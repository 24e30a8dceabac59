"""Shared grid state, constants and accessors.

The port's counterpart of `igg/shared.py`.  Where the JAX package keeps a
device mesh, the port keeps one torch device: every block of the grid
lives in ONE process on that device, laid out block-stacked (a grid array
has shape `dims .* local_shape`, and block `(cx, cy, cz)` is the local
array of grid coordinate `(cx, cy, cz)`), so block-to-block "sends" are
plane copies between views of the stacked tensor.  This in-process group
is what two functions move data across: the halo engine's planes
(`igg_torch.halo.exchange_planes`) and the K-step chunk's slabs
(`igg_torch.ops.chunk_engine.exchange_slabs`); a `torch.distributed`
backend with one rank per GPU replaces those two functions.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import torch

NDIMS = 3
# "No neighbor" (open boundary at the edge of the grid), MPI_PROC_NULL's role.
PROC_NULL = -1


class GridError(RuntimeError):
    """Error raised for grid lifecycle / argument violations."""


@dataclasses.dataclass(frozen=True)
class GlobalGrid:
    """Immutable description of the implicit global grid."""

    nxyz_g: Tuple[int, int, int]      # global grid size
    nxyz: Tuple[int, int, int]        # local (per-block) grid size
    dims: Tuple[int, int, int]        # blocks per dimension
    overlaps: Tuple[int, int, int]    # overlap cells per dimension
    nprocs: int                       # total number of blocks
    me: int                           # rank of this process
    coords: Tuple[int, int, int]      # grid coordinates of this process
    periods: Tuple[int, int, int]     # periodicity per dimension (0/1)
    disp: int                         # Cartesian-shift displacement (>= 1)
    reorder: int                      # kept for API parity; no effect
    device: torch.device              # the device every block lives on
    quiet: bool

    def cart_rank(self, coords) -> int:
        """Flat rank of grid coordinates (x fastest)."""
        cx, cy, cz = (int(c) for c in coords)
        dx, dy, dz = self.dims
        if not (0 <= cx < dx and 0 <= cy < dy and 0 <= cz < dz):
            raise ValueError(f"coords {coords} out of bounds for dims {self.dims}")
        return cx + cy * dx + cz * dx * dy

    def cart_coords(self, rank: int) -> Tuple[int, int, int]:
        """Inverse of :meth:`cart_rank`."""
        dx, dy, dz = self.dims
        if not 0 <= rank < self.nprocs:
            raise ValueError(f"rank {rank} out of range for nprocs {self.nprocs}")
        return (rank % dx, (rank // dx) % dy, rank // (dx * dy))

    def neighbors_of(self, coords, dim: int) -> Tuple[int, int]:
        """(left, right) neighbor ranks of `coords` along `dim`, or PROC_NULL."""
        c = [int(x) for x in coords]
        n = self.dims[dim]
        out = []
        for step in (-self.disp, self.disp):
            t = c[dim] + step
            if self.periods[dim]:
                t %= n
            if 0 <= t < n:
                cc = list(c)
                cc[dim] = t
                out.append(self.cart_rank(cc))
            else:
                out.append(PROC_NULL)
        return tuple(out)

    def neighbors(self, dim: int) -> Tuple[int, int]:
        return self.neighbors_of(self.coords, dim)

    def has_neighbor(self, n: int, dim: int) -> bool:
        return self.neighbors(dim)[n] != PROC_NULL

    def local_shape(self, A) -> Tuple[int, ...]:
        """Per-block shape of a stacked grid array `A`."""
        shp = []
        for d in range(A.ndim):
            nd = self.dims[d] if d < NDIMS else 1
            if A.shape[d] % nd != 0:
                raise ValueError(
                    f"array dim {d} of size {A.shape[d]} is not divisible by "
                    f"the grid dims[{d}]={nd}; arrays must be created with "
                    f"igg_torch.zeros()/igg_torch.full() or have a "
                    f"dims-divisible shape.")
            shp.append(A.shape[d] // nd)
        return tuple(shp)

    def local_shape_any(self, A) -> Tuple[int, ...]:
        """Per-block shape of `A`: a stacked torch tensor, or a local one
        (any array inside `igg_torch.sharded`, any non-tensor outside)."""
        if isinstance(A, torch.Tensor) and block_coords() is None:
            return self.local_shape(A)
        return tuple(A.shape)

    def ol_of_local(self, dim: int, local_shape) -> int:
        """Per-array staggered overlap along `dim`:
        `ol(dim, A) = overlaps[dim] + (size_local(A, dim) - nxyz[dim])`."""
        return self.overlaps[dim] + (local_shape[dim] - self.nxyz[dim])

    def ol(self, dim: int, A=None) -> int:
        if A is None:
            return self.overlaps[dim]
        if dim >= A.ndim:
            raise ValueError(f"array has no dimension {dim}")
        return self.ol_of_local(dim, self.local_shape_any(A))


# The block a thread runs inside `igg_torch.sharded` (`block.ctx`, set by
# `igg_torch.parallel`; absent outside).
block = threading.local()


def block_coords() -> Optional[Tuple[int, int, int]]:
    """Grid coordinates of the block this thread runs inside
    `igg_torch.sharded`, or None outside it."""
    ctx = getattr(block, "ctx", None)
    return None if ctx is None else ctx.coords


# Module-level handle: the reference's five-verb API is implicitly stateful.
_global_grid: Optional[GlobalGrid] = None
# Bumped at every init/finalize so caches keyed on it cannot leak across
# grid lifetimes.
_grid_epoch: int = 0


def grid_is_initialized() -> bool:
    return _global_grid is not None


def check_initialized() -> None:
    if not grid_is_initialized():
        raise GridError(
            "No function of the module can be called before init_global_grid() "
            "or after finalize_global_grid().")


def global_grid() -> GlobalGrid:
    check_initialized()
    return _global_grid


def get_global_grid() -> GlobalGrid:
    """The current grid (immutable, so no defensive copy is needed)."""
    return global_grid()


def set_global_grid(gg: Optional[GlobalGrid]) -> None:
    global _global_grid, _grid_epoch
    _global_grid = gg
    _grid_epoch += 1


def grid_epoch() -> int:
    return _grid_epoch


def me() -> int:
    return global_grid().me


def ol(dim: int, A=None) -> int:
    return global_grid().ol(dim, A)


def neighbors(dim: int):
    return global_grid().neighbors(dim)


def neighbor(n: int, dim: int) -> int:
    return global_grid().neighbors(dim)[n]


def has_neighbor(n: int, dim: int) -> bool:
    return global_grid().has_neighbor(n, dim)
