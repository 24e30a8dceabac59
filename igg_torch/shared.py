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

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch

NDIMS = 3
# Left and right neighbor per dimension.
NNEIGHBORS_PER_DIM = 2
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
# Monotonic epoch, bumped at every init/finalize so caches keyed on it
# cannot leak across grid lifetimes.  One counter allocates the epochs of
# EVERY handle, process-wide and thread-scoped alike, so two grids alive at
# once never share a cache key.
_grid_epoch: int = 0
_epoch_lock = threading.Lock()
# Epoch of the process-wide handle: scoped setters draw from the same
# counter but must not move the epoch that unscoped readers key on.
_GLOBAL_EPOCH = [0]

# Thread-scoped grid handles (igg_torch.serve): a thread inside
# :func:`thread_grid_scope` sees ITS OWN grid through every ambient
# accessor, so concurrent jobs on disjoint block slots each run a full
# grid lifecycle without touching the process-wide handle or each other.
# Threads outside a scope keep the module-global handle.
_grid_tls = threading.local()


def _next_epoch() -> int:
    global _grid_epoch
    with _epoch_lock:
        _grid_epoch += 1
        return _grid_epoch


def scope_of_caller() -> Optional[dict]:
    """The calling thread's grid scope (None outside one), to hand to a
    helper thread through :func:`in_scope`."""
    return getattr(_grid_tls, "scope", None)


@contextlib.contextmanager
def thread_grid_scope():
    """Make the ambient grid handle THREAD-LOCAL inside this context: the
    calling thread starts with no grid, `init_global_grid` installs into
    the scope, `finalize_global_grid` clears it, and no other thread sees
    it.  :mod:`igg_torch.serve` runs each concurrent job's worker in one.
    Scopes nest (the previous scope is restored on exit); a grid still
    installed at exit is discarded with the scope.  The threads the port
    starts on a scoped thread's behalf (`sharded`'s blocks, the background
    checkpoint writer) run in the scope they were started from
    (:func:`scope_of_caller`, :func:`in_scope`)."""
    prev = scope_of_caller()
    _grid_tls.scope = {"grid": None, "epoch": _next_epoch()}
    try:
        yield
    finally:
        _grid_tls.scope = prev


@contextlib.contextmanager
def in_scope(scope: Optional[dict]):
    """Run the body in `scope` (a value of :func:`scope_of_caller`; None:
    the process-wide handle), restoring this thread's own on exit."""
    prev = scope_of_caller()
    _grid_tls.scope = scope
    try:
        yield
    finally:
        _grid_tls.scope = prev


def grid_is_initialized() -> bool:
    sc = scope_of_caller()
    if sc is not None:
        return sc["grid"] is not None
    return _global_grid is not None


def check_initialized() -> None:
    if not grid_is_initialized():
        raise GridError(
            "No function of the module can be called before init_global_grid() "
            "or after finalize_global_grid().")


def global_grid() -> GlobalGrid:
    check_initialized()
    sc = scope_of_caller()
    if sc is not None:
        return sc["grid"]
    return _global_grid


def get_global_grid() -> GlobalGrid:
    """The current grid (immutable, so no defensive copy is needed)."""
    return global_grid()


def set_global_grid(gg: Optional[GlobalGrid]) -> None:
    global _global_grid
    sc = scope_of_caller()
    epoch = _next_epoch()
    if sc is not None:
        sc["grid"] = gg
        sc["epoch"] = epoch
        return
    _global_grid = gg
    _GLOBAL_EPOCH[0] = epoch


def grid_epoch() -> int:
    sc = scope_of_caller()
    if sc is not None:
        return sc["epoch"]
    return _GLOBAL_EPOCH[0]


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
