"""Global sizes, global coordinates and the synchronizing chronometer
(the port's `igg/tools.py`).  Scalar forms take a 0-based index; the
field forms return 1-D coordinate tensors along the stacked dimension of
a grid array, on the grid's device."""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import torch

from . import shared
from .shared import NDIMS, check_initialized, global_grid


def nx_g(A=None) -> int:
    """Global grid size in x; with an array, that (staggered) array's."""
    g = global_grid()
    if A is None:
        return g.nxyz_g[0]
    return g.nxyz_g[0] + (g.local_shape_any(A)[0] - g.nxyz[0])


def ny_g(A=None) -> int:
    g = global_grid()
    if A is None:
        return g.nxyz_g[1]
    s = g.local_shape_any(A)
    return g.nxyz_g[1] + ((s[1] if A.ndim > 1 else 1) - g.nxyz[1])


def nz_g(A=None) -> int:
    g = global_grid()
    if A is None:
        return g.nxyz_g[2]
    s = g.local_shape_any(A)
    return g.nxyz_g[2] + ((s[2] if A.ndim > 2 else 1) - g.nxyz[2])


def spacing(lx, ly, lz) -> Tuple[float, float, float]:
    """(dx, dy, dz) of a domain of size (lx, ly, lz): `l / (n_g - 1)`."""
    return (lx / (nx_g() - 1), ly / (ny_g() - 1), lz / (nz_g() - 1))


def _coord_g(dim: int, i, d, local_size: int, coord, grid):
    """x_g/y_g/z_g for 0-based index `i` (a scalar or a float64 tensor).
    A staggered array extends half a cell beyond the base grid on each
    side; a periodic dimension's first cell is a ghost cell, so coordinates
    shift by one cell and wrap into [0, ng*d)."""
    n = grid.nxyz[dim]
    ng = grid.nxyz_g[dim]
    old = grid.overlaps[dim]
    x0 = 0.5 * (n - local_size) * d
    x = (coord * (n - old) + i) * d + x0
    if grid.periods[dim]:
        x = x - d
        if isinstance(x, torch.Tensor):
            x = torch.where(x > (ng - 1) * d, x - ng * d, x)
            x = torch.where(x < 0, x + ng * d, x)
        else:
            if x > (ng - 1) * d:
                x = x - ng * d
            if x < 0:
                x = x + ng * d
    return x


def _scalar_coord(dim: int, i: int, d, A, coords) -> float:
    check_initialized()
    g = global_grid()
    s = g.local_shape_any(A)
    local_size = s[dim] if A.ndim > dim else 1
    if coords is None:
        coords = shared.block_coords() or g.coords
    c = coords[dim]
    return _coord_g(dim, i, d, local_size, c, g)


def x_g(ix: int, dx, A, coords: Optional[Sequence[int]] = None) -> float:
    """Global x-coordinate of element `ix` (0-based) of the local array `A`
    on the block at grid `coords` (default: this process's coords)."""
    return _scalar_coord(0, ix, dx, A, coords)


def y_g(iy: int, dy, A, coords: Optional[Sequence[int]] = None) -> float:
    return _scalar_coord(1, iy, dy, A, coords)


def z_g(iz: int, dz, A, coords: Optional[Sequence[int]] = None) -> float:
    return _scalar_coord(2, iz, dz, A, coords)


def _coord_field(dim: int, d, A):
    """float64 tensor of the global coordinates along the stacked dim `dim`
    of `A`: entry I is local element I % s of the block at grid position
    I // s (inside `igg_torch.sharded`, of the local `A` of this block)."""
    check_initialized()
    g = global_grid()
    s = g.local_shape_any(A)
    local_size = s[dim] if A.ndim > dim else 1
    inside = shared.block_coords()
    blocks = 1 if inside is not None else (g.dims[dim] if dim < NDIMS else 1)
    I = torch.arange(local_size * blocks, device=g.device)
    first = inside[dim] if inside is not None else 0
    return _coord_g(dim, (I % local_size).to(torch.float64), float(d),
                    local_size, (I // local_size + first).to(torch.float64), g)


def x_g_field(dx, A):
    return _coord_field(0, dx, A)


def y_g_field(dy, A):
    return _coord_field(1, dy, A)


def z_g_field(dz, A):
    return _coord_field(2, dz, A)


def coord_fields(dx, dy, dz, A) -> Tuple:
    """(X, Y, Z) coordinate tensors broadcastable against the 3-D `A`."""
    X = x_g_field(dx, A)[:, None, None]
    Y = y_g_field(dy, A)[None, :, None]
    Z = z_g_field(dz, A)[None, None, :]
    return X, Y, Z


_t0: Optional[float] = None


def reset_timer() -> None:
    global _t0
    _t0 = None


def barrier() -> None:
    """Wait until the grid's device has drained its work queue."""
    g = global_grid()
    if g.device.type == "cuda":
        torch.cuda.synchronize(g.device)


def tic() -> None:
    """Start the chronometer once the device has reached this point."""
    global _t0
    check_initialized()
    barrier()
    _t0 = time.monotonic()


def toc() -> float:
    """Seconds since `tic()`, after the device reaches this point."""
    check_initialized()
    if _t0 is None:
        raise shared.GridError("toc() called before tic().")
    barrier()
    return time.monotonic() - _t0
