"""Grid initialization: the port's `init_global_grid`.

Argument names, validation messages and the return tuple mirror
`igg.init_global_grid`.  The grid's blocks all live in this one process,
block-stacked on one torch device (see :mod:`igg_torch.shared`); `nprocs`
says how many blocks there are when some `dims` entries are left free (the
JAX package takes it from its device count).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import shared
from .shared import GlobalGrid, GridError
from .topology import dims_create


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; None means the card.  Asking for CUDA
    where there is none raises: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise GridError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU.")
    return dev


def init_global_grid(nx: int, ny: int, nz: int, *,
                     dimx: int = 0, dimy: int = 0, dimz: int = 0,
                     periodx: int = 0, periody: int = 0, periodz: int = 0,
                     overlapx: int = 2, overlapy: int = 2, overlapz: int = 2,
                     disp: int = 1, reorder: int = 1,
                     nprocs: Optional[int] = None,
                     device=None,
                     select_device: bool = True,
                     quiet: bool = False):
    """Initialize a Cartesian grid of blocks defining implicitly a global grid.

    - ``nx, ny, nz``: number of elements of the *local* (per-block) grid.
    - ``dimx/y/z``: blocks per dimension (0 = balanced auto choice).
    - ``periodx/y/z``: periodicity per dimension (0/1).
    - ``overlapx/y/z``: cells adjacent local grids overlap (default 2).
    - ``disp``: neighbor displacement of the Cartesian shift; ``reorder`` is
      accepted for parity and has no effect.
    - ``nprocs``: number of blocks the free dims are factored from (default:
      the product of the fixed dims, or 1).
    - ``device``: where every block lives (default ``"cuda"``; raises when
      there is no card).
    - ``select_device``: bind this process to its node-local card.

    Returns ``(me, dims, nprocs, coords, device)``.
    """
    if shared.grid_is_initialized():
        raise GridError("The global grid has already been initialized.")

    nxyz = np.array([nx, ny, nz], dtype=int)
    dims = np.array([dimx, dimy, dimz], dtype=int)
    periods = np.array([periodx, periody, periodz], dtype=int)
    overlaps = np.array([overlapx, overlapy, overlapz], dtype=int)

    if nx == 1:
        raise GridError("Invalid arguments: nx can never be 1.")
    if ny == 1 and nz > 1:
        raise GridError("Invalid arguments: ny cannot be 1 if nz is greater than 1.")
    if np.any((nxyz == 1) & (dims > 1)):
        raise GridError(
            "Incoherent arguments: if nx, ny, or nz is 1, then the "
            "corresponding dimx, dimy or dimz must not be set (or set 0 or 1).")
    if np.any((nxyz < 2 * overlaps - 1) & (periods > 0)):
        raise GridError(
            "Incoherent arguments: if nx, ny, or nz is smaller than "
            "2*overlapx-1, 2*overlapy-1 or 2*overlapz-1, respectively, then "
            "the corresponding periodx, periody or periodz must not be set "
            "(or set 0).")
    dims[(nxyz == 1) & (dims == 0)] = 1
    if disp < 1:
        raise GridError("Invalid arguments: disp must be a positive integer "
                        "(neighbor displacement of the Cartesian shift).")

    dev = resolve_device(device)
    if nprocs is None:
        nprocs = int(np.prod(dims)) if np.all(dims > 0) else 1
    dims = np.array(dims_create(int(nprocs), dims,
                                local_shape=(int(nx), int(ny), int(nz))),
                    dtype=int)
    nxyz_g = dims * (nxyz - overlaps) + overlaps * (periods == 0)

    if select_device and dev.type == "cuda" and dev.index is None:
        from .device import select_device as _select_device
        dev = torch.device("cuda", _select_device())

    gg = GlobalGrid(
        nxyz_g=tuple(int(v) for v in nxyz_g),
        nxyz=(int(nx), int(ny), int(nz)),
        dims=tuple(int(v) for v in dims),
        overlaps=tuple(int(v) for v in overlaps),
        nprocs=int(nprocs),
        me=0,
        coords=(0, 0, 0),
        periods=tuple(int(v) for v in periods),
        disp=int(disp),
        reorder=int(reorder),
        device=dev,
        quiet=bool(quiet),
    )
    shared.set_global_grid(gg)

    if not quiet:
        print(f"Global grid: {nxyz_g[0]}x{nxyz_g[1]}x{nxyz_g[2]} "
              f"(nprocs: {nprocs}, dims: {dims[0]}x{dims[1]}x{dims[2]})")

    from .tools import tic, toc
    tic()
    toc()
    return 0, gg.dims, int(nprocs), gg.coords, dev
