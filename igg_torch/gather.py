"""Gather a grid array into one host array (the port's `igg/gather.py`).

The block-stacked array already is the Cartesian tiling of the local
arrays, so `gather` is a device-to-host copy; `gather_interior` drops the
overlap cells each block shares with its right neighbor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import shared
from .shared import NDIMS, GridError


def _nprocs_in(grid, ndim: int) -> int:
    n = 1
    for d in range(min(ndim, NDIMS)):
        n *= grid.dims[d]
    return n


def gather(A, A_global: Optional[np.ndarray] = None, *, root: int = 0):
    """The grid array `A` as one host array of shape `dims .* local_shape`
    (whole local blocks, halos included) on process `root`, None
    elsewhere.  With `A_global`, the result is written into it (checked to
    hold `nprocs * local size` elements) and None is returned."""
    grid = shared.global_grid()
    if grid.me != root:
        if A_global is not None:
            raise GridError("The input argument A_global must be None (or "
                            "omitted) on non-root processes.")
        return None
    local = grid.local_shape(A)
    out = A.detach().cpu().numpy()
    if A_global is None:
        return out
    if A_global.size != _nprocs_in(grid, A.ndim) * int(np.prod(local)):
        raise GridError("The input argument A_global must be of length "
                        "nprocs*length(A)")
    A_global[...] = out.reshape(A_global.shape)
    return None


def gather_interior(A, *, root: int = 0):
    """Gather with overlap de-duplication: block `c` contributes its cells
    `[0, s - ol)`; the last block of a non-periodic dimension also keeps
    its trailing `ol` cells (see `igg.gather_interior` for the shape
    contract)."""
    grid = shared.global_grid()
    if grid.me != root:
        return None
    stacked = A.detach().cpu().numpy()
    local = grid.local_shape(A)
    ndim = min(A.ndim, NDIMS)
    return numpy_retile(
        stacked, [grid.dims[d] for d in range(ndim)],
        [local[d] for d in range(ndim)],
        [local[d] - max(grid.ol_of_local(d, local), 0) for d in range(ndim)],
        [not grid.periods[d] for d in range(ndim)])


def numpy_retile(stacked: np.ndarray, dims, s, keep, full_last) -> np.ndarray:
    """Block `c` along each dim contributes its first `keep` cells (all `s`
    for the last block when `full_last`)."""
    out = stacked
    for d in range(len(dims)):
        pieces = []
        for c in range(dims[d]):
            block = np.take(out, range(c * s[d], (c + 1) * s[d]), axis=d)
            if c == dims[d] - 1 and full_last[d]:
                pieces.append(block)
            else:
                pieces.append(np.take(block, range(keep[d]), axis=d))
        out = np.concatenate(pieces, axis=d) if len(pieces) > 1 else pieces[0]
    return out
