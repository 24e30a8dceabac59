"""Field (tensor) creation on the implicit global grid.

A grid array is the block-stacked tensor of shape `dims .* local_shape` on
the grid's device: block `(cx, cy, cz)` is the local array (halo cells
included) of grid coordinate `(cx, cy, cz)` — the layout of `igg.fields`,
so the two packages' arrays compare element for element.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import shared
from .shared import NDIMS


def stacked_shape(local_shape: Sequence[int],
                  grid: Optional[shared.GlobalGrid] = None) -> Tuple[int, ...]:
    """Global (stacked) shape for a per-block `local_shape`."""
    grid = grid or shared.global_grid()
    return tuple(int(s) * (grid.dims[d] if d < NDIMS else 1)
                 for d, s in enumerate(local_shape))


def zeros(local_shape: Sequence[int], dtype=torch.float32):
    """A grid array whose every block is a `local_shape` block of zeros."""
    grid = shared.global_grid()
    return torch.zeros(stacked_shape(local_shape), dtype=dtype, device=grid.device)


def ones(local_shape: Sequence[int], dtype=torch.float32):
    grid = shared.global_grid()
    return torch.ones(stacked_shape(local_shape), dtype=dtype, device=grid.device)


def full(local_shape: Sequence[int], fill_value, dtype=torch.float32):
    grid = shared.global_grid()
    return torch.full(stacked_shape(local_shape), fill_value, dtype=dtype,
                      device=grid.device)


def from_local_blocks(fn: Callable, local_shape: Sequence[int], dtype=torch.float32):
    """Assemble a grid array from per-coordinate local blocks:
    ``fn(coords, local_shape) -> array`` is evaluated for every grid
    coordinate (coords padded to 3 entries)."""
    grid = shared.global_grid()
    nd = len(local_shape)
    dims = [grid.dims[d] if d < NDIMS else 1 for d in range(nd)]
    out = np.empty(stacked_shape(local_shape),
                   dtype=torch.empty((), dtype=dtype).numpy().dtype)
    for cz in range(dims[2] if nd > 2 else 1):
        for cy in range(dims[1] if nd > 1 else 1):
            for cx in range(dims[0]):
                block = np.asarray(fn((cx, cy, cz), tuple(local_shape)))
                sl = tuple(slice(c * s, (c + 1) * s)
                           for c, s in zip((cx, cy, cz)[:nd], local_shape))
                out[sl] = block
    return torch.from_numpy(out).to(grid.device)


def local_blocks(A) -> np.ndarray:
    """Host copy of a grid array, indexable by block."""
    return A.detach().cpu().numpy()


def local_block(A, coords) -> np.ndarray:
    """Host copy of the local array at grid `coords`."""
    grid = shared.global_grid()
    s = grid.local_shape(A)
    sl = tuple(slice(int(coords[d]) * s[d], (int(coords[d]) + 1) * s[d])
               for d in range(A.ndim))
    return local_blocks(A[sl])
