"""Carry state between the JAX package and the port.

Both keep grid arrays in the same block-stacked layout, so state moves as
numpy arrays: :func:`to_torch` turns stacked numpy arrays (e.g.
`np.asarray` of `igg` fields) into tensors on the port's grid device, and
:func:`to_numpy` turns the port's tensors back.  Parameter dataclasses
(`Params` of a model) carry across by field name, so neither package's
class is imported by the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Type, TypeVar

import numpy as np
import torch

from . import shared

P = TypeVar("P")


def to_torch(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Stacked numpy arrays -> tensors on the grid's device (same dtype and
    shape; each shape must be divisible by the grid's dims)."""
    grid = shared.global_grid()
    out = {}
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.copy()).to(grid.device)
        grid.local_shape(t)          # raises on a non-stacked shape
        out[name] = t
    return out


def to_numpy(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's tensors -> stacked numpy arrays (host copies)."""
    return {name: t.detach().cpu().numpy() for name, t in tensors.items()}


def convert_params(params, cls: Type[P]) -> P:
    """`params` (a dataclass of either package) as an instance of `cls`,
    field by field; raises when a field of `cls` is missing."""
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if not hasattr(params, n)]
    if missing:
        raise ValueError(f"{type(params).__name__} lacks fields {missing} "
                         f"of {cls.__name__}")
    return cls(**{n: getattr(params, n) for n in names})
