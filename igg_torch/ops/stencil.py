"""Shared stencil-assembly helpers (plain PyTorch)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def interior_add(A, delta, pad_width=1):
    """`A` with `delta` added to its interior: `A + zero-pad(delta)`, so
    the boundary cells add exactly zero (the no-write semantics).
    `pad_width` is an int or one `(before, after)` pair per axis."""
    if isinstance(pad_width, int):
        pad_width = [(pad_width, pad_width)] * delta.ndim
    pad = []
    for before, after in reversed(pad_width):
        pad += [before, after]
    return A + F.pad(delta, pad)


def block_boundary_mask(shape, local, device) -> torch.Tensor:
    """Boolean mask of the cells of a stacked array of `shape` that lie on
    the outer planes of their local block of size `local` (any dim)."""
    mask = torch.zeros(shape, dtype=torch.bool, device=device)
    for d, (S, s) in enumerate(zip(shape, local)):
        i = torch.arange(S, device=device) % s
        edge = (i == 0) | (i == s - 1)
        view = [1] * len(shape)
        view[d] = S
        mask |= edge.view(view)
    return mask


@functools.lru_cache(maxsize=64)
def _scalar(value: float, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def divisor(value: float, like) -> torch.Tensor:
    """`value` rounded once to a 0-dim tensor of `like`'s dtype on its
    device.  Dividing by it is an IEEE division, as in the kernels: on a
    CUDA tensor PyTorch turns `x / float` into `x * (1/float)`, which rounds
    differently."""
    return _scalar(float(value), like.dtype, like.device)
