"""In-place halo writer: kernel `igg_halo_write` (csrc/halo_write.cu).

Writes a grid array's halo planes in dimension order (later dims win the
shared corner and edge cells), in place, touching only the planes.  Per
dimension the source is

- ``(d, "wrap", ol)``: the block's own inner plane `s-ol` (into plane 0)
  and `ol-1` (into plane `s-1`) — the periodic single-block self-wrap,
  read from the block as already updated by the earlier dims;
- ``(d, "ext", first, last)``: dense received planes, stacked over the
  blocks (dim `d` of size `blocks[d]`), written as given.

Replaces the TPU writers of `igg/ops/halo_write.py` (`halo_write`,
`halo_write_slabs`, `write_lane_active`).  Any 2/4/8-byte dtype: the
kernel copies bits.  Rank-1/2 fields are taken as 3-D with trailing
dims of size 1.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ._build import library

_MODE = {"none": 0, "wrap": 1, "ext": 2}


def _check(A, specs, blocks) -> Tuple:
    if A.ndim > 3 or A.ndim < 1:
        raise ValueError(f"halo_write takes rank-1..3 fields, got rank {A.ndim}")
    blocks = tuple(int(b) for b in blocks) + (1,) * (3 - len(blocks))
    shape = tuple(A.shape) + (1,) * (3 - A.ndim)
    for d in range(3):
        if shape[d] % blocks[d]:
            raise ValueError(f"dim {d} of size {shape[d]} is not divisible by "
                             f"{blocks[d]} blocks")
    local = tuple(shape[d] // blocks[d] for d in range(3))
    prev = -1
    for sp in specs:
        d, mode = sp[0], sp[1]
        if not prev < d < A.ndim:
            raise ValueError(f"specs must name increasing dims < {A.ndim}")
        prev = d
        if mode == "wrap":
            ol = sp[2]
            if blocks[d] != 1:
                raise ValueError(f"wrap source on dim {d} needs one block, "
                                 f"got {blocks[d]}")
            if not 2 <= ol <= local[d] - 1:
                raise ValueError(f"wrap overlap {ol} invalid for size {local[d]}")
        elif mode == "ext":
            want = list(A.shape)
            want[d] = blocks[d]
            for P in sp[2:4]:
                if tuple(P.shape) != tuple(want):
                    raise ValueError(f"ext plane of dim {d} has shape "
                                     f"{tuple(P.shape)}, expected {tuple(want)}")
                if P.dtype != A.dtype or P.device != A.device:
                    raise ValueError("ext planes must match the field's dtype "
                                     "and device")
        else:
            raise ValueError(f"unknown halo source mode {mode!r}")
    return blocks, local


def halo_write_plain(A, specs: Sequence[Tuple], blocks):
    """Plain PyTorch version of the writer (same function, same result)."""
    blocks, local = _check(A, specs, blocks)
    for sp in specs:
        d, mode = sp[0], sp[1]
        n, s = blocks[d], local[d]
        first = torch.arange(n, device=A.device) * s
        last = first + (s - 1)
        if mode == "wrap":
            ol = sp[2]
            A.index_copy_(d, first, A.index_select(d, first + (s - ol)))
            A.index_copy_(d, last, A.index_select(d, first + (ol - 1)))
        else:
            A.index_copy_(d, first, sp[2])
            A.index_copy_(d, last, sp[3])
    return A


def halo_write(A, specs: Sequence[Tuple], blocks):
    """Write `A`'s halo planes in place per `specs` (see module docstring);
    returns `A`.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (one launch for all dims) or raises."""
    if A.device.type == "cpu":
        return halo_write_plain(A, specs, blocks)
    blocks, local = _check(A, specs, blocks)
    if A.device.type != "cuda":
        raise ValueError(f"halo_write: unsupported device {A.device}")
    if not A.is_contiguous():
        raise ValueError("halo_write: the field must be contiguous")
    if A.element_size() not in (2, 4, 8):
        raise ValueError(f"halo_write: element size {A.element_size()} "
                         f"not in (2, 4, 8)")
    _launch(A, specs, blocks, local,
            torch.cuda.current_stream(A.device).cuda_stream)
    halo_write.launches += 1
    return A


def _launch(A, specs, blocks, local, stream: int) -> None:
    """Launch `igg_halo_write` on checked arguments."""
    cfg = [0] * 12
    ptrs = [None] * 6
    keep = []
    for sp in specs:
        d, mode = sp[0], sp[1]
        cfg[9 + d] = _MODE[mode]
        cfg[6 + d] = sp[2] if mode == "wrap" else 2
        if mode == "ext":
            for side in (0, 1):
                P = sp[2 + side].contiguous()
                keep.append(P)
                ptrs[2 * d + side] = P.data_ptr()
    for d in range(3):
        cfg[d] = blocks[d]
        cfg[3 + d] = local[d]
    lib = library("halo_write")
    err = lib.igg_halo_write(
        ctypes.c_void_p(A.data_ptr()), ctypes.c_int(A.element_size()),
        (ctypes.c_int * 12)(*cfg), (ctypes.c_void_p * 6)(*ptrs), stream)
    if err:
        raise RuntimeError(f"igg_halo_write launch failed: CUDA error {err}")


halo_write.launches = 0
