"""One-pass plane packer: kernel `igg_pack_planes` (csrc/pack_planes.cu).

Extracts several y/z planes of a block-stacked 3-D field at once: request
`(d, pos)` (d in {1, 2}) gives every block's local plane `pos` along `d`,
stacked over the blocks as the halo exchange takes it (the field's stacked
shape with dim `d` replaced by the block count; see
:func:`igg_torch.halo.planes`).  The halo engine uses it whenever at least
two y/z planes of a 3-D field must be materialised, the rule of
`igg/halo.py` (x planes, and single planes, stay `index_select` calls).

Replaces `igg/ops/pack.py` (`pack_planes`).  The JAX package keeps the
packer to 32-bit types (a Mosaic restriction); the kernel copies bits of
2, 4 or 8 bytes.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ._build import library

MAX_PLANES = 8   # requests one launch takes (y and z, send and stale, 2 sides)


def _check(A, reqs, blocks) -> Tuple:
    if A.ndim != 3:
        raise ValueError(f"pack_planes takes 3-D fields, got rank {A.ndim}")
    blocks = tuple(int(b) for b in blocks)
    local = []
    for d in range(3):
        if A.shape[d] % blocks[d]:
            raise ValueError(f"dim {d} of size {A.shape[d]} is not divisible "
                             f"by {blocks[d]} blocks")
        local.append(A.shape[d] // blocks[d])
    if not 1 <= len(reqs) <= MAX_PLANES:
        raise ValueError(f"{len(reqs)} plane requests: need 1..{MAX_PLANES}")
    for d, pos in reqs:
        if d not in (1, 2) or not 0 <= pos < local[d]:
            raise ValueError(f"plane request {(d, pos)}: need d in (1, 2) and "
                             f"a row inside the local block {tuple(local)}")
    return blocks, tuple(local)


def _out_shape(A, d, blocks):
    shape = list(A.shape)
    shape[d] = blocks[d]
    return shape


def pack_planes_plain(A, reqs: Sequence[Tuple[int, int]], blocks) -> List:
    """Plain PyTorch version: one `index_select` per requested plane."""
    blocks, local = _check(A, reqs, blocks)
    return [A.index_select(d, torch.arange(blocks[d], device=A.device)
                           * local[d] + pos) for d, pos in reqs]


def pack_planes(A, reqs: Sequence[Tuple[int, int]], blocks) -> List:
    """The requested planes of `A` as new dense tensors, in request order.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    once for all of them, or raises."""
    if A.device.type == "cpu":
        return pack_planes_plain(A, reqs, blocks)
    blocks, local = _check(A, reqs, blocks)
    if A.device.type != "cuda":
        raise ValueError(f"pack_planes: unsupported device {A.device}")
    if not A.is_contiguous():
        raise ValueError("pack_planes: the field must be contiguous")
    if A.element_size() not in (2, 4, 8):
        raise ValueError(f"pack_planes: element size {A.element_size()} "
                         f"not in (2, 4, 8)")
    outs = [torch.empty(_out_shape(A, d, blocks), dtype=A.dtype,
                        device=A.device) for d, _ in reqs]
    _launch(A, reqs, blocks, local, outs,
            torch.cuda.current_stream(A.device).cuda_stream)
    pack_planes.launches += 1
    return outs


def _launch(A, reqs, blocks, local, outs, stream: int) -> None:
    """Launch `igg_pack_planes` once on checked arguments."""
    flat = [v for req in reqs for v in req]
    err = library("pack_planes").igg_pack_planes(
        A.data_ptr(), A.element_size(),
        (ctypes.c_int * 6)(*blocks, *local), len(reqs),
        (ctypes.c_int * len(flat))(*flat),
        (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs]),
        stream)
    if err:
        raise RuntimeError(f"igg_pack_planes launch failed: CUDA error {err}")


pack_planes.launches = 0
