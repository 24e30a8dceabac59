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

from ._build import count_launch, library

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
    if A.device.type != "cuda":
        raise ValueError(f"halo_write: unsupported device {A.device}")
    if not A.is_contiguous():
        raise ValueError("halo_write: the field must be contiguous")
    esize = A.element_size()
    if esize not in (2, 4, 8):
        raise ValueError(f"halo_write: element size {esize} not in (2, 4, 8)")
    stream = _stream(A.device)
    if all(sp[1] == "wrap" for sp in specs):
        # Without EXT planes the layout is a function of the shape, the
        # specs and the blocks alone: checked and built once.
        key = (A.shape, tuple(specs), tuple(blocks))
        cfg = _WRAP_CFGS.get(key)
        if cfg is None:
            b3, local = _check(A, specs, blocks)
            if len(_WRAP_CFGS) >= 64:
                _WRAP_CFGS.clear()
            cfg = _WRAP_CFGS[key] = _CFG(*_cfg(specs, b3, local))
        _call(A, esize, cfg, _NO_PLANES, stream)
    else:
        _launch(A, specs, *_check(A, specs, blocks), stream)
    count_launch(halo_write)
    return A


def _stream(device) -> int:
    """The current CUDA stream of `device` as an int (PyTorch's raw-stream
    query where it has one: the writer's host path bounds it, and
    `torch.cuda.current_stream` builds a Stream object)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index if device.index is not None
                   else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


_CFG = ctypes.c_int * 12
_PTRS = ctypes.c_void_p * 6
_NO_PLANES = _PTRS()
# The layouts of wrap-only calls, keyed by (shape, specs, blocks).
_WRAP_CFGS: dict = {}
# The library and its typed entry point, looked up once per library.
_entry = [None, None]


def _cfg(specs, blocks, local):
    """The kernel's 12-int layout: n, s, ol and mode per dim."""
    cfg = [blocks[0], blocks[1], blocks[2], local[0], local[1], local[2],
           2, 2, 2, 0, 0, 0]
    for sp in specs:
        d = sp[0]
        cfg[9 + d] = _MODE[sp[1]]
        if sp[1] == "wrap":
            cfg[6 + d] = sp[2]
    return cfg


def _call(A, esize, cfg, ptrs, stream) -> None:
    lib = library("halo_write")
    if _entry[0] is not lib:
        _entry[:] = [lib, lib.igg_halo_write]
    err = _entry[1](A.data_ptr(), esize, cfg, ptrs, stream)
    if err:
        raise RuntimeError(f"igg_halo_write launch failed: CUDA error {err}")


def _launch(A, specs, blocks, local, stream: int) -> None:
    """Launch `igg_halo_write` on checked arguments."""
    ptrs = [None] * 6
    keep = []
    for sp in specs:
        if sp[1] == "ext":
            d = sp[0]
            for side in (0, 1):
                P = sp[2 + side].contiguous()
                keep.append(P)
                ptrs[2 * d + side] = P.data_ptr()
    _call(A, A.element_size(), _CFG(*_cfg(specs, blocks, local)),
          _PTRS(*ptrs), stream)


halo_write.launches = 0
