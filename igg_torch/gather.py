"""Gather a grid array into one host array (the port's `igg/gather.py`).

The block-stacked array already is the Cartesian tiling of the local
arrays, so `gather` is a device-to-host copy; `gather_interior` drops the
overlap cells each block shares with its right neighbor.  Every fetch goes
through :func:`_fetch_global`: arrays above `_CHUNK_BYTES` stream to the
host in slabs over their largest dim, so no fetch holds a second
whole-array buffer; on the card each slab lands in one reused pinned
host buffer first (:func:`free_gather_buffer` releases it).  numpy has
no bfloat16 or float8 type, so the fetch carries those as raw bits and
`gather`/`gather_interior` hand them out as their exact float32 values.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from . import shared
from .shared import NDIMS, GridError

# Device-to-host fetches larger than this go in slabs over the largest dim
# (igg's bound, `igg/gather.py:74`).
_CHUNK_BYTES = 1 << 28  # 256 MB

# Torch dtypes numpy has no type for: carried on the host as raw bits of
# the same width (the checkpoint stores these bytes and names the true
# dtype beside them, as igg does).
_BITS = {torch.bfloat16: (torch.int16, np.int16)}
for _name in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
              "float8_e5m2fnuz"):
    if hasattr(torch, _name):
        _BITS[getattr(torch, _name)] = (torch.uint8, np.uint8)

# The one pinned host buffer the card's slabs pass through (bytes), and the
# lock that keeps two fetches (a background worker's and the caller's) from
# sharing it.
_pinned: Optional[torch.Tensor] = None
_pinned_lock = threading.Lock()


def free_gather_buffer() -> None:
    """Release the pinned host buffer the card's fetches reuse (the
    reference's persistent gather buffer, `gather.jl:22-26`); the next
    fetch allocates it again."""
    global _pinned
    with _pinned_lock:
        _pinned = None


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a fetch of a `dtype` tensor returns: its own, or raw
    bits of its width where numpy has none (bfloat16, float8)."""
    if dtype in _BITS:
        return np.dtype(_BITS[dtype][1])
    return torch.empty((), dtype=dtype).numpy().dtype


def _as_host_typed(A: torch.Tensor) -> torch.Tensor:
    """`A` viewed as the dtype its host copy has (bits where numpy has no
    type for it)."""
    bits = _BITS.get(A.dtype)
    return A if bits is None else A.view(bits[0])


def _host_values(out: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """A fetched host array as values a numpy user can read: itself, or the
    exact float32 upcast of a bfloat16/float8 field's raw bits."""
    if dtype not in _BITS:
        return out
    return torch.from_numpy(out).view(dtype).to(torch.float32).numpy()


def _stream_axis(shape) -> Optional[int]:
    """The dim a bounded slab fetch streams over: the largest one (a
    leading singleton cannot be split), None when every dim is 1."""
    if not shape or max(shape) <= 1:
        return None
    return int(np.argmax(shape))


def _pinned_buffer(nbytes: int) -> torch.Tensor:
    """The reused pinned host buffer, grown to at least `nbytes`."""
    global _pinned
    if _pinned is None or _pinned.numel() < nbytes:
        _pinned = None
        _pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return _pinned


def _slabbed_get(A, limit: int) -> np.ndarray:
    """A fresh host copy of tensor `A` (any strides: a block of a stacked
    array is a view), fetched in slabs of at most `limit` bytes over its
    largest dim.  On the card each slab is made contiguous on the device
    (one slab at most), copied with `non_blocking=True` into the pinned
    buffer on the current stream, and that copy is waited for before its
    bytes go into the result; so the result holds `A` as the stream had it
    at the call.  On the CPU the slabs are copied directly."""
    A = _as_host_typed(A.detach())
    out = np.empty(tuple(A.shape), dtype=host_dtype(A.dtype))
    nbytes = out.nbytes
    axis = _stream_axis(tuple(A.shape))
    if axis is None or nbytes <= limit:
        slabs, rows = [None], 0
    else:
        n = A.shape[axis]
        rows = max(1, int(n * limit // nbytes))
        slabs = range(0, n, rows)
    if A.device.type != "cuda":
        for i0 in slabs:
            idx = _slab_index(A.ndim, axis, i0, rows)
            out[idx] = A[idx].numpy()
        return out
    with _pinned_lock:
        stream = torch.cuda.current_stream(A.device)
        most = nbytes if slabs == [None] else (
            rows * nbytes // A.shape[axis])
        pinned = _pinned_buffer(max(most, 1))
        for i0 in slabs:
            idx = _slab_index(A.ndim, axis, i0, rows)
            src = A[idx].contiguous()        # one slab on the device
            host = pinned[:src.numel() * src.element_size()].view(
                src.dtype).view(src.shape)
            host.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            done.synchronize()
            out[idx] = host.numpy()
            del src
    return out


def _slab_index(ndim: int, axis: Optional[int], i0, rows: int):
    if i0 is None:
        return (Ellipsis,)
    idx = [slice(None)] * ndim
    idx[axis] = slice(i0, i0 + rows)
    return tuple(idx)


def _fetch_global(A, chunk_bytes: Optional[int] = None,
                  root: int = 0) -> Optional[np.ndarray]:
    """Host copy of the whole stacked array `A` on process `root` (every
    block lives in this one process, so the caller is the root), in slabs
    above `chunk_bytes` (default `_CHUNK_BYTES`).  igg's multi-host branch
    (`_fetch_multihost`) waits for the port's `torch.distributed`
    backend."""
    limit = _CHUNK_BYTES if chunk_bytes is None else chunk_bytes
    return _slabbed_get(A, limit)


def _nprocs_in(grid, ndim: int) -> int:
    n = 1
    for d in range(min(ndim, NDIMS)):
        n *= grid.dims[d]
    return n


def gather(A, A_global: Optional[np.ndarray] = None, *, root: int = 0):
    """The grid array `A` as one host array of shape `dims .* local_shape`
    (whole local blocks, halos included) on process `root`, None
    elsewhere.  With `A_global`, the result is written into it (checked to
    hold `nprocs * local size` elements) and None is returned.  A bfloat16
    or float8 field comes back as its exact float32 values (numpy has no
    type for it; igg returns ml_dtypes arrays of the same values)."""
    grid = shared.global_grid()
    if grid.me != root:
        if A_global is not None:
            raise GridError("The input argument A_global must be None (or "
                            "omitted) on non-root processes.")
        return None
    local = grid.local_shape(A)
    out = _host_values(_fetch_global(A, root=root), A.dtype)
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
    contract); a bfloat16 or float8 field as its exact float32 values, as
    in :func:`gather`."""
    grid = shared.global_grid()
    if grid.me != root:
        return None
    stacked = _fetch_global(A, root=root)
    local = grid.local_shape(A)
    ndim = min(A.ndim, NDIMS)
    return _host_values(numpy_retile(
        stacked, [grid.dims[d] for d in range(ndim)],
        [local[d] for d in range(ndim)],
        [local[d] - max(grid.ol_of_local(d, local), 0) for d in range(ndim)],
        [not grid.periods[d] for d in range(ndim)]), A.dtype)


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
