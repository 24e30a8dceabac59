"""K-step trapezoid chunks of the diffusion step on grids of several
blocks: kernel `igg_diffusion_chunk_step` (csrc/diffusion_chunk.cu).

Once per chunk every block is extended by K rows beyond both ends of each
extended dimension (`igg_torch.ops.chunk_engine.extend_fields`: one K-deep
slab exchange per dimension instead of K plane exchanges), then K steps
run on the extended blocks, each step one kernel launch that ping-pongs two
buffers, and the last step writes each block's central window into the
output.  Bit for bit what K per-step steps give from an exchange-fresh
state (igg/ops/diffusion_trapezoid.py:30-70): every row that the central
window depends on is updated with the stencil arithmetic its owner would
apply, and open edges re-freeze from the chunk-entry buffer.

Replaces `igg/ops/diffusion_trapezoid.py` (`_kernel`, `_chunk_call`,
`fused_diffusion_trapezoid_steps`).  The plain version of a chunk,
:func:`window_steps_plain`, is the port of `_window_steps_xla`.

The streaming banded tier (igg's `diffusion3d.banded`): the same K-step
chunks, each iteration swept in x-row bands of depth B (kernel
`igg_diffusion_band_step`, csrc/diffusion_band.cu, one launch per
iteration: the x-march of csrc/diffusion_march.cuh, x walked in segments
of its own, since the bands do not change the function; plain version
`chunk_engine.banded_window_plain` with
:func:`banded_update`).  igg needed it where VMEM refused the resident
window; the card has no such limit, so the models take it only where the
resident routes refuse, or when asked (:func:`banded_refusal`,
:func:`fit_diffusion_band`, :func:`fused_diffusion_banded_steps`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ._build import count_launch, library
from ._smem import fit_banded
# `banded_refusal` (igg's `diffusion_banded_supported` for T and A) is the
# chunk engine's gate of the banded tier.
from .chunk_engine import (EXTENDED, admit_chunk_common, admit_send_slabs,
                           banded_refusal, central_window,
                           check_chunk_buffers, chunk_cfg, dim_modes,
                           extend_fields, field_ols, run_chunks,
                           streaming_chunk_call, window_chunk_plain)
from .diffusion_pallas import block_diffusion_compute

_DTYPE = {torch.float32: 0, torch.float64: 1}


def trapezoid_refusal(grid, shape, bx: int, n_inner: int,
                      dtype) -> Optional[str]:
    """Why the K=bx chunk cannot run `n_inner` steps of a field of local
    `shape`, or None when it can: the gates of igg's `trapezoid_supported`
    (with open dims admitted) without the Mosaic tile gates and the VMEM
    budget, plus the shared-region gate of `admit_send_slabs`."""
    why = admit_chunk_common(grid, bx, n_inner)
    if why is not None:
        return why
    if dtype not in _DTYPE:
        return f"dtype {dtype} is not float32/float64"
    modes = dim_modes(grid)
    K = bx
    S0, S1, S2 = shape
    olx = grid.ol_of_local(0, shape)
    if olx < 2 or S0 % K != 0:
        return (f"x extent {S0} (overlap {olx}) not chunkable at K={K} "
                f"(needs ol >= 2, S0 % K == 0)")
    if modes[0] != "frozen" and (S0 - olx - K < 0 or olx + K > S0):
        return (f"K={K} x send slabs fall outside the local block "
                f"(S0={S0}, ol={olx})")
    if modes[0] == "frozen" and S0 // K < 2:
        return f"frozen-x block needs >= 2 x bands (S0={S0}, K={K})"
    if modes[1] in EXTENDED:
        oly = grid.ol_of_local(1, shape)
        if oly < 2 or K % 8 != 0:
            return (f"y-extended chunk needs ol >= 2 and K % 8 == 0 "
                    f"(ol={oly}, K={K})")
        if S1 - oly - K < 0 or oly + K > S1:
            return (f"K={K} y send slabs fall outside the local block "
                f"(S1={S1}, ol={oly})")
    if modes[2] in EXTENDED:
        olz = grid.ol_of_local(2, shape)
        if olz < 2:
            return f"z-extended chunk needs overlap >= 2 (ol={olz})"
        if S2 - olz - K < 0 or olz + K > S2:
            return (f"K={K} z send slabs fall outside the local block "
                f"(S2={S2}, ol={olz})")
    shapes = [tuple(shape)]
    return admit_send_slabs(shapes, field_ols(grid, shapes), K, modes,
                            grid=grid)


def window_steps_plain(Text, A_ext, *, K, modes, grid, sc):
    """Plain PyTorch version of a chunk (the port of igg's
    `_window_steps_xla`): K window steps of the extended buffer `Text`,
    which is also the freeze source (:func:`chunk_engine.
    window_chunk_plain` with the diffusion stencil).  Returns the evolved
    extended buffer; :func:`chunk_engine.central_window` cuts the result
    out."""
    return window_chunk_plain([Text], K=K, modes=modes, grid=grid,
                              core=window_core(A_ext, grid, sc),
                              freeze_fields=(0,))[0]


def window_core(A_ext, grid, sc):
    """The stencil of every extended block (interior cells)."""
    ext_local = tuple(A_ext.shape[d] // grid.dims[d] for d in range(3))
    return lambda U: (block_diffusion_compute(U, A_ext, ext_local, **sc),)


def chunk_call(Text, A_ext, local, *, K, modes, grid, sc):
    """Advance the extended stacked buffer `Text` by K steps and return
    every block's central `local` window (a new tensor).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel K times,
    ping-ponging two buffers, the last launch writing the output, or
    raises."""
    if Text.device.type == "cpu":
        return central_window(window_steps_plain(
            Text, A_ext, K=K, modes=modes, grid=grid, sc=sc), local, K, modes)
    check_chunk_buffers([Text, A_ext], [local] * 2, K, modes, grid, _DTYPE)
    out = torch.empty([grid.dims[d] * local[d] for d in range(3)],
                      dtype=Text.dtype, device=Text.device)
    bufs = (torch.empty_like(Text), torch.empty_like(Text))
    stream = torch.cuda.current_stream(Text.device).cuda_stream
    src = Text
    for k in range(K):
        dst = out if k == K - 1 else bufs[k % 2]
        _launch(src, A_ext, Text, dst, local, K, modes, grid, sc,
                k == K - 1, stream)
        count_launch(chunk_call)
        src = dst
    return out


def _launch(src, A_ext, F, out, local, K, modes, grid, sc, last: bool,
            stream: int) -> None:
    """Launch `igg_diffusion_chunk_step` once on checked arguments."""
    cfg = chunk_cfg(src.shape, local, K, modes, grid, last)
    rdx2, rdy2, rdz2 = sc["rdx2"], sc["rdy2"], sc["rdz2"]
    err = library("diffusion_chunk").igg_diffusion_chunk_step(
        src.data_ptr(), A_ext.data_ptr(), F.data_ptr(), out.data_ptr(),
        _DTYPE[src.dtype], cfg,
        rdx2, rdy2, rdz2, 2.0 * (rdx2 + rdy2 + rdz2), stream)
    if err:
        raise RuntimeError(f"igg_diffusion_chunk_step launch failed: CUDA "
                           f"error {err}")


chunk_call.launches = 0


def fused_diffusion_trapezoid_steps(T, A, *, n_inner: int, bx: int, grid,
                                    rdx2, rdy2, rdz2):
    """Advance the grid array `T` by the `n_inner // bx` full chunks of
    K = bx steps; returns `(T, steps_done)` and leaves the remainder to
    the caller.  `A` is extended once for all chunks."""
    K = bx
    sc = dict(rdx2=rdx2, rdy2=rdy2, rdz2=rdz2)
    local = grid.local_shape(T)
    modes = dim_modes(grid)
    ols = field_ols(grid, [local])
    A_ext = extend_fields([A], ols, K, grid, modes)[0]

    def one(T):
        Text = extend_fields([T], ols, K, grid, modes)[0]
        return (chunk_call(Text, A_ext, local, K=K, modes=modes, grid=grid,
                           sc=sc),)

    T, done = run_chunks((T,), n_inner=n_inner, K=K, one_chunk=one)
    return T, done


# ---------------------------------------------------------------------------
# The streaming banded tier (igg's `diffusion3d.banded`)
# ---------------------------------------------------------------------------

def banded_update(Wt, Wa, *, bx, rdx2, rdy2, rdz2):
    """New band values (rows `[a, a+bx)`, window row offset 1) from the
    margin-1 windows of T and A (igg's `_banded_update`): interior cells
    take the 7-point update in the association of
    :func:`~igg_torch.ops.diffusion_pallas.diffusion_compute`, y/z edge
    rows keep their old values (the band halo owns them)."""
    o = Wt[1:1 + bx]
    c = o[:, 1:-1, 1:-1]
    lap = ((Wt[2:2 + bx, 1:-1, 1:-1] + Wt[0:bx, 1:-1, 1:-1]) * rdx2
           + (o[:, 2:, 1:-1] + o[:, :-2, 1:-1]) * rdy2
           + (o[:, 1:-1, 2:] + o[:, 1:-1, :-2]) * rdz2
           - 2.0 * (rdx2 + rdy2 + rdz2) * c)
    inner = c + Wa[1:1 + bx, 1:-1, 1:-1] * lap
    mid = torch.cat([o[:, 1:-1, :1], inner, o[:, 1:-1, -1:]], dim=2)
    return (torch.cat([o[:, :1], mid, o[:, -1:]], dim=1),)


def fit_diffusion_band(grid, shape, n_inner: int, dtype, kmax: int = 8,
                       bands=(8, 16)):
    """Largest admissible `(K, B)` of the banded tier (`_smem.fit_banded`);
    None when none applies."""
    return fit_banded(
        lambda K, B: banded_refusal(grid, shape, K, n_inner, dtype,
                                    B=B) is None,
        kmax, bands=bands)


def band_call(Text, A_ext, local, *, K, B, modes, grid, sc,
              central: bool = True):
    """K banded iterations of the extended stacked buffer `Text` with the
    extended coefficient `A_ext`: every block's central `local` window
    (`central`), or the whole evolved extended buffer.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel K times
    (`chunk_engine.streaming_chunk_call`), or raises."""
    shapes = [tuple(local)] * 2

    def launch(src, dst, cfg):
        _band_launch(src[0], A_ext, Text, dst[0], cfg, sc,
                     torch.cuda.current_stream(Text.device).cuda_stream)
        count_launch(band_call)

    return streaming_chunk_call(
        [Text], [A_ext], K=K, B=B, modes=modes, grid=grid,
        ols=field_ols(grid, shapes), shapes=shapes, E=K,
        band_update=partial(banded_update, **sc), extras=(1, 1),
        freeze_fields=(0,), launch=launch, central=central)[0]


def _band_launch(src, A_ext, F, out, cfg, sc, stream: int) -> None:
    """Launch `igg_diffusion_band_step` once (layout `cfg`,
    `chunk_engine.band_cfg`) on checked arguments."""
    rdx2, rdy2, rdz2 = sc["rdx2"], sc["rdy2"], sc["rdz2"]
    err = library("diffusion_band").igg_diffusion_band_step(
        src.data_ptr(), A_ext.data_ptr(), F.data_ptr(), out.data_ptr(),
        _DTYPE[src.dtype], cfg, rdx2, rdy2, rdz2, 2.0 * (rdx2 + rdy2 + rdz2),
        stream)
    if err:
        raise RuntimeError(f"igg_diffusion_band_step launch failed: CUDA "
                           f"error {err}")


band_call.launches = 0


def fused_diffusion_banded_steps(T, A, *, n_inner: int, K: int, B: int,
                                 grid, rdx2, rdy2, rdz2):
    """Advance the grid array `T` by the `n_inner // K` full chunks of
    depth K through the banded tier (band depth B); returns `(T,
    steps_done)` and leaves the warm-up step before and the remainder
    after to the caller, as :func:`fused_diffusion_trapezoid_steps`
    does."""
    sc = dict(rdx2=rdx2, rdy2=rdy2, rdz2=rdz2)
    local = grid.local_shape(T)
    modes = dim_modes(grid)
    ols = field_ols(grid, [local])
    A_ext = extend_fields([A], ols, K, grid, modes)[0]

    def one(T):
        Text = extend_fields([T], ols, K, grid, modes)[0]
        return (band_call(Text, A_ext, local, K=K, B=B, modes=modes,
                          grid=grid, sc=sc),)

    T, done = run_chunks((T,), n_inner=n_inner, K=K, one_chunk=one)
    return T, done
