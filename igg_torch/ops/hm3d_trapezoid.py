"""K-step trapezoid chunks of the HM3D step on grids of several blocks:
kernel `igg_hm3d_chunk_step` (csrc/hm3d_chunk.cu: the x-march of
csrc/hm3d_march.cuh with the chunk's edge rules).

The coupled update is radius 1 in both fields (`dPe` reads Pe and phi at
+-1, `dphi` the new Pe at the same cell), so the validity front shrinks one
row per extended side and step and the margin is `E = K`, the diffusion
chunk's geometry.  Once per chunk both fields are extended by K rows beyond
both ends of each extended dimension in one grouped slab exchange per
dimension (`igg_torch.ops.chunk_engine.extend_fields`), then K coupled
steps run on the extended blocks, each one kernel launch that ping-pongs
two pairs of buffers, with open dims re-freezing BOTH fields from the
chunk-entry buffers (igg's `freeze_fields=(0, 1)`), and the last launch
writes each block's central windows.  Bit for bit what K per-step steps
give from an exchange-fresh state.

Replaces the HM3D instance of the TPU kernel of `igg/ops/chunk_engine.py`
(`_resident_kernel`, `resident_chunk_call`) as `igg/ops/hm3d_trapezoid.py`
(`_chunk_call`, `fused_hm3d_trapezoid_steps`) configures it.  The plain
version of a chunk, :func:`window_steps_plain`, is the port of
`_window_steps_xla`.

The streaming banded tier (igg's `hm3d.banded`, the HM3D instance of
`_streaming_kernel`): the same K-step chunks, each iteration swept in
x-row bands of depth B (kernel `igg_hm3d_band_step`, csrc/hm3d_band.cu,
one launch per iteration: the x-march of csrc/hm3d_march.cuh, x walked in
segments of its own, since the bands do not change the function; plain
version `chunk_engine.banded_window_plain` with :func:`band_update`).  igg needed it where VMEM
refused the resident window; the card has no such limit, so the model
takes it only where the resident routes refuse, or when asked
(:func:`hm3d_banded_refusal`, :func:`fit_hm3d_band`,
:func:`fused_hm3d_banded_steps`).
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Optional

import torch

from ..models import hm3d as model
from ._build import library
from ._smem import fit_banded
from .chunk_engine import (admit_chunk_common, admit_send_slabs,
                           banded_refusal, central_window,
                           check_chunk_buffers, chunk_cfg, dim_modes,
                           extend_fields, field_ols, run_chunks,
                           streaming_chunk_call, window_chunk_plain)
from .diffusion_pallas import _DTYPE
from .hm3d_pallas import coef_args


def hm3d_trapezoid_refusal(grid, shape, K: int, n_inner: int,
                           dtype) -> Optional[str]:
    """Why the depth-K chunk cannot run `n_inner` steps of fields of local
    `shape`, or None when it can: the gates of igg's
    `hm3d_trapezoid_supported` (a full chunk, unit displacement, an
    overlap-2 grid, unstaggered fields, K-deep send slabs inside every
    extended dimension's block and out of the sender's shared region)
    without its Mosaic band/tile gates and its VMEM budget; f32 or f64."""
    why = admit_chunk_common(grid, K, n_inner)
    if why is not None:
        return why
    if grid.overlaps != (2, 2, 2):
        return f"grid overlaps {grid.overlaps} != (2, 2, 2)"
    if tuple(shape) != tuple(grid.nxyz) or min(shape) < 3:
        return (f"local shape {tuple(shape)} is not the grid block "
                f"{tuple(grid.nxyz)} of >= 3 cells per dim")
    if dtype not in _DTYPE:
        return f"dtype {dtype} is not float32/float64"
    shapes = [tuple(shape)] * 2
    return admit_send_slabs(shapes, field_ols(grid, shapes), K,
                            dim_modes(grid), grid=grid)


def window_core(ext_stacked, grid, kw):
    """The coupled update of every extended block of the stacked shape
    `ext_stacked` (interior cells): the port of igg's `_band_update` on
    whole windows."""
    ext_local = tuple(ext_stacked[d] // grid.dims[d] for d in range(3))
    return lambda Pe, phi: model.block_compute(Pe, phi, ext_local, **kw)


def window_steps_plain(Pee, phie, *, K, modes, grid, kw):
    """Plain PyTorch version of a chunk (the port of igg's
    `_window_steps_xla`): K window steps of the extended buffers `(Pee,
    phie)`, which are also the freeze source of both fields.  Returns the
    evolved extended buffers; :func:`chunk_engine.central_window` cuts the
    results out."""
    return tuple(window_chunk_plain(
        [Pee, phie], K=K, modes=modes, grid=grid,
        core=window_core(Pee.shape, grid, kw), freeze_fields=(0, 1)))


def chunk_call(exts, local, *, K, modes, grid, kw):
    """Advance the extended stacked buffers `exts = (Pee, phie)` by K steps
    and return every block's central `local` windows (new tensors).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel K
    times, ping-ponging two pairs of buffers, the last launch writing the
    outputs, or raises."""
    if exts[0].device.type == "cpu":
        return tuple(central_window(U, local, K, modes)
                     for U in window_steps_plain(*exts, K=K, modes=modes,
                                                 grid=grid, kw=kw))
    check_chunk_buffers(list(exts), [local] * 2, K, modes, grid, _DTYPE)
    shape = [grid.dims[d] * local[d] for d in range(3)]
    out = tuple(torch.empty(shape, dtype=exts[0].dtype, device=exts[0].device)
                for _ in range(2))
    bufs = [tuple(torch.empty_like(X) for X in exts) for _ in range(2)]
    stream = torch.cuda.current_stream(exts[0].device).cuda_stream
    src = tuple(exts)
    for k in range(K):
        dst = out if k == K - 1 else bufs[k % 2]
        _launch(src, exts, dst, local, K, modes, grid, kw, k == K - 1, stream)
        chunk_call.launches += 1
        src = dst
    return out


def _ptrs(tensors):
    return (ctypes.c_void_p * 2)(*[t.data_ptr() for t in tensors])


def _launch(src, F, out, local, K, modes, grid, kw, last: bool,
            stream: int) -> None:
    """Launch `igg_hm3d_chunk_step` once on checked arguments."""
    coef, npow = coef_args(kw)
    err = library("hm3d_chunk").igg_hm3d_chunk_step(
        _ptrs(src), _ptrs(F), _ptrs(out), _DTYPE[src[0].dtype],
        chunk_cfg(src[0].shape, local, K, modes, grid, last), coef, npow,
        stream)
    if err:
        raise RuntimeError(f"igg_hm3d_chunk_step launch failed: CUDA error "
                           f"{err}")


chunk_call.launches = 0


def fused_hm3d_trapezoid_steps(Pe, phi, *, n_inner: int, K: int, grid, dx,
                               dy, dz, dt, phi0, npow, eta):
    """Advance `(Pe, phi)` by the `n_inner // K` full chunks of depth K;
    returns `(Pe, phi, steps_done)` and leaves the remainder to the
    caller.  Entry contract: exchange-fresh halos (any state a step, an
    `update_halo` or a previous chunk produced)."""
    kw = dict(dx=dx, dy=dy, dz=dz, dt=dt, phi0=phi0, npow=npow, eta=eta)
    local = grid.local_shape(Pe)
    modes = dim_modes(grid)
    ols = field_ols(grid, [local, local])

    def one(Pe, phi):
        exts = extend_fields([Pe, phi], ols, K, grid, modes)
        return chunk_call(exts, local, K=K, modes=modes, grid=grid, kw=kw)

    return run_chunks((Pe, phi), n_inner=n_inner, K=K, one_chunk=one)


# ---------------------------------------------------------------------------
# The streaming banded tier (igg's `hm3d.banded`)
# ---------------------------------------------------------------------------

def band_update(Wpe, Wphi, *, bx, kw):
    """New band values of both fields (rows `[a, a+bx)`, window row offset
    1) from their margin-1 windows (igg's `_band_update`): interior cells
    take the increments of :func:`~igg_torch.models.hm3d.step_core`, y/z
    edge rows keep their old values (the band halo owns them)."""
    dPe, dphi = model.step_core(Wpe, Wphi, **kw)
    outs = []
    for W, dF in ((Wpe, dPe), (Wphi, dphi)):
        o = W[1:1 + bx]
        inner = o[:, 1:-1, 1:-1] + dF[0:bx]
        mid = torch.cat([o[:, 1:-1, :1], inner, o[:, 1:-1, -1:]], dim=2)
        outs.append(torch.cat([o[:, :1], mid, o[:, -1:]], dim=1))
    return tuple(outs)


def hm3d_banded_refusal(grid, shape, K: int, n_inner: int, dtype,
                        B: int = 8) -> Optional[str]:
    """Why the banded tier cannot run `n_inner` steps of fields of local
    `shape` at depth K and band B, or None when it can: igg's
    `hm3d_banded_supported` with its Mosaic gates dropped and float64
    admitted, an overlap-2 grid and `chunk_engine.banded_refusal` for Pe
    and phi.  Its window budget is that of the band walk igg's kernel
    stages; the port's kernel (the HM3D x-march) holds the same shared
    memory at every B, and the gate stays igg's, so the tier admits what
    igg's admits."""
    if grid.overlaps != (2, 2, 2):
        return f"grid overlaps {grid.overlaps} != (2, 2, 2)"
    return banded_refusal(grid, shape, K, n_inner, dtype, B=B)


def fit_hm3d_band(grid, shape, n_inner: int, dtype, kmax: int = 8,
                  bands=(8, 16)):
    """Largest admissible `(K, B)` of the banded tier (`_smem.fit_banded`);
    None when none applies."""
    return fit_banded(
        lambda K, B: hm3d_banded_refusal(grid, shape, K, n_inner, dtype,
                                         B=B) is None,
        kmax, bands=bands)


def band_call(exts, local, *, K, B, modes, grid, kw, central: bool = True):
    """K banded iterations of the extended stacked buffers `exts = (Pee,
    phie)`: every block's central `local` windows (`central`), or the
    whole evolved extended buffers.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel K times (`chunk_engine.
    streaming_chunk_call`), or raises."""
    shapes = [tuple(local)] * 2

    def launch(src, dst, cfg):
        _band_launch(src, exts, dst, cfg, kw,
                     torch.cuda.current_stream(exts[0].device).cuda_stream)
        band_call.launches += 1

    return streaming_chunk_call(
        list(exts), [], K=K, B=B, modes=modes, grid=grid,
        ols=field_ols(grid, shapes), shapes=shapes, E=K,
        band_update=partial(band_update, kw=kw), extras=(1, 1),
        freeze_fields=(0, 1), launch=launch, central=central)


def _band_launch(src, F, out, cfg, kw, stream: int) -> None:
    """Launch `igg_hm3d_band_step` once (layout `cfg`,
    `chunk_engine.band_cfg`) on checked arguments."""
    coef, npow = coef_args(kw)
    err = library("hm3d_band").igg_hm3d_band_step(
        _ptrs(src), _ptrs(F), _ptrs(out), _DTYPE[src[0].dtype], cfg, coef,
        npow, stream)
    if err:
        raise RuntimeError(f"igg_hm3d_band_step launch failed: CUDA error "
                           f"{err}")


band_call.launches = 0


def fused_hm3d_banded_steps(Pe, phi, *, n_inner: int, K: int, B: int, grid,
                            dx, dy, dz, dt, phi0, npow, eta):
    """Advance `(Pe, phi)` by the `n_inner // K` full chunks of depth K
    through the banded tier (band depth B); returns `(Pe, phi,
    steps_done)`.  Same entry contract as
    :func:`fused_hm3d_trapezoid_steps`."""
    kw = dict(dx=dx, dy=dy, dz=dz, dt=dt, phi0=phi0, npow=npow, eta=eta)
    local = grid.local_shape(Pe)
    modes = dim_modes(grid)
    ols = field_ols(grid, [local, local])

    def one(Pe, phi):
        exts = extend_fields([Pe, phi], ols, K, grid, modes)
        return band_call(exts, local, K=K, B=B, modes=modes, grid=grid,
                         kw=kw)

    return run_chunks((Pe, phi), n_inner=n_inner, K=K, one_chunk=one)
