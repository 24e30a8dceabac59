"""K-iteration chunks of the Stokes iteration: kernel
`igg_stokes_chunk_step` (csrc/stokes_chunk.cu).

The pseudo-transient chain loses two rows of validity per extended side
and iteration (the velocities read the fresh pressure, which reads the
velocities at +-1), so the margin is `E = 2K`.  Once per chunk the four
updated staggered fields are extended by E rows beyond both ends of each
extended dimension in one grouped slab exchange per dimension
(`igg_torch.ops.chunk_engine.extend_fields`, each field with its own
overlap: 4 along its own staggered dim, 3 elsewhere); the constant `Rho` is
extended once per call, not per chunk.  K iterations then run on the
extended blocks, each one kernel launch that ping-pongs two buffer
quadruples: where y or z is one periodic block, every iteration re-wraps
its edges in the kernel, each field with its own overlap; on open dims the
three velocities re-freeze from the chunk-entry buffers, each with its own
staggered high plane (the pressure does not freeze: its computed boundary
plane is the per-iteration path's no-write plane); the last launch writes
each block's central windows.  Bit for bit what K per-iteration
iterations give from an overlap-consistent, exchange-fresh state.

Replaces the Stokes instance of the TPU kernel of
`igg/ops/chunk_engine.py` (`_resident_kernel`, `resident_chunk_call`) as
`igg/ops/stokes_trapezoid.py` (`_chunk_call`,
`fused_stokes_trapezoid_iters`) configures it.  The plain version of a
chunk, :func:`window_iters_plain`, is the port of `_window_iters_xla`.
igg's kernel keeps the five extended fields in VMEM for the K iterations;
an extended 288^3 block is 96 MB a field, so the port goes through device
memory once an iteration.  igg's Mosaic band, tile and sublane gates and
its VMEM budget have no counterpart; the port admits float64.

The streaming banded tier (igg's `stokes3d.banded`,
`fused_stokes_banded_iters`): the same extension, then K iterations of
x-row bands of depth B, each band's window read from the previous
iteration (`chunk_engine.streaming_chunk_call`), one launch of
`igg_stokes_band_step` (csrc/stokes_band.cu: the Stokes march of
csrc/stokes_march.cuh in its band mode, x walked in segments of its own,
since the bands do not change the function) an iteration.  Its plain
version is `chunk_engine.banded_window_plain` with :func:`band_update`,
the port of igg's `_band_update`; its gates are igg's
`stokes_banded_supported` without the Mosaic and float32 gates, with the
shared-memory budget of `igg_torch.ops._smem` in place of VMEM
(:func:`stokes_banded_refusal`).
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Optional

import torch

from ..models import stokes3d as model
from ._build import count_launch, library
from ._smem import banded_smem, chunk_budget, fit_banded
from .chunk_engine import (admit_banded_geometry, admit_chunk_common,
                           admit_send_slabs, central_window,
                           check_chunk_buffers, dim_modes, extend_fields,
                           field_ols, run_chunks, stagger_cfg,
                           streaming_chunk_call, window_chunk_plain)
from .diffusion_pallas import _DTYPE
from .stokes_pallas import coef_args, field_shapes

FREEZE_FIELDS = (1, 2, 3)
# Rows each array of the banded tier's window reads above a band (P, Vx, Vy,
# Vz, Rho; Vx is one row longer in x); one row below.
EXTRAS = (1, 2, 1, 1, 1)


def stokes_chunk_refusal(grid, shape, K: int, n_inner: int,
                         dtype) -> Optional[str]:
    """Why the depth-K chunk cannot run `n_inner` iterations of fields whose
    pressure blocks are `shape`, or None when it can: the gates of igg's
    `stokes_trapezoid_supported` (a full chunk, unit displacement, an
    overlap-3 grid, the pressure on the grid block, 2K-deep send slabs of
    the five staggered fields inside every extended dimension's block and
    out of the sender's shared region) without its Mosaic band, tile and
    sublane gates and its VMEM budget; f32 or f64."""
    why = admit_chunk_common(grid, K, n_inner)
    if why is not None:
        return why
    if grid.overlaps != (3, 3, 3):
        return f"grid overlaps {grid.overlaps} != (3, 3, 3)"
    if tuple(shape) != tuple(grid.nxyz) or min(shape) < 3:
        return (f"local shape {tuple(shape)} is not the grid block "
                f"{tuple(grid.nxyz)} of >= 3 cells per dim")
    if dtype not in _DTYPE:
        return f"dtype {dtype} is not float32/float64"
    shapes = field_shapes(shape)
    return admit_send_slabs(shapes, field_ols(grid, shapes), 2 * K,
                            dim_modes(grid), grid=grid)


def fit_stokes_K(grid, shape, n_inner: int, dtype,
                 K: Optional[int] = None) -> int:
    """The chunk depth of the chunk route (igg's `fit_stokes_K`): `K` where
    given and admitted, else the largest of 8, 4, 2 the chunk admits; 0
    when none is."""
    for k in ((K,) if K else (8, 4, 2)):
        if stokes_chunk_refusal(grid, shape, k, n_inner, dtype) is None:
            return k
    return 0


def window_core(grid, Rho_ext, kw):
    """The update of every extended block (`block_compute` on the extended
    stacked buffers, with the extended constant `Rho_ext`)."""
    return lambda P, Vx, Vy, Vz: model.block_compute(
        P, Vx, Vy, Vz, Rho_ext, grid.dims, **kw)


def window_iters_plain(exts, Rho_ext, *, K, modes, grid, kw, ols):
    """Plain PyTorch version of a chunk (the port of igg's
    `_window_iters_xla`): K window iterations of the extended buffers
    `exts = (Pe, Vxe, Vye, Vze)` with margin 2K, the y/z self-wraps with
    the per-field overlaps `ols`, the velocities re-frozen on open dims
    from `exts` (the chunk-entry buffers).  Returns the evolved extended
    buffers; :func:`chunk_engine.central_window` cuts the results out."""
    return tuple(window_chunk_plain(
        list(exts), K=K, E=2 * K, modes=modes, grid=grid,
        core=window_core(grid, Rho_ext, kw), freeze_fields=FREEZE_FIELDS,
        ols=ols))


def chunk_call(exts, Rho_ext, shapes, *, K, modes, grid, kw, ols):
    """Advance the extended stacked buffers `exts` (blocks `shapes` extended
    by 2K) by K iterations and return every block's central windows (new
    tensors).  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel K times, ping-ponging two buffer quadruples, the last launch
    writing the outputs, or raises."""
    E = 2 * K
    if exts[0].device.type == "cpu":
        return tuple(central_window(U, s, E, modes) for U, s in zip(
            window_iters_plain(exts, Rho_ext, K=K, modes=modes, grid=grid,
                               kw=kw, ols=ols), shapes))
    check_chunk_buffers(list(exts) + [Rho_ext], list(shapes[:4]) + [shapes[0]],
                        E, modes, grid, _DTYPE)
    if list(shapes[:4]) != field_shapes(shapes[0])[:4] or len(exts) != 4:
        raise ValueError(f"Stokes chunk: blocks {shapes} are not "
                         f"(P, Vx, Vy, Vz)")
    out = tuple(torch.empty([grid.dims[d] * s[d] for d in range(3)],
                            dtype=exts[0].dtype, device=exts[0].device)
                for s in shapes[:4])
    bufs = [tuple(torch.empty_like(X) for X in exts) for _ in range(2)]
    stream = torch.cuda.current_stream(exts[0].device).cuda_stream
    src = tuple(exts)
    for k in range(K):
        last = k == K - 1
        dst = out if last else bufs[k % 2]
        _launch(src, exts, Rho_ext, dst,
                chunk_cfg(shapes[0], E, modes, grid, ols, last), kw, stream)
        count_launch(chunk_call)
        src = dst
    return out


def chunk_cfg(shape, E: int, modes, grid, ols, last: bool):
    """The layout `igg_stokes_chunk_step` takes (`Stag3` in
    `csrc/stagger_walk3.cuh`, :func:`chunk_engine.stagger_cfg`) for the
    four updated fields."""
    return stagger_cfg(shape, E, modes, grid.dims, ols[:4], last)


def _ptrs(tensors):
    return (ctypes.c_void_p * 4)(*[t.data_ptr() for t in tensors])


def _launch(src, F, Rho_ext, out, cfg, kw, stream: int) -> None:
    """Launch `igg_stokes_chunk_step` once on checked arguments."""
    err = library("stokes_chunk").igg_stokes_chunk_step(
        _ptrs(src), _ptrs(F), Rho_ext.data_ptr(), _ptrs(out),
        _DTYPE[src[0].dtype], cfg, coef_args(kw), stream)
    if err:
        raise RuntimeError(f"igg_stokes_chunk_step launch failed: CUDA error "
                           f"{err}")


chunk_call.launches = 0


def division_mismatches(d: float, *, dtype=torch.float32, lo: int = 0,
                        n: int = 1 << 32, step: int = 1,
                        device="cuda") -> int:
    """How many of the dividends with bits `lo + i * step` (i < n, modulo
    2^32 in float32, 2^64 in float64) the chunk kernel's division by `d`
    (csrc/const_div.cuh) does not round bitwise as `x / d`: the check of
    its reciprocal path (`igg_stokes_div_check`).  Runs the library's check
    kernel on `device` (the CPU only where the library is a host build of
    the source)."""
    bits = 32 if dtype == torch.float32 else 64
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    fn = library("stokes_chunk").igg_stokes_div_check
    fn.argtypes = [ctypes.c_double, ctypes.c_int, ctypes.c_ulonglong,
                   ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = (torch.cuda.current_stream(bad.device).cuda_stream
              if bad.is_cuda else 0)
    err = fn(float(d), _DTYPE[dtype], lo % (1 << bits), step % (1 << bits), n,
             bad.data_ptr(), stream)
    if err:
        raise RuntimeError(f"igg_stokes_div_check launch failed: CUDA error "
                           f"{err}")
    return int(bad.item())


def fused_stokes_trapezoid_iters(P, Vx, Vy, Vz, Rho, *, n_inner: int, K: int,
                                 dx, dy, dz, mu, dtP, dtV):
    """Advance `(P, Vx, Vy, Vz)` by the `n_inner // K` full chunks of depth
    K; returns `(P, Vx, Vy, Vz, iterations_done)` and leaves the remainder
    to the caller.  Entry contract (igg's): an overlap-consistent,
    exchange-fresh state, which a per-iteration iteration gives from any
    state reached from `init_fields`."""
    from .. import shared

    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dz=dz, mu=mu, dtP=dtP, dtV=dtV)
    modes = dim_modes(grid)
    shapes = field_shapes(grid.local_shape(P))
    ols = field_ols(grid, shapes)
    E = 2 * K
    # Rho never changes: its extension is made once per call.
    Rho_ext = extend_fields([Rho], [ols[4]], E, grid, modes)[0]

    def one(P, Vx, Vy, Vz):
        exts = extend_fields([P, Vx, Vy, Vz], ols[:4], E, grid, modes)
        return chunk_call(exts, Rho_ext, shapes, K=K, modes=modes, grid=grid,
                          kw=kw, ols=ols)

    return run_chunks((P, Vx, Vy, Vz), n_inner=n_inner, K=K, one_chunk=one)


# ---------------------------------------------------------------------------
# The streaming banded tier (igg's `stokes3d.banded`)
# ---------------------------------------------------------------------------

def band_update(Wp, Wvx, Wvy, Wvz, Wrho, *, bx, kw):
    """New band values (rows `[a, a+bx)`, window row offset 1) from the
    margin-1 windows (igg's `_band_update`): P, Vy, Vz and Rho window rows
    `[a-1, a+bx+1)`, the x-staggered Vx `[a-1, a+bx+2)`; the pressure on
    every cell, each velocity incremented on its interior y/z faces and
    kept on its y/z edge faces (the band halo owns them)."""
    Pn, dVx, dVy, dVz = model.iteration_core(Wp, Wvx, Wvy, Wvz, Wrho, **kw)
    outs = [Pn[1:1 + bx]]
    for W, dV in ((Wvx, dVx), (Wvy, dVy), (Wvz, dVz)):
        o = W[1:1 + bx]
        inner = o[:, 1:-1, 1:-1] + dV[0:bx]
        mid = torch.cat([o[:, 1:-1, :1], inner, o[:, 1:-1, -1:]], dim=2)
        outs.append(torch.cat([o[:, :1], mid, o[:, -1:]], dim=1))
    return tuple(outs)


def stokes_banded_refusal(grid, shape, K: int, n_inner: int, dtype, *,
                          B: int = 8) -> Optional[str]:
    """Why the banded tier cannot run `n_inner` iterations of fields whose
    pressure blocks are `shape` at depth K and band B, or None when it can:
    the gates of igg's `stokes_banded_supported` (a full chunk, unit
    displacement, an overlap-3 grid, the pressure on the grid block,
    2K-deep send slabs, the band geometry of the five arrays' margins
    `EXTRAS`) without its Mosaic gates (`B % 8`, 3-D only, the sublane
    extension) and its float32 gate; float32 or float64, and the band
    window within a thread block's shared memory (`igg_torch.ops._smem`)
    instead of VMEM.  The window is that of the band walk igg's kernel
    stages; the port's kernel (the Stokes march in band mode) holds the
    same shared memory at every B, and the gate stays igg's, so the tier
    admits what igg's admits."""
    why = admit_chunk_common(grid, K, n_inner)
    if why is not None:
        return why
    if grid.overlaps != (3, 3, 3):
        return f"grid overlaps {grid.overlaps} != (3, 3, 3)"
    if tuple(shape) != tuple(grid.nxyz):
        return (f"local shape {tuple(shape)} != grid block "
                f"{tuple(grid.nxyz)}")
    if dtype not in _DTYPE:
        return f"dtype {dtype} is not float32/float64"
    modes = dim_modes(grid)
    shapes = field_shapes(shape)
    why = (admit_send_slabs(shapes, field_ols(grid, shapes), 2 * K, modes,
                            grid=grid)
           or admit_banded_geometry(shapes, 2 * K, modes, B=B,
                                    extras=EXTRAS))
    if why is not None:
        return why
    need = banded_smem(B, EXTRAS, itemsize=torch.finfo(dtype).bits // 8,
                       stags=[(s[1] - shape[1], s[2] - shape[2])
                              for s in shapes])
    if need > chunk_budget():
        return (f"band window {need} bytes exceeds the shared-memory budget "
                f"{chunk_budget()} of a thread block")
    return None


def fit_stokes_band(grid, shape, n_inner: int, dtype, kmax: int = 8,
                    bands=(8, 16)):
    """Largest admissible `(K, B)` of the banded tier (igg's
    `fit_stokes_band`, `_smem.fit_banded`); None when none applies."""
    return fit_banded(
        lambda K, B: stokes_banded_refusal(grid, shape, K, n_inner, dtype,
                                           B=B) is None,
        kmax, bands=bands)


def band_call(exts, Rho_ext, shapes, *, K, B, modes, grid, kw, ols,
              central: bool = True):
    """K banded iterations of the extended stacked buffers `exts = (Pe,
    Vxe, Vye, Vze)` (blocks `shapes` extended by 2K) with the extended
    constant `Rho_ext`: every block's central windows (`central`), or the
    whole evolved extended buffers.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel K times
    (`chunk_engine.streaming_chunk_call`), or raises."""
    def launch(src, dst, cfg):
        _band_launch(src, exts, Rho_ext, dst, cfg, kw,
                     torch.cuda.current_stream(exts[0].device).cuda_stream)
        count_launch(band_call)

    return streaming_chunk_call(
        list(exts), [Rho_ext], K=K, B=B, modes=modes, grid=grid, ols=ols,
        shapes=list(shapes), E=2 * K, band_update=partial(band_update, kw=kw),
        extras=EXTRAS, freeze_fields=FREEZE_FIELDS, launch=launch,
        central=central, staggered=True)


def _band_launch(src, F, Rho_ext, out, cfg, kw, stream: int) -> None:
    """Launch `igg_stokes_band_step` once (layout `cfg`,
    `chunk_engine.stagger_band_cfg`) on checked arguments."""
    err = library("stokes_band").igg_stokes_band_step(
        _ptrs(src), _ptrs(F), Rho_ext.data_ptr(), _ptrs(out),
        _DTYPE[src[0].dtype], cfg, coef_args(kw), stream)
    if err:
        raise RuntimeError(f"igg_stokes_band_step launch failed: CUDA error "
                           f"{err}")


band_call.launches = 0


def fused_stokes_banded_iters(P, Vx, Vy, Vz, Rho, *, n_inner: int, K: int,
                              B: int, dx, dy, dz, mu, dtP, dtV):
    """Advance `(P, Vx, Vy, Vz)` by the `n_inner // K` full chunks of depth
    K through the banded tier (band depth B); returns `(P, Vx, Vy, Vz,
    iterations_done)` and leaves the warm-up iteration before and the
    remainder after to the caller.  Rho is extended once per call.  Entry
    contract: that of :func:`fused_stokes_trapezoid_iters`."""
    from .. import shared

    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dz=dz, mu=mu, dtP=dtP, dtV=dtV)
    modes = dim_modes(grid)
    shapes = field_shapes(grid.local_shape(P))
    ols = field_ols(grid, shapes)
    E = 2 * K
    Rho_ext = extend_fields([Rho], [ols[4]], E, grid, modes)[0]

    def one(P, Vx, Vy, Vz):
        exts = extend_fields([P, Vx, Vy, Vz], ols[:4], E, grid, modes)
        return band_call(exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                         grid=grid, kw=kw, ols=ols)

    return run_chunks((P, Vx, Vy, Vz), n_inner=n_inner, K=K, one_chunk=one)
