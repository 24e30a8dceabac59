"""K-step chunks of the wave2d step on periodic grids: kernel
`igg_wave2d_chunk_step` (csrc/wave2d_chunk.cu).

The coupled leapfrog loses two rows of validity per extended side and step
(the pressure reads the fresh velocities, which read the pressure at +-1),
so the margin is `E = 2K`.  Once per chunk the three staggered fields are
extended by E rows beyond both ends of each extended dimension (x always,
y where it holds several blocks) in one grouped slab exchange per
dimension (`igg_torch.ops.chunk_engine.extend_fields`, each field with its
own overlap: `Vx` is 3 in x, `Vy` 3 in y).  K coupled steps then run on the
extended blocks, each one kernel launch that ping-pongs two buffer triples;
where y is one periodic block, every step re-wraps its y edges in the
kernel, each field with its own overlap; the last launch writes each
block's central windows.  Bit for bit what K per-step steps give from an
exchange-fresh state.  Periodic grids only, as in igg: an open mesh takes
the per-step route.

Replaces the wave2d instance of the TPU kernel of `igg/ops/chunk_engine.py`
(`_whole_window_kernel`, `whole_window_chunk_call`) as
`igg/ops/wave2d_pallas.py` (`_chunk_call`, `fused_wave2d_chunk_steps`)
configures it.  The plain version of a chunk, :func:`window_steps_plain`, is
the port of `_window_steps_xla`.  igg's kernel keeps all three extended
fields in VMEM for the K steps; a 4096^2 window (67 MB a field) does not fit
in an SM's shared memory, so the port goes through device memory once a
step.

The streaming banded tier (igg's `wave2d.banded`,
`fused_wave2d_banded_steps`): the same extension, then K steps of x-row
bands of depth B whose windows read the previous step, the band core
derived from the coupled update on one block's windows
(`chunk_engine.band_core_from_window`, margin 2).  igg compiles its
streaming kernel for 3-D fields only, so this 2-D tier runs its plain
realization (`chunk_engine.banded_window_plain`) on the CPU, and on the
card `banded=True` gets igg's refusal and "auto" never takes it: there is
no band kernel for it, as igg has none on its accelerator.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models import wave2d as model
from ._build import library
from ._smem import fit_banded
from .chunk_engine import (admit_banded_geometry, admit_chunk_common,
                           admit_send_slabs, band_core_from_window,
                           central_window, check_chunk_buffers, dim_modes,
                           extend_fields, field_ols, run_chunks, stagger_cfg,
                           streaming_chunk_call, window_chunk_plain)
from .diffusion_pallas import _DTYPE
from .wave2d_pallas import coef_args, field_shapes


def wave2d_chunk_refusal(grid, shape, K: int, n_inner: int,
                         dtype) -> Optional[str]:
    """Why the depth-K chunk cannot run `n_inner` steps of fields whose
    pressure blocks are `shape`, or None when it can: the gates of igg's
    `wave2d_chunk_supported` (a full chunk, unit displacement, an overlap-2
    2-D grid, periodic dims only, 2K-deep send slabs of the three staggered
    fields inside every extended dimension's block and out of the sender's
    shared region) without its VMEM budget; f32 or f64."""
    why = admit_chunk_common(grid, K, n_inner)
    if why is not None:
        return why
    if grid.overlaps != (2, 2, 2):
        return f"grid overlaps {grid.overlaps} != (2, 2, 2)"
    if grid.dims[2] != 1 or grid.nxyz[2] != 1:
        return (f"grid is not a 2-D decomposition (dims={tuple(grid.dims)}, "
                f"nz={grid.nxyz[2]})")
    if tuple(shape) != tuple(grid.nxyz[:2]):
        return f"local shape {tuple(shape)} != grid block {tuple(grid.nxyz[:2])}"
    if dtype not in _DTYPE:
        return f"dtype {dtype} is not float32/float64"
    modes = dim_modes(grid)[:2]
    if any(m in ("oext", "frozen") for m in modes):
        return (f"open (non-periodic) dimensions {modes}: the wave2d chunk "
                f"serves periodic grids only (the per-step route carries "
                f"open boundaries)")
    shapes = field_shapes(shape)
    return admit_send_slabs(shapes, field_ols(grid, shapes), 2 * K, modes,
                            grid=grid)


def fit_wave2d_K(grid, shape, n_inner: int, dtype,
                 K: Optional[int] = None) -> int:
    """The chunk depth of the chunk route (igg's `fit_wave2d_K`): `K` where
    given and admitted, else the largest of 8, 4, 2 the chunk admits; 0
    when none is."""
    for k in ((K,) if K else (8, 4, 2)):
        if wave2d_chunk_refusal(grid, shape, k, n_inner, dtype) is None:
            return k
    return 0


def window_core(grid, kw):
    """The coupled update of every extended block (`block_compute` on the
    extended stacked buffers)."""
    return lambda P, Vx, Vy: model.block_compute(P, Vx, Vy, grid.dims[:2],
                                                 **kw)


def window_steps_plain(exts, *, K, modes, grid, kw, ols):
    """Plain PyTorch version of a chunk (the port of igg's
    `_window_steps_xla`): K window steps of the extended buffers `exts =
    (Pe, Vxe, Vye)` with margin 2K, the y self-wrap on a one-block y with
    the per-field overlaps `ols`, nothing frozen.  Returns the evolved
    extended buffers; :func:`chunk_engine.central_window` cuts the results
    out."""
    return tuple(window_chunk_plain(
        list(exts), K=K, E=2 * K, modes=modes, grid=grid,
        core=window_core(grid, kw), freeze_fields=(), ols=ols))


def chunk_call(exts, shapes, *, K, modes, grid, kw, ols):
    """Advance the extended stacked buffers `exts` (blocks `shapes` extended
    by 2K) by K steps and return every block's central windows (new
    tensors).  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel K times, ping-ponging two buffer triples, the last launch
    writing the outputs, or raises."""
    E = 2 * K
    if exts[0].device.type == "cpu":
        return tuple(central_window(U, s, E, modes) for U, s in zip(
            window_steps_plain(exts, K=K, modes=modes, grid=grid, kw=kw,
                               ols=ols), shapes))
    check_chunk_buffers(list(exts), shapes, E, modes, grid, _DTYPE)
    if list(shapes) != field_shapes(shapes[0]) or len(exts) != 3:
        raise ValueError(f"wave2d chunk: blocks {shapes} are not (P, Vx, Vy)")
    if any(m not in ("ext", "wrap") for m in modes[:2]):
        raise ValueError(f"wave2d chunk: modes {modes} are not periodic")
    out = tuple(torch.empty([grid.dims[d] * s[d] for d in range(2)],
                            dtype=exts[0].dtype, device=exts[0].device)
                for s in shapes)
    bufs = [tuple(torch.empty_like(X) for X in exts) for _ in range(2)]
    stream = torch.cuda.current_stream(exts[0].device).cuda_stream
    src = tuple(exts)
    for k in range(K):
        last = k == K - 1
        dst = out if last else bufs[k % 2]
        _launch(src, dst, chunk_cfg(shapes[0], E, modes, grid, ols, last),
                kw, stream)
        chunk_call.launches += 1
        src = dst
    return out


def chunk_cfg(shape, E: int, modes, grid, ols, last: bool):
    """The layout `igg_wave2d_chunk_step` takes (`Stag` in
    `csrc/stagger_walk.cuh`, :func:`chunk_engine.stagger_cfg`)."""
    return stagger_cfg(shape, E, modes, grid.dims, ols, last)


def _ptrs(tensors):
    return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in tensors])


def _launch(src, out, cfg, kw, stream: int) -> None:
    """Launch `igg_wave2d_chunk_step` once on checked arguments."""
    err = library("wave2d_chunk").igg_wave2d_chunk_step(
        _ptrs(src), _ptrs(out), _DTYPE[src[0].dtype], cfg, coef_args(kw),
        stream)
    if err:
        raise RuntimeError(f"igg_wave2d_chunk_step launch failed: CUDA error "
                           f"{err}")


chunk_call.launches = 0


def fused_wave2d_chunk_steps(P, Vx, Vy, *, n_inner: int, K: int, dx, dy, dt,
                             rho, bulk):
    """Advance `(P, Vx, Vy)` by the `n_inner // K` full chunks of depth K;
    returns `(P, Vx, Vy, steps_done)` and leaves the remainder to the
    caller.  Entry contract (igg's): an overlap-consistent, exchange-fresh
    state, which a per-step step gives."""
    from .. import shared

    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dt=dt, rho=rho, bulk=bulk)
    modes = dim_modes(grid)[:2]
    shapes = field_shapes(grid.local_shape(P))
    ols = field_ols(grid, shapes)

    def one(P, Vx, Vy):
        exts = extend_fields([P, Vx, Vy], ols, 2 * K, grid, modes)
        return chunk_call(exts, shapes, K=K, modes=modes, grid=grid, kw=kw,
                          ols=ols)

    return run_chunks((P, Vx, Vy), n_inner=n_inner, K=K, one_chunk=one)


# ---------------------------------------------------------------------------
# The streaming banded tier (igg's `wave2d.banded`), plain only
# ---------------------------------------------------------------------------

# The coupled chain loses 2 rows of validity per side and step, so the band
# core's low margin is 2 and the per-field high margins are 2 plus the
# x-stagger: (P, Vx, Vy) -> (2, 3, 2).
BAND_LO = 2
BAND_EXTRAS = (2, 3, 2)


def wave2d_banded_refusal(grid, shape, K: int, n_inner: int, dtype, *,
                          B: int = 8) -> Optional[str]:
    """Why the banded tier cannot run `n_inner` steps of fields whose
    pressure blocks are `shape` at depth K and band B, or None when it can:
    the gates of igg's `wave2d_banded_supported` (the chunk's structural
    gates, :func:`wave2d_chunk_refusal`, then the band geometry at the
    margins `BAND_LO`, `BAND_EXTRAS`) without its Mosaic gates, its VMEM
    budget and its float32 gate."""
    why = wave2d_chunk_refusal(grid, shape, K, n_inner, dtype)
    if why is not None:
        return why
    return admit_banded_geometry(field_shapes(shape), 2 * K,
                                 dim_modes(grid)[:2], B=B,
                                 extras=BAND_EXTRAS, lo=BAND_LO)


def fit_wave2d_band(grid, shape, n_inner: int, dtype, kmax: int = 8,
                    bands=(8, 16)):
    """Largest admissible `(K, B)` of the banded tier (igg's
    `fit_wave2d_band`); None when none applies."""
    return fit_banded(
        lambda K, B: wave2d_banded_refusal(grid, shape, K, n_inner, dtype,
                                           B=B) is None, kmax, bands=bands)


def band_call(exts, shapes, *, K, B, modes, grid, kw, ols,
              central: bool = True):
    """K banded steps of the extended stacked buffers `exts = (Pe, Vxe,
    Vye)` (blocks `shapes` extended by 2K): every block's central windows
    (`central`), or the whole evolved extended buffers.  A CPU tensor takes
    the plain realization; a CUDA tensor raises igg's refusal (the
    streaming kernel is 3-D only)."""
    band_update = band_core_from_window(
        lambda P, Vx, Vy: model.block_compute(P, Vx, Vy, (1, 1), **kw),
        BAND_LO)
    return streaming_chunk_call(
        list(exts), [], K=K, B=B, modes=modes, grid=grid, ols=ols,
        shapes=list(shapes), E=2 * K, band_update=band_update,
        extras=BAND_EXTRAS, freeze_fields=(), lo=BAND_LO, central=central)


def fused_wave2d_banded_steps(P, Vx, Vy, *, n_inner: int, K: int, B: int,
                              dx, dy, dt, rho, bulk):
    """Advance `(P, Vx, Vy)` by the `n_inner // K` full chunks of depth K
    through the banded tier (band depth B, CPU tensors); returns `(P, Vx,
    Vy, steps_done)` and leaves the warm-up step before and the remainder
    after to the caller, as :func:`fused_wave2d_chunk_steps` does."""
    from .. import shared

    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dt=dt, rho=rho, bulk=bulk)
    modes = dim_modes(grid)[:2]
    shapes = field_shapes(grid.local_shape(P))
    ols = field_ols(grid, shapes)

    def one(P, Vx, Vy):
        exts = extend_fields([P, Vx, Vy], ols, 2 * K, grid, modes)
        return band_call(exts, shapes, K=K, B=B, modes=modes, grid=grid,
                         kw=kw, ols=ols)

    return run_chunks((P, Vx, Vy), n_inner=n_inner, K=K, one_chunk=one)
