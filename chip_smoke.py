#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`igg_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `igg_torch/csrc` and the sources the
generator (`igg_torch/stencil/cuda.py`) writes for the specs of
`tests/torch_spec_cases.py` (one `nvcc` per source, all started together,
ptxas registers logged), then runs these phases; any failure raises and
the script exits non-zero without printing a result:

1. Kernel checks: each kernel against its plain PyTorch version on the card,
   at small shapes in every halo (or chunk window) mode, then at 256^3 f32
   (the headline's shape), where the kernel, its plain version and the
   bound are timed; the plane packer (f32 and f64, beside the
   `index_select` calls and its sector bound) and the trapezoid chunk step
   at the shape of the 510^3 headline (2x2x2 blocks of 256^3 f32, open).
2. Headline, periodic: 256^3 f32 on one block, `make_multi_step(100)`
   through `run()`: heat conserved, the first 10 steps equal to the plain
   path, ms/step.
3. Headline, open: the same at 512^3 with open boundaries (the reference's
   published configuration); ms/step.
4. Recv mode: dims (2,2,1) at 64x64x128 per block, open and z-periodic, so
   the fused step runs its `recv` and open-edge branches; held against the
   plain path and against the same global problem on one block.
5. Standalone `update_halo` on a 256^3 f32 periodic field and on an f64
   one, against the plain version; us per call.
6. The reference's 510^3 headline on one card: `init_global_grid(256, 256,
   256, dimx=2, dimy=2, dimz=2)`, open, the 8 blocks stacked in one
   process; 17 steps (a warm-up step and two K=8 chunks) equal to the
   per-step route and to the plain path bitwise; ms/step of the chunk route
   through `run()` and of the per-step route, with each route's device
   time split by kernel; peak device memory.
7. Standalone `update_halo` on that 2x2x2 grid, f32 and f64 (the plane
   packer and the halo writer), against the plain version; us per call.
8. HM3D (BASELINE config 4), 256^3 f32 periodic on one block:
   `make_multi_step(100)` through `run()` (the K-step loop), the first 10
   steps equal to the plain path; ms/step, and `make_step`'s wall time
   against its device time per call.
9. HM3D on 2x2x2 blocks of 256^3, periodic (508^3), the blocks stacked on
   the card: 17 steps (a warm-up step and two K=8 chunks) on the chunk
   route equal to the per-step route and to the plain path bitwise;
   ms/step of both routes, each route's device time split by kernel, peak
   device memory.
10. wave2d (BASELINE config 3), 4096^2 f32 periodic on one block:
   `make_multi_step(100)` through `run()` (the chunk route: x extended, y
   wrapped in the kernel); the first 10 steps equal to the per-step route
   and to the plain path bitwise; the discrete energy within igg's 25%
   bound; ms/step of the chunk and per-step routes.
11. wave2d on 8x1 blocks of 4096^2, periodic (32752 x 4094), stacked on the
   card: 17 steps (a warm-up step and two K=8 chunks) on the chunk route
   equal to the per-step route and to the plain path bitwise; ms/step of
   both routes, each route's device time split by kernel, launches per
   call, peak device memory.
12. stokes3d (BASELINE config 5), 256^3 f32 fully periodic on one block
   (overlap 3): 10 iterations on the chunk route (x extended, y and z
   wrapped in the kernel) equal to the per-iteration route and to the
   plain path bitwise; `make_iteration(n_inner=100)` through `run()`, and
   the per-iteration route over the same iterations from the same state;
   ms/iteration of both routes, each one's launches and device time split
   by kernel.
13. stokes3d on 2x2x2 blocks of 256^3, open (509^3), stacked on the card:
   17 iterations (a warm-up iteration and two K=8 chunks, the velocities
   re-frozen on the open edges) on the chunk route equal to the
   per-iteration route and to the plain path bitwise, peak device memory;
   both routes timed as in phase 12 (`make_iteration(n_inner=17)`).
14. shallow water (BASELINE config 3, kernels generated from its
   `igg_torch.stencil` spec), 4096^2 f32 periodic on one block:
   `make_step(n_inner=100)` through `run()` (the chunk route: x extended by
   E = margin_after(8) = 8, y wrapped in the kernel); the first 10 steps
   equal to the per-step route, to the plain path and to the chunk route
   on the kernels' plain versions, bitwise; total mass conserved within
   1e-6; ms/step of both routes and launches per call.
15. shallow water on 8x1 blocks of 4096^2, x periodic and y open (config
   3's 1-D periodic halo; the chunk re-freezes hv's y planes): 17 steps on
   the chunk route equal to the chunk route on the plain versions bitwise
   and to the per-step route within 2e-5 (igg's bound for open spec
   chunks; the log says whether bitwise); ms/step of both routes, device
   time split by kernel, launches per call, peak device memory.
16. diffusion on the banded tier (`make_multi_step(17, banded=True, K=8,
   band=8)`: a warm-up step, two chunks of K launches of the band kernel):
   256^3 f32 periodic on one block, bitwise the K-step loop, and the 510^3
   headline (2x2x2 blocks of 256^3, open), bitwise the trapezoid chunk
   route, each from `update_halo(*init_fields())`; ms/step through
   `run()`, launches per call, device time split by kernel, peak device
   memory.
17. HM3D on the banded tier: 256^3 periodic on one block (bitwise the
   K-step loop) and 508^3 periodic on 2x2x2 blocks of 256^3 (bitwise the
   chunk route); the same numbers.
18. stokes3d on the banded tier (`make_iteration(n_inner=17, banded=True,
   K=8, band=8)`: a warm-up iteration, two chunks of K launches of the
   Stokes band kernel), 256^3 periodic on one block (overlap 3), bitwise
   the chunk route from `update_halo(*init_fields())` evolved by 17
   iterations; ms/iteration of both routes through `run()` over one
   trajectory, launches and device time per call, peak device memory.
19. The same at 509^3 open on 2x2x2 blocks of 256^3 (config 5 at 8
   blocks).
20. relax3d (a rank-3 spec) on the banded route, 256^3 periodic on one
   block, `igg_torch.stencil.compile(n_inner=17, banded=True, K=8,
   band=8)` bitwise the spec chunk route; ms/step of both, launches and
   device time per call.

Phase 1 also holds the HM3D kernels (the fused two-field step, its use as
the one-block K-step loop, the chunk step, timed at 2x2x2 blocks of
256^3 periodic in f32 and f64) and the wave2d kernels (the
staggered leapfrog step, the chunk step) and the Stokes kernels (the fused
iteration, the chunk step, whose float32 division is also held to `x / d`
over all 2^32 dividends for every divisor of the Stokes phases, and which
is timed at 2x2x2 blocks of 256^3 open in f32 and f64 and at one 256^3
periodic block) and the generated spec step and chunk step (five
specs; spec-wave2d also against the hand wave2d kernels) against their
plain versions in every halo and window mode, f32 and f64, and times them
at their main paths' shapes, and the diffusion and HM3D band kernels
against their plain version (`banded_window_plain`) in every window mode,
f32 and f64, B = 8 and 16 with two and three bands, on the whole evolved
buffers and the central windows, then times them at 2x2x2 blocks of 256^3
(K = 8, B = 8), in f32 and f64; and the staggered band kernels
(the Stokes band step, the generated band entry of the rank-3 specs
relax3d and acoustic3d) the same way, then the Stokes one at 2x2x2 blocks
of 256^3 open (f32 and f64) and the generated band entry of relax3d and
acoustic3d at one 256^3 periodic block (K = 8, B = 8), f32 and f64, and
their generated step and K = 8 chunk step (igg_spec_step on the same
x-march's step and chunk modes) at that block, f32 and f64.  The
redesigned kernels are timed beside their first designs too
(kernel_variants.py: FIRST_DESIGNS and spec_first_source, built with
the sources), each by the profiler's device time of the kernel it names:
the Stokes and HM3D band kernels in f32, the HM3D chunk and diffusion
band kernels, the generated band, step and chunk entries and the halo
writer (at 256^3
periodic and at 2x2x2 blocks of 256^3 EXT, beside its 32-byte-sector
bound and its event time a launch) in f32 and f64; and the march division
(const_div.cuh) is held to `x / d` over all 2^32 float32 dividends for the
Stokes and HM3D divisors.  Launch counters are set to 0 before each
main-path phase (2 to 20) and read after it; each of the twenty kernels
must have launched on that main path (the generated relax3d step and
chunk step are phase 20's launches of the spec counters, shallow water's
the others').  The last lines are the run's seconds, the
`{"kernels": [...]}` summary, the card's name and power limit, and
`{"ok": true, "device": {...}}`.  Needs `torch.cuda.is_available()`; no
JAX and nothing of the `igg` package is imported.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
# Floating-point operations of one interior cell of the 7-point update
# (three pair sums, three scalings, two accumulations, the centre term and
# its subtraction, the coefficient product and the final add).
STENCIL_FLOPS = 12
# ... of one interior cell of the HM3D update at npow = 3, each face counted
# once: the permeability (a division, two products), three faces (mean: an
# add and a product; flux: a negation, a difference, a product and a
# division), the divergence (three differences, three divisions, two
# adds), Pe' (a product, a division, a negation, a difference, a product,
# an add) and phi' (a negation, a difference, two products, a division, a
# product, an add).
HM3D_FLOPS = 3 + 3 * 6 + 8 + 6 + 7
# ... of one cell of the wave2d update, each face counted once: a face of
# Vx and one of Vy (a difference, a product, a division, an add each) and
# P' (two differences, two divisions, an add, a product, a difference).
WAVE2D_FLOPS = 2 * 4 + 7
# ... of one cell of the Stokes iteration, each quotient, stress and face
# counted once: the divergence (three differences, three divisions, two
# adds), P' (a product, a difference), divV/3 (a division), three normal
# stresses (a difference, a product each), three shear stresses (two
# differences, two divisions, an add, a product each), three residuals
# (four differences, four divisions, three adds each), the buoyancy (two
# adds, a product) and three velocity updates (a product, an add each).
STOKES_FLOPS = 8 + 2 + 1 + 3 * 2 + 3 * 6 + 3 * 11 + 3 + 3 * 2

PERIODIC = dict(periodx=1, periody=1, periodz=1)
SINGLE = dict(dimx=1, dimy=1, dimz=1)
# Grids of the small-shape kernel checks: every halo mode of each kernel.
SMALL_GRIDS = {
    "wrap": dict(SINGLE, **PERIODIC),
    "frozen": SINGLE,
    "wrap_y_frozen_xz": dict(SINGLE, periody=1),
    "wrap_xz_frozen_y": dict(SINGLE, periodx=1, periodz=1),
    "recv_2x2x1_open": dict(dimx=2, dimy=2, dimz=1),
    "recv_2x2x2_periodic": dict(dimx=2, dimy=2, dimz=2, **PERIODIC),
    "recv_x_wrap_yz": dict(dimx=2, dimy=1, dimz=1, periody=1, periodz=1),
    "recv_yz_open_x": dict(dimx=1, dimy=2, dimz=2, periody=1),
}
# Local shapes of those checks: odd z extents (the kernels' element path),
# and 16-byte rows with block edges inside a vector (the vector path).
SMALL_SHAPES = ((12, 10, 33), (10, 12, 10))

KERNEL_INFO = {
    "diffusion_step": dict(
        source="igg_torch/csrc/diffusion_step.cu",
        replaces="igg/ops/diffusion_pallas.py:337"),
    # The K-step loop: the step kernel launched once per step on two
    # ping-pong buffers, counted by its own wrapper.
    "diffusion_mega_step": dict(
        source="igg_torch/csrc/diffusion_step.cu",
        replaces="igg/ops/diffusion_mega.py:414"),
    "halo_write": dict(
        source="igg_torch/csrc/halo_write.cu",
        replaces="igg/ops/halo_write.py:276"),
    "pack_planes": dict(
        source="igg_torch/csrc/pack_planes.cu",
        replaces="igg/ops/pack.py:77"),
    "diffusion_chunk_step": dict(
        source="igg_torch/csrc/diffusion_chunk.cu",
        replaces="igg/ops/diffusion_trapezoid.py:533"),
    "hm3d_step": dict(
        source="igg_torch/csrc/hm3d_step.cu",
        replaces="igg/ops/hm3d_pallas.py:368"),
    # The one-block K-step loop: the HM3D step kernel launched once per step
    # on two ping-pong pairs, counted by its own wrapper.
    "hm3d_mega_step": dict(
        source="igg_torch/csrc/hm3d_step.cu",
        replaces="igg/ops/hm3d_mega.py:249"),
    # The HM3D instance of the resident banded K-step window.
    "hm3d_chunk_step": dict(
        source="igg_torch/csrc/hm3d_chunk.cu",
        replaces="igg/ops/chunk_engine.py:985"),
    "wave2d_step": dict(
        source="igg_torch/csrc/wave2d_step.cu",
        replaces="igg/ops/wave2d_pallas.py:144"),
    # The wave2d instance of the whole-window K-step chunk.
    "wave2d_chunk_step": dict(
        source="igg_torch/csrc/wave2d_chunk.cu",
        replaces="igg/ops/chunk_engine.py:648"),
    "stokes_step": dict(
        source="igg_torch/csrc/stokes_step.cu",
        replaces="igg/ops/stokes_pallas.py:445"),
    # The Stokes instance of the resident banded K-step window.
    "stokes_chunk_step": dict(
        source="igg_torch/csrc/stokes_chunk.cu",
        replaces="igg/ops/chunk_engine.py:985"),
    # The kernels generated from the shallow-water spec: the per-step kernel
    # and the spec instance of the whole-window K-step chunk, counted by the
    # generated kernels' wrappers (every spec's launches).
    # `phases`: the launches of the main path's phases counted for an
    # instance (phase 20 drives relax3d, the others shallow water).
    "spec_step[shallow_water]": dict(
        source="igg_torch/stencil/cuda.py", counter="spec_step",
        phases="not 20", replaces="igg/stencil/lower.py:234"),
    "spec_chunk_step[shallow_water]": dict(
        source="igg_torch/stencil/cuda.py", counter="spec_chunk_step",
        phases="not 20", replaces="igg/ops/chunk_engine.py:648"),
    # The generated rank-3 step and chunk step of relax3d (both launch the
    # one entry igg_spec_step, on the x-march of
    # csrc/stagger_band_march3.cuh), phase 20's.
    "spec_step[relax3d]": dict(
        source="igg_torch/stencil/cuda.py", counter="spec_step",
        phases="20", replaces="igg/stencil/lower.py:234"),
    "spec_chunk_step[relax3d]": dict(
        source="igg_torch/stencil/cuda.py", counter="spec_chunk_step",
        phases="20", replaces="igg/ops/chunk_engine.py:648"),
    # The diffusion and HM3D instances of the streaming banded K-step
    # window: one launch per iteration.
    "diffusion_band_step": dict(
        source="igg_torch/csrc/diffusion_band.cu",
        replaces="igg/ops/chunk_engine.py:1455"),
    "hm3d_band_step": dict(
        source="igg_torch/csrc/hm3d_band.cu",
        replaces="igg/ops/chunk_engine.py:1455"),
    # Its Stokes instance (the Stokes march's band mode) and the rank-3
    # spec instances (generated, counted by the generated band entry's
    # wrapper: every spec's launches, on the x-march
    # csrc/stagger_band_march3.cuh).
    "stokes_band_step": dict(
        source="igg_torch/csrc/stokes_band.cu",
        replaces="igg/ops/chunk_engine.py:1455"),
    "spec_band_step[relax3d]": dict(
        source="igg_torch/stencil/cuda.py", counter="spec_band_step",
        replaces="igg/ops/chunk_engine.py:1455"),
}
# Layouts of the small wave2d checks, as init_global_grid keywords.
WAVE_GRIDS = {
    "1x1_periodic": dict(dimx=1, dimy=1, periodx=1, periody=1),
    "4x2_periodic": dict(dimx=4, dimy=2, periodx=1, periody=1),
    "8x1_periodic": dict(dimx=8, dimy=1, periodx=1, periody=1),
    "2x1_periodic": dict(dimx=2, dimy=1, periodx=1, periody=1),
    "2x2_periodic": dict(dimx=2, dimy=2, periodx=1, periody=1),
    "1x1_open": dict(dimx=1, dimy=1),
    "4x2_open": dict(dimx=4, dimy=2),
    "8x1_open": dict(dimx=8, dimy=1),
    "2x1_open": dict(dimx=2, dimy=1),
}
# Local shapes of those checks and the chunk depths each admits: even and
# odd y extents (Vy rows of 11, 14 and 22 elements).
WAVE_SHAPES = (((12, 10), (2,)), ((16, 13), (2, 4)), ((24, 21), (2, 4, 8)))
# Grids of the small-shape chunk checks: every window mode (ext, wrap, oext,
# frozen), as (dims, periods).
CHUNK_GRIDS = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "ring_open": ((8, 1, 1), (0, 0, 0)),
    "4x2x1_periodic": ((4, 2, 1), (1, 1, 1)),
    "2x2x2_periodic": ((2, 2, 2), (1, 1, 1)),
    "4x1x2_periodic": ((4, 1, 2), (1, 1, 1)),
    "2x2x2_periods010": ((2, 2, 2), (0, 1, 0)),
    "2x2x2_periods101": ((2, 2, 2), (1, 0, 1)),
    "1x2x2_open": ((1, 2, 2), (0, 0, 0)),
    "2x1x1_wrap_y_frozen_z": ((2, 1, 1), (0, 1, 0)),
}
# Local shapes of the chunk checks: the vector path, and odd extents (the
# element path).
CHUNK_SHAPES = ((16, 16, 16), (16, 12, 13))
K_CHUNK = 8
OL3 = dict(overlapx=3, overlapy=3, overlapz=3)
# Layouts of the small Stokes checks (overlap 3): igg's trapezoid matrix
# (every window mode: ext, wrap, oext, frozen) and one-block grids.
STOKES_GRIDS = {
    "ring_periodic": dict(dimx=8, dimy=1, dimz=1, **PERIODIC),
    "ring_open": dict(dimx=8, dimy=1, dimz=1),
    "2x2x2_periodic": dict(dimx=2, dimy=2, dimz=2, **PERIODIC),
    "2x2x2_open": dict(dimx=2, dimy=2, dimz=2),
    "2x2x2_periods010": dict(dimx=2, dimy=2, dimz=2, periody=1),
    "4x2x1_periods101": dict(dimx=4, dimy=2, dimz=1, periodx=1, periodz=1),
    "1x1x1_periodic": dict(SINGLE, **PERIODIC),
    "1x1x1_open": SINGLE,
    "1x1x1_periods101": dict(SINGLE, periodx=1, periodz=1),
}
# Local shapes of those checks and the chunk depths each admits: 16-byte P
# rows, odd extents, and z extents that cross the chunk kernel's 32-cell
# tiles and end in a ragged one.
STOKES_SHAPES = (((16, 16, 16), (2,)), ((15, 14, 17), (2, 3)),
                 ((24, 24, 24), (2, 4)), ((13, 13, 33), (2, 3)))
STOKES_NAMES = ("P", "Vx", "Vy", "Vz")
# The step kernels' names in a profiler trace: the HM3D march with the
# fused step's edge rules (its K-step loop launches it too) and the Stokes
# step's own march.
HM3D_STEP_KERNEL = "StepEdges"
STOKES_STEP_KERNEL = "stokes_step_kernel"


# The generated-kernel checks take their specs, layouts and local shapes
# from tests/torch_spec_cases.py (shallow water with and without friction,
# spec-wave2d, a `pow`/`where`/scalar-division spec, the rank-3 relax3d; every
# window mode and config 3's x-periodic, y-open ring), imported in main().
# Floating-point operations of one cell of the shallow-water update: those
# of wave2d (the same chain without friction).
SW_FLOPS = WAVE2D_FLOPS
# ... of one interior cell of relax3d: five adds of the six neighbours, the
# centre's product and subtraction, the coefficient's product, the add.
RELAX3D_FLOPS = 9
# ... of one cell of acoustic3d: three face velocities (a difference, a
# product, a division, an add each) and the pressure (three differences,
# three divisions, two adds, a product, a difference).
SPEC_FLOPS = {"relax3d": RELAX3D_FLOPS, "acoustic3d": 3 * 4 + 10}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(got, want) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SmokeFailure(f"shape/dtype {tuple(got.shape)} {got.dtype} != "
                           f"{tuple(want.shape)} {want.dtype}")
    if not torch.is_floating_point(got):
        return float((got != want).sum())
    return float((got.double() - want.double()).abs().max())


def check(what: str, got, want, tol: float) -> float:
    err = max_abs_err(got, want)
    if not err <= tol:
        raise SmokeFailure(f"{what}: max abs err {err:.3e} > tolerance {tol:.1e}")
    return err


def event_ms(fn, n: int) -> float:
    """Mean device ms of `fn()` over `n` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profiled_device_ms(fn, n: int, kernel: str, launches=None, tries=3):
    """profiled_device_ms_once, its trace taken again (up to `tries` times)
    where it holds no device time for the kernel: the profiler now and
    then loses a whole trace."""
    for left in range(tries - 1, -1, -1):
        try:
            ms = profiled_device_ms_once(fn, n, kernel, launches)
        except SmokeFailure:
            if not left:
                raise
            continue
        if ms is not None or not left:
            return ms
    return None


def profiled_device_ms_once(fn, n: int, kernel: str, launches=None):
    """Mean device ms per launch of the CUDA kernel whose name contains
    `kernel`, from a `torch.profiler` trace of `n` calls of `fn()`; None
    when the trace holds no device time for it.  Given `launches` (a
    call's launches of the kernel), `kernel` is the kernel's own name
    (template arguments included where it is a template), the trace holds
    one more call first (the profiler drops the first launch it sees now
    and then), and it must hold from n * launches to (n + 1) * launches
    launches of that kernel, or the timing raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n if launches is None else n + 1):
            fn()
        torch.cuda.synchronize()
    if launches is not None:
        own = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}"
                         rf"(?![A-Za-z0-9_])")
        count, total = 0, 0.0
        for evt in prof.key_averages():
            if own.search(evt.key) and evt.count:
                count += evt.count
                total += getattr(evt, "device_time_total",
                                 getattr(evt, "cuda_time_total", 0.0))
        if not n * launches <= count <= (n + 1) * launches or not total:
            raise SmokeFailure(
                f"the trace of {n + 1} calls holds {count} launches of "
                f"{kernel} ({total:.1f} us of device time), expected "
                f"{n * launches} to {(n + 1) * launches}")
        return total / count / 1e3
    for evt in prof.key_averages():
        if kernel in evt.key and evt.count:
            total = getattr(evt, "device_time_total",
                            getattr(evt, "cuda_time_total", 0.0))
            if total:
                return total / evt.count / 1e3
    return None


def device_ms_by_kernel(fn, n: int):
    """Device ms per call of `fn()` of each CUDA kernel it launches, by
    kernel name (cut to 80 characters; kernels whose cut names agree are
    summed), from a `torch.profiler` trace of `n` calls, and the number of
    kernel launches per call; ({}, 0) when the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out, launches = {}, 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        total = (getattr(evt, "self_device_time_total", 0)
                 or getattr(evt, "self_cuda_time_total", 0))
        if total:
            key = evt.key[:80]
            out[key] = out.get(key, 0.0) + total / n / 1e3
            launches += evt.count
    return out, launches / n


def kernel_time(fn, n: int, kernel: str, launches=None) -> dict:
    """A kernel's time: its device time from the profiler where the trace
    has it, else the event time of `n` back-to-back calls (which, for a
    kernel shorter than its launch, is the host's launch rate); with
    `launches`, as profiled_device_ms takes it."""
    events = event_ms(fn, n)
    device = profiled_device_ms(fn, n, kernel, launches)
    return dict(ms=events if device is None else device,
                ms_from="events" if device is None else "profiler",
                events_ms=events)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def pack_sector_bytes(shape, dims, reqs, esize) -> float:
    """Compulsory bytes of one plane-packer launch on the card: each y-plane
    cell read and written once, each z-plane cell written once, and the
    distinct 32-byte sectors that hold the z planes' cells read once (a
    sector that serves two requests counts once)."""
    G0, G1, G2 = shape
    s2 = G2 // dims[2]
    y_cells = sum(G0 * dims[1] * G2 for d, _ in reqs if d == 1)
    z_cells = sum(G0 * G1 * dims[2] for d, _ in reqs if d == 2)
    cols = np.array(sorted({c * s2 + p for d, p in reqs if d == 2
                            for c in range(dims[2])}), dtype=np.int64)
    rows = np.arange(G0 * G1, dtype=np.int64) * G2
    sectors = np.unique((rows[:, None] + cols[None, :]) * esize // 32).size \
        if cols.size else 0
    return float((2 * y_cells + z_cells) * esize + 32 * sectors)


def halo_sector_bytes(shape, dims, specs, esize) -> float:
    """Compulsory bytes of one halo-writer launch on the card: each x- and
    y-plane cell read once (from the field or its EXT plane) and written
    once, the z planes' cells by the 32-byte sectors they lie in: the
    distinct sectors of each (x, y) row that hold its z halo cells
    (written) and their WRAP sources (read; a sector read and written
    counts twice), their EXT values read once each."""
    G0, G1, G2 = shape
    n0, n1, n2 = dims
    cells = 0
    z = None
    for sp in specs:
        d = sp[0]
        if d < 2:
            cells += 2 * dims[d] * G0 * G1 * G2 // shape[d]
        else:
            z = sp
    total = 2.0 * cells * esize
    if z is not None:
        s2 = G2 // n2
        tgt = [b * s2 + r for b in range(n2) for r in (0, s2 - 1)]
        rows = np.arange(G0 * G1, dtype=np.int64) * G2
        sectors = lambda cols: np.unique(
            (rows[:, None] + np.array(cols, dtype=np.int64)[None, :])
            * esize // 32).size
        total += 32.0 * sectors(tgt)
        if z[1] == "wrap":
            total += 32.0 * sectors([s2 - z[2], z[2] - 1])
        else:
            total += float(len(tgt) * G0 * G1 * esize)
    return total


def uniform(shape, lo, hi, dtype, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.rand(shape, generator=g, dtype=torch.float64, device=dev)
            * (hi - lo) + lo).to(dtype)


class Smoke:
    """State of one run: the device, the sizes, and what each phase found."""

    def __init__(self, dev, *, n_head=256, n_open=512, recv_local=(64, 64, 128),
                 small=SMALL_SHAPES, n_inner=100, nt=8, halo_calls=200,
                 time_iters=50, n_multi=256, steps_multi=17, nt_multi=32,
                 n_wave=4096, wave_blocks=8, n_stokes=256):
        import igg_torch as it
        from igg_torch import halo, ops
        from igg_torch.models import diffusion3d as t3
        from igg_torch.models import hm3d as h3
        from igg_torch.ops import chunk_engine as ce
        from igg_torch.ops import diffusion_mega as dm
        from igg_torch.ops import diffusion_pallas as dp
        from igg_torch.ops import diffusion_trapezoid as dtz
        from igg_torch.ops import halo_write as hw
        from igg_torch.ops import hm3d_mega as hm
        from igg_torch.ops import hm3d_pallas as hp
        from igg_torch.ops import hm3d_trapezoid as htz
        from igg_torch.ops import pack as pk
        from igg_torch.models import wave2d as w2
        from igg_torch.ops import wave2d_pallas as wp
        from igg_torch.ops import wave2d_trapezoid as wtz
        from igg_torch.models import stokes3d as st3
        from igg_torch.ops import stokes_pallas as sp
        from igg_torch.ops import stokes_trapezoid as stz
        from igg_torch.models import shallow_water as sw
        from igg_torch.stencil import cuda
        from igg_torch.stencil import lower as sl

        self.it, self.halo, self.ops, self.t3 = it, halo, ops, t3
        self.w2, self.wp, self.wtz = w2, wp, wtz
        # wave2d: n_wave^2 blocks, one and wave_blocks x 1 of them.
        self.n_wave, self.wave_blocks = n_wave, wave_blocks
        # stokes3d: n_stokes^3 blocks, one and 2x2x2 of them.
        self.st3, self.sp, self.stz = st3, sp, stz
        self.n_stokes = n_stokes
        # Stencil specs: the generator, the lowering, shallow water.
        self.cuda, self.sl, self.sw = cuda, sl, sw
        import torch_spec_cases
        self.cases = torch_spec_cases
        self.dm, self.dp, self.hw = dm, dp, hw
        self.ce, self.dtz, self.pk = ce, dtz, pk
        self.h3, self.hp, self.hm, self.htz = h3, hp, hm, htz
        self.dev = dev
        self.n_head, self.n_open, self.recv_local = n_head, n_open, recv_local
        # The 510^3 headline: 2x2x2 blocks of n_multi^3, steps_multi steps
        # per call, nt_multi timed calls (a slope over 16 calls at 32).
        self.n_multi, self.steps_multi = n_multi, steps_multi
        self.nt_multi = nt_multi
        self.small, self.n_inner, self.nt = small, n_inner, nt
        self.halo_calls, self.time_iters = halo_calls, time_iters
        self.err = {name: 0.0 for name in KERNEL_INFO}
        self.perf = {}
        # The redesigned kernels' first designs, {library: CDLL}, and the
        # generated rank-3 libraries' with the band entry's first design,
        # {spec name: CDLL} (main()).
        self.first, self.first_gen = {}, {}
        self.launches = None

    def grid(self, n, **kw):
        if self.it.grid_is_initialized():
            self.it.finalize_global_grid()
        self.it.init_global_grid(*n, quiet=True, device=self.dev, **kw)
        return self.it.get_global_grid()

    def note(self, name, err):
        self.err[name] = max(self.err[name], err)

    # -- phase 1 ----------------------------------------------------------
    def kernel_checks(self):
        """Each kernel against its plain version; tolerance 0: the kernels
        copy bits or, built with -fmad=false, round every operation like
        the plain PyTorch version."""
        dp, dm, hw, halo = self.dp, self.dm, self.hw, self.halo
        sc = dp.scal(0.3, 0.4, 0.5)
        for case, kw, local in ((c, kw, s) for c, kw in SMALL_GRIDS.items()
                                for s in self.small):
            g = self.grid(local, **kw)
            shp = self.it.stacked_shape(g.nxyz)
            for dtype in (torch.float32, torch.float64):
                T = uniform(shp, -10, 10, dtype, self.dev, 1)
                A = uniform(shp, 0.01, 0.1, dtype, self.dev, 2)
                modes = dp.step_modes(g)
                recv = dp.step_recv_planes(T, A, g, modes, sc)
                ref = dp.step_plain(T, A, modes, recv, g.dims, sc)
                out = dp.step_kernel(T, A, modes, recv, g.dims, sc)
                self.note("diffusion_step",
                          check(f"diffusion_step {case} {dtype}", out, ref, 0.0))
                if g.dims == (1, 1, 1):
                    dst = dm.mega_step_kernel(T, A, torch.empty_like(T), modes, sc)
                    self.note("diffusion_mega_step",
                              check(f"diffusion_mega_step {case} {dtype}",
                                    dst, ref, 0.0))
                self.hm3d_step_check(g, modes, dtype, f"{case} {local}")
            lshapes = [g.nxyz, (g.nxyz[0] + 1,) + g.nxyz[1:],
                       g.nxyz[:2] + (g.nxyz[2] + 1,)]
            for lshape in lshapes:
                for dtype in (torch.float16, torch.float32, torch.float64,
                              torch.int64):
                    A = uniform(self.it.stacked_shape(lshape), -100, 100,
                                torch.float64, self.dev, 3).to(dtype)
                    ref = A.clone()
                    halo._update_field(ref, g, hw.halo_write_plain)
                    halo._update_field(A, g, hw.halo_write)
                    self.note("halo_write", check(
                        f"halo_write {case} {lshape} {dtype}", A, ref, 0.0))
        # Overlap 3 and a 2-D field through the writer.
        for n, kw, lshape in (((8, 9, 12), dict(PERIODIC, overlapx=3, dimx=2,
                                                dimy=1, dimz=1), (8, 9, 12)),
                              ((8, 9, 1), dict(periodx=1, dimx=2, dimy=1),
                               (8, 9))):
            g = self.grid(n, **kw)
            A = uniform(self.it.stacked_shape(lshape), -1, 1, torch.float32,
                        self.dev, 4)
            ref = A.clone()
            halo._update_field(ref, g, hw.halo_write_plain)
            halo._update_field(A, g, hw.halo_write)
            self.note("halo_write", check(f"halo_write {kw} {lshape}", A, ref, 0.0))
        self.chunk_and_pack_checks()
        log(f"[phase 1] small-shape kernel checks passed: max abs err "
            f"{json.dumps(self.err)} (tolerance 0)")
        self.kernel_checks_headline()
        self.kernel_checks_multiblock()
        self.hm3d_kernel_checks_headline()
        self.hm3d_kernel_checks_multiblock()
        self.wave2d_kernel_checks()
        self.wave2d_kernel_checks_full()
        self.stokes_kernel_checks()
        self.stokes_kernel_checks_full()
        self.spec_kernel_checks()
        self.spec_kernel_checks_full()
        self.band_kernel_checks()
        self.band_kernel_checks_full()
        self.stagger_band_checks()
        self.stagger_band_checks_full()

    def hm3d_input(self, shape, dtype, seed):
        """Random Pe and phi in the ranges of the HM3D initial state."""
        return (uniform(shape, -0.5, 0.0, dtype, self.dev, seed),
                uniform(shape, 0.1, 0.2, dtype, self.dev, seed + 1))

    def hm3d_step_check(self, g, modes, dtype, tag):
        """The HM3D step (and, on one block, its K-step loop's launch)
        against its plain version on grid `g`."""
        hp, hm = self.hp, self.hm
        kw = self.h3.Params().step_kwargs()
        Pe, phi = self.hm3d_input(self.it.stacked_shape(g.nxyz), dtype, 31)
        recv = hp.step_recv_planes(Pe, phi, g, modes, kw)
        ref = hp.step_plain(Pe, phi, modes, recv, g.dims, kw)
        out = hp.step_kernel(Pe, phi, modes, recv, g.dims, kw)
        for f, name in enumerate(("Pe", "phi")):
            self.note("hm3d_step", check(f"hm3d_step {name} {tag} {dtype}",
                                         out[f], ref[f], 0.0))
        if g.dims == (1, 1, 1):
            dst = hm.mega_step_kernel(Pe, phi, (torch.empty_like(Pe),
                                                torch.empty_like(phi)),
                                      modes, kw)
            for f, name in enumerate(("Pe", "phi")):
                self.note("hm3d_mega_step", check(
                    f"hm3d_mega_step {name} {tag} {dtype}", dst[f], ref[f],
                    0.0))

    def hm3d_chunk(self, g, Pe, phi, kw):
        """The extended buffers of a K_CHUNK chunk of (Pe, phi), the kernel's
        result and the plain version's."""
        ce, htz = self.ce, self.htz
        modes = ce.dim_modes(g)
        exts = ce.extend_fields([Pe, phi], ce.field_ols(g, [g.nxyz] * 2),
                                K_CHUNK, g, modes)
        out = htz.chunk_call(exts, g.nxyz, K=K_CHUNK, modes=modes, grid=g,
                             kw=kw)
        ref = [ce.central_window(U, g.nxyz, K_CHUNK, modes) for U in
               htz.window_steps_plain(*exts, K=K_CHUNK, modes=modes, grid=g,
                                      kw=kw)]
        return exts, modes, out, ref

    def chunk_input(self, g, dtype, seed):
        """Random T and A on grid `g`, extended for a K_CHUNK chunk."""
        ce = self.ce
        shp = self.it.stacked_shape(g.nxyz)
        T = uniform(shp, -10, 10, dtype, self.dev, seed)
        A = uniform(shp, 0.001, 0.1, dtype, self.dev, seed + 1)
        modes = ce.dim_modes(g)
        ols = ce.field_ols(g, [g.nxyz])
        Text, A_ext = ce.extend_fields([T, A], ols * 2, K_CHUNK, g, modes)
        return T, Text, A_ext, modes

    def chunk_and_pack_checks(self):
        """The chunk step in every window mode and the packer on y/z-split
        grids, against their plain versions at small shapes."""
        ce, dtz, pk = self.ce, self.dtz, self.pk
        sc = self.dp.scal(0.3, 0.4, 0.5)
        for (case, (dims, per)), local in ((c, s) for c in CHUNK_GRIDS.items()
                                           for s in CHUNK_SHAPES):
            kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2],
                      periodx=per[0], periody=per[1], periodz=per[2])
            g = self.grid(local, **kw)
            for dtype in (torch.float32, torch.float64):
                why = dtz.trapezoid_refusal(g, g.nxyz, K_CHUNK, K_CHUNK, dtype)
                if why is not None:
                    raise SmokeFailure(f"chunk {case} {local}: refused: {why}")
                T, Text, A_ext, modes = self.chunk_input(g, dtype, 11)
                out = dtz.chunk_call(Text, A_ext, g.nxyz, K=K_CHUNK,
                                     modes=modes, grid=g, sc=sc)
                ref = ce.central_window(dtz.window_steps_plain(
                    Text, A_ext, K=K_CHUNK, modes=modes, grid=g, sc=sc),
                    g.nxyz, K_CHUNK, modes)
                self.note("diffusion_chunk_step", check(
                    f"diffusion_chunk_step {case} {local} {dtype}", out, ref,
                    0.0))
                why = self.htz.hm3d_trapezoid_refusal(g, g.nxyz, K_CHUNK,
                                                      K_CHUNK, dtype)
                if why is not None:
                    raise SmokeFailure(f"hm3d chunk {case} {local}: refused: "
                                       f"{why}")
                Pe, phi = self.hm3d_input(self.it.stacked_shape(g.nxyz),
                                          dtype, 15)
                _, _, out, ref = self.hm3d_chunk(
                    g, Pe, phi, self.h3.Params().step_kwargs())
                for f, name in enumerate(("Pe", "phi")):
                    self.note("hm3d_chunk_step", check(
                        f"hm3d_chunk_step {name} {case} {local} {dtype}",
                        out[f], ref[f], 0.0))
            reqs = [(d, p) for d in (1, 2)
                    for p in (0, 1, local[d] - 2, local[d] - 1)]
            shp = self.it.stacked_shape(local)
            for dtype in (torch.float16, torch.float32, torch.float64,
                          torch.int64):
                # At offset 1 of its storage: rows not 16-byte aligned.
                for off in (0, 1):
                    F = uniform((int(np.prod(shp)) + off,), -100, 100,
                                torch.float64, self.dev, 12).to(dtype)
                    F = F[off:].view(shp)
                    got = pk.pack_planes(F, reqs, g.dims)
                    for (d, p), a, b in zip(
                            reqs, got, pk.pack_planes_plain(F, reqs, g.dims)):
                        self.note("pack_planes", check(
                            f"pack_planes {case} {local} {dtype} offset "
                            f"{off} {(d, p)}", a, b, 0.0))

    def kernel_checks_headline(self):
        """One step of each kernel at the headline shape (256^3 f32,
        periodic, one block): checked, then timed beside its plain version
        and its bound."""
        dp, dm, hw = self.dp, self.dm, self.hw
        n = self.n_head
        g = self.grid((n, n, n), **SINGLE, **PERIODIC)
        sc = dp.scal(*self.t3.Params().spacing())
        T = uniform((n, n, n), 0, 100, torch.float32, self.dev, 5)
        A = uniform((n, n, n), 0.001, 0.02, torch.float32, self.dev, 6)
        modes = dp.step_modes(g)
        ref = dp.step_plain(T, A, modes, {}, g.dims, sc)
        out = dp.step_kernel(T, A, modes, {}, g.dims, sc)
        self.note("diffusion_step", check("diffusion_step 256^3", out, ref, 0.0))
        dst = torch.empty_like(T)
        dm.mega_step_kernel(T, A, dst, modes, sc)
        self.note("diffusion_mega_step",
                  check("diffusion_mega_step 256^3", dst, ref, 0.0))
        del out, ref

        cells = float(n) ** 3
        interior = float(n - 2) ** 3
        step_bound = bound_ms(3 * cells * 4, STENCIL_FLOPS * interior, F32_FLOPS)
        k = self.time_iters
        self.perf["diffusion_step"] = dict(
            kernel_time(lambda: dp.step_kernel(T, A, modes, {}, g.dims, sc), k,
                        "step_kernel"),
            plain_ms=event_ms(lambda: dp.step_plain(T, A, modes, {}, g.dims, sc),
                              max(k // 5, 2)),
            bound=step_bound)
        self.perf["diffusion_mega_step"] = dict(
            kernel_time(lambda: dm.mega_step_kernel(T, A, dst, modes, sc), k,
                        "step_kernel"),
            plain_ms=event_ms(lambda: dm.mega_step_plain(T, A, dst, modes, sc),
                              max(k // 5, 2)),
            bound=step_bound)
        # What the card streams in practice: one elementwise pass over the
        # same three arrays (read T and A, write one).
        self.perf["stream_3x256^3_add_ms"] = event_ms(
            lambda: torch.add(T, A, out=dst), k)

        self.halo_write_full(T, g, 10 * k)
        for name in ("diffusion_step", "diffusion_mega_step", "halo_write"):
            p = self.perf[name]
            log(f"[phase 1] {name} at {n}^3 f32: {p['ms']:.4f} ms device "
                f"({p['ms_from']}), {p['events_ms']:.4f} ms per launch back to "
                f"back (events), plain {p['plain_ms']:.4f} ms, bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]})")
        log(f"[phase 1] torch.add over three {n}^3 f32 arrays: "
            f"{self.perf['stream_3x256^3_add_ms']:.4f} ms")
        # The K-step kernel at the open headline's shape too.
        m = self.n_open
        g = self.grid((m, m, m), **SINGLE)
        T = uniform((m, m, m), 0, 100, torch.float32, self.dev, 7)
        A = uniform((m, m, m), 0.001, 0.02, torch.float32, self.dev, 8)
        dst = torch.empty_like(T)
        modes = ("frozen",) * 3
        dm.mega_step_kernel(T, A, dst, modes, sc)
        ref = dm.mega_step_plain(T, A, torch.empty_like(T), modes, sc)
        self.note("diffusion_mega_step",
                  check("diffusion_mega_step 512^3 open", dst, ref, 0.0))
        del ref
        ms = event_ms(lambda: dm.mega_step_kernel(T, A, dst, modes, sc), k)
        b = bound_ms(3 * float(m) ** 3 * 4, STENCIL_FLOPS * float(m - 2) ** 3,
                     F32_FLOPS)
        self.perf["diffusion_mega_step_512_open"] = dict(ms=ms, bound=b)
        log(f"[phase 1] diffusion_mega_step at {m}^3 f32 open: {ms:.4f} "
            f"ms/launch, bound {b[0]:.4f} ms ({b[1]})")

    def halo_write_full(self, T, g, n):
        """The halo writer at the main path's two shapes, f32 and f64: one
        256^3 periodic block (every dim WRAP, phases 1 and 5; `T` on the
        grid `g`) and 2x2x2 blocks of 256^3 (every dim EXT, phase 7's
        writes), each checked, then timed (device time a launch and the
        event time a launch back to back) beside its first design in the
        same run, its plain version and two bounds: the halo cells read
        once and written once, and the 32-byte sectors its cells and
        sources lie in (halo_sector_bytes)."""
        hw = self.hw
        m = self.n_multi
        for key, shape in (("", "256^3 periodic"),
                           ("_2x2x2", f"2x2x2 x {m}^3 EXT")):
            if key:
                g = self.grid((m, m, m), dimx=2, dimy=2, dimz=2)
                T = uniform(self.it.stacked_shape(g.nxyz), -1, 1,
                            torch.float32, self.dev, 41)
            for dtype in (torch.float32, torch.float64):
                F = T.to(dtype, copy=True)
                if key:
                    specs = []
                    for d in range(3):
                        plane = list(F.shape)
                        plane[d] = g.dims[d]
                        specs.append((d, "ext") + tuple(
                            uniform(plane, -1, 1, dtype, self.dev, 43 + side)
                            for side in (0, 1)))
                else:
                    specs = [(d, "wrap", 2) for d in range(3)]
                ref = hw.halo_write_plain(F.clone(), specs, g.dims)
                hw.halo_write(F, specs, g.dims)
                self.note("halo_write", check(
                    f"halo_write {shape} {dtype}", F, ref, 0.0))
                size = F.element_size()
                cells = float(F.numel())
                interior = float(np.prod([s - 2 * n_ for s, n_ in zip(
                    F.shape, g.dims)]))
                run = lambda: hw.halo_write(F, specs, g.dims)
                name = f"halo_write{key}{'_f64' if size == 8 else ''}"
                self.perf[name] = dict(
                    kernel_time(run, n, "halo_write_kernel"),
                    plain_ms=event_ms(lambda: hw.halo_write_plain(
                        F, specs, g.dims), 20),
                    # The halo cells, each read once and written once.
                    bound=bound_ms(2 * (cells - interior) * size, 0,
                                   F32_FLOPS),
                    sector_bound=bound_ms(halo_sector_bytes(
                        F.shape, g.dims, specs, size), 0, F32_FLOPS))
                q = self.first_design_time(hw, "halo_write", run, n,
                                           "halo_write_kernel", 1, [ref],
                                           lambda b, f: b)
                self.perf[f"{name}_first_design"] = q
                p = self.perf[name]
                log(f"[phase 1] halo_write at {shape} "
                    f"{'f64' if size == 8 else 'f32'}: {p['ms']:.4f} ms device "
                    f"({p['ms_from']}), {p['events_ms']:.4f} ms per launch "
                    f"back to back (events); its first design {q['ms']:.4f} "
                    f"ms device, {q['events_ms']:.4f} ms events in the same "
                    f"run ({q['ms'] / p['ms']:.2f} times); plain "
                    f"{p['plain_ms']:.4f} ms; bounds: the halo cells "
                    f"{p['bound'][0]:.5f} ms, their 32-byte sectors "
                    f"{p['sector_bound'][0]:.5f} ms (bytes)")
                del ref, F

    def kernel_checks_multiblock(self):
        """The packer and the chunk step at the 510^3 headline's shape (2x2x2
        blocks of n_multi^3 f32, open): checked, then timed beside their
        plain versions and their bounds."""
        ce, dtz, pk, dp = self.ce, self.dtz, self.pk, self.dp
        n, k = self.n_multi, self.time_iters
        g = self.grid((n, n, n), dimx=2, dimy=2, dimz=2)
        sc = dp.scal(*self.t3.Params().spacing())
        # The packer: the 8 y/z planes update_halo extracts on this grid, in
        # f32 (the main path's) and f64.
        reqs = [(d, p) for d in (1, 2) for p in (1, n - 2, 0, n - 1)]
        for dtype, key in ((torch.float32, "pack_planes"),
                           (torch.float64, "pack_planes_f64")):
            T = uniform(self.it.stacked_shape(g.nxyz), 0, 100, dtype,
                        self.dev, 13)
            got = pk.pack_planes(T, reqs, g.dims)
            for (d, p), a, b in zip(reqs, got,
                                    pk.pack_planes_plain(T, reqs, g.dims)):
                self.note("pack_planes", check(
                    f"pack_planes {n}^3 2x2x2 {dtype} {(d, p)}", a, b, 0.0))
            cells = sum(o.numel() for o in got)
            del got
            idx = [(d, torch.arange(g.dims[d], device=self.dev) * n + p)
                   for d, p in reqs]
            esize = T.element_size()
            self.perf[key] = dict(
                kernel_time(lambda: pk.pack_planes(T, reqs, g.dims), 10 * k,
                            "pack_kernel"),
                plain_ms=event_ms(lambda: pk.pack_planes_plain(T, reqs,
                                                               g.dims), k),
                # The index_select calls alone (they are the plain version
                # too).
                library_ms=event_ms(
                    lambda: [T.index_select(d, i) for d, i in idx], k),
                # Each plane cell read once and written once.
                bound=bound_ms(2 * cells * esize, 0, F32_FLOPS),
                # The same with the z planes' cells read as the 32-byte
                # sectors that hold them, each sector once.
                sector_bound_ms=pack_sector_bytes(T.shape, g.dims, reqs,
                                                  esize)
                / HBM_BYTES_PER_S * 1e3)
            del T
        # The chunk: one K-step chunk of the extended 2x2x2 buffer.
        T, Text, A_ext, modes = self.chunk_input(g, torch.float32, 14)
        del T
        run = lambda: dtz.chunk_call(Text, A_ext, g.nxyz, K=K_CHUNK,
                                     modes=modes, grid=g, sc=sc)
        ref = ce.central_window(dtz.window_steps_plain(
            Text, A_ext, K=K_CHUNK, modes=modes, grid=g, sc=sc), g.nxyz,
            K_CHUNK, modes)
        self.note("diffusion_chunk_step", check(
            f"diffusion_chunk_step {n}^3 2x2x2 open", run(), ref, 0.0))
        del ref
        self.perf["diffusion_chunk_step"] = dict(
            kernel_time(run, max(k // 5, 4), "chunk_kernel"),
            plain_ms=event_ms(lambda: ce.window_step_plain(
                [Text], [Text], E=K_CHUNK, modes=modes, grid=g,
                core=dtz.window_core(A_ext, g, sc),
                flags=ce.edge_flags(modes, g), freeze_fields=(0,)), 3),
            bound=self.chunk_bound(g, Text.shape, K_CHUNK, modes))
        # kernel_time's event time is per chunk call: per launch here.
        self.perf["diffusion_chunk_step"]["events_ms"] /= K_CHUNK
        # The same stencil on the same extended buffer without the chunk's
        # freeze and window mapping: the fused step kernel, frozen modes.
        buf = torch.empty_like(Text)
        self.perf["step_kernel_on_chunk_buffer_ms"] = event_ms(
            lambda: dp.launch_step(Text, A_ext, ("frozen",) * 3, {}, g.dims,
                                   sc, out=buf), k)
        del buf
        for name in ("pack_planes", "pack_planes_f64", "diffusion_chunk_step"):
            p = self.perf[name]
            dt = "f64" if name.endswith("f64") else "f32"
            log(f"[phase 1] {name} at 2x2x2 x {n}^3 {dt} open: {p['ms']:.4f} ms "
                f"device per launch ({p['ms_from']}), {p['events_ms']:.4f} ms "
                f"per launch back to back (events), plain {p['plain_ms']:.4f} "
                f"ms, bound {p['bound'][0]:.4f} ms ({p['bound'][1]})"
                + (f", index_select calls {p['library_ms']:.4f} ms, bound with "
                   f"32-byte z sectors {p['sector_bound_ms']:.4f} ms"
                   if name.startswith("pack_planes") else
                   f", the step kernel on the same buffer (frozen modes) "
                   f"{self.perf['step_kernel_on_chunk_buffer_ms']:.4f} ms"))

    def hm3d_kernel_checks_headline(self):
        """One HM3D step and one K-step loop launch at 256^3 f32, periodic,
        one block: checked, then timed beside the plain version and the
        bound."""
        hp, hm = self.hp, self.hm
        n, k = self.n_head, self.time_iters
        g = self.grid((n, n, n), **SINGLE, **PERIODIC)
        kw = self.h3.Params().step_kwargs()
        Pe, phi = self.hm3d_input((n, n, n), torch.float32, 23)
        modes, none = self.dp.step_modes(g), ({}, {})
        ref = hp.step_plain(Pe, phi, modes, none, g.dims, kw)
        out = hp.step_kernel(Pe, phi, modes, none, g.dims, kw)
        dst = (torch.empty_like(Pe), torch.empty_like(phi))
        hm.mega_step_kernel(Pe, phi, dst, modes, kw)
        for f, name in enumerate(("Pe", "phi")):
            self.note("hm3d_step", check(f"hm3d_step {name} {n}^3", out[f],
                                         ref[f], 0.0))
            self.note("hm3d_mega_step", check(f"hm3d_mega_step {name} {n}^3",
                                              dst[f], ref[f], 0.0))
        del out
        cells, interior = float(n) ** 3, float(n - 2) ** 3
        # Read Pe and phi, write both, 4 bytes each.
        bound = bound_ms(4 * cells * 4, HM3D_FLOPS * interior, F32_FLOPS)
        run = lambda: hp.step_kernel(Pe, phi, modes, none, g.dims, kw)
        self.perf["hm3d_step"] = dict(
            kernel_time(run, k, HM3D_STEP_KERNEL),
            plain_ms=event_ms(lambda: hp.step_plain(Pe, phi, modes, none,
                                                    g.dims, kw),
                              max(k // 5, 2)),
            bound=bound)
        self.perf["hm3d_step_first_design"] = self.first_design_time(
            hp, "hm3d_step", run, k, "Hm3d", None, ref, lambda b, f: b)
        del ref
        self.perf["hm3d_mega_step"] = dict(
            kernel_time(lambda: hm.mega_step_kernel(Pe, phi, dst, modes, kw),
                        k, HM3D_STEP_KERNEL),
            plain_ms=event_ms(lambda: hm.mega_step_plain(Pe, phi, dst, modes,
                                                         kw),
                              max(k // 5, 2)),
            bound=bound)
        # What the card streams in practice: one elementwise pass reading
        # two arrays and writing one, twice (the step's four arrays).
        self.perf["stream_4x256^3_2add_ms"] = event_ms(
            lambda: (torch.add(Pe, phi, out=dst[0]),
                     torch.add(phi, Pe, out=dst[1])), k)
        for name in ("hm3d_step", "hm3d_mega_step"):
            p = self.perf[name]
            log(f"[phase 1] {name} at {n}^3 f32: {p['ms']:.4f} ms device "
                f"({p['ms_from']}), {p['events_ms']:.4f} ms per launch back to "
                f"back (events), plain {p['plain_ms']:.4f} ms, bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]})")
        log(f"[phase 1] two torch.add over {n}^3 f32 arrays (read 4, write "
            f"2): {self.perf['stream_4x256^3_2add_ms']:.4f} ms")
        q = self.perf["hm3d_step_first_design"]
        log(f"[phase 1] hm3d_step's first design (step_walk.cuh) at {n}^3 "
            f"f32: {q['ms']:.4f} ms in the same run, "
            f"{q['ms'] / self.perf['hm3d_step']['ms']:.2f} times the "
            f"march's")
        self.hm3d_step_shapes()

    def hm3d_step_shapes(self):
        """The HM3D step kernel at the main path's other shapes: one
        periodic n_head^3 block in f64 (phase 8's layout) and 2x2x2
        periodic blocks of n_multi^3 (every dim received, phase 9's) in f32
        and f64, each checked, then timed beside its plain version, its
        bound and its first design (step_walk.cuh) in the same run."""
        hp, k = self.hp, self.time_iters
        kw = self.h3.Params().step_kwargs()
        for key, dtype, blocks in (
                ("hm3d_step_f64", torch.float64, 1),
                ("hm3d_step_2x2x2", torch.float32, 2),
                ("hm3d_step_2x2x2_f64", torch.float64, 2)):
            f64 = dtype == torch.float64
            n = self.n_head if blocks == 1 else self.n_multi
            layout = SINGLE if blocks == 1 else dict(dimx=2, dimy=2, dimz=2)
            g = self.grid((n, n, n), **layout, **PERIODIC)
            tag = (f"{'2x2x2 x ' if blocks == 2 else ''}{n}^3 "
                   f"{'f64' if f64 else 'f32'} periodic")
            Pe, phi = self.hm3d_input(self.it.stacked_shape(g.nxyz), dtype,
                                      27)
            modes = self.dp.step_modes(g)
            recv = hp.step_recv_planes(Pe, phi, g, modes, kw)
            ref = hp.step_plain(Pe, phi, modes, recv, g.dims, kw)
            run = lambda: hp.step_kernel(Pe, phi, modes, recv, g.dims, kw)
            for f, name in enumerate(("Pe", "phi")):
                self.note("hm3d_step", check(f"hm3d_step {name} {tag}",
                                             run()[f], ref[f], 0.0))
            size, rate = (8, F64_FLOPS) if f64 else (4, F32_FLOPS)
            cells = float(Pe.numel())
            interior = blocks ** 3 * float(n - 2) ** 3
            self.perf[key] = dict(
                kernel_time(run, k, HM3D_STEP_KERNEL),
                plain_ms=event_ms(lambda: hp.step_plain(Pe, phi, modes, recv,
                                                        g.dims, kw), 3),
                bound=bound_ms(size * cells * 4, HM3D_FLOPS * interior,
                               rate), shape=tag)
            self.perf[f"{key}_first_design"] = self.first_design_time(
                hp, "hm3d_step", run, k, "Hm3d", None, ref, lambda b, f: b)
            del Pe, phi, recv, ref
            p, q = self.perf[key], self.perf[f"{key}_first_design"]
            log(f"[phase 1] hm3d_step at {tag}: {p['ms']:.4f} ms device "
                f"({p['ms_from']}), plain {p['plain_ms']:.4f} ms, bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]}); its first design "
                f"(step_walk.cuh) {q['ms']:.4f} ms in the same run, "
                f"{q['ms'] / p['ms']:.2f} times the march's")

    def hm3d_kernel_checks_multiblock(self):
        """The HM3D chunk step on the 508^3 grid (2x2x2 blocks of n_multi^3,
        periodic), f32 and f64: one chunk checked, then timed beside one
        window step of the plain version, two bounds of compulsory bytes (a
        launch's, about a pass: read Pe and phi, write both, the last
        launch only the central windows; and the whole chunk's over K:
        each extended field read once, each central block written once)
        and its first design (chunk_walk.cuh) in the same run."""
        ce, htz = self.ce, self.htz
        n, k = self.n_multi, self.time_iters
        g = self.grid((n, n, n), dimx=2, dimy=2, dimz=2, **PERIODIC)
        kw = self.h3.Params().step_kwargs()
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            key = "hm3d_chunk_step_f64" if f64 else "hm3d_chunk_step"
            tag = f"2x2x2 x {n}^3 {'f64' if f64 else 'f32'} periodic"
            Pe, phi = self.hm3d_input(self.it.stacked_shape(g.nxyz), dtype,
                                      25)
            exts, modes, out, ref = self.hm3d_chunk(g, Pe, phi, kw)
            del Pe, phi
            for f, name in enumerate(("Pe", "phi")):
                self.note("hm3d_chunk_step", check(
                    f"hm3d_chunk_step {name} {tag}", out[f], ref[f], 0.0))
            del out
            run = lambda: htz.chunk_call(exts, g.nxyz, K=K_CHUNK,
                                         modes=modes, grid=g, kw=kw)
            size, rate = (8, F64_FLOPS) if f64 else (4, F32_FLOPS)
            interior = 8 * float(n - 2) ** 3
            self.perf[key] = dict(
                kernel_time(run, max(k // 5, 4), "hm_march_kernel",
                            launches=K_CHUNK),
                plain_ms=event_ms(lambda: ce.window_step_plain(
                    exts, exts, E=K_CHUNK, modes=modes, grid=g,
                    core=htz.window_core(exts[0].shape, g, kw),
                    flags=ce.edge_flags(modes, g), freeze_fields=(0, 1)), 3),
                bound=self.chunk_bound(g, exts[0].shape, K_CHUNK, modes,
                                       arrays=4, frozen_fields=2,
                                       flops=HM3D_FLOPS, size=size,
                                       flop_rate=rate),
                chunk_over_k=bound_ms(
                    size * 2 * (float(exts[0].numel()) + 8 * float(n) ** 3)
                    / K_CHUNK, HM3D_FLOPS * interior, rate))
            self.perf[key]["events_ms"] /= K_CHUNK
            self.perf[f"{key}_first_design"] = self.first_design_time(
                htz, "hm3d_chunk", run, max(k // 5, 4), "chunk_kernel",
                K_CHUNK, ref, lambda b, f: b)
            del ref
            p, q = self.perf[key], self.perf[f"{key}_first_design"]
            log(f"[phase 1] hm3d_chunk_step at {tag}: {p['ms']:.4f} ms "
                f"device per launch ({p['ms_from']}), {p['events_ms']:.4f} "
                f"ms per launch back to back (events), plain "
                f"{p['plain_ms']:.4f} ms (one window step), bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]}), the whole chunk "
                f"over K {p['chunk_over_k'][0]:.4f} ms; its first design "
                f"(chunk_walk.cuh) {q['ms']:.4f} ms in the same run, "
                f"{q['ms'] / p['ms']:.2f} times the march's")
            del exts

    def wave_state(self, g, dtype, seed):
        """Random (P, Vx, Vy) on the 2-D grid `g`."""
        return [uniform(self.it.stacked_shape(s), -1, 1, dtype, self.dev,
                        seed + f)
                for f, s in enumerate(self.wp.field_shapes(g.nxyz[:2]))]

    def wave_chunk(self, g, state, K, kw):
        """The extended buffers of a depth-K chunk of the wave2d fields
        `state`, the kernel's result and the plain version's."""
        ce, wp, wtz = self.ce, self.wp, self.wtz
        modes = ce.dim_modes(g)[:2]
        shapes = wp.field_shapes(g.nxyz[:2])
        ols = ce.field_ols(g, shapes)
        exts = ce.extend_fields(list(state), ols, 2 * K, g, modes)
        out = wtz.chunk_call(exts, shapes, K=K, modes=modes, grid=g, kw=kw,
                             ols=ols)
        ref = [ce.central_window(U, s, 2 * K, modes) for U, s in zip(
            wtz.window_steps_plain(exts, K=K, modes=modes, grid=g, kw=kw,
                                   ols=ols), shapes)]
        return exts, modes, shapes, ols, out, ref

    def wave2d_kernel_checks(self):
        """The wave2d step on every layout, periodic and open, and its chunk
        step on the periodic ones at every admitted depth, f32 and f64,
        against their plain versions at small shapes."""
        wp, wtz = self.wp, self.wtz
        kw = dict(dx=0.31, dy=0.27, dt=0.05, rho=1.3, bulk=0.7)
        for case, gkw in WAVE_GRIDS.items():
            for local, Ks in WAVE_SHAPES:
                g = self.grid(local + (1,), dimz=1, **gkw)
                for dtype in (torch.float32, torch.float64):
                    S = self.wave_state(g, dtype, 41)
                    tag = f"{case} {local} {dtype}"
                    if case != "2x2_periodic":
                        out = wp.step_kernel(*S, g.dims[:2], kw)
                        ref = wp.step_plain(*S, g.dims[:2], kw)
                        for name, a, b in zip(("P", "Vx", "Vy"), out, ref):
                            self.note("wave2d_step", check(
                                f"wave2d_step {name} {tag}", a, b, 0.0))
                    if not case.endswith("periodic"):
                        continue
                    for K in Ks:
                        why = wtz.wave2d_chunk_refusal(g, local, K, K, dtype)
                        if why is not None:
                            raise SmokeFailure(f"wave2d chunk {tag} K={K}: "
                                               f"refused: {why}")
                        *_, out, ref = self.wave_chunk(g, S, K, kw)
                        for name, a, b in zip(("P", "Vx", "Vy"), out, ref):
                            self.note("wave2d_chunk_step", check(
                                f"wave2d_chunk_step {name} {tag} K={K}", a, b,
                                0.0))
        log(f"[phase 1] wave2d small-shape kernel checks passed: max abs err "
            f"step {self.err['wave2d_step']:.1e}, chunk "
            f"{self.err['wave2d_chunk_step']:.1e} (tolerance 0)")

    def wave2d_kernel_checks_full(self):
        """Both wave2d kernels at full width, f32 periodic: one step and one
        K=8 chunk on one n_wave^2 block and on wave_blocks x 1 of them,
        checked, then timed beside their plain versions and bounds."""
        ce, wp, wtz = self.ce, self.wp, self.wtz
        n, k, K = self.n_wave, self.time_iters, K_CHUNK
        for nb in (1, self.wave_blocks):
            g = self.grid((n, n, 1), dimx=nb, dimy=1, dimz=1, periodx=1,
                          periody=1)
            kw = self.w2.Params().step_kwargs()
            tag = f"{nb}x1 x {n}^2 f32 periodic"
            S = self.wave_state(g, torch.float32, 43)
            blocks = g.dims[:2]
            out = wp.step_kernel(*S, blocks, kw)
            for name, a, b in zip(("P", "Vx", "Vy"), out,
                                  wp.step_plain(*S, blocks, kw)):
                self.note("wave2d_step", check(f"wave2d_step {name} {tag}",
                                               a, b, 0.0))
            del out
            cells = float(sum(A.numel() for A in S))
            step = dict(
                kernel_time(lambda: wp.step_kernel(*S, blocks, kw), k,
                            "Wave2d"),
                plain_ms=event_ms(lambda: wp.step_plain(*S, blocks, kw), 3),
                # Read P, Vx, Vy once, write them once.
                bound=bound_ms(2 * cells * 4, WAVE2D_FLOPS * cells / 3,
                               F32_FLOPS))
            exts, modes, shapes, ols, out, ref = self.wave_chunk(g, S, K, kw)
            for name, a, b in zip(("P", "Vx", "Vy"), out, ref):
                self.note("wave2d_chunk_step", check(
                    f"wave2d_chunk_step {name} {tag} K={K}", a, b, 0.0))
            del out, ref, S
            ext_cells = float(sum(X.numel() for X in exts))
            # Per launch of a K-launch chunk: K-1 launches read and write
            # the extended buffers, the last reads them and writes the
            # central windows.
            nbytes = 4 * ((2 * K - 1) * ext_cells + cells) / K
            chunk = dict(
                kernel_time(lambda: wtz.chunk_call(
                    exts, shapes, K=K, modes=modes, grid=g, kw=kw, ols=ols),
                    max(k // 5, 4), "Wave2d"),
                plain_ms=event_ms(lambda: ce.window_step_plain(
                    exts, exts, E=2 * K, modes=modes, grid=g,
                    core=wtz.window_core(g, kw), flags=ce.edge_flags(modes, g),
                    freeze_fields=(), ols=ols), 3),
                bound=bound_ms(nbytes, WAVE2D_FLOPS * ext_cells / 3,
                               F32_FLOPS))
            chunk["events_ms"] /= K
            del exts
            # The summary's rows: the step at one block, the chunk on the
            # wave_blocks x 1 grid.
            if nb == 1:
                self.perf["wave2d_step"] = step
            else:
                self.perf["wave2d_chunk_step"] = chunk
            self.perf[f"wave2d_step_{nb}x1"] = step
            self.perf[f"wave2d_chunk_step_{nb}x1"] = chunk
            for name, p in (("wave2d_step", step),
                            ("wave2d_chunk_step K=8", chunk)):
                log(f"[phase 1] {name} at {tag}: {p['ms']:.4f} ms device per "
                    f"launch ({p['ms_from']}), {p['events_ms']:.4f} ms per "
                    f"launch back to back (events), plain {p['plain_ms']:.4f} "
                    f"ms{' (one window step)' if 'chunk' in name else ''}, "
                    f"bound {p['bound'][0]:.4f} ms ({p['bound'][1]})")

    @staticmethod
    def chunk_bound(g, ext_shape, K, modes, arrays=3, frozen_fields=1,
                    flops=STENCIL_FLOPS, size=4, flop_rate=F32_FLOPS):
        """Least time per launch of one chunk (K launches) of a kernel that
        reads and writes `arrays` arrays per cell (diffusion: T and A read,
        T written; HM3D: Pe and phi read and written): each launch but the
        last moves them over the extended buffers, the last over the
        central windows; every launch reads the chunk-entry values of the
        frozen cells of `frozen_fields` fields."""
        n = g.dims
        ext_local = [ext_shape[d] // n[d] for d in range(3)]
        ext_cells = float(np.prod(ext_shape))
        out_cells = float(np.prod([n[d] * g.nxyz[d] for d in range(3)]))
        kept = 1.0
        for d in range(3):   # rows along d outside every freeze
            rows = {"oext": 2 * (K + 1), "frozen": 2}.get(modes[d], 0)
            kept *= ext_shape[d] - rows
        frozen = ext_cells - kept
        interior = lambda local: float(np.prod(n)) * float(
            np.prod([s - 2 for s in local]))
        nbytes = size * ((K - 1) * arrays * ext_cells + arrays * out_cells
                         + K * frozen_fields * frozen)
        ops = flops * ((K - 1) * interior(ext_local) + interior(g.nxyz))
        return bound_ms(nbytes / K, ops / K, flop_rate)

    def band_fields(self, g, dtype, K, seed):
        """Random diffusion and HM3D fields on grid `g`, extended for a
        depth-K chunk: (Text, A_ext), (Pee, phie) and the window modes."""
        ce = self.ce
        shp = self.it.stacked_shape(g.nxyz)
        modes = ce.dim_modes(g)
        ols = ce.field_ols(g, [g.nxyz]) * 2
        T = uniform(shp, -10, 10, dtype, self.dev, seed)
        A = uniform(shp, 0.001, 0.1, dtype, self.dev, seed + 1)
        diff = ce.extend_fields([T, A], ols, K, g, modes)
        del T, A
        hm = ce.extend_fields(list(self.hm3d_input(shp, dtype, seed + 2)),
                              ols, K, g, modes)
        return diff, hm, modes, ols

    def band_plain(self, g, exts, K, B, modes, ols, family, sc, kw, iters=None):
        """The band kernels' plain version on the extended buffers `exts`:
        `iters` (K when None) banded iterations, whole evolved buffers."""
        from functools import partial

        ce, dtz, htz = self.ce, self.dtz, self.htz
        core = (partial(dtz.banded_update, **sc) if family == "diffusion"
                else partial(htz.band_update, kw=kw))
        n_up = 1 if family == "diffusion" else 2
        return ce.banded_window_plain(
            list(exts), K=K if iters is None else iters, B=B, lo=1,
            modes=modes, grid=g, ols=ols, shapes=[g.nxyz] * 2, E=K,
            band_update=core, extras=(1, 1), n_up=n_up,
            freeze_fields=tuple(range(n_up)))[:n_up]

    def band_check(self, g, exts, K, B, modes, ols, family, tag, sc, kw):
        """One band kernel against its plain version: the whole evolved
        buffers and the central windows, tolerance 0."""
        ce, dtz, htz = self.ce, self.dtz, self.htz
        name = f"{family}_band_step"
        want = self.band_plain(g, exts, K, B, modes, ols, family, sc, kw)
        for central in (False, True):
            if family == "diffusion":
                got = [dtz.band_call(exts[0], exts[1], g.nxyz, K=K, B=B,
                                     modes=modes, grid=g, sc=sc,
                                     central=central)]
            else:
                got = htz.band_call(exts, g.nxyz, K=K, B=B, modes=modes,
                                    grid=g, kw=kw, central=central)
            for f, (a, b) in enumerate(zip(got, want)):
                if central:
                    b = ce.central_window(b, g.nxyz, K, modes)
                self.note(name, check(
                    f"{name} {tag} field {f} "
                    f"{'central' if central else 'whole buffer'}", a, b, 0.0))

    def band_kernel_checks(self):
        """Both band kernels in every window mode (the chunk grids and one
        periodic block), f32 and f64, B = 8 and 16 with two and three bands
        (the block's x extent set so that its extended span is 2B or 3B),
        tolerance 0."""
        sc = self.dp.scal(0.3, 0.4, 0.5)
        K = 4
        grids = dict(CHUNK_GRIDS, one_block_periodic=((1, 1, 1), (1, 1, 1)))
        for case, (dims, per) in grids.items():
            for B, bands in ((8, 2), (8, 3), (16, 2), (16, 3)):
                ext = dims[0] > 1 or per[0]
                local = (B * bands - (2 * K if ext else 0), 12, 13)
                g = self.grid(local, dimx=dims[0], dimy=dims[1],
                              dimz=dims[2], periodx=per[0], periody=per[1],
                              periodz=per[2])
                kw = self.h3.Params().step_kwargs()
                for dtype in (torch.float32, torch.float64):
                    why = self.dtz.banded_refusal(g, local, K, K, dtype, B=B)
                    if why is not None:
                        raise SmokeFailure(f"band {case} {local}: {why}")
                    diff, hm, modes, ols = self.band_fields(g, dtype, K, 41)
                    tag = f"{case} {local} B={B} {dtype}"
                    self.band_check(g, diff, K, B, modes, ols, "diffusion",
                                    tag, sc, kw)
                    self.band_check(g, hm, K, B, modes, ols, "hm3d", tag, sc,
                                    kw)
        log(f"[phase 1] band kernels in every window mode: max abs err "
            f"{self.err['diffusion_band_step']:.3e} (diffusion), "
            f"{self.err['hm3d_band_step']:.3e} (HM3D) (tolerance 0)")

    def first_design_time(self, module, lib, run, n, kernel, K, want, cut):
        """The time of `run()` on the first design of library `lib` (built
        from kernel_variants.py's FIRST_DESIGNS text beside the sources),
        its result held against `want` (cut by `cut`) first; the wrapper
        module's library is restored after.  K: the launches of `kernel`
        a call makes, counted in the trace (kernel_time); None for the
        step kernels, whose first designs' names (`Hm3d`, `Stokes`) no
        other kernel of the call shares: the mean over the launches the
        trace holds."""
        real = module.library
        module.library = (lambda name: self.first[lib] if name == lib
                          else real(name))
        try:
            got = run()
            got = [got] if torch.is_tensor(got) else got
            for f, (a, b) in enumerate(zip(got, want)):
                check(f"{lib} first design field {f}", a, cut(b, f), 0.0)
            del got
            return kernel_time(run, n, kernel, launches=K)
        finally:
            module.library = real

    def band_kernel_checks_full(self):
        """Both band kernels at 2x2x2 blocks of n_multi^3 f32 (diffusion
        open, HM3D periodic), K = 8, B = 8: checked against the plain
        version, then timed beside one plain iteration and two bounds of
        compulsory bytes: a pass (read src and the constant, write dst) and
        the whole chunk (read each extended field once, write each central
        block once; the table's bound is the chunk's divided by K).  Both
        are also checked and timed in f64, beside their first designs
        (band_walk.cuh) in the same run: the diffusion one in f32 and f64,
        the HM3D one in f32."""
        n, k, K, B = self.n_multi, self.time_iters, K_CHUNK, 8
        for family, per, flops, dtype in (
                ("diffusion", {}, STENCIL_FLOPS, torch.float32),
                ("diffusion", {}, STENCIL_FLOPS, torch.float64),
                ("hm3d", PERIODIC, HM3D_FLOPS, torch.float32),
                ("hm3d", PERIODIC, HM3D_FLOPS, torch.float64)):
            f64 = dtype == torch.float64
            name = f"{family}_band_step"
            key = f"{name}_f64" if f64 else name
            kernel = ("dm_march_kernel" if family == "diffusion"
                      else "hm_march_kernel")
            g = self.grid((n, n, n), dimx=2, dimy=2, dimz=2, **per)
            kw = self.h3.Params().step_kwargs()
            sc = self.dp.scal(*self.t3.Params().spacing())
            diff, hm, modes, ols = self.band_fields(g, dtype, K, 51)
            exts = diff if family == "diffusion" else hm
            del diff, hm
            tag = (f"2x2x2 x {n}^3 {'f64' if f64 else 'f32'} "
                   f"{'open' if family == 'diffusion' else 'periodic'}")
            if family == "diffusion":
                run = lambda: self.dtz.band_call(exts[0], exts[1], g.nxyz,
                                                 K=K, B=B, modes=modes,
                                                 grid=g, sc=sc)
            else:
                run = lambda: self.htz.band_call(exts, g.nxyz, K=K, B=B,
                                                 modes=modes, grid=g, kw=kw)
            got = run()
            got = [got] if family == "diffusion" else got
            want = self.band_plain(g, exts, K, B, modes, ols, family, sc, kw)
            cut = (lambda b, f: self.ce.central_window(b, g.nxyz, K, modes))
            for f, (a, b) in enumerate(zip(got, want)):
                self.note(name, check(f"{name} {tag} field {f}", a,
                                      cut(b, f), 0.0))
            del got
            ext_cells = float(exts[0].numel())
            out_cells = float(n) ** 3 * 8
            n_up = 1 if family == "diffusion" else 2
            interior = 8 * float(n - 2) ** 3
            size = 8 if f64 else 4
            rate = F64_FLOPS if f64 else F32_FLOPS
            # A pass: every staged array read once, every field written.
            pass_bytes = size * ext_cells * (len(exts) + n_up)
            # The chunk: each extended array read once, each central block
            # written once, over the K launches.
            chunk_bytes = size * (len(exts) * ext_cells + n_up * out_cells)
            self.perf[key] = dict(
                kernel_time(run, max(k // 10, 3), kernel, launches=K),
                plain_ms=event_ms(lambda: self.band_plain(
                    g, exts, K, B, modes, ols, family, sc, kw, iters=1), 1),
                bound=bound_ms(chunk_bytes / K, flops * interior, rate),
                pass_bound=bound_ms(pass_bytes, flops * interior, rate),
                chunk_bound=bound_ms(chunk_bytes, flops * K * interior,
                                     rate))
            # kernel_time's event time is per chunk call: per launch here.
            self.perf[key]["events_ms"] /= K
            if family == "diffusion" or not f64:
                self.perf[f"{key}_first_design"] = self.first_design_time(
                    self.dtz if family == "diffusion" else self.htz,
                    f"{family}_band", run, max(k // 10, 3), "band_kernel", K,
                    want, cut)
            del want
            p = self.perf[key]
            log(f"[phase 1] {name} at {tag}, K={K}, B={B}: {p['ms']:.4f} ms "
                f"device per launch ({p['ms_from']}), {p['events_ms']:.4f} "
                f"ms per launch back to back (events), plain "
                f"{p['plain_ms']:.4f} ms (one iteration); bounds: a pass "
                f"{p['pass_bound'][0]:.4f} ms, the whole chunk "
                f"{p['chunk_bound'][0]:.4f} ms ({p['bound'][0]:.4f} ms a "
                f"launch, {p['bound'][1]})")
            if f"{key}_first_design" in self.perf:
                q = self.perf[f"{key}_first_design"]
                log(f"[phase 1] {name} at {tag}: its first design "
                    f"(band_walk.cuh) {q['ms']:.4f} ms device per launch in "
                    f"the same run, {q['ms'] / p['ms']:.2f} times the "
                    f"march's")
            del exts

    # -- the staggered band kernels (row 6's Stokes and rank-3 instances) --
    def stokes_band_plain(self, g, exts, Rho_ext, K, B, modes, ols, shapes,
                          kw, iters=None):
        """The Stokes band kernel's plain version: `iters` (K when None)
        banded iterations of the extended buffers, whole evolved
        buffers."""
        from functools import partial

        ce, stz = self.ce, self.stz
        return ce.banded_window_plain(
            list(exts) + [Rho_ext], K=K if iters is None else iters, B=B,
            lo=1, modes=modes, grid=g, ols=ols, shapes=shapes, E=2 * K,
            band_update=partial(stz.band_update, kw=kw), extras=stz.EXTRAS,
            n_up=4, freeze_fields=stz.FREEZE_FIELDS)[:4]

    def spec_band_plain(self, gen, g, exts, K, B, E, modes, ols, shapes,
                        iters=None):
        """The generated band entry's plain version (the band core derived
        from the spec's evaluator), whole evolved buffers."""
        ce, sl = self.ce, self.sl
        lo, extras = sl.band_margins(gen.spec, gen.analysis)
        return ce.banded_window_plain(
            list(exts), K=K if iters is None else iters, B=B, lo=lo,
            modes=modes, grid=g, ols=ols, shapes=shapes, E=E,
            band_update=sl.band_core(gen), extras=extras, n_up=len(exts),
            freeze_fields=gen.analysis.freeze)

    def band_compare(self, name, tag, call, counter, want, shapes, E, modes,
                     K, note=None):
        """`call(central)` against the whole evolved buffers `want` (and
        their central windows), tolerance 0, each call launching K
        times."""
        for central in (False, True):
            before = counter.launches
            got = call(central)
            sync(self.dev)
            if counter.launches != before + K:
                raise SmokeFailure(f"{name} {tag}: {counter.launches - before}"
                                   f" launches, expected {K}")
            for f, (a, b, s) in enumerate(zip(got, want, shapes)):
                if central:
                    b = self.ce.central_window(b, s, E, modes)
                err = check(f"{name} {tag} field {f} "
                            f"{'central' if central else 'whole buffer'}",
                            a, b, 0.0)
                if note:
                    self.note(note, err)

    def stagger_band_checks(self):
        """The staggered band kernels against their plain version in every
        window mode, two and three bands, f32 and f64, on the whole evolved
        buffers (the x-staggered tail rows and the shoulders) and the
        central windows, with each call's launches counted: Stokes on the
        layouts of the small Stokes checks (blocks of 12x12x36, K = 3), the
        generated band entry of the rank-3 specs (relax3d, the staggered
        acoustic3d) on the 3-D spec layouts (blocks of 18x12x36, K = 3);
        tolerance 0."""
        ce, sp, stz, sl = self.ce, self.sp, self.stz, self.sl
        kw = dict(dx=0.31, dy=0.27, dz=0.43, mu=1.3, dtP=0.07, dtV=0.011)
        K, local = 3, (12, 12, 36)
        # y one periodic block over an open x: an x freeze row's value comes
        # from the source's row of a y wrap.
        grids = dict(STOKES_GRIDS, **{"2x1x1_wrap_y_open_xz": dict(
            dimx=2, dimy=1, dimz=1, periody=1)})
        for case, gkw in grids.items():
            g = self.grid(local, **OL3, **gkw)
            modes = ce.dim_modes(g)
            shapes = sp.field_shapes(g.nxyz)
            ols = ce.field_ols(g, shapes)
            for dtype in (torch.float32, torch.float64):
                *S, Rho = self.stokes_state(g, dtype, 57)
                exts = ce.extend_fields(S, ols[:4], 2 * K, g, modes)
                Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g,
                                           modes)[0]
                for bands in (2, 3):
                    B = ce.ext_shape(local, 2 * K, modes)[0] // bands
                    tag = f"{case} {local} B={B} {dtype}"
                    why = stz.stokes_banded_refusal(g, local, K, K, dtype,
                                                    B=B)
                    if why is not None:
                        raise SmokeFailure(f"Stokes band {tag}: {why}")
                    want = self.stokes_band_plain(g, exts, Rho_ext, K, B,
                                                  modes, ols, shapes, kw)
                    self.band_compare(
                        "stokes_band_step", tag,
                        lambda central: stz.band_call(
                            exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                            grid=g, kw=kw, ols=ols, central=central),
                        stz.band_call, want, shapes, 2 * K, modes, K,
                        note="stokes_band_step")
        K, local = 3, (18, 12, 36)
        for name in self.cases.SPECS_3D:
            gen = self.spec_gen(name)
            for case in self.cases.GRIDS_3D:
                g = self.spec_grid(name, case, local)
                shapes = sl.field_shapes(gen.spec, g.nxyz)
                E = gen.analysis.margin_after(K)
                modes = ce.dim_modes(g)
                ols = ce.field_ols(g, shapes)
                for dtype in (torch.float32, torch.float64):
                    exts = ce.extend_fields(
                        self.spec_state(gen, g, dtype, 85), ols, E, g, modes)
                    for bands in (2, 3):
                        B = ce.ext_shape(local, E, modes)[0] // bands
                        tag = f"{name} {case} {local} B={B} {dtype}"
                        why = sl.banded_refusal(gen.spec, gen.analysis, g,
                                                shapes[0], K, K, dtype, B=B)
                        if why is not None:
                            raise SmokeFailure(f"spec band {tag}: {why}")
                        want = self.spec_band_plain(gen, g, exts, K, B, E,
                                                    modes, ols, shapes)
                        self.band_compare(
                            "spec_band_step", tag,
                            lambda central: sl.band_call(
                                gen, exts, shapes, K=K, B=B, E=E,
                                modes=modes, grid=g, ols=ols,
                                central=central),
                            sl.band_call, want, shapes, E, modes, K,
                            note=("spec_band_step[relax3d]"
                                  if name == "relax3d" else None))
        log(f"[phase 1] staggered band kernels in every window mode: max abs "
            f"err {self.err['stokes_band_step']:.3e} (Stokes), "
            f"{self.err['spec_band_step[relax3d]']:.3e} (relax3d; acoustic3d "
            f"checked alike) (tolerance 0)")

    def stagger_band_checks_full(self):
        """Both staggered band kernels at their main paths' shapes, f32,
        K = 8, B = 8: the Stokes band step at 2x2x2 blocks of n_multi^3,
        open (config 5's 509^3: 8 extended blocks of 288^3; also in f64,
        and in f32 its first design), and the generated band entry of
        relax3d and acoustic3d on one n_stokes^3 periodic block (relax3d:
        272 x 256 x 256 extended), f32 and f64, each beside its first design
        (spec_band_full); checked against their plain version, then timed
        beside one plain iteration and two bounds of compulsory bytes: a
        pass (every staged array read once, every field written once) and
        the whole chunk (each extended array read once, each central block
        written once; the table's bound is the chunk's divided by K)."""
        ce, sp, stz, sl = self.ce, self.sp, self.stz, self.sl
        m, k, K, B = self.n_multi, self.time_iters, K_CHUNK, 8
        for dtype in (torch.float32, torch.float64):
            self.stokes_band_full(m, k, K, B, dtype)
        n = self.n_stokes
        for name in ("relax3d", "acoustic3d"):
            for dtype in (torch.float32, torch.float64):
                self.spec_band_full(name, dtype, n, k, K, B)
        for name, tag in (("stokes_band_step", f"2x2x2 x {m}^3 f32 open"),
                          ("stokes_band_step_f64", f"2x2x2 x {m}^3 f64 open"),
                          ("spec_band_step[relax3d]", f"{n}^3 f32 periodic")):
            p = self.perf[name]
            log(f"[phase 1] {name} at {tag}, K={K}, B={B}: {p['ms']:.4f} ms "
                f"device per launch ({p['ms_from']}), {p['events_ms']:.4f} "
                f"ms per launch back to back (events), plain "
                f"{p['plain_ms']:.4f} ms (one iteration); bounds: a pass "
                f"{p['pass_bound'][0]:.4f} ms, the whole chunk "
                f"{p['chunk_bound'][0]:.4f} ms ({p['bound'][0]:.4f} ms a "
                f"launch, {p['bound'][1]})")

    def spec_band_full(self, name, dtype, n, k, K, B):
        """The generated band entry of spec `name` on one n^3 periodic block
        (relax3d: 272 x 256 x 256 extended), K and B, in `dtype`: checked
        against its plain version, then timed beside one plain iteration,
        two bounds (a pass: every field read and written once; the whole
        chunk over K) and its first design in the same run (the band walk,
        kernel_variants.py: spec_band_first_source)."""
        ce, sl = self.ce, self.sl
        f64 = dtype == torch.float64
        key = f"spec_band_step[{name}]{'_f64' if f64 else ''}"
        gen = self.spec_gen(name)
        g = self.spec_grid(name, "1x1x1_periodic", (n, n, n))
        shapes = sl.field_shapes(gen.spec, g.nxyz)
        E = gen.analysis.margin_after(K)
        modes = ce.dim_modes(g)
        ols = ce.field_ols(g, shapes)
        exts = ce.extend_fields(self.spec_state(gen, g, dtype, 99), ols, E,
                                g, modes)
        run = lambda: sl.band_call(gen, exts, shapes, K=K, B=B, E=E,
                                   modes=modes, grid=g, ols=ols)
        want = self.spec_band_plain(gen, g, exts, K, B, E, modes, ols, shapes)
        cut = (lambda b, f: ce.central_window(b, shapes[f], E, modes))
        tag = f"{n}^3 {'f64' if f64 else 'f32'} periodic"
        for f, (a, b) in enumerate(zip(run(), want)):
            err = check(f"{key} {tag} field {f}", a, cut(b, f), 0.0)
            if name == "relax3d":
                self.note("spec_band_step[relax3d]", err)
        size = 8 if f64 else 4
        rate = F64_FLOPS if f64 else F32_FLOPS
        flops = SPEC_FLOPS[name] * float(exts[0].numel())
        ext_cells = float(sum(X.numel() for X in exts))
        out_cells = float(sum(np.prod(s) for s in shapes))
        self.perf[key] = dict(
            kernel_time(run, max(k // 5, 4), "stag_march_kernel",
                        launches=K),
            plain_ms=event_ms(lambda: self.spec_band_plain(
                gen, g, exts, K, B, E, modes, ols, shapes, iters=1), 1),
            bound=bound_ms(size * (ext_cells + out_cells) / K, flops, rate),
            pass_bound=bound_ms(size * 2 * ext_cells, flops, rate),
            chunk_bound=bound_ms(size * (ext_cells + out_cells), flops * K,
                                 rate))
        self.perf[key]["events_ms"] /= K
        real = sl.generated_library
        sl.generated_library = lambda source, t: self.first_gen[name]
        try:
            for f, (a, b) in enumerate(zip(run(), want)):
                check(f"{key} first design {tag} field {f}", a, cut(b, f),
                      0.0)
            q = self.perf[f"{key}_first_design"] = kernel_time(
                run, max(k // 5, 4), "stag_band_kernel", launches=K)
        finally:
            sl.generated_library = real
        q["events_ms"] /= K
        p = self.perf[key]
        log(f"[phase 1] {key} at {tag}, K={K}, B={B}: {p['ms']:.4f} ms "
            f"device per launch ({p['ms_from']}), {p['events_ms']:.4f} ms per "
            f"launch back to back (events); its first design (the band "
            f"walk) {q['ms']:.4f} ms device in the same run, "
            f"{q['ms'] / p['ms']:.2f} times the march's; plain "
            f"{p['plain_ms']:.4f} ms (one iteration); bounds: a pass "
            f"{p['pass_bound'][0]:.4f} ms, the whole chunk over K "
            f"{p['bound'][0]:.4f} ms ({p['bound'][1]})")
        del exts, want

    def stokes_band_full(self, m, k, K, B, dtype):
        """The Stokes band step at 2x2x2 blocks of m^3, open (config 5's
        509^3: 8 extended blocks of 288^3), K and B, in `dtype`: checked
        against its plain version and timed (stagger_band_checks_full); in
        float32 also its first design (stagger_band_walk3.cuh) in the same
        run."""
        ce, sp, stz = self.ce, self.sp, self.stz
        f64 = dtype == torch.float64
        key = "stokes_band_step_f64" if f64 else "stokes_band_step"
        g = self.grid((m, m, m), dimx=2, dimy=2, dimz=2, **OL3)
        kw = self.st3._pseudo_steps(self.st3.Params())
        modes = ce.dim_modes(g)
        shapes = sp.field_shapes(g.nxyz)
        ols = ce.field_ols(g, shapes)
        *S, Rho = self.stokes_state(g, dtype, 59)
        exts = ce.extend_fields(S, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        del S, Rho
        tag = f"2x2x2 x {m}^3 {'f64' if f64 else 'f32'} open"
        run = lambda: stz.band_call(exts, Rho_ext, shapes, K=K, B=B,
                                    modes=modes, grid=g, kw=kw, ols=ols)
        got = run()
        want = self.stokes_band_plain(g, exts, Rho_ext, K, B, modes, ols,
                                      shapes, kw)
        cut = (lambda b, f: ce.central_window(b, shapes[f], 2 * K, modes))
        for f, (name, a, b) in enumerate(zip(STOKES_NAMES, got, want)):
            self.note("stokes_band_step", check(
                f"stokes_band_step {name} {tag}", a, cut(b, f), 0.0))
        del got
        size = 8 if f64 else 4
        rate = F64_FLOPS if f64 else F32_FLOPS
        rd = float(sum(X.numel() for X in exts) + Rho_ext.numel())
        wr = float(sum(X.numel() for X in exts))
        out_cells = float(sum(np.prod([g.dims[d] * s[d] for d in range(3)])
                              for s in shapes[:4]))
        cells = float(Rho_ext.numel())
        self.perf[key] = dict(
            kernel_time(run, max(k // 10, 2),
                        f"stokes_march_kernel<{'double' if f64 else 'float'}, "
                        f"true>", launches=K),
            plain_ms=event_ms(lambda: self.stokes_band_plain(
                g, exts, Rho_ext, K, B, modes, ols, shapes, kw, iters=1), 1),
            bound=bound_ms(size * (rd + out_cells) / K,
                           STOKES_FLOPS * cells, rate),
            pass_bound=bound_ms(size * (rd + wr), STOKES_FLOPS * cells, rate),
            chunk_bound=bound_ms(size * (rd + out_cells),
                                 STOKES_FLOPS * cells * K, rate))
        self.perf[key]["events_ms"] /= K
        if not f64:
            q = self.perf["stokes_band_step_first_design"] = \
                self.first_design_time(stz, "stokes_band", run,
                                       max(k // 10, 2), "stag_band_kernel",
                                       K, want, cut)
            log(f"[phase 1] stokes_band_step at {tag}: its first design "
                f"(stagger_band_walk3.cuh) {q['ms']:.4f} ms device per "
                f"launch in the same run, "
                f"{q['ms'] / self.perf[key]['ms']:.2f} times the march's")
        del want, exts, Rho_ext

    # -- main path --------------------------------------------------------
    def heat(self, T, Cp) -> float:
        return float(np.sum(self.it.gather_interior(Cp.double() * T.double())))

    def headline(self, n, periodic: bool):
        """`run()` at n^3 f32 on one block: physics checks, ms/step."""
        it, t3 = self.it, self.t3
        tag = f"{n}^3 {'periodic' if periodic else 'open'}"
        self.grid((n, n, n), **SINGLE, **(PERIODIC if periodic else {}))
        p = t3.Params()
        T, Cp = t3.init_fields(p)
        T10 = t3.make_multi_step(10, p)(T, Cp)
        T10_plain = t3.make_multi_step(10, p, use_kernels=False)(T, Cp)
        err10 = check(f"{tag}: 10 steps vs plain path", T10, T10_plain, 0.0)
        del T10, T10_plain
        T1, sec = t3.run(self.nt, p, dtype=torch.float32, n_inner=self.n_inner)
        n1 = max(1, self.nt // 4)     # the calls run() makes (warm-up 1)
        steps = (1 + n1 + max(self.nt - n1, n1 + 1)) * self.n_inner
        if not bool(torch.isfinite(T1).all()):
            raise SmokeFailure(f"{tag}: non-finite temperature")
        lo, hi = float(T.min()), float(T.max())
        lo1, hi1 = float(T1.min()), float(T1.max())
        # The explicit scheme is monotone at this time step: no new extrema.
        if lo1 < lo - 1e-3 or hi1 > hi + 1e-3:
            raise SmokeFailure(f"{tag}: range [{lo1}, {hi1}] left [{lo}, {hi}]")
        drift = None
        if periodic:
            e0, e1 = self.heat(T, Cp), self.heat(T1, Cp)
            drift = abs(e1 - e0) / abs(e0)
            # Periodic: sum(Cp*T) is conserved up to float32 rounding.
            if not drift < 1e-5:
                raise SmokeFailure(f"{tag}: heat drift {drift:.3e} >= 1e-5")
        one = t3.make_step(p)
        _, sec1 = it.time_steps(lambda T, Cp: (one(T, Cp), Cp), (T, Cp),
                                n1=10, n2=40, warmup=2)
        # Where a make_step call's time goes: device time per call, by
        # kernel, against the wall time per call above.
        split, _ = device_ms_by_kernel(lambda: one(T, Cp), 20)
        device = sum(split.values())
        log(f"[phase {2 if periodic else 3}] {tag} make_step split: wall "
            f"{sec1 * 1e3:.4f} ms/call, device {device:.4f} ms/call "
            f"{json.dumps(split)}")
        log(f"[phase {2 if periodic else 3}] headline {tag}: {steps} steps, "
            f"10-step max abs err vs plain {err10:.3e} (tolerance 0), heat "
            f"drift {drift if drift is None else f'{drift:.3e}'}, range "
            f"[{lo1:.4f}, {hi1:.4f}] within [{lo:.4f}, {hi:.4f}]; "
            f"make_multi_step({self.n_inner}) {sec * 1e3:.4f} ms/step, "
            f"make_step {sec1 * 1e3:.4f} ms/step")
        self.perf[f"headline_{tag}"] = dict(ms_per_step=sec * 1e3,
                                            make_step_ms=sec1 * 1e3,
                                            make_step_device_ms=device)

    def recv_mode(self):
        """Multi-block grids through the fused per-step kernel, against the
        plain path and against the same global problem on one block."""
        it, t3 = self.it, self.t3
        nx, ny, nz = self.recv_local
        p = t3.Params()
        for kw in (dict(), dict(periodz=1)):
            self.grid((nx, ny, nz), dimx=2, dimy=2, dimz=1, **kw)
            T, Cp = t3.init_fields(p)
            Tk = t3.make_multi_step(10, p)(T, Cp)
            Tp = t3.make_multi_step(10, p, use_kernels=False)(T, Cp)
            err = check(f"recv {kw}: 10 steps vs plain path", Tk, Tp, 0.0)
            multi = it.gather_interior(Tk)
            # The same global grid on one block (open: 2*(n-2)+2 cells).
            one = (2 * nx - 2, 2 * ny - 2, nz)
            self.grid(one, **SINGLE, **kw)
            T, Cp = t3.init_fields(p)
            single = it.gather_interior(t3.make_multi_step(10, p)(T, Cp))
            if multi.shape != single.shape:
                raise SmokeFailure(f"recv {kw}: shapes {multi.shape} {single.shape}")
            d = float(np.abs(multi.astype(np.float64) - single).max())
            # float32, the tolerance of igg's own kernel tests.
            if not np.allclose(multi, single, rtol=2e-6, atol=2e-5):
                raise SmokeFailure(f"recv {kw}: 2x2x1 vs one block: {d:.3e}")
            log(f"[phase 4] recv dims (2,2,1) {nx}x{ny}x{nz}/block {kw or 'open'}: "
                f"vs plain {err:.3e} (tolerance 0), vs one block {d:.3e} "
                f"(rtol 2e-6, atol 2e-5)")

    def standalone_halo(self, phase: int, local, **kw):
        """`update_halo` on a field of `local` blocks, f32 and f64, against
        the plain version; us per call (host clock)."""
        it = self.it
        tag = f"{'x'.join(map(str, local))} {kw}"
        for dtype in (torch.float32, torch.float64):
            g = self.grid(local, **kw)
            A = uniform(it.stacked_shape(g.nxyz), -1, 1, dtype, self.dev, 9)
            ref = it.update_halo(A.clone(), plain=True)
            it.update_halo(A)
            err = check(f"update_halo {tag} {dtype}", A, ref, 0.0)
            del ref
            sync(self.dev)
            t0 = time.perf_counter()
            for _ in range(self.halo_calls):
                it.update_halo(A)
            sync(self.dev)
            us = (time.perf_counter() - t0) / self.halo_calls * 1e6
            key = "" if g.dims == (1, 1, 1) else "_" + "x".join(map(str, g.dims))
            self.perf[f"update_halo{key}_{dtype}"] = dict(us_per_call=us)
            log(f"[phase {phase}] update_halo {tag} {dtype}: vs plain "
                f"{err:.3e} (tolerance 0), {us:.2f} us/call (host clock)")

    def headline_510(self):
        """The reference's 510^3 headline (2x2x2 blocks of 256^3, open) on
        one card: the chunk route against the per-step route and the plain
        path, then ms/step of both routes."""
        it, t3, dp = self.it, self.t3, self.dp
        n, steps = self.n_multi, self.steps_multi
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2)
        size = (it.nx_g(), it.ny_g(), it.nz_g())
        if size != (2 * (n - 2) + 2,) * 3:
            raise SmokeFailure(f"global size {size}")
        tag = f"{size[0]}^3 open (2x2x2 x {n}^3)"
        p = t3.Params()
        sc = dp.scal(*p.spacing())
        T, Cp = t3.init_fields(p)
        chunked = t3.make_multi_step(steps, p)
        before = self.ops.launch_counts()["diffusion_chunk_step"]
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9     # T and Cp
        Tc = chunked(T, Cp)
        sync(self.dev)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        A = float(p.timestep() * p.lam) / Cp
        launched = self.ops.launch_counts()["diffusion_chunk_step"] - before
        if launched != (steps - 1) // K_CHUNK * K_CHUNK:
            raise SmokeFailure(f"{tag}: {launched} chunk launches in {steps} steps")
        Tp = T
        for _ in range(steps):
            Tp = dp.fused_diffusion_step(Tp, A, **sc)
        err_route = check(f"{tag}: chunk route vs per-step route", Tc, Tp, 0.0)
        del Tp
        err_plain = check(f"{tag}: chunk route vs plain path", Tc,
                          t3.make_multi_step(steps, p, use_kernels=False)(T, Cp),
                          0.0)
        if not bool(torch.isfinite(Tc).all()):
            raise SmokeFailure(f"{tag}: non-finite temperature")
        lo, hi = float(T.min()), float(T.max())
        lo1, hi1 = float(Tc.min()), float(Tc.max())
        if lo1 < lo - 1e-3 or hi1 > hi + 1e-3:
            raise SmokeFailure(f"{tag}: range [{lo1}, {hi1}] left [{lo}, {hi}]")
        e0, e1 = self.heat(T, Cp), self.heat(Tc, Cp)
        del Tc
        # Where a chunk-route call's time goes, by kernel.
        split_chunk, n_chunk = device_ms_by_kernel(lambda: chunked(T, Cp), 3)
        T1, sec = t3.run(self.nt_multi, p, dtype=torch.float32,
                         n_inner=steps)
        if not bool(torch.isfinite(T1).all()):
            raise SmokeFailure(f"{tag}: run() gave non-finite values")
        del T1
        one = lambda T, A: (dp.fused_diffusion_step(T, A, **sc), A)
        _, sec_ps = it.time_steps(one, (T, A), n1=10, n2=40, warmup=2)
        split_ps, n_ps = device_ms_by_kernel(lambda: one(T, A), 10)
        log(f"[phase 6] headline {tag}: {steps} steps, chunk route vs per-step "
            f"route {err_route:.3e}, vs plain path {err_plain:.3e} (tolerance "
            f"0), heat {e0:.6e} -> {e1:.6e}, range [{lo1:.4f}, {hi1:.4f}] "
            f"within [{lo:.4f}, {hi:.4f}]; peak device memory of the chunk "
            f"route {peak_gb:.3f} GB, of which {held_gb:.3f} GB held before "
            f"the call (T, Cp)")
        log(f"[phase 6] {tag}: chunk route make_multi_step({steps}) "
            f"{sec * 1e3:.4f} ms/step; per-step route {sec_ps * 1e3:.4f} "
            f"ms/step")
        log(f"[phase 6] {tag}: chunk route, one call of {steps} steps: "
            f"{n_chunk:.0f} launches, device {sum(split_chunk.values()):.4f} "
            f"ms {json.dumps(split_chunk)}")
        log(f"[phase 6] {tag}: per-step route, one step: {n_ps:.0f} launches, "
            f"device {sum(split_ps.values()):.4f} ms {json.dumps(split_ps)}")
        self.perf["headline_510^3_open_2x2x2"] = dict(
            chunk_route_ms_per_step=sec * 1e3,
            per_step_route_ms_per_step=sec_ps * 1e3,
            chunk_route_device_ms_per_call=split_chunk,
            chunk_route_launches_per_call=n_chunk,
            per_step_route_device_ms_per_step=split_ps,
            per_step_route_launches_per_step=n_ps,
            peak_gb=peak_gb, held_gb=held_gb, heat=(e0, e1))

    def hm3d_state_check(self, tag, Pe, phi):
        """HM3D state after a run: finite, the porosity inside (0, 1)."""
        if not all(bool(torch.isfinite(F).all()) for F in (Pe, phi)):
            raise SmokeFailure(f"{tag}: non-finite Pe or phi")
        lo, hi = float(phi.min()), float(phi.max())
        if not 0.0 < lo <= hi < 1.0:
            raise SmokeFailure(f"{tag}: porosity range [{lo}, {hi}] leaves "
                               f"(0, 1)")
        return lo, hi

    def hm3d_one_block(self):
        """HM3D at n_head^3 f32, periodic, one block: the K-step loop
        against the plain path, `run()`, and `make_step`'s wall and device
        time per call."""
        it, h3 = self.it, self.h3
        n = self.n_head
        tag = f"HM3D {n}^3 periodic"
        self.grid((n, n, n), **SINGLE, **PERIODIC)
        p = h3.Params()
        Pe, phi = h3.init_fields(p)
        k10 = h3.make_multi_step(10, p)(Pe, phi)
        p10 = h3.make_multi_step(10, p, use_kernels=False)(Pe, phi)
        err10 = max(check(f"{tag}: 10 steps vs plain path, {name}", a, b, 0.0)
                    for name, a, b in zip(("Pe", "phi"), k10, p10))
        del k10, p10
        (Pe1, phi1), sec = h3.run(self.nt, p, dtype=torch.float32,
                                  n_inner=self.n_inner)
        n1 = max(1, self.nt // 4)     # the calls run() makes (warm-up 3)
        steps = (3 + n1 + max(self.nt - n1, n1 + 1)) * self.n_inner
        lo, hi = self.hm3d_state_check(tag, Pe1, phi1)
        moved = float((Pe1 - Pe).abs().max())
        if not moved > 0:
            raise SmokeFailure(f"{tag}: Pe did not change in {steps} steps")
        one = h3.make_step(p)
        _, sec1 = it.time_steps(one, (Pe, phi), n1=10, n2=40, warmup=2)
        split, _ = device_ms_by_kernel(lambda: one(Pe, phi), 20)
        device = sum(split.values())
        log(f"[phase 8] {tag} make_step split: wall {sec1 * 1e3:.4f} ms/call, "
            f"device {device:.4f} ms/call {json.dumps(split)}")
        log(f"[phase 8] {tag}: {steps} steps, 10-step max abs err vs plain "
            f"{err10:.3e} (tolerance 0), porosity in [{lo:.6f}, {hi:.6f}], "
            f"max |Pe change| {moved:.4e}; make_multi_step({self.n_inner}) "
            f"{sec * 1e3:.4f} ms/step, make_step {sec1 * 1e3:.4f} ms/step")
        self.perf[f"hm3d_{n}^3_periodic"] = dict(
            ms_per_step=sec * 1e3, make_step_ms=sec1 * 1e3,
            make_step_device_ms=device)

    def hm3d_508(self):
        """HM3D on 2x2x2 blocks of n_multi^3, periodic, on one card: the
        chunk route against the per-step route and the plain path, then
        ms/step of both routes."""
        it, h3, hp = self.it, self.h3, self.hp
        n, steps = self.n_multi, self.steps_multi
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2, **PERIODIC)
        size = (it.nx_g(), it.ny_g(), it.nz_g())
        if size != (2 * (n - 2),) * 3:
            raise SmokeFailure(f"HM3D global size {size}")
        tag = f"HM3D {size[0]}^3 periodic (2x2x2 x {n}^3)"
        p = h3.Params()
        kw = p.step_kwargs()
        Pe, phi = h3.init_fields(p)
        chunked = h3.make_multi_step(steps, p)
        before = self.ops.launch_counts()["hm3d_chunk_step"]
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9     # Pe and phi
        Sc = chunked(Pe, phi)
        sync(self.dev)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = self.ops.launch_counts()["hm3d_chunk_step"] - before
        if launched != (steps - 1) // K_CHUNK * K_CHUNK:
            raise SmokeFailure(f"{tag}: {launched} chunk launches in {steps} "
                               f"steps")
        Sp = (Pe, phi)
        for _ in range(steps):
            Sp = hp.fused_hm3d_step(*Sp, **kw)
        err_route = max(check(f"{tag}: chunk route vs per-step route, {name}",
                              a, b, 0.0)
                        for name, a, b in zip(("Pe", "phi"), Sc, Sp))
        del Sp
        plain = h3.make_multi_step(steps, p, use_kernels=False)(Pe, phi)
        err_plain = max(check(f"{tag}: chunk route vs plain path, {name}",
                              a, b, 0.0)
                        for name, a, b in zip(("Pe", "phi"), Sc, plain))
        del plain
        lo, hi = self.hm3d_state_check(tag, *Sc)
        del Sc
        split_chunk, n_chunk = device_ms_by_kernel(lambda: chunked(Pe, phi), 3)
        (P1, f1), sec = h3.run(self.nt_multi, p, dtype=torch.float32,
                               n_inner=steps)
        self.hm3d_state_check(f"{tag} run()", P1, f1)
        del P1, f1
        one = lambda Pe, phi: hp.fused_hm3d_step(Pe, phi, **kw)
        _, sec_ps = it.time_steps(one, (Pe, phi), n1=10, n2=40, warmup=2)
        split_ps, n_ps = device_ms_by_kernel(lambda: one(Pe, phi), 10)
        log(f"[phase 9] {tag}: {steps} steps, chunk route vs per-step route "
            f"{err_route:.3e}, vs plain path {err_plain:.3e} (tolerance 0), "
            f"porosity in [{lo:.6f}, {hi:.6f}]; peak device memory of the "
            f"chunk route {peak_gb:.3f} GB, of which {held_gb:.3f} GB held "
            f"before the call (Pe, phi)")
        log(f"[phase 9] {tag}: chunk route make_multi_step({steps}) "
            f"{sec * 1e3:.4f} ms/step; per-step route {sec_ps * 1e3:.4f} "
            f"ms/step")
        log(f"[phase 9] {tag}: chunk route, one call of {steps} steps: "
            f"{n_chunk:.0f} launches, device {sum(split_chunk.values()):.4f} "
            f"ms {json.dumps(split_chunk)}")
        log(f"[phase 9] {tag}: per-step route, one step: {n_ps:.0f} launches, "
            f"device {sum(split_ps.values()):.4f} ms {json.dumps(split_ps)}")
        self.perf["hm3d_508^3_periodic_2x2x2"] = dict(
            chunk_route_ms_per_step=sec * 1e3,
            per_step_route_ms_per_step=sec_ps * 1e3,
            chunk_route_device_ms_per_call=split_chunk,
            chunk_route_launches_per_call=n_chunk,
            per_step_route_device_ms_per_step=split_ps,
            per_step_route_launches_per_step=n_ps,
            peak_gb=peak_gb, held_gb=held_gb)

    def wave_fresh(self, p):
        """`init_fields` with its halos updated: an overlap-consistent state
        (every duplicated cell equal), from which the chunk route equals
        the per-step route bit for bit."""
        return self.it.update_halo(*self.w2.init_fields(p))

    def wave_routes(self, tag, S, steps, p):
        """`steps` steps of the wave2d state `S` on the dispatch (the chunk
        route), on the per-step route and on the plain path, held equal
        bitwise; returns the chunk route's state, the chunk launches it
        made and its peak device memory beyond what was held before."""
        w2, wp = self.w2, self.wp
        kw = p.step_kwargs()
        before = self.ops.launch_counts()["wave2d_chunk_step"]
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        Sc = w2.make_multi_step(steps, p)(*S)
        sync(self.dev)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = self.ops.launch_counts()["wave2d_chunk_step"] - before
        if launched != (steps - 1) // K_CHUNK * K_CHUNK:
            raise SmokeFailure(f"{tag}: {launched} chunk launches in {steps} "
                               f"steps")
        Sp = tuple(S)
        for _ in range(steps):
            Sp = wp.fused_wave2d_step(*Sp, **kw)
        err_route = max(check(f"{tag}: chunk route vs per-step route, {name}",
                              a, b, 0.0)
                        for name, a, b in zip(("P", "Vx", "Vy"), Sc, Sp))
        del Sp
        plain = w2.make_multi_step(steps, p, use_kernels=False)(*S)
        err_plain = max(check(f"{tag}: chunk route vs plain path, {name}",
                              a, b, 0.0)
                        for name, a, b in zip(("P", "Vx", "Vy"), Sc, plain))
        del plain
        if not all(bool(torch.isfinite(A).all()) for A in Sc):
            raise SmokeFailure(f"{tag}: non-finite fields")
        return Sc, err_route, err_plain, peak_gb, held_gb

    def wave2d_one_block(self):
        """wave2d at n_wave^2 f32, periodic, one block: the routes against
        each other over 10 steps, `run()` (the chunk route), the energy
        bound, ms/step of the chunk and per-step routes."""
        it, w2, wp = self.it, self.w2, self.wp
        n = self.n_wave
        tag = f"wave2d {n}^2 periodic"
        self.grid((n, n, 1), dimx=1, dimy=1, dimz=1, periodx=1, periody=1)
        p = w2.Params()
        S = self.wave_fresh(p)
        _, err_route, err_plain, _, _ = self.wave_routes(tag, S, 10, p)
        e0 = w2.energy(*w2.init_fields(p))
        S1, sec = w2.run(self.nt, p, dtype=torch.float32, n_inner=self.n_inner)
        n1 = max(1, self.nt // 4)     # the calls run() makes (warm-up 1)
        steps = (1 + n1 + max(self.nt - n1, n1 + 1)) * self.n_inner
        if not all(bool(torch.isfinite(A).all()) for A in S1):
            raise SmokeFailure(f"{tag}: run() gave non-finite fields")
        e1 = w2.energy(*S1)
        drift = (e1 - e0) / e0
        # igg's bounded wave_energy invariant (igg/models/wave2d.py:418).
        if not abs(drift) <= 0.25:
            raise SmokeFailure(f"{tag}: energy {e0:.6e} -> {e1:.6e}")
        moved = float((S1[0] - S[0]).abs().max())
        if not moved > 0:
            raise SmokeFailure(f"{tag}: P did not change in {steps} steps")
        del S1
        kw = p.step_kwargs()
        one = lambda *T: wp.fused_wave2d_step(*T, **kw)
        _, sec_ps = it.time_steps(one, S, n1=10, n2=40, warmup=2)
        split_ps, n_ps = device_ms_by_kernel(lambda: one(*S), 10)
        chunked = w2.make_multi_step(self.n_inner, p)
        split_chunk, n_chunk = device_ms_by_kernel(lambda: chunked(*S), 2)
        log(f"[phase 10] {tag}: 10 steps, chunk route vs per-step route "
            f"{err_route:.3e}, vs plain path {err_plain:.3e} (tolerance 0); "
            f"run() {steps} steps, energy {e0:.6e} -> {e1:.6e} ({drift:+.3e}, "
            f"bound 25%), max |P change| {moved:.4e}")
        log(f"[phase 10] {tag}: chunk route make_multi_step({self.n_inner}) "
            f"{sec * 1e3:.4f} ms/step; per-step route {sec_ps * 1e3:.4f} "
            f"ms/step")
        log(f"[phase 10] {tag}: chunk route, one call of {self.n_inner} "
            f"steps: {n_chunk:.0f} launches, device "
            f"{sum(split_chunk.values()):.4f} ms {json.dumps(split_chunk)}")
        log(f"[phase 10] {tag}: per-step route, one step: {n_ps:.0f} "
            f"launches, device {sum(split_ps.values()):.4f} ms "
            f"{json.dumps(split_ps)}")
        self.perf[f"wave2d_{n}^2_periodic"] = dict(
            chunk_route_ms_per_step=sec * 1e3,
            per_step_route_ms_per_step=sec_ps * 1e3,
            chunk_route_device_ms_per_call=split_chunk,
            chunk_route_launches_per_call=n_chunk,
            per_step_route_device_ms_per_step=split_ps,
            per_step_route_launches_per_step=n_ps, energy=(e0, e1))

    def wave2d_multiblock(self):
        """wave2d on wave_blocks x 1 blocks of n_wave^2, periodic, on one
        card: the chunk route against the per-step route and the plain
        path over 17 steps, then ms/step of both routes."""
        it, w2, wp = self.it, self.w2, self.wp
        n, nb, steps = self.n_wave, self.wave_blocks, self.steps_multi
        self.grid((n, n, 1), dimx=nb, dimy=1, dimz=1, periodx=1, periody=1)
        size = (it.nx_g(), it.ny_g())
        if size != (nb * (n - 2), n - 2):
            raise SmokeFailure(f"wave2d global size {size}")
        tag = f"wave2d {size[0]}x{size[1]} periodic ({nb}x1 x {n}^2)"
        p = w2.Params()
        S = self.wave_fresh(p)
        Sc, err_route, err_plain, peak_gb, held_gb = self.wave_routes(
            tag, S, steps, p)
        del Sc
        chunked = w2.make_multi_step(steps, p)
        split_chunk, n_chunk = device_ms_by_kernel(lambda: chunked(*S), 3)
        S1, sec = w2.run(self.nt_multi, p, dtype=torch.float32, n_inner=steps)
        if not all(bool(torch.isfinite(A).all()) for A in S1):
            raise SmokeFailure(f"{tag}: run() gave non-finite fields")
        del S1
        kw = p.step_kwargs()
        one = lambda *T: wp.fused_wave2d_step(*T, **kw)
        _, sec_ps = it.time_steps(one, S, n1=10, n2=40, warmup=2)
        split_ps, n_ps = device_ms_by_kernel(lambda: one(*S), 10)
        log(f"[phase 11] {tag}: {steps} steps, chunk route vs per-step route "
            f"{err_route:.3e}, vs plain path {err_plain:.3e} (tolerance 0); "
            f"peak device memory of the chunk route {peak_gb:.3f} GB, of "
            f"which {held_gb:.3f} GB held before the call (P, Vx, Vy)")
        log(f"[phase 11] {tag}: chunk route make_multi_step({steps}) "
            f"{sec * 1e3:.4f} ms/step; per-step route {sec_ps * 1e3:.4f} "
            f"ms/step")
        log(f"[phase 11] {tag}: chunk route, one call of {steps} steps: "
            f"{n_chunk:.0f} launches, device {sum(split_chunk.values()):.4f} "
            f"ms {json.dumps(split_chunk)}")
        log(f"[phase 11] {tag}: per-step route, one step: {n_ps:.0f} "
            f"launches, device {sum(split_ps.values()):.4f} ms "
            f"{json.dumps(split_ps)}")
        self.perf[f"wave2d_{size[0]}x{size[1]}_periodic_{nb}x1"] = dict(
            chunk_route_ms_per_step=sec * 1e3,
            per_step_route_ms_per_step=sec_ps * 1e3,
            chunk_route_device_ms_per_call=split_chunk,
            chunk_route_launches_per_call=n_chunk,
            per_step_route_device_ms_per_step=split_ps,
            per_step_route_launches_per_step=n_ps,
            peak_gb=peak_gb, held_gb=held_gb)

    # -- stokes3d ----------------------------------------------------------
    def stokes_state(self, g, dtype, seed):
        """Random (P, Vx, Vy, Vz, Rho) on the grid `g`."""
        return [uniform(self.it.stacked_shape(s), -1, 1, dtype, self.dev,
                        seed + f)
                for f, s in enumerate(self.sp.field_shapes(g.nxyz))]

    def stokes_chunk(self, g, state, Rho, K, kw):
        """The extended buffers of a depth-K chunk of the Stokes fields
        `state` (and `Rho`), the kernel's result and the plain version's."""
        ce, sp, stz = self.ce, self.sp, self.stz
        modes = ce.dim_modes(g)
        shapes = sp.field_shapes(g.nxyz)
        ols = ce.field_ols(g, shapes)
        exts = ce.extend_fields(list(state), ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        out = stz.chunk_call(exts, Rho_ext, shapes, K=K, modes=modes, grid=g,
                             kw=kw, ols=ols)
        ref = [ce.central_window(U, s, 2 * K, modes) for U, s in zip(
            stz.window_iters_plain(exts, Rho_ext, K=K, modes=modes, grid=g,
                                   kw=kw, ols=ols), shapes)]
        return exts, Rho_ext, modes, shapes, ols, out, ref

    def stokes_kernel_checks(self):
        """The Stokes iteration on every layout and its chunk step at every
        admitted depth, f32 and f64, against their plain versions at small
        shapes."""
        sp, stz = self.sp, self.stz
        kw = dict(dx=0.31, dy=0.27, dz=0.43, mu=1.3, dtP=0.07, dtV=0.011)
        for case, gkw in STOKES_GRIDS.items():
            for local, Ks in STOKES_SHAPES:
                g = self.grid(local, **OL3, **gkw)
                for dtype in (torch.float32, torch.float64):
                    *S, Rho = self.stokes_state(g, dtype, 51)
                    tag = f"{case} {local} {dtype}"
                    out = sp.step_kernel(*S, Rho, g.dims, kw)
                    ref = sp.step_plain(*S, Rho, g.dims, kw)
                    for name, a, b in zip(STOKES_NAMES, out, ref):
                        self.note("stokes_step", check(
                            f"stokes_step {name} {tag}", a, b, 0.0))
                    for K in Ks:
                        why = stz.stokes_chunk_refusal(g, local, K, K, dtype)
                        if why is not None:
                            raise SmokeFailure(f"Stokes chunk {tag} K={K}: "
                                               f"refused: {why}")
                        *_, out, ref = self.stokes_chunk(g, S, Rho, K, kw)
                        for name, a, b in zip(STOKES_NAMES, out, ref):
                            self.note("stokes_chunk_step", check(
                                f"stokes_chunk_step {name} {tag} K={K}", a,
                                b, 0.0))
        log(f"[phase 1] Stokes small-shape kernel checks passed: max abs err "
            f"step {self.err['stokes_step']:.1e}, chunk "
            f"{self.err['stokes_chunk_step']:.1e} (tolerance 0)")

    def stokes_kernel_checks_full(self):
        """Both Stokes kernels at full width, f32: one iteration on one
        n_stokes^3 block, periodic, and one K=8 chunk on 2x2x2 of them,
        open (the main path's shapes), checked, then timed beside their
        plain versions and bounds."""
        ce, sp, stz = self.ce, self.sp, self.stz
        n, k, K = self.n_stokes, self.time_iters, K_CHUNK
        g = self.grid((n, n, n), **SINGLE, **PERIODIC, **OL3)
        kw = self.st3._pseudo_steps(self.st3.Params())
        *S, Rho = self.stokes_state(g, torch.float32, 53)
        out = sp.step_kernel(*S, Rho, g.dims, kw)
        for name, a, b in zip(STOKES_NAMES, out,
                              sp.step_plain(*S, Rho, g.dims, kw)):
            self.note("stokes_step", check(f"stokes_step {name} {n}^3", a, b,
                                           0.0))
        del out
        cells = float(n) ** 3
        rd = float(sum(A.numel() for A in S + [Rho]))
        wr = float(sum(A.numel() for A in S))
        self.perf["stokes_step"] = dict(
            kernel_time(lambda: sp.step_kernel(*S, Rho, g.dims, kw), k,
                        STOKES_STEP_KERNEL),
            plain_ms=event_ms(lambda: sp.step_plain(*S, Rho, g.dims, kw), 3),
            # Read P, Vx, Vy, Vz and Rho once, write the four once.
            bound=bound_ms(4 * (rd + wr), STOKES_FLOPS * cells, F32_FLOPS))
        del S, Rho
        self.stokes_step_shapes()
        m = self.n_multi
        # The chunk: 2x2x2 blocks of m^3, open (8 extended blocks of
        # (m + 32)^3, config 5 at 509^3) in f32, the main path's, and f64;
        # one n^3 periodic block (x extended, y and z wrapped: phase 12's).
        for key, dtype, layout, tag in (
                ("stokes_chunk_step", torch.float32,
                 dict(dimx=2, dimy=2, dimz=2), f"2x2x2 x {m}^3 f32 open"),
                ("stokes_chunk_step_f64", torch.float64,
                 dict(dimx=2, dimy=2, dimz=2), f"2x2x2 x {m}^3 f64 open"),
                ("stokes_chunk_step_one_block", torch.float32,
                 dict(SINGLE, **PERIODIC), f"{n}^3 f32 periodic")):
            g = self.grid((m, m, m) if layout.get("dimx") == 2 else
                          (n, n, n), **layout, **OL3)
            kw = self.st3._pseudo_steps(self.st3.Params())
            *S, Rho = self.stokes_state(g, dtype, 55)
            exts, Rho_ext, modes, shapes, ols, out, ref = self.stokes_chunk(
                g, S, Rho, K, kw)
            for name, a, b in zip(STOKES_NAMES, out, ref):
                self.note("stokes_chunk_step", check(
                    f"stokes_chunk_step {name} {tag} K={K}", a, b, 0.0))
            del out, ref, S, Rho
            self.perf[key] = dict(
                kernel_time(lambda: stz.chunk_call(
                    exts, Rho_ext, shapes, K=K, modes=modes, grid=g, kw=kw,
                    ols=ols), max(k // 10, 2), "stokes_march_kernel"),
                plain_ms=event_ms(lambda: ce.window_step_plain(
                    exts, exts, E=2 * K, modes=modes, grid=g,
                    core=stz.window_core(g, Rho_ext, kw),
                    flags=ce.edge_flags(modes, g),
                    freeze_fields=stz.FREEZE_FIELDS, ols=ols), 2),
                bound=self.stokes_chunk_bound(g, exts, Rho_ext, shapes, K,
                                              modes),
                shape=tag)
            self.perf[key]["events_ms"] /= K
            if key == "stokes_chunk_step":
                # The step kernel on the same extended buffers (every
                # extended block a block): what the chunk's freezes and
                # window cost beyond it.
                outs = [torch.empty_like(X) for X in exts]
                self.perf["stokes_step_on_chunk_buffer_ms"] = event_ms(
                    lambda: sp.launch_step(*exts, Rho_ext, g.dims, kw,
                                           out=outs), 3)
                del outs
            del exts, Rho_ext
        for name, p in (
                ("stokes_step", dict(self.perf["stokes_step"],
                                     shape=f"{n}^3 f32 periodic")),
                ("stokes_chunk_step K=8", self.perf["stokes_chunk_step"]),
                ("stokes_chunk_step K=8", self.perf["stokes_chunk_step_f64"]),
                ("stokes_chunk_step K=8",
                 self.perf["stokes_chunk_step_one_block"])):
            log(f"[phase 1] {name} at {p['shape']}: {p['ms']:.4f} ms device "
                f"per launch ({p['ms_from']}), {p['events_ms']:.4f} ms per "
                f"launch back to back (events), plain {p['plain_ms']:.4f} ms"
                f"{' (one window step)' if 'chunk' in name else ''}, bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]})")
        log(f"[phase 1] stokes_step on the chunk's extended buffers (events): "
            f"{self.perf['stokes_step_on_chunk_buffer_ms']:.4f} ms")
        self.stokes_division_check()

    def stokes_step_shapes(self):
        """The Stokes step kernel beside its first design (stokes.cuh's
        2-cell runs on stagger_walk3.cuh) in the same run, at the main
        path's shapes: one periodic n_stokes^3 block (phase 12's) and 2x2x2
        open blocks of n_multi^3 (phase 13's), f32 and f64; the shapes
        other than the first also timed beside their plain versions and
        bounds."""
        sp, k = self.sp, self.time_iters
        kw = self.st3._pseudo_steps(self.st3.Params())
        for key, dtype, blocks in (
                ("stokes_step", torch.float32, 1),
                ("stokes_step_f64", torch.float64, 1),
                ("stokes_step_2x2x2", torch.float32, 2),
                ("stokes_step_2x2x2_f64", torch.float64, 2)):
            f64 = dtype == torch.float64
            n = self.n_stokes if blocks == 1 else self.n_multi
            layout = (dict(SINGLE, **PERIODIC) if blocks == 1
                      else dict(dimx=2, dimy=2, dimz=2))
            g = self.grid((n, n, n), **layout, **OL3)
            tag = (f"{'2x2x2 x ' if blocks == 2 else ''}{n}^3 "
                   f"{'f64' if f64 else 'f32'} "
                   f"{'periodic' if blocks == 1 else 'open'}")
            *S, Rho = self.stokes_state(g, dtype, 57)
            ref = sp.step_plain(*S, Rho, g.dims, kw)
            run = lambda: sp.step_kernel(*S, Rho, g.dims, kw)
            for name, a, b in zip(STOKES_NAMES, run(), ref):
                self.note("stokes_step", check(f"stokes_step {name} {tag}", a,
                                               b, 0.0))
            if key != "stokes_step":
                size, rate = (8, F64_FLOPS) if f64 else (4, F32_FLOPS)
                rd = float(sum(A.numel() for A in S + [Rho]))
                wr = float(sum(A.numel() for A in S))
                self.perf[key] = dict(
                    kernel_time(run, k, STOKES_STEP_KERNEL),
                    plain_ms=event_ms(lambda: sp.step_plain(*S, Rho, g.dims,
                                                            kw), 2),
                    bound=bound_ms(size * (rd + wr),
                                   STOKES_FLOPS * float(S[0].numel()), rate),
                    shape=tag)
            self.perf[f"{key}_first_design"] = self.first_design_time(
                sp, "stokes_step", run, k, "Stokes", None, ref, lambda b, f: b)
            del S, Rho, ref
            p, q = self.perf[key], self.perf[f"{key}_first_design"]
            log(f"[phase 1] stokes_step at {tag}: {p['ms']:.4f} ms device "
                f"({p['ms_from']}), plain {p['plain_ms']:.4f} ms, bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]}); its first design "
                f"(stagger_walk3.cuh) {q['ms']:.4f} ms in the same run, "
                f"{q['ms'] / p['ms']:.2f} times the march's")

    def stokes_division_check(self):
        """The marches' float32 division (csrc/const_div.cuh) bitwise `x /
        d` over all 2^32 float32 dividends, for every divisor of the Stokes
        and HM3D band and chunk checks and phases: 3, the small checks'
        spacings and HM3D's 1.3, phi0 and eta, the spacings of config 5 and
        of HM3D on each grid their phases use and on the HM3D chunk
        checks' small grids."""
        st3, stz, h3 = self.st3, self.stz, self.h3
        hp = h3.Params()
        divisors = {3.0, 0.31, 0.27, 0.43, 1.3, hp.phi0, hp.eta}
        for local, layout in (((self.n_stokes,) * 3, dict(SINGLE, **PERIODIC)),
                              ((self.n_multi,) * 3, dict(dimx=2, dimy=2,
                                                         dimz=2))):
            self.grid(local, **layout, **OL3)
            kw = st3._pseudo_steps(st3.Params())
            divisors |= {kw["dx"], kw["dy"], kw["dz"]}
        for local, layout in (((self.n_head,) * 3, dict(SINGLE, **PERIODIC)),
                              ((self.n_multi,) * 3, dict(dimx=2, dimy=2,
                                                         dimz=2,
                                                         **PERIODIC))):
            self.grid(local, **layout)
            divisors |= set(hp.spacing())
        # The HM3D chunk checks' spacings (chunk_and_pack_checks).
        for (dims, per), local in ((c, s) for c in CHUNK_GRIDS.values()
                                   for s in CHUNK_SHAPES):
            self.grid(local, dimx=dims[0], dimy=dims[1], dimz=dims[2],
                      periodx=per[0], periody=per[1], periodz=per[2])
            divisors |= set(hp.spacing())
        t0 = time.perf_counter()
        for d in sorted(divisors):
            bad = stz.division_mismatches(d, device=self.dev)
            if bad:
                raise SmokeFailure(f"stokes division by {d!r}: {bad} of 2^32 "
                                   f"float32 dividends differ from x / d")
        log(f"[phase 1] march division: bitwise x / d over all 2^32 float32 "
            f"dividends for the {len(divisors)} divisors "
            f"{sorted(divisors)} ({time.perf_counter() - t0:.1f} s)")

    @staticmethod
    def stokes_chunk_bound(g, exts, Rho_ext, shapes, K, modes):
        """Least time per launch of one Stokes chunk (K launches), from the
        real tensor sizes: each launch reads the five extended fields, all
        but the last write the four extended ones, the last the central
        windows; every launch reads the chunk-entry values of the three
        velocities' frozen cells."""
        E = 2 * K
        rd = float(sum(X.numel() for X in exts) + Rho_ext.numel())
        wr_ext = float(sum(X.numel() for X in exts))
        wr_out = float(sum(np.prod([g.dims[d] * s[d] for d in range(3)])
                           for s in shapes[:4]))
        frozen = 0.0
        for X in exts[1:]:
            kept = 1.0
            for d in range(3):   # rows along d outside every freeze
                rows = {"oext": 2 * (E + 1), "frozen": 2}.get(modes[d], 0)
                kept *= X.shape[d] - rows
            frozen += X.numel() - kept
        nbytes = exts[0].element_size() * (K * rd + (K - 1) * wr_ext + wr_out
                                           + K * frozen)
        out_cells = float(np.prod([g.dims[d] * shapes[0][d]
                                   for d in range(3)]))
        ops = STOKES_FLOPS * ((K - 1) * exts[0].numel() + out_cells)
        return bound_ms(nbytes / K, ops / K, F32_FLOPS)

    def stokes_routes(self, tag, S, steps, p):
        """`steps` iterations of the Stokes state `S = (P, Vx, Vy, Vz, Rho)`
        on the dispatch (the chunk route), on the per-iteration route and on
        the plain path, held equal bitwise; returns the chunk route's state,
        both errors, and its peak device memory beyond what was held
        before."""
        st3, sp = self.st3, self.sp
        kw = st3._pseudo_steps(p)
        *V, Rho = S
        before = self.ops.launch_counts()["stokes_chunk_step"]
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        Sc = st3.make_iteration(p, n_inner=steps)(*V, Rho)
        sync(self.dev)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = self.ops.launch_counts()["stokes_chunk_step"] - before
        if launched != (steps - 1) // K_CHUNK * K_CHUNK:
            raise SmokeFailure(f"{tag}: {launched} chunk launches in {steps} "
                               f"iterations")
        Sp = tuple(V)
        for _ in range(steps):
            Sp = sp.fused_stokes_iteration(*Sp, Rho, **kw)
        err_route = max(check(f"{tag}: chunk route vs per-iteration route, "
                              f"{name}", a, b, 0.0)
                        for name, a, b in zip(STOKES_NAMES, Sc, Sp))
        del Sp
        plain = st3.make_iteration(p, n_inner=steps, use_kernels=False)(
            *V, Rho)
        err_plain = max(check(f"{tag}: chunk route vs plain path, {name}",
                              a, b, 0.0)
                        for name, a, b in zip(STOKES_NAMES, Sc, plain))
        del plain
        self.stokes_state_check(tag, Sc)
        return Sc, err_route, err_plain, peak_gb, held_gb

    def stokes_state_check(self, tag, S):
        """Finite fields, and buoyancy that has set the fluid moving."""
        if not all(bool(torch.isfinite(A).all()) for A in S):
            raise SmokeFailure(f"{tag}: non-finite fields")
        if not float(S[3].abs().max()) > 0:
            raise SmokeFailure(f"{tag}: Vz did not move")

    def stokes_timed(self, phase, tag, p, n_inner, nt):
        """Both Stokes routes slope-timed over the same trajectory: the
        chunk route through `run()` (`make_iteration(n_inner)`, `nt` timed
        calls from `init_fields`), the per-iteration route through the same
        calls and counts of `n_inner` fused iterations from the same state
        (the IEEE divisions' cost depends on the data: a zero dividend takes
        their slow path); then each route's device time split by kernel on
        the state `run()` reached."""
        it, st3, sp = self.it, self.st3, self.sp
        kw = st3._pseudo_steps(p)
        S1, sec = st3.run(nt, p, dtype=torch.float32, n_inner=n_inner)
        self.stokes_state_check(f"{tag} run()", S1[:4])

        def per_iteration(P, Vx, Vy, Vz, Rho):
            S = (P, Vx, Vy, Vz)
            for _ in range(n_inner):
                S = sp.fused_stokes_iteration(*S, Rho, **kw)
            return S + (Rho,)

        n1 = max(1, nt // 4)     # the calls run() makes (warm-up 3)
        S2, sec_ps = it.time_steps(per_iteration, st3.init_fields(p), n1=n1,
                                   n2=max(nt - n1, n1 + 1))
        self.stokes_state_check(f"{tag} per-iteration route", S2[:4])
        del S2
        chunked = st3.make_iteration(p, n_inner=n_inner)
        split_chunk, n_chunk = device_ms_by_kernel(lambda: chunked(*S1), 2)
        split_ps, n_ps = device_ms_by_kernel(
            lambda: sp.fused_stokes_iteration(*S1, **kw), 10)
        iters = (3 + n1 + max(nt - n1, n1 + 1)) * n_inner
        vz = float(S1[3].abs().max())
        log(f"[phase {phase}] {tag}: chunk route make_iteration(n_inner="
            f"{n_inner}) through "
            f"run(): {sec * 1e3:.4f} ms/iteration; per-iteration route over "
            f"the same {iters} iterations {sec_ps / n_inner * 1e3:.4f} "
            f"ms/iteration; max |Vz| {vz:.4e}")
        log(f"[phase {phase}] {tag}: chunk route, one call of {n_inner} "
            f"iterations: "
            f"{n_chunk:.0f} launches, device {sum(split_chunk.values()):.4f} "
            f"ms {json.dumps(split_chunk)}")
        log(f"[phase {phase}] {tag}: per-iteration route, one iteration: "
            f"{n_ps:.0f} "
            f"launches, device {sum(split_ps.values()):.4f} ms "
            f"{json.dumps(split_ps)}")
        return dict(
            chunk_route_ms_per_iteration=sec * 1e3,
            per_iteration_route_ms_per_iteration=sec_ps / n_inner * 1e3,
            iterations_timed=iters,
            chunk_route_device_ms_per_call=split_chunk,
            chunk_route_launches_per_call=n_chunk,
            per_iteration_route_device_ms_per_iteration=split_ps,
            per_iteration_route_launches_per_iteration=n_ps)

    def stokes_one_block(self):
        """stokes3d at n_stokes^3 f32, fully periodic, one block: the routes
        against each other over 10 iterations, then both routes timed
        (:meth:`stokes_timed`, the chunk route through `run()`)."""
        st3 = self.st3
        n = self.n_stokes
        tag = f"Stokes {n}^3 periodic"
        self.grid((n, n, n), **SINGLE, **PERIODIC, **OL3)
        p = st3.Params()
        S = self.it.update_halo(*st3.init_fields(p))
        _, err_route, err_plain, _, _ = self.stokes_routes(tag, S, 10, p)
        del S
        log(f"[phase 12] {tag}: 10 iterations, chunk route vs per-iteration "
            f"route {err_route:.3e}, vs plain path {err_plain:.3e} "
            f"(tolerance 0)")
        self.perf[f"stokes_{n}^3_periodic"] = self.stokes_timed(
            12, tag, p, self.n_inner, self.nt)

    def stokes_509(self):
        """stokes3d on 2x2x2 blocks of n_multi^3, open, on one card: the
        chunk route against the per-iteration route and the plain path over
        17 iterations, then both routes timed (:meth:`stokes_timed`)."""
        it, st3 = self.it, self.st3
        n, steps = self.n_multi, self.steps_multi
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2, **OL3)
        size = (it.nx_g(), it.ny_g(), it.nz_g())
        if size != (2 * (n - 3) + 3,) * 3:
            raise SmokeFailure(f"Stokes global size {size}")
        tag = f"Stokes {size[0]}^3 open (2x2x2 x {n}^3)"
        p = st3.Params()
        S = it.update_halo(*st3.init_fields(p))
        Sc, err_route, err_plain, peak_gb, held_gb = self.stokes_routes(
            tag, S, steps, p)
        del Sc, S
        log(f"[phase 13] {tag}: {steps} iterations, chunk route vs "
            f"per-iteration route {err_route:.3e}, vs plain path "
            f"{err_plain:.3e} (tolerance 0); peak device memory of the chunk "
            f"route {peak_gb:.3f} GB, of which {held_gb:.3f} GB held before "
            f"the call (P, Vx, Vy, Vz, Rho)")
        perf = self.stokes_timed(13, tag, p, steps, self.nt_multi)
        self.perf[f"stokes_{size[0]}^3_open_2x2x2"] = dict(
            perf, peak_gb=peak_gb, held_gb=held_gb)

    # -- kernels generated from stencil specs -------------------------------
    def spec_gen(self, name):
        """The generated kernels of the spec case `name`."""
        return self.cases.kernels(name)

    def spec_grid(self, name, case, local):
        if self.it.grid_is_initialized():
            self.it.finalize_global_grid()
        return self.cases.init(self.it, name, case, local, self.dev)

    def spec_state(self, gen, g, dtype, seed):
        """Random fields in (-1, 1) of the spec on grid `g`."""
        nd = gen.spec.ndim
        return [uniform(self.it.stacked_shape(s), -1, 1, dtype, self.dev,
                        seed + f)
                for f, s in enumerate(self.sl.field_shapes(
                    gen.spec, g.nxyz[:nd]))]

    def spec_chunk(self, gen, g, S, K):
        """The extended buffers of a depth-K chunk of the spec's fields `S`
        (E = the analyzer's margin_after(K)), the kernel's result and the
        plain version's; None where the chunk refuses the layout."""
        ce, sl = self.ce, self.sl
        nd = gen.spec.ndim
        shapes = sl.field_shapes(gen.spec, g.nxyz[:nd])
        if sl.chunk_refusal(gen.spec, gen.analysis, g, shapes[0], K, K,
                            S[0].dtype) is not None:
            return None
        E = gen.analysis.margin_after(K)
        modes = ce.dim_modes(g)[:nd]
        ols = ce.field_ols(g, shapes)
        exts = ce.extend_fields(list(S), ols, E, g, modes)
        out = sl.chunk_call(gen, exts, shapes, K=K, E=E, modes=modes, grid=g,
                            ols=ols)
        ref = [ce.central_window(U, s, E, modes) for U, s in zip(
            sl.chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=g,
                           ols=ols), shapes)]
        return exts, modes, shapes, ols, out, ref

    def spec_kernel_checks(self):
        """The generated step and chunk step of every spec of tests/torch_spec_cases.py on
        every layout (every window mode), f32 and f64, against their plain
        versions; spec-wave2d against the hand wave2d kernels (the step
        always, the chunk on periodic grids), tolerance 0."""
        sl, wp, wtz, ce = self.sl, self.wp, self.wtz, self.ce
        kw = dict(dx=0.31, dy=0.27, dt=0.05, rho=1.3, bulk=0.7)
        cases = self.cases
        for name in cases.SPECS:
            gen = self.spec_gen(name)
            nd = gen.spec.ndim
            step_key = ("spec_step[shallow_water]" if "shallow" in name
                        else None)
            for case, local in ((c, s) for c in cases.grids(name)
                                for s in cases.locals_of(name)):
                g = self.spec_grid(name, case, local)
                for dtype in (torch.float32, torch.float64):
                    tag = f"{name} {case} {local} {dtype}"
                    S = self.spec_state(gen, g, dtype, 81)
                    out = sl.step_kernel(gen, S, g.dims[:nd])
                    ref = sl.step_plain(gen, S, g.dims[:nd])
                    for f, a, b in zip(gen.spec.fields, out, ref):
                        err = check(f"spec_step {f.name} {tag}", a, b, 0.0)
                        if step_key:
                            self.note(step_key, err)
                    ran = 0
                    for K in (2, 3):
                        got = self.spec_chunk(gen, g, S, K)
                        if got is None:
                            continue
                        *_, out, ref = got
                        for f, a, b in zip(gen.spec.fields, out, ref):
                            err = check(f"spec_chunk_step {f.name} {tag} "
                                        f"K={K}", a, b, 0.0)
                            if step_key:
                                self.note("spec_chunk_step[shallow_water]",
                                          err)
                        ran += 1
                    if not ran and name != "mixed":
                        raise SmokeFailure(f"spec chunk {tag}: refused")
                    if name != "wave2d_spec" or dtype != torch.float32:
                        continue
                    hand = wp.step_kernel(*S, g.dims[:2], kw)
                    spec = sl.step_kernel(gen, S, g.dims[:2])
                    for f, a, b in zip(gen.spec.fields, spec, hand):
                        check(f"spec-wave2d step vs wave2d_step {f.name} "
                              f"{tag}", a, b, 0.0)
                    modes = ce.dim_modes(g)[:2]
                    if any(m not in ("ext", "wrap") for m in modes):
                        continue
                    _, modes, shapes, ols, out, _ = self.spec_chunk(gen, g,
                                                                    S, 2)
                    hand = wtz.chunk_call(
                        ce.extend_fields(list(S), ols, 4, g, modes), shapes,
                        K=2, modes=modes, grid=g, kw=kw, ols=ols)
                    for f, a, b in zip(gen.spec.fields, out, hand):
                        check(f"spec-wave2d chunk vs wave2d_chunk_step "
                              f"{f.name} {tag}", a, b, 0.0)
        divs = {n: [self.cuda.divisions_per_cell(self.spec_gen(n).spec, r)
                    for r in (1, 4)] for n in cases.SPECS}
        log(f"[phase 1] generated spec kernels (specs {list(cases.SPECS)}, "
            f"{len(cases.GRIDS_2D)} 2-D and {len(cases.GRIDS_3D)} 3-D layouts, "
            f"f32 and f64): step and chunk step equal their plain versions, "
            f"spec-wave2d equals the hand wave2d kernels (tolerance 0); "
            f"divisions a cell (per-cell path, 4-cell run): "
            f"{json.dumps(divs)}")

    def spec_kernel_checks_full(self):
        """The generated kernels at full width, checked against their plain
        versions, then timed beside their bounds and their hand
        counterparts: the shallow-water step on one n_wave^2 periodic block,
        its K=8 chunk step on wave_blocks x 1 blocks of n_wave^2 (config 3:
        x periodic, y open), in f32; and the rank-3 specs' step and chunk
        step on one n_stokes^3 periodic block, f32 and f64, beside their
        first design (spec_entry_full)."""
        ce, sl = self.ce, self.sl
        n, k, K = self.n_wave, self.time_iters, K_CHUNK
        gen = self.spec_gen("shallow_water")
        g = self.grid((n, n, 1), dimx=1, dimy=1, dimz=1, periodx=1,
                      periody=1)
        S = self.spec_state(gen, g, torch.float32, 91)
        out = sl.step_kernel(gen, S, g.dims[:2])
        for f, a, b in zip(gen.spec.fields, out,
                           sl.step_plain(gen, S, g.dims[:2])):
            self.note("spec_step[shallow_water]", check(
                f"spec_step[shallow_water] {f.name} {n}^2", a, b, 0.0))
        del out
        cells = float(sum(A.numel() for A in S))
        self.perf["spec_step[shallow_water]"] = dict(
            kernel_time(lambda: sl.step_kernel(gen, S, g.dims[:2]), k,
                        "Spec_shallow_water"),
            plain_ms=event_ms(lambda: sl.step_plain(gen, S, g.dims[:2]), 3),
            # Read h, hu, hv once, write them once.
            bound=bound_ms(2 * cells * 4, SW_FLOPS * cells / 3, F32_FLOPS))
        del S
        nb = self.wave_blocks
        g = self.grid((n, n, 1), dimx=nb, dimy=1, dimz=1, periodx=1)
        S = self.spec_state(gen, g, torch.float32, 93)
        exts, modes, shapes, ols, out, ref = self.spec_chunk(gen, g, S, K)
        for f, a, b in zip(gen.spec.fields, out, ref):
            self.note("spec_chunk_step[shallow_water]", check(
                f"spec_chunk_step[shallow_water] {f.name} {nb}x1 K={K}", a,
                b, 0.0))
        del out, ref
        E = gen.analysis.margin_after(K)
        ext_cells = float(sum(X.numel() for X in exts))
        out_cells = float(sum(A.numel() for A in S))
        # hv's frozen y planes (rows 0 and S1 of every extended block), read
        # from the chunk-entry buffer on every launch.
        frozen = 2.0 * exts[2].shape[0]
        nbytes = 4 * ((K - 1) * 2 * ext_cells + ext_cells + out_cells
                      + K * frozen) / K
        flags = ce.edge_flags(modes, g)
        chunk = dict(
            kernel_time(lambda: sl.chunk_call(
                gen, exts, shapes, K=K, E=E, modes=modes, grid=g, ols=ols),
                max(k // 5, 4), "Spec_shallow_water"),
            plain_ms=event_ms(lambda: ce.window_step_plain(
                exts, exts, E=E, modes=modes, grid=g,
                core=sl.window_core(gen, g), flags=flags,
                freeze_fields=gen.analysis.freeze, ols=ols), 3),
            bound=bound_ms(nbytes, SW_FLOPS * ext_cells / 3, F32_FLOPS))
        chunk["events_ms"] /= K
        self.perf["spec_chunk_step[shallow_water]"] = chunk
        del exts, S
        for name in self.cases.SPECS_3D:
            for dtype in (torch.float32, torch.float64):
                self.spec_entry_full(name, dtype)
        for name, p, beside in (
                ("spec_step[shallow_water]", self.perf[
                    "spec_step[shallow_water]"], "wave2d_step"),
                ("spec_chunk_step[shallow_water] K=8 (E=8)", chunk,
                 "wave2d_chunk_step")):
            log(f"[phase 1] {name}: {p['ms']:.4f} ms device per launch "
                f"({p['ms_from']}), {p['events_ms']:.4f} ms per launch back "
                f"to back (events), plain {p['plain_ms']:.4f} ms"
                f"{' (one window step)' if 'chunk' in name else ''}, bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]}); hand {beside} "
                f"{self.perf[beside]['ms']:.4f} ms")

    def spec_entry_full(self, name, dtype):
        """The generated step and K=8 chunk step of the rank-3 spec `name`
        (igg_spec_step on the x-march's step and chunk modes) on one
        n_stokes^3 periodic block (the chunk 272 x 256 x 256 extended, y
        and z wrapped), in `dtype`: checked against their plain versions,
        then timed beside one plain step (the chunk: one window step), a
        pass's bound of compulsory bytes (every field read once and written
        once) and their first design in the same run (the walk,
        kernel_variants.py: spec_first_source)."""
        ce, sl = self.ce, self.sl
        m, k, K = self.n_stokes, self.time_iters, K_CHUNK
        f64 = dtype == torch.float64
        sfx = "_f64" if f64 else ""
        gen = self.spec_gen(name)
        g = self.grid((m, m, m), **SINGLE, **PERIODIC)
        S = self.spec_state(gen, g, dtype, 95)
        tag = f"{m}^3 {'f64' if f64 else 'f32'} periodic"
        exts, modes, shapes, ols, _, ref = self.spec_chunk(gen, g, S, K)
        E = gen.analysis.margin_after(K)
        want = sl.step_plain(gen, S, g.dims)
        step = lambda: sl.step_kernel(gen, S, g.dims)
        chunk = lambda: sl.chunk_call(gen, exts, shapes, K=K, E=E,
                                      modes=modes, grid=g, ols=ols)
        keys = (f"spec_step[{name}]{sfx}", f"spec_chunk_step[{name}]{sfx}")

        def checked(design):
            for f, a, b in zip(gen.spec.fields, step(), want):
                err = check(f"{keys[0]}{design} {f.name} {tag}", a, b, 0.0)
                if name == "relax3d":
                    self.note("spec_step[relax3d]", err)
            for f, a, b in zip(gen.spec.fields, chunk(), ref):
                err = check(f"{keys[1]}{design} {f.name} {tag} K={K}", a, b,
                            0.0)
                if name == "relax3d":
                    self.note("spec_chunk_step[relax3d]", err)

        checked("")
        size = 8 if f64 else 4
        rate = F64_FLOPS if f64 else F32_FLOPS
        cells, ext_cells = float(S[0].numel()), float(exts[0].numel())
        nbytes = 2.0 * size * sum(A.numel() for A in S)
        ext_bytes = 2.0 * size * sum(X.numel() for X in exts)
        flags = ce.edge_flags(modes, g)
        n_chunk = max(k // 5, 4)
        self.perf[keys[0]] = dict(
            kernel_time(step, k, "stag_xmarch_kernel"),
            plain_ms=event_ms(lambda: sl.step_plain(gen, S, g.dims), 3),
            bound=bound_ms(nbytes, SPEC_FLOPS[name] * cells, rate))
        self.perf[keys[1]] = dict(
            kernel_time(chunk, n_chunk, "stag_xmarch_kernel", launches=K),
            plain_ms=event_ms(lambda: ce.window_step_plain(
                exts, exts, E=E, modes=modes, grid=g,
                core=sl.window_core(gen, g), flags=flags,
                freeze_fields=gen.analysis.freeze, ols=ols), 3),
            # A pass: the extended blocks read once and written once.
            bound=bound_ms(ext_bytes, SPEC_FLOPS[name] * ext_cells, rate))
        self.perf[keys[1]]["events_ms"] /= K
        real = sl.generated_library
        sl.generated_library = lambda source, t: self.first_gen[name]
        try:
            checked(" first design")
            self.perf[f"{keys[0]}_first_design"] = kernel_time(
                step, k, "stagger_xyz_kernel")
            q = self.perf[f"{keys[1]}_first_design"] = kernel_time(
                chunk, n_chunk, "stagger_xyz_kernel", launches=K)
            q["events_ms"] /= K
        finally:
            sl.generated_library = real
        for key, what in zip(keys, ("", f" K={K} (E={E})")):
            p, q = self.perf[key], self.perf[f"{key}_first_design"]
            log(f"[phase 1] {key}{what} at {tag}: {p['ms']:.4f} ms device "
                f"per launch ({p['ms_from']}), {p['events_ms']:.4f} ms per "
                f"launch back to back (events); its first design (the walk) "
                f"{q['ms']:.4f} ms in the same run, {q['ms'] / p['ms']:.2f} "
                f"times the march's; plain {p['plain_ms']:.4f} ms"
                f"{' (one window step)' if 'chunk' in key else ''}; bound "
                f"{p['bound'][0]:.4f} ms ({p['bound'][1]}; "
                f"{p['bound'][0] / p['ms']:.2f} of it reached)")
        del S, exts, ref, want

    def spec_plain_route(self, gen, S, steps, K):
        """The chunk route of the spec's dispatch on the kernels' plain
        versions: a warm-up step, the K-step chunks, the remainder."""
        it, ce, sl = self.it, self.ce, self.sl
        g = it.get_global_grid()
        nd = gen.spec.ndim

        def step(T):
            return it.update_halo(*sl.step_plain(gen, T, g.dims[:nd]),
                                  plain=True)

        S = step(S)
        modes = ce.dim_modes(g)[:nd]
        shapes = sl.field_shapes(gen.spec, g.nxyz[:nd])
        ols = ce.field_ols(g, shapes)
        E = gen.analysis.margin_after(K)
        for _ in range((steps - 1) // K):
            exts = ce.extend_fields(list(S), ols, E, g, modes)
            S = tuple(ce.central_window(U, s, E, modes) for U, s in zip(
                sl.chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=g,
                               ols=ols), shapes))
        for _ in range((steps - 1) % K):
            S = step(S)
        return tuple(S)

    def sw_routes(self, tag, S, steps, p, exact):
        """`steps` shallow-water steps of `S` on the dispatch (the chunk
        route), on the per-step route, on the plain chunk route and on the
        plain path.  The chunk route equals the plain chunk route bitwise,
        and the per-step route the plain path; the two routes agree within
        2e-5 of each field's scale, bitwise where `exact`.  Returns the
        chunk route's state, its error against the per-step route, the
        chunk launches it made and its peak device memory beyond what was
        held before."""
        sw, sl, ops = self.sw, self.sl, self.ops
        gen = self.cuda.kernels_for(sw.spec(p), p.coeffs())
        before = ops.launch_counts()["spec_chunk_step"]
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        Sc = sw.make_step(p, n_inner=steps)(*S)
        sync(self.dev)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = ops.launch_counts()["spec_chunk_step"] - before
        if launched != (steps - 1) // K_CHUNK * K_CHUNK:
            raise SmokeFailure(f"{tag}: {launched} chunk launches in {steps} "
                               f"steps")
        Sp = sl.fused_spec_steps(gen, S, n_inner=steps, chunk=False)
        plain = sw.make_step(p, n_inner=steps, use_kernels=False)(*S)
        for name, a, b in zip(("h", "hu", "hv"), Sp, plain):
            check(f"{tag}: per-step route vs plain path, {name}", a, b, 0.0)
        del plain
        pc = self.spec_plain_route(gen, S, steps, K_CHUNK)
        for name, a, b in zip(("h", "hu", "hv"), Sc, pc):
            check(f"{tag}: chunk route vs plain chunk route, {name}", a, b,
                  0.0)
        del pc
        err = 0.0
        for name, a, b in zip(("h", "hu", "hv"), Sc, Sp):
            scale = float(b.abs().max())
            e = check(f"{tag}: chunk route vs per-step route, {name}", a, b,
                      0.0 if exact else 2e-5 * scale)
            err = max(err, e / (scale + 1e-30))
        if not all(bool(torch.isfinite(A).all()) for A in Sc):
            raise SmokeFailure(f"{tag}: non-finite fields")
        return Sc, err, peak_gb, held_gb

    def sw_fresh(self, p):
        """`init_fields` with its halos updated: an overlap-consistent
        state."""
        return self.it.update_halo(*self.sw.init_fields(p))

    def shallow_water_one_block(self):
        """Phase 14: shallow water at n_wave^2 f32, periodic, one block:
        the routes against each other over 10 steps, `run()` (the chunk
        route: x extended, y wrapped in the kernel), mass conservation,
        ms/step of both routes and launches per call."""
        it, sw, sl = self.it, self.sw, self.sl
        n = self.n_wave
        tag = f"shallow_water {n}^2 periodic"
        self.grid((n, n, 1), dimx=1, dimy=1, dimz=1, periodx=1, periody=1)
        p = sw.Params()
        S = self.sw_fresh(p)
        _, err, _, _ = self.sw_routes(tag, S, 10, p, exact=True)
        m0 = sw.mass(sw.init_fields(p)[0])
        S1, sec = sw.run(self.nt, p, dtype=torch.float32, n_inner=self.n_inner)
        n1 = max(1, self.nt // 4)
        steps = (1 + n1 + max(self.nt - n1, n1 + 1)) * self.n_inner
        if not all(bool(torch.isfinite(A).all()) for A in S1):
            raise SmokeFailure(f"{tag}: run() gave non-finite fields")
        m1 = sw.mass(S1[0])
        drift = abs(m1 - m0) / abs(m0)
        # igg's periodic continuity bound (tests/test_stencil.py).
        if not drift < 1e-6:
            raise SmokeFailure(f"{tag}: mass {m0:.9e} -> {m1:.9e}")
        moved = float((S1[0] - S[0]).abs().max())
        if not moved > 0:
            raise SmokeFailure(f"{tag}: h did not change in {steps} steps")
        del S1
        gen = self.cuda.kernels_for(sw.spec(p), p.coeffs())
        one = lambda *T: sl.fused_spec_step(gen, T)
        _, sec_ps = it.time_steps(one, S, n1=10, n2=40, warmup=2)
        split_ps, n_ps = device_ms_by_kernel(lambda: one(*S), 10)
        chunked = sw.make_step(p, n_inner=self.n_inner)
        split_chunk, n_chunk = device_ms_by_kernel(lambda: chunked(*S), 2)
        log(f"[phase 14] {tag}: 10 steps, chunk route vs per-step route, "
            f"per-step route vs plain path, chunk route vs plain chunk route: "
            f"bitwise; run() {steps} steps, mass {m0:.9e} -> {m1:.9e} "
            f"(drift {drift:.3e}, bound 1e-6), max |h change| {moved:.4e}")
        log(f"[phase 14] {tag}: chunk route make_step(n_inner="
            f"{self.n_inner}) {sec * 1e3:.4f} ms/step; per-step route "
            f"{sec_ps * 1e3:.4f} ms/step")
        log(f"[phase 14] {tag}: chunk route, one call of {self.n_inner} "
            f"steps: {n_chunk:.0f} launches, device "
            f"{sum(split_chunk.values()):.4f} ms {json.dumps(split_chunk)}")
        log(f"[phase 14] {tag}: per-step route, one step: {n_ps:.0f} "
            f"launches, device {sum(split_ps.values()):.4f} ms "
            f"{json.dumps(split_ps)}")
        self.perf[f"shallow_water_{n}^2_periodic"] = dict(
            chunk_route_ms_per_step=sec * 1e3,
            per_step_route_ms_per_step=sec_ps * 1e3,
            chunk_route_device_ms_per_call=split_chunk,
            chunk_route_launches_per_call=n_chunk,
            per_step_route_device_ms_per_step=split_ps,
            per_step_route_launches_per_step=n_ps, mass=(m0, m1))

    def shallow_water_config3(self):
        """Phase 15: shallow water on wave_blocks x 1 blocks of n_wave^2,
        x periodic and y open (config 3's 1-D periodic halo; the chunk
        re-freezes hv's y planes in "frozen" mode), stacked on one card: 17
        steps on both routes, ms/step, device time split by kernel,
        launches per call, peak device memory."""
        it, sw, sl = self.it, self.sw, self.sl
        n, nb, steps = self.n_wave, self.wave_blocks, self.steps_multi
        self.grid((n, n, 1), dimx=nb, dimy=1, dimz=1, periodx=1)
        size = (it.nx_g(), it.ny_g())
        tag = (f"shallow_water {size[0]}x{size[1]} x-periodic y-open "
               f"({nb}x1 x {n}^2)")
        p = sw.Params()
        S = self.sw_fresh(p)
        Sc, err, peak_gb, held_gb = self.sw_routes(tag, S, steps, p,
                                                   exact=False)
        del Sc
        chunked = sw.make_step(p, n_inner=steps)
        split_chunk, n_chunk = device_ms_by_kernel(lambda: chunked(*S), 3)
        S1, sec = sw.run(self.nt_multi, p, dtype=torch.float32, n_inner=steps)
        if not all(bool(torch.isfinite(A).all()) for A in S1):
            raise SmokeFailure(f"{tag}: run() gave non-finite fields")
        del S1
        gen = self.cuda.kernels_for(sw.spec(p), p.coeffs())
        one = lambda *T: sl.fused_spec_step(gen, T)
        _, sec_ps = it.time_steps(one, S, n1=10, n2=40, warmup=2)
        split_ps, n_ps = device_ms_by_kernel(lambda: one(*S), 10)
        log(f"[phase 15] {tag}: {steps} steps, chunk route vs plain chunk "
            f"route and per-step route vs plain path bitwise; chunk route vs "
            f"per-step route {err:.3e} of each field's scale (bound 2e-5"
            f"{', bitwise' if err == 0 else ''}); peak device memory of the "
            f"chunk route {peak_gb:.3f} GB, of which {held_gb:.3f} GB held "
            f"before the call (h, hu, hv)")
        log(f"[phase 15] {tag}: chunk route make_step(n_inner={steps}) "
            f"{sec * 1e3:.4f} ms/step; per-step route {sec_ps * 1e3:.4f} "
            f"ms/step")
        log(f"[phase 15] {tag}: chunk route, one call of {steps} steps: "
            f"{n_chunk:.0f} launches, device {sum(split_chunk.values()):.4f} "
            f"ms {json.dumps(split_chunk)}")
        log(f"[phase 15] {tag}: per-step route, one step: {n_ps:.0f} "
            f"launches, device {sum(split_ps.values()):.4f} ms "
            f"{json.dumps(split_ps)}")
        self.perf[f"shallow_water_{size[0]}x{size[1]}_config3_{nb}x1"] = dict(
            chunk_route_ms_per_step=sec * 1e3,
            per_step_route_ms_per_step=sec_ps * 1e3,
            chunk_vs_per_step_rel_err=err,
            chunk_route_device_ms_per_call=split_chunk,
            chunk_route_launches_per_call=n_chunk,
            per_step_route_device_ms_per_step=split_ps,
            per_step_route_launches_per_step=n_ps,
            peak_gb=peak_gb, held_gb=held_gb)

    def banded_route(self, phase, family, one_block: bool):
        """The banded tier of `family` through `make_multi_step(steps,
        banded=True, K=8, band=8)` against the route the dispatch takes
        without it (the K-step loop on one block, the chunk route on 2x2x2
        blocks), bitwise, from `update_halo(*init_fields())`; then ms/step
        through `run()`, launches and device time per call, peak device
        memory."""
        it = self.it
        n, steps, K, B = self.n_multi, self.steps_multi, K_CHUNK, 8
        model = self.t3 if family == "diffusion" else self.h3
        per = PERIODIC if (one_block or family == "hm3d") else {}
        if one_block:
            self.grid((n, n, n), **SINGLE, **per)
            tag = f"{family} {n}^3 periodic one block"
        else:
            self.grid((n, n, n), dimx=2, dimy=2, dimz=2, **per)
            size = it.nx_g()
            tag = (f"{family} {size}^3 {'periodic' if per else 'open'} "
                   f"(2x2x2 x {n}^3)")
        p = model.Params()
        state = it.update_halo(*model.init_fields(p))
        banded = model.make_multi_step(steps, p, banded=True, K=K, band=B)
        fields = ((lambda out: (out,)) if family == "diffusion"
                  else (lambda out: out))
        name = f"{family}_band_step"
        before = self.ops.launch_counts()[name]
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        got = fields(banded(*state))
        sync(self.dev)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = self.ops.launch_counts()[name] - before
        if launched != (steps - 1) // K * K:
            raise SmokeFailure(f"{tag}: {launched} band launches in {steps} "
                               f"steps")
        want = fields(model.make_multi_step(steps, p)(*state))
        route = "K-step loop" if one_block else "chunk route"
        err = max(check(f"{tag}: banded route vs {route}, field {f}", a, b,
                        0.0) for f, (a, b) in enumerate(zip(got, want)))
        if not all(bool(torch.isfinite(a).all()) for a in got):
            raise SmokeFailure(f"{tag}: non-finite values")
        del got, want
        split, n_call = device_ms_by_kernel(lambda: banded(*state), 3)
        out, sec = model.run(self.nt_multi, p, dtype=torch.float32,
                             n_inner=steps, banded=True, K=K, band=B)
        if not all(bool(torch.isfinite(a).all()) for a in fields(out)):
            raise SmokeFailure(f"{tag}: run() gave non-finite values")
        del out
        log(f"[phase {phase}] {tag}: {steps} steps on the banded route "
            f"(K={K}, B={B}) vs the {route} {err:.3e} (tolerance 0); peak "
            f"device memory {peak_gb:.3f} GB, of which {held_gb:.3f} GB held "
            f"before the call")
        log(f"[phase {phase}] {tag}: banded route make_multi_step({steps}) "
            f"{sec * 1e3:.4f} ms/step; one call: {n_call:.0f} launches, "
            f"device {sum(split.values()):.4f} ms {json.dumps(split)}")
        self.perf[f"banded_{tag}"] = dict(
            ms_per_step=sec * 1e3, device_ms_per_call=split,
            launches_per_call=n_call, peak_gb=peak_gb, held_gb=held_gb)

    def diffusion_banded(self):
        """Phase 16: the diffusion banded tier, one block and 510^3."""
        self.banded_route(16, "diffusion", one_block=True)
        self.banded_route(16, "diffusion", one_block=False)

    def hm3d_banded(self):
        """Phase 17: the HM3D banded tier, one block and 508^3."""
        self.banded_route(17, "hm3d", one_block=True)
        self.banded_route(17, "hm3d", one_block=False)

    def stokes_banded(self, phase, one_block: bool):
        """stokes3d on the banded tier: `make_iteration(n_inner=steps,
        banded=True, K=8, band=8)` (a warm-up iteration, two chunks of 8
        band launches) against the chunk route, bitwise, from
        `update_halo(*init_fields())` evolved by `steps` iterations of the
        chunk route (the fluid moving, not at rest); then both routes
        through `run()` over one trajectory (`steps` iterations a call,
        `nt_multi` timed calls from `init_fields`; zero dividends take the
        division's slow path), launches and device time per call split by
        kernel, peak device memory."""
        it, st3 = self.it, self.st3
        n, steps, K, B = self.n_multi, self.steps_multi, K_CHUNK, 8
        if one_block:
            self.grid((n, n, n), **SINGLE, **PERIODIC, **OL3)
            tag = f"Stokes {n}^3 periodic one block"
        else:
            self.grid((n, n, n), dimx=2, dimy=2, dimz=2, **OL3)
            tag = f"Stokes {it.nx_g()}^3 open (2x2x2 x {n}^3)"
        p = st3.Params()
        *V, Rho = it.update_halo(*st3.init_fields(p))
        chunk = st3.make_iteration(p, n_inner=steps)
        V = chunk(*V, Rho)
        banded = st3.make_iteration(p, n_inner=steps, banded=True, K=K,
                                    band=B)
        before = self.ops.launch_counts()["stokes_band_step"]
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        got = banded(*V, Rho)
        sync(self.dev)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = self.ops.launch_counts()["stokes_band_step"] - before
        if launched != (steps - 1) // K * K:
            raise SmokeFailure(f"{tag}: {launched} band launches in {steps} "
                               f"iterations")
        err = max(check(f"{tag}: banded route vs chunk route, {name}", a, b,
                        0.0)
                  for name, a, b in zip(STOKES_NAMES, got, chunk(*V, Rho)))
        self.stokes_state_check(tag, got)
        del got
        split, n_call = device_ms_by_kernel(lambda: banded(*V, Rho), 3)
        del V, Rho
        # run() gives seconds per iteration.
        S1, sec = st3.run(self.nt_multi, p, n_inner=steps, banded=True, K=K,
                          band=B)
        self.stokes_state_check(f"{tag} run(banded=True)", S1[:4])
        S2, sec_c = st3.run(self.nt_multi, p, n_inner=steps)
        same = all(torch.equal(a, b) for a, b in zip(S1, S2))
        del S1, S2
        iters = (3 + self.nt_multi) * steps
        log(f"[phase {phase}] {tag}: {steps} iterations on the banded route "
            f"(K={K}, B={B}) vs the chunk route {err:.3e} (tolerance 0); peak "
            f"device memory {peak_gb:.3f} GB, of which {held_gb:.3f} GB held "
            f"before the call (P, Vx, Vy, Vz, Rho)")
        log(f"[phase {phase}] {tag}: through run() over the same {iters} "
            f"iterations: banded route {sec * 1e3:.4f} ms/iteration, "
            f"chunk route {sec_c * 1e3:.4f} ms/iteration (end states "
            f"{'equal' if same else 'differ'}); banded route, one call: "
            f"{n_call:.0f} launches, device {sum(split.values()):.4f} ms "
            f"{json.dumps(split)}")
        self.perf[f"banded_{tag}"] = dict(
            ms_per_iteration=sec * 1e3,
            chunk_route_ms_per_iteration=sec_c * 1e3,
            iterations_timed=iters, device_ms_per_call=split,
            launches_per_call=n_call, peak_gb=peak_gb, held_gb=held_gb)

    def relax3d_banded(self):
        """Phase 20: relax3d on one n_stokes^3 periodic block through
        `compile(n_inner=steps, banded=True, K=8, band=8)` against the
        spec chunk route (`compile(n_inner=steps)`), bitwise, from random
        fields whose halos are updated; then both slope-timed over the same
        calls, launches and device time per call."""
        it, sl = self.it, self.sl
        n, steps, K, B = self.n_stokes, self.steps_multi, K_CHUNK, 8
        gen = self.spec_gen("relax3d")
        g = self.spec_grid("relax3d", "1x1x1_periodic", (n, n, n))
        tag = f"relax3d {n}^3 periodic one block"
        S = (it.update_halo(self.spec_state(gen, g, torch.float32, 97)[0]),)
        banded = it.stencil.compile(gen.spec, coeffs=gen.coeffs,
                                    n_inner=steps, banded=True, K=K, band=B)
        chunk = it.stencil.compile(gen.spec, coeffs=gen.coeffs,
                                   n_inner=steps)
        before = self.ops.launch_counts()["spec_band_step"]
        got = banded(*S)
        sync(self.dev)
        launched = self.ops.launch_counts()["spec_band_step"] - before
        if launched != (steps - 1) // K * K:
            raise SmokeFailure(f"{tag}: {launched} band launches in {steps} "
                               f"steps")
        err = check(f"{tag}: banded route vs chunk route", got[0],
                    chunk(*S)[0], 0.0)
        if not bool(torch.isfinite(got[0]).all()):
            raise SmokeFailure(f"{tag}: non-finite values")
        del got
        split, n_call = device_ms_by_kernel(lambda: banded(*S), 3)
        n1 = max(1, self.nt_multi // 4)
        _, sec = it.time_steps(banded, S, n1=n1, n2=self.nt_multi - n1)
        _, sec_c = it.time_steps(chunk, S, n1=n1, n2=self.nt_multi - n1)
        log(f"[phase 20] {tag}: {steps} steps on the banded route (K={K}, "
            f"B={B}) vs the chunk route {err:.3e} (tolerance 0); banded "
            f"route {sec / steps * 1e3:.4f} ms/step, chunk route "
            f"{sec_c / steps * 1e3:.4f} ms/step; banded route, one call: "
            f"{n_call:.0f} launches, device {sum(split.values()):.4f} ms "
            f"{json.dumps(split)}")
        self.perf[f"banded_{tag}"] = dict(
            ms_per_step=sec / steps * 1e3,
            chunk_route_ms_per_step=sec_c / steps * 1e3,
            device_ms_per_call=split, launches_per_call=n_call)

    def main_path(self):
        """Phases 2 to 20, each with the launch counters set to 0 just
        before it and read just after it; the counts add up over the
        phases."""
        n, m = self.n_head, self.n_multi
        phases = [
            ("2", lambda: self.headline(n, periodic=True)),
            ("3", lambda: self.headline(self.n_open, periodic=False)),
            ("4", self.recv_mode),
            ("5", lambda: self.standalone_halo(5, (n, n, n), **SINGLE,
                                               **PERIODIC)),
            ("6", self.headline_510),
            ("7", lambda: self.standalone_halo(7, (m, m, m), dimx=2, dimy=2,
                                               dimz=2)),
            ("8", self.hm3d_one_block), ("9", self.hm3d_508),
            ("10", self.wave2d_one_block), ("11", self.wave2d_multiblock),
            ("12", self.stokes_one_block), ("13", self.stokes_509),
            ("14", self.shallow_water_one_block),
            ("15", self.shallow_water_config3),
            ("16", self.diffusion_banded), ("17", self.hm3d_banded),
            ("18", lambda: self.stokes_banded(18, one_block=True)),
            ("19", lambda: self.stokes_banded(19, one_block=False)),
            ("20", self.relax3d_banded)]
        self.launches, self.phase_launches = {}, {}
        for phase, run in phases:
            self.ops.reset_launch_counts()
            run()
            counts = self.phase_launches[phase] = self.ops.launch_counts()
            for name, v in counts.items():
                self.launches[name] = self.launches.get(name, 0) + v
            log(f"[main path] phase {phase} launches "
                f"{json.dumps({k: v for k, v in counts.items() if v})}")
        log(f"[main path] launches {json.dumps(self.launches)}")
        missing = [k for k, v in self.launches.items() if v <= 0]
        missing += [k for k in KERNEL_INFO if self.instance_launches(k) <= 0]
        if missing:
            raise SmokeFailure(f"kernels not launched on the main path: {missing}")
        if self.it.grid_is_initialized():
            self.it.finalize_global_grid()

    def instance_launches(self, name) -> int:
        """The main path's launches of kernel `name` (KERNEL_INFO): its
        counter's, over the phases its `phases` names ("20", or "not 20")
        or all of them."""
        info = KERNEL_INFO[name]
        counter = info.get("counter", name)
        only = info.get("phases")
        if only is None:
            return int(self.launches[counter])
        own = int(self.phase_launches[only.split()[-1]].get(counter, 0))
        return int(self.launches[counter]) - own if only.startswith("not") \
            else own

    def summary(self):
        out = []
        for name, info in KERNEL_INFO.items():
            p = self.perf[name]
            out.append(dict(
                name=name, route="cuda", source=info["source"],
                replaces=info["replaces"],
                launches=self.instance_launches(name),
                max_abs_err=self.err[name], ms=p["ms"], plain_ms=p["plain_ms"],
                bound_ms=p["bound"][0], bound_by=p["bound"][1],
                # Only the packer's function is one PyTorch call (an
                # index_select per plane); none computes the others (no
                # PyTorch call computes a diffusion, an HM3D or a leapfrog
                # step, a Stokes iteration, a spec's step or a banded
                # iteration).
                library_ms=p.get("library_ms")))
        return {"kernels": out}


# The redesigned kernels whose first designs (kernel_variants.py:
# FIRST_DESIGNS) phase 1 times beside them in the same run.
FIRST_DESIGN_LIBS = ("stokes_band", "hm3d_band", "hm3d_chunk",
                     "diffusion_band", "stokes_step", "hm3d_step",
                     "halo_write")


def start_first_designs(gens=()):
    """Start one nvcc for each first design of FIRST_DESIGN_LIBS and for the
    first designs of both entries of each generated rank-3 library in
    `gens` (kernel_variants.py: spec_first_source, keyed `gen:<tag>`), its
    text written beside the first designs' policies (kernel_variants.py:
    FIRST_HEADERS, which the sources' quoted includes find before the
    kernels' headers) under igg_torch/_build/first/<key>/, keyed by the
    texts and the headers; returns the jobs."""
    import kernel_variants
    from igg_torch.ops import _build

    heads = [_build._read(h) for h in _build._headers()]
    key = _build._key([t.encode() for t in
                       kernel_variants.FIRST_HEADERS.values()] + heads)
    where = os.path.join(_build.BUILD_DIR, "first", key)
    os.makedirs(where, exist_ok=True)
    for name, text in kernel_variants.FIRST_HEADERS.items():
        with open(os.path.join(where, name), "w") as f:
            f.write(text)
    texts = {lib: kernel_variants.FIRST_DESIGNS[f"{lib}.cu"]
             for lib in FIRST_DESIGN_LIBS}
    texts.update({f"gen:{g.tag}": kernel_variants.spec_first_source(g)
                  for g in gens})
    jobs = {}
    for lib, text in texts.items():
        src = os.path.join(where, f"{lib.replace(':', '_')}-"
                                  f"{_build._key([text.encode()] + heads)}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = src[:-len(".cu")] + ".so"
        jobs[lib] = (_build._start_nvcc(src, so), so)
    return jobs


def finish_first_designs(jobs):
    """Wait for the first designs' builds; returns {library name: CDLL}
    with the entry point typed as the library's own."""
    from igg_torch.ops import _build

    from igg_torch.stencil import cuda

    libs = {}
    for lib, (job, so) in jobs.items():
        report = _build._finish(f"{lib} (first design)", job)
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {lib} first design] {line.strip()}")
        libs[lib] = ctypes.CDLL(so)
        names = ([(n, cuda.ARGTYPES) for n in (cuda.ENTRY, cuda.BAND_ENTRY)]
                 if lib.startswith("gen:") else [_build.SIGNATURES[lib]])
        for fn_name, argtypes in names:
            fn = getattr(libs[lib], fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return libs


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from igg_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    card = card_line()
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_spec_cases as cases

    t0 = time.perf_counter()
    # The kernels' sources and the sources generated from the specs of the
    # checks, one nvcc each, all started together.
    generated = [cases.kernels(name) for name in cases.SPECS]
    first = start_first_designs([cases.kernels(n) for n in cases.SPECS_3D])
    reports = _build.build_all(generated=[(g.source, g.tag)
                                          for g in generated])
    first = finish_first_designs(first)
    log(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(and the first designs of {sorted(first)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    smoke = Smoke(torch.device("cuda"))
    smoke.first = first
    smoke.first_gen = {n: first[f"gen:{cases.kernels(n).tag}"]
                       for n in cases.SPECS_3D}
    t0 = time.perf_counter()
    smoke.kernel_checks()
    log(f"[phase 1] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    smoke.main_path()
    log(f"[main path] done in {time.perf_counter() - t0:.1f} s")
    log(f"[run] {time.perf_counter() - start:.1f} s")
    log(json.dumps({"perf": smoke.perf}))
    log(json.dumps(smoke.summary()))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
