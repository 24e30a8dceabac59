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
21. Observability and verified dispatch, inside one `igg_torch.telemetry`
   session and one `igg_torch.profiling.trace`: phase 2's
   `make_multi_step(100, verify="first_use")` verifies `diffusion3d.cuda`
   against `diffusion3d.plain` in one span, bitwise the unverified route,
   with the dispatch counter and `igg_halo_plane_bytes_total` against
   their counts; one verified call of every other family's main route at
   its one-block shape (HM3D 256^3, wave2d and shallow water 4096^2,
   Stokes 256^3, relax3d 256^3 on its chunk and banded routes); a tier of
   the diffusion kernel route with one cell changed after it must raise
   GridError and serve nothing; ten calls under
   `torch.cuda.set_sync_debug_mode("warn")` with the session and spans
   on give as many sync warnings as ten with telemetry off; the
   profiler's trace holds the spans beside the step kernel's launches.
   Then phase 2's ms/step without and with the session, in turns,
   `make_step`'s wall per call through the ladder and through its kernel
   tier's callable, in turns, the halo byte counter's host time per
   `update_halo` call, and the first verified call's wall time beside a
   warm call's.
22. Checkpoint at the 510^3 headline (phase 6's grid): two calls of
   `make_multi_step(17)`, `save_checkpoint_sharded` of T and Cp (1.07 GB)
   into a `tempfile.TemporaryDirectory()`, two calls launched right after
   it; `load_checkpoint` gives the saved state in fresh tensors on the
   card and two calls from it equal the uninterrupted run bitwise;
   `verify_checkpoint` passes, and refuses a copy with one byte of a
   shard flipped, which `latest_checkpoint` skips; the flat format
   round-trips bitwise; then the generation restored onto (1, 2, 4)
   blocks of 510 x 256 x 129 (`redistribute=True`) and run two calls has
   the uninterrupted run's `gather_interior` bitwise, and each grid's
   serving tier is logged.  Printed: the save's wall and GB/s split into
   device-to-host copy, deep stats and CRC32, and file writes, beside one
   `copy_` of the payload into pinned memory; load, elastic load, verify,
   flat save and load; the host's traced peak during the save and the
   elastic load beside one block set (and the pinned buffer), which
   bound it with a slab; the device's memory above the fields during the
   save beside one block.  Then, on phase 2's 256^3 periodic block, a
   `igg_torch.vis.BackgroundRenderer` gets T after every call of
   `make_multi_step(17)` and reduces each frame to a CRC32 on its thread:
   every frame equals the synchronous frame of the same step.  Printed:
   one frame's host time alone, and ms a call in turns without frames,
   with the frames taken in series (the synchronous loop) and with the
   worker; then the same with a frame every k calls, k the frame's time
   over a call's, where overlap shows as the worker's run near the
   larger of the two and the series' near their sum.
23. The resilient loop and chaos (`igg_torch.run_resilient`,
   `igg_torch.chaos`), each run's events logged: (a) phase 6's grid from
   `update_halo(*init_fields())`, `make_multi_step(17)` (the chunk route)
   over a dict of T and Cp, 340 steps, `steps_per_call=17`,
   `watch_every=34`, `checkpoint_every=102`, `ring=2`, sharded and
   asynchronous generations in a `tempfile.TemporaryDirectory()`, against
   an uninterrupted run kept on the card: `ChaosPlan(nan_at=[(120,
   "T")])` gives one detection at a probe step in (120, 290], one
   rollback to a step at or below 102, one retry, the end bitwise the
   reference; `ChaosPlan(preempt_at=238)` preempts at 238 and a fresh
   `run_resilient(resume=True)` ends bitwise the reference; every call is
   served by `diffusion3d.cuda`.  (b) Phase 4's open (2,2,1) grid,
   `make_step`, 30 steps: `chaos.halo_corruption()`, disarmed by the
   recovery policy, is detected, rolled back once and ends bitwise the
   clean run.  (c) Phase 2's 256^3 periodic block:
   `chaos.kernel_corrupt("diffusion3d.cuda")` recurs at the same step
   after the rollback and raises `ResilienceError` naming the tier and
   `diffusion3d.plain`; nothing is quarantined.  Quarantined by hand, the
   tier's next dispatch raises `GridError` naming it instead of serving
   `diffusion3d.plain`.  (d) Printed with the
   card's name and power limit: the watchdog probe's device time at 510^3
   and 256^3 (profiler); ms/step of the bare loop against
   `run_resilient` with no ring, in turns, at 256^3 (`make_multi_step`,
   `watch_every=340`) and 128^3 (`make_step`, `watch_every=50`, T
   watched: igg's < 2% contract row); at 510^3 each cadence submit's hold
   on the loop beside a synchronous generation (igg's < 10% contract);
   sync warnings of `run_resilient` under `set_sync_debug_mode("warn")`
   over 10 and 20 watch windows.  A missed contract is printed, not
   raised.  Phase 23 must launch rows 1, 3, 4 and 5 of PERF.md's table
   (the fused step, the halo writer, the plane packer, the chunk step).
24. Comm/compute overlap (`igg_torch.hide_communication`: the boundary
   slabs, their plane extraction and the exchange on a side CUDA stream,
   the full compute on the caller's stream, the halo writer's assembly):
   (a) BASELINE config 5, phase 13's grid (stokes3d 509^3 open on 2x2x2
   blocks of 256^3, overlap 3, f32, from `update_halo(*init_fields())`):
   `make_iteration(n_inner=17, use_kernels=False, overlap=True)` bitwise
   `overlap=False`, served by `stokes3d.overlap`, with the halo writer's
   and the packer's launches counted; (b) phase 6's grid (diffusion 510^3
   open): `make_multi_step(17, use_kernels=False, overlap=True)` bitwise
   `overlap=False`, served by `diffusion3d.overlap`, beside phase 6's
   kernel routes; each with ms per iteration or step of both, in turns,
   and (c) from `torch.profiler`'s kernel events with their stream ids,
   the side stream's kernel time, the share of it that ran while a kernel
   of the caller's stream ran, and the time the caller's stream waited at
   the joins; (d) at (b)'s grid ten overlapped one-step calls under
   `set_sync_debug_mode("warn")` give as many sync warnings as ten
   sequential ones, and twenty chained overlapped calls whose results
   are dropped at once equal twenty whose results are kept; with
   `IGG_OVERLAP=1` and `overlap="auto"` on phase 2's one block, the
   admission log holds igg's "single-device mesh" reason and
   `diffusion3d.plain` serves.  Every number beside the card's name and
   power limit.
25. The perf ledger and the autotuner (`igg_torch.perf`,
   `igg_torch.autotune`), with the ledger and the tuning cache in a
   temporary directory, last so no earlier phase sees a winner: (a)
   `autotune.search(n_inner=17)` on phase 6's 510^3 grid, phase 12's
   256^3 periodic Stokes block, phase 15's shallow-water grid and phase
   10's 4096^2 wave2d block, every candidate's label, quick sample,
   slope-timed ms/step and cutoff logged, and the winner; (b) the cache
   saved, `reset()`, loaded: each factory built with `tune="auto"` serves
   the winner's tier with no search dispatch, bitwise the factory pinned
   to the winner with `tune=False`, and `tune=False` serves today's rule;
   (c) `perf.best` of each family, `igg_achieved_gbps` and
   `igg_pct_hbm_peak` of each non-chunk winner (above 100% fails), the
   Stokes winner and today's rule timed again from the state after 1100
   iterations (the search times from the state at rest), one
   `cost_model_drift` from a second `calibrate` under
   `chaos.stale_calibration` at ten times the first one's measurement,
   and a 20-window `run_resilient` over
   phase 6's chunk route whose windows the ledger credits to
   `diffusion3d.cuda`, with no more sync warnings than with `IGG_PERF=0`.
   An overlapped winner is kept only where the in-search decomposition
   confirms it; every `overlap_demoted` record is logged with its times.
26. Comm observability (`igg_torch.comm`), each number beside the card's
   name and power limit: (a) `calibrate_comm` on a seeded field of phase
   7's grid (2x2x2 blocks of 256^3) and of phase 5's 256^3 periodic
   block, f32 and f64: us per update and `igg_halo_gbps` beside phases 5
   and 7's `update_halo` us, the counter's delta over one `update_halo`
   equal to `plane_bytes_model`, no `igg_pct_link_peak` (no byte crosses
   a process), and the calibrated field bitwise `update_halo(plain=True)`
   of the same input; (b) `decompose` of diffusion at phase 6's 510^3
   grid and of Stokes at phase 13's 509^3 grid (config 5): the three
   variant times, the exposed fraction and the overlap efficiency beside
   phase 24's sequential and overlapped ms, after one iteration of each
   variant checked bitwise (exchange = compute and `update_halo(plain=
   True)`, hidden = exchange); (c) `autotune._overlap_confirmed(
   "diffusion3d")` at 510^3: its verdict and its
   `overlap.diffusion3d.overlap.*` ledger entries, and phase 25's
   demotions; (d) `run_resilient` over phase 23's 256^3 chunk route with
   and without `comm=StepDecomposition(...)`, in turns: the final states
   bitwise equal, at least 3 `comm_stats` windows, ms/step of each; ten
   windows each way under `set_sync_debug_mode("warn")` with equal
   sync-warning counts; (e) with `IGG_COMM_STALL_TIMEOUT=0.5` under
   `chaos.collective_stall()`, exactly one `collective_stall`, a
   `stall_r0.json` and a flight dump, the run bitwise the uninterrupted
   one; a healthy run at the default timeout without a stall; ms/step of
   `run_resilient` at 128^3 `make_step`, `watch_every=50`, with the
   heartbeat off and on, in turns, and the heartbeat's own host work
   timed alone (a watch and a fetch a probe, a thread start and join a
   run) as a share of a window (igg's < 1% `comm_overhead` row, printed,
   not raised); (f) `chaos.straggler(factor=4, after=16)` over
   a watched run: the `step_stats` windows read after the 16th grant
   (a granted poll of a probe the card has not finished reads it not
   ready, so about two grants go to a healthy fetch) against those
   before.  Phase 26 must launch rows 3 and 4 (the halo writer and
   the plane packer).
27. Numeric integrity (`igg_torch.integrity`, `run_resilient(integrity=)`,
   `chaos.silent_corruption`), each number beside the card's name and
   power limit: (a) diffusion on 2x2x2 blocks of 256^3, periodic (508^3),
   uniform heat capacity, `make_multi_step(17)` (the route it picks
   there), 170 steps, `watch_every=34`, `checkpoint_every=102`, `ring=2`,
   `IntegrityConfig(check_every=0)`: `silent_corruption("T", step=80,
   rank=3)` by 1e-2 of sum|T| gives no `nan_detected`, one
   `integrity_violation` on `total_heat` at the probe of step 102 naming
   block 3, a rollback to the newest deep-verified generation older than
   102, `integrity_resolved`, and the whole T bitwise the uninterrupted
   run; the plain, steady and anchor probes' device time; sum(T)'s own
   drift with `init_fields`' non-uniform Cp. (b) The same at 510^3 open,
   where no invariant matches, with `check_every=1`: caught with
   `source="shadow"`; the wide probe's device time. The launch counters
   are read after (a) and (b): the phase raises if no row of PERF.md's
   table launched and prints the rows that did (3-5 expected). (c) The
   newest generation of (a)'s ring, poisoned: `verify_checkpoint` passes
   it, `deep=True` refuses it, `latest_checkpoint(deep=True)` takes the
   older one; the deep verify's seconds. (d) At 128^3 `make_step`,
   `watch_every=50`: igg's `integrity_overhead` row ((steady fused probe
   - plain probe + decode) a window over 50 bare steps), the bare loop
   against `run_resilient` without integrity, with invariant probes and
   with shadows every 4 windows, in turns, and sync warnings over 10
   windows with shadows on and with integrity off (equal, or it raises);
   the rest printed, not raised.

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
x-march's step and chunk modes) at that block, f32 and f64, and the
same march's no-ring path (every read from device memory; the generated
sources built against the march with no shared memory for rings,
tests/torch_spec_cases.py: start_no_ring) against the plain versions in
every window mode, f32 and f64.  The
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
main-path phase (2 to 27) and read after it; each of the twenty kernels
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
N_OVERHEAD = 128   # igg's resilience_overhead contract row: one 128^3 block
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


def fmt_list(values) -> str:
    return "[" + ", ".join(f"{v:.4f}" for v in values) + "]"


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


def stream_split(kernels, writer="halo_write_kernel") -> dict:
    """The side stream's share of a profiler trace's kernel events
    (`cat == "kernel"`, with `args.stream`): the caller's stream is the one
    that launches the halo writer, every other one is the side stream's.
    Returns the side stream's kernel ms and launches, the share of its
    kernel time that ran while a kernel of the caller's stream ran, the
    caller's kernel ms, and the time the caller's stream waited at the
    joins: before each run of writer launches, from the end of its last
    other kernel to the end of the side stream's last kernel before the
    writer, where that is later."""
    import bisect

    streams = {e["args"]["stream"] for e in kernels}
    mains = {e["args"]["stream"] for e in kernels
             if writer in e.get("name", "")}
    if len(mains) != 1 or len(streams) < 2:
        raise SmokeFailure(f"profiler trace: {len(kernels)} kernel events "
                           f"on streams {sorted(streams)}, the halo writer "
                           f"on {sorted(mains)}: no side stream")
    main_stream = mains.pop()

    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    main = sorted(span(e) + (writer in e["name"],) for e in kernels
                  if e["args"]["stream"] == main_stream)
    side = sorted(span(e) for e in kernels
                  if e["args"]["stream"] != main_stream)
    union = []
    for a, b, _ in main:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [u[0] for u in union]
    concurrent = 0.0
    for a, b in side:
        k = max(0, bisect.bisect_right(starts, a) - 1)
        while k < len(union) and union[k][0] < b:
            concurrent += max(0.0, min(b, union[k][1]) - max(a, union[k][0]))
            k += 1
    side_us = sum(b - a for a, b in side)
    wait, joins, last_other = 0.0, 0, None
    for k, (a, b, is_writer) in enumerate(main):
        if not is_writer:
            last_other = b
            continue
        if k and main[k - 1][2]:
            continue                # the same run of writer launches
        joins += 1
        done = [e for s, e in side if s < a]
        if done and last_other is not None:
            wait += max(0.0, min(max(done), a) - last_other)
    return dict(side_ms=side_us / 1e3, side_kernels=len(side),
                main_ms=sum(b - a for a, b, _ in main) / 1e3,
                concurrent_share=concurrent / side_us if side_us else 0.0,
                join_wait_ms=wait / 1e3, joins=joins)


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
        # The generated rank-3 libraries built for the march's no-ring path,
        # {spec name: CDLL} (main()).
        self.no_ring = {}
        self.launches = None
        # The card's name and power limit (main()), beside phase 21's
        # numbers.
        self.card = ""

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
        self.spec_no_ring_checks()
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

    def spec_no_ring_checks(self):
        """The rank-3 march's no-ring path (every read from device memory,
        forced by building the generated sources with no shared memory for
        rings: torch_spec_cases.start_no_ring): the step and the K = 2, 3
        chunk steps of relax3d and acoustic3d against their plain versions
        in every window mode, f32 and f64, tiles ragged across the blocks'
        last rows included, tolerance 0."""
        sl, cases = self.sl, self.cases
        real = sl.generated_library
        n = 0
        try:
            for name in cases.SPECS_3D:
                sl.generated_library = (lambda source, tag, lib=
                                        self.no_ring[name]: lib)
                gen = self.spec_gen(name)
                for case in sorted(cases.BAND_GRIDS):
                    for local in ((10, 9, 8), (11, 19, 35)):
                        g = cases.march_grid(self.it, case, local, self.dev)
                        for dtype in (torch.float32, torch.float64):
                            S = cases.state(self.it, gen, g, dtype, 78,
                                            self.dev)
                            cases.march_step_check(gen, g, S)
                            for K in (2, 3):
                                if not cases.march_chunk_check(self.it, gen,
                                                               g, S, K):
                                    raise SmokeFailure(
                                        f"no-ring chunk {name} {case} "
                                        f"{local}: refused")
                            n += 1
        finally:
            sl.generated_library = real
        for key in ("spec_step[relax3d]", "spec_chunk_step[relax3d]"):
            self.note(key, 0.0)
        log(f"[phase 1] the rank-3 march's no-ring path: {n} layouts of "
            f"relax3d and acoustic3d, step and K = 2, 3 chunk steps, "
            f"bitwise their plain versions (tolerance 0)")

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

    # -- phase 21 ---------------------------------------------------------
    def verified(self, tag, factory, S, tier):
        """One call of `factory(verify="first_use")` on `S`: exactly one
        verification span, the output bitwise `factory()`'s, `tier`
        serving; returns (wall s of the verified call, of a warm one)."""
        from igg_torch import degrade, telemetry as tel

        def spans():
            return sum(1 for r in tel.flight_recorder() if r.kind == "span"
                       and r.payload.get("name") == "degrade.verify_first_use"
                       and r.payload.get("tier") == tier)

        before = spans()
        step = factory(verify="first_use")
        sync(self.dev)
        t0 = time.perf_counter()
        got = step(*S)
        sync(self.dev)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        step(*S)
        sync(self.dev)
        warm = time.perf_counter() - t0
        if spans() - before != 1:
            raise SmokeFailure(f"{tag}: {spans() - before} verification "
                               f"spans of {tier}, not 1")
        family = tier.rsplit(".", 1)[0]
        if degrade.active().get(family) != tier:
            raise SmokeFailure(f"{tag}: {degrade.active().get(family)} "
                               f"served, not {tier}")
        want = factory()(*S)
        outs = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        for a, b in zip(outs, wants):
            check(f"{tag}: verified route vs unverified route", a, b, 0.0)
            if not bool(torch.isfinite(a).all()):
                raise SmokeFailure(f"{tag}: non-finite output")
        return first, warm

    def observability(self):
        """Phase 21: telemetry, the profiler and the verified tier ladder
        on the card, inside one `Telemetry` session and one
        `profiling.trace`: diffusion at phase 2's shape through
        `make_multi_step(n_inner, verify="first_use")` (one verification
        span, the output bitwise the unverified route's, the dispatch and
        halo byte counters against their counts), one verified call of
        every other family's main route at its one-block phase shape, a
        corrupted tier that must raise, the sync warnings of ten calls
        with telemetry on against ten with it off, and the spans in the
        profiler's trace beside the kernel's launches.  Then, outside the
        trace, phase 2's ms/step with and without the session,
        `make_step`'s wall per call through the ladder and through its
        kernel tier's callable, and the first verified call's wall time
        beside a warm call's."""
        import shutil
        import tempfile
        import warnings

        from igg_torch import degrade, profiling, telemetry as tel

        it, t3 = self.it, self.t3
        n, steps = self.n_head, self.n_inner
        tag = f"diffusion {n}^3 periodic"
        work = tempfile.mkdtemp(prefix="igg_phase21_")
        trace_dir = os.path.join(work, "trace")
        degrade.reset()
        tel.reset_metrics()
        g = self.grid((n, n, n), **SINGLE, **PERIODIC)
        p = t3.Params()
        T, Cp = t3.init_fields(p)
        halo_per_call = 2 * 3 * n * n * 4     # three periodic dims, f32

        def counter(name, **labels):
            key = name + ("{" + ",".join(f'{k}="{v}"' for k, v in
                                         sorted(labels.items())) + "}"
                          if labels else "")
            return tel.snapshot().get(key, {}).get("value", 0.0)

        try:
            with tel.Telemetry(os.path.join(work, "session")) as session, \
                    profiling.trace(trace_dir):
                # 1. diffusion, verified on its first call.
                halo0 = counter("igg_halo_plane_bytes_total")
                first, warm = self.verified(
                    tag, lambda **kw: t3.make_multi_step(steps, p, **kw),
                    (T, Cp), "diffusion3d.cuda")
                halo = counter("igg_halo_plane_bytes_total") - halo0
                # The verification's plain route makes `steps` update_halo
                # calls; the kernel routes make none.
                if halo != steps * halo_per_call or counter(
                        "igg_halo_plane_bytes_total", dim="z",
                        mode="local_grouped") != steps * halo_per_call / 3:
                    raise SmokeFailure(f"{tag}: halo plane bytes {halo} != "
                                       f"{steps} x {halo_per_call}")
                calls = counter("igg_tier_dispatch_total",
                                family="diffusion3d", tier="diffusion3d.cuda")
                if calls != 3:      # verified, warm, and the unverified one
                    raise SmokeFailure(f"{tag}: {calls} dispatches counted")
                log(f"[phase 21] {tag}: make_multi_step({steps}, verify="
                    f"'first_use') verified diffusion3d.cuda against "
                    f"diffusion3d.plain in one span, output bitwise the "
                    f"unverified route's; {calls:.0f} dispatches counted; "
                    f"halo plane bytes {halo:.0f} = {steps} plain-route "
                    f"update_halo calls x {halo_per_call}; in the trace: "
                    f"first call {first * 1e3:.3f} ms, warm call "
                    f"{warm * 1e3:.3f} ms [{self.card}]")
                del T, Cp

                # 2. every other family's main route, verified once.
                m = self.n_wave
                hp, wp = self.h3.Params(), self.w2.Params()
                sp, swp = self.st3.Params(), self.sw.Params()
                for ftag, grid, make, state, tier in (
                        (f"HM3D {n}^3 periodic", ((n, n, n), PERIODIC),
                         lambda **kw: self.h3.make_multi_step(10, hp, **kw),
                         lambda: self.h3.init_fields(hp), "hm3d.cuda"),
                        (f"wave2d {m}^2 periodic",
                         ((m, m, 1), dict(periodx=1, periody=1)),
                         lambda **kw: self.w2.make_multi_step(9, wp, **kw),
                         lambda: self.wave_fresh(wp), "wave2d.chunk"),
                        (f"Stokes {n}^3 periodic",
                         ((n, n, n), dict(PERIODIC, **OL3)),
                         lambda **kw: self.st3.make_iteration(
                             sp, n_inner=9, **kw),
                         lambda: it.update_halo(*self.st3.init_fields(sp)),
                         "stokes3d.trapezoid"),
                        (f"shallow_water {m}^2 periodic",
                         ((m, m, 1), dict(periodx=1, periody=1)),
                         lambda **kw: self.sw.make_step(swp, n_inner=9, **kw),
                         lambda: self.sw_fresh(swp), "shallow_water.chunk")):
                    self.grid(grid[0], **SINGLE, **grid[1])
                    S = state()
                    first, warm = self.verified(ftag, make, S, tier)
                    log(f"[phase 21] {ftag}: {tier} verified against the "
                        f"plain tier, output bitwise the unverified route's; "
                        f"first call {first * 1e3:.3f} ms, warm call "
                        f"{warm * 1e3:.3f} ms [{self.card}]")
                    del S
                gen = self.spec_gen("relax3d")
                self.spec_grid("relax3d", "1x1x1_periodic", (n, n, n))
                S = (it.update_halo(self.spec_state(
                    gen, it.get_global_grid(), torch.float32, 97)[0]),)
                for route, kw in (("chunk", {}),
                                  ("banded", dict(banded=True, K=K_CHUNK,
                                                  band=8))):
                    first, warm = self.verified(
                        f"relax3d {n}^3 periodic {route}",
                        lambda kw=kw, **v: it.stencil.compile(
                            gen.spec, coeffs=gen.coeffs, n_inner=9, **kw,
                            **v), S, f"relax3d.{route}")
                    log(f"[phase 21] relax3d {n}^3 periodic: relax3d.{route} "
                        f"verified against the plain tier, output bitwise "
                        f"the unverified route's; first call "
                        f"{first * 1e3:.3f} ms, warm call {warm * 1e3:.3f} "
                        f"ms [{self.card}]")
                del S

                # 3. a corrupted tier raises and serves nothing.
                self.grid((n, n, n), **SINGLE, **PERIODIC)
                T, Cp = t3.init_fields(p)
                kernel = t3.make_multi_step(10, p)
                served = []

                def corrupted(T, Cp):
                    out = kernel(T, Cp)
                    out[n // 2, n // 2, n // 2] += 1.0
                    served.append(1)
                    return out

                ladder = degrade.Ladder("smoke_corrupt", [
                    degrade.Tier("smoke_corrupt.cuda", 0,
                                 build=lambda: corrupted),
                    degrade.Tier("smoke_corrupt.plain", 1, truth=True,
                                 build=lambda: t3.make_multi_step(
                                     10, p, use_kernels=False))],
                    verify="first_use")
                try:
                    ladder.dispatch(T, Cp)
                except self.it.GridError as e:
                    why = str(e)
                else:
                    raise SmokeFailure("a corrupted tier passed verification")
                if len(served) != 1 or "smoke_corrupt" in degrade.active():
                    raise SmokeFailure("the corrupted tier served a call")
                log(f"[phase 21] corrupted tier raised GridError: {why}")

                # 4. telemetry adds no device sync.
                step = t3.make_multi_step(steps, p)
                step(T, Cp)

                def sync_warnings(spans):
                    torch.cuda.synchronize()
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        torch.cuda.set_sync_debug_mode("warn")
                        try:
                            for i in range(10):
                                if spans:
                                    with tel.span("phase21.call", step=i):
                                        step(T, Cp)
                                else:
                                    step(T, Cp)
                        finally:
                            torch.cuda.set_sync_debug_mode("default")
                    torch.cuda.synchronize()
                    return [f"{os.path.basename(w.filename)}:{w.lineno}: "
                            f"{str(w.message)[:120]}" for w in caught
                            if "called a synchronizing CUDA operation"
                            in str(w.message)]

                on = sync_warnings(True)
                session.detach()
                os.environ["IGG_TELEMETRY_SPANS"] = "0"
                try:
                    off = sync_warnings(False)
                finally:
                    del os.environ["IGG_TELEMETRY_SPANS"]
                session.attach()
                if len(on) != len(off):
                    raise SmokeFailure(f"sync warnings with telemetry on "
                                       f"{on}, off {off}")
                on, off = len(on), len(off)
                log(f"[phase 21] ten make_multi_step({steps}) calls under "
                    f"set_sync_debug_mode('warn'): {on} sync warnings with "
                    f"the session and spans on, {off} with telemetry off")
                torch.cuda.synchronize()

            # 5. the profiler's trace holds the spans beside the launches.
            with open(profiling.trace_file(trace_dir)) as f:
                events = json.load(f)["traceEvents"]
            names = {e.get("name") for e in events}
            launches = sum(1 for e in events if e.get("cat") == "kernel"
                           and "step_kernel" in str(e.get("name")))
            missing = {"degrade.verify_first_use", "phase21.call"} - names
            if missing or not launches:
                raise SmokeFailure(f"profiler trace: spans {missing} missing "
                                   f"or no step_kernel launch ({launches})")
            with open(session.trace_path) as f:
                spans = json.load(f)["traceEvents"]
            log(f"[phase 21] profiler trace: {len(events)} events, "
                f"{launches} step_kernel launches beside the spans "
                f"degrade.verify_first_use and phase21.call; the session's "
                f"trace holds {len(spans)} spans; "
                f"{sorted(os.listdir(os.path.join(work, 'session')))}")

            # 6. times outside the trace: phase 2's make_multi_step with
            # and without the session, the ladder's and the halo byte
            # counter's host time, and the first verified call.
            g = self.grid((n, n, n), **SINGLE, **PERIODIC)
            T, Cp = t3.init_fields(p)
            step = t3.make_multi_step(steps, p)
            n1, n2 = self.nt_multi // 4, self.nt_multi

            def timed(attached):
                if not attached:
                    _, sec = it.time_steps(lambda T, Cp: (step(T, Cp), Cp),
                                           (T, Cp), n1=n1, n2=n2, warmup=1)
                    return sec / steps

                def spanned(T, Cp):
                    with tel.span("phase21.call"):
                        return step(T, Cp), Cp
                with tel.Telemetry(os.path.join(work, "timed")):
                    _, sec = it.time_steps(spanned, (T, Cp), n1=n1, n2=n2,
                                           warmup=1)
                return sec / steps

            bare = [timed(False)]
            attached = [timed(True), timed(True)]
            bare.append(timed(False))
            # The ladder's own walk (admission, the dispatch counter, the
            # active-tier record) on make_step's host-bound call: the
            # factory against its kernel tier's callable, in turns.
            one = t3.make_step(p)
            tier = one.ladder._fn(one.ladder.tier("diffusion3d.cuda"))
            walls = {}
            for name in ("tier", "ladder", "ladder", "tier"):
                fn = one if name == "ladder" else tier
                _, sec = it.time_steps(lambda T, Cp: (fn(T, Cp), Cp),
                                       (T, Cp), n1=10, n2=40, warmup=2)
                walls.setdefault(name, []).append(sec * 1e3)
            log(f"[phase 21] {tag} make_step wall per call through the "
                f"ladder {walls['ladder']} ms, through its kernel tier's "
                f"callable {walls['tier']} ms (in turns: tier, ladder, "
                f"ladder, tier) [{self.card}]")
            # The halo byte counter's host cost in one update_halo call of
            # phase 5's field.
            t0 = time.perf_counter()
            for _ in range(2000):
                self.halo.count_plane_bytes([g.nxyz], [torch.float32], g)
            count_us = (time.perf_counter() - t0) / 2000 * 1e6
            log(f"[phase 21] igg_halo_plane_bytes_total's count for one "
                f"{n}^3 f32 field: {count_us:.2f} us of host time per "
                f"update_halo call [{self.card}]")
            degrade.reset()
            first, warm = self.verified(
                tag, lambda **kw: t3.make_multi_step(steps, p, **kw),
                (T, Cp), "diffusion3d.cuda")
            log(f"[phase 21] {tag} make_multi_step({steps}) in turns without/"
                f"with/with/without the session (each call in a span): "
                f"{bare[0] * 1e3:.5f}, {attached[0] * 1e3:.5f}, "
                f"{attached[1] * 1e3:.5f}, {bare[1] * 1e3:.5f} ms/step; first "
                f"verified call {first * 1e3:.3f} ms, warm call "
                f"{warm * 1e3:.3f} ms [{self.card}]")
            self.perf["observability"] = dict(
                ms_per_step_without_session=[v * 1e3 for v in bare],
                ms_per_step_with_session=[v * 1e3 for v in attached],
                first_verified_call_ms=first * 1e3, warm_call_ms=warm * 1e3,
                make_step_wall_ms=walls, halo_count_us=count_us)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- phase 22 ---------------------------------------------------------
    def checkpoint_phase(self):
        """Save, resume and elastic resume at the 510^3 headline, the flat
        format, and the background worker (module docstring, phase 22)."""
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            gen, want = self.checkpoint_save_resume(tmp)
            self.checkpoint_elastic(gen, want)
        self.worker_frames()

    def host_peak(self, fn):
        """(fn's result, seconds, the peak of traced host allocations during
        it in bytes); the device's work is waited for inside the timing."""
        import tracemalloc

        tracemalloc.start()
        try:
            t0 = time.perf_counter()
            out = fn()
            sync(self.dev)
            sec = time.perf_counter() - t0
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        return out, sec, peak

    def checkpoint_save_resume(self, tmp):
        """(a) and (c): two calls of make_multi_step(steps_multi) on 2x2x2
        open blocks of n_multi^3, a sharded save of T and Cp, two calls
        launched right after it (T_ref); the loaded generation holds the
        saved state and continues to T_ref bitwise; a byte flipped in one
        shard of a copy is refused and skipped by the scan; the flat format
        round-trips bitwise.  Returns the generation and T_ref's interior."""
        import shutil

        from igg_torch import degrade
        from igg_torch import telemetry as tel

        it, t3, n, steps = self.it, self.t3, self.n_multi, self.steps_multi
        gather = sys.modules["igg_torch.gather"]
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2)
        tag = f"{it.nx_g()}^3 open (2x2x2 x {n}^3)"
        p = t3.Params()
        T, Cp = t3.init_fields(p)
        step = t3.make_multi_step(steps, p)
        T = step(step(T, Cp), Cp)
        tiers = dict(degrade.active())
        saved = T.clone()
        payload = 2 * T.numel() * T.element_size()
        block = payload // 16                 # one block of one field
        gen = os.path.join(tmp, "ckpt_000000034")
        sync(self.dev)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        records = []

        def saved_record(rec):
            if rec.kind == "checkpoint_write":
                records.append(rec.payload)

        tel.subscribe(saved_record)
        try:
            _, t_save, host_save = self.host_peak(
                lambda: it.save_checkpoint_sharded(gen, T=T, Cp=Cp))
        finally:
            tel.unsubscribe(saved_record)
        dev_save = torch.cuda.max_memory_allocated() - held
        if len(records) != 1 or records[0]["format"] != "sharded":
            raise SmokeFailure(f"{tag}: the save emitted {records} as its "
                               f"checkpoint_write records")
        split = {k: records[0][f"{k}_seconds"]
                 for k in ("fetch", "stamp", "write")}
        pinned = 0 if gather._pinned is None else gather._pinned.numel()
        T_ref = step(step(T, Cp), Cp)          # launched right after the save
        T_ref = T_ref.clone()
        got, t_load, _ = self.host_peak(lambda: it.load_checkpoint(gen))
        if got["T"].device != T.device or got["T"].data_ptr() == T.data_ptr():
            raise SmokeFailure(f"{tag}: load did not give fresh tensors on "
                               f"{T.device}")
        check(f"{tag}: loaded T vs the state at the save", got["T"], saved,
              0.0)
        check(f"{tag}: loaded Cp vs Cp", got["Cp"], Cp, 0.0)
        check(f"{tag}: resumed run vs the uninterrupted run",
              step(step(got["T"], got["Cp"]), got["Cp"]), T_ref, 0.0)
        del got
        ok, t_verify, _ = self.host_peak(lambda: it.verify_checkpoint(gen))
        if not ok:
            raise SmokeFailure(f"{tag}: verify_checkpoint refused the save")
        bad = os.path.join(tmp, "ckpt_000000051")
        shutil.copytree(gen, bad)
        shard = os.path.join(bad, "shard_00003.npz")
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x01]))
        if it.verify_checkpoint(bad):
            raise SmokeFailure(f"{tag}: a flipped byte in a shard verified")
        found = it.latest_checkpoint(tmp)
        if found is None or str(found) != gen:
            raise SmokeFailure(f"{tag}: latest_checkpoint gave {found}")
        shutil.rmtree(bad)
        want = it.gather_interior(T_ref)
        # (c) the flat format, the same state.
        flat = os.path.join(tmp, "flat.npz")
        _, t_fsave, _ = self.host_peak(
            lambda: it.save_checkpoint(flat, T=saved, Cp=Cp))
        fl, t_fload, _ = self.host_peak(lambda: it.load_checkpoint(flat))
        check(f"{tag}: flat round trip T", fl["T"], saved, 0.0)
        check(f"{tag}: flat round trip Cp", fl["Cp"], Cp, 0.0)
        del fl, saved
        os.unlink(flat)
        # The yardstick: one copy_ of the same bytes into pinned memory.
        copy_ms = self.pinned_copy_ms([T, Cp])
        gb = payload / 1e9
        log(f"[phase 22] {tag}: sharded save of T and Cp ({gb:.3f} GB, 16 "
            f"blocks of {block / 1e6:.1f} MB) {t_save:.3f} s = "
            f"{gb / t_save:.3f} GB/s: device-to-host copy "
            f"{split['fetch']:.3f} s, deep stats and CRC32 "
            f"{split['stamp']:.3f} s, file writes {split['write']:.3f} s; "
            f"one copy_ of the payload into pinned memory {copy_ms:.3f} ms "
            f"({gb / copy_ms * 1e3:.2f} GB/s) [{self.card}]")
        log(f"[phase 22] {tag}: load {t_load:.3f} s, verify {t_verify:.3f} "
            f"s, flat save {t_fsave:.3f} s, flat load {t_fload:.3f} s; "
            f"resumed run bitwise the uninterrupted one; a flipped shard "
            f"byte refused and skipped by latest_checkpoint [{self.card}]")
        log(f"[phase 22] {tag}: host peak of traced allocations during the "
            f"sharded save {host_save / 1e6:.1f} MB (one block set "
            f"{2 * block / 1e6:.1f} MB; the pinned buffer "
            f"{pinned / 1e6:.1f} MB besides), device memory above the fields "
            f"during the save {dev_save / 1e6:.1f} MB (one block "
            f"{block / 1e6:.1f} MB); tiers {json.dumps(tiers)} [{self.card}]")
        # One block set plus one slab (a block is below the slab limit, so
        # its slab is the whole block), and 1 MB for the zip and JSON
        # bookkeeping.
        if host_save > 3 * block + (1 << 20):
            raise SmokeFailure(f"{tag}: save staged {host_save} host bytes, "
                               f"above one block set and a slab")
        self.perf["checkpoint_510^3"] = dict(
            save_s=t_save, save_gb_per_s=gb / t_save, save_split_s=split,
            pinned_copy_ms=copy_ms, load_s=t_load, verify_s=t_verify,
            flat_save_s=t_fsave, flat_load_s=t_fload,
            host_peak_save_bytes=host_save, pinned_bytes=pinned,
            device_extra_save_bytes=dev_save, block_bytes=block, tiers=tiers)
        return gen, want

    def checkpoint_elastic(self, gen, want):
        """(b): the generation restored onto (1, 2, 4) blocks of the same
        global grid, two calls of make_multi_step(steps_multi): the interior
        equals T_ref's, bitwise."""
        from igg_torch import degrade

        it, t3, n, steps = self.it, self.t3, self.n_multi, self.steps_multi
        size = 2 * (n - 2) + 2
        self.grid((size, n, (size - 2) // 4 + 2), dimx=1, dimy=2, dimz=4)
        tag = (f"{it.nx_g()}x{it.ny_g()}x{it.nz_g()} open (1x2x4 x "
               f"{it.get_global_grid().nxyz})")
        got, t_load, host_load = self.host_peak(
            lambda: it.load_checkpoint(gen, redistribute=True))
        step = t3.make_multi_step(steps, t3.Params())
        T = step(step(got["T"], got["Cp"]), got["Cp"])
        sync(self.dev)
        tiers = dict(degrade.active())
        block = got["T"].numel() * got["T"].element_size() // 8
        if not np.array_equal(it.gather_interior(T), want):
            raise SmokeFailure(f"{tag}: elastic resume differs from the "
                               f"uninterrupted run")
        log(f"[phase 22] {tag}: elastic load {t_load:.3f} s, host peak of "
            f"traced allocations {host_load / 1e6:.1f} MB (one block set "
            f"{2 * block / 1e6:.1f} MB, a target block {block / 1e6:.1f} "
            f"MB); two calls of make_multi_step({steps}) "
            f"on tiers {json.dumps(tiers)}: interior bitwise the "
            f"uninterrupted run's [{self.card}]")
        if host_load > 3 * block + (1 << 20):
            raise SmokeFailure(f"{tag}: elastic load staged {host_load} host "
                               f"bytes, above one block set and a slab")
        self.perf["checkpoint_510^3"].update(
            elastic_load_s=t_load, host_peak_elastic_bytes=host_load,
            elastic_tiers=tiers)

    def pinned_copy_ms(self, tensors) -> float:
        """ms of copying `tensors` into one pinned host buffer, each with
        one copy_ (the best of three)."""
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        best = float("inf")
        for _ in range(3):
            sync(self.dev)
            t0 = time.perf_counter()
            off = 0
            for t in tensors:
                size = t.numel() * t.element_size()
                host[off:off + size].view(t.dtype).view(t.shape).copy_(
                    t, non_blocking=True)
                off += size
            sync(self.dev)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    def worker_frames(self):
        """(d): on one n_head^3 periodic block, a BackgroundRenderer gets T
        after every call of make_multi_step(steps_multi) and reduces each
        frame to a CRC32 on its thread; every frame equals the synchronous
        frame of the same step.  Timed in turns: the solver alone, the
        frames in series with it (the synchronous loop) and on the worker;
        one frame alone; then the same with a frame every k calls, k the
        frame's time over a call's, so that the two are of one size and
        overlap shows (the worker near the larger, the series near the
        sum)."""
        import zlib

        from igg_torch import vis

        it, t3, n, steps = self.it, self.t3, self.n_head, self.steps_multi
        self.grid((n, n, n), **SINGLE, **PERIODIC)
        tag = f"{n}^3 periodic"
        p = t3.Params()
        T0, Cp = t3.init_fields(p)
        step = t3.make_multi_step(steps, p)

        def crc(X):
            return zlib.crc32(X.cpu().numpy())

        def run(mode: str, calls: int, every: int):
            """(ms a call, {call: frame CRC32}); `mode` is "without" (no
            frames), "series" (each frame taken on this thread after its
            call) or "worker"."""
            frames = {}

            def consume(batch):
                k, X = batch
                frames[k] = crc(X)

            T = T0.clone()
            sync(self.dev)
            t0 = time.perf_counter()
            if mode == "worker":
                with vis.BackgroundRenderer(consume, maxsize=3) as r:
                    for k in range(calls):
                        T = step(T, Cp)
                        if (k + 1) % every == 0:
                            r.submit((k, T))
                if r.errors:
                    raise SmokeFailure(f"{tag}: worker errors {r.errors}")
            else:
                for k in range(calls):
                    T = step(T, Cp)
                    if mode == "series" and (k + 1) % every == 0:
                        frames[k] = crc(T)
            sync(self.dev)
            return (time.perf_counter() - t0) / calls * 1e3, frames

        def frame_ms():
            X = step(T0.clone(), Cp)
            sync(self.dev)
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                crc(X)
                best = min(best, time.perf_counter() - t0)
            return best * 1e3

        def turns(calls: int, every: int):
            order = ("without", "series", "worker", "worker", "series",
                     "without")
            ms, frames = {}, {}
            for mode in order:
                t, f = run(mode, calls, every)
                ms.setdefault(mode, []).append(t)
                frames.setdefault(mode, []).append(f)
            want = frames["series"][0]
            if len(want) != calls // every or any(
                    f != want for f in frames["series"] + frames["worker"]):
                raise SmokeFailure(f"{tag}: a worker frame differs from its "
                                   f"synchronous frame (a frame every "
                                   f"{every} calls)")
            return ms

        frame = frame_ms()
        each = turns(20, 1)
        solver = min(each["without"])
        every = max(1, round(frame / solver))
        spaced = turns(4 * every, every)
        frame_after = frame_ms()
        fmt = lambda ms: {m: [round(v, 4) for v in t] for m, t in ms.items()}
        log(f"[phase 22] {tag}: make_multi_step({steps}), a frame (the "
            f"capture's fetch and CRC32) after every call, 20 calls: every "
            f"worker frame's CRC32 equals the synchronous frame's; one "
            f"frame alone {frame:.3f} ms (after the turns "
            f"{frame_after:.3f}); ms a call in turns {fmt(each)} (the "
            f"worker's drain at close included) [{self.card}]")
        log(f"[phase 22] {tag}: a frame every {every} calls "
            f"({4 * every} calls): ms a call in turns {fmt(spaced)}; overlap "
            f"would put the worker near max(solver, frame / {every}) = "
            f"{max(min(spaced['without']), frame / every):.4f} and the "
            f"series near their sum "
            f"{min(spaced['without']) + frame / every:.4f} [{self.card}]")
        self.perf["worker_frames"] = dict(
            steps_per_call=steps, frame_ms=[frame, frame_after],
            ms_per_call_every_call=each, every=every,
            ms_per_call_spaced=spaced)

    # -- phase 23 ---------------------------------------------------------
    def resilience_phase(self):
        """The resilient loop and chaos (module docstring, phase 23)."""
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            self.resilient_headline(os.path.join(tmp, "a"))
            self.resilient_halo(os.path.join(tmp, "b"))
            self.resilient_recurrence(os.path.join(tmp, "c"))
        self.resilient_overhead()
        # The loop ran over rows 1, 3, 4 and 5 of PERF.md's kernel table.
        counts = self.ops.launch_counts()
        idle = [k for k in ("diffusion_step", "halo_write", "pack_planes",
                            "diffusion_chunk_step") if not counts[k]]
        if idle:
            raise SmokeFailure(f"phase 23 did not launch {idle}")

    def resilient_state(self, multi: bool):
        """(T, Cp) from `update_halo(*init_fields())` on the current grid
        and the step over a dict state: `make_multi_step(steps_multi)` or
        `make_step`; the second item of the step is the set of tiers that
        served its calls."""
        from igg_torch import degrade

        it, t3 = self.it, self.t3
        p = t3.Params()
        T, Cp = t3.init_fields(p)
        T = it.update_halo(T)
        step = t3.make_multi_step(self.steps_multi, p) if multi else \
            t3.make_step(p)
        tiers = set()

        def fn(s):
            out = {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}
            tiers.add(degrade.active()["diffusion3d"])
            return out

        return T, Cp, fn, tiers

    @staticmethod
    def run_calls(fn, state, calls):
        for _ in range(calls):
            state = fn(state)
        return state

    def resilient_headline(self, tmp):
        """(a) The 510^3 headline under chaos: a NaN at step 120 and a
        preemption at step 238 with its resume, each bitwise the
        uninterrupted run; the probe's device time; each cadence submit's
        hold on the loop beside a synchronous generation."""
        import threading

        from igg_torch import chaos, resilience
        from igg_torch import telemetry as tel

        it, n, steps = self.it, self.n_multi, self.steps_multi
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2)
        tag = f"{it.nx_g()}^3 open (2x2x2 x {n}^3)"
        T, Cp, fn, tiers = self.resilient_state(multi=True)
        calls = 20
        n_steps = calls * steps                         # 340
        watch, every, pending = 2 * steps, 6 * steps, 4   # 34, 102
        t0 = time.perf_counter()
        ref = self.run_calls(fn, {"T": T, "Cp": Cp}, calls)["T"]
        sync(self.dev)
        bare = time.perf_counter() - t0
        kw = dict(steps_per_call=steps, watch_every=watch,
                  checkpoint_every=every, ring=2,
                  max_pending_probes=pending)
        holds, spans = [], []
        main = threading.get_ident()
        real_submit = resilience._AsyncCheckpointWriter.submit

        def timed_submit(writer, step, fields, last_good):
            t1 = time.perf_counter()
            real_submit(writer, step, fields, last_good)
            holds.append(time.perf_counter() - t1)

        def on_record(rec):
            if rec.kind == "span" and rec.payload["name"] in (
                    "checkpoint.generation", "checkpoint.drain"):
                spans.append((rec.payload["name"], rec.step,
                              rec.payload["dur_s"],
                              rec.payload["tid"] == main))

        walls = {}
        resilience._AsyncCheckpointWriter.submit = timed_submit
        tel.subscribe(on_record)
        try:
            t0 = time.perf_counter()
            res = it.run_resilient(
                fn, {"T": T, "Cp": Cp}, n_steps,
                checkpoint_dir=os.path.join(tmp, "nan"),
                chaos=chaos.ChaosPlan(nan_at=[(120, "T")]), **kw)
            walls["nan"] = time.perf_counter() - t0
            det = [e.step for e in res.events if e.kind == "nan_detected"]
            rb = [e.step for e in res.events if e.kind == "rollback"]
            if (len(det) != 1 or not 120 < det[0] <= 120 + watch * (
                    1 + pending) or len(rb) != 1 or rb[0] > every
                    or res.retries != 1 or res.steps_done != n_steps):
                raise SmokeFailure(
                    f"{tag}: NaN at 120 gave detections {det}, rollbacks "
                    f"{rb}, {res.retries} retries, {res.steps_done} steps")
            err_nan = check(f"{tag}: NaN rollback run vs the uninterrupted "
                            f"run", res.state["T"], ref, 0.0)
            kinds_nan = [(e.kind, e.step) for e in res.events]
            del res
            pre = os.path.join(tmp, "preempt")
            t0 = time.perf_counter()
            res = it.run_resilient(fn, {"T": T, "Cp": Cp}, n_steps,
                                   checkpoint_dir=pre,
                                   chaos=chaos.ChaosPlan(preempt_at=238),
                                   **kw)
            walls["preempt"] = time.perf_counter() - t0
            if not res.preempted or res.steps_done != 238:
                raise SmokeFailure(f"{tag}: preemption at 238 gave "
                                   f"{res.preempted}, {res.steps_done}")
            kinds_pre = [(e.kind, e.step) for e in res.events]
            del res
            t0 = time.perf_counter()
            res = it.run_resilient(fn, {"T": T, "Cp": Cp}, n_steps,
                                   checkpoint_dir=pre, resume=True, **kw)
            walls["resume"] = time.perf_counter() - t0
            if (res.events[0].kind, res.events[0].step) != ("resume", 238) \
                    or res.steps_done != n_steps or res.preempted:
                raise SmokeFailure(f"{tag}: resume gave {res.events[:1]}, "
                                   f"{res.steps_done}")
            err_res = check(f"{tag}: resumed run vs the uninterrupted run",
                            res.state["T"], ref, 0.0)
            kinds_res = [(e.kind, e.step) for e in res.events]
            del res
        finally:
            resilience._AsyncCheckpointWriter.submit = real_submit
            tel.unsubscribe(on_record)
        if tiers != {"diffusion3d.cuda"}:
            raise SmokeFailure(f"{tag}: the calls were served by {tiers}")
        gens_sync = [d for name, _, d, on_main in spans
                     if name == "checkpoint.generation" and on_main]
        gens_async = [d for name, _, d, on_main in spans
                      if name == "checkpoint.generation" and not on_main]
        drains = [d for name, _, d, _ in spans if name == "checkpoint.drain"]
        step_ms = bare / n_steps * 1e3
        split, n_probe = device_ms_by_kernel(
            lambda: resilience.probe_counts(T, Cp), 10)
        probe_ms = sum(split.values())
        probe_bound = bound_ms(2 * T.numel() * T.element_size(), 0,
                               F32_FLOPS)
        log(f"[phase 23] (a) {tag}, make_multi_step({steps}) x {calls}: NaN "
            f"at 120 -> {kinds_nan}; vs the uninterrupted run {err_nan:.3e} "
            f"(tolerance 0)")
        log(f"[phase 23] (a) {tag}: preempt at 238 -> {kinds_pre}; resume "
            f"-> {kinds_res}; vs the uninterrupted run {err_res:.3e} "
            f"(tolerance 0); tiers served {sorted(tiers)}")
        log(f"[phase 23] (a) {tag}: wall s: bare {calls} calls {bare:.3f}, "
            f"NaN run {walls['nan']:.3f}, preempted run "
            f"{walls['preempt']:.3f}, resume {walls['resume']:.3f}; sync "
            f"generations s {fmt_list(gens_sync)}, background generations "
            f"s {fmt_list(gens_async)}, drains s {fmt_list(drains)} "
            f"[{self.card}]")
        ratio = max(holds) / min(gens_sync) if holds and gens_sync else None
        log(f"[phase 23] (d) {tag}: each cadence submit held the loop ms "
            f"{fmt_list([h * 1e3 for h in holds])} against a synchronous "
            f"generation's {min(gens_sync) * 1e3:.1f} ms: the largest "
            f"{ratio * 100:.3f}% of it, igg's contract < 10% "
            f"{'met' if ratio < 0.1 else 'MISSED'} [{self.card}]")
        log(f"[phase 23] (d) {tag}: the watchdog probe over T and Cp "
            f"(2 x {T.numel() * T.element_size() / 1e6:.1f} MB): device "
            f"{probe_ms:.4f} ms, {n_probe:.0f} launches "
            f"{json.dumps(split)}; a read of both fields "
            f"{probe_bound[0]:.4f} ms; {100 * probe_ms / (watch * step_ms):.2f}"
            f"% of a {watch}-step window at the bare loop's {step_ms:.4f} "
            f"ms/step [{self.card}]")
        self.perf["resilience_510"] = dict(
            walls_s=walls, bare_s=bare, sync_generation_s=gens_sync,
            background_generation_s=gens_async, drain_s=drains,
            submit_hold_s=holds, submit_over_sync=ratio,
            probe_device_ms=probe_ms, probe_launches=n_probe,
            probe_split=split, probe_bound_ms=probe_bound[0])

    def resilient_halo(self, tmp):
        """(b) Halo corruption on phase 4's (2,2,1) grid, disarmed by the
        recovery policy: detected, rolled back, bitwise the clean run."""
        from igg_torch import chaos

        nx, ny, nz = self.recv_local
        self.grid((nx, ny, nz), dimx=2, dimy=2, dimz=1)
        tag = f"dims (2,2,1) {nx}x{ny}x{nz}/block open"
        T, Cp, fn, tiers = self.resilient_state(multi=False)
        n_steps = 30
        ref = self.run_calls(fn, {"T": T, "Cp": Cp}, n_steps)["T"]
        fault, seen = chaos.halo_corruption(), []

        def policy(attempt, state, ev):
            seen.append((attempt, ev.kind))
            fault.disarm()

        with fault:
            res = self.it.run_resilient(
                fn, {"T": T, "Cp": Cp}, n_steps, watch_every=10,
                checkpoint_every=10, checkpoint_dir=tmp,
                recovery_policy=policy)
        kinds = [(e.kind, e.step) for e in res.events]
        if seen != [(1, "nan_detected")] or res.retries != 1 or \
                [k for k, _ in kinds].count("rollback") != 1:
            raise SmokeFailure(f"{tag}: halo corruption gave {kinds}, "
                               f"policy calls {seen}")
        err = check(f"{tag}: halo-corrupted run vs the clean run",
                    res.state["T"], ref, 0.0)
        log(f"[phase 23] (b) {tag}, make_step x {n_steps}: halo corruption "
            f"-> {kinds}; vs the clean run {err:.3e} (tolerance 0); tiers "
            f"served {sorted(tiers)}")

    def resilient_recurrence(self, tmp):
        """(c) A kernel tier corrupted at every dispatch on phase 2's block:
        the recurrence raises ResilienceError naming the tier; nothing is
        quarantined and diffusion3d.plain never serves.  Quarantined by
        hand, the tier's dispatch raises GridError naming it."""
        from igg_torch import chaos, degrade

        it, n, steps = self.it, self.n_head, self.steps_multi
        self.grid((n, n, n), **SINGLE, **PERIODIC)
        tag = f"{n}^3 periodic"
        T, Cp, fn, tiers = self.resilient_state(multi=True)
        with chaos.kernel_corrupt("diffusion3d.cuda"):
            try:
                it.run_resilient(fn, {"T": T, "Cp": Cp}, 20 * steps,
                                 steps_per_call=steps, watch_every=2 * steps,
                                 checkpoint_every=2 * steps, ring=2,
                                 checkpoint_dir=tmp)
            except it.ResilienceError as e:
                err = e
            else:
                raise SmokeFailure(f"{tag}: a corrupted kernel tier ran to "
                                   f"the end")
        kinds = [(e.kind, e.step) for e in err.events]
        if ("diffusion3d.cuda" not in str(err)
                or "diffusion3d.plain" not in str(err)
                or [k for k, _ in kinds].count("nan_detected") != 2
                or degrade.status() or tiers != {"diffusion3d.cuda"}):
            raise SmokeFailure(f"{tag}: recurrence gave {err!r}, events "
                               f"{kinds}, quarantine {degrade.status()}, "
                               f"tiers {tiers}")
        log(f"[phase 23] (c) {tag}: kernel_corrupt('diffusion3d.cuda') -> "
            f"{kinds}, then ResilienceError: {err}; quarantined "
            f"{sorted(degrade.status())}, tiers served {sorted(tiers)}")
        # The ladder's own guard: a quarantined kernel tier is not replaced
        # by diffusion3d.plain on the card; the dispatch raises.
        degrade.quarantine("diffusion3d.cuda", 1, "nan_recurrence")
        try:
            fn({"T": T, "Cp": Cp})
        except it.GridError as e:
            guard = e
        else:
            raise SmokeFailure(f"{tag}: a quarantined diffusion3d.cuda "
                               f"was served by {sorted(tiers)}")
        finally:
            degrade.reset("diffusion3d.cuda")
        if "diffusion3d.cuda is quarantined" not in str(guard) \
                or tiers != {"diffusion3d.cuda"}:
            raise SmokeFailure(f"{tag}: quarantined dispatch gave {guard!r}, "
                               f"tiers {tiers}")
        log(f"[phase 23] (c) {tag}: diffusion3d.cuda quarantined by hand -> "
            f"GridError: {guard}")

    def resilient_overhead(self):
        """(d) The probe at 256^3; the bare loop against run_resilient with
        no ring, in turns, at 256^3 (make_multi_step, watch_every=340) and
        at 128^3 (make_step, watch_every=50, igg's contract row); sync
        warnings over 10 and 20 watch windows."""
        import warnings

        from igg_torch import resilience

        it, n, steps = self.it, self.n_head, self.steps_multi
        out = {}
        for size, multi, watch, n_steps in ((n, True, 20 * steps,
                                             100 * steps),
                                            (N_OVERHEAD, False, 50,
                                             300)):
            self.grid((size, size, size), **SINGLE, **PERIODIC)
            tag = f"{size}^3 periodic"
            T, Cp, fn, _ = self.resilient_state(multi=multi)
            spc = steps if multi else 1
            state = {"T": T, "Cp": Cp}
            # Watched: every float field (T, Cp), or T alone as in igg's
            # benchmarks/resilience_overhead.py.
            watched_fields = (T, Cp) if multi else (T,)
            split, _ = device_ms_by_kernel(
                lambda: resilience.probe_counts(*watched_fields), 10)
            probe_ms = sum(split.values())
            route = f"make_multi_step({steps})" if multi else "make_step"

            def bare():
                t0 = time.perf_counter()
                self.run_calls(fn, state, n_steps // spc)
                sync(self.dev)
                return (time.perf_counter() - t0) / n_steps * 1e3

            def watched():
                t0 = time.perf_counter()
                res = it.run_resilient(
                    fn, state, n_steps, steps_per_call=spc,
                    watch_every=watch, install_sigterm=False,
                    watch_fields=None if multi else ["T"])
                sync(self.dev)
                if res.steps_done != n_steps:
                    raise SmokeFailure(f"{tag}: {res.steps_done} steps")
                return (time.perf_counter() - t0) / n_steps * 1e3

            bare(), watched()
            turns = {"bare": [], "resilient": []}
            for _ in range(3):
                turns["bare"].append(bare())
                turns["resilient"].append(watched())
            b, w = min(turns["bare"]), min(turns["resilient"])
            component = probe_ms / (watch * b) * 100
            log(f"[phase 23] (d) {tag}, {route}, watch_every={watch}, no ring: ms/step in turns bare "
                f"{fmt_list(turns['bare'])}, run_resilient "
                f"{fmt_list(turns['resilient'])}: wall delta "
                f"{(w - b) / b * 100:+.2f}%; the probe {probe_ms:.4f} ms "
                f"device, {component:.3f}% of a window (igg's contract, "
                f"< 2%: {'met' if component < 2 else 'MISSED'}) "
                f"[{self.card}]")
            out[tag] = dict(turns_ms_per_step=turns, probe_device_ms=probe_ms,
                            probe_split=split, probe_over_window=component,
                            wall_delta=(w - b) / b)
        # Sync warnings over 10 and 20 watch windows (256^3, no ring).
        self.grid((n, n, n), **SINGLE, **PERIODIC)
        T, Cp, fn, _ = self.resilient_state(multi=True)
        counts = {}
        for windows in (10, 20):
            it.run_resilient(fn, {"T": T, "Cp": Cp}, 2 * steps,
                             steps_per_call=steps, watch_every=steps,
                             install_sigterm=False)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    it.run_resilient(fn, {"T": T, "Cp": Cp},
                                     windows * 2 * steps,
                                     steps_per_call=steps,
                                     watch_every=2 * steps,
                                     install_sigterm=False)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            counts[windows] = [
                f"{os.path.basename(w.filename)}:{w.lineno}"
                for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
        flat = len(counts[20]) <= len(counts[10])
        log(f"[phase 23] (d) {n}^3 periodic, run_resilient over 10 and 20 "
            f"watch windows of {2 * steps} steps under "
            f"set_sync_debug_mode('warn'): {len(counts[10])} and "
            f"{len(counts[20])} sync warnings ({'flat' if flat else 'GROWS'}"
            f"; {sorted(set(counts[10] + counts[20]))}) [{self.card}]")
        out["sync_warnings"] = {k: len(v) for k, v in counts.items()}
        self.perf["resilience_overhead"] = out

    # -- phase 24: comm/compute overlap ----------------------------------
    def overlap_phase(self):
        """Phase 24: the overlapped plain composition
        (`igg_torch.hide_communication` on its side stream) at config 5's
        509^3 Stokes grid and at the 510^3 diffusion headline, each bitwise
        its sequential composition and timed beside it in turns, with the
        side stream's concurrency from the profiler's kernel events; then
        the contracts: sync warnings, admission on one block, and a loop
        that drops every result."""
        import warnings

        from igg_torch import degrade

        it, st3, t3 = self.it, self.st3, self.t3
        n, steps = self.n_multi, self.steps_multi
        out = {}
        # (a) BASELINE config 5: Stokes, 2x2x2 blocks of n^3, open.
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2, **OL3)
        size = it.nx_g()
        p = st3.Params()
        S = it.update_halo(*st3.init_fields(p))
        out["stokes"] = self.overlap_case(
            f"(a) Stokes {size}^3 open (2x2x2 x {n}^3)", "stokes3d", S,
            lambda ov: st3.make_iteration(p, n_inner=steps, use_kernels=False,
                                          overlap=ov), steps, "iteration")
        del S
        # (b) The diffusion headline, 2x2x2 blocks of n^3, open.
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2)
        size = it.nx_g()
        p = t3.Params()
        T, Cp = t3.init_fields(p)
        out["diffusion"] = self.overlap_case(
            f"(b) diffusion {size}^3 open (2x2x2 x {n}^3)", "diffusion3d",
            (T, Cp), lambda ov: t3.make_multi_step(steps, p, use_kernels=False,
                                                   overlap=ov), steps, "step")
        head = self.perf.get("headline_510^3_open_2x2x2")
        if head:
            log(f"[phase 24] (b) beside phase 6's kernel routes at {size}^3: "
                f"chunk route {head['chunk_route_ms_per_step']:.4f} ms/step, "
                f"per-step route {head['per_step_route_ms_per_step']:.4f} "
                f"ms/step [{self.card}]")
        # (d) The contracts at (b)'s grid: sync warnings of ten one-step
        # calls each way, and twenty chained overlapped calls whose results
        # are dropped at once against twenty whose results are kept.
        one = {ov: t3.make_multi_step(1, p, use_kernels=False, overlap=ov)
               for ov in (False, True)}
        warned = {}
        for ov in (False, True):
            one[ov](T, Cp)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    for _ in range(10):
                        one[ov](T, Cp)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            warned[ov] = [f"{os.path.basename(w.filename)}:{w.lineno}"
                          for w in caught if "called a synchronizing CUDA "
                          "operation" in str(w.message)]
        if len(warned[True]) != len(warned[False]):
            raise SmokeFailure(f"sync warnings: overlapped {warned[True]}, "
                               f"sequential {warned[False]}")
        log(f"[phase 24] (d) ten make_multi_step(1) calls at {size}^3 under "
            f"set_sync_debug_mode('warn'): {len(warned[True])} sync warnings "
            f"overlapped, {len(warned[False])} sequential")
        kept, X = [], T
        for _ in range(20):
            X = one[True](X, Cp)
            kept.append(X)
        store = torch.empty((20,) + tuple(T.shape), dtype=T.dtype,
                            device=T.device)
        X = T
        for i in range(20):
            r = one[True](X, Cp)
            store[i].copy_(r)
            del r
            X = store[i]
        torch.cuda.synchronize()
        err = max(check(f"drop-every-result loop, call {i}", store[i],
                        kept[i], 0.0) for i in range(20))
        del kept, store, X
        log(f"[phase 24] (d) twenty chained overlapped calls at {size}^3 "
            f"with every result dropped at once equal the loop that keeps "
            f"them: max abs err {err:.1e} (tolerance 0)")
        del T, Cp
        # (d) IGG_OVERLAP=1 and overlap="auto" on phase 2's one block.
        self.grid((self.n_head,) * 3, **SINGLE, **PERIODIC)
        T, Cp = t3.init_fields(p)
        os.environ["IGG_OVERLAP"] = "1"
        try:
            t3.make_multi_step(1, p, use_kernels=False, overlap="auto")(T, Cp)
        finally:
            del os.environ["IGG_OVERLAP"]
        reason = degrade.admission_log().get("diffusion3d.overlap", "")
        served = degrade.active()["diffusion3d"]
        if not reason.startswith("single-device mesh") or \
                served != "diffusion3d.plain":
            raise SmokeFailure(f"IGG_OVERLAP=1 on one block: {served} served, "
                               f"admission log {reason!r}")
        log(f"[phase 24] (d) IGG_OVERLAP=1, overlap='auto' on one "
            f"{self.n_head}^3 block: {served} served; admission log "
            f"diffusion3d.overlap: {reason!r}")
        out["sync_warnings"] = {"overlapped": len(warned[True]),
                                "sequential": len(warned[False])}
        self.perf["overlap"] = out

    def overlap_case(self, tag, family, args, make, iters, unit):
        """One overlapped plain route (`make(True)`) against its sequential
        composition (`make(False)`) on `args`: bitwise, served by
        `<family>.overlap`, the halo writer's launches counted; ms per
        `unit` of both, in turns; the side stream's concurrency."""
        from igg_torch import degrade

        ops = self.ops
        seq, ovl = make(False), make(True)
        before = ops.launch_counts()
        got = ovl(*args)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()
                    if v != before[k]}
        served = degrade.active()[family]
        want = seq(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(check(f"{tag}: overlapped vs sequential", a, b, 0.0)
                  for a, b in zip(got, want))
        if not all(bool(torch.isfinite(a).all()) for a in got):
            raise SmokeFailure(f"{tag}: non-finite values")
        del got, want
        if served != f"{family}.overlap":
            raise SmokeFailure(f"{tag}: {served} served the overlapped call")
        if launched.get("halo_write", 0) <= 0:
            raise SmokeFailure(f"{tag}: no halo writer launch ({launched})")
        log(f"[phase 24] {tag}: make(n_inner={iters}, use_kernels=False, "
            f"overlap=True) served by {served}, bitwise overlap=False (max "
            f"abs err {err:.1e}); launches a call {json.dumps(launched)}")
        wall = {False: [], True: []}
        for ov in (False, True, True, False, False, True, True, False):
            fn = ovl if ov else seq
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            wall[ov].append((time.perf_counter() - t0) * 1e3 / iters)
        ms = {ov: sum(v) / len(v) for ov, v in wall.items()}
        conc = self.stream_concurrency(lambda: ovl(*args))
        log(f"[phase 24] {tag}: ms/{unit} in turns, sequential "
            f"{fmt_list(wall[False])} (mean {ms[False]:.4f}), overlapped "
            f"{fmt_list(wall[True])} (mean {ms[True]:.4f}), "
            f"{100 * (ms[True] / ms[False] - 1):+.2f}% [{self.card}]")
        log(f"[phase 24] {tag}: one overlapped call: side stream "
            f"{conc['side_ms']:.4f} ms of kernels in {conc['side_kernels']} "
            f"launches, {100 * conc['concurrent_share']:.1f}% of it while a "
            f"kernel of the caller's stream ran; the caller's stream "
            f"{conc['main_ms']:.4f} ms of kernels, waited "
            f"{conc['join_wait_ms']:.4f} ms at the joins ({conc['joins']}) "
            f"[{self.card}]")
        return dict(sequential_ms_per_unit=wall[False],
                    overlapped_ms_per_unit=wall[True], unit=unit,
                    launches_per_call=launched, **conc)

    def stream_concurrency(self, fn, tries=3):
        """:func:`stream_split` of `torch.profiler`'s kernel events of one
        call of `fn()`, its trace taken again (up to `tries` times) where it
        holds no kernel on a stream beside the halo writer's."""
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for left in range(tries - 1, -1, -1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"
                       and "stream" in e.get("args", {})]
            try:
                return stream_split(kernels)
            except SmokeFailure:
                if not left:
                    raise

    # -- phase 25: the perf ledger and the autotuner ---------------------
    def tune_cases(self):
        """Phase 25's four grids: (tag, family, grid kwargs, fields,
        factory(**knobs) at n_inner=steps_multi, today's tier)."""
        it, t3, st3, w2, sw = self.it, self.t3, self.st3, self.w2, self.sw
        n, ns, nw, steps = (self.n_multi, self.n_stokes, self.n_wave,
                            self.steps_multi)
        pd, ps, pw, pq = t3.Params(), st3.Params(), w2.Params(), sw.Params()
        return [
            (f"diffusion 510^3 open (2x2x2 x {n}^3)", "diffusion3d",
             ((n, n, n), dict(dimx=2, dimy=2, dimz=2)),
             lambda: t3.init_fields(pd),
             lambda **kw: (lambda f: lambda T, Cp: (f(T, Cp), Cp))(
                 t3.make_multi_step(steps, pd, **kw)),
             "diffusion3d.cuda"),
            (f"Stokes {ns}^3 periodic", "stokes3d",
             ((ns, ns, ns), dict(**SINGLE, **PERIODIC, **OL3)),
             lambda: it.update_halo(*st3.init_fields(ps)),
             lambda **kw: (lambda f: lambda P, Vx, Vy, Vz, Rho: f(
                 P, Vx, Vy, Vz, Rho) + (Rho,))(
                 st3.make_iteration(ps, n_inner=steps, **kw)),
             "stokes3d.trapezoid"),
            (f"shallow water config 3 ({self.wave_blocks}x1 x {nw}^2, x "
             f"periodic)", "shallow_water",
             ((nw, nw, 1), dict(dimx=self.wave_blocks, dimy=1, dimz=1,
                                periodx=1)),
             lambda: it.update_halo(*sw.init_fields(pq)),
             lambda **kw: self.sw_pinned(pq, steps, **kw), "shallow_water.chunk"),
            (f"wave2d {nw}^2 periodic", "wave2d",
             ((nw, nw, 1), dict(**SINGLE, periodx=1, periody=1)),
             lambda: it.update_halo(*w2.init_fields(pw)),
             lambda **kw: w2.make_multi_step(steps, pw, **kw), "wave2d.chunk"),
        ]

    def sw_pinned(self, p, steps, **kw):
        """Shallow water's factory (`stencil.compile` of its spec) with the
        knobs the autotuner pins."""
        from igg_torch import stencil

        return stencil.compile(self.sw.spec(p), coeffs=p.coeffs(),
                               n_inner=steps, **kw)

    def tune_relaxed(self, tag, S, tuned, rule, w, today):
        """Phase 25 (c), Stokes: the search times its candidates from the
        state at rest (`init_fields`), where the Stokes division meets
        tiny dividends; the winner and today's rule timed again from the
        state after 1100 iterations (phase 12's timed span), in turns."""
        it, steps = self.it, self.steps_multi
        X = tuple(a.clone() for a in S)
        for _ in range(-(-1100 // steps)):
            X = tuned(*X)
        ms = {}
        for name, fn in (("winner", tuned), ("today", rule),
                         ("winner", tuned), ("today", rule)):
            _, sec = it.time_steps(fn, tuple(a.clone() for a in X), n1=2,
                                   n2=6, warmup=1)
            ms.setdefault(name, []).append(sec * 1e3 / steps)
        log(f"[phase 25] (c) {tag}: from the state after 1100 iterations, "
            f"{w['tier']} {fmt_list(ms['winner'])} ms/iteration, "
            f"{today} {fmt_list(ms['today'])} (in turns) [{self.card}]")
        return ms

    def tune_phase(self):
        """Phase 25: the perf ledger and the autotuner, with the ledger and
        the tuning cache in a temporary directory.  (a) `autotune.search`
        at n_inner = steps_multi on phase 6's, 12's, 15's and 10's grids,
        every candidate logged; (b) the cache saved, `reset()`, loaded,
        and each factory built with `tune="auto"`: no search dispatch, the
        winner's tier served, one call bitwise the factory pinned to the
        winner with `tune=False`, and `tune=False` serving today's rule;
        (c) `perf.best` of each family, the roofline gauges of each
        non-chunk winner (at most 100% of the card's peak), one
        `cost_model_drift` from `calibrate` under `stale_calibration`, and
        a 20-window `run_resilient` over phase 6's chunk route whose
        windows the ledger credits to the serving tier, with no sync
        warning beyond the same run with `IGG_PERF=0`.  `perf.reset()` and
        `autotune.reset()` at the end, so nothing later sees a winner."""
        import shutil
        import tempfile
        import warnings

        from igg_torch import autotune, chaos, degrade, perf
        from igg_torch import telemetry as tel

        it, t3 = self.it, self.t3
        steps = self.steps_multi
        tmp = tempfile.mkdtemp(prefix="igg_tune_")
        saved = {k: os.environ.get(k) for k in ("IGG_PERF_LEDGER",
                                                "IGG_TUNE_CACHE", "IGG_PERF")}
        os.environ["IGG_PERF_LEDGER"] = os.path.join(tmp, "ledger.json")
        os.environ["IGG_TUNE_CACHE"] = os.path.join(tmp, "tune.json")
        os.environ.pop("IGG_PERF", None)
        perf.reset()
        autotune.reset()
        out = {"search": {}, "served": {}, "gauges": {}}
        t_phase = time.perf_counter()
        try:
            cases = self.tune_cases()
            winners = {}
            # (a) The search on each grid.
            for tag, fam, (n, kw), fields, make, today in cases:
                self.grid(n, **kw)
                if fam == "shallow_water":
                    make()      # registers the spec's family
                tel._ring().clear()
                t0 = time.perf_counter()
                w = autotune.search(fam, n_inner=steps)
                secs = time.perf_counter() - t0
                recs = [r for r in tel.flight_recorder() if r.kind in (
                    "autotune_sample", "autotune_candidate_failed",
                    "overlap_demoted")]
                failed = [r.payload for r in recs
                          if r.kind == "autotune_candidate_failed"]
                demoted = [r.payload for r in recs
                           if r.kind == "overlap_demoted"]
                if failed or w is None:
                    raise SmokeFailure(f"[phase 25] {tag}: search failed: "
                                       f"{failed}")
                rows = []
                for r in recs:
                    p = r.payload
                    if r.kind == "autotune_sample":
                        rows.append(dict(candidate=p["candidate"],
                                         quick_ms=p["quick_ms_per_step"],
                                         ms=p["ms_per_step"],
                                         cutoff=p["cutoff"]))
                        log(f"[phase 25] (a) {tag}: {p['candidate']} quick "
                            f"{p['quick_ms_per_step']:.4f}, slope "
                            f"{p['ms_per_step']:.4f} ms/step"
                            f"{' (cut off)' if p['cutoff'] else ''}")
                    else:
                        log(f"[phase 25] (a) {tag}: overlap_demoted "
                            f"{json.dumps(p)}")
                label = autotune._cand_label(w)
                log(f"[phase 25] (a) {tag}: winner {label} at "
                    f"{w['ms']:.4f} ms/step (today's rule serves {today}); "
                    f"search {secs:.1f} s, {autotune.search_dispatches()} "
                    f"search dispatches so far [{self.card}]")
                winners[fam] = w
                out["search"][fam] = dict(candidates=rows, winner=label,
                                          winner_ms=w["ms"], seconds=secs,
                                          today=today, demoted=demoted)
            # (b) Serve from the loaded cache.
            if autotune.save() is None:
                raise SmokeFailure("[phase 25] (b) the cache was not saved")
            autotune.reset()
            n_loaded = autotune.load()
            if n_loaded != len(cases):
                raise SmokeFailure(f"[phase 25] (b) {n_loaded} cache entries "
                                   f"loaded, expected {len(cases)}")
            for tag, fam, (n, kw), fields, make, today in cases:
                self.grid(n, **kw)
                S = fields()
                tuned = make(tune="auto")
                got = tuned(*(a.clone() for a in S))
                if autotune.search_dispatches() != 0:
                    raise SmokeFailure(f"[phase 25] (b) {tag}: "
                                       f"{autotune.search_dispatches()} "
                                       f"search dispatches from the cache")
                w = winners[fam]
                served = degrade.active()[fam]
                if served != w["tier"]:
                    raise SmokeFailure(f"[phase 25] (b) {tag}: {served} "
                                       f"served, the winner is {w['tier']}")
                want = make(**autotune._knobs(fam, w))(
                    *(a.clone() for a in S))
                torch.cuda.synchronize()
                err = max(check(f"{tag}: tuned vs pinned {k}", a, b, 0.0)
                          for k, (a, b) in enumerate(zip(got, want)))
                make(tune=False)(*(a.clone() for a in S))
                rule = degrade.active()[fam]
                if rule != today:
                    raise SmokeFailure(f"[phase 25] (b) {tag}: tune=False "
                                       f"served {rule}, today's rule {today}")
                log(f"[phase 25] (b) {tag}: tune='auto' from the loaded "
                    f"cache served {served} with 0 search dispatches, "
                    f"bitwise the factory pinned to {autotune._cand_label(w)} "
                    f"(max abs err {err:.1e}); tune=False served {rule}")
                out["served"][fam] = dict(tier=served, today=rule)
                # (c) The gauges of a non-chunk winner: one slope-timed
                # sample of the served factory, per step, sets them.
                if perf.bytes_per_step(fam, w["tier"], (1,),
                                       "float32") is not None:
                    tel.reset_metrics()
                    _, sec = it.time_steps(tuned, tuple(a.clone() for a in S),
                                           n1=2, n2=6, warmup=1)
                    ctx = autotune._context(fam)     # the search's key
                    perf.record(fam, w["tier"], sec * 1e3 / steps,
                                source="calibrate",
                                local_shape=ctx["local_shape"],
                                dtype="float32", dims=ctx["dims"],
                                backend=ctx["backend"],
                                device_kind=ctx["device_kind"])
                    snap = tel.snapshot()
                    lab = f'{{family="{fam}",tier="{w["tier"]}"}}'
                    gbps = snap[f"igg_achieved_gbps{lab}"]["value"]
                    pct = snap.get(f"igg_pct_hbm_peak{lab}", {}).get("value")
                    log(f"[phase 25] (c) {tag}: {w['tier']} at "
                        f"{sec * 1e3 / steps:.4f} ms/step: igg_achieved_gbps "
                        f"{gbps:.1f} GB/s, igg_pct_hbm_peak {pct} % "
                        f"[{self.card}]")
                    if pct is None and self.dev.type != "cuda":
                        pct = 0.0    # a CPU has no peak (the rehearsal)
                    elif pct is None or not 0 < pct <= 100:
                        raise SmokeFailure(f"[phase 25] (c) {tag}: "
                                           f"{pct:.2f}% of the card's peak")
                    out["gauges"][fam] = dict(gbps=gbps, pct=pct)
                if fam == "stokes3d":
                    out["stokes_relaxed"] = self.tune_relaxed(
                        tag, S, tuned, make(tune=False), w, today)
                del S, got, want
            # (c) The ledger's best entry of each family.
            for fam in winners:
                b = perf.best(fam, backend=self.dev.type)
                log(f"[phase 25] (c) perf.best({fam!r}): {b['tier']} "
                    f"{'x'.join(map(str, b['local_shape']))} best "
                    f"{b['best_ms']:.4f} ms, {b['count']} samples "
                    f"{b['sources']}")
            # (c) Stale calibration: `calibrate` measures the family's
            # default step (one step a call), then, under a prediction ten
            # times that, one more `calibrate` emits one cost_model_drift.
            tag, fam, (n, kw), *_ = cases[0]
            self.grid(n, **kw)
            true_s = perf.calibrate(fam, nt=2)
            tel._ring().clear()
            with chaos.stale_calibration(fam, 10 * true_s):
                perf.calibrate(fam, nt=2)
            drifts = [r.payload for r in tel.flight_recorder()
                      if r.kind == "cost_model_drift"]
            if len(drifts) != 1:
                raise SmokeFailure(f"[phase 25] (c) {len(drifts)} "
                                   f"cost_model_drift events: {drifts}")
            log(f"[phase 25] (c) calibrate({fam!r}) {true_s * 1e3:.4f} ms "
                f"a call, then stale_calibration({fam!r}, 10 x that) and "
                f"calibrate: one "
                f"cost_model_drift ({drifts[0]['tier']}, rel_error "
                f"{drifts[0]['rel_error']:+.3f}, tol {drifts[0]['tol']})")
            out["drift"] = drifts[0]
            # (c) run_resilient over phase 6's chunk route, 20 windows,
            # with and without the ledger.
            T, Cp = t3.init_fields(t3.Params())
            step = t3.make_multi_step(steps, t3.Params(), tune=False)

            def fn(s):
                return {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}

            def resilient(windows):
                torch.cuda.synchronize()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        it.run_resilient(fn, {"T": T, "Cp": Cp},
                                         windows * steps,
                                         steps_per_call=steps,
                                         watch_every=steps,
                                         install_sigterm=False)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                return [f"{os.path.basename(w.filename)}:{w.lineno}"
                        for w in caught if "called a synchronizing CUDA "
                        "operation" in str(w.message)]

            def watchdog_samples():
                e = perf.best("diffusion3d", tier="diffusion3d.cuda",
                              local_shape=(self.n_multi,) * 3,
                              backend=self.dev.type)
                return e["sources"].get("watchdog", 0) if e else 0

            windows = 20
            resilient(2)
            before = watchdog_samples()
            tel._ring().clear()
            on = resilient(windows)
            credited = watchdog_samples() - before
            # The windows the ledger must credit: each `step_stats` window
            # (a rate between two fetches) in which a step was dispatched
            # since the window before it.  The first fetch only anchors,
            # probes drained back to back give no rate, and a drained
            # probe after the last dispatch has no tier to credit: at most
            # 1 + max_pending_probes (4) windows go uncredited.
            rated = [r.step + r.payload["fetch_lag_steps"]
                     for r in tel.flight_recorder() if r.kind == "step_stats"]
            due = sum(1 for i, cur in enumerate(rated)
                      if i == 0 or cur > rated[i - 1])
            os.environ["IGG_PERF"] = "0"
            try:
                off = resilient(windows)
            finally:
                os.environ.pop("IGG_PERF")
            if (credited != due or credited < windows - 5
                    or degrade.active()["diffusion3d"] != "diffusion3d.cuda"):
                raise SmokeFailure(
                    f"[phase 25] (c) run_resilient: {credited} of {windows} "
                    f"windows credited to diffusion3d.cuda, {due} due "
                    f"({len(rated)} rated windows)")
            if len(on) > len(off):
                raise SmokeFailure(f"[phase 25] (c) sync warnings with the "
                                   f"ledger {on}, without {off}")
            log(f"[phase 25] (c) run_resilient, {windows} windows of {steps} "
                f"steps over phase 6's chunk route: {credited} windows "
                f"credited to diffusion3d.cuda (source watchdog), all "
                f"{due} due; skipped {windows - len(rated)} with no rate "
                f"(the first fetch anchors, drained fetches under 0.1 ms "
                f"apart) and {len(rated) - due} drained after the last "
                f"dispatch; sync warnings {len(on)} with the ledger, "
                f"{len(off)} with IGG_PERF=0")
            out["resilient"] = dict(windows=windows, rated=len(rated),
                                    due=due, credited=credited,
                                    sync_on=len(on), sync_off=len(off))
            del T, Cp
            perf.save()
            ledger = perf._read_ledger_file(os.environ["IGG_PERF_LEDGER"])
            out["ledger_entries"] = len(ledger)
        finally:
            perf.reset()
            autotune.reset()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            shutil.rmtree(tmp, ignore_errors=True)
        out["seconds"] = time.perf_counter() - t_phase
        log(f"[phase 25] done in {out['seconds']:.1f} s; the ledger file held "
            f"{out['ledger_entries']} entries [{self.card}]")
        self.perf["autotune"] = out

    # -- phase 26: comm observability ------------------------------------
    def comm_phase(self):
        """Phase 26 (module docstring): `igg_torch.comm` on the card."""
        import tempfile

        t_phase = time.perf_counter()
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            out["calibrate"] = self.comm_calibrate()
            out["decompose"] = self.comm_decompose()
            out["confirm"] = self.comm_confirm()
            out["monitor"] = self.comm_monitor()
            out["heartbeat"] = self.comm_heartbeat(tmp)
            out["straggler"] = self.comm_straggler()
        counts = self.ops.launch_counts()
        idle = [k for k in ("halo_write", "pack_planes") if not counts[k]]
        if idle:
            raise SmokeFailure(f"phase 26 did not launch {idle}")
        out["seconds"] = time.perf_counter() - t_phase
        log(f"[phase 26] done in {out['seconds']:.1f} s [{self.card}]")
        self.perf["comm"] = out

    def comm_calibrate(self):
        """(a) `calibrate_comm` on a seeded field of phase 7's and phase
        5's grids, f32 and f64."""
        from igg_torch import comm
        from igg_torch import telemetry as tel

        it, m, n = self.it, self.n_multi, self.n_head
        out = {}
        for phase, local, kw in ((7, (m, m, m), dict(dimx=2, dimy=2, dimz=2)),
                                 (5, (n, n, n), dict(**SINGLE, **PERIODIC))):
            for dtype in (torch.float32, torch.float64):
                g = self.grid(local, **kw)
                tag = f"{'x'.join(map(str, local))} {kw} {dtype}"
                X = uniform(it.stacked_shape(g.nxyz), -1, 1, dtype, self.dev,
                            26)
                want = it.update_halo(X.clone(), plain=True)
                total, by_mode = comm.plane_bytes_model(g.nxyz, dtype)
                name = "igg_halo_plane_bytes_total"
                before = tel.snapshot().get(name, {}).get("value", 0.0)
                it.update_halo(X.clone())
                delta = tel.snapshot()[name]["value"] - before
                if delta != total:
                    raise SmokeFailure(f"[phase 26] (a) {tag}: the counter "
                                       f"moved {delta}, the model {total}")
                s = comm.calibrate_comm(fields=(X,), n_inner=10, nt=4)
                sync(self.dev)
                err = check(f"[phase 26] (a) {tag}: calibrated field", X,
                            want, 0.0)
                pct = [k for k in tel.snapshot()
                       if k.startswith("igg_pct_link_peak")]
                if s["pct_link_peak"] is not None or pct:
                    raise SmokeFailure(f"[phase 26] (a) {tag}: a link-peak "
                                       f"percentage with no wire byte")
                key = "" if g.dims == (1, 1, 1) else \
                    "_" + "x".join(map(str, g.dims))
                prior = self.perf.get(f"update_halo{key}_{dtype}", {})
                us = s["seconds_per_update"] * 1e6
                log(f"[phase 26] (a) {tag}: calibrate_comm {us:.2f} us per "
                    f"update (phase {phase}'s update_halo "
                    f"{prior.get('us_per_call', float('nan')):.2f} us/call), "
                    f"igg_halo_gbps {s['gbps']:.2f} over "
                    f"{s['bytes_per_update']} logical bytes a block "
                    f"({s['gbps'] * g.nprocs:.2f} GB/s over the card's "
                    f"{g.nprocs} blocks), tier "
                    f"{s['tier']}; the counter's delta over one update_halo "
                    f"{int(delta)} = plane_bytes_model {dict(by_mode)}; "
                    f"link peak {s['link_peak_gbps']} GB/s, wire bytes "
                    f"{s['wire_bytes_per_update']}, no igg_pct_link_peak; "
                    f"calibrated field vs update_halo(plain=True) "
                    f"{err:.1e} (tolerance 0) [{self.card}]")
                out[tag] = dict(us_per_update=us, gbps=s["gbps"],
                                bytes_per_update=s["bytes_per_update"],
                                counter_delta=delta,
                                update_halo_us=prior.get("us_per_call"))
                del X, want
        return out

    def comm_decompose(self):
        """(b) `decompose` of diffusion at 510^3 and of Stokes at 509^3,
        one iteration of each variant checked bitwise first."""
        from igg_torch import comm

        it, m = self.it, self.n_multi
        blocks = dict(dimx=2, dimy=2, dimz=2)
        ovl = self.perf.get("overlap", {})
        out = {}
        for key, family, unit in (("diffusion", "diffusion3d", "step"),
                                  ("stokes", "stokes3d", "iteration")):
            mv = comm.model_step_variants(family)
            self.grid((m, m, m), **blocks, **mv["grid_kwargs"])
            tag = f"{family} {it.nx_g()}^3 open (2x2x2 x {m}^3)"
            S = it.update_halo(*mv["init"](torch.float32))
            nf, r = mv["nf"], mv["radius"]
            outs = {v: comm._build_variant(mv["compute"], nf, v, 1, r)(*S)
                    for v in comm._VARIANTS}
            X = mv["compute"](*S)
            X = tuple(X) if isinstance(X, (tuple, list)) else (X,)
            it.update_halo(*X, plain=True)
            sync(self.dev)
            err = max(max(check(f"[phase 26] (b) {tag}: exchange", a, b, 0.0),
                          check(f"[phase 26] (b) {tag}: hidden", c, a, 0.0))
                      for a, b, c in zip(outs["exchange"], X, outs["hidden"]))
            del outs, X
            d = comm.decompose(mv["compute"], S[:nf], aux=S[nf:], radius=r,
                               nt=2, n_inner=2)
            p24 = ovl.get(key)
            beside = ("phase 24 did not run" if not p24 else
                      f"phase 24's {unit}: sequential "
                      f"{fmt_list(p24['sequential_ms_per_unit'])}, "
                      f"overlapped {fmt_list(p24['overlapped_ms_per_unit'])}")
            eff = d.get("overlap_efficiency")
            log(f"[phase 26] (b) {tag}: decompose ms per {unit}: compute "
                f"{d['compute_ms']:.4f}, exchange {d['exchange_ms']:.4f}, "
                f"hidden {d['hidden_ms']:.4f}; exposed-comm fraction "
                f"{d['exposed_comm_fraction']:.4f}, overlap efficiency "
                f"{'-' if eff is None else format(eff, '.4f')} ({beside}); "
                f"one iteration of each variant: exchange vs compute + "
                f"update_halo(plain=True), hidden vs exchange, max abs err "
                f"{err:.1e} (tolerance 0) [{self.card}]")
            out[key] = dict(d, bitwise_err=err)
            del S
        return out

    def comm_confirm(self):
        """(c) The search's overlap confirmation at 510^3, and phase 25's
        demotions."""
        from igg_torch import autotune, perf

        m = self.n_multi
        self.grid((m, m, m), dimx=2, dimy=2, dimz=2)
        kept, d = autotune._overlap_confirmed("diffusion3d", None,
                                              self.steps_multi)
        stem = "overlap.diffusion3d.overlap."
        entries = sorted((e["tier"], e["best_ms"]) for e in perf.query("comm")
                         if e["tier"].startswith(stem))
        if len(entries) != 3 or d is None:
            raise SmokeFailure(f"[phase 26] (c) ledger entries {entries}")
        log(f"[phase 26] (c) autotune._overlap_confirmed('diffusion3d') at "
            f"{self.it.nx_g()}^3: {'kept' if kept else 'demoted'} (hidden "
            f"{d['hidden_ms']:.4f} against exchange {d['exchange_ms']:.4f} "
            f"ms per step); ledger "
            f"{', '.join(f'{t} {ms:.4f} ms' for t, ms in entries)} "
            f"[{self.card}]")
        search = self.perf.get("autotune", {}).get("search", {})
        for fam, row in search.items():
            demoted = (json.dumps(row["demoted"]) if row.get("demoted")
                       else "none (no overlapped winner)")
            log(f"[phase 26] (c) phase 25's search of {fam}: winner "
                f"{row['winner']}; overlap_demoted {demoted}")
        return dict(kept=kept, entries=entries,
                    demoted={f: r.get("demoted") for f, r in search.items()})

    def comm_monitor(self):
        """(d) `run_resilient` over phase 23's 256^3 chunk route with and
        without a StepDecomposition, in turns; sync warnings."""
        import warnings

        from igg_torch import comm
        from igg_torch import telemetry as tel

        it, n, steps = self.it, self.n_head, self.steps_multi
        self.grid((n, n, n), **SINGLE, **PERIODIC)
        T, Cp, fn, _ = self.resilient_state(multi=True)
        mv = comm.model_step_variants("diffusion3d")
        watch = 2 * steps

        def run(monitored, windows):
            mon = (comm.StepDecomposition(mv["compute"], (T,), aux=(Cp,),
                                          reps=1) if monitored else None)
            tel._ring().clear()
            sync(self.dev)
            t0 = time.perf_counter()
            res = it.run_resilient(fn, {"T": T, "Cp": Cp}, windows * watch,
                                   steps_per_call=steps, watch_every=watch,
                                   comm=mon, install_sigterm=False)
            sync(self.dev)
            ms = (time.perf_counter() - t0) / (windows * watch) * 1e3
            stats = [r.payload for r in tel.flight_recorder()
                     if r.kind == "comm_stats"]
            if mon is not None and len(stats) != mon.windows:
                raise SmokeFailure(f"[phase 26] (d) {len(stats)} comm_stats "
                                   f"records, {mon.windows} windows")
            return res.state["T"], ms, stats

        windows = 120
        run(False, 4)
        run(True, 4)
        turns = {False: [], True: []}
        finals, stats = [], []
        for monitored in (False, True, True, False):
            Tn, ms, st = run(monitored, windows)
            turns[monitored].append(ms)
            finals.append(Tn)
            if monitored:
                stats.append(st)
        err = max(check(f"[phase 26] (d) final T, run {i}", a, finals[0], 0.0)
                  for i, a in enumerate(finals))
        got = min(len(st) for st in stats)
        if got < 3:
            raise SmokeFailure(f"[phase 26] (d) {got} comm_stats windows")
        last = stats[-1][-1]
        eff = last.get("overlap_efficiency")
        log(f"[phase 26] (d) {n}^3 periodic, make_multi_step({steps}), "
            f"watch_every={watch}, {windows} windows: ms/step in turns bare "
            f"loop {fmt_list(turns[False])}, with comm=StepDecomposition "
            f"{fmt_list(turns[True])} "
            f"({(min(turns[True]) / min(turns[False]) - 1) * 100:+.2f}%); "
            f"comm_stats windows {[len(st) for st in stats]}; the last: "
            f"compute {last['compute_ms']:.4f}, exchange "
            f"{last['exchange_ms']:.4f}, hidden {last['hidden_ms']:.4f} ms "
            f"a step, exposed {last['exposed_comm_fraction']:.4f}, "
            f"efficiency {'-' if eff is None else format(eff, '.4f')}, "
            f"config {last.get('config')}; final T with and without the "
            f"monitor max abs err {err:.1e} (tolerance 0) [{self.card}]")
        warned = {}
        for monitored in (False, True):
            mon = (comm.StepDecomposition(mv["compute"], (T,), aux=(Cp,),
                                          reps=1) if monitored else None)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    it.run_resilient(fn, {"T": T, "Cp": Cp}, 10 * watch,
                                     steps_per_call=steps, watch_every=watch,
                                     comm=mon, install_sigterm=False)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            warned[monitored] = [
                f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
        if len(warned[True]) != len(warned[False]):
            raise SmokeFailure(f"[phase 26] (d) sync warnings with the "
                               f"monitor {warned[True]}, without "
                               f"{warned[False]}")
        log(f"[phase 26] (d) ten windows under set_sync_debug_mode('warn'): "
            f"{len(warned[True])} sync warnings with the monitor, "
            f"{len(warned[False])} without ({sorted(set(warned[True]))})")
        return dict(ms_per_step=turns, windows=[len(st) for st in stats],
                    last=last, sync_warnings={k: len(v) for k, v in
                                              warned.items()})

    def comm_heartbeat(self, tmp):
        """(e) The stall heartbeat under `chaos.collective_stall()` with a
        0.5 s timeout; a healthy run at the default timeout; its overhead
        at 128^3 `make_step`."""
        from igg_torch import chaos
        from igg_torch import telemetry as tel

        it, n, steps = self.it, self.n_head, self.steps_multi
        self.grid((n, n, n), **SINGLE, **PERIODIC)
        T, Cp, fn, _ = self.resilient_state(multi=True)
        calls = 60
        ref = self.run_calls(fn, {"T": T, "Cp": Cp}, calls)["T"]

        def slow(s):
            time.sleep(0.02)
            return fn(s)

        def events(d):
            with open(os.path.join(d, "events_r0.jsonl")) as f:
                return [json.loads(line) for line in f]

        out = {}
        stalled_dir = os.path.join(tmp, "stall")
        os.environ["IGG_COMM_STALL_TIMEOUT"] = "0.5"
        try:
            with chaos.collective_stall():
                res = it.run_resilient(slow, {"T": T, "Cp": Cp},
                                       calls * steps, steps_per_call=steps,
                                       watch_every=steps,
                                       max_pending_probes=100,
                                       telemetry=stalled_dir,
                                       install_sigterm=False)
        finally:
            del os.environ["IGG_COMM_STALL_TIMEOUT"]
        err = check("[phase 26] (e) the stalled run's T", res.state["T"], ref,
                    0.0)
        stalls = [r for r in events(stalled_dir)
                  if r["kind"] == "collective_stall"]
        report = os.path.join(stalled_dir, "stall_r0.json")
        dumps = tel.flight_dumps(stalled_dir, rank=0)
        if len(stalls) != 1 or not os.path.exists(report) or not dumps:
            raise SmokeFailure(f"[phase 26] (e) {len(stalls)} stalls, report "
                               f"{os.path.exists(report)}, dumps {dumps}")
        p = stalls[0]["payload"]
        log(f"[phase 26] (e) IGG_COMM_STALL_TIMEOUT=0.5 under "
            f"chaos.collective_stall(), {calls} calls of 20 ms sleep + "
            f"make_multi_step({steps}): one collective_stall at step "
            f"{stalls[0]['step']} ({p['in_flight']}, age {p['age_s']} s, "
            f"{p['pending']} pending), stall_r0.json, "
            f"{os.path.basename(str(dumps[0]))}; final T vs the "
            f"uninterrupted run {err:.1e} (tolerance 0)")
        out["stall"] = dict(step=stalls[0]["step"], age_s=p["age_s"],
                            pending=p["pending"])
        healthy_dir = os.path.join(tmp, "healthy")
        it.run_resilient(fn, {"T": T, "Cp": Cp}, calls * steps,
                         steps_per_call=steps, watch_every=steps,
                         telemetry=healthy_dir, install_sigterm=False)
        quiet = not [r for r in events(healthy_dir)
                     if r["kind"] == "collective_stall"]
        if not quiet or os.path.exists(os.path.join(healthy_dir,
                                                    "stall_r0.json")):
            raise SmokeFailure("[phase 26] (e) a healthy run reported a stall")
        log("[phase 26] (e) a healthy run at the default timeout (120 s): "
            "no collective_stall, no stall_r0.json")
        # The heartbeat's cost on the host-bound loop.
        self.grid((N_OVERHEAD,) * 3, **SINGLE, **PERIODIC)
        T, Cp, fn, _ = self.resilient_state(multi=False)
        n_steps = 3000

        def timed(heartbeat):
            if not heartbeat:
                os.environ["IGG_COMM_STALL_TIMEOUT"] = "0"
            try:
                sync(self.dev)
                t0 = time.perf_counter()
                it.run_resilient(fn, {"T": T, "Cp": Cp}, n_steps,
                                 watch_every=50, watch_fields=["T"],
                                 install_sigterm=False)
                sync(self.dev)
            finally:
                os.environ.pop("IGG_COMM_STALL_TIMEOUT", None)
            return (time.perf_counter() - t0) / n_steps * 1e3

        timed(False), timed(True)
        turns = {False: [], True: []}
        for hb in (False, True) * 5:
            turns[hb].append(timed(hb))
        best = {hb: min(v) for hb, v in turns.items()}
        mid = {hb: float(np.median(v)) for hb, v in turns.items()}
        delta = (best[True] - best[False]) / best[False]
        # The heartbeat's own host work, timed alone: a watch and a fetch
        # a probe, a thread start and join a run.
        from igg_torch import comm

        sw = comm.StallWatchdog(120.0, run="cost")
        t0 = time.perf_counter()
        for i in range(2000):
            sw.watch(("probe", i), i, "cost probe")
            sw.fetched(("probe", i), i)
        per_probe = (time.perf_counter() - t0) / 2000
        sw.close()
        t0 = time.perf_counter()
        for _ in range(20):
            sw = comm.StallWatchdog(120.0, run="cost")
            sw.watch(("probe", 0), 0, "cost probe")
            sw.close()
        per_run = (time.perf_counter() - t0) / 20
        share = (per_probe + per_run / (n_steps // 50)) / \
            (50 * best[False] * 1e-3)
        log(f"[phase 26] (e) {N_OVERHEAD}^3 make_step, watch_every=50, "
            f"{n_steps} steps: ms/step in turns, heartbeat off "
            f"{fmt_list(turns[False])}, on {fmt_list(turns[True])}: "
            f"fastest {delta * 100:+.2f}%, median "
            f"{(mid[True] / mid[False] - 1) * 100:+.2f}%; the heartbeat's "
            f"own host work {per_probe * 1e6:.2f} us a probe and "
            f"{per_run * 1e6:.1f} us a run (thread start and join), "
            f"{share * 100:.3f}% of a 50-step window at the fastest "
            f"(igg's comm_overhead contract < 1%: "
            f"{'met' if share < 0.01 else 'MISSED'}) [{self.card}]")
        out["overhead"] = dict(ms_per_step=turns, delta=delta,
                               us_per_probe=per_probe * 1e6,
                               us_per_run=per_run * 1e6, share=share)
        return out

    def comm_straggler(self):
        """(f) `chaos.straggler(factor=4, after=k)` over a watched run: the
        windows read in the loop after the k-th grant against those
        before.  A grant is a readiness poll the rate limit lets through;
        on the card a granted poll of a probe the device has not finished
        reads it not ready, so grants are timed here (a wrap of the seam's
        predicate), not counted in windows."""
        from igg_torch import chaos, resilience
        from igg_torch import telemetry as tel

        it, n, steps = self.it, self.n_head, self.steps_multi
        self.grid((n, n, n), **SINGLE, **PERIODIC)
        T, Cp, fn, _ = self.resilient_state(multi=True)
        k, calls, base = 16, 60, 0.02
        last, grants = [0.0], []

        def slow(s):
            time.sleep(base)
            out = fn(s)
            last[0] = time.monotonic()
            return out

        tel._ring().clear()
        with chaos.straggler(factor=4.0, base_window_s=base, after=k):
            tap = resilience._CHAOS_FETCH_TAP

            def timed_tap(obj):
                granted = tap(obj)
                if granted:
                    grants.append(time.monotonic())
                return granted

            resilience._CHAOS_FETCH_TAP = timed_tap
            it.run_resilient(slow, {"T": T, "Cp": Cp}, calls * steps,
                             steps_per_call=steps, watch_every=steps,
                             max_pending_probes=100, install_sigterm=False)
        # The first rate-limited grant: windows read before it came through
        # the k free grants.
        t_k = grants[k]
        wins = [(r.t, r.payload["ms_per_step"]) for r in
                tel.flight_recorder()
                if r.kind == "step_stats" and r.t <= last[0]]
        before = [ms for t, ms in wins if t < t_k]
        after = [ms for t, ms in wins if t >= t_k]
        if not before or not after:
            raise SmokeFailure(f"[phase 26] (f) windows {wins}, grant "
                               f"{k + 1} at {t_k}")
        ratio = float(np.median(after)) / float(np.median(before))
        if ratio < 2:
            raise SmokeFailure(f"[phase 26] (f) windows after the grants "
                               f"{after}, before {before}")
        log(f"[phase 26] (f) chaos.straggler(factor=4, base_window_s={base}, "
            f"after={k}) over {calls} calls of {base * 1e3:.0f} ms sleep + "
            f"make_multi_step({steps}), watch_every={steps}: ms/step of the "
            f"windows read in the loop, up to the {k}th grant "
            f"{fmt_list(before)}, after it {fmt_list(after)}; median ratio "
            f"{ratio:.2f}; {len(grants)} grants [{self.card}]")
        return dict(before=before, after=after, ratio=ratio,
                    grants=len(grants))

    # -- phase 27: numeric integrity -------------------------------------
    def integrity_phase(self):
        """Phase 27 (module docstring): `igg_torch.integrity` on the card."""
        import tempfile

        t_phase = time.perf_counter()
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            ring = os.path.join(tmp, "a")
            out["invariant"] = self.integrity_run(ring, periodic=True)
            log(f"[phase 27] (a) {time.perf_counter() - t_phase:.1f} s")
            out["shadow"] = self.integrity_run(os.path.join(tmp, "b"),
                                               periodic=False)
            log(f"[phase 27] (b) {time.perf_counter() - t_phase:.1f} s")
            # PERF.md's table: row 1 the step kernel, 3 the halo writer, 4
            # the plane packer, 5 the chunk step (3-5 expected here).
            counts = self.ops.launch_counts()
            ran = {k: v for k, v in counts.items() if v}
            if not ran:
                raise SmokeFailure("[phase 27] (a), (b) launched no kernel "
                                   "of PERF.md's table")
            log(f"[phase 27] (a), (b) launches {json.dumps(ran)}; rows 3-5 "
                f"(halo_write, pack_planes, diffusion_chunk_step) "
                f"{'all' if all(ran.get(k) for k in ('halo_write', 'pack_planes', 'diffusion_chunk_step')) else 'NOT all'} "
                f"launched")
            out["launches"] = ran
            out["poisoned"] = self.integrity_poisoned(
                ring, out["invariant"]["tag"])
            log(f"[phase 27] (c) {time.perf_counter() - t_phase:.1f} s")
        out["overhead"] = self.integrity_overhead()
        out["seconds"] = time.perf_counter() - t_phase
        log(f"[phase 27] done in {out['seconds']:.1f} s [{self.card}]")
        self.perf["integrity"] = out

    def integrity_state(self, multi: bool):
        """Phase 23's state with a uniform heat capacity (cp_min): total
        heat is then conserved, igg's `total_heat` invariant exact; the
        step closes over Cp, so the state (and each generation) is T."""
        from igg_torch import degrade

        it, t3 = self.it, self.t3
        p = t3.Params()
        T, Cp = t3.init_fields(p)
        T = it.update_halo(T)
        Cp = torch.full_like(Cp, p.cp_min)
        step = t3.make_multi_step(self.steps_multi, p) if multi else \
            t3.make_step(p)
        tiers = set()

        def fn(s):
            out = {"T": step(s["T"], Cp)}
            tiers.add(degrade.active()["diffusion3d"])
            return out

        return T, Cp, fn, tiers

    def integrity_run(self, tmp, periodic: bool):
        """(a) periodic, 508^3: `silent_corruption` at step 80 on block 3
        caught by the `total_heat` invariant at the next probe (102), where
        a cadence generation may hold the corrupted state; (b)
        open, 510^3, no invariant: caught by the shadow re-execution
        (`check_every=1`).  Each rolls back to a deep-verified generation
        older than the violation and ends bitwise the uninterrupted run."""
        from igg_torch import chaos, integrity, resilience
        from igg_torch import checkpoint as ck

        it, n, steps = self.it, self.n_multi, self.steps_multi
        part = "(a)" if periodic else "(b)"
        self.grid((n, n, n), dimx=2, dimy=2, dimz=2,
                  **(PERIODIC if periodic else {}))
        g = it.get_global_grid()
        tag = (f"{it.nx_g()}^3 {'periodic' if periodic else 'open'} "
               f"(2x2x2 x {n}^3)")
        T, Cp, fn, tiers = self.integrity_state(multi=True)
        calls, watch, every, hit = 10, 2 * steps, 6 * steps, 80
        n_steps = calls * steps                          # 170
        scale = float(integrity._moment_sums(T, 1, g, absolute=True).sum())
        magnitude = 1e-2 * scale                         # 10x the tolerance
        t0 = time.perf_counter()
        ref = self.run_calls(fn, {"T": T}, calls)["T"]
        sync(self.dev)
        bare = time.perf_counter() - t0
        cfg = integrity.IntegrityConfig(check_every=0 if periodic else 1)
        scans = []
        real_latest = ck.latest_checkpoint

        def latest(*a, **kw):
            found = real_latest(*a, **kw)
            scans.append((kw.get("deep", False), kw.get("max_step"), found))
            return found

        ck.latest_checkpoint = latest
        try:
            with chaos.silent_corruption("T", step=hit, magnitude=magnitude,
                                         rank=3):
                t0 = time.perf_counter()
                res = it.run_resilient(
                    fn, {"T": T}, n_steps, steps_per_call=steps,
                    watch_every=watch, checkpoint_dir=tmp,
                    checkpoint_every=every, ring=2, integrity=cfg,
                    install_sigterm=False)
                sync(self.dev)
                wall = time.perf_counter() - t0
        finally:
            ck.latest_checkpoint = real_latest
        kinds = [(e.kind, e.step) for e in res.events
                 if e.kind != "checkpoint"]
        viol = [e for e in res.events if e.kind == "integrity_violation"]
        rb = [e for e in res.events if e.kind == "rollback"]
        want_step = (hit // watch + 1) * watch            # 102
        want = ("invariant", "total_heat") if periodic else ("shadow", "T")
        got = [(v.detail["source"], v.detail.get("invariant",
                                                 v.detail.get("field")),
                v.detail["rank"]) for v in viol]
        deep_hit = [f for deep, _, f in scans if deep and f is not None]
        if ("nan_detected" in [k for k, _ in kinds] or len(viol) != 1
                or viol[0].step != want_step or got != [want + (3,)]
                or len(rb) != 1 or not rb[0].step < viol[0].step
                or "integrity_resolved" not in [k for k, _ in kinds]
                or not deep_hit
                or str(deep_hit[0]) != rb[0].detail["path"]
                or res.steps_done != n_steps):
            raise SmokeFailure(f"[phase 27] {part} {tag}: silent corruption "
                               f"at {hit} gave {kinds}, violations {got}, "
                               f"scans {scans}")
        if self.dev.type == "cuda" and any(t.endswith(".plain")
                                           for t in tiers):
            raise SmokeFailure(f"[phase 27] {part} {tag}: the calls were "
                               f"served by {tiers}")
        err = check(f"[phase 27] {part} {tag}: the run vs the "
                    f"uninterrupted run", res.state["T"], ref, 0.0)
        v = viol[0].detail
        log(f"[phase 27] {part} {tag}, make_multi_step({steps}) x {calls}, "
            f"watch_every={watch}, checkpoint_every={every}, "
            f"integrity=IntegrityConfig(check_every={cfg.check_every}): "
            f"silent_corruption('T', step={hit}, magnitude={magnitude:.4g} "
            f"= 1e-2 x sum|T|, rank=3) -> {kinds}; the violation: source "
            f"{v['source']}, {want[1]}, rank {v['rank']} ({v['device']}), "
            f"{'drift %.4g against tol x scale %.4g' % (v['drift'], v['tol'] * v['scale']) if periodic else 'diff %.4g against tol x scale %.4g' % (v['diff'], v['tol'] * v['scale'])}; "
            f"the rollback's scans (deep, max_step, found) "
            f"{[(d, m, os.path.basename(str(f)) if f else None) for d, m, f in scans]}; "
            f"the whole stacked T vs the uninterrupted run {err:.1e} "
            f"(tolerance 0: its gather_interior too); tiers served "
            f"{sorted(tiers)}; wall s: bare {bare:.3f}, integrity run "
            f"{wall:.3f} [{self.card}]")
        out = dict(tag=tag, events=kinds, violation={k: v[k] for k in v
                                            if k != "partials"},
                   partials=v["partials"], bare_s=bare, wall_s=wall,
                   scans=[(d, m, str(f)) for d, m, f in scans])
        # The probes' device time on this grid's T, beside the plain one.
        probes = ({"plain": lambda: resilience.probe_counts(T)} if periodic
                  else {})
        invs = integrity.match_invariants({"T": T}, g)
        for kind in ("steady", "anchor") if invs else ():
            probes[kind] = (lambda f: lambda: f(T))(
                integrity._build_probe(["T"], [], invs, kind))
        if not periodic:
            probes["wide"] = (lambda f: lambda: f(T, ref))(
                integrity._build_probe(["T"], [], [], "wide"))
        split = {k: device_ms_by_kernel(f, 10) for k, f in probes.items()}
        log(f"[phase 27] {part} {tag}: probe device ms (launches) "
            + ", ".join(f"{k} {sum(v[0].values()):.4f} ({v[1]:.0f})"
                        for k, v in split.items())
            + f"; a read of T {bound_ms(T.numel() * 4, 0, F32_FLOPS)[0]:.4f}"
            f" ms [{self.card}]")
        out["probe_ms"] = {k: sum(v[0].values()) for k, v in split.items()}
        if periodic:
            # The default heat capacity is not uniform: sum(T) then drifts
            # by itself (the flux form conserves sum(Cp * T) only).
            T0, Cp0 = self.t3.init_fields(self.t3.Params())
            T0 = it.update_halo(T0)
            step = self.t3.make_multi_step(steps, self.t3.Params())
            s0 = float(integrity._moment_sums(T0, 1, g).sum())
            Tn = T0
            for _ in range(calls):
                Tn = step(Tn, Cp0)
            drift = (float(integrity._moment_sums(Tn, 1, g).sum()) - s0) \
                / float(integrity._moment_sums(T0, 1, g, absolute=True).sum())
            log(f"[phase 27] (a) {tag} with init_fields' own (non-uniform) "
                f"Cp: sum(T) drifts {drift:.4g} of sum|T| over {n_steps} "
                f"steps (tolerance 1e-3)")
            out["default_cp_drift"] = drift
        return out

    def integrity_poisoned(self, ring, tag):
        """(c) The newest 508^3 generation of (a)'s ring (T, stamped with
        the run's `total_heat` reference), poisoned: `verify_checkpoint`
        passes it, `deep=True` refuses it, `latest_checkpoint(deep=True)`
        takes the older one."""
        from igg_torch import chaos
        from igg_torch import checkpoint as ck

        gens = ck.list_generations(ring, "ckpt")
        if len(gens) < 2:
            raise SmokeFailure(f"[phase 27] (c) generations {gens}")
        (_, older), (_, newest) = gens[-2], gens[-1]
        stamp = json.loads((newest / "manifest.json").read_text())[
            "deep"].get("invariants")
        t0 = time.perf_counter()
        clean = ck.verify_checkpoint(newest, deep=True)
        t_clean = time.perf_counter() - t0
        chaos.poison_checkpoint(newest, field="T", magnitude=1e3, shard=3)
        t0 = time.perf_counter()
        plain = ck.verify_checkpoint(newest, check_finite=True)
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        deep = ck.verify_checkpoint(newest, deep=True)
        t_deep = time.perf_counter() - t0
        found = ck.latest_checkpoint(ring, "ckpt", check_finite=True,
                                     deep=True)
        if not (clean and plain and not deep and found == older
                and stamp and stamp[0]["ref"] is not None):
            raise SmokeFailure(f"[phase 27] (c) clean {clean}, plain {plain}"
                               f", deep {deep}, latest {found}, stamp "
                               f"{stamp}")
        nbytes = sum(f.stat().st_size for f in newest.iterdir())
        log(f"[phase 27] (c) {tag}: generation {newest.name} "
            f"({nbytes / 1e9:.3f} GB, stamp {stamp[0]['name']} ref "
            f"{stamp[0]['ref']:.6g} scale {stamp[0]['scale']:.6g}): deep "
            f"verify before the poison {clean} in {t_clean:.3f} s; "
            f"poison_checkpoint(field='T', magnitude=1e3, shard=3): "
            f"verify_checkpoint(check_finite=True) {plain} in "
            f"{t_plain:.3f} s, deep=True {deep} in {t_deep:.3f} s; "
            f"latest_checkpoint(deep=True) -> {found.name} [{self.card}]")
        return dict(deep_verify_s=t_deep, clean_deep_verify_s=t_clean,
                    verify_s=t_plain, bytes=nbytes)

    def integrity_overhead(self):
        """(d) igg's `integrity_overhead` row at 128^3 `make_step`,
        `watch_every=50` (benchmarks/resilience_overhead.py): (steady fused
        probe - plain probe + decode) a window over 50 bare steps; the bare
        loop against `run_resilient` without and with integrity, and with
        shadows every 4 windows, in turns; sync warnings with shadows on.
        Printed, not raised."""
        import warnings

        from igg_torch import integrity, resilience

        it = self.it
        self.grid((N_OVERHEAD,) * 3, **SINGLE, **PERIODIC)
        g = it.get_global_grid()
        T, Cp, fn, _ = self.integrity_state(multi=False)
        watch, n_steps = 50, 300
        inv = integrity.Invariant("total_heat", ("T",), moment=1,
                                  kind="conserved")
        fused = integrity._build_probe(["T"], [], [inv], "steady")
        split_p, _ = device_ms_by_kernel(lambda: resilience.probe_counts(T),
                                         10)
        split_f, launches_f = device_ms_by_kernel(lambda: fused(T), 10)
        probe_ms, fused_ms = sum(split_p.values()), sum(split_f.values())
        mon = integrity.Monitor(
            integrity.IntegrityConfig(invariants=[inv], check_every=4),
            {"T": T}, ["T"], watch, 1)
        anchor = integrity._build_probe(["T"], [], [inv], "anchor")(T)
        mon.decode(anchor.cpu().numpy(), ("anchor", g.nprocs), 0)
        vec = fused(T).cpu().numpy()
        t0 = time.perf_counter()
        for i in range(2000):
            mon.decode(vec, ("steady", g.nprocs), i * watch)
        decode_ms = (time.perf_counter() - t0) / 2000 * 1e3
        mon.close()

        def bare():
            sync(self.dev)
            t0 = time.perf_counter()
            self.run_calls(fn, {"T": T}, n_steps)
            sync(self.dev)
            return (time.perf_counter() - t0) / n_steps * 1e3

        def watched(check_every):
            cfg = (False if check_every is None else
                   integrity.IntegrityConfig(invariants=[inv],
                                             check_every=check_every))
            sync(self.dev)
            t0 = time.perf_counter()
            res = it.run_resilient(fn, {"T": T}, n_steps, watch_every=watch,
                                   integrity=cfg, install_sigterm=False)
            sync(self.dev)
            if res.steps_done != n_steps or [e for e in res.events
                                             if e.kind != "checkpoint"]:
                raise SmokeFailure(f"[phase 27] (d) {res.events}")
            return (time.perf_counter() - t0) / n_steps * 1e3

        runs = {"bare": bare, "off": lambda: watched(None),
                "invariant": lambda: watched(0),
                "shadow_4": lambda: watched(4)}
        for f in runs.values():
            f()
        turns = {k: [] for k in runs}
        for _ in range(3):
            for k, f in runs.items():
                turns[k].append(f())
        best = {k: min(v) for k, v in turns.items()}
        pct = (max(0.0, fused_ms - probe_ms) + decode_ms) / \
            (watch * best["bare"]) * 100
        warned = {}
        for on in (False, True):
            cfg = (integrity.IntegrityConfig(invariants=[inv], check_every=1)
                   if on else False)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    it.run_resilient(fn, {"T": T}, 10 * watch,
                                     watch_every=watch, integrity=cfg,
                                     install_sigterm=False)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            warned[on] = [
                f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
        log(f"[phase 27] (d) {N_OVERHEAD}^3 periodic make_step, "
            f"watch_every={watch}: the plain probe {probe_ms:.4f} ms device, "
            f"the steady fused probe (count + total_heat partials) "
            f"{fused_ms:.4f} ms device, {launches_f:.0f} launches "
            f"{json.dumps(split_f)}; decode {decode_ms * 1e3:.2f} us; "
            f"(fused - plain + decode) / (50 bare steps of "
            f"{best['bare']:.4f} ms) = {pct:.3f}% (igg's integrity_overhead "
            f"contract < 1%: {'met' if pct < 1 else 'MISSED'}) "
            f"[{self.card}]")
        log(f"[phase 27] (d) ms/step in turns over {n_steps} steps: bare "
            f"{fmt_list(turns['bare'])}, run_resilient integrity off "
            f"{fmt_list(turns['off'])}, invariant probes "
            f"{fmt_list(turns['invariant'])}, with shadows every 4 windows "
            f"{fmt_list(turns['shadow_4'])}: invariants "
            f"{(best['invariant'] / best['off'] - 1) * 100:+.2f}% and "
            f"shadows {(best['shadow_4'] / best['off'] - 1) * 100:+.2f}% "
            f"over the watched loop (igg's shadow_amortized_pct 25% = 1 / "
            f"check_every); sync warnings over 10 windows with shadows every "
            f"window {len(warned[True])}, without integrity "
            f"{len(warned[False])} ({sorted(set(warned[True]))}) "
            f"[{self.card}]")
        if len(warned[True]) != len(warned[False]):
            raise SmokeFailure(f"[phase 27] (d) sync warnings with integrity "
                               f"{warned[True]}, without {warned[False]}")
        return dict(plain_probe_ms=probe_ms, fused_probe_ms=fused_ms,
                    fused_split=split_f, decode_ms=decode_ms, pct=pct,
                    ms_per_step=turns,
                    sync_warnings={k: len(v) for k, v in warned.items()})

    def main_path(self):
        """Phases 2 to 27, each with the launch counters set to 0 just
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
            ("20", self.relax3d_banded), ("21", self.observability),
            ("22", self.checkpoint_phase), ("23", self.resilience_phase),
            ("24", self.overlap_phase), ("25", self.tune_phase),
            ("26", self.comm_phase), ("27", self.integrity_phase)]
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
    no_ring = cases.start_no_ring(cases.SPECS_3D)
    reports = _build.build_all(generated=[(g.source, g.tag)
                                          for g in generated])
    first = finish_first_designs(first)
    no_ring = cases.finish_no_ring(no_ring)
    log(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(and the first designs of {sorted(first)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    smoke = Smoke(torch.device("cuda"))
    smoke.card = card
    smoke.first = first
    smoke.first_gen = {n: first[f"gen:{cases.kernels(n).tag}"]
                       for n in cases.SPECS_3D}
    smoke.no_ring = no_ring
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
