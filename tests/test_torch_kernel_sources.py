"""The port's step and chunk kernels' CUDA sources, run on the CPU.

`igg_torch/csrc` is compiled here as C++ with g++ against a small header
that stands in for the CUDA runtime (a launch becomes loops over every
block and thread, run one after another; `-ffp-contract=off`, so no
operation is fused and each rounds as in IEEE arithmetic, like the
`-fmad=false` card build).  The wrappers' `_launch` functions then drive
those libraries with CPU tensors, and every kernel is held against its
plain PyTorch version, tolerance 0, in every halo and window mode, f32 and
f64: the diffusion, HM3D and wave2d step kernels and the Stokes iteration
(the K-step loops launch the same kernels), the diffusion, HM3D, wave2d
and Stokes chunk kernels, and the kernels generated from stencil specs
(`igg_torch/stencil/cuda.py`: the step and the chunk step of shallow water
with and without friction, spec-wave2d, a spec of `pow`, `where` and
scalar divisions, and the rank-3 `relax3d`), spec-wave2d also against the
hand-written wave2d kernels, the plane packer (2-, 4- and 8-byte
elements, rows not 16-byte aligned), the Stokes chunk kernel's x-march
(`csrc/stokes_march.cuh`: a thread block's threads as fibers, its
`cp.async` staging as plain copies; whole extended buffers across several
tiles) and its division (`csrc/const_div.cuh`, float32 and float64,
against `x / d` over samples of all bit patterns, for the Stokes and the
HM3D divisors, the HM3D chunk kernel's among them), the diffusion band
kernel (its x-march, `csrc/diffusion_march.cuh`, whose threads share
staged planes: each thread block's threads run as fibers that switch at
`__syncthreads`), the HM3D band and chunk kernels (the x-march of
`csrc/hm3d_march.cuh` with the band's and the chunk's edge rules,
`csrc/march_layout.cuh`), the Stokes band kernel (the Stokes march's band
mode) and the generated band entry of `relax3d` and the staggered
`acoustic3d` (its x-march, `csrc/stagger_band_march3.cuh`) in every
window mode, at B = 8 and 16 in two and three bands, on their whole
evolved buffers; the in-place halo writer (`csrc/halo_write.cu`) in every
WRAP/EXT/NONE mix on ranks 1-3, 2-, 4- and 8-byte elements, with its
thread blocks run in both orders (`EMU_REVERSE`: a kind of plane that
reads or writes what another writes shows in one of them); the five
marches also in their edge cases:
segments that cross the bands (built with shorter segments), tiles that
cross the blocks' last y and z rows, and fields at rest (the HM3D chunk
and diffusion band marches in every layout of the chunk and band
meshes); and the redesigned kernels' first designs, kept as text in
kernel_variants.py to be timed beside them, against the plain versions
too.  This
checks the kernels' indexing, walks and arithmetic, not their
CUDA-specific parts (vector loads, alignment, the launch), which
`tests/test_torch_kernels.py` checks on a card.  Skips without g++.

The rehearsal runs in several files, so that no one file is the test
run's critical path under `--dist loadfile`: this one (the step kernels,
the packer, the halo writer, the diffusion and HM3D band kernels, wave2d,
the Stokes step kernel and divisions, the first designs),
`_chunk.py` (the diffusion and HM3D chunk kernels), `_stokes.py` (the
Stokes chunk kernel), `_stokes_band.py` (the Stokes band kernel and its
edge cases), `_edges.py` (the HM3D, diffusion and Stokes step marches'
edge cases) and `_spec.py` (the generated kernels); the stand-in runtime,
fixtures and case tables are in tests/torch_kernel_emulation.py.
"""

import numpy as np
import pytest
import torch

import igg_torch as it
import torch_halo_cases as halo_cases
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import diffusion_pallas as dp
from igg_torch.ops import diffusion_trapezoid as dtz
from igg_torch.ops import halo_write as hw
from igg_torch.ops import hm3d_pallas as hp
from igg_torch.ops import hm3d_trapezoid as htz
from igg_torch.ops import pack as pk
from igg_torch.ops import stokes_pallas as sp
from igg_torch.ops import stokes_trapezoid as stz
from igg_torch.ops import wave2d_pallas as wp
from igg_torch.ops import wave2d_trapezoid as wtz
from torch_threads import one_torch_thread  # noqa: F401
from torch_kernel_emulation import (  # noqa: F401
    BAND_GRIDS, GRIDS, HM3D_KW, SC, STOKES_KW, WAVE_GRIDS, WAVE_KW, _random,
    _run_band, _run_chunk, _run_stag_band, _stokes_grid, _stokes_state,
    _wave_grid, _wave_state, csrc, emulated, first_designs, generated,
    halo_reversed, libs, same)


# (12, 10, 33): odd z extents, the element path; (10, 12, 8): whole 16-byte
# vectors in every z row of f32 and f64, the vector path.
@pytest.mark.parametrize("local", [(12, 10, 33), (10, 12, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_step_kernels_match_plain(emulated, case, dtype, local):
    it.init_global_grid(*local, quiet=True, device="cpu", **GRIDS[case])
    g = it.get_global_grid()
    shp = it.stacked_shape(g.nxyz)
    modes = dp.step_modes(g)
    T, A = _random(shp, dtype, -10, 10, 1), _random(shp, dtype, 0.01, 0.1, 2)
    recv = dp.step_recv_planes(T, A, g, modes, SC)
    out = torch.empty_like(T)
    dp._launch(T, A, out, modes, recv, g.dims, g.nxyz, SC, 0)
    same(out, dp.step_plain(T, A, modes, recv, g.dims, SC))
    Pe, phi = (_random(shp, dtype, -0.5, 0, 3),
               _random(shp, dtype, 0.05, 0.25, 4))
    recv = hp.step_recv_planes(Pe, phi, g, modes, HM3D_KW)
    out = (torch.empty_like(Pe), torch.empty_like(phi))
    hp._launch(Pe, phi, out, modes, recv, g.dims, g.nxyz, HM3D_KW, 0)
    for a, b in zip(out, hp.step_plain(Pe, phi, modes, recv, g.dims, HM3D_KW)):
        same(a, b)


@pytest.mark.parametrize("npow", [0, 1, 2, 5])
def test_hm3d_step_kernel_any_npow(emulated, npow):
    it.init_global_grid(8, 9, 12, quiet=True, device="cpu", **GRIDS["wrap"])
    g = it.get_global_grid()
    kw = dict(HM3D_KW, npow=npow)
    Pe, phi = (_random((8, 9, 12), torch.float32, lo, hi, s)
               for lo, hi, s in ((-0.5, 0, 5), (0.05, 0.25, 6)))
    modes, none = dp.step_modes(g), ({}, {})
    out = (torch.empty_like(Pe), torch.empty_like(phi))
    hp._launch(Pe, phi, out, modes, none, g.dims, g.nxyz, kw, 0)
    for a, b in zip(out, hp.step_plain(Pe, phi, modes, none, g.dims, kw)):
        same(a, b)


# Odd extents on grids of 2 and 3 blocks along y and z; the requests out of
# order, z rows adjacent (0 and 1, s-2 and s-1) and apart (3), the y rows
# likewise.  `offset` elements before the field: a source whose rows are
# not 16-byte aligned (the packer's element and head/tail paths).
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("dims,local", [((2, 3, 2), (5, 7, 9)),
                                        ((1, 2, 3), (3, 9, 13))])
def test_pack_kernel_matches_plain(emulated, dims, local, dtype, offset):
    shape = [n * s for n, s in zip(dims, local)]
    n = int(np.prod(shape))
    flat = _random((n + offset,), torch.float64, -100, 100, 23).to(dtype)
    A = flat[offset:].view(shape)
    reqs = [(2, local[2] - 1), (1, 0), (2, 0), (2, 3), (1, local[1] - 2),
            (2, 1), (1, 3), (2, local[2] - 2)]
    for some in (reqs, reqs[:1], [(1, 1), (1, 2)]):
        outs = [torch.full(pk._out_shape(A, d, dims), 7, dtype=dtype)
                for d, _ in some]
        pk._launch(A, some, dims, local, outs, 0)
        for got, want in zip(outs, pk.pack_planes_plain(A, some, dims)):
            same(got, want)


# Ranks 1-3; blocks (1,1,1), (2,2,2), (4,2,1); overlaps 2 and 3; 2-, 4- and
# 8-byte elements; the field at offset 0 and 1 of its storage (rows on and
# off 16 bytes); every WRAP/EXT/NONE mix; the thread blocks in both orders
# (a plane's kind that reads or writes a cell another kind writes shows in
# one of them).
@pytest.mark.parametrize("ol", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("blocks,local", halo_cases.LAYOUTS)
def test_halo_write_kernel_matches_plain(emulated, halo_reversed, blocks,
                                         local, dtype, ol, monkeypatch):
    """The halo writer against `halo_write_plain`, bitwise, every mode mix
    on every layout."""
    shape = [b * s for b, s in zip(blocks, local)]
    n = int(np.prod(shape))
    ran = 0
    for lib in (hw.library("halo_write"), halo_reversed):
        monkeypatch.setattr(hw, "library", lambda name, lib=lib: lib)
        for modes in halo_cases.mixes(blocks):
            for off in (0, 1):
                A = halo_cases.field(shape, dtype, off, 3 + off)
                specs = halo_cases.specs(A, modes, blocks, ol, 11)
                want = hw.halo_write_plain(A.clone(), specs, blocks)
                got = A.clone() if off == 0 else A
                b3, l3 = hw._check(got, specs, blocks)
                hw._launch(got, specs, b3, l3, 0)
                same(got, want)
                ran += 1
    assert ran >= 4


# Blocks of 18x10x40 and K = 3: an extended x span of 24 rows (18 on a
# frozen x), cut into 2 or 3 bands; two y tiles (8 + 2 rows) and two z tiles
# (32 + the rest), so wraps and tiles cross.
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(BAND_GRIDS))
def test_band_kernels_match_plain(emulated, case, dtype, bands):
    """The band kernels against `banded_window_plain` in every window mode:
    the whole evolved extended buffers (the shoulders show the clamp taken
    per block) and the central windows of the last launch."""
    (dims, per), K, local = BAND_GRIDS[case], 3, (18, 10, 40)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz]) * 2
    B = ce.ext_shape(local, K, modes)[0] // bands
    T, A = _random(shp, dtype, -10, 10, 17), _random(shp, dtype, 0.001, 0.1, 18)
    Text, A_ext = ce.extend_fields([T, A], ols, K, g, modes)
    Pe, phi = (_random(shp, dtype, -0.5, 0, 19),
               _random(shp, dtype, 0.05, 0.25, 20))
    exts = ce.extend_fields([Pe, phi], ols, K, g, modes)
    for central in (False, True):
        run = dict(local=local, K=K, B=B, modes=modes, g=g, central=central)
        got = _run_band(lambda src, dst, cfg: dtz._band_launch(
            src[0], A_ext, Text, dst[0], cfg, SC, 0), [Text], **run)[0]
        same(got, dtz.band_call(Text, A_ext, local, K=K, B=B, modes=modes,
                                grid=g, sc=SC, central=central))
        got = _run_band(lambda src, dst, cfg: htz._band_launch(
            src, exts, dst, cfg, HM3D_KW, 0), exts, **run)
        for a, b in zip(got, htz.band_call(exts, local, K=K, B=B, modes=modes,
                                           grid=g, kw=HM3D_KW,
                                           central=central)):
            same(a, b)


@pytest.mark.parametrize("local", [(12, 10), (16, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(c for c in WAVE_GRIDS
                                        if c != "2x2_periodic"))
def test_wave2d_step_kernel_matches_plain(emulated, case, dtype, local):
    g = _wave_grid(case, local)
    srcs = _wave_state(g, dtype, 11)
    out = [torch.empty_like(A) for A in srcs]
    wp._launch(srcs, out, g.dims[:2], g.nxyz[:2], WAVE_KW, 0)
    for a, b in zip(out, wp.step_plain(*srcs, g.dims[:2], WAVE_KW)):
        same(a, b)


# (16, 13): K = 2 and 4; (24, 21): K = 2, 4 and 8 (odd y extents: Vy rows
# of 14 and 22 elements).
@pytest.mark.parametrize("local,Ks", [((16, 13), (2, 4)), ((24, 21), (2, 8))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(c for c in WAVE_GRIDS
                                        if c.endswith("periodic")))
def test_wave2d_chunk_kernel_matches_plain(emulated, case, dtype, local, Ks):
    g = _wave_grid(case, local)
    modes = ce.dim_modes(g)[:2]
    shapes = wp.field_shapes(g.nxyz[:2])
    ols = ce.field_ols(g, shapes)
    for K in Ks:
        assert wtz.wave2d_chunk_refusal(g, g.nxyz[:2], K, K, dtype) is None
        exts = ce.extend_fields(_wave_state(g, dtype, 21), ols, 2 * K, g,
                                modes)
        got = _run_chunk(
            lambda src, dst, last: wtz._launch(
                src, dst, wtz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
                WAVE_KW, 0),
            exts, [torch.empty(it.stacked_shape(s), dtype=dtype)
                   for s in shapes], K)
        want = wtz.window_steps_plain(exts, K=K, modes=modes, grid=g,
                                      kw=WAVE_KW, ols=ols)
        for a, b, s in zip(got, want, shapes):
            same(a, ce.central_window(b, s, 2 * K, modes))


# (8, 9, 12): 16-byte P, Vx and Vy rows (the vector path; Vz's rows of 13
# are scalar); (7, 6, 11): odd z extents, the element path.
@pytest.mark.parametrize("local", [(8, 9, 12), (7, 6, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["ring_periodic", "2x2x2_open",
                                  "4x2x1_periods101", "1x1x1_periodic"])
def test_stokes_step_kernel_matches_plain(emulated, case, dtype, local):
    g = _stokes_grid(case, local)
    *srcs, Rho = _stokes_state(g, dtype, 31)
    out = [torch.empty_like(A) for A in srcs]
    sp._launch(srcs, Rho, out, g.dims, g.nxyz, STOKES_KW, 0)
    for a, b in zip(out, sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)):
        same(a, b)


# The spacings of the Stokes checks and of config 5 at 256^3 and 509^3, 3,
# and divisors at the ends of the reciprocal path's range and beyond it.
@pytest.mark.parametrize("d", [0.31, 0.27, 0.43, 3.0, 10 / 255, 10 / 508,
                               2.0 ** -20, 2.0 ** 20, 2.0 ** -21, 1e30,
                               -0.27])
def test_stokes_division_matches_ieee(emulated, d):
    """The chunk walk's division (`const_div.cuh`) bitwise `x / d`: float32
    over 2^20 dividends spread over all 2^32 bit patterns (every exponent,
    both signs, zeros, subnormals, infinities and NaNs among them) and
    around the ends of its dividend range and zero, float64 over 2^18
    patterns spread over all 2^64 and around its range's ends; the card
    checks all 2^32 float32 dividends for the phases' divisors
    (chip_smoke.py)."""
    f32, f64 = torch.float32, torch.float64
    assert stz.division_mismatches(d, dtype=f32, n=1 << 20, step=4093,
                                   device="cpu") == 0
    for lo in (0x0d800000 - 512, 0x71800000 - 512, 0x80000000 - 512,
               0xffffff00):
        assert stz.division_mismatches(d, dtype=f32, lo=lo, n=1024, step=1,
                                       device="cpu") == 0
    assert stz.division_mismatches(d, dtype=f64, n=1 << 18,
                                   step=0x9E3779B97F4A7C15,
                                   device="cpu") == 0
    for lo in (63 << 52, 1983 << 52, 1 << 63):
        for sign in (0, 1 << 63):
            assert stz.division_mismatches(d, dtype=f64, lo=(lo ^ sign) - 512,
                                           n=1024, step=1, device="cpu") == 0


# HM3D's divisors: phi0 and eta of its parameters, the checks' 1.3, and the
# spacings 10 / (n_g - 1) of its phases (n_g 254 on one periodic 256^3
# block, 508 on 2x2x2 periodic blocks of 256^3, 510 on open ones) and of
# their neighbours; and those of the chunk kernel's checks: HM3D_KW's
# spacings and 10 / (n_g - 1) on the chunk meshes at 16^3 and 16 x 12 x 13
# (chip_smoke.py), n_g from 10 to 114.
@pytest.mark.parametrize("d", [0.1, 1.0, 1.3, 10 / 252, 10 / 253, 10 / 254,
                               10 / 507, 10 / 508, 10 / 509, 0.31, 0.27,
                               0.43] + [10 / (n - 1) for n in (
                                   10, 11, 12, 13, 14, 16, 20, 22, 24, 28,
                                   30, 56, 112, 114)])
def test_hm3d_band_divisors_divide_as_ieee(emulated, d):
    """The HM3D marches' division (`const_div.cuh`) by their divisors
    bitwise `x / d`: float32 over 2^20 dividends spread over all 2^32 bit
    patterns and around its range's ends and zero, float64 over 2^18
    patterns spread over all 2^64; the card checks all 2^32 float32
    dividends (chip_smoke.py)."""
    f32, f64 = torch.float32, torch.float64
    assert stz.division_mismatches(d, dtype=f32, n=1 << 20, step=4093,
                                   device="cpu") == 0
    for lo in (0x0d800000 - 512, 0x71800000 - 512, 0x80000000 - 512):
        assert stz.division_mismatches(d, dtype=f32, lo=lo, n=1024, step=1,
                                       device="cpu") == 0
    assert stz.division_mismatches(d, dtype=f64, n=1 << 18,
                                   step=0x9E3779B97F4A7C15,
                                   device="cpu") == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["diffusion_band", "halo_write", "hm3d_band",
                                  "hm3d_chunk", "hm3d_step", "pack_planes",
                                  "stokes_band", "stokes_chunk",
                                  "stokes_step"])
def test_first_designs_match_plain(emulated, first_designs, name, dtype,
                                   monkeypatch):
    """The redesigned kernels' first designs, kept as text to be timed
    beside them, still build against the headers and equal the plain
    versions: the halo writer on 2x2x2 blocks (EXT sources on every dim,
    and on y and z alone), the band kernels on 2x2x2 blocks (diffusion
    periodic in z, HM3D periodic in y, Stokes open), the Stokes chunk step
    on one periodic
    block, the HM3D chunk step on 2x2x1 blocks (y and z periodic), the
    packer on 2x2x2 blocks, the HM3D step on 1x2x2 blocks (x periodic: a
    wrap and received planes) and the Stokes step on 2x2x2 open blocks."""
    for module in (dtz, htz, stz, pk, hp, sp, hw):
        monkeypatch.setattr(module, "library", first_designs.__getitem__)
    if name == "halo_write":
        blocks, local = (2, 2, 2), (5, 7, 19)
        got, want = [], []
        for modes in (("ext", "ext", "ext"), ("none", "ext", "ext")):
            A = halo_cases.field([b * s for b, s in zip(blocks, local)],
                                 dtype, 0, 13)
            specs = halo_cases.specs(A, modes, blocks, 2, 17)
            want.append(hw.halo_write_plain(A.clone(), specs, blocks))
            hw._launch(A, specs, blocks, local, 0)
            got.append(A)
    elif name == "diffusion_band":
        it.init_global_grid(18, 10, 40, quiet=True, device="cpu", dimx=2,
                            dimy=2, dimz=2, periodz=1)
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
        ols = ce.field_ols(g, [g.nxyz]) * 2
        Text, A_ext = ce.extend_fields([_random(shp, dtype, -10, 10, 25),
                                        _random(shp, dtype, 0.001, 0.1, 26)],
                                       ols, 3, g, modes)
        got = _run_band(lambda src, dst, cfg: dtz._band_launch(
            src[0], A_ext, Text, dst[0], cfg, SC, 0), [Text], local=g.nxyz,
            K=3, B=12, modes=modes, g=g, central=True)
        want = [dtz.band_call(Text, A_ext, g.nxyz, K=3, B=12, modes=modes,
                              grid=g, sc=SC)]
    elif name == "hm3d_chunk":
        it.init_global_grid(16, 12, 13, quiet=True, device="cpu", dimx=2,
                            dimy=2, dimz=1, periody=1, periodz=1)
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
        exts = ce.extend_fields([_random(shp, dtype, -0.5, 0, 27),
                                 _random(shp, dtype, 0.05, 0.25, 28)],
                                ce.field_ols(g, [g.nxyz]) * 2, 3, g, modes)
        got = _run_chunk(lambda src, dst, last: htz._launch(
            src, exts, dst, g.nxyz, 3, modes, g, HM3D_KW, last, 0), exts,
            [torch.empty(shp, dtype=dtype) for _ in range(2)], 3)
        want = htz.chunk_call(exts, g.nxyz, K=3, modes=modes, grid=g,
                              kw=HM3D_KW)
    elif name == "hm3d_step":
        it.init_global_grid(12, 10, 12, quiet=True, device="cpu",
                            **GRIDS["recv_yz_wrap_x"])
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), dp.step_modes(g)
        Pe, phi = (_random(shp, dtype, -0.5, 0, 33),
                   _random(shp, dtype, 0.05, 0.25, 34))
        recv = hp.step_recv_planes(Pe, phi, g, modes, HM3D_KW)
        got = (torch.empty_like(Pe), torch.empty_like(phi))
        hp._launch(Pe, phi, got, modes, recv, g.dims, g.nxyz, HM3D_KW, 0)
        want = hp.step_plain(Pe, phi, modes, recv, g.dims, HM3D_KW)
    elif name == "stokes_step":
        g = _stokes_grid("2x2x2_open", (7, 6, 11))
        *srcs, Rho = _stokes_state(g, dtype, 53)
        got = [torch.empty_like(A) for A in srcs]
        sp._launch(srcs, Rho, got, g.dims, g.nxyz, STOKES_KW, 0)
        want = sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)
    elif name == "hm3d_band":
        it.init_global_grid(18, 10, 40, quiet=True, device="cpu", dimx=2,
                            dimy=2, dimz=2, periody=1)
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
        ols = ce.field_ols(g, [g.nxyz]) * 2
        exts = ce.extend_fields([_random(shp, dtype, -0.5, 0, 23),
                                 _random(shp, dtype, 0.05, 0.25, 24)], ols,
                                3, g, modes)
        got = _run_band(lambda src, dst, cfg: htz._band_launch(
            src, exts, dst, cfg, HM3D_KW, 0), exts, local=g.nxyz, K=3, B=12,
            modes=modes, g=g, central=False)
        want = htz.band_call(exts, g.nxyz, K=3, B=12, modes=modes, grid=g,
                             kw=HM3D_KW, central=False)
    elif name == "stokes_band":
        K, local = 3, (12, 12, 36)
        g = _stokes_grid("2x2x2_open", local)
        modes = ce.dim_modes(g)
        shapes = sp.field_shapes(g.nxyz)
        ols = ce.field_ols(g, shapes)
        *state, Rho = _stokes_state(g, dtype, 47)
        exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        got = _run_stag_band(
            lambda src, dst, cfg: stz._band_launch(src, exts, Rho_ext, dst,
                                                   cfg, STOKES_KW, 0),
            exts, shapes, local, 2 * K, K, 12, 1, stz.EXTRAS, modes, g, ols,
            True)
        want = stz.band_call(exts, Rho_ext, shapes, K=K, B=12, modes=modes,
                             grid=g, kw=STOKES_KW, ols=ols)
    elif name == "stokes_chunk":
        K = 2
        g = _stokes_grid("1x1x1_periodic", (12, 12, 33))
        modes = ce.dim_modes(g)
        shapes = sp.field_shapes(g.nxyz)
        ols = ce.field_ols(g, shapes)
        *state, Rho = _stokes_state(g, dtype, 49)
        exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        got = _run_chunk(
            lambda src, dst, last: stz._launch(
                src, exts, Rho_ext, dst,
                stz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
                STOKES_KW, 0),
            exts, [torch.empty(it.stacked_shape(s), dtype=dtype)
                   for s in shapes[:4]], K)
        want = stz.chunk_call(exts, Rho_ext, shapes, K=K, modes=modes,
                              grid=g, kw=STOKES_KW, ols=ols)
    else:
        dims, local = (2, 2, 2), (5, 7, 9)
        A = _random([n * s for n, s in zip(dims, local)], torch.float64, -1,
                    1, 5).to(dtype)
        reqs = [(1, 1), (1, 5), (2, 0), (2, 8), (2, 1)]
        got = [torch.full(pk._out_shape(A, d, dims), 7, dtype=dtype)
               for d, _ in reqs]
        pk._launch(A, reqs, dims, local, got, 0)
        want = pk.pack_planes_plain(A, reqs, dims)
    for a, b in zip(got, want):
        same(a, b)

