"""The port's CUDA kernels held against their plain PyTorch versions on a
card: the fused diffusion step (wrap/recv/frozen halo modes), as a new
tensor and, for the K-step loop (wrap/frozen), into a preallocated one, the
in-place halo writer (wrap/ext sources, 2/4/8-byte elements; every
WRAP/EXT/NONE mix on ranks 1-3, blocks (1,1,1), (2,2,2) and (4,2,1),
overlaps 2 and 3, rows on and off 16 bytes), the trapezoid
chunk step (ext/wrap/oext/frozen window modes, f32/f64), the plane packer
(2/4/8-byte elements, rows that are not 16-byte aligned, z requests
adjacent and apart), the HM3D step (as a new pair and, for the
K-step loop, into a preallocated one) and chunk step in the same modes,
the wave2d step (1x1, 4x2, 8x1, 2x1 blocks, periodic and open) and
chunk step (periodic 1x1, 8x1, 4x2, 2x2 and 2x1 blocks, K = 2, 4, 8), and
the Stokes iteration (overlap-3 grids of 1, 8 blocks, periodic, open and
mixed) and chunk step (igg's trapezoid matrix: ext, wrap, oext and frozen
windows, the velocities' freezes, K = 2, 3, 4, extents across several of
its tiles; central windows and whole extended buffers) and its float32
division (against `x / d` over a sample of dividends), and the kernels generated
from stencil specs (tests/torch_spec_cases.py: shallow water with and
without friction, spec-wave2d, a spec of `pow`, `where` and scalar
divisions, the rank-3 `relax3d`; step and chunk step in every window mode,
spec-wave2d also against the hand wave2d kernels), and the diffusion and
HM3D band kernels (every window mode, two and three bands, whole evolved
buffers and central windows), and the staggered band kernels: Stokes
(igg's trapezoid matrix and one-block grids) and the generated band entry
of the rank-3 specs (`relax3d`, the staggered `acoustic3d`), the same way,
and its x-march at B = 8 and 16 in two and three bands in every window
mode of torch_spec_cases.BAND_GRIDS, with tiles across the blocks' last
y and z rows and with fields at rest; the generated rank-3 step and chunk
step (igg_spec_step on the same march's step and chunk modes) in every
layout of torch_spec_cases.BAND_GRIDS, whole extended buffers and central
windows, with tiles across the blocks' last rows, x extents of several
segments and fields at rest, and at phase 20's 256^3 periodic block;
the HM3D and Stokes band marches, the HM3D chunk march and the diffusion
band march in their edge cases (segments across the bands, tiles across
the blocks' last y and z rows, fields at rest, y one periodic block over
an open x; the last two marches in every layout of the chunk and band
meshes) and the HM3D marches' divisors against `x / d`; the diffusion and
Stokes gates refuse a window beyond the budget, which the marches (their
shared memory independent of B) still compute; a 2-D spec and wave2d
with `banded=True` raise on the card.
Tolerance 0 throughout.  Every test needs an
NVIDIA card and skips without one; `chip_smoke.py` runs the same
comparisons as its first phase."""

from functools import partial

import numpy as np
import pytest
import torch

import igg_torch as it
import torch_halo_cases as halo_cases
import torch_spec_cases as cases
from igg_torch import halo
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import diffusion_mega as dm
from igg_torch.ops import diffusion_pallas as dp
from igg_torch.ops import diffusion_trapezoid as dtz
from igg_torch.ops import halo_write as hw
from igg_torch.ops import hm3d_mega as hm
from igg_torch.ops import hm3d_pallas as hp
from igg_torch.ops import hm3d_trapezoid as htz
from igg_torch.ops import pack as pk
from igg_torch.ops import stokes_pallas as sp
from igg_torch.ops import stokes_trapezoid as stz
from igg_torch.ops import wave2d_pallas as wp
from igg_torch.ops import wave2d_trapezoid as wtz
from igg_torch.stencil import lower

pytestmark = pytest.mark.cuda

GRIDS = {
    "wrap": dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1),
    "frozen": dict(dimx=1, dimy=1, dimz=1),
    "wrap_y_frozen_xz": dict(dimx=1, dimy=1, dimz=1, periody=1),
    "recv_2x2x1_open": dict(dimx=2, dimy=2, dimz=1),
    "recv_2x2x2_periodic": dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                                periodz=1),
    "recv_x_wrap_yz": dict(dimx=2, dimy=1, dimz=1, periody=1, periodz=1),
    "recv_yz_wrap_x": dict(dimx=1, dimy=2, dimz=2, periodx=1),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    yield torch.device("cuda")
    if it.grid_is_initialized():
        it.finalize_global_grid()


def _random(shape, dtype, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape)).to(dtype)


# (8, 9, 16): 16-byte rows, the vector path; (7, 6, 10): odd z extents and
# block edges inside a vector, the element path and the per-lane z walk.
@pytest.mark.parametrize("local", [(8, 9, 16), (7, 6, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_step_kernel_matches_plain(card, case, dtype, local):
    it.init_global_grid(*local, quiet=True, device=card, **GRIDS[case])
    g = it.get_global_grid()
    shp = it.stacked_shape(g.nxyz)
    T = _random(shp, dtype, -10, 10, 0).to(card)
    A = _random(shp, dtype, 0.01, 0.1, 1).to(card)
    sc = dp.scal(0.3, 0.4, 0.5)
    modes = dp.step_modes(g)
    recv = dp.step_recv_planes(T, A, g, modes, sc)
    out = dp.step_kernel(T, A, modes, recv, g.dims, sc)
    torch.cuda.synchronize()
    ref = dp.step_plain(T, A, modes, recv, g.dims, sc)
    # built with -fmad=false: the same roundings as the plain version
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    if g.dims == (1, 1, 1):
        dst = torch.empty_like(T)
        dm.mega_step_kernel(T, A, dst, tuple(m for m in modes), sc)
        torch.testing.assert_close(dst, ref, rtol=0, atol=0)


HM3D_KW = dict(dx=0.31, dy=0.27, dz=0.43, dt=5e-4, phi0=0.1, npow=3, eta=1.3)


def _hm3d_state(shape, dtype, seed):
    return (_random(shape, dtype, -0.5, 0.0, seed),
            _random(shape, dtype, 0.05, 0.25, seed + 1))


# The HM3D step's layouts: GRIDS and y received over a wrapped x and z.
STEP_GRIDS = dict(GRIDS, recv_y_wrap_xz=dict(dimx=1, dimy=2, dimz=1,
                                             periodx=1, periodz=1))


# (19, 18, 35) and (40, 40, 70): extents across the march's 16 x 16 (y, z)
# tiles, the last ragged, and its x segments (1 and 2).
@pytest.mark.parametrize("local", [(8, 9, 16), (7, 6, 10), (19, 18, 35),
                                   (40, 40, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STEP_GRIDS))
def test_hm3d_step_kernel_matches_plain(card, case, dtype, local):
    it.init_global_grid(*local, quiet=True, device=card, **STEP_GRIDS[case])
    g = it.get_global_grid()
    Pe, phi = (F.to(card) for F in _hm3d_state(it.stacked_shape(g.nxyz),
                                               dtype, 7))
    modes = dp.step_modes(g)
    recv = hp.step_recv_planes(Pe, phi, g, modes, HM3D_KW)
    out = hp.step_kernel(Pe, phi, modes, recv, g.dims, HM3D_KW)
    torch.cuda.synchronize()
    ref = hp.step_plain(Pe, phi, modes, recv, g.dims, HM3D_KW)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if g.dims == (1, 1, 1):
        dst = (torch.empty_like(Pe), torch.empty_like(phi))
        hm.mega_step_kernel(Pe, phi, dst, modes, HM3D_KW)
        for a, b in zip(dst, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64,
                                   torch.int64])
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_halo_writer_matches_plain(card, case, dtype):
    it.init_global_grid(6, 7, 8, quiet=True, device=card, **GRIDS[case])
    for lshape in ((6, 7, 8), (7, 7, 8)):
        A = _random(it.stacked_shape(lshape), torch.float64, -100, 100, 2)
        A = A.to(dtype).to(card)
        ref = A.clone()
        g = it.get_global_grid()
        halo._update_field(ref, g, hw.halo_write_plain)
        halo._update_field(A, g, hw.halo_write)
        torch.testing.assert_close(A, ref, rtol=0, atol=0)


# Ranks 1-3; blocks (1,1,1), (2,2,2), (4,2,1); overlaps 2 and 3; 2-, 4- and
# 8-byte elements; the field at offset 0 and 1 of its storage (rows on and
# off 16 bytes); every WRAP/EXT/NONE mix (tests/torch_halo_cases.py).
@pytest.mark.parametrize("ol", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("blocks,local", halo_cases.LAYOUTS)
def test_halo_write_mixes_match_plain(card, blocks, local, dtype, ol):
    """The halo writer against `halo_write_plain`, bitwise, every mode mix
    on every layout."""
    shape = [b * s for b, s in zip(blocks, local)]
    for modes in halo_cases.mixes(blocks):
        for off in (0, 1):
            A = halo_cases.field(shape, dtype, off, 3 + off, card)
            specs = halo_cases.specs(A, modes, blocks, ol, 11)
            want = hw.halo_write_plain(A.clone(), specs, blocks)
            before = hw.halo_write.launches
            hw.halo_write(A, specs, blocks)
            torch.cuda.synchronize()
            assert hw.halo_write.launches == before + 1
            torch.testing.assert_close(A, want, rtol=0, atol=0)


# Meshes of the trapezoid chunk: every window mode (ext, wrap, oext, frozen).
CHUNK_GRIDS = {
    "ring_periodic": dict(dimx=8, dimy=1, dimz=1, periodx=1, periody=1,
                          periodz=1),
    "ring_open": dict(dimx=8, dimy=1, dimz=1),
    "4x2x1_periodic": dict(dimx=4, dimy=2, dimz=1, periodx=1, periody=1,
                           periodz=1),
    "2x2x2_periodic": dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                           periodz=1),
    "4x1x2_periodic": dict(dimx=4, dimy=1, dimz=2, periodx=1, periody=1,
                           periodz=1),
    "2x2x2_periods010": dict(dimx=2, dimy=2, dimz=2, periody=1),
    "2x2x2_periods101": dict(dimx=2, dimy=2, dimz=2, periodx=1, periodz=1),
    "1x2x2_open": dict(dimx=1, dimy=2, dimz=2),
    "2x1x1_wrap_y_frozen_z": dict(dimx=2, dimy=1, dimz=1, periody=1),
}


# (16, 16, 16): the vector path; (16, 12, 13): odd z, the element path.
@pytest.mark.parametrize("local", [(16, 16, 16), (16, 12, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CHUNK_GRIDS))
def test_chunk_kernel_matches_plain(card, case, dtype, local):
    it.init_global_grid(*local, quiet=True, device=card, **CHUNK_GRIDS[case])
    g = it.get_global_grid()
    K = 8
    assert dtz.trapezoid_refusal(g, g.nxyz, K, K, dtype) is None
    shp = it.stacked_shape(g.nxyz)
    T = _random(shp, dtype, -10, 10, 4).to(card)
    A = _random(shp, dtype, 0.01, 0.1, 5).to(card)
    sc = dp.scal(0.3, 0.4, 0.5)
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz])
    Text, A_ext = ce.extend_fields([T, A], ols * 2, K, g, modes)
    before = dtz.chunk_call.launches
    out = dtz.chunk_call(Text, A_ext, g.nxyz, K=K, modes=modes, grid=g, sc=sc)
    torch.cuda.synchronize()
    assert dtz.chunk_call.launches == before + K
    ref = ce.central_window(dtz.window_steps_plain(
        Text, A_ext, K=K, modes=modes, grid=g, sc=sc), g.nxyz, K, modes)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("local", [(16, 16, 16), (16, 12, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CHUNK_GRIDS))
def test_hm3d_chunk_kernel_matches_plain(card, case, dtype, local):
    it.init_global_grid(*local, quiet=True, device=card, **CHUNK_GRIDS[case])
    g = it.get_global_grid()
    K = 8
    assert htz.hm3d_trapezoid_refusal(g, g.nxyz, K, K, dtype) is None
    Pe, phi = (F.to(card) for F in _hm3d_state(it.stacked_shape(g.nxyz),
                                               dtype, 8))
    modes = ce.dim_modes(g)
    exts = ce.extend_fields([Pe, phi], ce.field_ols(g, [g.nxyz] * 2), K, g,
                            modes)
    before = htz.chunk_call.launches
    out = htz.chunk_call(exts, g.nxyz, K=K, modes=modes, grid=g, kw=HM3D_KW)
    torch.cuda.synchronize()
    assert htz.chunk_call.launches == before + K
    ref = htz.window_steps_plain(*exts, K=K, modes=modes, grid=g, kw=HM3D_KW)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, ce.central_window(b, g.nxyz, K, modes),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64,
                                   torch.int64])
@pytest.mark.parametrize("case", ["2x2x2_periodic", "1x2x2_open",
                                  "4x2x1_periodic"])
def test_pack_kernel_matches_plain(card, case, dtype):
    it.init_global_grid(6, 7, 9, quiet=True, device=card, **CHUNK_GRIDS[case])
    g = it.get_global_grid()
    A = _random(it.stacked_shape(g.nxyz), torch.float64, -100, 100, 6)
    A = A.to(dtype).to(card)
    reqs = [(d, p) for d in (1, 2) for p in (0, 1, g.nxyz[d] - 2, g.nxyz[d] - 1)]
    out = pk.pack_planes(A, reqs, g.dims)
    torch.cuda.synchronize()
    for got, want in zip(out, pk.pack_planes_plain(A, reqs, g.dims)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# Odd extents, 2 and 3 blocks along y and z, the requests out of order: z
# rows adjacent (0 and 1, s-2 and s-1) and apart (3).  `offset` elements
# before the field: rows that are not 16-byte aligned (the element and
# head/tail paths of the y copy).
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("dims,local", [((2, 3, 2), (5, 7, 9)),
                                        ((1, 2, 3), (3, 9, 13)),
                                        ((2, 2, 2), (4, 6, 64))])
def test_pack_kernel_unaligned_rows(card, dims, local, dtype, offset):
    shape = [n * s for n, s in zip(dims, local)]
    flat = _random((int(np.prod(shape)) + offset,), torch.float64, -100, 100,
                   24).to(dtype).to(card)
    A = flat[offset:].view(shape)
    reqs = [(2, local[2] - 1), (1, 0), (2, 0), (2, 3), (1, local[1] - 2),
            (2, 1), (1, 3), (2, local[2] - 2)]
    for some in (reqs, reqs[:1], [(1, 1), (1, 2)]):
        out = pk.pack_planes(A, some, dims)
        torch.cuda.synchronize()
        for got, want in zip(out, pk.pack_planes_plain(A, some, dims)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_update_halo_on_card_matches_cpu(card):
    it.init_global_grid(6, 6, 6, quiet=True, device=card, dimx=2, dimy=2,
                        dimz=2, periodx=1)
    A = _random(it.stacked_shape((6, 6, 6)), torch.float64, -1, 1, 3)
    out = it.update_halo(A.to(card)).cpu()
    before = hw.halo_write.launches
    ref = it.update_halo(A.clone(), plain=True)
    assert hw.halo_write.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# The band kernels' layouts: the chunk meshes and one periodic block (x
# extended, y and z wrapped).
BAND_GRIDS = dict(CHUNK_GRIDS, one_block_periodic=dict(
    dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1))


# Blocks of 18x10x40, K = 3: an extended x span of 24 rows (18 on a frozen
# x) in 2 or 3 bands (B = 12 in float64 stages 76,160 bytes a thread block,
# above the 48 KB that needs the attribute); y and z tiles that cross.
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(BAND_GRIDS))
def test_band_kernels_match_plain(card, case, dtype, bands):
    """Both band kernels against `banded_window_plain`: the whole evolved
    extended buffers and the central windows of the last launch."""
    K, local = 3, (18, 10, 40)
    it.init_global_grid(*local, quiet=True, device=card, **BAND_GRIDS[case])
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    B = ce.ext_shape(local, K, modes)[0] // bands
    assert dtz.banded_refusal(g, local, K, K, dtype, B=B) is None
    shp = it.stacked_shape(g.nxyz)
    ols = ce.field_ols(g, [g.nxyz]) * 2
    T = _random(shp, dtype, -10, 10, 6).to(card)
    A = _random(shp, dtype, 0.01, 0.1, 7).to(card)
    Text, A_ext = ce.extend_fields([T, A], ols, K, g, modes)
    exts = ce.extend_fields([F.to(card) for F in _hm3d_state(shp, dtype, 9)],
                            ols, K, g, modes)
    sc = dp.scal(0.3, 0.4, 0.5)
    plain = dict(K=K, B=B, lo=1, modes=modes, grid=g, ols=ols,
                 shapes=[local] * 2, E=K, extras=(1, 1))
    want_t = ce.banded_window_plain(
        [Text, A_ext], band_update=partial(dtz.banded_update, **sc), n_up=1,
        freeze_fields=(0,), **plain)[0]
    want_h = ce.banded_window_plain(
        list(exts), band_update=partial(htz.band_update, kw=HM3D_KW), n_up=2,
        freeze_fields=(0, 1), **plain)
    for central in (False, True):
        cut = ((lambda F: ce.central_window(F, local, K, modes)) if central
               else (lambda F: F))
        before = dtz.band_call.launches, htz.band_call.launches
        got = dtz.band_call(Text, A_ext, local, K=K, B=B, modes=modes, grid=g,
                            sc=sc, central=central)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, cut(want_t), rtol=0, atol=0)
        got = htz.band_call(exts, local, K=K, B=B, modes=modes, grid=g,
                            kw=HM3D_KW, central=central)
        torch.cuda.synchronize()
        for a, b in zip(got, want_h):
            torch.testing.assert_close(a, cut(b), rtol=0, atol=0)
        assert (dtz.band_call.launches, htz.band_call.launches) == (
            before[0] + K, before[1] + K)


def test_band_kernel_refuses_what_smem_refuses(card):
    """A band whose window exceeds a thread block's shared memory in the
    diffusion band kernel's first design (B = 48 in float64: 272,000
    bytes) raises in the wrapper (igg's gate, kept as it is).  The
    library's march holds the same shared memory at every B, so it takes
    the launch, and its result equals the plain version's."""
    it.init_global_grid(96, 16, 16, quiet=True, device=card)
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    T = _random((96, 16, 16), torch.float64, -1, 1, 3).to(card)
    A = _random((96, 16, 16), torch.float64, 0.01, 0.1, 4).to(card)
    sc = dp.scal(0.3, 0.4, 0.5)
    assert "shared-memory budget" in dtz.banded_refusal(
        g, g.nxyz, 4, 4, torch.float64, B=48)
    before = dtz.band_call.launches
    with pytest.raises(it.GridError, match="shared-memory budget"):
        dtz.band_call(T, A, g.nxyz, K=4, B=48, modes=modes, grid=g, sc=sc)
    assert dtz.band_call.launches == before
    cfg = ce.band_cfg(T.shape, g.nxyz, 4, modes, g, False, B=48, lo=1,
                      extra=1, ols=(2, 2, 2))
    out = torch.empty_like(T)
    dtz._band_launch(T, A, T, out, cfg, sc,
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = ce.banded_window_plain(
        [T, A], K=1, B=48, lo=1, modes=modes, grid=g, ols=[(2, 2, 2)] * 2,
        shapes=[g.nxyz] * 2, E=4, band_update=partial(dtz.banded_update, **sc),
        extras=(1, 1), n_up=1, freeze_fields=(0,))[0]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


WAVE_KW = dict(dx=0.31, dy=0.27, dt=0.05, rho=1.3, bulk=0.7)
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


def _wave_state(g, dtype, seed, dev):
    return [_random(it.stacked_shape(s), dtype, -1, 1, seed + f).to(dev)
            for f, s in enumerate(wp.field_shapes(g.nxyz[:2]))]


# (12, 10): even extents; (16, 13): an odd y extent (Vy rows of 14).
@pytest.mark.parametrize("local", [(12, 10), (16, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(c for c in WAVE_GRIDS
                                        if c != "2x2_periodic"))
def test_wave2d_step_kernel_matches_plain(card, case, dtype, local):
    it.init_global_grid(*local, 1, quiet=True, device=card, dimz=1,
                        **WAVE_GRIDS[case])
    g = it.get_global_grid()
    srcs = _wave_state(g, dtype, 11, card)
    before = wp.step_kernel.launches
    out = wp.step_kernel(*srcs, g.dims[:2], WAVE_KW)
    torch.cuda.synchronize()
    assert wp.step_kernel.launches == before + 1
    for a, b in zip(out, wp.step_plain(*srcs, g.dims[:2], WAVE_KW)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("local,Ks", [((16, 13), (2, 4)), ((24, 21), (2, 8))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(c for c in WAVE_GRIDS
                                        if c.endswith("periodic")))
def test_wave2d_chunk_kernel_matches_plain(card, case, dtype, local, Ks):
    it.init_global_grid(*local, 1, quiet=True, device=card, dimz=1,
                        **WAVE_GRIDS[case])
    g = it.get_global_grid()
    modes = ce.dim_modes(g)[:2]
    shapes = wp.field_shapes(g.nxyz[:2])
    ols = ce.field_ols(g, shapes)
    for K in Ks:
        assert wtz.wave2d_chunk_refusal(g, g.nxyz[:2], K, K, dtype) is None
        exts = ce.extend_fields(_wave_state(g, dtype, 21, card), ols, 2 * K,
                                g, modes)
        before = wtz.chunk_call.launches
        out = wtz.chunk_call(exts, shapes, K=K, modes=modes, grid=g,
                             kw=WAVE_KW, ols=ols)
        torch.cuda.synchronize()
        assert wtz.chunk_call.launches == before + K
        want = wtz.window_steps_plain(exts, K=K, modes=modes, grid=g,
                                      kw=WAVE_KW, ols=ols)
        for a, b, s in zip(out, want, shapes):
            torch.testing.assert_close(
                a, ce.central_window(b, s, 2 * K, modes), rtol=0, atol=0)


STOKES_KW = dict(dx=0.31, dy=0.27, dz=0.43, mu=1.3, dtP=0.07, dtV=0.011)
# Layouts of the Stokes checks (overlap 3), as init_global_grid keywords:
# igg's trapezoid matrix plus one-block grids.
STOKES_GRIDS = {
    "ring_periodic": dict(dimx=8, dimy=1, dimz=1, periodx=1, periody=1,
                          periodz=1),
    "ring_open": dict(dimx=8, dimy=1, dimz=1),
    "2x2x2_periodic": dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                           periodz=1),
    "2x2x2_open": dict(dimx=2, dimy=2, dimz=2),
    "2x2x2_periods010": dict(dimx=2, dimy=2, dimz=2, periody=1),
    "4x2x1_periods101": dict(dimx=4, dimy=2, dimz=1, periodx=1, periodz=1),
    "1x1x1_periodic": dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1,
                           periodz=1),
    "1x1x1_open": dict(dimx=1, dimy=1, dimz=1),
    "1x1x1_periods101": dict(dimx=1, dimy=1, dimz=1, periodx=1, periodz=1),
}


def _stokes_state(g, dtype, seed, dev):
    return [_random(it.stacked_shape(s), dtype, -1, 1, seed + f).to(dev)
            for f, s in enumerate(sp.field_shapes(g.nxyz))]


# (8, 9, 16) and (7, 6, 11): one tile; (17, 19, 35) and (40, 40, 70):
# extents across the march's (y, z) tiles (16 or 8 rows by 32 columns),
# the last ragged, and its x segments (2 and 5).
@pytest.mark.parametrize("local", [(8, 9, 16), (7, 6, 11), (17, 19, 35),
                                   (40, 40, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_step_kernel_matches_plain(card, case, dtype, local):
    it.init_global_grid(*local, quiet=True, device=card, overlapx=3,
                        overlapy=3, overlapz=3, **STOKES_GRIDS[case])
    g = it.get_global_grid()
    *srcs, Rho = _stokes_state(g, dtype, 31, card)
    before = sp.step_kernel.launches
    out = sp.step_kernel(*srcs, Rho, g.dims, STOKES_KW)
    torch.cuda.synchronize()
    assert sp.step_kernel.launches == before + 1
    for a, b in zip(out, sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("kernel", ["hm3d", "stokes"])
def test_step_kernels_at_main_path_shapes(card, kernel, blocks, dtype):
    """The HM3D and Stokes step kernels at the main path's shapes: one
    periodic block of 256^3 (phases 8 and 12) and 2x2x2 blocks of 256^3,
    HM3D periodic (every dim received, phase 9) and Stokes open (phase
    13)."""
    layout = (dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1)
              if blocks == 1 or kernel == "hm3d" else {})
    if blocks == 2:
        layout.update(dimx=2, dimy=2, dimz=2)
    if kernel == "hm3d":
        it.init_global_grid(256, 256, 256, quiet=True, device=card, **layout)
        g = it.get_global_grid()
        Pe, phi = (F.to(card) for F in _hm3d_state(
            it.stacked_shape(g.nxyz), dtype, 61))
        modes = dp.step_modes(g)
        recv = hp.step_recv_planes(Pe, phi, g, modes, HM3D_KW)
        out = hp.step_kernel(Pe, phi, modes, recv, g.dims, HM3D_KW)
        torch.cuda.synchronize()
        ref = hp.step_plain(Pe, phi, modes, recv, g.dims, HM3D_KW)
    else:
        it.init_global_grid(256, 256, 256, quiet=True, device=card,
                            overlapx=3, overlapy=3, overlapz=3, **layout)
        g = it.get_global_grid()
        *srcs, Rho = _stokes_state(g, dtype, 63, card)
        out = sp.step_kernel(*srcs, Rho, g.dims, STOKES_KW)
        torch.cuda.synchronize()
        ref = sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# (16, 16, 16): K = 2 (E = 4); (15, 14, 17): odd extents, K = 2 and 3;
# (24, 24, 24): K = 2 and 4; (13, 13, 33) and (12, 20, 70): extended y and
# z extents across 2 to 4 of the kernel's 8 x 32 (y, z) tiles, the last
# ragged, with the wraps' edge and alias rows inside tiles.
@pytest.mark.parametrize("local,Ks", [((16, 16, 16), (2,)),
                                      ((15, 14, 17), (2, 3)),
                                      ((24, 24, 24), (2, 4)),
                                      ((13, 13, 33), (2, 3)),
                                      ((12, 20, 70), (2,))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_chunk_kernel_matches_plain(card, case, dtype, local, Ks):
    it.init_global_grid(*local, quiet=True, device=card, overlapx=3,
                        overlapy=3, overlapz=3, **STOKES_GRIDS[case])
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    *state, Rho = _stokes_state(g, dtype, 41, card)
    for K in Ks:
        assert stz.stokes_chunk_refusal(g, g.nxyz, K, K, dtype) is None
        exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        before = stz.chunk_call.launches
        out = stz.chunk_call(exts, Rho_ext, shapes, K=K, modes=modes, grid=g,
                             kw=STOKES_KW, ols=ols)
        torch.cuda.synchronize()
        assert stz.chunk_call.launches == before + K
        want = stz.window_iters_plain(exts, Rho_ext, K=K, modes=modes,
                                      grid=g, kw=STOKES_KW, ols=ols)
        for a, b, s in zip(out, want, shapes):
            torch.testing.assert_close(
                a, ce.central_window(b, s, 2 * K, modes), rtol=0, atol=0)
        # The whole extended buffers of K launches (NaN-filled targets, so a
        # cell left unwritten shows).
        src = list(exts)
        for _ in range(K):
            dst = [torch.full_like(X, float("nan")) for X in exts]
            stz._launch(src, exts, Rho_ext, dst,
                        stz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, False),
                        STOKES_KW, torch.cuda.current_stream().cuda_stream)
            src = dst
        torch.cuda.synchronize()
        for a, b in zip(src, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# The spacings of the checks above and of config 5 at 256^3 and 509^3, 3,
# and divisors at and beyond the ends of the reciprocal path's range.
@pytest.mark.parametrize("d", [0.31, 0.27, 0.43, 3.0, 10 / 255, 10 / 508,
                               2.0 ** -20, 2.0 ** 20, 2.0 ** -21, 1e30,
                               -0.27])
def test_stokes_division_matches_ieee(card, d):
    """The chunk kernel's division bitwise `x / d` on the card: float32
    over 2^28 dividends spread over all bit patterns and around the ends
    of its dividend range and zero (chip_smoke.py checks all 2^32 for the
    phases' divisors), float64 over 2^28 patterns spread over all 2^64 and
    around its range's ends."""
    f32, f64 = torch.float32, torch.float64
    assert stz.division_mismatches(d, dtype=f32, n=1 << 28, step=15,
                                   device=card) == 0
    for lo in (0x0d800000 - 4096, 0x71800000 - 4096, 0x80000000 - 4096,
               0xfffff000):
        assert stz.division_mismatches(d, dtype=f32, lo=lo, n=8192, step=1,
                                       device=card) == 0
    assert stz.division_mismatches(d, dtype=f64, n=1 << 28,
                                   step=0x9E3779B97F4A7C15, device=card) == 0
    for lo in (63 << 52, 1983 << 52, 1 << 63):
        for sign in (0, 1 << 63):
            assert stz.division_mismatches(d, dtype=f64, lo=(lo ^ sign) - 4096,
                                           n=8192, step=1, device=card) == 0


# Blocks of 12x12x36, K = 3 (E = 6): an extended x span of 24 rows (12 on a
# frozen x) in 2 or 3 bands (B = 12 in float64 stages 198,048 bytes a
# thread block); y and z tiles that cross, the face rows of Vy and Vz.
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_band_kernel_matches_plain(card, case, dtype, bands):
    """The Stokes band kernel against `banded_window_plain` with the port of
    igg's `_band_update`: the whole evolved extended buffers (the
    x-staggered Vx's tail row and the shoulders included) and the central
    windows of the last launch."""
    K, local = 3, (12, 12, 36)
    it.init_global_grid(*local, quiet=True, device=card, overlapx=3,
                        overlapy=3, overlapz=3, **STOKES_GRIDS[case])
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, 2 * K, modes)[0] // bands
    assert stz.stokes_banded_refusal(g, local, K, K, dtype, B=B) is None
    *state, Rho = _stokes_state(g, dtype, 43, card)
    exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
    want = ce.banded_window_plain(
        list(exts) + [Rho_ext], K=K, B=B, lo=1, modes=modes, grid=g, ols=ols,
        shapes=shapes, E=2 * K,
        band_update=partial(stz.band_update, kw=STOKES_KW),
        extras=stz.EXTRAS, n_up=4, freeze_fields=stz.FREEZE_FIELDS)[:4]
    for central in (False, True):
        before = stz.band_call.launches
        got = stz.band_call(exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                            grid=g, kw=STOKES_KW, ols=ols, central=central)
        torch.cuda.synchronize()
        assert stz.band_call.launches == before + K
        for a, b, s in zip(got, want, shapes):
            b = ce.central_window(b, s, 2 * K, modes) if central else b
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stokes_band_kernel_refuses_what_smem_refuses(card):
    """B = 16 in float64 staged 253,856 bytes a thread block in the band
    kernel's first design: the gate and the wrapper refuse it (igg's gate,
    kept as it is).  The library's march holds the same shared memory at
    every B, so it takes the launch, and its result equals the plain
    version's."""
    local = (32, 12, 12)
    it.init_global_grid(*local, quiet=True, device=card, overlapx=3,
                        overlapy=3, overlapz=3)
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    assert "shared-memory budget" in stz.stokes_banded_refusal(
        g, local, 2, 2, torch.float64, B=16)
    *state, Rho = _stokes_state(g, torch.float64, 47, card)
    exts = ce.extend_fields(state, ols[:4], 4, g, modes)
    Rho_ext = ce.extend_fields([Rho], [ols[4]], 4, g, modes)[0]
    before = stz.band_call.launches
    with pytest.raises(it.GridError, match="shared-memory budget"):
        stz.band_call(exts, Rho_ext, shapes, K=2, B=16, modes=modes, grid=g,
                      kw=STOKES_KW, ols=ols)
    assert stz.band_call.launches == before
    cfg = ce.stagger_band_cfg(local, 4, modes, g.dims, ols[:4], False, B=16,
                              lo=1, extras=stz.EXTRAS)
    out = [torch.empty_like(X) for X in exts]
    stz._band_launch(exts, exts, Rho_ext, out, cfg, STOKES_KW,
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = ce.banded_window_plain(
        list(exts) + [Rho_ext], K=1, B=16, lo=1, modes=modes, grid=g,
        ols=ols, shapes=shapes, E=4,
        band_update=partial(stz.band_update, kw=STOKES_KW),
        extras=stz.EXTRAS, n_up=4, freeze_fields=stz.FREEZE_FIELDS)[:4]
    for a, b in zip(out, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# The band marches' edge cases on the card, two and three bands: HM3D
# blocks whose extended x span (42 or 36 rows) the march cuts into
# segments of 9 rows that cross the bands ("long_x"; the Stokes march's
# bounding box of 25 rows already gives segments of 9 at the other
# shapes: a longer x would need bands above float64's window budget),
# tiles that cross the blocks' last y and z rows ("ragged_tiles": y 13 and
# z 35 or 37), and fields at rest ("at_rest": `init_fields`, whose zero
# dividends const_div.cuh sends to `x * r`); Stokes also with y one
# periodic block over an open x.  (HM3D's local shape, Stokes' or None.)
BAND_EDGE_LOCALS = {"long_x": ((36, 10, 40), None),
                    "ragged_tiles": ((18, 13, 37), (12, 13, 35)),
                    "at_rest": ((18, 10, 40), (12, 12, 36))}


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", sorted(BAND_EDGE_LOCALS))
@pytest.mark.parametrize("case", ["one_block_periodic", "2x2x2_periods010",
                                  "1x2x2_open"])
def test_hm3d_band_march_edge_cases(card, case, kind, dtype, bands):
    """The HM3D band kernel against `banded_window_plain` in the march's
    edge cases: whole evolved buffers and central windows, K launches a
    call."""
    from igg_torch.models import hm3d as h3

    K, local = 3, BAND_EDGE_LOCALS[kind][0]
    it.init_global_grid(*local, quiet=True, device=card, **BAND_GRIDS[case])
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    span = ce.ext_shape(local, K, modes)[0]
    assert span % bands == 0
    B = span // bands
    assert htz.hm3d_banded_refusal(g, local, K, K, dtype, B=B) is None
    ols = ce.field_ols(g, [g.nxyz]) * 2
    state = (h3.init_fields(h3.Params(), dtype=dtype) if kind == "at_rest"
             else [F.to(card) for F in _hm3d_state(
                 it.stacked_shape(g.nxyz), dtype, 23)])
    exts = ce.extend_fields(list(state), ols, K, g, modes)
    want = ce.banded_window_plain(
        list(exts), K=K, B=B, lo=1, modes=modes, grid=g, ols=ols,
        shapes=[local] * 2, E=K,
        band_update=partial(htz.band_update, kw=HM3D_KW), extras=(1, 1),
        n_up=2, freeze_fields=(0, 1))
    for central in (False, True):
        before = htz.band_call.launches
        got = htz.band_call(exts, local, K=K, B=B, modes=modes, grid=g,
                            kw=HM3D_KW, central=central)
        torch.cuda.synchronize()
        assert htz.band_call.launches == before + K
        for a, b in zip(got, want):
            b = ce.central_window(b, local, K, modes) if central else b
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", sorted(k for k, v in BAND_EDGE_LOCALS.items()
                                         if v[1] is not None))
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_open",
                                  "4x2x1_periods101", "2x1x1_wrap_y_open_xz"])
def test_stokes_band_march_edge_cases(card, case, kind, dtype, bands):
    """The Stokes band kernel against `banded_window_plain` in the march's
    edge cases: whole evolved buffers and central windows, K launches a
    call."""
    from igg_torch.models import stokes3d as st3

    K, local = 3, BAND_EDGE_LOCALS[kind][1]
    layout = dict(STOKES_GRIDS, **{"2x1x1_wrap_y_open_xz": dict(
        dimx=2, dimy=1, dimz=1, periody=1)})[case]
    it.init_global_grid(*local, quiet=True, device=card, overlapx=3,
                        overlapy=3, overlapz=3, **layout)
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    span = ce.ext_shape(local, 2 * K, modes)[0]
    assert span % bands == 0
    B = span // bands
    assert stz.stokes_banded_refusal(g, local, K, K, dtype, B=B) is None
    if kind == "at_rest":
        *state, Rho = st3.init_fields(st3.Params(), dtype=dtype)
    else:
        *state, Rho = _stokes_state(g, dtype, 49, card)
    exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
    want = ce.banded_window_plain(
        list(exts) + [Rho_ext], K=K, B=B, lo=1, modes=modes, grid=g, ols=ols,
        shapes=shapes, E=2 * K,
        band_update=partial(stz.band_update, kw=STOKES_KW),
        extras=stz.EXTRAS, n_up=4, freeze_fields=stz.FREEZE_FIELDS)[:4]
    for central in (False, True):
        before = stz.band_call.launches
        got = stz.band_call(exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                            grid=g, kw=STOKES_KW, ols=ols, central=central)
        torch.cuda.synchronize()
        assert stz.band_call.launches == before + K
        for a, b, s in zip(got, want, shapes):
            b = ce.central_window(b, s, 2 * K, modes) if central else b
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# The HM3D chunk march's edge cases on the card, every layout of the chunk
# meshes: blocks whose extended x span (36 + 2K rows where x extends) the
# march cuts into segments of 9 rows ("long_x"), tiles that cross the
# blocks' last y and z rows ("ragged_tiles": 18 x 13 x 37), and fields at
# rest ("at_rest"); z wraps cross the 16-cell tiles at every shape, and
# one wraps over an open x and y (a wrapped z row takes F at its target).
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", sorted(BAND_EDGE_LOCALS))
@pytest.mark.parametrize("case", sorted(CHUNK_GRIDS) + ["wrap_z_open_xy"])
def test_hm3d_chunk_march_edge_cases(card, case, kind, dtype):
    """The HM3D chunk kernel (the HM3D march with the chunk's edge rules)
    against `window_steps_plain` in the march's edge cases: central
    windows of a K = 3 chunk, K launches a call, and the whole evolved
    extended buffers of K launches that write them (shoulders included)."""
    from igg_torch.models import hm3d as h3

    K, local = 3, BAND_EDGE_LOCALS[kind][0]
    layout = dict(CHUNK_GRIDS, wrap_z_open_xy=dict(dimx=2, dimy=1, dimz=1,
                                                   periodz=1))[case]
    it.init_global_grid(*local, quiet=True, device=card, **layout)
    g = it.get_global_grid()
    assert htz.hm3d_trapezoid_refusal(g, g.nxyz, K, K, dtype) is None
    modes = ce.dim_modes(g)
    state = (h3.init_fields(h3.Params(), dtype=dtype) if kind == "at_rest"
             else [F.to(card) for F in _hm3d_state(
                 it.stacked_shape(g.nxyz), dtype, 25)])
    exts = ce.extend_fields(list(state), ce.field_ols(g, [g.nxyz] * 2), K,
                            g, modes)
    before = htz.chunk_call.launches
    out = htz.chunk_call(exts, g.nxyz, K=K, modes=modes, grid=g, kw=HM3D_KW)
    torch.cuda.synchronize()
    assert htz.chunk_call.launches == before + K
    ref = htz.window_steps_plain(*exts, K=K, modes=modes, grid=g, kw=HM3D_KW)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, ce.central_window(b, g.nxyz, K, modes),
                                   rtol=0, atol=0)
    src = exts
    for k in range(K):
        dst = [torch.empty_like(X) for X in exts]
        htz._launch(src, exts, dst, g.nxyz, K, modes, g, HM3D_KW, False,
                    torch.cuda.current_stream().cuda_stream)
        src = dst
    torch.cuda.synchronize()
    for a, b in zip(src, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# The diffusion band march's edge cases on the card, every layout of the
# band meshes, two and three bands: the shapes of the HM3D band march's
# ("long_x", "ragged_tiles"), and "at_rest": the diffusion model's
# `init_fields` (T's anomalies in a field at rest, A = 0.05 / Cp).
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", sorted(BAND_EDGE_LOCALS))
@pytest.mark.parametrize("case", sorted(BAND_GRIDS))
def test_diffusion_band_march_edge_cases(card, case, kind, dtype, bands):
    """The diffusion band kernel against `banded_window_plain` in the
    march's edge cases: whole evolved buffers and central windows, K
    launches a call."""
    from igg_torch.models import diffusion3d as d3

    K, local = 3, BAND_EDGE_LOCALS[kind][0]
    it.init_global_grid(*local, quiet=True, device=card, **BAND_GRIDS[case])
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    span = ce.ext_shape(local, K, modes)[0]
    assert span % bands == 0
    B = span // bands
    assert dtz.banded_refusal(g, local, K, K, dtype, B=B) is None
    shp = it.stacked_shape(g.nxyz)
    if kind == "at_rest":
        T, Cp = d3.init_fields(d3.Params(), dtype=dtype)
        A = 0.05 / Cp
    else:
        T = _random(shp, dtype, -10, 10, 27).to(card)
        A = _random(shp, dtype, 0.01, 0.1, 28).to(card)
    ols = ce.field_ols(g, [g.nxyz]) * 2
    Text, A_ext = ce.extend_fields([T, A], ols, K, g, modes)
    sc = dp.scal(0.3, 0.4, 0.5)
    want = ce.banded_window_plain(
        [Text, A_ext], K=K, B=B, lo=1, modes=modes, grid=g, ols=ols,
        shapes=[local] * 2, E=K, band_update=partial(dtz.banded_update, **sc),
        extras=(1, 1), n_up=1, freeze_fields=(0,))[0]
    for central in (False, True):
        before = dtz.band_call.launches
        got = dtz.band_call(Text, A_ext, local, K=K, B=B, modes=modes, grid=g,
                            sc=sc, central=central)
        torch.cuda.synchronize()
        assert dtz.band_call.launches == before + K
        b = ce.central_window(want, local, K, modes) if central else want
        torch.testing.assert_close(got, b, rtol=0, atol=0)


# HM3D's divisors: phi0, eta, the checks' 1.3 and the spacings of its
# phases (10/253 on one periodic 256^3 block, 10/507 on 2x2x2 periodic
# blocks of 256^3), and the chunk checks' spacings (10/9 to 10/113 on the
# chunk meshes at 16^3 and 16 x 12 x 13, HM3D_KW's 0.31, 0.27 and 0.43).
@pytest.mark.parametrize("d", [0.1, 1.0, 1.3, 10 / 253, 10 / 507, 0.31,
                               0.27, 0.43, 10 / 9, 10 / 13, 10 / 27,
                               10 / 55, 10 / 113])
def test_hm3d_band_divisors_divide_as_ieee(card, d):
    """The HM3D marches' division (const_div.cuh, the Stokes chunk
    library's check kernel) bitwise `x / d` on the card: float32 over 2^28
    dividends spread over all bit patterns and around its range's ends and
    zero, float64 over 2^28 patterns spread over all 2^64."""
    f32, f64 = torch.float32, torch.float64
    assert stz.division_mismatches(d, dtype=f32, n=1 << 28, step=15,
                                   device=card) == 0
    for lo in (0x0d800000 - 4096, 0x71800000 - 4096, 0x80000000 - 4096):
        assert stz.division_mismatches(d, dtype=f32, lo=lo, n=8192, step=1,
                                       device=card) == 0
    assert stz.division_mismatches(d, dtype=f64, n=1 << 28,
                                   step=0x9E3779B97F4A7C15, device=card) == 0


# -- kernels generated from stencil specs ------------------------------------

def _spec_params():
    return [(name, case, local) for name in sorted(cases.SPECS)
            for case in sorted(cases.grids(name))
            for local in cases.locals_of(name)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case,local", _spec_params())
def test_spec_step_kernel_matches_plain(card, name, case, local, dtype):
    g = cases.init(it, name, case, local, card)
    gen = cases.kernels(name)
    nd = gen.spec.ndim
    S = cases.state(it, gen, g, dtype, 51, card)
    before = lower.step_kernel.launches
    out = lower.step_kernel(gen, S, g.dims[:nd])
    torch.cuda.synchronize()
    assert lower.step_kernel.launches == before + 1
    for a, b in zip(out, lower.step_plain(gen, S, g.dims[:nd])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case,local", _spec_params())
def test_spec_chunk_kernel_matches_plain(card, name, case, local, dtype):
    g = cases.init(it, name, case, local, card)
    gen = cases.kernels(name)
    S = cases.state(it, gen, g, dtype, 61, card)
    ran = 0
    for K in (2, 3):
        setup = cases.chunk_setup(gen, g, S, K)
        if setup is None:
            continue
        E, modes, shapes, ols, exts = setup
        before = lower.chunk_call.launches
        out = lower.chunk_call(gen, exts, shapes, K=K, E=E, modes=modes,
                               grid=g, ols=ols)
        torch.cuda.synchronize()
        assert lower.chunk_call.launches == before + K
        want = lower.chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=g,
                                 ols=ols)
        for a, b, s in zip(out, want, shapes):
            torch.testing.assert_close(
                a, ce.central_window(b, s, E, modes), rtol=0, atol=0)
        ran += 1
    assert ran or name == "mixed", (name, case)


@pytest.mark.parametrize("local", cases.LOCALS_2D)
@pytest.mark.parametrize("case", sorted(cases.GRIDS_2D))
def test_spec_wave2d_matches_hand_kernels(card, case, local):
    g = cases.init(it, "wave2d_spec", case, local, card)
    gen = cases.kernels("wave2d_spec")
    S = cases.state(it, gen, g, torch.float32, 71, card)
    out = lower.step_kernel(gen, S, g.dims[:2])
    hand = wp.step_kernel(*S, g.dims[:2], WAVE_KW)
    for a, b in zip(out, hand):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    modes = ce.dim_modes(g)[:2]
    if any(m not in ("ext", "wrap") for m in modes):
        return
    K = 2
    E, modes, shapes, ols, exts = cases.chunk_setup(gen, g, S, K)
    got = lower.chunk_call(gen, exts, shapes, K=K, E=E, modes=modes, grid=g,
                           ols=ols)
    wexts = ce.extend_fields(S, ols, 2 * K, g, modes)
    want = wtz.chunk_call(wexts, shapes, K=K, modes=modes, grid=g,
                          kw=WAVE_KW, ols=ols)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case", [(n, c) for n in cases.SPECS_3D
                                       for c in sorted(cases.GRIDS_3D)])
def test_spec_band_kernel_matches_plain(card, name, case, dtype, bands):
    """The generated band entry of the rank-3 specs against
    `banded_window_plain` with the band core derived from the evaluator:
    whole evolved buffers and central windows, blocks of 18x12x36, K = 3,
    an extended x span of 24 rows (18 on a frozen x) in 2 or 3 bands."""
    K, local = 3, (18, 12, 36)
    g = cases.init(it, name, case, local, card)
    gen = cases.kernels(name)
    shapes = lower.field_shapes(gen.spec, g.nxyz)
    E = gen.analysis.margin_after(K)
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, E, modes)[0] // bands
    assert lower.banded_refusal(gen.spec, gen.analysis, g, shapes[0], K, K,
                                dtype, B=B) is None
    lo, extras = lower.band_margins(gen.spec, gen.analysis)
    exts = ce.extend_fields(cases.state(it, gen, g, dtype, 65, card), ols, E,
                            g, modes)
    want = ce.banded_window_plain(
        list(exts), K=K, B=B, lo=lo, modes=modes, grid=g, ols=ols,
        shapes=shapes, E=E, band_update=lower.band_core(gen), extras=extras,
        n_up=len(exts), freeze_fields=gen.analysis.freeze)
    for central in (False, True):
        before = lower.band_call.launches
        got = lower.band_call(gen, exts, shapes, K=K, B=B, E=E, modes=modes,
                              grid=g, ols=ols, central=central)
        torch.cuda.synchronize()
        assert lower.band_call.launches == before + K
        for a, b, s in zip(got, want, shapes):
            b = ce.central_window(b, s, E, modes) if central else b
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_banded_rank2_raises_on_the_card(card):
    """igg compiles its streaming kernel for 3-D fields only: on the card a
    rank-2 spec and wave2d with `banded=True` raise a GridError naming
    "3-D only", and "auto" takes another route."""
    from igg_torch import stencil
    from igg_torch.models import wave2d as w2

    it.init_global_grid(16, 16, 1, dimx=4, dimy=2, periodx=1, periody=1,
                        quiet=True, device=card)
    p = w2.Params()
    S = it.update_halo(*w2.init_fields(p))
    with pytest.raises(it.GridError, match="3-D only"):
        w2.make_multi_step(5, p, banded=True, K=4, band=8)(*S)
    spec = stencil.wave2d_spec()
    cf = stencil.wave2d_coeffs(p)
    with pytest.raises(it.GridError, match="3-D only"):
        stencil.compile(spec, coeffs=cf, n_inner=5, banded=True, K=4,
                        band=8)(*S)
    before = lower.band_call.launches
    out = stencil.compile(spec, coeffs=cf, n_inner=5, chunk=False)(*S)
    assert lower.band_call.launches == before
    want = stencil.compile(spec, coeffs=cf, n_inner=5, chunk=False,
                           banded=False)(*S)
    for a, b in zip(out, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _spec_band_check(card, name, case, dtype, B, bands, yz, K=3,
                     fields=None):
    """The generated band entry's x-march against `banded_window_plain` on
    the card (torch_spec_cases.band_setup's layout), tolerance 0: whole
    evolved buffers and central windows, K launches a call."""
    gen, g, shapes, E, modes, ols, exts = cases.band_setup(
        it, name, case, B, bands, yz, K, dtype, card, fields=fields)
    lo, extras = lower.band_margins(gen.spec, gen.analysis)
    want = ce.banded_window_plain(
        list(exts), K=K, B=B, lo=lo, modes=modes, grid=g, ols=ols,
        shapes=shapes, E=E, band_update=lower.band_core(gen), extras=extras,
        n_up=len(exts), freeze_fields=gen.analysis.freeze)
    for central in (False, True):
        before = lower.band_call.launches
        got = lower.band_call(gen, exts, shapes, K=K, B=B, E=E, modes=modes,
                              grid=g, ols=ols, central=central)
        torch.cuda.synchronize()
        assert lower.band_call.launches == before + K
        for a, b, s in zip(got, want, shapes):
            b = ce.central_window(b, s, E, modes) if central else b
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# B = 8 and 16 in two and three bands, every window mode of the band
# entry (torch_spec_cases.BAND_GRIDS).
@pytest.mark.parametrize("B,bands", [(8, 2), (8, 3), (16, 2), (16, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_march_matches_plain(card, name, case, dtype, B, bands):
    _spec_band_check(card, name, case, dtype, B, bands, (9, 20))


# Tiles that cross the blocks' last y and z rows (y 13, z 37, and the face
# rows) and fields at rest, B = 8 in three bands.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ragged_tiles", "at_rest"])
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_march_edge_cases(card, name, case, kind, dtype):
    _spec_band_check(card, name, case, dtype, 8, 3,
                     (13, 37) if kind == "ragged_tiles" else (9, 20),
                     fields=cases.at_rest if kind == "at_rest" else None)


# -- igg_spec_step on the x-march (stagger_band_march3.cuh: its step and
# chunk modes) -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("local", cases.MARCH_LOCALS)
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_march_matches_plain(card, name, case, local, dtype):
    """The step (the march's step mode) against `step_plain` and the K = 2
    and 3 chunk steps (its chunk mode where a dim wraps or freezes) against
    `window_step_plain`, whole extended buffers and central windows, in
    every window mode of torch_spec_cases.BAND_GRIDS, with tiles across
    the blocks' last y and z rows."""
    gen = cases.kernels(name)
    g = cases.march_grid(it, case, local, card)
    S = cases.state(it, gen, g, dtype, 75, card)
    cases.march_step_check(gen, g, S)
    for K in (2, 3):
        assert cases.march_chunk_check(it, gen, g, S, K)


# Tiles ragged across the blocks' last rows with odd z extents, x extents
# of several segments, fields at rest.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ragged_tiles", "segments", "at_rest"])
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_march_edge_cases(card, name, case, kind, dtype):
    gen = cases.kernels(name)
    g = cases.march_grid(it, case, cases.MARCH_EDGE_LOCALS.get(
        kind, (10, 9, 8)), card)
    S = (cases.at_rest(it, gen, g, dtype, card) if kind == "at_rest"
         else cases.state(it, gen, g, dtype, 76, card))
    cases.march_step_check(gen, g, S)
    assert cases.march_chunk_check(it, gen, g, S, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_march_at_main_path_shapes(card, name, dtype):
    """The step and the K = 8 chunk step of the rank-3 specs on one 256^3
    periodic block (phase 20's relax3d shape: the chunk 272 x 256 x 256
    extended, y and z wrapped), through the counted wrappers."""
    n, K = 256, 8
    gen = cases.kernels(name)
    g = cases.march_grid(it, "1x1x1_periodic", (n, n, n), card)
    S = cases.state(it, gen, g, dtype, 77, card)
    before = lower.step_kernel.launches
    out = lower.step_kernel(gen, S, g.dims)
    torch.cuda.synchronize()
    assert lower.step_kernel.launches == before + 1
    for a, b in zip(out, lower.step_plain(gen, S, g.dims)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    del out
    E, modes, shapes, ols, exts = cases.chunk_setup(gen, g, S, K)
    before = lower.chunk_call.launches
    out = lower.chunk_call(gen, exts, shapes, K=K, E=E, modes=modes, grid=g,
                           ols=ols)
    torch.cuda.synchronize()
    assert lower.chunk_call.launches == before + K
    want = lower.chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=g,
                             ols=ols)
    for a, b, s in zip(out, want, shapes):
        torch.testing.assert_close(a, ce.central_window(b, s, E, modes),
                                   rtol=0, atol=0)
