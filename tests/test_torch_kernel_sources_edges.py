"""The HM3D and diffusion marches' edge cases (`csrc/hm3d_march.cuh`
with its band, chunk and step edge rules, `csrc/diffusion_march.cuh`)
and the Stokes step march's, run on the CPU through g++
(tests/test_torch_kernel_sources.py): segments cut short, tiles ragged
across the blocks' last rows, fields at rest, every halo mode.
Tolerance 0, f32 and f64; the stand-in runtime, fixtures and case tables
are in tests/torch_kernel_emulation.py, the rest of the rehearsal in
tests/test_torch_kernel_sources*.py.  Skips without g++.
"""

import pytest
import torch

import igg_torch as it
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import diffusion_pallas as dp
from igg_torch.ops import diffusion_trapezoid as dtz
from igg_torch.ops import hm3d_pallas as hp
from igg_torch.ops import hm3d_trapezoid as htz
from igg_torch.ops import stokes_pallas as sp
from torch_threads import one_torch_thread  # noqa: F401
from torch_kernel_emulation import (  # noqa: F401
    BAND_EDGE_CASES, BAND_GRIDS, CHUNK_EDGE_GRIDS, HM3D_KW, SC, STEP_GRIDS,
    STOKES_KW, _random, _run_band, _run_chunk, _stokes_grid, _stokes_state,
    csrc, emulated, generated, libs, same, short_segments)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_periods010",
                                  "1x2x2_open"])
def test_hm3d_band_march_edge_cases(emulated, short_segments, case, kind,
                                    dtype, monkeypatch):
    """The HM3D band kernel against `banded_window_plain` in the march's
    edge cases: the whole evolved extended buffers and the central
    windows, two bands."""
    from igg_torch.models import hm3d as h3

    (dims, per), K = BAND_GRIDS[case], 3
    local = (18, 13, 37) if kind == "ragged_tiles" else (18, 10, 40)
    if kind == "short_segments":
        monkeypatch.setattr(htz, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz]) * 2
    B = ce.ext_shape(local, K, modes)[0] // 2
    if kind == "at_rest":
        state = h3.init_fields(h3.Params(), dtype=dtype)
    else:
        state = (_random(shp, dtype, -0.5, 0, 21),
                 _random(shp, dtype, 0.05, 0.25, 22))
    exts = ce.extend_fields(list(state), ols, K, g, modes)
    for central in (False, True):
        got = _run_band(lambda src, dst, cfg: htz._band_launch(
            src, exts, dst, cfg, HM3D_KW, 0), exts, local=local, K=K, B=B,
            modes=modes, g=g, central=central)
        for a, b in zip(got, htz.band_call(exts, local, K=K, B=B, modes=modes,
                                           grid=g, kw=HM3D_KW,
                                           central=central)):
            same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(CHUNK_EDGE_GRIDS))
def test_hm3d_chunk_march_edge_cases(emulated, short_segments, case, kind,
                                     dtype, monkeypatch):
    """The HM3D chunk kernel (the HM3D march with the chunk's edge rules)
    against `window_steps_plain` in the march's edge cases, every layout
    of the chunk meshes: the whole evolved extended buffers of K = 3
    launches (the shoulders show the freeze rows beyond lo and hi and the
    outermost rows kept) and the central windows of a K = 3 chunk."""
    from igg_torch.models import hm3d as h3

    (dims, per), K = CHUNK_EDGE_GRIDS[case], 3
    local = (18, 13, 37) if kind == "ragged_tiles" else (18, 10, 40)
    if kind == "short_segments":
        monkeypatch.setattr(htz, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    if kind == "at_rest":
        state = h3.init_fields(h3.Params(), dtype=dtype)
    else:
        state = (_random(shp, dtype, -0.5, 0, 29),
                 _random(shp, dtype, 0.05, 0.25, 30))
    exts = ce.extend_fields(list(state), ce.field_ols(g, [g.nxyz]) * 2, K, g,
                            modes)
    want = htz.window_steps_plain(*exts, K=K, modes=modes, grid=g,
                                  kw=HM3D_KW)
    whole = _run_chunk(lambda src, dst, last: htz._launch(
        src, exts, dst, g.nxyz, K, modes, g, HM3D_KW, False, 0), exts,
        [torch.empty_like(X) for X in exts], K)
    got = _run_chunk(lambda src, dst, last: htz._launch(
        src, exts, dst, g.nxyz, K, modes, g, HM3D_KW, last, 0), exts,
        [torch.empty(shp, dtype=dtype) for _ in range(2)], K)
    for a, w, b in zip(got, whole, want):
        same(w, b)
        same(a, ce.central_window(b, g.nxyz, K, modes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(BAND_GRIDS))
def test_diffusion_band_march_edge_cases(emulated, short_segments, case, kind,
                                         dtype, monkeypatch):
    """The diffusion band kernel against `banded_window_plain` in the
    march's edge cases, every layout of the band meshes: the whole evolved
    extended buffer and the central window, two bands.  Its at-rest state
    is the diffusion model's `init_fields` (T's anomalies in a field at
    rest, A = 0.05 / Cp)."""
    from igg_torch.models import diffusion3d as d3

    (dims, per), K = BAND_GRIDS[case], 3
    local = (18, 13, 37) if kind == "ragged_tiles" else (18, 10, 40)
    if kind == "short_segments":
        monkeypatch.setattr(dtz, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    if kind == "at_rest":
        T, Cp = d3.init_fields(d3.Params(), dtype=dtype)
        A = 0.05 / Cp
    else:
        T, A = (_random(shp, dtype, -10, 10, 31),
                _random(shp, dtype, 0.001, 0.1, 32))
    Text, A_ext = ce.extend_fields([T, A], ce.field_ols(g, [g.nxyz]) * 2, K,
                                   g, modes)
    B = ce.ext_shape(local, K, modes)[0] // 2
    for central in (False, True):
        got = _run_band(lambda src, dst, cfg: dtz._band_launch(
            src[0], A_ext, Text, dst[0], cfg, SC, 0), [Text], local=local,
            K=K, B=B, modes=modes, g=g, central=central)[0]
        same(got, dtz.band_call(Text, A_ext, local, K=K, B=B, modes=modes,
                                grid=g, sc=SC, central=central))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(STEP_GRIDS))
def test_hm3d_step_march_edge_cases(emulated, short_segments, case, kind,
                                    dtype, monkeypatch):
    """The HM3D step kernel (the HM3D march with the fused step's edge
    rules) against `step_plain` in the march's edge cases, npow 0, 1, 2 and
    5: x segments of 3 rows (SHORT_SEGMENTS; 13 rows: 4 segments), extents
    that cross its 16 x 16 tiles and end in a ragged one (y 18, z 35), and
    fields at rest."""
    from igg_torch.models import hm3d as h3

    local = (19, 18, 35) if kind == "ragged_tiles" else (13, 10, 12)
    if kind == "short_segments":
        monkeypatch.setattr(hp, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", **STEP_GRIDS[case])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), dp.step_modes(g)
    if kind == "at_rest":
        Pe, phi = h3.init_fields(h3.Params(), dtype=dtype)
    else:
        Pe, phi = (_random(shp, dtype, -0.5, 0, 41),
                   _random(shp, dtype, 0.05, 0.25, 42))
    for npow in (0, 1, 2, 5):
        kw = dict(HM3D_KW, npow=npow)
        recv = hp.step_recv_planes(Pe, phi, g, modes, kw)
        out = (torch.empty_like(Pe), torch.empty_like(phi))
        hp._launch(Pe, phi, out, modes, recv, g.dims, g.nxyz, kw, 0)
        for a, b in zip(out, hp.step_plain(Pe, phi, modes, recv, g.dims, kw)):
            same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES + ("tiny",))
@pytest.mark.parametrize("case", ["ring_periodic", "2x2x2_open",
                                  "4x2x1_periods101", "1x1x1_periodic"])
def test_stokes_step_march_edge_cases(emulated, short_segments, case, kind,
                                      dtype, monkeypatch):
    """The Stokes step kernel's x-march against `step_plain` in its edge
    cases: x segments of 3 rows (SHORT_SEGMENTS; 13 rows: 4 segments),
    extents that cross its tiles (8 rows by 32 columns) and end in a
    ragged one (y 19, z 35; x 17: 2 segments), fields at rest, and tiny
    fields (about 1e-37: dividends below the reciprocal path's range,
    subnormal ones among them in float32)."""
    from igg_torch.models import stokes3d as st3

    local = (17, 19, 35) if kind == "ragged_tiles" else (13, 9, 12)
    if kind == "short_segments":
        monkeypatch.setattr(sp, "library", short_segments.__getitem__)
    g = _stokes_grid(case, local)
    if kind == "at_rest":
        *srcs, Rho = st3.init_fields(st3.Params(), dtype=dtype)
    else:
        *srcs, Rho = _stokes_state(g, dtype, 51)
    if kind == "tiny":
        srcs, Rho = [A * 1e-37 for A in srcs], Rho * 1e-37
    out = [torch.empty_like(A) for A in srcs]
    sp._launch(srcs, Rho, out, g.dims, g.nxyz, STOKES_KW, 0)
    for a, b in zip(out, sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)):
        same(a, b)

