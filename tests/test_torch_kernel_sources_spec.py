"""The kernels generated from stencil specs (`igg_torch/stencil/cuda.py`)
run on the CPU through g++ (tests/test_torch_kernel_sources.py): the step
and chunk step of the rank-2 specs, spec-wave2d against the hand wave2d
kernels, the generated band entry of relax3d and acoustic3d on its
x-march (`csrc/stagger_band_march3.cuh`) in every window mode and edge
case, and its first design.
Tolerance 0, f32 and f64; the stand-in runtime, fixtures and case tables
are in tests/torch_kernel_emulation.py, the rest of the rehearsal in
tests/test_torch_kernel_sources*.py.  Skips without g++.
"""

import pytest
import torch

import igg_torch as it
import torch_spec_cases as cases
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import wave2d_pallas as wp
from igg_torch.ops import wave2d_trapezoid as wtz
from igg_torch.stencil import lower
from torch_threads import one_torch_thread  # noqa: F401
from torch_kernel_emulation import (  # noqa: F401
    BAND_EDGE_CASES, _build_first_generated, _run_chunk, _run_stag_band,
    _spec_band_check, _spec_params, _step_cfg, csrc, emulated, first_designs,
    generated, libs, same, short_generated, short_segments)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case,local", _spec_params())
def test_spec_step_kernel_matches_plain(emulated, name, case, local, dtype):
    g = cases.init(it, name, case, local, "cpu")
    gen = cases.kernels(name)
    nd = gen.spec.ndim
    S = cases.state(it, gen, g, dtype, 51)
    out = [torch.empty_like(A) for A in S]
    lower._launch(gen, S, S, out, _step_cfg(g, nd), 0)
    for a, b in zip(out, lower.step_plain(gen, S, g.dims[:nd])):
        same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case,local", _spec_params())
def test_spec_chunk_kernel_matches_plain(emulated, name, case, local, dtype):
    g = cases.init(it, name, case, local, "cpu")
    gen = cases.kernels(name)
    S = cases.state(it, gen, g, dtype, 61)
    ran = 0
    for K in (2, 3):
        setup = cases.chunk_setup(gen, g, S, K)
        if setup is None:
            continue
        E, modes, shapes, ols, exts = setup
        got = _run_chunk(
            lambda src, dst, last: lower._launch(
                gen, src, exts, dst,
                ce.stagger_cfg(g.nxyz[:len(shapes[0])], E, modes, g.dims, ols,
                               last), 0),
            exts, [torch.empty(it.stacked_shape(s), dtype=dtype)
                   for s in shapes], K)
        want = lower.chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=g,
                                 ols=ols)
        for a, b, s in zip(got, want, shapes):
            same(a, ce.central_window(b, s, E, modes))
        ran += 1
    # The chunk refuses only `mixed` on open dims (its analyzer's
    # boundary-validity recurrence).
    assert ran or name == "mixed", (name, case)


@pytest.mark.parametrize("local", cases.LOCALS_2D)
@pytest.mark.parametrize("case", sorted(cases.GRIDS_2D))
def test_spec_wave2d_matches_hand_kernels(emulated, case, local):
    """The generated spec-wave2d step equals the hand-written wave2d step
    kernel bitwise; its chunk step (E = K) the hand chunk (E = 2K) on
    periodic grids, on the central windows."""
    g = cases.init(it, "wave2d_spec", case, local, "cpu")
    gen = cases.kernels("wave2d_spec")
    kw = dict(dx=0.31, dy=0.27, dt=0.05, rho=1.3, bulk=0.7)
    S = cases.state(it, gen, g, torch.float32, 71)
    hand = [torch.empty_like(A) for A in S]
    wp._launch(S, hand, g.dims[:2], g.nxyz[:2], kw, 0)
    out = [torch.empty_like(A) for A in S]
    lower._launch(gen, S, S, out, _step_cfg(g, 2), 0)
    for a, b in zip(out, hand):
        same(a, b)
    modes = ce.dim_modes(g)[:2]
    if any(m not in ("ext", "wrap") for m in modes):
        return
    K = 2
    E, modes, shapes, ols, exts = cases.chunk_setup(gen, g, S, K)
    got = _run_chunk(
        lambda src, dst, last: lower._launch(
            gen, src, exts, dst,
            ce.stagger_cfg(g.nxyz[:2], E, modes, g.dims, ols, last), 0),
        exts, [torch.empty_like(A) for A in S], K)
    wexts = ce.extend_fields(S, ols, 2 * K, g, modes)
    want = _run_chunk(
        lambda src, dst, last: wtz._launch(
            src, dst, wtz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
            kw, 0),
        wexts, [torch.empty_like(A) for A in S], K)
    for a, b in zip(got, want):
        same(a, b)


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case", [(n, c) for n in cases.SPECS_3D
                                       for c in sorted(cases.GRIDS_3D)])
def test_spec_band_kernel_matches_plain(emulated, name, case, dtype, bands):
    """The generated band entry of the rank-3 specs against
    `banded_window_plain` with the band core derived from the evaluator:
    whole evolved buffers and central windows, blocks of 18x12x36, K = 3,
    an extended x span of 24 rows (18 on a frozen x) in 2 or 3 bands."""
    K, local = 3, (18, 12, 36)
    g = cases.init(it, name, case, local, "cpu")
    gen = cases.kernels(name)
    shapes = lower.field_shapes(gen.spec, g.nxyz)
    E = gen.analysis.margin_after(K)
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, E, modes)[0] // bands
    assert lower.banded_refusal(gen.spec, gen.analysis, g, shapes[0], K, K,
                                dtype, B=B) is None
    lo, extras = lower.band_margins(gen.spec, gen.analysis)
    exts = ce.extend_fields(cases.state(it, gen, g, dtype, 65), ols, E, g,
                            modes)
    for central in (False, True):
        got = _run_stag_band(
            lambda src, dst, cfg: lower._band_launch(gen, src, exts, dst, cfg,
                                                     0),
            exts, shapes, local, E, K, B, lo, extras, modes, g, ols, central)
        want = lower.band_call(gen, exts, shapes, K=K, B=B, E=E, modes=modes,
                               grid=g, ols=ols, central=central)
        for a, b in zip(got, want):
            same(a, b)


# B = 8 and 16 in two and three bands, every window mode, y and z extents
# of one tile along z and two along y (the face rows of Vy and Vz in the
# last tiles).
@pytest.mark.parametrize("B,bands", [(8, 2), (8, 3), (16, 2), (16, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_march_matches_plain(emulated, name, case, dtype, B,
                                       bands):
    """The generated band entry's x-march against `banded_window_plain`
    at band depths 8 and 16, two and three bands, in every window mode."""
    _spec_band_check(name, case, dtype, B, bands, (9, 20))


# The march's edge cases: segments of 3 rows that cross the bands of 8
# (SHORT_SEGMENTS), y and z extents whose tiles end in ragged ones across
# the blocks' last rows (y 13, z 37: with the face rows 14 and 38, tiles of
# 8 x 32), and fields at rest.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_march_edge_cases(emulated, short_generated, name, case,
                                    kind, dtype, monkeypatch):
    """The generated band entry's x-march against `banded_window_plain`
    in its edge cases, every window mode, B = 8 in three bands."""
    if kind == "short_segments":
        monkeypatch.setattr(lower, "generated_library", short_generated)
    _spec_band_check(name, case, dtype, 8, 3,
                     (13, 37) if kind == "ragged_tiles" else (9, 20),
                     fields=cases.at_rest if kind == "at_rest" else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_open"])
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_first_design_matches_plain(emulated, first_designs, name,
                                              case, dtype, monkeypatch):
    """The generated band entry's first design (the band walk,
    kernel_variants.py: spec_band_first_source), kept to be timed beside
    the march, still builds against the headers and equals
    `banded_window_plain`."""
    first = _build_first_generated(first_designs, name)
    monkeypatch.setattr(lower, "generated_library",
                        lambda source, tag: first)
    _spec_band_check(name, case, dtype, 8, 3, (9, 20))

