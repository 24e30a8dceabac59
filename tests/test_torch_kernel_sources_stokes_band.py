"""The Stokes band kernel (the band mode of `csrc/stokes_march.cuh`) run
on the CPU through g++ (tests/test_torch_kernel_sources.py), against its
plain version in every window mode and in the march's edge cases
(short segments, ragged tiles, fields at rest).
Tolerance 0, f32 and f64; the stand-in runtime, fixtures and case tables
are in tests/torch_kernel_emulation.py, the rest of the rehearsal in
tests/test_torch_kernel_sources*.py.  Skips without g++.
"""

import pytest
import torch

from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import stokes_pallas as sp
from igg_torch.ops import stokes_trapezoid as stz
from torch_threads import one_torch_thread  # noqa: F401
from torch_kernel_emulation import (  # noqa: F401
    BAND_EDGE_CASES, STOKES_GRIDS, STOKES_KW, _run_stag_band, _stokes_grid,
    _stokes_state, csrc, emulated, generated, libs, same, short_segments)


# Blocks of 12x12x36 at K = 3 (E = 6): an extended x span of 24 rows (12 on a
# frozen x) cut into 2 or 3 bands; y in 2 or 3 tiles and z in 2 (the face
# rows of Vy and Vz in the last tile), so wraps, freezes and tiles cross.
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_band_kernel_matches_plain(emulated, case, dtype, bands):
    """The Stokes band kernel against `banded_window_plain` with the port
    of igg's `_band_update`: the whole evolved extended buffers (tail rows
    and shoulders included) and the central windows of the last launch."""
    K, local = 3, (12, 12, 36)
    g = _stokes_grid(case, local)
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, 2 * K, modes)[0] // bands
    assert stz.stokes_banded_refusal(g, local, K, K, dtype, B=B) is None
    *state, Rho = _stokes_state(g, dtype, 43)
    exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
    for central in (False, True):
        got = _run_stag_band(
            lambda src, dst, cfg: stz._band_launch(src, exts, Rho_ext, dst,
                                                   cfg, STOKES_KW, 0),
            exts, shapes, local, 2 * K, K, B, 1, stz.EXTRAS, modes, g, ols,
            central)
        want = stz.band_call(exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                             grid=g, kw=STOKES_KW, ols=ols, central=central)
        for a, b in zip(got, want):
            same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_open",
                                  "4x2x1_periods101", "2x1x1_wrap_y_open_xz"])
def test_stokes_band_march_edge_cases(emulated, short_segments, case, kind,
                                      dtype, monkeypatch):
    """The Stokes band kernel against `banded_window_plain` in the march's
    edge cases: the whole evolved extended buffers and the central
    windows, two bands."""
    from igg_torch.models import stokes3d as st3

    K = 3
    local = (12, 13, 35) if kind == "ragged_tiles" else (12, 12, 36)
    if kind == "short_segments":
        monkeypatch.setattr(stz, "library", short_segments.__getitem__)
    g = _stokes_grid(case, local)
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, 2 * K, modes)[0] // 2
    assert stz.stokes_banded_refusal(g, local, K, K, dtype, B=B) is None
    if kind == "at_rest":
        *state, Rho = st3.init_fields(st3.Params(), dtype=dtype)
    else:
        *state, Rho = _stokes_state(g, dtype, 45)
    exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
    for central in (False, True):
        got = _run_stag_band(
            lambda src, dst, cfg: stz._band_launch(src, exts, Rho_ext, dst,
                                                   cfg, STOKES_KW, 0),
            exts, shapes, local, 2 * K, K, B, 1, stz.EXTRAS, modes, g, ols,
            central)
        want = stz.band_call(exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                             grid=g, kw=STOKES_KW, ols=ols, central=central)
        for a, b in zip(got, want):
            same(a, b)

