"""The Stokes chunk kernel's CUDA source (the x-march of
`csrc/stokes_march.cuh`) run on the CPU through g++
(tests/test_torch_kernel_sources.py), against its plain version in every
window mode, over K = 1 and several launches.
Tolerance 0, f32 and f64; the stand-in runtime, fixtures and case tables
are in tests/torch_kernel_emulation.py, the rest of the rehearsal in
tests/test_torch_kernel_sources*.py.  Skips without g++.
"""

import pytest
import torch

import igg_torch as it
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import stokes_pallas as sp
from igg_torch.ops import stokes_trapezoid as stz
from torch_threads import one_torch_thread  # noqa: F401
from torch_kernel_emulation import (  # noqa: F401
    STOKES_GRIDS, STOKES_KW, _run_chunk, _stokes_grid, _stokes_state, csrc,
    emulated, generated, libs, same)


# Extents that cross the march's (y, z) tiles (8 x 32 cells) and end in a
# ragged one, extended (E = 2K) or not: y 12 and 13 (13 to 26 rows with
# the face row: 2 to 4 tiles), z 33 (34 to 46: 2 tiles), x 12 and 13 (two
# segments of x rows); K = 2 and 3.
@pytest.mark.parametrize("local,Ks", [((12, 12, 33), (2,)),
                                      ((13, 13, 33), (2, 3))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_chunk_kernel_matches_plain(emulated, case, dtype, local, Ks):
    """The chunk step against `window_iters_plain`: K launches into whole
    extended buffers (NaN-filled, so a cell left unwritten shows) against
    the plain version's evolved buffers, and the chain whose last launch
    writes the central windows against their windows."""
    g = _stokes_grid(case, local)
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    *state, Rho = _stokes_state(g, dtype, 41)
    for K in Ks:
        assert stz.stokes_chunk_refusal(g, g.nxyz, K, K, dtype) is None
        exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        want = stz.window_iters_plain(exts, Rho_ext, K=K, modes=modes,
                                      grid=g, kw=STOKES_KW, ols=ols)
        src = list(exts)
        for _ in range(K):
            dst = [torch.full_like(X, float("nan")) for X in exts]
            stz._launch(src, exts, Rho_ext, dst,
                        stz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, False),
                        STOKES_KW, 0)
            src = dst
        for a, b in zip(src, want):
            same(a, b)
        got = _run_chunk(
            lambda src, dst, last: stz._launch(
                src, exts, Rho_ext, dst,
                stz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
                STOKES_KW, 0),
            exts, [torch.full(it.stacked_shape(s), float("nan"), dtype=dtype)
                   for s in shapes[:4]], K)
        for a, b, s in zip(got, want, shapes):
            same(a, ce.central_window(b, s, 2 * K, modes))

