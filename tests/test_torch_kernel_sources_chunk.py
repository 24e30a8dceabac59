"""The diffusion and HM3D chunk kernels' CUDA sources run on the CPU
through g++ (tests/test_torch_kernel_sources.py), against their plain
versions in every window mode of the chunk mesh.
Tolerance 0, f32 and f64; the stand-in runtime, fixtures and case tables
are in tests/torch_kernel_emulation.py, the rest of the rehearsal in
tests/test_torch_kernel_sources*.py.  Skips without g++.
"""

import pytest
import torch

import igg_torch as it
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import diffusion_trapezoid as dtz
from igg_torch.ops import hm3d_trapezoid as htz
from torch_threads import one_torch_thread  # noqa: F401
from torch_kernel_emulation import (  # noqa: F401
    CHUNK_GRIDS, HM3D_KW, SC, _random, _run_chunk, csrc, emulated, generated,
    libs, same)


# (16, 16, 16): whole vectors; (16, 12, 13): odd z, the element path.
@pytest.mark.parametrize("local", [(16, 16, 16), (16, 12, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CHUNK_GRIDS))
def test_chunk_kernels_match_plain(emulated, case, dtype, local):
    (dims, per), K = CHUNK_GRIDS[case], 8
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz]) * 2

    T, A = _random(shp, dtype, -10, 10, 7), _random(shp, dtype, 0.001, 0.1, 8)
    Text, A_ext = ce.extend_fields([T, A], ols, K, g, modes)
    got = _run_chunk(
        lambda src, dst, last: dtz._launch(src[0], A_ext, Text, dst[0],
                                           g.nxyz, K, modes, g, SC, last, 0),
        [Text], [torch.empty_like(T)], K)[0]
    same(got, ce.central_window(dtz.window_steps_plain(
        Text, A_ext, K=K, modes=modes, grid=g, sc=SC), g.nxyz, K, modes))

    Pe, phi = (_random(shp, dtype, -0.5, 0, 9),
               _random(shp, dtype, 0.05, 0.25, 10))
    exts = ce.extend_fields([Pe, phi], ols, K, g, modes)
    got = _run_chunk(
        lambda src, dst, last: htz._launch(src, exts, dst, g.nxyz, K, modes,
                                           g, HM3D_KW, last, 0),
        exts, [torch.empty_like(Pe), torch.empty_like(phi)], K)
    for a, b in zip(got, htz.window_steps_plain(*exts, K=K, modes=modes,
                                                grid=g, kw=HM3D_KW)):
        same(a, ce.central_window(b, g.nxyz, K, modes))

