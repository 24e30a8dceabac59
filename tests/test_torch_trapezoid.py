"""The port's K-step trapezoid chunk route held against igg on the CPU.

igg's side runs as tests/test_trapezoid.py runs it: its chunk engine under
`igg.sharded` on the 8-device CPU mesh, its chunk through the pure-XLA
window realization (`interpret=True`) and its model path through
`make_multi_step(..., use_pallas=True, pallas_interpret=True, bx=8)`.  The
port runs with `device="cpu"`, where the chunk kernel's plain version (the
port of `_window_steps_xla`) serves.  Inputs are made with numpy from a
seed.  Tolerances: the extension is a copy (bitwise); one chunk against K
per-step steps in the port is the same arithmetic on the same cells
(tolerance 0); against igg, float64 `atol=1e-12` and float32 `rtol=2e-6,
atol=2e-5`, as in tests/test_torch_diffusion.py.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import igg
import igg_torch as it
from igg.models import diffusion3d as d3
from igg.ops.diffusion_trapezoid import (_dim_modes, _extend,
                                         fused_diffusion_trapezoid_steps)
from igg_torch import convert
from igg_torch.models import diffusion3d as t3
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import diffusion_pallas as dp
from igg_torch.ops import diffusion_trapezoid as dtz

from helpers import encoded_block
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-6, 2e-5          # float32, as in tests/test_torch_diffusion.py
SCAL = dict(rdx2=0.3, rdy2=0.25, rdz2=0.2)
PARAMS = d3.Params(lx=8.0, ly=8.0, lz=60.0)

# The meshes of tests/test_trapezoid.py: (dims, periods).
MESHES = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "ring_open": ((8, 1, 1), (0, 0, 0)),
    "4x2x1": ((4, 2, 1), (1, 1, 1)),
    "2x2x2_periodic": ((2, 2, 2), (1, 1, 1)),
    "4x1x2": ((4, 1, 2), (1, 1, 1)),
    "2x2x2_periods010": ((2, 2, 2), (0, 1, 0)),
    "2x2x2_periods101": ((2, 2, 2), (1, 0, 1)),
}


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(local, mesh):
    dims, periods = MESHES[mesh]
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], quiet=True)
    igg.init_global_grid(*local, **kw)
    it.init_global_grid(*local, device="cpu", **kw)
    return igg.get_global_grid(), it.get_global_grid()


def fields(local, seed, dtype=np.float64):
    """Random T (offset by block coordinates) and A as igg arrays, and the
    port's copies."""
    rng = np.random.default_rng(seed)
    T = igg.from_local_blocks(
        lambda c, ls: rng.standard_normal(ls) + 10.0 * c[0] + 100.0 * c[1]
        + 1000.0 * c[2], local, dtype=dtype)
    A = igg.from_local_blocks(lambda c, ls: 0.05 + 0.01 * rng.random(ls),
                              local, dtype=dtype)
    st = convert.to_torch({"T": np.asarray(T), "A": np.asarray(A)})
    return (T, A), (st["T"], st["A"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dim_modes_match_igg(mesh):
    g, tg = init_both((16, 16, 128), mesh)
    assert ce.dim_modes(tg) == _dim_modes(g)


@pytest.mark.parametrize("data", ["encoded", "random"])
@pytest.mark.parametrize("mesh", ["ring_open", "2x2x2_periodic",
                                  "2x2x2_periods010", "2x2x2_periods101"])
def test_extend_fields_matches_igg_bitwise(mesh, data):
    """The K-deep extension, with the replacement of each block's halo rows
    by the neighbours' send rows and the open-edge restore."""
    local, K = (12, 12, 12), 4
    g, tg = init_both(local, mesh)
    if data == "encoded":
        T = igg.from_local_blocks(lambda c, ls: encoded_block(c, ls), local,
                                  dtype=np.float64)
    else:
        T = fields(local, 3)[0][0]
    modes = _dim_modes(g)
    ref = igg.sharded(lambda T: _extend(T, K, g, T.shape, modes),
                      out_specs=P(*igg.AXIS_NAMES), check_vma=False)(T)
    Tt = convert.to_torch({"T": np.asarray(T)})["T"]
    ols = ce.field_ols(tg, [local])
    out = ce.extend_fields([Tt], ols, K, tg, modes)[0]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # Two same-shaped fields share one slab exchange per direction.
    one, two = ce.extend_fields([Tt, 2.0 * Tt], ols * 2, K, tg, modes)
    assert torch.equal(one, out) and torch.equal(two, 2.0 * out)


def port_per_step(T, A, K, grid):
    """K steps of the plain composition: stencil on every block, then the
    plain halo update."""
    for _ in range(K):
        T = it.update_halo(dp.block_diffusion_compute(T, A, grid.nxyz, **SCAL),
                           plain=True)
    return T


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_chunk_matches_per_step_and_igg(mesh, dtype):
    """One K=8 chunk from an exchange-fresh state (the port of
    tests/test_trapezoid.py:_chunk_vs_per_step_open): against K per-step
    steps in the port, bitwise, and against igg's interpret chunk."""
    local, K = (16, 16, 128), 8
    g, tg = init_both(local, mesh)
    (T, A), (Tt, At) = fields(local, 29, dtype)
    T, A = igg.update_halo(T, A)
    it.update_halo(Tt, At, plain=True)
    assert dtz.trapezoid_refusal(tg, local, K, K, Tt.dtype) is None

    out, done = dtz.fused_diffusion_trapezoid_steps(Tt, At, n_inner=K, bx=K,
                                                    grid=tg, **SCAL)
    assert done == K
    np.testing.assert_array_equal(out.numpy(),
                                  port_per_step(Tt, At, K, tg).numpy())

    ref = igg.sharded(
        lambda T, A: fused_diffusion_trapezoid_steps(
            T, A, n_inner=K, bx=K, grid=g, **SCAL, interpret=True)[0],
        check_vma=False)(T, A)
    if dtype == np.float64:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def per_step_route(T, A, n, tp):
    """`n` launches of the fused per-step route."""
    sc = dp.scal(*tp.spacing())
    for _ in range(n):
        T = dp.fused_diffusion_step(T, A, **sc)
    return T


@pytest.mark.parametrize("n_inner", [9, 20])
@pytest.mark.parametrize("mesh", ["2x2x2_periodic", "4x1x2", "ring_periodic",
                                  "ring_open"])
def test_model_path_matches_igg(mesh, n_inner, monkeypatch):
    """`make_multi_step(n_inner)` at 16x16x128 per block takes the chunk
    route (1 warm-up step, (n_inner-1)//8 chunks, the remainder per step),
    matches igg's interpret model path within the float32 tolerance, and
    equals the port's per-step route bitwise."""
    local = (16, 16, 128)
    g, tg = init_both(local, mesh)
    T, Cp = d3.init_fields(PARAMS, dtype=np.float32)
    st = convert.to_torch({"T": np.asarray(T), "Cp": np.asarray(Cp)})
    tp = convert.convert_params(PARAMS, t3.Params)
    calls = []
    real = dtz.fused_diffusion_trapezoid_steps

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[1])
        return out

    monkeypatch.setattr(dtz, "fused_diffusion_trapezoid_steps", spy)
    out = t3.make_multi_step(n_inner, tp)(st["T"], st["Cp"])
    assert calls == [((n_inner - 1) // 8) * 8]

    ref = d3.make_multi_step(n_inner, PARAMS, use_pallas=True,
                             pallas_interpret=True, donate=False, bx=8)(T, Cp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    A = tp.timestep() * tp.lam / st["Cp"]
    np.testing.assert_array_equal(out.numpy(),
                                  per_step_route(st["T"], A, n_inner, tp).numpy())


@pytest.mark.parametrize("local,reason", [((8, 8, 16), "outside the local block"),
                                          ((16, 10, 16), "shared region")])
def test_refused_shape_takes_per_step_route(local, reason, monkeypatch):
    """Shapes whose K=8 send slabs would leave the block (8x8x16) or enter
    the sender's shared region (y extent 10, `admit_send_slabs`) on a
    2x2x2 grid: the per-step route serves, with its own results."""
    g, tg = init_both(local, "2x2x2_periodic")
    assert reason in dtz.trapezoid_refusal(tg, local, 8, 8, torch.float32)
    T, Cp = d3.init_fields(PARAMS, dtype=np.float32)
    st = convert.to_torch({"T": np.asarray(T), "Cp": np.asarray(Cp)})
    tp = convert.convert_params(PARAMS, t3.Params)
    monkeypatch.setattr(dtz, "fused_diffusion_trapezoid_steps",
                        lambda *a, **kw: pytest.fail("chunk route taken"))
    out = t3.make_multi_step(9, tp)(st["T"], st["Cp"])
    A = tp.timestep() * tp.lam / st["Cp"]
    np.testing.assert_array_equal(out.numpy(),
                                  per_step_route(st["T"], A, 9, tp).numpy())


def test_admission_gates():
    it.init_global_grid(16, 16, 128, dimx=2, dimy=2, dimz=2, quiet=True,
                        device="cpu")
    g = it.get_global_grid()
    assert dtz.trapezoid_refusal(g, (16, 16, 128), 8, 8, torch.float32) is None
    assert "full K=8 chunk" in dtz.trapezoid_refusal(g, (16, 16, 128), 8, 7,
                                                     torch.float32)
    assert "float32/float64" in dtz.trapezoid_refusal(g, (16, 16, 128), 8, 8,
                                                      torch.bfloat16)
    assert "K % 8" in dtz.trapezoid_refusal(g, (16, 16, 128), 4, 8,
                                            torch.float32)
    it.finalize_global_grid()
    it.init_global_grid(16, 16, 128, dimx=2, dimy=2, dimz=2, disp=2,
                        periodx=1, quiet=True, device="cpu")
    assert "disp" in dtz.trapezoid_refusal(it.get_global_grid(), (16, 16, 128),
                                           8, 8, torch.float32)
