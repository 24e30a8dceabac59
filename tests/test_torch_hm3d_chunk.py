"""The port's HM3D K-step chunk route held against igg on the CPU.

igg's side runs as tests/test_chunk_engine.py:60-125 runs it: its model
path with `use_pallas=True, pallas_interpret=True, trapezoid=True, K=K`
(a warm-up step, `(n_inner-1)//K` chunks through the pure-XLA window
realization, the remainder per step) on igg's `_hm3d_compare` meshes at
16x16x128 per block.  The port runs with `device="cpu"`, where the chunk
kernel's plain version serves.  Tolerances: against igg, igg's own float32
relative 2e-5 of each field's largest magnitude, and float64 relative
1e-12 against its XLA path; against the port's per-step route and plain
path, 0 (the same arithmetic on the same cells).
"""

import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.models import hm3d as ih
from igg_torch import convert
from igg_torch.models import hm3d as th
from igg_torch.ops import hm3d_pallas as hp
from igg_torch.ops import hm3d_trapezoid as htz

PARAMS = ih.Params(lx=4.0, ly=4.0, lz=4.0)
REL = {np.float32: 2e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def setup(dims, periods, dtype=np.float32, local=(16, 16, 128)):
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], quiet=True)
    igg.init_global_grid(*local, **kw)
    it.init_global_grid(*local, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)
    Pe, phi = ih.init_fields(PARAMS, dtype=dtype)
    st = convert.to_torch({"Pe": np.asarray(Pe), "phi": np.asarray(phi)})
    return (Pe, phi), (st["Pe"], st["phi"]), \
        convert.convert_params(PARAMS, th.Params)


def close(port, ref, dtype=np.float32):
    for name, a, b in zip(("Pe", "phi"), port, ref):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
        assert rel < REL[dtype], (name, rel)


def same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def per_step_route(state, n, tp):
    for _ in range(n):
        state = hp.fused_hm3d_step(*state, **tp.step_kwargs())
    return state


def spy_chunks(monkeypatch):
    """Record the steps each call of the chunk driver advances."""
    calls = []
    real = htz.fused_hm3d_trapezoid_steps

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[-1])
        return out

    monkeypatch.setattr(htz, "fused_hm3d_trapezoid_steps", spy)
    return calls


# igg's `_hm3d_compare` matrix (tests/test_chunk_engine.py:85-125):
# (dims, periods, K, n_inner).
COMPARE = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1), 4, 5),
    "ring_open": ((8, 1, 1), (0, 0, 0), 4, 5),
    "torus_mixed": ((2, 2, 2), (0, 1, 0), 8, 9),
    "with_remainder": ((8, 1, 1), (1, 1, 1), 4, 7),
}


@pytest.mark.parametrize("case", sorted(COMPARE))
def test_chunk_route_matches_igg_trapezoid(case, monkeypatch):
    """`make_multi_step(n_inner, K=K)` takes the chunk route (a warm-up step,
    `(n_inner-1)//K` chunks, the remainder per step), matches igg's
    interpret-mode chunk tier, and equals the port's per-step route and
    plain path bitwise."""
    dims, periods, K, n_inner = COMPARE[case]
    (Pe, phi), state, tp = setup(dims, periods)
    calls = spy_chunks(monkeypatch)
    out = th.make_multi_step(n_inner, tp, K=K)(*state)
    assert calls == [(n_inner - 1) // K * K]
    ref = ih.make_step(PARAMS, donate=False, n_inner=n_inner, use_pallas=True,
                       pallas_interpret=True, trapezoid=True, K=K)(Pe, phi)
    assert igg.degrade.active().get("hm3d") == "hm3d.trapezoid"
    close(out, ref)
    same(out, per_step_route(state, n_inner, tp))
    same(out, th.make_multi_step(n_inner, tp, use_kernels=False)(*state))


def test_single_block_frozen_chunk_matches_igg():
    """One open block (every dim "frozen", both fields' boundary planes
    re-frozen): the port's make_multi_step takes the K-step loop there, so
    its chunk driver is called directly, after the warm-up step, as igg's
    chunk tier runs it."""
    K = 4
    (Pe, phi), state, tp = setup((1, 1, 1), (0, 0, 0))
    ref = ih.make_step(PARAMS, donate=False, n_inner=K + 1, use_pallas=True,
                       pallas_interpret=True, trapezoid=True, K=K)(Pe, phi)
    kw = tp.step_kwargs()
    warm = hp.fused_hm3d_step(*state, **kw)
    *out, done = htz.fused_hm3d_trapezoid_steps(
        *warm, n_inner=K, K=K, grid=it.get_global_grid(), **kw)
    assert done == K
    close(out, ref)
    same(out, per_step_route(state, K + 1, tp))
    same(out, th.make_multi_step(K + 1, tp)(*state))


@pytest.mark.parametrize("periods", [(1, 1, 1), (1, 0, 1)],
                         ids=["periodic", "periods101"])
def test_chunk_route_f64_matches_igg_xla(periods, monkeypatch):
    """float64 (igg gates its chunk tier to float32): the port's chunk route
    on 2x2x2 blocks against igg's XLA path within relative 1e-12."""
    (Pe, phi), state, tp = setup((2, 2, 2), periods, np.float64)
    calls = spy_chunks(monkeypatch)
    out = th.make_multi_step(9, tp)(*state)
    assert calls == [8]
    ref = ih.make_step(PARAMS, donate=False, n_inner=9,
                       use_pallas=False)(Pe, phi)
    close(out, ref, np.float64)
    same(out, per_step_route(state, 9, tp))


@pytest.mark.parametrize("local,reason", [
    ((8, 8, 16), "dim-0 send slabs enter the sender's shared region"),
    ((16, 10, 16), "dim-1 send slabs enter the sender's shared region")])
def test_refused_shape_takes_per_step_route(local, reason, monkeypatch):
    """Shapes whose K=8 send slabs would enter the sender's shared region
    (x extent 8, y extent 10) on a 2x2x2 grid: the per-step route serves,
    with its own results."""
    _, state, tp = setup((2, 2, 2), (1, 1, 1), local=local)
    assert reason in htz.hm3d_trapezoid_refusal(it.get_global_grid(), local,
                                                8, 8, torch.float32)
    monkeypatch.setattr(htz, "fused_hm3d_trapezoid_steps",
                        lambda *a, **kw: pytest.fail("chunk route taken"))
    out = th.make_multi_step(9, tp)(*state)
    same(out, per_step_route(state, 9, tp))
