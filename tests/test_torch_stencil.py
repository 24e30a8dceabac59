"""The port's stencil frontend (igg_torch.stencil) held against igg.stencil
on the CPU.

The same specs are built in both packages; the same state goes through
both through `igg_torch.convert`.  igg runs as tests/test_stencil.py runs
it: its generated per-step kernel and its chunk tier in interpret mode on
the 8-device CPU mesh, its XLA composition for the truth.  The port runs
with `device="cpu"`, where the generated kernels' plain versions serve.

Tolerances: the analyzer exactly; `apply_updates` bitwise against igg's
evaluated eagerly (the same IEEE operations in the same order); the routes
against igg's compiled ones float32 relative 2e-5 of each field's largest
magnitude (igg's chunk tolerance): under `jit`, XLA on the CPU turns a
division by a constant into a product with its reciprocal, which rounds
differently (up to 5e-7 relative here); where igg's own chunk test is
bitwise (periodic), the port's chunk route is bitwise its own per-step
route; a scalar division bitwise against a true division by a 0-dim
tensor; spec-wave2d against the port's hand wave2d, and the rank-3 spec
against the port's hand composition, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import igg
import igg_torch as it
from igg import stencil as ist
from igg.stencil import lower as ilower
from igg_torch import convert
from igg_torch import stencil as tst
from igg_torch.models import wave2d as tw
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import stencil as tops
from igg_torch.ops import wave2d_pallas as wp
from igg_torch.stencil import cuda
from igg_torch.stencil import lower as tlower
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(local, dims, periods, **kw):
    nd = len(local)
    kw = dict(dimx=dims[0], dimy=dims[1],
              dimz=dims[2] if len(dims) > 2 else 1, periodx=periods[0],
              periody=periods[1],
              periodz=periods[2] if len(periods) > 2 else 0, quiet=True, **kw)
    shape = tuple(local) + (1,) * (3 - nd)
    igg.init_global_grid(*shape, **kw)
    it.init_global_grid(*shape, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)
    return it.get_global_grid()


# -- the same specs in both packages ------------------------------------------

def _clamped(m):
    F_ = m.Field("F", stagger=(0, 0))
    r = m.Param("r", default=0.25)
    lap = (F_[-1, 0] + F_[1, 0] + F_[0, -1] + F_[0, 1] - 4.0 * F_[0, 0])
    return m.StencilSpec("clamped", fields=[F_], params=[r], updates=[
        m.Update(F_, m.where(F_[0, 0] > 0.5, 0.0 * F_[0, 0], r * lap),
                 pad=((1, 1), (1, 1)))])


def _relax3d(m):
    T = m.Field("T", stagger=(0, 0, 0))
    r = m.Param("r", default=0.1)
    lap = (T[-1, 0, 0] + T[1, 0, 0] + T[0, -1, 0] + T[0, 1, 0]
           + T[0, 0, -1] + T[0, 0, 1] - 6.0 * T[0, 0, 0])
    return m.StencilSpec("relax3d", fields=[T], params=[r],
                         updates=[m.Update(T, r * lap, pad=((1, 1),) * 3)])


def _drift(m):
    F_ = m.Field("F", stagger=(0, 0))
    return m.StencilSpec("drift", fields=[F_],
                         updates=[m.Update(F_, F_[-1, 0], mode="assign")])


def _wide(m):
    F_ = m.Field("F", stagger=(0, 0))
    return m.StencilSpec("wide", fields=[F_], updates=[
        m.Update(F_, F_[-2, 0] + F_[2, 0], pad=((2, 2), (0, 0)))])


def _bc(bc):
    def make(m):
        F_ = m.Field("F", stagger=(0, 0))
        return m.StencilSpec("s", fields=[F_], bc=bc, updates=[
            m.Update(F_, F_[0, 0], mode="assign")])
    return make


def _scalar_div(m):
    """`Const / Read` and `Read / Const`, and a constant field."""
    F_ = m.Field("F", stagger=(0, 0))
    G = m.Field("G", stagger=(0, 0))
    return m.StencilSpec("scalar_div", fields=[F_, G], updates=[
        m.Update(F_, 3.0 / F_[0, 0] + G[0, 0] / 0.7, pad=((1, 1), (1, 1)))])


SPECS = {
    "wave2d_spec": lambda m: m.wave2d_spec(),
    "shallow_water": lambda m: m.shallow_water_spec(),
    "shallow_water_cf": lambda m: m.shallow_water_spec(cf=0.1),
    "clamped": _clamped,
    "relax3d": _relax3d,
    "drift": _drift,
    "wide": _wide,
    "bc_reflect": _bc(("reflect", "periodic")),
    "bc_periodic_any": _bc(("periodic", "any")),
    "scalar_div": _scalar_div,
}
COEFFS = {
    "wave2d_spec": dict(dt=0.05, dx=0.31, dy=0.27, rho=1.3, K=0.7),
    "shallow_water": dict(dt=0.05, dx=0.31, dy=0.27, g=9.81, H=1.0),
    "shallow_water_cf": dict(dt=0.05, dx=0.31, dy=0.27, g=9.81, H=1.0),
    "clamped": dict(r=0.25),
    "relax3d": dict(r=0.1),
    "scalar_div": {},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_analyzer_matches_igg(name):
    a = ist.analyze(SPECS[name](ist))
    b = tst.analyze(SPECS[name](tst))
    assert b.radius == a.radius
    assert b.halo_radius == a.halo_radius
    assert b.freeze == a.freeze
    assert b.accesses == a.accesses
    assert b.const_fields == a.const_fields
    for K in range(1, 9):
        assert b.margin_after(K) == a.margin_after(K), K
        assert b.open_chunk_ok(K) == a.open_chunk_ok(K), K


@pytest.mark.parametrize("name", sorted(SPECS))
def test_admissible_matches_igg_without_grid(name):
    a = ist.admissible(SPECS[name](ist))
    why = tst.admissible(SPECS[name](tst))
    assert (why is None) == bool(a)
    if why is not None:
        assert why == a.reason


def test_shallow_water_analysis_facts():
    """Per-dim freeze sets and the analyzer's margin: E = K, half the hand
    wave2d chunk's 2K."""
    a = tst.analyze(tst.shallow_water_spec())
    assert a.freeze == {0: (1,), 1: (2,)}
    assert [a.margin_after(K) for K in (2, 4, 8)] == [2, 4, 8]
    assert all(a.open_chunk_ok(K) for K in (2, 4, 8))
    assert a.accesses == 6


# -- the spec API and the gates (tests/test_stencil.py) ------------------------

def test_spec_validation_errors():
    F_ = tst.Field("F", stagger=(0, 0))
    G = tst.Field("G", stagger=(0, 0))
    with pytest.raises(it.GridError, match="undeclared field"):
        tst.StencilSpec("s", fields=[F_], updates=[tst.Update(F_, G[0, 0])])
    with pytest.raises(it.GridError, match="stagger"):
        tst.Field("bad", stagger=(2, 0))
    with pytest.raises(it.GridError, match="1-D offset"):
        F_.shift(1)
    with pytest.raises(it.GridError, match="no updates"):
        tst.StencilSpec("s", fields=[F_], updates=[])
    with pytest.raises(it.GridError, match="twice"):
        tst.StencilSpec("s", fields=[F_], updates=[
            tst.Update(F_, F_[0, 0]), tst.Update(F_, F_[0, 0])])
    spec = tst.StencilSpec("s", fields=[F_],
                           updates=[tst.Update(F_, F_[0, 0], mode="assign")],
                           params=[tst.Param("a")])
    with pytest.raises(it.GridError, match="no value"):
        spec.coeffs()
    with pytest.raises(it.GridError, match="unknown coeffs"):
        spec.coeffs({"a": 1.0, "zz": 2.0})


def test_eq_ne_are_traced_comparisons():
    from igg_torch.stencil.spec import BinOp

    F_ = tst.Field("F", stagger=(0, 0))
    e = F_[0, 0] == 0
    assert isinstance(e, BinOp) and e.op == "eq"
    n = F_[0, 0] != 0
    assert isinstance(n, BinOp) and n.op == "ne"
    assert len({F_, tst.Param("p")}) == 2


@pytest.mark.parametrize("use_kernels", [False, "auto"])
def test_where_mask_lowers(use_kernels):
    """A clamped relaxation where every cell is above the clamp stays as it
    was (the plain composition, and the kernels' plain versions)."""
    it.init_global_grid(6, 6, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    A = it.update_halo(it.zeros((6, 6), dtype=torch.float64) + 0.6)
    step = tst.compile(_clamped(tst), use_kernels=use_kernels)
    (out,) = step(A)
    torch.testing.assert_close(out, A, rtol=0, atol=0)
    gen = cuda.kernels_for(_clamped(tst), {"r": 0.25})
    (out,) = tlower.fused_spec_steps(gen, (A,), n_inner=1)
    torch.testing.assert_close(out, A, rtol=0, atol=0)


def test_analyzer_open_recurrence_refuses_self_negative_assign():
    assert not tst.analyze(_drift(tst)).open_chunk_ok(2)


def test_gate_unsupported_bc():
    spec = _bc(("reflect", "periodic"))(tst)
    assert "unsupported boundary condition" in tst.admissible(spec)
    it.init_global_grid(6, 6, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    with pytest.raises(it.GridError, match="unsupported boundary"):
        tst.compile(spec)


def test_gate_bc_grid_mismatch():
    spec = _bc(("periodic", "any"))(tst)
    it.init_global_grid(6, 6, 1, quiet=True, device="cpu")
    assert "requires a periodic dim 0" in tst.admissible(spec)
    with pytest.raises(it.GridError, match="requires a periodic dim 0"):
        tst.compile(spec)


def test_gate_oversized_read_radius():
    spec = _wide(tst)
    it.init_global_grid(6, 6, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    why = tst.admissible(spec)
    assert "oversized read radius" in why and "overlap >= 3" in why
    with pytest.raises(it.GridError, match="oversized read radius"):
        tst.compile(spec)
    it.finalize_global_grid()
    it.init_global_grid(6, 6, 1, periodx=1, periody=1, overlapx=3,
                        overlapy=3, quiet=True, device="cpu")
    assert tst.admissible(spec) is None


def test_gate_read_outside_write_region():
    spec = _drift(tst)
    why = tst.admissible(spec)
    assert "outside the source array" in why and "[0, 0]" in why
    it.init_global_grid(6, 6, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    with pytest.raises(it.GridError, match="outside the source array"):
        tst.compile(spec)
    assert tst.admissible(tst.wave2d_spec()) is None


def test_kernel_refusals():
    """A non-overlap-2 grid and a 2-D spec on a 3-D decomposition are
    refused by the kernels' gate, `use_kernels=True` on the CPU raises,
    and "auto" on the CPU takes the plain composition."""
    spec, cf = tst.shallow_water_spec(), COEFFS["shallow_water"]
    it.init_global_grid(8, 8, 1, periodx=1, periody=1, overlapx=3,
                        overlapy=3, quiet=True, device="cpu")
    S = [it.zeros(s) for s in tlower.field_shapes(spec, (8, 8))]
    why = tlower.kernel_refusal(spec, it.get_global_grid(), S)
    assert "overlaps" in why
    with pytest.raises(it.GridError, match="overlaps"):
        tst.compile(spec, coeffs=cf, use_kernels=True)(*S)
    out = tst.compile(spec, coeffs=cf)(*S)          # "auto": plain
    assert [tuple(o.shape) for o in out] == [tuple(A.shape) for A in S]
    it.finalize_global_grid()
    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, quiet=True,
                        device="cpu")
    S = [it.zeros(s) for s in tlower.field_shapes(spec, (8, 8))]
    assert "2-D decomposition" in tlower.kernel_refusal(
        spec, it.get_global_grid(), S)
    with pytest.raises(it.GridError, match="2-D decomposition"):
        tst.compile(spec, coeffs=cf, use_kernels=True)(*S)
    it.finalize_global_grid()
    it.init_global_grid(8, 8, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    S = [it.zeros(s) for s in tlower.field_shapes(spec, (8, 8))]
    assert tlower.kernel_refusal(spec, it.get_global_grid(), S) is None
    with pytest.raises(it.GridError, match="needs CUDA tensors"):
        tst.compile(spec, coeffs=cf, use_kernels=True)(*S)
    with pytest.raises(it.GridError, match="chunk=True"):
        tst.compile(spec, coeffs=cf, use_kernels=False, chunk=True)


def test_generator_refusals():
    F_ = tst.Field("F", stagger=(0, 0))
    for expr, what in ((F_[0, 0] ** 0.5, "pow"),
                       ((F_[0, 0] > 0) * 2.0, "comparison")):
        spec = tst.StencilSpec("r", fields=[F_], updates=[
            tst.Update(F_, expr, pad=((1, 1), (1, 1)))])
        with pytest.raises(it.GridError, match=what):
            cuda.generate(spec, {})
    V = tst.Field("V", stagger=(1, 0, 0))
    spec = tst.StencilSpec("r3", fields=[V], updates=[
        tst.Update(V, V[0, 0, 0], mode="assign")])
    assert "outer face" in cuda.generator_refusal(spec, {})


# -- apply_updates against igg's ----------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["wave2d_spec", "shallow_water",
                                  "shallow_water_cf", "clamped", "relax3d",
                                  "scalar_div"])
def test_apply_updates_matches_igg(name, dtype):
    spec_i, spec_t = SPECS[name](ist), SPECS[name](tst)
    base = (9, 7, 6)[:spec_t.ndim]
    rng = np.random.default_rng(3)
    fields = [rng.uniform(0.5, 1.5, tuple(b + s for b, s in
                                          zip(base, f.stagger))).astype(dtype)
              for f in spec_t.fields]
    ref = ilower.apply_updates(spec_i, [jnp.asarray(a) for a in fields],
                               COEFFS[name])
    got = tlower.apply_updates(spec_t, [torch.from_numpy(a) for a in fields],
                               COEFFS[name], blocks=(1,) * spec_t.ndim)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scalar_division_is_a_true_division(dtype):
    """`Const / Read` and `Read / Const` divide by 0-dim tensors of the
    field's dtype: bitwise `3 / F` and `G / 0.7` as true divisions (not
    PyTorch's `F.reciprocal() * 3` or `G * (1 / 0.7)`)."""
    spec = _scalar_div(tst)
    rng = np.random.default_rng(5)
    Fv, Gv = (torch.from_numpy(rng.uniform(0.5, 1.5, (9, 7))).to(dtype)
              for _ in range(2))
    got, G_out = tlower.apply_updates(spec, [Fv, Gv], {}, blocks=(1, 1))
    three, c07 = torch.tensor(3.0, dtype=dtype), torch.tensor(0.7, dtype=dtype)
    delta = three / Fv[1:-1, 1:-1] + Gv[1:-1, 1:-1] / c07
    torch.testing.assert_close(got, Fv + F.pad(delta, (1, 1, 1, 1)), rtol=0,
                               atol=0)
    assert G_out is Gv


# -- the routes against igg's ------------------------------------------------

def _sw_state(local, dims, periods, dtype=np.float32):
    from igg.models import shallow_water as isw

    init_both(local, dims, periods)
    p = isw.Params()
    state = isw.init_fields(p, dtype=dtype)
    state = ist.compile(ist.shallow_water_spec(), coeffs=p.coeffs(),
                        donate=False, n_inner=2, use_pallas=False)(*state)
    port = convert.to_torch({n: np.asarray(a)
                             for n, a in zip("abc", state)})
    return p, state, tuple(port[n] for n in "abc")


def _close(port, ref, rel):
    for a, b in zip(port, ref):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * (np.abs(b).max() + 1e-30)


@pytest.mark.parametrize("local,dims,periods", [
    ((8, 8), (4, 2), (1, 1)), ((8, 8), (4, 2), (0, 0)),
    ((8, 8), (4, 2), (1, 0)), ((8, 8), (2, 4), (0, 1)),
    ((18, 10), (1, 1), (1, 1))],
    ids=["4x2_periodic", "4x2_open", "4x2_mixed", "2x4_mixed", "one_block"])
def test_per_step_route_matches_igg(local, dims, periods):
    p, state, S = _sw_state(local, dims, periods)
    n = 5
    ref = ist.compile(ist.shallow_water_spec(), coeffs=p.coeffs(),
                      donate=False, n_inner=n, use_pallas=True,
                      pallas_interpret=True, chunk=False)(*state)
    gen = cuda.kernels_for(tst.shallow_water_spec(), p.coeffs())
    got = tlower.fused_spec_steps(gen, S, n_inner=n, chunk=False)
    _close(got, ref, 2e-5)
    plain = tst.compile(tst.shallow_water_spec(), coeffs=p.coeffs(),
                        n_inner=n, use_kernels=False)(*S)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("periods", [(1, 1), (0, 0), (1, 0)],
                         ids=["periodic", "open", "mixed"])
def test_chunk_route_matches_igg_wave2d_setup(periods):
    """igg's test_wave2d_spec_matches_hand_ladder setup: spec-wave2d on the
    8-device mesh, 7 steps, K = 4."""
    from igg.models import wave2d as iw

    init_both((8, 8), (4, 2), periods)
    ip = iw.Params()
    state = iw.init_fields(ip)
    cf = ist.wave2d_coeffs(ip)
    ref = ist.compile(ist.wave2d_spec(), coeffs=cf, donate=False, n_inner=7,
                      use_pallas=True, pallas_interpret=True, chunk=True,
                      K=4)(*state)
    S = convert.to_torch({n: np.asarray(a) for n, a in zip("abc", state)})
    gen = cuda.kernels_for(tst.wave2d_spec(),
                           tst.wave2d_coeffs(convert.convert_params(
                               ip, tw.Params)))
    got = tlower.fused_spec_steps(gen, tuple(S[n] for n in "abc"), n_inner=7,
                                  K=4, chunk=True)
    _close(got, ref, 2e-5)
    if periods == (1, 1):
        per_step = tlower.fused_spec_steps(gen, tuple(S[n] for n in "abc"),
                                           n_inner=7, chunk=False)
        for a, b in zip(got, per_step):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_chunk_route_matches_igg_shallow_water_setup():
    """igg's test_shallow_water_mass_conserved_and_tiers chunk check: 5
    steps at K = 4 on the periodic 8-device mesh; bitwise against the
    port's per-step route, as igg's chunk is against its composition."""
    from igg.models import shallow_water as isw

    init_both((8, 8), (4, 2), (1, 1))
    p = isw.Params()
    state = isw.init_fields(p)
    ref = isw.make_step(p, donate=False, n_inner=5, use_pallas=True,
                        pallas_interpret=True, chunk=True, K=4)(*state)
    S = convert.to_torch({n: np.asarray(a) for n, a in zip("abc", state)})
    gen = cuda.kernels_for(tst.shallow_water_spec(), p.coeffs())
    S = tuple(S[n] for n in "abc")
    got = tlower.fused_spec_steps(gen, S, n_inner=5, K=4, chunk=True)
    _close(got, ref, 2e-5)
    per_step = tlower.fused_spec_steps(gen, S, n_inner=5, chunk=False)
    for a, b in zip(got, per_step):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- spec against hand, inside the port ----------------------------------------

@pytest.mark.parametrize("periods", [(1, 1), (0, 0), (1, 0)],
                         ids=["periodic", "open", "mixed"])
def test_wave2d_spec_matches_port_hand_wave2d(periods):
    """Spec-wave2d is bitwise the port's hand wave2d: the plain composition,
    the per-step route, and on the periodic grid the chunk route (E = K
    against the hand chunk's E = 2K)."""
    it.init_global_grid(16, 16, 1, dimx=4, dimy=2, dimz=1,
                        periodx=periods[0], periody=periods[1], quiet=True,
                        device="cpu")
    tp = tw.Params()
    S = it.update_halo(*tw.init_fields(tp))
    S = tw.make_multi_step(2, tp, use_kernels=False)(*S)
    cf, kw = tst.wave2d_coeffs(tp), tp.step_kwargs()
    n = 7
    hand = S
    for _ in range(n):
        hand = wp.fused_wave2d_step(*hand, **kw)
    plain = tst.compile(tst.wave2d_spec(), coeffs=cf, n_inner=n,
                        use_kernels=False)(*S)
    gen = cuda.kernels_for(tst.wave2d_spec(), cf)
    per_step = tlower.fused_spec_steps(gen, S, n_inner=n, chunk=False)
    for got in (plain, per_step):
        for a, b in zip(got, hand):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    if periods == (1, 1):
        chunk = tlower.fused_spec_steps(gen, S, n_inner=n, K=4, chunk=True)
        hand_chunk = wp.fused_wave2d_steps(*S, n_inner=n, K=2, **kw)
        for a, b, c in zip(chunk, hand_chunk, hand):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("periods", [(1, 1, 1), (0, 0, 0)],
                         ids=["periodic", "open"])
def test_rank3_spec_matches_hand_composition(periods):
    """relax3d on the (2,2,2) grid is bitwise the port's hand-written
    composition, on the plain path and the per-step route."""
    it.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=periods[0],
                        periody=periods[1], periodz=periods[2], quiet=True,
                        device="cpu")
    rng = np.random.default_rng(7)
    A0 = it.update_halo(it.from_local_blocks(
        lambda c, ls: rng.standard_normal(ls), (6, 6, 6), dtype=torch.float32))
    blocks = (2, 2, 2)

    def hand_step(A):
        v = A.reshape(2, 6, 2, 6, 2, 6)
        c = v[:, 1:-1, :, 1:-1, :, 1:-1]
        lap = (v[:, :-2, :, 1:-1, :, 1:-1] + v[:, 2:, :, 1:-1, :, 1:-1]
               + v[:, 1:-1, :, :-2, :, 1:-1] + v[:, 1:-1, :, 2:, :, 1:-1]
               + v[:, 1:-1, :, 1:-1, :, :-2] + v[:, 1:-1, :, 1:-1, :, 2:]
               - 6.0 * c)
        pad = ((0, 0), (1, 1)) * 3
        return it.update_halo(tops.interior_add(v, 0.1 * lap, pad)
                              .reshape(A.shape).contiguous())

    ref = A0
    for _ in range(5):
        ref = hand_step(ref)
    assert blocks == it.get_global_grid().dims
    spec = _relax3d(tst)
    (plain,) = tst.compile(spec, n_inner=5, use_kernels=False)(A0)
    gen = cuda.kernels_for(spec, {"r": 0.1})
    (fused,) = tlower.fused_spec_steps(gen, (A0,), n_inner=5)
    torch.testing.assert_close(plain, ref, rtol=0, atol=0)
    torch.testing.assert_close(fused, ref, rtol=0, atol=0)


# -- the per-dim freeze --------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_chunk_plain_per_dim_freeze_matches_igg(dtype):
    """A 2-D open one-block spec window ("frozen" on both dims, the
    analyzer's per-dim freeze sets): the port's `window_chunk_plain`
    against igg's `window_chunk_xla`."""
    from igg.ops import chunk_engine as ice

    init_both((10, 9), (1, 1), (0, 0))
    grid_i, grid_t = igg.get_global_grid(), it.get_global_grid()
    spec_i, spec_t = ist.shallow_water_spec(cf=0.1), tst.shallow_water_spec(
        cf=0.1)
    cf = COEFFS["shallow_water_cf"]
    freeze = tst.analyze(spec_t).freeze
    shapes = tlower.field_shapes(spec_t, (10, 9))
    rng = np.random.default_rng(9)
    fields = [rng.uniform(-1, 1, s).astype(dtype) for s in shapes]
    K, E, modes = 4, 4, ("frozen", "frozen")
    ols = ce.field_ols(grid_t, shapes)
    ref = ice.window_chunk_xla(
        tuple(jnp.asarray(a) for a in fields), K=K, E=E, modes=modes,
        grid=grid_i, ols=ols, shapes=shapes, freeze_fields=freeze,
        core=lambda *w: ilower.apply_updates(spec_i, w, cf))
    got = ce.window_chunk_plain(
        [torch.from_numpy(a) for a in fields], K=K, E=E, modes=modes,
        grid=grid_t, freeze_fields=freeze, ols=ols,
        core=lambda *w: tlower.apply_updates(spec_t, w, cf, blocks=(1, 1)))
    rel = 1e-12 if dtype == np.float64 else 2e-5
    for a, b in zip(got, ref):
        b = np.asarray(b, np.float64)
        assert np.abs(a.numpy() - b).max() <= rel * np.abs(b).max()
    # Frozen per dim: hu keeps its x boundary rows, not its y edges.
    hu0 = torch.from_numpy(fields[1])
    assert torch.equal(got[1][0], hu0[0]) and torch.equal(got[1][-1], hu0[-1])
    assert not torch.equal(got[1][1:-1, 0], hu0[1:-1, 0])


def test_sequence_freeze_is_every_dim():
    """A sequence freeze is the dict that names it on every dim, and gives
    what the Stokes rule gave: every named field frozen on every open
    dim."""
    it.init_global_grid(10, 9, 1, dimx=2, dimy=1, dimz=1, quiet=True,
                        device="cpu")
    g = it.get_global_grid()
    assert ce.normalize_freeze((1, 2), 2) == {0: (1, 2), 1: (1, 2)}
    assert ce.normalize_freeze({1: [2]}, 2) == {0: (), 1: (2,)}
    spec = tst.shallow_water_spec()
    shapes = tlower.field_shapes(spec, (10, 9))
    modes = ce.dim_modes(g)[:2]
    rng = np.random.default_rng(11)
    S = [torch.from_numpy(rng.uniform(-1, 1, it.stacked_shape(s)))
         for s in shapes]
    exts = ce.extend_fields(S, ce.field_ols(g, shapes), 2, g, modes)
    core = lambda *w: tlower.apply_updates(spec, w, COEFFS["shallow_water"],
                                           blocks=(2, 1))
    runs = [ce.window_chunk_plain(list(exts), K=2, E=2, modes=modes, grid=g,
                                  core=core, freeze_fields=fz,
                                  ols=ce.field_ols(g, shapes))
            for fz in ((1, 2), {0: (1, 2), 1: (1, 2)})]
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
