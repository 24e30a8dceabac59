"""The port's comm/compute overlap (igg_torch.overlap) held against igg's on
the CPU.

igg runs on its 8 virtual CPU devices, the port with `device="cpu"` and the
same 8 blocks stacked (`init_global_grid(6, 6, 6)` is 2x2x2 blocks), from
one float64 state made with a numpy seed.  `hide_communication` in both
forms (on stacked arrays, and inside `igg_torch.sharded` on local blocks),
each family's `local_step`/`local_iteration(overlap=True)` and factory
`overlap=True, use_kernels=False`, and the spec `compile(overlap=True)`
equal the port's sequential composition bitwise (igg's documented
overlap contract: overlapped equals sequential), and lie within igg's own
tolerance of igg's `overlap=True` (tests/test_overlap.py: rtol 1e-12,
atol 1e-9).  igg itself misses the bitwise contract on its compiled spec steps (XLA
compiles the slabs and the full domain differently), so its output is not
truth there.  Admission verdicts and reasons equal igg's.  igg's runs are
shared through module-scoped fixtures.
"""

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.fields import sharding_for
from igg.models import diffusion3d as id3
from igg.models import hm3d as ih3
from igg.models import stokes3d as ist
from igg.models import wave2d as iw2
from igg_torch import convert, degrade, overlap
from igg_torch import stencil as tst
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as td3
from igg_torch.models import hm3d as th3
from igg_torch.models import stokes3d as tst3
from igg_torch.models import wave2d as tw2
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-9)      # igg's, tests/test_overlap.py:60
PERIODS = [(1, 1, 1), (0, 0, 0), (1, 0, 1)]
OL3 = dict(overlapx=3, overlapy=3, overlapz=3)


@pytest.fixture(autouse=True)
def _clean_torch_grid(monkeypatch):
    monkeypatch.delenv("IGG_OVERLAP", raising=False)
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()


def grid_kw(periods=(1, 1, 1), **kw):
    return dict(periodx=periods[0], periody=periods[1], periodz=periods[2],
                quiet=True, **kw)


def seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def stacked_shape(local, dims):
    return tuple(s * d for s, d in zip(local, dims))


# -- the test stencils ------------------------------------------------------

def igg_stencil(A):
    """igg's radius-1 slice-based stencil (tests/test_overlap.py)."""
    out = 0.1 * A
    for d in range(A.ndim):
        lo = [slice(None)] * A.ndim
        hi = [slice(None)] * A.ndim
        mid = [slice(None)] * A.ndim
        lo[d], hi[d], mid[d] = slice(0, -2), slice(2, None), slice(1, -1)
        out = out.at[tuple(mid)].add(0.15 * (A[tuple(lo)] + A[tuple(hi)]))
    return out


def port_stencil(A):
    """The same stencil on every block of a grid array (stacked, a stack
    of slabs, or one local block inside `igg_torch.sharded`)."""
    s = it.get_global_grid().local_shape_any(A)
    split = []
    for d in range(A.ndim):
        split += [A.shape[d] // s[d], s[d]]
    V = A.reshape(split)
    out = 0.1 * V
    for d in range(A.ndim):
        ax = 2 * d + 1

        def sl(a, b):
            idx = [slice(None)] * V.ndim
            idx[ax] = slice(a, b)
            return tuple(idx)
        out[sl(1, -1)] += 0.15 * (V[sl(0, -2)] + V[sl(2, None)])
    return out.reshape(A.shape)


def igg_coupled(Vx, P):
    """igg's face/centre pair with the face field first
    (tests/test_overlap.py::test_multi_field_negative_stagger_base)."""
    div = Vx[1:, :, :] - Vx[:-1, :, :]
    Pn = P.at[1:-1, 1:-1, 1:-1].add(-0.1 * div[1:-1, 1:-1, 1:-1])
    gr = P[1:, :, :] - P[:-1, :, :]
    Vn = Vx.at[1:-1, 1:-1, 1:-1].add(-0.1 * gr[:, 1:-1, 1:-1])
    return Vn, Pn


def port_coupled(Vx, P):
    g = it.get_global_grid()
    sv, sp = g.local_shape_any(Vx), g.local_shape_any(P)
    n = [P.shape[d] // sp[d] for d in range(3)]
    v = Vx.reshape(n[0], sv[0], n[1], sv[1], n[2], sv[2])
    p = P.reshape(n[0], sp[0], n[1], sp[1], n[2], sp[2])
    i = slice(1, -1)
    a = slice(None)
    div = v[:, 1:] - v[:, :-1]
    Pn = p.clone()
    Pn[:, i, :, i, :, i] += -0.1 * div[:, i, :, i, :, i]
    gr = p[:, 1:] - p[:, :-1]
    Vn = v.clone()
    Vn[:, i, :, i, :, i] += -0.1 * gr[:, a, :, i, :, i]
    return Vn.reshape(Vx.shape), Pn.reshape(P.shape)


# -- hide_communication against igg ------------------------------------------

# name -> (grid keywords, local shapes of the primaries, igg compute, port
# compute, steps)
CASES = {
    "periodic": (grid_kw((1, 1, 1)), [(6, 6, 6)], igg_stencil, port_stencil, 1),
    "open": (grid_kw((0, 0, 0)), [(6, 6, 6)], igg_stencil, port_stencil, 1),
    "mixed_101": (grid_kw((1, 0, 1)), [(6, 6, 6)], igg_stencil,
                  port_stencil, 1),
    "multi_step_periodic": (grid_kw((1, 1, 1)), [(6, 6, 6)], igg_stencil,
                            port_stencil, 5),
    "staggered_x": (grid_kw((1, 1, 1)), [(7, 6, 6)], igg_stencil,
                    port_stencil, 1),
    "two_d": (grid_kw((1, 0, 1)), [(6, 6)], igg_stencil, port_stencil, 1),
    "self_neighbor_y": (grid_kw((1, 1, 1), dimx=4, dimy=1, dimz=2),
                        [(6, 6, 6)], igg_stencil, port_stencil, 1),
    "negative_stagger_base": (grid_kw((1, 1, 1), **OL3), [(9, 8, 8),
                                                          (8, 8, 8)],
                              igg_coupled, port_coupled, 3),
}


def case_state(name):
    """The primaries of case `name` on the live igg grid, stacked numpy."""
    g = igg.get_global_grid()
    _, shapes, _, _, _ = CASES[name]
    return [seeded(stacked_shape(s, g.dims), 11 + i)
            for i, s in enumerate(shapes)]


def case_local(name):
    return (8, 8, 8) if name == "negative_stagger_base" else (6, 6, 6)


def igg_case(name):
    kw, shapes, comp, _, steps = CASES[name]
    igg.init_global_grid(*case_local(name), **kw)
    arrays = case_state(name)
    S = tuple(jax.device_put(a, sharding_for(a.ndim)) for a in arrays)

    @igg.sharded
    def step(*S):
        return igg.hide_communication(S if len(S) > 1 else S[0], comp)

    for _ in range(steps):
        S = step(*S)
        S = S if isinstance(S, tuple) else (S,)
    out = [np.asarray(a) for a in S]
    igg.finalize_global_grid()
    return arrays, out


@pytest.fixture(scope="module")
def igg_cases():
    return {name: igg_case(name) for name in CASES}


def port_grid(name):
    it.init_global_grid(*case_local(name), device="cpu", nprocs=8,
                        **CASES[name][0])


def port_run(name, arrays, form):
    _, shapes, _, comp, steps = CASES[name]
    S = tuple(torch.from_numpy(a.copy()) for a in arrays)
    single = len(S) == 1

    def hidden(*S):
        out = it.hide_communication(S[0] if single else S, comp,
                                    plain=form == "stacked_plain")
        return (out,) if single else out

    def sequential(*S):
        out = comp(*S)
        out = it.update_halo_local(*((out,) if single else out))
        return (out,) if single else out

    if form == "sharded":
        hidden, sequential = (it.sharded(f) for f in (hidden, sequential))
    H = Q = S
    for _ in range(steps):
        H, Q = hidden(*H), sequential(*Q)
        H = H if isinstance(H, tuple) else (H,)
        Q = Q if isinstance(Q, tuple) else (Q,)
    return H, Q


@pytest.mark.parametrize("form", ["stacked", "stacked_plain", "sharded"])
@pytest.mark.parametrize("name", list(CASES))
def test_hide_communication_matches_igg_and_sequential(igg_cases, name, form):
    """Both forms (and the writer's plain version) against igg's
    `hide_communication` and bitwise the port's sequential composition."""
    arrays, ref = igg_cases[name]
    port_grid(name)
    H, Q = port_run(name, arrays, form)
    for h, q, r in zip(H, Q, ref):
        assert torch.equal(h, q)
        np.testing.assert_allclose(h.numpy(), r, **TOL)


def test_hide_communication_leaves_inputs_and_counts_once():
    """The inputs stay as they were; an output that is an input is copied;
    a loop of calls counts one trace, one record and one span."""
    port_grid("open")
    A = torch.from_numpy(seeded((12, 12, 12), 5))
    A0 = A.clone()
    before = tel.counter("igg_hide_communication_traces_total").value
    kinds = []
    tel.subscribe(kinds.append)
    try:
        for _ in range(4):
            out = it.hide_communication(A, port_stencil)
        same = it.hide_communication(A, lambda B: B)
    finally:
        tel.unsubscribe(kinds.append)
    assert torch.equal(A, A0)
    assert torch.equal(out, it.update_halo(port_stencil(A)))
    assert same is not A and torch.equal(same, it.update_halo(A.clone()))
    assert tel.counter("igg_hide_communication_traces_total").value \
        == before + 2
    names = [r.payload.get("name") for r in kinds if r.kind == "span"]
    assert [r.kind for r in kinds if r.kind == "hide_communication"] \
        == ["hide_communication"] * 2
    assert names == ["overlap.hide_communication"] * 2
    assert tel.metric_help("igg_hide_communication_traces_total") == \
        "hide_communication overlap schedules traced."


@pytest.mark.parametrize("form", ["stacked", "sharded"])
def test_in_place_compute_raises(form):
    """A compute that writes its inputs in place is refused with GridError
    (the slab computations would read the inputs beside it)."""
    port_grid("periodic")
    A = torch.from_numpy(seeded((12, 12, 12), 6))
    A0 = A.clone()

    def in_place(B):
        B.mul_(2.0)
        return B

    def call(A):
        return it.hide_communication(A, in_place)

    with pytest.raises(it.GridError, match="in place"):
        (it.sharded(call) if form == "sharded" else call)(A)
    # Refused after the full compute, before any slab work: the inputs
    # are as that one compute left them (in `sharded`, each block's copy).
    assert torch.equal(A, A0 if form == "sharded" else 2.0 * A0)


def test_halo_tap_applies_to_the_overlapped_exchange():
    """`chaos.halo_corruption()` (the `halo._CHAOS_PLANE_TAP` seam) reaches
    the planes `hide_communication` exchanges: every received halo plane
    becomes NaN, the interior stays the clean run's."""
    port_grid("open")
    A = torch.from_numpy(seeded((12, 12, 12), 8))
    clean = it.hide_communication(A, port_stencil)
    with it.chaos.halo_corruption():
        bad = it.hide_communication(A, port_stencil)
    nan = torch.isnan(bad)
    assert nan.any()
    inner = (slice(1, 5), slice(1, 5), slice(1, 5))
    assert torch.equal(bad[inner], clean[inner])
    assert torch.equal(bad[~nan], clean[~nan])


# (grid keywords, primaries' local shapes, radius, aux local shapes)
RAISES = {
    "radius_ol2": (grid_kw(), [(8, 8, 8)], 2, []),
    "radius_staggered_field": (grid_kw(**OL3), [(8, 8, 8), (7, 8, 8)], 2,
                               []),
    "window_smaller_aux": (grid_kw(**OL3), [(8, 8, 8)], 2, [(7, 8, 8)]),
    "halo_dims": (grid_kw(), [(8, 8, 8), (8, 8, 1)], 1, []),
}


@pytest.mark.parametrize("name", list(RAISES))
def test_refusals_raise_igg_messages(name):
    kw, shapes, radius, aux = RAISES[name]
    nf = len(shapes)
    igg.init_global_grid(8, 8, 8, **kw)
    g = igg.get_global_grid()
    arrays = [seeded(stacked_shape(s, g.dims), 3) for s in shapes + aux]

    def comp(*S):
        return S[:nf] if nf > 1 else S[0]

    @igg.sharded
    def step(*S):
        return igg.hide_communication(S[:nf] if nf > 1 else S[0], comp,
                                      *S[nf:], radius=radius)

    with pytest.raises(igg.GridError) as want:
        step(*(jax.device_put(a, sharding_for(a.ndim)) for a in arrays))
    igg.finalize_global_grid()
    it.init_global_grid(8, 8, 8, device="cpu", nprocs=8, **kw)
    S = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(it.GridError) as info:
        it.hide_communication(tuple(S[:nf]) if nf > 1 else S[0], comp,
                              *S[nf:], radius=radius)
    assert str(info.value) == str(want.value)


# -- the families -------------------------------------------------------------

def igg_arrays(arrays):
    return [jax.device_put(a, sharding_for(a.ndim)) for a in arrays]


def state(local, staggers, scales, dims, seed):
    """Seeded fields of the given staggers: `scale[0] + scale[1] * N(0,
    1)` each, stacked over `dims`."""
    return [lo + sc * seeded(stacked_shape(
        [n + d for n, d in zip(local, st)], dims), seed + i)
        for i, (st, (lo, sc)) in enumerate(zip(staggers, scales))]


def _diffusion(periods):
    p = id3.Params()
    tp = convert.convert_params(p, td3.Params)

    def step_kw():
        dx, dy, dz = tp.spacing()
        return dict(dx=dx, dy=dy, dz=dz, dt=tp.timestep(), lam=tp.lam)

    return dict(
        local=(6, 6, 6), kw=grid_kw(periods), family="diffusion3d",
        state=lambda dims: state((6, 6, 6), [(0, 0, 0)] * 2,
                                 [(0.0, 1.0), (2.0, 0.2)], dims, 21),
        igg=lambda S, n: [id3.make_multi_step(
            n, p, donate=False, use_pallas=False, overlap=True)(*S)],
        port=lambda S, n, ov: (td3.make_multi_step(
            n, tp, use_kernels=False, overlap=ov)(*S),),
        step=lambda S, ov, **k: (td3.local_step(*S, **k, overlap=ov),),
        step_kw=step_kw)


def _hm3d(periods):
    p = ih3.Params()
    tp = convert.convert_params(p, th3.Params)
    return dict(
        local=(6, 6, 6), kw=grid_kw(periods), family="hm3d",
        state=lambda dims: state((6, 6, 6), [(0, 0, 0)] * 2,
                                 [(-0.5, 0.1), (0.1, 0.01)], dims, 31),
        igg=lambda S, n: ih3.make_step(p, donate=False, use_pallas=False,
                                       overlap=True, n_inner=n)(*S),
        port=lambda S, n, ov: th3.make_multi_step(
            n, tp, use_kernels=False, overlap=ov)(*S),
        step=lambda S, ov, **k: th3.local_step(*S, **k, overlap=ov),
        step_kw=tp.step_kwargs)


def _wave2d(periods):
    p = iw2.Params()
    tp = convert.convert_params(p, tw2.Params)

    def step_kw():
        k = tp.step_kwargs()
        k["K"] = k.pop("bulk")
        return k

    return dict(
        local=(8, 8, 1), family="wave2d",
        kw=grid_kw(periods, dimx=4, dimy=2, dimz=1, overlapx=3, overlapy=3),
        state=lambda dims: state((8, 8), [(0, 0), (1, 0), (0, 1)],
                                 [(0.0, 1.0)] * 3, dims[:2], 41),
        igg=lambda S, n: iw2.make_step(p, donate=False, use_pallas=False,
                                       overlap=True, n_inner=n)(*S),
        port=lambda S, n, ov: tw2.make_multi_step(
            n, tp, use_kernels=False, overlap=ov)(*S),
        step=lambda S, ov, **k: tw2.local_step(*S, **k, overlap=ov),
        step_kw=step_kw)


def _stokes(periods):
    p = ist.Params()
    tp = convert.convert_params(p, tst3.Params)
    return dict(
        local=(8, 8, 8), kw=grid_kw(periods, **OL3), family="stokes3d",
        state=lambda dims: state(
            (8, 8, 8), [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                        (0, 0, 0)], [(0.0, 0.1)] * 4 + [(1.0, 0.1)], dims,
            51),
        igg=lambda S, n: ist.make_iteration(
            p, donate=False, use_pallas=False, overlap=True, n_inner=n)(*S),
        port=lambda S, n, ov: tst3.make_iteration(
            tp, n_inner=n, use_kernels=False, overlap=ov)(*S),
        step=lambda S, ov, **k: tst3.local_iteration(*S, **k, overlap=ov),
        step_kw=lambda: tst3._pseudo_steps(tp))


FAMILIES = {
    "diffusion3d_open": (_diffusion, (0, 0, 0)),
    "hm3d_mixed": (_hm3d, (1, 0, 1)),
    "wave2d_periodic": (_wave2d, (1, 1, 0)),
    "stokes3d_open": (_stokes, (0, 0, 0)),
}
N_FAMILY = 3


def family(name):
    make, periods = FAMILIES[name]
    return make(periods)


@pytest.fixture(scope="module")
def igg_families():
    """{family: (its seeded state, igg's N_FAMILY overlapped steps)}, as
    stacked numpy arrays."""
    out = {}
    for name in FAMILIES:
        f = family(name)
        igg.init_global_grid(*f["local"], **f["kw"])
        arrays = f["state"](igg.get_global_grid().dims)
        got = f["igg"](igg_arrays(arrays), N_FAMILY)
        out[name] = arrays, [np.asarray(a) for a in got]
        igg.finalize_global_grid()
    return out


def port_family_state(name, arrays):
    f = family(name)
    it.init_global_grid(*f["local"], device="cpu", nprocs=8, **f["kw"])
    return f, tuple(torch.from_numpy(a.copy()) for a in arrays)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_factory_overlap_matches_sequential_and_igg(igg_families, name):
    arrays, ref = igg_families[name]
    f, S = port_family_state(name, arrays)
    got = f["port"](S, N_FAMILY, True)
    assert degrade.active()[f["family"]] == f"{f['family']}.overlap"
    want = f["port"](S, N_FAMILY, False)
    assert degrade.active()[f["family"]] == f"{f['family']}.plain"
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    for a, s in zip(arrays, S):
        np.testing.assert_array_equal(s.numpy(), a)


@pytest.mark.parametrize("form", ["stacked", "sharded"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_local_step_overlap_matches_sequential(igg_families, name, form):
    arrays, _ = igg_families[name]
    f, S = port_family_state(name, arrays)
    kw = f["step_kw"]()

    def step(*S, overlap_):
        return tuple(f["step"](S, overlap_, **kw))

    def hidden(*S):
        return step(*S, overlap_=True)

    def sequential(*S):
        return step(*S, overlap_=False)

    if form == "sharded":
        hidden, sequential = it.sharded(hidden), it.sharded(sequential)
    one = f["port"](S, 1, False)
    H, Q = hidden(*S), sequential(*S)
    assert len(H) == len(Q) == len(one)
    for h, q, o in zip(H, Q, one):
        assert torch.equal(h, q)
        assert torch.equal(h, o)


@pytest.mark.parametrize("name", ["hm3d", "stokes3d"])
def test_local_step_overlap_with_kernels_raises_igg_message(name):
    """igg's message, naming the port's knob (`use_kernels` for igg's
    `use_pallas`)."""
    if name == "hm3d":
        it.init_global_grid(6, 6, 6, device="cpu", nprocs=8, **grid_kw())
        S = th3.init_fields(th3.Params(), dtype=torch.float64)
        run = lambda **k: th3.local_step(   # noqa: E731
            *S, **th3.Params().step_kwargs(), **k)
        ref = lambda: ih3.local_step(   # noqa: E731
            None, None, dx=1, dy=1, dz=1, dt=1, phi0=1, npow=3, eta=1,
            overlap=True, use_pallas=True)
    else:
        it.init_global_grid(8, 8, 8, device="cpu", nprocs=8,
                            **grid_kw(**OL3))
        S = tst3.init_fields(tst3.Params(), dtype=torch.float64)
        run = lambda **k: tst3.local_iteration(   # noqa: E731
            *S, **tst3._pseudo_steps(tst3.Params()), **k)
        ref = lambda: ist.local_iteration(   # noqa: E731
            None, None, None, None, None, dx=1, dy=1, dz=1, mu=1, dtP=1,
            dtV=1, overlap=True, use_pallas=True)
    with pytest.raises(igg.GridError) as want:
        ref()
    with pytest.raises(it.GridError) as info:
        run(overlap=True, use_kernels=True)
    assert str(info.value) == str(want.value).replace("use_pallas",
                                                      "use_kernels")


def test_factory_verify_first_use_holds_overlap_against_plain():
    it.init_global_grid(6, 6, 6, device="cpu", nprocs=8, **grid_kw())
    p = td3.Params()
    T, Cp = td3.init_fields(p, dtype=torch.float64)
    step = td3.make_multi_step(2, p, use_kernels=False, overlap=True,
                               verify="first_use")
    out = step(T, Cp)
    assert degrade.active()["diffusion3d"] == "diffusion3d.overlap"
    assert ("diffusion3d.overlap",) == tuple(
        t for t, _ in degrade._VERIFIED if t.endswith(".overlap"))
    assert torch.equal(out, td3.make_multi_step(2, p, use_kernels=False,
                                                overlap=False)(T, Cp))


def test_kernel_routes_ignore_overlap():
    it.init_global_grid(6, 6, 6, device="cpu", nprocs=8, **grid_kw())
    p = td3.Params()
    T, Cp = td3.init_fields(p, dtype=torch.float64)
    out = td3.make_multi_step(2, p, use_kernels="auto", overlap=True)(T, Cp)
    assert degrade.active()["diffusion3d"] == "diffusion3d.cuda"
    assert torch.equal(out, td3.make_multi_step(
        2, p, use_kernels="auto", overlap=False)(T, Cp))


# -- the spec frontend ----------------------------------------------------------

@pytest.mark.parametrize("periods", PERIODS)
def test_spec_compile_overlap_bitwise_sequential(periods):
    """The case igg misses by 1 ulp on (0, 0, 0) and (1, 0, 1)
    (test_round16_satellites.py::test_spec_compiled_overlap_matches_
    sequential): bitwise in the port."""
    it.init_global_grid(6, 6, 6, device="cpu", nprocs=8, **grid_kw(periods))
    T = tst.Field("T", stagger=(0, 0, 0))
    r = tst.Param("r", default=0.1)
    lap = (T[-1, 0, 0] + T[1, 0, 0] + T[0, -1, 0] + T[0, 1, 0]
           + T[0, 0, -1] + T[0, 0, 1] - 6.0 * T[0, 0, 0])
    spec = tst.StencilSpec(
        "relax3d", fields=[T], params=[r],
        updates=[tst.Update(T, r * lap, pad=((1, 1),) * 3)])
    A0 = it.update_halo(torch.from_numpy(seeded((12, 12, 12), 7)))
    (a,) = tst.compile(spec, n_inner=4, use_kernels=False, overlap=False)(A0)
    assert degrade.active()["relax3d"] == "relax3d.plain"
    (b,) = tst.compile(spec, n_inner=4, use_kernels=False, overlap=True)(A0)
    assert degrade.active()["relax3d"] == "relax3d.overlap"
    assert torch.equal(a, b)


# -- admission and resolution -----------------------------------------------

# (init_global_grid args and keywords, overlap_admission keywords)
ADMISSION = {
    "admitted": ((6, 6, 6), grid_kw(), dict(radius=1)),
    "radius": ((6, 6, 6), grid_kw(), dict(radius=2)),
    "radius_ol3": ((8, 8, 8), grid_kw(**OL3), dict(radius=2)),
    "chunk": ((6, 6, 6), grid_kw(), dict(radius=1, chunk_active=True)),
    "single_block": ((6, 6, 6), grid_kw(dimx=1, dimy=1, dimz=1),
                     dict(radius=1)),
    "single_block_2d": ((8, 8, 1), grid_kw((1, 1, 0), dimx=1, dimy=1,
                                           dimz=1, overlapx=3, overlapy=3),
                        dict(radius=2, ndim=2)),
    "mesh_2d": ((8, 8, 1), grid_kw((1, 1, 0), dimx=4, dimy=2, dimz=1,
                                   overlapx=3, overlapy=3),
                dict(radius=2, ndim=2)),
    "ndim_2_radius": ((6, 6, 1), grid_kw((1, 1, 0), dimx=4, dimy=2, dimz=1),
                      dict(radius=2, ndim=2)),
    "ndim_2_ignores_z": ((8, 8, 8), grid_kw(overlapx=3, overlapy=3),
                         dict(radius=2, ndim=2)),
    "ndim_3_checks_z": ((8, 8, 8), grid_kw(overlapx=3, overlapy=3),
                        dict(radius=2, ndim=3)),
}


@pytest.mark.parametrize("name", list(ADMISSION))
def test_overlap_admission_matches_igg(name):
    from igg.overlap import overlap_admission as igg_admission

    local, kw, akw = ADMISSION[name]
    igg.init_global_grid(*local, **kw)
    want = igg_admission(**akw)
    nprocs = igg.get_global_grid().nprocs
    igg.finalize_global_grid()
    it.init_global_grid(*local, device="cpu", nprocs=nprocs, **kw)
    got = overlap.overlap_admission(**akw)
    assert (bool(got), got.reason) == (bool(want), want.reason)


def test_overlap_admission_without_grid_matches_igg():
    from igg.overlap import overlap_admission as igg_admission

    want, got = igg_admission(), overlap.overlap_admission()
    assert (bool(got), got.reason) == (bool(want), want.reason)


def test_resolve_overlap_knob_order_log_and_record(monkeypatch):
    """The order of igg's test_resolve_overlap_env_overrides_tuned: the
    knob before the tuner's winner, the winner before off; a refusal
    under "auto" logs `<family>.overlap` and emits `overlap_refused`."""
    from igg.overlap import resolve_overlap as igg_resolve

    it.init_global_grid(6, 6, 6, device="cpu", nprocs=8, **grid_kw())
    igg.init_global_grid(6, 6, 6, **grid_kw())
    got = []
    tel.subscribe(got.append)
    try:
        for env, args in ((None, dict()), (None, dict(tuned={"overlap": True})),
                          ("0", dict(tuned={"overlap": True})),
                          ("1", dict(tuned={"overlap": False})),
                          ("1", dict(radius=5)), (None, dict(radius=5))):
            if env is None:
                monkeypatch.delenv("IGG_OVERLAP", raising=False)
            else:
                monkeypatch.setenv("IGG_OVERLAP", env)
            mine = overlap.resolve_overlap("auto", family="diffusion3d",
                                           **args)
            assert mine is igg_resolve("auto", family="diffusion3d", **args)
    finally:
        tel.unsubscribe(got.append)
    assert "radius 5" in degrade.admission_log()["diffusion3d.overlap"]
    assert degrade.admission_log()["diffusion3d.overlap"] == \
        igg.degrade.admission_log()["diffusion3d.overlap"]
    refused = [r.payload for r in got if r.kind == "overlap_refused"]
    assert refused == [dict(family="diffusion3d", radius=5,
                            reason=degrade.admission_log()[
                                "diffusion3d.overlap"])]
    for pin in (True, False):
        assert overlap.resolve_overlap(pin, family="x") is pin
    with pytest.raises(it.GridError, match="overlap"):
        overlap.resolve_overlap("sometimes", family="diffusion3d")


def test_auto_knob_on_one_block_serves_plain_with_igg_reason(monkeypatch):
    monkeypatch.setenv("IGG_OVERLAP", "1")
    it.init_global_grid(6, 6, 6, device="cpu", nprocs=1,
                        **grid_kw(dimx=1, dimy=1, dimz=1))
    p = td3.Params()
    T, Cp = td3.init_fields(p, dtype=torch.float64)
    td3.make_multi_step(2, p, use_kernels=False, overlap="auto")(T, Cp)
    assert degrade.active()["diffusion3d"] == "diffusion3d.plain"
    assert degrade.admission_log()["diffusion3d.overlap"].startswith(
        "single-device mesh")
    it.finalize_global_grid()
    it.init_global_grid(6, 6, 6, device="cpu", nprocs=8, **grid_kw())
    T, Cp = td3.init_fields(p, dtype=torch.float64)
    td3.make_multi_step(2, p, use_kernels=False, overlap="auto")(T, Cp)
    assert degrade.active()["diffusion3d"] == "diffusion3d.overlap"
    monkeypatch.setenv("IGG_OVERLAP", "0")
    td3.make_multi_step(2, p, use_kernels=False, overlap="auto")(T, Cp)
    assert degrade.active()["diffusion3d"] == "diffusion3d.plain"
