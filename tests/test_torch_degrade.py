"""The port's tier ladder (`igg_torch.degrade`), its wiring into every
family's factory and the halo byte counter, held against igg on the CPU.

- `_leaf_mismatch` gives igg's verdict and text on the same numpy-made
  arrays (f32 and f64, a delta just inside and just outside the
  tolerance, inf and NaN cells);
- a corrupted tier under `verify="first_use"` raises and serves nothing
  (the port quarantines nothing and never falls to the plain tier); a
  healthy tier verifies once per argument signature; `IGG_VERIFY_KERNELS`
  decides where `verify` is None; a refused required tier raises;
  `finalize_global_grid` resets the ladder;
- every family and the spec frontend serve bitwise the same output with
  and without `verify="first_use"`, and `degrade.active()` and
  `igg_tier_dispatch_total` match igg's for the same calls under the
  tier-name map (`.cuda` for igg's `.mosaic`, `.plain` for its `.xla`);
- `update_halo`'s `igg_halo_plane_bytes_total` deltas by `(dim, mode)`
  equal igg's `plane_bytes_by_mode`.
"""

import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg import degrade as igg_degrade
from igg import telemetry as igg_tel
from igg.halo import plane_bytes_by_mode
from igg_torch import convert, degrade, telemetry as tel
from igg_torch.models import diffusion3d as t3
from igg_torch.models import hm3d as th3
from igg_torch.models import shallow_water as tsw
from igg_torch.models import stokes3d as ts3
from igg_torch.models import wave2d as tw2
from igg_torch.ops import diffusion_pallas

import torch_spec_cases as cases
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("IGG_VERIFY_KERNELS", raising=False)
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()
    igg_degrade.reset()
    tel.reset_metrics()
    igg_tel.reset_metrics()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()


# ---------------------------------------------------------------------------
# The tolerance verdicts
# ---------------------------------------------------------------------------

def _pair(dtype, case):
    """(tier, truth) arrays of one verdict case, from a numpy seed."""
    rng = np.random.default_rng(7)
    truth = rng.uniform(-2.0, 2.0, (4, 5)).astype(dtype)
    truth[0, 0] = 2.0                    # max|truth| = 2
    rtol, atol = {np.float32: (1e-4, 1e-5),
                  np.float64: (1e-9, 1e-12)}[dtype]
    tol = atol + rtol * 2.0
    tier = truth.copy()
    if case == "inside":
        tier[1, 2] += dtype(0.5 * tol)
    elif case == "outside":
        tier[1, 2] += dtype(3.0 * tol)
    elif case == "inf_both":
        tier[2, 2] = truth[2, 2] = np.inf
    elif case == "inf_tier":
        tier[2, 2] = np.inf
    elif case == "nan_both":
        tier[3, 1] = truth[3, 1] = np.nan
    elif case == "nan_tier":
        tier[3, 1] = np.nan
    elif case == "dtype":
        tier = tier.astype(np.float64 if dtype == np.float32 else np.float32)
    return tier, truth


@pytest.mark.parametrize("case", ["equal", "inside", "outside", "inf_both",
                                  "inf_tier", "nan_both", "nan_tier",
                                  "dtype"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_leaf_mismatch_matches_igg(dtype, case):
    a, b = _pair(dtype, case)
    want = igg_degrade._leaf_mismatch(3, a, b)
    got = degrade._leaf_mismatch(3, torch.from_numpy(a), torch.from_numpy(b))
    assert got == want
    expect_ok = case in ("equal", "inside", "inf_both", "nan_both")
    assert (got is None) == expect_ok


def test_exact_dtypes_and_leaf_counts():
    a = torch.arange(6)
    assert degrade._leaf_mismatch(0, a, a.clone()) is None
    assert "exact-dtype" in degrade._leaf_mismatch(0, a, a + 1)
    assert "leaves" in degrade._compare_outputs((a, a), (a,))
    assert degrade._compare_outputs((a, (a,)), (a, (a,))) is None


# ---------------------------------------------------------------------------
# The ladder
# ---------------------------------------------------------------------------

def _ladder(fast, verify="first_use", required=False, admit=None):
    calls = {"fast": 0, "truth": 0}

    def fast_fn(x):
        calls["fast"] += 1
        return fast(x)

    def truth_fn(x):
        calls["truth"] += 1
        return x * 2.0

    tiers = [degrade.Tier("toy.cuda", 0, build=lambda: fast_fn, admit=admit,
                          required=required, requirement="toy.cuda needed"),
             degrade.Tier("toy.plain", 1, build=lambda: truth_fn,
                          truth=True)]
    return degrade.Ladder("toy", tiers, verify=verify), calls


def _spans(name="degrade.verify_first_use"):
    return sum(1 for r in tel.flight_recorder()
               if r.kind == "span" and r.payload.get("name") == name)


def _dispatches():
    return {k: v["value"] for k, v in tel.snapshot().items()
            if k.startswith("igg_tier_dispatch_total")}


def test_corrupted_tier_raises_and_serves_nothing():
    def corrupt(x):
        y = x * 2.0
        y.view(-1)[3] += 1.0
        return y

    ladder, calls = _ladder(corrupt)
    x = torch.arange(8, dtype=torch.float32)
    x0 = x.clone()
    with pytest.raises(it.GridError, match=r"toy\.cuda.*output 0.*"
                       r"max\|tier-truth\|=1\.000e\+00 vs tol="):
        ladder.dispatch(x)
    assert torch.equal(x, x0)
    assert calls == {"fast": 1, "truth": 1}      # the verification only
    assert "toy" not in degrade.active() and not _dispatches()
    (ev,) = degrade.events()
    assert ev["tier"] == "toy.cuda" and ev["reason"] == "verify_mismatch"
    assert tel.flight_recorder()[-1].kind == "tier_degraded"
    assert not degrade.is_quarantined("toy.cuda") and degrade.status() == {}
    with pytest.raises(it.GridError):           # still raises: no fallback
        ladder.dispatch(x)


def test_healthy_tier_verifies_once_per_signature():
    ladder, calls = _ladder(lambda x: x * 2.0)
    before = _spans()
    for n in (8, 8, 8, 5):
        out = ladder.dispatch(torch.ones(n))
        assert torch.equal(out, torch.full((n,), 2.0))
    assert _spans() - before == 2
    # Four served calls, two verifications and, after each, the one warm
    # dispatch timed into the perf ledger (igg's `_perf_sample`).
    assert calls == {"fast": 8, "truth": 2}
    assert degrade.active() == {"toy": "toy.cuda"}
    assert _dispatches() == {
        'igg_tier_dispatch_total{family="toy",tier="toy.cuda"}': 4.0}


def test_env_knob_decides_when_verify_is_none(monkeypatch):
    ladder, calls = _ladder(lambda x: x * 2.0, verify=None)
    ladder.dispatch(torch.ones(3))
    assert calls["truth"] == 0
    monkeypatch.setenv("IGG_VERIFY_KERNELS", "1")
    ladder.dispatch(torch.ones(3))
    assert calls["truth"] == 1
    off, calls_off = _ladder(lambda x: x * 2.0, verify=False)
    off.dispatch(torch.ones(4))
    assert calls_off["truth"] == 0


def test_invalid_verify_and_refused_required_tier():
    with pytest.raises(it.GridError, match="verify="):
        _ladder(lambda x: x, verify="always")
    with pytest.raises(it.GridError, match="truth rung"):
        degrade.Ladder("toy", [degrade.Tier("toy.cuda", 0, build=None)])
    ladder, _ = _ladder(lambda x: x, required=True,
                        admit=lambda args: degrade.Admission.no("too small"))
    with pytest.raises(it.GridError, match="toy.cuda needed"):
        ladder.dispatch(torch.ones(2))
    assert degrade.admission_log() == {"toy.cuda": "too small"}
    ladder, _ = _ladder(lambda x: x,
                        admit=lambda args: degrade.Admission.no("no"))
    assert torch.equal(ladder.dispatch(torch.ones(2)), torch.full((2,), 2.0))
    assert degrade.active() == {"toy": "toy.plain"}


class _CardArg:
    """An argument the ladder takes for a CUDA tensor (`is_cuda`), so the
    card rules run here."""
    is_cuda = True


def test_card_dispatch_never_falls_to_the_truth_tier():
    """On CUDA arguments the ladder serves no plain version: demoting a
    tier that last served the card is refused and quarantines nothing,
    and a quarantined tier that would have served a card dispatch raises
    naming it; CPU arguments still fall to the truth tier."""
    served = []
    tiers = [degrade.Tier("toy.cuda", 0,
                          build=lambda: lambda x: served.append("cuda")),
             degrade.Tier("toy.plain", 1, truth=True,
                          build=lambda: lambda x: served.append("plain"))]
    ladder = degrade.Ladder("toy", tiers, verify=False)
    ladder.dispatch(_CardArg())
    assert degrade.demotable() == [("toy", "toy.cuda", 0, True)]
    with pytest.raises(it.GridError, match=r"\(toy\.cuda\).*toy\.plain"):
        degrade.demote_active()
    assert degrade.status() == {} and degrade.events() == []
    degrade.quarantine("toy.cuda", 0, "nan_recurrence")
    with pytest.raises(it.GridError, match=r"toy\.cuda is quarantined "
                       r"\(nan_recurrence\).*toy\.plain"):
        ladder.dispatch(_CardArg())
    assert served == ["cuda"]
    ladder.dispatch(torch.ones(2))
    assert served == ["cuda", "plain"]
    assert degrade.active() == {"toy": "toy.plain"}


def test_finalize_resets_the_ladder():
    it.init_global_grid(8, 8, 8, device="cpu", quiet=True)
    ladder, _ = _ladder(lambda x: x * 2.0)
    ladder.dispatch(torch.ones(3))
    assert degrade.active() and degrade._VERIFIED
    it.finalize_global_grid()
    assert degrade.active() == {} and not degrade._VERIFIED
    assert degrade.active_records() == []


def test_factory_with_a_corrupted_kernel_raises(monkeypatch):
    """diffusion3d's kernel route, one cell changed after it: the factory's
    verification raises and the field is left as it was."""
    it.init_global_grid(8, 8, 8, dimx=1, dimy=1, dimz=1, periodx=1,
                        periody=1, periodz=1, device="cpu", quiet=True)
    real = diffusion_pallas.fused_diffusion_steps

    def corrupted(*a, **kw):
        out = real(*a, **kw).clone()
        out[4, 4, 4] += 1.0
        return out

    monkeypatch.setattr(diffusion_pallas, "fused_diffusion_steps", corrupted)
    p = t3.Params()
    T, Cp = t3.init_fields(p)
    T0 = T.clone()
    step = t3.make_multi_step(4, p, verify="first_use")
    with pytest.raises(it.GridError, match="diffusion3d.cuda.*"
                       "diffusion3d.plain"):
        step(T, Cp)
    assert torch.equal(T, T0)
    assert "diffusion3d" not in degrade.active()


# ---------------------------------------------------------------------------
# The factories
# ---------------------------------------------------------------------------

def _diffusion():
    p = t3.Params()
    return (lambda **kw: t3.make_multi_step(5, p, **kw)), t3.init_fields(p)


def _hm3d():
    p = th3.Params()
    return (lambda **kw: th3.make_multi_step(4, p, K=2, **kw)), \
        th3.init_fields(p)


def _wave2d():
    p = tw2.Params()
    return (lambda **kw: tw2.make_multi_step(4, p, **kw)), \
        tw2.init_fields(p)


def _stokes():
    p = ts3.Params()
    return (lambda **kw: ts3.make_iteration(p, n_inner=4, K=2, **kw)), \
        ts3.init_fields(p)


def _shallow_water():
    p = tsw.Params()
    return (lambda **kw: tsw.make_step(p, n_inner=4, **kw)), \
        tsw.init_fields(p)


def _relax3d_banded():
    gen = cases.kernels("relax3d")
    S = cases.state(it, gen, it.get_global_grid(), torch.float32, 11)
    return (lambda **kw: it.stencil.compile(
        gen.spec, coeffs=gen.coeffs, n_inner=4, banded=True, K=2, band=8,
        **kw)), (it.update_halo(S[0]),)


PERIODIC = dict(periodx=1, periody=1, periodz=1)
FAMILIES = {
    # family: (grid args, grid keywords, state, expected serving tier)
    "diffusion3d": ((8, 8, 8), dict(dimx=2, dimy=2, dimz=2, periodz=1),
                    _diffusion, "banded"),
    "hm3d": ((8, 8, 8), dict(dimx=2, dimy=2, dimz=2, **PERIODIC), _hm3d,
             "trapezoid"),
    "wave2d": ((8, 8, 1), dict(dimx=2, dimy=2, periodx=1, periody=1),
               _wave2d, "chunk"),
    "stokes3d": ((10, 8, 8), dict(dimx=2, dimy=1, dimz=1, overlapx=3,
                                  overlapy=3, overlapz=3, **PERIODIC),
                 _stokes, "trapezoid"),
    "shallow_water": ((8, 8, 1), dict(dimx=2, dimy=2, periodx=1, periody=1),
                      _shallow_water, "chunk"),
    "relax3d": ((12, 8, 8), dict(dimx=2, dimy=1, dimz=1, **PERIODIC),
                _relax3d_banded, "banded"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_factory_verify_is_bitwise(family):
    n, kw, make, route = FAMILIES[family]
    it.init_global_grid(*n, device="cpu", quiet=True, **kw)
    factory, state = make()
    want = factory()(*state)
    before = _spans()
    step = factory(verify="first_use")
    got = step(*state)
    step(*state)
    assert _spans() - before == 1
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert degrade.active() == {family: f"{family}.{route}"}
    assert _dispatches()[f'igg_tier_dispatch_total{{family="{family}",'
                         f'tier="{family}.{route}"}}'] == 3.0


def _igg_map(name: str) -> str:
    family, route = name.rsplit(".", 1)
    return f"{family}." + {"mosaic": "cuda", "xla": "plain"}.get(route,
                                                                route)


def _port_state(arrays):
    return tuple(convert.to_torch({str(i): np.asarray(a) for i, a in
                                   enumerate(arrays)})[str(i)]
                 for i in range(len(arrays)))


def test_factories_dispatch_like_igg():
    """The same calls through igg and the port: igg's interpret-mode
    kernel tier against the port's kernel tier for diffusion3d, igg's XLA
    tier against the port's plain tier for wave2d and stokes3d, each on
    one periodic block; `active()` and the dispatch counters agree under
    the tier-name map."""
    from igg.models import diffusion3d as d3
    from igg.models import stokes3d as s3
    from igg.models import wave2d as w2

    igg_counts, port_counts = {}, {}

    def run(n, kw, calls):
        """`calls()` (after both grids are up) gives pairs of igg and port
        calls; after each pair the active tiers agree."""
        igg.init_global_grid(*n, quiet=True, **kw)
        it.init_global_grid(*n, quiet=True, device="cpu",
                            nprocs=igg.get_global_grid().nprocs, **kw)
        for igg_call, port_call in calls():
            igg_call()
            port_call()
            assert {f: _igg_map(t) for f, t in
                    igg_degrade.active().items()} == degrade.active()
        igg.finalize_global_grid()
        it.finalize_global_grid()

    # diffusion3d: igg's fused kernel in interpret mode (its gate needs
    # z >= 128) against the port's K-step loop.
    dp, tp = d3.Params(), convert.convert_params(d3.Params(), t3.Params)

    def diffusion_calls():
        T, Cp = d3.init_fields(dp, dtype=np.float32)
        Tt, Cpt = _port_state((T, Cp))
        return [(lambda: d3.make_multi_step(
                    4, dp, donate=False, use_pallas=True,
                    pallas_interpret=True, verify="first_use")(T, Cp),
                 lambda: t3.make_multi_step(4, tp, verify="first_use")(
                     Tt, Cpt))]

    run((8, 8, 128), dict(dimx=1, dimy=1, dimz=1, **PERIODIC),
        diffusion_calls)

    # wave2d and stokes3d: the XLA tier against the plain tier.
    def plain_calls(mod, tmod, igg_make, port_make):
        def calls():
            p = mod.Params()
            tp = convert.convert_params(p, tmod.Params)
            S = mod.init_fields(p, dtype=np.float32)
            St = _port_state(S)
            pair = (lambda: igg_make(p, use_pallas=False, donate=False,
                                     verify="first_use")(*S),
                    lambda: port_make(tp, use_kernels=False,
                                      verify="first_use")(*St))
            return [pair]
        return calls

    run((8, 8, 1), dict(dimx=1, dimy=1, periodx=1, periody=1),
        plain_calls(w2, tw2, lambda p, **k: w2.make_step(p, n_inner=3, **k),
                    lambda p, **k: tw2.make_multi_step(3, p, **k)))
    run((8, 8, 8), dict(dimx=1, dimy=1, dimz=1, overlapx=3, overlapy=3,
                        overlapz=3, **PERIODIC),
        plain_calls(s3, ts3,
                    lambda p, **k: s3.make_iteration(p, n_inner=3, **k),
                    lambda p, **k: ts3.make_iteration(p, n_inner=3, **k)))

    for name, v in igg_tel.snapshot().items():
        if name.startswith("igg_tier_dispatch_total"):
            fam = name.split('family="')[1].split('"')[0]
            tier = name.split('tier="')[1].split('"')[0]
            igg_counts[(fam, _igg_map(tier))] = v["value"]
    for name, v in _dispatches().items():
        fam = name.split('family="')[1].split('"')[0]
        tier = name.split('tier="')[1].split('"')[0]
        port_counts[(fam, tier)] = v
    assert port_counts == igg_counts
    assert port_counts[("diffusion3d", "diffusion3d.cuda")] == 1.0


# ---------------------------------------------------------------------------
# The halo byte counter
# ---------------------------------------------------------------------------

HALO_GRIDS = {
    "periodic_1block": ((6, 6, 6), dict(dimx=1, dimy=1, dimz=1, **PERIODIC)),
    "2x2x2_nprocs8": ((6, 6, 6), dict(dimx=2, dimy=2, dimz=2, periodz=1)),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(HALO_GRIDS))
def test_halo_plane_bytes_match_igg(case, dtype):
    n, kw = HALO_GRIDS[case]
    igg.init_global_grid(*n, quiet=True, **kw)
    it.init_global_grid(*n, quiet=True, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    shapes = [(6, 6, 6), (7, 6, 6), (6, 6, 7)]
    fields = [it.zeros(s, dtype=tdt) for s in shapes]
    want = plane_bytes_by_mode(shapes, [np.dtype(dtype)] * 3,
                               igg.get_global_grid())
    it.update_halo(*fields)
    it.update_halo(fields[0])
    once = plane_bytes_by_mode(shapes[:1], [np.dtype(dtype)],
                               igg.get_global_grid())
    snap = tel.snapshot()
    got = {(k.split('dim="')[1][0], k.split('mode="')[1].split('"')[0]):
           v["value"] for k, v in snap.items() if "dim=" in k}
    total = {key: want.get(key, 0) + once.get(key, 0)
             for key in set(want) | set(once)}
    assert got == total and got
    assert snap["igg_halo_plane_bytes_total"]["value"] == sum(total.values())
    igg.finalize_global_grid()
