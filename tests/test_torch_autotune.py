"""The port's autotuner (igg_torch.autotune) and `tune=` held against igg's
on the CPU.

Against igg, on the same grids: `candidates_for` gives igg's candidate
set under the tier map (`igg_torch.perf.port_tier`) with no vmem axis, and
tuning-cache files cross-load both ways.  Then the contracts of igg's
tests/test_autotune.py: the cache round trip with zero search
dispatches, explicit arguments beating a cached winner, a cached K falling
back to the fit at a smaller `n_inner`, `invalidate` (scoped to a tier),
a corrupt cache never fatal, merge-on-write with the newest winner, the
prior ordering the walk, and the overlap demotion; and, for every family,
a tuned factory's output bitwise the output of the factory pinned to the
winner's config.  The port's grids are `init_global_grid(...,
device="cpu")`, where the kernel routes run their plain versions.
"""

import json

import pytest
import torch

import igg
import igg_torch as it
from igg import autotune as iauto
from igg import perf as iperf
from igg_torch import autotune, degrade, perf
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as td3
from igg_torch.models import hm3d as th3
from igg_torch.models import shallow_water as tsw
from igg_torch.models import stokes3d as tst3
from igg_torch.models import wave2d as tw2
from torch_threads import one_torch_thread  # noqa: F401

OL3 = dict(overlapx=3, overlapy=3, overlapz=3)
N = 9          # n_inner of the factories: a warm-up step and one K=8 chunk


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    for k in ("IGG_TUNE", "IGG_PERF", "IGG_PERF_LEDGER", "IGG_OVERLAP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("IGG_TUNE_CACHE", str(tmp_path / "tune.json"))
    for mod in (perf, autotune, iperf, iauto):
        mod.reset()
    tel.reset_metrics()
    tel._ring().clear()
    degrade.reset()
    yield
    for mod in (perf, autotune, iperf, iauto):
        mod.reset()
    degrade.reset()
    if it.grid_is_initialized():
        it.finalize_global_grid()


def grid(local, dims=(2, 2, 2), periods=(1, 1, 1), **kw):
    if it.grid_is_initialized():
        it.finalize_global_grid()
    it.init_global_grid(*local, dimx=dims[0], dimy=dims[1], dimz=dims[2],
                        periodx=periods[0], periody=periods[1],
                        periodz=periods[2], quiet=True, device="cpu", **kw)


def events(kind):
    return [r.payload for r in tel.flight_recorder() if r.kind == kind]


def same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The knob contract
# ---------------------------------------------------------------------------

def test_resolve_contract(monkeypatch):
    assert autotune.resolve(False) is False
    assert autotune.resolve(True) is True
    assert autotune.resolve("auto") == autotune.resolve(None) == "auto"
    monkeypatch.setenv("IGG_TUNE", "0")
    assert autotune.resolve(None) is False
    monkeypatch.setenv("IGG_TUNE", "1")
    assert autotune.resolve(None) is True
    with pytest.raises(it.GridError):
        autotune.resolve("sometimes")
    monkeypatch.setenv("IGG_TUNE", "banana")
    with pytest.raises(it.GridError):
        autotune.resolve(None)
    monkeypatch.delenv("IGG_TUNE")
    assert autotune.applied("diffusion3d", False) is None
    assert autotune.applied("diffusion3d", "auto") is None   # no grid


# ---------------------------------------------------------------------------
# Against igg
# ---------------------------------------------------------------------------

def igg_candidates(family, local, n_inner, dims, **kw):
    igg.init_global_grid(*local, dimx=dims[0], dimy=dims[1], dimz=dims[2],
                         quiet=True, **kw)
    try:
        if family == "shallow_water":
            from igg.models import shallow_water as isw

            isw.make_step(isw.Params(), n_inner=n_inner, donate=False,
                          pallas_interpret=True, tune=False)
        return [(perf.port_tier(c["tier"], bool(c.get("overlap"))),
                 c.get("K"), c.get("bx"), c.get("band"),
                 bool(c.get("overlap")), c.get("vmem_mb"))
                for c in iauto.candidates_for(family, n_inner=n_inner,
                                              interpret=True)]
    finally:
        igg.finalize_global_grid()


CAND_GRIDS = {
    "diffusion3d": ((16, 16, 128), (2, 2, 2), {}),
    "hm3d": ((16, 16, 128), (2, 2, 2), {}),
    "stokes3d": ((16, 16, 128), (2, 2, 2), OL3),
    "wave2d": ((32, 128, 1), (2, 2, 1), dict(periodx=1, periody=1)),
    "shallow_water": ((32, 128, 1), (2, 2, 1), dict(periodx=1, periody=1)),
}


@pytest.mark.parametrize("n_inner", [9, 17])
@pytest.mark.parametrize("family", sorted(CAND_GRIDS))
def test_candidates_are_iggs_under_the_tier_map(family, n_inner):
    """The same 2x2x2 (2-D: 2x2) grid of small blocks gives igg's
    candidate set in igg's order, tier names mapped, vmem_mb None.  One
    documented difference: igg's HM3D chunk gate also refuses K = 4 on
    TPU sublane tiling (`admit_sublane_extension`), a Mosaic gate the
    port's `hm3d_trapezoid_refusal` leaves out, so the port adds that
    candidate."""
    local, dims, kw = CAND_GRIDS[family]
    want = igg_candidates(family, local, n_inner, dims, **kw)
    grid(local, dims, periods=(kw.get("periodx", 0), kw.get("periody", 0),
                               0), **{k: v for k, v in kw.items()
                                      if k.startswith("overlap")})
    if family == "shallow_water":
        tsw.make_step(tsw.Params(), n_inner=n_inner, tune=False)
    got = [(c["tier"], c.get("K"), c.get("bx"), c.get("band"),
            bool(c.get("overlap")), c.get("vmem_mb"))
           for c in autotune.candidates_for(family, n_inner=n_inner)]
    if family == "hm3d":
        extra = ("hm3d.trapezoid", 4, None, None, False, None)
        assert extra in got and extra not in want
        got.remove(extra)
    assert got == want
    assert all(c[5] is None for c in got)


def test_cache_files_cross_load_both_ways(tmp_path):
    """A cache the port wrote loads in igg, and igg's in the port: the
    format is igg's field for field; a winner keyed by another backend or
    device is kept but never served here."""
    grid((8, 8, 8))
    w = autotune.record_winner("diffusion3d", {
        "tier": "diffusion3d.banded", "K": 8, "band": 16, "ms": 1.25})
    port_file = autotune.cache_path()
    doc = json.loads(port_file.read_text())
    assert doc["format"] == iauto.TUNE_FORMAT == autotune.TUNE_FORMAT
    (e,) = doc["entries"].values()
    assert e["vmem_mb"] is None and e["backend"] == "cpu"
    assert iauto.load(port_file) == 1
    (ie,) = iauto._CACHE.values()
    assert {k: ie[k] for k in ("tier", "K", "band", "bx", "ms", "overlap",
                               "local_shape", "dims")} == \
        {k: w[k] for k in ("tier", "K", "band", "bx", "ms", "overlap",
                           "local_shape", "dims")}
    # igg writes a winner under its own names; the port serves it mapped.
    igg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, quiet=True)
    try:
        iauto.reset()
        iauto.record_winner("stokes3d", {"tier": "stokes3d.mosaic", "K": None,
                                         "bx": None, "vmem_mb": None,
                                         "ms": 0.5}, persist=False)
        iauto.record_winner("hm3d", {"tier": "hm3d.xla", "overlap": True,
                                     "ms": 0.7}, persist=False)
        igg_file = tmp_path / "igg_tune.json"
        iauto.save(igg_file)
    finally:
        igg.finalize_global_grid()
    autotune.reset()
    assert autotune.load(igg_file) == 2
    grid((8, 8, 8))
    assert autotune.applied("stokes3d", "auto")["tier"] == "stokes3d.cuda"
    assert autotune.applied("hm3d", "auto")["tier"] == "hm3d.overlap"
    # Another device's winner is kept (and saved) but not served.
    with autotune._lock:
        for k in list(autotune._CACHE):
            e = dict(autotune._CACHE.pop(k), device_kind="NVIDIA H100 80GB "
                                                        "HBM3",
                     backend="cuda")
            autotune._CACHE[autotune._entry_key(e)] = e
    assert autotune.get("stokes3d") is None
    autotune.save(tmp_path / "mixed.json")
    # igg's two and the port's own winner, lazily loaded from the
    # configured cache by `applied`.
    assert len(autotune._read_cache_file(tmp_path / "mixed.json")) == 3


# ---------------------------------------------------------------------------
# The search and the cache
# ---------------------------------------------------------------------------

def two_candidates(family, fast):
    return [{"tier": f"{family}.plain", "K": None, "bx": None,
             "vmem_mb": None}, dict({"K": None, "bx": None, "vmem_mb": None},
                                    **fast)]


def test_search_cache_round_trip_zero_search_dispatches():
    grid((8, 8, 8))
    p = td3.Params()
    w = autotune.search("diffusion3d", n_inner=N, nt=1, cutoff=1e9,
                        candidates=two_candidates("diffusion3d", {
                            "tier": "diffusion3d.cuda", "K": 8, "bx": 8}))
    assert w is not None and autotune.search_dispatches() == 2 * (1 + 4)
    samples = events("autotune_sample")
    assert [s["candidate"] for s in samples] == \
        ["[diffusion3d.plain]", "[diffusion3d.cuda,K=8,bx=8]"]
    assert w["ms"] == min(s["ms_per_step"] for s in samples)
    assert all("autotune" in e["sources"]
               for e in perf.query("diffusion3d"))
    doc = json.loads(autotune.cache_path().read_text())
    assert [e["tier"] for e in doc["entries"].values()] == [w["tier"]]
    # "A second process": fresh memory, the same file.
    autotune.reset()
    assert autotune.search_dispatches() == 0
    w2 = autotune.applied("diffusion3d", "auto")
    assert (w2["tier"], w2.get("bx")) == (w["tier"], w.get("bx"))
    assert autotune.applied("diffusion3d", True, n_inner=N) is not None
    T, Cp = td3.init_fields(p)
    td3.make_multi_step(N, p, tune="auto")(T, Cp)
    assert autotune.search_dispatches() == 0
    assert degrade.active()["diffusion3d"] == w["tier"]


def test_tune_true_searches_on_a_miss_and_prior_orders_the_walk(monkeypatch):
    grid((8, 8, 8))
    ctx = autotune._context("diffusion3d")
    perf.record("diffusion3d", "diffusion3d.cuda", 0.5, source="calibrate",
                local_shape=ctx["local_shape"], dtype="float32",
                dims=ctx["dims"], backend=ctx["backend"],
                device_kind=ctx["device_kind"])
    cands = two_candidates("diffusion3d", {"tier": "diffusion3d.cuda",
                                           "K": 8, "bx": 8})
    real = autotune.candidates_for
    monkeypatch.setattr(autotune, "candidates_for",
                        lambda fam, **kw: [dict(c) for c in cands]
                        if fam == "diffusion3d" else real(fam, **kw))
    monkeypatch.setenv("IGG_TUNE_NT", "1")
    p = td3.Params()
    step = td3.make_multi_step(N, p, tune=True)
    assert autotune.search_dispatches() > 0
    assert events("autotune_sample")[0]["candidate"].startswith(
        "[diffusion3d.cuda")
    T, Cp = td3.init_fields(p)
    step(T, Cp)
    assert degrade.active()["diffusion3d"] == \
        autotune.get("diffusion3d")["tier"]


def test_cutoff_and_failed_candidates(monkeypatch):
    """A candidate whose quick sample exceeds cutoff x the best so far is
    cut off; one its pinned factory cannot serve is skipped with
    `autotune_candidate_failed`."""
    grid((8, 8, 8))
    cands = [{"tier": "diffusion3d.cuda", "K": 8, "bx": 8},
             {"tier": "diffusion3d.plain"},
             {"tier": "diffusion3d.banded", "K": 8, "band": 64}]
    w = autotune.search("diffusion3d", n_inner=N, nt=1, cutoff=1e-6,
                        candidates=cands)
    samples = events("autotune_sample")
    assert [s["cutoff"] for s in samples] == [False, True]
    assert samples[1]["ms_per_step"] == samples[1]["quick_ms_per_step"]
    (failed,) = events("autotune_candidate_failed")
    assert failed["candidate"] == "[diffusion3d.banded,K=8,band=64]"
    assert w["tier"] in ("diffusion3d.cuda", "diffusion3d.plain")


def test_overlapped_winner_is_demoted(monkeypatch):
    """An overlapped winner whose measured decomposition shows no hidden
    communication (hidden >= exchange, `comm.decompose` stubbed to say so)
    is demoted to the best sequential candidate, with the measured times
    in the `overlap_demoted` record."""
    import time

    from igg_torch import comm

    grid((8, 8, 8))
    times = dict(compute=1.0, exchange=2.0, hidden=2.5)
    seen = []
    monkeypatch.setattr(comm, "decompose", lambda *a, **kw: (
        seen.append(kw["config"]), comm._fractions(times))[1])
    real = autotune._build_candidate

    def slowed(family, cand, n_inner, params):
        fn, args = real(family, cand, n_inner, params)
        if cand.get("overlap"):
            return fn, args

        def slow(*a):
            time.sleep(0.02)
            return fn(*a)
        return slow, args

    monkeypatch.setattr(autotune, "_build_candidate", slowed)
    w = autotune.search("diffusion3d", n_inner=3, nt=1, candidates=[
        {"tier": "diffusion3d.overlap", "overlap": True},
        {"tier": "diffusion3d.plain"}])
    (d,) = events("overlap_demoted")
    assert d["demoted_to"] == "[diffusion3d.plain]"
    assert (d["exchange_ms"], d["hidden_ms"]) == (2.0, 2.5)
    assert seen == ["diffusion3d.overlap"]
    assert w["tier"] == "diffusion3d.plain" and not w["overlap"]


def test_explicit_args_beat_a_cached_winner(monkeypatch):
    grid((16, 16, 16))
    autotune.record_winner("diffusion3d", {"tier": "diffusion3d.cuda",
                                           "K": 4, "bx": 4, "ms": 0.1})
    from igg_torch.ops import diffusion_pallas as dp

    seen = []
    real = dp.fused_diffusion_steps
    monkeypatch.setattr(dp, "fused_diffusion_steps",
                        lambda *a, **kw: seen.append(kw["bx"]) or
                        real(*a, **kw))
    p = td3.Params()
    T, Cp = td3.init_fields(p)
    td3.make_multi_step(N, p, bx=8, tune="auto")(T, Cp)
    td3.make_multi_step(N, p, tune="auto")(T, Cp)
    td3.make_multi_step(N, p, tune=False)(T, Cp)
    assert seen == [8, 4, 8]
    # A caller's use_kernels=False outranks a cached kernel winner.
    td3.make_multi_step(N, p, use_kernels=False, tune="auto")(T, Cp)
    assert degrade.active()["diffusion3d"] == "diffusion3d.plain"


def test_cached_K_falls_back_to_the_fit_at_a_smaller_n_inner():
    """The cache key has no n_inner: a cached K = 8 at n_inner = 5, where
    only K = 4 fits, falls back to the fit and still serves the chunk
    route; a caller's K = 8 refuses."""
    grid((16, 16, 16))
    autotune.record_winner("hm3d", {"tier": "hm3d.trapezoid", "K": 8,
                                    "ms": 1.0})
    p = th3.Params(lx=4.0, ly=4.0, lz=4.0)
    Pe, phi = th3.init_fields(p)
    th3.make_multi_step(5, p, tune="auto")(Pe, phi)
    assert degrade.active()["hm3d"] == "hm3d.trapezoid"
    with pytest.raises(it.GridError, match="chunk tier"):
        th3.make_multi_step(5, p, trapezoid=True, K=8, tune=False)(Pe, phi)
    # Stokes, wave2d and specs take the same rule through their routes.
    grid((16, 16, 16), **OL3)
    autotune.record_winner("stokes3d", {"tier": "stokes3d.trapezoid",
                                        "K": 8, "ms": 1.0})
    S = tst3.init_fields(tst3.Params())
    tst3.make_iteration(tst3.Params(), n_inner=5, tune="auto")(*S)
    assert degrade.active()["stokes3d"] == "stokes3d.trapezoid"
    with pytest.raises(it.GridError, match="chunk tier"):
        tst3.make_iteration(tst3.Params(), n_inner=5, trapezoid=True, K=8,
                            tune=False)(*S)


def test_invalidate_scoped_and_durable():
    grid((8, 8, 8))
    autotune.record_winner("famA", {"tier": "famA.cuda", "bx": 8, "ms": 1.0})
    assert autotune.invalidate("famA", tier="famA.trapezoid") == 0
    assert autotune.get("famA") is not None
    assert autotune.invalidate("famA", tier="famA.cuda") == 1
    assert autotune.get("famA") is None
    assert not json.loads(autotune.cache_path().read_text())["entries"]
    assert events("tune_invalidated")[-1]["entries"] == 1


def test_corrupt_cache_is_never_fatal(tmp_path, monkeypatch):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    monkeypatch.setenv("IGG_TUNE_CACHE", str(p))
    autotune.reset()
    grid((8, 8, 8))
    assert autotune.get("anything") is None
    p2 = td3.Params()
    T, Cp = td3.init_fields(p2)
    td3.make_step(p2, tune="auto")(T, Cp)            # factories still build
    with pytest.raises(it.GridError, match="valid JSON"):
        autotune.load(p)
    autotune.record_winner("f", {"tier": "f.plain", "ms": 1.0})
    assert len(autotune._read_cache_file(p)) == 1     # replaced on save


def test_save_merges_and_the_newest_wins(tmp_path):
    grid((8, 8, 8))
    p = tmp_path / "t.json"
    autotune.record_winner("f1", {"tier": "f1.plain", "ms": 2.0},
                           persist=False)
    autotune.save(p)
    autotune.reset()
    autotune.record_winner("f2", {"tier": "f2.plain", "ms": 3.0},
                           persist=False)
    autotune.save(p)
    assert {e["family"] for e in autotune._read_cache_file(p)} == {"f1",
                                                                   "f2"}
    autotune.reset()
    autotune.record_winner("f1", {"tier": "f1.cuda", "K": 8, "ms": 1.0},
                           persist=False)
    autotune.save(p)
    f1 = [e for e in autotune._read_cache_file(p) if e["family"] == "f1"]
    assert [e["tier"] for e in f1] == ["f1.cuda"]


# ---------------------------------------------------------------------------
# A tuned factory is bitwise the factory pinned to its winner
# ---------------------------------------------------------------------------

def diffusion_case():
    grid((16, 16, 16), periods=(0, 0, 0))
    p = td3.Params()
    return "diffusion3d", td3.init_fields(p), lambda **kw: (
        td3.make_multi_step(N, p, **kw))


def stokes_case():
    grid((16, 16, 16), dims=(2, 1, 1), periods=(1, 0, 1), **OL3)
    p = tst3.Params()
    return "stokes3d", tst3.init_fields(p), lambda **kw: (
        tst3.make_iteration(p, n_inner=5, **kw))


def hm3d_case():
    grid((16, 16, 16), dims=(2, 1, 1))
    p = th3.Params(lx=4.0, ly=4.0, lz=4.0)
    return "hm3d", th3.init_fields(p), lambda **kw: (
        th3.make_multi_step(5, p, **kw))


def wave2d_case():
    grid((32, 32, 1), dims=(2, 2, 1), periods=(1, 1, 0))
    p = tw2.Params()
    return "wave2d", it.update_halo(*tw2.init_fields(p)), lambda **kw: (
        tw2.make_multi_step(N, p, **kw))


def sw_case():
    grid((32, 32, 1), dims=(2, 1, 1), periods=(1, 0, 0))
    p = tsw.Params()
    from igg_torch import stencil

    return "shallow_water", it.update_halo(*tsw.init_fields(p)), \
        lambda **kw: stencil.compile(tsw.spec(p), coeffs=p.coeffs(),
                                     n_inner=N, **kw)


CASES = {"diffusion3d": diffusion_case, "stokes3d": stokes_case,
         "hm3d": hm3d_case, "wave2d": wave2d_case,
         "shallow_water": sw_case}
WINNERS = {
    "diffusion3d": [{"tier": "diffusion3d.banded", "K": 8, "band": 8},
                    {"tier": "diffusion3d.cuda", "K": 4, "bx": 4},
                    {"tier": "diffusion3d.plain"}],
    "stokes3d": [{"tier": "stokes3d.cuda"},
                 {"tier": "stokes3d.trapezoid", "K": 4},
                 {"tier": "stokes3d.banded", "K": 4, "band": 8}],
    "hm3d": [{"tier": "hm3d.cuda"}, {"tier": "hm3d.trapezoid", "K": 4},
             {"tier": "hm3d.banded", "K": 4, "band": 8}],
    "wave2d": [{"tier": "wave2d.cuda"}, {"tier": "wave2d.chunk", "K": 4},
               {"tier": "wave2d.banded", "K": 4, "band": 8}],
    "shallow_water": [{"tier": "shallow_water.cuda"},
                      {"tier": "shallow_water.chunk", "K": 4},
                      {"tier": "shallow_water.plain"}],
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_tuned_factory_is_bitwise_the_pinned_factory(family):
    fam, S, make = CASES[family]()
    today = make(tune=False)(*(a.clone() for a in S))
    rule = degrade.active()[fam]
    for w in WINNERS[family]:
        autotune.record_winner(fam, dict(w, ms=1.0))
        got = make(tune="auto")(*(a.clone() for a in S))
        assert degrade.active()[fam] == w["tier"], w
        same(got, make(**autotune._knobs(fam, dict(w)))(
            *(a.clone() for a in S)))
        assert autotune.search_dispatches() == 0
    # tune=False keeps today's rule, whatever the cache holds.
    same(today, make(tune=False)(*(a.clone() for a in S)))
    assert degrade.active()[fam] == rule


def test_cached_overlap_resolves_overlap_auto():
    """A winner's overlap axis reaches `resolve_overlap`: an igg winner
    `<family>.xla` with overlap serves `<family>.overlap`; IGG_OVERLAP=0
    still pins it off."""
    fam, S, make = diffusion_case()
    autotune.record_winner(fam, {"tier": "diffusion3d.xla", "overlap": True,
                                 "ms": 1.0})
    make(tune="auto")(*S)
    assert degrade.active()[fam] == "diffusion3d.overlap"
    import os

    os.environ["IGG_OVERLAP"] = "0"
    try:
        make(tune="auto")(*S)
    finally:
        del os.environ["IGG_OVERLAP"]
    assert degrade.active()[fam] == "diffusion3d.plain"
