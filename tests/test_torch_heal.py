"""The port's self-healing control plane (igg_torch.heal) held against
igg's on the CPU.

The engine is host logic: fed the same synthetic bus records, the port's
engine plans the same actions and emits the same ``heal_*`` records as
igg's (one parametrised test over the streams of igg's
`tests/test_heal.py`).  `recalibrate` has igg's ledger effects, the
policy igg's validation and `as_engine` igg's coercion.  Then the loops on
the port's run loops, held to igg's contracts on the CPU (8 blocks of 8^3
periodic, `device="cpu"`, float64): a stall and a straggler re-tile the
grid over its block slots and end bitwise the uninterrupted run; a re-tile
without a ring is skipped; a drift recalibrates; a lagging fleet job is
repacked onto half the slots and ends bitwise the clean drain.  igg's
`test_stall_heals_by_elastic_retile_bit_exact` and
`test_lagging_job_repacks_bit_exact` fail in igg's own run on its CPU
devices (ROADMAP "Standing caveat"): their counterparts hold the port to
the documented contract alone.
"""

import json
import os
import time

import numpy as np
import pytest

import igg
import igg_torch as it
from igg import heal as iheal
from igg_torch import heal as theal
from igg_torch import resilience
from igg_torch import telemetry as ttel
from igg_torch.ops.stencil import interior_add
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"igg": igg, "port": it}
HEAL = {"igg": iheal, "port": theal}


def _reset_observability():
    for mod in (igg, it):
        tel = mod.telemetry
        for s in list(tel._SESSIONS):
            s.detach()
        with tel._lock:
            tel._SUBSCRIBERS.clear()
        tel.reset_metrics()
        tel._ring().clear()
        mod.perf.reset()
        mod.resilience.clear_preemption()


@pytest.fixture(autouse=True)
def _clean():
    """Metrics, the flight ring, the subscribers, the perf ledger and the
    preemption flag are process-global: isolate every test."""
    _reset_observability()
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    _reset_observability()
    if it.grid_is_initialized():
        it.finalize_global_grid()


# ---------------------------------------------------------------------------
# The engine on synthetic record streams, both packages
# ---------------------------------------------------------------------------

def _stall(step, run="resilient"):
    return ("emit", "collective_stall", step,
            {"run": run, "in_flight": "probe"})


def _window(ms, run="resilient"):
    return ("emit", "step_stats", None,
            {"run": run, "ms_per_step": ms, "steps_per_s": 1e3 / ms,
             "window_steps": 2})


def _job_window(rate):
    return ("emit", "step_stats", None,
            {"run": "ensemble", "ms_per_step": 1.0, "steps_per_s": 1e3,
             "member_steps_per_s": rate, "window_steps": 2})


# name -> (policy, engine run, ops).  Ops: ("emit", kind, step, payload),
# ("pop",), ("done", action), ("watch", job, expected), ("unwatch",),
# ("take", job), ("reset",), ("skipped", action).
STREAMS = {
    "stall": (dict(max_actions=1, cooldown_s=0.0), "resilient",
              [_stall(3), ("pop",), ("done", "retile"), _stall(9),
               _stall(9, run="ensemble"), ("pop",)]),
    "straggler_windows": (dict(max_actions=2, cooldown_s=0.0, sustain=2),
                          "resilient",
                          [_window(10.0), _window(11.0), _window(9.0),
                           _window(50.0), _window(10.0), _window(50.0),
                           _window(60.0), ("pop",), ("done", "retile"),
                           ("reset",), _window(30.0), _window(30.0),
                           _window(30.0), _window(200.0), _window(200.0),
                           ("pop",), _window(5.0, run="ensemble")]),
    "rank_skew": (dict(max_actions=2, cooldown_s=0.0, sustain=1,
                       skew_tol=2.0), "resilient",
                  [("emit", "rank_skew", 40,
                    {"max_skew_ms": 5.0, "median_ms": 10.0,
                     "worst_rank": 1, "ranks": 4}),
                   ("pop",),
                   ("emit", "rank_skew", 50,
                    {"max_skew_ms": 30.0, "median_ms": 10.0,
                     "worst_rank": 3, "ranks": 4}),
                   ("pop",), ("done", "retile"),
                   ("emit", "rank_skew", 60,
                    {"max_skew_ms": 30.0, "median_ms": 0.0,
                     "worst_rank": 3, "ranks": 4}), ("pop",)]),
    "drift": (dict(max_actions=3, cooldown_s=0.0), "resilient",
              [("emit", "cost_model_drift", 10,
                {"family": "diffusion3d", "tier": "diffusion3d.cuda",
                 "rel_error": 9.0}), ("pop",),
               ("done", "recalibrate"),
               ("emit", "cost_model_drift", 20,
                {"family": "diffusion3d", "tier": "diffusion3d.cuda",
                 "rel_error": 8.0}),
               ("emit", "cost_model_drift", 20,
                {"family": "hm3d", "tier": "hm3d.cuda", "rel_error": 2.0}),
               ("pop",), ("pop",)]),
    "lagging_job": (dict(max_actions=1, cooldown_s=0.0, sustain=2),
                    "fleet",
                    [("watch", "j", 5000.0), _job_window(4000.0),
                     _job_window(800.0), _job_window(3000.0),
                     _job_window(800.0), _job_window(700.0),
                     ("take", "j"), ("take", "j"), ("pop",),
                     _job_window(600.0), _job_window(600.0), ("unwatch",),
                     _job_window(1.0), _job_window(1.0)]),
    "lagging_job_baseline": (dict(max_actions=2, cooldown_s=0.0, sustain=1,
                                  baseline_windows=3), "fleet",
                             [("watch", "k", None), _job_window(900.0),
                              _job_window(1100.0), _job_window(1000.0),
                              _job_window(800.0), _job_window(400.0),
                              ("take", "k")]),
    "flapping": (dict(max_actions=2, cooldown_s=0.0, sustain=1,
                      escalation=()), "resilient",
                 [op for i in range(30)
                  for op in (_stall(i), ("pop", "done"))]),
    "cooldown_and_sustain": (dict(max_actions=10, cooldown_s=3600.0,
                                  sustain=3), "resilient",
                             [_window(m) for m in (10.0, 10.0, 10.0, 50.0,
                                                   50.0, 10.0, 50.0, 50.0)]
                             + [("pop",)]
                             + [_window(50.0)] * 3
                             + [("pop",), ("done", "retile")]
                             + [_window(50.0)] * 3 + [("pop",)]),
    "escalation": (dict(max_actions=0, cooldown_s=0.0,
                        escalation=("demote", "fail")), "resilient",
                   [_stall(1), _stall(2), ("pop",), ("done", "demote"),
                    ("pop",), _stall(3), ("pop",)]),
    "integrity_and_skip": (dict(max_actions=3, cooldown_s=0.0), "resilient",
                           [("emit", "integrity_violation", 30,
                             {"run": "resilient", "rank": 3,
                              "invariant": "total_heat", "field": "T"}),
                            ("pop",), ("skipped", "retile"), _stall(40),
                            ("pop",),
                            ("emit", "integrity_violation", 50,
                             {"run": "ensemble", "rank": 1})]),
}


def _drive(name, case):
    """Feed one stream to package `name`'s engine: returns the popped
    actions, the take_repack counts (relative to the preemption count
    before the stream), the engine's actions, skips and suppressions, and
    the ``heal_*`` records on the bus."""
    mod, heal = PKGS[name], HEAL[name]
    policy, run, ops = STREAMS[case]
    eng = heal.HealEngine(heal.HealPolicy(**policy), run=run)
    recs = []

    def take(rec):
        if rec.kind.startswith("heal_"):
            recs.append((rec.kind, rec.step, dict(rec.payload)))

    base = mod.resilience.preemption_requests()
    popped, taken = [], []
    mod.telemetry.subscribe(take)
    eng.attach()
    try:
        for op in ops:
            if op[0] == "emit":
                mod.telemetry.emit(op[1], step=op[2], **op[3])
            elif op[0] == "pop":
                act = eng.pop()
                popped.append(act)
                if act is not None and len(op) > 1:
                    eng.record_done(act["action"])
            elif op[0] == "done":
                eng.record_done(op[1])
            elif op[0] == "skipped":
                eng.record_skipped(op[1], reason="test")
            elif op[0] == "watch":
                eng.watch_job(op[1], op[2])
            elif op[0] == "unwatch":
                eng.unwatch_job()
            elif op[0] == "take":
                rc = eng.take_repack(op[1])
                taken.append(None if rc is None else rc - base)
            elif op[0] == "reset":
                eng.reset_baseline()
        preempt = mod.resilience.preemption_requested()
    finally:
        eng.detach()
        mod.telemetry.unsubscribe(take)
        mod.resilience.clear_preemption()
    return dict(popped=popped, taken=taken, actions=eng.actions,
                skipped=eng.skipped, suppressed=eng.suppressed, records=recs,
                pending=eng.has_pending(), preempt=preempt)


@pytest.mark.parametrize("case", list(STREAMS))
def test_engine_plans_as_iggs(case):
    want = _drive("igg", case)
    got = _drive("port", case)
    assert got == want
    # igg's contracts of the streams (tests/test_heal.py).
    if case == "flapping":
        assert len(got["actions"]) == 2 and got["suppressed"] == 28
        kinds = [r[0] for r in got["records"]]
        assert kinds.count("heal_planned") == 2
        assert "heal_suppressed" in kinds and "heal_escalated" not in kinds
    elif case == "escalation":
        kinds = [r[0] for r in got["records"]]
        assert kinds.count("heal_escalated") == 2
        assert [a["action"] for a in got["popped"][:2]] == ["demote", "fail"]
    elif case == "lagging_job":
        assert got["taken"] == [1, None] and got["preempt"]
    elif case == "rank_skew":
        assert got["popped"][0] is None
        assert got["popped"][1]["reason"] == "rank_skew_excess"
    elif case == "cooldown_and_sustain":
        assert got["popped"][0] is None
        assert got["popped"][1]["action"] == "retile"
        assert got["popped"][2] is None and got["suppressed"] >= 1


def test_rank_skew_publish_feeds_the_engine():
    """`comm.rank_skew(publish=True)`'s record is the engine's multi-rank
    straggler feed: a worst rank beyond `skew_tol` plans a retile."""
    eng = theal.HealEngine(theal.HealPolicy(max_actions=1, cooldown_s=0.0,
                                            sustain=1, skew_tol=2.0))
    records = [{"kind": "step_stats", "step": 50, "process": p,
                "payload": {"ms_per_step": ms}}
               for p, ms in enumerate((10.0, 10.0, 10.0, 40.0))]
    with eng:
        it.comm.rank_skew(records)          # analysis only: no record
        assert not eng.has_pending()
        it.comm.rank_skew(records, publish=True)
    act = eng.pop()
    assert act["action"] == "retile" and act["suspect_rank"] == 3


def test_policy_validation_and_as_engine_coercion(monkeypatch):
    """igg's test_policy_validation_and_as_engine_coercion and
    test_heal_env_knobs_registered on the port, messages included."""
    for kw in (dict(sustain=0), dict(max_actions=-1), dict(cooldown_s=-1.0),
               dict(escalation=("explode",))):
        with pytest.raises(igg.GridError) as want:
            iheal.HealPolicy(**kw)
        with pytest.raises(it.GridError) as got:
            theal.HealPolicy(**kw)
        assert str(got.value) == str(want.value)
    assert theal.as_engine(False) is None
    assert theal.as_engine(None) is None          # IGG_HEAL unset: off
    monkeypatch.setenv("IGG_HEAL", "1")
    eng = theal.as_engine(None, run="fleet")
    assert isinstance(eng, theal.HealEngine) and eng.run == "fleet"
    assert theal.as_engine(False) is None
    monkeypatch.setenv("IGG_HEAL_MAX_ACTIONS", "7")
    monkeypatch.setenv("IGG_HEAL_COOLDOWN", "2.5")
    monkeypatch.setenv("IGG_HEAL_SUSTAIN", "4")
    monkeypatch.setenv("IGG_HEAL_SKEW_TOL", "6")
    monkeypatch.setenv("IGG_HEAL_THROUGHPUT_TOL", "0.25")
    got, want = theal.as_engine(True).policy, iheal.as_engine(True).policy
    assert got == theal.HealPolicy(max_actions=7, cooldown_s=2.5, sustain=4,
                                   skew_tol=6.0, throughput_tol=0.25)
    assert (got.max_actions, got.cooldown_s, got.sustain, got.skew_tol,
            got.throughput_tol) == (want.max_actions, want.cooldown_s,
                                    want.sustain, want.skew_tol,
                                    want.throughput_tol)
    pol = theal.HealPolicy(max_actions=1)
    assert theal.as_engine(pol).policy is pol
    eng2 = theal.HealEngine(pol)
    assert theal.as_engine(eng2) is eng2
    with pytest.raises(it.GridError, match="heal='bogus': expected None"):
        theal.as_engine("bogus")
    from igg_torch import _env

    for name in ("IGG_HEAL", "IGG_HEAL_MAX_ACTIONS", "IGG_HEAL_COOLDOWN",
                 "IGG_HEAL_SKEW_TOL", "IGG_HEAL_THROUGHPUT_TOL",
                 "IGG_HEAL_SUSTAIN"):
        assert name in _env._KNOWN, name


# ---------------------------------------------------------------------------
# recalibrate: igg's ledger effects
# ---------------------------------------------------------------------------

def _ledger_effects(name, family):
    mod, heal = PKGS[name], HEAL[name]
    mod.perf.record(family, f"{family}.x", 2.5, source="watchdog",
                    local_shape=(8, 8, 8), dtype="float32", dims=(2, 2, 2),
                    backend="cpu", device_kind="cpu")
    mod.perf.predict(family, 99.0)
    recs = []

    def take(rec):
        if rec.kind in ("perf_invalidated", "recalibrated"):
            recs.append((rec.kind, dict(rec.payload)))

    mod.telemetry.subscribe(take)
    try:
        sec = heal.recalibrate(family)
    finally:
        mod.telemetry.unsubscribe(take)
    with mod.perf._lock:
        pred = dict(mod.perf._PREDICTIONS.get(family) or {})
    entries = [(e["tier"], e["best_ms"], e["count"])
               for e in mod.perf.query(family)]
    return dict(sec=sec, pred=pred, entries=entries, recs=recs,
                never=heal.recalibrate("neverseen"))


def test_recalibrate_unknown_family_equals_iggs():
    """igg's test_recalibrate_unknown_family_reanchors_from_ledger: the
    freshest measured sample re-anchors the prediction and re-seeds the
    ledger; with no measurement, None.  Both packages alike."""
    want = _ledger_effects("igg", "myphysics")
    got = _ledger_effects("port", "myphysics")
    assert got == want
    assert got["sec"] == pytest.approx(2.5e-3)
    assert got["pred"]["source"] == "heal"
    assert got["entries"] == [("myphysics.x", 2.5, 1)]
    assert got["never"] is None


def test_recalibrate_known_family_measures_on_the_live_grid():
    """A built-in family is re-measured by `perf.calibrate` on the live
    grid, as in igg: the stale entry invalidated, a fresh one measured
    (source "heal"), the prediction the measurement."""
    out = {}
    for name in ("igg", "port"):
        mod = PKGS[name]
        kw = dict(device="cpu", nprocs=8) if name == "port" else {}
        mod.init_global_grid(8, 8, 8, periodx=1, periody=1, periodz=1,
                             quiet=True, **kw)
        try:
            out[name] = _ledger_effects(name, "diffusion3d")
        finally:
            mod.finalize_global_grid()
    for name, got in out.items():
        assert got["pred"]["source"] == "heal", name
        assert got["pred"]["s_per_step"] == got["sec"] < 1.0, name
        assert [r[0] for r in got["recs"]] == ["perf_invalidated",
                                               "recalibrated"], name
        inv, recal = got["recs"][0][1], got["recs"][1][1]
        assert inv["entries"] == 1 and recal["invalidated"] == 1, name
        assert recal["measured_s_per_step"] == got["sec"], name
        assert len(got["entries"]) == 1, name
    assert sorted(out["port"]["recs"][1][1]) == \
        sorted(out["igg"]["recs"][1][1])


# ---------------------------------------------------------------------------
# plan_retile over the block slots of one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suspects,drop,want", [
    (None, 1, (7, (2, 2, 1))),
    ([5], 1, (7, (2, 2, 1))),
    ([5, 99], 1, (7, (2, 2, 1))),
    ([99], 2, (6, (3, 2, 1))),
    (["cuda:3"], 2, (6, (3, 2, 1))),
    ([0, "cuda"], 1, (6, (3, 2, 1))),
    (list(range(8)), 1, (8, (2, 2, 2))),
])
def test_plan_retile_over_slots(suspects, drop, want):
    """A block rank fences its slot (a rank outside the grid is ignored);
    a device suspect, or no usable suspect, fences `retile_drop` slots
    from the tail; fencing every slot keeps them all.  The survivors'
    count goes to `plan_dims` (interior 12^3 periodic: 7 and 5 slots fit
    no split, so 4; 6 slots give (3, 2, 1)); the devices are the grid's
    one device, repeated."""
    it.init_global_grid(8, 8, 8, periodx=1, periody=1, periodz=1,
                        device="cpu", nprocs=8, quiet=True)
    grid = it.get_global_grid()
    eng = theal.HealEngine(theal.HealPolicy(retile_drop=drop))
    devs, dims, local = eng.plan_retile(grid, suspects=suspects)
    survivors, want_dims = want
    assert dims == it.fleet.plan_dims((12, 12, 12), survivors)[0]
    assert int(np.prod(dims)) == len(devs)
    assert all(d == grid.device for d in devs)
    assert tuple(want_dims) == tuple(dims) or survivors == 7
    it.finalize_global_grid()
    it.init_global_grid(8, 8, 8, periodx=1, periody=1, periodz=1,
                        device="cpu", nprocs=1, quiet=True)
    devs, dims, local = eng.plan_retile(it.get_global_grid())
    assert dims == (1, 1, 1) and local == (8, 8, 8)   # nothing to fence


# ---------------------------------------------------------------------------
# The loops on run_resilient (the port's contracts)
# ---------------------------------------------------------------------------

def _grid(n=8):
    it.init_global_grid(n, n, n, periodx=1, periody=1, periodz=1,
                        device="cpu", nprocs=8, quiet=True)


def _make_step(sleep=0.0):
    """igg's `_make_step` (a Laplacian relaxation) on the port's stacked
    grid, with a wall-clock floor per dispatch."""
    def step(st):
        if sleep:
            time.sleep(sleep)
        T = st["T"]
        lap = (T[:-2, 1:-1, 1:-1] + T[2:, 1:-1, 1:-1]
               + T[1:-1, :-2, 1:-1] + T[1:-1, 2:, 1:-1]
               + T[1:-1, 1:-1, :-2] + T[1:-1, 1:-1, 2:]
               - 6.0 * T[1:-1, 1:-1, 1:-1])
        return {"T": it.update_halo_local(interior_add(T, 0.1 * lap))}

    return step


def _init_state(n=8, seed=3):
    import torch

    rng = np.random.default_rng(seed)
    T = it.from_local_blocks(lambda c, ls: rng.standard_normal(ls),
                             (n, n, n), dtype=torch.float64)
    return {"T": it.update_halo(T)}


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_stall_heals_by_elastic_retile_bitwise(tmp_path, monkeypatch):
    """igg's test_stall_heals_by_elastic_retile_bit_exact (which fails in
    igg's own run on its CPU devices), held to the contract: a stall tied
    to the 8-slot grid fires the heartbeat; the engine seals a generation,
    fences a slot, re-plans over the survivors (12^3 periodic on 7 slots:
    6 fit) and resumes elastically; the stall heals once the grid has left
    8 slots, and the run ends bitwise the uninterrupted one."""
    monkeypatch.setenv("IGG_COMM_STALL_TIMEOUT", "0.05")
    nt = 40
    slow = _make_step(sleep=0.004)
    _grid()
    ref = it.gather_interior(it.run_resilient(
        slow, _init_state(), nt, watch_every=2,
        install_sigterm=False).state["T"])
    it.finalize_global_grid()

    _grid()
    eng = theal.HealEngine(theal.HealPolicy(max_actions=1, cooldown_s=0.0))
    # The sick slot: probes never report ready while the grid holds it.
    monkeypatch.setattr(resilience, "_CHAOS_FETCH_TAP",
                        lambda x: it.get_global_grid().nprocs != 8)
    res = it.run_resilient(slow, _init_state(), nt, watch_every=2,
                           checkpoint_dir=tmp_path / "ring",
                           checkpoint_every=4, max_pending_probes=100,
                           heal=eng, telemetry=tmp_path / "tel",
                           install_sigterm=False)
    assert res.steps_done == nt and res.retries == 0
    ev = next(e for e in res.events if e.kind == "heal_retile")
    assert ev.detail["from_dims"] == [2, 2, 2] and ev.detail["devices"] == 6
    g2 = it.get_global_grid()
    assert tuple(ev.detail["dims"]) == g2.dims == (3, 2, 1)
    np.testing.assert_array_equal(it.gather_interior(res.state["T"]), ref)
    assert [a["action"] for a in eng.actions] == ["retile"]
    rk = [r["kind"] for r in _events(tmp_path / "tel" / "events_r0.jsonl")]
    assert rk.index("collective_stall") < rk.index("heal_planned") \
        < rk.index("heal_retile")


def test_straggler_window_inflation_triggers_retile(tmp_path):
    """igg's test_straggler_window_inflation_triggers_retile on the port:
    the straggler inflates the windows past `skew_tol` times the run's
    baseline, the engine re-tiles, and the run ends bitwise."""
    nt = 200
    slow = _make_step(sleep=0.004)
    _grid(n=6)
    ref = it.gather_interior(it.run_resilient(
        slow, _init_state(6), nt, watch_every=2,
        install_sigterm=False).state["T"])
    it.finalize_global_grid()

    _grid(n=6)
    eng = theal.HealEngine(theal.HealPolicy(
        max_actions=1, cooldown_s=0.0, sustain=2, skew_tol=3.0,
        baseline_windows=2, escalation=()))
    with it.chaos.straggler(rank=0, factor=5.0, base_window_s=0.05,
                            after=8):
        res = it.run_resilient(slow, _init_state(6), nt, watch_every=2,
                               checkpoint_dir=tmp_path / "ring",
                               checkpoint_every=4, max_pending_probes=300,
                               heal=eng, install_sigterm=False)
    assert res.steps_done == nt
    assert [a["action"] for a in eng.actions] == ["retile"]
    ev = next(e for e in res.events if e.kind == "heal_retile")
    assert ev.detail["reason"] == "window_inflation"
    np.testing.assert_array_equal(it.gather_interior(res.state["T"]), ref)


def test_retile_without_ring_is_skipped_not_fatal(tmp_path, monkeypatch):
    """igg's test_retile_without_ring_is_skipped_not_fatal on the port: no
    ring, nothing to seal; `heal_skipped`, the budget refunded, no
    escalation, the grid untouched, the run complete."""
    monkeypatch.setenv("IGG_COMM_STALL_TIMEOUT", "0.05")
    _grid()
    eng = theal.HealEngine(theal.HealPolicy(max_actions=1, cooldown_s=0.0))
    with it.chaos.collective_stall():
        res = it.run_resilient(_make_step(sleep=0.006), _init_state(), 30,
                               watch_every=2, max_pending_probes=100,
                               heal=eng, telemetry=tmp_path,
                               install_sigterm=False)
    assert res.steps_done == 30
    assert it.get_global_grid().dims == (2, 2, 2)
    recs = _events(tmp_path / "events_r0.jsonl")
    skips = [r for r in recs if r["kind"] == "heal_skipped"]
    assert skips and "ring" in skips[0]["payload"]["why"]
    assert eng.actions == []
    assert [s["action"] for s in eng.skipped] == ["retile"]
    assert not any(r["kind"] == "heal_escalated" for r in recs)


def test_drift_recalibrates_and_heals_bitwise(tmp_path):
    """igg's test_drift_recalibrates_and_heals_bit_exact on the port: a
    stale calibration fires `cost_model_drift`; the engine invalidates,
    re-measures and re-registers once; the physics is untouched."""
    import torch

    from igg_torch.models import diffusion3d as t3

    def run(**kw):
        it.init_global_grid(16, 16, 16, periodx=1, periody=1, periodz=1,
                            device="cpu", nprocs=8, quiet=True)
        T0, Cp = t3.init_fields(t3.Params(), dtype=torch.float32)
        step = t3.make_step(t3.Params())
        res = it.run_resilient(
            lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]},
            {"T": T0, "Cp": Cp}, 40, watch_every=5, install_sigterm=False,
            **kw)
        out = it.gather_interior(res.state["T"])
        it.finalize_global_grid()
        return res, out

    _, ref = run()
    eng = theal.HealEngine(theal.HealPolicy(max_actions=3, cooldown_s=0.0))
    with it.chaos.stale_calibration("diffusion3d", 10.0):
        res, out = run(heal=eng, telemetry=tmp_path)
    np.testing.assert_array_equal(out, ref)
    recals = [a for a in eng.actions if a["action"] == "recalibrate"]
    assert len(recals) == 1 and recals[0]["family"] == "diffusion3d"
    with it.perf._lock:
        pred = dict(it.perf._PREDICTIONS["diffusion3d"])
    assert pred["source"] == "heal" and pred["s_per_step"] < 1.0
    assert [e.kind for e in res.events].count("heal_recalibrate") == 1
    rk = [r["kind"] for r in _events(tmp_path / "events_r0.jsonl")]
    assert rk.index("cost_model_drift") < rk.index("heal_planned") \
        < rk.index("perf_invalidated") < rk.index("recalibrated")


def test_escalation_walks_demote_then_fail(tmp_path):
    """igg's test_escalation_walks_demote_then_fail on the port (CPU
    tensors: the demotion quarantines what served, here nothing): the
    ladder walks demote, then fail; `HealEscalation` is a
    `ResilienceError` naming its flight-recorder dumps."""
    _grid()
    eng = theal.HealEngine(theal.HealPolicy(
        max_actions=0, cooldown_s=0.0, escalation=("demote", "fail")))
    eng.attach()
    ttel.emit("collective_stall", step=1, run="resilient", in_flight="probe")
    ttel.emit("collective_stall", step=2, run="resilient", in_flight="probe")
    with pytest.raises(theal.HealEscalation) as ei:
        it.run_resilient(_make_step(), _init_state(), 20, watch_every=5,
                         heal=eng, telemetry=tmp_path, install_sigterm=False)
    err = ei.value
    assert [a["action"] for a in eng.actions] == ["demote"]
    assert err.dump_paths and "flight recorder dumped to" in str(err)
    assert all(p.exists() for p in err.dump_paths)
    assert isinstance(err, it.ResilienceError)
    assert "max_actions=0" in str(err)
    kinds = [r.kind for r in ttel.flight_recorder()]
    assert kinds.count("heal_escalated") == 2
    assert not eng._attached       # the run's finally detached it


def test_refused_demotion_raises_heal_escalation(tmp_path, monkeypatch):
    """Where the ladder's `demote` step is refused (on the card,
    `demote_active` refuses a tier that served CUDA tensors: the card test
    `test_heal_demote_raises_on_the_card`), the run raises the `fail`
    step's `HealEscalation` at once, naming the tier, the refusal as a
    note, the dumps named; nothing is served in its place."""
    from igg_torch import degrade

    def refuse(**kw):
        raise it.GridError("degrade: demoting the tier(s) (diffusion3d.cuda)"
                           " would serve diffusion3d.plain, which the port "
                           "does not serve on the card; nothing was "
                           "quarantined.")

    monkeypatch.setattr(degrade, "demote_active", refuse)
    _grid()
    eng = theal.HealEngine(theal.HealPolicy(
        max_actions=0, cooldown_s=0.0, escalation=("demote", "fail")))
    eng.attach()
    ttel.emit("collective_stall", step=1, run="resilient", in_flight="probe")
    with pytest.raises(theal.HealEscalation) as ei:
        it.run_resilient(_make_step(), _init_state(), 20, watch_every=5,
                         heal=eng, telemetry=tmp_path, install_sigterm=False)
    err = ei.value
    assert "diffusion3d.cuda" in str(err) and "max_actions=0" in str(err)
    assert any("demote step was refused" in n for n in err.__notes__)
    assert err.dump_paths and eng.actions == []
    assert isinstance(err.__cause__, it.GridError)


def test_journal_is_fsynced(tmp_path, monkeypatch):
    """igg's test_journal_and_manifest_seal_are_fsynced, the journal half
    (the manifest's is tests/test_torch_checkpoint.py's): the journal's
    file is fsync'd before the rename, and the directory after."""
    synced = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd),
                                                 real(fd))[1])
    it.fleet._write_journal(tmp_path / "journal.json",
                            {"format": "igg-fleet-journal-v1", "jobs": {}})
    assert len(synced) >= 1
    assert json.loads((tmp_path / "journal.json").read_text())["jobs"] == {}
    assert not (tmp_path / "journal.json.tmp").exists()


# ---------------------------------------------------------------------------
# Loop 4 on run_fleet
# ---------------------------------------------------------------------------

def test_lagging_job_repacks_bitwise(tmp_path, monkeypatch):
    """igg's test_lagging_job_repacks_bit_exact (which fails in igg's own
    run on its CPU devices), held to the contract: a job whose measured
    member rate collapses (`throughput_collapse`) is preempted at the next
    dispatch and re-admitted at once on half the slots (the port has no
    batch packing), resuming elastically: one `heal_repack` from 8 slots
    to 4, status done at attempt 2, every lane bitwise the clean drain."""
    from test_torch_fleet import fleet, interiors, job

    monkeypatch.setenv("IGG_ENSEMBLE_MAX_PENDING_PROBES", "1000")
    kw = dict(seed=5, members=4, n_steps=600, watch_every=2,
              checkpoint_every=200)
    t0 = time.perf_counter()
    ref = fleet("port", [job("port", "j", **kw)], tmp_path / "clean")
    # The expectation: the clean drain's member-steps/s, set-up included
    # (a lower bound of its windows' rate).
    expected = 4 * 600 / (time.perf_counter() - t0)
    assert ref.jobs["j"].status == "done"
    want = interiors("port", ref.jobs["j"].dims,
                     ref.jobs["j"].result.state["T"])

    eng = theal.HealEngine(theal.HealPolicy(max_actions=1, cooldown_s=0.0,
                                            sustain=2), run="fleet")
    jb = job("port", "j", expected_member_steps_per_s=expected, **kw)
    # Collapsed windows: 2 steps of 4 lanes a grant, one grant in 0.05 s.
    assert 2 * 4 / 0.05 < 0.5 * expected
    with it.chaos.throughput_collapse("j", delay_s=0.05):
        res = fleet("port", [jb], tmp_path / "healed", heal=eng)
    o = res.jobs["j"]
    assert o.status == "done" and not res.preempted
    repack = next(e for e in o.events if e.kind == "heal_repack")
    assert repack.detail == {"from_packing": "grid", "packing": "grid",
                             "from_devices": 8, "devices": 4,
                             "reason": "throughput_lag", "job": "j"}
    assert o.result.packing == "grid" and o.dims == (2, 2, 1)
    assert [a["action"] for a in eng.actions] == ["repack"]
    assert not resilience.preemption_requested()   # the engine's, consumed
    np.testing.assert_array_equal(
        interiors("port", o.dims, o.result.state["T"]), want)
    j = json.loads((tmp_path / "healed" / "journal.json").read_text())
    assert j["jobs"]["j"]["status"] == "done"
    assert j["jobs"]["j"]["attempts"] == 2
