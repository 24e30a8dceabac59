"""The port's fleet scheduler (igg_torch.fleet) held against igg's on the
CPU.

igg drains its queues on its 8 virtual CPU devices; the port on 8 block
slots of the CPU (`devices=["cpu"] * 8`), the counterpart of that mesh.
Jobs are igg's `tests/test_fleet.py` jobs: global interior (8, 8, 8)
periodic, member states from a seeded global random field (float64 here,
so the lanes compare at the float64 tolerance of
tests/test_torch_diffusion.py), the Laplacian member step of
`helpers.ensemble_member_step` and its port twin.  Every probe is read at
its step in both packages (`IGG_ENSEMBLE_MAX_PENDING_PROBES=0`), so the
event streams do not depend on when a device finishes.

`plan_dims`, `job_config_hash` and the journal are igg's exactly; each of
igg's `tests/test_fleet.py` contracts is a flow run on both packages, the
port's statuses, attempts, dims, events (paths aside) and journal equal
to igg's and its lanes within RTOL of igg's; each package resumes from
the other's journal and ring.  Where igg's own test fails on its CPU
devices (`test_batch_packing_job_plans_single_device_grid`: ROADMAP
"Standing caveat"), the port is held to its documented contract alone.
igg's flows run once, in a module-scoped fixture.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg_torch import fleet as tfleet
from igg_torch.ops.stencil import interior_add
from helpers import ensemble_member_step
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12     # float64 stencil values, as in tests/test_torch_diffusion.py
PKGS = {"igg": igg, "port": it}


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def port_member_step(rate=0.1):
    """The port's twin of `helpers.ensemble_member_step`."""
    def member_step(st):
        T = st["T"]
        lap = (T[:-2, 1:-1, 1:-1] + T[2:, 1:-1, 1:-1]
               + T[1:-1, :-2, 1:-1] + T[1:-1, 2:, 1:-1]
               + T[1:-1, 1:-1, :-2] + T[1:-1, 1:-1, 2:]
               - 6.0 * T[1:-1, 1:-1, 1:-1])
        out = dict(st)
        out["T"] = it.update_halo_local(interior_add(T, rate * lap))
        return out

    return member_step


def make_states(name, seed, members):
    """igg's `_make_states`: member states from a decomposition-invariant
    global random field, wrap-indexed per block, in float64."""
    mod = PKGS[name]
    dtype = np.float64 if name == "igg" else torch.float64

    def build(grid):
        rng = np.random.default_rng(seed)
        g = [grid.dims[d] * (grid.nxyz[d] - grid.overlaps[d])
             for d in range(3)]
        out = []
        for _ in range(members):
            glob = rng.standard_normal(g)

            def block(coords, ls, glob=glob):
                idx = [(coords[d] * (ls[d] - grid.overlaps[d])
                        + np.arange(ls[d])) % g[d] for d in range(3)]
                return glob[np.ix_(*idx)]

            T = mod.from_local_blocks(block, tuple(grid.nxyz), dtype=dtype)
            out.append({"T": mod.update_halo(T)})
        return out
    return build


def job(name, jname, seed=1, members=2, n_steps=10, **kw):
    """igg's `_job` in package `name`."""
    args = dict(name=jname, global_interior=(8, 8, 8), members=members,
                n_steps=n_steps, make_states=make_states(name, seed, members),
                step_fn=(ensemble_member_step() if name == "igg"
                         else port_member_step()),
                watch_every=5, checkpoint_every=5)
    args.update(kw)
    return PKGS[name].Job(**args)


def fleet(name, jobs, workdir, n=8, **kw):
    """`run_fleet` of package `name` on `n` devices (igg) or slots (the
    port)."""
    devs = jax.devices()[:n] if name == "igg" else ["cpu"] * n
    return PKGS[name].run_fleet(jobs, workdir, devices=devs, **kw)


def _plain(v):
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def summary(events):
    """(kind, step, detail but paths) of every event, in order."""
    return [(e.kind, e.step,
             _plain({k: v for k, v in e.detail.items() if k != "path"}))
            for e in events]


def journal(workdir):
    j = json.loads((workdir / "journal.json").read_text())
    for rec in j["jobs"].values():
        rec.pop("updated_at", None)
    return j


def lanes(res):
    """A finished job's stacked T as numpy (None where it did not run)."""
    if res is None:
        return None
    T = res.state["T"]
    return T.numpy() if isinstance(T, torch.Tensor) else np.asarray(T)


def interiors(name, dims, state_T):
    """Every lane's gathered interior, on a grid of `dims` rebuilt for the
    gather (periodic (8, 8, 8) interior, overlap 2)."""
    mod = PKGS[name]
    local = [8 // d + 2 for d in dims]
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=1,
              periody=1, periodz=1, quiet=True)
    if name == "igg":
        kw["devices"] = jax.devices()[:int(np.prod(dims))]
    else:
        kw["device"] = "cpu"
    mod.init_global_grid(*local, **kw)
    try:
        return np.stack([np.asarray(mod.gather_interior(state_T[m]))
                         for m in range(state_T.shape[0])])
    finally:
        mod.finalize_global_grid()


def outcome(res, workdir):
    return dict(preempted=res.preempted, journal=journal(workdir),
                jobs={n: dict(status=o.status, attempts=o.attempts,
                              dims=o.dims, events=summary(o.events),
                              ran=o.result is not None, T=lanes(o.result),
                              steps=(o.result.steps_done if o.result
                                     else None))
                      for n, o in res.jobs.items()})


# ---------------------------------------------------------------------------
# The flows: one per contract of igg's tests/test_fleet.py, run on both
# packages.
# ---------------------------------------------------------------------------

def flow_drain(name, tmp):
    res = fleet(name, [job(name, "a"), job(name, "b", seed=2, members=4)],
                tmp)
    return dict(run=outcome(res, tmp),
                initialized=PKGS[name].grid_is_initialized())


def flow_member_fault(name, tmp):
    mod = PKGS[name]
    jobs = [job(name, "a", chaos=mod.chaos.ChaosPlan(nan_at=[(3, 1, "T")])),
            job(name, "b", seed=2)]
    return dict(run=outcome(fleet(name, jobs, tmp), tmp))


def flow_resume_skips_done(name, tmp):
    jobs = [job(name, "a")]
    first = outcome(fleet(name, jobs, tmp), tmp)
    return dict(run=first, again=outcome(fleet(name, jobs, tmp, resume=True),
                                         tmp))


def flow_retry_backoff(name, tmp):
    with PKGS[name].chaos.scheduler_fault("a", times=2):
        res = fleet(name, [job(name, "a")], tmp, backoff=0.01)
    return dict(run=outcome(res, tmp))


def flow_exhaustion(name, tmp):
    with PKGS[name].chaos.scheduler_fault("a", times=10):
        res = fleet(name, [job(name, "a"), job(name, "b", seed=2)], tmp,
                    backoff=0.01, max_job_retries=2)
    return dict(run=outcome(res, tmp))


def flow_preempt_resume(name, tmp):
    jobs = [job(name, "a"), job(name, "b", seed=2)]
    with PKGS[name].chaos.job_preempt_at("a", 5):
        res = fleet(name, jobs, tmp)
    run = outcome(res, tmp)
    again = fleet(name, jobs, tmp, n=4, resume=True)
    clean = fleet(name, [job(name, "a")], tmp / "clean")
    return dict(run=run, again=outcome(again, tmp),
                resumed=interiors(name, again.jobs["a"].dims,
                                  again.jobs["a"].result.state["T"]),
                clean=interiors(name, clean.jobs["a"].dims,
                                clean.jobs["a"].result.state["T"]))


def flow_terminal(name, tmp):
    mod = PKGS[name]
    doomed = job(name, "a", chaos=mod.chaos.ChaosPlan(
        nan_at=[(3, 0, "T"), (3, 1, "T")]))
    doomed.ring = 0                            # an invalid config
    res = fleet(name, [doomed, job(name, "b", seed=2)], tmp, backoff=0.01,
                max_job_retries=5)
    return dict(run=outcome(res, tmp))


def flow_reused_name(name, tmp):
    fleet(name, [job(name, "a", n_steps=10)], tmp)
    events = []
    res = fleet(name, [job(name, "a", n_steps=20)], tmp, resume=True,
                on_event=events.append)
    return dict(run=outcome(res, tmp), events=summary(events))


def flow_same_config(name, tmp):
    fleet(name, [job(name, "a")], tmp)
    events = []
    res = fleet(name, [job(name, "a")], tmp, resume=True,
                on_event=events.append)
    return dict(run=outcome(res, tmp), events=summary(events))


FLOWS = {"drain": flow_drain, "member_fault": flow_member_fault,
         "resume_skips_done": flow_resume_skips_done,
         "retry_backoff": flow_retry_backoff, "exhaustion": flow_exhaustion,
         "preempt_resume": flow_preempt_resume, "terminal": flow_terminal,
         "reused_name": flow_reused_name, "same_config": flow_same_config}


def _contract(name, out):
    """igg's assertions of each flow (tests/test_fleet.py)."""
    run = out["run"]
    jobs = run["jobs"]
    if name == "drain":
        assert not run["preempted"]
        assert all(o["status"] == "done" for o in jobs.values())
        assert tuple(jobs["a"]["dims"]) == (2, 2, 2)
        assert run["journal"]["format"] == "igg-fleet-journal-v1"
        assert {n: r["status"] for n, r in run["journal"]["jobs"].items()} \
            == {"a": "done", "b": "done"}
        assert run["journal"]["jobs"]["b"]["steps_done"] == 10
        assert all(e[2]["job"] == "a" for e in jobs["a"]["events"])
        assert not out["initialized"]
    elif name == "member_fault":
        assert all(o["status"] == "done" for o in jobs.values())
        assert any(e[0] == "member_rollback" for e in jobs["a"]["events"])
    elif name == "resume_skips_done":
        again = out["again"]["jobs"]["a"]
        assert again["status"] == "done" and not again["ran"]
        assert out["again"]["journal"]["jobs"]["a"]["attempts"] == 1
    elif name == "retry_backoff":
        o = jobs["a"]
        assert o["status"] == "done" and o["attempts"] == 3
        fails = [e for e in o["events"] if e[0] == "job_failed"]
        assert len(fails) == 2
        assert "InjectedSchedulerFault" in fails[0][2]["error"]
    elif name == "exhaustion":
        assert jobs["a"]["status"] == "failed" and jobs["a"]["attempts"] == 3
        assert any(e[0] == "job_gave_up" for e in jobs["a"]["events"])
        assert jobs["b"]["status"] == "done"
        assert run["journal"]["jobs"]["a"]["status"] == "failed"
    elif name == "preempt_resume":
        assert run["preempted"] and jobs["a"]["status"] == "preempted"
        assert jobs["a"]["steps"] == 5 and jobs["b"]["status"] == "queued"
        assert run["journal"]["jobs"]["a"]["status"] == "preempted"
        again = out["again"]["jobs"]
        assert all(o["status"] == "done" for o in again.values())
        assert any(e[0] == "job_resumed" for e in again["a"]["events"])
        assert tuple(again["a"]["dims"]) != (2, 2, 2)
    elif name == "terminal":
        assert jobs["a"]["status"] == "failed" and jobs["a"]["attempts"] == 1
        gave = next(e for e in jobs["a"]["events"] if e[0] == "job_gave_up")
        assert gave[2]["terminal"] is True
        assert jobs["b"]["status"] == "done"
    elif name == "reused_name":
        assert jobs["a"]["status"] == "done" and jobs["a"]["steps"] == 20
        reused = [e for e in out["events"] if e[0] == "job_name_reused"]
        assert len(reused) == 1 and reused[0][2]["prior_status"] == "done"
        assert reused[0][2]["prior_config_hash"] != \
            reused[0][2]["config_hash"]
        rec = run["journal"]["jobs"]["a"]
        assert rec["steps_done"] == 20
        assert rec["config_hash"] == reused[0][2]["config_hash"]
    elif name == "same_config":
        assert jobs["a"]["status"] == "done" and not jobs["a"]["ran"]
        assert not any(e[0] == "job_name_reused" for e in out["events"])


def _cross_resume(tmp):
    """Each package preempts job 'a' at step 5 on 8 devices (slots); the
    other resumes the queue from that journal and ring on 4."""
    out = {}
    for writer, reader in (("igg", "port"), ("port", "igg")):
        d = tmp / f"{writer}_to_{reader}"
        with PKGS[writer].chaos.job_preempt_at("a", 5):
            fleet(writer, [job(writer, "a")], d)
        res = fleet(reader, [job(reader, "a")], d, n=4, resume=True)
        o = res.jobs["a"]
        out[f"{writer}_to_{reader}"] = dict(
            status=o.status, kinds=[e.kind for e in o.events],
            dims=o.dims, T=interiors(reader, o.dims, o.result.state["T"]))
    return out


@pytest.fixture(scope="module")
def igg_fleets(tmp_path_factory):
    """igg's outcome of every flow, its plan records, and the journals
    each package resumed from the other's."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGG_ENSEMBLE_MAX_PENDING_PROBES", "0")
        try:
            for name, flow in FLOWS.items():
                out[name] = flow("igg", tmp_path_factory.mktemp(name))
            out["cross"] = _cross_resume(tmp_path_factory.mktemp("cross"))
        finally:
            if igg.grid_is_initialized():
                igg.finalize_global_grid()
    return out


@pytest.mark.parametrize("name", list(FLOWS))
def test_flow_matches_igg_and_keeps_the_contract(igg_fleets, tmp_path,
                                                 monkeypatch, name):
    monkeypatch.setenv("IGG_ENSEMBLE_MAX_PENDING_PROBES", "0")
    port = FLOWS[name]("port", tmp_path)
    ref = igg_fleets[name]
    _contract(name, ref)
    _contract(name, port)
    for key in ("run", "again"):
        if key not in port:
            continue
        assert port[key]["preempted"] == ref[key]["preempted"]
        assert port[key]["journal"] == ref[key]["journal"]
        for jname, o in port[key]["jobs"].items():
            r = ref[key]["jobs"][jname]
            for field in ("status", "attempts", "dims", "events", "ran",
                          "steps"):
                assert o[field] == r[field], (key, jname, field)
            if o["T"] is not None:
                np.testing.assert_allclose(o["T"], r["T"], rtol=RTOL,
                                           atol=RTOL)
    if "events" in port:
        assert port["events"] == ref["events"]
    if name == "preempt_resume":
        # Bitwise within the port: the elastic resume on 4 slots ends as
        # the uninterrupted 8-slot run; within RTOL of igg's.
        np.testing.assert_array_equal(port["resumed"], port["clean"])
        np.testing.assert_allclose(port["resumed"], ref["resumed"],
                                   rtol=RTOL, atol=RTOL)


def test_each_package_resumes_from_the_others_journal(igg_fleets,
                                                      tmp_path, monkeypatch):
    """A queue preempted by igg resumes in the port and the other way
    round: the reader re-plans onto 4 devices (slots), emits
    `job_resumed`, and the cross resumes end within RTOL of each
    other."""
    monkeypatch.setenv("IGG_ENSEMBLE_MAX_PENDING_PROBES", "0")
    ref = igg_fleets["cross"]         # igg's writes and reads
    port = _cross_resume(tmp_path)
    for key in ("igg_to_port", "port_to_igg"):
        for out in (ref[key], port[key]):
            assert out["status"] == "done"
            assert "job_resumed" in out["kinds"]
            assert tuple(out["dims"]) == (2, 2, 1)
    np.testing.assert_allclose(port["igg_to_port"]["T"],
                               ref["igg_to_port"]["T"], rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(ref["port_to_igg"]["T"],
                               port["igg_to_port"]["T"], rtol=RTOL,
                               atol=RTOL)


# ---------------------------------------------------------------------------
# Planning and the journal's identity
# ---------------------------------------------------------------------------

# igg's test_plan_dims_balanced_and_divisible inputs first, then the
# shapes the fleet and heal plan on the card and odd ones.
PLAN_CASES = [
    ((8, 8, 8), (1, 1, 1), (2, 2, 2)),
    ((10, 10, 10), (0, 0, 0), (2, 2, 2)),
    ((7, 7, 7), (1, 1, 1), (2, 2, 2)),
    ((1, 8, 8), (0, 0, 0), (2, 2, 2)),
    ((254, 254, 254), (1, 1, 1), (2, 2, 2)),
    ((254, 254, 254), (0, 0, 0), (2, 2, 2)),
    ((510, 510, 510), (0, 0, 0), (2, 2, 2)),
    ((16, 12, 20), (1, 0, 1), (2, 2, 2)),
    ((24, 24, 8), (0, 1, 0), (2, 2, 2)),
    ((12, 12, 12), (1, 1, 1), (3, 3, 3)),
    ((15, 9, 21), (0, 0, 0), (3, 3, 3)),
    ((8, 1, 1), (0, 0, 0), (2, 2, 2)),
    ((36, 1, 8), (1, 0, 1), (2, 2, 2)),
    ((60, 60, 60), (1, 1, 1), (4, 4, 4)),
]


def _planned(mod, interior, n, periods, overlaps):
    """(dims, local) or the GridError text, and the `dims_planned`
    payloads the call emitted."""
    recs = []

    def take(rec):
        if rec.kind == "dims_planned":
            recs.append(_plain(dict(rec.payload)))

    mod.telemetry.subscribe(take)
    try:
        try:
            got = mod.fleet.plan_dims(interior, n, periods=periods,
                                      overlaps=overlaps)
            got = (tuple(got[0]), tuple(got[1]))
        except mod.GridError as e:
            got = str(e)
    finally:
        mod.telemetry.unsubscribe(take)
    return got, recs


@pytest.mark.parametrize("interior,periods,overlaps", PLAN_CASES)
def test_plan_dims_equals_iggs(interior, periods, overlaps):
    """Every slot count 1-8: the same (dims, local) or the same refusal,
    and the same `dims_planned` record (hop_cost "uniform": igg's on
    devices without physical coordinates, the port's always)."""
    for n in range(1, 9):
        want = _planned(igg, interior, n, periods, overlaps)
        got = _planned(it, interior, n, periods, overlaps)
        assert got == want, n
        if isinstance(got[0], tuple):
            assert got[1][0]["hop_cost"] == "uniform"


def test_plan_dims_contract():
    """igg's test_plan_dims_balanced_and_divisible on the port."""
    plan = tfleet.plan_dims
    assert plan((8, 8, 8), 8) == ((2, 2, 2), (6, 6, 6))
    dims, local = plan((8, 8, 8), 4)
    assert np.prod(dims) == 4 and all(d * (n - 2) == 8
                                      for d, n in zip(dims, local))
    assert plan((8, 8, 8), 1) == ((1, 1, 1), (10, 10, 10))
    dims, local = plan((10, 10, 10), 8, periods=(0, 0, 0))
    assert all(d * (n - 2) + 2 == 10 for d, n in zip(dims, local))
    assert np.prod(plan((7, 7, 7), 8)[0]) == 7
    with pytest.raises(it.GridError, match="no decomposition"):
        plan((1, 8, 8), 8, periods=(0, 0, 0))
    # The card's plans of the fleet and heal paths.
    assert plan((254, 254, 254), 4, periods=(0, 0, 0)) == \
        ((2, 2, 1), (128, 128, 254))
    assert plan((254, 254, 254), 7, periods=(0, 0, 0)) == \
        ((7, 1, 1), (38, 254, 254))
    assert plan((510, 510, 510), 8, periods=(0, 0, 0)) == \
        ((2, 2, 2), (256, 256, 256))


@pytest.mark.parametrize("fields", [
    dict(global_interior=(8, 8, 8), members=2, n_steps=10),
    dict(global_interior=(510, 510, 510), members=2, n_steps=34),
    dict(global_interior=(254, 254, 254), members=8, n_steps=200,
         tenant="lab-7"),
    dict(global_interior=(np.int64(16), 12, 20), members=np.int32(3),
         n_steps=1)])
def test_job_config_hash_equals_iggs(fields):
    mk = dict(name="x", make_states=lambda g: [], step_fn=lambda s: s)
    assert tfleet.job_config_hash(it.Job(**fields, **mk)) == \
        igg.fleet.job_config_hash(igg.Job(**fields, **mk))


def test_journal_records_and_reads_as_iggs(tmp_path):
    """`_journal_record` fills an older record's missing keys as igg's
    does, and a torn or foreign journal reads as an empty queue in both."""
    old = {"status": "preempted", "attempts": 2, "steps_done": 5}
    mk = dict(name="a", global_interior=(8, 8, 8), members=2, n_steps=10,
              make_states=lambda g: [], step_fn=lambda s: s,
              tenant="t", priority=3, submitted_at=12.5)
    recs = []
    for mod in (igg, it):
        j = {"format": "igg-fleet-journal-v1", "jobs": {"a": dict(old)}}
        recs.append(mod.fleet._journal_record(j, mod.Job(**mk)))
    assert recs[0] == recs[1]
    for text in ("{not json", json.dumps({"format": "v0", "jobs": {}}),
                 json.dumps({"format": "igg-fleet-journal-v1",
                             "jobs": []})):
        p = tmp_path / "journal.json"
        p.write_text(text)
        assert tfleet._read_journal(p) == igg.fleet._read_journal(p) == {
            "format": "igg-fleet-journal-v1", "jobs": {}}


# ---------------------------------------------------------------------------
# The port's contracts
# ---------------------------------------------------------------------------

def test_batch_packing_job_fails_terminally_on_one_device(tmp_path):
    """igg's test_batch_packing_job_plans_single_device_grid (which fails
    in igg's own run on its CPU devices): a job with packing='batch' is
    planned onto the one-block grid, and on the port's one device batch
    packing never applies, so run_ensemble's GridError is terminal:
    status 'failed' at attempt 1, `job_gave_up(terminal=True)`, and the
    queue drains on."""
    res = fleet("port", [job("port", "a", members=8, packing="batch"),
                         job("port", "b", seed=2)], tmp_path,
                max_job_retries=5)
    a = res.jobs["a"]
    assert a.status == "failed" and a.attempts == 1
    assert "packing='batch'" in a.error
    started = next(e for e in a.events if e.kind == "job_started")
    assert started.detail["dims"] == [1, 1, 1]
    assert started.detail["packing"] == "batch"
    gave = next(e for e in a.events if e.kind == "job_gave_up")
    assert gave.detail["terminal"] is True
    assert res.jobs["b"].status == "done"
    assert journal(tmp_path)["jobs"]["a"]["status"] == "failed"


def test_repack_choice_halves_the_slot_pool():
    """igg's test_repack_choice_flips_and_falls_back: igg flips grid <->
    batch where batch is admissible; the port has one device, so every
    re-admission keeps its packing on half the slots."""
    mk = dict(global_interior=(8, 8, 8), n_steps=1,
              make_states=lambda g: [], step_fn=lambda s: s)
    devs = ["cpu"] * 8
    for members in (8, 3):
        j = it.Job(name="x", members=members, **mk)
        assert tfleet._repack_choice(j, "grid", devs) == ("grid", devs[:4])
    assert tfleet._repack_choice(j, "grid", devs[:1]) == ("grid", devs[:1])


def test_devices_are_slots_of_one_device(tmp_path, monkeypatch):
    """`devices=None` is one slot on the card, which raises without one; a
    list naming two devices raises; a `serve=` that is no port or server
    raises igg's coercion; a live grid and duplicate names are refused as
    igg refuses them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(it.GridError, match="torch.cuda.is_available"):
        it.run_fleet([job("port", "a")], tmp_path)
    with pytest.raises(it.GridError, match="more than one device"):
        it.run_fleet([job("port", "a")], tmp_path, devices=["cpu", "meta"])
    for serve in ("bogus", 1.5):
        with pytest.raises(it.GridError, match="serve=.*expected None"):
            fleet("port", [job("port", "a")], tmp_path, serve=serve)
    it.init_global_grid(6, 6, 6, device="cpu", quiet=True)
    with pytest.raises(it.GridError, match="finalize"):
        fleet("port", [job("port", "a")], tmp_path)
    it.finalize_global_grid()
    with pytest.raises(it.GridError, match="duplicate"):
        fleet("port", [job("port", "a"), job("port", "a")], tmp_path)
    assert not os.path.exists(tmp_path / "journal.json")


def test_telemetry_of_a_drain(tmp_path):
    """One session for the whole drain: the scheduler's kinds on the bus
    with run="fleet" once each, the `fleet.job` spans, the queue gauge and
    the per-status counters."""
    from igg_torch import telemetry

    telemetry.reset_metrics()
    with it.chaos.scheduler_fault("b", times=9):
        res = fleet("port", [job("port", "a"), job("port", "b", seed=2)],
                    tmp_path / "w", telemetry=tmp_path / "tel",
                    backoff=0.01, max_job_retries=1)
    assert [o.status for o in res.jobs.values()] == ["done", "failed"]
    recs = [json.loads(line) for line in
            (tmp_path / "tel" / "events_r0.jsonl").read_text().splitlines()]
    fleet_kinds = [r["kind"] for r in recs
                   if r["payload"].get("run") == "fleet"]
    assert fleet_kinds == ["run_started", "job_started", "job_done",
                           "job_failed", "job_failed", "job_gave_up",
                           "run_finished"]
    samples = telemetry.metric_samples()
    counts = {v["labels"]["status"]: v["value"] for v in samples
              if v["name"] == "igg_fleet_jobs_total"}
    assert counts == {"done": 1.0, "failed": 1.0}
    depth = [v["value"] for v in samples
             if v["name"] == "igg_fleet_queue_depth"]
    assert depth == [0.0]
    trace = json.loads((tmp_path / "tel" / "trace_r0.json").read_text())
    spans = [e for e in trace["traceEvents"] if e.get("name") == "fleet.job"]
    assert len(spans) == 2


def test_preemption_during_backoff_requeues(tmp_path):
    """A preemption landing in a launcher fault's backoff hands the job
    back to the queue ('queued', `job_requeued`) and stops the drain; the
    owner-only clear leaves the flag to a supervisor that wired SIGTERM
    itself (`install_sigterm=False`)."""
    from igg_torch import resilience

    class FaultThenPreempt:
        def __init__(self):
            self.calls = 0

        def __call__(self, grid):
            resilience.request_preemption()
            raise RuntimeError("driver OOM while building states")

    j = job("port", "a", make_states=FaultThenPreempt())
    try:
        res = fleet("port", [j, job("port", "b", seed=2)], tmp_path,
                    backoff=0.01, install_sigterm=False)
        assert res.preempted
        assert res.jobs["a"].status == "queued"
        assert [e.kind for e in res.jobs["a"].events] == [
            "job_failed", "job_requeued"]
        assert res.jobs["b"].status == "queued"
        assert resilience.preemption_requested()     # the owner's to clear
        assert journal(tmp_path)["jobs"]["a"]["status"] == "queued"
    finally:
        resilience.clear_preemption()


def test_n_devices_caps_a_jobs_slots(tmp_path):
    """One drain over 8 slots: a job with `n_devices=1` runs on one block,
    one with `n_devices=4` on 4, one without on all 8; each lane bitwise
    the same job drained alone on as many slots."""
    jobs = [job("port", "one", n_devices=1), job("port", "four", n_devices=4),
            job("port", "all")]
    res = fleet("port", jobs, tmp_path / "mixed")
    assert [res.jobs[n].dims for n in ("one", "four", "all")] == [
        (1, 1, 1), (2, 2, 1), (2, 2, 2)]
    for name, n in (("one", 1), ("four", 4), ("all", 8)):
        alone = fleet("port", [job("port", name)], tmp_path / name, n=n)
        np.testing.assert_array_equal(lanes(res.jobs[name].result),
                                      lanes(alone.jobs[name].result))
