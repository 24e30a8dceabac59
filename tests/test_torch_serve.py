"""The port's service (igg_torch.serve), its thread-scoped grids
(igg_torch.shared.thread_grid_scope) and the intake chaos held against
igg's on the CPU.

The service's "devices" are block slots of one device (`devices=["cpu"] *
8`, the counterpart of igg's 8-device CPU mesh).  Jobs are igg's
`tests/test_serve.py` jobs: global interior (8, 8, 8) periodic, member
states from a seeded decomposition-invariant float64 field, the Laplacian
member step.  A job that must be caught mid-run (to be preempted, fenced
or drained while its neighbour runs) holds at a gate inside its member
step until the test has acted, so no test depends on timing.

The admission verdicts (codes, statuses, reasons, events, journal records
and per-tenant accounting) equal igg's for the same specs.  Every job the
service ran concurrently, preempted, fenced or drained and resumed ends
bitwise its solo `run_ensemble`, or the uninterrupted run's gathered
interior where it resumed on another decomposition.  Each package resumes
the other's drained journal and ring.  igg's runs sit in a module-scoped
fixture.
"""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg import serve as iserve
from igg_torch import serve, shared
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as t3
from igg_torch.ops.stencil import interior_add
from helpers import ensemble_member_step
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12     # float64 stencil values, as in tests/test_torch_fleet.py
PKGS = {"igg": igg, "port": it}
SLOTS = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _clean():
    for t in (tel, igg.telemetry):
        t.reset_metrics()
        t._ring().clear()
    GATES.clear()
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    for gate in GATES.values():
        gate["release"].set()
    if it.grid_is_initialized():
        it.finalize_global_grid()
    # The runs' ladder records and perf samples stay in this module.
    it.degrade.reset()
    it.perf.reset()
    assert serve._CHAOS_SUBMIT_TAP is None


# ---------------------------------------------------------------------------
# Jobs, gates and the service on a thread
# ---------------------------------------------------------------------------

# {job name: {"at": call, "reached": Event, "release": Event}}: the job's
# member step holds at its `at`-th call until `release` is set.
GATES = {}


def gate(name, at):
    GATES[name] = {"at": at, "reached": threading.Event(),
                   "release": threading.Event()}
    return GATES[name]


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


def gated(step, name):
    calls = [0]

    def member_step(st):
        calls[0] += 1
        g = GATES.get(name)
        if g is not None and calls[0] == g["at"]:
            g["reached"].set()
            assert g["release"].wait(60), f"gate of {name} never released"
        return step(st)

    return member_step


def make_states(pkg, seed, members):
    mod = PKGS[pkg]
    dtype = np.float64 if pkg == "igg" else torch.float64

    def build(grid):
        rng = np.random.default_rng(seed)
        gsz = [grid.dims[d] * (grid.nxyz[d] - grid.overlaps[d])
               for d in range(3)]
        out = []
        for _ in range(members):
            glob = rng.standard_normal(gsz)

            def block(coords, ls, glob=glob):
                idx = [(coords[d] * (ls[d] - grid.overlaps[d])
                        + np.arange(ls[d])) % gsz[d] for d in range(3)]
                return glob[np.ix_(*idx)]

            T = mod.from_local_blocks(block, tuple(grid.nxyz), dtype=dtype)
            out.append({"T": mod.update_halo(T)})
        return out
    return build


def factory_of(pkg):
    """igg's `_factory` in package `pkg`; a spec's "gate" names the gate
    its member step holds at, its "states_gate" an Event its states' build
    waits for (igg's member step is traced, so igg's jobs hold there)."""
    mod = PKGS[pkg]

    def factory(spec):
        members = spec.get("members", 1)
        step = (ensemble_member_step() if pkg == "igg"
                else port_member_step())
        build = make_states(pkg, spec.get("seed", 1), members)
        if spec.get("gate"):
            step = gated(step, spec["gate"])
        if spec.get("states_gate"):
            inner = build

            def build(grid, inner=inner, name=spec["states_gate"]):
                g = GATES[name]
                g["reached"].set()
                assert g["release"].wait(60)
                return inner(grid)
        job = mod.Job(name=spec["name"], global_interior=(8, 8, 8),
                      members=members, n_steps=spec["n_steps"],
                      make_states=build, step_fn=step, watch_every=5,
                      checkpoint_every=spec.get("checkpoint_every", 5))
        if spec.get("doom"):
            job.ring = 0          # an invalid config: a terminal GridError
        return job
    return factory


def spec(name, n_steps=8, **kw):
    out = {"name": name, "global_interior": [8, 8, 8], "members": 2,
           "n_steps": n_steps}
    out.update(kw)
    return out


def wait(pred, timeout=60, poll=0.01):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(poll)
    return False


class Serve:
    """`serve_fleet` of package `pkg` on a background thread, driven
    through its ServeControl."""

    def __init__(self, workdir, pkg="port", **kw):
        mod = PKGS[pkg]
        self.ctl = mod.ServeControl()
        self.events = []
        self.error = None
        self.result = None
        kw.setdefault("stop_when_idle_s", 1.5)
        kw.setdefault("poll_s", 0.01)
        kw.setdefault("install_sigterm", False)
        kw.setdefault("backoff", 0.01)
        kw.setdefault("devices", SLOTS if pkg == "port"
                      else jax.devices())
        factory = kw.pop("factory", None) or factory_of(pkg)

        def run():
            try:
                self.result = mod.serve_fleet(
                    workdir, factory, control=self.ctl,
                    on_event=self.events.append, **kw)
            except BaseException as e:
                self.error = e

        self.thread = threading.Thread(target=run)

    def __enter__(self):
        self.thread.start()
        assert self.ctl.wait_ready(30)
        return self

    def __exit__(self, *exc):
        for g in GATES.values():
            if exc[0] is not None:
                g["release"].set()
        self.thread.join(timeout=120)
        assert not self.thread.is_alive(), "serve loop did not exit"
        if self.error is not None and not exc[0]:
            raise self.error

    def kinds(self, kind):
        return [e for e in list(self.events) if e.kind == kind]

    def running(self):
        return self.ctl.stats()["running"]


def interiors(pkg, dims, T):
    """Every lane's gathered interior (M, 8, 8, 8) on a grid of `dims`."""
    mod = PKGS[pkg]
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=1,
              periody=1, periodz=1, quiet=True)
    if pkg == "igg":
        kw["devices"] = jax.devices()[:int(np.prod(dims))]
    else:
        kw["device"] = "cpu"
    mod.init_global_grid(*[8 // d + 2 for d in dims], **kw)
    try:
        return np.stack([np.asarray(mod.gather_interior(T[m]))
                         for m in range(T.shape[0])])
    finally:
        mod.finalize_global_grid()


def outcome_interiors(pkg, o):
    return interiors(pkg, o.dims, o.result.state["T"])


def clean(seed, n_steps, members=2):
    """The uninterrupted port run's interiors: run_ensemble on 2x2x2."""
    it.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1,
                        periody=1, periodz=1, device="cpu", quiet=True)
    res = it.run_ensemble(port_member_step(),
                          make_states("port", seed, members)(
                              it.global_grid()),
                          n_steps, watch_every=5, install_sigterm=False)
    it.finalize_global_grid()
    return interiors("port", (2, 2, 2), res.state["T"])


def solo(o, seed, n_steps, members=2):
    """A job's solo run_ensemble on the dims it ran, stacked lanes."""
    dims = o.dims
    it.init_global_grid(*[8 // d + 2 for d in dims], dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=1, periody=1,
                        periodz=1, device="cpu", quiet=True)
    try:
        res = it.run_ensemble(port_member_step(),
                              make_states("port", seed, members)(
                                  it.global_grid()),
                              n_steps, watch_every=5, install_sigterm=False)
        return res.state["T"]
    finally:
        it.finalize_global_grid()


# ---------------------------------------------------------------------------
# Thread-scoped grids
# ---------------------------------------------------------------------------

def _init(nx=6, **kw):
    args = dict(periodx=1, periody=1, periodz=1, device="cpu", quiet=True)
    args.update(kw)
    it.init_global_grid(nx, nx, nx, **args)


def test_thread_grid_scope_isolates_from_process_global():
    assert not it.grid_is_initialized()
    _init(8)
    outer = shared.grid_epoch()
    seen = {}

    def body():
        seen["outer_visible"] = it.grid_is_initialized()
        with shared.thread_grid_scope():
            seen["fresh"] = it.grid_is_initialized()
            with pytest.raises(it.GridError, match="before init_global"):
                it.check_initialized()
            _init(6, dimx=2, dimy=1, dimz=1)
            seen["inside"] = it.get_global_grid().nxyz
            seen["epoch"] = shared.grid_epoch()
            it.finalize_global_grid()
            seen["finalized"] = it.grid_is_initialized()
        seen["after"] = it.global_grid().nxyz

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=60)
    assert seen == {"outer_visible": True, "fresh": False,
                    "inside": (6, 6, 6), "epoch": seen["epoch"],
                    "finalized": False, "after": (8, 8, 8)}
    # One counter for every handle: the scope's epoch is not the
    # process-wide one, and the process-wide handle never moved.
    assert seen["epoch"] != outer and shared.grid_epoch() == outer
    assert it.global_grid().nxyz == (8, 8, 8)
    it.finalize_global_grid()


def test_concurrent_scopes_have_distinct_epochs():
    barrier = threading.Barrier(3)
    epochs, errors = [], []

    def body(n):
        try:
            with shared.thread_grid_scope():
                _init(n)
                barrier.wait(10)          # all three grids alive at once
                epochs.append(shared.grid_epoch())
                assert it.global_grid().nxyz == (n, n, n)
                barrier.wait(10)
                it.finalize_global_grid()
        except BaseException as e:       # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(n,)) for n in (6, 7, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(set(epochs)) == 3
    assert not it.grid_is_initialized()


def test_unscoped_handle_keeps_its_epoch_sequence():
    """Outside a scope the handle and its epoch behave as before: each
    init and finalize moves the epoch by one when no scope draws."""
    _init(6)
    it.finalize_global_grid()
    e0 = shared.grid_epoch()
    _init(6)
    e1 = shared.grid_epoch()
    it.finalize_global_grid()
    e2 = shared.grid_epoch()
    assert (e1 - e0, e2 - e1) == (1, 1)
    assert shared.scope_of_caller() is None


def test_shared_counters_lose_no_update_under_threads():
    """The launch counters and the epoch counter are process-wide and the
    service's workers bump them side by side: with the interpreter
    switching threads every microsecond, no count is lost and no epoch is
    handed out twice."""
    import sys

    from igg_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    epochs = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _build.count_launch(wrapper)
            epochs.extend(shared._next_epoch() for _ in range(200))

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000
    assert len(epochs) == len(set(epochs)) == 16 * 200


def test_helper_threads_run_in_the_callers_scope():
    """`sharded`'s block threads and the background writer's worker read
    the scoped grid of the thread that started them."""
    out = {}

    def body():
        with shared.thread_grid_scope():
            _init(6, dimx=2, dimy=2, dimz=2)
            rng = np.random.default_rng(0)
            T = it.from_local_blocks(lambda c, ls: rng.standard_normal(ls),
                                     (6, 6, 6), dtype=torch.float64)
            out["sharded"] = it.sharded(
                lambda A: it.update_halo_local(A * 1.0))(T)
            out["plain"] = it.update_halo(T.clone())
            seen = []
            with it.vis.BackgroundRenderer(
                    lambda b: seen.append(it.global_grid().dims)) as r:
                r.submit({"T": T})
            out["writer"] = seen
            it.finalize_global_grid()

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=60)
    assert torch.equal(out["sharded"], out["plain"])
    assert out["writer"] == [(2, 2, 2)]
    assert not it.grid_is_initialized()


def test_neighbours_finalize_leaves_a_running_job_bitwise():
    """A job holds mid-run (diffusion's member step through the tier
    ladder, 8 blocks) while a neighbour thread initializes and finalizes
    grids of its own; finalize resets the ladder process-wide (igg's
    behaviour), the job's bits do not move."""
    p = t3.Params()
    result, errors = {}, []
    g = gate("job", 9)

    def lanes():
        T, Cp = t3.init_fields(p, dtype=torch.float64)
        T = it.update_halo(T)
        return [{"T": T, "Cp": Cp,
                 "dt_scale": torch.tensor(s, dtype=torch.float64)}
                for s in (0.5, 1.0)]

    def job():
        try:
            with shared.thread_grid_scope():
                _init(8, dimx=2, dimy=2, dimz=2)
                step = gated(t3.make_member_step(p), "job")
                result["T"] = it.run_ensemble(
                    step, lanes(), 10, watch_every=5,
                    install_sigterm=False).state["T"]
                it.finalize_global_grid()
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=job)
    t.start()
    assert g["reached"].wait(60)
    tiers_before = it.degrade.active()
    for n in (6, 7):
        def neighbour(n=n):
            with shared.thread_grid_scope():
                _init(n)
                it.update_halo(it.zeros((n, n, n)))
                it.finalize_global_grid()
        nb = threading.Thread(target=neighbour)
        nb.start()
        nb.join(timeout=60)
    assert it.degrade.active() == {}          # the ladder was reset
    g["release"].set()
    t.join(timeout=60)
    assert not errors, errors
    assert tiers_before.get("diffusion3d") is not None
    _init(8, dimx=2, dimy=2, dimz=2)
    want = it.run_ensemble(t3.make_member_step(p), lanes(), 10,
                           watch_every=5, install_sigterm=False).state["T"]
    it.finalize_global_grid()
    assert torch.equal(result["T"], want)


# ---------------------------------------------------------------------------
# Admission: the verdict table against igg's
# ---------------------------------------------------------------------------

def admission_script(pkg, tmp):
    mod = iserve if pkg == "igg" else serve
    tmp.mkdir()
    events = []
    cfg = dict(max_concurrent=2, queue_bound=3, tenant_queue_bound=2,
               tenant_retry_budget=4, poll_s=0.01, max_body=200)
    devs = (jax.devices() if pkg == "igg"
            else it.fleet._slots(SLOTS))
    st = mod._ServeState(tmp, factory_of(pkg), devs, cfg, None,
                         events.append, None)
    out = []

    def sub(raw):
        r = st.submit(raw)
        out.append((r.code, r.status, r.reason, r.job, r.tenant, r.doc()))
        return r

    sub(b"{not json")
    sub(b"x" * 500)
    sub(b"[1, 2]")
    sub(12)
    sub({"name": "bad name!", "n_steps": 1})
    sub({"name": "a", "global_interior": [8, 8, 8]})
    sub({"name": "a", "global_interior": [8, 8, 10 ** 7], "n_steps": 1})
    sub({"name": "a", "global_interior": [8, 8], "n_steps": 1})
    sub({"name": "a", "global_interior": [8, 8, 8], "n_steps": True})
    sub({"name": "a", "global_interior": [8, 8, 8], "n_steps": 1,
         "members": 5000})
    sub({"name": "a", "global_interior": [8, 8, 8], "n_steps": 1,
         "priority": "hi"})
    sub({"name": "a", "global_interior": [8, 8, 8], "n_steps": 1,
         "deadline_s": -1})
    sub({"name": "a", "global_interior": [8, 8, 8], "n_steps": 1,
         "n_devices": 0})
    sub({"name": "a", "global_interior": [8, 8, 8], "n_steps": 1,
         "periods": [1, 1]})
    sub({"name": "a", "tenant": "no way", "global_interior": [8, 8, 8],
         "n_steps": 1})
    sub({"name": "inf", "global_interior": [2, 2, 2],
         "overlaps": [4, 4, 4], "n_steps": 1})
    sub(spec("j1", submit_token="t1"))
    sub(spec("j1", submit_token="t1"))
    sub(spec("j1", submit_token="OTHER"))
    rec = {k: v for k, v in st.journal["jobs"]["j1"].items()
           if k != "submitted_at"}
    for name, status in (("qq", "quarantined"), ("dd", "done")):
        sp, _ = st._validate(spec(name, tenant="term"))
        st.journal["jobs"][name] = {"status": status,
                                    "config_hash": st._spec_hash(sp)}
        sub(spec(name, tenant="term"))
    sub(spec("dd", tenant="term", n_steps=99))
    sub(spec("j2"))
    sub(spec("j3"))
    sub(spec("j4", tenant="third"))
    st._tenant("greedy")["retries_used"] = 99
    sub(spec("j6", tenant="greedy"))
    st.draining = True
    sub(spec("late"))
    stats = st.stats_doc()
    kinds = [(e.kind, {k: v for k, v in e.detail.items() if k != "at"})
             for e in events]
    return dict(verdicts=out, record=rec, stats=stats, events=kinds,
                shed=[{k: v for k, v in x.items() if k != "at"}
                      for x in st.shed],
                rejected=[{k: v for k, v in x.items() if k != "at"}
                          for x in st.rejected],
                saturated=st._saturated())


def test_admission_verdicts_equal_iggs(tmp_path):
    got = admission_script("port", tmp_path / "port")
    want = admission_script("igg", tmp_path / "igg")
    assert got == want
    codes = [v[0] for v in got["verdicts"]]
    assert codes[:16] == [400] * 16
    assert got["verdicts"][15][2].startswith("infeasible")
    assert codes[16:19] == [201, 200, 409]
    assert codes[19:] == [409, 200, 201, 201, 429, 429, 429, 503]
    assert [v[2] for v in got["verdicts"][23:26]] == [
        "tenant_queue_full", "queue_saturated", "tenant_budget_exhausted"]
    assert got["record"]["status"] == "queued"
    assert got["record"]["submit_token"] == "t1"
    assert sum(t["shed"] for t in got["stats"]["tenants"].values()) == \
        len(got["shed"])


def test_serve_rejects_live_grid_and_foreign_slots(tmp_path):
    _init(6)
    with pytest.raises(it.GridError, match="finalize"):
        it.serve_fleet(tmp_path, factory_of("port"), devices=SLOTS,
                       stop_when_idle_s=0.1)
    it.finalize_global_grid()
    with pytest.raises(it.GridError,
                       match="serve_fleet: devices=.* more than one"):
        it.serve_fleet(tmp_path, factory_of("port"),
                       devices=["cpu", "meta"], stop_when_idle_s=0.1)
    if not torch.cuda.is_available():
        with pytest.raises(it.GridError, match="is_available"):
            it.serve_fleet(tmp_path, factory_of("port"),
                           stop_when_idle_s=0.1)
    assert tel._SESSIONS == []


# ---------------------------------------------------------------------------
# Concurrent jobs, preemption, deadlines, fences, drain
# ---------------------------------------------------------------------------

def test_concurrent_jobs_on_disjoint_slots_bitwise(tmp_path):
    ga, gb = gate("a", 7), gate("b", 7)
    with Serve(tmp_path, max_concurrent=2) as s:
        assert s.ctl.submit(spec("a", tenant="alice", seed=1, n_steps=20,
                                 gate="a")).code == 201
        assert s.ctl.submit(spec("b", tenant="bob", seed=2, n_steps=20,
                                 gate="b")).code == 201
        assert ga["reached"].wait(60) and gb["reached"].wait(60)
        running = s.ctl._state.running
        assert sorted(s.running()) == ["a", "b"]
        assert set(running["a"].slots).isdisjoint(running["b"].slots)
        assert len(running["a"].slots) == len(running["b"].slots) == 4
        ga["release"].set()
        gb["release"].set()
    r = s.result
    assert {n: o.status for n, o in r.jobs.items()} == {"a": "done",
                                                        "b": "done"}
    assert not it.grid_is_initialized()
    for name, seed in (("a", 1), ("b", 2)):
        o = r.jobs[name]
        assert tuple(o.dims) == (2, 2, 1)
        assert torch.equal(o.result.state["T"], solo(o, seed, 20))


def test_priority_preemption_bitwise(tmp_path):
    g = gate("low", 7)
    with Serve(tmp_path, max_concurrent=2) as s:
        assert s.ctl.submit(spec("low", n_devices=8, n_steps=20,
                                 gate="low")).code == 201
        assert g["reached"].wait(60)
        assert s.ctl.submit(spec("hot", priority=5, seed=2,
                                 n_steps=8)).code == 201
        assert wait(lambda: s.ctl._state.running["low"].preempt_reason
                    == "priority")
        g["release"].set()
        assert wait(lambda: any(e.kind == "job_requeued"
                                and e.detail["reason"] == "priority"
                                for e in list(s.events)))
    r = s.result
    assert r.jobs["hot"].status == "done" and r.jobs["low"].status == "done"
    assert any(e.kind == "job_resumed" for e in s.events)
    np.testing.assert_array_equal(outcome_interiors("port", r.jobs["low"]),
                                  clean(1, 20))
    assert torch.equal(r.jobs["hot"].result.state["T"],
                       solo(r.jobs["hot"], 2, 8))


def test_deadline_expired_submission_sheds(tmp_path):
    g = gate("big", 3)
    with Serve(tmp_path, max_concurrent=1) as s:
        s.ctl.submit(spec("big", n_devices=8, n_steps=4, gate="big"))
        assert g["reached"].wait(60)
        s.ctl.submit(spec("urgent", deadline_s=0.05, n_steps=4))
        assert wait(lambda: any(
            e.kind == "job_shed" and e.detail["reason"] == "deadline_exceeded"
            for e in list(s.events)))
        g["release"].set()
    r = s.result
    assert "urgent" not in r.jobs and r.jobs["big"].status == "done"
    shed = [x for x in r.shed if x["job"] == "urgent"]
    assert shed and shed[0]["reason"] == "deadline_exceeded"
    assert "urgent" not in json.loads(r.journal.read_text())["jobs"]


def test_fence_shrinks_only_its_jobs_bitwise(tmp_path):
    ga, gb = gate("a", 7), gate("b", 7)
    with Serve(tmp_path, max_concurrent=2) as s:
        s.ctl.submit(spec("a", tenant="alice", n_steps=20, gate="a"))
        assert ga["reached"].wait(60)
        s.ctl.submit(spec("b", tenant="bob", seed=2, n_steps=20, gate="b"))
        assert gb["reached"].wait(60)
        s.ctl.fence_device(0)
        assert wait(lambda: s.kinds("device_fenced"))
        assert s.ctl._state.running["a"].preempt_reason == "fence"
        assert s.ctl._state.running["b"].preempt_reason is None
        ga["release"].set()
        gb["release"].set()
        assert wait(lambda: any(e.detail["reason"] == "fence"
                                for e in s.kinds("job_requeued")))
        assert s.ctl.stats()["fenced_devices"] == [0]
    r = s.result
    fence = s.kinds("device_fenced")[0]
    assert fence.detail == {"device": 0, "jobs": ["a"]}
    assert {e.detail["job"] for e in s.kinds("job_requeued")} == {"a"}
    assert r.jobs["a"].status == "done" and r.jobs["b"].status == "done"
    assert int(np.prod(r.jobs["a"].dims)) < 4
    assert torch.equal(r.jobs["b"].result.state["T"],
                       solo(r.jobs["b"], 2, 20))
    np.testing.assert_array_equal(outcome_interiors("port", r.jobs["a"]),
                                  clean(1, 20))


def test_drain_seals_and_resume_is_bitwise(tmp_path):
    g = gate("a", 7)
    with Serve(tmp_path, stop_when_idle_s=None) as s:
        s.ctl.submit(spec("a", n_steps=20, n_devices=8, gate="a"))
        assert g["reached"].wait(60)
        s.ctl.submit(spec("q", seed=2, n_steps=4))
        s.ctl.drain()
        late = s.ctl.submit(spec("late"))
        assert (late.code, late.reason) == (503, "draining")
        g["release"].set()
    r = s.result
    assert r.drained and r.jobs["a"].status == "preempted"
    assert "q" not in r.jobs
    j = json.loads(r.journal.read_text())
    assert j["jobs"]["a"]["status"] == "preempted"
    assert j["jobs"]["q"]["status"] == "queued" and j["sealed_at"] > 0
    with Serve(tmp_path, resume=True) as s2:
        pass
    r2 = s2.result
    assert r2.jobs["a"].status == "done" and r2.jobs["q"].status == "done"
    assert any(e.detail.get("source") == "resume"
               for e in s2.kinds("job_admitted"))
    np.testing.assert_array_equal(outcome_interiors("port", r2.jobs["a"]),
                                  clean(1, 20))


# ---------------------------------------------------------------------------
# Quarantine and tenants
# ---------------------------------------------------------------------------

def test_poison_job_quarantined_and_never_readmitted(tmp_path):
    with Serve(tmp_path) as s:
        assert s.ctl.submit(spec("poison", doom=True, n_steps=4,
                                 submit_token="t")).code == 201
        assert wait(lambda: s.kinds("job_quarantined"))
        again = s.ctl.submit(spec("poison", doom=True, n_steps=4,
                                  submit_token="t2"))
        assert (again.code, again.reason) == (409, "quarantined")
    r = s.result
    assert r.jobs["poison"].status == "quarantined"
    assert json.loads(r.journal.read_text())["jobs"]["poison"][
        "status"] == "quarantined"
    assert r.tenants["default"]["quarantined"] == 1
    with Serve(tmp_path, resume=True) as s2:
        pass
    assert "poison" not in s2.result.jobs


def test_two_tenant_isolation_hostile_vs_healthy(tmp_path):
    with Serve(tmp_path / "serve", max_concurrent=2, tenant_queue_bound=2,
               tenant_retry_budget=2) as s:
        assert s.ctl.submit(spec("h1", tenant="healthy", seed=1,
                                 n_steps=10)).code == 201
        assert s.ctl.submit(spec("m1", tenant="mallory", doom=True,
                                 n_steps=4)).code == 201
        assert s.ctl.submit(spec("h2", tenant="healthy", seed=2,
                                 n_steps=10)).code == 201
        codes = [s.ctl.submit(spec(f"m{i}", tenant="mallory", doom=True,
                                   n_steps=4)).code for i in range(2, 8)]
        assert 429 in codes
        assert wait(lambda: s.kinds("job_quarantined"))
        broke = s.ctl.submit(spec("m99", tenant="mallory", doom=True,
                                  n_steps=4))
        assert (broke.code, broke.reason) == (429, "tenant_budget_exhausted")
    r = s.result
    assert r.jobs["h1"].status == "done" and r.jobs["h2"].status == "done"
    mal = r.tenants["mallory"]
    assert mal["quarantined"] >= 1 and mal["shed"] >= 2
    assert mal["retries_used"] >= mal["retry_budget"]
    assert r.tenants["healthy"]["shed"] == r.tenants["healthy"][
        "rejected"] == 0
    assert sum(t["shed"] for t in r.tenants.values()) == len(r.shed)
    assert sum(t["rejected"] for t in r.tenants.values()) == len(r.rejected)
    assert len(s.kinds("job_shed")) == len(r.shed)
    for name, seed in (("h1", 1), ("h2", 2)):
        o = r.jobs[name]
        assert torch.equal(o.result.state["T"], solo(o, seed, 10))


# ---------------------------------------------------------------------------
# Intake: chaos, spool, the endpoint
# ---------------------------------------------------------------------------

def test_arrival_storm_and_malformed_chaos(tmp_path):
    storm = it.chaos.arrival_storm(10, tenant="load",
                                   spec={"global_interior": [8, 8, 8],
                                         "members": 1, "n_steps": 2})
    with it.chaos.armed(storm, it.chaos.malformed_submission(times=2)):
        assert serve._CHAOS_SUBMIT_TAP == {
            "storm": [{"n": 10, "tenant": "load",
                       "spec": {"global_interior": [8, 8, 8], "members": 1,
                                "n_steps": 2}}],
            "malformed": [{"times": 2}]}
        with Serve(tmp_path, max_concurrent=2, queue_bound=3,
                   tenant_queue_bound=8) as s:
            assert wait(lambda: s.kinds("job_shed"))
    assert serve._CHAOS_SUBMIT_TAP is None
    r = s.result
    admitted = [e for e in s.kinds("job_admitted")
                if e.detail.get("source") == "storm"]
    assert len(admitted) + len(s.kinds("job_shed")) == 10
    assert r.tenants["load"]["shed"] == len(s.kinds("job_shed")) >= 1
    assert all(x["reason"] in ("queue_saturated", "tenant_queue_full")
               for x in r.shed)
    assert all(r.jobs[e.detail["job"]].status == "done" for e in admitted)
    mal = [x for x in r.rejected if x["source"] == "chaos"]
    assert len(mal) == 2 and all("malformed" in x["reason"] for x in mal)
    # Disarmed before a loop ran: nothing fires.
    with it.chaos.arrival_storm(3):
        pass
    assert serve._CHAOS_SUBMIT_TAP is None


def test_spool_intake_and_rejected_dir(tmp_path):
    with Serve(tmp_path) as s:
        spool = tmp_path / "spool"
        assert wait(lambda: spool.is_dir())
        tmp = spool / ".tmp-good"
        tmp.write_text(json.dumps(spec("spooled", n_steps=4)))
        os.rename(tmp, spool / "good.json")
        (spool / "bad.json").write_bytes(b"{nope")
        assert wait(lambda: s.kinds("job_rejected"))
    r = s.result
    assert r.jobs["spooled"].status == "done"
    assert (tmp_path / "spool" / "rejected" / "bad.json").read_bytes() == \
        b"{nope"
    assert not list((tmp_path / "spool").glob("*.json"))
    assert [x["source"] for x in r.rejected] == ["spool"]


def test_post_jobs_and_saturation_through_the_endpoint(tmp_path):
    """`POST /jobs` on the serving endpoint answers the admission verdict;
    `/healthz` names queue_saturated while the queue is at its bound and
    recovers after the drain; `/status` carries the tenant table."""
    import urllib.error
    import urllib.request

    def call(url, data=None):
        req = urllib.request.Request(url, data=data,
                                     method="POST" if data else "GET")
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    srv = it.statusd.StatusServer(port=0).start()
    g = gate("hold", 3)
    try:
        with Serve(tmp_path, serve=srv, max_concurrent=1,
                   queue_bound=2) as s:
            body = json.dumps(spec("hold", n_devices=8, n_steps=4,
                                   gate="hold")).encode()
            assert call(srv.url + "/jobs", body)[0] == 201
            assert g["reached"].wait(60)
            codes = [call(srv.url + "/jobs", json.dumps(
                spec(f"q{i}", n_steps=2)).encode())[0] for i in range(3)]
            assert codes == [201, 201, 429]
            code, h = call(srv.url + "/healthz")
            assert code == 503 and [r["reason"] for r in h["reasons"]] == [
                "queue_saturated"]
            assert call(srv.url + "/jobs", b"{nope")[0] == 400
            _, st = call(srv.url + "/status")
            assert st["serve"]["queue_depth"] == 2
            assert st["serve"]["tenants"]["default"]["shed"] == 1
            g["release"].set()
            assert wait(lambda: call(srv.url + "/healthz")[0] == 200)
        assert all(o.status == "done" for o in s.result.jobs.values())
        assert srv.started
        _, st = call(srv.url + "/status")
        assert st["serve"] is None
        assert call(srv.url + "/jobs", body)[0] == 503
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# The journal across packages
# ---------------------------------------------------------------------------

def drain_mid_run(pkg, workdir):
    """Package `pkg`'s service drained while job 'x' (8 slots) holds
    mid-run and 'q' waits: 'x' sealed `preempted`, 'q' `queued`."""
    if pkg == "port":
        g = gate("x", 7)
        extra = {"gate": "x"}
    else:
        g = gate("x", 1)
        extra = {"states_gate": "x"}
    with Serve(workdir, pkg=pkg, stop_when_idle_s=None) as s:
        s.ctl.submit(spec("x", n_steps=20, n_devices=8, **extra))
        assert g["reached"].wait(60)
        s.ctl.submit(spec("q", seed=2, n_steps=4))
        s.ctl.drain()
        g["release"].set()
    g["release"].set()
    return s.result


def resume_in(pkg, workdir):
    with Serve(workdir, pkg=pkg, resume=True) as s:
        pass
    return s.result


@pytest.fixture(scope="module")
def igg_journals(tmp_path_factory):
    """igg's halves of the crossing, run once: igg drains a journal the
    port resumes, and igg resumes the port's drained one."""
    root = tmp_path_factory.mktemp("serve_cross")
    out = {}
    GATES.clear()
    out["igg_drained"] = drain_mid_run("igg", root / "igg_to_port")
    GATES.clear()
    r = drain_mid_run("port", root / "port_to_igg")
    out["port_drained"] = r
    out["port_journal"] = json.loads(r.journal.read_text())
    GATES.clear()
    res = resume_in("igg", root / "port_to_igg")
    out["igg_resumed"] = {n: (o.status, o.dims,
                              interiors("igg", o.dims, o.result.state["T"]))
                          for n, o in res.jobs.items()}
    out["igg_resumed_kinds"] = [e.kind for o in res.jobs.values()
                                for e in o.events]
    out["root"] = root
    return out


def test_igg_resumes_the_ports_drained_journal(igg_journals):
    r = igg_journals["port_drained"]
    assert r.drained and r.jobs["x"].status == "preempted"
    j = igg_journals["port_journal"]
    assert j["format"] == "igg-fleet-journal-v1"
    assert {n: rec["status"] for n, rec in j["jobs"].items()} == {
        "x": "preempted", "q": "queued"}
    got = igg_journals["igg_resumed"]
    assert {n: v[0] for n, v in got.items()} == {"x": "done", "q": "done"}
    assert "job_resumed" in igg_journals["igg_resumed_kinds"]
    np.testing.assert_allclose(got["x"][2], clean(1, 20), rtol=RTOL)
    np.testing.assert_allclose(got["q"][2], clean(2, 4), rtol=RTOL)


def test_port_resumes_iggs_drained_journal(igg_journals):
    r = igg_journals["igg_drained"]
    assert r.drained and r.jobs["x"].status == "preempted"
    wd = igg_journals["root"] / "igg_to_port"
    j = json.loads((wd / "journal.json").read_text())
    assert {n: rec["status"] for n, rec in j["jobs"].items()} == {
        "x": "preempted", "q": "queued"}
    assert j["jobs"]["x"]["spec"]["n_devices"] == 8
    gate("x", 1)["release"].set()     # the journaled spec names the gate
    res = resume_in("port", wd)
    assert {n: o.status for n, o in res.jobs.items()} == {"x": "done",
                                                          "q": "done"}
    assert any(e.kind == "job_resumed" for e in res.jobs["x"].events)
    np.testing.assert_allclose(outcome_interiors("port", res.jobs["x"]),
                               clean(1, 20), rtol=RTOL)
    np.testing.assert_array_equal(outcome_interiors("port", res.jobs["q"]),
                                  clean(2, 4))
    j = json.loads((wd / "journal.json").read_text())
    assert {n: rec["status"] for n, rec in j["jobs"].items()} == {
        "x": "done", "q": "done"}
