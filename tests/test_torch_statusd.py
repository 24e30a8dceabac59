"""The port's ops plane (igg_torch.statusd, igg_torch.top and `serve=` on
the three run loops) held against igg's on the CPU.

Both packages are fed the same record streams through their own buses:
the readiness verdicts and reasons, the `/status` documents (walls, ports
and run ids aside), the Prometheus text of the same registry, the merged
multi-rank exposition of a forged rank's snapshot, the `POST /jobs`
answers and `as_server`'s coercions equal igg's; top's frames equal igg's
for the same documents (the program's name aside); `build_from_dir`
reads a directory igg wrote and one the port wrote as igg does.  The
port's own surface runs over real ephemeral ports: the routes, the port
released on stop, the endpoint answering while the main loop is wedged,
no device-memory gauge on the CPU (the honest omission), the poll
throttle, the publisher off rank 0 and the staleness gate, and the
`serve=` lifecycle of `run_resilient`, `run_ensemble` and `run_fleet`
(an owned server stopped, a shared one left running, a bind failure
leaking no session).  igg's runs sit in a module-scoped fixture.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax  # noqa: F401  (the 8-device CPU mesh of conftest)
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg import comm as icomm
from igg import statusd as istatusd
from igg import telemetry as itel
from igg import top as itop
from igg_torch import comm, statusd, top
from igg_torch import telemetry as tel
from igg_torch.ops.stencil import interior_add
from torch_threads import one_torch_thread  # noqa: F401

PKG = {"igg": (igg, istatusd, itel, icomm, itop),
       "port": (it, statusd, tel, comm, top)}
# Keys whose values are walls, ports, ids or ages: they differ between any
# two runs.
VOLATILE = {"wall", "started_wall", "uptime_s", "run_id", "port", "age_s",
            "t"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("IGG_STATUSD_PORT", "IGG_TELEMETRY_DIR",
                "IGG_COMM_STALL_TIMEOUT", "IGG_STATUSD_HOST"):
        monkeypatch.delenv(var, raising=False)
    for mod in (tel, itel):
        mod.reset_metrics()
        mod._ring().clear()
    it.degrade.reset()
    igg.degrade.reset()
    yield
    for mod in (tel, itel):
        for s in list(mod._SESSIONS):
            s.detach()
        mod.reset_metrics()
    if it.grid_is_initialized():
        it.finalize_global_grid()
    # The runs' ladder records and perf samples stay in this module.
    it.degrade.reset()
    it.perf.reset()


def strip(v):
    if isinstance(v, dict):
        return {k: strip(x) for k, x in v.items() if k not in VOLATILE}
    if isinstance(v, (list, tuple)):
        return [strip(x) for x in v]
    return v


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_text(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# The port's grids and steps
# ---------------------------------------------------------------------------

def _grid():
    it.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1,
                        periody=1, periodz=1, device="cpu", quiet=True)


def _laplace(T, rate=0.1):
    lap = (T[:-2, 1:-1, 1:-1] + T[2:, 1:-1, 1:-1]
           + T[1:-1, :-2, 1:-1] + T[1:-1, 2:, 1:-1]
           + T[1:-1, 1:-1, :-2] + T[1:-1, 1:-1, 2:]
           - 6.0 * T[1:-1, 1:-1, 1:-1])
    return it.update_halo_local(interior_add(T, rate * lap))


def _step(st):
    return {"T": _laplace(st["T"])}


def _init_state(seed=3):
    rng = np.random.default_rng(seed)
    T = it.from_local_blocks(lambda c, ls: rng.standard_normal(ls),
                             (6, 6, 6), dtype=torch.float64)
    return {"T": it.update_halo(T)}


def _fleet_job(name="j1"):
    def make_states(grid):
        rng = np.random.default_rng(1)
        T = it.from_local_blocks(lambda c, ls: rng.standard_normal(ls),
                                 tuple(grid.nxyz), dtype=torch.float64)
        return [{"T": it.update_halo(T)}]

    return it.Job(name=name, global_interior=(8, 8, 8), members=1,
                  n_steps=4, make_states=make_states, step_fn=_step,
                  watch_every=0)


# ---------------------------------------------------------------------------
# (i) readiness verdicts: the same record streams through both buses
# ---------------------------------------------------------------------------

# Each script is a list of operations played on one package: ("emit",
# kind, step, payload), ("check",) records the verdict, ("stall",) fires a
# stall episode on a live StallWatchdog, ("drain",) retires its probe,
# ("saturate", depth, bound) and ("unsaturate",) pin and clear the serve
# backpressure reason.
SCRIPTS = {
    "stall_episode_and_rearm": [
        ("check",), ("stall",), ("check",), ("drain",), ("check",),
        ("stall",), ("check",), ("drain",), ("check",)],
    "members_all_quarantined_vs_one": [
        ("emit", "run_started", None,
         dict(run="ensemble", n_steps=10, members=3)),
        ("emit", "member_quarantined", 4, dict(member=1, reason="retries")),
        ("check",),
        ("emit", "member_quarantined", 6, dict(member=0, reason="retries")),
        ("emit", "member_quarantined", 6, dict(member=2, reason="retries")),
        ("check",),
        ("emit", "run_started", None,
         dict(run="ensemble", n_steps=10, members=2)),
        ("check",)],
    "heal_escalation": [
        ("emit", "run_started", None, dict(run="resilient", n_steps=10)),
        ("emit", "heal_planned", 5, dict(run="resilient", action="retile",
                                         reason="collective_stall")),
        ("emit", "heal_escalated", 7,
         dict(run="resilient", action="demote", escalated_from="retile",
              signal_reason="window_inflation", reason="escalation")),
        ("check",),
        ("emit", "run_started", None, dict(run="resilient", n_steps=10)),
        ("check",)],
    "watchdog_fetch_lag": [
        ("emit", "run_started", None, dict(run="resilient", n_steps=10000)),
        ("emit", "step_stats", 500,
         dict(run="resilient", steps_per_s=9.0, ms_per_step=111.0,
              window_steps=50, fetch_lag_steps=450)),
        ("check",),
        ("emit", "step_stats", 1000,
         dict(run="resilient", steps_per_s=9.0, ms_per_step=111.0,
              window_steps=50, fetch_lag_steps=10)),
        ("check",),
        ("emit", "step_stats", 1500,
         dict(run="resilient", steps_per_s=9.0, ms_per_step=111.0,
              window_steps=50, fetch_lag_steps=999)),
        ("check",),
        ("emit", "run_finished", 10000,
         dict(run="resilient", preempted=False)),
        ("check",)],
    "integrity_violation_and_resolution": [
        ("emit", "run_started", None, dict(run="resilient", n_steps=40)),
        ("emit", "integrity_config", None,
         dict(run="resilient", invariants=["total_heat"], tol=1e-9,
              check_every=2, deep_verify=True, shadow="replay")),
        ("check",),
        ("emit", "integrity_violation", 12,
         dict(run="resilient", source="invariant", invariant="total_heat",
              field="T", rank=3, device=None, drift=0.25)),
        ("check",),
        ("emit", "integrity_resolved", 12,
         dict(run="resilient", rolled_back_to=5, source="invariant")),
        ("check",)],
    "queue_saturated": [
        ("check",), ("saturate", 16, 16), ("check",), ("unsaturate",),
        ("check",), ("saturate", 3, 3), ("check",),
        ("emit", "run_started", None, dict(run="serve", devices=8)),
        ("check",), ("unsaturate",), ("check",)],
}


def play(pkg, script):
    _, sd, t, cm, _ = PKG[pkg]
    health = sd.HealthState(max_fetch_lag=100).attach()
    dog = cm.StallWatchdog(0.01, run="resilient", poll_s=100)
    verdicts = []
    try:
        for op in script:
            if op[0] == "emit":
                t.emit(op[1], step=op[2], **op[3])
            elif op[0] == "check":
                ready, reasons = health.readiness()
                verdicts.append((ready, strip(reasons)))
            elif op[0] == "stall":
                dog.watch(("probe", 5), 5, "watchdog probe")
                time.sleep(0.03)
                assert dog.check()
            elif op[0] == "drain":
                dog.fetched(("probe", 5), 5)
            elif op[0] == "saturate":
                health.set_queue_saturated(depth=op[1], bound=op[2])
            elif op[0] == "unsaturate":
                health.set_queue_saturated(None)
        view = strip(health.view())
    finally:
        dog.close()
        health.detach()
    return verdicts, view


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_readiness_verdicts_equal_iggs(script):
    want = play("igg", SCRIPTS[script])
    got = play("port", SCRIPTS[script])
    assert got == want
    # Each script turns readiness false at least once and recovers.
    assert any(not r for r, _ in got[0]) and got[0][-1][0]


def test_reason_strings_equal_iggs():
    for name in ("REASON_STALL", "REASON_ALL_QUARANTINED",
                 "REASON_ESCALATED", "REASON_FETCH_LAG", "REASON_INTEGRITY",
                 "REASON_QUEUE_SATURATED"):
        assert getattr(statusd, name) == getattr(istatusd, name)
    assert statusd._HEAL_KINDS == istatusd._HEAL_KINDS
    assert statusd.__all__ == istatusd.__all__


def test_feed_equals_live_folding():
    """`feed` over serialized records folds as the live subscription does
    (the offline top view shares the tracker)."""
    script = SCRIPTS["heal_escalation"] + SCRIPTS["watchdog_fetch_lag"]
    live, view = play("port", script)
    records = [r.as_dict() for r in tel.flight_recorder()]
    health = statusd.HealthState(max_fetch_lag=100)
    for r in json.loads(json.dumps(records)):
        health.feed(r)
    assert strip(health.view()) == view
    assert (health.readiness()[0], strip(health.readiness()[1])) == live[-1]


# ---------------------------------------------------------------------------
# (ii) the /status documents and the exposition
# ---------------------------------------------------------------------------

def _rich_stream(t):
    t.counter("igg_steps_total", run="resilient").inc(40)
    t.gauge("igg_exposed_comm_fraction").set(0.125)
    t.gauge("igg_steps_per_s").set(8.0)
    t.histogram("igg_checkpoint_write_seconds").observe(0.25)
    t.emit("run_started", run="resilient", n_steps=100)
    t.emit("step_stats", step=40, run="resilient", steps_per_s=8.0,
           ms_per_step=125.0, window_steps=20, fetch_lag_steps=2)
    t.emit("checkpoint", step=40, path="/ring/ckpt_000000040",
           background=True)
    t.emit("heal_recalibrate", step=41, run="resilient", family="comm")
    t.emit("run_started", run="ensemble", n_steps=10, members=4)
    t.emit("step_stats", step=5, run="ensemble", steps_per_s=3.0,
           ms_per_step=333.0, window_steps=5, fetch_lag_steps=0,
           member_steps_per_s=12.0, members_active=4)
    t.emit("member_quarantined", step=6, member=2, reason="retries")
    t.emit("collective_stall", step=7, run="resilient", in_flight="probe",
           age_s=1.5, pending=2)


SERVE_STATS = {"queue_depth": 2, "queue_bound": 16, "saturated": False,
               "running": ["ok"], "fenced_devices": [3], "draining": False,
               "tenants": {"alice": {"queued": 1, "running": 1, "done": 4,
                                     "failed": 0, "quarantined": 0,
                                     "shed": 2, "rejected": 1,
                                     "retries_used": 3, "retry_budget": 8,
                                     "weight": 2.0}}}


def _status(pkg, journal):
    _, sd, t, _, _ = PKG[pkg]
    with sd.StatusServer(port=0) as srv:
        _rich_stream(t)
        srv.watch_fleet(journal)
        srv.watch_serve(lambda: SERVE_STATS, None)
        doc = srv.status_doc()
        health = srv.health_doc()
        _, served = _get(srv.url + "/status")
    return doc, health, served


def test_status_documents_equal_iggs(tmp_path):
    journal = tmp_path / "journal.json"
    journal.write_text(json.dumps({
        "format": "igg-fleet-journal-v1",
        "jobs": {"a": {"status": "done"}, "b": {"status": "running"},
                 "c": {"status": "done"}, "d": {"status": "quarantined"}}}))
    want = _status("igg", journal)
    got = _status("port", journal)
    assert strip(got[0]) == strip(want[0])
    assert strip(got[1]) == strip(want[1])
    assert strip(got[2]) == strip(got[0]) | {"flight_events":
                                             got[2]["flight_events"]}
    doc = got[0]
    assert doc["fleet"]["by_status"] == {"done": 2, "running": 1,
                                         "quarantined": 1}
    assert doc["serve"] == SERVE_STATS
    assert doc["hbm"] is None and doc["members"]["quarantined"] == [2]


def test_prometheus_text_equal_iggs():
    for t in (itel, tel):
        t.counter("igg_steps_total", run="x").inc(3)
        t.counter("igg_tier_dispatch_total", family="diffusion3d",
                  tier="diffusion3d.cuda").inc(5)
        t.gauge("my_custom_gauge", help="A custom thing.\nSecond line",
                kind='a"b').set(1.5)
        t.histogram("igg_checkpoint_write_seconds").observe(0.1)
        t.histogram("h_lat", help="lat")
    assert tel.prometheus_text() == itel.prometheus_text()
    # The merged exposition of the same samples under forged ranks.
    by_rank = {0: tel.metric_samples(), 2: tel.metric_samples()}
    merged = statusd._render_samples(by_rank)
    assert merged == istatusd._render_samples(
        {0: itel.metric_samples(), 2: itel.metric_samples()})
    assert merged.count("# TYPE igg_steps_total counter") == 1
    assert 'rank="2"' in merged


def _publish_merge(pkg, tmp_path, monkeypatch):
    _, sd, t, _, _ = PKG[pkg]
    t.counter("igg_steps_total", run="resilient").inc(11)
    if pkg == "igg":
        monkeypatch.setattr(t, "_process_cached", 1)
    else:
        monkeypatch.setattr(t, "_process", lambda: 1)
    pub = sd.StatusServer(port=0, dir=tmp_path)
    out = pub.publish_snapshot()
    if pkg == "igg":
        monkeypatch.setattr(t, "_process_cached", 0)
    else:
        monkeypatch.setattr(t, "_process", lambda: 0)
    doc = json.loads(out.read_text())
    with sd.StatusServer(port=0, dir=tmp_path) as srv:
        code, body = _get_text(srv.url + "/metrics")
        _, s = _get(srv.url + "/status")
    return out.name, strip(doc), code, body, sorted(s["ranks"])


def test_publish_and_merge_with_a_forged_rank(tmp_path, monkeypatch):
    want = _publish_merge("igg", tmp_path / "igg", monkeypatch)
    got = _publish_merge("port", tmp_path / "port", monkeypatch)
    assert got == want
    name, doc, code, body, ranks = got
    assert name == "statusd_r1.json" and doc["process"] == 1
    assert code == 200 and 'rank="0"' in body and 'rank="1"' in body
    assert ranks == ["1"]


def test_staleness_gate_and_torn_snapshot(tmp_path, monkeypatch):
    tel.counter("igg_steps_total", run="resilient").inc(11)
    monkeypatch.setattr(tel, "_process", lambda: 1)
    out = statusd.StatusServer(port=0, dir=tmp_path).publish_snapshot()
    monkeypatch.setattr(tel, "_process", lambda: 0)
    with statusd.StatusServer(port=0, dir=tmp_path) as srv:
        assert 'rank="1"' in _get_text(srv.url + "/metrics")[1]
        doc = json.loads(out.read_text())
        doc["wall"] = time.time() - 3600
        out.write_text(json.dumps(doc))
        code, body = _get_text(srv.url + "/metrics")
        assert code == 200 and 'rank="1"' not in body
        assert "1" not in _get(srv.url + "/status")[1]["ranks"]
        doc["wall"] = time.time()
        out.write_text(json.dumps(doc))
        (tmp_path / "statusd_r2.json").write_text("{torn")
        code, body = _get_text(srv.url + "/metrics")
        assert code == 200 and 'rank="1"' in body and 'rank="2"' not in body


def test_publisher_thread_runs_off_rank0(tmp_path, monkeypatch):
    monkeypatch.setattr(tel, "_process", lambda: 3)
    srv = statusd.StatusServer(port=0, dir=tmp_path, publish_every=0.02)
    srv.start()
    try:
        assert srv.port is None and srv.url is None
        deadline = time.monotonic() + 5
        while (not (tmp_path / "statusd_r3.json").exists()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert (tmp_path / "statusd_r3.json").exists()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# (iii) the routes over a real ephemeral port
# ---------------------------------------------------------------------------

def test_routes_metrics_healthz_status_events():
    tel.counter("igg_steps_total", run="t").inc(7)
    tel.emit("run_started", run="resilient", n_steps=40)
    tel.emit("step_stats", step=20, run="resilient", steps_per_s=5.0,
             ms_per_step=200.0, window_steps=20, fetch_lag_steps=1)
    with statusd.StatusServer(port=0) as srv:
        code, body = _get_text(srv.url + "/metrics")
        assert code == 200 and 'igg_steps_total{run="t"} 7.0' in body
        code, h = _get(srv.url + "/healthz")
        assert code == 200 and h["live"] and h["ready"] and h["reasons"] == []
        code, s = _get(srv.url + "/status")
        assert code == 200 and s["runs"]["resilient"]["steps_done"] == 20
        assert s["port"] == srv.port and isinstance(s["tiers"], dict)
        code, nd = _get_text(srv.url + "/events?n=2")
        lines = [json.loads(ln) for ln in nd.splitlines()]
        assert code == 200 and len(lines) == 2
        assert lines[-1]["kind"] == "statusd_started"
        code, nd = _get_text(srv.url + "/events?n=oops")
        assert code == 200 and len(nd.splitlines()) == 3   # n=64: all
        code, e = _get(srv.url + "/nope")
        assert code == 404 and "/metrics" in e["routes"]
        counts = tel.snapshot()
        assert counts['igg_statusd_requests_total{route="/metrics"}'][
            "value"] == 1.0


def test_start_stop_releases_port():
    srv = statusd.StatusServer(port=0).start()
    port = srv.port
    assert port and srv.url == f"http://127.0.0.1:{port}"
    assert srv.start() is srv                       # idempotent
    srv.stop()
    assert srv.port is None and not srv.started
    again = statusd.StatusServer(port=port).start()  # the port is free
    assert again.port == port
    again.stop()
    again.stop()
    kinds = [r.kind for r in tel.flight_recorder()]
    assert kinds.count("statusd_started") == 2
    assert kinds.count("statusd_stopped") == 2


def test_bind_failure_is_a_grid_error():
    blocker = statusd.StatusServer(port=0).start()
    try:
        with pytest.raises(it.GridError, match="cannot bind 127.0.0.1:"):
            statusd.StatusServer(port=blocker.port).start()
    finally:
        blocker.stop()


def test_endpoint_answers_while_main_loop_is_wedged(monkeypatch):
    """With an injected stall and the loop's thread held at a dispatch
    boundary, `/metrics` and `/healthz` keep answering from statusd's own
    threads, readiness false naming the stall, and readiness recovers
    once the episode drains at the end of the run."""
    monkeypatch.setenv("IGG_COMM_STALL_TIMEOUT", "0.05")
    _grid()
    srv = statusd.StatusServer(port=0).start()
    plan = it.chaos.ChaosPlan(hold_at=[(10, 1.0)])
    seen, done, result = [], threading.Event(), {}

    def scrape():
        while not done.is_set():
            try:
                code, h = _get(srv.url + "/healthz")
                mcode, _ = _get_text(srv.url + "/metrics")
                seen.append((code, [r["reason"] for r in h["reasons"]],
                             mcode))
            except OSError:
                pass
            time.sleep(0.01)

    def run():
        with it.chaos.collective_stall():
            result["res"] = it.run_resilient(
                _step, _init_state(), 20, watch_every=5,
                max_pending_probes=100, serve=srv, chaos=plan,
                install_sigterm=False)

    scraper = threading.Thread(target=scrape, daemon=True)
    runner = threading.Thread(target=run, daemon=True)
    scraper.start()
    runner.start()
    runner.join(timeout=60)
    done.set()
    scraper.join(timeout=10)
    try:
        assert not runner.is_alive()
        assert result["res"].steps_done == 20
        stalled = [s for s in seen if s[0] == 503]
        assert stalled, seen
        assert all("collective_stall" in s[1] for s in stalled)
        assert all(s[2] == 200 for s in seen)
        assert any(r.kind == "collective_stall"
                   for r in tel.flight_recorder())
        code, h = _get(srv.url + "/healthz")
        assert code == 200 and h["ready"]
        assert srv.started                # shared: left running
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# (iv) device memory: honest omission on the CPU, the poll throttle
# ---------------------------------------------------------------------------

def test_hbm_omitted_on_the_cpu_and_present_with_stats(monkeypatch):
    from igg_torch import device

    assert device.memory_stats() == []          # this host has no card
    srv = statusd.StatusServer(port=0, hbm_every=0.0).start()
    try:
        code, body = _get_text(srv.url + "/metrics")
        assert code == 200 and "igg_hbm_" not in body
        assert _get(srv.url + "/status")[1]["hbm"] is None
        monkeypatch.setattr(device, "memory_stats", lambda device=None: [
            {"device": "cuda:0", "kind": "NVIDIA H100 80GB HBM3",
             "bytes_in_use": 3 * 2**30, "bytes_limit": 80 * 2**30,
             "peak_bytes_in_use": 5 * 2**30, "bytes_reserved": 6 * 2**30}])
        code, body = _get_text(srv.url + "/metrics")
        assert 'igg_hbm_bytes_in_use{device="cuda:0"} 3221225472' in body
        assert 'igg_hbm_bytes_limit{device="cuda:0"}' in body
        assert 'igg_hbm_watermark_bytes{device="cuda:0"}' in body
        hbm = _get(srv.url + "/status")[1]["hbm"]
        assert hbm["devices"] == 1
        assert hbm["pct_in_use"] == pytest.approx(100.0 * 3 / 80)
    finally:
        srv.stop()


def test_hbm_poll_throttle(monkeypatch):
    from igg_torch import device

    calls = []
    monkeypatch.setattr(device, "memory_stats",
                        lambda device=None: calls.append(1) or [])
    p = statusd._HbmPoller(every=1000.0)
    assert p.poll() is None
    p.poll()
    p.poll()
    assert len(calls) == 1
    p.poll(force=True)
    assert len(calls) == 2
    monkeypatch.setenv("IGG_STATUSD_HBM_EVERY", "2.5")
    assert statusd._HbmPoller().every == 2.5


# ---------------------------------------------------------------------------
# (v) POST /jobs, as_server, the knobs
# ---------------------------------------------------------------------------

def _jobs_answers(pkg):
    _, sd, _, _, _ = PKG[pkg]
    from importlib import import_module

    sr = import_module(("igg" if pkg == "igg" else "igg_torch")
                       + ".serve").SubmissionResult
    verdicts = {
        b'{"name": "ok"}': sr(201, "admitted", job="ok", tenant="t"),
        b'{"name": "dup"}': sr(200, "duplicate", reason="already enqueued"),
        b"{broken": sr(400, "rejected", reason="malformed: bad"),
        b'{"name": "q"}': sr(409, "rejected", reason="quarantined",
                             job="q"),
        b'{"name": "full"}': sr(429, "shed", reason="queue_saturated"),
        b'{"name": "late"}': sr(503, "shed", reason="draining"),
    }
    out = []
    with sd.StatusServer(port=0) as srv:
        out.append(_post(srv.url + "/jobs", b"{}"))
        srv.watch_serve(lambda: SERVE_STATS,
                        lambda raw: verdicts[bytes(raw)])
        out += [_post(srv.url + "/jobs", raw) for raw in verdicts]
        out.append(_post(srv.url + "/elsewhere", b"{}"))
        out.append(_get(srv.url + "/status")[1]["serve"])
        srv.watch_serve(None, None)
        out.append(_post(srv.url + "/jobs", b"{}"))
        out.append(_get(srv.url + "/status")[1]["serve"])
    return out


def test_post_jobs_answers_equal_iggs():
    got = _jobs_answers("port")
    assert got == _jobs_answers("igg")
    assert got[0][0] == 503 and "no serving scheduler" in got[0][1]["reason"]
    assert [c for c, _ in got[1:7]] == [201, 200, 400, 409, 429, 503]
    assert got[7][0] == 404 and got[8] == SERVE_STATS and got[-1] is None


def _coerce(sd, v):
    try:
        srv = sd.as_server(v)
    except Exception as e:
        return ("raises", type(e).__name__)
    if srv is None:
        return None
    return (srv.requested_port, srv.started, srv.host)


@pytest.mark.parametrize("env", [None, "0", "9137"])
def test_as_server_coercions_equal_iggs(env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("IGG_STATUSD_PORT", env)
    for v in (None, False, True, 0, 4242, "nope", 1.5):
        assert _coerce(statusd, v) == _coerce(istatusd, v), v
    shared_srv = statusd.StatusServer(port=0)
    assert statusd.as_server(shared_srv) is shared_srv
    with pytest.raises(it.GridError, match="serve="):
        statusd.as_server("nope")


def test_env_knobs_registered_and_read(monkeypatch):
    from igg_torch import _env

    for knob in ("IGG_STATUSD_PORT", "IGG_STATUSD_HOST",
                 "IGG_STATUSD_HBM_EVERY", "IGG_STATUSD_MAX_FETCH_LAG",
                 "IGG_STATUSD_PUBLISH_EVERY"):
        assert knob in _env._KNOWN
    monkeypatch.setenv("IGG_STATUSD_MAX_FETCH_LAG", "7")
    monkeypatch.setenv("IGG_STATUSD_PUBLISH_EVERY", "0.5")
    monkeypatch.setenv("IGG_STATUSD_HOST", "localhost")
    srv = statusd.StatusServer()
    assert srv.health.max_fetch_lag == 7 and srv.publish_every == 0.5
    assert srv.host == "localhost"


# ---------------------------------------------------------------------------
# (vi) serve= on the three run loops
# ---------------------------------------------------------------------------

def _run_loop(loop, serve, tmp_path, **kw):
    if loop == "resilient":
        _grid()
        try:
            return it.run_resilient(_step, _init_state(), 10, watch_every=5,
                                    serve=serve, install_sigterm=False, **kw)
        finally:
            it.finalize_global_grid()
    if loop == "ensemble":
        _grid()
        try:
            return it.run_ensemble(_step, [_init_state(1), _init_state(2)],
                                   10, watch_every=5, serve=serve,
                                   install_sigterm=False, **kw)
        finally:
            it.finalize_global_grid()
    return it.run_fleet([_fleet_job()], tmp_path, devices=["cpu"] * 8,
                        serve=serve, install_sigterm=False, **kw)


LOOPS = ("resilient", "ensemble", "fleet")


@pytest.mark.parametrize("loop", LOOPS)
def test_serve_lifecycle_shared_server(loop, tmp_path):
    """A shared, started server is left running; `/status` saw the run."""
    srv = statusd.StatusServer(port=0).start()
    try:
        _run_loop(loop, srv, tmp_path)
        assert srv.started
        _, s = _get(srv.url + "/status")
        assert s["runs"][loop]["finished"] is True
        if loop == "fleet":
            assert s["fleet"] == {"journal": str(tmp_path / "journal.json"),
                                  "jobs": 1, "by_status": {"done": 1}}
            assert s["runs"]["ensemble"]["finished"] is True
    finally:
        srv.stop()


@pytest.mark.parametrize("loop", LOOPS)
def test_serve_lifecycle_owned_server(loop, tmp_path):
    """An int port starts an owned endpoint for the run and stops it,
    releasing the port; None with no knob set runs no server."""
    seen = {}

    def on_record(rec):
        if rec.kind in ("statusd_started", "statusd_stopped"):
            seen.setdefault(rec.kind, []).append(rec.payload["port"])

    tel.subscribe(on_record)
    try:
        _run_loop(loop, 0, tmp_path / "a")
        port = seen["statusd_started"][0]
        assert seen["statusd_stopped"] == [port]
        statusd.StatusServer(port=port).start().stop()   # released
        _run_loop(loop, None, tmp_path / "b")
        assert seen["statusd_started"] == [port, port]   # the probe's only
    finally:
        tel.unsubscribe(on_record)


@pytest.mark.parametrize("loop", LOOPS)
def test_serve_bind_failure_detaches_session(loop, tmp_path):
    blocker = statusd.StatusServer(port=0).start()
    try:
        with pytest.raises(it.GridError, match="cannot bind"):
            _run_loop(loop, blocker.port, tmp_path / "ring",
                      telemetry=tmp_path / "tel")
        assert tel._SESSIONS == []
        assert not it.grid_is_initialized()
    finally:
        blocker.stop()


def test_serve_env_port_drives_the_loop(monkeypatch, tmp_path):
    """serve=None starts an endpoint where IGG_STATUSD_PORT is set, and
    serve=False stays off even then."""
    probe = statusd.StatusServer(port=0).start()
    port = probe.port
    probe.stop()
    monkeypatch.setenv("IGG_STATUSD_PORT", str(port))
    started = []
    tel.subscribe(lambda r: r.kind == "statusd_started"
                  and started.append(r.payload["port"]))
    _run_loop("resilient", None, tmp_path)
    _run_loop("resilient", False, tmp_path)
    assert started == [port]


def test_ensemble_all_quarantined_readiness_through_serve(tmp_path):
    """run_ensemble(serve=) with every member poisoned: the endpoint's
    verdict during the run names all_members_quarantined."""
    srv = statusd.StatusServer(port=0).start()
    _grid()
    try:
        plan = it.chaos.ChaosPlan(nan_at=[(3, 0, "T"), (3, 1, "T")])
        with pytest.raises(it.ResilienceError):
            it.run_ensemble(_step, [_init_state(1), _init_state(2)], 10,
                            watch_every=5, member_retries=0, serve=srv,
                            chaos=plan, install_sigterm=False)
        code, h = _get(srv.url + "/healthz")
        assert code == 503
        assert [r["reason"] for r in h["reasons"]] == [
            "all_members_quarantined"]
    finally:
        srv.stop()
        it.finalize_global_grid()


# ---------------------------------------------------------------------------
# (vii) top: the renderer, the offline view, the CLI
# ---------------------------------------------------------------------------

def _frame_pair(status, events, n=12):
    want = itop.render(status, events, n).replace("igg.top", "igg_torch.top")
    return top.render(status, events, n), want


def test_top_render_equals_iggs_for_live_documents(tmp_path):
    journal = tmp_path / "journal.json"
    journal.write_text(json.dumps({"format": "igg-fleet-journal-v1",
                                   "jobs": {"a": {"status": "done"}}}))
    status, _, _ = _status("port", journal)
    events = [r.as_dict() for r in tel.flight_recorder()]
    got, want = _frame_pair(status, events)
    assert got == want
    assert "NOT READY (collective_stall)" not in got    # stall record only
    assert "serve: queue 2/16" in got and "tenant alice" in got
    assert "members: 4 (1 quarantined)" in got


@pytest.mark.parametrize("case", ["ready", "not_ready", "offline",
                                  "integrity_live", "integrity_resolved",
                                  "integrity_clean", "hbm", "skew"])
def test_top_render_equals_iggs(case):
    base = {"wall": 1_700_000_000.0, "process": 0,
            "runs": {"resilient": {"n_steps": 100, "steps_done": 40,
                                   "steps_per_s": 8.0,
                                   "fetch_lag_steps": 2,
                                   "ms_per_step": 125.0}},
            "tiers": {"diffusion3d": "diffusion3d.cuda",
                      "hm3d": "hm3d.plain"},
            "health": {"ready": True, "reasons": []}}
    extra = {
        "ready": {},
        "not_ready": {"health": {"ready": False, "reasons": [
            {"reason": "collective_stall"}, {"reason": "queue_saturated"}]},
            "quarantine": {"hm3d.cuda": "verify"},
            "heal": [{"kind": "heal_retile", "step": 9}]},
        "offline": {"health": {"ready": None, "reasons": []},
                    "runs": {}, "process": None},
        "integrity_live": {"integrity": {"violation": {
            "source": "shadow", "field": "T", "rank": 3, "step": 12},
            "violations_total": 1}},
        "integrity_resolved": {"integrity": {
            "violations_total": 2, "resolved": {"step": 30}}},
        "integrity_clean": {"integrity": {"config": {
            "invariants": ["total_heat"], "check_every": 2}}},
        "hbm": {"hbm": {"bytes_in_use": 1.07e9, "bytes_limit": 8.5e10,
                        "pct_in_use": 1.26}, "checkpoint": {
                            "step": 40, "path": "/ring/ckpt_40"}},
        "skew": {"runs": {"resilient": {"ms_per_step": 10.0}},
                 "ranks": {"1": {"runs": {"resilient":
                                          {"ms_per_step": 14.0}}}}},
    }[case]
    status = {**base, **extra}
    if status.get("process") is None:
        status.pop("process")
    events = [{"wall": 1_700_000_000.0 + i, "process": 0,
               "kind": "step_stats", "step": i,
               "payload": {"run": "resilient", "steps_per_s": 8.0,
                           "ms_per_step": 125.0, "window_steps": 20}}
              for i in range(15)]
    got, want = _frame_pair(status, events)
    assert got == want
    assert top._rank_skew_from_status(status) == \
        itop._rank_skew_from_status(status)


def _write_session(pkg, d):
    """A short resilient run of package `pkg` under a telemetry session at
    `d`, plus a forged rank 1's statusd snapshot beside it."""
    mod, sd, t, _, _ = PKG[pkg]
    t.reset_metrics()
    if pkg == "igg":
        igg.init_global_grid(6, 6, 6, periodx=1, periody=1, periodz=1,
                             quiet=True)
        from helpers import ensemble_member_step

        step = ensemble_member_step()

        @igg.sharded
        def fn(T):
            return step({"T": T})["T"]

        rng = np.random.default_rng(3)
        T = igg.update_halo(igg.from_local_blocks(
            lambda c, ls: rng.standard_normal(ls), (6, 6, 6)))
        state, step_fn = {"T": T}, (lambda s: {"T": fn(s["T"])})
    else:
        _grid()
        state, step_fn = _init_state(), _step
    try:
        mod.run_resilient(step_fn, state, 20, watch_every=5,
                          checkpoint_dir=d / "ring", checkpoint_every=10,
                          telemetry=d, install_sigterm=False)
    finally:
        mod.finalize_global_grid()
    t.counter("igg_tier_dispatch_total", family="diffusion3d",
              tier="diffusion3d.plain").inc(5)
    t.gauge("igg_exposed_comm_fraction").set(0.25)
    return d


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Directories written by igg's and by the port's run loops (igg's runs
    once for the module)."""
    out = {}
    for pkg in ("igg", "port"):
        d = tmp_path_factory.mktemp(f"tel_{pkg}")
        _write_session(pkg, d)
        _, sd, t, _, _ = PKG[pkg]
        # A forged rank 1 publishes beside rank 0's files.
        if pkg == "igg":
            saved = t._process_cached
            t._process_cached = 1
        else:
            saved = t._process
            t._process = lambda: 1
        try:
            sd.StatusServer(port=0, dir=d).publish_snapshot()
        finally:
            if pkg == "igg":
                t._process_cached = saved
            else:
                t._process = saved
        out[pkg] = d
    return out


@pytest.mark.parametrize("writer", ["igg", "port"])
def test_build_from_dir_equals_iggs(writer, sessions):
    d = sessions[writer]
    got_status, got_events = top.build_from_dir(d, 8)
    want_status, want_events = itop.build_from_dir(d, 8)
    assert strip(got_status) == strip(want_status)
    assert got_events == want_events
    assert got_status["offline"] and got_status["health"]["ready"] is None
    assert got_status["runs"]["resilient"]["finished"] is True
    assert got_status["checkpoint"]["step"] == 20
    assert got_status["tiers"]["diffusion3d"] == "diffusion3d.plain"
    assert got_status["gauges"] == {"igg_exposed_comm_fraction": 0.25}
    got, want = _frame_pair(got_status, got_events, 8)
    assert got.split("\n", 1)[1] == want.split("\n", 1)[1]


def test_build_from_dir_falls_back_to_flight_dumps(tmp_path):
    with tel.Telemetry(tmp_path):
        tel.emit("run_started", run="resilient", n_steps=5)
        tel.emit("nan_detected", step=3, counts={"T": 1})
        tel.dump_flight_recorder("died")
    (tmp_path / "events_r0.jsonl").unlink()
    status, events = top.build_from_dir(tmp_path)
    want_status, want_events = itop.build_from_dir(tmp_path)
    assert strip(status) == strip(want_status)
    assert [e["kind"] for e in events] == [e["kind"] for e in want_events]
    assert "nan_detected" in [e["kind"] for e in events]


def test_top_cli_live_offline_and_errors(tmp_path, capsys):
    with tel.Telemetry(tmp_path):
        tel.emit("run_started", run="resilient", n_steps=100)
        tel.emit("step_stats", step=40, run="resilient", steps_per_s=8.0,
                 ms_per_step=125.0, window_steps=20, fetch_lag_steps=0)
        tel.emit("checkpoint", step=40, path="/tmp/ck_000000040")
    with statusd.StatusServer(port=0) as srv:
        assert top._main([srv.url, "--once", "--plain"]) == 0
        live = capsys.readouterr().out
        status, events = top.fetch_endpoint(srv.url, n=3)
        assert len(events) == 3
    assert "READY" in live and "step 40/100" in live
    assert "HBM: n/a (no allocator stats)" in live
    assert top._main([str(tmp_path), "--once", "--plain", "-n", "5"]) == 0
    offline = capsys.readouterr().out
    assert "OFFLINE VIEW" in offline and "checkpoint head: step 40" in offline
    assert top._main([str(tmp_path / "missing"), "--once"]) == 2
    assert top._main(["--every"]) == 2
    assert top._main([]) == 2
    assert top._main(["-h"]) == 0
    assert "usage: python -m igg_torch.top" in capsys.readouterr().out


def test_top_non_json_endpoint_is_a_clean_error(capsys):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Html(BaseHTTPRequestHandler):
        def do_GET(self):
            body = b"<html>not statusd</html>"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Html)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert top._main([url, "--once"]) == 2
        assert "did not return JSON" in capsys.readouterr().err
    finally:
        httpd.shutdown()
        httpd.server_close()
