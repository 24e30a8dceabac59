"""The port's telemetry, knobs and profiler held against igg on the CPU.

`igg_torch.telemetry` writes igg's formats: the same metric operations
give the same Prometheus text and snapshot, the same span records the
same Chrome trace, the same rank-tagged files the same merged stream,
byte for byte.  Also: the flight recorder's bound, a session's files,
`as_session`'s coercions, the span and device-annotation knobs, the
`IGG_*` knob registry, `igg_torch.profiling.trace`, that telemetry adds
no host sync to a model's loop, and that the new modules import neither
JAX nor igg.
"""

import json
import pathlib
import subprocess
import sys
import time
import warnings

import pytest
import torch

import igg_torch as it
from igg import _env as igg_env
from igg import telemetry as igg_tel
from igg_torch import _env as t_env
from igg_torch import profiling
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as t3
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_state():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    tel.reset_metrics()
    igg_tel.reset_metrics()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()
    tel.reset_metrics()
    igg_tel.reset_metrics()


def _script(mod):
    """One sequence of metric operations, labels that need escaping
    included, applied to a telemetry module."""
    mod.counter("igg_halo_plane_bytes_total").inc(4096)
    mod.counter("igg_halo_plane_bytes_total", dim="x",
                mode="local_grouped").inc(2048)
    mod.counter("igg_tier_dispatch_total", family="diffusion3d",
                tier="diffusion3d.plain").inc()
    c = mod.counter("port_odd_total", help='a \\ back"slash\nhelp',
                    path='C:\\run "one"\nx')
    c.inc(2.5)
    c.inc()
    g = mod.gauge("port_level", zone="b")
    g.set(3)
    g.inc(0.25)
    mod.gauge("port_level", zone="a").set(-1.5)
    h = mod.histogram("port_write_seconds", help="latency")
    for v in (0.5, 0.125, 2.0):
        h.observe(v)
    mod.histogram("port_write_seconds", kind="empty")
    with pytest.raises(mod.GridError):
        mod.gauge("port_odd_total")
    with pytest.raises(mod.GridError):
        c.inc(-1)


def test_metrics_match_igg_byte_for_byte():
    _script(tel)
    _script(igg_tel)
    assert tel.prometheus_text() == igg_tel.prometheus_text()
    assert tel.snapshot() == igg_tel.snapshot()
    assert tel.metric_samples() == igg_tel.metric_samples()
    assert 'path="C:\\\\run \\"one\\"\\nx"' in tel.prometheus_text()
    tel.reset_metrics()
    igg_tel.reset_metrics()
    assert tel.prometheus_text() == igg_tel.prometheus_text() == ""


def _records(mod):
    R = mod.Record
    return [
        R(t=1.0, wall=1000.5, process=0, kind="span", step=3,
          payload={"name": "degrade.verify_first_use", "dur_s": 0.25,
                   "t0": 0.75, "wall0": 1000.25, "tid": 7,
                   "tier": "diffusion3d.cuda"}),
        R(t=2.0, wall=1001.0, process=0, kind="tier_degraded",
          payload={"tier": "x"}),
        R(t=3.0, wall=1002.0, process=0, kind="span",
          payload={"name": "bare", "dur_s": -1.0}),
    ]


def test_chrome_trace_matches_igg(tmp_path):
    a = tel.export_chrome_trace(tmp_path / "port" / "t.json",
                                _records(tel))
    b = igg_tel.export_chrome_trace(tmp_path / "igg" / "t.json",
                                    _records(igg_tel))
    assert a.read_bytes() == b.read_bytes()
    assert len(json.loads(a.read_text())["traceEvents"]) == 2


def test_span_record_matches_igg(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY_DEVICE", "0")
    spans = []
    for mod in (tel, igg_tel):
        with mod.span("region", step=5, family="f"):
            pass
        spans.append(mod.flight_recorder()[-1])
    port, ref = spans
    assert port.kind == ref.kind == "span" and port.step == ref.step == 5
    assert sorted(port.payload) == sorted(ref.payload)
    assert port.payload["name"] == "region" and port.payload["dur_s"] >= 0


def _write_streams(d: pathlib.Path):
    d.mkdir()
    r0 = [{"t": 1.0, "wall": 100.0, "process": 0, "kind": "step_stats",
           "step": 10, "payload": {}},
          {"t": 2.0, "wall": 102.0, "process": 0, "kind": "span",
           "step": None, "payload": {"name": "a", "dur_s": 0.5,
                                     "wall0": 101.5, "tid": 1}}]
    r1 = [{"t": 5.0, "wall": 100.25, "process": 1, "kind": "step_stats",
           "step": 10, "payload": {}},
          {"t": 6.0, "wall": 101.0, "process": 1, "kind": "step_stats",
           "step": 20, "payload": {}}]
    (d / "events_r0.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in r0))
    (d / "events_r1.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in r1) + '{"t": 7.0, "wal')
    dump = d / "flight_r0.abc-1.json"
    dump.write_text(json.dumps({"events": [
        {"t": 0.5, "wall": 99.0, "process": 0, "kind": "run_started",
         "step": 0, "payload": {}}]}))
    return [d, dump]


def test_merge_matches_igg(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    inputs = _write_streams(tmp_path / "in")
    got = tel.merge_streams(inputs, tmp_path / "port.jsonl")
    want = igg_tel.merge_streams(inputs, tmp_path / "igg.jsonl")
    assert got == want
    assert got[-1]["kind"] == "merge_summary"
    assert got[-1]["payload"]["skipped_lines"] == 1
    assert got[-1]["payload"]["rank_wall_offsets"] == {"1": 0.25}
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "igg.jsonl").read_bytes()
    # The CLI (`python -m igg_torch.telemetry merge`), with its merged
    # Chrome trace.
    assert tel._main(["merge", "--trace", str(tmp_path / "pt.json"),
                      str(tmp_path / "cli_port.jsonl"), *map(str, inputs)]) == 0
    assert igg_tel._main(["merge", "--trace", str(tmp_path / "it.json"),
                          str(tmp_path / "cli_igg.jsonl"),
                          *map(str, inputs)]) == 0
    assert (tmp_path / "cli_port.jsonl").read_bytes() == \
        (tmp_path / "igg.jsonl").read_bytes()
    assert (tmp_path / "pt.json").read_bytes() == \
        (tmp_path / "it.json").read_bytes()
    assert tel._main(["bogus"]) == 2
    with pytest.raises(it.GridError):
        tel.merge_streams([tmp_path / "empty_dir_missing"])


def test_flight_recorder_is_bounded(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_FLIGHT_RECORDER", "4")
    monkeypatch.setattr(tel, "_RING", None)
    for i in range(10):
        tel.emit("tick", step=i)
    assert [r.step for r in tel.flight_recorder()] == [6, 7, 8, 9]
    (path,) = tel.dump_flight_recorder("asked", path=tmp_path / "f.json")
    doc = json.loads(path.read_text())
    assert doc["reason"] == "asked" and len(doc["events"]) == 4
    monkeypatch.delenv("IGG_TELEMETRY_DIR", raising=False)
    assert tel.dump_flight_recorder("nowhere") == []


def test_session_files_match_igg(tmp_path):
    names = []
    for mod, d in ((tel, tmp_path / "port"), (igg_tel, tmp_path / "igg")):
        with pytest.raises(ValueError):
            with mod.Telemetry(d):
                mod.emit("run_started", run="x")
                mod.counter("port_c_total").inc()
                with mod.span("region"):
                    pass
                raise ValueError("boom")
        names.append(sorted(p.name.split(".")[0] + p.suffix
                            for p in d.iterdir()))
        events = [json.loads(line) for line in
                  (d / "events_r0.jsonl").read_text().splitlines()]
        assert [e["kind"] for e in events] == ["run_started", "span"]
        assert "port_c_total 1.0" in (d / "metrics_r0.prom").read_text()
        assert mod.flight_dumps(d, rank=0)
    assert names[0] == names[1] == sorted(
        ["events_r0.jsonl", "flight_r0.json", "metrics_r0.jsonl",
         "metrics_r0.prom", "trace_r0.json"])


def test_as_session_coercions(tmp_path, monkeypatch):
    monkeypatch.delenv("IGG_TELEMETRY_DIR", raising=False)
    assert tel.as_session(False) is None
    assert tel.as_session(None) is None
    with pytest.raises(it.GridError):
        tel.as_session(True)
    s = tel.Telemetry(tmp_path)
    assert tel.as_session(s) is s
    assert tel.as_session(str(tmp_path)).dir == tmp_path
    assert tel.as_session(tmp_path / "p").dir == tmp_path / "p"
    with pytest.raises(it.GridError):
        tel.as_session(3)
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path / "env"))
    assert tel.as_session(None).dir == tmp_path / "env"
    assert tel.as_session(True).dir == tmp_path / "env"
    assert tel.as_session(False) is None


def test_span_and_device_knobs(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY_SPANS", "0")
    before = len(tel.flight_recorder())
    with tel.span("off"):
        pass
    assert len(tel.flight_recorder()) == before
    monkeypatch.setenv("IGG_TELEMETRY_SPANS", "1")
    monkeypatch.setenv("IGG_TELEMETRY_DEVICE", "0")
    assert tel._device_annotation("x") is None
    monkeypatch.setenv("IGG_TELEMETRY_DEVICE", "1")
    assert isinstance(tel._device_annotation("x"),
                      torch.profiler.record_function)
    with tel.span("on"):
        pass
    assert tel.flight_recorder()[-1].payload["name"] == "on"


def test_env_registry_and_parsing(monkeypatch):
    assert sorted(t_env._KNOWN) == sorted(igg_env._KNOWN)
    monkeypatch.setattr(t_env, "_warned_unknown", False)
    monkeypatch.setenv("IGG_VERIFY_KERNEL", "1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t_env.flag("IGG_VERIFY_KERNELS")
        t_env.flag("IGG_VERIFY_KERNELS")
    hits = [w for w in caught if "IGG_VERIFY_KERNEL" in str(w.message)]
    assert len(hits) == 1
    for name, value, fn in (("IGG_TELEMETRY_FLIGHT_RECORDER", "ten",
                             t_env.integer),
                            ("IGG_TELEMETRY_METRICS_EVERY", "soon",
                             t_env.number),
                            ("IGG_VERIFY_KERNELS", "maybe", t_env.flag)):
        monkeypatch.setenv(name, value)
        with pytest.raises(it.GridError, match=name):
            fn(name, 0) if fn is not t_env.flag else fn(name)
    with pytest.raises(it.GridError):
        t_env.register("NOT_IGG", "x")


def test_profiling_trace(tmp_path, monkeypatch):
    logdir = tmp_path / "a" / "b" / "c"
    with profiling.trace(logdir) as d:
        assert d == logdir and logdir.is_dir()
        with pytest.raises(it.GridError, match="already active"):
            with profiling.trace(tmp_path / "nested"):
                pass
        with tel.span("traced.region"):
            torch.ones(4).sum()
    kinds = [r.kind for r in tel.flight_recorder()]
    assert kinds.count("trace_started") >= 1 and kinds[-1] == "trace_stopped"
    names = {e.get("name") for e in json.loads(
        profiling.trace_file(logdir).read_text())["traceEvents"]}
    assert "traced.region" in names

    class Broken:
        def __init__(self, **kw):
            pass

        def start(self):
            raise RuntimeError("profiler refused to start")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="refused"):
        with profiling.trace(tmp_path / "broken"):
            pass
    monkeypatch.undo()
    with profiling.trace(tmp_path / "again"):   # the lock was released
        pass


def test_telemetry_adds_no_host_syncs(tmp_path, monkeypatch):
    """The port's form of igg's zero-host-syncs sentinel: every call that
    reads a tensor on the host (`item`, `tolist`, `cpu`, `numpy`,
    `torch.cuda.synchronize`) during a `make_multi_step` loop is counted,
    with telemetry off and with a session and spans attached; the counts
    are equal."""
    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodz=1,
                        device="cpu", nprocs=8, quiet=True)
    p = t3.Params()
    T, Cp = t3.init_fields(p)
    step = t3.make_multi_step(3, p)
    calls = []
    for name in ("item", "tolist", "cpu", "numpy"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: calls.append("synchronize"))

    def loop(spans):
        calls.clear()
        S = T
        for i in range(4):
            if spans:
                with tel.span("step", step=i):
                    S = step(S, Cp)
            else:
                S = step(S, Cp)
        return list(calls), S

    bare, S0 = loop(False)
    with tel.Telemetry(tmp_path):
        observed, S1 = loop(True)
    assert observed == bare
    assert torch.equal(S0, S1)
    assert sum(1 for r in tel.flight_recorder() if r.kind == "span") >= 4


def test_comm_monitor_and_heartbeat_add_no_host_syncs(tmp_path,
                                                      monkeypatch):
    """The sentinel over `run_resilient`, as igg's extended one: with a
    `StepDecomposition` attached and the stall heartbeat on (a 0.05 s
    timeout, so its thread polls the probes while the loop runs), the
    calls that read a tensor on the host equal the bare loop's (no
    monitor, heartbeat off), and so does the final state."""
    from igg_torch import comm

    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodz=1,
                        device="cpu", nprocs=8, quiet=True)
    p = t3.Params()
    T, Cp = t3.init_fields(p)
    step = t3.make_step(p)
    fn = lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}  # noqa: E731
    mv = comm.model_step_variants("diffusion3d", p)
    monitor = comm.StepDecomposition(mv["compute"], (T,), aux=(Cp,), reps=1)
    calls = []
    for name in ("item", "tolist", "cpu", "numpy"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: calls.append("synchronize"))

    def run(observed):
        calls.clear()
        monkeypatch.setenv("IGG_COMM_STALL_TIMEOUT",
                           "0.05" if observed else "0")
        res = it.run_resilient(fn, {"T": T, "Cp": Cp}, 40, watch_every=4,
                               comm=monitor if observed else None,
                               install_sigterm=False)
        return list(calls), res.state["T"]

    bare, S0 = run(False)
    with tel.Telemetry(tmp_path):
        observed, S1 = run(True)
    assert observed == bare and bare
    assert torch.equal(S0, S1)
    assert monitor.windows >= 1


def test_integrity_probes_and_shadows_add_no_host_syncs(monkeypatch):
    """The sentinel over `run_resilient` with the integrity layer on, its
    invariant sums and a shadow re-execution every window fused into the
    watchdog's probe: the calls that read a tensor on the host equal the
    bare loop's (the probe's one copy a window), and so does the final
    state."""
    from igg_torch import integrity

    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodz=1,
                        device="cpu", nprocs=8, quiet=True)
    p = t3.Params()
    T, Cp = t3.init_fields(p)
    step = t3.make_step(p)
    fn = lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}  # noqa: E731
    cfg = integrity.IntegrityConfig(
        invariants=[integrity.Invariant("total_heat", ("T",)),
                    integrity.Invariant("energy", ("T",), moment=2,
                                        kind="bounded")],
        check_every=1, tol=1.0)
    calls = []
    for name in ("item", "tolist", "cpu", "numpy"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: calls.append("synchronize"))

    def run(checked):
        calls.clear()
        res = it.run_resilient(fn, {"T": T, "Cp": Cp}, 40, watch_every=4,
                               integrity=cfg if checked else False,
                               install_sigterm=False)
        return list(calls), res

    shadows = tel.counter("igg_integrity_shadow_checks_total",
                          run="resilient")
    before = shadows.value
    bare, r0 = run(False)
    observed, r1 = run(True)
    assert observed == bare and bare
    assert torch.equal(r0.state["T"], r1.state["T"])
    assert [e.kind for e in r1.events] == []
    assert shadows.value - before == 10          # every window shadowed


def test_modules_import_neither_jax_nor_igg():
    """`igg_torch` with its telemetry, profiling, knob and ladder modules
    imports neither JAX nor anything of igg."""
    code = ("import sys, igg_torch, igg_torch._env, igg_torch.telemetry, "
            "igg_torch.profiling, igg_torch.degrade\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'igg' or m.startswith('igg.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=pathlib.Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr
