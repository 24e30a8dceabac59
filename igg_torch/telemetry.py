"""igg_torch.telemetry — one event bus, one metrics registry and trace
spans for the port (the port of `igg/telemetry.py`, with igg's names,
payloads and file names, so that streams of both packages merge and read
alike).

- **Event bus.**  :func:`emit` stamps every incident as a typed
  :class:`Record` `(t, wall, process, kind, step, payload)`: `t` is
  `time.monotonic()` (ordering within a process), `wall` is epoch seconds
  (merging across processes), `process` the `torch.distributed` rank (0
  where no process group is initialized).  Every record lands in the
  bounded in-memory **flight recorder** ring (a deque append, no I/O) and,
  when a :class:`Telemetry` session is attached, in that session's
  rank-tagged `events_r<rank>.jsonl`.  The tier ladder
  (:mod:`igg_torch.degrade`) and the profiler (:mod:`igg_torch.profiling`)
  emit here.

- **Flight recorder.**  The ring keeps the last N records
  (`IGG_TELEMETRY_FLIGHT_RECORDER`, default 512);
  :func:`dump_flight_recorder` writes it as `flight_r<rank>.<run-id>.json`,
  and a session dumps it when an exception leaves its `with` block.

- **Metrics registry.**  :func:`counter` / :func:`gauge` /
  :func:`histogram` get-or-create named instruments (optional labels);
  :func:`snapshot` returns the registry as a plain dict,
  :func:`prometheus_text` renders the Prometheus text exposition.  A
  session exports both at detach (`metrics_r<rank>.jsonl`,
  `metrics_r<rank>.prom`) and every `IGG_TELEMETRY_METRICS_EVERY` seconds
  where a caller asks (:meth:`Telemetry.maybe_export_metrics`).  The port
  maintains `igg_halo_plane_bytes_total` (`igg_torch.update_halo`),
  `igg_tier_dispatch_total{family,tier}` and `igg_tier_quarantined_total`
  (the tier ladder), the resilient loop's `igg_steps_total`,
  `igg_rollbacks_total` and the :class:`StepStats` gauges, and the
  integrity monitor's `igg_integrity_checks_total`,
  `igg_integrity_shadow_checks_total` and
  `igg_integrity_violations_total` (:mod:`igg_torch.integrity`, whose
  events are `integrity_config`, `integrity_degraded`,
  `integrity_violation` and `integrity_resolved`).

- **Run-loop hooks.**  :class:`StepStats` turns the watchdog's probe
  fetches into `step_stats` records and step-rate gauges;
  :func:`_auto_dump` dumps the flight recorder where a sink is
  configured when a run fails or is preempted.

- **Trace spans.**  :func:`span` records a named host-side region as a
  `span` record and mirrors it onto the profiler's timeline as a
  `torch.profiler.record_function` (so spans line up with the device
  trace of :func:`igg_torch.profiling.trace`); :func:`export_chrome_trace`
  renders spans as Chrome-trace/Perfetto JSON (a session writes
  `trace_r<rank>.json` at detach).  Span durations are host time.

- **Multihost merge.**  `python -m igg_torch.telemetry merge out.jsonl
  dir-or-files...` merge-sorts rank-tagged JSONL streams by wall time.

No call of this module synchronizes the device: it reads no tensor.

A session is a directory::

    with igg_torch.telemetry.Telemetry("/path/run1"):
        T = step(T, Cp)
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from . import _env
from .shared import GridError

__all__ = [
    "Record", "Telemetry", "emit", "span", "counter", "gauge", "histogram",
    "snapshot", "metric_samples", "prometheus_text", "reset_metrics",
    "flight_recorder", "dump_flight_recorder", "flight_dumps", "run_id",
    "export_chrome_trace", "as_session", "merge_streams", "subscribe",
    "unsubscribe", "StepStats",
]


# ---------------------------------------------------------------------------
# Records and the process-global bus
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Record:
    """One bus record: `t` monotonic seconds (in-process ordering), `wall`
    epoch seconds (cross-process merging), `process` the rank, `kind` the
    event name, `step` the step count it is anchored to (None for
    step-less events), `payload` the kind-specific detail."""
    t: float
    wall: float
    process: int
    kind: str
    step: Optional[int] = None
    payload: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"t": self.t, "wall": self.wall, "process": self.process,
                "kind": self.kind, "step": self.step,
                "payload": self.payload}


_lock = threading.RLock()
_RING: Optional[deque] = None        # created lazily (size is an env knob)
_SESSIONS: List["Telemetry"] = []    # attached sinks
_SUBSCRIBERS: List = []              # live bus consumers
# Per-run dump identity: dumps are named `flight_r<rank>.<id>.json`, the id
# a process-unique token plus a run sequence number (rotated on every
# `run_started` record), so two runs sharing a directory keep both dumps.
_RUN_BASE = f"{os.getpid():x}{int(time.time()) & 0xFFFF:04x}"
_RUN_SEQ = 0


def _process() -> int:
    """The rank that stamps records: `torch.distributed`'s where a process
    group is initialized, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _ring() -> deque:
    global _RING
    if _RING is None:
        with _lock:
            if _RING is None:
                size = max(1, int(_env.integer(
                    "IGG_TELEMETRY_FLIGHT_RECORDER", 512)))
                _RING = deque(maxlen=size)
    return _RING


def run_id() -> str:
    """The current flight-dump identity: a process-unique token plus the
    run sequence number (rotated on every ``run_started`` record), the
    suffix of `flight_r<rank>.<id>.json` dumps."""
    return f"{_RUN_BASE}-{_RUN_SEQ}"


def emit(kind: str, step: Optional[int] = None, **payload) -> Record:
    """Stamp and publish one record: append it to the flight-recorder ring
    and hand it to every attached session and subscriber.  Host
    bookkeeping only: no device work, no synchronization."""
    if kind == "run_started":
        global _RUN_SEQ
        with _lock:
            _RUN_SEQ += 1
    rec = Record(t=time.monotonic(), wall=time.time(), process=_process(),
                 kind=kind, step=None if step is None else int(step),
                 payload=payload)
    # Appends and snapshots share the lock: a record emitted from another
    # thread must not race a snapshot of the ring.
    with _lock:
        _ring().append(rec)
    if _SESSIONS:
        with _lock:
            sessions = list(_SESSIONS)
        for s in sessions:
            s._write_record(rec)
    if _SUBSCRIBERS:
        with _lock:
            subs = list(_SUBSCRIBERS)
        for fn in subs:
            try:
                fn(rec)
            except Exception:
                # A broken consumer must never kill the run it observes.
                pass
    return rec


def subscribe(fn) -> None:
    """Register a live bus consumer: `fn(record)` is called for every
    later :func:`emit`, on the emitting thread.  Consumers must be fast
    and must not raise (exceptions are swallowed)."""
    with _lock:
        if fn not in _SUBSCRIBERS:
            _SUBSCRIBERS.append(fn)


def unsubscribe(fn) -> None:
    """Remove a consumer registered with :func:`subscribe` (idempotent)."""
    with _lock:
        if fn in _SUBSCRIBERS:
            _SUBSCRIBERS.remove(fn)


def flight_recorder() -> List[Record]:
    """The flight-recorder ring's current contents, oldest first."""
    ring = _ring()
    with _lock:
        return list(ring)


def _flight_name() -> str:
    """Rank- and run-tagged dump filename: dumps within one run overwrite
    (latest wins), two runs sharing a directory never clobber each
    other."""
    return f"flight_r{_process()}.{run_id()}.json"


def flight_dumps(directory, rank: Optional[int] = None) -> List[pathlib.Path]:
    """Every flight-recorder dump under `directory`, newest first, in both
    of igg's filename forms: `flight_r<rank>.json` and
    `flight_r<rank>.<id>.json`."""
    d = pathlib.Path(directory)
    try:
        if rank is None:
            found = list(d.glob("flight_r*.json"))
        else:
            # Two exact-rank patterns, not a prefix glob: `flight_r1*`
            # would also match ranks 10-19.
            found = list(d.glob(f"flight_r{rank}.*.json"))
            legacy = d / f"flight_r{rank}.json"
            if legacy.exists():
                found.append(legacy)
    except OSError:
        return []
    return sorted(found, key=lambda p: p.stat().st_mtime, reverse=True)


def dump_flight_recorder(reason: str = "requested",
                         path=None) -> List[pathlib.Path]:
    """Dump the ring as JSON: to every attached session's
    `flight_r<rank>.<run-id>.json`, to `path` when given, and, with
    neither, to `IGG_TELEMETRY_DIR` when set.  Returns the paths written
    (empty when there is nowhere to write)."""
    recs = [r.as_dict() for r in flight_recorder()]
    doc = {"reason": reason, "wall": time.time(),
           "process": _process(), "run_id": run_id(), "events": recs}
    out: List[pathlib.Path] = []
    targets: List[pathlib.Path] = []
    if path is not None:
        targets.append(pathlib.Path(path))
    with _lock:
        sessions = list(_SESSIONS)
    for s in sessions:
        targets.append(s.dir / _flight_name())
    if not targets:
        envdir = _env.text("IGG_TELEMETRY_DIR")
        if envdir:
            targets.append(pathlib.Path(envdir) / _flight_name())
    for t in targets:
        try:
            t.parent.mkdir(parents=True, exist_ok=True)
            tmp = t.with_name(t.name + ".tmp")
            tmp.write_text(json.dumps(doc, default=str))
            os.replace(tmp, t)
            out.append(t)
        except OSError:
            continue   # a full or read-only disk must not mask the fault
    return out


def _auto_dump(reason: str) -> List[pathlib.Path]:
    """The run loop's fault hook: dump the flight recorder wherever a sink
    is configured (an attached session or `IGG_TELEMETRY_DIR`); a no-op
    when telemetry is unconfigured.  Returns the paths written, so a
    :class:`igg_torch.resilience.ResilienceError` can name them."""
    with _lock:
        have_session = bool(_SESSIONS)
    if have_session or _env.text("IGG_TELEMETRY_DIR"):
        return dump_flight_recorder(reason)
    return []


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

_METRICS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], "_Metric"] = {}
# One name, one type, across label sets too (one `# TYPE x` line cannot
# cover a counter and a gauge of the same name).
_KIND_BY_NAME: Dict[str, type] = {}
# `# HELP` strings: a name registered with `help=` first, this table of the
# names the port maintains second (igg's texts for igg's names).
_HELP_BY_NAME: Dict[str, str] = {}
_BUILTIN_HELP: Dict[str, str] = {
    "igg_steps_total": "Steps completed by a run loop.",
    "igg_rollbacks_total": "Checkpoint rollbacks taken by a run loop.",
    "igg_steps_per_s": "Live step rate of the last watchdog window.",
    "igg_watchdog_fetch_lag_steps": "Steps between the last fetched "
                                    "watchdog probe and the loop's "
                                    "current step.",
    "igg_rank_window_ms": "This rank's last watchdog-window ms/step "
                          "(the live straggler signal).",
    "igg_halo_plane_bytes_total": "Halo plane bytes moved by "
                                  "update_halo (per dim and wire/local "
                                  "mode when labelled).",
    "igg_hide_communication_traces_total": "hide_communication overlap "
                                           "schedules traced.",
    "igg_tier_dispatch_total": "Dispatches served per (family, tier) by "
                               "the degradation ladder.",
    "igg_tier_quarantined_total": "Kernel tiers quarantined by the "
                                  "degradation ladder.",
    "igg_integrity_checks_total": "Clean integrity verdicts decoded from "
                                  "fetched watchdog probes "
                                  "(igg.integrity).",
    "igg_integrity_shadow_checks_total": "Shadow re-execution comparisons "
                                         "completed (igg.integrity).",
    "igg_integrity_violations_total": "Silent-data-corruption verdicts "
                                      "raised (invariant drift or shadow "
                                      "mismatch; igg.integrity).",
    "igg_member_steps_total": "Member-steps completed by run_ensemble (steps"
                              " times active members).",
    "igg_member_steps_per_s": "Live aggregate member-step rate of the last "
                              "ensemble watchdog window.",
    "igg_rank_skew_ms": "Worst-vs-median window time across ranks "
                        "(igg.comm.rank_skew).",
    "igg_checkpoint_bytes_total": "Bytes written into checkpoint generations.",
    "igg_checkpoint_write_seconds": "Checkpoint generation write latency.",
    "igg_halo_gbps": "Measured halo-exchange bandwidth over the logical halo"
                     " bytes.",
    "igg_pct_link_peak": "Measured wire-crossing halo bandwidth as a "
                         "percentage of the chip's published ICI peak.",
    "igg_achieved_gbps": "Achieved HBM bandwidth of the serving kernel tier "
                         "(igg.perf).",
    "igg_pct_hbm_peak": "Achieved HBM bandwidth as a percentage of the "
                        "chip's published peak (igg.perf).",
    "igg_cost_model_rel_error": "Relative error of the registered cost-model"
                                " prediction vs measured step time.",
    "igg_exposed_comm_fraction": "Exposed communication fraction (exchange -"
                                 " compute) / exchange of the last "
                                 "decomposition window.",
    "igg_overlap_efficiency": "Overlap efficiency (exchange - hidden) / "
                              "(exchange - compute) of the last "
                              "decomposition window.",
    "igg_member_quarantined_total": "Ensemble members quarantined after "
                                    "retry-budget exhaustion.",
    "igg_fleet_queue_depth": "Fleet jobs not yet terminal this drain.",
    "igg_fleet_jobs_total": "Fleet jobs finished, by outcome status.",
    "igg_hbm_bytes_in_use": "Device memory currently allocated "
                            "(device.memory_stats; absent when the backend "
                            "exposes no allocator stats).",
    "igg_hbm_bytes_limit": "Device memory capacity visible to the allocator "
                           "(absent when the backend exposes no allocator "
                           "stats).",
    "igg_hbm_watermark_bytes": "Peak device memory allocated since process "
                               "start (absent when the backend exposes no "
                               "allocator stats).",
    "igg_statusd_requests_total": "HTTP requests served by igg.statusd, by "
                                  "route.",
}


class _Metric:
    kind = "untyped"

    __slots__ = ("name", "labels", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    def key(self) -> str:
        if not self.labels:
            return self.name
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return f"{self.name}{{{inner}}}"

    def as_dict(self) -> dict:   # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    """Monotone counter (`.inc(v)`); `.value` reads it."""
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise GridError(f"Counter {self.name}: negative increment {v}.")
        with self._lock:
            self.value += v

    def as_dict(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge(_Metric):
    """Last-write-wins instantaneous value (`.set(v)`)."""
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def as_dict(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram(_Metric):
    """Streaming summary (`.observe(v)`): count, sum, min, max."""
    kind = "histogram"
    __slots__ = ("count", "sum", "min", "max")

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def as_dict(self) -> dict:
        return {"type": self.kind, "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}


def _get_metric(cls, name: str, labels: dict, help: Optional[str]) -> _Metric:
    lab = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    key = (name, lab)
    if help is not None:
        with _lock:
            _HELP_BY_NAME[name] = str(help)
    m = _METRICS.get(key)
    if m is None:
        with _lock:
            m = _METRICS.get(key)
            if m is None:
                have = _KIND_BY_NAME.get(name)
                if have is not None and have is not cls:
                    raise GridError(
                        f"metric {name!r} is a {have.kind}, not a "
                        f"{cls.kind} — one name, one type (across every "
                        f"label set).")
                _KIND_BY_NAME[name] = cls
                m = _METRICS[key] = cls(name, lab)
    if not isinstance(m, cls):
        raise GridError(f"metric {name!r} is a {m.kind}, not a "
                        f"{cls.kind} — one name, one type.")
    return m


def metric_help(name: str) -> Optional[str]:
    """The `# HELP` string of a metric name (explicit `help=` first, the
    built-in table second, None when neither knows the name)."""
    return _HELP_BY_NAME.get(name, _BUILTIN_HELP.get(name))


def counter(name: str, help: Optional[str] = None, **labels) -> Counter:
    """Get-or-create the named counter (optional labels; `help` becomes
    the exposition's `# HELP` line)."""
    return _get_metric(Counter, name, labels, help)


def gauge(name: str, help: Optional[str] = None, **labels) -> Gauge:
    return _get_metric(Gauge, name, labels, help)


def histogram(name: str, help: Optional[str] = None, **labels) -> Histogram:
    return _get_metric(Histogram, name, labels, help)


def snapshot() -> Dict[str, dict]:
    """The whole registry as `{exposition-key: {type, value|count/sum/
    min/max}}`, a plain JSON-serializable dict."""
    with _lock:
        metrics = list(_METRICS.values())
    return {m.key(): m.as_dict() for m in metrics}


def reset_metrics() -> None:
    """Clear the registry (`finalize_global_grid` leaves metrics alone:
    they are process-scoped, like the flight recorder)."""
    with _lock:
        _METRICS.clear()
        _KIND_BY_NAME.clear()
        _HELP_BY_NAME.clear()


def metric_samples() -> List[dict]:
    """The registry as structured samples: one ``{name, labels, type,
    help, ...values}`` dict per metric instance (:func:`snapshot` with the
    labels kept structured)."""
    with _lock:
        metrics = list(_METRICS.values())
    return [{"name": m.name, "labels": dict(m.labels),
             "help": metric_help(m.name), **m.as_dict()} for m in metrics]


def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _prom_label_value(v: str) -> str:
    """Escape a label value per the Prometheus text format (backslash,
    double quote and newline)."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_help_value(v: str) -> str:
    """Escape a `# HELP` text (backslash and newline only)."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def prometheus_text() -> str:
    """The registry in the Prometheus text exposition format (histograms
    render as summaries: `_count`/`_sum`, plus `_min`/`_max`).  Names with
    a help string get a `# HELP` line ahead of their `# TYPE`."""
    with _lock:
        metrics = list(_METRICS.values())
    by_name: Dict[str, List[_Metric]] = {}
    for m in metrics:
        by_name.setdefault(m.name, []).append(m)
    out = io.StringIO()
    for name in sorted(by_name):
        group = by_name[name]
        pname = _prom_name(name)
        kind = group[0].kind
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "summary"}[kind]
        help_text = metric_help(name)
        if help_text:
            out.write(f"# HELP {pname} {_prom_help_value(help_text)}\n")
        out.write(f"# TYPE {pname} {ptype}\n")
        for m in sorted(group, key=lambda g: g.labels):
            lab = ("{" + ",".join(
                f'{_prom_name(k)}="{_prom_label_value(v)}"'
                for k, v in m.labels) + "}"
                   if m.labels else "")
            if kind == "histogram":
                out.write(f"{pname}_count{lab} {m.count}\n")
                out.write(f"{pname}_sum{lab} {m.sum}\n")
                if m.count:
                    out.write(f"{pname}_min{lab} {m.min}\n")
                    out.write(f"{pname}_max{lab} {m.max}\n")
            else:
                out.write(f"{pname}{lab} {m.value}\n")
    return out.getvalue()


# ---------------------------------------------------------------------------
# Trace spans
# ---------------------------------------------------------------------------

def _device_annotation(name: str):
    """A `torch.profiler.record_function` mirroring a host span onto the
    profiler's timeline, or None while `IGG_TELEMETRY_DEVICE=0`.  A
    failure to open one raises: nothing is disabled quietly."""
    if not _env.flag("IGG_TELEMETRY_DEVICE", True):
        return None
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, step: Optional[int] = None, **attrs):
    """Record the enclosed block as a named trace span: one `span` record
    on the bus (payload: name, dur_s, start timestamps, thread id, attrs)
    and a `torch.profiler.record_function` on the profiler's timeline.
    `IGG_TELEMETRY_SPANS=0` turns capture off (the block still runs).
    The duration is host time: the device is not waited for."""
    if not _env.flag("IGG_TELEMETRY_SPANS", True):
        yield
        return
    dev = _device_annotation(name)
    t0 = time.monotonic()
    w0 = time.time()
    if dev is not None:
        dev.__enter__()
    try:
        yield
    finally:
        if dev is not None:
            dev.__exit__(None, None, None)
        dur = time.monotonic() - t0
        emit("span", step=step, name=name, dur_s=dur, t0=t0, wall0=w0,
             tid=threading.get_ident(), **attrs)


def _chrome_events(records: Sequence[Record]) -> List[dict]:
    out = []
    for r in records:
        if r.kind != "span":
            continue
        p = r.payload
        out.append({
            "name": p.get("name", "span"), "cat": "igg", "ph": "X",
            "ts": p.get("wall0", r.wall) * 1e6,
            "dur": max(p.get("dur_s", 0.0), 0.0) * 1e6,
            "pid": r.process, "tid": p.get("tid", 0),
            "args": {k: v for k, v in p.items()
                     if k not in ("name", "dur_s", "t0", "wall0", "tid")},
        })
    return out


def export_chrome_trace(path, records: Optional[Sequence[Record]] = None
                        ) -> pathlib.Path:
    """Write the span records (default: the flight-recorder ring's) as a
    Chrome-trace/Perfetto JSON object (`{"traceEvents": [...]}`).
    Timestamps are wall-clock microseconds, so traces of several processes
    overlay.  The producer is named "igg.telemetry", the schema's name:
    the port writes igg's format."""
    recs = list(records) if records is not None else flight_recorder()
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"traceEvents": _chrome_events(recs),
           "displayTimeUnit": "ms",
           "metadata": {"producer": "igg.telemetry",
                        "process": _process()}}
    path.write_text(json.dumps(doc, default=str))
    return path


# ---------------------------------------------------------------------------
# Sessions: per-run JSONL sinks and exports
# ---------------------------------------------------------------------------

class Telemetry:
    """One observability session rooted at a directory.  While attached
    (a context manager, or :meth:`attach`/:meth:`detach`) every bus record
    is appended to `events_r<rank>.jsonl`; metrics snapshots go to
    `metrics_r<rank>.jsonl` and `metrics_r<rank>.prom` at detach (and
    every `metrics_every` seconds through :meth:`maybe_export_metrics`;
    default `IGG_TELEMETRY_METRICS_EVERY`, 0 = at detach only), the span
    trace to `trace_r<rank>.json` at detach, and the flight recorder to
    `flight_r<rank>.<run-id>.json` when an exception leaves the `with`
    block.  Sessions stack: the bus fans every record out to all attached
    sessions.  Attach after `torch.distributed.init_process_group` where
    there is one, so that the files carry the rank."""

    def __init__(self, dir, *, metrics_every: Optional[float] = None):
        self.dir = pathlib.Path(dir)
        self.metrics_every = (float(metrics_every)
                              if metrics_every is not None
                              else _env.number(
                                  "IGG_TELEMETRY_METRICS_EVERY", 0.0))
        self.attached = False
        self._events_fh = None
        # The trace export keeps the last N spans (the events JSONL keeps
        # them all).
        self._spans: deque = deque(maxlen=4096)
        self._last_metrics = 0.0
        self._io_lock = threading.Lock()

    # -- file naming (rank-tagged for the merge tool) ----------------------
    @property
    def events_path(self) -> pathlib.Path:
        return self.dir / f"events_r{_process()}.jsonl"

    @property
    def metrics_path(self) -> pathlib.Path:
        return self.dir / f"metrics_r{_process()}.jsonl"

    @property
    def prometheus_path(self) -> pathlib.Path:
        return self.dir / f"metrics_r{_process()}.prom"

    @property
    def trace_path(self) -> pathlib.Path:
        return self.dir / f"trace_r{_process()}.json"

    @property
    def flight_path(self) -> pathlib.Path:
        return self.dir / _flight_name()

    # -- lifecycle ---------------------------------------------------------
    def attach(self) -> "Telemetry":
        """Start sinking bus records into this session's directory
        (idempotent)."""
        with _lock:
            if self.attached:
                return self
            self.dir.mkdir(parents=True, exist_ok=True)
            self._events_fh = open(self.events_path, "a", buffering=1)
            self._last_metrics = time.monotonic()
            _SESSIONS.append(self)
            self.attached = True
        return self

    def detach(self) -> None:
        """Final exports (metrics snapshot, Prometheus file, Chrome trace)
        and stop sinking (idempotent)."""
        with _lock:
            if not self.attached:
                return
            self.attached = False
            if self in _SESSIONS:
                _SESSIONS.remove(self)
        self.export_metrics()
        try:
            export_chrome_trace(self.trace_path, self._spans)
        except OSError:
            pass
        with self._io_lock:
            if self._events_fh is not None:
                self._events_fh.close()
                self._events_fh = None

    def __enter__(self) -> "Telemetry":
        return self.attach()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            # Still attached, so this session's flight_path is a target.
            dump_flight_recorder(f"{exc_type.__name__}: {exc}")
        self.detach()

    # -- sinks -------------------------------------------------------------
    def _write_record(self, rec: Record) -> None:
        if rec.kind == "span":
            with self._io_lock:
                self._spans.append(rec)
        try:
            line = json.dumps(rec.as_dict(), default=str)
        except (TypeError, ValueError):
            line = json.dumps({**rec.as_dict(), "payload": str(rec.payload)})
        try:
            with self._io_lock:
                if self._events_fh is not None:
                    self._events_fh.write(line + "\n")
        except OSError:
            pass   # a full or read-only sink must never kill the run

    def maybe_export_metrics(self) -> bool:
        """Export when `metrics_every` seconds have passed since the last
        export (one clock read when not due)."""
        if not self.metrics_every:
            return False
        now = time.monotonic()
        if now - self._last_metrics < self.metrics_every:
            return False
        self.export_metrics()
        return True

    def export_metrics(self) -> None:
        """Write one metrics snapshot line (JSONL) and rewrite the
        Prometheus exposition file."""
        self._last_metrics = time.monotonic()
        snap = {"t": time.monotonic(), "wall": time.time(),
                "process": _process(), "metrics": snapshot()}
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            with open(self.metrics_path, "a") as fh:
                fh.write(json.dumps(snap, default=str) + "\n")
            tmp = self.prometheus_path.with_name(
                self.prometheus_path.name + ".tmp")
            tmp.write_text(prometheus_text())
            os.replace(tmp, self.prometheus_path)
        except OSError:
            pass   # an export must never kill the run


def as_session(telemetry) -> Optional[Telemetry]:
    """Coerce a `telemetry=` argument: None → a session under
    `IGG_TELEMETRY_DIR` when that is set (else no session); True → the env
    directory (GridError when unset); a str/Path → a session at that
    directory; a :class:`Telemetry` → itself; False → off even when the
    env knob is set."""
    if telemetry is False:
        return None
    if isinstance(telemetry, Telemetry):
        return telemetry
    if telemetry is None or telemetry is True:
        envdir = _env.text("IGG_TELEMETRY_DIR")
        if envdir:
            return Telemetry(envdir)
        if telemetry is True:
            raise GridError(
                "telemetry=True needs a directory: set IGG_TELEMETRY_DIR "
                "or pass telemetry=<dir> / a Telemetry session.")
        return None
    if isinstance(telemetry, (str, os.PathLike)):
        return Telemetry(telemetry)
    raise GridError(
        f"telemetry={telemetry!r}: expected None, False, True, a "
        f"directory path, or an igg_torch.telemetry.Telemetry session.")


# ---------------------------------------------------------------------------
# The step-stats meter (rides the watchdog's fetches)
# ---------------------------------------------------------------------------

class StepStats:
    """Per-window step rate with no host synchronization of its own.

    The resilient loop fetches its watchdog probes when they are ready;
    this meter timestamps each healthy fetch on the host and derives the
    rate from consecutive fetches (igg's `StepStats`).  A drain that
    fetches several probes back to back gives near-zero deltas; those
    windows are skipped (`_MIN_DT`).  Gauges `igg_steps_per_s`,
    `igg_watchdog_fetch_lag_steps` and `igg_rank_window_ms` (labelled
    `run`), and a `step_stats` record per window.  `perf` (an
    :func:`igg_torch.perf.sample_context` dict) also feeds each window's
    ms/step into the perf ledger, credited to the tiers that served a
    dispatch during the window (:func:`igg_torch.perf.observe_window`):
    host-side ladder bookkeeping on the same timestamps."""

    _MIN_DT = 1e-4

    def __init__(self, run: str, members: Optional[int] = None,
                 perf: Optional[dict] = None):
        self.run = run
        self.members = members
        self._anchor: Optional[Tuple[int, float]] = None
        self._sps = gauge("igg_steps_per_s", run=run)
        self._lag = gauge("igg_watchdog_fetch_lag_steps", run=run)
        self._win = gauge("igg_rank_window_ms", run=run)
        self._msps = gauge("igg_member_steps_per_s") if members else None
        self._perf_ctx = perf
        self._perf_state: Optional[dict] = None
        if perf is not None:
            from . import perf as _perf

            self._perf_state = _perf.window_state()

    def fetched(self, probe_step: int, current_step: int,
                active_members: Optional[int] = None) -> None:
        """One healthy probe was fetched (host side, after it was
        ready)."""
        now = time.monotonic()
        lag = max(0, current_step - probe_step)
        self._lag.set(lag)
        anchor = self._anchor
        self._anchor = (probe_step, now)
        if anchor is None:
            return
        dsteps = probe_step - anchor[0]
        dt = now - anchor[1]
        if dsteps <= 0 or dt < self._MIN_DT:
            return
        sps = dsteps / dt
        self._sps.set(sps)
        self._win.set(1e3 / sps)
        payload = {"run": self.run, "steps_per_s": sps,
                   "ms_per_step": 1e3 / sps, "window_steps": dsteps,
                   "fetch_lag_steps": lag}
        if active_members is not None:
            msps = sps * active_members
            payload["members_active"] = active_members
            payload["member_steps_per_s"] = msps
            if self._msps is not None:
                self._msps.set(msps)
        emit("step_stats", step=probe_step, **payload)
        if self._perf_ctx is not None:
            from . import perf as _perf

            _perf.observe_window(self.run, 1e3 / sps, dsteps,
                                 self._perf_ctx, self._perf_state)


# ---------------------------------------------------------------------------
# Multihost merge tool
# ---------------------------------------------------------------------------

def merge_streams(inputs: Sequence, output=None) -> List[dict]:
    """Merge rank-tagged event JSONL files into one stream ordered by wall
    time (ties broken by process, then monotonic t).  `inputs` are files or
    directories (directories contribute their `events_r*.jsonl`; a
    flight-recorder dump passed explicitly contributes its `events`);
    `output` is a path ('-' or None returns the records without writing).
    Unparsable lines are skipped and counted in a trailing
    `merge_summary` record (a killed process leaves a half-written line);
    with records of two ranks or more, the summary also estimates per-rank
    wall-clock offsets (:func:`_rank_wall_offsets`)."""
    files: List[pathlib.Path] = []
    for item in inputs:
        p = pathlib.Path(item)
        if p.is_dir():
            files.extend(sorted(p.glob("events_r*.jsonl")))
        else:
            files.append(p)
    if not files:
        raise GridError(f"telemetry merge: no event files found in "
                        f"{[str(i) for i in inputs]}.")
    records: List[dict] = []
    skipped = 0
    for f in files:
        try:
            text = f.read_text()
        except OSError as e:
            raise GridError(f"telemetry merge: cannot read {f}: {e}")
        if f.suffix == ".json":
            # A flight-recorder dump: its `events` merge like a stream.
            try:
                doc = json.loads(text)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(doc, dict) and isinstance(doc.get("events"), list):
                records.extend(r for r in doc["events"]
                               if isinstance(r, dict))
            else:
                skipped += 1
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                skipped += 1
    records.sort(key=lambda r: (r.get("wall", 0.0), r.get("process", 0),
                                r.get("t", 0.0)))
    offsets, matched = _rank_wall_offsets(records)
    if skipped or offsets:
        payload = {"skipped_lines": skipped,
                   "files": [str(f) for f in files]}
        if offsets:
            payload["rank_wall_offsets"] = offsets
            payload["offset_matched_records"] = matched
        records.append({"kind": "merge_summary", "process": -1,
                        "wall": time.time(), "payload": payload})
    if output is not None and str(output) != "-":
        out = pathlib.Path(output)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as fh:
            for r in records:
                fh.write(json.dumps(r, default=str) + "\n")
    return records


def _rank_wall_offsets(records: Sequence[dict]
                       ) -> Tuple[Dict[str, float], int]:
    """Per-rank wall-clock offsets against the lowest rank: the median
    pairwise wall delta over records that match on (kind, step), first
    occurrence per (kind, step, process) only (a replay re-emits steps).
    Returns ``({rank: offset_seconds}, matched_record_count)``, empty when
    fewer than two ranks share a step-anchored record."""
    first: Dict[Tuple, Dict[int, float]] = {}
    for r in records:
        if not isinstance(r, dict) or r.get("step") is None:
            continue
        kind = r.get("kind")
        if not kind or kind == "merge_summary":
            continue
        p = int(r.get("process", 0))
        by_proc = first.setdefault((kind, r["step"]), {})
        if p not in by_proc:
            by_proc[p] = float(r.get("wall", 0.0) or 0.0)
    ranks = sorted({p for by in first.values() for p in by})
    if len(ranks) < 2:
        return {}, 0
    ref = ranks[0]
    offsets: Dict[str, float] = {}
    matched = 0
    for p in ranks[1:]:
        deltas = sorted(by[p] - by[ref] for by in first.values()
                        if ref in by and p in by)
        if not deltas:
            continue
        matched += len(deltas)
        offsets[str(p)] = deltas[len(deltas) // 2]
    return offsets, matched


def _records_from_dicts(dicts: Sequence[dict]) -> List[Record]:
    """Merged JSONL dicts as :class:`Record`s (to feed the span exporter
    with cross-rank streams)."""
    out = []
    for r in dicts:
        if not isinstance(r, dict):
            continue
        out.append(Record(
            t=float(r.get("t", 0.0) or 0.0),
            wall=float(r.get("wall", 0.0) or 0.0),
            process=int(r.get("process", 0) or 0),
            kind=str(r.get("kind", "")), step=r.get("step"),
            payload=r.get("payload") if isinstance(r.get("payload"), dict)
            else {}))
    return out


def _main(argv: Sequence[str]) -> int:
    import sys

    usage = ("usage: python -m igg_torch.telemetry merge [--trace "
             "<trace.json>] <out.jsonl|-> <events.jsonl|session-dir> [...]")
    argv = list(argv)
    if len(argv) < 1 or argv[0] != "merge":
        print(usage, file=sys.stderr)
        return 2
    rest = argv[1:]
    trace_out = None
    if "--trace" in rest:
        i = rest.index("--trace")
        if i + 1 >= len(rest):
            print(usage, file=sys.stderr)
            return 2
        trace_out = rest[i + 1]
        del rest[i:i + 2]
    if len(rest) < 2:
        print(usage, file=sys.stderr)
        return 2
    out, inputs = rest[0], rest[1:]
    records = merge_streams(inputs, out)
    if trace_out is not None:
        # One Chrome trace over every rank's spans.
        spans = [r for r in _records_from_dicts(records)
                 if r.kind == "span"]
        export_chrome_trace(trace_out, spans)
        print(f"wrote merged Chrome trace ({len(spans)} span(s)) -> "
              f"{trace_out}", file=sys.stderr)
    if out == "-":
        for r in records:
            print(json.dumps(r, default=str))
    else:
        print(f"merged {len(records)} records from {len(inputs)} input(s) "
              f"-> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":   # python -m igg_torch.telemetry merge ...
    import sys

    sys.exit(_main(sys.argv[1:]))
