"""igg_torch.statusd — the live ops plane (the port of `igg/statusd.py`):
an always-on HTTP endpoint serving `/metrics`, `/healthz`, `/status` and
`/events` for a running simulation, with live gauges of the card's memory
and igg's multi-rank aggregation.

- **`/metrics`** renders :func:`igg_torch.telemetry.prometheus_text` at
  scrape time, the registry the `.prom` snapshot files export.  Where
  other ranks published snapshot files (below), rank 0's endpoint merges
  them into one exposition with a ``rank`` label.

- **`/healthz`** returns liveness (the server answered: it runs on its
  own threads, so it answers while the main loop is wedged) and
  READINESS, each failure with a machine-readable reason:

  ============================ ========================================
  reason                       source
  ============================ ========================================
  ``collective_stall``         a live :class:`igg_torch.comm.StallWatchdog`
                               episode (:func:`igg_torch.comm.active_stalls`);
                               recovers the moment the channel drains
  ``all_members_quarantined``  every ensemble member quarantined
  ``heal_escalated``           the heal engine walked its escalation
                               ladder
  ``watchdog_fetch_lag``       the watchdog's fetch lag exceeds
                               ``IGG_STATUSD_MAX_FETCH_LAG`` steps
  ``integrity_violation``      a live silent-data-corruption verdict
                               (:mod:`igg_torch.integrity`), cleared by
                               the ``integrity_resolved`` record of a
                               verified rollback
  ``queue_saturated``          the :mod:`igg_torch.serve` admission queue
                               at its bound
  ============================ ========================================

- **`/status`** returns JSON: run progress and step rate (the
  ``step_stats`` windows), the serving tier per family
  (:func:`igg_torch.degrade.active`, the port's names: ``<family>.cuda``,
  ``<family>.plain``, ``<family>.overlap``) and the quarantine set, the
  fleet journal's per-status job counts, the serve scheduler's per-tenant
  table, the heal ledger, the checkpoint head, device memory and the
  other ranks' summaries.

- **`/events`** tails the flight-recorder ring as JSONL (``?n=``).

- **Device-memory gauges.**  At scrape time, at most every
  ``IGG_STATUSD_HBM_EVERY`` seconds, the server reads
  :func:`igg_torch.device.memory_stats` (PyTorch's caching allocator:
  ``torch.cuda.memory_allocated``, ``max_memory_allocated`` and the card's
  ``total_memory``; host-side lookups, no synchronization, no device work)
  and sets ``igg_hbm_bytes_in_use`` / ``igg_hbm_bytes_limit`` /
  ``igg_hbm_watermark_bytes`` per card.  `memory_allocated` counts the
  tensors, not the allocator's reserve.  On the CPU there are no stats
  and no gauge is published: never an invented number.

- **Multi-rank aggregation.**  A non-zero rank runs no HTTP server; its
  :class:`StatusServer` writes a snapshot ``statusd_r<rank>.json`` into
  the telemetry directory every ``IGG_STATUSD_PUBLISH_EVERY`` seconds and
  rank 0 merges the fresh ones.  The port runs in one process, so on the
  card only rank 0's half runs until the multi-GPU backend.

Wiring: the ``serve=`` knob of :func:`igg_torch.run_resilient`,
:func:`igg_torch.run_ensemble` and :func:`igg_torch.run_fleet` (None:
``IGG_STATUSD_PORT``-driven, off when unset or 0; an int port, 0 an
ephemeral one; True; a shared :class:`StatusServer`; False), or
standalone::

    srv = igg_torch.statusd.StatusServer(port=9100).start()
    ...
    srv.stop()          # releases the port

Everything here runs on statusd's own threads: the hot loop pays one bus
subscriber callback per emitted record.  ``python -m igg_torch.top``
renders the endpoint as a terminal dashboard.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from . import _env
from . import telemetry as _telemetry
from .shared import GridError

__all__ = ["StatusServer", "HealthState", "as_server"]


# Machine-readable /healthz reason strings (pinned by
# the tests; treat as API).
REASON_STALL = "collective_stall"
REASON_ALL_QUARANTINED = "all_members_quarantined"
REASON_ESCALATED = "heal_escalated"
REASON_FETCH_LAG = "watchdog_fetch_lag"
REASON_INTEGRITY = "integrity_violation"
REASON_QUEUE_SATURATED = "queue_saturated"

_HEAL_KINDS = ("heal_planned", "heal_retile", "heal_repack",
               "heal_suppressed", "heal_skipped", "heal_escalated",
               "heal_recalibrate", "recalibrated")


class _RecordView:
    """Attribute view over a serialized record dict so
    :meth:`HealthState.feed` can route it through
    :meth:`HealthState._on_record` unchanged."""
    __slots__ = ("kind", "step", "wall", "payload")

    def __init__(self, rec: dict):
        self.kind = rec.get("kind")
        self.step = rec.get("step")
        self.wall = rec.get("wall")
        self.payload = rec.get("payload") or {}


class HealthState:
    """The readiness tracker behind `/healthz` and `/status`: a bus
    subscriber (the :class:`igg_torch.heal.HealEngine` shape — invoked per
    emit on the emitting thread, pure dict bookkeeping) that folds the
    event stream into the live run/member/heal/checkpoint view, plus
    the live stall verdict read straight from
    :func:`igg_torch.comm.active_stalls` (episode state, not events — that is
    what lets readiness RECOVER when the channel drains without any
    'stall over' record existing)."""

    def __init__(self, max_fetch_lag: Optional[int] = None):
        self.max_fetch_lag = (int(max_fetch_lag)
                              if max_fetch_lag is not None
                              else _env.integer("IGG_STATUSD_MAX_FETCH_LAG",
                                                1000))
        self._lock = threading.Lock()
        self._attached = False
        # Serve-driven backpressure verdict (igg_torch.serve): not bus-folded,
        # so it survives the attach-time _reset — the scheduler sets it
        # while the global queue is at bound and clears it on drain
        # (readiness RECOVERS).
        self.queue_saturated: Optional[dict] = None
        self._reset()

    def _reset(self) -> None:
        with self._lock:
            self.runs: Dict[str, dict] = {}
            self.members_total = 0
            self.members_quarantined: set = set()
            self.escalated: Optional[dict] = None
            self.heal: deque = deque(maxlen=64)
            self.checkpoint: Optional[dict] = None
            self.last_stall: Optional[dict] = None
            # Integrity: the LIVE silent-data-corruption
            # verdict (readiness 503 until a verified rollback resolves
            # it), plus the resolved tail and counters for /status.
            self.integrity_violation: Optional[dict] = None
            self.integrity_resolved: Optional[dict] = None
            self.integrity_total = 0
            self.integrity_config: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------
    def attach(self) -> "HealthState":
        """Subscribe + backfill: a server started mid-run (or shared
        across sequential runs) must not report an empty /status just
        because run_started predates it.  The tracked state is RESET and
        rebuilt from the flight ring — a re-attach replays history the
        live subscription already delivered, so carrying old state would
        double every heal-ledger entry — and the ring snapshot is taken
        under the bus lock together with the subscription, so a record
        emitted concurrently lands in exactly one of the two paths
        (snapshot or live delivery; at worst an emit already past its
        ring append is seen twice, bounded by the in-flight count)."""
        if self._attached:
            return self
        self._attached = True
        self._reset()
        with _telemetry._lock:
            ring = list(_telemetry._ring())
            _telemetry.subscribe(self._on_record)
        for rec in ring:
            self._on_record(rec)
        return self

    def detach(self) -> None:
        if self._attached:
            self._attached = False
            _telemetry.unsubscribe(self._on_record)

    def set_queue_saturated(self, info: Optional[dict] = None, *,
                            depth: Optional[int] = None,
                            bound: Optional[int] = None) -> None:
        """Pin (or clear, with `info=None` and no kwargs) the
        ``queue_saturated`` readiness reason: the serve scheduler calls
        this when its global admission queue reaches its bound (503 —
        shed traffic tells the balancer to back off) and again when the
        drain brings it back below (readiness recovers)."""
        if info is None and depth is None and bound is None:
            with self._lock:
                self.queue_saturated = None
            return
        doc = dict(info or {})
        if depth is not None:
            doc["depth"] = int(depth)
        if bound is not None:
            doc["bound"] = int(bound)
        doc["wall"] = time.time()
        with self._lock:
            self.queue_saturated = doc

    # -- detection ---------------------------------------------------------
    def feed(self, record: dict) -> None:
        """Fold one already-serialized record dict (the JSONL /
        flight-dump form) — the offline `igg_torch.top` view shares the live
        tracker's event folding instead of maintaining a second copy."""
        self._on_record(_RecordView(record))

    def _on_record(self, rec) -> None:
        kind = rec.kind
        if kind == "step_stats":
            p = rec.payload
            run = p.get("run")
            if not run:
                return
            with self._lock:
                info = self.runs.setdefault(run, {"run": run})
                info["steps_done"] = rec.step
                info["steps_per_s"] = p.get("steps_per_s")
                info["ms_per_step"] = p.get("ms_per_step")
                info["fetch_lag_steps"] = p.get("fetch_lag_steps")
                if "member_steps_per_s" in p:
                    info["member_steps_per_s"] = p["member_steps_per_s"]
                    info["members_active"] = p.get("members_active")
            return
        if kind == "run_started":
            p = rec.payload
            run = p.get("run") or "run"
            with self._lock:
                self.runs[run] = {"run": run,
                                  "n_steps": p.get("n_steps"),
                                  "started_wall": rec.wall,
                                  "steps_done": 0, "finished": False}
                # A fresh run resets the terminal verdicts of the last
                # one: an escalation/quarantine wall belongs to the run
                # that died, not to its successor — and so does its
                # integrity CONFIG (a non-integrity run on a shared
                # server must not claim the previous run's SDC coverage;
                # an integrity-enabled run re-emits integrity_config
                # right after run_started).
                self.escalated = None
                self.integrity_violation = None
                self.integrity_config = None
                if run == "ensemble":
                    self.members_total = int(p.get("members") or 0)
                    self.members_quarantined = set()
            return
        if kind == "run_finished":
            run = rec.payload.get("run")
            with self._lock:
                info = self.runs.get(run)
                if info is not None:
                    info["finished"] = True
                    info["preempted"] = rec.payload.get("preempted", False)
                    if rec.step is not None:
                        info["steps_done"] = rec.step
            return
        if kind == "member_quarantined":
            m = rec.payload.get("member")
            if m is not None:
                with self._lock:
                    self.members_quarantined.add(int(m))
            return
        if kind == "checkpoint":
            with self._lock:
                self.checkpoint = {"step": rec.step,
                                   "path": rec.payload.get("path"),
                                   "wall": rec.wall,
                                   "background":
                                       rec.payload.get("background", False)}
            return
        if kind == "collective_stall":
            with self._lock:
                self.last_stall = {"step": rec.step, "wall": rec.wall,
                                   **rec.payload}
            return
        if kind == "integrity_violation":
            with self._lock:
                self.integrity_total += 1
                self.integrity_violation = {"step": rec.step,
                                            "wall": rec.wall, **rec.payload}
            return
        if kind == "integrity_resolved":
            with self._lock:
                self.integrity_violation = None
                self.integrity_resolved = {"step": rec.step,
                                           "wall": rec.wall, **rec.payload}
            return
        if kind == "integrity_config":
            with self._lock:
                self.integrity_config = {**rec.payload}
            return
        if kind in _HEAL_KINDS:
            with self._lock:
                self.heal.append({"kind": kind, "step": rec.step,
                                  "wall": rec.wall, **rec.payload})
                if kind == "heal_escalated":
                    self.escalated = {"step": rec.step, "wall": rec.wall,
                                      **rec.payload}
            return

    # -- the verdicts ------------------------------------------------------
    def readiness(self) -> Tuple[bool, List[dict]]:
        """`(ready, reasons)` — readiness false iff `reasons` is
        non-empty; each reason carries the machine-readable ``reason``
        string plus its kind-specific detail."""
        from . import comm as _comm

        reasons: List[dict] = []
        for info in _comm.active_stalls():
            reasons.append({"reason": REASON_STALL,
                            "run": info.get("run"),
                            "step": info.get("step"),
                            "in_flight": info.get("in_flight"),
                            "age_s": info.get("age_s")})
        with self._lock:
            if (self.members_total > 0
                    and len(self.members_quarantined) >= self.members_total):
                reasons.append({"reason": REASON_ALL_QUARANTINED,
                                "members": self.members_total})
            if self.escalated is not None:
                reasons.append({
                    "reason": REASON_ESCALATED,
                    "escalated_from": self.escalated.get("escalated_from"),
                    "signal_reason": self.escalated.get("signal_reason"),
                    "step": self.escalated.get("step")})
            if self.integrity_violation is not None:
                # A live silent-data-corruption verdict: the served state
                # is finite-but-wrong until a verified rollback lands
                # (integrity_resolved clears this — readiness RECOVERS).
                v = self.integrity_violation
                reasons.append({
                    "reason": REASON_INTEGRITY,
                    "source": v.get("source"),
                    "invariant": v.get("invariant"),
                    "field": v.get("field"),
                    "rank": v.get("rank"),
                    "device": v.get("device"),
                    "step": v.get("step")})
            if self.queue_saturated is not None:
                # Admission backpressure (igg_torch.serve): the global queue is
                # at bound — new submissions shed until the drain brings
                # it back under (the reason clears and readiness
                # recovers).
                reasons.append({"reason": REASON_QUEUE_SATURATED,
                                "depth": self.queue_saturated.get("depth"),
                                "bound": self.queue_saturated.get("bound")})
            if self.max_fetch_lag > 0:
                for run, info in self.runs.items():
                    lag = info.get("fetch_lag_steps")
                    if (not info.get("finished")
                            and isinstance(lag, (int, float))
                            and lag > self.max_fetch_lag):
                        reasons.append({"reason": REASON_FETCH_LAG,
                                        "run": run, "lag_steps": lag,
                                        "max_lag_steps": self.max_fetch_lag})
        return (not reasons), reasons

    def view(self) -> dict:
        """The tracker's state as a plain JSON-serializable dict (the
        `/status` building blocks)."""
        with self._lock:
            return {
                "runs": {k: dict(v) for k, v in self.runs.items()},
                "members": {"total": self.members_total,
                            "quarantined":
                                sorted(self.members_quarantined)},
                "heal": [dict(h) for h in self.heal],
                "checkpoint": (dict(self.checkpoint)
                               if self.checkpoint else None),
                "last_stall": (dict(self.last_stall)
                               if self.last_stall else None),
                "integrity": {
                    "violation": (dict(self.integrity_violation)
                                  if self.integrity_violation else None),
                    "resolved": (dict(self.integrity_resolved)
                                 if self.integrity_resolved else None),
                    "violations_total": self.integrity_total,
                    "config": (dict(self.integrity_config)
                               if self.integrity_config else None),
                },
            }


class _HbmPoller:
    """Throttled live device-memory poll behind the ``igg_hbm_*``
    gauges: one :func:`igg_torch.device.memory_stats` call per
    ``IGG_STATUSD_HBM_EVERY`` seconds, run on whichever statusd thread
    scrapes next (never the hot loop).  Honest omission: a backend
    without allocator stats sets no gauge and summarizes as None."""

    def __init__(self, every: Optional[float] = None):
        self.every = (float(every) if every is not None
                      else _env.number("IGG_STATUSD_HBM_EVERY", 10.0))
        self._lock = threading.Lock()
        self._last_poll = 0.0
        self.last: Optional[dict] = None   # the latest summary (or None)

    def poll(self, force: bool = False) -> Optional[dict]:
        now = time.monotonic()
        with self._lock:
            if not force and self._last_poll and \
                    now - self._last_poll < self.every:
                return self.last
            self._last_poll = now
        from . import device as _device

        stats = _device.memory_stats()
        if not stats:
            with self._lock:
                self.last = None
            return None
        in_use = limit = peak = 0
        for entry in stats:
            dev = entry["device"]
            if "bytes_in_use" in entry:
                _telemetry.gauge("igg_hbm_bytes_in_use",
                                 device=dev).set(entry["bytes_in_use"])
                in_use += entry["bytes_in_use"]
            if "bytes_limit" in entry:
                _telemetry.gauge("igg_hbm_bytes_limit",
                                 device=dev).set(entry["bytes_limit"])
                limit += entry["bytes_limit"]
            if "peak_bytes_in_use" in entry:
                _telemetry.gauge("igg_hbm_watermark_bytes",
                                 device=dev).set(entry["peak_bytes_in_use"])
                peak += entry["peak_bytes_in_use"]
        summary = {"devices": len(stats), "bytes_in_use": in_use,
                   "bytes_limit": limit, "peak_bytes_in_use": peak}
        if limit:
            summary["pct_in_use"] = 100.0 * in_use / limit
        with self._lock:
            self.last = summary
        return summary


# ---------------------------------------------------------------------------
# The merged multi-rank exposition
# ---------------------------------------------------------------------------

def _render_samples(samples_by_rank: Dict[int, List[dict]]) -> str:
    """One spec-valid Prometheus exposition over several ranks'
    structured metric samples (:func:`igg_torch.telemetry.metric_samples`),
    every sample tagged with a ``rank`` label.  Grouped by metric name —
    one `# HELP`/`# TYPE` pair per name even when several ranks carry
    it; a name whose type disagrees across ranks keeps the first rank's
    samples only (a torn snapshot must not produce an unparsable
    exposition)."""
    tel = _telemetry
    groups: Dict[str, dict] = {}
    for rank in sorted(samples_by_rank):
        for s in samples_by_rank[rank]:
            name = s.get("name")
            stype = s.get("type")
            if not name or stype not in ("counter", "gauge", "histogram"):
                continue
            g = groups.setdefault(name, {"type": stype,
                                         "help": s.get("help"),
                                         "samples": []})
            if g["type"] != stype:
                continue
            if not g["help"] and s.get("help"):
                g["help"] = s["help"]
            g["samples"].append((rank, s))
    out = []
    for name in sorted(groups):
        g = groups[name]
        pname = tel._prom_name(name)
        if g["help"]:
            out.append(f"# HELP {pname} "
                       f"{tel._prom_help_value(g['help'])}")
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "summary"}[g["type"]]
        out.append(f"# TYPE {pname} {ptype}")
        for rank, s in g["samples"]:
            labels = dict(s.get("labels") or {})
            labels["rank"] = str(rank)
            lab = "{" + ",".join(
                f'{tel._prom_name(k)}="{tel._prom_label_value(v)}"'
                for k, v in sorted(labels.items())) + "}"
            if g["type"] == "histogram":
                out.append(f"{pname}_count{lab} {s.get('count', 0)}")
                out.append(f"{pname}_sum{lab} {s.get('sum', 0.0)}")
                if s.get("count"):
                    out.append(f"{pname}_min{lab} {s.get('min')}")
                    out.append(f"{pname}_max{lab} {s.get('max')}")
            else:
                out.append(f"{pname}{lab} {s.get('value', 0.0)}")
    return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# The HTTP surface
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    """One request — dispatched entirely from statusd's serving threads
    (ThreadingHTTPServer), so `/metrics` and `/healthz` keep answering
    while the main loop is wedged."""

    app: "StatusServer"   # set on the per-server subclass
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # silence the default stderr spam
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc: dict) -> None:
        self._send(code, json.dumps(doc, default=str).encode(),
                   "application/json")

    def do_GET(self):   # noqa: N802 - http.server API
        app = self.app
        parsed = urlsplit(self.path)
        route = parsed.path.rstrip("/") or "/"
        try:
            if route == "/metrics":
                self._send(200, app.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif route == "/healthz":
                doc = app.health_doc()
                self._send_json(200 if doc["ready"] else 503, doc)
            elif route == "/status":
                self._send_json(200, app.status_doc())
            elif route == "/events":
                q = parse_qs(parsed.query)
                try:
                    n = int(q.get("n", ["64"])[0])
                except ValueError:
                    n = 64
                body = "".join(json.dumps(r, default=str) + "\n"
                               for r in app.events_tail(n))
                self._send(200, body.encode(), "application/x-ndjson")
            else:
                self._send_json(404, {"error": f"unknown route {route!r}",
                                      "routes": ["/metrics", "/healthz",
                                                 "/status", "/events"]})
                route = "(404)"
        except BrokenPipeError:
            return   # the scraper went away mid-write
        except Exception as e:   # the ops plane must answer, not die
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                return
            route = "(500)"
        _telemetry.counter("igg_statusd_requests_total", route=route).inc()

    def do_POST(self):   # noqa: N802 - http.server API
        """``POST /jobs``: online job submission (igg_torch.serve).  The body
        is the JSON job spec; the response is the admission verdict —
        201 admitted, 200 idempotent duplicate, 400 rejected with the
        reason, 409 name conflict / quarantined, 429 shed
        (backpressure), 503 draining.  Absent a serving scheduler the
        route answers 503."""
        app = self.app
        route = urlsplit(self.path).path.rstrip("/") or "/"
        try:
            if route != "/jobs":
                self._send_json(404, {"error": f"unknown route {route!r}",
                                      "routes": ["/jobs"]})
                route = "(404)"
            else:
                submit = app._submit_cb
                if submit is None:
                    self._send_json(503, {
                        "status": "rejected",
                        "reason": "no serving scheduler attached"})
                else:
                    try:
                        length = int(self.headers.get(
                            "Content-Length") or 0)
                    except ValueError:
                        length = 0
                    # Cap the read BEFORE buffering: an oversized body is
                    # shed by the transport, not malloc'd first.
                    cap = 1 << 20
                    raw = self.rfile.read(min(max(length, 0), cap))
                    res = submit(raw)
                    self._send_json(res.code, res.doc())
        except BrokenPipeError:
            return
        except Exception as e:
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                return
            route = "(500)"
        _telemetry.counter("igg_statusd_requests_total", route=route).inc()


class StatusServer:
    """The live ops endpoint (module docstring).  On rank 0, `start()`
    binds an HTTP server (`port=0` = OS-assigned ephemeral; `.port`
    reflects the bound port) serving on daemon threads; on non-zero
    ranks it starts the snapshot publisher instead.  `stop()` shuts the
    server down and releases the port.  Share one instance across run
    loops by passing it as their ``serve=`` (an already-started server
    is left running by the loop, the `telemetry=` session contract)."""

    def __init__(self, port: int = 0, *, host: Optional[str] = None,
                 dir=None, hbm_every: Optional[float] = None,
                 max_fetch_lag: Optional[int] = None,
                 publish_every: Optional[float] = None):
        self.requested_port = int(port)
        self.host = (host if host is not None
                     else (_env.text("IGG_STATUSD_HOST") or "127.0.0.1"))
        self._dir = pathlib.Path(dir) if dir is not None else None
        self.health = HealthState(max_fetch_lag=max_fetch_lag)
        self.hbm = _HbmPoller(hbm_every)
        self.publish_every = (float(publish_every)
                              if publish_every is not None
                              else _env.number("IGG_STATUSD_PUBLISH_EVERY",
                                               5.0))
        self.started = False
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started_mono: Optional[float] = None
        self._fleet_journal: Optional[pathlib.Path] = None
        # igg_torch.serve wiring: the live scheduler's stats snapshot (the
        # /status per-tenant section) and its admission entrypoint (the
        # POST /jobs body → verdict).
        self._serve_stats_cb = None
        self._submit_cb = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def url(self) -> Optional[str]:
        return (f"http://{self.host}:{self.port}"
                if self.port is not None else None)

    def start(self) -> "StatusServer":
        """Bind and serve (idempotent).  Rank 0 serves HTTP; non-zero
        ranks publish snapshot files for rank 0 to merge."""
        if self.started:
            return self
        self._stop.clear()
        self._started_mono = time.monotonic()
        rank = _telemetry._process()
        if rank == 0:
            handler = type("_BoundHandler", (_Handler,), {"app": self})
            try:
                self._httpd = ThreadingHTTPServer(
                    (self.host, self.requested_port), handler)
            except OSError as e:
                raise GridError(
                    f"igg_torch.statusd: cannot bind {self.host}:"
                    f"{self.requested_port}: {e}") from None
            self._httpd.daemon_threads = True
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="igg-statusd", daemon=True)
        else:
            self.port = None
            self._thread = threading.Thread(
                target=self._publish_loop, name=f"igg-statusd-pub-r{rank}",
                daemon=True)
        self.health.attach()
        self._thread.start()
        self.started = True
        _telemetry.emit("statusd_started", port=self.port, rank=rank,
                        host=self.host)
        return self

    def stop(self) -> None:
        """Shut down and release the port (idempotent)."""
        if not self.started:
            return
        self.started = False
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()   # releases the listening socket
            self._httpd = None
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        self.health.detach()
        _telemetry.emit("statusd_stopped", port=self.port,
                        rank=_telemetry._process())
        self.port = None

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- wiring ------------------------------------------------------------
    def watch_fleet(self, journal) -> None:
        """Point `/status`'s fleet summary at a live queue journal
        (:func:`igg_torch.run_fleet` calls this with its ``journal.json``)."""
        self._fleet_journal = pathlib.Path(journal)

    def watch_serve(self, stats_cb, submit_cb) -> None:
        """Attach (or, with two Nones, detach) a live serve scheduler:
        `stats_cb() -> dict` feeds the `/status` per-tenant section,
        `submit_cb(raw) -> SubmissionResult` answers ``POST /jobs``
        (:func:`igg_torch.serve.serve_fleet` calls this)."""
        self._serve_stats_cb = stats_cb
        self._submit_cb = submit_cb

    def _telemetry_dir(self) -> Optional[pathlib.Path]:
        """Where rank snapshots live: the explicit ``dir=``, else the
        first attached session's directory, else ``IGG_TELEMETRY_DIR``."""
        if self._dir is not None:
            return self._dir
        with _telemetry._lock:
            sessions = list(_telemetry._SESSIONS)
        if sessions:
            return sessions[0].dir
        envdir = _env.text("IGG_TELEMETRY_DIR")
        return pathlib.Path(envdir) if envdir else None

    # -- the non-zero-rank publisher ---------------------------------------
    def _publish_loop(self) -> None:
        while not self._stop.wait(self.publish_every):
            try:
                self.publish_snapshot()
            except Exception:
                continue   # a full disk must not kill the publisher

    def publish_snapshot(self) -> Optional[pathlib.Path]:
        """Write this rank's ``statusd_r<rank>.json`` snapshot (metric
        samples + status summary) into the telemetry dir — the file
        rank 0 merges.  Returns the path (None with no telemetry dir
        configured)."""
        d = self._telemetry_dir()
        if d is None:
            return None
        self.hbm.poll()
        rank = _telemetry._process()
        ready, reasons = self.health.readiness()
        doc = {"wall": time.time(), "process": rank,
               "metrics": _telemetry.metric_samples(),
               "status": {**self.health.view(), "ready": ready,
                          "reasons": reasons}}
        try:
            d.mkdir(parents=True, exist_ok=True)
            target = d / f"statusd_r{rank}.json"
            tmp = target.with_name(target.name + ".tmp")
            tmp.write_text(json.dumps(doc, default=str))
            tmp.replace(target)
        except OSError:
            return None
        return target

    def _remote_snapshots(self) -> Dict[int, dict]:
        """Other ranks' snapshot files, `{rank: doc}` (rank 0's merge
        source; empty on single-rank runs or with no telemetry dir).
        Snapshots whose ``wall`` stamp is older than a few publish
        periods are skipped: a dead rank's (or a previous job's in a
        reused telemetry dir) leftover file must not merge into
        `/metrics` as live data."""
        d = self._telemetry_dir()
        if d is None:
            return {}
        me = _telemetry._process()
        horizon = max(3.0 * self.publish_every, 30.0)
        now = time.time()
        out: Dict[int, dict] = {}
        try:
            files = sorted(d.glob("statusd_r*.json"))
        except OSError:
            return {}
        for f in files:
            stem = f.stem   # statusd_r<rank>
            try:
                rank = int(stem.rsplit("_r", 1)[1])
            except (IndexError, ValueError):
                continue
            if rank == me:
                continue
            try:
                doc = json.loads(f.read_text())
            except (OSError, json.JSONDecodeError):
                continue   # half-written snapshot: next publish wins
            if not isinstance(doc, dict):
                continue
            wall = doc.get("wall")
            if not isinstance(wall, (int, float)) or now - wall > horizon:
                continue   # stale: the publisher stopped refreshing it
            out[rank] = doc
        return out

    # -- the endpoint bodies -----------------------------------------------
    def metrics_text(self) -> str:
        """The `/metrics` body: the live registry exposition; with
        remote rank snapshots present, the merged multi-rank exposition
        (every sample ``rank``-labelled) instead."""
        self.hbm.poll()
        remote = self._remote_snapshots()
        if not remote:
            return _telemetry.prometheus_text()
        by_rank: Dict[int, List[dict]] = {
            _telemetry._process(): _telemetry.metric_samples()}
        for rank, doc in remote.items():
            samples = doc.get("metrics")
            if isinstance(samples, list):
                by_rank[rank] = samples
        return _render_samples(by_rank)

    def health_doc(self) -> dict:
        """The `/healthz` body: liveness (always true — answering IS the
        proof), readiness, and the machine-readable reasons."""
        ready, reasons = self.health.readiness()
        return {"live": True, "ready": ready, "reasons": reasons,
                "wall": time.time()}

    def _fleet_summary(self) -> Optional[dict]:
        journal = self._fleet_journal
        doc: Optional[dict] = None
        if journal is not None:
            try:
                doc = json.loads(journal.read_text())
            except (OSError, json.JSONDecodeError):
                doc = None
        if doc is None:
            return None
        jobs = doc.get("jobs") or {}
        by_status: Dict[str, int] = {}
        for rec in jobs.values():
            s = rec.get("status", "?")
            by_status[s] = by_status.get(s, 0) + 1
        return {"journal": str(journal), "jobs": len(jobs),
                "by_status": by_status}

    def _serve_doc(self) -> Optional[dict]:
        """The `/status` serve section: queue depth/bound/saturation plus
        the per-tenant table (queued, running, done/failed/quarantined,
        shed/rejected, retry budget) — None without a live scheduler."""
        cb = self._serve_stats_cb
        if cb is None:
            return None
        try:
            return cb()
        except Exception:
            return None

    def status_doc(self) -> dict:
        """The `/status` body (module docstring)."""
        from . import degrade as _degrade

        self.hbm.poll()
        ready, reasons = self.health.readiness()
        # The dashboard's headline gauges, by name (last-write value;
        # several labelled series of one name collapse to the latest —
        # `/metrics` has the full label detail).
        gauges: Dict[str, float] = {}
        for s in _telemetry.metric_samples():
            if (s.get("type") == "gauge"
                    and s.get("name") in ("igg_exposed_comm_fraction",
                                          "igg_overlap_efficiency",
                                          "igg_rank_skew_ms",
                                          "igg_steps_per_s")):
                gauges[s["name"]] = s.get("value")
        remote = self._remote_snapshots()
        ranks = {}
        for rank, doc in remote.items():
            st = doc.get("status") or {}
            ranks[str(rank)] = {"wall": doc.get("wall"),
                                "ready": st.get("ready"),
                                "runs": st.get("runs")}
        return {
            "wall": time.time(),
            "uptime_s": (time.monotonic() - self._started_mono
                         if self._started_mono else None),
            "process": _telemetry._process(),
            "port": self.port,
            "run_id": _telemetry.run_id(),
            "health": {"ready": ready, "reasons": reasons},
            **self.health.view(),
            "tiers": _degrade.active(),
            "quarantine": {t: q.reason
                           for t, q in _degrade.status().items()},
            "fleet": self._fleet_summary(),
            "serve": self._serve_doc(),
            "hbm": self.hbm.last,
            "gauges": gauges,
            "ranks": ranks,
            "flight_events": len(_telemetry.flight_recorder()),
        }

    def events_tail(self, n: int = 64) -> List[dict]:
        """The `/events` body: the newest `n` flight-recorder records,
        oldest first (bounded by the ring size)."""
        n = max(1, min(int(n), 100_000))
        recs = _telemetry.flight_recorder()
        return [r.as_dict() for r in recs[-n:]]


def as_server(serve) -> Optional[StatusServer]:
    """Coerce the run loops' ``serve=`` knob: None → a server only when
    ``IGG_STATUSD_PORT`` is set non-zero; True → the env port (an
    ephemeral port when unset); an int → that port (0 = ephemeral); a
    :class:`StatusServer` → itself (shared — an already-started server
    is not stopped by the run); False → off even when the env knob is
    set."""
    if serve is False:
        return None
    if isinstance(serve, StatusServer):
        return serve
    if serve is None:
        port = _env.integer("IGG_STATUSD_PORT", 0)
        if port <= 0:
            return None
        return StatusServer(port=port)
    if serve is True:
        port = _env.integer("IGG_STATUSD_PORT", 0)
        return StatusServer(port=port if port > 0 else 0)
    if isinstance(serve, int):
        return StatusServer(port=serve)
    raise GridError(
        f"serve={serve!r}: expected None, False, True, a TCP port, or an "
        f"igg_torch.statusd.StatusServer.")
