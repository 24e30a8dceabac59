"""Fleet as a service: an always-on multi-tenant scheduler over the fleet
tier (the port of `igg/serve.py`).

:func:`igg_torch.run_fleet` drains a fixed queue one job at a time and
returns.  :func:`serve_fleet` is the service shape of the same machinery:
a long-running scheduler loop fed by online submission, hardened so
hostile traffic cannot knock it over.

- **Online submission.**  Two intake paths land in the same
  ``igg-fleet-journal-v1`` journal: ``POST /jobs`` on the
  :mod:`igg_torch.statusd` endpoint (JSON body, synchronous admission
  verdict) and a spool directory (``{workdir}/spool/*.json``,
  atomic-rename files; a rejected body is kept in ``spool/rejected/``).
  A submission is a plain-JSON job SPEC (name, tenant, priority,
  global_interior, members, n_steps, submit_token, deadline_s,
  n_devices); the host-side ``job_factory`` turns a validated spec into
  an :class:`igg_torch.Job`.
- **Admission control and backpressure.**  Bounded global and per-tenant
  queues: a submission past a bound is *shed* (HTTP 429, a ``job_shed``
  event) and the readiness reason ``queue_saturated`` is pinned while the
  global queue is at its bound.  Malformed, oversized or inadmissible
  specs (``plan_dims`` feasibility is checked before acceptance) are
  rejected at the door with the reason.  Submission is idempotent on
  ``(tenant, name, submit_token)``.
- **Concurrent jobs on disjoint slots.**  Admission partitions the live
  block slots; each job is planned on its share (``plan_dims`` takes
  ``n_devices``) and its nested :func:`igg_torch.run_ensemble` runs in a
  worker thread under :func:`igg_torch.shared.thread_grid_scope` and
  :func:`igg_torch.resilience.preemption_scope`: a grid lifecycle and a
  preemption channel per job, invisible to its neighbours.  A fenced slot
  (:meth:`ServeControl.fence_device`) shrinks only the jobs holding it:
  they seal their rings, re-admit elastically and re-plan without it.
- **Tenancy.**  Stride scheduling over tenant virtual time, per-tenant
  retry budgets (an over-budget tenant's submissions shed), and poison-job
  quarantine: a job that fails deterministically is journaled
  ``quarantined`` (``job_quarantined``) and never re-admitted.
- **Priority preemption and graceful drain.**  A hot arrival that cannot
  be placed preempts the lowest-priority running job through its cell
  (the job writes its final generation and is re-admitted elastically).
  SIGTERM (or :meth:`ServeControl.drain`) stops intake, drains running
  jobs to sealed generations, seals the journal and returns, ready for
  ``resume=True``.

Where the port's route is not igg's: the grid's blocks all live on one
device, so the service's "devices" are **block slots** of that device, as
in :func:`igg_torch.run_fleet`: ``devices=["cuda"] * 8`` gives eight
slots of the card, ``["cpu"] * 8`` eight of the CPU, None one slot of the
card (raising without one), and a list naming two devices raises
`GridError`.  Worker threads launch on their current stream, the card's
default stream, so the kernels of concurrent jobs run one after another
on the card; what runs side by side is their host work.

Chaos: :func:`igg_torch.chaos.arrival_storm` and
:func:`igg_torch.chaos.malformed_submission` inject hostile intake through
the ``_CHAOS_SUBMIT_TAP`` seam, composing under
:func:`igg_torch.chaos.armed`.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import re
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import fleet as _fleet
from . import shared
from . import telemetry as _telemetry
from .fleet import Job, JobOutcome, job_config_hash, plan_dims
from .resilience import Event, PreemptionCell, preemption_scope
from .shared import GridError

__all__ = ["serve_fleet", "ServeControl", "ServeResult",
           "SubmissionResult"]

# Chaos seam (igg_torch.chaos.arrival_storm / malformed_submission): a dict
# {"storm": [{"n": ..., "tenant": ..., "spec": ...}, ...],
#  "malformed": [{"times": ...}, ...]} consulted once per scheduler tick,
# entries consumed one-shot as they fire.
_CHAOS_SUBMIT_TAP: Optional[dict] = None

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,119}$")

# Structural sanity bounds: a submission past these is "oversized" and
# rejected at the door (a hostile 10^12-cell spec must fail in admission,
# not OOM a worker).
_MAX_MEMBERS = 4096
_MAX_STEPS = 10 ** 8
_MAX_DIM = 10 ** 6
_TERMINAL = ("done", "failed", "quarantined")


def _serve_defaults():
    from . import _env

    return {
        "max_concurrent": _env.integer("IGG_SERVE_MAX_CONCURRENT", 2),
        "queue_bound": _env.integer("IGG_SERVE_QUEUE_BOUND", 16),
        "tenant_queue_bound":
            _env.integer("IGG_SERVE_TENANT_QUEUE_BOUND", 8),
        "tenant_retry_budget":
            _env.integer("IGG_SERVE_TENANT_RETRIES", 8),
        "poll_s": _env.number("IGG_SERVE_POLL", 0.05),
        "max_body": _env.integer("IGG_SERVE_MAX_BODY", 65536),
    }


def _consume_submit_tap(kind: str) -> List[dict]:
    """Pop every chaos entry of `kind` (one-shot semantics)."""
    global _CHAOS_SUBMIT_TAP
    tap = _CHAOS_SUBMIT_TAP
    if not tap or not tap.get(kind):
        return []
    entries = list(tap.pop(kind) or [])
    if not any(tap.get(k) for k in tap):
        _CHAOS_SUBMIT_TAP = None
    return entries


@dataclasses.dataclass
class SubmissionResult:
    """One admission verdict, HTTP-shaped: `code` is the status the POST
    path answers with (201 admitted, 200 idempotent duplicate / already
    terminal, 400 rejected, 409 name conflict / quarantined, 429 shed,
    503 draining), `status` the machine-readable verdict, `reason` the
    structured refusal."""
    code: int
    status: str
    reason: Optional[str] = None
    job: Optional[str] = None
    tenant: Optional[str] = None

    def doc(self) -> dict:
        out = {"status": self.status}
        if self.reason is not None:
            out["reason"] = self.reason
        if self.job is not None:
            out["job"] = self.job
        if self.tenant is not None:
            out["tenant"] = self.tenant
        return out


@dataclasses.dataclass
class ServeResult:
    """What one :func:`serve_fleet` session did: per-job outcomes (the
    :class:`igg_torch.JobOutcome` shape), the shed/rejected submission records,
    the per-tenant accounting, whether the loop exited through the drain
    protocol, and the journal path a ``resume=True`` relaunch reconciles
    against."""
    jobs: Dict[str, JobOutcome]
    shed: List[dict]
    rejected: List[dict]
    tenants: Dict[str, dict]
    drained: bool
    journal: pathlib.Path


class ServeControl:
    """Thread-safe control handle for a live :func:`serve_fleet` loop:
    in-process submission, the fence verb, drain, and a stats snapshot.
    Create one, pass it as ``control=``, then drive it from any thread
    (a load generator submits from its thread while the scheduler loop
    owns the calling thread)."""

    def __init__(self) -> None:
        self._state: Optional["_ServeState"] = None
        self._bound = threading.Event()

    def _bind(self, state: "_ServeState") -> None:
        self._state = state
        self._bound.set()

    def _require(self) -> "_ServeState":
        if self._state is None:
            raise GridError("ServeControl: not bound to a serve_fleet "
                            "loop yet.")
        return self._state

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the scheduler loop has bound this control."""
        return self._bound.wait(timeout)

    def submit(self, spec) -> SubmissionResult:
        """Submit one job spec (dict or raw JSON bytes/str) through the
        full admission pipeline: the in-process twin of ``POST /jobs``."""
        return self._require().submit(spec, source="control")

    def fence_device(self, index: int) -> None:
        """Fence the block slot at `index` (the heal loop-1 verb): it
        leaves the placement pool and every running job holding it is
        preempted to its final ring generation and re-admitted on the
        slots left.  Jobs on other slots are untouched."""
        self._require().fence_device(int(index))

    def drain(self) -> None:
        """Begin the graceful drain protocol (the SIGTERM path): stop
        intake, preempt running jobs to sealed generations, seal the
        journal, let :func:`serve_fleet` return."""
        self._require().request_drain("control")

    def stats(self) -> dict:
        """Live per-tenant + queue snapshot (the /status `tenants` doc)."""
        return self._require().stats_doc()


@dataclasses.dataclass
class _Pending:
    job: Job
    spec: dict
    resume: bool
    enqueued_at: float
    seq: int
    token: str


class _Worker:
    def __init__(self, job: Job, slots, devices, rec: dict, resume: bool,
                 start_attempts: int, token: str, spec: dict) -> None:
        self.job = job
        self.slots = list(slots)       # indices into the slot list
        self.devices = list(devices)
        self.rec = rec
        self.resume = resume
        self.start_attempts = start_attempts
        self.cell = PreemptionCell()
        self.done = threading.Event()
        self.outcome: Optional[JobOutcome] = None
        self.thread: Optional[threading.Thread] = None
        self.started_at = time.time()
        self.preempt_reason: Optional[str] = None
        self.token = token
        self.spec = spec


class _ServeState:
    """Everything the scheduler loop owns, behind ONE lock (admission
    runs on HTTP handler threads, journal transitions on worker threads,
    placement on the loop thread; they all mutate the same queues and
    the same journal).  `devices` is the slot list; workers hold slot
    indices."""

    def __init__(self, workdir: pathlib.Path, job_factory, devs,
                 cfg: dict, tenant_weights, on_event, tel) -> None:
        self.lock = threading.RLock()
        self.workdir = workdir
        self.jpath = workdir / _fleet._JOURNAL
        self.spool = workdir / "spool"
        self.job_factory = job_factory
        self.devices = list(devs)
        self.cfg = cfg
        self.tenant_weights = dict(tenant_weights or {})
        self.on_event = on_event
        self.tel = tel
        self.journal = {"format": _fleet._JOURNAL_FORMAT, "jobs": {}}
        self.pending: Dict[str, collections.deque] = {}
        self.running: Dict[str, _Worker] = {}
        self.outcomes: Dict[str, JobOutcome] = {}
        self.shed: List[dict] = []
        self.rejected: List[dict] = []
        self.tenants: Dict[str, dict] = {}
        self.fenced: set = set()
        self.fence_queue: List[int] = []
        self.draining = False
        self.drain_source: Optional[str] = None
        self.seq = 0
        self.storm_seq = 0
        self.last_activity = time.monotonic()
        self.health = None      # bound to the statusd HealthState, if any
        self.m_queue = _telemetry.gauge("igg_serve_queue_depth")
        self.m_running = _telemetry.gauge("igg_serve_running_jobs")

    # -- events ------------------------------------------------------------

    def emit(self, kind: str, step: int, **detail) -> Event:
        ev = Event(kind, step, detail)
        if kind in _fleet._SCHEDULER_KINDS:
            _telemetry.emit(kind, step=step, run="serve", **detail)
        if self.on_event is not None:
            try:
                self.on_event(ev)
            except Exception:
                pass
        return ev

    # -- per-tenant accounting ---------------------------------------------

    def _tenant(self, name: str) -> dict:
        t = self.tenants.get(name)
        if t is None:
            t = self.tenants[name] = {
                "weight": float(self.tenant_weights.get(name, 1.0)),
                "vtime": 0.0, "done": 0, "quarantined": 0, "failed": 0,
                "shed": 0, "rejected": 0, "retries_used": 0,
                "retry_budget": int(self.cfg["tenant_retry_budget"]),
            }
        return t

    def _pending_depth(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return len(self.pending.get(tenant, ()))
        return sum(len(q) for q in self.pending.values())

    def _saturated(self) -> bool:
        return self._pending_depth() >= int(self.cfg["queue_bound"])

    def _update_saturation(self) -> None:
        if self.health is None:
            return
        if self._saturated():
            self.health.set_queue_saturated(
                depth=self._pending_depth(),
                bound=int(self.cfg["queue_bound"]))
        else:
            self.health.set_queue_saturated(None)

    # -- admission ---------------------------------------------------------

    def submit(self, raw, source: str = "api") -> SubmissionResult:
        res = self._submit_inner(raw, source)
        if res.status == "shed":
            self.emit("job_shed", 0, job=res.job, tenant=res.tenant,
                      reason=res.reason, source=source)
            with self.lock:
                self.shed.append({"job": res.job, "tenant": res.tenant,
                                  "reason": res.reason, "source": source,
                                  "at": time.time()})
                if res.tenant:
                    self._tenant(res.tenant)["shed"] += 1
        elif res.status == "rejected":
            self.emit("job_rejected", 0, job=res.job, tenant=res.tenant,
                      reason=res.reason, source=source)
            with self.lock:
                self.rejected.append({
                    "job": res.job, "tenant": res.tenant,
                    "reason": res.reason, "source": source,
                    "at": time.time()})
                if res.tenant:
                    self._tenant(res.tenant)["rejected"] += 1
        elif res.status == "admitted":
            self.emit("job_admitted", 0, job=res.job, tenant=res.tenant,
                      source=source)
        with self.lock:
            self._update_saturation()
            self.m_queue.set(self._pending_depth())
        return res

    def _parse(self, raw) -> Tuple[Optional[dict], Optional[str]]:
        if isinstance(raw, dict):
            return dict(raw), None
        if isinstance(raw, str):
            raw = raw.encode("utf-8", "replace")
        if not isinstance(raw, (bytes, bytearray)):
            return None, f"malformed: unsupported submission type " \
                         f"{type(raw).__name__}"
        if len(raw) > int(self.cfg["max_body"]):
            return None, f"oversized: body {len(raw)} bytes > " \
                         f"{self.cfg['max_body']}"
        try:
            doc = json.loads(bytes(raw).decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            return None, f"malformed: {e}"
        if not isinstance(doc, dict):
            return None, "malformed: spec must be a JSON object"
        return doc, None

    def _validate(self, spec: dict) -> Tuple[Optional[dict],
                                             Optional[str]]:
        name = spec.get("name")
        if not isinstance(name, str) or not _NAME_RE.match(name):
            return None, "malformed: name must match " \
                         "[A-Za-z0-9][A-Za-z0-9._-]{0,119}"
        tenant = spec.get("tenant", "default")
        if not isinstance(tenant, str) or not _NAME_RE.match(tenant):
            return None, "malformed: tenant must match the name charset"
        gi = spec.get("global_interior")
        if (not isinstance(gi, (list, tuple)) or len(gi) != 3
                or not all(isinstance(v, int) and not isinstance(v, bool)
                           for v in gi)):
            return None, "malformed: global_interior must be 3 ints"
        if any(v < 2 for v in gi):
            return None, "malformed: global_interior dims must be >= 2"
        if any(v > _MAX_DIM for v in gi):
            return None, f"oversized: global_interior dim > {_MAX_DIM}"
        members = spec.get("members", 1)
        n_steps = spec.get("n_steps")
        for label, v, hi in (("members", members, _MAX_MEMBERS),
                             ("n_steps", n_steps, _MAX_STEPS)):
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                return None, f"malformed: {label} must be a positive int"
            if v > hi:
                return None, f"oversized: {label} {v} > {hi}"
        prio = spec.get("priority", 0)
        if not isinstance(prio, int) or isinstance(prio, bool):
            return None, "malformed: priority must be an int"
        token = spec.get("submit_token", "")
        if not isinstance(token, str) or len(token) > 200:
            return None, "malformed: submit_token must be a short string"
        deadline = spec.get("deadline_s")
        if deadline is not None and (
                not isinstance(deadline, (int, float))
                or isinstance(deadline, bool) or deadline <= 0):
            return None, "malformed: deadline_s must be a positive number"
        ndev = spec.get("n_devices")
        if ndev is not None and (not isinstance(ndev, int)
                                 or isinstance(ndev, bool) or ndev < 1):
            return None, "malformed: n_devices must be a positive int"
        periods = spec.get("periods", [1, 1, 1])
        overlaps = spec.get("overlaps", [2, 2, 2])
        for label, v, lo in (("periods", periods, 0),
                             ("overlaps", overlaps, 1)):
            if (not isinstance(v, (list, tuple)) or len(v) != 3
                    or not all(isinstance(x, int)
                               and not isinstance(x, bool) and lo <= x <= 8
                               for x in v)):
                return None, f"malformed: {label} must be 3 small ints"
        out = {"name": name, "tenant": tenant,
               "global_interior": [int(v) for v in gi],
               "members": int(members), "n_steps": int(n_steps),
               "priority": int(prio), "submit_token": token,
               "deadline_s": (None if deadline is None
                              else float(deadline)),
               "n_devices": None if ndev is None else int(ndev),
               "periods": [int(v) for v in periods],
               "overlaps": [int(v) for v in overlaps]}
        for k, v in spec.items():
            if k not in out:
                out[k] = v
        return out, None

    def _default_share(self) -> int:
        live = max(1, len(self.devices) - len(self.fenced))
        return max(1, live // max(1, int(self.cfg["max_concurrent"])))

    def _device_request(self, job: Job) -> int:
        live = max(1, len(self.devices) - len(self.fenced))
        r = job.n_devices if job.n_devices else self._default_share()
        return max(1, min(int(r), live))

    def _submit_inner(self, raw, source: str) -> SubmissionResult:
        spec, err = self._parse(raw)
        if err is not None:
            return SubmissionResult(400, "rejected", reason=err)
        spec, err = self._validate(spec)
        if err is not None:
            return SubmissionResult(
                400, "rejected", reason=err,
                job=spec.get("name") if isinstance(spec, dict) else None,
                tenant=(spec.get("tenant")
                        if isinstance(spec, dict) else None))
        name, tenant = spec["name"], spec["tenant"]
        token = spec["submit_token"]
        with self.lock:
            if self.draining:
                return SubmissionResult(503, "shed", reason="draining",
                                        job=name, tenant=tenant)
            # plan_dims feasibility at the requested device share: an
            # inadmissible domain is rejected at the door, not launched
            # into a GridError.
            try:
                plan_dims(spec["global_interior"],
                          spec["n_devices"] or len(self.devices),
                          periods=tuple(spec["periods"]),
                          overlaps=tuple(spec["overlaps"]))
            except GridError as e:
                return SubmissionResult(400, "rejected",
                                        reason=f"infeasible: {e}",
                                        job=name, tenant=tenant)
            # Idempotency on (tenant, name, submit_token) — a client
            # retry of an in-flight or finished submission is a 200
            # duplicate, never a double-enqueue.
            live = self._find_live(name)
            rec = self.journal["jobs"].get(name)
            if live is not None:
                l_tenant, l_token, l_hash = live
                if (l_tenant, l_token) == (tenant, token) \
                        and l_hash == self._spec_hash(spec):
                    return SubmissionResult(200, "duplicate",
                                            reason="already enqueued",
                                            job=name, tenant=tenant)
                return SubmissionResult(409, "rejected",
                                        reason="name_in_use", job=name,
                                        tenant=tenant)
            reuse = False
            if isinstance(rec, dict):
                stamped = rec.get("config_hash")
                if stamped is not None \
                        and stamped != self._spec_hash(spec):
                    # Satellite: name reuse with a different config is a
                    # FRESH job, not the journaled one.  The reset is
                    # deferred past the shed checks — a shed submission
                    # must not destroy the prior record.
                    reuse = True
                    rec = None
                elif rec.get("status") == "quarantined":
                    return SubmissionResult(
                        409, "rejected", reason="quarantined", job=name,
                        tenant=tenant)
                elif rec.get("status") == "done":
                    return SubmissionResult(200, "duplicate",
                                            reason="already done",
                                            job=name, tenant=tenant)
            ten = self._tenant(tenant)
            if ten["retries_used"] >= ten["retry_budget"]:
                return SubmissionResult(429, "shed",
                                        reason="tenant_budget_exhausted",
                                        job=name, tenant=tenant)
            if self._pending_depth(tenant) >= int(
                    self.cfg["tenant_queue_bound"]):
                return SubmissionResult(429, "shed",
                                        reason="tenant_queue_full",
                                        job=name, tenant=tenant)
            if self._saturated():
                self._update_saturation()
                return SubmissionResult(429, "shed",
                                        reason="queue_saturated",
                                        job=name, tenant=tenant)
            try:
                job = self._build_job(spec)
            except Exception as e:
                return SubmissionResult(
                    400, "rejected",
                    reason=f"factory_error: {type(e).__name__}: {e}",
                    job=name, tenant=tenant)
            if reuse:
                self._reset_reused(name, spec)
            resume = isinstance(rec, dict) and rec.get("status") in (
                "preempted", "running")
            self._enqueue(job, spec, resume=resume, token=token)
            return SubmissionResult(201, "admitted", job=name,
                                    tenant=tenant)

    def _spec_hash(self, spec: dict) -> str:
        probe = Job(name=spec["name"],
                    global_interior=tuple(spec["global_interior"]),
                    members=spec["members"], n_steps=spec["n_steps"],
                    tenant=spec["tenant"])
        return job_config_hash(probe)

    def _find_live(self, name: str):
        """(tenant, token, hash) of a queued/running job named `name`."""
        w = self.running.get(name)
        if w is not None:
            return (w.job.tenant, w.token, job_config_hash(w.job))
        for q in self.pending.values():
            for p in q:
                if p.job.name == name:
                    return (p.job.tenant, p.token,
                            job_config_hash(p.job))
        return None

    def _reset_reused(self, name: str, spec: dict) -> None:
        import shutil

        old = self.journal["jobs"].pop(name, {}) or {}
        self.emit("job_name_reused", 0, job=name, tenant=spec["tenant"],
                  prior_status=old.get("status"),
                  prior_config_hash=old.get("config_hash"),
                  config_hash=self._spec_hash(spec))
        shutil.rmtree(self.workdir / "jobs" / name, ignore_errors=True)
        _fleet._write_journal(self.jpath, self.journal)

    def _build_job(self, spec: dict) -> Job:
        if self.job_factory is None:
            raise GridError("serve_fleet: no job_factory — online "
                            "submission needs one to turn specs into "
                            "runnable jobs.")
        job = self.job_factory(dict(spec))
        if not isinstance(job, Job):
            raise GridError(f"job_factory returned "
                            f"{type(job).__name__}, expected igg_torch.Job")
        job.name = spec["name"]
        job.tenant = spec["tenant"]
        job.priority = spec["priority"]
        job.deadline_s = spec["deadline_s"]
        job.n_devices = spec["n_devices"]
        job.global_interior = tuple(spec["global_interior"])
        job.members = spec["members"]
        job.n_steps = spec["n_steps"]
        if "periods" in spec:
            job.periods = tuple(spec["periods"])
        if "overlaps" in spec:
            job.overlaps = tuple(spec["overlaps"])
        if job.make_states is None or (job.step_fn is None
                                       and job.make_step is None):
            raise GridError("job_factory must set make_states and "
                            "step_fn (or make_step)")
        return job

    def _enqueue(self, job: Job, spec: dict, *, resume: bool,
                 token: str) -> None:
        now = time.time()
        job.submitted_at = now
        self.seq += 1
        p = _Pending(job=job, spec=spec, resume=resume, enqueued_at=now,
                     seq=self.seq, token=token)
        self.pending.setdefault(job.tenant, collections.deque()).append(p)
        rec = _fleet._journal_record(self.journal, job)
        rec["submitted_at"] = now
        rec["submit_token"] = token
        rec["tenant"] = job.tenant
        rec["priority"] = int(job.priority)
        rec["deadline_s"] = job.deadline_s
        # The SPEC rides in the journal so resume=True can rebuild the
        # job through the factory without the submitting client.
        rec["spec"] = {k: v for k, v in spec.items()
                       if _jsonable(v)}
        if not resume:
            rec["status"] = "queued"
        _fleet._write_journal(self.jpath, self.journal)
        self.last_activity = time.monotonic()

    # -- intake (spool + chaos) --------------------------------------------

    def poll_spool(self) -> None:
        try:
            files = sorted(self.spool.glob("*.json"))
        except OSError:
            return
        for f in files:
            try:
                raw = f.read_bytes()
                f.unlink()
            except OSError:
                continue
            res = self.submit(raw, source="spool")
            if res.code == 400:
                rej = self.spool / "rejected"
                try:
                    rej.mkdir(exist_ok=True)
                    (rej / f.name).write_bytes(raw)
                except OSError:
                    pass

    def poll_chaos(self) -> None:
        for entry in _consume_submit_tap("malformed"):
            for _ in range(int(entry.get("times", 1))):
                self.submit(b'{"name": ... not json', source="chaos")
        for entry in _consume_submit_tap("storm"):
            n = int(entry.get("n", 1))
            tenant = entry.get("tenant") or "default"
            template = entry.get("spec") or {
                "global_interior": [8, 8, 8], "members": 1, "n_steps": 2}
            for _ in range(n):
                self.storm_seq += 1
                spec = dict(template)
                spec["tenant"] = tenant
                spec.setdefault("priority", 0)
                spec["name"] = f"storm-{tenant}-{self.storm_seq}"
                self.submit(spec, source="storm")

    # -- fence / drain -----------------------------------------------------

    def fence_device(self, index: int) -> None:
        with self.lock:
            self.fence_queue.append(index)

    def request_drain(self, source: str) -> None:
        with self.lock:
            if self.draining:
                return
            self.draining = True
            self.drain_source = source
            # Drain to sealed generations: every running job is asked to
            # preempt through ITS cell (the final-ring-generation path),
            # per job, no cross-job blast radius.
            for w in self.running.values():
                if w.preempt_reason is None:
                    w.preempt_reason = "drain"
                w.cell.request()
        _telemetry.emit("drain_started", run="serve", source=source)

    # -- scheduling --------------------------------------------------------

    def _free_devices(self) -> List[int]:
        """Indices of the slots neither fenced nor held by a running job
        (the slots are one device repeated, so they are told apart by
        index)."""
        used = set()
        for w in self.running.values():
            used.update(w.slots)
        return [i for i in range(len(self.devices))
                if i not in self.fenced and i not in used]

    def _apply_fences(self) -> None:
        with self.lock:
            new = [i for i in self.fence_queue
                   if 0 <= i < len(self.devices) and i not in self.fenced]
            self.fence_queue = []
            for i in new:
                self.fenced.add(i)
                victims = [w for w in self.running.values()
                           if i in w.slots]
                self.emit("device_fenced", 0, device=i,
                          jobs=[w.job.name for w in victims])
                for w in victims:
                    if w.preempt_reason is None:
                        w.preempt_reason = "fence"
                        w.cell.request()

    def _pick(self) -> Optional[_Pending]:
        """Weighted-fair, priority-first pick of the next launchable
        submission: among the tenants' queue heads, the highest priority
        wins; ties go to the tenant with the LEAST virtual time (stride
        scheduling — each launch advances the tenant's clock by
        1/weight), then submission order."""
        heads = [(q[0], t) for t, q in self.pending.items() if q]
        if not heads:
            return None
        heads.sort(key=lambda pt: (-pt[0].job.priority,
                                   self._tenant(pt[1])["vtime"],
                                   pt[0].seq))
        free = self._free_devices()
        for p, tenant in heads:
            if len(free) >= self._device_request(p.job):
                q = self.pending[tenant]
                q.popleft()
                if not q:
                    del self.pending[tenant]
                ten = self._tenant(tenant)
                ten["vtime"] += 1.0 / max(ten["weight"], 1e-9)
                return p
        return None

    def _shed_expired(self) -> None:
        now = time.time()
        for tenant in list(self.pending):
            q = self.pending[tenant]
            keep = collections.deque()
            for p in q:
                dl = p.job.deadline_s
                if dl is not None and now - p.enqueued_at > dl:
                    self.journal["jobs"].pop(p.job.name, None)
                    _fleet._write_journal(self.jpath, self.journal)
                    self.shed.append({
                        "job": p.job.name, "tenant": tenant,
                        "reason": "deadline_exceeded", "source": "queue",
                        "at": now})
                    self._tenant(tenant)["shed"] += 1
                    self.emit("job_shed", 0, job=p.job.name,
                              tenant=tenant, reason="deadline_exceeded",
                              source="queue")
                else:
                    keep.append(p)
            if keep:
                self.pending[tenant] = keep
            else:
                del self.pending[tenant]

    def _maybe_preempt(self) -> None:
        """Priority preemption: when the hottest pending job cannot be
        placed, the lowest-priority running job BELOW it is preempted
        through its cell (final ring generation, elastic re-admit)."""
        heads = [q[0] for q in self.pending.values() if q]
        if not heads:
            return
        hot = max(heads, key=lambda p: p.job.priority)
        free = len(self._free_devices())
        need = self._device_request(hot.job)
        if free >= need and len(self.running) < int(
                self.cfg["max_concurrent"]):
            return
        victims = [w for w in self.running.values()
                   if w.preempt_reason is None
                   and w.job.priority < hot.job.priority]
        if not victims:
            return
        victim = min(victims,
                     key=lambda w: (w.job.priority, -w.started_at))
        victim.preempt_reason = "priority"
        victim.cell.request()

    def launch_ready(self, max_job_retries: int, backoff: float) -> None:
        with self.lock:
            # Draining stops LAUNCHES too, not just intake: queued
            # submissions must stay journaled for resume=True, not sneak
            # onto the devices a sealing worker just released.
            while (not self.draining
                   and len(self.running) < int(self.cfg["max_concurrent"])):
                p = self._pick()
                if p is None:
                    break
                free = self._free_devices()
                r = self._device_request(p.job)
                self._launch(p, free[:r], max_job_retries, backoff)
            self.m_queue.set(self._pending_depth())
            self.m_running.set(len(self.running))
            self._update_saturation()

    def _launch(self, p: _Pending, slots, max_job_retries: int,
                backoff: float) -> None:
        job = p.job
        ten = self._tenant(job.tenant)
        # An over-budget tenant's jobs keep running but fail FAST — the
        # launcher retry loop is the thing its blowups were burning.
        retries = (0 if ten["retries_used"] >= ten["retry_budget"]
                   else int(max_job_retries))
        rec = _fleet._journal_record(self.journal, job)
        worker = _Worker(job, slots, [self.devices[i] for i in slots], rec,
                         p.resume, rec.get("attempts", 0), p.token, p.spec)

        def transition(j, **updates):
            with self.lock:
                rec.update(updates)
                rec["updated_at"] = time.time()
                _fleet._write_journal(self.jpath, self.journal)

        jobdir = self.workdir / "jobs" / job.name

        def body():
            try:
                with shared.thread_grid_scope(), \
                        preemption_scope(worker.cell):
                    out = _fleet._run_job(
                        job, jobdir, worker.devices, worker.resume,
                        retries, backoff, self.emit, transition, rec,
                        self.tel, None)
            except BaseException as e:   # a worker must never die silent
                out = JobOutcome(status="failed",
                                 attempts=rec.get("attempts", 0),
                                 error=f"{type(e).__name__}: {e}")
                transition(job, status="failed")
            worker.outcome = out
            worker.done.set()

        worker.thread = threading.Thread(
            target=body, daemon=True, name=f"igg-serve-{job.name}")
        self.running[job.name] = worker
        self.last_activity = time.monotonic()
        worker.thread.start()

    # -- reaping -----------------------------------------------------------

    def reap(self) -> None:
        finished = [w for w in list(self.running.values())
                    if w.done.is_set()]
        for w in finished:
            if w.thread is not None:
                w.thread.join(timeout=10)
        with self.lock:
            for w in finished:
                self._reap_one(w)
            self.m_running.set(len(self.running))
            self.m_queue.set(self._pending_depth())

    def _reap_one(self, w: _Worker) -> None:
        self.running.pop(w.job.name, None)
        out = w.outcome or JobOutcome(status="failed", attempts=0,
                                      error="worker lost")
        ten = self._tenant(w.job.tenant)
        launches = max(0, out.attempts - w.start_attempts)
        ten["retries_used"] += max(0, launches - 1)
        self.last_activity = time.monotonic()
        if out.status == "done":
            ten["done"] += 1
            self.outcomes[w.job.name] = out
            _telemetry.counter("igg_serve_jobs_total",
                               status="done").inc()
            return
        if out.status == "failed":
            # Poison-job quarantine: a deterministic failure (terminal
            # verdict, or every launch dying with the identical error)
            # is journaled `quarantined` and never re-admitted.
            terminal = any(e.kind == "job_gave_up"
                           and e.detail.get("terminal")
                           for e in out.events)
            errs = {e.detail.get("error") for e in out.events
                    if e.kind == "job_failed"}
            deterministic = terminal or (len(errs) == 1 and launches > 1)
            ten["retries_used"] += 2
            if deterministic:
                ten["quarantined"] += 1
                rec = self.journal["jobs"].get(w.job.name)
                if isinstance(rec, dict):
                    rec["status"] = "quarantined"
                    rec["updated_at"] = time.time()
                    _fleet._write_journal(self.jpath, self.journal)
                self.emit("job_quarantined", 0, job=w.job.name,
                          tenant=w.job.tenant,
                          error=out.error, attempts=out.attempts)
                out = dataclasses.replace(out, status="quarantined")
                _telemetry.counter("igg_serve_jobs_total",
                                   status="quarantined").inc()
            else:
                ten["failed"] += 1
                _telemetry.counter("igg_serve_jobs_total",
                                   status="failed").inc()
            self.outcomes[w.job.name] = out
            return
        if out.status == "preempted":
            _telemetry.counter("igg_serve_jobs_total",
                               status="preempted").inc()
            if self.draining:
                # Sealed generation stays journaled `preempted`; the
                # resume=True relaunch re-admits it.
                self.outcomes[w.job.name] = out
                return
            # Elastic re-admit (fence shrink or priority preempt): the
            # job sealed its final generation — back in the queue,
            # resuming from the ring, re-planned against whatever
            # devices the bin-packer now hands it.
            chaos = w.job.chaos
            if chaos is not None and getattr(chaos, "preempt_at",
                                             None) is not None:
                chaos.preempt_at = None   # one-shot: never re-fire
            self.seq += 1
            self.pending.setdefault(
                w.job.tenant, collections.deque()).append(_Pending(
                    job=w.job, spec=w.spec, resume=True,
                    enqueued_at=time.time(), seq=self.seq,
                    token=w.token))
            self.emit("job_requeued", 0, job=w.job.name,
                      tenant=w.job.tenant,
                      reason=w.preempt_reason or "preempted")
            return
        # 'queued' (preemption during a launcher-fault backoff): requeue
        # unless draining.
        if not self.draining:
            self.seq += 1
            self.pending.setdefault(
                w.job.tenant, collections.deque()).append(_Pending(
                    job=w.job, spec={}, resume=True,
                    enqueued_at=time.time(), seq=self.seq,
                    token=w.token))
        else:
            self.outcomes[w.job.name] = out

    # -- status ------------------------------------------------------------

    def stats_doc(self) -> dict:
        with self.lock:
            tenants = {}
            for name, t in sorted(self.tenants.items()):
                tenants[name] = {
                    "queued": self._pending_depth(name),
                    "running": sum(1 for w in self.running.values()
                                   if w.job.tenant == name),
                    "done": t["done"], "failed": t["failed"],
                    "quarantined": t["quarantined"], "shed": t["shed"],
                    "rejected": t["rejected"],
                    "retries_used": t["retries_used"],
                    "retry_budget": t["retry_budget"],
                    "weight": t["weight"],
                }
            for w in self.running.values():
                tenants.setdefault(w.job.tenant, {
                    "queued": 0, "running": 0, "done": 0, "failed": 0,
                    "quarantined": 0, "shed": 0, "rejected": 0,
                    "retries_used": 0,
                    "retry_budget": int(self.cfg["tenant_retry_budget"]),
                    "weight": 1.0})
            return {
                "queue_depth": self._pending_depth(),
                "queue_bound": int(self.cfg["queue_bound"]),
                "saturated": self._saturated(),
                "running": sorted(self.running),
                "fenced_devices": sorted(self.fenced),
                "draining": self.draining,
                "tenants": tenants,
            }


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def serve_fleet(workdir, job_factory=None, *, jobs: Sequence[Job] = (),
                devices=None, resume: bool = False,
                max_concurrent: Optional[int] = None,
                queue_bound: Optional[int] = None,
                tenant_queue_bound: Optional[int] = None,
                tenant_weights: Optional[Dict[str, float]] = None,
                tenant_retry_budget: Optional[int] = None,
                max_job_retries: Optional[int] = None,
                backoff: Optional[float] = None,
                poll_s: Optional[float] = None,
                stop_when_idle_s: Optional[float] = None,
                install_sigterm: bool = True,
                on_event: Optional[Callable[[Event], None]] = None,
                telemetry=None, serve=None,
                control: Optional[ServeControl] = None) -> ServeResult:
    """Run the always-on fleet service until drained (module docstring
    for the full contract).  The caller must NOT hold an initialized
    grid: every job owns a thread-scoped grid lifecycle on its slots.

    - `job_factory(spec) -> igg_torch.Job`: the host-side hook that turns a
      validated submission spec into a runnable job (specs arrive as
      JSON; callables cannot).  Required for online submission and for
      `resume=True` re-admission of journaled submissions.
    - `devices`: the block slots (a list of one device repeated; None:
      one slot on the card, raising without one).
    - `jobs`: pre-seeded :class:`igg_torch.Job` objects admitted at start
      (they bypass the factory but not the queue bounds).
    - `resume=True` reconciles the journal under `workdir`: `done` /
      `quarantined` records are left terminal, `running` / `preempted` /
      `queued` submissions are re-admitted from their journaled specs
      and resume elastically from their rings.
    - `stop_when_idle_s`: return once no work has arrived, run, or
      finished for this many seconds (tests/benches); None (default)
      serves until SIGTERM / :meth:`ServeControl.drain`.
    - `serve` / `telemetry`: the :func:`igg_torch.run_fleet` coercions:
      the statusd endpoint additionally answers ``POST /jobs`` and
      reports the per-tenant section; the telemetry session is shared by
      every nested run.
    - `control`: a :class:`ServeControl` to drive the loop in-process
      (submission, slot fencing, drain).
    """
    if shared.grid_is_initialized():
        raise GridError(
            "serve_fleet: finalize the global grid first — the scheduler "
            "owns per-job grid lifecycles.")
    cfg = _serve_defaults()
    if max_concurrent is not None:
        cfg["max_concurrent"] = int(max_concurrent)
    if queue_bound is not None:
        cfg["queue_bound"] = int(queue_bound)
    if tenant_queue_bound is not None:
        cfg["tenant_queue_bound"] = int(tenant_queue_bound)
    if tenant_retry_budget is not None:
        cfg["tenant_retry_budget"] = int(tenant_retry_budget)
    if poll_s is None:
        poll_s = float(cfg["poll_s"])
    if max_job_retries is None:
        max_job_retries = _fleet._fleet_retries_default()
    if backoff is None:
        backoff = _fleet._fleet_backoff_default()

    devs = _fleet._slots(devices, "serve_fleet")
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    tel = _telemetry.as_session(telemetry)
    tel_owns = tel is not None and not tel.attached
    if tel_owns:
        tel.attach()

    state = _ServeState(workdir, job_factory, devs, cfg, tenant_weights,
                        on_event, tel)
    state.spool.mkdir(exist_ok=True)
    if control is not None:
        control._bind(state)

    _telemetry.emit("run_started", run="serve", resume=resume,
                    devices=len(devs))

    from . import statusd as _statusd

    try:
        srv = _statusd.as_server(serve)
        srv_owns = srv is not None and not srv.started
        if srv_owns:
            srv.start()
    except BaseException:
        if tel_owns:
            tel.detach()
        raise
    if srv is not None:
        srv.watch_fleet(state.jpath)
        srv.watch_serve(state.stats_doc, state.submit)
        state.health = srv.health

    installed = False
    old_handler = None
    if install_sigterm:
        def _sigterm(signum, frame):
            state.request_drain("sigterm")
        try:
            old_handler = signal.signal(signal.SIGTERM, _sigterm)
            installed = True
        except ValueError:
            pass

    drained = False
    try:
        if resume:
            _resume_journal(state)
        for job in jobs:
            if job.make_states is None or (job.step_fn is None
                                           and job.make_step is None):
                raise GridError(f"serve_fleet: job {job.name!r} needs "
                                f"make_states and step_fn (or "
                                f"make_step).")
            spec = {"name": job.name, "tenant": job.tenant,
                    "global_interior": list(job.global_interior),
                    "members": int(job.members),
                    "n_steps": int(job.n_steps),
                    "priority": int(job.priority),
                    "submit_token": "", "deadline_s": job.deadline_s,
                    "n_devices": job.n_devices}
            with state.lock:
                rec = state.journal["jobs"].get(job.name)
                res_job = isinstance(rec, dict) and rec.get(
                    "status") in ("preempted", "running")
                state._enqueue(job, spec, resume=res_job, token="")
            state.emit("job_admitted", 0, job=job.name,
                       tenant=job.tenant, source="seed")

        idle_since = time.monotonic()
        while True:
            state.poll_spool()
            state.poll_chaos()
            state._apply_fences()
            state.reap()
            with state.lock:
                state._shed_expired()
                if not state.draining:
                    state._maybe_preempt()
            state.launch_ready(int(max_job_retries), float(backoff))
            with state.lock:
                busy = bool(state.running) or state._pending_depth() > 0
                if state.draining and not state.running:
                    # Intake is stopped and every worker sealed: queued
                    # submissions stay journaled for resume=True.
                    drained = True
                    break
            if busy:
                idle_since = time.monotonic()
            elif stop_when_idle_s is not None and (
                    time.monotonic() - idle_since) >= stop_when_idle_s:
                break
            time.sleep(poll_s)
        with state.lock:
            state.journal["sealed_at"] = time.time()
            _fleet._write_journal(state.jpath, state.journal)
        if drained:
            _telemetry._auto_dump("serve drain")
    except BaseException as e:
        _telemetry._auto_dump(f"serve_fleet: {type(e).__name__}: {e}")
        raise
    finally:
        if installed:
            signal.signal(signal.SIGTERM, old_handler)
        if srv is not None:
            srv.watch_serve(None, None)
            if state.health is not None:
                state.health.set_queue_saturated(None)
        _telemetry.emit("run_finished", run="serve", drained=drained)
        if srv_owns:
            srv.stop()
        if tel is not None:
            if tel_owns:
                tel.detach()
            else:
                tel.export_metrics()

    return ServeResult(jobs=dict(state.outcomes), shed=list(state.shed),
                       rejected=list(state.rejected),
                       tenants=state.stats_doc()["tenants"],
                       drained=drained, journal=state.jpath)


def _resume_journal(state: _ServeState) -> None:
    """Reconcile a prior session's journal: terminal records stand,
    interrupted submissions are re-admitted from their journaled specs
    and resume elastically from their rings."""
    journal = _fleet._read_journal(state.jpath)
    with state.lock:
        state.journal = journal
        journal.pop("sealed_at", None)
        for name, rec in sorted(journal.get("jobs", {}).items()):
            if not isinstance(rec, dict):
                continue
            status = rec.get("status")
            if status in _TERMINAL:
                continue
            spec = rec.get("spec")
            if not isinstance(spec, dict) or state.job_factory is None:
                continue
            try:
                job = state._build_job({**spec, "name": name})
            except Exception as e:
                state.emit("job_rejected", 0, job=name,
                           tenant=rec.get("tenant"),
                           reason=f"resume_factory_error: "
                                  f"{type(e).__name__}: {e}",
                           source="resume")
                continue
            state.seq += 1
            state.pending.setdefault(
                job.tenant, collections.deque()).append(_Pending(
                    job=job, spec=spec,
                    resume=status in ("preempted", "running"),
                    enqueued_at=time.time(), seq=state.seq,
                    token=rec.get("submit_token", "") or ""))
            state.emit("job_admitted", 0, job=name, tenant=job.tenant,
                       source="resume",
                       resume=status in ("preempted", "running"))
