"""Fleet scheduler: a queue of ensemble jobs drained onto block slots, with
per-job retry, preemption persistence and elastic resume (the port of
`igg/fleet.py`).

A *job* is a config: a global interior, a member count, a member step.
The scheduler owns what a parameter-sweep driver would otherwise redo for
every launch:

- **Packing.**  Each job's Cartesian decomposition is planned against the
  slots that exist (:func:`plan_dims`: balanced factor triples of the slot
  count, the first whose dims divide the job's global interior), and a
  RESUMED queue re-plans against the slots it is given: the job's ring
  re-tiles elastically through `load_checkpoint(redistribute=True)`
  (:func:`igg_torch.run_ensemble` with `resume=True`).
- **Per-job fault domain.**  Inside a job, a diverging member is
  :func:`igg_torch.run_ensemble`'s problem (lane rollback, quarantine).
  Around a job, a LAUNCHER fault (grid init, state build, a transient
  file error) is retried with exponential backoff (`IGG_FLEET_RETRIES`,
  `IGG_FLEET_BACKOFF`); exhaustion marks the job `failed` and the queue
  drains on.  The run's own terminal verdicts (`ResilienceError`,
  `GridError`) are not retried.
- **Preemption.**  SIGTERM (or `resilience.request_preemption`) reaches
  the job's run loop, which writes its final generation; the scheduler
  records `preempted` in the journal and stops draining.
  `run_fleet(..., resume=True)` re-admits every unfinished job: `done`
  jobs are skipped, `preempted`/`running` ones resume from their rings (a
  `job_resumed` event), `queued` ones start fresh.
- **The journal** (`{workdir}/journal.json`, format igg-fleet-journal-v1)
  is the scheduler's commit record: one atomic, fsync'd rewrite per state
  transition (`queued` -> `running` -> `done` | `failed` | `preempted`)
  with each job's attempts, steps done, quarantined members and dims.
  igg and the port read each other's journals (:func:`job_config_hash` is
  igg's byte for byte).

Where the port's route is not igg's: every block of the port's grid lives
on one device, so a "device" of the fleet is a **block slot** on that
device until the multi-GPU backend: `devices=["cuda"] * 8` plans up to 8
blocks on the card, `["cpu"] * 8` on the CPU; a list naming more than one
device raises `GridError`.  :func:`plan_dims` weighs every axis 1 (igg's
weights where devices expose no physical coordinates): the card has none.
Batch packing never applies (one device), so a job asking for it fails
at its first launch with :func:`igg_torch.run_ensemble`'s refusal, and a
heal repack always halves the slot pool.  `serve=` attaches igg's ops
endpoint (:mod:`igg_torch.statusd`) for the whole drain, its `/status`
counting this drain's journal by status.

Chaos: :func:`igg_torch.chaos.scheduler_fault`,
:func:`igg_torch.chaos.job_preempt_at` and
:func:`igg_torch.chaos.throughput_collapse` through the `_CHAOS_JOB_TAP`
seam, consumed one-shot at launch.  `heal=` attaches the
:mod:`igg_torch.heal` engine's lagging-job loop.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import pathlib
import shutil
import signal
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import shared
from . import telemetry as _telemetry
from .resilience import (Event, ResilienceError, clear_preemption,
                         preemption_requested, preemption_requests,
                         request_preemption)
from .shared import NDIMS, GridError

__all__ = ["Job", "JobOutcome", "FleetResult", "run_fleet", "plan_dims",
           "job_config_hash"]

_JOURNAL = "journal.json"
_JOURNAL_FORMAT = "igg-fleet-journal-v1"

# The scheduler's own event kinds; every other event reaching the fleet's
# emitter is a forwarded run_ensemble event, already on the bus.
_SCHEDULER_KINDS = frozenset({
    "job_started", "job_done", "job_failed", "job_gave_up",
    "job_requeued", "job_preempted", "job_resumed", "heal_repack",
    "job_name_reused", "job_admitted", "job_shed", "job_rejected",
    "job_quarantined", "device_fenced",
})

# Chaos seam (igg_torch.chaos.scheduler_fault / job_preempt_at /
# throughput_collapse): {"fault": {job: {"times": n, "message": ...}},
# "preempt": {job: {"step": k}}, "collapse": {job: {"delay_s": s}}},
# consulted at job launch, entries consumed one-shot as they fire.
_CHAOS_JOB_TAP: Optional[dict] = None


def _fleet_retries_default() -> int:
    from . import _env

    return int(_env.integer("IGG_FLEET_RETRIES", 2))


def _fleet_backoff_default() -> float:
    from . import _env

    return float(_env.number("IGG_FLEET_BACKOFF", 0.5))


@dataclasses.dataclass
class Job:
    """One fleet job: a config plus a member count (igg's fields).

    - `name`: unique queue key (the journal's identity across resumes).
    - `step_fn`: the member step (the :func:`igg_torch.run_ensemble`
      contract); `make_step(grid)`, when given, is called after grid init
      and its result serves instead (a step needing grid constants).
    - `make_states(grid) -> [state dicts]`: the M member states on the
      live grid; decomposition-independent (built from global coordinates
      or a global array) for an elastic resume to be bitwise.
    - `global_interior`: the global interior per dim, the
      decomposition-invariant domain (periodic `dims*(n-ol)`, open
      `dims*(n-ol)+ol`); the scheduler plans `dims` and derives each local
      size from it.
    - `members`, `n_steps` and :func:`igg_torch.run_ensemble`'s cadence
      knobs; `tenant`, `priority`, `submitted_at` and `deadline_s` are the
      service's identity, only journaled here.
    - `n_devices`: at most this many slots for the job (None: every slot
      of the drain).  igg's plain drain ignores it (its service's
      admission honors it); the port's caps the plan with it, so one
      drain can run a one-block job beside an 8-block one.
    - `expected_member_steps_per_s`: the heal engine's lag expectation
      (None: the job's own healthy baseline)."""
    name: str
    global_interior: Tuple[int, int, int]
    members: int
    n_steps: int
    make_states: Callable = None
    step_fn: Callable = None
    make_step: Callable = None
    tenant: str = "default"
    priority: int = 0
    submitted_at: Optional[float] = None
    deadline_s: Optional[float] = None
    n_devices: Optional[int] = None
    periods: Tuple[int, int, int] = (1, 1, 1)
    overlaps: Tuple[int, int, int] = (2, 2, 2)
    watch_every: int = 10
    checkpoint_every: int = 10
    ring: int = 3
    member_retries: Optional[int] = None
    steps_per_call: int = 1
    packing: str = "auto"
    chaos: object = None
    expected_member_steps_per_s: Optional[float] = None


@dataclasses.dataclass
class JobOutcome:
    """A job's record in a :class:`FleetResult`: terminal `status`
    ('done', 'failed', 'preempted', or 'queued' when the fleet stopped
    before it), launcher `attempts` consumed, the
    :class:`igg_torch.EnsembleResult` (None unless it ran to a result in
    this drain), its events, and the `dims` it ran under."""
    status: str
    attempts: int
    result: object = None
    events: List[Event] = dataclasses.field(default_factory=list)
    dims: Optional[Tuple[int, int, int]] = None
    error: Optional[str] = None


@dataclasses.dataclass
class FleetResult:
    jobs: Dict[str, JobOutcome]
    preempted: bool
    journal: pathlib.Path


# ---------------------------------------------------------------------------
# Decomposition planning
# ---------------------------------------------------------------------------

def _divisors(n: int) -> List[int]:
    out = set()
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.add(d)
            out.add(n // d)
        d += 1
    return sorted(out)


@functools.lru_cache(maxsize=4096)
def _factor_triples(n: int) -> Tuple[Tuple[int, int, int], ...]:
    """All (dx, dy, dz) with dx*dy*dz == n, most balanced first (the
    `MPI_Dims_create` preference), in a deterministic order."""
    triples = []
    for dx in _divisors(n):
        for dy in _divisors(n // dx):
            triples.append((dx, dy, n // (dx * dy)))
    return tuple(sorted(triples,
                        key=lambda t: (max(t) - min(t), -t[0], -t[1])))


def _plan_score(dims, local, itemsize: int):
    """Wire bytes of one candidate's halo exchange, every axis weighing
    one hop, and the per-link breakdown the `dims_planned` record carries
    (igg's score where devices have no physical coordinates)."""
    elems = 1
    for n in local:
        elems *= int(n)
    nprocs = 1
    for d in dims:
        nprocs *= int(d)
    per_link = []
    total = 0.0
    for d in range(NDIMS):
        if dims[d] <= 1:
            continue
        b = 2 * (elems // int(local[d])) * int(itemsize) * nprocs
        per_link.append({"dim": "xyz"[d], "devices": int(dims[d]),
                         "wire_bytes_per_exchange": int(b),
                         "mean_link_hops": 1.0})
        total += b
    return total, per_link


def plan_dims(global_interior, n_devices: int, *, periods=(1, 1, 1),
              overlaps=(2, 2, 2), itemsize: int = 8,
              devices=None) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Plan a Cartesian decomposition of `global_interior` onto AT MOST
    `n_devices` slots (igg's `plan_dims`): the largest count with a
    factor triple whose dims divide the interior per dim and keep every
    local size a legal grid (`n >= 2`, periodic dims `>= 2*ol - 1`, no
    `ny == 1 < nz`).  Balance first; among equally balanced triples the
    fewest wire bytes (`itemsize` bytes a cell), every axis weighing one
    hop (`hop_cost: "uniform"`), then the enumeration order.  Returns
    `(dims, local)`, the `init_global_grid` arguments, and emits a
    ``dims_planned`` record; raises `GridError` when not even one slot
    fits.  `devices` is accepted for igg's signature; it weighs
    nothing."""
    g = [int(v) for v in global_interior]
    per = [int(v) for v in periods]
    ol = [int(v) for v in overlaps]
    for nd in range(int(n_devices), 0, -1):
        legal = []
        for dims in _factor_triples(nd):
            local = []
            for d in range(NDIMS):
                span = g[d] if per[d] else g[d] - ol[d]
                if span % dims[d]:
                    local = None
                    break
                n = span // dims[d] + ol[d]
                if n < 2 or (per[d] and n < 2 * ol[d] - 1):
                    local = None
                    break
                local.append(n)
            if local is None:
                continue
            if local[1] == 1 and local[2] > 1:
                continue          # init_global_grid's ny/nz rule
            legal.append((tuple(dims), tuple(local)))
        if not legal:
            continue
        best = None
        for idx, (dims, local) in enumerate(legal):
            score, per_link = _plan_score(dims, local, itemsize)
            key = (max(dims) - min(dims), score, idx)
            if best is None or key < best[0]:
                best = (key, dims, local, per_link)
        (_, score, _), dims, local, per_link = best
        _telemetry.emit("dims_planned", global_interior=list(g),
                        n_devices=int(n_devices), dims=list(dims),
                        local=list(local), itemsize=int(itemsize),
                        candidates=len(legal), hop_cost="uniform",
                        predicted_wire_cost=round(float(score), 1),
                        per_link=per_link)
        return dims, local
    raise GridError(
        f"plan_dims: no decomposition of global interior {g} "
        f"(periods {per}, overlaps {ol}) fits onto <= {n_devices} "
        f"device(s).")


# ---------------------------------------------------------------------------
# The queue journal
# ---------------------------------------------------------------------------

def _read_journal(path: pathlib.Path) -> dict:
    try:
        j = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return {"format": _JOURNAL_FORMAT, "jobs": {}}
    if j.get("format") != _JOURNAL_FORMAT or not isinstance(
            j.get("jobs"), dict):
        return {"format": _JOURNAL_FORMAT, "jobs": {}}
    return j


def job_config_hash(job: Job) -> str:
    """Identity stamp of a job's config (global interior, members,
    n_steps, tenant), journaled with every record: a new job reusing a
    finished job's name is a fresh job (`job_name_reused`), not a
    skip."""
    key = json.dumps([list(int(v) for v in job.global_interior),
                      int(job.members), int(job.n_steps),
                      str(job.tenant)])
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _write_journal(path: pathlib.Path, journal: dict) -> None:
    from .checkpoint import _write_atomic_text

    # The queue's commit record: the file is fsync'd before the rename and
    # the directory after, so a power cut cannot leave a torn journal that
    # a resume reads as "everything queued".
    _write_atomic_text(path, json.dumps(journal, indent=1, sort_keys=True),
                       durable=True)


def _journal_record(journal: dict, job: Job) -> dict:
    """The job's record, created queued if absent; the keys an older
    journal lacks are filled in from the job."""
    rec = journal["jobs"].setdefault(job.name, {
        "status": "queued", "attempts": 0, "steps_done": 0,
        "members": job.members, "quarantined": [], "dims": None})
    rec.setdefault("status", "queued")
    rec.setdefault("attempts", 0)
    rec.setdefault("steps_done", 0)
    rec.setdefault("quarantined", [])
    rec.setdefault("dims", None)
    rec.setdefault("tenant", job.tenant)
    rec.setdefault("priority", int(job.priority))
    rec.setdefault("submitted_at", job.submitted_at)
    rec.setdefault("deadline_s", job.deadline_s)
    rec.setdefault("config_hash", job_config_hash(job))
    return rec


def _reused_name(journal: dict, job: Job) -> bool:
    """True when `job` reuses the name of a journaled record with another
    config hash (records without a hash keep the skip/resume rules)."""
    rec = journal["jobs"].get(job.name)
    if not isinstance(rec, dict):
        return False
    stamped = rec.get("config_hash")
    return stamped is not None and stamped != job_config_hash(job)


def _reset_for_reuse(journal: dict, jobdir: pathlib.Path, job: Job,
                     _emit) -> None:
    """Make a reused name a fresh job: `job_name_reused`, the stale record
    dropped, the earlier job's ring removed."""
    old = journal["jobs"].pop(job.name, {}) or {}
    _emit("job_name_reused", 0, job=job.name, tenant=job.tenant,
          prior_status=old.get("status"),
          prior_config_hash=old.get("config_hash"),
          config_hash=job_config_hash(job))
    shutil.rmtree(jobdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

def _consume_tap(kind: str, job: str):
    """Pop one chaos entry of `kind` for `job` (one-shot)."""
    global _CHAOS_JOB_TAP
    tap = _CHAOS_JOB_TAP
    if not tap or job not in tap.get(kind, {}):
        return None
    entry = tap[kind][job]
    if kind == "fault":
        entry["times"] -= 1
        if entry["times"] <= 0:
            tap[kind].pop(job)
    else:
        tap[kind].pop(job)
    if not any(tap.get(k) for k in tap):
        _CHAOS_JOB_TAP = None
    return entry


def _slots(devices, caller: str = "run_fleet") -> List[torch.device]:
    """The slot list: every entry a `torch.device`, all naming one device
    (None: one slot on the card; no card raises)."""
    from .device import same_device
    from .init import resolve_device

    if devices is None:
        return [resolve_device(None)]
    devs = [resolve_device(d) for d in devices]
    if any(not same_device(d, devs[0]) for d in devs):
        raise GridError(
            f"{caller}: devices={[str(d) for d in devs]} names more than "
            f"one device; the port's grid lives on one device, so its "
            f"devices are block slots of one device until the multi-GPU "
            f"backend (ROADMAP, the NCCL item).")
    return devs


def run_fleet(jobs: Sequence[Job], workdir, *, devices=None,
              resume: bool = False, max_job_retries: Optional[int] = None,
              backoff: Optional[float] = None,
              install_sigterm: bool = True,
              on_event: Optional[Callable[[Event], None]] = None,
              telemetry=None, serve=None, heal=None) -> FleetResult:
    """Drain `jobs` in order (module docstring for the contract).  The
    caller must not hold an initialized grid: the scheduler owns one grid
    per job.  `devices`: the block slots (a list of one device repeated;
    None: one slot on the card).  `resume=True` reconciles against the
    journal under `workdir`.  `on_event` receives every job-scoped event
    (detail carries `job`); `telemetry` attaches one session for the whole
    drain (the :func:`igg_torch.run_resilient` contract: lifecycle spans
    ``fleet.job``, the ``igg_fleet_queue_depth`` gauge, the
    ``igg_fleet_jobs_total{status}`` counters).

    `heal` attaches the :mod:`igg_torch.heal` engine (None:
    ``IGG_HEAL``-driven; True, a policy, an engine, or False): a job whose
    measured ``member_steps_per_s`` falls below the policy's
    `throughput_tol` times its `Job.expected_member_steps_per_s` (or its
    own healthy baseline) for `sustain` windows is preempted at the next
    dispatch, writes its final generation, and is re-admitted at once on
    half the slots, resuming elastically (a ``heal_repack`` event).
    `serve` attaches the live ops endpoint (:mod:`igg_torch.statusd`, the
    :func:`igg_torch.run_resilient` contract: None is
    ``IGG_STATUSD_PORT``-driven, an int port, True, a shared server, or
    False) for the WHOLE drain; its `/status` also counts this drain's
    queue journal by status."""
    if shared.grid_is_initialized():
        raise GridError(
            "run_fleet: finalize the global grid first — the scheduler "
            "initializes one grid per job.")
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        raise GridError(f"run_fleet: duplicate job names in {names}.")
    for j in jobs:
        if j.make_states is None or (j.step_fn is None
                                     and j.make_step is None):
            raise GridError(f"run_fleet: job {j.name!r} needs make_states "
                            f"and step_fn (or make_step).")
    if max_job_retries is None:
        max_job_retries = _fleet_retries_default()
    if backoff is None:
        backoff = _fleet_backoff_default()
    devs = _slots(devices)
    # The lagging-job loop (igg_torch.heal): the engine watches each job's
    # nested step_stats windows; coerced before anything is attached.
    from . import heal as _heal

    heal_eng = _heal.as_engine(heal, run="fleet")

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    jpath = workdir / _JOURNAL
    journal = _read_journal(jpath) if resume else {
        "format": _JOURNAL_FORMAT, "jobs": {}}
    outcomes: Dict[str, JobOutcome] = {}

    def _emit(kind, step, **detail) -> Event:
        ev = Event(kind, step, detail)
        # Only the scheduler's own kinds go to the bus here: the nested
        # run_ensemble events are on it already (run="ensemble").
        if kind in _SCHEDULER_KINDS:
            _telemetry.emit(kind, step=step, run="fleet", **detail)
        if on_event is not None:
            on_event(ev)
        return ev

    tel = _telemetry.as_session(telemetry)
    tel_owns = tel is not None and not tel.attached
    if tel_owns:
        tel.attach()
    _telemetry.emit("run_started", run="fleet", jobs=len(jobs),
                    resume=resume)
    # The live ops endpoint (igg_torch.statusd) for the whole drain; its
    # /status reads this drain's journal.  Started after the heal=
    # coercion (a GridError there must not leak a bound server); a bind
    # failure must not leak the drain-owned session.
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
        srv.watch_fleet(jpath)
    if heal_eng is not None:
        heal_eng.attach()
    m_queue = _telemetry.gauge("igg_fleet_queue_depth")

    def _queue_depth() -> int:
        """Jobs that still owe work in this drain."""
        done = sum(1 for o in outcomes.values()
                   if o.status in ("done", "failed"))
        return len(jobs) - done

    def _jrec(job: Job) -> dict:
        return _journal_record(journal, job)

    def _transition(job: Job, **updates) -> None:
        _jrec(job).update(updates)
        journal["jobs"][job.name]["updated_at"] = time.time()
        _write_journal(jpath, journal)

    installed = False
    old_handler = None
    if install_sigterm:
        try:
            old_handler = signal.signal(signal.SIGTERM, request_preemption)
            installed = True
        except ValueError:
            pass

    fleet_preempted = False
    m_queue.set(_queue_depth())
    try:
        for job in jobs:
            if resume and _reused_name(journal, job):
                # Same name, another config: a new job, never skipped as
                # finished nor resumed from the other config's ring.
                _reset_for_reuse(journal, workdir / "jobs" / job.name,
                                 job, _emit)
                _write_journal(jpath, journal)
            rec = _jrec(job)
            if resume and rec["status"] == "done":
                outcomes[job.name] = JobOutcome(
                    status="done", attempts=rec["attempts"],
                    dims=tuple(rec["dims"]) if rec["dims"] else None)
                m_queue.set(_queue_depth())
                continue
            if fleet_preempted or preemption_requested():
                fleet_preempted = True
                outcomes[job.name] = JobOutcome(status="queued",
                                                attempts=rec["attempts"])
                break
            resume_job = resume and rec["status"] in ("preempted",
                                                      "running")
            with _telemetry.span("fleet.job", job=job.name,
                                 resume=resume_job):
                outcome = _run_job(job, workdir / "jobs" / job.name, devs,
                                   resume_job, max_job_retries, backoff,
                                   _emit, _transition, rec, tel, heal_eng)
            outcomes[job.name] = outcome
            _telemetry.counter("igg_fleet_jobs_total",
                               status=outcome.status).inc()
            m_queue.set(_queue_depth())
            # Stop on an in-run preemption, a preemption during a
            # launcher-fault backoff (the job went back to 'queued'), or a
            # SIGTERM after the run loop last looked (run_ensemble leaves
            # the flag to this scheduler, its owner).
            if outcome.status == "preempted" or preemption_requested():
                fleet_preempted = True
                break
        for job in jobs:
            if job.name not in outcomes:
                outcomes[job.name] = JobOutcome(
                    status="queued",
                    attempts=journal["jobs"].get(job.name,
                                                 {}).get("attempts", 0))
        _write_journal(jpath, journal)
        if fleet_preempted:
            _telemetry._auto_dump("fleet drain preempted")
    except BaseException as e:
        _telemetry._auto_dump(f"run_fleet: {type(e).__name__}: {e}")
        raise
    finally:
        if heal_eng is not None:
            heal_eng.detach()
        if installed:
            signal.signal(signal.SIGTERM, old_handler)
            # Only the handler's owner clears the flag: with
            # install_sigterm=False a supervisor owns it.
            clear_preemption()
        _telemetry.emit("run_finished", run="fleet",
                        preempted=fleet_preempted)
        if srv_owns:
            srv.stop()
        if tel is not None:
            if tel_owns:
                tel.detach()
            else:
                tel.export_metrics()

    return FleetResult(jobs=outcomes, preempted=fleet_preempted,
                       journal=jpath)


def _repack_choice(job: Job, served: str, devs) -> Tuple[str, list]:
    """Where a lagging job is re-admitted (the heal repack loop): igg
    flips grid <-> batch where batch is admissible; the port has one
    device, so batch never is, and the job keeps its packing on half the
    slots."""
    return served, list(devs)[:max(1, len(devs) // 2)]


def _run_job(job: Job, jobdir: pathlib.Path, devs, resume_job: bool,
             max_job_retries: int, backoff: float, _emit, _transition,
             rec, tel, heal_eng=None) -> JobOutcome:
    """Launch one job with retry and exponential backoff around LAUNCHER
    faults (grid init, planning, state build); a fault inside the run is
    the ensemble's."""
    from .chaos import InjectedSchedulerFault
    from .ensemble import run_ensemble
    from .finalize import finalize_global_grid
    from .init import init_global_grid

    events: List[Event] = []

    def job_event(ev: Event) -> None:
        ev2 = Event(ev.kind, ev.step, {**ev.detail, "job": job.name})
        events.append(ev2)
        _emit(ev.kind, ev.step, **ev2.detail)

    attempt = rec["attempts"]   # journal-cumulative: every launch, ever
    faults = 0                  # this drain's launcher faults: the budget
    delay = backoff
    packing = job.packing       # a heal repack re-admits the job on
    launch_devs = list(devs)    # another slot pool
    expected_rate = job.expected_member_steps_per_s
    while True:
        attempt += 1
        _transition(job, status="running", attempts=attempt)
        try:
            fault = _consume_tap("fault", job.name)
            if fault is not None:
                raise InjectedSchedulerFault(
                    fault.get("message")
                    or f"injected launcher fault for job {job.name!r}")
            # Batch packing needs the one-block grid (the member axis spans
            # the devices); otherwise as many slots as divide the domain,
            # at most the job's `n_devices`.
            cap = 1 if packing == "batch" else len(launch_devs)
            if job.n_devices:
                cap = min(cap, int(job.n_devices))
            dims, local = plan_dims(job.global_interior, cap,
                                    periods=job.periods,
                                    overlaps=job.overlaps)
            ndev = int(np.prod(dims))
            init_global_grid(
                *local, dimx=dims[0], dimy=dims[1], dimz=dims[2],
                periodx=job.periods[0], periody=job.periods[1],
                periodz=job.periods[2], overlapx=job.overlaps[0],
                overlapy=job.overlaps[1], overlapz=job.overlaps[2],
                nprocs=ndev, device=launch_devs[0], quiet=True)
            try:
                grid = shared.global_grid()
                step_fn = (job.make_step(grid) if job.make_step is not None
                           else job.step_fn)
                states = job.make_states(grid)
                chaos = job.chaos
                pre = _consume_tap("preempt", job.name)
                if pre is not None:
                    from .chaos import ChaosPlan

                    if chaos is None:
                        chaos = ChaosPlan(preempt_at=pre["step"])
                    else:
                        chaos.preempt_at = pre["step"]
                # Throughput collapse: a rate limit on the probes'
                # readiness for this launch only, so a re-admission runs
                # clean.
                collapse = _consume_tap("collapse", job.name)
                slowdown = None
                if collapse is not None:
                    from .chaos import FetchDelay

                    slowdown = FetchDelay(collapse["delay_s"]).arm()
                job_event(Event("job_started", 0,
                                {"attempt": attempt, "dims": list(dims),
                                 "devices": ndev, "resume": resume_job,
                                 "packing": packing}))
                if heal_eng is not None:
                    heal_eng.watch_job(job.name, expected_rate)
                # The drain's session passes through (already attached);
                # telemetry=False without one, so the nested run does not
                # attach a second session on the same files.
                try:
                    res = run_ensemble(
                        step_fn, states, job.n_steps, members=job.members,
                        watch_every=job.watch_every,
                        checkpoint_dir=jobdir,
                        checkpoint_every=job.checkpoint_every,
                        ring=job.ring,
                        member_retries=job.member_retries,
                        resume=resume_job,
                        steps_per_call=job.steps_per_call,
                        packing=packing, devices=[launch_devs[0]],
                        install_sigterm=False, on_event=job_event,
                        telemetry=tel if tel is not None else False,
                        serve=False, chaos=chaos)
                finally:
                    if slowdown is not None:
                        slowdown.disarm()
                    if heal_eng is not None:
                        heal_eng.unwatch_job()
                if resume_job and any(e.kind == "resume"
                                      for e in res.events):
                    job_event(Event("job_resumed",
                                    next(e.step for e in res.events
                                         if e.kind == "resume"),
                                    {"devices": ndev, "dims": list(dims)}))
            finally:
                finalize_global_grid()
        except Exception as e:          # a launcher fault: retry
            if shared.grid_is_initialized():
                finalize_global_grid()
            if heal_eng is not None:
                # A repack planned for this job must not outlive its
                # failure: consume the plan and the engine's preemption
                # request (an operator signal racing the clear is
                # restored).
                rc = heal_eng.take_repack(job.name)
                if rc is not None:
                    clear_preemption()
                    if preemption_requests() > rc:
                        request_preemption()
            job_event(Event("job_failed", 0,
                            {"attempt": attempt,
                             "error": f"{type(e).__name__}: {e}"}))
            # Only launcher faults are transient: the run's own verdicts
            # (every member quarantined, an invalid config) fail the same
            # way on every replay.
            faults += 1
            terminal = isinstance(e, (ResilienceError, GridError))
            if terminal or faults > max_job_retries:
                _transition(job, status="failed", attempts=attempt)
                job_event(Event("job_gave_up", 0, {"attempts": attempt,
                                                   "terminal": terminal}))
                return JobOutcome(status="failed", attempts=attempt,
                                  events=events,
                                  error=f"{type(e).__name__}: {e}")

            def _requeued():
                # A preemption around the backoff hands the job back to
                # the queue instead of relaunching it just to stop.
                _transition(job, status="queued", attempts=attempt)
                job_event(Event("job_requeued", 0,
                                {"reason": "preempted during "
                                           "launcher-fault backoff"}))
                return JobOutcome(status="queued", attempts=attempt,
                                  events=events,
                                  error=f"{type(e).__name__}: {e}")

            if preemption_requested():
                return _requeued()
            time.sleep(delay)
            delay = min(delay * 2, 30.0)
            if preemption_requested():   # SIGTERM during the sleep
                return _requeued()
            continue

        repack_count = (heal_eng.take_repack(job.name)
                        if heal_eng is not None else None)
        if (repack_count is not None
                and preemption_requests() > repack_count):
            # A further preemption request (an operator SIGTERM) raced the
            # heal action: honor it; the job stands preempted.
            repack_count = None
        if res.preempted and repack_count is not None:
            # The heal engine's preemption: the job measured below its
            # expectation and wrote its final generation.  Re-admit it at
            # once on half the slots, resuming from the ring; the
            # engine's request is consumed here (the flag is this
            # scheduler's: run_ensemble ran with install_sigterm=False).
            clear_preemption()
            if preemption_requests() > repack_count:
                # A SIGTERM between the guard and the clear: restore it.
                request_preemption()
            new_packing, new_devs = _repack_choice(job, res.packing,
                                                   launch_devs)
            if expected_rate is not None and len(new_devs) < len(
                    launch_devs):
                # Fewer slots deliver less: scale the expectation, or the
                # re-admitted job would lag against the stale one.
                expected_rate *= len(new_devs) / len(launch_devs)
            _transition(job, status="preempted", attempts=attempt,
                        steps_done=res.steps_done,
                        quarantined=res.quarantined, dims=list(dims))
            job_event(Event("heal_repack", res.steps_done,
                            {"from_packing": res.packing,
                             "packing": new_packing,
                             "from_devices": len(launch_devs),
                             "devices": len(new_devs),
                             "reason": "throughput_lag"}))
            heal_eng.record_done("repack", job=job.name,
                                 from_packing=res.packing,
                                 packing=new_packing)
            packing, launch_devs = new_packing, new_devs
            resume_job = True
            continue
        if not res.preempted and repack_count is not None:
            # The job finished before the engine's request landed: consume
            # the stale request (a racing operator signal stays standing).
            clear_preemption()
            if preemption_requests() > repack_count:
                request_preemption()
        status = "preempted" if res.preempted else "done"
        _transition(job, status=status, attempts=attempt,
                    steps_done=res.steps_done,
                    quarantined=res.quarantined, dims=list(dims))
        job_event(Event("job_preempted" if res.preempted else "job_done",
                        res.steps_done,
                        {"quarantined": res.quarantined,
                         "retries": {str(m): r
                                     for m, r in res.retries.items()}}))
        return JobOutcome(status=status, attempts=attempt, result=res,
                          events=events, dims=tuple(dims))
