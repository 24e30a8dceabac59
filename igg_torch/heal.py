"""The self-healing control plane: detection -> action loops over the
event bus (the port of `igg/heal.py`).

A :class:`HealEngine` subscribes to the bus (:func:`igg_torch.telemetry.
subscribe`) and drives recovery machinery the run loops already have,
with igg's loops:

1. **Stall or straggler -> elastic re-tile.**  A ``collective_stall``
   record (the :class:`igg_torch.comm.StallWatchdog` heartbeat), a
   ``rank_skew`` record beyond tolerance (``comm.rank_skew(
   publish=True)``), or the run's own ``step_stats`` windows sustained
   beyond ``skew_tol`` times its healthy baseline plan a **retile**:
   :func:`igg_torch.run_resilient` seals a generation, fences the suspect
   slot(s), re-plans `dims` over the rest (:func:`igg_torch.fleet.
   plan_dims`), re-initializes the grid and resumes elastically from the
   sealed generation (`load_checkpoint(redistribute=True)`), bitwise.
2. **Cost-model drift -> recalibrate.**  A ``cost_model_drift`` record
   plans :func:`recalibrate`: the family's ledger entries invalidated,
   re-measured, the prediction re-registered, a ``recalibrated`` record.
3. **Silent corruption -> fence the suspect.**  An attributed
   ``integrity_violation`` (the loop has rolled back onto a verified
   generation) plans a retile fencing the block the violation names.
4. **Lagging fleet job -> repack.**  A fleet job whose
   ``member_steps_per_s`` falls below ``throughput_tol`` times its
   expectation is preempted at the next dispatch and re-admitted by
   :func:`igg_torch.run_fleet` on half the slots.

One budget and hysteresis policy (:class:`HealPolicy`) governs every
loop: a soft signal must be sustained, at most `max_actions` actions a
run, `cooldown_s` between actions, one pending action of a kind; past the
budget a persistent signal walks the `escalation` ladder: ``"demote"``
(:func:`igg_torch.degrade.demote_active`), then ``"fail"``
(:class:`HealEscalation`).  Every decision is a ``heal_*`` bus record.
The engine itself touches no device and no grid: it plans into a queue
the run loop reads at its dispatch boundaries (one deque check an
iteration when idle).

Where the port's route is not igg's: every block of the port's grid lives
on one device, so a re-tile re-plans the block SLOTS of that device
(:meth:`HealEngine.plan_retile`); fencing a sick card waits for the
multi-GPU backend.  On the card a ``demote`` step cannot serve the truth
tier (the port does not serve it there): the run loop raises
:class:`HealEscalation` instead.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import _env
from . import telemetry as _telemetry
from .resilience import ResilienceError
from .shared import GridError

__all__ = ["HealPolicy", "HealEngine", "HealEscalation", "recalibrate",
           "as_engine"]


class HealEscalation(ResilienceError):
    """The end of the escalation ladder: the budget is spent, the ladder's
    ``demote`` step (if configured) was taken or refused, and the signal
    persists.  A :class:`igg_torch.ResilienceError`: `.events` holds the
    run's events, `.dump_paths` the flight-recorder dumps (named in the
    message)."""


def _policy_field(env: str, default):
    return dataclasses.field(
        default_factory=lambda: type(default)(_env.number(env, default)))


@dataclasses.dataclass
class HealPolicy:
    """The budget and hysteresis governor of every heal loop.

    - `max_actions`: actions the engine may take in a run.
    - `cooldown_s`: seconds between consecutive actions.
    - `sustain`: consecutive observations a soft signal (window
      inflation, a lagging job, rank skew) needs before an action;
      ``collective_stall``, ``integrity_violation`` and
      ``cost_model_drift`` act on the first record.
    - `skew_tol`: a window slower than ``skew_tol`` times the healthy
      baseline (or a rank skew beyond it) is a straggler.
    - `throughput_tol`: a job below ``throughput_tol`` times its
      expectation lags.
    - `baseline_windows`: windows that set the healthy baseline.
    - `retile_drop`: slots fenced from the tail when the suspect is not a
      block.
    - `escalation`: the ladder past the budget, a subset of ``("demote",
      "fail")`` in order.

    Defaults come from the ``IGG_HEAL_*`` knobs."""
    max_actions: int = _policy_field("IGG_HEAL_MAX_ACTIONS", 3)
    cooldown_s: float = _policy_field("IGG_HEAL_COOLDOWN", 60.0)
    sustain: int = _policy_field("IGG_HEAL_SUSTAIN", 2)
    skew_tol: float = _policy_field("IGG_HEAL_SKEW_TOL", 4.0)
    throughput_tol: float = _policy_field("IGG_HEAL_THROUGHPUT_TOL", 0.5)
    baseline_windows: int = 3
    retile_drop: int = 1
    escalation: Tuple[str, ...] = ("demote", "fail")

    def __post_init__(self):
        if self.max_actions < 0 or self.sustain < 1 or self.cooldown_s < 0:
            raise GridError(
                "HealPolicy: max_actions must be >= 0, sustain >= 1, "
                "cooldown_s >= 0.")
        bad = [s for s in self.escalation if s not in ("demote", "fail")]
        if bad:
            raise GridError(f"HealPolicy: unknown escalation step(s) {bad} "
                            f"(expected 'demote' and/or 'fail').")


class HealEngine:
    """One run's detection -> action controller (module docstring).

    The run loops call :meth:`attach` at entry and :meth:`detach` in their
    finally; detectors run on the emitting thread (the loop, the stall
    heartbeat); actions are planned into a queue that the loop reads at
    its next dispatch boundary (:meth:`has_pending`, :meth:`pop`)."""

    def __init__(self, policy: Optional[HealPolicy] = None,
                 run: str = "resilient"):
        self.policy = policy if policy is not None else HealPolicy()
        self.run = run
        self.actions: List[Dict] = []      # executed actions, in order
        self.skipped: List[Dict] = []      # planned but unactionable
        self.suppressed = 0                # decisions not to act
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._pending_kinds: set = set()
        self._sustain: Dict[Tuple, int] = {}
        self._acted: set = set()           # keys that took an action
        self._skip_kinds: set = set()      # kinds proven unactionable
        self._last_action_t: Optional[float] = None
        self._last_suppressed_t: Dict[Tuple, float] = {}
        self._esc_idx = 0                  # next escalation step
        self._windows: List[float] = []    # healthy-baseline ms/step
        self._baseline: Optional[float] = None
        self._attached = False
        # The fleet job watch (loop 4): a planned repack keeps the
        # preemption request count its own request produced, so the
        # scheduler tells it from an operator SIGTERM racing it.
        self._job: Optional[str] = None
        self._job_expected: Optional[float] = None
        self._job_windows: List[float] = []
        self._repack_jobs: Dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------
    def attach(self) -> "HealEngine":
        if not self._attached:
            self._attached = True
            _telemetry.subscribe(self._on_record)
        return self

    def detach(self) -> None:
        if self._attached:
            self._attached = False
            _telemetry.unsubscribe(self._on_record)

    def __enter__(self) -> "HealEngine":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()

    # -- the run-loop surface ----------------------------------------------
    def has_pending(self) -> bool:
        """Whether an action waits for the loop (a deque's truth)."""
        return bool(self._pending)

    def pop(self) -> Optional[Dict]:
        """The next planned action (first in, first out), or None."""
        with self._lock:
            if not self._pending:
                return None
            act = self._pending.popleft()
            self._pending_kinds.discard(act["action"])
            return act

    def record_done(self, action: str, **detail) -> None:
        """Record an executed action (its plan already took the budget)."""
        with self._lock:
            self.actions.append({"action": action, **detail})

    def record_skipped(self, action: str, **detail) -> None:
        """A planned action proved unactionable (no ring to seal, no
        decomposition for the survivors): the budget is refunded, and the
        kind is not planned again."""
        with self._lock:
            self.skipped.append({"action": action, **detail})
            self._skip_kinds.add(action)

    # -- the fleet job watch (loop 4) --------------------------------------
    def watch_job(self, name: str,
                  expected_member_steps_per_s: Optional[float]) -> None:
        """Arm lag detection for one fleet job: its run_ensemble windows
        against the expectation (None: the job's own healthy
        baseline)."""
        with self._lock:
            self._job = name
            self._job_expected = expected_member_steps_per_s
            self._job_windows = []
            self._sustain.pop(("lag", name), None)

    def unwatch_job(self) -> None:
        with self._lock:
            self._job = None
            self._job_expected = None
            self._job_windows = []

    def reset_baseline(self) -> None:
        """Forget the healthy ms/step baseline (after a re-tile: the
        smaller grid is slower per step, legitimately)."""
        with self._lock:
            self._windows = []
            self._baseline = None
            self._sustain.pop(("straggler",), None)

    def take_repack(self, name: str) -> Optional[int]:
        """Consume a planned repack for `name` and its queue entry;
        returns the preemption request count the engine's own request
        produced (None: no repack planned).  A higher live count means an
        operator signal raced the heal action."""
        with self._lock:
            if name not in self._repack_jobs:
                return None
            count = self._repack_jobs.pop(name)
            for act in list(self._pending):
                if act["action"] == "repack" and act.get("job") == name:
                    self._pending.remove(act)
                    self._pending_kinds.discard("repack")
            return count

    # -- detection ---------------------------------------------------------
    def _on_record(self, rec) -> None:
        kind = rec.kind
        if kind == "collective_stall":
            if rec.payload.get("run") == self.run:
                self._signal(("stall",), "retile", sustain=1,
                             reason="collective_stall", step=rec.step)
        elif kind == "integrity_violation":
            # An attributed corruption verdict: the loop has rolled back;
            # the block that corrupted the arithmetic stops serving.
            if rec.payload.get("run") == self.run:
                rank = rec.payload.get("rank")
                self._signal(("integrity",), "retile", sustain=1,
                             reason="integrity_violation", step=rec.step,
                             suspects=([int(rank)] if rank is not None
                                       else None),
                             invariant=rec.payload.get("invariant"),
                             field=rec.payload.get("field"))
        elif kind == "cost_model_drift":
            # Advisory: re-anchor once per family, never escalate.
            fam = rec.payload.get("family")
            self._signal(("drift", fam), "recalibrate", sustain=1,
                         once=True, escalate=False,
                         reason="cost_model_drift", family=fam,
                         tier=rec.payload.get("tier"),
                         rel_error=rec.payload.get("rel_error"))
        elif kind == "rank_skew":
            skew = rec.payload.get("max_skew_ms")
            median = rec.payload.get("median_ms")
            if (isinstance(skew, (int, float))
                    and isinstance(median, (int, float)) and median > 0
                    and skew > (self.policy.skew_tol - 1.0) * median):
                # `suspect_rank` names a process, not a block: the retile
                # takes the policy's default fence.
                self._signal(("skew",), "retile",
                             reason="rank_skew_excess", skew_ms=skew,
                             suspect_rank=rec.payload.get("worst_rank"))
        elif kind == "step_stats":
            self._on_window(rec)

    def _on_window(self, rec) -> None:
        p = rec.payload
        ms = p.get("ms_per_step")
        if not isinstance(ms, (int, float)) or ms <= 0:
            return
        run = p.get("run")
        # Loop 4: a watched fleet job's ensemble windows.
        if run == "ensemble" and self._job is not None:
            rate = p.get("member_steps_per_s", p.get("steps_per_s"))
            if not isinstance(rate, (int, float)):
                return
            with self._lock:
                expected = self._job_expected
                if expected is None:
                    self._job_windows.append(rate)
                    if len(self._job_windows) < self.policy.baseline_windows:
                        return
                    w = sorted(self._job_windows)
                    expected = w[len(w) // 2]
                    # The derived baseline is frozen.
                    self._job_expected = expected
                    self._job_windows = []
                job = self._job
            if rate < self.policy.throughput_tol * expected:
                # escalate=False: the scheduler consumes repack plans
                # only; a job still lagging past the budget is suppressed.
                self._signal(("lag", job), "repack", escalate=False,
                             job=job, reason="throughput_lag",
                             measured=rate, expected=expected)
            else:
                with self._lock:
                    self._sustain.pop(("lag", job), None)
            return
        if run != self.run:
            return
        # Loop 1's soft half: window inflation against the run's own
        # healthy baseline.
        with self._lock:
            if self._baseline is None:
                self._windows.append(float(ms))
                if len(self._windows) < self.policy.baseline_windows:
                    return
                w = sorted(self._windows)
                self._baseline = w[len(w) // 2]
                return
            baseline = self._baseline
        if ms > self.policy.skew_tol * baseline:
            self._signal(("straggler",), "retile",
                         reason="window_inflation", ms_per_step=ms,
                         baseline_ms=baseline)
        else:
            with self._lock:
                self._sustain.pop(("straggler",), None)

    # -- the budget and hysteresis governor --------------------------------
    def _signal(self, key: Tuple, action: str, sustain: Optional[int] = None,
                once: bool = False, escalate: bool = True,
                **detail) -> None:
        pol = self.policy
        now = time.monotonic()
        plan = None
        with self._lock:
            need = pol.sustain if sustain is None else sustain
            n = self._sustain.get(key, 0) + 1
            self._sustain[key] = n
            if n < need:
                return
            self._sustain[key] = 0
            if once and key in self._acted:
                self._suppress(key, now, "already_acted", detail)
                return
            if action in self._skip_kinds:
                self._suppress(key, now, "unactionable", detail)
                return
            if action in self._pending_kinds:
                self._suppress(key, now, "already_pending", detail)
                return
            in_cooldown = (self._last_action_t is not None
                           and now - self._last_action_t < pol.cooldown_s)
            if len(self.actions) + len(self._pending) >= pol.max_actions:
                # Budget spent: walk the ladder, one step at a time and
                # cooldown-separated; advisory signals only suppress.
                if not escalate:
                    self._suppress(key, now, "budget_exhausted", detail)
                    return
                if in_cooldown:
                    self._suppress(key, now, "cooldown", detail)
                    return
                if self._esc_idx >= len(pol.escalation):
                    self._suppress(key, now, "budget_exhausted", detail)
                    return
                step = pol.escalation[self._esc_idx]
                self._esc_idx += 1
                self._last_action_t = now
                plan = {**detail, "action": step, "reason": "escalation",
                        "escalated_from": action,
                        "signal_reason": detail.get("reason")}
                self._pending.append(plan)
                self._pending_kinds.add(step)
            else:
                if in_cooldown:
                    self._suppress(key, now, "cooldown", detail)
                    return
                self._last_action_t = now
                self._acted.add(key)
                plan = {"action": action, **detail}
                self._pending.append(plan)
                self._pending_kinds.add(action)
                if action == "repack" and detail.get("job"):
                    from .resilience import preemption_requests

                    self._repack_jobs[detail["job"]] = \
                        preemption_requests() + 1
        if plan["reason"] == "escalation":
            _telemetry.emit("heal_escalated", run=self.run, **plan)
        else:
            _telemetry.emit("heal_planned", run=self.run, **plan)
        # Loop 4's action goes through the preemption flag: the scheduler
        # is inside the job's run loop, which stops at its next dispatch
        # boundary with its final generation written.
        if plan.get("action") == "repack":
            from .resilience import request_preemption

            request_preemption()

    def _suppress(self, key, now, why, detail) -> None:
        # Under self._lock.  The count is exact; the bus record at most
        # once per key per cooldown (at least a second).
        self.suppressed += 1
        last = self._last_suppressed_t.get(key)
        throttle = max(1.0, self.policy.cooldown_s)
        if last is not None and now - last < throttle:
            return
        self._last_suppressed_t[key] = now
        _telemetry.emit("heal_suppressed", run=self.run, why=why,
                        signal=key[0], suppressed_total=self.suppressed,
                        **{k: v for k, v in detail.items()
                           if k in ("job", "family", "reason")})

    # -- the retile plan (executed by igg_torch.run_resilient) -------------
    def plan_retile(self, grid, suspects: Optional[Sequence] = None):
        """Plan the grid after a re-tile over the `grid.nprocs` block slots
        of `grid.device`: an integer suspect is a block rank (the
        integrity layer's attribution), whose slot is fenced (a rank of an
        earlier topology is ignored); any other suspect (a device) cannot
        name a block, since every block lives on the one device, so it
        fences `retile_drop` slots from the tail, as does a plan with no
        usable suspect.  Re-plans `dims` over the survivors with
        :func:`igg_torch.fleet.plan_dims`; returns `(devices, dims,
        local)`, `devices` being `[grid.device] * n`, or raises `GridError`
        when no decomposition fits."""
        from .fleet import plan_dims

        nslots = int(grid.nprocs)
        fenced = set()
        tail = suspects is None
        for s in suspects or ():
            if isinstance(s, (int, np.integer)):
                if 0 <= int(s) < nslots:
                    fenced.add(int(s))
            else:
                tail = True
        if tail or not fenced:
            drop = max(1, int(self.policy.retile_drop))
            if nslots > 1:
                fenced.update(range(max(0, nslots - drop), nslots))
        healthy = nslots - len(fenced) or nslots
        interior = tuple(
            grid.dims[d] * (grid.nxyz[d] - grid.overlaps[d])
            + (0 if grid.periods[d] else grid.overlaps[d])
            for d in range(3))
        dims, local = plan_dims(interior, healthy, periods=grid.periods,
                                overlaps=grid.overlaps)
        return [grid.device] * int(np.prod(dims)), dims, local


def recalibrate(family: str, tier: Optional[str] = None, *,
                source: str = "heal") -> Optional[float]:
    """The drift loop's action (callable directly too): invalidate the
    family's ledger entries (:func:`igg_torch.perf.invalidate`),
    re-measure (:func:`igg_torch.perf.calibrate` for the built-in and
    registered families on the live grid, else the freshest sample the
    ledger held, recorded again), re-register the prediction
    (:func:`igg_torch.perf.predict`) and emit ``recalibrated``.  Returns
    the seconds per step re-registered (None where nothing was
    measured)."""
    from . import perf

    entries = perf.query(family, tier=tier)
    newest = max(entries, key=lambda e: e.get("updated_wall", 0.0),
                 default=None)
    # The stale prediction goes first: recording the fresh sample against
    # it would fire cost_model_drift again mid-action.
    perf.forget_prediction(family)
    invalidated = perf.invalidate(family, tier=tier)
    sec = None
    recal_tier = tier
    try:
        sec = perf.calibrate(family, source=source)
    except GridError:
        # Not a known family (or no live grid): the freshest measurement
        # is the truth.
        if newest is not None:
            sec = newest["last_ms"] / 1e3
            recal_tier = newest["tier"]
            perf.record(family, newest["tier"], newest["last_ms"],
                        source=source,
                        local_shape=newest.get("local_shape") or (),
                        dtype=newest.get("dtype", "-"),
                        dims=newest.get("dims"),
                        backend=newest.get("backend"),
                        device_kind=newest.get("device_kind"))
    if sec is not None:
        perf.predict(family, sec, source=source)
    _telemetry.emit("recalibrated", family=family, tier=recal_tier,
                    invalidated=invalidated, measured_s_per_step=sec,
                    source=source)
    return sec


def as_engine(heal, run: str = "resilient") -> Optional[HealEngine]:
    """The run loops' ``heal=``: None -> an engine only where
    ``IGG_HEAL=1`` (policy from the ``IGG_HEAL_*`` knobs); True -> an
    engine on that policy; a :class:`HealPolicy` -> a fresh engine; a
    :class:`HealEngine` -> itself; False -> off, also where the knob is
    set."""
    if heal is False:
        return None
    if heal is None:
        if not _env.flag("IGG_HEAL", False):
            return None
        return HealEngine(HealPolicy(), run=run)
    if heal is True:
        return HealEngine(HealPolicy(), run=run)
    if isinstance(heal, HealPolicy):
        return HealEngine(heal, run=run)
    if isinstance(heal, HealEngine):
        return heal
    raise GridError(
        f"heal={heal!r}: expected None, False, True, an igg_torch.heal."
        f"HealPolicy, or an igg_torch.heal.HealEngine.")
