"""Resilient run loop: a NaN watchdog on the device, a checkpoint ring with
rollback and retry, and preemption (the port of `igg/resilience.py`).

A long run on a large grid must survive a NaN blowup, a preempted job and
a damaged checkpoint without losing the run.  :func:`run_resilient` owns
that loop, with igg's signature, defaults, validation and event stream:

- **Watchdog.**  Every `watch_every` steps one probe runs over the
  watched fields: each field's non-finite count, in float32, stacked
  into an `(n_fields,)` tensor on the device.  Per field the count is
  taken over slabs of `_PROBE_SLAB_BYTES`, so its temporaries are one
  slab of at most 32 MB and a few scalars (a boolean mask of one 512^3
  field would be 134 MB).  The counts are copied without blocking into
  pinned host memory, followed by a recorded `torch.cuda.Event`; the
  loop polls the event (`query()`, through the `_CHAOS_FETCH_TAP` seam)
  and reads a probe only once the device has finished it, so the hot
  loop never waits for the device.  At most `max_pending_probes` probes
  wait: beyond that the oldest is read at once (a deterministic, bounded
  wait), so detection lags the injection by at most one watch window
  plus that depth.  On CPU tensors every probe is ready at once.

- **Checkpoint ring.**  Every `checkpoint_every` steps the state is
  written as a generation `{prefix}_<step>` (igg's sharded format by
  default, flat `.npz` files with `sharded=False`), keeping the newest
  `ring` generations plus the newest one known healthy.  Cadence
  generations go to a background writer (`async_checkpoint=True`):
  :class:`igg_torch.vis.BackgroundRenderer` copies the fields on the card
  at `submit` and its worker writes the copies, so a `step_fn` that
  writes its input tensors in place cannot change a generation in
  flight.  The writer is drained before every rollback scan, before the
  final preemption generation and at the end of the run; a failed
  background write costs one generation ('checkpoint_failed'), not the
  run.  PyTorch has no buffer donation, so igg's donation probe is gone
  (`_is_deleted` is always False).

- **Rollback and retry.**  On a non-finite probe (or a true
  `divergence_fn`) the loop rolls back to the newest generation at or
  below the failing probe that verifies with `check_finite=True`, calls
  `recovery_policy`, and replays; `max_retries` bounds the rollbacks.
  The same failure at the same step after a rollback is the signature
  of a deterministic kernel blowup.  On CPU tensors the loop then
  demotes the tier that served the failing dispatch
  (:func:`igg_torch.degrade.demote_active`, scoped to this run's
  dispatches) and replays on the next rung without spending a retry, as
  igg does.  On the card the next rung is the plain truth tier, which
  the port does not serve there: `demote_active` refuses it, and the
  recurrence raises :class:`ResilienceError` naming the tier.

- **Preemption.**  SIGTERM sets a flag read between dispatches; the loop
  probes the tail, writes a final generation and returns with
  `preempted=True`.  `resume=True` continues from the newest healthy
  generation, elastically onto another decomposition of the same grid.

- **Communication observability** (:mod:`igg_torch.comm`).  Whenever the
  loop watches, every probe is registered with a collective-stall
  heartbeat (`comm.StallWatchdog`, ``IGG_COMM_STALL_TIMEOUT``) and retired
  when read; a probe over age that still reports not ready becomes a
  ``collective_stall`` record, a ``stall_r<rank>.json`` report and a
  flight dump.  `comm=` takes a :class:`igg_torch.comm.StepDecomposition`,
  which dispatches one decomposition probe a watch window beside the
  watchdog's and polls it once a loop iteration.

- **Numeric integrity** (:mod:`igg_torch.integrity`).  `integrity=`
  fuses the families' invariant sums and, every `check_every` windows,
  a shadow re-execution's diffs into the watchdog's probe (one vector,
  one pinned copy a window); finite but wrong state is an
  ``integrity_violation``, rolled back to the newest deep-verified
  generation OLDER than the violating probe, then
  ``integrity_resolved``; generations carry the invariants' stamps.

The fault injectors of :mod:`igg_torch.chaos` drive every path.  Not
ported yet: `heal=` and `serve=` (each raises `GridError`) and the
multi-process branches (more than one process raises `GridError`).  With
the perf ledger on (`IGG_PERF`, default on), each watchdog window's
ms/step is recorded for the tier that served it
(`igg_torch.perf.observe_window`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import signal
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import shared
from . import telemetry as _telemetry
from .shared import GridError

__all__ = ["run_resilient", "RunResult", "Event", "ResilienceError",
           "PreemptionCell", "preemption_scope", "request_preemption",
           "preemption_requested", "preemption_requests",
           "clear_preemption"]


class ResilienceError(GridError):
    """Unrecoverable failure of the resilient loop: retry budget
    exhausted, no healthy generation to roll back to, or a recurring
    failure on the card.  `.events` holds the run's events up to the
    failure; `.dump_paths` the flight-recorder dumps written on the way
    out (named in the message) when a telemetry sink is configured."""

    def __init__(self, message: str, events: Sequence["Event"] = ()):
        super().__init__(message)
        self.events: List[Event] = list(events)
        self.dump_paths: List[pathlib.Path] = []

    def __str__(self) -> str:
        base = super().__str__()
        if self.dump_paths:
            paths = ", ".join(str(p) for p in self.dump_paths)
            return f"{base}  [flight recorder dumped to: {paths}]"
        return base


# Process-wide preemption flag (set by SIGTERM or igg_torch.chaos) and the
# monotone count of requests beside it.
_preempt = threading.Event()
_preempt_requests = 0


class PreemptionCell:
    """A preemption channel of one job's run loop: a flag and a monotone
    request count, installed in a thread by :func:`preemption_scope`."""

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._count = 0
        self._lock = threading.Lock()

    def request(self) -> None:
        with self._lock:
            self._count += 1
        self._ev.set()

    def clear(self) -> None:
        self._ev.clear()

    def requested(self) -> bool:
        return self._ev.is_set()

    def requests(self) -> int:
        with self._lock:
            return self._count


_preempt_tls = threading.local()


def _preempt_cell() -> Optional[PreemptionCell]:
    return getattr(_preempt_tls, "cell", None)


@contextlib.contextmanager
def preemption_scope(cell: PreemptionCell):
    """Route this thread's preemption calls through `cell`: requests made
    from this thread land on the cell, polls read the cell or the process
    flag, and :func:`clear_preemption` clears only the cell."""
    prev = _preempt_cell()
    _preempt_tls.cell = cell
    try:
        yield cell
    finally:
        _preempt_tls.cell = prev


def request_preemption(signum=None, frame=None) -> None:
    """Ask the running loop to write a generation and return at the next
    dispatch boundary (also the SIGTERM handler `run_resilient`
    installs)."""
    global _preempt_requests
    cell = _preempt_cell()
    if cell is not None:
        cell.request()
        return
    _preempt_requests += 1
    _preempt.set()


def preemption_requests() -> int:
    """Monotone count of :func:`request_preemption` calls visible to this
    thread: the process's plus, inside a scope, the cell's."""
    cell = _preempt_cell()
    return _preempt_requests + (cell.requests() if cell is not None else 0)


def preemption_requested() -> bool:
    cell = _preempt_cell()
    return _preempt.is_set() or (cell is not None and cell.requested())


def clear_preemption() -> None:
    cell = _preempt_cell()
    if cell is not None:
        cell.clear()
        return
    _preempt.clear()


@dataclasses.dataclass(frozen=True)
class Event:
    """One incident of the loop (also passed to `on_event`): `kind` is
    'resume', 'checkpoint' (detail `background: True` when the writer
    committed it), 'checkpoint_failed', 'nan_detected' (`step` is the
    probe's step, detail `counts`), 'divergence', 'integrity_violation'
    (finite but wrong state, from :mod:`igg_torch.integrity`: the
    drifted invariant or the shadow's field, the drift, the suspect block
    `rank` and `device`), 'integrity_resolved' (the violation's rollback
    landed on a verified generation), 'rollback', 'tier_degraded',
    'preempt' or an injector's 'chaos_*'."""
    kind: str
    step: int
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunResult:
    """What :func:`run_resilient` returns: the final `state`,
    `steps_done`, the `retries` spent, whether it was `preempted`, the
    `events`, and the `checkpoint` holding the returned state (None
    without a ring)."""
    state: Dict
    steps_done: int
    retries: int
    preempted: bool
    events: List[Event]
    checkpoint: Optional[pathlib.Path]


# Bytes of one slab of the probe's count: a slab's one temporary (1 + 0*x
# in float32 or float64) is at most 32 MB.
_PROBE_SLAB_BYTES = 1 << 25


def _watchable(a) -> bool:
    return isinstance(a, torch.Tensor) and (a.is_floating_point()
                                            or a.is_complex())


# `(dtype, device) -> (1, 0)` as scalar tensors: the probe's constants.
_UNIT: Dict = {}


def _nonfinite_count(a: torch.Tensor) -> torch.Tensor:
    """The number of non-finite elements of `a`, a floating scalar tensor
    on its device.  Per slab, `1 + 0*x` (one elementwise kernel) is 1
    where x is finite and NaN elsewhere, and its `nansum` (one reduction)
    counts the ones, exactly: a slab holds fewer than 2^24 elements.
    (PyTorch's `isfinite` on the card is four elementwise kernels, and a
    sum of booleans casts them to int64 first.)  Elements narrower than 4
    bytes are widened to float32 a slab at a time; complex fields take
    `isfinite`."""
    flat = a.reshape(-1)
    if flat.is_complex():
        return (~torch.isfinite(flat)).sum().to(torch.float64)
    wide = flat.element_size() < 4
    dtype = torch.float32 if wide else flat.dtype
    key = (dtype, a.device)
    if key not in _UNIT:
        _UNIT[key] = (torch.ones((), dtype=dtype, device=a.device),
                      torch.zeros((), dtype=dtype, device=a.device))
    one, zero = _UNIT[key]
    n = _PROBE_SLAB_BYTES // max(flat.element_size(), 4)
    fin = [torch.addcmul(one, part.float() if wide else part, zero).nansum()
           for part in flat.split(n)]
    if len(fin) == 1:                   # an empty field is one slab too
        return flat.numel() - fin[0]
    return flat.numel() - torch.stack(fin).sum(dtype=torch.float64)


def probe_counts(*arrays) -> torch.Tensor:
    """The watchdog probe: one float32 non-finite count per array (zero
    for an array that is neither floating nor complex), stacked into an
    `(n,)` tensor on the arrays' device; nothing is read back."""
    return torch.stack([
        _nonfinite_count(a) if _watchable(a)
        else torch.zeros((), dtype=torch.float64, device=a.device)
        for a in arrays]).to(torch.float32)


class _Probe:
    """One probe in flight: its vector (the counts, or the integrity
    monitor's fused vector, decoded by `tag`) copied without blocking into
    pinned host memory (on the card) and the event recorded after the
    copy."""

    __slots__ = ("host", "event", "tag")

    def __init__(self, counts: torch.Tensor, tag=None):
        self.tag = tag
        if counts.device.type == "cuda":
            self.host = torch.empty(counts.shape, dtype=counts.dtype,
                                    pin_memory=True)
            self.host.copy_(counts, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(counts.device))
        else:
            self.host, self.event = counts, None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self):
        """The counts as a numpy array (waits for the copy if it has not
        finished)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


# Fault-injection seam (igg_torch.chaos): a predicate applied to every
# readiness poll of a watchdog probe, so a probe that never becomes ready
# is injectable.  Host level, read at each poll.
_CHAOS_FETCH_TAP = None

# Fault-injection seam: a state transform `(state, step, emit, span) ->
# state` applied at every dispatch boundary of the loop (the stand-in for
# silent corruption of live state).  Host level, read at each boundary.
_CHAOS_STATE_TAP = None


def _buffer_ready(x) -> bool:
    """Whether `x`'s device work has finished; values with no such notion
    are ready."""
    try:
        return x.is_ready()
    except AttributeError:
        return True


def _is_ready(x) -> bool:
    """:func:`_buffer_ready` routed through the `_CHAOS_FETCH_TAP` seam
    (the watchdog's readiness channel)."""
    tap = _CHAOS_FETCH_TAP
    if tap is not None and not tap(x):
        return False
    return _buffer_ready(x)


def _is_deleted(x) -> bool:
    """igg's donation check.  A PyTorch tensor is never donated: False."""
    return False


class _AsyncCheckpointWriter:
    """Background checkpoint writer on :class:`igg_torch.vis.
    BackgroundRenderer`: `submit(step, fields, last_good)` hands the
    fields to the renderer, which copies them on the card before it
    returns; its worker runs `save_fn(step, copies, last_good)` after the
    copies.  The bounded queue (`maxsize`) bounds the copies held on the
    card: a submit beyond it waits.

    Completions and failures come back on the caller's thread through
    :meth:`poll` (never blocks) and :meth:`drain` (blocks until every
    submitted generation is written or failed), each `([(step, path,
    background)], [(step, error)])`; a failure carries the step of the
    generation it lost."""

    def __init__(self, save_fn, *, maxsize: int = 2):
        from .vis import BackgroundRenderer

        self._save_fn = save_fn
        self._done: deque = deque()      # (step, path, background)
        self._failed: deque = deque()    # (step, exception)
        self._r = BackgroundRenderer(self._consume, maxsize=maxsize,
                                     name="igg-ckpt-writer")

    def _consume(self, batch) -> None:
        step, fields, last_good = batch
        try:
            path = self._save_fn(step, fields, last_good)
        except Exception as e:    # one generation lost, not the run
            self._failed.append((step, e))
            return
        self._done.append((step, path, True))

    def note_donation(self) -> None:
        """igg's donation notice; nothing to do without donation."""

    def submit(self, step: int, fields: Dict, last_good: int) -> None:
        self._r.submit((step, dict(fields), last_good))

    def _results(self):
        done, errs = [], []
        while self._done:
            done.append(self._done.popleft())
        while self._failed:
            errs.append(self._failed.popleft())
        return done, errs

    def poll(self):
        """Completions and failures so far; never blocks."""
        return self._results()

    def drain(self):
        """Block until every submitted generation is written (or failed),
        then return the completions and failures."""
        self._r.drain()
        return self._results()

    def close(self) -> None:
        self._r.close()


# The layers igg's loop calls that the port does not have yet, and the
# ROADMAP Queue A item that brings each.
_UNPORTED = {
    "serve": ("igg.statusd", "item 10, the ops plane"),
    "heal": ("igg.heal", "item 9, heal"),
}


def run_resilient(step_fn: Callable[[Dict], Dict], state: Dict, n_steps: int,
                  *,
                  watch_every: int = 50,
                  watch_fields: Optional[Sequence[str]] = None,
                  divergence_fn: Optional[Callable[[Dict], bool]] = None,
                  checkpoint_dir=None,
                  checkpoint_every: int = 0,
                  ring: int = 3,
                  prefix: str = "ckpt",
                  max_retries: int = 3,
                  recovery_policy: Optional[Callable] = None,
                  resume: bool = False,
                  steps_per_call: int = 1,
                  max_pending_probes: int = 4,
                  sharded: bool = True,
                  async_checkpoint: bool = True,
                  install_sigterm: bool = True,
                  on_event: Optional[Callable[[Event], None]] = None,
                  telemetry=None,
                  serve=None,
                  comm=None,
                  heal=None,
                  integrity=None,
                  chaos=None) -> RunResult:
    """Drive `state = step_fn(state)` for `n_steps` steps with the
    watchdog, the checkpoint ring, rollback and retry, and preemption
    (module docstring).

    - `state`: dict of named block-stacked grid tensors (the
      :func:`igg_torch.save_checkpoint` field model); `step_fn` maps it
      to the next state dict (same keys) and may return new tensors or
      write its inputs in place.  A `step_fn` advancing several steps per
      call says so with `steps_per_call`: every cadence counts steps and
      must be a multiple of it.
    - `watch_every`: probe cadence in steps (0: no watchdog);
      `watch_fields` the fields probed (default: every floating or
      complex one); `divergence_fn(state) -> bool` a host-side predicate
      at the same cadence.
    - `checkpoint_every` > 0 enables the ring under `checkpoint_dir`
      (a generation is also written at entry and at preemption); `ring`
      generations are kept; `sharded`, `async_checkpoint` as in the module
      docstring.  A fresh run (`resume=False`) removes the ring's
      generations left in the directory by an earlier run.
    - On detection: rollback to the newest generation at or below the
      failing probe that passes `verify_checkpoint(check_finite=True)`,
      then `recovery_policy(attempt, state, event)`, which may return a
      new state dict, a `(state, step_fn)` pair, or None.  `max_retries`
      bounds the rollbacks; exhaustion raises :class:`ResilienceError`,
      as does a detection with no healthy generation or no ring.
    - `resume=True` continues from the newest healthy generation of
      `checkpoint_dir`.
    - `telemetry`: None (a session only where `IGG_TELEMETRY_DIR` is
      set), a directory, a :class:`igg_torch.telemetry.Telemetry`, or
      False.  Events also go to the telemetry bus; with a session the
      loop emits `step_stats` per window and dumps the flight recorder on
      `ResilienceError`, on preemption and on any other escape.
    - `comm`: an :class:`igg_torch.comm.StepDecomposition` (per-window
      ``comm_stats`` records; needs `watch_every` > 0).  Independently of
      it, every probe is watched by the collective-stall heartbeat
      (module docstring; ``IGG_COMM_STALL_TIMEOUT=0`` turns it off).  On
      the card a failure of the monitor's end-of-run drain raises once
      the run's own outcome is settled (the run's own error wins, and
      carries it as a note); on CPU tensors it is dropped, as igg drops
      it.
    - `integrity`: :mod:`igg_torch.integrity` (None: on only where
      ``IGG_INTEGRITY=1``; True: the environment's config; an
      :class:`igg_torch.integrity.IntegrityConfig`; False: off).  Needs
      `watch_every` > 0.  Invariant sums and shadow diffs ride the
      watchdog's probe; a violation rolls back to the newest generation
      older than the probe that deep-verifies (the plain scan where none
      does); a violation that recurs at the same step after a rollback
      demotes as a recurring NaN does; resume scans prefer deep-verified
      generations.
    - `serve`, `heal`: not ported yet; anything but None raises
      `GridError`.
    - `chaos`: an :class:`igg_torch.chaos.ChaosPlan` (testing only).

    Runs in one process (more raise `GridError`)."""
    from . import checkpoint as ckpt
    from . import degrade as _degrade

    shared.check_initialized()
    for name, value in (("serve", serve), ("heal", heal)):
        if value is not None:
            mod, item = _UNPORTED[name]
            raise GridError(
                f"run_resilient: {name}={value!r}: the port has no "
                f"{mod} yet (ROADMAP Queue A {item}); pass None.")
    if ckpt._process_count() > 1:
        raise GridError(
            "run_resilient: the port's resilient loop runs in one process "
            "(every block of its grid lives there); the multi-process "
            "loop waits for its torch.distributed backend.")
    if not isinstance(state, dict) or not state:
        raise GridError("run_resilient: state must be a non-empty dict of "
                        "named grid fields (the save_checkpoint model).")
    if steps_per_call < 1:
        raise GridError("run_resilient: steps_per_call must be >= 1.")
    for name, value in (("n_steps", n_steps), ("watch_every", watch_every),
                        ("checkpoint_every", checkpoint_every)):
        if value and value % steps_per_call != 0:
            raise GridError(
                f"run_resilient: {name}={value} is not a multiple of "
                f"steps_per_call={steps_per_call}; cadences count steps and "
                f"must align with dispatch boundaries.")
    if checkpoint_every and checkpoint_dir is None:
        raise GridError("run_resilient: checkpoint_every > 0 requires "
                        "checkpoint_dir.")
    if divergence_fn is not None and not watch_every:
        raise GridError("run_resilient: divergence_fn is evaluated at the "
                        "watch cadence; set watch_every > 0.")
    if resume and checkpoint_dir is None:
        raise GridError("run_resilient: resume=True requires "
                        "checkpoint_dir (silently restarting from step 0 "
                        "would recompute the whole run).")
    if ring < 1:
        raise GridError("run_resilient: ring must be >= 1.")

    state = dict(state)
    cdir = pathlib.Path(checkpoint_dir) if checkpoint_dir is not None else None
    watch = list(watch_fields) if watch_fields is not None else [
        n for n, a in state.items() if _watchable(a)]
    missing = [n for n in watch if n not in state]
    if missing:
        raise GridError(f"run_resilient: watch_fields {missing} not in "
                        f"state {sorted(state)}.")
    # Numeric integrity: the knob is checked here, the monitor is built
    # after a resume has settled the state it checks.
    from . import integrity as _integrity

    int_cfg = _integrity.as_config(integrity)
    if int_cfg is not None and not (watch and watch_every):
        raise GridError(
            "run_resilient: the integrity= probes ride the watch cadence; "
            "set watch_every > 0 (with watched fields).")
    deep_pref = int_cfg is not None and int_cfg.resolved_deep()
    mon: Optional[_integrity.Monitor] = None
    if comm is not None:
        if not (hasattr(comm, "maybe_dispatch") and hasattr(comm, "poll")):
            raise GridError(
                f"run_resilient: comm={comm!r}: expected an "
                f"igg_torch.comm.StepDecomposition monitor (or None).")
        if not (watch and watch_every):
            raise GridError(
                "run_resilient: the comm= decomposition probes ride the "
                "watch cadence; set watch_every > 0 (with watched "
                "fields).")

    events: List[Event] = []

    def _emit(kind, step, _bus=True, **detail) -> Event:
        ev = Event(kind, step, detail)
        events.append(ev)
        # `_bus=False` keeps an event in the per-run view only, where
        # another layer just emitted the bus record.
        if _bus:
            _telemetry.emit(kind, step=step, run="resilient", **detail)
        if on_event is not None:
            on_event(ev)
        return ev

    tel = _telemetry.as_session(telemetry)
    tel_owns = tel is not None and not tel.attached
    if tel_owns:
        tel.attach()
    _telemetry.emit("run_started", run="resilient", n_steps=n_steps,
                    watch_every=watch_every, steps_per_call=steps_per_call)
    # The perf ledger (igg_torch.perf): window rates are credited to the
    # serving tier, on the watchdog's own fetch timestamps.
    from . import perf as _perf

    stats = _telemetry.StepStats(
        "resilient",
        perf=(_perf.sample_context(state[watch[0]])
              if watch and _perf.enabled() else None))
    m_steps = _telemetry.counter("igg_steps_total", run="resilient")
    m_rollbacks = _telemetry.counter("igg_rollbacks_total", run="resilient")

    steps_done = 0
    resumed_step = None
    try:
        if resume and cdir is not None:
            found = None
            if deep_pref:
                # Prefer the newest deep-verified generation; unstamped or
                # poisoned ones fall through to the plain scan.
                found = ckpt.latest_checkpoint(cdir, prefix,
                                               check_finite=True, deep=True)
            if found is None:
                found = ckpt.latest_checkpoint(cdir, prefix,
                                               check_finite=True)
            if found is not None:
                # Elastic: a generation of another decomposition of the
                # same grid is re-tiled onto the live one.
                state = ckpt.load_checkpoint(found, redistribute=True)
                steps_done = resumed_step = ckpt.checkpoint_step(found) or 0
                if steps_done % steps_per_call != 0:
                    raise GridError(
                        f"run_resilient(resume=True): generation "
                        f"{found.name} is at step {steps_done}, not a "
                        f"multiple of steps_per_call={steps_per_call} — the "
                        f"resumed walk would miss every watch/checkpoint "
                        f"boundary and overshoot n_steps.  Resume with the "
                        f"steps_per_call the checkpoint was written under.")
                _emit("resume", steps_done, path=str(found))
        if int_cfg is not None:
            mon = _integrity.Monitor(int_cfg, state, watch, watch_every,
                                     steps_per_call)
    except BaseException as e:
        paths = _telemetry._auto_dump(f"run_resilient: "
                                      f"{type(e).__name__}: {e}")
        if isinstance(e, ResilienceError):
            e.dump_paths.extend(p for p in paths if p not in e.dump_paths)
        if mon is not None:
            mon.close()
        if tel_owns:
            tel.detach()
        raise
    probing = bool(watch and watch_every)
    pending: deque = deque()   # (probe step, _Probe)
    # The collective-stall heartbeat watches every probe in flight; the
    # comm monitor rides the watch cadence (igg_torch.comm).
    from . import comm as _comm

    stall = _comm.make_stall_watchdog("resilient") if probing else None
    run_error: Optional[BaseException] = None
    retries = 0
    last_fail = None           # (kind, step) of the previous rollback cause
    # Demotion scope: only families that dispatch after this stamp belong
    # to this run.
    run_stamp = _degrade.dispatch_stamp()
    preempted = False
    last_ckpt: Optional[pathlib.Path] = None
    last_ckpt_step = -1
    use_async = bool(async_checkpoint and sharded and checkpoint_every)
    writer: Optional[_AsyncCheckpointWriter] = None   # created on first use
    # Steps whose generation holds THIS run's state (invalidated on
    # rollback, where the replay may differ from the first attempt).
    synced = set()
    if resumed_step is not None:
        synced.add(resumed_step)
    # Newest step whose health is established (a fetched clean probe, a
    # finite-verified load, or the caller's state): the generation at or
    # below it is exempt from pruning.
    last_good = steps_done

    def _generations():
        return ckpt.list_generations(cdir, prefix) if cdir is not None else []

    def _gen_path(step) -> pathlib.Path:
        return cdir / (f"{prefix}_{step:09d}" if sharded
                       else f"{prefix}_{step:09d}.npz")

    def _write_gen(step, fields, good_until) -> pathlib.Path:
        """Write one generation and prune the ring (on the caller's thread
        for sync generations, on the writer's for async ones)."""
        p = _gen_path(step)
        with _telemetry.span("checkpoint.generation", step=step,
                             path=str(p)):
            if sharded:
                ckpt.save_checkpoint_sharded(p, **fields)
            else:
                ckpt.save_checkpoint(p, **fields)
        ckpt.prune_generations(cdir, prefix, ring, good_until)
        return p

    def _record_gen(step, p, background=False) -> None:
        nonlocal last_ckpt, last_ckpt_step
        synced.add(step)
        if step >= last_ckpt_step:
            last_ckpt, last_ckpt_step = p, step
        detail = {"path": str(p)}
        if background:
            detail["background"] = True
        _emit("checkpoint", step, **detail)

    def _merge_writer(drain: bool = False) -> None:
        """Collect the writer's completions and failures on this thread;
        `drain=True` first waits for every queued generation."""
        if writer is None:
            return
        if drain:
            with _telemetry.span("checkpoint.drain", step=steps_done):
                done, errs = writer.drain()
        else:
            done, errs = writer.poll()
        for step_w, p, background in done:
            _record_gen(step_w, p, background=background)
        for step_w, e in errs:
            _emit("checkpoint_failed", step_w,
                  error=f"{type(e).__name__}: {e}")

    def _save_gen(step, sync: bool = True) -> None:
        nonlocal writer
        if not sync and use_async:
            if writer is None:
                writer = _AsyncCheckpointWriter(_write_gen)
            writer.submit(step, state, last_good)
            return
        _record_gen(step, _write_gen(step, state, last_good))

    def _poll_probes(drain: bool = False) -> Optional[Event]:
        """Read finished probes oldest first (forced beyond
        `max_pending_probes`, or on `drain`); returns the failure event of
        the first non-finite probe, else None."""
        nonlocal last_good
        while pending:
            step_p, pr = pending[0]
            if (not drain and len(pending) <= max_pending_probes
                    and not _is_ready(pr)):
                return None
            pending.popleft()
            host = pr.result()
            if stall is not None:
                stall.fetched(("probe", step_p), step_p)
            viol = None
            if mon is not None:
                host, viol = mon.decode(host, pr.tag, step_p)
            bad = {n: int(c) for n, c in zip(watch, host) if c != 0}
            if bad:
                pending.clear()   # younger probes are post-failure noise
                if stall is not None:
                    stall.clear()
                return _emit("nan_detected", step_p, counts=bad)
            if viol is not None:
                # Finite but wrong state: an invariant drifted or a shadow
                # re-execution disagreed.
                pending.clear()
                if stall is not None:
                    stall.clear()
                return _emit("integrity_violation", step_p, **viol)
            last_good = max(last_good, step_p)
            stats.fetched(step_p, steps_done)
        return None

    def _dispatch_probe() -> None:
        """One watchdog probe, registered with the stall heartbeat (the
        entry a hung exchange is reported against).  With integrity on,
        the monitor's fused probe serves: counts, invariant partials and
        (on the check cadence) shadow diffs in one vector."""
        if mon is not None:
            vec, tag = mon.dispatch(state, steps_done, step_fn)
            pr = _Probe(vec, tag)
        else:
            pr = _Probe(probe_counts(*[state[n] for n in watch]))
        pending.append((steps_done, pr))
        if stall is not None:
            stall.watch(("probe", steps_done), steps_done,
                        "watchdog probe (non-finite counts of the watched "
                        "fields)", pr)

    def _rollback(ev: Event) -> None:
        nonlocal state, steps_done, retries, step_fn, final_probe_done, \
            last_good, last_ckpt, last_ckpt_step, last_fail
        final_probe_done = False   # the replay's tail window re-probes
        # The same failure at the same step after a bit-exact rollback: a
        # deterministic kernel blowup.  Demote the tier that served it (no
        # retry spent: the demotion is the recovery), where the next rung
        # can serve.
        demoted: List[str] = []
        if last_fail == (ev.kind, ev.step):
            try:
                demoted = _degrade.demote_active(
                    reason="nan_recurrence",
                    error_text=f"{ev.kind} recurred at step {ev.step} "
                               f"after a bit-exact rollback",
                    since=run_stamp)
            except GridError as e:   # the card: no rung left to serve
                raise ResilienceError(
                    f"run_resilient: {ev.kind} recurred at step {ev.step} "
                    f"after a bit-exact rollback: the tier that served the "
                    f"failing dispatch blows up deterministically.  {e}",
                    events) from e
            for tname in demoted:
                # quarantine() emitted the bus record; this is the
                # per-run view's step-anchored copy.
                _emit("tier_degraded", ev.step, _bus=False, tier=tname,
                      reason="nan_recurrence")
            if demoted and mon is not None:
                # References anchored on the demoted tier's trajectory
                # would flag the healthy replay: re-anchor.
                mon.reset_reference()
        last_fail = (ev.kind, ev.step)
        if not demoted:
            retries += 1
        if retries > max_retries:
            raise ResilienceError(
                f"run_resilient: {ev.kind} at step {ev.step} "
                f"({ev.detail or ''}) and the retry budget "
                f"(max_retries={max_retries}) is exhausted.", events)
        if cdir is None:
            raise ResilienceError(
                f"run_resilient: {ev.kind} at step {ev.step} but no "
                f"checkpoint_dir is configured — nothing to roll back to.  "
                f"Enable the ring (checkpoint_every/checkpoint_dir) for "
                f"rollback-and-retry.", events)
        # Every background write settles before the scan: a half-written
        # generation is no candidate, and the newest healthy one may still
        # be queued.
        _merge_writer(drain=True)
        # A violation's generation at the probe step may already hold the
        # finite but wrong state (a shadow catch leaves its deep stamp
        # consistent): only older generations are candidates.  A NaN's
        # generation at its step fails check_finite.
        max_step = (ev.step - 1 if ev.kind == "integrity_violation"
                    else ev.step)
        found = None
        if mon is not None and mon.deep_verify:
            # A finite but poisoned generation passes check_finite and
            # fails its deep stamp: prefer the newest that deep-verifies,
            # the plain scan only where none does.
            found = ckpt.latest_checkpoint(cdir, prefix, check_finite=True,
                                           max_step=max_step, deep=True)
        if found is None:
            found = ckpt.latest_checkpoint(cdir, prefix, check_finite=True,
                                           max_step=max_step)
        if found is None:
            raise ResilienceError(
                f"run_resilient: {ev.kind} at step {ev.step} and no healthy "
                f"checkpoint generation exists under {cdir} to roll back "
                f"to.", events)
        pending.clear()
        if stall is not None:
            stall.clear()
        m_rollbacks.inc()
        with _telemetry.span("resilience.rollback", step=ev.step,
                             target_step=ckpt.checkpoint_step(found)):
            state = ckpt.load_checkpoint(found)
        steps_done = ckpt.checkpoint_step(found)
        synced.clear()
        synced.add(steps_done)
        last_good = steps_done
        last_ckpt, last_ckpt_step = found, steps_done
        # Generations newer than the target belong to the abandoned
        # attempt: a later resume must never land on them.
        for s, p in _generations():
            if s > steps_done:
                ckpt.remove_generation(p)
        _emit("rollback", steps_done, from_step=ev.step,
              attempt=retries, path=str(found))
        if mon is not None:
            mon.on_rollback(state, steps_done)
            if ev.kind == "integrity_violation":
                _emit("integrity_resolved", steps_done, from_step=ev.step,
                      path=str(found), deep_verified=bool(mon.deep_verify))
        if recovery_policy is not None:
            out = recovery_policy(retries, state, ev)
            if isinstance(out, tuple):
                state, step_fn = out
            elif out is not None:
                state = out

    # The loop's thread and scope stay the same for the whole run: look the
    # scope's cell up once (preemption_requested() per dispatch, cheaper).
    cell = _preempt_cell()

    def _preempt_asked() -> bool:
        return _preempt.is_set() or (cell is not None and cell.requested())

    installed = False
    old_handler = None
    if install_sigterm:
        try:
            old_handler = signal.signal(signal.SIGTERM, request_preemption)
            installed = True
        except ValueError:
            pass   # not on the main thread: the caller wires signals

    try:
        # A fresh run owns its ring: an earlier run's generations are not
        # this trajectory, so no rollback or resume may land on them.
        if cdir is not None and not resume:
            for _, old in _generations():
                ckpt.remove_generation(old)
        # Entry generation, so a rollback target exists from the start.
        if checkpoint_every and steps_done != resumed_step:
            _save_gen(steps_done)
        if mon is not None:
            # The first window is shadow-checked from the entry state.
            mon.arm_entry(state, steps_done)

        final_probe_done = False
        while True:
            while steps_done < n_steps:
                if _preempt_asked():
                    preempted = True
                    break
                if chaos is not None:
                    state = chaos.apply(state, steps_done, _emit,
                                        span=steps_per_call)
                    if _preempt_asked():
                        preempted = True
                        break
                state_tap = _CHAOS_STATE_TAP
                if state_tap is not None:
                    state = state_tap(state, steps_done, _emit,
                                      steps_per_call)
                state = step_fn(state)
                steps_done += steps_per_call
                m_steps.inc(steps_per_call)
                fail = None
                if probing and steps_done % watch_every == 0:
                    _dispatch_probe()
                    if comm is not None:
                        comm.maybe_dispatch(steps_done, stall)
                if (divergence_fn is not None and watch_every
                        and steps_done % watch_every == 0
                        and divergence_fn(state)):
                    fail = _emit("divergence", steps_done)
                if fail is None and pending:
                    fail = _poll_probes()
                if fail is not None:
                    _rollback(fail)
                    continue
                if checkpoint_every and steps_done % checkpoint_every == 0:
                    # Cadence generations go to the writer; entry,
                    # rollback and preemption generations stay sync.
                    _save_gen(steps_done, sync=False)
                if writer is not None:
                    _merge_writer()   # a deque pop, never blocks
                if comm is not None:
                    comm.poll(steps_done, stall)   # readiness only
                if tel is not None:
                    tel.maybe_export_metrics()
            if preempted:
                break
            # End of the run: probe an off-cadence tail window and read
            # every pending probe; a failure here still rolls back.
            if (probing and not final_probe_done
                    and steps_done % watch_every != 0):
                final_probe_done = True
                _dispatch_probe()
            fail = _poll_probes(drain=True)
            if fail is None:
                _merge_writer(drain=True)
                break
            _rollback(fail)

        if preempted:
            # A blowup inside the last window must not become the final
            # generation: probe the tail, read, and roll back first.
            if probing and steps_done % watch_every != 0:
                _dispatch_probe()
            fail = _poll_probes(drain=True)
            if fail is not None:
                _rollback(fail)
            _merge_writer(drain=True)
            # Final generation, unless one at this step holds this state.
            if cdir is not None and steps_done not in synced:
                _save_gen(steps_done)
            _emit("preempt", steps_done,
                  path=str(last_ckpt) if last_ckpt else None)
            _telemetry._auto_dump(f"preempt at step {steps_done}")
    except BaseException as e:
        run_error = e
        paths = _telemetry._auto_dump(f"run_resilient: "
                                      f"{type(e).__name__}: {e}")
        if isinstance(e, ResilienceError):
            e.dump_paths.extend(p for p in paths if p not in e.dump_paths)
        raise
    finally:
        if mon is not None:
            mon.close()   # clears the checkpoint stamp context
        comm_error = None
        if comm is not None:
            try:
                comm.finalize(steps_done)
            except Exception as e:
                # igg drops it (a broken probe must not mask the run's
                # outcome); on the card it is raised after the run's own
                # outcome is settled, or noted on the run's own error.
                if getattr(comm, "on_card", False):
                    comm_error = GridError(
                        f"run_resilient: the comm monitor's end-of-run "
                        f"drain failed on the card ({type(e).__name__}: "
                        f"{e})")
                    comm_error.__cause__ = e
        if stall is not None:
            stall.close()
        if writer is not None:
            try:
                _merge_writer(drain=True)
            finally:
                writer.close()
        if installed:
            signal.signal(signal.SIGTERM, old_handler)
        clear_preemption()
        _telemetry.emit("run_finished", step=steps_done, run="resilient",
                        preempted=preempted, retries=retries)
        if tel is not None:
            if tel_owns:
                tel.detach()
            else:
                tel.export_metrics()
        if comm_error is not None:
            if run_error is None:
                raise comm_error
            run_error.add_note(str(comm_error))

    return RunResult(state=state, steps_done=steps_done, retries=retries,
                     preempted=preempted, events=events, checkpoint=last_ckpt)
