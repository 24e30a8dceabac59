"""Verified tiered dispatch: the tier ladder (the port of `igg/degrade.py`).

Every model family serves a call through a ladder of tiers: its kernel
routes first (`<family>.trapezoid`/`.chunk`/`.banded`/`.cuda`), its plain
PyTorch version last (`<family>.plain`, the truth tier).  Each tier's
admission says whether it serves the call; the first tier that admits it
serves.

- **Verify on first use.**  With ``verify="first_use"`` (or ``True``) on
  a model factory, or ``IGG_VERIFY_KERNELS=1`` where `verify` is None, a
  kernel tier first runs once on scratch copies (`clone()`s on the same
  device) of the real arguments beside the truth tier on copies of its
  own, and the outputs are held to a per-dtype tolerance.  One
  verification per (tier, argument signature), inside the trace span
  `degrade.verify_first_use`.

- **Verification raises; only demotion quarantines.**  Where igg
  quarantines a tier that fails verification or its first build and
  serves the next one, the port raises: a verify mismatch raises
  `GridError` naming the tier, the output and the figures
  (`max|tier-truth|` against `tol`), emits `tier_degraded` and serves
  nothing; a kernel that fails to build or launch raises as it is (so
  does an armed `InjectedCompileError`).  The one path to quarantine is
  :func:`demote_active`, the resilient loop's answer to a failure that
  recurs at the same step after a rollback (igg's): :func:`quarantine`
  pulls the tier out of dispatch, :func:`is_quarantined` and
  :func:`status` report it, :func:`reset` re-admits it.  The resilient
  loop demotes only on CPU tensors: on the card the next rung is the
  truth tier, which the port does not serve there.  Both guards live
  here: :func:`demote_active` refuses (`GridError`, nothing quarantined)
  a tier whose last dispatch served CUDA tensors, and a dispatch of CUDA
  tensors that a quarantined tier would have served raises `GridError`
  naming it instead of falling to the truth tier.

- **Chaos seam.**  `_CHAOS_TIER_TAP` (`igg_torch.chaos.kernel_compile_fail`
  and `kernel_corrupt`): ``{"compile_fail": {tier: message}, "corrupt":
  {tier: magnitude}}``, read at a tier's build and after each of its
  dispatches.  With nothing armed or quarantined each check is one read
  of a module global per dispatch.

- **Observable.**  :func:`active` names the tier that served each family's
  last dispatch, :func:`events` the `tier_degraded` log,
  :func:`admission_log` the last refusal reason of each tier; the counter
  `igg_tier_dispatch_total{family,tier}` counts dispatches.
  :func:`reset` clears this state (`finalize_global_grid` does);
  :func:`dispatch_stamp` is the monotone dispatch counter that scopes a
  run's demotion to the families it dispatched (and the perf ledger's
  window attribution, `igg_torch.perf.observe_window`);
  :func:`diagnostic_dispatches` keeps a diagnostic replay (the integrity
  layer's shadow re-execution) out of the active-tier records.

- **Perf samples.**  A tier that passes verification gets one more warm
  dispatch on clones, timed (CUDA events on the card) into the perf
  ledger (`igg_torch.perf`, source ``verify_first_use``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import _env
from . import telemetry as _telemetry
from .shared import GridError

__all__ = ["Admission", "Tier", "Ladder", "Quarantine", "status", "events",
           "active", "active_records", "admission_log", "is_quarantined",
           "reset", "quarantine", "dispatch_stamp", "diagnostic_dispatches",
           "demotable", "demote_active", "InjectedCompileError"]


class Admission:
    """Structured admission verdict: truthy/falsy like a bool, plus the
    reason a tier was refused."""

    __slots__ = ("ok", "reason")

    def __init__(self, ok: bool, reason: str = ""):
        self.ok = bool(ok)
        self.reason = reason

    def __bool__(self) -> bool:
        return self.ok

    def __repr__(self) -> str:
        return (f"Admission(ok={self.ok}"
                + (f", reason={self.reason!r}" if self.reason else "") + ")")

    @classmethod
    def yes(cls) -> "Admission":
        return cls(True)

    @classmethod
    def no(cls, reason: str) -> "Admission":
        return cls(False, reason)


@dataclasses.dataclass(frozen=True)
class Quarantine:
    """One quarantined tier: its rung, why it was pulled (the port's one
    reason is 'nan_recurrence', from :func:`demote_active`) and the
    captured error text."""
    tier: str
    rung: int
    reason: str
    error: Optional[str] = None


# Process-wide ladder state, keyed by tier name so every ladder of a family
# (factories are cheap and recreated freely) shares one verification
# memory and one quarantine verdict.
_lock = threading.Lock()
_QUARANTINE: Dict[str, Quarantine] = {}
# family -> (tier, rung, truth, on the card, dispatch counter) of the
# family's last dispatch: what active() reports and demote_active() pulls.
_ACTIVE: Dict[str, Tuple[str, int, bool, bool, int]] = {}
_DISPATCHES = 0                         # monotone dispatch counter
_VERIFIED: set = set()                  # (tier name, argument signature)
_ADMISSION_LOG: Dict[str, str] = {}     # tier -> last refusal reason
_EVENTS: List[dict] = []                # tier_degraded event log
_warned: set = set()                    # tiers already warned about

# Fault-injection seam (igg_torch.chaos.kernel_compile_fail /
# kernel_corrupt): {"compile_fail": {tier: message}, "corrupt": {tier:
# magnitude}}, consulted at a tier's build and after each of its
# dispatches; None when nothing is armed.
_CHAOS_TIER_TAP: Optional[dict] = None


class InjectedCompileError(RuntimeError):
    """The chaos stand-in for a kernel that fails to build."""


def _chaos_compile_check(tier: str) -> None:
    tap = _CHAOS_TIER_TAP
    if tap and tier in tap.get("compile_fail", {}):
        raise InjectedCompileError(
            tap["compile_fail"][tier]
            or f"kernel build failed (chaos-injected) for tier {tier}")


def _chaos_corrupt(tier: str, out):
    """An armed output corruption of `tier`, the stand-in for a miscompiled
    kernel: one interior element (index 1 along every dim) of the first
    floating output tensor is perturbed by `magnitude`, in a copy (an
    output may alias an input)."""
    tap = _CHAOS_TIER_TAP
    if not tap or tier not in tap.get("corrupt", {}):
        return out
    magnitude = tap["corrupt"][tier]
    done = []

    def hit(o):
        if isinstance(o, (tuple, list)):
            return type(o)(hit(x) for x in o)
        if done or not hasattr(o, "is_floating_point") or not (
                o.is_floating_point() or o.is_complex()):
            return o
        done.append(True)
        bad = o.clone()
        bad[tuple(min(1, s - 1) for s in bad.shape)] += magnitude
        return bad

    return hit(out)


def quarantine(tier: str, rung: int, reason: str,
               error_text: Optional[str] = None) -> Quarantine:
    """Pull `tier` out of dispatch for the process: record the verdict,
    append a `tier_degraded` event, and warn once naming the tier and the
    captured error text."""
    q = Quarantine(tier=tier, rung=rung, reason=reason, error=error_text)
    with _lock:
        _QUARANTINE[tier] = q
        _EVENTS.append({"kind": "tier_degraded", "tier": tier, "rung": rung,
                        "reason": reason, "error": error_text})
        warn = tier not in _warned
        _warned.add(tier)
    _telemetry.emit("tier_degraded", tier=tier, rung=rung, reason=reason,
                    error=error_text)
    _telemetry.counter("igg_tier_quarantined_total", tier=tier).inc()
    if warn:
        warnings.warn(
            f"igg_torch.degrade: tier {tier!r} (rung {rung}) quarantined "
            f"({reason}); dispatch falls to the next rung.  Captured: "
            f"{error_text or '<none>'}.  igg_torch.degrade.status() queries, "
            f"igg_torch.degrade.reset({tier!r}) re-admits.", stacklevel=2)
    return q


def is_quarantined(tier: str) -> bool:
    return tier in _QUARANTINE


def status() -> Dict[str, Quarantine]:
    """The quarantined tiers: `{tier: Quarantine(tier, rung, reason,
    error)}` (empty when every tier is healthy)."""
    with _lock:
        return dict(_QUARANTINE)


def events() -> List[dict]:
    """The `tier_degraded` event log, oldest first (each entry: kind,
    tier, rung, reason, error)."""
    with _lock:
        return list(_EVENTS)


def active() -> Dict[str, str]:
    """Which tier served each family's most recent dispatch."""
    with _lock:
        return {f: r[0] for f, r in _ACTIVE.items()}


def active_records() -> List[Tuple[str, str, int]]:
    """`[(family, serving tier, dispatch stamp)]`: :func:`active` with the
    monotone dispatch counter at each family's last dispatch."""
    with _lock:
        return [(f, r[0], r[4]) for f, r in _ACTIVE.items()]


def admission_log() -> Dict[str, str]:
    """The last refusal reason per tier."""
    with _lock:
        return dict(_ADMISSION_LOG)


def reset(tier: Optional[str] = None) -> None:
    """Re-admit `tier`: forget its quarantine, verifications and refusal
    (or, with no argument, clear all ladder state: quarantine,
    verification memory, active-tier records, refusals, the event log,
    and the one-time warnings)."""
    with _lock:
        if tier is not None:
            _QUARANTINE.pop(tier, None)
            _warned.discard(tier)
            for key in [k for k in _VERIFIED if k[0] == tier]:
                _VERIFIED.discard(key)
            _ADMISSION_LOG.pop(tier, None)
            return
        _QUARANTINE.clear()
        _ACTIVE.clear()
        _VERIFIED.clear()
        _ADMISSION_LOG.clear()
        _EVENTS.clear()
        _warned.clear()


def dispatch_stamp() -> int:
    """The monotone ladder-dispatch counter: snapshot it before a run and
    pass it to :func:`demote_active` as `since` to scope demotion to the
    families that dispatched during that run."""
    return _DISPATCHES


@contextlib.contextmanager
def diagnostic_dispatches():
    """Dispatches inside this block leave the per-family active-tier
    records as they were (snapshotted on entry, restored on exit): the
    :mod:`igg_torch.integrity` shadow replay runs the truth step between
    two serving dispatches, and without this guard the replay's tier would
    look like the serving one to :func:`demote_active` and to the perf
    ledger's window attribution."""
    with _lock:
        saved = dict(_ACTIVE)
    try:
        yield
    finally:
        with _lock:
            _ACTIVE.clear()
            _ACTIVE.update(saved)


def demotable(since: Optional[int] = None
              ) -> List[Tuple[str, str, int, bool]]:
    """`[(family, tier, rung, on_card)]`: the non-truth, unquarantined
    tier that served each family's most recent dispatch (with `since`,
    only families that dispatched strictly after that
    :func:`dispatch_stamp`), whether that dispatch served CUDA tensors:
    what :func:`demote_active` would quarantine."""
    with _lock:
        records = list(_ACTIVE.items())
    return [(family, tname, rung, card)
            for family, (tname, rung, truth, card, stamp) in records
            if not truth and not (since is not None and stamp <= since)
            and not is_quarantined(tname)]


def demote_active(reason: str = "nan_recurrence",
                  error_text: Optional[str] = None,
                  since: Optional[int] = None) -> List[str]:
    """Quarantine the non-truth tier(s) that served each family's most
    recent dispatch (igg's recovery rung for a deterministic kernel
    blowup: a NaN recurring at the same step after a bit-exact rollback);
    `since` as in :func:`demotable`.  Returns the quarantined tier names
    (empty when nothing is left to demote).  Where such a tier last served
    CUDA tensors it raises `GridError` naming it and quarantines nothing:
    the rung below it is the truth tier, which the port does not serve on
    the card."""
    tiers = demotable(since)
    card = [(f, t) for f, t, _, on_card in tiers if on_card]
    if card:
        raise GridError(
            f"degrade: demoting the tier(s) ({', '.join(t for _, t in card)})"
            f" would serve {', '.join(f'{f}.plain' for f, _ in card)}, which "
            f"the port does not serve on the card; nothing was quarantined.")
    demoted = []
    for _, tname, rung, _ in tiers:
        quarantine(tname, rung, reason, error_text=error_text)
        demoted.append(tname)
    return demoted


@dataclasses.dataclass
class Tier:
    """One rung of a family's ladder.

    `build()` lazily returns the serving callable (built at most once per
    ladder); `admit(args)` returns an :class:`Admission` or bool per
    dispatch (None admits always); `truth` marks the plain rung, the
    verification's oracle; a `required` tier that is refused raises
    `GridError(requirement)` instead of leaving the call to a lower
    rung."""
    name: str
    rung: int
    build: Callable[[], Callable]
    admit: Optional[Callable[[tuple], object]] = None
    truth: bool = False
    required: bool = False
    requirement: Optional[str] = None


# Verification tolerances per dtype size: |tier - truth| <= atol +
# rtol * max|truth| (igg's).  The kernels are bitwise their plain versions
# on the card, so the budget only has to absorb the routes' different
# association (a chunk route against the per-step plain composition); a
# miscompile's corruption is of the order of the field.
_TOLERANCES = {
    2: (2e-2, 1e-2),     # bf16 / f16
    4: (1e-4, 1e-5),     # f32
    8: (1e-9, 1e-12),    # f64
}


def _on_card(args) -> bool:
    """Whether any argument is a CUDA tensor."""
    for a in args:
        if getattr(a, "is_cuda", False):
            return True
    return False


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_mismatch(i, a, b) -> Optional[str]:
    """Reason text when output tensor `i` of tier (`a`) and truth (`b`)
    disagree beyond tolerance; None when they agree.  Computed on the
    tensors' device in float64 (complex128 for complex dtypes); the
    verdicts and texts are igg's."""
    import torch

    if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
        return (f"output {i}: structure {tuple(a.shape)}/"
                f"{_dtype_name(a.dtype)} != {tuple(b.shape)}/"
                f"{_dtype_name(b.dtype)}")
    if not (a.is_floating_point() or a.is_complex()):
        if torch.equal(a, b):
            return None
        return f"output {i}: exact-dtype values differ"
    wide = torch.complex128 if a.is_complex() else torch.float64
    A = a.to(wide)
    B = b.to(wide)
    rtol, atol = _TOLERANCES.get(a.element_size(), (1e-4, 1e-5))
    # The tolerance scale stays finite: non-finite truth cells are held to
    # exact agreement (the same inf, or NaN on both sides) below.
    absB = B.abs()
    scale = (float(torch.where(torch.isfinite(B), absB,
                               torch.zeros_like(absB)).max())
             if B.numel() else 0.0)
    tol = atol + rtol * scale
    diff = (A - B).abs()
    agree = (diff <= tol) | (A == B) | (torch.isnan(A) & torch.isnan(B))
    nbad = int((~agree).sum())
    if nbad == 0:
        return None
    err = float(torch.where(torch.isfinite(diff), diff,
                            torch.full_like(diff, float("inf"))).max())
    return (f"output {i} ({tuple(a.shape)}, {_dtype_name(a.dtype)}): {nbad} "
            f"cell(s) beyond tolerance, max|tier-truth|={err:.3e} vs "
            f"tol={tol:.3e}")


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _compare_outputs(got, want) -> Optional[str]:
    ga, wa = _leaves(got), _leaves(want)
    if len(ga) != len(wa):
        return f"tier returned {len(ga)} leaves, truth {len(wa)}"
    for i, (a, b) in enumerate(zip(ga, wa)):
        detail = _leaf_mismatch(i, a, b)
        if detail is not None:
            return detail
    return None


_VERIFY_MODES = (None, False, True, "first_use")


class Ladder:
    """A family's ordered tier ladder (kernel rungs first, the plain truth
    rung last): per dispatch, walks admission and verify-on-first-use and
    serves the first rung that admits the call."""

    def __init__(self, family: str, tiers: Sequence[Tier], verify=None):
        if not tiers or not tiers[-1].truth:
            raise GridError(f"Ladder({family!r}): the last tier must be "
                            f"the plain truth rung.")
        if verify not in _VERIFY_MODES:
            raise GridError(
                f"verify={verify!r}: expected None (IGG_VERIFY_KERNELS "
                f"decides), False (off), or 'first_use'.")
        self.family = family
        self.tiers = list(tiers)
        self.verify = verify
        self._built: Dict[str, Callable] = {}

    def tier(self, name: str) -> Optional[Tier]:
        for t in self.tiers:
            if t.name == name:
                return t
        return None

    def _verify_enabled(self) -> bool:
        if self.verify is not None:
            return bool(self.verify)
        return _env.flag("IGG_VERIFY_KERNELS")

    def _fn(self, t: Tier) -> Callable:
        fn = self._built.get(t.name)
        if fn is None:
            if not t.truth:
                _chaos_compile_check(t.name)
            fn = self._built[t.name] = t.build()
        return fn

    def _call(self, t: Tier, fn: Callable, args: tuple):
        out = fn(*args)
        return out if t.truth else _chaos_corrupt(t.name, out)

    @staticmethod
    def _signature(args) -> tuple:
        import torch

        return tuple((tuple(a.shape), str(a.dtype), a.device.type)
                     if isinstance(a, torch.Tensor) else ((), repr(a))
                     for a in args)

    def _verify_first_use(self, t: Tier, fn: Callable, args: tuple) -> None:
        """One tier dispatch against one truth dispatch, each on clones of
        the real arguments; raises `GridError` on disagreement.  Runs at
        most once per (tier, argument signature)."""
        import torch

        sig = self._signature(args)
        with _lock:
            if (t.name, sig) in _VERIFIED:
                return
        truth = self.tiers[-1]
        truth_fn = self._fn(truth)

        def scratch():
            return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)
        with _telemetry.span("degrade.verify_first_use", tier=t.name,
                             family=self.family):
            got = self._call(t, fn, scratch())
            want = truth_fn(*scratch())
            detail = _compare_outputs(got, want)
        if detail is not None:
            event = {"kind": "tier_degraded", "tier": t.name, "rung": t.rung,
                     "reason": "verify_mismatch", "error": detail}
            with _lock:
                _EVENTS.append(event)
            _telemetry.emit("tier_degraded", tier=t.name, rung=t.rung,
                            reason="verify_mismatch", error=detail)
            raise GridError(
                f"tier {t.name} failed verify-on-first-use against "
                f"{truth.name}: {detail}; nothing was served (the port "
                f"does not fall back to {truth.name}).")
        with _lock:
            _VERIFIED.add((t.name, sig))
        self._perf_sample(t, fn, scratch)

    def _perf_sample(self, t: Tier, fn: Callable, scratch) -> None:
        """One warm timed dispatch of a tier that just passed its check,
        recorded in the perf ledger (source ``verify_first_use``; ms per
        dispatch): CUDA events on the card, the host clock on the CPU.  It
        runs inside the one-time verification, which has already
        synchronized, so an unverified dispatch gains no synchronization.
        Bookkeeping only: never fails the verified dispatch."""
        import time

        import torch

        from . import perf as _perf

        if not _perf.enabled():
            return
        try:
            args = scratch()
            if _on_card(args):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                self._call(t, fn, args)
                ev[1].record()
                ev[1].synchronize()
                ms = ev[0].elapsed_time(ev[1])
            else:
                t0 = time.perf_counter()
                self._call(t, fn, args)
                ms = (time.perf_counter() - t0) * 1e3
            ctx = _perf.sample_context(args[0] if args else None)
            _perf.record(self.family, t.name, ms, source="verify_first_use",
                         local_shape=ctx.get("local_shape", ()),
                         dtype=ctx.get("dtype", "-"), dims=ctx.get("dims"),
                         backend=ctx.get("backend"),
                         device_kind=ctx.get("device_kind"))
        except Exception:   # bookkeeping never fails a verified dispatch
            pass

    def _record_active(self, t: Tier, args: tuple) -> None:
        global _DISPATCHES
        card = _on_card(args)
        with _lock:
            _DISPATCHES += 1
            _ACTIVE[self.family] = (t.name, t.rung, t.truth, card,
                                    _DISPATCHES)
        _telemetry.counter("igg_tier_dispatch_total", family=self.family,
                           tier=t.name).inc()

    def dispatch(self, *args):
        skipped = None   # a quarantined tier that would have served
        for t in self.tiers:
            if t.truth:
                if skipped is not None and _on_card(args):
                    raise GridError(
                        f"tier {skipped.tier} is quarantined "
                        f"({skipped.reason}) and the rung below it is "
                        f"{t.name}, which the port does not serve on the "
                        f"card; nothing was served.  igg_torch.degrade."
                        f"reset({skipped.tier!r}) re-admits it.")
                out = self._fn(t)(*args)
                self._record_active(t, args)
                return out
            q = _QUARANTINE.get(t.name) if _QUARANTINE else None
            if q is not None:
                if t.required:
                    raise GridError(
                        f"tier {t.name} is required but quarantined "
                        f"({q.reason}): {q.error or '<no capture>'}.  "
                        f"igg_torch.degrade.reset({t.name!r}) re-admits "
                        f"it.")
                if skipped is None and (t.admit is None or t.admit(args)):
                    skipped = q
                continue
            adm = t.admit(args) if t.admit is not None else True
            if not adm:
                reason = getattr(adm, "reason", "") or "not admitted"
                with _lock:
                    _ADMISSION_LOG[t.name] = reason
                if t.required:
                    raise GridError(t.requirement
                                    or f"tier {t.name}: {reason}")
                continue
            fn = self._fn(t)
            if self._verify_enabled():
                self._verify_first_use(t, fn, args)
            out = self._call(t, fn, args)
            self._record_active(t, args)
            return out
        raise GridError(   # unreachable: the truth rung always serves
            f"degrade: no tier of {self.family} could serve the dispatch.")
