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

- **No quarantine, no fall to the truth tier.**  Where igg quarantines a
  tier and serves the next one, the port raises: a verify mismatch raises
  `GridError` naming the tier, the output and the figures
  (`max|tier-truth|` against `tol`), emits `tier_degraded` and serves
  nothing; a kernel that fails to build or launch raises as it is.  So
  :func:`is_quarantined` is always False and :func:`status` is empty.

- **Observable.**  :func:`active` names the tier that served each family's
  last dispatch, :func:`events` the `tier_degraded` log,
  :func:`admission_log` the last refusal reason of each tier; the counter
  `igg_tier_dispatch_total{family,tier}` counts dispatches.
  :func:`reset` clears this state (`finalize_global_grid` does).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import _env
from . import telemetry as _telemetry
from .shared import GridError

__all__ = ["Admission", "Tier", "Ladder", "status", "events", "active",
           "active_records", "admission_log", "is_quarantined", "reset"]


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


# Process-wide ladder state, keyed by tier name so every ladder of a family
# (factories are cheap and recreated freely) shares one verification
# memory.
_lock = threading.Lock()
_ACTIVE: Dict[str, str] = {}            # family -> tier serving last dispatch
_ACTIVE_STAMP: Dict[str, int] = {}      # family -> dispatch counter at that
_DISPATCHES = 0                         # monotone dispatch counter
_VERIFIED: set = set()                  # (tier name, argument signature)
_ADMISSION_LOG: Dict[str, str] = {}     # tier -> last refusal reason
_EVENTS: List[dict] = []                # tier_degraded event log


def is_quarantined(tier: str) -> bool:
    """Always False: the port quarantines nothing (a failing tier
    raises)."""
    return False


def status() -> Dict[str, object]:
    """The quarantined tiers: always empty in the port."""
    return {}


def events() -> List[dict]:
    """The `tier_degraded` event log, oldest first (each entry: kind,
    tier, rung, reason, error)."""
    with _lock:
        return list(_EVENTS)


def active() -> Dict[str, str]:
    """Which tier served each family's most recent dispatch."""
    with _lock:
        return dict(_ACTIVE)


def active_records() -> List[Tuple[str, str, int]]:
    """`[(family, serving tier, dispatch stamp)]`: :func:`active` with the
    monotone dispatch counter at each family's last dispatch."""
    with _lock:
        return [(f, t, _ACTIVE_STAMP.get(f, 0)) for f, t in _ACTIVE.items()]


def admission_log() -> Dict[str, str]:
    """The last refusal reason per tier."""
    with _lock:
        return dict(_ADMISSION_LOG)


def reset(tier: Optional[str] = None) -> None:
    """Forget `tier`'s verifications and refusal (or, with no argument,
    clear all ladder state: verification memory, active-tier records,
    refusals and the event log)."""
    with _lock:
        if tier is not None:
            for key in [k for k in _VERIFIED if k[0] == tier]:
                _VERIFIED.discard(key)
            _ADMISSION_LOG.pop(tier, None)
            return
        _ACTIVE.clear()
        _ACTIVE_STAMP.clear()
        _VERIFIED.clear()
        _ADMISSION_LOG.clear()
        _EVENTS.clear()


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
            fn = self._built[t.name] = t.build()
        return fn

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
            got = fn(*scratch())
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

    def _record_active(self, tier_name: str) -> None:
        global _DISPATCHES
        with _lock:
            _DISPATCHES += 1
            _ACTIVE[self.family] = tier_name
            _ACTIVE_STAMP[self.family] = _DISPATCHES
        _telemetry.counter("igg_tier_dispatch_total", family=self.family,
                           tier=tier_name).inc()

    def dispatch(self, *args):
        for t in self.tiers:
            if t.truth:
                out = self._fn(t)(*args)
                self._record_active(t.name)
                return out
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
            out = fn(*args)
            self._record_active(t.name)
            return out
        raise GridError(   # unreachable: the truth rung always serves
            f"degrade: no tier of {self.family} could serve the dispatch.")
