"""igg_torch.integrity — the numeric-integrity layer of the resilient loop
(the port of `igg/integrity.py`): defense against silent data corruption.

The watchdog counts non-finite values, the rollback scan asks for finite
generations and `verify_checkpoint` checks CRCs and finiteness.  A flaky
card or a flipped bit in device memory that leaves finite but wrong
values passes all of them.  This module adds three mechanisms, none of
which reads the device outside the loop's one copy a watch window:

1. **Invariant probes.**  Families declare conserved or bounded quantities
   through :func:`register_invariants` (diffusion's total heat, shallow
   water's total mass, the wave energy bound; `igg_torch.stencil` specs
   register theirs at compile).  Each is a moment sum (`Σ f^m`, m = 1 or
   2) over the owned cells of its fields, taken per block (the block owns
   its first `s − ol` cells along each dim, the last block of an open dim
   all `s`: the ownership rule of the checkpoint's deep stamps) and
   stacked in x-fastest block order.  The sums ride the watchdog's probe:
   ONE float32 vector on the device, in igg's layout, copied once a
   window into pinned memory by the loop.  Drift past the invariant's
   tolerance is an ``integrity_violation`` carrying the per-block
   partials; the block whose partial moved most is the suspect (`rank`).

2. **Shadow re-execution.**  Every `check_every` watch windows the monitor
   clones the watched fields at the window's start (a device-to-device
   copy on the caller's stream; PyTorch fields change in place, so a
   reference would be overwritten by the next step) and at the window's
   end re-runs the window on the clone with the truth step, inside
   :func:`igg_torch.degrade.diagnostic_dispatches`.  Per watched field,
   `Σ|state − truth|` and `Σ|state|` over owned cells join the same
   vector (the "wide" probe).  This catches corruption no invariant
   covers; it costs one window of compute every `check_every` windows.

3. **Verified-generation rollback.**  While a run is integrity-enabled,
   every generation it writes carries the invariants' reference values in
   its deep stamp (:func:`stamp_entries`, read by
   `igg_torch.checkpoint`); `verify_checkpoint(deep=True)` recomputes
   them, and the loop's rollback and resume scans prefer the newest
   deep-verified generation.

The probe sums in float32, as igg's does, and the deep stamps in float64;
`DEFAULT_TOL` absorbs the gap.  Every block lives on one device, so a
violation's `rank` is the block and its `device` the device's name.  The
reductions are strided views of the block-stacked tensors where the term
is the field itself (moment 1 of a float32 field), else slabs of at most
`resilience._PROBE_SLAB_BYTES` of float32 temporaries.

Wiring: ``run_resilient(integrity=)`` (None: on when ``IGG_INTEGRITY=1``;
True: the environment's config; an :class:`IntegrityConfig`; False: off).
Chaos: :func:`igg_torch.chaos.silent_corruption` (live state) and
:func:`igg_torch.chaos.poison_checkpoint` (a generation on disk).

The ensemble half (:func:`igg_torch.run_ensemble`):
:func:`member_invariant_rows` gives each invariant's per-member value and
scale sums, rows of the ensemble's probe matrix, and :class:`MemberRefs`
anchors them per member and names the members whose invariant drifted.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _env
from . import shared
from . import telemetry as _telemetry
from .shared import NDIMS, GridError

__all__ = ["Invariant", "IntegrityConfig", "register_invariants",
           "invariants_for", "registered_families", "match_invariants",
           "as_config", "stamp_entries", "Monitor", "DEFAULT_TOL",
           "member_invariant_rows", "MemberRefs"]

# Relative drift tolerance default (IGG_INTEGRITY_TOL): the probe sums in
# float32 and the deep stamp in float64, so the floor absorbs ~1e-6 of
# cross-precision slack on top of the scheme's own conservation roundoff,
# and any corruption worth detecting (far above one ulp of the field)
# trips it.
DEFAULT_TOL = 1e-3
_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One family-declared conserved or bounded quantity: ``value =
    Σ_fields Σ_owned f^moment`` over the owned cells of the global grid
    (overlap copies counted once, the outer planes of open dims included).

    - ``moment=1``, ``kind="conserved"``: a conservation law; the value
      stays within ``tol × scale`` of its reference, ``scale = Σ|f|``
      taken with the reference.
    - ``moment=2``, ``kind="bounded"``: an energy bound; the value may
      decay or oscillate but never grow past ``ref + tol × scale``.

    ``requires_periodic``: the law holds only where every dim is periodic
    (an open boundary leaks the quantity); such invariants are skipped on
    grids with an open dim.  ``tol=None`` takes the config's default."""
    name: str
    fields: Tuple[str, ...]
    moment: int = 1
    kind: str = "conserved"           # "conserved" | "bounded"
    tol: Optional[float] = None
    requires_periodic: bool = True

    def __post_init__(self):
        if self.moment not in (1, 2):
            raise GridError(f"Invariant {self.name!r}: moment must be 1 "
                            f"(sum) or 2 (sum of squares).")
        if self.kind not in ("conserved", "bounded"):
            raise GridError(f"Invariant {self.name!r}: kind must be "
                            f"'conserved' or 'bounded'.")
        if not self.fields:
            raise GridError(f"Invariant {self.name!r}: fields is empty.")
        object.__setattr__(self, "fields", tuple(self.fields))


# ---------------------------------------------------------------------------
# The family registry
# ---------------------------------------------------------------------------

_REG_LOCK = threading.Lock()
_FAMILIES: Dict[str, Tuple[Invariant, ...]] = {}


def register_invariants(family: str, invariants: Sequence[Invariant]) -> None:
    """Declare `family`'s invariants (replacing an earlier registration).
    Model modules call this at import, `igg_torch.stencil.compile` for a
    spec that declares invariants."""
    invs = tuple(invariants)
    for inv in invs:
        if not isinstance(inv, Invariant):
            raise GridError(f"register_invariants({family!r}): expected "
                            f"Invariant instances, got {type(inv).__name__}.")
    with _REG_LOCK:
        _FAMILIES[family] = invs


def invariants_for(family: str) -> Tuple[Invariant, ...]:
    with _REG_LOCK:
        return _FAMILIES.get(family, ())


def registered_families() -> List[str]:
    with _REG_LOCK:
        return sorted(_FAMILIES)


def match_invariants(state_keys, grid) -> Tuple[Invariant, ...]:
    """Every registered invariant whose fields are all in the run's state
    (and whose periodicity requirement the grid meets), in registration
    order, the first registration of a name winning."""
    keys = set(state_keys)
    out: List[Invariant] = []
    seen = set()
    with _REG_LOCK:
        fams = list(_FAMILIES.items())
    for _, invs in fams:
        for inv in invs:
            if inv.name in seen or not set(inv.fields) <= keys:
                continue
            if inv.requires_periodic and not all(grid.periods):
                continue
            seen.add(inv.name)
            out.append(inv)
    return tuple(out)


# ---------------------------------------------------------------------------
# The integrity= knob
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IntegrityConfig:
    """One run's integrity layer.

    - `invariants`: explicit :class:`Invariant` list, or None for the
      registry's match against the state's field names.
    - `check_every`: shadow re-execution cadence in watch windows
      (default ``IGG_INTEGRITY_CHECK_EVERY``, 4; 0 disables shadows).
    - `tol`: default relative drift tolerance (default
      ``IGG_INTEGRITY_TOL``); an invariant's own `tol` wins.
    - `shadow_tol`: relative tolerance of the shadow comparison (default
      `tol`; with the run's own step as truth a healthy diff is 0).
    - `deep_verify`: rollback and resume scans prefer deep-verified
      generations (default ``IGG_INTEGRITY_DEEP_VERIFY``, on).
    - `truth_step_fn`: the shadow's step (e.g. the family's plain tier);
      None re-runs the run's own step, which catches corruption that does
      not recur on re-execution."""
    invariants: Optional[Sequence[Invariant]] = None
    check_every: Optional[int] = None
    tol: Optional[float] = None
    shadow_tol: Optional[float] = None
    deep_verify: Optional[bool] = None
    truth_step_fn: Optional[Callable] = None

    def resolved_check_every(self) -> int:
        if self.check_every is not None:
            ce = int(self.check_every)
        else:
            ce = int(_env.number("IGG_INTEGRITY_CHECK_EVERY", 4))
        if ce < 0:
            raise GridError("IntegrityConfig: check_every must be >= 0 "
                            "(0 disables shadow checks).")
        return ce

    def resolved_tol(self) -> float:
        tol = (float(self.tol) if self.tol is not None
               else float(_env.number("IGG_INTEGRITY_TOL", DEFAULT_TOL)))
        if tol <= 0:
            raise GridError("IntegrityConfig: tol must be > 0.")
        return tol

    def resolved_deep(self) -> bool:
        if self.deep_verify is not None:
            return bool(self.deep_verify)
        return _env.flag("IGG_INTEGRITY_DEEP_VERIFY", True)


def as_config(integrity) -> Optional[IntegrityConfig]:
    """Coerce ``integrity=``: None gives a config only where
    ``IGG_INTEGRITY=1``; True the environment's config; an
    :class:`IntegrityConfig` itself; False None even where the knob is
    set."""
    if integrity is False:
        return None
    if integrity is None:
        if not _env.flag("IGG_INTEGRITY", False):
            return None
        return IntegrityConfig()
    if integrity is True:
        return IntegrityConfig()
    if isinstance(integrity, IntegrityConfig):
        return integrity
    raise GridError(
        f"integrity={integrity!r}: expected None, False, True, or an "
        f"igg_torch.integrity.IntegrityConfig.")


# ---------------------------------------------------------------------------
# Owned-cell reductions on block-stacked tensors
# ---------------------------------------------------------------------------

def _inexact(a) -> bool:
    return isinstance(a, torch.Tensor) and (a.is_floating_point()
                                            or a.is_complex())


def _ownership(shape, grid):
    """Per grid dim `(blocks, s, keep, extra)` of a stacked array of
    `shape`: every block owns cells `[0, keep)`, and where `extra` the last
    block also `[keep, s)` (an open dim).  Dims past the array's rank are
    `(1, 1, 1, False)`: a lower-rank field counts at block coordinate 0 of
    the missing dims (igg's replica gate)."""
    nd = min(len(shape), NDIMS)
    out = []
    for d in range(NDIMS):
        if d >= nd:
            out.append((1, 1, 1, False))
            continue
        b = grid.dims[d]
        s = int(shape[d]) // b
        ol = grid.overlaps[d] + (s - grid.nxyz[d])
        keep = s - max(ol, 0)
        out.append((b, s, keep, not grid.periods[d] and keep < s))
    return out


def _boxes(own):
    """The owned region as boxes of the blocked view: for each subset of
    the dims with an `extra` range, `(block selector, cell selector)` per
    dim (all blocks and `[0, keep)`, or the last block and `[keep, s)`)."""
    extra = [d for d, o in enumerate(own) if o[3]]
    for k in range(len(extra) + 1):
        for sub in itertools.combinations(extra, k):
            sel = []
            for d, (b, s, keep, _) in enumerate(own):
                sel.append((slice(b - 1, b), slice(keep, s)) if d in sub
                           else (slice(None), slice(0, keep)))
            yield sel


def _blocked(own) -> List[int]:
    """The blocked shape `(b0, s0, b1, s1, ...)` of dims `own`."""
    return [x for b, s, _, _ in own for x in (b, s)]


def _block_sums(arrays, grid, term=None) -> torch.Tensor:
    """Per-block owned-cell sums `Σ term(*arrays)` in float32, as a
    `(nprocs,)` tensor on the arrays' device in x-fastest block order.
    `term` maps row slabs of the arrays (views of the same rows) to one
    float32 tensor; None sums the first array itself (a float32 field:
    strided views of it, no temporaries).  A term is taken over slabs of
    x rows of at most `_PROBE_SLAB_BYTES` of float32."""
    from .resilience import _PROBE_SLAB_BYTES

    a0 = arrays[0]
    own = _ownership(a0.shape, grid)
    out = torch.zeros(grid.dims[::-1], dtype=torch.float32,
                      device=a0.device).permute(2, 1, 0)
    # The blocks this field spans (1 along dims past its rank).
    mine = out[tuple(slice(0, o[0]) for o in own)]
    if term is None:
        v = a0.reshape(*_blocked(own), -1)
        for sel in _boxes(own):
            mine[tuple(b for b, _ in sel)] += v[
                tuple(x for pair in sel for x in pair)].sum(
                    dim=(1, 3, 5, 6), dtype=torch.float32)
        return out.permute(2, 1, 0).reshape(-1)
    b0, s0, keep0, extra0 = own[0]
    plane = max(1, int(np.prod(a0.shape[1:], dtype=np.int64)))
    rows = max(1, _PROBE_SLAB_BYTES // (4 * plane))
    for c in range(b0):
        hi = s0 if (extra0 and c == b0 - 1) else keep0
        for r0 in range(0, hi, rows):
            r1 = min(hi, r0 + rows)
            lo = c * s0
            y = term(*[x[lo + r0:lo + r1] for x in arrays])
            v = y.reshape(r1 - r0, *_blocked(own[1:]), -1)
            for sel in _boxes(own[1:]):
                mine[(c,) + tuple(b for b, _ in sel)] += v[
                    (slice(None),) + tuple(x for pair in sel
                                           for x in pair)].sum(
                        dim=(0, 2, 4, 5), dtype=torch.float32)
    return out.permute(2, 1, 0).reshape(-1)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _moment_term(moment: int, absolute: bool = False):
    """The elementwise term of an owned moment (igg's `_masked_moment`:
    the field cast to float32, then squared or its magnitude taken)."""
    if moment == 2:
        return lambda x: _f32(x).square()
    if absolute:
        return lambda x: _f32(x).abs()
    return _f32


def _moment_sums(a: torch.Tensor, moment: int, grid,
                 absolute: bool = False) -> torch.Tensor:
    if moment == 1 and not absolute and a.dtype == torch.float32:
        return _block_sums((a,), grid)
    return _block_sums((a,), grid, _moment_term(moment, absolute))


def _shadow_sums(a: torch.Tensor, t: torch.Tensor, grid):
    """Per-block `Σ|a − t|` and `Σ|a|` over owned cells, in float32."""
    diff = _block_sums((a, t), grid,
                       lambda x, y: (_f32(x) - _f32(y)).abs())
    return diff, _moment_sums(a, 1, grid, absolute=True)


# ---------------------------------------------------------------------------
# The fused run probe
# ---------------------------------------------------------------------------

def _moment_map(invariants: Sequence[Invariant]) -> Dict[str, Tuple[int, ...]]:
    """field -> sorted moments that some invariant needs of it (host-side,
    an invariant's value is `Σ_fields partial[f, m]`)."""
    moms: Dict[str, set] = {}
    for inv in invariants:
        for f in inv.fields:
            moms.setdefault(f, set()).add(inv.moment)
    return {f: tuple(sorted(ms)) for f, ms in moms.items()}


def _build_probe(watch: Sequence[str], extra: Sequence[str],
                 invariants: Sequence[Invariant], kind: str):
    """The probe over the watched fields (then the invariant-only `extra`
    fields, then, for ``kind="wide"``, the truth's watched fields): one
    float32 vector on the fields' device, in igg's layout —

    - the non-finite count of each watched field (0 for a field that is
      not floating);
    - per (field, moment) an invariant needs: the `(nprocs,)` per-block
      partials of `Σ_owned f^m`;
    - ``"anchor"`` and ``"wide"``: per (field, moment) the scale partials
      `Σ_owned |f|^m` (for m = 2 the value rows again);
    - ``"wide"``: per watched field the partials of `Σ_owned |f − truth|`
      and of `Σ_owned |f|`.

    Nothing is read back; the grid is read at each call."""
    from .resilience import probe_counts

    watch = tuple(watch)
    extra = tuple(extra)
    moms = _moment_map(invariants)
    vs_keys = [(f, m) for f in watch + extra for m in moms.get(f, ())]

    def probe(*arrays) -> torch.Tensor:
        grid = shared.global_grid()
        n, ne = len(watch), len(extra)
        cur = dict(zip(watch + extra, arrays[:n + ne]))
        truth = dict(zip(watch, arrays[n + ne:])) if kind == "wide" else {}
        pieces = [probe_counts(*[cur[f] for f in watch])] if watch else []
        vals = {key: _moment_sums(cur[key[0]], key[1], grid)
                for key in vs_keys}
        pieces += [vals[key] for key in vs_keys]
        if kind in ("anchor", "wide"):
            for name, m in vs_keys:
                pieces.append(vals[(name, m)] if m == 2 else
                              _moment_sums(cur[name], 1, grid,
                                           absolute=True))
        if kind == "wide":
            for name in watch:
                pieces += _shadow_sums(cur[name], truth[name], grid)
        return torch.cat(pieces)

    return probe


# ---------------------------------------------------------------------------
# The checkpoint stamp context (read by igg_torch.checkpoint at save time)
# ---------------------------------------------------------------------------

_STAMP_LOCK = threading.Lock()
_STAMP: Optional[List[dict]] = None


def _set_stamp_context(entries: Optional[List[dict]]) -> None:
    global _STAMP
    with _STAMP_LOCK:
        _STAMP = list(entries) if entries is not None else None


def stamp_entries() -> Optional[List[dict]]:
    """The active run's invariant stamp entries (None outside an
    integrity-enabled run): ``{name, fields, moment, kind, tol, ref,
    scale}`` dicts for the deep stamp; `ref`/`scale` are None until the
    first probe anchors them (deep verify then checks content only).
    Thread-safe: the background checkpoint writer reads it."""
    with _STAMP_LOCK:
        return [dict(e) for e in _STAMP] if _STAMP is not None else None


# ---------------------------------------------------------------------------
# The run monitor (owned by run_resilient)
# ---------------------------------------------------------------------------

class Monitor:
    """One run's integrity runtime: the fused probes, the shadow window's
    snapshot, the invariant references, the decode of fetched probe
    vectors into verdicts, and the stamp context.  Host bookkeeping
    outside the probes."""

    def __init__(self, cfg: IntegrityConfig, state: Dict,
                 watch: Sequence[str], watch_every: int,
                 steps_per_call: int, run: str = "resilient"):
        grid = shared.global_grid()
        self.run = run
        # The full watch list, non-float fields included: their count row
        # is 0, so the loop's zip(watch, counts) stays aligned.
        self.watch = list(watch)
        if cfg.invariants is not None:
            invs = tuple(cfg.invariants)
            missing = [i.name for i in invs
                       if not set(i.fields) <= set(state)]
            if missing:
                raise GridError(
                    f"integrity: invariant(s) {missing} name fields not in "
                    f"the run state {sorted(state)}.")
        else:
            invs = match_invariants(state, grid)
        self.invariants = invs
        for inv in invs:
            for f in inv.fields:
                if not _inexact(state[f]):
                    raise GridError(
                        f"integrity: invariant {inv.name!r} field {f!r} "
                        f"has non-floating dtype "
                        f"{getattr(state[f], 'dtype', '?')}.")
        self.tol = cfg.resolved_tol()
        self.shadow_tol = (float(cfg.shadow_tol)
                           if cfg.shadow_tol is not None else self.tol)
        self.check_every = cfg.resolved_check_every()
        self.deep_verify = cfg.resolved_deep()
        self.truth_step_fn = cfg.truth_step_fn
        self.watch_every = int(watch_every)
        self.steps_per_call = int(steps_per_call)
        # Invariant-only fields (declared, not watched) feed the probe too.
        self.extra = list(dict.fromkeys(
            f for inv in invs for f in inv.fields if f not in self.watch))
        self._moms = _moment_map(invs)
        self.vs_keys = [(f, m) for f in self.watch + self.extra
                        for m in self._moms.get(f, ())]
        self._steady = _build_probe(self.watch, self.extra, invs, "steady")
        self._anchor = _build_probe(self.watch, self.extra, invs, "anchor")
        self._wide = (_build_probe(self.watch, self.extra, invs, "wide")
                      if self.check_every else None)
        self._snapshot: Optional[Dict] = None
        self._snapshot_step: Optional[int] = None
        # References: per-(field, moment) global values and scales and the
        # per-block value partials, anchored at the first clean fetch of
        # an anchor-width probe.
        self._ref_vals: Optional[Dict[Tuple, float]] = None
        self._ref_scales: Optional[Dict[Tuple, float]] = None
        self._ref_partials: Optional[Dict[Tuple, np.ndarray]] = None
        self.checks = 0
        self.shadow_checks = 0
        self.violations = 0
        self._m_checks = _telemetry.counter("igg_integrity_checks_total",
                                            run=run)
        self._m_shadow = _telemetry.counter(
            "igg_integrity_shadow_checks_total", run=run)
        self._m_viol = _telemetry.counter(
            "igg_integrity_violations_total", run=run)
        _telemetry.emit(
            "integrity_config", run=run,
            invariants=[i.name for i in invs],
            check_every=self.check_every, tol=self.tol,
            deep_verify=self.deep_verify,
            shadow="truth_step" if cfg.truth_step_fn is not None
                   else ("re_execution" if self.check_every else "off"))
        self._push_stamp()

    # -- stamp context -----------------------------------------------------
    def _inv_ref(self, inv: Invariant):
        """(ref, scale) of one invariant (None before the first anchor)."""
        if self._ref_vals is None:
            return None, None
        ref = sum(self._ref_vals[(f, inv.moment)] for f in inv.fields)
        sca = sum(self._ref_scales[(f, inv.moment)] for f in inv.fields)
        return float(ref), float(sca)

    def _push_stamp(self) -> None:
        entries = []
        for inv in self.invariants:
            ref, sca = self._inv_ref(inv)
            entries.append({
                "name": inv.name, "fields": list(inv.fields),
                "moment": inv.moment, "kind": inv.kind,
                "tol": inv.tol if inv.tol is not None else self.tol,
                "ref": ref, "scale": sca})
        _set_stamp_context(entries)

    def close(self) -> None:
        _set_stamp_context(None)

    # -- shadow snapshot ---------------------------------------------------
    def note_donation(self) -> None:
        """igg's donation notice; a PyTorch step donates nothing."""

    def _snap(self, state: Dict) -> Dict:
        """The window-entry state: the watched fields cloned on the
        device (the step may write them in place), the others by
        reference."""
        return {k: (v.clone() if k in self.watch and
                    isinstance(v, torch.Tensor) else v)
                for k, v in state.items()}

    def _arm(self, state: Optional[Dict], steps_done) -> None:
        self._snapshot = self._snapshot_step = None
        if state is not None and self.check_every:
            self._snapshot = self._snap(state)
            self._snapshot_step = steps_done

    def arm_entry(self, state: Dict, steps_done: int) -> None:
        """Snapshot the run-entry (or resumed) state, so the first window
        is shadow-checked."""
        self._arm(state, steps_done)

    def on_rollback(self, state: Optional[Dict] = None,
                    steps_done: Optional[int] = None) -> None:
        """A rollback moved the step: the pending snapshot is re-armed from
        the restored state, so the replay's first window is shadowed (a
        deterministic corruption recurs at the same probe step, which the
        demotion rung needs).  References are kept: the restored state is
        on the same trajectory."""
        self._arm(state, steps_done)

    def on_retile(self, state: Optional[Dict] = None,
                  steps_done: Optional[int] = None) -> None:
        """The block count changed: per-block reference partials re-anchor
        at the next clean fetch, and the snapshot re-arms."""
        self.on_rollback(state, steps_done)
        self._ref_partials = None

    def reset_reference(self) -> None:
        """Forget the references (after a demotion: a trajectory of the
        demoted tier's wrong physics is no reference); the next
        anchor-width probe anchors on the healthy tier's values."""
        self._ref_vals = self._ref_scales = self._ref_partials = None
        self._push_stamp()

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, state: Dict, steps_done: int, step_fn):
        """The probe at a watch boundary: the wide one where the window
        just completed was snapshotted (re-run from the snapshot with the
        truth step, as a diagnostic dispatch), the anchor one while no
        reference is anchored, else the steady one; arms the next window's
        snapshot on the check cadence.  Returns `(device vector, tag)`."""
        ndev = shared.global_grid().nprocs
        args = [state[n] for n in self.watch + self.extra]
        if (self._snapshot is not None
                and self._snapshot_step == steps_done - self.watch_every):
            from . import degrade as _degrade

            truth_fn = self.truth_step_fn or step_fn
            t = self._snapshot
            with _degrade.diagnostic_dispatches():
                for _ in range(self.watch_every // self.steps_per_call):
                    t = truth_fn(t)
            vec = self._wide(*args, *[t[n] for n in self.watch])
            tag = ("wide", ndev)
            self._snapshot = self._snapshot_step = None
        elif self._ref_vals is None:
            vec, tag = self._anchor(*args), ("anchor", ndev)
        else:
            vec, tag = self._steady(*args), ("steady", ndev)
        if (self.check_every
                and (steps_done // self.watch_every) % self.check_every == 0):
            self._arm(state, steps_done)
        return vec, tag

    # -- decode ------------------------------------------------------------
    def _attribute(self, partials: np.ndarray, ref: Optional[np.ndarray]):
        """The suspect block: the one whose partial moved most against the
        reference (or holds the most diff); None on one block."""
        if partials.size <= 1:
            return None
        delta = np.abs(partials - ref) if (
            ref is not None and ref.shape == partials.shape) else np.abs(
            partials)
        return int(np.argmax(delta))

    def decode(self, host: np.ndarray, tag, step_p: int):
        """Split a fetched probe vector into ``(nonfinite_counts,
        violation-or-None)``.  The first clean anchor-width fetch anchors
        the references; a drifted invariant or a shadow diff over
        tolerance gives the ``integrity_violation`` payload."""
        kind, ndev = tag
        n_w = len(self.watch)
        counts = host[:n_w]
        off = n_w
        vals: Dict[Tuple, float] = {}
        parts: Dict[Tuple, np.ndarray] = {}
        for key in self.vs_keys:
            p = host[off:off + ndev].astype(np.float64)
            vals[key] = float(p.sum())
            parts[key] = p
            off += ndev
        scales: Optional[Dict[Tuple, float]] = None
        if kind in ("anchor", "wide"):
            scales = {}
            for key in self.vs_keys:
                scales[key] = float(
                    host[off:off + ndev].astype(np.float64).sum())
                off += ndev
        shadow: List[Tuple[float, float, np.ndarray]] = []
        if kind == "wide":
            for _ in self.watch:
                dp = host[off:off + ndev].astype(np.float64)
                sp = host[off + ndev:off + 2 * ndev].astype(np.float64)
                shadow.append((float(dp.sum()), float(sp.sum()), dp))
                off += 2 * ndev
        if counts.sum() != 0:
            # Non-finite state: the NaN verdict outranks any drift.
            return counts, None
        self.checks += 1
        self._m_checks.inc()
        anchored_now = False
        if self._ref_vals is None:
            if scales is None:
                return counts, None   # a steady fetch before any anchor
            # Anchor.  This window's drift is zero against itself, but the
            # shadow rows (when wide) need no reference and are checked.
            self._ref_vals = dict(vals)
            self._ref_scales = dict(scales)
            self._ref_partials = {k: p.copy() for k, p in parts.items()}
            self._push_stamp()
            anchored_now = True
        if (self._ref_partials is None
                or (self.vs_keys
                    and self._ref_partials[self.vs_keys[0]].size != ndev)):
            self._ref_partials = {k: p.copy() for k, p in parts.items()}
        for inv in self.invariants if not anchored_now else ():
            value = sum(vals[(f, inv.moment)] for f in inv.fields)
            ref, ref_scale = self._inv_ref(inv)
            tol = inv.tol if inv.tol is not None else self.tol
            drift = value - ref
            bound = tol * max(ref_scale, _TINY)
            bad = (drift > bound if inv.kind == "bounded"
                   else abs(drift) > bound)
            if bad:
                partials = sum(parts[(f, inv.moment)] for f in inv.fields)
                ref_p = sum(self._ref_partials[(f, inv.moment)]
                            for f in inv.fields)
                rank = self._attribute(partials, ref_p)
                return counts, self._violation(
                    step_p, source="invariant", invariant=inv.name,
                    fields=list(inv.fields), value=value, ref=ref,
                    drift=float(drift), tol=tol,
                    scale=float(ref_scale), rank=rank,
                    partials=[float(x) for x in partials])
        if kind == "wide":
            self.shadow_checks += 1
            self._m_shadow.inc()
            for i, name in enumerate(self.watch):
                diff, scale, dp = shadow[i]
                bound = self.shadow_tol * max(scale, _TINY)
                if diff > bound:
                    rank = self._attribute(dp, None)
                    return counts, self._violation(
                        step_p, source="shadow", field=name,
                        diff=float(diff), scale=float(scale),
                        tol=self.shadow_tol, rank=rank,
                        partials=[float(x) for x in dp])
        return counts, None

    def _violation(self, step_p: int, **detail) -> dict:
        self.violations += 1
        self._m_viol.inc()
        grid = shared.global_grid()
        if detail.get("rank") is not None:
            # Every block lives on the grid's one device.
            dev = grid.device
            detail["device"] = (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else str(dev))
        return detail


# ---------------------------------------------------------------------------
# Ensemble support: per-member rows and references
# ---------------------------------------------------------------------------

def member_invariant_rows(invariants: Sequence[Invariant], arrays_by_field,
                          grid) -> List[torch.Tensor]:
    """The ensemble probe's invariant rows: per invariant, an `(M,)` value
    row `Σ_owned f^m` and an `(M,)` scale row `Σ_owned |f|^m` over the
    owned cells of each member's lane, in float32 (igg's
    `member_invariant_rows` under grid packing).  `arrays_by_field[f]` is
    a field's lanes: a stacked tensor (leading member axis) or the
    sequence of its M lane tensors.  A lane's sum is its per-block sums
    (:func:`_block_sums`) added over the blocks; several fields add."""
    rows = []
    for inv in invariants:
        val = sca = None
        for f in inv.fields:
            v = torch.stack([_moment_sums(a, inv.moment, grid).sum()
                             for a in arrays_by_field[f]])
            c = torch.stack([_moment_sums(a, inv.moment, grid,
                                          absolute=True).sum()
                             for a in arrays_by_field[f]])
            val = v if val is None else val + v
            sca = c if sca is None else sca + c
        rows.append(val)
        rows.append(sca)
    return rows


class MemberRefs:
    """The per-member reference and verdict bookkeeping behind
    :func:`igg_torch.run_ensemble`'s integrity rows (igg's class, on the
    host): decode a `(2·n_inv, M)` block of per-member (value, scale)
    rows, anchor references per member at the first clean fetch, and name
    the members whose invariant drifted."""

    def __init__(self, invariants: Sequence[Invariant], members: int,
                 tol: float):
        self.invariants = tuple(invariants)
        self.members = members
        self.tol = tol
        self._ref: Optional[np.ndarray] = None       # (n_inv, M) values
        self._ref_scale: Optional[np.ndarray] = None

    def rows(self) -> int:
        return 2 * len(self.invariants)

    def check(self, block: np.ndarray, lanes: np.ndarray) -> dict:
        """`block` is the probe matrix's invariant rows ((2·n_inv, M):
        value, scale per invariant); returns `{member: [names]}` of the
        accountable lanes whose invariants drifted."""
        vals = block[0::2].astype(np.float64)
        scas = block[1::2].astype(np.float64)
        if self._ref is None:
            # The first clean fetch anchors, per lane, so a quarantined
            # lane's NaN rows never block the healthy ones.
            self._ref, self._ref_scale = vals.copy(), scas.copy()
            return {}
        fill = ~np.isfinite(self._ref) & np.isfinite(vals)
        if fill.any():
            self._ref[fill] = vals[fill]
            self._ref_scale[fill] = scas[fill]
        bad: Dict[int, List[str]] = {}
        for i, inv in enumerate(self.invariants):
            tol = inv.tol if inv.tol is not None else self.tol
            drift = vals[i] - self._ref[i]
            bound = tol * np.maximum(self._ref_scale[i], _TINY)
            hit = (drift > bound if inv.kind == "bounded"
                   else np.abs(drift) > bound)
            # A non-finite value (or an unanchored reference) is the NaN
            # watchdog's case, not drift.
            hit &= np.isfinite(vals[i]) & np.isfinite(self._ref[i])
            for m in np.nonzero(hit & lanes)[0]:
                bad.setdefault(int(m), []).append(inv.name)
        return bad
