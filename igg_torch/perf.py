"""The perf ledger: measured step times keyed by signature, the roofline
and cost-model gauges, and the benchmark regression gate (the port of
`igg/perf.py`).

- **The ledger.**  Every measured dispatch becomes a sample keyed
  ``(family, tier, local_shape, dtype, dims, backend, device_kind)`` with
  ms-per-step aggregates (best, mean, last, count, per-source counts).
  Samples come from three sources, none of which adds a host
  synchronization to an unverified dispatch:

  1. *watchdog windows*: the resilient loop's
     :class:`igg_torch.telemetry.StepStats` hands each window's ms/step to
     :func:`observe_window`, which credits the tiers that served a
     dispatch during the window (:func:`igg_torch.degrade.active_records`);
  2. *verify on first use*: after a kernel tier passes its check,
     :mod:`igg_torch.degrade` times one more warm dispatch on clones (CUDA
     events on the card) and records it;
  3. *calibration*: :func:`calibrate` slope-times a step (or a named
     family's default step) and records it; the autotuner's search
     records every candidate it measures.

  The ledger persists to a versioned JSON file (``IGG_PERF_LEDGER``,
  format ``igg-perf-ledger-v1``, igg's field for field, so each package
  reads the other's files) with merge-on-write saves that merge only what
  this process added since its last save to that file, and merges across
  runs (``python -m igg_torch.perf show|merge``).  :func:`query` and
  :func:`best` are the autotuner's prior.

- **Gauges.**  Each sample sets ``igg_achieved_gbps{family,tier}`` and
  ``igg_pct_hbm_peak`` from the family's analytic bytes per step
  (:func:`bytes_per_step`) over the card's peak memory rate
  (:func:`hbm_peak_gbps`).  :func:`predict` registers a cost model's
  seconds per step; later samples set ``igg_cost_model_rel_error{family}``
  and emit one ``cost_model_drift`` record per (family, tier) past
  ``IGG_PERF_DRIFT_TOL``.

- **The regression gate.**  ``python -m igg_torch.perf compare <baseline>
  <new> --tol X`` pairs benchmark JSONL rows on (metric, config) and
  their provenance (backend, device_kind, smoke), and exits 1 on a
  contract row whose ``"pass"`` flips false, a value past `tol` in the bad
  direction of its unit, or a missing golden row.

Keys and names (deliberate differences from igg):

- ``backend`` is ``"cuda"`` or ``"cpu"`` (the grid's device type) and
  ``device_kind`` is ``torch.cuda.get_device_name()`` or ``"cpu"``.  An
  entry of another backend or device kind is kept, shown and merged, but
  never matches the live key, so it never serves.
- Tier names are the port's.  igg's map onto them: ``<family>.xla`` →
  ``<family>.plain``; ``<family>.xla`` with ``overlap`` →
  ``<family>.overlap``; ``<family>.mosaic`` → ``<family>.cuda``;
  ``.trapezoid``, ``.chunk`` and ``.banded`` keep their names
  (:func:`port_tier`).
- The peak table is the card's, keyed by the device name; an unknown name
  gives None and the percent gauge is skipped.
- The port's grid holds every block on one device, so the gauges count
  the bytes of all blocks (``local_shape`` times the blocks of ``dims``);
  :func:`bytes_per_step` itself is igg's, per block.

Host bookkeeping only: no device work and no synchronization.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import _env
from . import shared
from . import telemetry as _telemetry
from .shared import GridError

__all__ = [
    "enabled", "ledger_path", "record", "query", "best", "predict",
    "calibrate", "observe_window", "window_state", "sample_context",
    "device_context", "bytes_per_step", "hbm_peak_gbps", "save", "load",
    "merge_ledgers", "reset", "invalidate", "forget_prediction",
    "compare_rows", "compare_paths", "register_family",
    "registered_families", "port_tier", "LEDGER_FORMAT",
]

LEDGER_FORMAT = "igg-perf-ledger-v1"

_lock = threading.RLock()
_LEDGER: Dict[Tuple, Dict] = {}          # key tuple -> aggregate entry
_PREDICTIONS: Dict[str, Dict] = {}       # family -> cost-model prediction
_DRIFT_EMITTED: set = set()              # (family, tier) drift events sent
# What this process has already put into each ledger FILE ({path: {key:
# {count, sum_ms, sources}}}): a save merges only the delta since the last
# save to that file, and load() credits a file's entries to its baseline,
# so repeated saves never count a sample twice.
_PERSISTED: Dict[str, Dict[Tuple, Dict]] = {}
_last_save = 0.0
_atexit_registered = False


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """The master switch: ``IGG_PERF=0`` disables all recording (queries
    and the CLI still work on whatever was loaded)."""
    return _env.flag("IGG_PERF", True)


def _rank_path(var: str) -> Optional[pathlib.Path]:
    """The file that knob `var` names, rank-tagged where a process group
    is initialized (``ledger.json`` → ``ledger_r3.json`` on rank 3); None
    when the knob is unset."""
    raw = _env.text(var)
    if not raw:
        return None
    p = pathlib.Path(raw)
    rank = _telemetry._process()
    if rank:
        p = p.with_name(f"{p.stem}_r{rank}{p.suffix or '.json'}")
    return p


def ledger_path() -> Optional[pathlib.Path]:
    """The configured on-disk ledger (``IGG_PERF_LEDGER``), rank-tagged
    (:func:`_rank_path`).  None when unset: the ledger then lives in
    memory only."""
    return _rank_path("IGG_PERF_LEDGER")


def port_tier(tier: Optional[str], overlap: bool = False) -> Optional[str]:
    """igg's tier name mapped onto the port's (module docstring); the
    port's own names pass through."""
    if not tier:
        return tier
    family, _, route = str(tier).rpartition(".")
    if route == "xla":
        return f"{family}.overlap" if overlap else f"{family}.plain"
    if route == "mosaic":
        return f"{family}.cuda"
    return tier


# ---------------------------------------------------------------------------
# Roofline accounting: analytic bytes per step, the card's peak rate
# ---------------------------------------------------------------------------

# Full-field accesses per step of the per-step tiers (igg's ideal-fusion
# traffic model):
#   diffusion3d: read T and Cp, write T                -> 3 accesses
#   stokes3d:    read P, Vx, Vy, Vz, Rho, write four   -> 9 accesses
#   hm3d:        read Pe, phi, write Pe, phi           -> 4 accesses
#   wave2d:      read P, Vx, Vy, write P, Vx, Vy       -> 6 accesses
_FAMILY_ACCESSES = {"diffusion3d": 3, "stokes3d": 9, "hm3d": 4, "wave2d": 6}

# Registered families (spec families among them): `accesses` for
# bytes_per_step, `steps(dtype) -> (state_fn, args)` for calibrate.  The
# built-ins stay in the tables above as the fallback; entries here win.
_FAMILY_REGISTRY: Dict[str, Dict] = {}


def register_family(name: str, *, accesses: Optional[int] = None,
                    steps=None) -> None:
    """Register (or update) a family with the perf layer: `accesses` feeds
    :func:`bytes_per_step`, `steps` (a `(dtype) -> (state_fn, args)`
    function on the live grid) makes :func:`calibrate` work for the family
    by name.  Idempotent; `igg_torch.stencil.compile` calls it for every
    compiled spec."""
    with _lock:
        _FAMILY_REGISTRY[str(name)] = {
            "accesses": int(accesses) if accesses is not None else None,
            "steps": steps,
        }


def registered_families() -> Dict[str, Dict]:
    """The registered-family table (name -> {accesses, steps})."""
    with _lock:
        return dict(_FAMILY_REGISTRY)


# Peak memory rate per card, GB/s, matched by substring against the
# lowercased `torch.cuda.get_device_name()`.  The figure every bound of
# PERF.md uses.
_HBM_PEAK_TABLE: Sequence[Tuple[str, float]] = (
    ("h100 80gb hbm3", 3350.0),
)


def bytes_per_step(family: str, tier: Optional[str], local_shape,
                   dtype) -> Optional[int]:
    """Analytic memory traffic of ONE step of `family`'s per-step tiers on
    a `local_shape` block of `dtype` (igg's ideal-fusion model).  None
    where no model applies: an unknown family, no shape, or a resident
    K-step chunk tier (``.trapezoid``, ``.chunk``), which moves the fields
    once per K steps.  The streaming ``.banded`` tier re-streams every
    field each iteration, so the per-step model applies to it."""
    reg = _FAMILY_REGISTRY.get(family)
    acc = (reg["accesses"] if reg and reg.get("accesses") is not None
           else _FAMILY_ACCESSES.get(family))
    if acc is None or not local_shape:
        return None
    if tier and ("trapezoid" in tier or tier.endswith(".chunk")):
        return None
    itemsize = _itemsize(dtype)
    if itemsize is None:
        return None
    cells = 1
    for s in local_shape:
        cells *= int(s)
    return acc * cells * itemsize


def _itemsize(dtype) -> Optional[int]:
    import torch

    name = str(dtype).replace("torch.", "")
    try:
        return torch.empty((), dtype=getattr(torch, name)).element_size()
    except (AttributeError, TypeError):
        return None


def hbm_peak_gbps(device_kind: Optional[str]) -> Optional[float]:
    """The card's peak memory rate (GB/s) for a device name, or None when
    the name is unknown (a CPU has none)."""
    if not device_kind:
        return None
    dk = str(device_kind).lower()
    for pat, val in _HBM_PEAK_TABLE:
        if pat in dk:
            return val
    return None


# ---------------------------------------------------------------------------
# Sample context (key axes from shapes and the grid: metadata only)
# ---------------------------------------------------------------------------

def device_context() -> Dict:
    """`{backend, device_kind}` of the live grid's device (without a grid:
    the card where there is one, else the CPU): the environment half of
    the ledger key."""
    import torch

    if shared.grid_is_initialized():
        dev = torch.device(shared.global_grid().device)
    else:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        return {"backend": "cuda",
                "device_kind": torch.cuda.get_device_name(dev)}
    return {"backend": dev.type, "device_kind": dev.type}


def sample_context(array=None) -> Dict:
    """Ledger-key context from a live grid array: its block shape, dtype,
    the grid's `dims` and the device context.  With `array=None` only the
    grid and device axes are filled."""
    ctx = dict(device_context())
    ctx["dims"] = (tuple(shared.global_grid().dims)
                   if shared.grid_is_initialized() else None)
    if array is not None:
        shape = tuple(getattr(array, "shape", ()))
        if shared.grid_is_initialized():
            try:
                shape = tuple(shared.global_grid().local_shape_any(array))
            except ValueError:
                pass    # not a grid array: its own shape
        ctx["local_shape"] = shape
        ctx["dtype"] = _dtype_name(getattr(array, "dtype",
                                           type(array).__name__))
    return ctx


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------

def _key(family, tier, local_shape, dtype, dims, backend, device_kind
         ) -> Tuple:
    return (str(family), str(tier),
            tuple(int(s) for s in (local_shape or ())),
            _dtype_name(dtype),
            tuple(int(d) for d in dims) if dims else None,
            str(backend) if backend else None,
            str(device_kind) if device_kind else None)


def _key_str(k: Tuple) -> str:
    """A ledger or tuning-cache key as the files spell it (igg's): its
    axes joined by ``|``, a shape or dims by ``x``, an absent axis ``-``."""
    return "|".join(("x".join(map(str, v)) if isinstance(v, tuple) else v)
                    or "-" for v in k)


def _entry_key(e: Dict) -> Tuple:
    return _key(e["family"], e["tier"], e.get("local_shape") or (),
                e.get("dtype", "-"), e.get("dims"), e.get("backend"),
                e.get("device_kind"))


def _blocks(dims) -> int:
    n = 1
    for d in dims or ():
        n *= int(d)
    return n


def record(family: str, tier: str, ms_per_step: float, *,
           local_shape=(), dtype="-", dims=None, backend=None,
           device_kind=None, source: str = "api",
           window_steps: Optional[int] = None) -> Optional[Dict]:
    """Record one measured sample: update the keyed aggregates, the
    roofline and cost-model gauges, emit a ``perf_sample`` record, and
    (throttled) autosave the on-disk ledger.  Returns the updated entry (a
    copy), or None where recording is off (``IGG_PERF=0``) or the sample
    is unusable (not a finite positive number)."""
    if not enabled():
        return None
    try:
        ms = float(ms_per_step)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(ms) or ms <= 0:
        return None
    k = _key(family, tier, local_shape, dtype, dims, backend, device_kind)
    now = time.time()
    with _lock:
        e = _LEDGER.get(k)
        if e is None:
            e = _LEDGER[k] = {
                "family": k[0], "tier": k[1], "local_shape": list(k[2]),
                "dtype": k[3], "dims": list(k[4]) if k[4] else None,
                "backend": k[5], "device_kind": k[6],
                "count": 0, "sum_ms": 0.0, "best_ms": ms, "last_ms": ms,
                "sources": {}, "updated_wall": now,
            }
        e["count"] += 1
        e["sum_ms"] += ms
        e["best_ms"] = min(e["best_ms"], ms)
        e["last_ms"] = ms
        e["mean_ms"] = e["sum_ms"] / e["count"]
        e["sources"][source] = e["sources"].get(source, 0) + 1
        e["updated_wall"] = now
        snapshot = dict(e)

    payload = {"family": k[0], "tier": k[1], "ms_per_step": ms,
               "local_shape": list(k[2]), "dtype": k[3],
               "dims": list(k[4]) if k[4] else None, "backend": k[5],
               "device_kind": k[6], "source": source}
    if window_steps is not None:
        payload["window_steps"] = int(window_steps)

    # Roofline gauges: every block of the grid lives on the one device.
    nbytes = bytes_per_step(k[0], k[1], k[2], k[3])
    if nbytes:
        gbps = nbytes * _blocks(k[4]) / (ms * 1e-3) / 1e9
        payload["achieved_gbps"] = gbps
        _telemetry.gauge("igg_achieved_gbps", family=k[0],
                         tier=k[1]).set(gbps)
        peak = hbm_peak_gbps(k[6])
        if peak:
            pct = 100.0 * gbps / peak
            payload["pct_hbm_peak"] = pct
            _telemetry.gauge("igg_pct_hbm_peak", family=k[0],
                             tier=k[1]).set(pct)

    # Cost-model drift: measured beside the registered prediction.
    pred = _PREDICTIONS.get(k[0])
    if pred is not None:
        rel = (pred["s_per_step"] * 1e3 - ms) / ms
        payload["predicted_s_per_step"] = pred["s_per_step"]
        payload["cost_model_rel_error"] = rel
        _telemetry.gauge("igg_cost_model_rel_error", family=k[0]).set(rel)
        tol = _env.number("IGG_PERF_DRIFT_TOL", 0.5)
        if abs(rel) > tol:
            with _lock:
                fresh = (k[0], k[1]) not in _DRIFT_EMITTED
                _DRIFT_EMITTED.add((k[0], k[1]))
            if fresh:
                _telemetry.emit(
                    "cost_model_drift", family=k[0], tier=k[1],
                    rel_error=rel, tol=tol, measured_ms=ms,
                    predicted_s_per_step=pred["s_per_step"],
                    prediction_source=pred.get("source"))

    _telemetry.emit("perf_sample", **payload)
    _maybe_autosave()
    return snapshot


def predict(family: str, compute_s_per_step: float, *,
            source: str = "cost_model", **extra) -> None:
    """Register a cost model's predicted seconds per step for `family`.
    Samples recorded for the family, now or later, maintain the
    ``igg_cost_model_rel_error{family}`` gauge and fire
    ``cost_model_drift`` once per (family, tier) past
    ``IGG_PERF_DRIFT_TOL``."""
    pred = {"s_per_step": float(compute_s_per_step), "source": source,
            **extra}
    with _lock:
        _PREDICTIONS[family] = pred
    _telemetry.emit("cost_model_prediction", family=family,
                    compute_s_per_step=pred["s_per_step"], source=source)
    # A measurement may already exist: set the gauge now.
    e = best(family)
    if e is not None:
        rel = (pred["s_per_step"] * 1e3 - e["best_ms"]) / e["best_ms"]
        _telemetry.gauge("igg_cost_model_rel_error", family=family).set(rel)


def forget_prediction(family: str) -> None:
    """Unregister `family`'s cost-model prediction (a recalibration drops
    the stale one first, so its fresh samples cannot re-fire
    ``cost_model_drift`` against it)."""
    with _lock:
        _PREDICTIONS.pop(family, None)


def query(family: Optional[str] = None, *, tier: Optional[str] = None,
          local_shape=None, dtype=None, dims=None, backend=None,
          device_kind=None) -> List[Dict]:
    """Entries matching every given filter (None: any), best first.
    Shapes and dims compare as tuples."""
    def norm(x):
        return tuple(x) if x is not None else None

    want_shape, want_dims = norm(local_shape), norm(dims)
    out = []
    with _lock:
        entries = [dict(e) for e in _LEDGER.values()]
    for e in entries:
        if family is not None and e["family"] != family:
            continue
        if tier is not None and e["tier"] != tier:
            continue
        if want_shape is not None and tuple(e["local_shape"]) != want_shape:
            continue
        if dtype is not None and e["dtype"] != _dtype_name(dtype):
            continue
        if want_dims is not None and norm(e["dims"]) != want_dims:
            continue
        if backend is not None and e["backend"] != backend:
            continue
        if device_kind is not None and e["device_kind"] != device_kind:
            continue
        out.append(e)
    # igg's deterministic order: best_ms, then the better-evidenced entry
    # (higher count), then the freshest, then the tier's name.
    out.sort(key=lambda e: (e["best_ms"], -e["count"],
                            -e.get("updated_wall", 0.0), e["tier"]))
    return out


def best(family: str, local_shape=None, **filters) -> Optional[Dict]:
    """The fastest recorded entry for `family` under the filters: the
    autotuner's prior."""
    matches = query(family, local_shape=local_shape, **filters)
    return matches[0] if matches else None


def reset() -> None:
    """Clear the in-memory ledger, predictions, drift memory and the
    registered families (the file is untouched; tests isolate with it)."""
    global _last_save
    with _lock:
        _LEDGER.clear()
        _PREDICTIONS.clear()
        _DRIFT_EMITTED.clear()
        _PERSISTED.clear()
        _FAMILY_REGISTRY.clear()
        _last_save = 0.0


def invalidate(family: str, tier: Optional[str] = None) -> int:
    """Drop every in-memory entry of `family` (optionally one `tier`),
    re-arm its ``cost_model_drift`` events and evict its tuning-cache
    winners (:func:`igg_torch.autotune.invalidate`), so a drifted
    calibration stops answering :func:`best` before fresh samples replace
    it.  The entries also leave the per-file baselines, so a later save
    merges the new samples as new deltas (the file keeps the old
    aggregates as history).  Emits ``perf_invalidated``; returns the
    number of ledger entries dropped."""
    with _lock:
        keys = [k for k in _LEDGER
                if k[0] == family and (tier is None or k[1] == tier)]
        for k in keys:
            del _LEDGER[k]
        for base in _PERSISTED.values():
            for k in [b for b in base
                      if b[0] == family and (tier is None or b[1] == tier)]:
                del base[k]
        for dk in [d for d in _DRIFT_EMITTED if d[0] == family
                   and (tier is None or d[1] == tier)]:
            _DRIFT_EMITTED.discard(dk)
    from . import autotune as _autotune

    tune_evicted = _autotune.invalidate(family, tier=tier)
    _telemetry.emit("perf_invalidated", family=family, tier=tier,
                    entries=len(keys), tune_evicted=tune_evicted)
    return len(keys)


# ---------------------------------------------------------------------------
# Watchdog-window attribution (no additional host synchronization)
# ---------------------------------------------------------------------------

def window_state() -> Dict:
    """Per-run attribution state for :func:`observe_window`: the ladder's
    dispatch stamp, so a window is credited only to families that
    dispatched during it."""
    from . import degrade

    return {"stamp": degrade.dispatch_stamp()}


def observe_window(run: str, ms_per_step: float, window_steps: int,
                   ctx: Optional[Dict], state: Dict) -> List[Dict]:
    """One watchdog window's rate, credited to each `(family, tier)` whose
    ladder dispatch stamp advanced since the previous window (source
    ``"watchdog"``).  Reads host-side ladder state only."""
    if ctx is None or not enabled():
        return []
    from . import degrade

    prev = state.get("stamp", -1)
    recs = degrade.active_records()
    state["stamp"] = degrade.dispatch_stamp()
    out = []
    for family, tier, stamp in recs:
        if stamp <= prev:
            continue
        e = record(family, tier, ms_per_step, source="watchdog",
                   window_steps=window_steps,
                   local_shape=ctx.get("local_shape", ()),
                   dtype=ctx.get("dtype", "-"), dims=ctx.get("dims"),
                   backend=ctx.get("backend"),
                   device_kind=ctx.get("device_kind"))
        if e is not None:
            out.append(e)
    return out


# ---------------------------------------------------------------------------
# Explicit calibration
# ---------------------------------------------------------------------------

def _default_family_step(family: str, dtype):
    """(state_fn, args) of a named family's default step on the live grid:
    the convenience behind ``calibrate("diffusion3d")``.  Registered
    families resolve through their registered `steps` first."""
    reg = _FAMILY_REGISTRY.get(family)
    if reg is not None and reg.get("steps") is not None:
        return reg["steps"](dtype)
    if family == "diffusion3d":
        from .models import diffusion3d as m

        T, Cp = m.init_fields(m.Params(), dtype=dtype)
        step = m.make_step(m.Params())
        return (lambda T, Cp: (step(T, Cp), Cp)), (T, Cp)
    if family == "hm3d":
        from .models import hm3d as m

        fields = m.init_fields(m.Params(), dtype=dtype)
        step = m.make_step(m.Params())
        return (lambda *fs: step(*fs)), tuple(fields)
    if family == "stokes3d":
        from .models import stokes3d as m

        fields = m.init_fields(m.Params(), dtype=dtype)
        it = m.make_iteration(m.Params())
        # The iteration returns (P, Vx, Vy, Vz); Rho rides along.
        return (lambda P, Vx, Vy, Vz, Rho:
                it(P, Vx, Vy, Vz, Rho) + (Rho,)), tuple(fields)
    if family == "wave2d":
        from .models import wave2d as m

        fields = m.init_fields(m.Params(), dtype=dtype)
        step = m.make_step(m.Params())
        return (lambda P, Vx, Vy: step(P, Vx, Vy)), tuple(fields)
    raise GridError(
        f"igg_torch.perf.calibrate: unknown family {family!r} (built-ins: "
        f"diffusion3d, hm3d, stokes3d, wave2d; registered: "
        f"{sorted(_FAMILY_REGISTRY) or 'none'}; pass a step callable + "
        f"args for anything else, or register via "
        f"igg_torch.perf.register_family).")


def calibrate(model, args=None, *, family: Optional[str] = None,
              tier: Optional[str] = None, nt: int = 8, warmup: int = 1,
              dtype=None, source: str = "calibrate") -> float:
    """Slope-time a step and record it.  `model` is a step callable (then
    `args` is its argument tuple and `family` is required) or a family's
    name (its default step is built on the live grid, fields of `dtype`,
    float32 by default).  The measurement is :func:`igg_torch.time_steps`
    over batches of nt and 3·nt calls; the serving `tier` is read from
    :func:`igg_torch.degrade.active` after the timed calls unless given.
    Returns the measured seconds per call (and records ms unless
    ``IGG_PERF=0``)."""
    import torch

    from .timing import time_steps

    shared.check_initialized()
    if isinstance(model, str):
        family = family or model
        step_fn, args = _default_family_step(
            model, torch.float32 if dtype is None else dtype)
    else:
        if family is None:
            raise GridError("igg_torch.perf.calibrate: family= is required "
                            "when passing a step callable.")
        step_fn = model
        if args is None:
            raise GridError("igg_torch.perf.calibrate: args= (the step's "
                            "argument tuple) is required when passing a "
                            "step callable.")
    if nt < 1:
        raise GridError("igg_torch.perf.calibrate: nt must be >= 1.")
    args = tuple(args) if isinstance(args, (tuple, list)) else (args,)
    _, sec = time_steps(step_fn, args, n1=nt, n2=3 * nt, warmup=warmup)
    from . import degrade

    served = tier or degrade.active().get(family, f"{family}.plain")
    ctx = sample_context(args[0] if args else None)
    record(family, served, sec * 1e3, source=source,
           local_shape=ctx.get("local_shape", ()),
           dtype=ctx.get("dtype", "-"), dims=ctx.get("dims"),
           backend=ctx.get("backend"), device_kind=ctx.get("device_kind"))
    return sec


# ---------------------------------------------------------------------------
# Persistence: versioned JSON, merge-on-write, cross-run merge
# ---------------------------------------------------------------------------

def _merge_entry(into: Dict, e: Dict) -> None:
    into["count"] += e["count"]
    into["sum_ms"] += e["sum_ms"]
    into["best_ms"] = min(into["best_ms"], e["best_ms"])
    if e.get("updated_wall", 0) >= into.get("updated_wall", 0):
        into["last_ms"] = e["last_ms"]
        into["updated_wall"] = e.get("updated_wall", 0)
    into["mean_ms"] = into["sum_ms"] / max(1, into["count"])
    for s, n in e.get("sources", {}).items():
        into["sources"][s] = into["sources"].get(s, 0) + n


def merge_ledgers(entries_lists: Sequence[Sequence[Dict]]) -> Dict[Tuple,
                                                                   Dict]:
    """Merge entry lists: same-key aggregates combine (counts and sums
    add, best_ms is the least, last_ms the newest `updated_wall`'s)."""
    merged: Dict[Tuple, Dict] = {}
    for entries in entries_lists:
        for e in entries:
            k = _entry_key(e)
            have = merged.get(k)
            if have is None:
                merged[k] = json.loads(json.dumps(e))   # deep copy
            else:
                _merge_entry(have, e)
    return merged


def _read_ledger_file(path) -> List[Dict]:
    path = pathlib.Path(path)
    try:
        doc = json.loads(path.read_text())
    except OSError as e:
        raise GridError(f"igg_torch.perf: cannot read ledger {path}: {e}")
    except json.JSONDecodeError as e:
        raise GridError(f"igg_torch.perf: {path} is not valid JSON ({e}).")
    if not isinstance(doc, dict) or doc.get("format") != LEDGER_FORMAT:
        raise GridError(
            f"igg_torch.perf: {path} is not an {LEDGER_FORMAT} ledger "
            f"(format={doc.get('format') if isinstance(doc, dict) else '?'!r}).")
    return list(doc.get("entries", {}).values())


def _baseline_snapshot(e: Dict) -> Dict:
    return {"count": e["count"], "sum_ms": e["sum_ms"],
            "sources": dict(e.get("sources", {}))}


def _delta_entry(e: Dict, base: Optional[Dict]) -> Optional[Dict]:
    """`e` less what was already persisted (`base`): the only part a save
    may merge into a file that holds the earlier save.  None when nothing
    new happened under this key."""
    if base is None:
        return dict(e)
    d_count = e["count"] - base["count"]
    if d_count <= 0:
        return None
    d = dict(e)
    d["count"] = d_count
    d["sum_ms"] = e["sum_ms"] - base["sum_ms"]
    d["mean_ms"] = d["sum_ms"] / d_count
    d["sources"] = {s: n - base["sources"].get(s, 0)
                    for s, n in e.get("sources", {}).items()
                    if n - base["sources"].get(s, 0) > 0}
    return d


def _write_doc(target: pathlib.Path, doc: Dict) -> None:
    """Replace `target` with `doc` atomically (tmp + rename)."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(target.name + ".tmp")
    tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
    os.replace(tmp, target)


def save(path=None) -> Optional[pathlib.Path]:
    """Persist the ledger: read the file, merge in this process's delta
    since its last save to that file, and replace the file atomically
    (tmp + rename), so concurrent runs lose nothing and repeated saves
    never count twice.  `path` defaults to :func:`ledger_path`; with
    neither, a no-op returning None."""
    global _last_save
    target = pathlib.Path(path) if path is not None else ledger_path()
    if target is None:
        return None
    pkey = str(target.resolve())
    on_disk: List[Dict] = []
    disk_ok = False
    if target.exists():
        try:
            on_disk = _read_ledger_file(target)
            disk_ok = True
        except GridError:
            on_disk = []   # a corrupt ledger is replaced, not fatal
    with _lock:
        _last_save = time.monotonic()
        base = _PERSISTED.get(pkey, {}) if disk_ok else {}
        mine = []
        for k, e in _LEDGER.items():
            d = _delta_entry(e, base.get(k))
            if d is not None:
                mine.append(d)
        new_base = {k: _baseline_snapshot(e) for k, e in _LEDGER.items()}
    merged = merge_ledgers([on_disk, mine])
    doc = {"format": LEDGER_FORMAT, "saved_wall": time.time(),
           "process": _telemetry._process(),
           "entries": {_key_str(k): e for k, e in sorted(
               merged.items(), key=lambda kv: _key_str(kv[0]))}}
    try:
        _write_doc(target, doc)
    except OSError:
        return None   # a full or read-only disk must never kill the run
    with _lock:
        _PERSISTED[pkey] = new_base
    return target


def load(path=None, *, replace: bool = False) -> int:
    """Load a ledger file into memory, merging with what is there
    (``replace=True`` clears first).  `path` defaults to
    :func:`ledger_path`.  Returns the number of entries in memory; raises
    `GridError` on a missing, invalid or foreign-format file."""
    target = pathlib.Path(path) if path is not None else ledger_path()
    if target is None:
        raise GridError("igg_torch.perf.load: no path given and "
                        "IGG_PERF_LEDGER is unset.")
    entries = _read_ledger_file(target)
    with _lock:
        pkey = str(target.resolve())
        if replace:
            _LEDGER.clear()
            _PERSISTED.clear()
            _PERSISTED[pkey] = {_entry_key(e): _baseline_snapshot(e)
                                for e in entries}
        else:
            # The loaded amounts came from this file: credit them to its
            # baseline, or the next save would merge them in again.
            base = _PERSISTED.setdefault(pkey, {})
            for e in entries:
                k = _entry_key(e)
                have = base.get(k)
                if have is None:
                    base[k] = _baseline_snapshot(e)
                else:
                    have["count"] += e["count"]
                    have["sum_ms"] += e["sum_ms"]
                    for s, n in e.get("sources", {}).items():
                        have["sources"][s] = have["sources"].get(s, 0) + n
        merged = merge_ledgers([[dict(e) for e in _LEDGER.values()],
                                entries])
        _LEDGER.clear()
        _LEDGER.update(merged)
        return len(_LEDGER)


def _maybe_autosave() -> None:
    """Throttled persistence: at most one save per ``IGG_PERF_SAVE_EVERY``
    seconds (default 60), plus one at process exit."""
    global _atexit_registered
    if ledger_path() is None:
        return
    if not _atexit_registered:
        import atexit

        with _lock:
            if not _atexit_registered:
                _atexit_registered = True
                atexit.register(lambda: save())
    every = _env.number("IGG_PERF_SAVE_EVERY", 60.0)
    if time.monotonic() - _last_save >= every:
        save()


# ---------------------------------------------------------------------------
# Regression gating: benchmark-row comparison
# ---------------------------------------------------------------------------

def _load_rows(path) -> List[Dict]:
    """Benchmark JSONL rows from a file or a directory of ``*.jsonl``
    (``*.failed.jsonl`` excluded); unparsable lines are skipped."""
    p = pathlib.Path(path)
    if p.is_dir():
        files = sorted(f for f in p.glob("*.jsonl")
                       if not f.name.endswith(".failed.jsonl"))
    else:
        files = [p]
    if not files:
        raise GridError(f"igg_torch.perf compare: no .jsonl files under {p}.")
    rows = []
    for f in files:
        try:
            text = f.read_text()
        except OSError as e:
            raise GridError(f"igg_torch.perf compare: cannot read {f}: {e}")
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row, dict) and "metric" in row:
                rows.append(row)
    return rows


def _row_key(r: Dict) -> Tuple[str, str]:
    return (str(r.get("metric")),
            json.dumps(r.get("config"), sort_keys=True, default=str))


def _row_prov(r: Dict) -> Tuple:
    """The provenance rows must share to be compared: backend,
    device_kind, smoke flag."""
    prov = r.get("provenance") or {}
    return (prov.get("backend"), prov.get("device_kind"), r.get("smoke"))


def _direction(unit: Optional[str]) -> str:
    """'lower' (ms, %, seconds), 'higher' (GB/s, steps/s, jobs/hour,
    efficiency and overlap fractions, speedups) or 'abs' (relative-error
    columns: closer to zero is better)."""
    u = (unit or "").lower()
    if "relative error" in u or "rel_error" in u:
        return "abs"
    for tok in ("gb/s", "gbps", "/s", "/sec", "/hour", "/hr", "flop",
                "fraction", "efficiency", "speedup"):
        if tok in u:
            return "higher"
    return "lower"


def compare_rows(baseline: Sequence[Dict], new: Sequence[Dict], *,
                 tol: float = 0.1, allow_missing: bool = False,
                 gate_pass_values: bool = False) -> Dict:
    """Compare two benchmark row sets (the regression gate, igg's).

    Rows pair on (metric, canonical config) and are compared only when
    their provenance matches.  A golden ``"pass": true`` turning false is
    always a regression (a contract row's value is informational unless
    `gate_pass_values`); value rows regress past `tol` relative in the bad
    direction of their unit; golden rows without a new counterpart are
    `missing` (a regression unless `allow_missing`), or `out_of_scope`
    where their provenance matches no new row; new-only rows are
    informational.  Returns ``{regressions, improvements, ok, missing,
    out_of_scope, new_only, lines, failed}``."""
    base_by_key: Dict[Tuple, Dict] = {}
    for r in baseline:
        base_by_key[_row_key(r)] = r      # last row per key wins
    new_by_key: Dict[Tuple, Dict] = {}
    for r in new:
        new_by_key[_row_key(r)] = r
    new_provs = {_row_prov(r) for r in new}

    regressions, improvements, ok = [], [], []
    missing, out_of_scope = [], []
    lines: List[str] = []

    def fin(row, field="value"):
        v = row.get(field)
        return float(v) if isinstance(v, (int, float)) else None

    for key, b in sorted(base_by_key.items()):
        n = new_by_key.get(key)
        label = f"{key[0]} config={key[1]}"
        if n is None:
            if _row_prov(b) not in new_provs:
                out_of_scope.append(key)
                lines.append(f"SKIP (provenance out of scope) {label}")
            else:
                missing.append(key)
                lines.append(f"MISSING {label}")
            continue
        if _row_prov(b) != _row_prov(n):
            out_of_scope.append(key)
            lines.append(f"SKIP (provenance mismatch "
                         f"{_row_prov(b)} vs {_row_prov(n)}) {label}")
            continue
        verdicts = []
        if isinstance(b.get("pass"), bool):
            if b["pass"] and not n.get("pass"):
                verdicts.append(("regression",
                                 'contract "pass": true -> false'))
            gate_value = gate_pass_values
        else:
            gate_value = True
        bv, nv = fin(b), fin(n)
        if gate_value and bv is not None and nv is not None:
            d = _direction(b.get("unit"))
            if d == "abs":
                drift = abs(nv) - abs(bv)
                if drift > tol:
                    verdicts.append(("regression",
                                     f"|error| {abs(bv):.4g} -> "
                                     f"{abs(nv):.4g} (+{drift:.4g} > "
                                     f"tol {tol:g})"))
            else:
                scale = abs(bv)
                rel = ((nv - bv) / scale if scale
                       else (math.inf if nv > bv else 0.0))
                bad = rel if d == "lower" else -rel
                if bad > tol:
                    arrow = f"{bv:.6g} -> {nv:.6g}"
                    verdicts.append(("regression",
                                     f"value {arrow} ({bad:+.1%} beyond "
                                     f"tol {tol:.0%}, {d}-is-better "
                                     f"unit {b.get('unit')!r})"))
                elif -bad > tol:
                    verdicts.append(("improvement",
                                     f"value {bv:.6g} -> {nv:.6g}"))
        regs = [v for v in verdicts if v[0] == "regression"]
        if regs:
            regressions.append((key, [v[1] for v in regs]))
            for _, why in regs:
                lines.append(f"REGRESSION {label}: {why}")
        elif any(v[0] == "improvement" for v in verdicts):
            improvements.append(key)
            lines.append(f"IMPROVED {label}: "
                         f"{[v[1] for v in verdicts if v[0] == 'improvement'][0]}")
        else:
            ok.append(key)
            lines.append(f"OK {label}")

    new_only = sorted(set(new_by_key) - set(base_by_key))
    failing = len(regressions) + (0 if allow_missing else len(missing))
    lines.append(
        f"compare: {len(ok) + len(improvements) + len(regressions)} "
        f"matched ({len(regressions)} regression(s), "
        f"{len(improvements)} improved), {len(missing)} missing"
        f"{' (allowed)' if allow_missing and missing else ''}, "
        f"{len(out_of_scope)} out-of-scope, {len(new_only)} new-only")
    return {"regressions": regressions, "improvements": improvements,
            "ok": ok, "missing": missing, "out_of_scope": out_of_scope,
            "new_only": new_only, "lines": lines,
            "failed": failing > 0}


def compare_paths(baseline, new, *, tol: float = 0.1,
                  allow_missing: bool = False,
                  gate_pass_values: bool = False) -> Dict:
    """:func:`compare_rows` over files or directories of benchmark
    JSONL."""
    return compare_rows(_load_rows(baseline), _load_rows(new), tol=tol,
                        allow_missing=allow_missing,
                        gate_pass_values=gate_pass_values)


# ---------------------------------------------------------------------------
# CLI: python -m igg_torch.perf show|merge|compare|tune
# ---------------------------------------------------------------------------

def _format_entries(entries: Sequence[Dict]) -> str:
    import io

    out = io.StringIO()
    header = (f"{'family':<12} {'tier':<24} {'local_shape':<16} "
              f"{'dtype':<9} {'dims':<8} {'backend':<7} "
              f"{'best_ms':>10} {'mean_ms':>10} {'n':>5}  sources")
    out.write(header + "\n")
    for e in sorted(entries, key=lambda e: (e["family"], e["best_ms"])):
        shape = "x".join(map(str, e.get("local_shape") or [])) or "-"
        dims = ("x".join(map(str, e["dims"])) if e.get("dims") else "-")
        srcs = ",".join(f"{s}:{n}"
                        for s, n in sorted(e.get("sources", {}).items()))
        out.write(f"{e['family']:<12} {e['tier']:<24} {shape:<16} "
                  f"{e['dtype']:<9} {dims:<8} {e.get('backend') or '-':<7} "
                  f"{e['best_ms']:>10.4f} {e.get('mean_ms', 0):>10.4f} "
                  f"{e['count']:>5}  {srcs}\n")
    return out.getvalue()


def _main(argv: Sequence[str]) -> int:
    import sys

    usage = (
        "usage: python -m igg_torch.perf show [<ledger.json>] [--family F]\n"
        "           [--tier T]\n"
        "       python -m igg_torch.perf tune [<cache.json>] [--family F]\n"
        "           [--ledger <ledger.json>]\n"
        "       python -m igg_torch.perf merge <out.json> <ledger.json> "
        "[...]\n"
        "       python -m igg_torch.perf compare <baseline> <new> "
        "[--tol X]\n"
        "           [--allow-missing] [--gate-pass-values]\n"
        "  show     print a ledger (default: $IGG_PERF_LEDGER) as a table,\n"
        "           optionally one family and/or tier\n"
        "  tune     print the tuning cache (default: $IGG_TUNE_CACHE)\n"
        "           beside the ledger's best entry for each winner\n"
        "  merge    merge ledger files into one (aggregates combine)\n"
        "  compare  regression-gate benchmark JSONL rows/dirs; exit 1 on\n"
        "           regressions (or missing golden rows)")
    argv = list(argv)
    if not argv:
        print(usage, file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]

    def take_flag(name):
        if name in rest:
            i = rest.index(name)
            val = rest[i + 1]
            del rest[i:i + 2]
            return val
        return None

    try:
        if cmd == "show":
            fam = take_flag("--family")
            tier_f = take_flag("--tier")
            path = rest[0] if rest else ledger_path()
            if path is None:
                print("igg_torch.perf show: no ledger given and "
                      "IGG_PERF_LEDGER is unset.", file=sys.stderr)
                return 2
            entries = _read_ledger_file(path)
            if fam is not None:
                entries = [e for e in entries if e["family"] == fam]
            if tier_f is not None:
                entries = [e for e in entries if e["tier"] == tier_f]
            print(f"# {path} ({len(entries)} entr"
                  f"{'y' if len(entries) == 1 else 'ies'})")
            sys.stdout.write(_format_entries(entries))
            return 0
        if cmd == "tune":
            from . import autotune

            fam = take_flag("--family")
            ledger_arg = take_flag("--ledger")
            path = rest[0] if rest else autotune.cache_path()
            if path is None:
                print("igg_torch.perf tune: no cache given and "
                      "IGG_TUNE_CACHE is unset.", file=sys.stderr)
                return 2
            entries = autotune._read_cache_file(path)
            if fam is not None:
                entries = [e for e in entries if e["family"] == fam]
            lpath = ledger_arg or ledger_path()
            led = []
            if lpath is not None and pathlib.Path(lpath).exists():
                led = _read_ledger_file(lpath)
            print(f"# {path} ({len(entries)} winner"
                  f"{'' if len(entries) == 1 else 's'})"
                  + (f" vs prior {lpath}" if led else " (no ledger prior)"))
            print(f"{'family':<14} {'local_shape':<14} {'tier':<22} "
                  f"{'K':>3} {'bx':>3} {'band':>4} {'ovl':>4} "
                  f"{'ms':>9}  prior (ledger best)")
            for e in sorted(entries, key=lambda e: (e["family"],
                                                    str(e["local_shape"]))):
                shape = "x".join(map(str, e.get("local_shape") or [])) or "-"
                prior = [l for l in led
                         if l["family"] == e["family"]
                         and tuple(l.get("local_shape") or ())
                         == tuple(e.get("local_shape") or ())]
                prior.sort(key=lambda l: l["best_ms"])
                ptxt = (f"{prior[0]['tier']} @ {prior[0]['best_ms']:.4f} ms"
                        if prior else "-")
                print(f"{e['family']:<14} {shape:<14} "
                      f"{e.get('tier') or '-':<22} "
                      f"{e.get('K') or '-':>3} {e.get('bx') or '-':>3} "
                      f"{e.get('band') or '-':>4} "
                      f"{'yes' if e.get('overlap') else '-':>4} "
                      f"{(e.get('ms') or 0):>9.4f}  {ptxt}")
            return 0
        if cmd == "merge":
            if len(rest) < 2:
                print(usage, file=sys.stderr)
                return 2
            out, inputs = rest[0], rest[1:]
            merged = merge_ledgers([_read_ledger_file(p) for p in inputs])
            doc = {"format": LEDGER_FORMAT, "saved_wall": time.time(),
                   "process": -1,
                   "entries": {_key_str(k): e for k, e in sorted(
                       merged.items(), key=lambda kv: _key_str(kv[0]))}}
            _write_doc(pathlib.Path(out), doc)
            print(f"merged {len(merged)} entr"
                  f"{'y' if len(merged) == 1 else 'ies'} from "
                  f"{len(inputs)} ledger(s) -> {out}", file=sys.stderr)
            return 0
        if cmd == "compare":
            tol, allow_missing, gate_pass = 0.1, False, False
            if "--tol" in rest:
                i = rest.index("--tol")
                tol = float(rest[i + 1])
                del rest[i:i + 2]
            if "--allow-missing" in rest:
                allow_missing = True
                rest.remove("--allow-missing")
            if "--gate-pass-values" in rest:
                gate_pass = True
                rest.remove("--gate-pass-values")
            if len(rest) != 2:
                print(usage, file=sys.stderr)
                return 2
            rep = compare_paths(rest[0], rest[1], tol=tol,
                                allow_missing=allow_missing,
                                gate_pass_values=gate_pass)
            for line in rep["lines"]:
                print(line)
            return 1 if rep["failed"] else 0
    except (GridError, ValueError, IndexError) as e:
        print(f"igg_torch.perf {cmd}: {e}", file=sys.stderr)
        return 2
    print(usage, file=sys.stderr)
    return 2


if __name__ == "__main__":   # python -m igg_torch.perf ...
    import sys

    sys.exit(_main(sys.argv[1:]))
