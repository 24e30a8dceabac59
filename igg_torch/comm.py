"""Communication observability: the comm ledger, the link-peak gauges,
the step-time decomposition, per-rank skew and collective-stall detection
(the port of `igg/comm.py`).

Five pieces, none of which adds a device-to-host synchronization to a hot
loop (`tests/test_torch_telemetry.py` runs its host-read sentinel with a
monitor and the heartbeat on):

- **The comm ledger.**  :func:`calibrate_comm` slope-times a standalone
  halo-exchange program (`n_inner` calls of :func:`igg_torch.update_halo`
  a step, through :func:`igg_torch.time_steps`; on the card the plane
  packer and the halo writer) and :func:`record_exchange` records the
  sample in the perf ledger under family ``"comm"``, tier
  ``halo.<set>.grouped``: ``<set>`` names the moving dims (`xyz`, `xy`,
  ...); the path is always ``grouped`` (the port has no stacked lane
  program).  ``python -m igg_torch.perf show --family comm`` renders it;
  ``python -m igg_torch.comm report`` joins it with the event streams.

- **Link-peak gauges.**  Each sample sets ``igg_halo_gbps{path=}``, the
  logical halo bytes (igg's accounting: 4 planes per field per moving
  dim, per block) over the measured time, and ``igg_pct_link_peak{path=}``
  over the bytes that cross a process boundary, where the card has a
  published link peak.  Every block of the port's grid lives in one
  process on one card, so no byte crosses a process boundary (the wire
  count is 0) and the percent gauge is omitted, never invented, until the
  `torch.distributed` backend exists.  :func:`plane_bytes_model` is the
  accounting of the ``igg_halo_plane_bytes_total`` counter, callable: one
  `update_halo` advances the counter by exactly its bytes.

- **Step-time decomposition.**  :func:`decompose` (ahead of a run) and
  :class:`StepDecomposition` (in a run, ``run_resilient(..., comm=)``)
  time three variants of one step on scratch copies of the state: the
  pure compute, the compute followed by one grouped `update_halo`, and
  :func:`igg_torch.hide_communication`; each ``comm_stats`` record carries
  the three times, the exposed-communication fraction `(exchange -
  compute) / exchange` and the overlap efficiency `(exchange - hidden) /
  (exchange - compute)`.  In a run each variant is a pair of batches
  (`reps` and `2 reps` iterations) dispatched back to back; on the card a
  timing `torch.cuda.Event` follows each batch and the second batch's
  time is read from the events once the second one reports ready through
  the watchdog's readiness channel (`resilience._is_ready`), so nothing
  waits for the device; on CPU tensors the host clock stands in.

- **Per-rank skew.**  :func:`rank_skew` takes the worst against the
  median window time per matching step over merged rank streams and
  publishes ``igg_rank_skew_ms``.

- **Collective-stall detection.**  :class:`StallWatchdog` is a host
  heartbeat thread (a hung exchange blocks the run loop in its next forced
  read, so only another thread can still speak).  `run_resilient`
  registers every watchdog probe (and every decomposition probe) with it
  and retires it when read; when the oldest one in flight is older than
  ``IGG_COMM_STALL_TIMEOUT`` seconds (default 120; 0 disables) and still
  reports not ready, the watchdog emits one ``collective_stall`` record
  per episode, writes ``stall_r<rank>.json`` into every attached session
  and ``IGG_TELEMETRY_DIR``, and dumps the flight recorder.
  :func:`igg_torch.chaos.collective_stall` shows it deterministically.

``python -m igg_torch.comm report [--ledger ledger.json] <session-dirs...>``
renders the comm ledger, the decomposition table, the skew table and the
stalls from artifacts alone.  File formats and record names are igg's.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _env
from . import shared
from . import telemetry as _telemetry
from .shared import GridError

__all__ = [
    "plane_bytes_model", "link_peak_gbps", "record_exchange",
    "calibrate_comm", "decompose", "StepDecomposition", "StallWatchdog",
    "make_stall_watchdog", "active_stalls", "rank_skew",
    "model_step_variants",
]


# ---------------------------------------------------------------------------
# The link-peak table
# ---------------------------------------------------------------------------

# Published aggregate link bandwidth per card, GB/s, matched by substring
# against the lowercased `torch.cuda.get_device_name()`.  The H100 SXM5
# (80GB HBM3) has 18 fourth-generation NVLink links, 900 GB/s in all
# (NVIDIA's H100 data sheet).  A CPU and any name not listed give None: the
# `igg_pct_link_peak` gauge is then omitted, never invented.
_LINK_PEAK_TABLE: Sequence[Tuple[str, float]] = (
    ("h100 80gb hbm3", 900.0),
)


def link_peak_gbps(device_kind: Optional[str]) -> Optional[float]:
    """Published aggregate link bandwidth (GB/s) of a card name, or None
    when unknown (a CPU, an unlisted card)."""
    if not device_kind:
        return None
    dk = str(device_kind).lower()
    for pat, val in _LINK_PEAK_TABLE:
        if pat in dk:
            return val
    return None


# ---------------------------------------------------------------------------
# The analytic plane-bytes model (the counter's accounting, callable)
# ---------------------------------------------------------------------------

def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a
    name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def plane_bytes_model(local_shape, dtype, *, nfields: int = 1, grid=None
                      ) -> Tuple[int, Dict[Tuple[str, str], int]]:
    """Halo-plane bytes of ONE `update_halo` call of `nfields` fields of
    `dtype` on `local_shape` blocks: ``(total, {(dim, mode): bytes})``,
    the accounting of the ``igg_halo_plane_bytes_total`` counter
    (:func:`igg_torch.halo.plane_bytes_by_mode`), so a counter delta
    equals this model exactly.  Modes are ``wire_grouped`` (the dim has
    several blocks) and ``local_grouped`` (one periodic block wraps onto
    itself)."""
    from . import halo

    g = grid if grid is not None else shared.global_grid()
    dt = _torch_dtype(dtype)
    by_mode = halo.plane_bytes_by_mode([tuple(local_shape)] * int(nfields),
                                       [dt] * int(nfields), g)
    return sum(by_mode.values()), by_mode


def _exchange_accounting(local_shape, dtype, nfields: int, grid) -> Dict:
    """Logical traffic of one grouped update per block (igg's accounting:
    4 planes per field per moving dim, 2 sent and 2 received), the bytes
    of it that cross a process boundary, and the serving path."""
    from . import halo

    local_shape = tuple(local_shape)
    itemsize = _torch_dtype(dtype).itemsize
    elems = 1
    for s in local_shape:
        elems *= int(s)
    moving = halo.moving_dims(halo.active_dims(local_shape, grid), grid)
    total = 0
    dims_label = ""
    for d, _ in moving:
        total += nfields * 4 * (elems // int(local_shape[d])) * itemsize
        dims_label += "xyz"[d] if d < 3 else str(d)
    # Every block of the port's grid lives in this process and its planes
    # move by device copies: no byte crosses a process boundary until the
    # torch.distributed backend (igg counts the dims of several devices).
    return {"bytes_per_update": total, "wire_bytes_per_update": 0,
            "moving_dims": [d for d, _ in moving],
            "dims_label": dims_label or "-", "path": "grouped"}


# ---------------------------------------------------------------------------
# The comm ledger and the link gauges
# ---------------------------------------------------------------------------

def record_exchange(sec_per_update: float, *, local_shape, dtype,
                    nfields: int = 1, source: str = "calibrate",
                    label: Optional[str] = None) -> Optional[Dict]:
    """Record one measured halo-exchange sample: a perf-ledger entry under
    family ``"comm"`` (tier ``halo.<set>.grouped``), the
    ``igg_halo_gbps{path=}`` gauge over the logical halo bytes, the
    ``igg_pct_link_peak{path=}`` gauge where the card has a published link
    peak AND bytes cross a process boundary (else omitted), and a
    ``comm_sample`` record.  Returns the sample dict, or None for an
    unusable measurement."""
    from . import perf

    try:
        sec = float(sec_per_update)
    except (TypeError, ValueError):
        return None
    if not (sec > 0):
        return None
    grid = shared.global_grid()
    acct = _exchange_accounting(local_shape, dtype, nfields, grid)
    ctx = perf.device_context()
    gbps = acct["bytes_per_update"] / sec / 1e9
    peak = link_peak_gbps(ctx.get("device_kind"))
    pct = None
    if peak and acct["wire_bytes_per_update"]:
        pct = 100.0 * (acct["wire_bytes_per_update"] / sec / 1e9) / peak
    tier = f"halo.{label or acct['dims_label']}.{acct['path']}"
    dtype_name = perf._dtype_name(_torch_dtype(dtype))
    perf.record("comm", tier, sec * 1e3, source=source,
                local_shape=tuple(local_shape), dtype=dtype_name,
                dims=tuple(grid.dims), backend=ctx.get("backend"),
                device_kind=ctx.get("device_kind"))
    _telemetry.gauge("igg_halo_gbps", path=acct["path"]).set(gbps)
    if pct is not None:
        _telemetry.gauge("igg_pct_link_peak", path=acct["path"]).set(pct)
    sample = {"tier": tier, "seconds_per_update": sec, "gbps": gbps,
              "bytes_per_update": acct["bytes_per_update"],
              "wire_bytes_per_update": acct["wire_bytes_per_update"],
              "link_peak_gbps": peak, "pct_link_peak": pct,
              "path": acct["path"], "nfields": int(nfields),
              "local_shape": list(local_shape), "dtype": dtype_name,
              "dims": list(grid.dims), "source": source, **ctx}
    _telemetry.emit("comm_sample", **sample)
    return sample


def _no_assembly(assembly, where: str) -> None:
    """igg's `assembly=` elects an XLA halo assembly; the port has none."""
    if assembly is not None:
        raise GridError(
            f"{where}: assembly={assembly!r}: the port has no XLA halo "
            f"assembly to elect; pass None (the halo writer's plain PyTorch "
            f"version is update_halo(plain=True)).")


def calibrate_comm(nfields: int = 1, dtype=torch.float32, *,
                   local_shape=None, n_inner: int = 10, nt: int = 4,
                   assembly=None, fields=None,
                   source: str = "calibrate") -> Optional[Dict]:
    """Slope-time a standalone halo-exchange program on the live grid:
    `n_inner` calls of :func:`igg_torch.update_halo` on `nfields` fresh
    grid arrays of `dtype` a step (igg's `zeros + i`), and record the
    sample through :func:`record_exchange`.  `local_shape` defaults to the
    grid's block; `fields` (grid arrays of one shape and dtype, updated in
    place) replaces the fresh arrays.  Returns the sample dict, or None
    when no dimension moves on this grid."""
    from . import fields as _fields
    from . import halo
    from .timing import time_steps

    shared.check_initialized()
    _no_assembly(assembly, "calibrate_comm")
    grid = shared.global_grid()
    if fields is not None:
        arrays = tuple(fields)
        local_shape = tuple(grid.local_shape(arrays[0]))
        dtype, nfields = arrays[0].dtype, len(arrays)
    else:
        local_shape = (tuple(local_shape) if local_shape is not None
                       else tuple(grid.nxyz))
        dtype, nfields = _torch_dtype(dtype), int(nfields)
    if not halo.moving_dims(halo.active_dims(local_shape, grid), grid):
        return None
    if fields is None:
        arrays = tuple(_fields.zeros(local_shape, dtype=dtype) + i
                       for i in range(nfields))

    def body(*fs):
        for _ in range(n_inner):
            halo.update_halo(*fs)
        return fs

    _, sec = time_steps(body, arrays, n1=max(1, nt), n2=3 * max(1, nt),
                        warmup=1)
    return record_exchange(sec / n_inner, local_shape=local_shape,
                           dtype=dtype, nfields=nfields, source=source)


# ---------------------------------------------------------------------------
# Step-time decomposition: compute only / plain exchange / hidden overlap
# ---------------------------------------------------------------------------

def model_step_variants(family: str, params=None) -> Dict:
    """A family's step-variant recipe (igg's): everything needed to build
    the compute-only, sequential and overlapped variants of one step.
    Returns a dict:

    - ``family``, ``params``: the family name and its Params;
    - ``nf`` / ``naux``: primary and read-only aux field counts (the state
      is the primaries, then the aux fields, `init()`'s order);
    - ``radius`` / ``ndim``: the `hide_communication` radius and the rank;
    - ``stagger``: per field, per dim size offsets over the block;
    - ``grid_kwargs``: extra `init_global_grid` arguments the family needs
      (Stokes' radius-2 chain needs overlap 3);
    - ``init(dtype)``: the family's `init_fields` on the live grid;
    - ``compute(*fields)``: the pure stencil (no halo), on stacked arrays;
    - ``local(*fields, overlap=False, assembly=None)``: the full step
      (compute and one grouped exchange, or the overlapped form).

    The coefficients read the live grid when a closure runs, so the recipe
    itself needs no grid."""
    if family == "diffusion3d":
        from .models import diffusion3d as m

        p = params if params is not None else m.Params()

        def kw():
            dx, dy, dz = p.spacing()
            return dict(dx=dx, dy=dy, dz=dz, dt=p.timestep(), lam=p.lam)

        def local(T, Cp, overlap=False, assembly=None):
            _no_assembly(assembly, "diffusion3d local")
            return m.local_step(T, Cp, **kw(), overlap=overlap)

        return dict(
            family=family, params=p, nf=1, naux=1, radius=1, ndim=3,
            stagger=((0, 0, 0), (0, 0, 0)), grid_kwargs={},
            init=lambda dtype=torch.float32: m.init_fields(p, dtype),
            compute=lambda T, Cp: m.compute_step(T, Cp, **kw()),
            local=local)
    if family == "stokes3d":
        from .models import stokes3d as m

        p = params if params is not None else m.Params()

        def local(P, Vx, Vy, Vz, Rho, overlap=False, assembly=None):
            _no_assembly(assembly, "stokes3d local")
            return m.local_iteration(P, Vx, Vy, Vz, Rho,
                                     **m._pseudo_steps(p), overlap=overlap)

        return dict(
            family=family, params=p, nf=4, naux=1, radius=2, ndim=3,
            stagger=((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                     (0, 0, 0)),
            grid_kwargs=dict(overlapx=3, overlapy=3, overlapz=3),
            init=lambda dtype=torch.float32: m.init_fields(p, dtype),
            compute=lambda P, Vx, Vy, Vz, Rho: m.compute_iteration(
                P, Vx, Vy, Vz, Rho, **m._pseudo_steps(p)),
            local=local)
    if family == "hm3d":
        from .models import hm3d as m

        p = params if params is not None else m.Params()

        def local(Pe, phi, overlap=False, assembly=None):
            _no_assembly(assembly, "hm3d local")
            return m.local_step(Pe, phi, **p.step_kwargs(), overlap=overlap)

        return dict(
            family=family, params=p, nf=2, naux=0, radius=1, ndim=3,
            stagger=((0, 0, 0), (0, 0, 0)), grid_kwargs={},
            init=lambda dtype=torch.float32: m.init_fields(p, dtype),
            compute=lambda Pe, phi: m.compute_step(Pe, phi,
                                                   **p.step_kwargs()),
            local=local)
    raise GridError(
        f"model_step_variants({family!r}): no step-variant recipe for "
        f"this family (known: diffusion3d, stokes3d, hm3d)")


def _build_variant(compute, nf: int, variant: str, reps: int, radius: int):
    """`run(*fields, *aux) -> fields`: `reps` iterations of the named
    variant on an `nf`-field state (aux fields read only).  Every variant
    returns new tensors: the arguments are never written."""
    from .halo import update_halo_local
    from .overlap import hide_communication

    def once(fs, ax):
        if variant == "compute":
            out = compute(*fs, *ax)
        elif variant == "exchange":
            out = compute(*fs, *ax)
            out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            update_halo_local(*out)
        elif variant == "hidden":
            out = hide_communication(fs[0] if nf == 1 else fs, compute, *ax,
                                     radius=radius)
        else:   # pragma: no cover - internal
            raise GridError(f"unknown variant {variant!r}")
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def run(*args):
        fs, ax = tuple(args[:nf]), tuple(args[nf:])
        for _ in range(reps):
            fs = once(fs, ax)
        return fs

    return run


_VARIANTS = ("compute", "exchange", "hidden")


def _fractions(times_ms: Dict[str, float]) -> Dict[str, float]:
    """Exposed-comm fraction and overlap efficiency from the three variant
    times (ms), clamped to their meaningful ranges (timer noise can invert
    orderings, and a fraction outside [0, 1] would only mislead)."""
    comp = times_ms["compute"]
    exch = times_ms["exchange"]
    hid = times_ms["hidden"]
    out = dict(compute_ms=comp, exchange_ms=exch, hidden_ms=hid)
    exposed = max(0.0, (exch - comp) / exch) if exch > 0 else 0.0
    out["exposed_comm_fraction"] = min(1.0, exposed)
    out["overlap_speedup"] = (exch / hid) if hid > 0 else 0.0
    if exch > comp:
        eff = (exch - hid) / (exch - comp)
        out["overlap_efficiency"] = max(0.0, min(1.0, eff))
    return out


def _as_fields(fields) -> tuple:
    return tuple(fields) if isinstance(fields, (tuple, list)) else (fields,)


def decompose(compute, fields, *, aux=(), radius: int = 1, assembly=None,
              nt: int = 4, n_inner: int = 5, record: bool = True,
              config: Optional[str] = None) -> Dict:
    """Step-time decomposition ahead of a run: slope-time the compute-only,
    compute + exchange and hidden-overlap variants of one step
    (:func:`igg_torch.time_steps`, `n_inner` iterations a call) on scratch
    copies of `fields` (`aux` read only) and emit one ``comm_stats``
    record (source ``"calibrate"``).  `compute` is a shift-invariant,
    shape-preserving stencil on stacked arrays, as
    :func:`igg_torch.hide_communication` requires.  With `record`, each
    variant lands in the comm ledger (tier ``overlap.<variant>``, or
    ``overlap.<config>.<variant>`` when `config` names the serving
    configuration, e.g. the autotuner's ``"<family>.overlap"``).  A
    variant that fails on CUDA tensors raises `GridError` naming it.
    Returns the times and fractions (:func:`_fractions`)."""
    from . import perf
    from .timing import time_steps

    shared.check_initialized()
    _no_assembly(assembly, "decompose")
    grid = shared.global_grid()
    fields = _as_fields(fields)
    aux = tuple(aux)
    nf = len(fields)
    times_ms: Dict[str, float] = {}
    for variant in _VARIANTS:
        fn = _build_variant(compute, nf, variant, n_inner, radius)

        def stepper(*args):
            return fn(*args) + tuple(args[nf:])

        try:
            _, sec = time_steps(stepper, tuple(f.clone() for f in fields)
                                + aux, n1=max(1, nt), n2=3 * max(1, nt),
                                warmup=1)
        except Exception as e:
            if fields[0].device.type != "cuda":
                raise
            raise GridError(
                f"decompose: the {variant!r} variant"
                f"{f' of {config}' if config else ''} failed on the card "
                f"({type(e).__name__}: {e}); a probe on the card never "
                f"gives way to another route") from e
        times_ms[variant] = sec / n_inner * 1e3
    out = _fractions(times_ms)
    ctx = perf.device_context()
    stem = f"overlap.{config}" if config else "overlap"
    if record:
        for variant, ms in times_ms.items():
            perf.record("comm", f"{stem}.{variant}", ms,
                        source="calibrate",
                        local_shape=tuple(grid.local_shape(fields[0])),
                        dtype=perf._dtype_name(fields[0].dtype),
                        dims=tuple(grid.dims), backend=ctx.get("backend"),
                        device_kind=ctx.get("device_kind"))
    _telemetry.gauge("igg_exposed_comm_fraction",
                     run="calibrate").set(out["exposed_comm_fraction"])
    extra = {"config": config} if config else {}
    _telemetry.emit("comm_stats", run="calibrate", source="calibrate",
                    n_inner=n_inner, **extra, **out)
    return out


class _Mark:
    """The end of one probe batch: on the card a timing `torch.cuda.Event`
    recorded on the caller's stream (`is_ready` is its `query()`, which
    any thread may call), on the CPU the host clock (work on CPU tensors
    has finished when the call returns)."""

    __slots__ = ("event", "t")

    def __init__(self, device: torch.device):
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(torch.cuda.current_stream(device))
            self.t = None
        else:
            self.event, self.t = None, time.monotonic()

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def seconds_to(self, later: "_Mark") -> float:
        """Seconds from this mark to `later` (both finished)."""
        if self.event is None:
            return later.t - self.t
        return self.event.elapsed_time(later.event) / 1e3


class StepDecomposition:
    """In-run step-time decomposition riding :func:`igg_torch.
    run_resilient`'s watch cadence (its ``comm=`` argument).

    The three variants of the step (compute only, compute + exchange,
    hidden overlap, built from the same `compute` the caller's step uses)
    run on scratch copies taken here, one variant per watch window, round
    robin.  A measurement is a pair of batches (`reps` and `2 reps`
    iterations) dispatched back to back, each followed by a mark
    (:class:`_Mark`): on the card the second batch's time is the elapsed
    time between the two timing events, read once the second reports
    ready through `resilience._is_ready` (the chaos-tappable readiness
    channel); the card runs the pair back to back, so the queue ahead of
    the pair cancels, as igg's slope over host poll times does, and
    nothing waits for the device.  On CPU tensors the host clock between
    the marks stands in; a delta under `_MIN_DT` is discarded and the
    variant retried.

    When all three variants have a time, one ``comm_stats`` record (source
    ``"probe"``) carries the times and fractions (:func:`_fractions`),
    attributed to the serving configuration (`config`, or the tiers of
    ``igg_torch.degrade.active()`` when the monitor is built), the
    ``igg_exposed_comm_fraction{run=}`` and ``igg_overlap_efficiency{run=}``
    gauges are set, and the rotation restarts.  Construction runs each
    pair once (set-up, where a wait is expected)."""

    _MIN_DT = 1e-4

    def __init__(self, compute, fields, *, aux=(), radius: int = 1,
                 assembly=None, reps: int = 4, run: str = "resilient",
                 config: Optional[str] = None):
        shared.check_initialized()
        _no_assembly(assembly, "StepDecomposition")
        if config is None:
            from . import degrade

            served = sorted(set(degrade.active().values()))
            config = ",".join(served) if served else None
        self.config = config
        fields = _as_fields(fields)
        self._aux = tuple(aux)
        self._nf = len(fields)
        self._reps = max(1, int(reps))
        self.run = run
        self._device = fields[0].device
        # Scratch copies: the caller's state is never touched.
        self._scratch = tuple(f.clone() for f in fields)
        self._progs = {
            v: (_build_variant(compute, self._nf, v, self._reps, radius),
                _build_variant(compute, self._nf, v, 2 * self._reps, radius))
            for v in _VARIANTS}
        args = self._scratch + self._aux
        for fn_a, fn_b in self._progs.values():
            fn_a(*args)
            fn_b(*args)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._i = 0                     # next variant index
        self._pending = None            # (variant, step, mark_a, mark_b)
        self._times_ms: Dict[str, float] = {}
        self.windows = 0                # comm_stats records emitted
        self._g_exposed = _telemetry.gauge("igg_exposed_comm_fraction",
                                           run=run)
        self._g_eff = _telemetry.gauge("igg_overlap_efficiency", run=run)

    @property
    def on_card(self) -> bool:
        """Whether the probes run on CUDA tensors (a failure there
        raises)."""
        return self._device.type == "cuda"

    # -- the run-loop surface ---------------------------------------------
    def maybe_dispatch(self, step: int, stall=None) -> bool:
        """Dispatch the next variant's pair of batches (one variant a
        watch window; skipped while a pair is in flight)."""
        if self._pending is not None:
            return False
        variant = _VARIANTS[self._i % len(_VARIANTS)]
        fn_a, fn_b = self._progs[variant]
        args = self._scratch + self._aux
        try:
            fn_a(*args)
            mark_a = _Mark(self._device)
            fn_b(*args)
            mark_b = _Mark(self._device)
        except Exception as e:
            if not self.on_card:
                raise
            raise GridError(
                f"StepDecomposition: the {variant!r} probe"
                f"{f' of {self.config}' if self.config else ''} failed on "
                f"the card at step {step} ({type(e).__name__}: {e})") from e
        self._pending = (variant, step, mark_a, mark_b)
        if stall is not None:
            stall.watch(("comm", variant, step), step,
                        f"comm decomposition probe ({variant})", mark_b)
        return True

    def poll(self, step: int, stall=None) -> Optional[Dict]:
        """Non-blocking readiness check (once a loop iteration); emits and
        returns the ``comm_stats`` dict when a rotation completes."""
        if self._pending is None:
            return None
        from .resilience import _is_ready

        variant, p_step, mark_a, mark_b = self._pending
        if not _is_ready(mark_b):
            return None
        if stall is not None:
            stall.fetched(("comm", variant, p_step), p_step)
        self._pending = None
        dt = mark_a.seconds_to(mark_b)
        if mark_a.event is None and dt < self._MIN_DT:
            return None   # under the host clock's resolution: retry
        self._times_ms[variant] = dt / (2 * self._reps) * 1e3
        self._i += 1
        if not all(v in self._times_ms for v in _VARIANTS):
            return None
        out = _fractions(self._times_ms)
        self._times_ms = {}
        self.windows += 1
        self._g_exposed.set(out["exposed_comm_fraction"])
        if "overlap_efficiency" in out:
            self._g_eff.set(out["overlap_efficiency"])
        extra = {"config": self.config} if self.config else {}
        _telemetry.emit("comm_stats", step=step, run=self.run,
                        source="probe", reps=self._reps, **extra, **out)
        return out

    def finalize(self, step: int, timeout_s: float = 10.0) -> None:
        """End-of-run drain: give the pair in flight a bounded window to
        finish (polling, never waiting on the device), so a short run's
        last rotation is not lost."""
        deadline = time.monotonic() + timeout_s
        while self._pending is not None and time.monotonic() < deadline:
            if self.poll(step) is not None:
                break
            time.sleep(0.002)


# ---------------------------------------------------------------------------
# Collective-stall detection
# ---------------------------------------------------------------------------

# The live watchdogs (the readiness source of the ops plane, ROADMAP Queue A
# item 10): each registers at construction and leaves on close(); a WeakSet,
# so an abandoned instance cannot pin a "stalled" verdict forever.
_live_lock = threading.Lock()
_LIVE_WATCHDOGS: "weakref.WeakSet" = weakref.WeakSet()


def active_stalls() -> List[dict]:
    """The stall episodes in progress across every live
    :class:`StallWatchdog` (fired and not yet drained): each the
    heartbeat's ``collective_stall`` payload with the step and wall time it
    fired at.  An episode leaves the list when its channel fully drains."""
    with _live_lock:
        dogs = list(_LIVE_WATCHDOGS)
    out = []
    for w in dogs:
        with w._lock:
            if w._stalled and w.stall_info is not None:
                out.append(dict(w.stall_info))
    return out


class StallWatchdog:
    """Host heartbeat thread that turns a hung exchange into an artifact
    (module docstring).  `watch(key, step, what, obj)` registers a probe in
    flight; `fetched(key, step)` retires it.  When the OLDEST one in flight
    is older than `timeout_s` and `obj` still reports not ready (through
    `igg_torch.resilience._is_ready`, the chaos-tappable readiness
    channel), the watchdog fires ONCE per episode:

    - a ``collective_stall`` record (step, what is in flight, age, the
      last completed step, the pending depth);
    - ``stall_r<rank>.json`` into every attached session and
      ``IGG_TELEMETRY_DIR``, written atomically;
    - a flight-recorder dump (reason ``collective_stall ...``).

    The episode ends, and detection re-arms, only when the channel fully
    drains.  Host bookkeeping only; the thread starts on the first `watch`
    and `close()` joins it.  Size the timeout above `max_pending_probes`
    watch windows: a probe legitimately waits that long before the loop
    reads it by force."""

    def __init__(self, timeout_s: float, *, run: str = "resilient",
                 poll_s: Optional[float] = None):
        self.timeout_s = float(timeout_s)
        self.run = run
        self._poll_s = (float(poll_s) if poll_s is not None
                        else min(1.0, max(0.005, self.timeout_s / 5.0)))
        self._lock = threading.Lock()
        self._inflight: Dict = {}          # key -> (step, what, obj, t0)
        self._last_completed: Optional[int] = None
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stalls = 0
        # The payload of the episode in progress, None once it drains.
        self.stall_info: Optional[dict] = None
        with _live_lock:
            _LIVE_WATCHDOGS.add(self)

    def watch(self, key, step: int, what: str, obj=None) -> None:
        with self._lock:
            self._inflight[key] = (int(step), str(what), obj,
                                   time.monotonic())
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name=f"igg-stall-{self.run}",
                    daemon=True)
                self._thread.start()

    def fetched(self, key, step: Optional[int] = None) -> None:
        with self._lock:
            self._inflight.pop(key, None)
            if step is not None:
                self._last_completed = (step if self._last_completed is None
                                        else max(self._last_completed, step))
            # An episode ends only when the channel fully drains: one fetch
            # while other over-age probes remain must not re-arm mid-drain
            # and report one stall twice.
            if not self._inflight:
                self._stalled = False
                self.stall_info = None

    def clear(self) -> None:
        """Forget every entry in flight (the loop's `pending.clear()` on a
        rollback); the next stall is a new episode."""
        with self._lock:
            self._inflight.clear()
            self._stalled = False
            self.stall_info = None

    @property
    def stalled(self) -> bool:
        """Whether an episode is in progress (fired, not yet drained)."""
        return self._stalled

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        with _live_lock:
            _LIVE_WATCHDOGS.discard(self)

    # -- the heartbeat -----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.check()
            except Exception:   # a broken probe must not kill the thread
                continue

    def check(self, now: Optional[float] = None) -> bool:
        """One heartbeat (callable from tests): fire when the oldest entry
        in flight is over age and not ready.  Returns whether it fired."""
        from .resilience import _is_ready

        now = time.monotonic() if now is None else now
        with self._lock:
            if self._stalled or not self._inflight:
                return False
            key = min(self._inflight, key=lambda k: self._inflight[k][3])
            step, what, obj, t0 = self._inflight[key]
            age = now - t0
            pending = len(self._inflight)
            last = self._last_completed
        if age <= self.timeout_s:
            return False
        if obj is not None and _is_ready(obj):
            return False   # ready but not yet read: a slow host, not a stall
        self._fire(step, what, age, pending, last)
        return True

    def _fire(self, step, what, age, pending, last_completed) -> None:
        payload = {"run": self.run, "in_flight": what,
                   "age_s": round(age, 3), "timeout_s": self.timeout_s,
                   "last_completed_step": last_completed,
                   "pending": pending}
        with self._lock:
            self._stalled = True
            self.stalls += 1
            self.stall_info = {"step": step, "wall": time.time(), **payload}
        _telemetry.emit("collective_stall", step=step, **payload)
        self._write_reports({"reason": "collective_stall", "step": step,
                             "wall": time.time(),
                             "process": _telemetry._process(), **payload})
        _telemetry._auto_dump(
            f"collective_stall: {what} dispatched at step {step} not ready "
            f"after {age:.1f}s (timeout {self.timeout_s:g}s)")

    @staticmethod
    def _write_reports(doc: dict) -> List[pathlib.Path]:
        """`stall_r<rank>.json` into every attached session directory and
        `IGG_TELEMETRY_DIR` (atomic; a failed write never masks the
        stall)."""
        rank = _telemetry._process()
        with _telemetry._lock:
            sessions = list(_telemetry._SESSIONS)
        targets = [s.dir / f"stall_r{rank}.json" for s in sessions]
        envdir = _env.text("IGG_TELEMETRY_DIR")
        if envdir:
            p = pathlib.Path(envdir) / f"stall_r{rank}.json"
            if p not in targets:
                targets.append(p)
        out = []
        for t in targets:
            try:
                t.parent.mkdir(parents=True, exist_ok=True)
                tmp = t.with_name(t.name + ".tmp")
                tmp.write_text(json.dumps(doc, default=str))
                os.replace(tmp, t)
                out.append(t)
            except OSError:
                continue
        return out


def make_stall_watchdog(run: str = "resilient") -> Optional[StallWatchdog]:
    """The run loop's factory: a :class:`StallWatchdog` honoring
    ``IGG_COMM_STALL_TIMEOUT`` (seconds, default 120; 0 disables and
    returns None)."""
    timeout = _env.number("IGG_COMM_STALL_TIMEOUT", 120.0)
    if timeout <= 0:
        return None
    return StallWatchdog(timeout, run=run)


# ---------------------------------------------------------------------------
# Per-rank skew
# ---------------------------------------------------------------------------

def rank_skew(records: Sequence[dict], *, publish: bool = False) -> Dict:
    """Worst against median window time per matching step across merged
    rank streams (:func:`igg_torch.telemetry.merge_streams` output): every
    step at which at least 2 ranks reported a ``step_stats`` window gives
    a row ``{step, ranks, median_ms, worst_ms, worst_rank, skew_ms}``.
    Returns ``{"per_step": [...], "max_skew_ms", "ranks"}`` and sets the
    ``igg_rank_skew_ms`` gauge to the maximum.  Window times are per-rank
    durations, so host clock offsets cannot skew this number.
    `publish=True` also emits a ``rank_skew`` record (the live straggler
    feed of a heal engine, ROADMAP Queue A item 9); off by default, since
    this is also the offline analysis of ``python -m igg_torch.comm
    report``."""
    by_step: Dict[int, Dict[int, float]] = {}
    ranks = set()
    for r in records:
        if not isinstance(r, dict) or r.get("kind") != "step_stats":
            continue
        step = r.get("step")
        payload = r.get("payload") or {}
        ms = payload.get("ms_per_step")
        if step is None or not isinstance(ms, (int, float)):
            continue
        p = int(r.get("process", 0))
        ranks.add(p)
        by_step.setdefault(int(step), {})[p] = float(ms)
    per_step = []
    max_skew = 0.0
    for step in sorted(by_step):
        window = by_step[step]
        if len(window) < 2:
            continue
        vals = sorted(window.values())
        k = len(vals)
        median = (vals[k // 2] if k % 2
                  else 0.5 * (vals[k // 2 - 1] + vals[k // 2]))
        worst_rank = max(window, key=window.get)
        worst = window[worst_rank]
        skew = worst - median
        max_skew = max(max_skew, skew)
        per_step.append({"step": step, "ranks": len(window),
                         "median_ms": median, "worst_ms": worst,
                         "worst_rank": worst_rank, "skew_ms": skew})
    if per_step:
        _telemetry.gauge("igg_rank_skew_ms").set(max_skew)
        if publish:
            worst = max(per_step, key=lambda r: r["skew_ms"])
            _telemetry.emit("rank_skew", step=worst["step"],
                            max_skew_ms=max_skew,
                            median_ms=worst["median_ms"],
                            worst_rank=worst["worst_rank"],
                            ranks=len(ranks))
    return {"per_step": per_step, "max_skew_ms": max_skew,
            "ranks": sorted(ranks)}


# ---------------------------------------------------------------------------
# CLI: python -m igg_torch.comm report
# ---------------------------------------------------------------------------

def _report(inputs: Sequence[str], ledger: Optional[str], out) -> int:
    from . import perf

    if ledger is not None:
        entries = [e for e in perf._read_ledger_file(ledger)
                   if e.get("family") == "comm"]
    else:
        entries = perf.query("comm")
    if entries:
        out.write(f"# comm ledger ({len(entries)} entr"
                  f"{'y' if len(entries) == 1 else 'ies'})\n")
        out.write(perf._format_entries(entries))
    else:
        out.write("# comm ledger: no 'comm' entries"
                  + (f" in {ledger}" if ledger else " in memory") + "\n")

    if not inputs:
        return 0
    records = _telemetry.merge_streams(inputs)

    stats = [r for r in records if r.get("kind") == "comm_stats"]
    out.write(f"\n# step-time decomposition ({len(stats)} window(s))\n")
    if stats:
        out.write(f"{'step':>8} {'rank':>4} {'source':>9} "
                  f"{'compute_ms':>11} {'exchange_ms':>12} "
                  f"{'hidden_ms':>10} {'exposed':>8} {'overlap_eff':>11}\n")
        for r in stats:
            p = r.get("payload") or {}
            eff = p.get("overlap_efficiency")
            out.write(
                f"{str(r.get('step', '-')):>8} {r.get('process', 0):>4} "
                f"{p.get('source', '-'):>9} "
                f"{p.get('compute_ms', 0.0):>11.4f} "
                f"{p.get('exchange_ms', 0.0):>12.4f} "
                f"{p.get('hidden_ms', 0.0):>10.4f} "
                f"{p.get('exposed_comm_fraction', 0.0):>8.3f} "
                f"{('-' if eff is None else format(eff, '.3f')):>11}\n")

    skew = rank_skew(records)
    out.write(f"\n# rank skew (worst-vs-median window time; "
              f"{len(skew['ranks'])} rank(s))\n")
    if skew["per_step"]:
        out.write(f"{'step':>8} {'ranks':>5} {'median_ms':>10} "
                  f"{'worst_ms':>9} {'worst_rank':>10} {'skew_ms':>8}\n")
        for row in skew["per_step"]:
            out.write(f"{row['step']:>8} {row['ranks']:>5} "
                      f"{row['median_ms']:>10.4f} {row['worst_ms']:>9.4f} "
                      f"{row['worst_rank']:>10} {row['skew_ms']:>8.4f}\n")
        out.write(f"max skew: {skew['max_skew_ms']:.4f} ms\n")
    else:
        out.write("single-rank stream (or no matching-step windows): "
                  "skew needs >= 2 ranks\n")

    stalls = [r for r in records if r.get("kind") == "collective_stall"]
    out.write(f"\n# collective stalls ({len(stalls)})\n")
    for r in stalls:
        p = r.get("payload") or {}
        out.write(f"step {r.get('step')}: {p.get('in_flight')} not ready "
                  f"after {p.get('age_s')}s (timeout {p.get('timeout_s')}s; "
                  f"last completed step {p.get('last_completed_step')}, "
                  f"{p.get('pending')} pending)\n")
    return 0


def _main(argv: Sequence[str]) -> int:
    import sys

    usage = ("usage: python -m igg_torch.comm report [--ledger "
             "<ledger.json>] [<events.jsonl|session-dir> ...]\n"
             "  report  render the comm ledger, the per-window step-time\n"
             "          decomposition, the per-rank skew table, and any\n"
             "          collective-stall events from session artifacts")
    argv = list(argv)
    if not argv or argv[0] != "report":
        print(usage, file=sys.stderr)
        return 2
    rest = argv[1:]
    ledger = None
    if "--ledger" in rest:
        i = rest.index("--ledger")
        if i + 1 >= len(rest):
            print(usage, file=sys.stderr)
            return 2
        ledger = rest[i + 1]
        del rest[i:i + 2]
    try:
        return _report(rest, ledger, sys.stdout)
    except GridError as e:
        print(f"igg_torch.comm report: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":   # python -m igg_torch.comm report ...
    import sys

    sys.exit(_main(sys.argv[1:]))
