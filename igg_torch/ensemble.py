"""Ensemble execution: M independent members of one model with per-member
fault isolation (the port of `igg/ensemble.py`).

The reference's headline workloads are parameter sweeps: many independent
simulations of one model, each too small to need the whole machine.
:func:`run_resilient` serves one simulation; :func:`run_ensemble` drives M
*members* and turns the watchdog, rollback and preemption machinery into
a verdict per member, so one diverging member never rolls back, stalls or
kills the batch.

**The member step.**  `step_fn` maps ONE member's state dict of
block-stacked grid tensors (the whole grid of that member, the field
model of :func:`igg_torch.save_checkpoint`) to a new dict with the same
keys; a per-member scalar (a swept parameter) is a 0-d tensor of the
dict.  On a stacked tensor :func:`igg_torch.update_halo_local` is
:func:`igg_torch.update_halo`, so igg's local-form member steps carry
over unchanged (e.g. :func:`igg_torch.models.diffusion3d.make_member_step`).
The step must return new tensors for what it changes: a step that writes
one of its input tensors in place, or returns one field's input tensor
under another field's name, raises `GridError` (a field passed through
unchanged under its own name is fine, as the heat capacity is).  These
checks run on each lane's first dispatch of a run; later dispatches call
`step_fn` bare, since a sweep is bound by the host's per-lane dispatch.

Where the port's route is not igg's, and why:

- **Packing.**  Every block of the port's grid lives on one device
  (`igg_torch.init`), so igg's batch packing (the member axis sharded over
  more than one device) never applies: `packing="auto"` gives "grid",
  `packing="batch"` raises igg's `GridError`, and `devices` may name only
  the grid's device.  A generation igg wrote under batch packing has the
  grid layout on disk, so it loads here.
- **No vmap.**  The kernels are ctypes launches, so the loop calls
  `step_fn` once per *stepping* lane, `steps_per_call` times a dispatch,
  where igg runs one vmapped program.  Frozen lanes (quarantined, or
  healthy during a catch-up replay) are not dispatched at all, which is
  igg's bit-exact freeze by construction, with no `where`-select.
- **Lanes.**  Between cadence points the members live as M separate state
  dicts; they are stacked only where igg's contract shows a stacked
  array: the probe matrix, a generation (block by block) and
  :attr:`EnsembleResult.state`.  A per-step copy into a stack would add a
  read and a write of every lane to each step.

**Per-member watchdog.**  Every `watch_every` steps one probe computes,
per watched field and lane, the non-finite count of
`resilience._nonfinite_count`, then the integrity rows
(:func:`igg_torch.integrity.member_invariant_rows`): one float32 matrix
of `n_fields + 2·n_inv` rows and M columns on the device, copied without
blocking into pinned memory behind one CUDA event, polled with
`resilience._is_ready` and read only once ready; `max_pending_probes`
bounds the queue.  The hot loop never synchronizes.  Quarantined lanes
are masked out of the verdict on the host.

**Per-member isolation.**  Generations are igg's: the grid fields written
member-axis-LAST (`(X, Y, Z, M)`) through
:func:`igg_torch.save_checkpoint_sharded`, each block stacked from its
lanes at its turn, plus the `ensemble.json` sidecar (format
`igg-ensemble-v1`: member count, retries, quarantine, the per-member
scalars as raw bytes); igg and the port read each other's.  Every
generation carries the per-field moment sums of its deep stamp, as igg's
do; the ensemble has no shadow and no deep scan.  On detection only the
diverged lanes are restored, from the newest generation whose lanes pass
the finite gate (after an ``integrity_violation``, the newest older than
the violating probe: the finite gate cannot see a finite corruption, and
a late-read probe's own step may hold it), and replayed to the front; a
member that exhausts its retries, or has no rollback target, is
quarantined (`member_quarantined`) instead of failing the batch.  Preemption (SIGTERM,
`resilience.request_preemption`) writes a final generation;
`resume=True` re-tiles it elastically onto the live grid with the
quarantine state of the sidecar.  The member-targeted injectors of
:mod:`igg_torch.chaos` drive every path.

`serve=` attaches the live ops endpoint (:mod:`igg_torch.statusd`), whose
readiness turns false when every member is quarantined.  Runs in one
process.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import pathlib
import signal
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import shared
from . import telemetry as _telemetry
from . import resilience as _resilience
from .resilience import (Event, ResilienceError, _is_ready, _Probe,
                         _watchable, clear_preemption, preemption_requested,
                         probe_counts, request_preemption)
from .shared import GridError

__all__ = ["run_ensemble", "EnsembleResult", "stack_members",
           "member_state"]

# Sidecar file inside a generation directory carrying the lane metadata.
# Written AFTER the generation commits; `load_checkpoint` ignores it, so
# the generation stays a plain igg-sharded-v1 artifact.
_SIDECAR = "ensemble.json"
_SIDECAR_FORMAT = "igg-ensemble-v1"


def _member_retries_default() -> int:
    from . import _env

    return int(_env.integer("IGG_ENSEMBLE_RETRIES", 2))


def _max_pending_default() -> int:
    from . import _env

    return int(_env.integer("IGG_ENSEMBLE_MAX_PENDING_PROBES", 4))


@dataclasses.dataclass
class EnsembleResult:
    """What :func:`run_ensemble` returns: the stacked `state` (leading
    member axis; :meth:`member_state` slices one lane), the member count,
    `steps_done` for the batch front, per-member `retries` consumed, the
    `quarantined` member indices, whether the run was `preempted`, the
    `events`, the `checkpoint` holding the returned state, and the
    `packing` that served the run (always "grid" in the port)."""
    state: Dict
    members: int
    steps_done: int
    retries: Dict[int, int]
    quarantined: List[int]
    preempted: bool
    events: List[Event]
    checkpoint: Optional[pathlib.Path]
    packing: str

    def member_state(self, m: int) -> Dict:
        return member_state(self.state, m)


def member_state(stacked: Dict, m: int) -> Dict:
    """Slice one member's state dict out of a stacked ensemble state."""
    return {k: v[m] for k, v in stacked.items()}


def _as_tensor(v) -> torch.Tensor:
    """A member value as a tensor: tensors as they are, anything else
    through numpy (a Python float is float64, as igg stacks it)."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v))


def _shape_dtype(a) -> str:
    return f"{tuple(a.shape)}/{str(a.dtype).replace('torch.', '')}"


def _check_members(states: Sequence[Dict]) -> List[str]:
    """igg's `stack_members` checks: one field model, one shape and dtype
    per field; returns the sorted keys."""
    if not states:
        raise GridError("stack_members: no member states given.")
    keys = sorted(states[0])
    for i, st in enumerate(states):
        if sorted(st) != keys:
            raise GridError(
                f"stack_members: member {i} has fields {sorted(st)}, "
                f"member 0 has {keys} — all members must share one field "
                f"model.")
    for k in keys:
        a0 = _as_tensor(states[0][k])
        for i, st in enumerate(states):
            a = _as_tensor(st[k])
            if a.shape != a0.shape or a.dtype != a0.dtype:
                raise GridError(
                    f"stack_members: field {k!r} of member {i} is "
                    f"{_shape_dtype(a)}, member 0 is {_shape_dtype(a0)}.")
    return keys


def stack_members(states: Sequence[Dict]) -> Dict:
    """Stack M member state dicts (same keys, shapes and dtypes) on a
    leading member axis; values may be tensors, numpy arrays or scalars
    (a scalar becomes an `(M,)` tensor)."""
    keys = _check_members(states)
    return {k: torch.stack([_as_tensor(st[k]) for st in states])
            for k in keys}


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def _choose_packing(grid, members: int, packing: str, devices) -> str:
    """igg's `_choose_packing` with the port's device list: `devices` is
    None or names only the grid's device, so batch packing (the member
    axis over more than one device) never applies."""
    from .device import same_device

    if devices is not None and any(not same_device(d, grid.device)
                                   for d in devices):
        raise GridError(
            f"run_ensemble: devices={list(devices)!r}: every block of the "
            f"grid lives on {grid.device}; the port packs members on that "
            f"device only.")
    if packing == "auto":
        packing = "grid"
    if packing == "batch":
        raise GridError(
            f"run_ensemble(packing='batch') needs a dims=(1,1,1) grid "
            f"(got dims={grid.dims}), more than one device, and a "
            f"member count divisible by the device count "
            f"({members} members over 1 device(s)).")
    if packing != "grid":
        raise GridError(f"run_ensemble: unknown packing {packing!r} "
                        f"(expected 'auto', 'grid', or 'batch').")
    return packing


# ---------------------------------------------------------------------------
# Generation layout: member-axis-last shards + the ensemble sidecar
# ---------------------------------------------------------------------------

def _encode_param(v: np.ndarray) -> dict:
    v = np.ascontiguousarray(v)
    return {"dtype": str(v.dtype), "shape": list(v.shape),
            "data": base64.b64encode(v.tobytes()).decode("ascii")}


def _decode_param(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["data"].encode("ascii"))
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def _write_sidecar(gen: pathlib.Path, meta: dict) -> None:
    from .checkpoint import _write_atomic_text

    _write_atomic_text(gen / _SIDECAR, json.dumps(meta))


def _read_sidecar(gen: pathlib.Path) -> Optional[dict]:
    try:
        meta = json.loads((gen / _SIDECAR).read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    if meta.get("format") != _SIDECAR_FORMAT:
        return None
    return meta


class _LaneStack:
    """One grid field of every lane, member-axis-LAST, as the sharded save
    sees it: a shape and dtype, and for a block's slices a callable that
    stacks the lanes' blocks on the device when the save reaches that
    block (`checkpoint._local_block_refs`).  The device holds one stacked
    block at a time, never a copy of the whole stack."""

    def __init__(self, lanes: Sequence[torch.Tensor]):
        self._lanes = list(lanes)
        self.dtype = self._lanes[0].dtype
        self.shape = torch.Size(tuple(self._lanes[0].shape)
                                + (len(self._lanes),))
        self.ndim = len(self.shape)

    def __getitem__(self, sl):
        return lambda: torch.stack([a[sl] for a in self._lanes], dim=-1)


def _save_generation(path: pathlib.Path, lanes: Sequence[Dict], grid_fields,
                     params, sidecar_meta: dict) -> pathlib.Path:
    """Write one ensemble generation: the grid fields member-axis-LAST
    through :func:`igg_torch.save_checkpoint_sharded` (block by block; the
    trailing member dim rides the format's rank-4+ support, elastic
    restore included), then the sidecar with the lane metadata and the
    raw-byte-encoded per-member scalars."""
    from . import checkpoint as ckpt

    ckpt.save_checkpoint_sharded(path, **{
        k: _LaneStack([lane[k] for lane in lanes]) for k in grid_fields})
    meta = dict(sidecar_meta)
    meta["format"] = _SIDECAR_FORMAT
    meta["params"] = {k: _encode_param(torch.stack(
        [lane[k] for lane in lanes]).cpu().numpy()) for k in params}
    _write_sidecar(path, meta)
    return path


def _state_from_loaded(loaded: Dict, meta: dict, gen, grid_fields, params,
                       which: Sequence[int], device) -> Dict[int, Dict]:
    """Lanes `which` of a raw `load_checkpoint` result (member-axis-LAST
    fields) and its sidecar, as `{member: lane dict}` of contiguous
    tensors on `device`."""
    missing = [k for k in grid_fields if k not in loaded]
    if missing:
        raise GridError(f"run_ensemble: generation {gen} is missing "
                        f"fields {missing}.")
    scalars = {}
    for k in params:
        enc = meta.get("params", {}).get(k)
        if enc is None:
            raise GridError(f"run_ensemble: generation {gen} sidecar has no "
                            f"parameter field {k!r}.")
        scalars[k] = torch.from_numpy(_decode_param(enc)).to(device)
    out = {}
    for m in which:
        lane = {k: loaded[k][..., m].contiguous() for k in grid_fields}
        lane.update({k: v[m] for k, v in scalars.items()})
        out[m] = lane
    return out


def _fields_finite(loaded: Dict, grid_fields, lanes) -> bool:
    """Whether the given member lanes of every grid field of a loaded
    generation are finite (the lane slice on the device, one flag read);
    a field that is not floating passes."""
    idx = torch.as_tensor(list(lanes), dtype=torch.long)
    for k in grid_fields:
        if k not in loaded:
            return False
        a = loaded[k]
        if not _watchable(a):
            continue
        if not bool(torch.isfinite(a.index_select(
                a.ndim - 1, idx.to(a.device))).all()):
            return False
    return True


def _lanes_finite(loaded: Dict, meta: dict, grid_fields, params,
                  lanes) -> bool:
    """Whether the given lanes of every field of a loaded generation are
    finite, the per-member scalars included (igg's per-member analog of
    `verify_checkpoint(check_finite=True)`: a generation whose
    QUARANTINED lanes hold NaNs still serves the other members)."""
    if not _fields_finite(loaded, grid_fields, lanes):
        return False
    lanes = np.asarray(list(lanes), dtype=np.int64)
    for k in params:
        enc = meta.get("params", {}).get(k)
        if enc is None:
            return False
        v = _decode_param(enc)
        if (np.issubdtype(v.dtype, np.floating)
                and not np.isfinite(v[lanes]).all()):
            return False
    return True


# ---------------------------------------------------------------------------
# The per-member probe
# ---------------------------------------------------------------------------

def probe_matrix(lanes: Sequence[Dict], watch, probe_fields, invariants,
                 grid) -> torch.Tensor:
    """The per-member watchdog probe (igg's `_build_probe`): a float32
    `(len(watch) + 2·n_inv, M)` matrix on the lanes' device, each watched
    field's non-finite count per lane, then each invariant's per-lane
    value and scale rows (:func:`igg_torch.integrity.
    member_invariant_rows` over `probe_fields`).  Nothing is read back."""
    rows = [probe_counts(*[lane[k] for lane in lanes]) for k in watch]
    if invariants:
        from . import integrity as _integrity

        rows += _integrity.member_invariant_rows(
            invariants, {f: [lane[f] for lane in lanes]
                         for f in probe_fields}, grid)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# The ensemble run loop
# ---------------------------------------------------------------------------

def _checked_step(step_fn, lane: Dict, keys) -> Dict:
    """`step_fn(lane)` held to the member-step contract: a dict with the
    lane's keys, no input tensor written in place, no field's input
    returned under another field's name."""
    ins = list(lane.values())
    versions = [getattr(t, "_version", None) for t in ins]
    new = step_fn(dict(lane))
    if not isinstance(new, dict) or new.keys() != lane.keys():
        raise GridError(
            f"run_ensemble: step_fn must map the member state dict "
            f"to a dict with the same fields {keys}; got "
            f"{sorted(new) if isinstance(new, dict) else type(new)}.")
    if [getattr(t, "_version", None) for t in ins] != versions:
        raise GridError(
            "run_ensemble: step_fn wrote one of its input tensors in "
            "place; a member step returns new tensors for the fields "
            "it changes (frozen lanes and generations hold the "
            "inputs).")
    owner = {id(t): k for k, t in lane.items()}
    for k, t in new.items():
        if owner.get(id(t), k) != k:
            raise GridError(
                f"run_ensemble: step_fn returned another field's input "
                f"tensor as {k!r}; return a new tensor.")
    return new


def _lanes_of(states, members, device):
    """`(lanes, members)`: the member state dicts of `states` (a list of
    member dicts, or a stacked dict with `members=M`) as M dicts of
    tensors on `device` (views of a stacked input; nothing is copied on
    the device)."""
    if isinstance(states, dict):
        if members is None:
            raise GridError("run_ensemble: a pre-stacked state dict needs "
                            "members=M.")
        stacked = {k: _as_tensor(states[k]) for k in sorted(states)}
        for k, v in stacked.items():
            if v.ndim < 1 or v.shape[0] != members:
                raise GridError(
                    f"run_ensemble: stacked field {k!r} has shape "
                    f"{tuple(v.shape)}; expected a leading member axis of "
                    f"{members}.")
        stacked = {k: v.to(device) for k, v in stacked.items()}
        lanes = [{k: v[m] for k, v in stacked.items()}
                 for m in range(members)]
    else:
        states = list(states)
        keys = _check_members(states)
        members = len(states)
        lanes = [{k: _as_tensor(st[k]).to(device) for k in keys}
                 for st in states]
    return lanes, members


def run_ensemble(step_fn: Callable[[Dict], Dict], states, n_steps: int, *,
                 members: Optional[int] = None,
                 watch_every: int = 50,
                 watch_fields: Optional[Sequence[str]] = None,
                 checkpoint_dir=None,
                 checkpoint_every: int = 0,
                 ring: int = 3,
                 prefix: str = "ens",
                 member_retries: Optional[int] = None,
                 resume: bool = False,
                 steps_per_call: int = 1,
                 max_pending_probes: Optional[int] = None,
                 packing: str = "auto",
                 devices=None,
                 install_sigterm: bool = True,
                 on_event: Optional[Callable[[Event], None]] = None,
                 telemetry=None,
                 serve=None,
                 integrity=None,
                 chaos=None) -> EnsembleResult:
    """Drive M independent members of `step_fn` for `n_steps` steps with
    per-member fault isolation (module docstring for the contract).

    - `step_fn`: the member step, one member's state dict to the next
      (e.g. :func:`igg_torch.models.diffusion3d.make_member_step`).
    - `states`: a list of M member state dicts (one field model), or a
      stacked dict of `(M,) + stacked_shape` arrays with `members=M`.
      Per-member fields are grid fields (rank >= 3) or scalars (a
      per-member parameter, carried through generations by the sidecar,
      bit-exact).
    - `watch_every`/`watch_fields`: the per-member watchdog cadence (0
      disables).  `checkpoint_every`/`checkpoint_dir`/`ring`/`prefix`: the
      generation ring (sharded directories).  `steps_per_call` steps per
      dispatch of a lane; cadences count steps and must be multiples of
      it.
    - `member_retries` (default `IGG_ENSEMBLE_RETRIES`, 2): per-member
      rollback budget; exhaustion quarantines the member (frozen lane,
      `member_quarantined`); a detection with no rollback target
      quarantines at once (reason `no_rollback_target`).
    - `packing`: "auto", "grid" or "batch"; `devices`: None or the grid's
      device (module docstring).
    - `resume=True` loads the newest generation whose active lanes are
      finite, elastically, with the sidecar's quarantine state.
    - `telemetry`: the :func:`igg_torch.run_resilient` contract; the
      `step_stats` records carry the member rates.
    - `integrity`: the :func:`igg_torch.run_resilient` contract (needs
      `watch_every` > 0); per-member invariant rows ride the probe, and a
      lane whose invariant drifts past tolerance is an
      ``integrity_violation`` attributed to the lane, rolled back or
      quarantined like a divergence.
    - `serve`: the live ops endpoint (:mod:`igg_torch.statusd`, the
      :func:`igg_torch.run_resilient` contract: None is
      ``IGG_STATUSD_PORT``-driven, an int port, True, a shared server, or
      False).  `/healthz` readiness turns false when EVERY member is
      quarantined.
    - `chaos`: an :class:`igg_torch.chaos.ChaosPlan`; member-targeted
      entries `(step, member, field)` poison one lane.

    Returns an :class:`EnsembleResult`.  Raises :class:`ResilienceError`
    only when EVERY member is quarantined."""
    from . import checkpoint as ckpt

    shared.check_initialized()
    grid = shared.global_grid()
    if ckpt._process_count() > 1:
        raise GridError(
            "run_ensemble: the ensemble tier is single-controller in this "
            "round (the fleet scheduler packs whole jobs, not processes); "
            "drive multi-controller meshes through igg.run_resilient.")

    lanes, members = _lanes_of(states, members, grid.device)
    if members < 1:
        raise GridError("run_ensemble: members must be >= 1.")
    keys = sorted(lanes[0])
    if not keys:
        raise GridError("run_ensemble: state must be a non-empty dict of "
                        "named member fields.")
    if steps_per_call < 1:
        raise GridError("run_ensemble: steps_per_call must be >= 1.")
    for nm, value in (("n_steps", n_steps), ("watch_every", watch_every),
                      ("checkpoint_every", checkpoint_every)):
        if value and value % steps_per_call != 0:
            raise GridError(
                f"run_ensemble: {nm}={value} is not a multiple of "
                f"steps_per_call={steps_per_call}.")
    if checkpoint_every and checkpoint_dir is None:
        raise GridError("run_ensemble: checkpoint_every > 0 requires "
                        "checkpoint_dir.")
    if resume and checkpoint_dir is None:
        raise GridError("run_ensemble: resume=True requires checkpoint_dir.")
    if ring < 1:
        raise GridError("run_ensemble: ring must be >= 1.")
    if member_retries is None:
        member_retries = _member_retries_default()
    if max_pending_probes is None:
        max_pending_probes = _max_pending_default()

    # The stacked rank of each field (the member axis included), igg's
    # field model: grid fields carry member lanes in the shard files,
    # scalar per-member parameters ride the sidecar.
    ndims = {k: lanes[0][k].ndim + 1 for k in keys}
    grid_fields = [k for k in keys if ndims[k] >= 4]
    params = [k for k in keys if ndims[k] == 1]
    odd = [k for k in keys if k not in grid_fields and k not in params]
    if odd and (checkpoint_dir is not None):
        raise GridError(
            f"run_ensemble: per-member fields must be rank-3+ grid fields "
            f"or scalars when checkpointing is enabled; {odd} are "
            f"{[ndims[k] - 1 for k in odd]}-D per member.")
    # Per-member scalars are watched only when named (a swept parameter is
    # not a health signal).
    watch = (list(watch_fields) if watch_fields is not None
             else [k for k in keys
                   if _watchable(lanes[0][k]) and ndims[k] >= 2])
    missing = [k for k in watch if k not in lanes[0]]
    if missing:
        raise GridError(f"run_ensemble: watch_fields {missing} not in "
                        f"state {keys}.")

    from . import integrity as _integrity

    int_cfg = _integrity.as_config(integrity)
    if int_cfg is not None and not (watch and watch_every):
        raise GridError(
            "run_ensemble: the integrity= probes ride the watch cadence; "
            "set watch_every > 0 (with watched fields).")
    invariants = ()
    memrefs = None
    if int_cfg is not None:
        if int_cfg.invariants is not None:
            invariants = tuple(int_cfg.invariants)
            bad_inv = [i.name for i in invariants
                       if not set(i.fields) <= set(keys)]
            if bad_inv:
                raise GridError(
                    f"run_ensemble: invariant(s) {bad_inv} name fields not "
                    f"in the member state {keys}.")
        else:
            invariants = _integrity.match_invariants(keys, grid)
        memrefs = _integrity.MemberRefs(invariants, members,
                                        int_cfg.resolved_tol())

    pk_name = _choose_packing(grid, members, packing, devices)

    cdir = (pathlib.Path(checkpoint_dir) if checkpoint_dir is not None
            else None)
    events: List[Event] = []

    def _emit(kind, step, **detail) -> Event:
        ev = Event(kind, step, detail)
        events.append(ev)
        _telemetry.emit(kind, step=step, run="ensemble", **detail)
        if on_event is not None:
            on_event(ev)
        return ev

    # The telemetry session is attached before the resume scan, so the
    # earliest events reach its sink.
    tel = _telemetry.as_session(telemetry)
    tel_owns = tel is not None and not tel.attached
    if tel_owns:
        tel.attach()
    # The live ops endpoint (igg_torch.statusd): the run_resilient
    # contract; a bind failure must not leak the run-owned session.
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
    _telemetry.emit("run_started", run="ensemble", n_steps=n_steps,
                    members=members, packing=pk_name,
                    watch_every=watch_every, steps_per_call=steps_per_call)
    if memrefs is not None:
        _telemetry.emit("integrity_config", run="ensemble",
                        invariants=[i.name for i in invariants],
                        members=members, tol=int_cfg.resolved_tol(),
                        check_every=0, deep_verify=False,
                        shadow="off")
    # The perf ledger's context is one lane's field: lanes are dispatched
    # one by one, so a lane is the served shape.
    from . import perf as _perf

    stats = _telemetry.StepStats(
        "ensemble", members=members,
        perf=(_perf.sample_context(lanes[0][watch[0]])
              if watch and _perf.enabled() else None))
    m_steps = _telemetry.counter("igg_steps_total", run="ensemble")
    m_member_steps = _telemetry.counter("igg_member_steps_total")
    m_rollbacks = _telemetry.counter("igg_rollbacks_total", run="ensemble")
    m_quarantined = _telemetry.counter("igg_member_quarantined_total")

    valid = np.ones(members, dtype=bool)       # not quarantined
    retries = {m: 0 for m in range(members)}

    def _generations():
        return (ckpt.list_generations(cdir, prefix)
                if cdir is not None else [])

    steps_done = 0
    resumed_step = None
    # Failures before the loop (the resume scan, the stale-ring sweep)
    # must not leak the run-owned session.
    try:
        if resume and cdir is not None:
            for s, p in reversed(_generations()):
                meta = _read_sidecar(p) if p.is_dir() else None
                if meta is None or int(meta.get("members", -1)) != members:
                    continue
                active = [m for m in range(members)
                          if m not in set(meta.get("quarantined", []))]
                try:
                    loaded = ckpt.load_checkpoint(p, redistribute=True)
                    # Only the active lanes gate: a quarantined lane's
                    # NaNs never reject the candidate.
                    if active and not _fields_finite(loaded, grid_fields,
                                                     active):
                        continue
                    cand = _state_from_loaded(loaded, meta, p, grid_fields,
                                              params, range(members),
                                              grid.device)
                except GridError:
                    continue
                del loaded
                lanes = [cand[m] for m in range(members)]
                steps_done = resumed_step = s
                for m in meta.get("quarantined", []):
                    valid[int(m)] = False
                for m, r in (meta.get("retries", {}) or {}).items():
                    retries[int(m)] = int(r)
                if steps_done % steps_per_call != 0:
                    raise GridError(
                        f"run_ensemble(resume=True): generation {p.name} "
                        f"is at step {steps_done}, not a multiple of "
                        f"steps_per_call={steps_per_call}.")
                _emit("resume", steps_done, path=str(p),
                      quarantined=sorted(int(m) for m in
                                         np.nonzero(~valid)[0]))
                break
            if resumed_step is None:
                # The scan matched nothing: the run starts fresh at step 0
                # and, like a fresh run, owns its ring (stale high-step
                # generations would win every prune and serve no
                # rollback).
                for _, old in _generations():
                    ckpt.remove_generation(old)
        probe_fields = list(dict.fromkeys(list(watch) + [
            f for inv in invariants for f in inv.fields if f not in watch]))
        probing = bool(watch and watch_every)
    except BaseException as e:
        _telemetry._auto_dump(f"run_ensemble: {type(e).__name__}: {e}")
        if srv_owns:
            srv.stop()
        if tel_owns:
            tel.detach()
        raise

    pending: deque = deque()       # (probe step, _Probe, accountable lanes)
    last_good = steps_done         # newest step probe-confirmed for all active
    last_ckpt: Optional[pathlib.Path] = None
    last_ckpt_step = -1
    # Set when a lane restore makes the live state diverge from the newest
    # generation's data: the final or preemption write must then REWRITE
    # the generation (`result.checkpoint` holds the returned state).
    gen_stale = False
    preempted = False

    def _sidecar_meta(step):
        return {"members": members, "step": int(step),
                "quarantined": sorted(int(m) for m in np.nonzero(~valid)[0]),
                "retries": {str(m): int(r) for m, r in retries.items()
                            if r}}

    def _gen_path(step) -> pathlib.Path:
        return cdir / f"{prefix}_{step:09d}"

    def _save_gen(step) -> None:
        nonlocal last_ckpt, last_ckpt_step, gen_stale
        with _telemetry.span("checkpoint.generation", step=step,
                             path=str(_gen_path(step)), run="ensemble"):
            p = _save_generation(_gen_path(step), lanes, grid_fields,
                                 params, _sidecar_meta(step))
        ckpt.prune_generations(cdir, prefix, ring, last_good)
        if step >= last_ckpt_step:
            last_ckpt, last_ckpt_step = p, step
        gen_stale = False
        _emit("checkpoint", step, path=str(p))

    def _reseal(gen: pathlib.Path) -> None:
        """Re-write a generation's sidecar with the live lane metadata."""
        old = _read_sidecar(gen) or {}
        _write_sidecar(gen, {**_sidecar_meta(steps_done),
                             "format": _SIDECAR_FORMAT,
                             "params": old.get("params", {})})

    # Lanes whose step has passed `_checked_step` in this run: the checks
    # cost host time on the dispatch path that bounds a sweep
    # (`chip_smoke.py` phase 28 (a) times them), so each lane's first
    # dispatch is checked and the rest call step_fn bare.
    checked = np.zeros(members, dtype=bool)

    def _dispatch(stepping: np.ndarray) -> None:
        for m in np.nonzero(stepping)[0]:
            lane = lanes[m]
            for _ in range(steps_per_call):
                if checked[m]:
                    lane = step_fn(lane)
                else:
                    lane = _checked_step(step_fn, lane, keys)
                    checked[m] = True
            lanes[m] = lane

    def _enqueue_probe(step, verdict_lanes: np.ndarray) -> None:
        pending.append((step, _Probe(probe_matrix(
            lanes, watch, probe_fields, invariants, grid)),
            np.array(verdict_lanes)))

    def _poll_probes(drain: bool = False) -> Optional[Event]:
        """Read finished probes oldest first; the verdict is masked to
        the lanes the probe was accountable for (quarantined lanes hold
        NaNs by design and must not re-trigger)."""
        nonlocal last_good
        while pending:
            step_p, pr, accountable = pending[0]
            if (not drain and len(pending) <= max_pending_probes
                    and not _is_ready(pr)):
                return None
            pending.popleft()
            host = pr.result()        # (n_fields [+ 2·n_inv], M)
            accountable = accountable & valid   # quarantines since enqueue
            nf = host[:len(watch)]
            bad_members = sorted(
                int(m) for m in range(members)
                if accountable[m] and nf[:, m].sum() != 0)
            if bad_members:
                bad = {f: {int(m): int(nf[i, m]) for m in bad_members
                           if nf[i, m]}
                       for i, f in enumerate(watch)
                       if any(nf[i, m] for m in bad_members)}
                pending.clear()
                return _emit("member_diverged", step_p,
                             members=bad_members, counts=bad)
            if memrefs is not None:
                # A lane whose invariant moved past tolerance while staying
                # finite: rides the same rollback and quarantine path.
                bad_inv = memrefs.check(host[len(watch):], accountable)
                if bad_inv:
                    pending.clear()
                    return _emit(
                        "integrity_violation", step_p, source="invariant",
                        members=sorted(bad_inv),
                        invariants={str(m): v
                                    for m, v in sorted(bad_inv.items())})
            if np.array_equal(accountable, valid):
                # Confirmed for every active lane: the generation at (or
                # newest below) this step is a protected rollback target.
                last_good = max(last_good, step_p)
            stats.fetched(step_p, pos, active_members=int(accountable.sum()))
        return None

    def _quarantine(ms, step, reason) -> None:
        for m in ms:
            if valid[m]:
                valid[m] = False
                m_quarantined.inc()
                _emit("member_quarantined", step, member=int(m),
                      reason=reason, retries=int(retries[m]))
        if not valid.any():
            raise ResilienceError(
                f"run_ensemble: every member is quarantined (last at step "
                f"{step}, reason {reason!r}) — no batch left to serve.",
                events)

    def _find_lane_target(max_step: int, which) -> Optional[tuple]:
        """Newest generation at or below `max_step` whose lanes `which`
        are finite; each candidate is read once (elastically: after an
        elastic resume the ring still holds the old decomposition's
        generations) and returned for the restore: `(step, path, loaded,
        meta)`.  The finite gate is the only one: a finitely corrupted
        lane passes it."""
        for s, p in reversed(_generations()):
            if s > max_step or not p.is_dir():
                continue
            meta = _read_sidecar(p)
            if meta is None or int(meta.get("members", -1)) != members:
                continue
            try:
                loaded = ckpt.load_checkpoint(p, redistribute=True)
            except GridError:
                continue
            if _lanes_finite(loaded, meta, grid_fields, params, which):
                return s, p, loaded, meta
        return None

    def _handle_failure(ev: Event, carry: Optional[List[int]] = None):
        """Per-member rollback: restore ONLY the failing lanes (and a
        cohort mid-replay, `carry`, so the whole cohort replays from one
        step) from the newest lane-healthy generation; returns the
        catch-up cohort `(members, from_step)`, or None when every failing
        member was quarantined instead."""
        nonlocal gen_stale
        F = [m for m in ev.detail["members"] if valid[m]]
        if not F and not carry:
            return None
        exhausted = []
        for m in F:
            retries[m] += 1
            if retries[m] > member_retries:
                exhausted.append(m)
        _quarantine(exhausted, ev.step, reason="retry_budget")
        which = sorted({m for m in F + list(carry or []) if valid[m]})
        if not which:
            return None
        if cdir is None:
            _quarantine(which, ev.step, reason="no_rollback_target")
            return None
        # Probes are read late, so a cadence generation at a violating
        # probe's step may already hold the corrupted (finite) lane: only
        # older generations are candidates, as in run_resilient.  A NaN's
        # generation at its step fails the finite gate.
        target = _find_lane_target(
            ev.step - 1 if ev.kind == "integrity_violation" else ev.step,
            which)
        if target is None:
            _quarantine(which, ev.step, reason="no_rollback_target")
            return None
        s0, gen, loaded, meta = target
        pending.clear()
        m_rollbacks.inc()
        with _telemetry.span("ensemble.member_rollback", step=ev.step,
                             target_step=s0, lanes=len(which)):
            gen_stale = True   # the newest generation no longer matches
            restored = _state_from_loaded(loaded, meta, gen, grid_fields,
                                          params, which, grid.device)
            for m, lane in restored.items():
                lanes[m] = lane
        _emit("member_rollback", s0, members=which, from_step=ev.step,
              path=str(gen),
              attempts={str(m): int(retries[m]) for m in which})
        return which, s0

    def _lane_view() -> Dict:
        """The ensemble state in lane form for the chaos seams: each
        field as the list of its lane tensors."""
        return {k: [lane[k] for lane in lanes] for k in keys}

    def _adopt(view: Dict) -> None:
        """Take the lanes an injector replaced (lane form)."""
        for k, seq in view.items():
            for m, t in enumerate(seq):
                if t is not lanes[m][k]:
                    lanes[m][k] = t

    installed = False
    old_handler = None
    if install_sigterm:
        try:
            old_handler = signal.signal(signal.SIGTERM, request_preemption)
            installed = True
        except ValueError:
            pass   # not on the main thread: the caller wires signals

    pos = steps_done                     # the replaying cohort's step
    try:
        if cdir is not None and not resume:
            for _, old in _generations():
                ckpt.remove_generation(old)
        if checkpoint_every and steps_done != resumed_step:
            _save_gen(steps_done)

        cohort: Optional[List[int]] = None   # members replaying to the front

        def _stepping():
            if cohort is not None:
                sel = np.zeros(members, dtype=bool)
                sel[[m for m in cohort if valid[m]]] = True
                return sel
            return valid.copy()

        while True:
            in_catchup = cohort is not None
            front_done = (not in_catchup) and steps_done >= n_steps
            if front_done or (preemption_requested() and not in_catchup):
                # Tail window: probe the final partial window, drain, and
                # isolate any straggler blowup before finishing.
                if (probing and pos % watch_every != 0 and valid.any()):
                    _enqueue_probe(pos, _stepping())
                fail = _poll_probes(drain=True)
                if fail is not None:
                    got = _handle_failure(fail, carry=cohort)
                    if fail.kind == "integrity_violation":
                        _emit("integrity_resolved", fail.step,
                              members=fail.detail.get("members"),
                              rolled_back=got is not None)
                    cohort, pos = got if got is not None else (
                        None, steps_done)
                    continue
                if preemption_requested() and not front_done:
                    preempted = True
                break

            state_tap = _resilience._CHAOS_STATE_TAP
            if state_tap is not None:
                # Silent corruption (chaos.silent_corruption with
                # member=): one lane perturbed finitely.
                view = _lane_view()
                poisoned = state_tap(view, pos, _emit, steps_per_call)
                if poisoned is not view:
                    _adopt(poisoned)
            if chaos is not None:
                view = _lane_view()
                poisoned = chaos.apply(view, pos, _emit,
                                       span=steps_per_call)
                if poisoned is not view:
                    _adopt(poisoned)
                # Honor a (possibly injected) preemption before the next
                # dispatch, but only outside a catch-up replay: the
                # cohort must reach the front first.
                if preemption_requested() and not in_catchup:
                    continue

            stepping = _stepping()
            _dispatch(stepping)
            pos += steps_per_call
            m_member_steps.inc(steps_per_call * int(stepping.sum()))
            if not in_catchup:
                steps_done = pos
                m_steps.inc(steps_per_call)

            if probing and pos % watch_every == 0:
                _enqueue_probe(pos, stepping)
            if tel is not None:
                tel.maybe_export_metrics()
            fail = _poll_probes()
            if fail is not None:
                got = _handle_failure(fail, carry=cohort)
                if fail.kind == "integrity_violation":
                    _emit("integrity_resolved", fail.step,
                          members=fail.detail.get("members"),
                          rolled_back=got is not None)
                # None: every failing lane quarantined, and any surviving
                # cohort lane was re-restored, so no lane is mid-replay.
                cohort, pos = got if got is not None else (None, steps_done)
                continue

            if in_catchup and pos >= steps_done:
                cohort, pos = None, steps_done
                continue

            if (not in_catchup and checkpoint_every
                    and pos % checkpoint_every == 0):
                _save_gen(pos)

        if preempted:
            if cdir is not None:
                if last_ckpt_step == steps_done and not gen_stale:
                    # Re-seal the lane metadata: quarantines since the
                    # cadence write must survive the relaunch.
                    _reseal(last_ckpt)
                else:
                    _save_gen(steps_done)
            _emit("preempt", steps_done,
                  path=str(last_ckpt) if last_ckpt else None)
            _telemetry._auto_dump(f"preempt at step {steps_done}")
        elif checkpoint_every and (steps_done % checkpoint_every != 0
                                   or gen_stale):
            # Off-cadence front, or a tail rollback replayed past the
            # cadence write at this step: (re)write the generation.
            _save_gen(steps_done)
        elif last_ckpt is not None:
            # A quarantine at the tail probe post-dates the last cadence
            # write: re-seal so a resume masks the lane.
            _reseal(last_ckpt)
    except BaseException as e:
        paths = _telemetry._auto_dump(f"run_ensemble: "
                                      f"{type(e).__name__}: {e}")
        if isinstance(e, ResilienceError):
            e.dump_paths.extend(p for p in paths if p not in e.dump_paths)
        raise
    finally:
        if installed:
            signal.signal(signal.SIGTERM, old_handler)
            # Only the owner of the handler clears the shared flag (a
            # scheduler that wired the signal must still see it).
            clear_preemption()
        _telemetry.emit("run_finished", step=steps_done, run="ensemble",
                        preempted=preempted,
                        quarantined=sorted(int(m)
                                           for m in np.nonzero(~valid)[0]))
        if srv_owns:
            srv.stop()
        if tel is not None:
            if tel_owns:
                tel.detach()
            else:
                tel.export_metrics()

    return EnsembleResult(
        state={k: torch.stack([lane[k] for lane in lanes]) for k in keys},
        members=members, steps_done=steps_done,
        retries={m: r for m, r in retries.items() if r},
        quarantined=sorted(int(m) for m in np.nonzero(~valid)[0]),
        preempted=preempted, events=events, checkpoint=last_ckpt,
        packing=pk_name)
