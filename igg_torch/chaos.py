"""Deterministic fault injection for :mod:`igg_torch.resilience` (the port
of the parts of `igg/chaos.py` the ported layers use).

Every detection and recovery path of the resilient loop is shown, not
argued, by injectors that are deterministic and, for the in-loop ones,
one-shot, so a rolled-back replay passes the same step clean:

- :class:`ChaosPlan`: NaN written into a named field at step k, a
  simulated preemption (the flag SIGTERM sets) at step k, and a wedge of
  the loop's thread for some seconds at step k; consumed by
  ``run_resilient(..., chaos=plan)``.
- :func:`corrupt_checkpoint`: damage a checkpoint on disk.  A flat
  `.npz`: `truncate` (a writer that died mid-file) or `bitflip` (one
  payload byte flipped with the zip container rewritten consistently, so
  only the CRC32 manifest can catch it).  A sharded generation directory:
  the same two on one shard, and `missing_shard`, `partial_commit` (no
  manifest) and `preempt_mid_write` (no manifest, back under its `.tmp`
  staging name).  `verify_checkpoint` and `latest_checkpoint` must skip
  every one.
- :func:`poison_checkpoint`: finite corruption written consistently
  through the CRC layer; only `verify_checkpoint(deep=True)` refuses it.
- :func:`silent_corruption`: one element of a live field inside one
  block perturbed by a finite amount at a step, through the
  `igg_torch.resilience._CHAOS_STATE_TAP` seam: the fault the NaN
  watchdog cannot see, which :mod:`igg_torch.integrity` must.
- :func:`halo_corruption`: every received halo plane replaced through
  the `igg_torch.halo._CHAOS_PLANE_TAP` seam (the planes
  `exchange_planes` returns).  The tap is read at every call, so arming
  clears no cache; a recovery policy that calls ``disarm()`` models a
  transient fault that heals on retry.
- :func:`kernel_compile_fail` / :func:`kernel_corrupt`: the tier
  ladder's failure shapes, through `igg_torch.degrade._CHAOS_TIER_TAP`:
  the build of a named tier raises `InjectedCompileError`, or every
  dispatch of the tier perturbs one interior output element (a
  deterministic miscompile, which rollback cannot heal).
- :func:`stale_calibration`: a wrong cost-model prediction for a family
  in the perf ledger (`igg_torch.perf.predict`), so the next measured
  sample fires ``cost_model_drift``.
- :func:`collective_stall` / :func:`straggler`: the watchdog's readiness
  channel (`igg_torch.resilience._CHAOS_FETCH_TAP`, read at every
  readiness poll) reports not ready while armed, or grants readiness at
  most once per window: a hung exchange, which the stall heartbeat
  (`igg_torch.comm.StallWatchdog`) must report, and a slow rank, whose
  inflated `step_stats` windows show it.

Every injector is a context manager that disarms on the way out, also
when the body raises; :func:`armed` composes several.  Not ported yet
(ROADMAP Queue A): `throughput_collapse`, `scheduler_fault` and
`job_preempt_at` (item 8, fleet), `arrival_storm` and
`malformed_submission` (item 11, service), and the member-targeted
shapes of ensembles (item 7): ChaosPlan's member `nan_at` entries and
`silent_corruption(member=)`.

This is a test surface: nothing here is imported by the port's hot paths.
"""

from __future__ import annotations

import contextlib
import pathlib
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np

from .shared import GridError

__all__ = ["ChaosPlan", "corrupt_checkpoint", "poison_checkpoint",
           "silent_corruption", "SilentCorruption", "halo_corruption", "HaloCorruption", "kernel_compile_fail",
           "kernel_corrupt", "KernelChaos", "stale_calibration",
           "StaleCalibration", "collective_stall", "FetchStall",
           "straggler", "FetchDelay", "armed"]


class ChaosPlan:
    """Deterministic in-loop fault plan for
    :func:`igg_torch.run_resilient`.

    `nan_at`: `(step, field)` or `(step, field, index)` entries: before
    the dispatch that advances past `step`, write NaN into `state[field]`
    at `index` (default `(1, 1, ...)`, an interior cell of the first block:
    a halo cell would be healed by the next exchange).  igg's
    member-targeted entries `(step, member, field[, index])` raise
    `GridError` until the port has ensembles.
    `preempt_at`: request preemption when the loop reaches that step.
    `hold_at`: `(step, seconds)` entries: hold the loop's thread that long
    at the dispatch boundary (a `chaos_hold` event).
    Each injection fires once; `reset()` re-arms them."""

    def __init__(self, nan_at: Sequence = (),
                 preempt_at: Optional[int] = None,
                 hold_at: Sequence = ()):
        entries = []
        for e in nan_at:
            if len(e) >= 2 and isinstance(e[1], (int, np.integer)):
                if len(e) < 3 or not isinstance(e[2], str):
                    raise GridError(
                        f"ChaosPlan: member-targeted nan_at entry {e!r} "
                        f"must be (step, member, field) or "
                        f"(step, member, field, index).")
                raise GridError(
                    f"ChaosPlan: member-targeted nan_at entry {e!r}: the "
                    f"port has no ensembles yet (ROADMAP Queue A item 7).")
            entries.append((int(e[0]), None, e[1],
                            tuple(e[2]) if len(e) > 2 and e[2] is not None
                            else None))
        self.nan_at: Tuple = tuple(entries)
        self.preempt_at = preempt_at
        holds = []
        for h in hold_at:
            if len(h) != 2 or float(h[1]) < 0:
                raise GridError(
                    f"ChaosPlan: hold_at entry {h!r} must be "
                    f"(step, seconds >= 0).")
            holds.append((int(h[0]), float(h[1])))
        self.hold_at: Tuple = tuple(holds)
        self._fired = set()

    def reset(self) -> None:
        self._fired.clear()

    def apply(self, state: dict, step: int, emit, span: int = 1) -> dict:
        """Called by the loop before each dispatch with the state and the
        step count; returns the (possibly corrupted) state.  An injection
        step anywhere in the coming dispatch window `[step, step + span)`
        fires at this boundary; `emit(kind, step, **detail)` logs it."""
        for k, member, field, index in self.nan_at:
            key = ("nan", k, member, field, index)
            if step <= k < step + span and key not in self._fired:
                self._fired.add(key)
                if field not in state:
                    raise GridError(f"ChaosPlan: field {field!r} not in "
                                    f"state {sorted(state)}.")
                state = dict(state)
                state[field] = _poison(state[field], index)
                emit("chaos_nan", step, field=field)
        for k, seconds in self.hold_at:
            key = ("hold", k)
            if step <= k < step + span and key not in self._fired:
                self._fired.add(key)
                emit("chaos_hold", step, seconds=seconds)
                import time

                time.sleep(seconds)
        if (self.preempt_at is not None
                and step <= self.preempt_at < step + span
                and ("preempt", self.preempt_at) not in self._fired):
            self._fired.add(("preempt", self.preempt_at))
            emit("chaos_preempt", step)
            from .resilience import request_preemption

            request_preemption()
        return state


def _poison(A, index=None):
    """A copy of grid tensor `A` with NaN in one element (`index`, default
    `(1, 1, ...)`); `A` itself is left as it was."""
    if not (A.is_floating_point() or A.is_complex()):
        raise GridError(f"ChaosPlan: cannot seed NaN into dtype "
                        f"{str(A.dtype).replace('torch.', '')}.")
    idx = (tuple(index) if index is not None
           else tuple(min(1, s - 1) for s in A.shape))
    out = A.clone()
    out[idx] = float("nan")
    return out


def corrupt_checkpoint(path, mode: str = "truncate", *,
                       field: Optional[str] = None, seed: int = 0,
                       shard: int = 0) -> None:
    """Damage a checkpoint in place, deterministically: a flat `.npz` file
    or a sharded generation directory (detected).

    `mode="truncate"` cuts the file to half its bytes; `mode="bitflip"`
    XORs one byte of one array's payload (`field`, default the first
    array by name; `seed` picks the byte) and rewrites the zip container
    consistently, so only the CRC32 manifest can catch it.  On a
    directory these hit `shard_<shard>.npz`, and three more modes apply:
    `missing_shard` deletes that shard, `partial_commit` the manifest, and
    `preempt_mid_write` also renames the directory back to its `.tmp`
    staging name (igg's `corrupt_checkpoint`)."""
    path = pathlib.Path(path)
    if path.is_dir():
        return _corrupt_sharded(path, mode, field=field, seed=seed,
                                shard=shard)
    if mode in ("missing_shard", "partial_commit", "preempt_mid_write"):
        raise GridError(f"corrupt_checkpoint: mode {mode!r} applies to "
                        f"sharded generation directories; {path} is a flat "
                        f"file.")
    if mode == "truncate":
        data = path.read_bytes()
        path.write_bytes(data[:max(1, len(data) // 2)])
        return
    if mode != "bitflip":
        raise GridError(f"corrupt_checkpoint: unknown mode {mode!r} "
                        f"(expected 'truncate' or 'bitflip').")
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    victims = sorted(n for n in entries if n != "__igg_meta__.npy")
    name = (f"{field}.npy" if field is not None else victims[0])
    if name not in entries:
        raise GridError(f"corrupt_checkpoint: no member {name!r} in {path} "
                        f"(has {sorted(entries)}).")
    buf = bytearray(entries[name])
    # A byte of the data, past the npy header, so the descriptor parses.
    lo = min(128, len(buf) - 1)
    span = max(1, len(buf) - lo)
    pos = min(len(buf) - 1,
              lo + int(np.random.default_rng(seed).integers(0, span)))
    buf[pos] ^= 0x01
    entries[name] = bytes(buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for n, data in entries.items():
            zf.writestr(n, data)


def _corrupt_sharded(path: pathlib.Path, mode: str, *, field, seed,
                     shard: int) -> None:
    """Directory branch of :func:`corrupt_checkpoint`."""
    from .checkpoint import _MANIFEST, _shard_name

    if mode == "partial_commit":
        (path / _MANIFEST).unlink()
        return
    if mode == "preempt_mid_write":
        (path / _MANIFEST).unlink()
        path.rename(path.with_name(path.name + ".tmp"))
        return
    sp = path / _shard_name(shard)
    if not sp.exists():
        raise GridError(f"corrupt_checkpoint: generation {path} has no "
                        f"{sp.name}.")
    if mode == "missing_shard":
        sp.unlink()
        return
    if mode not in ("truncate", "bitflip"):
        raise GridError(f"corrupt_checkpoint: unknown mode {mode!r} "
                        f"(expected 'truncate', 'bitflip', 'missing_shard', "
                        f"'partial_commit', or 'preempt_mid_write').")
    corrupt_checkpoint(sp, mode, field=field, seed=seed)


def poison_checkpoint(path, *, field: Optional[str] = None,
                      magnitude: float = 1.0, seed: int = 0,
                      shard: int = 0) -> None:
    """Poison a checkpoint with finite corruption written consistently
    through the CRC layer: one owned element of one array (`field`,
    default the first by name; `seed` picks it) changes by `magnitude` in
    its own dtype, its CRC32 (and on a sharded generation the manifest's
    shard summary) is rewritten, the deep stamps are left alone.
    Structural verification and `check_finite` pass; only
    `verify_checkpoint(deep=True)` refuses it (igg's
    `poison_checkpoint`)."""
    import json

    from .checkpoint import (_MANIFEST, _shard_name, _summary_crc,
                             _write_atomic_text)

    path = pathlib.Path(path)
    if path.is_dir():
        sp = path / _shard_name(shard)
        if not sp.exists():
            raise GridError(f"poison_checkpoint: generation {path} has no "
                            f"{sp.name}.")
        mp = path / _MANIFEST
        man = json.loads(mp.read_text())
        new_crcs = _poison_npz(sp, field, magnitude, seed, geom=man)
        man["shards"][sp.name] = _summary_crc(new_crcs)
        _write_atomic_text(mp, json.dumps(man))
        return
    _poison_npz(path, field, magnitude, seed)


def _poison_npz(path, field, magnitude, seed, geom=None) -> dict:
    """Perturb one owned element of one array of an igg npz (a flat file,
    or a shard file whose generation manifest is `geom`) and rewrite its
    CRC32 entry; returns the new per-array CRC map."""
    import json

    import torch

    from .checkpoint import (_META_KEY, _crc32, _decode, _encode, _ext,
                             _meta_array, _owned_slice, _write_npz)

    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    victims = sorted(n for n in arrays)
    name = field if field is not None else victims[0]
    if name not in arrays:
        raise GridError(f"poison_checkpoint: no array {name!r} in {path} "
                        f"(has {victims}).")
    dname = meta.get("dtypes", {}).get(name)
    ext = _ext(dname)
    dec = np.array(_decode(arrays[name], dname, path, name))
    if ext is None and dec.dtype.kind in "biu":
        raise GridError(f"poison_checkpoint: array {name!r} has integral "
                        f"dtype {dec.dtype}; pick a floating field.")
    if geom is not None:
        sl = _owned_slice(dec.shape, meta.get("coords", [0, 0, 0]), geom)
    else:
        # Flat stacked array: block (0, ..) sits at offset 0.
        local = [dec.shape[d] // meta["dims"][d]
                 for d in range(min(dec.ndim, 3))]
        sl = _owned_slice(local, (0,) * len(local), meta) \
            + (slice(None),) * (dec.ndim - len(local))
    owned = np.zeros(dec.shape, dtype=bool)
    owned[sl] = True
    idxs = np.flatnonzero(owned)
    pos = int(idxs[np.random.default_rng(seed).integers(0, idxs.size)])
    if ext is not None:
        # Bits of an extension dtype: the sum in that dtype, through torch.
        vals = torch.from_numpy(dec.reshape(-1)).view(ext)
        vals[pos] = vals[pos] + torch.tensor(magnitude, dtype=ext)
        value = float(vals[pos])
    else:
        flat = dec.reshape(-1)
        flat[pos] = flat[pos] + np.asarray(magnitude, dec.dtype)
        value = np.float64(flat[pos])
    if not np.isfinite(value):
        raise GridError("poison_checkpoint: the perturbation overflowed to "
                        "non-finite — pick a smaller magnitude (the point "
                        "is corruption check_finite cannot see).")
    enc = _encode(np.ascontiguousarray(dec), dname)
    arrays[name] = enc
    meta.setdefault("crc32", {})[name] = _crc32(enc)
    _write_npz(path, {**arrays, _META_KEY: _meta_array(meta)})
    return {k: int(v) for k, v in meta.get("crc32", {}).items()}


class SilentCorruption:
    """Armed silent corruption (:func:`silent_corruption`): a one-shot
    state transform in the `igg_torch.resilience._CHAOS_STATE_TAP` seam.
    When the loop crosses `step`, one element of `state[field]` inside the
    block of `rank` is perturbed by the finite `magnitude` in a copy of
    the field (the caller's tensor is never written), added on the device
    with no read back.  Every value stays finite; one-shot, so the
    rolled-back replay passes the same step clean."""

    def __init__(self, field: str, step: int, magnitude: float = 1.0,
                 rank: int = 0, index=None, member: Optional[int] = None):
        if not np.isfinite(magnitude) or magnitude == 0:
            raise GridError("silent_corruption: magnitude must be a "
                            "non-zero FINITE perturbation (NaN injection "
                            "is ChaosPlan's job — the point here is a "
                            "fault the NaN watchdog cannot see).")
        if member is not None:
            raise GridError(
                f"silent_corruption(member={member!r}): the port has no "
                f"ensembles yet (ROADMAP Queue A item 7).")
        self.field = str(field)
        self.step = int(step)
        self.magnitude = float(magnitude)
        self.rank = int(rank)
        self.index = tuple(index) if index is not None else None
        self._fired = False

    def reset(self) -> None:
        self._fired = False

    def _tap(self, state: dict, step: int, emit, span: int = 1):
        from . import shared

        if self._fired or not step <= self.step < step + span:
            return state
        self._fired = True
        if self.field not in state:
            raise GridError(f"silent_corruption: field {self.field!r} not "
                            f"in state {sorted(state)}.")
        A = state[self.field]
        if not (A.is_floating_point() or A.is_complex()):
            raise GridError(f"silent_corruption: cannot perturb dtype "
                            f"{A.dtype}.")
        grid = shared.global_grid()
        coords = grid.cart_coords(self.rank)
        local = grid.local_shape(A)
        off = (self.index if self.index is not None
               else tuple(min(1, s - 1) for s in local))
        nd = min(A.ndim, 3)
        idx = tuple(coords[d] * local[d] + off[d] for d in range(nd)) \
            + tuple(off[nd:])
        out = A.clone()
        out[idx].add_(self.magnitude)
        state = dict(state)
        state[self.field] = out
        emit("chaos_silent_corruption", step, field=self.field,
             magnitude=self.magnitude, index=[int(i) for i in idx],
             rank=self.rank)
        return state

    def arm(self) -> "SilentCorruption":
        from . import resilience

        self._fired = False
        resilience._CHAOS_STATE_TAP = self._tap
        return self

    def disarm(self) -> None:
        from . import resilience

        resilience._CHAOS_STATE_TAP = None

    def __enter__(self) -> "SilentCorruption":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


def silent_corruption(field: str, step: int, magnitude: float = 1.0,
                      rank: int = 0, index=None,
                      member: Optional[int] = None) -> SilentCorruption:
    """Context manager injecting silent data corruption: at step `step`,
    one element of `state[field]` inside block `rank`'s region of the
    stacked tensor (index `coords(rank) * local + index`, default an
    interior cell `(1, 1, ...)`) is perturbed by the finite `magnitude`
    (igg's injector).  The NaN watchdog stays silent; detection belongs
    to :mod:`igg_torch.integrity`::

        with it.chaos.silent_corruption("T", step=40, magnitude=50.0,
                                        rank=3):
            res = it.run_resilient(step, state, n, watch_every=10,
                                   integrity=True, ...)

    `member=` (a lane of an ensemble) raises `GridError` until the port
    has ensembles."""
    return SilentCorruption(field, step, magnitude, rank=rank, index=index,
                            member=member)


class HaloCorruption:
    """Armed halo-plane corruption (see :func:`halo_corruption`)."""

    def __init__(self, value: float = float("nan")):
        self._value = value

    def _tap(self, d, first, last):
        def hit(P):
            if P is None or not (P.is_floating_point() or P.is_complex()):
                return P
            import torch

            return torch.full_like(P, self._value)

        return hit(first), hit(last)

    def arm(self) -> "HaloCorruption":
        from . import halo

        halo._CHAOS_PLANE_TAP = self._tap
        return self

    def disarm(self) -> None:
        from . import halo

        halo._CHAOS_PLANE_TAP = None

    def __enter__(self) -> "HaloCorruption":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


def halo_corruption(value: float = float("nan")) -> HaloCorruption:
    """Context manager replacing every RECEIVED halo plane by `value`
    (default NaN) through the `igg_torch.halo._CHAOS_PLANE_TAP` seam, the
    stand-in for a corrupted transfer; `disarm()` from a recovery policy
    models a transient fault that heals on retry::

        fault = igg_torch.chaos.halo_corruption()
        with fault:
            result = igg_torch.run_resilient(
                step, state, n,
                recovery_policy=lambda k, s, ev: (fault.disarm(), None)[1],
                ...)
    """
    return HaloCorruption(value)


class KernelChaos:
    """Armed tier-dispatch fault (see :func:`kernel_compile_fail` /
    :func:`kernel_corrupt`): merges its entry into
    `igg_torch.degrade._CHAOS_TIER_TAP` on `arm()` and removes exactly it
    on `disarm()`, so several can be armed at once."""

    def __init__(self, kind: str, tier: str, payload):
        self._kind = kind          # "compile_fail" | "corrupt"
        self._tier = tier
        self._payload = payload

    def arm(self) -> "KernelChaos":
        from . import degrade

        tap = degrade._CHAOS_TIER_TAP or {}
        tap.setdefault(self._kind, {})[self._tier] = self._payload
        degrade._CHAOS_TIER_TAP = tap
        return self

    def disarm(self) -> None:
        from . import degrade

        tap = degrade._CHAOS_TIER_TAP
        if not tap:
            return
        tap.get(self._kind, {}).pop(self._tier, None)
        if not any(tap.get(k) for k in tap):
            degrade._CHAOS_TIER_TAP = None

    def __enter__(self) -> "KernelChaos":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


def kernel_compile_fail(tier: str, message: Optional[str] = None) \
        -> KernelChaos:
    """Context manager making the build of ladder tier `tier` (e.g.
    ``"diffusion3d.cuda"``) raise `igg_torch.degrade.InjectedCompileError`
    carrying `message`.  Where igg quarantines the tier and serves the
    next rung, the port's ladder lets the error out (a kernel that fails
    to build raises), and so does `run_resilient`."""
    return KernelChaos("compile_fail", tier, message)


def kernel_corrupt(tier: str, magnitude: float = float("nan")) \
        -> KernelChaos:
    """Context manager corrupting every dispatch of ladder tier `tier`:
    one interior element of its first floating output changes by
    `magnitude` (default NaN, the blowup the watchdog detects).  It does
    not heal on rollback: on CPU tensors `run_resilient` demotes the tier,
    on the card it raises naming it."""
    return KernelChaos("corrupt", tier, magnitude)


class StaleCalibration:
    """Armed stale-calibration injection (see :func:`stale_calibration`):
    `arm()` registers a wrong cost-model prediction for a family, and
    `disarm()` restores the one before it, unless a recalibration has
    replaced the injection since."""

    def __init__(self, family: str, s_per_step: float):
        self._family = family
        self._s = float(s_per_step)
        self._prev = None

    def arm(self) -> "StaleCalibration":
        from . import perf

        with perf._lock:
            self._prev = perf._PREDICTIONS.get(self._family)
        perf.predict(self._family, self._s, source="chaos")
        return self

    def disarm(self) -> None:
        from . import perf

        with perf._lock:
            cur = perf._PREDICTIONS.get(self._family)
            if cur is None or cur.get("source") != "chaos":
                return   # a recalibration replaced the injection: keep it
            if self._prev is None:
                perf._PREDICTIONS.pop(self._family, None)
            else:
                perf._PREDICTIONS[self._family] = self._prev

    def __enter__(self) -> "StaleCalibration":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


def stale_calibration(family: str, s_per_step: float) -> StaleCalibration:
    """Context manager installing a wrong cost-model prediction for
    `family` (say ten times the true seconds per step): the next measured
    sample of the family is past ``IGG_PERF_DRIFT_TOL`` and fires
    ``cost_model_drift`` once per (family, tier), the trigger of igg's
    drift -> recalibrate loop."""
    return StaleCalibration(family, s_per_step)


class FetchStall:
    """Armed collective-stall injection (see :func:`collective_stall`): a
    never-ready predicate in the `igg_torch.resilience._CHAOS_FETCH_TAP`
    seam, the readiness primitive of the watchdog's probes, the comm
    decomposition probes and the stall heartbeat, so every readiness poll
    reports not ready while armed.  Read at poll time, so arming clears
    nothing.  Forced reads (at the pending-depth bound, at the end-of-run
    drain) still complete, because the data is there: only the readiness
    channel stalls, which is how the host sees a hung exchange.

    With `device` (a `torch.device` or a CUDA index), the stall is tied to
    that device: polls report not ready only while the live grid's device
    is that device, so a grid re-initialized elsewhere no longer sees it
    (igg's sick-chip shape)."""

    def __init__(self, device=None):
        self._device = device

    def _sick_in_grid(self) -> bool:
        import torch

        from . import shared

        if not shared.grid_is_initialized():
            return True            # no grid to have fenced it yet
        dev = self._device
        if isinstance(dev, (int, np.integer)):
            dev = torch.device("cuda", int(dev))
        return _same_device(torch.device(dev),
                            torch.device(shared.global_grid().device))

    def _tap(self, obj) -> bool:
        if self._device is None:
            return False           # unconditionally stalled
        return not self._sick_in_grid()

    def arm(self) -> "FetchStall":
        from . import resilience

        resilience._CHAOS_FETCH_TAP = self._tap
        return self

    def disarm(self) -> None:
        from . import resilience

        resilience._CHAOS_FETCH_TAP = None

    def __enter__(self) -> "FetchStall":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


def _same_device(a, b) -> bool:
    """Device equality with an index-less CUDA device read as the current
    one."""
    import torch

    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    if a.type != b.type:
        return False
    return norm(a) == norm(b)


def collective_stall(device=None) -> FetchStall:
    """Context manager making every probe's readiness poll report not
    ready: the stand-in for an exchange hung between devices.  The stall
    heartbeat (`igg_torch.comm.StallWatchdog`, ``IGG_COMM_STALL_TIMEOUT``)
    must report the probe over age with a ``collective_stall`` record, a
    ``stall_r<rank>.json`` report and a flight dump::

        with igg_torch.chaos.collective_stall():
            res = igg_torch.run_resilient(step, state, n, watch_every=5,
                                          max_pending_probes=100, ...)

    `max_pending_probes` is raised so that the loop's forced reads do not
    retire the probe before the deadline; the run still completes (the
    end-of-run drain reads every probe).  `device` ties the stall to one
    device (:class:`FetchStall`)."""
    return FetchStall(device=device)


class FetchDelay:
    """Armed straggler injection (see :func:`straggler`): a rate limit on
    the readiness channel, at most one grant per `delay_s` seconds after
    `after` free grants (the healthy baseline), through the
    `igg_torch.resilience._CHAOS_FETCH_TAP` seam.  Probe reads then trickle
    at the slow rank's pace and every watchdog window that
    :class:`igg_torch.telemetry.StepStats` measures inflates.  Forced reads
    still complete, so the run always finishes; raise `max_pending_probes`
    so the windows stay readiness-gated.  `rank` limits it to one process
    (`telemetry._process()`; a one-process run is rank 0)."""

    def __init__(self, delay_s: float, *, rank: Optional[int] = None,
                 after: int = 0):
        self._delay = float(delay_s)
        self._rank = rank
        self._free = int(after)
        self._last_grant: Optional[float] = None

    def _tap(self, obj) -> bool:
        import time

        from . import telemetry

        if self._rank is not None and \
                int(telemetry._process()) != int(self._rank):
            return True
        now = time.monotonic()
        if self._free > 0:
            self._free -= 1
            self._last_grant = now
            return True
        if self._last_grant is None or now - self._last_grant >= self._delay:
            self._last_grant = now
            return True
        return False

    def arm(self) -> "FetchDelay":
        from . import resilience

        resilience._CHAOS_FETCH_TAP = self._tap
        return self

    def disarm(self) -> None:
        from . import resilience

        resilience._CHAOS_FETCH_TAP = None

    def __enter__(self) -> "FetchDelay":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


def straggler(rank: int = 0, factor: float = 4.0, *,
              base_window_s: float = 0.05, after: int = 0) -> FetchDelay:
    """Context manager making process `rank` a straggler: readiness grants
    are limited to one per ``factor * base_window_s`` seconds
    (`base_window_s` approximates the healthy watch window), so measured
    watchdog windows inflate by about `factor`.  `after` grants pass
    first, so the run sets its healthy baseline before the slowdown (a
    card degrading mid-run).  Rides the readiness seam
    (:class:`FetchDelay`)."""
    return FetchDelay(factor * base_window_s, rank=rank, after=after)


@contextlib.contextmanager
def armed(*injectors):
    """Arm several injectors for a scope and disarm all of them (in
    reverse order) on the way out, also when the body or a later `arm()`
    raises.  A :class:`ChaosPlan` is `reset()` on entry and exit.  Yields
    the injectors (the one, when one was passed)."""
    entered = []
    try:
        for inj in injectors:
            if isinstance(inj, ChaosPlan):
                inj.reset()
            else:
                inj.arm()
            entered.append(inj)
        yield injectors[0] if len(injectors) == 1 else injectors
    finally:
        for inj in reversed(entered):
            if isinstance(inj, ChaosPlan):
                inj.reset()
            else:
                inj.disarm()
