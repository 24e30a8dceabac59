"""Checkpoint / resume for grid fields (the port's `igg/checkpoint.py`).

The on-disk formats are igg's, byte for byte in every entry, so a
generation written by one package loads in the other:

- **Flat `.npz`** (:func:`save_checkpoint`): one file holding every field's
  block-stacked global array (halo cells included: on open boundaries they
  are user-owned data) plus a `__igg_meta__` JSON entry with the geometry
  `(nxyz, dims, overlaps, periods, nprocs)`, each field's dtype name, the
  deep stamp and a CRC32 of each array's stored bytes.
- **Sharded generation directory** (:func:`save_checkpoint_sharded`,
  `igg-sharded-v1`): one `shard_<rank>.npz` per grid block (each field's
  local block, halos included, and a per-shard `__igg_meta__`), and a
  `manifest.json` written LAST as the commit record, staged as
  `<name>.tmp/` and renamed into place.  A generation without its
  manifest, or still under its staging name, is skipped by
  :func:`verify_checkpoint`/:func:`latest_checkpoint` like a bit-flipped
  flat file.

Restore (:func:`load_checkpoint`) validates the geometry against the live
grid; `redistribute=True` re-tiles either format onto another
decomposition (overlaps stripped, every block's halo rebuilt by global
indexing, periodic wrap included).  Loads return fresh tensors on the
grid's device.

Where the port's route is not igg's, and why:

- **Snapshots.**  A JAX array never changes; the port's fields are
  overwritten in place (`update_halo`, the models' ping-pong buffers).  So
  both saves copy every byte they write off the fields before they return:
  each block goes through `igg_torch.gather._slabbed_get` (one slab on the
  device at a time, into the reused pinned host buffer, waited for), and a
  kernel the caller launches after the call cannot change the generation.
- **One process.**  Every block of a port grid lives in this process, so
  "the blocks this process addresses" are all of them, and staging stays
  one block at a time: fetch, stamp, CRC, write, release.  The peer side
  of igg's multi-controller commit (`_peer_handshake`, `_await_commit`,
  the wait for peers' shards in `_await_files`) waits for the port's
  `torch.distributed` backend; with more than one process the sharded
  save raises `GridError`.
- **Reads are streamed.**  Shard members are stored uncompressed, so a
  load maps each member (`numpy.memmap`) and checks its CRC32 in chunks;
  the elastic restore copies only the cells each target block needs.  Host
  memory stays one target block, never the global array.
- **Extension dtypes.**  bfloat16 and float8 live on the host as raw bits
  of their width (numpy has no type for them); the stored bytes and the
  `dtypes` names are igg's.
- **Integrity stamps.**  A generation written during an
  integrity-enabled run carries the run's invariant entries (name,
  fields, moment, kind, tol and the reference `ref`/`scale`,
  :func:`igg_torch.integrity.stamp_entries`) in its deep stamp, igg's
  `deep["invariants"]`; `verify_checkpoint(deep=True)` holds each to its
  tolerance (:func:`_invariants_ok`), on the port's generations and on
  igg's.

Imports torch, numpy and the stdlib only.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import pathlib
import re
import shutil
import struct
import time
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import shared
from . import telemetry as _telemetry
from .gather import (_BITS, _CHUNK_BYTES, _fetch_global, _slabbed_get,
                     host_dtype)
from .shared import NDIMS, GridError

__all__ = ["save_checkpoint", "save_checkpoint_sharded", "load_checkpoint",
           "latest_checkpoint", "verify_checkpoint",
           "verify_checkpoint_distributed", "checkpoint_step",
           "list_generations", "remove_generation"]

_META_KEY = "__igg_meta__"
# igg's attempt handshake inside a staging dir (`igg/checkpoint.py:97-116`):
# peer p publishes `hello_<p>` with a fresh nonce, process 0 answers with
# `ack_<p>` (nonce and this attempt's token), the peer confirms with
# `done_<p>`.  The port runs one process, so only process 0's side runs.
_ACK = "ack_{:05d}"
# Marker name older igg versions staged (recognized when sweeping).
_ATTEMPT = "attempt.token"

# Sharded-generation layout constants.
_MANIFEST = "manifest.json"
_FORMAT = "igg-sharded-v1"

_warned_stale_tmp = False

# Deep-stamp format version: per-field owned-cell moment sums (and the
# active invariants' references) in the flat meta / sharded manifests.
_DEEP_V = 1


# ---------------------------------------------------------------------------
# dtypes on the host
# ---------------------------------------------------------------------------

_EXT_NAMES = {dt: str(dt).replace("torch.", "") for dt in _BITS}


def _dtype_name(dtype: torch.dtype) -> str:
    """igg's name of a dtype (`str(np.dtype(A.dtype))`): numpy's, or the
    ml_dtypes name of an extension dtype ("bfloat16")."""
    return _EXT_NAMES.get(dtype) or str(host_dtype(dtype))


def _ext(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype of an extension dtype name, None for the others."""
    for dt, n in _EXT_NAMES.items():
        if n == name:
            return dt
    return None


def _torch_dtype(name: str) -> torch.dtype:
    ext = _ext(name)
    if ext is not None:
        return ext
    return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype


def _host_dtype_of(name: str) -> np.dtype:
    """The host dtype of arrays of the dtype named `name` (bits for the
    extension dtypes)."""
    ext = _ext(name)
    return host_dtype(ext) if ext is not None else np.dtype(name)


def _to_tensor(arr: np.ndarray, name: Optional[str], device) -> torch.Tensor:
    """A fresh tensor on `device` holding host array `arr` of the dtype
    named `name`."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    ext = _ext(name)
    if ext is not None:
        t = t.view(ext)
    return t.to(device, copy=True)


def _crc32(arr: np.ndarray, chunk: int = 1 << 26) -> int:
    """CRC32 of an array's raw bytes (C-order), as igg records it, read
    `chunk` bytes at a time (a mapped shard member is never read whole
    into memory)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    crc = 0
    for i in range(0, flat.size, chunk):
        crc = zlib.crc32(flat[i:i + chunk], crc)
    return int(crc)


def _meta(grid) -> dict:
    return {
        "nxyz": list(grid.nxyz),
        "dims": list(grid.dims),
        "overlaps": list(grid.overlaps),
        "periods": list(grid.periods),
        "nprocs": grid.nprocs,
    }


def _process_count() -> int:
    """Processes of the run: the `torch.distributed` world, else 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def _single_process(what: str) -> None:
    if _process_count() > 1:
        raise GridError(
            f"{what}: the port's checkpoint runs in one process (every block "
            f"of its grid lives there); the multi-process commit waits for "
            f"its torch.distributed backend.")


# ---------------------------------------------------------------------------
# Staging and atomic writes
# ---------------------------------------------------------------------------

# A .tmp entry younger than this may belong to a live concurrent writer.
_STALE_TMP_AGE_S = 300.0


def _is_staging_dir(p: pathlib.Path) -> bool:
    """Whether a `*.tmp` directory has exactly the shape a sharded save
    stages (shards, handshake files, the manifest); anything else is not
    ours and is never swept."""
    try:
        entries = list(p.iterdir())
    except OSError:
        return False
    for e in entries:
        if not (re.fullmatch(
                    r"(shard_\d+\.npz|hello_\d+|ack_\d+|done_\d+)(\.tmp)?",
                    e.name)
                or e.name in (_MANIFEST, _MANIFEST + ".tmp",
                              _ATTEMPT, _ATTEMPT + ".tmp")):
            return False
    return True


def _sweep_stale_tmp(parent: pathlib.Path) -> None:
    """Remove `*.npz.tmp` files and staging directories a crashed writer
    left in `parent`, only the shapes this module stages and only those
    older than `_STALE_TMP_AGE_S`; warns once per process."""
    global _warned_stale_tmp

    now = time.time()
    stale = []
    for p in sorted(parent.glob("*.tmp")):
        try:
            is_dir = p.is_dir()
            if is_dir and not _is_staging_dir(p):
                continue
            if not is_dir and not p.name.endswith(".npz.tmp"):
                continue
            if now - p.stat().st_mtime >= _STALE_TMP_AGE_S:
                stale.append((p, is_dir))
        except OSError:
            pass   # vanished under us
    if not stale:
        return
    if not _warned_stale_tmp:
        import warnings

        _warned_stale_tmp = True
        warnings.warn(
            f"igg_torch.save_checkpoint: sweeping {len(stale)} stale .tmp "
            f"file(s)/staging dir(s) left by a crashed writer in {parent} "
            f"(e.g. {stale[0][0].name}); checkpoints publish atomically, so "
            f".tmp entries are never valid state.  (Warned once per "
            f"process.)", stacklevel=3)
    for p, is_dir in stale:
        try:
            shutil.rmtree(p) if is_dir else p.unlink()
        except OSError:
            pass


def _npy_size(arr: np.ndarray) -> int:
    """Bytes of `arr` in the npy format `np.lib.format.write_array` writes."""
    fmt = np.lib.format
    head = fmt.header_data_from_array_1_0(arr)
    buf = io.BytesIO()
    try:
        fmt.write_array_header_1_0(buf, head)
    except ValueError:     # a header too long for version 1.0
        buf = io.BytesIO()
        fmt.write_array_header_2_0(buf, head)
    return buf.tell() + arr.nbytes


class _NpzWriter:
    """igg's `_write_npz` file, entry by entry: an uncompressed zip whose
    entry `<name>.npy` is the npy bytes of one array, each entry's header
    that of `ZipFile.writestr`.  Each array streams into its entry (no
    second copy of it in memory); the file is written as `<path>.tmp` and
    renamed over `path` by :meth:`commit`, so a crash never destroys the
    previous file at `path`."""

    def __init__(self, path: pathlib.Path):
        self.path = pathlib.Path(path)
        self.tmp = self.path.with_name(self.path.name + ".tmp")
        self.zf = zipfile.ZipFile(self.tmp, "w", zipfile.ZIP_STORED)

    def add(self, name: str, arr: np.ndarray) -> None:
        info = zipfile.ZipInfo(name + ".npy",
                               date_time=time.localtime(time.time())[:6])
        info.compress_type = zipfile.ZIP_STORED
        info.external_attr = 0o600 << 16
        info.file_size = _npy_size(arr)
        with self.zf.open(info, "w") as dest:
            np.lib.format.write_array(dest, arr, allow_pickle=False)

    def commit(self) -> None:
        self.zf.close()
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        self.zf.close()
        try:
            self.tmp.unlink()
        except OSError:
            pass


def _write_npz(path, arrays: Dict[str, np.ndarray]) -> None:
    """Write `arrays` as one `.npz` at exactly `path` (atomic, see
    :class:`_NpzWriter`)."""
    w = _NpzWriter(path)
    try:
        for name, arr in arrays.items():
            w.add(name, arr)
    except BaseException:
        w.abort()
        raise
    w.commit()


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _encode(arr: np.ndarray, name: str) -> np.ndarray:
    """The bytes an array is stored as: extension dtypes (bits on the
    host) as uint8, the true name travelling in `dtypes` (igg's layout)."""
    if _ext(name) is not None:
        return arr.view(np.uint8)
    return arr


def _decode(arr: np.ndarray, want: Optional[str], path, name: str):
    """View a stored array back to its host dtype per the `dtypes` entry
    (bits for the extension dtypes); a malformed entry reads as a corrupt
    checkpoint, never a raw TypeError/ValueError."""
    try:
        w = _host_dtype_of(want) if want is not None else arr.dtype
        if arr.dtype != w:
            arr = arr.view(w)
    except (TypeError, ValueError) as e:
        raise GridError(
            f"load_checkpoint: corrupt dtypes manifest for field "
            f"{name!r} in {path} ({e}).") from e
    return arr


# ---------------------------------------------------------------------------
# Deep stamps: owned-cell moment sums and invariant references
# ---------------------------------------------------------------------------

def _real_view(a: np.ndarray) -> np.ndarray:
    """A real-valued view for the moment sums: complex splits into
    interleaved re/im floats, bool widens to uint8."""
    if a.dtype.kind == "c":
        return a.view(np.dtype(f"f{a.dtype.itemsize // 2}"))
    if a.dtype.kind == "b":
        return a.astype(np.uint8)
    return a


def _float64(a: np.ndarray, ext: Optional[torch.dtype]) -> np.ndarray:
    """A C-contiguous float64 copy of `a`'s values (bits of `ext` decoded
    exactly)."""
    if ext is not None:
        t = torch.from_numpy(np.ascontiguousarray(a)).view(ext)
        return t.to(torch.float64).numpy()
    return np.ascontiguousarray(_real_view(a), dtype=np.float64)


def _deep_stats(a: np.ndarray, ext: Optional[torch.dtype] = None
                ) -> np.ndarray:
    """``[sum, abs_sum, sum_sq]`` of an (owned-slice) array in float64,
    bitwise what igg's `_deep_stats` computes (numpy reduces a whole array
    in C order, buffer after buffer of `np.getbufsize()` elements, each
    buffer summed pairwise, the buffers' sums added in order), but over a
    bounded slab of float64 at a time instead of a float64 copy of the
    whole block and two more temporaries."""
    a = np.asarray(a)
    if a.ndim == 0:
        a = a.reshape(1)
    bs = np.getbufsize()
    plane = int(np.prod(a.shape[1:], dtype=np.int64))
    step = max(1, (1 << 20) // max(plane, 1))     # ~8 MB of float64 a slab
    acc = [0.0, 0.0, 0.0]
    carry = np.empty(0, dtype=np.float64)

    def add(x):
        for k, v in enumerate((x, np.abs(x), x * x)):
            s = v.sum(axis=-1) if x.ndim == 2 else (v.sum(),)
            for part in s:
                acc[k] += part

    for i0 in range(0, a.shape[0], step):
        seg = _float64(a[i0:i0 + step], ext).reshape(-1)
        if carry.size:
            seg = np.concatenate([carry, seg])
        m = seg.size // bs * bs
        if m:
            add(seg[:m].reshape(-1, bs))
        carry = seg[m:].copy()
    if carry.size:
        add(carry)
    return np.array(acc, dtype=np.float64)


def _owned_slice(shape, coords, meta) -> tuple:
    """Owned-cell slice of one local block: along each sharded dim the
    block owns its first ``s − ol`` cells, the LAST block of a non-periodic
    dim all ``s`` (the union over blocks is the global interior)."""
    sl = []
    for d in range(min(len(shape), NDIMS)):
        s = int(shape[d])
        ol = meta["overlaps"][d] + (s - meta["nxyz"][d])
        keep = s - max(ol, 0)
        last = coords[d] == meta["dims"][d] - 1
        sl.append(slice(0, s if (last and not meta["periods"][d]) else keep))
    return tuple(sl) + (slice(None),) * (len(shape) - len(sl))


def _deep_sums_stacked(arr: np.ndarray, meta: dict,
                       ext: Optional[torch.dtype] = None) -> np.ndarray:
    """Moment sums of a block-STACKED array (the flat format): per-block
    owned slices accumulated in block order."""
    nd = min(arr.ndim, NDIMS)
    local = [arr.shape[d] // meta["dims"][d] for d in range(nd)]
    tot = np.zeros(3, dtype=np.float64)
    for coords in itertools.product(
            *[range(meta["dims"][d]) for d in range(nd)]):
        block = arr[tuple(slice(c * local[d], (c + 1) * local[d])
                          for d, c in enumerate(coords)) or (Ellipsis,)]
        tot += _deep_stats(block[_owned_slice(block.shape, coords, meta)],
                           ext)
    return tot


def _stamp_invariants() -> Optional[list]:
    """The active run's invariant stamp entries
    (:func:`igg_torch.integrity.stamp_entries`; None outside an
    integrity-enabled run).  Imported at the call: the checkpoint layer
    neither pays for nor cycles with the integrity module."""
    from . import integrity

    return integrity.stamp_entries()


def _deep_meta(sums: Dict[str, list]) -> dict:
    deep = {"v": _DEEP_V, "sums": {n: [float(v) for v in s]
                                   for n, s in sums.items()}}
    inv = _stamp_invariants()
    if inv:
        deep["invariants"] = inv
    return deep


def _close(a, b) -> bool:
    return bool(np.isclose(float(a), float(b), rtol=1e-9, atol=1e-12,
                           equal_nan=True))


def _stats_match(got: np.ndarray, want) -> bool:
    want = np.asarray(want, dtype=np.float64)
    return want.shape == (3,) and all(_close(g, w)
                                      for g, w in zip(got, want))


def _derive_invariant(entry: dict, sums: Dict[str, list]):
    """(value, present) of one stamped invariant from per-field moment
    sums: moment 1 reads the plain sums, moment 2 the sums of squares."""
    idx = 0 if int(entry.get("moment", 1)) == 1 else 2
    total = 0.0
    for f in entry.get("fields", ()):
        s = sums.get(f)
        if s is None or len(s) < 3:
            return 0.0, False
        total += float(s[idx])
    return total, True


def _invariants_ok(deep: dict) -> bool:
    """Every stamped invariant whose reference is present sits within its
    tolerance of that reference (igg's drift gate)."""
    for entry in deep.get("invariants") or ():
        ref, scale = entry.get("ref"), entry.get("scale")
        if ref is None:
            continue
        value, present = _derive_invariant(entry, deep.get("sums", {}))
        if not present:
            return False
        tol = float(entry.get("tol", 1e-3))
        bound = tol * max(float(scale or 0.0), 1e-30)
        drift = value - float(ref)
        if entry.get("kind") == "bounded":
            if drift > bound:
                return False
        elif abs(drift) > bound:
            return False
    return True


def _observe(path, nbytes: int, dur: float, fmt: str,
             split: Dict[str, float]) -> None:
    """igg's checkpoint telemetry: bytes, write latency, the record (host
    numbers only: nothing here waits for the device).  The record also
    carries the save's seconds by part: the device-to-host copy
    (`fetch_seconds`), the deep stamp and CRC32 (`stamp_seconds`) and the
    file writes (`write_seconds`)."""
    _telemetry.counter("igg_checkpoint_bytes_total").inc(nbytes)
    _telemetry.histogram("igg_checkpoint_write_seconds",
                         format=fmt).observe(dur)
    _telemetry.emit("checkpoint_write", path=str(path), bytes=int(nbytes),
                    seconds=round(dur, 6), format=fmt,
                    **{f"{k}_seconds": round(v, 6) for k, v in split.items()})


# ---------------------------------------------------------------------------
# The flat format
# ---------------------------------------------------------------------------

def save_checkpoint(path, /, **fields) -> None:
    """Write the named grid fields and the grid geometry to `path` (.npz):
    the FLAT single-file format (:func:`save_checkpoint_sharded` writes
    the O(block) generation directory).  Fields are block-stacked grid
    arrays (any stagger, any dtype); each is copied off the device in
    bounded slabs before anything is written, and the call returns only
    after every copy finished."""
    shared.check_initialized()
    grid = shared.global_grid()
    if not fields:
        raise GridError("save_checkpoint: no fields given.")
    t_start = time.monotonic()
    host: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    deep_sums: Dict[str, list] = {}
    gmeta = _meta(grid)
    split = dict(fetch=0.0, stamp=0.0, write=0.0)
    for name, A in fields.items():
        if name == _META_KEY:
            raise GridError(f"save_checkpoint: field name {_META_KEY!r} is "
                            f"reserved.")
        dtypes[name] = _dtype_name(A.dtype)
        t0 = time.monotonic()
        arr = _fetch_global(A)
        t1 = time.monotonic()
        deep_sums[name] = _deep_sums_stacked(arr, gmeta,
                                             _ext(dtypes[name])).tolist()
        host[name] = _encode(arr, dtypes[name])
        split["fetch"] += t1 - t0
        split["stamp"] += time.monotonic() - t1

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _sweep_stale_tmp(path.parent)
    t0 = time.monotonic()
    meta = {**gmeta, "dtypes": dtypes, "deep": _deep_meta(deep_sums),
            "crc32": {name: _crc32(arr) for name, arr in host.items()}}
    t1 = time.monotonic()
    _write_npz(path, {**host, _META_KEY: _meta_array(meta)})
    split["stamp"] += t1 - t0
    split["write"] += time.monotonic() - t1
    dur = time.monotonic() - t_start
    _observe(path, sum(a.nbytes for a in host.values()), dur, "flat", split)


def load_checkpoint(path, /, *, redistribute: bool = False) -> Dict:
    """Read a checkpoint written by :func:`save_checkpoint` (a flat `.npz`)
    or :func:`save_checkpoint_sharded` (a generation directory; the format
    is detected) and return `{name: tensor}`, fresh tensors on the grid's
    device.

    By default the grid must have the geometry the checkpoint was written
    under (`GridError` on a mismatch).  With `redistribute=True` a
    checkpoint of another decomposition is re-tiled onto the grid: the
    saved blocks' overlaps are stripped (the `gather_interior` contract),
    the global interior is checked against the grid's global sizes, and
    every target block, halo cells included, is rebuilt by global indexing
    with periodic wrap, which is what an `update_halo` of globally
    consistent data gives.  Periodicity and per-array stagger must match;
    `dims`, local sizes and overlaps may differ.  A sharded generation is
    restored block by block (elastically too): the global array is never
    held in host memory."""
    shared.check_initialized()
    grid = shared.global_grid()
    path = pathlib.Path(path)
    if path.is_dir():
        return _load_sharded(path, grid, redistribute)
    meta, arrays = _read_verified(path)

    mine = _meta(grid)
    same_geometry = {k: meta.get(k) for k in mine} == mine
    if not same_geometry and not redistribute:
        diffs = {k: (meta.get(k), mine[k]) for k in mine
                 if meta.get(k) != mine[k]}
        raise GridError(
            f"load_checkpoint: grid geometry mismatch {diffs} "
            f"(checkpoint vs current).  Pass redistribute=True to re-tile "
            f"the checkpoint onto the current decomposition.")
    if not same_geometry and list(meta["periods"]) != mine["periods"]:
        raise GridError(
            f"load_checkpoint(redistribute=True): periodicity mismatch "
            f"{meta['periods']} vs {mine['periods']} — redistribution "
            f"changes the decomposition, not the physics.")

    dtypes = meta.get("dtypes", {})
    out = {}
    for name, arr in arrays.items():
        arr = _decode(arr, dtypes.get(name), path, name)
        if not same_geometry:
            arr = _redistribute(name, arr, meta, grid)
        out[name] = _to_tensor(arr, dtypes.get(name), grid.device)
    return out


def _read_verified(path: pathlib.Path):
    """Every entry of a flat checkpoint, its CRC32 manifest verified:
    `(meta, arrays)`; `GridError` naming the path for anything unreadable
    (missing, truncated, a failing container checksum, a CRC mismatch)."""
    try:
        with np.load(path) as z:
            if _META_KEY not in z.files:
                raise GridError(
                    f"load_checkpoint: {path} has no {_META_KEY!r} entry — "
                    f"not an igg checkpoint (or one truncated before the "
                    f"manifest was written).")
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
            arrays = {k: z[k] for k in z.files if k != _META_KEY}
    except GridError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError,
            json.JSONDecodeError) as e:
        raise GridError(
            f"load_checkpoint: cannot read checkpoint {path}: "
            f"{type(e).__name__}: {e} — the file is missing, truncated, or "
            f"corrupt (a crash mid-write never publishes a partial file; "
            f"this one was damaged after the fact or never completed on a "
            f"non-atomic filesystem).") from e

    crcs = meta.get("crc32", {})
    for name, arr in arrays.items():
        want = crcs.get(name)
        if want is not None and _crc32(arr) != want:
            raise GridError(
                f"load_checkpoint: CRC32 mismatch for field {name!r} in "
                f"{path} ({_crc32(arr):#010x} != recorded {want:#010x}) — "
                f"the checkpoint is corrupt.")
    return meta, arrays


def _all_finite(arrays: Dict[str, np.ndarray],
                dtypes: Optional[Dict[str, str]] = None) -> bool:
    """The all-finite gate over decoded arrays: integral dtypes pass; f/c
    and the extension floats (bits decoded through torch) must be finite
    everywhere."""
    dtypes = dtypes or {}
    for name, arr in arrays.items():
        ext = _ext(dtypes.get(name))
        if ext is not None:
            ok = bool(torch.isfinite(torch.from_numpy(
                np.ascontiguousarray(arr)).view(ext)).all())
        elif arr.dtype.kind in "biu":
            continue
        else:
            try:
                ok = bool(np.isfinite(arr).all())
            except TypeError:
                continue
        if not ok:
            return False
    return True


def verify_checkpoint(path, *, check_finite: bool = False,
                      part: Optional[Tuple[int, int]] = None,
                      deep: bool = False) -> bool:
    """Whether `path` is a readable, checksum-consistent checkpoint, a flat
    `.npz` or a sharded generation directory (detected).  Every array is
    read and its CRC32 checked (a sharded generation also needs its
    manifest, every listed shard present and summary-consistent).
    `check_finite=True` also requires every float field finite;
    `part=(i, n)` restricts a sharded verification to every n-th shard
    from i; `deep=True` requires the deep stamp, recomputes every stamped
    sum from the stored arrays and holds every stamped invariant to its
    tolerance.  Host-side only (no grid needed); a sharded generation is
    read one mapped member at a time."""
    path = pathlib.Path(path)
    if path.is_dir():
        return _verify_sharded(path, check_finite=check_finite, part=part,
                               deep=deep)
    try:
        meta, arrays = _read_verified(path)
    except GridError:
        return False
    if not (check_finite or deep):
        return True
    dtypes = meta.get("dtypes", {})
    try:
        decoded = {n: _decode(a, dtypes.get(n), path, n)
                   for n, a in arrays.items()}
    except GridError:
        return False
    if check_finite and not _all_finite(decoded, dtypes):
        return False
    if deep:
        dm = meta.get("deep")
        if not isinstance(dm, dict) or not isinstance(dm.get("sums"), dict):
            return False
        sums = dm["sums"]
        for n, a in decoded.items():
            if n not in sums or not _stats_match(
                    _deep_sums_stacked(a, meta, _ext(dtypes.get(n))),
                    sums[n]):
                return False
        if not _invariants_ok(dm):
            return False
    return True


def verify_checkpoint_distributed(path, *, check_finite: bool = False,
                                  deep: bool = False) -> bool:
    """igg's collective verification: each process checks a round-robin
    part of the shards and the verdicts are AND-combined.  The port runs
    one process, where it is exactly :func:`verify_checkpoint`."""
    _single_process("verify_checkpoint_distributed")
    return verify_checkpoint(path, check_finite=check_finite, deep=deep)


def _combine_min(val: int) -> int:
    """igg's cross-process minimum; over the port's one process, `val`."""
    _single_process("checkpoint verdict combine")
    return int(val)


def _combine_max(val: int) -> int:
    """Maximum across processes (the minimum of the negation)."""
    return -_combine_min(-int(val))


def _combine_verdicts(ok: bool) -> bool:
    """AND of a per-process verdict across processes."""
    return _combine_min(1 if ok else 0) > 0


# ---------------------------------------------------------------------------
# Generations
# ---------------------------------------------------------------------------

def checkpoint_step(path) -> Optional[int]:
    """Step number of a generation name (`<prefix>_<step>.npz` or a
    `<prefix>_<step>` directory); None for other names (a `.tmp` staging
    directory included)."""
    m = re.search(r"_(\d+)(?:\.npz)?$", pathlib.Path(path).name)
    return int(m.group(1)) if m else None


def list_generations(directory, prefix: str = "ckpt"):
    """Every generation, flat files `{prefix}_<digits>.npz` and sharded
    directories `{prefix}_<digits>`, in `directory` as `[(step, path),
    ...]` sorted by step (a longer prefix or a `.tmp` name never
    matches)."""
    directory = pathlib.Path(directory)
    gens = []
    for p in directory.glob(f"{prefix}_*"):
        if re.fullmatch(re.escape(prefix) + r"_\d+(\.npz)?", p.name):
            gens.append((checkpoint_step(p), p))
    return sorted(gens)


def remove_generation(path) -> None:
    """Delete one generation, file or directory; already gone is fine."""
    path = pathlib.Path(path)
    try:
        if path.is_dir():
            shutil.rmtree(path, ignore_errors=True)
        else:
            path.unlink()
    except OSError:
        pass


def prune_generations(directory, prefix: str, ring: int,
                      good_until: int) -> None:
    """Keep the newest `ring` generations PLUS the newest one at or below
    `good_until` (the health-established rollback target); remove the
    rest."""
    gens = list_generations(directory, prefix)
    keep = {s for s, _ in gens[-ring:]}
    good = [s for s, _ in gens if s <= good_until]
    if good:
        keep.add(max(good))
    for s, p in gens:
        if s not in keep:
            remove_generation(p)


def latest_checkpoint(directory, prefix: str = "ckpt", *,
                      check_finite: bool = False,
                      distributed: bool = False,
                      max_step: Optional[int] = None,
                      deep: bool = False) -> Optional[pathlib.Path]:
    """Newest valid generation in `directory`: generations newest-first by
    the step in the name, the first that passes :func:`verify_checkpoint`
    (a corrupt or uncommitted newest one is skipped), None when none
    passes.  `max_step` restricts the scan to steps at or below it;
    `check_finite` and `deep` as in :func:`verify_checkpoint`;
    `distributed=True` verifies through
    :func:`verify_checkpoint_distributed` (one process here)."""
    gens = [(s, p) for s, p in list_generations(directory, prefix)
            if max_step is None or s <= max_step]
    verify = verify_checkpoint_distributed if distributed \
        else verify_checkpoint
    # Every artifact is a candidate: a step can hold a sharded directory
    # and a flat file, and one failing must not mask the other.
    for _, p in reversed(gens):
        if verify(p, check_finite=check_finite, deep=deep):
            return p
    return None


def _redistribute(name: str, arr: np.ndarray, meta: dict, grid) -> np.ndarray:
    """Re-tile one saved stacked array from the checkpoint's decomposition
    onto `grid` (see :func:`load_checkpoint`)."""
    from .gather import numpy_retile

    ndim = min(arr.ndim, NDIMS)
    dims_s = list(meta["dims"][:ndim])
    nxyz_s = list(meta["nxyz"][:ndim])
    over_s = list(meta["overlaps"][:ndim])
    periods = list(meta["periods"][:ndim])

    local_s, ol_s = [], []
    for d in range(ndim):
        if arr.shape[d] % dims_s[d] != 0:
            raise GridError(
                f"load_checkpoint: field '{name}' dim {d} of size "
                f"{arr.shape[d]} is not divisible by the checkpoint's "
                f"dims[{d}]={dims_s[d]}.")
        local_s.append(arr.shape[d] // dims_s[d])
        ol_s.append(over_s[d] + (local_s[d] - nxyz_s[d]))

    interior = numpy_retile(
        arr, dims_s, local_s,
        [local_s[d] - max(ol_s[d], 0) for d in range(ndim)],
        [not periods[d] for d in range(ndim)])

    # The stagger (local - base) does not depend on the decomposition; the
    # de-duplicated global sizes must agree.
    out = interior
    for d in range(ndim):
        df = local_s[d] - nxyz_s[d]
        s_b = grid.nxyz[d] + df
        ol_b = grid.overlaps[d] + df
        n_b = grid.dims[d]
        size = interior.shape[d]
        want = n_b * (s_b - ol_b) + (0 if periods[d] else ol_b)
        if size != want:
            raise GridError(
                f"load_checkpoint(redistribute=True): field '{name}' has "
                f"{size} unique cells along dim {d} but the current grid "
                f"needs {want}; the global physical domain must match.")
        # Stacked index j = c*s_b + i -> global interior index
        # c*(s_b - ol_b) + i (wrapped on periodic dims).
        idx = np.concatenate([
            (c * (s_b - ol_b) + np.arange(s_b)) % size if periods[d]
            else c * (s_b - ol_b) + np.arange(s_b)
            for c in range(n_b)])
        out = np.take(out, idx, axis=d)
    return out


# ---------------------------------------------------------------------------
# The sharded generation format (igg-sharded-v1)
# ---------------------------------------------------------------------------
#
# {path}/                      <- committed by renaming {path}.tmp/ into place
#   shard_00000.npz            <- one per grid block (cart rank): every
#   shard_00001.npz               field's local block, halo cells included,
#   ...                           and a per-shard __igg_meta__ CRC32 manifest
#   manifest.json              <- written LAST: the commit record (geometry,
#                                 per-field dtypes and local shapes,
#                                 per-shard CRC32 summaries)
#
# A field of rank < 3 spans the leading grid dims only; its block lives in
# the shard of the rank with trailing coords 0.


def _shard_name(rank: int) -> str:
    return f"shard_{rank:05d}.npz"


def _summary_crc(crcs: Dict[str, int]) -> int:
    """One CRC32 of a shard's per-field CRC32 map: what the manifest
    records per shard, tying each shard file to the write that made it."""
    return int(zlib.crc32(json.dumps(
        {k: int(v) for k, v in sorted(crcs.items())}).encode()))


def _ranks_for_field(grid, ndim: int):
    """Shard ranks holding blocks of a rank-`ndim` field: all coordinates
    over the first min(ndim, NDIMS) grid dims, trailing coords 0."""
    nd = min(ndim, NDIMS)
    for coords in itertools.product(
            *[range(grid.dims[d]) for d in range(nd)]):
        yield grid.cart_rank(tuple(coords) + (0,) * (NDIMS - nd))


def _expected_shards(grid, field_ndims) -> List[int]:
    ranks = set()
    for nd in field_ndims:
        ranks.update(_ranks_for_field(grid, nd))
    return sorted(ranks)


def _block_slices(coords, local) -> tuple:
    return tuple(slice(c * local[d], (c + 1) * local[d])
                 for d, c in enumerate(coords))


def _local_block_refs(grid, fields) -> Dict[int, Dict[str, torch.Tensor]]:
    """{shard rank: {field: block view}} for every block of the grid (all
    live in this process): views of the stacked tensors, no copy and no
    transfer.  A field of rank < 3 gives the blocks of its leading dims,
    under the trailing-0 ranks."""
    refs: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, A in fields.items():
        local = grid.local_shape(A)
        nd = min(A.ndim, NDIMS)
        for coords in itertools.product(
                *[range(grid.dims[d]) for d in range(nd)]):
            rank = grid.cart_rank(tuple(coords) + (0,) * (NDIMS - nd))
            refs.setdefault(rank, {})[name] = A[_block_slices(coords, local)]
    return refs


def _write_atomic_text(p: pathlib.Path, text: str,
                       durable: bool = False) -> None:
    """Write `text` to `p` through `p.tmp` and a rename; `durable` fsyncs
    the file before the rename and the directory after it (the commit
    record)."""
    tmp = p.with_name(p.name + ".tmp")
    if durable:
        with open(tmp, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, p)
        try:
            fd = os.open(p.parent, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass   # directory fsync unsupported here: best effort
        return
    tmp.write_text(text)
    os.replace(tmp, p)


def _ack_hellos(staging: pathlib.Path, token: str) -> None:
    """Process 0's side of the attempt handshake: answer every peer hello
    whose nonce is not yet acked with `ack_<p>` = nonce + token."""
    try:
        entries = list(staging.iterdir())
    except OSError:
        return
    for e in entries:
        m = re.fullmatch(r"hello_(\d+)", e.name)
        if not m:
            continue
        try:
            nonce = e.read_text()
        except OSError:
            continue
        ack = staging / _ACK.format(int(m.group(1)))
        try:
            if ack.read_text().split("\n", 1)[0] == nonce:
                continue
        except (OSError, ValueError):
            pass
        _write_atomic_text(ack, f"{nonce}\n{token}")


def save_checkpoint_sharded(path, /, **fields) -> None:
    """Write the named grid fields as a sharded generation DIRECTORY at
    `path` (module docstring for the format): one `shard_<rank>.npz` per
    grid block, staged one block at a time (its fields copied off the
    device, stamped, CRC'd and streamed into the shard, then released),
    then the manifest written last and the atomic `.tmp`-dir rename
    (an existing generation at `path` is renamed aside first).  Returns
    once every byte it writes has been copied off the fields, so kernels
    launched after it cannot change the generation."""
    shared.check_initialized()
    grid = shared.global_grid()
    if not fields:
        raise GridError("save_checkpoint_sharded: no fields given.")
    for name in fields:
        if name == _META_KEY:
            raise GridError(f"save_checkpoint_sharded: field name "
                            f"{_META_KEY!r} is reserved.")
    path = pathlib.Path(path)
    if path.suffix == ".npz":
        raise GridError(
            "save_checkpoint_sharded: a sharded checkpoint is a DIRECTORY "
            "generation; pass a path without the .npz suffix "
            "(save_checkpoint writes the flat single-file format).")
    _single_process("save_checkpoint_sharded")

    import uuid

    t_start = time.monotonic()
    split = dict(fetch=0.0, stamp=0.0, write=0.0)
    written_bytes = 0
    staging = path.with_name(path.name + ".tmp")
    path.parent.mkdir(parents=True, exist_ok=True)
    _sweep_stale_tmp(path.parent)
    # A staging dir at this exact name is a dead attempt's leftover: clear
    # it before answering any hello.
    if staging.is_dir():
        _rmtree_contended(staging)
    elif staging.exists():
        staging.unlink()
    staging.mkdir()
    token = uuid.uuid4().hex
    _ack_hellos(staging, token)

    dtypes = {n: _dtype_name(A.dtype) for n, A in fields.items()}
    local_shapes = {n: [int(v) for v in grid.local_shape(A)]
                    for n, A in fields.items()}
    refs = _local_block_refs(grid, fields)
    gmeta = _meta(grid)
    my_crcs: Dict[int, Dict[str, int]] = {}
    my_deep: Dict[int, Dict[str, list]] = {}
    for rank in sorted(refs):
        # One block at a time: fetch, stamp, CRC, write, release.
        crcs: Dict[str, int] = {}
        deep: Dict[str, list] = {}
        coords = grid.cart_coords(rank)
        shard = _NpzWriter(staging / _shard_name(rank))
        try:
            for name in sorted(refs[rank]):
                block = refs[rank][name]
                t0 = time.monotonic()
                raw = _slabbed_get(block, _CHUNK_BYTES)
                t1 = time.monotonic()
                deep[name] = _deep_stats(
                    raw[_owned_slice(raw.shape, coords, gmeta)],
                    _ext(dtypes[name])).tolist()
                arr = _encode(raw, dtypes[name])
                crcs[name] = _crc32(arr)
                t2 = time.monotonic()
                shard.add(name, arr)
                split["fetch"] += t1 - t0
                split["stamp"] += t2 - t1
                split["write"] += time.monotonic() - t2
                written_bytes += arr.nbytes
                del raw, arr
            smeta = {"shard": rank, "coords": list(coords),
                     "dtypes": {n: dtypes[n] for n in sorted(refs[rank])},
                     "crc32": crcs, "deep": deep}
            t0 = time.monotonic()
            shard.add(_META_KEY, _meta_array(smeta))
            shard.commit()
            split["write"] += time.monotonic() - t0
        except BaseException:
            shard.abort()
            raise
        my_crcs[rank] = crcs
        my_deep[rank] = deep
        _ack_hellos(staging, token)

    t0 = time.monotonic()
    # Every block lives in this process, so the shard set is complete
    # here; igg's wait for peers' shards (`_await_files`) waits for the
    # NCCL backend.
    expected = _expected_shards(grid, [A.ndim for A in fields.values()])
    missing = [r for r in expected if r not in my_crcs]
    if missing:
        raise GridError(f"save_checkpoint_sharded: no block staged for "
                        f"shard rank(s) {missing} of the grid.")
    shards = {}
    deep_sums: Dict[str, np.ndarray] = {}
    for r in expected:
        shards[_shard_name(r)] = _summary_crc(my_crcs[r])
        # Manifest deep stamp: element-wise sums of the per-shard partials.
        for name, stats in my_deep[r].items():
            acc = deep_sums.setdefault(name, np.zeros(3, dtype=np.float64))
            acc += np.asarray(stats, dtype=np.float64)
    for e in list(staging.iterdir()):
        if re.fullmatch(r"(hello_\d+|ack_\d+|done_\d+)(\.tmp)?", e.name):
            e.unlink()
    manifest = {"format": _FORMAT, **gmeta, "dtypes": dtypes,
                "local_shapes": local_shapes, "shards": shards,
                "attempt": token,
                "deep": _deep_meta({n: s.tolist()
                                    for n, s in deep_sums.items()})}
    # The manifest IS the commit record: fsync'd before the rename.
    _write_atomic_text(staging / _MANIFEST, json.dumps(manifest),
                       durable=True)
    # Commit: an existing generation at `path` is renamed aside (a `.tmp`
    # name the stale sweep reclaims after a crash), then replaced.
    if path.exists():
        aside = path.with_name(path.name + ".old.tmp")
        if aside.is_dir():
            shutil.rmtree(aside)
        elif aside.exists():
            aside.unlink()
        os.replace(path, aside)
        os.replace(staging, path)
        remove_generation(aside)
    else:
        os.replace(staging, path)
    split["write"] += time.monotonic() - t0
    dur = time.monotonic() - t_start
    _observe(path, written_bytes, dur, "sharded", split)


def _rmtree_contended(path, attempts: int = 8) -> None:
    """`shutil.rmtree` that survives a concurrent file creation inside the
    tree (a live peer's hello landing in a dead attempt's staging dir)."""
    import errno

    for i in range(attempts):
        try:
            shutil.rmtree(path)
            return
        except FileNotFoundError:
            return
        except OSError as e:
            if (e.errno not in (errno.ENOTEMPTY, errno.EEXIST)
                    or i == attempts - 1):
                raise
            time.sleep(0.01)


def _read_shard_meta(p: pathlib.Path) -> dict:
    """Just the `__igg_meta__` entry of one shard file."""
    try:
        with np.load(p) as z:
            if _META_KEY not in z.files:
                raise GridError(
                    f"checkpoint shard {p} has no {_META_KEY!r} entry — not "
                    f"an igg shard (or truncated before its manifest).")
            return json.loads(bytes(z[_META_KEY].tobytes()).decode())
    except GridError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError,
            json.JSONDecodeError) as e:
        raise GridError(
            f"cannot read checkpoint shard {p}: {type(e).__name__}: {e} — "
            f"missing, truncated, or corrupt.") from e


def _map_members(p: pathlib.Path) -> Dict[str, np.ndarray]:
    """Every `<name>.npy` entry of an `.npz` as an array: a copy-on-write
    map of the file where the entry is stored uncompressed in C order (the
    layout both packages write), else read whole."""
    fmt = np.lib.format
    out: Dict[str, np.ndarray] = {}
    with open(p, "rb") as fh, zipfile.ZipFile(fh) as zf:
        for info in zf.infolist():
            name = info.filename[:-len(".npy")] \
                if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as f:
                    out[name] = fmt.read_array(f, allow_pickle=False)
                continue
            fh.seek(info.header_offset)
            head = fh.read(30)
            if len(head) != 30 or head[:4] != b"PK\x03\x04":
                raise zipfile.BadZipFile(f"bad local header of {name}")
            n, m = struct.unpack("<HH", head[26:30])
            start = info.header_offset + 30 + n + m
            fh.seek(start)
            version = fmt.read_magic(fh)
            read = (fmt.read_array_header_1_0 if version == (1, 0)
                    else fmt.read_array_header_2_0)
            shape, fortran, dtype = read(fh)
            if dtype.hasobject:
                raise ValueError(f"entry {name} holds Python objects")
            off = fh.tell()
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            if off - start + nbytes != info.file_size:
                raise ValueError(f"entry {name}: {nbytes} data bytes do not "
                                 f"fill its {info.file_size}-byte entry")
            if nbytes == 0 or fortran:
                fh.seek(off)
                arr = np.frombuffer(fh.read(nbytes), dtype=dtype).reshape(
                    shape, order="F" if fortran else "C")
                out[name] = np.array(arr, order="C")
                continue
            out[name] = np.asarray(np.memmap(fh, dtype=dtype, mode="c",
                                             offset=off, shape=shape))
    return out


class _Shard:
    """One shard file of a generation, opened: its meta read, its summary
    CRC checked against the manifest (when given); each field's CRC32 is
    checked, and the field decoded and shape-checked, on first use."""

    def __init__(self, gen: pathlib.Path, fname: str, man: Optional[dict]):
        p = self.path = gen / fname
        try:
            members = _map_members(p)
            if _META_KEY not in members:
                raise GridError(
                    f"load_checkpoint: shard {p} has no {_META_KEY!r} entry "
                    f"— not an igg shard (or truncated).")
            self.meta = json.loads(bytes(members.pop(_META_KEY)).decode())
        except GridError:
            raise
        except (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError,
                struct.error, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise GridError(
                f"load_checkpoint: cannot read shard {p}: "
                f"{type(e).__name__}: {e} — missing, truncated, or corrupt "
                f"(an uncommitted or damaged generation).") from e
        self.man = man
        self.members = members
        self.crcs = self.meta.get("crc32", {})
        if man is not None and _summary_crc(self.crcs) != \
                man["shards"].get(fname):
            raise GridError(
                f"load_checkpoint: shard {p} disagrees with the generation "
                f"manifest (summary CRC32) — the shard belongs to a "
                f"different write or was swapped.")
        self.dtypes = (man or self.meta).get("dtypes", {})
        self._checked: Dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        got = self._checked.get(name)
        if got is not None:
            return got
        if name not in self.members:
            raise GridError(
                f"load_checkpoint: shard {self.path} has no field {name!r}.")
        arr = self.members[name]
        want = self.crcs.get(name)
        if want is None or _crc32(arr) != want:
            raise GridError(
                f"load_checkpoint: CRC32 mismatch for field {name!r} in "
                f"shard {self.path} — the shard is corrupt.")
        arr = _decode(arr, self.dtypes.get(name), self.path, name)
        if self.man is not None:
            want_shape = tuple(self.man.get("local_shapes", {}).get(
                name, arr.shape))
            if tuple(arr.shape) != want_shape:
                raise GridError(
                    f"load_checkpoint: field {name!r} in shard {self.path} "
                    f"has shape {tuple(arr.shape)}, manifest says "
                    f"{want_shape} — the shard is inconsistent with its "
                    f"generation.")
        self._checked[name] = arr
        return arr


def _read_shard(gen: pathlib.Path, fname: str, man: Optional[dict] = None):
    """Open and fully verify one shard of a generation: every field's CRC32
    against the shard's meta, the summary CRC against the manifest and the
    shapes against its local shapes (when `man` is given).  Returns
    `(shard meta, {field: host array})`, the arrays mapped from the file;
    `GridError` naming the path for anything inconsistent."""
    shard = _Shard(gen, fname, man)
    return shard.meta, {n: shard[n] for n in shard.members}


def _read_manifest_verified(path: pathlib.Path) -> dict:
    """The generation manifest, the commit record; a directory without one
    is an UNCOMMITTED generation and reads as invalid."""
    mp = path / _MANIFEST
    try:
        man = json.loads(mp.read_text())
    except FileNotFoundError:
        raise GridError(
            f"load_checkpoint: {path} has no {_MANIFEST} — an uncommitted "
            f"(crashed or preempted mid-commit) sharded generation, not a "
            f"valid checkpoint.") from None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise GridError(
            f"load_checkpoint: cannot read {mp}: {type(e).__name__}: {e} — "
            f"the generation manifest is corrupt.") from e
    if man.get("format") != _FORMAT:
        raise GridError(
            f"load_checkpoint: {mp} has format {man.get('format')!r}, "
            f"expected {_FORMAT!r}.")
    for key in ("nxyz", "dims", "overlaps", "periods", "nprocs", "dtypes",
                "local_shapes", "shards"):
        if key not in man:
            raise GridError(
                f"load_checkpoint: {mp} is missing the {key!r} entry — the "
                f"generation manifest is corrupt.")
    return man


def _verify_sharded(path: pathlib.Path, *, check_finite: bool,
                    part: Optional[Tuple[int, int]] = None,
                    deep: bool = False) -> bool:
    """Directory branch of :func:`verify_checkpoint`: manifest present and
    well formed, every (selected) shard present, readable, CRC- and
    summary-consistent; `check_finite` and `deep` per shard, one shard at
    a time."""
    try:
        man = _read_manifest_verified(path)
    except GridError:
        return False
    deep_man = man.get("deep") if deep else None
    if deep and (not isinstance(deep_man, dict)
                 or not isinstance(deep_man.get("sums"), dict)):
        return False
    if deep and not _invariants_ok(deep_man):
        return False
    names = sorted(man["shards"])
    if part is not None:
        i, n = part
        names = names[i::n]
    dtypes = man.get("dtypes", {})
    for fname in names:
        try:
            smeta, arrays = _read_shard(path, fname, man)
        except GridError:
            return False
        if check_finite and not _all_finite(arrays, dtypes):
            return False
        if deep:
            stamped = smeta.get("deep")
            if not isinstance(stamped, dict):
                return False
            coords = smeta.get("coords")
            if coords is None:
                return False
            for n2, a in arrays.items():
                if n2 not in stamped or not _stats_match(
                        _deep_stats(a[_owned_slice(a.shape, coords, man)],
                                    _ext(dtypes.get(n2))),
                        stamped[n2]):
                    return False
    return True


class _ShardCache:
    """Bounded LRU of opened shards (:class:`_Shard`), the streaming unit
    of the sharded loads.  A shard holds maps of its file, so an entry
    costs no host memory beyond the fields' cells a load copies out."""

    def __init__(self, path: pathlib.Path, man: dict, limit: int = 4):
        import threading

        self._path, self._man, self._limit = path, man, limit
        self._cache: Dict[str, _Shard] = {}
        self._lock = threading.Lock()

    def get(self, rank: int) -> _Shard:
        fname = _shard_name(rank)
        with self._lock:
            if fname in self._cache:
                self._cache[fname] = self._cache.pop(fname)   # LRU touch
                return self._cache[fname]
        if fname not in self._man["shards"]:
            raise GridError(
                f"load_checkpoint: generation {self._path} has no shard "
                f"{fname} — the manifest does not cover this block.")
        shard = _Shard(self._path, fname, self._man)
        with self._lock:
            while len(self._cache) >= self._limit:
                self._cache.pop(next(iter(self._cache)))
            self._cache[fname] = shard
        return shard


def _elastic_params(name: str, src_local, tgt_local, man: dict, grid):
    """Per-dim re-tiling parameters from the checkpoint's decomposition
    onto the live grid (the plane algebra of :func:`_redistribute`),
    validated up front: the de-duplicated global sizes must agree."""
    params = []
    for d in range(min(len(tgt_local), NDIMS)):
        df = src_local[d] - man["nxyz"][d]
        s_s, s_b = src_local[d], tgt_local[d]
        ol_s = man["overlaps"][d] + df
        ol_b = grid.overlaps[d] + df
        n_s, n_b = man["dims"][d], grid.dims[d]
        periodic = bool(man["periods"][d])
        keep_s = s_s - max(ol_s, 0)
        size = n_s * keep_s + (0 if periodic else max(ol_s, 0))
        want = n_b * (s_b - ol_b) + (0 if periodic else ol_b)
        if size != want:
            raise GridError(
                f"load_checkpoint(redistribute=True): field '{name}' has "
                f"{size} unique cells along dim {d} but the current grid "
                f"needs {want}; the global physical domain must match.")
        params.append(dict(keep_s=keep_s, size=size, stride_b=s_b - ol_b,
                           n_s=n_s, s_b=s_b, periodic=periodic))
    return params


def _as_slice(ix: np.ndarray):
    """A run of consecutive indices as a slice (a copy-free selection),
    other index arrays as they are."""
    if ix.size and int(ix[-1]) - int(ix[0]) == ix.size - 1 and \
            (ix.size == 1 or bool((np.diff(ix) == 1).all())):
        return slice(int(ix[0]), int(ix[-1]) + 1)
    return ix


def _assemble_block(name: str, cache: _ShardCache, man: dict, params,
                    coords, tgt_local, dtype) -> np.ndarray:
    """Rebuild ONE target block (halo cells included) of a field from the
    source shards by global indexing: target index `i` of block `c` is
    global interior cell `g = c*(s_b - ol_b) + i` (wrapped on periodic
    dims), owned by source block `min(g // keep_s, n_s - 1)` at local index
    `g - c_src*keep_s` (the inverse of the `gather_interior`
    de-duplication).  Runs of cells are copied from the mapped shards
    straight into the block."""
    nds = len(params)
    maps = []
    for d, p in enumerate(params):
        g = coords[d] * p["stride_b"] + np.arange(p["s_b"])
        if p["periodic"]:
            g %= p["size"]
        c_src = np.minimum(g // p["keep_s"], p["n_s"] - 1)
        maps.append((c_src, g - c_src * p["keep_s"]))
    out = np.empty(tuple(tgt_local), dtype=dtype)
    dims_s = man["dims"]
    for combo in itertools.product(
            *[np.unique(m[0]).tolist() for m in maps]):
        pos = [np.nonzero(maps[d][0] == combo[d])[0] for d in range(nds)]
        c3 = tuple(int(c) for c in combo) + (0,) * (NDIMS - nds)
        rank_s = c3[0] + c3[1] * dims_s[0] + c3[2] * dims_s[0] * dims_s[1]
        S = cache.get(rank_s)[name]
        sel = [_as_slice(maps[d][1][pos[d]]) for d in range(nds)]
        dst = [_as_slice(pos[d]) for d in range(nds)]
        if all(isinstance(s, slice) for s in sel + dst):
            out[tuple(dst)] = S[tuple(sel)]
        else:
            out[np.ix_(*pos)] = S[np.ix_(*[maps[d][1][pos[d]]
                                           for d in range(nds)])]
    return out


def _load_sharded(path: pathlib.Path, grid, redistribute: bool) -> Dict:
    """Directory branch of :func:`load_checkpoint`: each field is made on
    the grid's device and filled block by block (the same geometry: each
    block copied from its shard's mapped member; another: each target
    block assembled from the source shards), so host memory holds at most
    one target block."""
    from .fields import stacked_shape

    man = _read_manifest_verified(path)
    mine = _meta(grid)
    same_geometry = {k: man.get(k) for k in mine} == mine
    if not same_geometry and not redistribute:
        diffs = {k: (man.get(k), mine[k]) for k in mine
                 if man.get(k) != mine[k]}
        raise GridError(
            f"load_checkpoint: grid geometry mismatch {diffs} "
            f"(checkpoint vs current).  Pass redistribute=True to re-tile "
            f"the sharded generation onto the current decomposition "
            f"(elastic restore).")
    if not same_geometry and list(man["periods"]) != mine["periods"]:
        raise GridError(
            f"load_checkpoint(redistribute=True): periodicity mismatch "
            f"{man['periods']} vs {mine['periods']} — redistribution "
            f"changes the decomposition, not the physics.")

    # Every shard stays open (maps only) so each field's CRC is checked
    # once, whatever the order the blocks read them in.
    cache = _ShardCache(path, man, limit=max(4, len(man["shards"])))
    out = {}
    for name in sorted(man["local_shapes"]):
        src_local = [int(v) for v in man["local_shapes"][name]]
        nd = len(src_local)
        nds = min(nd, NDIMS)
        tgt_local = [grid.nxyz[d] + (src_local[d] - man["nxyz"][d])
                     if d < NDIMS else src_local[d] for d in range(nd)]
        if any(s < 1 for s in tgt_local):
            raise GridError(
                f"load_checkpoint: field '{name}' has local shape "
                f"{tgt_local} on the current grid — the stagger recorded "
                f"in {path} does not fit it.")
        dname = man["dtypes"][name]
        try:
            dtype = _host_dtype_of(dname)
            tdtype = _torch_dtype(dname)
        except (TypeError, ValueError) as e:
            raise GridError(
                f"load_checkpoint: corrupt dtypes manifest for field "
                f"{name!r} in {path} ({e}).") from e
        params = (None if same_geometry
                  else _elastic_params(name, src_local, tgt_local, man, grid))
        T = torch.empty(stacked_shape(tgt_local, grid), dtype=tdtype,
                        device=grid.device)
        for coords in itertools.product(
                *[range(grid.dims[d]) for d in range(nds)]):
            if params is None:
                rank = grid.cart_rank(tuple(coords) + (0,) * (NDIMS - nds))
                block = cache.get(rank)[name]
            else:
                block = _assemble_block(name, cache, man, params, coords,
                                        tgt_local, dtype)
            src = torch.from_numpy(block)
            if tdtype != src.dtype:
                src = src.view(tdtype)
            T[_block_slices(coords, tgt_local)].copy_(src)
            del block, src
        out[name] = T
    return out
