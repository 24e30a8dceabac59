"""The autotuner: a measured route search keyed by signature, with a
persistent tuning cache (the port of `igg/autotune.py`).

- **The search** (:func:`search`): for the signature `(family,
  local_shape, dtype, dims, backend, device_kind)` of the live grid (the
  perf ledger's axes without the tier), each candidate route of the family
  (:func:`candidates_for`: tier, K, bx, band, overlap) is built through
  the family's factory pinned to it (``tune=False``) on the family's
  default float32 fields, run once to warm up, checked to be served by
  its own tier, timed once (the quick sample) and, unless that sample
  exceeds ``IGG_TUNE_CUTOFF`` times the best quick sample so far, slope
  timed (:func:`igg_torch.time_steps`, batches of ``IGG_TUNE_NT`` and
  three times as many calls).  The ledger's :func:`igg_torch.perf.best`
  for this signature orders the walk, so the likely winner sets the
  cutoff first.  Every sample lands in the ledger (source
  ``"autotune"``).

- **The tuning cache**: winners persist in a versioned JSON file
  (``IGG_TUNE_CACHE``, format ``igg-tune-cache-v1``, igg's field for
  field) with atomic merge-on-write saves (the newest ``updated_wall``
  wins per key).  A process that finds its signature in the cache serves
  the winner with no search dispatch (:func:`search_dispatches`); a
  corrupt cache file is never fatal.

- **The application** (:func:`applied`, at factory time only): the
  factories take ``tune="auto"|True|False`` (None: the ``IGG_TUNE``
  knob).  "auto" applies a cached winner wherever the caller left the
  defaults (`igg_torch.models._dispatch.apply_tuned`); True also searches
  on a miss; False ignores the cache.  Explicit arguments always win.

- **Staleness** (:func:`invalidate`): `igg_torch.perf.invalidate` evicts
  the family's winners from memory and from the file, and emits
  ``tune_invalidated``.

Deliberate differences from igg: the tier names are the port's (igg's
map onto them through :func:`igg_torch.perf.port_tier` when a winner is
served); there is no VMEM axis (the kernels' shared memory is fixed per
design, `igg_torch/ops/_smem.py`), so ``vmem_mb`` is None in every entry
the port writes and :func:`applied` installs no cap; and the overlapped
winner's confirmation (:func:`_overlap_confirmed`) records its
decomposition under the port's tier, ``overlap.<family>.overlap.*``,
where igg writes ``overlap.<family>.xla+overlap.*``.
"""

from __future__ import annotations

import json
import math
import pathlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import _env
from . import perf
from . import telemetry as _telemetry
from .shared import GridError

__all__ = ["TUNE_FORMAT", "applied", "cache_path", "candidates_for", "get",
           "invalidate", "load", "record_winner", "register_family",
           "registered_families", "reset", "resolve", "save", "search",
           "search_dispatches"]

TUNE_FORMAT = "igg-tune-cache-v1"

_lock = threading.RLock()
_CACHE: Dict[Tuple, Dict] = {}
_LOADED: set = set()           # cache files already lazily loaded
_SEARCH_DISPATCHES = 0         # timed search dispatches of this process

# Registered families (spec families among them): `candidates(grid, *,
# n_inner) -> [candidate dicts]` and `build(cand, *, n_inner, params) ->
# (state_fn, args)`.  The four built-ins are the fallback.
_FAMILY_REGISTRY: Dict[str, Dict] = {}


def register_family(name: str, *, candidates, build) -> None:
    """Register a family's search providers (idempotent;
    `igg_torch.stencil.compile` calls it for every compiled spec)."""
    with _lock:
        _FAMILY_REGISTRY[str(name)] = {"candidates": candidates,
                                       "build": build}


def registered_families() -> Dict[str, Dict]:
    with _lock:
        return dict(_FAMILY_REGISTRY)


# ---------------------------------------------------------------------------
# Configuration / keys
# ---------------------------------------------------------------------------

def resolve(tune):
    """The factories' ``tune=`` contract: None defers to ``IGG_TUNE``
    ("0" -> False, "1" -> True, unset or "auto" -> "auto"); otherwise
    False, True or "auto"."""
    if tune is None:
        raw = (_env.text("IGG_TUNE") or "auto").strip().lower()
        if raw in ("0", "false", "off", "no"):
            return False
        if raw in ("1", "true", "on", "yes"):
            return True
        if raw == "auto":
            return "auto"
        raise GridError(f"IGG_TUNE={raw!r}: expected 0, 1, or auto.")
    if tune in (False, True, "auto"):
        return tune
    raise GridError(f"tune={tune!r}: expected None, False, True, or "
                    f"'auto'.")


def cache_path() -> Optional[pathlib.Path]:
    """The configured on-disk tuning cache (``IGG_TUNE_CACHE``),
    rank-tagged where a process group is initialized.  None when unset:
    the cache then lives in memory only."""
    return perf._rank_path("IGG_TUNE_CACHE")


def search_dispatches() -> int:
    """Timed search dispatches of this process: a process that serves a
    cached winner keeps it at zero."""
    return _SEARCH_DISPATCHES


def _key(family, local_shape, dtype, dims, backend, device_kind) -> Tuple:
    """The perf ledger's key without the tier."""
    k = perf._key(family, "", local_shape, dtype, dims, backend,
                  device_kind)
    return k[:1] + k[2:]


def _entry_key(e: Dict) -> Tuple:
    return _key(e["family"], e.get("local_shape") or (),
                e.get("dtype", "float32"), e.get("dims"),
                e.get("backend"), e.get("device_kind"))


def _context(family: str, local_shape=None) -> Dict:
    """Signature axes from the live grid and device (the ledger's key
    without the tier); igg's block shape: `nxyz`, its first two for
    wave2d."""
    from . import shared

    ctx = perf.device_context()
    ctx["dims"] = (tuple(shared.global_grid().dims)
                   if shared.grid_is_initialized() else None)
    if local_shape is None and shared.grid_is_initialized():
        grid = shared.global_grid()
        local_shape = (tuple(grid.nxyz[:2]) if family == "wave2d"
                       else tuple(grid.nxyz))
    ctx["local_shape"] = tuple(local_shape or ())
    return ctx


def _live_key(family: str, local_shape, dtype) -> Tuple:
    ctx = _context(family, local_shape)
    return _key(family, ctx["local_shape"], dtype, ctx["dims"],
                ctx["backend"], ctx["device_kind"])


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

def _lazy_load() -> None:
    """Merge the configured cache file into memory, once per path."""
    target = cache_path()
    if target is None:
        return
    pkey = str(target)
    with _lock:
        if pkey in _LOADED:
            return
        _LOADED.add(pkey)
    if target.exists():
        try:
            load(target)
        except GridError:
            pass   # a corrupt cache is re-tuned, never fatal


def get(family: str, local_shape=None, dtype="float32") -> Optional[Dict]:
    """The cached winner for this signature on the live grid and device,
    or None.  A dict lookup (and a one-time lazy file load); no device
    work."""
    _lazy_load()
    k = _live_key(family, local_shape, dtype)
    with _lock:
        e = _CACHE.get(k)
        return dict(e) if e else None


def record_winner(family: str, winner: Dict, *, local_shape=None,
                  dtype="float32", source: str = "search",
                  persist: bool = True) -> Dict:
    """Install a winner for this signature (and persist it where a cache
    path is configured)."""
    k = _live_key(family, local_shape, dtype)
    e = {"family": family, "local_shape": list(k[1]), "dtype": k[2],
         "dims": list(k[3]) if k[3] else None, "backend": k[4],
         "device_kind": k[5],
         "tier": winner.get("tier"), "K": winner.get("K"),
         "bx": winner.get("bx"), "band": winner.get("band"),
         "vmem_mb": None,
         "overlap": bool(winner.get("overlap", False)),
         "ms": winner.get("ms"), "source": source,
         "updated_wall": time.time()}
    with _lock:
        _CACHE[k] = e
    _telemetry.emit("autotune_winner", **{kk: vv for kk, vv in e.items()
                                          if kk != "updated_wall"})
    if persist:
        save()
    return dict(e)


def reset() -> None:
    """Clear the in-memory cache, the lazy-load memory, the search count
    and the registered families (the file is untouched)."""
    global _SEARCH_DISPATCHES
    with _lock:
        _CACHE.clear()
        _LOADED.clear()
        _FAMILY_REGISTRY.clear()
        _SEARCH_DISPATCHES = 0


def invalidate(family: str, tier: Optional[str] = None) -> int:
    """Evict `family`'s winners (optionally only those serving `tier`)
    from memory and from the on-disk cache, so a drifted machine re-tunes
    instead of serving a stale winner.  Returns the number evicted."""
    with _lock:
        keys = [k for k, e in _CACHE.items()
                if k[0] == family and (tier is None or e.get("tier") == tier)]
        for k in keys:
            del _CACHE[k]
    n = len(keys)
    # Merge-on-write would bring the entry back from the file at the next
    # save, so the file is rewritten without it.
    target = cache_path()
    if target is not None and target.exists():
        try:
            doc = json.loads(target.read_text())
            entries = doc.get("entries", {}) if isinstance(doc, dict) else {}
            kept = {ks: e for ks, e in entries.items()
                    if not (isinstance(e, dict) and e.get("family") == family
                            and (tier is None or e.get("tier") == tier))}
            n = max(n, len(entries) - len(kept))
            perf._write_doc(target, {
                "format": TUNE_FORMAT, "saved_wall": time.time(),
                "process": _telemetry._process(), "entries": kept})
        except (OSError, json.JSONDecodeError):
            pass
    if n:
        _telemetry.emit("tune_invalidated", family=family, tier=tier,
                        entries=n)
    return n


def _read_cache_file(path) -> List[Dict]:
    path = pathlib.Path(path)
    try:
        doc = json.loads(path.read_text())
    except OSError as e:
        raise GridError(f"igg_torch.autotune: cannot read cache {path}: {e}")
    except json.JSONDecodeError as e:
        raise GridError(f"igg_torch.autotune: {path} is not valid JSON "
                        f"({e}).")
    if not isinstance(doc, dict) or doc.get("format") != TUNE_FORMAT:
        raise GridError(
            f"igg_torch.autotune: {path} is not an {TUNE_FORMAT} cache "
            f"(format="
            f"{doc.get('format') if isinstance(doc, dict) else '?'!r}).")
    return [e for e in doc.get("entries", {}).values()
            if isinstance(e, dict)]


def save(path=None) -> Optional[pathlib.Path]:
    """Persist the cache: read the file, merge (the newest
    ``updated_wall`` wins per key), replace it atomically.  `path`
    defaults to :func:`cache_path`; with neither, a no-op returning
    None."""
    target = pathlib.Path(path) if path is not None else cache_path()
    if target is None:
        return None
    on_disk: List[Dict] = []
    if target.exists():
        try:
            on_disk = _read_cache_file(target)
        except GridError:
            on_disk = []   # a corrupt cache is replaced, not fatal
    merged: Dict[Tuple, Dict] = {}
    for e in on_disk:
        merged[_entry_key(e)] = e
    with _lock:
        for k, e in _CACHE.items():
            have = merged.get(k)
            if (have is None or e.get("updated_wall", 0)
                    >= have.get("updated_wall", 0)):
                merged[k] = dict(e)
    doc = {"format": TUNE_FORMAT, "saved_wall": time.time(),
           "process": _telemetry._process(),
           "entries": {perf._key_str(k): e for k, e in merged.items()}}
    try:
        perf._write_doc(target, doc)
    except OSError:
        return None   # a full or read-only disk must never kill the run
    return target


def load(path=None, *, replace: bool = False) -> int:
    """Load a cache file into memory (merging, the newest wins;
    ``replace=True`` clears first).  Returns the number of entries in
    memory; raises `GridError` on an unreadable or foreign file."""
    target = pathlib.Path(path) if path is not None else cache_path()
    if target is None:
        raise GridError("igg_torch.autotune.load: no path given and "
                        "IGG_TUNE_CACHE is unset.")
    entries = _read_cache_file(target)
    with _lock:
        if replace:
            _CACHE.clear()
        for e in entries:
            k = _entry_key(e)
            have = _CACHE.get(k)
            if (have is None or e.get("updated_wall", 0)
                    >= have.get("updated_wall", 0)):
                _CACHE[k] = e
        return len(_CACHE)


# ---------------------------------------------------------------------------
# The application (factory time)
# ---------------------------------------------------------------------------

def applied(family: str, tune, *, n_inner: int = 8,
            params=None) -> Optional[Dict]:
    """The factories' entry point: resolve ``tune=``, look up the cached
    winner of this signature, search on a miss when ``tune=True``, and
    return the winner with its tier in the port's names (None where tuning
    is off, no grid is initialized, or there is no winner).  Host work at
    factory time only."""
    from . import shared

    mode = resolve(tune)
    if mode is False or not shared.grid_is_initialized():
        return None
    w = get(family)
    if w is None and mode is True:
        w = search(family, n_inner=n_inner, params=params)
    if w is not None:
        w["tier"] = perf.port_tier(w.get("tier"), bool(w.get("overlap")))
    return w


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

# (hide_communication read radius, decomposition rank) per built-in: the
# admission geometry of each family's overlapped candidate.
_OVERLAP_GEOMETRY = {"diffusion3d": (1, 3), "stokes3d": (2, 3),
                     "hm3d": (1, 3), "wave2d": (2, 2)}


def _meta(grid, local_shape, dtype):
    """A stacked grid array's shape and dtype, with no storage (for the
    kernel gates that read only those)."""
    import torch

    dims = tuple(grid.dims) + (1,) * len(local_shape)
    return torch.empty([s * d for s, d in zip(local_shape, dims)],
                       dtype=dtype, device="meta")


def candidates_for(family: str, *, n_inner: int = 8) -> List[Dict]:
    """The candidate routes of `family` on the live grid, each a dict of
    the factory arguments the search pins (tier, K, bx, band, overlap;
    ``vmem_mb`` None): the plain truth tier, the overlapped composition
    where its admission passes, the per-step kernel tier (diffusion: one
    per bx of 4, 8, 16 dividing the block's x extent), every chunk depth
    of 4 and 8 the chunk route admits and every `(K, B)` of (4, 8) × (8,
    16) the banded tier admits."""
    import torch

    from . import shared
    from .overlap import overlap_admission

    grid = shared.global_grid()
    reg = _FAMILY_REGISTRY.get(family)
    if reg is not None:
        return reg["candidates"](grid, n_inner=n_inner)
    if family not in _OVERLAP_GEOMETRY:
        raise GridError(
            f"igg_torch.autotune: unknown family {family!r} (built-ins: "
            f"diffusion3d, stokes3d, hm3d, wave2d; registered: "
            f"{sorted(_FAMILY_REGISTRY) or 'none'}; "
            f"igg_torch.autotune.register_family hooks new ones in).")
    shape = (tuple(grid.nxyz[:2]) if family == "wave2d"
             else tuple(grid.nxyz))
    dtype = torch.float32
    n = n_inner - 1
    out: List[Dict] = [{"tier": f"{family}.plain", "K": None, "bx": None,
                        "vmem_mb": None}]

    def cand(route, K=None, **kw):
        return {"tier": f"{family}.{route}", "K": K, "bx": None,
                "vmem_mb": None, **kw}

    def chunk_ks(refusal, route):
        return [cand(route, K) for K in (4, 8)
                if n_inner >= 3 and refusal(grid, shape, K, n, dtype) is None]

    def banded(refusal):
        return [cand("banded", K, band=B) for K in (4, 8) for B in (8, 16)
                if n_inner >= 3
                and refusal(grid, shape, K, n, dtype, B=B) is None]

    if family == "diffusion3d":
        from .ops import diffusion_pallas as dp
        from .ops import diffusion_trapezoid as dtz

        if dp.kernel_refusal(grid, _meta(grid, shape, dtype)) is None:
            out += [dict(cand("cuda", bx), bx=bx) for bx in (4, 8, 16)
                    if shape[0] % bx == 0]
        out += banded(dtz.banded_refusal)
    elif family == "stokes3d":
        from .ops import stokes_trapezoid as stz

        out.append(cand("cuda"))
        out += chunk_ks(stz.stokes_chunk_refusal, "trapezoid")
        out += banded(stz.stokes_banded_refusal)
    elif family == "hm3d":
        from .ops import hm3d_trapezoid as htz

        out.append(cand("cuda"))
        # On one block the K-step loop serves every multi-step call.
        if not (grid.dims == (1, 1, 1) and n_inner >= 2):
            out += chunk_ks(htz.hm3d_trapezoid_refusal, "trapezoid")
        out += banded(htz.hm3d_banded_refusal)
    else:
        from .ops import wave2d_trapezoid as wtz

        out.append(cand("cuda"))
        out += chunk_ks(wtz.wave2d_chunk_refusal, "chunk")
        # The streaming band kernel is 3-D only: the banded tier serves
        # wave2d on CPU tensors alone.
        if grid.device.type == "cpu":
            out += banded(wtz.wave2d_banded_refusal)
    radius, nd = _OVERLAP_GEOMETRY[family]
    if overlap_admission(radius, grid=grid, ndim=nd):
        out.insert(1, {"tier": f"{family}.overlap", "K": None, "bx": None,
                       "vmem_mb": None, "overlap": True})
    return out


def _knobs(family: str, cand: Dict) -> Dict:
    """The factory arguments pinning a candidate's route (``tune=False``,
    so the search never recurses into itself)."""
    route = cand["tier"].rpartition(".")[2]
    fast = route not in ("plain", "overlap")
    kw = dict(use_kernels="auto" if fast else False,
              overlap=bool(cand.get("overlap")) or route == "overlap",
              banded=route == "banded", K=cand.get("K"),
              band=cand.get("band"), tune=False)
    if family in ("stokes3d", "hm3d"):
        kw["trapezoid"] = route == "trapezoid"
    elif family != "diffusion3d":
        kw["chunk"] = route == "chunk"
    else:
        kw["bx"] = cand.get("bx")
        if route != "banded":
            kw["K"] = None
    return kw


def _build_candidate(family: str, cand: Dict, n_inner: int, params):
    """(state_fn, args) of one candidate: the family's factory pinned to
    the candidate, on the family's default float32 fields."""
    import torch

    reg = _FAMILY_REGISTRY.get(family)
    if reg is not None:
        return reg["build"](cand, n_inner=n_inner, params=params)
    kw = _knobs(family, cand)
    if family == "diffusion3d":
        from .models import diffusion3d as m

        p = params or m.Params()
        T, Cp = m.init_fields(p, dtype=torch.float32)
        step = m.make_multi_step(n_inner, p, **kw)
        return (lambda T, Cp: (step(T, Cp), Cp)), (T, Cp)
    if family == "stokes3d":
        from .models import stokes3d as m

        p = params or m.Params()
        fields = m.init_fields(p, dtype=torch.float32)
        it = m.make_iteration(p, n_inner=n_inner, **kw)
        return (lambda P, Vx, Vy, Vz, Rho:
                it(P, Vx, Vy, Vz, Rho) + (Rho,)), tuple(fields)
    if family == "hm3d":
        from .models import hm3d as m

        p = params or m.Params()
        fields = m.init_fields(p, dtype=torch.float32)
        step = m.make_multi_step(n_inner, p, **kw)
        return (lambda Pe, phi: step(Pe, phi)), tuple(fields)
    if family == "wave2d":
        from .models import wave2d as m

        p = params or m.Params()
        fields = m.init_fields(p, dtype=torch.float32)
        step = m.make_multi_step(n_inner, p, **kw)
        return (lambda P, Vx, Vy: step(P, Vx, Vy)), tuple(fields)
    raise GridError(f"igg_torch.autotune: unknown family {family!r}.")


def _cand_label(cand: Dict) -> str:
    bits = [cand["tier"]]
    if cand.get("overlap"):
        bits.append("overlap")
    if cand.get("K"):
        bits.append(f"K={cand['K']}")
    if cand.get("bx"):
        bits.append(f"bx={cand['bx']}")
    if cand.get("band"):
        bits.append(f"band={cand['band']}")
    return "[" + ",".join(bits) + "]"


def search(family: str, *, n_inner: int = 8, params=None,
           nt: Optional[int] = None,
           candidates: Optional[Sequence[Dict]] = None,
           cutoff: Optional[float] = None,
           source: str = "autotune") -> Optional[Dict]:
    """Measure the candidates of `family`'s live signature and install the
    winner in the tuning cache (module docstring).  A candidate that fails
    to build or run, or that its factory serves on another tier, emits
    ``autotune_candidate_failed``: on CPU tensors it is skipped, as igg
    skips it; on the card it raises `GridError` naming it and nothing is
    cached, because a kernel that fails to build or launch there raises
    and never gives way to another route.  Every measured candidate emits
    ``autotune_sample`` (its label, quick sample, ms per step and whether
    it was cut off).  Returns the winner's entry (None when nothing could
    be measured)."""
    global _SEARCH_DISPATCHES
    from . import degrade, shared
    from .timing import _sync, time_steps

    shared.check_initialized()
    nt = int(nt if nt is not None else _env.number("IGG_TUNE_NT", 2))
    cutoff = float(cutoff if cutoff is not None
                   else _env.number("IGG_TUNE_CUTOFF", 2.0))
    cands = list(candidates if candidates is not None
                 else candidates_for(family, n_inner=n_inner))
    if not cands:
        return None

    on_card = shared.global_grid().device.type == "cuda"
    ctx = _context(family)
    # The prior orders the walk; evidence of another backend, device or
    # decomposition does not.
    prior = perf.best(family, local_shape=ctx["local_shape"] or None,
                      dims=ctx["dims"], backend=ctx["backend"],
                      device_kind=ctx["device_kind"])
    if prior is not None:
        first = perf.port_tier(prior["tier"])
        cands.sort(key=lambda c: 0 if c["tier"] == first else 1)

    results = []
    best_quick = None
    for cand in cands:
        label = _cand_label(cand)
        try:
            state_fn, args = _build_candidate(family, cand, n_inner, params)
            out = state_fn(*(a.clone() for a in args))   # warm-up
            _sync(out)
            served = degrade.active().get(family)
            if served != cand["tier"]:
                raise GridError(f"the pinned factory served {served}, not "
                                f"{cand['tier']}")
            t0 = time.monotonic()
            out = state_fn(*out)
            _sync(out)
            quick = (time.monotonic() - t0) / n_inner * 1e3
            _SEARCH_DISPATCHES += 1
            cut = best_quick is not None and quick > cutoff * best_quick
            if not cut:
                _, sec = time_steps(state_fn, out, n1=nt, n2=3 * nt,
                                    warmup=0)
                _SEARCH_DISPATCHES += 4 * nt
                ms = sec / n_inner * 1e3
            else:
                ms = quick
            best_quick = quick if best_quick is None else min(best_quick,
                                                              quick)
            del out, args
        except Exception as e:   # an inadmissible or failing candidate
            _telemetry.emit("autotune_candidate_failed", family=family,
                            candidate=label,
                            error=f"{type(e).__name__}: {e}")
            if on_card:
                raise GridError(
                    f"igg_torch.autotune.search({family!r}): candidate "
                    f"{label} failed on the card ({type(e).__name__}: {e}); "
                    f"a card search never skips a route that fails") from e
            continue
        perf.record(family, cand["tier"], ms, source=source,
                    local_shape=ctx["local_shape"], dtype="float32",
                    dims=ctx["dims"], backend=ctx["backend"],
                    device_kind=ctx["device_kind"])
        _telemetry.emit("autotune_sample", family=family, candidate=label,
                        ms_per_step=ms, quick_ms_per_step=quick,
                        cutoff=bool(cut))
        results.append((ms, cand))
    if not results:
        return None
    results.sort(key=lambda r: r[0] if math.isfinite(r[0]) else math.inf)
    ms, best = results[0]
    if best.get("overlap"):
        confirmed, d = _overlap_confirmed(family, params, n_inner)
        if not confirmed:
            # The overlapped route won the timing, but the measured
            # decomposition shows no exposed communication hidden (hidden
            # >= exchange): demote it to the best sequential candidate.
            # The decomposition is in the ledger (family "comm").
            seq = next((r for r in results if not r[1].get("overlap")),
                       None)
            _telemetry.emit(
                "overlap_demoted", family=family, overlapped_ms=ms,
                demoted_to=_cand_label(seq[1]) if seq else None,
                **{k: d[k] for k in ("compute_ms", "exchange_ms",
                                     "hidden_ms")})
            if seq is not None:
                ms, best = seq
    winner = dict(best, ms=ms)
    return record_winner(family, winner, local_shape=ctx["local_shape"])


def _overlap_confirmed(family: str, params, n_inner: int
                       ) -> Tuple[bool, Optional[Dict]]:
    """Whether an overlapped winner is kept: an in-search
    :func:`igg_torch.comm.decompose` must show the hidden variant beating
    the plain exchange, attributed to the ``"<family>.overlap"`` serving
    configuration in the comm ledger.  Returns ``(verdict, decomposition
    or None)``.  A family with no step-variant recipe (a spec family)
    passes on the timing alone.  A decomposition that fails emits
    ``overlap_confirm_failed``: on CPU tensors the winner then stays, as
    in igg; on the card it raises `GridError` naming the family."""
    import torch

    from . import comm, shared

    try:
        mv = comm.model_step_variants(family, params)
    except GridError:
        return True, None
    try:
        fields = mv["init"](torch.float32)
        d = comm.decompose(mv["compute"], fields[:mv["nf"]],
                           aux=fields[mv["nf"]:], radius=mv["radius"],
                           nt=2, n_inner=max(2, int(n_inner) // 2),
                           config=f"{family}.overlap")
    except Exception as e:
        _telemetry.emit("overlap_confirm_failed", family=family,
                        error=f"{type(e).__name__}: {e}")
        if shared.global_grid().device.type == "cuda":
            raise GridError(
                f"igg_torch.autotune: the overlap confirmation of "
                f"{family} failed on the card ({type(e).__name__}: {e}); "
                f"a card search never keeps a winner it could not "
                f"measure") from e
        return True, None
    return d["hidden_ms"] < d["exchange_ms"], d
