"""Communication/computation overlap: the port's `hide_communication`
(`igg.overlap`).

The reference leaves comm/compute overlap to the caller: it provides
max-priority copy streams, and an application layer (ParallelStencil's
`@hide_communication`) computes the domain interior while `update_halo!`'s
messages are in flight (the reference's `update_halo.jl:337,365`).  In the
plain composition

    A' = compute(A); update_halo(A')

the exchange reads planes of `A'`, so the whole update must finish before
the first plane moves.  :func:`hide_communication` restructures the step:
the send planes come from thin *slab* computations (two per exchanged
dimension, `(1 + 2r)` planes plus the staggers), the dimension-sequential
plane exchange (corner propagation intact, `igg_torch.halo.
exchange_all_dims_grouped`) runs on those, and the full-domain `compute`
does not depend on any of it.  The received planes are then written into
the full compute's output in dimension order, on a CUDA tensor by ONE
launch of the halo writer per field (`igg_torch.ops.halo_write`, the
`"ext"` source for every exchanged dim, `"wrap"` for a periodic dim of one
block; `plain=True` takes the writer's plain version, as
:func:`igg_torch.update_halo` does).  Cost: a few boundary planes
recomputed, O(s^2) work against the O(s^3) interior.

Semantics are igg's (`igg/overlap.py`): for slice-based computes (every
model of `igg_torch.models`; anything whose values on a block's outermost
planes read only cells inside the slab) the result equals
`update_halo(compute(A))` everywhere, open-boundary planes included: the
no-write fallback planes of an open edge are taken from the slab outputs
too.  PyTorch applies the same operation to every element whatever the
tensor's extent, so the port's slab and full computes agree to the bit,
and the overlapped result is bitwise the sequential one.

Two forms:

- **On stacked grid arrays** (the factories' form).  Every block's slab
  along `d` is cut by one `index_select` over `halo.block_rows`, and
  `compute` runs once on the stacked slabs: the port's computes find a
  block's extent as the array's extent over `grid.dims`
  (`GlobalGrid.local_shape_any`), so a stack of slabs is a grid of blocks
  of the slab's extent.  On CUDA tensors the slab cuts, slab computes,
  plane extraction (two or more y/z planes of a slab output by one launch
  of the plane packer, `halo.extract_planes`) and the exchange run on a
  side stream of the highest priority, cached per device, which first
  waits for an event recorded on the caller's stream at the call (the
  inputs are ready) and records an event at the end.  The full compute
  runs on the caller's stream, which waits for that event and then
  launches the halo writer.  The host enqueues the full compute first and
  the side stream's work after it, so that the card has the full compute
  queued while the host launches the many small slab kernels, and runs
  them beside it.  The received planes, allocated on the side stream and
  read by the writer, are `record_stream`-ed onto the caller's stream.
  No host synchronisation anywhere.  On CPU tensors the same operations
  run in the same order, with no streams.
- **Inside** :func:`igg_torch.sharded` **on local blocks** (igg's form).
  Each block cuts and computes its own slabs; the exchange is a
  collective, like `update_halo_local` (every block's planes stacked, one
  grouped exchange, each block's received planes handed back); each block
  then runs the full compute and writes its own halo.  No side stream.

Requirements on `compute`: a shift-invariant local stencil of radius
`<= ol-1` per participating dimension, accepting any extent along the
grid dimensions, returning NEW tensors of its inputs' shapes (one, or a
tuple matching the primaries).  `radius` counts the whole dependency
chain (a Gauss-Seidel chain whose later updates read earlier ones, as in
Stokes, has radius 2 and needs overlap >= 3).  The inputs are read on the
side stream while the caller's stream runs the full compute, so a
`compute` that writes its inputs in place is refused: `hide_communication`
raises `GridError` when the full compute changed the inputs (before any
slab work is enqueued) or a slab computation changed its slab arrays.  An
output that IS one of the inputs is copied before its halo is written, so
the caller's arrays never change.

Observability (igg's): one `igg_hide_communication_traces_total`
increment, one `hide_communication` bus record and one
`overlap.hide_communication` span where igg would trace the restructuring,
which the port, running eagerly, counts as the first call of each
argument signature (grid epoch, form, compute code, radius, `plain`, and
each array's shape, dtype and device, as the factories' route verdicts are
keyed): a loop of 1000 calls counts 1, as igg's compiled loop does.

:func:`overlap_admission` and :func:`resolve_overlap` are igg's serving
contract of the factories' `overlap="auto"/True/False` (the `IGG_OVERLAP`
knob, then the autotuner's winner, which the port does not have yet, then
off; a refusal under "auto" is logged under `<family>.overlap` and served
by the sequential composition).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from . import shared
from . import telemetry as _telemetry
from .halo import (active_dims, block_rows, exchange_all_dims_grouped,
                   extract_planes, moving_dims, wrap_dims)
from .shared import GridError

__all__ = ["hide_communication", "overlap_admission", "resolve_overlap"]

# Argument signatures already seen (the trace-count rule, module docstring).
_TRACED: set = set()
# The side stream of each CUDA device (module docstring).
_SIDE: Dict[int, "torch.cuda.Stream"] = {}
# Slab row indices, keyed by (device, blocks, block extent, lo, extent).
_ROWS: Dict[Tuple, torch.Tensor] = {}


def hide_communication(A, compute: Callable, *aux, radius: int = 1,
                       plain: bool = False):
    """`update_halo(compute(A, *aux))` with the halo exchange independent of
    the full-domain compute (module docstring).  `A` is a grid array, or a
    tuple of them for a multi-field step (`compute` then returns the
    matching tuple); `aux` are read-only coefficient arrays of any stagger.
    On stacked grid arrays, or inside :func:`igg_torch.sharded` on local
    blocks.  Returns the updated array(s), new tensors."""
    shared.check_initialized()
    grid = shared.global_grid()
    single = not isinstance(A, (tuple, list))
    fields = (A,) if single else tuple(A)
    if not fields:
        raise GridError("hide_communication: no fields given.")
    arrays = (*fields, *aux)
    local = [tuple(grid.local_shape_any(B)) for B in arrays]
    s0 = local[0]
    dims_base = active_dims(s0, grid)
    base_dims = [d for d, _ in dims_base]
    per_field_dims = []
    for i, s in enumerate(local[:len(fields)]):
        dims_f = active_dims(s, grid)
        if [d for d, _ in dims_f] != base_dims:
            raise GridError(
                f"hide_communication: field {i} (local shape {s}) has "
                f"halos in dims {[d for d, _ in dims_f]} but the base field "
                f"has {base_dims}; all primary fields must share the same "
                f"exchanged dimensions.")
        for d, ol in dims_f:
            if radius > ol - 1:
                raise GridError(
                    f"hide_communication: stencil radius {radius} exceeds "
                    f"ol-1={ol - 1} for field {i} along dimension {d}; the "
                    f"send planes cannot be computed from in-block data "
                    f"(initialize the grid with a larger overlap).")
        per_field_dims.append(dims_f)
    windows = _windows(dims_base, local, len(fields), radius)

    from .parallel import _block_context
    ctx = _block_context()
    run = lambda: _hide(fields, aux, compute, windows, per_field_dims,  # noqa: E731
                        local, single, plain, grid, ctx)
    key = ((shared.grid_epoch(), ctx is None,
            getattr(compute, "__code__", compute), int(radius), bool(plain))
           + tuple((tuple(B.shape), B.dtype, B.device) for B in arrays))
    if key in _TRACED:
        return run()
    if len(_TRACED) >= 4096:
        _TRACED.clear()
    _TRACED.add(key)
    _telemetry.counter("igg_hide_communication_traces_total").inc()
    _telemetry.emit("hide_communication", n_fields=len(fields),
                    radius=radius, dims=base_dims, plain=plain)
    with _telemetry.span("overlap.hide_communication",
                         n_fields=len(fields), radius=radius):
        return run()


def _windows(dims_base, local, nf: int, radius: int) -> Dict:
    """The slab windows `{(d, side): (lo, E, send plane of each primary in
    slab coordinates)}` of every active dim, with igg's window algebra and
    its check (`igg/overlap.py:137-192`).  All arrays are cut at a COMMON
    start `lo` along `d` (index alignment is what lets a shift-invariant
    stencil see the slabs as a window of the global arrays), each keeping
    its stagger overhang `df = size_d - base_d` at the far end (extent
    `E + df`).  Producing field g's value at index i reads array f within
    `[i - r + min(0, df_f - df_g), i + r + max(0, df_f - df_g)]`; send
    planes sit at `p + df_g` on side 0 and `p` on side 1; the `lo` and `E`
    below cover every primary's send plane's reads in every array.  The
    window is then widened to the block end, so that the outermost plane
    (the open edge's no-write fallback) lies in the slab."""
    s0 = local[0]
    out = {}
    for d, ol in dims_base:
        dfs_all = [s[d] - s0[d] for s in local]
        dgs = dfs_all[:nf]
        dgmin, dgmax = min(dgs), max(dgs)
        dmin_all = min(dfs_all)
        for side, p in ((0, ol - 1), (1, s0[d] - ol)):
            if side == 0:
                lo = p - radius + min(dmin_all, dgmin)
                E = (2 * radius + 1 - min(dmin_all, dgmin)
                     + max(0, dgmax - dmin_all))
            else:
                lo = p - radius + min(0, dmin_all - dgmax)
                E = (p - lo) + radius + 1 - min(dmin_all, dgmin)
            for s in local:
                df = s[d] - s0[d]
                if lo < 0 or lo + E + df > s[d]:
                    raise GridError(
                        f"hide_communication: the send-plane window "
                        f"[{lo}, {lo + E + df}) along dimension {d} exceeds "
                        f"an array of local size {s[d]}; increase the "
                        f"grid overlap to accommodate radius {radius} with "
                        f"staggers {sorted(set(dfs_all))}.")
            if side == 0:
                E += lo
                lo = 0
            else:
                E = s0[d] - lo
            out[(d, side)] = (lo, E, [(p + dgs[i] if side == 0 else p) - lo
                                      for i in range(nf)])
    return out


def _side_stream(device) -> "torch.cuda.Stream":
    """The cached side stream of `device`, of the highest priority."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _SIDE.get(index)
    if s is None:
        high = min(torch.cuda.Stream.priority_range())
        s = _SIDE[index] = torch.cuda.Stream(device=index, priority=high)
    return s


def _cut(B, d: int, n: int, s: int, lo: int, extent: int):
    """Rows `[lo, lo + extent)` along `d` of each of the `n` blocks of
    extent `s` of `B`, stacked: one `index_select`."""
    key = (B.device, n, s, lo, extent)
    idx = _ROWS.get(key)
    if idx is None:
        if len(_ROWS) >= 256:
            _ROWS.clear()
        idx = _ROWS[key] = (block_rows(n, s, lo, B.device)[:, None]
                            + torch.arange(extent, device=B.device)
                            ).reshape(-1)
    return B.index_select(d, idx)


def _as_tuple(outs, single: bool, nf: int, what: str) -> tuple:
    outs = (outs,) if single else tuple(outs)
    if len(outs) != nf:
        raise GridError(f"hide_communication: compute returned {len(outs)} "
                        f"arrays for {nf} fields ({what}).")
    return outs


def _in_place(what: str) -> GridError:
    return GridError(
        f"hide_communication: compute changed its input arrays in place "
        f"({what}); the inputs are read by the slab computations beside "
        f"the full compute, so compute must return new tensors.")


def _send_planes(arrays, compute, windows, exchanged, local, nf, single,
                 blocks, grid):
    """The slab computations and the send (and, on open dims, stale)
    planes they give, `(sends, stales)`, one dict per primary keyed by
    `(d, side)` (`igg_torch.halo.exchange_all_dims_grouped`'s)."""
    s0 = local[0]
    sends = [dict() for _ in range(nf)]
    stales = [dict() for _ in range(nf)]
    for d in exchanged:
        n = blocks[d]
        for side in (0, 1):
            lo, E, lps = windows[(d, side)]
            cuts = [_cut(B, d, n, s[d], lo, E + s[d] - s0[d])
                    for B, s in zip(arrays, local)]
            versions = [c._version for c in cuts]
            outs = _as_tuple(compute(*cuts), single, nf, "on a slab")
            if any(c._version != v for c, v in zip(cuts, versions)):
                raise _in_place(f"a slab along dimension {d}")
            for i, out in enumerate(outs):
                if tuple(out.shape) != tuple(cuts[i].shape):
                    raise GridError(
                        f"hide_communication: compute returned an array of "
                        f"shape {tuple(out.shape)} for a slab of shape "
                        f"{tuple(cuts[i].shape)} (field {i}); it must "
                        f"return arrays of its inputs' shapes.")
                reqs = {"send": (d, lps[i])}
                if not grid.periods[d]:
                    reqs["stale"] = (d, 0 if side == 0
                                     else out.shape[d] // n - 1)
                got = extract_planes(out, reqs, grid, blocks)
                sends[i][(d, side)] = got["send"]
                if "stale" in got:
                    stales[i][(d, side)] = got["stale"]
    return sends, stales


def _hide(fields, aux, compute, windows, per_field_dims, local, single,
          plain, grid, ctx):
    """The restructured step (see :func:`hide_communication`)."""
    from .ops.halo_write import halo_write, halo_write_plain

    arrays = (*fields, *aux)
    nf = len(fields)
    blocks = tuple(grid.dims) if ctx is None else (1, 1, 1)
    dims = [moving_dims(ds, grid) for ds in per_field_dims]
    wraps = [wrap_dims(ds, grid) for ds in dims]
    exchanged = [d for d, _ in dims[0] if grid.dims[d] > 1]
    shapes = local[:nf]
    versions = [B._version for B in arrays]

    def exchange():
        sends, stales = _send_planes(arrays, compute, windows, exchanged,
                                     local, nf, single, blocks, grid)
        if ctx is not None:
            return ctx.exchange_grouped(sends, stales, dims, shapes, wraps)
        return exchange_all_dims_grouped(sends, dims, grid, shapes, stales,
                                         wraps)

    card = ctx is None and fields[0].device.type == "cuda"
    if card:
        main = torch.cuda.current_stream(fields[0].device)
        ready = torch.cuda.Event()
        ready.record(main)
    outs = _as_tuple(compute(*arrays), single, nf, "on the full arrays")
    if any(B._version != v for B, v in zip(arrays, versions)):
        raise _in_place("the full compute")
    if card:
        side = _side_stream(fields[0].device)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            recvs = exchange()
            done = torch.cuda.Event()
            done.record(side)
        for recv in recvs:
            for pair in recv.values():
                for P in pair:
                    P.record_stream(main)
        main.wait_event(done)
    else:
        recvs = exchange()

    write = halo_write_plain if plain else halo_write
    result = []
    for i, out in enumerate(outs):
        if any(out is B for B in arrays):
            out = out.clone()
        out = out.contiguous()
        specs = [(d, "wrap", ol) if d in wraps[i] else (d, "ext", *recvs[i][d])
                 for d, ol in dims[i]]
        if specs:
            write(out, specs, blocks[:min(out.ndim, 3)])
        result.append(out)
    return result[0] if single else tuple(result)


# ---------------------------------------------------------------------------
# Overlap as a serving configuration: the factories' overlap="auto"/True/
# False contract and its admission (igg/overlap.py:232-314).
# ---------------------------------------------------------------------------

def overlap_admission(radius: int = 1, *, grid=None, ndim: int = 3,
                      chunk_active: bool = False):
    """Whether the overlapped composition is ADMISSIBLE as a serving
    configuration on the live grid: an :class:`igg_torch.degrade.Admission`
    with igg's refusal reasons:

    - ``radius > ol-1``: the send planes cannot be slab-computed from
      in-block data (:func:`hide_communication` would raise);
    - a grid of one block (igg's "single-device mesh"): every exchange is
      a local plane copy, there is no wire to hide;
    - an active chunk or banded tier: its kernels already amortize one
      halo update over K interior steps.

    A stacked grid of several blocks on one card is admitted, as the
    blocks of a mesh are.  `ndim` bounds the participating dims (2 for the
    2-D families).  Host arithmetic only; never raises."""
    from .degrade import Admission

    if grid is None:
        if not shared.grid_is_initialized():
            return Admission.no("no grid initialized")
        grid = shared.global_grid()
    r = int(radius)
    for d in range(min(int(ndim), len(grid.overlaps))):
        ol = int(grid.overlaps[d])
        if r > ol - 1:
            return Admission.no(
                f"stencil radius {r} exceeds ol-1={ol - 1} along dimension "
                f"{d}: the send planes cannot be computed from in-block "
                f"data (initialize the grid with overlap >= {r + 1})")
    if all(int(dm) == 1 for dm in grid.dims[:int(ndim)]):
        return Admission.no(
            "single-device mesh: every exchange is a local plane copy, "
            "there is no wire to hide")
    if chunk_active:
        return Admission.no(
            "chunk tier already amortizes the exchange (one halo update "
            "per K interior steps)")
    return Admission.yes()


def resolve_overlap(overlap, *, family: str, tuned=None, radius: int = 1,
                    ndim: int = 3, chunk_active: bool = False) -> bool:
    """The factories' ``overlap=`` contract (igg's): ``True``/``False``
    are the caller's pins (True is still checked, at the call, by
    :func:`hide_communication`); ``"auto"`` resolves, in order, to

    1. the ``IGG_OVERLAP`` knob: a set value forces on (1/true/on) or pins
       off (0/false/off) every "auto" in the process;
    2. the autotuner's cached winner's ``overlap`` axis (`tuned`; None
       until the port has an autotuner);
    3. off: the sequential composition.

    A resolved True is gated by :func:`overlap_admission`: a refusal
    serves the sequential composition, recorded in
    `igg_torch.degrade.admission_log()` under ``{family}.overlap`` and
    emitted as an ``overlap_refused`` bus record, rather than raising."""
    from . import _env, degrade

    if overlap in (True, False):
        return bool(overlap)
    if overlap != "auto":
        raise GridError(
            f"overlap={overlap!r}: expected True, False, or 'auto'.")
    if _env.text("IGG_OVERLAP") is not None:
        want = _env.flag("IGG_OVERLAP")
    elif tuned is not None and tuned.get("overlap") is not None:
        want = bool(tuned["overlap"])
    else:
        want = False
    if not want:
        return False
    adm = overlap_admission(radius, ndim=ndim, chunk_active=chunk_active)
    if not adm:
        with degrade._lock:
            degrade._ADMISSION_LOG[f"{family}.overlap"] = adm.reason
        _telemetry.emit("overlap_refused", family=family, radius=radius,
                        reason=adm.reason)
        return False
    return True
