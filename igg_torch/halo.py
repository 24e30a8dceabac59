"""Halo-exchange engine: the port's `update_halo`.

Semantics of `igg.halo` (and of the reference's `update_halo!`):

- one boundary plane is exchanged per side per dimension: send plane
  `ol-1` (left) / `s-ol` (right), received into plane `0` / `s-1`;
- the per-array staggered overlap `ol(dim, A) = overlaps[dim] +
  (s_d - n_d)`; a dimension takes part only when `ol >= 2`;
- dimensions go in order x, y, z, and later dimensions win the shared
  corner and edge cells, so corners propagate without diagonal messages;
- open (non-periodic) boundaries: edge halos are not written;
- periodic with one block along a dimension: the block wraps onto itself
  (the self-neighbor path), read from the block in the halo writer.

Structure: :func:`send_planes` extracts the planes to send (the y/z ones
of a 3-D field in one launch of the plane packer, `igg_torch.ops.pack`,
where there are at least two); :func:`exchange_all_dims` runs the
dimension-sequential plane exchange with corner propagation (the pending
planes of later dims are patched with what earlier dims received), moving
planes through :func:`exchange_planes` — the one function of the halo
engine that crosses blocks, which a `torch.distributed` backend replaces.
The received planes and the wrap
dims then go to ONE launch of the in-place halo writer
(:func:`igg_torch.ops.halo_write.halo_write`), which writes every
participating dimension's two planes in dimension order.

Planes are stacked over the blocks: the plane tensor of dimension `d` has
the stacked shape of the field with dim `d` replaced by `dims[d]` (entry
`c` along `d` is block `c`'s plane).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import shared, telemetry
from .shared import NDIMS, GridError


def check_fields(grid, fields, local_shapes) -> None:
    """The reference's argument checks: every field has a halo, no field is
    passed twice, all fields share one dtype."""
    no_halo = [
        i for i, (A, s) in enumerate(zip(fields, local_shapes))
        if all(grid.ol_of_local(d, s) < 2 for d in range(min(A.ndim, NDIMS)))
    ]
    if len(no_halo) > 1:
        raise GridError(
            f"The fields at positions {', '.join(map(str, no_halo))} have no "
            f"halo; remove them from the call.")
    if no_halo:
        raise GridError(
            f"The field at position {no_halo[0]} has no halo; remove it from "
            f"the call.")
    dups = [(i, j) for i in range(len(fields)) for j in range(i + 1, len(fields))
            if fields[i] is fields[j]]
    if dups:
        i, j = dups[0]
        raise GridError(
            f"The field at position {j} is a duplicate of the one at the "
            f"position {i}; remove the duplicate from the call.")
    diff = [i for i in range(1, len(fields)) if fields[i].dtype != fields[0].dtype]
    if diff:
        raise GridError(
            f"The field at position {diff[0]} is of different type than the "
            f"first field; make sure that in a same call all fields are of "
            f"the same type.")


def active_dims(shape, grid) -> List[Tuple[int, int]]:
    """(dim, ol) pairs of a local block shape that have a halo (ol >= 2)."""
    return [(d, grid.ol_of_local(d, shape))
            for d in range(min(len(shape), NDIMS))
            if grid.ol_of_local(d, shape) >= 2]


def moving_dims(dims_active, grid) -> List[Tuple[int, int]]:
    """The active dims whose halo planes can change: a dimension with one
    block and an open boundary never receives anything."""
    return [(d, ol) for d, ol in dims_active
            if grid.dims[d] > 1 or grid.periods[d]]


def wrap_dims(dims, grid) -> frozenset:
    """Dims the halo writer assembles from the block itself: periodic with
    a single block (the self-neighbor path)."""
    return frozenset(d for d, _ in dims if grid.dims[d] == 1 and grid.periods[d])


def block_rows(n: int, s: int, pos: int, device) -> torch.Tensor:
    """Stacked indices of local row `pos` in each of `n` blocks of size `s`."""
    return torch.arange(n, device=device) * s + pos


def planes(A, d: int, n: int, pos: int) -> torch.Tensor:
    """Every block's local plane `pos` along `d`, stacked (a new tensor)."""
    return A.index_select(d, block_rows(n, A.shape[d] // n, pos, A.device))


# ---------------------------------------------------------------------------
# Exchange
# ---------------------------------------------------------------------------

# Fault-injection seam (igg_torch.chaos.halo_corruption, igg's
# `_CHAOS_PLANE_TAP`): a callable `(d, first, last) -> (first, last)`
# applied to the planes `exchange_planes` returns, the one primitive every
# `update_halo` path goes through.  Read at every call (nothing is
# compiled), so arming it clears no cache.
_CHAOS_PLANE_TAP = None


def exchange_planes(left_send, right_send, stale_first, stale_last,
                    d: int, n: int, periodic: bool, disp: int = 1):
    """Plane-level neighbor shift along dimension `d` over `n` blocks:
    returns the `(new_first, new_last)` halo planes of every block.

    Block `c` receives into its first plane the right send plane of the
    block `disp` to its left, and into its last plane the left send plane
    of the block `disp` to its right.  Where an open boundary leaves no
    partner, the stale planes come back (the no-write semantics).  This is
    the only function of the halo engine that moves data between blocks
    (the K-step chunk's is `igg_torch.ops.chunk_engine.exchange_slabs`).
    An armed `_CHAOS_PLANE_TAP` gets `(d, new_first, new_last)` and
    returns the planes handed on."""
    first, last = _shift_planes(left_send, right_send, stale_first,
                                stale_last, d, n, periodic, disp)
    tap = _CHAOS_PLANE_TAP
    return (first, last) if tap is None else tap(d, first, last)


def _shift_planes(left_send, right_send, stale_first, stale_last,
                  d: int, n: int, periodic: bool, disp: int):
    if periodic and disp % n == 0:
        return right_send, left_send
    if not periodic and disp >= n:
        return stale_first, stale_last
    c = torch.arange(n, device=left_send.device)
    shape = [1] * left_send.ndim
    shape[d] = n
    from_left = right_send.index_select(d, (c - disp) % n)
    from_right = left_send.index_select(d, (c + disp) % n)
    if periodic:
        return from_left, from_right
    has_left = (c >= disp).view(shape)
    has_right = (c < n - disp).view(shape)
    return (torch.where(has_left, from_left, stale_first),
            torch.where(has_right, from_right, stale_last))


def exchange_all_dims(sends: Dict, dims: Sequence[Tuple[int, int]], grid,
                      local_shape, stales: Optional[Dict] = None,
                      wraps=frozenset()) -> Dict:
    """Dimension-sequential plane exchange of one field with corner/edge
    propagation: :func:`exchange_all_dims_grouped` for one field.  Returns
    `recv[d] = (new_first, new_last)`."""
    return exchange_all_dims_grouped([sends], [dims], grid, [local_shape],
                                     [stales], [wraps])[0]


def exchange_all_dims_grouped(sends: Sequence[Dict], dims: Sequence, grid,
                              local_shapes, stales: Optional[Sequence] = None,
                              wraps: Optional[Sequence] = None) -> List[Dict]:
    """Dimension-sequential plane exchange of several fields at once, with
    corner/edge propagation (`igg.halo.exchange_all_dims_grouped`).  Per
    field `i`: `sends[i][(d, side)]` are the stacked send planes of every
    exchanged dim in `dims[i]` (`(d, ol)` pairs), `stales[i][(d, side)]`
    the open-boundary fallback planes of its non-periodic ones, `wraps[i]`
    the dims the caller assembles from the block itself.  Returns one
    `recv[d] = (new_first, new_last)` dict per field.

    Dimensions go in order; the planes of the fields that exchange a dim
    and share a plane shape and dtype are stacked and moved by ONE
    :func:`exchange_planes` call.  After dim `d` is exchanged, the pending
    send and stale planes of every later dim get their edge rows along `d`
    overwritten with what `d` received (wrap dims: with their own inner
    rows), which is what the later dims would see after a sequential
    update of the whole block.  The caller writes the planes in dimension
    order."""
    nf = len(sends)
    sends = [dict(s) for s in sends]
    stales = [dict(st) if st else {} for st in (stales or [None] * nf)]
    wraps = wraps or [frozenset()] * nf
    ols = [dict(ds) for ds in dims]
    recvs: List[Dict] = [{} for _ in range(nf)]
    for d in sorted(set().union(*ols)):
        groups: Dict = {}
        for i in range(nf):
            if d not in ols[i]:
                continue
            if d in wraps[i]:
                _patch_wrapped(sends[i], stales[i], d, ols[i][d], dims[i],
                               wraps[i], local_shapes[i])
            else:
                P = sends[i][(d, 0)]
                groups.setdefault((tuple(P.shape), P.dtype), []).append(i)
        for members in groups.values():
            n, periodic = grid.dims[d], bool(grid.periods[d])
            planes4 = [[store[i].get((d, side)) for i in members]
                       for store in (sends, stales) for side in (0, 1)]
            if len(members) == 1:
                got = [exchange_planes(*[p[0] for p in planes4], d, n,
                                       periodic, grid.disp)]
            else:
                stacked = [None if p[0] is None else torch.stack(p)
                           for p in planes4]
                first, last = exchange_planes(*stacked, d + 1, n, periodic,
                                              grid.disp)
                got = list(zip(first.unbind(0), last.unbind(0)))
            for i, (first, last) in zip(members, got):
                recvs[i][d] = (first, last)
                _patch_received(sends[i], stales[i], d, n, first, last,
                                dims[i], wraps[i], local_shapes[i], grid)
    return recvs


def _patch_wrapped(sends, stales, d, ol, dims, wraps, s) -> None:
    """Wrap dim `d` (assembled by the caller): the later dims' pending
    planes get the wrapped rows, aliases of their own inner rows."""
    for d2, _ in dims:
        if d2 <= d or d2 in wraps:
            continue
        for store in (sends, stales):
            for side2 in (0, 1):
                P = store.get((d2, side2))
                if P is None:
                    continue
                P[_sl(d, 0)] = P[_sl(d, s[d] - ol)]
                P[_sl(d, s[d] - 1)] = P[_sl(d, ol - 1)]


def _patch_received(sends, stales, d, n, first, last, dims, wraps, s,
                    grid) -> None:
    """Exchanged dim `d`: the later dims' pending send and stale planes get
    their edge rows along `d` from the received planes."""
    for d2, ol2 in dims:
        if d2 <= d or d2 in wraps:
            continue
        n2 = grid.dims[d2]
        for side2, p_send, p_stale in ((0, ol2 - 1, 0),
                                       (1, s[d2] - ol2, s[d2] - 1)):
            for store, pos in ((sends, p_send), (stales, p_stale)):
                P = store.get((d2, side2))
                if P is None:
                    continue
                rows_first = block_rows(n, s[d], 0, P.device)
                rows_last = block_rows(n, s[d], s[d] - 1, P.device)
                P.index_copy_(d, rows_first, planes(first, d2, n2, pos))
                P.index_copy_(d, rows_last, planes(last, d2, n2, pos))


def _sl(d: int, i: int):
    """Index of row `i` along dim `d` (keeping the dim), for a single block."""
    return (slice(None),) * d + (slice(i, i + 1),)


def extract_planes(A, reqs: Dict, grid, blocks=None) -> Dict:
    """`{key: (d, pos)}` -> `{key: every block's plane pos along d}`, `A`
    laid out as `blocks` blocks (the grid's when None).  Where a 3-D field
    needs at least two y/z planes, they come from one pass of the plane
    packer (`igg_torch.ops.pack`), the rule of `igg/halo.py`; the others
    are `index_select` calls."""
    from .ops.pack import pack_planes
    blocks = tuple(grid.dims) if blocks is None else tuple(blocks)
    minor = [k for k, (d, _) in reqs.items() if d >= 1 and A.ndim == 3]
    out = {}
    if len(minor) >= 2:
        out.update(zip(minor, pack_planes(A, [reqs[k] for k in minor],
                                          blocks)))
    for k, (d, pos) in reqs.items():
        if k not in out:
            out[k] = planes(A, d, blocks[d], pos)
    return out


def send_planes(A, dims, grid, wraps=frozenset()):
    """The stacked send planes (`ol-1` / `s-ol`) and, for open dims, stale
    planes (`0` / `s-1`) of every exchanged dim of `A`."""
    s = grid.local_shape(A)
    reqs = {}
    for d, ol in dims:
        if d in wraps:
            continue
        reqs[("send", d, 0)] = (d, ol - 1)
        reqs[("send", d, 1)] = (d, s[d] - ol)
        if not grid.periods[d]:
            reqs[("stale", d, 0)] = (d, 0)
            reqs[("stale", d, 1)] = (d, s[d] - 1)
    got = extract_planes(A, reqs, grid)
    sends = {k[1:]: P for k, P in got.items() if k[0] == "send"}
    stales = {k[1:]: P for k, P in got.items() if k[0] == "stale"}
    return sends, stales


def plane_bytes_by_mode(local_shapes, dtypes, grid
                        ) -> Dict[Tuple[str, str], int]:
    """The `igg_halo_plane_bytes_total` accounting of one `update_halo`
    call (igg's `plane_bytes_by_mode`), by ``(dim, mode)``: per field and
    per moving dim, two boundary planes per block, summed over the blocks.
    `mode` is ``wire_grouped`` where the dim has several blocks (the planes
    cross blocks: :func:`exchange_planes`) and ``local_grouped`` where one
    periodic block wraps onto itself; the port has no stacked lane
    program, so no field is ``*_stacked`` (igg's classification on the
    CPU).  Host arithmetic only."""
    out: Dict[Tuple[str, str], int] = {}
    for ls, dtype in zip(local_shapes, dtypes):
        elems = 1
        for v in ls:
            elems *= int(v)
        for d, _ in moving_dims(active_dims(ls, grid), grid):
            transport = "wire" if grid.dims[d] > 1 else "local"
            key = ("xyz"[d] if d < 3 else str(d), f"{transport}_grouped")
            out[key] = out.get(key, 0) + (2 * (elems // int(ls[d]))
                                          * dtype.itemsize * grid.nprocs)
    return out


# {(grid epoch, local shapes, dtypes): (total, sorted (dim, mode) bytes)}:
# the accounting of a call signature, formed once.
_PLANE_BYTES: Dict = {}


def count_plane_bytes(local_shapes, dtypes, grid) -> None:
    """Add one call's plane bytes to `igg_halo_plane_bytes_total`,
    unlabeled and by ``(dim, mode)``, as igg's `update_halo` does."""
    key = (shared.grid_epoch(), tuple(local_shapes), tuple(dtypes))
    got = _PLANE_BYTES.get(key)
    if got is None:
        by_mode = plane_bytes_by_mode(local_shapes, dtypes, grid)
        got = _PLANE_BYTES[key] = (sum(by_mode.values()),
                                   sorted(by_mode.items()))
    total, items = got
    telemetry.counter("igg_halo_plane_bytes_total").inc(total)
    for (dim, mode), nbytes in items:
        telemetry.counter("igg_halo_plane_bytes_total", dim=dim,
                          mode=mode).inc(nbytes)


def _update_field(A, grid, write) -> None:
    s = grid.local_shape(A)
    dims = moving_dims(active_dims(s, grid), grid)
    if not dims:
        return
    wraps = wrap_dims(dims, grid)
    sends, stales = send_planes(A, dims, grid, wraps)
    recv = exchange_all_dims(sends, dims, grid, s, stales, wraps)
    specs = [(d, "wrap", ol) if d in wraps else (d, "ext", *recv[d])
             for d, ol in dims]
    write(A, specs, grid.dims[:min(A.ndim, NDIMS)])


def _writer(plain: bool):
    from .ops.halo_write import halo_write, halo_write_plain
    return halo_write_plain if plain else halo_write


def update_halo(*fields, plain: bool = False):
    """Update the halo of the given grid array(s) IN PLACE and return
    it (them).  Several fields in one call are checked together (no
    duplicates, one dtype) and updated one after the other.  On a CUDA
    tensor each field costs one launch of the halo-writer kernel;
    `plain=True` asks for the writer's plain PyTorch version instead.
    Each call adds its plane bytes to `igg_halo_plane_bytes_total`
    (:func:`count_plane_bytes`)."""
    grid = shared.global_grid()
    local_shapes = [grid.local_shape(A) for A in fields]
    check_fields(grid, fields, local_shapes)
    count_plane_bytes(local_shapes, [A.dtype for A in fields], grid)
    write = _writer(plain)
    for A in fields:
        _update_field(A, grid, write)
    return fields[0] if len(fields) == 1 else fields


def update_halo_local(*fields, plain: bool = False):
    """Halo update of local blocks inside :func:`igg_torch.sharded` (on a
    stacked grid array outside of it, the same as :func:`update_halo`)."""
    from .parallel import _block_context
    ctx = _block_context()
    if ctx is None:
        return update_halo(*fields, plain=plain)
    return ctx.update_halo(fields, plain)
