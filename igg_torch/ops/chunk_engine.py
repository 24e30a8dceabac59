"""The host pieces of the K-step chunk engine (`igg/ops/chunk_engine.py`),
on block-stacked tensors, shared by the diffusion, HM3D, wave2d and Stokes
chunk routes.

A K-step chunk advances every block by K steps at once: each block is first
extended by E rows beyond both ends of every extended dimension, with the
neighbours' rows (:func:`extend_fields`); K steps then run on the extended
blocks, each losing E/K rows of validity per extended end and step (one for
diffusion and HM3D, E = K; two for wave2d's coupled leapfrog and the
Stokes Gauss-Seidel chain, E = 2K), so that after K steps exactly the
block itself holds the values the per-step path would produce; the
central window is cut out (:func:`central_window`).
Fields may be staggered (their own block shapes and overlaps) and of rank 2
or 3; a family may re-freeze only some of them (Stokes: the velocities on
every open dim; a stencil spec: per dim, the fields its analyzer names,
:func:`normalize_freeze`), and a field that never changes (Stokes' `Rho`)
is extended once and read by the family's core.

Per-dimension window modes (:func:`dim_modes`): ``"ext"`` (periodic,
extended), ``"wrap"`` (periodic, one block, y/z self-wrap in place),
``"oext"`` (open, several blocks: extended, and the blocks on the global
edges re-freeze their boundary rows from the chunk-entry buffer every
step), ``"frozen"`` (open, one block: both boundary planes re-frozen).

The plain window realization (:func:`window_chunk_plain`, igg's
`window_chunk_xla`) is the plain version of every family's chunk kernel
(`csrc/chunk_walk.cuh` for diffusion and HM3D, `csrc/stagger_walk.cuh` for
wave2d and rank-2 specs, `csrc/stagger_walk3.cuh` for Stokes and rank-3
specs); :func:`chunk_cfg` and :func:`stagger_cfg` give the walks' kernels
the layout.

The one function that moves data between blocks is :func:`exchange_slabs`
(as :func:`igg_torch.halo.exchange_planes` is for the halo engine): here
the blocks are stacked in one tensor, so it is an index gather over the
block axis, and a `torch.distributed` backend replaces it.

Left out, because they exist only for the TPU: transposed z slabs, the
sublane-tile and banded-geometry gates and the VMEM budget.  The TPU's
resident kernel has its counterpart in the chunk kernels of
`csrc/chunk_walk.cuh` (diffusion and HM3D) and `csrc/stokes_chunk.cu`, the
whole-window kernel its wave2d instance in `csrc/wave2d_chunk.cu`; the
streaming kernel is later work.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch

EXTENDED = ("ext", "oext")
# Fields the staggered walks take at most (`MAXF` in csrc/stagger_walk.cuh).
MAXF = 8


def dim_modes(grid) -> Tuple[str, str, str]:
    """Per-dimension window mode of the chunk (module docstring); x is
    always extended when periodic, even on one block."""
    modes = []
    for d in range(3):
        if grid.periods[d]:
            modes.append("ext" if (d == 0 or grid.dims[d] > 1) else "wrap")
        else:
            modes.append("oext" if grid.dims[d] > 1 else "frozen")
    return tuple(modes)


def edge_flags(modes, grid) -> torch.Tensor:
    """Per-block edge flags, shape `dims + (6,)` int32: two per dim, set
    where the block's low / high boundary rows freeze.  A "frozen" dim
    flags both sides (its one block is both global edges), an "oext" dim
    flags the blocks on the global edges, periodic dims and dims beyond
    `modes` (of a 2-D field) flag nothing.  The stacked layout's
    `axis_index`: the flags come from block coordinates."""
    n = grid.dims
    flags = torch.zeros(tuple(n) + (6,), dtype=torch.int32, device=grid.device)
    for d in range(len(modes)):
        if modes[d] not in ("frozen", "oext"):
            continue
        c = torch.arange(n[d], device=grid.device)
        view = [1, 1, 1]
        view[d] = n[d]
        flags[..., 2 * d] = (c == 0).to(torch.int32).view(view)
        flags[..., 2 * d + 1] = (c == n[d] - 1).to(torch.int32).view(view)
    return flags


def field_ols(grid, shapes) -> List[Tuple[int, ...]]:
    """Per-field per-dim staggered overlaps `ol(dim, A)`."""
    return [tuple(grid.ol_of_local(d, s) for d in range(len(s)))
            for s in shapes]


def ext_shape(s, E, modes) -> Tuple[int, ...]:
    """A block's extended shape: +2E along every extended dim."""
    return tuple(s[d] + (2 * E if modes[d] in EXTENDED else 0)
                 for d in range(len(s)))


def wrap_edges(v, axis: int, size: int, ol: int):
    """Periodic self-wrap, in place, of the outermost planes along `axis`
    of a field with one block along it: edge 0 <- inner `size-ol`, then
    edge `size-1` <- inner `ol-1`.  Returns `v`."""
    v.select(axis, 0).copy_(v.select(axis, size - ol))
    v.select(axis, size - 1).copy_(v.select(axis, ol - 1))
    return v


def freeze_open_dim(U, F, d: int, lo: int, hi: int, flags):
    """Open-dim freeze of the window realization: on the blocks flagged by
    `flags` (:func:`edge_flags`), rows `<= lo` (low edge) and `>= hi`
    (high edge) along `d` take the chunk-entry values of `F` ("frozen":
    lo = 0 and hi = S-1, the two boundary planes; "oext": the boundary row
    and the shoulder beyond it).  Any rank up to 3 (the grid's trailing
    dims then hold one block).  Returns a new tensor."""
    nd = U.ndim
    n = flags.shape[:nd]
    fl = flags.reshape(tuple(n) + (6,))
    S = [U.shape[k] // n[k] for k in range(nd)]
    block = sum(((n[k], 1) for k in range(nd)), ())
    i = torch.arange(S[d], device=U.device)
    row = [1] * (2 * nd)
    row[2 * d + 1] = S[d]
    mask = ((fl[..., 2 * d].view(block) == 1) & (i <= lo).view(row)) | \
           ((fl[..., 2 * d + 1].view(block) == 1) & (i >= hi).view(row))
    split = sum(((n[k], S[k]) for k in range(nd)), ())
    return torch.where(mask, F.view(split), U.view(split)).view(U.shape)


def freeze_rows(modes, E: int, ext_local):
    """Per dim `(lo, hi)` of the rows that re-freeze on edge blocks of an
    extended block of shape `ext_local` (margin `E`), or None for a dim
    that does not freeze."""
    out = []
    for d in range(len(ext_local)):
        if modes[d] == "oext":
            out.append((E, ext_local[d] - 1 - E))
        elif modes[d] == "frozen":
            out.append((0, ext_local[d] - 1))
        else:
            out.append(None)
    return out


# ---------------------------------------------------------------------------
# The plain window realization (igg's `window_chunk_xla`)
# ---------------------------------------------------------------------------

def normalize_freeze(freeze_fields, nd: int):
    """Per-dim freeze sets (igg's `normalize_freeze`): a plain sequence of
    field indices freezes on every dim (the Stokes velocities); a dict
    `{dim: field indices}` freezes per dim (a spec's face field is no-write
    only along its staggered dim, `igg_torch.stencil.analyze`)."""
    if isinstance(freeze_fields, dict):
        return {d: tuple(freeze_fields.get(d, ())) for d in range(nd)}
    return {d: tuple(freeze_fields) for d in range(nd)}


def window_step_plain(fields, entry, *, E: int, modes, grid, core, flags,
                      freeze_fields, ols=None):
    """One step of the window realization on the extended stacked buffers
    `fields` (chunk-entry buffers `entry`, margin `E`, :func:`edge_flags`
    `flags`): `core(*fields)` gives the family's updated fields (every
    extended block's updated cells, stale outer cells); then the y/z
    self-wrap of every field, with its own overlap `ols[f][d]` (2 when
    `ols` is None), then the open-dim freezes of `freeze_fields` (a
    sequence or a per-dim dict, :func:`normalize_freeze`), which win the
    cells they share with a wrap.  Fields may differ in shape (staggered)
    and be of rank 2 or 3.  Returns new tensors.

    igg's `window_chunk_xla` applies the wraps and freezes dim by dim
    instead; from an exchange-fresh entry state (the chunk's entry
    condition) a wrap and a freeze agree on the cells they share, so the
    two orders give the same values.  The port's chunk kernels
    (`csrc/chunk_walk.cuh`) take this order."""
    U = list(core(*fields))
    for d in range(1, U[0].ndim):
        if modes[d] == "wrap":
            for f, u in enumerate(U):
                wrap_edges(u, d, u.shape[d], 2 if ols is None else ols[f][d])
    freeze = normalize_freeze(freeze_fields, U[0].ndim)
    for f in range(len(U)):
        ext_local = tuple(U[f].shape[d] // grid.dims[d]
                          for d in range(U[f].ndim))
        for d, rows in enumerate(freeze_rows(modes, E, ext_local)):
            if rows is not None and f in freeze[d]:
                U[f] = freeze_open_dim(U[f], entry[f], d, *rows, flags)
    return U


def window_chunk_plain(fields, *, K: int, modes, grid, core, freeze_fields,
                       E: Optional[int] = None, ols=None):
    """K window steps (:func:`window_step_plain`, margin `E`, K when None)
    of the extended buffers `fields`, which are also the freeze source:
    the plain version of every family's chunk kernel.  Returns the evolved
    extended buffers; :func:`central_window` cuts the results out."""
    flags = edge_flags(modes, grid)
    U = list(fields)
    for _ in range(K):
        U = window_step_plain(U, fields, E=K if E is None else E, modes=modes,
                              grid=grid, core=core, flags=flags,
                              freeze_fields=freeze_fields, ols=ols)
    return U


# ---------------------------------------------------------------------------
# The K-deep slab extension
# ---------------------------------------------------------------------------

def exchange_slabs(left, right, axis: int, periodic: bool):
    """Slab-level neighbour shift over the block axis `axis` of `left` and
    `right` (each block's slab to send rightward / leftward): returns
    `(from_left, from_right)`, every block's slab received from its left
    and from its right neighbour.  Where an open boundary leaves no
    partner, the slab is zeros.  This is the only function of the chunk
    engine that moves data between blocks."""
    n = left.shape[axis]
    c = torch.arange(n, device=left.device)
    from_left = left.index_select(axis, (c - 1) % n)
    from_right = right.index_select(axis, (c + 1) % n)
    if not periodic:
        from_left.select(axis, 0).zero_()
        from_right.select(axis, n - 1).zero_()
    return from_left, from_right


def extend_dim_grouped(arrs, ols, E: int, grid, d: int, mode: str = "ext"):
    """The `S + 2E` window along dim `d` of every block of each field in
    `arrs` (per-field staggered overlaps `ols`): the `E+1` rows that the
    left neighbour sends from `[S-ol-E, S-ol]`, the block's own rows
    `1 .. S-2`, and the `E+1` rows the right neighbour sends from
    `[ol-1, ol+E-1]`.  The block's own boundary rows are thus replaced by
    the neighbours' send-position rows (a no-op on exchange-fresh halos).
    Same-shaped slabs go through :func:`exchange_slabs` together.  On an
    "oext" dim the global-edge blocks receive zeros beyond the domain and
    get their own boundary row back at `E` / `Se-1-E` (no-write)."""
    n = grid.dims[d]
    views, sends = [], []
    for A, ol in zip(arrs, ols):
        v = A.unflatten(d, (n, A.shape[d] // n))
        S = v.shape[d + 1]
        views.append(v)
        sends.append((v.narrow(d + 1, S - ol - E, E + 1),
                      v.narrow(d + 1, ol - 1, E + 1)))
    groups = {}
    for j, (left, _) in enumerate(sends):
        groups.setdefault((tuple(left.shape), left.dtype), []).append(j)
    recv = [None] * len(arrs)
    periodic = mode != "oext"
    for members in groups.values():
        if len(members) == 1:
            j = members[0]
            recv[j] = exchange_slabs(*sends[j], d, periodic)
            continue
        lefts, rights = exchange_slabs(
            torch.stack([sends[j][0] for j in members]),
            torch.stack([sends[j][1] for j in members]), d + 1, periodic)
        for k, j in enumerate(members):
            recv[j] = (lefts[k], rights[k])
    out = []
    for v, (from_left, from_right) in zip(views, recv):
        S = v.shape[d + 1]
        Se = S + 2 * E
        shape = list(v.shape)
        shape[d + 1] = Se
        w = torch.empty(shape, dtype=v.dtype, device=v.device)
        w.narrow(d + 1, 0, E + 1).copy_(from_left)
        w.narrow(d + 1, E + 1, S - 2).copy_(v.narrow(d + 1, 1, S - 2))
        w.narrow(d + 1, Se - E - 1, E + 1).copy_(from_right)
        if mode == "oext":
            w.select(d, 0).narrow(d, E, 1).copy_(
                v.select(d, 0).narrow(d, 0, 1))
            w.select(d, n - 1).narrow(d, Se - 1 - E, 1).copy_(
                v.select(d, n - 1).narrow(d, S - 1, 1))
        out.append(w.flatten(d, d + 1))
    return out


def extend_fields(arrs, ols, E: int, grid, modes):
    """Dimension-sequential extension of a list of fields: x first, then y
    of the x-extended buffers, then z of the x/y-extended ones, so corner
    and edge regions arrive through the later neighbours' own earlier-dim
    extensions.  wrap/frozen dims are not extended."""
    out = list(arrs)
    for d in range(arrs[0].ndim):
        if modes[d] in EXTENDED:
            out = extend_dim_grouped(out, [ol[d] for ol in ols], E, grid, d,
                                     modes[d])
    return out


def central_window(F, shape, E: int, modes):
    """Every block's central `shape` window of the extended stacked `F`
    (rows `E .. E+s-1` of each extended dim), as a new contiguous tensor."""
    for d in range(len(shape)):
        if modes[d] in EXTENDED:
            Se = shape[d] + 2 * E
            F = F.unflatten(d, (F.shape[d] // Se, Se)).narrow(
                d + 1, E, shape[d]).flatten(d, d + 1)
    return F.contiguous()


# ---------------------------------------------------------------------------
# Admission and the chunk loop
# ---------------------------------------------------------------------------

def default_K(S0: int) -> int:
    """Chunk depth K of a model's chunk route for blocks of `S0` x rows:
    igg's choice, 8 when it divides S0."""
    for b in (8, 16, 4, 2):
        if S0 % b == 0:
            return b
    return 1


def admit_chunk_common(grid, K: int, n_inner: int) -> Optional[str]:
    """The gates every chunk tier shares: at least one full K-chunk and
    unit displacement.  Returns the refusal, or None."""
    if K < 2 or n_inner < K:
        return (f"n_inner={n_inner} holds no full K={K} chunk "
                f"(needs n_inner >= K >= 2)")
    if grid.disp != 1:
        return f"grid disp {grid.disp} != 1 (the slab exchange shifts by 1)"
    return None


def admit_send_slabs(shapes, ols, E: int, modes, *, grid=None,
                     min_ol: int = 2) -> Optional[str]:
    """E-deep send slabs must lie inside every extended dimension's block
    for every field, with overlap >= `min_ol`, and (given the grid) stay
    out of the sender's shared region: `E <= nxyz - 2*overlap` per dim, or
    the slab ships rows the sender merely mirrors.  Returns the refusal,
    or None."""
    for d in range(len(shapes[0])):
        if modes[d] not in EXTENDED:
            continue
        if grid is not None:
            nb, olb = grid.nxyz[d], grid.overlaps[d]
            if E > nb - 2 * olb:
                return (f"E={E} dim-{d} send slabs enter the sender's shared "
                        f"region (base extent {nb}, ol {olb}: needs "
                        f"E <= {nb - 2 * olb})")
        for s, ol in zip(shapes, ols):
            if ol[d] < min_ol:
                return f"dim-{d} overlap {ol[d]} < {min_ol} (field shape {s})"
            if s[d] - ol[d] - E < 0 or ol[d] + E > s[d]:
                return (f"E={E} dim-{d} send slabs fall outside a field block "
                        f"(shape {s}, ol {ol[d]})")
    return None


def check_chunk_buffers(exts, shapes, E: int, modes, grid, dtypes) -> None:
    """Raise unless the extended stacked buffers `exts` suit a chunk
    kernel: of one rank and one dtype among `dtypes`, contiguous, on one
    CUDA device, field f's blocks `shapes[f]` extended by E along the
    extended dims, and wrap modes only on one-block y/z dims."""
    T = exts[0]
    for X, s in zip(exts, shapes):
        if X.ndim != T.ndim or len(s) != X.ndim:
            raise ValueError(f"chunk buffers {[tuple(x.shape) for x in exts]} "
                             f"must share one rank with their blocks {shapes}")
        if X.dtype not in dtypes or X.dtype != T.dtype:
            raise ValueError(f"chunk buffer dtypes {[x.dtype for x in exts]}: "
                             f"need one of {sorted(map(str, dtypes))}")
        if X.device.type != "cuda" or X.device != T.device:
            raise ValueError(f"chunk kernel: buffers on "
                             f"{[str(x.device) for x in exts]}")
        if not X.is_contiguous():
            raise ValueError("chunk kernel: buffers must be contiguous")
        want = [grid.dims[d] * e for d, e in enumerate(ext_shape(s, E, modes))]
        if list(X.shape) != want or min(s) < 3:
            raise ValueError(f"chunk buffer {tuple(X.shape)}: expected {want} "
                             f"for blocks {tuple(s)} and E={E}")
    for d in range(T.ndim):
        if modes[d] == "wrap" and (d == 0 or grid.dims[d] != 1):
            raise ValueError(f"wrap mode on dim {d} needs y/z and one block")


def chunk_cfg(ext_stacked, local, E: int, modes, grid, last: bool):
    """The chunk layout the 3-D walk's chunk kernels take (`make_chunk` in
    `csrc/chunk_walk.cuh`), as a ctypes int array: blocks, extended local
    extents, modes, the freeze rows (margin `E`), `last`, the central
    window's offsets and the output's local extents."""
    ext_local = [ext_stacked[d] // grid.dims[d] for d in range(3)]
    rows = freeze_rows(modes, E, ext_local)
    cfg = (list(grid.dims) + ext_local
           + [1 if m == "wrap" else 0 for m in modes]
           + [0 if r is None else 1 for r in rows]
           + [0 if r is None else r[0] for r in rows]
           + [0 if r is None else r[1] for r in rows]
           + [int(last)]
           + [E if m in EXTENDED else 0 for m in modes]
           + list(local))
    return (ctypes.c_int * len(cfg))(*cfg)


def stagger_cfg(shape, E: int, modes, dims, ols, last: bool):
    """The layout the staggered walks' chunk kernels take, as a ctypes int
    array: `make_stag` (`csrc/stagger_walk.cuh`) for a base block `shape`
    of rank 2, `make_stag3` (`csrc/stagger_walk3.cuh`) for rank 3.  Blocks
    (`dims`),
    the extended base block (margin `E`), the y (and z) wraps, the target's
    offset in an extended block and its base block (the central window on
    the last step, else the whole extended block), the freezing dims and
    their rows (the base block's; a staggered field's high row is one
    further along its own dim), and the fields' overlaps `ols` (y only for
    rank 2), padded to `MAXF` fields."""
    nd = len(shape)
    if len(ols) > MAXF:
        raise ValueError(f"{len(ols)} fields: the staggered walks take at most "
                         f"{MAXF}")
    ext = ext_shape(shape, E, modes)
    rows = freeze_rows(modes, E, ext)
    off = [E if last and modes[d] in EXTENDED else 0 for d in range(nd)]
    wraps = [int(modes[d] == "wrap") for d in range(1, nd)]
    ols = [tuple(ol) for ol in ols] + [(2,) * nd] * (MAXF - len(ols))
    cfg = (list(dims[:nd]) + list(ext) + ([0] if nd == 3 else [])
           + wraps + off + list(shape if last else ext)
           + [int(r is not None) for r in rows]
           + [0 if r is None else r[0] for r in rows]
           + [0 if r is None else r[1] for r in rows]
           + [o for ol in ols for o in (ol[1:] if nd == 2 else ol)])
    return (ctypes.c_int * len(cfg))(*cfg)


def run_chunks(fields: Sequence, *, n_inner: int, K: int,
               one_chunk: Callable):
    """`n_inner // K` full chunks; the K-remainder is the caller's.
    Returns `(*fields, steps_done)`."""
    fields = tuple(fields)
    for _ in range(n_inner // K):
        fields = tuple(one_chunk(*fields))
    return (*fields, (n_inner // K) * K)
