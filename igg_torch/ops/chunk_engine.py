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
(`csrc/chunk_walk.cuh` for diffusion, the HM3D x-march
`csrc/hm3d_march.cuh` with the chunk's edge rules, `csrc/stagger_walk.cuh` for
wave2d and rank-2 specs, the x-marches on `csrc/stagger_walk3.cuh`'s
layout for Stokes (`csrc/stokes_march.cuh`) and rank-3 specs
(`csrc/stagger_band_march3.cuh`, its chunk mode)); :func:`chunk_cfg` and
:func:`stagger_cfg` give the kernels the layout.

The one function that moves data between blocks is :func:`exchange_slabs`
(as :func:`igg_torch.halo.exchange_planes` is for the halo engine): here
the blocks are stacked in one tensor, so it is an index gather over the
block axis, and a `torch.distributed` backend replaces it.

The streaming banded realization (igg's `banded_window_xla` and
`_streaming_kernel`): K iterations, each sweeping every extended block in
x-row bands of depth B that read the previous iteration's values through a
window of rows `[a - lo, a + B + extras[f])`, clamped to duplicates of the
block's first and last rows of each field, with the per-band halo handling
of :func:`band_halo`.  Its shoulders differ from the window realization's
(clamped rows, exact-row freezes), its central windows do not.
:func:`banded_window_plain` is the plain version of the band kernels, of
any rank; :func:`streaming_chunk_call` their launcher, which on the card
takes 3-D fields only, as igg's compiled streaming kernel does
(layout :func:`band_cfg`: diffusion and HM3D on their x-marches
`csrc/diffusion_march.cuh` and `csrc/hm3d_march.cuh`; layout
:func:`stagger_band_cfg`: Stokes on
the Stokes march's band mode `csrc/stokes_march.cuh`, rank-3 specs on
their own x-march `csrc/stagger_band_march3.cuh`); :func:`banded_refusal`
and :func:`admit_banded_geometry` their gates and `igg_torch.ops._smem`
their shared-memory budget (igg's gates, kept as they are: the marches
walk x in segments of their own, so their shared memory does not depend
on B; the budget prices the band walks of their first designs).

Left out, because they exist only for the TPU: transposed z slabs, the
sublane-tile gates (`admit_sublane_extension`, the band depth's `B % 8`)
and the VMEM budget; the streaming kernel's (8, 128) padding, DMA slots
and semaphores have no counterpart (a launch per iteration ping-pongs two
device buffers).  igg compiles its streaming kernel for 3-D fields only
(wave2d's and rank-2 specs' banded tiers run its interpret mode), and so
does the port: on the card a 2-D field gets igg's refusal.  The TPU's
resident kernel has its counterpart in the chunk kernels of
`csrc/chunk_walk.cuh` (diffusion), `csrc/hm3d_march.cuh` (HM3D) and
`csrc/stokes_chunk.cu`, the whole-window kernel its wave2d instance in
`csrc/wave2d_chunk.cu` and its spec instances generated by
`igg_torch.stencil.cuda`, the streaming kernel its diffusion, HM3D and
Stokes instances in the x-marches `csrc/diffusion_march.cuh`,
`csrc/hm3d_march.cuh` and `csrc/stokes_march.cuh` and its rank-3 spec
instances in the x-march `csrc/stagger_band_march3.cuh`.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..shared import GridError
from ._smem import banded_smem, chunk_budget

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
    `csrc/chunk_walk.cuh`; the HM3D chunk march's `march_chunk_layout` in
    `csrc/march_layout.cuh`, its wraps of overlap 2), as a ctypes int
    array: blocks, extended local
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


# ---------------------------------------------------------------------------
# The streaming banded realization (igg's `banded_window_xla`,
# `streaming_chunk_call`)
# ---------------------------------------------------------------------------

def admit_banded_geometry(shapes, E: int, modes, *, B: int, extras,
                          lo: int = 1) -> Optional[str]:
    """Structural gates of the banded realization (igg's
    `admit_banded_geometry` without its Mosaic gates: `B % 8`, 3-D only
    and the sublane extension): an extended x span that B divides into at
    least two bands, and read margins inside one band.  Returns the
    refusal, or None."""
    base = min(ext_shape(s, E, modes)[0] for s in shapes)
    if B < 1 or base % B != 0:
        return f"extended x span {base} not band-divisible by B={B}"
    if base // B < 2:
        return f"extended x span {base} holds fewer than 2 bands of B={B}"
    if max(extras) + lo > B:
        return (f"read margins lo={lo}/extras={tuple(extras)} exceed one "
                f"band of B={B}")
    return None


def banded_refusal(grid, shape, K: int, n_inner: int, dtype, *, B: int,
                   extras=(1, 1)) -> Optional[str]:
    """Why the band kernels cannot run `n_inner` steps of unstaggered
    fields of local `shape` (one per entry of `extras`, each read
    `extras[f]` rows above a band) at depth K and band B, or None: the
    gates igg's `*_banded_supported` share (a full chunk, unit
    displacement, the grid's block, K-deep send slabs, the band geometry,
    the window budget), float32 or float64, the budget being a thread
    block's shared memory (`igg_torch.ops._smem`)."""
    why = admit_chunk_common(grid, K, n_inner)
    if why is not None:
        return why
    if tuple(shape) != tuple(grid.nxyz):
        return (f"local shape {tuple(shape)} != grid block "
                f"{tuple(grid.nxyz)}")
    if dtype not in (torch.float32, torch.float64):
        return f"dtype {dtype} is not float32/float64"
    modes = dim_modes(grid)
    shapes = [tuple(shape)] * len(extras)
    why = (admit_send_slabs(shapes, field_ols(grid, shapes), K, modes,
                            grid=grid)
           or admit_banded_geometry(shapes, K, modes, B=B, extras=extras))
    if why is not None:
        return why
    need = banded_smem(B, extras, itemsize=torch.finfo(dtype).bits // 8)
    if need > chunk_budget():
        return (f"band window {need} bytes exceeds the shared-memory budget "
                f"{chunk_budget()} of a thread block")
    return None


def band_halo(news, a: int, bx: int, flags, frx, fryz, cfg):
    """Per-band halo handling of the updated fields' new band values
    `news` (rows `[a, a+bx)` of one extended block), in place, in
    dimension order (later dims win shared cells): the x freeze rows of
    open dims, then the y wrap or freeze, then z (a 2-D field stops at y).
    `flags` are the block's six edge flags (:func:`edge_flags`) as ints;
    `frx[(f, side)]` the whole x freeze planes of field f and
    `fryz[(f, d, side)]` its y/z freeze planes cut to the band's rows, all
    chunk-entry values.  Only the rows `lo`/`hi` themselves freeze, not the
    shoulders beyond them.  `cfg` holds `modes`, `ols`, `ext_shapes`,
    `shapes`, `E` and `freeze_fields` (:func:`normalize_freeze`).  Returns
    `news`."""
    modes, ols, ext_shapes, E = (cfg["modes"], cfg["ols"],
                                 cfg["ext_shapes"], cfg["E"])
    nd = news[0].ndim
    freeze = normalize_freeze(cfg["freeze_fields"], nd)
    if modes[0] in ("oext", "frozen"):
        lo = E if modes[0] == "oext" else 0
        for f in freeze[0]:
            hi = lo + cfg["shapes"][f][0] - 1
            for side, row in ((0, lo), (1, hi)):
                if flags[side] and a <= row < a + bx:
                    news[f][row - a].copy_(frx[(f, side)])
    for d in range(1, nd):
        if modes[d] == "wrap":
            for f, u in enumerate(news):
                wrap_edges(u, d, ext_shapes[f][d], ols[f][d])
        elif modes[d] in ("oext", "frozen"):
            lo = E if modes[d] == "oext" else 0
            for f in freeze[d]:
                hi = lo + cfg["shapes"][f][d] - 1
                for side, idx in ((0, lo), (1, hi)):
                    if flags[2 * d + side]:
                        news[f].select(d, idx).copy_(fryz[(f, d, side)])
    return news


def band_core_from_window(core, lo: int, n_up: Optional[int] = None):
    """A `band_update(*windows, bx=)` derived from a family's full-window
    `core(*fields)`: the core applied to the band windows (rows
    `[a-lo, a+bx+extras)` of each field), the central `bx` rows kept.
    `lo` must be the per-iteration margin loss, so that those rows are at
    full validity distance from both window edges; `n_up` keeps the
    updated fields of a core that returns constant fields too."""
    def band_update(*Ws, bx):
        outs = core(*Ws)
        if n_up is not None:
            outs = outs[:n_up]
        return tuple(o[lo:lo + bx] for o in outs)

    return band_update


def _banded_block(entry, *, K, B, lo, modes, ols, shapes, E, band_update,
                  extras, n_up, flags, freeze_fields):
    """K banded iterations of one extended block (igg's
    `banded_window_xla` on one device's buffers): each band reads the
    previous iteration's values, padded at the block's x ends with
    duplicates of its first and last rows."""
    nd = entry[0].ndim
    ext_shapes = [tuple(F.shape) for F in entry]
    base = min(s[0] for s in ext_shapes)
    freeze = normalize_freeze(freeze_fields, nd)
    frx, fryz_full = {}, {}
    for d in range(nd):
        if modes[d] not in ("oext", "frozen"):
            continue
        fr = E if modes[d] == "oext" else 0
        for f in freeze[d]:
            for side, idx in ((0, fr), (1, fr + shapes[f][d] - 1)):
                p = entry[f].select(d, idx)
                if d == 0:
                    frx[(f, side)] = p
                else:
                    fryz_full[(f, d, side)] = p
    cfg = dict(modes=tuple(modes), ols=tuple(ols), E=E,
               ext_shapes=tuple(ext_shapes), shapes=tuple(shapes),
               freeze_fields=freeze_fields)
    S = list(entry)
    for _ in range(K):
        padded = []
        for f, F in enumerate(S):
            top = extras[f] - (ext_shapes[f][0] - base)
            parts = [F[:1]] * lo + [F] + [F[-1:]] * max(top, 0)
            padded.append(torch.cat(parts) if len(parts) > 1 else F)
        D = [F.clone() for F in S[:n_up]]
        for i in range(base // B):
            a = i * B
            Ws = [P.narrow(0, a, lo + B + extras[f])
                  for f, P in enumerate(padded)]
            fryz = {key: p.narrow(0, a, B) for key, p in fryz_full.items()}
            news = band_halo(list(band_update(*Ws, bx=B)), a, B, flags, frx,
                             fryz, cfg)
            for f in range(n_up):
                D[f][a:a + B] = news[f]
        S = D + S[n_up:]
    return S


def banded_window_plain(fields, *, K: int, B: int, lo: int, modes, grid, ols,
                        shapes, E: int, band_update, extras, n_up: int,
                        freeze_fields):
    """K iterations of the banded realization on the extended stacked
    buffers `fields` (the `n_up` updated fields, then constant ones), the
    plain version of the band kernels (igg's `banded_window_xla`, run on
    each block's buffers as igg runs it on each device's): every band's
    window reads the previous iteration's values (ping-pong), clamped to
    duplicates of the BLOCK's first and last rows, and :func:`band_halo`
    handles the band's halo.  `band_update(*windows, bx=)` is the family's
    band core.  Returns the evolved extended buffers (updated fields first,
    constant ones passed through); :func:`central_window` cuts the results
    out."""
    nd = fields[0].ndim
    n = grid.dims[:nd]
    flags = edge_flags(tuple(modes) + ("wrap",) * (3 - nd), grid)
    out = [F.clone() for F in fields[:n_up]]
    for c in itertools.product(*[range(k) for k in n]):
        def block(F):
            for d in range(nd):
                s = F.shape[d] // n[d]
                F = F.narrow(d, c[d] * s, s)
            return F

        fl = flags[tuple(c) + (0,) * (3 - nd)].tolist()
        evolved = _banded_block(
            [block(F) for F in fields], K=K, B=B, lo=lo, modes=modes,
            ols=ols, shapes=shapes, E=E, band_update=band_update,
            extras=extras, n_up=n_up, flags=fl, freeze_fields=freeze_fields)
        for f in range(n_up):
            block(out[f]).copy_(evolved[f])
    return out + list(fields[n_up:])


def band_cfg(ext_stacked, local, E: int, modes, grid, last: bool, *, B: int,
             lo: int, extra: int, ols):
    """The layout the unstaggered band kernels take (`march_band_layout`
    in `csrc/march_layout.cuh`, and `make_band` in `csrc/band_walk.cuh` of
    their first designs), as a ctypes int array: :func:`chunk_cfg`, then
    the band depth, the read margins below and above a band, and the wrap
    overlaps of y and z (`ols` of one field)."""
    cfg = list(chunk_cfg(ext_stacked, local, E, modes, grid, last))
    cfg += [B, lo, extra, ols[1], ols[2]]
    return (ctypes.c_int * len(cfg))(*cfg)


def stagger_band_cfg(shape, E: int, modes, dims, ols, last: bool, *,
                     B: int, lo: int, extras):
    """The layout the staggered band kernels take (`make_sb_layout` in
    `csrc/stagger_band_march3.cuh`, `band_layout` in `csrc/stokes_band.cu`),
    as a ctypes int array: the
    `make_stag3` layout of :func:`stagger_cfg` (base block `shape`, margin
    `E`, the updated fields' overlaps `ols`), then the band depth, the read
    margin below a band and each staged array's margin above it, padded to
    `MAXF` arrays."""
    if len(extras) > MAXF:
        raise ValueError(f"{len(extras)} staged arrays: the band walk takes "
                         f"at most {MAXF}")
    cfg = list(stagger_cfg(shape, E, modes, dims, ols, last))
    cfg += [B, lo] + list(extras) + [lo + 1] * (MAXF - len(extras))
    return (ctypes.c_int * len(cfg))(*cfg)


def streaming_chunk_call(exts, const_exts, *, K: int, B: int, modes, grid,
                         ols, shapes, E: int, band_update, extras,
                         freeze_fields, lo: int = 1, launch=None,
                         central: bool = True, staggered: bool = False,
                         radius: int = 1):
    """K banded iterations of the extended stacked buffers `exts` (updated,
    never written) with the constant `const_exts`; returns the updated
    fields' central windows (`central`) or their whole evolved extended
    buffers.  A CPU tensor takes the plain version
    (:func:`banded_window_plain`), of any rank.  A CUDA tensor runs the
    family's band kernel: `launch(src, dst, cfg)` launches one iteration
    of the buffers `src` into `dst` with the layout `cfg` and counts it;
    K launches ping-pong two sets of buffers, the last writing the central
    windows when `central`.  The layout is :func:`band_cfg` for unstaggered
    fields (fields of one shape and one read margin) and
    :func:`stagger_band_cfg` for staggered ones (`staggered`: fields of the
    grid's block staggered by 0 or 1 per dim, their y/z read `radius`),
    whose every launch writes every cell of its targets, an x-staggered
    field's last row from the source.  The window budget checked here is
    igg's gate (`_smem.banded_smem`), kept for every kernel, those whose
    shared memory does not depend on B included.  The band kernels are 3-D only; a rank, shape,
    dtype or window they cannot take raises a GridError."""
    fields = list(exts) + list(const_exts)
    n_up = len(exts)
    if exts[0].device.type == "cpu":
        out = banded_window_plain(
            fields, K=K, B=B, lo=lo, modes=modes, grid=grid, ols=ols,
            shapes=shapes, E=E, band_update=band_update, extras=extras,
            n_up=n_up, freeze_fields=freeze_fields)[:n_up]
        if not central:
            return tuple(out)
        return tuple(central_window(F, shapes[f], E, modes)
                     for f, F in enumerate(out))
    if exts[0].ndim != 3:
        raise GridError(f"the streaming band kernels are 3-D only "
                        f"({exts[0].ndim}-D fields; banded_window_plain "
                        f"serves them on the CPU)")
    if launch is None:
        raise GridError("streaming_chunk_call: no band kernel for these "
                        "fields on the card")
    local = tuple(grid.nxyz)
    if staggered:
        stags = [tuple(s[d] - local[d] for d in range(3)) for s in shapes]
        if any(t not in (0, 1) for st in stags for t in st):
            raise GridError(f"band kernel: field blocks {shapes} are not the "
                            f"base block {local} staggered by 0 or 1")
    elif (len({tuple(s) for s in shapes}) != 1 or len(set(extras)) != 1
          or len({tuple(o) for o in ols}) != 1):
        raise GridError(f"the unstaggered band kernels take fields of one "
                        f"shape and one read margin (shapes {shapes}, "
                        f"extras {tuple(extras)})")
    else:
        local, stags = tuple(shapes[0]), None
    why = admit_banded_geometry(shapes, E, modes, B=B, extras=extras, lo=lo)
    need = banded_smem(B, extras, lo=lo, itemsize=exts[0].element_size(),
                       stags=stags and [s[1:] for s in stags], radius=radius)
    if why is None and need > chunk_budget():
        why = (f"band window {need} bytes exceeds the shared-memory budget "
               f"{chunk_budget()} of a thread block")
    if why is not None:
        raise GridError(f"band kernel: {why}")
    check_chunk_buffers(fields, shapes, E, modes, grid,
                        (torch.float32, torch.float64))

    def cfg(last):
        if staggered:
            return stagger_band_cfg(local, E, modes, grid.dims, ols[:n_up],
                                    last, B=B, lo=lo, extras=extras)
        return band_cfg(exts[0].shape, local, E, modes, grid, last, B=B,
                        lo=lo, extra=extras[0], ols=ols[0])

    bufs = [tuple(torch.empty_like(X) for X in exts) for _ in range(2)]
    src = tuple(exts)
    for k in range(K):
        last = central and k == K - 1
        dst = (tuple(torch.empty([grid.dims[d] * s[d] for d in range(3)],
                                 dtype=X.dtype, device=X.device)
                     for X, s in zip(exts, shapes)) if last
               else bufs[k % 2])
        launch(src, dst, cfg(last))
        src = dst
    return src
