"""Lowering (the port of `igg/stencil/lower.py`): one spec, three
realizations.

A single expression evaluator (:func:`apply_updates`) is the arithmetic
truth of every route and the plain version of both generated kernels:

- **The plain composition** (:func:`local_step_fn`): the update chain as
  tensor algebra (`igg_torch.ops.stencil.interior_add` for no-write
  increments, plain expressions for full-shape assigns) plus ONE grouped
  `update_halo` over every field, on any grid, boundary condition and
  dtype.
- **The per-step route** (:func:`fused_spec_step`): the whole chain in ONE
  launch of the kernel generated from the spec (:mod:`.cuda`; igg's
  `_step_kernel`, `pallas_call` at `igg/stencil/lower.py:234`), each field
  read once and written once, then the grouped `update_halo`.
- **The K-step chunk route** (:func:`spec_chunk_steps`): fields extended
  `E = margin_after(K)` deep per extended dim by the chunk engine's slab
  exchange, K launches of the same generated kernel on the extended
  buffers (per-field y/z self-wraps, the analyzer's per-dim open-edge
  freezes), the last one writing each block's central window (igg's
  `_whole_window_kernel`, spec instances).  Open dims are admitted only
  where the analyzer's boundary-validity recurrence proves the freeze
  scheme bit-exact (`Analysis.open_chunk_ok`).
- **The streaming banded route** (:func:`spec_banded_steps`, igg's
  `<spec>.banded` rung): the same extension, then K iterations of x-row
  bands of depth B whose windows read the previous iteration
  (`chunk_engine.streaming_chunk_call`), the band core derived from the
  evaluator by `chunk_engine.band_core_from_window` at the analyzer's
  one-iteration margin (:func:`band_margins`); on the card one launch of
  the generated band entry an iteration (rank 3 only, as igg compiles its
  streaming kernel; a rank-2 spec runs the plain realization on the CPU).

Scalar subtrees evaluate in host floats (Python's double precision) and
meet a tensor as a 0-dim tensor of its dtype, so every operation between a
scalar and a tensor, division included, is one IEEE operation in that
dtype, as in the kernels (PyTorch turns `x / float` into `x * (1/float)`
on CUDA, and `float / x` into `x.reciprocal() * float` everywhere).  A
spec mirroring a hand-written module expression for expression produces
BITWISE the hand module's results.

Stacked layout: every field is a block-stacked tensor; the evaluator works
on block-batched views `(n0, S0, n1, S1[, n2, S2])`, so one call updates
every block (or every extended chunk window) at once.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from .. import halo, shared
from ..ops._build import count_launch, generated_library
from ..ops._smem import banded_smem, chunk_budget, fit_banded
from ..ops.chunk_engine import (admit_banded_geometry, admit_chunk_common,
                                admit_send_slabs, band_core_from_window,
                                central_window, check_chunk_buffers,
                                dim_modes, extend_fields, field_ols,
                                run_chunks, stagger_cfg, streaming_chunk_call,
                                window_chunk_plain)
from ..ops.diffusion_pallas import _DTYPE
from ..ops.stencil import divisor
from ..shared import GridError
from .analyze import Analysis
from .spec import BinOp, Const, Expr, ParamRef, Read, StencilSpec, UnOp, Where

__all__ = ["apply_updates", "local_step_fn", "kernel_refusal",
           "step_plain", "step_kernel", "fused_spec_step", "fused_spec_steps",
           "spec_route",
           "chunk_refusal", "fit_spec_K", "window_core", "chunk_plain",
           "chunk_call", "spec_chunk_steps", "field_shapes", "band_margins",
           "banded_refusal", "fit_spec_band", "band_core", "band_call",
           "spec_banded_steps"]

_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "pow": lambda a, b: a ** b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


def _tensor(x, like):
    """`x` as an operand next to a tensor: a scalar becomes a 0-dim tensor
    of `like`'s dtype on its device (rounded once)."""
    return x if isinstance(x, torch.Tensor) else divisor(x, like)


def _eval(expr: Expr, arrays: Dict[str, torch.Tensor], starts, extents,
          coeffs, like):
    """Evaluate one expression over the write region of every block:
    `starts[d]` is the region's first index in the OUTPUT field's block
    index space, `extents[d]` its size; a Read slices its source's blocks
    at `starts + offset` (the analyzer guaranteed the slice is in bounds).
    `arrays` holds block-batched views.  Scalars stay Python scalars until
    they meet a tensor (then `_tensor`, in `like`'s dtype)."""
    if isinstance(expr, Const):
        return expr.value
    if isinstance(expr, ParamRef):
        try:
            return coeffs[expr.param.name]
        except KeyError:
            raise GridError(f"igg_torch.stencil: param {expr.param.name!r} "
                            f"has no bound value.")
    if isinstance(expr, Read):
        A = arrays[expr.field.name]
        sl = []
        for d in range(len(starts)):
            a = starts[d] + expr.offset[d]
            sl += [slice(None), slice(a, a + extents[d])]
        return A[tuple(sl)]
    if isinstance(expr, UnOp):
        return -_eval(expr.a, arrays, starts, extents, coeffs, like)
    if isinstance(expr, BinOp):
        a = _eval(expr.a, arrays, starts, extents, coeffs, like)
        b = _eval(expr.b, arrays, starts, extents, coeffs, like)
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            if expr.op == "pow" and not isinstance(b, torch.Tensor):
                return a ** b        # PyTorch's pow of a Python exponent
            a, b = _tensor(a, like), _tensor(b, like)
        return _OPS[expr.op](a, b)
    if isinstance(expr, Where):
        c = _eval(expr.cond, arrays, starts, extents, coeffs, like)
        a = _eval(expr.a, arrays, starts, extents, coeffs, like)
        b = _eval(expr.b, arrays, starts, extents, coeffs, like)
        if not isinstance(c, torch.Tensor):
            return a if c else b
        if c.dtype != torch.bool:
            c = c != 0
        return torch.where(c, _tensor(a, like), _tensor(b, like))
    raise GridError(f"igg_torch.stencil: cannot lower {expr!r}.")


def _blocks_of(spec: StencilSpec, fields, blocks):
    if blocks is not None:
        return tuple(blocks)
    grid = shared.global_grid()
    s = grid.local_shape_any(fields[0])
    return tuple(fields[0].shape[d] // s[d] for d in range(spec.ndim))


def apply_updates(spec: StencilSpec, fields: Sequence, coeffs: Dict,
                  blocks=None):
    """One step of the spec's update chain on every block of the stacked
    `fields` (local blocks OR extended chunk windows: the evaluator is
    shape-driven), `blocks[d]` blocks along dim d (from the grid when
    None).  Later updates read the fresh values of earlier ones.  Returns
    the new field tuple in spec order; a field no update touches is
    returned as it was given."""
    from ..ops.stencil import interior_add

    nd = spec.ndim
    blocks = _blocks_of(spec, fields, blocks)
    arrays = {}
    for f, A in zip(spec.fields, fields):
        split = []
        for d in range(nd):
            split += [blocks[d], A.shape[d] // blocks[d]]
        arrays[f.name] = A.reshape(split)
    for u in spec.updates:
        U = arrays[u.field.name]
        starts = [lo for lo, _ in u.pad]
        extents = [U.shape[2 * d + 1] - lo - hi
                   for d, (lo, hi) in enumerate(u.pad)]
        val = _eval(u.expr, arrays, starts, extents, coeffs, U)
        if not isinstance(val, torch.Tensor):
            raise GridError(f"igg_torch.stencil: the update of "
                            f"{u.field.name!r} in spec {spec.name!r} reads "
                            f"no field")
        if u.mode == "add":
            pad = sum((((0, 0), p) for p in u.pad), ())
            arrays[u.field.name] = interior_add(U, val, pad)
        else:
            arrays[u.field.name] = val
    updated = {u.field.name for u in spec.updates}
    return tuple(arrays[f.name].reshape(A.shape) if f.name in updated else A
                 for f, A in zip(spec.fields, fields))


def local_step_fn(spec: StencilSpec, coeffs: Dict, plain: bool = False):
    """The per-block step of the plain composition: the update chain plus
    one grouped halo update over every field (`plain=True`: the halo
    writer's plain version).  Returns new tensors."""

    def step(*fields):
        out = apply_updates(spec, fields, coeffs)
        out = tuple(o.clone() if o is A else o for o, A in zip(out, fields))
        new = halo.update_halo_local(*out, plain=plain)
        return new if isinstance(new, tuple) else (new,)

    return step


# ---------------------------------------------------------------------------
# The per-step route
# ---------------------------------------------------------------------------

def field_shapes(spec: StencilSpec, base_shape):
    """Local shapes of every field from the grid block shape."""
    return [tuple(base_shape[d] + f.stagger[d] for d in range(spec.ndim))
            for f in spec.fields]


def kernel_refusal(spec: StencilSpec, grid, fields) -> Optional[str]:
    """Why the generated kernels cannot serve `fields`, or None when they
    can: the gates of igg's `mosaic_supported_fn` (an overlap-2 grid, a
    decomposition that matches the spec's rank, field 0 on the grid block,
    blocks of at least 4 cells per dim) without its VMEM gate, every
    field's staggered blocks, one dtype of float32/float64 and one
    device."""
    nd = spec.ndim
    if len(fields) != len(spec.fields):
        return f"{len(fields)} fields for the spec's {len(spec.fields)}"
    if tuple(grid.overlaps[:nd]) != (2,) * nd:
        return f"grid overlaps {grid.overlaps} != 2 on the spec's {nd} dims"
    A = fields[0]
    if A.ndim != nd:
        return f"field rank {A.ndim} != spec rank {nd}"
    if nd == 2 and (grid.dims[2] != 1 or grid.nxyz[2] != 1):
        return (f"grid is not a 2-D decomposition (dims={tuple(grid.dims)}, "
                f"nz={grid.nxyz[2]})")
    base = tuple(grid.nxyz[:nd])
    for f, X, want in zip(spec.fields, fields, field_shapes(spec, base)):
        if X.ndim != nd or grid.local_shape(X) != want:
            return (f"local shape {grid.local_shape(X)} != grid block {want} "
                    f"(field {f.name!r})")
    if any(b < 4 for b in base):
        return f"local block {base} too small (needs >= 4 cells per dim)"
    if A.dtype not in _DTYPE:
        return f"dtype {A.dtype} is not float32/float64"
    for X in fields:
        if X.dtype != A.dtype or X.device != A.device:
            return (f"fields of {[str(x.dtype) for x in fields]} on "
                    f"{[str(x.device) for x in fields]}: need one dtype and "
                    f"one device")
    return None


def step_plain(gen, fields, blocks):
    """Plain PyTorch version of the generated step kernel: the update chain
    of every block into new tensors (constant fields copied)."""
    out = apply_updates(gen.spec, fields, gen.coeffs, blocks)
    return tuple(o.clone() if o is A else o for o, A in zip(out, fields))


def step_kernel(gen, fields, blocks):
    """The update chain of every block of the stacked `fields` into new
    tensors, with the kernels `gen` (:class:`.cuda.SpecKernels`).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if fields[0].device.type == "cpu":
        return step_plain(gen, fields, blocks)
    out = launch_step(gen, fields, blocks)
    count_launch(step_kernel)
    return out


def _check_cuda(fields, what):
    T = fields[0]
    for X in fields:
        if X.device.type != "cuda" or X.device != T.device:
            raise ValueError(f"{what}: fields on "
                             f"{[str(x.device) for x in fields]}")
        if X.dtype not in _DTYPE or X.dtype != T.dtype:
            raise ValueError(f"{what}: dtypes {[x.dtype for x in fields]}: "
                             f"need one of float32/float64")
        if not X.is_contiguous():
            raise ValueError(f"{what}: fields must be contiguous")


def launch_step(gen, fields, blocks, out=None):
    """Check CUDA fields and launch the generated kernel once on the current
    stream (whole blocks, no wrap, no freeze), into `out` (allocated when
    None).  Counts nothing."""
    spec, nd = gen.spec, gen.spec.ndim
    _check_cuda(fields, f"spec {spec.name!r} step kernel")
    base = tuple(fields[0].shape[d] // blocks[d] - spec.fields[0].stagger[d]
                 for d in range(nd))
    for f, X, s in zip(spec.fields, fields, field_shapes(spec, base)):
        if tuple(X.shape) != tuple(blocks[d] * s[d] for d in range(nd)):
            raise ValueError(f"spec {spec.name!r} step kernel: field "
                             f"{f.name!r} {tuple(X.shape)} does not hold "
                             f"{tuple(blocks)} blocks of {s}")
    if min(base) < 3:
        raise ValueError(f"spec {spec.name!r} step kernel: blocks {base} "
                         f"too small")
    if out is None:
        out = tuple(torch.empty_like(X) for X in fields)
    ptrs = {X.data_ptr() for X in fields}
    for o, X in zip(out, fields):
        if (o.shape != X.shape or o.dtype != X.dtype or o.device != X.device
                or not o.is_contiguous() or o.data_ptr() in ptrs):
            raise ValueError(f"spec {spec.name!r} step kernel: an output is "
                             f"not a fresh contiguous tensor like its source")
        ptrs.add(o.data_ptr())
    cfg = stagger_cfg(base, 0, ("ext",) * nd, blocks, [], False)
    _launch(gen, fields, fields, out, cfg,
            torch.cuda.current_stream(fields[0].device).cuda_stream)
    return tuple(out)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(gen, src, entry, out, cfg, stream: int) -> None:
    """Launch the generated `igg_spec_step` once on checked arguments."""
    lib = generated_library(gen.source, gen.tag)
    err = lib.igg_spec_step(_ptrs(src), _ptrs(entry), _ptrs(out),
                            _DTYPE[src[0].dtype], cfg, gen.coef, stream)
    if err:
        raise RuntimeError(f"igg_spec_step ({gen.spec.name}) launch failed: "
                           f"CUDA error {err}")


step_kernel.launches = 0


def fused_spec_step(gen, fields):
    """One fused step of the grid arrays `fields` into new tensors: the
    whole update chain in one launch of the generated kernel (on CUDA
    tensors), then one grouped halo update of every field."""
    out = step_kernel(gen, fields, shared.global_grid().dims[:gen.spec.ndim])
    new = halo.update_halo_local(*out)
    return new if isinstance(new, tuple) else (new,)


def banded_requirement(spec: StencilSpec) -> str:
    """What `banded=True` needs (the start of its GridError)."""
    return (f"banded=True: the streaming banded {spec.name!r} spec route "
            f"needs the generated kernels (use_kernels 'auto' or True), "
            f"n_inner >= K + 1 >= 3, analyzer-admitted boundary conditions, "
            f"an extended x span of >= 2 bands of B, E-deep send slabs "
            f"inside every extended dimension's block, a band window within "
            f"a thread block's shared memory "
            f"(igg_torch.stencil.lower.banded_refusal), and on the card 3-D "
            f"fields")


def spec_route(gen, fields, *, n_inner: int, K: Optional[int] = None,
               chunk="auto", banded="auto", band: Optional[int] = None,
               K_from_cache: bool = False, band_from_cache: bool = False):
    """The route of :func:`fused_spec_steps` for `fields`: `(Kf, kb)`, the
    chunk depth of the chunk route (0 where it does not serve) and the
    banded route's `(K, B)` (None where it does not serve); both falsy
    means the per-step route.  `K_from_cache`/`band_from_cache` mark
    `K`/`band` as an autotuner's winner's
    (:func:`igg_torch.models._dispatch.resolve_chunk_K`).  Raises where
    `chunk=True` or `banded=True` cannot be served."""
    from ..models._dispatch import band_config, resolve_chunk_K

    spec = gen.spec
    grid = shared.global_grid()
    S0 = fields[0]
    shape = grid.local_shape(S0)
    Kf = 0
    if chunk is not False and banded is not True and n_inner >= 3:
        Kf = resolve_chunk_K(
            K, K_from_cache,
            lambda k: chunk_refusal(spec, gen.analysis, grid, shape, k,
                                    n_inner - 1, S0.dtype) is None,
            lambda: fit_spec_K(spec, gen.analysis, grid, shape, n_inner - 1,
                               S0.dtype))
    if chunk is True and not Kf:
        why = ("n_inner < 3: no warm-up step plus a full chunk" if n_inner < 3
               else chunk_refusal(spec, gen.analysis, grid, shape, K or 2,
                                  n_inner - 1, S0.dtype))
        raise GridError(f"chunk=True: the K-step {spec.name!r} spec chunk "
                        f"route cannot serve n_inner={n_inner}: {why}")
    kb = None
    if not Kf and banded is not False:
        if S0.device.type != "cpu" and spec.ndim != 3:
            if banded is True:
                raise GridError(
                    f"{banded_requirement(spec)}: the streaming band kernel "
                    f"is 3-D only ({spec.ndim}-D x-row bands; "
                    f"banded_window_plain serves them on the CPU)")
        else:
            kb = band_config(
                banded, K, band, n_inner,
                requirement=banded_requirement(spec),
                from_cache=K_from_cache or band_from_cache,
                resident=lambda: chunk is False,
                supported=lambda k, b: banded_refusal(
                    spec, gen.analysis, grid, shape, k, n_inner - 1,
                    S0.dtype, B=b) is None,
                fit=lambda bands: fit_spec_band(
                    spec, gen.analysis, grid, shape, n_inner - 1, S0.dtype,
                    bands=bands))
    return Kf, kb


def fused_spec_steps(gen, fields, *, n_inner: int, K: Optional[int] = None,
                     chunk="auto", banded="auto", band: Optional[int] = None,
                     route=None):
    """`n_inner` steps of `fields` on the generated kernels; returns new
    tensors.  The dispatch of igg's `compile` (its tiers `<spec>.chunk`,
    `<spec>.banded`, the per-step kernel):

    - where `chunk` is not False, `banded` is not True, `n_inner >= 3` and
      the chunk admits `n_inner - 1` steps at a depth K (`K`, or the
      largest of 8, 4, 2 it admits: :func:`fit_spec_K`), one per-step
      warm-up step (which makes the state exchange-fresh, the chunk's entry
      condition), then `(n_inner - 1) // K` chunks, then the remainder per
      step; `chunk=True` raises where no chunk is admitted;
    - where the banded route takes the call (`banded=True`, or "auto"
      where the chunk refuses and `chunk` is not False; `(K, B)` from `K`
      and `band` or :func:`fit_spec_band`, `models._dispatch.band_config`):
      the warm-up, the banded chunks (:func:`spec_banded_steps`), the
      remainder; `banded=True` raises where no `(K, B)` admits, and on the
      card for a rank-2 spec (igg's refusal: the streaming kernel is 3-D
      only), where "auto" skips the route;
    - otherwise one per-step step per step.

    `route` is :func:`spec_route`'s verdict where the caller has it."""
    S = tuple(fields)
    Kf, kb = route or spec_route(gen, S, n_inner=n_inner, K=K, chunk=chunk,
                                 banded=banded, band=band)
    if Kf or kb:
        S = fused_spec_step(gen, S)
        if kb:
            *S, done = spec_banded_steps(gen, S, n_inner=n_inner - 1,
                                         K=kb[0], B=kb[1])
        else:
            *S, done = spec_chunk_steps(gen, S, n_inner=n_inner - 1, K=Kf)
        n_inner -= 1 + done
    for _ in range(n_inner):
        S = fused_spec_step(gen, S)
    return tuple(S)


# ---------------------------------------------------------------------------
# The K-step chunk route
# ---------------------------------------------------------------------------

def chunk_refusal(spec: StencilSpec, analysis: Analysis, grid, shape,
                  K: int, n_inner: int, dtype) -> Optional[str]:
    """Why the depth-K chunk cannot run `n_inner` steps of fields whose
    field-0 blocks are `shape`, or None when it can: the gates of igg's
    `chunk_supported_fn` (a full chunk, unit displacement, the per-step
    kernel's grid gates, open dims only where the analyzer's
    boundary-validity recurrence admits them, `E = margin_after(K)`-deep
    send slabs inside every extended dim's block) without its VMEM and
    float32-only gates; float32 or float64."""
    nd = spec.ndim
    why = admit_chunk_common(grid, K, n_inner)
    if why is not None:
        return why
    if tuple(grid.overlaps[:nd]) != (2,) * nd:
        return f"grid overlaps {grid.overlaps} != 2 on the spec's {nd} dims"
    if nd == 2 and (grid.dims[2] != 1 or grid.nxyz[2] != 1):
        return (f"grid is not a 2-D decomposition (dims={tuple(grid.dims)}, "
                f"nz={grid.nxyz[2]})")
    base = tuple(grid.nxyz[:nd])
    if tuple(shape) != field_shapes(spec, base)[0]:
        return (f"local shape {tuple(shape)} != grid block "
                f"{field_shapes(spec, base)[0]}")
    if dtype not in _DTYPE:
        return f"dtype {dtype} is not float32/float64"
    modes = dim_modes(grid)[:nd]
    if (any(m in ("oext", "frozen") for m in modes)
            and not analysis.open_chunk_ok(K)):
        return (f"open (non-periodic) dimensions {modes}: the analyzer's "
                f"boundary-validity recurrence refuses the plane-freeze "
                f"chunk evolution for spec {spec.name!r} (a boundary-adjacent "
                f"read would land on shoulder garbage); the per-step route "
                f"carries open boundaries")
    E = analysis.margin_after(K)
    shapes = field_shapes(spec, base)
    return admit_send_slabs(shapes, field_ols(grid, shapes), E, modes,
                            grid=grid)


def fit_spec_K(spec: StencilSpec, analysis: Analysis, grid, shape,
               n_inner: int, dtype, K: Optional[int] = None) -> int:
    """The chunk depth of the chunk route: `K` where given and admitted,
    else the largest of 8, 4, 2 the chunk admits; 0 when none is."""
    for k in ((K,) if K else (8, 4, 2)):
        if chunk_refusal(spec, analysis, grid, shape, k, n_inner,
                         dtype) is None:
            return k
    return 0


def window_core(gen, grid):
    """The update chain on every extended block (`apply_updates` on the
    extended stacked buffers)."""
    blocks = grid.dims[:gen.spec.ndim]
    return lambda *fields: apply_updates(gen.spec, fields, gen.coeffs, blocks)


def chunk_plain(gen, exts, *, K, E, modes, grid, ols):
    """Plain PyTorch version of a chunk: K window steps of the extended
    buffers (:func:`chunk_engine.window_chunk_plain`, the analyzer's
    per-dim freeze sets).  Returns the evolved extended buffers."""
    return window_chunk_plain(list(exts), K=K, E=E, modes=modes, grid=grid,
                              core=window_core(gen, grid),
                              freeze_fields=gen.analysis.freeze, ols=ols)


def chunk_call(gen, exts, shapes, *, K, E, modes, grid, ols):
    """Advance the extended stacked buffers `exts` (blocks `shapes`
    extended by E) by K steps and return every block's central windows
    (new tensors).  A CPU tensor takes the plain version; a CUDA tensor
    launches the generated kernel K times, ping-ponging two buffer sets,
    the last launch writing the outputs, or raises."""
    nd = gen.spec.ndim
    if exts[0].device.type == "cpu":
        return tuple(central_window(U, s, E, modes) for U, s in zip(
            chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=grid,
                        ols=ols), shapes))
    check_chunk_buffers(list(exts), shapes, E, modes, grid, _DTYPE)
    base = tuple(grid.nxyz[:nd])
    if list(shapes) != field_shapes(gen.spec, base):
        raise ValueError(f"spec {gen.spec.name!r} chunk: blocks {shapes} are "
                         f"not the spec's fields on {base}")
    out = tuple(torch.empty([grid.dims[d] * s[d] for d in range(nd)],
                            dtype=exts[0].dtype, device=exts[0].device)
                for s in shapes)
    bufs = [tuple(torch.empty_like(X) for X in exts) for _ in range(2)]
    stream = torch.cuda.current_stream(exts[0].device).cuda_stream
    src = tuple(exts)
    for k in range(K):
        last = k == K - 1
        dst = out if last else bufs[k % 2]
        _launch(gen, src, exts, dst,
                stagger_cfg(base, E, modes, grid.dims, ols, last), stream)
        count_launch(chunk_call)
        src = dst
    return out


chunk_call.launches = 0


def spec_chunk_steps(gen, fields, *, n_inner: int, K: int):
    """Advance `fields` by the `n_inner // K` full chunks of depth K;
    returns `(*fields, steps_done)` and leaves the remainder to the
    caller.  Entry contract (igg's): an overlap-consistent, exchange-fresh
    state, which a per-step step gives."""
    spec = gen.spec
    grid = shared.global_grid()
    nd = spec.ndim
    modes = dim_modes(grid)[:nd]
    E = gen.analysis.margin_after(K)
    shapes = field_shapes(spec, grid.nxyz[:nd])
    ols = field_ols(grid, shapes)

    def one(*S):
        exts = extend_fields(list(S), ols, E, grid, modes)
        return chunk_call(gen, exts, shapes, K=K, E=E, modes=modes,
                          grid=grid, ols=ols)

    return run_chunks(tuple(fields), n_inner=n_inner, K=K, one_chunk=one)


# ---------------------------------------------------------------------------
# The streaming banded route (igg's `<spec>.banded` rung)
# ---------------------------------------------------------------------------

def band_margins(spec: StencilSpec, analysis: Analysis):
    """The banded scheme's read margins (igg's `_band_margins`): the low
    margin is the analyzer's one-iteration validity loss (so
    `band_core_from_window` keeps rows at full validity distance from both
    window edges), the per-field high margins add the x-stagger."""
    lo = analysis.margin_after(1)
    return lo, tuple(lo + f.stagger[0] for f in spec.fields)


def banded_refusal(spec: StencilSpec, analysis: Analysis, grid, shape,
                   K: int, n_inner: int, dtype, *,
                   B: int = 8) -> Optional[str]:
    """Why the banded route cannot run `n_inner` steps of fields whose
    field-0 blocks are `shape` at depth K and band B, or None when it can:
    the gates of igg's `banded_supported_fn` (the chunk route's structural
    gates, :func:`chunk_refusal`, then the band geometry at the margins of
    :func:`band_margins`) without its Mosaic gates (`B % 8`, 3-D only, the
    sublane extension), its VMEM budget and its float32 gate; at rank 3,
    the band kernel's window within a thread block's shared memory and a
    read radius within the band's low margin.  float32 or float64."""
    why = chunk_refusal(spec, analysis, grid, shape, K, n_inner, dtype)
    if why is not None:
        return why
    from .cuda import band_radius

    nd = spec.ndim
    modes = dim_modes(grid)[:nd]
    shapes = field_shapes(spec, grid.nxyz[:nd])
    lo, extras = band_margins(spec, analysis)
    why = admit_banded_geometry(shapes, analysis.margin_after(K), modes, B=B,
                                extras=extras, lo=lo)
    if why is not None or nd != 3:
        return why
    radius = band_radius(spec)
    if radius > lo:
        return (f"read radius {radius} exceeds the band's low margin {lo} "
                f"(the band kernel's window)")
    need = banded_smem(B, extras, lo=lo,
                       itemsize=torch.finfo(dtype).bits // 8,
                       stags=[f.stagger[1:] for f in spec.fields],
                       radius=radius)
    if need > chunk_budget():
        return (f"band window {need} bytes exceeds the shared-memory budget "
                f"{chunk_budget()} of a thread block")
    return None


def fit_spec_band(spec: StencilSpec, analysis: Analysis, grid, shape,
                  n_inner: int, dtype, kmax: int = 8, bands=(8, 16)):
    """Largest admissible `(K, B)` of the banded route (igg's
    `fit_spec_band`, `_smem.fit_banded`); None when none applies."""
    return fit_banded(
        lambda K, B: banded_refusal(spec, analysis, grid, shape, K, n_inner,
                                    dtype, B=B) is None, kmax, bands=bands)


def band_core(gen):
    """The band core of the plain version: the evaluator on one block's band
    windows, its central rows kept (`chunk_engine.band_core_from_window` at
    the low margin of :func:`band_margins`)."""
    nd = gen.spec.ndim
    lo, _ = band_margins(gen.spec, gen.analysis)
    return band_core_from_window(
        lambda *W: apply_updates(gen.spec, W, gen.coeffs, (1,) * nd), lo)


def band_call(gen, exts, shapes, *, K, B, E, modes, grid, ols,
              central: bool = True):
    """K banded iterations of the extended stacked buffers `exts` (blocks
    `shapes` extended by E): every block's central windows (`central`),
    or the whole evolved extended buffers.  A CPU tensor takes the plain
    version (any rank); a CUDA tensor launches the generated band entry K
    times (`chunk_engine.streaming_chunk_call`, rank 3 only), or
    raises."""
    from .cuda import band_radius

    lo, extras = band_margins(gen.spec, gen.analysis)

    def launch(src, dst, cfg):
        _band_launch(gen, src, exts, dst, cfg,
                     torch.cuda.current_stream(exts[0].device).cuda_stream)
        count_launch(band_call)

    return streaming_chunk_call(
        list(exts), [], K=K, B=B, modes=modes, grid=grid, ols=ols,
        shapes=list(shapes), E=E, band_update=band_core(gen), extras=extras,
        freeze_fields=gen.analysis.freeze, lo=lo, launch=launch,
        central=central, staggered=True, radius=band_radius(gen.spec))


def _band_launch(gen, src, entry, out, cfg, stream: int) -> None:
    """Launch the generated `igg_spec_band_step` once (layout `cfg`,
    `chunk_engine.stagger_band_cfg`) on checked arguments."""
    lib = generated_library(gen.source, gen.tag)
    err = lib.igg_spec_band_step(_ptrs(src), _ptrs(entry), _ptrs(out),
                                 _DTYPE[src[0].dtype], cfg, gen.coef, stream)
    if err:
        raise RuntimeError(f"igg_spec_band_step ({gen.spec.name}) launch "
                           f"failed: CUDA error {err}")


band_call.launches = 0


def spec_banded_steps(gen, fields, *, n_inner: int, K: int, B: int):
    """Advance `fields` by the `n_inner // K` full chunks of depth K through
    the banded route (band depth B); returns `(*fields, steps_done)` and
    leaves the warm-up step before and the remainder after to the caller.
    Entry contract: that of :func:`spec_chunk_steps`."""
    spec = gen.spec
    grid = shared.global_grid()
    nd = spec.ndim
    modes = dim_modes(grid)[:nd]
    E = gen.analysis.margin_after(K)
    shapes = field_shapes(spec, grid.nxyz[:nd])
    ols = field_ols(grid, shapes)

    def one(*S):
        exts = extend_fields(list(S), ols, E, grid, modes)
        return band_call(gen, exts, shapes, K=K, B=B, E=E, modes=modes,
                         grid=grid, ols=ols)

    return run_chunks(tuple(fields), n_inner=n_inner, K=K, one_chunk=one)
