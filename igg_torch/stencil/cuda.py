"""The CUDA generator: a spec's update chain as a physics policy of the
staggered kernels, compiled at first use.

From a :class:`~igg_torch.stencil.spec.StencilSpec` and its bound
coefficients, :func:`generate` emits one C++ source: a policy and one
extern "C" entry point, `igg_spec_step`, which both the per-step kernel
(table row 13, igg's `_step_kernel`) and the chunk step (row 12's spec
instances, igg's `_whole_window_kernel`) launch: the layout says whether
the targets are whole blocks or a chunk's windows, and which dims wrap or
freeze.  At rank 2 it runs on the walk `csrc/stagger_walk.cuh` (a thread
a run of cells, the policy's `cell` and `cells<VEC>`).  At rank 3 it runs
on the x-march `csrc/stagger_band_march3.cuh` in its step mode (no wrap
and no freeze: the fused step, and chunk steps extended on every dim) or
its chunk mode (wraps and freezes), and a second entry point,
`igg_spec_band_step`, runs the same march in its band mode: one iteration
of the streaming banded chunk (row 6's spec instance, igg's
`_streaming_kernel`).  The three modes compute through the policy's
`mcells`, on the planes the march stages in shared memory; rank 2 gets no
band entry, as igg compiles its streaming kernel for 3-D fields only.  At
rank 3 the generator still emits the walk's per-cell functions and
`cells<VEC>`: only the first design of the step and chunk entry (the walk
of `stagger_walk3_first.cuh`, kept as text in kernel_variants.py with the
band entry's first design) calls them.  It is the counterpart of the body
that Pallas traces from `apply_updates`.

The policy computes, at one cell, the value every field takes after the
whole chain, exactly as :func:`igg_torch.stencil.lower.apply_updates`
computes it:

- each update is a device function of the cell, guarded by its write
  region: outside an `add` update's interior the value is `old + T(0)`
  (the exact `+0` of `interior_add`), and the expression is not read;
  an `assign` update covers the whole field;
- a read of a field that an EARLIER update rewrote is an inline call of
  that update's function at the offset cell (the Gauss-Seidel chain);
  other reads load the source;
- scalar subtrees are folded on the host in double precision by the same
  evaluator as the plain version, passed as a `double` array and cast to
  `T` once (the plain version's 0-dim tensors): no constant is printed;
- the emitted expressions keep the tree's association order, and the
  library is built with `-fmad=false`, so every operation rounds like the
  plain PyTorch version's.

What the generator refuses (`GridError`): a `pow` whose exponent is not
the constant 2 or 3 (`x*x`, `x*x*x`, PyTorch's own special cases), a
comparison used anywhere but as a `where` condition, more than
:data:`igg_torch.ops.chunk_engine.MAXF` fields, and, at rank 3, a
staggered field whose outer face row the kernels cannot write (a constant
staggered field, or an update whose pad leaves that row in its region:
the 3-D kernels keep outer face rows at `old + T(0)`).

Two paths compute the same values with the same operations: on a run of
cells inside every update's write region (almost every run of a block),
`cells<VEC>` forms each update's value at each offset cell the run needs
once and loads each source element once, a run of VEC cells as one
16-byte load where aligned, as `wave2d.cuh`'s run design does; the cells
of a block's edges and wrap aliases go through per-cell functions that
re-evaluate earlier updates inline (:func:`divisions_per_cell` counts
what either costs).  The march's `mcells` and `mu<k>` are the same two
paths over its staged planes (one cell at a time, the x offset of a read
a template argument), emitted after the others.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, List, Optional, Tuple

from ..shared import GridError
from .analyze import analyze
from .lower import _OPS
from .spec import (BinOp, Const, Expr, ParamRef, Read, StencilSpec, UnOp,
                   Where, collect_reads)

__all__ = ["SpecKernels", "generate", "generator_refusal",
           "divisions_per_cell", "band_radius", "ENTRY", "BAND_ENTRY",
           "ARGTYPES"]

# The entry point of every generated library, the band entry of a rank-3
# one, and their C signature: (src, entry, out, dtype, cfg, coef, stream).
ENTRY = "igg_spec_step"
BAND_ENTRY = "igg_spec_band_step"
# The header of the band entry's x-march.
BAND_MARCH = "stagger_band_march3.cuh"
_P = ctypes.c_void_p
ARGTYPES = [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_P),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double), _P]

_ARITH = {"add": "+", "sub": "-", "mul": "*", "truediv": "/"}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
        "ne": "!="}
_XYZ = "ijk"


class _Refused(Exception):
    pass


class _Emitter:
    """The C++ text of one spec's policy (module docstring)."""

    def __init__(self, spec: StencilSpec, coeffs: Dict):
        from ..ops.chunk_engine import MAXF

        self.spec, self.coeffs = spec, coeffs
        self.nd = spec.ndim
        self.index = {f.name: i for i, f in enumerate(spec.fields)}
        self.pos = {u.field.name: k for k, u in enumerate(spec.updates)}
        self.values: List[float] = []
        self.coef_of: Dict[int, str] = {}   # id of a scalar subtree -> c[k]
        if len(spec.fields) > MAXF:
            raise _Refused(f"{len(spec.fields)} fields: the staggered walks "
                           f"take at most {MAXF}")
        if self.nd == 3:
            for f in spec.fields:
                u = self.update_of(f.name)
                for d in range(3):
                    if f.stagger[d] and (u is None or u.pad[d][1] < 1):
                        raise _Refused(
                            f"rank-3 field {f.name!r} is staggered along dim "
                            f"{d} and its outer face row takes "
                            f"{'its old value' if u is None else 'an update'}"
                            f": the 3-D walk keeps outer face rows at "
                            f"old + 0")

    def update_of(self, name):
        for u in self.spec.updates:
            if u.field.name == name:
                return u
        return None

    # -- scalars ------------------------------------------------------------
    def scalar(self, e: Expr):
        """The host value of a subtree without reads (the plain evaluator's
        own arithmetic), or None."""
        if isinstance(e, Const):
            return e.value
        if isinstance(e, ParamRef):
            try:
                return self.coeffs[e.param.name]
            except KeyError:
                raise GridError(f"igg_torch.stencil: param {e.param.name!r} "
                                f"has no bound value.")
        if isinstance(e, Read):
            return None
        if isinstance(e, UnOp):
            a = self.scalar(e.a)
            return None if a is None else -a
        if isinstance(e, BinOp):
            a, b = self.scalar(e.a), self.scalar(e.b)
            return None if a is None or b is None else _OPS[e.op](a, b)
        if isinstance(e, Where):
            c = self.scalar(e.cond)
            if c is None or not isinstance(c, bool):
                return None
            return self.scalar(e.a if c else e.b)
        raise GridError(f"igg_torch.stencil: cannot lower {e!r}.")

    def coef(self, e: Expr, value) -> str:
        """The coefficient of the scalar subtree `e` (one per node, however
        often the node is emitted)."""
        if isinstance(value, bool):
            raise _Refused("a comparison of scalars is used as a value")
        if id(e) not in self.coef_of:
            self.values.append(float(value))
            self.coef_of[id(e)] = f"c[{len(self.values) - 1}]"
        return self.coef_of[id(e)]

    # -- expressions --------------------------------------------------------
    def args(self, off=None) -> str:
        """The argument list of an update function at the current cell
        shifted by `off`."""
        strides = "row" if self.nd == 2 else "sx, sy"
        if off is None or not any(off):
            cs = ", ".join(_XYZ[:self.nd])
            return f"g, {cs}, at, {strides}"
        cs = ", ".join(f"{_XYZ[d]} + ({off[d]})" if off[d] else _XYZ[d]
                       for d in range(self.nd))
        return (f"g, {cs}, sh(at, {strides}, "
                f"{', '.join(str(o) for o in off)}).a, {strides}")

    def offset(self, f: int, off, at: str = "at") -> str:
        terms = [f"{at}[{f}]"]
        strides = (["row"] if self.nd == 2 else ["sx", "sy"])
        for d in range(self.nd - 1):
            if off[d]:
                terms.append(f"({off[d]}) * {strides[d]}[{f}]")
        if off[-1]:
            terms.append(f"({off[-1]})")
        return " + ".join(terms)

    def cell_read(self, name: str, off, k: int) -> str:
        """A read inside the per-cell update function of update `k`: an
        inline call of an earlier update, else a load of the source."""
        if self.pos.get(name, len(self.spec.updates)) < k:
            return f"u{self.pos[name]}({self.args(off)})"
        return f"ld(src[{self.index[name]}] + " \
               f"{self.offset(self.index[name], off)})"

    def expr(self, e: Expr, k: int, read) -> Tuple[str, str]:
        """(code, kind) of `e` inside update `k`, its reads given by
        `read(field name, offset, k)`; kind "T" or "bool"."""
        v = self.scalar(e)
        if v is not None:
            return self.coef(e, v), "T"
        if isinstance(e, Read):
            return read(e.field.name, e.offset, k), "T"
        if isinstance(e, UnOp):
            a = self.value(e.a, k, read)
            return f"(-{a})", "T"
        if isinstance(e, BinOp):
            if e.op in _ARITH:
                a, b = self.value(e.a, k, read), self.value(e.b, k, read)
                return f"({a} {_ARITH[e.op]} {b})", "T"
            if e.op in _CMP:
                a, b = self.value(e.a, k, read), self.value(e.b, k, read)
                return f"({a} {_CMP[e.op]} {b})", "bool"
            if e.op == "pow":
                x = self.scalar(e.b)
                if x is None or isinstance(x, bool) or float(x) not in (2.0,
                                                                       3.0):
                    raise _Refused(f"pow with exponent {e.b!r}: the kernels "
                                   f"take the constant 2 or 3 only")
                a = self.value(e.a, k, read)
                return (f"({a} * {a})" if float(x) == 2.0
                        else f"(({a} * {a}) * {a})"), "T"
            raise GridError(f"igg_torch.stencil: unknown operator {e.op!r}.")
        if isinstance(e, Where):
            c = self.scalar(e.cond)
            if isinstance(c, bool):
                return self.expr(e.a if c else e.b, k, read)
            if c is not None:
                raise _Refused("a where condition is a non-boolean scalar")
            cond, kind = self.expr(e.cond, k, read)
            if kind == "T":
                cond = f"({cond} != T(0))"
            return (f"({cond} ? {self.value(e.a, k, read)} : "
                    f"{self.value(e.b, k, read)})"), "T"
        raise GridError(f"igg_torch.stencil: cannot lower {e!r}.")

    def value(self, e: Expr, k: int, read) -> str:
        code, kind = self.expr(e, k, read)
        if kind != "T":
            raise _Refused("a comparison's result is used as a value (the "
                           "kernels take comparisons as where conditions "
                           "only)")
        return code

    # -- the policy ---------------------------------------------------------
    def update_fn(self, k: int) -> str:
        u = self.spec.updates[k]
        f = self.index[u.field.name]
        cs = ", ".join(f"int {_XYZ[d]}" for d in range(self.nd))
        strides = ("const long long* row" if self.nd == 2
                   else "const long long* sx, const long long* sy")
        body = self.value(u.expr, k, self.cell_read)
        sig = (f"  // {u.field.name}' ({u.mode}, pad {u.pad}) at source-local "
               f"cell ({', '.join(_XYZ[:self.nd])}).\n"
               f"  __device__ __forceinline__ T u{k}(const {self.stag} g, "
               f"{cs}, const long long* at, {strides}) const {{\n")
        if u.mode == "assign":
            return sig + f"    return {body};\n  }}\n"
        conds = []
        for d, (lo, hi) in enumerate(u.pad):
            c = _XYZ[d]
            top = u.field.stagger[d] - hi
            conds.append(f"{c} >= {lo} && {c} < g.s[{d}] + ({top})")
        return (sig + f"    const T old = ld(src[{f}] + at[{f}]);\n"
                f"    if (!({' && '.join(conds)})) return old + T(0);\n"
                f"    return old + {body};\n  }}\n")

    def field_value(self, f: int) -> str:
        k = self.pos.get(self.spec.fields[f].name)
        if k is None:
            return f"ld(src[{f}] + at[{f}])"
        return f"u{k}({self.args()})"

    # -- the band march's view (csrc/stagger_band_march3.cuh) ---------------
    # The march stages each array's x planes in a ring in shared memory, so
    # no linear x stride reaches a neighbour: its reads go through a
    # position `m` (`SbAt`) that holds the ring offsets of the planes
    # t - R .. t + R, the x offset a template argument X, the in-plane
    # offset `q` moved by the window's row width `M::WZ`.  The same
    # expressions in the same association as the functions above.
    @staticmethod
    def march_q(off) -> str:
        q = "q"
        if off[1]:
            q += f" + ({off[1]}) * M::WZ"
        if off[2]:
            q += f" + ({off[2]})"
        return q

    def march_at(self, f: int, off, x: str = "") -> str:
        """Staged array f at offset `off` from the cell of plane X (from the
        march's cell itself where `x` is empty)."""
        xo = (f"{x} + ({off[0]})" if off[0] else x) if x else f"{off[0]}"
        return f"m.template at<{xo}>({f}, {self.march_q(off)})"

    def march_read(self, name: str, off, k: int) -> str:
        """A read inside the march function of update `k`: an inline call
        of an earlier update at the offset cell, else a staged element."""
        if self.pos.get(name, len(self.spec.updates)) < k:
            cs = ", ".join(f"{_XYZ[d]} + ({off[d]})" if off[d] else _XYZ[d]
                           for d in range(3))
            xo = f"X + ({off[0]})" if off[0] else "X"
            return (f"this->template mu{self.pos[name]}<{xo}>(g, {cs}, m, "
                    f"{self.march_q(off)})")
        return self.march_at(self.index[name], off, "X")

    def march_update_fn(self, k: int) -> str:
        u = self.spec.updates[k]
        f = self.index[u.field.name]
        body = self.value(u.expr, k, self.march_read)
        sig = (f"  // {u.field.name}' at the march's cell of plane X.\n"
               f"  template <int X, class M>\n"
               f"  __device__ __forceinline__ T mu{k}(const Stag3& g, int i, "
               f"int j, int k, const M& m,\n"
               f"                                     int q) const {{\n")
        if u.mode == "assign":
            return sig + f"    return {body};\n  }}\n"
        conds = []
        for d, (lo, hi) in enumerate(u.pad):
            c = _XYZ[d]
            top = u.field.stagger[d] - hi
            conds.append(f"{c} >= {lo} && {c} < g.s[{d}] + ({top})")
        return (sig + f"    const T old = {self.march_at(f, (0, 0, 0), 'X')};\n"
                f"    if (!({' && '.join(conds)})) return old + T(0);\n"
                f"    return old + {body};\n  }}\n")

    def march_cells(self) -> str:
        """`mcells`: every field's value after the chain at the march's cell
        (the run block where every evaluation lies in its write region,
        else the per-update functions)."""
        nf = len(self.spec.fields)
        fns = "\n".join(self.march_update_fn(k)
                        for k in range(len(self.spec.updates)))

        def value(f):
            k = self.pos.get(self.spec.fields[f].name)
            if k is None:
                return self.march_at(f, (0, 0, 0))
            return f"this->template mu{k}<0>(g, i, j, k, m, q)"

        return (
            f"{fns}\n"
            "  // Every field at the march's cell (i, j, k): plane 0 of the "
            "position m, in-plane\n"
            "  // offset q (csrc/stagger_band_march3.cuh).\n"
            "  template <class M>\n"
            "  __device__ __forceinline__ void mcells(const Stag3& g, int i, "
            "int j, int k,\n"
            "                                         const M& m, int q, "
            "T* out) const {\n"
            + self.run_block(1, march=True)
            + "".join(f"    out[{f}] = {value(f)};\n" for f in range(nf))
            + "  }\n")

    def run_block(self, n: int, march: bool = False) -> str:
        """The straight-line body of `cells<n>` for a run of n cells along
        the last dim whose every evaluation lies inside its update's write
        region: each update's value at each offset cell the run needs is
        formed once, each source element is loaded once (a run of n cells
        as one `load_run`), and the reads of earlier updates take those
        values.  The same operations in the same order as the per-cell
        functions, so the two agree bitwise.  `march`: the body of the
        band march's `mcells` (n = 1, the elements read from its staged
        planes, :meth:`march_at`)."""
        spec, nd = self.spec, self.nd
        ups = spec.updates
        run0 = tuple(0 for _ in range(nd - 1))
        need = run_needs(spec, n)
        coords = (["i", "j", "k"] if march else
                  ["i", "j0"] if nd == 2 else ["i", "j", "k0"])
        conds = []
        for k, u in enumerate(ups):
            for d in range(nd):
                mn = min(t[d] for t in need[k])
                mx = max(t[d] for t in need[k])
                lo, hi = u.pad[d]
                top = u.field.stagger[d] - hi
                conds.append(f"{coords[d]} + ({mn}) >= {lo} && "
                             f"{coords[d]} + ({mx}) < g.s[{d}] + ({top})")
        loads = set()

        def code(t):
            return "_".join(str(o).replace("-", "m") for o in t)

        def stale(f, t):
            loads.add((f, t))
            return f"L{f}_{code(t)}"

        lines = []
        for k, u in enumerate(ups):
            f = self.index[u.field.name]
            for t in sorted(need[k]):
                def read(name, off, kk, t=t):
                    at = tuple(a + o for a, o in zip(t, off))
                    if self.pos.get(name, len(ups)) < kk:
                        return f"v{self.pos[name]}_{code(at)}"
                    return stale(self.index[name], at)

                body = self.value(u.expr, k, read)
                rhs = body if u.mode == "assign" else f"{stale(f, t)} + {body}"
                lines.append(f"const T v{k}_{code(t)} = {rhs};")
        outs = []
        for f, fld in enumerate(spec.fields):
            k = self.pos.get(fld.name)
            for m in range(n):
                t = run0 + (m,)
                outs.append(f"out[{f}]{'' if march else f'[{m}]'} = "
                            + (stale(f, t) if k is None
                               else f"v{k}_{code(t)}") + ";")
        decl = []
        if march:
            decl = [f"const T L{f}_{code(t)} = {self.march_at(f, t)};"
                    for f, t in sorted(loads)]
            pad = "    "
            cond = (" &&\n" + pad + "    ").join(conds)
            body = "\n".join(pad + "  " + x for x in decl + lines + outs)
            return f"{pad}if ({cond}) {{\n{body}\n{pad}  return;\n{pad}}}\n"
        by_row: Dict[Tuple, List[int]] = {}
        for f, t in sorted(loads):
            by_row.setdefault((f, t[:-1]), []).append(t[-1])
        for (f, lead), bs in sorted(by_row.items()):
            vec = n > 1 and all(b in bs for b in range(n))
            if vec:
                name = f"R{f}_{code(lead + (0,))}"
                decl.append(f"T {name}[{n}];")
                decl.append(f"load_run<T, {n}>(src[{f}] + "
                            f"{self.offset(f, lead + (0,), 'at0')}, {name});")
            for b in bs:
                t = lead + (b,)
                if vec and 0 <= b < n:
                    decl.append(f"const T L{f}_{code(t)} = "
                                f"R{f}_{code(lead + (0,))}[{b}];")
                else:
                    decl.append(f"const T L{f}_{code(t)} = ld(src[{f}] + "
                                f"{self.offset(f, t, 'at0')});")
        pad = "        "
        body = "\n".join(pad + x for x in decl + lines + outs)
        cond = (" &&\n" + pad).join(conds)
        return (f"    if constexpr (VEC == {n}) {{\n"
                f"      if ({cond}) {{\n{body}\n{pad}return;\n      }}\n"
                f"    }}\n")

    @property
    def stag(self) -> str:
        return "Stag&" if self.nd == 2 else "Stag3&"

    def source(self, tag: str) -> str:
        spec, nd = self.spec, self.nd
        nf = len(spec.fields)
        freeze = analyze(spec).freeze
        fns = "\n".join(self.update_fn(k) for k in range(len(spec.updates)))
        runs = "".join(self.run_block(n) for n in (4, 2, 1))
        values = [self.field_value(f) for f in range(nf)]
        nc = max(1, len(self.values))
        st = " ".join(f"{list(f.stagger)}" for f in spec.fields)
        st_table = ", ".join("{" + ", ".join(map(str, f.stagger)) + "}"
                             for f in spec.fields)
        fz_table = ", ".join(
            "{" + ", ".join("1" if f in freeze[d] else "0"
                            for d in range(nd)) + "}" for f in range(nf))
        if nd == 2:
            shift = ("  __device__ __forceinline__ static Off sh(\n"
                     "      const long long* at, const long long* row, int ox,"
                     " int oy) {\n    Off o;\n#pragma unroll\n"
                     "    for (int f = 0; f < NF; ++f) o.a[f] = at[f] + "
                     "ox * row[f] + oy;\n    return o;\n  }\n")
            cell = (
                "  __device__ __forceinline__ void cell(const Stag& g, int i, "
                "int j, const long long* at,\n"
                "                                       const long long* row,"
                " const bool* want,\n"
                "                                       T* out) const {\n"
                + "".join(f"    if (want[{f}]) out[{f}] = {values[f]};\n"
                          for f in range(nf)) + "  }\n\n"
                "  template <int VEC>\n"
                "  __device__ __forceinline__ void cells(const Stag& g, int i,"
                " int j0, const long long* at0,\n"
                "                                        const long long* row,"
                " T (*out)[VEC]) const {\n"
                + runs +
                "#pragma unroll\n    for (int m = 0; m < VEC; ++m) {\n"
                "      const int j = j0 + m;\n"
                "      const Off s = sh(at0, row, 0, m);\n"
                "      const long long* at = s.a;\n"
                + "".join(f"      out[{f}][m] = {values[f]};\n"
                          for f in range(nf)) + "    }\n  }\n")
            launch = ("  Stag g;\n  if (!make_stag(cfg, g)) return "
                      "(int)cudaErrorInvalidValue;\n")
            walk, launcher = "stagger_walk.cuh", "launch_stagger"
        else:
            shift = ("  __device__ __forceinline__ static Off sh(\n"
                     "      const long long* at, const long long* sx, "
                     "const long long* sy, int ox,\n      int oy, int oz) {\n"
                     "    Off o;\n#pragma unroll\n"
                     "    for (int f = 0; f < NF; ++f)\n"
                     "      o.a[f] = at[f] + ox * sx[f] + oy * sy[f] + oz;\n"
                     "    return o;\n  }\n")
            cell = (
                "  template <int VEC>\n"
                "  __device__ __forceinline__ void cells(const Stag3& g, int i,"
                " int j, int k0,\n"
                "                                        const long long* at0,"
                " const long long* sx,\n"
                "                                        const long long* sy,"
                " T (*out)[VEC]) const {\n"
                + runs +
                "#pragma unroll\n    for (int m = 0; m < VEC; ++m) {\n"
                "      const int k = k0 + m;\n"
                "      const Off s = sh(at0, sx, sy, 0, 0, m);\n"
                "      const long long* at = s.a;\n"
                + "".join(f"      out[{f}][m] = {values[f]};\n"
                          for f in range(nf)) + "    }\n  }\n")
            launch = ("  Stag3 g;\n  if (!make_stag3(cfg, g)) return "
                      "(int)cudaErrorInvalidValue;\n")
            walk, launcher = "stagger_walk3.cuh", "launch_stag_xmarch"
        name = f"Spec_{tag}"
        radius = band_radius(spec)
        band = "" if nd == 2 else _BAND_SOURCE.format(name=name, nf=nf,
                                                       nc=nc, entry=BAND_ENTRY)
        march = "" if nd == 2 else "\n" + self.march_cells()
        walks = walk if nd == 2 else f"{BAND_MARCH}'s x-march"
        return f"""\
// Generated by igg_torch/stencil/cuda.py from the spec {spec.name!r}: its
// update chain as a policy of {walks}
// (fields {[f.name for f in spec.fields]}, staggers {st}).  One launch computes every field's value after the whole
// chain at every cell of the walk's targets: on a run of cells inside every
// update's write region each update's value at each offset cell the run
// needs is formed once; elsewhere reads of fields an earlier update rewrote
// are inline calls of that update at the offset cell.  Replaces the
// generated TPU kernels of igg/stencil/lower.py (_step_kernel) and
// igg/ops/chunk_engine.py (_whole_window_kernel and, at rank 3,
// _streaming_kernel: the spec instances).
#include "{walk}"
{"" if nd == 2 else f'#include "{BAND_MARCH}"'}

namespace igg {{

template <typename Real>
struct {name} {{
  using T = Real;
  static constexpr int NF = {nf};
  const T* src[NF];
  T c[{nc}];  // the folded scalar subtrees, each rounded once to T

  struct Off {{
    long long a[NF];
  }};

  __host__ __device__ static constexpr int st(int f, int d) {{
    constexpr int t[NF][{nd}] = {{{st_table}}};
    return t[f][d];
  }}
  __host__ __device__ static constexpr bool freezes(int f, int d) {{
    constexpr int t[NF][{nd}] = {{{fz_table}}};
    return t[f][d] != 0;
  }}

  // The arrays the band walk stages (every field), and the largest index
  // offset of any value `cells` reads.
  static constexpr int NS = NF;
  static constexpr int RADIUS = {radius};
  __device__ __forceinline__ const T* staged(int k) const {{ return src[k]; }}
  __device__ __forceinline__ void restage(int k, const T* p) {{ src[k] = p; }}

{shift}
{fns}
{cell}{march}}};

template <typename T>
int launch_generated(void* const* src, void* const* entry, void* const* out,
                     const int* cfg, const double* coef, cudaStream_t s) {{
{launch}  {name}<T> ph;
  Fields<const T, {nf}> fr;
  Fields<T, {nf}> o;
  for (int f = 0; f < {nf}; ++f) {{
    ph.src[f] = static_cast<const T*>(src[f]);
    fr.p[f] = static_cast<const T*>(entry[f]);
    o.p[f] = static_cast<T*>(out[f]);
  }}
  for (int k = 0; k < {nc}; ++k) ph.c[k] = (T)coef[k];
  return {launcher}(ph, g, fr, o, s);
}}

}}  // namespace igg

// src, entry, out: the fields' pointers of the sources, of the chunk-entry
// buffers (read where a dim freezes; the sources on a step) and of the
// targets; cfg: the walk's layout (igg_torch.ops.chunk_engine.stagger_cfg);
// coef: the {len(self.values)} folded scalars; dtype: 0 float32, 1 float64.
extern "C" int {ENTRY}(void* const* src, void* const* entry,
                             void* const* out, int dtype, const int* cfg,
                             const double* coef, void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return igg::launch_generated<float>(src, entry, out, cfg, coef, s);
  if (dtype == 1)
    return igg::launch_generated<double>(src, entry, out, cfg, coef, s);
  return (int)cudaErrorInvalidValue;
}}
{band}"""


# The band entry of a rank-3 library (one iteration of the streaming banded
# chunk on the x-march of csrc/stagger_band_march3.cuh), with the policy of
# the same source.
_BAND_SOURCE = """
namespace igg {{

template <typename T>
int launch_generated_band(void* const* src, void* const* entry,
                          void* const* out, const int* cfg,
                          const double* coef, cudaStream_t s) {{
  SbLayout b;
  if (!make_sb_layout<{name}<T>>(cfg, b)) return (int)cudaErrorInvalidValue;
  {name}<T> ph;
  Fields<const T, {nf}> fr;
  Fields<T, {nf}> o;
  for (int f = 0; f < {nf}; ++f) {{
    ph.src[f] = static_cast<const T*>(src[f]);
    fr.p[f] = static_cast<const T*>(entry[f]);
    o.p[f] = static_cast<T*>(out[f]);
  }}
  for (int k = 0; k < {nc}; ++k) ph.c[k] = (T)coef[k];
  return launch_stag_march(ph, b, fr, o, s);
}}

}}  // namespace igg

// One banded iteration: src, entry, out as above (entry: the chunk-entry
// buffers), cfg: the layout of igg::make_sb_layout
// (igg_torch.ops.chunk_engine.stagger_band_cfg).
extern "C" int {entry}(void* const* src, void* const* entry,
                              void* const* out, int dtype, const int* cfg,
                              const double* coef, void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return igg::launch_generated_band<float>(src, entry, out, cfg, coef, s);
  if (dtype == 1)
    return igg::launch_generated_band<double>(src, entry, out, cfg, coef, s);
  return (int)cudaErrorInvalidValue;
}}
"""


def band_radius(spec: StencilSpec) -> int:
    """The largest index offset, along any dim, of a value the generated
    `cells<1>` reads at a cell: each update's reads at every offset cell
    where the cell's chain evaluates it (:func:`run_needs`), at least 1.
    The band walk stages each tile with this radius."""
    need = run_needs(spec, 1)
    r = 1
    for k, u in enumerate(spec.updates):
        reads = collect_reads(u.expr) + [(u.field, (0,) * spec.ndim)]
        for t in need[k]:
            for _, off in reads:
                r = max(r, max(abs(a + o) for a, o in zip(t, off)))
    return r


def _tag(spec: StencilSpec) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", spec.name) or "spec"


def generate(spec: StencilSpec, coeffs: Dict) -> Tuple[str, List[float]]:
    """The CUDA source of the spec's kernels and the coefficient values the
    entry point takes; raises `GridError` for a spec the generator refuses
    (module docstring)."""
    try:
        em = _Emitter(spec, coeffs)
        text = em.source(_tag(spec))
    except _Refused as e:
        raise GridError(f"igg_torch.stencil: the CUDA generator refuses spec "
                        f"{spec.name!r}: {e}") from None
    return text, em.values


def generator_refusal(spec: StencilSpec, coeffs: Dict) -> Optional[str]:
    """Why the generator refuses the spec with these coefficients, or
    None."""
    try:
        kernels_for(spec, coeffs)
    except GridError as e:
        return str(e)
    return None


def run_needs(spec: StencilSpec, n: int) -> Dict[int, set]:
    """For a run of n cells along the last dim: update index -> the offset
    cells (relative to the run's first cell) where the run needs that
    update's value, its own n cells and those later updates read."""
    pos = {u.field.name: k for k, u in enumerate(spec.updates)}
    run0 = (0,) * (spec.ndim - 1)
    need = {k: {run0 + (m,) for m in range(n)}
            for k in range(len(spec.updates))}
    for k in reversed(range(len(spec.updates))):
        for g, off in collect_reads(spec.updates[k].expr):
            j = pos.get(g.name, len(spec.updates))
            if j < k:
                need[j] |= {tuple(a + o for a, o in zip(t, off))
                            for t in need[k]}
    return need


def divisions_per_cell(spec: StencilSpec, n: int = 1) -> float:
    """IEEE divisions the generated kernel makes a cell on a run of n cells
    (`cells<n>`, each update's value formed once at every offset cell the
    run needs); n = 1 is the per-cell path of a block's edges and wrap
    aliases.  Divisions of scalar subtrees are folded on the host."""
    def divs(e) -> int:
        if isinstance(e, BinOp):
            own = e.op == "truediv" and (_has_read(e.a) or _has_read(e.b))
            return divs(e.a) + divs(e.b) + own
        if isinstance(e, UnOp):
            return divs(e.a)
        if isinstance(e, Where):
            return divs(e.cond) + divs(e.a) + divs(e.b)
        return 0

    need = run_needs(spec, n)
    return sum(len(need[k]) * divs(u.expr)
               for k, u in enumerate(spec.updates)) / n


def _has_read(e) -> bool:
    from .spec import collect_reads

    return bool(collect_reads(e))


class SpecKernels:
    """The generated kernels of one spec with its coefficients bound: the
    source, the coefficient array the entry point takes, and the spec's
    analysis.  The library is built and loaded at the first launch
    (:func:`igg_torch.ops._build.generated_library`)."""

    def __init__(self, spec: StencilSpec, coeffs: Dict):
        self.spec, self.coeffs = spec, dict(coeffs)
        self.analysis = analyze(spec)
        self.tag = _tag(spec)
        self.source, values = generate(spec, self.coeffs)
        self.coef = (ctypes.c_double * max(1, len(values)))(*values)


@functools.lru_cache(maxsize=64)
def _kernels(spec: StencilSpec, items: Tuple) -> SpecKernels:
    return SpecKernels(spec, dict(items))


def kernels_for(spec: StencilSpec, coeffs: Dict) -> SpecKernels:
    """The (cached) :class:`SpecKernels` of a spec and its coefficients."""
    return _kernels(spec, tuple(sorted(coeffs.items())))
