"""The `igg_torch.stencil` spec API: model-as-data physics declarations
(the port of `igg/stencil/spec.py`, pure Python, unchanged in meaning).

A :class:`StencilSpec` is a complete, declarative description of a
stencil time step: :class:`Field` declarations (rank, per-dim
staggering, so `Vx (nx+1, ny)`-style face fields are first-class), a
small traced expression algebra over neighborhood reads (integer-offset
shifts, arithmetic, comparisons, :func:`where` masks, scalar
:class:`Param` leaves), an ORDERED list of :class:`Update`s (later
updates read the fresh values of earlier ones: the Gauss-Seidel chain
every coupled family uses), and per-dim boundary conditions matching the
halo engine's modes (``"periodic"`` / ``"open"`` no-write / ``"any"``).

Index convention (NOT numpy indexing): ``F[ox, oy]`` inside an update
expression is a READ of field ``F`` at the integer ARRAY-INDEX offset
``(ox, oy)`` relative to the cell being written; the index spaces of all
fields are aligned at index 0, the convention of the hand-written
modules (`P[1:, :] - P[:-1, :]` producing the delta for `Vx[1:-1, :]` is
`P[0, 0] - P[-1, 0]` here).  The spec layer never evaluates anything:
lowering (`igg_torch/stencil/lower.py`) realizes one expression tree as
plain tensor algebra, and the generator (`igg_torch/stencil/cuda.py`)
as the CUDA kernels of the per-step and chunk routes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..shared import GridError

__all__ = ["Field", "Param", "Update", "StencilSpec", "where",
           "Expr", "Read", "Const", "ParamRef", "BinOp", "UnOp", "Where"]


# ---------------------------------------------------------------------------
# The expression algebra (build-only; evaluation lives in lower.py)
# ---------------------------------------------------------------------------

# Operator names and their Python spelling.  Scalar subtrees fold in host
# floats exactly like the hand-written modules' `-dt / rho`, so the
# generated tree computes BITWISE what the equivalent hand code computes.
_BINOPS = {"add": "+", "sub": "-", "mul": "*", "truediv": "/",
           "pow": "**", "lt": "<", "le": "<=", "gt": ">", "ge": ">=",
           "eq": "==", "ne": "!="}


def _wrap(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, Field):
        return Read(x, (0,) * x.ndim)
    if isinstance(x, Param):
        return ParamRef(x)
    if isinstance(x, (int, float)):
        return Const(float(x) if isinstance(x, float) else x)
    raise GridError(f"igg_torch.stencil: {x!r} is not usable in a stencil "
                    f"expression (expected a Field read, Param, Expr, or "
                    f"a number).")


class _Alg:
    """Operator mixin shared by Expr, Field, and Param.  `==`/`!=` are
    TRACED comparisons like the orderings (a spec-level `F == 0` must
    become a mask, not a host bool that `where` would constant-fold
    into silently wrong physics), so identity comparison/hash are
    pinned explicitly and the expression dataclasses opt out of their
    generated `__eq__`."""

    __hash__ = object.__hash__

    def __eq__(self, o):
        return BinOp("eq", _wrap(self), _wrap(o))

    def __ne__(self, o):
        return BinOp("ne", _wrap(self), _wrap(o))

    def __add__(self, o):
        return BinOp("add", _wrap(self), _wrap(o))

    def __radd__(self, o):
        return BinOp("add", _wrap(o), _wrap(self))

    def __sub__(self, o):
        return BinOp("sub", _wrap(self), _wrap(o))

    def __rsub__(self, o):
        return BinOp("sub", _wrap(o), _wrap(self))

    def __mul__(self, o):
        return BinOp("mul", _wrap(self), _wrap(o))

    def __rmul__(self, o):
        return BinOp("mul", _wrap(o), _wrap(self))

    def __truediv__(self, o):
        return BinOp("truediv", _wrap(self), _wrap(o))

    def __rtruediv__(self, o):
        return BinOp("truediv", _wrap(o), _wrap(self))

    def __pow__(self, o):
        return BinOp("pow", _wrap(self), _wrap(o))

    def __neg__(self):
        return UnOp("neg", _wrap(self))

    def __lt__(self, o):
        return BinOp("lt", _wrap(self), _wrap(o))

    def __le__(self, o):
        return BinOp("le", _wrap(self), _wrap(o))

    def __gt__(self, o):
        return BinOp("gt", _wrap(self), _wrap(o))

    def __ge__(self, o):
        return BinOp("ge", _wrap(self), _wrap(o))


class Expr(_Alg):
    """Base of the traced expression algebra."""


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Expr):
    value: float


@dataclasses.dataclass(frozen=True, eq=False)
class ParamRef(Expr):
    param: "Param"


class Read(Expr):
    """A neighborhood read: `field` at integer array-index offset
    `offset` relative to the cell being written."""

    def __init__(self, field: "Field", offset: Sequence[int]):
        off = tuple(int(o) for o in offset)
        if len(off) != field.ndim:
            raise GridError(
                f"igg_torch.stencil: field {field.name!r} is {field.ndim}-D but "
                f"was read with a {len(off)}-D offset {off}.")
        self.field = field
        self.offset = off

    def __repr__(self):
        return f"{self.field.name}[{', '.join(map(str, self.offset))}]"


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    a: Expr
    b: Expr

    def __post_init__(self):
        if self.op not in _BINOPS:
            raise GridError(f"igg_torch.stencil: unknown operator {self.op!r}.")


@dataclasses.dataclass(frozen=True, eq=False)
class UnOp(Expr):
    op: str
    a: Expr


@dataclasses.dataclass(frozen=True, eq=False)
class Where(Expr):
    cond: Expr
    a: Expr
    b: Expr


def where(cond, a, b) -> Where:
    """Element-wise select `cond ? a : b` (the algebra's masking
    primitive; lowered to `torch.where`)."""
    return Where(_wrap(cond), _wrap(a), _wrap(b))


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

class Param(_Alg):
    """A scalar coefficient placeholder (dt, dx, g, ...).  Values are
    bound at :func:`igg_torch.stencil.compile` time (`coeffs=`) and fold
    in host floats."""

    def __init__(self, name: str, default: Optional[float] = None):
        self.name = str(name)
        self.default = default

    def __repr__(self):
        return f"Param({self.name!r})"


class Field(_Alg):
    """One declared field: `stagger[d] = 1` gives the field one extra
    cell along dim `d` (an `(nx+1, ny)` face field, the reference's
    per-array `ol(dim, A)` staggering rule).  `F[ox, oy(, oz)]` inside
    an update expression reads the field at that array-index offset."""

    def __init__(self, name: str, *, stagger: Sequence[int] = (0, 0)):
        self.name = str(name)
        self.stagger = tuple(int(s) for s in stagger)
        if any(s not in (0, 1) for s in self.stagger):
            raise GridError(f"igg_torch.stencil: Field({name!r}) stagger "
                            f"{self.stagger} — each entry must be 0 "
                            f"(cell-centered) or 1 (face-staggered).")
        if len(self.stagger) not in (2, 3):
            raise GridError(f"igg_torch.stencil: Field({name!r}) must be 2-D or "
                            f"3-D (stagger length {len(self.stagger)}).")

    @property
    def ndim(self) -> int:
        return len(self.stagger)

    def __getitem__(self, off) -> Read:
        if not isinstance(off, tuple):
            off = (off,)
        return Read(self, off)

    def shift(self, *off) -> Read:
        return Read(self, off)

    def __repr__(self):
        return f"Field({self.name!r}, stagger={self.stagger})"


class Update:
    """One sub-update of the step chain, applied in declaration order.

    `mode="add"` increments the field on its no-write interior (the
    `igg_torch.ops.stencil.interior_add` semantics: boundary planes of every
    padded dim add exactly zero — open-boundary no-write for free); the
    default pad freezes one plane per STAGGERED dim (the `Vx` /
    `((1, 1), (0, 0))` shape), overridable with `pad=`.  `mode="assign"`
    replaces the field full-shape (the pressure-style update whose
    computed boundary IS its value)."""

    def __init__(self, field: Field, expr, mode: str = "add",
                 pad: Optional[Sequence[Tuple[int, int]]] = None):
        if mode not in ("add", "assign"):
            raise GridError(f"igg_torch.stencil: Update mode {mode!r} — expected "
                            f"'add' or 'assign'.")
        self.field = field
        self.expr = _wrap(expr)
        self.mode = mode
        if mode == "assign":
            if pad is not None:
                raise GridError("igg_torch.stencil: 'assign' updates are "
                                "full-shape; pad= applies to 'add' only.")
            self.pad = tuple((0, 0) for _ in range(field.ndim))
        else:
            self.pad = (tuple((int(l), int(h)) for l, h in pad) if pad
                        else tuple((s, s) for s in field.stagger))
        if len(self.pad) != field.ndim:
            raise GridError(f"igg_torch.stencil: Update({field.name!r}) pad "
                            f"{self.pad} does not match field rank "
                            f"{field.ndim}.")
        for lo, hi in self.pad:
            if lo != hi or lo < 0:
                raise GridError(
                    f"igg_torch.stencil: Update({field.name!r}) pad {self.pad} — "
                    f"per-dim pads must be symmetric and non-negative "
                    f"(the no-write halo planes are).")

    def __repr__(self):
        return f"Update({self.field.name}, mode={self.mode!r})"


_BC_MODES = ("periodic", "open", "any")


class StencilSpec:
    """The complete model-as-data step declaration.

    `fields` fixes the state order (the compiled step's argument and
    return order); `updates` is the ordered sub-update chain; `bc` the
    per-dim boundary-condition requirement validated against the live
    grid at compile time (``"any"`` serves both halo-engine modes);
    `init` an optional `(coeffs, dtype) -> state tuple` function on the
    live grid; `invariants` the spec's conserved or bounded quantities
    (:class:`igg_torch.integrity.Invariant` records)."""

    def __init__(self, name: str, *, fields: Sequence[Field],
                 updates: Sequence[Update],
                 params: Sequence[Param] = (),
                 bc: Sequence[str] = None, init=None,
                 invariants: Sequence = ()):
        self.name = str(name)
        self.fields = list(fields)
        self.updates = list(updates)
        self.params = list(params)
        self.init = init
        # Conserved/bounded quantities: `compile` registers them with
        # igg_torch.integrity.
        self.invariants = tuple(invariants)
        for inv in self.invariants:
            if not {f for f in inv.fields} <= {f.name for f in fields}:
                raise GridError(
                    f"igg_torch.stencil: spec {name!r} invariant {inv.name!r} "
                    f"names fields {list(inv.fields)} not all declared "
                    f"({[f.name for f in fields]}).")
        if not self.fields:
            raise GridError("igg_torch.stencil: a spec needs at least one Field.")
        nd = self.fields[0].ndim
        if any(f.ndim != nd for f in self.fields):
            raise GridError(f"igg_torch.stencil: spec {name!r} mixes field ranks "
                            f"({[f.ndim for f in self.fields]}).")
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise GridError(f"igg_torch.stencil: spec {name!r} has duplicate "
                            f"field names {names}.")
        self.bc = tuple(bc) if bc is not None else ("any",) * nd
        if len(self.bc) != nd:
            raise GridError(f"igg_torch.stencil: spec {name!r} bc {self.bc} does "
                            f"not match field rank {nd}.")
        # Unknown BC strings are kept (not rejected here) so the analyzer
        # can refuse them with a reason (igg_torch.stencil.admissible).
        known = set(names)
        for u in self.updates:
            if u.field.name not in known:
                raise GridError(
                    f"igg_torch.stencil: spec {name!r} updates undeclared field "
                    f"{u.field.name!r}.")
            for g, _ in collect_reads(u.expr):
                if g.name not in known:
                    raise GridError(
                        f"igg_torch.stencil: spec {name!r} update of "
                        f"{u.field.name!r} reads undeclared field "
                        f"{g.name!r}.")
        updated = [u.field.name for u in self.updates]
        if len(set(updated)) != len(updated):
            raise GridError(f"igg_torch.stencil: spec {name!r} updates a field "
                            f"twice ({updated}); fold the chain into one "
                            f"Update per field.")
        if not self.updates:
            raise GridError(f"igg_torch.stencil: spec {name!r} has no updates.")

    @property
    def ndim(self) -> int:
        return self.fields[0].ndim

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise GridError(f"igg_torch.stencil: spec {self.name!r} has no field "
                        f"{name!r}.")

    def coeffs(self, overrides: Optional[Dict[str, float]] = None
               ) -> Dict[str, float]:
        """Resolve the spec's Params to python scalars: declared defaults
        overlaid with `overrides`; a Param left unbound raises."""
        out = {}
        overrides = dict(overrides or {})
        for p in self.params:
            if p.name in overrides:
                out[p.name] = overrides.pop(p.name)
            elif p.default is not None:
                out[p.name] = p.default
            else:
                raise GridError(f"igg_torch.stencil: spec {self.name!r} param "
                                f"{p.name!r} has no value (pass coeffs=).")
        if overrides:
            raise GridError(f"igg_torch.stencil: spec {self.name!r} got unknown "
                            f"coeffs {sorted(overrides)} (declared params: "
                            f"{[p.name for p in self.params]}).")
        return out

    def __repr__(self):
        return (f"StencilSpec({self.name!r}, fields="
                f"{[f.name for f in self.fields]}, bc={self.bc})")


def collect_reads(expr: Expr) -> List[Tuple[Field, Tuple[int, ...]]]:
    """Every (field, offset) read in an expression tree."""
    out: List[Tuple[Field, Tuple[int, ...]]] = []

    def walk(e):
        if isinstance(e, Read):
            out.append((e.field, e.offset))
        elif isinstance(e, BinOp):
            walk(e.a)
            walk(e.b)
        elif isinstance(e, UnOp):
            walk(e.a)
        elif isinstance(e, Where):
            walk(e.cond)
            walk(e.a)
            walk(e.b)

    walk(expr)
    return out
