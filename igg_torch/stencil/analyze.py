"""The read-set analyzer (the port of `igg/stencil/analyze.py`): the
window/margin analysis the hand-written chunk modules derive by hand,
computed from the spec's expressions.

For a :class:`~igg_torch.stencil.spec.StencilSpec` it derives:

- **Per-field halo radius** per dim (max read reach across every
  update), which gates the per-step routes: one grouped exchange per
  step delivers `ol - 1` fresh cells per side, so a spec reading
  farther is refused ("oversized read radius").
- **Chunk margins**: the exact per-side validity-margin recurrence of
  the update chain (stale no-write planes + read reach, fresh
  intra-step values for already-updated fields), iterated K steps:
  `margin_after(K)` is the extension depth E the K-step chunk route
  needs (the hand wave2d chunk's `E = 2K` is twice what the spec-wave2d
  chain needs).
- **Per-dim freeze sets** for open boundaries: the fields whose update
  leaves their dim-`d` boundary planes unwritten (`pad[d] > 0`) own
  frozen no-write planes there; full-`assign` fields' computed boundary
  IS their value (the Stokes-pressure rule).  `open_chunk_ok` runs the
  boundary-adjacent validity recurrence (plane-frozen reads vs shoulder
  garbage) that decides whether the chunk route may serve open dims.
- **The analytic accesses count** (distinct fields read + fields
  written: wave2d 6, diffusion 3, stokes 9).

:func:`admissible` is the truth-level gate: boundary conditions and read
radii that the plain composition itself cannot serve are refused with a
reason naming the rule (None when the spec is served; igg returns an
`igg.degrade.Admission`, whose tier ladder the port has not yet).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from .spec import StencilSpec, collect_reads, _BC_MODES

__all__ = ["Analysis", "analyze", "admissible"]


@dataclasses.dataclass(frozen=True)
class Analysis:
    """The derived read-set facts of one spec (all pure host data)."""
    spec: StencilSpec
    # field name -> per-dim (low reach, high reach) across all updates
    radius: Dict[str, Tuple[Tuple[int, int], ...]]
    # max read reach per dim over all fields (the exchange requirement)
    halo_radius: Tuple[int, ...]
    # dim -> tuple of field indices with frozen no-write planes there
    freeze: Dict[int, Tuple[int, ...]]
    # distinct fields read + fields written (the bytes/step model)
    accesses: int
    # fields never updated (loop constants: valid everywhere, never
    # extended-stale)
    const_fields: Tuple[int, ...]

    def margin_after(self, K: int) -> int:
        """Exact max validity margin (cells per side, any field/dim)
        after `K` exchange-less steps: the chunk route's extension
        depth E."""
        return _margin_after(self.spec, K)

    def open_chunk_ok(self, K: int) -> bool:
        """Whether the chunk route's window evolution stays bit-exact on
        open (no-write) dims for `K` steps: every boundary-adjacent read
        must land on a frozen plane or a computed-valid row, never on
        the beyond-domain shoulder."""
        return _open_ok(self.spec, K)


# Specs are identity-hashed (the algebra's `==` is traced, so content
# equality is deliberately absent): the caches below memoize per spec
# OBJECT (`fit_spec_K` asks margin_after / open_chunk_ok several times).

@functools.lru_cache(maxsize=256)
def analyze(spec: StencilSpec) -> Analysis:
    nd = spec.ndim
    radius: Dict[str, List[Tuple[int, int]]] = {
        f.name: [(0, 0)] * nd for f in spec.fields}
    read_names = set()
    for u in spec.updates:
        reads = collect_reads(u.expr)
        if u.mode == "add":
            reads = reads + [(u.field, (0,) * nd)]
        for g, off in reads:
            read_names.add(g.name)
            r = radius[g.name]
            for d in range(nd):
                lo, hi = r[d]
                r[d] = (max(lo, -off[d]), max(hi, off[d]))
    halo = tuple(max(max(r[d]) for r in radius.values())
                 for d in range(nd))
    updated = {u.field.name for u in spec.updates}
    freeze = {}
    for d in range(nd):
        fz = tuple(i for i, f in enumerate(spec.fields)
                   if f.name in updated
                   and _update_of(spec, f.name).pad[d][0] > 0)
        freeze[d] = fz
    const = tuple(i for i, f in enumerate(spec.fields)
                  if f.name not in updated)
    accesses = len(read_names) + len(updated)
    return Analysis(spec=spec,
                    radius={k: tuple(v) for k, v in radius.items()},
                    halo_radius=halo, freeze=freeze, accesses=accesses,
                    const_fields=const)


def _update_of(spec, name):
    for u in spec.updates:
        if u.field.name == name:
            return u
    return None


@functools.lru_cache(maxsize=1024)
def _margin_after(spec: StencilSpec, K: int) -> int:
    """Iterate the chain's margin recurrence K times from the
    exchange-fresh state.  Per update, a written cell is valid iff every
    read lands on a valid cell of its source (fresh margins for fields
    updated EARLIER in the same step — the Gauss-Seidel chain), and the
    no-write pad planes go stale; constants never decay."""
    nd = spec.ndim
    updated = {u.field.name for u in spec.updates}
    m = {f.name: [(0, 0)] * nd for f in spec.fields}
    for _ in range(K):
        for u in spec.updates:
            reads = collect_reads(u.expr)
            if u.mode == "add":
                reads = reads + [(u.field, (0,) * nd)]
            out = []
            for d in range(nd):
                lo, hi = u.pad[d]
                for g, off in reads:
                    glo, ghi = m[g.name][d]
                    # Low side: all index spaces align at 0.  High side:
                    # field tops sit stagger-many rows apart, so the
                    # distance-from-top bookkeeping shifts by the
                    # stagger difference (a face field's extra row).
                    lo = max(lo, glo - off[d])
                    hi = max(hi, ghi + off[d]
                             + (u.field.stagger[d] - g.stagger[d]))
                out.append((lo, hi))
            m[u.field.name] = out
    worst = 0
    for f in spec.fields:
        if f.name in updated:
            for lo, hi in m[f.name]:
                worst = max(worst, lo, hi)
    return worst


@functools.lru_cache(maxsize=1024)
def _open_ok(spec: StencilSpec, K: int) -> bool:
    """The boundary-adjacent validity recurrence for one open side.

    Window coordinates: row `lo` is the frozen/computed boundary plane,
    rows `< lo` the beyond-domain shoulder (garbage), rows `> lo` the
    interior.  Per field track `(lo_valid, bad)` — whether the boundary
    row itself is valid, and how many rows strictly above it are not.
    The chunk realizations re-freeze exactly the boundary PLANE of the
    per-dim freeze set each iteration (not the whole shoulder band), so
    a read below the boundary is invalid even for frozen fields."""
    nd = spec.ndim
    const = {f.name for f in spec.fields
             if _update_of(spec, f.name) is None}
    freeze_by_dim = analyze(spec).freeze
    for d in range(nd):
        frozen = {spec.fields[i].name for i in freeze_by_dim[d]}
        for side in (0, 1):
            st = {f.name: (True, 0) for f in spec.fields}
            for _ in range(K):
                for u in spec.updates:
                    reads = collect_reads(u.expr)
                    if u.mode == "add":
                        reads = reads + [(u.field, (0,) * nd)]

                    def ok(g, off, t):
                        if g.name in const:
                            return True
                        # Effective offset in boundary-distance terms:
                        # the low boundaries align at index 0; the high
                        # boundaries sit stagger-many rows apart.
                        o = (off[d] if side == 0
                             else -off[d] + (g.stagger[d]
                                             - u.field.stagger[d]))
                        lv, bad = st[g.name]
                        tgt = t + o
                        if tgt < 0:
                            return False
                        if tgt == 0:
                            return lv or g.name in frozen
                        return tgt > bad

                    b = 0
                    while b <= K + 4 and not all(
                            ok(g, off, 1 + b) for g, off in reads):
                        b += 1
                    lv = (u.field.name in frozen) or all(
                        ok(g, off, 0) for g, off in reads)
                    st[u.field.name] = (lv, b)
            for f in spec.fields:
                if f.name in const:
                    continue
                lv, bad = st[f.name]
                if bad > 0 or not lv:
                    return False
    return True


# ---------------------------------------------------------------------------
# The truth-level admission gate
# ---------------------------------------------------------------------------

def admissible(spec: StencilSpec, grid=None) -> Optional[str]:
    """Why the spec cannot be served AT ALL on `grid` (the live grid when
    None; the grid-free rules only when none is initialized), or None when
    it can: unknown boundary-condition strings, BC/grid periodicity
    mismatches, reads outside the source array over the write region, and
    read radii the per-step halo exchange cannot deliver
    (`radius > ol - 1`).  :func:`igg_torch.stencil.compile` raises
    `GridError` carrying the same reason."""
    nd = spec.ndim
    for d, bc in enumerate(spec.bc):
        if bc not in _BC_MODES:
            return (f"unsupported boundary condition {bc!r} on dim {d} "
                    f"(the halo engine serves 'periodic' and 'open' "
                    f"no-write; 'any' accepts both)")
    # Read-slice bounds: over the write region [lo, size-hi) of U, a read
    # of G at offset o slices G[lo+o : size_U-hi+o], in bounds iff
    # -lo <= o <= hi + (stagger_G - stagger_U).  Purely spec-determined.
    for u in spec.updates:
        for g, off in collect_reads(u.expr):
            for d in range(nd):
                lo, hi = u.pad[d]
                top = hi + g.stagger[d] - u.field.stagger[d]
                if off[d] < -lo or off[d] > top:
                    return (f"read {g.name}[{', '.join(map(str, off))}] in "
                            f"the update of {u.field.name!r} falls outside "
                            f"the source array over the write region (dim "
                            f"{d}: offset must lie in [{-lo}, {top}])")
    if grid is None:
        from .. import shared

        if not shared.grid_is_initialized():
            return None
        grid = shared.global_grid()
    a = analyze(spec)
    for d in range(nd):
        bc = spec.bc[d]
        per = bool(grid.periods[d])
        if bc == "periodic" and not per:
            return (f"spec {spec.name!r} requires a periodic dim {d} but the "
                    f"grid is open there (periods={tuple(grid.periods)})")
        if bc == "open" and per:
            return (f"spec {spec.name!r} requires an open dim {d} but the "
                    f"grid is periodic there (periods={tuple(grid.periods)})")
        need = a.halo_radius[d] + 1
        if grid.overlaps[d] < need:
            return (f"oversized read radius {a.halo_radius[d]} on dim {d}: "
                    f"one exchange per step delivers ol-1 = "
                    f"{grid.overlaps[d] - 1} fresh cell(s) per side (needs "
                    f"overlap >= {need}; init the grid with "
                    f"overlap{'xyz'[d]}={need})")
    return None
