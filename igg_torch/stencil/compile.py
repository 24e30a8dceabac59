"""`igg_torch.stencil.compile`: a spec compiled into a step function
interchangeable with the hand-written model factories (the port of
`igg/stencil/compile.py`).

Dispatch (`use_kernels`, the idiom of :mod:`igg_torch.models.wave2d`):

- ``False``: the plain composition (:func:`.lower.local_step_fn`), all in
  plain PyTorch (also on the card);
- ``"auto"`` / ``True``: the kernels generated from the spec
  (:mod:`.cuda`), dispatched as igg's `compile` dispatches its tiers
  (:func:`.lower.fused_spec_steps`): where the chunk admits `n_inner - 1`
  steps (`chunk` not False, `banded` not True), one per-step warm-up step,
  then K-step chunks, then the remainder per step; where the streaming
  banded route takes the call (`banded=True`, or "auto" where the chunk
  refuses), the warm-up step, then K-step chunks of x-row bands of depth
  B (`band`), then the remainder; otherwise one fused per-step launch and
  one grouped halo update per step.  A CPU tensor runs the kernels' plain
  versions.  Where the kernels cannot serve the fields, a CUDA tensor
  raises (never a quiet fallback); so does ``True`` on the CPU, while
  ``"auto"`` on the CPU takes the plain composition.  The banded route's
  band kernel is generated for rank-3 specs only (igg compiles its
  streaming kernel for 3-D fields only): on the card a rank-2 spec with
  `banded=True` raises igg's refusal and "auto" skips the route; on the
  CPU both ranks run its plain realization.

The overlapped composition (`overlap`, "auto", True or False): where the
plain composition serves a call and `overlap` resolves True
(:func:`igg_torch.overlap.resolve_overlap`, admission from the analyzer's
read-set radius, `max(analysis.halo_radius)`, with no per-spec code), the
tier `<spec>.overlap` serves it: the update chain under
:func:`igg_torch.overlap.hide_communication`, bitwise the plain
composition.  The generated kernel routes ignore `overlap`.

The call runs through the spec's tier ladder (`verify=`, igg's; no
quarantine: a kernel tier that disagrees with the plain composition
raises).  Not ported: `tune=` and the family registration with perf,
autotune and integrity (`_register_family`).
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import shared
from ..overlap import hide_communication, resolve_overlap
from ..shared import GridError
from .analyze import admissible, analyze
from .spec import StencilSpec

__all__ = ["compile"]

_KNOBS = ("auto", True, False)


def _kernel_path(spec, cf, use_kernels, fields) -> bool:
    """Whether this call takes the generated kernels (module docstring)."""
    from . import lower
    from .cuda import generator_refusal

    if use_kernels is False:
        return False
    why = (lower.kernel_refusal(spec, shared.global_grid(), fields)
           or generator_refusal(spec, cf))
    on_cpu = fields[0].device.type == "cpu"
    if why is None and (use_kernels == "auto" or not on_cpu):
        return True
    if use_kernels == "auto" and on_cpu:
        return False
    raise GridError(f"the generated {spec.name} kernels cannot serve these "
                    f"fields: {why or 'use_kernels=True needs CUDA tensors'}")


def compile(spec: StencilSpec, *, coeffs: Optional[Dict] = None,
            n_inner: int = 1, use_kernels="auto", chunk="auto",
            K: Optional[int] = None, banded="auto",
            band: Optional[int] = None, overlap="auto", verify=None):
    """`(*fields) -> (*fields)` advancing `n_inner` steps of the spec (new
    tensors; the inputs stay as they were).  `coeffs` binds the spec's
    scalar Params (declared defaults fill the rest); `use_kernels` picks
    the path (module docstring); `chunk` ("auto", True, False) and `K` the
    K-step chunk route, which serves only where the chunk admits it
    (default depth: the largest of 8, 4, 2 it admits); `banded` ("auto",
    True, False), `K` and `band` the streaming banded route; `overlap`
    ("auto", True, False) the overlapped composition.  Needs an
    initialized grid: the analyzer's truth-level gate (boundary
    conditions, reads, read radius against the overlap) runs here and
    raises `GridError` with its reason.

    The call runs through the spec's tier ladder
    (:func:`igg_torch.models._dispatch.auto_dispatch`, family `spec.name`):
    `<spec>.chunk`, `<spec>.banded`, `<spec>.cuda` (the generated per-step
    kernel), `<spec>.overlap` (where `overlap` resolves True) and
    `<spec>.plain`.  `verify="first_use"` checks a kernel tier
    against the plain composition before it serves and raises where they
    disagree."""
    from ..models._dispatch import auto_dispatch, required_routes
    from . import lower
    from .cuda import kernels_for

    shared.global_grid()       # factories need the live grid
    why = admissible(spec)
    if why is not None:
        raise GridError(f"igg_torch.stencil.compile({spec.name!r}): {why}")
    if n_inner < 1:
        raise GridError(f"n_inner must be >= 1, got {n_inner}")
    for name, knob in (("use_kernels", use_kernels), ("chunk", chunk),
                       ("banded", banded)):
        if knob not in _KNOBS:
            raise GridError(f"{name}={knob!r}: expected 'auto', True or "
                            f"False")
    if chunk is True and use_kernels is False:
        raise GridError(f"chunk=True: the K-step {spec.name} spec chunk "
                        f"route runs on the generated kernels, which "
                        f"use_kernels=False excludes")
    if banded is True and (use_kernels is False or chunk is True):
        pin = "chunk=True" if chunk is True else "use_kernels=False"
        raise GridError(f"{lower.banded_requirement(spec)}; {pin} pins "
                        f"another route")
    cf = spec.coeffs(coeffs)
    local = lower.local_step_fn(spec, cf, plain=True)
    nf = len(spec.fields)
    halo_radius = analyze(spec).halo_radius
    radius = max(halo_radius) if halo_radius else 1
    overlap = resolve_overlap(overlap, family=spec.name, radius=radius,
                              ndim=spec.ndim,
                              chunk_active=chunk is True or banded is True)

    def check(fields):
        if len(fields) != nf:
            raise GridError(f"spec {spec.name!r} steps {nf} fields, got "
                            f"{len(fields)}")

    def plan(*fields):
        """The route of a call and its `(Kf, kb)`
        (:func:`igg_torch.stencil.lower.spec_route`)."""
        check(fields)
        if not _kernel_path(spec, cf, use_kernels, fields):
            if banded is True:
                raise GridError(f"{lower.banded_requirement(spec)}; the "
                                f"plain composition serves these fields")
            return "plain", None
        Kf, kb = lower.spec_route(kernels_for(spec, cf), fields,
                                  n_inner=n_inner, K=K, chunk=chunk,
                                  banded=banded, band=band)
        return ("chunk" if Kf else "banded" if kb else "cuda"), (Kf, kb)

    def plain(*fields):
        check(fields)
        for _ in range(n_inner):
            fields = local(*fields)
        return tuple(fields)

    def updates(*fields):
        return lower.apply_updates(spec, fields, cf)

    def overlapped(*fields):
        check(fields)
        for _ in range(n_inner):
            fields = hide_communication(tuple(fields), updates, radius=radius)
        return tuple(fields)

    def kernels(route, *fields):
        return lower.fused_spec_steps(kernels_for(spec, cf), fields,
                                      n_inner=n_inner, route=route)

    return auto_dispatch(
        family=spec.name, plan=plan,
        routes={"chunk": kernels, "banded": kernels, "cuda": kernels},
        plain=plain, overlap=overlapped if overlap else None,
        required=required_routes(use_kernels, banded, chunk), verify=verify)
