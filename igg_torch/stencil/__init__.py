"""`igg_torch.stencil`: the define-your-own-physics frontend (the port of
`igg.stencil`).

Users declare fields, update expressions and boundary conditions as a
:class:`StencilSpec`; :func:`compile` turns it into a step function on
three routes: the plain composition (the truth), a per-step route and a
K-step chunk route, both on CUDA kernels GENERATED from the spec
(`igg_torch/stencil/cuda.py`, built at first use).  Spec-compiled wave2d
is bitwise the hand-written :mod:`igg_torch.models.wave2d`, and
BASELINE's shallow-water family is pure frontend input
(:mod:`igg_torch.models.shallow_water`).

Naming: `igg_torch.stencil` is THIS package (specs and compilation);
`igg_torch.ops.stencil` holds the lowering's assembly helpers
(`interior_add`).
"""

from .analyze import Analysis, admissible, analyze
from .compile import compile
from .library import shallow_water_spec, wave2d_coeffs, wave2d_spec
from .lower import local_step_fn
from .spec import Field, Param, StencilSpec, Update, where

__all__ = ["Analysis", "Field", "Param", "StencilSpec", "Update",
           "admissible", "analyze", "compile", "local_step_fn",
           "shallow_water_spec", "wave2d_coeffs", "wave2d_spec", "where"]
