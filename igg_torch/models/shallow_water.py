"""2-D linearized shallow water (the port of `igg.models.shallow_water`):
BASELINE config 3's named family, as pure `igg_torch.stencil` frontend
input.

There is no hand-written kernel for this family: every route it runs on
(the per-step route and the K-step chunk route on CUDA, the plain
composition) is generated from the spec in
:mod:`igg_torch.stencil.library` by :func:`igg_torch.stencil.compile`.  The
module gives the family the surface of the hand-written ones: a `Params`
dataclass, `init_fields`, `make_step`, `run`.  Fields `(h, hu, hv)` of
local shapes `(nx, ny)`, `(nx+1, ny)`, `(nx, ny+1)` on a 2-D grid
(`init_global_grid(nx, ny, 1, ...)`).

Not ported here: the integrity invariant's registration (the spec carries
its `total_mass` declaration) and `tune=`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import fields, shared, tools
from ..timing import time_steps


@dataclasses.dataclass(frozen=True)
class Params:
    g: float = 9.81       # gravity
    H: float = 1.0        # mean depth (gravity-wave speed sqrt(g*H))
    cf: float = 0.0       # linear bottom-friction coefficient
    lx: float = 10.0
    ly: float = 10.0

    def spacing(self) -> Tuple[float, float]:
        return (self.lx / (tools.nx_g() - 1), self.ly / (tools.ny_g() - 1))

    def timestep(self) -> float:
        dx, dy = self.spacing()
        c = (self.g * self.H) ** 0.5
        return min(dx, dy) / c / 4.1

    def coeffs(self) -> dict:
        dx, dy = self.spacing()
        return dict(dt=self.timestep(), dx=dx, dy=dy, g=self.g, H=self.H)


def spec(params: Params = Params()):
    """The family's StencilSpec (:func:`igg_torch.stencil.shallow_water_spec`)."""
    from ..stencil import shallow_water_spec

    return shallow_water_spec(cf=params.cf)


def init_fields(params: Params = Params(), dtype=torch.float32):
    """Gaussian height bump over the mean surface, discharges at rest, from
    global coordinates on the grid's device; returns `(h, hu, hv)`."""
    grid = shared.global_grid()
    nx, ny = grid.nxyz[0], grid.nxyz[1]
    dx, dy = params.spacing()
    h0 = fields.zeros((nx, ny), dtype=dtype)
    X = tools.x_g_field(dx, h0)[:, None].to(dtype)
    Y = tools.y_g_field(dy, h0)[None, :].to(dtype)
    h = (0.1 * torch.exp(-((X - params.lx / 2) ** 2
                           + (Y - params.ly / 2) ** 2)) + 0 * h0)
    return (h, fields.zeros((nx + 1, ny), dtype=dtype),
            fields.zeros((nx, ny + 1), dtype=dtype))


def make_step(params: Params = Params(), *, n_inner: int = 1,
              use_kernels="auto", chunk="auto", K: int = None, verify=None):
    """`(h, hu, hv) -> (h, hu, hv)` advancing `n_inner` steps:
    :func:`igg_torch.stencil.compile` with this family's spec and coeffs
    (`use_kernels`, `chunk`, `K` and `verify` as there; the ladder's
    family is the spec's name, "shallow_water")."""
    from .. import stencil

    return stencil.compile(spec(params), coeffs=params.coeffs(),
                           n_inner=n_inner, use_kernels=use_kernels,
                           chunk=chunk, K=K, verify=verify)


def mass(h) -> float:
    """Total mass: the float64 sum of `h` over the owned cells (each global
    cell once, `igg_torch.gather_interior`)."""
    from ..gather import gather_interior

    return float(gather_interior(h).astype("float64").sum())


def run(nt: int, params: Params = Params(), dtype=torch.float32,
        n_inner: int = 1, use_kernels="auto"):
    """Slope-timed run (:func:`igg_torch.time_steps`, igg's
    `shallow_water.run`): `nt` timed calls in batches of ~nt/4 and ~3nt/4
    after one untimed call, each call advancing `n_inner` steps.  Returns
    `((h, hu, hv), seconds_per_step)`."""
    state = init_fields(params, dtype=dtype)
    step = make_step(params, n_inner=n_inner, use_kernels=use_kernels)
    n1 = max(1, nt // 4)
    state, sec = time_steps(step, state, n1=n1, n2=max(nt - n1, n1 + 1),
                            warmup=1)
    return state, sec / n_inner
