"""Built-in spec definitions (the port of `igg/stencil/library.py`).

`wave2d_spec` re-expresses :mod:`igg_torch.models.wave2d` as pure
frontend input, mirroring the hand-written module EXPRESSION-FOR-EXPRESSION,
so the generated routes are bitwise the hand-written ones
(`tests/test_torch_stencil.py` holds it on periodic, open and mixed grids).
`shallow_water_spec` is BASELINE config 3's shallow-water family: the
linearized shallow-water gravity-wave system on an Arakawa-C staggered grid
(cell-centered height `h`, face discharges `hu`/`hv`, optional linear bottom
friction), with no hand-written kernel: every route it runs on is generated
from the spec.
"""

from __future__ import annotations

from ..integrity import Invariant
from .spec import Field, Param, StencilSpec, Update

__all__ = ["Invariant", "wave2d_spec", "wave2d_coeffs", "shallow_water_spec"]


def wave2d_spec() -> StencilSpec:
    """The acoustic-wave leapfrog (:mod:`igg_torch.models.wave2d`) as a
    spec: face velocities from the pressure gradient (no-write staggered
    interiors), then the pressure full-shape from the FRESH velocity
    divergence: the Gauss-Seidel chain, declared in order."""
    P = Field("P", stagger=(0, 0))
    Vx = Field("Vx", stagger=(1, 0))
    Vy = Field("Vy", stagger=(0, 1))
    dt, dx, dy = Param("dt"), Param("dx"), Param("dy")
    rho, bulk = Param("rho"), Param("K")

    def init(coeffs, dtype):
        from ..models import wave2d as m

        return m.init_fields(m.Params(), dtype=dtype)

    return StencilSpec(
        "wave2d_spec",
        fields=[P, Vx, Vy],
        params=[dt, dx, dy, rho, bulk],
        updates=[
            # interior_add(Vx, -dt / rho * (P[1:, :] - P[:-1, :]) / dx)
            Update(Vx, -dt / rho * (P[0, 0] - P[-1, 0]) / dx),
            Update(Vy, -dt / rho * (P[0, 0] - P[0, -1]) / dy),
            # P = P - dt * K * (dVx/dx + dVy/dy), full-shape
            Update(P, P - dt * bulk * ((Vx[1, 0] - Vx[0, 0]) / dx
                                       + (Vy[0, 1] - Vy[0, 0]) / dy),
                   mode="assign"),
        ],
        init=init)


def wave2d_coeffs(params=None) -> dict:
    """The coeffs binding that makes the spec compute exactly what
    `wave2d.make_step(params)` computes (needs the live grid: the spacing
    derives from the global interior size)."""
    from ..models import wave2d as m

    params = params or m.Params()
    dx, dy = params.spacing()
    return dict(dt=params.timestep(), dx=dx, dy=dy, rho=params.rho,
                K=params.K)


def shallow_water_spec(cf: float = 0.0) -> StencilSpec:
    """Linearized shallow water on the C-grid: `dh/dt = -(d(hu)/dx +
    d(hv)/dy)`, `d(hu)/dt = -g H dh/dx - cf hu` (and the y analog):
    gravity-wave speed `sqrt(g H)`, optional linear bottom friction `cf`.
    The friction term is a self-read in an `add` update."""
    h = Field("h", stagger=(0, 0))
    hu = Field("hu", stagger=(1, 0))
    hv = Field("hv", stagger=(0, 1))
    dt, dx, dy = Param("dt"), Param("dx"), Param("dy")
    g, H = Param("g", default=9.81), Param("H", default=1.0)

    ux = -dt * g * H * (h[0, 0] - h[-1, 0]) / dx
    uy = -dt * g * H * (h[0, 0] - h[0, -1]) / dy
    if cf:
        ux = ux - dt * cf * hu[0, 0]
        uy = uy - dt * cf * hv[0, 0]

    def init(coeffs, dtype):
        from ..models import shallow_water as m

        return m.init_fields(m.Params(), dtype=dtype)

    return StencilSpec(
        "shallow_water",
        fields=[h, hu, hv],
        params=[dt, dx, dy, g, H],
        updates=[
            Update(hu, ux),
            Update(hv, uy),
            Update(h, h - dt * ((hu[1, 0] - hu[0, 0]) / dx
                                + (hv[0, 1] - hv[0, 0]) / dy),
                   mode="assign"),
        ],
        init=init,
        # Conservation of mass: the height update is the flux-form
        # divergence of (hu, hv), so the sum of h over owned cells is exact
        # under periodic boundaries.
        invariants=(Invariant("total_mass", ("h",), moment=1,
                              kind="conserved", requires_periodic=True),))
