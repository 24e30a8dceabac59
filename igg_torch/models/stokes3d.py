"""3-D staggered-grid Stokes solver: the stokes3d family
(`igg.models.stokes3d`).

BASELINE config 5 ("3-D staggered-grid Stokes solver with comm/compute
overlap"): a pseudo-transient relaxation of the cell-centred pressure
`P (nx, ny, nz)` and the face velocities `Vx (nx+1, ny, nz)`, `Vy (nx,
ny+1, nz)` and `Vz (nx, ny, nz+1)`, driven by the buoyancy of a dense
spherical inclusion `Rho (nx, ny, nz)`, which never changes.  The grid
has overlap 3 in every dim (the radius-2 Gauss-Seidel chain); each
velocity's overlap along its own dim is 4, so its halo planes sit one row
deeper (the per-array `ol(dim, A)` rule).  The four updated fields share
one halo update per iteration.  Iterations run on the block-stacked grid
arrays of :mod:`igg_torch.fields`.

:func:`iteration_core` is the arithmetic truth of every path: the plain
composition, the window core of the chunk route, and the plain versions
the kernels (`csrc/stokes_step.cu`, `csrc/stokes_march.cuh`) are held to.  It keeps igg's association
order exactly, which the kernels follow to be bitwise:

- `divV = ((dVx/dx + dVy/dy) + dVz/dz)`, the sum of three quotients;
- `P' = P - dtP*divV` on every cell of the block;
- normal stresses `(2.0*mu) * (dV/d - divV/3.0)`, with `2.0*mu` a Python
  float product rounded once to the field's dtype, and `divV / 3.0` an
  IEEE division;
- shear stresses `mu * (dVa/db + dVb/da)` on the block's interior edges;
- residuals `((dtau_n/d + dtau_s1/d1) + dtau_s2/d2) - dP'/d`, plus
  `0.5 * (Rho_hi + Rho_lo)` on z (buoyancy drives `Vz`);
- velocity increments `dtV * r` on each velocity's interior faces, added
  with an exact `+0` on the block's outer faces (igg's `interior_add`).

Coefficients are rounded once to the field's dtype; divisions are by 0-dim
tensors (:func:`igg_torch.ops.stencil.divisor`): on a CUDA tensor PyTorch
turns `x / float` into `x * (1/float)`, which rounds differently.
Staggered fields do not line up on the stacked layout (P has `n0*S0` rows,
Vx `n0*(S0+1)`), so :func:`block_compute` runs the core on block-batched
views `(n0, n1, n2, S0, S1, S2)`.  igg's `buoy_axis` existed only for the
TPU's transposed z windows; here buoyancy always drives `Vz`.

Dispatch of :func:`make_iteration` (`use_kernels`), the idiom of
:mod:`igg_torch.models.wave2d`:

- ``False``: the plain composition `update_halo(*compute_iteration(P, Vx,
  Vy, Vz, Rho))`, all in plain PyTorch (also on the card);
- ``"auto"`` / ``True``: the kernels, dispatched as igg dispatches them
  (:func:`igg_torch.ops.stokes_pallas.fused_stokes_iterations`): where the
  chunk admits `n_inner - 1` iterations
  (:mod:`igg_torch.ops.stokes_trapezoid`), one per-iteration warm-up,
  then K-iteration chunks, then the remainder per iteration; otherwise
  one fused per-iteration launch and one halo update per iteration.  A
  CPU tensor runs the kernels' plain versions.  Where the kernels cannot
  serve the fields, a CUDA tensor raises (never a quiet fallback); so
  does ``True`` on the CPU, while ``"auto"`` on the CPU takes the plain
  composition.

The streaming banded tier (igg's `stokes3d.banded`): `banded="auto"`,
True or False with `band=` (its depth B) and `K=`: a warm-up iteration,
then K-iteration chunks of x-row bands of depth B, each iteration one
launch of the band kernel (:mod:`igg_torch.ops.stokes_trapezoid`), then the
remainder per iteration; "auto" takes it only where the chunk route
refuses, True takes it or raises a GridError naming "banded" (also with
`use_kernels=False` or where the plain composition serves).  On the CPU
the band kernel's plain version runs.

The overlapped composition (`overlap`, BASELINE config 5's
`@hide_communication`): where the plain composition serves a call and
`overlap` resolves True (:func:`igg_torch.overlap.resolve_overlap`, radius
2, so admission needs an overlap-3 grid of several blocks), the tier
`stokes3d.overlap` serves it: each iteration's send planes of the four
fields come from slabs of the iteration's input (`Rho` as an aux field)
on a side stream, the full iteration runs on the caller's stream, and the
halo writer assembles the two (:func:`igg_torch.overlap.
hide_communication`), bitwise the plain composition.  The kernel routes
ignore `overlap`: their send planes are already slab-computed.

Not ported here: the autotuner's `tune=` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import fields, halo, shared, tools
from ..ops.stencil import divisor, interior_add
from ..overlap import hide_communication, resolve_overlap
from ..shared import GridError
from ..timing import time_steps
from ._dispatch import auto_dispatch, required_routes

@dataclasses.dataclass(frozen=True)
class Params:
    mu: float = 1.0          # viscosity
    rho_g: float = 1.0       # buoyancy contrast of the inclusion
    lx: float = 10.0
    ly: float = 10.0
    lz: float = 10.0
    vdamp: float = 4.0       # velocity damping (pseudo-transient accelerator)

    def spacing(self) -> Tuple[float, float, float]:
        return tools.spacing(self.lx, self.ly, self.lz)


def init_fields(params: Params = Params(), dtype=torch.float32):
    """Pressure and velocities at rest; buoyancy from a smooth spherical
    inclusion, from global coordinates on the grid's device.  Returns
    `(P, Vx, Vy, Vz, Rho)`."""
    grid = shared.global_grid()
    nx, ny, nz = grid.nxyz
    dx, dy, dz = params.spacing()
    P = fields.zeros((nx, ny, nz), dtype=dtype)
    X, Y, Z = (a.to(dtype) for a in tools.coord_fields(dx, dy, dz, P))
    r2 = ((X - params.lx / 2) ** 2 + (Y - params.ly / 2) ** 2
          + (Z - params.lz / 2) ** 2)
    Rho = params.rho_g * torch.exp(-r2) + 0 * P
    return (P, fields.zeros((nx + 1, ny, nz), dtype=dtype),
            fields.zeros((nx, ny + 1, nz), dtype=dtype),
            fields.zeros((nx, ny, nz + 1), dtype=dtype), Rho)


def iteration_core(P, Vx, Vy, Vz, Rho, *, dx, dy, dz, mu, dtP, dtV):
    """The raw coupled arithmetic on blocks laid out in the last three
    dims (one block `(S0, S1, S2)`, or a batch of them): the full-shape
    updated pressure and the velocity increments on the interior faces,
    `(P', dVx, dVy, dVz)`, in igg's association order (module
    docstring)."""
    rdx, rdy, rdz, three = (divisor(v, P) for v in (dx, dy, dz, 3.0))
    i, a = slice(1, -1), slice(None)
    gx = (Vx[..., 1:, :, :] - Vx[..., :-1, :, :]) / rdx
    gy = (Vy[..., :, 1:, :] - Vy[..., :, :-1, :]) / rdy
    gz = (Vz[..., 1:] - Vz[..., :-1]) / rdz
    divV = gx + gy + gz
    P = P - dtP * divV
    d3 = divV / three
    txx = 2.0 * mu * (gx - d3)
    tyy = 2.0 * mu * (gy - d3)
    tzz = 2.0 * mu * (gz - d3)
    txy = mu * ((Vx[..., i, 1:, :] - Vx[..., i, :-1, :]) / rdy
                + (Vy[..., 1:, i, :] - Vy[..., :-1, i, :]) / rdx)
    txz = mu * ((Vx[..., i, :, 1:] - Vx[..., i, :, :-1]) / rdz
                + (Vz[..., 1:, :, i] - Vz[..., :-1, :, i]) / rdx)
    tyz = mu * ((Vy[..., :, i, 1:] - Vy[..., :, i, :-1]) / rdz
                + (Vz[..., :, 1:, i] - Vz[..., :, :-1, i]) / rdy)
    rx = ((txx[..., 1:, i, i] - txx[..., :-1, i, i]) / rdx
          + (txy[..., a, 1:, i] - txy[..., a, :-1, i]) / rdy
          + (txz[..., a, i, 1:] - txz[..., a, i, :-1]) / rdz
          - (P[..., 1:, i, i] - P[..., :-1, i, i]) / rdx)
    ry = ((tyy[..., i, 1:, i] - tyy[..., i, :-1, i]) / rdy
          + (txy[..., 1:, a, i] - txy[..., :-1, a, i]) / rdx
          + (tyz[..., i, a, 1:] - tyz[..., i, a, :-1]) / rdz
          - (P[..., i, 1:, i] - P[..., i, :-1, i]) / rdy)
    rz = ((tzz[..., i, i, 1:] - tzz[..., i, i, :-1]) / rdz
          + (txz[..., 1:, i, a] - txz[..., :-1, i, a]) / rdx
          + (tyz[..., i, 1:, a] - tyz[..., i, :-1, a]) / rdy
          - (P[..., i, i, 1:] - P[..., i, i, :-1]) / rdz)
    rz = rz + 0.5 * (Rho[..., i, i, 1:] + Rho[..., i, i, :-1])
    return P, dtV * rx, dtV * ry, dtV * rz


_PAD3 = [(0, 0)] * 3 + [(1, 1)] * 3


def block_compute(P, Vx, Vy, Vz, Rho, blocks, *, dx, dy, dz, mu, dtP, dtV):
    """The coupled update of every block of stacked `(P, Vx, Vy, Vz)` (and
    constant `Rho`) laid out as `blocks = (n0, n1, n2)` blocks, into new
    contiguous tensors: `P'` on every cell, the velocities on their
    block's interior faces, `+0` on its outer faces."""
    n0, n1, n2 = blocks

    def batched(A):
        s = [A.shape[d] // blocks[d] for d in range(3)]
        return A.view(n0, s[0], n1, s[1], n2, s[2]).permute(0, 2, 4, 1, 3, 5)

    def stacked(B, like):
        return B.permute(0, 3, 1, 4, 2, 5).reshape(like.shape)

    p, vx, vy, vz, rho = (batched(A) for A in (P, Vx, Vy, Vz, Rho))
    pn, dvx, dvy, dvz = iteration_core(p, vx, vy, vz, rho, dx=dx, dy=dy,
                                       dz=dz, mu=mu, dtP=dtP, dtV=dtV)
    out = [pn] + [interior_add(v, dv, _PAD3)
                  for v, dv in ((vx, dvx), (vy, dvy), (vz, dvz))]
    return tuple(stacked(B, A) for B, A in zip(out, (P, Vx, Vy, Vz)))


def compute_iteration(P, Vx, Vy, Vz, Rho, *, dx, dy, dz, mu, dtP, dtV):
    """The pure coupled update without halo exchange (igg's
    `compute_iteration`), on stacked arrays or on one block inside
    :func:`igg_torch.sharded`: pressure then velocities, interior faces
    only.  Effective stencil radius 2 (the velocity updates read the fresh
    pressure, which reads the velocities at +-1)."""
    s = shared.global_grid().local_shape_any(P)
    blocks = tuple(P.shape[d] // s[d] for d in range(3))
    return block_compute(P, Vx, Vy, Vz, Rho, blocks, dx=dx, dy=dy, dz=dz,
                         mu=mu, dtP=dtP, dtV=dtV)


def local_iteration(P, Vx, Vy, Vz, Rho, *, dx, dy, dz, mu, dtP, dtV,
                    overlap: bool = False, use_kernels: bool = False):
    """One pseudo-transient iteration of the plain composition: the
    coupled update, then one grouped halo update of the four fields
    (inside :func:`igg_torch.sharded` on local blocks, or on stacked
    arrays).  `overlap=True` restructures it with the multi-field
    :func:`igg_torch.overlap.hide_communication` (radius 2, `Rho` an aux
    field; the grid needs overlap >= 3).  `use_kernels=True` runs the
    fused iteration instead (:func:`igg_torch.ops.stokes_pallas.
    fused_stokes_iteration`, on stacked arrays) or raises `GridError`
    where the kernels cannot serve the fields."""
    kw = dict(dx=dx, dy=dy, dz=dz, mu=mu, dtP=dtP, dtV=dtV)
    if use_kernels:
        from ..ops import stokes_pallas

        if overlap:
            raise GridError(
                "the fused Stokes iteration has overlap "
                "(hide_communication) semantics built in; drop "
                "overlap=True when passing use_kernels.")
        why = ("the fused iteration runs on stacked grid arrays, not "
               "inside igg_torch.sharded" if shared.block_coords() is not None
               else stokes_pallas.kernel_refusal(shared.global_grid(), P, Vx,
                                                 Vy, Vz, Rho))
        if why is not None:
            raise GridError(f"the Stokes kernels cannot serve these fields: "
                            f"{why}")
        return stokes_pallas.fused_stokes_iteration(P, Vx, Vy, Vz, Rho, **kw)
    if overlap:
        return hide_communication(
            (P, Vx, Vy, Vz),
            lambda P, Vx, Vy, Vz, Rho: compute_iteration(P, Vx, Vy, Vz, Rho,
                                                         **kw),
            Rho, radius=2)
    return halo.update_halo_local(*compute_iteration(P, Vx, Vy, Vz, Rho,
                                                     **kw))


def _pseudo_steps(params: Params) -> dict:
    """The keyword arguments of :func:`iteration_core` these parameters
    give: the spacings, `mu`, and igg's pseudo-time steps `dtP`, `dtV`."""
    dx, dy, dz = params.spacing()
    n_min = min(tools.nx_g(), tools.ny_g(), tools.nz_g())
    dtV = min(dx, dy, dz) ** 2 / params.mu / 8.1 / params.vdamp
    dtP = 4.1 * params.mu / n_min
    return dict(dx=dx, dy=dy, dz=dz, mu=params.mu, dtP=dtP, dtV=dtV)


def _kernel_path(use_kernels, P, Vx, Vy, Vz, Rho) -> bool:
    """Whether this call takes the kernels (module docstring)."""
    from ..ops import stokes_pallas

    if use_kernels not in ("auto", True, False):
        raise GridError(f"use_kernels={use_kernels!r}: expected 'auto', "
                        f"True or False")
    if use_kernels is False:
        return False
    why = stokes_pallas.kernel_refusal(shared.global_grid(), P, Vx, Vy, Vz,
                                       Rho)
    if why is None and (use_kernels == "auto" or P.device.type != "cpu"):
        return True
    if use_kernels == "auto" and P.device.type == "cpu":
        return False
    raise GridError(f"the Stokes kernels cannot serve these fields: "
                    f"{why or 'use_kernels=True needs CUDA tensors'}")


def make_iteration(params: Params = Params(), *, n_inner: int = 1,
                   use_kernels="auto", K: int = None, banded="auto",
                   band: int = None, overlap="auto", verify=None):
    """`(P, Vx, Vy, Vz, Rho) -> (P, Vx, Vy, Vz)` advancing `n_inner`
    iterations; returns new tensors and leaves its inputs as they were.
    `use_kernels` picks the path (module docstring); `K` is the chunk depth
    of the chunk route, which serves only where the chunk admits it
    (default: the largest of 8, 4, 2 it admits, igg's `fit_stokes_K`);
    `banded` and `band` the banded tier, `overlap` ("auto", True, False)
    the overlapped composition (module docstring).

    The call runs through the family's tier ladder
    (:func:`igg_torch.models._dispatch.auto_dispatch`):
    `stokes3d.trapezoid` (the chunk route), `stokes3d.banded`,
    `stokes3d.cuda` (the per-iteration kernel), `stokes3d.overlap` (where
    `overlap` resolves True) and `stokes3d.plain`.
    `verify="first_use"` checks a kernel tier against the plain
    composition before it serves and raises where they disagree."""
    from ..ops.stokes_pallas import BANDED_REQ

    if n_inner < 1:
        raise GridError(f"n_inner must be >= 1, got {n_inner}")
    if banded not in ("auto", True, False):
        raise GridError(f"banded={banded!r}: expected 'auto', True or False")
    if banded is True and use_kernels is False:
        raise GridError(f"{BANDED_REQ}; use_kernels=False pins the plain "
                        f"composition")
    overlap = resolve_overlap(overlap, family="stokes3d", radius=2,
                              chunk_active=banded is True)
    kw = _pseudo_steps(params)

    def plan(P, Vx, Vy, Vz, Rho):
        """The route of a call and its `(Kf, kb)`
        (:func:`igg_torch.ops.stokes_pallas.stokes_route`)."""
        from ..ops import stokes_pallas

        if not _kernel_path(use_kernels, P, Vx, Vy, Vz, Rho):
            if banded is True:
                raise GridError(f"{BANDED_REQ}; the plain composition "
                                f"serves these fields")
            return "plain", None
        Kf, kb = stokes_pallas.stokes_route(
            shared.global_grid(), P, n_inner=n_inner, K=K, banded=banded,
            band=band)
        return ("trapezoid" if Kf else "banded" if kb else "cuda"), (Kf, kb)

    def plain(P, Vx, Vy, Vz, Rho):
        blocks = shared.global_grid().dims
        for _ in range(n_inner):
            P, Vx, Vy, Vz = block_compute(P, Vx, Vy, Vz, Rho, blocks, **kw)
            halo.update_halo(P, Vx, Vy, Vz, plain=True)
        return P, Vx, Vy, Vz

    def slab_iteration(P, Vx, Vy, Vz, Rho):
        return block_compute(P, Vx, Vy, Vz, Rho, shared.global_grid().dims,
                             **kw)

    def overlapped(P, Vx, Vy, Vz, Rho):
        S = (P, Vx, Vy, Vz)
        for _ in range(n_inner):
            S = hide_communication(S, slab_iteration, Rho, radius=2)
        return S

    def kernels(route, P, Vx, Vy, Vz, Rho):
        from ..ops import stokes_pallas

        return stokes_pallas.fused_stokes_iterations(
            P, Vx, Vy, Vz, Rho, n_inner=n_inner, route=route, **kw)

    return auto_dispatch(
        family="stokes3d", plan=plan,
        routes={"trapezoid": kernels, "banded": kernels, "cuda": kernels},
        plain=plain, overlap=overlapped if overlap else None,
        required=required_routes(use_kernels, banded), verify=verify)


def run(n_iters: int, params: Params = Params(), dtype=torch.float32,
        n_inner: int = 1, use_kernels="auto", K: int = None, banded="auto",
        band: int = None):
    """Slope-timed relaxation (:func:`igg_torch.time_steps`, igg's
    `stokes3d.run`): `n_iters` timed calls in batches of ~n_iters/4 and
    ~3n_iters/4 after the default three untimed ones, each call advancing
    `n_inner` iterations (`make_iteration`'s route arguments).  Returns
    `((P, Vx, Vy, Vz, Rho), seconds_per_iteration)`."""
    P, Vx, Vy, Vz, Rho = init_fields(params, dtype=dtype)
    it = make_iteration(params, n_inner=n_inner, use_kernels=use_kernels,
                        K=K, banded=banded, band=band)
    n1 = max(1, n_iters // 4)
    state, sec = time_steps(
        lambda P, Vx, Vy, Vz, Rho: it(P, Vx, Vy, Vz, Rho) + (Rho,),
        (P, Vx, Vy, Vz, Rho), n1=n1, n2=max(n_iters - n1, n1 + 1))
    return state, sec / n_inner
