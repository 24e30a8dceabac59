"""2-D acoustic wave on a staggered grid: the wave2d family
(`igg.models.wave2d`).

BASELINE config 3 ("2-D shallow-water / acoustic wave, 1-D periodic
halo"): a velocity-pressure leapfrog on the pressure `P (nx, ny)` and the
face velocities `Vx (nx+1, ny)` and `Vy (nx, ny+1)`.  `Vx` is one cell
longer in x, so its x overlap is 3 and its halo planes sit one cell deeper
(the per-array `ol(dim, A)` rule); all three fields share one halo update
per step.  Steps run on the block-stacked grid arrays of
:mod:`igg_torch.fields`.

:func:`block_compute` is the arithmetic truth of every path: the plain
composition, the window core of the chunk route, and the plain versions the
kernels (`csrc/wave2d.cuh`) are held to.  The velocities move on their
block's interior faces from the pressure gradient, then the pressure moves
on EVERY cell of the block from the fresh velocity divergence.  Staggered
fields do not line up on the stacked layout (P has `n0*S0` rows, Vx
`n0*(S0+1)`), so the update runs on block-batched views `(n0, S0, n1, S1)`.
Coefficients are rounded once to the field's dtype, and divisions are by
0-dim tensors (:func:`igg_torch.ops.stencil.divisor`).

Dispatch of :func:`make_multi_step` (`use_kernels`), the idiom of
:mod:`igg_torch.models.hm3d`:

- ``False``: the plain composition `update_halo(*compute_step(P, Vx,
  Vy))`, all in plain PyTorch (also on the card);
- ``"auto"`` / ``True``: the kernels, dispatched as igg dispatches them
  (:func:`igg_torch.ops.wave2d_pallas.fused_wave2d_steps`): where the
  chunk admits `n_inner - 1` steps (periodic grids,
  :mod:`igg_torch.ops.wave2d_trapezoid`), one per-step warm-up step, then
  K-step chunks, then the remainder per step; otherwise one fused
  per-step launch and one halo update per step.  A CPU tensor runs the
  kernels' plain versions.  Where the kernels cannot serve the fields, a
  CUDA tensor raises (never a quiet fallback); so does ``True`` on the
  CPU, while ``"auto"`` on the CPU takes the plain composition.

The streaming banded tier (igg's `wave2d.banded`): `banded="auto"`, True
or False with `band=` and `K=`.  igg compiles its streaming kernel for
3-D fields only, and so does the port: on CPU tensors the tier runs its
plain realization (a warm-up step, K-step chunks of x-row bands of depth
B, the remainder per step; :mod:`igg_torch.ops.wave2d_trapezoid`), on the
card `banded=True` raises igg's refusal and "auto" never takes it.

The overlapped composition (`overlap`, igg's `hide_communication` of the
three fields, radius 2: the velocity-pressure chain, so the grid needs
overlap >= 3 along the exchanged dims): where the plain composition
serves a call and `overlap` resolves True
(:func:`igg_torch.overlap.resolve_overlap`, `ndim=2`), the tier
`wave2d.overlap` serves it, bitwise the plain composition.  The kernel
routes ignore `overlap`.

Not ported here: the integrity invariant's registration.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import fields, halo, shared, tools
from ..ops.stencil import divisor
from ..overlap import hide_communication, resolve_overlap
from ..shared import GridError
from ..timing import time_steps
from ._dispatch import auto_dispatch, required_routes


@dataclasses.dataclass(frozen=True)
class Params:
    rho: float = 1.0      # density
    K: float = 1.0        # bulk modulus
    lx: float = 10.0
    ly: float = 10.0

    def spacing(self) -> Tuple[float, float]:
        return (self.lx / (tools.nx_g() - 1), self.ly / (tools.ny_g() - 1))

    def timestep(self) -> float:
        dx, dy = self.spacing()
        c = (self.K / self.rho) ** 0.5
        return min(dx, dy) / c / 4.1

    def step_kwargs(self) -> dict:
        """The keyword arguments of :func:`block_compute` these parameters
        give (the bulk modulus as `bulk`, so that `K` names the chunk
        depth in the ops)."""
        dx, dy = self.spacing()
        return dict(dx=dx, dy=dy, dt=self.timestep(), rho=self.rho,
                    bulk=self.K)


def init_fields(params: Params = Params(), dtype=torch.float32):
    """Gaussian pressure pulse, velocities at rest, from global
    coordinates on the grid's device; returns `(P, Vx, Vy)`."""
    grid = shared.global_grid()
    nx, ny = grid.nxyz[0], grid.nxyz[1]
    dx, dy = params.spacing()
    P0 = fields.zeros((nx, ny), dtype=dtype)
    X = tools.x_g_field(dx, P0)[:, None].to(dtype)
    Y = tools.y_g_field(dy, P0)[None, :].to(dtype)
    P = torch.exp(-((X - params.lx / 2) ** 2 + (Y - params.ly / 2) ** 2)) \
        + 0 * P0
    return (P, fields.zeros((nx + 1, ny), dtype=dtype),
            fields.zeros((nx, ny + 1), dtype=dtype))


def block_compute(P, Vx, Vy, blocks, *, dx, dy, dt, rho, bulk):
    """The coupled leapfrog update of every block of stacked `(P, Vx, Vy)`
    laid out as `blocks = (n0, n1)` blocks, into new tensors:

        Vx' = Vx + ((c1 * (P[i] - P[i-1])) / dx)   interior x faces,
        Vy' = Vy + ((c1 * (P[j] - P[j-1])) / dy)   interior y faces,
        P'  = P - (c2 * ((Vx'[i+1] - Vx'[i]) / dx + (Vy'[j+1] - Vy'[j]) / dy))

    on every cell, with `c1 = -dt/rho` and `c2 = dt*bulk` formed in double
    and rounded once (igg's Python-float products).  The block's outer
    faces add an exact +0 (igg's `interior_add`)."""
    n0, n1 = blocks
    S0, S1 = P.shape[0] // n0, P.shape[1] // n1
    p = P.view(n0, S0, n1, S1)
    vx = Vx.view(n0, S0 + 1, n1, S1)
    vy = Vy.view(n0, S0, n1, S1 + 1)
    c1, c2 = divisor(-dt / rho, P), divisor(dt * bulk, P)
    rdx, rdy = divisor(dx, P), divisor(dy, P)
    vxn = vx + F.pad((c1 * (p[:, 1:] - p[:, :-1])) / rdx, (0, 0, 0, 0, 1, 1))
    vyn = vy + F.pad((c1 * (p[..., 1:] - p[..., :-1])) / rdy, (1, 1))
    pn = p - c2 * ((vxn[:, 1:] - vxn[:, :-1]) / rdx
                   + (vyn[..., 1:] - vyn[..., :-1]) / rdy)
    return pn.reshape(P.shape), vxn.reshape(Vx.shape), vyn.reshape(Vy.shape)


def compute_step(P, Vx, Vy, *, dx, dy, dt, rho, K):
    """The coupled update without halo exchange (igg's `compute_step`), on
    a stacked array or on one block inside :func:`igg_torch.sharded`."""
    s = shared.global_grid().local_shape_any(P)
    return block_compute(P, Vx, Vy, (P.shape[0] // s[0], P.shape[1] // s[1]),
                         dx=dx, dy=dy, dt=dt, rho=rho, bulk=K)


def local_step(P, Vx, Vy, *, dx, dy, dt, rho, K, overlap: bool = False):
    """One step of the plain composition: the coupled update, then one halo
    update of the three fields.  `overlap=True` restructures it with
    :func:`igg_torch.overlap.hide_communication` (radius 2: the grid needs
    overlap >= 3 along the exchanged dims)."""
    kw = dict(dx=dx, dy=dy, dt=dt, rho=rho, K=K)
    if overlap:
        return hide_communication(
            (P, Vx, Vy), lambda Pb, Vxb, Vyb: compute_step(Pb, Vxb, Vyb, **kw),
            radius=2)
    return halo.update_halo_local(*compute_step(P, Vx, Vy, **kw))


def make_step(params: Params = Params(), *, use_kernels="auto",
              overlap="auto", verify=None):
    """`(P, Vx, Vy) -> (P, Vx, Vy)` advancing one step (see
    :func:`make_multi_step`)."""
    return make_multi_step(1, params, use_kernels=use_kernels,
                           overlap=overlap, verify=verify)


def _kernel_path(use_kernels, P, Vx, Vy) -> bool:
    """Whether this call takes the kernels (module docstring)."""
    from ..ops import wave2d_pallas

    if use_kernels not in ("auto", True, False):
        raise GridError(f"use_kernels={use_kernels!r}: expected 'auto', "
                        f"True or False")
    if use_kernels is False:
        return False
    why = wave2d_pallas.kernel_refusal(shared.global_grid(), P, Vx, Vy)
    if why is None and (use_kernels == "auto" or P.device.type != "cpu"):
        return True
    if use_kernels == "auto" and P.device.type == "cpu":
        return False
    raise GridError(f"the wave2d kernels cannot serve these fields: "
                    f"{why or 'use_kernels=True needs CUDA tensors'}")


def make_multi_step(n_inner: int, params: Params = Params(), *,
                    use_kernels="auto", K: int = None, banded="auto",
                    band: int = None, overlap="auto", verify=None):
    """`(P, Vx, Vy) -> (P, Vx, Vy)` advancing `n_inner` steps; returns new
    tensors and leaves its inputs as they were.  `use_kernels` picks the
    path (module docstring); `K` is the chunk depth of the chunk route,
    which serves only where the chunk admits it (default: the largest of 8,
    4, 2 it admits, igg's `fit_wave2d_K`); `banded` and `band` the banded
    tier, `overlap` ("auto", True, False) the overlapped composition
    (module docstring).

    The call runs through the family's tier ladder
    (:func:`igg_torch.models._dispatch.auto_dispatch`): `wave2d.chunk`,
    `wave2d.banded`, `wave2d.cuda` (the per-step kernel), `wave2d.overlap`
    (where `overlap` resolves True) and `wave2d.plain`.  `verify="first_use"` checks a kernel tier against the
    plain composition before it serves and raises where they disagree."""
    from ..ops.wave2d_pallas import BANDED_REQ

    if n_inner < 1:
        raise GridError(f"n_inner must be >= 1, got {n_inner}")
    if banded not in ("auto", True, False):
        raise GridError(f"banded={banded!r}: expected 'auto', True or False")
    if banded is True and use_kernels is False:
        raise GridError(f"{BANDED_REQ}; use_kernels=False pins the plain "
                        f"composition")
    overlap = resolve_overlap(overlap, family="wave2d", radius=2, ndim=2,
                              chunk_active=banded is True)
    kw = params.step_kwargs()

    def plan(P, Vx, Vy):
        """The route of a call and its `(Kf, kb)`
        (:func:`igg_torch.ops.wave2d_pallas.wave2d_route`)."""
        from ..ops import wave2d_pallas

        if not _kernel_path(use_kernels, P, Vx, Vy):
            if banded is True:
                raise GridError(f"{BANDED_REQ}; the plain composition "
                                f"serves these fields")
            return "plain", None
        Kf, kb = wave2d_pallas.wave2d_route(
            shared.global_grid(), P, n_inner=n_inner, K=K, banded=banded,
            band=band)
        return ("chunk" if Kf else "banded" if kb else "cuda"), (Kf, kb)

    def plain(P, Vx, Vy):
        blocks = shared.global_grid().dims[:2]
        for _ in range(n_inner):
            P, Vx, Vy = block_compute(P, Vx, Vy, blocks, **kw)
            halo.update_halo(P, Vx, Vy, plain=True)
        return P, Vx, Vy

    def slab_step(P, Vx, Vy):
        return block_compute(P, Vx, Vy, shared.global_grid().dims[:2], **kw)

    def overlapped(P, Vx, Vy):
        for _ in range(n_inner):
            P, Vx, Vy = hide_communication((P, Vx, Vy), slab_step, radius=2)
        return P, Vx, Vy

    def kernels(route, P, Vx, Vy):
        from ..ops import wave2d_pallas

        return wave2d_pallas.fused_wave2d_steps(
            P, Vx, Vy, n_inner=n_inner, route=route, **kw)

    return auto_dispatch(
        family="wave2d", plan=plan,
        routes={"chunk": kernels, "banded": kernels, "cuda": kernels},
        plain=plain, overlap=overlapped if overlap else None,
        required=required_routes(use_kernels, banded), verify=verify)


def energy(P, Vx, Vy) -> float:
    """The discrete energy `sum P^2 + sum Vx^2 + sum Vy^2` over the owned
    cells (each global cell once, `igg_torch.gather_interior`), in float64:
    igg's bounded `wave_energy` invariant."""
    from ..gather import gather_interior

    return float(sum((gather_interior(A).astype("float64") ** 2).sum()
                     for A in (P, Vx, Vy)))


def run(nt: int, params: Params = Params(), dtype=torch.float32,
        n_inner: int = 1, use_kernels="auto"):
    """Slope-timed run (:func:`igg_torch.time_steps`, igg's `wave2d.run`):
    `nt` timed calls in batches of ~nt/4 and ~3nt/4 after one untimed call,
    each call advancing `n_inner` steps.  Returns `((P, Vx, Vy),
    seconds_per_step)`."""
    state = init_fields(params, dtype=dtype)
    step = make_multi_step(n_inner, params, use_kernels=use_kernels)
    n1 = max(1, nt // 4)
    state, sec = time_steps(step, state, n1=n1, n2=max(nt - n1, n1 + 1),
                            warmup=1)
    return state, sec / n_inner
