"""3-D hydro-mechanical porous flow: the HM3D family (`igg.models.hm3d`).

BASELINE config 4 (ParallelStencil's HM3D, weak scaling): the effective
pressure `Pe` diffuses through a porosity field `phi` with the
porosity-dependent permeability `(phi/phi0)^npow`, coupled back through
compaction, the porosity-wave problem.  Two mutually coupled fields share
one halo update per step; the face permeabilities make the stencil depend
on the state.  Steps run on the block-stacked grid arrays of
:mod:`igg_torch.fields`.

:func:`step_core` is the arithmetic truth of every path: the plain
composition, the send planes the kernel route recomputes on slabs, and the
plain versions the kernels (`csrc/hm3d_march.cuh`) are held to.  Divisions are
by 0-dim tensors of the field's dtype, not by Python floats: on a CUDA
tensor PyTorch turns `x / float` into `x * (1/float)`, which rounds
differently from the kernels' IEEE division.

Dispatch of :func:`make_multi_step` (`use_kernels`), the idiom of
:mod:`igg_torch.models.diffusion3d`:

- ``False``: the plain composition `update_halo(*compute_step(Pe, phi))`,
  all in plain PyTorch (also on the card);
- ``"auto"`` / ``True``: the kernels, dispatched as igg dispatches them
  (:func:`igg_torch.ops.hm3d_pallas.fused_hm3d_steps`): on a one-block grid
  and `n_inner >= 2`, the K-step loop (:mod:`igg_torch.ops.hm3d_mega`); on
  several blocks, where the chunk admits the shape
  (:mod:`igg_torch.ops.hm3d_trapezoid`), one per-step warm-up step, then
  K-step chunks, then the remainder as per-step steps; otherwise one fused
  per-step launch per step.  A CPU tensor runs the kernels' plain
  versions.  Where the kernels cannot serve the fields, a CUDA tensor
  raises (never a quiet fallback); so does ``True`` on the CPU, while
  ``"auto"`` on the CPU takes the plain composition.

The streaming banded tier (`banded`, igg's `hm3d.banded`) rides the kernel
path as in :mod:`igg_torch.models.diffusion3d`: one per-step warm-up step,
`(n_inner-1)//K` chunks whose iterations sweep x-row bands of depth B
(:func:`igg_torch.ops.hm3d_trapezoid.fused_hm3d_banded_steps`), then the
remainder per step.  ``"auto"`` takes it only where the K-step loop and
the chunk route both refuse and some `(K, B)` is admissible; ``True``
requires it (a `GridError` where none is admissible or with
`use_kernels=False`); ``False`` never takes it.  `K` pins the depth of
whichever chunk route runs, `band` the band depth; a pinned pair the tier
refuses is never refitted.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import fields, halo, shared, tools
from ..ops.stencil import block_boundary_mask, divisor, interior_add
from ..shared import GridError
from ..timing import time_steps
from ._dispatch import band_config

_BANDED_REQ = ("banded=True needs the fused kernels (use_kernels 'auto' or "
               "True, on a grid they serve) and an admissible banded config "
               "(K, B): n_inner >= K + 1 >= 3, an overlap-2 grid, an "
               "extended x span of >= 2 bands of B, K-deep send slabs inside "
               "every extended dimension's block (igg_torch.ops."
               "hm3d_trapezoid.hm3d_banded_refusal)")


@dataclasses.dataclass(frozen=True)
class Params:
    phi0: float = 0.1        # background porosity
    npow: int = 3            # permeability exponent k ~ (phi/phi0)^n
    eta: float = 1.0         # compaction viscosity
    lx: float = 10.0
    ly: float = 10.0
    lz: float = 10.0

    def spacing(self) -> Tuple[float, float, float]:
        return tools.spacing(self.lx, self.ly, self.lz)

    def timestep(self) -> float:
        dx, dy, dz = self.spacing()
        # igg's bound on k*dt/dx^2, with headroom for the porosity wave's
        # growth of k.
        return min(dx * dx, dy * dy, dz * dz) / 8.1 / 32.0

    def step_kwargs(self) -> dict:
        """The keyword arguments of :func:`step_core` these parameters
        give."""
        dx, dy, dz = self.spacing()
        return dict(dx=dx, dy=dy, dz=dz, dt=self.timestep(), phi0=self.phi0,
                    npow=self.npow, eta=self.eta)


def init_fields(params: Params = Params(), dtype=torch.float32):
    """Gaussian porosity anomaly in a uniform background, Pe at rest but
    under-pressured in the anomaly, built from global coordinates on the
    grid's device; returns `(Pe, phi)`."""
    grid = shared.global_grid()
    nx, ny, nz = grid.nxyz
    dx, dy, dz = params.spacing()
    Pe0 = fields.zeros((nx, ny, nz), dtype=dtype)
    X, Y, Z = (a.to(dtype) for a in tools.coord_fields(dx, dy, dz, Pe0))
    r2 = ((X - params.lx / 2) ** 2 + (Y - params.ly / 2) ** 2
          + (Z - params.lz / 3) ** 2)
    phi = params.phi0 * (1.0 + 1.0 * torch.exp(-r2)) + 0 * Pe0
    Pe = -0.5 * torch.exp(-r2) + 0 * Pe0
    return Pe, phi


def int_pow(x, n: int):
    """`x**n` for an int `n >= 0` by repeated squaring in the order of
    XLA's `integer_pow` (igg's `(phi/phi0) ** npow`): the accumulator takes
    `x` at each set bit of `n` from the lowest, `x` squares in between."""
    if n < 0:
        raise GridError(f"npow must be an int >= 0, got {n}")
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def step_core(Pe, phi, *, dx, dy, dz, dt, phi0, npow, eta):
    """The coupled increments `(dPe, dphi)` on a window's interior cells:
    face permeabilities (arithmetic means), Darcy fluxes, the fluid mass
    balance, and the compaction of the porosity by the UPDATED effective
    pressure (the Gauss-Seidel coupling).  Same association as igg's."""
    rdx, rdy, rdz, rphi0, reta = (divisor(v, Pe)
                                  for v in (dx, dy, dz, phi0, eta))
    k = int_pow(phi / rphi0, npow)
    kx = 0.5 * (k[1:, 1:-1, 1:-1] + k[:-1, 1:-1, 1:-1])
    ky = 0.5 * (k[1:-1, 1:, 1:-1] + k[1:-1, :-1, 1:-1])
    kz = 0.5 * (k[1:-1, 1:-1, 1:] + k[1:-1, 1:-1, :-1])
    qx = -kx * (Pe[1:, 1:-1, 1:-1] - Pe[:-1, 1:-1, 1:-1]) / rdx
    qy = -ky * (Pe[1:-1, 1:, 1:-1] - Pe[1:-1, :-1, 1:-1]) / rdy
    qz = -kz * (Pe[1:-1, 1:-1, 1:] - Pe[1:-1, 1:-1, :-1]) / rdz
    divq = ((qx[1:, :, :] - qx[:-1, :, :]) / rdx
            + (qy[:, 1:, :] - qy[:, :-1, :]) / rdy
            + (qz[:, :, 1:] - qz[:, :, :-1]) / rdz)
    inner = (slice(1, -1),) * 3
    dPe = dt * (-divq - Pe[inner] * phi[inner] / reta)
    Pe_new = Pe[inner] + dPe
    dphi = dt * (-phi[inner] * (1.0 - phi[inner]) * Pe_new / reta)
    return dPe, dphi


def block_compute(Pe, phi, local, **kw):
    """The coupled update of every `local`-sized block of stacked `Pe` and
    `phi`: interior cells advance, cells on a block's outer planes keep
    their stale values.  Returns new tensors."""
    dPe, dphi = step_core(Pe, phi, **kw)
    Pn, fn = interior_add(Pe, dPe), interior_add(phi, dphi)
    if tuple(Pe.shape) == tuple(local):
        return Pn, fn
    mask = block_boundary_mask(Pe.shape, local, Pe.device)
    return torch.where(mask, Pe, Pn), torch.where(mask, phi, fn)


def compute_step(Pe, phi, *, dx, dy, dz, dt, phi0, npow, eta):
    """The coupled update without halo exchange (on a stacked array, or on
    one block inside :func:`igg_torch.sharded`)."""
    return block_compute(Pe, phi, shared.global_grid().local_shape_any(Pe),
                         dx=dx, dy=dy, dz=dz, dt=dt, phi0=phi0, npow=npow,
                         eta=eta)


def local_step(Pe, phi, *, dx, dy, dz, dt, phi0, npow, eta):
    """One step of the plain composition: the coupled update, then one halo
    update of both fields."""
    return halo.update_halo_local(*compute_step(
        Pe, phi, dx=dx, dy=dy, dz=dz, dt=dt, phi0=phi0, npow=npow, eta=eta))


def make_step(params: Params = Params(), *, use_kernels="auto"):
    """`(Pe, phi) -> (Pe, phi)` advancing one step (see
    :func:`make_multi_step`)."""
    return make_multi_step(1, params, use_kernels=use_kernels)


def _kernel_path(use_kernels, Pe, phi) -> bool:
    """Whether this call takes the kernels (module docstring)."""
    from ..ops import hm3d_pallas

    if use_kernels not in ("auto", True, False):
        raise GridError(f"use_kernels={use_kernels!r}: expected 'auto', "
                        f"True or False")
    if use_kernels is False:
        return False
    why = hm3d_pallas.kernel_refusal(shared.global_grid(), Pe, phi)
    if why is None:
        return True
    if use_kernels == "auto" and Pe.device.type == "cpu":
        return False
    raise GridError(f"the HM3D kernels cannot serve these fields: {why}")


def make_multi_step(n_inner: int, params: Params = Params(), *,
                    use_kernels="auto", K: int = None, banded="auto",
                    band: int = None):
    """`(Pe, phi) -> (Pe, phi)` advancing `n_inner` steps; returns new
    tensors and leaves its inputs as they were.  `use_kernels` picks the
    path, `banded` and `band` the banded tier (module docstring); `K` is
    the chunk depth of the chunk route or the banded tier (default: 8
    where it divides the block's x extent,
    :func:`igg_torch.ops.chunk_engine.default_K`, and the banded tier's
    fit)."""
    from ..ops import chunk_engine

    if n_inner < 1:
        raise GridError(f"n_inner must be >= 1, got {n_inner}")
    if not isinstance(params.npow, int) or params.npow < 0:
        raise GridError(f"npow must be an int >= 0, got {params.npow!r}")
    if banded not in ("auto", True, False):
        raise GridError(f"banded={banded!r}: expected 'auto', True or False")
    if banded is True and use_kernels is False:
        raise GridError(f"{_BANDED_REQ}; use_kernels=False pins the plain "
                        f"composition")
    kw = params.step_kwargs()

    def step(Pe, phi):
        from ..ops import hm3d_pallas, hm3d_trapezoid as htz

        grid = shared.global_grid()
        local = grid.local_shape(Pe)
        if not _kernel_path(use_kernels, Pe, phi):
            if banded is True:
                raise GridError(f"{_BANDED_REQ}; the plain composition "
                                f"serves these fields")
            for _ in range(n_inner):
                Pe, phi = block_compute(Pe, phi, local, **kw)
                halo.update_halo(Pe, phi, plain=True)
            return Pe, phi
        Kc = K or chunk_engine.default_K(grid.nxyz[0])
        kb = band_config(
            banded, K, band, n_inner, requirement=_BANDED_REQ,
            resident=lambda: (grid.dims == (1, 1, 1) and n_inner >= 2) or
            htz.hm3d_trapezoid_refusal(grid, local, Kc, n_inner - 1,
                                       Pe.dtype) is None,
            supported=lambda k, b: htz.hm3d_banded_refusal(
                grid, local, k, n_inner - 1, Pe.dtype, B=b) is None,
            fit=lambda bands: htz.fit_hm3d_band(
                grid, local, n_inner - 1, Pe.dtype, bands=bands))
        if kb is None:
            return hm3d_pallas.fused_hm3d_steps(Pe, phi, n_inner=n_inner,
                                                K=Kc, **kw)
        Pe, phi = hm3d_pallas.fused_hm3d_step(Pe, phi, **kw)
        Pe, phi, done = htz.fused_hm3d_banded_steps(
            Pe, phi, n_inner=n_inner - 1, K=kb[0], B=kb[1], grid=grid, **kw)
        for _ in range(n_inner - 1 - done):
            Pe, phi = hm3d_pallas.fused_hm3d_step(Pe, phi, **kw)
        return Pe, phi

    return step


def run(nt: int, params: Params = Params(), dtype=torch.float32,
        n_inner: int = 1, use_kernels="auto", banded="auto", K: int = None,
        band: int = None):
    """Slope-timed run (:func:`igg_torch.time_steps`, igg's `hm3d.run`):
    `nt` timed calls in batches of ~nt/4 and ~3nt/4 after the default
    three untimed ones, each call advancing `n_inner` steps
    (`make_multi_step`'s route arguments).  Returns `((Pe, phi),
    seconds_per_step)`."""
    Pe, phi = init_fields(params, dtype=dtype)
    step = make_multi_step(n_inner, params, use_kernels=use_kernels,
                           banded=banded, K=K, band=band)
    n1 = max(1, nt // 4)
    state, sec = time_steps(step, (Pe, phi), n1=n1, n2=max(nt - n1, n1 + 1))
    return state, sec / n_inner
