"""3-D heat diffusion: the port's flagship model (`igg.models.diffusion3d`).

Fourier-law heat diffusion with constant conductivity: the staggered flux
divergence telescopes to the 7-point Laplacian, so a step is
`T + dt*lam/Cp * lap(T)` on every block's interior followed by the halo
update.  Steps run on the block-stacked grid arrays of
:mod:`igg_torch.fields`.

Dispatch of :func:`make_multi_step` (`use_kernels`):

- ``False``: the plain composition `update_halo(compute_step(T))`, all in
  plain PyTorch (also on the card);
- ``"auto"`` / ``True``: the kernels, dispatched as igg dispatches them
  (:func:`igg_torch.ops.diffusion_pallas.fused_diffusion_steps`): on a
  one-block grid and `n_inner >= 2`, the K-step loop
  (:mod:`igg_torch.ops.diffusion_mega`); on several blocks, where the
  trapezoid chunk admits the shape (:mod:`igg_torch.ops.
  diffusion_trapezoid`, depth K = 8 when 8 divides the block's x extent),
  one per-step warm-up step, then K-step chunks, then the remainder as
  per-step steps; otherwise one fused per-step kernel launch per step
  (:mod:`igg_torch.ops.diffusion_pallas`).  A CPU tensor runs the
  kernels' plain versions.  Where the kernels cannot serve the field, a
  CUDA tensor raises (never a quiet fallback); so does ``True`` on the
  CPU, while ``"auto"`` on the CPU takes the plain composition.

The streaming banded tier (`banded`, igg's `diffusion3d.banded`) rides the
kernel path: one per-step warm-up step, `(n_inner-1)//K` chunks whose
iterations sweep x-row bands of depth B
(:func:`igg_torch.ops.diffusion_trapezoid.fused_diffusion_banded_steps`),
then the remainder as per-step steps.  ``"auto"`` takes it only where the
K-step loop (one block, `n_inner >= 2`) and the trapezoid chunk both
refuse and some `(K, B)` is admissible; ``True`` requires it and raises a
`GridError` where no `(K, B)` is admissible or with `use_kernels=False`;
``False`` never takes it.  `K` and `band` pin the chunk and band depths
(:func:`igg_torch.models._dispatch.resolve_band`): a pinned pair that is
inadmissible is never refitted (``True`` raises, ``"auto"`` leaves the
tier to the other routes), as in igg.

The overlapped composition (`overlap`, igg's `hide_communication`): where
the plain composition serves a call and `overlap` resolves True
(:func:`igg_torch.overlap.resolve_overlap`: True, or "auto" with
`IGG_OVERLAP=1` on an admissible grid, one of several blocks with no
`banded=True`), the tier `diffusion3d.overlap` serves it: each step's send
planes come from slabs of the step's input on a side stream, the full
step runs on the caller's stream, and the halo writer assembles the two
(:func:`igg_torch.overlap.hide_communication`, radius 1), bitwise the plain
composition.  The kernel routes ignore `overlap`: their send planes are
already slab-computed.

`tune` ("auto", True, False; None: the `IGG_TUNE` knob) applies the
autotuner's cached winner for the grid's signature
(:func:`igg_torch.models._dispatch.apply_tuned`, igg's rules): its `bx`,
`K` and `band` fill what the caller left unset, its tier pins the route
where the caller left the knobs at "auto", and its `overlap` resolves
`overlap="auto"`; True searches on a miss (:mod:`igg_torch.autotune`).
`bx` is the chunk route's depth on several blocks (default 8 where it
divides the block's x extent, :func:`igg_torch.ops.chunk_engine.
default_K`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import fields, halo, shared, tools
from ..ops import chunk_engine, diffusion_pallas
from ..overlap import hide_communication, resolve_overlap
from ..ops import diffusion_trapezoid as dtz
from ..shared import GridError
from ..timing import time_steps
from ._dispatch import (apply_tuned, auto_dispatch, band_config,
                        required_routes)

_BANDED_REQ = ("banded=True needs the fused kernels (use_kernels 'auto' or "
               "True, on a grid they serve) and an admissible banded config "
               "(K, B): n_inner >= K + 1 >= 3, an extended x span of >= 2 "
               "bands of B, K-deep send slabs inside every extended "
               "dimension's block (igg_torch.ops.diffusion_trapezoid."
               "banded_refusal)")


@dataclasses.dataclass(frozen=True)
class Params:
    lam: float = 1.0        # thermal conductivity
    cp_min: float = 1.0     # minimal heat capacity
    lx: float = 10.0        # domain length in x
    ly: float = 10.0
    lz: float = 10.0

    def spacing(self) -> Tuple[float, float, float]:
        return tools.spacing(self.lx, self.ly, self.lz)

    def timestep(self) -> float:
        dx, dy, dz = self.spacing()
        return min(dx * dx, dy * dy, dz * dz) * self.cp_min / self.lam / 8.1


def init_fields(params: Params = Params(), dtype=torch.float32):
    """Heat capacity and temperature with Gaussian anomalies, built from
    global coordinates on the grid's device; returns `(T, Cp)`."""
    grid = shared.global_grid()
    nx, ny, nz = grid.nxyz
    dx, dy, dz = params.spacing()
    lx, ly, lz = params.lx, params.ly, params.lz
    T0 = fields.zeros((nx, ny, nz), dtype=dtype)
    X, Y, Z = (a.to(dtype) for a in tools.coord_fields(dx, dy, dz, T0))
    Cp = (params.cp_min
          + 5 * torch.exp(-(X - lx / 1.5) ** 2 - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
          + 5 * torch.exp(-(X - lx / 3.0) ** 2 - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
          + 0 * T0)
    T = (100 * torch.exp(-((X - lx / 2) / 2) ** 2 - ((Y - ly / 2) / 2) ** 2
                         - ((Z - lz / 3.0) / 2) ** 2)
         + 50 * torch.exp(-((X - lx / 2) / 2) ** 2 - ((Y - ly / 2) / 2) ** 2
                          - ((Z - lz / 1.5) / 2) ** 2)
         + 0 * T0)
    return T, Cp


def compute_step(T, Cp, *, dx, dy, dz, dt, lam):
    """The stencil update of every block (no halo exchange): interior
    cells advance, block boundary planes keep their stale values."""
    grid = shared.global_grid()
    return diffusion_pallas.block_diffusion_compute(
        T, float(dt * lam) / Cp, grid.local_shape_any(T),
        **diffusion_pallas.scal(dx, dy, dz))


def local_step(T, Cp, *, dx, dy, dz, dt, lam, overlap: bool = False):
    """One step of the plain composition: the stencil, then the halo update
    (inside :func:`igg_torch.sharded` on local blocks, or on a stacked
    array).  `overlap=True` restructures it with
    :func:`igg_torch.overlap.hide_communication` (radius 1): the same
    values, the exchange independent of the full-domain stencil."""
    kw = dict(dx=dx, dy=dy, dz=dz, dt=dt, lam=lam)
    if overlap:
        return hide_communication(
            T, lambda Tb, Cpb: compute_step(Tb, Cpb, **kw), Cp)
    return halo.update_halo_local(compute_step(T, Cp, **kw))


def make_step(params: Params = Params(), *, use_kernels="auto",
              overlap="auto", verify=None, tune=None):
    """`(T, Cp) -> T` advancing one step (see :func:`make_multi_step`)."""
    return make_multi_step(1, params, use_kernels=use_kernels,
                           overlap=overlap, verify=verify, tune=tune)


def _kernel_path(use_kernels, T) -> bool:
    """Whether this call takes the kernels (module docstring)."""
    if use_kernels not in ("auto", True, False):
        raise GridError(f"use_kernels={use_kernels!r}: expected 'auto', "
                        f"True or False")
    if use_kernels is False:
        return False
    why = diffusion_pallas.kernel_refusal(shared.global_grid(), T)
    if why is None:
        return True
    if use_kernels == "auto" and T.device.type == "cpu":
        return False
    raise GridError(f"the diffusion kernels cannot serve this field: {why}")


def make_multi_step(n_inner: int, params: Params = Params(), *,
                    use_kernels="auto", banded="auto", K: int = None,
                    band: int = None, bx: int = None, overlap="auto",
                    verify=None, tune=None):
    """`(T, Cp) -> T` advancing `n_inner` steps; returns a new tensor and
    leaves `T` as it was.  `use_kernels` picks the path, `banded`, `K` and
    `band` the banded tier, `bx` the chunk route's depth, `overlap`
    ("auto", True, False) the overlapped composition, `tune` the
    autotuner's cached winner (module docstring).  The returned function keeps `A =
    dt*lam/Cp` of the last `Cp` it was given.

    The call runs through the family's tier ladder
    (:func:`igg_torch.models._dispatch.auto_dispatch`): `diffusion3d.banded`
    (the banded tier), `diffusion3d.cuda` (the other kernel routes),
    `diffusion3d.overlap` (where `overlap` resolves True) and
    `diffusion3d.plain` (the plain composition).  `verify="first_use"`
    (igg's argument; None: `IGG_VERIFY_KERNELS` decides) checks a kernel
    tier against the plain composition once per argument signature before
    it serves, and raises where they disagree."""
    if n_inner < 1:
        raise GridError(f"n_inner must be >= 1, got {n_inner}")
    if banded not in ("auto", True, False):
        raise GridError(f"banded={banded!r}: expected 'auto', True or False")
    if banded is True and use_kernels is False:
        raise GridError(f"{_BANDED_REQ}; use_kernels=False pins the plain "
                        f"composition")
    (K, K_cached, band, band_cached, _, banded, use_kernels,
     tuned) = apply_tuned("diffusion3d", tune, n_inner=n_inner, K=K,
                          chunk_knob="auto", use_kernels=use_kernels,
                          band=band, banded_knob=banded, params=params)
    if bx is None and tuned and tuned.get("bx"):
        bx = int(tuned["bx"])
    overlap = resolve_overlap(overlap, family="diffusion3d", tuned=tuned,
                              radius=1, chunk_active=banded is True)
    dx, dy, dz = params.spacing()
    dt = params.timestep()
    lam = params.lam
    sc = diffusion_pallas.scal(dx, dy, dz)
    dt_lam = float(dt * lam)
    last = {}

    def coefficient(Cp):
        """`A = dt*lam/Cp`, formed once per heat-capacity tensor (again only
        after an in-place change of `Cp`), not once per call."""
        if last.get("Cp") is not Cp or last["version"] != Cp._version:
            last.update(Cp=Cp, version=Cp._version, A=dt_lam / Cp)
        return last["A"]

    def plan(T, Cp):
        """The route of a call: ("plain", None), ("banded", (K, B)) or
        ("cuda", bx)."""
        grid = shared.global_grid()
        if not _kernel_path(use_kernels, T):
            if banded is True:
                raise GridError(f"{_BANDED_REQ}; the plain composition "
                                f"serves this field")
            return "plain", None
        local = grid.local_shape(T)
        depth = bx or chunk_engine.default_K(grid.nxyz[0])
        kb = band_config(
            banded, K, band, n_inner, requirement=_BANDED_REQ,
            from_cache=K_cached or band_cached,
            resident=lambda: (grid.dims == (1, 1, 1) and n_inner >= 2) or
            dtz.trapezoid_refusal(grid, local, depth, n_inner - 1,
                                  T.dtype) is None,
            supported=lambda k, b: dtz.banded_refusal(
                grid, local, k, n_inner - 1, T.dtype, B=b) is None,
            fit=lambda bands: dtz.fit_diffusion_band(
                grid, local, n_inner - 1, T.dtype, bands=bands))
        return ("banded", kb) if kb else ("cuda", depth)

    def plain(T, Cp):
        A = coefficient(Cp)
        local = shared.global_grid().local_shape(T)
        for _ in range(n_inner):
            T = halo.update_halo(
                diffusion_pallas.block_diffusion_compute(T, A, local, **sc),
                plain=True)
        return T

    def slab_step(T, A):
        return diffusion_pallas.block_diffusion_compute(
            T, A, shared.global_grid().local_shape(T), **sc)

    def overlapped(T, Cp):
        A = coefficient(Cp)
        for _ in range(n_inner):
            T = hide_communication(T, slab_step, A)
        return T

    def kernels(bx, T, Cp):
        return diffusion_pallas.fused_diffusion_steps(
            T, coefficient(Cp), n_inner=n_inner, bx=bx, **sc)

    def banded_steps(kb, T, Cp):
        A = coefficient(Cp)
        T = diffusion_pallas.fused_diffusion_step(T, A, **sc)
        T, done = dtz.fused_diffusion_banded_steps(
            T, A, n_inner=n_inner - 1, K=kb[0], B=kb[1],
            grid=shared.global_grid(), **sc)
        for _ in range(n_inner - 1 - done):
            T = diffusion_pallas.fused_diffusion_step(T, A, **sc)
        return T

    return auto_dispatch(
        family="diffusion3d", plan=plan,
        routes={"banded": banded_steps, "cuda": kernels}, plain=plain,
        overlap=overlapped if overlap else None,
        required=required_routes(use_kernels, banded), verify=verify)


def run(nt: int, params: Params = Params(), dtype=torch.float32,
        warmup: int = 1, n_inner: int = 1, use_kernels="auto",
        banded="auto", K: int = None, band: int = None):
    """Slope-timed run (:func:`igg_torch.time_steps`): `nt` timed calls in
    batches of ~nt/4 and ~3nt/4 after `warmup` untimed ones, each call
    advancing `n_inner` steps (`make_multi_step`'s route arguments).
    Returns `(T, seconds_per_step)`."""
    T, Cp = init_fields(params, dtype=dtype)
    step = make_multi_step(n_inner, params, use_kernels=use_kernels,
                           banded=banded, K=K, band=band)
    n1 = max(1, nt // 4)
    (T, Cp), sec = time_steps(lambda T, Cp: (step(T, Cp), Cp), (T, Cp),
                              n1=n1, n2=max(nt - n1, n1 + 1),
                              warmup=max(warmup, 1))
    return T, sec / n_inner


# Numeric integrity (igg_torch.integrity): where every dim is periodic and
# the heat capacity uniform, the flux-form update keeps the sum of T over
# owned cells (up to roundoff); state dicts with this family's "T" field
# opt in.
from .. import integrity as _integrity

_integrity.register_invariants("diffusion3d", [
    _integrity.Invariant("total_heat", ("T",), moment=1, kind="conserved",
                         requires_periodic=True),
])
