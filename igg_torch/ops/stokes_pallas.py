"""Fused Stokes iteration: kernel `igg_stokes_step` (csrc/stokes_step.cu).

One launch computes the whole pseudo-transient update of every block of
`(P, Vx, Vy, Vz)` into new tensors (:func:`igg_torch.models.stokes3d.
block_compute`: the pressure on every cell, the six stresses and three
residuals, the velocities on their block's interior faces), reading the
constant `Rho`; the halo planes of the four fields then come from ONE
grouped `update_halo` through the port's halo engine (the plane packer,
the exchange and the in-place halo writer).  So an iteration is exactly
the plain composition `update_halo(*compute_iteration(P, Vx, Vy, Vz, Rho))`
on every grid and boundary condition, which is also what igg's kernel
computes (its docstring: identical to the plain composition everywhere,
open-boundary planes included).

Replaces `igg/ops/stokes_pallas.py` (`_kernel`, `_call_kernel`,
`fused_stokes_iteration`) and the per-iteration dispatch of
`igg/models/stokes3d.py:make_iteration`.  igg's kernel assembles the halo
planes itself, from send planes recomputed on thin windows (transposed for
the TPU's z tiling); here that is later work.  igg's Mosaic slab gates and
VMEM budget have no counterpart.  Types: float32 and float64 (igg gates
its kernel to float32; its float64 path is the XLA composition, which
computes the same function).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import halo, shared
from ..models import stokes3d as model
from ._build import library
from .diffusion_pallas import _DTYPE


def field_shapes(shape):
    """Local shapes of `(P, Vx, Vy, Vz, Rho)` from the pressure's `(S0, S1,
    S2)`."""
    S0, S1, S2 = shape
    return [(S0, S1, S2), (S0 + 1, S1, S2), (S0, S1 + 1, S2),
            (S0, S1, S2 + 1), (S0, S1, S2)]


def kernel_refusal(grid, P, Vx, Vy, Vz, Rho) -> Optional[str]:
    """Why the Stokes kernels cannot serve `(P, Vx, Vy, Vz, Rho)`, or None
    when they can: the gates of igg's `stokes_pallas_supported` (an
    overlap-3 grid, 3-D fields, the pressure on the grid block) without its
    Mosaic slab and VMEM gates, the staggered shapes, blocks of at least 3
    cells, f32 or f64, all fields alike, one device."""
    if grid.overlaps != (3, 3, 3):
        return f"grid overlaps {grid.overlaps} != (3, 3, 3)"
    if P.ndim != 3:
        return f"pressure rank {P.ndim} != 3"
    s = grid.local_shape(P)
    if s != tuple(grid.nxyz):
        return f"local shape {s} != grid block {tuple(grid.nxyz)}"
    if min(s) < 3:
        return f"local block {s} too small (needs >= 3 cells per dim)"
    for name, A, want in zip(("Vx", "Vy", "Vz", "Rho"), (Vx, Vy, Vz, Rho),
                             field_shapes(s)[1:]):
        if A.ndim != 3 or grid.local_shape(A) != want:
            return (f"{name} {tuple(A.shape)} does not hold blocks of "
                    f"{want}")
    if P.dtype not in _DTYPE:
        return f"dtype {P.dtype} is not float32/float64"
    for A in (Vx, Vy, Vz, Rho):
        if A.dtype != P.dtype or A.device != P.device:
            return (f"field {A.dtype} on {A.device} is not like P "
                    f"{P.dtype} on {P.device}")
    return None


def coef_args(kw):
    """The kernels' coefficients as doubles: `dx`, `dy`, `dz`, `mu`,
    `2.0*mu` (igg's Python-float product), `dtP`, `dtV`, each rounded once
    to the field's type in the kernel."""
    mu = float(kw["mu"])
    return (ctypes.c_double * 7)(float(kw["dx"]), float(kw["dy"]),
                                 float(kw["dz"]), mu, 2.0 * mu,
                                 float(kw["dtP"]), float(kw["dtV"]))


def check_step(P, Vx, Vy, Vz, Rho, blocks):
    """Check the stacked fields of one iteration on `blocks = (n0, n1, n2)`
    blocks; returns the pressure's local block shape."""
    if any(A.ndim != 3 for A in (P, Vx, Vy, Vz, Rho)):
        raise ValueError("Stokes step: P, Vx, Vy, Vz and Rho must be 3-D")
    if any(P.shape[d] % blocks[d] for d in range(3)):
        raise ValueError(f"P {tuple(P.shape)} is not stacked over {blocks} "
                         f"blocks")
    s = tuple(P.shape[d] // blocks[d] for d in range(3))
    if min(s) < 3:
        raise ValueError(f"P blocks {s} too small")
    for name, A, want in zip(("Vx", "Vy", "Vz", "Rho"), (Vx, Vy, Vz, Rho),
                             field_shapes(s)[1:]):
        stacked = tuple(blocks[d] * want[d] for d in range(3))
        if tuple(A.shape) != stacked:
            raise ValueError(f"{name} {tuple(A.shape)}: expected {stacked} "
                             f"for P blocks {s}")
    if P.dtype not in _DTYPE or any(A.dtype != P.dtype
                                    for A in (Vx, Vy, Vz, Rho)):
        raise ValueError(f"dtypes {[A.dtype for A in (P, Vx, Vy, Vz, Rho)]}"
                         f": need one of float32/float64")
    return s


def step_plain(P, Vx, Vy, Vz, Rho, blocks, kw):
    """Plain PyTorch version of the kernel: the pseudo-transient update of
    every block into new tensors."""
    check_step(P, Vx, Vy, Vz, Rho, blocks)
    return model.block_compute(P, Vx, Vy, Vz, Rho, blocks, **kw)


def step_kernel(P, Vx, Vy, Vz, Rho, blocks, kw):
    """The update of every block into new tensors.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if P.device.type == "cpu":
        return step_plain(P, Vx, Vy, Vz, Rho, blocks, kw)
    out = launch_step(P, Vx, Vy, Vz, Rho, blocks, kw)
    step_kernel.launches += 1
    return out


def launch_step(P, Vx, Vy, Vz, Rho, blocks, kw, out=None):
    """Check CUDA fields and launch the kernel once on the current stream,
    into `out` (allocated when None).  Counts nothing."""
    s = check_step(P, Vx, Vy, Vz, Rho, blocks)
    srcs = (P, Vx, Vy, Vz)
    for A in srcs + (Rho,):
        if A.device.type != "cuda" or A.device != P.device:
            raise ValueError(f"Stokes step kernel: fields on "
                             f"{[str(x.device) for x in srcs + (Rho,)]}")
        if not A.is_contiguous():
            raise ValueError("Stokes step kernel: fields must be contiguous")
    if out is None:
        out = tuple(torch.empty_like(A) for A in srcs)
    ptrs = {A.data_ptr() for A in srcs + (Rho,)}
    for o, A in zip(out, srcs):
        if (o.shape != A.shape or o.dtype != A.dtype or o.device != A.device
                or not o.is_contiguous()):
            raise ValueError(f"Stokes step kernel: out {tuple(o.shape)} "
                             f"{o.dtype} on {o.device} is not a contiguous "
                             f"tensor like its source")
        if o.data_ptr() in ptrs:
            raise ValueError("Stokes step kernel: an output aliases a source "
                             "or another output")
        ptrs.add(o.data_ptr())
    _launch(srcs, Rho, out, blocks, s, kw,
            torch.cuda.current_stream(P.device).cuda_stream)
    return tuple(out)


def _ptrs(tensors):
    return (ctypes.c_void_p * 4)(*[t.data_ptr() for t in tensors])


def _launch(srcs, Rho, out, blocks, s, kw, stream: int) -> None:
    """Launch `igg_stokes_step` on checked arguments."""
    cfg = (ctypes.c_int * 6)(*blocks, *s)
    err = library("stokes_step").igg_stokes_step(
        _ptrs(srcs), Rho.data_ptr(), _ptrs(out), _DTYPE[srcs[0].dtype], cfg,
        coef_args(kw), stream)
    if err:
        raise RuntimeError(f"igg_stokes_step launch failed: CUDA error {err}")


step_kernel.launches = 0


def fused_stokes_iteration(P, Vx, Vy, Vz, Rho, *, dx, dy, dz, mu, dtP, dtV):
    """One Stokes iteration of the grid arrays `(P, Vx, Vy, Vz)` into new
    tensors: one kernel launch on CUDA tensors, then one grouped halo
    update of the four fields."""
    kw = dict(dx=dx, dy=dy, dz=dz, mu=mu, dtP=dtP, dtV=dtV)
    out = step_kernel(P, Vx, Vy, Vz, Rho, shared.global_grid().dims, kw)
    return tuple(halo.update_halo_local(*out))


BANDED_REQ = ("banded=True needs the Stokes kernels (use_kernels 'auto' or "
              "True, on fields they serve) and an admissible banded config "
              "(K, B): n_inner >= K + 1 >= 3, an overlap-3 grid, an extended "
              "x span of >= 2 bands of B, 2K-deep send slabs inside every "
              "extended dimension's block, a band window within a thread "
              "block's shared memory (igg_torch.ops.stokes_trapezoid."
              "stokes_banded_refusal)")


def fused_stokes_iterations(P, Vx, Vy, Vz, Rho, *, n_inner: int,
                            K: Optional[int] = None, banded="auto",
                            band: Optional[int] = None, dx, dy, dz, mu, dtP,
                            dtV):
    """`n_inner` Stokes iterations of `(P, Vx, Vy, Vz)`; returns new tensors.
    The dispatch of `igg/models/stokes3d.py:make_iteration`:

    - where `n_inner >= 3`, `banded` is not True and the chunk admits
      `n_inner - 1` iterations at a depth K (`K`, or the largest of 8, 4, 2
      it admits: :func:`igg_torch.ops.stokes_trapezoid.fit_stokes_K`): one
      per-iteration warm-up (which makes the state exchange-fresh, the
      chunk's entry condition), then `(n_inner - 1) // K` chunks, then the
      remainder per iteration;
    - where the banded tier takes the call (`banded=True`, or "auto" where
      the chunk refuses; `(K, B)` from `K` and `band` or
      :func:`~igg_torch.ops.stokes_trapezoid.fit_stokes_band`,
      `models._dispatch.band_config`): the warm-up, the banded chunks
      (:func:`~igg_torch.ops.stokes_trapezoid.fused_stokes_banded_iters`),
      the remainder; `banded=True` raises a GridError where no `(K, B)`
      admits;
    - otherwise one fused iteration per iteration."""
    from ..models._dispatch import band_config
    from . import stokes_trapezoid as stz

    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dz=dz, mu=mu, dtP=dtP, dtV=dtV)
    S = (P, Vx, Vy, Vz)
    shape = grid.local_shape(P)
    Kf = (stz.fit_stokes_K(grid, shape, n_inner - 1, P.dtype, K=K)
          if n_inner >= 3 and banded is not True else 0)
    kb = band_config(
        banded, K, band, n_inner, requirement=BANDED_REQ,
        resident=lambda: bool(Kf),
        supported=lambda k, b: stz.stokes_banded_refusal(
            grid, shape, k, n_inner - 1, P.dtype, B=b) is None,
        fit=lambda bands: stz.fit_stokes_band(grid, shape, n_inner - 1,
                                              P.dtype, bands=bands))
    if kb or Kf:
        S = fused_stokes_iteration(*S, Rho, **kw)
        if kb:
            *S, done = stz.fused_stokes_banded_iters(
                *S, Rho, n_inner=n_inner - 1, K=kb[0], B=kb[1], **kw)
        else:
            *S, done = stz.fused_stokes_trapezoid_iters(
                *S, Rho, n_inner=n_inner - 1, K=Kf, **kw)
        n_inner -= 1 + done
    for _ in range(n_inner):
        S = fused_stokes_iteration(*S, Rho, **kw)
    return tuple(S)
