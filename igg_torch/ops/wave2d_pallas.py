"""Fused wave2d step: kernel `igg_wave2d_step` (csrc/wave2d_step.cu).

One launch computes the whole coupled leapfrog update of every block of
`(P, Vx, Vy)` into new tensors (:func:`igg_torch.models.wave2d.
block_compute`: the velocities on their block's interior faces, then the
pressure on every cell from the fresh divergence); the halo planes of the
three fields then come from ONE `update_halo` through the port's halo
engine (the exchange and the in-place halo writer), as in igg, whose
kernel has no halo assembly either.  So a step is exactly the plain
composition `update_halo(*compute_step(P, Vx, Vy))` on every grid and
boundary condition.

Replaces `igg/ops/wave2d_pallas.py` (`_step_kernel`, `_call_step_kernel`,
`fused_wave2d_step`, `fused_wave2d_steps`).  igg's VMEM gate has no
counterpart.  Types: float32 and float64 (igg gates its kernels to
float32; its float64 path is the XLA composition, which computes the same
function).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import halo, shared
from ..models import wave2d as model
from ..shared import GridError
from ._build import library
from .diffusion_pallas import _DTYPE


def field_shapes(shape):
    """Local shapes of `(P, Vx, Vy)` from the pressure's `(S0, S1)`."""
    S0, S1 = shape
    return [(S0, S1), (S0 + 1, S1), (S0, S1 + 1)]


def kernel_refusal(grid, P, Vx, Vy) -> Optional[str]:
    """Why the wave2d kernels cannot serve `(P, Vx, Vy)`, or None when they
    can: the gates of igg's `wave2d_pallas_supported` (an overlap-2 grid, a
    2-D decomposition, the pressure on the grid block, blocks of at least
    4x4) without its VMEM gate, the staggered velocity shapes, f32 or
    f64, one device."""
    if grid.overlaps != (2, 2, 2):
        return f"grid overlaps {grid.overlaps} != (2, 2, 2)"
    if P.ndim != 2:
        return f"field rank {P.ndim} != 2"
    if grid.dims[2] != 1 or grid.nxyz[2] != 1:
        return (f"grid is not a 2-D decomposition (dims={tuple(grid.dims)}, "
                f"nz={grid.nxyz[2]})")
    s = grid.local_shape(P)
    if s != tuple(grid.nxyz[:2]):
        return f"local shape {s} != grid block {tuple(grid.nxyz[:2])}"
    if s[0] < 4 or s[1] < 4:
        return f"local block {s} too small (needs x >= 4, y >= 4)"
    for name, A, want in zip(("Vx", "Vy"), (Vx, Vy), field_shapes(s)[1:]):
        if A.ndim != 2 or grid.local_shape(A) != want:
            return (f"{name} {tuple(A.shape)} does not hold blocks of "
                    f"{want}")
    if P.dtype not in _DTYPE:
        return f"dtype {P.dtype} is not float32/float64"
    for A in (Vx, Vy):
        if A.dtype != P.dtype or A.device != P.device:
            return (f"velocity {A.dtype} on {A.device} is not like P "
                    f"{P.dtype} on {P.device}")
    return None


def coef_args(kw):
    """The kernels' coefficients as doubles: `c1 = -dt/rho`, `c2 =
    dt*bulk` (each rounded once to the field's type in the kernel), `dx`,
    `dy`."""
    return (ctypes.c_double * 4)(-kw["dt"] / kw["rho"], kw["dt"] * kw["bulk"],
                                 float(kw["dx"]), float(kw["dy"]))


def check_step(P, Vx, Vy, blocks):
    """Check the stacked fields of one step on `blocks = (n0, n1)` blocks;
    returns the pressure's local block shape."""
    if P.ndim != 2 or Vx.ndim != 2 or Vy.ndim != 2:
        raise ValueError("wave2d step: P, Vx and Vy must be 2-D")
    n0, n1 = blocks
    if P.shape[0] % n0 or P.shape[1] % n1:
        raise ValueError(f"P {tuple(P.shape)} is not stacked over {blocks} "
                         f"blocks")
    s = (P.shape[0] // n0, P.shape[1] // n1)
    if min(s) < 2:
        raise ValueError(f"P blocks {s} too small")
    for name, A, (a, b) in zip(("Vx", "Vy"), (Vx, Vy), field_shapes(s)[1:]):
        if tuple(A.shape) != (n0 * a, n1 * b):
            raise ValueError(f"{name} {tuple(A.shape)}: expected "
                             f"{(n0 * a, n1 * b)} for P blocks {s}")
    if P.dtype not in _DTYPE or Vx.dtype != P.dtype or Vy.dtype != P.dtype:
        raise ValueError(f"dtypes {P.dtype}/{Vx.dtype}/{Vy.dtype}: need one "
                         f"of float32/float64")
    return s


def step_plain(P, Vx, Vy, blocks, kw):
    """Plain PyTorch version of the kernel: the coupled update of every
    block into new tensors."""
    check_step(P, Vx, Vy, blocks)
    return model.block_compute(P, Vx, Vy, blocks, **kw)


def step_kernel(P, Vx, Vy, blocks, kw):
    """The coupled update of every block into new tensors.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if P.device.type == "cpu":
        return step_plain(P, Vx, Vy, blocks, kw)
    out = launch_step(P, Vx, Vy, blocks, kw)
    step_kernel.launches += 1
    return out


def launch_step(P, Vx, Vy, blocks, kw, out=None):
    """Check CUDA fields and launch the kernel once on the current stream,
    into `out` (allocated when None).  Counts nothing."""
    s = check_step(P, Vx, Vy, blocks)
    srcs = (P, Vx, Vy)
    for A in srcs:
        if A.device.type != "cuda" or A.device != P.device:
            raise ValueError(f"wave2d step kernel: fields on "
                             f"{[str(x.device) for x in srcs]}")
        if not A.is_contiguous():
            raise ValueError("wave2d step kernel: fields must be contiguous")
    if out is None:
        out = tuple(torch.empty_like(A) for A in srcs)
    ptrs = {A.data_ptr() for A in srcs}
    for o, A in zip(out, srcs):
        if (o.shape != A.shape or o.dtype != A.dtype or o.device != A.device
                or not o.is_contiguous()):
            raise ValueError(f"wave2d step kernel: out {tuple(o.shape)} "
                             f"{o.dtype} on {o.device} is not a contiguous "
                             f"tensor like its source")
        if o.data_ptr() in ptrs:
            raise ValueError("wave2d step kernel: an output aliases a source "
                             "or another output")
        ptrs.add(o.data_ptr())
    _launch(srcs, out, blocks, s, kw,
            torch.cuda.current_stream(P.device).cuda_stream)
    return tuple(out)


def _launch(srcs, out, blocks, s, kw, stream: int) -> None:
    """Launch `igg_wave2d_step` on checked arguments."""
    cfg = (ctypes.c_int * 4)(*blocks, *s)
    err = library("wave2d_step").igg_wave2d_step(
        (ctypes.c_void_p * 3)(*[A.data_ptr() for A in srcs]),
        (ctypes.c_void_p * 3)(*[o.data_ptr() for o in out]),
        _DTYPE[srcs[0].dtype], cfg, coef_args(kw), stream)
    if err:
        raise RuntimeError(f"igg_wave2d_step launch failed: CUDA error {err}")


step_kernel.launches = 0


def fused_wave2d_step(P, Vx, Vy, *, dx, dy, dt, rho, bulk):
    """One wave2d step of the grid arrays `(P, Vx, Vy)` into new tensors:
    one kernel launch on CUDA tensors, then one halo update of the three
    fields."""
    kw = dict(dx=dx, dy=dy, dt=dt, rho=rho, bulk=bulk)
    out = step_kernel(P, Vx, Vy, shared.global_grid().dims[:2], kw)
    return tuple(halo.update_halo_local(*out))


BANDED_REQ = ("banded=True needs the wave2d kernels' plain versions (CPU "
              "tensors; igg's streaming kernel is 3-D only) and an "
              "admissible banded config (K, B): n_inner >= K + 1 >= 3, a "
              "periodic overlap-2 2-D grid, an extended x span of >= 2 "
              "bands of B, 2K-deep send slabs inside every extended "
              "dimension's block (igg_torch.ops.wave2d_trapezoid."
              "wave2d_banded_refusal)")


def fused_wave2d_steps(P, Vx, Vy, *, n_inner: int, K: Optional[int] = None,
                       banded="auto", band: Optional[int] = None, dx, dy,
                       dt, rho, bulk):
    """`n_inner` wave2d steps of `(P, Vx, Vy)`; returns new tensors.  The
    dispatch of `igg/models/wave2d.py:make_step`:

    - where `n_inner >= 3`, `banded` is not True and the chunk admits
      `n_inner - 1` steps at a depth K (`K`, or the largest of 8, 4, 2 it
      admits: :func:`igg_torch.ops.wave2d_trapezoid.fit_wave2d_K`): one
      per-step step (which makes the state exchange-fresh, the chunk's
      entry condition), then `(n_inner - 1) // K` chunks, then the
      remainder as per-step steps;
    - on CPU tensors, where the banded tier takes the call (`banded=True`,
      or "auto" where the chunk refuses; `models._dispatch.band_config`):
      the warm-up step, the banded chunks
      (:func:`~igg_torch.ops.wave2d_trapezoid.fused_wave2d_banded_steps`),
      the remainder; on the card `banded=True` raises igg's refusal (its
      streaming kernel is 3-D only) and "auto" never takes the tier;
    - otherwise one per-step step per step."""
    from ..models._dispatch import band_config
    from . import wave2d_trapezoid as wtz

    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dt=dt, rho=rho, bulk=bulk)
    S = (P, Vx, Vy)
    shape = grid.local_shape(P)
    Kf = (wtz.fit_wave2d_K(grid, shape, n_inner - 1, P.dtype, K=K)
          if n_inner >= 3 and banded is not True else 0)
    kb = None
    if P.device.type != "cpu":
        if banded is True:
            raise GridError(f"{BANDED_REQ}: the streaming band kernel is 3-D "
                            f"only (2-D x-row bands; banded_window_plain "
                            f"serves them on the CPU)")
    else:
        kb = band_config(
            banded, K, band, n_inner, requirement=BANDED_REQ,
            resident=lambda: bool(Kf),
            supported=lambda k, b: wtz.wave2d_banded_refusal(
                grid, shape, k, n_inner - 1, P.dtype, B=b) is None,
            fit=lambda bands: wtz.fit_wave2d_band(grid, shape, n_inner - 1,
                                                  P.dtype, bands=bands))
    if kb or Kf:
        S = fused_wave2d_step(*S, **kw)
        if kb:
            *S, done = wtz.fused_wave2d_banded_steps(
                *S, n_inner=n_inner - 1, K=kb[0], B=kb[1], **kw)
        else:
            *S, done = wtz.fused_wave2d_chunk_steps(*S, n_inner=n_inner - 1,
                                                    K=Kf, **kw)
        n_inner -= 1 + done
    for _ in range(n_inner):
        S = fused_wave2d_step(*S, **kw)
    return tuple(S)
