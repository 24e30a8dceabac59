"""Fused HM3D step: kernel `igg_hm3d_step` (csrc/hm3d_step.cu).

One launch computes one coupled step of both fields `(Pe, phi)` of a grid
into new tensors, halo maintenance included: the update of
:func:`igg_torch.models.hm3d.step_core` on every block's interior, then the
halo planes of both fields in dimension order, later dims owning the shared
corner and edge cells.  Per dimension the halo mode is that of the fused
diffusion step (:func:`igg_torch.ops.diffusion_pallas.step_modes`):

- ``"wrap"`` (periodic, one block): the halo is the updated inner plane,
  recomputed in the kernel from the sources, both fields of a cell
  together;
- ``"recv"`` (several blocks): the planes come from ONE grouped exchange
  of both fields' updated send planes, which are recomputed on thin
  3-plane slabs so the exchange does not depend on the step (the overlap
  recipe of `igg.hide_communication`);
- ``"frozen"`` (open, one block): nothing is received; the stale planes
  stay.

Replaces `igg/ops/hm3d_pallas.py` (`_make_kernel`, `_call_kernel`,
`fused_hm3d_step`, `fused_hm3d_steps`).  The TPU's slab carry and its
transposed z slabs existed only for its (8,128) tiling and have no
counterpart.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from .. import shared
from ..halo import block_rows, exchange_all_dims_grouped, extract_planes
from ..models import hm3d as model
from ._build import library
from .diffusion_pallas import (_DTYPE, _MODE, check_step, halo_specs,
                               kernel_refusal as _field_refusal, step_modes)
from .halo_write import halo_write_plain

_COEF = ("dx", "dy", "dz", "dt", "phi0", "eta")


def kernel_refusal(grid, Pe, phi) -> Optional[str]:
    """Why the HM3D kernels cannot serve `(Pe, phi)`, or None when they can:
    the gates of igg's `hm3d_pallas_supported` (overlap-2 grid, 3-D
    unstaggered fields) without its Mosaic slab and VMEM gates, f32 or
    f64, both fields alike."""
    why = _field_refusal(grid, Pe)
    if why is not None:
        return why
    if (phi.shape != Pe.shape or phi.dtype != Pe.dtype
            or phi.device != Pe.device):
        return (f"phi {tuple(phi.shape)} {phi.dtype} on {phi.device} is not "
                f"like Pe {tuple(Pe.shape)} {Pe.dtype} on {Pe.device}")
    return None


def _check(Pe, phi, modes, recv, blocks):
    check_step(phi, Pe, modes, recv[1], blocks)
    return check_step(Pe, phi, modes, recv[0], blocks)


def step_plain(Pe, phi, modes, recv, blocks, kw):
    """Plain PyTorch version of the kernel: one step of both fields into
    new tensors; `recv[f]` are field f's received planes."""
    local = _check(Pe, phi, modes, recv, blocks)
    out = model.block_compute(Pe, phi, local, **kw)
    return tuple(halo_write_plain(U, halo_specs(modes, r), blocks)
                 for U, r in zip(out, recv))


def step_kernel(Pe, phi, modes, recv, blocks, kw, out=None):
    """One step of `(Pe, phi)` into `out` (a pair of tensors; new tensors
    when None).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if Pe.device.type == "cpu":
        new = step_plain(Pe, phi, modes, recv, blocks, kw)
        return new if out is None else tuple(o.copy_(n)
                                             for o, n in zip(out, new))
    out = launch_step(Pe, phi, modes, recv, blocks, kw, out)
    step_kernel.launches += 1
    return out


def launch_step(Pe, phi, modes, recv, blocks, kw, out=None):
    """Check the arguments of CUDA fields and launch the kernel once on the
    current stream, into `out` (allocated when None).  Counts nothing:
    each wrapper counts its own launches."""
    local = _check(Pe, phi, modes, recv, blocks)
    if Pe.device.type != "cuda" or phi.device != Pe.device:
        raise ValueError(f"HM3D step kernel: Pe on {Pe.device}, phi on "
                         f"{phi.device}")
    if not (Pe.is_contiguous() and phi.is_contiguous()):
        raise ValueError("HM3D step kernel: Pe and phi must be contiguous")
    if out is None:
        out = (torch.empty_like(Pe), torch.empty_like(phi))
    srcs = {Pe.data_ptr(), phi.data_ptr()}
    for o in out:
        if (o.shape != Pe.shape or o.dtype != Pe.dtype
                or o.device != Pe.device or not o.is_contiguous()):
            raise ValueError(f"HM3D step kernel: out {tuple(o.shape)} "
                             f"{o.dtype} on {o.device} is not a contiguous "
                             f"tensor like Pe")
        if o.data_ptr() in srcs:
            raise ValueError("HM3D step kernel: an output aliases a source "
                             "(radius-1 stencil)")
    if out[0].data_ptr() == out[1].data_ptr():
        raise ValueError("HM3D step kernel: the two outputs alias")
    _launch(Pe, phi, out, modes, recv, blocks, local, kw,
            torch.cuda.current_stream(Pe.device).cuda_stream)
    return tuple(out)


def coef_args(kw):
    """The kernels' coefficients (`dx dy dz dt phi0 eta` as doubles) and
    `npow`."""
    coef = (ctypes.c_double * 6)(*[float(kw[k]) for k in _COEF])
    return coef, int(kw["npow"])


def _launch(Pe, phi, out, modes, recv, blocks, local, kw, stream: int) -> None:
    """Launch `igg_hm3d_step` on checked arguments."""
    ptrs = [None] * 12
    keep = []
    for f in range(2):
        for d in range(3):
            if modes[d] == "recv":
                for side in (0, 1):
                    P = recv[f][d][side].contiguous()
                    keep.append(P)
                    ptrs[6 * f + 2 * d + side] = P.data_ptr()
    cfg = list(blocks) + list(local) + [_MODE[m] for m in modes]
    coef, npow = coef_args(kw)
    err = library("hm3d_step").igg_hm3d_step(
        Pe.data_ptr(), phi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        _DTYPE[Pe.dtype], (ctypes.c_int * 9)(*cfg),
        (ctypes.c_void_p * 12)(*ptrs), coef, npow, stream)
    if err:
        raise RuntimeError(f"igg_hm3d_step launch failed: CUDA error {err}")


step_kernel.launches = 0


def _slab_planes(Pe, phi, d, local, first_row, kw):
    """The updated middle planes of both fields' 3-plane slabs starting at
    local row `first_row` of every block along `d`: a send plane of each
    field, recomputed from the sources alone."""
    n = Pe.shape[d] // local[d]
    idx = (block_rows(n, local[d], first_row, Pe.device)[:, None]
           + torch.arange(3, device=Pe.device)[None, :]).reshape(-1)
    slab_local = list(local)
    slab_local[d] = 3
    mid = block_rows(n, 3, 1, Pe.device)
    return tuple(U.index_select(d, mid) for U in model.block_compute(
        Pe.index_select(d, idx), phi.index_select(d, idx), tuple(slab_local),
        **kw))


def step_recv_planes(Pe, phi, grid, modes, kw) -> List:
    """Received halo planes of both fields for the `recv` dims: send planes
    recomputed on slabs (updated planes 1 and s-2), stale planes for open
    edges (extracted as the halo engine does, two or more y/z planes by
    the plane packer), exchanged in ONE dimension-sequential grouped call
    with corner propagation (`igg_torch.halo.exchange_all_dims_grouped`).
    Returns `[recv_Pe, recv_phi]`."""
    s = grid.local_shape(Pe)
    dims = [(d, 2) for d in range(3) if modes[d] != "frozen"]
    wraps = frozenset(d for d in range(3) if modes[d] == "wrap")
    sends, stale_reqs = ({}, {}), {}
    for d in range(3):
        if modes[d] != "recv":
            continue
        for side, first_row in ((0, 0), (1, s[d] - 3)):
            planes = _slab_planes(Pe, phi, d, s, first_row, kw)
            for f in range(2):
                sends[f][(d, side)] = planes[f]
        if not grid.periods[d]:
            stale_reqs[(d, 0)] = (d, 0)
            stale_reqs[(d, 1)] = (d, s[d] - 1)
    stales = [extract_planes(F, stale_reqs, grid) for F in (Pe, phi)]
    return exchange_all_dims_grouped(list(sends), [dims] * 2, grid, [s] * 2,
                                     stales, [wraps] * 2)


def fused_hm3d_step(Pe, phi, *, dx, dy, dz, dt, phi0, npow, eta):
    """One HM3D step of the grid arrays `(Pe, phi)` into new tensors, halos
    included (one kernel launch on CUDA tensors)."""
    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dz=dz, dt=dt, phi0=phi0, npow=npow, eta=eta)
    modes = step_modes(grid)
    recv = step_recv_planes(Pe, phi, grid, modes, kw)
    return step_kernel(Pe, phi, modes, recv, grid.dims, kw)


def fused_hm3d_steps(Pe, phi, *, n_inner: int, K: int, dx, dy, dz, dt, phi0,
                     npow, eta):
    """`n_inner` HM3D steps of `(Pe, phi)`; returns new tensors.  The
    dispatch of `igg/ops/hm3d_pallas.py:fused_hm3d_steps` and
    `igg/models/hm3d.py:make_step`:

    - a one-block grid and `n_inner >= 2`: the K-step loop
      (:mod:`igg_torch.ops.hm3d_mega`);
    - several blocks, where the chunk admits `n_inner - 1` steps at depth
      `K` (:func:`igg_torch.ops.hm3d_trapezoid.hm3d_trapezoid_refusal`):
      one per-step step (which makes the halos exchange-fresh, the chunk's
      entry condition), then `(n_inner - 1) // K` chunks, then the
      remainder as per-step steps;
    - otherwise one per-step kernel step per step."""
    from . import hm3d_mega, hm3d_trapezoid as htz

    grid = shared.global_grid()
    kw = dict(dx=dx, dy=dy, dz=dz, dt=dt, phi0=phi0, npow=npow, eta=eta)
    if grid.dims == (1, 1, 1) and n_inner >= 2:
        modes = tuple("wrap" if p else "frozen" for p in grid.periods)
        return hm3d_mega.fused_hm3d_megasteps(Pe, phi, n_inner=n_inner,
                                              modes=modes, **kw)
    if htz.hm3d_trapezoid_refusal(grid, grid.local_shape(Pe), K, n_inner - 1,
                                  Pe.dtype) is None:
        Pe, phi = fused_hm3d_step(Pe, phi, **kw)
        Pe, phi, done = htz.fused_hm3d_trapezoid_steps(
            Pe, phi, n_inner=n_inner - 1, K=K, grid=grid, **kw)
        n_inner -= 1 + done
    for _ in range(n_inner):
        Pe, phi = fused_hm3d_step(Pe, phi, **kw)
    return Pe, phi
