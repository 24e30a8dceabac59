"""Fused diffusion step: kernel `igg_diffusion_step` (csrc/diffusion_step.cu).

One launch computes one diffusion step of a grid array into a new tensor,
halo maintenance included: the 7-point update `T + A*lap` (`A = dt*lam/Cp`)
on every block's interior, then the halo planes in dimension order, later
dims owning the shared corner and edge cells.  Per dimension the halo mode is

- ``"wrap"`` (periodic, one block): the halo is the updated inner plane
  `s-2` / `1`, recomputed in the kernel from the source tensor with the
  same formula, so no grid-wide synchronization is needed;
- ``"recv"`` (several blocks): the planes come from the exchange of the
  updated send planes, which are recomputed on thin 3-plane slabs so the
  exchange does not depend on the step (the overlap recipe of
  `igg.hide_communication`);
- ``"frozen"`` (open, one block): nothing is received; the stale planes
  stay.

Replaces `igg/ops/diffusion_pallas.py` (`_make_kernel`, `_call_kernel`,
`fused_diffusion_step`).  The TPU's slab carry, transposed z slabs and
x-banding existed only for its (8,128) tiling and have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import shared
from ..halo import block_rows, exchange_all_dims, extract_planes
from ._build import library
from .halo_write import halo_write_plain
from .stencil import block_boundary_mask, interior_add

_MODE = {"frozen": 0, "wrap": 1, "recv": 2}
_DTYPE = {torch.float32: 0, torch.float64: 1}


def scal(dx, dy, dz) -> Dict[str, float]:
    return dict(rdx2=1.0 / (dx * dx), rdy2=1.0 / (dy * dy), rdz2=1.0 / (dz * dz))


def diffusion_compute(T, A, *, rdx2, rdy2, rdz2):
    """The stencil update of one block: conservative 7-point-Laplacian
    interior update, boundary planes keep their stale values.  Same
    association as `igg.ops.diffusion_compute`."""
    lap = ((T[2:, 1:-1, 1:-1] + T[:-2, 1:-1, 1:-1]) * rdx2
           + (T[1:-1, 2:, 1:-1] + T[1:-1, :-2, 1:-1]) * rdy2
           + (T[1:-1, 1:-1, 2:] + T[1:-1, 1:-1, :-2]) * rdz2
           - 2.0 * (rdx2 + rdy2 + rdz2) * T[1:-1, 1:-1, 1:-1])
    return interior_add(T, A[1:-1, 1:-1, 1:-1] * lap)


def block_diffusion_compute(T, A, local, **sc):
    """:func:`diffusion_compute` of every `local`-sized block of a stacked
    array: cells on a block's outer planes keep their stale values."""
    U = diffusion_compute(T, A, **sc)
    if tuple(T.shape) == tuple(local):
        return U
    return torch.where(block_boundary_mask(T.shape, local, T.device), T, U)


def step_modes(grid) -> Tuple[str, str, str]:
    """Per-dimension halo mode of the fused step (module docstring)."""
    return tuple("recv" if grid.dims[d] > 1
                 else ("wrap" if grid.periods[d] else "frozen")
                 for d in range(3))


def kernel_refusal(grid, T):
    """Why the fused kernels cannot serve `T`, or None when they can."""
    if grid.overlaps != (2, 2, 2):
        return f"grid overlaps {grid.overlaps} != (2, 2, 2)"
    if T.ndim != 3:
        return f"field rank {T.ndim} != 3"
    s = grid.local_shape(T)
    if s != tuple(grid.nxyz):
        return f"staggered local shape {s} != grid block {tuple(grid.nxyz)}"
    if min(s) < 3:
        return f"local block {s} has no interior"
    if T.dtype not in _DTYPE:
        return f"dtype {T.dtype} is not float32/float64"
    return None


def check_step(T, A, modes, recv, blocks):
    """Check the arguments of one step of `T` (with the like-shaped `A`) in
    per-dim halo `modes` with received planes `recv` on `blocks` blocks;
    returns the local block shape."""
    if T.ndim != 3 or tuple(A.shape) != tuple(T.shape):
        raise ValueError(f"T {tuple(T.shape)} and A {tuple(A.shape)} must be "
                         f"3-D of one shape")
    if T.dtype not in _DTYPE or A.dtype != T.dtype:
        raise ValueError(f"dtypes {T.dtype}/{A.dtype}: need one of float32/float64")
    local = []
    for d in range(3):
        if T.shape[d] % blocks[d] or T.shape[d] // blocks[d] < 3:
            raise ValueError(f"dim {d}: {T.shape[d]} cells in {blocks[d]} "
                             f"blocks of >= 3")
        local.append(T.shape[d] // blocks[d])
        if modes[d] == "wrap" and blocks[d] != 1:
            raise ValueError(f"wrap mode on dim {d} needs one block")
        if modes[d] == "recv":
            want = list(T.shape)
            want[d] = blocks[d]
            for P in recv[d]:
                if tuple(P.shape) != tuple(want) or P.dtype != T.dtype:
                    raise ValueError(f"recv plane of dim {d}: {tuple(P.shape)} "
                                     f"{P.dtype}, expected {tuple(want)} {T.dtype}")
        elif modes[d] not in _MODE:
            raise ValueError(f"unknown halo mode {modes[d]!r}")
    return tuple(local)


def halo_specs(modes, recv):
    """The halo writer's specs (`ops.halo_write`) of a step's halo modes."""
    return [(d, "wrap", 2) if m == "wrap" else (d, "ext", *recv[d])
            for d, m in enumerate(modes) if m != "frozen"]


def step_plain(T, A, modes, recv, blocks, sc):
    """Plain PyTorch version of the kernel: one step into a new tensor."""
    local = check_step(T, A, modes, recv, blocks)
    U = block_diffusion_compute(T, A, local, **sc)
    return halo_write_plain(U, halo_specs(modes, recv), blocks)


def step_kernel(T, A, modes, recv, blocks, sc, out=None):
    """One step of `T` into `out`, a new tensor when None (see module
    docstring).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if T.device.type == "cpu":
        U = step_plain(T, A, modes, recv, blocks, sc)
        return U if out is None else out.copy_(U)
    out = launch_step(T, A, modes, recv, blocks, sc, out)
    step_kernel.launches += 1
    return out


def launch_step(T, A, modes, recv, blocks, sc, out=None):
    """Check the arguments of a CUDA `T` and launch the kernel once on the
    current stream, into `out` (allocated when None).  Counts nothing: each
    wrapper counts its own launches."""
    local = check_step(T, A, modes, recv, blocks)
    if T.device.type != "cuda" or A.device != T.device:
        raise ValueError(f"step kernel: T on {T.device}, A on {A.device}")
    if not (T.is_contiguous() and A.is_contiguous()):
        raise ValueError("step kernel: T and A must be contiguous")
    if out is None:
        out = torch.empty_like(T)
    elif (out.shape != T.shape or out.dtype != T.dtype
          or out.device != T.device or not out.is_contiguous()):
        raise ValueError(f"step kernel: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} is not a contiguous tensor like T")
    if out.data_ptr() == T.data_ptr():
        raise ValueError("step kernel: out must not alias T (radius-1 stencil)")
    _launch(T, A, out, modes, recv, blocks, local, sc,
            torch.cuda.current_stream(T.device).cuda_stream)
    return out


def _launch(T, A, out, modes, recv, blocks, local, sc, stream: int) -> None:
    """Launch `igg_diffusion_step` on checked arguments."""
    ptrs = [None] * 6
    keep = []
    for d in range(3):
        if modes[d] == "recv":
            for side in (0, 1):
                P = recv[d][side].contiguous()
                keep.append(P)
                ptrs[2 * d + side] = P.data_ptr()
    cfg = list(blocks) + list(local) + [_MODE[m] for m in modes]
    rdx2, rdy2, rdz2 = sc["rdx2"], sc["rdy2"], sc["rdz2"]
    err = library("diffusion_step").igg_diffusion_step(
        T.data_ptr(), A.data_ptr(), out.data_ptr(), _DTYPE[T.dtype],
        (ctypes.c_int * 9)(*cfg), (ctypes.c_void_p * 6)(*ptrs),
        rdx2, rdy2, rdz2, 2.0 * (rdx2 + rdy2 + rdz2), stream)
    if err:
        raise RuntimeError(f"igg_diffusion_step launch failed: CUDA error {err}")


step_kernel.launches = 0


def _slab_planes(T, A, d, local, first_row, sc):
    """The updated middle plane of the 3-plane slab starting at local row
    `first_row` of every block along `d`: a send plane, recomputed from
    `T` alone."""
    n = T.shape[d] // local[d]
    idx = (block_rows(n, local[d], first_row, T.device)[:, None]
           + torch.arange(3, device=T.device)[None, :]).reshape(-1)
    slab_local = list(local)
    slab_local[d] = 3
    U = block_diffusion_compute(T.index_select(d, idx), A.index_select(d, idx),
                                tuple(slab_local), **sc)
    return U.index_select(d, block_rows(n, 3, 1, T.device))


def step_recv_planes(T, A, grid, modes, sc) -> Dict:
    """Received halo planes of the step for the `recv` dims: send planes
    recomputed on slabs of `T` (updated planes 1 and s-2), stale planes
    for open edges (extracted as the halo engine does, two or more y/z
    planes by the plane packer), exchanged dimension-sequentially with
    corner propagation (`igg_torch.halo.exchange_all_dims`)."""
    s = grid.local_shape(T)
    dims = [(d, 2) for d in range(3) if modes[d] != "frozen"]
    wraps = frozenset(d for d in range(3) if modes[d] == "wrap")
    sends, stale_reqs = {}, {}
    for d in range(3):
        if modes[d] != "recv":
            continue
        sends[(d, 0)] = _slab_planes(T, A, d, s, 0, sc)
        sends[(d, 1)] = _slab_planes(T, A, d, s, s[d] - 3, sc)
        if not grid.periods[d]:
            stale_reqs[(d, 0)] = (d, 0)
            stale_reqs[(d, 1)] = (d, s[d] - 1)
    stales = extract_planes(T, stale_reqs, grid)
    return exchange_all_dims(sends, dims, grid, s, stales, wraps)


def fused_diffusion_step(T, A, *, rdx2, rdy2, rdz2):
    """One diffusion step of the grid array `T` with coefficient
    `A = dt*lam/Cp` into a new tensor, halos included (one kernel launch
    on a CUDA tensor)."""
    grid = shared.global_grid()
    sc = dict(rdx2=rdx2, rdy2=rdy2, rdz2=rdz2)
    modes = step_modes(grid)
    recv = step_recv_planes(T, A, grid, modes, sc)
    return step_kernel(T, A, modes, recv, grid.dims, sc)


def fused_diffusion_steps(T, A, *, n_inner: int, bx: int, rdx2, rdy2, rdz2):
    """`n_inner` diffusion steps of the grid array `T` with coefficient
    `A`; returns a new tensor.  The dispatch of
    `igg/ops/diffusion_pallas.py:fused_diffusion_steps`:

    - a one-block grid and `n_inner >= 2`: the K-step loop
      (:mod:`igg_torch.ops.diffusion_mega`);
    - several blocks, where the trapezoid chunk admits `n_inner - 1` steps
      at `K = bx` (:func:`igg_torch.ops.diffusion_trapezoid.
      trapezoid_refusal`): one per-step step (which makes the halos
      exchange-fresh, the chunk's entry condition), then `(n_inner - 1) //
      K` chunks, then the remainder as per-step steps;
    - otherwise one per-step kernel step per step."""
    from . import diffusion_mega, diffusion_trapezoid as dtz

    grid = shared.global_grid()
    sc = dict(rdx2=rdx2, rdy2=rdy2, rdz2=rdz2)
    if grid.dims == (1, 1, 1) and n_inner >= 2:
        modes = tuple("wrap" if p else "frozen" for p in grid.periods)
        return diffusion_mega.fused_diffusion_megasteps(
            T, A, n_inner=n_inner, modes=modes, **sc)
    if dtz.trapezoid_refusal(grid, grid.local_shape(T), bx, n_inner - 1,
                             T.dtype) is None:
        T = fused_diffusion_step(T, A, **sc)
        T, done = dtz.fused_diffusion_trapezoid_steps(
            T, A, n_inner=n_inner - 1, bx=bx, grid=grid, **sc)
        n_inner -= 1 + done
    for _ in range(n_inner):
        T = fused_diffusion_step(T, A, **sc)
    return T
