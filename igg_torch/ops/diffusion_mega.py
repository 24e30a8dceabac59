"""K-step diffusion loop of a one-block grid (`igg.ops.diffusion_mega`).

`n_inner` launches of the fused step kernel (`csrc/diffusion_step.cu`,
:func:`igg_torch.ops.diffusion_pallas.launch_step`) with no received
planes, ping-ponging two preallocated buffers: step k reads one and writes
the other, with `A = dt*lam/Cp` formed once by the caller.  Per-dimension
halo modes:

- ``"wrap"`` (periodic): the halo is the updated inner plane, recomputed
  from the step's source buffer (the self-neighbor path);
- ``"frozen"`` (open): halo cells are copied through from the source
  buffer.  Under a wrap dim, a frozen dim's edge cells take the wrapped
  rows of the source (a frozen-z column under wrap-y re-wraps its y-edge
  cells), the corner rules of `igg/ops/diffusion_mega.py:258-340`.

Both modes together are exactly the per-step composition
`update_halo(diffusion_compute(T))` of a single block.  Replaces
`igg/ops/diffusion_mega.py` (`_kernel`, `fused_diffusion_megasteps`).  The
TPU kernel ran all K steps in one launch with A resident in VMEM; A (64 MiB
at 256^3 f32) does not fit the H100's 50 MB L2, so here every step reads it
again.  Temporal blocking (K steps per pass) is later work.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .diffusion_pallas import launch_step, step_plain

_BLOCKS = (1, 1, 1)


def _check_modes(modes) -> None:
    if len(modes) != 3 or any(m not in ("wrap", "frozen") for m in modes):
        raise ValueError(f"modes {modes}: each must be 'wrap' or 'frozen'")


def mega_step_plain(src, A, dst, modes, sc):
    """Plain PyTorch version of one launch: `dst` <- one step of `src`."""
    _check_modes(modes)
    return dst.copy_(step_plain(src, A, tuple(modes), {}, _BLOCKS, sc))


def mega_step_kernel(src, A, dst, modes, sc):
    """One step of the one-block grid `src` into `dst` (preallocated).  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.  Launches count here, not in the step kernel's wrapper."""
    if src.device.type == "cpu":
        return mega_step_plain(src, A, dst, modes, sc)
    _check_modes(modes)
    launch_step(src, A, tuple(modes), {}, _BLOCKS, sc, out=dst)
    mega_step_kernel.launches += 1
    return dst


mega_step_kernel.launches = 0


def fused_diffusion_megasteps(T, A, *, n_inner: int, rdx2, rdy2, rdz2,
                              modes: Sequence[str] = ("wrap", "wrap", "wrap")):
    """Advance the one-block grid array `T` by `n_inner` steps; returns a
    new tensor (`T` is not modified).  Two buffers are allocated once and
    ping-ponged: step k reads one and writes the other."""
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    sc = dict(rdx2=rdx2, rdy2=rdy2, rdz2=rdz2)
    bufs = (torch.empty_like(T), torch.empty_like(T))
    src = T
    for k in range(n_inner):
        src = mega_step_kernel(src, A, bufs[k % 2], tuple(modes), sc)
    return src
