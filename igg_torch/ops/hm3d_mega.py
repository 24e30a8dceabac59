"""K-step HM3D loop of a one-block grid (`igg.ops.hm3d_mega`).

`n_inner` launches of the fused HM3D step kernel (`csrc/hm3d_step.cu`,
:func:`igg_torch.ops.hm3d_pallas.launch_step`) with no received planes,
ping-ponging two preallocated pairs of buffers (Pe, phi): step k reads one
pair and writes the other.  Per-dimension halo modes: ``"wrap"``
(periodic: the halo is the updated inner plane, recomputed from the
step's sources) and ``"frozen"`` (open: halo cells are copied through),
with the corner rules of the fused step; together exactly the per-step
composition `update_halo(*compute_step(Pe, phi))` of a single block.

Replaces `igg/ops/hm3d_mega.py` (`_kernel`, `fused_hm3d_megasteps`), which
ran all K steps in one launch and took only grids that wrap in all three
dims; the port serves any one-block grid (the values are those of the
per-step route, only the route differs).  One launch for all K steps,
with a grid-wide sync, is later work.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .hm3d_pallas import launch_step, step_plain

_BLOCKS = (1, 1, 1)
_NO_PLANES = ({}, {})


def _check_modes(modes) -> None:
    if len(modes) != 3 or any(m not in ("wrap", "frozen") for m in modes):
        raise ValueError(f"modes {modes}: each must be 'wrap' or 'frozen'")


def mega_step_plain(Pe, phi, dst, modes, kw):
    """Plain PyTorch version of one launch: `dst` (a pair) <- one step of
    `(Pe, phi)`."""
    _check_modes(modes)
    new = step_plain(Pe, phi, tuple(modes), _NO_PLANES, _BLOCKS, kw)
    return tuple(d.copy_(n) for d, n in zip(dst, new))


def mega_step_kernel(Pe, phi, dst, modes, kw):
    """One step of the one-block grid `(Pe, phi)` into the preallocated pair
    `dst`.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises.  Launches count here, not in the step kernel's
    wrapper."""
    if Pe.device.type == "cpu":
        return mega_step_plain(Pe, phi, dst, modes, kw)
    _check_modes(modes)
    out = launch_step(Pe, phi, tuple(modes), _NO_PLANES, _BLOCKS, kw, out=dst)
    mega_step_kernel.launches += 1
    return out


mega_step_kernel.launches = 0


def fused_hm3d_megasteps(Pe, phi, *, n_inner: int, dx, dy, dz, dt, phi0,
                         npow, eta,
                         modes: Sequence[str] = ("wrap", "wrap", "wrap")):
    """Advance the one-block grid `(Pe, phi)` by `n_inner` steps; returns
    new tensors (the inputs are not modified).  Two pairs of buffers are
    allocated once and ping-ponged."""
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    kw = dict(dx=dx, dy=dy, dz=dz, dt=dt, phi0=phi0, npow=npow, eta=eta)
    bufs = [(torch.empty_like(Pe), torch.empty_like(phi)) for _ in range(2)]
    src = (Pe, phi)
    for k in range(n_inner):
        src = mega_step_kernel(*src, bufs[k % 2], tuple(modes), kw)
    return src
