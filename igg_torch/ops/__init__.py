"""Kernels of the port and their plain PyTorch versions.

Every kernel is CUDA C++ under `igg_torch/csrc`, or generated from a
stencil spec by `igg_torch.stencil.cuda`, built at first use
(:mod:`igg_torch.ops._build`).  Each wrapper takes its plain version for a
CPU tensor, launches its kernel for a CUDA tensor (or raises), and counts
its launches in `<wrapper>.launches`.
"""

from . import (chunk_engine, diffusion_mega, diffusion_pallas,
               diffusion_trapezoid, halo_write, hm3d_mega, hm3d_pallas,
               hm3d_trapezoid, pack, stokes_pallas, stokes_trapezoid,
               wave2d_pallas, wave2d_trapezoid)
from .diffusion_mega import fused_diffusion_megasteps
from .diffusion_pallas import (diffusion_compute, fused_diffusion_step,
                               fused_diffusion_steps)
from .diffusion_trapezoid import (fused_diffusion_banded_steps,
                                  fused_diffusion_trapezoid_steps)
from .hm3d_mega import fused_hm3d_megasteps
from .hm3d_pallas import fused_hm3d_step, fused_hm3d_steps
from .hm3d_trapezoid import (fused_hm3d_banded_steps,
                             fused_hm3d_trapezoid_steps)
from .pack import pack_planes
from .stencil import interior_add
from .stokes_pallas import fused_stokes_iteration, fused_stokes_iterations
from .stokes_trapezoid import (fused_stokes_banded_iters,
                               fused_stokes_trapezoid_iters)
from .wave2d_pallas import fused_wave2d_step, fused_wave2d_steps
from .wave2d_trapezoid import fused_wave2d_chunk_steps

# name -> wrapper that launches the kernel
KERNELS = {
    "diffusion_step": diffusion_pallas.step_kernel,
    "diffusion_mega_step": diffusion_mega.mega_step_kernel,
    "halo_write": halo_write.halo_write,
    "pack_planes": pack.pack_planes,
    "diffusion_chunk_step": diffusion_trapezoid.chunk_call,
    "hm3d_step": hm3d_pallas.step_kernel,
    "hm3d_mega_step": hm3d_mega.mega_step_kernel,
    "hm3d_chunk_step": hm3d_trapezoid.chunk_call,
    "diffusion_band_step": diffusion_trapezoid.band_call,
    "hm3d_band_step": hm3d_trapezoid.band_call,
    "wave2d_step": wave2d_pallas.step_kernel,
    "wave2d_chunk_step": wave2d_trapezoid.chunk_call,
    "stokes_step": stokes_pallas.step_kernel,
    "stokes_chunk_step": stokes_trapezoid.chunk_call,
    "stokes_band_step": stokes_trapezoid.band_call,
}


def all_kernels() -> dict:
    """`KERNELS` and the wrappers of the kernels generated from a stencil
    spec (`igg_torch.stencil.lower`: the per-step kernel, the chunk step
    and the band step, each counting the launches of every spec)."""
    from ..stencil import lower

    return dict(KERNELS, spec_step=lower.step_kernel,
                spec_chunk_step=lower.chunk_call,
                spec_band_step=lower.band_call)


def reset_launch_counts() -> None:
    for fn in all_kernels().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in all_kernels().items()}
