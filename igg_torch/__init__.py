"""igg_torch — Implicit Global Grid on PyTorch and CUDA.

The PyTorch/CUDA port of `igg`: the same five-verb API
(`init_global_grid`, `update_halo`, `gather`, `select_device`,
`finalize_global_grid`), the 3-D diffusion solver, the HM3D porous-flow
solver, the 2-D staggered acoustic wave, the 3-D staggered Stokes solver
and the 2-D shallow-water family (`igg_torch.models`), and the
define-your-own-physics frontend `igg_torch.stencil`, with hand-written
CUDA kernels for the fused diffusion, HM3D and wave2d steps and Stokes
iteration (the first two also the K-step loop of a one-block grid), the
in-place halo writer, the y/z plane packer and the diffusion, HM3D, wave2d
and Stokes steps of a K-step chunk, and CUDA kernels generated from a
stencil spec for its fused step and its K-step chunk step.  Grid arrays are
block-stacked tensors on one device; entry points use the card unless the
caller passes `device="cpu"`.  Imports neither JAX nor `igg`.
"""

from .device import memory_stats, select_device
from .fields import (from_local_blocks, full, local_block, local_blocks, ones,
                     stacked_shape, zeros)
from .finalize import finalize_global_grid
from .gather import gather, gather_interior
from .halo import update_halo, update_halo_local
from . import stencil
from .init import init_global_grid
from .parallel import local_coords, sharded
from .shared import (NDIMS, PROC_NULL, GlobalGrid, GridError, check_initialized,
                     get_global_grid, global_grid, grid_epoch,
                     grid_is_initialized, has_neighbor, me, neighbor, neighbors,
                     ol)
from .timing import time_steps
from .tools import (barrier, coord_fields, nx_g, ny_g, nz_g, spacing, tic, toc,
                    x_g, x_g_field, y_g, y_g_field, z_g, z_g_field)

__all__ = [
    "NDIMS", "PROC_NULL", "GlobalGrid", "GridError", "barrier",
    "check_initialized", "coord_fields", "finalize_global_grid",
    "from_local_blocks", "full", "gather", "gather_interior",
    "get_global_grid", "global_grid", "grid_epoch", "grid_is_initialized",
    "has_neighbor", "init_global_grid", "local_block", "local_blocks",
    "local_coords", "me", "memory_stats", "neighbor", "neighbors", "nx_g",
    "ny_g", "nz_g", "ol", "ones", "select_device", "sharded", "spacing",
    "stacked_shape", "stencil", "tic", "time_steps", "toc", "update_halo",
    "update_halo_local", "x_g", "x_g_field", "y_g", "y_g_field", "z_g",
    "z_g_field", "zeros",
]
