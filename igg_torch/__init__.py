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
stencil spec for its fused step and its K-step chunk step; `telemetry`
(event bus, metrics, spans, sessions), `profiling` (`torch.profiler`
traces), `degrade` (the tier ladder every factory dispatches through,
with `verify=`), `checkpoint` (igg's flat and sharded formats, elastic
restore), `vis` (the background render/IO worker), `resilience`
(`run_resilient`: the NaN watchdog on CUDA events, the checkpoint ring
with its background writer, rollback, demotion on CPU tensors,
preemption and resume), `chaos` (its deterministic fault injectors) and
`overlap` (`hide_communication`: the boundary slabs and their exchange on
a side CUDA stream beside the full-domain compute, and the factories'
`overlap=` admission), `perf` (the perf ledger of measured step times,
its roofline and drift gauges, the regression gate) and `autotune` (the
measured route search and its tuning cache behind every factory's
`tune=`), `comm` (the comm ledger, the step-time decomposition, rank
skew and the collective-stall heartbeat behind `run_resilient(comm=)`)
`integrity` (invariant probes fused into the watchdog's probe,
shadow re-execution and deep-stamped generations behind
`run_resilient(integrity=)`), `ensemble` (`run_ensemble`: M
independent members with a per-member watchdog, lane rollback,
quarantine, preemption and elastic resume), `fleet` (`run_fleet`: a
queue of ensemble jobs over block slots, with its journal, retries,
preemption and elastic resume), `heal` (the self-healing engine
behind `heal=` on `run_resilient` and `run_fleet`), `statusd` (the live
ops endpoint behind `serve=` on the three run loops), `top` (its
terminal dashboard, `python -m igg_torch.top`) and `serve` (`serve_fleet`:
the always-on multi-tenant scheduler over block slots).
Grid arrays are block-stacked tensors on one device; entry points use the
card unless the caller passes `device="cpu"`.  Imports neither JAX nor
`igg`.
"""

from .checkpoint import (latest_checkpoint, load_checkpoint, save_checkpoint,
                         save_checkpoint_sharded, verify_checkpoint,
                         verify_checkpoint_distributed)
from .device import memory_stats, select_device
from .fields import (from_local_blocks, full, local_block, local_blocks, ones,
                     stacked_shape, zeros)
from .finalize import finalize_global_grid
from .gather import gather, gather_interior
from .halo import update_halo, update_halo_local
from . import (autotune, chaos, checkpoint, comm, degrade, ensemble, fleet,
               heal, integrity, overlap, perf, profiling, resilience,
               serve, statusd, stencil, telemetry, vis)
from .ensemble import (EnsembleResult, member_state, run_ensemble,
                       stack_members)
from .fleet import FleetResult, Job, JobOutcome, run_fleet
from .overlap import hide_communication
from .resilience import ResilienceError, RunResult, run_resilient
from .serve import ServeControl, ServeResult, serve_fleet
from .telemetry import Telemetry
from .init import init_global_grid
from .parallel import local_coords, sharded
from .shared import (NDIMS, NNEIGHBORS_PER_DIM, PROC_NULL, GlobalGrid,
                     GridError, check_initialized, get_global_grid,
                     global_grid, grid_epoch, grid_is_initialized,
                     has_neighbor, me, neighbor, neighbors, ol)
from .timing import time_steps
from .tools import (barrier, coord_fields, nx_g, ny_g, nz_g, spacing, tic, toc,
                    x_g, x_g_field, y_g, y_g_field, z_g, z_g_field)

__version__ = "0.1.0"


def __getattr__(name):
    # `top` is imported on first access, so `python -m igg_torch.top` does
    # not find it already imported by the package (runpy warns then).
    if name == "top":
        import importlib

        return importlib.import_module(".top", __name__)
    raise AttributeError(f"module 'igg_torch' has no attribute {name!r}")

__all__ = [
    "NDIMS", "NNEIGHBORS_PER_DIM", "PROC_NULL", "EnsembleResult",
    "FleetResult", "GlobalGrid", "GridError", "Job", "JobOutcome",
    "ResilienceError",
    "RunResult", "ServeControl", "ServeResult", "Telemetry", "autotune",
    "barrier", "chaos",
    "check_initialized",
    "checkpoint", "comm", "coord_fields", "degrade", "ensemble",
    "finalize_global_grid", "fleet", "from_local_blocks", "full", "gather",
    "gather_interior", "get_global_grid", "global_grid", "grid_epoch",
    "grid_is_initialized", "has_neighbor", "heal", "hide_communication",
    "init_global_grid", "integrity",
    "latest_checkpoint", "load_checkpoint", "local_block", "local_blocks",
    "local_coords", "me", "member_state", "memory_stats", "neighbor",
    "neighbors", "nx_g",
    "ny_g", "nz_g", "ol", "ones", "overlap", "perf", "profiling",
    "resilience",
    "run_ensemble", "run_fleet", "run_resilient", "save_checkpoint",
    "save_checkpoint_sharded", "select_device", "serve", "serve_fleet",
    "sharded", "spacing", "stack_members", "stacked_shape", "statusd",
    "stencil", "telemetry", "tic", "time_steps", "toc", "top",
    "update_halo", "update_halo_local", "verify_checkpoint",
    "verify_checkpoint_distributed", "vis", "x_g", "x_g_field", "y_g",
    "y_g_field", "z_g", "z_g_field", "zeros",
]
