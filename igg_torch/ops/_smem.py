"""The shared-memory budget of the band kernels (`igg/ops/_vmem.py` on the
card).

igg's budget authority models the VMEM footprint of each TPU kernel against
a scoped-VMEM cap.  On the H100 the band walks of the band kernels'
first designs (`csrc/band_walk.cuh` and the staggered walk kept in
kernel_variants.py) staged a band's window on chip, and the one limit that
binds is the shared memory a thread block may use: 232,448 bytes (227 KB,
opted into with `cudaFuncAttributeMaxDynamicSharedMemorySize` above the
default 48 KB).  :func:`banded_smem` is the bytes one thread block of
those walks stages, igg's gate for every band kernel: the band kernels
march x in segments of their own (`csrc/diffusion_march.cuh`,
`csrc/hm3d_march.cuh`, `csrc/stokes_march.cuh` and the generated rank-3
band entries' `csrc/stagger_band_march3.cuh`), hold the same shared
memory at every band depth, within what the gate admits, and are held to
the gate all the same, so that the tier admits what igg's admits.
:func:`fit_banded` keeps igg's
`(K, B)` search.  No override or autotune hook: those come with the perf
ledger and the autotuner.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

# Shared memory one thread block may use on the H100 (opt-in maximum).
SMEM_PER_BLOCK = 232_448
# The y and z cells of a band walk's thread-block tile (`BAND_TY`,
# `BAND_TZ` in csrc/band_walk.cuh, shared by the staggered walk).
BAND_TILE = (8, 32)


def chunk_budget() -> int:
    """The band kernels' per-block shared-memory budget."""
    return SMEM_PER_BLOCK


def banded_smem(B: int, extras: Sequence[int], *, lo: int = 1,
                itemsize: int = 4, stags: Optional[Sequence] = None,
                radius: int = 1) -> int:
    """Bytes one thread block of a band kernel stages: for each array (the
    updated fields, then the constant ones; `extras[f]` the rows it reads
    above a band), rows `lo + B + extras[f]` over the y/z tile plus the
    stencil's `radius` on both sides plus the array's own stagger along y
    and z (`stags[f] = (st_y, st_z)`, none when `stags` is None: the
    unstaggered band walk).  The freeze values are read from the
    chunk-entry buffers in device memory, as the chunk kernels read them,
    and take no shared memory."""
    ty, tz = BAND_TILE
    stags = stags or [(0, 0)] * len(extras)
    return int(sum((lo + B + e) * (ty + 2 * radius + sy)
                   * (tz + 2 * radius + sz)
                   for e, (sy, sz) in zip(extras, stags)) * itemsize)


def fit_banded(admissible: Callable[[int, int], bool], kmax: int, *,
               bands: Sequence[int] = (8, 16),
               min_k: int = 2) -> Optional[Tuple[int, int]]:
    """Largest admissible `(K, B)` of a band tier (igg's `fit_banded`): K
    by halving from `kmax`, bands in preference order; None when none
    applies.  `admissible(K, B)` is the family's whole gate."""
    K = int(kmax)
    while K >= min_k:
        for B in bands:
            if admissible(K, B):
                return K, B
        K //= 2
    return None
