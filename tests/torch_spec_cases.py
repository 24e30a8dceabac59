"""Specs and layouts the tests of the kernels generated from
`igg_torch.stencil` specs share (tests/test_torch_kernel_sources.py on the
CPU through g++, tests/test_torch_kernels.py on a card).

Specs: shallow water without and with friction (a self-read in an `add`
update), spec-wave2d, the rank-3 `relax3d` of tests/test_stencil.py, and
`mixed`: `pow` with the exponents 2 and 3, `where` on a comparison,
`Const / Read` and `Read / Const`, and a constant staggered field.
Coefficients are fixed numbers, so the checks need no grid-derived
spacing."""

import numpy as np
import torch

from igg_torch import stencil
from igg_torch.ops import chunk_engine as ce
from igg_torch.stencil import Field, Param, StencilSpec, Update, where
from igg_torch.stencil import lower

SW = dict(dt=0.05, dx=0.31, dy=0.27, g=9.81, H=1.0)


def relax3d_spec():
    """tests/test_stencil.py's rank-3 radius-1 relaxation."""
    T = Field("T", stagger=(0, 0, 0))
    r = Param("r", default=0.1)
    lap = (T[-1, 0, 0] + T[1, 0, 0] + T[0, -1, 0] + T[0, 1, 0]
           + T[0, 0, -1] + T[0, 0, 1] - 6.0 * T[0, 0, 0])
    return StencilSpec("relax3d", fields=[T], params=[r],
                       updates=[Update(T, r * lap, pad=((1, 1),) * 3)])


def mixed_spec():
    F = Field("F", stagger=(0, 0))
    G = Field("G", stagger=(1, 0))
    H = Field("H", stagger=(0, 1))         # never updated
    a = Param("a", default=0.05)
    return StencilSpec(
        "mixed", fields=[F, G, H], params=[a],
        updates=[
            Update(G, a * (F[0, 0] ** 2 - F[-1, 0] ** 3) * H[0, 1]),
            Update(F, where(F[0, 0] > 0.5, 0.0 * F[0, 0],
                            a * ((G[1, 0] - G[0, 0]) / 0.3
                                 + 1.0 / (2.0 + F[0, 1] ** 2))),
                   pad=((0, 0), (1, 1))),
        ])


# name -> (spec factory, coefficients)
SPECS = {
    "shallow_water": (stencil.shallow_water_spec, SW),
    "shallow_water_cf": (lambda: stencil.shallow_water_spec(cf=0.1), SW),
    "wave2d_spec": (stencil.wave2d_spec,
                    dict(dt=0.05, dx=0.31, dy=0.27, rho=1.3, K=0.7)),
    "mixed": (mixed_spec, dict(a=0.05)),
    "relax3d": (relax3d_spec, dict(r=0.1)),
}
SPECS_2D = sorted(n for n in SPECS if n != "relax3d")

# Layouts as init_global_grid keywords: every window mode (ext, wrap, oext,
# frozen) and BASELINE config 3's x-periodic, y-open ring.
GRIDS_2D = {
    "1x1_periodic": dict(dimx=1, dimy=1, periodx=1, periody=1),
    "1x1_open": dict(dimx=1, dimy=1),
    "4x2_periodic": dict(dimx=4, dimy=2, periodx=1, periody=1),
    "4x2_open": dict(dimx=4, dimy=2),
    "2x2_mixed": dict(dimx=2, dimy=2, periodx=1),
    "8x1_periodx": dict(dimx=8, dimy=1, periodx=1),
    "2x1_periody": dict(dimx=2, dimy=1, periody=1),
}
GRIDS_3D = {
    "1x1x1_periodic": dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1,
                           periodz=1),
    "2x2x2_open": dict(dimx=2, dimy=2, dimz=2),
    "2x1x1_periods010": dict(dimx=2, dimy=1, dimz=1, periody=1),
}
# Local shapes: (12, 10) and (16, 13) (odd y extents: the element path);
# rank 3 (12, 10, 9) and (10, 9, 8) (16-byte z rows).
LOCALS_2D = [(12, 10), (16, 13)]
LOCALS_3D = [(12, 10, 9), (10, 9, 8)]


def grids(spec_name):
    return GRIDS_3D if spec_name == "relax3d" else GRIDS_2D


def locals_of(spec_name):
    return LOCALS_3D if spec_name == "relax3d" else LOCALS_2D


def init(it, spec_name, case, local, device):
    kw = dict(grids(spec_name)[case])
    if spec_name != "relax3d":
        local, kw["dimz"] = tuple(local) + (1,), 1
    it.init_global_grid(*local, quiet=True, device=device, **kw)
    return it.get_global_grid()


def kernels(spec_name):
    from igg_torch.stencil import cuda

    make, coeffs = SPECS[spec_name]
    return cuda.kernels_for(make(), coeffs)


def state(it, gen, grid, dtype, seed, device="cpu"):
    """Random fields in (-1, 1) on the grid, from a numpy seed."""
    nd = gen.spec.ndim
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, it.stacked_shape(s)))
            .to(dtype).to(device)
            for s in lower.field_shapes(gen.spec, grid.nxyz[:nd])]


def chunk_setup(gen, grid, S, K):
    """(E, modes, shapes, ols, extended buffers) of a depth-K chunk, or None
    where the chunk refuses the layout."""
    nd = gen.spec.ndim
    shapes = lower.field_shapes(gen.spec, grid.nxyz[:nd])
    if lower.chunk_refusal(gen.spec, gen.analysis, grid, shapes[0], K, K,
                           S[0].dtype) is not None:
        return None
    E = gen.analysis.margin_after(K)
    modes = ce.dim_modes(grid)[:nd]
    ols = ce.field_ols(grid, shapes)
    return E, modes, shapes, ols, ce.extend_fields(S, ols, E, grid, modes)
