"""Specs and layouts the tests of the kernels generated from
`igg_torch.stencil` specs share (tests/test_torch_kernel_sources.py on the
CPU through g++, tests/test_torch_kernels.py on a card).

Specs: shallow water without and with friction (a self-read in an `add`
update), spec-wave2d, the rank-3 `relax3d` of tests/test_stencil.py, the
rank-3 staggered `acoustic3d` (wave2d's leapfrog carried to three dims: a
pressure and three face velocities, each frozen on its own dim), and
`mixed`: `pow` with the exponents 2 and 3, `where` on a comparison,
`Const / Read` and `Read / Const`, and a constant staggered field.
Coefficients are fixed numbers, so the checks need no grid-derived
spacing.  The rank-3 specs also drive the generated band entry
(tests/test_torch_banded_stagger.py, the kernel tests, chip_smoke.py)."""

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


def acoustic3d_spec(m=stencil):
    """A 3-D acoustic leapfrog (the spec module `m`: igg_torch.stencil, or
    igg.stencil in the tests that hold the two against each other): face
    velocities from the pressure gradient on their no-write interiors,
    then the pressure full-shape from the fresh velocity divergence."""
    P = m.Field("P", stagger=(0, 0, 0))
    Vx = m.Field("Vx", stagger=(1, 0, 0))
    Vy = m.Field("Vy", stagger=(0, 1, 0))
    Vz = m.Field("Vz", stagger=(0, 0, 1))
    dt, dx, dy, dz = m.Param("dt"), m.Param("dx"), m.Param("dy"), m.Param("dz")
    rho, bulk = m.Param("rho"), m.Param("K")
    return m.StencilSpec(
        "acoustic3d", fields=[P, Vx, Vy, Vz],
        params=[dt, dx, dy, dz, rho, bulk],
        updates=[
            m.Update(Vx, -dt / rho * (P[0, 0, 0] - P[-1, 0, 0]) / dx),
            m.Update(Vy, -dt / rho * (P[0, 0, 0] - P[0, -1, 0]) / dy),
            m.Update(Vz, -dt / rho * (P[0, 0, 0] - P[0, 0, -1]) / dz),
            m.Update(P, P - dt * bulk * ((Vx[1, 0, 0] - Vx[0, 0, 0]) / dx
                                         + (Vy[0, 1, 0] - Vy[0, 0, 0]) / dy
                                         + (Vz[0, 0, 1] - Vz[0, 0, 0]) / dz),
                     mode="assign"),
        ])


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
    "acoustic3d": (acoustic3d_spec, dict(dt=0.05, dx=0.31, dy=0.27, dz=0.43,
                                         rho=1.3, K=0.7)),
}
SPECS_3D = ("relax3d", "acoustic3d")
SPECS_2D = sorted(n for n in SPECS if n not in SPECS_3D)

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
# The band entry's window modes: GRIDS_3D (one periodic block, 2x2x2 open
# blocks, y one periodic block over an open x), one open block (every dim
# frozen) and y and z one periodic block over an open x of two blocks (the
# wraps' targets beside an x freeze row).
BAND_GRIDS = dict(GRIDS_3D, **{
    "1x1x1_open": dict(dimx=1, dimy=1, dimz=1),
    "2x1x1_wrap_yz": dict(dimx=2, dimy=1, dimz=1, periody=1, periodz=1)})
# Local shapes: (12, 10) and (16, 13) (odd y extents: the element path);
# rank 3 (12, 10, 9) and (10, 9, 8) (16-byte z rows).
LOCALS_2D = [(12, 10), (16, 13)]
LOCALS_3D = [(12, 10, 9), (10, 9, 8)]


def grids(spec_name):
    return GRIDS_3D if spec_name in SPECS_3D else GRIDS_2D


def locals_of(spec_name):
    return LOCALS_3D if spec_name in SPECS_3D else LOCALS_2D


def init(it, spec_name, case, local, device):
    kw = dict(grids(spec_name)[case])
    if spec_name not in SPECS_3D:
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


def band_setup(it, name, case, B, bands, yz, K, dtype, device="cpu",
               fields=None):
    """The generated band entry of spec `name` on the BAND_GRIDS layout
    `case`, blocks of `yz` along y and z and an extended x span of `bands`
    bands of B, at depth K: (gen, grid, shapes, E, modes, ols, extended
    buffers).  `fields(it, gen, grid, dtype, device)` makes the fields
    (random ones in (-1, 1) where None)."""
    gen = kernels(name)
    E = gen.analysis.margin_after(K)
    kw = BAND_GRIDS[case]
    it.init_global_grid(10, *yz, quiet=True, device=device, **kw)
    extra = ce.ext_shape((10,) + tuple(yz), E,
                         ce.dim_modes(it.get_global_grid()))[0] - 10
    it.finalize_global_grid()
    it.init_global_grid(B * bands - extra, *yz, quiet=True, device=device,
                        **kw)
    g = it.get_global_grid()
    shapes = lower.field_shapes(gen.spec, g.nxyz)
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, shapes)
    assert lower.banded_refusal(gen.spec, gen.analysis, g, shapes[0], K, K,
                                dtype, B=B) is None
    S = (state(it, gen, g, dtype, 67, device) if fields is None
         else fields(it, gen, g, dtype, device))
    return gen, g, shapes, E, modes, ols, ce.extend_fields(S, ols, E, g,
                                                           modes)


def at_rest(it, gen, g, dtype, device="cpu"):
    """Every field zero (fields at rest)."""
    return [torch.zeros(it.stacked_shape(s), dtype=dtype, device=device)
            for s in lower.field_shapes(gen.spec, g.nxyz)]


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


# -- igg_spec_step's x-march (csrc/stagger_band_march3.cuh: its step and
# chunk modes), held against the plain versions on the CPU rehearsal
# (tests/test_torch_spec_march.py) and on a card (tests/test_torch_kernels.py)

# Local blocks of the march's checks: LOCALS_3D ((12, 10, 9): odd z, rows
# copied element by element; (10, 9, 8): 16-byte rows in float32 and
# float64) and blocks whose y and z rows cross the tiles (relax3d's 16 x
# 32, acoustic3d's 8 x 32) and end in ragged ones (21 and 37 rows, with
# the extension and the face rows more).
MARCH_LOCALS = list(LOCALS_3D) + [(9, 21, 37)]
# Its edge cases' blocks: tiles ragged across the blocks' last rows with
# odd z extents, and an x extent of several segments.
MARCH_EDGE_LOCALS = {"ragged_tiles": (11, 19, 35), "segments": (40, 9, 12)}


def march_grid(it, case, local, device="cpu"):
    """A BAND_GRIDS layout of blocks `local`."""
    if it.grid_is_initialized():
        it.finalize_global_grid()
    it.init_global_grid(*local, quiet=True, device=device, **BAND_GRIDS[case])
    return it.get_global_grid()


def _same(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _stream(X):
    return (torch.cuda.current_stream(X.device).cuda_stream
            if X.device.type == "cuda" else 0)


def march_step_check(gen, g, S):
    """igg_spec_step on whole blocks (no wrap, no freeze: the march's step
    mode) into NaN-filled targets against `step_plain`, tolerance 0."""
    out = [torch.full_like(A, float("nan")) for A in S]
    lower._launch(gen, S, S, out, ce.stagger_cfg(g.nxyz, 0, ("ext",) * 3,
                                                 g.dims, [], False),
                  _stream(S[0]))
    for a, b in zip(out, lower.step_plain(gen, S, g.dims)):
        _same(a, b)


def march_chunk_check(it, gen, g, S, K):
    """K launches of igg_spec_step on the extended buffers of a depth-K
    chunk: every launch into NaN-filled whole extended targets against
    `chunk_plain` (K window steps), then the chunk as `chunk_call` runs it
    (the last launch into the central windows) against the plain chunk's
    central windows; tolerance 0.  Returns False where the chunk refuses
    the layout."""
    setup = chunk_setup(gen, g, S, K)
    if setup is None:
        return False
    E, modes, shapes, ols, exts = setup
    want = lower.chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=g,
                             ols=ols)
    stream = _stream(S[0])
    src = list(exts)
    for _ in range(K):
        dst = [torch.full_like(X, float("nan")) for X in exts]
        lower._launch(gen, src, exts, dst,
                      ce.stagger_cfg(g.nxyz, E, modes, g.dims, ols, False),
                      stream)
        src = dst
    for a, b in zip(src, want):
        _same(a, b)
    bufs = [[torch.full_like(X, float("nan")) for X in exts]
            for _ in range(2)]
    out = [torch.full(it.stacked_shape(s), float("nan"), dtype=S[0].dtype,
                      device=S[0].device) for s in shapes]
    src = list(exts)
    for k in range(K):
        last = k == K - 1
        dst = out if last else bufs[k % 2]
        lower._launch(gen, src, exts, dst,
                      ce.stagger_cfg(g.nxyz, E, modes, g.dims, ols, last),
                      stream)
        src = dst
    for a, b, s in zip(out, want, shapes):
        _same(a, ce.central_window(b, s, E, modes))
    return True
