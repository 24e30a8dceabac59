"""The port's streaming banded tier on staggered fields held against igg on
the CPU: Stokes (BASELINE config 5), the rank-3 specs `relax3d` and the
staggered `acoustic3d`, and the 2-D instances igg runs only in interpret
mode (wave2d and spec-wave2d).

igg's side runs as its own tests run it: `banded_window_xla` (the plain
realization of `_streaming_kernel`) under `igg.sharded` on igg's banded
meshes, so that every device's whole evolved buffer comes back stacked as
the port stacks its blocks; the model paths with `pallas_interpret=True,
banded=True` (tests/test_chunk_engine.py:407-500) and its XLA composition
in float64 (igg gates its banded tiers to float32).  The port runs with
`device="cpu"`, where the band kernels' plain version
(`chunk_engine.banded_window_plain`) serves.  Inputs are made with numpy
from a seed.

Tolerances, igg's own: Stokes float32 relative 5e-4 of the pressure's
largest magnitude for P and of the largest velocity magnitude for the
velocities (tests/test_chunk_engine.py:425, the pseudo-transient chain's
float32 reassociation; tests/test_torch_stokes_chunk.py's scales), float64
1e-12; wave2d and the specs relative 2e-5.  Between the port's banded and
window realizations and its routes, 0: the two realizations differ only in
shoulder rows the central windows never read.
"""

import subprocess
import sys
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import igg
import igg_torch as it
import torch_spec_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from igg import stencil as ist
from igg.models import stokes3d as ism
from igg.models import wave2d as iw2
from igg.ops import chunk_engine as ice
from igg.ops import stokes_trapezoid as istz
from igg_torch import convert
from igg_torch import stencil as tst
from igg_torch.models import stokes3d as tsm
from igg_torch.models import wave2d as tw2
from igg_torch.ops import _smem
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import stokes_pallas as sp
from igg_torch.ops import stokes_trapezoid as stz
from igg_torch.ops import wave2d_trapezoid as wtz
from igg_torch.stencil import lower

OL3 = dict(overlapx=3, overlapy=3, overlapz=3)
KW = dict(dx=0.31, dy=0.27, dz=0.43, mu=1.3, dtP=0.07, dtV=0.011)
PARAMS = ism.Params(lx=4.0, ly=4.0, lz=4.0)
REL_F32, REL_F64, REL_SPEC = 5e-4, 1e-12, 2e-5

MESHES = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "torus_open": ((2, 2, 2), (0, 0, 0)),
    "torus_mixed": ((2, 2, 2), (0, 1, 0)),
    "one_block_periodic": ((1, 1, 1), (1, 1, 1)),
}
# (K, B): an extended x span of 24 rows (blocks of 16, E = 4) in three
# bands of 8, and of 32 rows (E = 8) in two bands of 16.
DEPTHS = [(2, 8), (4, 16)]
LOCAL = (16, 16, 32)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(dims, periods, local, **kw):
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], quiet=True, **kw)
    igg.init_global_grid(*local, **kw)
    it.init_global_grid(*local, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)
    return igg.get_global_grid(), it.get_global_grid()


def close(port, ref, rel, velocities=True):
    """Each field within `rel` of its scale: the first field's largest
    magnitude for it, the largest velocity magnitude for the velocities
    (`velocities`), else each field's own."""
    ref = [np.asarray(b, np.float64) for b in ref]
    if velocities:
        scale = [np.abs(ref[0]).max()] + [max(np.abs(b).max()
                                              for b in ref[1:])] * 3
    else:
        scale = [np.abs(b).max() for b in ref]
    for f, (a, b, s) in enumerate(zip(port, ref, scale)):
        a = a.numpy().astype(np.float64)
        assert a.shape == b.shape, f
        err = np.abs(a - b).max() / (s + 1e-30)
        assert err < rel, (f, err)


def same(a, b):
    assert len(a) == len(b)
    for f, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f


def stokes_extended(mesh, K, dtype, seed=3):
    """Random Stokes fields on `mesh`, extended by 2K in the port."""
    ig, g = init_both(*MESHES[mesh], LOCAL, **OL3)
    rng = np.random.default_rng(seed)
    shapes = sp.field_shapes(g.nxyz)
    fields = [torch.from_numpy(rng.uniform(-1, 1, it.stacked_shape(s)))
              .to(dtype) for s in shapes]
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, shapes)
    exts = ce.extend_fields(fields[:4], ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([fields[4]], [ols[4]], 2 * K, g, modes)[0]
    return ig, g, exts, Rho_ext, dict(modes=modes, ols=ols, shapes=shapes)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,B", DEPTHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_stokes_banded_window_plain_matches_igg(mesh, K, B, dtype):
    """(a) The port's banded realization with the port of igg's
    `_band_update` against igg's `banded_window_xla` on the same extended
    buffers: every block's whole evolved buffer, shoulders and Vx's tail
    row included."""
    ig, g, exts, Rho_ext, lay = stokes_extended(mesh, K, dtype)
    kw = dict(K=K, B=B, lo=1, modes=lay["modes"], ols=lay["ols"],
              shapes=lay["shapes"], E=2 * K, extras=stz.EXTRAS, n_up=4,
              freeze_fields=stz.FREEZE_FIELDS)
    out = ce.banded_window_plain(
        list(exts) + [Rho_ext], grid=g,
        band_update=partial(stz.band_update, kw=KW), **kw)[:4]
    xs = [jnp.asarray(X.numpy()) for X in list(exts) + [Rho_ext]]
    ikw = dict(kw, grid=ig, band_update=partial(istz._band_update, scal=KW))
    if g.dims == (1, 1, 1):
        ref = ice.banded_window_xla(xs, **ikw)[:4]
    else:
        ref = igg.sharded(
            lambda *F: tuple(ice.banded_window_xla(list(F), **ikw)[:4]),
            out_specs=(PS(*igg.AXIS_NAMES),) * 4, check_vma=False)(*xs)
    close(out, ref, REL_F64 if dtype == torch.float64 else REL_F32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,B", DEPTHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_stokes_banded_central_equals_window_plain(mesh, K, B, dtype):
    """(b) The banded realization's central windows equal the window
    realization's (`window_chunk_plain`, the chunk kernel's plain version)
    bitwise, from random (not overlap-consistent) buffers."""
    _, g, exts, Rho_ext, lay = stokes_extended(mesh, K, dtype, seed=5)
    band = stz.band_call(exts, Rho_ext, lay["shapes"], K=K, B=B, grid=g,
                         kw=KW, modes=lay["modes"], ols=lay["ols"])
    win = stz.chunk_call(exts, Rho_ext, lay["shapes"], K=K, grid=g, kw=KW,
                         modes=lay["modes"], ols=lay["ols"])
    same(band, win)


def spy(monkeypatch, module, name):
    """Record the steps each call of a chunk function advances."""
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[-1])
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


def to_port(fields):
    names = [f"f{k}" for k in range(len(fields))]
    st = convert.to_torch({n: np.asarray(a) for n, a in zip(names, fields)})
    return [st[n] for n in names]


def test_stokes_model_banded_matches_igg(monkeypatch):
    """(c) `make_iteration(n_inner=5, banded=True, K=4, band=8)` takes the
    banded tier (a warm-up iteration and one chunk of 4), matches igg's
    interpret banded tier on igg's mesh (the overlap-3 8-block ring of
    16x16x128, tests/test_chunk_engine.py:407-433), and equals the port's
    chunk route bitwise."""
    init_both((8, 1, 1), (1, 1, 1), (16, 16, 128), **OL3)
    fields = ism.init_fields(PARAMS, dtype=np.float32)
    ref = ism.make_iteration(PARAMS, donate=False, n_inner=5,
                             pallas_interpret=True, banded=True, K=4,
                             band=8)(*fields)
    assert igg.degrade.active().get("stokes3d") == "stokes3d.banded"
    *state, Rho = to_port(fields)
    tp = convert.convert_params(PARAMS, tsm.Params)
    calls = spy(monkeypatch, stz, "fused_stokes_banded_iters")
    out = tsm.make_iteration(tp, n_inner=5, banded=True, K=4,
                             band=8)(*state, Rho)
    assert calls == [4]
    close(out, ref, REL_F32)
    same(out, tsm.make_iteration(tp, n_inner=5, K=4, banded=False)(*state,
                                                                    Rho))


@pytest.mark.parametrize("mesh,periods", [((2, 2, 2), (0, 0, 0)),
                                          ((1, 1, 1), (0, 1, 0))],
                         ids=["torus_open", "one_block_mixed"])
def test_stokes_model_banded_f64_matches_igg_xla(mesh, periods, monkeypatch):
    """(c) float64 (igg's banded tier is float32 only, so its XLA path is
    the reference), 24x24x20 blocks, 9 iterations: the banded route (a
    warm-up, two chunks of K = 4 at B = 8) within relative 1e-12 of igg,
    and bitwise the port's chunk route."""
    init_both(mesh, periods, (24, 24, 20), **OL3)
    fields = ism.init_fields(PARAMS, dtype=np.float64)
    ref = ism.make_iteration(PARAMS, donate=False, use_pallas=False,
                             overlap=False, n_inner=9)(*fields)
    *state, Rho = to_port(fields)
    tp = convert.convert_params(PARAMS, tsm.Params)
    calls = spy(monkeypatch, stz, "fused_stokes_banded_iters")
    out = tsm.make_iteration(tp, n_inner=9, banded=True, K=4,
                             band=8)(*state, Rho)
    assert calls == [8]
    close(out, ref, REL_F64)
    same(out, tsm.make_iteration(tp, n_inner=9, K=4)(*state, Rho))


SPEC_COEFFS = {
    "relax3d": dict(r=0.1),
    "acoustic3d": cases.SPECS["acoustic3d"][1],
}


def igg_spec(name):
    if name == "relax3d":
        T = ist.Field("T", stagger=(0, 0, 0))
        r = ist.Param("r", default=0.1)
        lap = (T[-1, 0, 0] + T[1, 0, 0] + T[0, -1, 0] + T[0, 1, 0]
               + T[0, 0, -1] + T[0, 0, 1] - 6.0 * T[0, 0, 0])
        return ist.StencilSpec("relax3d", fields=[T], params=[r], updates=[
            ist.Update(T, r * lap, pad=((1, 1),) * 3)])
    return cases.acoustic3d_spec(ist)


@pytest.mark.parametrize("mesh", ["ring_periodic", "torus_open",
                                  "torus_mixed"])
@pytest.mark.parametrize("name", ["relax3d", "acoustic3d"])
def test_rank3_spec_banded_matches_igg(name, mesh, monkeypatch):
    """(d) `compile(<rank-3 spec>, banded=True, K=4, band=8)` takes the
    banded route (a warm-up step and one chunk), matches igg's interpret
    banded rung (tests/test_chunk_engine.py:477-500) within 2e-5 of each
    field's scale, and equals the port's chunk route bitwise where that is
    exact (see the next test)."""
    dims, periods = MESHES[mesh]
    init_both(dims, periods, (16, 16, 32))
    spec_i, cf = igg_spec(name), SPEC_COEFFS[name]
    rng = np.random.default_rng(11)
    fields = igg.update_halo(*[igg.from_local_blocks(
        lambda c, ls: rng.uniform(-1, 1, ls), s, dtype=np.float32)
        for s in lower.field_shapes(cases.SPECS[name][0](), (16, 16, 32))])
    fields = list(fields) if isinstance(fields, tuple) else [fields]
    ref = ist.compile(spec_i, coeffs=cf, donate=False, n_inner=5,
                      pallas_interpret=True, banded=True, K=4,
                      band=8)(*fields)
    assert igg.degrade.active().get(name) == name + ".banded"
    S = to_port(fields)
    spec = cases.SPECS[name][0]()
    calls = spy(monkeypatch, lower, "spec_banded_steps")
    out = tst.compile(spec, coeffs=cf, n_inner=5, banded=True, K=4,
                      band=8)(*S)
    assert calls == [4]
    close(out, ref, REL_SPEC, velocities=False)
    if name == "relax3d" or all(periods):
        same(out, tst.compile(spec, coeffs=cf, n_inner=5, K=4,
                              banded=False)(*S))


@pytest.mark.parametrize("mesh,exact", [("ring_periodic", True),
                                        ("one_block_periodic", True),
                                        ("torus_open", False),
                                        ("torus_mixed", False)])
def test_acoustic3d_routes_against_per_step_route(mesh, exact):
    """The staggered chain's routes from an overlap-consistent state (a
    pressure pulse at rest, two XLA steps of igg): on periodic dims the
    banded route and the chunk route both equal the per-step route
    bitwise.  On an open dim of several blocks ("oext") a velocity's
    boundary row sits inside the extended window, so within a step the
    pressure reads a face the core computed from the shoulder before the
    freeze restores it: igg's own chunk tier carries the same deviation
    from its per-step path (0.6% of the pressure's scale here; igg's
    analyzer admits the chain on open dims).  The port's chunk route then
    matches igg's interpret chunk tier within 2e-5, and its banded route
    matches its chunk route within 2e-5 but not bitwise: the window
    realization re-freezes the velocities' shoulder rows every step, the
    banded one freezes only the boundary row and evolves the shoulder,
    which the deviated boundary faces then read."""
    dims, periods = MESHES[mesh]
    ig, _ = init_both(dims, periods, (16, 16, 32))
    spec_i, cf = cases.acoustic3d_spec(ist), SPEC_COEFFS["acoustic3d"]
    P = igg.zeros((16, 16, 32), dtype=np.float32)
    X, Y, Z = igg.coord_fields(0.31, 0.27, 0.43, P)
    P = (jnp.exp(-((X - 2.0) ** 2 + (Y - 2.0) ** 2 + (Z - 4.0) ** 2))
         + 0 * P).astype(np.float32)
    S = igg.update_halo(P, *[igg.zeros(s, dtype=np.float32) for s in (
        (17, 16, 32), (16, 17, 32), (16, 16, 33))])
    S = ist.compile(spec_i, coeffs=cf, donate=False, n_inner=2,
                    use_pallas=False)(*S)
    gen = cases.kernels("acoustic3d")
    run = partial(tst.compile, gen.spec, coeffs=cf, n_inner=9, K=4)
    T = to_port(S)
    banded = run(banded=True, band=8)(*T)
    chunk = run(banded=False)(*T)
    if exact:
        per_step = run(chunk=False, banded=False)(*T)
        same(banded, per_step)
        same(chunk, per_step)
        return
    ref = ist.compile(spec_i, coeffs=cf, donate=False, n_inner=9,
                      pallas_interpret=True, chunk=True, K=4)(*S)
    assert igg.degrade.active().get("acoustic3d") == "acoustic3d.chunk"
    close(chunk, ref, REL_SPEC, velocities=False)
    close(banded, [c.numpy() for c in chunk], REL_SPEC, velocities=False)
    assert not all(torch.equal(a, b) for a, b in zip(banded, chunk))


def wave_fields(p):
    """igg's `_wave_fields(p, pre_steps=3)`: the initial state evolved by
    three steps of igg's XLA path."""
    fields = iw2.init_fields(p, dtype=np.float32)
    return iw2.make_step(p, donate=False, n_inner=3,
                         use_pallas=False)(*fields)


def test_wave2d_banded_matches_igg(monkeypatch):
    """(d) wave2d's `make_multi_step(5, banded=True, K=4, band=8)` and the
    spec-wave2d `compile(banded=True)` take the banded tier on the CPU (the
    plain realization: igg's streaming kernel is 3-D only) and match igg's
    interpret banded tiers on the 4x2 periodic mesh
    (tests/test_chunk_engine.py:436-453, 477-500) within 2e-5; the model
    equals the port's chunk route bitwise."""
    init_both((4, 2, 1), (1, 1, 0), (16, 16, 1))
    p = iw2.Params()
    fields = wave_fields(p)
    ref = iw2.make_step(p, donate=False, n_inner=5, pallas_interpret=True,
                        banded=True, K=4, band=8)(*fields)
    assert igg.degrade.active().get("wave2d") == "wave2d.banded"
    S = to_port(fields)
    tp = convert.convert_params(p, tw2.Params)
    calls = spy(monkeypatch, wtz, "fused_wave2d_banded_steps")
    out = tw2.make_multi_step(5, tp, banded=True, K=4, band=8)(*S)
    assert calls == [4]
    close(out, ref, REL_SPEC, velocities=False)
    same(out, tw2.make_multi_step(5, tp, K=4, banded=False)(*S))

    spec_i = ist.wave2d_spec()
    ref = ist.compile(spec_i, coeffs=ist.wave2d_coeffs(p), donate=False,
                      n_inner=5, pallas_interpret=True, banded=True, K=4,
                      band=8)(*fields)
    assert igg.degrade.active().get(spec_i.name) == spec_i.name + ".banded"
    calls = spy(monkeypatch, lower, "spec_banded_steps")
    out = tst.compile(tst.wave2d_spec(), coeffs=tst.wave2d_coeffs(tp),
                      n_inner=5, banded=True, K=4, band=8)(*S)
    assert calls == [4]
    close(out, ref, REL_SPEC, velocities=False)


def test_stokes_gates_match_igg():
    """(e) The structural gates the port keeps refuse where igg's
    `stokes_banded_supported` does, with igg's reasons, on the overlap-3
    ring of 16x16x128: no full chunk, an extended x span B does not divide,
    fewer than two bands, send slabs in the sender's shared region, an
    overlap other than 3."""
    local = (16, 16, 128)
    ig, g = init_both((8, 1, 1), (1, 1, 1), local, **OL3)
    f32 = torch.float32
    assert stz.stokes_banded_refusal(g, local, 4, 4, f32, B=8) is None
    assert istz.stokes_banded_supported(ig, local, 4, 4, np.float32, B=8,
                                        interpret=True)
    cases_ = [((4, 3, 8), "holds no full K=4 chunk"),
              ((4, 4, 24), "not band-divisible by B=24"),
              ((4, 4, 32), "fewer than 2 bands"),
              ((8, 8, 8), "send slabs enter the sender's shared region")]
    for (K, n, B), why in cases_:
        assert why in stz.stokes_banded_refusal(g, local, K, n, f32, B=B)
        assert why in istz.stokes_banded_supported(
            ig, local, K, n, np.float32, B=B, interpret=True).reason
    igg.finalize_global_grid()
    it.finalize_global_grid()
    ig, g = init_both((8, 1, 1), (1, 1, 1), local)
    assert "overlaps" in stz.stokes_banded_refusal(g, local, 4, 4, f32, B=8)
    assert "overlaps" in istz.stokes_banded_supported(
        ig, local, 4, 4, np.float32, B=8, interpret=True).reason


def test_stokes_dropped_gates_and_budget():
    """(e) Where igg's compiled gates refuse for the TPU alone the port
    admits (a band depth off the sublane tile, float64); its budget is the
    card's shared memory: five arrays of (1 + B + extras) rows over their
    staggered 10 x 34 tiles, 71,120 bytes at B = 8 in float32, 142,240 in
    float64, and 253,856 at B = 16 in float64, above the 232,448 a thread
    block may use, so `fit_stokes_band` takes B = 8 there."""
    local = (16, 16, 128)
    ig, g = init_both((8, 1, 1), (1, 1, 1), local, **OL3)
    assert "not on sublane tiles" in istz.stokes_banded_supported(
        ig, local, 4, 4, np.float32, B=4).reason
    assert stz.stokes_banded_refusal(g, local, 4, 4, torch.float32,
                                     B=4) is None
    assert "float32" in istz.stokes_banded_supported(
        ig, local, 4, 4, np.float64, B=8, interpret=True).reason
    assert stz.stokes_banded_refusal(g, local, 4, 4, torch.float64,
                                     B=8) is None
    stags = [(s[1] - local[1], s[2] - local[2])
             for s in sp.field_shapes(local)]
    assert _smem.banded_smem(8, stz.EXTRAS, itemsize=4, stags=stags) == 71120
    assert _smem.banded_smem(8, stz.EXTRAS, itemsize=8,
                             stags=stags) == 142240
    assert _smem.banded_smem(16, stz.EXTRAS, itemsize=8,
                             stags=stags) == 253856
    assert "shared-memory budget" in stz.stokes_banded_refusal(
        g, local, 4, 4, torch.float64, B=16)
    assert stz.stokes_banded_refusal(g, local, 4, 4, torch.float32,
                                     B=16) is None
    assert stz.fit_stokes_band(g, local, 4, torch.float64,
                               bands=(16, 8)) == (4, 8)
    assert stz.fit_stokes_band(g, local, 4, torch.float32,
                               bands=(16, 8)) == (4, 16)


def test_stokes_gates_at_256_cubed():
    """(e) igg's admission case at 256^3 on one periodic block
    (tests/test_chunk_engine.py:503-538): the banded tier admits K = 4,
    B = 8 for 4 iterations in both packages; igg's resident fit refuses
    there (its VMEM budget), the port's chunk route admits."""
    s = (256, 256, 256)
    ig, g = init_both((1, 1, 1), (1, 1, 1), s, **OL3)
    assert istz.fit_stokes_K(ig, s, 8, np.float32, interpret=True) == 0
    assert stz.fit_stokes_K(g, s, 8, torch.float32) == 8
    assert istz.fit_stokes_band(ig, s, 4, np.float32,
                                interpret=True) == (4, 8)
    assert stz.fit_stokes_band(g, s, 4, torch.float32) == (4, 8)


def test_banded_true_raises_where_nothing_admits():
    """(e) `banded=True` raises a GridError naming "banded" where no
    `(K, B)` admits (n_inner = 2 holds no chunk; a pinned band of 24 does
    not divide the extended x span), with `use_kernels=False`, and on a
    spec whose chunk route is pinned, as igg's does."""
    init_both((8, 1, 1), (1, 1, 1), (16, 16, 32), **OL3)
    tp = convert.convert_params(PARAMS, tsm.Params)
    *state, Rho = tsm.init_fields(tp)
    with pytest.raises(it.GridError, match="banded"):
        tsm.make_iteration(tp, n_inner=2, banded=True)(*state, Rho)
    with pytest.raises(it.GridError, match="banded"):
        tsm.make_iteration(tp, n_inner=5, banded=True, K=4,
                           band=24)(*state, Rho)
    with pytest.raises(it.GridError, match="banded"):
        tsm.make_iteration(tp, n_inner=5, use_kernels=False, banded=True)
    igg.finalize_global_grid()
    it.finalize_global_grid()
    init_both((2, 2, 2), (1, 1, 1), (16, 16, 32))
    spec = cases.relax3d_spec()
    with pytest.raises(it.GridError, match="banded"):
        tst.compile(spec, n_inner=5, banded=True, chunk=True)
    with pytest.raises(it.GridError, match="banded"):
        tst.compile(spec, n_inner=5, banded=True, use_kernels=False)
    S = cases.state(it, cases.kernels("relax3d"), it.get_global_grid(),
                    torch.float32, 3)
    with pytest.raises(it.GridError, match="banded"):
        tst.compile(spec, n_inner=2, banded=True)(*S)


def test_auto_leaves_the_tier_to_the_chunk_route(monkeypatch):
    """(e) `banded="auto"` does not take the tier where the chunk route
    admits (the Stokes ring, relax3d on 2x2x2 blocks, wave2d on 4x2
    blocks), as igg's "auto" engages only where its resident fit
    refuses."""
    for module, name in ((stz, "fused_stokes_banded_iters"),
                         (lower, "spec_banded_steps"),
                         (wtz, "fused_wave2d_banded_steps")):
        monkeypatch.setattr(module, name,
                            lambda *a, **kw: pytest.fail("banded taken"))
    init_both((8, 1, 1), (1, 1, 1), (16, 16, 32), **OL3)
    tp = convert.convert_params(PARAMS, tsm.Params)
    tsm.make_iteration(tp, n_inner=9)(*tsm.init_fields(tp))
    igg.finalize_global_grid()
    it.finalize_global_grid()
    init_both((2, 2, 2), (1, 1, 1), (16, 16, 32))
    gen = cases.kernels("relax3d")
    tst.compile(gen.spec, coeffs=gen.coeffs, n_inner=9)(
        *cases.state(it, gen, it.get_global_grid(), torch.float32, 4))
    igg.finalize_global_grid()
    it.finalize_global_grid()
    init_both((4, 2, 1), (1, 1, 0), (16, 16, 1))
    tw2.make_multi_step(9, tw2.Params())(*tw2.init_fields(tw2.Params()))


def test_stagger_band_cfg_layout():
    """The staggered band layout: `stagger_cfg`'s `make_stag3` ints, then
    B, lo and each staged array's margin above a band, padded to MAXF."""
    _, g = init_both((2, 2, 2), (0, 1, 0), (16, 16, 32), **OL3)
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, sp.field_shapes(g.nxyz))
    base = list(ce.stagger_cfg(g.nxyz, 8, modes, g.dims, ols[:4], True))
    cfg = list(ce.stagger_band_cfg(g.nxyz, 8, modes, g.dims, ols[:4], True,
                                   B=8, lo=1, extras=stz.EXTRAS))
    assert cfg == base + [8, 1, 1, 2, 1, 1, 1, 2, 2, 2]
    assert len(base) == 24 + 3 * ce.MAXF


# The layouts of the Stokes kernel checks (overlap 3), as (dims, periods):
# igg's trapezoid matrix plus one-block grids (tests/test_torch_kernel_
# sources.py: STOKES_GRIDS).
STOKES_GRIDS = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "ring_open": ((8, 1, 1), (0, 0, 0)),
    "2x2x2_periodic": ((2, 2, 2), (1, 1, 1)),
    "2x2x2_open": ((2, 2, 2), (0, 0, 0)),
    "2x2x2_periods010": ((2, 2, 2), (0, 1, 0)),
    "4x2x1_periods101": ((4, 2, 1), (1, 0, 1)),
    "1x1x1_periodic": ((1, 1, 1), (1, 1, 1)),
    "1x1x1_open": ((1, 1, 1), (0, 0, 0)),
    "1x1x1_periods101": ((1, 1, 1), (1, 0, 1)),
}


def stokes_port_state(case, local, dtype, seed, K):
    """Random Stokes fields on the port's grid of layout `case`, made
    overlap-consistent by one `update_halo` (the chunk's entry state), and
    extended by 2K; returns the grid, the extended fields, Rho and the
    layout."""
    (dims, per) = STOKES_GRIDS[case]
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2], **OL3)
    g = it.get_global_grid()
    rng = np.random.default_rng(seed)
    shapes = sp.field_shapes(g.nxyz)
    fields = it.update_halo(*[torch.from_numpy(
        rng.uniform(-1, 1, it.stacked_shape(s))).to(dtype) for s in shapes])
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, shapes)
    exts = ce.extend_fields(list(fields[:4]), ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([fields[4]], [ols[4]], 2 * K, g, modes)[0]
    return g, exts, Rho_ext, dict(modes=modes, ols=ols, shapes=shapes)


def stokes_banded(g, exts, Rho_ext, lay, K, B, E):
    """K banded iterations of the plain version on buffers extended by E,
    whole evolved buffers."""
    return ce.banded_window_plain(
        list(exts) + [Rho_ext], K=K, B=B, lo=1, grid=g,
        band_update=partial(stz.band_update, kw=KW), extras=stz.EXTRAS,
        n_up=4, freeze_fields=stz.FREEZE_FIELDS, E=E,
        modes=lay["modes"], ols=lay["ols"], shapes=lay["shapes"])[:4]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_banded_function_does_not_depend_on_B(case, dtype):
    """The banded realization's whole evolved buffers are the same bits for
    every band depth B dividing the extended x span (2, 4, half of it, all
    of it): a band reads the previous iteration's values of its block,
    padded only at the block's x ends, so the bands are the TPU's VMEM at
    work and not part of the function.  The band kernel walks x in
    segments of its own choosing on that ground."""
    K, local = 2, (16, 10, 12)
    g, exts, Rho_ext, lay = stokes_port_state(case, local, dtype, 61, K)
    span = ce.ext_shape(local, 2 * K, lay["modes"])[0]
    Bs = [B for B in (2, 4, span // 2, span) if span % B == 0]
    assert len(set(Bs)) == 4
    want = stokes_banded(g, exts, Rho_ext, lay, K, Bs[0], 2 * K)
    for B in Bs[1:]:
        same(stokes_banded(g, exts, Rho_ext, lay, K, B, 2 * K), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_band_iteration_equals_chunk_iteration_inside(case, dtype):
    """From an overlap-consistent state, one banded iteration equals one
    window (chunk-step) iteration on the same extended buffers everywhere
    but at an extended block's outermost cells: P everywhere; the
    velocities except on each block's first and last x rows (the band walk
    clamps their neighbours to the block's rows, the chunk keeps them) and,
    on open dims, the shoulder rows beyond the freeze rows of the edge
    blocks (the chunk freezes every row from lo and hi outward, the band
    walk only lo and hi).  So the band kernel is the chunk kernel's x-march
    with those edge rules."""
    K, local = 3, (12, 12, 36)
    g, exts, Rho_ext, lay = stokes_port_state(case, local, dtype, 63, K)
    modes, shapes = lay["modes"], lay["shapes"]
    band = stokes_banded(g, exts, Rho_ext, lay, 1,
                         ce.ext_shape(local, 2 * K, modes)[0] // 2, 2 * K)
    win = ce.window_chunk_plain(
        list(exts), K=1, E=2 * K, modes=modes, grid=g,
        core=stz.window_core(g, Rho_ext, KW),
        freeze_fields=stz.FREEZE_FIELDS, ols=lay["ols"])
    assert torch.equal(band[0], win[0])
    for f in (1, 2, 3):
        a, b = band[f], win[f]
        ext = [a.shape[d] // g.dims[d] for d in range(3)]
        rows = ce.freeze_rows(modes, 2 * K, ext)
        keep = torch.ones(a.shape, dtype=torch.bool)
        for d in range(3):
            r = torch.arange(a.shape[d]) % ext[d]
            blk = torch.arange(a.shape[d]) // ext[d]
            edge = torch.zeros(a.shape[d], dtype=torch.bool)
            if d == 0:
                edge |= (r == 0) | (r == ext[d] - 1)
            if rows is not None and rows[d] is not None:
                edge |= ((blk == 0) & (r < rows[d][0])) | (
                    (blk == g.dims[d] - 1) & (r > rows[d][1]))
            view = [1, 1, 1]
            view[d] = -1
            keep &= ~edge.view(view)
        assert torch.equal(a[keep], b[keep]), f


def test_new_modules_import_neither_jax_nor_igg():
    """The staggered banded tier's modules and `chip_smoke.py` import
    neither JAX nor anything of igg."""
    code = ("import sys, chip_smoke, igg_torch.ops.stokes_trapezoid, "
            "igg_torch.ops.stokes_pallas, igg_torch.models.stokes3d, "
            "igg_torch.ops.wave2d_trapezoid, igg_torch.models.wave2d, "
            "igg_torch.stencil.lower, igg_torch.stencil.compile, "
            "igg_torch.stencil.cuda\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'igg' or m.startswith('igg.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
