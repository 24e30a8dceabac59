"""The port's streaming banded tier held against igg on the CPU.

igg's side runs as its own tests run it: `banded_window_xla` (the plain
realization of `_streaming_kernel`) on one block directly, as
tests/test_stokes_trapezoid.py drives igg's banded scheme, and on grids of
several blocks inside `igg.sharded`, so that every device's whole evolved
buffer comes back stacked as the port stacks its blocks; the model paths
with `pallas_interpret=True, banded=True` and with `use_pallas=False`, as
tests/test_chunk_engine.py:380-474 run them.  The port runs with
`device="cpu"`, where the band kernels' plain version
(`chunk_engine.banded_window_plain`) serves.  Inputs are made with numpy
from a seed, on igg's banded meshes (tests/test_chunk_engine.py:375-379:
the ring of 8 blocks periodic and open, the 2x2x2 torus with periods
(0, 1, 0)) and one periodic block.

Tolerances: against igg, float64 `atol=1e-12` and float32 `rtol=2e-6,
atol=2e-5` (tests/test_torch_trapezoid.py), and igg's own relative 2e-5 on
the model paths; between the port's banded and window realizations and
its routes, 0 (the same arithmetic on the cells the central windows depend
on).
"""

import subprocess
import sys
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import igg
import igg_torch as it
from igg.models import diffusion3d as d3
from igg.models import hm3d as ih
from igg.ops import chunk_engine as ice
from igg.ops import diffusion_trapezoid as idt
from igg.ops import hm3d_trapezoid as iht
from igg_torch import convert
from igg_torch.models import _dispatch
from igg_torch.models import diffusion3d as t3
from igg_torch.models import hm3d as th
from igg_torch.ops import _smem
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import diffusion_pallas as dp
from igg_torch.ops import diffusion_trapezoid as dtz
from igg_torch.ops import hm3d_pallas as hp
from igg_torch.ops import hm3d_trapezoid as htz

RTOL, ATOL = 2e-6, 2e-5
REL = 2e-5
SC = dict(rdx2=0.3, rdy2=0.25, rdz2=0.2)
KW = dict(dx=0.31, dy=0.27, dz=0.43, dt=5e-4, phi0=0.1, npow=3, eta=1.3)

MESHES = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "ring_open": ((8, 1, 1), (0, 0, 0)),
    "torus_mixed": ((2, 2, 2), (0, 1, 0)),
    "one_block_periodic": ((1, 1, 1), (1, 1, 1)),
}
# (K, B): three bands of 8 rows in an extended x span of 24 (blocks of
# 16 rows, K = 4), two of 16 in a span of 32 (K = 8).
DEPTHS = [(4, 8), (8, 16)]


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(mesh, local):
    dims, periods = MESHES[mesh]
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=dims[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], quiet=True)
    igg.init_global_grid(*local, **kw)
    it.init_global_grid(*local, device="cpu", **kw)
    return igg.get_global_grid(), it.get_global_grid()


def random_fields(g, ranges, seed, dtype):
    rng = np.random.default_rng(seed)
    shp = it.stacked_shape(g.nxyz)
    return [torch.from_numpy(rng.uniform(lo, hi, shp)).to(dtype)
            for lo, hi in ranges]


FAMILIES = {
    # name: (value ranges, port band core, igg band core, updated fields)
    "diffusion": (((-10, 10), (0.001, 0.1)), partial(dtz.banded_update, **SC),
                  partial(idt._banded_update, **SC), 1),
    "hm3d": (((-0.5, 0), (0.05, 0.25)), partial(htz.band_update, kw=KW),
             partial(iht._band_update, kw=KW), 2),
}


def extended(family, mesh, local, K, dtype, seed=3):
    """Random fields of `family` on `mesh`, extended by K in the port."""
    ig, g = init_both(mesh, local)
    ranges, core, icore, n_up = FAMILIES[family]
    fields = random_fields(g, ranges, seed, dtype)
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz] * 2)
    exts = ce.extend_fields(fields, ols, K, g, modes)
    kw = dict(K=K, modes=modes, ols=ols, shapes=[g.nxyz] * 2, E=K,
              extras=(1, 1), n_up=n_up, freeze_fields=tuple(range(n_up)),
              lo=1)
    return ig, g, exts, kw


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,B", DEPTHS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_banded_window_plain_matches_igg(mesh, family, K, B, dtype):
    """(a) The port's banded realization against igg's `banded_window_xla`
    on the same extended buffers: every block's whole evolved buffer,
    shoulders included (a clamp taken across the stacked tensor instead of
    per block shows there on the rings)."""
    local = (16, 16, 32)
    ig, g, exts, kw = extended(family, mesh, local, K, dtype)
    _, core, icore, n_up = FAMILIES[family]
    out = ce.banded_window_plain(list(exts), B=B, grid=g, band_update=core,
                                 **kw)[:n_up]
    xs = [jnp.asarray(X.numpy()) for X in exts]
    ikw = dict(kw, grid=ig, band_update=icore, B=B)
    if g.dims == (1, 1, 1):
        ref = ice.banded_window_xla(xs, **ikw)[:n_up]
    else:
        ref = igg.sharded(
            lambda *F: tuple(ice.banded_window_xla(list(F), **ikw)[:n_up]),
            out_specs=(P(*igg.AXIS_NAMES),) * n_up, check_vma=False)(*xs)
    for a, b in zip(out, ref):
        if dtype == torch.float64:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("K,B", DEPTHS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_banded_central_equals_window_plain(mesh, family, K, B):
    """(b) The banded realization's central blocks equal the window
    realization's (`window_chunk_plain`, the chunk kernels' plain version)
    bitwise: the two differ only in shoulder rows the central windows
    never read."""
    local = (16, 16, 32)
    _, g, exts, kw = extended(family, mesh, local, K, torch.float64, seed=5)
    _, core, _, n_up = FAMILIES[family]
    band = ce.banded_window_plain(list(exts), B=B, grid=g, band_update=core,
                                  **kw)[:n_up]
    modes = kw["modes"]
    if family == "diffusion":
        win = [dtz.window_steps_plain(exts[0], exts[1], K=K, modes=modes,
                                      grid=g, sc=SC)]
    else:
        win = htz.window_steps_plain(*exts, K=K, modes=modes, grid=g, kw=KW)
    for a, b in zip(band, win):
        assert torch.equal(ce.central_window(a, local, K, modes),
                           ce.central_window(b, local, K, modes))


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


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_diffusion_model_banded_matches_igg(mesh, monkeypatch):
    """(c) `make_multi_step(5, banded=True, K=4, band=8)` takes the banded
    tier (a warm-up step and one chunk), matches igg's interpret banded
    tier and its XLA composition, and equals the port's other kernel
    route bitwise."""
    params = d3.Params(lx=4.0, ly=4.0, lz=4.0)
    init_both(mesh, (16, 16, 128))
    T, Cp = d3.init_fields(params, dtype=np.float32)
    st = convert.to_torch({"T": np.asarray(T), "Cp": np.asarray(Cp)})
    tp = convert.convert_params(params, t3.Params)
    calls = spy(monkeypatch, dtz, "fused_diffusion_banded_steps")
    out = t3.make_multi_step(5, tp, banded=True, K=4, band=8,
                             use_kernels=True)(st["T"], st["Cp"])
    assert calls == [4]
    ref = d3.make_multi_step(5, params, donate=False, pallas_interpret=True,
                             banded=True, K=4, band=8)(T, Cp)
    assert igg.degrade.active().get("diffusion3d") == "diffusion3d.banded"
    xla = d3.make_multi_step(5, params, donate=False, use_pallas=False)(T, Cp)
    for r in (ref, xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    other = t3.make_multi_step(5, tp, banded=False)(st["T"], st["Cp"])
    assert torch.equal(out, other)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_hm3d_model_banded_matches_igg(mesh, monkeypatch):
    """(c) The same for HM3D: `make_multi_step(5, banded=True, K=4,
    band=8)` against igg's `make_step(n_inner=5, banded=True, K=4,
    band=8)` in interpret mode and its XLA composition, and bitwise
    against the port's other kernel route."""
    params = ih.Params(lx=4.0, ly=4.0, lz=4.0)
    init_both(mesh, (16, 16, 128))
    Pe, phi = ih.init_fields(params, dtype=np.float32)
    st = convert.to_torch({"Pe": np.asarray(Pe), "phi": np.asarray(phi)})
    state = (st["Pe"], st["phi"])
    tp = convert.convert_params(params, th.Params)
    calls = spy(monkeypatch, htz, "fused_hm3d_banded_steps")
    out = th.make_multi_step(5, tp, banded=True, K=4, band=8,
                             use_kernels=True)(*state)
    assert calls == [4]
    ref = ih.make_step(params, donate=False, n_inner=5,
                       pallas_interpret=True, banded=True, K=4,
                       band=8)(Pe, phi)
    assert igg.degrade.active().get("hm3d") == "hm3d.banded"
    xla = ih.make_step(params, donate=False, n_inner=5,
                       use_pallas=False)(Pe, phi)
    for r in (ref, xla):
        for a, b in zip(out, r):
            b = np.asarray(b, np.float64)
            rel = np.abs(a.numpy() - b).max() / (np.abs(b).max() + 1e-30)
            assert rel < REL, rel
    other = th.make_multi_step(5, tp, banded=False)(*state)
    assert all(torch.equal(a, b) for a, b in zip(out, other))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [8, 16])
def test_band_core_from_window_equals_hand_cores(B, dtype):
    """(d) A band core derived from each family's whole-window core
    (`band_core_from_window(core, lo=1)`) equals the hand band core
    bitwise on random band windows."""
    rng = np.random.default_rng(B)
    shape = (B + 2, 9, 13)
    W = [torch.from_numpy(rng.uniform(lo, hi, shape)).to(dtype)
         for lo, hi in ((-1, 1), (0.05, 0.25))]
    derived = ce.band_core_from_window(
        lambda T, A: (dp.diffusion_compute(T, A, **SC), A), lo=1, n_up=1)
    for a, b in zip(derived(*W, bx=B), dtz.banded_update(*W, bx=B, **SC)):
        assert torch.equal(a, b)
    derived = ce.band_core_from_window(
        lambda Pe, phi: th.block_compute(Pe, phi, Pe.shape, **KW), lo=1)
    for a, b in zip(derived(*W, bx=B), htz.band_update(*W, bx=B, kw=KW)):
        assert torch.equal(a, b)


def test_gates_match_igg_at_256_cubed():
    """(e) igg's admission case at 256^3 on one periodic block
    (tests/test_chunk_engine.py:509-538): the banded tier admits K=4, B=8
    for 4 steps in both packages.  igg's resident fit refuses there (its
    VMEM budget); the port's chunk route has no such budget and admits."""
    s = (256, 256, 256)
    igg.init_global_grid(*s, periodx=1, periody=1, periodz=1, quiet=True)
    it.init_global_grid(*s, periodx=1, periody=1, periodz=1, quiet=True,
                        device="cpu")
    ig, g = igg.get_global_grid(), it.get_global_grid()
    assert iht.fit_hm3d_K(ig, s, 8, np.float32, interpret=True) == 0
    assert htz.hm3d_trapezoid_refusal(g, s, 8, 8, torch.float32) is None
    assert iht.hm3d_banded_supported(ig, s, 4, 4, np.float32, B=8,
                                     interpret=True)
    assert htz.hm3d_banded_refusal(g, s, 4, 4, torch.float32, B=8) is None
    assert iht.fit_hm3d_band(ig, s, 4, np.float32, interpret=True) == (4, 8)
    assert htz.fit_hm3d_band(g, s, 4, torch.float32) == (4, 8)
    assert idt.fit_diffusion_band(ig, s, 4, np.float32,
                                  interpret=True) == (4, 8)
    assert dtz.fit_diffusion_band(g, s, 4, torch.float32) == (4, 8)


def test_gates_refuse_as_igg():
    """(e) The structural gates the port keeps refuse where igg's do, with
    the same reasons: no full chunk, an extended x span B does not divide,
    fewer than two bands, read margins beyond one band, an overlap other
    than 2 (HM3D), send slabs in the sender's shared region."""
    local = (16, 16, 32)
    ig, g = init_both("ring_periodic", local)
    cases = [((4, 3, 8), "holds no full K=4 chunk"),
             ((4, 4, 16), "not band-divisible by B=16"),
             ((4, 4, 24), "fewer than 2 bands")]
    for (K, n, B), why in cases:
        assert why in dtz.banded_refusal(g, local, K, n, torch.float32, B=B)
        assert why in htz.hm3d_banded_refusal(g, local, K, n, torch.float32,
                                              B=B)
        assert why in idt.diffusion_banded_supported(
            ig, local, K, n, np.float32, B=B, interpret=True).reason
        assert why in iht.hm3d_banded_supported(
            ig, local, K, n, np.float32, B=B, interpret=True).reason
    assert "exceed one band" in ce.admit_banded_geometry(
        [local], 4, ce.dim_modes(g), B=8, extras=(8,))
    assert "exceed one band" in ice.admit_banded_geometry(
        [local], 4, ce.dim_modes(g), B=8, extras=(8,), interpret=True).reason
    igg.finalize_global_grid()
    it.finalize_global_grid()
    local = (8, 8, 16)
    ig, g = init_both("torus_mixed", local)
    why = "send slabs enter the sender's shared region"
    assert why in dtz.banded_refusal(g, local, 8, 8, torch.float32, B=8)
    assert why in idt.diffusion_banded_supported(
        ig, local, 8, 8, np.float32, B=8, interpret=True).reason
    igg.finalize_global_grid()
    it.finalize_global_grid()
    igg.init_global_grid(*local, overlapx=3, quiet=True)
    it.init_global_grid(*local, overlapx=3, quiet=True, device="cpu")
    assert "overlaps" in htz.hm3d_banded_refusal(
        it.get_global_grid(), local, 2, 2, torch.float32, B=8)
    assert "overlaps" in iht.hm3d_banded_supported(
        igg.get_global_grid(), local, 2, 2, np.float32, B=8,
        interpret=True).reason


def test_dropped_mosaic_gates_admit():
    """(e) Where igg's compiled gates refuse for the TPU alone, the port
    admits: a band depth off the sublane tile (`B % 8`), a y extension off
    the sublane tile (`admit_sublane_extension`), float64; and its budget
    is the card's shared memory, not VMEM."""
    local = (16, 16, 32)
    ig, g = init_both("torus_mixed", local)
    assert "not on sublane tiles" in idt.diffusion_banded_supported(
        ig, local, 2, 2, np.float32, B=4).reason
    assert dtz.banded_refusal(g, local, 2, 2, torch.float32, B=4) is None
    assert "y-extension E=4 not on sublane tiles" in \
        iht.hm3d_banded_supported(ig, local, 4, 4, np.float32, B=8).reason
    assert htz.hm3d_banded_refusal(g, local, 4, 4, torch.float32, B=8) is None
    assert "float64" in idt.diffusion_banded_supported(
        ig, local, 4, 4, np.float64, B=8, interpret=True).reason
    assert dtz.banded_refusal(g, local, 4, 4, torch.float64, B=8) is None
    # Two staged arrays of (1 + B + 1) rows over a 10 x 34 tile.
    assert _smem.banded_smem(8, (1, 1), itemsize=8) == 2 * 10 * 340 * 8
    assert _smem.chunk_budget() == 232448
    # B = 48 in float64: 50 rows of two arrays, 272,000 bytes.
    igg.finalize_global_grid()
    it.finalize_global_grid()
    it.init_global_grid(96, 16, 16, quiet=True, device="cpu")
    assert "shared-memory budget" in dtz.banded_refusal(
        it.get_global_grid(), (96, 16, 16), 4, 4, torch.float64, B=48)


def test_resolve_band_rules():
    """(e) igg's `resolve_band` cases (tests/test_chunk_engine.py:584-598)."""
    sup = lambda K, B: K == 4 and B == 8
    fit = lambda bands: (4, 8) if 8 in bands else None
    rb = _dispatch.resolve_band
    assert rb(4, 8, False, sup, fit) == (4, 8)
    assert rb(8, 8, False, sup, fit) is None
    assert rb(4, 16, False, sup, fit) is None
    assert rb(8, 8, True, sup, fit) == (4, 8)
    assert rb(None, 16, True, sup, fit) == (4, 8)
    assert rb(None, None, False, sup, fit) == (4, 8)


def test_banded_true_raises():
    """(f) `banded=True` raises a GridError naming "banded" where no
    `(K, B)` is admissible (n_inner=2 holds no chunk; a pinned pair the
    gates refuse) and with `use_kernels=False`, as igg's does
    (tests/test_chunk_engine.py:564-581)."""
    init_both("ring_periodic", (16, 16, 128))
    tp = convert.convert_params(ih.Params(lx=4.0, ly=4.0, lz=4.0), th.Params)
    Pe, phi = th.init_fields(tp)
    with pytest.raises(it.GridError, match="banded"):
        th.make_multi_step(2, tp, banded=True)(Pe, phi)
    with pytest.raises(it.GridError, match="banded"):
        th.make_multi_step(5, tp, banded=True, K=4, band=16)(Pe, phi)
    with pytest.raises(it.GridError, match="banded"):
        th.make_multi_step(5, tp, use_kernels=False, banded=True)
    dpar = convert.convert_params(d3.Params(lx=4.0, ly=4.0, lz=4.0),
                                  t3.Params)
    T, Cp = t3.init_fields(dpar)
    with pytest.raises(it.GridError, match="banded"):
        t3.make_multi_step(2, dpar, banded=True)(T, Cp)
    with pytest.raises(it.GridError, match="banded"):
        t3.make_multi_step(5, dpar, banded=True, K=8, band=8)(T, Cp)
    with pytest.raises(it.GridError, match="banded"):
        t3.make_multi_step(5, dpar, use_kernels=False, banded=True)


@pytest.mark.parametrize("mesh", ["ring_periodic", "one_block_periodic"])
def test_auto_leaves_the_tier_to_resident_routes(mesh, monkeypatch):
    """(f) `banded="auto"` does not take the tier where the K-step loop
    (one block) or the chunk route (the ring) admits."""
    init_both(mesh, (16, 16, 128))
    for module, name in ((dtz, "fused_diffusion_banded_steps"),
                         (htz, "fused_hm3d_banded_steps")):
        monkeypatch.setattr(module, name,
                            lambda *a, **kw: pytest.fail("banded taken"))
    tp = convert.convert_params(ih.Params(lx=4.0, ly=4.0, lz=4.0), th.Params)
    th.make_multi_step(9, tp)(*th.init_fields(tp))
    dpar = convert.convert_params(d3.Params(lx=4.0, ly=4.0, lz=4.0),
                                  t3.Params)
    t3.make_multi_step(9, dpar)(*t3.init_fields(dpar))


def test_auto_takes_the_tier_where_resident_routes_refuse(monkeypatch):
    """(f) On 2x2x2 blocks of 12^3 the diffusion chunk route refuses (its
    y extension needs K % 8 == 0 at K = 4) and the banded tier admits
    K = 2, B = 8: "auto" takes it, and equals the per-step route
    bitwise."""
    local = (12, 12, 12)
    it.init_global_grid(*local, dimx=2, dimy=2, dimz=2, periodx=1,
                        periody=1, periodz=1, quiet=True, device="cpu")
    g = it.get_global_grid()
    assert "K % 8" in dtz.trapezoid_refusal(g, local, 4, 8, torch.float32)
    assert dtz.fit_diffusion_band(g, local, 8, torch.float32) == (2, 8)
    dpar = t3.Params(lx=4.0, ly=4.0, lz=4.0)
    T, Cp = t3.init_fields(dpar)
    calls = spy(monkeypatch, dtz, "fused_diffusion_banded_steps")
    out = t3.make_multi_step(9, dpar)(T, Cp)
    assert calls == [8]
    A = dpar.timestep() * dpar.lam / Cp
    sc = dp.scal(*dpar.spacing())
    ref = T
    for _ in range(9):
        ref = dp.fused_diffusion_step(ref, A, **sc)
    assert torch.equal(out, ref)
    Pe, phi = th.init_fields(th.Params())
    kw = th.Params().step_kwargs()
    calls = spy(monkeypatch, htz, "fused_hm3d_banded_steps")
    out = th.make_multi_step(9, th.Params(), K=4, banded="auto")(Pe, phi)
    assert calls == []    # the HM3D chunk route admits K = 4 here
    ref = (Pe, phi)
    for _ in range(9):
        ref = hp.fused_hm3d_step(*ref, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


# The layouts of the band kernels' checks, as (dims, periods): the chunk
# matrix and one periodic block (tests/test_torch_kernel_sources.py:
# BAND_GRIDS).
BAND_GRIDS = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "ring_open": ((8, 1, 1), (0, 0, 0)),
    "2x2x2_periodic": ((2, 2, 2), (1, 1, 1)),
    "2x2x2_periods010": ((2, 2, 2), (0, 1, 0)),
    "2x2x2_periods101": ((2, 2, 2), (1, 0, 1)),
    "1x2x2_open": ((1, 2, 2), (0, 0, 0)),
    "2x1x1_wrap_y_frozen_z": ((2, 1, 1), (0, 1, 0)),
    "1x1x1_open": ((1, 1, 1), (0, 0, 0)),
    "1x1x1_periodic": ((1, 1, 1), (1, 1, 1)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(BAND_GRIDS))
def test_hm3d_banded_function_does_not_depend_on_B(case, dtype):
    """HM3D's banded realization gives the same whole evolved buffers for
    every band depth B dividing the extended x span (2, 4, half of it, all
    of it): a band reads the previous iteration's values of its block,
    padded only at the block's x ends, so the HM3D band kernel walks x in
    segments of its own choosing."""
    (dims, per), K, local = BAND_GRIDS[case], 2, (16, 10, 12)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz] * 2)
    fields = random_fields(g, FAMILIES["hm3d"][0], 65, dtype)
    exts = ce.extend_fields(fields, ols, K, g, modes)
    span = ce.ext_shape(local, K, modes)[0]
    Bs = [B for B in (2, 4, span // 2, span) if span % B == 0]
    assert len(set(Bs)) == 4

    def banded(B):
        return ce.banded_window_plain(
            list(exts), K=K, B=B, lo=1, modes=modes, grid=g, ols=ols,
            shapes=[local] * 2, E=K, band_update=partial(htz.band_update,
                                                         kw=KW),
            extras=(1, 1), n_up=2, freeze_fields=(0, 1))

    want = banded(Bs[0])
    for B in Bs[1:]:
        for a, b in zip(banded(B), want):
            assert torch.equal(a, b), B


def test_new_modules_import_neither_jax_nor_igg():
    """The banded tier's modules and `chip_smoke.py` import neither JAX
    nor anything of igg."""
    code = ("import sys, chip_smoke, igg_torch.ops._smem, "
            "igg_torch.models._dispatch, igg_torch.ops.chunk_engine, "
            "igg_torch.ops.diffusion_trapezoid, igg_torch.ops.hm3d_trapezoid, "
            "igg_torch.models.diffusion3d, igg_torch.models.hm3d\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'igg' or m.startswith('igg.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
