"""The port's Stokes K-iteration chunk route held against igg on the CPU.

igg's side runs as tests/test_stokes_trapezoid.py runs it: its chunk tier
`fused_stokes_trapezoid_iters` with `interpret=True` under `igg.sharded`
(the pure-XLA window realization) from igg's `_fresh_fields` state (the
buoyancy init evolved by three XLA iterations, overlap-consistent), at
igg's local 16x16x128 (its Mosaic `z % 128` gate), on igg's matrix of
meshes; and its model path (`make_iteration` with `trapezoid=True`: a
warm-up iteration, the chunks, the remainder), igg's `_model_compare`.
The port runs with `device="cpu"`, where the chunk kernel's plain version
serves.  Tolerances: igg's own (the chunk tier float32 relative 2e-5;
the model path 2e-4; float64 relative 1e-12 against igg's XLA path),
relative to the pressure's largest magnitude for P and to the largest
velocity magnitude for the velocities: the inclusion sits in the middle of
the box, so Vx and Vy are zero by symmetry, and what they hold on igg's
state (1e-8 against Vz's 2e-4) is float32 rounding noise, which XLA and
PyTorch round differently (against a float64 run of the same iterations,
igg's and the port's float32 Vx differ by 8.4e-5 of Vx's own largest
magnitude, alike).  Against the port's per-iteration route and plain
path, 0 (the same arithmetic on the same cells, from an overlap-consistent
state).
"""

import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.models import stokes3d as ist
from igg_torch import convert
from igg_torch.models import stokes3d as tst
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import stokes_pallas as sp
from igg_torch.ops import stokes_trapezoid as stz
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("P", "Vx", "Vy", "Vz", "Rho")
OL3 = dict(overlapx=3, overlapy=3, overlapz=3)
PARAMS = ist.Params(lx=4.0, ly=4.0, lz=4.0)
LOCAL = (16, 16, 128)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(mesh, periods, local=LOCAL):
    kw = dict(dimx=mesh[0], dimy=mesh[1], dimz=mesh[2], periodx=periods[0],
              periody=periods[1], periodz=periods[2], quiet=True, **OL3)
    igg.init_global_grid(*local, **kw)
    it.init_global_grid(*local, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)
    return it.get_global_grid()


def fresh_fields(dtype=np.float32):
    """igg's `_fresh_fields`: the buoyancy init evolved by three iterations
    of igg's XLA path (overlap-consistent, exchange-fresh)."""
    P, Vx, Vy, Vz, Rho = ist.init_fields(PARAMS, dtype=dtype)
    step = ist.make_iteration(PARAMS, donate=False, use_pallas=False,
                              n_inner=3)
    return (*step(P, Vx, Vy, Vz, Rho), Rho)


def to_port(fields):
    st = convert.to_torch({n: np.asarray(a) for n, a in zip(NAMES, fields)})
    return tuple(st[n] for n in NAMES)


def close(port, ref, rel):
    """Each field within `rel` of its scale: the pressure's largest
    magnitude for P, the largest velocity magnitude for the velocities."""
    ref = [np.asarray(b, np.float64) for b in ref[:4]]
    scale = [np.abs(ref[0]).max()] + [max(np.abs(b).max()
                                          for b in ref[1:])] * 3
    for name, a, b, s in zip(NAMES, port, ref, scale):
        a = a.numpy().astype(np.float64)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / (s + 1e-30)
        assert err < rel, (name, err)


def same(a, b):
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


def per_iteration_route(state, Rho, n, tp):
    kw = tst._pseudo_steps(tp)
    for _ in range(n):
        state = sp.fused_stokes_iteration(*state, Rho, **kw)
    return tuple(state)


def consistent(tp, pre, dtype=torch.float32):
    """An overlap-consistent state of the port: `init_fields` with the
    halos of all five fields updated (on periodic grids the coordinate
    wrap may round a cell's two copies apart in the last ulp), then `pre`
    iterations of the plain path."""
    *state, Rho = it.update_halo(*tst.init_fields(tp, dtype=dtype))
    state = tst.make_iteration(tp, n_inner=pre, use_kernels=False)(*state,
                                                                   Rho)
    return state, Rho


def spy_chunks(monkeypatch):
    """Record the iterations each call of `fused_stokes_trapezoid_iters`
    advances."""
    calls = []
    real = stz.fused_stokes_trapezoid_iters

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[-1])
        return out

    monkeypatch.setattr(stz, "fused_stokes_trapezoid_iters", spy)
    return calls


# igg's matrix (tests/test_stokes_trapezoid.py:92-150): (mesh, periods,
# chunks of K = 4, the window modes).
MATRIX = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1), 1, ("ext", "wrap", "wrap")),
    "ring_open": ((8, 1, 1), (0, 0, 0), 1, ("oext", "frozen", "frozen")),
    "torus_periodic": ((2, 2, 2), (1, 1, 1), 1, ("ext", "ext", "ext")),
    "torus_open": ((2, 2, 2), (0, 0, 0), 1, ("oext", "oext", "oext")),
    "mixed_open_xz": ((2, 2, 2), (0, 1, 0), 1, ("oext", "ext", "oext")),
    "mesh_421": ((4, 2, 1), (1, 0, 1), 1, ("ext", "oext", "wrap")),
    "selfwrap_two_chunks": ((1, 1, 1), (1, 1, 1), 2, ("ext", "wrap", "wrap")),
    "single_frozen": ((1, 1, 1), (0, 0, 0), 1,
                      ("frozen", "frozen", "frozen")),
}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_chunk_matches_igg_chunk_tier(case):
    """`fused_stokes_trapezoid_iters` (K = 4) against igg's chunk tier in
    interpret mode on the same state, within 2e-5; the port's chunk is its
    per-iteration route's results bitwise."""
    from igg.ops.stokes_trapezoid import fused_stokes_trapezoid_iters

    mesh, periods, n_chunks, modes = MATRIX[case]
    K, g = 4, init_both(mesh, periods)
    assert ce.dim_modes(g) == modes
    n = K * n_chunks
    assert stz.stokes_chunk_refusal(g, LOCAL, K, n, torch.float32) is None
    kw = ist._pseudo_steps(PARAMS)
    fields = fresh_fields()

    @igg.sharded
    def chunk(P, Vx, Vy, Vz, Rho):
        return fused_stokes_trapezoid_iters(P, Vx, Vy, Vz, Rho, n_inner=n,
                                            K=K, **kw, interpret=True)[:4]

    ref = chunk(*fields)
    *state, Rho = to_port(fields)
    *out, done = stz.fused_stokes_trapezoid_iters(*state, Rho, n_inner=n,
                                                  K=K, **kw)
    assert done == n
    close(out, ref, 2e-5)
    tp = convert.convert_params(PARAMS, tst.Params)
    same(out, per_iteration_route(tuple(state), Rho, n, tp))


# igg's `_model_compare` cases: (mesh, periods, n_inner, K).
MODEL = {
    "ring_periodic_n5": ((8, 1, 1), (1, 1, 1), 5, 4),
    "ring_open_remainder_n7": ((8, 1, 1), (0, 0, 0), 7, 4),
}


@pytest.mark.parametrize("case", sorted(MODEL))
def test_model_path_matches_igg(case, monkeypatch):
    """`make_iteration(n_inner, K=K)` takes the chunk route (a warm-up
    iteration, `(n_inner-1)//K` chunks, the remainder per iteration),
    matches igg's model path with `trapezoid=True` within 2e-4, and equals
    the port's per-iteration route and plain path bitwise."""
    mesh, periods, n_inner, K = MODEL[case]
    init_both(mesh, periods)
    fields = fresh_fields()
    ref = ist.make_iteration(PARAMS, donate=False, use_pallas=True,
                             pallas_interpret=True, n_inner=n_inner,
                             trapezoid=True, K=K)(*fields)
    assert igg.degrade.active().get("stokes3d") == "stokes3d.trapezoid"
    *state, Rho = to_port(fields)
    tp = convert.convert_params(PARAMS, tst.Params)
    calls = spy_chunks(monkeypatch)
    out = tst.make_iteration(tp, n_inner=n_inner, K=K)(*state, Rho)
    assert calls == [(n_inner - 1) // K * K]
    close(out, ref, 2e-4)
    same(out, per_iteration_route(tuple(state), Rho, n_inner, tp))
    same(out, tst.make_iteration(tp, n_inner=n_inner,
                                 use_kernels=False)(*state, Rho))


@pytest.mark.parametrize("mesh,periods,n_inner,chunks", [
    ((2, 2, 2), (1, 1, 1), 11, [8]),      # x, y, z extended; remainder 2
    ((4, 2, 1), (0, 1, 1), 7, [4]),       # oext x, ext y, z wrap
    ((1, 1, 1), (0, 1, 0), 9, [8]),       # frozen x/z, y wrap
], ids=["222_periodic", "421_mixed", "1block_mixed"])
def test_chunk_route_f64_matches_igg_xla(mesh, periods, n_inner, chunks,
                                         monkeypatch):
    """float64 (igg gates its chunk tier to float32, so its XLA path is the
    reference), at 24x24x20 per block: the port's chunk route at the fitted
    K within relative 1e-12 of igg, and bitwise against its per-iteration
    route."""
    init_both(mesh, periods, local=(24, 24, 20))
    fields = ist.init_fields(PARAMS, dtype=np.float64)
    ref = ist.make_iteration(PARAMS, donate=False, use_pallas=False,
                             overlap=False, n_inner=n_inner)(*fields)
    tp = convert.convert_params(PARAMS, tst.Params)
    *state, Rho = to_port(fields)
    calls = spy_chunks(monkeypatch)
    out = tst.make_iteration(tp, n_inner=n_inner)(*state, Rho)
    assert calls == chunks
    close(out, ref, 1e-12)
    state, Rho = consistent(tp, 1, torch.float64)
    same(tst.make_iteration(tp, n_inner=n_inner)(*state, Rho),
         per_iteration_route(state, Rho, n_inner, tp))


@pytest.mark.parametrize("mesh", [(2, 2, 2), (8, 1, 1)])
def test_extend_fields_staggered_matches_igg_bitwise(mesh):
    """The chunk's E = 2K extension of the four staggered fields and of Rho
    (per-field overlaps 4 along the staggered dim) against igg's
    `chunk_engine.extend_fields` under `igg.sharded`, bitwise."""
    import jax
    from igg.ops import chunk_engine as ice
    from jax.sharding import PartitionSpec

    init_both(mesh, (1, 0, 1), local=(16, 16, 16))
    g, tg = igg.get_global_grid(), it.get_global_grid()
    modes, E = ce.dim_modes(tg), 8
    assert modes == ice.dim_modes(g)
    shapes = sp.field_shapes((16, 16, 16))
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(it.stacked_shape(s)) for s in shapes]
    ref = igg.sharded(lambda *A: tuple(ice.extend_fields(
        list(A), ice.field_ols(g, [a.shape for a in A]), E, g, modes)),
        out_specs=(PartitionSpec(*igg.AXIS_NAMES),) * 5,
        check_vma=False)(*(jax.device_put(a, igg.sharding_for(3))
                           for a in arrs))
    out = ce.extend_fields([torch.from_numpy(a) for a in arrs],
                           ce.field_ols(tg, shapes), E, tg, modes)
    for name, o, r in zip(NAMES, out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)


def test_refused_shape_takes_per_iteration_route(monkeypatch):
    """16x8x16 blocks on a 2x2x2 grid: a K = 2 chunk's 4-deep y slabs
    would enter the sender's shared region (8 - 2*3 = 2 rows), so the
    per-iteration route serves, with its own results."""
    g = init_both((2, 2, 2), (1, 1, 1), local=(16, 8, 16))
    assert "dim-1 send slabs enter the sender's shared region" in \
        stz.stokes_chunk_refusal(g, (16, 8, 16), 2, 8, torch.float32)
    assert stz.fit_stokes_K(g, (16, 8, 16), 8, torch.float32) == 0
    monkeypatch.setattr(stz, "fused_stokes_trapezoid_iters",
                        lambda *a, **kw: pytest.fail("chunk route taken"))
    tp = convert.convert_params(PARAMS, tst.Params)
    *state, Rho = tst.init_fields(tp)
    same(tst.make_iteration(tp, n_inner=9)(*state, Rho),
         per_iteration_route(tuple(state), Rho, 9, tp))


def test_chunk_admission_matrix():
    """igg's `test_gate_rejects` on the port's gate, without its float32-only
    row (the port's kernels take float64)."""
    g = init_both((8, 1, 1), (1, 1, 1))
    f32 = torch.float32
    refusal = stz.stokes_chunk_refusal
    assert refusal(g, LOCAL, 4, 4, f32) is None
    assert "no full K=4 chunk" in refusal(g, LOCAL, 4, 3, f32)
    assert "no full K=1 chunk" in refusal(g, LOCAL, 1, 8, f32)
    assert "shared region" in refusal(g, LOCAL, 8, 8, f32)
    assert refusal(g, LOCAL, 4, 4, torch.float64) is None
    assert "float32/float64" in refusal(g, LOCAL, 4, 4, torch.float16)
    assert stz.fit_stokes_K(g, LOCAL, 8, f32) == 4
    assert stz.fit_stokes_K(g, LOCAL, 8, f32, K=8) == 0
    it.finalize_global_grid()
    it.init_global_grid(*LOCAL, dimx=8, dimy=1, dimz=1, periodx=1, periody=1,
                        periodz=1, quiet=True, device="cpu", nprocs=8)
    assert "overlaps" in refusal(it.get_global_grid(), LOCAL, 4, 4, f32)
