"""The port's stokes3d family (igg_torch.models.stokes3d) held against igg on
the CPU: the model, the per-iteration route and its dispatch.

The same inputs go through both packages through `igg_torch.convert`.  igg
runs as its own tests run it (tests/test_stokes_pallas.py): its fused
per-iteration kernel in interpret mode under `igg.sharded` on the 8-device
CPU mesh, its XLA composition for float64.  The port runs with
`device="cpu"`, where the kernels' plain versions serve.  Tolerances:
igg's own (the per-iteration route float32 relative 2e-5 of each field's
largest magnitude, igg's `_mesh_compare`; float64 relative 1e-12;
decomposition invariance absolute 1e-12); `init_fields` bitwise for the
pressure and velocities, Rho within relative 1e-6 (float32 `exp` may round
differently in the last ulp); `iteration_core` per block float64 relative
1e-12, float32 2e-5; the port's routes against each other and its plain
path, 0 (the same arithmetic on the same cells).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.models import stokes3d as ist
from igg_torch import convert
from igg_torch.models import stokes3d as tst
from igg_torch.ops import stokes_pallas as sp

NAMES = ("P", "Vx", "Vy", "Vz", "Rho")
OL3 = dict(overlapx=3, overlapy=3, overlapz=3)
PARAMS = ist.Params(lx=4.0, ly=4.0, lz=4.0)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(local, **kw):
    kw = dict(OL3, quiet=True, **kw)
    igg.init_global_grid(*local, **kw)
    it.init_global_grid(*local, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)


def to_port(fields):
    st = convert.to_torch({n: np.asarray(a) for n, a in zip(NAMES, fields)})
    return tuple(st[n] for n in NAMES[:len(fields)])


def close(port, ref, rel):
    for name, a, b in zip(NAMES, port, ref):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
        assert err < rel, (name, err)


def same(a, b):
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


def per_iteration_route(state, Rho, n, tp):
    kw = tst._pseudo_steps(tp)
    for _ in range(n):
        state = sp.fused_stokes_iteration(*state, Rho, **kw)
    return state


MESHES = {
    "222_periodic": dict(periodx=1, periody=1, periodz=1),
    "222_open": {},
    "421_mixed_wrap": dict(dimx=4, dimy=2, dimz=1, periodx=1, periodz=1),
    "811": dict(dimx=8, dimy=1, dimz=1, periody=1, periodz=1),
    "1block_wrap": dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1,
                        periodz=1),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mesh", ["222_periodic", "222_open",
                                  "1block_wrap"])
def test_init_fields_matches_igg(mesh, dtype):
    init_both((16, 8, 8), **MESHES[mesh])
    ref = [np.asarray(a) for a in ist.init_fields(PARAMS, dtype=dtype)]
    tp = convert.convert_params(PARAMS, tst.Params)
    got = [a.numpy() for a in tst.init_fields(tp, dtype=getattr(
        torch, np.dtype(dtype).name))]
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "Rho":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compute_iteration_matches_igg_per_block(dtype):
    """`compute_iteration` on the stacked 2x2x2 grid against igg's
    `compute_iteration` on each block (seeded random fields, so no block
    edge is special)."""
    init_both((9, 7, 8))
    rng = np.random.default_rng(7)
    shapes = sp.field_shapes((9, 7, 8))
    fields = [rng.uniform(-1, 1, it.stacked_shape(s)).astype(dtype)
              for s in shapes]
    kw = dict(dx=0.3, dy=0.4, dz=0.35, mu=1.3, dtP=0.07, dtV=0.011)
    got = tst.compute_iteration(*(torch.from_numpy(a) for a in fields), **kw)
    rel = 1e-12 if dtype == np.float64 else 2e-5
    for b in np.ndindex(2, 2, 2):
        blk = [jnp.asarray(a[tuple(slice(c * t, (c + 1) * t)
                                   for c, t in zip(b, s))])
               for a, s in zip(fields, shapes)]
        want = ist.compute_iteration(*blk, **kw)
        for name, G, W, s in zip(NAMES, got, want, shapes):
            g = G.numpy()[tuple(slice(c * t, (c + 1) * t)
                                for c, t in zip(b, s))].astype(np.float64)
            W = np.asarray(W, np.float64)
            np.testing.assert_allclose(g, W, rtol=0,
                                       atol=rel * np.abs(W).max(),
                                       err_msg=f"{name} block {b}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_iteration_core_matches_igg(dtype):
    """`iteration_core` on one block: the full-shape pressure and the three
    interior increments."""
    rng = np.random.default_rng(3)
    shapes = sp.field_shapes((7, 9, 8))
    fields = [rng.uniform(-1, 1, s).astype(dtype) for s in shapes]
    kw = dict(dx=0.3, dy=0.4, dz=0.35, mu=0.7, dtP=0.05, dtV=0.013)
    got = tst.iteration_core(*(torch.from_numpy(a) for a in fields), **kw)
    want = ist.iteration_core(*(jnp.asarray(a) for a in fields), **kw)
    rel = 1e-12 if dtype == np.float64 else 2e-5
    for name, g, w in zip(("P'", "dVx", "dVy", "dVz"), got, want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy().astype(np.float64), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_per_iteration_route_matches_igg_mosaic(mesh):
    """Three iterations of the per-iteration route (the kernel's plain
    version and the grouped halo update) against igg's fused kernel in
    interpret mode under `igg.sharded` (igg's `_mesh_compare`, local
    16x8x8); the port's dispatch (`make_iteration`) and its plain path give
    the route's results bitwise."""
    init_both((16, 8, 8), **MESHES[mesh])
    fields = ist.init_fields(PARAMS, dtype=np.float32)
    ref = ist.make_iteration(PARAMS, donate=False, use_pallas=True,
                             pallas_interpret=True, n_inner=3,
                             trapezoid=False)(*fields)
    assert igg.degrade.active().get("stokes3d") == "stokes3d.mosaic"
    *state, Rho = to_port(fields)
    tp = convert.convert_params(PARAMS, tst.Params)
    out = per_iteration_route(tuple(state), Rho, 3, tp)
    close(out, ref, 2e-5)
    same(out, tst.make_iteration(tp, n_inner=3, use_kernels=False)(*state,
                                                                    Rho))
    same(out, tst.make_iteration(tp, n_inner=3)(*state, Rho))


@pytest.mark.parametrize("mesh", ["222_periodic", "222_open",
                                  "421_mixed_wrap"])
def test_float64_matches_igg_xla(mesh):
    """float64 (igg gates its kernels to float32, so its XLA composition is
    the reference): four iterations of the port's kernel route within
    relative 1e-12 of igg's `local_iteration` path."""
    init_both((16, 8, 8), **MESHES[mesh])
    fields = ist.init_fields(PARAMS, dtype=np.float64)
    ref = ist.make_iteration(PARAMS, donate=False, use_pallas=False,
                             overlap=False, n_inner=4)(*fields)
    *state, Rho = to_port(fields)
    tp = convert.convert_params(PARAMS, tst.Params)
    close(tst.make_iteration(tp, n_inner=4)(*state, Rho), ref, 1e-12)


def _port_run(n_calls, local, **kw):
    it.init_global_grid(*local, quiet=True, device="cpu", **OL3, **kw)
    tp = convert.convert_params(PARAMS, tst.Params)
    *state, Rho = tst.init_fields(tp, dtype=torch.float64)
    step = tst.make_iteration(tp, n_inner=9)
    for _ in range(n_calls):
        state = step(*state, Rho)
    out = tuple(it.gather_interior(a) for a in state)
    it.finalize_global_grid()
    return out


def test_decomposition_invariance():
    """igg's tests/test_stokes_pallas.py:178-206 on the port, float64: 2x9
    iterations on the open 2x2x2 grid of 16x8x8 blocks (the per-iteration
    route: no chunk depth fits 8 cells with its 3 overlap) and on one
    29x13x13 block (the chunk route, K = 8, every dim frozen) give one
    global answer within 1e-12."""
    multi = _port_run(2, (16, 8, 8), nprocs=8)
    single = _port_run(2, (29, 13, 13), dimx=1, dimy=1, dimz=1)
    for m, s, name in zip(multi, single, NAMES):
        assert m.shape == s.shape, name
        np.testing.assert_allclose(m, s, rtol=0, atol=1e-12, err_msg=name)


def test_local_iteration_under_sharded():
    """`local_iteration` block by block inside `igg_torch.sharded` equals
    it on the stacked arrays."""
    it.init_global_grid(9, 8, 7, quiet=True, device="cpu", nprocs=8, **OL3,
                        periodx=1, periodz=1)
    tp = tst.Params()
    kw = tst._pseudo_steps(tp)
    rng = np.random.default_rng(9)
    state = [torch.from_numpy(rng.uniform(-1, 1, it.stacked_shape(s)))
             for s in sp.field_shapes((9, 8, 7))]
    ref = tst.local_iteration(*[a.clone() for a in state], **kw)
    out = it.sharded(lambda *A: tst.local_iteration(*A, **kw))(*state)
    same(out, ref)


def test_run_relaxes():
    """`run` (slope-timed) on a small periodic grid: finite fields of the
    staggered shapes, the velocities moved, seconds per iteration > 0."""
    it.init_global_grid(10, 10, 10, quiet=True, device="cpu", **OL3,
                        periodx=1, periody=1, periodz=1)
    tp = convert.convert_params(PARAMS, tst.Params)
    state, sec = tst.run(4, tp, dtype=torch.float32, n_inner=3)
    for A, s in zip(state, sp.field_shapes((10, 10, 10))):
        assert tuple(A.shape) == s and bool(torch.isfinite(A).all())
    assert float(state[3].abs().max()) > 0 and sec > 0


def test_kernel_refusals():
    it.init_global_grid(8, 8, 8, quiet=True, device="cpu", **OL3)
    g = it.get_global_grid()
    P, Vx, Vy, Vz, Rho = tst.init_fields(tst.Params())
    assert sp.kernel_refusal(g, P, Vx, Vy, Vz, Rho) is None
    assert "Vy" in sp.kernel_refusal(g, P, Vx, Vx, Vz, Rho)
    assert "Vz" in sp.kernel_refusal(g, P, Vx, Vy, Vy, Rho)
    assert "float32/float64" in sp.kernel_refusal(
        g, *(A.half() for A in (P, Vx, Vy, Vz, Rho)))
    assert "like P" in sp.kernel_refusal(g, P, Vx, Vy.double(), Vz, Rho)
    it.finalize_global_grid()
    it.init_global_grid(8, 8, 8, quiet=True, device="cpu")   # overlap 2
    g = it.get_global_grid()
    assert "overlaps" in sp.kernel_refusal(g, P, Vx, Vy, Vz, Rho)


def test_use_kernels_on_cpu():
    """`True` on the CPU raises; `"auto"` on the CPU takes the plain
    composition where the kernels refuse the grid (overlap 2), and the
    kernels' plain versions where they serve it."""
    it.init_global_grid(8, 8, 8, quiet=True, device="cpu", periodx=1,
                        periody=1, periodz=1)
    tp = tst.Params()
    *state, Rho = tst.init_fields(tp)
    with pytest.raises(it.GridError, match="Stokes kernels"):
        tst.make_iteration(tp, n_inner=2, use_kernels=True)(*state, Rho)
    with pytest.raises(it.GridError, match="use_kernels"):
        tst.make_iteration(tp, n_inner=2, use_kernels="yes")(*state, Rho)
    same(tst.make_iteration(tp, n_inner=2)(*state, Rho),
         tst.make_iteration(tp, n_inner=2, use_kernels=False)(*state, Rho))
    it.finalize_global_grid()
    it.init_global_grid(8, 8, 8, quiet=True, device="cpu", **OL3, periodx=1,
                        periody=1, periodz=1)
    *state, Rho = tst.init_fields(tp)
    with pytest.raises(it.GridError, match="use_kernels=True needs CUDA"):
        tst.make_iteration(tp, n_inner=2, use_kernels=True)(*state, Rho)
    with pytest.raises(it.GridError, match="n_inner"):
        tst.make_iteration(tp, n_inner=0)
