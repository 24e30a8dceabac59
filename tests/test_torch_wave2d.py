"""The port's wave2d family (igg_torch.models.wave2d) held against igg on
the CPU.

The same inputs go through both packages through `igg_torch.convert`.  igg
runs as its own tests run it (tests/test_chunk_engine.py,
tests/test_wave2d.py): its fused per-step kernel and its chunk tier in
interpret mode on the 8-device CPU mesh, its XLA composition for float64.
The port runs with `device="cpu"`, where the kernels' plain versions
serve.  Tolerances: igg's own (per-step float32 relative 1e-5 and chunk
relative 2e-5 of each field's largest magnitude; float64 relative 1e-12,
decomposition invariance absolute 1e-12); `init_fields` float64 relative
1e-15 and float32 2 ulp (exp may round differently); the port's routes
against each other and its plain path, 0 (the same arithmetic on the same
cells).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.models import wave2d as iw
from igg_torch import convert
from igg_torch.models import wave2d as tw
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import wave2d_pallas as wp
from igg_torch.ops import wave2d_trapezoid as wtz

NAMES = ("P", "Vx", "Vy")


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(local, dims, periods):
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=1, periodx=periods[0],
              periody=periods[1], quiet=True)
    igg.init_global_grid(local[0], local[1], 1, **kw)
    it.init_global_grid(local[0], local[1], 1, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)


def to_port(fields):
    st = convert.to_torch({n: np.asarray(a) for n, a in zip(NAMES, fields)})
    return tuple(st[n] for n in NAMES)


def close(port, ref, rel):
    for name, a, b in zip(NAMES, port, ref):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
        assert err < rel, (name, err)


def same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def igg_fields(p, dtype=np.float32, pre_steps=0):
    fields = iw.init_fields(p, dtype=dtype)
    if pre_steps:
        fields = iw.make_step(p, donate=False, n_inner=pre_steps,
                              use_pallas=False)(*fields)
    return fields


def consistent(tp, pre_steps, dtype=torch.float32):
    """An overlap-consistent state (every duplicated cell equal), the entry
    condition under which the chunk route equals the per-step route bit for
    bit: `init_fields` with its halos updated, then `pre_steps` plain
    steps.  `init_fields` alone may not be one: on small periodic grids the
    coordinate wrap rounds the two copies of a cell to different
    coordinates (igg's too; on 16x16, P's last row differs from its alias
    row 1 by 1.2e-11), and `Vx`'s third duplicated x row is never
    re-synchronized by `update_halo`, so the copies stay apart."""
    state = it.update_halo(*tw.init_fields(tp, dtype=dtype))
    return tw.make_multi_step(pre_steps, tp, use_kernels=False)(*state)


def per_step_route(state, n, tp):
    for _ in range(n):
        state = wp.fused_wave2d_step(*state, **tp.step_kwargs())
    return state


def spy_chunks(monkeypatch):
    """Record the steps each call of `fused_wave2d_chunk_steps` advances."""
    calls = []
    real = wtz.fused_wave2d_chunk_steps

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[-1])
        return out

    monkeypatch.setattr(wtz, "fused_wave2d_chunk_steps", spy)
    return calls


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims,periods", [((4, 2), (1, 1)), ((1, 1), (1, 1)),
                                          ((4, 2), (0, 0))],
                         ids=["4x2_periodic", "1x1_periodic", "4x2_open"])
def test_init_fields_matches_igg(dims, periods, dtype):
    init_both((8, 6), dims, periods)
    ref = [np.asarray(a) for a in iw.init_fields(iw.Params(), dtype=dtype)]
    tp = convert.convert_params(iw.Params(), tw.Params)
    got = [a.numpy() for a in tw.init_fields(tp, dtype=getattr(
        torch, np.dtype(dtype).name))]
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=1e-15, atol=0, err_msg=name)
        else:
            ulp = np.spacing(np.abs(b).astype(np.float32))
            assert np.all(np.abs(a - b) <= 2 * ulp), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compute_step_matches_igg_per_block(dtype):
    """`compute_step` on the stacked 4x2 grid against igg's on each block
    (seeded random fields, so no block edge is special)."""
    init_both((8, 6), (4, 2), (1, 1))
    rng = np.random.default_rng(7)
    shapes = wp.field_shapes((8, 6))
    fields = [rng.uniform(-1, 1, it.stacked_shape(s)).astype(dtype)
              for s in shapes]
    kw = dict(dx=0.3, dy=0.4, dt=0.05, rho=1.3, K=0.7)
    got = tw.compute_step(*(torch.from_numpy(a) for a in fields), **kw)
    for name, f, G, s in zip(NAMES, range(3), got, shapes):
        for b0 in range(4):
            for b1 in range(2):
                blk = [jnp.asarray(a[b0 * t[0]:(b0 + 1) * t[0],
                                     b1 * t[1]:(b1 + 1) * t[1]])
                       for a, t in zip(fields, shapes)]
                want = np.asarray(iw.compute_step(*blk, **kw)[f], np.float64)
                g = G.numpy()[b0 * s[0]:(b0 + 1) * s[0],
                              b1 * s[1]:(b1 + 1) * s[1]].astype(np.float64)
                tol = (1e-12 if dtype == np.float64 else 1e-5) * np.abs(
                    want).max()
                np.testing.assert_allclose(g, want, rtol=0, atol=tol,
                                           err_msg=f"{name} block {b0},{b1}")


@pytest.mark.parametrize("periods", [(1, 1), (0, 0)], ids=["periodic", "open"])
def test_kernel_route_matches_igg_mosaic(periods):
    """Five steps with the kernels (their plain versions here) against igg's
    fused per-step kernel on the (4,2,1) mesh at 8x8 per block; the port's
    per-step route and its dispatch (the chunk route where it admits the
    grid) equal its plain path bitwise."""
    init_both((8, 8), (4, 2), periods)
    p = iw.Params()
    fields = igg_fields(p)
    ref = iw.make_step(p, donate=False, n_inner=5, use_pallas=True,
                       pallas_interpret=True, chunk=False)(*fields)
    assert igg.degrade.active().get("wave2d") == "wave2d.mosaic"
    state = to_port(fields)
    tp = convert.convert_params(p, tw.Params)
    out = per_step_route(state, 5, tp)
    close(out, ref, 1e-5)
    same(out, tw.make_multi_step(5, tp, use_kernels=False)(*state))
    state = consistent(tp, 1)
    plain = tw.make_multi_step(5, tp, use_kernels=False)(*state)
    same(per_step_route(state, 5, tp), plain)
    same(tw.make_multi_step(5, tp)(*state), plain)


@pytest.mark.parametrize("mesh", [(4, 2), (1, 1)], ids=["mesh42", "selfwrap"])
def test_chunk_route_matches_igg_chunk(mesh, monkeypatch):
    """One warm-up step and one K=4 chunk on periodic grids at 16x16 per
    block, from 3 plain pre-steps: against igg's chunk tier, and, from an
    overlap-consistent state, bitwise against the port's per-step route and
    plain path."""
    init_both((16, 16), mesh, (1, 1))
    p = iw.Params()
    fields = igg_fields(p, pre_steps=3)
    ref = iw.make_step(p, donate=False, n_inner=5, use_pallas=True,
                       pallas_interpret=True, chunk=True, K=4)(*fields)
    assert igg.degrade.active().get("wave2d") == "wave2d.chunk"
    state = to_port(fields)
    tp = convert.convert_params(p, tw.Params)
    calls = spy_chunks(monkeypatch)
    out = tw.make_multi_step(5, tp, K=4)(*state)
    assert calls == [4]
    close(out, ref, 2e-5)
    state = consistent(tp, 3)
    out = tw.make_multi_step(5, tp, K=4)(*state)
    assert calls == [4, 4]
    same(out, per_step_route(state, 5, tp))
    same(out, tw.make_multi_step(5, tp, use_kernels=False)(*state))


@pytest.mark.parametrize("dims,n_inner,chunks", [
    ((2, 2), 11, [8]),       # y extended too; remainder 2 per step
    ((2, 1), 9, [8]),        # x extended, y wrap
])
def test_chunk_route_f64_matches_igg_xla(dims, n_inner, chunks, monkeypatch):
    """float64 (igg gates its kernels to float32, so its XLA path is the
    reference), from an overlap-consistent state: the port's chunk route
    at the fitted K within relative 1e-12 of igg, and bitwise against its
    per-step route."""
    import jax

    init_both((24, 20), dims, (1, 1))
    p = iw.Params()
    tp = convert.convert_params(p, tw.Params)
    state = consistent(tp, 2, torch.float64)
    ref = iw.make_step(p, donate=False, n_inner=n_inner, use_pallas=False)(
        *(jax.device_put(a.numpy(), igg.sharding_for(2)) for a in state))
    calls = spy_chunks(monkeypatch)
    out = tw.make_multi_step(n_inner, tp)(*state)
    assert calls == chunks
    close(out, ref, 1e-12)
    same(out, per_step_route(state, n_inner, tp))


@pytest.mark.parametrize("mesh", [(4, 2), (1, 1), (2, 1)],
                         ids=["mesh42", "selfwrap", "2x1"])
def test_extend_fields_staggered_matches_igg_bitwise(mesh):
    """The chunk's E = 2K extension of the three staggered 2-D fields
    (per-field overlaps, P and Vx grouped in x) against igg's
    `chunk_engine.extend_fields` under `igg.sharded`, bitwise."""
    import jax
    from igg.ops import chunk_engine as ice
    from jax.sharding import PartitionSpec

    init_both((16, 16), mesh, (1, 1))
    g, tg = igg.get_global_grid(), it.get_global_grid()
    modes, E = ce.dim_modes(tg)[:2], 8
    assert modes == ice.dim_modes(g)[:2]
    shapes = wp.field_shapes((16, 16))
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(it.stacked_shape(s)) for s in shapes]
    ref = igg.sharded(lambda *A: tuple(ice.extend_fields(
        list(A), ice.field_ols(g, [a.shape for a in A]), E, g, modes)),
        out_specs=(PartitionSpec(*igg.AXIS_NAMES[:2]),) * 3,
        check_vma=False)(*(jax.device_put(a, igg.sharding_for(2))
                           for a in arrs))
    out = ce.extend_fields([torch.from_numpy(a) for a in arrs],
                           ce.field_ols(tg, shapes), E, tg, modes)
    for name, o, r in zip(NAMES, out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)


def _port_run(nt, nx, ny, **kw):
    it.init_global_grid(nx, ny, 1, periodx=1, periody=1, quiet=True,
                        device="cpu", **kw)
    tp = tw.Params()
    state = tw.init_fields(tp, dtype=torch.float64)
    state = tw.make_multi_step(nt, tp)(*state)
    out = tuple(it.gather_interior(a) for a in state)
    it.finalize_global_grid()
    return out


def test_decomposition_invariance():
    """igg's tests/test_wave2d.py:20-26 on the port: 20 steps on a 4x2
    grid of 6x6 blocks (the per-step route: no chunk depth fits 6 cells)
    and on one 18x10 block (the chunk route, K=4) give one global
    answer."""
    multi = _port_run(20, 6, 6, dimx=4, dimy=2, dimz=1, nprocs=8)
    single = _port_run(20, 18, 10, dimx=1, dimy=1, dimz=1)
    for m, s, name in zip(multi, single, NAMES):
        assert m.shape == s.shape, name
        np.testing.assert_allclose(m, s, atol=1e-12, err_msg=name)


def test_energy_stays_bounded():
    """igg's bounded `wave_energy` invariant (tolerance 25%) over 50 steps
    of the kernel route on a periodic 4x2 grid."""
    it.init_global_grid(10, 10, 1, dimx=4, dimy=2, dimz=1, periodx=1,
                        periody=1, quiet=True, device="cpu", nprocs=8)
    tp = tw.Params()
    state = tw.init_fields(tp, dtype=torch.float64)
    e0 = tw.energy(*state)
    state = tw.make_multi_step(50, tp)(*state)
    assert abs(tw.energy(*state) - e0) <= 0.25 * e0


def test_open_mesh_takes_per_step_route(monkeypatch):
    """An open grid: the chunk refuses it with the periodic-only reason and
    the per-step route serves, with its own results."""
    init_both((16, 16), (4, 2), (0, 0))
    g = it.get_global_grid()
    assert "periodic" in wtz.wave2d_chunk_refusal(g, (16, 16), 4, 8,
                                                  torch.float32)
    monkeypatch.setattr(wtz, "fused_wave2d_chunk_steps",
                        lambda *a, **kw: pytest.fail("chunk route taken"))
    tp = tw.Params()
    state = tw.init_fields(tp)
    same(tw.make_multi_step(9, tp)(*state), per_step_route(state, 9, tp))


def test_chunk_admission_matrix():
    """igg's tests/test_chunk_engine.py:279-292 on the port's gate, without
    its float32-only row (the port's kernels take float64)."""
    init_both((16, 16), (1, 1), (1, 1))
    g = it.get_global_grid()
    s, f32 = (16, 16), torch.float32
    assert wtz.wave2d_chunk_refusal(g, s, 4, 4, f32) is None
    assert "no full K=4 chunk" in wtz.wave2d_chunk_refusal(g, s, 4, 3, f32)
    assert "no full K=1 chunk" in wtz.wave2d_chunk_refusal(g, s, 1, 8, f32)
    assert "shared region" in wtz.wave2d_chunk_refusal(g, s, 8, 8, f32)
    assert wtz.wave2d_chunk_refusal(g, s, 4, 4, torch.float64) is None
    assert wtz.fit_wave2d_K(g, s, 8, f32) == 4
    assert wtz.fit_wave2d_K(g, s, 8, f32, K=8) == 0


def test_use_kernels_true_on_cpu_raises():
    it.init_global_grid(8, 8, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    tp = tw.Params()
    state = tw.init_fields(tp)
    with pytest.raises(it.GridError, match="wave2d kernels"):
        tw.make_multi_step(3, tp, use_kernels=True)(*state)
    with pytest.raises(it.GridError, match="use_kernels"):
        tw.make_multi_step(3, tp, use_kernels="yes")(*state)


def test_kernel_refusals():
    it.init_global_grid(8, 8, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    g = it.get_global_grid()
    P, Vx, Vy = tw.init_fields(tw.Params())
    assert wp.kernel_refusal(g, P, Vx, Vy) is None
    assert "Vy" in wp.kernel_refusal(g, P, Vx, Vx)
    assert "float32/float64" in wp.kernel_refusal(
        g, P.half(), Vx.half(), Vy.half())
    assert "like P" in wp.kernel_refusal(g, P, Vx.double(), Vy)
    it.finalize_global_grid()
    it.init_global_grid(8, 8, 8, quiet=True, device="cpu")
    g = it.get_global_grid()
    assert "rank" in wp.kernel_refusal(g, it.zeros((8, 8, 8)), Vx, Vy)
