"""The port's HM3D family held against igg on the CPU.

The same inputs (made with numpy from a seed, or igg's `init_fields`,
moved as numpy arrays) go through igg and through igg_torch with
`device="cpu"`, where the port's kernel route runs each kernel's plain
version.  igg's side is its XLA path, or its interpret-mode fused Pallas
step where its own tests pin the kernel to it.  Tolerances, igg's own
(`tests/test_chunk_engine.py:60-82`): float64 relative 1e-12 and float32
relative 2e-5 of the field's largest magnitude (the two packages round
`exp` and the flux sums in different places); the grouped exchange is a
copy, held bitwise.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import igg
import igg_torch as it
from igg.halo import exchange_all_dims_grouped as igg_grouped
from igg.models import hm3d as ih
from igg_torch import convert, halo
from igg_torch.models import hm3d as th
from igg_torch.ops import hm3d_pallas as hp
from igg_torch.ops import hm3d_trapezoid as htz
from torch_threads import one_torch_thread  # noqa: F401

REL = {np.float64: 1e-12, np.float32: 2e-5}
PERIODIC = dict(periodx=1, periody=1, periodz=1)
SINGLE = dict(dimx=1, dimy=1, dimz=1)
PARAMS = ih.Params(lx=4.0, ly=4.0, lz=60.0)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(n, kw):
    igg.init_global_grid(*n, quiet=True, **kw)
    it.init_global_grid(*n, quiet=True, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)
    return igg.get_global_grid(), it.get_global_grid()


def port_state(Pe, phi):
    st = convert.to_torch({"Pe": np.asarray(Pe), "phi": np.asarray(phi)})
    return st["Pe"], st["phi"]


def close(port, ref, dtype=np.float32):
    """Each field within igg's relative tolerance of its largest value."""
    for name, a, b in zip(("Pe", "phi"), port, ref):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
        assert rel < REL[dtype], (name, rel)


def same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def random_state(shape, dtype, seed):
    """Pe and phi in the ranges of the HM3D state, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.0, shape).astype(dtype),
            rng.uniform(0.08, 0.25, shape).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_step_core_and_compute_step_match_igg(dtype):
    """`step_core` and `compute_step` of one block on the same random state."""
    n = (10, 12, 14)
    init_both(n, SINGLE)
    Pe, phi = random_state(n, dtype, 1)
    kw = dict(dx=0.11, dy=0.13, dz=0.07, dt=2e-4, phi0=0.1, npow=3, eta=1.3)
    Pt, ft = torch.from_numpy(Pe), torch.from_numpy(phi)
    close(th.step_core(Pt, ft, **kw), ih.step_core(Pe, phi, **kw), dtype)
    close(th.compute_step(Pt, ft, **kw), ih.compute_step(Pe, phi, **kw), dtype)


@pytest.mark.parametrize("npow", [0, 1, 2, 5])
def test_int_pow_is_repeated_multiplication(npow):
    x = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 2.0, 100))
    want = torch.ones_like(x) if npow == 0 else x.clone()
    for _ in range(npow - 1):
        want = want * x
    torch.testing.assert_close(th.int_pow(x, npow), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("kw", [dict(SINGLE, **PERIODIC), {},
                                dict(dimx=4, dimy=2, dimz=1, periodz=1)],
                         ids=["periodic_1block", "open_8blocks",
                              "mixed_4x2x1"])
def test_init_fields_match_igg(kw):
    init_both((8, 8, 16), kw)
    ref = ih.init_fields(PARAMS, dtype=np.float32)
    tp = convert.convert_params(PARAMS, th.Params)
    close(th.init_fields(tp), ref)
    assert tp.timestep() == PARAMS.timestep()


MESHES = {
    "periodic_2x2x2": PERIODIC,
    "open_2x2x2": {},
    "4x2x1": dict(dimx=4, dimy=2, dimz=1, periodz=1, periodx=1),
    "8x1x1": dict(dimx=8, dimy=1, dimz=1, periody=1, periodz=1),
    "1x8x1": dict(dimx=1, dimy=8, dimz=1, **PERIODIC),
}


@pytest.mark.parametrize("case", sorted(MESHES))
def test_multiblock_steps_match_igg_fused_step(case):
    """Three steps on the 8-block meshes of tests/test_hm3d_pallas.py at
    8x8x128 per block: the port's per-step kernel route (the plain versions
    of the fused step, recomputed send planes, grouped exchange) against
    igg's interpret-mode fused step, and bitwise against the port's plain
    composition."""
    init_both((8, 8, 128), MESHES[case])
    Pe, phi = ih.init_fields(PARAMS, dtype=np.float32)
    ref = ih.make_step(PARAMS, donate=False, use_pallas=True,
                       pallas_interpret=True, n_inner=3)(Pe, phi)
    tp = convert.convert_params(PARAMS, th.Params)
    state = port_state(Pe, phi)
    fused = th.make_multi_step(3, tp, use_kernels="auto")(*state)
    close(fused, ref)
    same(fused, th.make_multi_step(3, tp, use_kernels=False)(*state))


ONE_BLOCK = {
    "wrap": dict(SINGLE, **PERIODIC),
    "frozen": SINGLE,
    "wrap_y_frozen_xz": dict(SINGLE, periody=1),
    "wrap_xz_frozen_y": dict(SINGLE, periodx=1, periodz=1),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(ONE_BLOCK))
def test_kstep_loop_matches_igg(case, dtype):
    """n_inner = 4 on one block: the port's K-step loop route against igg's
    XLA path (igg's K-step kernel has no interpret mode; tests/
    test_mega_tpu.py pins it to the per-step kernel), and bitwise against
    the port's plain loop and per-step route."""
    local = (8, 16, 16)
    init_both(local, ONE_BLOCK[case])
    Pe, phi = (igg.from_local_blocks(lambda c, ls, F=F: F, local, dtype=dtype)
               for F in random_state(local, dtype, 3))
    ref = ih.make_step(PARAMS, donate=False, use_pallas=False,
                       n_inner=4)(Pe, phi)
    tp = convert.convert_params(PARAMS, th.Params)
    state = port_state(Pe, phi)
    kstep = th.make_multi_step(4, tp, use_kernels="auto")(*state)
    close(kstep, ref, dtype)
    same(kstep, th.make_multi_step(4, tp, use_kernels=False)(*state))
    per_step = state
    for _ in range(4):
        per_step = hp.fused_hm3d_step(*per_step, **tp.step_kwargs())
    same(kstep, per_step)


GROUPED = {
    "periodic_2x2x2": PERIODIC,
    "open_2x2x2": {},
    "4x2x1_periodz": dict(dimx=4, dimy=2, dimz=1, periodz=1),
    "8x1x1_wrap_yz": dict(dimx=8, dimy=1, dimz=1, periody=1, periodz=1),
    "1x2x4_periodx": dict(dimx=1, dimy=2, dimz=4, periodx=1),
}


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_grouped_exchange_matches_igg_bitwise(case):
    """Both fields' send and stale planes through one grouped exchange:
    every received plane equals igg's `exchange_all_dims_grouped` under
    `igg.sharded` (its per-block keepdims planes, stacked over the
    blocks)."""
    local = (6, 7, 8)
    g, tg = init_both(local, GROUPED[case])
    rng = np.random.default_rng(4)
    A = igg.from_local_blocks(lambda c, ls: rng.standard_normal(ls), local,
                              dtype=np.float64)
    B = igg.from_local_blocks(lambda c, ls: rng.standard_normal(ls), local,
                              dtype=np.float64)
    dims = halo.moving_dims(halo.active_dims(local, tg), tg)
    wraps = halo.wrap_dims(dims, tg)
    keys = [(f, d, side) for f in range(2) for d, _ in dims if d not in wraps
            for side in (0, 1)]

    def igg_side(A, B):
        sends = []
        for F in (A, B):
            sends.append({(d, side): F[tuple(slice(p, p + 1) if k == d
                                             else slice(None)
                                             for k in range(3))]
                          for d, ol in dims if d not in wraps
                          for side, p in ((0, ol - 1), (1, local[d] - ol))})
        recvs = igg_grouped([local] * 2, sends, [dims] * 2, g,
                            wraps=[wraps] * 2, blocks=[A, B])
        return tuple(recvs[f][d][side] for f, d, side in keys)

    ref = igg.sharded(igg_side, out_specs=P(*igg.AXIS_NAMES),
                      check_vma=False)(A, B)
    At, Bt = (convert.to_torch({"F": np.asarray(F)})["F"] for F in (A, B))
    planes = [halo.send_planes(F, dims, tg, wraps) for F in (At, Bt)]
    recvs = halo.exchange_all_dims_grouped(
        [p[0] for p in planes], [dims] * 2, tg, [local] * 2,
        [p[1] for p in planes], [wraps] * 2)
    assert len(keys) == len(ref) > 0
    for (f, d, side), want in zip(keys, ref):
        np.testing.assert_array_equal(recvs[f][d][side].numpy(),
                                      np.asarray(want), err_msg=str((f, d)))


@pytest.mark.parametrize("kw", [PERIODIC, {}], ids=["periodic", "open"])
def test_sharded_local_step_matches_igg(kw):
    """`local_step` written for one block, run on every block by `sharded`,
    against igg's `local_step` under `igg.sharded`, and bitwise against the
    port's plain composition."""
    init_both((8, 8, 16), kw)
    Pe, phi = ih.init_fields(PARAMS, dtype=np.float32)
    tp = convert.convert_params(PARAMS, th.Params)
    step = tp.step_kwargs()
    ref = igg.sharded(lambda Pe, phi: ih.local_step(Pe, phi, **step),
                      check_vma=False)(Pe, phi)
    state = port_state(Pe, phi)
    out = it.sharded(lambda Pe, phi: th.local_step(Pe, phi, **step))(*state)
    close(out, ref)
    same(out, th.make_step(tp, use_kernels=False)(*state))


def test_run_end_to_end_matches_igg():
    """`run()`: init, slope-timed calls of n_inner=2 steps; the same number
    of steps runs in both packages."""
    init_both((8, 8, 16), PERIODIC)
    ref, _ = ih.run(8, PARAMS, dtype=np.float32, n_inner=2, use_pallas=False)
    tp = convert.convert_params(PARAMS, th.Params)
    out, sec = th.run(8, tp, dtype=torch.float32, n_inner=2)
    assert sec > 0
    close(out, ref)


@pytest.mark.parametrize("n_inner,uk", [(1, "auto"), (3, "auto"), (3, False)])
def test_periodic_halo_aliases_inner_plane_bitwise(n_inner, uk):
    """On one periodic block every halo plane of both fields equals the
    inner plane it aliases, on the kernel route and the plain path."""
    it.init_global_grid(8, 8, 16, quiet=True, device="cpu", **SINGLE,
                        **PERIODIC)
    tp = th.Params()
    for F in th.make_multi_step(n_inner, tp, use_kernels=uk)(
            *th.init_fields(tp)):
        for d in range(3):
            S = F.shape[d]
            assert torch.equal(F.narrow(d, 0, 1), F.narrow(d, S - 2, 1))
            assert torch.equal(F.narrow(d, S - 1, 1), F.narrow(d, 1, 1))


def test_step_leaves_inputs_unchanged():
    it.init_global_grid(8, 8, 16, quiet=True, device="cpu", nprocs=8,
                        **PERIODIC)
    tp = th.Params()
    Pe, phi = th.init_fields(tp)
    before = Pe.clone(), phi.clone()
    for uk, n in ((False, 1), ("auto", 1), ("auto", 3), ("auto", 10)):
        th.make_multi_step(n, tp, use_kernels=uk)(Pe, phi)
        same((Pe, phi), before)


def test_decomposition_invariance_f64():
    """The same global problem on 8 blocks and on one (open boundaries),
    through the kernel routes (the chunk route on 8 blocks)."""
    out = {}
    for tag, n, kw in (("multi", 12, dict(nprocs=8)), ("single", 22, SINGLE)):
        it.init_global_grid(n, n, n, quiet=True, device="cpu", **kw)
        tp = th.Params()
        Pe, phi = th.make_multi_step(10, tp, K=4)(
            *th.init_fields(tp, dtype=torch.float64))
        out[tag] = [it.gather_interior(F) for F in (Pe, phi)]
        it.finalize_global_grid()
    for a, b in zip(out["multi"], out["single"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_dispatch_refusals():
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", nprocs=8,
                        overlapx=3, **PERIODIC)
    tp = th.Params()
    Pe, phi = th.init_fields(tp)
    with pytest.raises(it.GridError, match="overlaps"):
        th.make_step(tp, use_kernels=True)(Pe, phi)
    th.make_step(tp, use_kernels="auto")(Pe, phi)     # CPU: plain composition
    with pytest.raises(it.GridError, match="use_kernels"):
        th.make_step(tp, use_kernels="yes")(Pe, phi)
    with pytest.raises(it.GridError, match="n_inner"):
        th.make_multi_step(0, tp)
    with pytest.raises(it.GridError, match="npow"):
        th.make_multi_step(1, th.Params(npow=-1))
    it.finalize_global_grid()
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", **SINGLE)
    Pe, phi = th.init_fields(tp)
    with pytest.raises(it.GridError, match="is not like Pe"):
        th.make_step(tp, use_kernels=True)(Pe, phi.double())
    with pytest.raises(it.GridError, match="float32/float64"):
        th.make_step(tp, use_kernels=True)(Pe.half(), phi.half())


def test_chunk_admission_gates():
    it.init_global_grid(16, 16, 128, dimx=2, dimy=2, dimz=2, quiet=True,
                        device="cpu")
    g = it.get_global_grid()
    s = (16, 16, 128)
    refusal = htz.hm3d_trapezoid_refusal
    assert refusal(g, s, 8, 8, torch.float32) is None
    assert refusal(g, s, 8, 8, torch.float64) is None
    assert "full K=8 chunk" in refusal(g, s, 8, 7, torch.float32)
    assert "full K=1 chunk" in refusal(g, s, 1, 8, torch.float32)
    assert "float32/float64" in refusal(g, s, 8, 8, torch.float16)
    assert "shared region" in refusal(g, s, 16, 16, torch.float32)
    assert "grid block" in refusal(g, (17, 16, 128), 8, 8, torch.float32)
    it.finalize_global_grid()
    it.init_global_grid(16, 16, 128, dimx=2, dimy=2, dimz=2, disp=2,
                        periodx=1, quiet=True, device="cpu")
    assert "disp" in refusal(it.get_global_grid(), s, 8, 8, torch.float32)
    it.finalize_global_grid()
    it.init_global_grid(16, 16, 128, dimx=2, dimy=2, dimz=2, overlapz=3,
                        quiet=True, device="cpu")
    assert "overlaps" in refusal(it.get_global_grid(), s, 8, 8, torch.float32)
