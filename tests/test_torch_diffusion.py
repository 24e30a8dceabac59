"""The port's 3-D diffusion main path held against igg on the CPU.

The same state (igg's `init_fields`, moved as numpy arrays) goes through
igg and through igg_torch with `device="cpu"`.  On the CPU the port's
kernel route (`use_kernels="auto"`) runs each kernel's plain version, so
both of its paths are checked: the fused per-step route (exchange of
recomputed send planes, recv/wrap/frozen halo modes) and the K-step loop
route (wrap/frozen modes).  igg's side is its interpret-mode Pallas step,
or its XLA path with `overlap=True` where its own tests pin the kernels
to it.  Tolerance: `rtol=2e-6, atol=2e-5` in float32, the one igg's own
kernel tests use (the two packages round `exp` and the stencil sums in
different places).
"""

import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.models import diffusion3d as d3
from igg.ops import fused_diffusion_step
from igg_torch import convert
from igg_torch.models import diffusion3d as t3

RTOL, ATOL = 2e-6, 2e-5          # float32, as in tests/test_models.py
PERIODIC = dict(periodx=1, periody=1, periodz=1)
SINGLE = dict(dimx=1, dimy=1, dimz=1)
PARAMS = d3.Params(lx=4.0, ly=4.0, lz=8.0)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def setup(n, kw, dtype=np.float32):
    """Initialize both grids; returns igg's (T, Cp), the port's copy of
    the same state and the port's Params."""
    igg.init_global_grid(*n, quiet=True, **kw)
    T, Cp = d3.init_fields(PARAMS, dtype=dtype)
    it.init_global_grid(*n, quiet=True, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)
    st = convert.to_torch({"T": np.asarray(T), "Cp": np.asarray(Cp)})
    return (T, Cp), (st["T"], st["Cp"]), convert.convert_params(PARAMS, t3.Params)


def close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(SINGLE, **PERIODIC), {},
                                dict(dimx=4, dimy=2, dimz=1, periodz=1)],
                         ids=["periodic_1block", "open_8blocks", "mixed_4x2x1"])
def test_init_fields_match_igg(kw):
    (T, Cp), _, tp = setup((8, 8, 16), kw)
    Tt, Cpt = t3.init_fields(tp)
    # rtol 1e-6: exp differs by ulps between XLA and PyTorch
    np.testing.assert_allclose(Tt.numpy(), np.asarray(T), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Cpt.numpy(), np.asarray(Cp), rtol=1e-6, atol=1e-6)
    assert tp.timestep() == PARAMS.timestep()


STEP_CASES = {
    "periodic_1block": dict(SINGLE, **PERIODIC),
    "open_1block": SINGLE,
    "periody_1block": dict(SINGLE, periody=1),
    "periodic_8blocks": PERIODIC,
    "open_8blocks": {},
    "mixed_4x2x1": dict(dimx=4, dimy=2, dimz=1, periodz=1, periodx=1),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_igg_interpret_fused_step(case):
    """One step: the port's plain composition and its fused-step route
    against igg's fused Pallas step in interpret mode."""
    (T, Cp), (Tt, Cpt), tp = setup((8, 8, 16), STEP_CASES[case])
    dx, dy, dz = PARAMS.spacing()
    ref_fn = igg.sharded(
        lambda T, Cp: fused_diffusion_step(
            T, Cp, dx=dx, dy=dy, dz=dz, dt=PARAMS.timestep(), lam=PARAMS.lam,
            bx=4, interpret=True),
        check_vma=False)
    ref = ref_fn(T, Cp)
    plain = t3.make_step(tp, use_kernels=False)(Tt, Cpt)
    fused = t3.make_step(tp, use_kernels="auto")(Tt, Cpt)
    close(plain, ref)
    close(fused, ref)
    # Same arithmetic on the same inputs: the fused route's exchange of
    # recomputed planes reproduces the plain composition exactly.
    np.testing.assert_array_equal(fused.numpy(), plain.numpy())


KSTEP_CASES = {
    "wrap": dict(SINGLE, **PERIODIC),
    "frozen": SINGLE,
    "wrap_x_open_yz": dict(SINGLE, periodx=1),
    "wrap_y_frozen_z": dict(SINGLE, periody=1),
    "wrap_xz_frozen_y": dict(SINGLE, periodx=1, periodz=1),
}


@pytest.mark.parametrize("case", sorted(KSTEP_CASES))
def test_kstep_loop_matches_igg(case):
    """n_inner=4 on a one-block grid: the port's K-step route and plain
    loop against igg's overlap-path loop (the path tests/test_mega_tpu.py
    pins igg's mega kernel to within 1 ulp)."""
    (T, Cp), (Tt, Cpt), tp = setup((8, 16, 16), KSTEP_CASES[case])
    ref = d3.make_multi_step(4, PARAMS, donate=False, use_pallas=False,
                             overlap=True)(T, Cp)
    kstep = t3.make_multi_step(4, tp, use_kernels="auto")(Tt, Cpt)
    plain = t3.make_multi_step(4, tp, use_kernels=False)(Tt, Cpt)
    close(kstep, ref)
    close(plain, ref)
    np.testing.assert_array_equal(kstep.numpy(), plain.numpy())


@pytest.mark.parametrize("kw", [
    PERIODIC, {},
    dict(dimx=4, dimy=2, dimz=1, periodz=1, periodx=1),
    dict(dimx=8, dimy=1, dimz=1, periody=1, periodz=1),
    dict(dimx=1, dimy=8, dimz=1, **PERIODIC),
], ids=["periodic_2x2x2", "open_2x2x2", "4x2x1", "8x1x1", "1x8x1"])
def test_multiblock_multistep_matches_igg(kw):
    """The 8-block meshes of tests/test_models.py:90-153, 3 steps."""
    (T, Cp), (Tt, Cpt), tp = setup((8, 8, 16), kw)
    ref = d3.make_multi_step(3, PARAMS, donate=False, use_pallas=False,
                             overlap=True)(T, Cp)
    fused = t3.make_multi_step(3, tp, use_kernels="auto")(Tt, Cpt)
    close(fused, ref)
    close(t3.make_multi_step(3, tp, use_kernels=False)(Tt, Cpt), ref)


@pytest.mark.parametrize("kw", [PERIODIC, {}], ids=["periodic", "open"])
def test_sharded_local_step_matches_igg(kw):
    """`local_step` written for one block, run on every block by `sharded`
    (its `update_halo_local` a collective over the blocks), against igg's
    `local_step` under `igg.sharded`; float32, rtol 2e-6, atol 2e-5."""
    (T, Cp), (Tt, Cpt), tp = setup((8, 8, 16), kw)
    dx, dy, dz = PARAMS.spacing()
    step = dict(dx=dx, dy=dy, dz=dz, dt=PARAMS.timestep(), lam=PARAMS.lam)
    ref = igg.sharded(lambda T, Cp: d3.local_step(T, Cp, **step),
                      check_vma=False)(T, Cp)
    out = it.sharded(lambda T, Cp: t3.local_step(T, Cp, **step))(Tt, Cpt)
    close(out, ref)
    np.testing.assert_array_equal(
        out.numpy(), t3.make_step(tp, use_kernels=False)(Tt, Cpt).numpy())


@pytest.mark.parametrize("n_inner,uk", [(1, "auto"), (3, "auto"), (3, False)])
def test_periodic_halo_aliases_inner_plane_bitwise(n_inner, uk):
    """On one periodic block every halo plane equals the inner plane it
    aliases bit for bit, on the kernel route and the plain path alike."""
    _, (Tt, Cpt), tp = setup((8, 8, 16), dict(SINGLE, **PERIODIC))
    T = t3.make_multi_step(n_inner, tp, use_kernels=uk)(Tt, Cpt)
    for d in range(3):
        lo, hi = T.narrow(d, 0, 1), T.narrow(d, T.shape[d] - 1, 1)
        assert torch.equal(lo, T.narrow(d, T.shape[d] - 2, 1))
        assert torch.equal(hi, T.narrow(d, 1, 1))


def test_step_leaves_input_unchanged():
    _, (Tt, Cpt), tp = setup((8, 8, 16), dict(SINGLE, **PERIODIC))
    before = Tt.clone()
    for uk, n in ((False, 1), ("auto", 1), ("auto", 3)):
        t3.make_multi_step(n, tp, use_kernels=uk)(Tt, Cpt)
        assert torch.equal(Tt, before)


def test_run_end_to_end_matches_igg():
    """`run()`: init, slope-timed loop of n_inner=2 calls; the same number
    of steps runs in both packages."""
    igg.init_global_grid(8, 8, 16, quiet=True, **PERIODIC)
    T_ref, _ = d3.run(8, PARAMS, dtype=np.float32, n_inner=2, use_pallas=False)
    it.init_global_grid(8, 8, 16, quiet=True, device="cpu", nprocs=8, **PERIODIC)
    tp = convert.convert_params(PARAMS, t3.Params)
    T, sec = t3.run(8, tp, dtype=torch.float32, n_inner=2)
    assert sec > 0
    close(T, T_ref)


def test_energy_conservation_periodic_f64():
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", nprocs=8, **PERIODIC)
    tp = t3.Params()
    T, Cp = t3.init_fields(tp, dtype=torch.float64)
    e0 = float(np.sum(it.gather_interior(Cp * T)))
    T = t3.make_multi_step(20, tp)(T, Cp)
    e1 = float(np.sum(it.gather_interior(Cp * T)))
    assert abs(e1 - e0) / abs(e0) < 1e-13


def test_decomposition_invariance_f64():
    """Same global physics on 8 blocks as on 1 (open boundaries)."""
    out = {}
    for tag, n, kw in (("multi", 6, dict(nprocs=8)),
                       ("single", 10, SINGLE)):
        it.init_global_grid(n, n, n, quiet=True, device="cpu", **kw)
        tp = t3.Params()
        T, Cp = t3.init_fields(tp, dtype=torch.float64)
        T = t3.make_multi_step(10, tp)(T, Cp)
        out[tag] = it.gather_interior(T)
        it.finalize_global_grid()
    np.testing.assert_allclose(out["multi"], out["single"], rtol=0, atol=1e-12)


def test_dispatch_refusals():
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", nprocs=8,
                        overlapx=3, **PERIODIC)
    tp = t3.Params()
    T, Cp = t3.init_fields(tp)
    with pytest.raises(it.GridError, match="overlaps"):
        t3.make_step(tp, use_kernels=True)(T, Cp)
    t3.make_step(tp, use_kernels="auto")(T, Cp)     # CPU: plain composition
    with pytest.raises(it.GridError, match="use_kernels"):
        t3.make_step(tp, use_kernels="yes")(T, Cp)
    with pytest.raises(it.GridError, match="n_inner"):
        t3.make_multi_step(0, tp)


@pytest.mark.parametrize("uk", ["auto", False])
def test_coefficient_follows_heat_capacity(uk):
    """The step forms `A = dt*lam/Cp` once per `Cp` and again after `Cp`
    changes, in place or for another tensor: bitwise what a fresh step
    function gives."""
    _, (Tt, Cpt), tp = setup((8, 8, 16), dict(SINGLE, **PERIODIC))
    step = t3.make_multi_step(2, tp, use_kernels=uk)
    step(Tt, Cpt)
    for Cp in (Cpt.mul_(2.0), Cpt * 0.5):
        want = t3.make_multi_step(2, tp, use_kernels=uk)(Tt, Cp)
        assert torch.equal(step(Tt, Cp), want)
