"""The port's fault injectors (igg_torch.chaos) held against igg's on the
CPU.

A checkpoint the port's `corrupt_checkpoint` damaged (every mode, flat and
sharded) or its `poison_checkpoint` poisoned is judged by igg's
`verify_checkpoint` as igg's own damage is, and igg's damage by the
port's; `ChaosPlan` refuses what igg's refuses with igg's text; `armed`
composes and unwinds; `_poison` writes its NaN into the cell igg's does;
the halo and tier taps arm and disarm their seams.  igg runs on its 8
virtual CPU devices, the port with `device="cpu"` and the same 8 blocks
stacked, on (2, 2, 2) blocks of 6^3; inputs from a seeded numpy
generator.
"""

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.fields import sharding_for
from igg_torch import degrade, halo
from torch_threads import one_torch_thread  # noqa: F401

PERIODIC = dict(periodx=1, periody=1, periodz=1)
CHAOS = {"igg": igg.chaos, "port": it.chaos}
SHARDED_MODES = ["truncate", "bitflip", "missing_shard", "partial_commit",
                 "preempt_mid_write"]


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def both_init():
    igg.init_global_grid(6, 6, 6, quiet=True, **PERIODIC)
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", nprocs=8,
                        **PERIODIC)


def arrays(seed=11):
    rng = np.random.default_rng(seed)
    shp = it.stacked_shape((6, 6, 6))
    return {"T": rng.standard_normal(shp), "Cp": 1.0 + rng.random(shp)}


def write(writer, fmt, path, seed=11):
    """A generation of `arrays(seed)` written by `writer`."""
    a = arrays(seed)
    if writer == "igg":
        fields = {k: jax.device_put(v, sharding_for(3)) for k, v in a.items()}
        save = igg.save_checkpoint if fmt == "flat" else \
            igg.save_checkpoint_sharded
    else:
        fields = {k: torch.from_numpy(v) for k, v in a.items()}
        save = it.save_checkpoint if fmt == "flat" else \
            it.save_checkpoint_sharded
    save(path, **fields)
    return path


def gen(tmp_path, fmt):
    return tmp_path / ("gen.npz" if fmt == "flat" else "gen")


def verdicts(path, **kw):
    return [pkg.verify_checkpoint(path, **kw) for pkg in (igg, it)]


@pytest.mark.parametrize("corruptor,writer", [("port", "port"),
                                              ("port", "igg"),
                                              ("igg", "port")])
@pytest.mark.parametrize("mode", SHARDED_MODES)
def test_corrupt_sharded_refused_by_both(tmp_path, mode, corruptor, writer):
    both_init()
    p = write(writer, "sharded", gen(tmp_path, "sharded"))
    assert verdicts(p) == [True, True]
    CHAOS[corruptor].corrupt_checkpoint(p, mode, shard=3)
    if mode == "preempt_mid_write":
        assert not p.exists()
        assert p.with_name(p.name + ".tmp").is_dir()
        assert it.latest_checkpoint(tmp_path) is None
        assert igg.latest_checkpoint(tmp_path) is None
    else:
        assert verdicts(p) == [False, False]


@pytest.mark.parametrize("corruptor,writer", [("port", "port"),
                                              ("port", "igg"),
                                              ("igg", "port")])
@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_flat_refused_by_both(tmp_path, mode, corruptor, writer):
    both_init()
    p = write(writer, "flat", gen(tmp_path, "flat"))
    CHAOS[corruptor].corrupt_checkpoint(p, mode, field="T")
    assert verdicts(p) == [False, False]
    if mode == "bitflip":
        with pytest.raises(it.GridError, match="CRC32 mismatch"):
            it.load_checkpoint(p)


def test_corrupt_bytes_equal_igg(tmp_path):
    """Both packages' corruptors turn one file into the same bytes."""
    both_init()
    for mode in ("truncate", "bitflip"):
        out = []
        for pkg in ("igg", "port"):
            p = write("port", "flat", tmp_path / f"{pkg}_{mode}.npz")
            CHAOS[pkg].corrupt_checkpoint(p, mode, seed=4)
            out.append(p.read_bytes())
        assert out[0] == out[1], mode


@pytest.mark.parametrize("mode", ["missing_shard", "partial_commit",
                                  "preempt_mid_write", "sideways"])
def test_corrupt_refusals_equal_igg(tmp_path, mode):
    both_init()
    msgs = []
    for pkg in ("igg", "port"):
        p = write("port", "flat", tmp_path / f"{pkg}.npz")
        with pytest.raises(Exception) as ei:
            CHAOS[pkg].corrupt_checkpoint(p, mode)
        msgs.append(str(ei.value).replace(str(p), "<path>"))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("poisoner,writer", [("port", "port"),
                                             ("port", "igg"),
                                             ("igg", "port")])
@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_poison_refused_by_deep_verify_only(tmp_path, fmt, poisoner, writer):
    both_init()
    p = write(writer, fmt, gen(tmp_path, fmt))
    CHAOS[poisoner].poison_checkpoint(p, field="T", magnitude=3.0, seed=2,
                                      shard=5)
    assert verdicts(p) == [True, True]
    assert verdicts(p, check_finite=True) == [True, True]
    assert verdicts(p, deep=True) == [False, False]


def test_poison_bytes_equal_igg(tmp_path):
    """Both packages' poisoners change the same cell by the same amount."""
    both_init()
    got = []
    for pkg in ("igg", "port"):
        p = write("port", "sharded", tmp_path / pkg)
        CHAOS[pkg].poison_checkpoint(p, magnitude=2.5, seed=7, shard=1)
        got.append(it.load_checkpoint(p))
    for name in ("T", "Cp"):
        assert torch.equal(got[0][name], got[1][name])


@pytest.mark.parametrize("kw", [
    dict(nan_at=[(3, 0)]),
    dict(nan_at=[(3, 0, 5)]),
    dict(hold_at=[(3,)]),
    dict(hold_at=[(3, -1.0)]),
], ids=["member_no_field", "member_field_not_str", "hold_short",
        "hold_negative"])
def test_chaos_plan_parse_errors_equal_igg(kw):
    msgs = []
    for pkg in (igg, it):
        with pytest.raises(pkg.GridError) as ei:
            pkg.chaos.ChaosPlan(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_chaos_plan_fires_once_per_arming():
    plan = it.chaos.ChaosPlan(nan_at=[(3, "T")], preempt_at=4,
                              hold_at=[(2, 0.0)])
    log = []
    st = {"T": torch.zeros(4, 4, 4)}
    for step in range(6):
        st = plan.apply(st, step, lambda k, s, **d: log.append((k, s)))
    assert log == [("chaos_hold", 2), ("chaos_nan", 3), ("chaos_preempt", 4)]
    assert int(torch.isnan(st["T"]).sum()) == 1
    assert it.resilience.preemption_requested()
    it.resilience.clear_preemption()
    with pytest.raises(it.GridError, match="not in state"):
        it.chaos.ChaosPlan(nan_at=[(0, "U")]).apply(st, 0, lambda *a, **k: 0)


@pytest.mark.parametrize("index", [None, (7, 2, 9)])
def test_poison_hits_igg_cell(index):
    both_init()
    a = arrays()["T"]
    want = np.asarray(igg.chaos._poison(jax.device_put(a, sharding_for(3)),
                                        index))
    src = torch.from_numpy(a.copy())
    got = it.chaos._poison(src, index)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert torch.equal(src, torch.from_numpy(a))   # the input is untouched
    with pytest.raises(it.GridError, match="cannot seed NaN into dtype"):
        it.chaos._poison(torch.zeros(3, 3, dtype=torch.int32))


def test_armed_composes_and_unwinds():
    """igg's `TestChaosContextManagers`: every injector disarms on the way
    out, also when the body raises, and a plan is reset on entry and
    exit."""
    kc = it.chaos.kernel_corrupt("some.tier", 1.0)
    with pytest.raises(RuntimeError, match="boom"):
        with it.chaos.armed(kc):
            assert degrade._CHAOS_TIER_TAP is not None
            raise RuntimeError("boom")
    assert degrade._CHAOS_TIER_TAP is None
    plan = it.chaos.ChaosPlan(nan_at=[(3, "T")])
    plan._fired.add(("nan", 3, None, "T", None))
    with it.chaos.armed(plan) as p:
        assert p is plan and not plan._fired
        plan._fired.add(("nan", 3, None, "T", None))
    assert not plan._fired
    a = it.chaos.kernel_compile_fail("t.a")
    b = it.chaos.kernel_corrupt("t.b", 2.0)
    hc = it.chaos.halo_corruption()
    with it.chaos.armed(a, b, hc) as (ia, ib, ih):
        tap = degrade._CHAOS_TIER_TAP
        assert tap["compile_fail"]["t.a"] is None
        assert tap["corrupt"]["t.b"] == 2.0
        assert halo._CHAOS_PLANE_TAP is not None
    assert degrade._CHAOS_TIER_TAP is None and halo._CHAOS_PLANE_TAP is None
    kc = it.chaos.kernel_compile_fail("t.c").arm()
    assert "t.c" in degrade._CHAOS_TIER_TAP["compile_fail"]
    kc.disarm()
    assert degrade._CHAOS_TIER_TAP is None


@pytest.mark.parametrize("periods", [{}, PERIODIC], ids=["open",
                                                         "periodic"])
def test_halo_corruption_hits_igg_cells(periods):
    """Armed, `update_halo` leaves NaN in exactly the cells igg's leaves
    (every plane `exchange_planes` returns, an open edge's stale planes
    included) and the rest as the clean update; disarmed, the update is
    the clean one again."""
    igg.init_global_grid(6, 6, 6, quiet=True, **periods)
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", nprocs=8,
                        **periods)
    a = arrays()["T"]
    A = torch.from_numpy(a)
    clean = it.update_halo(A.clone())
    with igg.chaos.halo_corruption():
        want = np.asarray(igg.update_halo(jax.device_put(a,
                                                         sharding_for(3))))
    with it.chaos.halo_corruption():
        bad = it.update_halo(A.clone())
    assert torch.equal(it.update_halo(A.clone()), clean)
    nan = torch.isnan(bad)
    np.testing.assert_array_equal(nan.numpy(), np.isnan(want))
    assert bool(nan.any()) and not bool(nan[2:4, 2:4, 2:4].any())
    assert torch.equal(bad[~nan], clean[~nan])


def test_kernel_corrupt_taps_the_serving_tier():
    """A corrupted tier's output differs in one cell by `magnitude`; the
    truth tier is never touched; verify-on-first-use catches it."""
    from igg_torch.models import diffusion3d as t3

    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", nprocs=8,
                        **PERIODIC)
    a = arrays()
    T, Cp = torch.from_numpy(a["T"]), torch.from_numpy(a["Cp"])
    clean = t3.make_step()(T, Cp)
    plain = t3.make_step(use_kernels=False)(T, Cp)
    with it.chaos.kernel_corrupt("diffusion3d.cuda", 5.0):
        bad = t3.make_step()(T, Cp)
        assert torch.equal(t3.make_step(use_kernels=False)(T, Cp), plain)
        with pytest.raises(it.GridError, match="verify-on-first-use"):
            t3.make_step(verify="first_use")(T, Cp)
    diff = (bad - clean).abs()
    assert int((diff > 0).sum()) == 1 and float(diff[1, 1, 1]) == 5.0
