"""The port's resilient loop (igg_torch.resilience) held against igg's on
the CPU.

igg runs on its 8 virtual CPU devices, the port with `device="cpu"` and
the same 8 blocks stacked, on `init_global_grid(6, 6, 6)` fully periodic
(2x2x2 blocks), each package's `diffusion3d.make_step` (igg's with
`donate=False`), float64, from one seeded state.  For a NaN at step k, a
preemption and its resume, halo corruption and the demotion of a
corrupted kernel tier, the port's events (kinds, steps, the probes'
counts), retries and steps equal igg's, and its final state lies within
the float64 tolerance of tests/test_torch_diffusion.py of igg's and
equals the port's own clean run bitwise.  A ring igg wrote resumes in the
port and the other way round.  igg's runs are shared through
module-scoped fixtures.  Then the port's counterparts of igg's own cases
(tests/test_resilience.py).
"""

import gc
import os
import signal
import warnings

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.fields import sharding_for
from igg.models import diffusion3d as d3
from igg_torch import checkpoint as ck
from igg_torch import convert, degrade
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as t3
from torch_threads import one_torch_thread  # noqa: F401

PERIODIC = dict(periodx=1, periody=1, periodz=1)
LOCAL = (6, 6, 6)
ATOL = 1e-12            # float64, as in tests/test_torch_diffusion.py
F32_TOL = dict(rtol=2e-6, atol=2e-5)   # float32, ditto
N = 20
# The demotion case needs igg's Pallas tier to serve (interpret mode): it
# takes float32 only, and its slab gate wants z >= 128 (the grid of
# tests/test_degrade.py).
DEMOTE_LOCAL = (8, 8, 128)
SYNC = dict(async_checkpoint=False)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()


def seeded(local, seed=3, dtype=np.float64):
    """Stacked T (halo-consistent) and Cp on the initialized igg grid's
    decomposition, as numpy arrays."""
    g = igg.get_global_grid()
    shp = tuple(s * d for s, d in zip(local, g.dims))
    rng = np.random.default_rng(seed)
    T = rng.standard_normal(shp).astype(dtype)
    Cp = (1.0 + rng.random(shp)).astype(dtype)
    T = np.asarray(igg.update_halo(jax.device_put(T, sharding_for(3))))
    return {"T": T, "Cp": Cp}


def igg_state(arrays):
    return {k: jax.device_put(v, sharding_for(v.ndim))
            for k, v in arrays.items()}


def igg_step(**kw):
    step = d3.make_step(d3.Params(), donate=False, **kw)
    return lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}


def port_step(**kw):
    step = t3.make_step(t3.Params(), **kw)
    return lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}


def summary(events, names=None):
    """(kind, step, counts, tier) of every event; `names` maps tier
    names."""
    names = names or {}
    return [(e.kind, e.step, e.detail.get("counts"),
             names.get(e.detail.get("tier"), e.detail.get("tier")))
            for e in events]


def split(events):
    """The events other than 'checkpoint', in order, and the checkpoint
    steps, sorted: the background writer's completions land in the
    per-run list when they are collected, which depends on timing."""
    return ([e for e in summary(events) if e[0] != "checkpoint"],
            sorted(e.step for e in events if e.kind == "checkpoint"))


def outcome(res, names=None):
    return dict(events=summary(res.events, names), split=split(res.events),
                retries=res.retries, steps_done=res.steps_done,
                preempted=res.preempted, T=np.asarray(res.state["T"]))


def port_init(local=LOCAL):
    it.init_global_grid(*local, quiet=True, device="cpu", nprocs=8,
                        **PERIODIC)


def clean_port(fn, arrays, n=N):
    st = convert.to_torch(arrays)
    for _ in range(n):
        st = fn(st)
    return st["T"]


def halo_policy(fault, seen):
    def policy(attempt, state, ev):
        seen.append((attempt, ev.kind))
        fault.disarm()      # the transient fault heals
        return None
    return policy


@pytest.fixture(scope="module")
def igg_runs(tmp_path_factory):
    """igg's runs of every compared case, as host data."""
    tmp = tmp_path_factory.mktemp("igg_runs")
    igg.init_global_grid(*LOCAL, quiet=True, **PERIODIC)
    try:
        arrays = seeded(LOCAL)
        fn = igg_step()
        st = igg_state(arrays)
        for _ in range(N):
            st = fn(st)
        out = {"arrays": arrays, "clean": np.asarray(st["T"])}
        for mode, kw in (("sync", SYNC), ("async", {})):
            out[f"nan_{mode}"] = outcome(igg.run_resilient(
                fn, igg_state(arrays), N, watch_every=5,
                checkpoint_dir=tmp / f"nan_{mode}", checkpoint_every=5,
                chaos=igg.chaos.ChaosPlan(nan_at=[(7, "T")]), **kw))
        pre = tmp / "preempt"
        out["preempt"] = outcome(igg.run_resilient(
            fn, igg_state(arrays), N, watch_every=5, checkpoint_dir=pre,
            checkpoint_every=5, chaos=igg.chaos.ChaosPlan(preempt_at=12),
            **SYNC))
        out["resume"] = outcome(igg.run_resilient(
            fn, igg_state(arrays), N, watch_every=5, checkpoint_dir=pre,
            checkpoint_every=5, resume=True, **SYNC))
        fault, seen = igg.chaos.halo_corruption(), []
        with fault:
            out["halo"] = outcome(igg.run_resilient(
                fn, igg_state(arrays), 15, watch_every=5,
                checkpoint_dir=tmp / "halo", checkpoint_every=5,
                recovery_policy=halo_policy(fault, seen), **SYNC))
        out["halo"]["seen"] = seen
        # A ring igg writes, preempted at 12, for the port to resume.
        out["ring"] = tmp / "igg_ring"
        igg.run_resilient(fn, igg_state(arrays), N, watch_every=5,
                          checkpoint_dir=out["ring"], checkpoint_every=5,
                          chaos=igg.chaos.ChaosPlan(preempt_at=12))
        igg.finalize_global_grid()

        igg.init_global_grid(*DEMOTE_LOCAL, quiet=True, **PERIODIC)
        demote = seeded(DEMOTE_LOCAL, seed=5, dtype=np.float32)
        fn = igg_step(pallas_interpret=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with igg.chaos.kernel_corrupt("diffusion3d.mosaic"):
                out["demote"] = outcome(igg.run_resilient(
                    fn, igg_state(demote), N, watch_every=5,
                    checkpoint_dir=tmp / "demote", checkpoint_every=5,
                    **SYNC), names={"diffusion3d.mosaic": "kernel tier"})
        out["demote_arrays"] = demote
        out["demote_quarantined"] = sorted(igg.degrade.status())
        igg.degrade.reset()
    finally:
        if igg.grid_is_initialized():
            igg.finalize_global_grid()
    return out


def port_run(igg_runs, tmp_path, **kw):
    port_init()
    fn = port_step()
    res = it.run_resilient(fn, convert.to_torch(igg_runs["arrays"]), N,
                           watch_every=5, checkpoint_dir=tmp_path,
                           checkpoint_every=5, **kw)
    return fn, res


def check_final(got, want_igg, want_port):
    np.testing.assert_allclose(got, want_igg, rtol=0, atol=ATOL)
    assert torch.equal(torch.from_numpy(got), want_port)


# -- against igg --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_nan_rollback_matches_igg(igg_runs, tmp_path, mode):
    fn, res = port_run(igg_runs, tmp_path,
                       chaos=it.chaos.ChaosPlan(nan_at=[(7, "T")]),
                       **(SYNC if mode == "sync" else {}))
    got, want = outcome(res), igg_runs[f"nan_{mode}"]
    if mode == "sync":
        assert got["events"] == want["events"]
    assert got["split"] == want["split"]
    det = [e for e in res.events if e.kind == "nan_detected"]
    assert len(det) == 1 and 7 < det[0].step <= 12
    for k in ("retries", "steps_done", "preempted"):
        assert got[k] == want[k]
    check_final(got["T"], want["T"],
                clean_port(fn, igg_runs["arrays"]))


def test_preempt_and_resume_match_igg(igg_runs, tmp_path):
    fn, res = port_run(igg_runs, tmp_path,
                       chaos=it.chaos.ChaosPlan(preempt_at=12), **SYNC)
    got = outcome(res)
    assert got["events"] == igg_runs["preempt"]["events"]
    assert res.preempted and res.steps_done == 12
    res2 = it.run_resilient(fn, convert.to_torch(igg_runs["arrays"]), N,
                            watch_every=5, checkpoint_dir=tmp_path,
                            checkpoint_every=5, resume=True, **SYNC)
    got2, want2 = outcome(res2), igg_runs["resume"]
    assert got2["events"] == want2["events"]
    assert (got2["retries"], got2["steps_done"]) == (0, N)
    check_final(got2["T"], want2["T"], clean_port(fn, igg_runs["arrays"]))


def test_halo_corruption_matches_igg(igg_runs, tmp_path):
    port_init()
    fn = port_step()
    fault, seen = it.chaos.halo_corruption(), []
    with fault:
        res = it.run_resilient(fn, convert.to_torch(igg_runs["arrays"]), 15,
                               watch_every=5, checkpoint_dir=tmp_path,
                               checkpoint_every=5,
                               recovery_policy=halo_policy(fault, seen),
                               **SYNC)
    want = igg_runs["halo"]
    assert seen == want["seen"] == [(1, "nan_detected")]
    got = outcome(res)
    assert got["events"] == want["events"]
    assert got["retries"] == want["retries"] == 1
    check_final(got["T"], want["T"],
                clean_port(fn, igg_runs["arrays"], 15))


def test_recurrence_demotes_like_igg(igg_runs, tmp_path):
    """A kernel tier corrupted at every dispatch: the recurrence at the
    same step demotes it (a `tier_degraded` event, no retry spent) and the
    replay on the plain tier finishes; igg's sequence, its tier named
    `diffusion3d.mosaic` there and `diffusion3d.cuda` here.  float32 (igg's
    Pallas tier takes nothing else)."""
    port_init(DEMOTE_LOCAL)
    fn = port_step()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with it.chaos.kernel_corrupt("diffusion3d.cuda"):
            res = it.run_resilient(
                fn, convert.to_torch(igg_runs["demote_arrays"]), N,
                watch_every=5, checkpoint_dir=tmp_path, checkpoint_every=5,
                **SYNC)
    got = outcome(res, names={"diffusion3d.cuda": "kernel tier"})
    want = igg_runs["demote"]
    assert got["events"] == want["events"]
    assert [e[0] for e in got["events"]].count("tier_degraded") == 1
    assert (got["retries"], got["steps_done"]) == (want["retries"], N)
    assert sorted(degrade.status()) == ["diffusion3d.cuda"]
    assert igg_runs["demote_quarantined"] == ["diffusion3d.mosaic"]
    assert degrade.active()["diffusion3d"] == "diffusion3d.plain"
    plain = port_step(use_kernels=False)
    np.testing.assert_allclose(got["T"], want["T"], **F32_TOL)
    assert torch.equal(torch.from_numpy(got["T"]),
                       clean_port(plain, igg_runs["demote_arrays"]))


def test_recurrence_demotes_past_a_dropped_ladder(tmp_path):
    """A second ladder of the family, built and dropped before the
    recurrence, does not hide the serving tier from the demotion: the
    loop still demotes `diffusion3d.cuda` and finishes on the plain
    tier."""
    _grid()
    fn = port_step()
    port_step()(_init_state())     # a temporary factory, dispatched once
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with it.chaos.kernel_corrupt("diffusion3d.cuda"):
            res = _run(fn, tmp_path)
    kinds = [e.kind for e in res.events]
    assert kinds.count("tier_degraded") == 1 and res.steps_done == N
    assert sorted(degrade.status()) == ["diffusion3d.cuda"]
    assert degrade.active()["diffusion3d"] == "diffusion3d.plain"


def test_port_resumes_igg_ring(igg_runs):
    port_init()
    fn = port_step()
    res = it.run_resilient(fn, convert.to_torch(igg_runs["arrays"]), N,
                           watch_every=5, checkpoint_dir=igg_runs["ring"],
                           checkpoint_every=5, resume=True, **SYNC)
    assert res.events[0].kind == "resume" and res.events[0].step == 12
    assert res.steps_done == N
    np.testing.assert_allclose(res.state["T"].numpy(), igg_runs["clean"],
                               rtol=0, atol=ATOL)


def test_igg_resumes_port_ring(igg_runs, tmp_path):
    port_init()
    fn = port_step()
    res = it.run_resilient(fn, convert.to_torch(igg_runs["arrays"]), N,
                           watch_every=5, checkpoint_dir=tmp_path,
                           checkpoint_every=5,
                           chaos=it.chaos.ChaosPlan(preempt_at=12))
    assert res.preempted and res.steps_done == 12
    igg.init_global_grid(*LOCAL, quiet=True, **PERIODIC)
    res2 = igg.run_resilient(igg_step(), igg_state(igg_runs["arrays"]), N,
                             watch_every=5, checkpoint_dir=tmp_path,
                             checkpoint_every=5, resume=True)
    assert res2.events[0].kind == "resume" and res2.events[0].step == 12
    np.testing.assert_allclose(np.asarray(res2.state["T"]), igg_runs["clean"],
                               rtol=0, atol=ATOL)


# -- the port's counterparts of igg's cases -----------------------------------
# A small fully periodic float64 state on 2x2x2 blocks of 6^3 and the port's
# diffusion step, every comparison bitwise.

def _grid():
    port_init()


def _init_state(seed=3):
    rng = np.random.default_rng(seed)
    shp = it.stacked_shape(LOCAL)
    T = it.update_halo(torch.from_numpy(rng.standard_normal(shp)))
    return {"T": T, "Cp": torch.from_numpy(1.0 + rng.random(shp))}


def _clean(fn, state, n):
    for _ in range(n):
        state = fn(state)
    return state["T"]


def _run(fn, path, n=N, **kw):
    args = dict(watch_every=5, checkpoint_dir=path, checkpoint_every=5)
    args.update(kw)
    return it.run_resilient(fn, _init_state(), n, **args)


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "missing_shard",
                                  "partial_commit", "preempt_mid_write"])
def test_sharded_fault_skipped_and_recovered_bit_exact(tmp_path, mode):
    _grid()
    fn = port_step()
    ref = _clean(fn, _init_state(), N)
    _run(fn, tmp_path, 10, ring=3)
    newest = it.latest_checkpoint(tmp_path)
    assert ck.checkpoint_step(newest) == 10
    it.chaos.corrupt_checkpoint(newest, mode)
    assert it.latest_checkpoint(tmp_path) != newest
    res = _run(fn, tmp_path, ring=3, resume=True)
    assert res.events[0].kind == "resume" and res.events[0].step == 5
    assert res.steps_done == N
    assert torch.equal(res.state["T"], ref)


@pytest.mark.parametrize("case", ["poisoned_generation_skipped",
                                  "prune_protects_last_healthy",
                                  "newer_generations_discarded"])
def test_rollback_targets(tmp_path, case):
    """igg's `test_rollback_skips_poisoned_generation`,
    `test_ring_prune_protects_last_healthy_generation` and
    `test_rollback_discards_newer_abandoned_generations`."""
    _grid()
    fn = port_step()
    ref = _clean(fn, _init_state(), N)
    if case == "poisoned_generation_skipped":
        res = _run(fn, tmp_path, watch_every=10, checkpoint_every=2, ring=10,
                   max_pending_probes=4,
                   chaos=it.chaos.ChaosPlan(nan_at=[(7, "T")]))
        rb = [e for e in res.events if e.kind == "rollback"]
        assert rb and rb[0].step <= 6
        assert torch.equal(res.state["T"], ref)
    elif case == "prune_protects_last_healthy":
        res = _run(fn, tmp_path, watch_every=10, checkpoint_every=2, ring=2,
                   chaos=it.chaos.ChaosPlan(nan_at=[(1, "T")]))
        rb = [e for e in res.events if e.kind == "rollback"]
        assert rb and rb[0].step == 0
        assert torch.equal(res.state["T"], ref)
    else:
        res = _run(fn, tmp_path, watch_every=10, checkpoint_every=2, ring=10,
                   chaos=it.chaos.ChaosPlan(nan_at=[(7, "T")],
                                            preempt_at=12))
        rb = next(e for e in res.events if e.kind == "rollback")
        assert rb.step <= 6
        assert res.preempted and res.steps_done == 12
        steps = [s for s, _ in ck.list_generations(tmp_path)]
        assert max(steps) == 12
        assert it.latest_checkpoint(tmp_path, check_finite=True).name \
            == "ckpt_000000012"


@pytest.mark.parametrize("case", ["leftovers_cleared", "sibling_prefix"])
def test_ring_owns_its_generations(tmp_path, case):
    """igg's `test_fresh_run_clears_leftover_generations` and
    `test_ring_ignores_sibling_prefix`."""
    _grid()
    fn = port_step()
    if case == "leftovers_cleared":
        other = _init_state(seed=99)
        it.save_checkpoint(tmp_path / "ckpt_000000000.npz", **other)
        it.save_checkpoint(tmp_path / "ckpt_000000005.npz", **other)
        ref = _clean(fn, _init_state(), 10)
        res = _run(fn, tmp_path, 10, checkpoint_every=10,
                   chaos=it.chaos.ChaosPlan(nan_at=[(2, "T")]))
        rb = next(e for e in res.events if e.kind == "rollback")
        assert rb.step == 0 and res.retries == 1
        assert torch.equal(res.state["T"], ref)
    else:
        foreign = tmp_path / "ckpt_b_000000099.npz"
        it.save_checkpoint(foreign, **_init_state(seed=7))
        _run(fn, tmp_path, ring=2)
        assert foreign.exists()
        assert it.latest_checkpoint(tmp_path).name == "ckpt_000000020"


@pytest.mark.parametrize("case", [
    ("steps_per_call", dict(watch_every=5, steps_per_call=3), "state"),
    ("checkpoint_dir", dict(checkpoint_every=5), "state"),
    ("non-empty dict", {}, "list"),
    ("watch cadence", dict(watch_every=0,
                           divergence_fn=lambda st: False), "state"),
    ("resume=True", dict(resume=True), "state"),
    ("ring must", dict(ring=0), "state"),
    ("watch_fields", dict(watch_fields=["U"]), "state"),
], ids=lambda c: c[0].replace(" ", "_"))
def test_cadence_validation_messages_equal_igg(case):
    """The argument checks raise igg's `GridError` texts, word for
    word."""
    match, kw, state = case
    _grid()
    igg.init_global_grid(*LOCAL, quiet=True, **PERIODIC)
    msgs = []
    for pkg, st, fn in ((igg, igg_state(seeded(LOCAL)), igg_step()),
                        (it, _init_state(), port_step())):
        with pytest.raises(pkg.GridError, match=match) as ei:
            pkg.run_resilient(fn, [] if state == "list" else st, 10, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("case", ["background_commit", "failed_write",
                                  "sync_mode", "flat_mode"])
def test_checkpoint_modes(tmp_path, monkeypatch, case):
    """igg's `test_async_checkpoints_commit_in_background`,
    `test_failed_background_write_degrades_ring_not_run` and
    `test_sync_and_flat_checkpoint_modes`."""
    _grid()
    fn = port_step()
    if case == "background_commit":
        res = _run(fn, tmp_path, ring=3)
        cks = [e for e in res.events if e.kind == "checkpoint"]
        assert any(e.detail.get("background") for e in cks)
        assert not cks[0].detail.get("background")
        assert not any(e.kind == "checkpoint_failed" for e in res.events)
        newest = it.latest_checkpoint(tmp_path, check_finite=True)
        assert ck.checkpoint_step(newest) == N
        assert torch.equal(it.load_checkpoint(newest)["T"], res.state["T"])
    elif case == "failed_write":
        real = ck.save_checkpoint_sharded
        calls = {"n": 0}

        def flaky(path, /, **fields):
            calls["n"] += 1
            if calls["n"] == 2:              # the first cadence write
                raise OSError("disk full")
            return real(path, **fields)

        monkeypatch.setattr(ck, "save_checkpoint_sharded", flaky)
        res = _run(fn, tmp_path, ring=10)
        fails = [e for e in res.events if e.kind == "checkpoint_failed"]
        assert len(fails) == 1 and "disk full" in fails[0].detail["error"]
        assert fails[0].step == 5 and res.steps_done == N
        steps = [s for s, _ in ck.list_generations(tmp_path)]
        assert 5 not in steps and {0, 10, 15, 20} <= set(steps)
    elif case == "sync_mode":
        res = _run(fn, tmp_path, 10, **SYNC)
        assert not any(e.detail.get("background") for e in res.events
                       if e.kind == "checkpoint")
        assert it.latest_checkpoint(tmp_path).is_dir()
    else:
        res = _run(fn, tmp_path, 10, sharded=False)
        newest = it.latest_checkpoint(tmp_path)
        assert newest.name == "ckpt_000000010.npz" and newest.is_file()
        assert torch.equal(it.load_checkpoint(newest)["T"], res.state["T"])


@pytest.mark.parametrize("chaos", [False, True])
def test_multi_step_dispatch(tmp_path, chaos):
    """igg's `test_steps_per_call_multi_step_dispatch` and
    `test_chaos_injection_inside_multi_step_dispatch`: a step of 5 steps
    a call; a NaN at step 7 fires at the boundary before it."""
    _grid()
    base = port_step()

    def step5(st):
        for _ in range(5):
            st = base(st)
        return st

    ref = _clean(base, _init_state(), N)
    plan = it.chaos.ChaosPlan(nan_at=[(7, "T")]) if chaos else None
    res = _run(step5, tmp_path, watch_every=10, checkpoint_every=10,
               steps_per_call=5, chaos=plan)
    assert res.steps_done == N
    if chaos:
        inj = [e for e in res.events if e.kind == "chaos_nan"]
        assert inj and inj[0].step == 5
        assert res.retries == 1
    assert torch.equal(res.state["T"], ref)


def test_in_place_step_with_async_generations(tmp_path):
    """A `step_fn` that writes its input tensor in place: the background
    writer's generations hold the state of their step, bitwise, and a
    rollback replays bitwise."""
    _grid()
    step = t3.make_step(t3.Params())

    def in_place(st):
        st["T"].copy_(step(st["T"], st["Cp"]))
        return st

    ref = _init_state()
    want = {0: ref["T"].clone()}
    for k in range(1, N + 1):
        ref = in_place(ref)
        want[k] = ref["T"].clone()
    res = _run(in_place, tmp_path, ring=10,
               chaos=it.chaos.ChaosPlan(nan_at=[(7, "T")]))
    assert res.retries == 1 and torch.equal(res.state["T"], want[N])
    gens = ck.list_generations(tmp_path)
    assert [s for s, _ in gens] == [0, 5, 10, 15, 20]
    assert any(e.detail.get("background") for e in res.events
               if e.kind == "checkpoint")
    for s, p in gens:
        assert torch.equal(it.load_checkpoint(p)["T"], want[s]), s


@pytest.mark.parametrize("case", ["sigterm", "divergence", "policy_swap",
                                  "budget_exhausted", "no_ring"])
def test_loop_paths(tmp_path, case):
    """igg's `test_sigterm_handler_sets_preemption`,
    `test_divergence_predicate_triggers_rollback`,
    `test_recovery_policy_may_swap_step_fn`,
    `test_persistent_fault_exhausts_retry_budget` and
    `test_detection_without_ring_fails_fast`."""
    _grid()
    base = port_step()
    if case == "sigterm":
        fired = {"done": False}

        def fn(st):
            out = base(st)
            if not fired["done"]:
                fired["done"] = True
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        res = _run(fn, tmp_path)
        assert res.preempted and 0 < res.steps_done < N
        assert it.latest_checkpoint(tmp_path) is not None
        assert not it.resilience.preemption_requested()
        assert signal.getsignal(signal.SIGTERM) is not \
            it.resilience.request_preemption
    elif case == "divergence":
        fired = {"n": 0}

        def diverged(state):
            fired["n"] += 1
            return fired["n"] == 2

        res = _run(base, tmp_path, divergence_fn=diverged)
        kinds = [e.kind for e in res.events]
        assert "divergence" in kinds and "rollback" in kinds
        assert res.retries == 1
        assert torch.equal(res.state["T"], _clean(base, _init_state(), N))
    elif case == "policy_swap":
        calls = {"b": 0}

        def step_b(st):
            calls["b"] += 1
            return base(st)

        res = _run(base, tmp_path, 10,
                   recovery_policy=lambda k, st, ev: (st, step_b),
                   chaos=it.chaos.ChaosPlan(nan_at=[(3, "T")]))
        rb = next(e for e in res.events if e.kind == "rollback")
        assert res.retries == 1 and calls["b"] == 10 - rb.step
    elif case == "budget_exhausted":
        state0 = _init_state()
        with it.chaos.halo_corruption():
            with pytest.raises(it.ResilienceError, match="retry budget") \
                    as ei:
                it.run_resilient(base, state0, 15, watch_every=5,
                                 checkpoint_dir=tmp_path, checkpoint_every=5,
                                 max_retries=2)
        kinds = [e.kind for e in ei.value.events]
        # On the CPU the recurrence first demotes the kernel tier (no
        # retry spent); the plain tier's exchange is corrupted too.
        assert kinds.count("tier_degraded") == 1
        assert kinds.count("rollback") == 3 and kinds[-1] == "nan_detected"
    else:
        with pytest.raises(it.ResilienceError, match="no checkpoint_dir"):
            it.run_resilient(base, _init_state(), 10, watch_every=5,
                             chaos=it.chaos.ChaosPlan(nan_at=[(3, "T")]))


def test_probe_counts_per_field(tmp_path):
    """igg's `test_probe_counts_are_per_field_and_replicated`: only the
    poisoned field reports, with its count."""
    _grid()
    step = t3.make_step(t3.Params())
    state = _init_state()
    state["U"] = _init_state(5)["T"]
    fn = lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"],
                    "U": step(s["U"], s["Cp"])}
    res = it.run_resilient(fn, state, 10, watch_every=5,
                           checkpoint_dir=tmp_path, checkpoint_every=5,
                           chaos=it.chaos.ChaosPlan(nan_at=[(3, "U",
                                                             (7, 7, 7))]))
    det = [e for e in res.events if e.kind == "nan_detected"]
    assert det and set(det[0].detail["counts"]) == {"U"}
    U = state["U"].clone()
    U[1, 1, 1] = float("nan")
    U[2, 3, 4] = float("inf")
    counts = it.resilience.probe_counts(state["T"], U,
                                        torch.zeros(3, dtype=torch.int32))
    assert counts.dtype == torch.float32 and counts.tolist() == [0, 2, 0]


def test_kernel_compile_fail_raises(tmp_path):
    """Where igg quarantines a tier whose build fails and serves the next
    rung, the port lets the build error out of `run_resilient`, and
    nothing is quarantined."""
    _grid()
    fn = port_step()
    with it.chaos.kernel_compile_fail("diffusion3d.cuda", "no nvcc today"):
        with pytest.raises(degrade.InjectedCompileError, match="no nvcc"):
            _run(fn, tmp_path)
    assert degrade.status() == {}


@pytest.mark.parametrize("arg", ["serve", "comm", "heal", "integrity",
                                 "member_nan"])
def test_unported_arguments_raise(tmp_path, arg):
    _grid()
    if arg == "member_nan":
        # Member-targeted entries are ported with ensembles
        # (tests/test_torch_ensemble.py): they parse as igg's do.
        assert it.chaos.ChaosPlan(nan_at=[(3, 0, "T")]).nan_at == \
            igg.chaos.ChaosPlan(nan_at=[(3, 0, "T")]).nan_at
        return
    if arg == "integrity":
        # integrity= is ported (igg_torch.integrity): without a watch
        # cadence it raises igg's check.
        with pytest.raises(it.GridError, match="watch cadence"):
            _run(port_step(), tmp_path, watch_every=0, checkpoint_every=0,
                 checkpoint_dir=None, integrity=True)
        return
    if arg == "heal":
        # heal= is ported (igg_torch.heal): a value that is no policy or
        # engine raises igg's coercion.
        with pytest.raises(it.GridError, match="heal='bogus': expected "
                                               "None, False, True"):
            _run(port_step(), tmp_path, heal="bogus")
        return
    if arg == "serve":
        # serve= is ported (igg_torch.statusd): a value that is no port or
        # server raises igg's coercion.
        with pytest.raises(it.GridError, match="serve='bogus': expected "
                                               "None, False, True"):
            _run(port_step(), tmp_path, serve="bogus")
        return
    # comm= is ported (igg_torch.comm): a value that is no monitor raises
    # igg's check, naming StepDecomposition.
    with pytest.raises(it.GridError, match="comm=True: .*StepDecomposition"):
        _run(port_step(), tmp_path, comm=True)


def test_telemetry_names_and_auto_dump_equal_igg(tmp_path):
    """Metric names, the `step_stats` record's keys and the run records
    are igg's; a `ResilienceError` names the flight-recorder dump the
    loop wrote."""
    names = {}
    _grid()
    for pkg in ("port", "igg"):
        if pkg == "port":
            fn, st, mod = port_step(), _init_state(), it
        else:
            igg.init_global_grid(*LOCAL, quiet=True, **PERIODIC)
            fn, st, mod = igg_step(), igg_state(seeded(LOCAL)), igg
        kinds = {}
        sub = lambda rec: kinds.setdefault(rec.kind, set()).update(
            rec.payload)
        mod.telemetry.subscribe(sub)
        try:
            with mod.telemetry.Telemetry(tmp_path / pkg):
                mod.run_resilient(fn, st, N, watch_every=5,
                                  checkpoint_dir=tmp_path / f"{pkg}_ring",
                                  checkpoint_every=5,
                                  chaos=mod.chaos.ChaosPlan(nan_at=[(7,
                                                                     "T")]))
                snap = mod.telemetry.snapshot()
        finally:
            mod.telemetry.unsubscribe(sub)
        metrics = {k.split("{")[0] for k in snap
                   if k.startswith(("igg_steps", "igg_rollbacks",
                                    "igg_watchdog", "igg_rank_window"))}
        names[pkg] = (metrics, {k: sorted(v) for k, v in kinds.items()
                                if k in ("step_stats", "run_started",
                                         "run_finished", "rollback",
                                         "nan_detected", "chaos_nan")})
    assert names["port"] == names["igg"]
    assert names["port"][0] == {"igg_steps_total", "igg_rollbacks_total",
                                "igg_steps_per_s",
                                "igg_watchdog_fetch_lag_steps",
                                "igg_rank_window_ms"}
    for name in names["port"][0]:
        assert tel.metric_help(name) == igg.telemetry.metric_help(name)
    with tel.Telemetry(tmp_path / "dump"):
        with it.chaos.halo_corruption():
            with pytest.raises(it.ResilienceError) as ei:
                _run(port_step(), tmp_path / "dump_ring", 15, max_retries=0)
    paths = ei.value.dump_paths
    assert paths and all(p.exists() for p in paths)
    assert str(paths[0]) in str(ei.value)
