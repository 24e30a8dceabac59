"""The port's ensemble tier (igg_torch.ensemble) held against igg's on the
CPU.

igg runs on its 8 virtual CPU devices, the port with `device="cpu"` and
the same 8 blocks stacked, on `init_global_grid(6, 6, 6)` fully periodic
(2x2x2 blocks) unless a case says otherwise.  Member states are float64,
made with numpy from a seed (halo-consistent through each package's
`update_halo`), one stacked array per member as `tests/helpers.py`'s
`ensemble_states` makes them.  The member step is the port's twin of
`helpers.ensemble_member_step` (a Laplacian relaxation with an optional
per-member `rate_scale`), or each package's
`diffusion3d.make_member_step`.

Each of igg's `tests/test_ensemble.py` contracts is a flow run on both
packages (cases of one parametrised test where igg's tests repeat a
shape): the port's events (kind, step and detail but the paths),
retries, quarantine, steps and preemption equal igg's, and its final
stacked state lies within RTOL of igg's (the stencil's arithmetic in each
package's order); against the port's own uninterrupted run, frozen,
rolled-back and replayed lanes are bitwise.  Where igg's own test fails
on its CPU devices (batch packing, the elastic resumes: ROADMAP
"Standing caveat"), the port is held to the contract alone, and the test
names igg's.  Then the sidecar and the generations load both ways, the
diffusion member step, the integrity rows, `MemberRefs`, the member chaos
and overlap inside the ensemble.  igg's runs are shared through a
module-scoped fixture.
"""

import contextlib
import json

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.fields import sharding_for
from igg_torch import ensemble as ens
from igg_torch import integrity as tinteg
from igg_torch.ops.stencil import interior_add
from helpers import ensemble_member_step
from torch_threads import one_torch_thread  # noqa: F401

LOCAL = (6, 6, 6)
PERIODIC = dict(periodx=1, periody=1, periodz=1)
RTOL = 1e-12     # float64 stencil values, as in tests/test_torch_diffusion.py
PKGS = {"igg": igg, "port": it}


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def port_member_step(rate=0.1):
    """The port's twin of `helpers.ensemble_member_step`."""
    def member_step(st):
        T = st["T"]
        lap = (T[:-2, 1:-1, 1:-1] + T[2:, 1:-1, 1:-1]
               + T[1:-1, :-2, 1:-1] + T[1:-1, 2:, 1:-1]
               + T[1:-1, 1:-1, :-2] + T[1:-1, 1:-1, 2:]
               - 6.0 * T[1:-1, 1:-1, 1:-1])
        r = rate * st["rate_scale"] if "rate_scale" in st else rate
        out = dict(st)
        out["T"] = it.update_halo_local(interior_add(T, r * lap))
        return out

    return member_step


class Pkg:
    """One package's side of a flow, behind one interface."""

    def __init__(self, name):
        self.name = name
        self.mod = PKGS[name]

    def init(self, local=LOCAL, **kw):
        if self.mod.grid_is_initialized():
            self.mod.finalize_global_grid()
        args = dict(PERIODIC, quiet=True)
        args.update(kw)
        if self.name == "port":
            args["device"] = "cpu"
            if "dimx" not in kw:
                args["nprocs"] = 8
        self.mod.init_global_grid(*local, **args)

    def halo(self, a):
        if self.name == "igg":
            return igg.update_halo(jax.device_put(a, sharding_for(a.ndim)))
        return it.update_halo(torch.from_numpy(a.copy()))

    def states(self, members, seed=3, rate_scales=None, cp=False):
        g = self.mod.get_global_grid()
        shp = tuple(n * d for n, d in zip(g.nxyz, g.dims))
        rng = np.random.default_rng(seed)
        out = []
        for m in range(members):
            st = {"T": self.halo(rng.standard_normal(shp))}
            if cp:
                st["Cp"] = self.halo(1.0 + rng.random(shp))
            if rate_scales is not None:
                st["rate_scale"] = np.float64(rate_scales[m])
            out.append(st)
        return out

    def step(self, rate=0.1):
        return (ensemble_member_step(rate) if self.name == "igg"
                else port_member_step(rate))

    def run(self, states, n, step=None, **kw):
        # Every probe is read at its step in both packages, so the event
        # streams do not depend on when a device finishes.
        kw.setdefault("max_pending_probes", 0)
        return self.mod.run_ensemble(step or self.step(), states, n, **kw)

    @contextlib.contextmanager
    def never_ready(self):
        """Probes report not ready until the loop must read them (beyond
        the pending bound, or at its end): igg's usual order on its CPU
        devices, made deterministic through the readiness seam."""
        res = self.mod.resilience
        res._CHAOS_FETCH_TAP = lambda x: False
        try:
            yield
        finally:
            res._CHAOS_FETCH_TAP = None

    def clean(self, states, n, step=None, **kw):
        return self.run(states, n, step, watch_every=0,
                        install_sigterm=False, **kw)

    def ref(self, states, n):
        """The port's uninterrupted run's stacked T (None for igg, whose
        flows are compared with the port's, not with its own)."""
        if self.name == "igg":
            return None
        return self.host(self.clean(states, n).state["T"])

    def plan(self, **kw):
        return self.mod.chaos.ChaosPlan(**kw)

    @staticmethod
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def interiors(self, res, members):
        return np.stack([self.host(self.mod.gather_interior(
            res.state["T"][m])) for m in range(members)])


def _plain(v):
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def summary(events):
    """(kind, step, detail but paths) of every event, in order."""
    return [(e.kind, e.step,
             _plain({k: v for k, v in e.detail.items() if k != "path"}))
            for e in events]


def outcome(pkg, res):
    return dict(events=summary(res.events), T=pkg.host(res.state["T"]),
                steps=res.steps_done, quarantined=list(res.quarantined),
                retries=dict(res.retries), preempted=res.preempted,
                packing=res.packing)


def kinds(out):
    return [e[0] for e in out["events"]]


def first(out, kind):
    return next(e for e in out["events"] if e[0] == kind)


# ---------------------------------------------------------------------------
# The flows: one per contract of igg's tests/test_ensemble.py, run on both
# packages.  Each returns its outcomes and the package's clean references.
# ---------------------------------------------------------------------------

# igg: test_probe_attributes_single_member, _multiple_simultaneous_members,
# _member_zero_edge; test_isolated_recovery_bit_exact (the first case).
ATTRIBUTION = {
    "single": (4, [(7, 2, "T")]),
    "multiple_simultaneous": (5, [(6, 1, "T"), (7, 3, "T")]),
    "member_zero_edge": (3, [(7, 0, "T")]),
}


def flow_attribution(pkg, tmp, case):
    members, nan = ATTRIBUTION[case]
    pkg.init()
    states = pkg.states(members)
    ref = pkg.ref(states, 20)
    res = pkg.run(states, 20, watch_every=5, checkpoint_dir=tmp,
                  checkpoint_every=5, chaos=pkg.plan(nan_at=nan))
    return dict(run=outcome(pkg, res), ref=ref)


def flow_lane_poisoned_generation(pkg, tmp):
    # checkpoint_every=2 < watch_every=10: gens 8 and 10 hold the lane
    # poisoned at 7 before the step-10 probe is read.
    pkg.init()
    states = pkg.states(3)
    ref = pkg.ref(states, 20)
    res = pkg.run(states, 20, watch_every=10, checkpoint_dir=tmp,
                  checkpoint_every=2, ring=10,
                  chaos=pkg.plan(nan_at=[(7, 1, "T")]))
    return dict(run=outcome(pkg, res), ref=ref)


SCALES = [1.0, 0.5, 2.0, 1.25]


def flow_scalar_sweep(pkg, tmp):
    pkg.init()
    states = pkg.states(4, rate_scales=SCALES)
    res = pkg.run(states, 10, watch_every=5, checkpoint_dir=tmp,
                  checkpoint_every=5)
    zeros = [{k: np.zeros_like(pkg.host(v)) if k == "rate_scale"
              else v * 0 for k, v in st.items()} for st in states]
    again = pkg.run(zeros, 10, watch_every=5, checkpoint_dir=tmp,
                    checkpoint_every=5, resume=True)
    sidecar = json.loads((res.checkpoint / "ensemble.json").read_text())
    return dict(run=outcome(pkg, res), again=outcome(pkg, again),
                scales=pkg.host(res.state["rate_scale"]),
                scales_again=pkg.host(again.state["rate_scale"]),
                sidecar=sidecar)


def flow_retry_exhaustion(pkg, tmp):
    pkg.init()
    states = pkg.states(4)
    ref = pkg.ref(states, 20)
    plan = pkg.plan(nan_at=[(s, 1, "T") for s in
                            (6, 7, 8, 9, 11, 12, 13, 14, 16, 17)])
    res = pkg.run(states, 20, watch_every=5, checkpoint_dir=tmp,
                  checkpoint_every=5, member_retries=2, chaos=plan)
    return dict(run=outcome(pkg, res), ref=ref)


def flow_no_rollback_target(pkg, tmp):
    pkg.init()
    res = pkg.run(pkg.states(3), 10, watch_every=5,
                  chaos=pkg.plan(nan_at=[(3, 1, "T")]))
    return dict(run=outcome(pkg, res))


def flow_all_quarantined(pkg, tmp):
    pkg.init()
    with pytest.raises(pkg.mod.ResilienceError) as ei:
        pkg.run(pkg.states(2), 10, watch_every=5,
                chaos=pkg.plan(nan_at=[(3, 0, "T"), (3, 1, "T")]))
    return dict(error=str(ei.value).split("  [")[0],
                events=summary(ei.value.events))


def flow_quarantine_persists(pkg, tmp):
    pkg.init()
    plan = pkg.plan(nan_at=[(s, 0, "T") for s in (2, 3, 6, 7, 8, 9, 11, 12)],
                    preempt_at=15)
    kw = dict(watch_every=5, checkpoint_dir=tmp, checkpoint_every=5,
              member_retries=1)
    res = pkg.run(pkg.states(3), 25, chaos=plan, **kw)
    again = pkg.run(pkg.states(3), 25, resume=True, **kw)
    return dict(run=outcome(pkg, res), again=outcome(pkg, again))


def flow_resume_matching_nothing(pkg, tmp):
    pkg.init()
    pkg.run(pkg.states(2), 200, watch_every=100, checkpoint_dir=tmp,
            checkpoint_every=100)
    states = pkg.states(3)
    ref = pkg.ref(states, 20)
    res = pkg.run(states, 20, watch_every=5, checkpoint_dir=tmp,
                  checkpoint_every=5, ring=3, resume=True,
                  chaos=pkg.plan(nan_at=[(7, 1, "T")]))
    gens = [s for s, _ in it.checkpoint.list_generations(tmp, "ens")]
    return dict(run=outcome(pkg, res), ref=ref, gens=gens)


def flow_preempt_during_catchup(pkg, tmp):
    # NaN at 2, detected by the step-4 probe; the preemption at 3 lands
    # before the rollback, so the whole replay runs with the flag set.
    pkg.init()
    states = pkg.states(3)
    kw = dict(watch_every=4, checkpoint_dir=tmp, checkpoint_every=4)
    res = pkg.run(states, 8, chaos=pkg.plan(nan_at=[(2, 0, "T")],
                                            preempt_at=3), **kw)
    again = pkg.run(states, 8, resume=True, **kw)
    ref = pkg.ref(states, 8)
    return dict(run=outcome(pkg, res), again=outcome(pkg, again), ref=ref)


def flow_tail_rollback(pkg, tmp):
    # watch_every == n_steps: the only probe reads the front, after the
    # poisoned cadence generation at step 10 is on disk.
    pkg.init()
    states = pkg.states(3)
    ref = pkg.ref(states, 10)
    with pkg.never_ready():
        res = pkg.run(states, 10, watch_every=10, checkpoint_dir=tmp,
                      checkpoint_every=5, max_pending_probes=4,
                      chaos=pkg.plan(nan_at=[(7, 1, "T")]))
    disk = np.moveaxis(pkg.host(pkg.mod.load_checkpoint(res.checkpoint)["T"]),
                       -1, 0)
    return dict(run=outcome(pkg, res), ref=ref, disk=disk)


def flow_steps_per_call(pkg, tmp):
    pkg.init()
    states = pkg.states(3)
    ref = pkg.ref(states, 20)
    res = pkg.run(states, 20, watch_every=10, checkpoint_dir=tmp,
                  checkpoint_every=10, steps_per_call=5)
    return dict(run=outcome(pkg, res), ref=ref)


FLOWS = {
    "attribution_single": lambda p, t: flow_attribution(p, t, "single"),
    "attribution_multiple_simultaneous":
        lambda p, t: flow_attribution(p, t, "multiple_simultaneous"),
    "attribution_member_zero_edge":
        lambda p, t: flow_attribution(p, t, "member_zero_edge"),
    "lane_poisoned_generation": flow_lane_poisoned_generation,
    "scalar_sweep": flow_scalar_sweep,
    "retry_exhaustion": flow_retry_exhaustion,
    "no_rollback_target": flow_no_rollback_target,
    "all_quarantined": flow_all_quarantined,
    "quarantine_persists": flow_quarantine_persists,
    "resume_matching_nothing": flow_resume_matching_nothing,
    "preempt_during_catchup": flow_preempt_during_catchup,
    "tail_rollback": flow_tail_rollback,
    "steps_per_call": flow_steps_per_call,
}


def _contract(name, out):
    """igg's assertions of each flow (tests/test_ensemble.py), on one
    package's outcome."""
    run = out.get("run")
    if name.startswith("attribution"):
        members, nan = ATTRIBUTION[name[len("attribution_"):]]
        want = sorted({e[1] for e in nan})
        div = [e for e in run["events"] if e[0] == "member_diverged"]
        assert len(div) == 1 and div[0][2]["members"] == want
        assert 7 < div[0][1] <= 12                  # within one window
        assert sorted(div[0][2]["counts"]["T"]) == [str(m) for m in want]
        assert first(run, "member_rollback")[2]["members"] == want
        assert run["quarantined"] == [] and run["steps"] == 20
        assert run["retries"] == {m: 1 for m in want}
    elif name == "lane_poisoned_generation":
        assert first(run, "member_rollback")[1] <= 6
    elif name == "scalar_sweep":
        assert not np.array_equal(run["T"][0], run["T"][1])
        np.testing.assert_array_equal(out["scales"], SCALES)
        np.testing.assert_array_equal(out["scales_again"], SCALES)
        np.testing.assert_array_equal(out["again"]["T"], run["T"])
        assert out["again"]["events"][0][0] == "resume"
    elif name == "retry_exhaustion":
        assert run["quarantined"] == [1] and run["steps"] == 20
        q = first(run, "member_quarantined")[2]
        assert q["member"] == 1 and q["reason"] == "retry_budget"
    elif name == "no_rollback_target":
        assert run["quarantined"] == [1] and run["steps"] == 10
        assert first(run, "member_quarantined")[2]["reason"] == \
            "no_rollback_target"
    elif name == "all_quarantined":
        assert "every member" in out["error"]
    elif name == "quarantine_persists":
        assert run["preempted"] and run["quarantined"] == [0]
        again = out["again"]
        assert again["events"][0][0] == "resume"
        assert again["events"][0][2]["quarantined"] == [0]
        assert again["quarantined"] == [0] and again["steps"] == 25
        assert "member_diverged" not in kinds(again)
    elif name == "resume_matching_nothing":
        assert "resume" not in kinds(run)
        assert run["quarantined"] == [] and run["steps"] == 20
        assert max(out["gens"]) == 20
        assert 100 not in out["gens"] and 200 not in out["gens"]
    elif name == "preempt_during_catchup":
        assert run["preempted"] and run["quarantined"] == []
        assert "member_rollback" in kinds(run)
        assert out["again"]["steps"] == 8 and out["again"]["quarantined"] == []
    elif name == "tail_rollback":
        assert run["steps"] == 10 and run["quarantined"] == []
    elif name == "steps_per_call":
        assert run["steps"] == 20


# The flows whose lanes end as the uninterrupted run's (bitwise within a
# package): the state that must equal `ref`.
BITWISE = {"attribution_single": "run", "attribution_multiple_simultaneous":
           "run", "attribution_member_zero_edge": "run",
           "lane_poisoned_generation": "run", "resume_matching_nothing": "run",
           "preempt_during_catchup": "again", "tail_rollback": "run",
           "steps_per_call": "run"}


@pytest.fixture(scope="module")
def igg_flows(tmp_path_factory):
    """igg's outcome of every flow, as host data."""
    pkg = Pkg("igg")
    out = {}
    try:
        for name, flow in FLOWS.items():
            out[name] = flow(pkg, tmp_path_factory.mktemp(name))
    finally:
        if igg.grid_is_initialized():
            igg.finalize_global_grid()
    return out


def _same_state(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", list(FLOWS))
def test_flow_matches_igg_and_keeps_the_contract(igg_flows, tmp_path, name):
    port = FLOWS[name](Pkg("port"), tmp_path)
    ref = igg_flows[name]
    _contract(name, ref)
    _contract(name, port)
    if "error" in port:
        assert port["error"] == ref["error"]
        assert port["events"] == ref["events"]
        return
    for key in ("run", "again"):
        if key not in port:
            continue
        for field in ("events", "steps", "quarantined", "retries",
                      "preempted", "packing"):
            assert port[key][field] == ref[key][field], (key, field)
        _same_state(port[key]["T"], ref[key]["T"])
    if name in BITWISE:
        np.testing.assert_array_equal(port[BITWISE[name]]["T"], port["ref"])
    if name == "retry_exhaustion":
        for m in (0, 2, 3):
            np.testing.assert_array_equal(port["run"]["T"][m],
                                          port["ref"][m])
    if name == "tail_rollback":
        np.testing.assert_array_equal(port["disk"], port["ref"])
    if name == "scalar_sweep":
        assert port["sidecar"] == ref["sidecar"]
    if name == "resume_matching_nothing":
        assert port["gens"] == ref["gens"]


# ---------------------------------------------------------------------------
# The contracts igg's own tests miss on its CPU devices: the port alone
# ---------------------------------------------------------------------------

def _elastic_grid(pkg):
    # The same periodic global domain (2*(6-2) = 8 per dim) on (1, 2, 4).
    pkg.init((10, 6, 4), dimx=1, dimy=2, dimz=4)


@pytest.mark.parametrize("ckpt_every", [5, 20])
def test_preempt_and_elastic_resume(tmp_path, ckpt_every):
    """igg's test_preempt_and_elastic_resume_different_topology (5) and
    test_rollback_after_elastic_resume_uses_old_geometry_gens (20): a
    preempted (2,2,2) ensemble resumes on (1,2,4) and every member's
    interior ends bitwise the uninterrupted (2,2,2) run; with no
    generation written after the resume, member 1's NaN at step 12 rolls
    back into the old decomposition's generations, not into quarantine."""
    pkg = Pkg("port")
    pkg.init()
    states = pkg.states(3)
    want = pkg.interiors(pkg.clean(states, 20), 3)
    res = pkg.run(states, 20, watch_every=5, checkpoint_dir=tmp_path,
                  checkpoint_every=ckpt_every,
                  chaos=pkg.plan(preempt_at=10))
    assert res.preempted and res.steps_done == 10
    _elastic_grid(pkg)
    nan = [(12, 1, "T")] if ckpt_every == 20 else []
    res = pkg.run(pkg.states(3, seed=99), 20, watch_every=5,
                  checkpoint_dir=tmp_path, checkpoint_every=ckpt_every,
                  resume=True, chaos=pkg.plan(nan_at=nan))
    assert res.events[0].kind == "resume" and res.events[0].step == 10
    assert res.steps_done == 20 and res.quarantined == []
    if nan:
        rb = next(e for e in res.events if e.kind == "member_rollback")
        assert rb.detail["members"] == [1]
    np.testing.assert_array_equal(pkg.interiors(res, 3), want)


def test_batch_packing_refused_and_isolation_on_one_block(tmp_path):
    """igg's test_batch_packing_auto_and_isolation: on a dims=(1,1,1) grid
    every block lives on the grid's one device, so "auto" packs "grid",
    "batch" raises igg's refusal, another device is refused; attribution
    and isolated recovery hold for 16 members there."""
    pkg = Pkg("port")
    pkg.init((8, 8, 8), dimx=1, dimy=1, dimz=1)
    states = pkg.states(16)
    clean = pkg.clean(states, 10)
    assert clean.packing == "grid"
    with pytest.raises(it.GridError, match=r"packing='batch'\) needs a "
                                           r"dims=\(1,1,1\) grid"):
        pkg.run(states, 10, packing="batch")
    with pytest.raises(it.GridError, match="lives on cpu"):
        pkg.run(states, 10, devices=["cpu", "meta"])
    pkg.run(states, 2, devices=[torch.device("cpu")])
    res = pkg.run(states, 10, watch_every=5, checkpoint_dir=tmp_path,
                  checkpoint_every=5, chaos=pkg.plan(nan_at=[(3, 9, "T")]))
    div = [e for e in res.events if e.kind == "member_diverged"]
    assert res.packing == "grid" and div[0].detail["members"] == [9]
    assert torch.equal(res.state["T"], clean.state["T"])


def test_one_block_to_grid_elastic_resume(tmp_path):
    """igg's test_batch_to_grid_elastic_resume: a generation of a
    one-block ensemble resumes on the (2,2,2) grid bitwise (the lane
    layout does not depend on the packing)."""
    pkg = Pkg("port")
    pkg.init((8, 8, 8), dimx=1, dimy=1, dimz=1)
    states = pkg.states(8)
    want = pkg.interiors(pkg.clean(states, 10), 8)
    res = pkg.run(states, 10, watch_every=5, checkpoint_dir=tmp_path,
                  checkpoint_every=5, chaos=pkg.plan(preempt_at=5))
    assert res.preempted
    pkg.init((5, 5, 5), dimx=2, dimy=2, dimz=2)
    res = pkg.run(pkg.states(8, seed=42), 10, watch_every=5,
                  checkpoint_dir=tmp_path, checkpoint_every=5, resume=True)
    assert res.packing == "grid" and res.steps_done == 10
    np.testing.assert_array_equal(pkg.interiors(res, 8), want)


def test_argument_validation_equals_igg():
    """igg's test_argument_validation: each refusal raises in both
    packages with igg's text."""
    msgs = {}
    for name in ("igg", "port"):
        pkg = Pkg(name)
        pkg.init()
        states = pkg.states(2)
        step = pkg.step()
        calls = [
            lambda: pkg.mod.run_ensemble(
                step, {"T": np.zeros((2, 12, 12, 12))}, 10),
            lambda: pkg.mod.run_ensemble(step, states, 10,
                                         checkpoint_every=5),
            lambda: pkg.mod.run_ensemble(step, states, 10,
                                         steps_per_call=3),
            lambda: pkg.mod.run_ensemble(step, states, 10, packing="bogus"),
            lambda: pkg.mod.run_ensemble(step, states, 10, packing="batch"),
            lambda: pkg.mod.chaos.ChaosPlan(nan_at=[(3, 1)]),
            lambda: pkg.mod.stack_members([]) if name == "port"
            else igg.ensemble.stack_members([]),
            lambda: pkg.mod.run_ensemble(step, [states[0], {"U": 0}], 10),
        ]
        got = []
        for call in calls:
            with pytest.raises(pkg.mod.GridError) as ei:
                call()
            got.append(str(ei.value))
        msgs[name] = got
        pkg.mod.finalize_global_grid()
    for word, a, b in zip(["members", "checkpoint_dir", "steps_per_call",
                           "packing", "batch", "member-targeted",
                           "no member states", "field model"],
                          msgs["igg"], msgs["port"]):
        assert word in a and word in b
    # The texts equal igg's but where igg prints its grid dims as a list.
    for i in (0, 1, 2, 3, 5, 6, 7):
        assert msgs["igg"][i] == msgs["port"][i]


def test_serve_and_more_processes_refused():
    """serve= is ported (igg_torch.statusd): a value that is no port or
    server raises igg's coercion; an ephemeral endpoint and none run."""
    pkg = Pkg("port")
    pkg.init()
    with pytest.raises(it.GridError, match="serve='bogus': expected None"):
        pkg.run(pkg.states(2), 2, serve="bogus")
    assert pkg.run(pkg.states(2), 2, serve=0).steps_done == 2
    assert pkg.run(pkg.states(2), 2, serve=False).steps_done == 2


def test_step_fn_that_writes_its_inputs_is_refused():
    """The port's member-step contract: new tensors for what changes (a
    lane's input may be a frozen lane's or a generation's)."""
    pkg = Pkg("port")
    pkg.init()

    def in_place(st):
        return {"T": it.update_halo(st["T"])}

    def aliased(st):
        return {"T": st["U"], "U": st["T"] * 1}

    with pytest.raises(it.GridError, match="in place"):
        pkg.run(pkg.states(2), 2, in_place, watch_every=0)
    states = [dict(st, U=st["T"] + 1) for st in pkg.states(2)]
    with pytest.raises(it.GridError, match="another field's input"):
        pkg.run(states, 2, aliased, watch_every=0)
    with pytest.raises(it.GridError, match="same fields"):
        pkg.run(pkg.states(2), 2, lambda st: {"V": st["T"] * 1},
                watch_every=0)


# ---------------------------------------------------------------------------
# Generations and sidecars across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["igg", "port"])
def test_generations_load_both_ways(tmp_path, writer):
    """One package preempts a 3-member sweep at step 10 (ring of
    member-axis-last generations and the sidecar); the other resumes it,
    per-member scalars and quarantine included, and ends where its own
    uninterrupted run ends."""
    reader = "port" if writer == "igg" else "igg"
    w, r = Pkg(writer), Pkg(reader)
    scales = [1.0, 0.5, 2.0]
    kw = dict(watch_every=5, checkpoint_dir=tmp_path, checkpoint_every=5,
              member_retries=0)
    w.init()
    res = w.run(w.states(3, rate_scales=scales), 20,
                chaos=w.plan(nan_at=[(3, 2, "T")], preempt_at=10), **kw)
    assert res.preempted and res.quarantined == [2]
    w.mod.finalize_global_grid()
    r.init()
    states = r.states(3, rate_scales=scales)
    ref = r.host(r.clean(states, 20).state["T"])
    zeros = [{"T": st["T"] * 0, "rate_scale": np.float64(0)}
             for st in states]
    got = r.run(zeros, 20, resume=True, **kw)
    assert got.events[0].kind == "resume" and got.events[0].step == 10
    assert got.events[0].detail["quarantined"] == [2]
    assert got.quarantined == [2] and got.steps_done == 20
    np.testing.assert_array_equal(r.host(got.state["rate_scale"]), scales)
    _same_state(r.host(got.state["T"])[:2], ref[:2])
    r.mod.finalize_global_grid()


def test_param_encoding_equals_igg():
    v = np.array([1.0, 0.5, np.nan, -2.25], dtype=np.float64)
    for arr in (v, v.astype(np.float32), np.arange(3, dtype=np.int32)):
        assert ens._encode_param(arr) == igg.ensemble._encode_param(arr)
        np.testing.assert_array_equal(
            ens._decode_param(igg.ensemble._encode_param(arr)), arr)


# ---------------------------------------------------------------------------
# diffusion3d.make_member_step
# ---------------------------------------------------------------------------

DT_SCALES = [0.5, 0.75, 1.0, 1.25]


@pytest.fixture(scope="module")
def igg_diffusion_members():
    """igg's diffusion member step in its ensemble: 4 members swept over
    DT_SCALES, 10 steps; and one member without `dt_scale`, 4 steps."""
    from igg.models import diffusion3d as d3

    pkg = Pkg("igg")
    try:
        pkg.init()
        states = pkg.states(4, cp=True)
        for st, s in zip(states, DT_SCALES):
            st["dt_scale"] = np.float64(s)
        res = pkg.run(states, 10, d3.make_member_step(d3.Params()),
                      watch_every=5, install_sigterm=False)
        one = pkg.clean(pkg.states(1, seed=5, cp=True), 4,
                        d3.make_member_step(d3.Params()))
        return pkg.host(res.state["T"]), pkg.host(one.state["T"])
    finally:
        igg.finalize_global_grid()


@pytest.mark.parametrize("route", [dict(), dict(use_kernels=False),
                                   dict(use_kernels=False, overlap=True)],
                         ids=["auto", "plain", "overlap"])
def test_member_step_matches_igg(igg_diffusion_members, route):
    """Per dt_scale lane, the port's member step (the kernel's plain
    version under "auto", the plain composition, the overlapped
    composition) lies within RTOL of igg's; the routes agree bitwise."""
    from igg_torch.models import diffusion3d as t3

    swept, one = igg_diffusion_members
    pkg = Pkg("port")
    pkg.init()
    states = pkg.states(4, cp=True)
    for st, s in zip(states, DT_SCALES):
        st["dt_scale"] = np.float64(s)
    step = t3.make_member_step(t3.Params(), **route)
    res = pkg.run(states, 10, step, watch_every=5, install_sigterm=False)
    got = res.state["T"].numpy()
    _same_state(got, swept)
    plain = pkg.run(states, 10, t3.make_member_step(t3.Params(),
                                                    use_kernels=False),
                    watch_every=0)
    np.testing.assert_array_equal(got, plain.state["T"].numpy())
    assert not np.array_equal(got[0], got[3])          # the sweep is real
    solo = pkg.clean(pkg.states(1, seed=5, cp=True), 4,
                     t3.make_member_step(t3.Params(), **route))
    _same_state(solo.state["T"].numpy(), one)


def test_member_step_coefficient_follows_cp_and_dt_scale():
    """The coefficient formed per lane is reused only while the lane's
    Cp (its storage and version) and dt_scale are the ones it was formed
    from: an in-place change of Cp, or another dt_scale, gives the step of
    a fresh member step."""
    from igg_torch.models import diffusion3d as t3

    pkg = Pkg("port")
    pkg.init()
    st = pkg.states(1, cp=True)[0]
    st["dt_scale"] = torch.tensor(0.5, dtype=torch.float64)
    step = t3.make_member_step(t3.Params())

    def fresh(s):
        return t3.make_member_step(t3.Params())(s)["T"]

    assert torch.equal(step(st)["T"], fresh(st))
    st["Cp"].mul_(2.0)
    assert torch.equal(step(st)["T"], fresh(st))
    st["dt_scale"] = torch.tensor(0.25, dtype=torch.float64)
    assert torch.equal(step(st)["T"], fresh(st))
    with pytest.raises(it.GridError, match="dt_scale is torch.float32"):
        step(dict(st, dt_scale=torch.tensor(0.5)))
    with pytest.raises(it.GridError, match="diffusion kernels cannot serve"):
        t3.make_member_step(t3.Params(), use_kernels=True)(
            {"T": st["T"].half(), "Cp": st["Cp"].half()})


# ---------------------------------------------------------------------------
# Overlap inside the ensemble
# ---------------------------------------------------------------------------

def _stencil(A):
    """tests/test_round16_satellites.py's radius-1 slice stencil."""
    out = 0.1 * A
    for d in range(A.ndim):
        lo = [slice(None)] * A.ndim
        hi = [slice(None)] * A.ndim
        mid = [slice(None)] * A.ndim
        lo[d], hi[d], mid[d] = slice(0, -2), slice(2, None), slice(1, -1)
        out[tuple(mid)] += 0.15 * (A[tuple(lo)] + A[tuple(hi)])
    return out


@pytest.fixture(scope="module")
def igg_overlap_seq():
    from test_round16_satellites import _seq_member_step

    pkg = Pkg("igg")
    try:
        pkg.init()
        return pkg.host(pkg.clean(pkg.states(3), 6,
                                  _seq_member_step).state["T"])
    finally:
        igg.finalize_global_grid()


def test_overlap_in_ensemble(igg_overlap_seq):
    """igg's test_overlap_in_ensemble_grid_packing (and, on the port's one
    packing, _batch_packing): the member step through
    `hide_communication` serves the ensemble bitwise the sequential
    member step, which lies within RTOL of igg's."""
    pkg = Pkg("port")
    pkg.init()

    def seq(st):
        return {"T": it.update_halo_local(_stencil(st["T"]))}

    def ov(st):
        return {"T": it.hide_communication(st["T"], _stencil)}

    a = pkg.clean(pkg.states(3), 6, seq)
    b = pkg.clean(pkg.states(3), 6, ov)
    assert a.packing == b.packing == "grid"
    assert torch.equal(a.state["T"], b.state["T"])
    _same_state(a.state["T"].numpy(), igg_overlap_seq)


# ---------------------------------------------------------------------------
# Integrity's member half
# ---------------------------------------------------------------------------

def _heat(pkg):
    integ = pkg.mod.integrity
    return integ.IntegrityConfig(
        check_every=0,
        invariants=[integ.Invariant("total_heat", ("T",), moment=1,
                                    kind="conserved")])


def flow_member_integrity(pkg, tmp):
    pkg.init()
    states = pkg.states(4)
    ref = pkg.ref(states, 40)
    with pkg.mod.chaos.silent_corruption("T", step=22, magnitude=30.0,
                                         member=2):
        res = pkg.run(states, 40, watch_every=5, checkpoint_dir=tmp,
                      checkpoint_every=10, integrity=_heat(pkg),
                      install_sigterm=False)
    return dict(run=outcome(pkg, res), ref=ref)


@pytest.fixture(scope="module")
def igg_integrity(tmp_path_factory):
    try:
        return flow_member_integrity(Pkg("igg"),
                                     tmp_path_factory.mktemp("integrity"))
    finally:
        igg.finalize_global_grid()


def test_member_integrity_violation_matches_igg(igg_integrity, tmp_path):
    """igg's test_ensemble_member_violation_isolated_and_bit_exact: a
    finite corruption of member 2 is an integrity_violation on lane 2 at
    the next probe, rolled back alone, and every lane ends bitwise the
    clean run; the events equal igg's."""
    port = flow_member_integrity(Pkg("port"), tmp_path)
    run = port["run"]
    ks = kinds(run)
    assert "member_diverged" not in ks
    viol = first(run, "integrity_violation")
    assert viol[1] == 25 and viol[2]["members"] == [2]
    assert viol[2]["invariants"] == {"2": ["total_heat"]}
    assert ks.index("member_rollback") < ks.index("integrity_resolved")
    assert run["quarantined"] == [] and run["retries"] == {2: 1}
    np.testing.assert_array_equal(run["T"], port["ref"])
    assert run["events"] == igg_integrity["run"]["events"]
    _same_state(run["T"], igg_integrity["run"]["T"])


def test_member_violation_rolls_back_older_than_the_probe(tmp_path):
    """The port's rule (igg scans at or below the violating probe, ROADMAP
    Queue C): with `checkpoint_every == watch_every` and the probes read
    late (held not ready through the readiness seam, one pending), the
    cadence generation at the violating probe's step is written from the
    corrupted, finite lane before that probe is read.  The rollback takes
    the older generation, the lane is repaired on its first retry, and
    every lane ends bitwise the clean run."""
    pkg = Pkg("port")
    pkg.init()
    states = pkg.states(4)
    ref = pkg.ref(states, 40)
    with pkg.never_ready(), it.chaos.silent_corruption(
            "T", step=22, magnitude=30.0, member=2):
        res = pkg.run(states, 40, watch_every=5, checkpoint_dir=tmp_path,
                      checkpoint_every=5, max_pending_probes=1,
                      integrity=_heat(pkg), install_sigterm=False)
    seq = [(e.kind, e.step) for e in res.events]
    assert seq.index(("checkpoint", 25)) < seq.index(
        ("integrity_violation", 25))
    rb = [e for e in res.events if e.kind == "member_rollback"]
    assert [(e.step, e.detail["members"]) for e in rb] == [(20, [2])]
    assert res.quarantined == [] and res.retries == {2: 1}
    np.testing.assert_array_equal(res.state["T"].numpy(), ref)


def test_run_ensemble_adds_no_host_syncs(monkeypatch):
    """The zero-host-syncs sentinel over `run_ensemble` (the port's form
    of igg's, as in tests/test_torch_telemetry.py): with a probe every 4
    steps, integrity rows on it and the diffusion member step on its plain
    route, the only call that reads a tensor on the host is each probe's
    read; with no probe there is none.  Both runs end bitwise alike."""
    from igg_torch.models import diffusion3d as t3

    pkg = Pkg("port")
    pkg.init()
    states = pkg.states(3, cp=True)
    for st, s in zip(states, (0.5, 0.75, 1.0)):
        st["dt_scale"] = torch.tensor(s, dtype=torch.float64)
    step = t3.make_member_step(t3.Params(), use_kernels=False)
    cfg = tinteg.IntegrityConfig(
        check_every=0, tol=1.0,
        invariants=[tinteg.Invariant("total_heat", ("T",))])
    calls = []
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: calls.append("synchronize"))

    def run(**kw):
        calls.clear()
        res = pkg.run(states, 40, step, install_sigterm=False, **kw)
        return list(calls), res

    bare, r0 = run(watch_every=0)
    probed, r1 = run(watch_every=4, integrity=cfg)
    assert bare == [] and probed == ["numpy"] * 10
    assert r1.events == []
    assert torch.equal(r0.state["T"], r1.state["T"])


def _igg_probe(stacked_T, invariants, members):
    from igg.ensemble import _build_probe, _choose_packing

    pk = _choose_packing(igg.get_global_grid(), members, "grid", None)
    probe = _build_probe(pk, ["T"], {"T": 4}, probe_fields=["T"],
                         invariants=invariants)
    return np.asarray(probe(jax.device_put(stacked_T, pk.sharding(4))))


@pytest.mark.parametrize("periodic", [True, False])
def test_probe_matrix_matches_igg(periodic):
    """The per-member probe matrix (counts, then each invariant's value
    and scale rows over owned cells) equals igg's: counts exactly, the
    float32 sums within 2e-6 of their scale.  A NaN in a cell no block
    owns (lane 1) spoils igg's sums (its owned-cell mask multiplies by 0)
    and not the port's (it sums owned cells only); the count row flags
    that lane in both."""
    kw = {} if periodic else dict(periodx=0, periody=0, periodz=0)
    invs = {}
    mats = {}
    for name in ("igg", "port"):
        pkg = Pkg(name)
        pkg.init(**kw)
        integ = pkg.mod.integrity
        invs[name] = [integ.Invariant("heat", ("T",)),
                      integ.Invariant("energy", ("T",), moment=2,
                                      kind="bounded")]
        lanes = pkg.states(4, seed=11)
        stacked = np.stack([pkg.host(st["T"]) for st in lanes])
        stacked[1, 3, 4, 5] = np.nan
        stacked[3, 0, 0, 0] = np.inf
        if name == "igg":
            mats[name] = _igg_probe(stacked, invs[name], 4)
        else:
            t = [{"T": torch.from_numpy(a.copy())} for a in stacked]
            mats[name] = ens.probe_matrix(t, ["T"], ["T"], invs[name],
                                          it.get_global_grid()).numpy()
        pkg.mod.finalize_global_grid()
    got, want = mats["port"], mats["igg"]
    assert got.shape == want.shape == (5, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[0]) == [0, 1, 0, 1]
    fin = np.isfinite(want)
    assert not fin[1:, 1].any() and np.isfinite(got[1:, 1]).all()
    assert not fin[1:, 3].any() and not np.isfinite(got[1:, 3]).any()
    np.testing.assert_array_equal(np.isfinite(got[:, [0, 2]]),
                                  fin[:, [0, 2]])
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=2e-6 * scale)


def test_member_refs_equal_igg():
    """`MemberRefs` decodes the same blocks to the same verdicts: anchor,
    a lane that drifts, a lane whose reference was NaN, a bounded
    invariant that may shrink, an unaccountable lane."""
    mk = {}
    for name, mod in (("igg", igg.integrity), ("port", tinteg)):
        invs = [mod.Invariant("heat", ("T",)),
                mod.Invariant("energy", ("T",), moment=2, kind="bounded",
                              tol=1e-2)]
        mk[name] = mod.MemberRefs(invs, 3, 1e-3)
    rng = np.random.default_rng(0)
    base = rng.random((4, 3)).astype(np.float32) + 1.0
    base[:, 2] = np.nan
    blocks = [base, base + 1e-5, base * np.array([1, 1.01, 1], np.float32),
              base * np.array([0.5, 1, 1], np.float32)]
    blocks[1][:, 2] = 1.0
    lanes = [np.array([True, True, True]), np.array([True, True, True]),
             np.array([True, True, False]), np.array([True, False, True])]
    for block, ln in zip(blocks, lanes):
        got = [mk[n].check(block.copy(), ln) for n in ("igg", "port")]
        assert got[0] == got[1]
    assert mk["port"].rows() == 4


# ---------------------------------------------------------------------------
# Member-targeted chaos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [None, (2, 3, 4), (0, 11, 11)])
@pytest.mark.parametrize("member", [0, 2, None])
def test_member_poison_matches_igg(member, index):
    """`_poison(member=)` (ChaosPlan's member entries) and the silent
    corruption's member tap, on the ensemble's lane form (the lanes'
    list), hit igg's cell of the stacked array, copy only that lane and
    leave the input as it was; a member entry on one tensor raises."""
    from igg import chaos as gchaos

    if member is None and index is not None:
        index = (1,) + index        # igg's full stacked index
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 12, 12, 12))
    want = np.asarray(gchaos._poison(jax.device_put(a), index, member=member))
    src = torch.from_numpy(a.copy())
    lanes = list(src)
    out = it.chaos._poison(lanes, index, member=member)
    np.testing.assert_array_equal(np.isnan(torch.stack(out).numpy()),
                                  np.isnan(want))
    assert sum(o is l for o, l in zip(out, lanes)) == 2
    assert torch.equal(src, torch.from_numpy(a))
    if member is None:
        return
    with pytest.raises(it.GridError, match="lane of an ensemble"):
        it.chaos._poison(src, index, member=member)
    seen = {}
    for name, mod, arr in (("igg", gchaos, jax.device_put(a)),
                           ("port", it.chaos, list(src))):
        inj = mod.silent_corruption("T", step=4, magnitude=2.5,
                                    member=member, index=index)
        log = []
        res = inj._tap({"T": arr}, 4, lambda k, s, **d: log.append((k, d)))
        T = res["T"]
        seen[name] = (np.asarray(torch.stack(T) if name == "port" else T),
                      _plain(log))
    np.testing.assert_array_equal(seen["port"][0], seen["igg"][0])
    assert seen["port"][1] == seen["igg"][1]
    assert torch.equal(src, torch.from_numpy(a))
    with pytest.raises(it.GridError, match="lane of an ensemble"):
        it.chaos.silent_corruption("T", step=4, member=member)._tap(
            {"T": src}, 4, lambda *a, **k: None)


def test_member_chaos_parse_and_range_equal_igg():
    for pkg in (igg, it):
        plan = pkg.chaos.ChaosPlan(nan_at=[(3, 1, "T"), (4, 0, "T", (1, 2, 3)),
                                           (5, "T")])
        assert plan.nan_at == ((3, 1, "T", None), (4, 0, "T", (1, 2, 3)),
                               (5, None, "T", None))
    a = np.zeros((2, 4, 4, 4))
    msgs = []
    for poison, arr in ((igg.chaos._poison, jax.device_put(a)),
                        (it.chaos._poison, list(torch.from_numpy(a)))):
        with pytest.raises(GridErrorBoth) as ei:
            poison(arr, None, member=2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(it.GridError, match="pass member="):
        it.chaos.silent_corruption("T", 0)._tap(
            {"T": [torch.zeros(4, 4, 4)]}, 0, lambda *a, **k: None)


GridErrorBoth = (igg.GridError, it.GridError)


def test_telemetry_names_equal_igg(tmp_path):
    """The session's run records, `step_stats` member rates and the
    member-step counter carry igg's names (igg's
    test_ensemble_emits_member_rates_and_unified_events)."""
    pkg = Pkg("port")
    pkg.init()
    before = it.telemetry.snapshot().get("igg_member_steps_total",
                                         {}).get("value", 0)
    res = pkg.run(pkg.states(4), 20, watch_every=5,
                  telemetry=tmp_path / "t", install_sigterm=False)
    assert res.steps_done == 20
    recs = [json.loads(line) for line in
            (tmp_path / "t" / "events_r0.jsonl").read_text().splitlines()]
    started = [r for r in recs if r["kind"] == "run_started"]
    assert started[0]["payload"]["run"] == "ensemble"
    assert started[0]["payload"]["members"] == 4
    assert started[0]["payload"]["packing"] == "grid"
    stats = [r for r in recs if r["kind"] == "step_stats"]
    assert stats and stats[-1]["payload"]["members_active"] == 4
    assert stats[-1]["payload"]["member_steps_per_s"] == pytest.approx(
        4 * stats[-1]["payload"]["steps_per_s"])
    snap = it.telemetry.snapshot()
    assert snap["igg_member_steps_total"]["value"] - before == 4 * 20
