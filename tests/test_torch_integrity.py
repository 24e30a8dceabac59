"""The port's numeric-integrity layer (igg_torch.integrity) held against
igg's on the CPU, then the port's counterparts of igg's own cases
(tests/test_integrity.py).

igg runs on its 8 virtual CPU devices, the port with `device="cpu"` and
the same blocks stacked, from the same seeded numpy inputs; igg's runs are
shared through module-scoped fixtures.

- **Probe values.**  The fused probe's vectors (igg's layout: counts,
  per-block value partials, scale partials, shadow diff and magnitude
  partials) equal igg's `_build_probe` vectors of the same kind within
  rtol 1e-6, with an absolute floor of 1e-6 of the largest magnitude in
  the vector (a zero-mean sum's float32 rounding is set by its terms, not
  by its value); the decoded values and scales too.  igg's probe cannot
  take a 2-D field on its 3-D mesh (its count's `psum` over the z axis
  meets a value that does not vary along z and is refused), so wave2d's
  staggered `(P, Vx, Vy)` is held to igg's ownership algebra
  (`igg.checkpoint._owned_slice` per block) in float64, within the same
  tolerance.
- **Events and final state.**  diffusion3d (uniform heat capacity, so
  total heat is conserved) with `silent_corruption("T", step=27,
  rank=3)`, `watch_every=5`, `checkpoint_every=10`, `check_every=0` and
  `check_every=1`: igg's event kinds and steps (no generation at the
  violation's step exists, so the port's older-than rollback rule picks
  igg's target), the same invariant, source and rank; the final state is
  bitwise the port's uninterrupted run and within the float64 tolerance
  of tests/test_torch_diffusion.py of igg's.
- **Stamps.**  A generation written under integrity carries igg's entries
  field for field (`ref`/`scale` within rtol 1e-6 of the scale); each
  side's generation deep-verifies in the other, and a poisoned copy is
  refused by both.
"""

import json
import pathlib
import shutil

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
from igg_torch import integrity as integ
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as t3
from torch_threads import one_torch_thread  # noqa: F401

PERIODIC = dict(periodx=1, periody=1, periodz=1)
OPEN = dict(periodx=0, periody=0, periodz=0)
LOCAL = (6, 6, 6)
ATOL = 1e-12            # float64, as in tests/test_torch_diffusion.py
RTOL = 1e-6             # the probe's float32 sums against igg's
N = 60


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()
    tel.reset_metrics()
    yield
    from igg_torch import resilience

    resilience._CHAOS_STATE_TAP = None
    if it.grid_is_initialized():
        it.finalize_global_grid()
    degrade.reset()


def close(got, want):
    """`got` within RTOL of `want`, the floor 1e-6 of `want`'s largest
    magnitude."""
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


# -- the inputs -----------------------------------------------------------------

# Probe cases: (grid kwargs, dtype).  Fields: T (the invariant's), U
# (watched only), M (int32, watched: a zero count row).
PROBE_CASES = {
    "periodic-f32": (PERIODIC, np.float32),
    "periodic-f64": (PERIODIC, np.float64),
    "open-f32": (OPEN, np.float32),
    "open-f64": (OPEN, np.float64),
}
WATCH = ["T", "U", "M"]
KINDS = ("steady", "anchor", "wide")


def invariants(pkg):
    return [pkg.integrity.Invariant("heat", ("T",), moment=1),
            pkg.integrity.Invariant("energy", ("T", "U"), moment=2,
                                    kind="bounded")]


def probe_arrays(dims, local, dtype, seed=7):
    """The probe inputs as stacked numpy arrays: T, U, M, and the truth of
    each watched field (T and U perturbed, M equal)."""
    rng = np.random.default_rng(seed)
    shp = tuple(l * d for l, d in zip(local, dims))
    T = rng.standard_normal(shp).astype(dtype)
    U = (2.0 + rng.standard_normal(shp)).astype(dtype)
    M = rng.integers(0, 5, shp).astype(np.int32)
    truth = {"T": (T + 0.01 * rng.standard_normal(shp)).astype(dtype),
             "U": (U - 0.02 * rng.standard_normal(shp)).astype(dtype),
             "M": M}
    return {"T": T, "U": U, "M": M}, truth


def seeded_state(local=LOCAL, seed=3):
    """Stacked T (halo-consistent on the igg grid) and a uniform Cp, as
    numpy arrays (uniform heat capacity: total heat is conserved)."""
    g = igg.get_global_grid()
    shp = tuple(s * d for s, d in zip(local, g.dims))
    T = np.random.default_rng(seed).standard_normal(shp)
    T = np.asarray(igg.update_halo(jax.device_put(T, sharding_for(3))))
    return {"T": T, "Cp": np.ones(shp)}


def igg_state(arrays):
    return {k: jax.device_put(v, sharding_for(v.ndim))
            for k, v in arrays.items()}


def igg_step():
    step = d3.make_step(d3.Params(), donate=False)
    return lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}


def port_step(**kw):
    step = t3.make_step(t3.Params(), **kw)
    return lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}


def heat_cfg(pkg, **kw):
    kw.setdefault("check_every", 0)
    return pkg.integrity.IntegrityConfig(
        invariants=[pkg.integrity.Invariant("total_heat", ("T",), moment=1,
                                            kind="conserved")], **kw)


def summary(res):
    """(kind, step) of every event but the checkpoints, and the violation's
    (source, invariant or field, rank)."""
    kinds = [(e.kind, e.step) for e in res.events if e.kind != "checkpoint"]
    viol = [(e.detail["source"], e.detail.get("invariant",
                                              e.detail.get("field")),
             e.detail["rank"])
            for e in res.events if e.kind == "integrity_violation"]
    return kinds, viol


@pytest.fixture(scope="module")
def igg_runs(tmp_path_factory):
    """igg's probe vectors, silent-corruption runs and stamped
    generation, as host data."""
    tmp = tmp_path_factory.mktemp("igg_integrity")
    out = {"probe": {}}
    try:
        for case, (periods, dtype) in PROBE_CASES.items():
            igg.init_global_grid(*LOCAL, quiet=True, **periods)
            arrays, truth = probe_arrays(igg.get_global_grid().dims, LOCAL,
                                         dtype)
            ins = [jax.device_put(arrays[n], sharding_for(3))
                   for n in WATCH]
            tru = [jax.device_put(truth[n], sharding_for(3)) for n in WATCH]
            invs = invariants(igg)
            for kind in KINDS:
                probe = igg.integrity._build_probe(WATCH, [], invs, kind)
                out["probe"][case, kind] = np.asarray(
                    probe(*ins, *(tru if kind == "wide" else [])))
            igg.finalize_global_grid()

        igg.init_global_grid(*LOCAL, quiet=True, **PERIODIC)
        arrays = seeded_state()
        out["arrays"] = arrays
        fn = igg_step()
        st = igg_state(arrays)
        for _ in range(N):
            st = fn(st)
        out["clean"] = np.asarray(st["T"])
        for ce in (0, 1):
            with igg.chaos.silent_corruption("T", step=27, magnitude=25.0,
                                             rank=3):
                res = igg.run_resilient(
                    fn, igg_state(arrays), N, watch_every=5,
                    checkpoint_dir=tmp / f"sdc{ce}", checkpoint_every=10,
                    integrity=igg.integrity.IntegrityConfig(check_every=ce),
                    install_sigterm=False)
            out[f"sdc{ce}"] = (summary(res), np.asarray(res.state["T"]))
        # A generation written under integrity (the ring's step-20 one).
        ring = tmp / "stamped"
        igg.run_resilient(fn, igg_state(arrays), 20, watch_every=5,
                          checkpoint_dir=ring, checkpoint_every=10,
                          integrity=heat_cfg(igg), async_checkpoint=False,
                          install_sigterm=False)
        out["stamped"] = ring / "ckpt_000000020"
    finally:
        if igg.grid_is_initialized():
            igg.finalize_global_grid()
    return out


def port_grid(local=LOCAL, **periods):
    it.init_global_grid(*local, quiet=True, device="cpu", nprocs=8,
                        **(periods or PERIODIC))


# -- against igg ----------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_vectors_match_igg(igg_runs, case):
    """Steady, anchor and wide vectors equal igg's, the non-float field's
    count row 0; the decoded values, scales and shadow rows too."""
    periods, dtype = PROBE_CASES[case]
    port_grid(**periods)
    arrays, truth = probe_arrays(it.get_global_grid().dims, LOCAL, dtype)
    ins = [torch.from_numpy(arrays[n]) for n in WATCH]
    tru = [torch.from_numpy(truth[n]) for n in WATCH]
    invs = invariants(it)
    ndev = it.get_global_grid().nprocs
    for kind in KINDS:
        vec = integ._build_probe(WATCH, [], invs, kind)(
            *ins, *(tru if kind == "wide" else []))
        assert vec.dtype == torch.float32 and vec.device.type == "cpu"
        want = igg_runs["probe"][case, kind]
        got = vec.numpy()
        assert got.shape == want.shape
        assert got[2] == 0 and want[2] == 0          # M's count row
        close(got, want)
    # The anchored references decode alike from both vectors.
    mon = integ.Monitor(integ.IntegrityConfig(invariants=invs),
                        dict(zip(WATCH, ins)), WATCH, 5, 1)
    ref = integ.Monitor(integ.IntegrityConfig(invariants=invs),
                        dict(zip(WATCH, ins)), WATCH, 5, 1)
    mon.decode(integ._build_probe(WATCH, [], invs, "anchor")(*ins).numpy(),
               ("anchor", ndev), 5)
    ref.decode(igg_runs["probe"][case, "anchor"], ("anchor", ndev), 5)
    for key in mon.vs_keys:
        close([mon._ref_vals[key], mon._ref_scales[key]],
              [ref._ref_vals[key], ref._ref_scales[key]])
        close(mon._ref_partials[key], ref._ref_partials[key])
    mon.close()
    ref.close()


def test_staggered_wave2d_partials_match_igg_ownership():
    """wave2d's `(P, Vx, Vy)` on a 2-D grid with an open x and a periodic
    y: the probe's per-block partials of each field's moments equal
    igg's owned-slice algebra per block, in float64."""
    from igg.checkpoint import _owned_slice

    it.init_global_grid(6, 6, 1, quiet=True, device="cpu", nprocs=8,
                        periodx=0, periody=1)
    g = it.get_global_grid()
    meta = {"overlaps": list(g.overlaps), "nxyz": list(g.nxyz),
            "dims": list(g.dims), "periods": list(g.periods)}
    rng = np.random.default_rng(11)
    fields = {}
    for name, stag in (("P", (0, 0)), ("Vx", (1, 0)), ("Vy", (0, 1))):
        shp = tuple((n + s) * d for n, s, d in zip((6, 6), stag, g.dims))
        fields[name] = rng.standard_normal(shp).astype(np.float32)
    inv = it.integrity.Invariant("wave_energy", ("P", "Vx", "Vy"),
                                 moment=2, kind="bounded", tol=0.25,
                                 requires_periodic=False)
    watch = ["P", "Vx", "Vy"]
    vec = integ._build_probe(watch, [], [inv], "anchor")(
        *[torch.from_numpy(fields[n]) for n in watch]).numpy()
    ndev = g.nprocs
    assert vec.shape == (3 + 2 * 3 * ndev,)
    for i, name in enumerate(watch):
        a = fields[name].astype(np.float64)
        local = [a.shape[d] // g.dims[d] for d in range(2)]
        want = np.zeros(ndev)
        for r in range(ndev):
            cx, cy, cz = g.cart_coords(r)
            if cz:
                continue    # a 2-D field counts at z coordinate 0
            block = a[cx * local[0]:(cx + 1) * local[0],
                      cy * local[1]:(cy + 1) * local[1]]
            want[r] = (block[_owned_slice(block.shape, (cx, cy), meta)]
                       ** 2).sum()
        got = vec[3 + i * ndev:3 + (i + 1) * ndev]
        close(got, want)
        # m = 2: the scale rows repeat the value rows.
        np.testing.assert_array_equal(
            vec[3 + (3 + i) * ndev:3 + (4 + i) * ndev], got)


@pytest.mark.parametrize("check_every", [0, 1])
def test_silent_corruption_events_match_igg(igg_runs, tmp_path, check_every):
    port_grid()
    fn = port_step()
    with it.chaos.silent_corruption("T", step=27, magnitude=25.0, rank=3):
        res = it.run_resilient(
            fn, convert.to_torch(igg_runs["arrays"]), N, watch_every=5,
            checkpoint_dir=tmp_path, checkpoint_every=10,
            integrity=integ.IntegrityConfig(check_every=check_every),
            install_sigterm=False)
    (kinds, viol), T_igg = igg_runs[f"sdc{check_every}"]
    assert summary(res) == (kinds, viol)
    assert ("integrity_violation", 30) in kinds and "nan_detected" not in \
        [k for k, _ in kinds]
    assert viol == [("invariant", "total_heat", 3)]
    st = convert.to_torch(igg_runs["arrays"])
    for _ in range(N):
        st = fn(st)
    assert torch.equal(res.state["T"], st["T"])
    np.testing.assert_allclose(res.state["T"].numpy(), T_igg, rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(T_igg, igg_runs["clean"], rtol=0, atol=ATOL)


def _stamps(gen):
    return json.loads((pathlib.Path(gen) / "manifest.json").read_text())[
        "deep"]["invariants"]


def test_stamps_match_igg_and_cross_verify(igg_runs, tmp_path):
    port_grid()
    it.run_resilient(port_step(), convert.to_torch(igg_runs["arrays"]), 20,
                     watch_every=5, checkpoint_dir=tmp_path / "ring",
                     checkpoint_every=10, integrity=heat_cfg(it),
                     async_checkpoint=False, install_sigterm=False)
    mine = tmp_path / "ring" / "ckpt_000000020"
    got, want = _stamps(mine), _stamps(igg_runs["stamped"])
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("name", "fields", "moment", "kind",
                                  "tol")} == \
            {k: w[k] for k in ("name", "fields", "moment", "kind", "tol")}
        assert g["ref"] is not None and g["scale"] is not None
        close([g["ref"], g["scale"]], [w["ref"], w["scale"]])
    theirs = tmp_path / "igg_gen"
    shutil.copytree(igg_runs["stamped"], theirs)
    for gen in (mine, theirs):
        assert it.verify_checkpoint(gen, check_finite=True, deep=True)
        assert igg.verify_checkpoint(gen, check_finite=True, deep=True)
        bad = gen.with_name(gen.name + "_poisoned")
        shutil.copytree(gen, bad)
        it.chaos.poison_checkpoint(bad, field="T", magnitude=25.0, shard=3)
        assert it.verify_checkpoint(bad, check_finite=True)
        assert not it.verify_checkpoint(bad, deep=True)
        assert not igg.verify_checkpoint(bad, deep=True)


def test_public_names_equal_iggs():
    assert it.NNEIGHBORS_PER_DIM == igg.shared.NNEIGHBORS_PER_DIM
    assert it.__version__ == igg.__version__
    for name in ("NNEIGHBORS_PER_DIM", "integrity"):
        assert name in it.__all__


# -- the port's counterparts of igg's cases (tests/test_integrity.py) -----------

def _grid(**kw):
    port_grid(**kw)


def _make_step():
    return port_step()


def _init_state(seed=3):
    rng = np.random.default_rng(seed)
    shp = it.stacked_shape(LOCAL)
    T = it.update_halo(torch.from_numpy(rng.standard_normal(shp)))
    return {"T": T, "Cp": torch.ones(shp, dtype=torch.float64)}


def _reference(nt):
    fn, st = _make_step(), _init_state()
    for _ in range(nt):
        st = fn(st)
    return st["T"]


def test_invariant_detects_finite_corruption_nan_watchdog_silent(tmp_path):
    _grid()
    ref = _reference(60)
    with it.chaos.silent_corruption("T", step=27, magnitude=25.0, rank=3):
        res = it.run_resilient(_make_step(), _init_state(), 60,
                               watch_every=5, checkpoint_dir=tmp_path,
                               checkpoint_every=10, integrity=heat_cfg(it),
                               install_sigterm=False)
    kinds = [e.kind for e in res.events]
    assert "nan_detected" not in kinds
    viol = next(e for e in res.events if e.kind == "integrity_violation")
    assert viol.step == 30
    assert viol.detail["source"] == "invariant"
    assert viol.detail["invariant"] == "total_heat"
    assert viol.detail["rank"] == 3 and viol.detail["device"] == "cpu"
    assert viol.detail["partials"][3] == max(viol.detail["partials"])
    rb = next(e for e in res.events if e.kind == "rollback")
    assert rb.step < viol.step
    assert kinds.index("rollback") < kinds.index("integrity_resolved")
    assert res.retries == 1
    assert torch.equal(res.state["T"], ref)


def test_rollback_skips_poisoned_generation_via_deep_verify(tmp_path):
    """A generation at the violating probe's step holds the corrupted
    state: the rollback takes only older ones, and of those the newest
    that deep-verifies."""
    _grid()
    ref = _reference(60)
    with it.chaos.silent_corruption("T", step=23, magnitude=25.0, rank=1):
        res = it.run_resilient(_make_step(), _init_state(), 60,
                               watch_every=5, checkpoint_dir=tmp_path,
                               checkpoint_every=5, integrity=heat_cfg(it),
                               max_pending_probes=8, install_sigterm=False)
    viol = next(e for e in res.events if e.kind == "integrity_violation")
    rb = next(e for e in res.events if e.kind == "rollback")
    assert rb.step < viol.step <= 30
    assert torch.equal(res.state["T"], ref)


def test_older_than_rollback_skips_a_generation_at_the_violation(tmp_path):
    """The port's rule (igg scans at or below the violating step): a
    generation written at the violation's step from the corrupted state,
    which a shadow catch leaves deep-consistent, is never the target."""
    _grid()
    ref = _reference(20)
    seen = []

    def spy(ev):
        if ev.kind == "integrity_violation":
            # The corrupted state's generation lands at the probe step
            # before the rollback scans (as a background writer would).
            seen.append(ev.step)

    cfg = integ.IntegrityConfig(invariants=[], check_every=1)
    fn = _make_step()
    real = integ.Monitor.decode

    def decode_after_save(self, host, tag, step_p):
        out = real(self, host, tag, step_p)
        if out[1] is not None and not seen:
            it.save_checkpoint_sharded(
                tmp_path / f"ckpt_{step_p:09d}", **self._live)
        return out

    real_dispatch = integ.Monitor.dispatch

    def dispatch(self, state, steps_done, step_fn):
        self._live = state
        return real_dispatch(self, state, steps_done, step_fn)

    integ.Monitor.decode, integ.Monitor.dispatch = decode_after_save, \
        dispatch
    try:
        with it.chaos.silent_corruption("T", step=7, magnitude=10.0,
                                        rank=2):
            res = it.run_resilient(fn, _init_state(), 20, watch_every=5,
                                   checkpoint_dir=tmp_path,
                                   checkpoint_every=5, integrity=cfg,
                                   on_event=spy, async_checkpoint=False,
                                   install_sigterm=False)
    finally:
        integ.Monitor.decode, integ.Monitor.dispatch = real, real_dispatch
    rb = next(e for e in res.events if e.kind == "rollback")
    assert seen == [10] and rb.step == 5
    assert torch.equal(res.state["T"], ref)


def test_poisoned_generation_matrix_structural_serves_deep_refuses(
        tmp_path):
    _grid()
    st = _init_state()
    it.save_checkpoint_sharded(tmp_path / "ckpt_000000010", **st)
    it.save_checkpoint_sharded(tmp_path / "ckpt_000000020", **st)
    it.save_checkpoint(tmp_path / "ckpt_000000030.npz", **st)
    it.chaos.poison_checkpoint(tmp_path / "ckpt_000000020", field="T",
                               magnitude=5.0, shard=2)
    it.chaos.poison_checkpoint(tmp_path / "ckpt_000000030.npz", field="T",
                               magnitude=5.0)
    assert ck.verify_checkpoint(tmp_path / "ckpt_000000020",
                                check_finite=True)
    assert ck.verify_checkpoint(tmp_path / "ckpt_000000030.npz",
                                check_finite=True)
    loaded = it.load_checkpoint(tmp_path / "ckpt_000000020")
    assert not torch.equal(loaded["T"], st["T"])
    assert not ck.verify_checkpoint(tmp_path / "ckpt_000000020", deep=True)
    assert not ck.verify_checkpoint(tmp_path / "ckpt_000000030.npz",
                                    deep=True)
    assert ck.verify_checkpoint(tmp_path / "ckpt_000000010", deep=True)
    assert ck.latest_checkpoint(tmp_path, "ckpt", check_finite=True) \
        == tmp_path / "ckpt_000000030.npz"
    assert ck.latest_checkpoint(tmp_path, "ckpt", check_finite=True,
                                deep=True) == tmp_path / "ckpt_000000010"


def test_shadow_check_catches_corruption_with_no_invariant(tmp_path):
    _grid()
    ref = _reference(60)
    cfg = integ.IntegrityConfig(invariants=[], check_every=1)
    with it.chaos.silent_corruption("T", step=2, magnitude=10.0, rank=5):
        res = it.run_resilient(_make_step(), _init_state(), 60,
                               watch_every=5, checkpoint_dir=tmp_path,
                               checkpoint_every=10, integrity=cfg,
                               install_sigterm=False)
    viol = next(e for e in res.events if e.kind == "integrity_violation")
    assert viol.detail["source"] == "shadow"
    assert viol.step == 5 and viol.detail["rank"] == 5
    assert torch.equal(res.state["T"], ref)


def test_shadow_amortization_cadence(tmp_path):
    _grid()
    cfg = heat_cfg(it, check_every=3)
    captured = {}
    orig = integ.Monitor.dispatch

    def spy(self, *a, **kw):
        captured["mon"] = self
        return orig(self, *a, **kw)

    integ.Monitor.dispatch = spy
    try:
        it.run_resilient(_make_step(), _init_state(), 60, watch_every=5,
                         integrity=cfg, install_sigterm=False)
    finally:
        integ.Monitor.dispatch = orig
    mon = captured["mon"]
    # 12 windows; snapshots at windows 0 (entry), 3, 6, 9 -> 4 shadows.
    assert mon.shadow_checks == 4
    assert mon.checks == 12


def test_shadow_snapshot_is_a_clone_replayed_off_the_live_state(tmp_path):
    """A step that writes its input in place: the window-entry snapshot is
    a clone (a reference would be overwritten), the replay runs on it,
    and a healthy run raises no violation and ends bitwise the bare
    loop."""
    _grid()
    step = t3.make_step(t3.Params())

    def in_place(s):
        s["T"].copy_(step(s["T"], s["Cp"]))
        return s

    st = _init_state()
    bare = {k: v.clone() for k, v in st.items()}
    for _ in range(20):
        bare = in_place(bare)
    res = it.run_resilient(in_place, st, 20, watch_every=5,
                           integrity=integ.IntegrityConfig(check_every=1),
                           install_sigterm=False)
    assert [e.kind for e in res.events] == []
    assert torch.equal(res.state["T"], bare["T"])


def test_recurrent_violation_demotes_finitely_miscompiling_tier(tmp_path):
    """On CPU tensors: a kernel tier corrupted by a finite magnitude; the
    shadow against the plain truth tier raises the same violation at the
    same step after the rollback, the recurrence demotes the tier (no
    retry spent) and the plain tier finishes bitwise the truth run."""
    _grid()
    truth = port_step(use_kernels=False)
    st = _init_state()
    for _ in range(20):
        st = truth(st)
    ref = st["T"]
    degrade.reset()
    cfg = integ.IntegrityConfig(invariants=[], check_every=1,
                                truth_step_fn=truth)
    with it.chaos.kernel_corrupt("diffusion3d.cuda", magnitude=1e4):
        fn = port_step()
        res = it.run_resilient(fn, _init_state(), 20, watch_every=5,
                               checkpoint_dir=tmp_path, checkpoint_every=5,
                               integrity=cfg, install_sigterm=False)
    kinds = [e.kind for e in res.events]
    assert "nan_detected" not in kinds
    assert kinds.count("integrity_violation") >= 2
    demo = next(e for e in res.events if e.kind == "tier_degraded")
    assert demo.detail["tier"] == "diffusion3d.cuda"
    assert demo.detail["reason"] == "nan_recurrence"
    assert degrade.active().get("diffusion3d") == "diffusion3d.plain"
    assert res.retries == 1
    assert torch.equal(res.state["T"], ref)


def test_nan_counts_stay_field_aligned_with_nonfloat_watch(tmp_path):
    _grid()
    base = _make_step()
    mask = it.from_local_blocks(
        lambda c, ls: np.ones(ls, dtype=np.int32), LOCAL, dtype=torch.int32)

    def step_fn(st):
        return {"mask": st["mask"], **base({"T": st["T"], "Cp": st["Cp"]})}

    st = {**_init_state(), "mask": mask}
    with pytest.raises(it.ResilienceError) as ei:
        it.run_resilient(step_fn, st, 20, watch_every=5,
                         watch_fields=["mask", "T"], integrity=heat_cfg(it),
                         chaos=it.chaos.ChaosPlan(nan_at=[(7, "T")]),
                         install_sigterm=False)
    ev = next(e for e in ei.value.events if e.kind == "nan_detected")
    assert list(ev.detail["counts"]) == ["T"], ev.detail


def test_silent_corruption_composes_under_armed():
    from igg_torch import resilience as res_mod

    inj = it.chaos.silent_corruption("T", step=3, magnitude=1.0)
    with it.chaos.armed(inj) as got:
        assert got is inj
        assert res_mod._CHAOS_STATE_TAP is not None
    assert res_mod._CHAOS_STATE_TAP is None
    inj._fired = True
    inj.arm()
    assert inj._fired is False
    inj.disarm()
    with pytest.raises(it.GridError, match="FINITE"):
        it.chaos.silent_corruption("T", step=3, magnitude=float("nan"))
    with pytest.raises(it.GridError, match="item 7"):
        it.chaos.silent_corruption("T", step=3, member=2)


def test_silent_corruption_leaves_the_callers_tensor(tmp_path):
    """The injector adds in a copy at `coords(rank) * local + (1, 1, 1)`,
    emits igg's record, and never writes the caller's tensor."""
    _grid()
    st = _init_state()
    before = st["T"].clone()
    seen = []
    inj = it.chaos.silent_corruption("T", step=0, magnitude=2.5, rank=6)
    out = inj._tap(st, 0, lambda k, s, **d: seen.append((k, s, d)))
    assert torch.equal(st["T"], before)
    diff = (out["T"] - before).nonzero().tolist()
    g = it.get_global_grid()
    cx, cy, cz = g.cart_coords(6)
    assert diff == [[cx * 6 + 1, cy * 6 + 1, cz * 6 + 1]]
    assert seen == [("chaos_silent_corruption", 0,
                     {"field": "T", "magnitude": 2.5, "index": diff[0],
                      "rank": 6})]
    assert inj._tap(out, 0, None) is out            # one-shot


def test_config_validation_and_knob_registration():
    _grid()
    with pytest.raises(it.GridError, match="watch cadence"):
        it.run_resilient(_make_step(), _init_state(), 10, watch_every=0,
                         integrity=heat_cfg(it), install_sigterm=False)
    with pytest.raises(it.GridError, match="not in"):
        it.run_resilient(
            _make_step(), _init_state(), 10, watch_every=5,
            integrity=integ.IntegrityConfig(invariants=[
                integ.Invariant("x", ("missing",))]),
            install_sigterm=False)
    assert integ.stamp_entries() is None         # closed on the way out
    with pytest.raises(it.GridError, match="integrity="):
        integ.as_config("yes")
    with pytest.raises(it.GridError, match="moment"):
        integ.Invariant("bad", ("T",), moment=3)
    from igg_torch import _env

    for knob in ("IGG_INTEGRITY", "IGG_INTEGRITY_CHECK_EVERY",
                 "IGG_INTEGRITY_TOL", "IGG_INTEGRITY_DEEP_VERIFY"):
        assert knob in _env._KNOWN
    for name in ("igg_integrity_checks_total",
                 "igg_integrity_shadow_checks_total",
                 "igg_integrity_violations_total"):
        assert tel.metric_help(name) == igg.telemetry.metric_help(name)


def test_env_knob_drives_default(tmp_path, monkeypatch):
    _grid()
    monkeypatch.setenv("IGG_INTEGRITY", "1")
    monkeypatch.setenv("IGG_INTEGRITY_CHECK_EVERY", "0")
    it.run_resilient(_make_step(), _init_state(), 10, watch_every=5,
                     telemetry=tmp_path, install_sigterm=False)
    recs = [json.loads(line) for line in
            (tmp_path / "events_r0.jsonl").read_text().splitlines()]
    cfg = next(r for r in recs if r["kind"] == "integrity_config")
    assert cfg["payload"]["invariants"] == ["total_heat"]
    assert cfg["payload"]["check_every"] == 0
    assert integ.as_config(False) is None


def test_deep_verify_flat_and_sharded_roundtrip(tmp_path):
    _grid()
    st = _init_state()
    it.save_checkpoint(tmp_path / "flat_000000001.npz", **st)
    it.save_checkpoint_sharded(tmp_path / "gen_000000001", **st)
    for p in (tmp_path / "flat_000000001.npz", tmp_path / "gen_000000001"):
        assert ck.verify_checkpoint(p, check_finite=True, deep=True)
    with np.load(tmp_path / "flat_000000001.npz") as z:
        meta = json.loads(bytes(z["__igg_meta__"].tobytes()).decode())
    man = json.loads(
        (tmp_path / "gen_000000001" / "manifest.json").read_text())
    np.testing.assert_allclose(meta["deep"]["sums"]["T"],
                               man["deep"]["sums"]["T"], rtol=1e-12, atol=0)


def test_deep_verify_bf16_fields(tmp_path):
    _grid()
    T = _init_state()["T"].to(torch.bfloat16)
    it.save_checkpoint_sharded(tmp_path / "gen_000000001", T=T)
    it.save_checkpoint(tmp_path / "flat_000000001.npz", T=T)
    assert ck.verify_checkpoint(tmp_path / "gen_000000001", deep=True)
    assert ck.verify_checkpoint(tmp_path / "flat_000000001.npz", deep=True)
    it.chaos.poison_checkpoint(tmp_path / "gen_000000001", magnitude=4.0,
                               shard=1)
    assert ck.verify_checkpoint(tmp_path / "gen_000000001",
                                check_finite=True)
    assert not ck.verify_checkpoint(tmp_path / "gen_000000001", deep=True)


def test_deep_verified_generation_restores_elastically(tmp_path):
    _grid()
    st = _init_state()
    it.save_checkpoint_sharded(tmp_path / "gen_000000001", **st)
    assert ck.verify_checkpoint(tmp_path / "gen_000000001", deep=True)
    interior_ref = it.gather_interior(st["T"])
    it.finalize_global_grid()
    it.init_global_grid(10, 10, 6, dimx=1, dimy=1, dimz=2, quiet=True,
                        device="cpu", nprocs=2, **PERIODIC)
    loaded = it.load_checkpoint(tmp_path / "gen_000000001",
                                redistribute=True)
    assert np.array_equal(it.gather_interior(loaded["T"]), interior_ref)
    it.save_checkpoint_sharded(tmp_path / "gen_000000002", **loaded)
    assert ck.verify_checkpoint(tmp_path / "gen_000000002", deep=True)
    m1 = json.loads(
        (tmp_path / "gen_000000001" / "manifest.json").read_text())
    m2 = json.loads(
        (tmp_path / "gen_000000002" / "manifest.json").read_text())
    np.testing.assert_allclose(m1["deep"]["sums"]["T"],
                               m2["deep"]["sums"]["T"], rtol=1e-12)


def _strip_deep(gen):
    """Rewind a generation to its shape before deep stamps: no `deep` in
    the manifest or the shard metas."""
    from igg_torch.checkpoint import (_META_KEY, _write_atomic_text,
                                      _write_npz)

    gen = pathlib.Path(gen)
    if gen.is_dir():
        mp = gen / "manifest.json"
        man = json.loads(mp.read_text())
        man.pop("deep", None)
        for name in list(man["shards"]):
            sp = gen / name
            with np.load(sp) as z:
                smeta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
                arrays = {k: z[k] for k in z.files if k != _META_KEY}
            smeta.pop("deep", None)
            _write_npz(sp, {**arrays, _META_KEY: np.frombuffer(
                json.dumps(smeta).encode(), dtype=np.uint8)})
        _write_atomic_text(mp, json.dumps(man))
        return
    with np.load(gen) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    meta.pop("deep", None)
    _write_npz(gen, {**arrays, _META_KEY: np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)})


def test_mixed_stamped_unstamped_ordering_and_backward_compat(tmp_path):
    _grid()
    st = _init_state()
    it.save_checkpoint_sharded(tmp_path / "ckpt_000000010", **st)
    it.save_checkpoint_sharded(tmp_path / "ckpt_000000020", **st)
    it.save_checkpoint(tmp_path / "ckpt_000000030.npz", **st)
    _strip_deep(tmp_path / "ckpt_000000020")
    _strip_deep(tmp_path / "ckpt_000000030.npz")
    for p in ("ckpt_000000020", "ckpt_000000030.npz"):
        assert ck.verify_checkpoint(tmp_path / p, check_finite=True)
        loaded = it.load_checkpoint(tmp_path / p)
        assert torch.equal(loaded["T"], st["T"])
        assert not ck.verify_checkpoint(tmp_path / p, deep=True)
    assert ck.latest_checkpoint(tmp_path, "ckpt", check_finite=True) \
        == tmp_path / "ckpt_000000030.npz"
    assert ck.latest_checkpoint(tmp_path, "ckpt", check_finite=True,
                                deep=True) == tmp_path / "ckpt_000000010"
    res = it.run_resilient(_make_step(), _init_state(), 10, watch_every=5,
                           checkpoint_dir=tmp_path, prefix="ckpt",
                           checkpoint_every=0, resume=True,
                           integrity=heat_cfg(it), install_sigterm=False)
    resume = next(e for e in res.events if e.kind == "resume")
    assert resume.step == 10
    assert resume.detail["path"].endswith("ckpt_000000010")


def test_open_boundary_owned_planes_in_deep_stamp(tmp_path):
    _grid(periodx=0, periody=1, periodz=1)
    st = _init_state()
    it.save_checkpoint_sharded(tmp_path / "gen_000000001", **st)
    assert ck.verify_checkpoint(tmp_path / "gen_000000001", deep=True)
    it.chaos.poison_checkpoint(tmp_path / "gen_000000001", field="T",
                               magnitude=3.0, shard=7)
    assert not ck.verify_checkpoint(tmp_path / "gen_000000001", deep=True)


def test_registry_and_auto_match():
    _grid()
    grid = it.get_global_grid()
    from igg_torch.models import diffusion3d, shallow_water, wave2d  # noqa

    fams = integ.registered_families()
    assert {"diffusion3d", "shallow_water", "wave2d"} <= set(fams)
    assert [i.name for i in integ.match_invariants({"T", "Cp"}, grid)] \
        == ["total_heat"]
    assert [i.name for i in integ.match_invariants({"h", "hu", "hv"},
                                                   grid)] == ["total_mass"]
    got = integ.match_invariants({"P", "Vx", "Vy"}, grid)
    assert [(i.name, i.kind) for i in got] == [("wave_energy", "bounded")]
    for fam in ("diffusion3d", "shallow_water", "wave2d"):
        assert [dataclass_fields(i) for i in integ.invariants_for(fam)] == \
            [dataclass_fields(i) for i in igg.integrity.invariants_for(fam)]
    it.finalize_global_grid()
    _grid(periodx=0, periody=1, periodz=1)
    grid = it.get_global_grid()
    assert integ.match_invariants({"T"}, grid) == ()
    assert [i.name for i in integ.match_invariants({"P", "Vx", "Vy"},
                                                   grid)] == ["wave_energy"]


def dataclass_fields(inv):
    return (inv.name, tuple(inv.fields), inv.moment, inv.kind, inv.tol,
            inv.requires_periodic)


def test_stencil_spec_invariants_register_on_compile():
    from igg_torch import stencil as st
    from igg_torch.stencil import shallow_water_spec
    from igg_torch.stencil.library import Invariant

    assert Invariant is integ.Invariant
    spec = shallow_water_spec()
    assert [i.name for i in spec.invariants] == ["total_mass"]
    with pytest.raises(it.GridError, match="not all declared"):
        f = st.Field("a", stagger=(0, 0))
        st.StencilSpec("bad", fields=[f], updates=[st.Update(f, f + 1.0)],
                       invariants=(integ.Invariant("x", ("zz",)),))
    f = st.Field("a", stagger=(0, 0))
    spec = st.StencilSpec("mass_spec", fields=[f],
                          updates=[st.Update(f, f + 0.0, mode="assign")],
                          invariants=(integ.Invariant("a_sum", ("a",)),))
    it.init_global_grid(6, 6, 1, quiet=True, device="cpu", nprocs=4,
                        periodx=1, periody=1)
    st.compile(spec)
    assert [i.name for i in integ.invariants_for("mass_spec")] == ["a_sum"]
