"""The port's communication observability (igg_torch.comm) held against
igg's on the CPU.

igg runs on its 8 virtual CPU devices, the port with `device="cpu"` and the
same 8 blocks stacked, on `init_global_grid(6, 6, 6)` (Stokes 8^3 at
overlap 3), from float64 states made with a numpy seed.  The plane-bytes
model and the exchange accounting equal igg's integers; the counter
reconciles with the model; `_fractions` equals igg's exactly; each
family's step-variant closures and `decompose`'s three variants after
`reps` iterations lie within igg's overlap tolerance of igg's
(tests/test_overlap.py:60: rtol 1e-12, atol 1e-9), and the port's
exchange and hidden variants equal its plain composition bitwise (the
port's overlap contract); comm ledger files cross-load both ways and each
package's `comm report` renders the other's; `rank_skew` and the stall
heartbeat's episode sequence equal igg's; `run_resilient(comm=)` takes
igg's checks and emits igg's `comm_stats` records; the chaos stall and
straggler drive the heartbeat and the windows.  The one deliberate
difference is the wire subset: every block of the port's grid lives in
one process, so no byte is a wire byte (igg counts the dims of several
devices).  igg's runs are shared through module-scoped fixtures.
"""

import json
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg import comm as icomm
from igg import telemetry as itel
from igg.fields import sharding_for, spec_for
from igg.models import diffusion3d as id3
from igg_torch import autotune, comm, convert, degrade, perf
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as td3
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-9)      # igg's, tests/test_overlap.py:60
PERIODIC = dict(periodx=1, periody=1, periodz=1)
OPEN = dict(periodx=0, periody=0, periodz=0)
OL3 = dict(overlapx=3, overlapy=3, overlapz=3)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("IGG_COMM_STALL_TIMEOUT", raising=False)
    monkeypatch.delenv("IGG_TELEMETRY_DIR", raising=False)
    monkeypatch.delenv("IGG_PERF_LEDGER", raising=False)
    for mod in (tel, itel):
        mod.reset_metrics()
        mod._ring().clear()
    perf.reset()
    igg.perf.reset()
    degrade.reset()
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    for s in list(tel._SESSIONS):
        s.detach()
    if it.grid_is_initialized():
        it.finalize_global_grid()
    if igg.grid_is_initialized():
        igg.finalize_global_grid()
    degrade.reset()
    perf.reset()
    igg.perf.reset()


def port_grid(local=(6, 6, 6), nprocs=8, **kw):
    it.init_global_grid(*local, quiet=True, device="cpu", nprocs=nprocs,
                        **kw)


def igg_grid(local=(6, 6, 6), one_block=False, **kw):
    if one_block:
        kw["devices"] = jax.devices()[:1]
    igg.init_global_grid(*local, quiet=True, **kw)


def seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def to_igg(arrays):
    return tuple(jax.device_put(a, sharding_for(a.ndim)) for a in arrays)


def to_port(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def counter(mod, key):
    return mod.snapshot().get(key, {}).get("value", 0.0)


# ---------------------------------------------------------------------------
# The accounting
# ---------------------------------------------------------------------------

GRIDS = {
    "periodic_one_block": dict(one_block=True, **PERIODIC),
    "open_2x2x2": dict(**OPEN),
    "periodic_2x2x2": dict(**PERIODIC),
    "mixed_4x2x1": dict(dimx=4, dimy=2, dimz=1, **PERIODIC),
}


def grid_pair(name):
    kw = dict(GRIDS[name])
    one = kw.pop("one_block", False)
    igg_grid(one_block=one, **kw)
    port_grid(nprocs=1 if one else 8, **kw)
    assert tuple(it.get_global_grid().dims) == \
        tuple(igg.get_global_grid().dims)


@pytest.mark.parametrize("nfields", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_accounting_equals_iggs(name, dtype, nfields):
    """`plane_bytes_model` (total and by mode) and `_exchange_accounting`
    (bytes, moving dims, label, path) equal igg's integers; the wire subset
    is 0 in the port (one process), igg's the dims of several devices."""
    grid_pair(name)
    local = (6, 6, 6)
    want = icomm.plane_bytes_model(local, np.dtype(dtype), nfields=nfields)
    got = comm.plane_bytes_model(local, getattr(torch, dtype),
                                 nfields=nfields)
    assert got == want and got[0] > 0
    assert comm.plane_bytes_model(local, np.dtype(dtype),
                                  nfields=nfields) == want
    a_igg = icomm._exchange_accounting(local, np.dtype(dtype), nfields,
                                       igg.get_global_grid())
    a_port = comm._exchange_accounting(local, getattr(torch, dtype), nfields,
                                       it.get_global_grid())
    for key in ("bytes_per_update", "moving_dims", "dims_label", "path"):
        assert a_port[key] == a_igg[key], key
    assert a_port["wire_bytes_per_update"] == 0
    dims = igg.get_global_grid().dims
    assert (a_igg["wire_bytes_per_update"] > 0) == any(d > 1 for d in dims)


@pytest.mark.parametrize("name", ["periodic_2x2x2", "mixed_4x2x1",
                                  "periodic_one_block"])
def test_counter_reconciles_with_the_model(name):
    """One `update_halo` of two fields advances the unlabeled counter by
    exactly the model's total, and the labeled ones by its modes."""
    grid_pair(name)
    igg.finalize_global_grid()
    A = it.zeros((6, 6, 6), dtype=torch.float64) + 1.0
    B = it.zeros((6, 6, 6), dtype=torch.float64) + 2.0
    before = counter(tel, "igg_halo_plane_bytes_total")
    it.update_halo(A, B)
    total, by_mode = comm.plane_bytes_model((6, 6, 6), torch.float64,
                                            nfields=2)
    assert counter(tel, "igg_halo_plane_bytes_total") - before == total
    assert sum(counter(tel, f'igg_halo_plane_bytes_total{{dim="{d}",'
                            f'mode="{m}"}}') for d, m in by_mode) == total


def test_link_peak_table():
    assert comm.link_peak_gbps("NVIDIA H100 80GB HBM3") == 900.0
    for name in ("cpu", None, "", "NVIDIA A100-SXM4-80GB"):
        assert comm.link_peak_gbps(name) is None


def test_calibrate_comm_records_ledger_sample_and_gauges(tmp_path,
                                                         monkeypatch):
    """igg's sample keys, tier and ledger key; no percent gauge (no wire
    byte, no CPU peak)."""
    monkeypatch.setenv("IGG_PERF_LEDGER", str(tmp_path / "ledger.json"))
    igg_grid(**PERIODIC)
    want = icomm.calibrate_comm(nfields=2, n_inner=2, nt=1)
    port_grid(**PERIODIC)
    got = comm.calibrate_comm(nfields=2, n_inner=2, nt=1)
    assert set(got) == set(want)
    for key in ("tier", "path", "bytes_per_update", "nfields",
                "local_shape", "dtype", "dims", "backend", "device_kind",
                "link_peak_gbps", "pct_link_peak", "source"):
        assert got[key] == want[key], key
    assert got["gbps"] > 0 and got["wire_bytes_per_update"] == 0
    snap = tel.snapshot()
    assert snap['igg_halo_gbps{path="grouped"}']["value"] == \
        pytest.approx(got["gbps"])
    assert not any(k.startswith("igg_pct_link_peak") for k in snap)
    (e,) = perf.query("comm")
    assert (e["tier"], tuple(e["dims"]), e["dtype"], e["backend"]) == \
        ("halo.xyz.grouped", (2, 2, 2), "float32", "cpu")
    assert any(r.kind == "comm_sample" for r in tel.flight_recorder())


def test_calibrate_comm_edges():
    """Nothing moves on one open block: None, as igg's.  Caller's fields
    are exchanged in place and equal the plain writer's update; igg's
    `assembly=` raises naming the port's `plain=`."""
    port_grid(nprocs=1, **OPEN)
    assert comm.calibrate_comm(n_inner=2, nt=1) is None
    assert perf.query("comm") == []
    it.finalize_global_grid()
    port_grid(**OPEN)
    X = torch.from_numpy(seeded(it.stacked_shape((6, 6, 6)), 5))
    want = it.update_halo(X.clone(), plain=True)
    s = comm.calibrate_comm(fields=(X,), n_inner=2, nt=1)
    assert s["dtype"] == "float64" and s["nfields"] == 1
    assert torch.equal(X, want)
    with pytest.raises(it.GridError, match="plain=True"):
        comm.calibrate_comm(assembly="writer")


@pytest.mark.parametrize("times", [(1.0, 2.0, 1.5), (2.0, 1.0, 1.5),
                                   (1.0, 2.0, 3.0), (1.0, 2.0, 0.5),
                                   (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)])
def test_fractions_equal_iggs(times):
    t = dict(zip(("compute", "exchange", "hidden"), times))
    assert comm._fractions(t) == icomm._fractions(t)


# ---------------------------------------------------------------------------
# The step variants
# ---------------------------------------------------------------------------

FAMILIES = {
    "diffusion3d": dict(local=(6, 6, 6), kw=dict(**OPEN), seed=11,
                        scales=[(0.0, 1.0), (2.0, 0.2)]),
    "hm3d": dict(local=(6, 6, 6), kw=dict(periodx=1, periody=0, periodz=1),
                 seed=21, scales=[(-0.5, 0.1), (0.1, 0.01)]),
    "stokes3d": dict(local=(8, 8, 8), kw=dict(**OPEN, **OL3), seed=31,
                     scales=[(0.0, 0.1)] * 4 + [(1.0, 0.1)]),
}
REPS = 2


def family_state(name, dims):
    f = FAMILIES[name]
    mv = icomm.model_step_variants(name)
    out = []
    for i, (st, (lo, sc)) in enumerate(zip(mv["stagger"], f["scales"])):
        shp = tuple((n + s) * d for n, s, d in zip(f["local"], st, dims))
        out.append(lo + sc * seeded(shp, f["seed"] + i))
    return out


def igg_program(fn, nf, S):
    """`fn` over local blocks as one SPMD program on igg's mesh, returning
    the `nf` primaries (igg's `_build_variant` wrapping)."""
    specs = tuple(spec_for(a.ndim) for a in S)
    prog = jax.shard_map(lambda *A: tuple(fn(*A)) if nf > 1 else (fn(*A),),
                         mesh=igg.get_global_grid().mesh, in_specs=specs,
                         out_specs=specs[:nf])
    return jax.jit(prog)(*S)


def igg_variant_outputs(name):
    """igg's compute and local step (sequential and overlapped), once, and
    the three decomposition variants after REPS iterations, as numpy."""
    f = FAMILIES[name]
    igg_grid(f["local"], **f["kw"])
    mv = icomm.model_step_variants(name)
    arrays = family_state(name, igg.get_global_grid().dims)
    S = to_igg(arrays)
    nf = mv["nf"]
    out = {"state": arrays, "one_compute": igg_program(mv["compute"], nf, S)}
    for ov in (False, True):
        out[f"local_{ov}"] = igg_program(
            lambda *A, _ov=ov: mv["local"](*A, overlap=_ov), nf, S)
    grid = igg.get_global_grid()
    specs = tuple(spec_for(a.ndim) for a in S[:nf])
    aux_specs = tuple(spec_for(a.ndim) for a in S[nf:])
    for v in comm._VARIANTS:
        fn = icomm._build_variant(mv["compute"], nf, len(S) - nf, specs,
                                  aux_specs, grid, v, REPS, mv["radius"],
                                  None)
        out[v] = fn(*S)
    for k in list(out):
        if k != "state":
            out[k] = [np.asarray(a) for a in out[k]]
    igg.finalize_global_grid()
    return out


@pytest.fixture(scope="module")
def igg_variants():
    return {name: igg_variant_outputs(name) for name in FAMILIES}


def port_family(name, ref):
    f = FAMILIES[name]
    port_grid(f["local"], **f["kw"])
    return comm.model_step_variants(name), to_port(ref["state"])


def close(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_model_step_variants_match_iggs(igg_variants, name):
    ref = igg_variants[name]
    mv, S = port_family(name, ref)
    mi = icomm.model_step_variants(name)
    for key in ("family", "nf", "naux", "radius", "ndim", "stagger",
                "grid_kwargs"):
        assert mv[key] == mi[key], key
    close(mv["compute"](*S), ref["one_compute"])
    seq = mv["local"](*[a.clone() for a in S], overlap=False)
    hid = mv["local"](*S, overlap=True)
    close(seq, ref["local_False"])
    close(hid, ref["local_True"])
    seq = seq if isinstance(seq, tuple) else (seq,)
    hid = hid if isinstance(hid, tuple) else (hid,)
    for a, b in zip(seq, hid):
        assert torch.equal(a, b)
    with pytest.raises(it.GridError, match="plain="):
        mv["local"](*S, assembly="xla")


def test_model_step_variants_unknown_family_raises_iggs():
    with pytest.raises(igg.GridError) as want:
        icomm.model_step_variants("wave2d")
    with pytest.raises(it.GridError) as got:
        comm.model_step_variants("wave2d")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_decompose_variants_match_iggs(igg_variants, name):
    """Each variant after REPS iterations within igg's tolerance of igg's;
    the exchange variant bitwise the compute then `update_halo(plain=
    True)`, the hidden variant bitwise the exchange variant."""
    ref = igg_variants[name]
    mv, S = port_family(name, ref)
    nf = mv["nf"]
    outs = {v: comm._build_variant(mv["compute"], nf, v, REPS,
                                   mv["radius"])(*S)
            for v in comm._VARIANTS}
    for v in comm._VARIANTS:
        close(outs[v], ref[v])
    X = S[:nf]
    for _ in range(REPS):
        X = mv["compute"](*X, *S[nf:])
        X = tuple(X) if isinstance(X, (tuple, list)) else (X,)
        it.update_halo(*X, plain=True)
    for a, b, c in zip(outs["exchange"], X, outs["hidden"]):
        assert torch.equal(a, b) and torch.equal(c, a)


def test_decompose_records_and_stats(igg_variants):
    """`decompose`'s record and ledger tiers are igg's; the caller's
    fields are not touched."""
    ref = igg_variants["diffusion3d"]
    f = FAMILIES["diffusion3d"]
    igg_grid(f["local"], **f["kw"])
    mi = icomm.model_step_variants("diffusion3d")
    icomm.decompose(mi["compute"], to_igg(ref["state"][:1]),
                    aux=to_igg(ref["state"][1:]), nt=1, n_inner=2,
                    config="diffusion3d.xla+overlap")
    (want,) = [r.payload for r in itel.flight_recorder()
               if r.kind == "comm_stats"]
    mv, S = port_family("diffusion3d", ref)
    T0 = S[0].clone()
    d = comm.decompose(mv["compute"], S[:1], aux=S[1:], nt=1, n_inner=2,
                       config="diffusion3d.overlap")
    assert torch.equal(S[0], T0)
    (got,) = [r.payload for r in tel.flight_recorder()
              if r.kind == "comm_stats"]
    # `overlap_efficiency` is recorded only where the exchange variant
    # timed slower than the compute variant (igg's `_fractions`), which
    # each side's timer decides on its own.
    eff = "overlap_efficiency"
    assert set(got) - {eff} == set(want) - {eff}
    for rec in (got, want):
        assert (eff in rec) == (rec["exchange_ms"] > rec["compute_ms"])
    assert (got["source"], got["config"]) == ("calibrate",
                                              "diffusion3d.overlap")
    assert d["compute_ms"] > 0 and 0.0 <= d["exposed_comm_fraction"] <= 1.0
    tiers = {e["tier"] for e in perf.query("comm")}
    assert tiers == {f"overlap.diffusion3d.overlap.{v}"
                     for v in comm._VARIANTS}
    assert tel.snapshot()['igg_exposed_comm_fraction{run="calibrate"}'][
        "value"] == d["exposed_comm_fraction"]
    with pytest.raises(it.GridError, match="plain="):
        comm.decompose(mv["compute"], S[:1], aux=S[1:], assembly="xla")


def test_comm_ledger_files_cross_load_and_render(tmp_path, capsys):
    """Each package's ledger with comm entries loads in the other, and
    each package's `comm report --ledger` renders the other's file."""
    igg_grid(**PERIODIC)
    icomm.calibrate_comm(n_inner=2, nt=1)
    igg_file = tmp_path / "igg.json"
    igg.perf.save(igg_file)
    port_grid(**PERIODIC)
    comm.calibrate_comm(n_inner=2, nt=1, dtype=np.float64)
    port_file = tmp_path / "port.json"
    perf.save(port_file)
    assert perf.load(igg_file) >= 1
    assert igg.perf.load(port_file) >= 1
    for tool, ledger, dtype in ((comm, igg_file, "float32"),
                                (icomm, port_file, "float64")):
        capsys.readouterr()
        assert tool._main(["report", "--ledger", str(ledger)]) == 0
        out = capsys.readouterr().out
        assert "# comm ledger (1 entry)" in out
        assert "halo.xyz.grouped" in out and dtype in out


# ---------------------------------------------------------------------------
# Skew and the report
# ---------------------------------------------------------------------------

def fake_rank_stream(path, process, rows):
    with open(path, "w") as fh:
        for wall, kind, step, payload in rows:
            fh.write(json.dumps({"t": wall, "wall": wall,
                                 "process": process, "kind": kind,
                                 "step": step, "payload": payload}) + "\n")


def skew_streams(tmp_path):
    for p, ms in ((0, 10.0), (1, 16.0), (2, 11.0)):
        fake_rank_stream(tmp_path / f"events_r{p}.jsonl", p, [
            (100.0 + p, "step_stats", 50, {"ms_per_step": ms}),
            (110.0 + p, "step_stats", 60, {"ms_per_step": ms + p}),
            (120.0 + p, "step_stats", 70 + p, {"ms_per_step": 9.0})])
    fake_rank_stream(tmp_path / "events_r3.jsonl", 3,
                     [(100.5, "step_stats", 60, {"ms_per_step": 30.0})])


def test_rank_skew_equals_iggs(tmp_path):
    skew_streams(tmp_path)
    want = icomm.rank_skew(itel.merge_streams([tmp_path]), publish=True)
    got = comm.rank_skew(tel.merge_streams([tmp_path]), publish=True)
    assert got == want and got["per_step"]
    rec = lambda mod: [r.payload for r in mod.flight_recorder()  # noqa: E731
                       if r.kind == "rank_skew"]
    assert rec(tel) == rec(itel) and len(rec(tel)) == 1
    assert tel.snapshot()["igg_rank_skew_ms"]["value"] == \
        want["max_skew_ms"]
    assert comm.rank_skew(tel.merge_streams(
        [tmp_path / "events_r3.jsonl"]))["per_step"] == []


def test_report_renders_as_iggs(tmp_path, capsys):
    """The same streams render the same decomposition, skew and stall
    sections in both packages (the ledger section aside)."""
    rows = [(100.0, "step_stats", 50, {"ms_per_step": 10.0}),
            (150.0, "comm_stats", 60,
             {"source": "probe", "compute_ms": 1.0, "exchange_ms": 2.0,
              "hidden_ms": 1.5, "exposed_comm_fraction": 0.5,
              "overlap_efficiency": 0.5}),
            (180.0, "collective_stall", 70,
             {"in_flight": "watchdog probe", "age_s": 1.2,
              "timeout_s": 1.0, "last_completed_step": 65, "pending": 2})]
    fake_rank_stream(tmp_path / "events_r0.jsonl", 0, rows)
    fake_rank_stream(tmp_path / "events_r1.jsonl", 1,
                     [(100.5, "step_stats", 50, {"ms_per_step": 14.0})])
    outs = []
    for tool in (icomm, comm):
        capsys.readouterr()
        assert tool._main(["report", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        outs.append(out[out.index("# step-time decomposition"):])
    assert outs[0] == outs[1]
    assert "max skew: 2.0000 ms" in outs[1]
    assert "collective stalls (1)" in outs[1]
    assert comm._main([]) == 2 and comm._main(["report", "--ledger"]) == 2


# ---------------------------------------------------------------------------
# The stall heartbeat
# ---------------------------------------------------------------------------

class NeverReady:
    def is_ready(self):
        return False


class Ready:
    def is_ready(self):
        return True


def episodes(mod, sessdir):
    """One scripted heartbeat sequence on `mod`'s StallWatchdog, with
    explicit clocks: fire once, no second report mid-drain, re-arm after a
    full drain, ready-but-unread is no stall."""
    sess = mod.Telemetry(sessdir).attach()
    sw = (icomm if mod is itel else comm).StallWatchdog(
        0.01, run="unit", poll_s=10.0)
    seq = []
    try:
        sw.watch("a", 5, "unit probe a", NeverReady())
        sw.watch("b", 7, "unit probe b", NeverReady())
        now = time.monotonic()
        seq += [sw.check(now=now - 1.0), sw.check(now=now + 1.0),
                sw.check(now=now + 2.0), sw.stalled]
        sw.fetched("a", 5)
        seq += [sw.check(now=now + 3.0), sw.stalled]
        sw.fetched("b", 7)
        seq += [sw.stalled]
        sw.watch("c", 11, "unit probe c", NeverReady())
        seq += [sw.check(now=now + 4.0), sw.stalls]
        sw.fetched("c", 11)
        sw.watch("d", 13, "unit probe d", Ready())
        seq += [sw.check(now=now + 5.0)]
        sw.clear()
        seq += [sw.stalled, sw.stall_info]
    finally:
        sw.close()
        sess.detach()
    recs = [json.loads(line) for line in
            (sessdir / "events_r0.jsonl").read_text().splitlines()]
    stalls = [(r["step"], r["payload"]["in_flight"],
               r["payload"]["last_completed_step"], r["payload"]["pending"])
              for r in recs if r["kind"] == "collective_stall"]
    report = json.loads((sessdir / "stall_r0.json").read_text())
    return seq, stalls, (report["reason"], report["step"])


def test_stall_watchdog_episodes_equal_iggs(tmp_path):
    want = episodes(itel, tmp_path / "igg")
    got = episodes(tel, tmp_path / "port")
    assert got == want
    assert got[1] == [(5, "unit probe a", None, 2), (11, "unit probe c", 7, 1)]
    assert comm.active_stalls() == []


def test_active_stalls_and_env_knob(monkeypatch):
    sw = comm.StallWatchdog(0.01, run="unit", poll_s=10.0)
    try:
        sw.watch("a", 3, "unit probe", NeverReady())
        assert comm.active_stalls() == []
        assert sw.check(now=time.monotonic() + 1.0)
        (info,) = comm.active_stalls()
        assert info["step"] == 3 and info["in_flight"] == "unit probe"
        sw.fetched("a", 3)
        assert comm.active_stalls() == []
    finally:
        sw.close()
    assert comm.make_stall_watchdog("x").timeout_s == 120.0
    monkeypatch.setenv("IGG_COMM_STALL_TIMEOUT", "0")
    assert comm.make_stall_watchdog("x") is None


# ---------------------------------------------------------------------------
# The resilient loop
# ---------------------------------------------------------------------------

LOCAL = (6, 6, 6)


def loop_state(seed=3):
    rng = np.random.default_rng(seed)
    shp = it.stacked_shape(LOCAL)
    T = it.update_halo(torch.from_numpy(rng.standard_normal(shp)))
    return {"T": T, "Cp": torch.from_numpy(1.0 + rng.random(shp))}


def loop_step(sleep=0.0):
    step = td3.make_step(td3.Params())

    def fn(s):
        if sleep:
            time.sleep(sleep)
        return {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}
    return fn


def monitor(state, **kw):
    mv = comm.model_step_variants("diffusion3d")
    return comm.StepDecomposition(mv["compute"], (state["T"],),
                                  aux=(state["Cp"],), **kw)


def events_file(path):
    return [json.loads(line) for line in
            (path / "events_r0.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def igg_comm_run(tmp_path_factory):
    """igg's run_resilient with a StepDecomposition: its comm_stats
    records and its final T."""
    tmp = tmp_path_factory.mktemp("igg_comm")
    igg.init_global_grid(*LOCAL, quiet=True, **PERIODIC)
    try:
        port_grid(**PERIODIC)
        arrays = {k: v.numpy() for k, v in loop_state().items()}
        it.finalize_global_grid()
        st = {k: jax.device_put(v, sharding_for(3)) for k, v in
              arrays.items()}
        mv = icomm.model_step_variants("diffusion3d")
        mon = icomm.StepDecomposition(mv["compute"], (st["T"],),
                                      aux=(st["Cp"],), reps=2)
        step = id3.make_step(id3.Params(), donate=False)
        res = igg.run_resilient(
            lambda s: {"T": step(s["T"], s["Cp"]), "Cp": s["Cp"]}, st, 60,
            watch_every=2, telemetry=tmp, comm=mon, install_sigterm=False)
        stats = [r for r in events_file(tmp) if r["kind"] == "comm_stats"]
        return dict(arrays=arrays, T=np.asarray(res.state["T"]),
                    stats=stats, windows=mon.windows)
    finally:
        igg.finalize_global_grid()


def test_run_resilient_comm_checks_equal_iggs():
    """igg's two checks, igg's messages (the port names its module)."""
    port_grid(**PERIODIC)
    st = loop_state()

    class Duck:
        def maybe_dispatch(self, step, stall=None):
            return False

        def poll(self, step, stall=None):
            return None

    with pytest.raises(it.GridError, match="watch cadence"):
        it.run_resilient(loop_step(), st, 4, watch_every=0, comm=Duck(),
                         install_sigterm=False)
    with pytest.raises(it.GridError,
                       match=r"igg_torch\.comm\.StepDecomposition monitor"):
        it.run_resilient(loop_step(), st, 4, watch_every=2,
                         comm="not-a-monitor", install_sigterm=False)
    # heal= and serve= are ported (igg_torch.heal, igg_torch.statusd): a
    # value that is no policy, port or server raises igg's coercion.
    with pytest.raises(it.GridError, match="heal='bogus': expected None"):
        it.run_resilient(loop_step(), st, 4, install_sigterm=False,
                         heal="bogus")
    with pytest.raises(it.GridError, match="serve='bogus': expected None"):
        it.run_resilient(loop_step(), st, 4, install_sigterm=False,
                         serve="bogus")


def test_run_resilient_comm_windows_match_iggs(igg_comm_run, tmp_path):
    """The port's monitor emits igg's `comm_stats` records (same keys,
    source 'probe', config from the ladder), as many as its `windows`;
    the run's result equals the bare run's bitwise and igg's within the
    float64 tolerance of tests/test_torch_diffusion.py."""
    port_grid(**PERIODIC)
    st = convert.to_torch(igg_comm_run["arrays"])
    fn = loop_step()
    fn(dict(st))                     # the ladder's first dispatch
    mon = monitor(st, reps=2)
    assert mon.config == "diffusion3d.cuda"
    res = it.run_resilient(fn, st, 60, watch_every=2, telemetry=tmp_path,
                           comm=mon, install_sigterm=False)
    bare = it.run_resilient(fn, convert.to_torch(igg_comm_run["arrays"]),
                            60, watch_every=2, install_sigterm=False)
    assert torch.equal(res.state["T"], bare.state["T"])
    np.testing.assert_allclose(res.state["T"].numpy(), igg_comm_run["T"],
                               rtol=0, atol=1e-12)
    stats = [r for r in events_file(tmp_path) if r["kind"] == "comm_stats"]
    assert igg_comm_run["windows"] >= 1 and mon.windows >= 1
    assert len(stats) == mon.windows
    optional = {"overlap_efficiency", "config"}
    keys = {k for r in igg_comm_run["stats"] for k in r["payload"]}
    for r in stats:
        p = r["payload"]
        assert set(p) - optional == keys - optional
        assert p["source"] == "probe" and p["reps"] == 2
        assert p["compute_ms"] > 0 and p["hidden_ms"] > 0
        assert 0.0 <= p["exposed_comm_fraction"] <= 1.0
    assert 'igg_exposed_comm_fraction{run="resilient"}' in tel.snapshot()


def test_stall_fires_once_under_chaos(tmp_path, monkeypatch):
    """The chaos stall with a 0.05 s timeout, `max_pending_probes=100`
    and a step that sleeps: exactly one `collective_stall`, its report
    and a flight dump, and the run finishes bitwise the uninterrupted one
    (the forced reads at the end complete; a slower clock only makes the
    stall later)."""
    monkeypatch.setenv("IGG_COMM_STALL_TIMEOUT", "0.05")
    port_grid(**PERIODIC)
    clean = it.run_resilient(loop_step(), loop_state(), 40, watch_every=5,
                             install_sigterm=False)
    with it.chaos.collective_stall():
        res = it.run_resilient(loop_step(0.004), loop_state(), 40,
                               watch_every=5, max_pending_probes=100,
                               telemetry=tmp_path, install_sigterm=False)
    assert res.steps_done == 40
    assert torch.equal(res.state["T"], clean.state["T"])
    stalls = [r for r in events_file(tmp_path)
              if r["kind"] == "collective_stall"]
    assert len(stalls) == 1
    p = stalls[0]["payload"]
    assert "watchdog probe" in p["in_flight"]
    assert p["age_s"] >= 0.05 and p["timeout_s"] == 0.05 and p["pending"] >= 1
    report = json.loads((tmp_path / "stall_r0.json").read_text())
    assert (report["reason"], report["step"]) == ("collective_stall",
                                                  stalls[0]["step"])
    (dump,) = tel.flight_dumps(tmp_path, rank=0)
    doc = json.loads(dump.read_text())
    assert "collective_stall" in doc["reason"]
    assert any(r["kind"] == "collective_stall" for r in doc["events"])


def test_healthy_run_is_silent(tmp_path, monkeypatch):
    monkeypatch.setenv("IGG_COMM_STALL_TIMEOUT", "30")
    port_grid(**PERIODIC)
    st = loop_state()
    res = it.run_resilient(loop_step(), st, 30, watch_every=5,
                           telemetry=tmp_path, comm=monitor(st, reps=1),
                           install_sigterm=False)
    assert res.steps_done == 30
    assert not any(r["kind"] == "collective_stall"
                   for r in events_file(tmp_path))
    assert not (tmp_path / "stall_r0.json").exists()


def test_chaos_seams_restore_on_exit():
    from igg_torch import resilience

    assert resilience._is_ready(Ready())
    for make in (it.chaos.collective_stall,
                 lambda: it.chaos.straggler(factor=100.0, after=0)):
        with make():
            assert resilience._CHAOS_FETCH_TAP is not None
        assert resilience._CHAOS_FETCH_TAP is None
        with pytest.raises(RuntimeError, match="body"):
            with make():
                raise RuntimeError("body")
        assert resilience._CHAOS_FETCH_TAP is None
    with it.chaos.collective_stall():
        assert not resilience._is_ready(Ready())
    with it.chaos.straggler(factor=100.0, after=1):
        assert resilience._is_ready(Ready())       # the free grant
        assert not resilience._is_ready(Ready())   # then the rate limit
    with it.chaos.straggler(rank=1, factor=100.0):
        assert resilience._is_ready(Ready())       # not this rank


def test_collective_stall_tied_to_a_device():
    from igg_torch import resilience

    port_grid(**PERIODIC)
    with it.chaos.collective_stall(device=torch.device("cpu")):
        assert not resilience._is_ready(Ready())   # the grid's device
    with it.chaos.collective_stall(device=0):
        assert resilience._is_ready(Ready())       # another device


def test_straggler_inflates_windows(tmp_path):
    """After `after` free grants, readiness is granted at most once per
    `factor * base_window_s`: every window read in the loop after them is
    at least that long (on CPU tensors a grant is a read, so the bound is
    the rate limit's, whatever the host's speed), and longer than the
    healthy windows before them."""
    port_grid(**PERIODIC)
    k, watch, factor, base = 4, 5, 8.0, 0.05
    step, last = loop_step(0.005), [0.0]

    def timed(s):
        out = step(s)
        last[0] = time.monotonic()
        return out

    with it.chaos.straggler(factor=factor, base_window_s=base, after=k):
        it.run_resilient(timed, loop_state(), 200, watch_every=watch,
                         max_pending_probes=100, telemetry=tmp_path,
                         install_sigterm=False)
    wins = [(r["step"], r["t"], r["payload"]["ms_per_step"])
            for r in events_file(tmp_path) if r["kind"] == "step_stats"]
    before = [ms for s, t, ms in wins if s <= watch * k]
    after = [ms for s, t, ms in wins if s > watch * k and t <= last[0]]
    assert before and after
    limit = 0.95 * factor * base / watch * 1e3
    assert min(after) >= limit
    assert float(np.median(before)) < min(after)


# ---------------------------------------------------------------------------
# The search's overlap confirmation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden,kept", [(1.5, True), (2.0, False)])
def test_search_confirms_or_demotes_an_overlapped_winner(monkeypatch,
                                                         hidden, kept):
    """An overlapped winner stays only when the in-search decomposition
    (stubbed) measures hidden < exchange; else `overlap_demoted` carries
    the measured times."""
    port_grid((8, 8, 8), **PERIODIC)
    # The search's winner goes to a cache of this test's own: left in the
    # process-wide one, it would pin the route of every later "auto"
    # factory at this signature in the same worker.
    monkeypatch.setattr(autotune, "_CACHE", {})
    times = dict(compute=1.0, exchange=2.0, hidden=hidden)
    calls = []
    monkeypatch.setattr(comm, "decompose", lambda *a, **kw: (
        calls.append(kw["config"]), comm._fractions(times))[1])
    real = autotune._build_candidate

    def slowed(family, cand, n_inner, params):
        fn, args = real(family, cand, n_inner, params)
        if cand.get("overlap"):
            return fn, args
        # 0.2 s a call: the overlapped candidate must win even on a loaded
        # machine, where 0.02 s was at times not enough.
        return (lambda *a: (time.sleep(0.2), fn(*a))[1]), args

    monkeypatch.setattr(autotune, "_build_candidate", slowed)
    w = autotune.search("diffusion3d", n_inner=3, nt=1, candidates=[
        {"tier": "diffusion3d.overlap", "overlap": True},
        {"tier": "diffusion3d.plain"}])
    assert calls == ["diffusion3d.overlap"]
    demoted = [r.payload for r in tel.flight_recorder()
               if r.kind == "overlap_demoted"]
    if kept:
        assert w["tier"] == "diffusion3d.overlap" and w["overlap"]
        assert demoted == []
    else:
        assert w["tier"] == "diffusion3d.plain" and not w["overlap"]
        (d,) = demoted
        assert (d["exchange_ms"], d["hidden_ms"]) == (2.0, hidden)


def test_overlap_confirmation_without_recipe_or_on_failure(monkeypatch):
    """A family with no recipe passes on timing alone (igg's); a failing
    decomposition on CPU tensors emits `overlap_confirm_failed` and keeps
    the winner, as igg does."""
    port_grid((8, 8, 8), **PERIODIC)
    assert autotune._overlap_confirmed("wave2d", None, 4) == (True, None)

    def broken(*a, **kw):
        raise RuntimeError("probe broke")

    monkeypatch.setattr(comm, "decompose", broken)
    assert autotune._overlap_confirmed("diffusion3d", None, 4) == (True,
                                                                   None)
    (f,) = [r.payload for r in tel.flight_recorder()
            if r.kind == "overlap_confirm_failed"]
    assert "probe broke" in f["error"]


def test_comm_imports_neither_jax_nor_igg():
    code = ("import sys, igg_torch.comm, igg_torch.chaos\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'igg' or m.startswith('igg.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=pathlib.Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr
