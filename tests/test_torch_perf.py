"""The port's perf ledger (igg_torch.perf) held against igg's on the CPU.

Against igg, on the same inputs: ledger files cross-load both ways with
their aggregates; repeated saves never count a sample twice in either
package; `merge_ledgers` combines alike; `compare_rows` gives igg's
verdicts (directions, fraction units, pass flags, provenance, missing
rows, the injected 20% regression); `best` and `query` give igg's
tie-break; `bytes_per_step` igg's accesses, under the tier map.  Then the
port's own contracts, as igg's tests/test_perf.py states them: junk and
the kill switch, the gauges with the card's peak, drift once per tier,
the CLI, the window attribution of `StepStats(perf=)`, `run_resilient`
feeding the ledger, `calibrate`, `invalidate` evicting the tuning cache,
and `chaos.stale_calibration`.  The port's grids are
`init_global_grid(..., device="cpu")`.
"""

import json

import pytest
import torch

import igg_torch as it
from igg import perf as iperf
from igg import telemetry as itel
from igg_torch import autotune, chaos, degrade, perf
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as td3
from torch_threads import one_torch_thread  # noqa: F401

CTX = dict(local_shape=(128, 128, 128), dtype="float32", dims=(2, 2, 2),
           backend="cuda", device_kind="NVIDIA H100 80GB HBM3")
H100_GBS = 3350.0


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("IGG_PERF", "IGG_PERF_LEDGER", "IGG_TUNE_CACHE",
              "IGG_PERF_DRIFT_TOL", "IGG_PERF_SAVE_EVERY", "IGG_TUNE"):
        monkeypatch.delenv(k, raising=False)
    for mod in (perf, iperf, autotune):
        mod.reset()
    tel.reset_metrics()
    tel._ring().clear()
    itel._ring().clear()
    degrade.reset()
    yield
    for mod in (perf, iperf, autotune):
        mod.reset()
    tel.reset_metrics()
    degrade.reset()
    if it.grid_is_initialized():
        it.finalize_global_grid()


def entries(path):
    return {k: v for k, v in json.loads(path.read_text())["entries"].items()}


AGG = ("count", "sum_ms", "best_ms", "last_ms", "mean_ms", "sources")


def same_aggregates(a, b):
    assert set(a) == set(b)
    for k in a:
        for f in AGG:
            if isinstance(a[k][f], float):
                assert a[k][f] == pytest.approx(b[k][f], rel=1e-12), (k, f)
            else:
                assert a[k][f] == b[k][f], (k, f)


SAMPLES = [("diffusion3d", "diffusion3d.cuda", 2.0, "bench"),
           ("diffusion3d", "diffusion3d.cuda", 1.0, "watchdog"),
           ("diffusion3d", "diffusion3d.banded", 1.5, "autotune"),
           ("stokes3d", "stokes3d.trapezoid", 9.0, "calibrate")]


# ---------------------------------------------------------------------------
# Against igg
# ---------------------------------------------------------------------------

def test_ledger_files_cross_load_both_ways(tmp_path):
    """A file the port wrote loads in igg with its aggregates, and a file
    igg wrote loads in the port: the format is igg's field for field."""
    for fam, tier, ms, src in SAMPLES:
        perf.record(fam, tier, ms, source=src, **CTX)
    port_file = tmp_path / "port.json"
    perf.save(port_file)
    assert json.loads(port_file.read_text())["format"] == \
        iperf.LEDGER_FORMAT == perf.LEDGER_FORMAT
    assert iperf.load(port_file) == 3
    for e in perf.query():
        got = iperf.best(e["family"], tier=e["tier"])
        for f in AGG:
            assert got[f] == e[f], f
        assert got["device_kind"] == CTX["device_kind"]
    # The other way: igg records the same samples and saves.
    iperf.reset()
    for fam, tier, ms, src in SAMPLES:
        iperf.record(fam, tier, ms, source=src, **CTX)
    igg_file = tmp_path / "igg.json"
    iperf.save(igg_file)
    perf.reset()
    assert perf.load(igg_file) == 3
    same_aggregates(entries(port_file), entries(igg_file))
    assert [e["tier"] for e in perf.query()] == \
        [e["tier"] for e in iperf.query()]


def test_repeated_saves_never_double_count_like_igg(tmp_path):
    """The same sequence of records, saves, loads and replacing loads in
    both packages leaves the same aggregates in both files (igg's delta
    saves)."""
    def drive(mod, path):
        mod.record("f", "t", 2.0, **CTX)
        mod.save(path)
        mod.record("f", "t", 4.0, **CTX)
        mod.save(path)
        mod.save(path)
        after_two = entries(path)
        mod.load(path)
        mod.save(path)
        mod.load(path, replace=True)
        mod.record("f", "t", 10.0, **CTX)
        mod.save(path)
        return after_two, entries(path)

    a2, a = drive(perf, tmp_path / "port.json")
    b2, b = drive(iperf, tmp_path / "igg.json")
    e = next(iter(a2.values()))
    assert e["count"] == 2 and e["sum_ms"] == pytest.approx(6.0)
    assert e["sources"] == {"api": 2}
    e = next(iter(a.values()))
    assert e["count"] == 3 and e["sum_ms"] == pytest.approx(16.0)
    same_aggregates(a2, b2)
    same_aggregates(a, b)


def test_merge_ledgers_like_igg(tmp_path):
    lists = [[], []]
    for i, (fam, tier, ms, src) in enumerate(SAMPLES + SAMPLES[:2]):
        perf.reset()
        perf.record(fam, tier, ms + i, source=src, **CTX)
        lists[i % 2].extend(perf.query())
    mine = perf.merge_ledgers(lists)
    theirs = iperf.merge_ledgers(lists)
    assert set(mine) == set(theirs)
    for k in mine:
        for f in AGG:
            assert mine[k][f] == theirs[k][f]
    # The CLI's merge writes the same entries as igg's.
    paths = []
    for i, lst in enumerate(lists):
        perf.reset()
        for e in lst:
            perf.record(e["family"], e["tier"], e["best_ms"],
                        source=next(iter(e["sources"])), **CTX)
        paths.append(tmp_path / f"in{i}.json")
        perf.save(paths[-1])
    assert perf._main(["merge", str(tmp_path / "m.json"),
                       *map(str, paths)]) == 0
    assert iperf._main(["merge", str(tmp_path / "mi.json"),
                        *map(str, paths)]) == 0
    same_aggregates(entries(tmp_path / "m.json"), entries(tmp_path / "mi.json"))


def _row(metric="m", value=1.0, unit="ms", config=None, backend="cpu",
         device_kind="cpu", smoke=True, **extra):
    return {"metric": metric, "value": value, "unit": unit,
            "config": config or {"n": 64}, "smoke": smoke,
            "provenance": {"backend": backend, "device_kind": device_kind},
            **extra}


ERR = "relative error (predicted-measured)"
COMPARE_CASES = {
    "within_tol": ([_row("a", 100.0), _row("b", 50.0, "GB/s"),
                    _row("c", 0.05, ERR)],
                   [_row("a", 105.0), _row("b", 48.0, "GB/s"),
                    _row("c", -0.06, ERR)], {}),
    "worse": ([_row("a", 100.0), _row("b", 50.0, "GB/s"),
               _row("c", 0.05, ERR)],
              [_row("a", 120.0), _row("b", 40.0, "GB/s"),
               _row("c", 0.30, ERR)], {}),
    "better": ([_row("a", 100.0), _row("b", 50.0, "GB/s"),
                _row("c", 0.05, ERR)],
               [_row("a", 50.0), _row("b", 80.0, "GB/s"),
                _row("c", 0.0, ERR)], {}),
    "fractions": ([_row("eff", 0.95, "fraction"),
                   _row("ovl", 0.90, "fraction of compute cycles")],
                  [_row("eff", 0.50, "fraction"),
                   _row("ovl", 0.91, "fraction of compute cycles")], {}),
    "pass_flag_holds": ([_row("k", 0.03, "%", **{"pass": True})],
                        [_row("k", 0.4, "%", **{"pass": True})], {}),
    "pass_flag_flips": ([_row("k", 0.03, "%", **{"pass": True})],
                        [_row("k", 0.4, "%", **{"pass": False})], {}),
    "pass_values_gated": ([_row("k", 0.03, "%", **{"pass": True})],
                          [_row("k", 0.4, "%", **{"pass": True})],
                          {"gate_pass_values": True}),
    "provenance": ([_row("cpu_row"), _row("card_row", backend="cuda",
                                          device_kind="NVIDIA H100",
                                          smoke=False)],
                   [_row("cpu_row")], {}),
    "missing": ([_row("x")], [_row("other")], {}),
    "missing_allowed": ([_row("x")], [_row("other")],
                        {"allow_missing": True}),
    "injected_20pct": ([_row("ms_row", 100.0)], [_row("ms_row", 120.0)],
                       {}),
    "speedup_and_steps": ([_row("s", 2.0, "speedup"),
                           _row("r", 100.0, "steps/s")],
                          [_row("s", 1.5, "speedup"),
                           _row("r", 111.0, "steps/s")], {}),
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_rows_gives_iggs_verdicts(case):
    base, new, kw = COMPARE_CASES[case]
    mine = perf.compare_rows(base, new, tol=0.1, **kw)
    theirs = iperf.compare_rows(base, new, tol=0.1, **kw)
    assert mine == theirs


def test_compare_cli_injected_regression_like_igg(tmp_path):
    g, r = tmp_path / "goldens", tmp_path / "results"
    g.mkdir(), r.mkdir()
    (g / "bench.jsonl").write_text(json.dumps(_row("ms_row", 100.0)) + "\n")
    for value, want in ((104.0, 0), (120.0, 1)):
        (r / "bench.jsonl").write_text(json.dumps(_row("ms_row", value))
                                       + "\n")
        args = ["compare", str(g), str(r), "--tol", "0.1"]
        assert perf._main(args) == iperf._main(args) == want
    (r / "bench.jsonl").write_text(json.dumps(_row("ms_row", 104.0)) + "\n")
    (r / "x.failed.jsonl").write_text(json.dumps(_row("ms_row", 999.0))
                                      + "\n")
    assert perf._main(["compare", str(g), str(r)]) == 0
    assert perf._main(["compare", str(g)]) == 2
    assert perf._main(["compare", str(tmp_path / "void"), str(r)]) == 2


def test_best_tie_break_like_igg(tmp_path):
    """Equal best_ms: the higher count first, then the fresher entry, then
    the tier's name; the same entries give igg's order."""
    perf.record("f", "f.zeta", 1.0, source="watchdog", **CTX)
    for _ in range(3):
        perf.record("f", "f.alpha", 1.0, source="calibrate", **CTX)
    perf.record("g", "g.old", 2.0, source="bench", **CTX)
    perf.record("g", "g.new", 2.0, source="autotune", **CTX)
    with perf._lock:
        for k in perf._LEDGER:
            if k[0] == "g":
                perf._LEDGER[k]["updated_wall"] = 123.0
    perf.record("h", "h.late", 3.0, **CTX)
    perf.record("h", "h.early", 3.0, **CTX)
    with perf._lock:
        for k, e in perf._LEDGER.items():
            if k[0] == "h":
                e["updated_wall"] = 200.0 if k[1] == "h.late" else 100.0
    path = tmp_path / "ties.json"
    perf.save(path)
    iperf.load(path)
    for fam in "fgh":
        mine = [e["tier"] for e in perf.query(fam)]
        assert mine == [e["tier"] for e in iperf.query(fam)]
        assert perf.best(fam)["tier"] == iperf.best(fam)["tier"]
    assert [e["tier"] for e in perf.query("f")] == ["f.alpha", "f.zeta"]
    assert perf.best("g")["tier"] == "g.new"       # the name breaks the tie
    assert perf.best("h")["tier"] == "h.late"      # the fresher wins


@pytest.mark.parametrize("family,igg_tier", [
    ("diffusion3d", "diffusion3d.mosaic"), ("diffusion3d", "diffusion3d.xla"),
    ("diffusion3d", "diffusion3d.banded"), ("hm3d", "hm3d.trapezoid"),
    ("stokes3d", "stokes3d.mosaic"), ("stokes3d", "stokes3d.trapezoid"),
    ("wave2d", "wave2d.chunk"), ("wave2d", "wave2d.mosaic"),
    ("nosuch", "nosuch.xla")])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bytes_per_step_like_igg(family, igg_tier, dtype):
    tier = perf.port_tier(igg_tier)
    shape = (64, 32, 128) if family != "wave2d" else (256, 128)
    assert perf.bytes_per_step(family, tier, shape, dtype) == \
        iperf.bytes_per_step(family, igg_tier, shape, dtype)
    assert perf.bytes_per_step(family, tier, (), dtype) is None


def test_port_tier_map():
    assert perf.port_tier("stokes3d.xla") == "stokes3d.plain"
    assert perf.port_tier("stokes3d.xla", overlap=True) == "stokes3d.overlap"
    assert perf.port_tier("hm3d.mosaic") == "hm3d.cuda"
    for t in ("hm3d.trapezoid", "wave2d.chunk", "x.banded", "x.cuda"):
        assert perf.port_tier(t) == t


# ---------------------------------------------------------------------------
# The port's own contracts (igg's tests/test_perf.py)
# ---------------------------------------------------------------------------

def test_record_aggregates_junk_and_kill_switch(monkeypatch):
    assert perf.record("d", "d.cuda", 2.0, source="bench", **CTX)["count"] == 1
    e = perf.record("d", "d.cuda", 1.0, source="watchdog", **CTX)
    assert (e["count"], e["best_ms"], e["last_ms"]) == (2, 1.0, 1.0)
    assert e["mean_ms"] == pytest.approx(1.5)
    assert perf.best("d", dtype=torch.float32)["best_ms"] == 1.0
    assert perf.best("d", dtype="float64") is None
    for junk in (float("nan"), 0.0, "bogus"):
        assert perf.record("f", "t", junk, **CTX) is None
    monkeypatch.setenv("IGG_PERF", "0")
    assert not perf.enabled()
    assert perf.record("f", "t", 1.0, **CTX) is None
    assert {e["family"] for e in perf.query()} == {"d"}


def test_gauges_use_the_cards_peak_and_every_block():
    """3 accesses of a 128^3 float32 block, 8 blocks on one card, at 2 ms:
    the achieved rate and its share of the H100's 3350 GB/s."""
    perf.record("diffusion3d", "diffusion3d.cuda", 2.0, **CTX)
    snap = tel.snapshot()
    lab = '{family="diffusion3d",tier="diffusion3d.cuda"}'
    gbps = snap[f"igg_achieved_gbps{lab}"]["value"]
    assert gbps == pytest.approx(8 * 3 * 128 ** 3 * 4 / 2e-3 / 1e9)
    assert snap[f"igg_pct_hbm_peak{lab}"]["value"] == \
        pytest.approx(100 * gbps / H100_GBS)
    assert perf.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == H100_GBS
    for unknown in ("cpu", "NVIDIA A10", None, "TPU v5e"):
        assert perf.hbm_peak_gbps(unknown) is None
    tel.reset_metrics()
    perf.record("diffusion3d", "diffusion3d.trapezoid", 2.0, **CTX)
    assert not any(k.startswith("igg_achieved_gbps") for k in tel.snapshot())


def test_cost_model_drift_once_per_tier(monkeypatch):
    perf.predict("diffusion3d", 0.0021)
    perf.record("diffusion3d", "diffusion3d.cuda", 2.0, **CTX)
    rel = tel.snapshot()['igg_cost_model_rel_error{family="diffusion3d"}']
    assert rel["value"] == pytest.approx(0.05)
    assert not [r for r in tel.flight_recorder()
                if r.kind == "cost_model_drift"]
    perf.predict("diffusion3d", 0.010)
    for _ in range(2):
        perf.record("diffusion3d", "diffusion3d.cuda", 2.0, **CTX)
    drifts = [r.payload for r in tel.flight_recorder()
              if r.kind == "cost_model_drift"]
    assert len(drifts) == 1 and drifts[0]["rel_error"] == pytest.approx(4.0)
    monkeypatch.setenv("IGG_PERF_DRIFT_TOL", "0.01")
    perf.predict("hm3d", 0.00205)
    perf.record("hm3d", "hm3d.cuda", 2.0, **CTX)
    assert [r.payload["tol"] for r in tel.flight_recorder()
            if r.kind == "cost_model_drift"][-1] == pytest.approx(0.01)


def test_save_load_format_guard_env_path_and_autosave(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "igg-perf-ledger-v999",
                               "entries": {}}))
    with pytest.raises(it.GridError, match="igg-perf-ledger-v1"):
        perf.load(bad)
    (tmp_path / "junk.json").write_text("{")
    with pytest.raises(it.GridError, match="valid JSON"):
        perf.load(tmp_path / "junk.json")
    with pytest.raises(it.GridError, match="IGG_PERF_LEDGER"):
        perf.load()
    target = tmp_path / "auto" / "ledger.json"
    monkeypatch.setenv("IGG_PERF_LEDGER", str(target))
    monkeypatch.setenv("IGG_PERF_SAVE_EVERY", "0")
    assert perf.ledger_path() == target
    perf.record("diffusion3d", "diffusion3d.cuda", 2.0, **CTX)
    assert len(entries(target)) == 1
    bad.write_text("{not json")          # a corrupt file is replaced
    assert perf.save(bad) == bad and len(entries(bad)) == 1


def test_cli_show_and_tune(tmp_path, capsys):
    perf.record("diffusion3d", "diffusion3d.cuda", 2.0, **CTX)
    p = tmp_path / "ledger.json"
    perf.save(p)
    assert perf._main(["show", str(p)]) == 0
    out = capsys.readouterr().out
    assert "diffusion3d.cuda" in out and "128x128x128" in out
    assert perf._main(["show", str(p), "--family", "nosuch"]) == 0
    assert "cuda" not in capsys.readouterr().out
    assert perf._main(["show", str(tmp_path / "absent.json")]) == 2
    assert perf._main([]) == 2 and perf._main(["frobnicate"]) == 2
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu")
    autotune.record_winner("diffusion3d", {"tier": "diffusion3d.banded",
                                           "K": 8, "band": 8, "ms": 1.25},
                           local_shape=(128, 128, 128))
    c = tmp_path / "tune.json"
    autotune.save(c)
    assert perf._main(["tune", str(c), "--ledger", str(p)]) == 0
    out = capsys.readouterr().out
    assert "diffusion3d.banded" in out and "1 winner" in out
    assert perf._main(["tune"]) == 2


def test_observe_window_credits_the_serving_tier():
    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, quiet=True,
                        device="cpu", periodx=1, periody=1, periodz=1)
    state = perf.window_state()          # before the run's dispatches
    p = td3.Params()
    T, Cp = td3.init_fields(p)
    T = td3.make_step(p)(T, Cp)
    ctx = perf.sample_context(T)
    assert ctx["local_shape"] == (8, 8, 8) and ctx["dims"] == (2, 2, 2)
    assert (ctx["backend"], ctx["device_kind"], ctx["dtype"]) == \
        ("cpu", "cpu", "float32")
    out = perf.observe_window("resilient", 3.0, 10, ctx, state)
    assert len(out) == 1
    e = out[0]
    assert (e["family"], e["tier"]) == \
        ("diffusion3d", degrade.active()["diffusion3d"])
    assert e["sources"] == {"watchdog": 1}
    # No dispatch since the last window: nothing is credited.
    assert perf.observe_window("resilient", 3.0, 10, ctx, state) == []
    # StepStats(perf=) feeds it on its own fetch timestamps.
    stats = tel.StepStats("resilient", perf=ctx)
    td3.make_step(p)(T, Cp)
    stats.fetched(0, 0)
    import time
    time.sleep(0.002)
    stats.fetched(10, 10)
    assert perf.best("diffusion3d")["sources"]["watchdog"] == 2


def test_run_resilient_feeds_the_ledger(tmp_path, monkeypatch):
    """A model run with a verified factory gives the serving tier ledger
    samples from the verification and the watchdog windows, persisted to
    the configured file."""
    monkeypatch.setenv("IGG_PERF_LEDGER", str(tmp_path / "ledger.json"))
    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, quiet=True,
                        device="cpu", periodx=1, periody=1, periodz=1)
    p = td3.Params()
    T0, Cp = td3.init_fields(p)
    step = td3.make_step(p, verify="first_use")
    res = it.run_resilient(lambda s: {"T": step(s["T"], Cp)},
                           {"T": T0.clone()}, 30, watch_every=5,
                           install_sigterm=False, telemetry=False)
    assert res.steps_done == 30
    serving = degrade.active()["diffusion3d"]
    e = perf.best("diffusion3d", local_shape=(8, 8, 8), tier=serving)
    assert e is not None and e["sources"].get("verify_first_use") == 1
    assert e["sources"].get("watchdog", 0) >= 1
    assert perf.save() is not None
    assert any(v["tier"] == serving
               for v in entries(tmp_path / "ledger.json").values())
    # IGG_PERF=0 turns the run's attribution off.
    perf.reset()
    monkeypatch.setenv("IGG_PERF", "0")
    it.run_resilient(lambda s: {"T": step(s["T"], Cp)}, {"T": T0.clone()},
                     10, watch_every=5, install_sigterm=False,
                     telemetry=False)
    assert perf.query() == []


def test_calibrate_families_and_validation():
    it.init_global_grid(8, 8, 8, dimx=2, dimy=1, dimz=1, quiet=True,
                        device="cpu", periodx=1, periody=1, periodz=1)
    assert perf.calibrate("diffusion3d", nt=1, warmup=0) > 0
    e = perf.best("diffusion3d")
    assert e["sources"] == {"calibrate": 1}
    assert e["tier"] == degrade.active()["diffusion3d"]
    assert perf.calibrate("hm3d", nt=1, warmup=0) > 0
    calls = []
    sec = perf.calibrate(lambda x: calls.append(1) or x, (torch.ones(3),),
                         family="custom", tier="custom.plain", nt=2,
                         warmup=0)
    assert sec >= 0 and len(calls) == 8
    assert perf.best("custom")["tier"] == "custom.plain"
    with pytest.raises(it.GridError, match="unknown family"):
        perf.calibrate("nosuch")
    with pytest.raises(it.GridError, match="family="):
        perf.calibrate(lambda x: x, (1,))
    with pytest.raises(it.GridError, match="args="):
        perf.calibrate(lambda x: x, family="f")
    with pytest.raises(it.GridError, match="nt"):
        perf.calibrate("diffusion3d", nt=0)
    it.finalize_global_grid()
    it.init_global_grid(8, 8, 8, quiet=True, device="cpu", periodx=1,
                        periody=1, periodz=1, overlapx=3, overlapy=3,
                        overlapz=3)
    assert perf.calibrate("stokes3d", nt=1, warmup=0) > 0
    assert {e["family"] for e in perf.query()} >= {"diffusion3d", "hm3d",
                                                   "stokes3d"}


def test_invalidate_evicts_the_tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("IGG_TUNE_CACHE", str(tmp_path / "tune.json"))
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu")
    ctx = perf.sample_context()
    perf.record("diffusion3d", "diffusion3d.cuda", 1.0, source="autotune",
                local_shape=(6, 6, 6), dtype="float32", dims=ctx["dims"],
                backend=ctx["backend"], device_kind=ctx["device_kind"])
    autotune.record_winner("diffusion3d", {"tier": "diffusion3d.cuda",
                                           "K": 8, "bx": 8, "ms": 1.0})
    assert autotune.get("diffusion3d") is not None
    assert perf.invalidate("diffusion3d") == 1
    assert perf.best("diffusion3d") is None
    assert autotune.get("diffusion3d") is None
    assert not entries(tmp_path / "tune.json")
    inv = [r.payload for r in tel.flight_recorder()
           if r.kind == "perf_invalidated"]
    assert inv[-1]["tune_evicted"] == 1


def test_stale_calibration_fires_drift_once():
    """The injector installs a wrong prediction: the next samples fire
    `cost_model_drift` once for the tier; disarming restores the earlier
    prediction unless a recalibration replaced it."""
    perf.predict("diffusion3d", 0.002, source="cost_model")
    with chaos.stale_calibration("diffusion3d", 10 * 0.002):
        for _ in range(3):
            perf.record("diffusion3d", "diffusion3d.cuda", 2.0, **CTX)
    drifts = [r.payload for r in tel.flight_recorder()
              if r.kind == "cost_model_drift"]
    assert len(drifts) == 1
    assert drifts[0]["prediction_source"] == "chaos"
    assert drifts[0]["rel_error"] == pytest.approx(9.0)
    assert perf._PREDICTIONS["diffusion3d"]["source"] == "cost_model"
    inj = chaos.stale_calibration("hm3d", 1.0).arm()
    perf.forget_prediction("hm3d")
    perf.predict("hm3d", 0.5, source="recalibrated")
    inj.disarm()
    assert perf._PREDICTIONS["hm3d"]["source"] == "recalibrated"


def test_perf_and_tune_knobs_are_registered():
    from igg_torch import _env

    for name in ("IGG_PERF", "IGG_PERF_LEDGER", "IGG_PERF_SAVE_EVERY",
                 "IGG_PERF_DRIFT_TOL", "IGG_TUNE", "IGG_TUNE_CACHE",
                 "IGG_TUNE_NT", "IGG_TUNE_CUTOFF"):
        assert name in _env._KNOWN, name
