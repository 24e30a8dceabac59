"""igg_torch.top — a terminal dashboard over the :mod:`igg_torch.statusd`
live endpoint or, offline, over a telemetry directory (one renderer for
both; the port of `igg/top.py`).

::

    python -m igg_torch.top http://127.0.0.1:9100      # live endpoint
    python -m igg_torch.top /tmp/run1                  # offline artifacts
    python -m igg_torch.top http://host:9100 --every 1 # refresh cadence
    python -m igg_torch.top /tmp/run1 --once           # one frame (CI)

One frame renders: health (ready / NOT READY with the machine-readable
reasons), per-run step rate and progress, the serving tier per family
(the port's names), the exposed-comm fraction, device memory (absent
where no allocator reports: the CPU), rank skew (two ranks or more), the
heal ledger's tail, the fleet and serve sections, and the last N events.

Live mode polls ``/status`` and ``/events?n=`` and repaints with a plain
ANSI clear (`--plain` suppresses the escape codes, as does a stdout that
is not a tty); offline mode rebuilds the same document from the session's
files, which are igg's: per rank its ``statusd_r*.json`` snapshot where
one was published, else its newest ``metrics_r*.jsonl`` line; the
``events_r*.jsonl`` streams, else the newest flight dump (both filename
forms).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

from .shared import GridError

_DEFAULT_EVENTS = 12


# ---------------------------------------------------------------------------
# Sources: the live endpoint, or a telemetry directory
# ---------------------------------------------------------------------------

def fetch_endpoint(base_url: str, n: int = _DEFAULT_EVENTS
                   ) -> Tuple[dict, List[dict]]:
    """`(status, events)` from a live `igg_torch.statusd` endpoint."""
    from urllib.request import urlopen

    base = base_url.rstrip("/")
    with urlopen(f"{base}/status", timeout=5) as r:
        raw = r.read().decode()
    try:
        status = json.loads(raw)
    except ValueError:
        # A non-statusd HTTP server (nginx, a docs server) answers 200
        # with HTML — a clean CLI error, not a traceback.
        raise GridError(f"igg_torch.top: {base}/status did not return "
                        f"JSON — is this an igg_torch.statusd endpoint?"
                        ) from None
    events = []
    with urlopen(f"{base}/events?n={int(n)}", timeout=5) as r:
        for line in r.read().decode().splitlines():
            line = line.strip()
            if line:
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return status, events


def _parse_prom_key(key: str) -> Tuple[str, Dict[str, str]]:
    """'name{a="b",c="d"}' -> (name, {a: b, c: d}) — the snapshot-key
    inverse, naive about escaped quotes (a dashboard, not a parser)."""
    if "{" not in key:
        return key, {}
    name, rest = key.split("{", 1)
    rest = rest.rstrip("}")
    labels: Dict[str, str] = {}
    for part in rest.split('",'):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        labels[k.strip()] = v.strip().strip('"')
    return name, labels


def _samples_from_snapshot(snap: dict) -> List[dict]:
    """Structured samples from a `metrics_r<rank>.jsonl` snapshot line's
    ``metrics`` dict (exposition keys -> {type, value, ...})."""
    out = []
    for key, body in (snap or {}).items():
        name, labels = _parse_prom_key(key)
        out.append({"name": name, "labels": labels, **body})
    return out


def build_from_dir(directory, n: int = _DEFAULT_EVENTS
                   ) -> Tuple[dict, List[dict]]:
    """`(status, events)` rebuilt OFFLINE from a telemetry directory —
    the same document shape the live endpoint serves, so the renderer
    is shared.  Health is reported as unknown (an episode's drain is a
    live verdict; artifacts alone cannot prove recovery)."""
    from . import comm as _comm
    from . import telemetry as _telemetry

    d = pathlib.Path(directory)
    if not d.is_dir():
        raise GridError(f"igg_torch.top: {d} is not a directory (pass a "
                        f"telemetry session dir or an http:// endpoint).")

    # Event streams: the per-rank JSONL sinks; a run that died before
    # writing any still has its flight dump(s) — both filename forms.
    records: List[dict] = []
    if list(d.glob("events_r*.jsonl")):
        records = _telemetry.merge_streams([d])
    else:
        dumps = _telemetry.flight_dumps(d)
        if dumps:
            try:
                doc = json.loads(dumps[0].read_text())
                records = [r for r in doc.get("events", [])
                           if isinstance(r, dict)]
            except (OSError, json.JSONDecodeError):
                records = []
    records = [r for r in records if r.get("kind") != "merge_summary"]

    # Metric samples: each rank's statusd_r*.json snapshot when the ops
    # plane published one, its newest metrics_r*.jsonl line otherwise —
    # rank 0 serves HTTP and never publishes a snapshot, so the two
    # sources MERGE per rank rather than exclude each other.
    samples: List[dict] = []
    covered: set = set()

    def _rank_of(f) -> Optional[int]:
        try:
            return int(f.stem.rsplit("_r", 1)[1])
        except (IndexError, ValueError):
            return None

    for f in sorted(d.glob("statusd_r*.json")):
        try:
            doc = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(doc.get("metrics"), list):
            samples.extend(doc["metrics"])
            covered.add(_rank_of(f))
    for f in sorted(d.glob("metrics_r*.jsonl")):
        if _rank_of(f) in covered:
            continue
        try:
            lines = [ln for ln in f.read_text().splitlines()
                     if ln.strip()]
            snap = json.loads(lines[-1]) if lines else {}
        except (OSError, json.JSONDecodeError, IndexError):
            continue
        samples.extend(_samples_from_snapshot(snap.get("metrics")))

    # One source of truth for the event-stream folding: the live
    # tracker's, fed the serialized records.
    from .statusd import HealthState
    health = HealthState(max_fetch_lag=0)
    for r in records:
        health.feed(r)
    view = health.view()

    tiers: Dict[str, str] = {}
    hbm_in_use = hbm_limit = 0.0
    comm_fraction = None
    for s in samples:
        name, labels = s.get("name"), s.get("labels") or {}
        if name == "igg_tier_dispatch_total":
            fam, tier = labels.get("family"), labels.get("tier")
            if fam and tier:
                # Offline best-effort: the busiest tier per family.
                cur = tiers.get(fam)
                if cur is None or s.get("value", 0) >= tiers.get(
                        "_n_" + fam, 0):
                    tiers[fam] = tier
                    tiers["_n_" + fam] = s.get("value", 0)
        elif name == "igg_hbm_bytes_in_use":
            hbm_in_use += float(s.get("value") or 0)
        elif name == "igg_hbm_bytes_limit":
            hbm_limit += float(s.get("value") or 0)
        elif name == "igg_exposed_comm_fraction":
            comm_fraction = float(s.get("value") or 0)
    tiers = {k: v for k, v in tiers.items() if not k.startswith("_n_")}
    hbm = None
    if hbm_limit:
        hbm = {"bytes_in_use": hbm_in_use, "bytes_limit": hbm_limit,
               "pct_in_use": 100.0 * hbm_in_use / hbm_limit}

    skew = _comm.rank_skew(records)
    status = {
        "wall": time.time(), "offline": True,
        "health": {"ready": None,
                   "reasons": [{"reason": "offline",
                                "detail": "artifact view — live "
                                          "readiness needs the "
                                          "endpoint"}]},
        "runs": view["runs"],
        "tiers": tiers,
        "quarantine": {},
        "members": view["members"],
        "heal": view["heal"][-16:],
        "integrity": view.get("integrity"),
        "checkpoint": view["checkpoint"],
        "fleet": None,
        "serve": None,
        "hbm": hbm,
        "gauges": ({"igg_exposed_comm_fraction": comm_fraction}
                   if comm_fraction is not None else {}),
        "rank_skew_ms": (skew["max_skew_ms"] if skew["per_step"] else None),
        "ranks": {},
    }
    return status, records[-n:]


# ---------------------------------------------------------------------------
# The renderer (shared by both sources)
# ---------------------------------------------------------------------------

def _fmt_bytes(b) -> str:
    try:
        b = float(b)
    except (TypeError, ValueError):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024 or unit == "TiB":
            return f"{b:.1f} {unit}"
        b /= 1024
    return "-"


def _rank_skew_from_status(status: dict) -> Optional[float]:
    if status.get("rank_skew_ms") is not None:
        return status["rank_skew_ms"]
    # Skew is THE SAME run compared across ranks (worst vs median, the
    # igg_torch.comm.rank_skew convention) — mixing different runs' window
    # times, or one rank's runs with another's, fabricates skew on a
    # perfectly balanced job.
    by_run: Dict[str, List[float]] = {}

    def _collect(runs_doc):
        for name, info in (runs_doc or {}).items():
            ms = (info or {}).get("ms_per_step")
            if isinstance(ms, (int, float)):
                by_run.setdefault(name, []).append(float(ms))

    _collect(status.get("runs"))
    for rank_doc in (status.get("ranks") or {}).values():
        _collect((rank_doc or {}).get("runs"))
    worst = None
    for windows in by_run.values():
        if len(windows) < 2:
            continue
        windows.sort()
        k = len(windows)
        median = (windows[k // 2] if k % 2
                  else 0.5 * (windows[k // 2 - 1] + windows[k // 2]))
        skew = windows[-1] - median
        worst = skew if worst is None else max(worst, skew)
    return worst


def render(status: dict, events: List[dict],
           n_events: int = _DEFAULT_EVENTS) -> str:
    """One dashboard frame as text (no escape codes — the caller owns
    the screen)."""
    lines: List[str] = []
    health = status.get("health") or {}
    ready = health.get("ready")
    if ready is True:
        head = "READY"
    elif ready is False:
        reasons = ",".join(r.get("reason", "?")
                           for r in health.get("reasons", []))
        head = f"NOT READY ({reasons})"
    else:
        head = "OFFLINE VIEW"
    when = time.strftime("%H:%M:%S", time.localtime(
        status.get("wall", time.time())))
    lines.append(f"igg_torch.top — {head} — {when}"
                 + (f" — rank {status['process']}"
                    if "process" in status else ""))
    lines.append("-" * 72)

    runs = status.get("runs") or {}
    if runs:
        for name in sorted(runs):
            info = runs[name]
            done = info.get("steps_done")
            total = info.get("n_steps")
            sps = info.get("steps_per_s")
            frac = (f" ({100.0 * done / total:.0f}%)"
                    if isinstance(done, (int, float))
                    and isinstance(total, (int, float)) and total else "")
            state = ("done" if info.get("finished")
                     else f"{sps:.1f} steps/s" if isinstance(
                         sps, (int, float)) else "running")
            lag = info.get("fetch_lag_steps")
            lag_s = (f", fetch lag {int(lag)}"
                     if isinstance(lag, (int, float)) else "")
            lines.append(f"run {name:<10} step {done}/{total}{frac}  "
                         f"[{state}{lag_s}]")
    else:
        lines.append("run: (none observed yet)")

    tiers = status.get("tiers") or {}
    if tiers:
        lines.append("tiers: " + "  ".join(
            f"{fam}->{tier}" for fam, tier in sorted(tiers.items())))
    quar = status.get("quarantine") or {}
    if quar:
        lines.append("quarantined tiers: " + ", ".join(sorted(quar)))
    members = status.get("members") or {}
    if members.get("total"):
        lines.append(f"members: {members['total']} "
                     f"({len(members.get('quarantined') or [])} "
                     f"quarantined)")

    row = []
    gauges = status.get("gauges") or {}
    frac = gauges.get("igg_exposed_comm_fraction")
    if frac is not None:
        row.append(f"exposed comm {100.0 * float(frac):.1f}%")
    hbm = status.get("hbm")
    if hbm and hbm.get("pct_in_use") is not None:
        row.append(f"HBM {hbm['pct_in_use']:.1f}% "
                   f"({_fmt_bytes(hbm.get('bytes_in_use'))} / "
                   f"{_fmt_bytes(hbm.get('bytes_limit'))})")
    elif hbm:
        row.append(f"HBM in use {_fmt_bytes(hbm.get('bytes_in_use'))}")
    else:
        row.append("HBM: n/a (no allocator stats)")
    skew = _rank_skew_from_status(status)
    if skew is not None:
        row.append(f"rank skew {skew:.2f} ms")
    lines.append("  ".join(row))

    ck = status.get("checkpoint")
    if ck:
        lines.append(f"checkpoint head: step {ck.get('step')} "
                     f"-> {ck.get('path')}")
    fleet = status.get("fleet")
    if fleet:
        counts = ", ".join(f"{k}={v}" for k, v in
                           sorted((fleet.get("by_status") or {}).items()))
        lines.append(f"fleet: {fleet.get('jobs')} job(s) [{counts}]")
    serve = status.get("serve")
    if serve:
        flags = ("" + (" SATURATED" if serve.get("saturated") else "")
                 + (" DRAINING" if serve.get("draining") else ""))
        fenced = serve.get("fenced_devices") or []
        fence_s = (", fenced " + ",".join(str(i) for i in fenced)
                   if fenced else "")
        lines.append(f"serve: queue {serve.get('queue_depth')}/"
                     f"{serve.get('queue_bound')}{flags}, running "
                     f"{len(serve.get('running') or [])}{fence_s}")
        for name, t in sorted((serve.get("tenants") or {}).items()):
            lines.append(
                f"  tenant {name:<12} q={t.get('queued')} "
                f"run={t.get('running')} done={t.get('done')} "
                f"quar={t.get('quarantined')} shed={t.get('shed')} "
                f"rej={t.get('rejected')} budget "
                f"{t.get('retries_used')}/{t.get('retry_budget')} "
                f"w={t.get('weight')}")
    heal = status.get("heal") or []
    if heal:
        last = heal[-1]
        lines.append(f"heal: {len(heal)} action record(s), last "
                     f"{last.get('kind')} @ step {last.get('step')}")
    integ = status.get("integrity") or {}
    viol = integ.get("violation")
    if viol:
        what = viol.get("invariant") or viol.get("field") or "?"
        who = viol.get("device") or (f"rank {viol.get('rank')}"
                                     if viol.get("rank") is not None
                                     else "unattributed")
        lines.append(f"integrity: VIOLATION LIVE ({viol.get('source')} "
                     f"{what}, suspect {who}) @ step {viol.get('step')}")
    elif integ.get("violations_total"):
        res = integ.get("resolved") or {}
        lines.append(f"integrity: {integ['violations_total']} "
                     f"violation(s), last resolved @ step "
                     f"{res.get('step')}")
    elif integ.get("config"):
        cfg = integ["config"]
        inv_names = ",".join(cfg.get("invariants") or [])
        lines.append(f"integrity: clean (invariants {inv_names or '-'}, "
                     f"check_every {cfg.get('check_every')})")

    lines.append("-" * 72)
    lines.append(f"last {min(n_events, len(events))} event(s):")
    for r in events[-n_events:]:
        wall = r.get("wall")
        ts = (time.strftime("%H:%M:%S", time.localtime(wall))
              if isinstance(wall, (int, float)) else "--:--:--")
        p = r.get("payload") or {}
        brief = ", ".join(f"{k}={p[k]}" for k in list(p)[:3])
        if len(brief) > 46:
            brief = brief[:43] + "..."
        lines.append(f"  {ts} r{r.get('process', 0)} "
                     f"{str(r.get('kind', '?')):<22} "
                     f"step {str(r.get('step', '-')):>6}  {brief}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _frame(target: str, n: int) -> str:
    if target.startswith(("http://", "https://")):
        status, events = fetch_endpoint(target, n)
    else:
        status, events = build_from_dir(target, n)
    return render(status, events, n)


def _main(argv) -> int:
    usage = ("usage: python -m igg_torch.top <http://host:port | "
             "telemetry-dir> "
             "[--every SECONDS] [--once] [-n EVENTS] [--plain]")
    argv = list(argv)
    every = 2.0
    once = False
    plain = not sys.stdout.isatty()
    n = _DEFAULT_EVENTS
    target = None
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a == "--every":
                i += 1
                every = float(argv[i])
            elif a == "--once":
                once = True
            elif a == "--plain":
                plain = True
            elif a == "-n":
                i += 1
                n = int(argv[i])
            elif a in ("-h", "--help"):
                print(usage)
                return 0
            elif target is None:
                target = a
            else:
                print(usage, file=sys.stderr)
                return 2
            i += 1
    except (IndexError, ValueError):
        # A flag missing its value, or a non-numeric one: usage, not a
        # traceback.
        print(usage, file=sys.stderr)
        return 2
    if target is None:
        print(usage, file=sys.stderr)
        return 2
    try:
        while True:
            frame = _frame(target, n)
            if not plain:
                sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(frame)
            sys.stdout.flush()
            if once:
                return 0
            time.sleep(every)
    except KeyboardInterrupt:
        return 0
    except GridError as e:
        print(f"igg_torch.top: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"igg_torch.top: cannot reach {target}: {e}",
              file=sys.stderr)
        return 2


if __name__ == "__main__":   # python -m igg_torch.top ...
    sys.exit(_main(sys.argv[1:]))
