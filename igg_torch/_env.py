"""Typed accessors of the `IGG_*` environment knobs (the port's copy of
`igg/_env.py`).

Every environment variable the port reads goes through these accessors,
against a registry of the known names.  The registry holds igg's names,
so that a knob set for one package is never "unknown" to the other:

- the first accessor call scans the process environment for `IGG_`-prefixed
  names outside the registry and warns ONCE, listing them beside the knobs
  that exist (a misspelt knob would otherwise be silently ignored);
- an unparsable value raises `GridError` naming the variable and the
  expected type.

Extensions register their knobs with :func:`register` before first use so
the unknown-name sweep stays accurate.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

from .shared import GridError

# The registry: every IGG_* knob the library understands, with the one-line
# meaning shown when an unrecognized sibling is found.
_KNOWN: Dict[str, str] = {
    "IGG_ASSEMBLY": "pin the measured halo-assembly election (xla|writer)",
    "IGG_CKPT_COMMIT_TIMEOUT":
        "seconds to wait for sharded-checkpoint commit coordination",
    "IGG_COMM_STALL_TIMEOUT":
        "seconds before an unfetched async probe is reported as a "
        "collective stall (default 120; 0 disables the stall heartbeat)",
    "IGG_DIST_INIT_BACKOFF":
        "initial sleep between jax.distributed.initialize retries (s)",
    "IGG_DIST_INIT_TIMEOUT":
        "total seconds to keep retrying jax.distributed.initialize",
    "IGG_ENSEMBLE_MAX_PENDING_PROBES":
        "outstanding per-member watchdog probes before a forced fetch",
    "IGG_ENSEMBLE_RETRIES":
        "per-member rollback budget before a member is quarantined",
    "IGG_FLEET_BACKOFF":
        "initial sleep between fleet job-launch retries (s, doubling)",
    "IGG_FLEET_RETRIES":
        "launcher-fault retries per fleet job before it is marked failed",
    "IGG_HEAL":
        "1 enables the igg.heal self-healing engine on every run loop "
        "(default off; heal= on the run loops overrides)",
    "IGG_HEAL_COOLDOWN":
        "minimum seconds between consecutive heal actions (hysteresis; "
        "default 60)",
    "IGG_HEAL_MAX_ACTIONS":
        "heal-action budget per run before the escalation ladder "
        "(default 3)",
    "IGG_HEAL_SKEW_TOL":
        "straggler threshold: a watchdog window (or rank skew) beyond "
        "this factor of the healthy baseline plans a re-tile "
        "(default 4.0)",
    "IGG_HEAL_SUSTAIN":
        "consecutive observations a soft heal signal must persist "
        "before an action is planned (default 2)",
    "IGG_HEAL_THROUGHPUT_TOL":
        "lagging-job threshold: measured member_steps_per_s below this "
        "fraction of the expectation plans a repack (default 0.5)",
    "IGG_INTEGRITY":
        "1 enables the igg.integrity numeric-integrity layer on the run "
        "loops (default off; integrity= on the run loops overrides)",
    "IGG_INTEGRITY_CHECK_EVERY":
        "shadow re-execution cadence in watch windows (default 4; 0 "
        "disables the shadow spot checks)",
    "IGG_INTEGRITY_TOL":
        "relative invariant-drift tolerance of the integrity probes and "
        "the deep checkpoint verify (default 1e-3)",
    "IGG_INTEGRITY_DEEP_VERIFY":
        "0 stops integrity-enabled rollback/resume scans from preferring "
        "deep-verified generations (stamps are always written; default 1)",
    "IGG_NATIVE": "0 disables the native (C++) host-side runtime",
    "IGG_OVERLAP":
        "force (1/on) or pin off (0/off) the overlap='auto' knobs of the "
        "model factories and igg_torch.stencil.compile; unset defers to "
        "the "
        "autotuner's cached winner (igg_torch.overlap.resolve_overlap)",
    "IGG_NATIVE_THREADS": "thread count for the native re-tile/memcopy",
    "IGG_PERF": "0 disables perf-ledger recording (igg.perf)",
    "IGG_PERF_DRIFT_TOL":
        "relative cost-model error beyond which a cost_model_drift bus "
        "event fires (default 0.5)",
    "IGG_PERF_LEDGER":
        "path of the on-disk perf-ledger JSON (unset: in-memory only; "
        "rank-tagged automatically on multi-controller runs)",
    "IGG_PERF_SAVE_EVERY":
        "minimum seconds between perf-ledger autosaves (default 60)",
    "IGG_SERVE_MAX_CONCURRENT":
        "concurrent jobs the serve scheduler runs on disjoint device "
        "subsets (default 2; the bin-packer partitions the live devices)",
    "IGG_SERVE_QUEUE_BOUND":
        "global admission-queue bound of igg.serve — submissions past it "
        "shed with 429/job_shed and readiness pins queue_saturated "
        "(default 16)",
    "IGG_SERVE_TENANT_QUEUE_BOUND":
        "per-tenant admission-queue bound of igg.serve (default 8)",
    "IGG_SERVE_TENANT_RETRIES":
        "per-tenant retry budget: strikes a tenant's failing jobs may "
        "burn before its submissions shed and its jobs fail fast "
        "(default 8)",
    "IGG_SERVE_POLL":
        "serve scheduler tick interval in seconds (default 0.05)",
    "IGG_SERVE_MAX_BODY":
        "largest accepted submission body in bytes — bigger is rejected "
        "oversized (default 65536)",
    "IGG_STATUSD_PORT":
        "TCP port of the igg.statusd live ops endpoint (0/unset: off; "
        "the serve= knob on the run loops overrides)",
    "IGG_STATUSD_HOST":
        "bind address of the igg.statusd endpoint (default 127.0.0.1)",
    "IGG_STATUSD_HBM_EVERY":
        "minimum seconds between device memory_stats polls behind the "
        "igg_hbm_* gauges (default 10)",
    "IGG_STATUSD_MAX_FETCH_LAG":
        "watchdog fetch-lag (steps) beyond which /healthz readiness "
        "flips false (default 1000; 0 disables the lag check)",
    "IGG_STATUSD_PUBLISH_EVERY":
        "seconds between the non-zero-rank statusd snapshot files that "
        "rank 0's endpoint merges (default 5)",
    "IGG_TELEMETRY_DEVICE":
        "0 disables mirroring trace spans onto the device timeline "
        "(torch.profiler.record_function in igg_torch)",
    "IGG_TELEMETRY_DIR":
        "default igg.telemetry session directory (setting it attaches "
        "telemetry to every run loop)",
    "IGG_TELEMETRY_FLIGHT_RECORDER":
        "flight-recorder ring size (events kept for post-mortem dumps)",
    "IGG_TELEMETRY_METRICS_EVERY":
        "seconds between periodic metrics exports (0: at detach only)",
    "IGG_TELEMETRY_SPANS": "0 disables host-side trace-span capture",
    "IGG_TPU_TESTS": "1 runs the TPU-only test files on the real backend",
    # igg's autotuner registers these four when it is imported.
    "IGG_TUNE":
        "autotune default: 0 off, 1 search-on-miss, auto (default) "
        "cached winners only",
    "IGG_TUNE_CACHE":
        "path of the on-disk tuning-cache JSON (unset: in-memory "
        "only; rank-tagged on multi-controller runs)",
    "IGG_TUNE_NT":
        "slope-timing batch size per tuning candidate (default 2)",
    "IGG_TUNE_CUTOFF":
        "early-cutoff factor: a candidate whose first warm sample "
        "exceeds this multiple of the best-so-far skips the full "
        "measurement (default 2.0)",
    "IGG_VERIFY_KERNELS":
        "1 verifies every kernel tier against the truth tier (igg's XLA "
        "composition, igg_torch's plain PyTorch version) on first use",
}

_warned_unknown = False


def register(name: str, doc: str) -> None:
    """Add an extension's `IGG_*` knob to the known-name registry (call
    before the first accessor use so the unknown-name sweep stays
    accurate)."""
    if not name.startswith("IGG_"):
        raise GridError(f"_env.register: {name!r} is not an IGG_* name.")
    _KNOWN[name] = doc


def _sweep_unknown() -> None:
    """One-time warning for `IGG_`-prefixed environment variables the
    library does not understand — a typo'd knob silently ignored is its
    own robustness hole."""
    global _warned_unknown
    if _warned_unknown:
        return
    _warned_unknown = True
    unknown = sorted(n for n in os.environ
                     if n.startswith("IGG_") and n not in _KNOWN)
    if unknown:
        known = ", ".join(sorted(_KNOWN))
        warnings.warn(
            f"igg_torch: unrecognized IGG_* environment variable(s) "
            f"{', '.join(unknown)} — they have no effect (known knobs: "
            f"{known}).", stacklevel=3)


def text(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw string accessor (registry-checked)."""
    _sweep_unknown()
    assert name in _KNOWN, f"unregistered IGG knob {name!r} (add to _env)"
    return os.environ.get(name, default)


def number(name: str, default: float) -> float:
    val = text(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        raise GridError(f"{name}={val!r} is not a number.") from None


def integer(name: str, default: int) -> int:
    val = text(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        raise GridError(f"{name}={val!r} is not an integer.") from None


def flag(name: str, default: bool = False) -> bool:
    """Boolean knob: "1"/"true"/"yes"/"on" (case-insensitive) are true,
    "0"/"false"/"no"/"off"/"" are false; anything else raises."""
    val = text(name)
    if val is None:
        return default
    low = val.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off", ""):
        return False
    raise GridError(f"{name}={val!r} is not a boolean "
                    f"(use 1/0, true/false, yes/no, on/off).")
