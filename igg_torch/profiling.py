"""Profiling hooks (the port of `igg/profiling.py`).

:func:`trace` captures a `torch.profiler` trace of a block: the host's
operators always, and the card's kernels where a card is present.  Spans
recorded through :mod:`igg_torch.telemetry` are mirrored onto the same
timeline as `torch.profiler.record_function` ranges, so a trace captured
here lines up with the event stream.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import tempfile
import threading

from .shared import GridError

# One trace at a time: a second profiler started inside an active one
# would break the enclosing capture, so nesting is refused up front.
_lock = threading.Lock()
_active_logdir = None


def trace_file(logdir) -> pathlib.Path:
    """The Chrome trace :func:`trace` writes into `logdir`:
    `profile_r<rank>.json` (the rank as in :mod:`igg_torch.telemetry`)."""
    from .telemetry import _process

    return pathlib.Path(logdir) / f"profile_r{_process()}.json"


@contextlib.contextmanager
def trace(logdir=None):
    """Capture a profiler trace of the enclosed block::

        with igg_torch.profiling.trace("/path/trace"):
            for _ in range(10):
                T = step(T, Cp)

    and write it as a Chrome trace, :func:`trace_file` of `logdir`
    (default: `igg_torch_trace` under the temporary directory), which
    opens in ui.perfetto.dev or chrome://tracing.  The directory is
    created, parents included.  Nesting a second `trace()` inside an
    active one raises :class:`igg_torch.GridError`; a profiler that fails
    to start leaves no trace active.  Entry and exit are recorded on the
    event bus (`trace_started` / `trace_stopped`)."""
    import torch

    from . import telemetry as _telemetry

    global _active_logdir
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "igg_torch_trace")
    with _lock:
        if _active_logdir is not None:
            raise GridError(
                f"igg_torch.profiling.trace: a trace is already active "
                f"(logdir {_active_logdir!r}) — traces do not nest; close "
                f"the enclosing trace first.")
        _active_logdir = str(logdir)
    try:
        pathlib.Path(logdir).mkdir(parents=True, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except BaseException:
        with _lock:
            _active_logdir = None
        raise
    _telemetry.emit("trace_started", logdir=str(logdir))
    try:
        yield logdir
    finally:
        try:
            prof.stop()
            prof.export_chrome_trace(str(trace_file(logdir)))
        finally:
            with _lock:
                _active_logdir = None
            _telemetry.emit("trace_stopped", logdir=str(logdir))


def annotate(name: str):
    """A named range on the profiler's timeline
    (`torch.profiler.record_function`).  :func:`igg_torch.telemetry.span`
    opens the same range and also records the region on the event bus."""
    import torch

    return torch.profiler.record_function(name)
