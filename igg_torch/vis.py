"""Background render/IO worker for in-situ visualization (the port's
`igg/vis.py`).

Frames are captured at simulation time and handed to a worker thread,
which does the device-to-host fetch and the rendering while the solver
launches the next window; the bounded queue gives backpressure.

A capture here is not what igg hands over.  A JAX array never changes, so igg
hands the worker a lazy device-resident slice.  The port's fields are
overwritten in place (`update_halo`, the models' ping-pong buffers), so a
view handed to the worker would show a later state.  Here
:meth:`BackgroundRenderer.submit` replaces every tensor of the batch by a
device-side COPY before it returns: a `clone()` on the caller's current
stream, never a view, with an event recorded after the clones.  The worker
runs `consume` on a stream of its own that first waits for that event, so
a fetch there (`.cpu()`, `igg_torch.gather`) reads the state of the
`submit` call, whatever the caller launches after it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List

import torch

__all__ = ["BackgroundRenderer"]


def _snapshot(batch, clones: List[torch.Tensor]):
    """`batch` with every tensor in it (through lists, tuples and dicts)
    replaced by a clone; the clones are appended to `clones`."""
    if isinstance(batch, torch.Tensor):
        copy = batch.detach().clone()
        clones.append(copy)
        return copy
    if isinstance(batch, list):
        return [_snapshot(b, clones) for b in batch]
    if isinstance(batch, tuple):
        out = [_snapshot(b, clones) for b in batch]
        return type(batch)(*out) if hasattr(batch, "_fields") else tuple(out)
    if isinstance(batch, dict):
        return {k: _snapshot(v, clones) for k, v in batch.items()}
    return batch


class BackgroundRenderer:
    """Run `consume(batch)` for each submitted batch on a worker thread.

    `consume` receives what :meth:`submit` was given, its tensors replaced
    by copies taken at the `submit` call (module docstring), and does the
    fetch and render there; exceptions are collected on :attr:`errors` and
    returned by :meth:`close` instead of killing the run mid-flight.
    `maxsize` bounds the outstanding batches (submit blocks beyond it:
    backpressure, which also bounds the device memory the copies hold).
    :meth:`drain` blocks until every batch submitted so far has been
    consumed WITHOUT stopping the worker.  Use as a context manager or
    call :meth:`close`, which drains the queue, joins the worker and
    returns the error list; the drain is part of the caller's wall-clock.
    """

    def __init__(self, consume: Callable, *, maxsize: int = 3,
                 name: str = "igg-render"):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._errors: List[BaseException] = []
        self._closed = False
        # The worker runs in the grid scope of the thread that made the
        # renderer (a serve worker's thread-scoped grid), so a `consume`
        # that reads the grid (a checkpoint save) sees the caller's.
        from . import shared

        scope = shared.scope_of_caller()

        def loop():
            with shared.in_scope(scope):
                work()

        def work():
            streams: Dict[torch.device, torch.cuda.Stream] = {}
            while True:
                item = self._q.get()
                stop = item is None
                try:
                    if not stop:
                        self._run(consume, *item, streams)
                except BaseException as e:   # returned by close()/drain()
                    self._errors.append(e)
                finally:
                    item = None              # the copies go with the batch
                    self._q.task_done()
                if stop:
                    return

        self._t = threading.Thread(target=loop, daemon=True, name=name)
        self._t.start()

    @staticmethod
    def _run(consume, batch, clones, events, streams) -> None:
        """`consume(batch)` on the worker's stream of the clones' card,
        after that stream waited for the clones."""
        if not events:
            consume(batch)
            return
        dev = next(iter(events))
        stream = streams.get(dev)
        if stream is None:
            stream = streams[dev] = torch.cuda.Stream(dev)
        for event in events.values():
            stream.wait_event(event)
        for t in clones:
            if t.device.type == "cuda":
                # Freed here, the clone's memory must wait for this stream.
                t.record_stream(stream)
        with torch.cuda.stream(stream):
            consume(batch)

    @property
    def errors(self) -> List[BaseException]:
        return list(self._errors)

    def submit(self, batch) -> None:
        """Queue one batch for the worker (blocks when `maxsize` batches
        are outstanding); its tensors are copied before this returns.
        `None` is reserved as the shutdown sentinel."""
        if batch is None:
            raise ValueError("BackgroundRenderer.submit: None is the "
                             "shutdown sentinel; submit a non-None batch.")
        if self._closed:
            raise RuntimeError("BackgroundRenderer is closed.")
        clones: List[torch.Tensor] = []
        batch = _snapshot(batch, clones)
        events = {}
        for t in clones:
            if t.device.type == "cuda" and t.device not in events:
                events[t.device] = torch.cuda.Event()
                events[t.device].record(torch.cuda.current_stream(t.device))
        self._q.put((batch, clones, events))

    def drain(self) -> List[BaseException]:
        """Block until every batch submitted so far is consumed (the worker
        stays alive for more submissions) and return the errors collected
        so far."""
        self._q.join()
        return self.errors

    def close(self) -> List[BaseException]:
        """Drain remaining batches, stop the worker, and return any errors
        it collected."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._t.join()
        return self.errors

    def __enter__(self) -> "BackgroundRenderer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
