"""The port's background render/IO worker (igg_torch.vis) held against
igg's on the CPU: the same script of submissions gives the same trace in
both (order of consumption, backpressure at `maxsize`, `drain` without
stopping, errors returned by `close`, misuse), and a tensor handed to
`submit` is a copy taken at the call, whatever the caller does to the
field after it."""

import threading
import time

import numpy as np
import pytest
import torch

from igg import vis as igg_vis
from igg_torch import vis as tvis
from torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {"igg": igg_vis.BackgroundRenderer,
            "port": tvis.BackgroundRenderer}


def _order(BR):
    seen = []
    with BR(seen.append, maxsize=2) as r:
        for i in range(10):
            r.submit([i, ("step", i)])
    return {"seen": seen, "errors": r.close()}


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.005)


def _backpressure(BR):
    """With the worker held inside `consume`, exactly `maxsize` more
    batches queue; the next submit blocks until the worker moves on."""
    gate, started, seen = threading.Event(), threading.Event(), []

    def consume(batch):
        started.set()
        gate.wait(10)
        seen.append(batch)

    r = BR(consume, maxsize=2)
    returned = []

    def producer():
        for i in range(5):
            r.submit(i)
            returned.append(i)

    t = threading.Thread(target=producer)
    t.start()
    started.wait(10)
    _wait_until(lambda: len(returned) >= 3)
    time.sleep(0.2)
    held = list(returned)
    gate.set()
    t.join(10)
    errors = r.close()
    return {"held": held, "seen": seen, "errors": errors}


def _drain(BR):
    seen = []
    r = BR(seen.append, maxsize=1)
    for i in range(3):
        r.submit(i)
    first = (r.drain(), list(seen), r._t.is_alive())
    r.submit(3)
    second = (r.drain(), list(seen))
    errors = r.close()
    return {"first": first, "second": second, "alive": r._t.is_alive(),
            "errors": errors}


def _errors(BR):
    seen = []

    def consume(batch):
        if batch % 2:
            raise ValueError(f"bad batch {batch}")
        seen.append(batch)

    r = BR(consume)
    for i in range(5):
        r.submit(i)
    mid = [str(e) for e in r.drain()]
    errors = r.close()
    return {"mid": mid, "seen": seen, "errors": [str(e) for e in errors],
            "types": [type(e).__name__ for e in errors],
            "again": [str(e) for e in r.close()]}


def _misuse(BR):
    out = {}
    r = BR(lambda b: None)
    try:
        r.submit(None)
    except ValueError as e:
        out["none"] = type(e).__name__
    r.close()
    try:
        r.submit(1)
    except RuntimeError as e:
        out["closed"] = str(e)
    return out


@pytest.mark.parametrize("script", [_order, _backpressure, _drain, _errors,
                                    _misuse])
def test_same_trace_as_igg(script):
    """The same script gives the same trace with igg's worker and the
    port's."""
    want = script(PACKAGES["igg"])
    got = script(PACKAGES["port"])
    assert got == want


def test_traces_are_what_the_contract_says():
    assert _order(tvis.BackgroundRenderer)["seen"] == \
        [[i, ("step", i)] for i in range(10)]
    bp = _backpressure(tvis.BackgroundRenderer)
    assert bp["held"] == [0, 1, 2] and bp["seen"] == list(range(5))
    dr = _drain(tvis.BackgroundRenderer)
    assert dr["first"] == ([], [0, 1, 2], True)
    assert dr["second"] == ([], [0, 1, 2, 3]) and not dr["alive"]
    er = _errors(tvis.BackgroundRenderer)
    assert er["seen"] == [0, 2, 4]
    assert er["errors"] == ["bad batch 1", "bad batch 3"] == er["mid"]
    assert _misuse(tvis.BackgroundRenderer) == {
        "none": "ValueError", "closed": "BackgroundRenderer is closed."}


def test_capture_holds_the_state_of_the_submit():
    """The field changes in place right after `submit` (and while the
    worker is held); the worker sees the values of the call, in every
    container the batch nests them in, and never the live tensor."""
    rng = np.random.default_rng(5)
    T = torch.from_numpy(rng.standard_normal((8, 6, 5)))
    V = torch.from_numpy(rng.standard_normal((9, 6, 5)).astype(np.float32))
    gate, got = threading.Event(), []

    def consume(batch):
        gate.wait(10)
        got.append(batch)

    frames = []
    with tvis.BackgroundRenderer(consume, maxsize=4) as r:
        for step in range(3):
            frames.append((T.clone(), V.clone()))
            r.submit([(step, T), {"V": V, "tag": "v"}])
            T.add_(1.0)
            V.mul_(2.0)
        gate.set()
    assert len(got) == 3
    for step, (batch, (t0, v0)) in enumerate(zip(got, frames)):
        (s, t), d = batch
        assert s == step and d["tag"] == "v"
        assert t is not T and d["V"] is not V
        assert torch.equal(t, t0) and torch.equal(d["V"], v0)
        assert t.data_ptr() != T.data_ptr()
