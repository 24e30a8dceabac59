"""Step timing by the slope method (the port's `igg/timing.py`).

Seconds per call of `state = step(*state)`: a batch of N1 calls and a
batch of N2 calls are each ended by a device synchronization, and the
constant cost of that synchronization cancels in `(T2 - T1) / (N2 - N1)`.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

__all__ = ["time_steps"]


def _sync(state) -> None:
    """Wait until the devices holding `state` have finished their work."""
    for t in state:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


def time_steps(step: Callable, state: Tuple, *, n1: int = 10, n2: int = 50,
               warmup: int = 3) -> Tuple[Tuple, float]:
    """Seconds per call of `state = step(*state)`, slope-measured.  `step`
    returns the new state (a tuple, or one tensor for 1-element states).
    Returns `(state, sec_per_call)`; exactly `warmup + n1 + n2` calls run."""
    if n2 <= n1:
        raise ValueError(f"need n2 > n1, got n1={n1} n2={n2}")

    def advance(n: int) -> float:
        nonlocal state
        t0 = time.monotonic()
        for _ in range(n):
            out = step(*state)
            state = out if isinstance(out, tuple) else (out,)
        _sync(state)
        return time.monotonic() - t0

    state = tuple(state) if isinstance(state, tuple) else (state,)
    advance(warmup)
    t1 = advance(n1)
    t2 = advance(n2)
    if t2 > t1:
        return state, (t2 - t1) / (n2 - n1)
    # Noise swamped the slope: the batch-2 average, an overestimate.
    return state, t2 / n2
