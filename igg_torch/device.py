"""Device selection and allocator statistics (the port's `igg/device.py`).

One process drives one card: `select_device` binds this process to its
node-local card with `torch.cuda.set_device`, raising where the node has
fewer cards than the local rank needs (the reference's over-subscription
error).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from .shared import GridError


def select_device(local_rank: Optional[int] = None) -> int:
    """Bind this process to card `local_rank` (default: the `LOCAL_RANK`
    that a `torch.distributed` launcher sets, else 0) and return its index."""
    if not torch.cuda.is_available():
        raise GridError("Cannot select a device: torch.cuda.is_available() "
                        "is False.")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if not 0 <= local_rank < n:
        raise GridError(f"Cannot select a device: local rank {local_rank} "
                        f"but this node has {n} card(s).")
    torch.cuda.set_device(local_rank)
    return local_rank


def same_device(a, b) -> bool:
    """Whether two `torch.device`s name one device, an index-less CUDA
    device read as the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda" and (a.index is None) != (b.index is None):
        cur = torch.cuda.current_device()
        a = a if a.index is not None else torch.device("cuda", cur)
        b = b if b.index is not None else torch.device("cuda", cur)
    return a == b


def memory_stats(device=None) -> List[dict]:
    """Allocator statistics of the card(s): one entry per CUDA device of
    `device` (default: every visible card).  A CPU device reports nothing:
    an empty list, never an invented number."""
    if not torch.cuda.is_available():
        return []
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return []
        indices = [dev.index if dev.index is not None
                   else torch.cuda.current_device()]
    else:
        indices = list(range(torch.cuda.device_count()))
    out = []
    for i in indices:
        out.append({
            "device": f"cuda:{i}",
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_reserved": int(torch.cuda.memory_reserved(i)),
        })
    return out
