"""`sharded`: run a function written for one local block on every block of
the grid (the port's `igg.sharded`).

Each block runs the function in a thread of its own, as a rank would.
Inside, the function sees its local blocks, :func:`local_coords` gives its
grid coordinates, and :func:`igg_torch.update_halo_local` is a collective:
every block's call waits for the others, the stacked fields are updated
once, and each block gets its updated local arrays back (in place).
"""

from __future__ import annotations

import threading
from functools import wraps
from typing import List, Optional

import torch

from . import shared
from .shared import NDIMS, GridError

# Seconds a block waits for the others at a collective before giving up.
_COLLECTIVE_TIMEOUT = 300.0


class _Group:
    """The blocks of one `sharded` call and their collective state."""

    def __init__(self, grid):
        self.grid = grid
        self.barrier = threading.Barrier(grid.nprocs, timeout=_COLLECTIVE_TIMEOUT)
        self.slots: List = [None] * grid.nprocs


class _Context:
    def __init__(self, group: _Group, rank: int):
        self.group = group
        self.rank = rank
        self.coords = group.grid.cart_coords(rank)

    def update_halo(self, fields, plain: bool):
        from .halo import update_halo
        g = self.group
        g.slots[self.rank] = fields
        if g.barrier.wait() == 0:
            stacked = [_stack([g.slots[r][i] for r in range(g.grid.nprocs)],
                              g.grid) for i in range(len(fields))]
            update_halo(*stacked, plain=plain)
            for r in range(g.grid.nprocs):
                for A, S in zip(g.slots[r], stacked):
                    A.copy_(_block(S, g.grid, g.grid.cart_coords(r)))
        g.barrier.wait()
        return fields[0] if len(fields) == 1 else fields


def _block_context() -> Optional[_Context]:
    return getattr(shared.block, "ctx", None)


def local_coords():
    """Grid coordinates of the block running this code inside `sharded`."""
    ctx = _block_context()
    if ctx is None:
        raise GridError("local_coords() is only defined inside igg_torch.sharded")
    return ctx.coords


def _block(A, grid, coords):
    s = grid.local_shape(A)
    return A[tuple(slice(coords[d] * s[d], (coords[d] + 1) * s[d])
                   for d in range(min(A.ndim, NDIMS)))]


def _stack(blocks, grid):
    """The stacked array of per-rank local `blocks`."""
    b0 = blocks[0]
    shape = tuple(b0.shape[d] * (grid.dims[d] if d < NDIMS else 1)
                  for d in range(b0.ndim))
    out = torch.empty(shape, dtype=b0.dtype, device=b0.device)
    for r, b in enumerate(blocks):
        _block(out, grid, grid.cart_coords(r)).copy_(b)
    return out


def sharded(fn=None):
    """Decorate `fn(*local_args)` so that calling it with stacked grid
    arrays runs it on every block and returns the stacked results.
    Tensor arguments are split into local blocks; other arguments are
    passed to every block as they are.  `fn` returns a tensor or a tuple
    of tensors of local shape."""
    def deco(f):
        @wraps(f)
        def wrapper(*args):
            grid = shared.global_grid()
            group = _Group(grid)
            outs: List = [None] * grid.nprocs
            errors: List = []

            def run(rank):
                ctx = _Context(group, rank)
                shared.block.ctx = ctx
                try:
                    local = [(_block(a, grid, ctx.coords).clone()
                              if isinstance(a, torch.Tensor) and a.ndim else a)
                             for a in args]
                    outs[rank] = f(*local)
                except threading.BrokenBarrierError as e:
                    errors.append(e)
                except Exception as e:     # re-raised below; free the others
                    errors.insert(0, e)
                    group.barrier.abort()
                finally:
                    shared.block.ctx = None

            threads = [threading.Thread(target=run, args=(r,))
                       for r in range(grid.nprocs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            if isinstance(outs[0], tuple):
                return tuple(_stack([o[i] for o in outs], grid)
                             for i in range(len(outs[0])))
            return _stack(outs, grid)
        return wrapper

    return deco(fn) if fn is not None else deco
