"""Cartesian block-grid topology: `dims_create` with the `MPI_Dims_create`
contract, the port's copy of `igg/topology.py`'s factorization (the JAX
mesh construction has no counterpart: blocks are laid out stacked on one
device)."""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .shared import NDIMS, GridError


def _prime_factors(n: int) -> List[int]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def dims_create(nprocs: int, dims: Sequence[int], *,
                local_shape: Optional[Sequence[int]] = None,
                itemsize: int = 8) -> Tuple[int, ...]:
    """Balanced factorization of `nprocs` over the free (0) entries of `dims`.

    Fixed (non-zero) entries are kept; free entries are as close to each
    other as possible, in non-increasing order.  With `local_shape`, ties
    between permutations of the same balanced slots go to the one that
    moves the fewest halo-plane bytes (:func:`plane_wire_bytes`); equal
    bytes keep the `MPI_Dims_create` order.
    """
    dims = [int(d) for d in dims]
    if len(dims) != NDIMS:
        raise GridError(f"dims must have {NDIMS} entries, got {len(dims)}")
    if any(d < 0 for d in dims):
        raise GridError(f"dims entries must be >= 0, got {dims}")
    fixed = int(np.prod([d for d in dims if d > 0])) if any(d > 0 for d in dims) else 1
    if nprocs % fixed != 0:
        raise GridError(
            f"nprocs ({nprocs}) is not divisible by the product of the fixed "
            f"dims ({fixed}).")
    free_idx = [i for i, d in enumerate(dims) if d == 0]
    rem = nprocs // fixed
    if not free_idx:
        if rem != 1:
            raise GridError(
                f"the product of the fixed dims ({fixed}) does not equal "
                f"nprocs ({nprocs}).")
        return tuple(dims)
    slots = [1] * len(free_idx)
    for f in sorted(_prime_factors(rem), reverse=True):
        slots[int(np.argmin(slots))] *= f
    slots.sort(reverse=True)
    out = list(dims)
    for i, s in zip(free_idx, slots):
        out[i] = s
    if local_shape is not None and len(set(slots)) > 1:
        ls = [int(v) for v in local_shape]
        best, best_bytes = None, None
        # Reverse-lexicographic order puts the MPI-ordered assignment first,
        # so a bytes tie preserves it.
        for perm in sorted(set(itertools.permutations(slots)), reverse=True):
            cand = list(dims)
            for i, s in zip(free_idx, perm):
                cand[i] = s
            b = plane_wire_bytes(cand, ls, itemsize=itemsize)
            if best_bytes is None or b < best_bytes:
                best, best_bytes = cand, b
        out = best
    return tuple(out)


def plane_wire_bytes(dims: Sequence[int], local: Sequence[int],
                     itemsize: int = 8, nfields: int = 1) -> int:
    """Halo-plane bytes of one exchange of `nfields` fields of `local`-shaped
    blocks under the `dims` decomposition: two planes per block side per
    split dimension, summed over the blocks."""
    dims = [int(d) for d in dims]
    local = [int(n) for n in local]
    nprocs = int(np.prod(dims))
    elems = int(np.prod(local))
    total = 0
    for d in range(min(len(dims), len(local))):
        if dims[d] > 1:
            total += 2 * int(nfields) * (elems // local[d]) * int(itemsize) * nprocs
    return total
