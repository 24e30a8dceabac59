"""Layouts and sources the tests of the halo writer share
(tests/test_torch_kernel_sources.py on the CPU through g++,
tests/test_torch_kernels.py on a card): ranks 1-3 on blocks (1,1,1),
(2,2,2) and (4,2,1) of odd local extents (z long enough for whole 16-byte
copies of 2-, 4- and 8-byte elements between a z block's halo cells), and
every mix of WRAP, EXT and NONE sources per dim, EXT planes random, made
with numpy from a seed."""

import itertools

import numpy as np
import torch

# (blocks, local extents) per rank.
LAYOUTS = [(blocks[:r], (5, 7, 19)[3 - r:]) for r in (1, 2, 3)
           for blocks in ((1, 1, 1), (2, 2, 2), (4, 2, 1))]


def mixes(blocks):
    """Every mix of "wrap", "ext" and "none" over the dims of `blocks`
    (WRAP on one-block dims only)."""
    for modes in itertools.product(("wrap", "ext", "none"),
                                   repeat=len(blocks)):
        if not any(m == "wrap" and b != 1 for m, b in zip(modes, blocks)):
            yield modes


def _uniform(shape, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(-100, 100, shape)).to(dtype)
            .to(device))


def field(shape, dtype, offset, seed, device="cpu"):
    """A random field of `shape` at element `offset` of its storage (rows
    on or off 16 bytes)."""
    n = int(np.prod(shape))
    return _uniform((n + offset,), dtype, seed, device)[offset:].view(shape)


def specs(A, modes, blocks, ol, seed):
    """halo_write's specs of `modes`: WRAP of overlap `ol`, EXT with random
    planes of A's dtype and device."""
    out = []
    for d, m in enumerate(modes):
        if m == "wrap":
            out.append((d, "wrap", ol))
        elif m == "ext":
            shape = list(A.shape)
            shape[d] = blocks[d]
            out.append((d, "ext") + tuple(
                _uniform(shape, A.dtype, seed + side, A.device)
                for side in (0, 1)))
    return out
