"""The generated rank-3 step and chunk entry (`igg_spec_step`) on the x-march
of `igg_torch/csrc/stagger_band_march3.cuh`, run on the CPU.

The sources generated for the rank-3 specs of tests/torch_spec_cases.py
(`relax3d` and the staggered `acoustic3d`) are compiled with g++ against
the stand-in CUDA runtime of tests/torch_kernel_emulation.py (its
rewrite of the launches; each thread block's threads run as fibers that
switch at `__syncthreads`, the `cp.async` staging as plain copies), and
the entry is held against its plain versions, tolerance 0, f32 and f64:
the step against `lower.step_plain` (the march's step mode), the chunk
step against `chunk_engine.window_step_plain` (its chunk mode where a dim
wraps or freezes, its step mode where every dim is extended) over K = 2
and 3 launches, on the whole extended buffers (every target filled with
NaN first, so an unwritten cell shows) and on the last launch's central
windows, in every window mode of `torch_spec_cases.BAND_GRIDS` (one
periodic block, 2x2x2 open blocks, y one periodic block over an open x,
one open block, y and z one periodic block over an open x).  Its edge
cases too: segments cut short (the march built with segments of at least
3 x rows), tiles ragged across the blocks' last y and z rows and odd z
extents, fields at rest, every staged row copied element by element (no
16-byte copies), and the march with no ring (every read from device
memory, the launcher's path for policies whose ring exceeds shared
memory).  The entry's first design (the walk, kept as text in
kernel_variants.py: `spec_first_source`) is held to the same plain
versions.  Skips without g++.
"""

import concurrent.futures
import ctypes
import os
import sys

import pytest
import torch

import igg_torch as it
import torch_spec_cases as cases
from igg_torch.ops import _build
from igg_torch.stencil import cuda
from igg_torch.stencil import lower
from torch_kernel_emulation import _gxx, _rewrite, csrc  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

# Builds of the march, each an edit of stagger_band_march3.cuh's knobs
# (None: as it is).
BUILDS = {
    "as_built": None,
    "short_segments": (("constexpr int SX_MIN_SEG = 8;",
                        "constexpr int SX_MIN_SEG = 3;"),
                       ("constexpr int SX_BLOCKS = 2048;",
                        "constexpr int SX_BLOCKS = 65536;")),
    "no_ring": (("constexpr int SX_SMEM_MAX = SB_SMEM_MAX;",
                 "constexpr int SX_SMEM_MAX = 0;"),),
}


@pytest.fixture(scope="module")
def march_libs(csrc):
    """{(build, spec name): library}: the generated source of each rank-3
    spec built with g++ against each build of the march's header, and the
    first design (`build` "first": kernel_variants.spec_first_source,
    beside kernel_variants.FIRST_HEADERS)."""
    sys.path.insert(0, os.path.dirname(_build._ROOT))
    import kernel_variants

    header = "stagger_band_march3.cuh"
    dirs = {}
    for build, edits in BUILDS.items():
        if edits is None:
            dirs[build] = csrc
            continue
        out = csrc / f"march_{build}"
        out.mkdir()
        text = (csrc / header).read_text()
        for old, new in edits:
            assert text.count(old) == 1, (build, old)
            text = text.replace(old, new)
        (out / header).write_text(text)
        dirs[build] = out
    first = csrc / "march_first"
    first.mkdir()
    for name, text in kernel_variants.FIRST_HEADERS.items():
        (first / name).write_text(_rewrite(text))
    dirs["first"] = first

    def build(key):
        where, name = key
        out = dirs[where]
        gen = cases.kernels(name)
        text = (kernel_variants.spec_first_source(gen) if where == "first"
                else gen.source)
        src = out / f"gen_{name}.cu"
        src.write_text(_rewrite(text))
        # The edited header, where there is one, is found before csrc's.
        lib = _gxx(csrc, src, out / f"gen_{name}.so", out)
        for entry in (cuda.ENTRY, cuda.BAND_ENTRY):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = cuda.ARGTYPES, ctypes.c_int
        return key, lib

    keys = [(b, n) for b in dirs for n in cases.SPECS_3D]
    with concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
        return dict(pool.map(build, keys))


@pytest.fixture
def march(march_libs, monkeypatch):
    """Point `lower.generated_library` at the build `name` of the march."""

    def use(build, spec_name):
        lib = march_libs[build, spec_name]
        monkeypatch.setattr(lower, "generated_library",
                            lambda source, tag: lib)

    yield use
    if it.grid_is_initialized():
        it.finalize_global_grid()


def _fields(gen, g, dtype, rest):
    if rest:
        return cases.at_rest(it, gen, g, dtype)
    return cases.state(it, gen, g, dtype, 73)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("local", cases.MARCH_LOCALS)
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_march_step_matches_plain(march, name, case, local, dtype):
    """The march's step mode against `step_plain`, every layout."""
    march("as_built", name)
    gen = cases.kernels(name)
    g = cases.march_grid(it, case, local)
    cases.march_step_check(gen, g, cases.state(it, gen, g, dtype, 71))


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("local", cases.LOCALS_3D)
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_march_chunk_matches_plain(march, name, case, local, dtype, K):
    """The march's chunk step (its chunk mode where a dim wraps or
    freezes) against `window_step_plain`: whole extended buffers and the
    last launch's central windows."""
    march("as_built", name)
    gen = cases.kernels(name)
    g = cases.march_grid(it, case, local)
    assert cases.march_chunk_check(it, gen, g,
                                   cases.state(it, gen, g, dtype, 72), K)


# The march's edge cases (module docstring): its builds, tiles ragged
# across the blocks' last rows with odd z extents, fields at rest.
EDGE_CASES = ("short_segments", "no_ring", "ragged_tiles", "at_rest")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", EDGE_CASES)
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_march_edge_cases(march, name, case, kind, dtype):
    """The step and the K = 3 chunk step in the march's edge cases."""
    march(kind if kind in BUILDS else "as_built", name)
    gen = cases.kernels(name)
    local = cases.MARCH_EDGE_LOCALS.get(
        "segments" if kind == "short_segments" else kind, (10, 9, 8))
    g = cases.march_grid(it, case, local)
    S = _fields(gen, g, dtype, kind == "at_rest")
    cases.march_step_check(gen, g, S)
    assert cases.march_chunk_check(it, gen, g, S, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_open",
                                  "2x1x1_wrap_yz"])
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_step_first_design_matches_plain(march, name, case, dtype):
    """The step and chunk entry's first design (the walk,
    kernel_variants.py: spec_first_source), kept to be timed beside the
    march, still builds against the headers and equals its plain
    versions."""
    march("first", name)
    gen = cases.kernels(name)
    g = cases.march_grid(it, case, (12, 10, 9))
    S = cases.state(it, gen, g, dtype, 74)
    cases.march_step_check(gen, g, S)
    assert cases.march_chunk_check(it, gen, g, S, 2)
