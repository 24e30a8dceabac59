"""The stand-in CUDA runtime and the shared fixtures, case tables and
helpers of the g++ rehearsal of the port's CUDA sources on the CPU
(tests/test_torch_kernel_sources*.py, tests/test_torch_spec_march.py).

`igg_torch/csrc` is compiled as C++ with g++ against a small header that
stands in for the CUDA runtime (:data:`RUNTIME`; :func:`_rewrite` turns a
launch into loops over every block and thread, a launch with dynamic
shared memory into fibers that switch at `__syncthreads`), with
`-ffp-contract=off`, so each operation rounds as in the `-fmad=false` card
build.  The fixtures build those libraries once per test module
(:func:`csrc`, :func:`libs`, :func:`generated`, the edited builds) and
point the wrappers' `library` at them (:func:`emulated`).
"""

import concurrent.futures
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import igg_torch as it
import torch_spec_cases as cases
from igg_torch.ops import _build
from igg_torch.ops import chunk_engine as ce
from igg_torch.ops import diffusion_pallas as dp
from igg_torch.ops import diffusion_trapezoid as dtz
from igg_torch.ops import halo_write as hw
from igg_torch.ops import hm3d_pallas as hp
from igg_torch.ops import hm3d_trapezoid as htz
from igg_torch.ops import pack as pk
from igg_torch.ops import stokes_pallas as sp
from igg_torch.ops import stokes_trapezoid as stz
from igg_torch.ops import wave2d_pallas as wp
from igg_torch.ops import wave2d_trapezoid as wtz
from igg_torch.stencil import cuda
from igg_torch.stencil import lower

RUNTIME = r"""
#pragma once
#include <ucontext.h>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <cstdint>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline long long __double_as_longlong(double x) {
  long long u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline double __longlong_as_double(long long u) {
  double x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  *p += v;
  return old;
}
inline uint3 blockIdx, threadIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidConfiguration = 9 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// Built with EMU_REVERSE, the thread blocks run last to first: a kernel
// whose thread blocks race (one reads or writes what another writes) then
// shows what the other order hides.
inline void emu_launch(dim3 g, dim3 b, const std::function<void()>& body) {
  gridDim = g;
  blockDim = b;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx)
        for (unsigned tz = 0; tz < b.z; ++tz)
          for (unsigned ty = 0; ty < b.y; ++ty)
            for (unsigned tx = 0; tx < b.x; ++tx) {
#ifdef EMU_REVERSE
              blockIdx = {g.x - 1 - bx, g.y - 1 - by, g.z - 1 - bz};
#else
              blockIdx = {bx, by, bz};
#endif
              threadIdx = {tx, ty, tz};
              body();
            }
}
// Kernels with dynamic shared memory and __syncthreads: the threads of a
// block run as fibers (ucontext), each up to its next barrier in turn, so
// every thread's writes before a barrier precede every read after it.
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline unsigned char* emu_smem;
inline ucontext_t emu_main;
inline std::vector<ucontext_t> emu_ctx;
inline std::vector<int> emu_done;
inline unsigned emu_cur;
inline const std::function<void()>* emu_body;
inline void __syncthreads() { swapcontext(&emu_ctx[emu_cur], &emu_main); }
inline void emu_fiber() {
  (*emu_body)();
  emu_done[emu_cur] = 1;
}
inline void emu_launch_sync(dim3 g, dim3 b, size_t smem,
                            const std::function<void()>& body) {
  gridDim = g;
  blockDim = b;
  const unsigned n = b.x * b.y * b.z;
  std::vector<double> mem(smem / sizeof(double) + 1);
  emu_smem = reinterpret_cast<unsigned char*>(mem.data());
  std::vector<std::vector<char>> stacks(n, std::vector<char>(1 << 16));
  emu_ctx.assign(n, ucontext_t{});
  emu_done.assign(n, 0);
  emu_body = &body;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx) {
        blockIdx = {bx, by, bz};
        for (unsigned t = 0; t < n; ++t) {
          getcontext(&emu_ctx[t]);
          emu_ctx[t].uc_stack.ss_sp = stacks[t].data();
          emu_ctx[t].uc_stack.ss_size = stacks[t].size();
          emu_ctx[t].uc_link = &emu_main;
          makecontext(&emu_ctx[t], emu_fiber, 0);
          emu_done[t] = 0;
        }
        for (bool left = true; left;) {
          left = false;
          for (unsigned t = 0; t < n; ++t) {
            if (emu_done[t]) continue;
            emu_cur = t;
            threadIdx = {t % b.x, (t / b.x) % b.y, t / (b.x * b.y)};
            swapcontext(&emu_main, &emu_ctx[t]);
            left = left || !emu_done[t];
          }
        }
      }
}
"""
LAUNCH = re.compile(r"([A-Za-z_]+<[^<>]*>)<<<([^>]*), 0, [a-z]+>>>\((.*)\);")
# A launch with dynamic shared memory, `k<...><<<grid, block, bytes, s>>>`.
LAUNCH_SMEM = re.compile(
    r"([A-Za-z_]+<[^<>]*>)<<<([^,>]*), ([^,>]*), ([a-z_]+), [a-z]+>>>"
    r"\((.*)\);")
SHARED = re.compile(r"extern __shared__ [^;]*?(\w+)\[\];")
LIBS = ("diffusion_step", "diffusion_chunk", "hm3d_step", "hm3d_chunk",
        "wave2d_step", "wave2d_chunk", "stokes_step", "stokes_chunk",
        "diffusion_band", "hm3d_band", "stokes_band", "pack_planes",
        "halo_write")


def _rewrite(text):
    text = LAUNCH.sub(r"emu_launch(\2, [&]{ \1(\3); });", text)
    text = LAUNCH_SMEM.sub(r"emu_launch_sync(\2, \3, \4, [&]{ \1(\5); });",
                           text)
    return SHARED.sub(r"unsigned char* \1 = emu_smem;", text)


def _gxx(out, src, so, first=None, defines=()):
    """Build `src` into `so` against the headers in `out` (those in `first`,
    where given, found before them), with the macros `defines`."""
    inc = ([f"-I{first}"] if first else []) + [f"-I{out}"]
    proc = subprocess.run(
        [shutil.which("g++"), "-std=c++17", "-O1", "-ffp-contract=off",
         "-fPIC", "-shared", *inc, *(f"-D{d}" for d in defines), "-x", "c++",
         str(src), "-o", str(so)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def csrc(tmp_path_factory):
    """The repo's kernel sources, launches rewritten, and the stand-in
    runtime, in one directory."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' sources for the CPU")
    out = tmp_path_factory.mktemp("kernel_sources")
    (out / "cuda_runtime.h").write_text(RUNTIME)
    for f in os.listdir(_build.CSRC):
        if f.endswith((".cu", ".cuh")):
            (out / f).write_text(
                _rewrite(open(os.path.join(_build.CSRC, f)).read()))
    return out


@pytest.fixture(scope="module")
def libs(csrc):
    """The eight libraries, built with g++ from the repo's sources."""

    def build(name):
        lib = _gxx(csrc, csrc / f"{name}.cu", csrc / f"{name}.so")
        fn_name, argtypes = _build.SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return name, lib

    with concurrent.futures.ThreadPoolExecutor(len(LIBS)) as pool:
        return dict(pool.map(build, LIBS))


@pytest.fixture(scope="module")
def generated(csrc):
    """`generated_library` through g++: each generated source (launches
    rewritten) built once, beside the rewritten headers."""
    built = {}

    def library(source, tag):
        if source not in built:
            src = csrc / f"gen_{tag}_{len(built)}.cu"
            src.write_text(_rewrite(source))
            lib = _gxx(csrc, src, src.with_suffix(".so"))
            for name in (cuda.ENTRY, cuda.BAND_ENTRY):
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes, fn.restype = cuda.ARGTYPES, ctypes.c_int
            built[source] = lib
        return built[source]

    return library


@pytest.fixture
def emulated(libs, generated, monkeypatch):
    for module in (dp, dtz, hp, htz, wp, wtz, sp, stz, pk, hw):
        monkeypatch.setattr(module, "library", libs.__getitem__)
    monkeypatch.setattr(lower, "generated_library", generated)
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def _random(shape, dtype, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape)).to(dtype)


def same(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


SC = dp.scal(0.3, 0.4, 0.5)
HM3D_KW = dict(dx=0.31, dy=0.27, dz=0.43, dt=5e-4, phi0=0.1, npow=3, eta=1.3)

GRIDS = {
    "wrap": dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1),
    "frozen": dict(dimx=1, dimy=1, dimz=1),
    "wrap_y_frozen_xz": dict(dimx=1, dimy=1, dimz=1, periody=1),
    "recv_2x2x1_open": dict(dimx=2, dimy=2, dimz=1),
    "recv_2x2x2_periodic": dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                                periodz=1),
    "recv_x_wrap_yz": dict(dimx=2, dimy=1, dimz=1, periody=1, periodz=1),
    "recv_yz_wrap_x": dict(dimx=1, dimy=2, dimz=2, periodx=1),
}


@pytest.fixture(scope="module")
def halo_reversed(csrc):
    """The halo writer built with EMU_REVERSE: its thread blocks run last
    to first."""
    out = csrc / "reversed"
    out.mkdir()
    lib = _gxx(csrc, csrc / "halo_write.cu", out / "halo_write.so",
               defines=("EMU_REVERSE",))
    fn_name, argtypes = _build.SIGNATURES["halo_write"]
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


CHUNK_GRIDS = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "ring_open": ((8, 1, 1), (0, 0, 0)),
    "2x2x2_periodic": ((2, 2, 2), (1, 1, 1)),
    "2x2x2_periods010": ((2, 2, 2), (0, 1, 0)),
    "2x2x2_periods101": ((2, 2, 2), (1, 0, 1)),
    "1x2x2_open": ((1, 2, 2), (0, 0, 0)),
    "2x1x1_wrap_y_frozen_z": ((2, 1, 1), (0, 1, 0)),
    "1x1x1_open": ((1, 1, 1), (0, 0, 0)),
}


def _run_chunk(launch, exts, out, K):
    """K launches ping-ponging two sets of buffers, as the wrappers do."""
    bufs = [[torch.empty_like(X) for X in exts] for _ in range(2)]
    src = list(exts)
    for k in range(K):
        dst = out if k == K - 1 else bufs[k % 2]
        launch(src, dst, k == K - 1)
        src = dst
    return out


# The band kernels' layouts: the chunk matrix and one periodic block (x
# extended, y and z wrapped).
BAND_GRIDS = dict(CHUNK_GRIDS, **{"1x1x1_periodic": ((1, 1, 1), (1, 1, 1))})


def _run_band(launch, exts, local, K, B, modes, g, central):
    """K launches of a band kernel ping-ponging two sets of buffers, as
    `chunk_engine.streaming_chunk_call` runs them; the last one writes the
    central windows when `central`."""
    bufs = [[torch.empty_like(X) for X in exts] for _ in range(2)]
    src = list(exts)
    for k in range(K):
        last = central and k == K - 1
        dst = ([torch.empty(it.stacked_shape(local), dtype=X.dtype)
                for X in exts] if last else bufs[k % 2])
        launch(src, dst, ce.band_cfg(exts[0].shape, local, K, modes, g, last,
                                     B=B, lo=1, extra=1, ols=(2, 2, 2)))
        src = dst
    return src


WAVE_KW = dict(dx=0.31, dy=0.27, dt=0.05, rho=1.3, bulk=0.7)
# Layouts of the wave2d checks, as (dims, periods).
WAVE_GRIDS = {
    "1x1_periodic": ((1, 1), (1, 1)),
    "4x2_periodic": ((4, 2), (1, 1)),
    "8x1_periodic": ((8, 1), (1, 1)),
    "2x1_periodic": ((2, 1), (1, 1)),
    "2x2_periodic": ((2, 2), (1, 1)),
    "1x1_open": ((1, 1), (0, 0)),
    "4x2_open": ((4, 2), (0, 0)),
    "8x1_open": ((8, 1), (0, 0)),
    "2x1_open": ((2, 1), (0, 0)),
}


def _wave_grid(case, local):
    (dims, per) = WAVE_GRIDS[case]
    it.init_global_grid(*local, 1, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=1, periodx=per[0], periody=per[1])
    return it.get_global_grid()


def _wave_state(g, dtype, seed):
    return [_random(it.stacked_shape(s), dtype, -1, 1, seed + f)
            for f, s in enumerate(wp.field_shapes(g.nxyz[:2]))]


STOKES_KW = dict(dx=0.31, dy=0.27, dz=0.43, mu=1.3, dtP=0.07, dtV=0.011)
# Layouts of the Stokes checks (overlap 3), as (dims, periods): igg's
# trapezoid matrix (tests/test_stokes_trapezoid.py) plus one-block grids.
STOKES_GRIDS = {
    "ring_periodic": ((8, 1, 1), (1, 1, 1)),
    "ring_open": ((8, 1, 1), (0, 0, 0)),
    "2x2x2_periodic": ((2, 2, 2), (1, 1, 1)),
    "2x2x2_open": ((2, 2, 2), (0, 0, 0)),
    "2x2x2_periods010": ((2, 2, 2), (0, 1, 0)),
    "4x2x1_periods101": ((4, 2, 1), (1, 0, 1)),
    "1x1x1_periodic": ((1, 1, 1), (1, 1, 1)),
    "1x1x1_open": ((1, 1, 1), (0, 0, 0)),
    "1x1x1_periods101": ((1, 1, 1), (1, 0, 1)),
}


# y one periodic block over an open x, which only the band marches' edge
# cases take: an x freeze row's value then comes from the source's row of a
# y wrap, not the target's.
STOKES_EDGE_GRIDS = dict(STOKES_GRIDS, **{
    "2x1x1_wrap_y_open_xz": ((2, 1, 1), (0, 1, 0))})


def _stokes_grid(case, local):
    dims, per = STOKES_EDGE_GRIDS[case]
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2], overlapx=3,
                        overlapy=3, overlapz=3)
    return it.get_global_grid()


def _stokes_state(g, dtype, seed):
    """Random (P, Vx, Vy, Vz, Rho) on the grid `g`."""
    return [_random(it.stacked_shape(s), dtype, -1, 1, seed + f)
            for f, s in enumerate(sp.field_shapes(g.nxyz))]


def _run_stag_band(launch, exts, shapes, local, E, K, B, lo, extras, modes, g,
                   ols, central):
    """K launches of a staggered band kernel ping-ponging two sets of
    buffers (NaN-filled, so a cell a launch leaves unwritten shows), as
    `chunk_engine.streaming_chunk_call` runs them; the last one writes the
    central windows when `central`."""
    bufs = [[torch.full_like(X, float("nan")) for X in exts]
            for _ in range(2)]
    src = list(exts)
    for k in range(K):
        last = central and k == K - 1
        dst = ([torch.full(it.stacked_shape(s), float("nan"), dtype=X.dtype)
                for X, s in zip(exts, shapes)] if last else bufs[k % 2])
        launch(src, dst, ce.stagger_band_cfg(
            local, E, modes, g.dims, ols[:len(exts)], last, B=B, lo=lo,
            extras=extras))
        src = dst
    return src


# The marches with segments of at least 3 x rows instead of 8, so that
# the small blocks here are cut into segments that cross the bands.
SHORT_SEGMENTS = (("stokes_march.cuh", "constexpr int MARCH_MIN_SEG = 8;",
                   "constexpr int MARCH_MIN_SEG = 3;"),
                  ("hm3d_march.cuh", "constexpr int HM_MIN_SEG = 8;",
                   "constexpr int HM_MIN_SEG = 3;"),
                  ("diffusion_march.cuh", "constexpr int DM_MIN_SEG = 8;",
                   "constexpr int DM_MIN_SEG = 3;"),
                  ("stokes_step.cu", "constexpr int SS_MIN_SEG = 8;",
                   "constexpr int SS_MIN_SEG = 3;"),
                  ("hm3d_march.cuh", "constexpr int HM_STEP_MIN_SEG = 16;",
                   "constexpr int HM_STEP_MIN_SEG = 3;"),
                  ("stagger_band_march3.cuh", "constexpr int SB_MIN_SEG = 8;",
                   "constexpr int SB_MIN_SEG = 3;"))
SHORT_SEGMENT_LIBS = ("stokes_band", "hm3d_band", "hm3d_chunk",
                      "diffusion_band", "hm3d_step", "stokes_step")


@pytest.fixture(scope="module")
def short_segments(csrc):
    """The marches' libraries built with SHORT_SEGMENTS."""
    out = csrc / "short_segments"
    out.mkdir()
    for f in os.listdir(csrc):
        if f.endswith((".cu", ".cuh", ".h")):
            text = (csrc / f).read_text()
            for name, old, new in SHORT_SEGMENTS:
                if f == name:
                    assert text.count(old) == 1, (f, old)
                    text = text.replace(old, new)
            (out / f).write_text(text)

    def build(name):
        lib = _gxx(out, out / f"{name}.cu", out / f"{name}.so")
        fn_name, argtypes = _build.SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return name, lib

    with concurrent.futures.ThreadPoolExecutor(len(SHORT_SEGMENT_LIBS)) as pool:
        return dict(pool.map(build, SHORT_SEGMENT_LIBS))


# The marches' edge cases, each beside the plain version: segments
# that do not line up with the bands (SHORT_SEGMENTS), tiles that cross the
# blocks' last y and z rows (y 13 and z 35 or 37: 19 to 26 rows with the
# extension and the face row, tiles of 8 x 32 ending in 2 to 16 of them),
# and fields at rest (`init_fields`: zero velocities and pressures, the
# zero dividends that const_div.cuh sends to `x * r`).
BAND_EDGE_CASES = ("short_segments", "ragged_tiles", "at_rest")


# The chunk meshes and z one periodic block over an open x and y, where
# a wrapped z row takes F at its target's z, not at its source's.
CHUNK_EDGE_GRIDS = dict(CHUNK_GRIDS, **{
    "2x1x1_wrap_z_open_xy": ((2, 1, 1), (0, 0, 1))})


# The step marches' layouts: GRIDS (every halo mode, x wraps among them)
# and y received over a wrapped x and z, where a received y halo cell takes
# the y plane at its wrap source's z, not its own.
STEP_GRIDS = dict(GRIDS, recv_y_wrap_xz=dict(dimx=1, dimy=2, dimz=1,
                                             periodx=1, periodz=1))


@pytest.fixture(scope="module")
def first_designs(csrc):
    """The first designs of the redesigned kernels (kernel_variants.py:
    FIRST_DESIGNS), built with g++ beside the rewritten headers and the
    first designs' policies (FIRST_HEADERS, found first), as the card's
    timing runs build them with nvcc."""
    import sys

    sys.path.insert(0, os.path.dirname(_build._ROOT))
    import kernel_variants

    first = csrc / "first"
    first.mkdir()
    for name, text in kernel_variants.FIRST_HEADERS.items():
        (first / name).write_text(_rewrite(text))

    def build(name):
        src = first / f"first_{name}"
        src.write_text(_rewrite(kernel_variants.FIRST_DESIGNS[name]))
        lib = _gxx(csrc, src, first / f"first_{name}.so", first)
        fn_name, argtypes = _build.SIGNATURES[name[:-len(".cu")]]
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return name[:-len(".cu")], lib

    names = sorted(kernel_variants.FIRST_DESIGNS)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(pool.map(build, names))


# -- kernels generated from stencil specs ------------------------------------

def _spec_params():
    return [(name, case, local) for name in sorted(cases.SPECS)
            for case in sorted(cases.grids(name))
            for local in cases.locals_of(name)]


def _step_cfg(g, nd):
    return ce.stagger_cfg(g.nxyz[:nd], 0, ("ext",) * nd, g.dims, [], False)


# -- the generated band entry's x-march (csrc/stagger_band_march3.cuh) ------

def _spec_band_check(name, case, dtype, B, bands, yz, K=3, fields=None):
    """The generated band entry of spec `name` on grid `case` (blocks of yz
    along y and z, an extended x span of `bands` bands of B;
    torch_spec_cases.band_setup) against `banded_window_plain` (the band
    core derived from the evaluator), tolerance 0: K launches' whole
    evolved buffers (NaN-filled targets, so an unwritten cell shows) and
    central windows."""
    gen, g, shapes, E, modes, ols, exts = cases.band_setup(
        it, name, case, B, bands, yz, K, dtype, fields=fields)
    lo, extras = lower.band_margins(gen.spec, gen.analysis)
    for central in (False, True):
        got = _run_stag_band(
            lambda src, dst, cfg: lower._band_launch(gen, src, exts, dst, cfg,
                                                     0),
            exts, shapes, g.nxyz, E, K, B, lo, extras, modes, g, ols,
            central)
        want = lower.band_call(gen, exts, shapes, K=K, B=B, E=E, modes=modes,
                               grid=g, ols=ols, central=central)
        for a, b in zip(got, want):
            same(a, b)


@pytest.fixture(scope="module")
def short_generated(csrc, short_segments):
    """`generated_library` through g++ on the SHORT_SEGMENTS headers."""
    out = csrc / "short_segments"
    built = {}

    def library(source, tag):
        if source not in built:
            src = out / f"gen_{tag}_{len(built)}.cu"
            src.write_text(_rewrite(source))
            lib = _gxx(out, src, src.with_suffix(".so"))
            for name in (cuda.ENTRY, cuda.BAND_ENTRY):
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes, fn.restype = cuda.ARGTYPES, ctypes.c_int
            built[source] = lib
        return built[source]

    return library


_FIRST_GENERATED = {}


def _build_first_generated(first_designs, name):
    """The library of spec `name`'s source with its band entry on the first
    design, built with g++ beside the first designs' headers."""
    import kernel_variants

    if name not in _FIRST_GENERATED:
        lib0 = next(iter(first_designs.values()))
        first = os.path.dirname(lib0._name)
        src = os.path.join(first, f"first_gen_{name}.cu")
        with open(src, "w") as f:
            f.write(_rewrite(kernel_variants.spec_band_first_source(
                cases.kernels(name))))
        lib = _gxx(os.path.dirname(first), src, src[:-3] + ".so", first)
        fn = getattr(lib, cuda.BAND_ENTRY)
        fn.argtypes, fn.restype = cuda.ARGTYPES, ctypes.c_int
        _FIRST_GENERATED[name] = lib
    return _FIRST_GENERATED[name]
