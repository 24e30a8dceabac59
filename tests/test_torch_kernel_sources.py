"""The port's step and chunk kernels' CUDA sources, run on the CPU.

`igg_torch/csrc` is compiled here as C++ with g++ against a small header
that stands in for the CUDA runtime (a launch becomes loops over every
block and thread, run one after another; `-ffp-contract=off`, so no
operation is fused and each rounds as in IEEE arithmetic, like the
`-fmad=false` card build).  The wrappers' `_launch` functions then drive
those libraries with CPU tensors, and every kernel is held against its
plain PyTorch version, tolerance 0, in every halo and window mode, f32 and
f64: the diffusion, HM3D and wave2d step kernels and the Stokes iteration
(the K-step loops launch the same kernels), the diffusion, HM3D, wave2d
and Stokes chunk kernels, and the kernels generated from stencil specs
(`igg_torch/stencil/cuda.py`: the step and the chunk step of shallow water
with and without friction, spec-wave2d, a spec of `pow`, `where` and
scalar divisions, and the rank-3 `relax3d`), spec-wave2d also against the
hand-written wave2d kernels, the plane packer (2-, 4- and 8-byte
elements, rows not 16-byte aligned), the Stokes chunk kernel's x-march
(`csrc/stokes_march.cuh`: a thread block's threads as fibers, its
`cp.async` staging as plain copies; whole extended buffers across several
tiles) and its division (`csrc/const_div.cuh`, float32 and float64,
against `x / d` over samples of all bit patterns, for the Stokes and the
HM3D divisors, the HM3D chunk kernel's among them), the diffusion band
kernel (its x-march, `csrc/diffusion_march.cuh`, whose threads share
staged planes: each thread block's threads run as fibers that switch at
`__syncthreads`), the HM3D band and chunk kernels (the x-march of
`csrc/hm3d_march.cuh` with the band's and the chunk's edge rules,
`csrc/march_layout.cuh`), the Stokes band kernel (the Stokes march's band
mode) and the generated band entry of `relax3d` and the staggered
`acoustic3d` (its x-march, `csrc/stagger_band_march3.cuh`) in every
window mode, at B = 8 and 16 in two and three bands, on their whole
evolved buffers; the in-place halo writer (`csrc/halo_write.cu`) in every
WRAP/EXT/NONE mix on ranks 1-3, 2-, 4- and 8-byte elements, with its
thread blocks run in both orders (`EMU_REVERSE`: a kind of plane that
reads or writes what another writes shows in one of them); the five
marches also in their edge cases:
segments that cross the bands (built with shorter segments), tiles that
cross the blocks' last y and z rows, and fields at rest (the HM3D chunk
and diffusion band marches in every layout of the chunk and band
meshes); and the redesigned kernels' first designs, kept as text in
kernel_variants.py to be timed beside them, against the plain versions
too.  This
checks the kernels' indexing, walks and arithmetic, not their
CUDA-specific parts (vector loads, alignment, the launch), which
`tests/test_torch_kernels.py` checks on a card.  Skips without g++.
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
import torch_halo_cases as halo_cases
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


# (12, 10, 33): odd z extents, the element path; (10, 12, 8): whole 16-byte
# vectors in every z row of f32 and f64, the vector path.
@pytest.mark.parametrize("local", [(12, 10, 33), (10, 12, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_step_kernels_match_plain(emulated, case, dtype, local):
    it.init_global_grid(*local, quiet=True, device="cpu", **GRIDS[case])
    g = it.get_global_grid()
    shp = it.stacked_shape(g.nxyz)
    modes = dp.step_modes(g)
    T, A = _random(shp, dtype, -10, 10, 1), _random(shp, dtype, 0.01, 0.1, 2)
    recv = dp.step_recv_planes(T, A, g, modes, SC)
    out = torch.empty_like(T)
    dp._launch(T, A, out, modes, recv, g.dims, g.nxyz, SC, 0)
    same(out, dp.step_plain(T, A, modes, recv, g.dims, SC))
    Pe, phi = (_random(shp, dtype, -0.5, 0, 3),
               _random(shp, dtype, 0.05, 0.25, 4))
    recv = hp.step_recv_planes(Pe, phi, g, modes, HM3D_KW)
    out = (torch.empty_like(Pe), torch.empty_like(phi))
    hp._launch(Pe, phi, out, modes, recv, g.dims, g.nxyz, HM3D_KW, 0)
    for a, b in zip(out, hp.step_plain(Pe, phi, modes, recv, g.dims, HM3D_KW)):
        same(a, b)


@pytest.mark.parametrize("npow", [0, 1, 2, 5])
def test_hm3d_step_kernel_any_npow(emulated, npow):
    it.init_global_grid(8, 9, 12, quiet=True, device="cpu", **GRIDS["wrap"])
    g = it.get_global_grid()
    kw = dict(HM3D_KW, npow=npow)
    Pe, phi = (_random((8, 9, 12), torch.float32, lo, hi, s)
               for lo, hi, s in ((-0.5, 0, 5), (0.05, 0.25, 6)))
    modes, none = dp.step_modes(g), ({}, {})
    out = (torch.empty_like(Pe), torch.empty_like(phi))
    hp._launch(Pe, phi, out, modes, none, g.dims, g.nxyz, kw, 0)
    for a, b in zip(out, hp.step_plain(Pe, phi, modes, none, g.dims, kw)):
        same(a, b)


# Odd extents on grids of 2 and 3 blocks along y and z; the requests out of
# order, z rows adjacent (0 and 1, s-2 and s-1) and apart (3), the y rows
# likewise.  `offset` elements before the field: a source whose rows are
# not 16-byte aligned (the packer's element and head/tail paths).
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("dims,local", [((2, 3, 2), (5, 7, 9)),
                                        ((1, 2, 3), (3, 9, 13))])
def test_pack_kernel_matches_plain(emulated, dims, local, dtype, offset):
    shape = [n * s for n, s in zip(dims, local)]
    n = int(np.prod(shape))
    flat = _random((n + offset,), torch.float64, -100, 100, 23).to(dtype)
    A = flat[offset:].view(shape)
    reqs = [(2, local[2] - 1), (1, 0), (2, 0), (2, 3), (1, local[1] - 2),
            (2, 1), (1, 3), (2, local[2] - 2)]
    for some in (reqs, reqs[:1], [(1, 1), (1, 2)]):
        outs = [torch.full(pk._out_shape(A, d, dims), 7, dtype=dtype)
                for d, _ in some]
        pk._launch(A, some, dims, local, outs, 0)
        for got, want in zip(outs, pk.pack_planes_plain(A, some, dims)):
            same(got, want)


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


# Ranks 1-3; blocks (1,1,1), (2,2,2), (4,2,1); overlaps 2 and 3; 2-, 4- and
# 8-byte elements; the field at offset 0 and 1 of its storage (rows on and
# off 16 bytes); every WRAP/EXT/NONE mix; the thread blocks in both orders
# (a plane's kind that reads or writes a cell another kind writes shows in
# one of them).
@pytest.mark.parametrize("ol", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("blocks,local", halo_cases.LAYOUTS)
def test_halo_write_kernel_matches_plain(emulated, halo_reversed, blocks,
                                         local, dtype, ol, monkeypatch):
    """The halo writer against `halo_write_plain`, bitwise, every mode mix
    on every layout."""
    shape = [b * s for b, s in zip(blocks, local)]
    n = int(np.prod(shape))
    ran = 0
    for lib in (hw.library("halo_write"), halo_reversed):
        monkeypatch.setattr(hw, "library", lambda name, lib=lib: lib)
        for modes in halo_cases.mixes(blocks):
            for off in (0, 1):
                A = halo_cases.field(shape, dtype, off, 3 + off)
                specs = halo_cases.specs(A, modes, blocks, ol, 11)
                want = hw.halo_write_plain(A.clone(), specs, blocks)
                got = A.clone() if off == 0 else A
                b3, l3 = hw._check(got, specs, blocks)
                hw._launch(got, specs, b3, l3, 0)
                same(got, want)
                ran += 1
    assert ran >= 4


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


# (16, 16, 16): whole vectors; (16, 12, 13): odd z, the element path.
@pytest.mark.parametrize("local", [(16, 16, 16), (16, 12, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CHUNK_GRIDS))
def test_chunk_kernels_match_plain(emulated, case, dtype, local):
    (dims, per), K = CHUNK_GRIDS[case], 8
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz]) * 2

    T, A = _random(shp, dtype, -10, 10, 7), _random(shp, dtype, 0.001, 0.1, 8)
    Text, A_ext = ce.extend_fields([T, A], ols, K, g, modes)
    got = _run_chunk(
        lambda src, dst, last: dtz._launch(src[0], A_ext, Text, dst[0],
                                           g.nxyz, K, modes, g, SC, last, 0),
        [Text], [torch.empty_like(T)], K)[0]
    same(got, ce.central_window(dtz.window_steps_plain(
        Text, A_ext, K=K, modes=modes, grid=g, sc=SC), g.nxyz, K, modes))

    Pe, phi = (_random(shp, dtype, -0.5, 0, 9),
               _random(shp, dtype, 0.05, 0.25, 10))
    exts = ce.extend_fields([Pe, phi], ols, K, g, modes)
    got = _run_chunk(
        lambda src, dst, last: htz._launch(src, exts, dst, g.nxyz, K, modes,
                                           g, HM3D_KW, last, 0),
        exts, [torch.empty_like(Pe), torch.empty_like(phi)], K)
    for a, b in zip(got, htz.window_steps_plain(*exts, K=K, modes=modes,
                                                grid=g, kw=HM3D_KW)):
        same(a, ce.central_window(b, g.nxyz, K, modes))


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


# Blocks of 18x10x40 and K = 3: an extended x span of 24 rows (18 on a
# frozen x), cut into 2 or 3 bands; two y tiles (8 + 2 rows) and two z tiles
# (32 + the rest), so wraps and tiles cross.
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(BAND_GRIDS))
def test_band_kernels_match_plain(emulated, case, dtype, bands):
    """The band kernels against `banded_window_plain` in every window mode:
    the whole evolved extended buffers (the shoulders show the clamp taken
    per block) and the central windows of the last launch."""
    (dims, per), K, local = BAND_GRIDS[case], 3, (18, 10, 40)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz]) * 2
    B = ce.ext_shape(local, K, modes)[0] // bands
    T, A = _random(shp, dtype, -10, 10, 17), _random(shp, dtype, 0.001, 0.1, 18)
    Text, A_ext = ce.extend_fields([T, A], ols, K, g, modes)
    Pe, phi = (_random(shp, dtype, -0.5, 0, 19),
               _random(shp, dtype, 0.05, 0.25, 20))
    exts = ce.extend_fields([Pe, phi], ols, K, g, modes)
    for central in (False, True):
        run = dict(local=local, K=K, B=B, modes=modes, g=g, central=central)
        got = _run_band(lambda src, dst, cfg: dtz._band_launch(
            src[0], A_ext, Text, dst[0], cfg, SC, 0), [Text], **run)[0]
        same(got, dtz.band_call(Text, A_ext, local, K=K, B=B, modes=modes,
                                grid=g, sc=SC, central=central))
        got = _run_band(lambda src, dst, cfg: htz._band_launch(
            src, exts, dst, cfg, HM3D_KW, 0), exts, **run)
        for a, b in zip(got, htz.band_call(exts, local, K=K, B=B, modes=modes,
                                           grid=g, kw=HM3D_KW,
                                           central=central)):
            same(a, b)


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


@pytest.mark.parametrize("local", [(12, 10), (16, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(c for c in WAVE_GRIDS
                                        if c != "2x2_periodic"))
def test_wave2d_step_kernel_matches_plain(emulated, case, dtype, local):
    g = _wave_grid(case, local)
    srcs = _wave_state(g, dtype, 11)
    out = [torch.empty_like(A) for A in srcs]
    wp._launch(srcs, out, g.dims[:2], g.nxyz[:2], WAVE_KW, 0)
    for a, b in zip(out, wp.step_plain(*srcs, g.dims[:2], WAVE_KW)):
        same(a, b)


# (16, 13): K = 2 and 4; (24, 21): K = 2, 4 and 8 (odd y extents: Vy rows
# of 14 and 22 elements).
@pytest.mark.parametrize("local,Ks", [((16, 13), (2, 4)), ((24, 21), (2, 8))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(c for c in WAVE_GRIDS
                                        if c.endswith("periodic")))
def test_wave2d_chunk_kernel_matches_plain(emulated, case, dtype, local, Ks):
    g = _wave_grid(case, local)
    modes = ce.dim_modes(g)[:2]
    shapes = wp.field_shapes(g.nxyz[:2])
    ols = ce.field_ols(g, shapes)
    for K in Ks:
        assert wtz.wave2d_chunk_refusal(g, g.nxyz[:2], K, K, dtype) is None
        exts = ce.extend_fields(_wave_state(g, dtype, 21), ols, 2 * K, g,
                                modes)
        got = _run_chunk(
            lambda src, dst, last: wtz._launch(
                src, dst, wtz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
                WAVE_KW, 0),
            exts, [torch.empty(it.stacked_shape(s), dtype=dtype)
                   for s in shapes], K)
        want = wtz.window_steps_plain(exts, K=K, modes=modes, grid=g,
                                      kw=WAVE_KW, ols=ols)
        for a, b, s in zip(got, want, shapes):
            same(a, ce.central_window(b, s, 2 * K, modes))


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


# (8, 9, 12): 16-byte P, Vx and Vy rows (the vector path; Vz's rows of 13
# are scalar); (7, 6, 11): odd z extents, the element path.
@pytest.mark.parametrize("local", [(8, 9, 12), (7, 6, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["ring_periodic", "2x2x2_open",
                                  "4x2x1_periods101", "1x1x1_periodic"])
def test_stokes_step_kernel_matches_plain(emulated, case, dtype, local):
    g = _stokes_grid(case, local)
    *srcs, Rho = _stokes_state(g, dtype, 31)
    out = [torch.empty_like(A) for A in srcs]
    sp._launch(srcs, Rho, out, g.dims, g.nxyz, STOKES_KW, 0)
    for a, b in zip(out, sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)):
        same(a, b)


# Extents that cross the march's (y, z) tiles (8 x 32 cells) and end in a
# ragged one, extended (E = 2K) or not: y 12 and 13 (13 to 26 rows with
# the face row: 2 to 4 tiles), z 33 (34 to 46: 2 tiles), x 12 and 13 (two
# segments of x rows); K = 2 and 3.
@pytest.mark.parametrize("local,Ks", [((12, 12, 33), (2,)),
                                      ((13, 13, 33), (2, 3))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_chunk_kernel_matches_plain(emulated, case, dtype, local, Ks):
    """The chunk step against `window_iters_plain`: K launches into whole
    extended buffers (NaN-filled, so a cell left unwritten shows) against
    the plain version's evolved buffers, and the chain whose last launch
    writes the central windows against their windows."""
    g = _stokes_grid(case, local)
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    *state, Rho = _stokes_state(g, dtype, 41)
    for K in Ks:
        assert stz.stokes_chunk_refusal(g, g.nxyz, K, K, dtype) is None
        exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        want = stz.window_iters_plain(exts, Rho_ext, K=K, modes=modes,
                                      grid=g, kw=STOKES_KW, ols=ols)
        src = list(exts)
        for _ in range(K):
            dst = [torch.full_like(X, float("nan")) for X in exts]
            stz._launch(src, exts, Rho_ext, dst,
                        stz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, False),
                        STOKES_KW, 0)
            src = dst
        for a, b in zip(src, want):
            same(a, b)
        got = _run_chunk(
            lambda src, dst, last: stz._launch(
                src, exts, Rho_ext, dst,
                stz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
                STOKES_KW, 0),
            exts, [torch.full(it.stacked_shape(s), float("nan"), dtype=dtype)
                   for s in shapes[:4]], K)
        for a, b, s in zip(got, want, shapes):
            same(a, ce.central_window(b, s, 2 * K, modes))


# The spacings of the Stokes checks and of config 5 at 256^3 and 509^3, 3,
# and divisors at the ends of the reciprocal path's range and beyond it.
@pytest.mark.parametrize("d", [0.31, 0.27, 0.43, 3.0, 10 / 255, 10 / 508,
                               2.0 ** -20, 2.0 ** 20, 2.0 ** -21, 1e30,
                               -0.27])
def test_stokes_division_matches_ieee(emulated, d):
    """The chunk walk's division (`const_div.cuh`) bitwise `x / d`: float32
    over 2^20 dividends spread over all 2^32 bit patterns (every exponent,
    both signs, zeros, subnormals, infinities and NaNs among them) and
    around the ends of its dividend range and zero, float64 over 2^18
    patterns spread over all 2^64 and around its range's ends; the card
    checks all 2^32 float32 dividends for the phases' divisors
    (chip_smoke.py)."""
    f32, f64 = torch.float32, torch.float64
    assert stz.division_mismatches(d, dtype=f32, n=1 << 20, step=4093,
                                   device="cpu") == 0
    for lo in (0x0d800000 - 512, 0x71800000 - 512, 0x80000000 - 512,
               0xffffff00):
        assert stz.division_mismatches(d, dtype=f32, lo=lo, n=1024, step=1,
                                       device="cpu") == 0
    assert stz.division_mismatches(d, dtype=f64, n=1 << 18,
                                   step=0x9E3779B97F4A7C15,
                                   device="cpu") == 0
    for lo in (63 << 52, 1983 << 52, 1 << 63):
        for sign in (0, 1 << 63):
            assert stz.division_mismatches(d, dtype=f64, lo=(lo ^ sign) - 512,
                                           n=1024, step=1, device="cpu") == 0


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


# Blocks of 12x12x36 at K = 3 (E = 6): an extended x span of 24 rows (12 on a
# frozen x) cut into 2 or 3 bands; y in 2 or 3 tiles and z in 2 (the face
# rows of Vy and Vz in the last tile), so wraps, freezes and tiles cross.
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STOKES_GRIDS))
def test_stokes_band_kernel_matches_plain(emulated, case, dtype, bands):
    """The Stokes band kernel against `banded_window_plain` with the port
    of igg's `_band_update`: the whole evolved extended buffers (tail rows
    and shoulders included) and the central windows of the last launch."""
    K, local = 3, (12, 12, 36)
    g = _stokes_grid(case, local)
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, 2 * K, modes)[0] // bands
    assert stz.stokes_banded_refusal(g, local, K, K, dtype, B=B) is None
    *state, Rho = _stokes_state(g, dtype, 43)
    exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
    for central in (False, True):
        got = _run_stag_band(
            lambda src, dst, cfg: stz._band_launch(src, exts, Rho_ext, dst,
                                                   cfg, STOKES_KW, 0),
            exts, shapes, local, 2 * K, K, B, 1, stz.EXTRAS, modes, g, ols,
            central)
        want = stz.band_call(exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                             grid=g, kw=STOKES_KW, ols=ols, central=central)
        for a, b in zip(got, want):
            same(a, b)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_open",
                                  "4x2x1_periods101", "2x1x1_wrap_y_open_xz"])
def test_stokes_band_march_edge_cases(emulated, short_segments, case, kind,
                                      dtype, monkeypatch):
    """The Stokes band kernel against `banded_window_plain` in the march's
    edge cases: the whole evolved extended buffers and the central
    windows, two bands."""
    from igg_torch.models import stokes3d as st3

    K = 3
    local = (12, 13, 35) if kind == "ragged_tiles" else (12, 12, 36)
    if kind == "short_segments":
        monkeypatch.setattr(stz, "library", short_segments.__getitem__)
    g = _stokes_grid(case, local)
    modes = ce.dim_modes(g)
    shapes = sp.field_shapes(g.nxyz)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, 2 * K, modes)[0] // 2
    assert stz.stokes_banded_refusal(g, local, K, K, dtype, B=B) is None
    if kind == "at_rest":
        *state, Rho = st3.init_fields(st3.Params(), dtype=dtype)
    else:
        *state, Rho = _stokes_state(g, dtype, 45)
    exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
    Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
    for central in (False, True):
        got = _run_stag_band(
            lambda src, dst, cfg: stz._band_launch(src, exts, Rho_ext, dst,
                                                   cfg, STOKES_KW, 0),
            exts, shapes, local, 2 * K, K, B, 1, stz.EXTRAS, modes, g, ols,
            central)
        want = stz.band_call(exts, Rho_ext, shapes, K=K, B=B, modes=modes,
                             grid=g, kw=STOKES_KW, ols=ols, central=central)
        for a, b in zip(got, want):
            same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_periods010",
                                  "1x2x2_open"])
def test_hm3d_band_march_edge_cases(emulated, short_segments, case, kind,
                                    dtype, monkeypatch):
    """The HM3D band kernel against `banded_window_plain` in the march's
    edge cases: the whole evolved extended buffers and the central
    windows, two bands."""
    from igg_torch.models import hm3d as h3

    (dims, per), K = BAND_GRIDS[case], 3
    local = (18, 13, 37) if kind == "ragged_tiles" else (18, 10, 40)
    if kind == "short_segments":
        monkeypatch.setattr(htz, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    ols = ce.field_ols(g, [g.nxyz]) * 2
    B = ce.ext_shape(local, K, modes)[0] // 2
    if kind == "at_rest":
        state = h3.init_fields(h3.Params(), dtype=dtype)
    else:
        state = (_random(shp, dtype, -0.5, 0, 21),
                 _random(shp, dtype, 0.05, 0.25, 22))
    exts = ce.extend_fields(list(state), ols, K, g, modes)
    for central in (False, True):
        got = _run_band(lambda src, dst, cfg: htz._band_launch(
            src, exts, dst, cfg, HM3D_KW, 0), exts, local=local, K=K, B=B,
            modes=modes, g=g, central=central)
        for a, b in zip(got, htz.band_call(exts, local, K=K, B=B, modes=modes,
                                           grid=g, kw=HM3D_KW,
                                           central=central)):
            same(a, b)


# The chunk meshes and z one periodic block over an open x and y, where
# a wrapped z row takes F at its target's z, not at its source's.
CHUNK_EDGE_GRIDS = dict(CHUNK_GRIDS, **{
    "2x1x1_wrap_z_open_xy": ((2, 1, 1), (0, 0, 1))})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(CHUNK_EDGE_GRIDS))
def test_hm3d_chunk_march_edge_cases(emulated, short_segments, case, kind,
                                     dtype, monkeypatch):
    """The HM3D chunk kernel (the HM3D march with the chunk's edge rules)
    against `window_steps_plain` in the march's edge cases, every layout
    of the chunk meshes: the whole evolved extended buffers of K = 3
    launches (the shoulders show the freeze rows beyond lo and hi and the
    outermost rows kept) and the central windows of a K = 3 chunk."""
    from igg_torch.models import hm3d as h3

    (dims, per), K = CHUNK_EDGE_GRIDS[case], 3
    local = (18, 13, 37) if kind == "ragged_tiles" else (18, 10, 40)
    if kind == "short_segments":
        monkeypatch.setattr(htz, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    if kind == "at_rest":
        state = h3.init_fields(h3.Params(), dtype=dtype)
    else:
        state = (_random(shp, dtype, -0.5, 0, 29),
                 _random(shp, dtype, 0.05, 0.25, 30))
    exts = ce.extend_fields(list(state), ce.field_ols(g, [g.nxyz]) * 2, K, g,
                            modes)
    want = htz.window_steps_plain(*exts, K=K, modes=modes, grid=g,
                                  kw=HM3D_KW)
    whole = _run_chunk(lambda src, dst, last: htz._launch(
        src, exts, dst, g.nxyz, K, modes, g, HM3D_KW, False, 0), exts,
        [torch.empty_like(X) for X in exts], K)
    got = _run_chunk(lambda src, dst, last: htz._launch(
        src, exts, dst, g.nxyz, K, modes, g, HM3D_KW, last, 0), exts,
        [torch.empty(shp, dtype=dtype) for _ in range(2)], K)
    for a, w, b in zip(got, whole, want):
        same(w, b)
        same(a, ce.central_window(b, g.nxyz, K, modes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(BAND_GRIDS))
def test_diffusion_band_march_edge_cases(emulated, short_segments, case, kind,
                                         dtype, monkeypatch):
    """The diffusion band kernel against `banded_window_plain` in the
    march's edge cases, every layout of the band meshes: the whole evolved
    extended buffer and the central window, two bands.  Its at-rest state
    is the diffusion model's `init_fields` (T's anomalies in a field at
    rest, A = 0.05 / Cp)."""
    from igg_torch.models import diffusion3d as d3

    (dims, per), K = BAND_GRIDS[case], 3
    local = (18, 13, 37) if kind == "ragged_tiles" else (18, 10, 40)
    if kind == "short_segments":
        monkeypatch.setattr(dtz, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", dimx=dims[0],
                        dimy=dims[1], dimz=dims[2], periodx=per[0],
                        periody=per[1], periodz=per[2])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
    if kind == "at_rest":
        T, Cp = d3.init_fields(d3.Params(), dtype=dtype)
        A = 0.05 / Cp
    else:
        T, A = (_random(shp, dtype, -10, 10, 31),
                _random(shp, dtype, 0.001, 0.1, 32))
    Text, A_ext = ce.extend_fields([T, A], ce.field_ols(g, [g.nxyz]) * 2, K,
                                   g, modes)
    B = ce.ext_shape(local, K, modes)[0] // 2
    for central in (False, True):
        got = _run_band(lambda src, dst, cfg: dtz._band_launch(
            src[0], A_ext, Text, dst[0], cfg, SC, 0), [Text], local=local,
            K=K, B=B, modes=modes, g=g, central=central)[0]
        same(got, dtz.band_call(Text, A_ext, local, K=K, B=B, modes=modes,
                                grid=g, sc=SC, central=central))


# The step marches' layouts: GRIDS (every halo mode, x wraps among them)
# and y received over a wrapped x and z, where a received y halo cell takes
# the y plane at its wrap source's z, not its own.
STEP_GRIDS = dict(GRIDS, recv_y_wrap_xz=dict(dimx=1, dimy=2, dimz=1,
                                             periodx=1, periodz=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(STEP_GRIDS))
def test_hm3d_step_march_edge_cases(emulated, short_segments, case, kind,
                                    dtype, monkeypatch):
    """The HM3D step kernel (the HM3D march with the fused step's edge
    rules) against `step_plain` in the march's edge cases, npow 0, 1, 2 and
    5: x segments of 3 rows (SHORT_SEGMENTS; 13 rows: 4 segments), extents
    that cross its 16 x 16 tiles and end in a ragged one (y 18, z 35), and
    fields at rest."""
    from igg_torch.models import hm3d as h3

    local = (19, 18, 35) if kind == "ragged_tiles" else (13, 10, 12)
    if kind == "short_segments":
        monkeypatch.setattr(hp, "library", short_segments.__getitem__)
    it.init_global_grid(*local, quiet=True, device="cpu", **STEP_GRIDS[case])
    g = it.get_global_grid()
    shp, modes = it.stacked_shape(g.nxyz), dp.step_modes(g)
    if kind == "at_rest":
        Pe, phi = h3.init_fields(h3.Params(), dtype=dtype)
    else:
        Pe, phi = (_random(shp, dtype, -0.5, 0, 41),
                   _random(shp, dtype, 0.05, 0.25, 42))
    for npow in (0, 1, 2, 5):
        kw = dict(HM3D_KW, npow=npow)
        recv = hp.step_recv_planes(Pe, phi, g, modes, kw)
        out = (torch.empty_like(Pe), torch.empty_like(phi))
        hp._launch(Pe, phi, out, modes, recv, g.dims, g.nxyz, kw, 0)
        for a, b in zip(out, hp.step_plain(Pe, phi, modes, recv, g.dims, kw)):
            same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES + ("tiny",))
@pytest.mark.parametrize("case", ["ring_periodic", "2x2x2_open",
                                  "4x2x1_periods101", "1x1x1_periodic"])
def test_stokes_step_march_edge_cases(emulated, short_segments, case, kind,
                                      dtype, monkeypatch):
    """The Stokes step kernel's x-march against `step_plain` in its edge
    cases: x segments of 3 rows (SHORT_SEGMENTS; 13 rows: 4 segments),
    extents that cross its tiles (8 rows by 32 columns) and end in a
    ragged one (y 19, z 35; x 17: 2 segments), fields at rest, and tiny
    fields (about 1e-37: dividends below the reciprocal path's range,
    subnormal ones among them in float32)."""
    from igg_torch.models import stokes3d as st3

    local = (17, 19, 35) if kind == "ragged_tiles" else (13, 9, 12)
    if kind == "short_segments":
        monkeypatch.setattr(sp, "library", short_segments.__getitem__)
    g = _stokes_grid(case, local)
    if kind == "at_rest":
        *srcs, Rho = st3.init_fields(st3.Params(), dtype=dtype)
    else:
        *srcs, Rho = _stokes_state(g, dtype, 51)
    if kind == "tiny":
        srcs, Rho = [A * 1e-37 for A in srcs], Rho * 1e-37
    out = [torch.empty_like(A) for A in srcs]
    sp._launch(srcs, Rho, out, g.dims, g.nxyz, STOKES_KW, 0)
    for a, b in zip(out, sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)):
        same(a, b)


# HM3D's divisors: phi0 and eta of its parameters, the checks' 1.3, and the
# spacings 10 / (n_g - 1) of its phases (n_g 254 on one periodic 256^3
# block, 508 on 2x2x2 periodic blocks of 256^3, 510 on open ones) and of
# their neighbours; and those of the chunk kernel's checks: HM3D_KW's
# spacings and 10 / (n_g - 1) on the chunk meshes at 16^3 and 16 x 12 x 13
# (chip_smoke.py), n_g from 10 to 114.
@pytest.mark.parametrize("d", [0.1, 1.0, 1.3, 10 / 252, 10 / 253, 10 / 254,
                               10 / 507, 10 / 508, 10 / 509, 0.31, 0.27,
                               0.43] + [10 / (n - 1) for n in (
                                   10, 11, 12, 13, 14, 16, 20, 22, 24, 28,
                                   30, 56, 112, 114)])
def test_hm3d_band_divisors_divide_as_ieee(emulated, d):
    """The HM3D marches' division (`const_div.cuh`) by their divisors
    bitwise `x / d`: float32 over 2^20 dividends spread over all 2^32 bit
    patterns and around its range's ends and zero, float64 over 2^18
    patterns spread over all 2^64; the card checks all 2^32 float32
    dividends (chip_smoke.py)."""
    f32, f64 = torch.float32, torch.float64
    assert stz.division_mismatches(d, dtype=f32, n=1 << 20, step=4093,
                                   device="cpu") == 0
    for lo in (0x0d800000 - 512, 0x71800000 - 512, 0x80000000 - 512):
        assert stz.division_mismatches(d, dtype=f32, lo=lo, n=1024, step=1,
                                       device="cpu") == 0
    assert stz.division_mismatches(d, dtype=f64, n=1 << 18,
                                   step=0x9E3779B97F4A7C15,
                                   device="cpu") == 0


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["diffusion_band", "halo_write", "hm3d_band",
                                  "hm3d_chunk", "hm3d_step", "pack_planes",
                                  "stokes_band", "stokes_chunk",
                                  "stokes_step"])
def test_first_designs_match_plain(emulated, first_designs, name, dtype,
                                   monkeypatch):
    """The redesigned kernels' first designs, kept as text to be timed
    beside them, still build against the headers and equal the plain
    versions: the halo writer on 2x2x2 blocks (EXT sources on every dim,
    and on y and z alone), the band kernels on 2x2x2 blocks (diffusion
    periodic in z, HM3D periodic in y, Stokes open), the Stokes chunk step
    on one periodic
    block, the HM3D chunk step on 2x2x1 blocks (y and z periodic), the
    packer on 2x2x2 blocks, the HM3D step on 1x2x2 blocks (x periodic: a
    wrap and received planes) and the Stokes step on 2x2x2 open blocks."""
    for module in (dtz, htz, stz, pk, hp, sp, hw):
        monkeypatch.setattr(module, "library", first_designs.__getitem__)
    if name == "halo_write":
        blocks, local = (2, 2, 2), (5, 7, 19)
        got, want = [], []
        for modes in (("ext", "ext", "ext"), ("none", "ext", "ext")):
            A = halo_cases.field([b * s for b, s in zip(blocks, local)],
                                 dtype, 0, 13)
            specs = halo_cases.specs(A, modes, blocks, 2, 17)
            want.append(hw.halo_write_plain(A.clone(), specs, blocks))
            hw._launch(A, specs, blocks, local, 0)
            got.append(A)
    elif name == "diffusion_band":
        it.init_global_grid(18, 10, 40, quiet=True, device="cpu", dimx=2,
                            dimy=2, dimz=2, periodz=1)
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
        ols = ce.field_ols(g, [g.nxyz]) * 2
        Text, A_ext = ce.extend_fields([_random(shp, dtype, -10, 10, 25),
                                        _random(shp, dtype, 0.001, 0.1, 26)],
                                       ols, 3, g, modes)
        got = _run_band(lambda src, dst, cfg: dtz._band_launch(
            src[0], A_ext, Text, dst[0], cfg, SC, 0), [Text], local=g.nxyz,
            K=3, B=12, modes=modes, g=g, central=True)
        want = [dtz.band_call(Text, A_ext, g.nxyz, K=3, B=12, modes=modes,
                              grid=g, sc=SC)]
    elif name == "hm3d_chunk":
        it.init_global_grid(16, 12, 13, quiet=True, device="cpu", dimx=2,
                            dimy=2, dimz=1, periody=1, periodz=1)
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
        exts = ce.extend_fields([_random(shp, dtype, -0.5, 0, 27),
                                 _random(shp, dtype, 0.05, 0.25, 28)],
                                ce.field_ols(g, [g.nxyz]) * 2, 3, g, modes)
        got = _run_chunk(lambda src, dst, last: htz._launch(
            src, exts, dst, g.nxyz, 3, modes, g, HM3D_KW, last, 0), exts,
            [torch.empty(shp, dtype=dtype) for _ in range(2)], 3)
        want = htz.chunk_call(exts, g.nxyz, K=3, modes=modes, grid=g,
                              kw=HM3D_KW)
    elif name == "hm3d_step":
        it.init_global_grid(12, 10, 12, quiet=True, device="cpu",
                            **GRIDS["recv_yz_wrap_x"])
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), dp.step_modes(g)
        Pe, phi = (_random(shp, dtype, -0.5, 0, 33),
                   _random(shp, dtype, 0.05, 0.25, 34))
        recv = hp.step_recv_planes(Pe, phi, g, modes, HM3D_KW)
        got = (torch.empty_like(Pe), torch.empty_like(phi))
        hp._launch(Pe, phi, got, modes, recv, g.dims, g.nxyz, HM3D_KW, 0)
        want = hp.step_plain(Pe, phi, modes, recv, g.dims, HM3D_KW)
    elif name == "stokes_step":
        g = _stokes_grid("2x2x2_open", (7, 6, 11))
        *srcs, Rho = _stokes_state(g, dtype, 53)
        got = [torch.empty_like(A) for A in srcs]
        sp._launch(srcs, Rho, got, g.dims, g.nxyz, STOKES_KW, 0)
        want = sp.step_plain(*srcs, Rho, g.dims, STOKES_KW)
    elif name == "hm3d_band":
        it.init_global_grid(18, 10, 40, quiet=True, device="cpu", dimx=2,
                            dimy=2, dimz=2, periody=1)
        g = it.get_global_grid()
        shp, modes = it.stacked_shape(g.nxyz), ce.dim_modes(g)
        ols = ce.field_ols(g, [g.nxyz]) * 2
        exts = ce.extend_fields([_random(shp, dtype, -0.5, 0, 23),
                                 _random(shp, dtype, 0.05, 0.25, 24)], ols,
                                3, g, modes)
        got = _run_band(lambda src, dst, cfg: htz._band_launch(
            src, exts, dst, cfg, HM3D_KW, 0), exts, local=g.nxyz, K=3, B=12,
            modes=modes, g=g, central=False)
        want = htz.band_call(exts, g.nxyz, K=3, B=12, modes=modes, grid=g,
                             kw=HM3D_KW, central=False)
    elif name == "stokes_band":
        K, local = 3, (12, 12, 36)
        g = _stokes_grid("2x2x2_open", local)
        modes = ce.dim_modes(g)
        shapes = sp.field_shapes(g.nxyz)
        ols = ce.field_ols(g, shapes)
        *state, Rho = _stokes_state(g, dtype, 47)
        exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        got = _run_stag_band(
            lambda src, dst, cfg: stz._band_launch(src, exts, Rho_ext, dst,
                                                   cfg, STOKES_KW, 0),
            exts, shapes, local, 2 * K, K, 12, 1, stz.EXTRAS, modes, g, ols,
            True)
        want = stz.band_call(exts, Rho_ext, shapes, K=K, B=12, modes=modes,
                             grid=g, kw=STOKES_KW, ols=ols)
    elif name == "stokes_chunk":
        K = 2
        g = _stokes_grid("1x1x1_periodic", (12, 12, 33))
        modes = ce.dim_modes(g)
        shapes = sp.field_shapes(g.nxyz)
        ols = ce.field_ols(g, shapes)
        *state, Rho = _stokes_state(g, dtype, 49)
        exts = ce.extend_fields(state, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        got = _run_chunk(
            lambda src, dst, last: stz._launch(
                src, exts, Rho_ext, dst,
                stz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
                STOKES_KW, 0),
            exts, [torch.empty(it.stacked_shape(s), dtype=dtype)
                   for s in shapes[:4]], K)
        want = stz.chunk_call(exts, Rho_ext, shapes, K=K, modes=modes,
                              grid=g, kw=STOKES_KW, ols=ols)
    else:
        dims, local = (2, 2, 2), (5, 7, 9)
        A = _random([n * s for n, s in zip(dims, local)], torch.float64, -1,
                    1, 5).to(dtype)
        reqs = [(1, 1), (1, 5), (2, 0), (2, 8), (2, 1)]
        got = [torch.full(pk._out_shape(A, d, dims), 7, dtype=dtype)
               for d, _ in reqs]
        pk._launch(A, reqs, dims, local, got, 0)
        want = pk.pack_planes_plain(A, reqs, dims)
    for a, b in zip(got, want):
        same(a, b)


# -- kernels generated from stencil specs ------------------------------------

def _spec_params():
    return [(name, case, local) for name in sorted(cases.SPECS)
            for case in sorted(cases.grids(name))
            for local in cases.locals_of(name)]


def _step_cfg(g, nd):
    return ce.stagger_cfg(g.nxyz[:nd], 0, ("ext",) * nd, g.dims, [], False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case,local", _spec_params())
def test_spec_step_kernel_matches_plain(emulated, name, case, local, dtype):
    g = cases.init(it, name, case, local, "cpu")
    gen = cases.kernels(name)
    nd = gen.spec.ndim
    S = cases.state(it, gen, g, dtype, 51)
    out = [torch.empty_like(A) for A in S]
    lower._launch(gen, S, S, out, _step_cfg(g, nd), 0)
    for a, b in zip(out, lower.step_plain(gen, S, g.dims[:nd])):
        same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case,local", _spec_params())
def test_spec_chunk_kernel_matches_plain(emulated, name, case, local, dtype):
    g = cases.init(it, name, case, local, "cpu")
    gen = cases.kernels(name)
    S = cases.state(it, gen, g, dtype, 61)
    ran = 0
    for K in (2, 3):
        setup = cases.chunk_setup(gen, g, S, K)
        if setup is None:
            continue
        E, modes, shapes, ols, exts = setup
        got = _run_chunk(
            lambda src, dst, last: lower._launch(
                gen, src, exts, dst,
                ce.stagger_cfg(g.nxyz[:len(shapes[0])], E, modes, g.dims, ols,
                               last), 0),
            exts, [torch.empty(it.stacked_shape(s), dtype=dtype)
                   for s in shapes], K)
        want = lower.chunk_plain(gen, exts, K=K, E=E, modes=modes, grid=g,
                                 ols=ols)
        for a, b, s in zip(got, want, shapes):
            same(a, ce.central_window(b, s, E, modes))
        ran += 1
    # The chunk refuses only `mixed` on open dims (its analyzer's
    # boundary-validity recurrence).
    assert ran or name == "mixed", (name, case)


@pytest.mark.parametrize("local", cases.LOCALS_2D)
@pytest.mark.parametrize("case", sorted(cases.GRIDS_2D))
def test_spec_wave2d_matches_hand_kernels(emulated, case, local):
    """The generated spec-wave2d step equals the hand-written wave2d step
    kernel bitwise; its chunk step (E = K) the hand chunk (E = 2K) on
    periodic grids, on the central windows."""
    g = cases.init(it, "wave2d_spec", case, local, "cpu")
    gen = cases.kernels("wave2d_spec")
    kw = dict(dx=0.31, dy=0.27, dt=0.05, rho=1.3, bulk=0.7)
    S = cases.state(it, gen, g, torch.float32, 71)
    hand = [torch.empty_like(A) for A in S]
    wp._launch(S, hand, g.dims[:2], g.nxyz[:2], kw, 0)
    out = [torch.empty_like(A) for A in S]
    lower._launch(gen, S, S, out, _step_cfg(g, 2), 0)
    for a, b in zip(out, hand):
        same(a, b)
    modes = ce.dim_modes(g)[:2]
    if any(m not in ("ext", "wrap") for m in modes):
        return
    K = 2
    E, modes, shapes, ols, exts = cases.chunk_setup(gen, g, S, K)
    got = _run_chunk(
        lambda src, dst, last: lower._launch(
            gen, src, exts, dst,
            ce.stagger_cfg(g.nxyz[:2], E, modes, g.dims, ols, last), 0),
        exts, [torch.empty_like(A) for A in S], K)
    wexts = ce.extend_fields(S, ols, 2 * K, g, modes)
    want = _run_chunk(
        lambda src, dst, last: wtz._launch(
            src, dst, wtz.chunk_cfg(shapes[0], 2 * K, modes, g, ols, last),
            kw, 0),
        wexts, [torch.empty_like(A) for A in S], K)
    for a, b in zip(got, want):
        same(a, b)


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,case", [(n, c) for n in cases.SPECS_3D
                                       for c in sorted(cases.GRIDS_3D)])
def test_spec_band_kernel_matches_plain(emulated, name, case, dtype, bands):
    """The generated band entry of the rank-3 specs against
    `banded_window_plain` with the band core derived from the evaluator:
    whole evolved buffers and central windows, blocks of 18x12x36, K = 3,
    an extended x span of 24 rows (18 on a frozen x) in 2 or 3 bands."""
    K, local = 3, (18, 12, 36)
    g = cases.init(it, name, case, local, "cpu")
    gen = cases.kernels(name)
    shapes = lower.field_shapes(gen.spec, g.nxyz)
    E = gen.analysis.margin_after(K)
    modes = ce.dim_modes(g)
    ols = ce.field_ols(g, shapes)
    B = ce.ext_shape(local, E, modes)[0] // bands
    assert lower.banded_refusal(gen.spec, gen.analysis, g, shapes[0], K, K,
                                dtype, B=B) is None
    lo, extras = lower.band_margins(gen.spec, gen.analysis)
    exts = ce.extend_fields(cases.state(it, gen, g, dtype, 65), ols, E, g,
                            modes)
    for central in (False, True):
        got = _run_stag_band(
            lambda src, dst, cfg: lower._band_launch(gen, src, exts, dst, cfg,
                                                     0),
            exts, shapes, local, E, K, B, lo, extras, modes, g, ols, central)
        want = lower.band_call(gen, exts, shapes, K=K, B=B, E=E, modes=modes,
                               grid=g, ols=ols, central=central)
        for a, b in zip(got, want):
            same(a, b)


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


# B = 8 and 16 in two and three bands, every window mode, y and z extents
# of one tile along z and two along y (the face rows of Vy and Vz in the
# last tiles).
@pytest.mark.parametrize("B,bands", [(8, 2), (8, 3), (16, 2), (16, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_march_matches_plain(emulated, name, case, dtype, B,
                                       bands):
    """The generated band entry's x-march against `banded_window_plain`
    at band depths 8 and 16, two and three bands, in every window mode."""
    _spec_band_check(name, case, dtype, B, bands, (9, 20))


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


# The march's edge cases: segments of 3 rows that cross the bands of 8
# (SHORT_SEGMENTS), y and z extents whose tiles end in ragged ones across
# the blocks' last rows (y 13, z 37: with the face rows 14 and 38, tiles of
# 8 x 32), and fields at rest.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", BAND_EDGE_CASES)
@pytest.mark.parametrize("case", sorted(cases.BAND_GRIDS))
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_march_edge_cases(emulated, short_generated, name, case,
                                    kind, dtype, monkeypatch):
    """The generated band entry's x-march against `banded_window_plain`
    in its edge cases, every window mode, B = 8 in three bands."""
    if kind == "short_segments":
        monkeypatch.setattr(lower, "generated_library", short_generated)
    _spec_band_check(name, case, dtype, 8, 3,
                     (13, 37) if kind == "ragged_tiles" else (9, 20),
                     fields=cases.at_rest if kind == "at_rest" else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["1x1x1_periodic", "2x2x2_open"])
@pytest.mark.parametrize("name", cases.SPECS_3D)
def test_spec_band_first_design_matches_plain(emulated, first_designs, name,
                                              case, dtype, monkeypatch):
    """The generated band entry's first design (the band walk,
    kernel_variants.py: spec_band_first_source), kept to be timed beside
    the march, still builds against the headers and equals
    `banded_window_plain`."""
    first = _build_first_generated(first_designs, name)
    monkeypatch.setattr(lower, "generated_library",
                        lambda source, tag: first)
    _spec_band_check(name, case, dtype, 8, 3, (9, 20))


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
