#!/usr/bin/env python3
"""Time variants of the port's CUDA sources side by side on one NVIDIA card.

    python3 kernel_variants.py [VARIANT ...] [sources:DIR ...]
                               [case:SUBSTRING ...]

Each variant is the sources of `igg_torch/csrc` (and the source generated
for the rank-3 spec `relax3d`) with one text edit or one extra `nvcc`
flag, built into a directory of its own under `_build`.  The wrappers of
`igg_torch.ops` and `igg_torch.stencil.lower` are pointed at each
variant's libraries in turn and the kernels are timed with CUDA events at
the main path's shapes; the variants run in the order A B .. B A, so drift
on the card shows.  Named variants run beside `as_built` only, each on
the cases whose library its edit changes (its source or a header it
includes): a variant is never timed on sources it leaves as they are,
and an edit that matches no source raises.  `sources:DIR` is a variant
too: the `igg_torch/csrc` of another checkout at DIR (say, the parent
commit's, unpacked with `git archive`) as it stands, every library built
and timed.  A `case:SUBSTRING` argument keeps the cases whose name
contains it.  The variants are the design choices the sources record:

- `as_built`: the sources as they are;
- `ldg_loads`: the walk's loads through the read-only path (`__ldg`);
- `vec_8B`: 8-byte vectors per thread instead of 16-byte ones (the 3-D
  walk's kernels; the wave2d kernels keep theirs);
- `approx_div`: `-prec-div=false`.  Not bitwise equal to the plain
  versions, so never shipped: it measures what the IEEE divisions of the
  HM3D, wave2d and Stokes kernels cost (in the Stokes chunk kernel only
  its float64 divisions and the float32 ones outside the reciprocal
  path's range remain IEEE divisions);
- `stokes_vec_16B`: the 3-D staggered walk's kernel (the Stokes step
  kernel; the chunk kernel left that walk in its redesign) with runs of
  16 bytes per thread (4 cells in f32) instead of 8, the first design;
- `stokes_bounds_3`: the Stokes step kernel bounded to 85 registers a
  thread (`__launch_bounds__(256, 3)`), so three thread blocks fit on an
  SM;
- `stokes_zero_quot`: the divisions of `stokes.cuh` (the Stokes step
  kernel) skipped where the dividend is zero (`0 / d` is that zero
  for a positive d, bitwise), which the IEEE division's checks otherwise
  send down its slow path;
- `stokes_x_fastest`: the Stokes step kernel's thread blocks ordered x
  row first (gridDim.x over the x rows, gridDim.z over the z tiles), so
  the blocks in flight together share their neighbour rows along x;
- the Stokes chunk and band kernels' x-march (`stokes_march.cuh`,
  `const_div.cuh`; the division variants reach the HM3D marches too):
  - `march_div_ieee` divides by `x / d` throughout, `march_div_vote` by
    a warp-uniform test (`x / d` unless a lane divides a zero, which then
    takes its signed zero) instead of the reciprocal path,
    `march_div_mul` by the reciprocal alone (not bitwise, never shipped:
    what the corrections cost);
  - `march_sync_staging` stages the marches' planes (Stokes, HM3D and
    diffusion, `async_copy.cuh`) with plain loads and stores instead of
    `cp.async`
    (TMA is no option: a tensor map needs row strides of whole 16 bytes,
    and Vz's rows are s2 + 1 cells);
    `march_ahead_2` stages each plane a step earlier (rings one plane
    deeper);
  - `march_tile_8x64`, `march_tile_16x32` and `march_tile_4x64`: (y, z)
    tiles other than 8 x 32;
  - `march_bounds_f32_2`, `_f32_4`, `_f64_1` and `_f64_3`: registers
    bounded for 2 or 4 thread blocks an SM in float32 (3 as built), 1 or
    3 in float64 (2 as built);
  - `march_no_segments` never cuts x into segments (a thread block marches
    a tile's whole x extent), `march_blocks_2048` and `march_blocks_32768`
    cut it until a launch has that many thread blocks (8192 as built);
- `pack_threads_128`: the plane packer in thread blocks of 128 threads
  (128 (x, y) rows a z block) instead of 256;
- the HM3D band and chunk kernels' x-march (`hm3d_march.cuh`; each
  variant times both): `hm_div_ieee` divides by `x / d` throughout,
  `hm_div_ieee_f32` in float32 only (as built: the chunk kernel in
  float32), `hm_div_const` by `const_div.cuh` throughout;
  `hm_ahead_2` and `hm_ahead_3` stage each
  plane one or two steps earlier (rings as much deeper), and
  `hm_ahead_2_bounds_f32_6` also bounds float32 registers for 6 thread
  blocks an SM; `hm_tile_8x32`, `hm_tile_4x64` (a cell a thread),
  `hm_tile_16x32`, `hm_tile_32x16` and `hm_tile_8x64` (two cells a
  thread, along y): (y, z) tiles other than 16 x 16; `hm_blocks_2048`,
  `hm_blocks_32768` and `hm_no_segments`: segments cut until a launch has
  that many thread blocks (8192 as built) or none; `hm_bounds_f32_3`,
  `_f32_6`, `_f64_2` and `_f64_4`: registers bounded for other numbers of
  thread blocks an SM (4 in float32 and 3 in float64 as built);
- the diffusion band kernel's x-march (`diffusion_march.cuh`):
  `dm_tile_8x32`, `dm_tile_16x32` and `dm_tile_32x16` (the last two two
  cells a thread): (y, z) tiles other than 16 x 16; `dm_ahead_0` and
  `dm_ahead_2`: T's ring one plane shallower or deeper (planes in flight
  while a plane is updated); `dm_blocks_2048`, `dm_blocks_32768` and
  `dm_no_segments`: segments cut until a launch has that many thread
  blocks (8192 as built) or none, `dm_min_seg_16` and `dm_min_seg_32`
  segments of at least 16 or 32 rows (8 as built); `dm_bounds_f32_4`,
  `_f32_5`, `_f32_8`, `_f64_5` and `_f64_8`: registers bounded for other
  numbers of
  thread blocks an SM (6 in float32 and 3 in float64 as built);
  `dm_no_wrap_writes` writes every cell to its own position only (not
  bitwise where y or z wraps, never shipped: what the wraps' targets
  cost);
- `first_designs`: the kernels redesigned since as they were before:
  the Stokes chunk step (the Stokes walk's 2-cell runs), the plane packer
  (a request per blockIdx.y), the Stokes band step (a thread block per
  band and tile on `stagger_band_walk3.cuh`, stokes.cuh's one-cell
  update), the HM3D and diffusion band steps (the same on `band_walk.cuh`
  with hm3d.cuh's and diffusion.cuh's) and the HM3D chunk step (the chunk
  walk, `chunk_walk.cuh`, with hm3d.cuh's), rebuilt from the text kept
  here (`FIRST_DESIGNS`);
- `band_row_staging`: the staggered band walk (now the generated rank-3
  band entries' only) staging its windows a warp
  per (x, y) row of a window, the row's offset formed once, its lanes
  along z, instead of one element a thread with two integer divisions and
  a 64-bit offset per element;
- `band_bounds_1`: the staggered band walk without its float32 register
  bound (`__launch_bounds__(256)` instead of `(256, 2)`): one thread
  block an SM (the Stokes band kernel's first design took 156 registers a
  thread on it).

Prints one JSON line per variant (milliseconds per launch, each a list of
the two runs; CUDA events, or for the packer the profiler's device time),
then the card's name and power limit.  Needs
`torch.cuda.is_available()`; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

LDG_LOAD = """template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  if constexpr (sizeof(T) * VEC == 16) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    return *reinterpret_cast<const Vec<T, VEC>*>(&w);
  } else if constexpr (sizeof(T) * VEC == 8) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p));
    return *reinterpret_cast<const Vec<T, VEC>*>(&w);
  } else {
    return Vec<T, VEC>{{__ldg(p)}};
  }
}"""
PLAIN_LOAD = """template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}"""


def ldg_loads(name, text):
    if name != "step_walk.cuh":
        return text
    if PLAIN_LOAD not in text or "  return *p;\n" not in text:
        raise RuntimeError("step_walk.cuh no longer has the plain loads")
    return text.replace(PLAIN_LOAD, LDG_LOAD).replace("  return *p;\n",
                                                      "  return __ldg(p);\n")


def vec_8b(name, text):
    return text.replace("constexpr int VEC = 16 / sizeof(typename P::T);",
                        "constexpr int VEC = 8 / sizeof(typename P::T);")


BOUNDS = "__launch_bounds__(256)\n"
VEC8 = "P, 8 / sizeof(typename P::T)>"
QUOT = "{ return x / d; }"


class stokes_edit:
    """Edits `(file, old, new)` of the kernels' sources, each of which must
    match its file's text exactly once (`build` raises for an edit whose
    file is missing: a stale edit fails, it never times the sources as
    they are under its name)."""

    def __init__(self, *edits):
        self.edits = edits

    def __call__(self, name, text):
        for f, old, new in self.edits:
            if name != f:
                continue
            if text.count(old) != 1:
                raise RuntimeError(f"{f} no longer has {old!r}")
            text = text.replace(old, new)
        return text

    def files(self):
        return {f for f, _, _ in self.edits}


def walk(old, new):
    return ("stagger_walk3.cuh", old, new)


FLAT_STAGING = """    for (int e = tid; e < n; e += BAND_TY * BAND_TZ) {
      const int j = e / plane, q = e - j * plane;
      win[k][e] = ld(src + band_src_at<P>(
                               g, k, p.b, clampi(p.a - bd.lo + j, 0, e0),
                               clampi(p.y0 - R + q / wz, 0, e1),
                               clampi(p.z0 - R + q % wz, 0, e2)));
    }"""
ROW_STAGING = """    for (int q = threadIdx.y; q < n / wz; q += BAND_TY) {
      const int j = q / wy;
      const T* row = src + band_src_at<P>(g, k, p.b,
                                          clampi(p.a - bd.lo + j, 0, e0),
                                          clampi(p.y0 - R + q - j * wy, 0, e1),
                                          0);
      for (int w = threadIdx.x; w < wz; w += BAND_TZ)
        win[k][q * wz + w] = ld(row + clampi(p.z0 - R + w, 0, e2));
    }"""
BAND_BOUNDS = ("__launch_bounds__(BAND_TY * BAND_TZ,\n"
               "                                  8 / sizeof(typename P::T))")


def band(old, new):
    return ("stagger_band_walk3.cuh", old, new)


# The first designs of the kernels redesigned since, rebuilt for side-by-side
# timing: the Stokes chunk step on the 3-D staggered walk with stokes.cuh's
# 2-cell runs, and the plane packer with a request per blockIdx.y and
# 64-bit index arithmetic per element.
CHUNK_FIRST = """#include "stokes.cuh"
extern "C" int igg_stokes_chunk_step(void* const* src, void* const* F,
                                     const void* rho, void* const* out,
                                     int dtype, const int* cfg,
                                     const double* coef, void* stream) {
  igg::Stag3 g;
  if (!igg::make_stag3(cfg, g)) return (int)cudaErrorInvalidValue;
  return igg::launch_stokes(src, rho, F, out, dtype, g, coef, stream);
}
"""
PACK_FIRST = """#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;

struct Req {
  int n[3], s[3], G[3];
  int nreq;
  int dim[kMaxPlanes];  // 1 or 2
  int pos[kMaxPlanes];  // local row of the plane along dim
  long long count[kMaxPlanes];
};

template <typename E>
struct Outs {
  E* p[kMaxPlanes];
};

template <typename E>
__global__ void __launch_bounds__(256)
    pack_kernel(const E* __restrict__ A, Req r, Outs<E> outs) {
  const int j = blockIdx.y;
  const long long total = r.count[j];
  E* __restrict__ out = outs.p[j];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long src;
    if (r.dim[j] == 1) {  // out (G0, n1, G2): i = (g0 * n1 + c1) * G2 + g2
      const long long g2 = i % r.G[2];
      const long long t = i / r.G[2];
      const long long c1 = t % r.n[1], g0 = t / r.n[1];
      src = (g0 * r.G[1] + c1 * r.s[1] + r.pos[j]) * r.G[2] + g2;
    } else {  // out (G0, G1, n2): i = (g0 * G1 + g1) * n2 + c2
      const long long c2 = i % r.n[2];
      const long long t = i / r.n[2];
      src = t * r.G[2] + c2 * r.s[2] + r.pos[j];
    }
    out[i] = A[src];
  }
}

template <typename E>
int launch(const void* A, const Req& r, void* const* outs, cudaStream_t st) {
  Outs<E> o{};
  long long most = 0;
  for (int j = 0; j < r.nreq; ++j) {
    o.p[j] = static_cast<E*>(outs[j]);
    if (r.count[j] > most) most = r.count[j];
  }
  if (most == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (most + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride beyond that
  const dim3 grid((unsigned)blocks, r.nreq);
  pack_kernel<E><<<grid, threads, 0, st>>>(static_cast<const E*>(A), r, o);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2; reqs: nreq (dim, pos) pairs, dim 1 or 2; outs: one
// dense plane tensor per request, in request order.
extern "C" int igg_pack_planes(const void* A, int elem_size, const int* cfg,
                               int nreq, const int* reqs, void* const* outs,
                               void* stream) {
  if (nreq < 1 || nreq > kMaxPlanes) return (int)cudaErrorInvalidValue;
  Req r;
  for (int d = 0; d < 3; ++d) {
    r.n[d] = cfg[d];
    r.s[d] = cfg[3 + d];
    r.G[d] = cfg[d] * cfg[3 + d];
  }
  r.nreq = nreq;
  for (int j = 0; j < nreq; ++j) {
    const int d = reqs[2 * j], p = reqs[2 * j + 1];
    if ((d != 1 && d != 2) || p < 0 || p >= r.s[d])
      return (int)cudaErrorInvalidValue;
    r.dim[j] = d;
    r.pos[j] = p;
    r.count[j] = (long long)r.G[0] * (d == 1 ? (long long)r.n[1] * r.G[2]
                                             : (long long)r.G[1] * r.n[2]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(A, r, outs, st);
    case 4: return launch<uint32_t>(A, r, outs, st);
    case 8: return launch<uint64_t>(A, r, outs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


# The band kernels' first designs: a thread block per band and (y, z) tile
# staging each array's window of the band's rows, the policy's one-cell
# update run on it (the Stokes band step on stagger_band_walk3.cuh with
# stokes.cuh, the HM3D one on band_walk.cuh with hm3d.cuh), each policy
# given here the arrays the walk stages.
STOKES_BAND_FIRST = """#include "stagger_band_walk3.cuh"
#include "stokes.cuh"
namespace {
// The arrays the band walk stages: P, Vx, Vy, Vz, then Rho (laid out like
// P); every value `cells` reads lies within one cell of its cell.
template <typename T>
struct StokesBand : igg::Stokes<T> {
  static constexpr int NS = 5;
  static constexpr int RADIUS = 1;
  __device__ __forceinline__ const T* staged(int k) const {
    return k < 4 ? this->src[k] : this->rho;
  }
  __device__ __forceinline__ void restage(int k, const T* p) {
    if (k < 4)
      this->src[k] = p;
    else
      this->rho = p;
  }
};
template <typename T>
int launch(void* const* src, void* const* F, const void* rho,
           void* const* out, const int* cfg, const double* coef,
           cudaStream_t stream) {
  igg::StagBand b;
  if (!igg::make_stag_band<StokesBand<T>>(cfg, b))
    return (int)cudaErrorInvalidValue;
  return igg::launch_stag_band(
      StokesBand<T>{igg::make_stokes<T>(src, rho, coef)}, b,
      igg::stokes_entry<T>(F), igg::stokes_out<T>(out), stream);
}
}  // namespace
extern "C" int igg_stokes_band_step(void* const* src, void* const* F,
                                    const void* rho, void* const* out,
                                    int dtype, const int* cfg,
                                    const double* coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, rho, out, cfg, coef, st);
  if (dtype == 1) return launch<double>(src, F, rho, out, cfg, coef, st);
  return (int)cudaErrorInvalidValue;
}
"""
HM3D_BAND_FIRST = """#include "band_walk.cuh"
#include "hm3d.cuh"
namespace {
// The arrays the band walk stages: Pe, phi.
template <typename T>
struct Hm3dBand : igg::Hm3d<T> {
  static constexpr int NS = 2;
  __device__ __forceinline__ const T* staged(int k) const {
    return this->src[k];
  }
  __device__ __forceinline__ void restage(int k, const T* p) {
    this->src[k] = p;
  }
};
template <typename T>
int launch(void* const* src, void* const* F, void* const* out,
           const igg::Band& b, const double* coef, int npow,
           cudaStream_t stream) {
  return igg::launch_band(
      Hm3dBand<T>{igg::make_hm3d<T>(src[0], src[1], coef, npow)}, b,
      igg::Fields<const T, 2>{
          {static_cast<const T*>(F[0]), static_cast<const T*>(F[1])}},
      igg::Fields<T, 2>{{static_cast<T*>(out[0]), static_cast<T*>(out[1])}},
      stream);
}
}  // namespace
extern "C" int igg_hm3d_band_step(void* const* src, void* const* F,
                                  void* const* out, int dtype, const int* cfg,
                                  const double* coef, int npow, void* stream) {
  igg::Band b;
  if (!igg::make_band(cfg, b) || npow < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, out, b, coef, npow, st);
  if (dtype == 1) return launch<double>(src, F, out, b, coef, npow, st);
  return (int)cudaErrorInvalidValue;
}
"""
# The HM3D chunk step's first design: the unstaggered chunk walk
# (chunk_walk.cuh, a thread per 16 bytes of a z row) with hm3d.cuh's
# update; the diffusion band step's: the band walk (band_walk.cuh) with
# diffusion.cuh's, the policy given the arrays the walk stages.
HM3D_CHUNK_FIRST = """#include "chunk_walk.cuh"
#include "hm3d.cuh"

namespace {

template <typename T>
int launch(void* const* src, void* const* F, void* const* out,
           const igg::Chunk& c, const double* coef, int npow,
           cudaStream_t stream) {
  return igg::launch_chunk(
      igg::make_hm3d<T>(src[0], src[1], coef, npow), c,
      igg::Fields<const T, 2>{
          {static_cast<const T*>(F[0]), static_cast<const T*>(F[1])}},
      igg::Fields<T, 2>{{static_cast<T*>(out[0]), static_cast<T*>(out[1])}},
      stream);
}

}  // namespace

extern "C" int igg_hm3d_chunk_step(void* const* src, void* const* F,
                                   void* const* out, int dtype, const int* cfg,
                                   const double* coef, int npow,
                                   void* stream) {
  igg::Chunk c;
  if (!igg::make_chunk(cfg, c) || npow < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, out, c, coef, npow, st);
  if (dtype == 1) return launch<double>(src, F, out, c, coef, npow, st);
  return (int)cudaErrorInvalidValue;
}
"""
DIFFUSION_BAND_FIRST = """#include "band_walk.cuh"
#include "diffusion.cuh"

namespace {
// The arrays the band walk stages: T, then A.
template <typename T>
struct DiffusionBand : igg::Diffusion<T> {
  static constexpr int NS = 2;
  __device__ __forceinline__ const T* staged(int k) const {
    return k == 0 ? this->src[0] : this->A;
  }
  __device__ __forceinline__ void restage(int k, const T* p) {
    if (k == 0)
      this->src[0] = p;
    else
      this->A = p;
  }
};

template <typename T>
int launch(const void* src, const void* A, const void* F, void* out,
           const igg::Band& b, double cx, double cy, double cz, double cc,
           cudaStream_t stream) {
  return igg::launch_band(
      DiffusionBand<T>{igg::make_diffusion<T>(src, A, cx, cy, cz, cc)}, b,
                          igg::Fields<const T, 1>{{static_cast<const T*>(F)}},
                          igg::Fields<T, 1>{{static_cast<T*>(out)}}, stream);
}

}  // namespace

extern "C" int igg_diffusion_band_step(const void* src, const void* A,
                                       const void* F, void* out, int dtype,
                                       const int* cfg, double cx, double cy,
                                       double cz, double cc, void* stream) {
  igg::Band b;
  if (!igg::make_band(cfg, b)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, A, F, out, b, cx, cy, cz, cc, st);
  if (dtype == 1)
    return launch<double>(src, A, F, out, b, cx, cy, cz, cc, st);
  return (int)cudaErrorInvalidValue;
}
"""
FIRST_DESIGNS = {"stokes_chunk.cu": CHUNK_FIRST, "pack_planes.cu": PACK_FIRST,
                 "stokes_band.cu": STOKES_BAND_FIRST,
                 "hm3d_band.cu": HM3D_BAND_FIRST,
                 "hm3d_chunk.cu": HM3D_CHUNK_FIRST,
                 "diffusion_band.cu": DIFFUSION_BAND_FIRST}


def first_design(name, text):
    return FIRST_DESIGNS.get(name, text)


def march(old, new):
    return ("stokes_march.cuh", old, new)


def march_tile(ty, tz):
    return stokes_edit(
        march("constexpr int MARCH_TY = 8; ", f"constexpr int MARCH_TY = {ty}; "),
        march("constexpr int MARCH_TZ = 32; ",
              f"constexpr int MARCH_TZ = {tz}; "))


MARCH_CDIV = """  if (div_admits(x, q)) return div_fast(x, q);
  return q.fast && x == T(0) ? x * q.r : x / q.d;"""
MARCH_BATCH = """    ok = ok & div_admits(x, q);
    return div_fast(x, q);"""


def march_div(cdiv_body):
    """The march's divisions all by `cdiv_body` (the batches take it too)."""
    return stokes_edit(("const_div.cuh", MARCH_CDIV, cdiv_body),
                       ("const_div.cuh", MARCH_BATCH,
                        "    return cdiv(x, q);"))


def march_plain_staging(name, text):
    """The marches' staging with plain loads and stores: the cp.async
    helpers take their CPU form."""
    if name != "async_copy.cuh":
        return text
    guard = "#if defined(__CUDA_ARCH__)\n"
    if text.count(guard) != 3:
        raise RuntimeError("async_copy.cuh no longer has its three "
                           "cp.async guards")
    return text.replace(guard, "#if 0\n")


def hm(old, new):
    return ("hm3d_march.cuh", old, new)


def hm_tile(ty, tz):
    return stokes_edit(
        hm("constexpr int HM_TY = 16; ", f"constexpr int HM_TY = {ty}; "),
        hm("constexpr int HM_TZ = 16; ", f"constexpr int HM_TZ = {tz}; "))


def hm_const(name, old, new):
    return stokes_edit(hm(f"constexpr int {name} = {old};",
                          f"constexpr int {name} = {new};"))


# The HM3D march's divisions by `x / d` (its own, not the Stokes ones'):
# in both types and both instances, in float32 only, or nowhere.
HM_IEEE = "constexpr bool hm_ieee = E::CHUNK && sizeof(T) == 4;"
HM_DIV_IEEE = stokes_edit(hm(HM_IEEE, "constexpr bool hm_ieee = true;"))
HM_DIV_IEEE_F32 = stokes_edit(hm(HM_IEEE,
                                 "constexpr bool hm_ieee = sizeof(T) == 4;"))
HM_DIV_CONST = stokes_edit(hm(HM_IEEE, "constexpr bool hm_ieee = false;"))


def dm(old, new):
    return ("diffusion_march.cuh", old, new)


def dm_tile(ty, tz):
    return stokes_edit(
        dm("constexpr int DM_TY = 16; ", f"constexpr int DM_TY = {ty}; "),
        dm("constexpr int DM_TZ = 16; ", f"constexpr int DM_TZ = {tz}; "))


def dm_const(name, old, new):
    return stokes_edit(dm(f"constexpr int {name} = {old};",
                          f"constexpr int {name} = {new};"))


VARIANTS = {
    "as_built": (lambda name, text: text, []),
    "ldg_loads": (ldg_loads, []),
    "vec_8B": (vec_8b, []),
    "approx_div": (lambda name, text: text, ["-prec-div=false"]),
    "stokes_vec_16B": (stokes_edit(
        walk(VEC8, "P, 16 / sizeof(typename P::T)>")), []),
    "stokes_bounds_3": (stokes_edit(
        walk(BOUNDS, "__launch_bounds__(256, 3)\n")), []),
    "stokes_zero_quot": (stokes_edit(
        ("stokes.cuh", QUOT, "{ return x == T(0) ? x : x / d; }")), []),
    "stokes_x_fastest": (stokes_edit(
        walk("{(int)blockIdx.z / h0, (int)blockIdx.y / ty,\n"
             "                    (int)blockIdx.x / tz}",
             "{(int)blockIdx.x / h0, (int)blockIdx.y / ty,\n"
             "                    (int)blockIdx.z / tz}"),
        walk("const int i = blockIdx.z - b[0] * h0;",
             "const int i = blockIdx.x - b[0] * h0;"),
        walk("const int k0 = (blockIdx.x - b[2] * tz)",
             "const int k0 = (blockIdx.z - b[2] * tz)"),
        walk("if (gx > 0x7fffffffLL || gy > 65535 || gz > 65535)",
             "if (gz > 0x7fffffffLL || gy > 65535 || gx > 65535)"),
        walk("const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);",
             "const dim3 grid((unsigned)gz, (unsigned)gy, (unsigned)gx);")),
        []),
    "band_row_staging": (stokes_edit(band(FLAT_STAGING, ROW_STAGING)), []),
    "band_bounds_1": (stokes_edit(band(
        BAND_BOUNDS, "__launch_bounds__(BAND_TY * BAND_TZ)")), []),
    "march_div_ieee": (march_div("  return x / q.d;"), []),
    "march_div_vote": (march_div(
        "  const bool nz = x != T(0);\n"
        "  if (__all_sync(__activemask(), nz)) return x / q.d;\n"
        "  return nz ? x / q.d : x * q.r;"), []),
    "march_div_mul": (stokes_edit((
        "const_div.cuh",
        "  const T y = div_fma(x, q.r, x * q.rl);\n"
        "  return div_fma(div_fma(-y, q.d, x), q.r, y);",
        "  return x * q.r;")), []),
    "march_sync_staging": (march_plain_staging, []),
    "march_ahead_2": (stokes_edit(march("constexpr int MARCH_AHEAD = 1; ",
                                        "constexpr int MARCH_AHEAD = 2; ")),
                      []),
    "march_blocks_2048": (stokes_edit(march(
        "constexpr int MARCH_BLOCKS = 8192; ",
        "constexpr int MARCH_BLOCKS = 2048; ")), []),
    "march_blocks_32768": (stokes_edit(march(
        "constexpr int MARCH_BLOCKS = 8192; ",
        "constexpr int MARCH_BLOCKS = 32768; ")), []),
    "march_tile_8x64": (march_tile(8, 64), []),
    "march_tile_16x32": (march_tile(16, 32), []),
    "march_tile_4x64": (march_tile(4, 64), []),
    "march_bounds_f32_2": (stokes_edit(march(
        "MARCH_MIN_BLOCKS_F32 = 3;", "MARCH_MIN_BLOCKS_F32 = 2;")), []),
    "march_bounds_f32_4": (stokes_edit(march(
        "MARCH_MIN_BLOCKS_F32 = 3;", "MARCH_MIN_BLOCKS_F32 = 4;")), []),
    "march_bounds_f64_1": (stokes_edit(march(
        "MARCH_MIN_BLOCKS_F64 = 2;", "MARCH_MIN_BLOCKS_F64 = 1;")), []),
    "march_bounds_f64_3": (stokes_edit(march(
        "MARCH_MIN_BLOCKS_F64 = 2;", "MARCH_MIN_BLOCKS_F64 = 3;")), []),
    "first_designs": (first_design, []),
    "hm_div_ieee": (HM_DIV_IEEE, []),
    "hm_ahead_2": (hm_const("HM_AHEAD", 1, 2), []),
    "hm_ahead_3": (hm_const("HM_AHEAD", 1, 3), []),
    "hm_ahead_2_bounds_f32_6": (stokes_edit(
        hm("constexpr int HM_AHEAD = 1;", "constexpr int HM_AHEAD = 2;"),
        hm("constexpr int HM_MIN_BLOCKS_F32 = 4;",
           "constexpr int HM_MIN_BLOCKS_F32 = 6;")), []),
    "hm_tile_8x32": (hm_tile(8, 32), []),
    "hm_tile_4x64": (hm_tile(4, 64), []),
    "hm_tile_16x32": (hm_tile(16, 32), []),
    "hm_tile_32x16": (hm_tile(32, 16), []),
    "hm_tile_8x64": (hm_tile(8, 64), []),
    "hm_blocks_2048": (hm_const("HM_BLOCKS", 8192, 2048), []),
    "hm_blocks_32768": (hm_const("HM_BLOCKS", 8192, 32768), []),
    "hm_no_segments": (hm_const("HM_BLOCKS", 8192, 1), []),
    "hm_bounds_f32_3": (hm_const("HM_MIN_BLOCKS_F32", 4, 3), []),
    "hm_bounds_f32_6": (hm_const("HM_MIN_BLOCKS_F32", 4, 6), []),
    "hm_bounds_f64_2": (hm_const("HM_MIN_BLOCKS_F64", 3, 2), []),
    "hm_bounds_f64_4": (hm_const("HM_MIN_BLOCKS_F64", 3, 4), []),
    "hm_div_ieee_f32": (HM_DIV_IEEE_F32, []),
    "hm_div_const": (HM_DIV_CONST, []),
    "dm_tile_8x32": (dm_tile(8, 32), []),
    "dm_tile_16x32": (dm_tile(16, 32), []),
    "dm_tile_32x16": (dm_tile(32, 16), []),
    "dm_ahead_0": (dm_const("DM_AHEAD", 1, 0), []),
    "dm_ahead_2": (dm_const("DM_AHEAD", 1, 2), []),
    "dm_blocks_2048": (dm_const("DM_BLOCKS", 8192, 2048), []),
    "dm_blocks_32768": (dm_const("DM_BLOCKS", 8192, 32768), []),
    "dm_no_segments": (dm_const("DM_BLOCKS", 8192, 1), []),
    "dm_no_wrap_writes": (stokes_edit(dm(
        "      if (!WRAPS || (tb[n] & 63) == 9) {", "      if (true) {")), []),
    "dm_min_seg_16": (dm_const("DM_MIN_SEG", 8, 16), []),
    "dm_min_seg_32": (dm_const("DM_MIN_SEG", 8, 32), []),

    "dm_bounds_f32_4": (dm_const("DM_MIN_BLOCKS_F32", 6, 4), []),
    "dm_bounds_f32_5": (dm_const("DM_MIN_BLOCKS_F32", 6, 5), []),
    "dm_bounds_f32_8": (dm_const("DM_MIN_BLOCKS_F32", 6, 8), []),
    "dm_bounds_f64_5": (dm_const("DM_MIN_BLOCKS_F64", 3, 5), []),
    "dm_bounds_f64_8": (dm_const("DM_MIN_BLOCKS_F64", 3, 8), []),
    "march_no_segments": (stokes_edit(march(
        "constexpr int MARCH_BLOCKS = 8192; ",
        "constexpr int MARCH_BLOCKS = 1; ")), []),
    "pack_threads_128": (stokes_edit((
        "pack_planes.cu", "constexpr int kThreads = 256;",
        "constexpr int kThreads = 128;")), []),
}
# The libraries a variant means to change, where the headers its edit
# touches reach more of them than its kernels (`RELAX3D`: the generated
# library of relax3d); the others change every library whose sources
# include an edited file.  `build` raises where a named library's sources
# do not.
RELAX3D = "relax3d"
MARCH = ("stokes_chunk", "stokes_band")
TARGETS = {v: MARCH for v in VARIANTS if v.startswith("march_")}
TARGETS.update(
    {v: ("stokes_step",) for v in ("stokes_vec_16B", "stokes_bounds_3",
                                   "stokes_zero_quot", "stokes_x_fastest")},
    vec_8B=("diffusion_step", "diffusion_chunk", "hm3d_step"),
    band_row_staging=(RELAX3D,), band_bounds_1=(RELAX3D,),
    march_sync_staging=MARCH + ("hm3d_band", "hm3d_chunk", "diffusion_band"),
    **{v: MARCH + ("hm3d_band", "hm3d_chunk")
       for v in ("march_div_ieee", "march_div_vote", "march_div_mul")})
LIBS = ("diffusion_step", "diffusion_chunk", "hm3d_step", "hm3d_chunk",
        "wave2d_step", "wave2d_chunk", "stokes_step", "stokes_chunk",
        "stokes_band", "pack_planes", "diffusion_band", "hm3d_band")
# The generated library of this spec case is built per variant too.
GENERATED = "relax3d"


def relax3d_kernels():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_spec_cases

    return torch_spec_cases.kernels(GENERATED)


INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)


def affected(texts, changed):
    """The libraries (names of the `.cu` sources in `texts`) whose source
    or headers, followed through their `#include "..."` lines, are among
    the file names `changed`."""
    def reach(f, seen):
        if f in seen or f not in texts:
            return seen
        seen.add(f)
        for h in INCLUDE.findall(texts[f]):
            reach(h, seen)
        return seen

    return {f[:-len(".cu")] for f in texts if f.endswith(".cu")
            and reach(f, set()) & changed}


def variant_sources(variant):
    """The variant's edit and flags, and the directory its sources come
    from: `sources:DIR` takes the `igg_torch/csrc` of another checkout at
    DIR (say, the parent commit's) as it stands."""
    from igg_torch.ops import _build

    if variant.startswith("sources:"):
        return ((lambda name, text: text), [],
                os.path.join(variant[len("sources:"):], "igg_torch", "csrc"))
    edit, flags = VARIANTS[variant]
    return edit, flags, _build.CSRC


def build(variant):
    """Build the variant's libraries; returns ({library name: CDLL}, the
    libraries its edit or flags change).  An edit that matches no source,
    or one of whose files is missing, raises."""
    from igg_torch.ops import _build

    edit, flags, csrc = variant_sources(variant)
    out = os.path.join(_build.BUILD_DIR,
                       f"variant_{variant.replace(os.sep, '_').replace(':', '_')}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    texts, changed = {}, set()
    for f in os.listdir(csrc):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as src:
                before = src.read()
            texts[f] = edit(f, before)
            if texts[f] != before:
                changed.add(f)
            with open(os.path.join(out, f), "w") as dst:
                dst.write(texts[f])
    missing = sorted(getattr(edit, "files", set)() - changed)
    if missing:
        raise RuntimeError(f"variant {variant}: its edits of {missing} "
                           f"match no source")
    if variant != "as_built" and not changed and not flags and \
            not variant.startswith("sources:"):
        raise RuntimeError(f"variant {variant} changes no source")
    gen = relax3d_kernels()
    texts[f"gen_{gen.tag}.cu"] = gen.source
    with open(os.path.join(out, f"gen_{gen.tag}.cu"), "w") as dst:
        dst.write(gen.source)
    touched = (set(LIBS) | {f"gen_{gen.tag}"}
               if flags or variant.startswith("sources:")
               or variant == "as_built" else affected(texts, changed))
    if variant in TARGETS:
        named = {f"gen_{gen.tag}" if lib == RELAX3D else lib
                 for lib in TARGETS[variant]}
        if named - touched:
            raise RuntimeError(f"variant {variant}: its edit no longer "
                               f"reaches {sorted(named - touched)}")
        touched = named
    procs = {lib: subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, *flags, "-o",
         os.path.join(out, f"{lib}.so"), os.path.join(out, f"{lib}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib in LIBS + (f"gen_{gen.tag}",) if lib in touched}
    libs = {}
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}/{lib}:\n{log}")
        libs[lib] = ctypes.CDLL(os.path.join(out, f"{lib}.so"))
        if lib.startswith("gen_"):
            from igg_torch.stencil.cuda import ARGTYPES, BAND_ENTRY, ENTRY
            names = [(n, ARGTYPES) for n in (ENTRY, BAND_ENTRY)]
        else:
            names = [_build.SIGNATURES[lib]]
        for fn_name, argtypes in names:
            fn = getattr(libs[lib], fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return libs, touched


def event_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profiled_ms(fn, n, kernel):
    """Mean device ms per launch of the kernel whose name contains `kernel`
    over `n` calls of `fn()` (`torch.profiler`): for kernels shorter than
    the host's time to launch them, where events would time the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel in evt.key and evt.count:
            total = getattr(evt, "device_time_total",
                            getattr(evt, "cuda_time_total", 0.0))
            return total / evt.count / 1e3
    raise RuntimeError(f"no device time for {kernel} in the trace")


def cases(dev):
    """(name, setup) pairs; setup() returns a function that launches the
    kernel once (for a chunk, K launches) and the launches it makes."""
    import igg_torch as it
    from igg_torch.models import hm3d as h3
    from igg_torch.ops import chunk_engine as ce
    from igg_torch.ops import diffusion_pallas as dp
    from igg_torch.ops import diffusion_trapezoid as dtz
    from igg_torch.ops import hm3d_pallas as hp
    from igg_torch.ops import hm3d_trapezoid as htz
    from igg_torch.models import wave2d as w2
    from igg_torch.ops import wave2d_pallas as wp
    from igg_torch.ops import wave2d_trapezoid as wtz
    from igg_torch.models import stokes3d as st3
    from igg_torch.ops import stokes_pallas as sp
    from igg_torch.ops import stokes_trapezoid as stz

    n, K = 256, 8
    sc = dp.scal(0.04, 0.04, 0.04)

    def grid(**kw):
        if it.grid_is_initialized():
            it.finalize_global_grid()
        it.init_global_grid(n, n, n, quiet=True, device=dev, **kw)
        return it.get_global_grid()

    one_block = dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1)

    def diffusion_step():
        g = grid(**one_block)
        T = torch.rand((n,) * 3, device=dev)
        A, out = 0.01 * torch.rand_like(T), torch.empty_like(T)
        return lambda: dp.launch_step(T, A, dp.step_modes(g), {}, g.dims, sc,
                                      out=out), 1

    def diffusion_chunk():
        g = grid(dimx=2, dimy=2, dimz=2)
        modes = ce.dim_modes(g)
        T = torch.rand(it.stacked_shape(g.nxyz), device=dev)
        Text, A_ext = ce.extend_fields([T, 0.01 * torch.rand_like(T)],
                                       ce.field_ols(g, [g.nxyz]) * 2, K, g,
                                       modes)
        return lambda: dtz.chunk_call(Text, A_ext, g.nxyz, K=K, modes=modes,
                                      grid=g, sc=sc), K

    def hm3d_step(state):
        def setup():
            g = grid(**one_block)
            p = h3.Params()
            if state == "random":
                Pe = -0.5 * torch.rand((n,) * 3, device=dev)
                phi = 0.1 + 0.1 * torch.rand_like(Pe)
            else:
                Pe, phi = h3.init_fields(p)
            out = (torch.empty_like(Pe), torch.empty_like(phi))
            return lambda: hp.launch_step(Pe, phi, hp.step_modes(g), ({}, {}),
                                          g.dims, p.step_kwargs(), out=out), 1
        return setup

    def hm3d_chunk(state="random", dtype=torch.float32):
        """One K = 8 chunk of the HM3D chunk kernel on 2x2x2 periodic
        blocks of 256^3 (8 extended blocks of 272^3), random fields or
        `init_fields`."""
        def setup():
            g = grid(dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                     periodz=1)
            modes = ce.dim_modes(g)
            p = h3.Params()
            if state == "random":
                Pe = -0.5 * torch.rand(it.stacked_shape(g.nxyz), device=dev,
                                       dtype=dtype)
                phi = 0.1 + 0.1 * torch.rand_like(Pe)
            else:
                Pe, phi = h3.init_fields(p, dtype=dtype)
            exts = ce.extend_fields([Pe, phi], ce.field_ols(g, [g.nxyz]) * 2,
                                    K, g, modes)
            kw = p.step_kwargs()
            return lambda: htz.chunk_call(exts, g.nxyz, K=K, modes=modes,
                                          grid=g, kw=kw), K
        return setup

    def wave2d(blocks, chunk):
        """The wave2d step or K-step chunk on `blocks` x 1 blocks of
        4096^2, periodic, random fields."""
        def setup():
            if it.grid_is_initialized():
                it.finalize_global_grid()
            it.init_global_grid(4096, 4096, 1, quiet=True, device=dev,
                                dimx=blocks, dimy=1, dimz=1, periodx=1,
                                periody=1)
            g = it.get_global_grid()
            kw = w2.Params().step_kwargs()
            shapes = wp.field_shapes(g.nxyz[:2])
            S = [2 * torch.rand(it.stacked_shape(s), device=dev) - 1
                 for s in shapes]
            if not chunk:
                out = [torch.empty_like(A) for A in S]
                return lambda: wp.launch_step(*S, g.dims[:2], kw, out=out), 1
            modes = ce.dim_modes(g)[:2]
            ols = ce.field_ols(g, shapes)
            exts = ce.extend_fields(S, ols, 2 * K, g, modes)
            return lambda: wtz.chunk_call(exts, shapes, K=K, modes=modes,
                                          grid=g, kw=kw, ols=ols), K
        return setup

    def pack(dtype, dims=(1, 2)):
        """The plane packer: the 8 y/z planes `update_halo` extracts from a
        field of 2x2x2 blocks of 256^3 (those along `dims`)."""
        def setup():
            from igg_torch.ops import pack as pk

            g = grid(dimx=2, dimy=2, dimz=2)
            T = torch.rand(it.stacked_shape(g.nxyz), device=dev).to(dtype)
            reqs = [(d, p) for d in dims for p in (1, n - 2, 0, n - 1)]
            return lambda: pk.pack_planes(T, reqs, g.dims), 1
        return setup

    def stokes(chunk, state="random", blocks=1, nx=n, dtype=torch.float32):
        """The Stokes iteration, or a K-step chunk, on `blocks`^3 blocks of
        nx x 256 x 256 (open on several blocks, periodic on one); random
        fields or `init_fields` (at rest: zero pressure and velocities)."""
        def setup():
            ol3 = dict(overlapx=3, overlapy=3, overlapz=3)
            if it.grid_is_initialized():
                it.finalize_global_grid()
            layout = (dict(dimx=2, dimy=2, dimz=2) if blocks == 2
                      else one_block)
            it.init_global_grid(nx, n, n, quiet=True, device=dev, **layout,
                                **ol3)
            g = it.get_global_grid()
            kw = st3._pseudo_steps(st3.Params())
            shapes = sp.field_shapes(g.nxyz)
            if state == "random":
                *S, Rho = [(2 * torch.rand(it.stacked_shape(s), device=dev)
                            - 1).to(dtype) for s in shapes]
            else:
                *S, Rho = st3.init_fields(st3.Params(), dtype=dtype)
            if not chunk:
                out = [torch.empty_like(A) for A in S]
                return lambda: sp.launch_step(*S, Rho, g.dims, kw,
                                              out=out), 1
            modes = ce.dim_modes(g)
            ols = ce.field_ols(g, shapes)
            exts = ce.extend_fields(S, ols[:4], 2 * K, g, modes)
            Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
            return lambda: stz.chunk_call(exts, Rho_ext, shapes, K=K,
                                          modes=modes, grid=g, kw=kw,
                                          ols=ols), K
        return setup

    def stokes_band(state="random", dtype=torch.float32):
        """One K = 8 banded chunk (B = 8) of the Stokes band kernel on 2x2x2
        open blocks of 256^3 (8 extended blocks of 288^3), random fields or
        `init_fields`."""
        def setup():
            g = grid(dimx=2, dimy=2, dimz=2, overlapx=3, overlapy=3,
                     overlapz=3)
            kw = st3._pseudo_steps(st3.Params())
            shapes = sp.field_shapes(g.nxyz)
            if state == "random":
                *S, Rho = [(2 * torch.rand(it.stacked_shape(s), device=dev)
                            - 1).to(dtype) for s in shapes]
            else:
                *S, Rho = st3.init_fields(st3.Params(), dtype=dtype)
            return band_of(g, kw, shapes, S, Rho)
        return setup

    def band_of(g, kw, shapes, S, Rho):
        modes = ce.dim_modes(g)
        ols = ce.field_ols(g, shapes)
        exts = ce.extend_fields(S, ols[:4], 2 * K, g, modes)
        Rho_ext = ce.extend_fields([Rho], [ols[4]], 2 * K, g, modes)[0]
        return lambda: stz.band_call(exts, Rho_ext, shapes, K=K, B=8,
                                     modes=modes, grid=g, kw=kw,
                                     ols=ols), K

    def hm3d_band(state="random", dtype=torch.float32):
        """One K = 8 banded chunk (B = 8) of the HM3D band kernel on 2x2x2
        periodic blocks of 256^3 (8 extended blocks of 272^3), random
        fields or `init_fields`."""
        def setup():
            g = grid(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
            modes = ce.dim_modes(g)
            p = h3.Params()
            if state == "random":
                Pe = -0.5 * torch.rand(it.stacked_shape(g.nxyz), device=dev,
                                       dtype=dtype)
                phi = 0.1 + 0.1 * torch.rand_like(Pe)
            else:
                Pe, phi = h3.init_fields(p, dtype=dtype)
            exts = ce.extend_fields([Pe, phi], ce.field_ols(g, [g.nxyz]) * 2,
                                    K, g, modes)
            kw = p.step_kwargs()
            return lambda: htz.band_call(exts, g.nxyz, K=K, B=8, modes=modes,
                                         grid=g, kw=kw), K
        return setup

    def diffusion_band(dtype=torch.float32, blocks=2):
        """One K = 8 banded chunk (B = 8) of the diffusion band kernel on
        2x2x2 open blocks of 256^3, or on one periodic block (phase 16's
        shapes)."""
        def setup():
            g = grid(**(dict(dimx=2, dimy=2, dimz=2) if blocks == 2
                        else one_block))
            modes = ce.dim_modes(g)
            T = torch.rand(it.stacked_shape(g.nxyz), device=dev, dtype=dtype)
            Text, A_ext = ce.extend_fields([T, 0.01 * torch.rand_like(T)],
                                           ce.field_ols(g, [g.nxyz]) * 2, K,
                                           g, modes)
            return lambda: dtz.band_call(Text, A_ext, g.nxyz, K=K, B=8,
                                         modes=modes, grid=g, sc=sc), K
        return setup

    def relax3d_band():
        """One K = 8 banded chunk (B = 8) of relax3d's generated band kernel
        on one periodic block of 256^3 (272 x 256 x 256 extended)."""
        from igg_torch.stencil import lower

        g = grid(**one_block)
        gen = relax3d_kernels()
        shapes = lower.field_shapes(gen.spec, g.nxyz)
        E = gen.analysis.margin_after(K)
        modes = ce.dim_modes(g)
        ols = ce.field_ols(g, shapes)
        exts = ce.extend_fields([2 * torch.rand((n,) * 3, device=dev) - 1],
                                ols, E, g, modes)
        return lambda: lower.band_call(gen, exts, shapes, K=K, B=8, E=E,
                                       modes=modes, grid=g, ols=ols), K

    gen = f"gen_{relax3d_kernels().tag}"
    f64 = torch.float64
    # (name, setup, the library whose kernel it times)
    return [("diffusion_step_256", diffusion_step, "diffusion_step"),
            ("diffusion_chunk_2x2x2_256_open", diffusion_chunk,
             "diffusion_chunk"),
            ("hm3d_step_256_random", hm3d_step("random"), "hm3d_step"),
            ("hm3d_step_256_init_fields", hm3d_step("init_fields"),
             "hm3d_step"),
            ("hm3d_chunk_2x2x2_256_periodic", hm3d_chunk(), "hm3d_chunk"),
            ("hm3d_chunk_2x2x2_256_periodic_init_fields",
             hm3d_chunk("init_fields"), "hm3d_chunk"),
            ("hm3d_chunk_2x2x2_256_periodic_f64", hm3d_chunk(dtype=f64),
             "hm3d_chunk"),
            ("wave2d_step_4096", wave2d(1, False), "wave2d_step"),
            ("wave2d_step_8x1_4096", wave2d(8, False), "wave2d_step"),
            ("wave2d_chunk_8x1_4096_periodic", wave2d(8, True),
             "wave2d_chunk"),
            ("stokes_step_256_periodic", stokes(False), "stokes_step"),
            ("stokes_step_256_periodic_init_fields",
             stokes(False, "init_fields"), "stokes_step"),
            ("stokes_step_288x256x256_periodic", stokes(False, nx=288),
             "stokes_step"),
            ("stokes_chunk_256_periodic", stokes(True), "stokes_chunk"),
            ("stokes_chunk_2x2x2_256_open", stokes(True, blocks=2),
             "stokes_chunk"),
            ("stokes_chunk_2x2x2_256_open_init_fields",
             stokes(True, "init_fields", blocks=2), "stokes_chunk"),
            ("stokes_chunk_2x2x2_256_open_f64",
             stokes(True, blocks=2, dtype=f64), "stokes_chunk"),
            ("pack_planes_2x2x2_256_f32", pack(torch.float32),
             "pack_planes"),
            ("pack_planes_2x2x2_256_f64", pack(f64), "pack_planes"),
            ("pack_planes_2x2x2_256_f32_y_only", pack(torch.float32, (1,)),
             "pack_planes"),
            ("pack_planes_2x2x2_256_f32_z_only", pack(torch.float32, (2,)),
             "pack_planes"),
            ("diffusion_band_2x2x2_256_open", diffusion_band(),
             "diffusion_band"),
            ("diffusion_band_2x2x2_256_open_f64", diffusion_band(f64),
             "diffusion_band"),
            ("diffusion_band_256_periodic", diffusion_band(blocks=1),
             "diffusion_band"),
            ("hm3d_band_2x2x2_256_periodic", hm3d_band(), "hm3d_band"),
            ("hm3d_band_2x2x2_256_periodic_init_fields",
             hm3d_band("init_fields"), "hm3d_band"),
            ("hm3d_band_2x2x2_256_periodic_f64", hm3d_band(dtype=f64),
             "hm3d_band"),
            ("stokes_band_2x2x2_256_open", stokes_band(), "stokes_band"),
            ("stokes_band_2x2x2_256_open_init_fields",
             stokes_band("init_fields"), "stokes_band"),
            ("stokes_band_2x2x2_256_open_f64", stokes_band(dtype=f64),
             "stokes_band"),
            ("relax3d_band_256_periodic", relax3d_band, gen)]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from igg_torch.ops import (diffusion_pallas, diffusion_trapezoid,
                               hm3d_pallas, hm3d_trapezoid, pack,
                               stokes_pallas, stokes_trapezoid, wave2d_pallas,
                               wave2d_trapezoid)
    from igg_torch.stencil import lower

    wrappers = (diffusion_pallas, diffusion_trapezoid, hm3d_pallas,
                hm3d_trapezoid, wave2d_pallas, wave2d_trapezoid,
                stokes_pallas, stokes_trapezoid, pack)
    named = [a for a in sys.argv[1:] if not a.startswith("case:")]
    keep = [a[len("case:"):] for a in sys.argv[1:] if a.startswith("case:")]
    for v in named:
        if v not in VARIANTS and not v.startswith("sources:"):
            raise SystemExit(f"unknown variant {v!r}: {sorted(VARIANTS)}")
    variants = ["as_built"] + named if named else list(VARIANTS)
    built, touched = {}, {}
    for v in variants:
        built[v], touched[v] = build(v)
    times = {v: {} for v in variants}
    tag = relax3d_kernels().tag
    for name, setup, lib in cases(torch.device("cuda")):
        if keep and not any(k in name for k in keep):
            continue
        # A variant that leaves this case's library as built is not timed
        # on it: its time would be the sources' as they are.
        mine = [v for v in variants if lib in touched[v]]
        if mine == ["as_built"]:
            continue
        run, launches = setup()
        for v in mine + mine[::-1]:
            for m in wrappers:
                m.library = built[v].__getitem__
            lower.generated_library = (
                lambda source, t, v=v: built[v][f"gen_{tag}"])
            times[v].setdefault(name, []).append(
                profiled_ms(run, 200, "pack_kernel")
                if name.startswith("pack") else
                event_ms(run, max(2, 40 // launches)) / launches)
        del run
    for v in variants:
        print(json.dumps({"variant": v, "ms_per_launch": times[v],
                          "libraries": sorted(touched[v])}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
