#!/usr/bin/env python3
"""Time variants of the port's CUDA sources side by side on one NVIDIA card.

    python3 kernel_variants.py [VARIANT ...] [sources:DIR ...]
                               [case:SUBSTRING ...]

Each variant is the sources of `igg_torch/csrc` (and the sources generated
for the rank-3 specs `relax3d` and `acoustic3d`) with one text edit or one
extra `nvcc` flag, built into a directory of its own under `_build`.  The wrappers of
`igg_torch.ops` and `igg_torch.stencil.lower` are pointed at each
variant's libraries in turn and the kernels are timed with CUDA events at
the main path's shapes; the variants run in the order A B .. B A, so drift
on the card shows.  Named variants run beside `as_built` only, each on
the cases whose library its edit changes (its source or a header it
includes): a variant is never timed on sources it leaves as they are,
and an edit that matches no source raises.  `sources:DIR` is a variant
too: the `igg_torch/csrc` of another checkout at DIR (say, the parent
commit's, unpacked with `git archive`) as it stands, every library built
and timed, the spec sources written by that checkout's own generator.  A
`case:SUBSTRING` argument keeps the cases whose name
contains it.  The variants are the design choices the sources record:

- `as_built`: the sources as they are;
- `ldg_loads`: the walk's loads through the read-only path (`__ldg`);
- `vec_8B`: 8-byte vectors per thread instead of 16-byte ones (the 3-D
  walk's kernels; the wave2d kernels keep theirs);
- `approx_div`: `-prec-div=false`.  Not bitwise equal to the plain
  versions, so never shipped: it measures what the IEEE divisions of the
  HM3D, wave2d and Stokes kernels cost (in the marches only their IEEE
  divisions and those outside the reciprocal path's range remain IEEE
  divisions);
- the Stokes step kernel's x-march (`stokes_step.cu`; each variant times
  it alone): `ss_c_f32_1`, `ss_c_f32_4`, `ss_c_f64_1` and `ss_c_f64_4`:
  other cells a lane's column holds along y (2 as built); `ss_w_2` and
  `ss_w_8`: 2 or 8 warps a thread block (4 as built; the tile's rows are
  warps times cells); `ss_div_ieee` and `ss_div_ieee_f32`: IEEE `x / d`
  in both types or in float32 only instead of `const_div.cuh`; `ss_zero`:
  zero dividends kept on the reciprocal path (their signed zero set from
  the operands' signs) where a zero otherwise sends its batch of
  divisions to `cdiv`; `ss_wide`: a float32 batch outside the reciprocal
  path's range formed again on the float64 one before `cdiv`;
  `ss_ahead_2`: the staging rings a plane deeper; `ss_blocks_1024`,
  `_2048`, `_8192`, `_16384` and `ss_no_segments`: x cut into segments
  until a launch has that many thread blocks (4096 as built) or not at
  all; `ss_bounds_f32_2`, `_f32_4`, `_f64_2` and `_f64_4`: registers
  bounded for other numbers of thread blocks an SM (3 as built);
- the HM3D step's edge rules on the HM3D march (`StepEdges`; each
  variant times the step kernel alone): `hm_step_blocks_512`, `_1024`,
  `_2048`, `_16384`, `_32768` and `hm_step_no_segments`: the step's
  segments cut until a launch has that many thread blocks (8192 as built)
  or none; `hm_step_min_seg_4`, `_8` and `_32`: segments of at least 4
  (cut until 16384 thread blocks), 8 or 32 rows (16 as built); `hm_step_noinline_special`: the writes
  of the cells on a wrap's edge or alias rows or a received y or z halo
  row (`hm_step_put_special`) as a called function, not inlined;
  `hm_step_no_special_writes`: those cells not written at all (not
  bitwise, never shipped: what their writes cost); `hm_step_bounds_f32_3`,
  `_f64_2` and `_f64_3`: the step's registers bounded for other numbers of
  thread blocks an SM (4 as built);
  `hm_step_div_const` and `hm_step_div_ieee`: the step's division by
  `const_div.cuh` in float32 too, or by `x / d` in float64 too (as built
  `x / d` in float32, `const_div.cuh` in float64);
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
  `hm_div_ieee_f32` in float32 only (as built: the chunk and step
  kernels in float32), `hm_div_const` by `const_div.cuh` throughout;
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
  with hm3d.cuh's and diffusion.cuh's), the HM3D chunk step (the chunk
  walk, `chunk_walk.cuh`, with hm3d.cuh's), the Stokes step (the 2-cell
  runs on the staggered 3-D walk, `stagger_walk3_first.cuh`) and the HM3D
  step (`step_walk.cuh` with hm3d.cuh's), the halo writer (a thread a halo
  cell, its plane's cells found by divisions), the generated rank-3 band
  entries (the band walk, `stagger_band_walk3.cuh`: a thread block per
  band and tile, wrap aliases recomputed) and the generated rank-3 step
  and chunk entries (the staggered 3-D walk: a thread a run of 8 bytes of
  every block's bounding box, wrap cells recomputed one by one), rebuilt
  from the text kept here (`FIRST_DESIGNS`, with the policies and the
  walks only they use, `FIRST_HEADERS`: stokes.cuh's `cells`, hm3d.cuh,
  the staggered walk and the staggered band walk; the generated entries'
  source by `spec_first_source`);
- the generated rank-3 band entries' x-march
  (`stagger_band_march3.cuh`; each variant times relax3d's and
  acoustic3d's, f32 and f64): `sb_cpt_one_1` and `sb_cpt_one_4`: one or
  four cells a thread where the policy stages one array (two as built),
  `sb_cpt_many_2` and `sb_cpt_many_2_bounds_3_2`: two where it stages
  more (one as built; the latter with registers bounded for 3 thread
  blocks an SM in float32 and 2 in float64); `sb_tz_32` and `sb_tz_64`:
  tile rows of 32 or 64 z cells (16 as built);
  `sb_ahead_0` and `sb_ahead_2`: the rings a plane shallower or deeper;
  `sb_blocks_2048`, `sb_blocks_32768` and `sb_no_segments`: segments cut
  until a launch has that many thread blocks (8192 as built) or none,
  `sb_min_seg_16` and `sb_min_seg_32` segments of at least 16 or 32 rows
  (8 as built); `sb_bounds_f32_2`, `_f32_3`, `_f32_6`, `_f32_8`,
  `_f64_2`, `_f64_4` and `_f64_6`: registers bounded for other numbers of
  thread blocks an SM (4 in float32 and 3 in float64 as built);
- the generated rank-3 step and chunk entries on the same header's step
  and chunk modes (`stagger_band_march3.cuh`, `SX_*`; each variant times
  relax3d's and acoustic3d's step and K = 8 chunk step, f32 and f64):
  `sx_cpt_one_2` and `sx_cpt_one_8`: two or eight cells a thread where
  the policy stages one array in float32 (four as built),
  `sx_cpt_one_f64_1` and `sx_cpt_one_f64_4`: one or four in float64 (two
  as built), `sx_cpt_many_1` and `sx_cpt_many_4`: one or four where it
  stages more (two as built); `sx_tz_16` and `sx_tz_64`: tile rows of 16
  or 64 z cells (32 as built); `sx_ahead_0` and `sx_ahead_2`: the rings a
  plane shallower or deeper; `sx_blocks_1024`, `sx_blocks_4096`,
  `sx_blocks_8192` and `sx_no_segments`: segments cut until a launch has
  that many thread blocks (2048 as built) or none, `sx_min_seg_4` and
  `sx_min_seg_16` segments of at least 4 or 16 rows (8 as built);
  `sx_bounds_f32_2`, `_f32_3`, `_f32_6`, `_f64_2` and `_f64_4`: registers
  bounded for other numbers of thread blocks an SM where one array is
  staged (4 in float32 and 3 in float64 as built),
  `sx_bounds_many_f32_2`, `_f32_3`, `_f32_5`, `_f64_1` and `_f64_3`:
  where more are (4 in float32, 2 in float64 as built), and
  `sx_bounds_many_chunk_f32_1` and `_3` for the chunk mode's float32 (2
  as built); `sx_put_noinline`: the writes to a wrap's edge rows a called
  function; and two diagnostics, not bitwise, never shipped:
  `sx_no_wrap_writes` (no edge row of a wrap written: what the edge
  blocks cost) and `sx_step_for_chunk` (the step mode on every layout: no
  edge row and no freeze written, what the chunk mode costs); and the
  control `walk_vec16`: the entries' first design, the walk, with runs of
  16 bytes instead of 8;
- the halo writer (`halo_write.cu`; timed at 256^3 periodic and 2x2x2
  blocks of 256^3 EXT, f32 and f64): `hw_rows_2` and `hw_rows_8`: thread
  blocks of 2 or 8 rows (4 as built); `hw_zjoint`: a thread both sides of
  a row's z halo (a lane a side as built).

Prints one JSON line per variant (milliseconds per launch, each a list of
the two runs; CUDA events, or for the packer and the halo writer the
profiler's device time;
and ptxas's registers, stack and spills of each kernel it built), then
the card's name and power limit.  The variants build side by side.  Needs
`torch.cuda.is_available()`; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
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


def sb(old, new):
    return ("stagger_band_march3.cuh", old, new)


def sb_const(name, old, new):
    return stokes_edit(sb(f"constexpr int {name} = {old};",
                          f"constexpr int {name} = {new};"))


def sx_const(name, old, new):
    """A knob of the step and chunk modes (`SX_*`, stagger_band_march3.cuh)."""
    return sb_const(name, old, new)


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
# The step kernels' first designs: the Stokes iteration on the 3-D
# staggered walk (stagger_walk3.cuh) with stokes.cuh's 2-cell runs, and the
# HM3D step on the walk of the halo modes (step_walk.cuh) with hm3d.cuh's
# update.
STOKES_STEP_FIRST = """#include "stokes.cuh"

// src, out: (P, Vx, Vy, Vz) pointers of the sources and of the targets (laid
// out like the sources, none aliasing another); rho: Rho, laid out like P;
// cfg: n0 n1 n2 s0 s1 s2 (blocks and P's block extents); coef: dx dy dz mu
// 2*mu dtP dtV; dtype: 0 float32, 1 float64.
extern "C" int igg_stokes_step(void* const* src, const void* rho,
                               void* const* out, int dtype, const int* cfg,
                               const double* coef, void* stream) {
  // make_stag3's layout: whole blocks, no wrap, no freeze.
  int full[24 + 3 * igg::MAXF] = {cfg[0], cfg[1], cfg[2], cfg[3], cfg[4],
                                  cfg[5], 0,      0,      0,      0,
                                  0,      0,      cfg[3], cfg[4], cfg[5]};
  igg::Stag3 g;
  if (!igg::make_stag3(full, g)) return (int)cudaErrorInvalidValue;
  return igg::launch_stokes(src, rho, nullptr, out, dtype, g, coef, stream);
}
"""
HM3D_STEP_FIRST = """#include "hm3d.cuh"

namespace {

template <typename T>
int launch(const void* Pe, const void* phi, void* Pe_out, void* phi_out,
           const igg::Geo& geo, void* const* planes, const double* coef,
           int npow, cudaStream_t stream) {
  igg::Planes<T, 2> pl;
  for (int f = 0; f < 2; ++f)
    for (int j = 0; j < 6; ++j)
      pl.p[f][j] = static_cast<const T*>(planes[6 * f + j]);
  return igg::launch_step(
      igg::make_hm3d<T>(Pe, phi, coef, npow), geo, pl,
      igg::Fields<T, 2>{{static_cast<T*>(Pe_out), static_cast<T*>(phi_out)}},
      stream);
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2 mode0 mode1 mode2; planes: 12 pointers, (field,
// dim, side) with Pe's six first, null for dims not in RECV mode; coef: dx
// dy dz dt phi0 eta; npow >= 0; dtype: 0 float32, 1 float64.
extern "C" int igg_hm3d_step(const void* Pe, const void* phi, void* Pe_out,
                             void* phi_out, int dtype, const int* cfg,
                             void* const* planes, const double* coef,
                             int npow, void* stream) {
  const igg::Geo geo = igg::make_geo(cfg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (npow < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(Pe, phi, Pe_out, phi_out, geo, planes, coef, npow,
                         st);
  if (dtype == 1)
    return launch<double>(Pe, phi, Pe_out, phi_out, geo, planes, coef, npow,
                          st);
  return (int)cudaErrorInvalidValue;
}
"""
# The halo writer's first design: a thread a halo cell of one grid for all
# six planes, its plane's cells found by divisions of the thread's index.
HALO_WRITE_FIRST = """// In-place halo writer: one launch writes the two halo planes of every
// participating dimension of a block-stacked grid array, in dimension order
// (later dims own the shared corner and edge cells).  Per dim the source is
// WRAP (the block's own inner plane s-ol / ol-1, one block along the dim)
// or EXT (dense received planes, stacked over the blocks).
//
// Replaces the TPU writers of igg/ops/halo_write.py (_inplace_call,
// _write_dim0/1/2, _halo_write_raw; entries halo_write, halo_write_slabs,
// write_lane_active).
//
// What bounds it on the H100: launch latency.  It moves only the planes:
// at 256^3 f32 six planes of 256^2 cells read and written, about 3.1 MB, or
// about 1 us at 3.35 TB/s, below the few microseconds a launch costs.  The
// TPU's minor-dim read-modify-write of whole tiles has no counterpart: the
// card writes single elements.  The z planes (dim 2) are the strided ones
// of a C-ordered (x, y, z) tensor: each of their cells is a sector of its
// own.
//
// (The first design of the halo writer, kept to be timed beside it.)
//
// What the design does about it: one launch for all dims, one thread per
// halo cell and nothing else touched.  blockIdx.y picks the (dim, side) of
// the plane, and each dim has its own compiled path (write_plane<D>), so
// all index arithmetic stays in registers.  Threads run along the
// contiguous axis of each plane (z for the x and y planes; y for the z
// planes, along which the EXT plane is contiguous).  A cell whose later dim
// also writes it is left to that dim's thread.  Each written cell's value
// is resolved by walking the dims down from its own, exactly as the
// sequential per-dim writes would have left it: a WRAP dim maps the index
// to its source plane, an EXT dim returns the received plane's value, and
// the walk ends in the block itself at a cell that is not a halo cell of
// any participating dim, so no thread reads a cell another thread writes.
// Element-size generic (2, 4, 8 bytes): it copies bits.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { NONE = 0, WRAP = 1, EXT = 2 };

struct Cfg {
  int n[3], s[3], G[3], ol[3], mode[3];
};

template <typename E>
struct Src {
  const E* p[6];
};

__device__ __forceinline__ int block_of(int g, int n, int s) {
  return n == 1 ? 0 : g / s;
}

// Writes plane `side` of dim D: its cells (a, b, w) with w the fastest,
// a over the blocks along D, (b, w) over the other two dims.
template <typename E, int D>
__device__ __forceinline__ void write_plane(E* __restrict__ A, const Cfg& cfg,
                                            const Src<E>& src, int side) {
  constexpr int DB = D == 0 ? 1 : 0;
  constexpr int DW = D == 2 ? 1 : 2;
  const int nb = cfg.G[DB], nw = cfg.G[DW];
  const int total = cfg.n[D] * nb * nw;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += gridDim.x * blockDim.x) {
    int g[3];
    g[DW] = t % nw;
    const int r = t / nw;
    g[DB] = r % nb;
    g[D] = (r / nb) * cfg.s[D] + (side ? cfg.s[D] - 1 : 0);
    bool owned = true;
#pragma unroll
    for (int e = D + 1; e < 3; ++e) {
      const int i = g[e] - block_of(g[e], cfg.n[e], cfg.s[e]) * cfg.s[e];
      if (cfg.mode[e] != NONE && (i == 0 || i == cfg.s[e] - 1)) owned = false;
    }
    if (!owned) continue;
    const long long out =
        ((long long)g[0] * cfg.G[1] + g[1]) * cfg.G[2] + g[2];
    E v;
    bool done = false;
#pragma unroll
    for (int e = D; e >= 0; --e) {
      if (done || cfg.mode[e] == NONE) continue;
      const int c = block_of(g[e], cfg.n[e], cfg.s[e]);
      const int i = g[e] - c * cfg.s[e];
      if (i != 0 && i != cfg.s[e] - 1) continue;
      if (cfg.mode[e] == EXT) {
        // The received plane of dim e has extent n[e] along e.
        int p[3] = {g[0], g[1], g[2]};
        p[e] = c;
        const int P1 = e == 1 ? cfg.n[1] : cfg.G[1];
        const int P2 = e == 2 ? cfg.n[2] : cfg.G[2];
        const E* plane = i == 0 ? src.p[2 * e] : src.p[2 * e + 1];
        v = plane[((long long)p[0] * P1 + p[1]) * P2 + p[2]];
        done = true;
      } else {  // WRAP: one block along e, so g[e] is the local index
        g[e] = i == 0 ? cfg.s[e] - cfg.ol[e] : cfg.ol[e] - 1;
      }
    }
    if (!done) v = A[((long long)g[0] * cfg.G[1] + g[1]) * cfg.G[2] + g[2]];
    A[out] = v;
  }
}

template <typename E>
__global__ void __launch_bounds__(256)
    halo_write_kernel(E* A, Cfg cfg, Src<E> src) {
  const int side = blockIdx.y & 1;
  switch (blockIdx.y >> 1) {
    case 0:
      if (cfg.mode[0] != NONE) write_plane<E, 0>(A, cfg, src, side);
      break;
    case 1:
      if (cfg.mode[1] != NONE) write_plane<E, 1>(A, cfg, src, side);
      break;
    default:
      if (cfg.mode[2] != NONE) write_plane<E, 2>(A, cfg, src, side);
  }
}

template <typename E>
int launch(void* A, const Cfg& cfg, void* const* planes, cudaStream_t st) {
  Src<E> src;
  for (int j = 0; j < 6; ++j) src.p[j] = static_cast<const E*>(planes[j]);
  long long most = 0;
  for (int d = 0; d < 3; ++d) {
    if (cfg.mode[d] == NONE) continue;
    const long long cells = (long long)cfg.G[0] * cfg.G[1] * cfg.G[2] /
                            cfg.G[d] * cfg.n[d];
    if (cells > INT_MAX) return (int)cudaErrorInvalidValue;
    if (cells > most) most = cells;
  }
  if (most == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (most + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond that
  const dim3 grid((unsigned)blocks, 6);  // y: (dim, side) of the plane
  halo_write_kernel<E><<<grid, threads, 0, st>>>(static_cast<E*>(A), cfg, src);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2 ol0 ol1 ol2 mode0 mode1 mode2 (0 NONE, 1 WRAP,
// 2 EXT); planes: (dim, side) pointers of the EXT dims, null elsewhere.
extern "C" int igg_halo_write(void* A, int elem_size, const int* cfg_in,
                              void* const* planes, void* stream) {
  Cfg cfg;
  for (int d = 0; d < 3; ++d) {
    cfg.n[d] = cfg_in[d];
    cfg.s[d] = cfg_in[3 + d];
    cfg.G[d] = cfg_in[d] * cfg_in[3 + d];
    cfg.ol[d] = cfg_in[6 + d];
    cfg.mode[d] = cfg_in[9 + d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(A, cfg, planes, st);
    case 4: return launch<uint32_t>(A, cfg, planes, st);
    case 8: return launch<uint64_t>(A, cfg, planes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
FIRST_DESIGNS = {"stokes_chunk.cu": CHUNK_FIRST, "pack_planes.cu": PACK_FIRST,
                 "stokes_band.cu": STOKES_BAND_FIRST,
                 "hm3d_band.cu": HM3D_BAND_FIRST,
                 "hm3d_chunk.cu": HM3D_CHUNK_FIRST,
                 "diffusion_band.cu": DIFFUSION_BAND_FIRST,
                 "stokes_step.cu": STOKES_STEP_FIRST,
                 "hm3d_step.cu": HM3D_STEP_FIRST,
                 "halo_write.cu": HALO_WRITE_FIRST}
# The policies only the first designs use: stokes.cuh with its update of a
# run of cells on the staggered walks (`cells`, the kernels' as-built
# stokes.cuh keeps the fields' layout alone), and hm3d.cuh, the HM3D update
# of the unstaggered walks (step_walk.cuh, chunk_walk.cuh, band_walk.cuh).
STOKES_POLICY_FIRST = """// The stokes3d physics of the 3-D staggered walk
// (stagger_walk3_first.cuh): the pressure P (field 0) and the face
// velocities Vx (field 1, one cell longer in x), Vy (field 2, in y) and Vz
// (field 3, in z), with the constant
// buoyancy Rho laid out like P, updated as
// igg_torch.models.stokes3d.iteration_core updates every block:
//   gx = (Vx[i+1] - Vx[i]) / dx, gy, gz alike      at every cell
//   divV = ((gx + gy) + gz),  P' = P - dtP*divV     at every cell
//   txx = c2mu * (gx - divV/3), tyy, tzz alike      (c2mu = 2.0*mu)
//   txy = mu * ((Vx[J] - Vx[J-1])/dy + (Vy[I] - Vy[I-1])/dx)  interior edges
//   txz = mu * ((Vx[K] - Vx[K-1])/dz + (Vz[I] - Vz[I-1])/dx)
//   tyz = mu * ((Vy[K] - Vy[K-1])/dz + (Vz[J] - Vz[J-1])/dy)
//   rx = (((txx[I] - txx[I-1])/dx + (txy[J+1] - txy[J])/dy)
//         + (txz[K+1] - txz[K])/dz) - (P'[I] - P'[I-1])/dx,  ry, rz alike,
//   rz = rz + 0.5*(Rho[K] + Rho[K-1])
//   V' = V + dtV*r on each velocity's interior faces, V + 0 elsewhere.
// Each coefficient is rounded once to T; every operation is written out in
// the order of the plain version, built with -fmad=false and without fast
// math, so each one rounds like the plain PyTorch version (divisions IEEE).
// A quotient the plain version forms twice from the same operands (gx in
// divV and in txx) is formed once: the same operands give the same bits.
//
// `cells` computes a run of VEC cells along z: the VEC+1 cells k-1 .. k+VEC-1
// of its own row, the VEC cells of the rows at x-1 and y-1 (whose normal
// stresses and pressures the face residuals read), the shear stresses of
// its edges, each of them once: 38*VEC + 8 divisions a run.  Loads outside
// the block are skipped (their values are zeros, used by no interior face),
// so every read stays inside the block; all divisions are by the spacings
// or by 3, so the zeros are harmless.
#pragma once

#include "stagger_walk3_first.cuh"

namespace igg {

template <typename Real>
struct Stokes {
  using T = Real;
  static constexpr int NF = 4;
  const T* src[4];  // P, Vx, Vy, Vz
  const T* rho;     // Rho, laid out like P
  T dx, dy, dz, mu, c2mu, dtP, dtV;

  // Vx is staggered along dim 0, Vy along 1, Vz along 2.
  __host__ __device__ static constexpr int st(int f, int d) {
    return f == d + 1 ? 1 : 0;
  }
  // On open dims the velocities freeze; the pressure does not.
  __host__ __device__ static constexpr bool freezes(int f, int) {
    return f >= 1;
  }

  // x / d, an IEEE division: every division of the update is by a spacing
  // or by 3.
  __device__ __forceinline__ T quot(T x, T d) const { return x / d; }

  // (a - b) / d, the difference quotient, each operation rounded.
  __device__ __forceinline__ T dq(T a, T b, T d) const {
    return quot(a - b, d);
  }

  // p[0 .. N-1] from the N elements at q, VEC of them from q + lead (one
  // vector load where aligned), the others one by one; elements whose flag
  // is off are zero.
  template <int VEC, int N>
  __device__ __forceinline__ static void span(const T* q, int lead, bool lo,
                                              bool hi, T* p) {
#pragma unroll
    for (int m = 0; m < N; ++m) p[m] = T(0);
    load_run<T, VEC>(q + lead, p + lead);
    if (lead == 1 && lo) p[0] = ld(q);
    if (N > lead + VEC && hi) p[N - 1] = ld(q + N - 1);
  }

  template <int VEC>
  __device__ __forceinline__ void cells(const Stag3& g, int i, int j, int k,
                                        const long long* at,
                                        const long long* sx,
                                        const long long* sy,
                                        T (*out)[VEC]) const {
    constexpr int W = VEC + 1;  // cells k-1 .. k+VEC-1, index m+1 <-> k+m
    const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
    const bool rvx = i >= 1 && i <= s0 - 1 && j >= 1 && j <= s1 - 2;
    const bool rvy = i >= 1 && i <= s0 - 2 && j >= 1 && j <= s1 - 1;
    const bool rvz = i >= 1 && i <= s0 - 2 && j >= 1 && j <= s1 - 2;
    const bool zlo = k >= 1, zhi = k + VEC <= s2 - 1;
    const T* P = src[0] + at[0];
    const T* X = src[1] + at[1];
    const T* Y = src[2] + at[2];
    const T* Z = src[3] + at[3];
    const T* R = rho + at[0];
    const long long px = sx[0], py = sy[0], xx = sx[1], xy = sy[1];
    const long long yx = sx[2], yy = sy[2], zx = sx[3], zy = sy[3];

    // The cells k-1 .. k+VEC-1 of the row (i, j): pressure, quotients,
    // divergence, new pressure and normal stresses.
    T vx[W + 1], vx1[W], vy[W + 1], vy1[W], vz[W + 1], p[W], r[W];
    span<VEC, W + 1>(X - 1, 1, zlo, zhi, vx);
    span<VEC, W>(X + xx - 1, 1, zlo, false, vx1);
    span<VEC, W + 1>(Y - 1, 1, zlo, zhi, vy);
    span<VEC, W>(Y + yy - 1, 1, zlo, false, vy1);
    span<VEC, W + 1>(Z - 1, 1, zlo, true, vz);
    span<VEC, W>(P - 1, 1, zlo, false, p);
    span<VEC, W>(R - 1, 1, zlo, false, r);
    T gx[W], gy[W], d3[W], pn[W], tzz[W];
#pragma unroll
    for (int m = 0; m < W; ++m) {
      gx[m] = dq(vx1[m], vx[m], dx);
      gy[m] = dq(vy1[m], vy[m], dy);
      const T gz = dq(vz[m + 1], vz[m], dz);
      const T div = (gx[m] + gy[m]) + gz;
      pn[m] = p[m] - dtP * div;
      d3[m] = quot(div, T(3));
      tzz[m] = c2mu * (gz - d3[m]);
    }
#pragma unroll
    for (int m = 0; m < VEC; ++m) {
      out[0][m] = pn[m + 1];
      out[1][m] = vx[m + 1] + T(0);
      out[2][m] = vy[m + 1] + T(0);
      out[3][m] = vz[m + 1] + T(0);
    }
    if (!(rvx || rvy || rvz)) return;

    // The cells of the rows (i-1, j) and (i, j-1): their pressures and the
    // normal stress across the shared face.
    T xm[VEC], ym1[VEC], ym0[VEC], zm[VEC + 1], pxm[VEC];
    T xym[VEC], x1ym[VEC], yym[VEC], zym[VEC + 1], pym[VEC];
    load_run<T, VEC>(X - xx, xm);
    load_run<T, VEC>(Y - yx, ym0);
    load_run<T, VEC>(Y - yx + yy, ym1);
    span<VEC, VEC + 1>(Z - zx, 0, false, true, zm);
    load_run<T, VEC>(P - px, pxm);
    load_run<T, VEC>(X - xy, xym);
    load_run<T, VEC>(X + xx - xy, x1ym);
    load_run<T, VEC>(Y - yy, yym);
    span<VEC, VEC + 1>(Z - zy, 0, false, true, zym);
    load_run<T, VEC>(P - py, pym);
    T txx[VEC], txxm[VEC], tyy[VEC], tyym[VEC], pnxm[VEC], pnym[VEC];
#pragma unroll
    for (int m = 0; m < VEC; ++m) {
      txx[m] = c2mu * (gx[m + 1] - d3[m + 1]);
      tyy[m] = c2mu * (gy[m + 1] - d3[m + 1]);
      {  // cell (i-1, j, k+m)
        const T ax = dq(vx[m + 1], xm[m], dx);
        const T ay = dq(ym1[m], ym0[m], dy);
        const T az = dq(zm[m + 1], zm[m], dz);
        const T d = (ax + ay) + az;
        pnxm[m] = pxm[m] - dtP * d;
        txxm[m] = c2mu * (ax - quot(d, T(3)));
      }
      {  // cell (i, j-1, k+m)
        const T ax = dq(x1ym[m], xym[m], dx);
        const T ay = dq(vy[m + 1], yym[m], dy);
        const T az = dq(zym[m + 1], zym[m], dz);
        const T d = (ax + ay) + az;
        pnym[m] = pym[m] - dtP * d;
        tyym[m] = c2mu * (ay - quot(d, T(3)));
      }
    }

    // Shear stresses: txy at (i, j), txz at (i, j, k .. k+VEC), tyz alike.
    T txy[VEC], txz[W], tyz[W];
#pragma unroll
    for (int m = 0; m < VEC; ++m)
      txy[m] = mu * (dq(vx[m + 1], xym[m], dy) + dq(vy[m + 1], ym0[m], dx));
#pragma unroll
    for (int m = 0; m < W; ++m) {
      txz[m] = mu * (dq(vx[m + 1], vx[m], dz) + dq(vz[m + 1], zm[m], dx));
      tyz[m] = mu * (dq(vy[m + 1], vy[m], dz) + dq(vz[m + 1], zym[m], dy));
    }

    if (rvx) {  // Vx at face (i, j, k+m): also txy at (i, j+1)
      T xyp[VEC];
      load_run<T, VEC>(X + xy, xyp);
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        if (k + m < 1 || k + m > s2 - 2) continue;
        const T txyp =
            mu * (dq(xyp[m], vx[m + 1], dy) + dq(vy1[m + 1], ym1[m], dx));
        const T rx = ((dq(txx[m], txxm[m], dx) + dq(txyp, txy[m], dy)) +
                      dq(txz[m + 1], txz[m], dz)) -
                     dq(pn[m + 1], pnxm[m], dx);
        out[1][m] = vx[m + 1] + dtV * rx;
      }
    }
    if (rvy) {  // Vy at face (i, j, k+m): also txy at (i+1, j)
      T yxp[VEC];
      load_run<T, VEC>(Y + yx, yxp);
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        if (k + m < 1 || k + m > s2 - 2) continue;
        const T txyp =
            mu * (dq(vx1[m + 1], x1ym[m], dy) + dq(yxp[m], vy[m + 1], dx));
        const T ry = ((dq(tyy[m], tyym[m], dy) + dq(txyp, txy[m], dx)) +
                      dq(tyz[m + 1], tyz[m], dz)) -
                     dq(pn[m + 1], pnym[m], dy);
        out[2][m] = vy[m + 1] + dtV * ry;
      }
    }
    if (rvz) {  // Vz at face (i, j, k+m): txz at (i+1, j), tyz at (i, j+1)
      T zxp[VEC], zyp[VEC];
      load_run<T, VEC>(Z + zx, zxp);
      load_run<T, VEC>(Z + zy, zyp);
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        if (k + m < 1 || k + m > s2 - 1) continue;
        const T txzp =
            mu * (dq(vx1[m + 1], vx1[m], dz) + dq(zxp[m], vz[m + 1], dx));
        const T tyzp =
            mu * (dq(vy1[m + 1], vy1[m], dz) + dq(zyp[m], vz[m + 1], dy));
        T rz = ((dq(tzz[m + 1], tzz[m], dz) + dq(txzp, txz[m], dx)) +
                dq(tyzp, tyz[m], dy)) -
               dq(pn[m + 1], pn[m], dz);
        rz = rz + T(0.5) * (r[m + 1] + r[m]);
        out[3][m] = vz[m + 1] + dtV * rz;
      }
    }
  }
};

// Launch the walk with the Stokes policy on src (P, Vx, Vy, Vz) and the
// constant rho into out, with the chunk-entry buffers F (none for a step);
// coef: dx dy dz mu 2*mu dtP dtV, each rounded once to T; dtype: 0 float32,
// 1 float64.
// The policy on src (P, Vx, Vy, Vz) and rho; coef: dx dy dz mu 2*mu dtP
// dtV, each rounded once to T.
template <typename T>
Stokes<T> make_stokes(void* const* src, const void* rho, const double* coef) {
  return Stokes<T>{{static_cast<const T*>(src[0]),
                    static_cast<const T*>(src[1]),
                    static_cast<const T*>(src[2]),
                    static_cast<const T*>(src[3])},
                   static_cast<const T*>(rho),
                   (T)coef[0], (T)coef[1], (T)coef[2], (T)coef[3],
                   (T)coef[4], (T)coef[5], (T)coef[6]};
}

// The four fields' pointers, read-only (the chunk-entry buffers; none when
// F is null) or written (the targets).
template <typename T>
Fields<const T, 4> stokes_entry(void* const* F) {
  if (F == nullptr) return Fields<const T, 4>{};
  return Fields<const T, 4>{{static_cast<const T*>(F[0]),
                             static_cast<const T*>(F[1]),
                             static_cast<const T*>(F[2]),
                             static_cast<const T*>(F[3])}};
}
template <typename T>
Fields<T, 4> stokes_out(void* const* out) {
  return Fields<T, 4>{{static_cast<T*>(out[0]), static_cast<T*>(out[1]),
                       static_cast<T*>(out[2]), static_cast<T*>(out[3])}};
}

template <typename T>
int launch_stokes_as(void* const* src, const void* rho, void* const* F,
                     void* const* out, const Stag3& g, const double* coef,
                     cudaStream_t stream) {
  return launch_stagger3(make_stokes<T>(src, rho, coef), g,
                         stokes_entry<T>(F), stokes_out<T>(out), stream);
}

inline int launch_stokes(void* const* src, const void* rho, void* const* F,
                         void* const* out, int dtype, const Stag3& g,
                         const double* coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stokes_as<float>(src, rho, F, out, g, coef, st);
  if (dtype == 1)
    return launch_stokes_as<double>(src, rho, F, out, g, coef, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace igg
"""
HM3D_POLICY_FIRST = """// The HM3D physics of the step walk (step_walk.cuh): two fields, the
// effective pressure Pe (field 0) and the porosity phi (field 1), updated
// as igg.models.hm3d.step_core updates them:
//   k    = (phi/phi0)^npow                 (repeated multiplication)
//   kf   = 0.5*(k_hi + k_lo)               on each face
//   q    = (-kf * (Pe_hi - Pe_lo)) / d     Darcy flux
//   divq = ((dqx/dx + dqy/dy) + dqz/dz)
//   Pe'  = Pe + dt*(-divq - (Pe*phi)/eta)
//   phi' = phi + dt*(((-phi*(1 - phi))*Pe')/eta)
// Pe' is rounded before phi's update uses it (the Gauss-Seidel coupling).
// Every operation is written out in the order of step_core and of the
// port's plain version; built with -fmad=false and without fast math, so
// each one rounds like the plain PyTorch version (divisions IEEE).
#pragma once

#include "step_walk.cuh"

namespace igg {

template <typename Real>
struct Hm3d {
  using T = Real;
  static constexpr int NF = 2;
  const T* src[2];  // Pe, phi
  T dx, dy, dz, dt, phi0, eta;
  int npow;         // >= 0

  bool aligned(uintptr_t bytes) const {
    return igg::aligned(src[0], bytes) && igg::aligned(src[1], bytes);
  }

  // (phi/phi0)^npow by repeated squaring, the order of XLA's integer_pow:
  // acc takes x at each set bit of npow from the lowest, x squares between.
  __device__ __forceinline__ T perm(T phi) const {
    T x = phi / phi0;
    if (npow == 0) return T(1);
    T acc = x;
    bool have = false;
    for (int y = npow; y > 0;) {
      if (y & 1) {
        acc = have ? acc * x : x;
        have = true;
      }
      y >>= 1;
      if (y > 0) x = x * x;
    }
    return acc;
  }

  // Darcy flux through the face between cells lo and hi along a dim of
  // spacing d.
  __device__ __forceinline__ T flux(T klo, T khi, T plo, T phi_, T d) const {
    const T kf = T(0.5) * (khi + klo);
    return (-kf * (phi_ - plo)) / d;
  }

  // Pe' and phi' of one cell from its centre values and six face fluxes.
  __device__ __forceinline__ void cell(T pe, T ph, T qxl, T qxh, T qyl, T qyh,
                                       T qzl, T qzh, T& pe_out,
                                       T& ph_out) const {
    T divq = (qxh - qxl) / dx;
    divq = divq + (qyh - qyl) / dy;
    divq = divq + (qzh - qzl) / dz;
    const T dpe = dt * (-divq - (pe * ph) / eta);
    const T pe_new = pe + dpe;
    const T dph = dt * (((-ph * (T(1) - ph)) * pe_new) / eta);
    pe_out = pe_new;
    ph_out = ph + dph;
  }

  template <int VEC>
  __device__ __forceinline__ void update(long long row, int z0, long long sx,
                                         int G2, Cells<T, 2, VEC>& out) const {
    using V = Vec<T, VEC>;
    const T* P = src[0] + row;
    const T* F = src[1] + row;
    const V pc = load<T, VEC>(P + z0), fc = load<T, VEC>(F + z0);
    const V pxm = load<T, VEC>(P - sx + z0), fxm = load<T, VEC>(F - sx + z0);
    const V pxp = load<T, VEC>(P + sx + z0), fxp = load<T, VEC>(F + sx + z0);
    const V pym = load<T, VEC>(P - G2 + z0), fym = load<T, VEC>(F - G2 + z0);
    const V pyp = load<T, VEC>(P + G2 + z0), fyp = load<T, VEC>(F + G2 + z0);
    // The z line of the vector and its two neighbours, and its VEC + 1 z
    // faces (each face's flux serves the two cells beside it, as one
    // element of step_core's qz serves two cells).
    T pz[VEC + 2], kz[VEC + 2];
    pz[0] = z0 > 0 ? ld(P + z0 - 1) : T(0);
    kz[0] = perm(z0 > 0 ? ld(F + z0 - 1) : T(0));
    pz[VEC + 1] = z0 + VEC < G2 ? ld(P + z0 + VEC) : T(0);
    kz[VEC + 1] = perm(z0 + VEC < G2 ? ld(F + z0 + VEC) : T(0));
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      pz[v + 1] = pc.v[v];
      kz[v + 1] = perm(fc.v[v]);
    }
    T qz[VEC + 1];
#pragma unroll
    for (int i = 0; i <= VEC; ++i)
      qz[i] = flux(kz[i], kz[i + 1], pz[i], pz[i + 1], dz);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const T kc = kz[v + 1], p = pc.v[v];
      cell(p, fc.v[v], flux(perm(fxm.v[v]), kc, pxm.v[v], p, dx),
           flux(kc, perm(fxp.v[v]), p, pxp.v[v], dx),
           flux(perm(fym.v[v]), kc, pym.v[v], p, dy),
           flux(kc, perm(fyp.v[v]), p, pyp.v[v], dy), qz[v], qz[v + 1],
           out.f[0].v[v], out.f[1].v[v]);
    }
  }
};

// coef: dx dy dz dt phi0 eta, each rounded once to T.
template <typename T>
Hm3d<T> make_hm3d(const void* Pe, const void* phi, const double* coef,
                  int npow) {
  return Hm3d<T>{{static_cast<const T*>(Pe), static_cast<const T*>(phi)},
                 (T)coef[0], (T)coef[1], (T)coef[2], (T)coef[3],
                 (T)coef[4], (T)coef[5], npow};
}

}  // namespace igg
"""
# The staggered 3-D walk (csrc/stagger_walk3.cuh's kernel before the
# marches): the first design of the generated rank-3 step and chunk entry
# (spec_first_source) and the walk that stokes.cuh's `cells` ran on (the
# Stokes step's and chunk step's first designs).
STAGGER_WALK3_FIRST = """// The walk of a step over STAGGERED 3-D fields of a block-stacked grid,
// the first design of the kernels generated for a rank-3 igg_torch.stencil
// spec (igg_spec_step; they left it for the x-march of
// stagger_band_march3.cuh, its step and chunk modes) and of the stokes3d
// step and chunk kernels (stokes.cuh's `cells` of the first designs; they
// left it for stokes_step.cu's and stokes_march.cuh's x-marches): one
// launch writes every cell of every field of a policy P from the source
// tensors alone, into targets that are the whole blocks (a step, or a
// chunk step on extended buffers) or a window of each block (the last step
// of a chunk).  The 3-D sibling of stagger_walk.cuh: it adds a third dim
// and wraps on y and z; its layout (Stag3, make_stag3, at3, frozen3) is
// csrc/stagger_walk3.cuh's.
//
// The policy (generated, or the first designs' stokes.cuh, kept in
// kernel_variants.py) provides:
//   - `using T`, `static constexpr int NF` (<= MAXF): element type, fields;
//   - `st(f, d)` (constexpr): 1 where field f is one cell longer along d
//     than the base (unstaggered) block, else 0;
//   - `freezes(f, d)` (constexpr): whether field f re-freezes on dim d
//     where a chunk's open dim freezes;
//   - `const T* src[NF]`: the source fields;
//   - `cells<VEC>(g, i, j, k, at, sx, sy, out)`: the updated values of every
//     field at the VEC cells (i, j, k .. k+VEC-1) of a source block, all of
//     which lie inside the base block, given each field's offset of cell
//     (i, j, k) in its source tensor (`at`) and its x and y strides.
//
// Layout: field f is a C-ordered (n0*(e0+st(f,0)), n1*(e1+st(f,1)),
// n2*(e2+st(f,2))) tensor of n0 x n1 x n2 blocks, where (e0, e1, e2) is the
// base block of the sources (s) or of the targets (o); dim 2 is contiguous.
// Offsets are 64-bit.
//
// A thread takes VEC cells (i, j, k .. k+VEC-1) of a block's bounding box
// (o0+1) x (o1+1) x (o2+1) and writes the fields that have them, computing
// them at source index (i + off0, j + off1, k + off2); the thread whose run
// reaches o2 also takes the face row k = o2, which only the z-staggered
// field has.  Per dim:
//   - where y or z is one periodic block (`wrap`), each field's edges 0 and
//     size-1 take the updated values at the inner cells they alias,
//     size-ol and ol-1, with the field's own overlap ol (the staggered
//     self-wrap of chunk_engine.wrap_edges, y then z): fields whose aliases
//     agree are computed together, the others on their own;
//   - where a dim freezes (`frz`, a chunk's open dims), the fields that
//     freeze on it take the chunk-entry values F on the blocks of the global
//     edges: rows <= lo on the first block, rows >= hi + st(f, d) on the
//     last (each field's own staggered high plane).  The freeze wins the
//     cells it shares with a wrap (chunk_engine.window_step_plain).
// A cell outside the base block (a staggered field's outer face row) keeps
// its source value (+0): no update reaches an outer face.  Threads run along
// z, so every access is coalesced.
#pragma once

#include "stagger_walk3.cuh"

namespace igg {

// Source offsets and x/y strides of cell (si, sj, sk) of block b in every
// field.
template <class P>
__device__ __forceinline__ void source_at(const Stag3& g, const int* b,
                                          int si, int sj, int sk,
                                          long long* at, long long* sx,
                                          long long* sy) {
#pragma unroll
  for (int f = 0; f < P::NF; ++f) {
    at[f] = at3(g.s, g.n, P::st(f, 0), P::st(f, 1), P::st(f, 2), b[0], si,
                b[1], sj, b[2], sk);
    sy[f] = (long long)g.n[2] * (g.s[2] + P::st(f, 2));
    sx[f] = (long long)g.n[1] * (g.s[1] + P::st(f, 1)) * sy[f];
  }
}

// One cell (i, j, k) of the bounding box of block b: every field that has
// it, resolved through the per-field wrap aliases, then frozen.
template <class P>
__device__ __forceinline__ void walk_cell3(
    const P& ph, const Stag3& g, const int* b, int i, int j, int k,
    const Fields<const typename P::T, P::NF>& F,
    const Fields<typename P::T, P::NF>& out) {
  using T = typename P::T;
  constexpr int NF = P::NF;
  const int c[3] = {i + g.off[0], j + g.off[1], k + g.off[2]};
  bool want[NF], done[NF];
  int jf[NF], kf[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    want[f] = i < g.o[0] + P::st(f, 0) && j < g.o[1] + P::st(f, 1) &&
              k < g.o[2] + P::st(f, 2);
    done[f] = !want[f];
    jf[f] = g.wrap[1] ? wrap_alias(c[1], g.s[1] + P::st(f, 1), g.ol[f][1])
                      : c[1];
    kf[f] = g.wrap[2] ? wrap_alias(c[2], g.s[2] + P::st(f, 2), g.ol[f][2])
                      : c[2];
  }
  T v[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (done[f]) continue;
    bool w[NF];
#pragma unroll
    for (int h = 0; h < NF; ++h)
      w[h] = !done[h] && jf[h] == jf[f] && kf[h] == kf[f];
    long long at[NF], sx[NF], sy[NF];
    source_at<P>(g, b, c[0], jf[f], kf[f], at, sx, sy);
    T got[NF][1];
    if (c[0] < g.s[0] && jf[f] < g.s[1] && kf[f] < g.s[2]) {
      ph.template cells<1>(g, c[0], jf[f], kf[f], at, sx, sy, got);
    } else {
      // An outer face row of the staggered fields: no update reaches it.
#pragma unroll
      for (int h = 0; h < NF; ++h)
        if (w[h]) got[h][0] = ld(ph.src[h] + at[h]) + T(0);
    }
#pragma unroll
    for (int h = 0; h < NF; ++h)
      if (w[h]) {
        v[h] = got[h][0];
        done[h] = true;
      }
  }
  long long at[NF], sx[NF], sy[NF];
  source_at<P>(g, b, c[0], c[1], c[2], at, sx, sy);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (!want[f]) continue;
    if (frozen3<P>(g, f, b, c)) v[f] = ld(F.p[f] + at[f]);
    out.p[f][at3(g.o, g.n, P::st(f, 0), P::st(f, 1), P::st(f, 2), b[0], i,
                 b[1], j, b[2], k)] = v[f];
  }
}

// Block (32, 8): a warp takes 32 runs of VEC cells of one z row, the 8
// warps 8 rows along y.  Grid: x = the z tiles of every block along dim 2,
// y = the y tiles of every block along dim 1, z = the x rows of every block
// along dim 0 (so a thread finds its block and cells with a few divisions
// per thread block).  A run whose VEC cells lie in the base block and on
// no wrap alias takes the policy's `cells<VEC>`, with vector loads and
// stores where the rows allow them; the others go cell by cell.
template <class P, int VEC>
__global__ void __launch_bounds__(256)
    stagger_xyz_kernel(P ph, Stag3 g, Fields<const typename P::T, P::NF> F,
                    Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  constexpr int NF = P::NF;
  const int h0 = g.o[0] + 1, h1 = g.o[1] + 1, h2 = g.o[2] + 1;
  const int tz = (g.o[2] + 32 * VEC - 1) / (32 * VEC);
  const int ty = (h1 + 7) / 8;
  const int b[3] = {(int)blockIdx.z / h0, (int)blockIdx.y / ty,
                    (int)blockIdx.x / tz};
  const int i = blockIdx.z - b[0] * h0;
  const int j = (blockIdx.y - b[1] * ty) * 8 + threadIdx.y;
  const int k0 = (blockIdx.x - b[2] * tz) * 32 * VEC + threadIdx.x * VEC;
  if (k0 >= g.o[2] || j >= h1) return;
  // The run that reaches o2 also takes the face row k = o2.
  const int kend = k0 + VEC >= g.o[2] ? h2 : k0 + VEC;
  int k = k0;
  const int c[3] = {i + g.off[0], j + g.off[1], k0 + g.off[2]};
  if (i < g.o[0] && j < g.o[1] && k0 + VEC <= g.o[2] &&
      (!g.wrap[1] || (c[1] >= 1 && c[1] <= g.s[1] - 2)) &&
      (!g.wrap[2] || (c[2] >= 1 && c[2] + VEC <= g.s[2] - 1))) {
    long long at[NF], sx[NF], sy[NF];
    source_at<P>(g, b, c[0], c[1], c[2], at, sx, sy);
    T v[NF][VEC];
    ph.template cells<VEC>(g, c[0], c[1], c[2], at, sx, sy, v);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        const int cm[3] = {c[0], c[1], c[2] + m};
        if (frozen3<P>(g, f, b, cm)) v[f][m] = ld(F.p[f] + at[f] + m);
      }
      store_run<T, VEC>(out.p[f] + at3(g.o, g.n, P::st(f, 0), P::st(f, 1),
                                       P::st(f, 2), b[0], i, b[1], j, b[2],
                                       k0),
                        v[f]);
    }
    k = k0 + VEC;
  }
  for (; k < kend; ++k) walk_cell3(ph, g, b, i, j, k, F, out);
}

template <class P, int VEC>
int launch_stagger3_vec(const P& ph, const Stag3& g,
                        const Fields<const typename P::T, P::NF>& F,
                        const Fields<typename P::T, P::NF>& out,
                        cudaStream_t stream) {
  const long long tz = (g.o[2] + 32 * VEC - 1) / (32 * VEC);
  const long long gx = tz * g.n[2], gy = (long long)(g.o[1] + 8) / 8 * g.n[1];
  const long long gz = (long long)(g.o[0] + 1) * g.n[0];
  if (gx > 0x7fffffffLL || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(32, 8);
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  stagger_xyz_kernel<P, VEC><<<grid, block, 0, stream>>>(ph, g, F, out);
  return (int)cudaGetLastError();
}

// Runs of 8 bytes (2 cells in f32, 1 in f64): the Stokes policy holds
// some 25 values a cell, so a run of 16 bytes took 180 registers a thread
// and one thread block an SM, and ran 1.5 times (one 256^3 block) to 2
// times (8 extended blocks of 288^3) as long on an H100
// (kernel_variants.py).
template <class P>
int launch_stagger3(const P& ph, const Stag3& g,
                    const Fields<const typename P::T, P::NF>& F,
                    const Fields<typename P::T, P::NF>& out,
                    cudaStream_t stream) {
  static_assert(P::NF <= MAXF, "more fields than the walk takes");
  return launch_stagger3_vec<P, 8 / sizeof(typename P::T)>(ph, g, F, out,
                                                           stream);
}

}  // namespace igg
"""
# The staggered band walk (the first designs of the Stokes band kernel and
# of the generated rank-3 band entry), and that entry's launch on it: the
# band section of a generated source before the march
# (spec_band_first_source).
STAGGER_BAND_WALK3_FIRST = """// One iteration of the streaming banded K-step chunk over STAGGERED 3-D
// fields, the walk of the first designs of the Stokes band kernel and of
// the band entry generated for a rank-3 igg_torch.stencil spec (both left
// it for x-marches: the Stokes march's band mode, stokes_march.cuh, and
// stagger_band_march3.cuh): one launch
// advances every extended block of block-stacked EXTENDED buffers by one
// iteration of every field of a policy P of the 3-D staggered walk
// (stagger_walk3.cuh), sweeping each block in x-row bands of depth B (the
// function of igg/ops/chunk_engine.py: _streaming_kernel and of its plain
// version, igg_torch/ops/chunk_engine.py: banded_window_plain).
// band_walk.cuh's design carried to fields of their own shapes.
//
// The policy adds to the staggered walk's interface:
//   - `NS`, `staged(k)`, `restage(k, p)`: the arrays the walk stages (the
//     NF fields, then constant arrays laid out like field 0, which the
//     policy reads at field 0's offsets) and a way to point them elsewhere;
//   - `RADIUS`: the largest index offset, along any dim, of any value its
//     `cells` reads (1 for Stokes).
//
// A thread block takes one band (rows [a, a+B) of the base x extent of one
// extended block) over a BAND_TY x BAND_TZ tile of y/z cells.  It stages, in
// shared memory, rows [a - lo, a + B + extra[k]) of each staged array k over
// the tile plus RADIUS plus the array's own stagger, clamped to the BLOCK's
// first and last rows of that array (igg's rolling window of one device's
// buffer: a field one row longer in x is clamped at its own last row) and,
// in y and z, to the array's extents (values never read).  Each thread then
// computes its cell of every field in the B rows with the policy's own
// `cells<1>`, run on the staged windows: the policy sees the band's window
// as its block along x (row lo + r of a window of lo + B + lo base rows, the
// realization's band core applied to the window) and the block itself along
// y and z, so its interior tests are those of the plain band core.
//
// The band halo is resolved per field in the order of chunk_engine.band_halo
// (later dims win): z first, then y at the z-resolved cell, then x:
//   - a WRAP dim's edge cells of field f (0 and its own size - 1) take the
//     value of the inner cell they alias (size - ol, ol - 1, f's own
//     overlap) as resolved so far;
//   - an open dim's rows == lo and == hi + st(f, d) on the edge blocks take
//     the chunk-entry values F of the fields that freeze on that dim
//     (exactly those rows, not the shoulders beyond them).
// A wrap alias lies in another tile, computed by another thread block in the
// same launch: its update is recomputed here from the source buffers, on a
// (2 RADIUS + 1)^3 copy of its neighbourhood clamped the same way, never
// read from the destination.  Cells outside the base block (a staggered
// field's outer face rows along y and z) take no update: their source value
// plus an exact +0, as the 3-D walk writes them.  The rows beyond the base
// x extent (an x-staggered field's last row, which no band covers) keep
// their source values, so every launch writes every cell of its targets.
// A thread whose cell is a block's last y (z) row also takes the face row
// at y = s1 (z = s2) of the fields staggered along y (z).
//
// The last launch of a chunk writes only each block's central window,
// straight into the unextended outputs (the walk's target window).
#pragma once

#include "band_walk.cuh"
#include "stagger_walk3.cuh"

namespace igg {

struct StagBand {
  Stag3 g;           // make_stag3's layout: extended base block, targets
  int B;             // band depth (rows of a band)
  int lo;            // rows read below a band
  int extra[MAXF];   // rows each staged array reads above a band
  int tiles[3];      // bands per block along x, tiles per block along y, z
};

// Stagger of staged array k along d: a field's own, or field 0's for a
// constant array.
template <class P>
__host__ __device__ constexpr int sst(int k, int d) {
  return k < P::NF ? P::st(k, d) : P::st(0, d);
}

// cfg: the layout of make_stag3 (24 + 3 * MAXF ints), then B, lo and
// extra[MAXF].  Returns false where the layout does not suit the walk: the
// band depth does not divide the base x extent, or a read margin is below
// the window the policy's x tests assume (extra >= lo + stagger).
template <class P>
inline bool make_stag_band(const int* cfg, StagBand& b) {
  if (!make_stag3(cfg, b.g)) return false;
  constexpr int at = 24 + 3 * MAXF;
  b.B = cfg[at];
  b.lo = cfg[at + 1];
  for (int k = 0; k < MAXF; ++k) b.extra[k] = cfg[at + 2 + k];
  const Stag3& g = b.g;
  if (b.B < 1 || g.s[0] % b.B != 0 || b.lo < P::RADIUS) return false;
  for (int k = 0; k < P::NS; ++k)
    if (b.extra[k] < b.lo + sst<P>(k, 0)) return false;
  b.tiles[0] = g.s[0] / b.B;
  b.tiles[1] = (g.s[1] + BAND_TY - 1) / BAND_TY;
  b.tiles[2] = (g.s[2] + BAND_TZ - 1) / BAND_TZ;
  return true;
}

// The y and z extents of staged array k's window.
template <class P>
__host__ __device__ constexpr int band_wy(int k) {
  return BAND_TY + 2 * P::RADIUS + sst<P>(k, 1);
}
template <class P>
__host__ __device__ constexpr int band_wz(int k) {
  return BAND_TZ + 2 * P::RADIUS + sst<P>(k, 2);
}

// Bytes of shared memory one thread block stages (igg_torch/ops/_smem.py:
// banded_smem).
template <class P>
inline long long stag_band_smem_bytes(const StagBand& b) {
  long long n = 0;
  for (int k = 0; k < P::NS; ++k)
    n += (long long)(b.lo + b.B + b.extra[k]) * band_wy<P>(k) * band_wz<P>(k);
  return n * (long long)sizeof(typename P::T);
}

// Whether row c of block bl along d is field f's exact freeze row there.
template <class P>
__device__ __forceinline__ bool band_row_frozen(const Stag3& g, int f, int d,
                                                int bl, int c) {
  return P::freezes(f, d) && g.frz[d] &&
         ((bl == 0 && c == g.lo[d]) ||
          (bl == g.n[d] - 1 && c == g.hi[d] + P::st(f, d)));
}

// Stacked offset of cell (x, y, z) of block b in staged array k's source.
template <class P>
__device__ __forceinline__ long long band_src_at(const Stag3& g, int k,
                                                 const int* b, int x, int y,
                                                 int z) {
  return at3(g.s, g.n, sst<P>(k, 0), sst<P>(k, 1), sst<P>(k, 2), b[0], x,
             b[1], y, b[2], z);
}

// The update of every field at cell (x, y, z), interior to the base block,
// of block b, recomputed from the source buffers alone: the policy run on
// a (2 RADIUS + 1)^3 copy of each staged array's neighbourhood, rows
// clamped to the block's, at window row i of the window layout gw.
template <class P>
__device__ __noinline__ void band_recompute(const P& ph, const Stag3& gw,
                                            const Stag3& g, const int* b,
                                            int x, int i, int y, int z,
                                            typename P::T* res) {
  using T = typename P::T;
  constexpr int NF = P::NF, NS = P::NS, R = P::RADIUS, W = 2 * R + 1;
  T nb[NS][W * W * W];
  P loc = ph;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const T* p = ph.staged(k);
    const int e0 = g.s[0] + sst<P>(k, 0) - 1, e1 = g.s[1] + sst<P>(k, 1) - 1,
              e2 = g.s[2] + sst<P>(k, 2) - 1;
    for (int u = 0; u < W; ++u)
      for (int v = 0; v < W; ++v)
        for (int w = 0; w < W; ++w)
          nb[k][(u * W + v) * W + w] = ld(
              p + band_src_at<P>(g, k, b, clampi(x - R + u, 0, e0),
                                 clampi(y - R + v, 0, e1),
                                 clampi(z - R + w, 0, e2)));
    loc.restage(k, nb[k]);
  }
  long long at[NF], sx[NF], sy[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    at[f] = (long long)R * (W * W + W + 1);
    sx[f] = W * W;
    sy[f] = W;
  }
  T got[NF][1];
  loc.template cells<1>(gw, i, y, z, at, sx, sy, got);
#pragma unroll
  for (int f = 0; f < NF; ++f) res[f] = got[f][0];
}

// Window and target geometry of one thread: its block, band and tile.
struct BandAt {
  int b[3];    // the extended block
  int a;       // the band's first row
  int y0, z0;  // the tile's first y and z cells
  int y, z;    // the thread's own cell of the base block
};

// Write field f's value v at cell (x, y, z) of block p.b of the targets
// (the whole extended blocks, or each block's central window), if the
// target holds it.
template <class P>
__device__ __forceinline__ void band_store(
    const Stag3& g, const BandAt& p, int f, int x, int y, int z,
    typename P::T v, const Fields<typename P::T, P::NF>& out) {
  const int t0 = x - g.off[0], t1 = y - g.off[1], t2 = z - g.off[2];
  if (t0 < 0 || t0 >= g.o[0] + P::st(f, 0) || t1 < 0 ||
      t1 >= g.o[1] + P::st(f, 1) || t2 < 0 || t2 >= g.o[2] + P::st(f, 2))
    return;
  out.p[f][at3(g.o, g.n, P::st(f, 0), P::st(f, 1), P::st(f, 2), p.b[0], t0,
               p.b[1], t1, p.b[2], t2)] = v;
}

// Every field's cell (x, yv, zv) of band row r (x = a + r), for the fields
// that have it: the band halo resolved per field (header), the updates at
// the thread's own cell taken from the staged windows, the others
// recomputed from the sources, fields of one resolved cell together.
template <class P>
__device__ __forceinline__ void band_cells(
    const P& ph, const P& sm, const Stag3& gw, const StagBand& bd,
    const BandAt& p, int r, int yv, int zv,
    const Fields<const typename P::T, P::NF>& F,
    const Fields<typename P::T, P::NF>& out) {
  using T = typename P::T;
  constexpr int NF = P::NF, R = P::RADIUS;
  const Stag3& g = bd.g;
  const int x = p.a + r, s1 = g.s[1], s2 = g.s[2];
  int ty[NF], tz[NF];
  bool want[NF], done[NF];
  T v[NF];
  bool own = false;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n1 = s1 + P::st(f, 1), n2 = s2 + P::st(f, 2);
    want[f] = yv < n1 && zv < n2;
    done[f] = !want[f];
    int yy = yv, zz = zv;
    bool frozen = false;
    if (g.wrap[2] && (zv == 0 || zv == n2 - 1))
      zz = wrap_alias(zv, n2, g.ol[f][2]);
    else
      frozen = band_row_frozen<P>(g, f, 2, p.b[2], zv);
    if (!frozen) {
      if (g.wrap[1] && (yv == 0 || yv == n1 - 1))
        yy = wrap_alias(yv, n1, g.ol[f][1]);
      else
        frozen = band_row_frozen<P>(g, f, 1, p.b[1], yv);
    }
    if (!frozen) frozen = band_row_frozen<P>(g, f, 0, p.b[0], x);
    ty[f] = yy;
    tz[f] = zz;
    if (done[f]) continue;
    if (frozen) {
      v[f] = ld(F.p[f] + band_src_at<P>(g, f, p.b, x, yy, zz));
      done[f] = true;
    } else if (yy >= s1 || zz >= s2) {  // an outer face: no update
      v[f] = ld(ph.src[f] + band_src_at<P>(g, f, p.b, x, yy, zz)) + T(0);
      done[f] = true;
    } else {
      own = own || (yy == p.y && zz == p.z);
    }
  }
  if (own) {
    long long at[NF], sx[NF], sy[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      sy[f] = band_wz<P>(f);
      sx[f] = (long long)band_wy<P>(f) * sy[f];
      at[f] = (long long)(bd.lo + r) * sx[f] + (p.y - p.y0 + R) * sy[f] +
              (p.z - p.z0 + R);
    }
    T got[NF][1];
    sm.template cells<1>(gw, bd.lo + r, p.y, p.z, at, sx, sy, got);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (!done[f] && ty[f] == p.y && tz[f] == p.z) {
        v[f] = got[f][0];
        done[f] = true;
      }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (done[f]) continue;
    T got[NF];
    band_recompute(ph, gw, g, p.b, x, bd.lo + r, ty[f], tz[f], got);
#pragma unroll
    for (int h = 0; h < NF; ++h)
      if (!done[h] && ty[h] == ty[f] && tz[h] == tz[f]) {
        v[h] = got[h];
        done[h] = true;
      }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    if (want[f]) band_store<P>(g, p, f, x, yv, zv, v[f], out);
}

// The rows beyond the base x extent (an x-staggered field's last row) at
// (yv, zv): their source values.
template <class P>
__device__ __forceinline__ void band_tail(
    const P& ph, const Stag3& g, const BandAt& p, int yv, int zv,
    const Fields<typename P::T, P::NF>& out) {
#pragma unroll
  for (int f = 0; f < P::NF; ++f) {
    if (!P::st(f, 0) || yv >= g.s[1] + P::st(f, 1) ||
        zv >= g.s[2] + P::st(f, 2))
      continue;
    const int x = g.s[0];
    band_store<P>(g, p, f, x, yv, zv,
                  ld(ph.src[f] + band_src_at<P>(g, f, p.b, x, yv, zv)), out);
  }
}

// Two thread blocks an SM in float32, where the windows allow it (Stokes:
// 71 KB each): the register bound that takes (128 a thread, from 156) made
// the Stokes band kernel 1.53 times as fast on an H100
// (kernel_variants.py: band_bounds_1).  A float64 window of Stokes (142
// KB) leaves room for one, so float64 keeps its registers.
template <class P>
__global__ void __launch_bounds__(BAND_TY * BAND_TZ,
                                  8 / sizeof(typename P::T))
    stag_band_kernel(P ph, StagBand bd, Fields<const typename P::T, P::NF> F,
                     Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  constexpr int NS = P::NS, R = P::RADIUS;
  extern __shared__ __align__(16) unsigned char stag_band_smem[];
  const Stag3& g = bd.g;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
  BandAt p;
  p.b[0] = blockIdx.z / bd.tiles[0];
  p.b[1] = blockIdx.y / bd.tiles[1];
  p.b[2] = blockIdx.x / bd.tiles[2];
  p.a = (blockIdx.z % bd.tiles[0]) * bd.B;
  p.y0 = (blockIdx.y % bd.tiles[1]) * BAND_TY;
  p.z0 = (blockIdx.x % bd.tiles[2]) * BAND_TZ;
  p.y = p.y0 + threadIdx.y;
  p.z = p.z0 + threadIdx.x;

  // Stage each array's window: rows [a - lo, a + B + extra[k]) over the
  // tile, its radius and its stagger, clamped to the block; the threads
  // take consecutive elements, so a warp's loads run along z.
  T* win[NS];
  T* next = reinterpret_cast<T*>(stag_band_smem);
  const int tid = threadIdx.y * BAND_TZ + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int wy = band_wy<P>(k), wz = band_wz<P>(k), plane = wy * wz;
    const int n = (bd.lo + bd.B + bd.extra[k]) * plane;
    const int e0 = s0 + sst<P>(k, 0) - 1, e1 = s1 + sst<P>(k, 1) - 1,
              e2 = s2 + sst<P>(k, 2) - 1;
    const T* src = ph.staged(k);
    win[k] = next;
    next += n;
    for (int e = tid; e < n; e += BAND_TY * BAND_TZ) {
      const int j = e / plane, q = e - j * plane;
      win[k][e] = ld(src + band_src_at<P>(
                               g, k, p.b, clampi(p.a - bd.lo + j, 0, e0),
                               clampi(p.y0 - R + q / wz, 0, e1),
                               clampi(p.z0 - R + q % wz, 0, e2)));
    }
  }
  __syncthreads();

  if (p.y >= s1 || p.z >= s2) return;
  P sm = ph;
#pragma unroll
  for (int k = 0; k < NS; ++k) sm.restage(k, win[k]);
  // The policy's view: the band's window along x, the block along y, z.
  Stag3 gw = g;
  gw.s[0] = 2 * bd.lo + bd.B;
  const bool ylast = p.y == s1 - 1, zlast = p.z == s2 - 1;
  for (int r = 0; r < bd.B; ++r) {
    band_cells(ph, sm, gw, bd, p, r, p.y, p.z, F, out);
    if (ylast) band_cells(ph, sm, gw, bd, p, r, s1, p.z, F, out);
    if (zlast) band_cells(ph, sm, gw, bd, p, r, p.y, s2, F, out);
    if (ylast && zlast) band_cells(ph, sm, gw, bd, p, r, s1, s2, F, out);
  }
  if (p.a + bd.B == s0) {
    band_tail(ph, g, p, p.y, p.z, out);
    if (ylast) band_tail(ph, g, p, s1, p.z, out);
    if (zlast) band_tail(ph, g, p, p.y, s2, out);
    if (ylast && zlast) band_tail(ph, g, p, s1, s2, out);
  }
}

// Launch one iteration: thread blocks of BAND_TZ x BAND_TY threads, one per
// band and tile; dynamic shared memory above 48 KB is opted into first.
template <class P>
int launch_stag_band(const P& ph, const StagBand& bd,
                     const Fields<const typename P::T, P::NF>& F,
                     const Fields<typename P::T, P::NF>& out,
                     cudaStream_t stream) {
  static_assert(P::NF <= MAXF && P::NS <= MAXF, "more arrays than the walk takes");
  const long long smem = stag_band_smem_bytes<P>(bd);
  if (smem > BAND_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Stag3& g = bd.g;
  const dim3 block(BAND_TZ, BAND_TY);
  const dim3 grid(g.n[2] * bd.tiles[2], g.n[1] * bd.tiles[1],
                  g.n[0] * bd.tiles[0]);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (smem > BAND_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        stag_band_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t bytes = (size_t)smem;
  stag_band_kernel<P><<<grid, block, bytes, stream>>>(ph, bd, F, out);
  return (int)cudaGetLastError();
}

}  // namespace igg
"""
SPEC_BAND_FIRST = """
namespace igg {{

template <typename T>
int launch_generated_band(void* const* src, void* const* entry,
                          void* const* out, const int* cfg,
                          const double* coef, cudaStream_t s) {{
  StagBand b;
  if (!make_stag_band<{name}<T>>(cfg, b)) return (int)cudaErrorInvalidValue;
  {name}<T> ph;
  Fields<const T, {nf}> fr;
  Fields<T, {nf}> o;
  for (int f = 0; f < {nf}; ++f) {{
    ph.src[f] = static_cast<const T*>(src[f]);
    fr.p[f] = static_cast<const T*>(entry[f]);
    o.p[f] = static_cast<T*>(out[f]);
  }}
  for (int k = 0; k < {nc}; ++k) ph.c[k] = (T)coef[k];
  return launch_stag_band(ph, b, fr, o, s);
}}

}}  // namespace igg

// One banded iteration: src, entry, out as above (entry: the chunk-entry
// buffers), cfg: the layout of igg::make_stag_band
// (igg_torch.ops.chunk_engine.stagger_band_cfg).
extern "C" int {entry}(void* const* src, void* const* entry,
                              void* const* out, int dtype, const int* cfg,
                              const double* coef, void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return igg::launch_generated_band<float>(src, entry, out, cfg, coef, s);
  if (dtype == 1)
    return igg::launch_generated_band<double>(src, entry, out, cfg, coef, s);
  return (int)cudaErrorInvalidValue;
}}
"""
FIRST_HEADERS = {"stokes.cuh": STOKES_POLICY_FIRST,
                 "hm3d.cuh": HM3D_POLICY_FIRST,
                 "stagger_band_walk3.cuh": STAGGER_BAND_WALK3_FIRST,
                 "stagger_walk3_first.cuh": STAGGER_WALK3_FIRST}


def spec_band_first_source(gen):
    """The source generated for a rank-3 spec (`gen`: its SpecKernels) with
    its band entry on the first design, the band walk
    (`stagger_band_walk3.cuh` of FIRST_HEADERS): the step entry and the
    policy as generated, the band section SPEC_BAND_FIRST's."""
    from igg_torch.stencil import cuda

    kw = dict(name=f"Spec_{gen.tag}", nf=len(gen.spec.fields),
              nc=len(gen.coef), entry=cuda.BAND_ENTRY)
    band = cuda._BAND_SOURCE.format(**kw)
    include = f'#include "{cuda.BAND_MARCH}"'
    if gen.source.count(band) != 1 or gen.source.count(include) != 1:
        raise RuntimeError(f"the band section of {gen.tag} is not the "
                           f"generator's")
    return (gen.source.replace(band, SPEC_BAND_FIRST.format(**kw))
            .replace(include, include + '\n#include "stagger_band_walk3.cuh"'))


# igg_spec_step's launch in a generated rank-3 source, on the march and on
# its first design, the walk.
SPEC_STEP_MARCH = "return launch_stag_xmarch(ph, g, fr, o, s);"
SPEC_STEP_WALK = "return launch_stagger3(ph, g, fr, o, s);"


def spec_step_walk_source(gen, text=None, launch=SPEC_STEP_WALK):
    """The source generated for a rank-3 spec (`gen`: its SpecKernels; or
    `text`, an edit of it) with `igg_spec_step` (the step and the chunk
    step) on the walk (`stagger_walk3_first.cuh` of FIRST_HEADERS, through
    the policy's `cells<VEC>` and per-cell functions, which the generator
    still emits for it), launched by `launch`."""
    text = gen.source if text is None else text
    include = '#include "stagger_walk3.cuh"'
    if text.count(SPEC_STEP_MARCH) != 1 or text.count(include) != 1:
        raise RuntimeError(f"the step entry of {gen.tag} is not the "
                           f"generator's")
    return (text.replace(SPEC_STEP_MARCH, launch)
            .replace(include, include + '\n#include "stagger_walk3_first.cuh"'))


def spec_first_source(gen):
    """The source generated for a rank-3 spec with both entries on their
    first designs: `igg_spec_step` on the walk (spec_step_walk_source) and
    `igg_spec_band_step` on the band walk (spec_band_first_source)."""
    return spec_step_walk_source(gen, spec_band_first_source(gen))


class spec_walk_vec16:
    """The control of the step and chunk entry's redesign: its first design,
    the walk, with runs of 16 bytes (4 cells in float32, 2 in float64)
    instead of 8, the band entry as built."""

    added = {"stagger_walk3_first.cuh": STAGGER_WALK3_FIRST}

    def __call__(self, name, text):
        return self.added.get(name, text)

    @staticmethod
    def generated(gen):
        return spec_step_walk_source(
            gen, launch=f"return launch_stagger3_vec<Spec_{gen.tag}<T>, 16 / "
                        f"sizeof(T)>(ph, g, fr, o, s);")


class first_design:
    """The first designs' sources in place of the kernels' (FIRST_DESIGNS)
    and their policies' headers (FIRST_HEADERS: `stokes.cuh` in place of
    the layout alone, `hm3d.cuh`, the staggered walk and the staggered band
    walk added); the generated libraries' entries on those walks."""

    added = FIRST_HEADERS
    generated = staticmethod(spec_first_source)

    def __call__(self, name, text):
        return FIRST_DESIGNS.get(name, FIRST_HEADERS.get(name, text))


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
    if text.count(guard) != 4:
        raise RuntimeError("async_copy.cuh no longer has its four "
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
# The fused step's own: const_div.cuh in float32 too, or `x / d` in float64
# too (the band and chunk kernels as built).
HM_STEP_DIV_CONST = stokes_edit(hm(
    HM_IEEE, "constexpr bool hm_ieee = E::CHUNK && !E::STEP && "
             "sizeof(T) == 4;"))
HM_STEP_DIV_IEEE = stokes_edit(hm(
    HM_IEEE, "constexpr bool hm_ieee = E::STEP || (E::CHUNK && "
             "sizeof(T) == 4);"))


def ss(old, new):
    return ("stokes_step.cu", old, new)


def ss_const(name, old, new):
    return stokes_edit(ss(f"constexpr int {name} = {old};",
                          f"constexpr int {name} = {new};"))


SS_IEEE = "constexpr bool ss_ieee = false;"
# ss_zero: a zero dividend of an admitted divisor stays in its batch on the
# reciprocal path, its quotient given the sign of x / d (bitwise the zero
# `x / d` gives; an admitted x's quotient has that sign already).
SS_BATCH = """    ok = ok & div_admits(x, q);
    return div_fast(x, q);"""
SS_BATCH_ZERO = """    ok = ok & (div_admits(x, q) | (q.fast != 0 && x == T(0)));
    const T r = div_fast(x, q);
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float((__float_as_uint(r) & 0x7fffffffu) |
                             ((__float_as_uint(x) ^ __float_as_uint(q.d)) &
                              0x80000000u));
    } else {
      const long long s = (__double_as_longlong(x) ^
                           __double_as_longlong(q.d)) &
                          (long long)0x8000000000000000ull;
      return __longlong_as_double((__double_as_longlong(r) &
                                   0x7fffffffffffffffll) | s);
    }"""
# ss_wide: a float32 dividend of a batch that left the range on the
# float64 reciprocal path (its divisor formed as make_div forms it), which
# admits every finite nonzero float32 x: RN64(x / d) rounded to float32 is
# RN32(x / d), a double rounding of a quotient being exact where
# 53 >= 2 * 24 + 2.
SS_CDIV = """  else
    return cdiv(x, q);"""
SS_CDIV_WIDE = """  else {
    if constexpr (sizeof(T) == 4) {
      const double d = q.d, r = 1.0 / d;
      const ConstDiv<double> w{
          d, r, __fma_rn(-r, d, 1.0) * r, DivBits<double>::lo,
          q.fast ? DivBits<double>::hi - DivBits<double>::lo : 0, q.fast};
      const double xd = x;
      if (div_admits(xd, w)) return (T)div_fast(xd, w);
    }
    return cdiv(x, q);
  }"""


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
    "hw_rows_2": (stokes_edit(("halo_write.cu", "constexpr int TR = 4; ",
                               "constexpr int TR = 2; ")), []),
    "hw_rows_8": (stokes_edit(("halo_write.cu", "constexpr int TR = 4; ",
                               "constexpr int TR = 8; ")), []),
    "hw_zjoint": (stokes_edit(("halo_write.cu", "constexpr int ZS = 2;",
                               "constexpr int ZS = 1;")), []),
    "sx_cpt_one_2": (sx_const("SX_CPT_ONE", 4, 2), []),
    "sx_cpt_one_8": (sx_const("SX_CPT_ONE", 4, 8), []),
    "sx_cpt_one_f64_1": (sx_const("SX_CPT_ONE_F64", 2, 1), []),
    "sx_cpt_one_f64_4": (sx_const("SX_CPT_ONE_F64", 2, 4), []),
    "sx_cpt_many_1": (sx_const("SX_CPT_MANY", 2, 1), []),
    "sx_cpt_many_4": (sx_const("SX_CPT_MANY", 2, 4), []),
    "sx_tz_16": (sx_const("SX_TZ", 32, 16), []),
    "sx_tz_64": (sx_const("SX_TZ", 32, 64), []),
    "sx_ahead_0": (sx_const("SX_AHEAD", 1, 0), []),
    "sx_ahead_2": (sx_const("SX_AHEAD", 1, 2), []),
    "sx_blocks_1024": (sx_const("SX_BLOCKS", 2048, 1024), []),
    "sx_blocks_8192": (sx_const("SX_BLOCKS", 2048, 8192), []),
    "sx_no_segments": (sx_const("SX_BLOCKS", 2048, 1), []),
    "sx_min_seg_4": (sx_const("SX_MIN_SEG", 8, 4), []),
    "sx_min_seg_16": (sx_const("SX_MIN_SEG", 8, 16), []),
    "sx_blocks_4096": (sx_const("SX_BLOCKS", 2048, 4096), []),
    "sx_bounds_f32_2": (sx_const("SX_MIN_BLOCKS_F32", 4, 2), []),
    "sx_bounds_f32_3": (sx_const("SX_MIN_BLOCKS_F32", 4, 3), []),
    "sx_bounds_f32_6": (sx_const("SX_MIN_BLOCKS_F32", 4, 6), []),
    "sx_bounds_f64_2": (sx_const("SX_MIN_BLOCKS_F64", 3, 2), []),
    "sx_bounds_f64_4": (sx_const("SX_MIN_BLOCKS_F64", 3, 4), []),
    "sx_bounds_many_f32_2": (sx_const("SX_MIN_BLOCKS_MANY_F32", 4, 2), []),
    "sx_bounds_many_f32_3": (sx_const("SX_MIN_BLOCKS_MANY_F32", 4, 3), []),
    "sx_bounds_many_f32_5": (sx_const("SX_MIN_BLOCKS_MANY_F32", 4, 5), []),
    "sx_bounds_many_f64_1": (sx_const("SX_MIN_BLOCKS_MANY_F64", 2, 1), []),
    "sx_bounds_many_f64_3": (sx_const("SX_MIN_BLOCKS_MANY_F64", 2, 3), []),
    "sx_bounds_many_chunk_f32_1": (sx_const("SX_MIN_BLOCKS_MANY_CHUNK_F32", 2,
                                            1), []),
    "sx_bounds_many_chunk_f32_3": (sx_const("SX_MIN_BLOCKS_MANY_CHUNK_F32", 2,
                                            3), []),
    "sx_put_noinline": (stokes_edit(sb(
        "__device__ __forceinline__ void sx_put(",
        "__device__ __noinline__ void sx_put(")), []),
    "sx_step_for_chunk": (stokes_edit(sb(
        "    if (g.wrap[d] || g.frz[d]) step = false;\n", "")), []),
    "sx_no_wrap_writes": (stokes_edit(sb(
        "if (!STEP) sx_edges<P, Bits>(ph, ly, F, out);",
        "if (false) sx_edges<P, Bits>(ph, ly, F, out);")), []),
    "walk_vec16": (spec_walk_vec16(), []),
    "sb_cpt_one_1": (sb_const("SB_CPT_ONE", 2, 1), []),
    "sb_cpt_one_4": (sb_const("SB_CPT_ONE", 2, 4), []),
    "sb_cpt_many_2": (sb_const("SB_CPT_MANY", 1, 2), []),
    "sb_cpt_many_2_bounds_3_2": (stokes_edit(
        sb("constexpr int SB_CPT_MANY = 1;", "constexpr int SB_CPT_MANY = 2;"),
        sb("constexpr int SB_MIN_BLOCKS_F32 = 4;",
           "constexpr int SB_MIN_BLOCKS_F32 = 3;"),
        sb("constexpr int SB_MIN_BLOCKS_F64 = 3;",
           "constexpr int SB_MIN_BLOCKS_F64 = 2;")), []),
    "sb_tz_32": (sb_const("SB_TZ", 16, 32), []),
    "sb_tz_64": (sb_const("SB_TZ", 16, 64), []),
    "sb_ahead_0": (sb_const("SB_AHEAD", 1, 0), []),
    "sb_ahead_2": (sb_const("SB_AHEAD", 1, 2), []),
    "sb_blocks_2048": (sb_const("SB_BLOCKS", 8192, 2048), []),
    "sb_blocks_32768": (sb_const("SB_BLOCKS", 8192, 32768), []),
    "sb_no_segments": (sb_const("SB_BLOCKS", 8192, 1), []),
    "sb_min_seg_16": (sb_const("SB_MIN_SEG", 8, 16), []),
    "sb_min_seg_32": (sb_const("SB_MIN_SEG", 8, 32), []),
    "sb_bounds_f32_2": (sb_const("SB_MIN_BLOCKS_F32", 4, 2), []),
    "sb_bounds_f32_3": (sb_const("SB_MIN_BLOCKS_F32", 4, 3), []),
    "sb_bounds_f32_6": (sb_const("SB_MIN_BLOCKS_F32", 4, 6), []),
    "sb_bounds_f32_8": (sb_const("SB_MIN_BLOCKS_F32", 4, 8), []),
    "sb_bounds_f64_2": (sb_const("SB_MIN_BLOCKS_F64", 3, 2), []),
    "sb_bounds_f64_4": (sb_const("SB_MIN_BLOCKS_F64", 3, 4), []),
    "sb_bounds_f64_6": (sb_const("SB_MIN_BLOCKS_F64", 3, 6), []),
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
    "first_designs": (first_design(), []),
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
    "ss_c_f32_1": (ss_const("SS_C_F32", 2, 1), []),
    "ss_c_f32_4": (ss_const("SS_C_F32", 2, 4), []),
    "ss_c_f64_1": (ss_const("SS_C_F64", 2, 1), []),
    "ss_c_f64_4": (ss_const("SS_C_F64", 2, 4), []),
    "ss_w_2": (ss_const("SS_W", 4, 2), []),
    "ss_w_8": (ss_const("SS_W", 4, 8), []),
    "ss_div_ieee": (stokes_edit(ss(SS_IEEE, "constexpr bool ss_ieee = true;")),
                    []),
    "ss_div_ieee_f32": (stokes_edit(ss(
        SS_IEEE, "constexpr bool ss_ieee = sizeof(T) == 4;")), []),
    "ss_ahead_2": (ss_const("SS_AHEAD", 1, 2), []),
    "ss_zero": (stokes_edit(ss(SS_BATCH, SS_BATCH_ZERO)), []),
    "ss_wide": (stokes_edit(ss(SS_CDIV, SS_CDIV_WIDE)), []),
    "ss_blocks_1024": (ss_const("SS_BLOCKS", 4096, 1024), []),
    "ss_blocks_2048": (ss_const("SS_BLOCKS", 4096, 2048), []),
    "ss_blocks_8192": (ss_const("SS_BLOCKS", 4096, 8192), []),
    "ss_blocks_16384": (ss_const("SS_BLOCKS", 4096, 16384), []),
    "ss_no_segments": (ss_const("SS_BLOCKS", 4096, 1), []),
    "ss_bounds_f32_2": (ss_const("SS_MIN_BLOCKS_F32", 3, 2), []),
    "ss_bounds_f32_4": (ss_const("SS_MIN_BLOCKS_F32", 3, 4), []),
    "ss_bounds_f64_2": (ss_const("SS_MIN_BLOCKS_F64", 3, 2), []),
    "ss_bounds_f64_4": (ss_const("SS_MIN_BLOCKS_F64", 3, 4), []),
    "hm_step_blocks_512": (hm_const("HM_STEP_BLOCKS", 8192, 512), []),
    "hm_step_blocks_1024": (hm_const("HM_STEP_BLOCKS", 8192, 1024), []),
    "hm_step_blocks_2048": (hm_const("HM_STEP_BLOCKS", 8192, 2048), []),
    "hm_step_blocks_16384": (hm_const("HM_STEP_BLOCKS", 8192, 16384), []),
    "hm_step_min_seg_8": (hm_const("HM_STEP_MIN_SEG", 16, 8), []),
    "hm_step_min_seg_32": (hm_const("HM_STEP_MIN_SEG", 16, 32), []),
    "hm_step_min_seg_4": (stokes_edit(
        hm("constexpr int HM_STEP_BLOCKS = 8192;",
           "constexpr int HM_STEP_BLOCKS = 16384;"),
        hm("constexpr int HM_STEP_MIN_SEG = 16;",
           "constexpr int HM_STEP_MIN_SEG = 4;")), []),
    "hm_step_blocks_32768": (hm_const("HM_STEP_BLOCKS", 8192, 32768), []),
    "hm_step_no_segments": (hm_const("HM_STEP_BLOCKS", 8192, 1), []),
    "hm_step_div_const": (HM_STEP_DIV_CONST, []),
    "hm_step_bounds_f32_3": (hm_const("HM_STEP_MIN_BLOCKS_F32", 4, 3), []),
    "hm_step_bounds_f64_2": (hm_const("HM_STEP_MIN_BLOCKS_F64", 4, 2), []),
    "hm_step_bounds_f64_3": (hm_const("HM_STEP_MIN_BLOCKS_F64", 4, 3), []),
    "hm_step_noinline_special": (stokes_edit(hm(
        "__device__ __forceinline__ void hm_step_put_special(",
        "__device__ __noinline__ void hm_step_put_special(")), []),
    "hm_step_no_special_writes": (stokes_edit(hm(
        "  hm_step_put_special(m, b, j, k, ins, x, pn, fn);\n}",
        "}")), []),
    "hm_step_div_ieee": (HM_STEP_DIV_IEEE, []),
    "march_no_segments": (stokes_edit(march(
        "constexpr int MARCH_BLOCKS = 8192; ",
        "constexpr int MARCH_BLOCKS = 1; ")), []),
    "pack_threads_128": (stokes_edit((
        "pack_planes.cu", "constexpr int kThreads = 256;",
        "constexpr int kThreads = 128;")), []),
}
# The libraries a variant means to change, where the headers its edit
# touches reach more of them than its kernels (`SPEC_BAND`: the generated
# libraries of GENERATED); the others change every library whose sources
# include an edited file.  `build` raises where a named library's sources
# do not.
SPEC_BAND = ("gen_relax3d", "gen_acoustic3d")
MARCH = ("stokes_chunk", "stokes_band")
TARGETS = {v: MARCH for v in VARIANTS if v.startswith("march_")}
TARGETS.update(
    {v: ("stokes_step",) for v in VARIANTS if v.startswith("ss_")},
    **{v: ("hm3d_step",) for v in VARIANTS if v.startswith("hm_step_")},
    vec_8B=("diffusion_step", "diffusion_chunk"),
    **{v: SPEC_BAND for v in VARIANTS if v.startswith(("sb_", "sx_"))},
    walk_vec16=SPEC_BAND,
    march_sync_staging=MARCH + ("hm3d_band", "hm3d_chunk", "diffusion_band",
                                "hm3d_step", "stokes_step"),
    **{v: MARCH + ("hm3d_band", "hm3d_chunk")
       for v in ("march_div_ieee", "march_div_vote", "march_div_mul")})
LIBS = ("diffusion_step", "diffusion_chunk", "hm3d_step", "hm3d_chunk",
        "wave2d_step", "wave2d_chunk", "stokes_step", "stokes_chunk",
        "stokes_band", "pack_planes", "diffusion_band", "hm3d_band",
        "halo_write")
# The generated libraries of these spec cases are built per variant too
# (`gen_<tag>`).
GENERATED = ("relax3d", "acoustic3d")


def spec_kernels(name):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_spec_cases

    return torch_spec_cases.kernels(name)


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


def generated_at(root, name):
    """The source that the generator of the checkout at `root` writes for
    the spec case `name` (its own tests/torch_spec_cases.py)."""
    code = ("import sys; sys.path[:0] = ['.', 'tests']; "
            "import torch_spec_cases as c; "
            f"sys.stdout.write(c.kernels({name!r}).source)")
    return subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                          capture_output=True, text=True).stdout


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
    added = getattr(edit, "added", {})
    for f in sorted(set(os.listdir(csrc)) | set(added)):
        if f.endswith((".cu", ".cuh")):
            before = ""
            if os.path.exists(os.path.join(csrc, f)):
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
    gens = tuple(f"gen_{spec_kernels(name).tag}" for name in GENERATED)
    for name in GENERATED:
        gen = spec_kernels(name)
        if variant.startswith("sources:"):
            source = generated_at(variant[len("sources:"):], name)
        else:
            source = getattr(edit, "generated", lambda g: g.source)(gen)
        texts[f"gen_{gen.tag}.cu"] = source
        if source != gen.source:
            changed.add(f"gen_{gen.tag}.cu")
        with open(os.path.join(out, f"gen_{gen.tag}.cu"), "w") as dst:
            dst.write(source)
    touched = (set(LIBS) | set(gens)
               if flags or variant.startswith("sources:")
               or variant == "as_built" else affected(texts, changed))
    if variant in TARGETS:
        named = set(TARGETS[variant])
        if named - touched:
            raise RuntimeError(f"variant {variant}: its edit no longer "
                               f"reaches {sorted(named - touched)}")
        touched = named
    procs = {lib: subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, *flags, "-Xptxas", "-v", "-o",
         os.path.join(out, f"{lib}.so"), os.path.join(out, f"{lib}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib in LIBS + gens if lib in touched}
    libs = {}
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}/{lib}:\n{log}")
        PTXAS[variant, lib] = ptxas_report(log)
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


# (variant, library) -> ptxas's report of each kernel of the library.
PTXAS = {}
ENTRY = re.compile(r"Compiling entry function '(\w+)'")
USED = re.compile(r"Used (\d+) registers")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")


def ptxas_report(log):
    """{kernel (mangled): "R registers, S stack, spills st/ld"} from
    `nvcc -Xptxas -v`'s log (a kernel's lines follow its "Compiling entry
    function" line)."""
    out, name, frame = {}, None, ""
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            name, frame = m.group(1), ""
            continue
        m = FRAME.search(line)
        if m and name:
            frame = (f"{m.group(1)} stack, spills {m.group(2)}/"
                     f"{m.group(3)}")
            continue
        m = USED.search(line)
        if m and name:
            out[name] = f"{m.group(1)} registers, {frame}"
            name = None
    return out


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


def profiled_ms(fn, n, kernel, tries=3):
    """Mean device ms per launch of the kernel whose name contains `kernel`
    over `n` calls of `fn()` (`torch.profiler`): for kernels shorter than
    the host's time to launch them, where events would time the host.  A
    trace that holds none of its launches (the profiler now and then
    loses a trace) is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if kernel in evt.key and evt.count:
                total = getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
                if total:
                    return total / evt.count / 1e3
    raise RuntimeError(f"no device time for {kernel} in {tries} traces")


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

    def hm3d_step(state, dtype=torch.float32, blocks=1):
        """The HM3D step on one periodic 256^3 block or on 2x2x2 periodic
        blocks of 256^3 (every dim received), random fields or
        `init_fields`."""
        def setup():
            g = grid(**(dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
                             periodz=1) if blocks == 2 else one_block))
            p = h3.Params()
            if state == "random":
                Pe = -0.5 * torch.rand(it.stacked_shape(g.nxyz), device=dev,
                                       dtype=dtype)
                phi = 0.1 + 0.1 * torch.rand_like(Pe)
            else:
                Pe, phi = h3.init_fields(p, dtype=dtype)
            kw, modes = p.step_kwargs(), hp.step_modes(g)
            recv = hp.step_recv_planes(Pe, phi, g, modes, kw)
            out = (torch.empty_like(Pe), torch.empty_like(phi))
            return lambda: hp.launch_step(Pe, phi, modes, recv, g.dims, kw,
                                          out=out), 1
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
            if state == "evolved":  # phase 12's state: 10 iterations on
                *S, Rho = it.update_halo(*S, Rho)
                for _ in range(10):
                    S = list(sp.fused_stokes_iteration(*S, Rho, **kw))
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

    def spec_band(name, dtype=torch.float32):
        """One K = 8 banded chunk (B = 8) of a rank-3 spec's generated band
        kernel on one periodic block of 256^3 (relax3d: 272 x 256 x 256
        extended), random fields in (-1, 1)."""
        def setup():
            from igg_torch.stencil import lower

            g = grid(**one_block)
            gen = spec_kernels(name)
            shapes = lower.field_shapes(gen.spec, g.nxyz)
            E = gen.analysis.margin_after(K)
            modes = ce.dim_modes(g)
            ols = ce.field_ols(g, shapes)
            exts = ce.extend_fields(
                [(2 * torch.rand(it.stacked_shape(s), device=dev,
                                 dtype=torch.float64) - 1).to(dtype)
                 for s in shapes], ols, E, g, modes)
            return lambda: lower.band_call(gen, exts, shapes, K=K, B=8, E=E,
                                           modes=modes, grid=g,
                                           ols=ols), K
        return setup

    def spec_entry(name, chunk, dtype=torch.float32):
        """A rank-3 spec's generated step (one launch) or K = 8 chunk step
        (K launches; relax3d 272 x 256 x 256 extended) on one periodic
        block of 256^3, random fields in (-1, 1): igg_spec_step on the
        march's step and chunk modes (the chunk wraps y and z)."""
        def setup():
            from igg_torch.stencil import lower

            g = grid(**one_block)
            gen = spec_kernels(name)
            shapes = lower.field_shapes(gen.spec, g.nxyz)
            S = [(2 * torch.rand(it.stacked_shape(s), device=dev,
                                 dtype=torch.float64) - 1).to(dtype)
                 for s in shapes]
            if not chunk:
                out = [torch.empty_like(A) for A in S]
                return lambda: lower.launch_step(gen, S, g.dims, out=out), 1
            E = gen.analysis.margin_after(K)
            modes = ce.dim_modes(g)
            ols = ce.field_ols(g, shapes)
            exts = ce.extend_fields(S, ols, E, g, modes)
            return lambda: lower.chunk_call(gen, exts, shapes, K=K, E=E,
                                            modes=modes, grid=g,
                                            ols=ols), K
        return setup

    def halo(blocks, dtype=torch.float32):
        """One halo_write launch on a 256^3 f32 field: one periodic block
        (every dim WRAP, phases 1 and 5) or 2x2x2 blocks of 256^3 (every
        dim EXT, phase 7's writes)."""
        from igg_torch.ops import halo_write as hw

        def setup():
            g = grid(**(one_block if blocks == 1 else
                        dict(dimx=2, dimy=2, dimz=2)))
            shp = it.stacked_shape(g.nxyz)
            F = torch.rand(shp, device=dev).to(dtype)
            specs = []
            for d in range(3):
                if blocks == 1:
                    specs.append((d, "wrap", 2))
                    continue
                plane = list(shp)
                plane[d] = g.dims[d]
                specs.append((d, "ext") + tuple(
                    torch.rand(plane, device=dev).to(dtype) for _ in (0, 1)))
            return lambda: hw.halo_write(F, specs, g.dims), 1
        return setup

    f64 = torch.float64
    # (name, setup, the library whose kernel it times)
    return [("diffusion_step_256", diffusion_step, "diffusion_step"),
            ("diffusion_chunk_2x2x2_256_open", diffusion_chunk,
             "diffusion_chunk"),
            ("hm3d_step_256_random", hm3d_step("random"), "hm3d_step"),
            ("hm3d_step_256_init_fields", hm3d_step("init_fields"),
             "hm3d_step"),
            ("hm3d_step_256_random_f64", hm3d_step("random", f64),
             "hm3d_step"),
            ("hm3d_step_2x2x2_256_periodic", hm3d_step("random", blocks=2),
             "hm3d_step"),
            ("hm3d_step_2x2x2_256_periodic_f64",
             hm3d_step("random", f64, blocks=2), "hm3d_step"),
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
            ("stokes_step_256_periodic_evolved", stokes(False, "evolved"),
             "stokes_step"),
            ("stokes_step_288x256x256_periodic", stokes(False, nx=288),
             "stokes_step"),
            ("stokes_step_256_periodic_f64", stokes(False, dtype=f64),
             "stokes_step"),
            ("stokes_step_2x2x2_256_open", stokes(False, blocks=2),
             "stokes_step"),
            ("stokes_step_2x2x2_256_open_f64",
             stokes(False, blocks=2, dtype=f64), "stokes_step"),
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
            *[(f"{name}_{kind}_256_periodic{suffix}",
               spec_entry(name, kind == "chunk", dtype), f"gen_{name}")
              for name in GENERATED for kind in ("step", "chunk")
              for suffix, dtype in (("", torch.float32), ("_f64", f64))],
            ("relax3d_band_256_periodic", spec_band("relax3d"),
             "gen_relax3d"),
            ("relax3d_band_256_periodic_f64", spec_band("relax3d", f64),
             "gen_relax3d"),
            ("acoustic3d_band_256_periodic", spec_band("acoustic3d"),
             "gen_acoustic3d"),
            ("acoustic3d_band_256_periodic_f64",
             spec_band("acoustic3d", f64), "gen_acoustic3d"),
            ("halo_write_256_periodic", halo(1), "halo_write"),
            ("halo_write_256_periodic_f64", halo(1, f64), "halo_write"),
            ("halo_write_2x2x2_256_ext", halo(2), "halo_write"),
            ("halo_write_2x2x2_256_ext_f64", halo(2, f64), "halo_write")]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from igg_torch.ops import (diffusion_pallas, diffusion_trapezoid,
                               halo_write, hm3d_pallas, hm3d_trapezoid, pack,
                               stokes_pallas, stokes_trapezoid, wave2d_pallas,
                               wave2d_trapezoid)
    from igg_torch.stencil import lower

    wrappers = (diffusion_pallas, diffusion_trapezoid, hm3d_pallas,
                hm3d_trapezoid, wave2d_pallas, wave2d_trapezoid,
                stokes_pallas, stokes_trapezoid, pack, halo_write)
    named = [a for a in sys.argv[1:] if not a.startswith("case:")]
    keep = [a[len("case:"):] for a in sys.argv[1:] if a.startswith("case:")]
    for v in named:
        if v not in VARIANTS and not v.startswith("sources:"):
            raise SystemExit(f"unknown variant {v!r}: {sorted(VARIANTS)}")
    variants = ["as_built"] + named if named else list(VARIANTS)
    # The variants' builds run side by side (each one nvcc per library).
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        done = dict(zip(variants, pool.map(build, variants)))
    built = {v: done[v][0] for v in variants}
    touched = {v: done[v][1] for v in variants}
    times = {v: {} for v in variants}
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
                lambda source, t, v=v: built[v][f"gen_{t}"])
            times[v].setdefault(name, []).append(
                profiled_ms(run, 200, "pack_kernel")
                if name.startswith("pack") else
                profiled_ms(run, 200, "halo_write_kernel")
                if name.startswith("halo") else
                event_ms(run, max(2, 40 // launches)) / launches)
        del run
    for v in variants:
        print(json.dumps({"variant": v, "ms_per_launch": times[v],
                          "libraries": sorted(touched[v]),
                          "ptxas": {lib: rep for (w, lib), rep in
                                    PTXAS.items() if w == v}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
