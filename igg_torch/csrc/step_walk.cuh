// The walk shared by every step and chunk kernel of the port: one step of
// NF fields of a block-stacked grid, halo cells included, each output cell
// computed from the source tensors alone.  The physics is a policy type P
// (diffusion.cuh; the first designs' hm3d.cuh) that the walk is a
// template over:
//   - `using T`, `static constexpr int NF`: element type, updated fields;
//   - `const T* src[NF]`: the source fields (constant fields are the
//     policy's own members);
//   - `update<VEC>(row, z0, sx, G2, out)`: the new values of all NF fields
//     at the VEC cells (row + z0 ..) interior to their block in x and y,
//     with the z neighbours at z0-1 and z0+VEC read where the row has them
//     (lanes on a block's z edge are overwritten by the walk);
//   - `aligned(bytes)` (host): whether every pointer of the policy is.
//
// Layout: C-ordered (G0, G1, G2) tensors holding n0 x n1 x n2 local blocks
// of size (s0, s1, s2), G_d = n_d * s_d; z (dim 2) is contiguous.
//
// The value of output cell g is resolved by walking the dimensions from z
// down to x (later dims own the shared corner and edge cells, the
// reference's sequential-dimension halo semantics):
//   - a dim in WRAP mode (periodic, one block) whose local index is a halo
//     index maps it to the updated inner plane it aliases (0 -> s-2,
//     s-1 -> 1) and the walk goes on;
//   - a dim in RECV mode (several blocks) whose local index is a halo
//     index returns the received plane's value there;
//   - FROZEN dims (open, one block) never receive: the walk goes on.
// The walk ends in the updated values at the (mapped) cell: the policy's
// update for cells interior to their block in all three dims, the source
// values for cells on a block's outer planes (no-write).  All NF fields of
// a cell are resolved together, so a policy whose fields depend on each
// other at one cell (HM3D's phi on the new Pe) sees the pair.  Every value
// comes from the sources, never from the outputs, so no grid-wide
// synchronization is needed.
//
// A thread computes VEC consecutive z cells of one (x, y) row with 16-byte
// loads and stores.  The x/y part of the walk is the same for all of them,
// so the thread resolves its row once and loads the row's neighbours as
// vectors; only a lane on a block's z edge takes a path of its own (a few
// scalar loads, issued beside the vector ones).  Halo rows thus cost what
// interior rows cost, and no warp runs a slow path for one of its threads.
// Plain loads: routing them through the read-only path with __ldg made the
// diffusion chunk kernel 19% slower on the H100 (kernel_variants.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace igg {

enum Mode { FROZEN = 0, WRAP = 1, RECV = 2 };

struct Geo {
  int n[3];     // blocks per dim
  int s[3];     // local block size per dim
  int G[3];     // stacked extent per dim
  int mode[3];  // Mode per dim
};

// Geo from cfg = n[3] s[3] mode[3].
inline Geo make_geo(const int* cfg) {
  Geo geo;
  for (int d = 0; d < 3; ++d) {
    geo.n[d] = cfg[d];
    geo.s[d] = cfg[3 + d];
    geo.G[d] = cfg[d] * cfg[3 + d];
    geo.mode[d] = cfg[6 + d];
  }
  return geo;
}

template <typename T, int NF>
struct Fields {
  T* p[NF];
};

template <typename T, int NF>
struct Planes {
  const T* p[NF][6];  // (field, dim, side) -> received plane, stacked over
                      // the blocks; null for dims not in RECV mode
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int NF, int VEC>
struct Cells {
  Vec<T, VEC> f[NF];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return *p;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  *reinterpret_cast<Vec<T, VEC>*>(p) = v;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

__device__ __forceinline__ int block_of(int g, int d, const Geo& geo) {
  return geo.n[d] == 1 ? 0 : g / geo.s[d];
}

// One step of the VEC cells (g0, g1, z0 .. z0+VEC-1) of every field: their
// new values.  Needs G2 % VEC == 0 and every pointer aligned to VEC
// elements.
template <class P, int VEC>
__device__ __forceinline__ Cells<typename P::T, P::NF, VEC> resolve_cells(
    const P& ph, const Geo& geo, const Planes<typename P::T, P::NF>& pl,
    int g0, int g1, int z0) {
  using T = typename P::T;
  constexpr int NF = P::NF;
  const int G1 = geo.G[1], G2 = geo.G[2];
  const long long sx = (long long)G1 * G2;
  const int c0 = block_of(g0, 0, geo), c1 = block_of(g1, 1, geo);

  // The row's x/y walk (y first): the received planes that supply the row
  // (their row pointers per field, `plane`), or the resolved row (r0, r1)
  // of the block.  Plane pointers are picked with constant indices: a
  // runtime index into the kernel parameters would copy them to local
  // memory.
  int r0 = g0, r1 = g1;
  bool plane = false;
  const T* pp[NF] = {};
  const int i1 = g1 - c1 * geo.s[1];
  if (geo.mode[1] != FROZEN && (i1 == 0 || i1 == geo.s[1] - 1)) {
    if (geo.mode[1] == RECV) {
      plane = true;
      const long long prow = ((long long)g0 * geo.n[1] + c1) * G2;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        pp[f] = (i1 == 0 ? pl.p[f][2] : pl.p[f][3]) + prow;
    } else {
      r1 = i1 == 0 ? geo.s[1] - 2 : 1;
    }
  }
  const int i0 = g0 - c0 * geo.s[0];
  if (!plane && geo.mode[0] != FROZEN && (i0 == 0 || i0 == geo.s[0] - 1)) {
    if (geo.mode[0] == RECV) {
      plane = true;
      const long long prow = ((long long)c0 * G1 + r1) * G2;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        pp[f] = (i0 == 0 ? pl.p[f][0] : pl.p[f][1]) + prow;
    } else {
      r0 = i0 == 0 ? geo.s[0] - 2 : 1;
    }
  }
  const int j0 = r0 - c0 * geo.s[0], j1 = r1 - c1 * geo.s[1];
  const bool rows_in =
      j0 != 0 && j0 != geo.s[0] - 1 && j1 != 0 && j1 != geo.s[1] - 1;
  const long long row = (long long)r0 * sx + (long long)r1 * G2;

  Cells<T, NF, VEC> res;
  if (plane) {
#pragma unroll
    for (int f = 0; f < NF; ++f) res.f[f] = load<T, VEC>(pp[f] + z0);
  } else if (rows_in) {
    ph.template update<VEC>(row, z0, sx, G2, res);
  } else {
#pragma unroll
    for (int f = 0; f < NF; ++f)  // a block's outer row: no-write
      res.f[f] = load<T, VEC>(ph.src[f] + row + z0);
  }

  // Lanes on a block's z edge: the z part of the walk comes first.
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int z = z0 + v;
    const int c2 = block_of(z, 2, geo);
    const int i2 = z - c2 * geo.s[2];
    if (i2 != 0 && i2 != geo.s[2] - 1) continue;
    if (geo.mode[2] == RECV) {
      const long long q = ((long long)g0 * G1 + g1) * geo.n[2] + c2;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        res.f[f].v[v] = ld((i2 == 0 ? pl.p[f][4] : pl.p[f][5]) + q);
    } else if (geo.mode[2] == WRAP) {
      const int zz = i2 == 0 ? geo.s[2] - 2 : 1;
      if (plane) {
#pragma unroll
        for (int f = 0; f < NF; ++f) res.f[f].v[v] = ld(pp[f] + zz);
      } else if (rows_in) {
        Cells<T, NF, 1> one;
        ph.template update<1>(row, zz, sx, G2, one);
#pragma unroll
        for (int f = 0; f < NF; ++f) res.f[f].v[v] = one.f[f].v[0];
      } else {
#pragma unroll
        for (int f = 0; f < NF; ++f) res.f[f].v[v] = ld(ph.src[f] + row + zz);
      }
    } else if (!plane) {
#pragma unroll
      for (int f = 0; f < NF; ++f)  // FROZEN: the cell's own stale value
        res.f[f].v[v] = ld(ph.src[f] + row + z);
    }
  }
  return res;
}

// One step of every row of the grid: a thread per VEC z cells of one
// (x, y) row; 32 x 8 threads cover 32*VEC z cells of 8 y rows of one x
// plane.
template <class P, int VEC>
__global__ void __launch_bounds__(256)
    step_kernel(P ph, Geo geo, Planes<typename P::T, P::NF> pl,
                Fields<typename P::T, P::NF> out) {
  const int z0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int g1 = blockIdx.y * blockDim.y + threadIdx.y;
  if (z0 >= geo.G[2] || g1 >= geo.G[1]) return;
  const int g0 = blockIdx.z;
  const auto res = resolve_cells<P, VEC>(ph, geo, pl, g0, g1, z0);
  const long long o = ((long long)g0 * geo.G[1] + g1) * geo.G[2] + z0;
#pragma unroll
  for (int f = 0; f < P::NF; ++f) store(out.p[f] + o, res.f[f]);
}

template <class P, int VEC>
int launch_step_vec(const P& ph, const Geo& geo,
                    const Planes<typename P::T, P::NF>& pl,
                    const Fields<typename P::T, P::NF>& out,
                    cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((geo.G[2] / VEC + 31) / 32, (geo.G[1] + 7) / 8, geo.G[0]);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  step_kernel<P, VEC><<<grid, block, 0, stream>>>(ph, geo, pl, out);
  return (int)cudaGetLastError();
}

// Launch one step of `ph`'s fields into `out`: the 16-byte vector path
// where every row of the sources, the outputs and the received x/y planes
// is 16-byte aligned (G2 a multiple of VEC; z planes are read by
// element), else the element path.
template <class P>
int launch_step(const P& ph, const Geo& geo,
                const Planes<typename P::T, P::NF>& pl,
                const Fields<typename P::T, P::NF>& out, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(typename P::T);
  bool vec = geo.G[2] % VEC == 0 && ph.aligned(16);
  for (int f = 0; f < P::NF; ++f) {
    vec = vec && aligned(out.p[f], 16);
    for (int j = 0; j < 4; ++j) vec = vec && aligned(pl.p[f][j], 16);
  }
  if (vec) return launch_step_vec<P, VEC>(ph, geo, pl, out, stream);
  return launch_step_vec<P, 1>(ph, geo, pl, out, stream);
}

}  // namespace igg
