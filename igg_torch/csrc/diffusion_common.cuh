// Device code of the fused diffusion step (diffusion_step.cu, which also
// serves the K-step loop of a one-block grid): one step of a block-stacked
// grid array, halo cells included, computed from the source tensor alone.
//
// Layout: a C-ordered (G0, G1, G2) tensor holding n0 x n1 x n2 local blocks
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
// The walk ends in the updated value at the (mapped) cell: the stencil for
// cells interior to their block in all three dims, the source value for
// cells on a block's outer planes (no-write).  Every value comes from the
// source tensor, never from the output, so no grid-wide synchronization is
// needed.
//
// A thread computes VEC consecutive z cells of one (x, y) row with 16-byte
// loads and stores.  The x/y part of the walk is the same for all of them,
// so the thread resolves its row once and loads the row's neighbours as
// vectors; only a lane on a block's z edge takes a path of its own (a few
// scalar loads, issued beside the vector ones).  Halo rows thus cost what
// interior rows cost, and no warp runs a slow path for one of its threads.
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

template <typename T>
struct Planes {
  const T* p[6];  // (dim, side) -> received plane, stacked over the blocks
};

template <typename T>
struct Coef {
  T cx, cy, cz, cc;  // rdx2, rdy2, rdz2, 2*(rdx2+rdy2+rdz2)
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

// The update of one interior cell: ctr + a*lap with lap associated as
// ((x + y) + z) - cc*ctr, the order of igg.ops.diffusion_compute and of
// the port's plain version.  Built with -fmad=false, so each operation
// rounds separately like the plain PyTorch version.
template <typename T>
__device__ __forceinline__ T stencil(T ctr, T xm, T xp, T ym, T yp, T zm,
                                     T zp, T a, const Coef<T>& k) {
  T lap = (xp + xm) * k.cx;
  lap = lap + (yp + ym) * k.cy;
  lap = lap + (zp + zm) * k.cz;
  lap = lap - k.cc * ctr;
  return ctr + a * lap;
}

__device__ __forceinline__ int block_of(int g, int d, const Geo& geo) {
  return geo.n[d] == 1 ? 0 : g / geo.s[d];
}

// One step of the VEC cells (g0, g1, z0 .. z0+VEC-1) of `src`: their new
// values.  Needs G2 % VEC == 0 and every pointer aligned to VEC elements.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> resolve_cells(
    const T* __restrict__ src, const T* __restrict__ A, const Geo& geo,
    const Planes<T>& pl, const Coef<T>& k, int g0, int g1, int z0) {
  using V = Vec<T, VEC>;
  const int G1 = geo.G[1], G2 = geo.G[2];
  const long long sx = (long long)G1 * G2;
  const int c0 = block_of(g0, 0, geo), c1 = block_of(g1, 1, geo);

  // The row's x/y walk (y first): a received plane that supplies the row,
  // or the resolved row (r0, r1) of the block itself.
  int r0 = g0, r1 = g1;
  const T* plane = nullptr;
  long long prow = 0;  // offset of the row (z = 0) in `plane`
  const int i1 = g1 - c1 * geo.s[1];
  if (geo.mode[1] != FROZEN && (i1 == 0 || i1 == geo.s[1] - 1)) {
    if (geo.mode[1] == RECV) {
      plane = i1 == 0 ? pl.p[2] : pl.p[3];
      prow = ((long long)g0 * geo.n[1] + c1) * G2;
    } else {
      r1 = i1 == 0 ? geo.s[1] - 2 : 1;
    }
  }
  const int i0 = g0 - c0 * geo.s[0];
  if (!plane && geo.mode[0] != FROZEN && (i0 == 0 || i0 == geo.s[0] - 1)) {
    if (geo.mode[0] == RECV) {
      plane = i0 == 0 ? pl.p[0] : pl.p[1];
      prow = ((long long)c0 * G1 + r1) * G2;
    } else {
      r0 = i0 == 0 ? geo.s[0] - 2 : 1;
    }
  }
  const int j0 = r0 - c0 * geo.s[0], j1 = r1 - c1 * geo.s[1];
  const bool rows_in =
      j0 != 0 && j0 != geo.s[0] - 1 && j1 != 0 && j1 != geo.s[1] - 1;
  const long long row = (long long)r0 * sx + (long long)r1 * G2;

  V res;
  if (plane) {
    res = load<T, VEC>(plane + prow + z0);
  } else {
    const V c = load<T, VEC>(src + row + z0);
    if (rows_in) {
      const V xm = load<T, VEC>(src + row - sx + z0);
      const V xp = load<T, VEC>(src + row + sx + z0);
      const V ym = load<T, VEC>(src + row - G2 + z0);
      const V yp = load<T, VEC>(src + row + G2 + z0);
      const V a = load<T, VEC>(A + row + z0);
      const T zm = z0 > 0 ? src[row + z0 - 1] : T(0);
      const T zp = z0 + VEC < G2 ? src[row + z0 + VEC] : T(0);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        res.v[v] = stencil(c.v[v], xm.v[v], xp.v[v], ym.v[v], yp.v[v],
                           v == 0 ? zm : c.v[v - 1],
                           v == VEC - 1 ? zp : c.v[v + 1], a.v[v], k);
    } else {
      res = c;  // a block's outer row: no-write
    }
  }

  // Lanes on a block's z edge: the z part of the walk comes first.
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int z = z0 + v;
    const int c2 = block_of(z, 2, geo);
    const int i2 = z - c2 * geo.s[2];
    if (i2 != 0 && i2 != geo.s[2] - 1) continue;
    if (geo.mode[2] == RECV) {
      const T* p = i2 == 0 ? pl.p[4] : pl.p[5];
      res.v[v] = p[((long long)g0 * G1 + g1) * geo.n[2] + c2];
    } else if (geo.mode[2] == WRAP) {
      const int zz = i2 == 0 ? geo.s[2] - 2 : 1;
      const long long q = row + zz;
      if (plane)
        res.v[v] = plane[prow + zz];
      else if (rows_in)
        res.v[v] = stencil(src[q], src[q - sx], src[q + sx], src[q - G2],
                           src[q + G2], src[q - 1], src[q + 1], A[q], k);
      else
        res.v[v] = src[q];
    } else if (!plane) {
      res.v[v] = src[row + z];  // FROZEN: the cell's own stale value
    }
  }
  return res;
}

// One step of the VEC cells (g0, g1, z0 .. z0+VEC-1) of `src` into the same
// cells of `out`.
template <typename T, int VEC>
__device__ __forceinline__ void step_cells(const T* __restrict__ src,
                                           const T* __restrict__ A,
                                           T* __restrict__ out, const Geo& geo,
                                           const Planes<T>& pl,
                                           const Coef<T>& k, int g0, int g1,
                                           int z0) {
  *reinterpret_cast<Vec<T, VEC>*>(out + ((long long)g0 * geo.G[1] + g1) *
                                            geo.G[2] + z0) =
      resolve_cells<T, VEC>(src, A, geo, pl, k, g0, g1, z0);
}

// Whether the VEC-wide path may serve these pointers: 16-byte aligned rows
// (G2 a multiple of VEC) in the field, the coefficient, the output and the
// received x/y planes (z planes are read by element).
template <typename T, int VEC>
bool vector_ok(const Geo& geo, const void* src, const void* A, const void* out,
               const Planes<T>& pl) {
  auto ok = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (sizeof(T) * VEC) == 0;
  };
  bool good = geo.G[2] % VEC == 0 && ok(src) && ok(A) && ok(out);
  for (int j = 0; j < 4; ++j) good = good && ok(pl.p[j]);
  return good;
}

template <typename T, int VEC>
using CellKernel = void (*)(const T*, const T*, T*, Geo, Planes<T>, Coef<T>);

// Launch `kernel` (a __global__ that runs step_cells once per thread) over
// every row of the grid: 32 x 8 threads cover 32*VEC z cells of 8 y rows
// of one x plane.
template <typename T, int VEC>
int launch_cells(CellKernel<T, VEC> kernel, const void* src, const void* A,
                 void* out, const Geo& geo, const Planes<T>& pl,
                 const Coef<T>& k, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((geo.G[2] / VEC + 31) / 32, (geo.G[1] + 7) / 8, geo.G[0]);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, block, 0, stream>>>(static_cast<const T*>(src),
                                     static_cast<const T*>(A),
                                     static_cast<T*>(out), geo, pl, k);
  return (int)cudaGetLastError();
}

}  // namespace igg
