// The step of a K-step trapezoid chunk, shared by every family's chunk
// kernel (diffusion_chunk.cu, hm3d_chunk.cu): one launch advances every
// block of a block-stacked EXTENDED buffer (each block widened by K rows
// beyond both ends of every extended dim) by one step of all NF fields of
// the policy P (step_walk.cuh).
//
// Per step, for every extended block (the rules of the TPU kernels and of
// their window realization, igg_torch/ops/chunk_engine.py:
// window_step_plain):
//   - every interior row is updated by the policy; the outermost rows of
//     each extended block keep their values (shoulder garbage that the
//     shrinking validity never reads back into the central window);
//   - y/z dims in WRAP mode (periodic, one block, not extended) take the
//     updated inner plane, resolved as the fused step resolves it;
//   - then open dims re-freeze every field from F, the chunk-entry
//     buffers: a "frozen" dim (open, one block) its two boundary planes, an
//     "oext" dim (open, several blocks, extended) the rows <= lo and >= hi
//     of the blocks on the global edges.  The freeze wins the cells it
//     shares with a wrap.  The edge flags of a block along d are (c == 0,
//     c == n-1), which for a one-block frozen dim sets both: the rule of
//     chunk_engine.edge_flags.
// The last step writes only each block's central window, straight into the
// (unextended) outputs, with no separate slice pass.  Offsets into the
// stacked buffers are 64-bit.
#pragma once

#include "step_walk.cuh"

namespace igg {

struct Chunk {
  Geo geo;     // the extended stacked buffers; modes FROZEN or WRAP
  int frz[3];  // 1 where the dim re-freezes from F
  int lo[3];   // freeze rows <= lo on blocks with c == 0
  int hi[3];   // freeze rows >= hi on blocks with c == n-1
  int last;    // 1: write the central windows into the outputs
  int off[3];  // row offset of the central window in an extended block
  int os[3];   // local extent of the outputs
  int OG[3];   // stacked extent of the target tensors
};

// cfg: n[3] s[3] (extended local extents) mode[3] (0 FROZEN, 1 WRAP)
//      frz[3] lo[3] hi[3] last off[3] os[3] (output local extents).
// Returns false on a mode other than FROZEN or WRAP.
inline bool make_chunk(const int* cfg, Chunk& c) {
  c.geo = make_geo(cfg);
  c.last = cfg[18];
  for (int d = 0; d < 3; ++d) {
    if (c.geo.mode[d] != FROZEN && c.geo.mode[d] != WRAP) return false;
    c.frz[d] = cfg[9 + d];
    c.lo[d] = cfg[12 + d];
    c.hi[d] = cfg[15 + d];
    c.off[d] = cfg[19 + d];
    c.os[d] = cfg[22 + d];
    c.OG[d] = c.last ? cfg[d] * cfg[22 + d] : c.geo.G[d];
  }
  return true;
}

__device__ __forceinline__ bool frozen(int g, int d, const Chunk& c) {
  if (!c.frz[d]) return false;
  const int b = block_of(g, d, c.geo);
  const int i = g - b * c.geo.s[d];
  return (b == 0 && i <= c.lo[d]) || (b == c.geo.n[d] - 1 && i >= c.hi[d]);
}

// Extended-buffer index of target index t along d.
__device__ __forceinline__ int ext_index(int t, int d, const Chunk& c) {
  if (!c.last) return t;
  const int b = c.geo.n[d] == 1 ? 0 : t / c.os[d];
  return b * c.geo.s[d] + (t - b * c.os[d]) + c.off[d];
}

template <class P, int VEC>
__global__ void __launch_bounds__(256)
    chunk_kernel(P ph, Chunk c, Fields<const typename P::T, P::NF> F,
                 Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  constexpr int NF = P::NF;
  const int t2 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int t1 = blockIdx.y * blockDim.y + threadIdx.y;
  const int t0 = blockIdx.z;
  if (t2 >= c.OG[2] || t1 >= c.OG[1]) return;
  const int e0 = ext_index(t0, 0, c), e1 = ext_index(t1, 1, c);
  const int e2 = ext_index(t2, 2, c);
  const Planes<T, NF> none{};
  Cells<T, NF, VEC> res = resolve_cells<P, VEC>(ph, c.geo, none, e0, e1, e2);
  const long long row = ((long long)e0 * c.geo.G[1] + e1) * c.geo.G[2];
  if (frozen(e0, 0, c) || frozen(e1, 1, c)) {
#pragma unroll
    for (int f = 0; f < NF; ++f) res.f[f] = load<T, VEC>(F.p[f] + row + e2);
  } else if (c.frz[2]) {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (frozen(e2 + v, 2, c)) {
#pragma unroll
        for (int f = 0; f < NF; ++f) res.f[f].v[v] = ld(F.p[f] + row + e2 + v);
      }
  }
  const long long o = ((long long)t0 * c.OG[1] + t1) * c.OG[2] + t2;
#pragma unroll
  for (int f = 0; f < NF; ++f) store(out.p[f] + o, res.f[f]);
}

template <class P, int VEC>
int launch_chunk_vec(const P& ph, const Chunk& c,
                     const Fields<const typename P::T, P::NF>& F,
                     const Fields<typename P::T, P::NF>& out,
                     cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((c.OG[2] / VEC + 31) / 32, (c.OG[1] + 7) / 8, c.OG[0]);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  chunk_kernel<P, VEC><<<grid, block, 0, stream>>>(ph, c, F, out);
  return (int)cudaGetLastError();
}

// Launch one chunk step: the vector path needs whole vectors in every z row
// of the buffers and, on the last step, a central z window that starts and
// ends on a vector.
template <class P>
int launch_chunk(const P& ph, const Chunk& c,
                 const Fields<const typename P::T, P::NF>& F,
                 const Fields<typename P::T, P::NF>& out, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(typename P::T);
  bool vec = c.geo.G[2] % VEC == 0 && c.OG[2] % VEC == 0 && ph.aligned(16);
  for (int f = 0; f < P::NF; ++f)
    vec = vec && aligned(F.p[f], 16) && aligned(out.p[f], 16);
  if (c.last) vec = vec && c.os[2] % VEC == 0 && c.off[2] % VEC == 0;
  if (vec) return launch_chunk_vec<P, VEC>(ph, c, F, out, stream);
  return launch_chunk_vec<P, 1>(ph, c, F, out, stream);
}

}  // namespace igg
