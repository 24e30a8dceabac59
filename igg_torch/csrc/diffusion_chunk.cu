// One step of a K-step trapezoid chunk: one launch advances every block of
// a block-stacked EXTENDED buffer (each block widened by K rows beyond
// both ends of every extended dim) by one diffusion step.
//
// Replaces the TPU kernel of igg/ops/diffusion_trapezoid.py (_kernel,
// _chunk_call; entry fused_diffusion_trapezoid_steps), which ran all K steps
// in one launch with VMEM ping-pong.  Here the chunk is K launches that
// ping-pong two device buffers (as the K-step loop of a one-block grid does);
// one launch per chunk with a grid-wide sync, or temporal blocking in
// shared memory, is later work.
//
// Per step, for every extended block (the rules of the TPU kernel and of its
// window realization igg/ops/diffusion_trapezoid.py:_window_steps_xla):
//   - every interior row is updated by the 7-point stencil; the outermost
//     rows of each extended block keep their values (shoulder garbage that
//     the shrinking validity never reads back into the central window);
//   - y/z dims in WRAP mode (periodic, one block, not extended) take the
//     updated inner plane, resolved as the fused step resolves it;
//   - then open dims re-freeze from F, the chunk-entry buffer: a "frozen"
//     dim (open, one block) its two boundary planes, an "oext" dim (open,
//     several blocks, extended) the rows <= lo and >= hi of the blocks on
//     the global edges.  The freeze wins the cells it shares with a wrap.
//     The edge flags of a block along d are (c == 0, c == n-1), which for a
//     one-block frozen dim sets both: the rule of chunk_engine.edge_flags.
// The last step writes only each block's central window, straight into the
// (unextended) output, with no separate slice pass.  The cell update itself
// is the fused step's (diffusion_common.cuh), with no halo received.
//
// What bounds it on the H100: bytes.  Per step it reads the extended T and
// A once and writes T once; at 8 blocks of 272^3 f32 (the 510^3 headline's
// 256^3 blocks extended by K = 8) that is 1.93 GB, 0.577 ms at 3.35 TB/s,
// against 0.481 ms for the unextended step.  The TPU kernel read A once per
// chunk from VMEM; here A_ext (643 MB) is read every step.
//
// What the design does about it: the fused step's layout (a thread per 16
// bytes of a z row, every access coalesced, neighbours from L1/L2), with
// the freeze and the window mapping resolved once per row.  Offsets into
// the stacked buffers are 64-bit.
#include "diffusion_common.cuh"

namespace {

struct Chunk {
  igg::Geo geo;  // the extended stacked buffer; modes FROZEN or WRAP
  int frz[3];    // 1 where the dim re-freezes from F
  int lo[3];     // freeze rows <= lo on blocks with c == 0
  int hi[3];     // freeze rows >= hi on blocks with c == n-1
  int last;      // 1: write the central windows into the output
  int off[3];    // row offset of the central window in an extended block
  int os[3];     // local extent of the output
  int OG[3];     // stacked extent of the target tensor
};

__device__ __forceinline__ bool frozen(int g, int d, const Chunk& c) {
  if (!c.frz[d]) return false;
  const int b = igg::block_of(g, d, c.geo);
  const int i = g - b * c.geo.s[d];
  return (b == 0 && i <= c.lo[d]) || (b == c.geo.n[d] - 1 && i >= c.hi[d]);
}

// Extended-buffer index of target index t along d.
__device__ __forceinline__ int ext_index(int t, int d, const Chunk& c) {
  if (!c.last) return t;
  const int b = c.geo.n[d] == 1 ? 0 : t / c.os[d];
  return b * c.geo.s[d] + (t - b * c.os[d]) + c.off[d];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    chunk_kernel(const T* __restrict__ src, const T* __restrict__ A,
                 const T* __restrict__ F, T* __restrict__ out, Chunk c,
                 igg::Coef<T> k) {
  const int t2 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int t1 = blockIdx.y * blockDim.y + threadIdx.y;
  const int t0 = blockIdx.z;
  if (t2 >= c.OG[2] || t1 >= c.OG[1]) return;
  const int e0 = ext_index(t0, 0, c), e1 = ext_index(t1, 1, c);
  const int e2 = ext_index(t2, 2, c);
  const igg::Planes<T> none{};
  igg::Vec<T, VEC> res =
      igg::resolve_cells<T, VEC>(src, A, c.geo, none, k, e0, e1, e2);
  const long long row = ((long long)e0 * c.geo.G[1] + e1) * c.geo.G[2];
  if (frozen(e0, 0, c) || frozen(e1, 1, c)) {
    res = igg::load<T, VEC>(F + row + e2);
  } else if (c.frz[2]) {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (frozen(e2 + v, 2, c)) res.v[v] = F[row + e2 + v];
  }
  *reinterpret_cast<igg::Vec<T, VEC>*>(
      out + ((long long)t0 * c.OG[1] + t1) * c.OG[2] + t2) = res;
}

template <typename T, int VEC>
int launch_chunk(const void* src, const void* A, const void* F, void* out,
                 const Chunk& c, const igg::Coef<T>& k, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((c.OG[2] / VEC + 31) / 32, (c.OG[1] + 7) / 8, c.OG[0]);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  chunk_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(A),
      static_cast<const T*>(F), static_cast<T*>(out), c, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* src, const void* A, const void* F, void* out,
           const Chunk& c, double cx, double cy, double cz, double cc,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const igg::Coef<T> k{(T)cx, (T)cy, (T)cz, (T)cc};
  const igg::Planes<T> none{};
  // The vector path needs whole vectors in every z row of the buffers and,
  // on the last step, a central z window that starts and ends on a vector.
  bool vec = igg::vector_ok<T, VEC>(c.geo, src, A, out, none) &&
             reinterpret_cast<uintptr_t>(F) % (sizeof(T) * VEC) == 0 &&
             c.OG[2] % VEC == 0;
  if (c.last) vec = vec && c.os[2] % VEC == 0 && c.off[2] % VEC == 0;
  if (vec) return launch_chunk<T, VEC>(src, A, F, out, c, k, stream);
  return launch_chunk<T, 1>(src, A, F, out, c, k, stream);
}

}  // namespace

// cfg: n[3] s[3] (extended local extents) mode[3] (0 FROZEN, 1 WRAP)
//      frz[3] lo[3] hi[3] last off[3] os[3] (output local extents);
// dtype: 0 float32, 1 float64.  F is the chunk-entry buffer, laid out like
// src; out is extended like src, or, when `last`, the unextended output.
extern "C" int igg_diffusion_chunk_step(const void* src, const void* A,
                                        const void* F, void* out, int dtype,
                                        const int* cfg, double cx, double cy,
                                        double cz, double cc, void* stream) {
  Chunk c;
  c.last = cfg[18];
  for (int d = 0; d < 3; ++d) {
    c.geo.n[d] = cfg[d];
    c.geo.s[d] = cfg[3 + d];
    c.geo.G[d] = cfg[d] * cfg[3 + d];
    c.geo.mode[d] = cfg[6 + d];
    if (c.geo.mode[d] != igg::FROZEN && c.geo.mode[d] != igg::WRAP)
      return (int)cudaErrorInvalidValue;
    c.frz[d] = cfg[9 + d];
    c.lo[d] = cfg[12 + d];
    c.hi[d] = cfg[15 + d];
    c.off[d] = cfg[19 + d];
    c.os[d] = cfg[22 + d];
    c.OG[d] = c.last ? cfg[d] * cfg[22 + d] : c.geo.G[d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(src, A, F, out, c, cx, cy, cz, cc, st);
  if (dtype == 1)
    return launch<double>(src, A, F, out, c, cx, cy, cz, cc, st);
  return (int)cudaErrorInvalidValue;
}
