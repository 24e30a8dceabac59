// The walk of a step over STAGGERED 3-D fields of a block-stacked grid,
// shared by the stokes3d kernels (stokes_step.cu, stokes_chunk.cu) and the
// rank-3 kernels generated from an igg_torch.stencil spec: one launch
// writes every cell of every field of a policy P from the source tensors
// alone, into targets that are the whole blocks (a step, or a chunk step on
// extended buffers) or a window of each block (the last step of a chunk).
// The 3-D sibling of stagger_walk.cuh: it adds a third dim and wraps on y
// and z.
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

#include "stagger_walk.cuh"

namespace igg {

struct Stag3 {
  int n[3];          // blocks per dim
  int s[3];          // base block extents of the sources
  int wrap[3];       // 1: the dim (y or z) is one periodic block, re-wrapped
  int off[3];        // source index of a block's target index 0
  int o[3];          // base block extents of the targets
  int frz[3];        // 1: the dim re-freezes from the chunk-entry buffers
  int lo[3];         // freeze rows <= lo on the first block
  int hi[3];         // freeze rows >= hi + st(f, d) on the last block
  int ol[MAXF][3];   // per-field overlap per dim (the wraps' aliases)
};

// cfg = n[3] s[3] wrap[3] off[3] o[3] frz[3] lo[3] hi[3] ol[MAXF][3].  Returns
// false on a layout the walk cannot take: an empty grid, a block under 3
// cells, a target window outside the source block, a wrap on x, on several
// blocks, on an offset window or with an overlap outside the field, or
// freeze rows outside the block.
inline bool make_stag3(const int* cfg, Stag3& g) {
  for (int d = 0; d < 3; ++d) {
    g.n[d] = cfg[d];
    g.s[d] = cfg[3 + d];
    g.wrap[d] = cfg[6 + d];
    g.off[d] = cfg[9 + d];
    g.o[d] = cfg[12 + d];
    g.frz[d] = cfg[15 + d];
    g.lo[d] = cfg[18 + d];
    g.hi[d] = cfg[21 + d];
    if (g.n[d] < 1 || g.s[d] < 3 || g.o[d] < 1 || g.off[d] < 0 ||
        g.off[d] + g.o[d] > g.s[d])
      return false;
    if (g.frz[d] && (g.lo[d] < 0 || g.hi[d] > g.s[d] - 1 || g.lo[d] > g.hi[d]))
      return false;
    if (g.wrap[d] && (d == 0 || g.n[d] != 1 || g.off[d] != 0 ||
                      g.o[d] != g.s[d]))
      return false;
  }
  for (int f = 0; f < MAXF; ++f)
    for (int d = 0; d < 3; ++d) {
      g.ol[f][d] = cfg[24 + 3 * f + d];
      if (g.wrap[d] && (g.ol[f][d] < 2 || g.ol[f][d] > g.s[d])) return false;
    }
  return true;
}

// Stacked offset of cell (i, j, k) of block (b0, b1, b2) of a field
// staggered by (a0, a1, a2) on base blocks e[0] x e[1] x e[2] of a grid of
// n blocks.
__device__ __forceinline__ long long at3(const int* e, const int* n, int a0,
                                         int a1, int a2, int b0, int i, int b1,
                                         int j, int b2, int k) {
  const long long w1 = e[1] + a1, w2 = e[2] + a2;
  return (((long long)b0 * (e[0] + a0) + i) * (n[1] * w1) + b1 * w1 + j) *
             (n[2] * w2) +
         b2 * w2 + k;
}

// Whether field f's source cell c of block b takes its chunk-entry value.
template <class P>
__device__ __forceinline__ bool frozen3(const Stag3& g, int f, const int* b,
                                        const int* c) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if (P::freezes(f, d) && g.frz[d] &&
        ((b[d] == 0 && c[d] <= g.lo[d]) ||
         (b[d] == g.n[d] - 1 && c[d] >= g.hi[d] + P::st(f, d))))
      return true;
  return false;
}

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
