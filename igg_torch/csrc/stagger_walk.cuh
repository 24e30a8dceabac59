// The walk of a step over STAGGERED 2-D fields of a block-stacked grid,
// shared by the wave2d kernels (wave2d_step.cu, wave2d_chunk.cu) and the
// kernels generated from an igg_torch.stencil spec (igg_torch/stencil/
// cuda.py): one launch writes every cell of every field of a policy P from
// the source tensors alone, into targets that are the whole blocks (a step,
// or a chunk step on extended buffers) or a window of each block (the last
// step of a chunk).
//
// The policy (wave2d.cuh, or generated) provides:
//   - `using T`, `static constexpr int NF` (<= MAXF): element type, fields;
//   - `st(f, d)` (constexpr): 1 where field f is one cell longer along d
//     than the base (unstaggered) block, else 0;
//   - `freezes(f, d)` (constexpr): whether field f re-freezes on dim d
//     where a chunk's open dim freezes;
//   - `cell(g, i, j, at, row, want, out)`: the updated values of the
//     fields flagged in `want` at source-local cell (i, j) of a block, given
//     each field's offset of that cell in its source tensor (`at`) and its
//     row stride (`row`);
//   - `cells<VEC>(g, i, j, at, row, out)`: the same for every field at the
//     VEC cells (i, j .. j+VEC-1), all of which every field has.
//
// Layout: field f is a C-ordered (n0 * (e0 + st(f,0)), n1 * (e1 + st(f,1)))
// tensor of n0 x n1 blocks, where (e0, e1) is the base block of the sources
// (s) or of the targets (o); dim 1 is contiguous.  Offsets are 64-bit.
//
// A thread takes VEC cells (i, j .. j+VEC-1) of a block's bounding box
// (o0+1) x (o1+1) and writes the fields that have them, computing them at
// source index (i + off0, j + off1).  Where dim 1 is one periodic block
// (`wrap`), each field's edges j = 0 and j = size-1 take the updated values
// at the inner cells they alias, size-ol and ol-1, with the field's own
// overlap ol (the staggered self-wrap of chunk_engine.wrap_edges): fields
// whose alias agrees are computed together, the others on their own.  Where
// a dim freezes (`frz`, a chunk's open dims), the fields that freeze on it
// take the chunk-entry values F on the blocks of the global edges: rows
// <= lo on the first block, rows >= hi + st(f, d) on the last (each field's
// own staggered high plane); the freeze wins the cells it shares with a
// wrap (chunk_engine.window_step_plain).  Threads run along dim 1, so every
// access is coalesced.  A thread forms each field's offset once; the policy
// reaches the neighbours by adding strides.
#pragma once

#include "step_walk.cuh"

namespace igg {

// Fields a staggered walk takes at most (2-D and 3-D).
constexpr int MAXF = 8;

struct Stag {
  int n[2];      // blocks per dim
  int s[2];      // base block extents of the sources
  int wrap;      // 1: dim 1 is one periodic block, re-wrapped every step
  int off[2];    // source index of a block's target index 0
  int o[2];      // base block extents of the targets
  int frz[2];    // 1: the dim re-freezes from the chunk-entry buffers
  int lo[2];     // freeze rows <= lo on the first block
  int hi[2];     // freeze rows >= hi + st(f, d) on the last block
  int ol[MAXF];  // per-field overlap along dim 1 (the wrap's aliases)
};

// cfg = n[2] s[2] wrap off[2] o[2] frz[2] lo[2] hi[2] ol[MAXF].  Returns
// false on a layout the walk cannot take: an empty grid, a target window
// outside the source block, freeze rows outside the block, or a wrap on
// several blocks, on an offset window or with an overlap outside the field.
inline bool make_stag(const int* cfg, Stag& g) {
  for (int d = 0; d < 2; ++d) {
    g.n[d] = cfg[d];
    g.s[d] = cfg[2 + d];
    g.off[d] = cfg[5 + d];
    g.o[d] = cfg[7 + d];
    g.frz[d] = cfg[9 + d];
    g.lo[d] = cfg[11 + d];
    g.hi[d] = cfg[13 + d];
    if (g.n[d] < 1 || g.o[d] < 1 || g.off[d] < 0 || g.off[d] + g.o[d] > g.s[d])
      return false;
    if (g.frz[d] && (g.lo[d] < 0 || g.hi[d] > g.s[d] - 1 || g.lo[d] > g.hi[d]))
      return false;
  }
  g.wrap = cfg[4];
  for (int f = 0; f < MAXF; ++f) {
    g.ol[f] = cfg[15 + f];
    if (g.wrap && (g.ol[f] < 2 || g.ol[f] > g.s[1])) return false;
  }
  return !g.wrap || (g.n[1] == 1 && g.off[1] == 0 && g.o[1] == g.s[1]);
}

// Stacked offset of cell (i, j) of block (b0, b1) of a field staggered by
// (a, b) on base blocks e[0] x e[1], with n1 blocks along dim 1.
__device__ __forceinline__ long long stag_at(const int* e, int n1, int a,
                                             int b, int b0, int i, int b1,
                                             int j) {
  const long long w = e[1] + b;
  return ((long long)b0 * (e[0] + a) + i) * (n1 * w) + b1 * w + j;
}

__device__ __forceinline__ bool aligned_to(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// VEC values from p: one 16-byte load where p is aligned to it, else VEC
// scalar loads.
template <typename T, int VEC>
__device__ __forceinline__ void load_run(const T* p, T* v) {
  if (aligned_to(p, sizeof(T) * VEC)) {
    const Vec<T, VEC> w = load<T, VEC>(p);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = w.v[k];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = ld(p + k);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_run(T* p, const T* v) {
  if (aligned_to(p, sizeof(T) * VEC)) {
    Vec<T, VEC> w;
#pragma unroll
    for (int k = 0; k < VEC; ++k) w.v[k] = v[k];
    store<T, VEC>(p, w);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// Index that cell j of a one-block periodic dim of extent `size` takes its
// value from: 0 -> size-ol, size-1 -> ol-1, the others themselves.
__device__ __forceinline__ int wrap_alias(int j, int size, int ol) {
  return j == 0 ? size - ol : (j == size - 1 ? ol - 1 : j);
}

// Whether field f's source cell (si, sj) of block (b0, b1) takes its
// chunk-entry value.
template <class P>
__device__ __forceinline__ bool frozen2(const Stag& g, int f, int b0, int b1,
                                        int si, int sj) {
  const int b[2] = {b0, b1}, c[2] = {si, sj};
#pragma unroll
  for (int d = 0; d < 2; ++d)
    if (P::freezes(f, d) && g.frz[d] &&
        ((b[d] == 0 && c[d] <= g.lo[d]) ||
         (b[d] == g.n[d] - 1 && c[d] >= g.hi[d] + P::st(f, d))))
      return true;
  return false;
}

// One cell (i, j) of the bounding box of block (b0, b1): every field that
// has it, resolved through the per-field wrap aliases, then frozen.
template <class P>
__device__ __forceinline__ void walk_cell(
    const P& ph, const Stag& g, int b0, int i, int b1, int j,
    const Fields<const typename P::T, P::NF>& F,
    const Fields<typename P::T, P::NF>& out) {
  using T = typename P::T;
  constexpr int NF = P::NF;
  const int si = i + g.off[0], sj = j + g.off[1];  // source-local cell
  bool want[NF], done[NF];
  int jf[NF];
  long long at[NF], row[NF];  // source offset of (si, sj), row stride
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    want[f] = i < g.o[0] + P::st(f, 0) && j < g.o[1] + P::st(f, 1);
    done[f] = !want[f];
    jf[f] = g.wrap ? wrap_alias(sj, g.s[1] + P::st(f, 1), g.ol[f]) : sj;
    at[f] = stag_at(g.s, g.n[1], P::st(f, 0), P::st(f, 1), b0, si, b1, sj);
    row[f] = (long long)g.n[1] * (g.s[1] + P::st(f, 1));
  }
  T v[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (done[f]) continue;
    bool w[NF];
    long long af[NF];  // offsets of (si, jf[f])
#pragma unroll
    for (int h = 0; h < NF; ++h) {
      w[h] = !done[h] && jf[h] == jf[f];
      af[h] = at[h] + (jf[f] - sj);
    }
    T got[NF];
    ph.cell(g, si, jf[f], af, row, w, got);
#pragma unroll
    for (int h = 0; h < NF; ++h)
      if (w[h]) {
        v[h] = got[h];
        done[h] = true;
      }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (!want[f]) continue;
    if (frozen2<P>(g, f, b0, b1, si, sj)) v[f] = ld(F.p[f] + at[f]);
    out.p[f][stag_at(g.o, g.n[1], P::st(f, 0), P::st(f, 1), b0, i, b1, j)] =
        v[f];
  }
}

// Block (32, 8): a warp takes 32 runs of VEC cells of one row.  Grid: x =
// the column tiles of every block along dim 1, y = the row tiles of a
// block, z = the blocks along dim 0, so a thread finds its block and cells
// with one division per thread block.  A run whose VEC cells every field has and where no
// wrap alias applies (all but a block's last run and its wrap edges) takes
// the policy's `cells<VEC>`, with 16-byte loads and stores where the rows
// allow them; the others go cell by cell.
template <class P, int VEC>
__global__ void __launch_bounds__(256)
    stagger_kernel(P ph, Stag g, Fields<const typename P::T, P::NF> F,
                   Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  constexpr int NF = P::NF;
  const int h0 = g.o[0] + 1, h1 = g.o[1] + 1;  // a block's bounding box
  const int tiles = (h1 + 32 * VEC - 1) / (32 * VEC);
  const int b1 = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - b1 * tiles) * 32 * VEC + threadIdx.x * VEC;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b0 = blockIdx.z;
  if (j0 >= h1 || i >= h0) return;
  const int si = i + g.off[0], sj = j0 + g.off[1];
  if (i < g.o[0] && j0 + VEC <= g.o[1] &&
      (!g.wrap || (sj >= 1 && sj + VEC <= g.s[1] - 1))) {
    long long at[NF], row[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      at[f] = stag_at(g.s, g.n[1], P::st(f, 0), P::st(f, 1), b0, si, b1, sj);
      row[f] = (long long)g.n[1] * (g.s[1] + P::st(f, 1));
    }
    T v[NF][VEC];
    ph.template cells<VEC>(g, si, sj, at, row, v);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int m = 0; m < VEC; ++m)
        if (frozen2<P>(g, f, b0, b1, si, sj + m))
          v[f][m] = ld(F.p[f] + at[f] + m);
      store_run<T, VEC>(out.p[f] + stag_at(g.o, g.n[1], P::st(f, 0),
                                           P::st(f, 1), b0, i, b1, j0),
                        v[f]);
    }
    return;
  }
  for (int j = j0; j < j0 + VEC && j < h1; ++j)
    walk_cell(ph, g, b0, i, b1, j, F, out);
}

template <class P, int VEC>
int launch_stagger_vec(const P& ph, const Stag& g,
                       const Fields<const typename P::T, P::NF>& F,
                       const Fields<typename P::T, P::NF>& out,
                       cudaStream_t stream) {
  const long long tiles = (g.o[1] + 1 + 32 * VEC - 1) / (32 * VEC);
  const long long gx = tiles * g.n[1], gy = (g.o[0] + 1 + 7) / 8;
  if (gx > 0x7fffffffLL || gy > 65535 || g.n[0] > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(32, 8);
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)g.n[0]);
  stagger_kernel<P, VEC><<<grid, block, 0, stream>>>(ph, g, F, out);
  return (int)cudaGetLastError();
}

// F: the chunk-entry fields, read only where a dim freezes (any pointers
// otherwise).
template <class P>
int launch_stagger(const P& ph, const Stag& g,
                   const Fields<const typename P::T, P::NF>& F,
                   const Fields<typename P::T, P::NF>& out,
                   cudaStream_t stream) {
  static_assert(P::NF <= MAXF, "more fields than the walk takes");
  return launch_stagger_vec<P, 16 / sizeof(typename P::T)>(ph, g, F, out,
                                                           stream);
}

}  // namespace igg
