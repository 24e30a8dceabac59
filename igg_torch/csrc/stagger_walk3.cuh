// The layout of STAGGERED 3-D fields of a block-stacked grid (Stag3,
// make_stag3, at3) and the chunk's freeze rule (frozen3), shared by the
// x-marches that take it: the generated rank-3 kernels' march
// (stagger_band_march3.cuh: igg_spec_step's step and chunk modes and
// igg_spec_band_step's band mode, igg_torch/stencil/cuda.py) and the
// stokes3d kernels' (stokes_march.cuh, stokes_step.cu).  The 3-D sibling of
// stagger_walk.cuh's layout: it adds a third dim and wraps on y and z.  The
// walk these kernels first ran on (a thread a run of cells of every
// block's bounding box: stagger_xyz_kernel, walk_cell3, launch_stagger3)
// is kept as text in kernel_variants.py (FIRST_HEADERS:
// stagger_walk3_first.cuh), which the first designs build on.
//
// A policy of staggered 3-D fields provides:
//   - `using T`, `static constexpr int NF` (<= MAXF): element type, fields;
//   - `st(f, d)` (constexpr): 1 where field f is one cell longer along d
//     than the base (unstaggered) block, else 0;
//   - `freezes(f, d)` (constexpr): whether field f re-freezes on dim d
//     where a chunk's open dim freezes.
//
// Layout: field f is a C-ordered (n0*(e0+st(f,0)), n1*(e1+st(f,1)),
// n2*(e2+st(f,2))) tensor of n0 x n1 x n2 blocks, where (e0, e1, e2) is the
// base block of the sources (s) or of the targets (o); dim 2 is contiguous.
// A step or chunk step writes every cell of every field's targets (whole
// blocks, or each block's window [off, off + o + st(f, d)) per dim), cell c
// of the targets taking the value at source cell c + off.  Per dim:
//   - where y or z is one periodic block (`wrap`), each field's edges 0 and
//     size-1 take the updated values at the inner cells they alias,
//     size-ol and ol-1, with the field's own overlap ol (the staggered
//     self-wrap of chunk_engine.wrap_edges, y then z);
//   - where a dim freezes (`frz`, a chunk's open dims), the fields that
//     freeze on it take the chunk-entry values F on the blocks of the global
//     edges: rows <= lo on the first block, rows >= hi + st(f, d) on the
//     last (each field's own staggered high plane).  The freeze wins the
//     cells it shares with a wrap (chunk_engine.window_step_plain).
// A cell outside the base block (a staggered field's outer face row) keeps
// its source value (+0): no update reaches an outer face.
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
// false on a layout the kernels cannot take: an empty grid, a block under 3
// cells, a target window outside the source block, a wrap on x, on several
// blocks, on an offset window, on a dim that also freezes or with an
// overlap outside the field, or freeze rows outside the block.
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
                      g.o[d] != g.s[d] || g.frz[d]))
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

// frozen3's term of dim d: whether row c of block bl along d is one of
// field f's freeze rows.  (frozen3 keeps its own text: written through
// this function, it cost the Stokes chunk kernel four spill bytes and 4%
// on one 256^3 block, kernel_variants.py.)
template <class P>
__device__ __forceinline__ bool frozen_row3(const Stag3& g, int f, int d,
                                            int bl, int c) {
  return P::freezes(f, d) && g.frz[d] &&
         ((bl == 0 && c <= g.lo[d]) ||
          (bl == g.n[d] - 1 && c >= g.hi[d] + P::st(f, d)));
}

}  // namespace igg
