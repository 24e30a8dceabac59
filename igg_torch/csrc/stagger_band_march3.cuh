// The x-march of the band entry generated for a rank-3 igg_torch.stencil
// spec (igg_torch/stencil/cuda.py: igg_spec_band_step; relax3d, the
// staggered acoustic3d and any spec the generator admits): one launch
// advances every extended block of block-stacked EXTENDED buffers by one
// iteration of every field of the spec's policy P, with the rules of the
// banded realization (igg/ops/chunk_engine.py: _streaming_kernel; its
// plain version igg_torch/ops/chunk_engine.py: banded_window_plain with the
// band core derived from the spec's evaluator).  Its first design, a
// thread block per band and (y, z) tile staging the band's window
// (stagger_band_walk3.cuh), is kept as text in kernel_variants.py.
//
// Semantics (the band walk's, per field f of P, on the layout Stag3 of
// make_stag3; stokes_march.cuh's band mode is the same for Stokes):
//   - the x planes a cell reads are clamped to f's own first and last rows
//     of the block (igg's rolling window of one device's buffer), and every
//     row x < s0 of the block is updated: the policy sees x through the
//     window of one band row (lo rows below it, lo above; the function does
//     not depend on the band depth B, so the march cuts x its own way);
//   - the band halo, resolved z, then y at the z-resolved cell, then x: a
//     WRAP dim's edge cells 0 and size - 1 of f (size its own extent) take
//     the value at the inner cell they alias (size - ol, ol - 1, f's own
//     overlap g.ol[f][d], so the alias of a field one longer along d sits
//     one row further in); an open dim's rows lo and hi + st(f, d) of the
//     edge blocks take the chunk-entry values F of the fields that freeze
//     on that dim (exactly those rows): F at the target on a z freeze row,
//     F at the source's row of a y wrap on a y or x freeze row;
//   - cells outside the base block along y and z (a staggered field's
//     outer face rows) take their source value + 0;
//   - the x-staggered fields' tail row x = s0 keeps its source value,
//     unresolved, so every launch writes every cell of its targets;
//   - the targets are the whole extended blocks, or (the last launch of a
//     chunk) each block's central window in the unextended outputs.
// The arithmetic is the policy's `mcells`, the spec's chain in the tree's
// association, each operation rounded as the plain version rounds it
// (-fmad=false).
//
// The march.  A thread block owns the tile of source rows [y0, y0 + TY) x
// [z0, z0 + TZ) of one block (32 x 16 cells, two a thread along y, where
// the policy stages one array; 16 x 16, one a thread, where it stages
// more: SbTile) over the targets' bounding box (the face rows of the staggered fields are tile rows like
// the others) and walks x over a segment [xa, xb).  Each staged array (the
// policy's NS: the fields) keeps its x planes in a ring in shared memory,
// each plane the tile and R = P::RADIUS cells around it; plane p lives in
// slot (p - xa + R) mod RING.  Before plane t the thread waits for its own
// copies of plane t + R and meets the block at its one barrier a plane,
// then starts the copies (cp.async) of plane t + R + 1 + AHEAD into the
// slot of plane t - R - 1, which the block read last before that barrier,
// and computes its cell of plane t from planes t - R .. t + R: the policy
// reads them through the ring offsets of those planes (`SbAt`), formed once
// a plane; a thread forms its staging offsets, its cell's in-plane
// offsets and its targets once for the whole march, and no element needs
// a division.  The ring holds 2R + 2 + AHEAD planes.
//
// Each cell computed once, at its source, written to every target that
// takes it: its own position and, where y or z wraps, the edge rows that
// alias it, per field (each field's own extent and overlap), corners
// included.  A thread resolves its cell's targets once as bits per field:
// y rows j, 0, size - 1 (bits 0-2) and z rows k, 0, size - 1 (bits 3-5),
// march_layout.cuh's rule; its y and z freeze rows (bits 6, 7).  A cell
// whose every field's one target is its own position takes the short
// path; the others (the wrap's edge and alias rows, the freeze rows) a
// loop over their bits.  No cell is recomputed, and no thread reads a cell
// another writes.
//
// Segments.  Where the tiles of a launch give fewer than SB_BLOCKS thread
// blocks, x is cut into segments of at least SB_MIN_SEG rows, one a thread
// block, each staging R planes beyond both of its ends.
//
// Shared memory a thread block holds: NS rings of 2R + 2 + AHEAD planes of
// (TY + 2R)(TZ + 2R) elements, whatever B: at R = 1 and AHEAD = 1, 3,060
// elements for one array (12,240 bytes in float32; relax3d) and 1,620 an
// array of several (25,920 bytes for acoustic3d's four in float32).  The
// gate the tier keeps (igg_torch/ops/_smem.py: banded_smem, the band
// walk's window of 2 lo + B >= 4R planes of (8 + 2R)(32 + 2R)) admits no
// launch the march refuses: for several arrays its 2R + 3 planes of
// (16 + 2R)^2 are fewer elements at R >= 2, and eight float64 fields take
// 103,680 bytes at R = 1; one array takes 84,480 bytes even at R = 4.
#pragma once

#include <type_traits>

#include "async_copy.cuh"
#include "stagger_walk3.cuh"

namespace igg {

constexpr int SB_TZ = 16;         // z cells of a tile row
constexpr int SB_NT = 256;        // threads of a thread block
// Own cells a thread (a column along y, the tile SB_NT / SB_TZ times as
// many rows): where the policy stages one array, as relax3d does, two
// cells share a plane's fixed work (the barrier, the staging, the planes'
// offsets and targets); where it stages more, one, as a second cell's
// chain would not fit the register bound.
constexpr int SB_CPT_ONE = 2;
constexpr int SB_CPT_MANY = 1;
constexpr int SB_BLOCKS = 8192;   // thread blocks below which x is cut
constexpr int SB_MIN_SEG = 8;     // fewest x rows of a segment
constexpr int SB_AHEAD = 1;       // planes in flight beyond the next one
// Thread blocks an SM holds at least (the register bound).
constexpr int SB_MIN_BLOCKS_F32 = 4;
constexpr int SB_MIN_BLOCKS_F64 = 3;
constexpr int SB_SMEM_MAX = 232448;     // the H100's opt-in limit a block
constexpr int SB_SMEM_DEFAULT = 49152;  // above it: the attribute
static_assert(SB_NT % SB_TZ == 0, "a thread takes whole cells of one column");

// The tile of a policy P: CPT own cells a thread, TY rows.
template <class P>
struct SbTile {
  static constexpr int CPT = P::NS == 1 ? SB_CPT_ONE : SB_CPT_MANY;
  static constexpr int TY = CPT * SB_NT / SB_TZ;
};

// The staged window of a policy of radius R over tiles of TY rows.
template <int R, int TY>
struct SbWin {
  static constexpr int WY = TY + 2 * R, WZ = SB_TZ + 2 * R;
  static constexpr int IN = WY * WZ;                 // a staged plane
  static constexpr int RING = 2 * R + 2 + SB_AHEAD;  // planes of a ring
  static constexpr int RS = RING * IN;               // one array's ring
  static constexpr int SPT = (IN + SB_NT - 1) / SB_NT;  // elements a thread
};

// The march's position, through which the policy's `mcells` and `mu<k>`
// read: element q of plane t + X of staged array k, on the staged window W
// (its row pitch WZ and ring size RS; the step and chunk modes' SxWin).
template <typename T, int R, int TY, class W = SbWin<R, TY>>
struct SbAt {
  static constexpr int WZ = W::WZ;
  const T* ring;      // the arrays' rings, [NS][RING][IN]
  int so[2 * R + 1];  // the ring offsets of planes t - R .. t + R
  template <int X>
  __device__ __forceinline__ T at(int k, int q) const {
    static_assert(X >= -R && X <= R, "a read beyond the staged radius");
    return ring[k * W::RS + so[X + R] + q];
  }
};

struct SbLayout {
  Stag3 g;           // make_stag3's layout: extended base block, targets
  int B;             // band depth (a gate of the layout only)
  int lo;            // rows the policy's window reads below a row
  int extra[MAXF];   // rows each staged array reads above a band
  int first[3];      // first source row with a target, per dim
  int rows[3];       // source rows with a target (x: the rows below s0)
  int tail;          // 1: the targets hold the tail row x = s0
  int ty, tz;        // tiles of a block along y and z
  int nseg, seg;     // x segments of a block, rows of a segment
};

// Stagger of staged array k along d: a field's own, or field 0's for a
// constant array.
template <class P>
__host__ __device__ constexpr int sb_st(int k, int d) {
  return k < P::NF ? P::st(k, d) : P::st(0, d);
}

// cfg: the layout of make_stag3 (24 + 3 * MAXF ints), then B, lo and
// extra[MAXF] (chunk_engine.stagger_band_cfg).  Returns false where the
// layout does not suit the band: the band depth does not divide the base x
// extent, or a read margin is below the window the policy's x tests
// assume (lo >= RADIUS, extra >= lo + stagger).
template <class P>
inline bool make_sb_layout(const int* cfg, SbLayout& b) {
  if (!make_stag3(cfg, b.g)) return false;
  constexpr int at = 24 + 3 * MAXF;
  b.B = cfg[at];
  b.lo = cfg[at + 1];
  for (int k = 0; k < MAXF; ++k) b.extra[k] = cfg[at + 2 + k];
  const Stag3& g = b.g;
  if (b.B < 1 || g.s[0] % b.B != 0 || b.lo < P::RADIUS) return false;
  for (int k = 0; k < P::NS; ++k)
    if (b.extra[k] < b.lo + sb_st<P>(k, 0)) return false;
  for (int d = 0; d < 3; ++d) {
    int mx = 0;
    for (int f = 0; f < P::NF; ++f) mx = P::st(f, d) > mx ? P::st(f, d) : mx;
    b.first[d] = g.off[d];
    b.rows[d] = g.o[d] + mx;
    if (d == 0) {
      b.tail = g.off[0] + b.rows[0] > g.s[0];
      if (b.tail) b.rows[0] = g.s[0] - g.off[0];
    }
  }
  return true;
}

// Elements of an x plane of a stacked array of layout L (bit 0: one cell
// longer along y, bit 1: along z) on base blocks e.
__host__ __device__ __forceinline__ long long sb_plane(const int* e,
                                                       const int* n, int L) {
  return (long long)n[1] * (e[1] + (L & 1)) * n[2] * (e[2] + (L >> 1));
}

// Whether row c of block bl along d is field f's freeze row of the band:
// exactly lo and hi + st(f, d) on the edge blocks of an open dim.
template <class P>
__device__ __forceinline__ bool sb_frozen(const Stag3& g, int f, int d,
                                          int bl, int c) {
  return P::freezes(f, d) && g.frz[d] &&
         ((bl == 0 && c == g.lo[d]) ||
          (bl == g.n[d] - 1 && c == g.hi[d] + P::st(f, d)));
}

// The targets of source row c of an extent `size` along a dim as bits
// (march_layout.cuh: march_target_bits): bit 0 the row itself (a wrap:
// 1 <= c <= size - 2; else where the target window [off, off + o) holds
// it), bit 1 row 0 (a wrap: c == size - ol), bit 2 row size - 1 (a wrap:
// c == ol - 1).
__device__ __forceinline__ unsigned sb_targets(int c, int wrap, int off,
                                               int o, int size, int ol) {
  if (!wrap) return c >= off && c < off + o;
  return (c >= 1 && c <= size - 2) | (c == size - ol) << 1 |
         (c == ol - 1) << 2;
}

// Field f's value v at source plane t of a cell (j, k) whose targets are
// more than its own position (bits: sb_targets along y and z, the y and z
// freeze rows; module note), to each of them: `op` the target's x plane,
// `fp` F's, `fx` whether plane t is an x freeze row.  band_halo's order: F
// at the target's y where z froze, else at the source.
template <class P>
__device__ __forceinline__ void sb_put(const Stag3& g, const int* b, int f,
                                       int j, int k, unsigned t,
                                       typename P::T* op,
                                       const typename P::T* fp, bool fx,
                                       typename P::T v) {
  using T = typename P::T;
  const int sy = P::st(f, 1), sz = P::st(f, 2);
  const int n1 = g.s[1] + sy, n2 = g.s[2] + sz;
  const long long w1o = g.o[1] + sy, w2o = g.o[2] + sz;
  const long long w1s = n1, w2s = n2;
  const bool fz = t >> 7 & 1u, fr = fz || (t >> 6 & 1u) || fx;
  for (unsigned ym = t & 7u; ym; ym &= ym - 1) {
    const int ay = __ffs(ym) - 1;
    const int ys = ay == 0 ? j : ay == 1 ? 0 : n1 - 1;
    const T u = fr ? ld(fp + ((b[1] * w1s + (fz ? ys : j)) * (g.n[2] * w2s) +
                              b[2] * w2s + k))
                   : v;
    const long long row = (b[1] * w1o + ys - g.off[1]) * (g.n[2] * w2o) +
                          b[2] * w2o - g.off[2];
    for (unsigned zm = t >> 3 & 7u; zm; zm &= zm - 1) {
      const int az = __ffs(zm) - 1;
      op[row + (az == 0 ? k : az == 1 ? 0 : n2 - 1)] = u;
    }
  }
}

template <class P>
__global__ void __launch_bounds__(SB_NT, sizeof(typename P::T) == 4
                                             ? SB_MIN_BLOCKS_F32
                                             : SB_MIN_BLOCKS_F64)
    stag_march_kernel(P ph, SbLayout bd, Fields<const typename P::T, P::NF> F,
                      Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  constexpr int NF = P::NF, NS = P::NS, R = P::RADIUS;
  constexpr int TY = SbTile<P>::TY, CPT = SbTile<P>::CPT;
  using W = SbWin<R, TY>;
  constexpr int TZ = SB_TZ, NT = SB_NT, WZ = W::WZ, IN = W::IN;
  constexpr int RING = W::RING, NR = NT / TZ, AH = SB_AHEAD;
  extern __shared__ __align__(16) unsigned char sb_smem[];
  T* const ring = reinterpret_cast<T*>(sb_smem);
  const Stag3& g = bd.g;
  const int tid = threadIdx.x;
  const int b[3] = {(int)blockIdx.z / bd.nseg, (int)blockIdx.y / bd.ty,
                    (int)blockIdx.x / bd.tz};
  const int seg = blockIdx.z - b[0] * bd.nseg;
  const int y0 = bd.first[1] + (blockIdx.y - b[1] * bd.ty) * TY;
  const int z0 = bd.first[2] + (blockIdx.x - b[2] * bd.tz) * TZ;
  const int xa = bd.first[0] + seg * bd.seg;
  const int xend = bd.first[0] + bd.rows[0];
  const int xb = xa + bd.seg < xend ? xa + bd.seg : xend;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];

  // What the thread stages: its elements of a plane, their in-plane source
  // offsets per layout L and whether they lie inside the layout's block
  // (bit 4m + L; an x plane of a stacked array holds fewer than 2^31
  // elements: launch_stag_march).
  int soff[W::SPT][4];
  unsigned sok = 0;
#pragma unroll
  for (int m = 0; m < W::SPT; ++m) {
    const int e = tid + m * NT;
    const int j = y0 - R + e / WZ, k = z0 - R + e % WZ;
#pragma unroll
    for (int L = 0; L < 4; ++L) {
      const int w1 = s1 + (L & 1), w2 = s2 + (L >> 1);
      soff[m][L] = (b[1] * w1 + j) * (g.n[2] * w2) + b[2] * w2 + k;
      if (e < IN && j >= 0 && j < w1 && k >= 0 && k < w2)
        sok |= 1u << (4 * m + L);
    }
  }
  // Plane p of every staged array (clamped to the array's own x rows of
  // the block) into slot `slot` of its ring, zeros outside the array.
  auto stage = [&](int p, int slot) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int a0 = sb_st<P>(k, 0);
      const int L = sb_st<P>(k, 1) | sb_st<P>(k, 2) << 1;
      const T* const src = ph.staged(k);
      const T* const base =
          src + ((long long)b[0] * (s0 + a0) + march_clamp(p, 0, s0 - 1 + a0)) *
                    sb_plane(g.s, g.n, L);
      T* const dst = ring + k * W::RS + slot * IN;
#pragma unroll
      for (int m = 0; m < W::SPT; ++m) {
        const int e = tid + m * NT;
        if (e >= IN) break;
        const bool in = sok >> (4 * m + L) & 1u;
        march_copy(dst + e, in ? base + soff[m][L] : src, in);
      }
    }
  };

  // The thread's own cells (rows oa + n NR of column oc): their in-plane
  // staged offset q, their targets per field (bits 0-7: the module note;
  // bit 8: the target window holds the cell's own position, the tail
  // row's target) and in-plane target and source offsets per layout.
  const int oc = tid % TZ, k = z0 + oc;
  int j[CPT], q[CPT], ino[CPT][4], ins[CPT][4];
  unsigned tb[CPT][NF];
  bool mine[CPT], simple[CPT];
#pragma unroll
  for (int n = 0; n < CPT; ++n) {
    const int oa = tid / TZ + n * NR;
    j[n] = y0 + oa;
    q[n] = (oa + R) * WZ + oc + R;
    mine[n] = false;
    simple[n] = true;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int sy = P::st(f, 1), sz = P::st(f, 2);
      const int n1 = s1 + sy, n2 = s2 + sz;
      unsigned t = 0;
      if (j[n] < n1 && k < n2) {
        t = sb_targets(j[n], g.wrap[1], g.off[1], g.o[1] + sy, n1,
                       g.ol[f][1]) |
            sb_targets(k, g.wrap[2], g.off[2], g.o[2] + sz, n2,
                       g.ol[f][2]) << 3 |
            (unsigned)sb_frozen<P>(g, f, 1, b[1], j[n]) << 6 |
            (unsigned)sb_frozen<P>(g, f, 2, b[2], k) << 7;
        const int t1 = j[n] - g.off[1], t2 = k - g.off[2];
        if (t1 >= 0 && t1 < g.o[1] + sy && t2 >= 0 && t2 < g.o[2] + sz)
          t |= 1u << 8;
      }
      tb[n][f] = t;
      const bool any = (t & 7u) && (t >> 3 & 7u);
      mine[n] = mine[n] || any;
      if (any && (t & 255u) != 9u) simple[n] = false;
    }
#pragma unroll
    for (int L = 0; L < 4; ++L) {
      const int w1o = g.o[1] + (L & 1), w2o = g.o[2] + (L >> 1);
      const int w1s = s1 + (L & 1), w2s = s2 + (L >> 1);
      ino[n][L] = (b[1] * w1o + j[n] - g.off[1]) * (g.n[2] * w2o) +
                  b[2] * w2o + k - g.off[2];
      ins[n][L] = (b[1] * w1s + j[n]) * (g.n[2] * w2s) + b[2] * w2s + k;
    }
  }

  // The policy's view along x: the window of one band row, row lo of
  // 2 lo + 1 (its x tests, which every row of a band passes alike).
  Stag3 gw = g;
  gw.s[0] = 2 * bd.lo + 1;
  const int len = xb - xa, total = len + 2 * R;
  // Plane xa - R + i lives in slot i % RING.  Step v (plane t = xa + v)
  // reads the slots of planes v .. v + 2R; before it the thread waits for
  // its copies of plane v + 2R, meets the others at the barrier and stages
  // plane v + 2R + 1 + AH into the slot of plane v - 1, read last before
  // this barrier.
#pragma unroll
  for (int i = 0; i <= 2 * R + AH; ++i) {
    if (i < total) stage(xa - R + i, i);
    march_commit();
  }
  int sv = 0, sn = RING - 1;  // the slots of plane v and of the next staged
  for (int v = 0; v < len; ++v) {
    march_wait<AH>();
    __syncthreads();
    if (v + 2 * R + 1 + AH < total) stage(xa + v + R + 1 + AH, sn);
    march_commit();
    sn = sn + 1 < RING ? sn + 1 : 0;
    SbAt<T, R, TY> m;
    m.ring = ring;
#pragma unroll
    for (int x = 0; x <= 2 * R; ++x)
      m.so[x] = (sv + x < RING ? sv + x : sv + x - RING) * IN;
    sv = sv + 1 < RING ? sv + 1 : 0;
    const int t = xa + v;
    // Plane t of each field's target (none where the target window does
    // not hold it) and of F; whether it is an x freeze row.
    T* op[NF];
    const T* fp[NF];
    unsigned fx = 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int a0 = P::st(f, 0), L = P::st(f, 1) | P::st(f, 2) << 1;
      const int tx = t - g.off[0];
      op[f] = tx >= 0 && tx < g.o[0] + a0
                  ? out.p[f] + ((long long)b[0] * (g.o[0] + a0) + tx) *
                                   sb_plane(g.o, g.n, L)
                  : nullptr;
      fp[f] = F.p[f] + ((long long)b[0] * (s0 + a0) + t) * sb_plane(g.s, g.n, L);
      if (sb_frozen<P>(g, f, 0, b[0], t)) fx |= 1u << f;
    }
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      if (!mine[n]) continue;
      T val[NF];
      if (j[n] < s1 && k < s2) {
        ph.mcells(gw, bd.lo, j[n], k, m, q[n], val);
      } else {  // an outer face row: no update reaches it
#pragma unroll
        for (int f = 0; f < NF; ++f)
          val[f] = m.template at<0>(f, q[n]) + T(0);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const unsigned tf = tb[n][f];
        if (op[f] == nullptr || !(tf & 7u) || !(tf >> 3 & 7u)) continue;
        const int L = P::st(f, 1) | P::st(f, 2) << 1;
        if (simple[n])
          op[f][ino[n][L]] = fx >> f & 1u ? ld(fp[f] + ins[n][L]) : val[f];
        else
          sb_put<P>(g, b, f, j[n], k, tf, op[f], fp[f], fx >> f & 1u,
                    val[f]);
      }
    }
  }
  // The x-staggered fields' tail row x = s0: its source values, at their
  // own positions.
  if (bd.tail && xb == xend) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (!P::st(f, 0)) continue;
      const int L = P::st(f, 1) | P::st(f, 2) << 1;
      T* const tp = out.p[f] + ((long long)b[0] * (g.o[0] + 1) + s0 -
                                g.off[0]) *
                                   sb_plane(g.o, g.n, L);
      const T* const sp =
          ph.src[f] + ((long long)b[0] * (s0 + 1) + s0) * sb_plane(g.s, g.n, L);
#pragma unroll
      for (int n = 0; n < CPT; ++n)
        if (tb[n][f] >> 8 & 1u) tp[ino[n][L]] = ld(sp + ins[n][L]);
    }
  }
}

// Bytes of shared memory one thread block holds.
template <class P>
constexpr size_t sb_smem_bytes() {
  return sizeof(typename P::T) * (size_t)P::NS *
         SbWin<P::RADIUS, SbTile<P>::TY>::RS;
}

// Launch one banded iteration: thread blocks of SB_NT threads over (z
// tiles, y tiles, x segments) of every block; above 48 KB of shared memory
// the kernel opts in first.
template <class P>
int launch_stag_march(const P& ph, SbLayout bd,
                      const Fields<const typename P::T, P::NF>& F,
                      const Fields<typename P::T, P::NF>& out,
                      cudaStream_t stream) {
  static_assert(P::NF <= MAXF && P::NS <= MAXF && P::NS >= P::NF,
                "the march stages the fields, then constant arrays");
  const Stag3& g = bd.g;
  bd.ty = (bd.rows[1] + SbTile<P>::TY - 1) / SbTile<P>::TY;
  bd.tz = (bd.rows[2] + SB_TZ - 1) / SB_TZ;
  const int rows = bd.rows[0];
  const long long tiles = (long long)bd.ty * bd.tz * g.n[0] * g.n[1] * g.n[2];
  long long nseg = (SB_BLOCKS + tiles - 1) / tiles;
  const long long most = rows / SB_MIN_SEG > 1 ? rows / SB_MIN_SEG : 1;
  if (nseg > most) nseg = most;
  bd.seg = (int)((rows + nseg - 1) / nseg);
  bd.nseg = (rows + bd.seg - 1) / bd.seg;
  const long long gx = (long long)bd.tz * g.n[2], gy = (long long)bd.ty * g.n[1];
  const long long gz = (long long)bd.nseg * g.n[0];
  if (gx > 0x7fffffffLL || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidConfiguration;
  for (int L = 0; L < 4; ++L)  // in-plane offsets are 32-bit
    if (sb_plane(g.s, g.n, L) > 0x7fffffffLL ||
        sb_plane(g.o, g.n, L) > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  const size_t bytes = sb_smem_bytes<P>();
  if (bytes > (size_t)SB_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (bytes > (size_t)SB_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        stag_march_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  stag_march_kernel<P><<<grid, SB_NT, bytes, stream>>>(ph, bd, F, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The step and chunk modes: the march of igg_spec_step
// ---------------------------------------------------------------------------
//
// The generated entry igg_spec_step (the fused step, row 13 of PERF.md's
// table, and the chunk step, row 12's spec instances) runs on the same
// march with the walk's edge rules (stagger_walk3.cuh's layout Stag3 and
// semantics, chunk_engine.window_step_plain; its first design, a thread a
// run of cells of every block's bounding box, is kept as text in
// kernel_variants.py): per field f of P,
//   - x is not clamped: the policy sees the true x and extent of the
//     (extended) block, and its write-region tests leave each field's
//     outer x rows at old + T(0), so no plane beyond the block is read
//     (the march clamps what it stages all the same);
//   - a wrapped y or z (one periodic block) gives f's edge cells 0 and
//     size - 1 the updated values at the inner cells they alias, size - ol
//     and ol - 1 (f's own extent and overlap g.ol[f][d]), corners included;
//   - an open dim of a chunk gives the fields that freeze on it their
//     chunk-entry value F at the target cell on every row <= lo of the
//     first block and >= hi + st(f, d) of the last (ranges: frozen3); a
//     freeze wins the cells it shares with a wrap;
//   - a cell outside the base block along any dim (a staggered field's
//     outer face row, x = s0 included) takes its source value + 0;
//   - the targets are the whole blocks, or (a chunk's last launch) each
//     block's central window.
// A thread block owns a (y, z) tile of the targets' source rows of one
// block, TY = NR x CPT rows of TZ cells (a thread CPT cells of one z
// column on adjacent y rows: SxTile), and walks x over a segment, as the
// band mode does: each staged array's planes in a ring of 2R + 2 + AHEAD
// by cp.async, its staging offsets formed once, one barrier a plane, the
// policy's `mcells` reading the ring through the offsets of planes
// t - R .. t + R (SbAt on the window SxWin).  A thread computes its CPT
// cells before it writes any, so the loads its cells share (a cell's y
// neighbour is the next one's centre) can be formed once, and writes each
// cell's value at its own position, or F there where the cell freezes.
// Its targets are resolved once as bits per field (sx_bits: sb_targets,
// the freeze rows as ranges).
//
// The wraps' edge rows.  A cell on an alias row of a wrap (size - ol or
// ol - 1 of a field along y or z) has targets besides its own position:
// the field's edge rows 0 or size - 1, corners included.  Written by the
// cell's own tile, they made the lanes of a tile's first and last z
// column, and so the whole thread block at its next barrier, wait: they
// cost a third of relax3d's chunk step (kernel_variants.py
// sx_no_wrap_writes, PERF.md).  So the launch holds thread blocks beyond
// the tiles (the last ones along grid x) that take the alias cells alone,
// a thread a cell of a plane, compute each as the march does (the policy
// reading device memory through SxDirect centred on the cell: the same
// operations, so the same bits) and write it to those other targets
// (sx_edges, sx_put); a freeze there takes F at the target, and a target
// freezes as its cell does, since a dim that wraps does not freeze.  Every
// target is still written once.
//
// Two edge modes, chosen by the launcher from the layout: the step mode
// (no wrap and no freeze: the fused step, and the chunk steps of layouts
// extended on every dim) writes each field at its own position and reads
// no F; the chunk mode adds the freezes and the edge blocks.  Where the
// ring would not fit a thread block's shared memory, or a plane's offsets
// 32 bits (a spec of many arrays or a large read radius), the chunk mode
// runs with no ring, every read from device memory (SxDirect, 64-bit
// offsets): the march refuses no layout that make_stag3 takes.

constexpr int SX_NT = 256;          // threads of a thread block
constexpr int SX_TZ = 32;           // z cells of a tile row
// Cells a thread (adjacent y rows of its z column): where the policy
// stages one array (in float32, in float64), and where it stages more.
constexpr int SX_CPT_ONE = 4;
constexpr int SX_CPT_ONE_F64 = 2;
constexpr int SX_CPT_MANY = 2;
constexpr int SX_BLOCKS = 2048;     // thread blocks below which x is cut
constexpr int SX_MIN_SEG = 8;       // fewest x rows of a segment
constexpr int SX_AHEAD = 1;         // planes in flight beyond the next one
// Thread blocks an SM holds at least (the register bound), where the
// policy stages one array and where it stages more (in float32, the step
// mode's and the chunk mode's).
constexpr int SX_MIN_BLOCKS_F32 = 4;
constexpr int SX_MIN_BLOCKS_F64 = 3;
constexpr int SX_MIN_BLOCKS_MANY_F32 = 4;
constexpr int SX_MIN_BLOCKS_MANY_CHUNK_F32 = 2;
constexpr int SX_MIN_BLOCKS_MANY_F64 = 2;
// Bytes of a thread block's rings at most; above, the march runs with no
// ring (SxDirect).
constexpr int SX_SMEM_MAX = SB_SMEM_MAX;

// The tile of a policy P: TZ cells a row, NR rows of threads, CPT cells a
// thread, TY rows; MINB thread blocks an SM at least in the mode.
template <class P, bool STEP>
struct SxTile {
  static constexpr int TZ = SX_TZ;
  static constexpr int NR = SX_NT / TZ;
  static constexpr bool F32 = sizeof(typename P::T) == 4;
  static constexpr int CPT =
      P::NS == 1 ? (F32 ? SX_CPT_ONE : SX_CPT_ONE_F64) : SX_CPT_MANY;
  static constexpr int TY = NR * CPT;
  static constexpr int MINB =
      P::NS == 1 ? (F32 ? SX_MIN_BLOCKS_F32 : SX_MIN_BLOCKS_F64)
      : !F32     ? SX_MIN_BLOCKS_MANY_F64
      : STEP     ? SX_MIN_BLOCKS_MANY_F32
                 : SX_MIN_BLOCKS_MANY_CHUNK_F32;
  static_assert(SX_NT % TZ == 0, "a tile row is whole thread rows");
};

// The staged window of a tile of TY x TZ cells at radius R: rows of WZ
// cells (R halo cells on each side), a ring of RING planes of IN elements
// an array; SPT elements of a plane a thread.
template <int R, int TY, int TZ>
struct SxWin {
  static constexpr int WY = TY + 2 * R, WZ = TZ + 2 * R;
  static constexpr int IN = WY * WZ;
  static constexpr int RING = 2 * R + 2 + SX_AHEAD;
  static constexpr int RS = RING * IN;
  static constexpr int SPT = (IN + SX_NT - 1) / SX_NT;
};

// The position of the march with no ring: element q of the window (row
// q / WZ, column q % WZ) of plane t + X of staged array k, read from
// device memory.  o[k]: array k's offset of plane t's window cell (0, 0).
template <typename T, int R, class W, int NS>
struct SxDirect {
  static constexpr int WZ = W::WZ;
  const T* base[NS];
  long long o[NS], ps[NS], pitch[NS];  // plane t's window; x and y strides
  template <int X>
  __device__ __forceinline__ T at(int k, int q) const {
    static_assert(X >= -R && X <= R, "a read beyond the policy's radius");
    return ld(base[k] + (o[k] + X * ps[k] + (long long)(q / WZ) * pitch[k] +
                         q % WZ));
  }
};

template <bool RING>
struct SxIndex {
  using type = long long;
};
template <>
struct SxIndex<true> {
  using type = int;
};

struct SxLayout {
  Stag3 g;           // make_stag3's layout
  int first[3];      // first source row with a target, per dim
  int rows[3];       // source rows with a target, per dim
  int ty, tz;        // tiles of a block along y and z
  int nseg, seg;     // x segments of a block, rows of a segment
  int ney, nez;      // the wraps' alias rows along y and along z
  int ey[2 * MAXF], ez[2 * MAXF];  // (size - ol and ol - 1 of each field)
};

// The layouts of P's staged arrays, bit L (bit 0 of L: one cell longer
// along y, bit 1: along z).
template <class P>
__host__ __device__ constexpr unsigned sx_layouts() {
  unsigned m = 0;
  for (int k = 0; k < P::NS; ++k)
    m |= 1u << (sb_st<P>(k, 1) | sb_st<P>(k, 2) << 1);
  return m;
}

// A field's value v at a cell (j, k) of plane t to its targets other than
// its own position (bits 0-5 of `t`: sb_targets along y and z; a wrap's
// targets lie in the cell's own block and plane, rows 0 or n - 1 of the
// wrapped dims), or, where the cell is frozen (`fr`), its chunk-entry value
// F at each target: a dim that wraps does not freeze (make_stag3), so a
// wrap's targets freeze as the cell does.  `op` and `fp`: the target's and
// F's plane t; `to` and `so`: the cell's in-plane offsets in them; `po`
// and `ps`: their y pitches.
template <typename T, typename I>
__device__ __forceinline__ void sx_put(unsigned t, int j, int k, int n1,
                                       int n2, I to, I so, I po, I ps, T* op,
                                       const T* fp, bool fr, T v) {
  for (unsigned ym = t & 7u; ym; ym &= ym - 1) {
    const int ay = __ffs(ym) - 1;
    const int dy = ay == 0 ? 0 : ay == 1 ? -j : n1 - 1 - j;
    for (unsigned zm = (t >> 3 & 7u) & (ay == 0 ? 6u : 7u); zm;
         zm &= zm - 1) {
      const int az = __ffs(zm) - 1;
      const int dz = az == 0 ? 0 : az == 1 ? -k : n2 - 1 - k;
      op[to + dy * po + dz] = fr ? ld(fp + (so + dy * ps + dz)) : v;
    }
  }
}

// The targets of source cell (j, k) of block b, 8 bits a field: bits 0-7
// as in the band mode (sb_targets along y and z, the y and z freeze rows as
// ranges) where the cell has a target along both, else 0; the step mode's
// only target is the cell's own position (bit 0 | bit 3).
template <class P, bool STEP, typename Bits>
__device__ __forceinline__ Bits sx_bits(const Stag3& g, const int* b, int j,
                                        int k, int yend, int zend) {
  Bits tb = 0;
  if (j >= yend || k >= zend) return tb;
#pragma unroll
  for (int f = 0; f < P::NF; ++f) {
    const int sy = P::st(f, 1), sz = P::st(f, 2);
    const int n1 = g.s[1] + sy, n2 = g.s[2] + sz;
    unsigned t = 0;
    if (STEP) {
      if (j - g.off[1] < g.o[1] + sy && k - g.off[2] < g.o[2] + sz) t = 9u;
    } else if (j < n1 && k < n2) {
      t = sb_targets(j, g.wrap[1], g.off[1], g.o[1] + sy, n1, g.ol[f][1]) |
          sb_targets(k, g.wrap[2], g.off[2], g.o[2] + sz, n2, g.ol[f][2])
              << 3 |
          (unsigned)frozen_row3<P>(g, f, 1, b[1], j) << 6 |
          (unsigned)frozen_row3<P>(g, f, 2, b[2], k) << 7;
      if (!(t & 7u) || !(t >> 3 & 7u)) t = 0;  // no target
    }
    tb |= (Bits)t << (8 * f);
  }
  return tb;
}

// The wraps' edge rows, taken by the thread blocks beyond the tiles (the
// launch's last ones along grid x): a thread an alias source cell of a
// plane (each of the ly.ney alias rows along y by every column of the
// targets, then every row by each of the ly.nez alias columns along z), its
// value computed as the march computes it, with the policy's reads from
// device memory (SxDirect centred on the cell), and written to the cell's
// targets other than its own position (sx_put), which its tile writes.
template <class P, typename Bits>
__device__ __forceinline__ void sx_edges(
    const P& ph, const SxLayout& ly,
    const Fields<const typename P::T, P::NF>& F,
    const Fields<typename P::T, P::NF>& out) {
  using T = typename P::T;
  constexpr int NF = P::NF, NS = P::NS, R = P::RADIUS;
  using W = SxWin<R, 1, 1>;
  const Stag3& g = ly.g;
  const int tiles = ly.tz * g.n[2];
  const long long e =
      (((long long)blockIdx.z * gridDim.y + blockIdx.y) * (gridDim.x - tiles) +
       (blockIdx.x - tiles)) * SX_NT + threadIdx.x;
  const long long zi = (long long)ly.ney * g.n[2] * ly.rows[2];
  const long long per = zi + (long long)ly.nez * g.n[1] * ly.rows[1];
  const long long p = e / per;
  if (p >= (long long)g.n[0] * ly.rows[0]) return;
  long long i = e - p * per;
  int b[3] = {(int)(p / ly.rows[0]), 0, 0}, j, k;
  const int t = ly.first[0] + (int)(p - (long long)b[0] * ly.rows[0]);
  if (i < zi) {
    const long long w = (long long)g.n[2] * ly.rows[2];
    j = ly.ey[i / w];
    i %= w;
    b[2] = (int)(i / ly.rows[2]);
    k = ly.first[2] + (int)(i % ly.rows[2]);
  } else {
    i -= zi;
    const long long w = (long long)g.n[1] * ly.rows[1];
    k = ly.ez[i / w];
    i %= w;
    b[1] = (int)(i / ly.rows[1]);
    j = ly.first[1] + (int)(i % ly.rows[1]);
  }
  const Bits tb = sx_bits<P, false, Bits>(g, b, j, k, ly.first[1] + ly.rows[1],
                                          ly.first[2] + ly.rows[2]);
  bool any = false;
#pragma unroll
  for (int f = 0; f < NF; ++f) any = any || (tb >> (8 * f) & 54u);
  if (!any) return;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
  SxDirect<T, R, W, NS> m;
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    const int L = sb_st<P>(kk, 1) | sb_st<P>(kk, 2) << 1;
    const long long w1 = s1 + (L & 1), w2 = s2 + (L >> 1);
    m.base[kk] = ph.staged(kk);
    m.ps[kk] = sb_plane(g.s, g.n, L);
    m.pitch[kk] = g.n[2] * w2;
    m.o[kk] = ((long long)b[0] * (s0 + sb_st<P>(kk, 0)) + t) * m.ps[kk] +
              (b[1] * w1 + j - R) * m.pitch[kk] + b[2] * w2 + k - R;
  }
  const int q = R * W::WZ + R;
  T val[NF];
  if (t < s0 && j < s1 && k < s2) {
    ph.mcells(g, t, j, k, m, q, val);
  } else {  // an outer face row: no update reaches it
#pragma unroll
    for (int f = 0; f < NF; ++f)
      val[f] = tb >> (8 * f) & 54u && t < s0 + P::st(f, 0)
                   ? m.template at<0>(f, q) + T(0)
                   : T(0);
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const unsigned tf = (unsigned)(tb >> (8 * f)) & 255u;
    const int a0 = P::st(f, 0), sy = P::st(f, 1), sz = P::st(f, 2);
    const int L = sy | sz << 1, tx = t - g.off[0];
    if (!(tf & 54u) || tx < 0 || tx >= g.o[0] + a0) continue;
    const long long w1o = g.o[1] + sy, w2o = g.o[2] + sz;
    const long long w1s = s1 + sy, w2s = s2 + sz;
    const long long po = g.n[2] * w2o, ps = g.n[2] * w2s;
    T* const op = out.p[f] + ((long long)b[0] * (g.o[0] + a0) + tx) *
                                 sb_plane(g.o, g.n, L);
    const T* const fp =
        F.p[f] + ((long long)b[0] * (s0 + a0) + t) * sb_plane(g.s, g.n, L);
    const bool fr = frozen_row3<P>(g, f, 0, b[0], t) || (tf >> 6 & 3u);
    sx_put(tf, j, k, s1 + sy, s2 + sz,
           (b[1] * w1o + j - g.off[1]) * po + b[2] * w2o + k - g.off[2],
           (b[1] * w1s + j) * ps + b[2] * w2s + k, po, ps, op, fp, fr,
           val[f]);
  }
}

template <class P, bool STEP, bool RING>
__global__ void __launch_bounds__(SX_NT, SxTile<P, STEP>::MINB)
    stag_xmarch_kernel(P ph, SxLayout ly,
                       Fields<const typename P::T, P::NF> F,
                       Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  using I = typename SxIndex<RING>::type;
  constexpr int NF = P::NF, NS = P::NS, R = P::RADIUS, NT = SX_NT;
  using Tl = SxTile<P, STEP>;
  constexpr int TZ = Tl::TZ, TY = Tl::TY, CPT = Tl::CPT;
  using W = SxWin<R, TY, TZ>;
  constexpr int WZ = W::WZ, IN = W::IN, RG = W::RING, SPT = W::SPT;
  constexpr int AH = SX_AHEAD;
  constexpr unsigned LU = sx_layouts<P>();
  using Bits = typename std::conditional<(NF > 4), unsigned long long,
                                         unsigned>::type;
  if ((int)blockIdx.x >= ly.tz * ly.g.n[2]) {  // the wraps' edge rows
    if (!STEP) sx_edges<P, Bits>(ph, ly, F, out);
    return;
  }
  extern __shared__ __align__(16) unsigned char sx_smem[];
  T* const ring = reinterpret_cast<T*>(sx_smem);
  const Stag3& g = ly.g;
  const int tid = threadIdx.x;
  const int b[3] = {(int)blockIdx.z / ly.nseg, (int)blockIdx.y / ly.ty,
                    (int)blockIdx.x / ly.tz};
  const int seg = blockIdx.z - b[0] * ly.nseg;
  const int y0 = ly.first[1] + (blockIdx.y - b[1] * ly.ty) * TY;
  const int z0 = ly.first[2] + (blockIdx.x - b[2] * ly.tz) * TZ;
  const int xa = ly.first[0] + seg * ly.seg;
  const int xend = ly.first[0] + ly.rows[0];
  const int xb = xa + ly.seg < xend ? xa + ly.seg : xend;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];

  // What the thread stages: its elements e = tid + m NT of a plane's
  // window (row e / WZ, column e % WZ), their in-plane source offsets per
  // layout L of P's arrays and whether they lie inside the array (bit
  // 4m + L of sok).
  I soff[SPT][4];
  unsigned sok[(4 * SPT + 31) / 32];
#pragma unroll
  for (int w = 0; w < (4 * SPT + 31) / 32; ++w) sok[w] = 0;
#pragma unroll
  for (int m = 0; m < SPT; ++m) {
    const int e = tid + m * NT;
    const int j = y0 - R + e / WZ, k = z0 - R + e % WZ;
#pragma unroll
    for (int L = 0; L < 4; ++L) {
      soff[m][L] = 0;
      if (!(LU >> L & 1u)) continue;
      const int w1 = s1 + (L & 1), w2 = s2 + (L >> 1);
      soff[m][L] = ((I)b[1] * w1 + j) * ((I)g.n[2] * w2) + b[2] * w2 + k;
      if (e < IN && j >= 0 && j < w1 && k >= 0 && k < w2)
        sok[(4 * m + L) / 32] |= 1u << ((4 * m + L) % 32);
    }
  }
  // Plane p of every staged array (clamped to the array's own x rows of
  // the block) into slot `slot` of its ring, zeros outside the array.
  auto stage = [&](int p, int slot) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int a0 = sb_st<P>(k, 0);
      const int L = sb_st<P>(k, 1) | sb_st<P>(k, 2) << 1;
      const T* const src = ph.staged(k);
      const T* const base =
          src + ((long long)b[0] * (s0 + a0) + march_clamp(p, 0, s0 - 1 + a0)) *
                    sb_plane(g.s, g.n, L);
      T* const dst = ring + k * W::RS + slot * IN;
#pragma unroll
      for (int m = 0; m < SPT; ++m) {
        const int e = tid + m * NT;
        if (e >= IN) break;
        const bool in = sok[(4 * m + L) / 32] >> ((4 * m + L) % 32) & 1u;
        march_copy(dst + e, in ? base + soff[m][L] : src, in);
      }
    }
  };

  // The thread's own cells (CPT adjacent rows j0 + n of column oc, window
  // offsets q0 + n WZ): their targets (sx_bits) and, per layout L, the
  // in-plane target and source offsets of row j0 and their y pitches.
  const int oc = tid % TZ, k = z0 + oc, j0 = y0 + tid / TZ * CPT;
  const int q0 = (tid / TZ * CPT + R) * WZ + oc + R;
  Bits tb[CPT];
  I ino[4], ins[4], po[4], ps[4];
#pragma unroll
  for (int n = 0; n < CPT; ++n)
    tb[n] = sx_bits<P, STEP, Bits>(g, b, j0 + n, k, ly.first[1] + ly.rows[1],
                                   ly.first[2] + ly.rows[2]);
#pragma unroll
  for (int L = 0; L < 4; ++L) {
    const int w1o = g.o[1] + (L & 1), w2o = g.o[2] + (L >> 1);
    const int w1s = s1 + (L & 1), w2s = s2 + (L >> 1);
    po[L] = (I)g.n[2] * w2o;
    ps[L] = (I)g.n[2] * w2s;
    ino[L] = ((I)b[1] * w1o + j0 - g.off[1]) * po[L] + b[2] * w2o + k -
             g.off[2];
    ins[L] = ((I)b[1] * w1s + j0) * ps[L] + b[2] * w2s + k;
  }

  const int len = xb - xa, total = len + 2 * R;
  using Pos = typename std::conditional<RING, SbAt<T, R, TY, W>,
                                        SxDirect<T, R, W, NS>>::type;
  Pos m;
  long long dorg[RING ? 1 : NS];  // the no-ring position's window origins
  if constexpr (RING) {
    m.ring = ring;
    // Plane xa - R + i lives in slot i % RG (the band mode's protocol).
#pragma unroll
    for (int i = 0; i <= 2 * R + AH; ++i) {
      if (i < total) stage(xa - R + i, i);
      march_commit();
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const int L = sb_st<P>(kk, 1) | sb_st<P>(kk, 2) << 1;
      const long long w1 = s1 + (L & 1), w2 = s2 + (L >> 1);
      m.base[kk] = ph.staged(kk);
      m.ps[kk] = sb_plane(g.s, g.n, L);
      m.pitch[kk] = g.n[2] * w2;
      dorg[kk] = (b[1] * w1 + y0 - R) * m.pitch[kk] + b[2] * w2 + z0 - R;
    }
  }
  int sv = 0, sn = RG - 1;  // the slots of plane v and of the next staged
  for (int v = 0; v < len; ++v) {
    const int t = xa + v;
    if constexpr (RING) {
      march_wait<AH>();
      __syncthreads();
      if (v + 2 * R + 1 + AH < total) stage(xa + v + R + 1 + AH, sn);
      march_commit();
      sn = sn + 1 < RG ? sn + 1 : 0;
#pragma unroll
      for (int x = 0; x <= 2 * R; ++x)
        m.so[x] = (sv + x < RG ? sv + x : sv + x - RG) * IN;
      sv = sv + 1 < RG ? sv + 1 : 0;
    } else {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
        m.o[kk] = ((long long)b[0] * (s0 + sb_st<P>(kk, 0)) + t) * m.ps[kk] +
                  dorg[kk];
    }
    // Plane t of each field's target (none where the target window does
    // not hold it); whether it is an x freeze row.
    T* op[NF];
    unsigned fx = 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int a0 = P::st(f, 0), L = P::st(f, 1) | P::st(f, 2) << 1;
      const int tx = t - g.off[0];
      op[f] = tx >= 0 && tx < g.o[0] + a0
                  ? out.p[f] + ((long long)b[0] * (g.o[0] + a0) + tx) *
                                   sb_plane(g.o, g.n, L)
                  : nullptr;
      if (!STEP) fx |= (unsigned)frozen_row3<P>(g, f, 0, b[0], t) << f;
    }
    // Cell n's value of every field, and its writes.
    auto cell = [&](int n, T* val) {
      if (t < s0 && j0 + n < s1 && k < s2) {
        ph.mcells(g, t, j0 + n, k, m, q0 + n * WZ, val);
      } else {  // an outer face row: no update reaches it
#pragma unroll
        for (int f = 0; f < NF; ++f)
          val[f] = op[f] != nullptr && (tb[n] >> (8 * f) & 255u)
                       ? m.template at<0>(f, q0 + n * WZ) + T(0)
                       : T(0);
      }
    };
    auto put = [&](int n, const T* val) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const unsigned tf = (unsigned)(tb[n] >> (8 * f)) & 255u;
        if (op[f] == nullptr || !tf) continue;
        const int L = P::st(f, 1) | P::st(f, 2) << 1;
        const I to = ino[L] + n * po[L];
        // Its own position (a wrap's edge rows are the edge blocks'),
        // frozen or not.
        if (STEP || !((fx >> f & 1u) || (tf >> 6 & 3u))) {
          op[f][to] = val[f];
          continue;
        }
        op[f][to] = ld(F.p[f] + ((long long)b[0] * (s0 + P::st(f, 0)) + t) *
                                    sb_plane(g.s, g.n, L) +
                       ins[L] + n * ps[L]);
      }
    };
    T val[CPT][NF];
#pragma unroll
    for (int n = 0; n < CPT; ++n)
      if (tb[n]) cell(n, val[n]);
#pragma unroll
    for (int n = 0; n < CPT; ++n)
      if (tb[n]) put(n, val[n]);
  }
}

// Bytes of shared memory one thread block holds.
template <class P>
constexpr size_t sx_smem_bytes() {
  using Tl = SxTile<P, true>;  // (the tile of both modes)
  return sizeof(typename P::T) * (size_t)P::NS *
         SxWin<P::RADIUS, Tl::TY, Tl::TZ>::RS;
}

// One launch of a mode: thread blocks of SX_NT threads over (z tiles, y
// tiles, x segments) of every block; above 48 KB of shared memory the
// kernel opts in first.
template <class P, bool STEP, bool RING>
int sx_launch(const P& ph, SxLayout ly,
              const Fields<const typename P::T, P::NF>& F,
              const Fields<typename P::T, P::NF>& out, cudaStream_t s) {
  using Tl = SxTile<P, STEP>;
  const Stag3& g = ly.g;
  ly.ty = (ly.rows[1] + Tl::TY - 1) / Tl::TY;
  ly.tz = (ly.rows[2] + Tl::TZ - 1) / Tl::TZ;
  const int rows = ly.rows[0];
  const long long tiles = (long long)ly.ty * ly.tz * g.n[0] * g.n[1] * g.n[2];
  long long nseg = (SX_BLOCKS + tiles - 1) / tiles;
  const long long most = rows / SX_MIN_SEG > 1 ? rows / SX_MIN_SEG : 1;
  if (nseg > most) nseg = most;
  ly.seg = (int)((rows + nseg - 1) / nseg);
  ly.nseg = (rows + ly.seg - 1) / ly.seg;
  long long gx = (long long)ly.tz * g.n[2];
  const long long gy = (long long)ly.ty * g.n[1];
  const long long gz = (long long)ly.nseg * g.n[0];
  if (!STEP) {  // the wraps' edge rows: thread blocks beyond the tiles
    const long long items =
        (long long)g.n[0] * ly.rows[0] *
        ((long long)ly.ney * g.n[2] * ly.rows[2] +
         (long long)ly.nez * g.n[1] * ly.rows[1]);
    const long long blocks = (items + SX_NT - 1) / SX_NT;
    gx += (blocks + gy * gz - 1) / (gy * gz);
  }
  if (gx > 0x7fffffffLL || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = RING ? sx_smem_bytes<P>() : 0;
  if (bytes > (size_t)SB_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        stag_xmarch_kernel<P, STEP, RING>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  stag_xmarch_kernel<P, STEP, RING><<<grid, SX_NT, bytes, s>>>(ph, ly, F, out);
  return (int)cudaGetLastError();
}

// Launch one step or chunk step of the policy on make_stag3's layout g:
// the step mode where no dim wraps or freezes, else the chunk mode; with
// no ring where the ring would not fit a thread block's shared memory or
// a plane's offsets 32 bits.
template <class P>
int launch_stag_xmarch(const P& ph, const Stag3& g,
                       const Fields<const typename P::T, P::NF>& F,
                       const Fields<typename P::T, P::NF>& out,
                       cudaStream_t stream) {
  static_assert(P::NF <= MAXF && P::NS <= MAXF && P::NS >= P::NF,
                "the march stages the fields, then constant arrays");
  SxLayout ly;
  ly.g = g;
  bool step = true;
  for (int d = 0; d < 3; ++d) {
    int mx = 0;
    for (int f = 0; f < P::NF; ++f) mx = P::st(f, d) > mx ? P::st(f, d) : mx;
    ly.first[d] = g.off[d];
    ly.rows[d] = g.o[d] + mx;
    if (g.wrap[d] || g.frz[d]) step = false;
  }
  // The wraps' alias rows (sb_targets: size - ol to row 0, ol - 1 to row
  // size - 1, each field's own), each once.
  int* const alias[2] = {ly.ey, ly.ez};
  int* const count[2] = {&ly.ney, &ly.nez};
  for (int d = 1; d < 3; ++d) {
    *count[d - 1] = 0;
    if (!g.wrap[d]) continue;
    for (int f = 0; f < P::NF; ++f)
      for (const int c : {g.s[d] + P::st(f, d) - g.ol[f][d], g.ol[f][d] - 1}) {
        bool seen = false;
        for (int i = 0; i < *count[d - 1]; ++i)
          seen = seen || alias[d - 1][i] == c;
        if (!seen) alias[d - 1][(*count[d - 1])++] = c;
      }
  }
  bool ring = sx_smem_bytes<P>() <= (size_t)SX_SMEM_MAX;
  for (int L = 0; L < 4; ++L)
    if (sb_plane(g.s, g.n, L) > 0x7fffffffLL ||
        sb_plane(g.o, g.n, L) > 0x7fffffffLL)
      ring = false;
  if (!ring) return sx_launch<P, false, false>(ph, ly, F, out, stream);
  return step ? sx_launch<P, true, true>(ph, ly, F, out, stream)
              : sx_launch<P, false, true>(ph, ly, F, out, stream);
}

}  // namespace igg
