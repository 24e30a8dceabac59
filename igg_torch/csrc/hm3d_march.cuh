// The x-march of the HM3D band, chunk and step kernels (hm3d_band.cu,
// hm3d_chunk.cu, hm3d_step.cu): each thread block walks x over a (y, z)
// tile of one extended block, the planes it needs staged in shared memory,
// every quotient of the update formed once.
//
// Fields and semantics: HM3D's two collocated fields, the effective
// pressure Pe and the porosity phi (the first designs' hm3d.cuh, kept in
// kernel_variants.py), advanced by one coupled step on the layout of
// chunk_walk.cuh's Chunk, both fields re-frozen on open dims from the
// chunk-entry buffers F, with the edge rules of one of three realizations
// (march_layout.cuh), a template parameter E of the kernel:
//   - BandEdges, the banded realization (the band kernel; layout
//     chunk_engine.band_cfg; plain version banded_window_plain with
//     hm3d_trapezoid.band_update): every x row updated, its x neighbours
//     clamped to the block's first and last rows, F on exactly the freeze
//     rows lo and hi in band_halo's order;
//   - ChunkEdges, the K-step chunk (the chunk kernel; layout
//     chunk_engine.chunk_cfg; plain version window_step_plain with
//     hm3d_trapezoid.window_core): a block's outermost x rows keep their
//     values, F on every row <= lo / >= hi at the target cell;
//   - StepEdges, the fused step (the step kernel; layout make_geo's, whole
//     blocks, no F; plain version hm3d_pallas.step_plain): step_walk.cuh's
//     halo modes, x wraps and received planes included (hm_step_put).
// Rows on a block's y/z outer planes keep their source values, a wrapped
// dim's edge cells take the updated values at the inner cells they alias,
// and the last launch of a chunk writes only each block's central window,
// straight into the unextended outputs.
// The arithmetic is that of hm3d.cuh's `perm`, `flux` and `cell` in their
// association, each operation rounded as the plain version rounds it
// (-fmad=false), every division bitwise `x / d` (IEEE or const_div.cuh,
// as hm_ieee chooses):
//   k = (phi / phi0)^npow, once a cell;
//   q = (-(0.5 (k_hi + k_lo)) (Pe_hi - Pe_lo)) / d, once a face: hm3d.cuh
//       forms a face's flux from both cells beside it with the same
//       operands in the same order, so one quotient serves both;
//   divq = ((dqx / dx + dqy / dy) + dqz / dz), Pe' and phi' by eta.
// Divisions a cell: 1 (k) + 3 (faces) + 5 (divq, two by eta) = 9 against
// hm3d.cuh's 18; with the tile's halo 9.4.
//
// The march.  A thread block owns the tile of source rows [y0, y0 + TY) x
// [z0, z0 + TZ) of one block (16 x 16 cells, one a thread; HM_CPT cells of
// a column where a tile holds more) and walks x over a segment [xa, xb).
// At step u (plane t = xa - 1 + u) each thread
//   1. forms k of plane t + 1 over the tile and the halo cells the faces
//      read (one row above and below, one column left and right) into a
//      shared-memory ring, keeping its own cell's in a register; the x-face
//      flux between planes t and t + 1 of its own cell, in a register; the
//      y- and z-face fluxes of plane t (TY + 1 rows of y faces, TZ + 1
//      columns of z faces) into shared planes, from k of plane t formed the
//      step before;
//   2. waits for its own asynchronous copies and meets the block at its
//      one barrier a step;
//   3. starts the copies (cp.async) of Pe and phi at plane t + 3 into the
//      slots of plane t - 1;
//   4. updates its own cell of plane t from the fluxes of its six faces
//      and writes it to each of its targets.
// A thread that leaves step 4 early forms plane t + 1's k and fluxes while
// others still read plane t's: the flux planes and the k planes are rings
// of 2, the staged planes rings of 4, so that no slot a step writes before
// the barrier is one the step before reads after it.  The halo items go to
// warps that hold no other extra item (k: threads 0-63; y faces: 64-79;
// z faces: 96-111).
//
// Shared memory a thread block holds (elements): 8 staged planes and 2 k
// planes of (TY + 2)(TZ + 2) = 324, 2 y-face planes of (TY + 1) TZ = 272 and
// 2 z-face planes of TY (TZ + 1) = 272: 4,328 elements, 17,312 bytes in
// float32 and 34,624 in float64, whatever the band depth B.  The 16 x 16
// tile divides the extended blocks (272 = 17 x 16): on an H100 80GB HBM3
// at 700 W it ran 7% faster than 8 x 32, whose last z tile of 272 is half
// empty, and than two cells a thread (kernel_variants.py: hm_tile_*).
//
// Wraps without a second pass.  Every cell is computed once, at its source
// position, and written to each target that takes it: along a wrapped dim,
// row c goes to target c (1 <= c <= s-2), to 0 (c == s-ol) and to s-1
// (c == ol-1).  A thread resolves its cell's targets once for the whole
// march; only threads on a wrap's edge or alias rows resolve them per
// plane.  The fused step (StepEdges) wraps x too: plane t's targets are
// resolved once a plane for the thread block (hm_step_plane), a z wrap's
// alias is one more store of the cell (hm_step_put), and only cells on a y
// wrap's rows or on a received y or z halo row take the slower path
// (hm_step_put_special): their writes, divergent in their warps, take 8%
// of the step's time at one periodic 256^3 block and 14% at 2x2x2 blocks
// whose dims all receive (kernel_variants.py: hm_step_no_special_writes,
// not bitwise, on an H100 80GB HBM3 at 700 W).
//
// Segments.  Where the tiles of a launch give fewer than HM_BLOCKS thread
// blocks, x is cut into segments of at least HM_MIN_SEG rows, one a thread
// block; a segment starts one plane early (step 0: k and the x-face flux
// of its first face).  The segments are the kernel's own choice: neither
// function depends on them (nor the banded one on the band depth).  The
// fused step cuts until HM_STEP_BLOCKS thread blocks, segments of at least
// HM_STEP_MIN_SEG = 16 rows: on one periodic 256^3 block (256 tiles, 16
// segments) 8 rows ran 5% slower on random fields and 32 rows 10% slower
// at rest; on 2x2x2 blocks (2048 tiles, 4 segments) one segment ran 11%
// slower (kernel_variants.py: hm_step_min_seg_*, hm_step_blocks_2048).
#pragma once

#include <type_traits>

#include "const_div.cuh"
#include "march_layout.cuh"

namespace igg {

constexpr int HM_TY = 16;         // y rows of a tile
constexpr int HM_TZ = 16;         // z cells of a tile row
constexpr int HM_NT = 256;        // threads of a thread block
constexpr int HM_CPT = HM_TY * HM_TZ / HM_NT;  // own cells a thread
constexpr int HM_BLOCKS = 8192;   // thread blocks below which x is cut
constexpr int HM_STEP_BLOCKS = 8192;  // the same for the fused step
constexpr int HM_STEP_MIN_SEG = 16;   // and its fewest x rows of a segment
constexpr int HM_MIN_SEG = 8;     // fewest x rows of a segment
constexpr int HM_AHEAD = 1;       // planes staged beyond the next two
// Thread blocks an SM holds at least (the register bound).
constexpr int HM_MIN_BLOCKS_F32 = 4;
constexpr int HM_MIN_BLOCKS_F64 = 3;
// The same for the fused step: 4 in float64 too, where the step spilled 48
// bytes at 3 and ran 27% slower at one 256^3 block on an H100 80GB HBM3 at
// 700 W (kernel_variants.py: hm_step_bounds_f64_3; at 4 it spills 12).
constexpr int HM_STEP_MIN_BLOCKS_F32 = 4;
constexpr int HM_STEP_MIN_BLOCKS_F64 = 4;
// The staging ring: planes t - 1 .. t + 2 + AHEAD (the march's note).
constexpr int HM_RING = HM_AHEAD + 3;

constexpr int HM_IY = HM_TY + 2, HM_IZ = HM_TZ + 2;
constexpr int HM_IN = HM_IY * HM_IZ;        // a staged or k plane
constexpr int HM_QY = (HM_TY + 1) * HM_TZ;  // a y-face plane
constexpr int HM_QZ = HM_TY * (HM_TZ + 1);  // a z-face plane
constexpr int HM_SPT = (HM_IN + HM_NT - 1) / HM_NT;  // staged elements
constexpr int HM_HALO = 2 * HM_TZ + 2 * HM_TY;       // k's halo cells
constexpr int HM_ELEMS =
    (2 * HM_RING + 2) * HM_IN + 2 * HM_QY + 2 * HM_QZ;
// The warps of the halo items (module note).
constexpr int HM_QY0 = (HM_HALO + 31) / 32 * 32;
constexpr int HM_QZ0 = HM_QY0 + (HM_TZ + 31) / 32 * 32;
static_assert(HM_HALO <= HM_NT && HM_QY0 + HM_TZ <= HM_NT &&
                  HM_QZ0 + HM_TY <= HM_NT,
              "a thread takes at most one item beyond its own of each kind");
static_assert(HM_CPT >= 1 && HM_CPT * HM_NT == HM_TY * HM_TZ &&
                  HM_NT % HM_TZ == 0,
              "a thread takes whole cells of one column");

template <typename T>
struct HmArgs {
  const T* src[2];  // Pe, phi
  const T* F[2];    // the chunk-entry buffers (read where a dim freezes)
  T* out[2];        // the targets
  T dt;
  ConstDiv<T> qx, qy, qz, q0, qe;  // dx, dy, dz, phi0, eta
  int npow;         // >= 0
  Chunk c;          // extended blocks, wraps, freeze rows, central window
  int ol[3];        // wrap overlap along y and z
  int first[3];     // first source row with a target (a target block's
                    // row 0), per dim
  int rows[3];      // source rows with a target (a target block's extent)
  int ty, tz;       // tiles of a block along y and z
  int nseg, seg;    // x segments of a block, rows of a segment
};

// The fused step's arguments (StepEdges): the received planes too.
template <typename T>
struct HmStepArgs : HmArgs<T> {
  const T* pl[2][6];  // (field, dim, side) as step_walk.cuh's Planes; null
                      // for dims not in RECV mode
};

// The kernel's arguments under the edge rules E.
template <typename T, class E>
using HmParams = std::conditional_t<E::STEP, HmStepArgs<T>, HmArgs<T>>;

// Whether the march with the edge rules E divides by IEEE `x / d` rather
// than by const_div.cuh: the chunk kernel in float32, where `x / d` ran 1%
// faster on random fields and 4% at rest on an H100 80GB HBM3 at 700 W
// (kernel_variants.py: hm_div_ieee_f32); in float64 `x / d` ran 10%
// slower.  The step kernel (StepEdges, CHUNK) divides as the chunk kernel
// does (kernel_variants.py: hm_step_div_const, hm_step_div_ieee); the band
// kernel keeps const_div.cuh (hm_div_ieee and hm_div_ieee_f32 edit this
// choice).
template <typename T, class E>
constexpr bool hm_ieee = E::CHUNK && sizeof(T) == 4;

// The march's divisions, one at a time and in batches.
template <bool IEEE, typename T>
__device__ __forceinline__ T hm_div(T x, const ConstDiv<T>& q) {
  if constexpr (IEEE)
    return x / q.d;
  else
    return cdiv(x, q);
}
template <typename T, bool IEEE>
struct HmBatch {
  bool ok = true;
  __device__ __forceinline__ T operator()(T x, const ConstDiv<T>& q) {
    if constexpr (IEEE) return x / q.d;
    ok = ok & div_admits(x, q);
    return div_fast(x, q);
  }
};

// (phi/phi0)^npow: hm3d.cuh's perm with its division by phi0.
template <bool IEEE, typename T>
__device__ __forceinline__ T hm_perm(T phi, const HmArgs<T>& m) {
  T x = hm_div<IEEE>(phi, m.q0);
  if (m.npow == 0) return T(1);
  T acc = x;
  bool have = false;
  for (int y = m.npow; y > 0;) {
    if (y & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return acc;
}

// hm3d.cuh's flux before its division: -kf * (p_hi - p_lo).
template <typename T>
__device__ __forceinline__ T hm_flow(T klo, T khi, T plo, T phi_) {
  const T kf = T(0.5) * (khi + klo);
  return -kf * (phi_ - plo);
}

// Where source plane t of the thread block's block b0 goes in the fused
// step (StepEdges): its x targets (the plane itself, and along a wrapped x
// also plane 0 from s0-2 and plane s0-1 from 1; planes 0 and s0-1 of a
// wrap none), as offsets of target planes, and on a received x halo plane
// the received planes of both fields at the block (xp; null elsewhere).
template <typename T>
struct HmStepPlane {
  long long own, first, last;  // offsets of planes t, 0 and s0-1
  int t;
  bool to_own, to_first, to_last;
  const T* xp[2];
};
struct HmNoPlane {};  // the band's and the chunk's (no step targets)

template <typename T>
__device__ __forceinline__ HmStepPlane<T> hm_step_plane(const HmStepArgs<T>& m,
                                                        int b0, int t) {
  const Geo& g = m.c.geo;
  const int s0 = g.s[0];
  const long long psize = (long long)g.G[1] * g.G[2];
  const bool wx = g.mode[0] == WRAP;
  HmStepPlane<T> x;
  x.first = (long long)b0 * s0 * psize;
  x.own = x.first + (long long)t * psize;
  x.last = x.first + (long long)(s0 - 1) * psize;
  x.t = t;
  x.to_own = !wx || (t >= 1 && t <= s0 - 2);
  x.to_first = wx && t == s0 - 2;
  x.to_last = wx && t == 1;
  x.xp[0] = x.xp[1] = nullptr;
  if (g.mode[0] == RECV && (t == 0 || t == s0 - 1)) {
    x.xp[0] = (t == 0 ? m.pl[0][0] : m.pl[0][1]) + b0 * psize;
    x.xp[1] = (t == 0 ? m.pl[1][0] : m.pl[1][1]) + b0 * psize;
  }
  return x;
}

// hm_step_put's cells on a wrap's edge or alias rows or on a received y or
// z halo row, to each of their targets.
template <typename T>
__device__ __forceinline__ void hm_step_put_special(const HmStepArgs<T>& m,
                                                    const int* b, int j,
                                                    int k, int ins,
                                                    const HmStepPlane<T>& x,
                                                    T pn, T fn) {
  const Geo& g = m.c.geo;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
  int ty[3], tz[3];
  const int ny = march_targets(j, g.mode[1] == WRAP, 0, s1, s1, 2, ty);
  const int nz = march_targets(k, g.mode[2] == WRAP, 0, s2, s2, 2, tz);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (!(c == 0 ? x.to_own : c == 1 ? x.to_first : x.to_last)) continue;
    const long long xo = c == 0 ? x.own : c == 1 ? x.first : x.last;
    // The target's row of the stacked grid along x.
    const long long X =
        (long long)b[0] * s0 + (c == 0 ? x.t : c == 1 ? 0 : s0 - 1);
#pragma unroll 1
    for (int a = 0; a < ny * nz; ++a) {
      const int y = ty[a >= nz ? (a >= 2 * nz ? 2 : 1) : 0];
      const int z = tz[a - (a >= nz ? (a >= 2 * nz ? 2 : 1) : 0) * nz];
      const long long Y = (long long)b[1] * s1 + y;
      const long long o = xo + Y * g.G[2] + (long long)b[2] * s2 + z;
      T u0 = pn, u1 = fn;
      if (g.mode[2] == RECV && (z == 0 || z == s2 - 1)) {
        const long long q = (X * g.G[1] + Y) * g.n[2] + b[2];
        u0 = ld((z == 0 ? m.pl[0][4] : m.pl[0][5]) + q);
        u1 = ld((z == 0 ? m.pl[1][4] : m.pl[1][5]) + q);
      } else if (g.mode[1] == RECV && (y == 0 || y == s1 - 1)) {
        const long long q =
            (X * g.n[1] + b[1]) * g.G[2] + (long long)b[2] * s2 + k;
        u0 = ld((y == 0 ? m.pl[0][2] : m.pl[0][3]) + q);
        u1 = ld((y == 0 ? m.pl[1][2] : m.pl[1][3]) + q);
      } else if (x.xp[0] != nullptr) {
        u0 = ld(x.xp[0] + ins);
        u1 = ld(x.xp[1] + ins);
      }
      m.out[0][o] = u0;
      m.out[1][o] = u1;
    }
  }
}

// The fused step's writes (StepEdges) of the cell (j, k) of the thread
// block's block at the source plane that `x` describes, whose updated
// values (its source values where it is not updated) are pn and fn: to
// each of its targets, the product of its x targets and its y and z
// targets (a simple cell: its own row, and its own column and a z wrap's
// alias (zown, zd), on no received halo row; the others
// hm_step_put_special's), each target resolved z, then y,
// then x, as step_walk.cuh's resolve_cells resolves it.  A target on a
// received z halo row takes the z plane at the target's x and y; else on a
// received y halo row the y plane at the target's x and the source's z;
// else on a received x halo plane the x plane at the source's y and z;
// else the cell's values.  `ins`: the cell's in-plane offset.
template <typename T>
__device__ __forceinline__ void hm_step_put(const HmStepArgs<T>& m, const int* b,
                                            int j, int k, int ins,
                                            bool simple, bool zown, int zd,
                                            const HmStepPlane<T>& x, T pn,
                                            T fn) {
  if (simple) {
    if (x.xp[0] != nullptr) {  // a received x halo plane
      pn = ld(x.xp[0] + ins);
      fn = ld(x.xp[1] + ins);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (!(c == 0 ? x.to_own : c == 1 ? x.to_first : x.to_last)) continue;
      const long long o = (c == 0 ? x.own : c == 1 ? x.first : x.last) + ins;
      if (zown) {
        m.out[0][o] = pn;
        m.out[1][o] = fn;
      }
      if (zd != 0) {  // a z wrap's alias
        m.out[0][o + zd] = pn;
        m.out[1][o + zd] = fn;
      }
    }
    return;
  }
  hm_step_put_special(m, b, j, k, ins, x, pn, fn);
}

// E: the edge rules, BandEdges (the band kernel), ChunkEdges (the chunk
// kernel) or StepEdges (the fused step), march_layout.cuh.
template <typename T, class E>
__global__ void __launch_bounds__(
    HM_NT, E::STEP ? (sizeof(T) == 4 ? HM_STEP_MIN_BLOCKS_F32
                                     : HM_STEP_MIN_BLOCKS_F64)
                   : (sizeof(T) == 4 ? HM_MIN_BLOCKS_F32 : HM_MIN_BLOCKS_F64))
    hm_march_kernel(HmParams<T, E> m) {
  extern __shared__ __align__(16) unsigned char hm_smem[];
  constexpr int TY = HM_TY, TZ = HM_TZ, NT = HM_NT, IZ = HM_IZ, IN = HM_IN;
  constexpr int R = HM_RING, AH = HM_AHEAD;
  constexpr bool IEEE = hm_ieee<T, E>;
  const Chunk& c = m.c;
  const Geo& g = c.geo;
  const int tid = threadIdx.x;
  const int b[3] = {(int)blockIdx.z / m.nseg, (int)blockIdx.y / m.ty,
                    (int)blockIdx.x / m.tz};
  const int seg = blockIdx.z - b[0] * m.nseg;
  const int y0 = m.first[1] + (blockIdx.y - b[1] * m.ty) * TY;
  const int z0 = m.first[2] + (blockIdx.x - b[2] * m.tz) * TZ;
  const int xa = m.first[0] + seg * m.seg;
  const int xend = m.first[0] + m.rows[0];
  const int xb = xa + m.seg < xend ? xa + m.seg : xend;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];

  T* const sm = reinterpret_cast<T*>(hm_smem);
  T* const pring = sm;                 // Pe [R][IN]
  T* const fring = sm + R * IN;        // phi [R][IN]
  T* const kring = sm + 2 * R * IN;    // k [2][IN] (planes t, t + 1)
  T* const qyq = kring + 2 * IN;       // y faces [2][HM_QY]
  T* const qzq = qyq + 2 * HM_QY;      // z faces [2][HM_QZ]

  // What the thread stages: its elements of a plane, their in-plane
  // offsets (an x-plane of the stacked field holds fewer than 2^31
  // elements: launch_hm_march) and whether they lie inside the block.
  int soff[HM_SPT];
  unsigned sok = 0;
#pragma unroll
  for (int q = 0; q < HM_SPT; ++q) {
    const int e = tid + q * NT;
    const int j = y0 - 1 + e / IZ, k = z0 - 1 + e % IZ;
    soff[q] = (b[1] * s1 + j) * g.G[2] + b[2] * s2 + k;
    if (e < IN && j >= 0 && j < s1 && k >= 0 && k < s2) sok |= 1u << q;
  }
  const long long psize = (long long)g.G[1] * g.G[2];
  auto stage = [&](int i) {
    const int p = E::plane(xa - 1 + i, s0), slot = i % R;
    const long long base = ((long long)b[0] * s0 + p) * psize;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      T* const dst = (f == 0 ? pring : fring) + slot * IN;
      const T* const src = m.src[f];
#pragma unroll
      for (int q = 0; q < HM_SPT; ++q) {
        const int e = tid + q * NT;
        if (e >= IN) break;
        const bool in = sok >> q & 1u;
        march_copy(dst + e, in ? src + base + soff[q] : src, in);
      }
    }
  };

  // The thread's own cells (rows oa + n NR of column oc), its halo k cell
  // and its extra faces.
  constexpr int CPT = HM_CPT, NR = NT / TZ;
  const int oc = tid % TZ;
  int io[CPT], ins[CPT], j[CPT];
  long long ino[CPT];
  bool mine[CPT], inner[CPT], simple[CPT], fyz[CPT];
  const int k = z0 + oc;
  const bool wy = g.mode[1] == WRAP, wz = g.mode[2] == WRAP;
  const bool zspecial = wz && (k == 0 || k == s2 - 1 || k == s2 - m.ol[2] ||
                               k == m.ol[2] - 1);
  const int tb[3] = {b[0], b[1], b[2]};
  const int OG[3] = {c.geo.n[0] * m.rows[0], c.geo.n[1] * m.rows[1],
                     c.geo.n[2] * m.rows[2]};
  const long long opsize = (long long)OG[1] * OG[2];
#pragma unroll
  for (int n = 0; n < CPT; ++n) {
    const int oa = tid / TZ + n * NR;
    j[n] = y0 + oa;
    io[n] = (oa + 1) * IZ + oc + 1;
    mine[n] = j[n] < m.first[1] + m.rows[1] && k < m.first[2] + m.rows[2];
    inner[n] = j[n] >= 1 && j[n] <= s1 - 2 && k >= 1 && k <= s2 - 2;
    simple[n] = !(wy && (j[n] == 0 || j[n] == s1 - 1 ||
                         j[n] == s1 - m.ol[1] || j[n] == m.ol[1] - 1)) &&
                !zspecial;
    // A simple cell's target is its own position, frozen by y or z alike
    // in every plane.
    fyz[n] = E::frozen(c, 1, b[1], j[n]) || E::frozen(c, 2, b[2], k);
    ins[n] = (b[1] * s1 + j[n]) * g.G[2] + b[2] * s2 + k;
    ino[n] =
        march_at(m.rows, OG, tb, 0, j[n] - m.first[1], k - m.first[2]) -
        (long long)b[0] * m.rows[0] * opsize;
  }
  // StepEdges: received y and z halo rows are not simple, and a z wrap over
  // at least 4 rows is resolved in the simple path (zown: the cell's own z
  // target; zd: its alias's z offset).
  bool zown = true;
  int zd = 0;
  if constexpr (E::STEP) {
    const bool zs4 = wz && s2 >= 4;
    zown = !(zs4 && (k == 0 || k == s2 - 1));
    zd = zs4 ? (k == 1 ? s2 - 2 : k == s2 - 2 ? 2 - s2 : 0) : 0;
    const bool kr = g.mode[2] == RECV && (k == 0 || k == s2 - 1);
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      const bool jw = wy && (j[n] == 0 || j[n] == s1 - 1 || j[n] == s1 - 2 ||
                             j[n] == 1);
      const bool jr = g.mode[1] == RECV && (j[n] == 0 || j[n] == s1 - 1);
      simple[n] = !jw && !jr && !kr && !(wz && !zs4 && zspecial);
    }
  }
  int ih = -1;
  if (tid < HM_HALO) {
    const int h = tid;
    ih = h < TZ ? h + 1
         : h < 2 * TZ ? (TY + 1) * IZ + h - TZ + 1
         : h < 2 * TZ + TY ? (h - 2 * TZ + 1) * IZ
                           : (h - 2 * TZ - TY + 1) * IZ + TZ + 1;
  }
  const bool qy_extra = tid >= HM_QY0 && tid < HM_QY0 + TZ;
  const bool qz_extra = tid >= HM_QZ0 && tid < HM_QZ0 + TY;

  // Plane xa - 1 + i lives in slot i % R.  Step u forms k of plane u + 1
  // and the fluxes of plane u, waits for its own copies and meets the
  // others at the barrier, then stages plane u + 2 + AH into the slot of
  // plane u - 1 (read last before this barrier) and updates plane u.
  const int steps = xb - xa + 1;
#pragma unroll
  for (int i = 0; i <= AH + 1; ++i) stage(i);
  march_commit();
  march_wait<0>();
  __syncthreads();

  T kown[CPT], qlo[CPT];  // k of the own cells at plane t, their x-face
                          // fluxes below plane t
#pragma unroll
  for (int n = 0; n < CPT; ++n) {
    kown[n] = hm_perm<IEEE>(fring[io[n]], m);
    qlo[n] = T(0);
  }
  for (int u = 0, t = xa - 1; t < xb; ++u, ++t) {
    const T* pe0 = pring + (u % R) * IN;
    const T* pe1 = pring + ((u + 1) % R) * IN;
    const T* ph0 = fring + (u % R) * IN;
    const T* ph1 = fring + ((u + 1) % R) * IN;
    const T* k0 = kring + (u & 1) * IN;
    T* const k1 = kring + ((u + 1) & 1) * IN;
    T* const qy = qyq + (u & 1) * HM_QY;
    T* const qz = qzq + (u & 1) * HM_QZ;

    // k of plane t + 1, the x-face fluxes between t and t + 1, and (from
    // plane xa on) the y- and z-face fluxes of plane t.
    T qhi[CPT];
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      const int i = io[n];
      const T knext = hm_perm<IEEE>(ph1[i], m);
      k1[i] = knext;
      const T fx = hm_flow(kown[n], knext, pe0[i], pe1[i]);
      kown[n] = knext;
      if (t >= xa) {
        const T fy = hm_flow(k0[i - IZ], k0[i], pe0[i - IZ], pe0[i]);
        const T fz = hm_flow(k0[i - 1], k0[i], pe0[i - 1], pe0[i]);
        HmBatch<T, IEEE> D;
        T a = D(fx, m.qx), ay = D(fy, m.qy), az = D(fz, m.qz);
        if (!D.ok) {
          a = hm_div<IEEE>(fx, m.qx);
          ay = hm_div<IEEE>(fy, m.qy);
          az = hm_div<IEEE>(fz, m.qz);
        }
        qhi[n] = a;
        const int oa = tid / TZ + n * NR;
        qy[oa * TZ + oc] = ay;
        qz[oa * (TZ + 1) + oc] = az;
      } else {
        qhi[n] = hm_div<IEEE>(fx, m.qx);
      }
    }
    if (ih >= 0) k1[ih] = hm_perm<IEEE>(ph1[ih], m);
    if (t >= xa) {
      if (qy_extra) {  // the y faces above the tile's last row
        const int e = tid - HM_QY0, i = TY * IZ + e + 1;
        qy[TY * TZ + e] = hm_div<IEEE>(
            hm_flow(k0[i], k0[i + IZ], pe0[i], pe0[i + IZ]), m.qy);
      }
      if (qz_extra) {  // the z faces right of the tile's last column
        const int e = tid - HM_QZ0, i = (e + 1) * IZ + TZ;
        qz[e * (TZ + 1) + TZ] = hm_div<IEEE>(
            hm_flow(k0[i], k0[i + 1], pe0[i], pe0[i + 1]), m.qz);
      }
    }
    march_wait<AH - 1>();
    __syncthreads();
    if (u + 2 + AH <= steps) stage(u + 2 + AH);
    march_commit();
    T qxl[CPT];
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      qxl[n] = qlo[n];
      qlo[n] = qhi[n];
    }
    if (t < xa) continue;

    // The update of the own cells of plane t (hm3d.cuh's cell), their
    // targets, the freezes.  A chunk keeps a block's outermost x rows.
    const bool fx0 = E::frozen(c, 0, b[0], t);
    const bool xin = !E::CHUNK || (t >= 1 && t <= s0 - 2);
    const long long op = (long long)(b[0] * m.rows[0] + t - m.first[0]) *
                         opsize;
    const long long sp = ((long long)b[0] * s0 + t) * psize;
    std::conditional_t<E::STEP, HmStepPlane<T>, HmNoPlane> xs;
    if constexpr (E::STEP) xs = hm_step_plane(m, b[0], t);
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      if (!mine[n]) continue;
      const int i = io[n], oa = tid / TZ + n * NR;
      const T pe = pe0[i], ph = ph0[i];
      T pn = pe, fn = ph;
      if (inner[n] && xin) {
        const T dqx = qhi[n] - qxl[n];
        const T dqy = qy[(oa + 1) * TZ + oc] - qy[oa * TZ + oc];
        const T dqz = qz[oa * (TZ + 1) + oc + 1] - qz[oa * (TZ + 1) + oc];
        const T pp = pe * ph;
        HmBatch<T, IEEE> D;
        T a = D(dqx, m.qx), ay = D(dqy, m.qy), az = D(dqz, m.qz),
          ae = D(pp, m.qe);
        if (!D.ok) {
          a = hm_div<IEEE>(dqx, m.qx);
          ay = hm_div<IEEE>(dqy, m.qy);
          az = hm_div<IEEE>(dqz, m.qz);
          ae = hm_div<IEEE>(pp, m.qe);
        }
        T divq = a;
        divq = divq + ay;
        divq = divq + az;
        const T dpe = m.dt * (-divq - ae);
        pn = pe + dpe;
        const T dph = m.dt * hm_div<IEEE>((-ph * (T(1) - ph)) * pn, m.qe);
        fn = ph + dph;
      }
      if constexpr (E::STEP) {
        hm_step_put(m, b, j[n], k, ins[n], simple[n], zown, zd, xs, pn, fn);
        continue;
      }
      if (simple[n]) {
        const bool fr = fx0 || fyz[n];
        m.out[0][op + ino[n]] = fr ? ld(m.F[0] + sp + ins[n]) : pn;
        m.out[1][op + ino[n]] = fr ? ld(m.F[1] + sp + ins[n]) : fn;
        continue;
      }
      int tgy[3], tgz[3];
      const int ny =
          march_targets(j[n], wy, m.first[1], m.rows[1], s1, m.ol[1], tgy);
      const int nz =
          march_targets(k, wz, m.first[2], m.rows[2], s2, m.ol[2], tgz);
#pragma unroll 1
      for (int a = 0; a < ny * nz; ++a) {
        const int yt = tgy[a / nz], zt = tgz[a % nz];
        const int ya = yt + m.first[1];
        const bool fz = E::frozen(c, 2, b[2], zt + m.first[2]);
        const long long o = op + march_at(m.rows, OG, tb, 0, yt, zt) -
                            (long long)b[0] * m.rows[0] * opsize;
        if (fz || E::frozen(c, 1, b[1], ya) || fx0) {
          // The band takes F at the source's z (band_halo's order), the
          // chunk at the target cell.
          const long long q = sp +
                              (b[1] * s1 + (fz || E::CHUNK ? ya : j[n])) *
                                  (long long)g.G[2] +
                              b[2] * s2 + (E::CHUNK ? zt + m.first[2] : k);
          m.out[0][o] = ld(m.F[0] + q);
          m.out[1][o] = ld(m.F[1] + q);
        } else {
          m.out[0][o] = pn;
          m.out[1][o] = fn;
        }
      }
    }
  }
}

template <typename T>
size_t hm_march_smem_bytes() {
  return sizeof(T) * (size_t)HM_ELEMS;
}

// Launch one banded iteration, chunk step or fused step (E: the edge rules): thread
// blocks of HM_NT threads over (z tiles, y tiles, x segments) of every
// block.
template <typename T, class E>
int launch_hm_march(HmParams<T, E> m, cudaStream_t stream) {
  dim3 grid;
  const int err = march_grid(m, HM_TY, HM_TZ,
                             E::STEP ? HM_STEP_BLOCKS : HM_BLOCKS,
                             E::STEP ? HM_STEP_MIN_SEG : HM_MIN_SEG, grid);
  if (err) return err;
  const size_t bytes = hm_march_smem_bytes<T>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hm_march_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  hm_march_kernel<T, E><<<grid, HM_NT, bytes, stream>>>(m);
  return (int)cudaGetLastError();
}

// One launch of the march with the edge rules E on the layout `cfg`
// (chunk_engine.band_cfg for BandEdges, chunk_cfg for ChunkEdges): src, F,
// out the (Pe, phi) pointers of the sources, the chunk-entry buffers and
// the targets; coef dx dy dz dt phi0 eta, each rounded once to T.
template <typename T, class E>
int run_hm_march(void* const* src, void* const* F, void* const* out,
                 const int* cfg, const double* coef, int npow,
                 cudaStream_t stream) {
  HmArgs<T> m;
  const bool ok = E::CHUNK ? march_chunk_layout(cfg, m)
                           : march_band_layout(cfg, m);
  if (!ok || npow < 0) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < 2; ++f) {
    m.src[f] = static_cast<const T*>(src[f]);
    m.F[f] = static_cast<const T*>(F[f]);
    m.out[f] = static_cast<T*>(out[f]);
  }
  m.qx = make_div((T)coef[0]);
  m.qy = make_div((T)coef[1]);
  m.qz = make_div((T)coef[2]);
  m.dt = (T)coef[3];
  m.q0 = make_div((T)coef[4]);
  m.qe = make_div((T)coef[5]);
  m.npow = npow;
  return launch_hm_march<T, E>(m, stream);
}

// One fused step (StepEdges) of (Pe, phi) on the layout `cfg` (n[3] s[3]
// mode[3], march_step_layout): src and out the fields' pointers, planes the
// 12 received planes ((field, dim, side), null for dims not RECV); coef as
// run_hm_march's.
template <typename T>
int run_hm_step(void* const* src, void* const* out, const int* cfg,
                void* const* planes, const double* coef, int npow,
                cudaStream_t stream) {
  HmStepArgs<T> m;
  if (!march_step_layout(cfg, m) || npow < 0)
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < 2; ++f) {
    m.src[f] = static_cast<const T*>(src[f]);
    m.F[f] = nullptr;
    m.out[f] = static_cast<T*>(out[f]);
    for (int j = 0; j < 6; ++j)
      m.pl[f][j] = static_cast<const T*>(planes[6 * f + j]);
  }
  m.qx = make_div((T)coef[0]);
  m.qy = make_div((T)coef[1]);
  m.qz = make_div((T)coef[2]);
  m.dt = (T)coef[3];
  m.q0 = make_div((T)coef[4]);
  m.qe = make_div((T)coef[5]);
  m.npow = npow;
  return launch_hm_march<T, StepEdges>(m, stream);
}

}  // namespace igg
