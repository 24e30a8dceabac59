// The walk of the Stokes chunk step (stokes_chunk.cu) and, in its band
// mode, of the Stokes band step (stokes_band.cu): an x-march of each
// thread block over a (y, z) tile of one extended block, the planes it
// needs staged in shared memory, every quotient of the update formed once.
//
// Fields and semantics: those of stagger_walk3.cuh with the Stokes policy
// of stokes.cuh (P, Vx, Vy, Vz, the constant Rho; the layout Stag3 of
// make_stag3; wraps on y and z with each field's own overlap, the
// velocities' open-dim freezes from the chunk-entry buffers, targets that
// are the whole blocks or each block's central window).  The arithmetic is
// that of igg_torch.models.stokes3d.iteration_core in its association,
// each operation rounded as the plain version rounds it (-fmad=false; the
// divisions of const_div.cuh, bitwise `x / d`).  Of stokes.cuh it takes
// the fields' staggers and freezes (`Stokes::st`, `freezes`).  The step
// kernel (stokes_step.cu) runs a march of its own: it has none of this
// one's wraps, freezes, F buffers, central windows or per-plane targets.
//
// The band mode (BAND; chunk_engine.banded_window_plain with
// stokes_trapezoid.band_update, whose bands do not change the function):
//   - each staged plane index is clamped to its field's own first and last
//     rows of the block (Vx has s0 + 1), the band walk's rolling window,
//     and every row of the block is updated (its clamped neighbours make
//     each row interior along x);
//   - the velocities freeze on exactly the freeze rows lo and hi + st(f, d)
//     of open dims, resolved in band_halo's order (z, then y, then x):
//     march_put_wrapped takes F at the source's row of a y wrap, not the
//     target's, where a y or x freeze row takes the value;
//   - Vx's tail row (x = s0, which no band covers) keeps its source value,
//     unresolved, so every launch writes every cell of its targets;
//   - faces outside the base block along y and z take their source value
//     + 0, as in the chunk.
//
// The march.  A thread block owns the tile of source rows [y0, y0 + TY) x
// [z0, z0 + TZ) of one block (TY x TZ = 8 x 32 cells, one a thread) and
// walks x over a segment of the target's bounding box.  At each plane t it
//   1. forms, into shared-memory planes, the cell quantities of plane t
//      (gx, gy, gz, divV/3, P' = P - dtP divV, txx, tyy, tzz; over the
//      tile and the halo row and column below it), the shear stresses
//      txy and txz at x-face t + 1 and tyz at plane t (over the tile and
//      the halo row or column above it), from the staged velocities at t
//      and t + 1 and P at t, each over the tile and one halo row on each
//      side in y and z ((TY + 2) x (TZ + 2) cells; cells outside a field
//      are zeros, read by no update that is kept);
//   2. waits for its own asynchronous copies and meets the block at its
//      one barrier a plane;
//   3. starts the copies (cp.async) of the velocities at t + 3 and P and
//      Rho at t + 2 into the slots of plane t - 1, to arrive while it
//      computes the next two planes;
//   4. forms the face residuals of plane t from the quantity planes (txx,
//      P' of plane t - 1 and txy, txz of x-face t kept from the step
//      before) and writes every field's cells of plane t.
// A thread that leaves step 4 early forms plane t + 1's quantities while
// others still read plane t's: the quantity planes are rings of 3 (P',
// txx, txy, txz) and 2 (tyy, tzz, tyz), the staged ones of 4 (velocities)
// and 3 (P, Rho), so that no slot a step writes before the barrier is one
// the step before reads after it.
// Divisions a cell: 4 (cell quantities) + 6 (three shear stresses) + 12
// (three residuals) = 22, against stokes.cuh's 42; with the tile's halo
// 23.3.  The halo items go to warps that hold no other extra item, so no
// warp does more than one item beyond its own cells per stage.
//
// Shared memory a thread block holds (elements): 18 staged planes of
// (TY + 2)(TZ + 2) = 340 and 18 quantity planes of (TY + 1)(TZ + 1) = 297:
// 11,466 elements, 45,864 bytes in float32 and 91,728 in float64, within
// the 232,448 bytes a thread block may use (igg_torch/ops/_smem.py);
// float64 opts in above 48 KB.
//
// Wraps and the face rows without a second pass.  Every cell is computed
// once, at its source position, and written to each target that takes it:
// where y or z is one periodic block, row c of a field of extent S and
// overlap ol goes to target c (1 <= c <= S-2), to target 0 (c == S-ol) and
// to target S-1 (c == ol-1), the inverse of wrap_alias; the freeze is then
// taken at the target.  The tile spans the bounding box, so the staggered
// fields' face rows (k = o2, j = o1, t = o0) are tile rows like the
// others.  A thread resolves its cell's targets once for the whole march;
// only threads on a wrap's edge or alias rows resolve them per plane.
//
// Segments.  Where the tiles of a launch give fewer than MARCH_BLOCKS
// thread blocks (one 256^3 block: 297 tiles; 8 blocks of 288^3: 2,960),
// x is cut into segments of at least MARCH_MIN_SEG rows, one a thread
// block, so that the last wave of thread blocks is short; a segment starts
// one plane early to form the quantities of plane xa - 1 and x-face xa.
#pragma once

#include "async_copy.cuh"
#include "const_div.cuh"
#include "stokes.cuh"

namespace igg {

constexpr int MARCH_TY = 8;          // y rows of a tile
constexpr int MARCH_TZ = 32;         // z cells of a tile row
constexpr int MARCH_NT = 256;        // threads of a thread block
constexpr int MARCH_BLOCKS = 8192;   // thread blocks below which x is cut
constexpr int MARCH_MIN_SEG = 8;     // fewest x rows of a segment
constexpr int MARCH_AHEAD = 1;       // planes staged beyond the next one
// Thread blocks an SM holds at least (the register bound): 3 of 256
// threads in float32 (85 registers a thread), 2 in float64 (128).
constexpr int MARCH_MIN_BLOCKS_F32 = 3;
constexpr int MARCH_MIN_BLOCKS_F64 = 2;
// The staging rings: velocity planes t .. t + 2 + AHEAD, P and Rho planes
// t .. t + 1 + AHEAD (the march's note).
constexpr int MARCH_VRING = MARCH_AHEAD + 3;
constexpr int MARCH_PRING = MARCH_AHEAD + 2;

constexpr int MARCH_IY = MARCH_TY + 2, MARCH_IZ = MARCH_TZ + 2;
constexpr int MARCH_IN = MARCH_IY * MARCH_IZ;  // a staged plane
constexpr int MARCH_CY = MARCH_TY + 1, MARCH_CZ = MARCH_TZ + 1;
constexpr int MARCH_CN = MARCH_CY * MARCH_CZ;  // a quantity plane
constexpr int MARCH_OWN = MARCH_TY * MARCH_TZ;
constexpr int MARCH_CPT = MARCH_OWN / MARCH_NT;  // own cells a thread
constexpr int MARCH_SPT = (MARCH_IN + MARCH_NT - 1) / MARCH_NT;
constexpr int MARCH_ELEMS =
    (3 * MARCH_VRING + 2 * MARCH_PRING) * MARCH_IN + 18 * MARCH_CN;
static_assert(MARCH_OWN % MARCH_NT == 0, "a thread takes whole cells");

// The fields' staggers and freezes (stokes.cuh's; the same in every type).
using MarchLayout = Stokes<float>;

// Where each item list's halo items start among the threads: after the
// previous lists' halo items, rounded to whole warps.
constexpr int march_r32(int n) { return (n + 31) / 32 * 32; }
constexpr int MARCH_HC = MARCH_CN - MARCH_OWN;               // cells
constexpr int MARCH_HXY = MARCH_CY * MARCH_TZ - MARCH_OWN;   // txy
constexpr int MARCH_HXZ = MARCH_TY * MARCH_CZ - MARCH_OWN;   // txz
constexpr int MARCH_SXY = march_r32(MARCH_HC) % MARCH_NT;
constexpr int MARCH_SXZ = (march_r32(MARCH_HC) + march_r32(MARCH_HXY)) % MARCH_NT;
constexpr int MARCH_SYZ =
    (march_r32(MARCH_HC) + march_r32(MARCH_HXY) + march_r32(MARCH_HXZ)) %
    MARCH_NT;

template <typename T>
struct MarchArgs {
  const T* src[4];  // P, Vx, Vy, Vz
  const T* rho;     // Rho, laid out like P
  const T* F[4];    // the chunk-entry buffers (read where a dim freezes)
  T* out[4];        // the targets
  T mu, c2mu, dtP, dtV;
  ConstDiv<T> qx, qy, qz, q3;
  Stag3 g;
  int ty, tz;       // tiles of a block along y and z
  int nseg, seg;    // x segments of a block, rows of a segment
};

// Layout of field f (4: Rho) in y and z: 0 like P, 1 Vy's, 2 Vz's.
__host__ __device__ constexpr int march_lay(int f) {
  return f == 2 ? 1 : (f == 3 ? 2 : 0);
}

// The targets of source row c of a field along a dim (module note): its
// target index without a wrap, its wrap targets with one.
__device__ __forceinline__ int march_targets(int c, int wrap, int off, int o,
                                             int st, int size, int ol,
                                             int* tg) {
  int n = 0;
  if (!wrap) {
    const int t = c - off;
    if (t >= 0 && t < o + st) tg[n++] = t;
    return n;
  }
  if (c >= 1 && c <= size - 2) tg[n++] = c;
  if (c == size - ol) tg[n++] = 0;
  if (c == ol - 1) tg[n++] = size - 1;
  return n;
}

// Whether row c along a wrapped dim is an edge or an alias source of some
// field (its targets are then resolved per plane).
__device__ __forceinline__ bool march_special(const Stag3& g, int d, int c) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int size = g.s[d] + MarchLayout::st(f, d), ol = g.ol[f][d];
    if (c == 0 || c == size - 1 || c == size - ol || c == ol - 1) return true;
  }
  return false;
}

// a / qa + b / qb, both quotients in one batch.
template <typename T>
__device__ __forceinline__ T div_sum(T a, const ConstDiv<T>& qa, T b,
                                     const ConstDiv<T>& qb) {
  DivBatch<T> D;
  T x = D(a, qa), y = D(b, qb);
  if (!D.ok) {
    x = cdiv(a, qa);
    y = cdiv(b, qb);
  }
  return x + y;
}

// a / qa, b / qb, c / qc, e / qe into r[0..3], in one batch.
template <typename T>
__device__ __forceinline__ void march_quot4(T* r, T a, const ConstDiv<T>& qa,
                                            T b, const ConstDiv<T>& qb, T c,
                                            const ConstDiv<T>& qc, T e,
                                            const ConstDiv<T>& qe) {
  DivBatch<T> D;
  r[0] = D(a, qa);
  r[1] = D(b, qb);
  r[2] = D(c, qc);
  r[3] = D(e, qe);
  if (!D.ok) {
    r[0] = cdiv(a, qa);
    r[1] = cdiv(b, qb);
    r[2] = cdiv(c, qc);
    r[3] = cdiv(e, qe);
  }
}

// What a thread stages: its elements of a staged plane and their in-plane
// source offsets per layout (an x-plane of a stacked field holds fewer
// than 2^31 elements: launch_march).
template <typename T>
struct MarchStage {
  int off[MARCH_SPT][3];
  unsigned ok;         // bit 3m + L: element m lies inside layout L's block

  // The thread's elements of the plane of layout L at `base` (`pv`: the
  // plane lies inside the field), zeros where outside; `field` is the
  // field's first element, read by no copy.
  template <int L>
  __device__ __forceinline__ void stage(const T* field, const T* base,
                                        bool pv, T* dst) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int m = 0; m < MARCH_SPT; ++m) {
      const int e = tid + m * MARCH_NT;
      if (e >= MARCH_IN) break;
      const bool in = pv && (ok >> (3 * m + L) & 1u);
      march_copy(dst + e, in ? base + off[m][L] : field, in);
    }
  }
};

// A thread's own cell: its targets where they are its own position.
struct MarchOwn {
  int out[3];        // in-plane target offset per layout
  int src[3];        // in-plane source offset per layout (the freezes)
  unsigned has;      // bit f: field f has a target in y and z
  unsigned fyz;      // bit f: that target is frozen by the y or z freeze
  unsigned inner;    // bit d: (j, k) is inside velocity d's interior faces
  int j, k;          // source row and column
  bool simple;       // targets resolved once (not on a wrap's special row)
};

__device__ __forceinline__ long long march_inplane(const int* e, const int* n,
                                                   int L, int b1, int j,
                                                   int b2, int k) {
  const long long w1 = e[1] + (L == 1), w2 = e[2] + (L == 2);
  return ((long long)b1 * w1 + j) * ((long long)n[2] * w2) +
         (long long)b2 * w2 + k;
}

// Whether row c of block bl along d is one of field f's freeze rows of
// the band walk: exactly lo and hi + st(f, d) (the chunk's are every row
// from them outward: frozen3).
__device__ __forceinline__ bool march_band_row(const Stag3& g, int f, int d,
                                               int bl, int c) {
  return f >= 1 && g.frz[d] &&
         ((bl == 0 && c == g.lo[d]) ||
          (bl == g.n[d] - 1 && c == g.hi[d] + MarchLayout::st(f, d)));
}

template <bool BAND>
__device__ __forceinline__ MarchOwn march_own(const Stag3& g, const int* b,
                                              int j, int k) {
  MarchOwn w;
  w.j = j;
  w.k = k;
  w.has = 0;
  w.fyz = 0;
  const int s1 = g.s[1], s2 = g.s[2];
  w.inner = (j >= 1 && j <= s1 - 2 && k >= 1 && k <= s2 - 2 ? 1u : 0u) |
            (j >= 1 && j <= s1 - 1 && k >= 1 && k <= s2 - 2 ? 2u : 0u) |
            (j >= 1 && j <= s1 - 2 && k >= 1 && k <= s2 - 1 ? 4u : 0u);
  w.simple = !((g.wrap[1] && march_special(g, 1, j)) ||
               (g.wrap[2] && march_special(g, 2, k)));
  int ty[3], tz[3];
#pragma unroll
  for (int L = 0; L < 3; ++L) {
    w.src[L] = (int)march_inplane(g.s, g.n, L, b[1], j, b[2], k);
    ty[L] = g.wrap[1] ? j : j - g.off[1];
    tz[L] = g.wrap[2] ? k : k - g.off[2];
    w.out[L] = (int)march_inplane(g.o, g.n, L, b[1], ty[L], b[2], tz[L]);
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int L = march_lay(f), sy = L == 1, sz = L == 2;
    const bool oky = g.wrap[1] ? j >= 1 && j <= g.s[1] + sy - 2
                               : ty[L] >= 0 && ty[L] < g.o[1] + sy;
    const bool okz = g.wrap[2] ? k >= 1 && k <= g.s[2] + sz - 2
                               : tz[L] >= 0 && tz[L] < g.o[2] + sz;
    if (oky && okz) w.has |= 1u << f;
    // The y and z terms of frozen3 (x is taken per plane; the band walk's
    // exact rows in band mode).
    const int c[3] = {0, j, k};
    bool fr = false;
#pragma unroll
    for (int d = 1; d < 3; ++d)
      if constexpr (BAND)
        fr = fr || march_band_row(g, f, d, b[d], c[d]);
      else
        fr = fr || (f >= 1 && g.frz[d] &&
                    ((b[d] == 0 && c[d] <= g.lo[d]) ||
                     (b[d] == g.n[d] - 1 &&
                      c[d] >= g.hi[d] + MarchLayout::st(f, d))));
    if (fr) w.fyz |= 1u << f;
  }
  return w;
}

// Elements of an x-plane of a stacked field of layout L on base blocks e.
__device__ __forceinline__ long long march_plane_size(const int* e,
                                                      const int* n, int L) {
  return (long long)n[1] * (e[1] + (L == 1)) * n[2] * (e[2] + (L == 2));
}

// Where plane t of each field goes: its target x-plane (null where plane t
// has no target), its chunk-entry x-plane and whether the x freeze takes
// it; formed once a step.
template <typename T>
struct MarchPlane {
  T* out[4];
  const T* F[4];
  unsigned fx;  // bit f: field f's plane t re-freezes on x
};

template <bool BAND, typename T>
__device__ __forceinline__ MarchPlane<T> march_plane(const MarchArgs<T>& m,
                                                     const int* b, int t) {
  const Stag3& g = m.g;
  MarchPlane<T> p;
  p.fx = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int sx = f == 1, L = march_lay(f), tx = t - g.off[0];
    p.out[f] = tx >= 0 && tx < g.o[0] + sx
                   ? m.out[f] + ((long long)b[0] * (g.o[0] + sx) + tx) *
                                    march_plane_size(g.o, g.n, L)
                   : nullptr;
    p.F[f] = m.F[f] + ((long long)b[0] * (g.s[0] + sx) + t) *
                          march_plane_size(g.s, g.n, L);
    if constexpr (BAND) {
      if (march_band_row(g, f, 0, b[0], t)) p.fx |= 1u << f;
    } else if (f >= 1 && g.frz[0] &&
               ((b[0] == 0 && t <= g.lo[0]) ||
                (b[0] == g.n[0] - 1 && t >= g.hi[0] + sx))) {
      p.fx |= 1u << f;
    }
  }
  return p;
}

// a[f] for a runtime f, by constant indices only (a runtime index into a
// kernel parameter puts the parameters in a stack frame).
template <typename A>
__device__ __forceinline__ A march_pick(const A* a, int f) {
  A x = a[0];
#pragma unroll
  for (int h = 1; h < 4; ++h)
    if (f == h) x = a[h];
  return x;
}

// The four fields' values v at source plane t of a cell (j, k) on a wrap's
// edge or alias rows, to each of their targets.  Few threads take it: one
// loop over the fields, not unrolled, keeps its code small in the march's
// loop.  The chunk freezes a target where frozen3 takes it, from F at the
// target; the band walk (BAND) resolves z, then y, then x (band_halo's
// order, later dims winning): a target on a z freeze row takes F there, on
// a y or x freeze row F at the source's z (the z wrap having moved the
// value along z first), on an x freeze row F at the source cell.
template <bool BAND, typename T>
__device__ __forceinline__ void march_put_wrapped(const MarchArgs<T>& m,
                                                  const int* b,
                                                  const MarchOwn& w,
                                                  const MarchPlane<T>& p,
                                                  int t, const T* v) {
  const Stag3& g = m.g;
#pragma unroll 1
  for (int f = 0; f < 4; ++f) {
    T* const out = march_pick(p.out, f);
    if (out == nullptr) continue;
    const int L = march_lay(f), sx = f == 1, sy = L == 1, sz = L == 2;
    const int oly = f == 0 ? g.ol[0][1] : f == 1 ? g.ol[1][1]
                    : f == 2 ? g.ol[2][1] : g.ol[3][1];
    const int olz = f == 0 ? g.ol[0][2] : f == 1 ? g.ol[1][2]
                    : f == 2 ? g.ol[2][2] : g.ol[3][2];
    const T* const F = march_pick(m.F, f);
    T* const base = march_pick(m.out, f);
    const T val = march_pick(v, f);
    int ty[3], tz[3];
    const int ny = march_targets(w.j, g.wrap[1], g.off[1], g.o[1], sy,
                                 g.s[1] + sy, oly, ty);
    const int nz = march_targets(w.k, g.wrap[2], g.off[2], g.o[2], sz,
                                 g.s[2] + sz, olz, tz);
#pragma unroll 1
    for (int a = 0; a < ny * nz; ++a) {
      const int yt = ty[a / nz], zt = tz[a % nz];
      const int at[3] = {t, yt + g.off[1], zt + g.off[2]};
      T u = val;
      if constexpr (BAND) {
        const bool fz = march_band_row(g, f, 2, b[2], at[2]);
        if (fz || march_band_row(g, f, 1, b[1], at[1]) ||
            march_band_row(g, f, 0, b[0], t))
          u = ld(F + at3(g.s, g.n, sx, sy, sz, b[0], t, b[1],
                         fz ? at[1] : w.j, b[2], w.k));
      } else if (frozen3<MarchLayout>(g, f, b, at)) {
        u = ld(F + at3(g.s, g.n, sx, sy, sz, b[0], at[0], b[1], at[1], b[2],
                       at[2]));
      }
      base[at3(g.o, g.n, sx, sy, sz, b[0], t - g.off[0], b[1], yt, b[2],
               zt)] = u;
    }
  }
}

// Field f's value v at source plane t of a thread's own cell, to its own
// position (cells on a wrap's edge or alias rows: march_put_wrapped).
template <typename T>
__device__ __forceinline__ void march_put(const MarchOwn& w,
                                          const MarchPlane<T>& p, int f,
                                          T v) {
  if (p.out[f] == nullptr || !(w.has >> f & 1u)) return;
  if ((p.fx | w.fyz) >> f & 1u) v = ld(p.F[f] + w.src[march_lay(f)]);
  p.out[f][w.out[march_lay(f)]] = v;
}

// The march of one thread block: the chunk step, or one banded iteration
// (BAND: the module note's band mode; the profiler names it
// stokes_march_kernel<T, true>).
template <typename T, bool BAND>
__global__ void __launch_bounds__(MARCH_NT, sizeof(T) == 4
                                                ? MARCH_MIN_BLOCKS_F32
                                                : MARCH_MIN_BLOCKS_F64)
    stokes_march_kernel(MarchArgs<T> m) {
  extern __shared__ __align__(16) unsigned char march_smem[];
  constexpr int IZ = MARCH_IZ, IN = MARCH_IN, CZ = MARCH_CZ, CN = MARCH_CN;
  constexpr int TY = MARCH_TY, TZ = MARCH_TZ, NT = MARCH_NT;
  constexpr int OWN = MARCH_OWN;
  const Stag3& g = m.g;
  const int tid = threadIdx.x;
  const int b[3] = {(int)blockIdx.z / m.nseg, (int)blockIdx.y / m.ty,
                    (int)blockIdx.x / m.tz};
  const int seg = blockIdx.z - b[0] * m.nseg;
  const int y0 = g.off[1] + (blockIdx.y - b[1] * m.ty) * TY;
  const int z0 = g.off[2] + (blockIdx.x - b[2] * m.tz) * TZ;
  const int xa = g.off[0] + seg * m.seg;
  const int xend = g.off[0] + g.o[0] + 1;
  const int xb = xa + m.seg < xend ? xa + m.seg : xend;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];

  T* const sm = reinterpret_cast<T*>(march_smem);
  constexpr int VR = MARCH_VRING, PR = MARCH_PRING, AH = MARCH_AHEAD;
  T* const vring = sm;                 // [Vx, Vy, Vz][VR][IN]
  T* const pring = sm + 3 * VR * IN;   // [P, Rho][PR][IN]
  T* const qs = pring + 2 * PR * IN;
  T* const pnq = qs;             // P' [3][CN] (planes t, t-1, t+1)
  T* const txxq = qs + 3 * CN;   // txx [3][CN]
  T* const txyq = qs + 6 * CN;   // txy [3][CN] (x-faces t, t+1, t+2)
  T* const txzq = qs + 9 * CN;   // txz [3][CN]
  T* const tyyq = qs + 12 * CN;  // tyy [2][CN] (planes t, t+1)
  T* const tzzq = qs + 14 * CN;  // tzz [2][CN]
  T* const tyzq = qs + 16 * CN;  // tyz [2][CN]

  MarchStage<T> st;
  st.ok = 0;
#pragma unroll
  for (int q = 0; q < MARCH_SPT; ++q) {
    const int e = tid + q * NT;
    const int jj = e / IZ, kk = e - jj * IZ;
    const int j = y0 - 1 + jj, k = z0 - 1 + kk;
#pragma unroll
    for (int L = 0; L < 3; ++L) {
      st.off[q][L] = (int)march_inplane(g.s, g.n, L, b[1], j, b[2], k);
      if (e < IN && j >= 0 && j < s1 + (L == 1) && k >= 0 &&
          k < s2 + (L == 2))
        st.ok |= 1u << (3 * q + L);
    }
  }
  MarchOwn own[MARCH_CPT];
#pragma unroll
  for (int n = 0; n < MARCH_CPT; ++n) {
    const int e = tid + n * NT;
    own[n] = march_own<BAND>(g, b, y0 + e / TZ, z0 + e % TZ);
  }

  // Plane p of a field of layout L and x extent e0 of the thread block's
  // block (a plane outside the field is staged as zeros by the chunk, as
  // the block's first or last plane of that field by the band walk).
  auto plane_of = [&](const T* f, int L, int e0, int p) {
    return f + ((long long)b[0] * e0 + p) * march_plane_size(g.s, g.n, L);
  };
  auto stage_v = [&](int i) {
    const int p = xa - 1 + i, slot = i % VR;
    if constexpr (BAND) {
      const int px = march_clamp(p, 0, s0), pc = march_clamp(p, 0, s0 - 1);
      st.template stage<0>(m.src[1], plane_of(m.src[1], 0, s0 + 1, px),
                           true, vring + (0 * VR + slot) * IN);
      st.template stage<1>(m.src[2], plane_of(m.src[2], 1, s0, pc), true,
                           vring + (1 * VR + slot) * IN);
      st.template stage<2>(m.src[3], plane_of(m.src[3], 2, s0, pc), true,
                           vring + (2 * VR + slot) * IN);
      return;
    }
    const bool in = p >= 0 && p < s0;
    st.template stage<0>(m.src[1], plane_of(m.src[1], 0, s0 + 1, p),
                         p >= 0 && p <= s0, vring + (0 * VR + slot) * IN);
    st.template stage<1>(m.src[2], plane_of(m.src[2], 1, s0, p), in,
                         vring + (1 * VR + slot) * IN);
    st.template stage<2>(m.src[3], plane_of(m.src[3], 2, s0, p), in,
                         vring + (2 * VR + slot) * IN);
  };
  auto stage_p = [&](int i) {
    const int q = xa - 1 + i, slot = i % PR;
    const int p = BAND ? march_clamp(q, 0, s0 - 1) : q;
    const bool in = BAND || (p >= 0 && p < s0);
    st.template stage<0>(m.src[0], plane_of(m.src[0], 0, s0, p), in,
                         pring + slot * IN);
    st.template stage<0>(m.rho, plane_of(m.rho, 0, s0, p), in,
                         pring + (PR + slot) * IN);
  };
  // Velocity plane xa - 1 + i lives in slot i % VR, P's and Rho's in
  // i % PR.  One barrier a step: step u forms the quantities of plane u
  // from velocity planes u, u + 1 and P plane u, waits for its own copies
  // and meets the others at the barrier, then stages velocity plane
  // u + 2 + AH and P, Rho plane u + 1 + AH into the slots of plane u - 1
  // (read last before this barrier) and forms the residuals of plane u.
  // So plane u + 2, staged AH + 1 steps earlier, is in and seen by all
  // before step u + 1 forms its quantities; the quantity planes a step
  // writes before the barrier are not those the step before reads after
  // its own (rings of 3 and 2).
  const int steps = xb - xa + 1;
#pragma unroll
  for (int i = 0; i <= AH + 1; ++i) stage_v(i);
#pragma unroll
  for (int i = 0; i <= AH; ++i) stage_p(i);
  march_commit();
  march_wait<0>();
  __syncthreads();

  for (int u = 0, t = xa - 1; t < xb; ++u, ++t) {
    const int v0 = u % VR, v1 = (u + 1) % VR, p0 = u % PR;
    const int c0 = u % 3, cm = (u + 2) % 3, c1 = (u + 1) % 3, h0 = u & 1;
    const T* vx0 = vring + (0 * VR + v0) * IN;
    const T* vx1 = vring + (0 * VR + v1) * IN;
    const T* vy0 = vring + (1 * VR + v0) * IN;
    const T* vy1 = vring + (1 * VR + v1) * IN;
    const T* vz0 = vring + (2 * VR + v0) * IN;
    const T* vz1 = vring + (2 * VR + v1) * IN;
    const T* pp = pring + p0 * IN;
    const T* rr = pring + (PR + p0) * IN;
    T* const pnw = pnq + c0 * CN;     // P' of plane t
    T* const txxw = txxq + c0 * CN;
    T* const tyyw = tyyq + h0 * CN;
    T* const tzzw = tzzq + h0 * CN;
    T* const tyzw = tyzq + h0 * CN;
    T* const txyw = txyq + c1 * CN;   // txy of x-face t + 1
    T* const txzw = txzq + c1 * CN;

    // Cell quantities of plane t: own cells (cj, ck) = (a+1, c+1), then
    // the halo row cj = 0 and column ck = 0.
    for (int e = tid; e < CN; e += NT) {
      int cj, ck;
      if (e < OWN) {
        cj = e / TZ + 1;
        ck = e % TZ + 1;
      } else if (e - OWN < CZ) {
        cj = 0;
        ck = e - OWN;
      } else {
        cj = e - OWN - CZ + 1;
        ck = 0;
      }
      const int i = cj * IZ + ck, ci = cj * CZ + ck;
      const T ax = vx1[i] - vx0[i], ay = vy0[i + IZ] - vy0[i],
              az = vz0[i + 1] - vz0[i];
      DivBatch<T> D;
      T gx = D(ax, m.qx), gy = D(ay, m.qy), gz = D(az, m.qz);
      if (!D.ok) {
        gx = cdiv(ax, m.qx);
        gy = cdiv(ay, m.qy);
        gz = cdiv(az, m.qz);
      }
      const T div = (gx + gy) + gz;
      pnw[ci] = pp[i] - m.dtP * div;
      const T d3 = cdiv(div, m.q3);
      txxw[ci] = m.c2mu * (gx - d3);
      tyyw[ci] = m.c2mu * (gy - d3);
      tzzw[ci] = m.c2mu * (gz - d3);
    }
    // txy at x-face t + 1: y-faces y0 + ej (ej in [0, TY]), cells z0 + ek.
    for (int e = (tid + NT - MARCH_SXY) % NT; e < MARCH_CY * TZ; e += NT) {
      const int ej = e < OWN ? e / TZ : TY, ek = e < OWN ? e % TZ : e - OWN;
      const int i = (ej + 1) * IZ + ek + 1;
      txyw[ej * CZ + ek] = m.mu * div_sum(vx1[i] - vx1[i - IZ], m.qy,
                                          vy1[i] - vy0[i], m.qx);
    }
    // txz at x-face t + 1: cells y0 + ej, z-faces z0 + ek (ek in [0, TZ]).
    for (int e = (tid + NT - MARCH_SXZ) % NT; e < TY * CZ; e += NT) {
      const int ej = e < OWN ? e / TZ : e - OWN, ek = e < OWN ? e % TZ : TZ;
      const int i = (ej + 1) * IZ + ek + 1;
      txzw[ej * CZ + ek] = m.mu * div_sum(vx1[i] - vx1[i - 1], m.qz,
                                          vz1[i] - vz0[i], m.qx);
    }
    // tyz at plane t: y-faces y0 + ej, z-faces z0 + ek, both in [0, T*]
    // but for the corner (TY, TZ), which no residual reads.
    for (int e = (tid + NT - MARCH_SYZ) % NT; e < CN - 1; e += NT) {
      int ej, ek;
      if (e < OWN) {
        ej = e / TZ;
        ek = e % TZ;
      } else if (e - OWN < TZ) {
        ej = TY;
        ek = e - OWN;
      } else {
        ej = e - OWN - TZ;
        ek = TZ;
      }
      const int i = (ej + 1) * IZ + ek + 1;
      tyzw[ej * CZ + ek] = m.mu * div_sum(vy0[i] - vy0[i - 1], m.qz,
                                          vz0[i] - vz0[i - IZ], m.qy);
    }
    march_wait<AH - 1>();
    __syncthreads();
    if (u + 2 + AH <= steps) stage_v(u + 2 + AH);
    if (u + 1 + AH < steps) stage_p(u + 1 + AH);
    march_commit();
    if (t < xa) continue;
    const MarchPlane<T> pl = march_plane<BAND>(m, b, t);

    // The face residuals and every field's cells of plane t.
    const T* pn = pnw;
    const T* pnp = pnq + cm * CN;     // P' of plane t - 1
    const T* txxp = txxq + cm * CN;
    const T* txy = txyq + c0 * CN;    // x-face t
    const T* txz = txzq + c0 * CN;
#pragma unroll
    for (int n = 0; n < MARCH_CPT; ++n) {
      const int e = tid + n * NT, a = e / TZ, c = e % TZ;
      const MarchOwn& w = own[n];
      const int cc = (a + 1) * CZ + c + 1, ec = a * CZ + c;
      const int ic = (a + 1) * IZ + c + 1;
      if constexpr (BAND) {
        if (t == s0) {  // Vx's tail row: its source value, as it stands
          const int ty = g.wrap[1] ? w.j : w.j - g.off[1];
          const int tz = g.wrap[2] ? w.k : w.k - g.off[2];
          if (pl.out[1] != nullptr && ty >= 0 && ty < g.o[1] && tz >= 0 &&
              tz < g.o[2])
            pl.out[1][w.out[0]] = vx0[ic];
          continue;
        }
      }
      const T pc = pn[cc];
      // The twelve quotients of the three residuals, in batches of four
      // (at a face that is not interior they are formed and not used).
      T r[12];
      march_quot4(r, txxw[cc] - txxp[cc], m.qx, txy[ec + CZ] - txy[ec], m.qy,
                  txz[ec + 1] - txz[ec], m.qz, pc - pnp[cc], m.qx);
      march_quot4(r + 4, tyyw[cc] - tyyw[cc - CZ], m.qy, txyw[ec] - txy[ec],
                  m.qx, tyzw[ec + 1] - tyzw[ec], m.qz, pc - pn[cc - CZ], m.qy);
      march_quot4(r + 8, tzzw[cc] - tzzw[cc - 1], m.qz, txzw[ec] - txz[ec],
                  m.qx, tyzw[ec + CZ] - tyzw[ec], m.qy, pc - pn[cc - 1], m.qz);
      // Faces interior along x: the chunk's, or every row of the band walk
      // (its windows' clamped rows make each row interior).
      T vx = vx0[ic] + T(0), vy = vy0[ic] + T(0), vz = vz0[ic] + T(0);
      if ((BAND || (t >= 1 && t <= s0 - 1)) && (w.inner >> 0 & 1u))
        vx = vx0[ic] + m.dtV * (((r[0] + r[1]) + r[2]) - r[3]);
      if ((BAND || (t >= 1 && t <= s0 - 2)) && (w.inner >> 1 & 1u))
        vy = vy0[ic] + m.dtV * (((r[4] + r[5]) + r[6]) - r[7]);
      if ((BAND || (t >= 1 && t <= s0 - 2)) && (w.inner >> 2 & 1u)) {
        const T rz = (((r[8] + r[9]) + r[10]) - r[11]) +
                     T(0.5) * (rr[ic] + rr[ic - 1]);
        vz = vz0[ic] + m.dtV * rz;
      }
      if (w.simple) {
        march_put(w, pl, 0, pc);
        march_put(w, pl, 1, vx);
        march_put(w, pl, 2, vy);
        march_put(w, pl, 3, vz);
      } else {
        const T v[4] = {pc, vx, vy, vz};
        march_put_wrapped<BAND>(m, b, w, pl, t, v);
      }
    }
  }
}

template <typename T>
size_t march_smem_bytes() {
  return sizeof(T) * (size_t)MARCH_ELEMS;
}

// Launch one chunk iteration (BAND: one banded iteration): thread blocks
// of MARCH_NT threads over (z tiles, y tiles, x segments) of every block;
// above 48 KB of shared memory (float64) the kernel opts in first.
template <bool BAND, typename T>
int launch_march(MarchArgs<T> m, cudaStream_t stream) {
  const Stag3& g = m.g;
  m.ty = (g.o[1] + 1 + MARCH_TY - 1) / MARCH_TY;
  m.tz = (g.o[2] + 1 + MARCH_TZ - 1) / MARCH_TZ;
  const int rows = g.o[0] + 1;
  const long long tiles = (long long)m.ty * m.tz * g.n[0] * g.n[1] * g.n[2];
  long long nseg = (MARCH_BLOCKS + tiles - 1) / tiles;
  const long long most = rows / MARCH_MIN_SEG > 1 ? rows / MARCH_MIN_SEG : 1;
  if (nseg > most) nseg = most;
  m.seg = (int)((rows + nseg - 1) / nseg);
  m.nseg = (rows + m.seg - 1) / m.seg;
  const long long gx = (long long)m.tz * g.n[2], gy = (long long)m.ty * g.n[1];
  const long long gz = (long long)m.nseg * g.n[0];
  if (gx > 0x7fffffffLL || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidConfiguration;
  for (int L = 0; L < 3; ++L) {  // in-plane offsets are 32-bit
    const int* e[2] = {g.s, g.o};
    for (const int* x : e)
      if ((long long)g.n[1] * (x[1] + (L == 1)) * g.n[2] * (x[2] + (L == 2)) >
          0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = march_smem_bytes<T>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stokes_march_kernel<T, BAND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  stokes_march_kernel<T, BAND><<<grid, MARCH_NT, bytes, stream>>>(m);
  return (int)cudaGetLastError();
}

}  // namespace igg
