// Fused Stokes iteration: one launch writes the pseudo-transient update of
// every block of a block-stacked grid's (P, Vx, Vy, Vz) into new tensors:
// the pressure on every cell, the velocities on their block's interior
// faces, the outer faces copied through with an exact +0 (stokes.cuh's
// semantics: targets = whole blocks, no wrap, nothing frozen; Rho is read
// only).  No halo planes: the grouped update_halo of the four fields
// follows, through the port's halo engine.
//
// Replaces the TPU kernel of igg/ops/stokes_pallas.py (_kernel,
// _call_kernel; entries fused_stokes_iteration, make_iteration's
// per-iteration tier), which held x-slabs of the five fields in VMEM and
// assembled the halo planes in the kernel from send planes recomputed on
// thin windows.  In-kernel halo assembly is later work here.
//
// What bounds it on the H100: bytes, by the roofline.  It reads P, Vx, Vy,
// Vz and Rho once and writes the four updated fields once: at one 256^3
// f32 block that is 606 MB, 0.181 ms at 3.35 TB/s.  But it does about 77
// operations a cell, 22 of them divisions when each quotient is formed
// once, and its issued instructions, not the bytes, set its time.  Its
// first design (stokes.cuh's 2-cell runs on stagger_walk3.cuh, kept in
// kernel_variants.py) recomputed the quotients of the rows at x-1 and y-1
// and of the shared edges: 42 IEEE divisions a cell, 0.926 ms at one
// periodic 256^3 block (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  The
// x-march of the chunk and band kernels (stokes_march.cuh) forms each
// quotient once but spends most of its instructions on wraps, freezes,
// per-plane targets and the tile's halo items.
//
// What the design does about it: an x-march of its own, with none of the
// chunk's machinery.  A thread block of SS_W = 4 warps owns a (y, z) tile
// of 4C rows by 32 columns of one block, a lane one column of C = 2 cells
// along y, and walks x over a segment of the block; the five fields'
// planes are staged by cp.async in shared-memory rings, one barrier a
// plane.  Each cell quantity (P', txx,
// tyy, tzz), shear stress and residual quotient is formed once: 22
// divisions a cell, plus per lane the cell above its column (P', tyy) and
// the edges below it (txy, tyz), so that no quantity crosses a warp along
// y.  The quantities of plane t - 1 and x-face t that a cell reads (P',
// txx, txy, txz) stay in registers from the step before; only the z
// neighbours' P', tzz (k - 1) and tyz, txz (k + 1) go through shared
// memory, the tile's edge columns formed by 2C lanes of each warp.  Each
// cell's target is its source position: no target resolution, the 64-bit
// plane offsets moved by one plane a step.  The face rows outside the
// cells (Vx's x = s0, Vy's y = s1, Vz's z = s2, all outer faces) are
// copied by the threads beside them, so the tiles cover the cells alone.
//
// Choices, timed on an H100 80GB HBM3 at 700 W at one periodic 256^3
// block (kernel_variants.py, PERF.md): 0.485 ms in float32, 1.89 times
// faster than the first design in the same call.  Cells a lane: 1 ran
// 25% slower, 4 ran 10% slower (152 registers against 120); in float64 1
// ran 10% slower.  Two warps a thread block ran 7% slower.  IEEE `x / d`
// ran 15% slower in float32 and 87% slower at rest (zero dividends take its
// slow path).  The register bound of 3 thread blocks an SM in float64
// (167 registers) ran 19% faster than 2.  Segments until 4096 thread
// blocks: 2048 ran 23% slower on phase 12's evolved state (whose tiny
// dividends leave const_div.cuh's range unevenly across the tiles), 8192
// 12% slower on random fields.  Keeping zero dividends on the reciprocal
// path (ss_zero) ran 13% slower on random fields and 37% faster at rest;
// a float64 reciprocal fallback for the tiny ones (ss_wide) 26% slower on
// the evolved state: neither is taken.
#include "async_copy.cuh"
#include "const_div.cuh"

namespace igg {

constexpr int SS_TZ = 32;             // z cells of a tile: a warp's lanes
constexpr int SS_W = 4;               // warps of a thread block, along y
constexpr int SS_C_F32 = 2;           // y cells of a lane's column, float32
constexpr int SS_C_F64 = 2;           // and float64
constexpr int SS_BLOCKS = 4096;       // thread blocks below which x is cut
constexpr int SS_MIN_SEG = 8;         // fewest x rows of a segment
constexpr int SS_AHEAD = 1;           // planes staged beyond the next one
// Thread blocks an SM holds at least (the register bound).
constexpr int SS_MIN_BLOCKS_F32 = 3;
constexpr int SS_MIN_BLOCKS_F64 = 3;
// Whether the march divides by IEEE `x / d` rather than by const_div.cuh.
template <typename T>
constexpr bool ss_ieee = false;

template <typename T>
struct SsShape {
  static constexpr int C = sizeof(T) == 4 ? SS_C_F32 : SS_C_F64;
  static constexpr int TY = SS_W * C, TZ = SS_TZ, NT = 32 * SS_W;
  static constexpr int IZ = TZ + 2, IN = (TY + 2) * IZ;  // a staged plane
  static constexpr int QZ = TZ + 1, QN = TY * QZ;  // a neighbour plane
  // Staging rings: velocities t - 1 .. t + 2 + AHEAD, P and Rho t - 1 ..
  // t + 1 + AHEAD.
  static constexpr int VR = SS_AHEAD + 3, PR = SS_AHEAD + 2;
  static constexpr int SPT = (IN + NT - 1) / NT;  // staged elements a thread
  static constexpr int ELEMS = (3 * VR + 2 * PR) * IN + 8 * QN;
};
static_assert(SS_TZ == 32, "a warp's lanes are a tile row");

template <typename T>
struct SsArgs {
  const T* src[4];  // P, Vx, Vy, Vz
  const T* rho;     // Rho, laid out like P
  T* out[4];        // the targets, laid out like the sources
  T mu, c2mu, dtP, dtV;
  ConstDiv<T> qx, qy, qz, q3;  // dx, dy, dz, 3
  int n[3], s[3];   // blocks and P's block extents
  int ty, tz;       // tiles of a block along y and z
  int nseg, seg;    // x segments of a block, rows of a segment
};

// x / d one at a time (a batch's fallback).
template <bool IEEE, typename T>
__device__ __forceinline__ T ss_div(T x, const ConstDiv<T>& q) {
  if constexpr (IEEE)
    return x / q.d;
  else
    return cdiv(x, q);
}

// A batch of divisions: on the reciprocal path (`ok` clears where a
// dividend is outside its range, and the caller forms the batch again with
// ss_div), or IEEE.
template <typename T, bool IEEE>
struct SsBatch {
  bool ok = true;
  __device__ __forceinline__ T operator()(T x, const ConstDiv<T>& q) {
    if constexpr (IEEE) return x / q.d;
    ok = ok & div_admits(x, q);
    return div_fast(x, q);
  }
};

// The quantities of a cell from its three velocity differences and its
// pressure: P' and the normal stresses (stokes.cuh's association).
template <bool IEEE, typename T>
__device__ __forceinline__ void ss_cell(const SsArgs<T>& m, T ax, T ay, T az,
                                        T p, T& pn, T& txx, T& tyy, T& tzz) {
  SsBatch<T, IEEE> D;
  T gx = D(ax, m.qx), gy = D(ay, m.qy), gz = D(az, m.qz);
  if (!D.ok) {
    gx = ss_div<IEEE>(ax, m.qx);
    gy = ss_div<IEEE>(ay, m.qy);
    gz = ss_div<IEEE>(az, m.qz);
  }
  const T div = (gx + gy) + gz;
  pn = p - m.dtP * div;
  const T d3 = ss_div<IEEE>(div, m.q3);
  txx = m.c2mu * (gx - d3);
  tyy = m.c2mu * (gy - d3);
  tzz = m.c2mu * (gz - d3);
}

// A shear stress: mu (a / qa + b / qb).
template <bool IEEE, typename T>
__device__ __forceinline__ T ss_shear(const SsArgs<T>& m, T a,
                                      const ConstDiv<T>& qa, T b,
                                      const ConstDiv<T>& qb) {
  SsBatch<T, IEEE> D;
  T x = D(a, qa), y = D(b, qb);
  if (!D.ok) {
    x = ss_div<IEEE>(a, qa);
    y = ss_div<IEEE>(b, qb);
  }
  return m.mu * (x + y);
}

// a / qa, b / qb, c / qc, e / qe into r[0..3], in one batch.
template <bool IEEE, typename T>
__device__ __forceinline__ void ss_quot4(T* r, T a, const ConstDiv<T>& qa,
                                         T b, const ConstDiv<T>& qb, T c,
                                         const ConstDiv<T>& qc, T e,
                                         const ConstDiv<T>& qe) {
  SsBatch<T, IEEE> D;
  r[0] = D(a, qa);
  r[1] = D(b, qb);
  r[2] = D(c, qc);
  r[3] = D(e, qe);
  if (!D.ok) {
    r[0] = ss_div<IEEE>(a, qa);
    r[1] = ss_div<IEEE>(b, qb);
    r[2] = ss_div<IEEE>(c, qc);
    r[3] = ss_div<IEEE>(e, qe);
  }
}

template <typename T>
__global__ void __launch_bounds__(SsShape<T>::NT, sizeof(T) == 4
                                                      ? SS_MIN_BLOCKS_F32
                                                      : SS_MIN_BLOCKS_F64)
    stokes_step_kernel(SsArgs<T> m) {
  using S = SsShape<T>;
  constexpr int C = S::C, TY = S::TY, TZ = S::TZ, NT = S::NT;
  constexpr int IZ = S::IZ, IN = S::IN, QZ = S::QZ, QN = S::QN;
  constexpr int VR = S::VR, PR = S::PR, AH = SS_AHEAD;
  constexpr bool IEEE = ss_ieee<T>;
  extern __shared__ __align__(16) unsigned char ss_smem[];
  T* const sm = reinterpret_cast<T*>(ss_smem);
  T* const vring = sm;                // [Vx, Vy, Vz][VR][IN]
  T* const pring = sm + 3 * VR * IN;  // [P, Rho][PR][IN]
  // The z neighbours' quantities, rings of 2 planes of TY rows: P' and
  // tzz of plane t at columns z0 - 1 .. z0 + TZ - 1, tyz of plane t and
  // txz of x-face t + 1 at columns z0 .. z0 + TZ.
  T* const qpn = pring + 2 * PR * IN;
  T* const qzz = qpn + 2 * QN;
  T* const qyz = qzz + 2 * QN;
  T* const qxz = qyz + 2 * QN;

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int s0 = m.s[0], s1 = m.s[1], s2 = m.s[2];
  const int b0 = blockIdx.z / m.nseg, b1 = blockIdx.y / m.ty;
  const int b2 = blockIdx.x / m.tz;
  const int seg = blockIdx.z - b0 * m.nseg;
  const int y0 = (blockIdx.y - b1 * m.ty) * TY;
  const int z0 = (blockIdx.x - b2 * m.tz) * TZ;
  const int xa = seg * m.seg;
  const int xb = xa + m.seg < s0 ? xa + m.seg : s0;
  // Rows of an x-plane: P, Rho, Vx and Vy (W0 elements), Vz (W2); the
  // planes: P's (and Rho's, Vx's) ps0, Vy's ps1, Vz's ps2.
  const int W0 = m.n[2] * s2, W2 = m.n[2] * (s2 + 1);
  const long long ps0 = (long long)m.n[1] * s1 * W0;
  const long long ps1 = (long long)m.n[1] * (s1 + 1) * W0;
  const long long ps2 = (long long)m.n[1] * s1 * W2;

  // What the thread stages: its elements of a plane, their in-plane
  // offsets in the three layouts (P's, Vy's, Vz's) and whether they lie
  // inside the field (bit 3q + L).
  int soff[S::SPT][3];
  unsigned sok = 0;
#pragma unroll
  for (int q = 0; q < S::SPT; ++q) {
    const int e = tid + q * NT;
    const int j = y0 - 1 + e / IZ, k = z0 - 1 + e % IZ;
    soff[q][0] = (b1 * s1 + j) * W0 + b2 * s2 + k;
    soff[q][1] = (b1 * (s1 + 1) + j) * W0 + b2 * s2 + k;
    soff[q][2] = (b1 * s1 + j) * W2 + b2 * (s2 + 1) + k;
    if (e < IN) {
      const bool jin = j >= 0 && j < s1, kin = k >= 0 && k < s2;
      sok |= (jin && kin ? 1u : 0u) << (3 * q);
      sok |= (j >= 0 && j <= s1 && kin ? 1u : 0u) << (3 * q + 1);
      sok |= (jin && k >= 0 && k <= s2 ? 1u : 0u) << (3 * q + 2);
    }
  }
  auto copy = [&](T* dst, const T* field, const T* plane, int L, bool in) {
#pragma unroll
    for (int q = 0; q < S::SPT; ++q) {
      const int e = tid + q * NT;
      if (e >= IN) break;
      const bool ok = in && (sok >> (3 * q + L) & 1u);
      march_copy(dst + e, ok ? plane + soff[q][L] : field, ok);
    }
  };
  // Velocity plane xa - 1 + i in slot i % VR; P's and Rho's in i % PR.
  // Planes outside a field are zeros, read by no update that is kept.
  auto stage_v = [&](int i) {
    const int p = xa - 1 + i, slot = i % VR;
    const bool in = p >= 0 && p < s0;
    copy(vring + slot * IN, m.src[1],
         m.src[1] + ((long long)b0 * (s0 + 1) + p) * ps0, 0,
         p >= 0 && p <= s0);
    copy(vring + (VR + slot) * IN, m.src[2],
         m.src[2] + ((long long)b0 * s0 + p) * ps1, 1, in);
    copy(vring + (2 * VR + slot) * IN, m.src[3],
         m.src[3] + ((long long)b0 * s0 + p) * ps2, 2, in);
  };
  auto stage_p = [&](int i) {
    const int p = xa - 1 + i, slot = i % PR;
    const bool in = p >= 0 && p < s0;
    const long long at = ((long long)b0 * s0 + p) * ps0;
    copy(pring + slot * IN, m.src[0], m.src[0] + at, 0, in);
    copy(pring + (PR + slot) * IN, m.rho, m.rho + at, 0, in);
  };

  // The lane's cells: rows j0 .. j0 + C - 1 of column k.
  const int r0 = w * C, j0 = y0 + r0, k = z0 + lane;
  const bool kin = k < s2, kx = k >= 1 && k <= s2 - 2, kz = k >= 1 && k <= s2 - 1;
  const int o0 = (b1 * s1 + j0) * W0 + b2 * s2 + k;
  const int o1 = (b1 * (s1 + 1) + j0) * W0 + b2 * s2 + k;
  const int o2 = (b1 * s1 + j0) * W2 + b2 * (s2 + 1) + k;
  T* oP = m.out[0] + ((long long)b0 * s0 + xa) * ps0 + o0;
  T* oX = m.out[1] + ((long long)b0 * (s0 + 1) + xa) * ps0 + o0;
  T* oY = m.out[2] + ((long long)b0 * s0 + xa) * ps1 + o1;
  T* oZ = m.out[3] + ((long long)b0 * s0 + xa) * ps2 + o2;

  const int steps = xb - xa + 1;
#pragma unroll
  for (int i = 0; i <= AH + 1; ++i) stage_v(i);
#pragma unroll
  for (int i = 0; i <= AH; ++i) stage_p(i);
  march_commit();
  march_wait<0>();
  __syncthreads();

  // Carried from the step before: P' and txx of plane t - 1, txy (rows j0
  // .. j0 + C) and txz of x-face t, and txz of x-face t at k + 1.
  T pnm[C], txxm[C], txyc[C + 1], txzc[C], txzk[C];
  for (int u = 0, t = xa - 1; t < xb; ++u, ++t) {
    const T* vx0 = vring + (u % VR) * IN;
    const T* vx1 = vring + ((u + 1) % VR) * IN;
    const T* vy0 = vring + (VR + u % VR) * IN;
    const T* vy1 = vring + (VR + (u + 1) % VR) * IN;
    const T* vz0 = vring + (2 * VR + u % VR) * IN;
    const T* vz1 = vring + (2 * VR + (u + 1) % VR) * IN;
    const T* pp = pring + (u % PR) * IN;
    const T* rr = pring + (PR + u % PR) * IN;
    T* const wpn = qpn + (u & 1) * QN;
    T* const wzz = qzz + (u & 1) * QN;
    T* const wyz = qyz + (u & 1) * QN;
    T* const wxz = qxz + (u & 1) * QN;

    // The column's quantities of plane t (index c + 1 <-> row j0 + c, from
    // the row above the column) and of x-face t + 1.
    T pn[C + 1], tyy[C + 1], txx[C], tzz[C], txyn[C + 1], txzn[C], tyz[C + 1];
#pragma unroll
    for (int c = -1; c < C; ++c) {
      const int i = (r0 + c + 1) * IZ + lane + 1;
      T a, b;
      ss_cell<IEEE>(m, vx1[i] - vx0[i], vy0[i + IZ] - vy0[i],
                    vz0[i + 1] - vz0[i], pp[i], pn[c + 1], a, tyy[c + 1], b);
      if (c >= 0) {
        txx[c] = a;
        tzz[c] = b;
      }
    }
#pragma unroll
    for (int c = 0; c <= C; ++c) {
      const int i = (r0 + c + 1) * IZ + lane + 1;
      txyn[c] = ss_shear<IEEE>(m, vx1[i] - vx1[i - IZ], m.qy, vy1[i] - vy0[i],
                               m.qx);
      tyz[c] = ss_shear<IEEE>(m, vy0[i] - vy0[i - 1], m.qz,
                              vz0[i] - vz0[i - IZ], m.qy);
      if (c < C)
        txzn[c] = ss_shear<IEEE>(m, vx1[i] - vx1[i - 1], m.qz,
                                 vz1[i] - vz0[i], m.qx);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int q = (r0 + c) * QZ + lane;
      wpn[q + 1] = pn[c + 1];
      wzz[q + 1] = tzz[c];
      wyz[q] = tyz[c];
      wxz[q] = txzn[c];
    }
    // The tile's edge columns: P' and tzz at z0 - 1 (lanes 0 .. C - 1),
    // tyz and txz at z0 + TZ (lanes C .. 2C - 1), a row each.
    if (lane < C) {
      const int r = r0 + lane, i = (r + 1) * IZ;
      T a, b;
      ss_cell<IEEE>(m, vx1[i] - vx0[i], vy0[i + IZ] - vy0[i],
                    vz0[i + 1] - vz0[i], pp[i], wpn[r * QZ], a, b,
                    wzz[r * QZ]);
    } else if (lane < 2 * C) {
      const int r = r0 + lane - C, i = (r + 1) * IZ + TZ + 1;
      wyz[r * QZ + TZ] = ss_shear<IEEE>(m, vy0[i] - vy0[i - 1], m.qz,
                                        vz0[i] - vz0[i - IZ], m.qy);
      wxz[r * QZ + TZ] = ss_shear<IEEE>(m, vx1[i] - vx1[i - 1], m.qz,
                                        vz1[i] - vz0[i], m.qx);
    }
    march_wait<AH - 1>();
    __syncthreads();
    if (u + 2 + AH <= steps) stage_v(u + 2 + AH);
    if (u + 1 + AH < steps) stage_p(u + 1 + AH);
    march_commit();

    if (t >= xa) {
      // The residuals of the column's faces of plane t and its writes.
      const bool tx = t >= 1, tyz_in = t >= 1 && t <= s0 - 2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = (r0 + c + 1) * IZ + lane + 1, q = (r0 + c) * QZ + lane;
        const int j = j0 + c;
        const T pc = pn[c + 1];
        T r[12];
        ss_quot4<IEEE>(r, txx[c] - txxm[c], m.qx, txyc[c + 1] - txyc[c],
                       m.qy, txzk[c] - txzc[c], m.qz, pc - pnm[c], m.qx);
        ss_quot4<IEEE>(r + 4, tyy[c + 1] - tyy[c], m.qy, txyn[c] - txyc[c],
                       m.qx, wyz[q + 1] - tyz[c], m.qz, pc - pn[c], m.qy);
        ss_quot4<IEEE>(r + 8, tzz[c] - wzz[q], m.qz, txzn[c] - txzc[c], m.qx,
                       tyz[c + 1] - tyz[c], m.qy, pc - wpn[q], m.qz);
        T vx = vx0[i] + T(0), vy = vy0[i] + T(0), vz = vz0[i] + T(0);
        const bool jx = j >= 1 && j <= s1 - 2;
        if (tx && jx && kx)
          vx = vx0[i] + m.dtV * (((r[0] + r[1]) + r[2]) - r[3]);
        if (tyz_in && j >= 1 && j <= s1 - 1 && kx)
          vy = vy0[i] + m.dtV * (((r[4] + r[5]) + r[6]) - r[7]);
        if (tyz_in && jx && kz) {
          const T rz = (((r[8] + r[9]) + r[10]) - r[11]) +
                       T(0.5) * (rr[i] + rr[i - 1]);
          vz = vz0[i] + m.dtV * rz;
        }
        if (kin && j < s1) {
          oP[c * W0] = pc;
          oX[c * W0] = vx;
          oY[c * W0] = vy;
          oZ[c * W2] = vz;
          // The outer face rows beyond the cells: Vy's y = s1, Vz's z =
          // s2 and, after the last plane, Vx's x = s0.
          if (j == s1 - 1) oY[(c + 1) * W0] = vy0[i + IZ] + T(0);
          if (k == s2 - 1) oZ[c * W2 + 1] = vz0[i + 1] + T(0);
          if (t == s0 - 1) oX[c * W0 + ps0] = vx1[i] + T(0);
        }
      }
      oP += ps0;
      oX += ps0;
      oY += ps1;
      oZ += ps2;
    }
    // What the next step reads of this one.
#pragma unroll
    for (int c = 0; c < C; ++c) {
      txzk[c] = wxz[(r0 + c) * QZ + lane + 1];
      pnm[c] = pn[c + 1];
      txxm[c] = txx[c];
      txzc[c] = txzn[c];
    }
#pragma unroll
    for (int c = 0; c <= C; ++c) txyc[c] = txyn[c];
  }
}

// Launch one iteration: thread blocks of SsShape<T>::NT threads over (z
// tiles, y tiles, x segments) of every block; x is cut into segments of at
// least SS_MIN_SEG rows where the tiles give fewer than SS_BLOCKS thread
// blocks.
template <typename T>
int launch_stokes_step(SsArgs<T> m, cudaStream_t stream) {
  using S = SsShape<T>;
  for (int d = 0; d < 3; ++d)
    if (m.n[d] < 1 || m.s[d] < 3) return (int)cudaErrorInvalidValue;
  m.ty = (m.s[1] + S::TY - 1) / S::TY;
  m.tz = (m.s[2] + S::TZ - 1) / S::TZ;
  const int rows = m.s[0];
  const long long tiles =
      (long long)m.ty * m.tz * m.n[0] * m.n[1] * m.n[2];
  long long nseg = (SS_BLOCKS + tiles - 1) / tiles;
  const long long most = rows / SS_MIN_SEG > 1 ? rows / SS_MIN_SEG : 1;
  if (nseg > most) nseg = most;
  m.seg = (int)((rows + nseg - 1) / nseg);
  m.nseg = (rows + m.seg - 1) / m.seg;
  const long long gx = (long long)m.tz * m.n[2];
  const long long gy = (long long)m.ty * m.n[1];
  const long long gz = (long long)m.nseg * m.n[0];
  if (gx > 0x7fffffffLL || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // In-plane offsets are 32-bit.
  if ((long long)m.n[1] * (m.s[1] + 1) * m.n[2] * (m.s[2] + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(T) * (size_t)S::ELEMS;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stokes_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  const int nt = S::NT;
  stokes_step_kernel<T><<<grid, nt, bytes, stream>>>(m);
  return (int)cudaGetLastError();
}

template <typename T>
int run_stokes_step(void* const* src, const void* rho, void* const* out,
                    const int* cfg, const double* coef,
                    cudaStream_t stream) {
  SsArgs<T> m;
  for (int f = 0; f < 4; ++f) {
    m.src[f] = static_cast<const T*>(src[f]);
    m.out[f] = static_cast<T*>(out[f]);
  }
  m.rho = static_cast<const T*>(rho);
  m.qx = make_div((T)coef[0]);
  m.qy = make_div((T)coef[1]);
  m.qz = make_div((T)coef[2]);
  m.q3 = make_div(T(3));
  m.mu = (T)coef[3];
  m.c2mu = (T)coef[4];
  m.dtP = (T)coef[5];
  m.dtV = (T)coef[6];
  for (int d = 0; d < 3; ++d) {
    m.n[d] = cfg[d];
    m.s[d] = cfg[3 + d];
  }
  return launch_stokes_step(m, stream);
}

}  // namespace igg

// src, out: (P, Vx, Vy, Vz) pointers of the sources and of the targets (laid
// out like the sources, none aliasing another); rho: Rho, laid out like P;
// cfg: n0 n1 n2 s0 s1 s2 (blocks and P's block extents); coef: dx dy dz mu
// 2*mu dtP dtV; dtype: 0 float32, 1 float64.
extern "C" int igg_stokes_step(void* const* src, const void* rho,
                               void* const* out, int dtype, const int* cfg,
                               const double* coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return igg::run_stokes_step<float>(src, rho, out, cfg, coef, st);
  if (dtype == 1)
    return igg::run_stokes_step<double>(src, rho, out, cfg, coef, st);
  return (int)cudaErrorInvalidValue;
}
