// The x-march of the diffusion band kernel (diffusion_band.cu): each thread
// block walks x over a (y, z) tile of one extended block, T's planes
// staged in shared memory ahead of the update.
//
// Fields and semantics: the temperature T and the constant coefficient A
// (diffusion.cuh), T advanced by one 7-point step T + A lap(T) with the
// rules of the banded realization (BandEdges, march_layout.cuh; layout
// chunk_engine.band_cfg; plain version chunk_engine.banded_window_plain
// with diffusion_trapezoid.banded_update): every x row of an extended
// block updated, its x neighbours clamped to the block's first and last
// rows; rows on a block's y/z outer planes keep their source values; a
// wrapped y or z takes the updated values at the inner cells its edge cells
// alias; on open dims T takes the chunk-entry values F on exactly the
// freeze rows lo and hi, in band_halo's order; the last launch writes only
// each block's central window into the unextended output.  The arithmetic
// is diffusion.cuh's `stencil`, in its association, each operation rounded
// as the plain version rounds it (-fmad=false).
//
// The march.  A thread block owns the tile of source rows [y0, y0 + TY) x
// [z0, z0 + TZ) of one block (16 x 16 cells, one a thread; DM_CPT cells of
// a column where a tile holds more) and walks x over a segment [xa, xb).
// Before the update of plane t each thread waits for its own asynchronous
// copies of plane t + 1 and meets the block at its one barrier a plane;
// it then starts the copies (cp.async) of plane t + 2 + AHEAD into the
// slot of plane t - 2, which the block read last before that barrier, and
// updates its cells of plane t from the staged planes t - 1, t and t + 1
// (the tile and one row and column around it).  T's ring thus holds
// AHEAD + 4 planes, and the copies of planes t + 2 .. t + 2 + AHEAD are in
// flight while plane t is updated.  A is read once, at the cell: each
// thread copies its own cells' A into a ring of the same depth without a
// halo, and reads only what it copied, so A needs no barrier.
//
// Wraps without a second pass.  Every cell is computed once, at its source
// position, and written to each target that takes it (march_layout.cuh:
// march_target_bits), resolved once for the whole march, a store for each
// of its set bits.  Where neither y nor z wraps, a kernel without that
// path runs: on 8 open blocks of 272^3 f32 that, and carrying the ring's
// slots from plane to plane instead of three divisions by the ring's depth
// a plane, cut the march's time by 10% on an H100 80GB HBM3 at 700 W
// (kernel_variants.py; the wraps' stores alone still cost 18% on one
// periodic 272 x 256 x 256 block: dm_no_wrap_writes).
//
// Segments.  Where the tiles of a launch give fewer than DM_BLOCKS thread
// blocks, x is cut into segments of at least DM_MIN_SEG rows, one a thread
// block, each staging one plane beyond both of its ends.  The segments are
// the kernel's own choice: the banded function depends neither on them
// nor on the band depth B.
//
// Shared memory a thread block holds: AHEAD + 4 planes of (TY + 2)(TZ + 2)
// = 324 elements of T and of TY TZ = 256 of A: 2,900 elements, 11,600
// bytes in float32 and 23,200 in float64, whatever B.
#pragma once

#include "diffusion.cuh"
#include "march_layout.cuh"

namespace igg {

constexpr int DM_TY = 16;         // y rows of a tile
constexpr int DM_TZ = 16;         // z cells of a tile row
constexpr int DM_NT = 256;        // threads of a thread block
constexpr int DM_CPT = DM_TY * DM_TZ / DM_NT;  // own cells a thread
constexpr int DM_BLOCKS = 8192;   // thread blocks below which x is cut
constexpr int DM_MIN_SEG = 8;     // fewest x rows of a segment
constexpr int DM_AHEAD = 1;       // planes in flight beyond the next one
// Thread blocks an SM holds at least (the register bound).
constexpr int DM_MIN_BLOCKS_F32 = 6;
constexpr int DM_MIN_BLOCKS_F64 = 3;
// The rings: planes t - 1 .. t + 2 + AHEAD (the march's note).
constexpr int DM_RING = DM_AHEAD + 4;

constexpr int DM_IY = DM_TY + 2, DM_IZ = DM_TZ + 2;
constexpr int DM_IN = DM_IY * DM_IZ;  // a staged plane of T
constexpr int DM_AN = DM_TY * DM_TZ;  // a staged plane of A
constexpr int DM_SPT = (DM_IN + DM_NT - 1) / DM_NT;  // T elements a thread
constexpr int DM_ELEMS = DM_RING * (DM_IN + DM_AN);
static_assert(DM_CPT >= 1 && DM_CPT * DM_NT == DM_TY * DM_TZ &&
                  DM_NT % DM_TZ == 0,
              "a thread takes whole cells of one column");

template <typename T>
struct DmArgs {
  const T* src;  // T
  const T* A;    // the coefficient, laid out like T
  const T* F;    // the chunk-entry buffer (read where a dim freezes)
  T* out;        // the target
  Coef<T> k;
  Chunk c;       // extended blocks, wraps, freeze rows, central window
  int ol[3];     // wrap overlap along y and z
  int first[3];  // first source row with a target, per dim
  int rows[3];   // source rows with a target
  int ty, tz;    // tiles of a block along y and z
  int nseg, seg; // x segments of a block, rows of a segment
};

// WRAPS: y or z wraps (else every cell's one target is its own position).
template <typename T, bool WRAPS>
__global__ void __launch_bounds__(DM_NT, sizeof(T) == 4 ? DM_MIN_BLOCKS_F32
                                                        : DM_MIN_BLOCKS_F64)
    dm_march_kernel(DmArgs<T> m) {
  extern __shared__ __align__(16) unsigned char dm_smem[];
  using E = BandEdges;
  constexpr int TY = DM_TY, TZ = DM_TZ, NT = DM_NT, IZ = DM_IZ, IN = DM_IN;
  constexpr int AN = DM_AN, R = DM_RING, AH = DM_AHEAD;
  constexpr int CPT = DM_CPT, NR = NT / TZ;
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

  T* const tring = reinterpret_cast<T*>(dm_smem);  // T [R][IN]
  T* const aring = tring + R * IN;                  // A [R][AN]

  // What the thread stages of T: its elements of a plane, their in-plane
  // offsets (an x-plane of the stacked field holds fewer than 2^31
  // elements: march_grid) and whether they lie inside the block.
  int soff[DM_SPT];
  unsigned sok = 0;
#pragma unroll
  for (int q = 0; q < DM_SPT; ++q) {
    const int e = tid + q * NT;
    const int j = y0 - 1 + e / IZ, k = z0 - 1 + e % IZ;
    soff[q] = (b[1] * s1 + j) * g.G[2] + b[2] * s2 + k;
    if (e < IN && j >= 0 && j < s1 && k >= 0 && k < s2) sok |= 1u << q;
  }

  // The thread's own cells (rows oa + n NR of column oc).
  const int oc = tid % TZ;
  const int k = z0 + oc;
  const bool wy = g.mode[1] == WRAP, wz = g.mode[2] == WRAP;
  const int tz =
      march_target_bits(k, wz, m.first[2], m.rows[2], s2, m.ol[2]) << 3 |
      (int)E::frozen(c, 2, b[2], k) << 7;
  const int OG[3] = {g.n[0] * m.rows[0], g.n[1] * m.rows[1],
                     g.n[2] * m.rows[2]};
  const long long opsize = (long long)OG[1] * OG[2];
  // tb: the cell's targets (bits 0-2: y rows j, 0 and s1 - 1; bits 3-5:
  // z rows k, 0 and s2 - 1; march_target_bits) and whether its own y and
  // z rows freeze (bits 6, 7; a wrapped dim never does), resolved once.
  int io[CPT], ia[CPT], ins[CPT], ino[CPT], j[CPT], tb[CPT];
  bool inb[CPT], mine[CPT], inner[CPT];
#pragma unroll
  for (int n = 0; n < CPT; ++n) {
    const int oa = tid / TZ + n * NR;
    j[n] = y0 + oa;
    io[n] = (oa + 1) * IZ + oc + 1;
    ia[n] = oa * TZ + oc;
    inb[n] = j[n] < s1 && k < s2;
    mine[n] = j[n] < m.first[1] + m.rows[1] && k < m.first[2] + m.rows[2];
    inner[n] = j[n] >= 1 && j[n] <= s1 - 2 && k >= 1 && k <= s2 - 2;
    tb[n] = tz |
            march_target_bits(j[n], wy, m.first[1], m.rows[1], s1, m.ol[1]) |
            (int)E::frozen(c, 1, b[1], j[n]) << 6;
    ins[n] = (b[1] * s1 + j[n]) * g.G[2] + b[2] * s2 + k;
    ino[n] = (b[1] * m.rows[1] + j[n] - m.first[1]) * OG[2] +
             b[2] * m.rows[2] + k - m.first[2];
  }

  // Plane xa - 1 + i (clamped to the block) lives in slot i % R.
  const long long psize = (long long)g.G[1] * g.G[2];
  auto stage = [&](int i, int slot) {
    const int p = E::plane(xa - 1 + i, s0);
    const long long base = ((long long)b[0] * s0 + p) * psize;
    T* const dst = tring + slot * IN;
#pragma unroll
    for (int q = 0; q < DM_SPT; ++q) {
      const int e = tid + q * NT;
      if (e >= IN) break;
      const bool in = sok >> q & 1u;
      march_copy(dst + e, in ? m.src + base + soff[q] : m.src, in);
    }
#pragma unroll
    for (int n = 0; n < CPT; ++n)
      march_copy(aring + slot * AN + ia[n],
                 inb[n] ? m.A + base + ins[n] : m.A, inb[n]);
  };

  // Plane t = xa + v needs slots v, v + 1 and v + 2.  Before its update
  // the thread waits for its copies of plane t + 1 (slot v + 2), meets the
  // others at the barrier and stages slot v + 3 + AH into the slot of
  // plane t - 2 (read last before this barrier).
  const int len = xb - xa;
#pragma unroll
  for (int i = 0; i <= AH + 2; ++i) {
    stage(i, i);
    march_commit();
  }
  // The slots of plane t - 1 and of the plane staged next, kept as the
  // march goes (the ring's slots of t and t + 1 follow the first).
  int sm = 0, sn = (AH + 3) % R;
  for (int v = 0; v < len; ++v) {
    march_wait<AH>();
    __syncthreads();
    if (v + 3 + AH <= len + 1) stage(v + 3 + AH, sn);
    march_commit();
    const int sc = sm + 1 < R ? sm + 1 : 0, sp = sc + 1 < R ? sc + 1 : 0;
    const int t = xa + v;
    const T* const xm = tring + sm * IN;
    const T* const ctr = tring + sc * IN;
    const T* const xp = tring + sp * IN;
    const T* const aa = aring + sc * AN;
    sm = sc;
    sn = sn + 1 < R ? sn + 1 : 0;
    const bool fx0 = E::frozen(c, 0, b[0], t);
    // Plane t of the target and of F (in-plane offsets are 32-bit).
    T* const op = m.out + (long long)(b[0] * m.rows[0] + t - m.first[0]) *
                              opsize;
    const T* const fp = m.F + ((long long)b[0] * s0 + t) * psize;
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      if (!mine[n]) continue;
      const int i = io[n];
      T tn = ctr[i];
      if (inner[n])
        tn = stencil(ctr[i], xm[i], xp[i], ctr[i - IZ], ctr[i + IZ],
                     ctr[i - 1], ctr[i + 1],
                     aa[ia[n]], m.k);
      const bool fr = fx0 || (tb[n] >> 6 & 3);
      if (!WRAPS || (tb[n] & 63) == 9) {  // the cell's own position only
        op[ino[n]] = fr ? ld(fp + ins[n]) : tn;
        continue;
      }
      for (int ym = tb[n] & 7; ym; ym &= ym - 1) {  // its y targets
        const int ay = __ffs(ym) - 1;
        const int ya = ay == 0 ? j[n] : ay == 1 ? 0 : s1 - 1;
        // band_halo's order: F at the source's z unless z froze.
        const T f = fr ? ld(fp + (b[1] * s1 + (tb[n] >> 7 & 1 ? ya : j[n])) *
                                     g.G[2] +
                            b[2] * s2 + k)
                       : tn;
        const int oy = (b[1] * m.rows[1] + ya - m.first[1]) * OG[2] +
                       b[2] * m.rows[2] - m.first[2];
        for (int zm = tb[n] >> 3 & 7; zm; zm &= zm - 1) {  // its z targets
          const int az = __ffs(zm) - 1;
          op[oy + (az == 0 ? k : az == 1 ? 0 : s2 - 1)] = f;
        }
      }
    }
  }
}

template <typename T>
size_t dm_march_smem_bytes() {
  return sizeof(T) * (size_t)DM_ELEMS;
}

template <typename T, bool WRAPS>
int launch_dm_wraps(const DmArgs<T>& m, dim3 grid, cudaStream_t stream) {
  const size_t bytes = dm_march_smem_bytes<T>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dm_march_kernel<T, WRAPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dm_march_kernel<T, WRAPS><<<grid, DM_NT, bytes, stream>>>(m);
  return (int)cudaGetLastError();
}

// Launch one banded iteration: thread blocks of DM_NT threads over (z
// tiles, y tiles, x segments) of every block, the kernel without the
// wraps' targets where neither y nor z wraps.
template <typename T>
int launch_dm_march(DmArgs<T> m, cudaStream_t stream) {
  dim3 grid;
  const int err = march_grid(m, DM_TY, DM_TZ, DM_BLOCKS, DM_MIN_SEG, grid);
  if (err) return err;
  if (m.c.geo.mode[1] == WRAP || m.c.geo.mode[2] == WRAP)
    return launch_dm_wraps<T, true>(m, grid, stream);
  return launch_dm_wraps<T, false>(m, grid, stream);
}

}  // namespace igg
