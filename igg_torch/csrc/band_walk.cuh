// One iteration of the streaming banded K-step chunk, the walk of the
// diffusion and HM3D band kernels' first designs (both kernels left it for
// x-marches of their own, diffusion_march.cuh and hm3d_march.cuh; the first
// designs are kept as text in kernel_variants.py, to be timed beside them):
// one launch advances every extended block of
// a block-stacked EXTENDED buffer by one iteration of all NF fields of the
// policy P, sweeping each block in x-row bands of depth B (the function of
// igg/ops/chunk_engine.py: _streaming_kernel and of its plain version,
// igg_torch/ops/chunk_engine.py: banded_window_plain).
//
// A thread block takes one band (rows [a, a+B) of one extended block) over a
// BAND_TY x BAND_TZ tile of y/z cells of that block.  It stages, in shared
// memory, rows [a - lo, a + B + extra) of each of the policy's NS arrays
// (the fields, then the constant ones) over the tile plus the stencil radius.
// Rows beyond the block's x ends are clamped duplicates of its first and
// last rows, per block, not per tensor (igg's rolling window of one
// device's buffer); y/z cells beyond the block are clamped too and never
// read.  Each thread then computes its cell of the B rows with the policy's
// own per-cell update, run on the staged window (a policy copy whose array
// pointers point into shared memory), and resolves the band halo in the
// order of chunk_engine.band_halo, dimension by dimension:
//   - x: on an open dim (a "frozen" one-block dim, or the edge blocks of
//     an "oext" dim) the rows == lo and == hi take the chunk-entry values
//     F (exactly those rows, not the shoulders beyond them);
//   - y, then z: a WRAP dim's edge cells take the value of the inner cell
//     they alias (0 <- s-ol, s-1 <- ol-1) as resolved so far, an open dim's
//     rows == lo / == hi take F.
// A wrap alias lies in another tile, which another thread block computes in
// the same launch: its update is recomputed here from the source buffer
// (x neighbours clamped the same way), never read from the destination.
// Cells on a block's y/z outer planes keep their source values (no-write).
//
// The last launch of a chunk writes only each block's central window,
// straight into the unextended outputs, as chunk_walk.cuh's `last` does.
#pragma once

#include "chunk_walk.cuh"

namespace igg {

constexpr int BAND_TY = 8;        // y cells of a thread block's tile
constexpr int BAND_TZ = 32;       // z cells (a warp along contiguous z)
constexpr int BAND_SMEM_MAX = 232448;     // the H100's opt-in limit a block
constexpr int BAND_SMEM_DEFAULT = 49152;  // above it: the attribute

struct Band {
  Chunk c;       // layout, wraps, freeze rows, central window
  int B;         // band depth (rows of a band)
  int lo;        // rows read below a band
  int extra;     // rows read above a band
  int ol[3];     // wrap overlap per dim (y, z)
  int tiles[3];  // bands per block along x, tiles per block along y and z
};

// cfg: the chunk layout of make_chunk (25 ints), then B lo extra ol_y ol_z.
// Returns false where the layout does not suit the walk.
inline bool make_band(const int* cfg, Band& b) {
  if (!make_chunk(cfg, b.c)) return false;
  b.B = cfg[25];
  b.lo = cfg[26];
  b.extra = cfg[27];
  b.ol[0] = 0;
  b.ol[1] = cfg[28];
  b.ol[2] = cfg[29];
  const Geo& g = b.c.geo;
  if (b.B < 1 || g.s[0] % b.B != 0 || b.lo < 1 || b.extra < 1) return false;
  b.tiles[0] = g.s[0] / b.B;
  b.tiles[1] = (g.s[1] + BAND_TY - 1) / BAND_TY;
  b.tiles[2] = (g.s[2] + BAND_TZ - 1) / BAND_TZ;
  return true;
}

// Bytes of shared memory one thread block stages (igg_torch/ops/_smem.py:
// banded_smem).
template <typename T>
inline long long band_smem_bytes(int ns, const Band& b) {
  return (long long)ns * (b.lo + b.B + b.extra) * (BAND_TY + 2) *
         (BAND_TZ + 2) * (long long)sizeof(T);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Whether local row i of block b along d takes the chunk-entry value.
__device__ __forceinline__ bool band_frozen(int i, int b, int d,
                                            const Chunk& c) {
  return c.frz[d] && ((b == 0 && i == c.lo[d]) ||
                      (b == c.geo.n[d] - 1 && i == c.hi[d]));
}

// Where one extended block of the stacked buffers starts, and its strides.
struct BlockAt {
  long long base;  // offset of the block's (0, 0, 0) cell
  long long sx;    // x stride (G1 * G2)
  int sy;          // y stride (G2)
  __device__ __forceinline__ long long at(int x, int y, int z) const {
    return base + x * sx + (long long)y * sy + z;
  }
};

// The update of the cell (x, y, z), interior in y and z, of every field,
// recomputed from the source buffers alone: its x neighbours clamped to the
// block, the policy run on a 3x3x3 copy of the neighbourhood (strides 9, 3;
// only the seven cells of the stencil are read).
template <class P>
__device__ Cells<typename P::T, P::NF, 1> band_update_global(
    const P& ph, const BlockAt& blk, int s0, int x, int y, int z) {
  using T = typename P::T;
  const int xm = x > 0 ? x - 1 : 0, xp = x < s0 - 1 ? x + 1 : s0 - 1;
  T nb[P::NS][27];
  P loc = ph;
#pragma unroll
  for (int k = 0; k < P::NS; ++k) {
    const T* p = ph.staged(k);
    nb[k][13] = ld(p + blk.at(x, y, z));
    nb[k][4] = ld(p + blk.at(xm, y, z));
    nb[k][22] = ld(p + blk.at(xp, y, z));
    nb[k][10] = ld(p + blk.at(x, y - 1, z));
    nb[k][16] = ld(p + blk.at(x, y + 1, z));
    nb[k][12] = ld(p + blk.at(x, y, z - 1));
    nb[k][14] = ld(p + blk.at(x, y, z + 1));
    loc.restage(k, nb[k]);
  }
  Cells<T, P::NF, 1> res;
  loc.template update<1>(12, 1, 9, 3, res);
  return res;
}

template <class P>
__global__ void __launch_bounds__(BAND_TY * BAND_TZ)
    band_kernel(P ph, Band bd, Fields<const typename P::T, P::NF> F,
                Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  constexpr int NF = P::NF, NS = P::NS;
  constexpr int WY = BAND_TY + 2, WZ = BAND_TZ + 2, PLANE = WY * WZ;
  extern __shared__ __align__(16) unsigned char band_smem[];
  T* win = reinterpret_cast<T*>(band_smem);
  const Chunk& c = bd.c;
  const Geo& g = c.geo;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
  const int b0 = blockIdx.z / bd.tiles[0];
  const int a = (blockIdx.z % bd.tiles[0]) * bd.B;
  const int b1 = blockIdx.y / bd.tiles[1];
  const int y0 = (blockIdx.y % bd.tiles[1]) * BAND_TY;
  const int b2 = blockIdx.x / bd.tiles[2];
  const int z0 = (blockIdx.x % bd.tiles[2]) * BAND_TZ;
  const BlockAt blk{((long long)b0 * s0 * g.G[1] + (long long)b1 * s1) *
                            g.G[2] + (long long)b2 * s2,
                    (long long)g.G[1] * g.G[2], g.G[2]};

  // Stage the window of every array: rows [a - lo, a + B + extra), the
  // tile and its radius, clamped to the block.
  const int n = (bd.lo + bd.B + bd.extra) * PLANE;
  for (int e = threadIdx.y * BAND_TZ + threadIdx.x; e < n;
       e += BAND_TY * BAND_TZ) {
    const int j = e / PLANE, r = e - j * PLANE;
    const long long o = blk.at(clampi(a - bd.lo + j, 0, s0 - 1),
                               clampi(y0 - 1 + r / WZ, 0, s1 - 1),
                               clampi(z0 - 1 + r % WZ, 0, s2 - 1));
#pragma unroll
    for (int k = 0; k < NS; ++k) win[k * n + e] = ld(ph.staged(k) + o);
  }
  __syncthreads();

  const int y = y0 + threadIdx.y, z = z0 + threadIdx.x;
  if (y >= s1 || z >= s2) return;
  P sm = ph;
#pragma unroll
  for (int k = 0; k < NS; ++k) sm.restage(k, win + k * n);

  // The band halo's y/z part, the same for every row: z first (it wins),
  // then y at the z-resolved cell.  fz/fy: the cell takes F at
  // (x, y, z) / (x, y, zz).
  int zz = z, yy = y;
  bool fz = false, fy = false;
  if (g.mode[2] == WRAP && (z == 0 || z == s2 - 1))
    zz = z == 0 ? s2 - bd.ol[2] : bd.ol[2] - 1;
  else
    fz = band_frozen(z, b2, 2, c);
  if (!fz) {
    if (g.mode[1] == WRAP && (y == 0 || y == s1 - 1))
      yy = y == 0 ? s1 - bd.ol[1] : bd.ol[1] - 1;
    else
      fy = band_frozen(y, b1, 1, c);
  }
  const bool edge = yy == 0 || yy == s1 - 1 || zz == 0 || zz == s2 - 1;
  const bool own = yy == y && zz == z;

  for (int r = 0; r < bd.B; ++r) {
    const int x = a + r;
    Cells<T, NF, 1> v;
    if (fz || fy || band_frozen(x, b0, 0, c)) {
      const long long q = blk.at(x, fz ? y : yy, fz ? z : zz);
#pragma unroll
      for (int f = 0; f < NF; ++f) v.f[f].v[0] = ld(F.p[f] + q);
    } else if (edge) {  // a block's y/z outer plane: no-write
      const long long q = blk.at(x, yy, zz);
#pragma unroll
      for (int f = 0; f < NF; ++f) v.f[f].v[0] = ld(ph.src[f] + q);
    } else if (own) {
      sm.template update<1>(
          ((long long)(r + bd.lo) * WY + threadIdx.y + 1) * WZ, threadIdx.x + 1,
          PLANE, WZ, v);
    } else {
      v = band_update_global(ph, blk, s0, x, yy, zz);
    }
    long long o;
    if (!c.last) {
      o = blk.at(x, y, z);
    } else {
      const int t0 = x - c.off[0], t1 = y - c.off[1], t2 = z - c.off[2];
      if (t0 < 0 || t0 >= c.os[0] || t1 < 0 || t1 >= c.os[1] || t2 < 0 ||
          t2 >= c.os[2])
        continue;
      o = (((long long)b0 * c.os[0] + t0) * c.OG[1] + (long long)b1 * c.os[1] +
           t1) * c.OG[2] + (long long)b2 * c.os[2] + t2;
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) out.p[f][o] = v.f[f].v[0];
  }
}

// Launch one iteration: thread blocks of BAND_TZ x BAND_TY threads, one per
// band and tile; dynamic shared memory above 48 KB is opted into first.
template <class P>
int launch_band(const P& ph, const Band& bd,
                const Fields<const typename P::T, P::NF>& F,
                const Fields<typename P::T, P::NF>& out, cudaStream_t stream) {
  const long long smem = band_smem_bytes<typename P::T>(P::NS, bd);
  if (smem > BAND_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Geo& g = bd.c.geo;
  const dim3 block(BAND_TZ, BAND_TY);
  const dim3 grid(g.n[2] * bd.tiles[2], g.n[1] * bd.tiles[1],
                  g.n[0] * bd.tiles[0]);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (smem > BAND_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t bytes = (size_t)smem;
  band_kernel<P><<<grid, block, bytes, stream>>>(ph, bd, F, out);
  return (int)cudaGetLastError();
}

}  // namespace igg
