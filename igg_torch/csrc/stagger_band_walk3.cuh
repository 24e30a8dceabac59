// One iteration of the streaming banded K-step chunk over STAGGERED 3-D
// fields, the walk of the band entry generated for a rank-3
// igg_torch.stencil spec (relax3d and the others; the Stokes band kernel
// left it for the Stokes march's band mode, stokes_march.cuh, and its
// first design here is kept as text in kernel_variants.py): one launch
// advances every extended block of block-stacked EXTENDED buffers by one
// iteration of every field of a policy P of the 3-D staggered walk
// (stagger_walk3.cuh), sweeping each block in x-row bands of depth B (the
// function of igg/ops/chunk_engine.py: _streaming_kernel and of its plain
// version, igg_torch/ops/chunk_engine.py: banded_window_plain).
// band_walk.cuh's design carried to fields of their own shapes.
//
// The policy adds to the staggered walk's interface:
//   - `NS`, `staged(k)`, `restage(k, p)`: the arrays the walk stages (the
//     NF fields, then constant arrays laid out like field 0, which the
//     policy reads at field 0's offsets) and a way to point them elsewhere;
//   - `RADIUS`: the largest index offset, along any dim, of any value its
//     `cells` reads (1 for Stokes).
//
// A thread block takes one band (rows [a, a+B) of the base x extent of one
// extended block) over a BAND_TY x BAND_TZ tile of y/z cells.  It stages, in
// shared memory, rows [a - lo, a + B + extra[k]) of each staged array k over
// the tile plus RADIUS plus the array's own stagger, clamped to the BLOCK's
// first and last rows of that array (igg's rolling window of one device's
// buffer: a field one row longer in x is clamped at its own last row) and,
// in y and z, to the array's extents (values never read).  Each thread then
// computes its cell of every field in the B rows with the policy's own
// `cells<1>`, run on the staged windows: the policy sees the band's window
// as its block along x (row lo + r of a window of lo + B + lo base rows, the
// realization's band core applied to the window) and the block itself along
// y and z, so its interior tests are those of the plain band core.
//
// The band halo is resolved per field in the order of chunk_engine.band_halo
// (later dims win): z first, then y at the z-resolved cell, then x:
//   - a WRAP dim's edge cells of field f (0 and its own size - 1) take the
//     value of the inner cell they alias (size - ol, ol - 1, f's own
//     overlap) as resolved so far;
//   - an open dim's rows == lo and == hi + st(f, d) on the edge blocks take
//     the chunk-entry values F of the fields that freeze on that dim
//     (exactly those rows, not the shoulders beyond them).
// A wrap alias lies in another tile, computed by another thread block in the
// same launch: its update is recomputed here from the source buffers, on a
// (2 RADIUS + 1)^3 copy of its neighbourhood clamped the same way, never
// read from the destination.  Cells outside the base block (a staggered
// field's outer face rows along y and z) take no update: their source value
// plus an exact +0, as the 3-D walk writes them.  The rows beyond the base
// x extent (an x-staggered field's last row, which no band covers) keep
// their source values, so every launch writes every cell of its targets.
// A thread whose cell is a block's last y (z) row also takes the face row
// at y = s1 (z = s2) of the fields staggered along y (z).
//
// The last launch of a chunk writes only each block's central window,
// straight into the unextended outputs (the walk's target window).
#pragma once

#include "band_walk.cuh"
#include "stagger_walk3.cuh"

namespace igg {

struct StagBand {
  Stag3 g;           // make_stag3's layout: extended base block, targets
  int B;             // band depth (rows of a band)
  int lo;            // rows read below a band
  int extra[MAXF];   // rows each staged array reads above a band
  int tiles[3];      // bands per block along x, tiles per block along y, z
};

// Stagger of staged array k along d: a field's own, or field 0's for a
// constant array.
template <class P>
__host__ __device__ constexpr int sst(int k, int d) {
  return k < P::NF ? P::st(k, d) : P::st(0, d);
}

// cfg: the layout of make_stag3 (24 + 3 * MAXF ints), then B, lo and
// extra[MAXF].  Returns false where the layout does not suit the walk: the
// band depth does not divide the base x extent, or a read margin is below
// the window the policy's x tests assume (extra >= lo + stagger).
template <class P>
inline bool make_stag_band(const int* cfg, StagBand& b) {
  if (!make_stag3(cfg, b.g)) return false;
  constexpr int at = 24 + 3 * MAXF;
  b.B = cfg[at];
  b.lo = cfg[at + 1];
  for (int k = 0; k < MAXF; ++k) b.extra[k] = cfg[at + 2 + k];
  const Stag3& g = b.g;
  if (b.B < 1 || g.s[0] % b.B != 0 || b.lo < P::RADIUS) return false;
  for (int k = 0; k < P::NS; ++k)
    if (b.extra[k] < b.lo + sst<P>(k, 0)) return false;
  b.tiles[0] = g.s[0] / b.B;
  b.tiles[1] = (g.s[1] + BAND_TY - 1) / BAND_TY;
  b.tiles[2] = (g.s[2] + BAND_TZ - 1) / BAND_TZ;
  return true;
}

// The y and z extents of staged array k's window.
template <class P>
__host__ __device__ constexpr int band_wy(int k) {
  return BAND_TY + 2 * P::RADIUS + sst<P>(k, 1);
}
template <class P>
__host__ __device__ constexpr int band_wz(int k) {
  return BAND_TZ + 2 * P::RADIUS + sst<P>(k, 2);
}

// Bytes of shared memory one thread block stages (igg_torch/ops/_smem.py:
// banded_smem).
template <class P>
inline long long stag_band_smem_bytes(const StagBand& b) {
  long long n = 0;
  for (int k = 0; k < P::NS; ++k)
    n += (long long)(b.lo + b.B + b.extra[k]) * band_wy<P>(k) * band_wz<P>(k);
  return n * (long long)sizeof(typename P::T);
}

// Whether row c of block bl along d is field f's exact freeze row there.
template <class P>
__device__ __forceinline__ bool band_row_frozen(const Stag3& g, int f, int d,
                                                int bl, int c) {
  return P::freezes(f, d) && g.frz[d] &&
         ((bl == 0 && c == g.lo[d]) ||
          (bl == g.n[d] - 1 && c == g.hi[d] + P::st(f, d)));
}

// Stacked offset of cell (x, y, z) of block b in staged array k's source.
template <class P>
__device__ __forceinline__ long long band_src_at(const Stag3& g, int k,
                                                 const int* b, int x, int y,
                                                 int z) {
  return at3(g.s, g.n, sst<P>(k, 0), sst<P>(k, 1), sst<P>(k, 2), b[0], x,
             b[1], y, b[2], z);
}

// The update of every field at cell (x, y, z), interior to the base block,
// of block b, recomputed from the source buffers alone: the policy run on
// a (2 RADIUS + 1)^3 copy of each staged array's neighbourhood, rows
// clamped to the block's, at window row i of the window layout gw.
template <class P>
__device__ __noinline__ void band_recompute(const P& ph, const Stag3& gw,
                                            const Stag3& g, const int* b,
                                            int x, int i, int y, int z,
                                            typename P::T* res) {
  using T = typename P::T;
  constexpr int NF = P::NF, NS = P::NS, R = P::RADIUS, W = 2 * R + 1;
  T nb[NS][W * W * W];
  P loc = ph;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const T* p = ph.staged(k);
    const int e0 = g.s[0] + sst<P>(k, 0) - 1, e1 = g.s[1] + sst<P>(k, 1) - 1,
              e2 = g.s[2] + sst<P>(k, 2) - 1;
    for (int u = 0; u < W; ++u)
      for (int v = 0; v < W; ++v)
        for (int w = 0; w < W; ++w)
          nb[k][(u * W + v) * W + w] = ld(
              p + band_src_at<P>(g, k, b, clampi(x - R + u, 0, e0),
                                 clampi(y - R + v, 0, e1),
                                 clampi(z - R + w, 0, e2)));
    loc.restage(k, nb[k]);
  }
  long long at[NF], sx[NF], sy[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    at[f] = (long long)R * (W * W + W + 1);
    sx[f] = W * W;
    sy[f] = W;
  }
  T got[NF][1];
  loc.template cells<1>(gw, i, y, z, at, sx, sy, got);
#pragma unroll
  for (int f = 0; f < NF; ++f) res[f] = got[f][0];
}

// Window and target geometry of one thread: its block, band and tile.
struct BandAt {
  int b[3];    // the extended block
  int a;       // the band's first row
  int y0, z0;  // the tile's first y and z cells
  int y, z;    // the thread's own cell of the base block
};

// Write field f's value v at cell (x, y, z) of block p.b of the targets
// (the whole extended blocks, or each block's central window), if the
// target holds it.
template <class P>
__device__ __forceinline__ void band_store(
    const Stag3& g, const BandAt& p, int f, int x, int y, int z,
    typename P::T v, const Fields<typename P::T, P::NF>& out) {
  const int t0 = x - g.off[0], t1 = y - g.off[1], t2 = z - g.off[2];
  if (t0 < 0 || t0 >= g.o[0] + P::st(f, 0) || t1 < 0 ||
      t1 >= g.o[1] + P::st(f, 1) || t2 < 0 || t2 >= g.o[2] + P::st(f, 2))
    return;
  out.p[f][at3(g.o, g.n, P::st(f, 0), P::st(f, 1), P::st(f, 2), p.b[0], t0,
               p.b[1], t1, p.b[2], t2)] = v;
}

// Every field's cell (x, yv, zv) of band row r (x = a + r), for the fields
// that have it: the band halo resolved per field (header), the updates at
// the thread's own cell taken from the staged windows, the others
// recomputed from the sources, fields of one resolved cell together.
template <class P>
__device__ __forceinline__ void band_cells(
    const P& ph, const P& sm, const Stag3& gw, const StagBand& bd,
    const BandAt& p, int r, int yv, int zv,
    const Fields<const typename P::T, P::NF>& F,
    const Fields<typename P::T, P::NF>& out) {
  using T = typename P::T;
  constexpr int NF = P::NF, R = P::RADIUS;
  const Stag3& g = bd.g;
  const int x = p.a + r, s1 = g.s[1], s2 = g.s[2];
  int ty[NF], tz[NF];
  bool want[NF], done[NF];
  T v[NF];
  bool own = false;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n1 = s1 + P::st(f, 1), n2 = s2 + P::st(f, 2);
    want[f] = yv < n1 && zv < n2;
    done[f] = !want[f];
    int yy = yv, zz = zv;
    bool frozen = false;
    if (g.wrap[2] && (zv == 0 || zv == n2 - 1))
      zz = wrap_alias(zv, n2, g.ol[f][2]);
    else
      frozen = band_row_frozen<P>(g, f, 2, p.b[2], zv);
    if (!frozen) {
      if (g.wrap[1] && (yv == 0 || yv == n1 - 1))
        yy = wrap_alias(yv, n1, g.ol[f][1]);
      else
        frozen = band_row_frozen<P>(g, f, 1, p.b[1], yv);
    }
    if (!frozen) frozen = band_row_frozen<P>(g, f, 0, p.b[0], x);
    ty[f] = yy;
    tz[f] = zz;
    if (done[f]) continue;
    if (frozen) {
      v[f] = ld(F.p[f] + band_src_at<P>(g, f, p.b, x, yy, zz));
      done[f] = true;
    } else if (yy >= s1 || zz >= s2) {  // an outer face: no update
      v[f] = ld(ph.src[f] + band_src_at<P>(g, f, p.b, x, yy, zz)) + T(0);
      done[f] = true;
    } else {
      own = own || (yy == p.y && zz == p.z);
    }
  }
  if (own) {
    long long at[NF], sx[NF], sy[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      sy[f] = band_wz<P>(f);
      sx[f] = (long long)band_wy<P>(f) * sy[f];
      at[f] = (long long)(bd.lo + r) * sx[f] + (p.y - p.y0 + R) * sy[f] +
              (p.z - p.z0 + R);
    }
    T got[NF][1];
    sm.template cells<1>(gw, bd.lo + r, p.y, p.z, at, sx, sy, got);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (!done[f] && ty[f] == p.y && tz[f] == p.z) {
        v[f] = got[f][0];
        done[f] = true;
      }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (done[f]) continue;
    T got[NF];
    band_recompute(ph, gw, g, p.b, x, bd.lo + r, ty[f], tz[f], got);
#pragma unroll
    for (int h = 0; h < NF; ++h)
      if (!done[h] && ty[h] == ty[f] && tz[h] == tz[f]) {
        v[h] = got[h];
        done[h] = true;
      }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    if (want[f]) band_store<P>(g, p, f, x, yv, zv, v[f], out);
}

// The rows beyond the base x extent (an x-staggered field's last row) at
// (yv, zv): their source values.
template <class P>
__device__ __forceinline__ void band_tail(
    const P& ph, const Stag3& g, const BandAt& p, int yv, int zv,
    const Fields<typename P::T, P::NF>& out) {
#pragma unroll
  for (int f = 0; f < P::NF; ++f) {
    if (!P::st(f, 0) || yv >= g.s[1] + P::st(f, 1) ||
        zv >= g.s[2] + P::st(f, 2))
      continue;
    const int x = g.s[0];
    band_store<P>(g, p, f, x, yv, zv,
                  ld(ph.src[f] + band_src_at<P>(g, f, p.b, x, yv, zv)), out);
  }
}

// Two thread blocks an SM in float32, where the windows allow it (Stokes:
// 71 KB each): the register bound that takes (128 a thread, from 156) made
// the Stokes band kernel 1.53 times as fast on an H100
// (kernel_variants.py: band_bounds_1).  A float64 window of Stokes (142
// KB) leaves room for one, so float64 keeps its registers.
template <class P>
__global__ void __launch_bounds__(BAND_TY * BAND_TZ,
                                  8 / sizeof(typename P::T))
    stag_band_kernel(P ph, StagBand bd, Fields<const typename P::T, P::NF> F,
                     Fields<typename P::T, P::NF> out) {
  using T = typename P::T;
  constexpr int NS = P::NS, R = P::RADIUS;
  extern __shared__ __align__(16) unsigned char stag_band_smem[];
  const Stag3& g = bd.g;
  const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
  BandAt p;
  p.b[0] = blockIdx.z / bd.tiles[0];
  p.b[1] = blockIdx.y / bd.tiles[1];
  p.b[2] = blockIdx.x / bd.tiles[2];
  p.a = (blockIdx.z % bd.tiles[0]) * bd.B;
  p.y0 = (blockIdx.y % bd.tiles[1]) * BAND_TY;
  p.z0 = (blockIdx.x % bd.tiles[2]) * BAND_TZ;
  p.y = p.y0 + threadIdx.y;
  p.z = p.z0 + threadIdx.x;

  // Stage each array's window: rows [a - lo, a + B + extra[k]) over the
  // tile, its radius and its stagger, clamped to the block; the threads
  // take consecutive elements, so a warp's loads run along z.
  T* win[NS];
  T* next = reinterpret_cast<T*>(stag_band_smem);
  const int tid = threadIdx.y * BAND_TZ + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int wy = band_wy<P>(k), wz = band_wz<P>(k), plane = wy * wz;
    const int n = (bd.lo + bd.B + bd.extra[k]) * plane;
    const int e0 = s0 + sst<P>(k, 0) - 1, e1 = s1 + sst<P>(k, 1) - 1,
              e2 = s2 + sst<P>(k, 2) - 1;
    const T* src = ph.staged(k);
    win[k] = next;
    next += n;
    for (int e = tid; e < n; e += BAND_TY * BAND_TZ) {
      const int j = e / plane, q = e - j * plane;
      win[k][e] = ld(src + band_src_at<P>(
                               g, k, p.b, clampi(p.a - bd.lo + j, 0, e0),
                               clampi(p.y0 - R + q / wz, 0, e1),
                               clampi(p.z0 - R + q % wz, 0, e2)));
    }
  }
  __syncthreads();

  if (p.y >= s1 || p.z >= s2) return;
  P sm = ph;
#pragma unroll
  for (int k = 0; k < NS; ++k) sm.restage(k, win[k]);
  // The policy's view: the band's window along x, the block along y, z.
  Stag3 gw = g;
  gw.s[0] = 2 * bd.lo + bd.B;
  const bool ylast = p.y == s1 - 1, zlast = p.z == s2 - 1;
  for (int r = 0; r < bd.B; ++r) {
    band_cells(ph, sm, gw, bd, p, r, p.y, p.z, F, out);
    if (ylast) band_cells(ph, sm, gw, bd, p, r, s1, p.z, F, out);
    if (zlast) band_cells(ph, sm, gw, bd, p, r, p.y, s2, F, out);
    if (ylast && zlast) band_cells(ph, sm, gw, bd, p, r, s1, s2, F, out);
  }
  if (p.a + bd.B == s0) {
    band_tail(ph, g, p, p.y, p.z, out);
    if (ylast) band_tail(ph, g, p, s1, p.z, out);
    if (zlast) band_tail(ph, g, p, p.y, s2, out);
    if (ylast && zlast) band_tail(ph, g, p, s1, s2, out);
  }
}

// Launch one iteration: thread blocks of BAND_TZ x BAND_TY threads, one per
// band and tile; dynamic shared memory above 48 KB is opted into first.
template <class P>
int launch_stag_band(const P& ph, const StagBand& bd,
                     const Fields<const typename P::T, P::NF>& F,
                     const Fields<typename P::T, P::NF>& out,
                     cudaStream_t stream) {
  static_assert(P::NF <= MAXF && P::NS <= MAXF, "more arrays than the walk takes");
  const long long smem = stag_band_smem_bytes<P>(bd);
  if (smem > BAND_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Stag3& g = bd.g;
  const dim3 block(BAND_TZ, BAND_TY);
  const dim3 grid(g.n[2] * bd.tiles[2], g.n[1] * bd.tiles[1],
                  g.n[0] * bd.tiles[0]);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (smem > BAND_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        stag_band_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t bytes = (size_t)smem;
  stag_band_kernel<P><<<grid, block, bytes, stream>>>(ph, bd, F, out);
  return (int)cudaGetLastError();
}

}  // namespace igg
