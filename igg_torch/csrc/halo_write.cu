// In-place halo writer: one launch writes the two halo planes of every
// participating dimension of a block-stacked grid array, in dimension order
// (later dims own the shared corner and edge cells).  Per dim the source is
// WRAP (the block's own inner plane s-ol / ol-1, one block along the dim)
// or EXT (dense received planes, stacked over the blocks).
//
// Replaces the TPU writers of igg/ops/halo_write.py (_inplace_call,
// _write_dim0/1/2, _halo_write_raw; entries halo_write, halo_write_slabs,
// write_lane_active).
//
// What bounds it on the H100: launch latency, then bytes.  It moves only
// the planes: at 256^3 f32 six planes of 256^2 cells read and written,
// about 3.1 MB, or about 1 us at 3.35 TB/s.  The z planes (dim 2) are the
// strided ones of a C-ordered (x, y, z) tensor, so 32-byte sectors bound
// them: each (x, y) row of the two z planes touches 2 sectors, read and
// written (a WRAP source of overlap 2 shares its target's sector), 10.5
// MB at 256^3, about 3.1 us.  The TPU's minor-dim read-modify-write of
// whole tiles has no counterpart: the card writes single elements.  Its
// first design (a thread a halo cell, one grid for all six planes, the
// planes' cells found by divisions of the thread's index and each dim's
// block by a division per cell; kept in kernel_variants.py) ran 7.2 us
// on an H100 80GB HBM3 at 700 W.
//
// What the design does about it:
//   - each kind of plane gets its own range of thread blocks, and only the
//     participating dims' kinds are launched; a thread finds its plane,
//     rows and blocks from its thread block's index by multiplications
//     (FastDiv, a host reciprocal), never by a division, and nothing per
//     cell;
//   - the x and y planes are rows of z, contiguous: a thread copies 16
//     bytes of a row (a whole `uint4` where the target, the source and the
//     row's z block allow, element by element at a block's ragged ends and
//     at the z halo cells a later dim owns); a row's source (a WRAP row of
//     the block, or of an EXT plane) is resolved once for the thread;
//   - the z planes: two neighbouring lanes take an (x, y) row's two
//     targets of every z block, one a side, each its source first, so each
//     sector is fetched once (a WRAP source of overlap 2 shares its
//     target's sector, which the other lane writes); a thread the whole
//     row ran 1.12 times as long on an H100 80GB HBM3 at 700 W
//     (kernel_variants.py: hw_zjoint);
//   - a cell that a later participating dim also writes is left to that
//     dim; each written cell's value is read where the sequential per-dim
//     writes would have taken it (a WRAP dim maps the row to its source
//     row, an EXT dim reads the received plane), ending at a cell that no
//     thread writes.
// Element-size generic (2, 4, 8 bytes): it copies bits.  A field of rank 1
// or 2 (trailing dims of one cell) is taken as the same memory with its
// dims moved to the end, so its rows are its contiguous dim.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { NONE = 0, WRAP = 1, EXT = 2 };

constexpr int TX = 32;  // threads of a thread block along a row (z chunks)
constexpr int TR = 4;   // rows of a thread block
constexpr int ZS = 2;   // z planes: threads an (x, y) row (2: one a side)

struct Cfg {
  int n[3], s[3], G[3], ol[3], mode[3];
};

template <typename E>
struct Src {
  const E* p[6];
};

// n / d and n % d for 0 <= n < 2^31 by a multiplication (Granlund and
// Montgomery's round-up reciprocal with l = ceil(log2 d): m =
// ceil(2^(31+l) / d) < 2^32, n / d = (n m) >> (31 + l)).
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, m) >> s);
  }
  __device__ __forceinline__ int divmod(int n, int& r) const {
    const int q = div(n);
    r = n - q * (int)d;
    return q;
  }
};

FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    f.m = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    f.s = (unsigned)(l - 1);
  }
  return f;
}

template <typename E>
struct Args {
  E* A;
  Src<E> src;
  Cfg c;
  int start[4];     // first thread block of the x, y and z planes; the total
  int mis_free;     // 1: every z block's row starts on 16 bytes
  FastDiv ct;       // chunk tiles of a z block's row (x and y planes)
  FastDiv nz;       // blocks along z
  FastDiv rt[2];    // row tiles of the x planes (over G1) and y planes (G0)
  FastDiv zt;       // z planes: tiles of TX / ZS rows over G1
  FastDiv s[2];     // block extents along x and y
};

// The row of z of cell (g0, g1) as the dims below `upto` leave it: a halo
// row of a participating dim maps to its WRAP source row or to the row of
// its EXT plane, walking the dims down from upto - 1; then the block's own
// row.
template <typename E>
__device__ __forceinline__ const E* resolve_row(const Args<E>& a, int upto,
                                                int g0, int b0, int j0,
                                                int g1, int b1, int j1) {
  const Cfg& c = a.c;
  if (upto > 1 && c.mode[1] != NONE && (j1 == 0 || j1 == c.s[1] - 1)) {
    if (c.mode[1] == EXT)
      return a.src.p[2 + (j1 != 0)] +
             ((long long)g0 * c.n[1] + b1) * c.G[2];
    g1 = j1 == 0 ? c.s[1] - c.ol[1] : c.ol[1] - 1;
  }
  if (c.mode[0] != NONE && (j0 == 0 || j0 == c.s[0] - 1)) {
    if (c.mode[0] == EXT)
      return a.src.p[j0 != 0] + ((long long)b0 * c.G[1] + g1) * c.G[2];
    g0 = j0 == 0 ? c.s[0] - c.ol[0] : c.ol[0] - 1;
  }
  return a.A + ((long long)g0 * c.G[1] + g1) * c.G[2];
}

// Chunk `ch` of a z block's row: the 16 bytes at target elements
// [ch V - mis, ch V - mis + V) of the block's row `t` (mis: the row's
// start past 16 bytes, in elements), each from `s` at the same z; only
// z in [lo, hi) (the z halo cells a later dim owns left out).
template <typename E>
__device__ __forceinline__ void copy_chunk(E* t, const E* s, int ch, int s2,
                                           int lo, int hi, int mis) {
  constexpr int V = 16 / sizeof(E);
  const int z0 = ch * V - mis;
  if (z0 >= hi || z0 + V <= lo) return;
  if (z0 >= lo && z0 + V <= hi &&
      reinterpret_cast<uintptr_t>(s + z0) % 16 == 0) {
    *reinterpret_cast<uint4*>(t + z0) = *reinterpret_cast<const uint4*>(s + z0);
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int z = z0 + e;
    if (z >= lo && z < hi) t[z] = s[z];
  }
}

// The x (D = 0) or y (D = 1) planes: thread blocks of TR rows by TX chunks
// of one z block's row; block index (((plane rt + r) nz + b2) ct + ct_i),
// plane = b_D * 2 + side.
template <typename E, int D>
__device__ __forceinline__ void write_rows(const Args<E>& a, int lb) {
  constexpr int V = 16 / sizeof(E);
  const Cfg& c = a.c;
  int cti, b2, r;
  lb = a.ct.divmod(lb, cti);
  lb = a.nz.divmod(lb, b2);
  const int p = a.rt[D].divmod(lb, r);
  const int g = r * TR + threadIdx.y;  // x planes: g1; y planes: g0
  if (g >= c.G[1 - D]) return;
  const int side = p & 1, bd = p >> 1;
  const E* srow;
  E* trow;
  if (D == 0) {
    int j1;
    a.s[1].divmod(g, j1);
    if (c.mode[1] != NONE && (j1 == 0 || j1 == c.s[1] - 1)) return;
    trow = a.A + ((long long)(bd * c.s[0] + (side ? c.s[0] - 1 : 0)) *
                      c.G[1] + g) * c.G[2];
    srow = c.mode[0] == EXT
               ? a.src.p[side] + ((long long)bd * c.G[1] + g) * c.G[2]
               : a.A + ((long long)(side ? c.ol[0] - 1 : c.s[0] - c.ol[0]) *
                            c.G[1] + g) * c.G[2];
  } else {
    int j0;
    const int b0 = a.s[0].divmod(g, j0);
    const int g1 = bd * c.s[1] + (side ? c.s[1] - 1 : 0);
    trow = a.A + ((long long)g * c.G[1] + g1) * c.G[2];
    if (c.mode[1] == EXT) {
      srow = a.src.p[2 + side] + ((long long)g * c.n[1] + bd) * c.G[2];
    } else {
      const int g1s = side ? c.ol[1] - 1 : c.s[1] - c.ol[1];
      srow = resolve_row(a, 1, g, b0, j0, g1s, 0, g1s);
    }
  }
  const long long z = (long long)b2 * c.s[2];
  E* const t = trow + z;
  const int mis =
      a.mis_free ? 0 : (int)(reinterpret_cast<uintptr_t>(t) / sizeof(E) % V);
  const bool zh = c.mode[2] != NONE;
  copy_chunk(t, srow + z, cti * TX + threadIdx.x, c.s[2], zh ? 1 : 0,
             zh ? c.s[2] - 1 : c.s[2], mis);
}

// The z planes: ZS threads an (x, y) row (ZS = 2: lane pairs, each a
// side), its targets in every z block and their sources, loads first;
// block index (row tile of G0) zt + tile of G1.
template <typename E>
__device__ __forceinline__ void write_z(const Args<E>& a, int lb) {
  const Cfg& c = a.c;
  int t1;
  const int r = a.zt.divmod(lb, t1);
  const int g0 = r * TR + threadIdx.y;
  const int g1 = t1 * (TX / ZS) + threadIdx.x / ZS;
  if (g0 >= c.G[0] || g1 >= c.G[1]) return;
  const int s2 = c.s[2];
  const bool lo_side = ZS == 1 || threadIdx.x % 2 == 0;
  const bool hi_side = ZS == 1 || threadIdx.x % 2 == 1;
  E* const row = a.A + ((long long)g0 * c.G[1] + g1) * c.G[2];
  if (c.mode[2] == EXT) {
    const long long at = ((long long)g0 * c.G[1] + g1) * c.n[2];
    for (int b2 = 0; b2 < c.n[2]; ++b2) {
      if (lo_side) row[(long long)b2 * s2] = a.src.p[4][at + b2];
      if (hi_side) row[(long long)b2 * s2 + s2 - 1] = a.src.p[5][at + b2];
    }
    return;
  }
  int j0, j1;
  const int b0 = a.s[0].divmod(g0, j0), b1 = a.s[1].divmod(g1, j1);
  const E* const src = resolve_row(a, 2, g0, b0, j0, g1, b1, j1);
  E lo = E(), hi = E();
  if (lo_side) lo = src[s2 - c.ol[2]];
  if (hi_side) hi = src[c.ol[2] - 1];
  if (lo_side) row[0] = lo;
  if (hi_side) row[s2 - 1] = hi;
}

template <typename E>
__global__ void __launch_bounds__(TX * TR) halo_write_kernel(Args<E> a) {
  const int b = blockIdx.x;
  if (b < a.start[1])
    write_rows<E, 0>(a, b - a.start[0]);
  else if (b < a.start[2])
    write_rows<E, 1>(a, b - a.start[1]);
  else
    write_z(a, b - a.start[2]);
}

template <typename E>
int launch(void* A, const Cfg& c, void* const* planes, cudaStream_t st) {
  constexpr int V = 16 / sizeof(E);
  Args<E> a;
  a.A = static_cast<E*>(A);
  a.c = c;
  for (int j = 0; j < 6; ++j) a.src.p[j] = static_cast<const E*>(planes[j]);
  for (int d = 0; d < 3; ++d)
    if ((long long)c.G[0] * c.G[1] * c.G[2] / c.G[d] * c.n[d] > INT_MAX)
      return (int)cudaErrorInvalidValue;
  a.mis_free = reinterpret_cast<uintptr_t>(A) % 16 == 0 && c.G[2] % V == 0 &&
               c.s[2] % V == 0;
  const int chunks = a.mis_free ? (c.s[2] + V - 1) / V : (c.s[2] + 2 * V - 2) / V;
  const int ct = (chunks + TX - 1) / TX;
  const long long rows[2] = {(c.G[1] + TR - 1) / TR, (c.G[0] + TR - 1) / TR};
  long long blocks[3] = {0, 0, 0};
  for (int d = 0; d < 2; ++d)
    if (c.mode[d] != NONE)
      blocks[d] = 2LL * c.n[d] * rows[d] * c.n[2] * ct;
  if (c.mode[2] != NONE)
    blocks[2] = (long long)(c.G[0] + TR - 1) / TR *
                ((c.G[1] + TX / ZS - 1) / (TX / ZS));
  const long long total = blocks[0] + blocks[1] + blocks[2];
  if (total == 0) return (int)cudaSuccess;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  a.start[0] = 0;
  for (int d = 0; d < 3; ++d) a.start[d + 1] = a.start[d] + (int)blocks[d];
  a.ct = fast_div((unsigned)ct);
  a.nz = fast_div((unsigned)c.n[2]);
  a.rt[0] = fast_div((unsigned)rows[0]);
  a.rt[1] = fast_div((unsigned)rows[1]);
  a.zt = fast_div((unsigned)((c.G[1] + TX / ZS - 1) / (TX / ZS)));
  a.s[0] = fast_div((unsigned)c.s[0]);
  a.s[1] = fast_div((unsigned)c.s[1]);
  const dim3 block(TX, TR);
  halo_write_kernel<E><<<(unsigned)total, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2 ol0 ol1 ol2 mode0 mode1 mode2 (0 NONE, 1 WRAP,
// 2 EXT); planes: (dim, side) pointers of the EXT dims, null elsewhere.
extern "C" int igg_halo_write(void* A, int elem_size, const int* cfg_in,
                              void* const* planes_in, void* stream) {
  Cfg cfg;
  void* planes[6];
  for (int d = 0; d < 3; ++d) {
    cfg.n[d] = cfg_in[d];
    cfg.s[d] = cfg_in[3 + d];
    cfg.G[d] = cfg_in[d] * cfg_in[3 + d];
    cfg.ol[d] = cfg_in[6 + d];
    cfg.mode[d] = cfg_in[9 + d];
    planes[2 * d] = planes_in[2 * d];
    planes[2 * d + 1] = planes_in[2 * d + 1];
  }
  // A field of rank 1 or 2 (trailing dims of one cell, no halo): the same
  // memory with its dims moved to the end, its EXT planes alike.
  for (int k = 0; k < 2 && cfg.G[2] == 1 && cfg.mode[2] == NONE; ++k) {
    for (int d = 2; d > 0; --d) {
      cfg.n[d] = cfg.n[d - 1];
      cfg.s[d] = cfg.s[d - 1];
      cfg.G[d] = cfg.G[d - 1];
      cfg.ol[d] = cfg.ol[d - 1];
      cfg.mode[d] = cfg.mode[d - 1];
      planes[2 * d] = planes[2 * d - 2];
      planes[2 * d + 1] = planes[2 * d - 1];
    }
    cfg.n[0] = cfg.s[0] = cfg.G[0] = 1;
    cfg.ol[0] = 2;
    cfg.mode[0] = NONE;
    planes[0] = planes[1] = nullptr;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(A, cfg, planes, st);
    case 4: return launch<uint32_t>(A, cfg, planes, st);
    case 8: return launch<uint64_t>(A, cfg, planes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
