// One-pass plane packer: one launch copies every requested y/z plane of
// every block of a block-stacked field into dense stacked plane tensors,
// the shapes the halo exchange takes (the plane tensor of dim d has the
// field's stacked shape with dim d replaced by the block count n_d; entry c
// along d is block c's plane).
//
// Replaces the TPU kernel of igg/ops/pack.py (pack_planes), which streamed a
// block through VMEM once to avoid one relayout pass per minor-dim plane.
// On the card it is the reference's write_d2x! pack kernel
// (ImplicitGlobalGrid.jl src/update_halo.jl): the planes are copied, not
// relaid out, and one launch serves all of them.
//
// What bounds it on the H100: bytes, and for z planes the sectors behind
// them.  A y plane of a C-ordered (x, y, z) field is G0*n1 contiguous rows
// of G2 cells: read and written at full width.  A z plane is strided by G2:
// the card reads a 32-byte sector for the 2-8 bytes of each cell, but the
// z requests igg makes come in pairs of adjacent rows (0 and 1, s2-2 and
// s2-1), which share a sector.  At the 510^3 headline (8 blocks of 256^3
// f32, the 8 planes update_halo extracts) that is 4 sectors per (x, y) row,
// 33.5 MB, beside 16 MB of y-plane and 8 MB of z-plane bytes: 0.017 ms at
// 3.35 TB/s.
//
// What the design does about it: the thread blocks of one launch are of
// two kinds, told apart by blockIdx.x.
//   - A y block takes one (x row g0, block c1) and copies that row of every
//     y request: G2 contiguous cells in the source and in the output, with
//     16-byte accesses where both sides share their alignment, element
//     accesses at a ragged head or tail (or throughout where they do not).
//   - A z block takes 256 consecutive (x, y) rows: its threads run over the
//     (row, block c2) pairs of those rows, consecutive threads on
//     consecutive pairs, so each request's writes ((g0*G1 + g1)*n2 + c2)
//     are coalesced; a thread reads the cells of every z request of two
//     pairs, sorted by position, back to back before it writes them, so
//     adjacent positions share one sector read (the second load finds it
//     in L1).  The z blocks come first: they take the longest (their
//     scattered sectors), and the y blocks fill the card behind them.
// 64-bit offsets are formed once per row or pair; the per-element work is
// 32-bit (one 32-bit division per (row, c2) pair, none per element).
// Element-size generic (2, 4, 8 bytes): it copies bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kThreads = 256;

struct Req {
  int n[3], s[3], G[3];
  int ny, nz;               // y and z requests
  int zpos[kMaxPlanes];     // local row of each z plane, ascending
  int ypos[kMaxPlanes];     // ... of each y plane
  int out[kMaxPlanes];      // the request of output j (Outs order below)
  long long yblocks;        // G0 * n1 when ny > 0, else 0
  long long zrows;          // G0 * G1 when nz > 0, else 0
};

// The outputs: the z planes in ascending position, then the y planes.
template <typename E>
struct Outs {
  E* p[kMaxPlanes];
};

// a[j] for a runtime j, by constant indices only (a runtime index into a
// kernel parameter puts the parameters in a stack frame).
template <typename A>
__device__ __forceinline__ A pick(const A* a, int j) {
  A x = a[0];
#pragma unroll
  for (int m = 1; m < kMaxPlanes; ++m)
    if (j == m) x = a[m];
  return x;
}

// Slot v of the copy of `len` elements from S to D.  Where S and D share
// their offset within 16 bytes: a 16-byte vector (v < nv), the ragged head
// (v == nv) or the ragged tail (v == nv + 1); elsewhere the V elements
// [vV, vV + V).  A row has ceil(len / V) + 2 slots; some do nothing.
template <typename E>
__device__ __forceinline__ void copy_slot(const E* __restrict__ S,
                                          E* __restrict__ D, int len, int v) {
  constexpr int V = 16 / sizeof(E);
  const unsigned sa = reinterpret_cast<uintptr_t>(S) % 16;
  const unsigned da = reinterpret_cast<uintptr_t>(D) % 16;
  if (sa != da) {  // elements throughout: slot v is elements [vV, vV + V)
    const int e0 = v * V;
#pragma unroll
    for (int m = 0; m < V; ++m)
      if (e0 + m < len) D[e0 + m] = S[e0 + m];
    return;
  }
  int head = (int)(((16 - sa) % 16) / sizeof(E));
  if (head > len) head = len;
  const int nv = (len - head) / V;
  if (v < nv) {
    reinterpret_cast<uint4*>(D + head)[v] =
        reinterpret_cast<const uint4*>(S + head)[v];
  } else if (v == nv) {
    for (int e = 0; e < head; ++e) D[e] = S[e];
  } else if (v == nv + 1) {
    for (int e = head + nv * V; e < len; ++e) D[e] = S[e];
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const E* __restrict__ A, Req r, Outs<E> outs) {
  constexpr int V = 16 / sizeof(E);
  const int G1 = r.G[1], G2 = r.G[2], n1 = r.n[1], n2 = r.n[2];
  const long long zblocks = (r.zrows + kThreads - 1) / kThreads;
  const long long bid = blockIdx.x;
  if (bid >= zblocks) {
    // One (g0, c1) row of every y request.  Slots per row: its vectors
    // plus a head and a tail, or (unaligned) its elements in groups of V.
    const int u = (int)(bid - zblocks);
    const int g0 = u / n1, c1 = u - g0 * n1;
    const int slots = (G2 + V - 1) / V + 2;
    const long long base = (long long)g0 * G1 + (long long)c1 * r.s[1];
    const long long dst = (long long)u * G2;
    for (int w = threadIdx.x; w < r.ny * slots; w += kThreads) {
      const int j = w / slots, v = w - j * slots;
      copy_slot<E>(A + (base + pick(r.ypos, j)) * G2,
                   pick(outs.p, r.nz + j) + dst, G2, v);
    }
    return;
  }
  // 256 consecutive (x, y) rows of every z request: (row, c2) pairs, two
  // a thread at a time, both pairs' loads issued before their stores.
  const long long row0 = bid * kThreads;
  const int rows = (int)(r.zrows - row0 < kThreads ? r.zrows - row0
                                                   : kThreads);
  const int s2 = r.s[2], items = rows * n2;
  for (int w0 = threadIdx.x; w0 < items; w0 += 2 * kThreads) {
    E v[2][kMaxPlanes];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = w0 + h * kThreads;
      if (w >= items) break;
      const int q = w / n2, c2 = w - q * n2;
      const E* src = A + (row0 + q) * G2 + c2 * s2;
#pragma unroll
      for (int j = 0; j < kMaxPlanes; ++j)
        if (j < r.nz) v[h][j] = src[r.zpos[j]];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = w0 + h * kThreads;
      if (w >= items) break;
#pragma unroll
      for (int j = 0; j < kMaxPlanes; ++j)
        if (j < r.nz) outs.p[j][row0 * n2 + w] = v[h][j];
    }
  }
}

template <typename E>
int launch(const void* A, const Req& r, void* const* outs, cudaStream_t st) {
  Outs<E> o{};
  for (int j = 0; j < r.ny + r.nz; ++j)
    o.p[j] = static_cast<E*>(outs[r.out[j]]);
  const long long blocks = r.yblocks + (r.zrows + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL || r.yblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const E* src = static_cast<const E*>(A);
  pack_kernel<E><<<(unsigned)blocks, kThreads, 0, st>>>(src, r, o);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2; reqs: nreq (dim, pos) pairs, dim 1 or 2; outs: one
// dense plane tensor per request, in request order.
extern "C" int igg_pack_planes(const void* A, int elem_size, const int* cfg,
                               int nreq, const int* reqs, void* const* outs,
                               void* stream) {
  if (nreq < 1 || nreq > kMaxPlanes) return (int)cudaErrorInvalidValue;
  Req r{};
  for (int d = 0; d < 3; ++d) {
    r.n[d] = cfg[d];
    r.s[d] = cfg[3 + d];
    r.G[d] = cfg[d] * cfg[3 + d];
  }
  int yreq[kMaxPlanes];
  for (int j = 0; j < nreq; ++j) {
    const int d = reqs[2 * j], p = reqs[2 * j + 1];
    if ((d != 1 && d != 2) || p < 0 || p >= r.s[d])
      return (int)cudaErrorInvalidValue;
    if (d == 1) {
      yreq[r.ny] = j;
      r.ypos[r.ny++] = p;
    } else {  // insert by position: adjacent rows are read back to back
      int k = r.nz++;
      for (; k > 0 && r.zpos[k - 1] > p; --k) {
        r.zpos[k] = r.zpos[k - 1];
        r.out[k] = r.out[k - 1];
      }
      r.zpos[k] = p;
      r.out[k] = j;
    }
  }
  for (int j = 0; j < r.ny; ++j) r.out[r.nz + j] = yreq[j];
  r.yblocks = r.ny ? (long long)r.G[0] * r.n[1] : 0;
  r.zrows = r.nz ? (long long)r.G[0] * r.G[1] : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(A, r, outs, st);
    case 4: return launch<uint32_t>(A, r, outs, st);
    case 8: return launch<uint64_t>(A, r, outs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
