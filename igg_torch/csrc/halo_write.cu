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
// What bounds it on the H100: launch latency.  It moves only the planes:
// at 256^3 f32 six planes of 256^2 cells read and written, about 3.1 MB, or
// about 1 us at 3.35 TB/s, below the few microseconds a launch costs.  The
// TPU's minor-dim read-modify-write of whole tiles has no counterpart: the
// card writes single elements.  The z planes (dim 2) are the strided ones
// of a C-ordered (x, y, z) tensor: each of their cells is a sector of its
// own.
//
// What the design does about it: one launch for all dims, one thread per
// halo cell and nothing else touched.  blockIdx.y picks the (dim, side) of
// the plane, and each dim has its own compiled path (write_plane<D>), so
// all index arithmetic stays in registers.  Threads run along the
// contiguous axis of each plane (z for the x and y planes; y for the z
// planes, along which the EXT plane is contiguous).  A cell whose later dim
// also writes it is left to that dim's thread.  Each written cell's value
// is resolved by walking the dims down from its own, exactly as the
// sequential per-dim writes would have left it: a WRAP dim maps the index
// to its source plane, an EXT dim returns the received plane's value, and
// the walk ends in the block itself at a cell that is not a halo cell of
// any participating dim, so no thread reads a cell another thread writes.
// Element-size generic (2, 4, 8 bytes): it copies bits.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { NONE = 0, WRAP = 1, EXT = 2 };

struct Cfg {
  int n[3], s[3], G[3], ol[3], mode[3];
};

template <typename E>
struct Src {
  const E* p[6];
};

__device__ __forceinline__ int block_of(int g, int n, int s) {
  return n == 1 ? 0 : g / s;
}

// Writes plane `side` of dim D: its cells (a, b, w) with w the fastest,
// a over the blocks along D, (b, w) over the other two dims.
template <typename E, int D>
__device__ __forceinline__ void write_plane(E* __restrict__ A, const Cfg& cfg,
                                            const Src<E>& src, int side) {
  constexpr int DB = D == 0 ? 1 : 0;
  constexpr int DW = D == 2 ? 1 : 2;
  const int nb = cfg.G[DB], nw = cfg.G[DW];
  const int total = cfg.n[D] * nb * nw;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += gridDim.x * blockDim.x) {
    int g[3];
    g[DW] = t % nw;
    const int r = t / nw;
    g[DB] = r % nb;
    g[D] = (r / nb) * cfg.s[D] + (side ? cfg.s[D] - 1 : 0);
    bool owned = true;
#pragma unroll
    for (int e = D + 1; e < 3; ++e) {
      const int i = g[e] - block_of(g[e], cfg.n[e], cfg.s[e]) * cfg.s[e];
      if (cfg.mode[e] != NONE && (i == 0 || i == cfg.s[e] - 1)) owned = false;
    }
    if (!owned) continue;
    const long long out =
        ((long long)g[0] * cfg.G[1] + g[1]) * cfg.G[2] + g[2];
    E v;
    bool done = false;
#pragma unroll
    for (int e = D; e >= 0; --e) {
      if (done || cfg.mode[e] == NONE) continue;
      const int c = block_of(g[e], cfg.n[e], cfg.s[e]);
      const int i = g[e] - c * cfg.s[e];
      if (i != 0 && i != cfg.s[e] - 1) continue;
      if (cfg.mode[e] == EXT) {
        // The received plane of dim e has extent n[e] along e.
        int p[3] = {g[0], g[1], g[2]};
        p[e] = c;
        const int P1 = e == 1 ? cfg.n[1] : cfg.G[1];
        const int P2 = e == 2 ? cfg.n[2] : cfg.G[2];
        const E* plane = i == 0 ? src.p[2 * e] : src.p[2 * e + 1];
        v = plane[((long long)p[0] * P1 + p[1]) * P2 + p[2]];
        done = true;
      } else {  // WRAP: one block along e, so g[e] is the local index
        g[e] = i == 0 ? cfg.s[e] - cfg.ol[e] : cfg.ol[e] - 1;
      }
    }
    if (!done) v = A[((long long)g[0] * cfg.G[1] + g[1]) * cfg.G[2] + g[2]];
    A[out] = v;
  }
}

template <typename E>
__global__ void __launch_bounds__(256)
    halo_write_kernel(E* A, Cfg cfg, Src<E> src) {
  const int side = blockIdx.y & 1;
  switch (blockIdx.y >> 1) {
    case 0:
      if (cfg.mode[0] != NONE) write_plane<E, 0>(A, cfg, src, side);
      break;
    case 1:
      if (cfg.mode[1] != NONE) write_plane<E, 1>(A, cfg, src, side);
      break;
    default:
      if (cfg.mode[2] != NONE) write_plane<E, 2>(A, cfg, src, side);
  }
}

template <typename E>
int launch(void* A, const Cfg& cfg, void* const* planes, cudaStream_t st) {
  Src<E> src;
  for (int j = 0; j < 6; ++j) src.p[j] = static_cast<const E*>(planes[j]);
  long long most = 0;
  for (int d = 0; d < 3; ++d) {
    if (cfg.mode[d] == NONE) continue;
    const long long cells = (long long)cfg.G[0] * cfg.G[1] * cfg.G[2] /
                            cfg.G[d] * cfg.n[d];
    if (cells > INT_MAX) return (int)cudaErrorInvalidValue;
    if (cells > most) most = cells;
  }
  if (most == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (most + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond that
  const dim3 grid((unsigned)blocks, 6);  // y: (dim, side) of the plane
  halo_write_kernel<E><<<grid, threads, 0, st>>>(static_cast<E*>(A), cfg, src);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2 ol0 ol1 ol2 mode0 mode1 mode2 (0 NONE, 1 WRAP,
// 2 EXT); planes: (dim, side) pointers of the EXT dims, null elsewhere.
extern "C" int igg_halo_write(void* A, int elem_size, const int* cfg_in,
                              void* const* planes, void* stream) {
  Cfg cfg;
  for (int d = 0; d < 3; ++d) {
    cfg.n[d] = cfg_in[d];
    cfg.s[d] = cfg_in[3 + d];
    cfg.G[d] = cfg_in[d] * cfg_in[3 + d];
    cfg.ol[d] = cfg_in[6 + d];
    cfg.mode[d] = cfg_in[9 + d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(A, cfg, planes, st);
    case 4: return launch<uint32_t>(A, cfg, planes, st);
    case 8: return launch<uint64_t>(A, cfg, planes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
