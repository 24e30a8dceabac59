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
// them.  A y plane of a C-ordered (x, y, z) field is n0*s0 contiguous runs
// of G2 cells: read and written at full width.  A z plane is strided by G2:
// each of its cells sits in a 32-byte sector of its own, so the card reads
// 32 bytes for every 2-8 it keeps (8x the compulsory bytes in f32).  At the
// 510^3 headline (8 blocks of 256^3 f32) one y or z plane tensor holds
// 512 * 512 * 2 cells, 2 MB.
//
// What the design does about it: blockIdx.y picks the plane, and threads run
// along each output's contiguous axis, so writes are always coalesced and
// y-plane reads are coalesced along z.  Element-size generic (2, 4, 8
// bytes): it copies bits.  Indices are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;

struct Req {
  int n[3], s[3], G[3];
  int nreq;
  int dim[kMaxPlanes];  // 1 or 2
  int pos[kMaxPlanes];  // local row of the plane along dim
  long long count[kMaxPlanes];
};

template <typename E>
struct Outs {
  E* p[kMaxPlanes];
};

template <typename E>
__global__ void __launch_bounds__(256)
    pack_kernel(const E* __restrict__ A, Req r, Outs<E> outs) {
  const int j = blockIdx.y;
  const long long total = r.count[j];
  E* __restrict__ out = outs.p[j];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long src;
    if (r.dim[j] == 1) {  // out (G0, n1, G2): i = (g0 * n1 + c1) * G2 + g2
      const long long g2 = i % r.G[2];
      const long long t = i / r.G[2];
      const long long c1 = t % r.n[1], g0 = t / r.n[1];
      src = (g0 * r.G[1] + c1 * r.s[1] + r.pos[j]) * r.G[2] + g2;
    } else {  // out (G0, G1, n2): i = (g0 * G1 + g1) * n2 + c2
      const long long c2 = i % r.n[2];
      const long long t = i / r.n[2];
      src = t * r.G[2] + c2 * r.s[2] + r.pos[j];
    }
    out[i] = A[src];
  }
}

template <typename E>
int launch(const void* A, const Req& r, void* const* outs, cudaStream_t st) {
  Outs<E> o{};
  long long most = 0;
  for (int j = 0; j < r.nreq; ++j) {
    o.p[j] = static_cast<E*>(outs[j]);
    if (r.count[j] > most) most = r.count[j];
  }
  if (most == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (most + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride beyond that
  const dim3 grid((unsigned)blocks, r.nreq);
  pack_kernel<E><<<grid, threads, 0, st>>>(static_cast<const E*>(A), r, o);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2; reqs: nreq (dim, pos) pairs, dim 1 or 2; outs: one
// dense plane tensor per request, in request order.
extern "C" int igg_pack_planes(const void* A, int elem_size, const int* cfg,
                               int nreq, const int* reqs, void* const* outs,
                               void* stream) {
  if (nreq < 1 || nreq > kMaxPlanes) return (int)cudaErrorInvalidValue;
  Req r;
  for (int d = 0; d < 3; ++d) {
    r.n[d] = cfg[d];
    r.s[d] = cfg[3 + d];
    r.G[d] = cfg[d] * cfg[3 + d];
  }
  r.nreq = nreq;
  for (int j = 0; j < nreq; ++j) {
    const int d = reqs[2 * j], p = reqs[2 * j + 1];
    if ((d != 1 && d != 2) || p < 0 || p >= r.s[d])
      return (int)cudaErrorInvalidValue;
    r.dim[j] = d;
    r.pos[j] = p;
    r.count[j] = (long long)r.G[0] * (d == 1 ? (long long)r.n[1] * r.G[2]
                                             : (long long)r.G[1] * r.n[2]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(A, r, outs, st);
    case 4: return launch<uint32_t>(A, r, outs, st);
    case 8: return launch<uint64_t>(A, r, outs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
