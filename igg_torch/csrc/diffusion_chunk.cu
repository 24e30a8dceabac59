// One step of a K-step diffusion trapezoid chunk: one launch advances every
// block of a block-stacked EXTENDED buffer by one diffusion step (the rules
// of chunk_walk.cuh, with the diffusion policy of diffusion.cuh and no halo
// received).
//
// Replaces the TPU kernel of igg/ops/diffusion_trapezoid.py (_kernel,
// _chunk_call; entry fused_diffusion_trapezoid_steps), which ran all K steps
// in one launch with VMEM ping-pong.  Here the chunk is K launches that
// ping-pong two device buffers (as the K-step loop of a one-block grid does);
// one launch per chunk with a grid-wide sync, or temporal blocking in
// shared memory, is later work.
//
// What bounds it on the H100: bytes.  Per step it reads the extended T and
// A once and writes T once; at 8 blocks of 272^3 f32 (the 510^3 headline's
// 256^3 blocks extended by K = 8) that is 1.93 GB, 0.577 ms at 3.35 TB/s,
// against 0.481 ms for the unextended step.  The TPU kernel read A once per
// chunk from VMEM; here A_ext (643 MB) is read every step.
//
// What the design does about it: the fused step's layout (a thread per 16
// bytes of a z row, every access coalesced, neighbours from L1/L2), with
// the freeze and the window mapping resolved once per row.
#include "chunk_walk.cuh"
#include "diffusion.cuh"

namespace {

template <typename T>
int launch(const void* src, const void* A, const void* F, void* out,
           const igg::Chunk& c, double cx, double cy, double cz, double cc,
           cudaStream_t stream) {
  return igg::launch_chunk(igg::make_diffusion<T>(src, A, cx, cy, cz, cc), c,
                           igg::Fields<const T, 1>{{static_cast<const T*>(F)}},
                           igg::Fields<T, 1>{{static_cast<T*>(out)}}, stream);
}

}  // namespace

// cfg: the chunk layout of igg::make_chunk (chunk_walk.cuh); dtype: 0
// float32, 1 float64.  F is the chunk-entry buffer, laid out like src; out
// is extended like src, or, when `last`, the unextended output.
extern "C" int igg_diffusion_chunk_step(const void* src, const void* A,
                                        const void* F, void* out, int dtype,
                                        const int* cfg, double cx, double cy,
                                        double cz, double cc, void* stream) {
  igg::Chunk c;
  if (!igg::make_chunk(cfg, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(src, A, F, out, c, cx, cy, cz, cc, st);
  if (dtype == 1)
    return launch<double>(src, A, F, out, c, cx, cy, cz, cc, st);
  return (int)cudaErrorInvalidValue;
}
