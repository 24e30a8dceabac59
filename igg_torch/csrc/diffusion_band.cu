// One iteration of the streaming banded K-step diffusion chunk: one launch
// advances every block of a block-stacked EXTENDED buffer by one diffusion
// step, swept in x-row bands of depth B through a shared-memory window (the
// walk of band_walk.cuh, with the diffusion policy of diffusion.cuh: T and
// the constant coefficient A staged, T re-frozen on open dims).
//
// Replaces the diffusion instance of the TPU kernel of
// igg/ops/chunk_engine.py (_streaming_kernel; entry streaming_chunk_call,
// as igg/ops/diffusion_trapezoid.py:fused_diffusion_banded_steps
// configures it), which ran all K iterations in one launch, each band's
// rolling window in VMEM, the iterations ping-ponging through HBM.  Here
// the chunk is K launches that ping-pong two device buffers, the last
// writing the central windows; holding K iterations of a band on chip
// (temporal blocking) is later work.
//
// What bounds it on the H100: bytes.  Per launch it reads the extended T
// and A once and writes T once: at 8 blocks of 272^3 f32 (the 510^3
// headline's 256^3 blocks extended by K = 8) 1.93 GB, 0.58 ms at 3.35
// TB/s.  A whole K = 8 chunk needs to read each extended field once and
// write each central block once (0.55 ms): a design that keeps the
// iterations on chip would approach that.
//
// What the design does about it: a thread block stages its band's rows
// and its tile's radius once (coalesced along z), and every cell reads its
// seven neighbours from shared memory.
#include "band_walk.cuh"
#include "diffusion.cuh"

namespace {

template <typename T>
int launch(const void* src, const void* A, const void* F, void* out,
           const igg::Band& b, double cx, double cy, double cz, double cc,
           cudaStream_t stream) {
  return igg::launch_band(igg::make_diffusion<T>(src, A, cx, cy, cz, cc), b,
                          igg::Fields<const T, 1>{{static_cast<const T*>(F)}},
                          igg::Fields<T, 1>{{static_cast<T*>(out)}}, stream);
}

}  // namespace

// cfg: the band layout of igg::make_band (band_walk.cuh); dtype: 0 float32,
// 1 float64.  F is the chunk-entry buffer, laid out like src; out is
// extended like src, or, when `last`, the unextended output.
extern "C" int igg_diffusion_band_step(const void* src, const void* A,
                                       const void* F, void* out, int dtype,
                                       const int* cfg, double cx, double cy,
                                       double cz, double cc, void* stream) {
  igg::Band b;
  if (!igg::make_band(cfg, b)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, A, F, out, b, cx, cy, cz, cc, st);
  if (dtype == 1)
    return launch<double>(src, A, F, out, b, cx, cy, cz, cc, st);
  return (int)cudaErrorInvalidValue;
}
