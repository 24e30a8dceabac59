// One iteration of the streaming banded K-step HM3D chunk: one launch
// advances both fields (Pe, phi) of every block of the block-stacked
// EXTENDED buffers by one coupled step, swept in x-row bands of depth B
// through a shared-memory window (the walk of band_walk.cuh, with the HM3D
// policy of hm3d.cuh; both fields re-freeze on open dims, igg's
// `freeze_fields=(0, 1)`).
//
// Replaces the HM3D instance of the TPU kernel of igg/ops/chunk_engine.py
// (_streaming_kernel; entry streaming_chunk_call, as
// igg/ops/hm3d_trapezoid.py:fused_hm3d_banded_steps configures it), which
// ran all K iterations in one launch, each band's rolling window in VMEM,
// the iterations ping-ponging through HBM.  Here the chunk is K launches
// that ping-pong two buffer pairs, the last writing the central windows;
// temporal blocking in shared memory is later work.
//
// What bounds it on the H100: bytes, and in practice the IEEE divisions of
// the HM3D update (hm3d.cuh).  Per launch it reads both extended fields
// once and writes them once: at 8 blocks of 272^3 f32 (the 508^3 grid's
// 256^3 blocks extended by K = 8) 2.58 GB, 0.77 ms at 3.35 TB/s; a whole
// K = 8 chunk needs to read each extended field once and write each
// central block once (0.70 ms).
//
// What the design does about it: a thread block stages its band's rows
// and its tile's radius once, and every cell reads its neighbours from
// shared memory; the divisions are the policy's, in its order.
#include "band_walk.cuh"
#include "hm3d.cuh"

namespace {

template <typename T>
int launch(void* const* src, void* const* F, void* const* out,
           const igg::Band& b, const double* coef, int npow,
           cudaStream_t stream) {
  return igg::launch_band(
      igg::make_hm3d<T>(src[0], src[1], coef, npow), b,
      igg::Fields<const T, 2>{
          {static_cast<const T*>(F[0]), static_cast<const T*>(F[1])}},
      igg::Fields<T, 2>{{static_cast<T*>(out[0]), static_cast<T*>(out[1])}},
      stream);
}

}  // namespace

// src, F, out: (Pe, phi) pointers of the iteration's source buffers, the
// chunk-entry buffers (laid out like src) and the targets (extended like
// src, or, when `last`, the unextended outputs); cfg: the band layout of
// igg::make_band (band_walk.cuh); coef: dx dy dz dt phi0 eta; npow >= 0;
// dtype: 0 float32, 1 float64.
extern "C" int igg_hm3d_band_step(void* const* src, void* const* F,
                                  void* const* out, int dtype, const int* cfg,
                                  const double* coef, int npow, void* stream) {
  igg::Band b;
  if (!igg::make_band(cfg, b) || npow < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, out, b, coef, npow, st);
  if (dtype == 1) return launch<double>(src, F, out, b, coef, npow, st);
  return (int)cudaErrorInvalidValue;
}
