// One step of a K-step HM3D trapezoid chunk: one launch advances both fields
// (Pe, phi) of every block of the block-stacked EXTENDED buffers by one
// step (the rules of chunk_walk.cuh, with the HM3D policy of hm3d.cuh and
// no halo received; both fields re-freeze on open dims, igg's
// `freeze_fields=(0, 1)`).
//
// Replaces the HM3D instance of the TPU kernel of
// igg/ops/chunk_engine.py (_resident_kernel; entry resident_chunk_call, as
// igg/ops/hm3d_trapezoid.py:_chunk_call configures it), which held both
// extended fields in VMEM for all K steps.  Here the chunk is K launches
// that ping-pong two buffer pairs, the last writing the central windows;
// one launch per chunk, or temporal blocking in shared memory, is later
// work.
//
// What bounds it on the H100: bytes.  Per step it reads both extended
// fields once and writes them once; at 8 blocks of 272^3 f32 (the 508^3
// grid's 256^3 blocks extended by K = 8) that is 2.58 GB, 0.769 ms at
// 3.35 TB/s; the last launch writes only the central windows (0.705 ms).
//
// What the design does about it: the fused step's layout (a thread per 16
// bytes of a z row of both fields, every access coalesced, neighbours from
// L1/L2), with the freeze and the window mapping resolved once per row.
#include "chunk_walk.cuh"
#include "hm3d.cuh"

namespace {

template <typename T>
int launch(void* const* src, void* const* F, void* const* out,
           const igg::Chunk& c, const double* coef, int npow,
           cudaStream_t stream) {
  return igg::launch_chunk(
      igg::make_hm3d<T>(src[0], src[1], coef, npow), c,
      igg::Fields<const T, 2>{
          {static_cast<const T*>(F[0]), static_cast<const T*>(F[1])}},
      igg::Fields<T, 2>{{static_cast<T*>(out[0]), static_cast<T*>(out[1])}},
      stream);
}

}  // namespace

// src, F, out: (Pe, phi) pointers of the step's source buffers, the
// chunk-entry buffers (laid out like src) and the targets (extended like
// src, or, when `last`, the unextended outputs); cfg: the chunk layout of
// igg::make_chunk (chunk_walk.cuh); coef: dx dy dz dt phi0 eta; npow >= 0;
// dtype: 0 float32, 1 float64.
extern "C" int igg_hm3d_chunk_step(void* const* src, void* const* F,
                                   void* const* out, int dtype, const int* cfg,
                                   const double* coef, int npow,
                                   void* stream) {
  igg::Chunk c;
  if (!igg::make_chunk(cfg, c) || npow < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, out, c, coef, npow, st);
  if (dtype == 1) return launch<double>(src, F, out, c, coef, npow, st);
  return (int)cudaErrorInvalidValue;
}
