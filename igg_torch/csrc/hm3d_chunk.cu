// One step of a K-step HM3D trapezoid chunk: one launch advances both fields
// (Pe, phi) of every block of the block-stacked EXTENDED buffers by one
// step (the rules of chunk_walk.cuh with the HM3D update of hm3d.cuh and
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
// What bounds it on the H100: by the roofline, bytes.  Per step it reads
// both extended fields once and writes them once; at 8 blocks of 272^3 f32
// (the 508^3 grid's 256^3 blocks extended by K = 8) that is 2.58 GB, 0.769
// ms at 3.35 TB/s; the last launch writes only the central windows.  Its
// first design (chunk_walk.cuh: a thread per 16 bytes of a z row, the
// neighbours from L1/L2, hm3d.cuh's update with 18 IEEE divisions a cell,
// each face's flux formed from both sides) ran at 4.6 times a pass.
//
// What the design does about it: the x-march of hm3d_march.cuh with the
// chunk's edge rules (ChunkEdges, march_layout.cuh): each cell's
// permeability and each face's flux formed once (9 divisions a cell by
// const_div.cuh, bitwise `x / d`), the planes staged by cp.async, wraps
// resolved by writing each computed cell to every target that aliases it,
// the open dims' freezes taken at those writes.
#include "hm3d_march.cuh"

// src, F, out: (Pe, phi) pointers of the step's source buffers, the
// chunk-entry buffers (laid out like src) and the targets (extended like
// src, or, when `last`, the unextended outputs); cfg: the chunk layout of
// chunk_engine.chunk_cfg (igg::march_chunk_layout, march_layout.cuh; wraps
// with overlap 2); coef: dx dy dz dt phi0 eta; npow >= 0; dtype: 0
// float32, 1 float64.
extern "C" int igg_hm3d_chunk_step(void* const* src, void* const* F,
                                   void* const* out, int dtype, const int* cfg,
                                   const double* coef, int npow,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return igg::run_hm_march<float, igg::ChunkEdges>(src, F, out, cfg, coef,
                                                     npow, st);
  if (dtype == 1)
    return igg::run_hm_march<double, igg::ChunkEdges>(src, F, out, cfg, coef,
                                                      npow, st);
  return (int)cudaErrorInvalidValue;
}
