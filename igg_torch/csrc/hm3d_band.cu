// One iteration of the streaming banded K-step HM3D chunk: one launch
// advances both fields (Pe, phi) of every block of the block-stacked
// EXTENDED buffers by one coupled step with the rules of the banded
// realization (igg_torch/ops/chunk_engine.py: banded_window_plain with
// hm3d_trapezoid.band_update; both fields re-freeze on open dims, igg's
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
// The bands are the TPU's VMEM at work, not part of the function: a band
// reads the previous iteration's values of its block, padded only at the
// block's x ends, so every band depth B gives the same buffers
// (tests/test_torch_banded.py holds that).  So the kernel walks x in
// segments of its own choosing; B is a parameter of the layout and of the
// gates only, and the kernel's shared memory does not depend on it.
//
// What bounds it on the H100: by the roofline, bytes.  Per launch it reads
// both extended fields once and writes them once: at 8 blocks of 272^3 f32
// (the 508^3 grid's 256^3 blocks extended by K = 8) 2.58 GB, 0.77 ms at
// 3.35 TB/s.  Its first design (band_walk.cuh: a thread block per band and
// tile, hm3d.cuh's one-cell update on the staged window, 18 IEEE divisions
// a cell, each face's flux formed from both sides) ran at 4.9 times that.
//
// What the design does about it: the x-march of hm3d_march.cuh: each
// cell's permeability and each face's flux formed once (9 divisions a cell
// by const_div.cuh, bitwise `x / d`), the planes staged by cp.async and
// clamped at the block's x ends, wraps resolved by writing each computed
// cell to every target that aliases it, the band halo's freezes taken at
// those writes.
#include "hm3d_march.cuh"

// src, F, out: (Pe, phi) pointers of the iteration's source buffers, the
// chunk-entry buffers (laid out like src) and the targets (extended like
// src, or, when `last`, the unextended outputs); cfg: the band layout of
// chunk_engine.band_cfg (igg::march_band_layout, march_layout.cuh); coef:
// dx dy dz dt phi0 eta; npow >= 0; dtype: 0 float32, 1 float64.
extern "C" int igg_hm3d_band_step(void* const* src, void* const* F,
                                  void* const* out, int dtype, const int* cfg,
                                  const double* coef, int npow, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return igg::run_hm_march<float, igg::BandEdges>(src, F, out, cfg, coef,
                                                    npow, st);
  if (dtype == 1)
    return igg::run_hm_march<double, igg::BandEdges>(src, F, out, cfg, coef,
                                                     npow, st);
  return (int)cudaErrorInvalidValue;
}
