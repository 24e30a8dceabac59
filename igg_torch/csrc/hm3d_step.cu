// Fused HM3D step: one launch writes one step of both fields (Pe, phi) of a
// block-stacked grid into new tensors, halo planes included.
//
// Replaces the TPU kernels of igg/ops/hm3d_pallas.py (_make_kernel,
// _call_kernel; entries fused_hm3d_step, fused_hm3d_steps) and, launched
// once per step on two ping-pong pairs with no received planes, of
// igg/ops/hm3d_mega.py (_kernel; entry fused_hm3d_megasteps).
//
// What bounds it on the H100: by the roofline, bytes.  Per cell it reads Pe
// and phi once and writes them once (16 bytes in f32): at 256^3 f32 that is
// 268 MB, 80 us at 3.35 TB/s, while 42 operations a cell take 11 us at the
// f32 peak.  In practice the issued instructions bound it.  Its first
// design (step_walk.cuh's thread per 16 bytes of a z row with hm3d.cuh's
// update, kept in kernel_variants.py) formed the permeability at the 7
// points each cell reads and the x/y face fluxes per cell: about 16 IEEE
// divisions a cell against step_core's 9, and 0.394 ms at one periodic
// 256^3 block, 4.9 times the bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// What the design does about it: the HM3D x-march of hm3d_march.cuh (16 x
// 16 (y, z) tiles, Pe and phi staged by cp.async in shared-memory rings, k
// formed once a cell and each face's flux once, 9 divisions a cell) with
// the fused step's edge rules, StepEdges (march_layout.cuh): whole blocks,
// every cell computed once at its source position and written to each
// target that takes it; a WRAP dim (x included) writes plane s-2 also to 0
// and plane 1 also to s-1, a RECV dim's halo cells take the received plane,
// a FROZEN dim's outer cells their source values, each target resolved z,
// then y, then x, as the walk resolves it.  At one periodic 256^3 block it
// takes 0.297 ms in float32, 1.34 times faster than its first design in
// the same call, and 0.362 ms in float64 (2.11 times); 2x2x2 blocks, every
// dim received, 1.13 and 1.86 times (kernel_variants.py on an H100 80GB
// HBM3 at 700 W, PERF.md).  What still bounds it: the march's per-plane
// fixed work (staging, the tile's halo k and fluxes, a barrier a plane)
// and the cells on a y wrap's rows or a received y or z halo row, whose
// writes take a slower, divergent path (8% of its time at one block, 14%
// at 2x2x2: kernel_variants.py's hm_step_no_special_writes).
#include "hm3d_march.cuh"

// cfg: n0 n1 n2 s0 s1 s2 mode0 mode1 mode2; planes: 12 pointers, (field,
// dim, side) with Pe's six first, null for dims not in RECV mode; coef: dx
// dy dz dt phi0 eta; npow >= 0; dtype: 0 float32, 1 float64.
extern "C" int igg_hm3d_step(const void* Pe, const void* phi, void* Pe_out,
                             void* phi_out, int dtype, const int* cfg,
                             void* const* planes, const double* coef,
                             int npow, void* stream) {
  void* src[2] = {const_cast<void*>(Pe), const_cast<void*>(phi)};
  void* out[2] = {Pe_out, phi_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return igg::run_hm_step<float>(src, out, cfg, planes, coef, npow, st);
  if (dtype == 1)
    return igg::run_hm_step<double>(src, out, cfg, planes, coef, npow, st);
  return (int)cudaErrorInvalidValue;
}
