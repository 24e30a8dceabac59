// Fused wave2d step: one launch writes the coupled leapfrog update of every
// block of a block-stacked grid's (P, Vx, Vy) into new tensors: the
// velocities on their block's interior faces, then the pressure on every
// cell from the fresh divergence (the staggered walk of stagger_walk.cuh
// with the policy of wave2d.cuh, targets = whole blocks, no wrap).  No halo
// planes: the grouped update_halo follows, as it follows igg's kernel.
//
// Replaces the TPU kernel of igg/ops/wave2d_pallas.py (_step_kernel,
// _call_step_kernel; entries fused_wave2d_step, fused_wave2d_steps), which
// held the three blocks in VMEM.
//
// What bounds it on the H100: bytes.  It reads P, Vx and Vy once and writes
// them once: at one 4096^2 f32 block that is 403 MB, 0.120 ms at 3.35 TB/s,
// against about 15 operations a cell (4 of them IEEE divisions).
//
// What the design does about it: the staggered walk of stagger_walk.cuh.  A
// thread takes a run of 16 bytes of one row (4 cells in f32), threads along
// y, so every access is coalesced and the neighbour rows come from L1/L2; it
// forms the run's VEC+1 y faces and 2*VEC x faces once each, with 16-byte
// loads and stores where a row allows them (Vy's rows of s1+1 elements
// mostly do not).  A first version with a thread per cell, scalar loads and
// the four faces recomputed per P cell took 0.39 ms on an H100 at 4096^2
// f32, 2.7 times as long (kernel_variants.py on that version).
#include "wave2d.cuh"

// src, out: (P, Vx, Vy) pointers of the sources and of the targets (laid
// out like the sources, none aliasing another); cfg: n0 n1 s0 s1 (blocks
// and P's block extents); coef: -dt/rho, dt*bulk, dx, dy; dtype: 0 float32,
// 1 float64.
extern "C" int igg_wave2d_step(void* const* src, void* const* out, int dtype,
                               const int* cfg, const double* coef,
                               void* stream) {
  // make_stag's layout: whole blocks, no wrap, no freeze.
  const int full[15 + igg::MAXF] = {cfg[0], cfg[1], cfg[2], cfg[3], 0, 0, 0,
                                    cfg[2], cfg[3]};
  igg::Stag g;
  if (!igg::make_stag(full, g)) return (int)cudaErrorInvalidValue;
  return igg::launch_wave2d(src, out, dtype, g, coef, stream);
}
