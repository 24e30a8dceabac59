// Fused Stokes iteration: one launch writes the pseudo-transient update of
// every block of a block-stacked grid's (P, Vx, Vy, Vz) into new tensors:
// the pressure on every cell, the velocities on their block's interior
// faces, the outer faces copied through with an exact +0 (the 3-D staggered
// walk of stagger_walk3.cuh with the policy of stokes.cuh, targets = whole
// blocks, no wrap, nothing frozen; Rho is read only).  No halo planes: the
// grouped update_halo of the four fields follows, through the port's halo
// engine.
//
// Replaces the TPU kernel of igg/ops/stokes_pallas.py (_kernel,
// _call_kernel; entries fused_stokes_iteration, make_iteration's
// per-iteration tier), which held x-slabs of the five fields in VMEM and
// assembled the halo planes in the kernel from send planes recomputed on
// thin windows.  In-kernel halo assembly is later work here.
//
// What bounds it on the H100: bytes, by the roofline.  It reads P, Vx, Vy,
// Vz and Rho once and writes the four updated fields once: at one 256^3
// f32 block that is 606 MB, 0.181 ms at 3.35 TB/s.  But it does about 77
// operations a cell, 22 of them IEEE divisions when each quotient is formed
// once, and an IEEE division is a sequence of instructions whose checks
// send a zero or subnormal dividend down a slow path: the divisions, not
// the bytes, set its time (approximate division, never shipped since it
// is not bitwise, takes a third off; kernel_variants.py).
//
// What the design does about it: the staggered walk's layout, a thread per
// 8-byte run along z (2 cells in f32, 1 in f64), threads along z, so every
// access is coalesced and the neighbour rows come from L1/L2.  A run forms
// each quotient, stress and pressure of its own row once, and recomputes
// only those of the rows at x-1 and y-1 and the edge stresses it shares
// with other runs: 42 divisions a cell in f32 (46 in f64) against the 22 of
// a design that shares them between threads through shared memory, the
// next step.  Runs of 16 bytes recomputed less (40 divisions a cell) but
// took 180 registers a thread and ran 1.5 to 2 times as long
// (kernel_variants.py).  Vz's rows of s2+1 elements are not 8-byte aligned
// in f32 and take scalar loads.
#include "stokes.cuh"

// src, out: (P, Vx, Vy, Vz) pointers of the sources and of the targets (laid
// out like the sources, none aliasing another); rho: Rho, laid out like P;
// cfg: n0 n1 n2 s0 s1 s2 (blocks and P's block extents); coef: dx dy dz mu
// 2*mu dtP dtV; dtype: 0 float32, 1 float64.
extern "C" int igg_stokes_step(void* const* src, const void* rho,
                               void* const* out, int dtype, const int* cfg,
                               const double* coef, void* stream) {
  // make_stag3's layout: whole blocks, no wrap, no freeze.
  int full[24 + 3 * igg::MAXF] = {cfg[0], cfg[1], cfg[2], cfg[3], cfg[4],
                                  cfg[5], 0,      0,      0,      0,
                                  0,      0,      cfg[3], cfg[4], cfg[5]};
  igg::Stag3 g;
  if (!igg::make_stag3(full, g)) return (int)cudaErrorInvalidValue;
  return igg::launch_stokes(src, rho, nullptr, out, dtype, g, coef, stream);
}
