// One step of a K-step wave2d chunk: one launch advances the three fields
// (P, Vx, Vy) of every block of the block-stacked EXTENDED buffers (each
// block widened by E = 2K rows beyond both ends of every extended dim) by
// one coupled step, with the rules of the window realization
// (igg_torch/ops/chunk_engine.py: window_step_plain, periodic modes):
//   - every cell of each extended block takes the block update of
//     wave2d.cuh (P on every cell, stale outer faces), so that the
//     intermediate buffers equal the plain version's too;
//   - where y is one periodic block (WRAP), each field's y edges take the
//     updated values at the inner cells they alias, with the field's own
//     overlap (Vy: 3, so edge 0 <- s1-2 and edge s1 <- 2);
//   - the last step writes only each block's central window, straight into
//     the unextended outputs.
// Periodic grids only, as in igg: nothing re-freezes.
//
// Replaces the wave2d instance of the TPU kernel of igg/ops/chunk_engine.py
// (_whole_window_kernel; entry whole_window_chunk_call, as
// igg/ops/wave2d_pallas.py:_chunk_call configures it), which held all three
// extended fields in VMEM for the K steps.  A 4096^2 window is 67 MB a field
// and does not fit in shared memory, so here the chunk is K launches that
// ping-pong two buffer triples through device memory; temporal blocking in
// shared memory is later work.
//
// What bounds it on the H100: bytes.  Per step it reads the three extended
// fields once and writes them once: at 8 blocks of 4096^2 extended by
// E = 16 in x (K = 8) that is 3.25 GB, 0.969 ms at 3.35 TB/s; the last
// launch writes only the central windows.
//
// What the design does about it: the staggered walk's layout (a thread per
// 16-byte run of a row, threads along y, coalesced, each face formed once
// per run; the blocks along x on gridDim.z, so 8 extended blocks' 33 000
// rows stay inside gridDim.y).
#include "wave2d.cuh"

// src, out: (P, Vx, Vy) pointers of the step's source buffers and of the
// targets (extended like src, or, on the last step, the unextended
// outputs); cfg: the layout of igg::make_stag (stagger_walk.cuh); coef:
// -dt/rho, dt*bulk, dx, dy; dtype: 0 float32, 1 float64.
extern "C" int igg_wave2d_chunk_step(void* const* src, void* const* out,
                                     int dtype, const int* cfg,
                                     const double* coef, void* stream) {
  igg::Stag g;
  if (!igg::make_stag(cfg, g)) return (int)cudaErrorInvalidValue;
  return igg::launch_wave2d(src, out, dtype, g, coef, stream);
}
