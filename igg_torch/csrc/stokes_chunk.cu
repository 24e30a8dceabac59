// One iteration of a K-iteration Stokes chunk: one launch advances the four
// fields (P, Vx, Vy, Vz) of every block of the block-stacked EXTENDED
// buffers (each block widened by E = 2K rows beyond both ends of every
// extended dim; Rho extended alike, read only) by one pseudo-transient
// iteration, with the rules of the window realization
// (igg_torch/ops/chunk_engine.py: window_step_plain, freeze_fields
// (1, 2, 3)):
//   - every cell of each extended block takes the block update of
//     stokes.cuh (P on every cell, stale outer faces), so that the
//     intermediate buffers equal the plain version's too;
//   - where y or z is one periodic block (wrap), each field's edges take
//     the updated values at the inner cells they alias, with the field's
//     own overlap (Vy's y overlap is 4: edge 0 <- s1-3, edge s1 <- 3);
//   - on open dims (oext, frozen) the three velocities re-freeze from the
//     chunk-entry buffers on the blocks of the global edges, each with its
//     own staggered high plane; the pressure does not freeze;
//   - the last iteration writes only each block's central window, straight
//     into the unextended outputs.
//
// Replaces the Stokes instance of the TPU kernel of igg/ops/chunk_engine.py
// (_resident_kernel; entry resident_chunk_call, as
// igg/ops/stokes_trapezoid.py:_chunk_call configures it), which held the
// five extended fields in VMEM for the K iterations and updated them in
// place in x-row bands.  An extended 288^3 block is 96 MB a field and does
// not fit in shared memory, so here the chunk is K launches that ping-pong
// two buffer quadruples through device memory; temporal blocking in shared
// memory is later work.
//
// What bounds it on the H100: by the roofline, bytes.  Per launch it reads
// the five extended fields once and writes the four updated ones once: at 8
// blocks of 256^3 extended by E = 16 (288^3, K = 8) that is 6.9 GB, 2.05 ms
// at 3.35 TB/s; the last launch writes only the central windows.  As for
// the step kernel, its IEEE divisions set its time; on open grids the
// zeros beyond the domain in the edge blocks' shoulders take their slow
// path.
//
// What the design does about it: the step kernel's walk and policy
// (stagger_walk3.cuh, stokes.cuh), the freeze and the wrap aliases
// resolved per run; the x rows of the blocks along x ride gridDim.z (8
// extended blocks of 288^3: 578 rows), the y tiles gridDim.y.
#include "stokes.cuh"

// src, F, out: (P, Vx, Vy, Vz) pointers of the step's source buffers, the
// chunk-entry buffers (laid out like src) and the targets (extended like
// src, or, on the last step, the unextended outputs); rho: the extended Rho;
// cfg: the layout of igg::make_stag3 (stagger_walk3.cuh); coef: dx dy dz mu
// 2*mu dtP dtV; dtype: 0 float32, 1 float64.
extern "C" int igg_stokes_chunk_step(void* const* src, void* const* F,
                                     const void* rho, void* const* out,
                                     int dtype, const int* cfg,
                                     const double* coef, void* stream) {
  igg::Stag3 g;
  if (!igg::make_stag3(cfg, g)) return (int)cudaErrorInvalidValue;
  return igg::launch_stokes(src, rho, F, out, dtype, g, coef, stream);
}
