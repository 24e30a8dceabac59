// One iteration of the streaming banded K-iteration Stokes chunk: one launch
// advances the four fields (P, Vx, Vy, Vz) of every block of the
// block-stacked EXTENDED buffers (each block widened by E = 2K rows beyond
// both ends of every extended dim; Rho extended alike, read only) by one
// pseudo-transient iteration, swept in x-row bands of depth B through a
// shared-memory window (the walk of stagger_band_walk3.cuh with the policy
// of stokes.cuh): each band's window holds rows [a - 1, a + B + 1) of P,
// Vy, Vz and Rho and [a - 1, a + B + 2) of Vx over an 8 x 32 y/z tile and
// its radius, clamped per block; the band halo re-freezes the velocities
// on open dims (P does not freeze) and re-wraps every field with its own
// overlap where y or z is one periodic block; the last launch writes the
// central windows into the unextended outputs.
//
// Replaces the Stokes instance of the TPU kernel of igg/ops/chunk_engine.py
// (_streaming_kernel; entry streaming_chunk_call, as
// igg/ops/stokes_trapezoid.py:fused_stokes_banded_iters configures it with
// _band_update), which ran all K iterations in one launch, each band's
// rolling window of the five fields in VMEM, the iterations ping-ponging
// through HBM.  Here the chunk is K launches that ping-pong two buffer
// quadruples through device memory; holding a band's K iterations on chip
// (temporal blocking) is later work.
//
// What bounds it on the H100: by the roofline, bytes.  Per launch it reads
// the five extended fields once and writes the four updated ones once: at 8
// blocks of 256^3 extended by E = 16 (288^3, K = 8) that is 6.9 GB, 2.05 ms
// at 3.35 TB/s.  As for the step and chunk kernels, the IEEE divisions (a
// one-cell run forms 46 a cell) set its time, and the zero shoulders of
// the open extension take their slow path.
//
// What the design does about it: a thread block stages its band's rows of
// the five arrays once (70 KB in f32 at B = 8), coalesced along z, and each
// thread runs the policy's own `cells<1>` on them, so every neighbour read
// comes from shared memory and the arithmetic is that of the step and
// chunk kernels, bit for bit.
#include "stagger_band_walk3.cuh"
#include "stokes.cuh"

namespace {

template <typename T>
int launch(void* const* src, void* const* F, const void* rho,
           void* const* out, const int* cfg, const double* coef,
           cudaStream_t stream) {
  igg::StagBand b;
  if (!igg::make_stag_band<igg::Stokes<T>>(cfg, b))
    return (int)cudaErrorInvalidValue;
  return igg::launch_stag_band(igg::make_stokes<T>(src, rho, coef), b,
                               igg::stokes_entry<T>(F),
                               igg::stokes_out<T>(out), stream);
}

}  // namespace

// src, F, out: (P, Vx, Vy, Vz) pointers of the iteration's source buffers,
// the chunk-entry buffers (laid out like src) and the targets (extended
// like src, or, on the last launch, the unextended outputs); rho: the
// extended Rho; cfg: the layout of igg::make_stag_band
// (stagger_band_walk3.cuh); coef: dx dy dz mu 2*mu dtP dtV; dtype: 0
// float32, 1 float64.
extern "C" int igg_stokes_band_step(void* const* src, void* const* F,
                                    const void* rho, void* const* out,
                                    int dtype, const int* cfg,
                                    const double* coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, rho, out, cfg, coef, st);
  if (dtype == 1) return launch<double>(src, F, rho, out, cfg, coef, st);
  return (int)cudaErrorInvalidValue;
}
