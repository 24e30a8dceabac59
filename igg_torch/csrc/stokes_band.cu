// One iteration of the streaming banded K-iteration Stokes chunk: one launch
// advances the four fields (P, Vx, Vy, Vz) of every block of the
// block-stacked EXTENDED buffers (each block widened by E = 2K rows beyond
// both ends of every extended dim; Rho extended alike, read only) by one
// pseudo-transient iteration with the rules of the banded realization
// (igg_torch/ops/chunk_engine.py: banded_window_plain with
// stokes_trapezoid.band_update): every row of a block is updated, its x
// neighbours clamped to the block's own first and last rows of each field;
// the band halo re-freezes the velocities on exactly the freeze rows of
// open dims (P does not freeze) and re-wraps every field with its own
// overlap where y or z is one periodic block, in band_halo's order; Vx's
// tail row keeps its source value; the last launch writes the central
// windows into the unextended outputs.
//
// Replaces the Stokes instance of the TPU kernel of igg/ops/chunk_engine.py
// (_streaming_kernel; entry streaming_chunk_call, as
// igg/ops/stokes_trapezoid.py:fused_stokes_banded_iters configures it with
// _band_update), which ran all K iterations in one launch, each band's
// rolling window of the five fields in VMEM, the iterations ping-ponging
// through HBM.  Here the chunk is K launches that ping-pong two buffer
// quadruples through device memory; holding K iterations on chip (temporal
// blocking) is later work.
//
// The bands are the TPU's VMEM at work, not part of the function: a band
// reads the previous iteration's values of its block, padded only at the
// block's x ends, so every band depth B gives the same buffers
// (tests/test_torch_banded_stagger.py holds that).  So the kernel walks x
// in segments of its own choosing; B is a parameter of the layout and of
// the gates only, and the kernel's shared memory does not depend on it.
//
// What bounds it on the H100: by the roofline, bytes.  Per launch it reads
// the five extended fields once and writes the four updated ones once: at 8
// blocks of 256^3 extended by E = 16 (288^3, K = 8) that is 6.9 GB, 2.06 ms
// at 3.35 TB/s.  Its first design (a thread block per band and tile staging
// each array's window, stokes.cuh's one-cell update on it: 46 IEEE
// divisions a cell, whose slow path the open extension's zero shoulders
// take) ran at 13.8 times that.
//
// What the design does about it: the x-march of the Stokes chunk kernel
// (stokes_march.cuh) in its band mode: each quotient formed once in shared
// memory (22 divisions a cell by const_div.cuh, bitwise `x / d`), the
// planes staged by cp.async and clamped per field at the block's x ends,
// wraps resolved by writing each computed cell to every target that
// aliases it, the band halo's freezes taken at those writes.
#include "stokes_march.cuh"

namespace {

// cfg: chunk_engine.stagger_band_cfg, the layout of make_stag3 (24 + 3 MAXF
// ints), then B, lo and the staged arrays' margins above a band (P, Vx,
// Vy, Vz, Rho).  Whether it suits the band walk's layout: B divides the
// extended x span, and the margins hold the rows one cell's update reads
// (those of make_sb_layout in stagger_band_march3.cuh).
bool band_layout(const int* cfg, igg::Stag3& g) {
  if (!igg::make_stag3(cfg, g)) return false;
  constexpr int at = 24 + 3 * igg::MAXF;
  const int B = cfg[at], lo = cfg[at + 1];
  if (B < 1 || g.s[0] % B != 0 || lo < 1) return false;
  for (int k = 0; k < 5; ++k)
    if (cfg[at + 2 + k] < lo + (k == 1)) return false;
  return true;
}

template <typename T>
int launch(void* const* src, void* const* F, const void* rho,
           void* const* out, const int* cfg, const double* coef,
           cudaStream_t stream) {
  igg::Stag3 g;
  if (!band_layout(cfg, g)) return (int)cudaErrorInvalidValue;
  igg::MarchArgs<T> m;
  for (int f = 0; f < 4; ++f) {
    m.src[f] = static_cast<const T*>(src[f]);
    m.F[f] = static_cast<const T*>(F[f]);
    m.out[f] = static_cast<T*>(out[f]);
  }
  m.rho = static_cast<const T*>(rho);
  m.qx = igg::make_div((T)coef[0]);
  m.qy = igg::make_div((T)coef[1]);
  m.qz = igg::make_div((T)coef[2]);
  m.q3 = igg::make_div(T(3));
  m.mu = (T)coef[3];
  m.c2mu = (T)coef[4];
  m.dtP = (T)coef[5];
  m.dtV = (T)coef[6];
  m.g = g;
  return igg::launch_march<true>(m, stream);
}

}  // namespace

// src, F, out: (P, Vx, Vy, Vz) pointers of the iteration's source buffers,
// the chunk-entry buffers (laid out like src) and the targets (extended
// like src, or, on the last launch, the unextended outputs); rho: the
// extended Rho; cfg: chunk_engine.stagger_band_cfg (band_layout above);
// coef: dx dy dz mu 2*mu dtP dtV; dtype: 0 float32, 1 float64.
extern "C" int igg_stokes_band_step(void* const* src, void* const* F,
                                    const void* rho, void* const* out,
                                    int dtype, const int* cfg,
                                    const double* coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, rho, out, cfg, coef, st);
  if (dtype == 1) return launch<double>(src, F, rho, out, cfg, coef, st);
  return (int)cudaErrorInvalidValue;
}
