// One iteration of the streaming banded K-step diffusion chunk: one launch
// advances every block of a block-stacked EXTENDED buffer by one diffusion
// step with the rules of the banded realization (igg_torch/ops/
// chunk_engine.py: banded_window_plain with diffusion_trapezoid.
// banded_update; T re-frozen on open dims, A constant).
//
// Replaces the diffusion instance of the TPU kernel of
// igg/ops/chunk_engine.py (_streaming_kernel; entry streaming_chunk_call,
// as igg/ops/diffusion_trapezoid.py:fused_diffusion_banded_steps
// configures it), which ran all K iterations in one launch, each band's
// rolling window in VMEM, the iterations ping-ponging through HBM.  Here
// the chunk is K launches that ping-pong two device buffers, the last
// writing the central windows; holding K iterations of a band on chip
// (temporal blocking) is later work.
//
// The bands are the TPU's VMEM at work, not part of the function: a band
// reads the previous iteration's values of its block, padded only at the
// block's x ends, so every band depth B gives the same buffers
// (tests/test_torch_banded.py holds that).  So the kernel walks x in
// segments of its own choosing; B is a parameter of the layout and of the
// gates only, and the kernel's shared memory does not depend on it.
//
// What bounds it on the H100: bytes.  Per launch it reads the extended T
// and A once and writes T once: at 8 blocks of 272^3 f32 (the 510^3
// headline's 256^3 blocks extended by K = 8) 1.93 GB, 0.58 ms at 3.35
// TB/s.  A whole K = 8 chunk needs to read each extended field once and
// write each central block once (0.55 ms): a design that keeps the
// iterations on chip would approach that.  Its first design (band_walk.cuh:
// a thread block per band and 8 x 32 tile staging B + 2 rows of T and of A
// with a halo, 64-bit clamped addresses and plain loads, then one barrier
// before any arithmetic, wrap aliases recomputed from device memory) ran
// at 2.3 times a pass.
//
// What the design does about it: the x-march of diffusion_march.cuh: T's
// planes staged by cp.async two planes ahead of the update in a ring, A
// copied once at the cell, one barrier a plane, wraps resolved by writing
// each computed cell to every target that aliases it, the band halo's
// freezes taken at those writes.
#include "diffusion_march.cuh"

namespace {

template <typename T>
int launch(const void* src, const void* A, const void* F, void* out,
           const int* cfg, double cx, double cy, double cz, double cc,
           cudaStream_t stream) {
  igg::DmArgs<T> m;
  if (!igg::march_band_layout(cfg, m)) return (int)cudaErrorInvalidValue;
  m.src = static_cast<const T*>(src);
  m.A = static_cast<const T*>(A);
  m.F = static_cast<const T*>(F);
  m.out = static_cast<T*>(out);
  m.k = igg::Coef<T>{(T)cx, (T)cy, (T)cz, (T)cc};
  return igg::launch_dm_march(m, stream);
}

}  // namespace

// cfg: the band layout of chunk_engine.band_cfg (igg::march_band_layout,
// march_layout.cuh); dtype: 0 float32, 1 float64.  F is the chunk-entry
// buffer, laid out like src; out is extended like src, or, when `last`, the
// unextended output.
extern "C" int igg_diffusion_band_step(const void* src, const void* A,
                                       const void* F, void* out, int dtype,
                                       const int* cfg, double cx, double cy,
                                       double cz, double cc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, A, F, out, cfg, cx, cy, cz, cc, st);
  if (dtype == 1)
    return launch<double>(src, A, F, out, cfg, cx, cy, cz, cc, st);
  return (int)cudaErrorInvalidValue;
}
