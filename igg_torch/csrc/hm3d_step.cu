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
// f32 peak.  In practice the issued instructions bound it: step_core's 9
// IEEE divisions a cell (each a reciprocal, a Newton step, a check and a
// guarded slow path) become about 16 here, because a thread forms the
// permeability at the 7 points its cells read and the x/y face fluxes of
// its own cells; built with approximate division (a measurement only, not
// bitwise) the kernel is 30% faster (kernel_variants.py, PERF.md).
// Sharing those across threads through shared memory is later work.
//
// What the design does about it: the shared walk of step_walk.cuh with the
// HM3D policy of hm3d.cuh.  A thread computes 16 bytes of one z row of both
// fields with vector loads and stores, so every access is coalesced and the
// neighbour rows come from L1/L2; along z it forms the permeability once
// per cell and each face's flux once for the two cells beside it.  Halo
// cells are resolved in the same pass by the walk, both fields of a cell
// together: a wrap halo recomputes the updated inner cell (Pe' and then
// phi' from it), received planes are read where they land.  The TPU
// kernel's x-slabs, slab carry and transposed z slabs existed for its
// (8,128) tiling and VMEM; none is needed here.
#include "hm3d.cuh"

namespace {

template <typename T>
int launch(const void* Pe, const void* phi, void* Pe_out, void* phi_out,
           const igg::Geo& geo, void* const* planes, const double* coef,
           int npow, cudaStream_t stream) {
  igg::Planes<T, 2> pl;
  for (int f = 0; f < 2; ++f)
    for (int j = 0; j < 6; ++j)
      pl.p[f][j] = static_cast<const T*>(planes[6 * f + j]);
  return igg::launch_step(
      igg::make_hm3d<T>(Pe, phi, coef, npow), geo, pl,
      igg::Fields<T, 2>{{static_cast<T*>(Pe_out), static_cast<T*>(phi_out)}},
      stream);
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2 mode0 mode1 mode2; planes: 12 pointers, (field,
// dim, side) with Pe's six first, null for dims not in RECV mode; coef: dx
// dy dz dt phi0 eta; npow >= 0; dtype: 0 float32, 1 float64.
extern "C" int igg_hm3d_step(const void* Pe, const void* phi, void* Pe_out,
                             void* phi_out, int dtype, const int* cfg,
                             void* const* planes, const double* coef,
                             int npow, void* stream) {
  const igg::Geo geo = igg::make_geo(cfg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (npow < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(Pe, phi, Pe_out, phi_out, geo, planes, coef, npow,
                         st);
  if (dtype == 1)
    return launch<double>(Pe, phi, Pe_out, phi_out, geo, planes, coef, npow,
                          st);
  return (int)cudaErrorInvalidValue;
}
