// Fused diffusion step: one launch writes one step of a block-stacked grid
// array into a new tensor, halo planes included.
//
// Replaces the TPU kernels of igg/ops/diffusion_pallas.py (_make_kernel,
// _call_kernel; entry fused_diffusion_step) and, launched once per step on
// two ping-pong buffers with no received planes, of
// igg/ops/diffusion_mega.py (_kernel; entry fused_diffusion_megasteps).
//
// What bounds it on the H100: bytes.  Per cell it reads T and A once and
// writes T once (12 bytes in f32, 12 flops): at 256^3 f32 that is 201 MB,
// 60 us at 3.35 TB/s, while the flops take 3 us; at 512^3, 1.61 GB and
// 480 us.  The TPU's K-step kernel kept A resident in VMEM for all K steps;
// here A (64 MiB at 256^3) does not fit the 50 MB L2, so every step reads
// it again.  Temporal blocking (K steps per pass over T and A), a
// persistent grid sync and TMA are later work.
//
// What the design does about it: the shared walk of step_walk.cuh with the
// diffusion policy of diffusion.cuh.  Each thread computes 16 bytes of one
// z row with vector loads and stores; a warp spans the contiguous z axis,
// so every access is coalesced, and the neighbour rows come from L1/L2, so
// device memory sees T about once.  Halo cells are resolved in the same
// pass: wrap halos recompute the updated inner plane from the source,
// received planes are read where they land, so there is no second pass and
// no grid-wide synchronization.  A thread resolves its row's halo walk
// once, so halo rows cost what interior rows cost.  The TPU kernel's
// x-slabs, slab carry and transposed z slabs existed for its (8,128)
// tiling and VMEM; none is needed here.
#include "diffusion.cuh"

namespace {

template <typename T>
int launch(const void* src, const void* A, void* out, const igg::Geo& geo,
           void* const* planes, double cx, double cy, double cz, double cc,
           cudaStream_t stream) {
  igg::Planes<T, 1> pl;
  for (int j = 0; j < 6; ++j) pl.p[0][j] = static_cast<const T*>(planes[j]);
  return igg::launch_step(igg::make_diffusion<T>(src, A, cx, cy, cz, cc), geo,
                          pl, igg::Fields<T, 1>{{static_cast<T*>(out)}},
                          stream);
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2 mode0 mode1 mode2; planes: (dim, side) pointers,
// null for dims not in RECV mode; dtype: 0 float32, 1 float64.
extern "C" int igg_diffusion_step(const void* src, const void* A, void* out,
                                  int dtype, const int* cfg,
                                  void* const* planes, double cx, double cy,
                                  double cz, double cc, void* stream) {
  const igg::Geo geo = igg::make_geo(cfg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(src, A, out, geo, planes, cx, cy, cz, cc, st);
  if (dtype == 1)
    return launch<double>(src, A, out, geo, planes, cx, cy, cz, cc, st);
  return (int)cudaErrorInvalidValue;
}
