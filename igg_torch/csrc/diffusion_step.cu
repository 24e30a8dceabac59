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
// What the design does about it: each thread computes 16 bytes of one z
// row with vector loads and stores (diffusion_common.cuh); a warp spans the
// contiguous z axis, so every access is coalesced, and the neighbour rows
// come from L1/L2, so device memory sees T about once.  Halo cells are
// resolved in the same pass: wrap halos recompute the updated inner plane
// from the source, received planes are read where they land, so there is no
// second pass and no grid-wide synchronization.  A thread resolves its row's
// halo walk once, so halo rows cost what interior rows cost.  The TPU
// kernel's x-slabs, slab carry and transposed z slabs existed for its
// (8,128) tiling and VMEM; none is needed here.
#include "diffusion_common.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    step_kernel(const T* __restrict__ src, const T* __restrict__ A,
                T* __restrict__ out, igg::Geo geo, igg::Planes<T> pl,
                igg::Coef<T> k) {
  const int z0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int g1 = blockIdx.y * blockDim.y + threadIdx.y;
  if (z0 < geo.G[2] && g1 < geo.G[1])
    igg::step_cells<T, VEC>(src, A, out, geo, pl, k, blockIdx.z, g1, z0);
}

template <typename T>
int launch(const void* src, const void* A, void* out, const igg::Geo& geo,
           void* const* planes, double cx, double cy, double cz, double cc,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  igg::Planes<T> pl;
  for (int j = 0; j < 6; ++j) pl.p[j] = static_cast<const T*>(planes[j]);
  const igg::Coef<T> k{(T)cx, (T)cy, (T)cz, (T)cc};
  if (igg::vector_ok<T, VEC>(geo, src, A, out, pl))
    return igg::launch_cells<T, VEC>(step_kernel<T, VEC>, src, A, out, geo,
                                     pl, k, stream);
  return igg::launch_cells<T, 1>(step_kernel<T, 1>, src, A, out, geo, pl, k,
                                 stream);
}

}  // namespace

// cfg: n0 n1 n2 s0 s1 s2 mode0 mode1 mode2; planes: (dim, side) pointers,
// null for dims not in RECV mode; dtype: 0 float32, 1 float64.
extern "C" int igg_diffusion_step(const void* src, const void* A, void* out,
                                  int dtype, const int* cfg,
                                  void* const* planes, double cx, double cy,
                                  double cz, double cc, void* stream) {
  igg::Geo geo;
  for (int d = 0; d < 3; ++d) {
    geo.n[d] = cfg[d];
    geo.s[d] = cfg[3 + d];
    geo.G[d] = cfg[d] * cfg[3 + d];
    geo.mode[d] = cfg[6 + d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(src, A, out, geo, planes, cx, cy, cz, cc, st);
  if (dtype == 1)
    return launch<double>(src, A, out, geo, planes, cx, cy, cz, cc, st);
  return (int)cudaErrorInvalidValue;
}
