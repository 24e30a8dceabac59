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
// at 3.35 TB/s; the last launch writes only the central windows.  Its
// first design (stokes.cuh's 2-cell runs on stagger_walk3.cuh) was
// issue-bound instead: 42 IEEE divisions a cell, whose slow path the
// zeros of an open extension's shoulders take, and 7.9x the bound.
//
// What the design does about it: the x-march of stokes_march.cuh (each
// quotient formed once in shared memory, 22 divisions a cell; the planes
// staged by cp.async while the previous one is computed; wraps and face
// rows inside the tile) with the division of const_div.cuh (float32 by the
// launch's reciprocals and FMA corrections, bitwise `x / d`; zero
// dividends off the slow path).
#include "stokes_march.cuh"

namespace {

template <typename T>
int launch(void* const* src, void* const* F, const void* rho,
           void* const* out, const igg::Stag3& g, const double* coef,
           cudaStream_t stream) {
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
  return igg::launch_march<false>(m, stream);
}

__device__ __forceinline__ float from_bits(unsigned u) {
  return __uint_as_float(u);
}
__device__ __forceinline__ double from_bits(unsigned long long u) {
  return __longlong_as_double(static_cast<long long>(u));
}
__device__ __forceinline__ unsigned to_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long to_bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

// Counts the dividends x = bits lo + i * step (i < n, modulo 2^32 or 2^64)
// whose quotient by d through igg::cdiv differs in any bit from `x / d`.
template <typename T, typename U>
__global__ void div_check_kernel(igg::ConstDiv<T> q, U lo, U step,
                                 unsigned long long n,
                                 unsigned long long* bad) {
  unsigned long long mine = 0;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const T x = from_bits(static_cast<U>(lo + static_cast<U>(i) * step));
    if (to_bits(igg::cdiv(x, q)) != to_bits(x / q.d)) ++mine;
  }
  if (mine) atomicAdd(bad, mine);
}

}  // namespace

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, F, rho, out, g, coef, st);
  if (dtype == 1) return launch<double>(src, F, rho, out, g, coef, st);
  return (int)cudaErrorInvalidValue;
}

// The check of the division against `x / d`: adds to *bad (device memory)
// the dividends of the n it tries that differ; dtype 0 float32 (the low 32
// bits of lo and step), 1 float64.
extern "C" int igg_stokes_div_check(double d, int dtype, unsigned long long lo,
                                    unsigned long long step,
                                    unsigned long long n, void* bad,
                                    void* stream) {
  unsigned long long* out = static_cast<unsigned long long*>(bad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (long long)((n + 255) / 256);
  const unsigned blocks = (unsigned)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  if (dtype == 0) {
    const igg::ConstDiv<float> q = igg::make_div((float)d);
    const unsigned lo32 = (unsigned)lo, step32 = (unsigned)step;
    div_check_kernel<float, unsigned><<<blocks, 256, 0, st>>>(q, lo32, step32, n, out);
  } else if (dtype == 1) {
    const igg::ConstDiv<double> q = igg::make_div(d);
    div_check_kernel<double, unsigned long long><<<blocks, 256, 0, st>>>(q, lo, step, n, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
