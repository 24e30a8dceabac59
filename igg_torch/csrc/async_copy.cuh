// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80+), the staging of the x-marches (stokes_march.cuh, hm3d_march.cuh,
// diffusion_march.cuh, stagger_band_march3.cuh).
// Compiled for the CPU (the rehearsal of tests/test_torch_kernel_sources.py)
// they are plain copies, complete when issued.
#pragma once

#include <cuda_runtime.h>

namespace igg {

// A 4- or 8-byte copy of *src to dst, or a zero where `valid` is false (src
// is then not read, but is an address inside the field).
template <typename T>
__device__ __forceinline__ void march_copy(T* dst, const T* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(int(sizeof(T))),
               "r"(valid ? int(sizeof(T)) : 0));
#else
  *dst = valid ? *src : T(0);
#endif
}

// A 16-byte copy of the 16 / sizeof(T) elements at src (both 16-byte
// aligned) to dst, or zeros where `valid` is false (src is then not read,
// but is an aligned address inside the field).
template <typename T>
__device__ __forceinline__ void march_copy16(T* dst, const T* src,
                                             bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
#else
  for (int e = 0; e < int(16 / sizeof(T)); ++e) dst[e] = valid ? src[e] : T(0);
#endif
}

__device__ __forceinline__ void march_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void march_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

__device__ __forceinline__ int march_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace igg
