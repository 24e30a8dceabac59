// The diffusion physics of the step walk (step_walk.cuh): one field T and
// the constant coefficient A = dt*lam/Cp, the 7-point update
// T + A*lap(T).
#pragma once

#include "step_walk.cuh"

namespace igg {

template <typename T>
struct Coef {
  T cx, cy, cz, cc;  // rdx2, rdy2, rdz2, 2*(rdx2+rdy2+rdz2)
};

// The update of one interior cell: ctr + a*lap with lap associated as
// ((x + y) + z) - cc*ctr, the order of igg.ops.diffusion_compute and of
// the port's plain version.  Built with -fmad=false, so each operation
// rounds separately like the plain PyTorch version.
template <typename T>
__device__ __forceinline__ T stencil(T ctr, T xm, T xp, T ym, T yp, T zm,
                                     T zp, T a, const Coef<T>& k) {
  T lap = (xp + xm) * k.cx;
  lap = lap + (yp + ym) * k.cy;
  lap = lap + (zp + zm) * k.cz;
  lap = lap - k.cc * ctr;
  return ctr + a * lap;
}

template <typename Real>
struct Diffusion {
  using T = Real;
  static constexpr int NF = 1;
  const T* src[1];  // T
  const T* A;       // dt*lam/Cp, laid out like T
  Coef<T> k;

  bool aligned(uintptr_t bytes) const {
    return igg::aligned(src[0], bytes) && igg::aligned(A, bytes);
  }

  template <int VEC>
  __device__ __forceinline__ void update(long long row, int z0, long long sx,
                                         int G2, Cells<T, 1, VEC>& out) const {
    using V = Vec<T, VEC>;
    const T* s = src[0] + row;
    const V c = load<T, VEC>(s + z0);
    const V xm = load<T, VEC>(s - sx + z0);
    const V xp = load<T, VEC>(s + sx + z0);
    const V ym = load<T, VEC>(s - G2 + z0);
    const V yp = load<T, VEC>(s + G2 + z0);
    const V a = load<T, VEC>(A + row + z0);
    const T zm = z0 > 0 ? ld(s + z0 - 1) : T(0);
    const T zp = z0 + VEC < G2 ? ld(s + z0 + VEC) : T(0);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      out.f[0].v[v] = stencil(c.v[v], xm.v[v], xp.v[v], ym.v[v], yp.v[v],
                              v == 0 ? zm : c.v[v - 1],
                              v == VEC - 1 ? zp : c.v[v + 1], a.v[v], k);
  }
};

template <typename T>
Diffusion<T> make_diffusion(const void* src, const void* A, double cx,
                            double cy, double cz, double cc) {
  return Diffusion<T>{{static_cast<const T*>(src)},
                      static_cast<const T*>(A),
                      {(T)cx, (T)cy, (T)cz, (T)cc}};
}

}  // namespace igg
