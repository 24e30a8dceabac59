// The HM3D physics of the step walk (step_walk.cuh): two fields, the
// effective pressure Pe (field 0) and the porosity phi (field 1), updated
// as igg.models.hm3d.step_core updates them:
//   k    = (phi/phi0)^npow                 (repeated multiplication)
//   kf   = 0.5*(k_hi + k_lo)               on each face
//   q    = (-kf * (Pe_hi - Pe_lo)) / d     Darcy flux
//   divq = ((dqx/dx + dqy/dy) + dqz/dz)
//   Pe'  = Pe + dt*(-divq - (Pe*phi)/eta)
//   phi' = phi + dt*(((-phi*(1 - phi))*Pe')/eta)
// Pe' is rounded before phi's update uses it (the Gauss-Seidel coupling).
// Every operation is written out in the order of step_core and of the
// port's plain version; built with -fmad=false and without fast math, so
// each one rounds like the plain PyTorch version (divisions IEEE).
#pragma once

#include "step_walk.cuh"

namespace igg {

template <typename Real>
struct Hm3d {
  using T = Real;
  static constexpr int NF = 2;
  const T* src[2];  // Pe, phi
  T dx, dy, dz, dt, phi0, eta;
  int npow;         // >= 0

  bool aligned(uintptr_t bytes) const {
    return igg::aligned(src[0], bytes) && igg::aligned(src[1], bytes);
  }

  // (phi/phi0)^npow by repeated squaring, the order of XLA's integer_pow:
  // acc takes x at each set bit of npow from the lowest, x squares between.
  __device__ __forceinline__ T perm(T phi) const {
    T x = phi / phi0;
    if (npow == 0) return T(1);
    T acc = x;
    bool have = false;
    for (int y = npow; y > 0;) {
      if (y & 1) {
        acc = have ? acc * x : x;
        have = true;
      }
      y >>= 1;
      if (y > 0) x = x * x;
    }
    return acc;
  }

  // Darcy flux through the face between cells lo and hi along a dim of
  // spacing d.
  __device__ __forceinline__ T flux(T klo, T khi, T plo, T phi_, T d) const {
    const T kf = T(0.5) * (khi + klo);
    return (-kf * (phi_ - plo)) / d;
  }

  // Pe' and phi' of one cell from its centre values and six face fluxes.
  __device__ __forceinline__ void cell(T pe, T ph, T qxl, T qxh, T qyl, T qyh,
                                       T qzl, T qzh, T& pe_out,
                                       T& ph_out) const {
    T divq = (qxh - qxl) / dx;
    divq = divq + (qyh - qyl) / dy;
    divq = divq + (qzh - qzl) / dz;
    const T dpe = dt * (-divq - (pe * ph) / eta);
    const T pe_new = pe + dpe;
    const T dph = dt * (((-ph * (T(1) - ph)) * pe_new) / eta);
    pe_out = pe_new;
    ph_out = ph + dph;
  }

  template <int VEC>
  __device__ __forceinline__ void update(long long row, int z0, long long sx,
                                         int G2, Cells<T, 2, VEC>& out) const {
    using V = Vec<T, VEC>;
    const T* P = src[0] + row;
    const T* F = src[1] + row;
    const V pc = load<T, VEC>(P + z0), fc = load<T, VEC>(F + z0);
    const V pxm = load<T, VEC>(P - sx + z0), fxm = load<T, VEC>(F - sx + z0);
    const V pxp = load<T, VEC>(P + sx + z0), fxp = load<T, VEC>(F + sx + z0);
    const V pym = load<T, VEC>(P - G2 + z0), fym = load<T, VEC>(F - G2 + z0);
    const V pyp = load<T, VEC>(P + G2 + z0), fyp = load<T, VEC>(F + G2 + z0);
    // The z line of the vector and its two neighbours, and its VEC + 1 z
    // faces (each face's flux serves the two cells beside it, as one
    // element of step_core's qz serves two cells).
    T pz[VEC + 2], kz[VEC + 2];
    pz[0] = z0 > 0 ? ld(P + z0 - 1) : T(0);
    kz[0] = perm(z0 > 0 ? ld(F + z0 - 1) : T(0));
    pz[VEC + 1] = z0 + VEC < G2 ? ld(P + z0 + VEC) : T(0);
    kz[VEC + 1] = perm(z0 + VEC < G2 ? ld(F + z0 + VEC) : T(0));
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      pz[v + 1] = pc.v[v];
      kz[v + 1] = perm(fc.v[v]);
    }
    T qz[VEC + 1];
#pragma unroll
    for (int i = 0; i <= VEC; ++i)
      qz[i] = flux(kz[i], kz[i + 1], pz[i], pz[i + 1], dz);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const T kc = kz[v + 1], p = pc.v[v];
      cell(p, fc.v[v], flux(perm(fxm.v[v]), kc, pxm.v[v], p, dx),
           flux(kc, perm(fxp.v[v]), p, pxp.v[v], dx),
           flux(perm(fym.v[v]), kc, pym.v[v], p, dy),
           flux(kc, perm(fyp.v[v]), p, pyp.v[v], dy), qz[v], qz[v + 1],
           out.f[0].v[v], out.f[1].v[v]);
    }
  }
};

// coef: dx dy dz dt phi0 eta, each rounded once to T.
template <typename T>
Hm3d<T> make_hm3d(const void* Pe, const void* phi, const double* coef,
                  int npow) {
  return Hm3d<T>{{static_cast<const T*>(Pe), static_cast<const T*>(phi)},
                 (T)coef[0], (T)coef[1], (T)coef[2], (T)coef[3],
                 (T)coef[4], (T)coef[5], npow};
}

}  // namespace igg
