// The stokes3d physics of the 3-D staggered walk (stagger_walk3.cuh): the
// pressure P (field 0) and the face velocities Vx (field 1, one cell longer
// in x), Vy (field 2, in y) and Vz (field 3, in z), with the constant
// buoyancy Rho laid out like P, updated as
// igg_torch.models.stokes3d.iteration_core updates every block:
//   gx = (Vx[i+1] - Vx[i]) / dx, gy, gz alike      at every cell
//   divV = ((gx + gy) + gz),  P' = P - dtP*divV     at every cell
//   txx = c2mu * (gx - divV/3), tyy, tzz alike      (c2mu = 2.0*mu)
//   txy = mu * ((Vx[J] - Vx[J-1])/dy + (Vy[I] - Vy[I-1])/dx)  interior edges
//   txz = mu * ((Vx[K] - Vx[K-1])/dz + (Vz[I] - Vz[I-1])/dx)
//   tyz = mu * ((Vy[K] - Vy[K-1])/dz + (Vz[J] - Vz[J-1])/dy)
//   rx = (((txx[I] - txx[I-1])/dx + (txy[J+1] - txy[J])/dy)
//         + (txz[K+1] - txz[K])/dz) - (P'[I] - P'[I-1])/dx,  ry, rz alike,
//   rz = rz + 0.5*(Rho[K] + Rho[K-1])
//   V' = V + dtV*r on each velocity's interior faces, V + 0 elsewhere.
// Each coefficient is rounded once to T; every operation is written out in
// the order of the plain version, built with -fmad=false and without fast
// math, so each one rounds like the plain PyTorch version (divisions IEEE).
// A quotient the plain version forms twice from the same operands (gx in
// divV and in txx) is formed once: the same operands give the same bits.
//
// `cells` computes a run of VEC cells along z: the VEC+1 cells k-1 .. k+VEC-1
// of its own row, the VEC cells of the rows at x-1 and y-1 (whose normal
// stresses and pressures the face residuals read), the shear stresses of
// its edges, each of them once: 38*VEC + 8 divisions a run.  Loads outside
// the block are skipped (their values are zeros, used by no interior face),
// so every read stays inside the block; all divisions are by the spacings
// or by 3, so the zeros are harmless.
#pragma once

#include "stagger_walk3.cuh"

namespace igg {

template <typename Real>
struct Stokes {
  using T = Real;
  static constexpr int NF = 4;
  const T* src[4];  // P, Vx, Vy, Vz
  const T* rho;     // Rho, laid out like P
  T dx, dy, dz, mu, c2mu, dtP, dtV;

  // Vx is staggered along dim 0, Vy along 1, Vz along 2.
  __host__ __device__ static constexpr int st(int f, int d) {
    return f == d + 1 ? 1 : 0;
  }
  // On open dims the velocities freeze; the pressure does not.
  __host__ __device__ static constexpr bool freezes(int f, int) {
    return f >= 1;
  }

  // x / d, an IEEE division: every division of the update is by a spacing
  // or by 3.
  __device__ __forceinline__ T quot(T x, T d) const { return x / d; }

  // (a - b) / d, the difference quotient, each operation rounded.
  __device__ __forceinline__ T dq(T a, T b, T d) const {
    return quot(a - b, d);
  }

  // p[0 .. N-1] from the N elements at q, VEC of them from q + lead (one
  // vector load where aligned), the others one by one; elements whose flag
  // is off are zero.
  template <int VEC, int N>
  __device__ __forceinline__ static void span(const T* q, int lead, bool lo,
                                              bool hi, T* p) {
#pragma unroll
    for (int m = 0; m < N; ++m) p[m] = T(0);
    load_run<T, VEC>(q + lead, p + lead);
    if (lead == 1 && lo) p[0] = ld(q);
    if (N > lead + VEC && hi) p[N - 1] = ld(q + N - 1);
  }

  template <int VEC>
  __device__ __forceinline__ void cells(const Stag3& g, int i, int j, int k,
                                        const long long* at,
                                        const long long* sx,
                                        const long long* sy,
                                        T (*out)[VEC]) const {
    constexpr int W = VEC + 1;  // cells k-1 .. k+VEC-1, index m+1 <-> k+m
    const int s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
    const bool rvx = i >= 1 && i <= s0 - 1 && j >= 1 && j <= s1 - 2;
    const bool rvy = i >= 1 && i <= s0 - 2 && j >= 1 && j <= s1 - 1;
    const bool rvz = i >= 1 && i <= s0 - 2 && j >= 1 && j <= s1 - 2;
    const bool zlo = k >= 1, zhi = k + VEC <= s2 - 1;
    const T* P = src[0] + at[0];
    const T* X = src[1] + at[1];
    const T* Y = src[2] + at[2];
    const T* Z = src[3] + at[3];
    const T* R = rho + at[0];
    const long long px = sx[0], py = sy[0], xx = sx[1], xy = sy[1];
    const long long yx = sx[2], yy = sy[2], zx = sx[3], zy = sy[3];

    // The cells k-1 .. k+VEC-1 of the row (i, j): pressure, quotients,
    // divergence, new pressure and normal stresses.
    T vx[W + 1], vx1[W], vy[W + 1], vy1[W], vz[W + 1], p[W], r[W];
    span<VEC, W + 1>(X - 1, 1, zlo, zhi, vx);
    span<VEC, W>(X + xx - 1, 1, zlo, false, vx1);
    span<VEC, W + 1>(Y - 1, 1, zlo, zhi, vy);
    span<VEC, W>(Y + yy - 1, 1, zlo, false, vy1);
    span<VEC, W + 1>(Z - 1, 1, zlo, true, vz);
    span<VEC, W>(P - 1, 1, zlo, false, p);
    span<VEC, W>(R - 1, 1, zlo, false, r);
    T gx[W], gy[W], d3[W], pn[W], tzz[W];
#pragma unroll
    for (int m = 0; m < W; ++m) {
      gx[m] = dq(vx1[m], vx[m], dx);
      gy[m] = dq(vy1[m], vy[m], dy);
      const T gz = dq(vz[m + 1], vz[m], dz);
      const T div = (gx[m] + gy[m]) + gz;
      pn[m] = p[m] - dtP * div;
      d3[m] = quot(div, T(3));
      tzz[m] = c2mu * (gz - d3[m]);
    }
#pragma unroll
    for (int m = 0; m < VEC; ++m) {
      out[0][m] = pn[m + 1];
      out[1][m] = vx[m + 1] + T(0);
      out[2][m] = vy[m + 1] + T(0);
      out[3][m] = vz[m + 1] + T(0);
    }
    if (!(rvx || rvy || rvz)) return;

    // The cells of the rows (i-1, j) and (i, j-1): their pressures and the
    // normal stress across the shared face.
    T xm[VEC], ym1[VEC], ym0[VEC], zm[VEC + 1], pxm[VEC];
    T xym[VEC], x1ym[VEC], yym[VEC], zym[VEC + 1], pym[VEC];
    load_run<T, VEC>(X - xx, xm);
    load_run<T, VEC>(Y - yx, ym0);
    load_run<T, VEC>(Y - yx + yy, ym1);
    span<VEC, VEC + 1>(Z - zx, 0, false, true, zm);
    load_run<T, VEC>(P - px, pxm);
    load_run<T, VEC>(X - xy, xym);
    load_run<T, VEC>(X + xx - xy, x1ym);
    load_run<T, VEC>(Y - yy, yym);
    span<VEC, VEC + 1>(Z - zy, 0, false, true, zym);
    load_run<T, VEC>(P - py, pym);
    T txx[VEC], txxm[VEC], tyy[VEC], tyym[VEC], pnxm[VEC], pnym[VEC];
#pragma unroll
    for (int m = 0; m < VEC; ++m) {
      txx[m] = c2mu * (gx[m + 1] - d3[m + 1]);
      tyy[m] = c2mu * (gy[m + 1] - d3[m + 1]);
      {  // cell (i-1, j, k+m)
        const T ax = dq(vx[m + 1], xm[m], dx);
        const T ay = dq(ym1[m], ym0[m], dy);
        const T az = dq(zm[m + 1], zm[m], dz);
        const T d = (ax + ay) + az;
        pnxm[m] = pxm[m] - dtP * d;
        txxm[m] = c2mu * (ax - quot(d, T(3)));
      }
      {  // cell (i, j-1, k+m)
        const T ax = dq(x1ym[m], xym[m], dx);
        const T ay = dq(vy[m + 1], yym[m], dy);
        const T az = dq(zym[m + 1], zym[m], dz);
        const T d = (ax + ay) + az;
        pnym[m] = pym[m] - dtP * d;
        tyym[m] = c2mu * (ay - quot(d, T(3)));
      }
    }

    // Shear stresses: txy at (i, j), txz at (i, j, k .. k+VEC), tyz alike.
    T txy[VEC], txz[W], tyz[W];
#pragma unroll
    for (int m = 0; m < VEC; ++m)
      txy[m] = mu * (dq(vx[m + 1], xym[m], dy) + dq(vy[m + 1], ym0[m], dx));
#pragma unroll
    for (int m = 0; m < W; ++m) {
      txz[m] = mu * (dq(vx[m + 1], vx[m], dz) + dq(vz[m + 1], zm[m], dx));
      tyz[m] = mu * (dq(vy[m + 1], vy[m], dz) + dq(vz[m + 1], zym[m], dy));
    }

    if (rvx) {  // Vx at face (i, j, k+m): also txy at (i, j+1)
      T xyp[VEC];
      load_run<T, VEC>(X + xy, xyp);
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        if (k + m < 1 || k + m > s2 - 2) continue;
        const T txyp =
            mu * (dq(xyp[m], vx[m + 1], dy) + dq(vy1[m + 1], ym1[m], dx));
        const T rx = ((dq(txx[m], txxm[m], dx) + dq(txyp, txy[m], dy)) +
                      dq(txz[m + 1], txz[m], dz)) -
                     dq(pn[m + 1], pnxm[m], dx);
        out[1][m] = vx[m + 1] + dtV * rx;
      }
    }
    if (rvy) {  // Vy at face (i, j, k+m): also txy at (i+1, j)
      T yxp[VEC];
      load_run<T, VEC>(Y + yx, yxp);
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        if (k + m < 1 || k + m > s2 - 2) continue;
        const T txyp =
            mu * (dq(vx1[m + 1], x1ym[m], dy) + dq(yxp[m], vy[m + 1], dx));
        const T ry = ((dq(tyy[m], tyym[m], dy) + dq(txyp, txy[m], dx)) +
                      dq(tyz[m + 1], tyz[m], dz)) -
                     dq(pn[m + 1], pnym[m], dy);
        out[2][m] = vy[m + 1] + dtV * ry;
      }
    }
    if (rvz) {  // Vz at face (i, j, k+m): txz at (i+1, j), tyz at (i, j+1)
      T zxp[VEC], zyp[VEC];
      load_run<T, VEC>(Z + zx, zxp);
      load_run<T, VEC>(Z + zy, zyp);
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        if (k + m < 1 || k + m > s2 - 1) continue;
        const T txzp =
            mu * (dq(vx1[m + 1], vx1[m], dz) + dq(zxp[m], vz[m + 1], dx));
        const T tyzp =
            mu * (dq(vy1[m + 1], vy1[m], dz) + dq(zyp[m], vz[m + 1], dy));
        T rz = ((dq(tzz[m + 1], tzz[m], dz) + dq(txzp, txz[m], dx)) +
                dq(tyzp, tyz[m], dy)) -
               dq(pn[m + 1], pn[m], dz);
        rz = rz + T(0.5) * (r[m + 1] + r[m]);
        out[3][m] = vz[m + 1] + dtV * rz;
      }
    }
  }
};

// Launch the walk with the Stokes policy on src (P, Vx, Vy, Vz) and the
// constant rho into out, with the chunk-entry buffers F (none for a step);
// coef: dx dy dz mu 2*mu dtP dtV, each rounded once to T; dtype: 0 float32,
// 1 float64.
// The policy on src (P, Vx, Vy, Vz) and rho; coef: dx dy dz mu 2*mu dtP
// dtV, each rounded once to T.
template <typename T>
Stokes<T> make_stokes(void* const* src, const void* rho, const double* coef) {
  return Stokes<T>{{static_cast<const T*>(src[0]),
                    static_cast<const T*>(src[1]),
                    static_cast<const T*>(src[2]),
                    static_cast<const T*>(src[3])},
                   static_cast<const T*>(rho),
                   (T)coef[0], (T)coef[1], (T)coef[2], (T)coef[3],
                   (T)coef[4], (T)coef[5], (T)coef[6]};
}

// The four fields' pointers, read-only (the chunk-entry buffers; none when
// F is null) or written (the targets).
template <typename T>
Fields<const T, 4> stokes_entry(void* const* F) {
  if (F == nullptr) return Fields<const T, 4>{};
  return Fields<const T, 4>{{static_cast<const T*>(F[0]),
                             static_cast<const T*>(F[1]),
                             static_cast<const T*>(F[2]),
                             static_cast<const T*>(F[3])}};
}
template <typename T>
Fields<T, 4> stokes_out(void* const* out) {
  return Fields<T, 4>{{static_cast<T*>(out[0]), static_cast<T*>(out[1]),
                       static_cast<T*>(out[2]), static_cast<T*>(out[3])}};
}

template <typename T>
int launch_stokes_as(void* const* src, const void* rho, void* const* F,
                     void* const* out, const Stag3& g, const double* coef,
                     cudaStream_t stream) {
  return launch_stagger3(make_stokes<T>(src, rho, coef), g,
                         stokes_entry<T>(F), stokes_out<T>(out), stream);
}

inline int launch_stokes(void* const* src, const void* rho, void* const* F,
                         void* const* out, int dtype, const Stag3& g,
                         const double* coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stokes_as<float>(src, rho, F, out, g, coef, st);
  if (dtype == 1)
    return launch_stokes_as<double>(src, rho, F, out, g, coef, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace igg
