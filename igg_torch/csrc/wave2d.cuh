// The wave2d physics of the staggered walk (stagger_walk.cuh): the pressure
// P (field 0) and the face velocities Vx (field 1, one cell longer in x)
// and Vy (field 2, one cell longer in y), updated as
// igg_torch.models.wave2d.block_compute updates every block:
//   Vx' = Vx + ((c1 * (P[i] - P[i-1])) / dx)    interior x faces 1 .. s0-1
//   Vy' = Vy + ((c1 * (P[j] - P[j-1])) / dy)    interior y faces 1 .. s1-1
//   P'  = P - (c2 * (((Vx'[i+1] - Vx'[i]) / dx) + ((Vy'[j+1] - Vy'[j]) / dy)))
// on every cell, with c1 = -dt/rho and c2 = dt*bulk rounded once to T; the
// outer faces add an exact +0 (igg's interior_add).  `cells` forms each face
// of a run once; `cell`, for the cells of a block's edges and wrap aliases,
// recomputes the four faces a P cell reads.  Offsets come from the walk;
// the faces' guards keep every P read inside the block.  Every operation is written out in
// the order of the plain version; built with -fmad=false and without fast
// math, so each one rounds like the plain PyTorch version (divisions
// IEEE).
#pragma once

#include "stagger_walk.cuh"

namespace igg {

template <typename Real>
struct Wave2d {
  using T = Real;
  static constexpr int NF = 3;
  const T* src[3];  // P, Vx, Vy
  T c1, c2, dx, dy;

  // Vx is staggered along dim 0, Vy along dim 1.
  __host__ __device__ static constexpr int st(int f, int d) {
    return f == d + 1 ? 1 : 0;
  }
  // Periodic grids only: nothing re-freezes.
  __host__ __device__ static constexpr bool freezes(int, int) { return false; }

  // Vx' at face i (source-local) whose Vx offset is ax, with the P cell
  // (i, j) at offset ap and P's row stride sp.
  __device__ __forceinline__ T face_x(const Stag& g, int i, long long ax,
                                      long long ap, long long sp) const {
    const T v = ld(src[1] + ax);
    if (i < 1 || i > g.s[0] - 1) return v + T(0);
    return v + ((c1 * (ld(src[0] + ap) - ld(src[0] + ap - sp))) / dx);
  }

  // Vy' at face j (source-local) whose Vy offset is ay, with the P cell
  // (i, j) at offset ap.
  __device__ __forceinline__ T face_y(const Stag& g, int j, long long ay,
                                      long long ap) const {
    const T v = ld(src[2] + ay);
    if (j < 1 || j > g.s[1] - 1) return v + T(0);
    return v + ((c1 * (ld(src[0] + ap) - ld(src[0] + ap - 1))) / dy);
  }

  __device__ __forceinline__ void cell(const Stag& g, int i, int j,
                                       const long long* at,
                                       const long long* row, const bool* want,
                                       T* out) const {
    const long long ap = at[0], sp = row[0];
    if (want[0] || want[1]) out[1] = face_x(g, i, at[1], ap, sp);
    if (want[0] || want[2]) out[2] = face_y(g, j, at[2], ap);
    if (want[0]) {
      const T vxh = face_x(g, i + 1, at[1] + row[1], ap + sp, sp);
      const T vyh = face_y(g, j + 1, at[2] + 1, ap + 1);
      out[0] = ld(src[0] + ap) -
               (c2 * (((vxh - out[1]) / dx) + ((vyh - out[2]) / dy)));
    }
  }

  // All three fields at the VEC cells (i, j .. j+VEC-1) of a block, which
  // every field has: the VEC+1 y faces and 2*VEC x faces they read, each
  // once.  P's neighbour rows and edge columns are read only where a face
  // is interior, so every read stays inside the block.
  template <int VEC>
  __device__ __forceinline__ void cells(const Stag& g, int i, int j,
                                        const long long* at,
                                        const long long* row,
                                        T (*out)[VEC]) const {
    const T* P = src[0] + at[0];
    const long long sp = row[0];
    T pc[VEC + 2], pm[VEC], pp[VEC], vx0[VEC], vx1[VEC], vy[VEC + 1];
    load_run<T, VEC>(P, pc + 1);
    pc[0] = j >= 1 ? ld(P - 1) : T(0);
    pc[VEC + 1] = j + VEC <= g.s[1] - 1 ? ld(P + VEC) : T(0);
    const bool xlo = i >= 1 && i <= g.s[0] - 1;
    const bool xhi = i + 1 <= g.s[0] - 1;
    if (xlo) load_run<T, VEC>(P - sp, pm);
    if (xhi) load_run<T, VEC>(P + sp, pp);
    load_run<T, VEC>(src[1] + at[1], vx0);
    load_run<T, VEC>(src[1] + at[1] + row[1], vx1);
#pragma unroll
    for (int k = 0; k <= VEC; ++k) vy[k] = ld(src[2] + at[2] + k);
    T fy[VEC + 1];
#pragma unroll
    for (int k = 0; k <= VEC; ++k)
      fy[k] = j + k >= 1 && j + k <= g.s[1] - 1
                  ? vy[k] + ((c1 * (pc[k + 1] - pc[k])) / dy)
                  : vy[k] + T(0);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const T fx0 = xlo ? vx0[k] + ((c1 * (pc[k + 1] - pm[k])) / dx)
                        : vx0[k] + T(0);
      const T fx1 = xhi ? vx1[k] + ((c1 * (pp[k] - pc[k + 1])) / dx)
                        : vx1[k] + T(0);
      out[0][k] = pc[k + 1] -
                  (c2 * (((fx1 - fx0) / dx) + ((fy[k + 1] - fy[k]) / dy)));
      out[1][k] = fx0;
      out[2][k] = fy[k];
    }
  }
};

// Launch the walk with the wave2d policy on src (P, Vx, Vy) into out;
// coef: c1 = -dt/rho, c2 = dt*bulk, dx, dy; dtype: 0 float32, 1 float64.
template <typename T>
int launch_wave2d_as(void* const* src, void* const* out, const Stag& g,
                     const double* coef, cudaStream_t stream) {
  const Wave2d<T> ph{{static_cast<const T*>(src[0]),
                      static_cast<const T*>(src[1]),
                      static_cast<const T*>(src[2])},
                     (T)coef[0], (T)coef[1], (T)coef[2], (T)coef[3]};
  return launch_stagger(ph, g, Fields<const T, 3>{{ph.src[0], ph.src[1],
                                                   ph.src[2]}},
                        Fields<T, 3>{{static_cast<T*>(out[0]),
                                      static_cast<T*>(out[1]),
                                      static_cast<T*>(out[2])}},
                        stream);
}

inline int launch_wave2d(void* const* src, void* const* out, int dtype,
                         const Stag& g, const double* coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_wave2d_as<float>(src, out, g, coef, st);
  if (dtype == 1) return launch_wave2d_as<double>(src, out, g, coef, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace igg
