// The stokes3d fields' layout on the 3-D staggered walk's Stag3
// (stagger_walk3.cuh): the pressure P (field 0) and the face velocities Vx
// (field 1, one cell longer in x), Vy (field 2, in y) and Vz (field 3, in
// z), with the constant buoyancy Rho laid out like P, updated as
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
// math, so each one rounds like the plain PyTorch version.  The kernels:
// stokes_step.cu (the fused iteration) and stokes_march.cuh (the chunk and
// band steps), which take the staggers and freezes from here.  The first
// designs' update of a run of cells on the walk (`cells`) is kept as text
// in kernel_variants.py.
#pragma once

#include "stagger_walk3.cuh"

namespace igg {

template <typename Real>
struct Stokes {
  using T = Real;
  static constexpr int NF = 4;

  // Vx is staggered along dim 0, Vy along 1, Vz along 2.
  __host__ __device__ static constexpr int st(int f, int d) {
    return f == d + 1 ? 1 : 0;
  }
  // On open dims the velocities freeze; the pressure does not.
  __host__ __device__ static constexpr bool freezes(int f, int) {
    return f >= 1;
  }
};

}  // namespace igg
