// Division by a launch constant, bitwise the IEEE quotient `x / d`: the
// Stokes chunk walk (stokes_march.cuh) divides only by the spacings and by
// 3, each fixed for a launch.
//
// It divides by a reciprocal formed on the host and FMA corrections, in
// float32 and float64.  kernel_variants.py times it against `x / d`
// throughout and against a warp-uniform test that sends only zero
// dividends (the IEEE division's range checks take them down its slow
// path) to their signed zero `x * (1/d)`.
//
// Why it rounds like `x / d` (radix 2, precision p = 24 or 53, round to
// nearest even).  The host forms r = RN(1/d) with an IEEE division in the
// type, so |r - 1/d| <= ulp(1/d)/2 <= 2^-p |1/d|, then the remainder
// e = 1 - r d (exact: one FMA) and rl = RN(e r), so that r + rl is 1/d
// within 2^(1-2p) |1/d|.  For the admitted x:
//   q1 = RN(x r + RN(x rl)) (a product and an FMA) is x/d within a
//        relative 2^(2-2p) before its last rounding, so within
//        ulp(x/d)/2 + 2^(3-p) ulp(x/d) < 1 ulp of x/d;
//   Markstein's theorem (as the Handbook of Floating-Point Arithmetic,
//        Muller et al., states it for FMA division, in any precision):
//        when r is within half an ulp of 1/d and q1 within one ulp of x/d,
//        e1 = RN(x - q1 d) (one FMA) is exact and q2 = RN(q1 + e1 r) (one
//        FMA) is RN(x/d).
// Four operations, against the IEEE division's reciprocal approximation,
// Newton steps and range checks.  The theorem assumes no underflow or
// overflow: the path is taken for normal d with 2^-20 <= |d| <= 2^20 and
// dividends with 2^-100 <= |x| < 2^100 in float32 (2^-960 <= |x| < 2^960
// in float64), so that x/d and x r stay normal and the remainder's unit,
// ulp(d) ulp(q1) >= 2^(e_x - 1 - 2(p-1)), stays at or above 2^-147
// (2^-1065), above the smallest subnormal (x rl may fall among
// subnormals: its absolute error is then far below ulp(q1)).  A zero
// dividend of such a d gives its signed zero x * r, bitwise `0 / d`; every
// other x or d takes `x / d`.  The phases' divisors are held to `x / d`
// over all 2^32 float32 dividends on the card
// (chip_smoke.py phase 1, `igg_stokes_div_check`); float64 rests on the
// argument and on sampled checks (tests/test_torch_kernels.py), and every
// kernel check is bitwise against the plain version.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace igg {

// The bits of |x| and the dividend range of the reciprocal path (above).
template <typename T>
struct DivBits;
template <>
struct DivBits<float> {
  using U = unsigned;
  static constexpr U lo = 27u << 23, hi = 227u << 23;  // 2^-100, 2^100
  static constexpr U abs_mask = 0x7fffffffu;
};
template <>
struct DivBits<double> {
  using U = unsigned long long;
  static constexpr U lo = 63ull << 52, hi = 1983ull << 52;  // 2^-960, 2^960
  static constexpr U abs_mask = 0x7fffffffffffffffull;
};

template <typename T>
struct ConstDiv {
  using U = typename DivBits<T>::U;
  T d;       // the divisor
  T r;       // RN(1/d), formed on the host
  T rl;      // RN((1 - r d) r): r + rl is 1/d to twice the precision
  U lo;      // |x| bits in [lo, lo + span) take the reciprocal path
  U span;    // 0 where d does not admit it
  int fast;  // 1: d admits the reciprocal path
};

template <typename T>
inline ConstDiv<T> make_div(T d) {
  using B = DivBits<T>;
  const T r = T(1) / d;
  const T a = std::fabs(d);
  const bool fast = std::isnormal(d) && a >= T(0x1p-20) && a <= T(0x1p+20);
  const T rl = std::fma(-r, d, T(1)) * r;
  return ConstDiv<T>{d, r, rl, B::lo, fast ? B::hi - B::lo : 0,
                     fast ? 1 : 0};
}


__device__ __forceinline__ unsigned div_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long div_bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}
__device__ __forceinline__ float div_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double div_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The reciprocal path alone (valid where `div_admits`).
template <typename T>
__device__ __forceinline__ T div_fast(T x, const ConstDiv<T>& q) {
  const T y = div_fma(x, q.r, x * q.rl);
  return div_fma(div_fma(-y, q.d, x), q.r, y);
}

template <typename T>
__device__ __forceinline__ bool div_admits(T x, const ConstDiv<T>& q) {
  return (div_bits(x) & DivBits<T>::abs_mask) - q.lo < q.span;
}

// x / d: the reciprocal path where it admits x; else (rare) a zero of an
// admitted d takes its signed zero x * r, every other x or d `x / d`.
template <typename T>
__device__ __forceinline__ T cdiv(T x, const ConstDiv<T>& q) {
  if (div_admits(x, q)) return div_fast(x, q);
  return q.fast && x == T(0) ? x * q.r : x / q.d;
}

// A batch of divisions, each on the reciprocal path; `ok` clears when a
// dividend lies outside its range, and the caller then forms the batch's
// quotients again with cdiv.  So the common case tests its range with
// one branch a batch, not one a division.
template <typename T>
struct DivBatch {
  bool ok = true;
  __device__ __forceinline__ T operator()(T x, const ConstDiv<T>& q) {
    ok = ok & div_admits(x, q);
    return div_fast(x, q);
  }
};

}  // namespace igg
