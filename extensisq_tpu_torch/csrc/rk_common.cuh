// Device helpers shared by the fused Runge-Kutta kernels (fused_erk.cu,
// fused_esdirk.cu): the double-single arithmetic of the compensated mode,
// unrolled weighted sums with compile-time weights, NaN-keeping max/min and
// the RMS norm.
//
// FMA contraction: nvcc contracts a*b + c into one fma by default.  That is
// harmless in the plain sums, but it breaks the compensated mode: the error
// term that two_sum captures, and the Neumaier compensation of comp_wsum,
// assume every product and sum was rounded on its own.  These helpers
// therefore use __fadd_rn, __fsub_rn and __fmul_rn, which are never
// contracted; the kernels keep the default contraction elsewhere.
#pragma once

#include <math.h>

namespace rk {

// Knuth's two-sum: s + e == a + b exactly, for IEEE-rounded adds.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  const float ss = __fadd_rn(a, b);
  const float bb = __fsub_rn(ss, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(ss, bb)), __fsub_rn(b, bb));
  s = ss;
}

// (hi, lo) + x, double-single accumulate.
__device__ __forceinline__ void df_add(float hi, float lo, float x,
                                       float& out_hi, float& out_lo) {
  float s, e;
  two_sum(hi, x, s, e);
  two_sum(s, __fadd_rn(lo, e), out_hi, out_lo);
}

// A weight row W provides `static constexpr float w(int j)`; it is called
// only in constant expressions, so every weight is a compile-time constant
// of the device code and zero weights drop out of the unrolled sums.
template <class W>
__host__ __device__ constexpr int first_nonzero(int len) {
  for (int j = 0; j < len; ++j) {
    if (W::w(j) != 0.0f) return j;
  }
  return len;
}

// acc += w_j * K[j] for j in [J, LEN), zero weights dropped.
template <class W, int LEN, int J, int N, class Rows>
__device__ __forceinline__ void wsum_tail(float (&acc)[N], const Rows& K) {
  if constexpr (J < LEN) {
    constexpr float w = W::w(J);
    if constexpr (w != 0.0f) {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = acc[k] + w * K[J][k];
    }
    wsum_tail<W, LEN, J + 1>(acc, K);
  }
}

// acc = sum_{j < LEN} w_j * K[j], summed in order from the first nonzero
// weight (the order of the JAX kernels' sums); 0 when every weight is 0.
template <class W, int LEN, int N, class Rows>
__device__ __forceinline__ void wsum(float (&acc)[N], const Rows& K) {
  constexpr int F = first_nonzero<W>(LEN);
  if constexpr (F == LEN) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.0f;
  } else {
    constexpr float w = W::w(F);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = w * K[F][k];
    wsum_tail<W, LEN, F + 1>(acc, K);
  }
}

// Neumaier-compensated tail: products rounded on their own (__fmul_rn), so
// a contracted fma cannot make the captured error term wrong.
template <class W, int LEN, int J, int N, class Rows>
__device__ __forceinline__ void comp_tail(float (&acc)[N], float (&comp)[N],
                                          const Rows& K) {
  if constexpr (J < LEN) {
    constexpr float w = W::w(J);
    if constexpr (w != 0.0f) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float e;
        two_sum(acc[k], __fmul_rn(w, K[J][k]), acc[k], e);
        comp[k] = __fadd_rn(comp[k], e);
      }
    }
    comp_tail<W, LEN, J + 1>(acc, comp, K);
  }
}

// (sum, compensation) of sum_{j < LEN} w_j * K[j], as the JAX _comp_wsum.
template <class W, int LEN, int N, class Rows>
__device__ __forceinline__ void comp_wsum(float (&acc)[N], float (&comp)[N],
                                          const Rows& K) {
  constexpr int F = first_nonzero<W>(LEN);
#pragma unroll
  for (int k = 0; k < N; ++k) comp[k] = 0.0f;
  if constexpr (F == LEN) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.0f;
  } else {
    constexpr float w = W::w(F);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = __fmul_rn(w, K[F][k]);
    comp_tail<W, LEN, F + 1>(acc, comp, K);
  }
}

// max and min that keep a NaN, as torch.maximum and torch.minimum do (fmaxf
// and fminf drop it): the starting step and the step preparation use them,
// so that a member whose f(t0) is not finite starts as in the plain
// versions.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// RMS over the state, one member.
template <int N>
__device__ __forceinline__ float rms(const float (&x)[N]) {
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) sq = sq + x[k] * x[k];
  return sqrtf(sq / static_cast<float>(N));
}

}  // namespace rk
