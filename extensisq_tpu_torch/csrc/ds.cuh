// Double-single (hi, lo) float32 arithmetic on the device: the twin of
// extensisq_tpu_torch/ops/ds.py (and of extensisq_tpu/ops/ds.py).
//
// nvcc contracts a*b + c into one fma by default, which would break the
// error-free transformations: two_sum's error term and ds_div's residual
// assume each sum and product was rounded on its own.  Every operation here
// therefore goes through __fadd_rn, __fsub_rn, __fmul_rn or __fdiv_rn, which
// are never contracted.  two_prod's error term is fmaf(a, b, -p): the same
// exact value as Dekker's split of the plain version whenever nothing
// overflows.
#pragma once

#include <math.h>

namespace ds {

struct DS {
  float hi;
  float lo;
};

__device__ __forceinline__ DS lift(float x) { return DS{x, 0.0f}; }

// Knuth's two-sum: s + e == a + b exactly.
__device__ __forceinline__ DS two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return DS{s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

// p + e == a * b exactly.
__device__ __forceinline__ DS two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return DS{p, fmaf(a, b, -p)};
}

__device__ __forceinline__ DS neg(DS a) { return DS{-a.hi, -a.lo}; }

__device__ __forceinline__ DS add(DS a, DS b) {
  const DS s = two_sum(a.hi, b.hi);
  return two_sum(s.hi, __fadd_rn(s.lo, __fadd_rn(a.lo, b.lo)));
}

__device__ __forceinline__ DS add_f(DS a, float x) {
  const DS s = two_sum(a.hi, x);
  return two_sum(s.hi, __fadd_rn(s.lo, a.lo));
}

__device__ __forceinline__ DS mul(DS a, DS b) {
  const DS p = two_prod(a.hi, b.hi);
  const float cross = __fadd_rn(__fmul_rn(a.hi, b.lo), __fmul_rn(a.lo, b.hi));
  return two_sum(p.hi, __fadd_rn(p.lo, cross));
}

__device__ __forceinline__ DS mul_f(DS a, float x) {
  const DS p = two_prod(a.hi, x);
  return two_sum(p.hi, __fadd_rn(p.lo, __fmul_rn(a.lo, x)));
}

// a / b by one Newton correction of the float32 quotient.
__device__ __forceinline__ DS div(DS a, DS b) {
  const float q1 = __fdiv_rn(a.hi, b.hi);
  const DS p = two_prod(q1, b.hi);
  const DS r0 = two_sum(a.hi, -p.hi);
  const float r = __fadd_rn(
      r0.hi, __fsub_rn(__fsub_rn(__fadd_rn(r0.lo, a.lo), p.lo),
                       __fmul_rn(q1, b.lo)));
  return two_sum(q1, __fdiv_rn(r, b.hi));
}

__device__ __forceinline__ float collapse(DS a) {
  return __fadd_rn(a.hi, a.lo);
}

}  // namespace ds
