// CKdisc's variable-order cascade, shared by the fused CKdisc kernels
// (fused_ckdisc.cu, one thread per member, and the CK family of
// fused_rk_grid.cu, one block per member): its weight rows and one member's
// step control.  The plain version is ops/fused_ckdisc.py:run_ck_loop.
//
// An attempt of the cascade (extensisq cash.py): stage 2 and the first-order
// assessment E1; where E1 < twiddle0 * quit0 (go2), stages 3-4 and E2; where
// also E2 < twiddle1 * quit1 (go4), stages 5-6 and the 5(4) assessment E4.
// The 5th-order solution is taken when E4 < 1; otherwise the 3rd-order
// fallback (at c = 3/5 of the step) or the 2nd-order one (at c = 1/5) when
// its own error test passes.  The twiddle factors shrink towards E/quit on a
// 5th-order rejection; the quit factors track E1/E4 and E2/E4 on a 5th-order
// acceptance.
//
// Include after the kernel's generated config header: it reads the
// accessors BAS, EAS, BFB, EFB and CFB, and rk_control.cuh its constants.
#pragma once

#include <math.h>

#include "rk_control.cuh"

namespace ck {

constexpr float kSafety = 0.9f;
constexpr float kMaxFactor = 5.0f;
constexpr float kMinFactor = 0.2f;
// a non-finite norm counts as this, so that its attempt rejects
constexpr float kBig = 1e30f;
// the floor of the roots: E2 >= 1e-10, E4 >= 1e-6, so E4 can divide
constexpr float kRootFloor = 1e-30f;
// the independent quotients of Control::update
constexpr int kQuotients = 5;

// Weight rows of the assessments (R = 0: E1 over two stages, 1: E2 over
// four) and of the fallbacks (R = 0: 2nd order, 1: 3rd order), as
// rk_common.cuh's sums read them.
template <int R>
struct RowBas {
  __host__ __device__ static constexpr float w(int j) {
    return tab::BAS(R, j);
  }
};
template <int R>
struct RowEas {
  __host__ __device__ static constexpr float w(int j) {
    return tab::EAS(R, j);
  }
};
template <int R>
struct RowBfb {
  __host__ __device__ static constexpr float w(int j) {
    return tab::BFB(R, j);
  }
};
template <int R>
struct RowEfb {
  __host__ __device__ static constexpr float w(int j) {
    return tab::EFB(R, j);
  }
};

// A norm as the cascade reads it: a non-finite one counts as kBig.
__device__ __forceinline__ float clean(float nm) {
  return isfinite(nm) ? nm : kBig;
}

// The roots of E2 and E4, floored; a norm passes clean() first.
__device__ __forceinline__ float cbrt_floor(float nm) {
  return powf(fmaxf(nm, kRootFloor), 1.0f / 3.0f);
}
__device__ __forceinline__ float p5rt_floor(float nm) {
  return powf(fmaxf(nm, kRootFloor), 0.2f);
}

// One member's step control: rk::StepControl's per-step preparation (step
// limits and the end-of-interval look-ahead split, on fresh steps only) and
// its fresh/rejected bookkeeping, with the cascade's factors in place of
// the explicit pairs' controller.
struct Control : rk::StepControl {
  float tw0 = 1.5f;         // twiddle factors
  float tw1 = 1.1f;
  float q0 = 100.0f;        // quit factors
  float q1 = 100.0f;

  // Whether the attempt goes on past E1 (stages 3-4), and past E2.
  __device__ __forceinline__ bool go2(float E1) const {
    return E1 < tw0 * q0;
  }
  __device__ __forceinline__ bool go4(float E2) const {
    return E2 < tw1 * q1;
  }

  // The quotients of update, independent of each other: E1 / q0, E2 / q1,
  // and kSafety, E1 and E2 over E4 floored at 1e-30; quotient_terms gives
  // the numerator and the denominator of quotient i (a lane group splits
  // them, fused_ckdisc.cu; an i past them gives the third).
  enum Quotient { kE1Q0, kE2Q1, kSafetyE4, kE1E4, kE2E4 };
  __device__ __forceinline__ void quotient_terms(int i, float E1, float E2,
                                                 float E4, float& num,
                                                 float& den) const {
    num = (i == kE1Q0 || i == kE1E4) ? E1
                                     : ((i == kE2Q1 || i == kE2E4) ? E2
                                                                   : kSafety);
    den = i == kE1Q0 ? q0 : (i == kE2Q1 ? q1 : fmaxf(E4, 1e-30f));
  }

  // After the attempt: the next |h| and the twiddle and quit updates.  E2
  // and E4 are kBig where their stages were skipped; fb2_try is whether the
  // 2nd-order fallback was tried.  Each quotient is divided where it is
  // read, as one thread runs it.
  __device__ __forceinline__ void update(float E1, float E2, float E4,
                                         bool go2, bool go4, bool accept4,
                                         bool fb3_ok, bool fb2_try) {
    apply(E4, go2, go4, accept4, fb3_ok, fb2_try, [&](int i) {
      float num, den;
      quotient_terms(i, E1, E2, E4, num, den);
      return num / den;
    });
  }

  // The same with the quotients given (quotient_terms' order).
  __device__ __forceinline__ void update(float E1, float E2, float E4,
                                         bool go2, bool go4, bool accept4,
                                         bool fb3_ok, bool fb2_try,
                                         const float (&qt)[kQuotients]) {
    apply(E4, go2, go4, accept4, fb3_ok, fb2_try,
          [&](int i) { return qt[i]; });
  }

 private:
  template <class Quot>
  __device__ __forceinline__ void apply(float E4, bool go2, bool go4,
                                        bool accept4, bool fb3_ok,
                                        bool fb2_try, const Quot& quot) {
    const float esttol = go4 ? E4 : (go2 ? quot(kE2Q1) : quot(kE1Q0));
    float fac4 = fminf(quot(kSafetyE4), kMaxFactor);
    if (rejected) fac4 = fminf(fac4, 1.0f);
    const float fac_rej =
        fmaxf(go4 ? quot(kSafetyE4) : kSafety / fmaxf(esttol, 1e-30f),
              kMinFactor);
    float h_next =
        accept4 ? h_abs * fac4
                : (fb3_ok ? h_abs * tab::CFB(1)
                          : (fb2_try ? h_abs * tab::CFB(0) : h_abs * fac_rej));
    h_abs = isfinite(h_next) ? h_next : 1.0f;

    if (go4 && !accept4) {  // 5th-order rejection
      const float eq1 = quot(kE1Q0);
      const float eq2 = quot(kE2Q1);
      if (eq1 < tw0) tw0 = fmaxf(eq1, 1.1f);
      if (eq2 < tw1) tw1 = fmaxf(eq2, 1.1f);
    }
    if (accept4) {
      q0 = quit(quot(kE1E4), q0);
      q1 = quit(quot(kE2E4), q1);
    }
  }

  __device__ __forceinline__ static float quit(float qv, float qf) {
    const float q_adj =
        qv > qf ? fminf(qv, 10.0f * qf) : fmaxf(qv, (2.0f / 3.0f) * qf);
    return fminf(fmaxf(q_adj, 1.0f), 10000.0f);
  }
};

}  // namespace ck
