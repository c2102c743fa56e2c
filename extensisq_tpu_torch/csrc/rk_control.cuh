// One member's step-size control in the fused explicit loops (fused_erk.cu,
// fused_rkn.cu, fused_rk_grid.cu): the per-step preparation (step limits
// and the end-of-interval look-ahead split, applied on fresh steps only) and
// the float32 accept/reject controller of core/controller.py:
// erk_accept_update.  Their plain version is ops/fused_erk.py:fresh_step
// and controller; the preparation keeps a NaN step, as fresh_step does.
//
// Include after the kernel's generated config header: it reads tab::H_MIN_A,
// TINY_ERR and the controller constants SAFETY, SAFETY_SC, MINBETA1,
// MINBETA2, MINALPHA, ERROR_EXPONENT and MIN_FACTOR.
#pragma once

#include <math.h>

#include "rk_common.cuh"

namespace rk {

// The exponent of the controller's power q (StepControl::pow_base).
__host__ __device__ constexpr float pow_exponent(int q) {
  return q == 0 ? tab::ERROR_EXPONENT
                : (q == 1 ? tab::MINBETA1
                          : (q == 2 ? tab::MINBETA2 : tab::MINALPHA));
}

// Whether the controller's power q is left to compute: a zero exponent
// gives 1, and the error's power to MINBETA1 is its first where MINBETA1 =
// ERROR_EXPONENT (nvcc folds both out of StepControl::update's powf).
// kPowers of them are left, the p-th being power_index(p).
__host__ __device__ constexpr bool pow_left(int q) {
  return pow_exponent(q) != 0.0f &&
         !(q == 1 && tab::MINBETA1 == tab::ERROR_EXPONENT);
}
constexpr int kPowers = int(pow_left(0)) + int(pow_left(1)) +
                        int(pow_left(2)) + int(pow_left(3));
__host__ __device__ constexpr int power_index(int p) {
  int q = 0;
  for (; q < 4; ++q) {
    if (pow_left(q) && p-- == 0) break;
  }
  return q;
}

struct StepControl {
  float h_abs;             // |h| carried to the next attempt
  float min_step = 0.0f;
  float err_old = 1.0f;
  float h_prev = 0.0f;     // signed h of the last accepted step
  float max_fac = 10.0f;
  bool std_sc = true;      // the standard controller on the next step
  bool fresh = true;       // the next attempt starts a new step
  bool rejected = false;   // some attempt of this step was rejected
  bool std_b = false;      // the standard controller on this attempt

  // This attempt's |h| (in h_abs) at time t; d = |tf - t|.
  __device__ __forceinline__ void prepare(float t, float tf, float max_step,
                                          float& d, bool& too_small) {
    const float ms =
        nan_max(tab::H_MIN_A * (fabsf(t) + h_abs), tab::TINY_ERR);
    const float h_pre = nan_min(nan_max(h_abs, ms), max_step);
    d = fabsf(tf - t);
    const bool split = (d < 2.0f * h_pre) && (d > h_pre);
    if (fresh) {
      h_abs = split ? nan_max(0.5f * d, ms) : (d <= h_pre ? d : h_pre);
      min_step = ms;
    }
    std_b = std_sc || (fresh && split);
    too_small = h_abs < min_step;
  }

  // The controller's four powers after an attempt of step h with error
  // norm err_norm are pow_base(q) ** pow_exponent(q), q < 4: the error's to
  // ERROR_EXPONENT and MINBETA1, the last accepted error's to MINBETA2 and
  // the step ratio's to MINALPHA (a lane group splits them).
  __device__ __forceinline__ float pow_base(int q, float err_norm,
                                            float h) const {
    const float hr = h / (h_prev == 0.0f ? h : h_prev);
    return q == 2 ? fmaxf(err_old, 1e-30f)
                  : (q == 3 ? hr : fmaxf(err_norm, 1e-30f));
  }
  // The next |h| after an attempt of step h with error norm err_norm, and on
  // acceptance the controller's memory.
  // The powers keep their exponents as literals here: written as a loop
  // over pow_base/pow_exponent they gave the same bits, but the controller
  // took 398 cycles an attempt on vdp with BS5 against 285.
  __device__ __forceinline__ void update(float err_norm, float h,
                                         bool accepted) {
    const float err_c = fmaxf(err_norm, 1e-30f);
    const float hr = h / (h_prev == 0.0f ? h : h_prev);
    const float pw[4] = {powf(err_c, tab::ERROR_EXPONENT),
                         powf(err_c, tab::MINBETA1),
                         powf(fmaxf(err_old, 1e-30f), tab::MINBETA2),
                         powf(hr, tab::MINALPHA)};
    update(err_norm, h, accepted, pw);
  }

  // The same with the four powers given.
  __device__ __forceinline__ void update(float err_norm, float h,
                                         bool accepted,
                                         const float (&pw)[4]) {
    const float f_std = tab::SAFETY * pw[0];
    const float f_2nd = fminf(
        fmaxf(tab::SAFETY_SC * pw[1] * pw[2] * pw[3], tab::MIN_FACTOR),
        max_fac);
    const bool is_tiny = err_norm < tab::TINY_ERR;
    float fac_acc = is_tiny ? max_fac : (std_b ? f_std : f_2nd);
    if (rejected) fac_acc = fminf(1.0f, fac_acc);
    const float fac_rej = fmaxf(tab::MIN_FACTOR, f_std);
    if (accepted) {
      std_sc = is_tiny;
      err_old = err_norm;
      h_prev = h;
      max_fac = fac_acc < 4.0f ? 4.0f : max_fac;
    }
    h_abs = h_abs * (accepted ? fac_acc : fac_rej);
  }

  // After the attempt's status is known: whether the next attempt starts a
  // new step.
  __device__ __forceinline__ void end(bool accepted, bool running) {
    fresh = accepted || !running;
    rejected = !accepted;
  }
};

}  // namespace rk
