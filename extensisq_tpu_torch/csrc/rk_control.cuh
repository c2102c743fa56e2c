// One member's step-size control in the fused explicit loops (fused_erk.cu,
// fused_rkn.cu, fused_rk_grid.cu): the per-step preparation (step limits
// and the end-of-interval look-ahead split, applied on fresh steps only) and
// the float32 accept/reject controller of core/controller.py:
// erk_accept_update.  Their plain version is ops/fused_erk.py:fresh_step
// and controller.
//
// Include after the kernel's generated config header: it reads tab::H_MIN_A,
// TINY_ERR and the controller constants SAFETY, SAFETY_SC, MINBETA1,
// MINBETA2, MINALPHA, ERROR_EXPONENT and MIN_FACTOR.
#pragma once

#include <math.h>

namespace rk {

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
    const float ms = fmaxf(tab::H_MIN_A * (fabsf(t) + h_abs), tab::TINY_ERR);
    const float h_pre = fminf(fmaxf(h_abs, ms), max_step);
    d = fabsf(tf - t);
    const bool split = (d < 2.0f * h_pre) && (d > h_pre);
    if (fresh) {
      h_abs = split ? fmaxf(0.5f * d, ms) : (d <= h_pre ? d : h_pre);
      min_step = ms;
    }
    std_b = std_sc || (fresh && split);
    too_small = h_abs < min_step;
  }

  // The next |h| after an attempt of step h with error norm err_norm, and on
  // acceptance the controller's memory.
  __device__ __forceinline__ void update(float err_norm, float h,
                                         bool accepted) {
    const float err_c = fmaxf(err_norm, 1e-30f);
    const float f_std = tab::SAFETY * powf(err_c, tab::ERROR_EXPONENT);
    const float hr = h / (h_prev == 0.0f ? h : h_prev);
    const float f_2nd = fminf(
        fmaxf(tab::SAFETY_SC * powf(err_c, tab::MINBETA1) *
                  powf(fmaxf(err_old, 1e-30f), tab::MINBETA2) *
                  powf(hr, tab::MINALPHA),
              tab::MIN_FACTOR),
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
