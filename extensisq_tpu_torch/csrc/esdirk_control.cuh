// The implicit step control shared by the fused ESDIRK kernels
// (fused_esdirk.cu, one thread per member, and fused_esdirk_grid.cu, one
// thread block per member): extensisq's modified-Newton convergence tests
// (common.py:2183-2232) and the implicit controller
// (core/controller.py:esdirk_accept_update) in float32, as the plain
// version ops/fused_esdirk.py:run_esdirk_loop runs them.  Every thread of a
// block holds the same scalars, so the whole block takes the same branches.
//
// Include after the kernel's generated config header: it reads the
// tableau accessors tab::A(i, j), AZ(i, j), E(j), and tab::KAPPA,
// NEWTON_MAXITER, the controller constants and H_MIN_A, H_MIN_B,
// MAX_FACTOR0.
#pragma once

#include <math.h>

namespace esdirk {

// The tableau's weight rows as rk_common.cuh's sums read them.
template <int I>
struct RowA {
  __host__ __device__ static constexpr float w(int j) { return tab::A(I, j); }
};
template <int I>
struct RowAz {
  __host__ __device__ static constexpr float w(int j) { return tab::AZ(I, j); }
};
struct RowE {
  __host__ __device__ static constexpr float w(int j) { return tab::E(j); }
};

// The Newton iteration of one stage: the convergence rate and the last
// update's norm.
struct Newton {
  float rate = -1.0f;  // < 0: not yet measured
  float dz_old = 0.0f;

  // After iteration `it` (from 0) with the scaled update norm dz_norm:
  // `conv` says whether the iterate counts as converged, and the return
  // value whether the iteration stops here (a non-finite value, `bad`,
  // stops it too).
  __device__ __forceinline__ bool test(int it, float dz_norm, float tiny_err,
                                       bool bad, bool& conv) {
    const bool tiny_ok = dz_norm <= tiny_err;
    bool diverged = false;
    bool conv_normal = false;
    if (it > 0) {
      if (rate < 0.0f || dz_old > tab::KAPPA) {
        rate = fmaxf(rate, dz_norm / fmaxf(dz_old, 1e-30f));
      }
      float rp = 1.0f;
      for (int r = it; r < tab::NEWTON_MAXITER; ++r) rp = rp * rate;
      diverged = rate >= 1.0f || dz_norm * rp >= tab::KAPPA * (1.0f - rate);
      conv_normal =
          dz_norm * rate < tab::KAPPA * (1.0f - rate) && !diverged;
    }
    conv = tiny_ok || conv_normal;
    dz_old = dz_norm;
    return bad || tiny_ok || diverged || conv_normal;
  }
};

// The step control of one member.
struct Control {
  float h_abs;
  bool std_sc = true;
  bool rejected = false;
  float err_old = 1.0f;
  float h_prev = 0.0f;
  float max_fac = tab::MAX_FACTOR0;
  // set by prepare() for the attempt
  float ha = 0.0f;
  float min_step = 0.0f;
  bool std_b = false;
  bool too_small = false;

  // The step-size limits and the landing on tf, every attempt: |h| of the
  // attempt in ha (max_step is +inf when the caller gave none).
  __device__ __forceinline__ void prepare(float t, float t_lo, float tf,
                                          float max_step) {
    const float tc = t + t_lo;
    min_step = fmaxf(tab::H_MIN_A * (fabsf(tc) + h_abs), tab::H_MIN_B);
    const bool out_rng = h_abs < min_step || h_abs > max_step;
    ha = fminf(fmaxf(min_step, h_abs), max_step);
    std_b = std_sc || out_rng;
    const float d = fabsf((tf - t) - t_lo);
    if (fabsf(d / ha - 1.0f) < 1e-2f || d < ha) ha = d;
    too_small = ha < min_step;
  }

  // The controller's four powers after an attempt of step h with error
  // norm err_norm are pow_base(q) ** pow_exponent(q), q < 4: the error's
  // to ERROR_EXPONENT and MINBETA1, the last accepted error's to MINBETA2
  // and the step ratio's to MINALPHA (a lane group splits them).
  __device__ __forceinline__ float pow_base(int q, float err_norm,
                                            float h) const {
    const float hr = h / (h_prev == 0.0f ? h : h_prev);
    return q == 2 ? fmaxf(err_old, 1e-30f)
                  : (q == 3 ? fmaxf(fabsf(hr), 1e-30f)
                            : fmaxf(err_norm, 1e-30f));
  }
  __device__ static __forceinline__ float pow_exponent(int q) {
    return q == 0 ? tab::ERROR_EXPONENT
                  : (q == 1 ? tab::MINBETA1
                            : (q == 2 ? tab::MINBETA2 : tab::MINALPHA));
  }

  // After the attempt of step h (= ha with its sign): the next |h| from the
  // error norm, the stages' largest Newton rate and whether they all
  // converged; a rejected attempt whose reduced step falls below min_step
  // sets too_small, which ends the member instead of clamping it back up.
  __device__ __forceinline__ void finish(float err_norm, float rate,
                                         bool conv, bool accepted, float h,
                                         float tiny_err) {
    float pw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pw[q] = powf(pow_base(q, err_norm, h), pow_exponent(q));
    }
    finish(err_norm, rate, conv, accepted, h, tiny_err, pw);
  }

  // The same with the four powers given.
  __device__ __forceinline__ void finish(float err_norm, float rate,
                                         bool conv, bool accepted, float h,
                                         float tiny_err,
                                         const float (&pw)[4]) {
    const float f_pow = tab::SAFETY * pw[0];
    const float f_std = fminf(f_pow, max_fac);
    const float f_2nd = fminf(
        fmaxf(tab::SAFETY_SC * pw[1] * pw[2] * pw[3], tab::MIN_FACTOR),
        max_fac);
    const bool is_tiny = err_norm < tiny_err;
    float fac_acc = is_tiny ? max_fac : (std_b ? f_std : f_2nd);
    const bool on_scale = max_fac == tab::MAX_FACTOR;
    bool std_after = is_tiny || (std_b && on_scale ? false : std_sc);
    if (rejected) {
      fac_acc = fminf(1.0f, fac_acc);
      std_after = true;
    }
    const float max_fac_new =
        fac_acc < tab::MAX_FACTOR ? tab::MAX_FACTOR : max_fac;
    const float f_rej = fmaxf(tab::MIN_FACTOR, f_pow);
    // convergence failure: the rate-based reduction
    const float f_nrf = fminf(
        fmaxf(rate > 0.0f ? tab::MAX_RATE / fmaxf(rate, 1e-30f)
                          : tab::MIN_FACTOR,
              tab::MIN_FACTOR),
        tab::MAX_FACTOR_NRF);
    float next = ha * (accepted ? fac_acc : (conv ? f_rej : f_nrf));
    if (!isfinite(next)) next = 1.0f;
    too_small = too_small || (!accepted && next < min_step);
    if (accepted) {
      std_sc = std_after;
      err_old = err_norm;
      h_prev = h;
      max_fac = max_fac_new;
    } else {
      std_sc = true;
    }
    h_abs = next;
    rejected = !accepted && (rejected || !too_small);
  }
};

}  // namespace esdirk
