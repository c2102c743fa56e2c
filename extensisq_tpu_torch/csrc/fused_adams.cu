// Fused SWAG ensemble solver for Hopper (sm_90a): the whole variable-order
// Adams-Bashforth-Moulton PECE integration of each member in one launch.
//
// Replaces extensisq_tpu/ops/fused_adams.py:solve_fused_adams, the Pallas
// kernel (its body `kernel`/`body`, with _adams_common.make_coefficients).
// Its plain PyTorch version is extensisq_tpu_torch/ops/fused_adams.py:
// fused_adams_reference; the two take the same steps up to round-off.
//
// Design: one thread per ensemble member.  The member's multistep state (the
// scaled divided differences phi[KM+2][N], the coefficient vectors
// psi/alpha/beta/v/w[KM], sig/g[KM+1], the iv pointers, y, y_lo, yp) lives in
// registers for the whole integration; the thread reads device memory once
// at the start (its y0, f(t0, y0), starting step and nfev, computed by the
// float32 stepper's init as in the JAX package) and writes once at the end.
//
// The order k and the count ns differ per member and change at run time,
// so phi[k], g[k], sig[k-1] and gstr[k-2] are run-time indices.  Every such
// take/put walks the static bound with a select (adams_common.cuh), so no
// array leaves registers; where the JAX masks pick one branch per member
// (accepted or rejected, ns == 1 or not, near-end extrapolation), the thread
// branches, and computes only the side it takes.
//
// What bounds it on the H100: each attempt is a chain of several hundred
// dependent f32 operations (the coefficient recurrences are O(KM^2) with
// selects), two RHS evaluations and no memory traffic, so a thread is
// latency-bound and throughput comes from members in flight.  Registers are
// the scarce resource: the carry is about (KM + 2) N + 7 KM + 20 floats,
// ~150 at KM = 12 and N = 2, before temporaries; the build prints
// registers and spills (-Xptxas -v).  A warp runs until its slowest member
// ends, and members of one warp at different orders run each other's
// branches masked.
//
// The order, the state size, the Adams constants and the user's right-hand
// side come from the generated header fused_adams_config.cuh:
//   namespace tab { KM, N, INV_N, FOURU_T, LAND_TOL, GSTR(i), IQQ(i),
//                   TWO(i) }
//   __device__ void rhs(float t, const float* y, float* dy);  (or the
//   template rhs<T>, instantiated here as rhs<float>)
//
// Numerics (by line of the Pallas body, extensisq_tpu/ops/fused_adams.py):
//  * time in double-single in both modes (:410, :622), the 4 2^-30 |t|
//    minimum step (:181, :411), the remainder in double-single (:413) and
//    the landing test |rem| <= 8 eps32 |h| on it (:629-633);
//  * compensated mode: Neumaier sum of g phi in the predictor (:456-468)
//    and the whole step increment in the (hi, lo) carry of y (:554-566),
//    with rk_common.cuh's uncontracted two_sum/df_add; phi stays float32;
//  * powf where the JAX kernel takes exp(log x / (k + 1)) (:614-616), real
//    selects where it blends, isfinite where it scrubs bits;
//  * FMA contraction stays on elsewhere, as in the other fused kernels;
//  * a non-finite error estimate rejects the attempt (:518-525); a member
//    whose starting state or step is not finite, or whose accepted step
//    gives a non-finite y or f, ends with status 3 (the JAX kernel scrubs
//    those values to 1 and runs on);
//  * max_steps counts the member's loop iterations, accepted plus rejected
//    (the JAX hit_cap, :652), giving status 3.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_adams_config.cuh"
#include "adams_common.cuh"
#include "rk_common.cuh"

namespace {

using tab::KM;
using tab::N;
using adams::clip;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;
constexpr int R = KM + 2;  // rows of phi

// A float32 constant table entry tab::X(i) for a run-time i in [0, LEN).
template <int LEN, class Table>
__device__ __forceinline__ float ctake(Table table, int i) {
  float v = table(0);
#pragma unroll
  for (int r = 1; r < LEN; ++r) v = (i == r) ? table(r) : v;
  return v;
}

// phi[i][j] for a run-time row i.
__device__ __forceinline__ float row_take(const float (&phi)[R][N], int i,
                                          int j) {
  float v = phi[0][j];
#pragma unroll
  for (int r = 1; r < R; ++r) v = (i == r) ? phi[r][j] : v;
  return v;
}

__device__ __forceinline__ void row_put(float (&phi)[R][N], int i, int j,
                                        float val) {
#pragma unroll
  for (int r = 0; r < R; ++r) phi[r][j] = (i == r) ? val : phi[r][j];
}

// RMS over the state in the JAX kernel's order: squares summed in row
// order, times 1/N.
__device__ __forceinline__ float member_norm(const float (&x)[N]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) acc = acc + x[j] * x[j];
  return sqrtf(acc * tab::INV_N);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

template <int LEN>
__device__ __forceinline__ bool all_finite(const float (&x)[LEN]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < LEN; ++j) ok = ok && isfinite(x[j]);
  return ok;
}

// The tables as function objects, so that ctake's calls fold to literals.
struct Gstr {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::GSTR(i);
  }
};
struct Two {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::TWO(i);
  }
};

template <bool COMP>
__global__ void fused_adams_kernel(
    const float* __restrict__ y0, const float* __restrict__ yp0,
    const float* __restrict__ h0, const int* __restrict__ nfev0,
    float* __restrict__ y_out, int* __restrict__ status_out,
    int* __restrict__ nstep_out, int* __restrict__ nfev_out, int B, float t0,
    float tf, float dir, float rtol, float atol, float max_step,
    int max_steps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B) return;  // ragged last block: no member padding

  // the starting state (steppers/adams.py:init)
  float y[N], y_lo[N], yp[N];
  float phi[R][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    y[j] = y0[static_cast<size_t>(idx) * N + j];
    yp[j] = yp0[static_cast<size_t>(idx) * N + j];
    y_lo[j] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < N; ++j) phi[r][j] = r == 0 ? yp[j] : 0.0f;
  }
  adams::Coef<KM> c;
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    c.psi[r] = c.alpha[r] = c.beta[r] = c.v[r] = c.w[r] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r <= KM; ++r) {
    c.sig[r] = r == 0 ? 1.0f : 0.0f;
    c.g[r] = r == 0 ? 1.0f : (r == 1 ? 0.5f : 0.0f);
  }
#pragma unroll
  for (int r = 0; r < adams::Coef<KM>::NGI; ++r) c.gi[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < adams::Coef<KM>::NIV; ++r) c.iv[r] = 0;
  c.ivc = 0;
  c.kgi = 0;

  float t = t0;
  float t_lo = 0.0f;
  float h = h0[idx];
  float hold = 0.0f;
  int k = 1;
  int kold = 0;
  int kprev = 0;
  int ns = 0;
  int ifail = 0;
  bool phase1 = true;
  bool fresh = true;
  int nsteps = 0;
  int nfev = nfev0[idx];
  int status = (all_finite(y) && all_finite(yp) && isfinite(h)) ? kRunning
                                                                  : kOverflow;
  int it = 0;

  while (status == kRunning && it < max_steps) {
    const float tc = t + t_lo;  // double-single time carry
    const float min_step = tab::FOURU_T * fabsf(tc);
    const float d = (tf - t) - t_lo;  // remaining interval in DS
    it += 1;
    if (fabsf(d) <= min_step) {
      // near-end linear extrapolation (shampine.py:209-217); counts as a
      // step, evaluates nothing
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (COMP) {
          rk::df_add(y[j], y_lo[j], d * yp[j], y[j], y_lo[j]);
        } else {
          y[j] = y[j] + d * yp[j];
        }
      }
      t = tf;
      t_lo = 0.0f;
      nsteps += 1;
      status = kFinished;
      break;
    }

    // fresh steps: clamp h toward tf and max_step
    float h_in = h;
    if (fresh) {
      float hc = dir * (h - d) > 0.0f ? d : h;
      h_in = sgn(hc) * fminf(fabsf(hc), max_step);
      ifail = 0;
    }
    int ns2 = h_in != hold ? 0 : ns;
    if (ns2 <= kold) ns2 += 1;
    adams::coefficients<KM>(c, h_in, k, ns2, kprev, kold);
    const int km1 = k - 1;
    const int km2 = k - 2;

    // block 2: predict; phi[r] *= beta[r] for r in [ns, k)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= ns2 && r < k) {
        const float b = c.beta[r < KM ? r : KM - 1];
#pragma unroll
        for (int j = 0; j < N; ++j) phi[r][j] = phi[r][j] * b;
      }
    }
    float p[N], pred_s[N], pred_c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      row_put(phi, k + 1, j, row_take(phi, k, j));
      row_put(phi, k, j, 0.0f);
      float acc = 0.0f;
      if constexpr (COMP) {
        float comp = 0.0f;
#pragma unroll
        for (int r = 0; r <= KM; ++r) {
          const float gw = r < k ? c.g[r] : 0.0f;
          float e;
          rk::two_sum(acc, __fmul_rn(gw, phi[r][j]), acc, e);
          comp = __fadd_rn(comp, e);
        }
        pred_s[j] = h_in * acc;
        pred_c[j] = h_in * comp;
        p[j] = y[j] + (pred_s[j] + (pred_c[j] + y_lo[j]));
      } else {
#pragma unroll
        for (int r = 0; r <= KM; ++r) {
          const float gw = r < k ? c.g[r] : 0.0f;
          acc = acc + gw * phi[r][j];
        }
        p[j] = h_in * acc + y[j];
      }
      // reverse cumulative sum over rows < k
      float run = 0.0f;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        if (r < k) {
          run = run + phi[r][j];
          phi[r][j] = run;
        }
      }
    }

    const float x = tc + h_in;
    float yp_pred[N];
    rhs(x, p, yp_pred);
    nfev += 1;

    float wtn[N], temp4[N], e0[N], e1[N], e2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      wtn[j] = atol + rtol * 0.5f * (fabsf(p[j]) + fabsf(y[j]));
      const float inv_wt = 1.0f / wtn[j];
      temp4[j] = yp_pred[j] - phi[0][j];
      e0[j] = temp4[j] * inv_wt;
      e1[j] = (row_take(phi, clip(km1, 0, R - 1), j) + temp4[j]) * inv_wt;
      e2[j] = (row_take(phi, clip(km2, 0, R - 1), j) + temp4[j]) * inv_wt;
    }
    const float absh = fabsf(h_in);
    float erk = absh * member_norm(e0);
    const float erkm1 = absh * member_norm(e1) *
                        adams::take(c.sig, clip(km1, 0, KM)) *
                        ctake<13>(Gstr{}, clip(km2, 0, 12));
    const float erkm2 = absh * member_norm(e2) *
                        adams::take(c.sig, clip(km2, 0, KM)) *
                        ctake<13>(Gstr{}, clip(km2 - 1, 0, 12));
    float err = erk * (adams::take(c.g, clip(km1, 0, KM)) -
                       adams::take(c.g, clip(k, 0, KM)));
    erk = erk * adams::take(c.sig, clip(k, 0, KM)) *
          ctake<13>(Gstr{}, clip(km1, 0, 12));
    const bool bad_e = !isfinite(err);
    if (bad_e) err = 11.0f;
    // max(erkm1, erkm2) < erk, false where either is NaN (torch.maximum)
    const int knew = (k > 2 && erkm1 < erk && erkm2 < erk)
                         ? km1
                         : ((k == 2 && erkm1 < 0.5f * erk) ? km1 : k);
    const bool success = err <= 1.0f && !bad_e;

    if (success) {
      // block 4: correct and evaluate
      const float g_k = adams::take(c.g, clip(k, 0, KM));
      float yc[N], yc_lo[N], ypn[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (COMP) {
          // the whole step increment in double-single
          float s1, e, hi, lo1;
          rk::two_sum(pred_s[j], h_in * g_k * temp4[j], s1, e);
          const float lo = e + pred_c[j];
          rk::df_add(y[j], y_lo[j], s1, hi, lo1);
          rk::two_sum(hi, lo1 + lo, yc[j], yc_lo[j]);
        } else {
          yc[j] = h_in * g_k * temp4[j] + p[j];
          yc_lo[j] = y_lo[j];
        }
      }
      rhs(x, yc, ypn);
      nfev += 1;
      if (!all_finite(yc) || !all_finite(ypn)) {
        status = kOverflow;
        break;
      }

      // phi update
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float pkn = ypn[j] - phi[0][j];
        row_put(phi, k, j, pkn);
        row_put(phi, k + 1, j, pkn - row_take(phi, k + 1, j));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < k) phi[r][j] = phi[r][j] + pkn;
        }
      }

      // order selection for the next step (shampine.py:420-455)
      const bool ph1 = phase1 && !(knew == km1 || k == KM);
      float q[N];
#pragma unroll
      for (int j = 0; j < N; ++j) q[j] = row_take(phi, k + 1, j) / wtn[j];
      const float erkp1 =
          ctake<13>(Gstr{}, clip(k, 0, 12)) * absh * member_norm(q);
      const bool can_est = !ph1 && knew != km1 && k < ns2;
      const bool raise1 = k == 1 && erkp1 < 0.5f * erk && k < KM;
      const bool lower = k != 1 && erkm1 <= erk && erkm1 <= erkp1;
      const bool raise2 = k != 1 && !lower && !(erkp1 > erk || k == KM);
      int k_next = k;
      float erk_next = erk;
      if (ph1) {
        k_next = k + 1;
        erk_next = erkp1;
      } else if (knew == km1) {
        k_next = km1;
        erk_next = erkm1;
      } else if (can_est && raise1) {
        k_next = k + 1;
        erk_next = erkp1;
      } else if (can_est && lower) {
        k_next = km1;
        erk_next = erkm1;
      } else if (can_est && raise2) {
        k_next = k + 1;
        erk_next = erkp1;
      }
      const float two_next = ctake<KM + 2>(Two{}, clip(k_next, 0, KM + 1));
      const bool dbl = ph1 || 0.5f >= erk_next * two_next;
      const bool keep_h = 0.5f >= erk_next;
      const float rr =
          powf(fmaxf(0.5f / fmaxf(erk_next, 1e-30f), 1e-30f),
               1.0f / static_cast<float>(k_next + 1));
      float h_red = absh * fminf(fmaxf(rr, 0.5f), 0.9f);
      h_red = sgn(h_in) * fmaxf(h_red, min_step);
      const float h_next = dbl ? h_in + h_in : (keep_h ? h_in : h_red);

      // double-single t advance; the landing test uses the remainder
      float t_adv, t_lo_adv;
      rk::df_add(t, t_lo, h_in, t_adv, t_lo_adv);
      const float rem = (tf - t_adv) - t_lo_adv;
      const bool is_last = fabsf(rem) <= tab::LAND_TOL * fabsf(h_in);
      t = is_last ? tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[j] = yc[j];
        y_lo[j] = yc_lo[j];
        yp[j] = ypn[j];
      }
      h = isfinite(h_next) ? h_next : 1.0f;
      hold = h_in;
      kold = k;
      kprev = k;
      k = k_next;
      ns = ns2;
      phase1 = ph1;
      fresh = true;
      ifail = 0;
      nsteps += 1;
      if (is_last) status = kFinished;
    } else {
      // block 3: failure restore (shampine.py:369-398)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < k) {
          const float b = c.beta[r < KM ? r : KM - 1];
          const float bsafe = b == 0.0f ? 1.0f : b;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float up = phi[r + 1 < R ? r + 1 : R - 1][j];
            phi[r][j] = (phi[r][j] - up) / bsafe;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < KM; ++r) {
        if (r < km1) c.psi[r] = c.psi[r + 1 < KM ? r + 1 : KM - 1] - h_in;
      }
      const int ifail2 = ifail + 1;
      const float temp2 = (ifail2 >= 4 && 0.5f < 0.25f * erk)
                              ? sqrtf(0.5f / fmaxf(erk, 1e-30f))
                              : 0.5f;
      const float h_fail = h_in * temp2;
      if (fabsf(h_fail) < min_step) status = kTooSmall;
      h = isfinite(h_fail) ? h_fail : 1.0f;
      kprev = k;
      k = ifail2 >= 3 ? 1 : knew;
      ns = 0;
      phase1 = false;
      fresh = false;
      ifail = ifail2;
    }
    if (status == kRunning && it >= max_steps) status = kOverflow;
  }

#pragma unroll
  for (int j = 0; j < N; ++j) y_out[static_cast<size_t>(idx) * N + j] = y[j];
  status_out[idx] = status;
  nstep_out[idx] = nsteps;
  nfev_out[idx] = nfev;
}

}  // namespace

// Launches one thread per member on the caller's stream and returns
// cudaGetLastError(); the wrapper raises on anything but 0.  yp0, h0 and
// nfev0 are each member's f(t0, y0), starting step and evaluation count
// from the float32 stepper's init.
extern "C" int fused_adams_launch(const void* y0, const void* yp0,
                                  const void* h0, const void* nfev0,
                                  void* y_out, void* status, void* nstep,
                                  void* nfev, int B, float t0, float tf,
                                  float dir, float rtol, float atol,
                                  float max_step, int max_steps,
                                  int compensated, int threads,
                                  void* stream) {
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  const float* yp0f = static_cast<const float*>(yp0);
  const float* h0f = static_cast<const float*>(h0);
  const int* nf0 = static_cast<const int*>(nfev0);
  float* yf = static_cast<float*>(y_out);
  int* st = static_cast<int*>(status);
  int* ns = static_cast<int*>(nstep);
  int* nf = static_cast<int*>(nfev);
  if (compensated) {
    fused_adams_kernel<true><<<blocks, threads, 0, s>>>(
        y0f, yp0f, h0f, nf0, yf, st, ns, nf, B, t0, tf, dir, rtol, atol,
        max_step, max_steps);
  } else {
    fused_adams_kernel<false><<<blocks, threads, 0, s>>>(
        y0f, yp0f, h0f, nf0, yf, st, ns, nf, B, t0, tf, dir, rtol, atol,
        max_step, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
