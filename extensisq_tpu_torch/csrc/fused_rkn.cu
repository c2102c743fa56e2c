// Fused adaptive Runge-Kutta-Nystrom ensemble solver for Hopper (sm_90a).
//
// Replaces extensisq_tpu/ops/fused_rkn.py:solve_fused_rkn, the Pallas kernel
// that runs a whole adaptive integration of a second-order ensemble
// (_run_rkn_loop) per launch, with the in-kernel Watts start on the
// first-order form [v, acc].  Its plain PyTorch version is
// extensisq_tpu_torch/ops/fused_rkn.py:fused_rkn_reference; the two take the
// same steps up to round-off.
//
// Design: one thread per ensemble member, as fused_erk.cu.  Each thread
// holds u, v, their lo parts, the carried acceleration f and the stage
// accelerations K[S+1][M] in registers and runs its own adaptive loop
// (stages with h^2 A and h Ap weights, the combined [u, v] error norm, the
// controller, the end landing) until its status leaves RUNNING.  A member
// reads device memory once at the start and writes once at the end.
//
// What bounds it on the H100: as B1, each member is a long chain of
// dependent f32 operations (stages, powf in the controller), so a thread's
// time is latency-bound and the card's throughput comes from the number of
// members in flight: blocks of 128 threads, 2048 Kepler members give 16
// blocks (an eighth of the 132 SMs), 262,144 give 2048.  Registers grow
// with M (Fi5N keeps 7 stage rows of M accelerations); the build prints
// -Xptxas -v, and chip_smoke.py reports it for M = 2 and M = 14.  A warp
// runs until its slowest member ends.
//
// The tableau (float32, rounded as the JAX kernel rounds it; E and Ep as the
// tableau has them, without the stepper's Mu5Nmb damping) and the user's
// acceleration come from the generated header fused_rkn_config.cuh:
//   namespace tab { M, S, FSAL, MORDER, A(i, j), AP(i, j), B(j), BP(j),
//                   C(i), E(j), EP(j), controller and start constants }
//   template <class T> __device__ void acc(T t, const T* u, const T* v,
//                                          T* a);
// Weights are compile-time constants, so zero weights drop out of the
// unrolled sums (rk_common.cuh); the step control is rk_control.cuh's.
//
// Numerics, as in fused_erk.cu: the compensated helpers round every
// operation on its own (__f*_rn), the rest may contract to fma; no fast
// math; a non-finite error norm, u_new, v_new or FSAL acceleration ends the
// member with status 3; max_steps counts attempts.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_rkn_config.cuh"
#include "rk_common.cuh"

namespace {

using tab::M;
using tab::S;
constexpr int N = 2 * M;                    // the first-order state [u, v]
constexpr int MM = S + (tab::FSAL ? 1 : 0);  // rows of the error estimate
constexpr int kThreads = 128;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;

// The first-order form [v, acc(t, u, v)], the starting step's RHS.
__device__ __forceinline__ void rhs(float t, const float* y, float* dy) {
#pragma unroll
  for (int k = 0; k < M; ++k) dy[k] = y[M + k];
  acc(t, y, y + M, dy + M);
}

}  // namespace

#include "hstart.cuh"
#include "rk_control.cuh"
#include "rk_rows.cuh"

namespace {

using rk::RowA;
using rk::RowAp;
using rk::RowB;
using rk::RowBp;
using rk::RowE;
using rk::RowEp;
using Stages = float[S + 1][M];

// Stages I..S-1 of one attempt; K[0] holds acc(t, u, v).
template <bool COMP, int I>
__device__ __forceinline__ void stages(float t, float h, float hh,
                                       const float (&u)[M],
                                       const float (&u_lo)[M],
                                       const float (&v)[M],
                                       const float (&v_lo)[M], Stages& K) {
  if constexpr (I < S) {
    float wa[M], wp[M], au[M], av[M];
    rk::wsum<RowA<I>, I>(wa, K);
    rk::wsum<RowAp<I>, I>(wp, K);
    constexpr float c = tab::C(I);
    const float ch = c * h;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float du = hh * wa[k] + ch * v[k];
      float dv = h * wp[k];
      if constexpr (COMP) {
        du = du + u_lo[k];
        dv = dv + v_lo[k];
      }
      au[k] = u[k] + du;
      av[k] = v[k] + dv;
    }
    acc(t + ch, au, av, K[I]);
    stages<COMP, I + 1>(t, h, hh, u, u_lo, v, v_lo, K);
  }
}

template <bool COMP>
__global__ void __launch_bounds__(kThreads)
    fused_rkn_kernel(const float* __restrict__ y0, float* __restrict__ y_out,
                     int* __restrict__ status_out, int* __restrict__ nstep_out,
                     int* __restrict__ nfev_out, int B, float t0, float tf,
                     float rtol, float atol, float h0, int use_hstart,
                     float max_step, int max_steps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B) return;  // ragged last block: no member padding

  float u[M], v[M], u_lo[M], v_lo[M], f[M];
  Stages K;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    u[k] = y0[static_cast<size_t>(idx) * N + k];
    v[k] = y0[static_cast<size_t>(idx) * N + M + k];
    u_lo[k] = 0.0f;
    v_lo[k] = 0.0f;
  }
  const float span = tf - t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  float t = t0;
  float t_lo = 0.0f;
  acc(t, u, v, f);
  rk::StepControl ctl{h0};
  int nfev = 1;
  if (use_hstart) {
    float y[N], yp[N];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      y[k] = u[k];
      y[M + k] = v[k];
      yp[k] = v[k];
      yp[M + k] = f[k];
    }
    // max_step is +inf when the caller gave none
    const float bq = t + dir * fminf(fabsf(tf - t), max_step);
    ctl.h_abs = fabsf(rk::hstart<N, tab::MORDER>(t, bq, y, yp, rtol, atol));
    nfev = 2 + (N + 1 < 3 ? N + 1 : 3);
  }

  int status = kRunning;
  int nstep = 0;
  int it = 0;

  while (status == kRunning) {
    float d;
    bool too_small;
    ctl.prepare(t, tf, max_step, d, too_small);
    const float h = ctl.h_abs * dir;
    const float hh = h * h;

    // stages, solution and error estimate
#pragma unroll
    for (int k = 0; k < M; ++k) K[0][k] = f[k];
    stages<COMP, 1>(t, h, hh, u, u_lo, v, v_lo, K);
    float u_new[M], v_new[M], u_lo_new[M], v_lo_new[M];
    float err_u[M], err_v[M];
    if constexpr (COMP) {
      float bs[M], bc[M], ps[M], pc[M];
      rk::comp_wsum<RowB, S>(bs, bc, K);
      rk::comp_wsum<RowBp, S>(ps, pc, K);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        float hi, l1, l2;
        rk::df_add(u[k], u_lo[k], __fmul_rn(h, v[k]), hi, l1);
        rk::two_sum(hi, __fadd_rn(l1, __fmul_rn(hh, bs[k])), hi, l2);
        rk::two_sum(hi, __fadd_rn(l2, __fmul_rn(hh, bc[k])), u_new[k],
                    u_lo_new[k]);
        rk::df_add(v[k], v_lo[k], __fmul_rn(h, ps[k]), hi, l1);
        rk::two_sum(hi, __fadd_rn(l1, __fmul_rn(h, pc[k])), v_new[k],
                    v_lo_new[k]);
      }
    } else {
      float bs[M], ps[M];
      rk::wsum<RowB, S>(bs, K);
      rk::wsum<RowBp, S>(ps, K);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        u_new[k] = u[k] + h * v[k] + hh * bs[k];
        v_new[k] = v[k] + h * ps[k];
        u_lo_new[k] = u_lo[k];
        v_lo_new[k] = v_lo[k];
      }
    }
    if constexpr (tab::FSAL) acc(t + h, u_new, v_new, K[S]);
    if constexpr (COMP) {
      float es[M], ec[M], eps[M], epc[M];
      rk::comp_wsum<RowE, MM>(es, ec, K);
      rk::comp_wsum<RowEp, MM>(eps, epc, K);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        err_u[k] = hh * (es[k] + ec[k]);
        err_v[k] = h * (eps[k] + epc[k]);
      }
    } else {
      float es[M], eps[M];
      rk::wsum<RowE, MM>(es, K);
      rk::wsum<RowEp, MM>(eps, K);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        err_u[k] = hh * es[k];
        err_v[k] = h * eps[k];
      }
    }
    // the RMS of [err_u, err_v] over the 2M states
    float sq = 0.0f;
    bool finite = true;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float q =
          err_u[k] / (atol + rtol * fmaxf(fabsf(u[k]), fabsf(u_new[k])));
      sq = sq + q * q;
      finite = finite && isfinite(u_new[k]) && isfinite(v_new[k]);
      if constexpr (tab::FSAL) finite = finite && isfinite(K[S][k]);
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float q =
          err_v[k] / (atol + rtol * fmaxf(fabsf(v[k]), fabsf(v_new[k])));
      sq = sq + q * q;
    }
    const float err_norm = sqrtf(sq / static_cast<float>(N));
    // overflow: NaN/Inf anywhere ends this member with status 3
    const bool bad = !(finite && isfinite(err_norm));
    const bool accepted = err_norm < 1.0f && !too_small && !bad;

    if (too_small) {
      status = kTooSmall;
    } else if (bad) {
      status = kOverflow;
    }

    // exact landing: the look-ahead clamps h_abs <= d, with equality only
    // on the last step, which then lands on tf exactly
    const bool is_last = accepted && ctl.h_abs >= d;
    ctl.update(err_norm, h, accepted);
    float t_new, t_lo_new;
    if constexpr (COMP) {
      float t_adv, t_lo_adv;
      rk::df_add(t, t_lo, h, t_adv, t_lo_adv);
      t_new = is_last ? tf : t_adv;
      t_lo_new = is_last ? 0.0f : t_lo_adv;
    } else {
      t_new = is_last ? tf : t + h;
      t_lo_new = t_lo;
    }
    if (status == kRunning && is_last) status = kFinished;

    nfev += tab::FSAL ? S : S - 1;
    if (accepted) {
      if constexpr (tab::FSAL) {
#pragma unroll
        for (int k = 0; k < M; ++k) f[k] = K[S][k];
      } else {
        // a non-FSAL pair evaluates the endpoint of accepted steps only
        acc(t_new, u_new, v_new, f);
        nfev += 1;
      }
#pragma unroll
      for (int k = 0; k < M; ++k) {
        u[k] = u_new[k];
        v[k] = v_new[k];
        u_lo[k] = u_lo_new[k];
        v_lo[k] = v_lo_new[k];
      }
      t = t_new;
      t_lo = t_lo_new;
      nstep += 1;
    }

    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (it >= max_steps && status == kRunning) status = kOverflow;
    ctl.end(accepted, status == kRunning);
  }

#pragma unroll
  for (int k = 0; k < M; ++k) {
    y_out[static_cast<size_t>(idx) * N + k] = u[k];
    y_out[static_cast<size_t>(idx) * N + M + k] = v[k];
  }
  status_out[idx] = status;
  nstep_out[idx] = nstep;
  nfev_out[idx] = nfev;
}

}  // namespace

// Launches one thread per member, in blocks of kThreads, on the caller's
// stream and returns cudaGetLastError(); the wrapper raises on anything but
// 0.
extern "C" int fused_rkn_launch(const void* y0, void* y_out, void* status,
                                void* nstep, void* nfev, int B, float t0,
                                float tf, float rtol, float atol, float h0,
                                int use_hstart, float max_step, int max_steps,
                                int compensated, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  float* yf = static_cast<float*>(y_out);
  int* st = static_cast<int*>(status);
  int* ns = static_cast<int*>(nstep);
  int* nf = static_cast<int*>(nfev);
  if (compensated) {
    fused_rkn_kernel<true><<<blocks, kThreads, 0, s>>>(
        y0f, yf, st, ns, nf, B, t0, tf, rtol, atol, h0, use_hstart, max_step,
        max_steps);
  } else {
    fused_rkn_kernel<false><<<blocks, kThreads, 0, s>>>(
        y0f, yf, st, ns, nf, B, t0, tf, rtol, atol, h0, use_hstart, max_step,
        max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
