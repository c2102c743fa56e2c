// Fused adaptive explicit Runge-Kutta ensemble solver for Hopper (sm_90a).
//
// Replaces extensisq_tpu/ops/fused_erk.py:solve_fused_erk, the Pallas kernel
// that runs a whole adaptive integration (_run_erk_loop) per launch, with the
// in-kernel Watts start of extensisq_tpu/ops/_hstart_tile.py:hstart_tile.
// Its plain PyTorch version is extensisq_tpu_torch/ops/fused_erk.py:
// fused_erk_reference; the two take the same steps up to round-off.
//
// Design: one thread per ensemble member.  Each thread holds its y, y_lo, f
// and the K[S+1][N] stage rows in registers and runs its own adaptive loop
// (stages, error norm, controller, end landing) until its status leaves
// RUNNING.  A member reads device memory once at the start and writes once
// at the end; nothing inside the loop touches device memory.
//
// What bounds it on the H100: each member is a long chain of dependent f32
// operations (stages, powf in the controller), so a thread's time is
// latency-bound and the card's throughput comes from the number of members
// in flight.  Threads per block is the caller's block_members (128 by
// default); 4096 members fill only 32 blocks, about a quarter of the 132 SMs,
// while 262,144 members give 2048 blocks.  A warp runs until its slowest
// member ends, so members that need fewer steps idle their lanes meanwhile.
// No shared memory and no padding: the last block masks idx < B.
//
// The tableau (float32, rounded as the JAX kernel rounds it) and the user's
// right-hand side come from the generated header fused_erk_config.cuh:
//   namespace tab { N, S, FSAL, A, B, C, E, controller constants, ... }
//   __device__ void rhs(float t, const float* y, float* dy);
// (or the template form rhs<T> of the implicit kernels, instantiated as
// rhs<float>).  Weights are read through constexpr accessors at compile
// time, so zero weights drop out of the unrolled sums as they do at the JAX
// trace.  The sums, the double-single helpers and the starting step are
// shared with the implicit kernel (rk_common.cuh, hstart.cuh), the step
// control with the RKN and mid-size kernels (rk_control.cuh).
//
// Numerics, each handled where it appears:
//  * FMA contraction.  nvcc contracts a*b + c into one fma by default.  That
//    is harmless in the plain sums, but it breaks the compensated mode, so
//    two_sum, comp_wsum and df_add (rk_common.cuh) use __fadd_rn, __fsub_rn
//    and __fmul_rn, which are never contracted; the rest of the kernel keeps
//    the default contraction.
//  * No fast math: powf, log10f and sqrtf feed the controller and the
//    starting step; the build passes no -use_fast_math.
//  * Float literals: every literal carries an f suffix, so nothing is
//    promoted to double; the generated header emits float hex literals.
//  * Overflow: a non-finite error norm, y_new or FSAL f_new gives the member
//    status 3 (OVERFLOW).  A member lives in its own thread and never
//    poisons another.
//  * Step cap: max_steps counts the member's loop iterations, accepted plus
//    rejected, as the JAX kernel's hit_cap does; reaching it gives status 3.
//  * End landing: the end-of-interval split (d in (h, 2h) -> h = d/2) and
//    the exact landing t_new = tf on the last step follow the JAX kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_erk_config.cuh"
#include "hstart.cuh"
#include "rk_common.cuh"
#include "rk_control.cuh"

namespace {

using tab::N;
using tab::S;
constexpr int M = S + (tab::FSAL ? 1 : 0);  // rows of the error estimate

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;

// Weight rows: 0..S-1 are the rows of A, then B, E and the nodes C.
constexpr int kRowB = S;
constexpr int kRowE = S + 1;
constexpr int kRowC = S + 2;

// Called only in constant expressions, as CUDA allows for host constexpr
// arrays: every weight is a compile-time constant of the device code.
__host__ __device__ constexpr float weight(int row, int j) {
  return row < S ? tab::A[row][j]
                 : (row == kRowB ? tab::B[j]
                                 : (row == kRowE ? tab::E[j] : tab::C[j]));
}

// Weight row ROW as the shared sums read it.
template <int ROW>
struct Row {
  __host__ __device__ static constexpr float w(int j) { return weight(ROW, j); }
};

using Stages = float[S + 1][N];

// Stages I..S-1 of one attempt; K[0] holds f(t, y).
template <bool COMP, int I>
__device__ __forceinline__ void stages(float t, float h, const float (&y)[N],
                                       const float (&y_lo)[N], Stages& K) {
  if constexpr (I < S) {
    float acc[N], arg[N];
    rk::wsum<Row<I>, I>(acc, K);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float dy = h * acc[k];
      arg[k] = COMP ? y[k] + (dy + y_lo[k]) : y[k] + dy;
    }
    constexpr float c = weight(kRowC, I);
    rhs(t + c * h, arg, K[I]);
    stages<COMP, I + 1>(t, h, y, y_lo, K);
  }
}

template <bool COMP>
__global__ void fused_erk_kernel(const float* __restrict__ y0,
                                 float* __restrict__ y_out,
                                 int* __restrict__ status_out,
                                 int* __restrict__ nstep_out,
                                 int* __restrict__ nfev_out, int B, float t0,
                                 float tf, float rtol, float atol, float h0,
                                 int use_hstart, float max_step,
                                 int max_steps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B) return;  // ragged last block: no member padding

  float y[N], y_lo[N], f[N];
  Stages K;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    y[k] = y0[static_cast<size_t>(idx) * N + k];
    y_lo[k] = 0.0f;
  }
  const float span = tf - t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  float t = t0;
  float t_lo = 0.0f;
  rhs(t, y, f);
  rk::StepControl ctl{h0};
  int nfev = 1;
  if (use_hstart) {
    // max_step is +inf when the caller gave none
    const float bq = t + dir * fminf(fabsf(tf - t), max_step);
    ctl.h_abs = fabsf(rk::hstart<N, tab::MORDER>(t, bq, y, f, rtol, atol));
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

    // stages, solution and error estimate
#pragma unroll
    for (int k = 0; k < N; ++k) K[0][k] = f[k];
    stages<COMP, 1>(t, h, y, y_lo, K);
    float y_new[N], y_lo_new[N], err[N];
    if constexpr (COMP) {
      float inc_s[N], inc_c[N];
      rk::comp_wsum<Row<kRowB>, S>(inc_s, inc_c, K);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float hi, lo1;
        rk::df_add(y[k], y_lo[k], __fmul_rn(h, inc_s[k]), hi, lo1);
        rk::two_sum(hi, __fadd_rn(lo1, __fmul_rn(h, inc_c[k])), y_new[k],
                y_lo_new[k]);
      }
    } else {
      float inc[N];
      rk::wsum<Row<kRowB>, S>(inc, K);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        y_new[k] = y[k] + h * inc[k];
        y_lo_new[k] = y_lo[k];
      }
    }
    if constexpr (tab::FSAL) rhs(t + h, y_new, K[S]);
    if constexpr (COMP) {
      float e_s[N], e_c[N];
      rk::comp_wsum<Row<kRowE>, M>(e_s, e_c, K);
#pragma unroll
      for (int k = 0; k < N; ++k) err[k] = h * (e_s[k] + e_c[k]);
    } else {
      float e[N];
      rk::wsum<Row<kRowE>, M>(e, K);
#pragma unroll
      for (int k = 0; k < N; ++k) err[k] = h * e[k];
    }
    float sq = 0.0f;
    bool finite = true;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float scale = atol + rtol * fmaxf(fabsf(y[k]), fabsf(y_new[k]));
      const float q = err[k] / scale;
      sq = sq + q * q;
      finite = finite && isfinite(y_new[k]);
      if constexpr (tab::FSAL) finite = finite && isfinite(K[S][k]);
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
        for (int k = 0; k < N; ++k) f[k] = K[S][k];
      } else {
        rhs(t_new, y_new, f);
        nfev += 1;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        y[k] = y_new[k];
        y_lo[k] = y_lo_new[k];
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
  for (int k = 0; k < N; ++k) y_out[static_cast<size_t>(idx) * N + k] = y[k];
  status_out[idx] = status;
  nstep_out[idx] = nstep;
  nfev_out[idx] = nfev;
}

}  // namespace

// Launches one thread per member on the caller's stream and returns
// cudaGetLastError(); the wrapper raises on anything but 0.
extern "C" int fused_erk_launch(const void* y0, void* y_out, void* status,
                                void* nstep, void* nfev, int B, float t0,
                                float tf, float rtol, float atol, float h0,
                                int use_hstart, float max_step, int max_steps,
                                int compensated, int threads, void* stream) {
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  float* yf = static_cast<float*>(y_out);
  int* st = static_cast<int*>(status);
  int* ns = static_cast<int*>(nstep);
  int* nf = static_cast<int*>(nfev);
  if (compensated) {
    fused_erk_kernel<true><<<blocks, threads, 0, s>>>(
        y0f, yf, st, ns, nf, B, t0, tf, rtol, atol, h0, use_hstart, max_step,
        max_steps);
  } else {
    fused_erk_kernel<false><<<blocks, threads, 0, s>>>(
        y0f, yf, st, ns, nf, B, t0, tf, rtol, atol, h0, use_hstart, max_step,
        max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
