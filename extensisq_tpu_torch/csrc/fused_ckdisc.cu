// Fused CKdisc ensemble solver for Hopper (sm_90a): the variable-order
// cascade for non-smooth problems, the whole adaptive integration in one
// launch.
//
// Replaces extensisq_tpu/ops/fused_ckdisc.py:solve_fused_ckdisc, the Pallas
// kernel that runs _run_ck_loop per launch with the in-kernel Watts start of
// extensisq_tpu/ops/_hstart_tile.py:hstart_tile.  Its plain PyTorch version
// is extensisq_tpu_torch/ops/fused_ckdisc.py:fused_ckdisc_reference; the two
// take the same steps up to round-off.
//
// Design: one thread per ensemble member, as fused_erk.cu.  Each thread
// holds y, f and the six stage rows K[6][N] in registers and runs its own
// cascade (ck_control.cuh) until its status leaves RUNNING.  Unlike the TPU
// kernel, which computes all six stages for every member of a tile and
// applies the cascade as masks, a thread really skips stages 3-6 when E1 or
// E2 vetoes, and evaluates f at the new point only on acceptance.  The
// results are the same: E2 is read only where go2 holds, E4 and the
// 3rd-order fallback only where go4 holds.  nfev counts the evaluations of
// the reference method, 1 + 2 go2 + 2 go4 per attempt plus the endpoint of
// an accepted one, as the JAX kernel counts them, an attempt that ends in
// status 2 included.
//
// What bounds it on the H100: as B1, a long chain of dependent f32
// operations per thread (stages, three norms and powf per attempt), so it
// is latency-bound and the card's throughput comes from the members in
// flight (blocks of the caller's block_members, 128 by default).  A warp
// runs until its slowest member ends, and its threads diverge where their
// cascades take other branches.
//
// The tableau, the cascade's weight rows (float32, rounded as the JAX kernel
// rounds them) and the user's right-hand side come from the generated header
// fused_ckdisc_config.cuh:
//   namespace tab { N, S, MORDER, A(i, j), B(j), C(i), E(j), BAS(r, j),
//                   EAS(r, j), BFB(r, j), EFB(r, j), CFB(r), step and start
//                   constants }
//   __device__ void rhs(float t, const float* y, float* dy);
//
// Numerics: nvcc may contract a*b + c into fma (the plain version rounds
// each operation, so single members part in the last bits and, at a switch
// of a non-smooth RHS, take other steps); no fast math; a non-finite norm
// counts as 1e30, so it rejects; a non-finite E4 where go4 holds, or an
// accepted state or endpoint derivative that is not finite, ends the member
// with status 3; max_steps counts attempts.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_ckdisc_config.cuh"
#include "hstart.cuh"
#include "rk_common.cuh"
#include "rk_rows.cuh"
#include "ck_control.cuh"

namespace {

using tab::N;
constexpr int S = 6;
static_assert(tab::S == S, "CKdisc has six stages");

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;

using Stages = float[S][N];

// Stages I..END-1 of one attempt; K[0] holds f(t, y).
template <int I, int END>
__device__ __forceinline__ void stages(float t, float h, const float (&y)[N],
                                       Stages& K) {
  if constexpr (I < END) {
    float acc[N], arg[N];
    rk::wsum<rk::RowA<I>, I>(acc, K);
#pragma unroll
    for (int k = 0; k < N; ++k) arg[k] = y[k] + h * acc[k];
    rhs(t + tab::C(I) * h, arg, K[I]);
    stages<I + 1, END>(t, h, y, K);
  }
}

// The solution y + h sum_j WB_j K_j over the first LEN stages into sol, and
// the RMS of its error h sum_j WE_j K_j scaled by atol + rtol max(|y|, |sol|)
// (not yet clean()ed).
template <class WB, class WE, int LEN>
__device__ __forceinline__ float assess(const float (&y)[N], float h,
                                        const Stages& K, float rtol,
                                        float atol, float (&sol)[N]) {
  float b[N], e[N];
  rk::wsum<WB, LEN>(b, K);
  rk::wsum<WE, LEN>(e, K);
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sol[k] = y[k] + h * b[k];
    const float err = h * e[k];
    const float q = err / (atol + rtol * fmaxf(fabsf(y[k]), fabsf(sol[k])));
    sq = sq + q * q;
  }
  return sqrtf(sq / static_cast<float>(N));
}

__global__ void fused_ckdisc_kernel(const float* __restrict__ y0,
                                    float* __restrict__ y_out,
                                    int* __restrict__ status_out,
                                    int* __restrict__ nstep_out,
                                    int* __restrict__ nfev_out, int B,
                                    float t0, float tf, float rtol, float atol,
                                    float h0, int use_hstart, float max_step,
                                    int max_steps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B) return;  // ragged last block: no member padding

  float y[N], f[N];
  Stages K;
#pragma unroll
  for (int k = 0; k < N; ++k) y[k] = y0[static_cast<size_t>(idx) * N + k];
  const float span = tf - t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  float t = t0;
  rhs(t, y, f);
  ck::Control ctl{{h0}};
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

#pragma unroll
    for (int k = 0; k < N; ++k) K[0][k] = f[k];
    float y_new[N];

    // E1 after two stages; E2 after four where E1 lets the attempt go on;
    // E4 after six where E2 does (kBig where skipped)
    stages<1, 2>(t, h, y, K);
    const float E1 = sqrtf(ck::clean(
        assess<ck::RowBas<0>, ck::RowEas<0>, 2>(y, h, K, rtol, atol, y_new)));
    const bool go2 = ctl.go2(E1);
    float E2 = ck::kBig;
    if (go2) {
      stages<2, 4>(t, h, y, K);
      E2 = ck::cbrt_floor(ck::clean(assess<ck::RowBas<1>, ck::RowEas<1>, 4>(
          y, h, K, rtol, atol, y_new)));
    }
    const bool go4 = go2 && ctl.go4(E2);
    float E4 = ck::kBig;
    bool bad4 = false;
    if (go4) {
      stages<4, 6>(t, h, y, K);
      const float nm =
          assess<rk::RowB, rk::RowE, 6>(y, h, K, rtol, atol, y_new);
      bad4 = !isfinite(nm);
      E4 = ck::p5rt_floor(ck::clean(nm));
      if (E4 == 0.0f) E4 = 1e-38f;
    }
    const bool accept4 = go4 && E4 < 1.0f && !too_small;

    // the fallbacks: the 3rd-order solution at c = 3/5, else the 2nd-order
    // one at 1/5, each taken when its own error test passes
    bool fb3_ok = false;
    if (go4 && !accept4 && !bad4 && E2 < 1.0f && !too_small) {
      fb3_ok = ck::clean(assess<ck::RowBfb<1>, ck::RowEfb<1>, 4>(
                   y, h, K, rtol, atol, y_new)) < 1.0f;
    }
    const bool fb2_try =
        go2 && !accept4 && !bad4 && !fb3_ok && E1 < 1.0f && !too_small;
    bool fb2_ok = false;
    if (fb2_try) {
      fb2_ok = ck::clean(assess<ck::RowBfb<0>, ck::RowEfb<0>, 2>(
                   y, h, K, rtol, atol, y_new)) < 1.0f;
    }
    const bool accepted = accept4 || fb3_ok || fb2_ok;

    // a fallback shortens this step: its weights sum to C_fallback
    const float h_used =
        accept4 ? h : (fb3_ok ? h * tab::CFB(1) : h * tab::CFB(0));
    ctl.update(E1, E2, E4, go2, go4, accept4, fb3_ok, fb2_try);

    if (too_small) {
      status = kTooSmall;
    } else if (bad4) {
      status = kOverflow;
    }
    const bool is_last = accepted && fabsf(h_used) >= d;
    const float t_new = is_last ? tf : t + h_used;
    if (status == kRunning && is_last) status = kFinished;

    nfev += 1 + (go2 ? 2 : 0) + (go4 ? 2 : 0);
    if (accepted) {
      float f_new[N];
      rhs(t_new, y_new, f_new);
      nfev += 1;
      bool finite = true;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        finite = finite && isfinite(y_new[k]) && isfinite(f_new[k]);
      }
      if (finite) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          y[k] = y_new[k];
          f[k] = f_new[k];
        }
        t = t_new;
        nstep += 1;
      } else {
        status = kOverflow;
      }
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
extern "C" int fused_ckdisc_launch(const void* y0, void* y_out, void* status,
                                   void* nstep, void* nfev, int B, float t0,
                                   float tf, float rtol, float atol, float h0,
                                   int use_hstart, float max_step,
                                   int max_steps, int threads, void* stream) {
  const int blocks = (B + threads - 1) / threads;
  fused_ckdisc_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(
                                                stream)>>>(
      static_cast<const float*>(y0), static_cast<float*>(y_out),
      static_cast<int*>(status), static_cast<int*>(nstep),
      static_cast<int*>(nfev), B, t0, tf, rtol, atol, h0, use_hstart,
      max_step, max_steps);
  return static_cast<int>(cudaGetLastError());
}
