// Fused adaptive ESDIRK ensemble solver for Hopper (sm_90a): stiff ODEs and
// index-1 DAEs, the whole implicit integration in one launch.
//
// Replaces extensisq_tpu/ops/fused_esdirk.py:solve_fused_esdirk, the Pallas
// kernel (its body `kernel`, with `_jacobian`, `_gauss` and `newton`).  Its
// plain PyTorch version is extensisq_tpu_torch/ops/fused_esdirk.py:
// fused_esdirk_reference; the two take the same steps up to round-off.
//
// Design: one thread per ensemble member.  Each thread keeps y, y_lo, yp,
// the stage rows K[S][N] (and Z[S][N] in compensated mode), the Newton
// matrix and its factor in registers, and runs its own loop of attempts
// until its status leaves RUNNING.  A member reads device memory once at
// the start and writes once at the end.
//
// Per attempt, as in the JAX kernel:
//  * J at (t, y) from N evaluations of rhs<Dual> (dual.cuh), one tangent
//    seed per column: the exact JVP, not counted in nfev;
//  * W = Sc (M - h d J), factored ONCE by Gaussian elimination with the JAX
//    kernel's bubble pivoting (a lower row swaps in where its entry is
//    strictly larger, first maximum wins).  The Pallas body re-eliminates
//    [W | b] in every Newton iteration; storing the multipliers and the
//    swap bits gives the same arithmetic at a fraction of the cost;
//  * each stage by modified Newton (rate, divergence and early exit as in
//    extensisq common.py), the filtered or plain error, the implicit
//    controller, the rate-based reduction after a convergence failure and
//    the double-single time carry.
//
// What bounds it on the H100: like the explicit kernel, each member is a
// long chain of dependent f32 operations, now with N dual RHS evaluations,
// an N^3/3 elimination and several N^2 solves per attempt, so a thread is
// latency-bound and the card's throughput comes from members in flight.
// Registers are the scarce resource: Kv3I at N = 5 holds about 120 floats
// per thread; the build prints registers and spills (-Xptxas -v).
//
// The method, the mass-matrix setup and the user's right-hand side come
// from the generated header fused_esdirk_config.cuh:
//   namespace tab { N, S, D, KAPPA, controller constants,
//                   A(i,j), AZ(i,j), C(i), E(j), MASS(i), ALG(i), V(i,j), ... }
//   template <class T> __device__ void rhs(T t, const T* y, T* dy);
// The accessors are constexpr functions returning float32 literals, so
// after unrolling every coefficient is a constant and zero weights drop out
// of the sums as they do at the JAX trace.
//
// Numerics, each handled where it appears:
//  * FMA contraction stays on, except in the double-single helpers of the
//    compensated mode (rk_common.cuh); no fast math (powf, log10f, sqrtf
//    feed the controller and the starting step).
//  * Non-finite values: a non-finite RHS value or Newton update makes the
//    stage fail (the step shrinks by the rate rule); a non-finite y_new or
//    error norm rejects the attempt.  Non-finite entries are replaced by 1
//    where the JAX kernel scrubs them, so the arithmetic that follows is
//    the same; a member lives in its own thread and never poisons another.
//  * Step cap: max_steps counts the member's loop iterations, accepted plus
//    rejected; reaching it gives status 3.
//  * A rejected attempt whose reduced step falls below the minimum step ends
//    the member with status 2 instead of looping.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"
#include "fused_esdirk_config.cuh"
#include "esdirk_control.cuh"
#include "hstart.cuh"
#include "rk_common.cuh"

namespace {

using tab::N;
using tab::S;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;

using esdirk::RowA;
using esdirk::RowAz;
using esdirk::RowE;

// out = Mat x for the rotation matrices, zero coefficients dropped, summed
// in order.
enum class Mat { VH, V, UTS };

template <Mat M>
__host__ __device__ constexpr float coef(int i, int j) {
  return M == Mat::VH ? tab::VH(i, j)
                      : (M == Mat::V ? tab::V(i, j) : tab::UTS(i, j));
}

template <Mat M, class T>
__device__ __forceinline__ void mat_rows(const T (&x)[N], T (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0.0f);
    bool any = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float c = coef<M>(i, j);
      if (c != 0.0f) {
        acc = any ? acc + c * x[j] : c * x[j];
        any = true;
      }
    }
    out[i] = acc;
  }
}

// The system the kernel integrates: the user's rhs, or for a dense/hidden
// mass matrix the unit-mass rotated system w' = diag(1/s) U^T f(t, V w).
template <class T>
__device__ __forceinline__ void fun1(T t, const T (&w)[N], T (&dw)[N]) {
  if constexpr (tab::ROT) {
    T y[N], f[N];
    mat_rows<Mat::V>(w, y);
    rhs(t, y, f);
    mat_rows<Mat::UTS>(f, dw);
  } else {
    rhs(t, w, dw);
  }
}

// Rows in user coordinates (y = V w), where every norm is taken.
__device__ __forceinline__ void to_user(const float (&w)[N], float (&y)[N]) {
  if constexpr (tab::ROT) {
    mat_rows<Mat::V>(w, y);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = w[i];
  }
}

// J[i][j] = d fun1_i / d y_j at (t, y): one dual evaluation per column.
__device__ __forceinline__ void jacobian(float t, const float (&y)[N],
                                         float (&J)[N][N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    Dual yd[N], fd[N];
#pragma unroll
    for (int k = 0; k < N; ++k) yd[k] = Dual(y[k], k == j ? 1.0f : 0.0f);
    fun1(Dual(t), yd, fd);
#pragma unroll
    for (int i = 0; i < N; ++i) J[i][j] = fd[i].d;
  }
}

// Factor a in place: the eliminated rows with the multipliers below the
// diagonal; bit q of `swaps` records the q-th bubble swap.
__device__ __forceinline__ void gauss_factor(float (&a)[N][N],
                                             unsigned& swaps) {
  swaps = 0u;
  int q = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const bool sw = fabsf(a[i][k]) > fabsf(a[k][k]);
#pragma unroll
      for (int j = k; j < N; ++j) {
        const float akj = a[k][j];
        const float aij = a[i][j];
        a[k][j] = sw ? aij : akj;
        a[i][j] = sw ? akj : aij;
      }
      swaps |= (sw ? 1u : 0u) << q;
      ++q;
    }
    const float inv = 1.0f / a[k][k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float fkt = a[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < N; ++j) a[i][j] = a[i][j] - fkt * a[k][j];
      a[i][k] = fkt;
    }
  }
}

// Solve in place with a gauss_factor factor: the swaps and the elimination
// replayed on x in the factor's order, then back substitution.
__device__ __forceinline__ void gauss_solve(const float (&a)[N][N],
                                            unsigned swaps, float (&x)[N]) {
  int q = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const bool sw = (swaps >> q) & 1u;
      const float xk = x[k];
      const float xi = x[i];
      x[k] = sw ? xi : xk;
      x[i] = sw ? xk : xi;
      ++q;
    }
#pragma unroll
    for (int i = k + 1; i < N; ++i) x[i] = x[i] - a[i][k] * x[k];
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    float acc = x[k];
#pragma unroll
    for (int j = k + 1; j < N; ++j) acc = acc - a[k][j] * x[j];
    x[k] = acc / a[k][k];
  }
}

// x, or 1 with `bad` set where x is not finite (the JAX kernel's scrub).
__device__ __forceinline__ float finite_or_one(float x, bool& bad) {
  if (isfinite(x)) return x;
  bad = true;
  return 1.0f;
}

// RMS of x / (atol + rtol max(|a|, |b|)), all in user coordinates.
__device__ __forceinline__ float scaled_norm(const float (&x)[N],
                                             const float (&a)[N],
                                             const float (&b)[N], float rtol,
                                             float atol) {
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float scale = atol + rtol * fmaxf(fabsf(a[i]), fabsf(b[i]));
    const float r = x[i] / scale;
    sq = sq + r * r;
  }
  return sqrtf(sq / static_cast<float>(N));
}

struct Params {
  float rtol, atol, tiny_err;
};

// Modified Newton for one stage: z from its predictor to the stage
// increment.  Returns converged; sets the stage's rate (>= 0), its RHS
// evaluations and whether a non-finite value stopped it.
__device__ __forceinline__ bool newton(float t_stage, float h,
                                       const float (&psi)[N],
                                       const float (&yu_c)[N], float (&z)[N],
                                       const float (&a)[N][N], unsigned swaps,
                                       const Params& p, float& rate_out,
                                       int& nfev, bool& bad_any) {
  esdirk::Newton nw;
  bool conv = false;
  nfev = 0;
  bad_any = false;
#pragma unroll 1
  for (int it = 0; it < tab::NEWTON_MAXITER; ++it) {
    float y_pred[N], f[N], dz[N];
#pragma unroll
    for (int i = 0; i < N; ++i) y_pred[i] = psi[i] + tab::D * z[i];
    fun1(t_stage, y_pred, f);
    nfev += 1;
    bool bad = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float fi = finite_or_one(f[i], bad);
      dz[i] = tab::ALG(i) ? fi * tab::INV_D : h * fi - tab::MASS(i) * z[i];
    }
    gauss_solve(a, swaps, dz);
#pragma unroll
    for (int i = 0; i < N; ++i) dz[i] = finite_or_one(dz[i], bad);
    float yu_pred[N], dz_u[N];
    to_user(y_pred, yu_pred);
    to_user(dz, dz_u);
    const float dz_norm =
        finite_or_one(scaled_norm(dz_u, yu_c, yu_pred, p.rtol, p.atol), bad);
    const bool stop = nw.test(it, dz_norm, p.tiny_err, bad, conv);
    if (!bad) {
#pragma unroll
      for (int i = 0; i < N; ++i) z[i] = z[i] + dz[i];
    }
    bad_any = bad_any || bad;
    if (stop) break;
  }
  rate_out = fmaxf(nw.rate, 0.0f);
  return conv;
}

// One attempt's stage data; registers after inlining.
struct Stages {
  float K[S][N];  // stage derivatives
  float Z[S][N];  // stage increments h K (compensated mode)
  float psi[N];   // last stage's explicit part
  float z[N];     // last stage's increment
  float Rate;
  int nfev;
  bool conv;
};

// Stages I..S-1 of one attempt; K[0] (and Z[0]) hold the first stage.
template <bool COMP, int I>
__device__ __forceinline__ void stages(Stages& st, float tc, float h,
                                       const float (&y)[N],
                                       const float (&y_lo)[N],
                                       const float (&yu_c)[N],
                                       const float (&a)[N][N], unsigned swaps,
                                       const Params& p) {
  if constexpr (I < S) {
    float acc[N];
    if constexpr (COMP) {
      float cmp[N];
      rk::comp_wsum<RowA<I>, I>(acc, cmp, st.Z);
#pragma unroll
      for (int i = 0; i < N; ++i) st.psi[i] = y[i] + (acc[i] + (cmp[i] + y_lo[i]));
    } else {
      rk::wsum<RowA<I>, I>(acc, st.K);
#pragma unroll
      for (int i = 0; i < N; ++i) st.psi[i] = y[i] + h * acc[i];
    }
    rk::wsum<RowAz<I>, I>(acc, st.K);
#pragma unroll
    for (int i = 0; i < N; ++i) st.z[i] = h * acc[i];
    constexpr float c = tab::C(I);
    float rate;
    int nf;
    bool bad;
    const bool conv = newton(tc + c * h, h, st.psi, yu_c, st.z, a, swaps, p,
                             rate, nf, bad);
    st.conv = st.conv && conv && !bad;
    st.Rate = fmaxf(st.Rate, rate);
    st.nfev += nf;
    const float inv_h = 1.0f / h;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      st.K[I][i] = st.z[i] * inv_h;
      if constexpr (COMP) st.Z[I][i] = st.z[i];
    }
    stages<COMP, I + 1>(st, tc, h, y, y_lo, yu_c, a, swaps, p);
  }
}

template <bool COMP>
__global__ void fused_esdirk_kernel(
    const float* __restrict__ y0, const float* __restrict__ yp0,
    float* __restrict__ y_out, int* __restrict__ status_out,
    int* __restrict__ nstep_out, int* __restrict__ nfev_out, int B, float t0,
    float tf, float rtol, float atol, float h0, int use_hstart, int have_yp0,
    float max_step, int max_steps, float tiny_err) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B) return;  // ragged last block: no member padding
  const Params p{rtol, atol, tiny_err};

  float y[N], y_lo[N], yp[N], in[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    in[k] = y0[static_cast<size_t>(idx) * N + k];
    y_lo[k] = 0.0f;
  }
  if constexpr (tab::ROT) {
    mat_rows<Mat::VH>(in, y);  // w = V^T y
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = in[k];
  }
  float t = t0;
  float t_lo = 0.0f;
  const float span = tf - t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  if (have_yp0) {
#pragma unroll
    for (int k = 0; k < N; ++k) in[k] = yp0[static_cast<size_t>(idx) * N + k];
    if constexpr (tab::ROT) {
      mat_rows<Mat::VH>(in, yp);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) yp[k] = in[k];
    }
  } else {
    fun1(t, y, yp);
    if constexpr (tab::HAS_M && !tab::ROT) {
#pragma unroll
      for (int k = 0; k < N; ++k) yp[k] = yp[k] * tab::INV_MASS(k);
    }
  }
  float h_abs = h0;
  if (use_hstart) {
    // plain ODEs only; max_step is +inf when the caller gave none
    const float bq = t + dir * fminf(fabsf(tf - t), max_step);
    h_abs = fabsf(rk::hstart<N, tab::MORDER>(t, bq, y, yp, rtol, atol));
  }

  int status = kRunning;
  int nstep = 0;
  int nfev = have_yp0 ? 0 : 1;
  int it = 0;
  esdirk::Control ctl{h_abs};

  while (status == kRunning) {
    // step-size limits and the landing on tf, every attempt
    const float tc = t + t_lo;
    ctl.prepare(t, t_lo, tf, max_step);
    const float ha = ctl.ha;
    const float h = ha * dir;

    // Newton matrix W = Sc (M - h d J), factored once per attempt
    float a[N][N];
    jacobian(tc, y, a);
    const float hd = h * tab::D;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a[i][j] = tab::ALG(i) ? -a[i][j]
                              : (i == j ? tab::MASS(i) : 0.0f) - hd * a[i][j];
      }
    }
    unsigned swaps;
    gauss_factor(a, swaps);

    // stages (stage 0 explicit: K0 = yp; h K_j == z_j)
    Stages st;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      st.K[0][i] = yp[i];
      if constexpr (COMP) st.Z[0][i] = h * yp[i];
    }
    st.Rate = 0.0f;
    st.nfev = 0;
    st.conv = !ctl.too_small;
    float yu_c[N];
    to_user(y, yu_c);
    stages<COMP, 1>(st, tc, h, y, y_lo, yu_c, a, swaps, p);

    // solution and error estimate; stiffly accurate: y_new = psi + d z of
    // the last stage
    float y_new[N], y_lo_new[N], err[N];
    if constexpr (COMP) {
      float inc_s[N], inc_c[N];
      rk::comp_wsum<RowA<S - 1>, S>(inc_s, inc_c, st.Z);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float hi, lo1;
        rk::df_add(y[i], y_lo[i], inc_s[i], hi, lo1);
        rk::two_sum(hi, __fadd_rn(lo1, inc_c[i]), y_new[i], y_lo_new[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        y_new[i] = st.psi[i] + tab::D * st.z[i];
        y_lo_new[i] = y_lo[i];
      }
    }
    bool bad_m = false;
#pragma unroll
    for (int i = 0; i < N; ++i) y_new[i] = finite_or_one(y_new[i], bad_m);
    if constexpr (COMP) {
      float e_s[N], e_c[N];
      rk::comp_wsum<RowE, S>(e_s, e_c, st.Z);
#pragma unroll
      for (int i = 0; i < N; ++i) err[i] = e_s[i] + e_c[i];
    } else {
      float e[N];
      rk::wsum<RowE, S>(e, st.K);
#pragma unroll
      for (int i = 0; i < N; ++i) err[i] = h * e[i];
    }
    if constexpr (tab::FILTER_ERROR) {
      const float inv_hd = 1.0f / hd;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (tab::ALG(i)) err[i] = err[i] * inv_hd;
      }
      gauss_solve(a, swaps, err);
#pragma unroll
      for (int i = 0; i < N; ++i) err[i] = tab::MASS(i) * err[i];
    }
    float yu_new[N], err_u[N];
    to_user(y_new, yu_new);
    to_user(err, err_u);
    float err_norm = finite_or_one(
        scaled_norm(err_u, yu_c, yu_new, rtol, atol), bad_m);
    if (bad_m) err_norm = err_norm + 10.0f;
    const bool accepted = st.conv && err_norm < 1.0f && !bad_m;

    // implicit controller and the rate-based reduction after a convergence
    // failure (esdirk_control.cuh)
    ctl.finish(err_norm, st.Rate, st.conv, accepted, h, tiny_err);
    if (ctl.too_small) status = kTooSmall;
    // double-single t advance; the landing test uses the remainder
    float t_adv, t_lo_adv;
    rk::df_add(t, t_lo, h, t_adv, t_lo_adv);
    const float rem = (tf - t_adv) - t_lo_adv;
    const bool is_last = accepted && fabsf(rem) <= tab::LAND_TOL * ha;
    if (status == kRunning && is_last) status = kFinished;
    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (status == kRunning && it >= max_steps) status = kOverflow;

    if (accepted) {
      bool unused = false;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        y[i] = y_new[i];
        y_lo[i] = y_lo_new[i];
        yp[i] = finite_or_one(st.K[S - 1][i], unused);
      }
      t = is_last ? tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
      nstep += 1;
    }
    nfev += st.nfev;
  }

  float out[N];
  to_user(y, out);
#pragma unroll
  for (int k = 0; k < N; ++k) y_out[static_cast<size_t>(idx) * N + k] = out[k];
  status_out[idx] = status;
  nstep_out[idx] = nstep;
  nfev_out[idx] = nfev;
}

}  // namespace

// Launches one thread per member on the caller's stream and returns
// cudaGetLastError(); the wrapper raises on anything but 0.  yp0 may be
// null when have_yp0 is 0.
extern "C" int fused_esdirk_launch(const void* y0, const void* yp0,
                                   void* y_out, void* status, void* nstep,
                                   void* nfev, int B, float t0, float tf,
                                   float rtol, float atol, float h0,
                                   int use_hstart, int have_yp0,
                                   float max_step, int max_steps,
                                   float tiny_err, int compensated,
                                   int threads, void* stream) {
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  const float* yp0f = static_cast<const float*>(yp0);
  float* yf = static_cast<float*>(y_out);
  int* st = static_cast<int*>(status);
  int* ns = static_cast<int*>(nstep);
  int* nf = static_cast<int*>(nfev);
  if (compensated) {
    fused_esdirk_kernel<true><<<blocks, threads, 0, s>>>(
        y0f, yp0f, yf, st, ns, nf, B, t0, tf, rtol, atol, h0, use_hstart,
        have_yp0, max_step, max_steps, tiny_err);
  } else {
    fused_esdirk_kernel<false><<<blocks, threads, 0, s>>>(
        y0f, yp0f, yf, st, ns, nf, B, t0, tf, rtol, atol, h0, use_hstart,
        have_yp0, max_step, max_steps, tiny_err);
  }
  return static_cast<int>(cudaGetLastError());
}
