// Fused adaptive ESDIRK ensemble solver for mid-size stiff systems and
// index-1 DAEs on Hopper (sm_90a): tridiagonal Newton matrices solved by
// parallel cyclic reduction, the whole implicit integration of each member
// in one launch, one thread block per member.
//
// Replaces extensisq_tpu/ops/fused_esdirk_grid.py:solve_fused_esdirk_grid
// (B7), the Pallas kernel (its body `kernel`, with `jac_bands`, `newton` and
// `_pcr_solve`).  Its plain PyTorch version is
// extensisq_tpu_torch/ops/fused_esdirk_grid.py:fused_esdirk_grid_reference,
// which runs B2's plain loop (ops/fused_esdirk.py:run_esdirk_loop) with the
// same bands and reduction; the two take the same steps up to round-off.
//
// Design.  A member's y (and its lo carry), yp, the stage rows K[S][N] (and
// the increments Z[S][N] of the compensated mode), the stage's psi and z,
// the point where f is evaluated, one row of dual numbers, the Newton
// matrix's three bands (two sets, used in turn by the reduction), the
// reduction's multipliers alpha[L][N] and gamma[L][N] with L = ceil(log2 N)
// and its final diagonal, and two right-hand-side rows live in shared
// memory: (17 + 2 S + 2 L) N floats plus the mass row, 44 KB for Kv3I at
// N = 256.  Element i belongs to the thread of rank i mod (block size),
// which does every per-element operation on it; the per-member scalars
// (t, h, the Newton rate, the controller of esdirk_control.cuh) are
// computed by every thread from identical inputs, so every thread takes the
// same branches.  Per attempt:
//  * the bands of J at (t, y): four passes of rhs<Dual> over the block,
//    element j seeded with the tangent (j % 4 == c); the tangent at i gives
//    J[i, i-1], J[i, i] or J[i, i+1] where (i + 3) % 4, i % 4 or
//    (i + 1) % 4 equals c (the exact JVP of jax.linearize, not counted in
//    nfev), and W = M - h d J (algebraic rows -J) from them;
//  * the cyclic reduction's multipliers, once: L rounds, one barrier each;
//  * each stage by modified Newton: per iteration one RHS evaluation (a
//    barrier before it), the reduction replayed on the right-hand side (L
//    rounds, a barrier each), and two group sums (the update's norm and its
//    count of non-finite values);
//  * the solution, the filtered or plain error (one more replay) and its
//    norm, and B2's implicit controller.
//
// What bounds it on the H100: per Newton iteration an element costs one RHS
// (a stencil of a few flops on shared memory) and 4 flops per reduction
// round, and the iteration costs L + 3 barriers; with one element per
// thread at N = 128-256 that is barrier latency, not the card's flop or
// byte rate, and members run in parallel on the SMs (32 members use 32 of
// 132).
//
// The generated header fused_esdirk_grid_config.cuh provides
//   namespace tab { G = grid::Grid<N>, N, L, S, MORDER, NEWTON_MAXITER,
//                   FILTER_ERROR, D, INV_D, KAPPA, controller and start
//                   constants, the accessors A(i, j), AZ(i, j), C(i), E(j) }
//   template <class T> __device__ T rhs(T t, const T* y, int i,
//                                       const float* p);
// neighbours come from tab::G::rolled.  The mass diagonal is an input (all
// ones for ODEs), zeros marking algebraic rows.
//
// Numerics, as in fused_esdirk.cu (B2): FMA contraction stays on except in
// the compensated helpers; a non-finite RHS value or Newton update makes the
// stage fail and is replaced by 1 where the JAX kernel scrubs it, a
// non-finite y_new or error norm rejects the attempt; max_steps counts
// attempts; a rejected attempt whose reduced step falls below the minimum
// step ends the member with status 2.  The reduction's zero pivots and
// denominators read 1, as in the JAX _pcr_solve.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"
#include "grid_common.cuh"
#include "fused_esdirk_grid_config.cuh"
#include "esdirk_control.cuh"
#include "block_hstart.cuh"
#include "block_rows.cuh"
#include "rk_common.cuh"

namespace {

using tab::L;
using tab::N;
using tab::S;
using esdirk::RowA;
using esdirk::RowAz;
using esdirk::RowE;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;
constexpr int kMaxThreads = 256;

// Shared-memory layout of a member, in floats; the dual row comes first, so
// that it is aligned for its 8-byte elements.
constexpr int kDual = 0;                 // one row of Dual, 2 N
constexpr int kY = kDual + 2 * N;        // state
constexpr int kYlo = kY + N;             // its lo carry
constexpr int kYp = kYlo + N;            // f at the state
constexpr int kMass = kYp + N;           // mass diagonal
constexpr int kK = kMass + N;            // stage rows K[S]
constexpr int kZ = kK + S * N;           // increments Z[S] (compensated)
constexpr int kPsi = kZ + S * N;         // the stage's explicit part
constexpr int kZc = kPsi + N;            // the stage's increment z
constexpr int kPred = kZc + N;           // psi + d z, read by the RHS
constexpr int kYnew = kPred + N;         // the attempt's solution
constexpr int kYlonew = kYnew + N;       // and its lo carry
constexpr int kRhs = kYlonew + N;        // two right-hand-side rows
constexpr int kBand = kRhs + 2 * N;      // two sets of bands a, b, c
constexpr int kAlpha = kBand + 6 * N;    // alpha[L][N]
constexpr int kGamma = kAlpha + L * N;   // gamma[L][N]
constexpr int kDen = kGamma + L * N;     // the final diagonal
constexpr int kFloats = kDen + N;

struct Launch {  // the launch's scalars, the same for every member
  float t0, tf, rtol, atol, h0;
  int use_hstart, have_yp0;
  float max_step;
  int max_steps;
  float tiny_err;
};

struct Out {
  float* y;
  int* status;
  int* nsteps;
  int* nfev;
};

// Pointers into a member's shared memory.
struct Rows {
  Dual* dual;
  float *y, *ylo, *yp, *mass, *K, *Z, *psi, *z, *pred, *ynew, *ylonew;
  float *rhs, *band, *alpha, *gamma, *den;
};

__device__ __forceinline__ Rows rows(float* sm) {
  return Rows{reinterpret_cast<Dual*>(sm + kDual),
              sm + kY, sm + kYlo, sm + kYp, sm + kMass, sm + kK, sm + kZ,
              sm + kPsi, sm + kZc, sm + kPred, sm + kYnew, sm + kYlonew,
              sm + kRhs, sm + kBand, sm + kAlpha, sm + kGamma, sm + kDen};
}

// x, or 1 with `bad` counted where x is not finite (the JAX kernel's
// scrub).
__device__ __forceinline__ float finite_or_one(float x, float& bad) {
  if (isfinite(x)) return x;
  bad += 1.0f;
  return 1.0f;
}

// The element derivative as the block start calls it.
struct Deriv {
  __device__ float operator()(float t, const float* Y, int j) const {
    return rhs(t, Y, j, nullptr);
  }
};

// W = M - h d J at (tc, y) into the first set of bands (a = lower, b =
// diagonal, c = upper): four dual passes with striped tangents.
template <class Group>
__device__ void newton_matrix(Group& g, const Rows& m, float tc, float hd) {
  const int r0 = g.rank();
  const int nt = g.size();
  float* a = m.band;
  float* b = m.band + N;
  float* c = m.band + 2 * N;
  for (int i = r0; i < N; i += nt) a[i] = b[i] = c[i] = 0.0f;
#pragma unroll 1
  for (int col = 0; col < 4; ++col) {
    for (int j = r0; j < N; j += nt) {
      const float seed = (j % 4 == col) ? 1.0f : 0.0f;
      m.dual[j] = Dual(m.y[j], seed + m.y[j] * 0.0f);
    }
    g.sync();
    for (int i = r0; i < N; i += nt) {
      const float jv = rhs(Dual(tc), m.dual, i, nullptr).d;
      a[i] = a[i] + ((i + 3) % 4 == col ? 1.0f : 0.0f) * jv;
      b[i] = b[i] + (i % 4 == col ? 1.0f : 0.0f) * jv;
      c[i] = c[i] + ((i + 1) % 4 == col ? 1.0f : 0.0f) * jv;
    }
    g.sync();  // the dual row is rewritten by the next pass
  }
  for (int i = r0; i < N; i += nt) {
    const float mi = m.mass[i];
    const bool alg = mi == 0.0f;
    a[i] = alg ? -a[i] : -hd * a[i];
    b[i] = alg ? -b[i] : mi - hd * b[i];
    c[i] = alg ? -c[i] : -hd * c[i];
  }
}

// The cyclic reduction's multipliers of the bands in m.band: round l
// couples equation i to i -/+ 2^l (indices mod N); the bands of the next
// round go to the other set.
template <class Group>
__device__ void pcr_factor(Group& g, const Rows& m) {
  const int r0 = g.rank();
  const int nt = g.size();
  float* src = m.band;
  float* dst = m.band + 3 * N;
  int s = 1;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    g.sync();  // the bands of this round are complete
    const float* a = src;
    const float* b = src + N;
    const float* c = src + 2 * N;
    for (int i = r0; i < N; i += nt) {
      const int im = (i - s + N) % N;
      const int ip = (i + s) % N;
      const float bm = b[im] == 0.0f ? 1.0f : b[im];
      const float bp = b[ip] == 0.0f ? 1.0f : b[ip];
      const float alpha = -a[i] / bm;
      const float gamma = -c[i] / bp;
      m.alpha[l * N + i] = alpha;
      m.gamma[l * N + i] = gamma;
      dst[i] = alpha * a[im];
      dst[2 * N + i] = gamma * c[ip];
      dst[N + i] = b[i] + alpha * c[im] + gamma * a[ip];
    }
    float* t = src;
    src = dst;
    dst = t;
    s *= 2;
  }
  for (int i = r0; i < N; i += nt) {
    const float den = src[i] + src[N + i] + src[2 * N + i];
    m.den[i] = den == 0.0f ? 1.0f : den;
  }
}

// W x = d for the right-hand side in m.rhs (own elements written by the
// caller, a barrier between the last solve's reads and that write): the
// multipliers replayed, L rounds with a barrier each.  Returns the row that
// holds x (own elements final).
template <class Group>
__device__ float* pcr_solve(Group& g, const Rows& m) {
  const int r0 = g.rank();
  const int nt = g.size();
  float* src = m.rhs;
  float* dst = m.rhs + N;
  int s = 1;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    g.sync();
    for (int i = r0; i < N; i += nt) {
      dst[i] = src[i] + m.alpha[l * N + i] * src[(i - s + N) % N] +
               m.gamma[l * N + i] * src[(i + s) % N];
    }
    float* t = src;
    src = dst;
    dst = t;
    s *= 2;
  }
  for (int i = r0; i < N; i += nt) src[i] = src[i] / m.den[i];
  return src;
}

// Modified Newton for one stage of the group: z (m.z) from its predictor to
// the stage increment.  Returns converged; sets the stage's rate (>= 0),
// its RHS evaluations and whether a non-finite value stopped it.
template <class Group>
__device__ bool newton(Group& g, const Rows& m, float t_stage, float h,
                       const Launch& Lc, float& rate_out, int& nfev,
                       bool& bad_any) {
  const int r0 = g.rank();
  const int nt = g.size();
  esdirk::Newton nw;
  bool conv = false;
  nfev = 0;
  bad_any = false;
#pragma unroll 1
  for (int it = 0; it < tab::NEWTON_MAXITER; ++it) {
    for (int i = r0; i < N; i += nt) m.pred[i] = m.psi[i] + tab::D * m.z[i];
    g.sync();  // the point complete before the RHS reads neighbours
    float nbad = 0.0f;
    for (int i = r0; i < N; i += nt) {
      const float fi = finite_or_one(rhs(t_stage, m.pred, i, nullptr), nbad);
      const float mi = m.mass[i];
      m.rhs[i] = mi == 0.0f ? fi * tab::INV_D : h * fi - mi * m.z[i];
    }
    nfev += 1;
    float* dz = pcr_solve(g, m);
    float sq = 0.0f;
    for (int i = r0; i < N; i += nt) {
      dz[i] = finite_or_one(dz[i], nbad);
      const float scale =
          Lc.atol + Lc.rtol * fmaxf(fabsf(m.y[i]), fabsf(m.pred[i]));
      const float q = dz[i] / scale;
      sq = sq + q * q;
    }
    float dz_norm = sqrtf(g.sum(sq) / static_cast<float>(N));
    if (!isfinite(dz_norm)) {
      dz_norm = 1.0f;
      nbad += 1.0f;
    }
    const bool bad = g.sum(nbad) != 0.0f;
    const bool stop = nw.test(it, dz_norm, Lc.tiny_err, bad, conv);
    if (!bad) {
      for (int i = r0; i < N; i += nt) m.z[i] = m.z[i] + dz[i];
    }
    bad_any = bad_any || bad;
    if (stop) break;
  }
  rate_out = fmaxf(nw.rate, 0.0f);
  return conv;
}

// One attempt's stage results, the same in every thread.
struct StageSum {
  float Rate;
  int nfev;
  bool conv;
};

// Stages I..S-1 of one attempt; K[0] (and Z[0]) hold the first stage.
template <bool COMP, int I, class Group>
__device__ __forceinline__ void stages(Group& g, const Rows& m, StageSum& st,
                                       float tc, float h, const Launch& Lc) {
  if constexpr (I < S) {
    const int r0 = g.rank();
    const int nt = g.size();
    for (int i = r0; i < N; i += nt) {
      if constexpr (COMP) {
        float acc, cmp;
        rk::col_comp_wsum<RowA<I>, I, N>(m.Z, i, acc, cmp);
        m.psi[i] = m.y[i] + (acc + (cmp + m.ylo[i]));
      } else {
        m.psi[i] = m.y[i] + h * rk::col_wsum<RowA<I>, I, N>(m.K, i);
      }
      m.z[i] = h * rk::col_wsum<RowAz<I>, I, N>(m.K, i);
    }
    constexpr float c = tab::C(I);
    float rate;
    int nf;
    bool bad;
    const bool conv = newton(g, m, tc + c * h, h, Lc, rate, nf, bad);
    st.conv = st.conv && conv && !bad;
    st.Rate = fmaxf(st.Rate, rate);
    st.nfev += nf;
    const float inv_h = 1.0f / h;
    for (int i = r0; i < N; i += nt) {
      m.K[I * N + i] = m.z[i] * inv_h;
      if constexpr (COMP) m.Z[I * N + i] = m.z[i];
    }
    stages<COMP, I + 1>(g, m, st, tc, h, Lc);
  }
}

// A member's start: y, the mass row, yp (given, or M^-1 f(t0, y0)) and the
// first |h| (given, Watts' start for plain ODEs, or 1% of the span).
template <class Group>
__device__ float start(Group& g, const Rows& m, const float* __restrict__ y0,
                       const float* __restrict__ yp0,
                       const float* __restrict__ mass, float dir,
                       const Launch& Lc) {
  const int r0 = g.rank();
  const int nt = g.size();
  for (int i = r0; i < N; i += nt) {
    m.y[i] = y0[i];
    m.ylo[i] = 0.0f;
    m.mass[i] = mass ? mass[i] : 1.0f;
  }
  if (Lc.have_yp0) {
    for (int i = r0; i < N; i += nt) m.yp[i] = yp0[i];
  } else {
    g.sync();  // y complete before the RHS reads neighbours
    for (int i = r0; i < N; i += nt) {
      const float f = rhs(Lc.t0, m.y, i, nullptr);
      m.yp[i] = mass ? f / m.mass[i] : f;
    }
  }
  if (!Lc.use_hstart) return Lc.h0;
  // plain ODEs only; the six scratch rows are the two sets of bands, the
  // first holding f(t0, y); max_step is +inf when the caller gave none
  for (int i = r0; i < N; i += nt) m.band[i] = m.yp[i];
  g.sync();  // y complete (when yp0 was given) before the start reads it
  const float bq = Lc.t0 + dir * fminf(fabsf(Lc.tf - Lc.t0), Lc.max_step);
  return fabsf(rk::block_hstart<N, tab::MORDER>(g, Deriv{}, Lc.t0, bq, m.y,
                                               m.band, Lc.rtol, Lc.atol));
}

// The whole integration of one member by the group g (rank(), size(),
// sync() and sum(x), a reduction whose result every thread holds, and
// min(x) for the start).  sm is the member's shared memory (kFloats).
template <bool COMP, class Group>
__device__ void integrate(Group& g, float* sm, const float* __restrict__ y0,
                          const float* __restrict__ yp0,
                          const float* __restrict__ mass, const Launch& Lc,
                          int member, const Out& out) {
  const int r0 = g.rank();
  const int nt = g.size();
  const Rows m = rows(sm);
  const float span = Lc.tf - Lc.t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  esdirk::Control ctl{start(g, m, y0, yp0, mass, dir, Lc)};
  float t = Lc.t0;
  float t_lo = 0.0f;
  int status = kRunning;
  int nstep = 0;
  int nfev = Lc.have_yp0 ? 0 : 1;
  int it = 0;

  while (status == kRunning) {
    // step-size limits and the landing on tf, every attempt
    const float tc = t + t_lo;
    ctl.prepare(t, t_lo, Lc.tf, Lc.max_step);
    const float ha = ctl.ha;
    const float h = ha * dir;
    const float hd = h * tab::D;

    // the Newton matrix and its reduction, once per attempt
    newton_matrix(g, m, tc, hd);
    pcr_factor(g, m);

    // stages (stage 0 explicit: K0 = yp; h K_j == z_j)
    for (int i = r0; i < N; i += nt) {
      m.K[i] = m.yp[i];
      if constexpr (COMP) m.Z[i] = h * m.yp[i];
    }
    StageSum st{0.0f, 0, !ctl.too_small};
    stages<COMP, 1>(g, m, st, tc, h, Lc);

    // solution and error estimate; stiffly accurate: y_new = psi + d z of
    // the last stage
    float nbad = 0.0f;
    for (int i = r0; i < N; i += nt) {
      float yn, yln, err;
      if constexpr (COMP) {
        float inc_s, inc_c, hi, lo1, e_s, e_c;
        rk::col_comp_wsum<RowA<S - 1>, S, N>(m.Z, i, inc_s, inc_c);
        rk::df_add(m.y[i], m.ylo[i], inc_s, hi, lo1);
        rk::two_sum(hi, __fadd_rn(lo1, inc_c), yn, yln);
        rk::col_comp_wsum<RowE, S, N>(m.Z, i, e_s, e_c);
        err = e_s + e_c;
      } else {
        yn = m.psi[i] + tab::D * m.z[i];
        yln = m.ylo[i];
        err = h * rk::col_wsum<RowE, S, N>(m.K, i);
      }
      m.ynew[i] = finite_or_one(yn, nbad);
      m.ylonew[i] = yln;
      m.rhs[i] = err;
    }
    float* err = m.rhs;
    if constexpr (tab::FILTER_ERROR) {
      const float inv_hd = 1.0f / hd;
      for (int i = r0; i < N; i += nt) {
        if (m.mass[i] == 0.0f) m.rhs[i] = m.rhs[i] * inv_hd;
      }
      err = pcr_solve(g, m);
      for (int i = r0; i < N; i += nt) err[i] = m.mass[i] * err[i];
    }
    float sq = 0.0f;
    for (int i = r0; i < N; i += nt) {
      const float scale =
          Lc.atol + Lc.rtol * fmaxf(fabsf(m.y[i]), fabsf(m.ynew[i]));
      const float q = err[i] / scale;
      sq = sq + q * q;
    }
    float err_norm = sqrtf(g.sum(sq) / static_cast<float>(N));
    if (!isfinite(err_norm)) {
      err_norm = 1.0f;
      nbad += 1.0f;
    }
    const bool bad_m = g.sum(nbad) != 0.0f;
    if (bad_m) err_norm = err_norm + 10.0f;
    const bool accepted = st.conv && err_norm < 1.0f && !bad_m;

    // implicit controller and the rate-based reduction after a convergence
    // failure (esdirk_control.cuh)
    ctl.finish(err_norm, st.Rate, st.conv, accepted, h, Lc.tiny_err);
    if (ctl.too_small) status = kTooSmall;
    // double-single t advance; the landing test uses the remainder
    float t_adv, t_lo_adv;
    rk::df_add(t, t_lo, h, t_adv, t_lo_adv);
    const float rem = (Lc.tf - t_adv) - t_lo_adv;
    const bool is_last = accepted && fabsf(rem) <= tab::LAND_TOL * ha;
    if (status == kRunning && is_last) status = kFinished;
    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (status == kRunning && it >= Lc.max_steps) status = kOverflow;

    if (accepted) {
      float unused = 0.0f;
      for (int i = r0; i < N; i += nt) {
        m.y[i] = m.ynew[i];
        m.ylo[i] = m.ylonew[i];
        m.yp[i] = finite_or_one(m.K[(S - 1) * N + i], unused);
      }
      t = is_last ? Lc.tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
      nstep += 1;
    }
    nfev += st.nfev;
  }

  g.sync();
  for (int i = r0; i < N; i += nt) {
    out.y[static_cast<size_t>(member) * N + i] = m.y[i];
  }
  if (r0 == 0) {
    out.status[member] = status;
    out.nsteps[member] = nstep;
    out.nfev[member] = nfev;
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "block_group.cuh"

namespace {

template <bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
    fused_esdirk_grid_kernel(const float* __restrict__ y0,
                             const float* __restrict__ yp0,
                             const float* __restrict__ mass, Launch Lc,
                             Out out) {
  extern __shared__ float sm[];
  __shared__ float red[64];
  BlockGroup g{red};
  const int member = blockIdx.x;
  const size_t off = static_cast<size_t>(member) * N;
  integrate<COMP>(g, sm, y0 + off, yp0 ? yp0 + off : nullptr, mass, Lc,
                  member, out);
}

}  // namespace

// The shared memory one member needs and the most a block may have on this
// card, in bytes; returns the CUDA error code.
extern "C" int fused_esdirk_grid_smem(int* need, int* limit) {
  int dev = 0;
  cudaGetDevice(&dev);
  *need = static_cast<int>(kFloats * sizeof(float));
  cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(cudaGetLastError());
}

// Launches one block of `threads` (a multiple of 32, at most kMaxThreads)
// per member on the caller's stream, with the member's rows as dynamic
// shared memory (above 48 KB after cudaFuncSetAttribute), and returns the
// CUDA error code; the wrapper raises on anything but 0.  yp0 may be null
// when have_yp0 is 0, mass null for ODEs.
extern "C" int fused_esdirk_grid_launch(
    const void* y0, const void* yp0, const void* mass, void* y_out,
    void* status, void* nstep, void* nfev, int members, float t0, float tf,
    float rtol, float atol, float h0, int use_hstart, int have_yp0,
    float max_step, int max_steps, float tiny_err, int compensated,
    int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch Lc{t0,         tf,        rtol,     atol,      h0,
                  use_hstart, have_yp0,  max_step, max_steps, tiny_err};
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  const int bytes = static_cast<int>(kFloats * sizeof(float));
  void (*kernel)(const float*, const float*, const float*, Launch, Out) =
      compensated ? fused_esdirk_grid_kernel<true>
                  : fused_esdirk_grid_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<members, threads, bytes, st>>>(
      static_cast<const float*>(y0), static_cast<const float*>(yp0),
      static_cast<const float*>(mass), Lc, out);
  return static_cast<int>(cudaGetLastError());
}
