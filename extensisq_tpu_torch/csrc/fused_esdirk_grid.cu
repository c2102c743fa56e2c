// Fused adaptive ESDIRK ensemble solver for mid-size stiff systems and
// index-1 DAEs on Hopper (sm_90a): tridiagonal Newton matrices solved by
// parallel cyclic reduction, the whole implicit integration of each member
// in one launch, one thread block or one warp per member.
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
// the point where f is evaluated, four rows of dual numbers, the Newton
// matrix's three bands (two sets, used in turn by the reduction), the
// reduction's multipliers alpha[L][N] and gamma[L][N] with L = ceil(log2 N)
// and its final diagonal, and two right-hand-side rows live in shared
// memory: (25 + 2 S + 2 L) N floats plus the mass row, 24 KB for Kv3I at
// N = 128.
//
// The simultaneous corrector (tab::NB < N: the sensitivities' block_base,
// ops/fused_sens.py).  The state is N / NB blocks [y | s_1 .. s_k] of NB
// rows whose Jacobian is block lower triangular with every diagonal block
// the base block's J.  The bands come from the base block alone: the dual
// rows hold NB elements, seeded on the base block's columns with the same
// mod-4 rule, and the evaluation is base_rhs<Dual>, the user's right-hand
// side (never the augmented rhs on duals, which would need duals of
// duals).  The multipliers are computed once an attempt on the ring of NB
// rows, L = ceil(log2 NB) rounds, and replayed on each block of NB rows in
// every Newton iteration and in the error filter's solve: block-diag(W,
// ..., W), the JAX _pcr_solve(..., pos, nb) without its per-block lane
// padding.  So the dual rows, the bands, the multipliers and the final
// diagonal take NB columns; the other rows, the Newton and error norms and
// the Newton floor (tiny_err) are the whole augmented state's.  The block
// start's six scratch rows then lie over the stage rows, which the first
// attempt writes before it reads them.  Both groups run it (a warp member
// as a block member); the wrapper's rule takes the shape from N.
//
// One body, integrate<COMP, Group>, runs on two groups
// (block_group.cuh): a block of 32-256 threads per member (BlockGroupOf<2>)
// or one warp per member (WarpGroup: __syncwarp and shuffle butterflies,
// no block barrier, P members a block, each warp on its own rows).
// Element i belongs to the thread of rank i mod (group size), which does
// every per-element operation on it; a warp's lane holds N / 32 elements
// and computes the values of all of them before it stores any
// (rk::for_elements_put), so that their chains overlap.  The warp body is
// the block body at 32 threads bit for bit.  The per-member scalars (t, h,
// the Newton rate, the controller of esdirk_control.cuh) are computed by
// every thread from identical inputs, so every thread takes the same
// branches.  Per attempt:
//  * the bands of J at (t, y): four rows of rhs<Dual>, element j of row c
//    seeded with the tangent (j % 4 == c), all four seeded before one
//    barrier; the tangent at i gives J[i, i-1], J[i, i] or J[i, i+1] where
//    (i + 3) % 4, i % 4 or (i + 1) % 4 equals c (the exact JVP of
//    jax.linearize, not counted in nfev), summed in column order, and
//    W = M - h d J (algebraic rows -J) from them;
//  * the cyclic reduction's multipliers, once: L rounds, one barrier each;
//  * each stage by modified Newton: per iteration one RHS evaluation (a
//    barrier before it), the reduction replayed on the right-hand side (L
//    rounds, a barrier each), and one group reduction of two sums (the
//    update's norm and its count of non-finite values);
//  * the solution, the filtered or plain error (one more replay), its norm
//    and non-finite count in one reduction, and B2's implicit controller.
//
// What bounds it on the H100: per Newton iteration an element costs one RHS
// (a stencil of a few flops on shared memory) and 4 flops per reduction
// round, and the iteration costs L + 2 barriers or reductions; at N =
// 128-256 that is latency, not the card's flop or byte rate.  A block
// spends it at the barriers (one element a thread); a warp at its lanes'
// chains (4 elements a lane at N = 128, two IEEE divisions an element in
// each round of the factor), with no barrier to wait at; the wrapper's rule
// (ops/fused_esdirk_grid.py:_launch_shape) takes the faster of the two by
// the ensemble's size, from a measured sweep.

// Dense output (dense=R, ops/fused_esdirk_grid.py): a build whose header
// sets tab::REC writes each accepted step's end (t, y, y') to its member's
// rows in device memory (dense_record.cuh), y' the stiffly accurate last
// stage the loop carries: every thread the elements of y and y' it
// commits, as it commits them, rank 0 the step's t; f0 is the start's y',
// each thread its own elements.  The writes sit beside the arithmetic,
// which they leave as it is; without tab::REC the record parameter is
// never read and the kernels are those of the build before dense output.
//
// t_eval snapshots (ops/fused_esdirk_grid.py): a build whose header sets
// tab::SNAP writes each point's row (snapshot.cuh) as the member's accepted
// step crosses it, the cubic Hermite of the step's end pairs (y, y') and
// (y_new, y'_new), y' the carried stiffly accurate last stage and y'_new
// this step's, scrubbed as the commit carries it: every thread the
// elements it commits, before it overwrites them (the high words of y and
// t in the compensated mode), each thread holding the member's cursor into
// the sorted points; points at or before t0 take y0 and the points left at
// the end the final y, each thread its own elements.  The four outputs are
// those of the build without it; without tab::SNAP the snapshot parameter
// is never read.
//
// The generated header fused_esdirk_grid_config.cuh provides
//   namespace tab { G = grid::Grid<N>, N, NB, L, NPAR, REC, SNAP, S,
//                   MORDER,
//                   NEWTON_MAXITER, FILTER_ERROR, D, INV_D, KAPPA,
//                   controller and start constants, the accessors A(i, j),
//                   AZ(i, j), C(i), E(j) }
//   template <class T> __device__ T rhs(T t, const T* y, int i,
//                                       const T* p);
// (with NPAR = 0 p may be `const float*`: it is a null pointer), and with
// NB < N also base_rhs, the base block's; neighbours come from
// tab::G::rolled.  p is the member's NPAR parameters, loaded once into its
// shared memory and promoted to duals of zero tangent for the bands, so
// that the Jacobian is d f / d y at fixed p, as jax.linearize takes it.
// The mass diagonal is an input (all ones for ODEs), zeros marking
// algebraic rows.
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

#include "dense_record.cuh"
#include "dual.cuh"
#include "grid_common.cuh"
#include "fused_esdirk_grid_config.cuh"
#include "esdirk_control.cuh"
#include "block_hstart.cuh"
#include "block_rows.cuh"
#include "rk_common.cuh"
#include "snapshot.cuh"

namespace {

using tab::L;
using tab::N;
using tab::NB;
using tab::S;
constexpr bool kBlock = NB < N;  // the simultaneous corrector
using rk::Rec;
using rk::Snap;
using esdirk::RowA;
using esdirk::RowAz;
using esdirk::RowE;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;
constexpr int kMaxThreads = 256;

// Shared-memory layout of a member, in floats; the dual rows come first, so
// that they are aligned for their 8-byte elements (a member's size is even,
// so that the members of a warp-per-member block stay aligned too).
constexpr int kDual = 0;                 // four rows of Dual, 8 NB
constexpr int kY = kDual + 8 * NB;       // state
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
constexpr int kBand = kRhs + 2 * N;      // two sets of bands a, b, c, NB
constexpr int kAlpha = kBand + 6 * NB;   // alpha[L][NB]
constexpr int kGamma = kAlpha + L * NB;  // gamma[L][NB]
constexpr int kDen = kGamma + L * NB;    // the final diagonal, NB
constexpr int kPar = kDen + NB;          // the member's parameters, NPAR
constexpr int kFloats = (kPar + tab::NPAR + 1) & ~1;
static_assert(N % NB == 0, "the base block divides the state");

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

// Pointers into a member's shared memory; par is null without parameters.
struct Rows {
  Dual* dual;
  float *y, *ylo, *yp, *mass, *K, *Z, *psi, *z, *pred, *ynew, *ylonew;
  float *rhs, *band, *alpha, *gamma, *den;
  const float* par;
};

__device__ __forceinline__ Rows rows(float* sm) {
  return Rows{reinterpret_cast<Dual*>(sm + kDual),
              sm + kY, sm + kYlo, sm + kYp, sm + kMass, sm + kK, sm + kZ,
              sm + kPsi, sm + kZc, sm + kPred, sm + kYnew, sm + kYlonew,
              sm + kRhs, sm + kBand, sm + kAlpha, sm + kGamma, sm + kDen,
              tab::NPAR > 0 ? sm + kPar : nullptr};
}

// The member's parameters into its shared memory (the caller's barrier
// publishes them).
template <class Group>
__device__ __forceinline__ void load_params(const Group& g, float* sm,
                                            const float* __restrict__ params,
                                            int member) {
  if constexpr (tab::NPAR > 0) {
    rk::for_elements<tab::NPAR>(g, [&](int q) {
      sm[kPar + q] = params[static_cast<size_t>(member) * tab::NPAR + q];
    });
  }
}

// Element i of the bands' dual evaluation on the dual rows y: rhs<Dual>, or
// with the simultaneous corrector base_rhs<Dual> on the base block, with
// the member's parameters P as duals of zero tangent.  A template of the
// state's type, so that only the evaluation the build takes is compiled.
template <class V>
__device__ __forceinline__ Dual band_rhs(float tc, V y, int i,
                                         const float* P) {
  const auto eval = [&](auto p) {
    if constexpr (kBlock) {
      return base_rhs(Dual(tc), y, i, p);
    } else {
      return rhs(Dual(tc), y, i, p);
    }
  };
  if constexpr (tab::NPAR > 0) {
    Dual pd[tab::NPAR];
#pragma unroll
    for (int q = 0; q < tab::NPAR; ++q) pd[q] = Dual(P[q]);
    return eval(static_cast<const Dual*>(pd));
  } else {
    return eval(nullptr);  // a null p for sources typed const float* p
  }
}

// x, or 1 with `bad` counted where x is not finite (the JAX kernel's
// scrub).
__device__ __forceinline__ float finite_or_one(float x, float& bad) {
  if (isfinite(x)) return x;
  bad += 1.0f;
  return 1.0f;
}

// Section clocks of one member, in the probe's build only
// (tools/probe_fused_esdirk_grid.py compiles with
// FUSED_ESDIRK_GRID_SECTIONS): the SM cycles rank 0 spends in each part of
// the attempts, summed over them, and the attempts.  A thread waiting at a
// barrier counts the wait in the part that ends with it.  The shipped
// build's Clock is empty and compiles to nothing.
enum Section {
  kBands,       // the dual passes and the bands of W
  kFactor,      // the reduction's multipliers
  kNewtonRhs,   // the Newton point and its RHS
  kReplay,      // the multipliers replayed on a Newton right-hand side
  kNewtonTest,  // the update's norm, the convergence tests, z += dz
  kStage,       // the stage predictors and K, Z
  kError,       // y_new, the error estimate, its filter solve and norm
  kControl,     // the step-size limits, the controller, t and status
  kSections
};
// a member's row of the probe's counters: the sections' cycles, the barrier
// phases (syncs and reductions) and the attempts
constexpr int kPhases = kSections;
constexpr int kAttempts = kSections + 1;
constexpr int kSectionSlots = kSections + 2;
#ifdef FUSED_ESDIRK_GRID_SECTIONS
__device__ unsigned* g_sections;  // [member][kSectionSlots]
struct Clock {
  unsigned acc[kSections];
  unsigned last;
  __device__ Clock() : last(static_cast<unsigned>(clock())) {
#pragma unroll
    for (int k = 0; k < kSections; ++k) acc[k] = 0u;
  }
  __device__ void mark(int section) {
    const unsigned now = static_cast<unsigned>(clock());
    acc[section] += now - last;
    last = now;
  }
  __device__ void write(int member, int attempts) const {
    unsigned* row = g_sections + static_cast<size_t>(member) * kSectionSlots;
#pragma unroll
    for (int k = 0; k < kSections; ++k) row[k] = acc[k];
    row[kAttempts] = static_cast<unsigned>(attempts);
  }
};
#else
struct Clock {
  __device__ void mark(int) {}
  __device__ void write(int, int) const {}
};
#endif

// The element derivative as the block start calls it.
struct Deriv {
  const float* P;
  __device__ float operator()(float t, const float* Y, int j) const {
    return rhs(t, Y, j, P);
  }
};

// W = M - h d J at (tc, y) into the first set of bands (a = lower, b =
// diagonal, c = upper): four dual rows with striped tangents, seeded at
// once, so that one barrier serves the four passes; each band entry sums
// the passes in column order.  With the simultaneous corrector, the base
// block's NB rows and columns.
struct Tri {  // an element's entries of three bands
  float a, b, c;
};
template <class Group>
__device__ void newton_matrix(Group& g, const Rows& m, float tc, float hd) {
  rk::for_elements<NB>(g, [&](int j) {
    const float yj = m.y[j];
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const float seed = (j % 4 == col) ? 1.0f : 0.0f;
      m.dual[col * NB + j] = Dual(yj, seed + yj * 0.0f);
    }
  });
  g.sync();  // the dual rows complete before the RHS reads neighbours
  rk::for_elements_put<NB>(
      g,
      [&](int i) {
        float a = 0.0f, b = 0.0f, c = 0.0f;
#pragma unroll
        for (int col = 0; col < 4; ++col) {
          const float jv =
              band_rhs(tc, static_cast<const Dual*>(m.dual + col * NB), i,
                       m.par)
                  .d;
          a = a + ((i + 3) % 4 == col ? 1.0f : 0.0f) * jv;
          b = b + (i % 4 == col ? 1.0f : 0.0f) * jv;
          c = c + ((i + 1) % 4 == col ? 1.0f : 0.0f) * jv;
        }
        const float mi = m.mass[i];
        const bool alg = mi == 0.0f;
        return Tri{alg ? -a : -hd * a, alg ? -b : mi - hd * b,
                   alg ? -c : -hd * c};
      },
      [&](int i, const Tri& w) {
        m.band[i] = w.a;
        m.band[NB + i] = w.b;
        m.band[2 * NB + i] = w.c;
      });
}

// The per-element loops of the reduction and of a Newton iteration, each
// reading rows other than those it writes (__restrict__): a warp's lane
// computes the values of all its elements (4 at N = 128) before it stores
// them (rk::for_elements_put), so that their chains overlap.  The
// arithmetic is the parent's, expression for expression.

// One round of the multipliers: bands (a, b, c) of the round into its
// multipliers and the next round's bands (da, db, dc), on the ring of NB
// rows.
struct FactorRow {
  float alpha, gamma, a, b, c;
};
template <class Group>
__device__ __forceinline__ void factor_round(
    const Group& g, const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, float* __restrict__ alpha_l,
    float* __restrict__ gamma_l, float* __restrict__ da,
    float* __restrict__ db, float* __restrict__ dc, int s) {
  rk::for_elements_put<NB>(
      g,
      [&](int i) {
        const int im = (i - s + NB) % NB;
        const int ip = (i + s) % NB;
        const float bm = b[im] == 0.0f ? 1.0f : b[im];
        const float bp = b[ip] == 0.0f ? 1.0f : b[ip];
        const float alpha = -a[i] / bm;
        const float gamma = -c[i] / bp;
        return FactorRow{alpha, gamma, alpha * a[im],
                         b[i] + alpha * c[im] + gamma * a[ip],
                         gamma * c[ip]};
      },
      [&](int i, const FactorRow& f) {
        alpha_l[i] = f.alpha;
        gamma_l[i] = f.gamma;
        da[i] = f.a;
        db[i] = f.b;
        dc[i] = f.c;
      });
}

// One round of the replay: src into dst with the round's multipliers;
// with the simultaneous corrector on each block of NB rows, row r of a
// block coupled to its block's rows r -/+ s (mod NB).
template <class Group>
__device__ __forceinline__ void replay_round(
    const Group& g, const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ alpha_l, const float* __restrict__ gamma_l,
    int s) {
  rk::for_elements_put<N>(
      g,
      [&](int i) {
        if constexpr (kBlock) {
          const int r = i % NB;
          const int o = i - r;
          return src[i] + alpha_l[r] * src[o + (r - s + NB) % NB] +
                 gamma_l[r] * src[o + (r + s) % NB];
        } else {
          return src[i] + alpha_l[i] * src[(i - s + N) % N] +
                 gamma_l[i] * src[(i + s) % N];
        }
      },
      [&](int i, float x) { dst[i] = x; });
}

// The Newton point psi + d z into pred.
template <class Group>
__device__ __forceinline__ void newton_point(const Group& g,
                                             const float* __restrict__ psi,
                                             const float* __restrict__ z,
                                             float* __restrict__ pred) {
  rk::for_elements_put<N>(
      g, [&](int i) { return psi[i] + tab::D * z[i]; },
      [&](int i, float x) { pred[i] = x; });
}

// The Newton right-hand side at the point pred into out, non-finite RHS
// values counted in nbad.
template <class Group>
__device__ __forceinline__ void newton_rhs(
    const Group& g, float t_stage, float h, const float* __restrict__ pred,
    const float* __restrict__ mass, const float* __restrict__ z,
    float* __restrict__ out, const float* P, float& nbad) {
  rk::for_elements_put<N>(
      g,
      [&](int i) {
        const float fi = finite_or_one(rhs(t_stage, pred, i, P), nbad);
        const float mi = mass[i];
        return mi == 0.0f ? fi * tab::INV_D : h * fi - mi * z[i];
      },
      [&](int i, float x) { out[i] = x; });
}

// The update dz scrubbed (non-finite values counted in nbad) and the sum of
// its squares scaled by atol + rtol max(|y|, |pred|), in element order.
template <class Group>
__device__ __forceinline__ float newton_sq(const Group& g,
                                           float* __restrict__ dz,
                                           const float* __restrict__ y,
                                           const float* __restrict__ pred,
                                           const Launch& Lc, float& nbad) {
  float sq = 0.0f;
  rk::for_elements_put<N>(
      g,
      [&](int i) {
        const float d = finite_or_one(dz[i], nbad);
        const float scale =
            Lc.atol + Lc.rtol * fmaxf(fabsf(y[i]), fabsf(pred[i]));
        const float q = d / scale;
        sq = sq + q * q;
        return d;
      },
      [&](int i, float d) { dz[i] = d; });
  return sq;
}

// The cyclic reduction's multipliers of the bands in m.band: round l
// couples equation i to i -/+ 2^l (indices mod NB); the bands of the next
// round go to the other set.
template <class Group>
__device__ void pcr_factor(Group& g, const Rows& m) {
  float* src = m.band;
  float* dst = m.band + 3 * NB;
  int s = 1;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    g.sync();  // the bands of this round are complete
    factor_round(g, src, src + NB, src + 2 * NB, m.alpha + l * NB,
                 m.gamma + l * NB, dst, dst + NB, dst + 2 * NB, s);
    float* t = src;
    src = dst;
    dst = t;
    s *= 2;
  }
  rk::for_elements<NB>(g, [&](int i) {
    const float den = src[i] + src[NB + i] + src[2 * NB + i];
    m.den[i] = den == 0.0f ? 1.0f : den;
  });
}

// W x = d for the right-hand side in m.rhs (own elements written by the
// caller, a barrier between the last solve's reads and that write): the
// multipliers replayed, L rounds with a barrier each.  Returns the row that
// holds x (own elements final).
template <class Group>
__device__ float* pcr_solve(Group& g, const Rows& m) {
  float* src = m.rhs;
  float* dst = m.rhs + N;
  int s = 1;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    g.sync();
    replay_round(g, src, dst, m.alpha + l * NB, m.gamma + l * NB, s);
    float* t = src;
    src = dst;
    dst = t;
    s *= 2;
  }
  rk::for_elements<N>(g, [&](int i) {
    src[i] = src[i] / m.den[kBlock ? i % NB : i];
  });
  return src;
}

// Modified Newton for one stage of the group: z (m.z) from its predictor to
// the stage increment.  Returns converged; sets the stage's rate (>= 0),
// its RHS evaluations and whether a non-finite value stopped it.
template <class Group>
__device__ bool newton(Group& g, const Rows& m, float t_stage, float h,
                       const Launch& Lc, float& rate_out, int& nfev,
                       bool& bad_any, Clock& clk) {
  esdirk::Newton nw;
  bool conv = false;
  nfev = 0;
  bad_any = false;
#pragma unroll 1
  for (int it = 0; it < tab::NEWTON_MAXITER; ++it) {
    newton_point(g, m.psi, m.z, m.pred);
    g.sync();  // the point complete before the RHS reads neighbours
    float nbad = 0.0f;
    newton_rhs(g, t_stage, h, m.pred, m.mass, m.z, m.rhs, m.par, nbad);
    nfev += 1;
    clk.mark(kNewtonRhs);
    float* dz = pcr_solve(g, m);
    clk.mark(kReplay);
    const float sq = newton_sq(g, dz, m.y, m.pred, Lc, nbad);
    // the norm and the count of non-finite values in one reduction
    float v[2] = {sq, nbad};
    g.sums(v);
    float dz_norm = sqrtf(v[0] / static_cast<float>(N));
    const bool bad = v[1] != 0.0f || !isfinite(dz_norm);
    if (!isfinite(dz_norm)) dz_norm = 1.0f;
    const bool stop = nw.test(it, dz_norm, Lc.tiny_err, bad, conv);
    if (!bad) {
      rk::for_elements<N>(g, [&](int i) { m.z[i] = m.z[i] + dz[i]; });
    }
    bad_any = bad_any || bad;
    clk.mark(kNewtonTest);
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
                                       float tc, float h, const Launch& Lc,
                                       Clock& clk) {
  if constexpr (I < S) {
    rk::for_elements<N>(g, [&](int i) {
      if constexpr (COMP) {
        float acc, cmp;
        rk::col_comp_wsum<RowA<I>, I, N>(m.Z, i, acc, cmp);
        m.psi[i] = m.y[i] + (acc + (cmp + m.ylo[i]));
      } else {
        m.psi[i] = m.y[i] + h * rk::col_wsum<RowA<I>, I, N>(m.K, i);
      }
      m.z[i] = h * rk::col_wsum<RowAz<I>, I, N>(m.K, i);
    });
    clk.mark(kStage);
    constexpr float c = tab::C(I);
    float rate;
    int nf;
    bool bad;
    const bool conv = newton(g, m, tc + c * h, h, Lc, rate, nf, bad, clk);
    st.conv = st.conv && conv && !bad;
    st.Rate = fmaxf(st.Rate, rate);
    st.nfev += nf;
    const float inv_h = 1.0f / h;
    rk::for_elements<N>(g, [&](int i) {
      m.K[I * N + i] = m.z[i] * inv_h;
      if constexpr (COMP) m.Z[I * N + i] = m.z[i];
    });
    clk.mark(kStage);
    stages<COMP, I + 1>(g, m, st, tc, h, Lc, clk);
  }
}

// A member's start: y, the mass row, yp (given, or M^-1 f(t0, y0)) and the
// first |h| (given, Watts' start for plain ODEs, or 1% of the span).
template <class Group>
__device__ float start(Group& g, const Rows& m, const float* __restrict__ y0,
                       const float* __restrict__ yp0,
                       const float* __restrict__ mass, float dir,
                       const Launch& Lc) {
  rk::for_elements<N>(g, [&](int i) {
    m.y[i] = y0[i];
    m.ylo[i] = 0.0f;
    m.mass[i] = mass ? mass[i] : 1.0f;
  });
  if (Lc.have_yp0) {
    rk::for_elements<N>(g, [&](int i) { m.yp[i] = yp0[i]; });
  } else {
    g.sync();  // y complete before the RHS reads neighbours
    rk::for_elements<N>(g, [&](int i) {
      const float f = rhs(Lc.t0, m.y, i, m.par);
      m.yp[i] = mass ? f / m.mass[i] : f;
    });
  }
  if (!Lc.use_hstart) return Lc.h0;
  // plain ODEs only; the six scratch rows are the rows from K on (2 S + 7
  // rows before the bands), the first holding f(t0, y); max_step is +inf
  // when the caller gave none
  float* w = m.K;
  rk::for_elements<N>(g, [&](int i) { w[i] = m.yp[i]; });
  g.sync();  // y complete (when yp0 was given) before the start reads it
  const float bq = Lc.t0 + dir * fminf(fabsf(Lc.tf - Lc.t0), Lc.max_step);
  return fabsf(rk::block_hstart<N, tab::MORDER>(g, Deriv{m.par}, Lc.t0, bq,
                                               m.y, w, Lc.rtol, Lc.atol));
}

// The whole integration of one member by the group g (rank(), size(),
// sync() and sum(x), a reduction whose result every thread holds, and
// min(x) for the start).  sm is the member's shared memory (kFloats),
// params every member's NPAR parameters (null without any), rec the record
// with tab::REC, snap the t_eval rows with tab::SNAP.
template <bool COMP, class Group>
__device__ void integrate(Group& g, float* sm, const float* __restrict__ y0,
                          const float* __restrict__ yp0,
                          const float* __restrict__ mass,
                          const float* __restrict__ params, const Launch& Lc,
                          int member, const Out& out,
                          const Rec& rec = Rec{},
                          const Snap& snap = Snap{}) {
  const Rows m = rows(sm);
  load_params(g, sm, params, member);
  const float span = Lc.tf - Lc.t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  esdirk::Control ctl{start(g, m, y0, yp0, mass, dir, Lc)};
  if constexpr (tab::REC) {
    // the start's y': each thread's own elements, written by it
    rk::for_elements<N>(g, [&](int i) {
      rec.f0[static_cast<size_t>(member) * N + i] = m.yp[i];
    });
  }
  float t = Lc.t0;
  float t_lo = 0.0f;
  int status = kRunning;
  int nstep = 0;
  int nfev = Lc.have_yp0 ? 0 : 1;
  int it = 0;
  int nrec = 0;  // rows of the record written (tab::REC)
  // the next sorted t_eval point (tab::SNAP): the rows of those at or
  // before t0 get the thread's elements of y0
  int q = 0;
  if constexpr (tab::SNAP) {
    q = snap.past(0, dir, t);
    rk::for_elements<N>(g, [&](int i) {
      for (int p = 0; p < q; ++p) snap.row(p, member, N)[i] = m.y[i];
    });
  }
  Clock clk;

  while (status == kRunning) {
    // step-size limits and the landing on tf, every attempt
    const float tc = t + t_lo;
    ctl.prepare(t, t_lo, Lc.tf, Lc.max_step);
    const float ha = ctl.ha;
    const float h = ha * dir;
    const float hd = h * tab::D;
    clk.mark(kControl);

    // the Newton matrix and its reduction, once per attempt
    newton_matrix(g, m, tc, hd);
    clk.mark(kBands);
    pcr_factor(g, m);
    clk.mark(kFactor);

    // stages (stage 0 explicit: K0 = yp; h K_j == z_j)
    rk::for_elements<N>(g, [&](int i) {
      m.K[i] = m.yp[i];
      if constexpr (COMP) m.Z[i] = h * m.yp[i];
    });
    StageSum st{0.0f, 0, !ctl.too_small};
    stages<COMP, 1>(g, m, st, tc, h, Lc, clk);

    // solution and error estimate; stiffly accurate: y_new = psi + d z of
    // the last stage
    float nbad = 0.0f;
    rk::for_elements<N>(g, [&](int i) {
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
    });
    float* err = m.rhs;
    if constexpr (tab::FILTER_ERROR) {
      const float inv_hd = 1.0f / hd;
      rk::for_elements<N>(g, [&](int i) {
        if (m.mass[i] == 0.0f) m.rhs[i] = m.rhs[i] * inv_hd;
      });
      err = pcr_solve(g, m);
      rk::for_elements<N>(g, [&](int i) { err[i] = m.mass[i] * err[i]; });
    }
    float sq = 0.0f;
    rk::for_elements<N>(g, [&](int i) {
      const float scale =
          Lc.atol + Lc.rtol * fmaxf(fabsf(m.y[i]), fabsf(m.ynew[i]));
      const float q = err[i] / scale;
      sq = sq + q * q;
    });
    float v[2] = {sq, nbad};
    g.sums(v);
    float err_norm = sqrtf(v[0] / static_cast<float>(N));
    const bool bad_m = v[1] != 0.0f || !isfinite(err_norm);
    if (!isfinite(err_norm)) err_norm = 1.0f;
    if (bad_m) err_norm = err_norm + 10.0f;
    const bool accepted = st.conv && err_norm < 1.0f && !bad_m;
    clk.mark(kError);

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
    // the step's end at row nstep of the record, while the attempts are
    // below its rows
    const bool rec_row = tab::REC && it < rec.rows;
    const size_t row = tab::REC ? rec.row(member, nstep) : 0;
    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (status == kRunning && it >= Lc.max_steps) status = kOverflow;

    if (accepted) {
      float unused = 0.0f;
      // the t_eval points the step crosses
      const int q_end =
          tab::SNAP ? snap.past(q, dir, is_last ? Lc.tf : t_adv) : 0;
      rk::for_elements<N>(g, [&](int i) {
        if constexpr (tab::SNAP) {
          const float ypn = finite_or_one(m.K[(S - 1) * N + i], unused);
          for (int p = q; p < q_end; ++p) {
            snap.row(p, member, N)[i] = rk::hermite(
                snap.theta(p, t, h), h, m.y[i], m.yp[i], m.ynew[i], ypn);
          }
        }
        m.y[i] = m.ynew[i];
        m.ylo[i] = m.ylonew[i];
        m.yp[i] = finite_or_one(m.K[(S - 1) * N + i], unused);
        if constexpr (tab::REC) {
          if (rec_row) {
            rec.y[row * N + i] = m.y[i];
            rec.f[row * N + i] = m.yp[i];
          }
        }
      });
      t = is_last ? Lc.tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
      if constexpr (tab::REC) {
        if (rec_row) {
          if (g.rank() == 0) rec.t[row] = t;
          nrec += 1;
        }
      }
      if constexpr (tab::SNAP) q = q_end;
      nstep += 1;
    }
    nfev += st.nfev;
    clk.mark(kControl);
  }

  g.sync();
  rk::for_elements<N>(g, [&](int i) {
    out.y[static_cast<size_t>(member) * N + i] = m.y[i];
    // the points the member never reached take its final y
    if constexpr (tab::SNAP) {
      for (int p = q; p < snap.nq; ++p) snap.row(p, member, N)[i] = m.y[i];
    }
  });
  if (g.rank() == 0) {
    out.status[member] = status;
    out.nsteps[member] = nstep;
    out.nfev[member] = nfev;
    if constexpr (tab::REC) rec.n[member] = nrec;
    clk.write(member, it);
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "block_group.cuh"

namespace {

#ifdef FUSED_ESDIRK_GRID_SECTIONS
// The probe's group: the kernel's, counting its barrier phases.
template <class Group>
struct Counted : Group {
  unsigned phases = 0;
  __device__ void sync() {
    ++phases;
    Group::sync();
  }
  template <int K>
  __device__ void sums(float (&v)[K]) {
    ++phases;
    Group::sums(v);
  }
  __device__ float sum(float v) {
    ++phases;
    return Group::sum(v);
  }
  __device__ float min(float v) {
    ++phases;
    return Group::min(v);
  }
};
template <class Group>
__device__ Counted<Group> group(Group g) {
  return Counted<Group>{g};
}
template <class Group>
__device__ void write_phases(const Counted<Group>& g, int member) {
  if (g.rank() == 0) {
    g_sections[static_cast<size_t>(member) * kSectionSlots + kPhases] =
        g.phases;
  }
}
#else
template <class Group>
__device__ Group group(Group g) {
  return g;
}
template <class Group>
__device__ void write_phases(const Group&, int) {}
#endif

template <bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
    fused_esdirk_grid_kernel(const float* __restrict__ y0,
                             const float* __restrict__ yp0,
                             const float* __restrict__ mass,
                             const float* __restrict__ params, Launch Lc,
                             Out out, Rec rec, Snap snap) {
  extern __shared__ float sm[];
  __shared__ float red[2 * 2 * 32];
  auto g = group(BlockGroupOf<2>{red});
  const int member = blockIdx.x;
  const size_t off = static_cast<size_t>(member) * N;
  integrate<COMP>(g, sm, y0 + off, yp0 ? yp0 + off : nullptr, mass, params,
                  Lc, member, out, rec, snap);
  write_phases(g, member);
}

// One warp per member, blockDim.x / 32 members a block, each warp on its own
// kFloats of the dynamic shared memory; a warp past the ensemble returns at
// once (no block barrier waits for it).
template <bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
    fused_esdirk_grid_warp_kernel(const float* __restrict__ y0,
                                  const float* __restrict__ yp0,
                                  const float* __restrict__ mass,
                                  const float* __restrict__ params, Launch Lc,
                                  Out out, int members, Rec rec, Snap snap) {
  extern __shared__ float sm[];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int member = static_cast<int>(blockIdx.x * (blockDim.x >> 5)) + warp;
  if (member >= members) return;
  auto g = group(WarpGroup{});
  const size_t off = static_cast<size_t>(member) * N;
  integrate<COMP>(g, sm + warp * kFloats, y0 + off,
                  yp0 ? yp0 + off : nullptr, mass, params, Lc, member, out,
                  rec, snap);
  write_phases(g, member);
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, Launch, Out, Rec, Snap);
using WarpKernel = void (*)(const float*, const float*, const float*,
                            const float*, Launch, Out, int, Rec, Snap);

// Allows `bytes` of dynamic shared memory where it is above 48 KB.
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

#ifdef FUSED_ESDIRK_GRID_SECTIONS
// The probe build's counters: kSectionSlots unsigned values per member are
// written to `sections` by the launches that follow.
extern "C" int fused_esdirk_grid_sections(void* sections) {
  unsigned* ptr = static_cast<unsigned*>(sections);
  return static_cast<int>(
      cudaMemcpyToSymbol(g_sections, &ptr, sizeof(ptr)));
}
#endif

// The shared memory one member needs and the most a block may have on this
// card, in bytes; returns the CUDA error code.
extern "C" int fused_esdirk_grid_smem(int* need, int* limit) {
  int dev = 0;
  cudaGetDevice(&dev);
  *need = static_cast<int>(kFloats * sizeof(float));
  cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(cudaGetLastError());
}

// Launches the members on the caller's stream and returns the CUDA error
// code; the wrapper raises on anything but 0.  warp_members = 0: one block
// of `threads` (a multiple of 32, at most kMaxThreads) per member;
// warp_members = P >= 1: one warp per member, P members a block of 32 P
// threads (threads must be 32, P at most kMaxThreads / 32; another shape is
// cudaErrorInvalidValue).  The members' rows are dynamic shared memory
// (above 48 KB after cudaFuncSetAttribute).  yp0 may be null when have_yp0
// is 0, mass null for ODEs, params (NPAR floats a member) null where NPAR
// is 0.
static int launch_members(const void* y0, const void* yp0, const void* mass,
                          const void* params, void* y_out, void* status,
                          void* nstep, void* nfev, int members,
                          const Launch& Lc, int compensated, int threads,
                          int warp_members, const Rec& rec, const Snap& snap,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  const float* y0f = static_cast<const float*>(y0);
  const float* yp0f = static_cast<const float*>(yp0);
  const float* massf = static_cast<const float*>(mass);
  const float* pf = static_cast<const float*>(params);
  const int member_bytes = static_cast<int>(kFloats * sizeof(float));
  if (warp_members > 0) {
    if (threads != 32 || warp_members > kMaxThreads / 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int bytes = warp_members * member_bytes;
    WarpKernel kernel = compensated ? fused_esdirk_grid_warp_kernel<true>
                                    : fused_esdirk_grid_warp_kernel<false>;
    const cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (members + warp_members - 1) / warp_members;
    kernel<<<blocks, 32 * warp_members, bytes, st>>>(
        y0f, yp0f, massf, pf, Lc, out, members, rec, snap);
    return static_cast<int>(cudaGetLastError());
  }
  Kernel kernel = compensated ? fused_esdirk_grid_kernel<true>
                              : fused_esdirk_grid_kernel<false>;
  const cudaError_t e = allow_smem(kernel, member_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<members, threads, member_bytes, st>>>(y0f, yp0f, massf, pf, Lc,
                                                 out, rec, snap);
  return static_cast<int>(cudaGetLastError());
}

// The launch of a build without dense output or snapshots
// (cudaErrorInvalidValue for a build with either: those take
// fused_esdirk_grid_record_launch and fused_esdirk_grid_snap_launch).
extern "C" int fused_esdirk_grid_launch(
    const void* y0, const void* yp0, const void* mass, const void* params,
    void* y_out,
    void* status, void* nstep, void* nfev, int members, float t0, float tf,
    float rtol, float atol, float h0, int use_hstart, int have_yp0,
    float max_step, int max_steps, float tiny_err, int compensated,
    int threads, int warp_members, void* stream) {
  if (tab::REC || tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  const Launch Lc{t0,         tf,        rtol,     atol,      h0,
                  use_hstart, have_yp0,  max_step, max_steps, tiny_err};
  return launch_members(y0, yp0, mass, params, y_out, status, nstep, nfev,
                        members, Lc, compensated, threads, warp_members,
                        Rec{}, Snap{}, stream);
}

// The launch of a build with dense output (tab::REC): as
// fused_esdirk_grid_launch, and each member writes its record
// (dense_record.cuh) to rec_t (B, rows), rec_y and rec_f (B, rows, N),
// rec_f0 (B, N) and rec_n (B,) int32.  cudaErrorInvalidValue for a build
// without it, one with snapshots or rows < 1.
extern "C" int fused_esdirk_grid_record_launch(
    const void* y0, const void* yp0, const void* mass, const void* params,
    void* y_out, void* status, void* nstep, void* nfev, int members,
    float t0, float tf, float rtol, float atol, float h0, int use_hstart,
    int have_yp0, float max_step, int max_steps, float tiny_err,
    int compensated, int threads, int warp_members, void* rec_t,
    void* rec_y, void* rec_f, void* rec_f0, void* rec_n, int rows,
    void* stream) {
  if (!tab::REC || tab::SNAP || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch Lc{t0,         tf,        rtol,     atol,      h0,
                  use_hstart, have_yp0,  max_step, max_steps, tiny_err};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  return launch_members(y0, yp0, mass, params, y_out, status, nstep, nfev,
                        members, Lc, compensated, threads, warp_members, rec,
                        Snap{}, stream);
}

// The launch of a build with snapshots (tab::SNAP): as
// fused_esdirk_grid_record_launch, the record's arguments null with rows 0
// for a build without it, and each member writes the rows (snapshot.cuh) of
// the nq points tq (float32, sorted in the direction of integration) at
// their indices idx (int32) in t_eval to y_eval (nq, B, N).
// cudaErrorInvalidValue for a build without tab::SNAP, nq < 1, or rows
// that disagree with tab::REC.
extern "C" int fused_esdirk_grid_snap_launch(
    const void* y0, const void* yp0, const void* mass, const void* params,
    void* y_out, void* status, void* nstep, void* nfev, int members,
    float t0, float tf, float rtol, float atol, float h0, int use_hstart,
    int have_yp0, float max_step, int max_steps, float tiny_err,
    int compensated, int threads, int warp_members, void* rec_t,
    void* rec_y, void* rec_f, void* rec_f0, void* rec_n, int rows,
    const void* tq, const void* idx, void* y_eval, int nq, void* stream) {
  if (!tab::SNAP || nq < 1 || (rows > 0) != tab::REC || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch Lc{t0,         tf,        rtol,     atol,      h0,
                  use_hstart, have_yp0,  max_step, max_steps, tiny_err};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  const Snap snap{static_cast<const float*>(tq), static_cast<const int*>(idx),
                  static_cast<float*>(y_eval), nq, members};
  return launch_members(y0, yp0, mass, params, y_out, status, nstep, nfev,
                        members, Lc, compensated, threads, warp_members, rec,
                        snap, stream);
}
