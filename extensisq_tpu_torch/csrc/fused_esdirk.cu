// Fused adaptive ESDIRK ensemble solver for Hopper (sm_90a): stiff ODEs and
// index-1 DAEs, the whole implicit integration in one launch.
//
// Replaces extensisq_tpu/ops/fused_esdirk.py:solve_fused_esdirk, the Pallas
// kernel (its body `kernel`, with `_jacobian`, `_gauss` and `newton`).  Its
// plain PyTorch version is extensisq_tpu_torch/ops/fused_esdirk.py:
// fused_esdirk_reference; the two take the same steps up to round-off.
//
// Design: a group of G lanes of one warp per member, G = 4, 8, 16 or 32
// (lane_group.cuh), or one thread per member (G = 1, integrate_thread).
// Every lane of a group keeps the member's whole state in registers (y,
// y_lo, yp, the stage rows K[S][N] and Z[S][N] in compensated mode, the
// Newton matrix and its factor) and computes every scalar and N-vector
// from identical inputs, so the group takes every branch together and no
// lane misses a shuffle.  The lanes split the work that has the same code
// for every part and no chain between the parts: the Jacobian (lane r
// evaluates rhs<Dual> for the columns r, r + G, ...), the divisions of
// every scaled norm and the controller's four powf; the results reach
// every lane by shuffle and are summed in the one-thread order.  A thread
// issues such independent divisions and powf one after another (each
// IEEE division is a branch around its slow path), a group at once.  The
// factor and its replays stay whole in every lane: they are chains of
// dependent operations (the bubble pivot, back substitution's divisions)
// that shuffles would only lengthen.  A member reads device memory once
// at the start and lane 0 writes once at the end.
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
// What bounds it on the H100: each member is a long chain of dependent f32
// operations, now with N dual RHS evaluations, an N^3/3 elimination and
// several N^2 solves per attempt, so a lane is latency-bound and the
// card's throughput comes from members in flight.  One thread per member
// packs 32 members into a warp, which runs every Newton iteration that any
// of them needs and until the slowest of them ends; a group of G lanes
// packs 32 / G.  The wrapper (ops/fused_esdirk.py:_lanes_per_member) takes
// G from the ensemble size and the card's SM count.  Registers are the
// scarce resource: Kv3I at N = 5 holds about 120 floats per lane; the
// build prints registers and spills (-Xptxas -v).
//
// The method, the mass-matrix setup and the user's right-hand side come
// from the generated header fused_esdirk_config.cuh:
//   namespace tab { N, NB, NPAR, REC, SNAP, S, D, KAPPA, controller
//                   constants,
//                   A(i,j), AZ(i,j), C(i), E(j), MASS(i), ALG(i), V(i,j), ... }
//   template <class T> __device__ void rhs(T t, const T* y, T* dy);
// with NPAR = K > 0 per-member parameters rhs takes a fourth argument, the
// member's parameters as T (member_rhs.cuh).
//
// The simultaneous corrector (NB < N, ops/fused_sens.py's variational
// systems, CVODES's SIM scheme): the state is N = NB x blocks rows whose
// Jacobian is block lower triangular with every diagonal block the base
// block J = df/dy of the first NB rows.  J comes from base_rhs<Dual> over
// those rows only (the variational rhs evaluates the user's rhs on duals
// itself, and a dual of duals is not needed), W = I - h d J is NB x NB and
// factored once per attempt, and every Newton iteration and the error
// filter replay the one factor over each block of NB rows.  The neglected
// coupling below the diagonal blocks only lags the Newton rate, which the
// rate and divergence tests handle; the norms run over all N rows.  Plain
// ODEs only (no mass matrix).  The lanes of a group split the NB columns of
// the base block (lanes past NB idle there) and the N divisions of every
// norm.
//
// Dense output (dense=R, ops/fused_esdirk.py): a build whose header sets
// tab::REC writes each accepted step's end (t, y, y') to its member's rows
// in device memory, rank 0 of a group (dense_record.cuh), y' the stiffly
// accurate last stage the loop carries; f0 is the start's y'.  The rows
// hold user coordinates: with a dense or hidden mass matrix rank 0 maps y
// and y' back by V, as it maps the result.  The writes sit beside the
// arithmetic, which they leave as it is; without tab::REC the body is
// called with no record and the kernels are those of the build before
// dense output (the record build launches a kernel of its own,
// fused_esdirk_record_kernel).
//
// t_eval snapshots (ops/fused_esdirk.py): a build whose header sets
// tab::SNAP writes each point's row (snapshot.cuh) as the member's accepted
// step crosses it, the cubic Hermite of the step's end pairs (y, y') and
// (y_new, y'_new), y' the carried stiffly accurate last stage and y'_new
// this step's, scrubbed as the loop carries it, read before y and y' are
// overwritten (the high words of y and t in the compensated mode); a
// step's crossed points are split over the group's lanes, and each row is
// formed in the kernel's coordinates and mapped back to the user's by V,
// as y is (snapshot.cuh: snap_step_rows).  Points at or before t0 take y0
// (V V^T y0 under a rotation), the points left at the end the final y,
// rank 0 writing those.  The four outputs are those of the build without
// it (its Watts start out of line, as B5's); the snapshot build launches a
// kernel of its own too (fused_esdirk_snap_kernel, with the record where
// the build has both).
//
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

#include "dense_record.cuh"
#include "dual.cuh"
#include "fused_esdirk_config.cuh"
#include "esdirk_control.cuh"
#include "hstart.cuh"
#include "member_rhs.cuh"
#include "rk_common.cuh"
#include "snapshot.cuh"

namespace {

using tab::N;
using tab::NB;  // rows of the Newton matrix: N, or the base block's
using tab::S;
using Rhs = MemberRhs<tab::NPAR>;
static_assert(N % NB == 0 && NB * (NB - 1) / 2 <= 32,
              "the base block divides N, and its swaps fit one word");

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
__device__ __forceinline__ void fun1(const Rhs& fn, T t, const T (&w)[N],
                                     T (&dw)[N]) {
  if constexpr (tab::ROT) {
    T y[N], f[N];
    mat_rows<Mat::V>(w, y);
    fn(t, y, f);
    mat_rows<Mat::UTS>(f, dw);
  } else {
    fn(t, w, dw);
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

// j, unknown to the compiler: a seed that folds to a constant 1 would let
// nvcc contract a column's dual arithmetic otherwise in one body than in
// another, so every body seeds its columns (and picks its controller
// powers) through this.
__device__ __forceinline__ int opaque(int j) {
  asm volatile("" : "+r"(j));
  return j;
}

// J[i][j] = d fun1_i / d y_j (i, j < NB) at (t, y) in every lane of the
// group grp of G lanes (rank(), shfl(v, src)): lane r evaluates rhs<Dual>
// (base_rhs<Dual> over the base block when NB < N) with the tangent seeded
// at the columns r, r + G, ... (none past NB), and each entry comes from
// its column's lane.  D is Dual; a parameter keeps the unused branch
// uninstantiated.
template <int G, class Group, class D = Dual>
__device__ __forceinline__ void jacobian(Group& grp, const Rhs& fn, float t,
                                         const float (&y)[N],
                                         float (&J)[NB][NB]) {
  constexpr int JC = (NB + G - 1) / G;  // columns per lane
  float col[JC][NB];
#pragma unroll
  for (int q = 0; q < JC; ++q) {
    const int c = opaque(q * G + grp.rank());
    if constexpr (NB < N) {
      D yd[NB], fd[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) yd[k] = D(y[k], k == c ? 1.0f : 0.0f);
      fn.base(D(t), yd, fd);
#pragma unroll
      for (int i = 0; i < NB; ++i) col[q][i] = fd[i].d;
    } else {
      D yd[N], fd[N];
#pragma unroll
      for (int k = 0; k < N; ++k) yd[k] = D(y[k], k == c ? 1.0f : 0.0f);
      fun1(fn, D(t), yd, fd);
#pragma unroll
      for (int i = 0; i < N; ++i) col[q][i] = fd[i].d;
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int i = 0; i < NB; ++i) J[i][j] = grp.shfl(col[j / G][i], j % G);
  }
}

// One lane per member: the group of integrate_thread, whose shuffle is the
// identity.
struct OneLane {
  __device__ int rank() const { return 0; }
  __device__ float shfl(float v, int) const { return v; }
};

// Factor a in place: the eliminated rows with the multipliers below the
// diagonal; bit q of `swaps` records the q-th bubble swap.
__device__ __forceinline__ void gauss_factor(float (&a)[NB][NB],
                                             unsigned& swaps) {
  swaps = 0u;
  int q = 0;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
#pragma unroll
    for (int i = k + 1; i < NB; ++i) {
      const bool sw = fabsf(a[i][k]) > fabsf(a[k][k]);
#pragma unroll
      for (int j = k; j < NB; ++j) {
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
    for (int i = k + 1; i < NB; ++i) {
      const float fkt = a[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < NB; ++j) a[i][j] = a[i][j] - fkt * a[k][j];
      a[i][k] = fkt;
    }
  }
}

// Solve in place with a gauss_factor factor, block by block of NB rows (one
// block when NB == N): the swaps and the elimination replayed on the block
// in the factor's order, then back substitution.
__device__ __forceinline__ void gauss_solve(const float (&a)[NB][NB],
                                            unsigned swaps, float (&x)[N]) {
#pragma unroll
  for (int b = 0; b < N; b += NB) {
    int q = 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
#pragma unroll
      for (int i = k + 1; i < NB; ++i) {
        const bool sw = (swaps >> q) & 1u;
        const float xk = x[b + k];
        const float xi = x[b + i];
        x[b + k] = sw ? xi : xk;
        x[b + i] = sw ? xk : xi;
        ++q;
      }
#pragma unroll
      for (int i = k + 1; i < NB; ++i) {
        x[b + i] = x[b + i] - a[i][k] * x[b + k];
      }
    }
#pragma unroll
    for (int k = NB - 1; k >= 0; --k) {
      float acc = x[b + k];
#pragma unroll
      for (int j = k + 1; j < NB; ++j) acc = acc - a[k][j] * x[b + j];
      x[b + k] = acc / a[k][k];
    }
  }
}

// x, or 1 with `bad` set where x is not finite (the JAX kernel's scrub).
__device__ __forceinline__ float finite_or_one(float x, bool& bad) {
  if (isfinite(x)) return x;
  bad = true;
  return 1.0f;
}

// x_i for an index i unknown to the compiler: a select walk over the N
// entries (a register array indexed at run time would go to local memory).
__device__ __forceinline__ float pick(const float (&x)[N], int i) {
  float v = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = k == i ? x[k] : v;
  return v;
}

// RMS of x / (atol + rtol max(|a|, |b|)), all in user coordinates, in every
// lane of the group grp of G lanes: lane r divides the entries r, r + G,
// ... and the quotients reach every lane by shuffle, to be squared and
// summed in entry order.  One thread issues its N IEEE divisions one after
// another (each a branch around its slow path); a group of G >= N lanes
// waits for one.
template <int G, class Group>
__device__ __forceinline__ float scaled_norm(Group& grp, const float (&x)[N],
                                             const float (&a)[N],
                                             const float (&b)[N], float rtol,
                                             float atol) {
  constexpr int Q = (N + G - 1) / G;  // entries per lane
  float r[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = q * G + grp.rank();
    const float scale =
        atol + rtol * fmaxf(fabsf(pick(a, i)), fabsf(pick(b, i)));
    r[q] = pick(x, i) / scale;
  }
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ri = grp.shfl(r[i / G], i % G);
    sq = sq + ri * ri;
  }
  return sqrtf(sq / static_cast<float>(N));
}

// The controller's four powers (esdirk::Control::pow_base, pow_exponent)
// in every lane of the group: lane r takes the powers r, r + G, ...  The
// power's index is opaque, so that powf runs the same code at every G.
template <int G, class Group>
__device__ __forceinline__ void control_powers(Group& grp,
                                               const esdirk::Control& ctl,
                                               float err_norm, float h,
                                               float (&pw)[4]) {
  constexpr int Q = (4 + G - 1) / G;
  float mine[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = opaque(k * G + grp.rank());
    mine[k] = powf(ctl.pow_base(q, err_norm, h),
                   esdirk::Control::pow_exponent(q));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) pw[q] = grp.shfl(mine[q / G], q % G);
}

struct Params {
  float rtol, atol, tiny_err;
};

// Section clocks of one member, in the probe's build only
// (tools/probe_fused_esdirk.py compiles with FUSED_ESDIRK_SECTIONS): the
// SM cycles spent in each part of the attempts, summed over them and
// written by lane 0.  A lane waiting for the others of its warp at the end
// of a divergent part counts the wait in the part that follows.  The
// shipped build's Clock is empty and compiles to nothing.
enum Section {
  kJacobian,     // the dual evaluations and the shuffles of J
  kFactor,       // W and its factor
  kNewtonRhs,    // y_pred, the RHS and the Newton right-hand side
  kNewtonSolve,  // the factor's replay in a Newton iteration
  kNewtonTest,   // the update's norm, the convergence tests, z += dz
  kStage,        // the stage predictors and K, Z
  kError,        // y_new, the error estimate, its filter solve and norm
  kControl,      // the step-size limits, the controller, t and status
  kSections
};
#ifdef FUSED_ESDIRK_SECTIONS
__device__ unsigned* g_sections;  // [member][kSections]
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
  __device__ void write(int member) const {
#pragma unroll
    for (int k = 0; k < kSections; ++k) {
      g_sections[static_cast<size_t>(member) * kSections + k] = acc[k];
    }
  }
};
#else
struct Clock {
  __device__ void mark(int) {}
  __device__ void write(int) const {}
};
#endif

// Modified Newton for one stage: z from its predictor to the stage
// increment.  Returns converged; sets the stage's rate (>= 0), its RHS
// evaluations and whether a non-finite value stopped it.
template <int G, class Group>
__device__ __forceinline__ bool newton(Group& grp, const Rhs& fn,
                                       float t_stage, float h,
                                       const float (&psi)[N],
                                       const float (&yu_c)[N], float (&z)[N],
                                       const float (&a)[NB][NB],
                                       unsigned swaps,
                                       const Params& p, float& rate_out,
                                       int& nfev, bool& bad_any, Clock& clk) {
  esdirk::Newton nw;
  bool conv = false;
  nfev = 0;
  bad_any = false;
#pragma unroll 1
  for (int it = 0; it < tab::NEWTON_MAXITER; ++it) {
    float y_pred[N], f[N], dz[N];
#pragma unroll
    for (int i = 0; i < N; ++i) y_pred[i] = psi[i] + tab::D * z[i];
    fun1(fn, t_stage, y_pred, f);
    nfev += 1;
    bool bad = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float fi = finite_or_one(f[i], bad);
      dz[i] = tab::ALG(i) ? fi * tab::INV_D : h * fi - tab::MASS(i) * z[i];
    }
    clk.mark(kNewtonRhs);
    gauss_solve(a, swaps, dz);
    clk.mark(kNewtonSolve);
#pragma unroll
    for (int i = 0; i < N; ++i) dz[i] = finite_or_one(dz[i], bad);
    float yu_pred[N], dz_u[N];
    to_user(y_pred, yu_pred);
    to_user(dz, dz_u);
    const float dz_norm =
        finite_or_one(scaled_norm<G>(grp, dz_u, yu_c, yu_pred, p.rtol, p.atol),
                      bad);
    const bool stop = nw.test(it, dz_norm, p.tiny_err, bad, conv);
    if (!bad) {
#pragma unroll
      for (int i = 0; i < N; ++i) z[i] = z[i] + dz[i];
    }
    bad_any = bad_any || bad;
    clk.mark(kNewtonTest);
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
template <int G, bool COMP, int I, class Group>
__device__ __forceinline__ void stages(Group& grp, const Rhs& fn, Stages& st,
                                       float tc, float h,
                                       const float (&y)[N],
                                       const float (&y_lo)[N],
                                       const float (&yu_c)[N],
                                       const float (&a)[NB][NB],
                                       unsigned swaps,
                                       const Params& p, Clock& clk) {
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
    clk.mark(kStage);
    float rate;
    int nf;
    bool bad;
    const bool conv = newton<G>(grp, fn, tc + c * h, h, st.psi, yu_c, st.z,
                                a, swaps, p, rate, nf, bad, clk);
    st.conv = st.conv && conv && !bad;
    st.Rate = fmaxf(st.Rate, rate);
    st.nfev += nf;
    const float inv_h = 1.0f / h;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      st.K[I][i] = st.z[i] * inv_h;
      if constexpr (COMP) st.Z[I][i] = st.z[i];
    }
    clk.mark(kStage);
    stages<G, COMP, I + 1>(grp, fn, st, tc, h, y, y_lo, yu_c, a, swaps, p,
                           clk);
  }
}

// The launch's scalars, the same for every member (max_step is +inf when
// the caller gave none; yp0 is used where have_yp0).
struct Launch {
  float t0, tf, rtol, atol, h0, max_step, tiny_err;
  int use_hstart, have_yp0, max_steps;
};

struct Out {
  float* y;
  int* status;
  int* nstep;
  int* nfev;
};

using rk::Rec;
using rk::Snap;

// The record of a body called with one (a build with tab::REC, or with
// tab::SNAP: the record and the snapshots); a build without either calls
// the body with none, so that its kernels take, construct and pass nothing
// for them (an unused Rec argument moved nvcc's choice of integer
// instructions in the G = 4, 8 and 16 bodies).
template <class... More>
__device__ __forceinline__ const Rec& the_record(const Rec& rec,
                                                 const More&...) {
  return rec;
}

// The t_eval rows of a body called with them (a build with tab::SNAP).
__device__ __forceinline__ const Snap& the_snap(const Rec&,
                                                const Snap& snap) {
  return snap;
}

// Rank 0 writes the user-coordinate rows of the w-space state x to the
// record at dst (N floats).
template <class Group>
__device__ __forceinline__ void record_rows(const Group& grp,
                                            const float (&x)[N], float* dst) {
  if (grp.rank() != 0) return;
  float u[N];
  to_user(x, u);
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = u[k];
}

// The whole integration of one member by the group grp of G lanes
// (rank(), shfl(v, src); OneLane at G = 1).  y0 (and yp0) are the member's
// initial state (and derivative), par its tab::NPAR parameters (unread when
// there are none); lane 0 writes the results, with tab::REC the member's
// record (the Rec of `record`) and with tab::SNAP its t_eval rows (the
// Snap after it).
template <int G, bool COMP, class Group, class... Record>
__device__ void integrate(Group& grp, const float* __restrict__ y0,
                          const float* __restrict__ yp0,
                          const float* __restrict__ par, const Launch& L,
                          int member, const Out& out,
                          const Record&... record) {
  const Rhs fn(par);
  const Params p{L.rtol, L.atol, L.tiny_err};
  const float tf = L.tf;
  Clock clk;

  float y[N], y_lo[N], yp[N], in[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    in[k] = y0[k];
    y_lo[k] = 0.0f;
  }
  if constexpr (tab::ROT) {
    mat_rows<Mat::VH>(in, y);  // w = V^T y
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = in[k];
  }
  float t = L.t0;
  float t_lo = 0.0f;
  const float span = tf - L.t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  if (L.have_yp0) {
#pragma unroll
    for (int k = 0; k < N; ++k) in[k] = yp0[k];
    if constexpr (tab::ROT) {
      mat_rows<Mat::VH>(in, yp);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) yp[k] = in[k];
    }
  } else {
    fun1(fn, t, y, yp);
    if constexpr (tab::HAS_M && !tab::ROT) {
#pragma unroll
      for (int k = 0; k < N; ++k) yp[k] = yp[k] * tab::INV_MASS(k);
    }
  }
  if constexpr (tab::REC) {
    record_rows(grp, yp,
                the_record(record...).f0 + static_cast<size_t>(member) * N);
  }
  float h_abs = L.h0;
  if (L.use_hstart) {
    // plain ODEs only; max_step is +inf when the caller gave none
    const float bq = t + dir * fminf(fabsf(tf - t), L.max_step);
    if constexpr (tab::SNAP) {
      h_abs = fabsf(rk::hstart_out_of_line<N, tab::MORDER>(
          t, bq, y, yp, L.rtol, L.atol, fn));
    } else {
      h_abs = fabsf(
          rk::hstart<N, tab::MORDER>(t, bq, y, yp, L.rtol, L.atol, fn));
    }
  }
  // the next sorted t_eval point (tab::SNAP): those at or before t0 take y0
  rk::Cursor cur;
  if constexpr (tab::SNAP) {
    const Snap& snap = the_snap(record...);
    cur = rk::cursor_at(snap, snap.past(0, dir, t));
    if (grp.rank() == 0) {
      float yu[N];
      to_user(y, yu);
      rk::snap_fill(snap, 0, cur.q, member, yu);
    }
  }

  int status = kRunning;
  int nstep = 0;
  int nfev = L.have_yp0 ? 0 : 1;
  int it = 0;
  int nrec = 0;  // rows of the record written (tab::REC)
  esdirk::Control ctl{h_abs};

  while (status == kRunning) {
    // step-size limits and the landing on tf, every attempt
    const float tc = t + t_lo;
    ctl.prepare(t, t_lo, tf, L.max_step);
    const float ha = ctl.ha;
    const float h = ha * dir;
    clk.mark(kControl);

    // Newton matrix W = Sc (M - h d J), factored once per attempt (on the
    // base block when NB < N)
    float a[NB][NB];
    jacobian<G>(grp, fn, tc, y, a);
    clk.mark(kJacobian);
    const float hd = h * tab::D;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        a[i][j] = tab::ALG(i) ? -a[i][j]
                              : (i == j ? tab::MASS(i) : 0.0f) - hd * a[i][j];
      }
    }
    unsigned swaps;
    gauss_factor(a, swaps);
    clk.mark(kFactor);

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
    stages<G, COMP, 1>(grp, fn, st, tc, h, y, y_lo, yu_c, a, swaps, p, clk);

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
        scaled_norm<G>(grp, err_u, yu_c, yu_new, L.rtol, L.atol), bad_m);
    if (bad_m) err_norm = err_norm + 10.0f;
    const bool accepted = st.conv && err_norm < 1.0f && !bad_m;
    clk.mark(kError);

    // implicit controller and the rate-based reduction after a convergence
    // failure (esdirk_control.cuh)
    float pw[4];
    control_powers<G>(grp, ctl, err_norm, h, pw);
    ctl.finish(err_norm, st.Rate, st.conv, accepted, h, L.tiny_err, pw);
    if (ctl.too_small) status = kTooSmall;
    // double-single t advance; the landing test uses the remainder
    float t_adv, t_lo_adv;
    rk::df_add(t, t_lo, h, t_adv, t_lo_adv);
    const float rem = (tf - t_adv) - t_lo_adv;
    const bool is_last = accepted && fabsf(rem) <= tab::LAND_TOL * ha;
    if (status == kRunning && is_last) status = kFinished;
    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (status == kRunning && it >= L.max_steps) status = kOverflow;

    if (accepted) {
      bool unused = false;
      if constexpr (tab::SNAP) {
        // the points this step crosses, from its end pairs, each row
        // mapped to the user's coordinates
        float yp_new[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          yp_new[i] = finite_or_one(st.K[S - 1][i], unused);
        }
        cur = rk::snap_step_rows<N, G>(
            the_snap(record...), cur, member, grp.rank(), dir, t,
            is_last ? tf : t_adv, h, y, yp, y_new, yp_new,
            [](float* dst, const float (&row)[N]) {
              float u[N];
              to_user(row, u);
#pragma unroll
              for (int k = 0; k < N; ++k) dst[k] = u[k];
            });
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        y[i] = y_new[i];
        y_lo[i] = y_lo_new[i];
        yp[i] = finite_or_one(st.K[S - 1][i], unused);
      }
      t = is_last ? tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
      // the step's end at row nstep of the record, while the attempts
      // before this one are below its rows
      if constexpr (tab::REC) {
        const Rec& rec = the_record(record...);
        if (it <= rec.rows) {
          const size_t row = rec.row(member, nstep);
          if (grp.rank() == 0) rec.t[row] = t;
          record_rows(grp, y, rec.y + row * N);
          record_rows(grp, yp, rec.f + row * N);
          nrec += 1;
        }
      }
      nstep += 1;
    }
    nfev += st.nfev;
  }

  if (grp.rank() != 0) return;
  float res[N];
  to_user(y, res);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    out.y[static_cast<size_t>(member) * N + k] = res[k];
  }
  out.status[member] = status;
  out.nstep[member] = nstep;
  out.nfev[member] = nfev;
  if constexpr (tab::REC) the_record(record...).n[member] = nrec;
  // the points the member never reached take its final y
  if constexpr (tab::SNAP) {
    const Snap& snap = the_snap(record...);
    rk::snap_fill(snap, cur.q, snap.nq, member, res);
  }
  clk.write(member);
}

// One thread per member: the group body on one lane, for ensembles that
// fill the card.
template <bool COMP, class... Record>
__device__ void integrate_thread(const float* __restrict__ y0,
                                 const float* __restrict__ yp0,
                                 const float* __restrict__ par,
                                 const Launch& L, int member,
                                 const Out& out, const Record&... record) {
  OneLane one;
  integrate<1, COMP>(one, y0, yp0, par, L, member, out, record...);
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "lane_group.cuh"

namespace {

// The member of this thread's group from the kernel's arguments, with the
// record and the snapshots where a build has them.
template <int G, bool COMP, class... Record>
__device__ __forceinline__ void member_body(const float* __restrict__ y0,
                                            const float* __restrict__ yp0,
                                            const float* __restrict__ par,
                                            const Out& out, int B,
                                            int block_members,
                                            const Launch& L,
                                            const Record&... record) {
  const int member =
      blockIdx.x * block_members + static_cast<int>(threadIdx.x) / G;
  if (member >= B) return;  // ragged last block: no member padding
  const float* y0m = y0 + static_cast<size_t>(member) * N;
  const float* yp0m = L.have_yp0 ? yp0 + static_cast<size_t>(member) * N
                                 : nullptr;
  const float* parm = par + static_cast<size_t>(member) * tab::NPAR;
  if constexpr (G == 1) {
    integrate_thread<COMP>(y0m, yp0m, parm, L, member, out, record...);
  } else {
    LaneGroup<G> grp;
    integrate<G, COMP>(grp, y0m, yp0m, parm, L, member, out, record...);
  }
}

template <int G, bool COMP>
__global__ void fused_esdirk_kernel(const float* __restrict__ y0,
                                    const float* __restrict__ yp0,
                                    const float* __restrict__ par, Out out,
                                    int B, int block_members, Launch L) {
  member_body<G, COMP>(y0, yp0, par, out, B, block_members, L);
}

// The kernel of a build with the dense record (tab::REC), which takes the
// record; a build without it instantiates only fused_esdirk_kernel, whose
// parameters are those it had before dense output.
template <int G, bool COMP>
__global__ void fused_esdirk_record_kernel(const float* __restrict__ y0,
                                           const float* __restrict__ yp0,
                                           const float* __restrict__ par,
                                           Out out, int B,
                                           int block_members, Launch L,
                                           Rec rec) {
  member_body<G, COMP>(y0, yp0, par, out, B, block_members, L, rec);
}

// The kernel of a build with the t_eval snapshots (tab::SNAP), which takes
// the record (null with rows 0 where the build has none) and the rows.
template <int G, bool COMP>
__global__ void fused_esdirk_snap_kernel(const float* __restrict__ y0,
                                         const float* __restrict__ yp0,
                                         const float* __restrict__ par,
                                         Out out, int B, int block_members,
                                         Launch L, Rec rec, Snap snap) {
  member_body<G, COMP>(y0, yp0, par, out, B, block_members, L, rec, snap);
}

template <int G>
int launch(const float* y0, const float* yp0, const float* par,
           const Out& out, int B, const Launch& L, int compensated,
           int block_members, const Rec& rec, const Snap& snap,
           cudaStream_t s) {
  const int blocks = (B + block_members - 1) / block_members;
  const int threads = block_members * G;
  if constexpr (tab::SNAP) {
    if (compensated) {
      fused_esdirk_snap_kernel<G, true><<<blocks, threads, 0, s>>>(
          y0, yp0, par, out, B, block_members, L, rec, snap);
    } else {
      fused_esdirk_snap_kernel<G, false><<<blocks, threads, 0, s>>>(
          y0, yp0, par, out, B, block_members, L, rec, snap);
    }
  } else if constexpr (tab::REC) {
    if (compensated) {
      fused_esdirk_record_kernel<G, true><<<blocks, threads, 0, s>>>(
          y0, yp0, par, out, B, block_members, L, rec);
    } else {
      fused_esdirk_record_kernel<G, false><<<blocks, threads, 0, s>>>(
          y0, yp0, par, out, B, block_members, L, rec);
    }
  } else if (compensated) {
    fused_esdirk_kernel<G, true><<<blocks, threads, 0, s>>>(
        y0, yp0, par, out, B, block_members, L);
  } else {
    fused_esdirk_kernel<G, false><<<blocks, threads, 0, s>>>(
        y0, yp0, par, out, B, block_members, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef FUSED_ESDIRK_SECTIONS
// The probe build's section clocks: kSections unsigned counters per member
// are written to `sections` by the launches that follow.
extern "C" int fused_esdirk_sections(void* sections) {
  unsigned* ptr = static_cast<unsigned*>(sections);
  return static_cast<int>(
      cudaMemcpyToSymbol(g_sections, &ptr, sizeof(ptr)));
}
#endif

// Launches block_members members per block, `lanes` (1, 4, 8, 16 or 32)
// threads per member, on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for another lane count); the
// wrapper raises on anything but 0.  yp0 may be null when have_yp0 is 0;
// params is (B, tab::NPAR) float32, row-major (null when NPAR is 0).
static int launch_lanes(const void* y0, const void* yp0, const void* params,
                        void* y_out, void* status, void* nstep, void* nfev,
                        int B, const Launch& L, int compensated, int lanes,
                        int block_members, const Rec& rec, const Snap& snap,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  const float* yp0f = static_cast<const float*>(yp0);
  const float* par = static_cast<const float*>(params);
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  switch (lanes) {
    case 1:
      return launch<1>(y0f, yp0f, par, out, B, L, compensated,
                       block_members, rec, snap, s);
    case 4:
      return launch<4>(y0f, yp0f, par, out, B, L, compensated,
                       block_members, rec, snap, s);
    case 8:
      return launch<8>(y0f, yp0f, par, out, B, L, compensated,
                       block_members, rec, snap, s);
    case 16:
      return launch<16>(y0f, yp0f, par, out, B, L, compensated,
                        block_members, rec, snap, s);
    case 32:
      return launch<32>(y0f, yp0f, par, out, B, L, compensated,
                        block_members, rec, snap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch of a build without dense output or snapshots
// (cudaErrorInvalidValue for a build with either: those take
// fused_esdirk_record_launch and fused_esdirk_snap_launch).
extern "C" int fused_esdirk_launch(const void* y0, const void* yp0,
                                   const void* params, void* y_out,
                                   void* status, void* nstep,
                                   void* nfev, int B, float t0, float tf,
                                   float rtol, float atol, float h0,
                                   int use_hstart, int have_yp0,
                                   float max_step, int max_steps,
                                   float tiny_err, int compensated,
                                   int lanes, int block_members,
                                   void* stream) {
  if (tab::REC || tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{t0,       tf,       rtol,       atol,     h0,
                 max_step, tiny_err, use_hstart, have_yp0, max_steps};
  return launch_lanes(y0, yp0, params, y_out, status, nstep, nfev, B, L,
                      compensated, lanes, block_members, Rec{}, Snap{},
                      stream);
}

// The launch of a build with dense output (tab::REC): as
// fused_esdirk_launch, and each member writes its record
// (dense_record.cuh) to rec_t (B, rows), rec_y and rec_f (B, rows, N),
// rec_f0 (B, N) and rec_n (B,) int32, in user coordinates.
// cudaErrorInvalidValue for a build without it, one with snapshots or rows
// < 1.
extern "C" int fused_esdirk_record_launch(
    const void* y0, const void* yp0, const void* params, void* y_out,
    void* status, void* nstep, void* nfev, int B, float t0, float tf,
    float rtol, float atol, float h0, int use_hstart, int have_yp0,
    float max_step, int max_steps, float tiny_err, int compensated,
    int lanes, int block_members, void* rec_t, void* rec_y, void* rec_f,
    void* rec_f0, void* rec_n, int rows, void* stream) {
  if (!tab::REC || tab::SNAP || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0,       tf,       rtol,       atol,     h0,
                 max_step, tiny_err, use_hstart, have_yp0, max_steps};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  return launch_lanes(y0, yp0, params, y_out, status, nstep, nfev, B, L,
                      compensated, lanes, block_members, rec, Snap{}, stream);
}

// The launch of a build with snapshots (tab::SNAP): as
// fused_esdirk_record_launch, the record's arguments null with rows 0 for a
// build without it, and each member writes the rows (snapshot.cuh) of the
// nq points tq (float32, sorted in the direction of integration) at their
// indices idx (int32) in t_eval to y_eval (nq, B, N), in user coordinates.
// cudaErrorInvalidValue for a build without tab::SNAP, nq < 1, or rows
// that disagree with tab::REC.
extern "C" int fused_esdirk_snap_launch(
    const void* y0, const void* yp0, const void* params, void* y_out,
    void* status, void* nstep, void* nfev, int B, float t0, float tf,
    float rtol, float atol, float h0, int use_hstart, int have_yp0,
    float max_step, int max_steps, float tiny_err, int compensated,
    int lanes, int block_members, void* rec_t, void* rec_y, void* rec_f,
    void* rec_f0, void* rec_n, int rows, const void* tq, const void* idx,
    void* y_eval, int nq, void* stream) {
  if (!tab::SNAP || nq < 1 || (rows > 0) != tab::REC || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0,       tf,       rtol,       atol,     h0,
                 max_step, tiny_err, use_hstart, have_yp0, max_steps};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  const Snap snap{static_cast<const float*>(tq), static_cast<const int*>(idx),
                  static_cast<float*>(y_eval), nq, B};
  return launch_lanes(y0, yp0, params, y_out, status, nstep, nfev, B, L,
                      compensated, lanes, block_members, rec, snap, stream);
}
