// Fused adaptive explicit Runge-Kutta, Runge-Kutta-Nystrom and CKdisc
// ensembles of mid-size systems for Hopper (sm_90a): one thread block or
// one warp per member.
//
// Replaces the three Pallas kernels of the JAX package's mid-size layout,
// which run the loops of the small-system kernels with the state across
// lanes: extensisq_tpu/ops/fused_erk_grid.py:solve_fused_erk_grid (B4, the
// loop of B1), extensisq_tpu/ops/fused_rkn_grid.py:solve_fused_rkn_grid
// (B6, the loop of B5) and extensisq_tpu/ops/fused_ckdisc_grid.py:
// solve_fused_ckdisc_grid (B12, the cascade of B11).  One device body,
// integrate<COMP, Group>, runs B4 and B6, the family (ERK stages, or RKN
// h^2 A / h Ap stages on accelerations) coming from the generated header;
// integrate_ck<Group> runs B12 on the same layout, stages and starting
// step.  Their plain PyTorch versions are
// ops/fused_erk_grid.py:fused_erk_grid_reference,
// ops/fused_rkn_grid.py:fused_rkn_grid_reference and
// ops/fused_ckdisc_grid.py:fused_ckdisc_grid_reference, which run the loops
// of B1, B5 and B11 on the same members; each pair takes the same steps up
// to round-off.
//
// Design.  A member's state ([u | v] for RKN), its lo carry, the stage rows
// K[0..S] (K[0] = f), two stage-argument buffers and the attempt's lo carry
// live in shared memory: NF + (S + 1) N + 4 NF floats, with N the length of
// a stage row and NF = N (ERK) or 2N (RKN); Fi5N at N = 256 takes 17 KB.
// The bodies run on two groups (block_group.cuh): a block of 32-256
// threads per member (BlockGroup), or one warp per member (WarpGroup:
// __syncwarp and shuffle butterflies, no block barrier, P members a block,
// each warp on its own rows; the block body at 32 threads bit for bit),
// as each wrapper's rule says from the ensemble size and n (_launch_shape
// in ops/fused_erk_grid.py, fused_rkn_grid.py and fused_ckdisc_grid.py):
// B4 and B6 blocks or, for large ensembles, the warp; B12 blocks (a CKdisc
// build has no warp kernel).
// Element i belongs to the thread of rank i mod (group size), which
// computes its stage sums from its own entries of K; a warp's lane holds
// N / 32 elements and computes the values of all of them before it stores
// any (rk::for_elements_put), so that their chains overlap.  A stage
// writes its argument,
// takes one barrier, and then reads neighbours through the user's RHS; the
// two argument buffers are used in turn, so one barrier per stage suffices.
// Every per-member scalar (h, accept, status, counters, the controller) is
// computed by every thread from identical inputs, as in fused_rkc.cu, so
// every thread takes the same branches (the step control is
// rk_control.cuh's, as in B1 and B5).  Sums (the error norm, the starting
// step's norms) and the starting step's minimum are group reductions in a
// fixed order whose result every thread holds (block_group.cuh).  A
// non-finite element adds +inf to the error sum, so one reduction carries
// both the norm and the overflow test; a member that overflows ends alone.
// No lane padding: norms divide by the true NF and any N that fits in
// shared memory is taken (the wrapper raises before launch otherwise).
//
// The CKdisc cascade (ck_control.cuh) has up to five norms per attempt: E1,
// E2, E4 and the two fallbacks' error tests.  Every thread holds the same
// reductions, so the whole group takes the same branch, and stages that E1
// or E2 vetoes are skipped with their barriers.  The candidate solution of
// an attempt goes into the free stage row K[6]; the reduction of its norm
// is the barrier after which the endpoint's RHS may read its neighbours.
//
// What bounds it on the H100: per stage an element costs one RHS (a stencil
// of a few flops, loads from shared memory) and ~2 S flops of stage sums,
// and the stage costs one __syncthreads; an attempt adds the error norm's
// reduction.  At N = 256 with one element per thread the work between
// barriers is tens of cycles, so an attempt is bound by latency, not by
// the card's flop or byte rate: of a B4 attempt at 64 members a third is
// barrier and reduction waits, the rest the stage sums, the RHS and the
// controller, which every thread repeats; of a B12 attempt a quarter is
// the reductions and a fifth the cascade's scalar control (its powf).
// Members run in parallel on the SMs: 64 members use 64 of the 132 SMs,
// 1024 members keep several blocks on every SM, whose barriers then
// contend; a warp per member has no barrier to wait at but runs its
// lane's elements on one of the SM's four schedulers.
//
// The generated header fused_rk_grid_config.cuh provides
//   namespace tab { G = grid::Grid<...>, N, NPAR, RKN, CK, S, FSAL, MORDER,
//                   the weight accessors A, AP, B, BP, C, E, EP and the
//                   cascade's BAS, EAS, BFB, EFB, CFB (zeros for ERK and
//                   RKN), controller and start constants }
//   __device__ float rhs(float t, const float* y, int i, const float* p);
//   __device__ float acc(float t, const float* u, const float* v, int i,
//                        const float* p);
// (one of the two a stub); neighbours come from tab::G::rolled.  p is the
// member's NPAR parameters (B4's params), which it loads once into its
// shared memory before anything reads them; with NPAR = 0 (B6, B12 and B4
// without params) p is a null pointer, as it always was.
//
// Numerics as in fused_erk.cu and fused_rkn.cu: the compensated helpers
// round every operation on its own (__f*_rn), elsewhere nvcc may contract;
// no fast math; max_steps counts attempts.  B12 is plain float32 only.

#include <cuda_runtime.h>
#include <math.h>

#include "grid_common.cuh"
#include "fused_rk_grid_config.cuh"
#include "rk_common.cuh"
#include "rk_control.cuh"
#include "rk_rows.cuh"
#include "block_rows.cuh"
#include "ck_control.cuh"
#include "block_hstart.cuh"

namespace {

using tab::N;
using tab::S;
constexpr bool RKN = tab::RKN;
constexpr int NF = RKN ? 2 * N : N;          // the first-order state
constexpr int MM = S + (tab::FSAL ? 1 : 0);  // rows of the error estimate
constexpr int kMaxThreads = 256;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;

// Shared-memory layout of a member, in floats.  The starting step's six
// scratch rows of NF start past K[0]: it runs before the first attempt.
constexpr int kY = 0;                    // state, NF
constexpr int kK = kY + NF;              // stage rows K[0..S], N each
constexpr int kYlo = kK + (S + 1) * N;   // lo carry, NF
constexpr int kArg = kYlo + NF;          // two stage arguments, NF each
constexpr int kYloNew = kArg + 2 * NF;   // the attempt's lo carry, NF
constexpr int kPar = kYloNew + NF;       // the member's parameters, NPAR
constexpr int kFloats = kPar + tab::NPAR;
static_assert(kK + N + 6 * NF <= kFloats, "starting-step scratch");

struct Launch {  // the launch's scalars, the same for every member
  float t0, tf, dir, rtol, atol, h0;
  int use_hstart;
  float max_step;
  int max_steps;
};

struct Out {
  float* y;
  int* status;
  int* nsteps;
  int* nfev;
};

// Section clocks of one member, in the probe's build only
// (tools/probe_fused_rk_grid.py compiles with FUSED_RK_GRID_SECTIONS): the
// SM cycles rank 0 spends in each part of the attempts, summed over them,
// the attempts, and the attempts that CKdisc's E1 and E2 veto.  A thread
// waiting at a barrier counts the wait in the part that ends with it; the
// reductions' waits are a part of their own.  The shipped build's Clock is
// empty and compiles to nothing.
enum Section {
  kArgs,     // the stage arguments and the stages' barriers
  kRhs,      // the stage rows (the RHS), the FSAL row and the endpoint
  kNorm,     // the solution and the norms' partial sums
  kWait,     // the reductions
  kControl,  // the controller or the cascade's decisions, t and status
  kCommit,   // the commit and the barrier before the next attempt
  kSections
};
// a member's row of the probe's counters: the sections' cycles, the barrier
// phases (syncs and reductions), the attempts and the E1 and E2 vetoes
constexpr int kPhases = kSections;
constexpr int kAttempts = kSections + 1;
constexpr int kVeto1 = kSections + 2;
constexpr int kVeto2 = kSections + 3;
constexpr int kSectionSlots = kSections + 4;
#ifdef FUSED_RK_GRID_SECTIONS
__device__ unsigned* g_sections;  // [member][kSectionSlots]
struct Clock {
  unsigned acc[kSections];
  unsigned veto[2] = {0u, 0u};
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
  // the cascade's vetoes: E1 stops the attempt (!go2), or E2 (go2, !go4)
  __device__ void vetoes(bool go2, bool go4) {
    veto[0] += go2 ? 0u : 1u;
    veto[1] += (go2 && !go4) ? 1u : 0u;
  }
  template <class Group>
  __device__ void write(const Group& g, int member, int attempts) const {
    if (g.rank() != 0) return;
    unsigned* row = g_sections + static_cast<size_t>(member) * kSectionSlots;
#pragma unroll
    for (int k = 0; k < kSections; ++k) row[k] = acc[k];
    row[kAttempts] = static_cast<unsigned>(attempts);
    row[kVeto1] = veto[0];
    row[kVeto2] = veto[1];
  }
};
#else
struct Clock {
  __device__ void mark(int) {}
  __device__ void vetoes(bool, bool) {}
  template <class Group>
  __device__ void write(const Group&, int, int) const {}
};
#endif

using rk::RowA;
using rk::RowAp;
using rk::RowB;
using rk::RowBp;
using rk::RowE;
using rk::RowEp;

template <class W, int LEN>
__device__ __forceinline__ float wsum(const float* K, int i) {
  return rk::col_wsum<W, LEN, N>(K, i);
}

// (sum, compensation) of one column, as the JAX _comp_wsum
template <class W, int LEN>
__device__ __forceinline__ void comp_wsum(const float* K, int i, float& s,
                                          float& c) {
  rk::col_comp_wsum<W, LEN, N>(K, i, s, c);
}

// The stage row entry i at (t, Y): the RHS, or the acceleration of the
// positions Y[0..N) and velocities Y[N..2N); P the member's parameters.
__device__ __forceinline__ float stage_f(float t, const float* Y, int i,
                                         const float* P) {
  if constexpr (RKN) {
    return acc(t, Y, Y + N, i, P);
  } else {
    return rhs(t, Y, i, P);
  }
}

// Element j of the first-order derivative at (t, Y): [v, acc] for RKN.
__device__ __forceinline__ float deriv(float t, const float* Y, int j,
                                       const float* P) {
  if constexpr (RKN) {
    return j < N ? Y[N + j] : acc(t, Y, Y + N, j - N, P);
  } else {
    return rhs(t, Y, j, P);
  }
}

// deriv as the block start calls it
struct Deriv {
  const float* P;
  __device__ float operator()(float t, const float* Y, int j) const {
    return deriv(t, Y, j, P);
  }
};

// The member's parameters in its shared memory (the caller's barrier
// publishes them), or a null pointer without any.
template <class Group>
__device__ __forceinline__ const float* load_params(
    const Group& g, float* sm, const float* __restrict__ params,
    int member) {
  if constexpr (tab::NPAR > 0) {
    float* P = sm + kPar;
    rk::for_elements<tab::NPAR>(g, [&](int q) {
      P[q] = params[static_cast<size_t>(member) * tab::NPAR + q];
    });
    return P;
  } else {
    return nullptr;
  }
}

// The per-element loops of a stage and of the solution, each reading rows
// other than those it writes (__restrict__): a warp's lane computes the
// values of all its elements (8 positions at N = 256) before it stores
// them (rk::for_elements_put), so that their chains overlap.  The
// arithmetic is the parent's, expression for expression.

// An element's two entries: u and v of RKN (ERK uses u); and of a
// solution, with their lo carries.
struct Pair {
  float u, v;
};
struct Sol {
  Pair y, lo;
};
// and of an accepted step's commit, with the new K[0] entry
struct Commit {
  Pair y, lo;
  float k;
};

// Stage I's argument Y + h sum_j A_Ij K_j (RKN: positions and velocities)
// into a.
template <bool COMP, int I, class Group>
__device__ __forceinline__ void stage_arg(const Group& g, float h, float hh,
                                          float ch,
                                          const float* __restrict__ Y,
                                          const float* __restrict__ Ylo,
                                          const float* __restrict__ K,
                                          float* __restrict__ a) {
  rk::for_elements_put<N>(
      g,
      [&](int i) {
        if constexpr (RKN) {
          float du = hh * wsum<RowA<I>, I>(K, i) + ch * Y[N + i];
          float dv = h * wsum<RowAp<I>, I>(K, i);
          if constexpr (COMP) {
            du = du + Ylo[i];
            dv = dv + Ylo[N + i];
          }
          return Pair{Y[i] + du, Y[N + i] + dv};
        } else {
          const float dy = h * wsum<RowA<I>, I>(K, i);
          return Pair{COMP ? Y[i] + (dy + Ylo[i]) : Y[i] + dy, 0.0f};
        }
      },
      [&](int i, const Pair& x) {
        a[i] = x.u;
        if constexpr (RKN) a[N + i] = x.v;
      });
}

// The stage row at (t, Y) into out.
template <class Group>
__device__ __forceinline__ void stage_row(const Group& g, float t,
                                          const float* __restrict__ Y,
                                          float* __restrict__ out,
                                          const float* P) {
  rk::for_elements_put<N>(
      g, [&](int i) { return stage_f(t, Y, i, P); },
      [&](int i, float x) { out[i] = x; });
}

// Stages I..END-1 of one attempt of the group: stage I writes its argument
// into arg[b], takes the barrier and evaluates K[I]; b then flips.
template <bool COMP, int I, int END, class Group>
__device__ __forceinline__ void stages(Group& g, float t, float h, float hh,
                                       const float* Y, const float* Ylo,
                                       float* K, float* const (&arg)[2],
                                       int& b, const float* P, Clock& clk) {
  if constexpr (I < END) {
    float* a = arg[b];
    constexpr float c = tab::C(I);
    const float ch = c * h;
    stage_arg<COMP, I>(g, h, hh, ch, Y, Ylo, K, a);
    g.sync();
    clk.mark(kArgs);
    stage_row(g, t + ch, a, K + I * N, P);
    clk.mark(kRhs);
    b ^= 1;
    stages<COMP, I + 1, END>(g, t, h, hh, Y, Ylo, K, arg, b, P, clk);
  }
}

// The attempt's solution into Yn (and its lo carry into YloNew); element i
// carries u[i] and v[i] for RKN.
template <bool COMP, class Group>
__device__ __forceinline__ void solution(const Group& g, float h, float hh,
                                         const float* __restrict__ Y,
                                         const float* __restrict__ Ylo,
                                         const float* __restrict__ K,
                                         float* __restrict__ Yn,
                                         float* __restrict__ YloNew) {
  rk::for_elements_put<N>(
      g,
      [&](int i) {
        Pair y{0.0f, 0.0f}, lo{0.0f, 0.0f};
        if constexpr (RKN) {
          if constexpr (COMP) {
            float bs, bc, ps, pc, hi, l1, l2;
            comp_wsum<RowB, S>(K, i, bs, bc);
            comp_wsum<RowBp, S>(K, i, ps, pc);
            rk::df_add(Y[i], Ylo[i], __fmul_rn(h, Y[N + i]), hi, l1);
            rk::two_sum(hi, __fadd_rn(l1, __fmul_rn(hh, bs)), hi, l2);
            rk::two_sum(hi, __fadd_rn(l2, __fmul_rn(hh, bc)), y.u, lo.u);
            rk::df_add(Y[N + i], Ylo[N + i], __fmul_rn(h, ps), hi, l1);
            rk::two_sum(hi, __fadd_rn(l1, __fmul_rn(h, pc)), y.v, lo.v);
          } else {
            y.u = Y[i] + h * Y[N + i] + hh * wsum<RowB, S>(K, i);
            y.v = Y[N + i] + h * wsum<RowBp, S>(K, i);
          }
        } else {
          if constexpr (COMP) {
            float bs, bc, hi, lo1;
            comp_wsum<RowB, S>(K, i, bs, bc);
            rk::df_add(Y[i], Ylo[i], __fmul_rn(h, bs), hi, lo1);
            rk::two_sum(hi, __fadd_rn(lo1, __fmul_rn(h, bc)), y.u, lo.u);
          } else {
            y.u = Y[i] + h * wsum<RowB, S>(K, i);
          }
        }
        return Sol{y, lo};
      },
      [&](int i, const Sol& x) {
        Yn[i] = x.y.u;
        if constexpr (RKN) Yn[N + i] = x.y.v;
        if constexpr (COMP) {
          YloNew[i] = x.lo.u;
          if constexpr (RKN) YloNew[N + i] = x.lo.v;
        }
      });
}

// A member's start: its state Y from y0, K[0] = f(t0, Y) and the first |h|
// (Watts' start where asked, counted in nfev); P the member's parameters,
// written before the first barrier.
template <class Group>
__device__ float start(Group& g, float* Y, float* K,
                       const float* __restrict__ y0, const Launch& L,
                       const float* P, int& nfev) {
  rk::for_elements<NF>(g, [&](int j) { Y[j] = y0[j]; });
  g.sync();
  rk::for_elements<N>(g, [&](int i) { K[i] = stage_f(L.t0, Y, i, P); });
  nfev = 1;
  if (!L.use_hstart) return L.h0;
  float* w = K + N;
  g.sync();  // K[0] complete
  rk::for_elements<NF>(g, [&](int j) {
    w[j] = RKN ? (j < N ? Y[N + j] : K[j - N]) : K[j];
  });
  // max_step is +inf when the caller gave none
  const float bq = L.t0 + L.dir * fminf(fabsf(L.tf - L.t0), L.max_step);
  nfev = 2 + (NF + 1 < 3 ? NF + 1 : 3);
  return fabsf(rk::block_hstart<NF, tab::MORDER>(g, Deriv{P}, L.t0, bq, Y,
                                                 w, L.rtol, L.atol));
}

// The whole integration of one member by the group g (rank(), size(),
// sync(), sum(x) and min(x): reductions whose result every thread holds).
// sm is the member's shared memory (kFloats), y0 its initial state, params
// every member's NPAR parameters (null without any).
template <bool COMP, class Group>
__device__ void integrate(Group& g, float* sm, const float* __restrict__ y0,
                          const float* __restrict__ params, const Launch& L,
                          int member, const Out& out) {
  float* Y = sm + kY;
  float* K = sm + kK;
  float* Ylo = sm + kYlo;
  float* const arg[2] = {sm + kArg, sm + kArg + NF};
  float* YloNew = sm + kYloNew;
  const float* P = load_params(g, sm, params, member);

  int nfev;
  rk::StepControl ctl{start(g, Y, K, y0, L, P, nfev)};
  float t = L.t0;
  rk::for_elements<NF>(g, [&](int j) { Ylo[j] = 0.0f; });

  float t_lo = 0.0f;
  int status = kRunning;
  int nstep = 0;
  int it = 0;
  Clock clk;

  while (status == kRunning) {
    g.sync();  // the last attempt's commits and endpoint reads are done
    clk.mark(kCommit);

    float d;
    bool too_small;
    ctl.prepare(t, L.tf, L.max_step, d, too_small);
    const float h = ctl.h_abs * L.dir;
    const float hh = h * h;
    clk.mark(kControl);

    int b = 0;
    stages<COMP, 1, S>(g, t, h, hh, Y, Ylo, K, arg, b, P, clk);

    // the solution into arg[b]; element i carries u[i] and v[i] for RKN
    float* Yn = arg[b];
    solution<COMP>(g, h, hh, Y, Ylo, K, Yn, YloNew);
    if constexpr (tab::FSAL) {
      g.sync();
      clk.mark(kNorm);
      stage_row(g, t + h, Yn, K + S * N, P);
      clk.mark(kRhs);
    }

    // the error norm over NF; a non-finite element adds +inf
    float sq = 0.0f;
    rk::for_elements<N>(g, [&](int i) {
      float e0, e1 = 0.0f;
      if constexpr (COMP) {
        float s, c;
        comp_wsum<RowE, MM>(K, i, s, c);
        e0 = (RKN ? hh : h) * (s + c);
        if constexpr (RKN) {
          comp_wsum<RowEp, MM>(K, i, s, c);
          e1 = h * (s + c);
        }
      } else {
        e0 = (RKN ? hh : h) * wsum<RowE, MM>(K, i);
        if constexpr (RKN) e1 = h * wsum<RowEp, MM>(K, i);
      }
      bool finite = isfinite(Yn[i]);
      if constexpr (tab::FSAL) finite = finite && isfinite(K[S * N + i]);
      float q = e0 / (L.atol + L.rtol * fmaxf(fabsf(Y[i]), fabsf(Yn[i])));
      float part = q * q;
      if constexpr (RKN) {
        finite = finite && isfinite(Yn[N + i]);
        q = e1 / (L.atol +
                  L.rtol * fmaxf(fabsf(Y[N + i]), fabsf(Yn[N + i])));
        part = part + q * q;
      }
      sq += finite ? part : INFINITY;
    });
    clk.mark(kNorm);
    const float err_norm = sqrtf(g.sum(sq) / static_cast<float>(NF));
    clk.mark(kWait);
    // overflow: NaN/Inf anywhere ends this member with status 3
    const bool bad = !isfinite(err_norm);
    const bool accepted = err_norm < 1.0f && !too_small && !bad;

    if (too_small) {
      status = kTooSmall;
    } else if (bad) {
      status = kOverflow;
    }

    // exact landing on tf at the last step
    const bool is_last = accepted && ctl.h_abs >= d;
    ctl.update(err_norm, h, accepted);
    float t_new, t_lo_new;
    if constexpr (COMP) {
      float t_adv, t_lo_adv;
      rk::df_add(t, t_lo, h, t_adv, t_lo_adv);
      t_new = is_last ? L.tf : t_adv;
      t_lo_new = is_last ? 0.0f : t_lo_adv;
    } else {
      t_new = is_last ? L.tf : t + h;
      t_lo_new = t_lo;
    }
    if (status == kRunning && is_last) status = kFinished;
    clk.mark(kControl);

    nfev += tab::FSAL ? S : S - 1;
    if (accepted) {
      // each thread commits the elements it computed; a non-FSAL pair
      // evaluates the endpoint of accepted steps only
      rk::for_elements_put<N>(
          g,
          [&](int i) {
            Commit c{{Yn[i], 0.0f}, {0.0f, 0.0f}, 0.0f};
            if constexpr (RKN) c.y.v = Yn[N + i];
            if constexpr (COMP) {
              c.lo.u = YloNew[i];
              if constexpr (RKN) c.lo.v = YloNew[N + i];
            }
            c.k = tab::FSAL ? K[S * N + i] : stage_f(t_new, Yn, i, P);
            return c;
          },
          [&](int i, const Commit& c) {
            Y[i] = c.y.u;
            if constexpr (RKN) Y[N + i] = c.y.v;
            if constexpr (COMP) {
              Ylo[i] = c.lo.u;
              if constexpr (RKN) Ylo[N + i] = c.lo.v;
            }
            K[i] = c.k;
          });
      if constexpr (!tab::FSAL) nfev += 1;
      t = t_new;
      t_lo = t_lo_new;
      nstep += 1;
    }

    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (it >= L.max_steps && status == kRunning) status = kOverflow;
    ctl.end(accepted, status == kRunning);
    clk.mark(kCommit);
  }
  clk.write(g, member, it);

  g.sync();
  rk::for_elements<NF>(g, [&](int j) {
    out.y[static_cast<size_t>(member) * NF + j] = Y[j];
  });
  if (g.rank() == 0) {
    out.status[member] = status;
    out.nsteps[member] = nstep;
    out.nfev[member] = nfev;
  }
}

// The solution Y + h sum_j WB_j K_j over the first LEN stages into sol (own
// elements), and the RMS over the member of its error h sum_j WE_j K_j
// scaled by atol + rtol max(|Y|, |sol|), a group reduction (not yet
// clean()ed).
template <class WB, class WE, int LEN, class Group>
__device__ float assess(Group& g, const float* Y, const float* K, float h,
                        const Launch& L, float* sol, Clock& clk) {
  float sq = 0.0f;
  rk::for_elements<N>(g, [&](int i) {
    sol[i] = Y[i] + h * wsum<WB, LEN>(K, i);
    const float err = h * wsum<WE, LEN>(K, i);
    const float q =
        err / (L.atol + L.rtol * fmaxf(fabsf(Y[i]), fabsf(sol[i])));
    sq += q * q;
  });
  clk.mark(kNorm);
  const float s = g.sum(sq);
  clk.mark(kWait);
  return sqrtf(s / static_cast<float>(N));
}

// The whole integration of one member with CKdisc's cascade (B12), by the
// group g as integrate; ck_control.cuh has the cascade, fused_ckdisc.cu the
// same loop on one thread.  A full attempt takes ten barrier phases (the
// loop top, five stages, E1, E2, E4 and the endpoint's count of
// non-finite elements).  Its norms stay one reduction each, where the
// cascade reads them: E4's with the fallbacks' in one reduction, or all
// five in the JAX kernel's order, gave the same bits but ran 14-15% slower
// on an H100 (PERF.md §6, PR 13), since they compute assessments that the
// cascade mostly does not read.
template <class Group>
__device__ void integrate_ck(Group& g, float* sm, const float* __restrict__ y0,
                             const Launch& L, int member, const Out& out) {
  float* Y = sm + kY;
  float* K = sm + kK;
  float* const arg[2] = {sm + kArg, sm + kArg + NF};
  float* Ysol = K + S * N;  // the attempt's candidate solution
  const float* P = nullptr;  // B12 takes no parameters

  int nfev;
  ck::Control ctl{{start(g, Y, K, y0, L, P, nfev)}};
  float t = L.t0;
  int status = kRunning;
  int nstep = 0;
  int it = 0;
  Clock clk;

  while (status == kRunning) {
    g.sync();  // the last attempt's commits and endpoint reads are done
    clk.mark(kCommit);

    float d;
    bool too_small;
    ctl.prepare(t, L.tf, L.max_step, d, too_small);
    const float h = ctl.h_abs * L.dir;
    clk.mark(kControl);

    // E1 after two stages; E2 after four where E1 lets the attempt go on;
    // E4 after six where E2 does (kBig where skipped)
    int b = 0;
    stages<false, 1, 2>(g, t, h, h * h, Y, nullptr, K, arg, b, P, clk);
    const float E1 = sqrtf(ck::clean(
        assess<ck::RowBas<0>, ck::RowEas<0>, 2>(g, Y, K, h, L, Ysol, clk)));
    const bool go2 = ctl.go2(E1);
    float E2 = ck::kBig;
    if (go2) {
      stages<false, 2, 4>(g, t, h, h * h, Y, nullptr, K, arg, b, P, clk);
      E2 = ck::cbrt_floor(ck::clean(
          assess<ck::RowBas<1>, ck::RowEas<1>, 4>(g, Y, K, h, L, Ysol, clk)));
    }
    const bool go4 = go2 && ctl.go4(E2);
    float E4 = ck::kBig;
    bool bad4 = false;
    if (go4) {
      stages<false, 4, 6>(g, t, h, h * h, Y, nullptr, K, arg, b, P, clk);
      const float nm = assess<RowB, RowE, 6>(g, Y, K, h, L, Ysol, clk);
      bad4 = !isfinite(nm);
      E4 = ck::p5rt_floor(ck::clean(nm));
      if (E4 == 0.0f) E4 = 1e-38f;
    }
    clk.vetoes(go2, go4);
    const bool accept4 = go4 && E4 < 1.0f && !too_small;

    // the fallbacks: the 3rd-order solution at c = 3/5, else the 2nd-order
    // one at 1/5, each taken when its own error test passes
    bool fb3_ok = false;
    if (go4 && !accept4 && !bad4 && E2 < 1.0f && !too_small) {
      fb3_ok = ck::clean(assess<ck::RowBfb<1>, ck::RowEfb<1>, 4>(
                   g, Y, K, h, L, Ysol, clk)) < 1.0f;
    }
    const bool fb2_try =
        go2 && !accept4 && !bad4 && !fb3_ok && E1 < 1.0f && !too_small;
    bool fb2_ok = false;
    if (fb2_try) {
      fb2_ok = ck::clean(assess<ck::RowBfb<0>, ck::RowEfb<0>, 2>(
                   g, Y, K, h, L, Ysol, clk)) < 1.0f;
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
    const float t_new = is_last ? L.tf : t + h_used;
    if (status == kRunning && is_last) status = kFinished;
    clk.mark(kControl);

    nfev += 1 + (go2 ? 2 : 0) + (go4 ? 2 : 0);
    if (accepted) {
      // Ysol is complete: its norm's reduction was the last barrier.  The
      // endpoint derivative goes into K[0]; one reduction counts the
      // elements of the member that are not finite
      float bad = 0.0f;
      rk::for_elements<N>(g, [&](int i) {
        K[i] = stage_f(t_new, Ysol, i, P);
        bad += (isfinite(Ysol[i]) && isfinite(K[i])) ? 0.0f : 1.0f;
      });
      nfev += 1;
      clk.mark(kRhs);
      const float n_bad = g.sum(bad);
      clk.mark(kWait);
      if (n_bad == 0.0f) {
        rk::for_elements<N>(g, [&](int i) { Y[i] = Ysol[i]; });
        t = t_new;
        nstep += 1;
      } else {
        status = kOverflow;
      }
    }

    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (it >= L.max_steps && status == kRunning) status = kOverflow;
    ctl.end(accepted, status == kRunning);
    clk.mark(kCommit);
  }
  clk.write(g, member, it);

  g.sync();
  rk::for_elements<N>(g, [&](int j) {
    out.y[static_cast<size_t>(member) * N + j] = Y[j];
  });
  if (g.rank() == 0) {
    out.status[member] = status;
    out.nsteps[member] = nstep;
    out.nfev[member] = nfev;
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "block_group.cuh"

namespace {

#ifdef FUSED_RK_GRID_SECTIONS
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

template <bool COMP, class Group>
__device__ __forceinline__ void member_body(Group& g, float* sm,
                                            const float* __restrict__ y0,
                                            const float* __restrict__ params,
                                            const Launch& L, int member,
                                            const Out& out) {
  const float* y = y0 + static_cast<size_t>(member) * NF;
  if constexpr (tab::CK) {
    integrate_ck(g, sm, y, L, member, out);
  } else {
    integrate<COMP>(g, sm, y, params, L, member, out);
  }
}

template <bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
    fused_rk_grid_kernel(const float* __restrict__ y0,
                         const float* __restrict__ params, Launch L,
                         Out out) {
  extern __shared__ float sm[];
  __shared__ float red[64];
  auto g = group(BlockGroup{red});
  const int member = static_cast<int>(blockIdx.x);
  member_body<COMP>(g, sm, y0, params, L, member, out);
  write_phases(g, member);
}

// One warp per member, blockDim.x / 32 members a block, each warp on its own
// kFloats of the dynamic shared memory; a warp past the ensemble returns at
// once (no block barrier waits for it).  The ERK and RKN families (B4, B6):
// a CKdisc build compiles an empty body and its launch refuses a warp.  On
// the card the cascade's warp parted from its block of 32 threads in the
// last bits (9 of 1,024 ckmol members' counts; bit for bit with
// -fmad=false, so the compiler contracts some sum of the cascade otherwise
// in the two kernels), and it ran 1.3-2.7x slower than B12's blocks
// (measured on an H100; PERF.md §6).
template <bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
    fused_rk_grid_warp_kernel(const float* __restrict__ y0,
                              const float* __restrict__ params, Launch L,
                              Out out, int members) {
  if constexpr (!tab::CK) {
    extern __shared__ float sm[];
    const int warp = static_cast<int>(threadIdx.x >> 5);
    const int member =
        static_cast<int>(blockIdx.x * (blockDim.x >> 5)) + warp;
    if (member >= members) return;
    auto g = group(WarpGroup{});
    member_body<COMP>(g, sm + warp * kFloats, y0, params, L, member, out);
    write_phases(g, member);
  }
}

// Allows `bytes` of dynamic shared memory where it is above 48 KB.
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

#ifdef FUSED_RK_GRID_SECTIONS
// The probe build's counters: kSectionSlots unsigned values per member are
// written to `sections` by the launches that follow.
extern "C" int fused_rk_grid_sections(void* sections) {
  unsigned* ptr = static_cast<unsigned*>(sections);
  return static_cast<int>(
      cudaMemcpyToSymbol(g_sections, &ptr, sizeof(ptr)));
}
#endif

// The shared memory one member needs and the most a block may have on this
// card, in bytes; returns the CUDA error code.
extern "C" int fused_rk_grid_smem(int* need, int* limit) {
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
// threads (ERK and RKN only; threads must be 32, P at most kMaxThreads /
// 32; another shape is cudaErrorInvalidValue).  The members' rows are
// dynamic shared memory (above 48 KB after cudaFuncSetAttribute).  params
// holds NPAR floats a member (null where NPAR is 0).
extern "C" int fused_rk_grid_launch(const void* y0, const void* params,
                                    void* y_out, void* status,
                                    void* nstep, void* nfev, int members,
                                    float t0, float tf, float dir, float rtol,
                                    float atol, float h0, int use_hstart,
                                    float max_step, int max_steps,
                                    int compensated, int threads,
                                    int warp_members, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch L{t0, tf, dir, rtol, atol, h0, use_hstart, max_step,
                 max_steps};
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  const float* y0f = static_cast<const float*>(y0);
  const float* pf = static_cast<const float*>(params);
  const int member_bytes = static_cast<int>(kFloats * sizeof(float));
  if (warp_members > 0) {
    if (tab::CK || threads != 32 || warp_members > kMaxThreads / 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int bytes = warp_members * member_bytes;
    void (*kernel)(const float*, const float*, Launch, Out, int) =
        compensated ? fused_rk_grid_warp_kernel<true>
                    : fused_rk_grid_warp_kernel<false>;
    const cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (members + warp_members - 1) / warp_members;
    kernel<<<blocks, 32 * warp_members, bytes, st>>>(y0f, pf, L, out,
                                                     members);
    return static_cast<int>(cudaGetLastError());
  }
  void (*kernel)(const float*, const float*, Launch, Out) =
      compensated ? fused_rk_grid_kernel<true> : fused_rk_grid_kernel<false>;
  const cudaError_t e = allow_smem(kernel, member_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<members, threads, member_bytes, st>>>(y0f, pf, L, out);
  return static_cast<int>(cudaGetLastError());
}
