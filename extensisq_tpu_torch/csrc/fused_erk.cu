// Fused adaptive explicit Runge-Kutta ensemble solver for Hopper (sm_90a).
//
// Replaces extensisq_tpu/ops/fused_erk.py:solve_fused_erk, the Pallas kernel
// that runs a whole adaptive integration (_run_erk_loop) per launch, with the
// in-kernel Watts start of extensisq_tpu/ops/_hstart_tile.py:hstart_tile.
// Its plain PyTorch version is extensisq_tpu_torch/ops/fused_erk.py:
// fused_erk_reference; the two take the same steps up to round-off.
//
// Design: one member per thread (integrate_thread), or per group of G = 2,
// 4 or 8 lanes of one warp (integrate<G>, lane_group.cuh).  A member holds
// its y, y_lo, f and the K[S+1][N] stage rows in registers and runs its own
// adaptive loop (stages, error norm, controller, end landing) until its
// status leaves RUNNING; it reads device memory once at the start and lane
// 0 writes once at the end.  Every lane of a group runs the whole member,
// the RHS too, so the group branches together; the lanes split the norm's
// divisions and finiteness tests and the controller's powers left after
// folding (rk_lanes.cuh), with the one-thread bits at every G.
//
// What bounds it on the H100: each member is a long chain of dependent f32
// operations, and the launch lasts as long as the slowest member's chain.
// At vdp4096 (BS5, n = 2) the slowest member takes 51 attempts; their
// section clocks (tools/probe_fused_small.py, an instrumented build) put
// half of an attempt in the norm (two IEEE divisions and a sqrt) and the
// controller (one powf: BS5's other three fold away), and a third of the
// launch (26.6 us, plain, ten launches back to back) is a one-step
// launch's fixed cost (9.3 us).  Spreading members over all SMs gains
// nothing by itself (blocks of 32 tie blocks of 128: one warp a scheduler
// either way), and one thread already overlaps two divisions, so the plain
// mode keeps one thread per member; the compensated mode runs 6-10%
// faster on 4 or 8 lanes (ops/fused_erk.py:_lanes_per_member, from the
// member sweep).  262,144 members (2,048 blocks) fill the card on one
// thread each.  No shared memory and no padding: the last block masks
// member < B.
//
// Dense output (dense=R, ops/fused_erk.py): a build whose header sets
// tab::REC writes each accepted step's end (t, y, f) to its member's rows
// in device memory, rank 0 of a group as it writes the results
// (dense_record.cuh); f0 = f(t0, y0) once at the start.  The writes sit
// beside the arithmetic, which they leave as it is: y, status, nsteps and
// nfev are those of the build without them.  Without tab::REC the record
// parameter is never read and the kernels are those of the build before
// dense output.
//
// t_eval snapshots (ops/fused_erk.py): a build whose header sets tab::SNAP
// writes each point's row (snapshot.cuh) as the member's accepted step
// crosses it, the cubic Hermite of the step's end pairs read before y and
// f are overwritten (the high words in the compensated mode, as JAX's
// split_rows reads them), a step's crossed points split over the group's
// lanes (snapshot.cuh: snap_step); points at or before t0 take y0, the
// points left at the end the final y (rank 0 writing those).  Like the
// record the rows sit beside the arithmetic: the four outputs are those of
// the build without them.  A build with both switches serves t_eval with
// dense=R.
//
// The tableau (float32, rounded as the JAX kernel rounds it) and the user's
// right-hand side come from the generated header fused_erk_config.cuh:
//   namespace tab { N, NPAR, REC, SNAP, S, FSAL, A, B, C, E, controller
//                   constants, ... }
//   __device__ void rhs(float t, const float* y, float* dy);
// (or the template form rhs<T> of the implicit kernels, instantiated as
// rhs<float>); with NPAR = K > 0 per-member parameters, rhs takes a fourth
// argument, the member's K parameters (member_rhs.cuh), which a member
// loads into registers once, before its loop.  Weights are read through
// constexpr accessors at compile time, so zero weights drop out of the
// unrolled sums as they do at the JAX trace.  The sums, the double-single
// helpers and the starting step are shared with the implicit kernel
// (rk_common.cuh, hstart.cuh), the step control with the RKN and mid-size
// kernels (rk_control.cuh).
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

#include "dense_record.cuh"
#include "dual.cuh"
#include "fused_erk_config.cuh"
#include "hstart.cuh"
#include "member_rhs.cuh"
#include "rk_common.cuh"
#include "rk_control.cuh"
#include "rk_lanes.cuh"
#include "snapshot.cuh"

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
using Rhs = MemberRhs<tab::NPAR>;

// Stages I..S-1 of one attempt; K[0] holds f(t, y).
template <bool COMP, int I>
__device__ __forceinline__ void stages(const Rhs& fn, float t, float h,
                                       const float (&y)[N],
                                       const float (&y_lo)[N], Stages& K,
                                       rk::Clock& clk) {
  if constexpr (I < S) {
    float acc[N], arg[N];
    rk::wsum<Row<I>, I>(acc, K);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float dy = h * acc[k];
      arg[k] = COMP ? y[k] + (dy + y_lo[k]) : y[k] + dy;
    }
    clk.mark(rk::kStageSums);
    constexpr float c = weight(kRowC, I);
    fn(t + c * h, arg, K[I]);
    clk.mark(rk::kRhs);
    stages<COMP, I + 1>(fn, t, h, y, y_lo, K, clk);
  }
}

using rk::Launch;
using rk::OneLane;
using rk::Out;
using rk::Rec;
using rk::Snap;

// The whole integration of one member by the group grp of G lanes (rank(),
// shfl(v, src); OneLane at G = 1) from its initial state y0 with its
// parameters par (tab::NPAR floats; unread when there are none); lane 0
// writes the results, with tab::REC the member's record rec and with
// tab::SNAP its t_eval rows snap.  At G = 1
// the norm and the controller run as one thread runs them; at G > 1 their
// divisions and powers are split over the lanes (rk_lanes.cuh), with the
// same bits.
template <int G, bool COMP, class Group>
__device__ __forceinline__ void integrate(Group& grp,
                                          const float* __restrict__ y0,
                                          const float* __restrict__ par,
                                          const Launch& L, int member,
                                          const Out& out,
                                          const Rec& rec = Rec{},
                                          const Snap& snap = Snap{}) {
  const Rhs fn(par);
  const float tf = L.tf;
  const float rtol = L.rtol;
  const float atol = L.atol;
  const float max_step = L.max_step;
  float y[N], y_lo[N], f[N];
  Stages K;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    y[k] = y0[k];
    y_lo[k] = 0.0f;
  }
  const float span = tf - L.t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  float t = L.t0;
  float t_lo = 0.0f;
  fn(t, y, f);
  if constexpr (tab::REC) {
    if (grp.rank() == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        rec.f0[static_cast<size_t>(member) * N + k] = f[k];
      }
    }
  }
  rk::StepControl ctl{L.h0};
  int nfev = 1;
  if (L.use_hstart) {
    // max_step is +inf when the caller gave none
    const float bq = t + dir * fminf(fabsf(tf - t), max_step);
    ctl.h_abs =
        fabsf(rk::hstart<N, tab::MORDER>(t, bq, y, f, rtol, atol, fn));
    nfev = 2 + (N + 1 < 3 ? N + 1 : 3);
  }
  // the next sorted t_eval point (tab::SNAP): those at or before t0 take y0
  rk::Cursor cur;
  if constexpr (tab::SNAP) {
    cur = rk::cursor_at(snap, snap.past(0, dir, t));
    if (grp.rank() == 0) rk::snap_fill(snap, 0, cur.q, member, y);
  }

  int status = kRunning;
  int nstep = 0;
  int it = 0;
  int nrec = 0;  // rows of the record written (tab::REC)
  rk::Clock clk;

  while (status == kRunning) {
    float d;
    bool too_small;
    ctl.prepare(t, tf, max_step, d, too_small);
    const float h = ctl.h_abs * dir;
    // the cursor's Hermite weights over this attempt (tab::SNAP), formed
    // here to overlap the stages
    rk::HermiteWeights w{};
    if constexpr (tab::SNAP) w = rk::cursor_weights(cur, t, h);

    // stages, solution and error estimate
#pragma unroll
    for (int k = 0; k < N; ++k) K[0][k] = f[k];
    clk.mark(rk::kLoop);
    stages<COMP, 1>(fn, t, h, y, y_lo, K, clk);
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
    clk.mark(rk::kSolution);
    if constexpr (tab::FSAL) fn(t + h, y_new, K[S]);
    clk.mark(rk::kRhs);
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
    clk.mark(rk::kSolution);
    float err_norm;
    bool bad;
    if constexpr (G == 1) {
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
      err_norm = sqrtf(sq / static_cast<float>(N));
      // overflow: NaN/Inf anywhere ends this member with status 3
      bad = !(finite && isfinite(err_norm));
    } else {
      // a non-finite y_new or FSAL stage makes the norm non-finite
      const float(&fsal)[N] = tab::FSAL ? K[S] : y_new;
      err_norm = rk::lane_norm<G>(grp, err, y, y_new, fsal, rtol, atol);
      bad = !isfinite(err_norm);
    }
    const bool accepted = err_norm < 1.0f && !too_small && !bad;
    clk.mark(rk::kNorm);

    if (too_small) {
      status = kTooSmall;
    } else if (bad) {
      status = kOverflow;
    }

    // exact landing: the look-ahead clamps h_abs <= d, with equality only
    // on the last step, which then lands on tf exactly
    const bool is_last = accepted && ctl.h_abs >= d;
    clk.mark(rk::kLoop);
    if constexpr (G == 1) {
      ctl.update(err_norm, h, accepted);
    } else {
      float pw[4];
      rk::lane_powers<G>(grp, ctl, err_norm, h, pw);
      ctl.update(err_norm, h, accepted, pw);
    }
    clk.mark(rk::kControl);
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
      if constexpr (tab::SNAP) {
        // the points this step crosses, from its end pairs
        float f_new[N];
        if constexpr (tab::FSAL) {
#pragma unroll
          for (int k = 0; k < N; ++k) f_new[k] = K[S][k];
        } else {
          fn(t_new, y_new, f_new);
          nfev += 1;
        }
        cur = rk::snap_step<N, G>(snap, cur, w, member, grp.rank(), dir, t,
                                  t_new, h, y, f, y_new, f_new);
#pragma unroll
        for (int k = 0; k < N; ++k) f[k] = f_new[k];
      } else if constexpr (tab::FSAL) {
#pragma unroll
        for (int k = 0; k < N; ++k) f[k] = K[S][k];
      } else {
        fn(t_new, y_new, f);
        nfev += 1;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        y[k] = y_new[k];
        y_lo[k] = y_lo_new[k];
      }
      t = t_new;
      t_lo = t_lo_new;
      // the step's end at row nstep, while the attempts are below rows
      if constexpr (tab::REC) {
        if (it < rec.rows) {
          if (grp.rank() == 0) {
            const size_t row = rec.row(member, nstep);
            rec.t[row] = t;
#pragma unroll
            for (int k = 0; k < N; ++k) {
              rec.y[row * N + k] = y[k];
              rec.f[row * N + k] = f[k];
            }
          }
          nrec += 1;
        }
      }
      nstep += 1;
    }

    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (it >= L.max_steps && status == kRunning) status = kOverflow;
    ctl.end(accepted, status == kRunning);
    clk.mark(rk::kLoop);
  }

  if (grp.rank() != 0) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    out.y[static_cast<size_t>(member) * N + k] = y[k];
  }
  out.status[member] = status;
  out.nstep[member] = nstep;
  out.nfev[member] = nfev;
  if constexpr (tab::REC) rec.n[member] = nrec;
  // the points the member never reached take its final y
  if constexpr (tab::SNAP) rk::snap_fill(snap, cur.q, snap.nq, member, y);
  clk.write(member, it);
}

// One thread per member: the group body on one lane, for ensembles that
// fill the card.
template <bool COMP>
__device__ void integrate_thread(const float* __restrict__ y0,
                                 const float* __restrict__ par,
                                 const Launch& L, int member,
                                 const Out& out, const Rec& rec = Rec{},
                                 const Snap& snap = Snap{}) {
  OneLane one;
  integrate<1, COMP>(one, y0, par, L, member, out, rec, snap);
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "lane_group.cuh"

namespace {

template <int G, bool COMP>
__global__ void fused_erk_kernel(const float* __restrict__ y0,
                                 const float* __restrict__ par, Out out,
                                 int B, int block_members, Launch L,
                                 Rec rec, Snap snap) {
  const int member =
      blockIdx.x * block_members + static_cast<int>(threadIdx.x) / G;
  if (member >= B) return;  // ragged last block: no member padding
  const float* y0m = y0 + static_cast<size_t>(member) * N;
  const float* parm = par + static_cast<size_t>(member) * tab::NPAR;
  if constexpr (G == 1) {
    integrate_thread<COMP>(y0m, parm, L, member, out, rec, snap);
  } else {
    LaneGroup<G> grp;
    integrate<G, COMP>(grp, y0m, parm, L, member, out, rec, snap);
  }
}

template <int G>
int launch(const float* y0, const float* par, const Out& out, int B,
           const Launch& L, int compensated, int block_members,
           const Rec& rec, const Snap& snap, cudaStream_t s) {
  const int blocks = (B + block_members - 1) / block_members;
  const int threads = block_members * G;
  if (compensated) {
    fused_erk_kernel<G, true><<<blocks, threads, 0, s>>>(
        y0, par, out, B, block_members, L, rec, snap);
  } else {
    fused_erk_kernel<G, false><<<blocks, threads, 0, s>>>(
        y0, par, out, B, block_members, L, rec, snap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef FUSED_SMALL_SECTIONS
// The probe build's section clocks: rk::kSectionSlots unsigned counters per
// member are written to `sections` by the launches that follow.
extern "C" int fused_erk_sections(void* sections) {
  unsigned* ptr = static_cast<unsigned*>(sections);
  return static_cast<int>(
      cudaMemcpyToSymbol(rk::g_sections, &ptr, sizeof(ptr)));
}
#endif

// Launches block_members members per block, `lanes` (1, 2, 4 or 8)
// threads per member, on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for another lane count); the
// wrapper raises on anything but 0.  params is (B, tab::NPAR) float32,
// row-major (null when NPAR is 0).
static int launch_lanes(const void* y0, const void* params, void* y_out,
                        void* status, void* nstep, void* nfev, int B,
                        const Launch& L, int compensated, int lanes,
                        int block_members, const Rec& rec,
                        const Snap& snap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  const float* par = static_cast<const float*>(params);
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  switch (lanes) {
    case 1:
      return launch<1>(y0f, par, out, B, L, compensated, block_members, rec,
                       snap, s);
    case 2:
      return launch<2>(y0f, par, out, B, L, compensated, block_members, rec,
                       snap, s);
    case 4:
      return launch<4>(y0f, par, out, B, L, compensated, block_members, rec,
                       snap, s);
    case 8:
      return launch<8>(y0f, par, out, B, L, compensated, block_members, rec,
                       snap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch of a build without dense output or snapshots
// (cudaErrorInvalidValue for a build with either: those take
// fused_erk_record_launch and fused_erk_snap_launch).
extern "C" int fused_erk_launch(const void* y0, const void* params,
                                void* y_out, void* status,
                                void* nstep, void* nfev, int B, float t0,
                                float tf, float rtol, float atol, float h0,
                                int use_hstart, float max_step, int max_steps,
                                int compensated, int lanes, int block_members,
                                void* stream) {
  if (tab::REC || tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  return launch_lanes(y0, params, y_out, status, nstep, nfev, B, L,
                      compensated, lanes, block_members, Rec{}, Snap{},
                      stream);
}

// The launch of a build with dense output (tab::REC): as fused_erk_launch,
// and each member writes its record (dense_record.cuh) to rec_t (B, rows),
// rec_y and rec_f (B, rows, N), rec_f0 (B, N) and rec_n (B,) int32.
// cudaErrorInvalidValue for a build without it, one with snapshots or rows
// < 1.
extern "C" int fused_erk_record_launch(
    const void* y0, const void* params, void* y_out, void* status,
    void* nstep, void* nfev, int B, float t0, float tf, float rtol,
    float atol, float h0, int use_hstart, float max_step, int max_steps,
    int compensated, int lanes, int block_members, void* rec_t, void* rec_y,
    void* rec_f, void* rec_f0, void* rec_n, int rows, void* stream) {
  if (!tab::REC || tab::SNAP || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  return launch_lanes(y0, params, y_out, status, nstep, nfev, B, L,
                      compensated, lanes, block_members, rec, Snap{}, stream);
}

// The launch of a build with snapshots (tab::SNAP): as
// fused_erk_record_launch, the record's arguments null with rows 0 for a
// build without it, and each member writes the rows (snapshot.cuh) of the
// nq points tq (float32, sorted in the direction of integration) at their
// indices idx (int32) in t_eval to y_eval (nq, B, N).
// cudaErrorInvalidValue for a build without tab::SNAP, nq < 1, or rows
// that disagree with tab::REC.
extern "C" int fused_erk_snap_launch(
    const void* y0, const void* params, void* y_out, void* status,
    void* nstep, void* nfev, int B, float t0, float tf, float rtol,
    float atol, float h0, int use_hstart, float max_step, int max_steps,
    int compensated, int lanes, int block_members, void* rec_t, void* rec_y,
    void* rec_f, void* rec_f0, void* rec_n, int rows, const void* tq,
    const void* idx, void* y_eval, int nq, void* stream) {
  if (!tab::SNAP || nq < 1 || (rows > 0) != tab::REC || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  const Snap snap{static_cast<const float*>(tq), static_cast<const int*>(idx),
                  static_cast<float*>(y_eval), nq, B};
  return launch_lanes(y0, params, y_out, status, nstep, nfev, B, L,
                      compensated, lanes, block_members, rec, snap, stream);
}
