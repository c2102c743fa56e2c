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
// Design: one member per thread (integrate_thread), or per group of G = 2
// to 32 lanes of one warp (integrate<G>, lane_group.cuh), as fused_erk.cu.
// A member holds y, f and the six stage rows K[6][N] in registers and runs
// its own cascade (ck_control.cuh) until its status leaves RUNNING.  Every
// lane of a group runs the whole member, the RHS and the roots too, so the
// group takes the cascade's branches together; the lanes split each
// assessment's divisions and the step control's five quotients
// (lane_assess, lane_quotients), with the one-thread bits at every G.
// Unlike the TPU kernel, which computes all six stages for every member of
// a tile and applies the cascade as masks, a member really skips stages
// 3-6 when E1 or E2 vetoes, and evaluates f at the new point only on
// acceptance.  The results are the same: E2 is read only where go2 holds,
// E4 and the 3rd-order fallback only where go4 holds.  nfev counts the
// evaluations of the reference method, 1 + 2 go2 + 2 go4 per attempt plus
// the endpoint of an accepted one, as the JAX kernel counts them, an
// attempt that ends in status 2 included.
//
// What bounds it on the H100: a long chain of dependent f32 operations per
// member (up to six stages with their RHS, four assessments, two powf
// roots and the step control per attempt), and a launch lasts as long as
// its slowest member's chain.  On config 1c's line (tools/
// probe_fused_small.py --family ck) the slowest member takes 83 attempts;
// one thread per member puts 32 cascades in a warp, which took other paths
// in 87% of a member's attempts and ran each attempt at the cost of the
// union of its members' branches (3,765 cycles an attempt, 56% of it in
// the assessments and the control, their waits for the other members
// included).  A warp per member runs the chain alone (2,942 cycles), so
// ensembles of up to two warps per SM sub-partition take 32, 16 or 8 lanes
// (ops/fused_ckdisc.py:_lanes_per_member: 146.7 -> 113.8 us a launch of
// 1,024 members); beyond, the lanes' issue slots cost more than they
// save, and one thread per member stays.
//
// The tableau, the cascade's weight rows (float32, rounded as the JAX kernel
// rounds them) and the user's right-hand side come from the generated header
// fused_ckdisc_config.cuh:
//   namespace tab { N, NPAR, SNAP, S, MORDER, A(i, j), B(j), C(i), E(j),
//                   BAS(r, j), EAS(r, j), BFB(r, j), EFB(r, j), CFB(r), step
//                   and start constants }
//   __device__ void rhs(float t, const float* y, float* dy);
// with NPAR = K > 0 per-member parameters, rhs takes a fourth argument, the
// member's K parameters (member_rhs.cuh), which a member loads into
// registers once, before its loop, as B1 does; every evaluation takes them,
// the starting step's too.
//
// t_eval snapshots (ops/fused_ckdisc.py): a build whose header sets
// tab::SNAP writes each point's row (snapshot.cuh) as the member's accepted
// sub-step [t, t + h_used] crosses it, h_used being the step as a fallback
// shortened it, from the end pairs (y, f) and (y_new, f_new) before they are
// overwritten, a step's crossed points split over the group's lanes (rank 0
// writing those at the start and the end); the four outputs are those of
// the build without it.
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
#include "rk_lanes.cuh"
#include "member_rhs.cuh"
#include "snapshot.cuh"

namespace {

using tab::N;
constexpr int S = 6;
static_assert(tab::S == S, "CKdisc has six stages");

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;

using Stages = float[S][N];
using Rhs = MemberRhs<tab::NPAR>;

// The probe build's sections of an attempt (rk::Clock's slots).
enum Section {
  kStageSums,  // the stage arguments: weighted sums of the earlier stages
  kRhs,        // the right-hand side evaluations, the endpoint's included
  kAssess,     // the assessments: their sums, divisions and square roots
  kRoots,      // the roots of E2 and E4
  kControl,    // the cascade's decisions and the step control's update
  kLoop,       // the step limits, landing, status, commit and step cap
  kSectionCount
};
static_assert(kSectionCount == rk::kSections, "one slot a section");

// The probe build's warp readings of a member: the attempts of the slowest
// member of its warp, and the attempts in which its warp's members took
// other cascade paths (go2, go4, accept4, fb3_ok).  Empty in the shipped
// build.
constexpr int kWarpSlots = 2;
#ifdef FUSED_SMALL_SECTIONS
__device__ unsigned* g_warp;  // [member][kWarpSlots]
struct WarpReading {
  unsigned split = 0;
  __device__ void attempt(bool go2, bool go4, bool accept4, bool fb3_ok) {
    const unsigned m = __activemask();
    const unsigned b0 = __ballot_sync(m, go2), b1 = __ballot_sync(m, go4);
    const unsigned b2 = __ballot_sync(m, accept4);
    const unsigned b3 = __ballot_sync(m, fb3_ok);
    split += ((b0 != 0u && b0 != m) || (b1 != 0u && b1 != m) ||
              (b2 != 0u && b2 != m) || (b3 != 0u && b3 != m))
                 ? 1u
                 : 0u;
  }
  __device__ void write(int member, int attempts) const {
    const unsigned slowest =
        __reduce_max_sync(__activemask(), static_cast<unsigned>(attempts));
    g_warp[static_cast<size_t>(member) * kWarpSlots] = slowest;
    g_warp[static_cast<size_t>(member) * kWarpSlots + 1] = split;
  }
};
#else
struct WarpReading {
  __device__ void attempt(bool, bool, bool, bool) {}
  __device__ void write(int, int) const {}
};
#endif

// Stages I..END-1 of one attempt; K[0] holds f(t, y).
template <int I, int END>
__device__ __forceinline__ void stages(const Rhs& fn, float t, float h,
                                       const float (&y)[N], Stages& K,
                                       rk::Clock& clk) {
  if constexpr (I < END) {
    float acc[N], arg[N];
    rk::wsum<rk::RowA<I>, I>(acc, K);
#pragma unroll
    for (int k = 0; k < N; ++k) arg[k] = y[k] + h * acc[k];
    clk.mark(kStageSums);
    fn(t + tab::C(I) * h, arg, K[I]);
    clk.mark(kRhs);
    stages<I + 1, END>(fn, t, h, y, K, clk);
  }
}

// The solution y + h sum_j WB_j K_j over the first LEN stages into sol, and
// the RMS of its error h sum_j WE_j K_j scaled by atol + rtol max(|y|, |sol|)
// (not yet clean()ed), as one thread computes it.
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

// The same by a group of G lanes: every lane computes the sums and the
// solution, lane r divides the components r, r + G, ... (rk::lane_entry),
// and the quotients reach every lane by shuffle and are squared and summed
// in component order, as assess sums them.  (The thread body keeps assess:
// this form at one lane compiled to 8 more instructions and ran 1.4%
// slower.)
template <class WB, class WE, int LEN, int G, class Group>
__device__ __forceinline__ float lane_assess(Group& grp,
                                             const float (&y)[N], float h,
                                             const Stages& K, float rtol,
                                             float atol, float (&sol)[N]) {
  float b[N], e[N], err[N];
  rk::wsum<WB, LEN>(b, K);
  rk::wsum<WE, LEN>(e, K);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sol[k] = y[k] + h * b[k];
    err[k] = h * e[k];
  }
  constexpr int Q = (N + G - 1) / G;  // components per lane
  const int rank = grp.rank();
  float r[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float scale =
        atol + rtol * fmaxf(fabsf(rk::lane_entry<G>(y, q, rank)),
                            fabsf(rk::lane_entry<G>(sol, q, rank)));
    r[q] = rk::lane_entry<G>(err, q, rank) / scale;
  }
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ri = grp.shfl(r[i / G], i % G);
    sq = sq + ri * ri;
  }
  return sqrtf(sq / static_cast<float>(N));
}

// One assessment by the group: assess at one lane, else lane_assess.
template <class WB, class WE, int LEN, int G, class Group>
__device__ __forceinline__ float assessment(Group& grp, const float (&y)[N],
                                            float h, const Stages& K,
                                            float rtol, float atol,
                                            float (&sol)[N]) {
  if constexpr (G == 1) {
    return assess<WB, WE, LEN>(y, h, K, rtol, atol, sol);
  } else {
    return lane_assess<WB, WE, LEN, G>(grp, y, h, K, rtol, atol, sol);
  }
}

// The step control's independent quotients (ck::Control::quotient_terms)
// in every lane of the group: lane r divides the quotients r, r + G, ....
template <int G, class Group>
__device__ __forceinline__ void lane_quotients(Group& grp,
                                               const ck::Control& ctl,
                                               float E1, float E2, float E4,
                                               float (&qt)[ck::kQuotients]) {
  constexpr int P = ck::kQuotients;
  constexpr int Q = (P + G - 1) / G;  // quotients per lane
  float mine[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float num, den;
    ctl.quotient_terms(k * G + grp.rank(), E1, E2, E4, num, den);
    mine[k] = num / den;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) qt[i] = grp.shfl(mine[i / G], i % G);
}

using rk::Launch;
using rk::OneLane;
using rk::Out;
using rk::Snap;

// The whole integration of one member by the group grp of G lanes (rank(),
// shfl(v, src); OneLane at G = 1) from its initial state y0 with its
// parameters par (tab::NPAR floats; unread when there are none); lane 0
// writes the results, and with tab::SNAP the member's t_eval rows snap.
// At G = 1 the step control runs as one thread runs it; at G > 1 the
// assessments' and the step control's divisions are split over the lanes,
// with the same bits.
template <int G, class Group>
__device__ __forceinline__ void integrate(Group& grp,
                                          const float* __restrict__ y0,
                                          const float* __restrict__ par,
                                          const Launch& L, int member,
                                          const Out& out,
                                          const Snap& snap = Snap{}) {
  const Rhs fn(par);
  const float tf = L.tf;
  const float rtol = L.rtol;
  const float atol = L.atol;
  const float max_step = L.max_step;
  float y[N], f[N];
  Stages K;
#pragma unroll
  for (int k = 0; k < N; ++k) y[k] = y0[k];
  const float span = tf - L.t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  float t = L.t0;
  fn(t, y, f);
  ck::Control ctl{{L.h0}};
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
  rk::Clock clk;
  WarpReading warp;

  while (status == kRunning) {
    float d;
    bool too_small;
    ctl.prepare(t, tf, max_step, d, too_small);
    const float h = ctl.h_abs * dir;

#pragma unroll
    for (int k = 0; k < N; ++k) K[0][k] = f[k];
    float y_new[N];
    clk.mark(kLoop);

    // E1 after two stages; E2 after four where E1 lets the attempt go on;
    // E4 after six where E2 does (kBig where skipped)
    stages<1, 2>(fn, t, h, y, K, clk);
    const float E1 = sqrtf(ck::clean(
        assessment<ck::RowBas<0>, ck::RowEas<0>, 2, G>(grp, y, h, K, rtol,
                                                       atol, y_new)));
    clk.mark(kAssess);
    const bool go2 = ctl.go2(E1);
    float E2 = ck::kBig;
    clk.mark(kControl);
    if (go2) {
      stages<2, 4>(fn, t, h, y, K, clk);
      const float nm =
          ck::clean(assessment<ck::RowBas<1>, ck::RowEas<1>, 4, G>(
              grp, y, h, K, rtol, atol, y_new));
      clk.mark(kAssess);
      E2 = ck::cbrt_floor(nm);
      clk.mark(kRoots);
    }
    const bool go4 = go2 && ctl.go4(E2);
    float E4 = ck::kBig;
    bool bad4 = false;
    clk.mark(kControl);
    if (go4) {
      stages<4, 6>(fn, t, h, y, K, clk);
      const float nm = assessment<rk::RowB, rk::RowE, 6, G>(grp, y, h, K,
                                                            rtol, atol, y_new);
      bad4 = !isfinite(nm);
      clk.mark(kAssess);
      E4 = ck::p5rt_floor(ck::clean(nm));
      if (E4 == 0.0f) E4 = 1e-38f;
      clk.mark(kRoots);
    }
    const bool accept4 = go4 && E4 < 1.0f && !too_small;
    clk.mark(kControl);

    // the fallbacks: the 3rd-order solution at c = 3/5, else the 2nd-order
    // one at 1/5, each taken when its own error test passes
    bool fb3_ok = false;
    if (go4 && !accept4 && !bad4 && E2 < 1.0f && !too_small) {
      fb3_ok = ck::clean(assessment<ck::RowBfb<1>, ck::RowEfb<1>, 4, G>(
                   grp, y, h, K, rtol, atol, y_new)) < 1.0f;
    }
    const bool fb2_try =
        go2 && !accept4 && !bad4 && !fb3_ok && E1 < 1.0f && !too_small;
    bool fb2_ok = false;
    if (fb2_try) {
      fb2_ok = ck::clean(assessment<ck::RowBfb<0>, ck::RowEfb<0>, 2, G>(
                   grp, y, h, K, rtol, atol, y_new)) < 1.0f;
    }
    const bool accepted = accept4 || fb3_ok || fb2_ok;
    clk.mark(kAssess);
    warp.attempt(go2, go4, accept4, fb3_ok);

    // a fallback shortens this step: its weights sum to C_fallback
    const float h_used =
        accept4 ? h : (fb3_ok ? h * tab::CFB(1) : h * tab::CFB(0));
    if constexpr (G == 1) {
      ctl.update(E1, E2, E4, go2, go4, accept4, fb3_ok, fb2_try);
    } else {
      float qt[ck::kQuotients];
      lane_quotients<G>(grp, ctl, E1, E2, E4, qt);
      ctl.update(E1, E2, E4, go2, go4, accept4, fb3_ok, fb2_try, qt);
    }
    clk.mark(kControl);

    if (too_small) {
      status = kTooSmall;
    } else if (bad4) {
      status = kOverflow;
    }
    const bool is_last = accepted && fabsf(h_used) >= d;
    const float t_new = is_last ? tf : t + h_used;
    if (status == kRunning && is_last) status = kFinished;

    nfev += 1 + (go2 ? 2 : 0) + (go4 ? 2 : 0);
    clk.mark(kLoop);
    if (accepted) {
      float f_new[N];
      fn(t_new, y_new, f_new);
      clk.mark(kRhs);
      nfev += 1;
      bool finite = true;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        finite = finite && isfinite(y_new[k]) && isfinite(f_new[k]);
      }
      if (finite) {
        if constexpr (tab::SNAP) {
          // the points the accepted sub-step crosses, from its end pairs
          cur = rk::snap_step<N, G>(snap, cur, member, grp.rank(), dir, t,
                                    t_new, h_used, y, f, y_new, f_new);
        }
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
    if (it >= L.max_steps && status == kRunning) status = kOverflow;
    ctl.end(accepted, status == kRunning);
    clk.mark(kLoop);
  }

  if (grp.rank() != 0) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    out.y[static_cast<size_t>(member) * N + k] = y[k];
  }
  out.status[member] = status;
  out.nstep[member] = nstep;
  out.nfev[member] = nfev;
  // the points the member never reached take its final y
  if constexpr (tab::SNAP) rk::snap_fill(snap, cur.q, snap.nq, member, y);
  clk.write(member, it);
  warp.write(member, it);
}

// One thread per member: the group body on one lane, the parent's
// thread-per-member kernel.
__device__ void integrate_thread(const float* __restrict__ y0,
                                 const float* __restrict__ par,
                                 const Launch& L, int member, const Out& out,
                                 const Snap& snap = Snap{}) {
  OneLane one;
  integrate<1>(one, y0, par, L, member, out, snap);
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "lane_group.cuh"

namespace {

template <int G>
__global__ void fused_ckdisc_kernel(const float* __restrict__ y0,
                                    const float* __restrict__ par, Out out,
                                    int B, int block_members, Launch L,
                                    Snap snap) {
  const int member =
      blockIdx.x * block_members + static_cast<int>(threadIdx.x) / G;
  if (member >= B) return;  // ragged last block: no member padding
  const float* y0m = y0 + static_cast<size_t>(member) * N;
  const float* parm = par + static_cast<size_t>(member) * tab::NPAR;
  if constexpr (G == 1) {
    integrate_thread(y0m, parm, L, member, out, snap);
  } else {
    LaneGroup<G> grp;
    integrate<G>(grp, y0m, parm, L, member, out, snap);
  }
}

template <int G>
int launch(const float* y0, const float* par, const Out& out, int B,
           const Launch& L, int block_members, const Snap& snap,
           cudaStream_t s) {
  const int blocks = (B + block_members - 1) / block_members;
  fused_ckdisc_kernel<G><<<blocks, block_members * G, 0, s>>>(
      y0, par, out, B, block_members, L, snap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef FUSED_SMALL_SECTIONS
// The probe build's readings: rk::kSectionSlots section counters and
// kWarpSlots warp readings per member, written by the launches that follow.
extern "C" int fused_ckdisc_sections(void* sections, void* warp) {
  unsigned* ptr = static_cast<unsigned*>(sections);
  unsigned* wptr = static_cast<unsigned*>(warp);
  const cudaError_t rc =
      cudaMemcpyToSymbol(rk::g_sections, &ptr, sizeof(ptr));
  return static_cast<int>(
      rc != cudaSuccess ? rc : cudaMemcpyToSymbol(g_warp, &wptr,
                                                  sizeof(wptr)));
}
#endif

// Launches block_members members per block, `lanes` (1, 2, 4, 8, 16 or 32)
// threads per member, on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for another lane count); the
// wrapper raises on anything but 0.  params is (B, tab::NPAR) float32,
// row-major (null when NPAR is 0).
static int launch_lanes(const void* y0, const void* params, void* y_out,
                        void* status, void* nstep, void* nfev, int B,
                        const Launch& L, int lanes, int block_members,
                        const Snap& snap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  const float* par = static_cast<const float*>(params);
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  switch (lanes) {
    case 1:
      return launch<1>(y0f, par, out, B, L, block_members, snap, s);
    case 2:
      return launch<2>(y0f, par, out, B, L, block_members, snap, s);
    case 4:
      return launch<4>(y0f, par, out, B, L, block_members, snap, s);
    case 8:
      return launch<8>(y0f, par, out, B, L, block_members, snap, s);
    case 16:
      return launch<16>(y0f, par, out, B, L, block_members, snap, s);
    case 32:
      return launch<32>(y0f, par, out, B, L, block_members, snap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch of a build without snapshots (cudaErrorInvalidValue for a
// build with them: that one takes fused_ckdisc_snap_launch).
extern "C" int fused_ckdisc_launch(const void* y0, const void* params,
                                   void* y_out, void* status, void* nstep,
                                   void* nfev, int B, float t0, float tf,
                                   float rtol, float atol, float h0,
                                   int use_hstart, float max_step,
                                   int max_steps, int lanes,
                                   int block_members, void* stream) {
  if (tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  return launch_lanes(y0, params, y_out, status, nstep, nfev, B, L, lanes,
                      block_members, Snap{}, stream);
}

// The launch of a build with snapshots (tab::SNAP): as fused_ckdisc_launch,
// and each member writes the rows (snapshot.cuh) of the nq points tq
// (float32, sorted in the direction of integration) at their indices idx
// (int32) in t_eval to y_eval (nq, B, N).  cudaErrorInvalidValue for a
// build without it or nq < 1.
extern "C" int fused_ckdisc_snap_launch(
    const void* y0, const void* params, void* y_out, void* status,
    void* nstep, void* nfev, int B, float t0, float tf, float rtol,
    float atol, float h0, int use_hstart, float max_step, int max_steps,
    int lanes, int block_members, const void* tq, const void* idx,
    void* y_eval, int nq, void* stream) {
  if (!tab::SNAP || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  const Snap snap{static_cast<const float*>(tq), static_cast<const int*>(idx),
                  static_cast<float*>(y_eval), nq, B};
  return launch_lanes(y0, params, y_out, status, nstep, nfev, B, L, lanes,
                      block_members, snap, stream);
}
