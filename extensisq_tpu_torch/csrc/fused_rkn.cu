// Fused adaptive Runge-Kutta-Nystrom ensemble solver for Hopper (sm_90a).
//
// Replaces extensisq_tpu/ops/fused_rkn.py:solve_fused_rkn, the Pallas kernel
// that runs a whole adaptive integration of a second-order ensemble
// (_run_rkn_loop) per launch, with the in-kernel Watts start on the
// first-order form [v, acc].  Its plain PyTorch version is
// extensisq_tpu_torch/ops/fused_rkn.py:fused_rkn_reference; the two take the
// same steps up to round-off.
//
// Design: one member per thread or per group of G = 2, 4 or 8 lanes of one
// warp, as fused_erk.cu.  A member holds u, v, their lo parts, the carried
// acceleration f and the stage accelerations K[S+1][M] in registers and
// runs its own adaptive loop (stages with h^2 A and h Ap weights, the
// combined [u, v] error norm, the controller, the end landing) until its
// status leaves RUNNING; it reads device memory once at the start and lane
// 0 writes once at the end.  The lanes of a group split the norm's 2M
// divisions and finiteness tests and the controller's powers (Fi5N leaves
// three: the error's to -0.2 and -0.14, the last error's to 0.08), with
// the one-thread bits at every G (rk_lanes.cuh).
//
// What bounds it on the H100: as B1, each member is a long chain of
// dependent f32 operations and the launch lasts as long as the slowest
// member's.  At kepler2048 its attempt (section clocks,
// tools/probe_fused_small.py) is half the acceleration (a powf in each of
// the 7 stages and the FSAL row), which no lane can split, and 38% the
// norm's four divisions and the controller's three powf, issued one after
// another by one thread.  4 or 8 lanes a member (ops/fused_rkn.py:
// _lanes_per_member) cut that share and the launch by 10-13% plain, 7-11%
// compensated, up to one warp per SM sub-partition; 262,144 members run
// one thread each.  Registers grow with M (Fi5N keeps 7 stage rows of M
// accelerations); the build prints -Xptxas -v, and chip_smoke.py reports
// it for M = 2 and M = 14.
//
// Per-member parameters (params, ops/fused_rkn.py): with tab::NPAR = K > 0
// a member loads its K parameters into registers once, before its loop,
// and the acceleration takes them as a fifth argument (MemberAcc below, the
// form of member_rhs.cuh); with K = 0 the params pointer is never read.
//
// Dense output (dense=R): a build whose header sets tab::REC writes each
// accepted step's end (t, [u, v], [v, a]) to its member's rows in device
// memory, rank 0 of a group as it writes the results (dense_record.cuh,
// rows of 2M); f0 = [v0, a(t0)] once at the start.  The writes sit beside
// the arithmetic, which they leave as it is; without tab::REC the record
// parameter is never read and the kernels are those of the build before
// dense output.
//
// t_eval snapshots (ops/fused_rkn.py): a build whose header sets tab::SNAP
// writes each point's row (snapshot.cuh) as the member's accepted step
// crosses it: the cubic Hermite of the step's end pairs ([u, v], [v, a])
// and ([u_new, v_new], [v_new, a_new]), which is JAX's partitioned form
// (the u rows with derivative v, the v rows with the carried
// acceleration), read before u, v and a are overwritten (their high words
// in the compensated mode); the new acceleration goes into a temporary
// first, so that the v rows still see the old one.  A step's crossed
// points are split over the group's lanes (snapshot.cuh: snap_step);
// points at or before t0 take y0, the points left at the end the final
// [u, v] (rank 0 writing those).  The four outputs are those of the build
// without it (its Watts start out of line, hstart.cuh: inlined beside the
// rows' code it parted in the compensated body), and a build with both
// switches serves t_eval with dense=R.
//
// The tableau (float32, rounded as the JAX kernel rounds it; E and Ep as the
// tableau has them, without the stepper's Mu5Nmb damping) and the user's
// acceleration come from the generated header fused_rkn_config.cuh:
//   namespace tab { M, NPAR, REC, SNAP, S, FSAL, MORDER, A(i, j), AP(i, j),
//                   B(j), BP(j), C(i), E(j), EP(j), controller and start
//                   constants }
//   template <class T> __device__ void acc(T t, const T* u, const T* v,
//                                          T* a);
// (with NPAR = K > 0: acc(T t, const T* u, const T* v, T* a, const T* p),
// p the member's K parameters).
// Weights are compile-time constants, so zero weights drop out of the
// unrolled sums (rk_common.cuh); the step control is rk_control.cuh's.
//
// Numerics, as in fused_erk.cu: the compensated helpers round every
// operation on its own (__f*_rn), the rest may contract to fma; no fast
// math; a non-finite error norm, u_new, v_new or FSAL acceleration ends the
// member with status 3; max_steps counts attempts.

#include <cuda_runtime.h>
#include <math.h>

#include "dense_record.cuh"
#include "fused_rkn_config.cuh"
#include "rk_common.cuh"
#include "snapshot.cuh"

namespace {

using tab::M;
using tab::S;
constexpr int N = 2 * M;                    // the first-order state [u, v]
constexpr int MM = S + (tab::FSAL ? 1 : 0);  // rows of the error estimate

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;

// The user's acceleration bound to one member's K parameters, loaded into
// registers once.
template <int K>
struct MemberAcc {
  float p[K > 0 ? K : 1];

  __device__ explicit MemberAcc(const float* __restrict__ par) {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = par[j];
  }

  template <class T>
  __device__ __forceinline__ void operator()(T t, const T* u, const T* v,
                                             T* a) const {
    if constexpr (K == 0) {
      acc(t, u, v, a);
    } else {
      acc(t, u, v, a, static_cast<const T*>(p));
    }
  }
};
using Acc = MemberAcc<tab::NPAR>;

// The first-order form [v, acc(t, u, v)], the starting step's RHS.
struct FirstOrder {
  const Acc& fn;
  __device__ __forceinline__ void operator()(float t, const float* y,
                                             float* dy) const {
#pragma unroll
    for (int k = 0; k < M; ++k) dy[k] = y[M + k];
    fn(t, y, y + M, dy + M);
  }
};

}  // namespace

#include "hstart.cuh"
#include "rk_control.cuh"
#include "rk_lanes.cuh"
#include "rk_rows.cuh"

namespace {

using rk::Launch;
using rk::OneLane;
using rk::Out;
using rk::Rec;
using rk::Snap;
using rk::RowA;
using rk::RowAp;
using rk::RowB;
using rk::RowBp;
using rk::RowE;
using rk::RowEp;
using Stages = float[S + 1][M];

// Stages I..S-1 of one attempt; K[0] holds acc(t, u, v).
template <bool COMP, int I>
__device__ __forceinline__ void stages(const Acc& fn, float t, float h,
                                       float hh,
                                       const float (&u)[M],
                                       const float (&u_lo)[M],
                                       const float (&v)[M],
                                       const float (&v_lo)[M], Stages& K,
                                       rk::Clock& clk) {
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
    clk.mark(rk::kStageSums);
    fn(t + ch, au, av, K[I]);
    clk.mark(rk::kRhs);
    stages<COMP, I + 1>(fn, t, h, hh, u, u_lo, v, v_lo, K, clk);
  }
}

// The whole integration of one member by the group grp of G lanes (rank(),
// shfl(v, src); OneLane at G = 1) from its initial state y0 = [u, v] with
// its parameters par (tab::NPAR floats; unread when there are none); lane
// 0 writes the results, with tab::REC the member's record rec and with
// tab::SNAP its t_eval rows snap.  At G = 1 the norm and the controller run
// as one thread runs them; at G > 1 their divisions and powers are split
// over the lanes (rk_lanes.cuh), with the same bits.
template <int G, bool COMP, class Group>
__device__ __forceinline__ void integrate(Group& grp,
                                          const float* __restrict__ y0,
                                          const float* __restrict__ par,
                                          const Launch& L, int member,
                                          const Out& out,
                                          const Rec& rec = Rec{},
                                          const Snap& snap = Snap{}) {
  const Acc fn(par);
  const float tf = L.tf;
  const float rtol = L.rtol;
  const float atol = L.atol;
  const float max_step = L.max_step;
  float u[M], v[M], u_lo[M], v_lo[M], f[M];
  Stages K;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    u[k] = y0[k];
    v[k] = y0[M + k];
    u_lo[k] = 0.0f;
    v_lo[k] = 0.0f;
  }
  const float span = tf - L.t0;
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  float t = L.t0;
  float t_lo = 0.0f;
  fn(t, u, v, f);
  if constexpr (tab::REC) {
    if (grp.rank() == 0) {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        rec.f0[static_cast<size_t>(member) * N + k] = v[k];
        rec.f0[static_cast<size_t>(member) * N + M + k] = f[k];
      }
    }
  }
  rk::StepControl ctl{L.h0};
  int nfev = 1;
  if (L.use_hstart) {
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
    if constexpr (tab::SNAP) {
      ctl.h_abs = fabsf(rk::hstart_out_of_line<N, tab::MORDER>(
          t, bq, y, yp, rtol, atol, FirstOrder{fn}));
    } else {
      ctl.h_abs = fabsf(rk::hstart<N, tab::MORDER>(t, bq, y, yp, rtol, atol,
                                                   FirstOrder{fn}));
    }
    nfev = 2 + (N + 1 < 3 ? N + 1 : 3);
  }
  // the next sorted t_eval point (tab::SNAP): those at or before t0 take y0
  rk::Cursor cur;
  if constexpr (tab::SNAP) {
    cur = rk::cursor_at(snap, snap.past(0, dir, t));
    if (grp.rank() == 0) {
      float y[N];
#pragma unroll
      for (int k = 0; k < M; ++k) {
        y[k] = u[k];
        y[M + k] = v[k];
      }
      rk::snap_fill(snap, 0, cur.q, member, y);
    }
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
    const float hh = h * h;

    // stages, solution and error estimate
#pragma unroll
    for (int k = 0; k < M; ++k) K[0][k] = f[k];
    clk.mark(rk::kLoop);
    stages<COMP, 1>(fn, t, h, hh, u, u_lo, v, v_lo, K, clk);
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
    clk.mark(rk::kSolution);
    if constexpr (tab::FSAL) fn(t + h, u_new, v_new, K[S]);
    clk.mark(rk::kRhs);
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
    clk.mark(rk::kSolution);
    // the RMS of [err_u, err_v] over the 2M states
    float err_norm;
    bool bad;
    if constexpr (G == 1) {
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
      err_norm = sqrtf(sq / static_cast<float>(N));
      // overflow: NaN/Inf anywhere ends this member with status 3
      bad = !(finite && isfinite(err_norm));
    } else {
      // the same over [u, v] as one vector; a non-finite u_new, v_new or
      // FSAL stage makes the norm non-finite
      float e[N], a[N], b[N], c[N];
#pragma unroll
      for (int k = 0; k < M; ++k) {
        e[k] = err_u[k];
        e[M + k] = err_v[k];
        a[k] = u[k];
        a[M + k] = v[k];
        b[k] = u_new[k];
        b[M + k] = v_new[k];
        c[k] = tab::FSAL ? K[S][k] : u_new[k];
        c[M + k] = v_new[k];
      }
      err_norm = rk::lane_norm<G>(grp, e, a, b, c, rtol, atol);
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
        // the points this step crosses, from its end pairs [u, v], [v, a]
        float f_new[M];
        if constexpr (tab::FSAL) {
#pragma unroll
          for (int k = 0; k < M; ++k) f_new[k] = K[S][k];
        } else {
          fn(t_new, u_new, v_new, f_new);
          nfev += 1;
        }
        float y[N], yp[N], y1[N], yp1[N];
#pragma unroll
        for (int k = 0; k < M; ++k) {
          y[k] = u[k];
          y[M + k] = v[k];
          yp[k] = v[k];
          yp[M + k] = f[k];
          y1[k] = u_new[k];
          y1[M + k] = v_new[k];
          yp1[k] = v_new[k];
          yp1[M + k] = f_new[k];
        }
        cur = rk::snap_step<N, G>(snap, cur, member, grp.rank(), dir, t,
                                  t_new, h, y, yp, y1, yp1);
#pragma unroll
        for (int k = 0; k < M; ++k) f[k] = f_new[k];
      } else if constexpr (tab::FSAL) {
#pragma unroll
        for (int k = 0; k < M; ++k) f[k] = K[S][k];
      } else {
        // a non-FSAL pair evaluates the endpoint of accepted steps only
        fn(t_new, u_new, v_new, f);
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
      // the step's end at row nstep, while the attempts are below rows
      if constexpr (tab::REC) {
        if (it < rec.rows) {
          if (grp.rank() == 0) {
            const size_t row = rec.row(member, nstep);
            rec.t[row] = t;
#pragma unroll
            for (int k = 0; k < M; ++k) {
              rec.y[row * N + k] = u[k];
              rec.y[row * N + M + k] = v[k];
              rec.f[row * N + k] = v[k];
              rec.f[row * N + M + k] = f[k];
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
  for (int k = 0; k < M; ++k) {
    out.y[static_cast<size_t>(member) * N + k] = u[k];
    out.y[static_cast<size_t>(member) * N + M + k] = v[k];
  }
  out.status[member] = status;
  out.nstep[member] = nstep;
  out.nfev[member] = nfev;
  if constexpr (tab::REC) rec.n[member] = nrec;
  // the points the member never reached take its final [u, v]
  if constexpr (tab::SNAP) {
    float y[N];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      y[k] = u[k];
      y[M + k] = v[k];
    }
    rk::snap_fill(snap, cur.q, snap.nq, member, y);
  }
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
__global__ void fused_rkn_kernel(const float* __restrict__ y0,
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
    fused_rkn_kernel<G, true><<<blocks, threads, 0, s>>>(
        y0, par, out, B, block_members, L, rec, snap);
  } else {
    fused_rkn_kernel<G, false><<<blocks, threads, 0, s>>>(
        y0, par, out, B, block_members, L, rec, snap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef FUSED_SMALL_SECTIONS
// The probe build's section clocks: rk::kSectionSlots unsigned counters per
// member are written to `sections` by the launches that follow.
extern "C" int fused_rkn_sections(void* sections) {
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
// fused_rkn_record_launch and fused_rkn_snap_launch).
extern "C" int fused_rkn_launch(const void* y0, const void* params,
                                void* y_out, void* status, void* nstep,
                                void* nfev, int B, float t0, float tf,
                                float rtol, float atol, float h0,
                                int use_hstart, float max_step, int max_steps,
                                int compensated, int lanes, int block_members,
                                void* stream) {
  if (tab::REC || tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  return launch_lanes(y0, params, y_out, status, nstep, nfev, B, L,
                      compensated, lanes, block_members, Rec{}, Snap{},
                      stream);
}

// The launch of a build with dense output (tab::REC): as fused_rkn_launch,
// and each member writes its record (dense_record.cuh) to rec_t (B, rows),
// rec_y and rec_f (B, rows, 2M), rec_f0 (B, 2M) and rec_n (B,) int32.
// cudaErrorInvalidValue for a build without it, one with snapshots or rows
// < 1.
extern "C" int fused_rkn_record_launch(
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
// fused_rkn_record_launch, the record's arguments null with rows 0 for a
// build without it, and each member writes the rows (snapshot.cuh) of the
// nq points tq (float32, sorted in the direction of integration) at their
// indices idx (int32) in t_eval to y_eval (nq, B, 2M).
// cudaErrorInvalidValue for a build without tab::SNAP, nq < 1, or rows
// that disagree with tab::REC.
extern "C" int fused_rkn_snap_launch(
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
