// Fused SWAG ensemble solver for Hopper (sm_90a): the whole variable-order
// Adams-Bashforth-Moulton PECE integration of each member in one launch.
//
// Replaces extensisq_tpu/ops/fused_adams.py:solve_fused_adams, the Pallas
// kernel (its body `kernel`/`body`, with _adams_common.make_coefficients).
// Its plain PyTorch version is extensisq_tpu_torch/ops/fused_adams.py:
// fused_adams_reference; the two take the same steps up to round-off.
//
// Design: a group of G lanes of one warp per member, G = 8, 16 or 32
// (lane_group.cuh), or one thread per member (G = 1).  Lane r of a group
// owns the phi rows r, r + G, ... (all N components) and the elements r,
// r + G, ... of the coefficient vectors psi/alpha/beta/v/w and sig/g
// (adams_common.cuh: LaneCoef, coefficients_lanes).  Every lane computes
// the member's scalars (t, h, the order k, the counts ns and ifail, the
// status) and its N-vectors (y, the prediction, f, the error weights) from
// identical inputs, so the group takes every branch together: a member's
// control flow is its own, and a warp of one member never runs another
// member's branches.  An element at a run-time index (row k, g[k],
// sig[k-1], ...) comes from its lane by one shuffle; the element-wise steps
// (the beta scaling, the phi update and restore, the v update, each step of
// the g loop) run across the lanes.  Sums and products keep the plain
// version's order: the predictor's rows are broadcast in row order and
// every lane runs the chain, so the first attempts stay bit-identical to
// the plain version on the host.  The sums over rows stop at the member's
// own order k (the rows are broadcast up to KM, every shuffle issued
// before the sums, so that their latencies overlap).
//
// One lane keeps the thread-per-member body of the first port
// (integrate_thread): the member's whole state in registers, every
// run-time index a select walk over the static bound KM (adams_common.cuh:
// Coef, coefficients).  The group body run at one lane was up to 7% faster
// at n = 2 but 1.6-1.9x slower at n = 8 and 32,768 members, where it
// spilled twice as much at 255 registers (PERF.md, PR 9).
//
// Launch shape: block_members members per block, block_members x G <= 1024
// threads; the member of thread x of block b is b block_members + x / G.
// The wrapper (ops/fused_adams.py:_lanes_per_member) takes the largest G
// of 32, 16 and 8 that keeps about 256 threads per SM (8 up to twice that
// at k_max >= 8), else 1: the 256-member bench line runs on 256 warps
// (G = 32) over the SMs instead of 8 lockstep warps on 2 SMs, and 32,768
// members one thread each.
//
// Per-member parameters (params, ops/fused_adams.py): with tab::NPAR = K >
// 0 a member loads its K parameters into registers once, before its loop,
// and the right-hand side takes them as a fourth argument
// (member_rhs.cuh); with K = 0 the params pointer is never read.
//
// Dense output (dense=R): a build whose header sets tab::REC writes the end
// (t, y, f) of each accepted step, and of the near-end extrapolation, to
// its member's rows in device memory, rank 0 of a group as it writes the
// results (dense_record.cuh).  As in the JAX kernel, the extrapolation is
// a node at tf with the extrapolated y and the f of the step before it;
// y is the high word in compensated mode; f0 is the starting state's
// f(t0, y0) from the float32 stepper's init.  The writes sit beside the
// arithmetic, which they leave as it is; without tab::REC the bodies are
// called with no record and the kernels are those of the build before
// dense output (the record build launches a kernel of its own,
// fused_adams_record_kernel).
//
// t_eval snapshots (ops/fused_adams.py): a build whose header sets
// tab::SNAP writes each point's row (snapshot.cuh) as the member crosses
// it, as the JAX kernel does (fused_adams.py:655-681): at an accepted step
// the cubic Hermite of the step's end pairs (y, y') and (y_c, f(y_c)), and
// at the near-end extrapolation JAX's straight line y + (tq - t) y' for
// the points up to tf; t and y are the high words in compensated mode, and
// both are read before they are overwritten.  The member's cursor into
// the sorted points sits in registers, and a step's crossed points are
// split over the group's lanes (snapshot.cuh: snap_step, snap_line);
// points at or before t0 take y0, the points left at the end the final y,
// rank 0 writing those.  The four outputs are those of the build without
// it; the snapshot build launches a kernel of its own
// (fused_adams_snap_kernel, with the record where the build has both).
//
// Work counters: lane 0 writes five per member (Out::work): the attempts,
// and over the attempts the sums of the order k (the predictor's rows),
// of k where the step was accepted (the phi update's rows), of the
// coefficient elements updated (k - ns, psi to sig and the beta scaling)
// and of the element steps of the v update and the g loop.  They count
// the work at the orders the member took, for the kernel's bound; the
// plain version counts the same.
//
// What bounds it on the H100: each attempt is a chain of dependent f32
// operations (the coefficient recurrences, the predictor sum, two RHS
// evaluations, the error norms, the controller's powf) and no memory
// traffic: latency, not the card's flop or byte rate.  At G = 1 a warp
// runs until its slowest member ends and executes the union of its
// members' branches; registers are the scarce resource (the carry is about
// (KM + 2) N + 7 KM + 20 floats, ~150 at KM = 12 and N = 2).  At G = 32 a
// shuffle replaces each select walk, a lane's state is one phi row and
// one element of each vector, and what is left is one warp's instruction
// stream per member, mostly integer index and predicate work: 2.2 us per
// attempt on the bench line on an H100 (700 W).
//
// The order, the state size, the Adams constants and the user's right-hand
// side come from the generated header fused_adams_config.cuh:
//   namespace tab { KM, N, NPAR, REC, SNAP, INV_N, FOURU_T, LAND_TOL,
//                   GSTR(i), IQQ(i), TWO(i) }
//   __device__ void rhs(float t, const float* y, float* dy);  (or the
//   template rhs<T>, instantiated here as rhs<float>; with NPAR = K > 0
//   rhs(float t, const float* y, float* dy, const float* p), p the
//   member's K parameters)
//
// Numerics (by line of the Pallas body, extensisq_tpu/ops/fused_adams.py):
//  * time in double-single in both modes (:410, :622), the 4 2^-30 |t|
//    minimum step (:181, :411), the remainder in double-single (:413) and
//    the landing test |rem| <= 8 eps32 |h| on it (:629-633);
//  * compensated mode: Neumaier sum of g phi in the predictor (:456-468)
//    and the whole step increment in the (hi, lo) carry of y (:554-566),
//    with rk_common.cuh's uncontracted two_sum/df_add; phi stays float32;
//  * powf where the JAX kernel takes exp(log x / (k + 1)) (:614-616), real
//    selects where it blends, isfinite where it scrubs bits;
//  * FMA contraction stays on elsewhere, as in the other fused kernels;
//  * the predictor's sum stops at row k - 1, where the JAX kernel adds
//    zero weights up to KM (the same bits while the rows are finite);
//  * a non-finite error estimate rejects the attempt (:518-525); a member
//    whose starting state or step is not finite, or whose accepted step
//    gives a non-finite y or f, ends with status 3 (the JAX kernel scrubs
//    those values to 1 and runs on);
//  * max_steps counts the member's loop iterations, accepted plus rejected
//    (the JAX hit_cap, :652), giving status 3.

#include <cuda_runtime.h>
#include <math.h>

#include "dense_record.cuh"
#include "fused_adams_config.cuh"
#include "adams_common.cuh"
#include "member_rhs.cuh"
#include "rk_common.cuh"
#include "snapshot.cuh"

namespace {

using tab::KM;
using tab::N;
using adams::clip;
using adams::slots;
using rk::Rec;
using rk::Snap;
using Rhs = MemberRhs<tab::NPAR>;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;
constexpr int R = KM + 2;     // rows of phi
constexpr int NGSTR = 13;     // entries of tab::GSTR

struct Launch {  // the launch's scalars, the same for every member
  float t0, tf, dir, rtol, atol, max_step;
  int max_steps;
};

struct Out {
  float* y;
  int* status;
  int* nsteps;
  int* nfev;
  int* work;  // kWork counters per member
};

constexpr int kWork = 5;

// A float32 constant table entry tab::X(i) for a run-time i in [0, LEN).
template <int LEN, class Table>
__device__ __forceinline__ float ctake(Table table, int i) {
  float v = table(0);
#pragma unroll
  for (int r = 1; r < LEN; ++r) v = (i == r) ? table(r) : v;
  return v;
}

// The tables as function objects, so that ctake's calls fold to literals.
struct Gstr {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::GSTR(i);
  }
};
struct Iqq {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::IQQ(i);
  }
};
struct Two {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::TWO(i);
  }
};

// RMS over the state in the JAX kernel's order: squares summed in row
// order, times 1/N.
__device__ __forceinline__ float member_norm(const float (&x)[N]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) acc = acc + x[j] * x[j];
  return sqrtf(acc * tab::INV_N);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

template <int LEN>
__device__ __forceinline__ bool all_finite(const float (&x)[LEN]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < LEN; ++j) ok = ok && isfinite(x[j]);
  return ok;
}

// A member's work counters (the note above), in Out::work's order.
struct Work {
  int att = 0, rows = 0, rows_acc = 0, coef = 0, steps = 0;
  // one attempt at order k with ns steps at this h
  __device__ __forceinline__ void attempt(int k, int ns) {
    const int a = max(k - ns, 0);
    att += 1;
    rows += k;
    coef += a;
    if (k >= ns) steps += (ns > 1 ? a + 1 : 0) + a * (a + 1) / 2;
  }
};

// A member's results and work counters.
__device__ __forceinline__ void write_member(const Out& out, int member,
                                             const float (&y)[N], int status,
                                             int nsteps, int nfev,
                                             const Work& w) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    out.y[static_cast<size_t>(member) * N + j] = y[j];
  }
  out.status[member] = status;
  out.nsteps[member] = nsteps;
  out.nfev[member] = nfev;
  int* o = out.work + static_cast<size_t>(member) * kWork;
  o[0] = w.att;
  o[1] = w.rows;
  o[2] = w.rows_acc;
  o[3] = w.coef;
  o[4] = w.steps;
}

// The record of a body called with one (a build with tab::REC, or with
// tab::SNAP: the record and the snapshots); a build without either calls
// the bodies with none, so that its kernels take, construct and pass
// nothing for them.
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

// Row `step` of the member's record: the step's end t, y and f.
__device__ __forceinline__ void record_row(const Rec& rec, int member,
                                           int step, float t,
                                           const float (&y)[N],
                                           const float (&yp)[N]) {
  const size_t row = rec.row(member, step);
  rec.t[row] = t;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    rec.y[row * N + j] = y[j];
    rec.f[row * N + j] = yp[j];
  }
}

// The member's f0 (its starting f) to the record.
__device__ __forceinline__ void record_f0(const Rec& rec, int member,
                                          const float (&yp)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    rec.f0[static_cast<size_t>(member) * N + j] = yp[j];
  }
}

// ---- one lane: a thread per member ----

// phi[i][j] for a run-time row i.
__device__ __forceinline__ float row_take(const float (&phi)[R][N], int i,
                                          int j) {
  float v = phi[0][j];
#pragma unroll
  for (int r = 1; r < R; ++r) v = (i == r) ? phi[r][j] : v;
  return v;
}

__device__ __forceinline__ void row_put(float (&phi)[R][N], int i, int j,
                                        float val) {
#pragma unroll
  for (int r = 0; r < R; ++r) phi[r][j] = (i == r) ? val : phi[r][j];
}

// The whole integration of one member by one thread, its multistep state in
// registers: the order k and the count ns are run-time indices, and every
// take/put at one walks the static bound with a select (adams_common.cuh).
// Arguments as for integrate below.
template <bool COMP, class... Record>
__device__ void integrate_thread(const float* __restrict__ y0,
                                 const float* __restrict__ yp0,
                                 const float* __restrict__ par, float h0,
                                 int nfev0, const Launch& L, int member,
                                 const Out& out, const Record&... record) {
  const Rhs fn(par);
  // the starting state (steppers/adams.py:init)
  float y[N], y_lo[N], yp[N];
  float phi[R][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    y[j] = y0[j];
    yp[j] = yp0[j];
    y_lo[j] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < N; ++j) phi[r][j] = r == 0 ? yp[j] : 0.0f;
  }
  adams::Coef<KM> c;
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    c.psi[r] = c.alpha[r] = c.beta[r] = c.v[r] = c.w[r] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r <= KM; ++r) {
    c.sig[r] = r == 0 ? 1.0f : 0.0f;
    c.g[r] = r == 0 ? 1.0f : (r == 1 ? 0.5f : 0.0f);
  }
#pragma unroll
  for (int r = 0; r < adams::Coef<KM>::NGI; ++r) c.gi[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < adams::Coef<KM>::NIV; ++r) c.iv[r] = 0;
  c.ivc = 0;
  c.kgi = 0;

  float t = L.t0;
  float t_lo = 0.0f;
  float h = h0;
  float hold = 0.0f;
  int k = 1;
  int kold = 0;
  int kprev = 0;
  int ns = 0;
  int ifail = 0;
  bool phase1 = true;
  bool fresh = true;
  int nsteps = 0;
  int nfev = nfev0;
  int status = (all_finite(y) && all_finite(yp) && isfinite(h)) ? kRunning
                                                                  : kOverflow;
  int it = 0;
  int nrec = 0;  // rows of the record written (tab::REC)
  Work work;
  if constexpr (tab::REC) {
    record_f0(the_record(record...), member, yp);
  }
  // the next sorted t_eval point (tab::SNAP): those at or before t0 take y0
  rk::Cursor cur;
  if constexpr (tab::SNAP) {
    const Snap& snap = the_snap(record...);
    cur = rk::cursor_at(snap, snap.past(0, L.dir, t));
    rk::snap_fill(snap, 0, cur.q, member, y);
  }

  while (status == kRunning && it < L.max_steps) {
    const float tc = t + t_lo;  // double-single time carry
    const float min_step = tab::FOURU_T * fabsf(tc);
    const float d = (L.tf - t) - t_lo;  // remaining interval in DS
    it += 1;
    if (fabsf(d) <= min_step) {
      // near-end linear extrapolation (shampine.py:209-217); counts as a
      // step, evaluates nothing; the points up to tf take its straight line
      if constexpr (tab::SNAP) {
        cur = rk::snap_line<N, 1>(the_snap(record...), cur, member, 0, L.dir,
                                  t, L.tf, y, yp);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (COMP) {
          rk::df_add(y[j], y_lo[j], d * yp[j], y[j], y_lo[j]);
        } else {
          y[j] = y[j] + d * yp[j];
        }
      }
      t = L.tf;
      t_lo = 0.0f;
      // a node at tf with the f of the step before, while the attempts
      // before this one are below the record's rows
      if constexpr (tab::REC) {
        if (it <= the_record(record...).rows) {
          record_row(the_record(record...), member, nsteps, t, y, yp);
          nrec += 1;
        }
      }
      nsteps += 1;
      status = kFinished;
      break;
    }

    // fresh steps: clamp h toward tf and max_step
    float h_in = h;
    if (fresh) {
      float hc = L.dir * (h - d) > 0.0f ? d : h;
      h_in = sgn(hc) * fminf(fabsf(hc), L.max_step);
      ifail = 0;
    }
    int ns2 = h_in != hold ? 0 : ns;
    if (ns2 <= kold) ns2 += 1;
    adams::coefficients<KM>(c, h_in, k, ns2, kprev, kold);
    work.attempt(k, ns2);
    const int km1 = k - 1;
    const int km2 = k - 2;

    // block 2: predict; phi[r] *= beta[r] for r in [ns, k)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= ns2 && r < k) {
        const float b = c.beta[r < KM ? r : KM - 1];
#pragma unroll
        for (int j = 0; j < N; ++j) phi[r][j] = phi[r][j] * b;
      }
    }
    float p[N], pred_s[N], pred_c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      row_put(phi, k + 1, j, row_take(phi, k, j));
      row_put(phi, k, j, 0.0f);
      float acc = 0.0f;
      if constexpr (COMP) {
        float comp = 0.0f;
#pragma unroll
        for (int r = 0; r <= KM; ++r) {
          const float gw = r < k ? c.g[r] : 0.0f;
          float e;
          rk::two_sum(acc, __fmul_rn(gw, phi[r][j]), acc, e);
          comp = __fadd_rn(comp, e);
        }
        pred_s[j] = h_in * acc;
        pred_c[j] = h_in * comp;
        p[j] = y[j] + (pred_s[j] + (pred_c[j] + y_lo[j]));
      } else {
#pragma unroll
        for (int r = 0; r <= KM; ++r) {
          const float gw = r < k ? c.g[r] : 0.0f;
          acc = acc + gw * phi[r][j];
        }
        p[j] = h_in * acc + y[j];
      }
      // reverse cumulative sum over rows < k
      float run = 0.0f;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        if (r < k) {
          run = run + phi[r][j];
          phi[r][j] = run;
        }
      }
    }

    const float x = tc + h_in;
    float yp_pred[N];
    fn(x, p, yp_pred);
    nfev += 1;

    float wtn[N], temp4[N], e0[N], e1[N], e2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      wtn[j] = L.atol + L.rtol * 0.5f * (fabsf(p[j]) + fabsf(y[j]));
      const float inv_wt = 1.0f / wtn[j];
      temp4[j] = yp_pred[j] - phi[0][j];
      e0[j] = temp4[j] * inv_wt;
      e1[j] = (row_take(phi, clip(km1, 0, R - 1), j) + temp4[j]) * inv_wt;
      e2[j] = (row_take(phi, clip(km2, 0, R - 1), j) + temp4[j]) * inv_wt;
    }
    const float absh = fabsf(h_in);
    float erk = absh * member_norm(e0);
    const float erkm1 = absh * member_norm(e1) *
                        adams::take(c.sig, clip(km1, 0, KM)) *
                        ctake<13>(Gstr{}, clip(km2, 0, 12));
    const float erkm2 = absh * member_norm(e2) *
                        adams::take(c.sig, clip(km2, 0, KM)) *
                        ctake<13>(Gstr{}, clip(km2 - 1, 0, 12));
    float err = erk * (adams::take(c.g, clip(km1, 0, KM)) -
                       adams::take(c.g, clip(k, 0, KM)));
    erk = erk * adams::take(c.sig, clip(k, 0, KM)) *
          ctake<13>(Gstr{}, clip(km1, 0, 12));
    const bool bad_e = !isfinite(err);
    if (bad_e) err = 11.0f;
    // max(erkm1, erkm2) < erk, false where either is NaN (torch.maximum)
    const int knew = (k > 2 && erkm1 < erk && erkm2 < erk)
                         ? km1
                         : ((k == 2 && erkm1 < 0.5f * erk) ? km1 : k);
    const bool success = err <= 1.0f && !bad_e;

    if (success) {
      // block 4: correct and evaluate
      const float g_k = adams::take(c.g, clip(k, 0, KM));
      float yc[N], yc_lo[N], ypn[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (COMP) {
          // the whole step increment in double-single
          float s1, e, hi, lo1;
          rk::two_sum(pred_s[j], h_in * g_k * temp4[j], s1, e);
          const float lo = e + pred_c[j];
          rk::df_add(y[j], y_lo[j], s1, hi, lo1);
          rk::two_sum(hi, lo1 + lo, yc[j], yc_lo[j]);
        } else {
          yc[j] = h_in * g_k * temp4[j] + p[j];
          yc_lo[j] = y_lo[j];
        }
      }
      fn(x, yc, ypn);
      nfev += 1;
      if (!all_finite(yc) || !all_finite(ypn)) {
        status = kOverflow;
        break;
      }

      // phi update
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float pkn = ypn[j] - phi[0][j];
        row_put(phi, k, j, pkn);
        row_put(phi, k + 1, j, pkn - row_take(phi, k + 1, j));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < k) phi[r][j] = phi[r][j] + pkn;
        }
      }
      work.rows_acc += k;

      // order selection for the next step (shampine.py:420-455)
      const bool ph1 = phase1 && !(knew == km1 || k == KM);
      float q[N];
#pragma unroll
      for (int j = 0; j < N; ++j) q[j] = row_take(phi, k + 1, j) / wtn[j];
      const float erkp1 =
          ctake<13>(Gstr{}, clip(k, 0, 12)) * absh * member_norm(q);
      const bool can_est = !ph1 && knew != km1 && k < ns2;
      const bool raise1 = k == 1 && erkp1 < 0.5f * erk && k < KM;
      const bool lower = k != 1 && erkm1 <= erk && erkm1 <= erkp1;
      const bool raise2 = k != 1 && !lower && !(erkp1 > erk || k == KM);
      int k_next = k;
      float erk_next = erk;
      if (ph1) {
        k_next = k + 1;
        erk_next = erkp1;
      } else if (knew == km1) {
        k_next = km1;
        erk_next = erkm1;
      } else if (can_est && raise1) {
        k_next = k + 1;
        erk_next = erkp1;
      } else if (can_est && lower) {
        k_next = km1;
        erk_next = erkm1;
      } else if (can_est && raise2) {
        k_next = k + 1;
        erk_next = erkp1;
      }
      const float two_next = ctake<KM + 2>(Two{}, clip(k_next, 0, KM + 1));
      const bool dbl = ph1 || 0.5f >= erk_next * two_next;
      const bool keep_h = 0.5f >= erk_next;
      const float rr =
          powf(fmaxf(0.5f / fmaxf(erk_next, 1e-30f), 1e-30f),
               1.0f / static_cast<float>(k_next + 1));
      float h_red = absh * fminf(fmaxf(rr, 0.5f), 0.9f);
      h_red = sgn(h_in) * fmaxf(h_red, min_step);
      const float h_next = dbl ? h_in + h_in : (keep_h ? h_in : h_red);

      // double-single t advance; the landing test uses the remainder
      float t_adv, t_lo_adv;
      rk::df_add(t, t_lo, h_in, t_adv, t_lo_adv);
      const float rem = (L.tf - t_adv) - t_lo_adv;
      const bool is_last = fabsf(rem) <= tab::LAND_TOL * fabsf(h_in);
      // the points this step crosses, from its end pairs
      if constexpr (tab::SNAP) {
        cur = rk::snap_step<N, 1>(the_snap(record...), cur, member, 0, L.dir,
                                  t, is_last ? L.tf : t_adv, h_in, y, yp,
                                  yc, ypn);
      }
      t = is_last ? L.tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[j] = yc[j];
        y_lo[j] = yc_lo[j];
        yp[j] = ypn[j];
      }
      h = isfinite(h_next) ? h_next : 1.0f;
      hold = h_in;
      kold = k;
      kprev = k;
      k = k_next;
      ns = ns2;
      phase1 = ph1;
      fresh = true;
      ifail = 0;
      // the step's end at row nsteps of the record, while the attempts
      // before this one are below its rows
      if constexpr (tab::REC) {
        if (it <= the_record(record...).rows) {
          record_row(the_record(record...), member, nsteps, t, y, yp);
          nrec += 1;
        }
      }
      nsteps += 1;
      if (is_last) status = kFinished;
    } else {
      // block 3: failure restore (shampine.py:369-398)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < k) {
          const float b = c.beta[r < KM ? r : KM - 1];
          const float bsafe = b == 0.0f ? 1.0f : b;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float up = phi[r + 1 < R ? r + 1 : R - 1][j];
            phi[r][j] = (phi[r][j] - up) / bsafe;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < KM; ++r) {
        if (r < km1) c.psi[r] = c.psi[r + 1 < KM ? r + 1 : KM - 1] - h_in;
      }
      const int ifail2 = ifail + 1;
      const float temp2 = (ifail2 >= 4 && 0.5f < 0.25f * erk)
                              ? sqrtf(0.5f / fmaxf(erk, 1e-30f))
                              : 0.5f;
      const float h_fail = h_in * temp2;
      if (fabsf(h_fail) < min_step) status = kTooSmall;
      h = isfinite(h_fail) ? h_fail : 1.0f;
      kprev = k;
      k = ifail2 >= 3 ? 1 : knew;
      ns = 0;
      phase1 = false;
      fresh = false;
      ifail = ifail2;
    }
    if (status == kRunning && it >= L.max_steps) status = kOverflow;
  }

  write_member(out, member, y, status, nsteps, nfev, work);
  if constexpr (tab::REC) the_record(record...).n[member] = nrec;
  // the points the member never reached take its final y
  if constexpr (tab::SNAP) {
    const Snap& snap = the_snap(record...);
    rk::snap_fill(snap, cur.q, snap.nq, member, y);
  }
}

// ---- a group of G lanes per member ----

// A table spread over the group: the lane's entries s G + rank of LEN.
template <int G, int LEN, class Table, class Group>
__device__ __forceinline__ void lane_table(Group& grp, Table table,
                                           float (&out)[slots<LEN, G>()]) {
#pragma unroll
  for (int s = 0; s < slots<LEN, G>(); ++s) {
    out[s] = ctake<LEN>(table, s * G + grp.rank());
  }
}


// Component j of phi's row i (run-time, uniform), in every lane.
template <int G, int RS, class Group>
__device__ __forceinline__ float row_get(Group& grp, const float (&phi)[RS][N],
                                         int i, int j) {
  float v = phi[0][j];
#pragma unroll
  for (int s = 1; s < RS; ++s) v = (i / G == s) ? phi[s][j] : v;
  return grp.shfl(v, i % G);
}

// Component j of phi's row i = val, on the row's lane.
template <int G, int RS, class Group>
__device__ __forceinline__ void row_put(Group& grp, float (&phi)[RS][N],
                                        int i, int j, float val) {
  if (grp.rank() != i % G) return;
#pragma unroll
  for (int s = 0; s < RS; ++s) phi[s][j] = (i / G == s) ? val : phi[s][j];
}

// The whole integration of one member by the group grp of G lanes
// (rank(), shfl(v, src)).  y0, yp0 are the member's initial state and
// f(t0, y0), par its tab::NPAR parameters (unread when there are none),
// h0 and nfev0 its starting step and evaluation count from the float32
// stepper's init, as in the JAX package.  Lane 0 writes the results, with
// tab::REC the member's record (the Rec of `record`) and with tab::SNAP
// its t_eval rows (the Snap after it).
template <int G, bool COMP, class Group, class... Record>
__device__ void integrate(Group& grp, const float* __restrict__ y0,
                          const float* __restrict__ yp0,
                          const float* __restrict__ par, float h0, int nfev0,
                          const Launch& L, int member, const Out& out,
                          const Record&... record) {
  const Rhs fn(par);
  using Coef = adams::LaneCoef<KM, G>;
  constexpr int S = Coef::S;
  constexpr int S1 = Coef::S1;
  constexpr int RS = slots<R, G>();  // phi rows per lane
  const int rank = grp.rank();

  // the lane's entries of the constant tables
  float gstr[slots<NGSTR, G>()], two[slots<KM + 2, G>()], iqq[S];
  lane_table<G, NGSTR>(grp, Gstr{}, gstr);
  lane_table<G, KM + 2>(grp, Two{}, two);
  lane_table<G, KM>(grp, Iqq{}, iqq);

  // the starting state (steppers/adams.py:init)
  float y[N], y_lo[N], yp[N];
  float phi[RS][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    y[j] = y0[j];
    yp[j] = yp0[j];
    y_lo[j] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < RS; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      phi[s][j] = s == 0 && rank == 0 ? yp[j] : 0.0f;
    }
  }
  Coef c;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    c.psi[s] = c.alpha[s] = c.beta[s] = c.v[s] = c.w[s] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < S1; ++s) {
    const int e = s * G + rank;
    c.sig[s] = e == 0 ? 1.0f : 0.0f;
    c.g[s] = e == 0 ? 1.0f : (e == 1 ? 0.5f : 0.0f);
  }
#pragma unroll
  for (int r = 0; r < Coef::NIV; ++r) c.iv[r] = 0;
  c.ivc = 0;

  float t = L.t0;
  float t_lo = 0.0f;
  float h = h0;
  float hold = 0.0f;
  int k = 1;
  int kold = 0;
  int kprev = 0;
  int ns = 0;
  int ifail = 0;
  bool phase1 = true;
  bool fresh = true;
  int nsteps = 0;
  int nfev = nfev0;
  int status = (all_finite(y) && all_finite(yp) && isfinite(h)) ? kRunning
                                                                  : kOverflow;
  int it = 0;
  int nrec = 0;  // rows of the record written (tab::REC)
  Work work;
  if constexpr (tab::REC) {
    if (rank == 0) record_f0(the_record(record...), member, yp);
  }
  // the next sorted t_eval point (tab::SNAP): those at or before t0 take y0
  rk::Cursor cur;
  if constexpr (tab::SNAP) {
    const Snap& snap = the_snap(record...);
    cur = rk::cursor_at(snap, snap.past(0, L.dir, t));
    if (rank == 0) rk::snap_fill(snap, 0, cur.q, member, y);
  }

  while (status == kRunning && it < L.max_steps) {
    const float tc = t + t_lo;  // double-single time carry
    const float min_step = tab::FOURU_T * fabsf(tc);
    const float d = (L.tf - t) - t_lo;  // remaining interval in DS
    it += 1;
    if (fabsf(d) <= min_step) {
      // near-end linear extrapolation (shampine.py:209-217); counts as a
      // step, evaluates nothing; the points up to tf take its straight line
      if constexpr (tab::SNAP) {
        cur = rk::snap_line<N, G>(the_snap(record...), cur, member, rank,
                                  L.dir, t, L.tf, y, yp);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (COMP) {
          rk::df_add(y[j], y_lo[j], d * yp[j], y[j], y_lo[j]);
        } else {
          y[j] = y[j] + d * yp[j];
        }
      }
      t = L.tf;
      t_lo = 0.0f;
      // a node at tf with the f of the step before, while the attempts
      // before this one are below the record's rows
      if constexpr (tab::REC) {
        if (it <= the_record(record...).rows) {
          if (rank == 0) {
            record_row(the_record(record...), member, nsteps, t, y, yp);
          }
          nrec += 1;
        }
      }
      nsteps += 1;
      status = kFinished;
      break;
    }

    // fresh steps: clamp h toward tf and max_step
    float h_in = h;
    if (fresh) {
      float hc = L.dir * (h - d) > 0.0f ? d : h;
      h_in = sgn(hc) * fminf(fabsf(hc), L.max_step);
      ifail = 0;
    }
    int ns2 = h_in != hold ? 0 : ns;
    if (ns2 <= kold) ns2 += 1;
    adams::coefficients_lanes<KM, G>(grp, c, iqq, h_in, k, ns2, kprev, kold);
    work.attempt(k, ns2);
    const int km1 = k - 1;
    const int km2 = k - 2;

    // block 2: predict; phi[r] *= beta[r] for r in [ns, k)
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      const int e = s * G + rank;
      if (e >= ns2 && e < k) {
        const float b = c.beta[s < S ? s : S - 1];
#pragma unroll
        for (int j = 0; j < N; ++j) phi[s][j] = phi[s][j] * b;
      }
    }
    // row k moves to k + 1 and row k becomes 0; rows 0 .. KM - 1 and the
    // g weights are broadcast to every lane in row order
    float phik[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      phik[j] = row_get<G>(grp, phi, k, j);
      row_put<G>(grp, phi, k + 1, j, phik[j]);
      row_put<G>(grp, phi, k, j, 0.0f);
    }
    float gr[KM], pr[KM][N];
#pragma unroll
    for (int r = 0; r < KM; ++r) {
      gr[r] = grp.shfl(c.g[r / G], r % G);
#pragma unroll
      for (int j = 0; j < N; ++j) pr[r][j] = grp.shfl(phi[r / G][j], r % G);
    }
    float p[N], pred_s[N], pred_c[N];
    float phi0[N], phi_km1[N], phi_km2[N];  // rows 0, k-1, k-2 after the sums
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
      if constexpr (COMP) {
        float comp = 0.0f;
#pragma unroll
        for (int r = 0; r < KM; ++r) {
          if (r < k) {
            float e;
            rk::two_sum(acc, __fmul_rn(gr[r], pr[r][j]), acc, e);
            comp = __fadd_rn(comp, e);
          }
        }
        pred_s[j] = h_in * acc;
        pred_c[j] = h_in * comp;
        p[j] = y[j] + (pred_s[j] + (pred_c[j] + y_lo[j]));
      } else {
#pragma unroll
        for (int r = 0; r < KM; ++r) {
          if (r < k) acc = acc + gr[r] * pr[r][j];
        }
        p[j] = h_in * acc + y[j];
      }
      // reverse cumulative sum over rows < k; each lane keeps its rows
      float run = 0.0f;
#pragma unroll
      for (int r = KM - 1; r >= 0; --r) {
        if (r < k) {
          run = run + pr[r][j];
          if (rank == r % G) phi[r / G][j] = run;
          if (r == km1) phi_km1[j] = run;
          if (r == max(km2, 0)) phi_km2[j] = run;
        }
      }
      phi0[j] = run;
    }

    const float x = tc + h_in;
    float yp_pred[N];
    fn(x, p, yp_pred);
    nfev += 1;

    float wtn[N], temp4[N], e0[N], e1[N], e2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      wtn[j] = L.atol + L.rtol * 0.5f * (fabsf(p[j]) + fabsf(y[j]));
      const float inv_wt = 1.0f / wtn[j];
      temp4[j] = yp_pred[j] - phi0[j];
      e0[j] = temp4[j] * inv_wt;
      e1[j] = (phi_km1[j] + temp4[j]) * inv_wt;
      e2[j] = (phi_km2[j] + temp4[j]) * inv_wt;
    }
    const float sig_km1 = adams::lget<G>(grp, c.sig, clip(km1, 0, KM));
    const float sig_km2 = adams::lget<G>(grp, c.sig, clip(km2, 0, KM));
    const float sig_k = adams::lget<G>(grp, c.sig, clip(k, 0, KM));
    const float g_km1 = adams::lget<G>(grp, c.g, clip(km1, 0, KM));
    const float g_k = adams::lget<G>(grp, c.g, clip(k, 0, KM));
    const float absh = fabsf(h_in);
    float erk = absh * member_norm(e0);
    const float erkm1 =
        absh * member_norm(e1) * sig_km1 *
        adams::lget<G>(grp, gstr, clip(km2, 0, NGSTR - 1));
    const float erkm2 =
        absh * member_norm(e2) * sig_km2 *
        adams::lget<G>(grp, gstr, clip(km2 - 1, 0, NGSTR - 1));
    float err = erk * (g_km1 - g_k);
    erk = erk * sig_k *
          adams::lget<G>(grp, gstr, clip(km1, 0, NGSTR - 1));
    const bool bad_e = !isfinite(err);
    if (bad_e) err = 11.0f;
    // max(erkm1, erkm2) < erk, false where either is NaN (torch.maximum)
    const int knew = (k > 2 && erkm1 < erk && erkm2 < erk)
                         ? km1
                         : ((k == 2 && erkm1 < 0.5f * erk) ? km1 : k);
    const bool success = err <= 1.0f && !bad_e;

    if (success) {
      // block 4: correct and evaluate
      float yc[N], yc_lo[N], ypn[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (COMP) {
          // the whole step increment in double-single
          float s1, e, hi, lo1;
          rk::two_sum(pred_s[j], h_in * g_k * temp4[j], s1, e);
          const float lo = e + pred_c[j];
          rk::df_add(y[j], y_lo[j], s1, hi, lo1);
          rk::two_sum(hi, lo1 + lo, yc[j], yc_lo[j]);
        } else {
          yc[j] = h_in * g_k * temp4[j] + p[j];
          yc_lo[j] = y_lo[j];
        }
      }
      fn(x, yc, ypn);
      nfev += 1;
      if (!all_finite(yc) || !all_finite(ypn)) {
        status = kOverflow;
        break;
      }

      // phi update: row k = f - phi[0], row k + 1 = row k - old row k,
      // rows below k += row k
      float q[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float pkn = ypn[j] - phi0[j];
        const float pk1 = pkn - phik[j];
        row_put<G>(grp, phi, k, j, pkn);
        row_put<G>(grp, phi, k + 1, j, pk1);
#pragma unroll
        for (int s = 0; s < RS; ++s) {
          if (s * G + rank < k) phi[s][j] = phi[s][j] + pkn;
        }
        q[j] = pk1 / wtn[j];
      }
      work.rows_acc += k;

      // order selection for the next step (shampine.py:420-455)
      const bool ph1 = phase1 && !(knew == km1 || k == KM);
      const float erkp1 =
          adams::lget<G>(grp, gstr, clip(k, 0, NGSTR - 1)) *
          absh * member_norm(q);
      const bool can_est = !ph1 && knew != km1 && k < ns2;
      const bool raise1 = k == 1 && erkp1 < 0.5f * erk && k < KM;
      const bool lower = k != 1 && erkm1 <= erk && erkm1 <= erkp1;
      const bool raise2 = k != 1 && !lower && !(erkp1 > erk || k == KM);
      int k_next = k;
      float erk_next = erk;
      if (ph1) {
        k_next = k + 1;
        erk_next = erkp1;
      } else if (knew == km1) {
        k_next = km1;
        erk_next = erkm1;
      } else if (can_est && raise1) {
        k_next = k + 1;
        erk_next = erkp1;
      } else if (can_est && lower) {
        k_next = km1;
        erk_next = erkm1;
      } else if (can_est && raise2) {
        k_next = k + 1;
        erk_next = erkp1;
      }
      const float two_next =
          adams::lget<G>(grp, two, clip(k_next, 0, KM + 1));
      const bool dbl = ph1 || 0.5f >= erk_next * two_next;
      const bool keep_h = 0.5f >= erk_next;
      const float rr =
          powf(fmaxf(0.5f / fmaxf(erk_next, 1e-30f), 1e-30f),
               1.0f / static_cast<float>(k_next + 1));
      float h_red = absh * fminf(fmaxf(rr, 0.5f), 0.9f);
      h_red = sgn(h_in) * fmaxf(h_red, min_step);
      const float h_next = dbl ? h_in + h_in : (keep_h ? h_in : h_red);

      // double-single t advance; the landing test uses the remainder
      float t_adv, t_lo_adv;
      rk::df_add(t, t_lo, h_in, t_adv, t_lo_adv);
      const float rem = (L.tf - t_adv) - t_lo_adv;
      const bool is_last = fabsf(rem) <= tab::LAND_TOL * fabsf(h_in);
      // the points this step crosses, from its end pairs
      if constexpr (tab::SNAP) {
        cur = rk::snap_step<N, G>(the_snap(record...), cur, member, rank,
                                  L.dir, t, is_last ? L.tf : t_adv, h_in, y,
                                  yp, yc, ypn);
      }
      t = is_last ? L.tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[j] = yc[j];
        y_lo[j] = yc_lo[j];
        yp[j] = ypn[j];
      }
      h = isfinite(h_next) ? h_next : 1.0f;
      hold = h_in;
      kold = k;
      kprev = k;
      k = k_next;
      ns = ns2;
      phase1 = ph1;
      fresh = true;
      ifail = 0;
      // the step's end at row nsteps of the record, while the attempts
      // before this one are below its rows
      if constexpr (tab::REC) {
        if (it <= the_record(record...).rows) {
          if (rank == 0) {
            record_row(the_record(record...), member, nsteps, t, y, yp);
          }
          nrec += 1;
        }
      }
      nsteps += 1;
      if (is_last) status = kFinished;
    } else {
      // block 3: failure restore (shampine.py:369-398); row r + 1 comes
      // from the next lane
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float col[RS], up[RS];
#pragma unroll
        for (int s = 0; s < RS; ++s) col[s] = phi[s][j];
        adams::shift_down<G, R>(grp, col, up);
#pragma unroll
        for (int s = 0; s < RS; ++s) {
          if (s * G + rank < k) {
            const float b = c.beta[s < S ? s : S - 1];
            const float bsafe = b == 0.0f ? 1.0f : b;
            phi[s][j] = (phi[s][j] - up[s]) / bsafe;
          }
        }
      }
      float psi_up[S];
      adams::shift_down<G, KM>(grp, c.psi, psi_up);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s * G + rank < km1) c.psi[s] = psi_up[s] - h_in;
      }
      const int ifail2 = ifail + 1;
      const float temp2 = (ifail2 >= 4 && 0.5f < 0.25f * erk)
                              ? sqrtf(0.5f / fmaxf(erk, 1e-30f))
                              : 0.5f;
      const float h_fail = h_in * temp2;
      if (fabsf(h_fail) < min_step) status = kTooSmall;
      h = isfinite(h_fail) ? h_fail : 1.0f;
      kprev = k;
      k = ifail2 >= 3 ? 1 : knew;
      ns = 0;
      phase1 = false;
      fresh = false;
      ifail = ifail2;
    }
    if (status == kRunning && it >= L.max_steps) status = kOverflow;
  }

  if (rank == 0) {
    write_member(out, member, y, status, nsteps, nfev, work);
    if constexpr (tab::REC) the_record(record...).n[member] = nrec;
    // the points the member never reached take its final y
    if constexpr (tab::SNAP) {
      const Snap& snap = the_snap(record...);
      rk::snap_fill(snap, cur.q, snap.nq, member, y);
    }
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "lane_group.cuh"

namespace {

// The member of this thread's group from the kernel's arguments, with the
// record and the snapshots where a build has them.
template <int G, bool COMP, class... Record>
__device__ __forceinline__ void member_body(const float* __restrict__ y0,
                                            const float* __restrict__ par,
                                            const float* __restrict__ yp0,
                                            const float* __restrict__ h0,
                                            const int* __restrict__ nfev0,
                                            const Out& out, int B,
                                            int block_members,
                                            const Launch& L,
                                            const Record&... record) {
  const int member =
      blockIdx.x * block_members + static_cast<int>(threadIdx.x) / G;
  if (member >= B) return;  // ragged last block: no member padding
  const float* y0m = y0 + static_cast<size_t>(member) * N;
  const float* yp0m = yp0 + static_cast<size_t>(member) * N;
  const float* parm = par + static_cast<size_t>(member) * tab::NPAR;
  if constexpr (G == 1) {
    integrate_thread<COMP>(y0m, yp0m, parm, h0[member], nfev0[member], L,
                           member, out, record...);
  } else {
    LaneGroup<G> grp;
    integrate<G, COMP>(grp, y0m, yp0m, parm, h0[member], nfev0[member], L,
                       member, out, record...);
  }
}

template <int G, bool COMP>
__global__ void fused_adams_kernel(const float* __restrict__ y0,
                                   const float* __restrict__ par,
                                   const float* __restrict__ yp0,
                                   const float* __restrict__ h0,
                                   const int* __restrict__ nfev0, Out out,
                                   int B, int block_members, Launch L) {
  member_body<G, COMP>(y0, par, yp0, h0, nfev0, out, B, block_members, L);
}

// The kernel of a build with the dense record (tab::REC), which takes the
// record; a build without it instantiates only fused_adams_kernel.
template <int G, bool COMP>
__global__ void fused_adams_record_kernel(const float* __restrict__ y0,
                                          const float* __restrict__ par,
                                          const float* __restrict__ yp0,
                                          const float* __restrict__ h0,
                                          const int* __restrict__ nfev0,
                                          Out out, int B, int block_members,
                                          Launch L, Rec rec) {
  member_body<G, COMP>(y0, par, yp0, h0, nfev0, out, B, block_members, L,
                       rec);
}

// The kernel of a build with the t_eval snapshots (tab::SNAP), which takes
// the record (null with rows 0 where the build has none) and the rows.
template <int G, bool COMP>
__global__ void fused_adams_snap_kernel(const float* __restrict__ y0,
                                        const float* __restrict__ par,
                                        const float* __restrict__ yp0,
                                        const float* __restrict__ h0,
                                        const int* __restrict__ nfev0,
                                        Out out, int B, int block_members,
                                        Launch L, Rec rec, Snap snap) {
  member_body<G, COMP>(y0, par, yp0, h0, nfev0, out, B, block_members, L,
                       rec, snap);
}

template <int G>
int launch(const float* y0, const float* par, const float* yp0,
           const float* h0, const int* nfev0, const Out& out, int B,
           const Launch& L, int compensated, int block_members,
           const Rec& rec, const Snap& snap, cudaStream_t s) {
  const int blocks = (B + block_members - 1) / block_members;
  const int threads = block_members * G;
  if constexpr (tab::SNAP) {
    if (compensated) {
      fused_adams_snap_kernel<G, true><<<blocks, threads, 0, s>>>(
          y0, par, yp0, h0, nfev0, out, B, block_members, L, rec, snap);
    } else {
      fused_adams_snap_kernel<G, false><<<blocks, threads, 0, s>>>(
          y0, par, yp0, h0, nfev0, out, B, block_members, L, rec, snap);
    }
  } else if constexpr (tab::REC) {
    if (compensated) {
      fused_adams_record_kernel<G, true><<<blocks, threads, 0, s>>>(
          y0, par, yp0, h0, nfev0, out, B, block_members, L, rec);
    } else {
      fused_adams_record_kernel<G, false><<<blocks, threads, 0, s>>>(
          y0, par, yp0, h0, nfev0, out, B, block_members, L, rec);
    }
  } else if (compensated) {
    fused_adams_kernel<G, true><<<blocks, threads, 0, s>>>(
        y0, par, yp0, h0, nfev0, out, B, block_members, L);
  } else {
    fused_adams_kernel<G, false><<<blocks, threads, 0, s>>>(
        y0, par, yp0, h0, nfev0, out, B, block_members, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches block_members members per block, `lanes` (1, 8, 16 or 32: the
// counts the wrapper takes) threads per member, on the caller's stream and
// returns cudaGetLastError() (cudaErrorInvalidValue for another lane
// count); the wrapper raises on anything but 0.  params is (B, tab::NPAR)
// float32, row-major (null when NPAR is 0); yp0, h0 and nfev0 are each
// member's f(t0, y0), starting step and evaluation count from the float32
// stepper's init; work receives the five work counters of each member.
static int launch_lanes(const void* y0, const void* params, const void* yp0,
                        const void* h0, const void* nfev0, void* y_out,
                        void* status, void* nstep, void* nfev, void* work,
                        int B, const Launch& L, int compensated, int lanes,
                        int block_members, const Rec& rec, const Snap& snap,
                        void* stream) {
  const float* y0f = static_cast<const float*>(y0);
  const float* par = static_cast<const float*>(params);
  const float* yp0f = static_cast<const float*>(yp0);
  const float* h0f = static_cast<const float*>(h0);
  const int* nf0 = static_cast<const int*>(nfev0);
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev),
                static_cast<int*>(work)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:
      return launch<1>(y0f, par, yp0f, h0f, nf0, out, B, L, compensated,
                       block_members, rec, snap, s);
    case 8:
      return launch<8>(y0f, par, yp0f, h0f, nf0, out, B, L, compensated,
                       block_members, rec, snap, s);
    case 16:
      return launch<16>(y0f, par, yp0f, h0f, nf0, out, B, L, compensated,
                        block_members, rec, snap, s);
    case 32:
      return launch<32>(y0f, par, yp0f, h0f, nf0, out, B, L, compensated,
                        block_members, rec, snap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch of a build without dense output or snapshots
// (cudaErrorInvalidValue for a build with either: those take
// fused_adams_record_launch and fused_adams_snap_launch).
extern "C" int fused_adams_launch(const void* y0, const void* params,
                                  const void* yp0, const void* h0,
                                  const void* nfev0, void* y_out,
                                  void* status, void* nstep, void* nfev,
                                  void* work, int B, float t0, float tf,
                                  float dir, float rtol, float atol,
                                  float max_step, int max_steps,
                                  int compensated, int lanes,
                                  int block_members, void* stream) {
  if (tab::REC || tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  return launch_lanes(y0, params, yp0, h0, nfev0, y_out, status, nstep, nfev,
                      work, B, L, compensated, lanes, block_members, Rec{},
                      Snap{}, stream);
}

// The launch of a build with dense output (tab::REC): as
// fused_adams_launch, and each member writes its record (dense_record.cuh)
// to rec_t (B, rows), rec_y and rec_f (B, rows, N), rec_f0 (B, N) and
// rec_n (B,) int32.  cudaErrorInvalidValue for a build without it, one
// with snapshots or rows < 1.
extern "C" int fused_adams_record_launch(
    const void* y0, const void* params, const void* yp0, const void* h0,
    const void* nfev0, void* y_out, void* status, void* nstep, void* nfev,
    void* work, int B, float t0, float tf, float dir, float rtol, float atol,
    float max_step, int max_steps, int compensated, int lanes,
    int block_members, void* rec_t, void* rec_y, void* rec_f, void* rec_f0,
    void* rec_n, int rows, void* stream) {
  if (!tab::REC || tab::SNAP || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  return launch_lanes(y0, params, yp0, h0, nfev0, y_out, status, nstep, nfev,
                      work, B, L, compensated, lanes, block_members, rec,
                      Snap{}, stream);
}

// The launch of a build with snapshots (tab::SNAP): as
// fused_adams_record_launch, the record's arguments null with rows 0 for a
// build without it, and each member writes the rows (snapshot.cuh) of the
// nq points tq (float32, sorted in the direction of integration) at their
// indices idx (int32) in t_eval to y_eval (nq, B, N).
// cudaErrorInvalidValue for a build without tab::SNAP, nq < 1, or rows
// that disagree with tab::REC.
extern "C" int fused_adams_snap_launch(
    const void* y0, const void* params, const void* yp0, const void* h0,
    const void* nfev0, void* y_out, void* status, void* nstep, void* nfev,
    void* work, int B, float t0, float tf, float dir, float rtol, float atol,
    float max_step, int max_steps, int compensated, int lanes,
    int block_members, void* rec_t, void* rec_y, void* rec_f, void* rec_f0,
    void* rec_n, int rows, const void* tq, const void* idx, void* y_eval,
    int nq, void* stream) {
  if (!tab::SNAP || nq < 1 || (rows > 0) != tab::REC || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  const Snap snap{static_cast<const float*>(tq), static_cast<const int*>(idx),
                  static_cast<float*>(y_eval), nq, B};
  return launch_lanes(y0, params, yp0, h0, nfev0, y_out, status, nstep, nfev,
                      work, B, L, compensated, lanes, block_members, rec,
                      snap, stream);
}
