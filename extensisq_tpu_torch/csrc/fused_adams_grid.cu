// Fused SWAG ensemble solver for mid-size systems on Hopper (sm_90a): the
// whole variable-order Adams PECE integration of each member in one launch,
// one thread block per member.
//
// Replaces extensisq_tpu/ops/fused_adams_grid.py:solve_fused_adams_grid
// (B8), the Pallas kernel that runs B3's SWAG loop with the state across
// the 128 lanes.  Its plain PyTorch version is
// extensisq_tpu_torch/ops/fused_adams_grid.py:fused_adams_grid_reference,
// which runs the loop of B3's plain version (ops/fused_adams.py:
// run_adams_loop) on the same members; the two take the same steps up to
// round-off.
//
// Design.  A member's y, yp, the predicted and corrected states (which the
// right-hand side reads, neighbours included), the error weights, the
// predictor's defect temp4, the corrector's f and the KM + 2 rows of the
// scaled divided differences phi live in shared memory: (7 + KM + 2) N
// floats, 21 KB at KM = 12 and N = 256.  Element i belongs to the thread of
// rank i mod (block size), which does every per-element operation on it.
// The per-member scalars (t, h, the order k, the step count ns) are
// computed by every thread from identical inputs, so every thread takes the
// same branches, as in fused_rk_grid.cu.  The coefficient vectors
// (psi/alpha/beta/sig/v/w/g, adams_common.cuh's LaneCoef) are spread over
// the 32 lanes of each warp, element e on lane e, and every warp runs
// coefficients_lanes, the update B3's lane groups run (fused_adams.cu):
// the element-wise steps across the lanes, the running products and the
// diagonal update as one chain in the one-thread update's order, so every
// warp ends with the same values and no barrier is added; the predictor
// and the failure restore take beta[r] and g[r] from lane r by shuffle.
// Each norm is a block sum in a fixed order whose result every thread
// holds; the error ladder's three sums (orders k - 2, k - 1, k) share one
// reduction, and on acceptance the count of non-finite elements at the
// corrected state shares one with the order k + 1 sum (the phi update
// before it runs either way: a member that overflows ends there, and its
// phi is never read again).  So an accepted attempt takes four barriers:
// after the predicted state, the ladder's reduction, after the corrected
// state and the acceptance's reduction; a rejected one two.
//
// What bounds it on the H100: per attempt an element costs two RHS
// evaluations (a stencil of a few flops on shared memory) and ~6 (KM + 2)
// flops on its phi column, and the attempt costs its four barriers and the
// coefficient update's chain of shuffles.  At N = 256 that is latency of
// barriers, reductions and the scalar chain, not the card's flop or byte
// rate; members run in parallel on the SMs (32 members use 32 of 132).
//
// Per-member parameters (params, ops/fused_adams_grid.py): with tab::NPAR
// = K > 0 a member's K parameters are loaded once into its shared memory
// (kPar, after its rows) before anything reads them, and the element
// rhs(t, y, i, p) gets them as p; with K = 0 p is a null pointer, as
// before, and the params pointer is never read.
//
// Dense output (dense=R): a build whose header sets tab::REC writes the end
// (t, y, f) of each accepted step, and of the near-end extrapolation (a
// node at tf with the extrapolated y and the f of the step before it, as
// in the JAX kernel), to its member's rows in device memory
// (dense_record.cuh): every thread the elements it commits, rank 0 the
// time and the count of rows; f0 is the starting state's f(t0, y0) from
// the float32 stepper's init.  The writes sit beside the arithmetic,
// which they leave as it is; without tab::REC the body is called with no
// record and the kernel is that of the build before dense output (the
// record build launches a kernel of its own, fused_adams_grid_record_kernel).
//
// t_eval snapshots (ops/fused_adams_grid.py): a build whose header sets
// tab::SNAP writes each point's row (snapshot.cuh) as the member crosses
// it, as the JAX kernel does (fused_adams_grid.py:601-621): at an accepted
// step the cubic Hermite of the step's end pairs (y, y') and (y_c, f(y_c)),
// at the near-end extrapolation JAX's straight line y + (tq - t) y' for the
// points up to tf, each read before y and y' are overwritten.  Every
// thread holds the member's cursor into the sorted points and writes its
// own elements of each row; points at or before t0 take y0, the points
// left at the end the final y.  The four outputs are those of the build
// without it; the snapshot build launches a kernel of its own
// (fused_adams_grid_snap_kernel, with the record where the build has
// both).
//
// The generated header fused_adams_grid_config.cuh provides
//   namespace tab { G = grid::Grid<N>, KM, N, NPAR, REC, SNAP, INV_N,
//                   FOURU_T, LAND_TOL, GSTR(i), IQQ(i), TWO(i) }
//   __device__ float rhs(float t, const float* y, int i, const float* p);
// (or the template rhs<T>, called here on floats); neighbours come from
// tab::G::rolled.
//
// Numerics as in fused_adams.cu (B3, by line of the Pallas body
// extensisq_tpu/ops/fused_adams_grid.py): time in double-single with the
// 4 2^-30 |t| minimum step (:158, :433-436) and the landing test on the
// double-single remainder (:588-593); powf where the JAX kernel takes
// exp(log x / (k + 1)) (:577-579); a non-finite error estimate rejects
// (:519-520); a member whose starting state or step is not finite, or whose
// accepted step gives a non-finite y or f, ends with status 3 (the JAX
// kernel scrubs such values to 1 and runs on); max_steps counts the
// member's attempts.  float32 only, as the JAX kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "dense_record.cuh"
#include "grid_common.cuh"
#include "fused_adams_grid_config.cuh"
#include "adams_common.cuh"
#include "rk_common.cuh"
#include "snapshot.cuh"

namespace {

using tab::KM;
using tab::N;
using adams::clip;
using rk::Rec;
using rk::Snap;

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;
constexpr int R = KM + 2;  // rows of phi
constexpr int kMaxThreads = 256;

// Shared-memory layout of a member, in floats.
constexpr int kY = 0;          // state
constexpr int kYp = kY + N;    // f at the state
constexpr int kP = kYp + N;    // predicted state, read by the RHS
constexpr int kYc = kP + N;    // corrected state, read by the RHS
constexpr int kFc = kYc + N;   // f at the corrected state
constexpr int kT4 = kFc + N;   // temp4 = f(p) - phi[0]
constexpr int kWt = kT4 + N;   // error weights
constexpr int kPhi = kWt + N;  // phi rows, N each
constexpr int kPar = kPhi + R * N;  // the member's parameters, NPAR
constexpr int kFloats = kPar + tab::NPAR;

struct Launch {  // the launch's scalars, the same for every member
  float t0, tf, dir, rtol, atol, max_step;
  int max_steps;
};

struct Out {
  float* y;
  int* status;
  int* nsteps;
  int* nfev;
};

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// A float32 constant table entry tab::X(i) for a run-time i in [0, LEN).
template <int LEN, class Table>
__device__ __forceinline__ float ctake(Table table, int i) {
  float v = table(0);
#pragma unroll
  for (int r = 1; r < LEN; ++r) v = (i == r) ? table(r) : v;
  return v;
}

struct Gstr {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::GSTR(i);
  }
};
struct Two {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::TWO(i);
  }
};
struct Iqq {
  __device__ __forceinline__ float operator()(int i) const {
    return tab::IQQ(i);
  }
};

// RMS over the member from the group's sum of squares.
__device__ __forceinline__ float member_norm(float sum) {
  return sqrtf(sum * tab::INV_N);
}

// The record of a body called with one (a build with tab::REC, or with
// tab::SNAP: the record and the snapshots); a build without either calls
// the body with none, so that its kernel takes, constructs and passes
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

// Row `step` of the member's record and whether the member writes it: while
// its attempts before this one (it - 1) are below the record's rows; none
// without a record.
struct RowAt {
  bool write;
  size_t row;
};
__device__ __forceinline__ RowAt row_at(int, int, int) { return {false, 0}; }
template <class... More>
__device__ __forceinline__ RowAt row_at(int member, int step, int it,
                                        const Rec& rec, const More&...) {
  return {it <= rec.rows, rec.row(member, step)};
}

// The whole integration of one member by the group g (rank(), size(),
// sync() and sums(v), the group's sums of the K values of v, every value
// reduced in its own fixed order and the results held by every thread),
// with the coefficient vectors spread over the W lanes of `lanes` (rank(),
// shfl(v, src); W = 32 on the card, the lanes of a warp).  sm is the
// member's shared memory (kFloats); y0, yp0 its initial state and f(t0,
// y0), params every member's tab::NPAR parameters (unread when there are
// none), h0 and nfev0 its starting step and evaluation count from the
// float32 stepper's init, as in the JAX package; with tab::REC the
// member's record is the Rec of `record`, and with tab::SNAP its t_eval
// rows the Snap after it.
template <int W, class Group, class Lanes, class... Record>
__device__ void integrate(Group& g, Lanes& lanes, float* sm,
                          const float* __restrict__ y0,
                          const float* __restrict__ yp0,
                          const float* __restrict__ params, float h0,
                          int nfev0, const Launch& L, int member,
                          const Out& out, const Record&... record) {
  using Coef = adams::LaneCoef<KM, W>;
  constexpr int S = Coef::S;
  constexpr int S1 = Coef::S1;
  const int r0 = g.rank();
  const int nt = g.size();
  const int lane = lanes.rank();
  float* Y = sm + kY;
  float* Yp = sm + kYp;
  float* P = sm + kP;
  float* Yc = sm + kYc;
  float* Fc = sm + kFc;
  float* T4 = sm + kT4;
  float* Wt = sm + kWt;
  float* phi = sm + kPhi;
  const float* par = tab::NPAR > 0 ? sm + kPar : nullptr;

  // the starting state (steppers/adams.py:init) and the parameters; one
  // reduction counts the elements that are not finite, and its barrier
  // publishes the parameters
  if constexpr (tab::NPAR > 0) {
    for (int q = r0; q < tab::NPAR; q += nt) {
      sm[kPar + q] = params[static_cast<size_t>(member) * tab::NPAR + q];
    }
  }
  // the next sorted t_eval point (tab::SNAP): the rows of those at or
  // before t0 get the thread's elements of y0
  int q = 0;
  if constexpr (tab::SNAP) q = the_snap(record...).past(0, L.dir, L.t0);
  float bad[1] = {0.0f};
  for (int i = r0; i < N; i += nt) {
    if constexpr (tab::SNAP) {
      const Snap& snap = the_snap(record...);
      for (int p = 0; p < q; ++p) snap.row(p, member, N)[i] = y0[i];
    }
    Y[i] = y0[i];
    Yp[i] = yp0[i];
    phi[i] = Yp[i];
#pragma unroll
    for (int r = 1; r < R; ++r) phi[r * N + i] = 0.0f;
    bad[0] += (isfinite(Y[i]) && isfinite(Yp[i])) ? 0.0f : 1.0f;
    if constexpr (tab::REC) {
      the_record(record...).f0[static_cast<size_t>(member) * N + i] = Yp[i];
    }
  }
  g.sums(bad);
  const bool start_ok = bad[0] == 0.0f && isfinite(h0);

  // the lane's elements of the coefficient vectors and of tab::IQQ
  Coef c;
  float iqq[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    c.psi[s] = c.alpha[s] = c.beta[s] = c.v[s] = c.w[s] = 0.0f;
    iqq[s] = ctake<KM>(Iqq{}, s * W + lane);
  }
#pragma unroll
  for (int s = 0; s < S1; ++s) {
    const int e = s * W + lane;
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
  int status = start_ok ? kRunning : kOverflow;
  int it = 0;
  int nrec = 0;  // rows of the record written (tab::REC)

  while (status == kRunning && it < L.max_steps) {
    const float tc = t + t_lo;  // double-single time carry
    const float min_step = tab::FOURU_T * fabsf(tc);
    const float d = (L.tf - t) - t_lo;  // remaining interval in DS
    it += 1;
    if (fabsf(d) <= min_step) {
      // near-end linear extrapolation; counts as a step, evaluates nothing;
      // a node of the record at tf with the f of the step before
      const RowAt at = row_at(member, nsteps, it, record...);
      // the points up to tf take the extrapolation's straight line
      int q_end = 0;
      if constexpr (tab::SNAP) {
        q_end = the_snap(record...).past(q, L.dir, L.tf);
      }
      for (int i = r0; i < N; i += nt) {
        if constexpr (tab::SNAP) {
          const Snap& snap = the_snap(record...);
          for (int p = q; p < q_end; ++p) {
            snap.row(p, member, N)[i] =
                rk::line_row(snap.tq[p], t, Y[i], Yp[i]);
          }
        }
        Y[i] = Y[i] + d * Yp[i];
        if constexpr (tab::REC) {
          if (at.write) {
            the_record(record...).y[at.row * N + i] = Y[i];
            the_record(record...).f[at.row * N + i] = Yp[i];
          }
        }
      }
      t = L.tf;
      t_lo = 0.0f;
      if constexpr (tab::REC) {
        if (at.write) {
          if (r0 == 0) the_record(record...).t[at.row] = t;
          nrec += 1;
        }
      }
      if constexpr (tab::SNAP) q = q_end;
      nsteps += 1;
      status = kFinished;
      break;
    }

    // fresh steps: clamp h toward tf and max_step
    float h_in = h;
    if (fresh) {
      const float hc = L.dir * (h - d) > 0.0f ? d : h;
      h_in = sgn(hc) * fminf(fabsf(hc), L.max_step);
      ifail = 0;
    }
    int ns2 = h_in != hold ? 0 : ns;
    if (ns2 <= kold) ns2 += 1;
    adams::coefficients_lanes<KM, W>(lanes, c, iqq, h_in, k, ns2, kprev,
                                     kold);
    const int km1 = k - 1;
    const int km2 = k - 2;
    // beta and g in every thread, element r from lane r
    float beta[KM], gw[KM + 1];
#pragma unroll
    for (int r = 0; r < KM; ++r) beta[r] = lanes.shfl(c.beta[r / W], r % W);
#pragma unroll
    for (int r = 0; r <= KM; ++r) gw[r] = lanes.shfl(c.g[r / W], r % W);

    // block 2: predict (own elements); phi[r] *= beta[r] for r in [ns, k),
    // phi[k + 1] = phi[k], phi[k] = 0, p = h sum_{r < k} g[r] phi[r] + y,
    // then the reverse cumulative sum over rows < k
    for (int i = r0; i < N; i += nt) {
      float col[R];
#pragma unroll
      for (int r = 0; r < R; ++r) col[r] = phi[r * N + i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= ns2 && r < k) col[r] = col[r] * beta[r < KM ? r : KM - 1];
      }
      adams::put(col, k + 1, adams::take(col, k));
      adams::put(col, k, 0.0f);
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r <= KM; ++r) {
        const float gr = r < k ? gw[r] : 0.0f;
        acc = acc + gr * col[r];
      }
      P[i] = h_in * acc + Y[i];
      float run = 0.0f;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        if (r < k) {
          run = run + col[r];
          col[r] = run;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) phi[r * N + i] = col[r];
    }
    g.sync();  // P complete before the RHS reads neighbours

    const float x = tc + h_in;
    const int r1 = clip(km1, 0, R - 1);
    const int r2 = clip(km2, 0, R - 1);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int i = r0; i < N; i += nt) {
      const float fp = rhs(x, P, i, par);
      const float wt = L.atol + L.rtol * 0.5f * (fabsf(P[i]) + fabsf(Y[i]));
      const float inv_wt = 1.0f / wt;
      const float t4 = fp - phi[i];
      Wt[i] = wt;
      T4[i] = t4;
      const float e0 = t4 * inv_wt;
      const float e1 = (phi[r1 * N + i] + t4) * inv_wt;
      const float e2 = (phi[r2 * N + i] + t4) * inv_wt;
      s0 = s0 + e0 * e0;
      s1 = s1 + e1 * e1;
      s2 = s2 + e2 * e2;
    }
    nfev += 1;
    float ladder[3] = {s0, s1, s2};
    g.sums(ladder);
    const float absh = fabsf(h_in);
    float erk = absh * member_norm(ladder[0]);
    const float erkm1 = absh * member_norm(ladder[1]) *
                        adams::lget<W>(lanes, c.sig, clip(km1, 0, KM)) *
                        ctake<13>(Gstr{}, clip(km2, 0, 12));
    const float erkm2 = absh * member_norm(ladder[2]) *
                        adams::lget<W>(lanes, c.sig, clip(km2, 0, KM)) *
                        ctake<13>(Gstr{}, clip(km2 - 1, 0, 12));
    float err = erk * (adams::lget<W>(lanes, c.g, clip(km1, 0, KM)) -
                       adams::lget<W>(lanes, c.g, clip(k, 0, KM)));
    erk = erk * adams::lget<W>(lanes, c.sig, clip(k, 0, KM)) *
          ctake<13>(Gstr{}, clip(km1, 0, 12));
    const bool bad_e = !isfinite(err);
    if (bad_e) err = 11.0f;
    // max(erkm1, erkm2) < erk, false where either is NaN (torch.maximum)
    const int knew = (k > 2 && erkm1 < erk && erkm2 < erk)
                         ? km1
                         : ((k == 2 && erkm1 < 0.5f * erk) ? km1 : k);
    const bool success = err <= 1.0f && !bad_e;

    if (success) {
      // block 4: correct (own elements); then f at the corrected state,
      // the phi update and the norm at order k + 1, with the count of the
      // elements that are not finite in the same reduction
      const float g_k = adams::lget<W>(lanes, c.g, clip(k, 0, KM));
      for (int i = r0; i < N; i += nt) Yc[i] = h_in * g_k * T4[i] + P[i];
      g.sync();
      float acc2[2] = {0.0f, 0.0f};  // non-finite count, sum of squares
      for (int i = r0; i < N; i += nt) {
        const float fc = rhs(x, Yc, i, par);
        Fc[i] = fc;
        acc2[0] += (isfinite(Yc[i]) && isfinite(fc)) ? 0.0f : 1.0f;
        const float pkn = fc - phi[i];
        phi[k * N + i] = pkn;
        phi[(k + 1) * N + i] = pkn - phi[(k + 1) * N + i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < k) phi[r * N + i] = phi[r * N + i] + pkn;
        }
        const float q = phi[(k + 1) * N + i] / Wt[i];
        acc2[1] = acc2[1] + q * q;
      }
      nfev += 1;
      g.sums(acc2);
      if (acc2[0] != 0.0f) {
        status = kOverflow;
        break;
      }
      const float erkp1 =
          ctake<13>(Gstr{}, clip(k, 0, 12)) * absh * member_norm(acc2[1]);

      // order selection for the next step (shampine.py:420-455)
      const bool ph1 = phase1 && !(knew == km1 || k == KM);
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
      // the t_eval points the step crosses, from the step's start
      const float t_step = t;
      int q_end = 0;
      if constexpr (tab::SNAP) {
        q_end = the_snap(record...).past(q, L.dir, is_last ? L.tf : t_adv);
      }
      t = is_last ? L.tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
      // the step's end at row nsteps of the record
      const RowAt at = row_at(member, nsteps, it, record...);
      for (int i = r0; i < N; i += nt) {
        if constexpr (tab::SNAP) {
          const Snap& snap = the_snap(record...);
          for (int p = q; p < q_end; ++p) {
            snap.row(p, member, N)[i] =
                rk::hermite(snap.theta(p, t_step, h_in), h_in, Y[i], Yp[i],
                            Yc[i], Fc[i]);
          }
        }
        Y[i] = Yc[i];
        Yp[i] = Fc[i];
        if constexpr (tab::REC) {
          if (at.write) {
            the_record(record...).y[at.row * N + i] = Y[i];
            the_record(record...).f[at.row * N + i] = Yp[i];
          }
        }
      }
      if constexpr (tab::REC) {
        if (at.write) {
          if (r0 == 0) the_record(record...).t[at.row] = t;
          nrec += 1;
        }
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
      if constexpr (tab::SNAP) q = q_end;
      nsteps += 1;
      if (is_last) status = kFinished;
    } else {
      // block 3: failure restore (shampine.py:369-398), own elements
      for (int i = r0; i < N; i += nt) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < k) {
            const float b = beta[r < KM ? r : KM - 1];
            const float bsafe = b == 0.0f ? 1.0f : b;
            const float up = phi[(r + 1 < R ? r + 1 : R - 1) * N + i];
            phi[r * N + i] = (phi[r * N + i] - up) / bsafe;
          }
        }
      }
      float psi_up[S];
      adams::shift_down<W, KM>(lanes, c.psi, psi_up);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s * W + lane < km1) c.psi[s] = psi_up[s] - h_in;
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

  g.sync();
  for (int i = r0; i < N; i += nt) {
    out.y[static_cast<size_t>(member) * N + i] = Y[i];
    // the points the member never reached take its final y
    if constexpr (tab::SNAP) {
      const Snap& snap = the_snap(record...);
      for (int p = q; p < snap.nq; ++p) snap.row(p, member, N)[i] = Y[i];
    }
  }
  if (r0 == 0) {
    out.status[member] = status;
    out.nsteps[member] = nsteps;
    out.nfev[member] = nfev;
    if constexpr (tab::REC) the_record(record...).n[member] = nrec;
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "block_group.cuh"
#include "lane_group.cuh"

namespace {

// sums of up to kMaxSums values in one barrier
constexpr int kMaxSums = 3;

// The member of this block from the kernel's arguments, with the record
// and the snapshots where a build has them.
template <class... Record>
__device__ __forceinline__ void member_body(const float* __restrict__ y0,
                                            const float* __restrict__ yp0,
                                            const float* __restrict__ h0,
                                            const int* __restrict__ nfev0,
                                            const float* __restrict__ par,
                                            const Launch& L, const Out& out,
                                            const Record&... record) {
  extern __shared__ float sm[];
  __shared__ float red[2 * kMaxSums * 32];
  BlockGroupOf<kMaxSums> g{red};
  LaneGroup<32> lanes;
  const int m = blockIdx.x;
  const size_t off = static_cast<size_t>(m) * N;
  integrate<32>(g, lanes, sm, y0 + off, yp0 + off, par, h0[m], nfev0[m], L,
                m, out, record...);
}

// The kernel of a build without the dense record or the snapshots; a build
// with either instantiates only fused_adams_grid_record_kernel or
// fused_adams_grid_snap_kernel.
template <int = 0>
__global__ void __launch_bounds__(kMaxThreads)
    fused_adams_grid_kernel(const float* __restrict__ y0,
                            const float* __restrict__ yp0,
                            const float* __restrict__ h0,
                            const int* __restrict__ nfev0,
                            const float* __restrict__ par, Launch L,
                            Out out) {
  member_body(y0, yp0, h0, nfev0, par, L, out);
}

// The kernel of a build with the dense record (tab::REC) and without the
// snapshots, which takes the record.
template <int = 0>
__global__ void __launch_bounds__(kMaxThreads)
    fused_adams_grid_record_kernel(const float* __restrict__ y0,
                                   const float* __restrict__ yp0,
                                   const float* __restrict__ h0,
                                   const int* __restrict__ nfev0,
                                   const float* __restrict__ par, Launch L,
                                   Out out, Rec rec) {
  member_body(y0, yp0, h0, nfev0, par, L, out, rec);
}

// The kernel of a build with the t_eval snapshots (tab::SNAP), which takes
// the record (null with rows 0 where the build has none) and the rows.
template <int = 0>
__global__ void __launch_bounds__(kMaxThreads)
    fused_adams_grid_snap_kernel(const float* __restrict__ y0,
                                 const float* __restrict__ yp0,
                                 const float* __restrict__ h0,
                                 const int* __restrict__ nfev0,
                                 const float* __restrict__ par, Launch L,
                                 Out out, Rec rec, Snap snap) {
  member_body(y0, yp0, h0, nfev0, par, L, out, rec, snap);
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after cudaFuncSetAttribute).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One block of `threads` per member on `st`, with the member's rows as
// dynamic shared memory; the snapshot kernel where SNAP (tab::SNAP), else
// the record kernel where RECORD (tab::REC): a build instantiates one of
// the three.
template <bool SNAP, bool RECORD>
int launch(int members, int threads, cudaStream_t st, const float* y0,
           const float* yp0, const float* h0, const int* nfev0,
           const float* par, const Launch& L, const Out& out,
           const Rec& rec, const Snap& snap) {
  const int bytes = static_cast<int>(kFloats * sizeof(float));
  if constexpr (SNAP) {
    const cudaError_t e = allow_smem(fused_adams_grid_snap_kernel<>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_adams_grid_snap_kernel<><<<members, threads, bytes, st>>>(
        y0, yp0, h0, nfev0, par, L, out, rec, snap);
  } else if constexpr (RECORD) {
    const cudaError_t e = allow_smem(fused_adams_grid_record_kernel<>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_adams_grid_record_kernel<><<<members, threads, bytes, st>>>(
        y0, yp0, h0, nfev0, par, L, out, rec);
  } else {
    const cudaError_t e = allow_smem(fused_adams_grid_kernel<>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_adams_grid_kernel<><<<members, threads, bytes, st>>>(
        y0, yp0, h0, nfev0, par, L, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shared memory one member needs and the most a block may have on this
// card, in bytes; returns the CUDA error code.
extern "C" int fused_adams_grid_smem(int* need, int* limit) {
  int dev = 0;
  cudaGetDevice(&dev);
  *need = static_cast<int>(kFloats * sizeof(float));
  cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(cudaGetLastError());
}

// Launches one block of `threads` (a multiple of 32, at most kMaxThreads)
// per member on the caller's stream, with the member's rows as dynamic
// shared memory, and returns the CUDA error code; the wrapper raises on
// anything but 0.  yp0, h0 and nfev0 are each member's f(t0, y0), starting
// step and evaluation count from the float32 stepper's init; params is (B,
// tab::NPAR) float32, row-major (null when NPAR is 0).  A build with dense
// output or snapshots refuses (cudaErrorInvalidValue): it takes
// fused_adams_grid_record_launch or fused_adams_grid_snap_launch.
extern "C" int fused_adams_grid_launch(const void* y0, const void* yp0,
                                       const void* h0, const void* nfev0,
                                       const void* params, void* y_out,
                                       void* status, void* nstep, void* nfev,
                                       int members, float t0, float tf,
                                       float dir, float rtol, float atol,
                                       float max_step, int max_steps,
                                       int threads, void* stream) {
  if (tab::REC || tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  return launch<tab::SNAP, tab::REC>(
      members, threads, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(y0), static_cast<const float*>(yp0),
      static_cast<const float*>(h0), static_cast<const int*>(nfev0),
      static_cast<const float*>(params), L, out, Rec{}, Snap{});
}

// The launch of a build with dense output (tab::REC): as
// fused_adams_grid_launch, and each member writes its record
// (dense_record.cuh) to rec_t (B, rows), rec_y and rec_f (B, rows, N),
// rec_f0 (B, N) and rec_n (B,) int32.  cudaErrorInvalidValue for a build
// without it, one with snapshots or rows < 1.
extern "C" int fused_adams_grid_record_launch(
    const void* y0, const void* yp0, const void* h0, const void* nfev0,
    const void* params, void* y_out, void* status, void* nstep, void* nfev,
    int members, float t0, float tf, float dir, float rtol, float atol,
    float max_step, int max_steps, int threads, void* rec_t, void* rec_y,
    void* rec_f, void* rec_f0, void* rec_n, int rows, void* stream) {
  if (!tab::REC || tab::SNAP || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  return launch<tab::SNAP, tab::REC>(
      members, threads, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(y0), static_cast<const float*>(yp0),
      static_cast<const float*>(h0), static_cast<const int*>(nfev0),
      static_cast<const float*>(params), L, out, rec, Snap{});
}

// The launch of a build with snapshots (tab::SNAP): as
// fused_adams_grid_record_launch, the record's arguments null with rows 0
// for a build without it, and each member writes the rows (snapshot.cuh)
// of the nq points tq (float32, sorted in the direction of integration) at
// their indices idx (int32) in t_eval to y_eval (nq, B, N).
// cudaErrorInvalidValue for a build without tab::SNAP, nq < 1, or rows
// that disagree with tab::REC.
extern "C" int fused_adams_grid_snap_launch(
    const void* y0, const void* yp0, const void* h0, const void* nfev0,
    const void* params, void* y_out, void* status, void* nstep, void* nfev,
    int members, float t0, float tf, float dir, float rtol, float atol,
    float max_step, int max_steps, int threads, void* rec_t, void* rec_y,
    void* rec_f, void* rec_f0, void* rec_n, int rows, const void* tq,
    const void* idx, void* y_eval, int nq, void* stream) {
  if (!tab::SNAP || nq < 1 || (rows > 0) != tab::REC || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  const Rec rec{static_cast<float*>(rec_t), static_cast<float*>(rec_y),
                static_cast<float*>(rec_f), static_cast<float*>(rec_f0),
                static_cast<int*>(rec_n), rows};
  const Snap snap{static_cast<const float*>(tq), static_cast<const int*>(idx),
                  static_cast<float*>(y_eval), nq, members};
  return launch<tab::SNAP, tab::REC>(
      members, threads, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(y0), static_cast<const float*>(yp0),
      static_cast<const float*>(h0), static_cast<const int*>(nfev0),
      static_cast<const float*>(params), L, out, rec, snap);
}
