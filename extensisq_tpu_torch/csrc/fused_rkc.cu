// Fused RKC solver for Hopper (sm_90a): a whole adaptive SSV2stab
// integration of a semi-discretized PDE grid in one launch.
//
// Replaces the two Pallas kernels of extensisq_tpu/ops/fused_rkc.py, which
// share one body, `_integrate`: solve_fused_rkc (B9, one grid) and
// solve_fused_rkc_ensemble (B10, one member grid per program instance).
// Here too one device template, integrate<RHO, Group>, runs both; Group is
// the threads that work on one member and where its arrays live:
//   * B9:  the whole grid of a cooperative launch, so every SM works on the
//          one member; every block is resident (the host sizes the grid from
//          the occupancy), and a split grid barrier of its own (a counter
//          in the workspace) is the barrier;
//   * B10: a thread-block cluster of C = 2, 4 or 8 CTAs per member on as
//          many SMs, or, where the wrapper's rule finds no such C
//          (ops/fused_rkc.py:_cluster_size), one CTA per member.
// Its plain PyTorch version is extensisq_tpu_torch/ops/fused_rkc.py:
// fused_rkc_reference; the two take the same steps up to round-off.
//
// Design.  Thousands of threads share one member, so every per-member scalar
// (t, h, m, accept/reject, status, the power iteration's exit, the Chebyshev
// coefficients) is computed by every thread from identical inputs, and every
// thread takes the same branch: no broadcast, and no thread can miss a
// barrier.  A group owns the elements [lo, hi) of the member (all of them,
// but for a CTA of a cluster its contiguous chunk), element i belonging to
// the thread of rank (i - lo) mod (threads).  Per member there are nine
// arrays: y_hi, y_lo, f, f_new, two deviation buffers e (the stage
// recurrence updates e_{j-2} in place with e_j), two stage-argument buffers
// a (double-buffered, so one group barrier per stage suffices) and V, the
// power iteration's warm start (its iterate and f(v) reuse the a buffers).
// Only the a buffers are read at other elements' indices (by the user's
// stencil, across the chunks), so they and V stay in a global workspace;
// the six arrays read at their own index only live where Group::kLocal
// says: in global memory (B10 at C = 1: 576 KB a member at 2x64x128, which
// no SM's L1 holds, so every stage went to L2 through one SM's port, ~35
// GB/s; and B9 where a block's share does not fit), or in shared memory:
// each CTA's chunk (B10 at C > 1: 192 KB a CTA at C = 2 and 2x64x128), or
// on B9's grid the slots of each block's threads' own elements (24 KB a
// block at 2x256x256 on 132 blocks of 512).  Under a rho callback, which
// reads the whole member, a global copy of y_hi is written at each
// accepted step.  A norm is a group sum: a warp butterfly
// (all lanes end with the same value), the warps' sums in shared memory
// added in order by every thread, then on the grid the blocks' sums in a
// global slot each, added lane-strided and butterflied by every warp, and
// in a cluster each CTA's sum written into every peer's shared memory
// (DSMEM) and the C sums added in rank order.  The order is fixed by the
// launch shape, so every thread holds the identical total.
//
// What bounds it on the H100: per stage each element costs one RHS (a
// 5-point stencil with its periodic index arithmetic: ~20 flops and five
// loads of a) and ~10 flops of the recurrence, and the stage ends in a
// barrier: the whole grid's (B9), the cluster's (B10 at C > 1) or a
// __syncthreads (B10 at C = 1).  B9 at 131,072 elements is bound by the
// grid barrier and the L2 round trips of the stencil's reads, not by the
// card's flop rate; the next stage's Chebyshev scalars are computed
// between the barrier's arrive and its wait.  B10 at C > 1
// takes ~2.6 us a stage of fixed work (the barrier, and the Chebyshev
// scalars, computed between its arrive and its wait) and ~1 SM cycle per
// element of the CTA's chunk (tools/probe_fused_rkc.py: 3.7, 4.8 and 7.1
// us per evaluation at C = 8, 4 and 2 on 2x64x128), so on clusters of 2
// it is bound by instruction issue on 128 SMs; issuing the stencil loads
// of four elements together (fewer L2 round trips) ran no faster.
//
// Visibility across the cluster: a_next is written by one CTA and read by
// its peers on other SMs after the cluster barrier (barrier.cluster.arrive
// .release / wait.acquire).  The arrive compiles to MEMBAR.ALL.GPU and
// UCGABAR_ARV, the wait to UCGABAR_WAIT and CCTL.IVALL, an invalidation of
// the SM's L1, so no stale line of a survives a barrier; the card check
// runs the cluster launch three times and requires bit-identical outputs.
//
// t_eval snapshots (ops/fused_rkc.py): a build whose header sets
// tab::SNAP writes each point's row as the JAX kernel does, by its pending
// index (snapshot.cuh: Pending; fused_rkc.py:494-513, :570-584, :605-616):
// the points in the order given, the index iq beside t in every thread
// (a member's decision is uniform over its group, which holds one t);
// the points at or before t0 take y0, an accepted step writes point iq
// while dir tq <= dir t_new and moves on, with the unclamped cubic
// Hermite of its end pairs (y, f) and (y_k, f_new) at theta = ((tq - t) -
// t_lo) / h, and every point from iq on takes the final y.  Each thread
// writes its own elements of a row (B9: every block of the grid; B10:
// each CTA its chunk), read before y and f are overwritten.  The
// snapshot build's kernels take the points as one more argument
// (Pts...); without tab::SNAP they take none and are those of the build
// before it.
//
// The grid shape, the parameter count, the float32 constants and the user's
// right-hand side come from the generated header fused_rkc_config.cuh:
//   namespace tab { G = grid::Grid<...>, NTOT, NPAR, SNAP, SQRTMIN, SQRTU,
//                   ONE_P_SQRTU, RHO_UROUND, HMIN_C }
//   __device__ float rhs(float t, const float* y, int i, const float* p);
//   __device__ float rho(float t, const float* y, const float* p);
//
// Numerics (by line of the Pallas body, extensisq_tpu/ops/fused_rkc.py):
//  * the deviation-form stage recurrence (:257-336) with the Chebyshev
//    coefficients in double-single (ds.cuh), the stage arrays in float32 and
//    the y carry in double-single; t in double-single;
//  * the coefficient scalars round every operation on its own (__f*_rn), as
//    the plain version and the JAX kernel do; sinhf/coshf where the JAX
//    kernel takes exp (:289-295), powf where it takes exp(log x / 3)
//    (:396-409), selects where it blends (_sblend, :62);
//  * a non-finite absh is clamped before m is cast to int (:368);
//  * a non-finite error norm ends the member with status 3 (B10: the other
//    members run on); a power iteration that does not converge in 50
//    iterations gives status 6 (:522); max_steps counts attempts (:523).
// Elsewhere nvcc may contract a*b + c into one fma.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <math.h>

#include "ds.cuh"
#include "grid_common.cuh"
#include "fused_rkc_config.cuh"
#include "snapshot.cuh"

namespace {

constexpr int kRunning = 0;
constexpr int kFinished = 1;
constexpr int kTooSmall = 2;
constexpr int kOverflow = 3;
constexpr int kRhoFail = 6;
constexpr int kItMax = 50;       // power-iteration bound
constexpr int NTOT = tab::NTOT;
constexpr int kArrays = 9;       // per-member arrays in the workspace
// B9's block size bound: a grid kernel of at most 512 threads per block may
// use 128 registers a thread (B10's blocks of up to 1024 get 64)
constexpr int kGridThreads = 512;
// B10's CTA size bound at cluster size C > 1 (64 registers a thread; CTAs
// of 512 with 128 ran slower on 5d, tools/probe_fused_rkc.py)
constexpr int kClusterThreads = 1024;

// how the spectral radius is found
constexpr int kRhoConst = 0;     // a float bound
constexpr int kRhoFn = 1;        // the user's rho(t, y, p)
constexpr int kRhoPower = 2;     // the nonlinear power iteration

struct Solve {  // the launch's scalars, the same for every member
  float t0, tf, dir, rtol, atol, h0, rho_const, max_step;
  int mmax, max_steps, const_jac;
};

struct Out {
  float* y;
  int* status;
  int* nsteps;
  int* nfev;
  int* nfesig;
};

// The Chebyshev recurrence's scalars (sommeijer.py:273-329 in the JAX
// kernel's double-single form), advanced stage by stage by every thread.
struct Cheb {
  ds::DS two_w0, zjm2, zjm1, dzjm2, dzjm1, d2zjm2, d2zjm1, bjm2, bjm1;
  float w0c, w1, mus0, thjm2, thjm1;

  __device__ __forceinline__ void start(int m) {
    const float mf = static_cast<float>(m);
    const ds::DS w0 = ds::add_f(
        ds::div(ds::lift(2.0f), ds::lift(__fmul_rn(__fmul_rn(13.0f, mf), mf))),
        1.0f);
    two_w0 = ds::mul_f(w0, 2.0f);
    w0c = ds::collapse(w0);
    const float temp1 = __fsub_rn(__fmul_rn(w0c, w0c), 1.0f);
    const float temp2 = sqrtf(temp1);
    const float arg = __fmul_rn(mf, logf(__fadd_rn(w0c, temp2)));
    const float sinh_a = sinhf(arg);
    const float cosh_a = coshf(arg);
    w1 = __fdiv_rn(__fmul_rn(sinh_a, temp1),
                   __fsub_rn(__fmul_rn(__fmul_rn(cosh_a, mf), temp2),
                             __fmul_rn(w0c, sinh_a)));
    const ds::DS bj0 = ds::div(ds::lift(1.0f), ds::mul(two_w0, two_w0));
    mus0 = __fmul_rn(w1, ds::collapse(bj0));
    thjm2 = 0.0f;
    thjm1 = mus0;
    zjm2 = ds::lift(1.0f);
    zjm1 = w0;
    dzjm2 = ds::lift(0.0f);
    dzjm1 = ds::lift(1.0f);
    d2zjm2 = ds::lift(0.0f);
    d2zjm1 = ds::lift(0.0f);
    bjm2 = bj0;
    bjm1 = bj0;
  }

  // The coefficients of the next stage: e_j = muc e_{j-1} + nuc e_{j-2} +
  // (h mus) (f_j - ajc f), f_j taken at t + h th.
  __device__ __forceinline__ void next(float& muc, float& nuc, float& ajc,
                                       float& mus, float& th) {
    const ds::DS zj = ds::add(ds::mul(two_w0, zjm1), ds::neg(zjm2));
    const ds::DS dzj = ds::add(ds::add(ds::mul(two_w0, dzjm1), ds::neg(dzjm2)),
                               ds::mul_f(zjm1, 2.0f));
    const ds::DS d2zj =
        ds::add(ds::add(ds::mul(two_w0, d2zjm1), ds::neg(d2zjm2)),
                ds::mul_f(dzjm1, 4.0f));
    const ds::DS bj = ds::div(d2zj, ds::mul(dzj, dzj));
    const ds::DS ajm1 = ds::add_f(ds::neg(ds::mul(zjm1, bjm1)), 1.0f);
    const ds::DS mu = ds::div(ds::mul(two_w0, bj), bjm1);
    const ds::DS nu = ds::neg(ds::div(bj, bjm2));
    muc = ds::collapse(mu);
    nuc = ds::collapse(nu);
    ajc = ds::collapse(ajm1);
    mus = __fdiv_rn(__fmul_rn(muc, w1), w0c);
    th = thjm1;
    const float thj =
        __fadd_rn(__fadd_rn(__fmul_rn(muc, thjm1), __fmul_rn(nuc, thjm2)),
                  __fmul_rn(mus, __fsub_rn(1.0f, ajc)));
    thjm2 = thjm1;
    thjm1 = thj;
    zjm2 = zjm1;
    zjm1 = zj;
    dzjm2 = dzjm1;
    dzjm1 = dzj;
    d2zjm2 = d2zjm1;
    d2zjm1 = d2zj;
    bjm2 = bjm1;
    bjm1 = bj;
  }
};

__device__ __forceinline__ float cube_root(float x) {
  return powf(x, 1.0f / 3.0f);
}

// The t_eval points of a body called with them (a build with tab::SNAP),
// the thread's copy whose pending index the body moves; a build without
// them calls the body with none, so that its kernels take, construct and
// pass nothing for them.
__device__ __forceinline__ rk::Pending& the_points(rk::Pending& pts) {
  return pts;
}

// The whole integration of one member by the group g: rank(), size(),
// sync() (or its two halves, arrive() and wait(), with work on registers
// between them), sum(x) (the group's sum of x, identical in every
// thread), the elements [lo(), hi()) it owns (element i to the thread of
// rank (i - lo) mod size), and kLocal, where the six elementwise arrays
// live: if not kLocal, in w; else in sm, local_len() floats each, the k-th
// element of a thread at local_rank() + k local_size() (its block's slots:
// a CTA's chunk in a cluster, a block's share of the grid).  y0 and p are
// the member's initial grid and parameters; w its kArrays * NTOT floats of
// workspace; with tab::SNAP `pts` is the t_eval points, their rows and
// the member's pending index.
template <int RHO, class Group, class... Pts>
__device__ void integrate(Group& g, const float* __restrict__ y0,
                          const float* __restrict__ p, float* w, float* sm,
                          const Solve& s, int member, const Out& out,
                          Pts&... pts) {
  constexpr bool LOCAL = Group::kLocal;
  const int rank = g.rank();
  const int nthr = g.size();
  const int lo = g.lo();
  const int hi = g.hi();
  // a thread's k-th element i = lo + rank + k nthr is entry l = l0 + k
  // lstep of the elementwise arrays: i itself in the workspace, else its
  // slot in the group's share (len floats each)
  int l0 = lo + rank;
  int lstep = nthr;
  int len = NTOT;
  if constexpr (LOCAL) {
    l0 = g.local_rank();
    lstep = g.local_size();
    len = g.local_len();
  }
  float* const ew = LOCAL ? sm : w;
  float* y_hi = ew;
  float* y_lo = ew + len;
  float* f = ew + 2 * len;
  float* f_new = ew + 3 * len;
  float* e_a = ew + 4 * len;
  float* e_b = ew + 5 * len;
  float* arg[2] = {w + 6 * NTOT, w + 7 * NTOT};
  float* V = w + 8 * NTOT;
  float* y_glob = w;  // with kLocal: the copy of y_hi that rho() reads
  constexpr bool kGlobY = LOCAL && RHO == kRhoFn;
  const float nf = static_cast<float>(NTOT);  // jnp.mean divides by n

  for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
    y_hi[l] = y0[i];
    y_lo[l] = 0.0f;
    if constexpr (kGlobY) y_glob[i] = y0[i];
  }
  // the t_eval points at or before t0 take y0 (tab::SNAP): the pending
  // index moves past them
  if constexpr (tab::SNAP) {
    rk::Pending& pq = the_points(pts...);
    pq.iq = pq.reached(0, s.dir, s.t0);
    for (int q = 0; q < pq.iq; ++q) {
      float* r = pq.row(q, member, NTOT);
      for (int i = lo + rank; i < hi; i += nthr) r[i] = y0[i];
    }
  }
  g.sync();
  for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
    f[l] = rhs(s.t0, y0, i, p);
    if constexpr (RHO == kRhoPower) V[i] = f[l];
  }
  // steppers/rkc.py:141-143: hmax from the span and max_step
  const float mse = fminf(fabsf(s.tf - s.t0), s.max_step);
  const float small = 1.0f / mse;

  float t = s.t0;
  float t_lo = 0.0f;
  float h_abs = s.h0;
  float h_prev = 0.0f;
  float err_old = 1.0f;
  float sprad = 0.0f;
  int status = kRunning;
  int nstep = 0;
  int nfev = 1;
  int nfesig = 0;
  bool newspc = true;
  bool jacatt = false;
  int nstsig = 0;
  int it = 0;

  while (status == kRunning) {
    g.sync();  // the last attempt's writes (y, f) are visible to all

    // spectral radius: a bound, the user's callback, or the power
    // iteration with the stepper's refresh policy
    bool rho_ok = true;
    bool jacatt_att = jacatt;
    if constexpr (RHO == kRhoConst) {
      sprad = s.rho_const;
      rho_ok = sprad == sprad;
    } else if constexpr (RHO == kRhoFn) {
      sprad = rho(t, kGlobY ? y_glob : y_hi, p);
      rho_ok = sprad == sprad;
    } else {
      if (newspc) {
        float yy = 0.0f, vv = 0.0f;
        for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
          yy += y_hi[l] * y_hi[l];
          vv += V[i] * V[i];
        }
        const float ynrm = sqrtf(g.sum(yy));
        const float vnrm = sqrtf(g.sum(vv));
        const bool both = ynrm != 0.0f && vnrm != 0.0f;
        const bool only_y = ynrm != 0.0f && vnrm == 0.0f;
        const bool only_v = ynrm == 0.0f && vnrm != 0.0f;
        const float dynrm = (both || only_y) ? ynrm * tab::SQRTU
                                             : tab::RHO_UROUND;
        const float vs = dynrm / (vnrm == 0.0f ? 1.0f : vnrm);
        float* v = arg[0];
        float* fv = arg[1];
        for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
          v[i] = both     ? y_hi[l] + V[i] * vs
                 : only_y ? V[i] * tab::ONE_P_SQRTU
                 : only_v ? V[i] * vs
                          : dynrm;
        }
        g.sync();
        float sigma = 0.0f;
        bool done = false;
        int nev = 0;
        sprad = 0.0f;
        for (int k = 0; k < kItMax && !done; ++k) {
          float dd = 0.0f;
          for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
            const float fvi = rhs(t, v, i, p);
            fv[i] = fvi;
            const float df = fvi - f[l];
            dd += df * df;
          }
          const float dfnrm = sqrtf(g.sum(dd));
          nev += 1;
          const float sigma_new = dfnrm / dynrm;
          if (k > 0 && fabsf(sigma_new - sigma) <=
                           fmaxf(sigma_new, small) * 0.01f) {
            sprad = 1.2f * sigma_new;
            done = true;
          } else {
            if (dfnrm != 0.0f) {
              const float scale = dynrm / dfnrm;
              for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
                v[i] = y_hi[l] + (fv[i] - f[l]) * scale;
              }
            } else {
              // degenerate case: the owner of component k mod n flips it
              const int e = k % NTOT;
              if (e >= lo && e < hi && (e - lo) % nthr == rank) v[e] = -v[e];
            }
            g.sync();
          }
          sigma = sigma_new;
        }
        rho_ok = done;
        if (done) {
          for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
            V[i] = v[i] - y_hi[l];
          }
        }
        nfesig += nev;
        jacatt_att = true;
      }
    }

    // the starting step on the first attempt (sommeijer.py:206-216)
    float absh = h_abs;
    if (h_abs < 0.0f) {
      float absh0 = sprad * mse > 1.0f ? 1.0f / sprad : mse;
      absh0 = fmaxf(absh0, tab::SQRTMIN);
      float* a = arg[0];
      for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
        a[i] = y_hi[l] + absh0 * f[l];
      }
      g.sync();
      float acc = 0.0f;
      for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
        const float q = (rhs(t + absh0, a, i, p) - f[l]) /
                        (s.atol + s.rtol * fabsf(y_hi[l]));
        acc += q * q;
      }
      const float est = absh0 * sqrtf(g.sum(acc) / nf);
      absh = 0.1f * absh0 < mse * sqrtf(est)
                 ? fmaxf(0.1f * absh0 / sqrtf(est), tab::SQRTMIN)
                 : mse;
      nfev += 1;
    }

    // stage count and the m cap; a non-finite absh is clamped first
    const float d = fabsf(s.tf - t);
    if (1.1f * absh >= d) absh = d;
    if (!isfinite(absh)) absh = mse;
    const float q = sqrtf(1.54f * absh * sprad + 1.0f);
    const bool hit_cap = q >= static_cast<float>(s.mmax);
    int m = hit_cap ? s.mmax : 1 + (q == q ? static_cast<int>(q) : 0);
    m = min(max(m, 2), s.mmax);
    const float mf = static_cast<float>(m);
    if (hit_cap) absh = (mf * mf - 1.0f) / (1.54f * sprad);
    const float h = s.dir * absh;
    const float hmin = fmaxf(
        tab::SQRTMIN, tab::HMIN_C * (fabsf(t) + absh) * (mf * mf - 1.0f));

    // the stages in deviation form: e_j = y_j - y_n
    Cheb c;
    c.start(m);
    float* em2 = e_a;
    float* em1 = e_b;
    int ab = 0;
    const float hmus0 = h * c.mus0;
    for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
      const float e1 = hmus0 * f[l];
      em2[l] = 0.0f;
      em1[l] = e1;
      arg[0][i] = y_hi[l] + (y_lo[l] + e1);
    }
    // the barrier before each stage as arrive and wait, the stage's
    // coefficients computed in between
    for (int j = 2; j <= m; ++j) {
      float muc, nuc, ajc, mus, th;
      g.arrive();
      c.next(muc, nuc, ajc, mus, th);
      g.wait();
      const float tj = t + h * th;
      const float hmus = h * mus;
      const float* a = arg[ab];
      float* a_next = arg[ab ^ 1];
      for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
        const float fj = rhs(tj, a, i, p);
        const float ej =
            muc * em1[l] + nuc * em2[l] + hmus * (fj - ajc * f[l]);
        em2[l] = ej;
        a_next[i] = y_hi[l] + (y_lo[l] + ej);
      }
      float* tmp = em2;
      em2 = em1;
      em1 = tmp;
      ab ^= 1;
    }
    g.sync();
    // arg[ab] now holds y_k = y_n + e_m

    // f(t + h, y_k) and the embedded error estimate
    const float* yk = arg[ab];
    const float h4 = 0.4f * h;
    float acc = 0.0f;
    for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
      const float fk = rhs(t + h, yk, i, p);
      f_new[l] = fk;
      const float wt = s.atol + s.rtol * fmaxf(fabsf(y_hi[l]), fabsf(yk[i]));
      const float est = -0.8f * em1[l] + h4 * (f[l] + fk);
      const float r = est / wt;
      acc += r * r;
    }
    float err = sqrtf(g.sum(acc) / nf);
    nfev += m;
    const bool bad = !isfinite(err);
    if (bad) err = 10.0f;
    const bool accepted = err < 1.0f && !bad;

    const float cbrt_e = cube_root(fmaxf(err, 1e-30f));
    const float absh_rej = 0.8f * absh / cbrt_e;
    const bool too_small = !accepted && absh_rej < hmin;

    // H220 dead-beat controller (sommeijer.py:253-266)
    float fac;
    if (h_prev == 0.0f) {
      fac = 0.8f < 10.0f * cbrt_e ? 0.8f / cbrt_e : 10.0f;
    } else {
      const float temp1 = 0.8f * absh * cube_root(fmaxf(err_old, 1e-30f));
      const float temp2 =
          fabsf(h_prev) * powf(fmaxf(err, 1e-30f), 2.0f / 3.0f);
      fac = temp1 < 10.0f * temp2 ? temp1 / fmaxf(temp2, 1e-30f) : 10.0f;
    }
    const float absh_acc =
        fmaxf(hmin, fminf(mse, fmaxf(0.1f, fac) * absh));
    const bool is_last = accepted && absh >= d;

    int st = bad ? kOverflow
                 : (too_small ? kTooSmall : (is_last ? kFinished : status));
    if (!rho_ok) st = kRhoFail;
    it += 1;
    if (it >= s.max_steps && st == kRunning) st = kOverflow;
    status = st;

    if (RHO == kRhoPower) {
      // refresh policy after the attempt (steppers/rkc.py:513-517)
      if (accepted) {
        nstsig = (nstsig + 1) % 25;
        newspc = nstsig == 0 && !s.const_jac;
        jacatt = s.const_jac;
      } else {
        newspc = !jacatt_att;
        jacatt = jacatt_att;
      }
    }

    if (accepted) {
      const ds::DS tn = ds::add_f(ds::DS{t, t_lo}, h);
      // the t_eval points the step reaches, from the pending one on: the
      // unclamped cubic Hermite of its end pairs (y, f) and (y_k, f_new)
      if constexpr (tab::SNAP) {
        rk::Pending& pq = the_points(pts...);
        const int q_end = pq.reached(pq.iq, s.dir, is_last ? s.tf : tn.hi);
        for (int q = pq.iq; q < q_end; ++q) {
          const rk::HermiteWeights hw =
              rk::hermite_weights_at(pq.theta(q, t, t_lo, h), h);
          float* r = pq.row(q, member, NTOT);
          for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
            r[i] = rk::hermite_sum(hw, y_hi[l], f[l], yk[i], f_new[l]);
          }
        }
        pq.iq = q_end;
      }
      t = is_last ? s.tf : tn.hi;
      t_lo = is_last ? 0.0f : tn.lo;
      // the double-single y carry advances by the step's deviation
      for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
        const ds::DS yn = ds::add_f(ds::DS{y_hi[l], y_lo[l]}, em1[l]);
        y_hi[l] = yn.hi;
        y_lo[l] = yn.lo;
        if constexpr (kGlobY) y_glob[i] = yn.hi;
      }
      float* tmp = f;
      f = f_new;
      f_new = tmp;
      h_abs = absh_acc;
      h_prev = h;
      err_old = err;
      nstep += 1;
    } else {
      h_abs = absh_rej;
    }
  }

  g.sync();
  for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
    out.y[static_cast<size_t>(member) * NTOT + i] = y_hi[l];
  }
  // the points from the pending one on take the final y
  if constexpr (tab::SNAP) {
    const rk::Pending& pq = the_points(pts...);
    for (int q = pq.iq; q < pq.nq; ++q) {
      float* r = pq.row(q, member, NTOT);
      for (int i = lo + rank, l = l0; i < hi; i += nthr, l += lstep) {
        r[i] = y_hi[l];
      }
    }
  }
  if (lo == 0 && rank == 0) {
    out.status[member] = status;
    out.nsteps[member] = nstep;
    out.nfev[member] = nfev;
    out.nfesig[member] = nfesig;
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "block_group.cuh"

namespace {

namespace cg = cooperative_groups;

// B10 at C = 1: one thread block per member, its arrays in the workspace.
struct MemberBlock : BlockGroup {
  static constexpr bool kLocal = false;
  __device__ int lo() const { return 0; }
  __device__ int hi() const { return NTOT; }
  __device__ void arrive() const { __syncthreads(); }
  __device__ void wait() const {}
};

// B9: the whole cooperative grid on one member; kLocal: each block keeps
// the six elementwise arrays of its threads' elements in its dynamic shared
// memory, K = ceil(NTOT / threads of the grid) slots of blockDim.x floats
// each, so that every thread owns the elements it owns in the global
// placement and sums them in the same order.  The barrier is split: in
// arrive() one thread of each block adds 1 to the generation counter `bar`
// by a release reduction after a __syncthreads (so the block's writes are
// visible before the count), in wait() it spins with acquire loads until
// every block of the grid has arrived, then the block meets at a
// __syncthreads; work on registers goes between the two.  Each block's sum
// goes to its slot of `partials` (two sets of gridDim.x slots, used in
// turn); after the barrier every warp adds the slots lane-strided and
// butterflies them.
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <bool LOCAL>
struct GridGroup {
  static constexpr bool kLocal = LOCAL;
  float* red;
  float* partials;
  unsigned* bar;
  int turn = 0;
  int pturn = 0;
  unsigned target = 0;  // the count of arrivals that ends the next wait
  __device__ int rank() const {
    return blockIdx.x * blockDim.x + threadIdx.x;
  }
  __device__ int size() const { return gridDim.x * blockDim.x; }
  __device__ int lo() const { return 0; }
  __device__ int hi() const { return NTOT; }
  __device__ int local_rank() const { return threadIdx.x; }
  __device__ int local_size() const { return blockDim.x; }
  __device__ int local_len() const {
    return (NTOT + size() - 1) / size() * static_cast<int>(blockDim.x);
  }
  __device__ void arrive() {
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                   :
                   : "l"(bar)
                   : "memory");
    }
    target += gridDim.x;
  }
  __device__ void wait() const {
    if (threadIdx.x == 0) {
      while (static_cast<int>(load_acquire(bar) - target) < 0) {
      }
    }
    __syncthreads();
  }
  __device__ void sync() {
    arrive();
    wait();
  }
  __device__ float sum(float v) {
    const float b = block_sum(v, red, turn);
    float* slots = partials + gridDim.x * pturn;
    pturn ^= 1;
    if (threadIdx.x == 0) slots[blockIdx.x] = b;
    sync();
    float s = 0.0f;
    for (unsigned k = threadIdx.x & 31; k < gridDim.x; k += 32) s += slots[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  }
};

// B10 at C > 1: one CTA of a cluster of C on one member, owning the
// contiguous chunk [lo, hi) with its elementwise arrays in shared memory.
// A sum: the CTA's block_sum, written by thread j into slot `crank` of
// peer j's `parts` (DSMEM; two sets of slots used in turn, so that one
// cluster barrier per sum suffices), then the C slots added in rank order.
constexpr int kMaxCluster = 8;
struct ClusterGroup {
  static constexpr bool kLocal = true;
  float* red;
  float* parts;
  int c;
  int crank;
  int lo_;
  int hi_;
  int turn = 0;
  int pturn = 0;
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ int lo() const { return lo_; }
  __device__ int hi() const { return hi_; }
  __device__ int local_rank() const { return threadIdx.x; }
  __device__ int local_size() const { return blockDim.x; }
  __device__ int local_len() const { return hi_ - lo_; }
  __device__ void sync() const { cg::this_cluster().sync(); }
  __device__ void arrive() const { cg::this_cluster().barrier_arrive(); }
  __device__ void wait() const { cg::this_cluster().barrier_wait(); }
  __device__ float sum(float v) {
    const float b = block_sum(v, red, turn);
    float* slots = parts + kMaxCluster * pturn;
    pturn ^= 1;
    if (static_cast<int>(threadIdx.x) < c) {
      cg::this_cluster().map_shared_rank(slots, threadIdx.x)[crank] = b;
    }
    cg::this_cluster().sync();
    float s = slots[0];
    for (int k = 1; k < c; ++k) s += slots[k];
    return s;
  }
};

// The chunk of each CTA at cluster size c, and its dynamic shared memory.
__host__ __device__ constexpr int cluster_chunk(int c) {
  return (NTOT + c - 1) / c;
}
constexpr int kLocalArrays = 6;
__host__ __device__ constexpr size_t cluster_smem(int c) {
  return static_cast<size_t>(kLocalArrays) * cluster_chunk(c) * sizeof(float);
}

// The kernels take the t_eval points last (Pts: rk::Pending, each thread's
// copy carrying its member's pending index) in a build with tab::SNAP, and
// nothing more without it.
template <int RHO, class... Pts>
__global__ void __launch_bounds__(1024)
    fused_rkc_block_kernel(const float* __restrict__ y0,
                           const float* __restrict__ params, float* work,
                           Solve s, Out out, Pts... pts) {
  __shared__ float red[64];
  MemberBlock g{{red}};
  const int member = blockIdx.x;
  integrate<RHO>(g, y0 + static_cast<size_t>(member) * NTOT,
                 tab::NPAR ? params + member * tab::NPAR : nullptr,
                 work + static_cast<size_t>(member) * kArrays * NTOT,
                 nullptr, s, member, out, pts...);
}

template <int RHO, class... Pts>
__global__ void __launch_bounds__(kClusterThreads)
    fused_rkc_cluster_kernel(const float* __restrict__ y0,
                             const float* __restrict__ params, float* work,
                             Solve s, Out out, Pts... pts) {
  extern __shared__ float sm[];
  __shared__ float red[64];
  __shared__ float parts[2 * kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int member = blockIdx.x / c;
  const int lo = min(crank * cluster_chunk(c), NTOT);
  const int hi = min(lo + cluster_chunk(c), NTOT);
  ClusterGroup g{red, parts, c, crank, lo, hi};
  integrate<RHO>(g, y0 + static_cast<size_t>(member) * NTOT,
                 tab::NPAR ? params + member * tab::NPAR : nullptr,
                 work + static_cast<size_t>(member) * kArrays * NTOT, sm, s,
                 member, out, pts...);
}

template <int RHO, bool LOCAL, class... Pts>
__global__ void __launch_bounds__(kGridThreads)
    fused_rkc_grid_kernel(const float* __restrict__ y0,
                          const float* __restrict__ params, float* work,
                          float* partials, Solve s, Out out, Pts... pts) {
  extern __shared__ float sm[];
  __shared__ float red[64];
  GridGroup<LOCAL> g{red, partials,
                     reinterpret_cast<unsigned*>(partials + 2 * gridDim.x)};
  integrate<RHO>(g, y0, tab::NPAR ? params : nullptr, work,
                 LOCAL ? sm : nullptr, s, 0, out, pts...);
}

template <bool LOCAL, class... Pts>
const void* grid_kernel_of(int rho_mode) {
  if (rho_mode == kRhoConst) {
    return reinterpret_cast<const void*>(
        &fused_rkc_grid_kernel<kRhoConst, LOCAL, Pts...>);
  }
  if (rho_mode == kRhoFn) {
    return reinterpret_cast<const void*>(
        &fused_rkc_grid_kernel<kRhoFn, LOCAL, Pts...>);
  }
  return reinterpret_cast<const void*>(
      &fused_rkc_grid_kernel<kRhoPower, LOCAL, Pts...>);
}

// B9's kernel of this build (with the t_eval points where SNAP, tab::SNAP:
// a build instantiates the kernels of one kind).
template <bool SNAP = tab::SNAP>
const void* grid_kernel(int rho_mode, bool local) {
  if constexpr (SNAP) {
    return local ? grid_kernel_of<true, rk::Pending>(rho_mode)
                 : grid_kernel_of<false, rk::Pending>(rho_mode);
  } else {
    return local ? grid_kernel_of<true>(rho_mode)
                 : grid_kernel_of<false>(rho_mode);
  }
}

// B9's dynamic shared memory in the shared placement on `blocks` blocks of
// `threads`: the six arrays' slots of every thread.
size_t grid_smem(int blocks, int threads) {
  const int per = (NTOT + blocks * threads - 1) / (blocks * threads);
  return static_cast<size_t>(kLocalArrays) * per * threads * sizeof(float);
}

template <class... Pts>
using ClusterKernel = void (*)(const float*, const float*, float*, Solve, Out,
                               Pts...);

template <class... Pts>
ClusterKernel<Pts...> cluster_kernel(int rho_mode) {
  if (rho_mode == kRhoConst) {
    return &fused_rkc_cluster_kernel<kRhoConst, Pts...>;
  }
  if (rho_mode == kRhoFn) return &fused_rkc_cluster_kernel<kRhoFn, Pts...>;
  return &fused_rkc_cluster_kernel<kRhoPower, Pts...>;
}

// The launch configuration of B10 at cluster size c, after raising the
// kernel's dynamic shared memory limit to what it needs.
template <class Kernel>
cudaError_t cluster_config(Kernel k, int members, int c, int threads,
                           cudaStream_t st, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const size_t bytes = cluster_smem(c);
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(members * c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// fused_rkc_cluster_capacity (below) for the cluster kernel k.
template <class Kernel>
int cluster_capacity(Kernel k, int threads, int c, int* clusters,
                     int* bytes) {
  int dev = 0;
  int optin = 0;
  cudaFuncAttributes fa;
  *clusters = 0;
  *bytes = static_cast<int>(cluster_smem(c));
  if (c < 2 || c > kMaxCluster || threads > kClusterThreads) return 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*bytes + static_cast<int>(fa.sharedSizeBytes) > optin) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = cluster_config(k, c, c, threads, nullptr, cfg, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveClusters(clusters, k, &cfg);
  return static_cast<int>(e);
}

// fused_rkc_cluster_capacity for the cluster kernel of this build (with the
// t_eval points where SNAP, tab::SNAP).
template <bool SNAP = tab::SNAP>
int build_cluster_capacity(int rho_mode, int threads, int c, int* clusters,
                           int* bytes) {
  if constexpr (SNAP) {
    return cluster_capacity(cluster_kernel<rk::Pending>(rho_mode), threads,
                            c, clusters, bytes);
  } else {
    return cluster_capacity(cluster_kernel<>(rho_mode), threads, c, clusters,
                            bytes);
  }
}

// The launch of B9 or B10 (as fused_rkc_launch describes) with the
// kernels' last arguments `pts` (the t_eval points in a build with
// tab::SNAP, none without).
template <class... Pts>
int launch_rkc(int grid, int rho_mode, const float* y0f, const float* pf,
               float* wf, float* part, int members, Solve s, Out out,
               int threads, int blocks, int cluster, cudaStream_t st,
               Pts... pts) {
  if (grid) {
    const bool local = grid == 2;
    const void* k = grid_kernel(rho_mode, local);
    const size_t bytes = local ? grid_smem(blocks, threads) : 0;
    cudaError_t e = cudaMemsetAsync(part + 2 * blocks, 0, sizeof(unsigned),
                                    st);
    if (e == cudaSuccess && local) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    void* args[] = {&y0f, &pf, &wf, &part, &s, &out, &pts...};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        k, dim3(blocks), dim3(threads), args, bytes, st));
  }
  if (cluster > 1) {
    if (cluster > kMaxCluster || threads > kClusterThreads) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const ClusterKernel<Pts...> k = cluster_kernel<Pts...>(rho_mode);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const cudaError_t e =
        cluster_config(k, members, cluster, threads, st, cfg, attr);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(
        cudaLaunchKernelEx(&cfg, k, y0f, pf, wf, s, out, pts...));
  }
  if (rho_mode == kRhoConst) {
    fused_rkc_block_kernel<kRhoConst, Pts...><<<members, threads, 0, st>>>(
        y0f, pf, wf, s, out, pts...);
  } else if (rho_mode == kRhoFn) {
    fused_rkc_block_kernel<kRhoFn, Pts...><<<members, threads, 0, st>>>(
        y0f, pf, wf, s, out, pts...);
  } else {
    fused_rkc_block_kernel<kRhoPower, Pts...><<<members, threads, 0, st>>>(
        y0f, pf, wf, s, out, pts...);
  }
  return static_cast<int>(cudaGetLastError());
}

// fused_rkc_launch's arguments to launch_rkc, with the t_eval points *pts
// in a build with them (SNAP, tab::SNAP: a build instantiates the kernels
// of one kind).
template <bool SNAP = tab::SNAP>
int launch_build(int grid, int rho_mode, const void* y0, const void* params,
                 void* y_out, void* status, void* nsteps, void* nfev,
                 void* nfesig, void* work, void* partials, int members,
                 const Solve& s, int threads, int blocks, int cluster,
                 void* stream, const rk::Pending* pts) {
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nsteps), static_cast<int*>(nfev),
                static_cast<int*>(nfesig)};
  const float* y0f = static_cast<const float*>(y0);
  const float* pf = static_cast<const float*>(params);
  float* wf = static_cast<float*>(work);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (SNAP) {
    return launch_rkc(grid, rho_mode, y0f, pf, wf, part, members, s, out,
                      threads, blocks, cluster, st, *pts);
  } else {
    return launch_rkc(grid, rho_mode, y0f, pf, wf, part, members, s, out,
                      threads, blocks, cluster, st);
  }
}

}  // namespace

// The largest grid whose blocks of `threads` threads are all resident at
// once in B9's global placement (the blocks one SM holds times the SM
// count), written to *blocks; returns the CUDA error code.
extern "C" int fused_rkc_grid_capacity(int rho_mode, int threads,
                                       int* blocks) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grid_kernel(rho_mode, false), threads, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(cudaGetLastError());
}

// B9's shared placement on a grid of `blocks` blocks of `threads`: the
// dynamic shared memory a block needs (*bytes) and whether the card holds
// all of the grid's blocks at once with it (*fits: 0 where it exceeds the
// card's opt-in shared memory); returns the CUDA error code.
extern "C" int fused_rkc_grid_smem(int rho_mode, int threads, int blocks,
                                   int* bytes, int* fits) {
  int dev = 0;
  int sms = 0;
  int optin = 0;
  int per_sm = 0;
  cudaFuncAttributes fa;
  const void* k = grid_kernel(rho_mode, true);
  *fits = 0;
  *bytes = static_cast<int>(grid_smem(blocks, threads));
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*bytes + static_cast<int>(fa.sharedSizeBytes) > optin) return 0;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                    *bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *fits = per_sm * sms >= blocks ? 1 : 0;
  return 0;
}

// B10 at cluster size c (2, 4 or 8) with CTAs of `threads`: the dynamic
// shared memory a CTA needs (*bytes) and the clusters resident at once
// (*clusters, cudaOccupancyMaxActiveClusters; 0 where the chunk's arrays do
// not fit the card's opt-in shared memory); returns the CUDA error code.
extern "C" int fused_rkc_cluster_capacity(int rho_mode, int threads, int c,
                                          int* clusters, int* bytes) {
  return build_cluster_capacity(rho_mode, threads, c, clusters, bytes);
}

// Launches B9 (one member on a cooperative grid of `blocks` blocks, its
// six elementwise arrays in global memory at grid = 1 or in the blocks'
// shared memory at grid = 2) or B10 (grid = 0: one block per member at
// cluster = 1, else a cluster of `cluster` blocks per member) on the
// caller's stream and returns the CUDA error code; the wrapper raises on
// anything but 0, and a refused cooperative or cluster launch is such an
// error.  `work` holds kArrays * NTOT floats per member, `partials`
// 2 * blocks + 1 floats (B9 only: the blocks' sums and the barrier's
// counter, which the launch sets to 0 first).  A build with the snapshots
// refuses (cudaErrorInvalidValue): it takes fused_rkc_snap_launch.
extern "C" int fused_rkc_launch(int grid, int rho_mode, const void* y0,
                                const void* params, void* y_out, void* status,
                                void* nsteps, void* nfev, void* nfesig,
                                void* work, void* partials, int members,
                                float t0, float tf, float dir, float rtol,
                                float atol, float h0, float rho_const,
                                float max_step, int mmax, int max_steps,
                                int const_jac, int threads, int blocks,
                                int cluster, void* stream) {
  if (tab::SNAP) return static_cast<int>(cudaErrorInvalidValue);
  return launch_build(grid, rho_mode, y0, params, y_out, status, nsteps, nfev,
                      nfesig, work, partials, members,
                      Solve{t0, tf, dir, rtol, atol, h0, rho_const, max_step,
                            mmax, max_steps, const_jac},
                      threads, blocks, cluster, stream, nullptr);
}

// The launch of a build with the t_eval snapshots (tab::SNAP): as
// fused_rkc_launch, and each member writes the rows of the nq points tq
// (float32, in t_eval's order) to y_eval (members, nq, NTOT) by JAX's
// pending index (snapshot.cuh: Pending).  cudaErrorInvalidValue for a
// build without tab::SNAP or nq < 1.
extern "C" int fused_rkc_snap_launch(
    int grid, int rho_mode, const void* y0, const void* params, void* y_out,
    void* status, void* nsteps, void* nfev, void* nfesig, void* work,
    void* partials, int members, float t0, float tf, float dir, float rtol,
    float atol, float h0, float rho_const, float max_step, int mmax,
    int max_steps, int const_jac, int threads, int blocks, int cluster,
    const void* tq, void* y_eval, int nq, void* stream) {
  if (!tab::SNAP || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const rk::Pending pts{static_cast<const float*>(tq),
                        static_cast<float*>(y_eval), nq};
  return launch_build(grid, rho_mode, y0, params, y_out, status, nsteps, nfev,
                      nfesig, work, partials, members,
                      Solve{t0, tf, dir, rtol, atol, h0, rho_const, max_step,
                            mmax, max_steps, const_jac},
                      threads, blocks, cluster, stream, &pts);
}
