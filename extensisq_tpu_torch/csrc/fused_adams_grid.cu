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
// The per-member scalars (t, h, the order k, the step count ns, the
// coefficient vectors psi/alpha/beta/sig/v/w/g of adams_common.cuh's
// Coef<KM>) are computed by every thread from identical inputs, so every
// thread takes the same branches, as in fused_rk_grid.cu.  Each norm is a
// group sum in a fixed order whose result every thread holds
// (block_group.cuh).  Per attempt: one barrier between writing the
// predicted state and evaluating f there, the three norms of the error
// ladder (orders k - 2, k - 1, k); on acceptance one barrier before f at
// the corrected state, one reduction that counts its non-finite elements
// and the norm at order k + 1.
//
// What bounds it on the H100: per attempt an element costs two RHS
// evaluations (a stencil of a few flops on shared memory) and ~6 (KM + 2)
// flops on its phi column, and the attempt costs 6 barriers and the
// coefficient recurrences, O(KM^2) dependent selects that every thread
// repeats.  At N = 256 that is latency of barriers, reductions and the
// scalar chain, not the card's flop or byte rate; members run in parallel
// on the SMs (32 members use 32 of 132).
//
// The generated header fused_adams_grid_config.cuh provides
//   namespace tab { G = grid::Grid<N>, KM, N, INV_N, FOURU_T, LAND_TOL,
//                   GSTR(i), IQQ(i), TWO(i) }
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

#include "grid_common.cuh"
#include "fused_adams_grid_config.cuh"
#include "adams_common.cuh"
#include "rk_common.cuh"

namespace {

using tab::KM;
using tab::N;
using adams::clip;

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
constexpr int kFloats = kPhi + R * N;

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

// RMS over the member of the per-thread partial sums of squares, in the
// kernel's order.
template <class Group>
__device__ __forceinline__ float member_norm(Group& g, float part) {
  return sqrtf(g.sum(part) * tab::INV_N);
}

// The whole integration of one member by the group g (rank(), size(),
// sync() and sum(x), a reduction whose result every thread holds).  sm is
// the member's shared memory (kFloats); y0, yp0 its initial state and
// f(t0, y0), h0 and nfev0 its starting step and evaluation count from the
// float32 stepper's init, as in the JAX package.
template <class Group>
__device__ void integrate(Group& g, float* sm, const float* __restrict__ y0,
                          const float* __restrict__ yp0, float h0, int nfev0,
                          const Launch& L, int member, const Out& out) {
  const int r0 = g.rank();
  const int nt = g.size();
  float* Y = sm + kY;
  float* Yp = sm + kYp;
  float* P = sm + kP;
  float* Yc = sm + kYc;
  float* Fc = sm + kFc;
  float* T4 = sm + kT4;
  float* Wt = sm + kWt;
  float* phi = sm + kPhi;

  // the starting state (steppers/adams.py:init); one reduction counts the
  // elements that are not finite
  float bad = 0.0f;
  for (int i = r0; i < N; i += nt) {
    Y[i] = y0[i];
    Yp[i] = yp0[i];
    phi[i] = Yp[i];
#pragma unroll
    for (int r = 1; r < R; ++r) phi[r * N + i] = 0.0f;
    bad += (isfinite(Y[i]) && isfinite(Yp[i])) ? 0.0f : 1.0f;
  }
  const bool start_ok = g.sum(bad) == 0.0f && isfinite(h0);

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
  int status = start_ok ? kRunning : kOverflow;
  int it = 0;

  while (status == kRunning && it < L.max_steps) {
    const float tc = t + t_lo;  // double-single time carry
    const float min_step = tab::FOURU_T * fabsf(tc);
    const float d = (L.tf - t) - t_lo;  // remaining interval in DS
    it += 1;
    if (fabsf(d) <= min_step) {
      // near-end linear extrapolation; counts as a step, evaluates nothing
      for (int i = r0; i < N; i += nt) Y[i] = Y[i] + d * Yp[i];
      t = L.tf;
      t_lo = 0.0f;
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
    adams::coefficients<KM>(c, h_in, k, ns2, kprev, kold);
    const int km1 = k - 1;
    const int km2 = k - 2;

    // block 2: predict (own elements); phi[r] *= beta[r] for r in [ns, k),
    // phi[k + 1] = phi[k], phi[k] = 0, p = h sum_{r < k} g[r] phi[r] + y,
    // then the reverse cumulative sum over rows < k
    for (int i = r0; i < N; i += nt) {
      float col[R];
#pragma unroll
      for (int r = 0; r < R; ++r) col[r] = phi[r * N + i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= ns2 && r < k) col[r] = col[r] * c.beta[r < KM ? r : KM - 1];
      }
      adams::put(col, k + 1, adams::take(col, k));
      adams::put(col, k, 0.0f);
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r <= KM; ++r) {
        const float gw = r < k ? c.g[r] : 0.0f;
        acc = acc + gw * col[r];
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
      const float fp = rhs(x, P, i, nullptr);
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
    const float absh = fabsf(h_in);
    float erk = absh * member_norm(g, s0);
    const float erkm1 = absh * member_norm(g, s1) *
                        adams::take(c.sig, clip(km1, 0, KM)) *
                        ctake<13>(Gstr{}, clip(km2, 0, 12));
    const float erkm2 = absh * member_norm(g, s2) *
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
      // block 4: correct (own elements), then f at the corrected state
      const float g_k = adams::take(c.g, clip(k, 0, KM));
      for (int i = r0; i < N; i += nt) Yc[i] = h_in * g_k * T4[i] + P[i];
      g.sync();
      float nonfinite = 0.0f;
      for (int i = r0; i < N; i += nt) {
        Fc[i] = rhs(x, Yc, i, nullptr);
        nonfinite += (isfinite(Yc[i]) && isfinite(Fc[i])) ? 0.0f : 1.0f;
      }
      nfev += 1;
      if (g.sum(nonfinite) != 0.0f) {
        status = kOverflow;
        break;
      }

      // phi update and the norm at order k + 1
      float sq = 0.0f;
      for (int i = r0; i < N; i += nt) {
        const float pkn = Fc[i] - phi[i];
        phi[k * N + i] = pkn;
        phi[(k + 1) * N + i] = pkn - phi[(k + 1) * N + i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < k) phi[r * N + i] = phi[r * N + i] + pkn;
        }
        const float q = phi[(k + 1) * N + i] / Wt[i];
        sq = sq + q * q;
      }
      const float erkp1 =
          ctake<13>(Gstr{}, clip(k, 0, 12)) * absh * member_norm(g, sq);

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
      t = is_last ? L.tf : t_adv;
      t_lo = is_last ? 0.0f : t_lo_adv;
      for (int i = r0; i < N; i += nt) {
        Y[i] = Yc[i];
        Yp[i] = Fc[i];
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
      nsteps += 1;
      if (is_last) status = kFinished;
    } else {
      // block 3: failure restore (shampine.py:369-398), own elements
      for (int i = r0; i < N; i += nt) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < k) {
            const float b = c.beta[r < KM ? r : KM - 1];
            const float bsafe = b == 0.0f ? 1.0f : b;
            const float up = phi[(r + 1 < R ? r + 1 : R - 1) * N + i];
            phi[r * N + i] = (phi[r * N + i] - up) / bsafe;
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

  g.sync();
  for (int i = r0; i < N; i += nt) {
    out.y[static_cast<size_t>(member) * N + i] = Y[i];
  }
  if (r0 == 0) {
    out.status[member] = status;
    out.nsteps[member] = nsteps;
    out.nfev[member] = nfev;
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "block_group.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
    fused_adams_grid_kernel(const float* __restrict__ y0,
                            const float* __restrict__ yp0,
                            const float* __restrict__ h0,
                            const int* __restrict__ nfev0, Launch L,
                            Out out) {
  extern __shared__ float sm[];
  __shared__ float red[64];
  BlockGroup g{red};
  const int m = blockIdx.x;
  const size_t off = static_cast<size_t>(m) * N;
  integrate(g, sm, y0 + off, yp0 + off, h0[m], nfev0[m], L, m, out);
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
// shared memory (above 48 KB after cudaFuncSetAttribute), and returns the
// CUDA error code; the wrapper raises on anything but 0.  yp0, h0 and nfev0
// are each member's f(t0, y0), starting step and evaluation count from the
// float32 stepper's init.
extern "C" int fused_adams_grid_launch(const void* y0, const void* yp0,
                                       const void* h0, const void* nfev0,
                                       void* y_out, void* status, void* nstep,
                                       void* nfev, int members, float t0,
                                       float tf, float dir, float rtol,
                                       float atol, float max_step,
                                       int max_steps, int threads,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  const int bytes = static_cast<int>(kFloats * sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_adams_grid_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_adams_grid_kernel<<<members, threads, bytes, st>>>(
      static_cast<const float*>(y0), static_cast<const float*>(yp0),
      static_cast<const float*>(h0), static_cast<const int*>(nfev0), L, out);
  return static_cast<int>(cudaGetLastError());
}
