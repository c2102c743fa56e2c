// Fused adaptive explicit Runge-Kutta and Runge-Kutta-Nystrom ensembles of
// mid-size systems for Hopper (sm_90a): one thread block per member.
//
// Replaces the two Pallas kernels of the JAX package's mid-size layout,
// which run the loops of the small-system kernels with the state across
// lanes: extensisq_tpu/ops/fused_erk_grid.py:solve_fused_erk_grid (B4, the
// loop of B1) and extensisq_tpu/ops/fused_rkn_grid.py:solve_fused_rkn_grid
// (B6, the loop of B5).  One device body, integrate<COMP, Group>, runs both;
// the family (ERK stages, or RKN h^2 A / h Ap stages on accelerations) comes
// from the generated header.  Its plain PyTorch versions are
// ops/fused_erk_grid.py:fused_erk_grid_reference and
// ops/fused_rkn_grid.py:fused_rkn_grid_reference, which run the loops of B1
// and B5 on the same members; the two take the same steps up to round-off.
//
// Design.  A member's state ([u | v] for RKN), its lo carry, the stage rows
// K[0..S] (K[0] = f), two stage-argument buffers and the attempt's lo carry
// live in shared memory: NF + (S + 1) N + 4 NF floats, with N the length of
// a stage row and NF = N (ERK) or 2N (RKN); Fi5N at N = 256 takes 17 KB.
// Element i belongs to the thread of rank i mod (block size), which computes
// its stage sums from its own entries of K.  A stage writes its argument,
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
// What bounds it on the H100: per stage an element costs one RHS (a stencil
// of a few flops, loads from shared memory) and ~2 S flops of stage sums,
// and the stage costs one __syncthreads; an attempt adds the error norm's
// reduction.  At N = 256 with one element per thread the work between
// barriers is tens of cycles, so an attempt is bound by barrier and
// reduction latency, not by the card's flop or byte rate, and members run
// in parallel on the SMs: 64 members use 64 of the 132 SMs, 1024 members
// keep several blocks on every SM.
//
// The generated header fused_rk_grid_config.cuh provides
//   namespace tab { G = grid::Grid<...>, N, RKN, S, FSAL, MORDER, the weight
//                   accessors A, AP, B, BP, C, E, EP, controller and start
//                   constants }
//   __device__ float rhs(float t, const float* y, int i, const float* p);
//   __device__ float acc(float t, const float* u, const float* v, int i,
//                        const float* p);
// (one of the two a stub); neighbours come from tab::G::rolled.
//
// Numerics as in fused_erk.cu and fused_rkn.cu: the compensated helpers
// round every operation on its own (__f*_rn), elsewhere nvcc may contract;
// no fast math; max_steps counts attempts.

#include <cuda_runtime.h>
#include <math.h>

#include "grid_common.cuh"
#include "fused_rk_grid_config.cuh"
#include "rk_common.cuh"
#include "rk_control.cuh"
#include "rk_rows.cuh"

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
constexpr int kFloats = kYloNew + NF;
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

using rk::RowA;
using rk::RowAp;
using rk::RowB;
using rk::RowBp;
using rk::RowE;
using rk::RowEp;

// Column i of the stage rows, indexed as the shared sums index a one-state
// member: col[j][0] is K[j][i].
struct Column {
  const float* k;
  int i;
  struct Entry {
    const float* p;
    __device__ float operator[](int) const { return *p; }
  };
  __device__ Entry operator[](int j) const { return Entry{k + j * N + i}; }
};

template <class W, int LEN>
__device__ __forceinline__ float wsum(const float* K, int i) {
  float a[1];
  rk::wsum<W, LEN>(a, Column{K, i});
  return a[0];
}

// (sum, compensation) of one column, as the JAX _comp_wsum
template <class W, int LEN>
__device__ __forceinline__ void comp_wsum(const float* K, int i, float& s,
                                          float& c) {
  float a[1], b[1];
  rk::comp_wsum<W, LEN>(a, b, Column{K, i});
  s = a[0];
  c = b[0];
}

// The stage row entry i at (t, Y): the RHS, or the acceleration of the
// positions Y[0..N) and velocities Y[N..2N).
__device__ __forceinline__ float stage_f(float t, const float* Y, int i) {
  if constexpr (RKN) {
    return acc(t, Y, Y + N, i, nullptr);
  } else {
    return rhs(t, Y, i, nullptr);
  }
}

// Element j of the first-order derivative at (t, Y): [v, acc] for RKN.
__device__ __forceinline__ float deriv(float t, const float* Y, int j) {
  if constexpr (RKN) {
    return j < N ? Y[N + j] : acc(t, Y, Y + N, j - N, nullptr);
  } else {
    return rhs(t, Y, j, nullptr);
  }
}

// Watts' starting step for one member, unsigned: hstart.cuh's algorithm on
// the group, with its norms and minimum as group reductions.  y is the
// state (NF, in shared memory), w six scratch rows of NF whose first holds
// f(a, y).  Costs 1 + min(NF + 1, 3) evaluations of the RHS.
template <class Group>
__device__ float hstart(Group& g, float a, float b, const float* y, float* w,
                        float rtol, float atol) {
  constexpr float kBig = tab::HS_BIG;
  constexpr float kRelper = tab::HS_RELPER;
  const int r = g.rank();
  const int nt = g.size();
  const float* F = w;
  float* SF = w + NF;
  float* PR = w + 2 * NF;   // the probe point, read by the RHS
  float* YP = w + 3 * NF;
  float* DF = w + 4 * NF;
  float* SPY = w + 5 * NF;
  auto rms = [&](const float* x) {
    float s = 0.0f;
    for (int j = r; j < NF; j += nt) s += x[j] * x[j];
    return sqrtf(g.sum(s) / static_cast<float>(NF));
  };

  const float dx = b - a;
  const float absdx = fabsf(dx);
  const float sdx = dx >= 0.0f ? 1.0f : -1.0f;

  // bound on d f / d t
  float da = sdx * fmaxf(fminf(kRelper * fabsf(a), absdx),
                         tab::HS_T_FLOOR * fabsf(a));
  if (da == 0.0f) da = kRelper * dx;
  for (int j = r; j < NF; j += nt) {
    SF[j] = deriv(a + da, y, j);
    YP[j] = SF[j] - F[j];
  }
  float delf = rms(YP);
  const float dfdxb = delf < kBig * fabsf(da) ? delf / fabsf(da) : kBig;
  float fbnd = rms(SF);

  // local Lipschitz constant from min(NF + 1, 3) probes
  float dely = kRelper * rms(y);
  if (dely == 0.0f) dely = kRelper;
  dely = dely * sdx;
  delf = rms(F);
  fbnd = fmaxf(fbnd, delf);

  const bool have_slope = delf != 0.0f;
  for (int j = r; j < NF; j += nt) {
    SPY[j] = have_slope ? F[j] : 0.0f;
    YP[j] = have_slope ? F[j] : 1.0f;
  }
  if (!have_slope) delf = 1.0f;  // rms of a vector of ones

  float dfdub = 0.0f;
  bool done = false;
  constexpr int kProbes = NF + 1 < 3 ? NF + 1 : 3;
  for (int p = 1; p <= kProbes; ++p) {
    const float step = dely / (delf == 0.0f ? 1.0f : delf);
    for (int j = r; j < NF; j += nt) PR[j] = y[j] + step * YP[j];
    g.sync();
    const float* base = p == 2 ? SF : F;
    const float tp = p == 2 ? a + da : a;
    for (int j = r; j < NF; j += nt) {
      YP[j] = deriv(tp, PR, j);
      DF[j] = YP[j] - base[j];
    }
    const float nyp = rms(YP);
    if (!done) fbnd = fmaxf(fbnd, nyp);
    delf = rms(DF);
    const bool overflow = delf >= kBig * fabsf(dely);
    if (!done) dfdub = overflow ? kBig : fmaxf(dfdub, delf / fabsf(dely));
    done = done || overflow;
    if (p == kProbes) break;

    // next perturbation vector, signs matched to local slopes
    if (delf == 0.0f) delf = 1.0f;
    for (int j = r; j < NF; j += nt) {
      const float dy = p == 2 ? (y[j] != 0.0f ? y[j] : dely / kRelper)
                              : (DF[j] != 0.0f ? DF[j] : delf);
      if (SPY[j] == 0.0f) SPY[j] = YP[j];
      YP[j] = SPY[j] != 0.0f ? fabsf(dy) * (SPY[j] >= 0.0f ? 1.0f : -1.0f)
                             : dy;
    }
    delf = rms(YP);
  }

  // second-derivative bound and tolerance midpoint
  const float ydpb = dfdxb + dfdub * fbnd;
  float tsum = 0.0f;
  float tmin = INFINITY;
  for (int j = r; j < NF; j += nt) {
    const float te = log10f(atol + rtol * fabsf(y[j]));
    tsum += te;
    tmin = fminf(tmin, te);
  }
  const float tolsum = g.sum(tsum);
  const float tolmin = fminf(g.min(tmin), kBig);
  const float tolp = powf(
      10.0f, 0.5f * (tolsum / static_cast<float>(NF) + tolmin) /
                 static_cast<float>(tab::MORDER + 1));

  float h = absdx;
  const float srydpb = sqrtf(0.5f * fmaxf(ydpb, 0.0f));
  if (ydpb == 0.0f && fbnd == 0.0f) {
    if (tolp < 1.0f) h = absdx * tolp;
  } else if (ydpb == 0.0f) {
    if (tolp < fbnd * absdx) h = tolp / fbnd;
  } else if (tolp < srydpb * absdx) {
    h = tolp / srydpb;
  }
  if (dfdub != 0.0f) h = fminf(h, 1.0f / dfdub);
  h = fmaxf(h, tab::HS_T_FLOOR * fabsf(a));
  if (h == 0.0f) h = tab::HS_SMALL * fabsf(b);
  return h;
}

// Stages I..S-1 of one attempt of the group: stage I writes its argument
// into arg[b], takes the barrier and evaluates K[I]; b then flips.
template <bool COMP, int I, class Group>
__device__ __forceinline__ void stages(Group& g, float t, float h, float hh,
                                       const float* Y, const float* Ylo,
                                       float* K, float* const (&arg)[2],
                                       int& b) {
  if constexpr (I < S) {
    const int r = g.rank();
    const int nt = g.size();
    float* a = arg[b];
    constexpr float c = tab::C(I);
    const float ch = c * h;
    for (int i = r; i < N; i += nt) {
      if constexpr (RKN) {
        float du = hh * wsum<RowA<I>, I>(K, i) + ch * Y[N + i];
        float dv = h * wsum<RowAp<I>, I>(K, i);
        if constexpr (COMP) {
          du = du + Ylo[i];
          dv = dv + Ylo[N + i];
        }
        a[i] = Y[i] + du;
        a[N + i] = Y[N + i] + dv;
      } else {
        const float dy = h * wsum<RowA<I>, I>(K, i);
        a[i] = COMP ? Y[i] + (dy + Ylo[i]) : Y[i] + dy;
      }
    }
    g.sync();
    for (int i = r; i < N; i += nt) K[I * N + i] = stage_f(t + ch, a, i);
    b ^= 1;
    stages<COMP, I + 1>(g, t, h, hh, Y, Ylo, K, arg, b);
  }
}

// The whole integration of one member by the group g (rank(), size(),
// sync(), sum(x) and min(x): reductions whose result every thread holds).
// sm is the member's shared memory (kFloats), y0 its initial state.
template <bool COMP, class Group>
__device__ void integrate(Group& g, float* sm, const float* __restrict__ y0,
                          const Launch& L, int member, const Out& out) {
  const int r = g.rank();
  const int nt = g.size();
  float* Y = sm + kY;
  float* K = sm + kK;
  float* Ylo = sm + kYlo;
  float* const arg[2] = {sm + kArg, sm + kArg + NF};
  float* YloNew = sm + kYloNew;

  for (int j = r; j < NF; j += nt) Y[j] = y0[j];
  g.sync();
  float t = L.t0;
  for (int i = r; i < N; i += nt) K[i] = stage_f(t, Y, i);
  rk::StepControl ctl{L.h0};
  int nfev = 1;
  if (L.use_hstart) {
    float* w = K + N;
    g.sync();  // K[0] complete
    for (int j = r; j < NF; j += nt) {
      w[j] = RKN ? (j < N ? Y[N + j] : K[j - N]) : K[j];
    }
    // max_step is +inf when the caller gave none
    const float bq = t + L.dir * fminf(fabsf(L.tf - t), L.max_step);
    ctl.h_abs = fabsf(hstart(g, t, bq, Y, w, L.rtol, L.atol));
    nfev = 2 + (NF + 1 < 3 ? NF + 1 : 3);
  }
  for (int j = r; j < NF; j += nt) Ylo[j] = 0.0f;

  float t_lo = 0.0f;
  int status = kRunning;
  int nstep = 0;
  int it = 0;

  while (status == kRunning) {
    g.sync();  // the last attempt's commits and endpoint reads are done

    float d;
    bool too_small;
    ctl.prepare(t, L.tf, L.max_step, d, too_small);
    const float h = ctl.h_abs * L.dir;
    const float hh = h * h;

    int b = 0;
    stages<COMP, 1>(g, t, h, hh, Y, Ylo, K, arg, b);

    // the solution into arg[b]; element i carries u[i] and v[i] for RKN
    float* Yn = arg[b];
    for (int i = r; i < N; i += nt) {
      if constexpr (RKN) {
        if constexpr (COMP) {
          float bs, bc, ps, pc, hi, l1, l2;
          comp_wsum<RowB, S>(K, i, bs, bc);
          comp_wsum<RowBp, S>(K, i, ps, pc);
          rk::df_add(Y[i], Ylo[i], __fmul_rn(h, Y[N + i]), hi, l1);
          rk::two_sum(hi, __fadd_rn(l1, __fmul_rn(hh, bs)), hi, l2);
          rk::two_sum(hi, __fadd_rn(l2, __fmul_rn(hh, bc)), Yn[i],
                      YloNew[i]);
          rk::df_add(Y[N + i], Ylo[N + i], __fmul_rn(h, ps), hi, l1);
          rk::two_sum(hi, __fadd_rn(l1, __fmul_rn(h, pc)), Yn[N + i],
                      YloNew[N + i]);
        } else {
          Yn[i] = Y[i] + h * Y[N + i] + hh * wsum<RowB, S>(K, i);
          Yn[N + i] = Y[N + i] + h * wsum<RowBp, S>(K, i);
        }
      } else {
        if constexpr (COMP) {
          float bs, bc, hi, lo1;
          comp_wsum<RowB, S>(K, i, bs, bc);
          rk::df_add(Y[i], Ylo[i], __fmul_rn(h, bs), hi, lo1);
          rk::two_sum(hi, __fadd_rn(lo1, __fmul_rn(h, bc)), Yn[i],
                      YloNew[i]);
        } else {
          Yn[i] = Y[i] + h * wsum<RowB, S>(K, i);
        }
      }
    }
    if constexpr (tab::FSAL) {
      g.sync();
      for (int i = r; i < N; i += nt) K[S * N + i] = stage_f(t + h, Yn, i);
    }

    // the error norm over NF; a non-finite element adds +inf
    float sq = 0.0f;
    for (int i = r; i < N; i += nt) {
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
    }
    const float err_norm = sqrtf(g.sum(sq) / static_cast<float>(NF));
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

    nfev += tab::FSAL ? S : S - 1;
    if (accepted) {
      // each thread commits the elements it computed
      for (int i = r; i < N; i += nt) {
        Y[i] = Yn[i];
        if constexpr (RKN) Y[N + i] = Yn[N + i];
        if constexpr (COMP) {
          Ylo[i] = YloNew[i];
          if constexpr (RKN) Ylo[N + i] = YloNew[N + i];
        }
        // a non-FSAL pair evaluates the endpoint of accepted steps only
        K[i] = tab::FSAL ? K[S * N + i] : stage_f(t_new, Yn, i);
      }
      if constexpr (!tab::FSAL) nfev += 1;
      t = t_new;
      t_lo = t_lo_new;
      nstep += 1;
    }

    // step cap: loop iterations, accepted plus rejected
    it += 1;
    if (it >= L.max_steps && status == kRunning) status = kOverflow;
    ctl.end(accepted, status == kRunning);
  }

  g.sync();
  for (int j = r; j < NF; j += nt) {
    out.y[static_cast<size_t>(member) * NF + j] = Y[j];
  }
  if (r == 0) {
    out.status[member] = status;
    out.nsteps[member] = nstep;
    out.nfev[member] = nfev;
  }
}

}  // namespace

// ---- CUDA groups, kernels and launch ----
#include "block_group.cuh"

namespace {

template <bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
    fused_rk_grid_kernel(const float* __restrict__ y0, Launch L, Out out) {
  extern __shared__ float sm[];
  __shared__ float red[64];
  BlockGroup g{red};
  const int member = blockIdx.x;
  integrate<COMP>(g, sm, y0 + static_cast<size_t>(member) * NF, L, member,
                  out);
}

}  // namespace

// The shared memory one member needs and the most a block may have on this
// card, in bytes; returns the CUDA error code.
extern "C" int fused_rk_grid_smem(int* need, int* limit) {
  int dev = 0;
  cudaGetDevice(&dev);
  *need = static_cast<int>(kFloats * sizeof(float));
  cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(cudaGetLastError());
}

// Launches one block of `threads` (a multiple of 32, at most kMaxThreads)
// per member on the caller's stream, with the member's rows as dynamic
// shared memory (above 48 KB after cudaFuncSetAttribute), and returns the
// CUDA error code; the wrapper raises on anything but 0.
extern "C" int fused_rk_grid_launch(const void* y0, void* y_out, void* status,
                                    void* nstep, void* nfev, int members,
                                    float t0, float tf, float dir, float rtol,
                                    float atol, float h0, int use_hstart,
                                    float max_step, int max_steps,
                                    int compensated, int threads,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch L{t0, tf, dir, rtol, atol, h0, use_hstart, max_step,
                 max_steps};
  const Out out{static_cast<float*>(y_out), static_cast<int*>(status),
                static_cast<int*>(nstep), static_cast<int*>(nfev)};
  const float* y0f = static_cast<const float*>(y0);
  const int bytes = static_cast<int>(kFloats * sizeof(float));
  void (*kernel)(const float*, Launch, Out) =
      compensated ? fused_rk_grid_kernel<true> : fused_rk_grid_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<members, threads, bytes, st>>>(y0f, L, out);
  return static_cast<int>(cudaGetLastError());
}
