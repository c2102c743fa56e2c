// What the small explicit kernels B1 (fused_erk.cu) and B5 (fused_rkn.cu)
// share besides their step control (rk_control.cuh): the launch's scalars
// and outputs, the one-lane group, the split of an attempt's same-code work
// over a group of G lanes that all run one member, and the probe build's
// section clocks.
//
// Every lane of a group holds the member's whole state and computes every
// stage, sum and scalar from identical inputs, so the group takes every
// branch together.  What has the same code for every part and no chain
// between the parts is split: the scaled norm's divisions and finiteness
// tests (lane r takes the components r, r + G, ...) and the controller's
// powers left to compute (lane r the powers r, r + G, ...).  The results
// reach every lane by shuffle and are combined in the one-thread order, so
// every G gives the one-thread body's bits.  A group is any type with
// rank() and shfl(v, src), the value v of the group's lane src:
// lane_group.cuh's LaneGroup on the card, coroutine lanes in the host
// rehearsal.
//
// Include after the kernel's generated config header.
#pragma once

#include <math.h>

#include "rk_control.cuh"

namespace rk {

// The launch scalars and the output arrays of a launch.
struct Launch {
  float t0, tf, rtol, atol, h0, max_step;
  int use_hstart, max_steps;
};

struct Out {
  float* y;
  int* status;
  int* nstep;
  int* nfev;
};

// One lane per member: the group of integrate_thread, whose shuffle is the
// identity.
struct OneLane {
  __device__ int rank() const { return 0; }
  __device__ float shfl(float v, int) const { return v; }
};

// x[q G + rank] for the lane `rank` of a group of G lanes, from the G
// entries x[q G], ..., x[q G + G - 1] (those before N) by G - 1 selects:
// an index known only at run time would put x in local memory.  A lane
// past N gets x[q G].
template <int G, int N>
__device__ __forceinline__ float lane_entry(const float (&x)[N], int q,
                                            int rank) {
  float v = x[q * G];
#pragma unroll
  for (int j = 1; j < G; ++j) {
    if (q * G + j < N) v = rank == j ? x[q * G + j] : v;
  }
  return v;
}

// sqrt(mean((e / (atol + rtol max(|a|, |b|)))^2)) over N components, or a
// non-finite value where b or c holds one (the finiteness tests of the
// solution and the FSAL stage): lane r divides and tests the components r,
// r + G, ...; the quotients reach every lane by shuffle and are squared and
// summed in component order, as the one-thread body sums them.
template <int G, int N, class Group>
__device__ __forceinline__ float lane_norm(Group& grp, const float (&e)[N],
                                           const float (&a)[N],
                                           const float (&b)[N],
                                           const float (&c)[N], float rtol,
                                           float atol) {
  constexpr int Q = (N + G - 1) / G;  // components per lane
  const int rank = grp.rank();
  float r[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float bq = lane_entry<G>(b, q, rank);
    const float scale =
        atol + rtol * fmaxf(fabsf(lane_entry<G>(a, q, rank)), fabsf(bq));
    const float x = lane_entry<G>(e, q, rank) / scale;
    r[q] = isfinite(bq) && isfinite(lane_entry<G>(c, q, rank)) ? x
                                                              : INFINITY;
  }
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ri = grp.shfl(r[i / G], i % G);
    sq = sq + ri * ri;
  }
  return sqrtf(sq / static_cast<float>(N));
}

// The four powers of ctl.update after an attempt of step h with error norm
// err_norm, in every lane of the group: lane r computes the powers left
// (kPowers, power_index) r, r + G, ...; the others are 1 or the first.
// Where one power is left, every lane computes it and nothing is shuffled.
template <int G, class Group>
__device__ __forceinline__ void lane_powers(Group& grp,
                                            const StepControl& ctl,
                                            float err_norm, float h,
                                            float (&pw)[4]) {
  constexpr int P = kPowers;
  if constexpr (P <= 1) {
    // one power (or none) left: every lane computes it with its exponent
    // a literal, as StepControl::update does
    constexpr int q0 = power_index(0);
    constexpr float e0 = pow_exponent(q0 < 4 ? q0 : 0);
    const float p0 = P == 1 ? powf(ctl.pow_base(q0, err_norm, h), e0) : 1.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pw[q] = pow_left(q) ? p0 : (pow_exponent(q) == 0.0f ? 1.0f : p0);
    }
  } else {
    constexpr int Q = (P + G - 1) / G;  // powers per lane
    float mine[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int p = k * G + grp.rank();
      float base = ctl.pow_base(power_index(0), err_norm, h);
      float ex = pow_exponent(power_index(0));
#pragma unroll
      for (int j = 1; j < P; ++j) {
        if (p == j) {
          base = ctl.pow_base(power_index(j), err_norm, h);
          ex = pow_exponent(power_index(j));
        }
      }
      mine[k] = powf(base, ex);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int p = 0;
#pragma unroll
      for (int j = 0; j < P; ++j) p = power_index(j) == q ? j : p;
      pw[q] = pow_left(q) ? grp.shfl(mine[p / G], p % G)
                          : (pow_exponent(q) == 0.0f ? 1.0f : pw[0]);
    }
  }
}

// Section clocks of one member, in the probe's build only
// (tools/probe_fused_small.py compiles with FUSED_SMALL_SECTIONS): the SM
// cycles spent in each part of the attempts, summed over them, and the
// attempts.  A lane waiting for the others of its warp at the end of a
// divergent part counts the wait in the part that follows.  The shipped
// build's Clock is empty and compiles to nothing.
enum Section {
  kStageSums,  // the stage arguments: weighted sums of the earlier stages
  kRhs,        // the right-hand side (acceleration) evaluations
  kSolution,   // the solution and the error estimate's sums
  kNorm,       // the scaled norm, its finiteness tests and the accept test
  kControl,    // the controller: its powers and the next step
  kLoop,       // the step limits, landing, status, commit and step cap
  kSections
};
// a member's row of the probe's counters: the sections' cycles, attempts
constexpr int kAttempts = kSections;
constexpr int kSectionSlots = kSections + 1;
#ifdef FUSED_SMALL_SECTIONS
__device__ unsigned* g_sections;  // [member][kSectionSlots]
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
  __device__ void write(int member, int attempts) const {
    unsigned* row = g_sections + static_cast<size_t>(member) * kSectionSlots;
#pragma unroll
    for (int k = 0; k < kSections; ++k) row[k] = acc[k];
    row[kAttempts] = static_cast<unsigned>(attempts);
  }
};
#else
struct Clock {
  __device__ void mark(int) {}
  __device__ void write(int, int) const {}
};
#endif

}  // namespace rk
