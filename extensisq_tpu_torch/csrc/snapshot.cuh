// The in-kernel t_eval snapshots: B1 (fused_erk.cu), B5 (fused_rkn.cu),
// B11 (fused_ckdisc.cu), B2 (fused_esdirk.cu), B4, B6 and B12
// (fused_rk_grid.cu) and B7 (fused_esdirk_grid.cu).
//
// The JAX kernels (extensisq_tpu/ops/fused_erk.py:_run_erk_loop,
// fused_ckdisc.py:_run_ck_loop, fused_rkn.py:_run_rkn_loop and the ESDIRK
// kernels' loops) test every point q at every accepted step
// of a member: q is crossed when dir (tq - t) > 0 and dir tq <= dir t_new,
// and its row is then the cubic Hermite (_hermite_tiles) of the step's end
// pairs (y, f) and (y_new, f_new) at theta = (tq - t) / h, clamped to
// [0, 1]; points at or before t0 keep y0 and points a member never reaches
// take its final y.  A member's accepted steps (t, t_new] follow each other
// without gap or overlap, so each point is crossed at most once, by the
// step whose interval holds it.  Here the host sorts the points in the
// direction of integration (a stable sort, NaN first, as a point that is
// never crossed and never flushed) and a member keeps a cursor into them:
// the points from the cursor up to t_new are those the step crosses, one
// compare a step where a scan would take nq.  Each row is written once, at
// the point's index in t_eval: y0 at the start, the Hermite at the step
// that crosses it, the final y at the end.
//
// The Hermite rounds each operation on its own (__f*_rn, never contracted)
// and sums its terms in _hermite_tiles' order, so a row is the plain
// version's bit for bit from the same end pairs.  The arrays live in device
// memory; a kernel writes them only where its generated header sets
// tab::SNAP, and without it compiles to the kernels it had before.
//
// The register kernels (B1, B5, B11, B2) keep the cursor's point, its time
// and its index in t_eval, in registers (Cursor), so that a step which
// crosses no point costs a compare and no load; B1 forms the Hermite's
// weights of that point at the start of each attempt, before the stages,
// so that a step crossing it only sums them with its end pairs; and the
// points a step crosses are split over the member's lanes (snap_step, and
// snap_step_rows where a row is mapped before it is stored).  B5's rows
// are the first-order state [u, v] with derivative [v, a].  The block
// kernels (B4, B6, B12, B7) hold the cursor in every thread, and each
// thread writes its own elements of a row.  What the rows
// cost is the chain each crossed point runs after acceptance (the scan's
// load, the division, the weights, the stores), and a warp waits for its
// lane that crosses most.
#pragma once

#include <stddef.h>

namespace rk {

struct Snap {
  const float* tq = nullptr;  // [nq]: the points, sorted in the direction
  const int* idx = nullptr;   // [nq]: each sorted point's index in t_eval
  float* y = nullptr;         // [nq][members][n]: the rows, y_eval
  int nq = 0;
  int members = 0;

  // The row of sorted point q of `member`, n floats.
  __host__ __device__ float* row(int q, int member, int n) const {
    return y + (static_cast<size_t>(idx[q]) * members + member) * n;
  }

  // The first sorted point from q that lies past t in the direction dir
  // (dir tq > dir t); the points before it are at or before t.
  __device__ int past(int q, float dir, float t) const {
    while (q < nq && !(dir * tq[q] > dir * t)) ++q;
    return q;
  }

  // theta of the point at tq over the step from t of signed size h.
  __device__ static float theta(float tq, float t, float h) {
    return __fdiv_rn(__fsub_rn(tq, t), h == 0.0f ? 1.0f : h);
  }

  // theta of sorted point q over the step from t of signed size h.
  __device__ float theta(int q, float t, float h) const {
    return theta(tq[q], t, h);
  }
};

// The cubic Hermite's weights at theta (clamped to [0, 1]) over the signed
// step h, as _hermite_tiles forms them.
struct HermiteWeights {
  float c00, c10, c01, c11;
};

__device__ __forceinline__ HermiteWeights hermite_weights(float theta,
                                                          float h) {
  const float s = fminf(fmaxf(theta, 0.0f), 1.0f);
  const float s2 = __fmul_rn(s, s);
  const float s3 = __fmul_rn(s2, s);
  return HermiteWeights{
      __fadd_rn(__fsub_rn(__fmul_rn(2.0f, s3), __fmul_rn(3.0f, s2)), 1.0f),
      __fmul_rn(h, __fadd_rn(__fsub_rn(s3, __fmul_rn(2.0f, s2)), s)),
      __fsub_rn(__fmul_rn(3.0f, s2), __fmul_rn(2.0f, s3)),
      __fmul_rn(h, __fsub_rn(s3, s2))};
}

// One element of the cubic Hermite from (y0, f0) to (y1, f1) with the
// weights w, its terms summed in _hermite_tiles' order.
__device__ __forceinline__ float hermite_sum(const HermiteWeights& w,
                                             float y0, float f0, float y1,
                                             float f1) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(w.c00, y0), __fmul_rn(w.c10, f0)),
                __fmul_rn(w.c01, y1)),
      __fmul_rn(w.c11, f1));
}

// The cubic Hermite of one element at theta (clamped to [0, 1]) over the
// signed step h from (y0, f0) to (y1, f1), as _hermite_tiles sums it.
__device__ __forceinline__ float hermite(float theta, float h, float y0,
                                         float f0, float y1, float f1) {
  return hermite_sum(hermite_weights(theta, h), y0, f0, y1, f1);
}

// A register kernel's cursor: sorted point q, the first past the member's
// t, with its time and its index in t_eval (unread at q = nq).
struct Cursor {
  int q = 0;
  float tq = 0.0f;
  int idx = 0;
};

// The cursor at sorted point q.
__device__ __forceinline__ Cursor cursor_at(const Snap& s, int q) {
  Cursor c;
  c.q = q;
  if (q < s.nq) {
    c.tq = s.tq[q];
    c.idx = s.idx[q];
  }
  return c;
}

// The weights of the cursor's point over the attempt from t of signed size
// h (B1 forms them at the attempt's start; unused past the last point).
__device__ __forceinline__ HermiteWeights cursor_weights(const Cursor& c,
                                                         float t, float h) {
  return hermite_weights(Snap::theta(c.tq, t, h), h);
}

// The register kernels' rows (B1, B11): y into the rows of sorted points
// [q, end) of `member`.
template <int N>
__device__ __forceinline__ void snap_fill(const Snap& s, int q, int end,
                                          int member, const float (&y)[N]) {
  for (int p = q; p < end; ++p) {
    float* r = s.row(p, member, N);
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = y[k];
  }
}

// The register kernels' accepted step from (t, y, f) to (t_new, y1, f1) of
// signed size h with each crossed point's row formed whole in registers and
// handed to store(dst, row), dst its N floats in y_eval (B2, whose rows of
// a rotated system go back to the user's coordinates first): the j-th
// crossed point to lane j mod G, as snap_step splits them, the weights of
// each formed here.  Returns the cursor past them.
template <int N, int G, class Store>
__device__ __forceinline__ Cursor snap_step_rows(
    const Snap& s, const Cursor& c, int member, int rank, float dir, float t,
    float t_new, float h, const float (&y)[N], const float (&f)[N],
    const float (&y1)[N], const float (&f1)[N], const Store& store) {
  if (c.q >= s.nq || dir * c.tq > dir * t_new) return c;
  const int end = s.past(c.q + 1, dir, t_new);
  for (int p = c.q + rank; p < end; p += G) {
    const HermiteWeights w = hermite_weights(s.theta(p, t, h), h);
    float r[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      r[k] = hermite_sum(w, y[k], f[k], y1[k], f1[k]);
    }
    store(s.row(p, member, N), r);
  }
  return cursor_at(s, end);
}

// The register kernels' accepted step from (t, y, f) to (t_new, y1, f1) of
// signed size h, with w the weights of the cursor's point over it: the rows
// of the points it crosses, split over the member's G lanes (every lane
// holds the member's state): the j-th crossed point, j = 0, 1, ..., goes to
// lane j mod G, so that a step crossing several points writes them side by
// side, each row by the same operations whichever lane writes it.  Returns
// the cursor past them.
template <int N, int G>
__device__ __forceinline__ Cursor snap_step(const Snap& s, const Cursor& c,
                                            const HermiteWeights& w,
                                            int member, int rank, float dir,
                                            float t, float t_new, float h,
                                            const float (&y)[N],
                                            const float (&f)[N],
                                            const float (&y1)[N],
                                            const float (&f1)[N]) {
  if (c.q >= s.nq || dir * c.tq > dir * t_new) return c;
  const int end = s.past(c.q + 1, dir, t_new);
  if (rank == 0) {
    float* r = s.y + (static_cast<size_t>(c.idx) * s.members + member) * N;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      r[k] = hermite_sum(w, y[k], f[k], y1[k], f1[k]);
    }
  }
  for (int p = c.q + (rank == 0 ? G : rank); p < end; p += G) {
    const float th = s.theta(p, t, h);
    float* rp = s.row(p, member, N);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      rp[k] = hermite(th, h, y[k], f[k], y1[k], f1[k]);
    }
  }
  return cursor_at(s, end);
}

// As above, the weights of the cursor's point formed here (B11, whose
// accepted sub-step is known only after its cascade).
template <int N, int G>
__device__ __forceinline__ Cursor snap_step(const Snap& s, const Cursor& c,
                                            int member, int rank, float dir,
                                            float t, float t_new, float h,
                                            const float (&y)[N],
                                            const float (&f)[N],
                                            const float (&y1)[N],
                                            const float (&f1)[N]) {
  if (c.q >= s.nq || dir * c.tq > dir * t_new) return c;
  return snap_step<N, G>(s, c, cursor_weights(c, t, h), member, rank, dir,
                         t, t_new, h, y, f, y1, f1);
}

}  // namespace rk
