// Watts' starting step for one member, unsigned: the scalar form of
// ops/_hstart_tile.py:hstart_tile, shared by the fused kernels.  Costs
// 1 + min(N + 1, 3) evaluations of the right-hand side.  Its maxima and
// minima keep a NaN, as the plain version's do.
//
// Include after the kernel's generated config header: it reads the
// float32 constants tab::HS_BIG, HS_SMALL, HS_RELPER and HS_T_FLOOR and
// calls fn(t, y, dy) on float arguments, by default the user's rhs.
#pragma once

#include <math.h>

#include "rk_common.cuh"

namespace rk {

// The user's rhs(t, y, dy), the right-hand side hstart calls by default.
struct CallRhs {
  template <class T>
  __device__ __forceinline__ void operator()(T t, const T* y, T* dy) const {
    rhs(t, y, dy);
  }
};

template <int N, int MORDER, class F = CallRhs>
__device__ float hstart(float a, float b, const float (&y)[N],
                        const float (&f)[N], float rtol, float atol,
                        const F& fn = F()) {
  constexpr float kBig = tab::HS_BIG;
  constexpr float kRelper = tab::HS_RELPER;
  float etol[N];
#pragma unroll
  for (int k = 0; k < N; ++k) etol[k] = atol + rtol * fabsf(y[k]);

  const float dx = b - a;
  const float absdx = fabsf(dx);
  const float sdx = dx >= 0.0f ? 1.0f : -1.0f;

  // bound on d f / d t
  float da = sdx * fmaxf(fminf(kRelper * fabsf(a), absdx),
                         tab::HS_T_FLOOR * fabsf(a));
  if (da == 0.0f) da = kRelper * dx;
  float sf[N], yp[N], pv[N], spy[N];
  fn(a + da, y, sf);
#pragma unroll
  for (int k = 0; k < N; ++k) yp[k] = sf[k] - f[k];
  float delf = rms(yp);
  const float dfdxb = delf < kBig * fabsf(da) ? delf / fabsf(da) : kBig;
  float fbnd = rms(sf);

  // local Lipschitz constant from min(N + 1, 3) probes
  float dely = kRelper * rms(y);
  if (dely == 0.0f) dely = kRelper;
  dely = dely * sdx;
  delf = rms(f);
  fbnd = nan_max(fbnd, delf);

  const bool have_slope = delf != 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    spy[k] = have_slope ? f[k] : 0.0f;
    yp[k] = have_slope ? f[k] : 1.0f;
  }
  if (!have_slope) delf = 1.0f;  // rms of a vector of ones

  float dfdub = 0.0f;
  bool done = false;
  constexpr int kProbes = N + 1 < 3 ? N + 1 : 3;
#pragma unroll
  for (int p = 1; p <= kProbes; ++p) {
    const float step = dely / (delf == 0.0f ? 1.0f : delf);
#pragma unroll
    for (int k = 0; k < N; ++k) pv[k] = y[k] + step * yp[k];
    if (p == 2) {
      fn(a + da, pv, yp);
#pragma unroll
      for (int k = 0; k < N; ++k) pv[k] = yp[k] - sf[k];
    } else {
      fn(a, pv, yp);
#pragma unroll
      for (int k = 0; k < N; ++k) pv[k] = yp[k] - f[k];
    }
    if (!done) fbnd = nan_max(fbnd, rms(yp));
    delf = rms(pv);
    const bool overflow = delf >= kBig * fabsf(dely);
    if (!done) dfdub = overflow ? kBig : nan_max(dfdub, delf / fabsf(dely));
    done = done || overflow;
    if (p == kProbes) break;

    // next perturbation vector, signs matched to local slopes
    if (delf == 0.0f) delf = 1.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float dy = p == 2 ? (y[k] != 0.0f ? y[k] : dely / kRelper)
                              : (pv[k] != 0.0f ? pv[k] : delf);
      if (spy[k] == 0.0f) spy[k] = yp[k];
      yp[k] = spy[k] != 0.0f ? fabsf(dy) * (spy[k] >= 0.0f ? 1.0f : -1.0f)
                             : dy;
    }
    delf = rms(yp);
  }

  // second-derivative bound and tolerance midpoint
  const float ydpb = dfdxb + dfdub * fbnd;
  float tolsum = 0.0f;
  float tolmin = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float te = log10f(etol[k]);
    tolsum = tolsum + te;
    tolmin = k == 0 ? te : nan_min(tolmin, te);
  }
  tolmin = nan_min(tolmin, kBig);
  const float tolp = powf(
      10.0f, 0.5f * (tolsum / static_cast<float>(N) + tolmin) /
                 static_cast<float>(MORDER + 1));

  float h = absdx;
  const float srydpb = sqrtf(0.5f * nan_max(ydpb, 0.0f));
  if (ydpb == 0.0f && fbnd == 0.0f) {
    if (tolp < 1.0f) h = absdx * tolp;
  } else if (ydpb == 0.0f) {
    if (tolp < fbnd * absdx) h = tolp / fbnd;
  } else if (tolp < srydpb * absdx) {
    h = tolp / srydpb;
  }
  if (dfdub != 0.0f) h = nan_min(h, 1.0f / dfdub);
  h = nan_max(h, tab::HS_T_FLOOR * fabsf(a));
  if (h == 0.0f) h = tab::HS_SMALL * fabsf(b);
  return h;
}

// hstart compiled out of line, for the t_eval snapshot builds of B1, B5 and
// B2: inlined beside the snapshots' code, nvcc compiled it otherwise than
// in the build without them in B5's compensated body (config 3's Kepler
// line from Watts' start: 143 of 2,048 members apart) and in B1's
// compensated lane bodies (the same orbits in first-order form with powf:
// 2,013 of 2,048 apart at 8 and 4 lanes), while out of line it gives that
// build's bits (PERF.md §6).
template <int N, int MORDER, class F>
__device__ __noinline__ float hstart_out_of_line(float a, float b,
                                                 const float (&y)[N],
                                                 const float (&f)[N],
                                                 float rtol, float atol,
                                                 const F& fn) {
  return hstart<N, MORDER>(a, b, y, f, rtol, atol, fn);
}

}  // namespace rk
