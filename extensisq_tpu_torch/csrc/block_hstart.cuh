// The block start shared by the block-per-member kernels (fused_rk_grid.cu,
// fused_esdirk_grid.cu): Watts' starting step with a member's rows in
// shared memory and its norms as group reductions.
//
// Include after the kernel's generated config header: it reads the float32
// constants tab::HS_BIG, HS_RELPER, HS_SMALL and HS_T_FLOOR.
#pragma once

#include <math.h>

#include "rk_common.cuh"

namespace rk {

// The sum and the minimum over the member of log10(atol + rtol |y_j|), the
// parts of the start's tolerance midpoint, as group reductions; the minimum
// keeps a NaN, as torch.amin does in the plain version.
template <int NF, class Group>
__device__ void log_tolerances(Group& g, const float* y, float rtol,
                               float atol, float& lsum, float& lmin) {
  float tsum = 0.0f;
  float tmin = INFINITY;
  for (int j = g.rank(); j < NF; j += g.size()) {
    const float te = log10f(atol + rtol * fabsf(y[j]));
    tsum += te;
    tmin = nan_min(tmin, te);
  }
  lsum = g.sum(tsum);
  lmin = g.min(tmin);
}

// Watts' starting step for one member, unsigned: hstart.cuh's algorithm on
// the group g (rank(), size(), sync(), sum(x), min(x)), with its norms and
// minimum as group reductions that keep a NaN, as the plain version's
// torch reductions do.  deriv(t, Y, j) is element j of the member's
// first-order derivative at (t, Y); y is the state (NF, in shared memory),
// w six scratch rows of NF whose first holds f(a, y).  Costs
// 1 + min(NF + 1, 3) evaluations of the RHS.
template <int NF, int MORDER, class Group, class Deriv>
__device__ float block_hstart(Group& g, const Deriv& deriv, float a, float b,
                              const float* y, float* w, float rtol,
                              float atol) {
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
  fbnd = nan_max(fbnd, delf);

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
    if (!done) fbnd = nan_max(fbnd, nyp);
    delf = rms(DF);
    const bool overflow = delf >= kBig * fabsf(dely);
    if (!done) {
      dfdub = overflow ? kBig : nan_max(dfdub, delf / fabsf(dely));
    }
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
  float tolsum, tolmin;
  log_tolerances<NF>(g, y, rtol, atol, tolsum, tolmin);
  tolmin = nan_min(tolmin, kBig);
  const float tolp = powf(
      10.0f, 0.5f * (tolsum / static_cast<float>(NF) + tolmin) /
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

}  // namespace rk
