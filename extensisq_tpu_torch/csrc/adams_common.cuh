// Device helpers of the fused SWAG kernels: per-member dynamic indexing over
// a compile-time bound, and the dsteps block-1 coefficient update.
//
// Counterpart of extensisq_tpu/ops/_adams_common.py (make_coefficients),
// itself the Pallas form of extensisq_tpu/steppers/adams.py:_coefficients.
// The plain PyTorch version the kernels are held against is the port's
// AdamsStepper._coefficients (steppers/adams.py) run in float32.
//
// Every member has its own order k and step count ns, so the recurrences
// index their vectors at run time.  An array indexed at run time would
// leave registers for local memory; take/put instead walk the static bound
// KM with a select on r == i (what TileOps.vtake/vput do in JAX), so after
// unrolling every element stays a register.  The includer defines the
// float32 table tab::IQQ(i) = 1 / ((i + 1) (i + 2)) (the generated header).
#pragma once

namespace adams {

// jnp.clip(i, lo, hi): max first, then min (so hi < lo gives hi).
__device__ __forceinline__ int clip(int i, int lo, int hi) {
  return min(max(i, lo), hi);
}

// a[i] for a run-time i in [0, LEN).
template <int LEN, class T>
__device__ __forceinline__ T take(const T (&a)[LEN], int i) {
  T v = a[0];
#pragma unroll
  for (int r = 1; r < LEN; ++r) v = (i == r) ? a[r] : v;
  return v;
}

// a[i] = val for a run-time i.
template <int LEN, class T>
__device__ __forceinline__ void put(T (&a)[LEN], int i, T val) {
#pragma unroll
  for (int r = 0; r < LEN; ++r) a[r] = (i == r) ? val : a[r];
}

// The coefficient state of one member.  gi has KM - 1 rows and iv KM - 2
// (at least one, as in JAX); for KM = 1 the one gi row is never used.
template <int KM>
struct Coef {
  static constexpr int NGI = KM > 1 ? KM - 1 : 1;
  static constexpr int NIV = KM > 2 ? KM - 2 : 1;
  float psi[KM], alpha[KM], beta[KM], sig[KM + 1], v[KM], w[KM], g[KM + 1];
  float gi[NGI];
  int iv[NIV];
  int ivc, kgi;
};

// The dsteps block-1 update (shampine.py:246-317) of c, in place, for the
// step h at order k with ns steps taken at this h (after the ns update),
// the previous attempt's order kprev and the last accepted order kold:
// psi/alpha/beta/sig, the v/w diagonal update with the iv/ivc/kgi
// bookkeeping, and the g weights.  Where k < ns nothing is recomputed.
// Each branch of the JAX masks (ns == 1 or not, an active diagonal step)
// is taken as a branch here; the values are the same.
template <int KM>
__device__ __forceinline__ void coefficients(Coef<KM>& c, float h, int k,
                                             int ns, int kprev, int kold) {
  if (k < ns) return;
  const int kp1 = k + 1;
  const int km1 = k - 1;
  const int nsm1 = ns - 1;

  // psi[ns-1] = h ns; psi[r] = h + psi_old[r-1] for r in [ns, k)
  float psi_old[KM];
#pragma unroll
  for (int r = 0; r < KM; ++r) psi_old[r] = c.psi[r];
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    const float prev = r > 0 ? psi_old[r - 1] : 0.0f;
    if (r == nsm1) {
      c.psi[r] = h * static_cast<float>(ns);
    } else if (r >= ns && r < k) {
      c.psi[r] = h + prev;
    }
  }
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    if (r == nsm1) {
      c.alpha[r] = 1.0f / static_cast<float>(ns);
    } else if (r >= ns && r < k) {
      c.alpha[r] = h / (c.psi[r] == 0.0f ? 1.0f : c.psi[r]);
    }
  }
  // beta[r] = prod_{j = ns..r} psi[j-1] / psi_old[j-1], 1 at r = ns - 1
  float run = 1.0f;
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    const bool rng = r >= ns && r < k;
    float ratio = 1.0f;
    if (rng && r > 0) {
      const float old = psi_old[r - 1];
      ratio = 0.0f * old + c.psi[r - 1] / (old == 0.0f ? 1.0f : old);
    }
    run = run * ratio;
    if (r == nsm1) {
      c.beta[r] = 1.0f;
    } else if (rng) {
      c.beta[r] = run;
    }
  }
  // sig[m] = sig_old[ns-1] prod_{i = ns-1..m-1} (i+1) alpha[i], m in [ns, k]
  const float s_base = nsm1 == 0 ? 1.0f : take(c.sig, clip(nsm1, 0, KM));
  float tail[KM];
  run = 1.0f;
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    const float fac = (r >= nsm1 && r < k)
                          ? static_cast<float>(r + 1) * c.alpha[r]
                          : 1.0f;
    run = run * fac;
    tail[r] = s_base * run;
  }
#pragma unroll
  for (int m = 0; m <= KM; ++m) {
    if (m >= ns && m <= k) c.sig[m] = tail[m > 0 ? m - 1 : 0];
  }

  if (ns == 1) {
    // first step at this h (shampine.py:275-280)
#pragma unroll
    for (int r = 0; r < KM; ++r) {
      if (r < k) c.v[r] = tab::IQQ(r);
      c.w[r] = c.v[r];
    }
    c.ivc = 0;
    c.kgi = k != 1 ? 1 : 0;
    if (KM > 1 && k != 1) c.gi[0] = c.w[1 < KM ? 1 : 0];
  } else {
    // ns > 1 (shampine.py:282-309)
    const bool raised = k > kprev;
    const bool use_iv = raised && c.ivc != 0;
    const int jv =
        use_iv ? kp1 - take(c.iv, clip(c.ivc - 1, 0, Coef<KM>::NIV - 1)) : 1;
    int ivc2 = use_iv ? c.ivc - 1 : c.ivc;
    // fresh diagonal entry when the order was raised without a stored iv
    // pointer
    if (raised && c.ivc == 0) {
      float iqq_km1 = tab::IQQ(0);
#pragma unroll
      for (int r = 1; r < KM; ++r) {
        iqq_km1 = (km1 == r) ? tab::IQQ(r) : iqq_km1;
      }
      put(c.v, km1, iqq_km1);
      put(c.w, km1, take(c.v, clip(km1, 0, KM - 1)));
      if (k == 2) {
        c.kgi = 1;
        if (KM > 1) c.gi[0] = c.w[1 < KM ? 1 : 0];
      }
    }
    // sequential diagonal update over j = jv .. ns-2, rows k-1-j
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (raised && j >= jv && j < nsm1) {
        const int i = clip(km1 - j, 0, KM - 1);
        const float vi = take(c.v, i);
        put(c.v, i, vi - c.alpha[j] * take(c.v, clip(i + 1, 0, KM - 1)));
      }
    }
    if (raised) {
      const int lowlim = max(km1 - nsm1 + 1, 0);
#pragma unroll
      for (int r = 0; r < KM; ++r) {
        if (r >= lowlim && r <= km1 - jv) c.w[r] = c.v[r];
      }
    }
    if (raised && k == ns && jv < nsm1) {
      c.kgi = nsm1;
      const int gr = clip(nsm1 - 1, 0, KM - 2);
#pragma unroll
      for (int r = 0; r < KM - 1; ++r) {
        if (r == gr) c.gi[r] = c.v[1 < KM ? 1 : 0];
      }
    }
    // main v update and w copy
    const int limit1 = kp1 - ns;
    const float alpha_ns = take(c.alpha, clip(nsm1, 0, KM - 1));
#pragma unroll
    for (int r = 0; r < KM; ++r) {
      if (r < limit1) {
        c.v[r] = c.v[r] - alpha_ns * (r + 1 < KM ? c.v[r + 1] : 0.0f);
      }
    }
#pragma unroll
    for (int r = 0; r < KM; ++r) {
      if (r < limit1 + 1) c.w[r] = c.v[r];
    }
    put(c.g, clip(ns, 0, KM), c.v[0]);
    if (limit1 != 1) {
      c.kgi = ns;
      const int gr = clip(nsm1, 0, KM - 2);
#pragma unroll
      for (int r = 0; r < KM - 1; ++r) {
        if (r == gr) c.gi[r] = c.v[1 < KM ? 1 : 0];
      }
    }
    if (k < kold) {
      put(c.iv, clip(ivc2, 0, Coef<KM>::NIV - 1), limit1 + 2);
      ivc2 += 1;
    }
    c.ivc = ivc2;
  }

  // the g coefficients, computed in w (shampine.py:311-316)
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i >= ns && i < k) {
      const int limit2 = k - i;
#pragma unroll
      for (int r = 0; r < KM; ++r) {
        if (r < limit2) {
          c.w[r] = c.w[r] - c.alpha[i] * (r + 1 < KM ? c.w[r + 1] : 0.0f);
        }
      }
      c.g[i + 1 < KM ? i + 1 : KM] = c.w[0];
    }
  }
}

}  // namespace adams
