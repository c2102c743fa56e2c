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
//
// coefficients_lanes is the same update for a member whose vectors are
// spread over a group of G lanes (fused_adams.cu): element e lives in lane
// e % G at slot e / G, an element at a run-time index comes from its lane
// by a shuffle, and the element-wise steps run across the lanes.  Every sum
// and product keeps coefficients' order.
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

// ---- a member's vectors over a group of G lanes ----
//
// The group (rank(), shfl(v, src): lane src's v) is BlockGroup-like; with
// G = 1 its shfl is the identity, slot e is element e, and every helper
// below reduces to the register form above.

// Slots per lane of a vector of LEN elements.
template <int LEN, int G>
__device__ __host__ constexpr int slots() {
  return (LEN + G - 1) / G;
}

// Element e of a spread vector, in every lane (e uniform over the group).
template <int G, int S, class Group>
__device__ __forceinline__ float lget(Group& grp, const float (&a)[S],
                                      int e) {
  return grp.shfl(take(a, e / G), e % G);
}

// Element e of a spread vector = val, on e's lane.
template <int G, int S, class Group>
__device__ __forceinline__ void lput(Group& grp, float (&a)[S], int e,
                                     float val) {
  if (grp.rank() == e % G) put(a, e / G, val);
}

// b = a moved down one element: b[e] = a[e + 1], 0 from element LEN - 1.
template <int G, int LEN, int S, class Group>
__device__ __forceinline__ void shift_down(Group& grp, const float (&a)[S],
                                           float (&b)[S]) {
  const int r = grp.rank();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float same = grp.shfl(a[s], (r + 1) & (G - 1));
    const float next = s + 1 < S ? grp.shfl(a[s + 1 < S ? s + 1 : s], 0)
                                 : 0.0f;
    b[s] = s * G + r + 1 < LEN ? (r < G - 1 ? same : next) : 0.0f;
  }
}

// b = a moved up one element: b[e] = a[e - 1], 0 at element 0.
template <int G, int S, class Group>
__device__ __forceinline__ void shift_up(Group& grp, const float (&a)[S],
                                         float (&b)[S]) {
  const int r = grp.rank();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float same = grp.shfl(a[s], (r + G - 1) & (G - 1));
    const float prev = s > 0 ? grp.shfl(a[s > 0 ? s - 1 : 0], G - 1) : 0.0f;
    b[s] = r > 0 ? same : prev;
  }
}

// The coefficient state of one member over G lanes: psi/alpha/beta/v/w
// (KM elements) and sig/g (KM + 1) spread, the iv pointers in every lane.
// coefficients' gi and kgi are left out: nothing reads them in a kernel.
template <int KM, int G>
struct LaneCoef {
  static constexpr int S = slots<KM, G>();
  static constexpr int S1 = slots<KM + 1, G>();
  static constexpr int NIV = KM > 2 ? KM - 2 : 1;
  float psi[S], alpha[S], beta[S], v[S], w[S];
  float sig[S1], g[S1];
  int iv[NIV];
  int ivc;
};

// coefficients (above) for a member spread over the group grp; iqq holds
// the lane's elements of tab::IQQ.  The element-wise steps (psi, alpha,
// the beta ratios, the main v update, each step of the g loop) run across
// the lanes; the running products of beta and sig and the diagonal v
// update are one chain, in coefficients' order, that every lane runs on
// elements broadcast from their lanes.
template <int KM, int G, class Group>
__device__ __forceinline__ void coefficients_lanes(
    Group& grp, LaneCoef<KM, G>& c, const float (&iqq)[LaneCoef<KM, G>::S],
    float h, int k, int ns, int kprev, int kold) {
  using C = LaneCoef<KM, G>;
  constexpr int S = C::S;
  if (k < ns) return;
  const int rank = grp.rank();
  const int kp1 = k + 1;
  const int km1 = k - 1;
  const int nsm1 = ns - 1;

  // psi[ns-1] = h ns; psi[e] = h + psi_old[e-1] for e in [ns, k)
  float old_up[S];
  shift_up<G>(grp, c.psi, old_up);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = s * G + rank;
    if (e == nsm1) {
      c.psi[s] = h * static_cast<float>(ns);
    } else if (e >= ns && e < k) {
      c.psi[s] = h + old_up[s];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = s * G + rank;
    if (e == nsm1) {
      c.alpha[s] = 1.0f / static_cast<float>(ns);
    } else if (e >= ns && e < k) {
      c.alpha[s] = h / (c.psi[s] == 0.0f ? 1.0f : c.psi[s]);
    }
  }
  // beta[e] = prod_{j = ns..e} psi[j-1] / psi_old[j-1], 1 at e = ns - 1
  float new_up[S], ratio[S];
  shift_up<G>(grp, c.psi, new_up);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = s * G + rank;
    ratio[s] = 1.0f;
    if (e >= ns && e < k && e > 0) {
      const float old = old_up[s];
      ratio[s] = 0.0f * old + new_up[s] / (old == 0.0f ? 1.0f : old);
    }
  }
  float run = 1.0f;
#pragma unroll
  for (int e = 0; e < KM; ++e) {
    const float re = grp.shfl(ratio[e / G], e % G);
    if (e >= ns && e < k) run = run * re;
    if (rank == e % G) {
      if (e == nsm1) {
        c.beta[e / G] = 1.0f;
      } else if (e >= ns && e < k) {
        c.beta[e / G] = run;
      }
    }
  }
  // sig[m] = sig_old[ns-1] prod_{i = ns-1..m-1} (i+1) alpha[i], m in [ns, k]
  const float s_base =
      nsm1 == 0 ? 1.0f : lget<G>(grp, c.sig, clip(nsm1, 0, KM));
  run = 1.0f;
#pragma unroll
  for (int e = 0; e < KM; ++e) {
    const float ae = grp.shfl(c.alpha[e / G], e % G);
    if (e >= nsm1 && e < k) run = run * (static_cast<float>(e + 1) * ae);
    const int m = e + 1;
    if (m >= ns && m <= k && rank == m % G) c.sig[m / G] = s_base * run;
  }

  if (ns == 1) {
    // first step at this h (shampine.py:275-280)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s * G + rank < k) c.v[s] = iqq[s];
      c.w[s] = c.v[s];
    }
    c.ivc = 0;
  } else {
    // ns > 1 (shampine.py:282-309)
    const bool raised = k > kprev;
    const bool use_iv = raised && c.ivc != 0;
    const int jv =
        use_iv ? kp1 - take(c.iv, clip(c.ivc - 1, 0, C::NIV - 1)) : 1;
    int ivc2 = use_iv ? c.ivc - 1 : c.ivc;
    // fresh diagonal entry when the order was raised without a stored iv
    // pointer
    if (raised && c.ivc == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s * G + rank == km1) c.v[s] = c.w[s] = iqq[s];
      }
    }
    // the diagonal update over j = jv .. ns-2, rows i = k-1-j, one chain:
    // the new v[i] is the next row's v[i + 1]
    if (raised && jv < nsm1) {
      float prev = lget<G>(grp, c.v, clip(k - jv, 0, KM - 1));
      for (int j = jv; j < nsm1; ++j) {
        const int i = clip(km1 - j, 0, KM - 1);
        prev = lget<G>(grp, c.v, i) - lget<G>(grp, c.alpha, j) * prev;
        lput<G>(grp, c.v, i, prev);
      }
    }
    if (raised) {
      const int lowlim = max(km1 - nsm1 + 1, 0);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int e = s * G + rank;
        if (e >= lowlim && e <= km1 - jv) c.w[s] = c.v[s];
      }
    }
    // main v update and w copy
    const int limit1 = kp1 - ns;
    const float alpha_ns = lget<G>(grp, c.alpha, clip(nsm1, 0, KM - 1));
    float v_next[S];
    shift_down<G, KM>(grp, c.v, v_next);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s * G + rank < limit1) c.v[s] = c.v[s] - alpha_ns * v_next[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s * G + rank < limit1 + 1) c.w[s] = c.v[s];
    }
    lput<G>(grp, c.g, clip(ns, 0, KM), grp.shfl(c.v[0], 0));
    if (k < kold) {
      put(c.iv, clip(ivc2, 0, C::NIV - 1), limit1 + 2);
      ivc2 += 1;
    }
    c.ivc = ivc2;
  }

  // the g coefficients, computed in w (shampine.py:311-316)
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i >= ns && i < k) {
      const int limit2 = k - i;
      const float a_i = grp.shfl(c.alpha[i / G], i % G);
      float w_next[S];
      shift_down<G, KM>(grp, c.w, w_next);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s * G + rank < limit2) c.w[s] = c.w[s] - a_i * w_next[s];
      }
      const float w0 = grp.shfl(c.w[0], 0);
      if (rank == (i + 1) % G) c.g[(i + 1) / G] = w0;
    }
  }
}

}  // namespace adams
