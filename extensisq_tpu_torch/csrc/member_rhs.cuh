// The user's right-hand side bound to one member's parameters, for the
// register kernels B1 (fused_erk.cu), B2 (fused_esdirk.cu) and B3
// (fused_adams.cu).
//
// The generated config header gives tab::NPAR, the number K of per-member
// parameters, and the user's source.  With K = 0 the source defines
//   rhs(float t, const float* y, float* dy)       (or the template rhs<T>);
// with K > 0 it takes the member's parameters as a fourth argument,
//   rhs(float t, const float* y, float* dy, const float* p)
//   template <class T> rhs(T t, const T* y, T* dy, const T* p),
// the template form needed wherever the kernel runs rhs<Dual> (B2's
// Jacobian, the variational systems of ops/fused_sens.py).  A member loads
// its K parameters into registers once, before its loop; on a dual
// evaluation they are promoted to duals of zero tangent, so the Jacobian
// is d f / d y at fixed p, as jax.linearize takes it.
//
// B2's simultaneous corrector (tab::NB < tab::N) forms its Newton matrix on
// the first NB rows and columns only, from base_rhs<Dual>, the system's
// first block (for a variational system the user's own right-hand side);
// its source defines base_rhs with the signature of rhs.
//
// Include after the kernel's generated config header.
#pragma once

template <int K>
struct MemberRhs {
  float p[K > 0 ? K : 1];

  __device__ explicit MemberRhs(const float* __restrict__ par) {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = par[j];
  }

  // dy = f(t, y) of the whole system
  template <class T>
  __device__ __forceinline__ void operator()(T t, const T* y, T* dy) const {
    if constexpr (K == 0) {
      rhs(t, y, dy);
    } else {
      T pt[K];
#pragma unroll
      for (int j = 0; j < K; ++j) pt[j] = T(p[j]);
      rhs(t, y, dy, static_cast<const T*>(pt));
    }
  }

  // dy = f(t, y) of the first block, for the simultaneous corrector
  template <class T>
  __device__ __forceinline__ void base(T t, const T* y, T* dy) const {
    if constexpr (K == 0) {
      base_rhs(t, y, dy);
    } else {
      T pt[K];
#pragma unroll
      for (int j = 0; j < K; ++j) pt[j] = T(p[j]);
      base_rhs(t, y, dy, static_cast<const T*>(pt));
    }
  }
};
