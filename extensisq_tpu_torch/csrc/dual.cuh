// Forward-mode dual numbers for the implicit fused kernels.
//
// A right-hand side written as a template,
//
//   template <class T> __device__ void rhs(T t, const T* y, T* dy);
//
// runs as rhs<float> for its values and as rhs<Dual> for one column of its
// Jacobian: seeding y[j] with the tangent 1 gives dy[i].d = df_i/dy_j.
// This is the exact JVP the JAX kernel takes with jax.linearize, not a
// finite difference.  The value parts of a dual evaluation are not used,
// so that nvcc may contract them into fma differently from rhs<float>
// changes nothing the kernel reads.
#pragma once

#include <math.h>

struct Dual {
  float v;  // value
  float d;  // tangent
  __host__ __device__ constexpr Dual(float v_ = 0.0f, float d_ = 0.0f)
      : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a) { return a; }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ Dual operator+(Dual a, float b) {
  return Dual(a.v + b, a.d);
}
__device__ __forceinline__ Dual operator+(float a, Dual b) {
  return Dual(a + b.v, b.d);
}

__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, float b) {
  return Dual(a.v - b, a.d);
}
__device__ __forceinline__ Dual operator-(float a, Dual b) {
  return Dual(a - b.v, -b.d);
}

__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
  return Dual(a.v * b, a.d * b);
}
__device__ __forceinline__ Dual operator*(float a, Dual b) {
  return Dual(a * b.v, a * b.d);
}

__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator/(Dual a, float b) {
  return Dual(a.v / b, a.d / b);
}
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return Dual(q, -q * b.d / b.v);
}

__device__ __forceinline__ Dual& operator+=(Dual& a, Dual b) {
  return a = a + b;
}
__device__ __forceinline__ Dual& operator-=(Dual& a, Dual b) {
  return a = a - b;
}
__device__ __forceinline__ Dual& operator*=(Dual& a, Dual b) {
  return a = a * b;
}
__device__ __forceinline__ Dual& operator/=(Dual& a, Dual b) {
  return a = a / b;
}

__device__ __forceinline__ Dual sqrt(Dual a) {
  const float r = sqrtf(a.v);
  return Dual(r, a.d / (2.0f * r));
}
__device__ __forceinline__ Dual exp(Dual a) {
  const float e = expf(a.v);
  return Dual(e, e * a.d);
}
__device__ __forceinline__ Dual log(Dual a) {
  return Dual(logf(a.v), a.d / a.v);
}
__device__ __forceinline__ Dual sin(Dual a) {
  return Dual(sinf(a.v), cosf(a.v) * a.d);
}
__device__ __forceinline__ Dual cos(Dual a) {
  return Dual(cosf(a.v), -sinf(a.v) * a.d);
}
__device__ __forceinline__ Dual tanh(Dual a) {
  const float th = tanhf(a.v);
  return Dual(th, (1.0f - th * th) * a.d);
}
__device__ __forceinline__ Dual fabs(Dual a) {
  return a.v < 0.0f ? -a : a;
}
__device__ __forceinline__ Dual pow(Dual a, float p) {
  const float r = powf(a.v, p);
  return Dual(r, p * powf(a.v, p - 1.0f) * a.d);
}
__device__ __forceinline__ Dual pow(Dual a, Dual p) {
  const float r = powf(a.v, p.v);
  return Dual(r, r * (p.d * logf(a.v) + p.v * a.d / a.v));
}
