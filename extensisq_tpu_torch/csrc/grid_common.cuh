// Periodic grid indexing for the right-hand sides of the block-per-member
// kernels (fused_rkc.cu, fused_rk_grid.cu, fused_adams_grid.cu,
// fused_esdirk_grid.cu).
//
// A member's state is a row-major grid of extents D... (e.g. (2, ny, nx) for
// the Brusselator's two fields).  The generated header names it
// `tab::G = grid::Grid<D...>`, so every extent and stride is a compile-time
// constant.  A right-hand side computes dy at one flat index i and reads its
// neighbours with G::rolled<AXIS>(y, i, shift), the value at i of
// jnp.roll(y, shift, AXIS) (torch.roll(y, shift, AXIS) in the plain version):
// the element whose coordinate along AXIS is (c - shift) mod n.
#pragma once

namespace grid {

template <int... D>
struct Grid {
  static constexpr int NDIM = sizeof...(D);
  static constexpr int SIZE = (D * ... * 1);

  __host__ __device__ static constexpr int extent(int axis) {
    constexpr int d[] = {D...};
    return d[axis];
  }

  __host__ __device__ static constexpr int stride(int axis) {
    int s = 1;
    for (int a = NDIM - 1; a > axis; --a) s *= extent(a);
    return s;
  }

  // coordinate of flat index i along AXIS
  template <int AXIS>
  __device__ __forceinline__ static int coord(int i) {
    return (i / stride(AXIS)) % extent(AXIS);
  }

  // flat index of the element that a periodic shift by `shift` along AXIS
  // moves to flat index i
  template <int AXIS>
  __device__ __forceinline__ static int shifted(int i, int shift) {
    constexpr int n = extent(AXIS);
    constexpr int st = stride(AXIS);
    const int c = coord<AXIS>(i);
    int c2 = (c - shift) % n;
    if (c2 < 0) c2 += n;
    return i + (c2 - c) * st;
  }

  // of any element type, so that a template right-hand side can run as
  // rhs<Dual> (dual.cuh) for the implicit kernels' Jacobian bands
  template <int AXIS, class T>
  __device__ __forceinline__ static T rolled(const T* y, int i, int shift) {
    return y[shifted<AXIS>(i, shift)];
  }

  // and of any indexable view of the state, such as the dual rows
  // (dual.cuh: DualRows) through which the variational systems of
  // ops/fused_sens.py evaluate a right-hand side on a tangent block
  template <int AXIS, class V>
  __device__ __forceinline__ static auto rolled(const V& y, int i,
                                                int shift) {
    return y[shifted<AXIS>(i, shift)];
  }
};

}  // namespace grid
