// The weight rows of an explicit tableau as rk_common.cuh's sums read them,
// for the kernels whose generated header provides the accessors tab::A(i, j),
// AP(i, j), B(j), BP(j), E(j) and EP(j) (fused_rkn.cu, fused_rk_grid.cu; the
// velocity rows are zero for a first-order tableau).
//
// Include after the kernel's generated config header.
#pragma once

namespace rk {

template <int I>
struct RowA {
  __host__ __device__ static constexpr float w(int j) { return tab::A(I, j); }
};
template <int I>
struct RowAp {
  __host__ __device__ static constexpr float w(int j) {
    return tab::AP(I, j);
  }
};
struct RowB {
  __host__ __device__ static constexpr float w(int j) { return tab::B(j); }
};
struct RowBp {
  __host__ __device__ static constexpr float w(int j) { return tab::BP(j); }
};
struct RowE {
  __host__ __device__ static constexpr float w(int j) { return tab::E(j); }
};
struct RowEp {
  __host__ __device__ static constexpr float w(int j) { return tab::EP(j); }
};

}  // namespace rk
