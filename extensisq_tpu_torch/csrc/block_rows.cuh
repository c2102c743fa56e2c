// Weighted sums over stage rows kept in shared memory, for the
// block-per-member kernels (fused_rk_grid.cu, fused_esdirk_grid.cu): the
// thread that owns element i sums column i of the rows K[j][0..N), with
// rk_common.cuh's compile-time weights (zero weights drop out, the order
// is the JAX kernels').
#pragma once

#include "rk_common.cuh"

namespace rk {

// Column i of the rows K[j * N + i], indexed as the shared sums index a
// one-state member: col[j][0] is K[j][i].
template <int N>
struct Column {
  const float* k;
  int i;
  struct Entry {
    const float* p;
    __device__ float operator[](int) const { return *p; }
  };
  __device__ Entry operator[](int j) const { return Entry{k + j * N + i}; }
};

// sum_{j < LEN} W_j K[j][i]
template <class W, int LEN, int N>
__device__ __forceinline__ float col_wsum(const float* K, int i) {
  float a[1];
  wsum<W, LEN>(a, Column<N>{K, i});
  return a[0];
}

// (sum, compensation) of column i, as the JAX _comp_wsum
template <class W, int LEN, int N>
__device__ __forceinline__ void col_comp_wsum(const float* K, int i, float& s,
                                              float& c) {
  float a[1], b[1];
  comp_wsum<W, LEN>(a, b, Column<N>{K, i});
  s = a[0];
  c = b[0];
}

}  // namespace rk
