// Weighted sums over stage rows kept in shared memory, for the
// block-per-member and warp-per-member kernels (fused_rk_grid.cu,
// fused_esdirk_grid.cu): the thread that owns element i sums column i of
// the rows K[j][0..N), with rk_common.cuh's compile-time weights (zero
// weights drop out, the order is the JAX kernels'); and the loop over the
// elements a thread owns.
#pragma once

#include "rk_common.cuh"

namespace rk {

// f(i) for the elements i < NE that the group's thread g.rank() owns, in
// ascending order: i = rank, rank + size, ...  A group whose stride is
// known at compile time (Group::kStride > 0: a warp's 32) runs the loop
// unrolled over its ceil(NE / kStride) elements, so that their independent
// chains can overlap; a block takes its run-time size.
template <int NE, class Group, class F>
__device__ __forceinline__ void for_elements(const Group& g, F&& f) {
  constexpr int kStride = Group::kStride;
  if constexpr (kStride > 0) {
    const int r = g.rank();
#pragma unroll
    for (int k = 0; k < (NE + kStride - 1) / kStride; ++k) {
      const int i = r + k * kStride;
      if (NE % kStride == 0 || i < NE) f(i);
    }
  } else {
    for (int i = g.rank(); i < NE; i += g.size()) f(i);
  }
}

// value(i) for every element i the thread owns, then put(i, value) for
// each, in ascending order.  Where the stride is known at compile time the
// values wait in registers until all are computed: the compiler keeps a
// store to shared memory ahead of every later load whose address it cannot
// prove apart, so a loop that stores as it goes runs a thread's elements
// one after another, while here their loads and arithmetic overlap.  A
// block puts each value at once (one element a thread, as a rule).
template <int NE, class Group, class Value, class Put>
__device__ __forceinline__ void for_elements_put(const Group& g,
                                                 Value&& value, Put&& put) {
  constexpr int kStride = Group::kStride;
  if constexpr (kStride > 0) {
    constexpr int kE = (NE + kStride - 1) / kStride;
    decltype(value(0)) v[kE];
    const int r = g.rank();
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int i = r + k * kStride;
      if (NE % kStride == 0 || i < NE) v[k] = value(i);
    }
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int i = r + k * kStride;
      if (NE % kStride == 0 || i < NE) put(i, v[k]);
    }
  } else {
    for (int i = g.rank(); i < NE; i += g.size()) put(i, value(i));
  }
}

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
