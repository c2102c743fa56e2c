// One thread block as the group of threads that works on one ensemble member
// (the block-per-member kernels fused_rkc.cu, fused_rk_grid.cu,
// fused_adams_grid.cu and fused_esdirk_grid.cu).
//
// A group reduction gives every thread the same value, in an order fixed by
// the launch shape: a warp butterfly, then the warps' results from shared
// memory in warp order; the minimum keeps a NaN, as torch.amin does.  One
// reduction may take K values at once, each reduced in that order, with one
// barrier for all of them (a body that needs several norms of one state
// pays one barrier, not one each).  `red` holds two buffers of SLOTS x 32
// floats (SLOTS >= K) used in turn, so that one barrier per reduction
// suffices.  The block size must be a multiple of 32.  Include it after
// the kernel's device body: host rehearsals of a body run it with a
// one-thread group instead.
#pragma once

#include <math.h>

#include "rk_common.cuh"

namespace {

template <bool MIN, int K>
__device__ __forceinline__ void block_reduce(float (&v)[K], float* red,
                                             int slots, int& turn) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v[j], o);
      v[j] = MIN ? rk::nan_min(v[j], w) : v[j] + w;
    }
  }
  float* buf = red + 32 * slots * turn;
  turn ^= 1;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) buf[32 * j + (threadIdx.x >> 5)] = v[j];
  }
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float s = buf[32 * j];
    for (int k = 1; k < nwarps; ++k) {
      s = MIN ? rk::nan_min(s, buf[32 * j + k]) : s + buf[32 * j + k];
    }
    v[j] = s;
  }
}

// One sum with `red` of two 32-float buffers.
__device__ __forceinline__ float block_sum(float v, float* red, int& turn) {
  float a[1] = {v};
  block_reduce<false>(a, red, 1, turn);
  return a[0];
}

// sums(v): the K values of v summed in one reduction, K <= SLOTS; `red`
// holds 2 x SLOTS x 32 floats.
template <int SLOTS>
struct BlockGroupOf {
  float* red;
  int turn = 0;
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  template <int K>
  __device__ void sums(float (&v)[K]) {
    static_assert(K <= SLOTS, "more sums than the buffers hold");
    block_reduce<false>(v, red, SLOTS, turn);
  }
  __device__ float sum(float v) {
    float a[1] = {v};
    sums(a);
    return a[0];
  }
  __device__ float min(float v) {
    float a[1] = {v};
    block_reduce<true>(a, red, SLOTS, turn);
    return a[0];
  }
};
using BlockGroup = BlockGroupOf<1>;

}  // namespace
