// One thread block as the group of threads that works on one ensemble member
// (the block-per-member kernels fused_rkc.cu and fused_rk_grid.cu).
//
// A group reduction gives every thread the same value, in an order fixed by
// the launch shape: a warp butterfly, then the warps' results from shared
// memory in warp order.  `red` holds two 32-float buffers used in turn, so
// that one barrier per reduction suffices.  The block size must be a
// multiple of 32.  Include it after the kernel's device body: host
// rehearsals of a body run it with a one-thread group instead.
#pragma once

#include <math.h>

namespace {

template <bool MIN>
__device__ __forceinline__ float block_reduce(float v, float* red, int& turn) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MIN ? fminf(v, w) : v + w;
  }
  float* buf = red + 32 * turn;
  turn ^= 1;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  float s = buf[0];
  for (int k = 1; k < nwarps; ++k) s = MIN ? fminf(s, buf[k]) : s + buf[k];
  return s;
}

__device__ __forceinline__ float block_sum(float v, float* red, int& turn) {
  return block_reduce<false>(v, red, turn);
}

struct BlockGroup {
  float* red;
  int turn = 0;
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ float sum(float v) { return block_reduce<false>(v, red, turn); }
  __device__ float min(float v) { return block_reduce<true>(v, red, turn); }
};

}  // namespace
