// G lanes of one warp as the group of threads that works on one ensemble
// member (the SWAG kernel fused_adams.cu), G a power of two from 1 to 32.
//
// Like BlockGroup (block_group.cuh) it gives a lane its rank(), with
// shfl(v, src), the value v of the group's lane src, in place of the block
// reductions.  The G consecutive threads of a block from a multiple of G
// form one group; the mask names the group's lanes, so that the groups of
// one warp may branch apart.  Include it after the kernel's device body:
// host rehearsals of a body run it with a group of their own.
#pragma once

namespace {

template <int G>
struct LaneGroup {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a lane group is a power of two of at most 32 lanes");
  unsigned mask;
  __device__ LaneGroup()
      : mask(G == 32 ? 0xffffffffu
                     : ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~(G - 1u))) {
  }
  __device__ int rank() const {
    return static_cast<int>(threadIdx.x & (G - 1u));
  }
  __device__ float shfl(float v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
};

}  // namespace
