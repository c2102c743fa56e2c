// The dense record of the fused kernels, the rows
// ops/fused_dense.py:build_fused_dense turns into cubic Hermite segments.
// Its writers: B1 (fused_erk.cu), B2 (fused_esdirk.cu), B3
// (fused_adams.cu), B4, B6 (fused_rk_grid.cu), B5 (fused_rkn.cu), B7
// (fused_esdirk_grid.cu) and B8 (fused_adams_grid.cu).
//
// The JAX kernels (extensisq_tpu/ops/fused_*.py, `record`) write one row
// per iteration of a tile's lockstep loop, with a sentinel time where the
// member did not accept, and compact the rows on the host.  A member
// attempts once in every iteration while it runs, so that iteration is the
// member's own attempt count; here a member writes the end (t, y, f) of
// each accepted step at the row of its count of accepted steps before it,
// while its attempt count is below `rows`, and the count of rows it wrote.
// The rows arrive compacted, member by member, and a member's record is
// complete (JAX's `valid`) where that count equals its nsteps.  f0 is the
// derivative at the first node, f(t0, y0).  The SWAG kernels (B3, B8) also
// write their near-end extrapolation as a node at tf, with the f of the
// step before it, and take f0 from the starting state of the float32
// stepper's init, as JAX's do.  The arrays live in device memory,
// rows-major per member; a build writes them only where its generated
// header sets tab::REC, and without it compiles to the kernels it had
// before.
#pragma once

#include <stddef.h>

namespace rk {

struct Rec {
  float* t = nullptr;   // [member][rows]: the step's end t
  float* y = nullptr;   // [member][rows][N]: y there
  float* f = nullptr;   // [member][rows][N]: f(t, y)
  float* f0 = nullptr;  // [member][N]: f(t0, y0)
  int* n = nullptr;     // [member]: rows written
  int rows = 0;

  // the index of row `step` of `member`
  __host__ __device__ size_t row(int member, int step) const {
    return static_cast<size_t>(member) * rows + step;
  }
};

}  // namespace rk
