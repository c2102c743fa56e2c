"""The CUDA kernels' sources, compiled for the host and held against their
plain PyTorch versions on the CPU.

``nvcc`` and the card exist only on the machine with the GPU, but the
kernels are plain C++ apart from a few CUDA keywords and intrinsics.  A
small shim header defines those for the host (``__device__`` and friends
away; ``__fadd_rn``/``__fsub_rn``/``__fmul_rn`` as operations the compiler
cannot contract; ``blockIdx``/``threadIdx`` as variables), and the
``extern "C"`` launch is replaced by a loop over the members.  g++ then
builds each kernel with the generated header the wrapper would use, with
``-ffp-contract=off``: no product is fused into an fma, as in PyTorch's
CPU operations.  So the kernel's logic, not only its plain version, is
checked on every CPU run: its first attempts are bit-identical to the
plain version's, and what remains is the libraries' ``powf``/``log10f``
and the dual numbers' derivative round-off.  The SWAG kernel starts from
the float32 stepper's ``init``, as its wrapper starts it, and runs its
body both as one thread per member and with each member's rows and
coefficients spread over 4 and 32 lanes (coroutines on one thread that
hand over at each shuffle).  Skipped where no g++ is installed.
"""
import ctypes
import functools
import platform
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_adams as TA  # noqa: E402
import test_torch_fused_adams_grid as TAG  # noqa: E402
import test_torch_fused_adams_routes as TAR  # noqa: E402
import test_torch_fused_ckdisc as TC  # noqa: E402
import test_torch_fused_dense_routes as TDR  # noqa: E402
import test_torch_fused_esdirk as T  # noqa: E402
import test_torch_fused_esdirk_grid as TEG  # noqa: E402
import test_torch_fused_erk as TK  # noqa: E402
import test_torch_fused_erk_grid as TG  # noqa: E402
import test_torch_fused_rkc as TR  # noqa: E402
import test_torch_fused_rkn as TN  # noqa: E402
import test_torch_fused_teval as TT  # noqa: E402

from extensisq_tpu_torch.ops import _build  # noqa: E402
from extensisq_tpu_torch.ops import fused_adams as FA  # noqa: E402
from extensisq_tpu_torch.ops import fused_adams_grid as FAG  # noqa: E402
from extensisq_tpu_torch.ops import fused_ckdisc as FC  # noqa: E402
from extensisq_tpu_torch.ops import fused_erk as FK  # noqa: E402
from extensisq_tpu_torch.ops import fused_esdirk as FE  # noqa: E402
from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG  # noqa: E402
from extensisq_tpu_torch.ops import fused_rkc as FR  # noqa: E402
from extensisq_tpu_torch.ops import fused_rkn as FN  # noqa: E402
from extensisq_tpu_torch.ops.fused_sens import (_aug_grid_rhs,  # noqa: E402
                                                _aug_rhs)
from extensisq_tpu_torch.parallel import pde  # noqa: E402

SHIM = """
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __launch_bounds__(x)
struct HostDim3 { int x; };
static HostDim3 blockIdx, blockDim, threadIdx;
__attribute__((noinline)) static float __fadd_rn(float a, float b) {
  volatile float r = a + b; return r; }
__attribute__((noinline)) static float __fsub_rn(float a, float b) {
  volatile float r = a - b; return r; }
__attribute__((noinline)) static float __fmul_rn(float a, float b) {
  volatile float r = a * b; return r; }
__attribute__((noinline)) static float __fdiv_rn(float a, float b) {
  volatile float r = a / b; return r; }
using std::isfinite;
using std::max;
using std::min;
"""

# G lanes (or CTAs) of one member as coroutines on one thread, for the
# bodies that run on groups of threads: SWAG's lane groups, B8's warp of
# coefficient lanes and B10's cluster of CTAs.
COROUTINES = r"""
#include <cstdint>
#include <cstdlib>

// G lanes of one member as coroutines on one thread: a lane runs until its
// next shfl, then hands over to the next lane; the last hands back
// to lane 0, which then finds every lane's value in the buffer (two
// buffers used in turn, so that one hand-over round per shfl suffices).
extern "C" void adams_lane_switch(void** save_sp, void* load_sp);
asm(R"(
  .text
  .globl adams_lane_switch
  .hidden adams_lane_switch
  .type adams_lane_switch, @function
adams_lane_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size adams_lane_switch, .-adams_lane_switch
)");

struct HostLaneSet {
  int G;
  int started;
  void* sp[32];
  void* main_sp;
  float fbuf[2][32];
  void (*run)(int rank);
};
static HostLaneSet* g_set;

struct HostLanes {
  int r;
  int turn = 0;
  int rank() const { return r; }
  void pass() {
    adams_lane_switch(&g_set->sp[r], g_set->sp[(r + 1) % g_set->G]);
  }
  float shfl(float v, int src) {
    float* buf = g_set->fbuf[turn];
    turn ^= 1;
    buf[r] = v;
    pass();
    return buf[src];
  }
};

static void lane_entry() {
  const int r = g_set->started++;
  g_set->run(r);
  // the lanes end in rank order; the last hands back to the caller
  void* dead;
  adams_lane_switch(&dead, r + 1 < g_set->G ? g_set->sp[r + 1]
                                            : g_set->main_sp);
}

static const int kLaneStack = 1 << 18;

// run(rank) on G lanes, each on a stack of its own
static void run_lanes(int G, void (*run)(int), char* stacks) {
  HostLaneSet set;
  set.G = G;
  set.started = 0;
  set.run = run;
  g_set = &set;
  for (int r = 0; r < G; ++r) {
    uintptr_t top = (reinterpret_cast<uintptr_t>(stacks) +
                     static_cast<uintptr_t>(r + 1) * kLaneStack) &
                    ~static_cast<uintptr_t>(15);
    void** sp = reinterpret_cast<void**>(top);
    *--sp = nullptr;
    *--sp = reinterpret_cast<void*>(&lane_entry);
    for (int i = 0; i < 6; ++i) *--sp = nullptr;
    set.sp[r] = sp;
  }
  adams_lane_switch(&set.main_sp, set.sp[0]);
}
"""

# The explicit bodies of B1 and B5 run one member after another: at one
# lane the thread-per-member body integrate_thread<COMP>, at G lanes the
# group body integrate<G, COMP> with the lanes as coroutines that hand over
# at each shuffle (the norm's quotients, the controller's powers).  The
# CUDA group and kernel after the marker are left out.
SMALL_LAUNCH = COROUTINES + r"""
struct HostSmallMember {
  const float* y0;
  const float* par;
  Launch L;
  int m;
  Out out;
  int comp;
};
static HostSmallMember g_small;
REC_GLOBAL
SNAP_GLOBAL

template <int G>
static void small_lane(int rank) {
  HostLanes lane{rank};
  const HostSmallMember& a = g_small;
  if (a.comp) {
    integrate<G, true>(lane, a.y0, PAR_ARG a.L, a.m, a.out REC_ARG SNAP_ARG);
  } else {
    integrate<G, false>(lane, a.y0, PAR_ARG a.L, a.m, a.out REC_ARG SNAP_ARG);
  }
}

extern "C" int KERNEL_launch(
    const void* y0, PAR_DECL void* y_out, void* status, void* nstep,
    void* nfev,
    int B, float t0, float tf, float rtol, float atol, float h0,
    int use_hstart, float max_step, int max_steps, int compensated,
    int lanes, int block_members, REC_DECL SNAP_DECL void* stream) {
  const Out out{(float*)y_out, (int*)status, (int*)nstep, (int*)nfev};
  REC_SET
  SNAP_SET
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  void (*body)(int) = lanes == 2 ? small_lane<2>
                      : lanes == 4 ? small_lane<4>
                      : lanes == 8 ? small_lane<8> : nullptr;
  if (lanes != 1 && body == nullptr) return 1;
  char* stacks = lanes > 1 ? static_cast<char*>(
      std::malloc(static_cast<size_t>(lanes) * kLaneStack)) : nullptr;
  const float* y0f = (const float*)y0;
  for (int m = 0; m < B; ++m) {
    const float* y0m = y0f + static_cast<size_t>(m) * N;
    const float* parm = PAR_ROW;
    if (lanes == 1) {
      if (compensated) {
        integrate_thread<true>(y0m, PAR_M L, m, out REC_ARG SNAP_ARG);
      } else {
        integrate_thread<false>(y0m, PAR_M L, m, out REC_ARG SNAP_ARG);
      }
    } else {
      g_small = HostSmallMember{y0m, parm, L, m, out, compensated};
      run_lanes(lanes, body, stacks);
    }
  }
  std::free(stacks);
  return 0;
}
"""
# B1 and B5 read the members' parameters ((B, tab::NPAR), row-major).  A
# build with the dense record (tab::REC) takes its arrays and rows after
# block_members, as fused_erk_record_launch and fused_rkn_record_launch do
def _small_launch(kernel):
    return (SMALL_LAUNCH.replace("KERNEL", kernel)
            .replace("PAR_DECL", "const void* params,")
            .replace("PAR_ROW", "(const float*)params + m * tab::NPAR")
            .replace("PAR_ARG", "a.par,").replace("PAR_M", "parm,"))


ERK_LAUNCH = _small_launch("fused_erk")
REC_DECL = ("void* rec_t, void* rec_y, void* rec_f, void* rec_f0, "
            "void* rec_n, int rows,")
REC_SET = ("g_rec = Rec{(float*)rec_t, (float*)rec_y, (float*)rec_f, "
           "(float*)rec_f0, (int*)rec_n, rows};")


def _with_record(launch, record):
    """``launch`` with its record placeholders filled (``record``) or
    empty."""
    parts = {"REC_GLOBAL": "static Rec g_rec;", "REC_ARG": ", g_rec",
             "REC_DECL": REC_DECL, "REC_SET": REC_SET}
    for key, text in parts.items():
        launch = launch.replace(key, text if record else "")
    return launch


def _with_snap(launch, snap, members="B"):
    """``launch`` with its t_eval snapshot placeholders filled (``snap``:
    the points, their indices, y_eval and their count after the record's
    arguments, as the ``<name>_snap_launch`` entries take them; the
    member count is ``members``) or empty.  A snapshot launch also takes
    the record's arguments, null with rows 0 for a build without it."""
    parts = {"SNAP_GLOBAL": "static Snap g_snap;", "SNAP_ARG": ", g_snap",
             "SNAP_DECL": ("const void* tq, const void* idx, void* y_eval, "
                           "int nq,"),
             "SNAP_SET": ("g_snap = Snap{(const float*)tq, (const int*)idx, "
                          f"(float*)y_eval, nq, {members}}};")}
    for key, text in parts.items():
        launch = launch.replace(key, text if snap else "")
    return launch


ERK_SNAP_LAUNCH = _with_snap(_with_record(ERK_LAUNCH, True), True)
ERK_RECORD_LAUNCH = _with_snap(_with_record(ERK_LAUNCH, True), False)
ERK_LAUNCH = _with_snap(_with_record(ERK_LAUNCH, False), False)
RKN_SNAP_LAUNCH = _with_snap(
    _with_record(_small_launch("fused_rkn"), True), True)
RKN_RECORD_LAUNCH = _with_snap(
    _with_record(_small_launch("fused_rkn"), True), False)
RKN_LAUNCH = _with_snap(_with_record(_small_launch("fused_rkn"), False),
                        False)

# The SWAG bodies of B3 run one member after another: at one lane the
# thread-per-member body integrate_thread<COMP>, at G lanes the group body
# integrate<G, COMP> with the lanes run as coroutines on one thread: a lane
# runs until its next shfl and hands over to the next lane (an x86-64 stack
# switch), so every lane sees the others' values at each shuffle and a
# wrong split of rows or coefficients over the lanes shows on the host.
# The CUDA group and kernel after the marker are left out.  The members'
# parameters are (B, tab::NPAR), row-major; a build with the dense record
# takes its arrays and rows before the lane count, and a build with the
# snapshots the record's (null without it) and the points' after them.
ADAMS_LAUNCH = COROUTINES + r"""
struct HostMember {
  const float *y0, *yp0, *par;
  float h0;
  int nfev0;
  Launch L;
  int m;
  Out out;
  int comp;
};
static HostMember g_member;
REC_GLOBAL
SNAP_GLOBAL

template <int G>
static void lane_body(int rank) {
  HostLanes lane{rank};
  const HostMember& a = g_member;
  if (a.comp) {
    integrate<G, true>(lane, a.y0, a.yp0, a.par, a.h0, a.nfev0, a.L, a.m,
                       a.out REC_ARG SNAP_ARG);
  } else {
    integrate<G, false>(lane, a.y0, a.yp0, a.par, a.h0, a.nfev0, a.L, a.m,
                        a.out REC_ARG SNAP_ARG);
  }
}

extern "C" int fused_adams_host(
    const float* y0, const float* params, const float* yp0, const float* h0,
    const int* nfev0, float* y_out, int* status, int* nsteps, int* nfev,
    int* work, int members, float t0, float tf, float dir, float rtol,
    float atol, float max_step, int max_steps, int compensated, REC_DECL
    SNAP_DECL int lanes) {
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Out out{y_out, status, nsteps, nfev, work};
  REC_SET
  SNAP_SET
  void (*body)(int) = lanes == 4 ? lane_body<4>
                      : lanes == 8 ? lane_body<8>
                      : lanes == 16 ? lane_body<16>
                      : lanes == 32 ? lane_body<32> : nullptr;
  if (lanes != 1 && body == nullptr) return 1;
  char* stacks = lanes > 1 ? static_cast<char*>(
      std::malloc(static_cast<size_t>(lanes) * kLaneStack)) : nullptr;
  for (int m = 0; m < members; ++m) {
    const float* parm = params + m * tab::NPAR;
    if (lanes == 1) {
      if (compensated) {
        integrate_thread<true>(y0 + m * N, yp0 + m * N, parm, h0[m],
                               nfev0[m], L, m, out REC_ARG SNAP_ARG);
      } else {
        integrate_thread<false>(y0 + m * N, yp0 + m * N, parm, h0[m],
                                nfev0[m], L, m, out REC_ARG SNAP_ARG);
      }
    } else {
      g_member = HostMember{y0 + m * N, yp0 + m * N, parm, h0[m], nfev0[m],
                            L, m, out, compensated};
      run_lanes(lanes, body, stacks);
    }
  }
  std::free(stacks);
  return 0;
}
"""
ADAMS_SNAP_LAUNCH = _with_snap(_with_record(ADAMS_LAUNCH, True), True,
                               "members")
ADAMS_RECORD_LAUNCH = _with_snap(_with_record(ADAMS_LAUNCH, True), False)
ADAMS_LAUNCH = _with_snap(_with_record(ADAMS_LAUNCH, False), False)

# The ESDIRK bodies of B2 run one member after another: at one lane the
# thread-per-member body integrate_thread<COMP>, at G lanes the group body
# integrate<G, COMP> with the lanes as coroutines that hand over at each
# shuffle (the Jacobian's columns).  The CUDA group and kernel after the
# marker are left out.
ESDIRK_LAUNCH = COROUTINES + r"""
struct HostEsdirkMember {
  const float *y0, *yp0, *par;
  Launch L;
  int m;
  Out out;
  int comp;
};
static HostEsdirkMember g_esdirk;
REC_GLOBAL
SNAP_GLOBAL

template <int G>
static void esdirk_lane(int rank) {
  HostLanes lane{rank};
  const HostEsdirkMember& a = g_esdirk;
  if (a.comp) {
    integrate<G, true>(lane, a.y0, a.yp0, a.par, a.L, a.m,
                       a.out REC_ARG SNAP_ARG);
  } else {
    integrate<G, false>(lane, a.y0, a.yp0, a.par, a.L, a.m,
                        a.out REC_ARG SNAP_ARG);
  }
}

extern "C" int fused_esdirk_launch(
    const void* y0, const void* yp0, const void* params, void* y_out,
    void* status, void* nstep, void* nfev, int B, float t0, float tf,
    float rtol, float atol, float h0, int use_hstart, int have_yp0,
    float max_step, int max_steps, float tiny_err, int compensated,
    int lanes, int block_members, REC_DECL SNAP_DECL void* stream) {
  const Out out{(float*)y_out, (int*)status, (int*)nstep, (int*)nfev};
  REC_SET
  SNAP_SET
  const Launch L{t0, tf, rtol, atol, h0, max_step, tiny_err, use_hstart,
                 have_yp0, max_steps};
  void (*body)(int) = lanes == 4 ? esdirk_lane<4>
                      : lanes == 8 ? esdirk_lane<8> : nullptr;
  if (lanes != 1 && body == nullptr) return 1;
  char* stacks = lanes > 1 ? static_cast<char*>(
      std::malloc(static_cast<size_t>(lanes) * kLaneStack)) : nullptr;
  const float* y0f = (const float*)y0;
  const float* yp0f = (const float*)yp0;
  for (int m = 0; m < B; ++m) {
    const float* y0m = y0f + m * N;
    const float* yp0m = have_yp0 ? yp0f + m * N : nullptr;
    const float* parm = (const float*)params + m * tab::NPAR;
    if (lanes == 1) {
      if (compensated) {
        integrate_thread<true>(y0m, yp0m, parm, L, m, out REC_ARG SNAP_ARG);
      } else {
        integrate_thread<false>(y0m, yp0m, parm, L, m,
                                out REC_ARG SNAP_ARG);
      }
    } else {
      g_esdirk = HostEsdirkMember{y0m, yp0m, parm, L, m, out, compensated};
      run_lanes(lanes, body, stacks);
    }
  }
  std::free(stacks);
  return 0;
}
"""
# B2 with the dense record takes its arrays and rows after block_members,
# and with snapshots theirs after them (with the record's, null without it)
ESDIRK_SNAP_LAUNCH = _with_snap(_with_record(ESDIRK_LAUNCH, True), True)
ESDIRK_RECORD_LAUNCH = _with_snap(_with_record(ESDIRK_LAUNCH, True), False)
ESDIRK_LAUNCH = _with_snap(_with_record(ESDIRK_LAUNCH, False), False)

# The RKC body integrate<RHO, Group> run one member after another, at
# cluster = 1 by a one-thread group whose sync() does nothing (the arrays in
# the workspace, as B9 and B10's block body), at cluster = C by C one-thread
# CTAs as coroutines that hand over at each cluster barrier, each with its
# chunk's arrays in a buffer of its own and its sums written into every
# CTA's slots (the DSMEM partials of the card's ClusterGroup), then added
# in rank order.  The CUDA groups and kernels after the marker are left
# out.
RKC_MARKER = "// ---- CUDA groups, kernels and launch ----"
RKC_LAUNCH = COROUTINES + r"""
struct HostGroup {
  static constexpr bool kLocal = false;
  int rank() const { return 0; }
  int size() const { return 1; }
  int lo() const { return 0; }
  int hi() const { return NTOT; }
  void sync() const {}
  void arrive() const {}
  void wait() const {}
  float sum(float v) const { return v; }
};

static float g_parts[8][2][8];  // [CTA][turn][sending CTA]

struct HostCta {
  static constexpr bool kLocal = true;
  int r, c, lo_, hi_;
  int turn = 0;
  int rank() const { return 0; }
  int size() const { return 1; }
  int lo() const { return lo_; }
  int hi() const { return hi_; }
  int local_rank() const { return 0; }
  int local_size() const { return 1; }
  int local_len() const { return hi_ - lo_; }
  void sync() const {
    adams_lane_switch(&g_set->sp[r], g_set->sp[(r + 1) % g_set->G]);
  }
  void arrive() const { sync(); }
  void wait() const {}
  float sum(float v) {
    for (int k = 0; k < c; ++k) g_parts[k][turn][r] = v;
    const float* mine = g_parts[r][turn];
    turn ^= 1;
    sync();
    float s = mine[0];
    for (int k = 1; k < c; ++k) s += mine[k];
    return s;
  }
};

struct HostRkcMember {
  int rho_mode, c;
  const float *y, *p;
  float *w, *sm;
  Solve s;
  int m;
  Out out;
};
static HostRkcMember g_rkc;
PTS_GLOBAL

template <class Group>
static void rkc_member(Group& g, const HostRkcMember& a, float* sm) {
  PTS_LOCAL
  if (a.rho_mode == kRhoConst) integrate<kRhoConst>(g, a.y, a.p, a.w, sm, a.s, a.m, a.out PTS_ARG);
  if (a.rho_mode == kRhoFn) integrate<kRhoFn>(g, a.y, a.p, a.w, sm, a.s, a.m, a.out PTS_ARG);
  if (a.rho_mode == kRhoPower) integrate<kRhoPower>(g, a.y, a.p, a.w, sm, a.s, a.m, a.out PTS_ARG);
}

static void rkc_cta(int r) {
  const HostRkcMember& a = g_rkc;
  const int chunk = (NTOT + a.c - 1) / a.c;
  const int lo = min(r * chunk, NTOT);
  HostCta g{r, a.c, lo, min(lo + chunk, NTOT)};
  rkc_member(g, a, a.sm + static_cast<size_t>(r) * 6 * chunk);
}

// B9's grid group on the host: `nb` one-thread blocks as coroutines that
// hand over at each arrive (wait does nothing; the last hands back to the
// first, so every block has arrived when one goes on), element i to block
// i mod nb; with LOCAL each block keeps the k-th slot of its elements'
// six arrays at k of a buffer of its own (the card's shared placement),
// else the arrays are in the workspace.  A sum: each block's value in its
// slot, the barrier, then the slots added in block order by every block.
static float g_gparts[2][8];

template <bool LOCAL>
struct HostGridBlock {
  static constexpr bool kLocal = LOCAL;
  int b, nb;
  int turn = 0;
  int rank() const { return b; }
  int size() const { return nb; }
  int lo() const { return 0; }
  int hi() const { return NTOT; }
  int local_rank() const { return 0; }
  int local_size() const { return 1; }
  int local_len() const { return (NTOT + nb - 1) / nb; }
  void arrive() const {
    adams_lane_switch(&g_set->sp[b], g_set->sp[(b + 1) % g_set->G]);
  }
  void wait() const {}
  void sync() const { arrive(); }
  float sum(float v) {
    float* parts = g_gparts[turn];
    turn ^= 1;
    parts[b] = v;
    sync();
    float s = parts[0];
    for (int k = 1; k < nb; ++k) s += parts[k];
    return s;
  }
};

template <bool LOCAL>
static void rkc_grid_block(int b) {
  const HostRkcMember& a = g_rkc;
  HostGridBlock<LOCAL> g{b, a.c};
  float* sm = LOCAL ? a.sm + static_cast<size_t>(b) * 6 * g.local_len()
                    : nullptr;
  rkc_member(g, a, sm);
}

// One member (B9) on `blocks` host blocks (at most 8), its arrays in their
// buffers (local) or in the workspace.
extern "C" int fused_rkc_grid_host(
    int rho_mode, const float* y0, const float* params, float* y_out,
    int* status, int* nsteps, int* nfev, int* nfesig, float* work,
    float t0, float tf, float dir, float rtol, float atol, float h0,
    float rho_const, float max_step, int mmax, int max_steps,
    int const_jac, PTS_DECL int blocks, int local) {
  if (blocks < 1 || blocks > 8) return 1;
  PTS_SET
  Solve s{t0, tf, dir, rtol, atol, h0, rho_const, max_step,
          mmax, max_steps, const_jac};
  Out out{y_out, status, nsteps, nfev, nfesig};
  const int len = (NTOT + blocks - 1) / blocks;
  float* sm = new float[static_cast<size_t>(blocks) * 6 * len];
  char* stacks = static_cast<char*>(
      std::malloc(static_cast<size_t>(blocks) * kLaneStack));
  g_rkc = HostRkcMember{rho_mode, blocks, y0,
                        tab::NPAR ? params : nullptr, work, sm, s, 0, out};
  run_lanes(blocks, local ? rkc_grid_block<true> : rkc_grid_block<false>,
            stacks);
  std::free(stacks);
  delete[] sm;
  return 0;
}

extern "C" int fused_rkc_host(
    int rho_mode, const float* y0, const float* params, float* y_out,
    int* status, int* nsteps, int* nfev, int* nfesig, float* work,
    int members, float t0, float tf, float dir, float rtol, float atol,
    float h0, float rho_const, float max_step, int mmax, int max_steps,
    int const_jac, PTS_DECL int cluster) {
  if (cluster < 1 || cluster > 8) return 1;
  PTS_SET
  Solve s{t0, tf, dir, rtol, atol, h0, rho_const, max_step,
          mmax, max_steps, const_jac};
  Out out{y_out, status, nsteps, nfev, nfesig};
  const int chunk = (NTOT + cluster - 1) / cluster;
  float* sm = new float[static_cast<size_t>(cluster) * 6 * chunk];
  char* stacks = static_cast<char*>(
      std::malloc(static_cast<size_t>(cluster) * kLaneStack));
  for (int m = 0; m < members; ++m) {
    g_rkc = HostRkcMember{rho_mode, cluster,
                          y0 + m * NTOT,
                          tab::NPAR ? params + m * tab::NPAR : nullptr,
                          work + static_cast<size_t>(m) * kArrays * NTOT,
                          sm, s, m, out};
    if (cluster == 1) {
      HostGroup g;
      rkc_member(g, g_rkc, nullptr);
    } else {
      run_lanes(cluster, rkc_cta, stacks);
    }
  }
  std::free(stacks);
  delete[] sm;
  return 0;
}
"""


def _with_points(launch, points):
    """``launch`` with its t_eval placeholders filled (``points``: the
    points in t_eval's order, y_eval and their count before the launch
    shape, as fused_rkc_snap_launch takes them after its own; each group
    integrates with its own copy, whose pending index it moves, as each
    thread on the card does) or empty."""
    parts = {"PTS_GLOBAL": "static rk::Pending g_pts;",
             "PTS_LOCAL": "rk::Pending p = g_pts;",
             "PTS_ARG": ", p",
             "PTS_DECL": "const float* tq, float* y_eval, int nq,",
             "PTS_SET": "g_pts = rk::Pending{tq, y_eval, nq};"}
    for key, text in parts.items():
        launch = launch.replace(key, text if points else "")
    return launch


RKC_SNAP_LAUNCH = _with_points(RKC_LAUNCH, True)
RKC_LAUNCH = _with_points(RKC_LAUNCH, False)
RKC_SHAPE = (8, 8)

HOST_GROUP = """
struct HostGroup {
  static constexpr int kStride = 0;
  int rank() const { return 0; }
  int size() const { return 1; }
  void sync() const {}
  template <int K>
  void sums(float (&)[K]) const {}
  float sum(float v) const { return v; }
  float min(float v) const { return v; }
};
"""

# The warp bodies' group as a warp of 32 coroutine lanes: lane r owns the
# elements r, r + 32, ...; sync() hands over to the next lane (a barrier,
# since every lane calls it alike), and a reduction hands each lane's values
# round the warp and runs block_group.cuh's butterfly (warp_reduce) on
# them.  Each lane takes its own lane's result, as WarpGroup does, or with
# BLOCK lane 0's, as BlockGroup in a block of one warp reads it back.
HOST_WARP = COROUTINES + r"""
static float g_warp_red[2][4][32];  // [turn][value][lane]

template <bool BLOCK>
struct HostWarp {
  static constexpr int kStride = 32;
  int r;
  int turn = 0;
  int rank() const { return r; }
  int size() const { return 32; }
  void sync() const {
    adams_lane_switch(&g_set->sp[r], g_set->sp[(r + 1) % g_set->G]);
  }
  template <bool MIN, int K>
  void reduce(float (&v)[K]) {
    const int t = turn;
    turn ^= 1;
    for (int j = 0; j < K; ++j) g_warp_red[t][j][r] = v[j];
    sync();
    for (int j = 0; j < K; ++j) {
      float w[32], x[32];
      for (int l = 0; l < 32; ++l) w[l] = g_warp_red[t][j][l];
      for (int o = 16; o > 0; o >>= 1) {
        for (int l = 0; l < 32; ++l) {
          x[l] = MIN ? rk::nan_min(w[l], w[l ^ o]) : w[l] + w[l ^ o];
        }
        for (int l = 0; l < 32; ++l) w[l] = x[l];
      }
      v[j] = w[BLOCK ? 0 : r];
    }
  }
  template <int K>
  void sums(float (&v)[K]) {
    reduce<false>(v);
  }
  float sum(float v) {
    float a[1] = {v};
    reduce<false>(a);
    return a[0];
  }
  float min(float v) {
    float a[1] = {v};
    reduce<true>(a);
    return a[0];
  }
};
"""

# The grid bodies integrate<COMP, Group> (B4 and B6) and integrate_ck<Group>
# (B12) run on a host buffer in place of shared memory, one member after
# another: at lanes = 1 by a one-thread group, at lanes = 32 by a warp of 32
# coroutine lanes (the warp body's layout and reductions).
GRID_LAUNCH = HOST_GROUP + HOST_WARP + r"""
// one member by the body of the header's family (a template, so that the
// other family's body is never instantiated)
REC_GLOBAL
SNAP_GLOBAL
template <bool CK, class Group>
void host_member(Group& g, float* sm, const float* y0, const float* params,
                 const Launch& L, int m, const Out& out, int compensated) {
  if constexpr (CK) {
    integrate_ck(g, sm, y0, params, L, m, out SNAP_ARG);
  } else if (compensated) {
    integrate<true>(g, sm, y0, params, L, m, out REC_ARG SNAP_ARG);
  } else {
    integrate<false>(g, sm, y0, params, L, m, out REC_ARG SNAP_ARG);
  }
}

struct HostGridMember {
  float* sm;
  const float* y0;
  const float* params;
  Launch L;
  int m;
  Out out;
  int compensated;
};
static HostGridMember g_member;

template <bool BLOCK>
static void grid_warp_lane(int r) {
  HostWarp<BLOCK> g{r};
  const HostGridMember& a = g_member;
  host_member<tab::CK>(g, a.sm, a.y0, a.params, a.L, a.m, a.out,
                       a.compensated);
}

extern "C" int fused_rk_grid_host(
    const float* y0, const float* params, float* y_out, int* status,
    int* nsteps, int* nfev,
    int members, float t0, float tf, float dir, float rtol, float atol,
    float h0, int use_hstart, float max_step, int max_steps,
    int compensated, int lanes, REC_DECL SNAP_DECL int block_order) {
  if (lanes != 1 && lanes != 32) return 1;
  REC_SET
  SNAP_SET
  const Launch L{t0, tf, dir, rtol, atol, h0, use_hstart, max_step,
                 max_steps};
  const Out out{y_out, status, nsteps, nfev};
  float* sm = new float[kFloats];
  char* stacks = static_cast<char*>(std::malloc(32 * kLaneStack));
  for (int m = 0; m < members; ++m) {
    if (lanes == 1) {
      HostGroup g;
      host_member<tab::CK>(g, sm, y0 + m * NF, params, L, m, out,
                           compensated);
    } else {
      g_member = HostGridMember{sm, y0 + m * NF, params, L, m, out,
                                compensated};
      run_lanes(32, block_order ? grid_warp_lane<true>
                                : grid_warp_lane<false>, stacks);
    }
  }
  std::free(stacks);
  delete[] sm;
  return 0;
}
"""
# B4 with the dense record takes its arrays and rows before block_order,
# and B4 and B12 with snapshots theirs after them (with the record's, null
# without it)
GRID_SNAP_LAUNCH = _with_snap(_with_record(GRID_LAUNCH, True), True,
                              "members")
GRID_RECORD_LAUNCH = _with_snap(_with_record(GRID_LAUNCH, True), False)
GRID_LAUNCH = _with_snap(_with_record(GRID_LAUNCH, False), False)

# The mid-size SWAG body (B8) integrate<W> run one member after another on
# a host buffer in place of shared memory: at lanes = 1 by a one-thread
# group whose sums return their values and one coefficient lane (W = 1); at
# lanes = 32 by a warp of 32 coroutine threads, the coefficient vectors
# spread over their lanes (W = 32, as on the card) and exchanged by the
# coroutine shfl, the member's elements all on thread 0 (so the norms sum
# in the one-thread order) and the block's sums and barriers handed round
# the warp.
ADAMS_GRID_LAUNCH = COROUTINES + r"""
struct HostBlock {
  int rank() const { return 0; }
  int size() const { return 1; }
  void sync() const {}
  template <int K>
  void sums(float (&)[K]) const {}
};

struct HostOneLane {
  int rank() const { return 0; }
  float shfl(float v, int) const { return v; }
};

static float g_sums[2][3][32];  // [turn][value][thread]

struct HostWarpBlock {
  int r;
  int turn = 0;
  int rank() const { return r == 0 ? 0 : N; }
  int size() const { return 1; }
  void sync() const {
    adams_lane_switch(&g_set->sp[r], g_set->sp[(r + 1) % g_set->G]);
  }
  template <int K>
  void sums(float (&v)[K]) {
    const int t = turn;
    turn ^= 1;
    for (int j = 0; j < K; ++j) g_sums[t][j][r] = v[j];
    sync();
    for (int j = 0; j < K; ++j) {
      float s = g_sums[t][j][0];
      for (int k = 1; k < 32; ++k) s = s + g_sums[t][j][k];
      v[j] = s;
    }
  }
};

struct HostGridMember {
  const float *y0, *yp0, *par;
  float h0;
  int nfev0;
  Launch L;
  int m;
  Out out;
  float* sm;
};
static HostGridMember g_grid;
REC_GLOBAL
SNAP_GLOBAL

static void warp_thread(int r) {
  HostWarpBlock g{r};
  HostLanes lanes{r};
  const HostGridMember& a = g_grid;
  integrate<32>(g, lanes, a.sm, a.y0, a.yp0, a.par, a.h0, a.nfev0, a.L, a.m,
                a.out REC_ARG SNAP_ARG);
}

extern "C" int fused_adams_grid_host(
    const float* y0, const float* params, const float* yp0, const float* h0,
    const int* nfev0, float* y_out, int* status, int* nsteps, int* nfev,
    int members, float t0, float tf, float dir, float rtol, float atol,
    float max_step, int max_steps, REC_DECL SNAP_DECL int lanes) {
  if (lanes != 1 && lanes != 32) return 1;
  const Launch L{t0, tf, dir, rtol, atol, max_step, max_steps};
  const Out out{y_out, status, nsteps, nfev};
  REC_SET
  SNAP_SET
  float* sm = new float[kFloats];
  char* stacks = static_cast<char*>(std::malloc(32 * kLaneStack));
  for (int m = 0; m < members; ++m) {
    if (lanes == 1) {
      HostBlock g;
      HostOneLane one;
      integrate<1>(g, one, sm, y0 + m * N, yp0 + m * N, params, h0[m],
                   nfev0[m], L, m, out REC_ARG SNAP_ARG);
    } else {
      g_grid = HostGridMember{y0 + m * N, yp0 + m * N, params, h0[m],
                              nfev0[m], L, m, out, sm};
      run_lanes(32, warp_thread, stacks);
    }
  }
  std::free(stacks);
  delete[] sm;
  return 0;
}
"""
ADAMS_GRID_SNAP_LAUNCH = _with_snap(_with_record(ADAMS_GRID_LAUNCH, True),
                                    True, "members")
ADAMS_GRID_RECORD_LAUNCH = _with_snap(
    _with_record(ADAMS_GRID_LAUNCH, True), False)
ADAMS_GRID_LAUNCH = _with_snap(_with_record(ADAMS_GRID_LAUNCH, False), False)

# The mid-size ESDIRK body (B7) run on a host buffer in place of shared
# memory, one member after another: at lanes = 1 by a one-thread group, at
# lanes = 32 by a warp of 32 coroutine lanes (the warp body's layout and
# reductions).
ESDIRK_GRID_LAUNCH = HOST_GROUP + HOST_WARP + r"""
struct HostEsdirkMember {
  float* sm;
  const float *y0, *yp0, *mass, *params;
  Launch Lc;
  int m;
  Out out;
  int compensated;
};
static HostEsdirkMember g_member;
REC_GLOBAL
SNAP_GLOBAL

template <class Group>
void host_member(Group& g, const HostEsdirkMember& a) {
  if (a.compensated) {
    integrate<true>(g, a.sm, a.y0, a.yp0, a.mass, a.params, a.Lc, a.m,
                    a.out REC_ARG SNAP_ARG);
  } else {
    integrate<false>(g, a.sm, a.y0, a.yp0, a.mass, a.params, a.Lc, a.m,
                     a.out REC_ARG SNAP_ARG);
  }
}

template <bool BLOCK>
static void esdirk_warp_lane(int r) {
  HostWarp<BLOCK> g{r};
  host_member(g, g_member);
}

extern "C" int fused_esdirk_grid_host(
    const float* y0, const float* yp0, const float* mass,
    const float* params, float* y_out,
    int* status, int* nsteps, int* nfev, int members, float t0, float tf,
    float rtol, float atol, float h0, int use_hstart, int have_yp0,
    float max_step, int max_steps, float tiny_err, int compensated,
    int lanes, REC_DECL SNAP_DECL int block_order) {
  if (lanes != 1 && lanes != 32) return 1;
  REC_SET
  SNAP_SET
  const Launch Lc{t0, tf, rtol, atol, h0, use_hstart, have_yp0, max_step,
                  max_steps, tiny_err};
  const Out out{y_out, status, nsteps, nfev};
  float* sm = new float[kFloats];
  char* stacks = static_cast<char*>(std::malloc(32 * kLaneStack));
  for (int m = 0; m < members; ++m) {
    g_member = HostEsdirkMember{sm, y0 + m * N, yp0 ? yp0 + m * N : nullptr,
                                mass, params, Lc, m, out, compensated};
    if (lanes == 1) {
      HostGroup g;
      host_member(g, g_member);
    } else {
      run_lanes(32, block_order ? esdirk_warp_lane<true>
                                : esdirk_warp_lane<false>, stacks);
    }
  }
  std::free(stacks);
  delete[] sm;
  return 0;
}
"""
# B7 with the dense record takes its arrays and rows before block_order,
# and with snapshots theirs after them (with the record's, null without it)
ESDIRK_GRID_SNAP_LAUNCH = _with_snap(_with_record(ESDIRK_GRID_LAUNCH, True),
                                     True, "members")
ESDIRK_GRID_RECORD_LAUNCH = _with_snap(
    _with_record(ESDIRK_GRID_LAUNCH, True), False)
ESDIRK_GRID_LAUNCH = _with_snap(_with_record(ESDIRK_GRID_LAUNCH, False),
                                False)

# B11's body runs one member after another: at one lane the
# thread-per-member body integrate_thread, at G lanes the group body
# integrate<G> with the lanes as coroutines that hand over at each shuffle
# (the assessments' quotients, the step control's quotients).  The CUDA
# group and kernel after the marker are left out.
CK_LAUNCH = COROUTINES + r"""
struct HostCkMember {
  const float* y0;
  const float* par;
  Launch L;
  int m;
  Out out;
};
static HostCkMember g_ck;
SNAP_GLOBAL

template <int G>
static void ck_lane(int rank) {
  HostLanes lane{rank};
  integrate<G>(lane, g_ck.y0, g_ck.par, g_ck.L, g_ck.m, g_ck.out SNAP_ARG);
}

extern "C" int fused_ckdisc_launch(
    const void* y0, const void* params, void* y_out, void* status,
    void* nstep, void* nfev, int B, float t0, float tf, float rtol,
    float atol, float h0, int use_hstart, float max_step, int max_steps,
    int lanes, int block_members, SNAP_DECL void* stream) {
  const Out out{(float*)y_out, (int*)status, (int*)nstep, (int*)nfev};
  const Launch L{t0, tf, rtol, atol, h0, max_step, use_hstart, max_steps};
  SNAP_SET
  void (*body)(int) = lanes == 2 ? ck_lane<2>
                      : lanes == 4 ? ck_lane<4>
                      : lanes == 8 ? ck_lane<8>
                      : lanes == 16 ? ck_lane<16>
                      : lanes == 32 ? ck_lane<32> : nullptr;
  if (lanes != 1 && body == nullptr) return 1;
  char* stacks = lanes > 1 ? static_cast<char*>(
      std::malloc(static_cast<size_t>(lanes) * kLaneStack)) : nullptr;
  const float* y0f = (const float*)y0;
  for (int m = 0; m < B; ++m) {
    const float* y0m = y0f + static_cast<size_t>(m) * N;
    const float* parm = (const float*)params + m * tab::NPAR;
    if (lanes == 1) {
      integrate_thread(y0m, parm, L, m, out SNAP_ARG);
    } else {
      g_ck = HostCkMember{y0m, parm, L, m, out};
      run_lanes(lanes, body, stacks);
    }
  }
  std::free(stacks);
  return 0;
}
"""
# B11 with snapshots takes their arrays after block_members, as
# fused_ckdisc_snap_launch does
CK_SNAP_LAUNCH = _with_snap(CK_LAUNCH, True)
CK_LAUNCH = _with_snap(CK_LAUNCH, False)

# label -> (problem, k_max) of each SWAG build; the cases of
# test_torch_fused_adams.py, and the bench line's k_max = 12
ADAMS_VARIANTS = {"vdp": ("vdp5", 6), "osc_comp": ("osc", 4),
                  "decay_1e6": ("decay", 6), "bench": ("vdp1e3", 4),
                  "bench12": ("vdp1e3", 12)}
ADAMS_CASES = dict(TA.CASES, bench12=(
    "vdp1e3", (0.0, 0.05), TA.X0,
    dict(rtol=1e-6, atol=1e-9, k_max=12, compensated=True)))

# label -> (problem, k_max) of each mid-size SWAG build
ADAMS_GRID_VARIANTS = {"ag_heat4": ("heat", 4), "ag_heat3": ("heat", 3),
                       "ag_skew3": ("skew", 3),
                       "ag_cubic4": ("heat_cubic", 4)}

# label -> (problem, method) of each mid-size ESDIRK build
ESDIRK_GRID_VARIANTS = {"eg_rd_kv3i": ("rdiff", "Kv3I"),
                        "eg_rd_trbdf2": ("rdiff", "TRBDF2"),
                        "eg_dae": ("dae", "Kv3I"),
                        "eg_skew": ("skew", "TRBDF2"),
                        "eg_cubic": ("cubic", "Kv3I")}

ESDIRK_VARIANTS = {           # label -> (problem, method, M)
    "rob_kv3i": ("rob", "Kv3I", None),
    "rob_trbdf2": ("rob", "TRBDF2", None),
    "pend": ("pend", "Kv3I", T.M_PEND),
    "kaps_hidden": ("kaps_hidden", "TRBDF2", T.M_HIDDEN),
}
# label -> (problem, method, base block): B2 with per-member params, and
# its simultaneous corrector on Robertson's variational system
ESDIRK_PARAM_VARIANTS = {"stiff_params": ("stiff_p", "Kv3I", None),
                         "rob_block": ("rob_aug", "TRBDF2", 3)}
VARIANT_OF = {"rob_kv3i": "rob_kv3i", "rob_kv3i_comp": "rob_kv3i",
              "rob_trbdf2": "rob_trbdf2", "pend_dae": "pend",
              "kaps_hidden": "kaps_hidden", "stiff_params": "stiff_params",
              "rob_block": "rob_block"}
# B1 with a per-member mu, and on Van der Pol's variational system for mu
# and y0 (ops.solve_fused_sens's)
ERK_PARAM_RHS = {"vdp_params": TK.PROBLEMS["vdp_p"],
                 "vdp_variational": _aug_rhs(TK.PROBLEMS["vdp_p"], 2, 1, 2)}
# B4 with a growth rate a member and on the variational system of the
# periodic Fisher MoL (whose roll in the base block wraps within its 64
# states only where the user's namespace has its own grid), B7 with (k, D)
# a member and its simultaneous corrector on the reaction-diffusion's
# variational system: label -> (kernel, FusedGridRHS, method, base block)
GRID_PARAM_RHS = {
    "grid_fisher_params": ("fused_rk_grid", TG.FISHER_P, "BS5", None),
    "grid_fisher_variational": ("fused_rk_grid",
                                _aug_grid_rhs(TG.FISHER_P, TG.N_P, 1), "BS5",
                                None),
    "eg_rd_params": ("fused_esdirk_grid", TEG.RD_P, "Kv3I", None),
    "eg_rd_block": ("fused_esdirk_grid", _aug_grid_rhs(TEG.RD_P, TEG.N_P, 2),
                    "TRBDF2", TEG.N_P)}
# the builds of the dense record of B2, B7, B5 and B6 and of the params of
# B5 and B6: label -> (kernel, right-hand side, method (B2: with the
# problem whose mass matrix it takes), base block, record)
ROUTE_BUILDS = {
    "rob_trbdf2_rec": ("fused_esdirk", T.PROBLEMS["rob"], ("TRBDF2", "rob"),
                       None, True),
    "pend_rec": ("fused_esdirk", T.PROBLEMS["pend"], ("Kv3I", "pend"), None,
                 True),
    "kaps_hidden_rec": ("fused_esdirk", T.PROBLEMS["kaps_hidden"],
                        ("TRBDF2", "kaps_hidden"), None, True),
    "rob_block_rec": ("fused_esdirk", T.PROBLEMS["rob_aug"],
                      ("TRBDF2", "rob_aug"), 3, True),
    "eg_dae_rec": ("fused_esdirk_grid", TEG.RHS["dae"], "Kv3I", None, True),
    "eg_rd_params_rec": ("fused_esdirk_grid", TEG.RD_P, "Kv3I", None, True),
    "eg_rd_block_rec": ("fused_esdirk_grid",
                        _aug_grid_rhs(TEG.RD_P, TEG.N_P, 2), "TRBDF2",
                        TEG.N_P, True),
    "rkn_osc_p": ("fused_rkn", TDR.OSC_P, None, None, False),
    "rkn_osc_p_rec": ("fused_rkn", TDR.OSC_P, None, None, True),
    "grid_wave_p": ("fused_rk_grid", TDR.WAVE_P, None, None, False),
    "grid_wave_p_rec": ("fused_rk_grid", TDR.WAVE_P, None, None, True),
}
# B3 and B8 with a parameter a member, with and without the dense record
# (k_max = 6): label -> (right-hand side, record)
SWAG_BUILDS = {"swag_vdp_p": (TAR.VDP_P, False),
               "swag_vdp_p_rec": (TAR.VDP_P, True),
               "ag_heat_p": (TAR.HEAT_P, False),
               "ag_heat_p_rec": (TAR.HEAT_P, True)}
# the builds of the t_eval snapshots (B1, B4, B11, B12) and of B11's and
# B12's params, each beside the build without the snapshots: label ->
# (kernel, right-hand side, record, snapshots)
TEVAL_BUILDS = {
    "erk_vdp5": ("fused_erk", TT.RHS["vdp5"], False, False),
    "erk_vdp5_snap": ("fused_erk", TT.RHS["vdp5"], False, True),
    "erk_vdp_p_rec_snap": ("fused_erk", TT.RHS["vdp_p"], True, True),
    "grid_adv": ("fused_rk_grid", TT.RHS["adv"], False, False),
    "grid_adv_snap": ("fused_rk_grid", TT.RHS["adv"], False, True),
    "ck_decay_p": ("fused_ckdisc", TT.RHS["decay_p"], False, False),
    "ck_decay_p_snap": ("fused_ckdisc", TT.RHS["decay_p"], False, True),
    "ck_sink_p": ("ck_grid", TT.RHS["sink_p"], False, False),
    "ck_sink_p_snap": ("ck_grid", TT.RHS["sink_p"], False, True),
}
# the snapshot builds of B5, B6, B2 (behind the hidden M, so that its rows
# go back to the user's coordinates) and B7, each beside an earlier build
# without the switch on the same source: label -> (kernel, build without
# the snapshots)
TEVAL_ROUTE_BUILDS = {"rkn_cubic_snap": ("fused_rkn", "rkn_cubic"),
                      "grid_wave_snap": ("fused_rk_grid", "grid_wave"),
                      "kaps_hidden_snap": ("fused_esdirk", "kaps_hidden"),
                      "eg_rd_kv3i_snap": ("fused_esdirk_grid",
                                          "eg_rd_kv3i")}
# the snapshot builds of B3 (vdp plain, the compensated oscillator), B8
# (the heat MoL whose whole run repeats the plain version's arithmetic)
# and of the RKC body (B9 and B10: the params Brusselator with the rho
# callback), each the header of its build without the snapshots with the
# switch set: label -> (kernel, label of that build)
TEVAL_ADAMS_RKC_BUILDS = {
    "adams_vdp_snap": ("fused_adams", "adams_vdp"),
    "adams_osc_comp_snap": ("fused_adams", "adams_osc_comp"),
    "ag_heat3_snap": ("fused_adams_grid", "ag_heat3"),
    "rkc_snap": ("fused_rkc", "rkc")}
VDP_TEMPLATE = FK.FusedRHS(
    TK.PROBLEMS["vdp"].torch_fn,
    "template <class T>\n__device__ void rhs(T t, const T* y, T* dy) {\n"
    "  dy[0] = y[1];\n"
    "  dy[1] = 3.0f * (1.0f - y[0] * y[0]) * y[1] - y[0];\n}", 2)


def _compile(name, header, launch, out_dir, cut='extern "C"'):
    src = (_build.CSRC / f"{name}.cu").read_text()
    for inc in ("#include <cuda_runtime.h>",
                "#include <cooperative_groups.h>"):
        src = src.replace(inc, "")
    src = src[:src.index(cut)] + launch
    out_dir.mkdir(parents=True)
    (out_dir / "shim.h").write_text(SHIM)
    (out_dir / f"{name}_config.cuh").write_text(header)
    (out_dir / "kernel.cpp").write_text(src)
    so = out_dir / "lib.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-Wno-unknown-pragmas", "-include",
                    str(out_dir / "shim.h"), "-I", str(out_dir), "-I",
                    str(_build.CSRC), "-o", str(so),
                    str(out_dir / "kernel.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every kernel variant built for the host, in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    d = tmp_path_factory.mktemp("csrc_host")
    jobs = {}
    for label, (prob, meth, M) in ESDIRK_VARIANTS.items():
        rhs = T.PROBLEMS[prob]
        header = _build.fused_esdirk_header(
            FE._esdirk_consts(T.METHODS[meth]), *FE._mass_setup(M, rhs.n),
            rhs.n, rhs.cuda_src)
        jobs[label] = ("fused_esdirk", header, ESDIRK_LAUNCH, RKC_MARKER)
    for label, (prob, meth, nb) in ESDIRK_PARAM_VARIANTS.items():
        rhs = T.PROBLEMS[prob]
        jobs[label] = ("fused_esdirk", _build.fused_esdirk_header(
            FE._esdirk_consts(T.METHODS[meth]), None, None, rhs.n,
            rhs.cuda_src, rhs.k, nb), ESDIRK_LAUNCH, RKC_MARKER)
    for label, rhs in (("vdp", TK.PROBLEMS["vdp"]),
                       ("vdp_template", VDP_TEMPLATE),
                       *ERK_PARAM_RHS.items()):
        header = _build.fused_erk_header(FK._fused_consts(TK.BS5), rhs.n,
                                         rhs.cuda_src, rhs.k)
        jobs[label] = ("fused_erk", header, ERK_LAUNCH, RKC_MARKER)
    for label, (prob, km) in ADAMS_VARIANTS.items():
        rhs = TA.PROBLEMS[prob]
        jobs["adams_" + label] = (
            "fused_adams",
            _build.fused_adams_header(FA._adams_consts(km, rhs.n),
                                      rhs.cuda_src), ADAMS_LAUNCH,
            RKC_MARKER)
    rkc_p = pde.brusselator_2d_grid(RKC_SHAPE, B=None)
    jobs["rkc"] = ("fused_rkc", _build.fused_rkc_header(
        rkc_p.shape, 1, rkc_p.cuda_src, TR.RHO_FN.cuda_src), RKC_LAUNCH,
        RKC_MARKER)
    jobs["rkn_kepler"] = ("fused_rkn", _build.fused_rkn_header(
        FN.rkn_consts(TN.Fi5N), 2, TN.KEPLER.cuda_src), RKN_LAUNCH,
        RKC_MARKER)
    cubic = TN.CARD_PROBLEMS["cubic"]
    jobs["rkn_cubic"] = ("fused_rkn", _build.fused_rkn_header(
        FN.rkn_consts(TN.Fi5N), cubic.m, cubic.cuda_src), RKN_LAUNCH,
        RKC_MARKER)
    jobs["grid_wave"] = ("fused_rk_grid", _build.fused_rk_grid_header(
        FN.rkn_consts(TN.Fi5N), True, (TN.N_GRID,), TN.WAVE_CUDA),
        GRID_LAUNCH, RKC_MARKER)
    jobs["grid_fisher"] = ("fused_rk_grid", _build.fused_rk_grid_header(
        FK._fused_consts(TK.BS5), False, (TG.N,), TG.RHS["fisher"].cuda_src),
        GRID_LAUNCH, RKC_MARKER)
    for prob in ("swdec", "rational", "cubic"):
        jobs["ck_" + prob] = ("fused_ckdisc", _build.fused_ckdisc_header(
            FC.ck_consts(), TC.RHS[prob].n, TC.RHS[prob].cuda_src),
            CK_LAUNCH, RKC_MARKER)
    for prob in ("mol", "diffusion"):
        jobs["ck_" + prob] = ("fused_rk_grid", _build.fused_rk_grid_header(
            FC.ck_consts(), False, TC.RHS[prob].shape,
            TC.RHS[prob].cuda_src), GRID_LAUNCH, RKC_MARKER)
    for label, (prob, meth) in ESDIRK_GRID_VARIANTS.items():
        rhs = TEG.RHS[prob]
        jobs[label] = ("fused_esdirk_grid", _build.fused_esdirk_grid_header(
            FE._esdirk_consts(TEG.METHODS[meth]), rhs.shape, rhs.cuda_src),
            ESDIRK_GRID_LAUNCH, RKC_MARKER)
    for label, (kernel, rhs, meth, nb) in GRID_PARAM_RHS.items():
        if kernel == "fused_rk_grid":
            header = _build.fused_rk_grid_header(
                FK._fused_consts(TK.BS5), False, rhs.shape, rhs.cuda_src,
                rhs.k)
            launch = GRID_LAUNCH
        else:
            header = _build.fused_esdirk_grid_header(
                FE._esdirk_consts(TEG.METHODS[meth]), rhs.shape,
                rhs.cuda_src, rhs.k, nb)
            launch = ESDIRK_GRID_LAUNCH
        jobs[label] = (kernel, header, launch, RKC_MARKER)
    vdp_p, fis_p = TK.PROBLEMS["vdp_p"], TG.FISHER_P
    jobs["vdp_params_rec"] = ("fused_erk", _build.fused_erk_header(
        FK._fused_consts(TK.BS5), vdp_p.n, vdp_p.cuda_src, vdp_p.k, True),
        ERK_RECORD_LAUNCH, RKC_MARKER)
    jobs["grid_fisher_params_rec"] = (
        "fused_rk_grid", _build.fused_rk_grid_header(
            FK._fused_consts(TK.BS5), False, fis_p.shape, fis_p.cuda_src,
            fis_p.k, True), GRID_RECORD_LAUNCH, RKC_MARKER)
    for label, (kernel, rhs, meth, nb, rec) in ROUTE_BUILDS.items():
        if kernel == "fused_esdirk":
            M = dict(pend=T.M_PEND, kaps_hidden=T.M_HIDDEN).get(meth[1])
            header = _build.fused_esdirk_header(
                FE._esdirk_consts(T.METHODS[meth[0]]),
                *FE._mass_setup(M, rhs.n), rhs.n, rhs.cuda_src, rhs.k, nb,
                rec)
            launch = ESDIRK_RECORD_LAUNCH
        elif kernel == "fused_esdirk_grid":
            header = _build.fused_esdirk_grid_header(
                FE._esdirk_consts(TEG.METHODS[meth]), rhs.shape,
                rhs.cuda_src, rhs.k, nb, rec)
            launch = ESDIRK_GRID_RECORD_LAUNCH
        elif kernel == "fused_rkn":
            header = _build.fused_rkn_header(FN.rkn_consts(TN.Fi5N), rhs.m,
                                             rhs.cuda_src, rhs.k, rec)
            launch = RKN_RECORD_LAUNCH if rec else RKN_LAUNCH
        else:
            header = _build.fused_rk_grid_header(
                FN.rkn_consts(TN.Fi5N), True, (rhs.n,), rhs.cuda_src, rhs.k,
                rec)
            launch = GRID_RECORD_LAUNCH if rec else GRID_LAUNCH
        jobs[label] = (kernel, header, launch, RKC_MARKER)
    for label, (prob, km) in ADAMS_GRID_VARIANTS.items():
        rhs = TAG.RHS[prob]
        jobs[label] = ("fused_adams_grid", _build.fused_adams_header(
            FA._adams_consts(km, rhs.shape[0]), rhs.cuda_src, rhs.shape),
            ADAMS_GRID_LAUNCH, RKC_MARKER)
    for label, (rhs, rec) in SWAG_BUILDS.items():
        if isinstance(rhs, FK.FusedRHS):
            jobs[label] = ("fused_adams", _build.fused_adams_header(
                FA._adams_consts(6, rhs.n), rhs.cuda_src, None, rhs.k, rec),
                ADAMS_RECORD_LAUNCH if rec else ADAMS_LAUNCH, RKC_MARKER)
        else:
            jobs[label] = ("fused_adams_grid", _build.fused_adams_header(
                FA._adams_consts(6, rhs.shape[0]), rhs.cuda_src, rhs.shape,
                rhs.k, rec),
                ADAMS_GRID_RECORD_LAUNCH if rec else ADAMS_GRID_LAUNCH,
                RKC_MARKER)
    for label, (kernel, rhs, rec, snap) in TEVAL_BUILDS.items():
        if kernel == "fused_erk":
            header = _build.fused_erk_header(FK._fused_consts(TK.BS5), rhs.n,
                                             rhs.cuda_src, rhs.k, rec, snap)
            launch = (ERK_SNAP_LAUNCH if snap else
                      ERK_RECORD_LAUNCH if rec else ERK_LAUNCH)
        elif kernel == "fused_ckdisc":
            header = _build.fused_ckdisc_header(FC.ck_consts(), rhs.n,
                                                rhs.cuda_src, rhs.k, snap)
            launch = CK_SNAP_LAUNCH if snap else CK_LAUNCH
        else:
            consts = (FC.ck_consts() if kernel == "ck_grid"
                      else FK._fused_consts(TK.BS5))
            kernel = "fused_rk_grid"
            header = _build.fused_rk_grid_header(consts, False, rhs.shape,
                                                 rhs.cuda_src, rhs.k, rec,
                                                 snap)
            launch = GRID_SNAP_LAUNCH if snap else GRID_LAUNCH
        jobs[label] = (kernel, header, launch, RKC_MARKER)
    snap_launch = {"fused_rkn": RKN_SNAP_LAUNCH,
                   "fused_rk_grid": GRID_SNAP_LAUNCH,
                   "fused_esdirk": ESDIRK_SNAP_LAUNCH,
                   "fused_esdirk_grid": ESDIRK_GRID_SNAP_LAUNCH,
                   "fused_adams": ADAMS_SNAP_LAUNCH,
                   "fused_adams_grid": ADAMS_GRID_SNAP_LAUNCH,
                   "fused_rkc": RKC_SNAP_LAUNCH}
    for label, (kernel, off) in {**TEVAL_ROUTE_BUILDS,
                                 **TEVAL_ADAMS_RKC_BUILDS}.items():
        # the header of the build without the switch, with it set
        header = jobs[off][1].replace("constexpr bool SNAP = false;",
                                      "constexpr bool SNAP = true;")
        assert header != jobs[off][1]
        jobs[label] = (kernel, header, snap_launch[kernel], RKC_MARKER)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_compile, *v[:3], d / k, *v[3:])
                   for k, v in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _esdirk_host(lib, case, lanes=1, **over):
    """The host-built ESDIRK kernel on ``case`` at ``lanes`` lanes per
    member."""
    if lanes > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host lane group switches x86-64 stacks")
    prob, meth, span, y0, yp0, M, kw = {**T.CASES, **T.PARAM_CASES}[case]
    kw = dict(kw, **over)
    kw.pop("block_base", None)          # the build's
    rows = kw.pop("rows", 0)
    t_eval = kw.pop("t_eval", None)
    par = T.PARAMS.get(case)
    if par is not None:
        par = np.ascontiguousarray(par, np.float32)
    rtol, atol = kw.pop("rtol"), kw.pop("atol")
    comp = kw.pop("compensated", False)
    max_steps = kw.pop("max_steps", 100_000)
    first_step = kw.pop("first_step", None)
    assert not kw
    y0 = np.ascontiguousarray(y0, np.float32)
    nb, n = y0.shape
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    t0, tf = np.float32(span[0]), np.float32(span[1])
    yp = None if yp0 is None else np.ascontiguousarray(yp0, np.float32)
    fn = lib.fused_esdirk_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    snap = _HostSnap(t_eval, span, y0)
    rec = _HostRecord(y0, rows, snap.points is not None)
    fn.argtypes = ([vp] * 7 + [ci, cf, cf, cf, cf, cf, ci, ci, cf, ci, cf,
                               ci, ci, ci] + rec.argtypes + snap.argtypes
                   + [vp])
    rc = fn(y0.ctypes.data, None if yp is None else yp.ctypes.data,
            None if par is None else par.ctypes.data, out.ctypes.data,
            st.ctypes.data, ns.ctypes.data, nf.ctypes.data, nb, float(t0),
            float(tf), rtol, atol,
            float(np.float32(0.01) * abs(tf - t0) if first_step is None
                  else np.float32(first_step)),
            int(M is None and first_step is None), int(yp is not None),
            np.inf, max_steps, FE._tiny_err(n, rtol), int(comp), lanes,
            128 // lanes, *rec.args(), *snap.args(), None)
    assert rc == 0
    return (out, st, ns, nf) + rec.arrays() + snap.arrays()


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# rob_kv3i 3.6e-7, 1, 6; rob_kv3i_comp 3.7e-9, 1, 13; rob_trbdf2 1.7e-6,
# 1, 2; pend_dae 4.8e-6, 1, 11; kaps_hidden 6.7e-7, 0, 4; stiff_params
# (a parameter a member) 1.8e-6, 0, 1; rob_block (the simultaneous
# corrector on Robertson's variational system) 1.2e-7, 0, 0.  Gates about
# 2x.
GATES = [("rob_kv3i", 1e-6, 2, 12), ("rob_kv3i_comp", 1e-8, 2, 26),
         ("rob_trbdf2", 4e-6, 2, 4), ("pend_dae", 1e-5, 2, 22),
         ("kaps_hidden", 2e-6, 1, 8), ("stiff_params", 4e-6, 1, 2),
         ("rob_block", 3e-7, 1, 2)]


# the multi-lane groups each SWAG case also runs under, besides one lane
ADAMS_LANES = {"vdp": (4, 32), "osc_comp": (4, 32), "bench12": (4, 32)}


def _over_lanes(params, lanes=ADAMS_LANES):
    """Each parameter tuple at one lane (under its old id) and at the
    case's multi-lane groups (``lanes``: case -> lane counts)."""
    out = []
    for p in params:
        base = "-".join(str(x) for x in p)
        out.append(pytest.param(*p, 1, id=base))
        out += [pytest.param(*p, g, id=f"{base}-lanes{g}")
                for g in lanes.get(p[0], ())]
    return out


# the lane groups each ESDIRK case also runs under, besides one lane
ESDIRK_LANES = (4, 8)
# the plain version of a case, run once for its lane counts
_plain_esdirk = functools.lru_cache(maxsize=None)(T._port)


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers,lanes", _over_lanes(
    GATES, {case: ESDIRK_LANES for case, *_ in GATES}))
def test_esdirk_kernel_matches_plain_version(libs, case, y_gate, dsteps,
                                             nmembers, lanes):
    y, st, ns, nf = _esdirk_host(libs[VARIANT_OF[case]], case, lanes)
    ry, rst, rns, rnf = _plain_esdirk(case)
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts", [("pend_dae", 1),
                                           ("kaps_hidden", 3)])
def test_esdirk_kernel_first_attempts_bit_identical(libs, case, attempts):
    """Without a starting-step estimate, the kernel's first attempts (the
    dual-number Jacobian, the factor, Newton, the error and the controller
    up to its powf) repeat the plain version's arithmetic bit for bit."""
    y, st, ns, nf = _esdirk_host(libs[VARIANT_OF[case]], case,
                                 max_steps=attempts)
    ry, rst, rns, rnf = T._port(case, max_steps=attempts)
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(st, rst)
    np.testing.assert_array_equal(ns, rns)
    np.testing.assert_array_equal(nf, rnf)


@pytest.mark.parametrize("lanes", ESDIRK_LANES)
@pytest.mark.parametrize("case", list(VARIANT_OF))
def test_esdirk_lane_body_bit_identical_to_thread_body(libs, case, lanes):
    """B2's group body, each member's Jacobian columns spread over 4 and 8
    lanes (coroutines that hand over at each shuffle) and everything else
    computed by every lane, gives the thread body's y, status, nsteps and
    nfev bit for bit over the whole runs (pendulum DAE, Robertson plain
    and compensated, TRBDF2's filtered error, the hidden-M Kaps
    problem)."""
    lib = libs[VARIANT_OF[case]]
    for a, b in zip(_esdirk_host(lib, case, lanes), _esdirk_host(lib, case)):
        np.testing.assert_array_equal(a, b)


def _small_host(lib, name, span, y0, lanes=1, params=None, rows=0,
                t_eval=None, **kw):
    """The host-built B1 (``name`` fused_erk) or B5 (fused_rkn) on ``y0``
    (with the members' ``params`` or none) by one thread per member (lanes
    = 1) or ``lanes`` coroutine lanes; a build with the dense record takes
    ``rows`` and returns the record's arrays after the outputs, and a build
    with snapshots takes ``t_eval`` and returns ``y_eval`` last."""
    if lanes > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host lane group switches x86-64 stacks")
    y0 = np.ascontiguousarray(y0, np.float32)
    nb = y0.shape[0]
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    fn = getattr(lib, f"{name}_launch")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    first = [y0.ctypes.data]
    if params is not None:
        params = np.ascontiguousarray(params, np.float32)
    first.append(None if params is None else params.ctypes.data)
    snap = _HostSnap(t_eval, span, y0)
    rec = _HostRecord(y0, rows, snap.points is not None)
    fn.argtypes = ([vp] * (4 + len(first)) + [ci, cf, cf, cf, cf, cf, ci, cf,
                                              ci, ci, ci, ci]
                   + rec.argtypes + snap.argtypes + [vp])
    rc = fn(*first, out.ctypes.data, st.ctypes.data, ns.ctypes.data,
            nf.ctypes.data, nb,
            *FK.launch_args(span, kw["rtol"], kw["atol"],
                            kw.get("first_step"),
                            kw.get("max_steps", 100_000),
                            kw.get("compensated", False), None),
            lanes, max(1, 128 // lanes), *rec.args(), *snap.args(), None)
    assert rc == 0
    return (out, st, ns, nf) + rec.arrays() + snap.arrays()


class _HostRecord:
    """The dense record's arrays of a host launch at ``rows`` a member
    (none at 0), filled with NaN so that a row the kernel leaves shows; a
    snapshot launch (``declared``) takes the record's arguments also
    without rows, null with rows 0."""

    def __init__(self, y0, rows, declared=False):
        nb, n = y0.shape
        self.rows = rows
        self.t = np.full((nb, rows), np.nan, np.float32)
        self.y = np.full((nb, rows, n), np.nan, np.float32)
        self.f = np.full((nb, rows, n), np.nan, np.float32)
        self.f0 = np.full((nb, n), np.nan, np.float32)
        self.n = np.full(nb, -1, np.int32)
        self.declared = bool(rows) or declared
        self.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                         if self.declared else [])

    def args(self):
        if not self.rows:
            return (None,) * 5 + (0,) if self.declared else ()
        return (self.t.ctypes.data, self.y.ctypes.data, self.f.ctypes.data,
                self.f0.ctypes.data, self.n.ctypes.data, self.rows)

    def arrays(self):
        return ((self.t, self.y, self.f, self.f0, self.n) if self.rows
                else ())


class _HostSnap:
    """The t_eval arrays of a host snapshot launch (none for ``t_eval``
    None): the points sorted as the wrappers sort them
    (``ops.fused_erk.SnapPoints``), y_eval filled with NaN so that a row
    the kernel leaves shows."""

    def __init__(self, t_eval, span, y0):
        tq = FK.eval_points(t_eval)
        self.points = (None if tq is None else
                       FK.SnapPoints(tq, span, torch.from_numpy(y0)))
        self.argtypes = []
        if self.points is not None:
            self.points.y.fill_(float("nan"))
            self.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]

    def args(self):
        return () if self.points is None else self.points.args()

    def arrays(self):
        return () if self.points is None else (self.points.y.numpy(),)


def _erk_host(lib, span, y0, **kw):
    return _small_host(lib, "fused_erk", span, y0, **kw)


@pytest.mark.parametrize("label", ["vdp", "vdp_template"])
@pytest.mark.parametrize("case", ["vdp_plain", "vdp_compensated"])
def test_erk_kernel_matches_plain_version(libs, label, case):
    """The explicit kernel on the shared headers, with a plain and with a
    template right-hand side.  Measured: |dy| <= 1.5e-6, identical step
    counts, one member 7 RHS evaluations apart (compensated)."""
    prob, meth, span, y0, kw = TK.CASES[case]
    y, st, ns, nf = _erk_host(libs[label], span, y0, **kw)
    ry, rst, rns, rnf = (r.numpy() for r in FK.fused_erk_reference(
        TK.PROBLEMS[prob], span, torch.tensor(y0), method=TK.BS5, **kw))
    np.testing.assert_array_equal(st, rst)
    assert np.max(np.abs(y - ry)) <= 3e-6
    np.testing.assert_array_equal(ns, rns)
    assert np.max(np.abs(nf - rnf)) <= 14


# the lane counts of B1's and B5's group bodies
SMALL_LANES = (2, 4, 8)


@pytest.mark.parametrize("lanes", SMALL_LANES)
@pytest.mark.parametrize("label", ["vdp", "vdp_template"])
@pytest.mark.parametrize("case", ["vdp_plain", "vdp_compensated"])
def test_erk_lane_body_bit_identical_to_thread_body(libs, label, case,
                                                    lanes):
    """B1's group body, each member's norm divisions and finiteness tests
    split over 2, 4 and 8 lanes (coroutines that hand over at each
    shuffle; BS5 leaves one controller power, which every lane computes),
    gives the thread body's y, status, nsteps and nfev bit for bit over
    whole runs, with a plain and a template right-hand side."""
    prob, meth, span, y0, kw = TK.CASES[case]
    for a, b in zip(_erk_host(libs[label], span, y0, lanes=lanes, **kw),
                    _erk_host(libs[label], span, y0, **kw)):
        np.testing.assert_array_equal(a, b)


def _erk_params_case(label):
    """B1's params cases: the mu sweep of test_torch_fused_erk.py (y0 =
    (2, 0), mu in [1, 2]) on Van der Pol, and on its variational system
    from (y0, 0, I)."""
    y0 = TK.VDPP0
    if label == "vdp_variational":
        y0 = np.concatenate([y0, np.zeros_like(y0), np.tile(
            np.eye(2, dtype=np.float32).reshape(1, 4), (len(y0), 1))], 1)
    return y0, TK.MUS, dict(rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("label,y_gate", [("vdp_params", 6e-6),
                                          ("vdp_variational", 1.2e-4)])
def test_erk_params_kernels_match_plain_version(libs, label, y_gate):
    """B1 with a parameter a member, and on the variational system whose
    tangent rows the kernel takes on dual numbers, against the plain
    version (torch.func.jvp for the tangents).  Measured: |dy| 3.0e-6 and
    6.0e-5 (the tangent rows, |s| up to ~6), identical counts."""
    y0, mus, kw = _erk_params_case(label)
    y, st, ns, nf = _erk_host(libs[label], (0.0, 3.0), y0, params=mus, **kw)
    ry, rst, rns, rnf = (r.numpy() for r in FK.fused_erk_reference(
        ERK_PARAM_RHS[label], (0.0, 3.0), torch.tensor(y0),
        params=torch.tensor(mus), method=TK.BS5, **kw))
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    np.testing.assert_array_equal(ns, rns)
    np.testing.assert_array_equal(nf, rnf)


@pytest.mark.parametrize("lanes", SMALL_LANES)
@pytest.mark.parametrize("label", list(ERK_PARAM_RHS))
def test_erk_params_lane_body_bit_identical_to_thread_body(libs, label,
                                                           lanes):
    """The params and variational builds of B1 on 2, 4 and 8 coroutine
    lanes per member: the thread body's results bit for bit."""
    y0, mus, kw = _erk_params_case(label)
    for a, b in zip(_erk_host(libs[label], (0.0, 3.0), y0, lanes=lanes,
                              params=mus, **kw),
                    _erk_host(libs[label], (0.0, 3.0), y0, params=mus,
                              **kw)):
        np.testing.assert_array_equal(a, b)


def _adams_host(lib, case, lanes=1, **over):
    """The host-built SWAG kernel on ``case`` at ``lanes`` lanes per member,
    started from the float32 stepper's init as the wrapper starts it."""
    prob, span, y0, kw = ADAMS_CASES[case]
    return _swag_host(lib, TA.PROBLEMS[prob], span, y0, lanes,
                      **dict(kw, **over))


def _swag_host(lib, rhs, span, y0, lanes=1, params=None, rows=0,
               t_eval=None, **kw):
    """The host-built B3 on ``y0`` (with the members' ``params`` or none)
    at ``lanes`` lanes per member, started from the float32 stepper's init
    on the bound function as the wrapper starts it: (y, status, nsteps,
    nfev, work), with ``rows`` the record's arrays after them, and a build
    with snapshots takes ``t_eval`` and returns ``y_eval`` last."""
    if lanes > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host lane group switches x86-64 stacks")
    y0 = np.ascontiguousarray(y0, np.float32)
    nb = y0.shape[0]
    if params is not None:
        params = np.ascontiguousarray(params, np.float32)
    _, s0, direction = FA._host_init(
        FK.bind_params(rhs, None if params is None
                       else torch.tensor(params)), span, torch.tensor(y0).T,
        kw["rtol"], kw["atol"], kw.get("first_step"), kw["k_max"], None)
    yp0 = np.ascontiguousarray(s0.yp.T.numpy())
    h0 = np.ascontiguousarray(s0.h.numpy())
    nfev0 = np.ascontiguousarray(s0.nfev.numpy())
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    work = np.empty((nb, FA._WORK), np.int32)
    snap = _HostSnap(t_eval, span, y0)
    rec = _HostRecord(y0, rows, snap.points is not None)
    fn = lib.fused_adams_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 10 + [ci, cf, cf, cf, cf, cf, cf, ci, ci]
                   + rec.argtypes + snap.argtypes + [ci])
    rc = fn(y0.ctypes.data, None if params is None else params.ctypes.data,
            yp0.ctypes.data, h0.ctypes.data, nfev0.ctypes.data,
            out.ctypes.data, st.ctypes.data, ns.ctypes.data, nf.ctypes.data,
            work.ctypes.data, nb, FA._f32(span[0]), FA._f32(span[1]),
            direction, FA._f32(kw["rtol"]), FA._f32(kw["atol"]), np.inf,
            kw.get("max_steps", 200_000), int(kw.get("compensated", False)),
            *rec.args(), *snap.args(), lanes)
    assert rc == 0
    return (out, st, ns, nf, work) + rec.arrays() + snap.arrays()


@functools.lru_cache(maxsize=None)
def _adams_plain(case, max_steps=None):
    """The plain version on ``case``: (y, status, nsteps, nfev, work)."""
    prob, span, y0, kw = ADAMS_CASES[case]
    if max_steps is not None:
        kw = dict(kw, max_steps=max_steps)
    work = torch.zeros(len(y0), FA._WORK, dtype=torch.int64)
    out = FA.fused_adams_reference(TA.PROBLEMS[prob], span,
                                   torch.tensor(y0), work=work, **kw)
    return tuple(r.numpy() for r in out + (work,))


@pytest.mark.parametrize("case,attempts,lanes", _over_lanes(
    [("vdp", 2), ("bench", 4), ("osc_comp", 200_000),
     ("decay_1e6", 200_000), ("bench12", 200_000)]))
def test_adams_kernel_first_attempts_bit_identical(libs, case, attempts,
                                                   lanes):
    """The kernel's attempts (the coefficient update, predictor, error
    estimates, corrector, order selection and the double-single carries,
    plain and compensated) repeat the plain version's arithmetic bit for
    bit until a step ratio taken by powf rounds differently from
    torch.pow: after 2 attempts on vdp and 4 on bench; never in the whole
    runs of osc_comp, decay_1e6 and bench12 (k_max = 12, 134 steps).  The
    same holds with the rows and coefficients spread over 4 and 32
    lanes, and the kernel's work counters equal the plain version's."""
    y, st, ns, nf, work = _adams_host(libs["adams_" + case], case, lanes,
                                      max_steps=attempts)
    ry, rst, rns, rnf, rwork = _adams_plain(case, attempts)
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(st, rst)
    np.testing.assert_array_equal(ns, rns)
    np.testing.assert_array_equal(nf, rnf)
    np.testing.assert_array_equal(work, rwork)


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# vdp 1.5e-5, 1, 2; bench 7.6e-10, 0, 1; the rest 0, 0, 0 (the same at
# 1, 4 and 32 lanes).  Gates about 2x, with a floor of 1e-7 on |dy|.
GATES_ADAMS = [("vdp", 3e-5, 2, 4), ("osc_comp", 1e-7, 1, 2),
               ("decay_1e6", 1e-7, 1, 2), ("bench", 2e-9, 1, 2),
               ("bench12", 1e-7, 1, 2)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers,lanes",
                         _over_lanes(GATES_ADAMS))
def test_adams_kernel_matches_plain_version(libs, case, y_gate, dsteps,
                                            nmembers, lanes):
    y, st, ns, nf, _ = _adams_host(libs["adams_" + case], case, lanes)
    ry, rst, rns, rnf, _ = _adams_plain(case)
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


def _rkc_inputs():
    x = np.linspace(0, 1, RKC_SHAPE[1], endpoint=False)
    y0 = np.zeros((3, 2) + RKC_SHAPE, np.float32)
    for i, a in enumerate((0.2, 0.35, 0.5)):
        y0[i, 0] = 1.0 + a * np.sin(2 * np.pi * x)[None, :]
        y0[i, 1] = 3.0
    y0[2] *= 1e30                      # this member overflows
    return y0, np.array([[2.9], [3.2], [3.4]], np.float32)


class _HostPoints:
    """The t_eval arrays of a host RKC launch with snapshots (none for
    ``t_eval`` None): the points in t_eval's order and y_eval (members, nq,
    *shape) filled with NaN so that a row the kernel leaves shows."""

    def __init__(self, t_eval, y0):
        self.tq = (None if t_eval is None
                   else np.asarray(t_eval, np.float32).reshape(-1))
        self.argtypes = []
        if self.tq is not None:
            self.y = np.full((y0.shape[0], len(self.tq)) + y0.shape[1:],
                             np.nan, np.float32)
            self.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]

    def args(self):
        return (() if self.tq is None
                else (self.tq.ctypes.data, self.y.ctypes.data, len(self.tq)))

    def arrays(self):
        return () if self.tq is None else (self.y,)


def _rkc_host(lib, rho_mode, rho, cluster=1, t_eval=None, **kw):
    if cluster > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host cluster switches x86-64 stacks")
    y0, params = _rkc_inputs()
    nb = y0.shape[0]
    ntot = int(np.prod(y0.shape[1:]))
    out = np.empty_like(y0)
    ints = [np.empty(nb, np.int32) for _ in range(4)]
    work = np.empty(nb * FR.N_ARRAYS * ntot, np.float32)
    pts = _HostPoints(t_eval, y0)
    fn = lib.fused_rkc_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci] + [vp] * 8 + [ci] + [cf] * 8 + [ci] * 3 \
        + pts.argtypes + [ci]
    rc = fn(rho_mode, y0.ctypes.data, params.ctypes.data, out.ctypes.data,
            *[a.ctypes.data for a in ints], work.ctypes.data, nb, 0.0, 1.0,
            1.0, 1e-4, 1e-7, FR._f32(kw.get("first_step", -1.0)),
            FR._f32(rho) if rho_mode == 0 else 0.0, np.inf,
            FR._mmax_for(1e-4, kw.get("m_max"))[0], 100_000,
            int(kw.get("const_jac", False)), *pts.args(), cluster)
    assert rc == 0
    return (out, *ints) + pts.arrays()


RHO_8 = 8 * 0.02 * RKC_SHAPE[1] ** 2 + 5.5


# (rho mode, options): the three ways to the spectral radius, const_jac
# and a forced stage cap
RKC_CASES = {"float": (0, {}), "callable": (1, {}), "power": (2, {}),
             "power_const_jac": (2, {"const_jac": True}),
             "m_max": (0, {"m_max": 2})}


def _rkc_against_plain(libs, case, cluster):
    """The host body at ``cluster`` CTAs per member against
    fused_rkc_reference on ``case``: identical status, nsteps, nfev and
    nfesig, and max |dy| over the finished members (returned)."""
    mode, kw = RKC_CASES[case]
    rho = {0: RHO_8, 1: TR.RHO_FN, 2: None}[mode]
    y, st, ns, nf, nsig = _rkc_host(libs["rkc"], mode, RHO_8, cluster, **kw)
    y0, params = _rkc_inputs()
    ref = FR.fused_rkc_reference(
        pde.brusselator_2d_grid(RKC_SHAPE, B=None), (0.0, 1.0),
        torch.tensor(y0), rho, params=torch.tensor(params), rtol=1e-4,
        atol=1e-7, **kw)
    ref = [r.numpy() for r in ref]
    np.testing.assert_array_equal(st, ref[1])
    assert list(st) == [1, 1, 3 if mode != 2 else 6]
    np.testing.assert_array_equal(ns, ref[2])
    np.testing.assert_array_equal(nf, ref[3])
    if mode == 2:
        np.testing.assert_array_equal(nsig, ref[4])
    return np.max(np.abs(y[:2] - ref[0][:2]))


@pytest.mark.parametrize("case", list(RKC_CASES))
def test_rkc_kernel_matches_plain_version(libs, case):
    """The RKC body (B9 and B10 share it) run on the host by a one-thread
    group, its arrays in the workspace, against fused_rkc_reference on
    three 2x8x8 Brusselator members with their own B, one of which
    overflows.  Measured: identical status, nsteps, nfev and nfesig, |dy|
    <= 1.4e-6 over the finished members (the libraries'
    logf/sinhf/coshf/powf and the order of the grid sums, which the host
    kernel takes sequentially); the gate is 5e-6."""
    assert _rkc_against_plain(libs, case, 1) <= 5e-6


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("case", list(RKC_CASES))
def test_rkc_cluster_body_matches_plain_version(libs, case, cluster):
    """B10's cluster body on the host: each member on ``cluster`` CTAs
    (coroutines that hand over at each cluster barrier), each owning a
    contiguous chunk of the grid with its elementwise arrays in a buffer of
    its own, the stage arguments shared across the chunks, and every sum
    the CTAs' partials added in rank order, against fused_rkc_reference at
    the one-thread body's gates: identical status and counts (the
    overflowing member fails alone), |dy| <= 5e-6."""
    assert _rkc_against_plain(libs, case, cluster) <= 5e-6


def _rkc_grid_host(lib, rho_mode, blocks, local, t_eval=None, **kw):
    """B9's body on ``blocks`` host blocks, its arrays in their buffers
    (``local``) or in the workspace, on member 0 of the RKC inputs; a build
    with snapshots takes ``t_eval`` and returns ``y_eval`` last."""
    if platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host grid switches x86-64 stacks")
    y0, params = (np.ascontiguousarray(x[:1]) for x in _rkc_inputs())
    ntot = int(np.prod(y0.shape[1:]))
    out = np.empty_like(y0)
    ints = [np.empty(1, np.int32) for _ in range(4)]
    work = np.empty(FR.N_ARRAYS * ntot, np.float32)
    pts = _HostPoints(t_eval, y0)
    fn = lib.fused_rkc_grid_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci] + [vp] * 8 + [cf] * 8 + [ci] * 3 + pts.argtypes \
        + [ci] * 2
    rc = fn(rho_mode, y0.ctypes.data, params.ctypes.data, out.ctypes.data,
            *[a.ctypes.data for a in ints], work.ctypes.data, 0.0, 1.0, 1.0,
            1e-4, 1e-7, FR._f32(kw.get("first_step", -1.0)),
            FR._f32(RHO_8) if rho_mode == 0 else 0.0, np.inf,
            FR._mmax_for(1e-4, kw.get("m_max"))[0], 100_000,
            int(kw.get("const_jac", False)), *pts.args(), blocks, int(local))
    assert rc == 0
    return (out, *ints) + pts.arrays()


@pytest.mark.parametrize("blocks", [3, 4])
@pytest.mark.parametrize("case", list(RKC_CASES))
def test_rkc_grid_placements_bit_identical(libs, case, blocks):
    """B9's grid body on the host: one member on 3 and 4 one-thread blocks
    (coroutines that hand over at each barrier's arrive), element i to
    block i mod blocks.  With the elementwise arrays in each block's own
    buffer (the shared placement: a block's k-th element at slot k) the
    run is bit-identical to the global placement on the same blocks, since
    every block owns the same elements and sums them in the same order; and
    both hold fused_rkc_reference's counts exactly and |dy| <= 5e-6 (the
    one-thread gate: the blocks' partial sums part the last bits from the
    plain version's torch.sum)."""
    mode, kw = RKC_CASES[case]
    rho = {0: RHO_8, 1: TR.RHO_FN, 2: None}[mode]
    local = _rkc_grid_host(libs["rkc"], mode, blocks, True, **kw)
    glob = _rkc_grid_host(libs["rkc"], mode, blocks, False, **kw)
    for a, b in zip(local, glob):
        np.testing.assert_array_equal(a, b)
    y0, params = _rkc_inputs()
    ref = [r.numpy() for r in FR.fused_rkc_reference(
        pde.brusselator_2d_grid(RKC_SHAPE, B=None), (0.0, 1.0),
        torch.tensor(y0[:1]), rho, params=torch.tensor(params[:1]),
        rtol=1e-4, atol=1e-7, **kw)]
    y, st, ns, nf, nsig = local
    assert list(st) == [1] and list(ref[1]) == [1]
    np.testing.assert_array_equal(ns, ref[2])
    np.testing.assert_array_equal(nf, ref[3])
    if mode == 2:
        np.testing.assert_array_equal(nsig, ref[4])
    assert np.max(np.abs(y - ref[0])) <= 5e-6


def _rkn_host(lib, span, y0, **kw):
    return _small_host(lib, "fused_rkn", span, y0, **kw)


def _grid_host(lib, span, y0, lanes=1, block_order=False, params=None,
               rows=0, t_eval=None, **kw):
    """The host-built grid body on ``y0`` (and the members' ``params``) by
    a one-thread group (lanes = 1) or a warp of 32 coroutine lanes, whose
    reductions take their own lane's butterfly result or, with
    ``block_order``, lane 0's; a B4 build with the dense record takes
    ``rows`` and returns the record's arrays after the outputs, and a B4
    or B12 build with snapshots takes ``t_eval`` and returns ``y_eval``
    last."""
    if lanes > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host warp switches x86-64 stacks")
    y0 = np.ascontiguousarray(y0, np.float32)
    par = None if params is None else np.ascontiguousarray(params,
                                                           np.float32)
    nb = y0.shape[0]
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    fn = lib.fused_rk_grid_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    snap = _HostSnap(t_eval, span, y0)
    rec = _HostRecord(y0, rows, snap.points is not None)
    fn.argtypes = ([vp] * 6 + [ci] + [cf] * 6 + [ci, cf, ci, ci, ci]
                   + rec.argtypes + snap.argtypes + [ci])
    t0, tf, rt, at, h0, use_h, mstep, msteps, comp = FK.launch_args(
        span, kw["rtol"], kw["atol"], kw.get("first_step"),
        kw.get("max_steps", 100_000), kw.get("compensated", False), None)
    rc = fn(y0.ctypes.data, None if par is None else par.ctypes.data,
            out.ctypes.data, st.ctypes.data, ns.ctypes.data,
            nf.ctypes.data, nb, t0, tf, float(np.sign(tf - t0)), rt, at, h0,
            use_h, mstep, msteps, comp, lanes, *rec.args(), *snap.args(),
            int(block_order))
    assert rc == 0
    return (out, st, ns, nf) + rec.arrays() + snap.arrays()



def _with_warp(params, warp, gates=None):
    """pytest parameters of the one-thread cases (``lanes`` = 1, their ids
    as before) and of those whose case is in ``warp`` again on a warp of
    32 coroutine lanes (``lanes`` = 32, ids ending in ``-warp32``), with
    the gates of ``gates[case]`` where the warp has gates of its own."""
    out = []
    for p in params:
        base = "-".join(str(x) for x in p)
        out.append(pytest.param(*p, 1, id=base))
        if p[0] in warp:
            w = (p[0], *gates[p[0]]) if p[0] in (gates or {}) else p
            out.append(pytest.param(*w, 32, id=base + "-warp32"))
    return out


def _new_case(label):
    """(host runner, library, plain version, right-hand side, span, y0,
    options) of a case of the RKN and grid kernels."""
    case = {"kepler": (_rkn_host, "rkn_kepler", FN.fused_rkn_reference,
                       TN.KEPLER, TN.CASES),
            "wave": (_grid_host, "grid_wave", TN.fused_rkn_grid_reference,
                     TN.WAVE, TN.CASES),
            "fisher": (_grid_host, "grid_fisher",
                       TG.fused_erk_grid_reference, TG.RHS["fisher"],
                       TG.CASES)}[label.split("_")[0]]
    host, lib, plain, fun, cases = case
    c = cases[label]
    return host, lib, plain, fun, c[-3], c[-2], dict(c[-1])


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# kepler_plain 9.6e-5, 1, 7; kepler_comp 2.8e-5, 1, 71 (B5, Fi5N, the
# f32 error estimate of a nearly circular orbit is round-off, so last bits
# move h); wave_h0 1.1e-4, 0, 0; wave_comp 1.3e-5, 1, 1 (B6, n = 100);
# fisher_plain 1.8e-4, 5, 3; fisher_comp 5.3e-6, 3, 5; fisher_h0 8.3e-7,
# 0, 0 (B4, n = 100).  Gates about 2x.
NEW_GATES = [("kepler_plain", 2e-4, 2, 16), ("kepler_comp", 6e-5, 2, 100),
             ("wave_h0", 2e-4, 0, 0), ("wave_comp", 3e-5, 2, 2),
             ("fisher_plain", 4e-4, 8, 6), ("fisher_comp", 1.2e-5, 6, 8),
             ("fisher_h0", 2e-6, 0, 0)]


# the grid body's cases that also run on a warp of 32 coroutine lanes: B6's
# and B4's warp body, at the one-thread gates but for the compensated wave's count
# of members with other counts.  The warp's order of the norm's sums moves
# the last bits of that error estimate, which is round-off there: at 32
# lanes max |dy| 1.2e-5 and max |dnsteps| 1, as on one thread, but 5 of
# the 8 members one step apart (measured; 1 on one thread); its first
# five attempts stay bit-identical to the plain version
WARP_GRID_CASES = ("wave_h0", "wave_comp", "fisher_plain", "fisher_comp",
                   "fisher_h0")
WARP_GRID_GATES = {"wave_comp": (3e-5, 2, 6)}


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers,lanes",
                         _with_warp(NEW_GATES, WARP_GRID_CASES,
                                    WARP_GRID_GATES))
def test_rkn_and_grid_kernels_match_plain_versions(libs, case, y_gate,
                                                    dsteps, nmembers, lanes):
    """B5 (``fused_rkn.cu``, one member per thread) and the block body of
    B4 and B6 (``fused_rk_grid.cu``, run by a one-thread group, and also
    by a warp of 32 coroutine lanes, the warp body's layout) against
    their plain versions: status identical, counts within the gates (the
    libraries' powf/log10f part last bits of h), identical where
    ``first_step`` is given."""
    host, lib, plain, fun, span, y0, kw = _new_case(case)
    if lanes > 1:
        kw["lanes"] = lanes
    y, st, ns, nf = host(libs[lib], span, y0, **kw)
    kw.pop("lanes", None)
    ry, rst, rns, rnf = (r.numpy() for r in plain(fun, span,
                                                  torch.tensor(y0), **kw))
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts,lanes", _with_warp(
    [("wave_comp", 5), ("wave_h0", 1), ("fisher_h0", 1), ("fisher_comp", 1)],
    WARP_GRID_CASES))
def test_grid_body_first_attempts_bit_identical(libs, case, attempts, lanes):
    """With ``first_step`` given, the grid body's first attempts (stage
    sums, the compensated carries, the norm, the controller) repeat the
    plain version's arithmetic bit for bit: five attempts of the
    compensated wave, until powf and torch.pow round a step ratio apart;
    B6's and B4's also on a warp of 32 coroutine lanes."""
    host, lib, plain, fun, span, y0, kw = _new_case(case)
    kw.update(first_step=0.01, max_steps=attempts)
    y, st, ns, nf = host(libs[lib], span, y0, lanes=lanes, **kw)
    ry, rst, rns, rnf = (r.numpy() for r in plain(fun, span,
                                                  torch.tensor(y0), **kw))
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(st, rst)
    np.testing.assert_array_equal(ns, rns)
    np.testing.assert_array_equal(nf, rnf)


@pytest.mark.parametrize("lanes", SMALL_LANES)
@pytest.mark.parametrize("case", ["kepler_plain", "kepler_comp"])
def test_rkn_lane_body_bit_identical_to_thread_body(libs, case, lanes):
    """B5's group body, the norm's four divisions and finiteness tests and
    Fi5N's three controller powers split over 2, 4 and 8 coroutine lanes,
    gives the thread body's y, status, nsteps and nfev bit for bit over
    whole Kepler orbits, plain and compensated."""
    _, lib, _, _, span, y0, kw = _new_case(case)
    for a, b in zip(_rkn_host(libs[lib], span, y0, lanes=lanes, **kw),
                    _rkn_host(libs[lib], span, y0, **kw)):
        np.testing.assert_array_equal(a, b)


def test_rkn_lane_body_isolates_an_overflowing_member(libs):
    """At 4 lanes a member whose state overflows (the cubic acceleration)
    ends with status 3 alone, its group's shuffles leaving the other
    groups alone, and every member's outputs equal the thread body's."""
    _, _, _, span, y0, kw = TN.CASES["overflow"]
    out = _rkn_host(libs["rkn_cubic"], span, y0, lanes=4, **kw)
    assert out[1][7] == 3 and np.sum(out[1] == 1) == len(y0) - 1
    for a, b in zip(out, _rkn_host(libs["rkn_cubic"], span, y0, **kw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["overflow", "wave_overflow"])
def test_rkn_kernels_isolate_an_overflowing_member(libs, tmp_path, case):
    """A member whose state overflows ends with status 3 alone, in the
    thread-per-member kernel (cubic acceleration) and in the block body
    (the wave plus a cubic term); the others keep the plain version's
    counts within a step (measured: identical, and one wave member one
    step apart from the starting step's last bits)."""
    kind, prob, meth, span, y0, kw = TN.CASES[case]
    fun = TN.CARD_PROBLEMS[prob]
    if kind == "flat":
        header = _build.fused_rkn_header(FN.rkn_consts(TN.Fi5N), fun.m,
                                         fun.cuda_src)
        lib = _compile("fused_rkn", header, RKN_LAUNCH, tmp_path / case,
                       RKC_MARKER)
        out = _rkn_host(lib, span, y0, **kw)
        plain = FN.fused_rkn_reference
    else:
        header = _build.fused_rk_grid_header(FN.rkn_consts(TN.Fi5N), True,
                                             (fun.n,), fun.cuda_src)
        lib = _compile("fused_rk_grid", header, GRID_LAUNCH,
                       tmp_path / case, RKC_MARKER)
        out = _grid_host(lib, span, y0, **kw)
        plain = TN.fused_rkn_grid_reference
    ref = [r.numpy() for r in plain(fun, span, torch.tensor(y0), **kw)]
    bad = 7 if kind == "flat" else 3
    assert out[1][bad] == 3 and np.sum(out[1] == 1) == len(y0) - 1
    np.testing.assert_array_equal(out[1], ref[1])
    ok = out[1] == 1
    assert np.max(np.abs(out[2][ok] - ref[2][ok])) <= 1


def _ck_host(lib, span, y0, lanes=1, params=None, t_eval=None, **kw):
    """The host-built B11 on ``y0`` (and the members' ``params``) by one
    thread per member (lanes = 1) or ``lanes`` coroutine lanes; a build
    with snapshots takes ``t_eval`` and returns ``y_eval`` last."""
    if lanes > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host lane group switches x86-64 stacks")
    y0 = np.ascontiguousarray(y0, np.float32)
    par = None if params is None else np.ascontiguousarray(params,
                                                           np.float32)
    nb = y0.shape[0]
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    t0, tf, rt, at, h0, use_h, mstep, msteps, _ = FK.launch_args(
        span, kw["rtol"], kw["atol"], kw.get("first_step"),
        kw.get("max_steps", 100_000), False, kw.get("max_step"))
    fn = lib.fused_ckdisc_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    snap = _HostSnap(t_eval, span, y0)
    fn.argtypes = ([vp] * 6 + [ci, cf, cf, cf, cf, cf, ci, cf, ci, ci, ci]
                   + snap.argtypes + [vp])
    rc = fn(y0.ctypes.data, None if par is None else par.ctypes.data,
            out.ctypes.data, st.ctypes.data, ns.ctypes.data, nf.ctypes.data,
            nb, t0, tf, rt, at, h0, use_h, mstep, msteps, lanes,
            max(1, 128 // lanes), *snap.args(), None)
    assert rc == 0
    return (out, st, ns, nf) + snap.arrays()


def _ck_case(libs, name, **over):
    """The host-built kernel's and the plain version's results on a case of
    ``test_torch_fused_ckdisc.py``."""
    kind, prob, span, y0, kw = TC.CASES[name]
    kw = dict(kw, **over)
    host = _ck_host if kind == "flat" else _grid_host
    return (host(libs["ck_" + prob], span, TC.Y0[y0], **kw),
            TC._port(name, **over))


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# swdec 1.24e-3, 5, 39 of 128 (the libraries' powf parts a last bit of h,
# and the cascade's bisection towards each switch of the RHS carries it
# on); mol 3.3e-4, 7, 7 of 8 (n = 128, the same); rational_h0, overflow
# and overflow_h0 0, 0, 0 (the overflowing member with status 3 from
# Watts' NaN start and 2 from a first step, on both); mol_overflow 8.8e-6,
# 0, 2 and mol_overflow_h0 2.7e-6, 0, 0 (the same statuses); diffusion
# 9.5e-7, 0, 0 (n = 200, the group sums in another order).  Gates about
# 2x.
CK_GATES = [("swdec", 2.5e-3, 10, 80), ("rational_h0", 1e-6, 0, 0),
            ("overflow", 1e-6, 0, 0), ("overflow_h0", 1e-6, 0, 0),
            ("mol", 7e-4, 14, 8), ("mol_overflow", 2e-5, 0, 2),
            ("mol_overflow_h0", 6e-6, 0, 0), ("diffusion", 2e-6, 0, 0)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers", CK_GATES)
def test_ckdisc_kernels_match_plain_versions(libs, case, y_gate, dsteps,
                                             nmembers):
    """B11 (``fused_ckdisc.cu``, one member per thread) and the cascade of
    the block body (``fused_rk_grid.cu``'s integrate_ck, B12, run by a
    one-thread group) against their plain versions: status identical,
    counts within the gates."""
    (y, st, ns, nf), (ry, rst, rns, rnf) = _ck_case(libs, case)
    np.testing.assert_array_equal(st, rst)
    ok = st == 1
    print(case, np.max(np.abs(y[ok] - ry[ok])), np.max(np.abs(ns - rns)), np.sum((ns != rns) | (nf != rnf)), st[:8], rst[:8])
    assert np.max(np.abs(y[ok] - ry[ok])) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts", [("swdec_h0", 1), ("swdec_h0", 3),
                                           ("rational_h0", 10),
                                           ("mol_h0", 1), ("mol_h0", 3)])
def test_ckdisc_kernels_first_attempts_bit_identical(libs, case, attempts):
    """With ``first_step`` given, the kernels' first attempts (stages, the
    cascade's norms and decisions, the fallbacks, the twiddle and quit
    updates and the new point) repeat the plain version's arithmetic bit
    for bit."""
    out, ref = _ck_case(libs, case, max_steps=attempts)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


# the lane counts of B11's group body
CK_LANES = (2, 4, 8, 16, 32)


@pytest.mark.parametrize("lanes", CK_LANES)
@pytest.mark.parametrize("case", ["swdec", "rational_h0", "overflow"])
def test_ckdisc_lane_body_bit_identical_to_thread_body(libs, case, lanes):
    """B11's group body, each assessment's divisions and the step control's
    five quotients split over 2 to 32 lanes (coroutines that hand over at
    each shuffle; every lane runs the stages and the roots), gives the
    thread body's y, status, nsteps and nfev bit for bit over whole runs:
    the sign-switching decay (bisecting towards each switch), the rational
    problem from a first step and the overflowing cubic."""
    _, prob, span, y0, kw = TC.CASES[case]
    lib = libs["ck_" + prob]
    for a, b in zip(_ck_host(lib, span, TC.Y0[y0], lanes=lanes, **kw),
                    _ck_host(lib, span, TC.Y0[y0], **kw)):
        np.testing.assert_array_equal(a, b)


def test_ckdisc_lane_body_isolates_an_overflowing_member(libs):
    """At 8 lanes (four groups a warp) a member whose state overflows (the
    cubic from Watts' start) ends with status 3 alone, its group's shuffles
    leaving the other groups alone, and every member's outputs equal the
    thread body's."""
    _, prob, span, y0, kw = TC.CASES["overflow"]
    lib = libs["ck_" + prob]
    out = _ck_host(lib, span, TC.Y0[y0], lanes=8, **kw)
    assert out[1][7] == 3 and np.sum(out[1] == 1) == len(out[1]) - 1
    for a, b in zip(out, _ck_host(lib, span, TC.Y0[y0], **kw)):
        np.testing.assert_array_equal(a, b)


def _adams_grid_host(lib, fun, span, y0, lanes=1, params=None, rows=0,
                     t_eval=None, **kw):
    """The host-built mid-size SWAG body on ``y0`` (with the members'
    ``params`` or none) with its coefficients on ``lanes`` lanes, started
    from the float32 stepper's init as the wrapper starts it: (y, status,
    nsteps, nfev), with ``rows`` the record's arrays after them, and a
    build with snapshots takes ``t_eval`` and returns ``y_eval`` last."""
    if lanes > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host warp switches x86-64 stacks")
    y0 = np.ascontiguousarray(y0, np.float32)
    nb = y0.shape[0]
    if params is not None:
        params = np.ascontiguousarray(params, np.float32)
    yp0, h0, nfev0, direction = (
        np.ascontiguousarray(x.numpy()) if isinstance(x, torch.Tensor) else x
        for x in FAG._start(fun, span, torch.tensor(y0), kw["rtol"],
                            kw["atol"], kw.get("first_step"), kw["k_max"],
                            kw.get("max_step"),
                            None if params is None
                            else torch.tensor(params)))
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    snap = _HostSnap(t_eval, span, y0)
    rec = _HostRecord(y0, rows, snap.points is not None)
    fn = lib.fused_adams_grid_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 9 + [ci] + [cf] * 6 + [ci] + rec.argtypes
                   + snap.argtypes + [ci])
    mstep = kw.get("max_step")
    rc = fn(y0.ctypes.data, None if params is None else params.ctypes.data,
            yp0.ctypes.data, h0.ctypes.data, nfev0.ctypes.data,
            out.ctypes.data, st.ctypes.data, ns.ctypes.data, nf.ctypes.data,
            nb, FA._f32(span[0]), FA._f32(span[1]), direction,
            FA._f32(kw["rtol"]), FA._f32(kw["atol"]),
            np.inf if mstep is None else FA._f32(mstep),
            kw.get("max_steps", 200_000), *rec.args(), *snap.args(), lanes)
    assert rc == 0
    return (out, st, ns, nf) + rec.arrays() + snap.arrays()


# name -> (library, problem, span, y0, options): the cases of
# test_torch_fused_adams_grid.py and its overflowing member
ADAMS_GRID_CASES = {
    "heat": ("ag_heat4",) + TAG.CASES["heat"],
    "skew_back": ("ag_skew3",) + TAG.CASES["skew_back"],
    "heat_max_step": ("ag_heat3",) + TAG.CASES["heat_max_step"],
    "overflow": ("ag_cubic4", "heat_cubic", (0.0, 0.1), "bad",
                 dict(TAG.TOL, k_max=4, max_steps=2000)),
}


def _adams_grid_case(libs, name, lanes=1, **over):
    lib, prob, span, y0, kw = ADAMS_GRID_CASES[name]
    kw = dict(kw, **over)
    fun, y0 = TAG.RHS[prob], TAG.Y0[y0]
    host = _adams_grid_host(libs[lib], fun, span, y0, lanes, **kw)
    ref = FAG.fused_adams_grid_reference(fun, span, torch.tensor(y0), **kw)
    return host, tuple(r.numpy() for r in ref)


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# heat 2.0e-5, 2, 2; skew_back 7.2e-7, 0, 0; heat_max_step 0, 0, 0 (bit
# for bit); overflow 2.2e-5, 1, 1 (the overflowing member with status 3 on
# both).  powf against torch.pow in the step ratio and the order of the
# norms' sums (the host body sums the elements in order, the plain version
# by torch.sum) part last bits of h; gates about 2x.
ADAMS_GRID_GATES = [("heat", 4e-5, 4, 4), ("skew_back", 2e-6, 1, 2),
                    ("heat_max_step", 0.0, 0, 0), ("overflow", 5e-5, 2, 2)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers", ADAMS_GRID_GATES)
def test_adams_grid_body_matches_plain_version(libs, case, y_gate, dsteps,
                                               nmembers):
    """The mid-size SWAG body (``fused_adams_grid.cu``, B8, run by a
    one-thread group) against its plain version: status identical (the
    overflowing member ends with status 3 alone), counts within the
    gates."""
    (y, st, ns, nf), (ry, rst, rns, rnf) = _adams_grid_case(libs, case)
    np.testing.assert_array_equal(st, rst)
    ok = st == 1
    assert np.sum(ok) == len(st) - (1 if case == "overflow" else 0)
    assert np.max(np.abs(y[ok] - ry[ok])) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts", [("heat_max_step", 5),
                                           ("heat_max_step", 30)])
def test_adams_grid_body_first_attempts_bit_identical(libs, case, attempts):
    """The body's first attempts (the coefficient update, the predictor on
    the phi columns, the error ladder, the corrector and the order
    selection) repeat the plain version's arithmetic bit for bit."""
    out, ref = _adams_grid_case(libs, case, max_steps=attempts)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case,attempts", [("heat_max_step", 5),
                                           ("heat_max_step", 30)])
def test_adams_grid_warp_lanes_first_attempts_bit_identical(libs, case,
                                                            attempts):
    """With the coefficient vectors spread over a warp of 32 lanes (the
    card's layout: coefficients_lanes in every warp, beta and g by shuffle,
    the failure restore's psi shift across the lanes), the body's first
    attempts still repeat the plain version's arithmetic bit for bit."""
    out, ref = _adams_grid_case(libs, case, 32, max_steps=attempts)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(ADAMS_GRID_CASES))
def test_adams_grid_warp_lanes_equal_one_lane(libs, case):
    """Whole runs with the coefficients on 32 lanes equal the one-lane
    body's bit for bit (every order change, rejection and failure restore
    of these cases, the overflowing member's status 3 included)."""
    (out, _), (one, _) = (_adams_grid_case(libs, case, lanes)
                          for lanes in (32, 1))
    for a, b in zip(out, one):
        np.testing.assert_array_equal(a, b)


def _esdirk_grid_host(lib, span, y0, yp0=None, M=None, rtol=1e-4, atol=1e-6,
                      first_step=None, max_steps=100_000, compensated=False,
                      max_step=None, method=None, lanes=1,
                      block_order=False, params=None, block_base=None,
                      rows=0, t_eval=None):
    """The host-built mid-size ESDIRK body on ``y0`` (and the members'
    ``params``; ``block_base`` is the build's), launched as the wrapper
    launches the kernel, by a one-thread group (lanes = 1) or a warp of 32
    coroutine lanes (reductions as in ``_grid_host``); a build with the
    dense record takes ``rows`` and returns the record's arrays after the
    outputs, and a build with snapshots takes ``t_eval`` and returns
    ``y_eval`` last."""
    if lanes > 1 and platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the host warp switches x86-64 stacks")
    y0 = np.ascontiguousarray(y0, np.float32)
    par = None if params is None else np.ascontiguousarray(params,
                                                           np.float32)
    nb, n = y0.shape
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    yp = None if yp0 is None else np.ascontiguousarray(yp0, np.float32)
    mass = None if M is None else np.ascontiguousarray(M, np.float32)
    t0, tf = np.float32(span[0]), np.float32(span[1])
    h0 = (np.float32(first_step) if first_step is not None
          else np.float32(0.01) * abs(tf - t0))
    fn = lib.fused_esdirk_grid_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    snap = _HostSnap(t_eval, span, y0)
    rec = _HostRecord(y0, rows, snap.points is not None)
    fn.argtypes = ([vp] * 8 + [ci] + [cf] * 5
                   + [ci, ci, cf, ci, cf, ci, ci] + rec.argtypes
                   + snap.argtypes + [ci])
    rc = fn(y0.ctypes.data, None if yp is None else yp.ctypes.data,
            None if mass is None else mass.ctypes.data,
            None if par is None else par.ctypes.data, out.ctypes.data,
            st.ctypes.data, ns.ctypes.data, nf.ctypes.data, nb, float(t0),
            float(tf), rtol, atol, float(h0),
            int(first_step is None and M is None), int(yp is not None),
            np.inf if max_step is None else float(max_step), max_steps,
            FE._tiny_err(n, rtol), int(compensated), lanes, *rec.args(),
            *snap.args(), int(block_order))
    assert rc == 0
    return (out, st, ns, nf) + rec.arrays() + snap.arrays()


# name -> (library, case of test_torch_fused_esdirk_grid.py or its
# (problem, method, span, y0, options))
ESDIRK_GRID_CASES = {
    "rd_kv3i": ("eg_rd_kv3i", "rd_kv3i"),
    "rd_trbdf2": ("eg_rd_trbdf2", "rd_trbdf2"),
    "rd_h0": ("eg_rd_kv3i", "rd_h0"),
    "rd_comp": ("eg_rd_kv3i", "rd_comp"),
    "dae": ("eg_dae", "dae"),
    "skew_back": ("eg_skew", "skew_back"),
    "overflow": ("eg_cubic", ("cubic", "Kv3I", (0.0, 0.05), "bad",
                              dict(TEG.TOL, first_step=1e-3,
                                   max_steps=2000))),
    "nan_start": ("eg_cubic", ("cubic", "Kv3I", (0.0, 0.05), "nan",
                               dict(TEG.TOL, max_steps=50))),
}


def _esdirk_grid_case(libs, name, lanes=1, block_order=False, plain=True,
                      **over):
    """The host body's outputs on case ``name`` (at ``lanes``, see
    ``_esdirk_grid_host``) and, where ``plain``, the plain version's."""
    lib, case = ESDIRK_GRID_CASES[name]
    prob, meth, span, y0, kw = TEG.CASES[case] if isinstance(case, str) \
        else case
    kw = dict(TEG._options(kw), **over)
    fun = TEG.RHS[prob]
    y0 = NAN_Y0 if y0 == "nan" else TEG.Y0[y0]
    host_kw = dict(kw, lanes=lanes, block_order=block_order)
    if "yp0_batch" in host_kw:
        host_kw["yp0"] = host_kw.pop("yp0_batch").numpy()
    host = _esdirk_grid_host(libs[lib], span, y0, **host_kw)
    if not plain:
        return host, None
    ref = FEG.fused_esdirk_grid_reference(fun, span, torch.tensor(y0),
                                          method=TEG.METHODS[meth], **kw)
    return host, tuple(r.numpy() for r in ref)


# a member whose y0 holds a NaN: the block start's element minimum keeps it
NAN_Y0 = TEG.Y0["bump"].copy()
NAN_Y0[5, 7] = np.nan

# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# rd_kv3i 9.7e-6, 1, 6; rd_trbdf2 4.4e-6, 0, 0; rd_h0 1.0e-5, 0, 2; rd_comp
# 2.6e-6, 2, 7; dae 1.5e-7, 0, 0; skew_back 6.6e-7, 0, 0; overflow 3.0e-7,
# 0, 0 (the overflowing member with status 2 on both); nan_start 2.7e-7, 0,
# 1 (status 2 on both).  powf against torch.pow in the controller and the
# order of the norms' sums part last bits of h; gates about 2x.
ESDIRK_GRID_GATES = [("rd_kv3i", 2e-5, 2, 8), ("rd_trbdf2", 1e-5, 1, 2),
                     ("rd_h0", 2e-5, 1, 4), ("rd_comp", 6e-6, 4, 8),
                     ("dae", 5e-7, 1, 2), ("skew_back", 1.5e-6, 1, 2),
                     ("overflow", 1e-6, 1, 2), ("nan_start", 1e-6, 1, 2)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers,lanes",
                         _with_warp(ESDIRK_GRID_GATES, ESDIRK_GRID_CASES))
def test_esdirk_grid_body_matches_plain_version(libs, case, y_gate, dsteps,
                                                nmembers, lanes):
    """The mid-size ESDIRK body (``fused_esdirk_grid.cu``, B7, run by a
    one-thread group and by a warp of 32 coroutine lanes, the warp body's
    layout: the dual-number bands, the cyclic reduction, Newton and the
    controller) against its plain version: status identical (the
    overflowing member fails alone, the member with a NaN in y0 takes the
    plain version's status from the block start), counts within the
    gates."""
    (y, st, ns, nf), (ry, rst, rns, rnf) = _esdirk_grid_case(libs, case,
                                                             lanes)
    np.testing.assert_array_equal(st, rst)
    ok = st == 1
    if case in ("overflow", "nan_start"):
        assert np.sum(ok) == len(st) - 1
    else:
        assert np.all(ok)
    assert np.max(np.abs(y[ok] - ry[ok])) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts,lanes", _with_warp(
    [("rd_h0", 1), ("rd_h0", 2), ("dae", 1)], ESDIRK_GRID_CASES))
def test_esdirk_grid_body_first_attempts_bit_identical(libs, case, attempts,
                                                       lanes):
    """The body's first attempts repeat the plain version's arithmetic bit
    for bit, on one thread and on a warp of 32 coroutine lanes."""
    out, ref = _esdirk_grid_case(libs, case, lanes, max_steps=attempts)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(ESDIRK_GRID_CASES) + list(
    WARP_GRID_CASES))
def test_warp_body_equals_block_order(libs, case):
    """A warp's reductions give every lane the same value: whole runs of
    the warp bodies of B7, B6 and B4 (32 coroutine lanes, each taking its
    own lane's butterfly result, as WarpGroup does) equal the same runs
    with every lane taking lane 0's (as BlockGroup in a block of one warp
    reads it back), bit for bit."""
    if case in ESDIRK_GRID_CASES:
        runs = [_esdirk_grid_case(libs, case, 32, block, plain=False)[0]
                for block in (False, True)]
    else:
        host, lib, _, _, span, y0, kw = _new_case(case)
        runs = [host(libs[lib], span, y0, 32, block, **kw)
                for block in (False, True)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# The block start's tolerance parts alone, by a one-thread group, for an
# NF = 4 member.
LOG_TOL_SRC = HOST_GROUP + """
namespace tab {
constexpr float HS_BIG = 1.0f, HS_RELPER = 1.0f, HS_SMALL = 1.0f,
                HS_T_FLOOR = 1.0f;
}
#include "block_hstart.cuh"

extern "C" void log_tolerances_host(const float* y, float rtol, float atol,
                                    float* out) {
  HostGroup g;
  rk::log_tolerances<4>(g, y, rtol, atol, out[0], out[1]);
}
"""


def test_block_start_keeps_a_nan_of_y0(tmp_path):
    """The block start's minimum over the elements of log10(atol + rtol
    |y|) keeps a NaN of y0, as torch.amin does in ``hstart_tile`` (it
    dropped it, with fminf, before); finite members give the sum and the
    minimum of the plain version."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    (tmp_path / "shim.h").write_text(SHIM)
    (tmp_path / "log_tol.cpp").write_text(LOG_TOL_SRC)
    so = tmp_path / "lib.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-include", str(tmp_path / "shim.h"),
                    "-I", str(_build.CSRC), "-o", str(so),
                    str(tmp_path / "log_tol.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(str(so)).log_tolerances_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    for y in ([0.5, -2.0, 3.0, 1e-3], [0.5, np.nan, 3.0, 1e-3]):
        y = np.asarray(y, np.float32)
        out = np.empty(2, np.float32)
        fn(y.ctypes.data, 1e-4, 1e-6, out.ctypes.data)
        te = torch.log10(1e-6 + 1e-4 * torch.abs(torch.tensor(y)))
        np.testing.assert_allclose(out, [te.sum(), te.amin()], rtol=1e-6)
        assert np.isnan(out[1]) == bool(np.isnan(y).any())


def test_grid_body_nan_start_status_as_plain(libs):
    """A member of B4's block body whose y0 holds a NaN ends with the plain
    version's status, and its neighbours with the plain version's counts
    (the block start's NaN reaches h through its norms, as in
    ``hstart_tile``)."""
    host, lib, plain, fun, span, y0, kw = _new_case("fisher_plain")
    y0 = y0.copy()
    y0[2, 5] = np.nan
    kw["max_steps"] = 200
    y, st, ns, nf = host(libs[lib], span, y0, **kw)
    ry, rst, rns, rnf = (r.numpy() for r in plain(fun, span,
                                                  torch.tensor(y0), **kw))
    np.testing.assert_array_equal(st, rst)
    assert st[2] != 1 and np.sum(st == 1) == len(st) - 1


def _grid_param_case(label, lanes=1, **over):
    """The host body's outputs on ``label`` of GRID_PARAM_RHS (8 members,
    the fixture's inputs; a variational system starts from [y0 | 0]) and
    its plain version's: the Fisher cases on t in [0, 0.25], the
    reaction-diffusion cases on [0, 0.04], at rtol 1e-5 / atol 1e-8."""
    kernel, rhs, meth, nb = GRID_PARAM_RHS[label]
    if kernel == "fused_rk_grid":
        y0, par = TG.fisher_p_inputs()
        span, method = (0.0, 0.25), TK.BS5
    else:
        y0, par = TEG.rd_p_inputs()
        span, method = (0.0, 0.04), TEG.METHODS[meth]
    if rhs.shape[0] > y0.shape[1]:
        y0 = np.concatenate([y0, np.zeros((len(y0), rhs.shape[0]
                                           - y0.shape[1]), np.float32)], 1)
    kw = dict(dict(rtol=1e-5, atol=1e-8), **over)
    if kernel == "fused_rk_grid":
        host = _grid_host(LIBS_OF[label], span, y0, lanes=lanes, params=par,
                          **kw)
        ref = TG.fused_erk_grid_reference(
            rhs, span, torch.tensor(y0), method=method,
            params=torch.tensor(par), **kw)
    else:
        host = _esdirk_grid_host(LIBS_OF[label], span, y0, lanes=lanes,
                                 params=par, **kw)
        ref = FEG.fused_esdirk_grid_reference(
            rhs, span, torch.tensor(y0), method=method,
            params=torch.tensor(par), block_base=nb, **kw)
    return host, tuple(r.numpy() for r in ref)


LIBS_OF = {}


@pytest.fixture
def grid_param_libs(libs):
    LIBS_OF.update(libs)
    return libs


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# grid_fisher_params 4.6e-6, 0, 0; grid_fisher_variational 7.3e-6, 0, 2
# (the tangent rows on DualRows against torch.func.jvp; one rejected
# attempt more or less); eg_rd_params 4.8e-7, 0, 1; eg_rd_block 4.8e-7, 0,
# 0 (the base block's dual bands and the block-cyclic replay).  powf and
# torch.pow part last bits of h from the second attempt; gates about 2x.
GRID_PARAM_GATES = [("grid_fisher_params", 1e-5, 1, 2),
                    ("grid_fisher_variational", 1.5e-5, 1, 4),
                    ("eg_rd_params", 1e-6, 1, 2),
                    ("eg_rd_block", 1e-6, 1, 2)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers,lanes", _with_warp(
    GRID_PARAM_GATES, ("eg_rd_block", "grid_fisher_variational")))
def test_grid_params_kernels_match_plain_versions(grid_param_libs, case,
                                                  y_gate, dsteps, nmembers,
                                                  lanes):
    """B4 with params and on a variational system, B7 with params and with
    ``block_base`` (``fused_rk_grid.cu``, ``fused_esdirk_grid.cu`` run by a
    one-thread group, the block_base and variational builds also by a warp
    of 32 coroutine lanes) against their plain versions: status identical,
    counts and endpoints within the gates."""
    (y, st, ns, nf), (ry, rst, rns, rnf) = _grid_param_case(case, lanes)
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts", [
    ("grid_fisher_params", 1), ("grid_fisher_variational", 1),
    ("eg_rd_params", 2), ("eg_rd_block", 1)])
def test_grid_params_first_attempts_bit_identical(grid_param_libs, case,
                                                  attempts):
    """With ``first_step`` given, the first attempts of each params and
    variational build repeat the plain version's arithmetic bit for bit:
    the member's parameters from shared memory, the tangent rows' duals
    through the user's grid, the base block's bands and the block-cyclic
    replay."""
    host, ref = _grid_param_case(case, first_step=1e-4, max_steps=attempts)
    for a, b in zip(host, ref):
        np.testing.assert_array_equal(a, b)



# -- the dense record (dense=R) of B1 and B4 ----------------------------------

def _record_case(kind, lanes=1, rows=400, compensated=False, **over):
    """(host outputs with the record's arrays, plain version's outputs with
    its FusedDenseSolution) of B1 on the mu sweep of Van der Pol (t in [0,
    3], rtol 1e-5 / atol 1e-8) or B4 on the Fisher MoL with r a member (t
    in [0, 0.25]); ``compensated`` runs B1's other mode at rtol 1e-6 /
    atol 1e-9."""
    from extensisq_tpu_torch.ops.fused_erk_grid import \
        fused_erk_grid_reference
    kw = (dict(rtol=1e-6, atol=1e-9, compensated=True) if compensated
          else dict(rtol=1e-5, atol=1e-8))
    kw.update(over)
    if kind == "erk":
        y0, par, span = TK.VDPP0, TK.MUS, (0.0, 3.0)
        host = _erk_host(LIBS_OF["vdp_params_rec"], span, y0, lanes=lanes,
                         params=par, rows=rows, **kw)
        ref = FK.fused_erk_reference(TK.PROBLEMS["vdp_p"], span,
                                     torch.tensor(y0), method=TK.BS5,
                                     params=torch.tensor(par), dense=rows,
                                     **kw)
    else:
        (y0, par), span = TG.fisher_p_inputs(), (0.0, 0.25)
        host = _grid_host(LIBS_OF["grid_fisher_params_rec"], span, y0,
                          lanes=lanes, params=par, rows=rows, **kw)
        ref = fused_erk_grid_reference(TG.FISHER_P, span, torch.tensor(y0),
                                       method=TK.BS5,
                                       params=torch.tensor(par), dense=rows,
                                       **kw)
    return host, ref, span, y0


def _host_solution(host, span, y0):
    from extensisq_tpu_torch.ops.fused_dense import record_solution
    rt, ry, rf, f0, nrec = (torch.tensor(a) for a in host[4:])
    return record_solution(span, torch.tensor(y0), f0, rt, ry, rf, nrec,
                           torch.tensor(host[2]))


# (kind, lanes, compensated, rows, gate on the two dense outputs at 97
# common times, gate on |dnfev|).  From the second attempt powf and
# torch.pow part the last bits of h, so the nodes part (by up to 5e-4 in t
# on erk, 1e-2 compensated, 3e-3 on grid) with equal step counts, and the
# dense outputs differ by their interpolation error between the nodes.
# Measured: erk 1.0e-5; erk at 8 lanes compensated 1.3e-4 (a member 7
# evaluations apart); grid 2.2e-4, at 32 lanes 1.8e-4.  Gates about 3x.
# Van der Pol takes 14-21 attempts, Fisher 7: rows 12 and 4 overflow every
# member
RECORD_CASES = [
    ("erk", 1, False, 400, 3e-5, 0), ("erk", 8, False, 400, 3e-5, 0),
    ("erk", 1, True, 400, 4e-4, 14), ("erk", 8, True, 400, 4e-4, 14),
    ("erk", 4, False, 12, 3e-5, 0),
    ("grid", 1, False, 400, 6e-4, 0), ("grid", 32, False, 400, 6e-4, 0),
    ("grid", 1, False, 4, 6e-4, 0)]


@pytest.mark.parametrize("kind,lanes,comp,rows,gate,dnfev", RECORD_CASES)
def test_dense_record_matches_plain_version(grid_param_libs, kind, lanes,
                                            comp, rows, gate, dnfev):
    """B1 (one thread, 4 and 8 coroutine lanes) and B4 (one thread, a warp
    of 32 coroutine lanes) with the dense record against their plain
    versions: equal status, nsteps and valid, nfev within the gate, the
    dense outputs within the gate; every row written and no other, the
    last node the final state at tf and each row's f the right-hand side
    at its (t, y)."""
    host, ref, span, y0 = _record_case(kind, lanes, rows, comp)
    np.testing.assert_array_equal(host[1], ref[1].numpy())
    np.testing.assert_array_equal(host[2], ref[2].numpy())
    assert np.max(np.abs(host[3] - ref[3].numpy())) <= dnfev
    rt, ry, rf, f0, nrec = host[4:]
    assert np.all(nrec == np.minimum(host[2], nrec))
    written = np.arange(rows)[None] < nrec[:, None]
    assert np.all(np.isfinite(rt[written])) and np.all(np.isnan(rt[~written]))
    sol, rsol = _host_solution(host, span, y0), ref[4]
    np.testing.assert_array_equal(sol.valid.numpy(), rsol.valid.numpy())
    assert bool(sol.valid.all()) == (rows >= 100)
    if rows < 100:
        return
    b = np.arange(len(y0))
    np.testing.assert_array_equal(rt[b, nrec - 1], np.float32(span[1]))
    np.testing.assert_array_equal(ry[b, nrec - 1], host[0])
    fun = (TK.PROBLEMS["vdp_p"].torch_fn if kind == "erk"
           else TG.FISHER_P.torch_fn)
    par = torch.tensor(TK.MUS if kind == "erk" else TG.fisher_p_inputs()[1])
    p = tuple(par.T) if kind == "erk" else par.T
    for j in range(0, int(nrec.min()), 3):
        f = fun(torch.tensor(rt[:, j]), torch.tensor(ry[:, j]).T, p).T
        assert np.max(np.abs(f.numpy() - rf[:, j])) <= 1e-5 * max(
            1.0, np.abs(rf[:, j]).max())
    tq = torch.linspace(span[0], span[1], 97)
    assert (sol(tq) - rsol(tq)).abs().max().item() <= gate


@pytest.mark.parametrize("kind,lanes,comp", [
    ("erk", 2, False), ("erk", 4, False), ("erk", 8, False), ("erk", 4, True),
    ("erk", 8, True)])
def test_dense_record_lane_body_bit_identical_to_thread_body(
        grid_param_libs, kind, lanes, comp):
    """B1's group body on 2, 4 and 8 coroutine lanes writes the thread
    body's record bit for bit, with its outputs."""
    a, _, _, _ = _record_case(kind, lanes, 400, comp)
    b, _, _, _ = _record_case(kind, 1, 400, comp)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind,lanes,comp", [
    ("erk", 1, False), ("erk", 8, True), ("grid", 1, False),
    ("grid", 32, False)])
def test_dense_record_leaves_the_outputs_as_they_are(grid_param_libs, kind,
                                                     lanes, comp):
    """The record's build gives the outputs of the build without it (the
    params builds of the other tests) bit for bit."""
    rec, _, span, y0 = _record_case(kind, lanes, 400, comp)
    kw = (dict(rtol=1e-6, atol=1e-9, compensated=True) if comp
          else dict(rtol=1e-5, atol=1e-8))
    if kind == "erk":
        off = _erk_host(LIBS_OF["vdp_params"], span, y0, lanes=lanes,
                        params=TK.MUS, **kw)
    else:
        off = _grid_host(LIBS_OF["grid_fisher_params"], span, y0,
                         lanes=lanes, params=TG.fisher_p_inputs()[1], **kw)
    for x, y in zip(rec[:4], off):
        np.testing.assert_array_equal(x, y)


def test_dense_record_first_attempts_bit_identical(grid_param_libs):
    """With ``first_step`` given, B1's and B4's records of their first
    attempt (f0 and the first row) repeat the plain versions' bit for bit
    (from the second, powf and torch.pow part the last bits of h)."""
    for kind in ("erk", "grid"):
        host, ref, span, y0 = _record_case(kind, 1, 400, first_step=1e-3,
                                           max_steps=1)
        assert np.all(host[8] == 1)
        sol, rsol = _host_solution(host, span, y0), ref[4]
        for name in ("ts", "y_anchor", "Q", "valid"):
            assert torch.equal(getattr(sol, name), getattr(rsol, name))


# -- the dense record of B2, B7, B5 and B6, and the params of B5 and B6 -------

# kind -> (kernel family, the case, the record build, the build without it).
# B2: Robertson (TRBDF2), the pendulum DAE (a diagonal M, yp0 given), the
# Kaps DAE behind a hidden M (rows mapped back by V) and the simultaneous
# corrector on Robertson's variational system with params (the record of
# the augmented state); B7: the DAE (a diagonal M), the reaction-diffusion
# with params and its simultaneous corrector; B5 and B6: the oscillator and
# the wave with a parameter a member (the fixture's inputs)
ROUTE_KINDS = {
    "b2_rob": ("esdirk", "rob_trbdf2", "rob_trbdf2_rec", "rob_trbdf2"),
    "b2_pend": ("esdirk", "pend_dae", "pend_rec", "pend"),
    "b2_kaps": ("esdirk", "kaps_hidden", "kaps_hidden_rec", "kaps_hidden"),
    "b2_block": ("esdirk", "rob_block", "rob_block_rec", "rob_block"),
    "b7_dae": ("esdirk_grid", "dae", "eg_dae_rec", "eg_dae"),
    "b7_params": ("esdirk_grid", "eg_rd_params", "eg_rd_params_rec",
                  "eg_rd_params"),
    "b7_block": ("esdirk_grid", "eg_rd_block", "eg_rd_block_rec",
                 "eg_rd_block"),
    "b5_params": ("rkn", "osc_params", "rkn_osc_p_rec", "rkn_osc_p"),
    "b6_params": ("rkn_grid", "wave_params", "grid_wave_p_rec",
                  "grid_wave_p"),
}


def _route_case(kind, lanes=1, rows=256, record=True, block_order=False,
                plain=True, **over):
    """(host outputs with the record's arrays where ``record``, plain
    version's outputs with its FusedDenseSolution (None unless
    ``plain``), span, y0) of ``kind`` at ``lanes`` (a warp of 32 for B7
    and B6, reductions in ``block_order`` where asked) with ``rows`` a
    member."""
    family, case, rec_lib, lib = ROUTE_KINDS[kind]
    lib = LIBS_OF[rec_lib if record else lib]
    hrows = rows if record else 0
    if family == "esdirk":
        host = _esdirk_host(lib, case, lanes, rows=hrows, **over)
        prob, meth, span, y0, yp0, M, kw = {**T.CASES, **T.PARAM_CASES}[case]
        par = T.PARAMS.get(case)
        ref = None if not plain else FE.fused_esdirk_reference(
            T.PROBLEMS[prob], span, torch.tensor(y0), method=T.METHODS[meth],
            M=M, yp0_batch=None if yp0 is None else torch.tensor(yp0),
            params=None if par is None else torch.tensor(par), dense=rows,
            **dict(kw, **over))
        return host, ref, span, y0
    if family == "esdirk_grid" and case == "dae":
        prob, meth, span, y0, kw = TEG.CASES[case]
        kw = dict(TEG._options(kw), **over)
        y0 = TEG.Y0[y0]
        host_kw = dict(kw, yp0=kw["yp0_batch"].numpy())
        del host_kw["yp0_batch"]
        host = _esdirk_grid_host(lib, span, y0, lanes=lanes,
                                 block_order=block_order, rows=hrows,
                                 **host_kw)
        ref = None if not plain else FEG.fused_esdirk_grid_reference(
            TEG.RHS[prob], span, torch.tensor(y0), method=TEG.METHODS[meth],
            dense=rows, **kw)
        return host, ref, span, y0
    if family == "esdirk_grid":
        _, rhs, meth, nb = GRID_PARAM_RHS[case]
        y0, par = TEG.rd_p_inputs()
        if rhs.shape[0] > y0.shape[1]:
            y0 = np.concatenate([y0, np.zeros(
                (len(y0), rhs.shape[0] - y0.shape[1]), np.float32)], 1)
        span = (0.0, 0.04)
        kw = dict(dict(rtol=1e-5, atol=1e-8), **over)
        host = _esdirk_grid_host(lib, span, y0, lanes=lanes,
                                 block_order=block_order, params=par,
                                 rows=hrows, **kw)
        ref = None if not plain else FEG.fused_esdirk_grid_reference(
            rhs, span, torch.tensor(y0), method=TEG.METHODS[meth],
            params=torch.tensor(par), block_base=nb, dense=rows, **kw)
        return host, ref, span, y0
    plain_fn, fun, span, kw = TDR.CASES[case]
    y0, _, par = (None if x is None else x.numpy()
                  for x in TDR._inputs(case))
    kw = dict(kw, **over)
    kw.pop("dense")
    if family == "rkn":
        host = _rkn_host(lib, span, y0, lanes=lanes, params=par, rows=hrows,
                         **kw)
    else:
        host = _grid_host(lib, span, y0, lanes=lanes, block_order=block_order,
                          params=par, rows=hrows, **kw)
    ref = None if not plain else plain_fn(
        fun, span, torch.tensor(y0), params=torch.tensor(par), dense=rows,
        **kw)
    return host, ref, span, y0


# (kind, lanes, gate on |dnsteps|, gate on the two dense outputs at 97
# common times).  From the second attempt powf and torch.pow part the
# last bits of h, so the nodes part with the counts, and the dense
# outputs by their interpolation error between them.  Measured (max
# |dnsteps|, dense outputs): b2_rob 1, 2.1e-6 (1 and 8 lanes); b2_pend 1,
# 7.6e-6 (1 and 4); b2_kaps 0, 1.4e-6; b2_block 0, 1.2e-7; b7_dae 0,
# 3.6e-7 (1 and 32); b7_params 0, 4.8e-7; b7_block 0, 4.8e-7 (1 and 32);
# b5_params 0, 2.6e-5 (1 and 8); b6_params 1, 3.9e-4 (1), 0, 6.4e-4 (32).
# Gates about 3x, at least 1 on the steps
ROUTE_RECORD_CASES = [
    ("b2_rob", 1, 2, 6e-6), ("b2_rob", 8, 2, 6e-6), ("b2_pend", 1, 2, 2.3e-5),
    ("b2_pend", 4, 2, 2.3e-5), ("b2_kaps", 1, 1, 4.5e-6),
    ("b2_block", 1, 1, 4e-7), ("b7_dae", 1, 1, 1.1e-6),
    ("b7_dae", 32, 1, 1.1e-6), ("b7_params", 1, 1, 1.5e-6),
    ("b7_block", 1, 1, 1.5e-6), ("b7_block", 32, 1, 1.5e-6),
    ("b5_params", 1, 1, 8e-5), ("b5_params", 8, 1, 8e-5),
    ("b6_params", 1, 2, 2e-3), ("b6_params", 32, 2, 2e-3)]


@pytest.mark.parametrize("kind,lanes,dsteps,gate", ROUTE_RECORD_CASES)
def test_route_record_matches_plain_version(grid_param_libs, kind, lanes,
                                            dsteps, gate):
    """B2 (one thread, 4 and 8 coroutine lanes), B7 and B6 (one thread, a
    warp of 32 coroutine lanes) and B5 (one thread, 8 lanes) with the
    dense record against their plain versions: equal status and valid,
    nsteps within the gate; every row written and no other, the last node
    the final state at tf; the dense outputs within the gate."""
    host, ref, span, y0 = _route_case(kind, lanes)
    np.testing.assert_array_equal(host[1], ref[1].numpy())
    assert np.all(host[1] == 1)
    assert np.max(np.abs(host[2] - ref[2].numpy())) <= dsteps
    rt, ry, rf, f0, nrec = host[4:]
    rows = rt.shape[1]
    np.testing.assert_array_equal(nrec, host[2])
    written = np.arange(rows)[None] < nrec[:, None]
    assert np.all(np.isfinite(rt[written])) and np.all(np.isnan(rt[~written]))
    assert np.all(np.isfinite(f0))
    b = np.arange(len(y0))
    np.testing.assert_array_equal(rt[b, nrec - 1], np.float32(span[1]))
    np.testing.assert_array_equal(ry[b, nrec - 1], host[0])
    sol, rsol = _host_solution(host, span, y0), ref[4]
    assert bool(sol.valid.all()) and bool(rsol.valid.all())
    tq = torch.linspace(span[0], span[1], 97)
    assert (sol(tq) - rsol(tq)).abs().max().item() <= gate


@pytest.mark.parametrize("kind,lanes", [
    ("b2_rob", 4), ("b2_rob", 8), ("b2_kaps", 8), ("b2_block", 4),
    ("b5_params", 2), ("b5_params", 4), ("b5_params", 8)])
def test_route_record_lane_body_bit_identical_to_thread_body(
        grid_param_libs, kind, lanes):
    """B2's and B5's group bodies on coroutine lanes write the thread
    body's records bit for bit, with its outputs."""
    a = _route_case(kind, lanes, plain=False)[0]
    b = _route_case(kind, 1, plain=False)[0]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["b7_dae", "b7_block", "b6_params"])
def test_route_record_warp_equals_block_order(grid_param_libs, kind):
    """The warp bodies of B7 and B6 write the same records with each lane
    taking its own butterfly result as with every lane taking lane 0's
    (a block of one warp), bit for bit."""
    a, b = (_route_case(kind, 32, block_order=block, plain=False)[0]
            for block in (False, True))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind,lanes", [
    (k, 1) for k in ROUTE_KINDS] + [("b2_rob", 8), ("b7_dae", 32),
                                    ("b5_params", 8), ("b6_params", 32)])
def test_route_record_leaves_the_outputs_as_they_are(grid_param_libs, kind,
                                                     lanes):
    """Each record build gives the outputs of the build without it bit for
    bit."""
    on = _route_case(kind, lanes, plain=False)[0]
    off = _route_case(kind, lanes, record=False, plain=False)[0]
    assert len(off) == 4
    for x, y in zip(on[:4], off):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", sorted(ROUTE_KINDS))
def test_route_record_first_attempts_bit_identical(grid_param_libs, kind):
    """With ``first_step`` given, each record of the first attempt (f0 and
    the first row) repeats the plain version's bit for bit: the stages, the
    Newton iterations, y' the last stage and, with a hidden M, the rows
    mapped back by V (at 1e-5 every member accepts it, but 28 of the 128
    behind the hidden M)."""
    host, ref, span, y0 = _route_case(kind, 1, first_step=1e-5,
                                      max_steps=1)
    assert np.sum(host[8]) >= 0.75 * len(y0)
    sol, rsol = _host_solution(host, span, y0), ref[4]
    for name in ("ts", "y_anchor", "Q", "valid"):
        assert torch.equal(getattr(sol, name), getattr(rsol, name)), name


@pytest.mark.parametrize("kind", ["b2_rob", "b7_dae", "b5_params",
                                  "b6_params"])
def test_route_record_overflow(grid_param_libs, kind):
    """A record of 3 rows: the members write the steps they accepted in
    their first 3 attempts, are not valid, and the outputs are those of
    the build without it."""
    host, ref, span, y0 = _route_case(kind, 1, rows=3)
    assert np.all((host[8] >= 1) & (host[8] <= 3))
    sol = _host_solution(host, span, y0)
    assert not bool(sol.valid.any()) and not bool(ref[4].valid.any())
    off = _route_case(kind, 1, record=False, plain=False)[0]
    for x, y in zip(host[:4], off):
        np.testing.assert_array_equal(x, y)


# (kind, lanes, max |dy|, max |dnsteps|), the params builds of B5 and B6
# without the record against their plain versions.  Measured: b5_params
# 4.8e-7, 0 (1 and 8 lanes); b6_params 1.4e-5, 1 (1 lane), 1.7e-5, 0 (a
# warp of 32).  Gates about 3x, at least 1 on the steps
PARAMS_CASES = [("b5_params", 1, 1.5e-6, 1), ("b5_params", 8, 1.5e-6, 1),
                ("b6_params", 1, 5.2e-5, 2), ("b6_params", 32, 5.2e-5, 2)]


@pytest.mark.parametrize("kind,lanes,y_gate,dsteps", PARAMS_CASES)
def test_rkn_params_kernels_match_plain_versions(grid_param_libs, kind,
                                                 lanes, y_gate, dsteps):
    """B5 and B6 with a parameter a member (loaded once into registers or
    the member's shared memory) against their plain versions: status
    equal, steps and endpoints within the gates."""
    host, ref, _, _ = _route_case(kind, lanes, record=False)
    np.testing.assert_array_equal(host[1], ref[1].numpy())
    assert np.max(np.abs(host[2] - ref[2].numpy())) <= dsteps
    assert np.max(np.abs(host[0] - ref[0].numpy())) <= y_gate


# -- per-member params and the dense record of B3 and B8 ----------------------

# kind -> (right-hand side, the record build, the build without it, the
# fixture case of the inputs, span, options): Van der Pol with mu a member
# (the flat SWAG adjoint's members, plain and compensated) and the heat MoL
# with the diffusivity a member (the grid one's)
SWAG_KINDS = {
    "b3_vdp": (TAR.VDP_P, "swag_vdp_p_rec", "swag_vdp_p", "adj_vdp",
               (0.0, 3.0), dict(rtol=1e-5, atol=1e-8, k_max=6)),
    "b3_vdp_comp": (TAR.VDP_P, "swag_vdp_p_rec", "swag_vdp_p", "adj_vdp",
                    (0.0, 3.0), dict(rtol=1e-6, atol=1e-9, k_max=6,
                                     compensated=True)),
    "b8_heat": (TAR.HEAT_P, "ag_heat_p_rec", "ag_heat_p", "adj_heat",
                (0.0, 0.3), dict(rtol=1e-4, atol=1e-7, k_max=6)),
}


def _swag_case(kind, lanes=1, rows=512, record=True, plain=True, **over):
    """(host outputs with the record's arrays where ``record``, the plain
    version's outputs with its FusedDenseSolution (None unless ``plain``),
    span, y0) of ``kind`` at ``lanes`` with ``rows`` a member."""
    rhs, rec_lib, lib, case, span, kw = SWAG_KINDS[kind]
    kw = dict(kw, **over)
    y0, par = (TAR.FIXTURE[f"{case}/in_{k}"] for k in ("y0", "params"))
    lib = LIBS_OF[rec_lib if record else lib]
    hrows = rows if record else 0
    if kind.startswith("b3"):
        host = _swag_host(lib, rhs, span, y0, lanes, par, hrows, **kw)
        host = host[:4] + host[5:]
        plain_fn = FA.fused_adams_reference
    else:
        host = _adams_grid_host(lib, rhs, span, y0, lanes, par, hrows, **kw)
        plain_fn = FAG.fused_adams_grid_reference
    ref = None if not plain else plain_fn(
        rhs, span, torch.tensor(y0), params=torch.tensor(par), dense=rows,
        **kw)
    return host, ref, span, y0


# (kind, lanes, gate on |dnsteps|, gate on the two dense outputs at 97
# common times).  Measured (max |dnsteps|, dense outputs): B3 0, 0 at
# every lane count, plain and compensated (powf and torch.pow agree on
# these members' step ratios); B8 1, 2.8e-4 at 1 and 32 lanes (its norms
# are block sums in element order, the plain version's torch.sum, and the
# init's starting step rounds by the layout of its rows: the nodes part
# with the counts, the dense outputs by their interpolation error between
# them).  Gates about 3x, at least 1e-7 and 1 on the steps
SWAG_RECORD_CASES = [
    ("b3_vdp", 1, 1, 1e-7), ("b3_vdp", 4, 1, 1e-7), ("b3_vdp", 32, 1, 1e-7),
    ("b3_vdp_comp", 1, 1, 1e-7), ("b3_vdp_comp", 16, 1, 1e-7),
    ("b8_heat", 1, 3, 9e-4), ("b8_heat", 32, 3, 9e-4)]


@pytest.mark.parametrize("kind,lanes,dsteps,gate", SWAG_RECORD_CASES)
def test_swag_record_matches_plain_version(grid_param_libs, kind, lanes,
                                           dsteps, gate):
    """B3 (one thread, 4, 16 and 32 coroutine lanes) and B8 (one thread, a
    warp of 32 coroutine lanes) with params and the dense record against
    their plain versions: equal status and valid, nsteps within the gate;
    every row written and no other, the last node the final state at tf;
    the dense outputs within the gate."""
    host, ref, span, y0 = _swag_case(kind, lanes)
    np.testing.assert_array_equal(host[1], ref[1].numpy())
    assert np.all(host[1] == 1)
    assert np.max(np.abs(host[2] - ref[2].numpy())) <= dsteps
    rt, ry, rf, f0, nrec = host[4:]
    rows = rt.shape[1]
    np.testing.assert_array_equal(nrec, host[2])
    written = np.arange(rows)[None] < nrec[:, None]
    assert np.all(np.isfinite(rt[written])) and np.all(np.isnan(rt[~written]))
    assert np.all(np.isfinite(f0))
    b = np.arange(len(y0))
    np.testing.assert_array_equal(rt[b, nrec - 1], np.float32(span[1]))
    np.testing.assert_array_equal(ry[b, nrec - 1], host[0])
    sol, rsol = _host_solution(host, span, y0), ref[4]
    assert bool(sol.valid.all()) and bool(rsol.valid.all())
    tq = torch.linspace(span[0], span[1], 97)
    assert (sol(tq) - rsol(tq)).abs().max().item() <= gate


@pytest.mark.parametrize("kind,lanes", [
    ("b3_vdp", 4), ("b3_vdp", 32), ("b3_vdp_comp", 16), ("b8_heat", 32)])
def test_swag_record_lanes_bit_identical_to_one_lane(grid_param_libs, kind,
                                                     lanes):
    """B3's group body on 4, 16 and 32 coroutine lanes and B8's
    coefficients over a warp of 32 write the one-lane body's records bit
    for bit, with its outputs."""
    a = _swag_case(kind, lanes, plain=False)[0]
    b = _swag_case(kind, 1, plain=False)[0]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind,lanes", [
    ("b3_vdp", 1), ("b3_vdp", 32), ("b3_vdp_comp", 8), ("b8_heat", 1),
    ("b8_heat", 32)])
def test_swag_record_leaves_the_outputs_as_they_are(grid_param_libs, kind,
                                                    lanes):
    """Each record build gives the outputs of the build without it bit for
    bit."""
    on = _swag_case(kind, lanes, plain=False)[0]
    off = _swag_case(kind, lanes, record=False, plain=False)[0]
    assert len(off) == 4
    for x, y in zip(on[:4], off):
        np.testing.assert_array_equal(x, y)


# (kind, attempts, options): VdP's first two attempts are rejected; the
# heat's starting step and its cap are given, since the block sums its
# norms in another order than torch.sum (and the init's starting step
# rounds by the layout of its rows)
@pytest.mark.parametrize("kind,attempts,over", [
    ("b3_vdp", 7, {}), ("b3_vdp_comp", 7, {}),
    ("b8_heat", 30, dict(first_step=1e-3, max_step=0.005))])
def test_swag_record_first_attempts_bit_identical(grid_param_libs, kind,
                                                  attempts, over):
    """The records of the first attempts (f0 from the float32 stepper's
    init on the bound function, the accepted steps' rows) repeat the plain
    versions' bit for bit."""
    host, ref, span, y0 = _swag_case(kind, 1, max_steps=attempts, **over)
    assert np.all(host[8] >= 1)
    sol, rsol = _host_solution(host, span, y0), ref[4]
    for name in ("ts", "y_anchor", "Q", "valid"):
        assert torch.equal(getattr(sol, name), getattr(rsol, name)), name


@pytest.mark.parametrize("kind", sorted(SWAG_KINDS))
def test_swag_record_overflow(grid_param_libs, kind):
    """A record of 3 rows: the members write the steps they accepted in
    their first 3 attempts, are not valid, and the outputs are those of
    the build without it."""
    host, ref, span, y0 = _swag_case(kind, 1, rows=3)
    assert np.all((host[8] >= 1) & (host[8] <= 3))
    sol = _host_solution(host, span, y0)
    assert not bool(sol.valid.any()) and not bool(ref[4].valid.any())
    off = _swag_case(kind, 1, record=False, plain=False)[0]
    for x, y in zip(host[:4], off):
        np.testing.assert_array_equal(x, y)


# (kind, lanes, max |dy|, max |dnsteps|), the params builds without the
# record against the plain versions.  Measured: B3 0, 0 (1 and 32 lanes,
# plain and compensated); B8 2.8e-4, 1 (1 and 32).  Gates about 3x, at
# least 1e-7 and 1 on the steps
SWAG_PARAMS_CASES = [("b3_vdp", 1, 1e-7, 1), ("b3_vdp", 32, 1e-7, 1),
                     ("b3_vdp_comp", 1, 1e-7, 1), ("b8_heat", 1, 9e-4, 3),
                     ("b8_heat", 32, 9e-4, 3)]


@pytest.mark.parametrize("kind,lanes,y_gate,dsteps", SWAG_PARAMS_CASES)
def test_swag_params_kernels_match_plain_versions(grid_param_libs, kind,
                                                  lanes, y_gate, dsteps):
    """B3 and B8 with a parameter a member (loaded once into registers or
    the member's shared memory, the starting state from the bound
    function) against their plain versions: status equal, steps and
    endpoints within the gates."""
    host, ref, _, _ = _swag_case(kind, lanes, record=False, rows=0)
    np.testing.assert_array_equal(host[1], ref[1].numpy())
    assert np.max(np.abs(host[2] - ref[2].numpy())) <= dsteps
    assert np.max(np.abs(host[0] - ref[0].numpy())) <= y_gate


# -- the t_eval snapshots (B1, B4, B11, B12) and B11's and B12's params ----

# a case of tests/test_torch_fused_teval.py -> (its build without the
# snapshots, its build with them); b1_params's builds carry the dense
# record too (its rows beside the snapshots)
TEVAL_HOST = {"b1_plain": ("erk_vdp5", "erk_vdp5_snap"),
              "b1_comp": ("erk_vdp5", "erk_vdp5_snap"),
              "b1_params": ("vdp_params_rec", "erk_vdp_p_rec_snap"),
              "b4_adv": ("grid_adv", "grid_adv_snap"),
              "b11_both": ("ck_decay_p", "ck_decay_p_snap"),
              "b12_params_teval": ("ck_sink_p", "ck_sink_p_snap")}
TEVAL_ROWS = {"b1_params": 256}


def _teval_host(libs, name, snap=True, lanes=1, **over):
    """A case of tests/test_torch_fused_teval.py on its host-built kernel
    (with the snapshots where ``snap``, else without ``t_eval``), at
    ``lanes`` lanes (B1 and B11 coroutine lanes, B4 a warp of 32)."""
    kind, _, span, _ = TT.CASES[name]
    base = TT.FIRST.get(name, name)
    y0, kw = TT._inputs(name)
    kw = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in dict(kw, **over).items()}
    if not snap:
        kw.pop("t_eval", None)
    kw.pop("dense", None)
    lib = libs[TEVAL_HOST[base][int(snap)]]
    host = {"erk": _erk_host, "ckdisc": _ck_host}.get(kind, _grid_host)
    return host(lib, span, y0.numpy(), lanes=lanes,
                **dict(kw, rows=TEVAL_ROWS[base]) if base in TEVAL_ROWS
                else kw)


# lanes of each kind's group bodies besides one thread: B1's and B11's
# coroutine lanes, B4's warp of 32 (B12's warp the card does not build)
TEVAL_LANES = {"b1_plain": (2, 4, 8), "b1_comp": (2, 4, 8),
               "b1_params": (4,), "b4_adv": (32,),
               "b11_both": (2, 8, 32), "b12_params_teval": ()}


@pytest.mark.parametrize("name,lanes", [
    (name, lanes) for name in TEVAL_HOST for lanes in (1,) + (
        TEVAL_LANES[name][-1:])])
def test_snapshot_builds_leave_the_outputs_bit_for_bit(libs, name, lanes):
    """The snapshot build (tab::SNAP) of each kernel gives the build
    without it bit for bit: the four outputs, and B1's dense record beside
    the snapshots; on one thread and on the kind's group body."""
    out = _teval_host(libs, name, lanes=lanes)
    off = _teval_host(libs, name, snap=False, lanes=lanes)
    assert len(out) == len(off) + 1
    for a, b in zip(out, off):
        np.testing.assert_array_equal(a, b)
    assert not np.isnan(out[-1]).any()


# (case, max |dy|, max |dy_eval|, max |dnsteps|, members with other
# counts) of the host-built kernels against the plain versions, measured
# (the libraries' powf parts last bits of h, from the second attempt):
# b1_plain 4.6e-7, 1.9e-6, 0, 0; b1_comp 2.1e-7, 1.7e-5, 2, 5 of 128;
# b1_params 2.7e-6, 4.3e-6, 0, 0; b4_adv 8.1e-6, 4.8e-5, 0, 1; b11_both
# 7.9e-5, 1.7e-4, 5, 2 of 32; b12_params_teval 2.4e-6, 2.4e-6, 0, 1.
# Gates about 2x.
TEVAL_HOST_GATES = [("b1_plain", 1e-6, 4e-6, 1, 2),
                    ("b1_comp", 5e-7, 4e-5, 4, 10),
                    ("b1_params", 6e-6, 1e-5, 1, 2),
                    ("b4_adv", 2e-5, 1e-4, 1, 2),
                    ("b11_both", 2e-4, 4e-4, 10, 4),
                    ("b12_params_teval", 5e-6, 5e-6, 1, 2)]


@pytest.mark.parametrize("name,y_gate,yq_gate,dsteps,nmembers",
                         TEVAL_HOST_GATES)
def test_snapshot_kernels_match_plain_versions(libs, name, y_gate, yq_gate,
                                               dsteps, nmembers):
    """The kernels' rows (their cursor into the sorted points) against the
    plain versions' (every point tested at every step), with params on B1,
    B11 and B12: status identical, y, y_eval and the counts within the
    gates."""
    out = _teval_host(libs, name)
    ref = [r.numpy() for r in TT._port(name)[:5]]
    np.testing.assert_array_equal(out[1], ref[1])
    assert np.all(out[1] == 1)
    assert np.max(np.abs(out[0] - ref[0])) <= y_gate
    assert np.max(np.abs(out[-1] - ref[4])) <= yq_gate
    assert np.max(np.abs(out[2] - ref[2])) <= dsteps
    assert np.sum((out[2] != ref[2]) | (out[3] != ref[3])) <= nmembers


@pytest.mark.parametrize("name", list(TT.FIRST))
def test_snapshot_first_attempt_bit_identical(libs, name):
    """One attempt of every member from ``first_step``, with points inside
    the step, before t0 and past it: the kernels' rows (the Hermite's
    __f*_rn operations in _hermite_tiles' order, y0, the final y) and
    outputs are the plain version's bit for bit."""
    out = _teval_host(libs, name)
    ref = TT._port(name)
    assert np.all(out[1] == 3)
    for a, b in zip(out[:4] + out[-1:], ref[:5]):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("name,lanes", [
    (name, lanes) for name in ("b1_plain", "b1_comp", "b11_both")
    for lanes in TEVAL_LANES[name]])
def test_snapshot_lane_bodies_bit_identical_to_thread_body(libs, name,
                                                           lanes):
    """B1's and B11's group bodies with snapshots (a step's crossed points
    split over the lanes) give the thread body's outputs and rows bit for
    bit, B11 with a parameter a member."""
    for a, b in zip(_teval_host(libs, name, lanes=lanes),
                    _teval_host(libs, name)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["b11_params", "b12_params"])
def test_ckdisc_params_kernels_match_plain_versions(libs, name):
    """B11 and B12 with a parameter a member (k = 1, loaded once: B11's
    into registers, B12's into its shared memory) against their plain
    versions at the gates of the k = 0 cases (CK_GATES' swdec and mol):
    status identical, y and the counts within them."""
    kind, _, span, _ = TT.CASES[name]
    y0, kw = TT._inputs(name)
    lib = "ck_decay_p" if kind == "ckdisc" else "ck_sink_p"
    host = _ck_host if kind == "ckdisc" else _grid_host
    out = host(libs[lib], span, y0.numpy(), params=kw.pop("params").numpy(),
               **kw)
    ref = [r.numpy() for r in TT._port(name)]
    np.testing.assert_array_equal(out[1], ref[1])
    y_gate, dsteps, nmembers = {"ckdisc": (2.5e-3, 10, 80),
                                "ckdisc_grid": (7e-4, 14, 8)}[kind]
    assert np.max(np.abs(out[0] - ref[0])) <= y_gate
    assert np.max(np.abs(out[2] - ref[2])) <= dsteps
    assert np.sum((out[2] != ref[2]) | (out[3] != ref[3])) <= nmembers


# -- the t_eval snapshots of B5, B6, B2 and B7 ----------------------------

# a case of the RKN (TN), ESDIRK (T) or mid-size ESDIRK (TEG) tests -> (its
# kernel, its build without the snapshots, the case, options over the
# case's); the snapshot build is the one of TEVAL_ROUTE_BUILDS beside it.
# B5 runs u'' = u^3 (a polynomial, so one attempt is the plain version's
# bit for bit; Kepler's division parts a last bit at a few members), its
# member 7 overflowing, plain and compensated
ROUTE_TEVAL = {"b5_overflow": ("rkn", "rkn_cubic", "overflow", {}),
               "b5_overflow_comp": ("rkn", "rkn_cubic", "overflow",
                                    dict(rtol=1e-6, atol=1e-9,
                                         compensated=True)),
               "b6_wave": ("rkn_grid", "grid_wave", "wave_h0", {}),
               "b6_wave_comp": ("rkn_grid", "grid_wave", "wave_comp", {}),
               "b2_kaps": ("esdirk", "kaps_hidden", "kaps_hidden", {}),
               "b2_kaps_comp": ("esdirk", "kaps_hidden", "kaps_hidden",
                                dict(compensated=True)),
               "b7_rd": ("esdirk_grid", "eg_rd_kv3i", "rd_kv3i", {}),
               "b7_rd_h0": ("esdirk_grid", "eg_rd_kv3i", "rd_h0", {})}
SNAP_OF = {off: snap for snap, (_, off) in TEVAL_ROUTE_BUILDS.items()}
# the group bodies of each kernel besides one thread: B5's and B2's
# coroutine lanes, B6's and B7's warp of 32
ROUTE_TEVAL_LANES = {"rkn": (2, 4, 8), "rkn_grid": (32,),
                     "esdirk": (4, 8), "esdirk_grid": (32,)}


def _route_spec(name):
    """(kernel, build without the snapshots, case, span) of a case."""
    kernel, off, case, _ = ROUTE_TEVAL[name]
    cases = {"rkn": TN.CASES, "rkn_grid": TN.CASES, "esdirk": T.CASES,
             "esdirk_grid": TEG.CASES}[kernel]
    span = cases[case][3] if kernel.startswith("rkn") else cases[case][2]
    return kernel, off, case, span


def _route_points(span, first):
    """The case's points, unsorted, repeated, before t0 and past tf; with
    ``first`` (one attempt of the size ``first``) four of them inside that
    attempt's step."""
    t0, tf = span
    w = tf - t0
    at = [0.5, 0.0, 1.0, 0.25, 0.25, -0.1, 1.2]
    tq = [t0 + w * a for a in at]
    if first:
        tq = [t0 + first * np.sign(w) * a for a in (0.5, 0.0, 1.0, 0.25)]
        tq += [t0 + 0.5 * w, t0 - 0.1 * w]
    return np.asarray(tq, np.float32)


def _route_teval(libs, name, snap=True, lanes=1, first=False, plain=True):
    """The host-built kernel on a case with its points (the snapshot build;
    without ``snap`` the build without it and no points) at ``lanes``, and
    where ``plain`` the plain version with the points; with ``first`` one
    attempt of 1% of the span, the points inside it."""
    kernel, off, case, span = _route_spec(name)
    lib = libs[SNAP_OF[off] if snap else off]
    over = dict(ROUTE_TEVAL[name][3])
    if first:
        h0 = 0.01 * abs(span[1] - span[0])
        over.update(first_step=h0, max_steps=1)
    tq = _route_points(span, over.get("first_step", 0.0))
    host_tq = tq if snap else None
    ref = None
    if kernel.startswith("rkn"):
        _, _, _, _, y0, kw = TN.CASES[case]
        kw = dict(kw, **over)
        run = _rkn_host if kernel == "rkn" else _grid_host
        host = run(lib, span, y0, lanes=lanes, t_eval=host_tq, **kw)
        if plain:
            ref = TN._port(case, t_eval=tq, **over)
    elif kernel == "esdirk":
        host = _esdirk_host(lib, case, lanes, t_eval=host_tq, **over)
        if plain:
            prob, meth, _, y0, yp0, M, kw = T.CASES[case]
            ref = FE.fused_esdirk_reference(
                T.PROBLEMS[prob], span, torch.tensor(y0),
                method=T.METHODS[meth], M=M,
                yp0_batch=None if yp0 is None else torch.tensor(yp0),
                t_eval=tq, **dict(kw, **over))
            ref = tuple(r.numpy() for r in ref)
    else:
        prob, meth, _, y0, kw = TEG.CASES[case]
        kw = dict(TEG._options(kw), **over)
        y0 = TEG.Y0[y0]
        host = _esdirk_grid_host(lib, span, y0, lanes=lanes, t_eval=host_tq,
                                 **kw)
        if plain:
            ref = FEG.fused_esdirk_grid_reference(
                TEG.RHS[prob], span, torch.tensor(y0),
                method=TEG.METHODS[meth], t_eval=tq, **kw)
            ref = tuple(r.numpy() for r in ref)
    return host, ref


@pytest.mark.parametrize("name,lanes", [
    (name, lanes) for name in ROUTE_TEVAL for lanes in (1,) + (
        ROUTE_TEVAL_LANES[ROUTE_TEVAL[name][0]][-1:])])
def test_route_snapshot_builds_leave_the_outputs_bit_for_bit(libs, name,
                                                             lanes):
    """The snapshot build (tab::SNAP) of B5, B6, B2 and B7 gives the build
    without it bit for bit, on one thread and on the kernel's group body;
    every row is written."""
    out, _ = _route_teval(libs, name, lanes=lanes, plain=False)
    off, _ = _route_teval(libs, name, snap=False, lanes=lanes, plain=False)
    assert len(out) == len(off) + 1
    for a, b in zip(out, off):
        np.testing.assert_array_equal(a, b)
    assert not np.isnan(out[-1]).any()


# (case, max |dy|, max |dy_eval|, max |dnsteps|, members with other
# counts) of the host-built kernels against the plain versions over the
# finished members, measured (the libraries' powf parts last bits of h
# from the second attempt): b5_overflow and b5_overflow_comp 0, 0, 0, 0
# (u'' = u^3 from 0.1 takes no step whose h parts; member 7 with status 3
# on both); b6_wave 1.1e-4, 1.1e-4, 0, 0; b6_wave_comp 1.3e-5, 1.3e-5, 1,
# 1; b2_kaps 6.7e-7, 7.5e-7, 0, 4; b2_kaps_comp 1.1e-6, 1.1e-6, 0, 0;
# b7_rd 9.7e-6, 9.7e-6, 1, 6; b7_rd_h0 1.0e-5, 1.0e-5, 0, 2.  Gates about
# 2x.
ROUTE_TEVAL_GATES = [("b5_overflow", 0.0, 0.0, 0, 0),
                     ("b5_overflow_comp", 0.0, 0.0, 0, 0),
                     ("b6_wave", 2.5e-4, 2.5e-4, 1, 2),
                     ("b6_wave_comp", 3e-5, 3e-5, 2, 2),
                     ("b2_kaps", 1.5e-6, 1.5e-6, 1, 8),
                     ("b2_kaps_comp", 2.5e-6, 2.5e-6, 1, 2),
                     ("b7_rd", 2e-5, 2e-5, 2, 12),
                     ("b7_rd_h0", 2e-5, 2e-5, 1, 4)]


@pytest.mark.parametrize("name,y_gate,yq_gate,dsteps,nmembers",
                         ROUTE_TEVAL_GATES)
def test_route_snapshot_kernels_match_plain_versions(libs, name, y_gate,
                                                     yq_gate, dsteps,
                                                     nmembers):
    """The kernels' rows (their cursor into the sorted points) against the
    plain versions' (every point tested at every step): status identical,
    y, y_eval and the counts within the gates; B2's rows behind the hidden
    M mapped to the user's coordinates in both."""
    out, ref = _route_teval(libs, name)
    np.testing.assert_array_equal(out[1], ref[1])
    ok = ref[1] == 1
    assert np.max(np.abs(out[0][ok] - ref[0][ok])) <= y_gate
    assert np.max(np.abs(out[-1][:, ok] - ref[4][:, ok])) <= yq_gate
    assert np.max(np.abs(out[2] - ref[2])) <= dsteps
    assert np.sum((out[2] != ref[2]) | (out[3] != ref[3])) <= nmembers


@pytest.mark.parametrize("name", ["b5_overflow", "b5_overflow_comp",
                                  "b6_wave", "b6_wave_comp", "b2_kaps",
                                  "b2_kaps_comp", "b7_rd"])
def test_route_snapshot_first_attempt_bit_identical(libs, name):
    """One attempt of every member, with points inside the step, before t0
    and past it: the kernels' rows (the Hermite's __f*_rn operations in
    _hermite_tiles' order, B5's and B6's on [u, v] with derivative [v, a],
    B2's mapped back by V behind the hidden M; y0; the final state) and
    outputs are the plain version's bit for bit."""
    out, ref = _route_teval(libs, name, first=True)
    assert np.all(out[1] == 3)
    for a, b in zip(out[:4] + out[-1:], ref[:5]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,lanes", [
    (name, lanes) for name in ("b5_overflow_comp", "b2_kaps", "b2_kaps_comp")
    for lanes in ROUTE_TEVAL_LANES[ROUTE_TEVAL[name][0]]])
def test_route_snapshot_lane_bodies_bit_identical_to_thread_body(libs, name,
                                                                 lanes):
    """B5's and B2's group bodies with snapshots (a step's crossed points
    split over the lanes) give the thread body's outputs and rows bit for
    bit."""
    for a, b in zip(_route_teval(libs, name, lanes=lanes, plain=False)[0],
                    _route_teval(libs, name, plain=False)[0]):
        np.testing.assert_array_equal(a, b)


# -- t_eval snapshots of B3, B8, B9 and B10 ----------------------------------

# points unsorted, repeated, at and before t0 and past tf
TQ_OSC = [1.0, 0.0, 0.5, 2.0, 1.5, 1.5, -0.5, 2.5, 0.004]
TQ_HEAT = [0.1, 0.0, 0.25, 0.05, 0.05, -0.1, 0.3, 7e-4]
# RKC's pending index: before t0, at t0, in order, out of order, NaN
TQ_RKC = [-0.1, 0.0, 0.25, 0.75, 0.5, 0.6, np.nan, 0.9, 0.3]


def _adams_teval_plain(case, tq):
    prob, span, y0, kw = ADAMS_CASES[case]
    return [r.numpy() for r in FA.fused_adams_reference(
        TA.PROBLEMS[prob], span, torch.tensor(y0), t_eval=tq, **kw)]


@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_adams_snapshot_build_bit_for_bit(libs, lanes):
    """B3's snapshot build on the compensated oscillator (k_max 4, a whole
    run that repeats the plain version's arithmetic): its five outputs are
    the build's without the snapshots bit for bit, and its rows the plain
    version's bit for bit (the Hermite from the high words of t and y, y0
    before t0, the final y past tf), on one thread and with a step's
    crossed points split over 4 and 32 lanes."""
    on = _adams_host(libs["adams_osc_comp_snap"], "osc_comp", lanes,
                     t_eval=TQ_OSC)
    off = _adams_host(libs["adams_osc_comp"], "osc_comp", lanes)
    assert len(on) == len(off) + 1
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    ref = _adams_teval_plain("osc_comp", TQ_OSC)
    np.testing.assert_array_equal(on[-1], ref[4])


@pytest.mark.parametrize("lanes", [1, 32])
def test_adams_snapshot_build_plain_mode(libs, lanes):
    """B3's snapshot build on Van der Pol (plain mode, k_max 6): the five
    outputs are the build's without the snapshots bit for bit; the rows
    of the members whose counts match the plain version's lie within the
    kernel's gate on y (GATES_ADAMS, 3e-5: powf against torch.pow parts
    the last bits of h from the second attempt)."""
    tq = [1.1, 0.0, 0.5, 2.0, 1.7, 1.7, -0.5, 2.5]
    on = _adams_host(libs["adams_vdp_snap"], "vdp", lanes, t_eval=tq)
    off = _adams_host(libs["adams_vdp"], "vdp", lanes)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    ref = _adams_teval_plain("vdp", tq)
    same = (on[2] == ref[2]) & (on[3] == ref[3])
    assert same.sum() >= len(same) - 4
    assert np.max(np.abs(on[-1][:, same] - ref[4][:, same])) <= 3e-5
    np.testing.assert_array_equal(on[-1][1], ADAMS_CASES["vdp"][2])


@pytest.mark.parametrize("lanes", [1, 32])
def test_adams_grid_snapshot_build_bit_for_bit(libs, lanes):
    """B8's snapshot build on the heat MoL with max_step (a whole run that
    repeats the plain version's arithmetic): its four outputs are the
    build's without the snapshots bit for bit and its rows, every thread
    its own elements, the plain version's bit for bit, with the
    coefficients on one lane and on a warp of 32."""
    lib, prob, span, y0, kw = ADAMS_GRID_CASES["heat_max_step"]
    fun, y0 = TAG.RHS[prob], TAG.Y0[y0]
    on = _adams_grid_host(libs["ag_heat3_snap"], fun, span, y0, lanes,
                          t_eval=TQ_HEAT, **kw)
    off = _adams_grid_host(libs[lib], fun, span, y0, lanes, **kw)
    assert len(on) == len(off) + 1
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    ref = FAG.fused_adams_grid_reference(fun, span, torch.tensor(y0),
                                         t_eval=TQ_HEAT, **kw)
    np.testing.assert_array_equal(on[-1], ref[4].numpy())


def _rkc_teval_plain(mode, tq, **kw):
    y0, params = _rkc_inputs()
    rho = {0: RHO_8, 1: TR.RHO_FN, 2: None}[mode]
    return [r.numpy() for r in FR.fused_rkc_reference(
        pde.brusselator_2d_grid(RKC_SHAPE, B=None), (0.0, 1.0),
        torch.tensor(y0), rho, params=torch.tensor(params), rtol=1e-4,
        atol=1e-7, t_eval=tq, **kw)]


def _check_rkc_rows(rows, ref_rows, y_final, members):
    """RKC rows against the plain version's, on ``members``: the points at
    or before t0 (first) are y0 bit for bit, from the NaN point on the
    final y bit for bit, those in order within the body's 5e-6, and the
    two out of order (0.5 and 0.6 after 0.75, written at the step that
    reaches 0.75, the cubic at theta down to ~-3) within 1e-4: measured
    4.1e-5 at most, the step's end pairs' 1.4e-6 amplified by the weights
    there."""
    y0 = _rkc_inputs()[0]
    nan_at = int(np.flatnonzero(np.isnan(TQ_RKC))[0])
    behind = [4, 5]
    for m in members:
        for q in (0, 1):
            np.testing.assert_array_equal(rows[m, q], y0[m])
        for q in range(nan_at, len(TQ_RKC)):
            np.testing.assert_array_equal(rows[m, q], y_final[m])
        d = np.abs(rows[m] - ref_rows[m]).reshape(len(TQ_RKC), -1).max(1)
        assert np.max(np.delete(d, behind)) <= 5e-6
        assert np.max(d[behind]) <= 1e-4


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("case", ["float", "power"])
def test_rkc_snapshot_build_matches_plain_version(libs, case, cluster):
    """The RKC body's snapshot build (B9 and B10 share it) on the host, one
    member a one-thread group or a cluster of 2 and 4 coroutine CTAs each
    writing its chunk of a row: its five outputs are the build's without
    the snapshots bit for bit, and its rows by the pending index (points
    before and at t0, in order, out of order, NaN, and after it) hold
    fused_rkc_reference's, the overflowing member's y0 and final y bit for
    bit."""
    mode, kw = RKC_CASES[case]
    on = _rkc_host(libs["rkc_snap"], mode, RHO_8, cluster, t_eval=TQ_RKC,
                   **kw)
    off = _rkc_host(libs["rkc"], mode, RHO_8, cluster, **kw)
    assert len(on) == len(off) + 1
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    ref = _rkc_teval_plain(mode, TQ_RKC, **kw)
    rows = on[-1]
    assert rows.shape == ref[-1].shape == (3, len(TQ_RKC)) + (2,) + RKC_SHAPE
    _check_rkc_rows(rows, ref[-1], on[0], [0, 1])
    np.testing.assert_array_equal(rows[2], ref[-1][2])


@pytest.mark.parametrize("case", ["float", "power"])
def test_rkc_grid_snapshot_build_matches_plain_version(libs, case):
    """B9's grid body with snapshots on 3 host blocks, each writing its
    own elements of a row: the shared and global placements give the same
    outputs and rows, the outputs are the build's without the snapshots
    bit for bit, and the rows hold fused_rkc_reference's."""
    mode, kw = RKC_CASES[case]
    local = _rkc_grid_host(libs["rkc_snap"], mode, 3, True, t_eval=TQ_RKC,
                           **kw)
    glob = _rkc_grid_host(libs["rkc_snap"], mode, 3, False, t_eval=TQ_RKC,
                          **kw)
    off = _rkc_grid_host(libs["rkc"], mode, 3, True, **kw)
    for a, b in zip(local, glob):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(local, off):
        np.testing.assert_array_equal(a, b)
    ref = _rkc_teval_plain(mode, TQ_RKC, **kw)
    _check_rkc_rows(local[-1], ref[-1][:1], local[0], [0])
