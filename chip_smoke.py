"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives each of the port's paths once:

* explicit: 4096 Van der Pol members (mu = 3, t in [0, 10]) integrated
  with BS5, first through the f64 batched solver ``solve_ensemble`` and
  then through the fused CUDA kernel ``ops.solve_fused_erk`` in plain
  float32 (rtol 1e-4) and in compensated mode (rtol 1e-6 / atol 1e-9);
* implicit: 4096 index-1 pendulum DAE members (M = diag(1, 1, 1, 1, 0),
  t in [0, 10], Kv3I, rtol 1e-4 / atol 1e-6), consistent starts from the
  f64 stepper's projection, through ``ops.solve_fused_esdirk`` and through
  the f64 ``solve_ensemble``;
* multistep: the SWAG bench line, 256 Van der Pol members (mu = 1000,
  t in [0, 20], rtol 1e-6 / atol 1e-9, k_max = 12, compensated), through
  ``ops.solve_fused_adams``, held against scipy's Radau at rtol 1e-12 on
  sampled members, and on a cut span against the plain version and the
  f64 ``solve_ensemble`` with SWAG;
* stabilized (SSV2stab, BASELINE config 5): the 2-D Brusselator on one
  2x256x256 grid (t in [0, 1], rtol 1e-4 / atol 1e-7) through the f64
  ``solve`` and through ``ops.solve_fused_rkc`` (the whole card on one
  grid), and 64 members of 2x64x128 with B per member (t in [0, 4])
  through ``ops.solve_fused_rkc_ensemble`` (a thread-block cluster per
  member, its launches repeated bit for bit) with a rho bound and with
  the in-kernel power iteration, held against the f64 ``solve_ensemble``;
* second-order and mid-size explicit (BASELINE configs 3 and 1b): 2048
  Kepler orbits with Fi5N through the f64 ``solve_ensemble`` (rtol 1e-9)
  and ``ops.solve_fused_rkn`` (plain f32 at rtol 1e-5, compensated at
  1e-7), 512 perturbed Pleiades members with CFMR7osc on the f64 driver,
  64 members of a 256-state fisher MoL with BS5 through
  ``ops.solve_fused_erk_grid``, and 64 members of a 256-position wave with
  Fi5N through ``ops.solve_fused_rkn_grid`` (plain and compensated), each
  held against the f64 driver;
* non-smooth (CKdisc, BASELINE config 1c): 1024 members of a
  sign-switching decay (t in [0, 5], rtol 1e-4 / atol 1e-7) through
  ``ops.solve_fused_ckdisc`` and the f64 ``solve_ensemble``, and 64 members
  of a 256-state advection-reaction MoL with a switching forcing (t in
  [0, 1.2]) through ``ops.solve_fused_ckdisc_grid`` and the f64 driver;
* mid-size SWAG and ESDIRK (BASELINE configs 2d and 4d): 32 members of a
  256-state periodic heat MoL (t in [0, 0.25], k_max 6) through
  ``ops.solve_fused_adams_grid`` (timed also as the launch alone, its
  float32 init outside the window) and the f64 SWAG driver, and 32 members of
  a 128-state periodic reaction-diffusion (t in [0, 1], Kv3I) through
  ``ops.solve_fused_esdirk_grid`` and the f64 driver, with a DAE-lanes
  check against the exact solution and a compensated one against f64;
* the f64 driver's trajectory options on the explicit line (after it):
  201 ``t_eval`` points with ``save_steps`` (the counters of the
  final-state run, the record ending at y), a zero crossing and a
  terminal event that stops the members starting above it, and four
  ``solve_windowed`` windows, bit for bit the single shot; 64 sampled
  members rerun on the CPU; and one 64-member ``t_eval`` run of Fi5N,
  Kv3I, SWAG, SSV2stab and CKdisc each, held against the CPU;
* banded ESDIRK and complex states (after the trajectory phase): config
  8, Medazko at n = 512, 1,024 and 2,048 with KC4I (t in [0, 20], rtol
  1e-3, ``jac_sparsity``) through ``solve`` with ``bands=True`` (block
  cyclic reduction) and dense (cuSOLVER's LU), equal steps at 512 and
  within 1 beyond, endpoints within 1e-5, both warm walls printed; a
  16-member banded ensemble at n = 512 against its 16 single solves,
  ``bands="rcm"`` on a relabelled chain against the dense path, a member
  rerun on the CPU; 64-member complex128 BS5, TRBDF2 (a callable complex
  Jacobian) and SWAG ensembles, each against the CPU;
* the fused sensitivities (configs 7a and 7b, before the host phase): B1
  and B2 with per-member ``params`` and B2's simultaneous corrector
  (``block_base``) on a variational system, each against its plain version
  on the card; 7a, 512 Robertson members (k1 in [0.04, 0.05], TRBDF2, t in
  [0, 0.4], rtol 1e-4 / atol 1e-8) through ``ops.solve_fused_sens``, one
  launch of B2, member 0 at the CVODES table's gates; 7b, the gradient of
  sum(y_f[:, 0]) over 1,024 Van der Pol members (mu in [1, 2], BS5, t in
  [0, 3], rtol 1e-5 / atol 1e-8) through ``ops.solve_fused_final``, two
  launches of B1, against central differences of B1 with params;
* the fused sensitivities on the grid layout (after configs 7a and 7b):
  B4 with ``params`` and on a variational system, B7 with ``params`` and
  its simultaneous corrector (``block_base``), each against its plain
  version on the card; 64 members of a 256-state periodic Fisher MoL (r in
  [0.8, 1.2], BS5, t in [0, 0.25], rtol 1e-5 / atol 1e-8) through
  ``ops.solve_fused_sens(layout="grid")``, one B4 launch on 512 rows,
  against central differences of B4 with params; 32 members of a
  128-state reaction-diffusion (k in [5, 30], D = 200, TRBDF2, t in [0,
  0.04]) through it, one B7 launch with block_base 128 on 384 rows,
  members 0 and 31 against the f64 ``sensitivity.sens_forward`` on the
  CPU;
* the in-kernel t_eval snapshots (after the adjoint phases): the main
  path's 4,096 Van der Pol members through B1 with 101 points (plain and
  compensated), config 1b's 64 Fisher members at n = 256 through B4,
  config 1c's 1,024 decay members through B11 with the switching
  frequency a member's parameter and the CKdisc MoL's 64 members through
  B12 with the forcing amplitude a member's parameter, 11 points each;
  each against its plain version and, bit for bit, the launch without
  t_eval at every shape its rule takes, the members at the k = 0 literal
  bit for bit the k = 0 run, B1 against the f64 ``solve_ensemble(...,
  t_eval=...)`` and a ``dense=R`` launch's ``sol(t_eval)`` against its
  ``y_eval``; each launch alone timed with and without the points;
* the in-kernel t_eval snapshots of the second-order and implicit kernels
  (after those): config 3's 2,048 Kepler orbits through B5 with 101
  points (plain and compensated), the wave line's 64 members at n = 256
  through B6, the bench's 4,096 pendulum members through B2 with 101
  points (its plain version's and f64 driver's runs those of the implicit
  path, which take the points), the hidden-M Kaps members through B2 and
  config 4d's 32 reaction-diffusion members through B7, 11 points each;
  each against its plain version and, bit for bit, the launch without
  t_eval at every shape its rule takes; B5 and B2 against the f64 driver's
  t_eval rows, a ``dense=R`` launch of B5's ``sol(t_eval)`` against its
  ``y_eval``, the hidden-M rows against the exact solution; each launch
  alone timed with and without the points;
* the host driver, the sensitivities and the front door (last):
  ``solve_ivp`` on the card against the same call on CPU tensors (VdP
  with BS5, ``t_eval``, dense output and two events; the CKdisc decay;
  Pleiades with CFMR7osc; Kepler with Fi5N; the pendulum DAE with Kv3I;
  Medazko N = 200 with KC4I and ``bands=True``; VdP with SWAG; the 2 x
  64 x 64 Brusselator with SSV2stab), each wall on both with ms a step
  and host syncs a step; a ``Stepper`` stepped by hand; the sensitivity
  functions on Robertson at the CVODES gates and ``solve_final``'s
  gradient against ``sens_forward``; ``ops.solve_fused`` once for each of
  the twelve kernels, and once more on B11 and B12 with params and
  t_eval and on B5, B6, B2 and B7 with t_eval, each to JAX's route and
  bit for bit the direct call.

Before that, it builds every kernel from the sources in this checkout
(one nvcc per variant, all started together) and holds each against its
plain PyTorch version on the card (B2 at the wrapper's lanes per member,
its thread body held to it bit for bit; B9 with its elementwise arrays
in shared and in global memory, bit for bit; B10 both at its cluster
size and in its one-block-per-member body).  Any mismatch raises; the script exits
0 only if every phase passed.

    python3 chip_smoke.py

The last line of output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launch count on its path (and
through the front door, ``launches_solve_fused``; B1's and B2's entries
also hold the sensitivity lines' launches, times and bounds, the keys
ending in ``_7b`` and ``_7a``, B4's and B7's those of the grid layout's,
ending in ``_sens_grid``, B1's, B2's, B4-B7's, B11's and B12's those of
the t_eval phases, ending in ``_teval``), its
largest difference from the plain version, its time, the plain version's
and its bound in ms (the least time the card could take: the larger of
its bytes over the memory rate and its operations over the float32 peak).
"""
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

MU = 3.0
T_SPAN = (0.0, 10.0)
N_MEMBERS = 4096
N_LARGE = 262_144
REPS = 5
PLAIN_TOL = dict(rtol=1e-4, atol=1e-6)
COMP_TOL = dict(rtol=1e-6, atol=1e-9, compensated=True)
# kernel against its plain version: f32 round-off (FMA contraction in the
# kernel, none in PyTorch's separate ops) makes single members take other
# step sequences; measured on an H100, max |dy| was 1.27e-2 (plain) and
# 3.7e-5 (compensated) at 4096 VdP members
PLAIN_GATE = 3e-2
COMP_GATE = 1e-4
# relative difference of mean nsteps, kernel against plain version
# (measured: 2.7e-4 plain, 1.5e-4 compensated at 1024 members)
STEP_GATE = 2e-3

VDP_CUDA = """
__device__ void rhs(float t, const float* y, float* dy) {
  dy[0] = y[1];
  dy[1] = 3.0f * (1.0f - y[0] * y[0]) * y[1] - y[0];
}
"""
HO_CUDA = """
__device__ void rhs(float t, const float* y, float* dy) {
  dy[0] = y[1];
  dy[1] = -y[0];
}
"""
CUBIC_CUDA = """
__device__ void rhs(float t, const float* y, float* dy) {
  dy[0] = y[1];
  dy[1] = y[0] * y[0] * y[0];
}
"""

# -- the implicit path -------------------------------------------------------
G = 9.81
PEND_N = 4096
PEND_SPAN = (0.0, 10.0)
PEND_TOL = dict(rtol=1e-4, atol=1e-6)
M_PEND = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
ROB_TOL = dict(rtol=1e-4, atol=1e-8)
ROB_COMP_TOL = dict(rtol=1e-6, atol=1e-9, compensated=True)
# kernel against its plain version: (max |dy| over finished members,
# relative difference of mean nsteps).  Measured on an H100 at 1024
# members: rob_kv3i 9.5e-7 / 1.3e-4, rob_trbdf2 7.7e-7 / 0, rob_comp
# 1.2e-7 / 5.2e-6, pend 1.0e-5 / 1.6e-5, kaps_hidden 2.1e-5 / 3.2e-3;
# at 4096 on the bench line (t = 10) 3.1e-3 / 1.2e-6.  Each gate keeps a
# margin of 3-10x on |dy| and 3x or more on steps
ESDIRK_GATES = {"rob_kv3i": (1e-5, 1e-3), "rob_trbdf2": (1e-5, 1e-3),
                "rob_comp": (1e-6, 1e-4), "pend": (1e-4, 1e-3),
                "kaps_hidden": (2e-4, 1e-2), "bench": (1e-2, 1e-4)}
# fused f32 against the f64 driver at t = 10 on the bench line: the JAX
# test's 1e-3 holds at t = 0.3; at t = 10 both lines carry rtol-1e-4
# global errors (the f64 driver's own constraint drift is 1.7e-2 there)
# and they part by 0.46 in lambda (|lambda| up to ~30), 7e-2 in the
# velocities (measured on an H100), so the gate is 1.0.  The fused
# line's constraint drift, 9.2e-4 measured, keeps the JAX test's 1e-3.
PEND_F64_GATE = 1.0
PEND_DRIFT_GATE = 1e-3
# the Kaps DAE behind a hidden mass matrix (the JAX test's A M B^-1)
_RNG = np.random.RandomState(1)
HID_A = _RNG.rand(2, 2)
HID_B = _RNG.rand(2, 2)
HID_BINV = np.linalg.inv(HID_B)
M_HIDDEN = HID_A @ np.array([[0.0, 0.0], [0.0, 1.0]]) @ HID_BINV

ROB_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy) {
  const T r1 = -0.04f * y[0] + 1e4f * y[1] * y[2];
  const T r3 = 3e7f * y[1] * y[1];
  dy[0] = r1;
  dy[1] = -r1 - r3;
  dy[2] = r3;
}
"""
PEND_CUDA = """
template <class T>
__device__ void rhs(T t, const T* s, T* ds) {
  ds[0] = s[2];
  ds[1] = s[3];
  ds[2] = -s[4] * s[0];
  ds[3] = -s[4] * s[1] - 9.81f;
  ds[4] = s[2] * s[2] + s[3] * s[3]
          - s[4] * (s[0] * s[0] + s[1] * s[1]) - 9.81f * s[1];
}
"""


def _lit(x):
    return f"{float(np.float32(x))!r}f"


KAPS_HIDDEN_CUDA = f"""
template <class T>
__device__ void rhs(T t, const T* z, T* dz) {{
  const T y0 = {_lit(HID_BINV[0, 0])} * z[0] + {_lit(HID_BINV[0, 1])} * z[1];
  const T y1 = {_lit(HID_BINV[1, 0])} * z[0] + {_lit(HID_BINV[1, 1])} * z[1];
  const T f0 = -y0 + y1 * y1;
  const T f1 = y0 - y1 - y1 * y1;
  dz[0] = {_lit(HID_A[0, 0])} * f0 + {_lit(HID_A[0, 1])} * f1;
  dz[1] = {_lit(HID_A[1, 0])} * f0 + {_lit(HID_A[1, 1])} * f1;
}}
"""


def robertson(t, y):
    r1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    r3 = 3e7 * y[1] * y[1]
    return torch.stack([r1, -r1 - r3, r3])


def pendulum(t, s):
    return torch.stack([s[2], s[3], -s[4] * s[0], -s[4] * s[1] - G,
                        s[2] * s[2] + s[3] * s[3]
                        - s[4] * (s[0] * s[0] + s[1] * s[1]) - G * s[1]])


def kaps_hidden(t, z):
    a, bi = HID_A.tolist(), HID_BINV.tolist()
    y0 = bi[0][0] * z[0] + bi[0][1] * z[1]
    y1 = bi[1][0] * z[0] + bi[1][1] * z[1]
    f0 = -y0 + y1 * y1
    f1 = y0 - y1 - y1 * y1
    return torch.stack([a[0][0] * f0 + a[0][1] * f1,
                        a[1][0] * f0 + a[1][1] * f1])


def vdp(t, y):
    return torch.stack([y[1], MU * (1 - y[0] ** 2) * y[1] - y[0]])


def oscillator(t, y):
    return torch.stack([y[1], -y[0]])


def cubic(t, y):
    return torch.stack([y[1], y[0] ** 3])


# the bound of a kernel: NVIDIA's data-sheet peaks of one H100 SXM (at its
# 700 W limit): HBM bytes/s and float32 operations/s outside the tensor
# cores (every kernel here is float32 scalar arithmetic)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float32 operations per RHS evaluation of each kernel's line, counted from
# the kernel source: the RHS plus the share of the stage sums, the error
# norm and the controller that one evaluation carries (BS5 on Van der Pol,
# Kv3I on the pendulum DAE with its dual-number Jacobian, LU and Newton
# solves), and for the RKC kernels per grid element (the Brusselator
# stencil, ~14, and the stage recurrence, ~9).  SWAG is counted by
# adams_ops (B3) and adams_grid_ops (B8)
OPS_PER_EVAL = {"fused_erk": 35, "fused_esdirk": 100}
OPS_PER_ELEMENT_EVAL = {"fused_rkc": 23}
# The explicit kernels B4, B5 and B6 (csrc/fused_rkn.cu, fused_rk_grid.cu)
# are counted from their sources and the tableau's nonzero weights, since
# zero weights drop out of the unrolled sums (csrc/rk_common.cuh): a sum
# of nnz weights costs 2 nnz - 1; per element (a position for RKN) stage
# I's argument adds 2 (RKN 6: the h^2 and h products, c h v, the u and v
# sums), the solution 2 (RKN 6), the error estimate 1 (RKN 2) and its
# scaled square 8 per state; a member's attempt adds ~30 for the step
# control and the norm.  A transcendental function counts as one
# operation, so the count is a lower bound.  RHS operations per element:
RHS_OPS = {"kepler": 7, "fisher": 5, "wave": 4, "swdec": 6, "ckmol": 11,
           # Van der Pol: 5 operations over its 2 states
           "vdp": 2.5}
CONTROL_OPS = 30


def _wsum_ops(w):
    return max(2 * int(np.count_nonzero(np.asarray(w, np.float32))) - 1, 0)


def rk_ops(k, rkn, n_row, rhs_ops, nfev_sum, members, start_evals):
    """float32 operations of a plain-mode run of B4, B5 or B6 (tableau
    constants ``k``, stage rows of ``n_row`` elements) whose members made
    ``nfev_sum`` RHS evaluations, ``start_evals`` each of them for the
    start: per attempt the stages, solution and error counted above, over
    the attempt's S evaluations (S - 1 stages, and the FSAL row or the
    endpoint of an accepted step)."""
    s, mm = k["s"], k["s"] + (1 if k["fsal"] else 0)

    def rows(name, i=None, length=None):
        both = (name, name + "p") if rkn else (name,)
        return sum(_wsum_ops(k[r][i, :i] if i is not None else k[r][:length])
                   for r in both)

    stage, sol, err = (6, 6, 2 + 16) if rkn else (2, 2, 1 + 8)
    per_elem = (sum(rows("A", i) + stage for i in range(1, s))
                + rows("B", length=s) + sol + rows("E", length=mm) + err)
    per_eval = n_row * (per_elem / s + rhs_ops) + CONTROL_OPS / s
    start = members * start_evals
    return (nfev_sum - start) * per_eval + start * n_row * rhs_ops


def bound_entry(bytes_moved, ops):
    """The ``kernels`` keys of a kernel's bound: the least time the card
    could take to read and write ``bytes_moved`` once and do ``ops``
    float32 operations, what bounds it, and the library call (none: no
    single PyTorch call computes a whole adaptive integration)."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": by,
            "library_ms": None}


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def vdp_y0(n, dtype):
    return torch.tensor(np.stack([np.linspace(1.5, 2.5, n), np.zeros(n)], 1),
                        dtype=dtype, device="cuda")


def wall_ms(fn, reps=REPS):
    """Median synchronized wall time of ``fn()`` over ``reps`` warm runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn):
    """Median device time of ``fn()`` between CUDA events, REPS runs."""
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def hold_against_plain(tag, label, kernel, plain, y_gate, step_gate,
                       dstep_gate=None, scaled=False):
    """Run ``kernel()`` and ``plain()`` (each returning ``(y, status,
    nsteps, nfev)`` for the same members), print how far apart they are and
    fail past the gates: identical status, max |dy| over the members the
    plain version finished (with ``scaled``, each component's |dy| over
    that component's largest |y| among them), relative difference of mean
    nsteps and, where given, max |dnsteps|.  Returns (kernel result, plain
    result, max |dy|, plain version's seconds)."""
    t0 = time.perf_counter()
    k = kernel()
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = plain()
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t0
    ok = r[1] == 1
    ydiff = 0.0
    if ok.any():
        dy = (k[0][ok] - r[0][ok]).abs()
        if scaled:
            dy = dy / r[0][ok].abs().amax(0)
        ydiff = dy.max().item()
    what = " over each component's largest" if scaled else ""
    step_rel = abs(k[2].double().mean().item()
                   / r[2].double().mean().item() - 1.0)
    print(f"{tag} kernel vs plain [{label}, {k[0].shape[0]}]: status equal "
          f"{torch.equal(k[1], r[1])}, max |dy|{what} {ydiff:.3e} (gate "
          f"{y_gate:.1e}), mean nsteps {k[2].double().mean():.4f} vs "
          f"{r[2].double().mean():.4f} (rel {step_rel:.2e}, gate "
          f"{step_gate:.1e}), max |dnsteps| "
          f"{(k[2] - r[2]).abs().max().item()}, mean nfev "
          f"{k[3].double().mean():.3f} vs {r[3].double().mean():.3f}, "
          f"members with other counts "
          f"{int(((k[2] != r[2]) | (k[3] != r[3])).sum())}; {k_s:.3f} s vs "
          f"{r_s:.3f} s")
    check(torch.equal(k[1], r[1]), f"{label}: status differs")
    check(bool(torch.isfinite(k[0][ok]).all()), f"{label}: non-finite")
    check(ydiff <= y_gate, f"{label}: |dy| {ydiff} > {y_gate}")
    check(step_rel <= step_gate, f"{label}: mean nsteps differ by {step_rel}")
    dsteps = (k[2] - r[2]).abs().max().item()
    check(dstep_gate is None or dsteps <= dstep_gate,
          f"{label}: max |dnsteps| {dsteps} > {dstep_gate}")
    return k, r, ydiff, r_s


def esdirk_builds():
    """(kernel, label, FusedRHS, (method, M)) of every implicit variant."""
    from extensisq_tpu_torch import Kv3I, TRBDF2
    from extensisq_tpu_torch.ops import FusedRHS
    rob = FusedRHS(robertson, ROB_CUDA, 3)
    return [("fused_esdirk", "robertson Kv3I", rob, (Kv3I, None)),
            ("fused_esdirk", "robertson TRBDF2", rob, (TRBDF2, None)),
            ("fused_esdirk", "pendulum Kv3I diag M",
             FusedRHS(pendulum, PEND_CUDA, 5), (Kv3I, M_PEND)),
            ("fused_esdirk", "kaps TRBDF2 hidden M",
             FusedRHS(kaps_hidden, KAPS_HIDDEN_CUDA, 2), (TRBDF2, M_HIDDEN))]


# -- the multistep path -----------------------------------------------------
SWAG_MU = 1000.0
SWAG_N = 256
SWAG_N_LARGE = 32_768
# the bench line's members per block: at 32 lanes per member, 64 blocks of
# 128 threads on 64 SMs (the wrapper takes the lanes, ops/fused_adams.py:
# _lanes_per_member)
SWAG_BLOCK_MEMBERS = 4
# the member counts timed beside the bench line, each at the wrapper's lanes
SWAG_SIZES = (1024, 4096, SWAG_N_LARGE)
SWAG_SPAN = (0.0, 20.0)
SWAG_TOL = dict(rtol=1e-6, atol=1e-9, k_max=12, max_steps=400_000)
# the span on which the plain version and the f64 driver, both host-bound
# (one attempt of every member per loop iteration), follow the kernel
SWAG_T_CUT = 0.5
SWAG_RADAU_MEMBERS = 8
# kernel against its plain version, 1024 members (256 on the cut span):
# (max |dy| over finished members, relative difference of mean nsteps).
# Measured on an H100: vdp 5.1e-5 / 1.3e-4, osc_comp 4.1e-6 / 6.1e-5,
# decay 6.0e-8 / 0, grow and cubic 0 / 0, bench_cut 1.2e-8 / 4.9e-3 (the
# stiff line: every member takes other steps, FMA against separate
# roundings); the gates keep a margin of 2-10x
ADAMS_GATES = {"vdp": (2e-4, 1e-3), "osc_comp": (2e-5, 5e-4),
               "decay": (1e-6, 1e-4), "grow": (1e-6, 1e-4),
               "cubic": (1e-6, 1e-4), "bench_cut": (1e-7, 1e-2)}
# the bench line against Radau (rtol 1e-12 / atol 1e-14) at t = 20: the
# starting gate 1e-5, measured 1.0e-7 on an H100; and the kernel against
# the f64 driver on the cut span, measured 1.2e-7
SWAG_RADAU_GATE = 1e-6
SWAG_F64_GATE = 1e-6
# the f64 driver on the card against the same 64 members on the CPU
# (max |dy|, relative difference of mean nsteps): measured on an H100
# 8.5e-9 and 1.4e-3, with 18 members taking other step counts
SWAG_CPU_GATE = 1e-7
SWAG_CPU_STEP_GATE = 1e-2


def _vdp_cuda(mu):
    return ("__device__ void rhs(float t, const float* y, float* dy) {\n"
            "  dy[0] = y[1];\n"
            f"  dy[1] = {_lit(mu)} * (1.0f - y[0] * y[0]) * y[1] - y[0];\n}}")


def vdp_mu(mu):
    return lambda t, y: torch.stack([y[1], mu * (1 - y[0] ** 2) * y[1]
                                     - y[0]])


DECAY_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy) { dy[0] = -y[0]; }
"""
GROW_CUDA = """
__device__ void rhs(float t, const float* y, float* dy) { dy[0] = y[0]; }
"""


def adams_rhs():
    """The FusedRHS of every SWAG variant, by label."""
    from extensisq_tpu_torch.ops import FusedRHS
    return {"vdp": FusedRHS(vdp_mu(5.0), _vdp_cuda(5.0), 2),
            "osc": FusedRHS(oscillator, HO_CUDA, 2),
            "decay": FusedRHS(lambda t, y: -y, DECAY_CUDA, 1),
            "grow": FusedRHS(lambda t, y: 1.0 * y, GROW_CUDA, 1),
            "cubic": FusedRHS(cubic, CUBIC_CUDA, 2),
            "bench": FusedRHS(vdp_mu(SWAG_MU), _vdp_cuda(SWAG_MU), 2)}


ADAMS_KMAX = {"vdp": 6, "osc": 8, "decay": 6, "grow": 6, "cubic": 6,
              "bench": 12}


def adams_builds(rhs):
    """(kernel, label, FusedRHS, k_max) of every SWAG variant."""
    return [("fused_adams", f"{label} k_max={km}", rhs[label], km)
            for label, km in ADAMS_KMAX.items()]


def build_all(jobs):
    """Build every (kernel, label, rhs, options) variant with one nvcc
    each, all started together; print seconds, registers and spills.  A
    kernel name ending in ``_rec`` (B1-B8) is the build with the dense
    record, in ``_snap`` (B1, B2, B4-B7, B11, B12) the build with the
    t_eval snapshots, in ``_rec_snap`` (B1, B4, B5) with both."""
    from extensisq_tpu_torch import BS5
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_adams import _adams_consts
    from extensisq_tpu_torch.ops.fused_ckdisc import ck_consts
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    from extensisq_tpu_torch.ops.fused_esdirk import (_esdirk_consts,
                                                      _mass_setup)
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts

    def build(job):
        kernel, _, rhs, opt = job
        snap = kernel.endswith("_snap")
        kernel = kernel.removesuffix("_snap")
        rec = kernel.endswith("_rec")
        kernel = kernel.removesuffix("_rec")
        if kernel == "fused_rkn":
            return _build.load_fused_rkn(rkn_consts(opt), rhs.m,
                                         rhs.cuda_src, rhs.k, rec, snap)
        if kernel == "fused_erk_grid":
            return _build.load_fused_rk_grid(
                _fused_consts(opt), False, rhs.shape, rhs.cuda_src, rhs.k,
                rec, snap)
        if kernel == "fused_rkn_grid":
            return _build.load_fused_rk_grid(rkn_consts(opt), True,
                                             (rhs.n,), rhs.cuda_src, rhs.k,
                                             rec, snap)
        if kernel == "fused_ckdisc":
            return _build.load_fused_ckdisc(ck_consts(), rhs.n, rhs.cuda_src,
                                            rhs.k, snap)
        if kernel == "fused_ckdisc_grid":
            return _build.load_fused_rk_grid(ck_consts(), False, rhs.shape,
                                             rhs.cuda_src, rhs.k, False,
                                             snap)
        if kernel == "fused_erk":
            return _build.load_fused_erk(_fused_consts(BS5), rhs.n,
                                         rhs.cuda_src, rhs.k, rec, snap)
        if kernel == "fused_adams":
            return _build.load_fused_adams(_adams_consts(opt, rhs.n),
                                           rhs.cuda_src, rhs.k, rec)
        if kernel == "fused_adams_grid":
            return _build.load_fused_adams_grid(
                _adams_consts(opt, rhs.shape[0]), rhs.shape, rhs.cuda_src,
                rhs.k, rec)
        if kernel == "fused_esdirk_grid":
            method, nb = opt if isinstance(opt, tuple) else (opt, None)
            return _build.load_fused_esdirk_grid(
                _esdirk_consts(method), rhs.shape, rhs.cuda_src, rhs.k, nb,
                rec, snap)
        if kernel == "fused_rkc":
            n_par, rho = opt
            return _build.load_fused_rkc(rhs.shape, n_par, rhs.cuda_src,
                                         None if rho is None
                                         else rho.cuda_src)
        method, M, *nb = opt
        return _build.load_fused_esdirk(_esdirk_consts(method),
                                        *_mass_setup(M, rhs.n), rhs.n,
                                        rhs.cuda_src, rhs.k,
                                        nb[0] if nb else None, rec, snap)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build, jobs))
    for (kernel, label, _, _), b in zip(jobs, built):
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {kernel}[{label}]: {b.seconds:.2f} s; "
              + "; ".join(regs))
    print(f"builds: {time.perf_counter() - t0:.2f} s wall for {len(jobs)} "
          "variants in parallel")


def _launch_esdirk(rhs, span, y0, kw, lanes):
    """B2 at ``lanes`` lanes per member (a comparison launch, not counted):
    ((y, status, nsteps, nfev), (lanes, members per block))."""
    from extensisq_tpu_torch.ops import fused_esdirk as FE
    kw = dict(kw)
    return FE._launch(rhs, span, y0, kw.pop("method", None),
                      kw.pop("M", None), kw.pop("yp0_batch", None),
                      kw.pop("rtol"), kw.pop("atol"),
                      kw.pop("first_step", None),
                      kw.pop("max_steps", 100_000),
                      kw.pop("compensated", False), kw.pop("max_step", None),
                      lanes, None, kw.pop("params", None),
                      kw.pop("block_base", None))


def pend_start(n, device, t_bound=PEND_SPAN[1]):
    """The bench line's members, theta0 in [0.2, 1.2], and their
    consistent (y0, yp0) from the f64 stepper's DAE projection."""
    from extensisq_tpu_torch import Kv3I
    from extensisq_tpu_torch.steppers import build_stepper
    from extensisq_tpu_torch.types import IVPParams
    th = np.linspace(0.2, 1.2, n)
    y0 = torch.tensor(np.stack([np.sin(th), -np.cos(th), np.zeros(n),
                                np.zeros(n), np.zeros(n)], 1),
                      dtype=torch.float64, device=device)
    stepper = build_stepper(Kv3I, pendulum, 5, torch.float64,
                            M=np.diag(M_PEND))
    st = stepper.init(0.0, y0.T.contiguous(), IVPParams(
        t_bound=t_bound, direction=1.0, max_step=np.inf, **PEND_TOL))
    return y0, st.y.T.contiguous(), st.yp.T.contiguous()


# the bench line's plain version and f64 driver runs, with the t_eval
# points of the pend4096-kv3i-teval line, for teval_routes_path
PEND_RUNS = {}


def esdirk_path():
    """Hold the implicit kernel against its plain version on the card,
    drive the bench line, time it; returns its ``kernels`` entry.  The
    bench line's plain version and f64 driver run once each, with the
    pend4096-kv3i-teval line's points (which leave their other outputs as
    they are), and their times are those runs' (``PEND_RUNS`` keeps them
    for teval_routes_path)."""
    from extensisq_tpu_torch import Kv3I, TRBDF2, solve_ensemble
    from extensisq_tpu_torch.ops import (FusedRHS, fused_esdirk_reference,
                                         solve_fused_erk, solve_fused_esdirk)
    ROB = FusedRHS(robertson, ROB_CUDA, 3)
    PEND = FusedRHS(pendulum, PEND_CUDA, 5)
    KAPS = FusedRHS(kaps_hidden, KAPS_HIDDEN_CUDA, 2)

    def compare(label, rhs, span, y0, plain_kw=None, **kw):
        """The kernel at the rule's launch shape (a lane group per member
        at these sizes) against the plain version (with the options
        ``plain_kw`` besides ``kw``) at the label's gates, and the thread
        body against it bit for bit; returns (kernel result, plain result,
        max |dy|, the plain version's seconds)."""
        nb = y0.shape[0]
        k, r, dy, r_s = hold_against_plain(
            "esdirk", label, lambda: solve_fused_esdirk(rhs, span, y0, **kw),
            lambda: fused_esdirk_reference(rhs, span, y0, **kw,
                                           **(plain_kw or {})),
            *ESDIRK_GATES[label])
        lanes = solve_fused_esdirk.last_shape[0]
        check(lanes > 1, f"esdirk {label}: the rule took one thread per "
              f"member at {nb} members")
        thread, _ = _launch_esdirk(rhs, span, y0, kw, 1)
        same = all(torch.equal(a, b) for a, b in zip(k, thread))
        print(f"esdirk [{label}]: {shape_text(solve_fused_esdirk, nb)}; "
              f"one thread per member bit-identical {same}")
        check(same, f"esdirk {label}: the lane body and the thread body "
              "differ")
        return k, r, dy, r_s

    # (a) every variant against its plain version, 1024 members
    rob0 = torch.zeros(1024, 3, device="cuda")
    rob0[:, 0] = torch.linspace(0.9, 1.1, 1024, device="cuda")
    compare("rob_kv3i", ROB, (0.0, 10.0), rob0, method=Kv3I, **ROB_TOL)
    compare("rob_trbdf2", ROB, (0.0, 10.0), rob0, method=TRBDF2, **ROB_TOL)
    compare("rob_comp", ROB, (0.0, 1e5), rob0, method=Kv3I, **ROB_COMP_TOL)
    _, p0, pp0 = pend_start(1024, "cuda", t_bound=1.0)
    k = compare("pend", PEND, (0.0, 1.0), p0.float(), method=Kv3I,
                M=M_PEND, yp0_batch=pp0.float(), **PEND_TOL)[0]
    drift = (k[0][:, 0] ** 2 + k[0][:, 1] ** 2 - 1.0).abs().max().item()
    print(f"pendulum t = 1: constraint drift {drift:.3e} (gate 1e-3)")
    check(drift < 1e-3, "pendulum: constraint drift")
    a = np.linspace(0.8, 1.2, 1024)
    kz0 = torch.tensor((HID_B @ np.stack([a * a, a])).T, dtype=torch.float32,
                       device="cuda")
    kzp0 = torch.tensor((HID_B @ np.stack([-2 * a * a, -a])).T,
                        dtype=torch.float32, device="cuda")
    k = compare("kaps_hidden", KAPS, (0.0, 1.0), kz0, method=TRBDF2,
                M=M_HIDDEN, yp0_batch=kzp0, rtol=1e-4, atol=1e-6)[0]
    yk = k[0].double().cpu().numpy() @ HID_BINV.T
    exact = np.stack([a * a * np.exp(-2.0), a * np.exp(-1.0)], 1)
    err = np.abs(yk - exact).max()
    print(f"kaps hidden M: kernel error vs exact {err:.3e} (gate 3e-4)")
    check(err < 3e-4, "kaps hidden M: error vs exact")

    # (b) the bench line: 4096 pendulum members, f64 projection, fused f32
    # and the f64 driver at the same tolerances (the f64 run with the
    # t_eval points of pend4096-kv3i-teval, timed on its own)
    tq_pend = np.linspace(*PEND_SPAN, TE_N_EVAL).astype(np.float32)
    solve_fused_erk.launches = 0
    solve_fused_esdirk.launches = 0
    t0 = time.perf_counter()
    y64, yc, ypc = pend_start(PEND_N, "cuda")
    Y0, YP0 = yc.float(), ypc.float()
    fused = solve_fused_esdirk(PEND, PEND_SPAN, Y0, method=Kv3I, M=M_PEND,
                               yp0_batch=YP0, **PEND_TOL)
    shape = solve_fused_esdirk.last_shape
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ens = solve_ensemble(pendulum, PEND_SPAN, y64, method=Kv3I,
                         M=np.diag(M_PEND), t_eval=torch.tensor(
                             tq_pend, dtype=torch.float64, device="cuda"),
                         **PEND_TOL)
    torch.cuda.synchronize()
    f64_ms = (time.perf_counter() - t1) * 1e3
    path_s = time.perf_counter() - t0
    launches = solve_fused_esdirk.launches
    print(f"implicit path: {path_s:.3f} s, fused_esdirk launches "
          f"{launches}, fused_erk launches {solve_fused_erk.launches}; "
          f"{PEND_N} members at {shape_text(solve_fused_esdirk, PEND_N)}")
    check(launches == 1, f"fused_esdirk launched {launches} times, "
          "expected 1")
    check(solve_fused_erk.launches == 0,
          "the implicit path launched the explicit kernel")
    check(bool((fused[1] == 1).all()), "bench line: not all finished")
    check(bool((ens.status == 1).all()), "f64 pendulum: not all finished")
    check(fused[0].shape == (PEND_N, 5)
          and bool(torch.isfinite(fused[0]).all()), "bench line: bad output")
    drift = (fused[0][:, 0] ** 2 + fused[0][:, 1] ** 2 - 1.0).abs().max()
    drift64 = (ens.y[:, 0] ** 2 + ens.y[:, 1] ** 2 - 1.0).abs().max()
    dcomp = (fused[0].double() - ens.y).abs().amax(0)
    d64 = dcomp.max().item()
    print(f"bench line: constraint drift {drift.item():.3e} (gate "
          f"{PEND_DRIFT_GATE:.0e}; f64 driver {drift64.item():.3e}), fused "
          f"vs f64 max |dy| {d64:.3e} (gate {PEND_F64_GATE:.0e}; per "
          f"component {', '.join(f'{v:.2e}' for v in dcomp.tolist())}), "
          f"mean nsteps {fused[2].double().mean():.3f} vs "
          f"{ens.nsteps.double().mean():.3f}, max {int(fused[2].max())} vs "
          f"{int(ens.nsteps.max())}")
    check(drift.item() < PEND_DRIFT_GATE, "bench line: constraint drift")
    check(d64 < PEND_F64_GATE, "bench line: fused and f64 disagree")
    idx = torch.linspace(0, PEND_N - 1, 64).long()
    cpu = solve_ensemble(pendulum, PEND_SPAN, y64[idx].cpu(), method=Kv3I,
                         M=np.diag(M_PEND), **PEND_TOL)
    for f in ("status", "nsteps", "nfev", "nfailed"):
        check(torch.equal(getattr(ens, f)[idx].cpu(), getattr(cpu, f)),
              f"f64 pendulum: {f} differs between the card and the CPU")
    # round-off of the card's and the CPU's LU and matrix products grows
    # over ~700 steps; |lambda| reaches ~30, so the gate is 1e-12 relative
    # to max(1, |y|) (measured on an H100: 3.9e-12 absolute)
    dabs = (ens.y[idx].cpu() - cpu.y).abs()
    dcpu = dabs.max().item()
    drel = (dabs / cpu.y.abs().clamp(min=1.0)).max().item()
    print(f"f64 pendulum: card vs CPU on 64 members: counts equal, max |dy| "
          f"{dcpu:.3e}, relative to max(1, |y|) {drel:.3e} (gate 1e-12)")
    check(drel <= 1e-12, "f64 pendulum: card and CPU disagree")
    _, ref, err_k, plain_s = compare(
        "bench", PEND, PEND_SPAN, Y0, plain_kw=dict(t_eval=tq_pend),
        method=Kv3I, M=M_PEND, yp0_batch=YP0, **PEND_TOL)
    plain_ms = plain_s * 1e3
    PEND_RUNS.update(y0=Y0, yp0=YP0, tq=tq_pend, plain=ref, f64=ens,
                     plain_ms=plain_ms, f64_ms=f64_ms)
    # the bench line's launch against the other body, bit for bit
    other = 1 if shape[0] > 1 else 4
    same = all(torch.equal(a, b) for a, b in zip(fused, _launch_esdirk(
        PEND, PEND_SPAN, Y0, dict(method=Kv3I, M=M_PEND, yp0_batch=YP0,
                                  **PEND_TOL), other)[0]))
    print(f"bench line: {shape[0]} lanes per member (the rule's) and "
          f"{other} bit-identical {same}")
    check(same, "bench line: the lane body and the thread body differ")

    # (c) times: the kernel's warm, synchronized medians; the host-bound
    # references, ~15-40 s a run, from their runs above (one each: the
    # plain version's the bench check's, after its 1,024-member checks,
    # the f64 driver's the path's first)
    def run_kernel():
        return solve_fused_esdirk(PEND, PEND_SPAN, Y0, method=Kv3I,
                                  M=M_PEND, yp0_batch=YP0, **PEND_TOL)

    k_ms = wall_ms(run_kernel)
    k_dev = event_ms(run_kernel)
    max_steps = int(fused[2].max())
    steps = int(fused[2].sum())
    print(f"time [fused_esdirk kernel] {PEND_N} members: {k_ms:.3f} ms wall, "
          f"{k_dev:.4f} ms device (CUDA events), {k_ms / max_steps:.5f} ms "
          f"per step (wall / max nsteps {max_steps}), "
          f"{steps / k_ms * 1e3:.4g} accepted steps/s")
    print(f"time [plain version] {PEND_N} members: {plain_ms:.3f} ms wall "
          f"(the bench check's run, with {TE_N_EVAL} t_eval points), "
          f"{int(ref[2].sum()) / plain_ms * 1e3:.4g} accepted steps/s")
    print(f"time [f64 solve_ensemble] {PEND_N} members: {f64_ms:.3f} ms wall "
          f"(the path's run, with {TE_N_EVAL} t_eval points), "
          f"{int(ens.nsteps.sum()) / f64_ms * 1e3:.4g} accepted steps/s")
    # the kernel on a full card: 262,144 members, the rule's launch shape
    _, yl, ypl = pend_start(N_LARGE, "cuda")
    Yl, YPl = yl.float(), ypl.float()

    def run_large():
        return solve_fused_esdirk(PEND, PEND_SPAN, Yl, method=Kv3I,
                                  M=M_PEND, yp0_batch=YPl, **PEND_TOL)

    out = run_large()
    large_ms = event_ms(run_large)
    check(bool((out[1] == 1).all()), "pendulum 262,144: not all finished")
    print(f"fused_esdirk kernel {N_LARGE} members "
          f"({shape_text(solve_fused_esdirk, N_LARGE)}): {large_ms:.3f} ms, "
          f"max nsteps {int(out[2].max())}, "
          f"{int(out[2].sum()) / large_ms * 1e3:.4g} accepted steps/s")
    return dict({"name": "fused_esdirk", "route": "cuda",
                 "source": "extensisq_tpu_torch/csrc/fused_esdirk.cu",
                 "replaces": "extensisq_tpu/ops/fused_esdirk.py:1001",
                 "launches": launches, "max_abs_err": err_k, "ms": k_ms,
                 "plain_ms": plain_ms, "device_ms": k_dev,
                 "ms_per_step": k_ms / max_steps, "f64_ms": f64_ms,
                 "lanes": shape[0], "large_ms": large_ms},
                **bound_entry(PEND_N * 5 * 4 * 3 + PEND_N * 4 * 3,
                              int(fused[3].sum()) * OPS_PER_EVAL[
                                  "fused_esdirk"]))


def radau_reference(y0, t_end):
    """VdP mu = SWAG_MU from each row of y0 (f64 numpy) to t_end with
    scipy's Radau at rtol 1e-12 / atol 1e-14, on the host (a reference of
    this script only, never a dependency of the port)."""
    from scipy.integrate import solve_ivp
    mu = SWAG_MU

    def f(t, y):
        return [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]

    def jac(t, y):
        return [[0.0, 1.0], [-2.0 * mu * y[0] * y[1] - 1.0,
                             mu * (1 - y[0] ** 2)]]

    out = []
    for row in y0:
        sol = solve_ivp(f, (0.0, t_end), row, method="Radau", rtol=1e-12,
                        atol=1e-14, jac=jac)
        check(sol.success, "Radau reference failed")
        out.append(sol.y[:, -1])
    return np.array(out)


def adams_path():
    """Hold the SWAG kernel against its plain version on the card, drive
    the bench line, time it; returns its ``kernels`` entry."""
    from extensisq_tpu_torch import SWAG, solve_ensemble
    from extensisq_tpu_torch.ops import (fused_adams_reference,
                                         solve_fused_adams, solve_fused_erk,
                                         solve_fused_esdirk)
    from extensisq_tpu_torch.ops.fused_adams import _host_init
    R = adams_rhs()

    def compare(label, rhs, span, y0, **kw):
        return hold_against_plain(
            "adams", label, lambda: solve_fused_adams(R[rhs], span, y0, **kw),
            lambda: fused_adams_reference(R[rhs], span, y0, **kw),
            *ADAMS_GATES[label])

    # (a) the kernel against its plain version, 1024 members
    x0 = torch.tensor(np.stack([np.linspace(1.9, 2.1, 1024),
                                np.zeros(1024)], 1), dtype=torch.float32,
                      device="cuda")
    compare("vdp", "vdp", (0.0, 2.0), x0, rtol=1e-4, atol=1e-6, k_max=6)
    # the same members repeated to 4096 and 32,768, where the wrapper takes
    # 8 lanes per member and one
    for nb in (4096, SWAG_N_LARGE):
        xr = x0.repeat(nb // 1024, 1)
        hold_against_plain(
            "adams", f"vdp x{nb // 1024}",
            lambda: solve_fused_adams(R["vdp"], (0.0, 2.0), xr, rtol=1e-4,
                                      atol=1e-6, k_max=6),
            lambda: fused_adams_reference(R["vdp"], (0.0, 2.0), xr,
                                          rtol=1e-4, atol=1e-6, k_max=6),
            *ADAMS_GATES["vdp"])
        print(f"  {nb} members: {shape_text(solve_fused_adams, nb)}")
    ho0 = torch.tensor([[1.0, 0.0]], device="cuda") \
        * torch.linspace(0.9, 1.1, 1024, device="cuda")[:, None]
    compare("osc_comp", "osc", (0.0, 6.0), ho0, rtol=1e-6, atol=1e-9,
            k_max=8, compensated=True)
    one = torch.ones(1024, 1, device="cuda")
    k, _, _, _ = compare("decay", "decay", (1e6, 1e6 + 1.0), one, rtol=1e-4,
                         atol=1e-7, k_max=6, max_steps=3000)
    err = (k[0] - np.exp(-1.0)).abs().max().item()
    print(f"decay on (1e6, 1e6 + 1): kernel error {err:.3e} (gate 1e-3)")
    check(err < 1e-3, "decay at t0 = 1e6: error")
    k, _, _, _ = compare("grow", "grow", (1.0, 0.0), one, rtol=1e-5,
                         atol=1e-8, k_max=6, max_steps=3000)
    err = (k[0] - np.exp(-1.0)).abs().max().item()
    print(f"growth backward on (1, 0): kernel error {err:.3e} (gate 1e-4)")
    check(err < 1e-4, "backward growth: error")
    xc = np.full(1024, 0.1, np.float32)
    xc[7] = 1e18                      # this member overflows in f32
    cub0 = torch.tensor(np.stack([xc, np.zeros_like(xc)], 1), device="cuda")
    k, _, _, _ = compare("cubic", "cubic", (0.0, 1.0), cub0, rtol=1e-4,
                         atol=1e-6, k_max=6, max_steps=2000)
    check(int(k[1][7]) == 3 and int((k[1] == 1).sum()) == 1023,
          "overflow isolation: member 7 must end with status 3 alone")

    # (b) the bench line: 256 members, the whole span, compensated
    y0 = torch.tensor(np.stack([np.linspace(1.9, 2.1, SWAG_N),
                                np.zeros(SWAG_N)], 1), dtype=torch.float32,
                      device="cuda")
    solve_fused_erk.launches = 0
    solve_fused_esdirk.launches = 0
    solve_fused_adams.launches = 0
    t0 = time.perf_counter()
    comp = solve_fused_adams(R["bench"], SWAG_SPAN, y0,
                             block_members=SWAG_BLOCK_MEMBERS,
                             compensated=True, **SWAG_TOL)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = solve_fused_adams.launches
    lanes, bm = solve_fused_adams.last_shape
    work = solve_fused_adams.last_work.long().sum(0).tolist()
    print(f"multistep path: {path_s:.3f} s, fused_adams launches {launches}"
          f"; {shape_text(solve_fused_adams, SWAG_N)}")
    check(launches == 1, f"fused_adams launched {launches} times, expected 1")
    check(solve_fused_erk.launches == 0 and solve_fused_esdirk.launches == 0,
          "the multistep path launched another kernel")
    check(bool((comp[1] == 1).all()), "SWAG bench line: not all finished")
    check(comp[0].shape == (SWAG_N, 2) and bool(torch.isfinite(comp[0]).all()),
          "SWAG bench line: bad output")
    plain = solve_fused_adams(R["bench"], SWAG_SPAN, y0,
                              block_members=SWAG_BLOCK_MEMBERS, **SWAG_TOL)
    torch.cuda.synchronize()
    idx = torch.linspace(0, SWAG_N - 1, SWAG_RADAU_MEMBERS).long()
    t0 = time.perf_counter()
    ref = radau_reference(y0[idx].double().cpu().numpy(), SWAG_SPAN[1])
    radau_s = time.perf_counter() - t0
    err_comp = np.abs(comp[0][idx].double().cpu().numpy() - ref).max()
    err_plain = np.abs(plain[0][idx].double().cpu().numpy() - ref).max()
    print(f"SWAG bench line vs Radau (rtol 1e-12, {SWAG_RADAU_MEMBERS} "
          f"members, {radau_s:.1f} s): compensated {err_comp:.3e} (gate "
          f"{SWAG_RADAU_GATE:.0e}), plain f32 {err_plain:.3e} (status "
          f"{torch.unique(plain[1]).tolist()}, not gated); mean nsteps "
          f"{comp[2].double().mean():.1f} compensated, "
          f"{plain[2].double().mean():.1f} plain, max {int(comp[2].max())}")
    check(err_comp <= SWAG_RADAU_GATE, "SWAG bench line: error vs Radau")

    # (c) on the cut span: the kernel against its plain version and the
    # f64 driver; 64 members of the f64 run again on the CPU
    cut = (SWAG_SPAN[0], SWAG_T_CUT)
    k, _, err_k, plain_s = compare("bench_cut", "bench", cut, y0,
                                   compensated=True, **SWAG_TOL)
    y64 = y0.double()
    t0 = time.perf_counter()
    ens = solve_ensemble(vdp_mu(SWAG_MU), cut, y64, method=SWAG,
                         rtol=SWAG_TOL["rtol"], atol=SWAG_TOL["atol"],
                         k_max=SWAG_TOL["k_max"], max_steps=100_000)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    check(bool((ens.status == 1).all()), "f64 SWAG: not all finished")
    d64 = (k[0].double() - ens.y).abs().max().item()
    print(f"cut span t in [0, {SWAG_T_CUT}]: kernel {int(k[2].max())} steps "
          f"(max), f64 driver {int(ens.nsteps.max())} (mean "
          f"{ens.nsteps.double().mean():.1f}, {f64_s:.1f} s), kernel vs f64 "
          f"max |dy| {d64:.3e} (gate {SWAG_F64_GATE:.0e})")
    check(d64 <= SWAG_F64_GATE, "SWAG cut span: kernel and f64 disagree")
    sel = torch.linspace(0, SWAG_N - 1, 64).long()
    cpu = solve_ensemble(vdp_mu(SWAG_MU), cut, y64[sel].cpu(), method=SWAG,
                         rtol=SWAG_TOL["rtol"], atol=SWAG_TOL["atol"],
                         k_max=SWAG_TOL["k_max"], max_steps=100_000)
    # the card's and the CPU's log10, pow and sqrt differ in the last bit
    # (the starting step of 3 of 8 members here), and this stiff line's
    # order and step selection carries that on, so the counts part
    check(torch.equal(ens.status[sel].cpu(), cpu.status),
          "f64 SWAG: status differs between the card and the CPU")
    dns = (ens.nsteps[sel].cpu() - cpu.nsteps).abs()
    step_rel = abs(ens.nsteps[sel].double().mean().item()
                   / cpu.nsteps.double().mean().item() - 1.0)
    dcpu = (ens.y[sel].cpu() - cpu.y).abs().max().item()
    print(f"f64 SWAG: card vs CPU on 64 members: status equal, members with "
          f"other nsteps {int((dns != 0).sum())}, max |dnsteps| "
          f"{int(dns.max())}, mean nsteps rel {step_rel:.2e} (gate "
          f"{SWAG_CPU_STEP_GATE:.0e}), max |dy| {dcpu:.3e} (gate "
          f"{SWAG_CPU_GATE:.0e})")
    check(dcpu <= SWAG_CPU_GATE, "f64 SWAG: card and CPU disagree")
    check(step_rel <= SWAG_CPU_STEP_GATE,
          "f64 SWAG: card and CPU step counts disagree")

    # (d) times: warm medians of the kernel on the whole span
    def run_kernel(y=y0, bm=SWAG_BLOCK_MEMBERS):
        return solve_fused_adams(R["bench"], SWAG_SPAN, y, block_members=bm,
                                 compensated=True, **SWAG_TOL)

    def slowest_attempts(y, out):
        """Attempts of the member that made the most (each one evaluates f
        once, and an accepted one once more; init's evaluations apart)."""
        _, s0, _ = _host_init(R["bench"].torch_fn, SWAG_SPAN, y.T,
                              SWAG_TOL["rtol"], SWAG_TOL["atol"], None,
                              SWAG_TOL["k_max"], None)
        return int((out[3] - s0.nfev - out[2]).max()), int(s0.nfev.sum())

    k_ms = wall_ms(run_kernel)
    k_dev = event_ms(run_kernel)
    max_steps = int(comp[2].max())
    steps = int(comp[2].sum())
    fev = int(comp[3].sum())
    attempts, init_fev = slowest_attempts(y0, comp)
    ops = adams_ops(2, RHS_OPS["vdp"], True, work, fev - init_fev)
    print(f"B3 work at the orders taken: {work[0]} attempts, mean order "
          f"{work[1] / work[0]:.3f}, {work[3] / work[0]:.3f} coefficient "
          f"elements and {work[4] / work[0]:.3f} v and g element steps per "
          f"attempt: {ops:.6g} float32 operations, {ops / work[0]:.1f} per "
          f"attempt")
    print(f"time [fused_adams kernel] {SWAG_N} members, t in "
          f"[0, {SWAG_SPAN[1]:g}], {lanes} lanes per member, {bm} members "
          f"per block: {k_ms:.3f} ms wall, {k_dev:.3f} ms device (CUDA "
          f"events), {k_ms / max_steps:.5f} ms per step (wall / max nsteps "
          f"{max_steps}), {k_dev / attempts:.5f} ms device per attempt of "
          f"the slowest member ({attempts} attempts), "
          f"{steps / k_ms * 1e3:.4g} accepted steps/s, "
          f"{fev / k_ms * 1e3:.4g} RHS evals/s")
    print(f"time [plain version] {SWAG_N} members, t in [0, {SWAG_T_CUT}] "
          f"(cut span): {plain_s * 1e3:.1f} ms wall, one run; "
          f"[f64 solve_ensemble] same span: {f64_s * 1e3:.1f} ms wall")
    sizes = {}
    for nb in SWAG_SIZES:
        yl = torch.tensor(np.stack([np.linspace(1.9, 2.1, nb),
                                    np.zeros(nb)], 1),
                          dtype=torch.float32, device="cuda")
        out = run_kernel(yl, None)
        shape = shape_text(solve_fused_adams, nb)
        ms = event_ms(lambda: run_kernel(yl, None))
        check(bool((out[1] == 1).all()), f"SWAG {nb}: not all finished")
        att, _ = slowest_attempts(yl, out)
        print(f"time [fused_adams kernel] {nb} members, {shape}: "
              f"{ms:.3f} ms device, max nsteps {int(out[2].max())}, "
              f"{ms / att:.5f} ms per attempt of the slowest member, "
              f"{int(out[2].sum()) / ms * 1e3:.4g} accepted steps/s")
        sizes[nb] = (solve_fused_adams.last_shape[0], ms)
    return dict({"name": "fused_adams", "route": "cuda",
                 "source": "extensisq_tpu_torch/csrc/fused_adams.cu",
                 "replaces": "extensisq_tpu/ops/fused_adams.py:876",
                 "launches": launches, "max_abs_err": err_k, "ms": k_ms,
                 "plain_ms": plain_s * 1e3, "plain_span": [0.0, SWAG_T_CUT],
                 "device_ms": k_dev, "ms_per_step": k_ms / max_steps,
                 "lanes_per_member": lanes, "block_members": bm,
                 "ms_per_attempt": k_dev / attempts,
                 "f64_ms_cut_span": f64_s * 1e3,
                 "err_vs_radau": float(err_comp),
                 **{f"ms_{nb}": ms for nb, (_, ms) in sizes.items()},
                 **{f"lanes_{nb}": g for nb, (g, _) in sizes.items()},
                 "ops_per_attempt": ops / work[0]},
                **bound_entry(SWAG_N * (2 * 4 * 3 + 4 * 5), ops))


def shape_text(wrapper, nb):
    """The launch shape of ``wrapper``'s last launch of ``nb`` members."""
    lanes, bm = wrapper.last_shape
    blocks = -(-nb // bm)
    return (f"{lanes} lanes per member, {bm} members per block ({blocks} "
            f"blocks of {bm * lanes} threads)")


def small_launch(kind, rhs, span, y0, kw, lanes):
    """B1 (``kind`` fused_erk), B5 (fused_rkn) or B11 (fused_ckdisc) at
    ``lanes`` lanes per member (a comparison launch, not counted): (y,
    status, nsteps, nfev)."""
    from extensisq_tpu_torch.ops import fused_ckdisc as FC
    from extensisq_tpu_torch.ops import fused_erk as FK
    from extensisq_tpu_torch.ops import fused_rkn as FN
    kw = dict(kw)
    if kind == "fused_ckdisc":
        return FC._launch(rhs, span, y0, kw.pop("rtol"), kw.pop("atol"),
                          kw.pop("first_step", None),
                          kw.pop("max_steps", 100_000),
                          kw.pop("max_step", None), lanes)[0]
    mod = FK if kind == "fused_erk" else FN
    extra = (None, kw.pop("params", None))
    return mod._launch(rhs, span, y0, kw.pop("method", None), kw.pop("rtol"),
                       kw.pop("atol"), kw.pop("first_step", None),
                       kw.pop("max_steps", 100_000),
                       kw.pop("compensated", False),
                       kw.pop("max_step", None), lanes, *extra)[0]


def hold_small_lanes(kind, label, rhs, span, y0, kw, k, shape):
    """B1, B5 or B11 on a check whose wrapper run ``k`` took the rule's
    ``shape`` (lanes, members per block): bit for bit against the other
    body, one thread per member where the rule took a lane group, else 2
    lanes."""
    other = 1 if shape[0] > 1 else 2
    same = all(torch.equal(a, b) for a, b in zip(
        k, small_launch(kind, rhs, span, y0, kw, other)))
    print(f"{kind} [{label}, {y0.shape[0]}]: {shape[0]} lanes per member, "
          f"{shape[1]} members per block (the rule's); {other} lanes "
          f"bit-identical {same}")
    check(same, f"{kind} {label}: {shape[0]} lanes and {other} differ")


def grid_shape_text(shape, nb):
    """A mid-size kernel's launch shape ``(threads, warp members)`` for
    ``nb`` members (B7, B6, B4, B12)."""
    threads, warp = shape
    if warp:
        return (f"one warp per member, {warp} members per block "
                f"({-(-nb // warp)} blocks of {32 * warp} threads)")
    return f"one block of {threads} threads per member ({nb} blocks)"


def grid_launch(kind, rhs, span, y0, kw, shape):
    """B7, B6, B4 or B12 forced to ``shape`` (a comparison launch, not
    counted): (y, status, nsteps, nfev)."""
    from extensisq_tpu_torch.ops import fused_ckdisc_grid as FCG
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    kw = dict(kw)
    method = kw.pop("method", None)
    if kind == "fused_esdirk_grid":
        nb = kw.pop("block_base", None)
        return FEG._launch(FEG._kernel(method, rhs, nb), span, y0,
                           method=method, shape=shape, **kw)[0]
    if kind == "fused_erk_grid":
        return FKG._launch(FKG._kernel(method, rhs), span, y0, y0.shape[1],
                           shape=shape, **kw)[0]
    if kind == "fused_ckdisc_grid":
        return FCG._launch(FCG._kernel(rhs), span, y0, y0.shape[1],
                           shape=shape, **kw)[0]
    return FNG._launch(FNG._kernel(method, rhs), span, y0, rhs.n,
                       shape=shape, **kw)[0]


def hold_grid_shapes(kind, label, rhs, span, y0, kw, k, shape, r, gates):
    """B7, B6, B4 or B12 on a check whose wrapper run ``k`` took the
    rule's ``shape`` and was held against the plain version's run ``r``:
    the warp body (one warp per member, the rule's members a block) and
    the block of ``grid_threads(n)`` threads per member (B12, which has no
    warp body: that block and the rule's block for large ensembles), each
    where the rule took another shape, held against ``r`` at the check's
    ``gates`` (or the shape's own, ``GRID_SHAPE_GATES``); the warp body bit
    for bit against the kernel forced to one block of 32 threads per
    member."""
    from extensisq_tpu_torch import ops
    mod = getattr(ops, kind)
    nb = y0.shape[0]
    n = rhs.n if kind == "fused_rkn_grid" else y0.shape[1]
    threads = ops.fused_erk_grid.grid_threads
    runs = {tuple(shape): k}
    print(f"{kind} [{label}, {nb}]: the rule takes "
          f"{grid_shape_text(shape, nb)}")
    if kind == "fused_ckdisc_grid":
        others = [(threads(n), 0), (min(mod.SMALL_THREADS, threads(n)), 0)]
    else:
        warp = (32, mod.WARP_MEMBERS)
        others = [warp, (threads(n), 0)]
    for s in others:
        if s not in runs:
            runs[s] = hold_against_plain(
                kind, f"{label}, {grid_shape_text(s, nb)}",
                lambda s=s: grid_launch(kind, rhs, span, y0, kw, s),
                lambda: r, *GRID_SHAPE_GATES.get((kind, label, s), gates))[0]
    if kind == "fused_ckdisc_grid":
        return
    b32 = runs.get((32, 0))
    if b32 is None:
        b32 = grid_launch(kind, rhs, span, y0, kw, (32, 0))
    same = all(torch.equal(a, b) for a, b in zip(runs[warp], b32))
    print(f"{kind} [{label}, {nb}]: {grid_shape_text(warp, nb)} "
          f"bit-identical to one block of 32 threads per member: {same}")
    check(same, f"{label}: the warp body and the block of 32 threads "
          "differ")


# -- the RKC path --------------------------------------------------------------
# validation/benchmarks.py:511-668 (config 5): 5a/5c on one 2x256x256
# Brusselator grid, 5d/5e on 64 members of 2x64x128 with B per member
RKC_TOL = dict(rtol=1e-4, atol=1e-7)
BRUS_N = 256
BRUS_RHO = 8.0 * 0.02 * BRUS_N**2 + 5.0
ENS_NY, ENS_NX, ENS_M, ENS_TF = 64, 128, 64, 4.0
ENS_RHO = 8.0 * 0.02 * ENS_NX**2 + 5.5
# the JAX benchmark's gates (validation/benchmarks.py:636-637, :657-659,
# tests/test_fused_pallas.py:215), set on a TPU; re-measured here, section 6
# of PERF.md
RKC_F64_GATE = 1e-3
ENS_STEP_GATE, ENS_Y_GATE = 6, 2e-3
POWER_STEP_GATE = 8
# kernel against its plain version on the card, on the small checks (B9 on
# 2x128x128, B10 on 8 members of 2x32x128, one of which overflows) and at
# the path's shapes: max |dy| over finished members and max |dnsteps|;
# PERF.md section 6 holds the measured values.  On the path's 5e line (4
# time units of the limit cycle, the power iteration re-run every 25 steps
# and after rejections) the card's FMA contraction parts the f32 step
# sequences of kernel and plain version further: one member took 45 steps
# against 51, |dy| 4.5e-4; that line keeps the JAX 5e step gate, 8
RKC_KERNEL_GATES = {"b9": (5e-4, 3), "b10": (5e-4, 3),
                    "b10_power_path": (1e-3, 8)}
# the f64 driver on the card against the CPU on a 2x16x16 grid
RKC_CPU_GATE = 1e-10


def rkc_rhs():
    """The FusedGridRHS and FusedRho of every RKC variant, by label."""
    from extensisq_tpu_torch import parallel
    from extensisq_tpu_torch.ops import FusedRho
    # a bound of the small grids' spectral radius (8 alpha / dx^2 + 5.5
    # at nx = 128), growing with t
    rho_fn = FusedRho(
        lambda t, y, p=None: 2627.0 * (1.0 + 0.1 * t),
        "__device__ float rho(float t, const float* y, const float* p) {\n"
        "  return 2627.0f * (1.0f + 0.1f * t);\n}")
    return {"b9": parallel.brusselator_2d_grid((BRUS_N, BRUS_N)),
            "b10": parallel.brusselator_2d_grid((ENS_NY, ENS_NX), B=None),
            "b9_small": parallel.brusselator_2d_grid((128, 128)),
            "b10_small": parallel.brusselator_2d_grid((32, 128), B=None),
            "rho_fn": rho_fn}


def rkc_builds(rhs):
    """(kernel, label, FusedGridRHS, (n_par, rho)) of every RKC variant."""
    return [("fused_rkc", "brusselator 2x256x256", rhs["b9"], (0, None)),
            ("fused_rkc", "brusselator 2x64x128, B per member", rhs["b10"],
             (1, None)),
            ("fused_rkc", "brusselator 2x128x128", rhs["b9_small"],
             (0, None)),
            ("fused_rkc", "brusselator 2x128x128, rho callback",
             rhs["b9_small"], (0, rhs["rho_fn"])),
            ("fused_rkc", "brusselator 2x32x128, B per member",
             rhs["b10_small"], (1, None)),
            ("fused_rkc", "brusselator 2x32x128, rho callback",
             rhs["b10_small"], (1, rhs["rho_fn"]))]


def brus131k_y0():
    """The 5a/5c initial grid (validation/benchmarks.py:518-522)."""
    n = BRUS_N
    xg, yg = np.meshgrid(np.linspace(0, 1, n, endpoint=False),
                         np.linspace(0, 1, n, endpoint=False))
    return np.stack([1.0 + 0.5 * np.sin(2 * np.pi * xg)
                     * np.sin(2 * np.pi * yg),
                     3.0 + 0.1 * np.cos(2 * np.pi * xg)])


def ens_y0(members, ny, nx):
    """The 5d/5e members: u0 = 1 + 0.3 sin(2 pi x), v0 = 3."""
    x = np.linspace(0, 1, nx, endpoint=False)
    y0 = np.zeros((members, 2, ny, nx), np.float32)
    y0[:, 0] = 1.0 + 0.3 * np.sin(2 * np.pi * x)[None, :]
    y0[:, 1] = 3.0
    return y0


def hold_rkc(label, what, k, r, gate_key, extra=""):
    """Hold an RKC kernel's result ``k`` against its plain version's ``r``
    (member axis first): identical status, and max |dy| over the finished
    members and max |dnsteps| within ``RKC_KERNEL_GATES[gate_key]``.
    Returns max |dy|."""
    ok = (r[1] == 1).reshape(-1)
    dy = (k[0] - r[0]).reshape(ok.shape[0], -1)[ok].abs().max().item()
    dn = (k[2] - r[2]).abs().max().item()
    y_gate, n_gate = RKC_KERNEL_GATES[gate_key]
    print(f"rkc kernel vs plain [{label}, {what}]: status "
          f"{k[1].reshape(-1).tolist()} vs {r[1].reshape(-1).tolist()}, "
          f"nsteps {k[2].reshape(-1).tolist()} vs {r[2].reshape(-1).tolist()}"
          + (f", nfesig {k[4].reshape(-1).tolist()} vs "
             f"{r[4].reshape(-1).tolist()}" if len(k) == 5 else "")
          + f", max |dy| {dy:.3e} (gate {y_gate:.0e}), max |dnsteps| {dn} "
          f"(gate {n_gate}){extra}")
    check(torch.equal(k[1], r[1]), f"rkc {label} {what}: status")
    check(dy <= y_gate and dn <= n_gate,
          f"rkc {label} {what}: kernel and plain version disagree")
    return dy


def rkc_kernel_checks(R):
    """Each RKC kernel against its plain version on the card, in the three
    rho modes: B9 in its shared placement (the wrapper's here) and in its
    global one, which must agree bit for bit; B10 with a member that
    overflows, both at the wrapper's cluster size and in its
    one-block-per-member body (C = 1), and at C = 1 where the wrapper
    takes it, on members whose arrays fit no CTA's shared memory.  Returns
    the largest |dy| of B9 and of B10."""
    from extensisq_tpu_torch.ops import (fused_rkc, fused_rkc_reference,
                                         solve_fused_rkc,
                                         solve_fused_rkc_ensemble)
    rhos = {"float": 8.0 * 0.02 * 128**2 + 5.5, "callback": R["rho_fn"],
            "power": None}
    worst = {"b9": 0.0, "b10": 0.0}
    y9 = torch.tensor(ens_y0(1, 128, 128)[0], device="cuda")
    y10 = torch.tensor(ens_y0(8, 32, 128), device="cuda")
    y10[:, 0] += torch.linspace(0.0, 0.2, 8, device="cuda")[:, None, None]
    y10[5] *= 1e30                      # this member overflows
    p10 = torch.linspace(2.8, 3.5, 8, device="cuda")[:, None]
    for mode, rho in rhos.items():
        plain10 = {}

        def block(rho=rho):
            out, c = fused_rkc._launch_ensemble(
                R["b10_small"], (0.0, 1.0), y10, rho, p10, 1, **RKC_TOL)
            check(c == 1, "rkc b10 block: not one block per member")
            return out if rho is None else out[:4]
        plain9 = {}

        def grid_global(rho=rho):
            out, shape = fused_rkc._launch_grid(
                R["b9_small"], (0.0, 1.0), y9, rho, fused_rkc.GLOBAL,
                **RKC_TOL)
            check(shape[1] == fused_rkc.GLOBAL, "rkc b9 global: placement")
            return out if rho is None else out[:4]
        for label, run, plain in (
                ("b9", lambda: solve_fused_rkc(
                    R["b9_small"], (0.0, 1.0), y9, rho, **RKC_TOL),
                 lambda: plain9.setdefault("r", tuple(
                     x[0] for x in fused_rkc_reference(
                         R["b9_small"], (0.0, 1.0), y9[None], rho,
                         **RKC_TOL)))),
                ("b9 global", grid_global, lambda: plain9["r"]),
                ("b10", lambda: solve_fused_rkc_ensemble(
                    R["b10_small"], (0.0, 1.0), y10, rho, params=p10,
                    **RKC_TOL),
                 lambda: plain10.setdefault("r", fused_rkc_reference(
                     R["b10_small"], (0.0, 1.0), y10, rho, params=p10,
                     **RKC_TOL))),
                ("b10 C=1", block, lambda: plain10["r"])):
            t0 = time.perf_counter()
            k = run()
            torch.cuda.synchronize()
            k_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = plain()
            torch.cuda.synchronize()
            r_s = time.perf_counter() - t0
            key = label.split()[0]
            dy = hold_rkc(label, f"rho {mode}", k, r, key,
                          f"; {k_s:.3f} s vs {r_s:.3f} s")
            worst[key] = max(worst[key], dy)
            if key == "b10":
                bad = 6 if rho is None else 3
                check(int(k[1][5]) == bad and int((k[1] == 1).sum()) == 7,
                      f"rkc overflow isolation ({label}): member 5 must "
                      "fail alone")
            if label == "b9":
                shape9 = solve_fused_rkc.last_shape
                check(shape9[1] == fused_rkc.SHARED,
                      "rkc b9: the small grid took the global placement")
                first9 = k
            if label == "b9 global":
                same = all(torch.equal(a, b) for a, b in zip(k, first9))
                print(f"rkc b9 rho {mode}: {shape9[0]} blocks, shared "
                      f"placement ({shape9[2]} B a block) and global "
                      f"placement bit-identical {same}")
                check(same, f"rkc b9 rho {mode}: the placements differ")
            if label == "b10":
                c = solve_fused_rkc_ensemble.cluster
                same = repeats_bit_for_bit(k, run)
                print(f"rkc b10 rho {mode}: clusters of {c} CTAs per member;"
                      f" {REPEATS_B10} launches bit-identical {same}")
                check(c > 1, "rkc b10: the 8-member check took no cluster")
                check(same, f"rkc b10 rho {mode}: launches differ")

    # two members of the 2x256x256 grid: no C holds a chunk of their six
    # arrays in shared memory, so the wrapper runs one block per member
    yb = torch.tensor(np.stack([brus131k_y0()] * 2), dtype=torch.float32,
                      device="cuda")
    yb[1, 0] += 0.1
    t0 = time.perf_counter()
    k = solve_fused_rkc_ensemble(R["b9"], (0.0, 1.0), yb, BRUS_RHO,
                                 **RKC_TOL)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    c = solve_fused_rkc_ensemble.cluster
    t0 = time.perf_counter()
    r = fused_rkc_reference(R["b9"], (0.0, 1.0), yb, BRUS_RHO, **RKC_TOL)
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t0
    dy = hold_rkc("b10", f"2 x 2x{BRUS_N}x{BRUS_N}, rho float", k, r, "b10",
                  f"; {k_s:.3f} s vs {r_s:.3f} s; clusters of {c}")
    check(c == 1, f"rkc b10 2x{BRUS_N}x{BRUS_N}: took clusters of {c}, "
          "not one block per member")
    check(bool((k[1] == 1).all()), f"rkc b10 2x{BRUS_N}x{BRUS_N}: status")
    worst["b10"] = max(worst["b10"], dy)
    return worst


# B10's cluster launch: a stale L1 line of a peer's stage argument would
# show as outputs that differ from launch to launch
REPEATS_B10 = 3


def repeats_bit_for_bit(first, run):
    """Whether ``REPEATS_B10 - 1`` more runs give ``first`` bit for bit."""
    outs = [run() for _ in range(REPEATS_B10 - 1)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for o in outs for a, b in zip(o, first))


def rkc_path():
    """The SSV2stab path at BASELINE config 5's sizes: the f64 driver on
    one 131,072-state grid (5a), B9 on the same grid (5c), B10 on the
    64-member ensemble with a rho bound (5d) and with the power iteration
    (5e), the f64 ensemble; returns the ``kernels`` entries of B9 and
    B10."""
    from extensisq_tpu_torch import (SSV2stab, parallel, solve,
                                     solve_ensemble)
    from extensisq_tpu_torch.ops import (fused_rkc, fused_rkc_reference,
                                         solve_fused_adams, solve_fused_erk,
                                         solve_fused_esdirk, solve_fused_rkc,
                                         solve_fused_rkc_ensemble)
    R = rkc_rhs()

    # (a) the kernels against their plain versions, three rho modes
    worst = rkc_kernel_checks(R)

    # (b) the path: every count set to 0 just before, read just after
    y131 = brus131k_y0()
    Y9 = torch.tensor(y131, dtype=torch.float32, device="cuda")
    Y10 = torch.tensor(ens_y0(ENS_M, ENS_NY, ENS_NX), device="cuda")
    P10 = torch.tensor(np.linspace(2.8, 3.5, ENS_M), dtype=torch.float32,
                       device="cuda")[:, None]
    flat = parallel.brusselator_2d_rhs((BRUS_N, BRUS_N), alpha=0.02)
    rho_bound = parallel.brusselator_rho_bound((BRUS_N, BRUS_N), alpha=0.02)

    def flat_ens(t, y, b):
        return R["b10"].torch_fn(t, y.reshape(2, ENS_NY, ENS_NX, -1),
                                 b[None]).reshape(2 * ENS_NY * ENS_NX, -1)

    for fn in (solve_fused_erk, solve_fused_esdirk, solve_fused_adams,
               solve_fused_rkc, solve_fused_rkc_ensemble):
        fn.launches = 0
    t0 = time.perf_counter()
    f64 = solve(flat, (0.0, 1.0), torch.tensor(y131.reshape(-1),
                                               device="cuda"),
                method=SSV2stab, rho_jac=rho_bound, **RKC_TOL)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    b9 = solve_fused_rkc(R["b9"], (0.0, 1.0), Y9, BRUS_RHO, **RKC_TOL)
    b10 = solve_fused_rkc_ensemble(R["b10"], (0.0, ENS_TF), Y10, ENS_RHO,
                                   params=P10, **RKC_TOL)
    b10p = solve_fused_rkc_ensemble(R["b10"], (0.0, ENS_TF), Y10, None,
                                    params=P10, **RKC_TOL)
    torch.cuda.synchronize()
    shape9 = solve_fused_rkc.last_shape
    cluster10 = solve_fused_rkc_ensemble.cluster
    t0 = time.perf_counter()
    ens = solve_ensemble(flat_ens, (0.0, ENS_TF),
                         Y10.reshape(ENS_M, -1).double(),
                         params_batch=P10[:, 0].double(), method=SSV2stab,
                         rho_jac=lambda t, y: ENS_RHO, **RKC_TOL)
    torch.cuda.synchronize()
    ens_s = time.perf_counter() - t0
    launches = (solve_fused_rkc.launches, solve_fused_rkc_ensemble.launches)
    others = (solve_fused_erk.launches, solve_fused_esdirk.launches,
              solve_fused_adams.launches)
    print(f"rkc path: fused_rkc launches {launches[0]}, "
          f"fused_rkc_ensemble launches {launches[1]}, others {others}")
    check(launches == (1, 2) and others == (0, 0, 0),
          f"rkc path launched {launches}, {others}; expected (1, 2)")

    # (c) the gates of config 5
    print(f"brus131k-f64: status {int(f64.status)}, nsteps "
          f"{int(f64.nsteps)}, nfev {int(f64.nfev)}, maxm {int(f64.maxm)}, "
          f"{f64_s * 1e3:.1f} ms wall (one run)")
    check(int(f64.status) == 1, "brus131k-f64: not finished")
    d9 = (b9[0].double().reshape(-1) - f64.y).abs().max().item()
    print(f"brus131k-fused (B9): status {int(b9[1])}, nsteps {int(b9[2])}, "
          f"nfev {int(b9[3])}, {shape9[0]} blocks of "
          f"{fused_rkc.GRID_THREADS}; "
          f"vs f64 max |dy| {d9:.3e} (gate {RKC_F64_GATE:.0e})")
    check(int(b9[1]) == 1 and b9[0].shape == Y9.shape
          and bool(torch.isfinite(b9[0]).all()), "brus131k-fused: bad run")
    check(d9 < RKC_F64_GATE, "brus131k-fused: fused and f64 disagree")
    check(bool((ens.status == 1).all()), "f64 ensemble: not all finished")
    for label, out, step_gate in (("5d, rho bound", b10, ENS_STEP_GATE),
                                  ("5e, power iteration", b10p,
                                   POWER_STEP_GATE)):
        dstep = (out[2] - ens.nsteps).abs().max().item()
        dy = (out[0].reshape(ENS_M, -1).double() - ens.y).abs().max().item()
        print(f"brus64x2x64x128-ens (B10, {label}): status "
              f"{torch.unique(out[1]).tolist()}, nsteps {int(out[2].min())}-"
              f"{int(out[2].max())} (f64 {int(ens.nsteps.min())}-"
              f"{int(ens.nsteps.max())}), step max |d| {dstep} (gate "
              f"{step_gate}), endpoint max |d| {dy:.3e} (gate "
              f"{ENS_Y_GATE:.0e})"
              + (f", max nfesig {int(out[4].max())}" if len(out) == 5
                 else ""))
        check(bool((out[1] == 1).all()) and bool(torch.isfinite(out[0]).all()),
              f"B10 {label}: not all finished")
        check(dstep <= step_gate and dy < ENS_Y_GATE,
              f"B10 {label}: fused and f64 ensemble disagree")

    # (d) the f64 driver on the card against the CPU, 4 members of 2x16x16
    small = parallel.brusselator_2d_rhs((16, 16), alpha=0.02)
    ys = torch.tensor(ens_y0(4, 16, 16).reshape(4, -1), dtype=torch.float64)
    ys[:, :256] *= torch.linspace(0.9, 1.1, 4, dtype=torch.float64)[:, None]
    card = solve_ensemble(small, (0.0, 1.0), ys.cuda(), method=SSV2stab,
                          **RKC_TOL)
    cpu = solve_ensemble(small, (0.0, 1.0), ys, method=SSV2stab, **RKC_TOL)
    same = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
               for f in ("status", "nsteps", "nfev", "nfailed", "nfesig",
                         "maxm"))
    dcpu = (card.y.cpu() - cpu.y).abs().max().item()
    print(f"f64 SSV2stab, card vs CPU (4 members of 2x16x16, power "
          f"iteration): counts equal {same}, max |dy| {dcpu:.3e} (gate "
          f"{RKC_CPU_GATE:.0e})")
    check(torch.equal(card.status.cpu(), cpu.status),
          "f64 SSV2stab: status differs between the card and the CPU")
    check(dcpu <= RKC_CPU_GATE, "f64 SSV2stab: card and CPU disagree")

    # (e) times: warm medians; the plain versions and the f64 ensemble once
    def run9():
        return solve_fused_rkc(R["b9"], (0.0, 1.0), Y9, BRUS_RHO, **RKC_TOL)

    def run10(rho=ENS_RHO):
        return solve_fused_rkc_ensemble(R["b10"], (0.0, ENS_TF), Y10, rho,
                                        params=P10, **RKC_TOL)

    b9_ms, b9_dev = wall_ms(run9), event_ms(run9)
    same9 = repeats_bit_for_bit(b9, run9)
    print(f"B9 on the path: {shape9[0]} blocks of "
          f"{fused_rkc.GRID_THREADS}, "
          f"{'shared' if shape9[1] == fused_rkc.SHARED else 'global'} "
          f"placement ({shape9[2]} B a block); {REPEATS_B10} launches "
          f"bit-identical {same9}")
    check(same9, "B9 on the path: launches differ")
    b9g, _ = fused_rkc._launch_grid(R["b9"], (0.0, 1.0), Y9, BRUS_RHO,
                                    fused_rkc.GLOBAL, **RKC_TOL)
    b10_ms, b10_dev = wall_ms(run10), event_ms(run10)
    b10p_dev = event_ms(lambda: run10(None))
    same = (repeats_bit_for_bit(b10, run10)
            and repeats_bit_for_bit(b10p, lambda: run10(None)))
    print(f"B10 on the path (5d, 5e): clusters of {cluster10} CTAs per "
          f"member; {REPEATS_B10} launches of each bit-identical {same}")
    check(same, "B10 on the path: launches differ")

    # (f) the path's kernel runs against their plain versions, same inputs
    t0 = time.perf_counter()
    r9 = fused_rkc_reference(R["b9"], (0.0, 1.0), Y9[None], BRUS_RHO,
                             **RKC_TOL)
    torch.cuda.synchronize()
    plain9_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r10 = fused_rkc_reference(R["b10"], (0.0, ENS_TF), Y10, ENS_RHO,
                              params=P10, **RKC_TOL)
    torch.cuda.synchronize()
    plain10_ms = (time.perf_counter() - t0) * 1e3
    r10p = fused_rkc_reference(R["b10"], (0.0, ENS_TF), Y10, None,
                               params=P10, **RKC_TOL)
    err9 = max(hold_rkc("b9", "the path, 2x256x256",
                        tuple(x[None] for x in b9), r9, "b9"),
               hold_rkc("b9", "the path, 2x256x256, global placement",
                        tuple(x[None] for x in b9g[:4]), r9, "b9"))
    check(all(torch.equal(a, b) for a, b in zip(b9, b9g)),
          "B9 on the path: the placements differ")
    err10 = max(hold_rkc("b10", "the path, 5d bound", b10, r10, "b10"),
                hold_rkc("b10", "the path, 5e power", b10p, r10p,
                         "b10_power_path"))
    stages9 = int(b9[3]) - 1
    stages10 = int(b10[3].max()) - 1
    evals10p = int((b10p[3] + b10p[4]).max()) - 1
    print(f"time [fused_rkc B9] 2x{BRUS_N}x{BRUS_N}: {b9_ms:.3f} ms wall, "
          f"{b9_dev:.3f} ms device (CUDA events), "
          f"{b9_dev / stages9 * 1e3:.2f} us per RHS evaluation "
          f"({stages9} after the first)")
    print(f"time [fused_rkc_ensemble B10] {ENS_M} x 2x{ENS_NY}x{ENS_NX}: "
          f"{b10_ms:.3f} ms wall, {b10_dev:.3f} ms device, "
          f"{b10_dev / stages10 * 1e3:.2f} us per RHS evaluation of the "
          f"slowest member; power iteration {b10p_dev:.3f} ms device "
          f"({b10p_dev / evals10p * 1e3:.2f} us per evaluation, the power "
          f"iteration's included); clusters of {cluster10}")
    print(f"time [plain versions] B9 {plain9_ms:.1f} ms, B10 "
          f"{plain10_ms:.1f} ms (one run each); [f64 solve] 5a "
          f"{f64_s * 1e3:.1f} ms, [f64 solve_ensemble] 5d {ens_s * 1e3:.1f}"
          f" ms (one run each)")

    ntot9 = 2 * BRUS_N * BRUS_N
    ntot10 = 2 * ENS_NY * ENS_NX
    per_eval = OPS_PER_ELEMENT_EVAL["fused_rkc"]
    source = "extensisq_tpu_torch/csrc/fused_rkc.cu"
    return [dict(name="fused_rkc", route="cuda", source=source,
                 replaces="extensisq_tpu/ops/fused_rkc.py:804",
                 launches=launches[0], max_abs_err=max(worst["b9"], err9),
                 ms=b9_ms, plain_ms=plain9_ms, device_ms=b9_dev,
                 f64_ms=f64_s * 1e3, blocks=shape9[0],
                 placement="shared" if shape9[1] == fused_rkc.SHARED
                 else "global",
                 **bound_entry(2 * 4 * ntot9,
                               per_eval * ntot9 * int(b9[3]))),
            dict(name="fused_rkc_ensemble", route="cuda", source=source,
                 replaces="extensisq_tpu/ops/fused_rkc.py:1036",
                 launches=launches[1], max_abs_err=max(worst["b10"], err10),
                 ms=b10_ms, plain_ms=plain10_ms, device_ms=b10_dev,
                 device_ms_power=b10p_dev, f64_ms=ens_s * 1e3,
                 cluster=cluster10,
                 **bound_entry(2 * 4 * ntot10 * ENS_M + 4 * 4 * ENS_M,
                               per_eval * ntot10 * int(b10[3].sum())))]


# -- the second-order and mid-size explicit paths -----------------------------
# validation/benchmarks.py:273-343 (config 3: 3 Kepler f64, 3b Pleiades,
# 3c fused RKN) and :69-103 (config 1b, the fisher MoL through the grid
# ERK kernel); the wave of tests/test_fused_pallas.py:1367-1414 at config
# 1b's widths (256 positions, 64 members)
KEP_N = 2048
KEP_SPAN = (0.0, 2 * np.pi)
KEP_F64_TOL = dict(rtol=1e-9, atol=1e-12)
KEP_PLAIN_TOL = dict(rtol=1e-5, atol=1e-7)
KEP_COMP_TOL = dict(rtol=1e-7, atol=1e-9, compensated=True)
PL_N = 512
PL_SPAN = (0.0, 3.0)
FISHER_N, FISHER_M, FISHER_M_LARGE, FISHER_SPAN = 256, 64, 1024, (0.0, 2.0)
FISHER_TOL = dict(rtol=1e-5, atol=1e-7)
WAVE_N, WAVE_M, WAVE_M_LARGE, WAVE_SPAN = 256, 64, 1024, (0.0, 4.0)
WAVE_C2 = 400.0
WAVE_TOL = dict(rtol=1e-5, atol=1e-7, first_step=0.05)
WAVE_COMP_TOL = dict(rtol=1e-6, atol=1e-9, first_step=0.05,
                     compensated=True)
# kernel against its plain version on the card: (max |dy| over finished
# members, relative difference of mean nsteps, max |dnsteps|).  Measured on
# an H100 (the small checks; the paths' shapes where larger): kepler
# 3.4e-4 / 1.4e-3 / 1 (B5 plain, half the members one step or a rejection
# apart: the f32 error estimate of the near-circular orbits is round-off,
# so FMA parts h), kepler_comp 5.3e-5 / 2.1e-3 / 3, cubic 0 / 0 / 0;
# fisher 2.4e-4 / 6e-5 / 2, fisher_comp 1.8e-5 / 2.0e-3 / 1,
# fisher_overflow 5.8e-4 / 0 / 0 (B4); wave 1.9e-3 / 2.6e-3 / 3, wave_comp
# 5.9e-5 / 5.6e-3 / 4, wave_overflow 2.3e-5 / 0 / 0 (B6); wave1024 (the
# warp body, 1,024 members: the max over members grows with their number)
# 2.6e-3 / 1.1e-3 / 7; fisher1024 (B4's warp, 1,024 members) 3.7e-4 /
# 1.4e-4 / 15 (154 members with other counts).  The gates keep a margin of
# 2-4x, at least 1e-3 on mean steps and 1 on max steps
RKN_KERNEL_GATES = {"kepler": (1e-3, 5e-3, 3),
                    "kepler_comp": (2e-4, 6e-3, 6),
                    "cubic": (1e-6, 1e-3, 1), "fisher": (1e-3, 1e-3, 4),
                    "fisher_comp": (6e-5, 6e-3, 3),
                    "fisher_overflow": (2e-3, 1e-3, 1),
                    "wave": (5e-3, 8e-3, 6), "wave_comp": (2e-4, 1.5e-2, 8),
                    "wave_overflow": (1e-4, 1e-3, 1),
                    "wave1024": (5e-3, 8e-3, 14),
                    "fisher1024": (1e-3, 1e-3, 30)}
# the lines against the f64 driver: config 1b's endpoint gate 1e-3
# (validation/benchmarks.py:100); the wave's 5e-3 and mean nsteps within
# 10% + 2 (tests/test_fused_pallas.py:1407-1414), which that test sets at
# 128 positions and 16 members, where it holds (checked here on that
# replica).  At 256 positions the float32 stencil's cancellation makes the
# error estimate noisy, and the JAX kernel itself (interpret mode on the
# CPU, tests/jax_wave256_steps.py, 8 members) takes 54.62 steps against
# the f64 driver's 46.25 (plain, 18%) and 301.5 against 48.25
# (compensated at atol 1e-9, 6x): the plain line is held to 25% + 2, the
# compensated line to the endpoint gate only.
# Kepler: the f32 lines within the global error of their tolerances of the
# rtol-1e-9 line, measured on an H100 at 4.0e-4 (plain) and 9.7e-5
# (compensated), kept at 1e-3 and 3e-4
FISHER_F64_GATE = 1e-3
WAVE_F64_GATE = 5e-3
WAVE_STEP_GATES = {"replica": 0.1, "plain": 0.25}
KEP_F64_GATES = {"plain": 1e-3, "compensated": 3e-4}
# the f64 lines rerun on the CPU: counters identical, |dy| relative to
# max(1, |y|) 1e-12, except where the problem amplifies last bits.  There
# the sampled members also run inside the whole batch on the CPU, which
# shows how far the batch's shape alone moves them (PyTorch's batched sums
# and pow round by it), and the gate sits just above the larger of that
# and the card's reading (H100): the Pleiades members' close encounters,
# card vs CPU 2.742e-12; the wave's 512-state norms over 50 steps of a
# stencil that cancels, card vs CPU 1.940e-11 (its GPU sums add in
# another order than the CPU's)
PLEIADES_CPU_GATE = 5e-12
WAVE_CPU_GATE = 3e-11

KEPLER_CUDA = """
template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  const T r2 = u[0] * u[0] + u[1] * u[1];
  const T s = -powf(r2, -1.5f);
  a[0] = s * u[0];
  a[1] = s * u[1];
}
"""
CUBIC_ACC_CUDA = """
__device__ void acc(float t, const float* u, const float* v, float* a) {
  a[0] = u[0] * u[0] * u[0];
}
"""
# the Pleiades acceleration as a 14-position B5 acc, built for its register
# report only (config 3b runs on the f64 driver)
PLEIADES_ACC_CUDA = """
template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  for (int i = 0; i < 7; ++i) {
    T ax = 0.0f, ay = 0.0f;
    for (int j = 0; j < 7; ++j) {
      if (j == i) continue;
      const T dx = u[j] - u[i];
      const T dy = u[7 + j] - u[7 + i];
      const T r2 = dx * dx + dy * dy;
      const T w = static_cast<T>(j + 1) * powf(r2, -1.5f);
      ax += w * dx;
      ay += w * dy;
    }
    a[i] = ax;
    a[7 + i] = ay;
  }
}
"""


def _fisher_cuda(n):
    return ("__device__ float rhs(float t, const float* y, int i, "
            "const float* p) {\n"
            f"  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {_lit(n)}\n"
            "         + y[i] * (1.0f - y[i]);\n}")


def _wave_cuda(cubic=False):
    return ("__device__ float acc(float t, const float* u, const float* v, "
            "int i, const float* p) {\n  using G = tab::G;\n"
            f"  return {_lit(WAVE_C2)} * (G::rolled<0>(u, i, 1) + "
            "G::rolled<0>(u, i, -1) - 2.0f * u[i])"
            + (" + u[i] * u[i] * u[i]" if cubic else "") + ";\n}")


def kepler_acc(t, u, v):
    r2 = u[0] ** 2 + u[1] ** 2
    a = -r2 ** -1.5
    return torch.stack([a * u[0], a * u[1]])


def kepler(t, y):
    return torch.cat([y[2:], kepler_acc(t, y[:2], y[2:])])


def fisher_mol(n):
    return lambda t, y: -(y - torch.roll(y, 1, 0)) * float(n) + y * (1 - y)


def wave_acc(t, u, v):
    return WAVE_C2 * (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) - 2.0 * u)


def wave_first_order(n):
    return lambda t, y: torch.cat([y[n:], wave_acc(t, y[:n], y[n:])])


PL_MASSES = np.arange(1.0, 8.0)
PL_Q0 = np.array([3, 3, -1, -3, 2, -2, 2, 3, -3, 2, 0, 0, -4, 4], float)
PL_V0 = np.array([0, 0, 0, 0, 0, 1.75, -1.5, 0, 0, 0, -1.25, 1, 0, 0],
                 float)


def pleiades(t, y):
    """The 7-body Pleiades problem, rows-first (28, B), as the benchmark's
    ``fpl`` (validation/benchmarks.py:309-317)."""
    x, yy = y[:7], y[7:14]
    eye = torch.eye(7, dtype=y.dtype, device=y.device)[:, :, None]
    dx = x[None, :] - x[:, None]
    dy = yy[None, :] - yy[:, None]
    r2 = dx * dx + dy * dy + eye
    m = torch.tensor(PL_MASSES, dtype=y.dtype, device=y.device)
    w = m[None, :, None] * r2 ** -1.5 * (1.0 - eye)
    return torch.cat([y[14:], (w * dx).sum(1), (w * dy).sum(1)])


def rkn_grid_rhs():
    """The FusedAcc/FusedGridRHS/FusedGridAcc of every variant, by label."""
    from extensisq_tpu_torch.ops import FusedAcc, FusedGridAcc, FusedGridRHS
    return {"kepler": FusedAcc(kepler_acc, KEPLER_CUDA, 2),
            "cubic": FusedAcc(lambda t, u, v: u ** 3, CUBIC_ACC_CUDA, 1),
            "pleiades": FusedAcc(None, PLEIADES_ACC_CUDA, 14),
            "fisher": FusedGridRHS(fisher_mol(FISHER_N),
                                   _fisher_cuda(FISHER_N), (FISHER_N,)),
            "fisher128": FusedGridRHS(fisher_mol(128), _fisher_cuda(128),
                                      (128,)),
            "fisher100": FusedGridRHS(fisher_mol(100), _fisher_cuda(100),
                                      (100,)),
            "wave": FusedGridAcc(wave_acc, _wave_cuda(), WAVE_N),
            "wave128": FusedGridAcc(wave_acc, _wave_cuda(), 128),
            "wave100_cubic": FusedGridAcc(
                lambda t, u, v: wave_acc(t, u, v) + u ** 3,
                _wave_cuda(cubic=True), 100)}


def rkn_grid_builds(rhs):
    """(kernel, label, rhs, method) of every B4/B5/B6 variant."""
    from extensisq_tpu_torch import BS5, Fi5N
    return ([("fused_rkn", f"{k} Fi5N", rhs[k], Fi5N)
             for k in ("kepler", "cubic", "pleiades")]
            + [("fused_erk_grid", f"{k} BS5", rhs[k], BS5)
               for k in ("fisher", "fisher128", "fisher100")]
            + [("fused_rkn_grid", f"{k} Fi5N", rhs[k], Fi5N)
               for k in ("wave", "wave128", "wave100_cubic")])


def kepler_y0(n, dtype=torch.float32):
    ecc = np.linspace(0.1, 0.7, n)
    return torch.tensor(np.stack([1 - ecc, np.zeros(n), np.zeros(n),
                                  np.sqrt((1 + ecc) / (1 - ecc))], 1),
                        dtype=dtype, device="cuda")


def fisher_y0(members, n):
    x = np.linspace(0, 1, n, endpoint=False)
    amps = np.linspace(0.2, 0.8, members)
    return torch.tensor(0.5 + 0.4 * amps[:, None]
                        * np.sin(2 * np.pi * x)[None, :],
                        dtype=torch.float32, device="cuda")


def wave_y0(members, n):
    x = np.linspace(0, 1, n, endpoint=False)
    u0 = (np.linspace(0.5, 1.5, members)[:, None]
          * np.sin(2 * np.pi * x)[None, :])
    return torch.tensor(np.concatenate([u0, np.zeros_like(u0)], 1),
                        dtype=torch.float32, device="cuda")


def f64_against_cpu(label, fun, span, y64, method, idx, tol, gate=1e-12,
                    batch_witness=False):
    """Rerun the members ``idx`` of an f64 card run on the CPU: counters
    identical, |dy| relative to max(1, |y|) within ``gate``.  With
    ``batch_witness`` also print how far the same members move on the CPU
    inside the whole batch.  Returns the card run."""
    from extensisq_tpu_torch import solve_ensemble

    def apart(run, ref):
        same = {f: torch.equal(getattr(run, f)[idx].cpu(), getattr(ref, f))
                for f in ("status", "nsteps", "nfev", "nfailed")}
        drel = ((run.y[idx].cpu() - ref.y).abs()
                / ref.y.abs().clamp(min=1.0)).max().item()
        return same, drel

    card = solve_ensemble(fun, span, y64, method=method, **tol)
    cpu = solve_ensemble(fun, span, y64[idx].cpu(), method=method, **tol)
    same, drel = apart(card, cpu)
    print(f"{label} f64: card vs CPU on {len(idx)} members: counters equal "
          f"{same}, max |dy| relative to max(1, |y|) {drel:.3e} (gate "
          f"{gate:.0e})")
    if batch_witness:
        whole = solve_ensemble(fun, span, y64.cpu(), method=method, **tol)
        w_same, w_drel = apart(whole, cpu)
        print(f"{label} f64: the same members on the CPU alone vs inside the "
              f"batch of {y64.shape[0]}: counters equal "
              f"{all(w_same.values())}, max |dy| relative to max(1, |y|) "
              f"{w_drel:.3e}")
    check(all(same.values()), f"{label} f64: counters differ card vs CPU")
    check(drel <= gate, f"{label} f64: card and CPU disagree")
    return card


def rkn_grid_path():
    """The second-order and mid-size explicit paths: B5, B4 and B6 against
    their plain versions (small checks and the paths' shapes), config 3's
    lines (3: Kepler f64, 3b: Pleiades f64, 3c: fused RKN), config 1b (the
    fisher MoL through B4) and the wave through B6, each held against the
    f64 driver; returns the ``kernels`` entries of B5, B4 and B6."""
    from extensisq_tpu_torch import BS5, CFMR7osc, Fi5N, solve_ensemble
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts
    R = rkn_grid_rhs()
    kinds = {"fused_rkn": (ops.solve_fused_rkn, ops.fused_rkn_reference),
             "fused_erk_grid": (ops.solve_fused_erk_grid,
                                ops.fused_erk_grid_reference),
             "fused_rkn_grid": (ops.solve_fused_rkn_grid,
                                ops.fused_rkn_grid_reference)}

    def compare(kind, label, rhs, span, y0, method, **kw):
        run, plain = kinds[kind]
        res = hold_against_plain(
            kind, label, lambda: run(rhs, span, y0, method=method, **kw),
            lambda: plain(rhs, span, y0, method=method, **kw),
            *RKN_KERNEL_GATES[label])
        if kind == "fused_rkn":
            hold_small_lanes(kind, label, rhs, span, y0,
                             dict(kw, method=method), res[0], run.last_shape)
        else:
            hold_grid_shapes(kind, label, rhs, span, y0,
                             dict(kw, method=method), res[0], run.last_shape,
                             res[1], RKN_KERNEL_GATES[label])
        return res

    # (a) each kernel against its plain version: 1024 Kepler members, 8
    # members of n = 128 and n = 100, one overflowing member each
    k1024 = kepler_y0(1024)
    compare("fused_rkn", "kepler", R["kepler"], KEP_SPAN, k1024, Fi5N,
            **KEP_PLAIN_TOL)
    compare("fused_rkn", "kepler_comp", R["kepler"], KEP_SPAN, k1024, Fi5N,
            **KEP_COMP_TOL)
    u0 = torch.full((1024, 2), 0.1, device="cuda")
    u0[:, 1] = 0.0
    u0[7, 0] = 1e18                      # this member overflows in f32
    k, _, _, _ = compare("fused_rkn", "cubic", R["cubic"], (0.0, 1.0), u0,
                         Fi5N, rtol=1e-4, atol=1e-6, max_steps=2000)
    check(int(k[1][7]) == 3 and int((k[1] == 1).sum()) == 1023,
          "B5 overflow isolation: member 7 must end with status 3 alone")
    f128 = fisher_y0(8, 128)
    compare("fused_erk_grid", "fisher", R["fisher128"], FISHER_SPAN, f128,
            BS5, **FISHER_TOL)
    compare("fused_erk_grid", "fisher_comp", R["fisher128"], (0.0, 1.0),
            f128, BS5, rtol=1e-6, atol=1e-9, compensated=True)
    f100 = fisher_y0(8, 100)
    f100[3] *= 1e19                      # this member overflows in f32
    k, _, _, _ = compare("fused_erk_grid", "fisher_overflow", R["fisher100"],
                         (0.0, 1.0), f100, BS5, rtol=1e-4, atol=1e-6,
                         max_steps=2000)
    check(int(k[1][3]) == 3 and int((k[1] == 1).sum()) == 7,
          "B4 overflow isolation: member 3 must end with status 3 alone")
    w128 = wave_y0(8, 128)
    compare("fused_rkn_grid", "wave", R["wave128"], (0.0, 1.0), w128, Fi5N,
            rtol=1e-5, atol=1e-7)
    compare("fused_rkn_grid", "wave_comp", R["wave128"], (0.0, 1.0), w128,
            Fi5N, **WAVE_COMP_TOL)
    w100 = wave_y0(8, 100)
    w100[3, :100] *= 1e13                # this member overflows in f32
    k, _, _, _ = compare("fused_rkn_grid", "wave_overflow",
                         R["wave100_cubic"], (0.0, 0.5), w100, Fi5N,
                         rtol=1e-4, atol=1e-6, max_steps=2000)
    check(int(k[1][3]) == 3 and int((k[1] == 1).sum()) == 7,
          "B6 overflow isolation: member 3 must end with status 3 alone")

    # (b) the paths: every count set to 0 just before, read just after
    K32 = kepler_y0(KEP_N)
    K64 = kepler_y0(KEP_N, torch.float64)
    rng = np.random.RandomState(1)
    P64 = torch.tensor(np.concatenate([PL_Q0, PL_V0])[None, :]
                       + 1e-3 * rng.randn(PL_N, 28), device="cuda")
    F32 = fisher_y0(FISHER_M, FISHER_N)
    W32 = wave_y0(WAVE_M, WAVE_N)
    counted = (ops.solve_fused_erk_grid, ops.solve_fused_rkn,
               ops.solve_fused_rkn_grid)
    others = (ops.solve_fused_erk, ops.solve_fused_esdirk,
              ops.solve_fused_adams, ops.solve_fused_rkc,
              ops.solve_fused_rkc_ensemble)
    for fn in counted + others:
        fn.launches = 0
    t0 = time.perf_counter()
    kep64 = solve_ensemble(kepler, KEP_SPAN, K64, method=Fi5N, **KEP_F64_TOL)
    torch.cuda.synchronize()
    kep64_s = time.perf_counter() - t0
    kep_plain = ops.solve_fused_rkn(R["kepler"], KEP_SPAN, K32, method=Fi5N,
                                    **KEP_PLAIN_TOL)
    kep_shape = ops.solve_fused_rkn.last_shape
    kep_comp = ops.solve_fused_rkn(R["kepler"], KEP_SPAN, K32, method=Fi5N,
                                   **KEP_COMP_TOL)
    kep_comp_shape = ops.solve_fused_rkn.last_shape
    t0 = time.perf_counter()
    pl64 = solve_ensemble(pleiades, PL_SPAN, P64, method=CFMR7osc,
                          rtol=1e-9, atol=1e-12)
    torch.cuda.synchronize()
    pl_s = time.perf_counter() - t0
    fis = ops.solve_fused_erk_grid(R["fisher"], FISHER_SPAN, F32, method=BS5,
                                   **FISHER_TOL)
    fis_shape = ops.solve_fused_erk_grid.last_shape
    wav = ops.solve_fused_rkn_grid(R["wave"], WAVE_SPAN, W32, method=Fi5N,
                                   **WAVE_TOL)
    wav_comp = ops.solve_fused_rkn_grid(R["wave"], WAVE_SPAN, W32,
                                        method=Fi5N, **WAVE_COMP_TOL)
    torch.cuda.synchronize()
    wave_shape = ops.solve_fused_rkn_grid.last_shape
    launches = tuple(fn.launches for fn in counted)
    print(f"second-order and mid-size paths: fused_erk_grid, fused_rkn, "
          f"fused_rkn_grid launches {launches}, others "
          f"{tuple(fn.launches for fn in others)}")
    check(launches == (1, 2, 2),
          f"launches {launches}, expected one per fused call: (1, 2, 2)")
    check(all(fn.launches == 0 for fn in others),
          "the second-order and mid-size paths launched another kernel")

    # (c) the gates against the f64 driver
    check(bool((kep64.status == 1).all()), "kepler f64: not all finished")
    for label, out in (("plain", kep_plain), ("compensated", kep_comp)):
        d = (out[0].double() - kep64.y).abs().max().item()
        print(f"kepler2048 fused {label} vs f64 (rtol 1e-9): status "
              f"{torch.unique(out[1]).tolist()}, max |dy| {d:.3e} (gate "
              f"{KEP_F64_GATES[label]:.0e}), mean nsteps "
              f"{out[2].double().mean():.2f} (f64 "
              f"{kep64.nsteps.double().mean():.2f})")
        check(bool((out[1] == 1).all()) and out[0].shape == (KEP_N, 4),
              f"kepler fused {label}: bad run")
        check(d <= KEP_F64_GATES[label], f"kepler fused {label}: endpoints")
    idx = torch.linspace(0, KEP_N - 1, 8).long()
    f64_against_cpu("kepler2048", kepler, KEP_SPAN, K64, Fi5N, idx,
                    KEP_F64_TOL)
    check(bool((pl64.status == 1).all()), "pleiades f64: not all finished")
    print(f"pleiades512-cfmr7osc f64: status 1 for all, nsteps "
          f"{int(pl64.nsteps.min())}-{int(pl64.nsteps.max())}, "
          f"{pl_s * 1e3:.1f} ms wall (one run)")
    f64_against_cpu("pleiades512", pleiades, PL_SPAN, P64, CFMR7osc,
                    torch.linspace(0, PL_N - 1, 8).long(),
                    dict(rtol=1e-9, atol=1e-12), gate=PLEIADES_CPU_GATE,
                    batch_witness=True)
    t0 = time.perf_counter()
    fis64 = solve_ensemble(fisher_mol(FISHER_N), FISHER_SPAN, F32.double(),
                           method=BS5, **FISHER_TOL)
    torch.cuda.synchronize()
    fis64_s = time.perf_counter() - t0
    dfis = (fis[0].double() - fis64.y).abs().max().item()
    print(f"fisher256x64-bs5: B4 status {torch.unique(fis[1]).tolist()}, "
          f"nsteps {int(fis[2].min())}-{int(fis[2].max())} (f64 "
          f"{int(fis64.nsteps.min())}-{int(fis64.nsteps.max())}), endpoint "
          f"vs f64 {dfis:.3e} (gate {FISHER_F64_GATE:.0e})")
    check(bool((fis[1] == 1).all()) and bool((fis64.status == 1).all()),
          "fisher: not all finished")
    check(dfis < FISHER_F64_GATE, "fisher: B4 and f64 disagree")
    t0 = time.perf_counter()
    wav64 = solve_ensemble(wave_first_order(WAVE_N), WAVE_SPAN, W32.double(),
                           method=Fi5N, rtol=1e-5, atol=1e-7,
                           first_step=0.05)
    torch.cuda.synchronize()
    wav64_s = time.perf_counter() - t0
    f64_against_cpu("wave256x64", wave_first_order(WAVE_N), WAVE_SPAN,
                    W32.double(), Fi5N,
                    torch.linspace(0, WAVE_M - 1, 4).long(),
                    dict(rtol=1e-5, atol=1e-7, first_step=0.05),
                    gate=WAVE_CPU_GATE, batch_witness=True)
    wav64c = solve_ensemble(wave_first_order(WAVE_N), WAVE_SPAN,
                            W32.double(), method=Fi5N, rtol=1e-6, atol=1e-9,
                            first_step=0.05)
    # the JAX test's own size: 16 members of 128 positions
    W16 = wave_y0(16, 128)
    rep = ops.solve_fused_rkn_grid(R["wave128"], WAVE_SPAN, W16, method=Fi5N,
                                   **WAVE_TOL)
    rep64 = solve_ensemble(wave_first_order(128), WAVE_SPAN, W16.double(),
                           method=Fi5N, rtol=1e-5, atol=1e-7, first_step=0.05)
    for label, out, ref in (("replica", rep, rep64), ("plain", wav, wav64),
                            ("compensated", wav_comp, wav64c)):
        check(bool((ref.status == 1).all()), "wave f64: not all finished")
        d = (out[0].double() - ref.y).abs().max().item()
        mean = out[2].double().mean().item()
        mean64 = ref.nsteps.double().mean().item()
        rel = WAVE_STEP_GATES.get(label)
        print(f"wave{'128x16' if label == 'replica' else '256x64'}-fi5n B6 "
              f"{label}: status {torch.unique(out[1]).tolist()}, endpoint vs "
              f"f64 {d:.3e} (gate {WAVE_F64_GATE:.0e}), mean nsteps "
              f"{mean:.2f} vs {mean64:.2f} (gate "
              + ("none" if rel is None else f"{rel:.0%} + 2") + ")")
        check(bool((out[1] == 1).all()), f"wave {label}: not all finished")
        check(d < WAVE_F64_GATE, f"wave {label}: B6 and f64 endpoints")
        check(rel is None or abs(mean - mean64) < rel * mean64 + 2,
              f"wave {label}: B6 and f64 step counts")

    # (d) each kernel against its plain version at the paths' shapes
    errs, plain_ms = {}, {}
    for kind, label, rhs, span, y0, meth, tol, out in (
            ("fused_rkn", "kepler", R["kepler"], KEP_SPAN, K32, Fi5N,
             KEP_PLAIN_TOL, kep_plain),
            ("fused_rkn", "kepler_comp", R["kepler"], KEP_SPAN, K32, Fi5N,
             KEP_COMP_TOL, kep_comp),
            ("fused_erk_grid", "fisher", R["fisher"], FISHER_SPAN, F32, BS5,
             FISHER_TOL, fis),
            ("fused_rkn_grid", "wave", R["wave"], WAVE_SPAN, W32, Fi5N,
             WAVE_TOL, wav),
            ("fused_rkn_grid", "wave_comp", R["wave"], WAVE_SPAN, W32, Fi5N,
             WAVE_COMP_TOL, wav_comp)):
        _, r, err, r_s = hold_against_plain(
            kind, f"{label}, the path", lambda o=out: o,
            lambda: kinds[kind][1](rhs, span, y0, method=meth, **tol),
            *RKN_KERNEL_GATES[label])
        if kind == "fused_rkn":
            hold_small_lanes(kind, f"{label}, the path", rhs, span, y0,
                             dict(tol, method=meth), out,
                             kep_comp_shape if tol.get("compensated")
                             else kep_shape)
        else:
            hold_grid_shapes(kind, f"{label}, the path", rhs, span, y0,
                             dict(tol, method=meth), out,
                             fis_shape if kind == "fused_erk_grid"
                             else wave_shape, r, RKN_KERNEL_GATES[label])
        errs[kind] = max(errs.get(kind, 0.0), err)
        plain_ms.setdefault(kind, r_s * 1e3)

    # (e) times: warm medians; the timing-only lines fill the card
    def run_kep(tol, y=K32):
        return lambda: ops.solve_fused_rkn(R["kepler"], KEP_SPAN, y,
                                           method=Fi5N, **tol)

    def run_fis():
        return ops.solve_fused_erk_grid(R["fisher"], FISHER_SPAN, F32,
                                        method=BS5, **FISHER_TOL)

    def run_wav(tol, y=W32):
        return lambda: ops.solve_fused_rkn_grid(R["wave"], WAVE_SPAN, y,
                                                method=Fi5N, **tol)

    times = {}
    for label, fn, out in (("kepler2048 B5 plain", run_kep(KEP_PLAIN_TOL),
                            kep_plain),
                           ("kepler2048 B5 compensated",
                            run_kep(KEP_COMP_TOL), kep_comp),
                           ("fisher256x64 B4", run_fis, fis),
                           ("wave256x64 B6 plain", run_wav(WAVE_TOL), wav),
                           ("wave256x64 B6 compensated",
                            run_wav(WAVE_COMP_TOL), wav_comp)):
        ms, dev = wall_ms(fn), event_ms(fn)
        times[label] = (ms, dev)
        print(f"time [{label}]: {ms:.3f} ms wall, {dev:.4f} ms device (CUDA "
              f"events), {int(out[2].sum()) / ms * 1e3:.4g} accepted "
              f"steps/s, {int(out[3].sum()) / ms * 1e3:.4g} RHS evals/s")
    f64_ms = {"fused_rkn": kep64_s * 1e3, "fused_erk_grid": fis64_s * 1e3,
              "fused_rkn_grid": wav64_s * 1e3}
    print("time [plain versions] (one run each): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items())
          + "; [f64 solve_ensemble] (one run each): kepler2048 at rtol 1e-9 "
          f"{kep64_s * 1e3:.1f} ms, fisher {fis64_s * 1e3:.1f} ms, wave "
          f"{wav64_s * 1e3:.1f} ms, pleiades512 {pl_s * 1e3:.1f} ms")
    k_large = kepler_y0(N_LARGE)
    for label, tol in (("plain", KEP_PLAIN_TOL), ("compensated",
                                                  KEP_COMP_TOL)):
        out = run_kep(tol, k_large)()
        check(bool((out[1] == 1).all()), f"kepler262k {label}: not finished")
        check(ops.solve_fused_rkn.last_shape[0] == 1,
              f"kepler262k {label}: the rule took a lane group")
        large = shape_text(ops.solve_fused_rkn, N_LARGE)
        ms = event_ms(run_kep(tol, k_large))
        print(f"fused_rkn kernel {label} kepler262k ({large}): {ms:.3f} ms, "
              f"{int(out[2].sum()) / ms * 1e3:.4g} accepted steps/s")
    print(f"kepler2048 B5 ran at {kep_shape[0]} lanes per member, "
          f"{kep_shape[1]} members per block (plain), {kep_comp_shape[0]} "
          f"and {kep_comp_shape[1]} (compensated)")
    w_large = wave_y0(WAVE_M_LARGE, WAVE_N)
    out = run_wav(WAVE_TOL, w_large)()
    check(bool((out[1] == 1).all()), "wave1024: not all finished")
    large_shape = ops.solve_fused_rkn_grid.last_shape
    shape = grid_shape_text(large_shape, WAVE_M_LARGE)
    _, r, _, _ = hold_against_plain(
        "fused_rkn_grid", "wave1024", lambda: out,
        lambda: ops.fused_rkn_grid_reference(R["wave"], WAVE_SPAN, w_large,
                                             method=Fi5N, **WAVE_TOL),
        *RKN_KERNEL_GATES["wave1024"])
    hold_grid_shapes("fused_rkn_grid", "wave1024", R["wave"], WAVE_SPAN,
                     w_large, dict(WAVE_TOL, method=Fi5N), out, large_shape,
                     r, RKN_KERNEL_GATES["wave1024"])
    ms = event_ms(run_wav(WAVE_TOL, w_large))
    print(f"fused_rkn_grid kernel wave1024 ({shape}): {ms:.3f} ms, "
          f"{int(out[2].sum()) / ms * 1e3:.4g} accepted steps/s")
    print(f"wave256x64 B6 ran at {grid_shape_text(wave_shape, WAVE_M)}")
    f_large = fisher_y0(FISHER_M_LARGE, FISHER_N)

    def run_fis_large():
        return ops.solve_fused_erk_grid(R["fisher"], FISHER_SPAN, f_large,
                                        method=BS5, **FISHER_TOL)

    out = run_fis_large()
    check(bool((out[1] == 1).all()), "fisher1024: not all finished")
    large_shape = ops.solve_fused_erk_grid.last_shape
    _, r, _, _ = hold_against_plain(
        "fused_erk_grid", "fisher1024", lambda: out,
        lambda: ops.fused_erk_grid_reference(R["fisher"], FISHER_SPAN,
                                             f_large, method=BS5,
                                             **FISHER_TOL),
        *RKN_KERNEL_GATES["fisher1024"])
    hold_grid_shapes("fused_erk_grid", "fisher1024", R["fisher"],
                     FISHER_SPAN, f_large, dict(FISHER_TOL, method=BS5), out,
                     large_shape, r, RKN_KERNEL_GATES["fisher1024"])
    fis_large_ms = event_ms(run_fis_large)
    print(f"fused_erk_grid kernel fisher1024 "
          f"({grid_shape_text(large_shape, FISHER_M_LARGE)}): "
          f"{fis_large_ms:.3f} ms, {int(out[2].sum()) / fis_large_ms * 1e3:.4g}"
          " accepted steps/s")
    print(f"fisher256x64 B4 ran at {grid_shape_text(fis_shape, FISHER_M)}")

    def entry(name, source, replaces, launches, key, bytes_moved, ops_):
        return dict({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": errs[name], "ms": times[key][0],
                     "device_ms": times[key][1], "plain_ms": plain_ms[name],
                     "f64_ms": f64_ms[name]},
                    **bound_entry(bytes_moved, ops_))

    csrc = "extensisq_tpu_torch/csrc/"
    fi5n, bs5 = rkn_consts(Fi5N), _fused_consts(BS5)
    return [
        dict(entry("fused_rkn", csrc + "fused_rkn.cu",
                   "extensisq_tpu/ops/fused_rkn.py:639", launches[1],
                   "kepler2048 B5 plain", KEP_N * (4 * 4 * 2 + 4 * 3),
                   rk_ops(fi5n, True, 2, RHS_OPS["kepler"],
                          int(kep_plain[3].sum()), KEP_N, 5)),
             ms_compensated=times["kepler2048 B5 compensated"][0],
             lanes=kep_shape[0], block_members=kep_shape[1],
             lanes_compensated=kep_comp_shape[0],
             block_members_compensated=kep_comp_shape[1]),
        dict(entry("fused_erk_grid", csrc + "fused_rk_grid.cu",
                   "extensisq_tpu/ops/fused_erk_grid.py:321", launches[0],
                   "fisher256x64 B4",
                   FISHER_M * (FISHER_N * 4 * 2 + 4 * 3),
                   rk_ops(bs5, False, FISHER_N, RHS_OPS["fisher"],
                          int(fis[3].sum()), FISHER_M, 5)),
             device_ms_1024=fis_large_ms),
        dict(entry("fused_rkn_grid", csrc + "fused_rk_grid.cu",
                   "extensisq_tpu/ops/fused_rkn_grid.py:337", launches[2],
                   "wave256x64 B6 plain",
                   WAVE_M * (2 * WAVE_N * 4 * 2 + 4 * 3),
                   rk_ops(fi5n, True, WAVE_N, RHS_OPS["wave"],
                          int(wav[3].sum()), WAVE_M, 1)),
             ms_compensated=times["wave256x64 B6 compensated"][0])]


# -- the CKdisc path -------------------------------------------------------
# validation/benchmarks.py:105-142 (config 1c, not cut): 1024 members of the
# sign-switching decay through B11 against the f64 driver; the non-smooth
# advection-reaction MoL of tests/test_fused_pallas.py:2010-2024 at config
# 1b's widths (256 states, 64 members) through B12, and 1024 members of it
# for timing only
CK_N, CK_SPAN = 1024, (0.0, 5.0)
CK_TOL = dict(rtol=1e-4, atol=1e-7)
CKMOL_N, CKMOL_M, CKMOL_M_LARGE, CKMOL_SPAN = 256, 64, 1024, (0.0, 1.2)
CKMOL_TOL = dict(rtol=1e-4, atol=1e-6)
# the JAX gates: config 1c's endpoint 5e-3 (validation/benchmarks.py:139,
# measured with a margin over the f32 bifurcation of
# validation/ckdisc_drift.py), the MoL's endpoint 2e-3 and mean nsteps
# within 20% (tests/test_fused_pallas.py:2034-2042)
CK_F64_GATE = 5e-3
CKMOL_F64_GATE = 2e-3
CKMOL_STEP_GATE = 0.2
# kernel against its plain version on the card: (max |dy| over finished
# members, relative difference of mean nsteps, max |dnsteps|).  Measured on
# an H100 (nvcc contracts into fma, the plain version rounds each
# operation): on the small checks that do not bifurcate, linear 1.9e-7 /
# 6.0e-4 / 1 (10 of 1024 members one step apart), rational 6.0e-8 / 0 / 0,
# fisher 1.6e-5 / 1.8e-3 / 1 (the upwind MoL without the switch, 8
# members), diffusion 7.2e-7 / 0 / 0, and from a first step cubic_overflow
# 0 / 0 / 0 and mol_overflow 2.8e-5 / 0 / 0 (from Watts' start, NaN for
# the overflowing member, its plain version runs to the step cap, ~10 s
# here, and the others part by 1.6e-4: tests/test_torch_fused_ckdisc.py
# holds that case); on the sign-switching lines, where independent
# float32 implementations part by ~3e-3 (validation/ckdisc_drift.py:13-36),
# mol
# 3.0e-4 / 3.1e-2 / 6 (8 members), swdec (the path) 2.9e-3 / 7.8e-3 / 10,
# ckmol (the path) 5.7e-4 / 2.5e-3 / 9.  The gates keep a margin of 2-5x
CK_KERNEL_GATES = {"linear": (1e-6, 2e-3, 2), "rational": (1e-6, 1e-3, 1),
                   "cubic_overflow": (1e-6, 1e-3, 1),
                   "fisher": (5e-5, 5e-3, 2), "diffusion": (3e-6, 1e-3, 1),
                   "mol_overflow": (1e-4, 1e-3, 1),
                   "mol": (1e-3, 8e-2, 12), "swdec": (6e-3, 2e-2, 20),
                   "ckmol": (2e-3, 1e-2, 20)}
# B12 at its other block shapes (measured on an H100, blocks of 64 / 128 /
# 256 threads): fisher 1.5e-5 / 5.5e-3 / 1 at 64 threads, two elements a
# thread (three of the 8 members one step apart; 1.6e-5 / 1.8e-3 / 1 at
# 128), its own gate below; diffusion 9.5e-7 / 0 / 0 and mol_overflow
# 2.8e-5 / 0 / 0 at 64; mol 3.0e-4 / 2.3e-2 / 5; ckmol (the path) 4.7e-4 /
# 2.6e-3 / 6, 4.7e-4 / 3.6e-3 / 6, 5.7e-4 / 2.5e-3 / 9; ckmol1024 (1,024
# members; the rule takes 64 threads) 9.5e-4 / 1.1e-4 / 11, 9.6e-4 /
# 2.7e-4 / 10, 1.0e-3 / 4.2e-5 / 11, within the ckmol gates
CK_KERNEL_GATES["ckmol1024"] = CK_KERNEL_GATES["ckmol"]
GRID_SHAPE_GATES = {("fused_ckdisc_grid", "fisher", (64, 0)):
                    (5e-5, 1.2e-2, 2)}
# the f64 line rerun on the CPU: counters identical, |dy| relative to
# max(1, |y|) within the gate; the sampled members also run inside the whole
# batch on the CPU, the witness of what the batch's shape alone moves
# (PyTorch's vectorised pow rounds by it, and a step that lands a few ulps
# elsewhere near a switch takes a fallback of the tolerance's accuracy):
# 1.527e-12 on a CPU; the card vs the CPU measured 6.120e-12 on an H100
CK_CPU_GATE = 1e-11
# RHS_OPS of the CKdisc lines: the switch (sinf, a product, a comparison, a
# select) and the sign-switching decay's 2 per element; the MoL's stencil,
# logistic term and forcing 7 per element


def _sw_cuda(freq):
    return f"const float sw = sinf({_lit(freq)} * t) >= 0.0f ? 1.0f : -1.0f;"


def swdec_rows(t, y):
    """Config 1c's RHS (validation/benchmarks.py:110-113), rows-first."""
    sw = torch.where(torch.sin(3.0 * t) >= 0.0, 1.0, -1.0)
    return torch.stack([(-sw - 0.5) * y[0], (sw - 0.5) * y[1]])


def ck_mol(n):
    def fun(t, y):
        sw = torch.where(torch.sin(4.0 * t) >= 0.0, 1.0, -1.0)
        return -(y - torch.roll(y, 1, 0)) * float(n) + y * (1 - y) + 0.3 * sw
    return fun


def _ck_mol_cuda(n):
    return ("__device__ float rhs(float t, const float* y, int i, "
            "const float* p) {\n  " + _sw_cuda(4.0) + "\n"
            f"  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {_lit(n)}\n"
            "         + y[i] * (1.0f - y[i]) + 0.3f * sw;\n}")


def linear2(t, y):
    return torch.stack([-y[0], -0.5 * y[1] + y[0]])


def rational(t, y):
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def diffusion200(t, y):
    z = torch.zeros_like(y[:1])
    return (20.0 * (torch.cat([z, y[:-1]]) - 2.0 * y + torch.cat([y[1:], z]))
            + torch.abs(y - 0.4))


def ckdisc_rhs():
    """The FusedRHS/FusedGridRHS of every CKdisc variant, by label."""
    from extensisq_tpu_torch.ops import FusedGridRHS, FusedRHS
    flat = "__device__ void rhs(float t, const float* y, float* dy) {\n"
    return {
        "swdec": FusedRHS(swdec_rows, flat + "  " + _sw_cuda(3.0) + "\n"
                          "  dy[0] = (-sw - 0.5f) * y[0];\n"
                          "  dy[1] = (sw - 0.5f) * y[1];\n}", 2),
        "linear": FusedRHS(linear2, flat + "  dy[0] = -y[0];\n"
                           "  dy[1] = -0.5f * y[1] + y[0];\n}", 2),
        "rational": FusedRHS(rational, flat + "  dy[0] = y[1] / t;\n"
                             "  dy[1] = y[1] * (y[0] + 2.0f * y[1] - 1.0f)"
                             " / (t * (y[0] - 1.0f));\n}", 2),
        "cubic": FusedRHS(cubic, CUBIC_CUDA, 2),
        "ckmol": FusedGridRHS(ck_mol(CKMOL_N), _ck_mol_cuda(CKMOL_N),
                              (CKMOL_N,)),
        "ckmol128": FusedGridRHS(ck_mol(128), _ck_mol_cuda(128), (128,)),
        "fisher128": FusedGridRHS(fisher_mol(128), _fisher_cuda(128), (128,)),
        "diffusion": FusedGridRHS(
            diffusion200, "__device__ float rhs(float t, const float* y, "
            "int i, const float* p) {\n"
            "  const float left = i > 0 ? y[i - 1] : 0.0f;\n"
            "  const float right = i < 199 ? y[i + 1] : 0.0f;\n"
            "  return 20.0f * (left - 2.0f * y[i] + right)"
            " + fabsf(y[i] - 0.4f);\n}", (200,))}


def ckdisc_builds(rhs):
    """(kernel, label, rhs, None) of every B11/B12 variant."""
    return ([("fused_ckdisc", k, rhs[k], None)
             for k in ("swdec", "linear", "rational", "cubic")]
            + [("fused_ckdisc_grid", k, rhs[k], None)
               for k in ("ckmol", "ckmol128", "fisher128", "diffusion")])


def swdec_y0(dtype):
    """Config 1c's members (validation/benchmarks.py:116-117)."""
    y0 = (1.0 + 0.5 * np.random.RandomState(1).rand(CK_N, 2))
    return torch.tensor(y0.astype(np.float32), dtype=dtype, device="cuda")


def ck_ops(n_row, rhs_ops, nfev_sum, members, start_evals):
    """float32 operations of a B11 or B12 run (stage rows of ``n_row``
    elements) whose members made ``nfev_sum`` RHS evaluations (their real
    ones: the kernels skip vetoed stages), ``start_evals`` each for the
    start.  Counted from csrc/fused_ckdisc.cu and ck_control.cuh with the
    weights' nonzeros: per element, the five stage arguments (a sum and 2)
    over the five stage evaluations of a full attempt, and the E1, E2 and
    E4 assessments (the solution's and the error's sums, 3, and the scaled
    square, 8) over the evaluations that reach them; per member and
    attempt ~40 for the roots, the cascade and the step control."""
    from extensisq_tpu_torch.ops.fused_ckdisc import ck_consts
    k = ck_consts()
    stage = sum(_wsum_ops(k["A"][i, :i]) + 2 for i in range(1, 6))
    assess = sum(_wsum_ops(b[:m]) + _wsum_ops(e[:m]) + 11 for b, e, m in (
        (k["B_as"][0], k["E_as"][0], 2), (k["B_as"][1], k["E_as"][1], 4),
        (k["B"], k["E"], 6)))
    per_eval = n_row * ((stage + assess) / 5 + rhs_ops) + 40 / 5
    start = members * start_evals
    return (nfev_sum - start) * per_eval + start * n_row * rhs_ops


def ckdisc_path():
    """The CKdisc paths: B11 and B12 against their plain versions (small
    checks and the paths' shapes), config 1c through B11 and the MoL
    through B12, each held against the f64 driver; returns the ``kernels``
    entries of B11 and B12."""
    from extensisq_tpu_torch import CKdisc, solve_ensemble
    from extensisq_tpu_torch import ops
    R = ckdisc_rhs()
    kinds = {"fused_ckdisc": (ops.solve_fused_ckdisc,
                              ops.fused_ckdisc_reference),
             "fused_ckdisc_grid": (ops.solve_fused_ckdisc_grid,
                                   ops.fused_ckdisc_grid_reference)}

    def compare(kind, label, rhs, span, y0, **kw):
        run, plain = kinds[kind]
        res = hold_against_plain(
            kind, label, lambda: run(rhs, span, y0, **kw),
            lambda: plain(rhs, span, y0, **kw), *CK_KERNEL_GATES[label])
        if kind == "fused_ckdisc_grid":
            hold_grid_shapes(kind, label, rhs, span, y0, kw, res[0],
                             run.last_shape, res[1], CK_KERNEL_GATES[label])
        else:
            hold_small_lanes(kind, label, rhs, span, y0, kw, res[0],
                             run.last_shape)
        return res

    # (a) each kernel against its plain version on problems that do not
    # bifurcate, and an overflowing member of each
    n = 1024
    lin = torch.tensor(np.stack([np.linspace(0.5, 2.0, n), np.zeros(n)], 1),
                       dtype=torch.float32, device="cuda")
    compare("fused_ckdisc", "linear", R["linear"], (0.0, 5.0), lin,
            rtol=1e-5, atol=1e-8)
    rat = torch.tensor(np.array([[1 / 3, 2 / 9]])
                       * np.linspace(1.0, 1.2, n)[:, None],
                       dtype=torch.float32, device="cuda")
    compare("fused_ckdisc", "rational", R["rational"], (5.0, 9.0), rat,
            rtol=1e-5, atol=1e-8)
    cub0 = torch.zeros(n, 2, device="cuda")
    cub0[:, 0] = 0.1
    cub0[7, 0] = 1e18                    # this member overflows in f32
    k, _, _, _ = compare("fused_ckdisc", "cubic_overflow", R["cubic"],
                         (0.0, 1.0), cub0, rtol=1e-4, atol=1e-6,
                         first_step=0.01, max_steps=2000)
    check(int(k[1][7]) != 1 and int((k[1] == 1).sum()) == n - 1,
          "B11 overflow isolation: member 7 must fail alone")
    f128 = fisher_y0(8, 128)
    compare("fused_ckdisc_grid", "fisher", R["fisher128"], (0.0, 1.0), f128,
            rtol=1e-5, atol=1e-7)
    xd = np.linspace(0, 1, 200)
    d200 = torch.tensor(np.tile(np.exp(-30 * (xd - 0.5) ** 2), (8, 1)),
                        dtype=torch.float32, device="cuda")
    compare("fused_ckdisc_grid", "diffusion", R["diffusion"], (0.0, 0.5),
            d200, rtol=1e-4, atol=1e-6)
    m128 = fisher_y0(8, 128)
    compare("fused_ckdisc_grid", "mol", R["ckmol128"], CKMOL_SPAN, m128,
            **CKMOL_TOL)
    m128[3] *= 1e20                      # this member overflows in f32
    k, _, _, _ = compare("fused_ckdisc_grid", "mol_overflow", R["ckmol128"],
                         (0.0, 0.5), m128, first_step=0.001, max_steps=2000,
                         **CKMOL_TOL)
    check(int(k[1][3]) != 1 and int((k[1] == 1).sum()) == 7,
          "B12 overflow isolation: member 3 must fail alone")

    # (b) the paths: every count set to 0 just before, read just after
    S32, S64 = swdec_y0(torch.float32), swdec_y0(torch.float64)
    M32 = fisher_y0(CKMOL_M, CKMOL_N)
    counted = (ops.solve_fused_ckdisc, ops.solve_fused_ckdisc_grid)
    others = (ops.solve_fused_erk, ops.solve_fused_esdirk,
              ops.solve_fused_adams, ops.solve_fused_rkc,
              ops.solve_fused_rkc_ensemble, ops.solve_fused_rkn,
              ops.solve_fused_erk_grid, ops.solve_fused_rkn_grid)
    for fn in counted + others:
        fn.launches = 0
    t0 = time.perf_counter()
    sw64 = solve_ensemble(swdec_rows, CK_SPAN, S64, method=CKdisc, **CK_TOL)
    torch.cuda.synchronize()
    sw64_s = time.perf_counter() - t0
    sw = ops.solve_fused_ckdisc(R["swdec"], CK_SPAN, S32, **CK_TOL)
    sw_shape = ops.solve_fused_ckdisc.last_shape
    mol = ops.solve_fused_ckdisc_grid(R["ckmol"], CKMOL_SPAN, M32,
                                      **CKMOL_TOL)
    mol_shape = ops.solve_fused_ckdisc_grid.last_shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mol64 = solve_ensemble(ck_mol(CKMOL_N), CKMOL_SPAN, M32.double(),
                           method=CKdisc, **CKMOL_TOL)
    torch.cuda.synchronize()
    mol64_s = time.perf_counter() - t0
    launches = tuple(fn.launches for fn in counted)
    print(f"CKdisc paths: fused_ckdisc, fused_ckdisc_grid launches "
          f"{launches}, others {tuple(fn.launches for fn in others)}")
    check(launches == (1, 1),
          f"launches {launches}, expected one per fused call: (1, 1)")
    check(all(fn.launches == 0 for fn in others),
          "the CKdisc paths launched another kernel")

    # (c) the gates against the f64 driver
    check(bool((sw64.status == 1).all()), "swdec f64: not all finished")
    check(bool((sw[1] == 1).all()) and sw[0].shape == (CK_N, 2)
          and bool(torch.isfinite(sw[0]).all()), "swdec B11: bad run")
    dsw = (sw[0].double() - sw64.y).abs().max().item()
    dstep = (sw[2] - sw64.nsteps).abs().max().item()
    print(f"swdec1024-ckdisc: B11 status {torch.unique(sw[1]).tolist()}, "
          f"endpoint vs f64 max |d| {dsw:.3e} (gate {CK_F64_GATE:.0e}), step "
          f"max |d| {dstep}, mean nsteps {sw[2].double().mean():.3f} vs "
          f"{sw64.nsteps.double().mean():.3f}, mean nfev "
          f"{sw[3].double().mean():.2f} vs {sw64.nfev.double().mean():.2f}, "
          f"members with other nsteps {int((sw[2] != sw64.nsteps).sum())}")
    check(dsw < CK_F64_GATE, "swdec: B11 and f64 disagree")
    f64_against_cpu("swdec1024", swdec_rows, CK_SPAN, S64, CKdisc,
                    torch.linspace(0, CK_N - 1, 8).long(), CK_TOL,
                    gate=CK_CPU_GATE, batch_witness=True)
    check(bool((mol[1] == 1).all()) and bool((mol64.status == 1).all()),
          "ckmol: not all finished")
    dmol = (mol[0].double() - mol64.y).abs().max().item()
    mean, mean64 = (mol[2].double().mean().item(),
                    mol64.nsteps.double().mean().item())
    print(f"ckmol256x64-ckdisc: B12 status {torch.unique(mol[1]).tolist()}, "
          f"endpoint vs f64 {dmol:.3e} (gate {CKMOL_F64_GATE:.0e}), mean "
          f"nsteps {mean:.3f} vs {mean64:.3f} (gate "
          f"{CKMOL_STEP_GATE:.0%}), nsteps {int(mol[2].min())}-"
          f"{int(mol[2].max())} (f64 {int(mol64.nsteps.min())}-"
          f"{int(mol64.nsteps.max())})")
    check(dmol < CKMOL_F64_GATE, "ckmol: B12 and f64 endpoints")
    check(abs(mean - mean64) < CKMOL_STEP_GATE * mean64,
          "ckmol: B12 and f64 step counts")

    # (d) each kernel against its plain version at the paths' shapes
    errs, plain_ms = {}, {}
    for kind, label, rhs, span, y0, tol, out in (
            ("fused_ckdisc", "swdec", R["swdec"], CK_SPAN, S32, CK_TOL, sw),
            ("fused_ckdisc_grid", "ckmol", R["ckmol"], CKMOL_SPAN, M32,
             CKMOL_TOL, mol)):
        _, r, errs[kind], r_s = hold_against_plain(
            kind, f"{label}, the path", lambda o=out: o,
            lambda: kinds[kind][1](rhs, span, y0, **tol),
            *CK_KERNEL_GATES[label])
        plain_ms[kind] = r_s * 1e3
        if kind == "fused_ckdisc_grid":
            hold_grid_shapes(kind, f"{label}, the path", rhs, span, y0, tol,
                             out, mol_shape, r, CK_KERNEL_GATES[label])
        else:
            hold_small_lanes(kind, f"{label}, the path", rhs, span, y0, tol,
                             out, sw_shape)

    # (e) times: warm medians; the timing-only line fills the card
    def run_sw():
        return ops.solve_fused_ckdisc(R["swdec"], CK_SPAN, S32, **CK_TOL)

    def run_mol(y=M32):
        return lambda: ops.solve_fused_ckdisc_grid(R["ckmol"], CKMOL_SPAN, y,
                                                   **CKMOL_TOL)

    times = {}
    for label, fn, out in (("swdec1024 B11", run_sw, sw),
                           ("ckmol256x64 B12", run_mol(), mol)):
        ms, dev = wall_ms(fn), event_ms(fn)
        times[label] = (ms, dev)
        print(f"time [{label}]: {ms:.3f} ms wall, {dev:.4f} ms device (CUDA "
              f"events), {int(out[2].sum()) / ms * 1e3:.4g} accepted "
              f"steps/s, {int(out[3].sum()) / ms * 1e3:.4g} RHS evals/s")
    print(f"time [plain versions] (one run each): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items())
          + f"; [f64 solve_ensemble] (one run each): swdec1024 "
          f"{sw64_s * 1e3:.1f} ms, ckmol256x64 {mol64_s * 1e3:.1f} ms")
    m_large = fisher_y0(CKMOL_M_LARGE, CKMOL_N)
    out = run_mol(m_large)()
    check(bool((out[1] == 1).all()), "ckmol1024: not all finished")
    large_shape = ops.solve_fused_ckdisc_grid.last_shape
    _, r, _, _ = hold_against_plain(
        "fused_ckdisc_grid", "ckmol1024", lambda: out,
        lambda: ops.fused_ckdisc_grid_reference(R["ckmol"], CKMOL_SPAN,
                                                m_large, **CKMOL_TOL),
        *CK_KERNEL_GATES["ckmol1024"])
    hold_grid_shapes("fused_ckdisc_grid", "ckmol1024", R["ckmol"],
                     CKMOL_SPAN, m_large, CKMOL_TOL, out, large_shape, r,
                     CK_KERNEL_GATES["ckmol1024"])
    mol_large_ms = event_ms(run_mol(m_large))
    print(f"fused_ckdisc_grid kernel ckmol1024 "
          f"({grid_shape_text(large_shape, CKMOL_M_LARGE)}): "
          f"{mol_large_ms:.3f} ms, "
          f"{int(out[2].sum()) / mol_large_ms * 1e3:.4g} accepted steps/s")
    print(f"ckmol256x64 B12 ran at {grid_shape_text(mol_shape, CKMOL_M)}; "
          f"swdec1024 B11 at {shape_text(ops.solve_fused_ckdisc, CK_N)}")

    csrc = "extensisq_tpu_torch/csrc/"
    return [
        dict({"name": "fused_ckdisc", "route": "cuda",
              "source": csrc + "fused_ckdisc.cu",
              "replaces": "extensisq_tpu/ops/fused_ckdisc.py:557",
              "launches": launches[0], "max_abs_err": errs["fused_ckdisc"],
              "ms": times["swdec1024 B11"][0],
              "device_ms": times["swdec1024 B11"][1],
              "plain_ms": plain_ms["fused_ckdisc"], "f64_ms": sw64_s * 1e3,
              "lanes": sw_shape[0], "block_members": sw_shape[1]},
             **bound_entry(CK_N * (2 * 4 * 2 + 4 * 3),
                           ck_ops(2, RHS_OPS["swdec"], int(sw[3].sum()),
                                  CK_N, 5))),
        dict({"name": "fused_ckdisc_grid", "route": "cuda",
              "source": csrc + "fused_rk_grid.cu",
              "replaces": "extensisq_tpu/ops/fused_ckdisc_grid.py:240",
              "launches": launches[1],
              "max_abs_err": errs["fused_ckdisc_grid"],
              "ms": times["ckmol256x64 B12"][0],
              "device_ms": times["ckmol256x64 B12"][1],
              "plain_ms": plain_ms["fused_ckdisc_grid"],
              "f64_ms": mol64_s * 1e3, "device_ms_1024": mol_large_ms},
             **bound_entry(CKMOL_M * (CKMOL_N * 4 * 2 + 4 * 3),
                           ck_ops(CKMOL_N, RHS_OPS["ckmol"],
                                  int(mol[3].sum()), CKMOL_M, 5)))]


# -- the mid-size SWAG and ESDIRK paths (B8, B7) -----------------------------
# BASELINE config 2d (validation/benchmarks.py:221-259): 32 members of the
# 256-state periodic heat MoL (D = 0.01, dx = 1/256), y0 = amps sin(2 pi x)
# + 0.3 cos(4 pi x) with amps = linspace(0.5, 1.5), SWAG with k_max 6 on
# t in [0, 0.25] at rtol 1e-4 / atol 1e-6
HEAT_N, HEAT_M, HEAT_SPAN = 256, 32, (0.0, 0.25)
HEAT_TOL = dict(rtol=1e-4, atol=1e-6, k_max=6)
# BASELINE config 4d (validation/benchmarks.py:463-502): 32 members of the
# 128-state periodic reaction-diffusion (D = 1, dx = 1/128, f = D lap y +
# y^2 (1 - y)), y0 = 0.5 + 0.4 amps sin(2 pi x) with amps =
# linspace(0.3, 0.7), Kv3I on t in [0, 1] at rtol 1e-4 / atol 1e-6
RD_N, RD_M, RD_SPAN = 128, 32, (0.0, 1.0)
RD_TOL = dict(rtol=1e-4, atol=1e-6)
# the JAX tests' span for the step gate (tests/test_fused_pallas.py:957-988):
# on the whole span the float32 steps inflate ~3x at the steady-state tail
# (validation/benchmarks.py:463-469), so the steps are held on t <= 0.1
RD_STEP_SPAN = (0.0, 0.1)
GRID_LARGE = 1024                     # timing only: ~8 blocks per SM
# the JAX gates: 2d and 4d endpoints within 1e-3 of the f64 driver; 2d mean
# nsteps within 15% (tests/test_fused_pallas.py:598-628), 4d within 20% + 2
# (:957-988); the DAE lanes within 1e-4 of y0 exp(-t) (:991-1015); the
# compensated run at rtol 1e-6 within 3e-5 of f64 (:1018-1039)
GRID_F64_GATE = 1e-3
HEAT_STEP_GATE = 0.15
RD_STEP_GATE = 0.2
DAE_EXACT_GATE = 1e-4
RD_COMP_GATE = 3e-5
# kernel against its plain version on the card: (max |dy| over finished
# members, relative difference of mean nsteps, max |dnsteps|).  Measured on
# an H100 (nvcc contracts into fma, the plain version rounds each
# operation): heat32 4.5e-5 / 4.0e-3 / 2, skew_back 7.2e-7 / 0 / 0,
# heat_max_step 1.8e-7 / 0 / 0, heat_overflow 3.3e-5 / 0 / 0, rd_kv3i
# 1.0e-5 / 7.0e-3 / 1, rd_trbdf2 7.3e-6 / 0 / 0, rd_comp 2.5e-6 / 9.6e-3 /
# 1, dae 1.8e-7 / 0 / 0, dirichlet_back 6.1e-7 / 0 / 0, cubic_overflow
# 2.1e-7 / 0 / 0; on the paths, whose float32 step sequences bifurcate
# (2d's stability-limited SWAG steps, 4d's steady-state tail, where
# round-off caps h), heat2d 5.4e-4 / 3.8e-3 / 58 and rd4d 6.4e-5 / 7.7e-3 /
# 28.  The gates keep a margin of 2-5x
MID_KERNEL_GATES = {"heat32": (1e-4, 2e-2, 4), "skew_back": (2e-6, 1e-2, 1),
                    "heat_max_step": (1e-6, 1e-2, 1),
                    "heat_overflow": (1e-4, 1e-2, 2),
                    "rd_kv3i": (3e-5, 3e-2, 2), "rd_trbdf2": (2e-5, 1e-2, 1),
                    "rd_comp": (1e-5, 3e-2, 2), "dae": (1e-6, 1e-2, 1),
                    "dirichlet_back": (2e-6, 1e-2, 1),
                    "cubic_overflow": (1e-6, 1e-2, 1),
                    "heat2d": (2e-3, 2e-2, 120), "rd4d": (2e-4, 3e-2, 60)}
# RHS_OPS of the mid-size lines, per element: the heat stencil (two adds, a
# product, a difference and the scale) and the reaction-diffusion's (the
# same and y^2 (1 - y), its sum with the stencil)
RHS_OPS.update({"heat": 5, "rdiff": 9,
                # the tangent of a row of config 4d's reaction-diffusion
                # (its band passes): the stencil (4), y y (3), the product
                # with 1 - y (3) and the sum (1)
                "rdiff_band": 11})


def heat_mol(n, diff):
    c = diff * n * n

    def fun(t, y):
        return (torch.roll(y, 1, 0) + torch.roll(y, -1, 0) - 2.0 * y) * c
    return fun


def _heat_cuda(n, diff):
    return ("__device__ float rhs(float t, const float* y, int i, "
            "const float* p) {\n  using G = tab::G;\n"
            "  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) - "
            f"2.0f * y[i]) * {_lit(diff * n * n)};\n}}")


def heat_cubic32(t, y):
    return heat_mol(32, 0.05)(t, y) + y * y * y


def skew32(t, y):
    return -(torch.roll(y, -1, 0) - torch.roll(y, 1, 0)) * 16.0


def rdiff_mol(n):
    c = float(n * n)

    def fun(t, y):
        return ((torch.roll(y, 1, 0) + torch.roll(y, -1, 0) - 2.0 * y) * c
                + y * y * (1.0 - y))
    return fun


def _rdiff_cuda(n):
    return ("template <class T>\n__device__ T rhs(T t, const T* y, int i, "
            "const float* p) {\n  using G = tab::G;\n"
            "  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) - "
            f"2.0f * y[i]) * {_lit(n * n)}\n"
            "         + y[i] * y[i] * (1.0f - y[i]);\n}")


def dae_lanes(t, y):
    even = (torch.arange(y.shape[0], device=y.device)[:, None] % 2
            == 0).to(y.dtype)
    return even * (-y) + (1.0 - even) * (torch.roll(y, 1, 0) - y)


def dirichlet(n, cubic):
    """Central advection (or, with ``cubic``, diffusion plus a cubic
    source) with zero boundaries: a strictly tridiagonal Jacobian."""
    def fun(t, y):
        z = torch.zeros_like(y[:1])
        right, left = torch.cat([y[1:], z]), torch.cat([z, y[:-1]])
        if cubic:
            return (right + left - 2.0 * y) * float(n * n) + y * y * y
        return -(right - left) * (0.5 * n)
    return fun


def _dirichlet_cuda(n, cubic):
    body = (f"(right + left - 2.0f * y[i]) * {_lit(n * n)} + y[i] * y[i] * "
            "y[i]" if cubic else f"-(right - left) * {_lit(0.5 * n)}")
    return ("template <class T>\n__device__ T rhs(T t, const T* y, int i, "
            "const float* p) {\n"
            f"  const T right = i < {n - 1} ? y[i + 1] : T(0.0f);\n"
            "  const T left = i > 0 ? y[i - 1] : T(0.0f);\n"
            f"  return {body};\n}}")


def mid_rhs():
    """The FusedGridRHS of every B8/B7 variant, by label."""
    from extensisq_tpu_torch.ops import FusedGridRHS
    skew_src = ("__device__ float rhs(float t, const float* y, int i, "
                "const float* p) {\n  using G = tab::G;\n"
                "  return -(G::rolled<0>(y, i, -1) - G::rolled<0>(y, i, 1))"
                " * 16.0f;\n}")
    cubic_src = ("template <class T>\n__device__ T rhs(T t, const T* y, "
                 "int i, const float* p) {\n  using G = tab::G;\n"
                 "  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) "
                 f"- 2.0f * y[i]) * {_lit(51.2)} + y[i] * y[i] * y[i];\n}}")
    return {
        "heat": FusedGridRHS(heat_mol(HEAT_N, 0.01),
                             _heat_cuda(HEAT_N, 0.01), (HEAT_N,)),
        "heat32": FusedGridRHS(heat_mol(32, 0.05), _heat_cuda(32, 0.05),
                               (32,)),
        "skew32": FusedGridRHS(skew32, skew_src, (32,)),
        "heat_cubic32": FusedGridRHS(heat_cubic32, cubic_src, (32,)),
        "rdiff": FusedGridRHS(rdiff_mol(RD_N), _rdiff_cuda(RD_N), (RD_N,)),
        "dae": FusedGridRHS(dae_lanes, (
            "template <class T>\n__device__ T rhs(T t, const T* y, int i, "
            "const float* p) {\n  return i % 2 == 0 ? -y[i] : "
            "tab::G::rolled<0>(y, i, 1) - y[i];\n}"), (RD_N,)),
        "skew_d32": FusedGridRHS(dirichlet(32, False),
                                 _dirichlet_cuda(32, False), (32,)),
        "cubic_d32": FusedGridRHS(dirichlet(32, True),
                                  _dirichlet_cuda(32, True), (32,))}


def mid_builds(rhs):
    """(kernel, label, rhs, option) of every B8 (k_max) and B7 (method)
    variant."""
    from extensisq_tpu_torch import Kv3I, TRBDF2
    return ([("fused_adams_grid", f"{k} k_max={km}", rhs[k], km)
             for k, km in (("heat", 6), ("heat32", 4), ("heat32", 3),
                           ("skew32", 3), ("heat_cubic32", 4))]
            + [("fused_esdirk_grid", f"{k} {m.name}", rhs[k], m)
               for k, m in (("rdiff", Kv3I), ("rdiff", TRBDF2),
                            ("dae", Kv3I), ("skew_d32", TRBDF2),
                            ("cubic_d32", Kv3I))])


def heat_y0(members, n):
    """Config 2d's members (validation/benchmarks.py:242-245)."""
    x = np.linspace(0, 1, n, endpoint=False)
    amps = np.linspace(0.5, 1.5, members)
    return torch.tensor((amps[:, None] * np.sin(2 * np.pi * x)[None, :]
                         + 0.3 * np.cos(4 * np.pi * x)[None, :]),
                        dtype=torch.float32, device="cuda")


def rdiff_y0(members, n):
    """Config 4d's members (validation/benchmarks.py:482-485)."""
    x = np.linspace(0, 1, n, endpoint=False)
    amps = np.linspace(0.3, 0.7, members)
    return torch.tensor(0.5 + 0.4 * amps[:, None]
                        * np.sin(2 * np.pi * x)[None, :],
                        dtype=torch.float32, device="cuda")


def adams_ops(n, rhs_ops, compensated, work, evals):
    """float32 operations of a B3 run on members of ``n`` states from the
    kernel's work counters summed over the members, ``work`` = (attempts,
    and over them the sums of the order k, of k where the step was
    accepted, of the coefficient elements updated and of the element steps
    of the v update and the g loop), and its ``evals`` RHS evaluations (the
    init's left out).  Counted from csrc/fused_adams.cu at the orders the
    members took: per attempt and element the error weights, the three
    scaled error vectors and their squares (16) and the prediction (2,
    compensated 5), and ~20 scalar operations; per row of the predictor (k
    an attempt) and element its g . phi term (2, compensated 8) and the
    cumulative sum (1); per accepted step (a second evaluation) and element
    the corrector (3, compensated 29), the rows k and k + 1, q and its
    square (5), one add per row below k, and ~30 scalar operations of the
    order and step selection; per rejected attempt and row below k the
    restore (2 per element) and psi (1), and ~5 scalar operations; per
    coefficient element psi, alpha, the beta ratio and product, sig (9)
    and its row's beta scaling (1 per element); per element step of the v
    update and the g loop 2.  A transcendental function counts as one and
    the diagonal v update (taken when the order rises after several steps
    at one h) is left out, so the count is a lower bound."""
    att, rows, rows_acc, coef, steps = (int(x) for x in work)
    acc = int(evals) - att
    rej, rows_rej = att - acc, rows - rows_acc
    return (att * (n * (16 + (5 if compensated else 2) + rhs_ops) + 20)
            + rows * n * ((8 if compensated else 2) + 1)
            + acc * (n * ((29 if compensated else 3) + 5 + rhs_ops) + 30)
            + rows_acc * n + rows_rej * 2 * n + (rows_rej - rej) + rej * 5
            + coef * (9 + n) + steps * 2)


def adams_grid_ops(n, km, rhs_ops, nfev_sum, nsteps_sum, init_sum):
    """float32 operations of a B8 run whose members made ``nfev_sum`` RHS
    evaluations, ``init_sum`` of them in the float32 stepper's init (run
    outside the kernel, not counted) and took ``nsteps_sum`` steps.
    Counted from csrc/fused_adams_grid.cu: per attempt (one evaluation of f
    at the prediction) and element the beta scaling, the g . phi sum and
    the reverse cumulative sum over at most k_max + 2 rows (4 (k_max + 2)),
    the weights and the three scaled squares of the error ladder (14); per
    accepted step (a second evaluation) and element the corrector (3), the
    phi update over the rows (k_max + 3) and the order k + 1 norm (3); per
    member and attempt ~10 k_max^2 for the coefficient recurrences and the
    order and step selection."""
    attempts = nfev_sum - init_sum - nsteps_sum
    return (attempts * (n * (4 * (km + 2) + 14 + rhs_ops) + 10 * km * km)
            + nsteps_sum * n * ((km + 3) + 6 + rhs_ops))


def esdirk_grid_ops(n, k, rhs_ops, newton_evals, nsteps_sum, band_ops,
                    nb=None):
    """float32 operations of a B7 run whose members made ``newton_evals``
    Newton RHS evaluations and took ``nsteps_sum`` steps (rejected attempts
    not counted, so this is a lower bound), counted from
    csrc/fused_esdirk_grid.cu with L = ceil(log2 nb) reduction rounds: per
    element of the base block (nb rows, n without block_base) the band
    passes of each attempt (``band_ops``: the tangent of the row in the 3
    of the 4 striped passes whose seeds touch it, as the work the row
    needs), W (3) and the reduction's multipliers (12 L + 3);
    per element of the state the stage sums (4 per weight of A and Az), the
    solution, error and its norm (2 S + 8) and the filter's replay (4 L +
    2), and each Newton iteration's point (2), RHS, right-hand side (3),
    replay (4 L + 1), norm (6) and update (1)."""
    nb = n if nb is None else nb
    L = (nb - 1).bit_length()
    s = k["s"]
    stage = sum(_wsum_ops(k["A"][i, :i]) + _wsum_ops(k["Az"][i, :i]) + 4
                for i in range(1, s))
    per_attempt = (nb * (band_ops + 3 + 12 * L + 3)
                   + n * (stage + 2 * s + 8
                          + (4 * L + 2 if k["filter_error"] else 0)))
    per_newton = n * (2 + rhs_ops + 3 + 4 * L + 1 + 6 + 1)
    return nsteps_sum * per_attempt + newton_evals * per_newton


def mid_path():
    """The mid-size SWAG and ESDIRK paths: B8 and B7 against their plain
    versions (small checks with an overflowing member, and the paths'
    shapes), config 2d through B8 against the f64 SWAG driver, config 4d
    through B7 against the f64 Kv3I driver with the DAE-lanes and
    compensated checks; returns the ``kernels`` entries of B8 and B7."""
    from extensisq_tpu_torch import Kv3I, SWAG, TRBDF2, solve_ensemble
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops.fused_adams import _host_init
    from extensisq_tpu_torch.ops.fused_esdirk import _esdirk_consts
    R = mid_rhs()
    kinds = {"fused_adams_grid": (ops.solve_fused_adams_grid,
                                  ops.fused_adams_grid_reference),
             "fused_esdirk_grid": (ops.solve_fused_esdirk_grid,
                                   ops.fused_esdirk_grid_reference)}

    def compare(kind, label, rhs, span, y0, **kw):
        run, plain = kinds[kind]
        res = hold_against_plain(
            kind, label, lambda: run(rhs, span, y0, **kw),
            lambda: plain(rhs, span, y0, **kw), *MID_KERNEL_GATES[label])
        if kind == "fused_esdirk_grid":
            hold_grid_shapes(kind, label, rhs, span, y0, kw, res[0],
                             ops.solve_fused_esdirk_grid.last_shape, res[1],
                             MID_KERNEL_GATES[label])
        return res

    # (a) each kernel against its plain version on small checks, with an
    # overflowing member each
    h32 = heat_y0(8, 32)
    compare("fused_adams_grid", "heat32", R["heat32"], (0.0, 0.25), h32,
            rtol=1e-4, atol=1e-6, k_max=4)
    compare("fused_adams_grid", "skew_back", R["skew32"], (0.5, 0.0), h32,
            rtol=1e-5, atol=1e-7, k_max=3)
    compare("fused_adams_grid", "heat_max_step", R["heat32"], (0.0, 0.25),
            h32, rtol=1e-4, atol=1e-6, k_max=3, first_step=1e-3,
            max_step=0.005)
    bad = h32.clone()
    bad[3] *= 1e19                        # this member overflows in f32
    k, _, _, _ = compare("fused_adams_grid", "heat_overflow",
                         R["heat_cubic32"], (0.0, 0.1), bad, rtol=1e-4,
                         atol=1e-6, k_max=4, max_steps=2000)
    check(int(k[1][3]) == 3 and int((k[1] == 1).sum()) == 7,
          "B8 overflow isolation: member 3 must end with status 3 alone")
    r8 = rdiff_y0(8, RD_N)
    compare("fused_esdirk_grid", "rd_kv3i", R["rdiff"], RD_STEP_SPAN, r8,
            method=Kv3I, **RD_TOL)
    compare("fused_esdirk_grid", "rd_trbdf2", R["rdiff"], RD_STEP_SPAN, r8,
            method=TRBDF2, **RD_TOL)
    compare("fused_esdirk_grid", "rd_comp", R["rdiff"], (0.0, 0.02), r8,
            rtol=1e-6, atol=1e-9, compensated=True)
    m_dae = (np.arange(RD_N) % 2 == 0).astype(np.float64)
    d8 = torch.ones(8, RD_N, device="cuda") * torch.linspace(
        0.5, 2.0, 8, device="cuda")[:, None]
    compare("fused_esdirk_grid", "dae", R["dae"], (0.0, 1.0), d8, M=m_dae,
            yp0_batch=-d8, rtol=1e-5, atol=1e-7)
    xs = np.linspace(0, 1, 32)
    bump = torch.tensor(np.exp(-40 * (xs - 0.5) ** 2)[None, :]
                        * np.linspace(0.5, 1.0, 8)[:, None],
                        dtype=torch.float32, device="cuda")
    compare("fused_esdirk_grid", "dirichlet_back", R["skew_d32"], (0.2, 0.0),
            bump, method=TRBDF2, rtol=1e-5, atol=1e-7)
    bad = bump.clone()
    bad[3] *= 1e19                        # this member overflows in f32
    k, _, _, _ = compare("fused_esdirk_grid", "cubic_overflow",
                         R["cubic_d32"], (0.0, 0.05), bad, rtol=1e-4,
                         atol=1e-6, first_step=1e-3, max_steps=2000)
    check(int(k[1][3]) != 1 and int((k[1] == 1).sum()) == 7,
          "B7 overflow isolation: member 3 must fail alone")

    # (b) the paths, each with every count set to 0 just before it and read
    # just after
    every = (ops.solve_fused_erk, ops.solve_fused_esdirk,
             ops.solve_fused_adams, ops.solve_fused_rkc,
             ops.solve_fused_rkc_ensemble, ops.solve_fused_rkn,
             ops.solve_fused_erk_grid, ops.solve_fused_rkn_grid,
             ops.solve_fused_ckdisc, ops.solve_fused_ckdisc_grid,
             ops.solve_fused_adams_grid, ops.solve_fused_esdirk_grid)
    H32 = heat_y0(HEAT_M, HEAT_N)
    RD32 = rdiff_y0(RD_M, RD_N)
    launches, outs, shapes = {}, {}, {}
    for label, run in (
            ("fused_adams_grid", lambda: ops.solve_fused_adams_grid(
                R["heat"], HEAT_SPAN, H32, **HEAT_TOL)),
            ("fused_esdirk_grid", lambda: ops.solve_fused_esdirk_grid(
                R["rdiff"], RD_SPAN, RD32, **RD_TOL))):
        for fn in every:
            fn.launches = 0
        outs[label] = run()
        torch.cuda.synchronize()
        shapes[label] = getattr(getattr(ops, "solve_" + label),
                                "last_shape", None)
        counts = {fn.__name__: fn.launches for fn in every if fn.launches}
        print(f"mid-size path [{label}]: launches {counts}")
        launches[label] = getattr(ops, "solve_" + label).launches
        check(counts == {"solve_" + label: 1},
              f"{label} path: launches {counts}, expected one of its own")
    heat, rd = outs["fused_adams_grid"], outs["fused_esdirk_grid"]

    # (c) the gates against the f64 drivers
    t0 = time.perf_counter()
    heat64 = solve_ensemble(R["heat"].torch_fn, HEAT_SPAN, H32.double(),
                            method=SWAG, **HEAT_TOL)
    torch.cuda.synchronize()
    heat64_s = time.perf_counter() - t0
    check(bool((heat[1] == 1).all()) and bool((heat64.status == 1).all()),
          "heat2d: not all finished")
    check(heat[0].shape == (HEAT_M, HEAT_N)
          and bool(torch.isfinite(heat[0]).all()), "heat2d B8: bad output")
    dh = (heat[0].double() - heat64.y).abs().max().item()
    mean, mean64 = (heat[2].double().mean().item(),
                    heat64.nsteps.double().mean().item())
    print(f"heat256x32-swag (2d): B8 endpoint vs f64 max |d| {dh:.3e} (gate "
          f"{GRID_F64_GATE:.0e}), mean nsteps {mean:.3f} vs {mean64:.3f} "
          f"(gate {HEAT_STEP_GATE:.0%}), mean nfev "
          f"{heat[3].double().mean():.2f} vs "
          f"{heat64.nfev.double().mean():.2f}")
    check(dh < GRID_F64_GATE, "heat2d: B8 and f64 endpoints")
    check(abs(mean - mean64) < HEAT_STEP_GATE * mean64,
          "heat2d: B8 and f64 step counts")
    t0 = time.perf_counter()
    rd64 = solve_ensemble(R["rdiff"].torch_fn, RD_SPAN, RD32.double(),
                          method=Kv3I, **RD_TOL)
    torch.cuda.synchronize()
    rd64_s = time.perf_counter() - t0
    check(bool((rd[1] == 1).all()) and bool((rd64.status == 1).all()),
          "rdiff4d: not all finished")
    check(rd[0].shape == (RD_M, RD_N) and bool(torch.isfinite(rd[0]).all()),
          "rdiff4d B7: bad output")
    dr = (rd[0].double() - rd64.y).abs().max().item()
    print(f"rdiff128x32-kv3i (4d): B7 endpoint vs f64 max |d| {dr:.3e} (gate "
          f"{GRID_F64_GATE:.0e}), mean nsteps {rd[2].double().mean():.3f} vs "
          f"{rd64.nsteps.double().mean():.3f} (not gated on t <= 1: the "
          "float32 steady-state tail)")
    check(dr < GRID_F64_GATE, "rdiff4d: B7 and f64 endpoints")
    rs = ops.solve_fused_esdirk_grid(R["rdiff"], RD_STEP_SPAN, RD32,
                                     **RD_TOL)
    rs64 = solve_ensemble(R["rdiff"].torch_fn, RD_STEP_SPAN, RD32.double(),
                          method=Kv3I, **RD_TOL)
    mean, mean64 = (rs[2].double().mean().item(),
                    rs64.nsteps.double().mean().item())
    drs = (rs[0].double() - rs64.y).abs().max().item()
    print(f"rdiff128x32-kv3i on t <= 0.1: B7 vs f64 max |d| {drs:.3e}, mean "
          f"nsteps {mean:.3f} vs {mean64:.3f} (gate {RD_STEP_GATE:.0%} + 2)")
    check(bool((rs[1] == 1).all()) and drs < GRID_F64_GATE,
          "rdiff4d on t <= 0.1: B7 and f64 endpoints")
    check(abs(mean - mean64) < RD_STEP_GATE * mean64 + 2.0,
          "rdiff4d on t <= 0.1: B7 and f64 step counts")
    dae = ops.solve_fused_esdirk_grid(R["dae"], (0.0, 1.0), d8, M=m_dae,
                                      yp0_batch=-d8, rtol=1e-5, atol=1e-7)
    dexact = (dae[0] - d8 * np.exp(-1.0)).abs().max().item()
    print(f"B7 DAE lanes vs y0 exp(-t): max |d| {dexact:.3e} (gate "
          f"{DAE_EXACT_GATE:.0e})")
    check(bool((dae[1] == 1).all()) and dexact < DAE_EXACT_GATE,
          "B7 DAE lanes off the exact solution")
    comp = ops.solve_fused_esdirk_grid(R["rdiff"], RD_STEP_SPAN, r8,
                                       rtol=1e-6, atol=1e-9, compensated=True)
    comp64 = solve_ensemble(R["rdiff"].torch_fn, RD_STEP_SPAN, r8.double(),
                            method=Kv3I, rtol=1e-6, atol=1e-9)
    dcomp = (comp[0].double() - comp64.y).abs().max().item()
    print(f"B7 compensated at rtol 1e-6 vs f64: max |d| {dcomp:.3e} (gate "
          f"{RD_COMP_GATE:.0e}), mean nsteps {comp[2].double().mean():.3f} "
          f"vs {comp64.nsteps.double().mean():.3f}")
    check(bool((comp[1] == 1).all()) and dcomp < RD_COMP_GATE,
          "B7 compensated: off the f64 driver")

    # (d) each kernel against its plain version at the paths' shapes
    errs, plain_ms = {}, {}
    for kind, label, rhs, span, y0, tol, out in (
            ("fused_adams_grid", "heat2d", R["heat"], HEAT_SPAN, H32,
             HEAT_TOL, heat),
            ("fused_esdirk_grid", "rd4d", R["rdiff"], RD_SPAN, RD32, RD_TOL,
             rd)):
        _, r, errs[kind], r_s = hold_against_plain(
            kind, f"{label}, the path", lambda o=out: o,
            lambda: kinds[kind][1](rhs, span, y0, **tol),
            *MID_KERNEL_GATES[label])
        if kind == "fused_esdirk_grid":
            hold_grid_shapes(kind, f"{label}, the path", rhs, span, y0, tol,
                             out, shapes[kind], r, MID_KERNEL_GATES[label])
        plain_ms[kind] = r_s * 1e3

    # (e) times: warm medians; the timing-only lines fill the card
    def run_heat(y=H32):
        return lambda: ops.solve_fused_adams_grid(R["heat"], HEAT_SPAN, y,
                                                  **HEAT_TOL)

    def run_rd(y=RD32):
        return lambda: ops.solve_fused_esdirk_grid(R["rdiff"], RD_SPAN, y,
                                                   **RD_TOL)

    def heat_alone(y, out):
        """B8's launch alone on ``y``, its float32 init run before the
        window: (median device ms, attempts of the slowest member in
        ``out``, one evaluation each and one more when accepted)."""
        from extensisq_tpu_torch.ops import fused_adams_grid as FAG
        built = FAG._kernel(R["heat"], HEAT_TOL["k_max"])
        kw = dict(HEAT_TOL, first_step=None, max_steps=200_000,
                  max_step=None)
        start = FAG._start(R["heat"], HEAT_SPAN, y, kw["rtol"], kw["atol"],
                           None, kw["k_max"], None)
        ms = event_ms(lambda: FAG._launch(built, R["heat"], HEAT_SPAN, y,
                                          start=start, **kw))
        return ms, int((out[3] - start[2] - out[2]).max())

    times = {}
    for label, fn, out in (("heat256x32 B8", run_heat(), heat),
                           ("rdiff128x32 B7", run_rd(), rd)):
        ms, dev = wall_ms(fn), event_ms(fn)
        times[label] = (ms, dev)
        print(f"time [{label}]: {ms:.3f} ms wall, {dev:.4f} ms device (CUDA "
              f"events), {int(out[2].sum()) / ms * 1e3:.4g} accepted "
              f"steps/s, {int(out[3].sum()) / ms * 1e3:.4g} RHS evals/s")
    print(f"rdiff128x32 B7 ran at "
          f"{grid_shape_text(shapes['fused_esdirk_grid'], RD_M)}")
    alone, att = heat_alone(H32, heat)
    print(f"time [heat256x32 B8, launch alone]: {alone:.4f} ms device "
          f"(the window above also holds the float32 init), "
          f"{alone / att * 1e3:.3f} us per attempt of the slowest member "
          f"({att} attempts)")
    print(f"time [plain versions] (one run each): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items())
          + f"; [f64 solve_ensemble] (one run each): heat256x32 "
          f"{heat64_s * 1e3:.1f} ms, rdiff128x32 {rd64_s * 1e3:.1f} ms")
    for label, y_large, run in (
            ("heat1024 B8", heat_y0(GRID_LARGE, HEAT_N), run_heat),
            ("rdiff1024 B7", rdiff_y0(GRID_LARGE, RD_N), run_rd)):
        out = run(y_large)()
        check(bool((out[1] == 1).all()), f"{label}: not all finished")
        shape = (grid_shape_text(ops.solve_fused_esdirk_grid.last_shape,
                                 GRID_LARGE) if run is run_rd
                 else f"{GRID_LARGE} blocks")
        if run is run_rd:
            kind = "fused_esdirk_grid"
            _, r, _, _ = hold_against_plain(
                kind, "rdiff1024", lambda: out,
                lambda: kinds[kind][1](R["rdiff"], RD_SPAN, y_large,
                                       **RD_TOL), *MID_KERNEL_GATES["rd4d"])
            hold_grid_shapes(kind, "rdiff1024", R["rdiff"], RD_SPAN, y_large,
                             RD_TOL, out,
                             ops.solve_fused_esdirk_grid.last_shape, r,
                             MID_KERNEL_GATES["rd4d"])
        ms = event_ms(run(y_large))
        print(f"time [{label}] ({shape}): {ms:.3f} ms device, "
              f"{int(out[2].sum()) / ms * 1e3:.4g} accepted steps/s")
        if run is run_heat:
            ms1024, att1024 = heat_alone(y_large, out)
            print(f"time [{label}, launch alone]: {ms1024:.3f} ms device, "
                  f"{ms1024 / att1024 * 1e3:.3f} us per attempt of the "
                  f"slowest member")

    _, s0, _ = _host_init(R["heat"].torch_fn, HEAT_SPAN, H32.T,
                          HEAT_TOL["rtol"], HEAT_TOL["atol"], None, 6, None)
    csrc = "extensisq_tpu_torch/csrc/"
    return [
        dict({"name": "fused_adams_grid", "route": "cuda",
              "source": csrc + "fused_adams_grid.cu",
              "replaces": "extensisq_tpu/ops/fused_adams_grid.py:802",
              "launches": launches["fused_adams_grid"],
              "max_abs_err": errs["fused_adams_grid"],
              "ms": times["heat256x32 B8"][0],
              "device_ms": times["heat256x32 B8"][1],
              "device_ms_launch": alone,
              "plain_ms": plain_ms["fused_adams_grid"],
              "f64_ms": heat64_s * 1e3},
             **bound_entry(HEAT_M * (HEAT_N * 4 * 3 + 4 * 5),
                           adams_grid_ops(HEAT_N, 6, RHS_OPS["heat"],
                                          int(heat[3].sum()),
                                          int(heat[2].sum()),
                                          int(s0.nfev.sum())))),
        dict({"name": "fused_esdirk_grid", "route": "cuda",
              "source": csrc + "fused_esdirk_grid.cu",
              "replaces": "extensisq_tpu/ops/fused_esdirk_grid.py:873",
              "launches": launches["fused_esdirk_grid"],
              "max_abs_err": errs["fused_esdirk_grid"],
              "ms": times["rdiff128x32 B7"][0],
              "device_ms": times["rdiff128x32 B7"][1],
              "plain_ms": plain_ms["fused_esdirk_grid"],
              "f64_ms": rd64_s * 1e3},
             **bound_entry(RD_M * (RD_N * 4 * 2 + 4 * 3),
                           esdirk_grid_ops(RD_N, _esdirk_consts(Kv3I),
                                           RHS_OPS["rdiff"],
                                           int(rd[3].sum()) - RD_M,
                                           int(rd[2].sum()),
                                           3 * RHS_OPS["rdiff_band"])))]


# the trajectory phase: the f64 driver's dense output, events and windows
# on the main path's line, then one 64-member t_eval run per other family
TRAJ_N_EVAL = 201
TRAJ_TOL = dict(rtol=1e-6, atol=1e-9)
TRAJ_STOP = 2.45            # the terminal event's level: y[0] down through it
TRAJ_CPU_MEMBERS = 64
TRAJ_Y_GATE = 1e-11         # card vs CPU, relative to max(1, |y|)
TRAJ_T_GATE = 1e-10         # card vs CPU event times
TRAJ_LAST_GATE = 1e-12      # ys at the last step vs y, relative
TRAJ_FAMILIES = 64
TRAJ_REPS = 3               # warm timed runs of each vdp4096 variant


def _zero_y0(t, y):
    return y[0]


def _stop_y0(t, y):
    return y[0] - TRAJ_STOP


_stop_y0.terminal = True
_stop_y0.direction = -1


def _rel(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()


def _record_bytes(sol):
    return sum(v.numel() * v.element_size() for v in sol.record.values())


def trajectory_family_runs():
    """One 64-member ``t_eval`` run per family other than ERK on the card,
    each rerun on the CPU: counters identical, y_eval within the gate."""
    from extensisq_tpu_torch import solve_ensemble
    x = np.linspace(0.0, 1.0, 64, endpoint=False)
    rng = np.random.default_rng(16)
    heat0 = (np.sin(2 * np.pi * x)[None] * rng.uniform(0.8, 1.2, (64, 1))
             + 0.01 * rng.uniform(-1.0, 1.0, (64, 64)))
    vdp64 = vdp_y0(TRAJ_FAMILIES, torch.float64)
    runs = [("Fi5N", kepler, (0.0, 2 * np.pi),
             kepler_y0(TRAJ_FAMILIES, torch.float64), dict(rtol=1e-8,
                                                           atol=1e-11)),
            ("Kv3I", vdp, (0.0, 1.5), vdp64, dict(rtol=1e-5, atol=1e-8)),
            ("SWAG", vdp, (0.0, 3.0), vdp64, dict(rtol=1e-6, atol=1e-9,
                                                  k_max=6)),
            ("SSV2stab", heat_mol(64, 0.1), (0.0, 0.05),
             torch.tensor(heat0, device="cuda"), dict(rtol=1e-4, atol=1e-7)),
            ("CKdisc", vdp, (0.0, 3.0), vdp64, dict(rtol=1e-6, atol=1e-9))]
    for method, fun, span, y0, kw in runs:
        te = np.linspace(span[0], span[1], TRAJ_N_EVAL)

        def run(y=y0):
            return solve_ensemble(fun, span, y, method=method, t_eval=te,
                                  save_steps=True, max_steps=2000, **kw)
        run()                                   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = run(y0.cpu())
        same = {f: torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
                for f in ("status", "nsteps", "nfev", "nfailed")}
        d = _rel(card.y_eval.cpu(), cpu.y_eval)
        print(f"trajectory {method} {TRAJ_FAMILIES} members t in {span}, "
              f"{TRAJ_N_EVAL} t_eval + save_steps: {ms:.1f} ms wall, mean "
              f"nsteps {card.nsteps.double().mean():.1f}; card vs CPU "
              f"counters equal {same}, max |dy_eval| relative {d:.3e} (gate "
              f"{TRAJ_Y_GATE:.0e})")
        check(bool((card.status == 1).all()), f"trajectory {method}: status")
        check(all(same.values()), f"trajectory {method}: counters card/CPU")
        check(d <= TRAJ_Y_GATE, f"trajectory {method}: y_eval card/CPU")


def trajectory_path(y64, ens, final_ms):
    """The main path's line (vdp4096, BS5, f64) with t_eval of 201 points
    and save_steps, with events (y[0]'s zero crossings, and a terminal
    event that stops the members that start above TRAJ_STOP), and in four
    windows: the recorded run's counters equal the final-state run's, its
    last step ends at y, the windows are the single shot bit for bit, and
    sampled members rerun on the CPU agree."""
    from extensisq_tpu_torch import solve_ensemble, solve_windowed
    start = time.perf_counter()
    te = np.linspace(T_SPAN[0], T_SPAN[1], TRAJ_N_EVAL)
    events = [_zero_y0, _stop_y0]

    def recorded(y=y64):
        return solve_ensemble(vdp, T_SPAN, y, method="BS5", t_eval=te,
                              save_steps=True, **TRAJ_TOL)

    def with_events(y=y64):
        return solve_ensemble(vdp, T_SPAN, y, method="BS5", events=events,
                              **TRAJ_TOL)

    def windowed():
        return solve_windowed(vdp, T_SPAN, y64, 4, method="BS5",
                              ensemble=True, **TRAJ_TOL)

    rec_ms = wall_ms(recorded, TRAJ_REPS)
    ev_ms = wall_ms(with_events, TRAJ_REPS)
    win_ms = wall_ms(windowed, TRAJ_REPS)
    rec, ev, win = recorded(), with_events(), windowed()
    print(f"trajectory vdp{N_MEMBERS} BS5 f64 wall: final state "
          f"{final_ms:.1f} ms, t_eval {TRAJ_N_EVAL} + save_steps "
          f"{rec_ms:.1f} ms (record {_record_bytes(rec) / 2**30:.3f} GiB), "
          f"events {ev_ms:.1f} ms, 4 windows {win_ms:.1f} ms")

    # (a) the record: the final-state run's counters and end, ys ends at y
    for f in ("status", "nsteps", "nfev", "nfailed"):
        check(torch.equal(getattr(rec, f), getattr(ens, f)),
              f"trajectory: recorded {f} differs from the final-state run")
    check(torch.equal(rec.y, ens.y), "trajectory: recorded y differs")
    b = torch.arange(N_MEMBERS, device="cuda")
    last = rec.ys[b, rec.nsteps.long() - 1]
    d_last = _rel(last, rec.y)
    check(rec.y_eval.shape == (N_MEMBERS, TRAJ_N_EVAL, 2)
          and bool(torch.isfinite(rec.y_eval).all()), "trajectory: y_eval")
    d_end = _rel(rec.y_eval[:, -1], rec.y)
    print(f"trajectory record: counters equal the final-state run's, ys at "
          f"the last step vs y {d_last:.3e}, y_eval at t = 10 vs y "
          f"{d_end:.3e} (gate {TRAJ_LAST_GATE:.0e})")
    check(max(d_last, d_end) <= TRAJ_LAST_GATE,
          "trajectory: the record does not end at y")

    # (b) events: the terminal one stops some members and not others; the
    # rest take the final-state run's steps
    stopped = ev.status == 8
    n_stop = int(stopped.sum())
    free = ~stopped
    print(f"trajectory events: {n_stop} of {N_MEMBERS} members stopped at "
          f"y[0] = {TRAJ_STOP}, zero crossings per member "
          f"{ev.n_events[:, 0].min().item()}-{ev.n_events[:, 0].max().item()}")
    check(0 < n_stop < N_MEMBERS, "trajectory: the terminal event stopped "
          "all members or none")
    check(bool((ev.status[free] == 1).all()) and bool(
        (ev.t[stopped] < T_SPAN[1]).all()), "trajectory: event status")
    for f in ("nsteps", "nfev", "nfailed"):
        check(torch.equal(getattr(ev, f)[free], getattr(ens, f)[free]),
              f"trajectory: events changed {f} of a free member")
    check(torch.equal(ev.y[free], ens.y[free]),
          "trajectory: events changed y of a free member")
    y_stop = ev.y_events[stopped, 1, 0, 0]
    check(bool(((y_stop - TRAJ_STOP).abs() < 1e-9).all()),
          "trajectory: terminal states off the event level")

    # (c) four windows, bit for bit the single shot
    for f in ("t", "y", "status", "nsteps", "nfev", "nfailed"):
        check(torch.equal(getattr(win, f), getattr(ens, f)),
              f"trajectory: windowed {f} differs from the single shot")
    print("trajectory windows: 4 windows bit-identical to the single shot "
          "(t, y, status, nsteps, nfev, nfailed)")

    # (d) sampled members on the CPU, stopped ones among them
    idx = torch.cat([torch.linspace(0, N_MEMBERS - 1, TRAJ_CPU_MEMBERS
                                    - 8, device="cuda").long(),
                     stopped.nonzero()[:8, 0]])
    rec_cpu = recorded(y64[idx].cpu())
    ev_cpu = with_events(y64[idx].cpu())
    same = all(torch.equal(getattr(r, f)[idx].cpu(), getattr(c, f))
               for r, c in ((rec, rec_cpu), (ev, ev_cpu))
               for f in ("status", "nsteps", "nfev", "nfailed"))
    same = same and torch.equal(ev.n_events[idx].cpu(), ev_cpu.n_events)
    d_eval = _rel(rec.y_eval[idx].cpu(), rec_cpu.y_eval)
    t_card, t_cpu = ev.t_events[idx].cpu(), ev_cpu.t_events
    nan_same = torch.equal(t_card.isnan(), t_cpu.isnan())
    ok = ~t_cpu.isnan()
    d_t = (t_card[ok] - t_cpu[ok]).abs().max().item()
    print(f"trajectory card vs CPU on {len(idx)} members: counters and "
          f"n_events equal {same}, max |dy_eval| relative {d_eval:.3e} (gate "
          f"{TRAJ_Y_GATE:.0e}), max |dt_event| {d_t:.3e} (gate "
          f"{TRAJ_T_GATE:.0e})")
    check(same and nan_same, "trajectory: card and CPU counters differ")
    check(d_eval <= TRAJ_Y_GATE and d_t <= TRAJ_T_GATE,
          "trajectory: card and CPU disagree")
    line_s = time.perf_counter() - start
    trajectory_family_runs()
    print(f"trajectory phase: {time.perf_counter() - start:.1f} s (the "
          f"vdp{N_MEMBERS} line {line_s:.1f} s)")


# the banded and complex phase: config 8 (Medazko, banded against dense
# ESDIRK linear algebra), a banded ensemble, RCM, and complex states
CONFIG8_N = (256, 512, 1024)          # N of Medazko: n = 2N states
CONFIG8_SPAN = (0.0, 20.0)
CONFIG8_TOL = dict(rtol=1e-3, atol=1e-6, max_steps=400)
CONFIG8_DY_GATE = 1e-5                # banded vs dense endpoint (config 8)
BAND_ENS = 16                         # members of the banded ensemble
BAND_ENS_N = 256
# the ensemble against its 16 single solves: t in [0, 1], 19 of config
# 8's 58 steps at n = 512 (the whole span: ~120 s of singles, run CJ)
BAND_ENS_SPAN = (0.0, 1.0)
CPLX_MEMBERS = 64
CPLX_TOL = dict(rtol=1e-6, atol=1e-9)
CPLX_TOL_IMPLICIT = dict(rtol=1e-4, atol=1e-7)   # TRBDF2: ~49 steps
CPLX_GATE = 1e-10                     # card vs CPU, relative to max(1, |y|)
CPLX_A = np.array([[-1.0 + 2.0j, 0.5], [0.1j, -3.0]])


def _cplx_nonlinear(t, y):
    return torch.stack([(-1.0 + 3.0j) * y[0] + 0.3j * y[1] ** 2,
                        -(1 + 0.5j) * y[1] + torch.sin(y[0])])


def _cplx_linear(t, y):
    return torch.as_tensor(CPLX_A, device=y.device) @ y


def _relabelled_chain(n=60, seed=3):
    """The irregular pattern of the JAX package's RCM test: a diffusion
    chain with its states randomly relabelled (natural bandwidths ~n)."""
    rng = np.random.RandomState(seed)
    sig = np.asarray(rng.permutation(n))
    pos = np.argsort(sig)
    lam = 1.0 + np.linspace(0.0, 1.0, n)
    Sc = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 1

    def rhs(t, y):
        w = y[torch.as_tensor(sig, device=y.device)]
        left = torch.cat([w[:1], w[:-1]])
        right = torch.cat([w[1:], w[-1:]])
        gw = (30.0 * (left - 2.0 * w + right)
              - torch.as_tensor(lam, device=y.device)[:, None] * w)
        return gw[torch.as_tensor(pos, device=y.device)]

    return rhs, Sc[np.ix_(pos, pos)].astype(int), \
        1.0 + 0.1 * np.sin(np.arange(n))


def _counts(sol):
    st = sol.final_state
    out = {f: getattr(sol, f).reshape(-1).cpu() for f in
           ("status", "nsteps", "nfev", "nfailed")}
    if st is not None:
        out.update(njev=st.njev.cpu(), nlu=st.nlu.cpu())
    return out


def config8_lines():
    """Config 8: Medazko at n = 512, 1,024 and 2,048 through ``solve``
    with KC4I and its pattern, banded (``bands=True``, block cyclic
    reduction) and dense (cuSOLVER's LU); each warm wall time printed."""
    from extensisq_tpu_torch import KC4I, solve
    from extensisq_tpu_torch.problems import medazko
    times = {}
    for N in CONFIG8_N:
        P = medazko(N)
        n = 2 * N
        y0 = torch.tensor(P.y0, device="cuda")

        def run(span=CONFIG8_SPAN, **kw):
            return solve(P.rhs, span, y0, method=KC4I,
                         jac_sparsity=P.jac_sparsity, return_state=True,
                         **CONFIG8_TOL, **kw)
        out = {}
        for label, kw in (("banded", dict(bands=True)), ("dense", {})):
            if N == CONFIG8_N[0]:
                run((0.0, 0.5), **kw)                  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[label] = run(**kw)
            torch.cuda.synchronize()
            times[(n, label)] = time.perf_counter() - t0
        rb, rd = out["banded"], out["dense"]
        cb, cd = _counts(rb), _counts(rd)
        ds = abs(int(rb.nsteps) - int(rd.nsteps))
        dy = (rb.y - rd.y).abs().max().item()
        print(f"config 8 Medazko n={n} KC4I t in {CONFIG8_SPAN}: banded "
              f"{times[(n, 'banded')]:.3f} s, dense "
              f"{times[(n, 'dense')]:.3f} s (dense/banded "
              f"{times[(n, 'dense')] / times[(n, 'banded')]:.2f}x); "
              f"banded {({k: int(v) for k, v in cb.items()})}, dense "
              f"{({k: int(v) for k, v in cd.items()})}; endpoint |dy| "
              f"{dy:.3e} (gate {CONFIG8_DY_GATE:.0e})")
        check(int(rb.status) == 1 and int(rd.status) == 1,
              f"config 8 n={n}: status")
        check(ds <= (0 if n <= 512 else 1), f"config 8 n={n}: step drift "
              f"{ds}")
        check(dy < CONFIG8_DY_GATE, f"config 8 n={n}: endpoint {dy}")
    return times


def banded_ensemble_and_cpu():
    """A 16-member banded ensemble at n = 512 (y0 scaled per member)
    against 16 single solves on t in [0, 1]; RCM on an irregular pattern
    against the dense path; one member rerun on the CPU."""
    from extensisq_tpu_torch import KC4I, TRBDF2, solve, solve_ensemble
    from extensisq_tpu_torch.problems import medazko
    P = medazko(BAND_ENS_N)
    scales = np.linspace(0.8, 1.2, BAND_ENS)
    Y0 = torch.tensor(scales[:, None] * P.y0[None], device="cuda")
    kw = dict(method=KC4I, bands=True, jac_sparsity=P.jac_sparsity,
              **CONFIG8_TOL)
    t0 = time.perf_counter()
    ens = solve_ensemble(P.rhs, BAND_ENS_SPAN, Y0, **kw)
    torch.cuda.synchronize()
    ens_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [solve(P.rhs, BAND_ENS_SPAN, Y0[i], **kw)
               for i in range(BAND_ENS)]
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    same = all(int(getattr(one, f)) == int(getattr(ens, f)[i])
               for i, one in enumerate(singles)
               for f in ("status", "nsteps", "nfev", "nfailed"))
    dy = max((one.y - ens.y[i]).abs().max().item()
             for i, one in enumerate(singles))
    print(f"banded ensemble {BAND_ENS} x n={2 * BAND_ENS_N} KC4I t in "
          f"{BAND_ENS_SPAN}: "
          f"{ens_s:.3f} s, {BAND_ENS} single solves {one_s:.3f} s; counters "
          f"equal {same}, max |dy| {dy:.3e} (gate {CONFIG8_DY_GATE:.0e}), "
          f"nsteps {ens.nsteps.min().item()}-{ens.nsteps.max().item()}")
    check(bool((ens.status == 1).all()), "banded ensemble: status")
    check(same and dy < CONFIG8_DY_GATE,
          "banded ensemble differs from its single solves")

    rhs, S, y0 = _relabelled_chain()
    y0 = torch.tensor(y0, device="cuda")
    runs = [solve(rhs, (0.0, 0.5), y0, method=TRBDF2, return_state=True,
                  **opt) for opt in (dict(bands="rcm", jac_sparsity=S), {})]
    cr, cd = (_counts(r) for r in runs)
    dy = (runs[0].y - runs[1].y).abs().max().item()
    same = all(torch.equal(cr[f], cd[f]) for f in cr)
    print(f"bands='rcm' on the relabelled chain (n = 60): counters equal "
          f"the dense path's {same} ({({k: int(v) for k, v in cr.items()})})"
          f", |dy| {dy:.3e}")
    check(int(runs[0].status) == 1 and same and dy < 1e-9,
          "bands='rcm' differs from the dense path")

    i = BAND_ENS // 3
    cpu = solve(P.rhs, BAND_ENS_SPAN, Y0[i].cpu(), **kw)
    ds = abs(int(cpu.nsteps) - int(ens.nsteps[i]))
    dy = (cpu.y - ens.y[i].cpu()).abs().max().item()
    print(f"banded member {i} on the CPU: nsteps {int(cpu.nsteps)} vs card "
          f"{int(ens.nsteps[i])}, nfev {int(cpu.nfev)} vs "
          f"{int(ens.nfev[i])}, |dy| {dy:.3e} (gates: steps within 1, "
          f"{CONFIG8_DY_GATE:.0e})")
    check(int(cpu.status) == 1 and ds <= 1 and dy < CONFIG8_DY_GATE,
          "banded member: card and CPU disagree")
    return ens_s, one_s


def complex_runs():
    """BS5, TRBDF2 with a callable complex Jacobian, and SWAG on a
    64-member complex128 ensemble, each rerun on the CPU."""
    from extensisq_tpu_torch import solve_ensemble
    rng = np.random.default_rng(17)
    y0 = torch.tensor((rng.standard_normal((CPLX_MEMBERS, 2))
                       + 1j * rng.standard_normal((CPLX_MEMBERS, 2))) * 0.5,
                      device="cuda")
    jac = (lambda t, y: torch.as_tensor(CPLX_A, device=y.device))  # noqa
    runs = [("BS5", _cplx_nonlinear, CPLX_TOL),
            ("TRBDF2", _cplx_linear, dict(CPLX_TOL_IMPLICIT, jac=jac)),
            ("SWAG", _cplx_nonlinear, dict(CPLX_TOL, k_max=6))]
    for method, fun, kw in runs:
        def run(y=y0):
            return solve_ensemble(fun, (0.0, 2.0), y, method=method, **kw)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = run(y0.cpu())
        same = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
                   for f in ("status", "nsteps", "nfev", "nfailed"))
        d = _rel(card.y.cpu(), cpu.y)
        print(f"complex128 {method} {CPLX_MEMBERS} members: {ms:.1f} ms "
              f"wall, mean nsteps {card.nsteps.double().mean():.1f}; card vs "
              f"CPU counters equal {same}, max |dy| relative {d:.3e} (gate "
              f"{CPLX_GATE:.0e})")
        check(card.y.dtype == torch.complex128
              and bool((card.status == 1).all()), f"complex {method}: status")
        check(same and d <= CPLX_GATE, f"complex {method}: card and CPU "
              "disagree")


def banded_complex_path(smi):
    """Config 8 on the card, a banded ensemble and RCM, and complex
    states; prints the phase's time."""
    start = time.perf_counter()
    print(f"config 8 on {smi.splitlines()[0]}")
    config8_lines()
    banded_ensemble_and_cpu()
    complex_runs()
    print(f"banded and complex phase: {time.perf_counter() - start:.1f} s")


# -- the host driver, the sensitivities and the front door --------------------
# solve_ivp on the card (a numpy y0) against the same call on CPU tensors:
# equal counters and status, t, y and the events within 1e-9 relative to
# max(1, |y|).  One member's state is an (n, 1) column, whose norm the card
# sums as a contiguous reduction in another order than the CPU, and the
# card's f64 pow differs in the last bit (ROADMAP C); measured on an H100,
# where a problem amplifies those bits the gate is looser: Pleiades' close
# encounters 1.3e-7 (gate 1e-6), Kepler 1.6e-9 and the CKdisc decay 1.0e-9
# (gates 1e-8).  The decay takes a first step: without it, h_start's pow
# parts the cascade's choices at the switches (77 steps on the card, 79 on
# the CPU)
# -- the fused sensitivities (configs 7a and 7b) --------------------------
SENS_ROB_N = 512
SENS_ROB_SPAN = (0.0, 0.4)
SENS_ROB_TOL = dict(rtol=1e-4, atol=1e-8)
SENS_VDP_N = 1024
SENS_VDP_SPAN = (0.0, 3.0)
SENS_VDP_TOL = dict(rtol=1e-5, atol=1e-8)
SENS_FD_TOL = dict(rtol=1e-6, atol=1e-9)
SENS_FD_EPS = 1e-2
# JAX's gates (validation/benchmarks.py:825-835, 858-869): member 0 of 7a
# against the CVODES table, y_f within 5e-4 relative and each dy/dp_j
# column, scaled by its largest entry, within 2e-2; 7b's dL/dmu within
# 5e-3 of central differences of B1 with params
SENS_CVODES_RTOL = 5e-4
SENS_CVODES_SCALED = 2e-2
SENS_FD_GATE = 5e-3
CVODES_YF = np.array([9.8517e-01, 3.3864e-05, 1.4794e-02])
CVODES_SENS = np.array([[-3.5595e-01, 9.5428e-08, -1.5832e-11],
                        [3.9026e-04, -2.1310e-10, -5.2900e-13],
                        [3.5556e-01, -9.5215e-08, 1.6361e-11]])
# kernel against its plain version on the card: (max |dy|, relative
# difference of mean nsteps, max |dnsteps|) of each check, and for 7a the
# largest difference of a dy/dp_j column over its largest entry.  Measured
# on an H100 (tools/probe_sens.py): vdp params 2.2e-4, 3.8e-4, 1; vdp
# variational 4.8e-4, 0, 1; stiff params 3.2e-6, 0, 0; robertson
# variational 1.6e-5, 0, 0 and 4.5e-4 scaled.  The gates allow 3-5x
SENS_KERNEL_GATES = {"vdp params": (1e-3, 2e-3, 2),
                     "vdp variational": (2e-3, 2e-3, 2),
                     "stiff params": (1e-5, 2e-3, 1),
                     "robertson variational": (5e-5, 2e-3, 1)}
SENS_SCALED_GATE = 2e-3
# float32 operations per Newton evaluation of the variational Robertson
# system (n = 3, k = 3: 12 rows) in B2, counted from the source as the
# work each row needs (SG_RHS_OPS' rule: an addition, subtraction or
# multiplication one, a negation and a product with a seed of 1 or 0
# none): the base rows (8) and the three tangent blocks, each the tangent
# of the rates and of the rows at the block's seed (12: 36), the
# blockwise replay of the 3 x 3 factor over four blocks (15 each: 60),
# and per row the point psi + d z (2), the update's right-hand side h f -
# z (2), its scaled norm (6) and the update (1) (132).  The attempt's
# base Jacobian and factor are left out, so the count is a lower bound
SENS_ESDIRK_OPS = 236
# the variational Van der Pol system of 7b (k = 1 and the 2 initial
# condition blocks: 8 rows), per element of a stage row: the base rows (5)
# and three tangent blocks (8 each, and the seeded mu's 1), as the work
# each row needs
SENS_VDP_AUG_RHS_OPS = 30 / 8

VDP_P_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = y[1];
  dy[1] = p[0] * (1.0f - y[0] * y[0]) * y[1] - y[0];
}
"""
ROB_P_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  const T r1 = p[0] * y[0];
  const T r2 = p[1] * y[1] * y[2];
  const T r3 = p[2] * y[1] * y[1];
  dy[0] = -r1 + r2;
  dy[1] = r1 - r2 - r3;
  dy[2] = r3;
}
"""
STIFF_P_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = -p[0] * (y[0] - cos(t));
}
"""


def vdp_p(t, y, p):
    return torch.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]])


def robertson_p(t, y, p):
    r1 = p[0] * y[0]
    r2 = p[1] * y[1] * y[2]
    r3 = p[2] * y[1] * y[1]
    return torch.stack([-r1 + r2, r1 - r2 - r3, r3])


def stiff_p(t, y, p):
    return torch.stack([-p[0] * (y[0] - torch.cos(t))])


def sens_rhs():
    """The sensitivity phase's right-hand sides (FusedRHS with their
    parameter counts) and the variational systems solve_fused_sens builds
    from them: 7b's backward (k = 1 with the initial-condition blocks) and
    7a's (k = 3)."""
    from extensisq_tpu_torch.ops import FusedRHS
    from extensisq_tpu_torch.ops.fused_sens import _aug_rhs
    vdp = FusedRHS(vdp_p, VDP_P_CUDA, 2, 1)
    rob = FusedRHS(robertson_p, ROB_P_CUDA, 3, 3)
    return {"vdp": vdp, "rob": rob,
            "stiff": FusedRHS(stiff_p, STIFF_P_CUDA, 1, 1),
            "vdp_aug": _aug_rhs(vdp, 2, 1, 2),
            "rob_aug": _aug_rhs(rob, 3, 3, 0)}


def sens_builds(rhs):
    """(kernel, label, FusedRHS, options) of the phase's variants."""
    from extensisq_tpu_torch import Kv3I, TRBDF2
    return [("fused_erk", "vdp params", rhs["vdp"], None),
            ("fused_erk", "vdp variational", rhs["vdp_aug"], None),
            ("fused_esdirk", "stiff params Kv3I", rhs["stiff"],
             (Kv3I, None)),
            ("fused_esdirk", "robertson variational TRBDF2 block_base 3",
             rhs["rob_aug"], (TRBDF2, None, 3))]


def sens_inputs():
    """7a's 512 Robertson members (k1 in [0.04, 0.05], member 0 at the
    nominal values) and 7b's 1,024 Van der Pol members (mu in [1, 2],
    y0 = (2, 0)) on the card, with the initial states of their variational
    systems as solve_fused_sens builds them: ``(y0a, pa, Ya, y0b, mus,
    Yb)``."""
    y0a = torch.tensor([[1.0, 0.0, 0.0]], device="cuda").repeat(
        SENS_ROB_N, 1)
    pa = np.tile([0.04, 1e4, 3e7], (SENS_ROB_N, 1)).astype(np.float32)
    pa[:, 0] = np.linspace(0.04, 0.05, SENS_ROB_N)
    pa[0, 0] = 0.04
    y0b = torch.zeros(SENS_VDP_N, 2, device="cuda")
    y0b[:, 0] = 2.0
    mus = np.linspace(1.0, 2.0, SENS_VDP_N).astype(np.float32)[:, None]
    Ya = torch.cat([y0a, torch.zeros(SENS_ROB_N, 9, device="cuda")], 1)
    Yb = torch.cat([y0b, torch.zeros_like(y0b),
                    torch.eye(2, device="cuda").reshape(1, 4).repeat(
                        SENS_VDP_N, 1)], 1)
    return (y0a, torch.tensor(pa, device="cuda"), Ya, y0b,
            torch.tensor(mus, device="cuda"), Yb)


def sens_kernel_checks(R, y0a, pa, ya_aug, y0b, mus, yb_aug):
    """B1 and B2 with params, B1 on 7b's variational system and B2's
    simultaneous corrector on 7a's, each against its plain version on the
    card at the phase's sizes, and each bit for bit against the other body
    (one thread per member, or a lane group).  Returns the largest |dy| of
    the B1 and of the B2 checks."""
    from extensisq_tpu_torch import BS5, Kv3I, TRBDF2
    from extensisq_tpu_torch.ops import (fused_erk_reference,
                                         fused_esdirk_reference,
                                         solve_fused_erk, solve_fused_esdirk)
    ks = torch.linspace(50.0, 500.0, SENS_VDP_N, device="cuda")[:, None]
    y0s = torch.zeros(SENS_VDP_N, 1, device="cuda")
    erk = [("vdp params", R["vdp"], y0b, mus),
           ("vdp variational", R["vdp_aug"], yb_aug, mus)]
    errs = {"fused_erk": 0.0, "fused_esdirk": 0.0}
    for label, rhs, y0, par in erk:
        kw = dict(method=BS5, params=par, **SENS_VDP_TOL)
        k, _, dy, _ = hold_against_plain(
            "sens", label,
            lambda: solve_fused_erk(rhs, SENS_VDP_SPAN, y0, **kw),
            lambda: fused_erk_reference(rhs, SENS_VDP_SPAN, y0, **kw),
            *SENS_KERNEL_GATES[label])
        hold_small_lanes("fused_erk", label, rhs, SENS_VDP_SPAN, y0, kw, k,
                         solve_fused_erk.last_shape)
        errs["fused_erk"] = max(errs["fused_erk"], dy)
    esd = [("stiff params", R["stiff"], (0.0, 1.0), y0s, ks,
            dict(method=Kv3I, rtol=1e-4, atol=1e-6)),
           ("robertson variational", R["rob_aug"], SENS_ROB_SPAN, ya_aug,
            pa, dict(method=TRBDF2, block_base=3, **SENS_ROB_TOL))]
    for label, rhs, span, y0, par, kw in esd:
        kw = dict(kw, params=par)
        k, r, dy, _ = hold_against_plain(
            "sens", label,
            lambda: solve_fused_esdirk(rhs, span, y0, **kw),
            lambda: fused_esdirk_reference(rhs, span, y0, **kw),
            *SENS_KERNEL_GATES[label])
        shape = solve_fused_esdirk.last_shape
        other = 1 if shape[0] > 1 else 4
        same = all(torch.equal(a, b) for a, b in zip(
            k, _launch_esdirk(rhs, span, y0, kw, other)[0]))
        print(f"esdirk [{label}, {y0.shape[0]}]: "
              f"{shape_text(solve_fused_esdirk, y0.shape[0])}; {other} "
              f"lanes bit-identical {same}")
        check(same, f"esdirk {label}: the lane body and the other differ")
        errs["fused_esdirk"] = max(errs["fused_esdirk"], dy)
        if label == "robertson variational":
            S_k = k[0][:, 3:].reshape(-1, 3, 3)
            S_r = r[0][:, 3:].reshape(-1, 3, 3)
            scaled = ((S_k - S_r).abs().amax((0, 2))
                      / S_r.abs().amax((0, 2))).max().item()
            print(f"sens [{label}]: kernel vs plain, largest dy/dp_j "
                  f"column difference over its largest entry {scaled:.3e} "
                  f"(gate {SENS_SCALED_GATE:.0e})")
            check(scaled <= SENS_SCALED_GATE,
                  f"{label}: scaled sensitivities differ by {scaled}")
    return errs


def sens_path():
    """Configs 7a and 7b on the card: the kernel checks, 7a's 512-member
    stiff forward sensitivities through B2's simultaneous corrector at the
    CVODES gates, and 7b's gradient of a 1,024-member Van der Pol sweep
    through solve_fused_final (two B1 launches) against central
    differences; the lines' warm walls, the kernels' device ms and the
    plain versions' walls.  Returns the ``kernels`` keys of B1 and B2."""
    from extensisq_tpu_torch import BS5, TRBDF2
    from extensisq_tpu_torch.ops import (fused_erk_reference,
                                         fused_esdirk_reference,
                                         solve_fused_erk, solve_fused_esdirk,
                                         solve_fused_final, solve_fused_sens)
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    start = time.perf_counter()
    R = sens_rhs()
    y0a, pa, Ya, y0b, mus, Yb = sens_inputs()
    errs = sens_kernel_checks(R, y0a, pa, Ya, y0b, mus, Yb)

    # 7a: one launch of B2 in block_base mode for all 512 members
    solve_fused_erk.launches = 0
    solve_fused_esdirk.launches = 0
    t0 = time.perf_counter()
    yf, Sp, Sy0, st, ns, nf = solve_fused_sens(
        R["rob"], SENS_ROB_SPAN, y0a, params=pa, method=TRBDF2,
        **SENS_ROB_TOL)
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    la = (solve_fused_erk.launches, solve_fused_esdirk.launches)
    check(la == (0, 1), f"7a: launches (B1, B2) {la}, expected (0, 1)")
    check(bool((st == 1).all()), "7a: not every member finished")
    check(Sp.shape == (SENS_ROB_N, 3, 3) and Sy0 is None
          and bool(torch.isfinite(Sp).all()), "7a: bad sensitivities")
    y_0 = yf[0].double().cpu().numpy()
    S_0 = Sp[0].double().cpu().numpy()
    d_yf = np.max(np.abs(y_0 - CVODES_YF) / np.abs(CVODES_YF))
    sc = np.abs(CVODES_SENS).max(0)
    d_S = np.max(np.abs(S_0 - CVODES_SENS) / sc)
    print(f"7a Robertson x{SENS_ROB_N} (TRBDF2, 3 params, block_base 3): "
          f"{a_s * 1e3:.1f} ms first call, launches (B1, B2) {la}, mean "
          f"nsteps {ns.double().mean():.2f}, max {int(ns.max())}; member 0 "
          f"vs CVODES: y_f rel {d_yf:.3e} (gate {SENS_CVODES_RTOL:.0e}), "
          f"scaled S {d_S:.3e} (gate {SENS_CVODES_SCALED:.0e})")
    check(d_yf <= SENS_CVODES_RTOL, "7a: y_f off the CVODES table")
    check(d_S <= SENS_CVODES_SCALED, "7a: S off the CVODES table")

    # 7b: the value and gradient of a 1,024-member sweep, two B1 launches
    def grad_7b():
        P = mus.clone().requires_grad_(True)
        out = solve_fused_final(R["vdp"], SENS_VDP_SPAN, y0b, P, BS5,
                                **SENS_VDP_TOL)
        val = out[:, 0].sum()
        g, = torch.autograd.grad(val, P)
        return val.detach(), g

    solve_fused_erk.launches = 0
    solve_fused_esdirk.launches = 0
    t0 = time.perf_counter()
    val, g = grad_7b()
    torch.cuda.synchronize()
    b_s = time.perf_counter() - t0
    lb = (solve_fused_erk.launches, solve_fused_esdirk.launches)
    check(lb == (2, 0), f"7b: launches (B1, B2) {lb}, expected (2, 0)")
    check(bool(torch.isfinite(g).all()), "7b: non-finite gradient")
    kw = dict(method=BS5, **SENS_FD_TOL)
    yp = solve_fused_erk(R["vdp"], SENS_VDP_SPAN, y0b,
                         params=mus + SENS_FD_EPS, **kw)
    ym = solve_fused_erk(R["vdp"], SENS_VDP_SPAN, y0b,
                         params=mus - SENS_FD_EPS, **kw)
    check(bool((yp[1] == 1).all() and (ym[1] == 1).all()),
          "7b: a central-difference run did not finish")
    fd = (yp[0][:, 0] - ym[0][:, 0]) / (2 * SENS_FD_EPS)
    d_fd = (g[:, 0] - fd).abs().max().item()
    print(f"7b value_and_grad VdP x{SENS_VDP_N} (BS5, 2 launches): "
          f"{b_s * 1e3:.1f} ms first call, launches (B1, B2) {lb}, loss "
          f"{float(val):.6f}; dL/dmu vs central differences (eps "
          f"{SENS_FD_EPS:.0e}) max |d| {d_fd:.3e} (gate {SENS_FD_GATE:.0e})")
    check(d_fd <= SENS_FD_GATE, "7b: gradient off central differences")

    # times: warm walls of the two lines, the kernels' device time and the
    # plain versions' walls (one warm run each)
    kwa = dict(method=TRBDF2, params=pa, block_base=3, **SENS_ROB_TOL)
    kwb = dict(method=BS5, params=mus, **SENS_VDP_TOL)
    a_ms = wall_ms(lambda: solve_fused_sens(
        R["rob"], SENS_ROB_SPAN, y0a, params=pa, method=TRBDF2,
        **SENS_ROB_TOL), reps=3)
    b_ms = wall_ms(grad_7b, reps=3)
    a_dev = event_ms(lambda: solve_fused_esdirk(R["rob_aug"], SENS_ROB_SPAN,
                                                Ya, **kwa))
    b_fwd = event_ms(lambda: solve_fused_erk(R["vdp"], SENS_VDP_SPAN, y0b,
                                             **kwb))
    b_bwd = event_ms(lambda: solve_fused_erk(R["vdp_aug"], SENS_VDP_SPAN, Yb,
                                             **kwb))
    a_plain = wall_ms(lambda: fused_esdirk_reference(
        R["rob_aug"], SENS_ROB_SPAN, Ya, **kwa), reps=1)
    b_plain = wall_ms(lambda: (
        fused_erk_reference(R["vdp"], SENS_VDP_SPAN, y0b, **kwb),
        fused_erk_reference(R["vdp_aug"], SENS_VDP_SPAN, Yb, **kwb)), reps=1)
    print(f"time [7a, B2 block_base 3] {SENS_ROB_N} members: "
          f"{a_ms:.3f} ms wall (solve_fused_sens), {a_dev:.4f} ms device "
          f"(CUDA events, the launch), plain version {a_plain:.1f} ms wall")
    print(f"time [7b, two B1 launches] {SENS_VDP_N} members: {b_ms:.3f} ms "
          f"wall (value and gradient), device {b_fwd:.4f} ms forward + "
          f"{b_bwd:.4f} ms backward (CUDA events), plain versions "
          f"{b_plain:.1f} ms wall")

    # bounds: the states in and out once, the params once; operations from
    # this run's evaluations
    fwd = solve_fused_erk(R["vdp"], SENS_VDP_SPAN, y0b, **kwb)
    bwd = solve_fused_erk(R["vdp_aug"], SENS_VDP_SPAN, Yb, **kwb)
    k_bs5 = _fused_consts(BS5)
    start_b = 2 + min(2 + 1, 3)
    ops_b = (rk_ops(k_bs5, False, 2, RHS_OPS["vdp"], int(fwd[3].sum()),
                    SENS_VDP_N, start_b)
             + rk_ops(k_bs5, False, 8, SENS_VDP_AUG_RHS_OPS,
                      int(bwd[3].sum()), SENS_VDP_N, 2 + min(8 + 1, 3)))
    bound_b = bound_entry(SENS_VDP_N * 4 * (2 * 2 + 2 * 8 + 2 + 2 * 3),
                          ops_b)
    bound_a = bound_entry(SENS_ROB_N * 4 * (2 * 12 + 3 + 3),
                          int(nf.sum()) * SENS_ESDIRK_OPS)
    print(f"sensitivity phase: {time.perf_counter() - start:.1f} s")
    return ({"launches_7b": lb[0], "max_abs_err_params": errs["fused_erk"],
             "ms_7b": b_ms, "device_ms_7b": b_fwd + b_bwd,
             "plain_ms_7b": b_plain, "bound_ms_7b": bound_b["bound_ms"],
             "bound_by_7b": bound_b["bound_by"]},
            {"launches_7a": la[1],
             "max_abs_err_block_base": errs["fused_esdirk"],
             "ms_7a": a_ms, "device_ms_7a": a_dev, "plain_ms_7a": a_plain,
             "bound_ms_7a": bound_a["bound_ms"],
             "bound_by_7a": bound_a["bound_by"]})


# -- the fused sensitivities on the grid layout (configs 1b and 4d) ----------
# B4 with params and on a variational system at config 1b's width (JAX's
# Fisher grid case at n = 256, 64 members), B7 with params and its
# simultaneous corrector (block_base) at config 4d's (JAX's reaction-
# diffusion grid case at n = 128, 32 members): tests/test_fused_sens.py
# :261-291 and :320-366 at those widths
SG_FIS_N, SG_FIS_M, SG_FIS_SPAN = 256, 64, (0.0, 0.25)
SG_FIS_TOL = dict(rtol=1e-5, atol=1e-8)
# the central differences' B4 runs: JAX's eps, 4e-3, but at rtol 1e-8 /
# atol 1e-11 in the compensated mode.  At n = 256 the JAX test's plain
# rtol 1e-7 / atol 1e-10 leaves the quotient noisy: on 4 members (CPU,
# plain versions) it parted from S_p by 9.6e-3 of max |FD| (7.0e-3
# compensated), while S_p at rtol 1e-5 and 1e-7 agree to 4.5e-5 and the
# tighter quotient meets S_p to 3.9e-4
SG_FD_TOL = dict(rtol=1e-8, atol=1e-11, compensated=True)
SG_FD_EPS = 4e-3
SG_RD_N, SG_RD_M, SG_RD_SPAN = 128, 32, (0.0, 0.04)
SG_RD_TOL = dict(rtol=1e-5, atol=1e-8)
SG_F64_TOL = dict(rtol=1e-9, atol=1e-12)
# JAX's gates: S_p within 6e-3 of the largest |FD| (Fisher); members 0 and
# 31 against the f64 sens_forward, |dy| 2e-5 and each dy/dp_j within 3e-3
# of its largest entry (the reaction-diffusion)
SG_FD_GATE = 6e-3
SG_F64_Y_GATE = 2e-5
SG_F64_S_GATE = 3e-3
# kernel against its plain version on the card: (max |dy|, relative
# difference of mean nsteps, max |dnsteps|).  Measured on an H100
# (tools/probe_sens.py --grid), the rule's shape / the warp: fisher params
# 8.3e-5 / 7.1e-5, 0, 0; fisher variational 1.6e-5 / 2.6e-5, 0, 0 (2 / 5
# members one rejected attempt apart in nfev); rd params 3.6e-7, 0, 0; rd
# variational (block_base) 3.6e-7, 0, 0.  The gates allow 3-5x
SG_KERNEL_GATES = {"fisher params": (3e-4, 2e-3, 1),
                   "fisher variational": (1e-4, 2e-3, 1),
                   "rd params": (2e-6, 2e-3, 1),
                   "rd variational": (2e-6, 2e-3, 1)}
# float32 operations per element of a right-hand side evaluation, counted
# from the sources as the work the function needs: an addition,
# subtraction or multiplication one, a negation and a product with a seed
# of 1 or 0 none.  Fisher: its stencil and logistic term (6); a row of its
# tangent block, the tangent on (y, s) with p seeded (8) and the two
# intermediates that reads, p y and 1 - y (10).  The reaction-diffusion
# (7); a row of the tangent block of k (7, and y - 1: 8) and of D (7, and
# the stencil sum: 10); a row of a band pass, the tangent on the base
# block at fixed p (6), needed in the 3 of the 4 striped passes whose
# seeds touch its neighbours (its tangent is 0 in the fourth)
SG_RHS_OPS = {"fisher": 6, "fisher_tangent": 10, "rd": 7,
              "rd_tangent_k": 8, "rd_tangent_d": 10, "rd_band": 6}


def fisher_p(n):
    return lambda t, y, p: (-(y - torch.roll(y, 1, 0)) * float(n)
                            + p[0] * y * (1.0 - y))


def _fisher_p_cuda(n):
    return ("template <class T, class V>\n"
            "__device__ T rhs(T t, V y, int i, const T* p) {\n"
            f"  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {_lit(n)}\n"
            "         + p[0] * y[i] * (1.0f - y[i]);\n}")


def rd_p(t, y, p):
    left = torch.cat([y[:1], y[:-1]])
    right = torch.cat([y[1:], y[-1:]])
    return (left - 2.0 * y + right) * p[1] - p[0] * (y - 1.0)


def rd_1(t, y, k, D):
    """One member of ``rd_p`` for the f64 ``sens_forward``."""
    return rd_p(t, y, (k, D))


def _rd_p_cuda(n):
    return ("template <class T, class V>\n"
            "__device__ T rhs(T t, V y, int i, const T* p) {\n"
            "  const T left = y[i > 0 ? i - 1 : 0];\n"
            f"  const T right = y[i < {n - 1} ? i + 1 : {n - 1}];\n"
            "  return (left - 2.0f * y[i] + right) * p[1]"
            " - p[0] * (y[i] - 1.0f);\n}")


def sens_grid_rhs():
    """The grid phase's right-hand sides (FusedGridRHS with their parameter
    counts) and the variational systems solve_fused_sens(layout="grid")
    builds from them."""
    from extensisq_tpu_torch.ops import FusedGridRHS
    from extensisq_tpu_torch.ops.fused_sens import _aug_grid_rhs
    fis = FusedGridRHS(fisher_p(SG_FIS_N), _fisher_p_cuda(SG_FIS_N),
                       (SG_FIS_N,), 1)
    rd = FusedGridRHS(rd_p, _rd_p_cuda(SG_RD_N), (SG_RD_N,), 2)
    return {"fisher": fis, "rd": rd,
            "fisher_aug": _aug_grid_rhs(fis, SG_FIS_N, 1),
            "rd_aug": _aug_grid_rhs(rd, SG_RD_N, 2)}


def sens_grid_builds(rhs):
    """(kernel, label, FusedGridRHS, options) of the grid phase's
    variants."""
    from extensisq_tpu_torch import BS5, TRBDF2
    return [("fused_erk_grid", "fisher params", rhs["fisher"], BS5),
            ("fused_erk_grid", "fisher variational", rhs["fisher_aug"], BS5),
            ("fused_esdirk_grid", "rd params TRBDF2", rhs["rd"],
             (TRBDF2, None)),
            ("fused_esdirk_grid", f"rd variational TRBDF2 block_base "
             f"{SG_RD_N}", rhs["rd_aug"], (TRBDF2, SG_RD_N))]


def sens_grid_inputs():
    """The Fisher members (y0 = 0.5 + 0.3 sin(2 pi x), r in [0.8, 1.2])
    and the reaction-diffusion members (y0 = 1 + 0.5 sin(pi x), k in [5,
    30], D = 200) on the card, with the initial states of their
    variational systems: ``(fy0, r, fY, ry0, kd, rY)``."""
    x = np.linspace(0, 1, SG_FIS_N, endpoint=False)
    fy0 = torch.tensor(np.tile(0.5 + 0.3 * np.sin(2 * np.pi * x),
                               (SG_FIS_M, 1)), dtype=torch.float32,
                       device="cuda")
    r = torch.linspace(0.8, 1.2, SG_FIS_M, device="cuda")[:, None]
    xr = np.linspace(0, 1, SG_RD_N)
    ry0 = torch.tensor(np.tile(1.0 + 0.5 * np.sin(np.pi * xr),
                               (SG_RD_M, 1)), dtype=torch.float32,
                       device="cuda")
    kd = torch.stack([torch.linspace(5.0, 30.0, SG_RD_M, device="cuda"),
                      torch.full((SG_RD_M,), 200.0, device="cuda")], 1)
    fY = torch.cat([fy0, torch.zeros_like(fy0)], 1)
    rY = torch.cat([ry0, torch.zeros(SG_RD_M, 2 * SG_RD_N, device="cuda")],
                   1)
    return fy0, r, fY, ry0, kd, rY


def sens_grid_kernel_checks(R, fy0, r, fY, ry0, kd, rY):
    """B4 with params and on the Fisher variational system, B7 with params
    and in block_base mode on the reaction-diffusion's, each against its
    plain version on the card at the phase's sizes, and at the other
    launch shapes (the warp body bit for bit the block of 32).  Returns
    the largest |dy| of the B4 and of the B7 checks and the plain
    versions' seconds."""
    from extensisq_tpu_torch import BS5, TRBDF2
    from extensisq_tpu_torch import ops
    runs = {"fused_erk_grid": (ops.solve_fused_erk_grid,
                               ops.fused_erk_grid_reference),
            "fused_esdirk_grid": (ops.solve_fused_esdirk_grid,
                                  ops.fused_esdirk_grid_reference)}
    checks = [
        ("fused_erk_grid", "fisher params", R["fisher"], SG_FIS_SPAN, fy0,
         dict(method=BS5, params=r, **SG_FIS_TOL)),
        ("fused_erk_grid", "fisher variational", R["fisher_aug"],
         SG_FIS_SPAN, fY, dict(method=BS5, params=r, **SG_FIS_TOL)),
        ("fused_esdirk_grid", "rd params", R["rd"], SG_RD_SPAN, ry0,
         dict(method=TRBDF2, params=kd, **SG_RD_TOL)),
        ("fused_esdirk_grid", "rd variational", R["rd_aug"], SG_RD_SPAN, rY,
         dict(method=TRBDF2, params=kd, block_base=SG_RD_N, **SG_RD_TOL))]
    errs = {"fused_erk_grid": 0.0, "fused_esdirk_grid": 0.0}
    plain_s = {}
    for kind, label, rhs, span, y0, kw in checks:
        run, plain = runs[kind]
        k, res, dy, r_s = hold_against_plain(
            "sens grid", label, lambda: run(rhs, span, y0, **kw),
            lambda: plain(rhs, span, y0, **kw), *SG_KERNEL_GATES[label])
        print(f"sens grid [{label}, {y0.shape[0]} members of "
              f"{y0.shape[1]} rows]: plain version {r_s:.3f} s")
        hold_grid_shapes(kind, label, rhs, span, y0, kw, k,
                         getattr(ops, "solve_" + kind).last_shape, res,
                         SG_KERNEL_GATES[label])
        errs[kind] = max(errs[kind], dy)
        plain_s[label] = r_s
    return errs, plain_s


def sens_grid_path():
    """Forward sensitivities on the grid layout at the mid-size configs'
    widths: the kernel checks; Fisher's 64-member sweep (n = 256) through
    ``solve_fused_sens(layout="grid")``, one launch of B4 on 512 rows,
    against central differences of B4 with params; the reaction-diffusion's
    32-member sweep (n = 128, k = 2) through it with TRBDF2, one launch of
    B7 with block_base 128 on 384 rows, members 0 and 31 against the
    port's f64 ``sens_forward`` on the CPU; the lines' walls, device ms and
    bounds.  Returns the ``_sens_grid`` keys of B4 and B7."""
    from extensisq_tpu_torch import BS5, KC4I, TRBDF2, sensitivity
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    from extensisq_tpu_torch.ops.fused_esdirk import _esdirk_consts
    start = time.perf_counter()
    R = sens_grid_rhs()
    fy0, r, fY, ry0, kd, rY = sens_grid_inputs()
    errs, plain_s = sens_grid_kernel_checks(R, fy0, r, fY, ry0, kd, rY)
    erk, esd = ops.solve_fused_erk_grid, ops.solve_fused_esdirk_grid
    every = [getattr(ops, k) for k in dir(ops) if k.startswith("solve_fused_")
             and hasattr(getattr(ops, k), "launches")]

    def counted(fn):
        """``fn()`` with every kernel's count set to 0 just before it and
        read just after: (its result, (B4's, B7's launches), seconds);
        fails where another kernel launched."""
        for w in every:
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        others = {w.__name__: w.launches for w in every
                  if w not in (erk, esd) and w.launches}
        check(not others, f"sens grid: other kernels launched {others}")
        return out, (erk.launches, esd.launches), sec

    # the Fisher line: one launch of B4 on the variational system
    def run_fis():
        return ops.solve_fused_sens(R["fisher"], SG_FIS_SPAN, fy0, params=r,
                                    layout="grid", **SG_FIS_TOL)

    (yf, Sp, Sy0, st, ns, nf), lf, f_s = counted(run_fis)
    check(lf == (1, 0), f"sens grid fisher: launches (B4, B7) {lf}, "
          "expected (1, 0)")
    check(bool((st == 1).all()), "sens grid fisher: not every member "
          "finished")
    check(Sp.shape == (SG_FIS_M, SG_FIS_N, 1) and Sy0 is None
          and bool(torch.isfinite(Sp).all()), "sens grid fisher: bad S_p")
    yp = erk(R["fisher"], SG_FIS_SPAN, fy0, params=r + SG_FD_EPS,
             **SG_FD_TOL)
    ym = erk(R["fisher"], SG_FIS_SPAN, fy0, params=r - SG_FD_EPS,
             **SG_FD_TOL)
    check(bool((yp[1] == 1).all() and (ym[1] == 1).all()),
          "sens grid fisher: a central-difference run did not finish")
    fd = (yp[0] - ym[0]) / (2 * SG_FD_EPS)
    d_fd = (Sp[:, :, 0] - fd).abs().max().item() / fd.abs().max().item()
    print(f"sens grid Fisher x{SG_FIS_M} (n {SG_FIS_N}, BS5, 512 rows): "
          f"{f_s * 1e3:.1f} ms first call, launches (B4, B7) {lf}, mean "
          f"nsteps {ns.double().mean():.2f}; S_p vs central differences "
          f"of B4 with params (eps {SG_FD_EPS:.0e}): max |d| / max |FD| "
          f"{d_fd:.3e} (gate {SG_FD_GATE:.0e})")
    check(d_fd < SG_FD_GATE, "sens grid fisher: S_p off central "
          "differences")

    # the reaction-diffusion line: one launch of B7 in block_base mode
    def run_rd():
        return ops.solve_fused_sens(R["rd"], SG_RD_SPAN, ry0, params=kd,
                                    method=TRBDF2, layout="grid",
                                    **SG_RD_TOL)

    (ryf, rSp, rSy0, rst, rns, rnf), lr, r_s = counted(run_rd)
    check(lr == (0, 1), f"sens grid rd: launches (B4, B7) {lr}, expected "
          "(0, 1)")
    check(bool((rst == 1).all()), "sens grid rd: not every member finished")
    check(rSp.shape == (SG_RD_M, SG_RD_N, 2) and rSy0 is None
          and bool(torch.isfinite(rSp).all()), "sens grid rd: bad S_p")
    t0 = time.perf_counter()
    worst_y, worst_s = 0.0, 0.0
    for b in (0, SG_RD_M - 1):
        ref = sensitivity.sens_forward(
            rd_1, SG_RD_SPAN, ry0[b].double().cpu(),
            p=(float(kd[b, 0]), float(kd[b, 1])), method=KC4I,
            **SG_F64_TOL)
        ref_S = torch.as_tensor(ref.sensf)
        worst_y = max(worst_y, (ryf[b].double().cpu()
                                - torch.as_tensor(ref.yf)).abs().max().item())
        for j in range(2):
            sc = max(ref_S[:, j].abs().max().item(), 1e-12)
            worst_s = max(worst_s, (rSp[b, :, j].double().cpu()
                                    - ref_S[:, j]).abs().max().item() / sc)
    f64_s = time.perf_counter() - t0
    print(f"sens grid reaction-diffusion x{SG_RD_M} (n {SG_RD_N}, k 2, "
          f"TRBDF2, block_base {SG_RD_N}, 384 rows): {r_s * 1e3:.1f} ms "
          f"first call, launches (B4, B7) {lr}, mean nsteps "
          f"{rns.double().mean():.2f}; members 0 and {SG_RD_M - 1} vs the "
          f"f64 sens_forward (KC4I, rtol 1e-9, CPU, {f64_s:.1f} s): max "
          f"|dy| {worst_y:.3e} (gate {SG_F64_Y_GATE:.0e}), max |dS_j| / "
          f"max |S_j| {worst_s:.3e} (gate {SG_F64_S_GATE:.0e})")
    check(worst_y < SG_F64_Y_GATE, "sens grid rd: y_f off the f64 driver")
    check(worst_s < SG_F64_S_GATE, "sens grid rd: S_p off the f64 driver")

    # times: the lines' warm walls, the launches' device ms, the plain
    # versions' walls (from the kernel checks, one run each)
    kwf = dict(method=BS5, params=r, **SG_FIS_TOL)
    kwr = dict(method=TRBDF2, params=kd, block_base=SG_RD_N, **SG_RD_TOL)
    f_ms = wall_ms(run_fis, reps=3)
    r_ms = wall_ms(run_rd, reps=3)
    f_dev = event_ms(lambda: erk(R["fisher_aug"], SG_FIS_SPAN, fY, **kwf))
    r_dev = event_ms(lambda: esd(R["rd_aug"], SG_RD_SPAN, rY, **kwr))
    f_plain = plain_s["fisher variational"] * 1e3
    r_plain = plain_s["rd variational"] * 1e3
    print(f"time [sens grid Fisher, B4 on 512 rows] {SG_FIS_M} members: "
          f"{f_ms:.3f} ms wall (solve_fused_sens), {f_dev:.4f} ms device "
          f"(CUDA events, the launch), plain version {f_plain:.1f} ms wall")
    print(f"time [sens grid reaction-diffusion, B7 block_base on 384 rows] "
          f"{SG_RD_M} members: {r_ms:.3f} ms wall (solve_fused_sens), "
          f"{r_dev:.4f} ms device, plain version {r_plain:.1f} ms wall")

    # bounds: the states in and out once, the params once; operations from
    # this run's evaluations, each row counted as the work it needs
    n_f = 2 * SG_FIS_N
    ops_f = rk_ops(_fused_consts(BS5), False, n_f,
                   (SG_RHS_OPS["fisher"] + SG_RHS_OPS["fisher_tangent"]) / 2,
                   int(nf.sum()), SG_FIS_M, 5)
    bound_f = bound_entry(SG_FIS_M * 4 * (2 * n_f + 1 + 3), ops_f)
    n_r = 3 * SG_RD_N
    ops_r = esdirk_grid_ops(
        n_r, _esdirk_consts(TRBDF2),
        (SG_RHS_OPS["rd"] + SG_RHS_OPS["rd_tangent_k"]
         + SG_RHS_OPS["rd_tangent_d"]) / 3,
        int(rnf.sum()) - SG_RD_M, int(rns.sum()),
        3 * SG_RHS_OPS["rd_band"], nb=SG_RD_N)
    bound_r = bound_entry(SG_RD_M * 4 * (2 * n_r + 2 + 3), ops_r)
    print(f"bound [sens grid Fisher]: {bound_f['bound_ms']:.4f} ms "
          f"({bound_f['bound_by']}); [sens grid reaction-diffusion]: "
          f"{bound_r['bound_ms']:.4f} ms ({bound_r['bound_by']})")
    print(f"sensitivity grid phase: {time.perf_counter() - start:.1f} s")
    return ({"launches_sens_grid": lf[0],
             "max_abs_err_sens_grid": errs["fused_erk_grid"],
             "ms_sens_grid": f_ms, "device_ms_sens_grid": f_dev,
             "plain_ms_sens_grid": f_plain,
             "bound_ms_sens_grid": bound_f["bound_ms"],
             "bound_by_sens_grid": bound_f["bound_by"]},
            {"launches_sens_grid": lr[1],
             "max_abs_err_sens_grid": errs["fused_esdirk_grid"],
             "ms_sens_grid": r_ms, "device_ms_sens_grid": r_dev,
             "plain_ms_sens_grid": r_plain,
             "bound_ms_sens_grid": bound_r["bound_ms"],
             "bound_by_sens_grid": bound_r["bound_by"]})


# -- the continuous adjoint through the fused kernels (configs 7d and 7b) -----
# Config 7d (validation/benchmarks.py:910-953): the grid layout's continuous
# adjoint of sum(mean(y_f)) over 8 members of the diffusive Fisher MoL at n
# = 128, D = 0.02 n^2, r in [0.8, 1.6], BS5 at rtol 1e-5 / atol 1e-8 on t in
# [0, 0.25], dense=400 (tests/test_fused_adjoint.py:84-139); and config 7b's
# 1,024-member Van der Pol sweep (validation/benchmarks.py:838-871) through
# the adjoint (tests/test_fused_adjoint.py:32-66 at 7b's width)
ADJ_N, ADJ_M, ADJ_SPAN = 128, 8, (0.0, 0.25)
ADJ_D = 0.02 * ADJ_N * ADJ_N
ADJ_TOL = dict(rtol=1e-5, atol=1e-8)
ADJ_DENSE = 400
ADJ_VDP_DENSE = 512
# JAX's gates: dL/dr within 5e-3 of central differences of B4 with params
# (eps 2e-3, rtol 1e-7 / atol 1e-10), member 0's dL/dy0 within 2e-3 of the
# f64 solve_final gradient, 7b's gradients within 2e-3 of
# solve_fused_final's, each over its largest entry
ADJ_FD_EPS = 2e-3
ADJ_FD_TOL = dict(rtol=1e-7, atol=1e-10)
ADJ_FD_GATE = 5e-3
ADJ_F64_TOL = dict(rtol=1e-9, atol=1e-12)
ADJ_F64_GATE = 2e-3
ADJ_FINAL_GATE = 2e-3
# the overflow: dense=8 on 7b's first 64 members
ADJ_OVERFLOW = (8, 64)
# the kernels with their records against the plain versions with theirs on
# the card: (max |dy|, relative difference of mean nsteps, max |dnsteps|)
# of hold_against_plain (the 7b line's are SENS_KERNEL_GATES' "vdp
# params": the record leaves the outputs as they are).  Measured on an
# H100 (tools/probe_sens.py --adjoint): vdp params 2.2e-4, 3.8e-4, 1; vdp
# compensated 6.0e-6, 1.5e-4, 1; fisher 7d 2.4e-5, 2.5e-2, 8 (the
# stability-bound steps of the diffusive MoL bifurcate: 6 of 8 members
# take other counts).  Gates 3-5x
ADJ_KERNEL_GATES = {"vdp params": SENS_KERNEL_GATES["vdp params"],
                    "vdp compensated": (3e-5, 2e-3, 2),
                    "fisher 7d": (1e-4, 0.1, 32)}
# then the records: (the two dense outputs at 97 common times, the
# kernel's nodes (ts, y_anchor) against the plain version's dense output at
# the same times).  From the second attempt the card's powf and torch.pow
# part the last bits of h, so the nodes themselves part (by up to 0.4 on
# Van der Pol, with equal counts) and the gates are those of the dense
# outputs' interpolation error.  Measured (the same probe): vdp params
# 9.1e-3 and 8.5e-3; vdp compensated 1.8e-3 and 1.9e-3; fisher 7d 3.7e-4
# and 2.5e-4.  Gates about 4x
ADJ_DENSE_GATES = {"vdp params": (4e-2, 4e-2),
                   "vdp compensated": (8e-3, 8e-3),
                   "fisher 7d": (1.5e-3, 1e-3)}
# float32 operations per element of 7d's right-hand side: the stencil
# (4) and the logistic term (4)
ADJ_FISHER_OPS = 8


def fisher_diff(n):
    d = 0.02 * n * n
    return lambda t, y, p: ((torch.roll(y, 1, 0) - 2.0 * y
                             + torch.roll(y, -1, 0)) * d
                            + p[0] * y * (1.0 - y))


def _fisher_diff_cuda(n):
    return ("template <class T, class V>\n"
            "__device__ T rhs(T t, V y, int i, const T* p) {\n"
            "  return (tab::G::rolled<0>(y, i, 1) - 2.0f * y[i]\n"
            f"          + tab::G::rolled<0>(y, i, -1)) * {_lit(0.02 * n * n)}"
            "\n         + p[0] * y[i] * (1.0f - y[i]);\n}")


def adjoint_rhs():
    """The adjoint phase's right-hand sides: 7b's Van der Pol with mu a
    member (as the sensitivity phase's) and 7d's Fisher MoL with r a
    member."""
    from extensisq_tpu_torch.ops import FusedGridRHS, FusedRHS
    return {"vdp": FusedRHS(vdp_p, VDP_P_CUDA, 2, 1),
            "fisher": FusedGridRHS(fisher_diff(ADJ_N),
                                   _fisher_diff_cuda(ADJ_N), (ADJ_N,), 1)}


def adjoint_builds(rhs):
    """(kernel, label, rhs, options) of the phase's variants: B1 and B4
    with the dense record, and B4 without it on 7d's line (7b's B1 without
    it is the sensitivity phase's)."""
    from extensisq_tpu_torch import BS5
    return [("fused_erk_rec", "vdp params dense", rhs["vdp"], None),
            ("fused_erk_grid_rec", "fisher 7d dense", rhs["fisher"], BS5),
            ("fused_erk_grid", "fisher 7d", rhs["fisher"], BS5)]


def adjoint_inputs():
    """7d's members (y0 = 0.5 + 0.3 sin(2 pi x), r in [0.8, 1.6]) on the
    card: ``(fy0, rates)``."""
    x = np.linspace(0, 1, ADJ_N, endpoint=False)
    fy0 = torch.tensor(np.tile(0.5 + 0.3 * np.sin(2 * np.pi * x),
                               (ADJ_M, 1)), dtype=torch.float32,
                       device="cuda")
    rates = torch.tensor(np.linspace(0.8, 1.6, ADJ_M), dtype=torch.float32,
                         device="cuda")[:, None]
    return fy0, rates


def _scaled(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def hold_record(label, k, r, span, gates=None, scaled=False):
    """A kernel run ``k`` and its plain version's ``r``, each with its
    dense output fifth: equal valid; each member's last node its final
    state at tf, bit for bit; the dense outputs at 97 common times and the
    kernel's nodes against the plain version's dense output at their times
    within ``gates`` (by default ``ADJ_DENSE_GATES[label]``); with
    ``scaled``, each component's difference over that component's largest
    |y| in the plain version's dense outputs or nodes."""
    from extensisq_tpu_torch.ops.fused_dense import _evaluate
    sol_gate, node_gate = gates or ADJ_DENSE_GATES[label]
    sol, ref = k[4], r[4]
    check(torch.equal(sol.valid, ref.valid), f"{label}: valid differs")
    # node nsteps (the first of the inert tail) repeats the last step's end
    b = torch.arange(k[0].shape[0], device="cuda")
    last = k[2].long()
    inner = last < sol.h.shape[1]
    ends = (torch.equal(sol.ts[b, last], torch.full_like(
        sol.ts[:, 0], float(np.float32(span[1]))))
        and torch.equal(sol.y_anchor[b[inner], last[inner]], k[0][inner]))
    tq = torch.linspace(*span, 97, device="cuda")
    # sol(tq) is (B, n, 97), the nodes (B, R, n)
    ref_q = ref(tq)
    d_sol = (sol(tq) - ref_q).abs()
    sgn = 1.0 if span[1] >= span[0] else -1.0
    nodes = torch.arange(sol.h.shape[1], device="cuda")[None] < last[:, None]
    at = _evaluate(ref, sol.t_anchor, sgn)
    d_node = (sol.y_anchor - at).abs()[nodes]
    if scaled:
        d_sol = d_sol / ref_q.abs().amax((0, 2))[:, None]
        d_node = d_node / at[nodes].abs().amax(0)
    d_sol, d_node = d_sol.max().item(), d_node.max().item()
    what = " over each component's largest" if scaled else ""
    print(f"adjoint record [{label}, {k[0].shape[0]}]: valid equal "
          f"(all {bool(sol.valid.all())}), the last nodes the final states "
          f"at tf {ends}, dense outputs at 97 times max |d|{what} {d_sol:.3e} "
          f"(gate {sol_gate:.1e}), the nodes against the plain version's "
          f"dense output max |d|{what} {d_node:.3e} (gate {node_gate:.1e})")
    check(ends, f"{label}: the last nodes are not the final states")
    check(d_sol <= sol_gate, f"{label}: dense outputs differ by {d_sol}")
    check(d_node <= node_gate, f"{label}: nodes differ by {d_node}")


def _same_record(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
            and all(torch.equal(getattr(a[4], f), getattr(b[4], f))
                    for f in a[4]._fields))


def adjoint_kernel_checks(R, y0b, mus, fy0, rates):
    """B1 (7b's members, plain and compensated) and B4 (7d's) with their
    records against their plain versions on the card; every shape B1
    takes (one thread, 4 and 8 lanes) and B4's warp against its block of
    32, records included, bit for bit; the record leaves y, status,
    nsteps and nfev as they are without it.  Returns the largest |dy|
    and the plain versions' seconds of B1 and of B4."""
    from extensisq_tpu_torch import BS5
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops import fused_erk as FK
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    errs, plain_s = {}, {}
    for label, tol in (("vdp params", SENS_VDP_TOL),
                       ("vdp compensated", dict(ADJ_TOL, rtol=1e-6,
                                                atol=1e-9,
                                                compensated=True))):
        kw = dict(method=BS5, params=mus, **tol)
        k, r, dy, r_s = hold_against_plain(
            "adjoint", label,
            lambda: ops.solve_fused_erk(R["vdp"], SENS_VDP_SPAN, y0b,
                                        dense=ADJ_VDP_DENSE, **kw),
            lambda: ops.fused_erk_reference(R["vdp"], SENS_VDP_SPAN, y0b,
                                            dense=ADJ_VDP_DENSE, **kw),
            *ADJ_KERNEL_GATES[label])
        hold_record(label, k, r, SENS_VDP_SPAN)
        off = ops.solve_fused_erk(R["vdp"], SENS_VDP_SPAN, y0b, **kw)
        same_off = all(torch.equal(a, b) for a, b in zip(k[:4], off))
        shapes = {}
        for lanes in (1, 4, 8):
            shapes[lanes] = _same_record(k, FK._launch(
                R["vdp"], SENS_VDP_SPAN, y0b, BS5, tol["rtol"], tol["atol"],
                None, 100_000, tol.get("compensated", False), None, lanes,
                None, mus, ADJ_VDP_DENSE)[0])
        print(f"fused_erk [{label} dense, {y0b.shape[0]}]: the rule takes "
              f"{shape_text(ops.solve_fused_erk, y0b.shape[0])}; outputs and "
              f"records at "
              f"1 / 4 / 8 lanes bit-identical to the rule's {shapes}; "
              f"outputs bit-identical to dense=None {same_off}")
        check(all(shapes.values()), f"{label}: a lane shape differs")
        check(same_off, f"{label}: the record changed the outputs")
        errs["fused_erk"] = max(errs.get("fused_erk", 0.0), dy)
        plain_s[label] = r_s
    kw = dict(method=BS5, params=rates, **ADJ_TOL)
    k, r, dy, r_s = hold_against_plain(
        "adjoint", "fisher 7d",
        lambda: ops.solve_fused_erk_grid(R["fisher"], ADJ_SPAN, fy0,
                                         dense=ADJ_DENSE, **kw),
        lambda: ops.fused_erk_grid_reference(R["fisher"], ADJ_SPAN, fy0,
                                             dense=ADJ_DENSE, **kw),
        *ADJ_KERNEL_GATES["fisher 7d"])
    shape = ops.solve_fused_erk_grid.last_shape
    hold_record("fisher 7d", k, r, ADJ_SPAN)
    off = ops.solve_fused_erk_grid(R["fisher"], ADJ_SPAN, fy0, **kw)
    same_off = all(torch.equal(a, b) for a, b in zip(k[:4], off))
    built = FKG._kernel(BS5, R["fisher"], True)
    kw.pop("method")
    warp, b32 = (FKG._launch(built, ADJ_SPAN, fy0, ADJ_N, shape=s,
                             dense=ADJ_DENSE, **kw)[0]
                 for s in ((32, FKG.WARP_MEMBERS), (32, 0)))
    warp_same = _same_record(warp, b32)
    print(f"fused_erk_grid [fisher 7d dense, {ADJ_M}]: the rule takes "
          f"{grid_shape_text(shape, ADJ_M)}; one warp per member bit-"
          f"identical to one block of 32 threads, records included, "
          f"{warp_same}; outputs bit-identical to dense=None {same_off}")
    check(warp_same, "fisher 7d: the warp and the block of 32 differ")
    check(same_off, "fisher 7d: the record changed the outputs")
    errs["fused_erk_grid"] = dy
    plain_s["fisher 7d"] = r_s
    return errs, plain_s


# the C library of each wrapper module's kernel
KERNEL_LIB = {"fused_erk": "fused_erk", "fused_erk_grid": "fused_rk_grid",
              "fused_rkn": "fused_rkn", "fused_rkn_grid": "fused_rk_grid",
              "fused_esdirk": "fused_esdirk",
              "fused_esdirk_grid": "fused_esdirk_grid",
              "fused_ckdisc": "fused_ckdisc",
              "fused_ckdisc_grid": "fused_rk_grid"}


def _launch_args(kind, y0, out, params, span, tol, shape, rec, yp0=None,
                 M=None):
    """The C arguments before the stream of one launch of B1, B2, B4-B7,
    B11 or B12 (``kind``, its wrapper's module) at ``shape`` into the
    preallocated ``out`` with the members' ``params`` (None: none), and
    ``rec``, a DenseRecord, where it has rows, as the wrappers pass them:
    from ``tol``'s first_step where it has one, else from Watts' estimate
    (B2 and B7 as plain ODEs; with a mass matrix ``M``, B2's any value as
    its build holds it, B7's the mass diagonal as a CUDA tensor, and the
    derivatives ``yp0`` from 1% of the span)."""
    from extensisq_tpu_torch.ops.fused_erk import launch_args
    from extensisq_tpu_torch.ops.fused_esdirk import _tiny_err
    nb, n = y0.shape
    outs = tuple(x.data_ptr() for x in out)
    if kind in ("fused_esdirk", "fused_esdirk_grid"):
        t0, tf = np.float32(span[0]), np.float32(span[1])
        head = (y0.data_ptr(), None if yp0 is None else yp0.data_ptr())
        if kind.endswith("_grid"):
            head += (None if M is None else M.data_ptr(),)
        first = tol.get("first_step")
        h0 = (np.float32(0.01) * abs(tf - t0) if first is None
              else np.float32(first))
        args = (head + (None if params is None else params.data_ptr(),)
                + outs
                + (nb, float(t0), float(tf), float(tol["rtol"]),
                   float(tol["atol"]), float(h0),
                   int(M is None and first is None), int(yp0 is not None),
                   np.inf, 100_000, _tiny_err(n, tol["rtol"]),
                   int(tol.get("compensated", False)))
                + tuple(shape))
    else:
        scal = launch_args(span, tol["rtol"], tol["atol"],
                           tol.get("first_step"), 100_000,
                           tol.get("compensated", False), None)
        head = ((y0.data_ptr(),
                 None if params is None else params.data_ptr())
                + outs + (nb,))
        if kind in ("fused_erk", "fused_rkn"):
            args = head + scal + tuple(shape)
        elif kind == "fused_ckdisc":
            args = head + scal[:-1] + tuple(shape)
        else:
            t0, tf = scal[:2]
            args = (head + (t0, tf, float(np.sign(np.float32(tf)
                                                  - np.float32(t0))))
                    + scal[2:] + tuple(shape))
    return args + (rec.args() if rec.rows else ())


def launch_ms(kind, built, y0, params, span, tol, shape, rows, reps=10,
              tq=None, yp0=None, M=None):
    """Device ms of one launch of B1, B2, B4-B7, B11 or B12 (``kind``, its
    wrapper's module) with the record of ``rows`` a member (0: the build
    without it) and, on a snapshot build, the t_eval points ``tq`` (B2 and
    B7 with the mass matrix ``M`` and the derivatives ``yp0`` of
    :func:`_launch_args`), the outputs allocated before: CUDA events
    around ``reps`` launches back to back, per launch (a single launch
    between events measures the host's enqueue as much as the kernel),
    median of REPS; and the DenseRecord written."""
    from extensisq_tpu_torch.ops.fused_erk import DenseRecord, SnapPoints
    out = (torch.empty_like(y0),
           *[torch.empty(y0.shape[0], dtype=torch.int32, device="cuda")
             for _ in range(3)])
    rec = DenseRecord(y0, rows)
    args = _launch_args(kind, y0, out, params, span, tol, shape, rec, yp0,
                        M)
    suffix = "_record" if rows else ""
    if tq is not None:
        # a snapshot launch takes the record's arguments (null without
        # rows; B11 has none) before the points'
        if not rows and kind != "fused_ckdisc":
            args = args + rec.args()
        args = args + SnapPoints(tq, span, y0).args()
        suffix = "_snap"
    fn = getattr(built.lib, f"{KERNEL_LIB[kind]}{suffix}_launch")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        for _ in range(reps):
            check(fn(*args, stream) == 0, f"{kind}: launch failed")
    return event_ms(run) / reps, rec


def adjoint_path():
    """The continuous adjoint through B1 and B4 on the card: the kernels
    with their records against their plain versions; config 7d through
    ``solve_fused_adjoint(layout="grid")`` (one launch of B4 with the
    record, the f64 backward) against central differences of B4 with
    params and member 0 against the f64 ``sensitivity.solve_final``;
    config 7b through ``solve_fused_adjoint`` (one launch of B1) against
    ``solve_fused_final``; the overflow's NaN gradients; the walls, the
    forward launches' device ms with and without the record, their bounds
    and the backward's attempts and host syncs.  Returns the ``_adjoint``
    keys of B1 and B4."""
    from extensisq_tpu_torch import BS5, sensitivity
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops import fused_erk as FK
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    start = time.perf_counter()
    R = adjoint_rhs()
    _, _, _, y0b, mus, _ = sens_inputs()
    fy0, rates = adjoint_inputs()
    errs, plain_s = adjoint_kernel_checks(R, y0b, mus, fy0, rates)
    erk, grid = ops.solve_fused_erk, ops.solve_fused_erk_grid
    every = [getattr(ops, k) for k in dir(ops) if k.startswith("solve_fused_")
             and hasattr(getattr(ops, k), "launches")]

    def counted(fn, wrapper):
        """``fn()`` with every kernel's count set to 0 just before it and
        read just after: (its result, ``wrapper``'s launches); fails where
        another kernel launched."""
        for w in every:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        others = {w.__name__: w.launches for w in every
                  if w is not wrapper and w.launches}
        check(not others, f"adjoint: other kernels launched {others}")
        return out, wrapper.launches

    # 7d: the grid layout's adjoint, one launch of B4 with the record
    def grad_7d(dense=ADJ_DENSE):
        Y = fy0.clone().requires_grad_(True)
        P = rates.clone().requires_grad_(True)
        yf = ops.solve_fused_adjoint(R["fisher"], ADJ_SPAN, Y, P, None,
                                     dense=dense, layout="grid", **ADJ_TOL)
        val = yf.mean(1).sum()
        gy0, gp = torch.autograd.grad(val, (Y, P))
        return val.detach(), gy0, gp

    (val_d, gy0, gp), ld = counted(grad_7d, grid)
    check(ld == 1, f"7d: B4 launched {ld} times, expected 1")
    check(bool(torch.isfinite(gy0).all() and torch.isfinite(gp).all()),
          "7d: a gradient is not finite")
    bw_d = ops.solve_fused_adjoint.last_backward
    fd_kw = dict(method=BS5, **ADJ_FD_TOL)
    yp = grid(R["fisher"], ADJ_SPAN, fy0, params=rates + ADJ_FD_EPS, **fd_kw)
    ym = grid(R["fisher"], ADJ_SPAN, fy0, params=rates - ADJ_FD_EPS, **fd_kw)
    check(bool((yp[1] == 1).all() and (ym[1] == 1).all()),
          "7d: a central-difference run did not finish")
    fd = (yp[0].mean(1) - ym[0].mean(1)) / (2 * ADJ_FD_EPS)
    d_fd = _scaled(gp[:, 0], fd)
    t0 = time.perf_counter()
    v0 = fy0[0].double().requires_grad_(True)
    fun = R["fisher"].torch_fn
    yf64 = sensitivity.solve_final(
        lambda t, y, p: fun(t, y, (p,)), ADJ_SPAN, v0,
        torch.tensor(float(rates[0, 0]), dtype=torch.float64,
                     device="cuda"), None, max_steps=100_000, **ADJ_F64_TOL)
    gref, = torch.autograd.grad(yf64.mean(), v0)
    f64_s = time.perf_counter() - t0
    d_f64 = _scaled(gy0[0].double(), gref)
    print(f"7d Fisher x{ADJ_M} (n {ADJ_N}, D {ADJ_D:g}, BS5, dense "
          f"{ADJ_DENSE}, grid): launches of B4 {ld}, loss {float(val_d):.6f}"
          f", backward attempts {int((bw_d.nsteps + bw_d.nfailed).max())};"
          f" dL/dr vs central differences of B4 with params (eps "
          f"{ADJ_FD_EPS:.0e}, rtol 1e-7): max |d| / max |FD| {d_fd:.3e} "
          f"(gate {ADJ_FD_GATE:.0e}); member 0's dL/dy0 vs the f64 "
          f"solve_final (rtol 1e-9, the card, {f64_s:.1f} s): {d_f64:.3e} "
          f"(gate {ADJ_F64_GATE:.0e})")
    check(d_fd <= ADJ_FD_GATE, "7d: dL/dr off central differences")
    check(d_f64 <= ADJ_F64_GATE, "7d: dL/dy0 off the f64 solve_final")

    # 7b through the adjoint, one launch of B1 with the record, against
    # solve_fused_final
    def grad_7b(solver, *extra, members=None):
        sl = slice(None, members)
        t0_, tf_ = (torch.tensor(x, device="cuda", requires_grad=True)
                    for x in SENS_VDP_SPAN)
        Y = y0b[sl].clone().requires_grad_(True)
        P = mus[sl].clone().requires_grad_(True)
        yf = solver(R["vdp"], (t0_, tf_), Y, P, BS5, SENS_VDP_TOL["rtol"],
                    SENS_VDP_TOL["atol"], 100_000, None, *extra)
        val = yf[:, 0].sum()
        return (val.detach(),) + torch.autograd.grad(val, (t0_, tf_, Y, P))

    adj, lb = counted(lambda: grad_7b(ops.solve_fused_adjoint,
                                      ADJ_VDP_DENSE), erk)
    check(lb == 1, f"7b adjoint: B1 launched {lb} times, expected 1")
    bw_b = ops.solve_fused_adjoint.last_backward
    fin = grad_7b(ops.solve_fused_final)
    d_y0 = _scaled(adj[3], fin[3])
    d_p = _scaled(adj[4], fin[4])
    d_t = max(abs(float(a) - float(b)) / abs(float(b))
              for a, b in zip(adj[1:3], fin[1:3]))
    print(f"7b adjoint VdP x{SENS_VDP_N} (BS5, dense {ADJ_VDP_DENSE}): "
          f"launches of B1 {lb}, loss equal to solve_fused_final's "
          f"{float(adj[0]) == float(fin[0])}; vs solve_fused_final: dL/dy0 "
          f"{d_y0:.3e}, dL/dmu {d_p:.3e}, dL/dt0 and dL/dtf {d_t:.3e} (gate "
          f"{ADJ_FINAL_GATE:.0e}); backward attempts "
          f"{int((bw_b.nsteps + bw_b.nfailed).max())}")
    check(float(adj[0]) == float(fin[0]), "7b adjoint: the value differs")
    check(max(d_y0, d_p, d_t) <= ADJ_FINAL_GATE,
          "7b adjoint: gradients off solve_fused_final's")
    dense_o, members_o = ADJ_OVERFLOW
    ovf = grad_7b(ops.solve_fused_adjoint, dense_o, members=members_o)
    nan_all = all(bool(torch.isnan(g).all()) for g in ovf[3:])
    print(f"adjoint overflow (dense {dense_o}, {members_o} members): every "
          f"dL/dy0 and dL/dmu NaN {nan_all}")
    check(nan_all, "adjoint overflow: finite gradients")

    # readings: walls of value and gradient, the backward's syncs, the
    # forward launches' device ms with and without the record
    b_ms = wall_ms(lambda: grad_7b(ops.solve_fused_adjoint, ADJ_VDP_DENSE),
                   reps=3)
    b_fin_ms = wall_ms(lambda: grad_7b(ops.solve_fused_final), reps=3)
    d_ms = wall_ms(grad_7d, reps=3)
    syncs = {}
    for name, fwd in (("7b", lambda: ops.solve_fused_adjoint(
            R["vdp"], SENS_VDP_SPAN, y0b.clone().requires_grad_(True), mus,
            BS5, dense=ADJ_VDP_DENSE, **SENS_VDP_TOL)),
            ("7d", lambda: ops.solve_fused_adjoint(
                R["fisher"], ADJ_SPAN, fy0.clone().requires_grad_(True),
                rates, dense=ADJ_DENSE, layout="grid", **ADJ_TOL))):
        yf = fwd()
        _, n_sync, sec, _ = count_syncs(lambda: yf.sum().backward())
        bw = ops.solve_fused_adjoint.last_backward
        att = int((bw.nsteps + bw.nfailed).max())
        syncs[name] = (sec, att, n_sync)
        print(f"adjoint backward [{name}]: {sec * 1e3:.1f} ms wall, "
              f"{att} attempts of the f64 driver over {bw.y.shape[0]} "
              f"members of {bw.y.shape[1]} rows, {n_sync} host syncs "
              f"({n_sync / att:.2f} an attempt)")
    tol_b = dict(SENS_VDP_TOL)
    b1_rec = FK._kernel(BS5, R["vdp"], True)
    b1_off = FK._kernel(BS5, R["vdp"], False)
    lanes = FK._lanes_per_member(SENS_VDP_N, FK.device_sm_count(y0b.device),
                                 False)
    shape_b = (lanes, max(1, 128 // lanes))
    b_rec_ms, rec_b = launch_ms("fused_erk", b1_rec, y0b, mus,
                                SENS_VDP_SPAN, tol_b, shape_b, ADJ_VDP_DENSE)
    b_off_ms, _ = launch_ms("fused_erk", b1_off, y0b, mus, SENS_VDP_SPAN,
                            tol_b, shape_b, 0)
    grid(R["fisher"], ADJ_SPAN, fy0, params=rates, method=BS5, **ADJ_TOL)
    shape_d = grid.last_shape
    b4_rec = FKG._kernel(BS5, R["fisher"], True)
    b4_off = FKG._kernel(BS5, R["fisher"], False)
    d_rec_ms, rec_d = launch_ms("fused_erk_grid", b4_rec, fy0, rates,
                                ADJ_SPAN, ADJ_TOL, shape_d, ADJ_DENSE)
    d_off_ms, _ = launch_ms("fused_erk_grid", b4_off, fy0, rates, ADJ_SPAN,
                            ADJ_TOL, shape_d, 0)
    # bounds: the states in and out once, the params once, the counters,
    # and the record's rows as written (2n + 1 floats a row), f0 and the
    # counts; operations from this run's evaluations
    k_bs5 = _fused_consts(BS5)
    fwd_b = erk(R["vdp"], SENS_VDP_SPAN, y0b, params=mus, method=BS5,
                **tol_b)
    fwd_d = grid(R["fisher"], ADJ_SPAN, fy0, params=rates, method=BS5,
                 **ADJ_TOL)

    def bound(n, members, nrec, nfev_sum, rhs_ops, start_evals):
        rows = int(nrec.sum())
        by = members * 4 * (2 * n + 1 + 3) + 4 * (
            rows * (2 * n + 1) + members * (n + 1))
        return bound_entry(by, rk_ops(k_bs5, False, n, rhs_ops, nfev_sum,
                                      members, start_evals))

    bound_b = bound(2, SENS_VDP_N, rec_b.n, int(fwd_b[3].sum()),
                    RHS_OPS["vdp"], 2 + min(2 + 1, 3))
    bound_d = bound(ADJ_N, ADJ_M, rec_d.n, int(fwd_d[3].sum()),
                    ADJ_FISHER_OPS, 5)
    print(f"time [7b adjoint, B1 with the record] {SENS_VDP_N} members: "
          f"{b_ms:.3f} ms wall (value and gradient, median of 3) against "
          f"{b_fin_ms:.3f} ms through solve_fused_final (forward "
          f"sensitivities); the forward launch {b_rec_ms:.4f} ms device "
          f"with the record, {b_off_ms:.4f} ms without it (CUDA events, "
          f"ten launches back to back); bound {bound_b['bound_ms']:.4f} ms "
          f"({bound_b['bound_by']}, {int(rec_b.n.sum())} rows); plain "
          f"version {plain_s['vdp params'] * 1e3:.1f} ms wall")
    print(f"time [7d adjoint, B4 with the record] {ADJ_M} members: "
          f"{d_ms:.3f} ms wall (value and gradient, median of 3); the "
          f"forward launch {d_rec_ms:.4f} ms device with the record, "
          f"{d_off_ms:.4f} ms without it; bound {bound_d['bound_ms']:.4f} ms"
          f" ({bound_d['bound_by']}, {int(rec_d.n.sum())} rows); plain "
          f"version {plain_s['fisher 7d'] * 1e3:.1f} ms wall")
    print(f"adjoint phase: {time.perf_counter() - start:.1f} s")
    return ({"launches_adjoint": lb,
             "max_abs_err_adjoint": errs["fused_erk"],
             "ms_adjoint": b_ms, "ms_final_7b": b_fin_ms,
             "device_ms_adjoint": b_rec_ms,
             "device_ms_adjoint_no_record": b_off_ms,
             "plain_ms_adjoint": plain_s["vdp params"] * 1e3,
             "bound_ms_adjoint": bound_b["bound_ms"],
             "bound_by_adjoint": bound_b["bound_by"],
             "backward_attempts_adjoint": syncs["7b"][1],
             "backward_syncs_adjoint": syncs["7b"][2]},
            {"launches_adjoint": ld,
             "max_abs_err_adjoint": errs["fused_erk_grid"],
             "ms_adjoint": d_ms, "device_ms_adjoint": d_rec_ms,
             "device_ms_adjoint_no_record": d_off_ms,
             "plain_ms_adjoint": plain_s["fisher 7d"] * 1e3,
             "bound_ms_adjoint": bound_d["bound_ms"],
             "bound_by_adjoint": bound_d["bound_by"],
             "backward_attempts_adjoint": syncs["7d"][1],
             "backward_syncs_adjoint": syncs["7d"][2]})


# -- the ESDIRK and RKN routes of the continuous adjoint ----------------------
# solve_fused_adjoint through B2 and B7 (ESDIRK, flat and grid) and B5 and
# B6 (RKN, flat and grid), each forward one launch with the dense record:
# * ESDIRK flat at config 7a's width: 512 Robertson members with the three
#   rate constants a member (k1 in [0.04, 0.05]), TRBDF2 on t in [0, 0.4]
#   at rtol 1e-4 / atol 1e-8; dL/dp of sum(y_f[:, 0]) against the same
#   phase's solve_fused_sens S_p[:, 0, :], each column over its largest
#   entry at 7a's CVODES gate (2e-2); member 0's dL/dy0 against the f64
#   sensitivity.solve_final (KC4I, rtol 1e-9);
# * ESDIRK grid: the reaction-diffusion of the grid sensitivity phase (n =
#   128, 32 members, (k, D) a member, TRBDF2 on t in [0, 0.04] at rtol
#   1e-5 / atol 1e-8); dL/dp of sum(mean(y_f)) against
#   solve_fused_sens(layout="grid") at JAX's 5e-3 of scale;
# * RKN flat at B5's width: u'' = -w^2 u, 2,048 members, w in [1, 2], u0 =
#   1, tf = 2, Fi5N at rtol 1e-6 / atol 1e-9; against the closed forms
#   dL/dw = -tf sin(w tf), dL/du0 = cos(w tf) at JAX's 5e-3
#   (tests/test_fused_adjoint.py:228-267);
# * RKN grid: the wave line's system (n = 256, 64 members) with c2 a member
#   in [300, 500] around WAVE_C2, Fi5N on t in [0, 1] at rtol 1e-6 / atol
#   1e-9; dL/dc2 of sum(u_f at x = 1/4) against central differences of B6
#   with params (eps 1% of c2, compensated at rtol 1e-8 / atol 1e-11) at
#   5e-3 of scale.
AR_ROB_DENSE = 512
AR_RD_DENSE = 256
AR_OSC_N, AR_OSC_SPAN = 2048, (0.0, 2.0)
AR_OSC_TOL = dict(rtol=1e-6, atol=1e-9)
AR_OSC_DENSE = 512
AR_WAVE_SPAN = (0.0, 1.0)
AR_WAVE_TOL = dict(rtol=1e-6, atol=1e-9)
AR_WAVE_DENSE = 1024
AR_WAVE_FD_REL = 1e-2
AR_WAVE_FD_TOL = dict(rtol=1e-8, atol=1e-11, compensated=True)
AR_F64_TOL = dict(rtol=1e-9, atol=1e-14)
AR_SENS_GATE = SENS_CVODES_SCALED
AR_GRID_GATE = 5e-3
AR_CLOSED_GATE = 5e-3
AR_FD_GATE = 5e-3
# member 0's dL/dy0 of the ESDIRK route against the f64 solve_final, over
# its largest entry (the JAX test's 1e-4 is absolute at rtol 1e-5 on a
# 2-state system; here 7a's tolerances on Robertson)
AR_F64_GATE = 2e-2
# the kernels with their records against the plain versions on the card:
# (max |dy|, relative difference of mean nsteps, max |dnsteps|) and (the
# dense outputs at 97 common times, the kernel's nodes against the plain
# version's dense output); Robertson's each component's difference over its
# largest value (y2 lives at ~3e-5), the others absolute.  Measured on an
# H100 (NVIDIA H100 80GB HBM3, 700 W; tools/probe_sens.py --routes and
# this phase): rob 7a 9.1e-7, 0, 0 and 1.2e-6, 1.5e-6; rd 3.6e-7, 0, 0 and
# 3.6e-7, 3.6e-7; osc 1.7e-6, 3.5e-2, 5 and 9.3e-5, 7.8e-5; wave 6.6e-5,
# 1.0e-3, 8 and 8.6e-5, 8.7e-5.  Gates 3-5x the readings; where a count
# reading is 0, one step of one member.  The oscillator's Fi5N error
# estimate is round-off at rtol 1e-6 (its stage accelerations cancel), so
# nvcc's contraction moves h: 14.48 against 13.998 mean steps, 5 at most,
# 1,047 of 2,048 members with other counts on the card; the same source
# built for the host with -ffp-contract=fast -mfma parts from the plain
# version alike (14.48 against 14.01, 5, 1,031), without contraction not
# at all
AR_KERNEL_GATES = {"rob 7a": (4e-6, 1e-4, 1), "rd": (1.5e-6, 3e-3, 1),
                   "osc": (6e-6, 0.1, 15), "wave": (3e-4, 5e-3, 24)}
AR_DENSE_GATES = {"rob 7a": (5e-6, 6e-6), "rd": (1.5e-6, 1.5e-6),
                  "osc": (4e-4, 3e-4), "wave": (3e-4, 3e-4)}
# float32 operations counted from the sources as the work each row needs
# (an addition, subtraction or multiplication one; a negation and a
# product with a seed of 1 or 0 none): B2 per Newton evaluation of
# Robertson (n = 3): the right-hand side (8), the point psi + d z (6), the
# right-hand side of the update h f - z (6), the replay of the 3 x 3
# factor (15), the update's scaled norm (18) and the update (3); the
# attempt's Jacobian and factor are left out, so the count is a lower
# bound.  B5's acceleration -(w w) u (2) and B6's wave with c2 a member
# (5) per position
AR_ROB_OPS = 56
AR_ACC_OPS = {"osc": 2, "wave": 5}


def osc_p(t, u, v, p):
    return -(p[0] * p[0]) * u


OSC_P_CUDA = """
template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a, const T* p) {
  a[0] = -(p[0] * p[0]) * u[0];
}
"""


def wave_p(t, u, v, p):
    return p[0] * (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) - 2.0 * u)


def _wave_p_cuda():
    return ("__device__ float acc(float t, const float* u, const float* v, "
            "int i, const float* p) {\n  using G = tab::G;\n"
            "  return p[0] * (G::rolled<0>(u, i, 1) + "
            "G::rolled<0>(u, i, -1) - 2.0f * u[i]);\n}")


def adjoint_routes_rhs():
    """The routes' right-hand sides: 7a's Robertson and the grid phase's
    reaction-diffusion (their sensitivity phases'), the oscillator and the
    wave with a parameter a member."""
    from extensisq_tpu_torch.ops import FusedAcc, FusedGridAcc
    return {"rob": sens_rhs()["rob"], "rd": sens_grid_rhs()["rd"],
            "osc": FusedAcc(osc_p, OSC_P_CUDA, 1, 1),
            "wave": FusedGridAcc(wave_p, _wave_p_cuda(), WAVE_N, 1)}


def adjoint_routes_builds(rhs):
    """(kernel, label, rhs, options) of the phase's variants: B2, B7, B5
    and B6 with the dense record, and B2, B5 and B6 with params without it
    (B7's is the grid sensitivity phase's)."""
    from extensisq_tpu_torch import Fi5N, TRBDF2
    return [("fused_esdirk_rec", "rob params TRBDF2 dense", rhs["rob"],
             (TRBDF2, None)),
            ("fused_esdirk", "rob params TRBDF2", rhs["rob"], (TRBDF2, None)),
            ("fused_esdirk_grid_rec", "rd params TRBDF2 dense", rhs["rd"],
             (TRBDF2, None)),
            ("fused_rkn_rec", "osc params Fi5N dense", rhs["osc"], Fi5N),
            ("fused_rkn", "osc params Fi5N", rhs["osc"], Fi5N),
            ("fused_rkn_grid_rec", "wave params Fi5N dense", rhs["wave"],
             Fi5N),
            ("fused_rkn_grid", "wave params Fi5N", rhs["wave"], Fi5N)]


def adjoint_routes_inputs():
    """The routes' members on the card: 7a's Robertson (y0, p), the
    reaction-diffusion's (y0, (k, D)), the oscillators' ([1, 0], w) and
    the waves' (wave_y0, c2)."""
    y0a, pa, _, _, _, _ = sens_inputs()
    _, _, _, ry0, kd, _ = sens_grid_inputs()
    oy0 = torch.zeros(AR_OSC_N, 2, device="cuda")
    oy0[:, 0] = 1.0
    ws = torch.linspace(1.0, 2.0, AR_OSC_N, device="cuda")[:, None]
    wy0 = wave_y0(WAVE_M, WAVE_N)
    c2 = torch.linspace(300.0, 500.0, WAVE_M, device="cuda")[:, None]
    return {"rob": (y0a, pa), "rd": (ry0, kd), "osc": (oy0, ws),
            "wave": (wy0, c2)}


def _route_kw(name):
    """The wrapper options of each route's forward."""
    from extensisq_tpu_torch import Fi5N, TRBDF2
    return {"rob": dict(method=TRBDF2, **SENS_ROB_TOL),
            "rd": dict(method=TRBDF2, **SG_RD_TOL),
            "osc": dict(method=Fi5N, **AR_OSC_TOL),
            "wave": dict(method=Fi5N, **AR_WAVE_TOL)}[name]


AR_DENSE = {"rob": AR_ROB_DENSE, "rd": AR_RD_DENSE, "osc": AR_OSC_DENSE,
            "wave": AR_WAVE_DENSE}
AR_SPAN = {"rob": SENS_ROB_SPAN, "rd": SG_RD_SPAN, "osc": AR_OSC_SPAN,
           "wave": AR_WAVE_SPAN}
AR_LABEL = {"rob": "rob 7a", "rd": "rd", "osc": "osc", "wave": "wave"}
# the wrapper module of each route's kernel
AR_KIND = {"rob": "fused_esdirk", "rd": "fused_esdirk_grid",
           "osc": "fused_rkn", "wave": "fused_rkn_grid"}


def adjoint_routes_kernel_checks(R, inp):
    """B2, B7, B5 and B6 with their records (B5 and B6 with params) against
    their plain versions on the card at the routes' widths; B2's lane
    groups (1, 4, 8, 16 and 32 lanes) and B5's (1, 2, 4 and 8) against
    the rule's shape, B7's and B6's warps against their blocks of 32 and
    their rules' blocks, records included, bit for bit; the record leaves
    y, status, nsteps and nfev as they are without it; B5 and B6 with
    params and no record against their plain versions and their other
    shapes.  Returns the largest |dy| and the plain versions' seconds of
    each kernel."""
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops import fused_esdirk as FE
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn as FN
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    wrappers = {name: (getattr(ops, "solve_" + kind),
                       getattr(ops, kind + "_reference"))
                for name, kind in AR_KIND.items()}
    errs, plain_s = {}, {}
    for name, (wrapper, plain) in wrappers.items():
        y0, p = inp[name]
        span, rows, label = AR_SPAN[name], AR_DENSE[name], AR_LABEL[name]
        kw = dict(_route_kw(name), params=p)
        k, r, dy, r_s = hold_against_plain(
            "adjoint routes", f"{label} dense",
            lambda: wrapper(R[name], span, y0, dense=rows, **kw),
            lambda: plain(R[name], span, y0, dense=rows, **kw),
            *AR_KERNEL_GATES[label], scaled=name == "rob")
        shape = wrapper.last_shape
        hold_record(label, k, r, span, AR_DENSE_GATES[label],
                    scaled=name == "rob")
        off = wrapper(R[name], span, y0, **kw)
        same_off = all(torch.equal(a, b) for a, b in zip(k[:4], off))
        check(same_off, f"{label}: the record changed the outputs")
        # the kernels line's error is absolute, Robertson's too
        errs[name] = (k[0] - r[0]).abs().max().item() if name == "rob" else dy
        plain_s[name] = r_s
        tol = {x: kw[x] for x in ("rtol", "atol")}
        if name == "rob":
            same = {lanes: _same_record(k, FE._launch(
                R[name], span, y0, kw["method"], None, None, tol["rtol"],
                tol["atol"], None, 100_000, False, None, lanes, None, p, None,
                rows)[0]) for lanes in (1, 4, 8, 16, 32)}
            text = f"1 / 4 / 8 / 16 / 32 lanes {same}"
        elif name == "osc":
            same = {lanes: _same_record(k, FN._launch(
                R[name], span, y0, kw["method"], tol["rtol"], tol["atol"],
                None, 100_000, False, None, lanes, None, p, rows)[0])
                for lanes in (1, 2, 4, 8)}
            text = f"1 / 2 / 4 / 8 lanes {same}"
            # the params build without the record: the plain version and
            # the other body
            # (dense leaves the plain version's outputs as they are)
            kp, _, dyp, _ = hold_against_plain(
                "adjoint routes", "osc params", lambda: off, lambda: r[:4],
                *AR_KERNEL_GATES[label])
            hold_small_lanes("fused_rkn", "osc params", R[name], span, y0,
                             kw, kp, shape)
            errs[name] = max(dy, dyp)
        else:
            mod = FEG if name == "rd" else FNG
            built = mod._kernel(kw["method"], R[name], *(
                (None, True) if name == "rd" else (True,)))
            n_arg = () if name == "rd" else (WAVE_N,)
            gkw = dict(tol, params=p, dense=rows)
            if name == "rd":
                gkw["method"] = kw["method"]
            threads = ops.fused_erk_grid.grid_threads(y0.shape[1]
                                                      // (1 if name == "rd"
                                                          else 2))
            runs = {s: mod._launch(built, span, y0, *n_arg, shape=s,
                                   **gkw)[0]
                    for s in ((32, mod.WARP_MEMBERS), (32, 0),
                              (threads, 0))}
            same = {s: _same_record(k, runs[s]) for s in runs
                    if s == tuple(shape)}
            same["warp = block of 32"] = _same_record(
                runs[(32, mod.WARP_MEMBERS)], runs[(32, 0)])
            for s, o in runs.items():
                if s != tuple(shape):
                    hold_against_plain(
                        "adjoint routes",
                        f"{label} dense, {grid_shape_text(s, y0.shape[0])}",
                        lambda o=o: o, lambda: r, *AR_KERNEL_GATES[label])
            text = (f"the rule's shape "
                    f"{grid_shape_text(shape, y0.shape[0])}; {same}")
            if name == "wave":
                kp, _, dyp, _ = hold_against_plain(
                    "adjoint routes", "wave params", lambda: off,
                    lambda: r[:4], *AR_KERNEL_GATES[label])
                hold_grid_shapes("fused_rkn_grid", "wave params", R[name],
                                 span, y0, kw, kp, shape, r[:4],
                                 AR_KERNEL_GATES[label])
                errs[name] = max(dy, dyp)
        print(f"{wrapper.__name__} [{label} dense, {y0.shape[0]}]: outputs "
              f"and records bit-identical across shapes: {text}; outputs "
              f"bit-identical to dense=None {same_off}")
        check(all(same.values()), f"{label}: a launch shape differs")
    return errs, plain_s


def adjoint_routes_path():
    """The ESDIRK and RKN routes of solve_fused_adjoint on the card: the
    four kernels with their records (and B5's and B6's params) against
    their plain versions at every launch shape; each route's value and
    gradient, its forward one launch of its kernel, against its reference
    (module comment above); the record overflow's NaN gradients per route;
    the backward's attempts, ms an attempt and host syncs; the forward
    launches' device ms with and without the record, the record's bytes,
    the bounds.  Returns each kernel's ``_adjoint_routes`` keys by its
    ``kernels`` name."""
    from extensisq_tpu_torch import KC4I, sensitivity
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops import fused_esdirk as FE
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn as FN
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    from extensisq_tpu_torch.ops.fused_esdirk import _esdirk_consts
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts
    start = time.perf_counter()
    R = adjoint_routes_rhs()
    inp = adjoint_routes_inputs()
    errs, plain_s = adjoint_routes_kernel_checks(R, inp)
    wrappers = {name: getattr(ops, "solve_" + kind)
                for name, kind in AR_KIND.items()}
    every = [getattr(ops, k) for k in dir(ops) if k.startswith("solve_fused_")
             and hasattr(getattr(ops, k), "launches")]

    def counted(fn, wrapper):
        for w in every:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        others = {w.__name__: w.launches for w in every
                  if w is not wrapper and w.launches}
        check(not others, f"adjoint routes: other kernels launched {others}")
        return out, wrapper.launches

    def loss_of(name, yf):
        if name == "rob":
            return yf[:, 0].sum()
        if name == "rd":
            return yf.mean(1).sum()
        if name == "osc":
            return yf[:, 0].sum()
        return yf[:, WAVE_N // 4].sum()

    def grad(name, dense=None, members=None):
        """(value, dL/dt0, dL/dtf, dL/dy0, dL/dp) of the route's loss."""
        y0, p = inp[name]
        sl = slice(None, members)
        kw = _route_kw(name)
        t0_, tf_ = (torch.tensor(x, device="cuda", requires_grad=True)
                    for x in AR_SPAN[name])
        Y = y0[sl].clone().requires_grad_(True)
        P = p[sl].clone().requires_grad_(True)
        yf = ops.solve_fused_adjoint(
            R[name], (t0_, tf_), Y, P, kw["method"], kw["rtol"], kw["atol"],
            100_000, None, AR_DENSE[name] if dense is None else dense,
            layout="grid" if name in ("rd", "wave") else "flat")
        val = loss_of(name, yf)
        return (val.detach(),) + torch.autograd.grad(val, (t0_, tf_, Y, P))

    res, launches, bw = {}, {}, {}
    for name in ("rob", "rd", "osc", "wave"):
        res[name], launches[name] = counted(lambda: grad(name),
                                            wrappers[name])
        check(launches[name] == 1, f"{name}: {wrappers[name].__name__} "
              f"launched {launches[name]} times, expected 1")
        bw[name] = ops.solve_fused_adjoint.last_backward
        check(all(bool(torch.isfinite(g).all()) for g in res[name][1:]),
              f"{name}: a gradient is not finite")

    # ESDIRK flat: against 7a's forward sensitivities and the f64 driver
    y0, p = inp["rob"]
    _, Sp, _, st, _, _ = ops.solve_fused_sens(
        R["rob"], SENS_ROB_SPAN, y0, params=p, **_route_kw("rob"))
    check(bool((st == 1).all()), "rob: a sensitivity run did not finish")
    gp, ref = res["rob"][4], Sp[:, 0, :]
    d_rob = ((gp - ref).abs().amax(0) / ref.abs().amax(0)).max().item()
    t0 = time.perf_counter()
    v0 = y0[0].double().requires_grad_(True)
    yf64 = sensitivity.solve_final(
        lambda t, y, q: robertson_p(t, y, (q[0], q[1], q[2])), SENS_ROB_SPAN,
        v0, p[0].double(), KC4I, max_steps=100_000, **AR_F64_TOL)
    gref, = torch.autograd.grad(yf64[0], v0)
    f64_s = time.perf_counter() - t0
    d_rob_y0 = _scaled(res["rob"][3][0].double(), gref)
    print(f"adjoint ESDIRK flat, Robertson x{SENS_ROB_N} (TRBDF2, k 3, dense "
          f"{AR_ROB_DENSE}): launches of B2 {launches['rob']}, loss "
          f"{float(res['rob'][0]):.6f}; dL/dp vs solve_fused_sens S_p[:, 0,"
          f" :], each column over its largest entry: {d_rob:.3e} (gate "
          f"{AR_SENS_GATE:.0e}); member 0's dL/dy0 vs the f64 solve_final "
          f"(KC4I, rtol 1e-9, {f64_s:.1f} s): {d_rob_y0:.3e} (gate "
          f"{AR_F64_GATE:.0e})")
    check(d_rob <= AR_SENS_GATE, "rob: dL/dp off solve_fused_sens")
    check(d_rob_y0 <= AR_F64_GATE, "rob: dL/dy0 off the f64 solve_final")

    # ESDIRK grid: against solve_fused_sens(layout="grid")
    y0, kd = inp["rd"]
    _, Sg, _, st, _, _ = ops.solve_fused_sens(
        R["rd"], SG_RD_SPAN, y0, params=kd, layout="grid",
        **_route_kw("rd"))
    check(bool((st == 1).all()), "rd: a sensitivity run did not finish")
    # over the largest entry: D leaves the mean of the Neumann line as it
    # is, so its column is round-off in both
    ref = Sg.mean(1)
    d_rd = _scaled(res["rd"][4], ref)
    print(f"adjoint ESDIRK grid, reaction-diffusion x{SG_RD_M} (n {SG_RD_N},"
          f" TRBDF2, k 2, dense {AR_RD_DENSE}): launches of B7 "
          f"{launches['rd']}, loss {float(res['rd'][0]):.6f}; dL/dp vs "
          f"solve_fused_sens(layout='grid'), over the largest entry: "
          f"{d_rd:.3e} (gate {AR_GRID_GATE:.0e})")
    check(d_rd <= AR_GRID_GATE, "rd: dL/dp off solve_fused_sens")

    # RKN flat: the closed forms
    _, ws = inp["osc"]
    w, tf = ws[:, 0].double(), AR_OSC_SPAN[1]
    d_w = (res["osc"][4][:, 0].double() + tf * torch.sin(w * tf)).abs().max()
    d_u = (res["osc"][3][:, 0].double() - torch.cos(w * tf)).abs().max()
    print(f"adjoint RKN flat, oscillators x{AR_OSC_N} (Fi5N, dense "
          f"{AR_OSC_DENSE}): launches of B5 {launches['osc']}; dL/dw vs "
          f"-tf sin(w tf) max |d| {float(d_w):.3e}, dL/du0 vs cos(w tf) "
          f"{float(d_u):.3e} (gate {AR_CLOSED_GATE:.0e})")
    check(max(float(d_w), float(d_u)) <= AR_CLOSED_GATE,
          "osc: gradients off the closed forms")

    # RKN grid: central differences of B6 with params
    y0, c2 = inp["wave"]
    eps = AR_WAVE_FD_REL * c2
    kw = dict(method=_route_kw("wave")["method"], **AR_WAVE_FD_TOL)
    yp = ops.solve_fused_rkn_grid(R["wave"], AR_WAVE_SPAN, y0, params=c2 + eps,
                                  **kw)
    ym = ops.solve_fused_rkn_grid(R["wave"], AR_WAVE_SPAN, y0, params=c2 - eps,
                                  **kw)
    check(bool((yp[1] == 1).all() and (ym[1] == 1).all()),
          "wave: a central-difference run did not finish")
    i4 = WAVE_N // 4
    fd = (yp[0][:, i4] - ym[0][:, i4]) / (2 * eps[:, 0])
    d_wave = _scaled(res["wave"][4][:, 0], fd)
    print(f"adjoint RKN grid, wave x{WAVE_M} (n {WAVE_N}, Fi5N, dense "
          f"{AR_WAVE_DENSE}): launches of B6 {launches['wave']}; dL/dc2 vs "
          f"central differences of B6 with params (eps 1% of c2, "
          f"compensated, rtol 1e-8): max |d| / max |FD| {d_wave:.3e} (gate "
          f"{AR_FD_GATE:.0e})")
    check(d_wave <= AR_FD_GATE, "wave: dL/dc2 off central differences")

    # the overflow: 3 rows a member, NaN gradients on every route
    for name in ("rob", "rd", "osc", "wave"):
        ovf = grad(name, dense=3, members=8)
        nan_all = all(bool(torch.isnan(g).all()) for g in ovf[3:])
        print(f"adjoint routes overflow [{name}] (dense 3, 8 members): "
              f"every dL/dy0 and dL/dp NaN {nan_all}")
        check(nan_all, f"{name} overflow: finite gradients")

    # readings: the backward (attempts, ms an attempt, host syncs), the
    # walls, the forward launches with and without the record, the bounds
    out = {}
    for name in ("rob", "rd", "osc", "wave"):
        y0, p = inp[name]
        kw = _route_kw(name)
        g_ms = wall_ms(lambda: grad(name), reps=3)
        yf = ops.solve_fused_adjoint(
            R[name], AR_SPAN[name], y0.clone().requires_grad_(True), p,
            kw["method"], kw["rtol"], kw["atol"], dense=AR_DENSE[name],
            layout="grid" if name in ("rd", "wave") else "flat")
        _, n_sync, sec, _ = count_syncs(
            lambda: loss_of(name, yf).backward())
        b = ops.solve_fused_adjoint.last_backward
        att = int((b.nsteps + b.nfailed).max())
        print(f"adjoint routes backward [{name}]: {sec * 1e3:.1f} ms wall, "
              f"{att} attempts of the f64 driver ({b.y.shape[0]} members of "
              f"{b.y.shape[1]} rows, {bw[name].status.eq(1).all().item()} "
              f"all finished), {sec * 1e3 / att:.3f} ms an attempt, "
              f"{n_sync} host syncs ({n_sync / att:.2f} an attempt)")
        wrapper = wrappers[name]
        fwd = wrapper(R[name], AR_SPAN[name], y0, params=p, **kw)
        shape = wrapper.last_shape
        mod = {"rob": FE, "rd": FEG, "osc": FN, "wave": FNG}[name]
        if name == "rob":
            builds = [mod._kernel(kw["method"], R[name], None, None, None,
                                  3, 3, rec) for rec in (True, False)]
        elif name == "rd":
            builds = [mod._kernel(kw["method"], R[name], None, rec)
                      for rec in (True, False)]
        else:
            builds = [mod._kernel(kw["method"], R[name], rec)
                      for rec in (True, False)]
        tol = {x: kw[x] for x in ("rtol", "atol")}
        on_ms, rec = launch_ms(AR_KIND[name], builds[0], y0, p,
                               AR_SPAN[name], tol, shape, AR_DENSE[name])
        off_ms, _ = launch_ms(AR_KIND[name], builds[1], y0, p,
                              AR_SPAN[name], tol, shape, 0)
        nb, n = y0.shape
        rows = int(rec.n.sum())
        rec_bytes = 4 * (rows * (2 * n + 1) + nb * (n + 1))
        by = 4 * nb * (2 * n + p.shape[1] + 3) + rec_bytes
        nfev = int(fwd[3].sum())
        if name == "rob":
            ops_ = nfev * AR_ROB_OPS
        elif name == "rd":
            ops_ = esdirk_grid_ops(SG_RD_N, _esdirk_consts(kw["method"]),
                                   SG_RHS_OPS["rd"], nfev - nb,
                                   int(fwd[2].sum()),
                                   3 * SG_RHS_OPS["rd_band"])
        else:
            m = n // 2
            ops_ = rk_ops(rkn_consts(kw["method"]), True, m,
                          AR_ACC_OPS[name], nfev, nb, 2 + min(n + 1, 3))
        bound = bound_entry(by, ops_)
        print(f"time [adjoint route {name}, {wrapper.__name__}] {nb} "
              f"members: {g_ms:.3f} ms wall (value and gradient, median of "
              f"3); the forward launch {on_ms:.4f} ms device with the "
              f"record, {off_ms:.4f} ms without it (CUDA events, ten "
              f"launches back to back); the record {rows} rows, "
              f"{rec_bytes} bytes; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}); plain version "
              f"{plain_s[name] * 1e3:.1f} ms wall")
        out[AR_KIND[name]] = {
            "launches_adjoint_routes": launches[name],
            "max_abs_err_adjoint_routes": errs[name],
            "ms_adjoint_routes": g_ms,
            "device_ms_adjoint_routes": on_ms,
            "device_ms_adjoint_routes_no_record": off_ms,
            "record_bytes_adjoint_routes": rec_bytes,
            "plain_ms_adjoint_routes": plain_s[name] * 1e3,
            "bound_ms_adjoint_routes": bound["bound_ms"],
            "bound_by_adjoint_routes": bound["bound_by"],
            "backward_attempts_adjoint_routes": att,
            "backward_ms_per_attempt_adjoint_routes": sec * 1e3 / att,
            "backward_syncs_adjoint_routes": n_sync}
    print(f"adjoint routes phase: {time.perf_counter() - start:.1f} s")
    return out


# -- the SWAG routes of the continuous adjoint --------------------------------
# solve_fused_adjoint(method=SWAG) through B3 (flat) and B8 (grid), each
# forward one launch with params and the dense record, a static t_span:
# * vdp1024-grad-swag-adjoint: config 7b's ensemble (validation/
#   benchmarks.py:838-871; 1,024 Van der Pol members, y0 = (2, 0), mu in
#   [1, 2] a member, t in [0, 3]) at the settings of JAX's SWAG adjoint
#   test (tests/test_fused_adjoint.py:270-301: rtol 1e-5 / atol 1e-8,
#   k_max 6); dL/dmu of sum(y_f[:, 0]) against central differences (eps
#   1e-2) of B3 with params at the same settings, two launches (every
#   member's mu up, then down), within JAX's 2e-2 of max(max |FD|, 1);
# * heat256x32-swag-adjoint-grid: config 2d's line (`:221-259`; the
#   periodic heat MoL, n = 256, dx = 1/256, 32 members, y0 = a_b sin(2 pi
#   x) + 0.3 cos(4 pi x), a_b in [0.5, 1.5], k_max 6 at rtol 1e-4 / atol
#   1e-6, t in [0, 0.25]) with the diffusivity D_b in [0.005, 0.015] a
#   member; L = sum_b sum_i y_f[b, i] sin(2 pi x_i), whose gradients the
#   semi-discrete solution gives: with lam_1 = (2 / dx sin(pi / n))^2,
#   dL/dD_b = -lam_1 T a_b (n / 2) exp(-D_b lam_1 T) and dL/dy0[b, i] =
#   exp(-D_b lam_1 T) sin(2 pi x_i), each over its largest entry.
# The records take about 1.3x the slowest member's attempts (69 and 684 of
# the plain versions on the CPU)
AD_VDP_TOL = dict(rtol=1e-5, atol=1e-8, k_max=6)
AD_VDP_DENSE = 96
AD_FD_EPS = 1e-2
AD_FD_GATE = 2e-2
AD_HEAT_N, AD_HEAT_M = 256, 32
AD_HEAT_SPAN = (0.0, 0.25)
AD_HEAT_TOL = dict(rtol=1e-4, atol=1e-6, k_max=6)
AD_HEAT_DENSE = 896
# the gradients of the grid route against the closed form, over their
# largest entries: dL/dD and dL/dy0, measured 1.037e-6 and 2.777e-4 on an
# H100 (NVIDIA H100 80GB HBM3, 700 W; tools/probe_sens.py --adams); gates
# about 4x, within JAX's 2e-2
AD_CLOSED_GATES = (4e-6, 1.1e-3)
# the kernels with params and their records against the plain versions on
# the card, as AR_KERNEL_GATES and AR_DENSE_GATES: (max |dy|, relative
# difference of mean nsteps, max |dnsteps|) and (the dense outputs at 97
# common times, the kernel's nodes against the plain version's dense
# output).  Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W;
# tools/probe_sens.py --adams): vdp 1.035e-4, 2.37e-4, 7 and 1.080e-4,
# 1.009e-4 (186 of 1,024 members with other counts); heat 3.406e-4,
# 8.54e-4, 43 and 1.621e-3, 1.480e-3 (every member: the heat's SWAG steps
# sit at its stability limit, where the card's contraction and powf move
# them, as on config 2d's line, MID_KERNEL_GATES' heat2d).  Gates 3-5x the
# readings
AD_KERNEL_GATES = {"vdp": (4e-4, 1e-3, 21), "heat": (1.4e-3, 3.4e-3, 130)}
AD_DENSE_GATES = {"vdp": (4e-4, 4e-4), "heat": (6.5e-3, 6e-3)}
# the heat line's right-hand side per element: (roll - 2 y + roll), times
# D and the constant: 5 operations
AD_HEAT_OPS = 5


def heat_p(n):
    """The periodic heat MoL with the diffusivity a member's parameter."""
    c = float(n * n)

    def fun(t, y, p):
        return p[0] * (torch.roll(y, 1, 0) - 2 * y + torch.roll(y, -1, 0)) \
            * c
    return fun


def _heat_p_cuda(n):
    return ("__device__ float rhs(float t, const float* y, int i, "
            "const float* p) {\n  using G = tab::G;\n"
            "  return p[0] * (G::rolled<0>(y, i, 1) - 2.0f * y[i] + "
            f"G::rolled<0>(y, i, -1)) * {_lit(n * n)};\n}}")


def adams_routes_rhs():
    """The SWAG routes' right-hand sides: 7b's Van der Pol with mu a member
    (the sensitivity phase's) and the heat MoL with D a member."""
    from extensisq_tpu_torch.ops import FusedGridRHS
    return {"vdp": sens_rhs()["vdp"],
            "heat": FusedGridRHS(heat_p(AD_HEAT_N), _heat_p_cuda(AD_HEAT_N),
                                 (AD_HEAT_N,), 1)}


def adams_routes_builds(rhs):
    """(kernel, label, rhs, k_max) of the phase's variants: B3 and B8 with
    params, with and without the dense record."""
    return [("fused_adams_rec", "vdp params dense", rhs["vdp"], 6),
            ("fused_adams", "vdp params", rhs["vdp"], 6),
            ("fused_adams_grid_rec", "heat params dense", rhs["heat"], 6),
            ("fused_adams_grid", "heat params", rhs["heat"], 6)]


def adams_routes_inputs():
    """The routes' members on the card: 7b's (y0, mu) and the heat line's
    (y0, D)."""
    y0b, mus = sens_inputs()[3:5]
    D = torch.linspace(0.005, 0.015, AD_HEAT_M, device="cuda")[:, None]
    return {"vdp": (y0b, mus), "heat": (heat_y0(AD_HEAT_M, AD_HEAT_N), D)}


AD_SPAN = {"vdp": SENS_VDP_SPAN, "heat": AD_HEAT_SPAN}
AD_TOL = {"vdp": AD_VDP_TOL, "heat": AD_HEAT_TOL}
AD_DENSE = {"vdp": AD_VDP_DENSE, "heat": AD_HEAT_DENSE}
AD_KIND = {"vdp": "fused_adams", "heat": "fused_adams_grid"}


def adams_routes_kernel_checks(R, inp):
    """B3 and B8 with params and their records against their plain
    versions on the card at the routes' widths; B3 at 1, 8, 16 and 32
    lanes against the rule's shape, records included, bit for bit; the
    record leaves y, status, nsteps and nfev as they are without it, and
    the params builds without it against the plain versions.  Returns the
    largest |dy| and the plain versions' seconds of each kernel."""
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops import fused_adams as FA
    errs, plain_s = {}, {}
    for name, kind in AD_KIND.items():
        wrapper = getattr(ops, "solve_" + kind)
        plain = getattr(ops, kind + "_reference")
        y0, p = inp[name]
        span, rows = AD_SPAN[name], AD_DENSE[name]
        kw = dict(AD_TOL[name], params=p, max_steps=100_000)
        k, r, dy, r_s = hold_against_plain(
            "adams routes", f"{name} params dense",
            lambda: wrapper(R[name], span, y0, dense=rows, **kw),
            lambda: plain(R[name], span, y0, dense=rows, **kw),
            *AD_KERNEL_GATES[name])
        hold_record(name, k, r, span, AD_DENSE_GATES[name])
        off = wrapper(R[name], span, y0, **kw)
        same_off = all(torch.equal(a, b) for a, b in zip(k[:4], off))
        check(same_off, f"{name}: the record changed the outputs")
        _, _, dyp, _ = hold_against_plain(
            "adams routes", f"{name} params", lambda: off, lambda: r[:4],
            *AD_KERNEL_GATES[name])
        errs[kind], plain_s[kind] = max(dy, dyp), r_s
        text = "one block a member"
        if name == "vdp":
            shape = ops.solve_fused_adams.last_shape
            same = {lanes: _same_record(k, FA._launch(
                R[name], span, y0, kw["rtol"], kw["atol"], None,
                kw["k_max"], kw["max_steps"], False, None, lanes, None, p,
                rows)[0]) for lanes in (1, 8, 16, 32) if lanes != shape[0]}
            text = (f"the rule's {shape_text(ops.solve_fused_adams, len(y0))}"
                    f"; 1 / 8 / 16 / 32 lanes {same}")
            check(all(same.values()), f"{name}: a lane shape differs")
        print(f"{wrapper.__name__} [{name} params dense, {y0.shape[0]}]: "
              f"outputs and records bit-identical across shapes: {text}; "
              f"outputs bit-identical to dense=None {same_off}")
    return errs, plain_s


def adams_start(kind, fun, y0, params, span, tol):
    """The members' start of a B3 or B8 (``kind``) launch, from the float32
    stepper's init on ``fun`` with ``params`` bound, as the wrappers run
    it: (f(t0, y0), h0, nfev0, direction)."""
    from extensisq_tpu_torch.ops import fused_adams as FA
    from extensisq_tpu_torch.ops import fused_adams_grid as FAG
    from extensisq_tpu_torch.ops.fused_erk import bind_params
    if kind == "fused_adams_grid":
        return FAG._start(fun, span, y0, tol["rtol"], tol["atol"], None,
                          tol["k_max"], None, params)
    _, s0, direction = FA._host_init(bind_params(fun, params), span, y0.T,
                                     tol["rtol"], tol["atol"], None,
                                     tol["k_max"], None)
    return (s0.yp.T.contiguous(), s0.h.contiguous(), s0.nfev.contiguous(),
            direction)


def adams_launch_ms(kind, built, fun, y0, params, span, tol, shape, rows,
                    reps=10):
    """Device ms of one launch of B3 or B8 (``kind``, its wrapper's module)
    with the record of ``rows`` a member (0: the build without it), the
    float32 init run and the outputs allocated before: CUDA events around
    ``reps`` launches back to back, per launch, median of REPS; and the
    DenseRecord written."""
    from extensisq_tpu_torch.ops.fused_erk import DenseRecord
    from extensisq_tpu_torch.ops.fused_erk_grid import grid_threads
    nb, n = y0.shape
    yp0, h0, nfev0, direction = adams_start(kind, fun, y0, params, span,
                                            tol)
    out = (torch.empty_like(y0),
           *[torch.empty(nb, dtype=torch.int32, device="cuda")
             for _ in range(3)])
    rec = DenseRecord(y0, rows)
    scal = (nb, float(np.float32(span[0])), float(np.float32(span[1])),
            direction, float(np.float32(tol["rtol"])),
            float(np.float32(tol["atol"])), np.inf, 100_000)
    ptrs = [x.data_ptr() for x in out]
    if kind == "fused_adams":
        work = torch.empty(nb, 5, dtype=torch.int32, device="cuda")
        args = ((y0.data_ptr(), params.data_ptr(), yp0.data_ptr(),
                 h0.data_ptr(), nfev0.data_ptr(), *ptrs, work.data_ptr())
                + scal + (0,) + tuple(shape))
    else:
        args = ((y0.data_ptr(), yp0.data_ptr(), h0.data_ptr(),
                 nfev0.data_ptr(), params.data_ptr(), *ptrs) + scal
                + (grid_threads(n),))
    fn = getattr(built.lib, f"{kind}{'_record' if rows else ''}_launch")
    stream = torch.cuda.current_stream().cuda_stream
    args = args + (rec.args() if rows else ())

    def run():
        for _ in range(reps):
            check(fn(*args, stream) == 0, f"{kind}: launch failed")
    return event_ms(run) / reps, rec


def adams_routes_path():
    """The SWAG routes of solve_fused_adjoint on the card: B3 and B8 with
    params and their records against their plain versions (B3 at every lane
    shape); each route's value and gradient, its forward one launch of its
    kernel, against its reference (module comment above); the record
    overflow's NaN gradients; the backward's attempts, ms an attempt and
    host syncs; the forward launches' device ms with and without the
    record, the record's bytes, the bounds.  Returns each kernel's
    ``_adams_routes`` keys by its ``kernels`` name."""
    from extensisq_tpu_torch import SWAG
    from extensisq_tpu_torch import ops
    from extensisq_tpu_torch.ops import fused_adams as FA
    from extensisq_tpu_torch.ops import fused_adams_grid as FAG
    start = time.perf_counter()
    R = adams_routes_rhs()
    inp = adams_routes_inputs()
    errs, plain_s = adams_routes_kernel_checks(R, inp)
    every = [getattr(ops, k) for k in dir(ops) if k.startswith("solve_fused_")
             and hasattr(getattr(ops, k), "launches")]
    x = torch.arange(AD_HEAT_N, device="cuda") / AD_HEAT_N
    w_heat = torch.sin(2 * np.pi * x)

    def loss_of(name, yf):
        return yf[:, 0].sum() if name == "vdp" else (yf * w_heat).sum()

    def grad(name, dense=None, members=None):
        """(value, dL/dy0, dL/dp) of the route's loss."""
        y0, p = inp[name]
        sl = slice(None, members)
        tol = AD_TOL[name]
        Y = y0[sl].clone().requires_grad_(True)
        P = p[sl].clone().requires_grad_(True)
        yf = ops.solve_fused_adjoint(
            R[name], AD_SPAN[name], Y, P, SWAG, tol["rtol"], tol["atol"],
            100_000, None, AD_DENSE[name] if dense is None else dense,
            layout="grid" if name == "heat" else "flat", k_max=tol["k_max"])
        val = loss_of(name, yf)
        return (val.detach(),) + torch.autograd.grad(val, (Y, P))

    res, launches, walls = {}, {}, {}
    for name, kind in AD_KIND.items():
        wrapper = getattr(ops, "solve_" + kind)
        for w in every:
            w.launches = 0
        t0 = time.perf_counter()
        res[name] = grad(name)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        others = {w.__name__: w.launches for w in every
                  if w is not wrapper and w.launches}
        launches[name] = wrapper.launches
        check(not others, f"adams routes: other kernels launched {others}")
        check(launches[name] == 1, f"{name}: {wrapper.__name__} launched "
              f"{launches[name]} times, expected 1")
        check(all(bool(torch.isfinite(g).all()) for g in res[name][1:]),
              f"{name}: a gradient is not finite")

    # flat: central differences of B3 with params, two launches
    y0, mus = inp["vdp"]
    kw = dict(AD_VDP_TOL, max_steps=100_000)
    yp, ym = (ops.solve_fused_adams(R["vdp"], SENS_VDP_SPAN, y0,
                                    params=mus + s, **kw)
              for s in (AD_FD_EPS, -AD_FD_EPS))
    check(bool((yp[1] == 1).all() and (ym[1] == 1).all()),
          "vdp: a central-difference run did not finish")
    fd = (yp[0][:, 0] - ym[0][:, 0]) / (2 * AD_FD_EPS)
    scale = max(fd.abs().max().item(), 1.0)
    d_fd = (res["vdp"][2][:, 0] - fd).abs().max().item() / scale
    print(f"adjoint SWAG flat, Van der Pol x{SENS_VDP_N} (k_max 6, dense "
          f"{AD_VDP_DENSE}): launches of B3 {launches['vdp']}, loss "
          f"{float(res['vdp'][0]):.6f}; dL/dmu vs central differences of B3 "
          f"with params (eps {AD_FD_EPS:g}): max |d| / max(max |FD|, 1) "
          f"{d_fd:.3e} (gate {AD_FD_GATE:.0e})")
    check(d_fd <= AD_FD_GATE, "vdp: dL/dmu off central differences")

    # grid: the closed form
    _, D = inp["heat"]
    T = AD_HEAT_SPAN[1]
    lam = (2.0 * AD_HEAT_N * np.sin(np.pi / AD_HEAT_N)) ** 2
    amps = torch.linspace(0.5, 1.5, AD_HEAT_M, device="cuda").double()
    decay = torch.exp(-D[:, 0].double() * lam * T)
    d_D = _scaled(res["heat"][2][:, 0].double(),
                  -lam * T * amps * (AD_HEAT_N / 2) * decay)
    d_y0 = _scaled(res["heat"][1].double(),
                   decay[:, None] * w_heat.double()[None, :])
    print(f"adjoint SWAG grid, heat x{AD_HEAT_M} (n {AD_HEAT_N}, k_max 6, "
          f"dense {AD_HEAT_DENSE}): launches of B8 {launches['heat']}; "
          f"against the semi-discrete closed form, over the largest entry: "
          f"dL/dD {d_D:.3e}, dL/dy0 {d_y0:.3e} (gates "
          f"{AD_CLOSED_GATES[0]:.0e}, {AD_CLOSED_GATES[1]:.1e})")
    check(d_D <= AD_CLOSED_GATES[0] and d_y0 <= AD_CLOSED_GATES[1],
          "heat: gradients off the closed form")

    # the overflow: 3 rows a member, NaN gradients on both routes
    for name in AD_KIND:
        ovf = grad(name, dense=3, members=8)
        nan_all = all(bool(torch.isnan(g).all()) for g in ovf[1:])
        print(f"adams routes overflow [{name}] (dense 3, 8 members): every "
              f"dL/dy0 and dL/dp NaN {nan_all}")
        check(nan_all, f"{name} overflow: finite gradients")

    # readings: the warm wall, the backward (attempts, ms an attempt, host
    # syncs), the forward launches with and without the record, the bounds
    out = {}
    for name, kind in AD_KIND.items():
        wrapper = getattr(ops, "solve_" + kind)
        mod = FA if name == "vdp" else FAG
        y0, p = inp[name]
        tol = AD_TOL[name]
        g_ms = wall_ms(lambda: grad(name), reps=3)
        yf = ops.solve_fused_adjoint(
            R[name], AD_SPAN[name], y0.clone().requires_grad_(True), p, SWAG,
            tol["rtol"], tol["atol"], 100_000, None, AD_DENSE[name],
            layout="grid" if name == "heat" else "flat", k_max=tol["k_max"])
        _, n_sync, sec, _ = count_syncs(lambda: loss_of(name, yf).backward())
        b = ops.solve_fused_adjoint.last_backward
        att = int((b.nsteps + b.nfailed).max())
        print(f"adams routes backward [{name}]: {sec * 1e3:.1f} ms wall, "
              f"{att} attempts of the f64 driver ({b.y.shape[0]} members of "
              f"{b.y.shape[1]} rows, {b.status.eq(1).all().item()} all "
              f"finished), {sec * 1e3 / att:.3f} ms an attempt, {n_sync} "
              f"host syncs ({n_sync / att:.2f} an attempt)")
        fwd = wrapper(R[name], AD_SPAN[name], y0, params=p,
                      max_steps=100_000, **tol)
        shape = (ops.solve_fused_adams.last_shape if name == "vdp"
                 else None)
        builds = [mod._kernel(R[name], tol["k_max"], rec)
                  for rec in (True, False)]
        on_ms, rec = adams_launch_ms(kind, builds[0], R[name], y0, p,
                                     AD_SPAN[name], tol, shape,
                                     AD_DENSE[name])
        off_ms, _ = adams_launch_ms(kind, builds[1], R[name], y0, p,
                                    AD_SPAN[name], tol, shape, 0)
        nb, n = y0.shape
        rows = int(rec.n.sum())
        rec_bytes = 4 * (rows * (2 * n + 1) + nb * (n + 1))
        start_fev = int(adams_start(kind, R[name], y0, p, AD_SPAN[name],
                                    tol)[2].sum())
        if name == "vdp":
            work = ops.solve_fused_adams.last_work.long().sum(0).tolist()
            ops_ = adams_ops(n, RHS_OPS["vdp"], False, work,
                             int(fwd[3].sum()) - start_fev)
            by = 4 * nb * (3 * n + p.shape[1] + 10) + rec_bytes
        else:
            ops_ = adams_grid_ops(n, tol["k_max"], AD_HEAT_OPS,
                                  int(fwd[3].sum()), int(fwd[2].sum()),
                                  start_fev)
            by = 4 * nb * (3 * n + p.shape[1] + 5) + rec_bytes
        bound = bound_entry(by, ops_)
        print(f"time [adams route {name}, {wrapper.__name__}] {nb} members: "
              f"{g_ms:.3f} ms wall (value and gradient, median of 3; the "
              f"first run {walls[name]:.3f} ms); the forward launch "
              f"{on_ms:.4f} ms device with the record, {off_ms:.4f} ms "
              f"without it (CUDA events, ten launches back to back); the "
              f"record {rows} rows, {rec_bytes} bytes; bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); plain "
              f"version {plain_s[kind] * 1e3:.1f} ms wall")
        out[kind] = {
            "launches_adams_routes": launches[name],
            "max_abs_err_adams_routes": errs[kind],
            "ms_adams_routes": g_ms,
            "device_ms_adams_routes": on_ms,
            "device_ms_adams_routes_no_record": off_ms,
            "record_bytes_adams_routes": rec_bytes,
            "plain_ms_adams_routes": plain_s[kind] * 1e3,
            "bound_ms_adams_routes": bound["bound_ms"],
            "bound_by_adams_routes": bound["bound_by"],
            "backward_attempts_adams_routes": att,
            "backward_ms_per_attempt_adams_routes": sec * 1e3 / att,
            "backward_syncs_adams_routes": n_sync}
    print(f"adams routes phase: {time.perf_counter() - start:.1f} s")
    return out


# -- the t_eval snapshots (B1, B4, B11, B12) and B11's and B12's params -------
# Four lines, each an earlier path's problem at its full size with points
# in its span: vdp4096-bs5-teval (B1: the main path's 4,096 Van der Pol
# members, mu = 3, t in [0, 10], with t_eval = linspace(0, 10, 101), plain
# at rtol 1e-4 and compensated at the official tolerances),
# fisher64x256-teval (B4: config 1b's 64 Fisher members at n = 256 with 11
# points), swdec1024-params-teval (B11: config 1c's 1,024 decay members
# with the switching frequency 3 a member's parameter, swept over [2.5,
# 3.5] with every 64th member at 3, 11 points) and
# ckmol64x256-params-teval (B12: the CKdisc MoL's 64 members at n = 256
# with the forcing amplitude 0.3 a member's parameter, swept over [0.2,
# 0.4] with every 16th member at 0.3, 11 points).
TE_N_EVAL = 101
TE_POINTS = 11
TE_DENSE = 256           # rows a member of the dense=R launch beside them
# each kernel's snapshot build against its plain version on the card: max
# |dy_eval| over the members whose counts equal the plain version's, and
# over every finished member (y itself keeps the gates of the line's
# earlier check).  nvcc's contraction moves h by last bits, and a member
# may take other steps; where a front of the relaxation oscillation
# passes a point, a last-bit shift of the trajectory in time moves the
# row by |y'| times it, and the cubic Hermite's own error, which the
# tolerance does not control, differs between step sequences.  Readings
# on an H100 (NVIDIA H100 80GB HBM3, 700 W; run DU), same counts /
# all: vdp plain 8.071e-2 / 1.775e-1 (the endpoints 1.269e-2), vdp
# compensated 3.464e-3 / 3.510e-3, fisher 1.571e-4 / 5.729e-4, swdec
# params 2.750e-3 / 1.190e-2, ckmol params 2.909e-4 / 6.861e-4.  The gates
# keep about 3x
TE_YEVAL_GATES = {"vdp plain": (2.5e-1, 5e-1),
                  "vdp compensated": (1e-2, 1e-2),
                  "fisher": (5e-4, 1.5e-3), "swdec params": (8e-3, 3.5e-2),
                  "ckmol params": (9e-4, 2e-3)}
# y_eval against the f64 solve_ensemble(..., t_eval=...) on the same
# members: plain against f64 at the same tolerances, compensated against
# f64 at rtol 1e-6 (the endpoints' gates 5e-2 and 1e-3, from the JAX
# package's fused tests, hold at tf; at the fronts inside the span the
# rows part more, as above).  Readings (run DU): plain 2.389e-1,
# compensated 3.520e-3; gates about 2x
TE_F64_GATES = {"plain": 5e-1, "compensated": 8e-3}
# sol(t_eval) of the dense=R launch against its own y_eval: both the cubic
# Hermite of the step crossing each point, summed in other orders (and
# ops/fused_dense.py's rounded in float32 torch ops); reading 9.537e-6
# (run DU), gate 4x
TE_DENSE_GATE = 4e-5
# members whose parameter is the k = 0 literal against the k = 0 run,
# bit for bit (readings 0 on B11 and B12, run DU)
TE_LITERAL_GATE = 0.0


def swdec_p(t, y, p):
    """Config 1c's decay with its switching frequency a member's
    parameter, rows-first."""
    sw = torch.where(torch.sin(p[0] * t) >= 0.0, 1.0, -1.0)
    return torch.stack([(-sw - 0.5) * y[0], (sw - 0.5) * y[1]])


def ck_mol_p(n):
    def fun(t, y, p):
        sw = torch.where(torch.sin(4.0 * t) >= 0.0, 1.0, -1.0)
        return -(y - torch.roll(y, 1, 0)) * float(n) + y * (1 - y) + p[0] * sw
    return fun


def _ck_mol_p_cuda(n):
    return ("__device__ float rhs(float t, const float* y, int i, "
            "const float* p) {\n  " + _sw_cuda(4.0) + "\n"
            f"  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {_lit(n)}\n"
            "         + y[i] * (1.0f - y[i]) + p[0] * sw;\n}")


def teval_rhs():
    """The phase's right-hand sides: the main path's Van der Pol, config
    1b's Fisher MoL, and the decay and the CKdisc MoL with a parameter."""
    from extensisq_tpu_torch.ops import FusedGridRHS, FusedRHS
    return {
        "vdp": FusedRHS(vdp, VDP_CUDA, 2),
        "fisher": rkn_grid_rhs()["fisher"],
        "swdec": FusedRHS(
            swdec_p, "__device__ void rhs(float t, const float* y, "
            "float* dy, const float* p) {\n"
            "  const float sw = sinf(p[0] * t) >= 0.0f ? 1.0f : -1.0f;\n"
            "  dy[0] = (-sw - 0.5f) * y[0];\n"
            "  dy[1] = (sw - 0.5f) * y[1];\n}", 2, 1),
        "ckmol": FusedGridRHS(ck_mol_p(CKMOL_N), _ck_mol_p_cuda(CKMOL_N),
                              (CKMOL_N,), 1)}


def teval_builds(rhs):
    """(kernel, label, rhs, method) of the phase's variants: the snapshot
    builds of B1 (with and beside the dense record), B4, B11 and B12 with
    params, and B11's and B12's params builds without them."""
    from extensisq_tpu_torch import BS5
    return [("fused_erk_snap", "vdp t_eval", rhs["vdp"], None),
            ("fused_erk_rec_snap", "vdp dense t_eval", rhs["vdp"], None),
            ("fused_erk_grid_snap", "fisher t_eval", rhs["fisher"], BS5),
            ("fused_ckdisc", "swdec params", rhs["swdec"], None),
            ("fused_ckdisc_snap", "swdec params t_eval", rhs["swdec"], None),
            ("fused_ckdisc_grid", "ckmol params", rhs["ckmol"], None),
            ("fused_ckdisc_grid_snap", "ckmol params t_eval", rhs["ckmol"],
             None)]


def teval_inputs():
    """Each line's (y0, params or None, span, tolerances, t_eval)."""
    f = np.float32
    fr = np.linspace(2.5, 3.5, CK_N)
    fr[::64] = 3.0
    amp = np.linspace(0.2, 0.4, CKMOL_M)
    amp[::16] = 0.3
    return {
        "vdp": (vdp_y0(N_MEMBERS, torch.float32), None, T_SPAN,
                np.linspace(*T_SPAN, TE_N_EVAL).astype(f)),
        "fisher": (fisher_y0(FISHER_M, FISHER_N), None, FISHER_SPAN,
                   np.linspace(*FISHER_SPAN, TE_POINTS).astype(f)),
        "swdec": (swdec_y0(torch.float32),
                  torch.tensor(fr[:, None], dtype=torch.float32,
                               device="cuda"), CK_SPAN,
                  np.linspace(*CK_SPAN, TE_POINTS).astype(f)),
        "ckmol": (fisher_y0(CKMOL_M, CKMOL_N),
                  torch.tensor(amp[:, None], dtype=torch.float32,
                               device="cuda"), CKMOL_SPAN,
                  np.linspace(*CKMOL_SPAN, TE_POINTS).astype(f))}


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _eval_err(k, r, same_counts=False):
    """max |dy_eval| between two runs over the members both finished (with
    ``same_counts``, and took the same nsteps and nfev)."""
    ok = (k[1] == 1) & (r[1] == 1)
    if same_counts:
        ok = ok & (k[2] == r[2]) & (k[3] == r[3])
    return (k[4][:, ok] - r[4][:, ok]).abs().max().item() if ok.any() else 0.0


def teval_kernel_checks(R, inp, runs):
    """Each line's snapshot launch ``runs[name]`` (and B1's compensated one)
    held against its plain version on the card (status, y and the counts
    at the line's earlier gates, y_eval at TE_YEVAL_GATES) and, bit for
    bit, against the launch without t_eval at every shape the rule can
    take: B1 at the rule's shape and compensated at 8 and 4 lanes, B4 at
    its blocks and the warp, B11 at 32, 16, 8 and 1 lanes, B12 at its
    three blocks, each shape's y_eval against the plain version's too; the
    members of B11 and B12 whose parameter is the k = 0 literal against the
    k = 0 run.  Returns each kernel's largest |dy| and |dy_eval|, and the
    plain versions' ms."""
    from extensisq_tpu_torch import BS5, ops
    from extensisq_tpu_torch.ops import fused_ckdisc as FC
    from extensisq_tpu_torch.ops import fused_ckdisc_grid as FCG
    from extensisq_tpu_torch.ops import fused_erk as FK
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    threads = FKG.grid_threads
    errs, plain_ms, plains = {}, {}, {}
    for name, label, tol, gates in (
            ("vdp", "vdp plain", PLAIN_TOL, (PLAIN_GATE, STEP_GATE)),
            ("vdp", "vdp compensated", COMP_TOL, (COMP_GATE, STEP_GATE)),
            ("fisher", "fisher", FISHER_TOL, RKN_KERNEL_GATES["fisher"]),
            ("swdec", "swdec params", CK_TOL, CK_KERNEL_GATES["swdec"]),
            ("ckmol", "ckmol params", CKMOL_TOL, CK_KERNEL_GATES["ckmol"])):
        y0, p, span, tq = inp[name]
        k = runs[label]
        kind = {"vdp": "fused_erk", "fisher": "fused_erk_grid",
                "swdec": "fused_ckdisc", "ckmol": "fused_ckdisc_grid"}[name]
        plain = getattr(ops, kind + "_reference")
        kw = dict(tol, params=p, t_eval=tq)
        if kind.startswith("fused_erk"):
            kw["method"] = BS5
        _, r, dy, r_s = hold_against_plain(
            "t_eval", f"{label} t_eval", lambda: k,
            lambda: plain(R[name], span, y0, **kw), *gates)
        plains[label] = r
        dq, dq_same = _eval_err(k, r), _eval_err(k, r, True)
        g_same, g_all = TE_YEVAL_GATES[label]
        print(f"t_eval kernel vs plain [{label}, {y0.shape[0]}, "
              f"{len(tq)} points]: max |dy_eval| over the members with the "
              f"plain version's counts {dq_same:.3e} (gate {g_same:.1e}), "
              f"over all {dq:.3e} (gate {g_all:.1e})")
        check(dq_same <= g_same and dq <= g_all, f"{label}: y_eval off the "
             "plain version")
        # the launch without t_eval at each shape, and the snapshot launch
        off_kw = dict(kw, t_eval=None)
        if kind == "fused_erk":
            shape = runs[label + " shape"]
            forced = [shape] + [(g, None) for g in (8, 4) if g != shape[0]
                                and tol.get("compensated")]

            def launch(s, kw_):
                return FK._launch(
                    R[name], span, y0, BS5, kw_["rtol"], kw_["atol"], None,
                    100_000, kw_.get("compensated", False), None, s[0], s[1],
                    None, None, kw_["t_eval"])[0]
        elif kind == "fused_ckdisc":
            forced = [(g, None) for g in (32, 16, 8, 1)]

            def launch(s, kw_):
                return FC._launch(R[name], span, y0, kw_["rtol"],
                                  kw_["atol"], None, 100_000, None, s[0],
                                  s[1], kw_["params"], kw_["t_eval"])[0]
        else:
            mod = FKG if kind == "fused_erk_grid" else FCG
            n = y0.shape[1]
            if kind == "fused_erk_grid":
                forced = [(threads(n), 0), (32, FKG.WARP_MEMBERS),
                          (threads(-(-n // 2)), 0)]
            else:
                forced = [(threads(n), 0), (threads(-(-n // 2)), 0),
                          (min(FCG.SMALL_THREADS, threads(n)), 0)]
            built = {True: (mod._kernel(BS5, R[name], False, True)
                            if mod is FKG else mod._kernel(R[name], True)),
                     False: (mod._kernel(BS5, R[name]) if mod is FKG
                             else mod._kernel(R[name]))}

            def launch(s, kw_):
                kw2 = {a: b for a, b in kw_.items() if a != "method"}
                return mod._launch(built[kw2["t_eval"] is not None], span,
                                   y0, y0.shape[1], shape=s, **kw2)[0]
        same, worst = {}, dq
        for s in forced:
            on, off = launch(s, kw), launch(s, off_kw)
            same[s] = _same(on[:4], off)
            worst = max(worst, _eval_err(on, r))
            check(torch.equal(on[1], r[1]), f"{label} at {s}: status")
        print(f"t_eval [{label}]: the four outputs bit for bit those without "
              f"t_eval at {same}; max |dy_eval| over the shapes {worst:.3e}")
        check(all(same.values()), f"{label}: t_eval changed the outputs")
        check(worst <= g_all, f"{label}: y_eval off at a "
             "shape")
        key = kind if label != "vdp compensated" else kind + "_comp"
        errs[key] = (max(dy, errs.get(key, (0.0, 0.0))[0]), worst)
        plain_ms[key] = r_s * 1e3
        if p is not None:
            # the members at the k = 0 literal against the k = 0 run
            lit = {"swdec": 3.0, "ckmol": 0.3}[name]
            at = (p[:, 0] == float(np.float32(lit))).nonzero()[:, 0]
            R0 = ckdisc_rhs()["swdec" if name == "swdec" else "ckmol"]
            wrapper = getattr(ops, "solve_" + kind)
            k0 = wrapper(R0, span, y0, **tol)
            d0 = max((k[0][at] - k0[0][at]).abs().max().item(),
                     float((k[2][at] != k0[2][at]).sum()))
            print(f"{label}: the {len(at)} members at the literal {lit} "
                  f"against the k = 0 run: max |dy| and differing nsteps "
                  f"{d0:.3e} (gate {TE_LITERAL_GATE:.0e})")
            check(d0 <= TE_LITERAL_GATE, f"{label}: the literal's members")
    return errs, plain_ms, plains


def teval_path():
    """The t_eval snapshots on the card: the four lines through the
    wrappers, each wrapper's count set to 0 just before and read just
    after (one launch a line, two for B1); each against its plain version
    and the launch without t_eval at every shape (teval_kernel_checks); B1
    against the f64 solve_ensemble(..., t_eval=...) and a dense=R launch's
    sol(t_eval) against its y_eval; each line's launch alone with and
    without t_eval (ten back to back, CUDA events) and its bound.  Returns
    each kernel's ``_teval`` keys by its ``kernels`` name."""
    from extensisq_tpu_torch import BS5, ops, solve_ensemble
    from extensisq_tpu_torch.ops import fused_ckdisc as FC
    from extensisq_tpu_torch.ops import fused_ckdisc_grid as FCG
    from extensisq_tpu_torch.ops import fused_erk as FK
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    start = time.perf_counter()
    R = teval_rhs()
    inp = teval_inputs()
    every = [getattr(ops, k) for k in dir(ops) if k.startswith("solve_fused_")
             and hasattr(getattr(ops, k), "launches")]

    def line(name, tol):
        y0, p, span, tq = inp[name]
        kind = {"vdp": "erk", "fisher": "erk_grid", "swdec": "ckdisc",
                "ckmol": "ckdisc_grid"}[name]
        kw = dict(tol, t_eval=tq)
        if p is not None:
            kw["params"] = p
        if kind.startswith("erk"):
            kw["method"] = BS5
        return getattr(ops, "solve_fused_" + kind)(R[name], span, y0, **kw)

    # the main path of the phase: the four lines through the wrappers
    for w in every:
        w.launches = 0
    t0 = time.perf_counter()
    runs = {"vdp plain": line("vdp", PLAIN_TOL)}
    runs["vdp plain shape"] = ops.solve_fused_erk.last_shape
    runs["vdp compensated"] = line("vdp", COMP_TOL)
    runs["vdp compensated shape"] = ops.solve_fused_erk.last_shape
    runs["fisher"] = line("fisher", FISHER_TOL)
    runs["swdec params"] = line("swdec", CK_TOL)
    runs["ckmol params"] = line("ckmol", CKMOL_TOL)
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = {w.__name__: w.launches for w in every if w.launches}
    expect = {"solve_fused_erk": 2, "solve_fused_erk_grid": 1,
              "solve_fused_ckdisc": 1, "solve_fused_ckdisc_grid": 1}
    print(f"t_eval path: {path_ms:.1f} ms for the four lines (first calls), "
          f"launches {launches}")
    check(launches == expect, f"t_eval path launched {launches}, expected "
         f"{expect}")
    for label in ("vdp plain", "vdp compensated", "fisher", "swdec params",
                  "ckmol params"):
        out = runs[label]
        check(len(out) == 5 and bool((out[1] == 1).all()),
             f"{label}: not every member finished")
        check(out[4].shape == (len(inp[label.split()[0]][3]),
                               *out[0].shape), f"{label}: y_eval's shape")
        check(bool(torch.isfinite(out[4]).all()), f"{label}: y_eval finite")
    errs, plain_ms, plains = teval_kernel_checks(R, inp, runs)

    # B1 against the f64 driver's t_eval output on the same members, and a
    # dense=R launch's sol(t_eval) against its own y_eval
    y0, _, span, tq = inp["vdp"]
    te = torch.tensor(tq, dtype=torch.float64, device="cuda")
    for mode, tol64 in (("plain", dict(rtol=1e-4, atol=1e-6)),
                        ("compensated", dict(rtol=1e-6, atol=1e-9))):
        out = runs["vdp " + mode]
        ref = solve_ensemble(vdp, span, y0.double(), method=BS5, t_eval=te,
                             **tol64)
        check(bool((ref.status == 1).all()), "f64 t_eval: not finished")
        rows64 = ref.y_eval.permute(1, 0, 2)
        d64 = (out[4].double() - rows64).abs().max()
        d_plain = (plains["vdp " + mode][4].double() - rows64).abs().max()
        print(f"t_eval vdp {mode} vs f64 solve_ensemble(t_eval) at rtol "
              f"{tol64['rtol']:g}: max |dy_eval| {d64.item():.3e} (gate "
              f"{TE_F64_GATES[mode]:.0e}); the plain version's "
              f"{d_plain.item():.3e}")
        check(d64.item() <= TE_F64_GATES[mode], f"vdp {mode}: y_eval off f64")
    dense = ops.solve_fused_erk(R["vdp"], span, y0, method=BS5, t_eval=tq,
                                dense=TE_DENSE, **PLAIN_TOL)
    check(_same(dense[:5], runs["vdp plain"]),
         "vdp: the record changed the outputs or y_eval")
    sol = dense[5]
    check(bool(sol.valid.all()), f"vdp dense: {TE_DENSE} rows too few")
    at = sol(torch.tensor(tq, device="cuda")).permute(2, 0, 1)
    d_sol = (at - dense[4]).abs().max().item()
    print(f"t_eval vdp plain with dense={TE_DENSE}: outputs and y_eval bit "
          f"for bit the launch without the record; sol(t_eval) vs y_eval "
          f"max |d| {d_sol:.3e} (gate {TE_DENSE_GATE:.0e})")
    check(d_sol <= TE_DENSE_GATE, "vdp: sol(t_eval) off y_eval")

    # readings: each line's wall through the wrapper, its launch alone with
    # and without t_eval, the rows' bytes, the bound
    builds = {
        "vdp plain": ("fused_erk", FK._kernel(BS5, R["vdp"], False, True),
                      FK._kernel(BS5, R["vdp"]), runs["vdp plain shape"]),
        "vdp compensated": ("fused_erk",
                            FK._kernel(BS5, R["vdp"], False, True),
                            FK._kernel(BS5, R["vdp"]),
                            runs["vdp compensated shape"]),
        "fisher": ("fused_erk_grid",
                   FKG._kernel(BS5, R["fisher"], False, True),
                   FKG._kernel(BS5, R["fisher"]),
                   ops.solve_fused_erk_grid.last_shape),
        "swdec params": ("fused_ckdisc", FC._kernel(R["swdec"], True),
                         FC._kernel(R["swdec"]),
                         ops.solve_fused_ckdisc.last_shape),
        "ckmol params": ("fused_ckdisc_grid", FCG._kernel(R["ckmol"], True),
                         FCG._kernel(R["ckmol"]),
                         ops.solve_fused_ckdisc_grid.last_shape)}
    tols = {"vdp plain": PLAIN_TOL, "vdp compensated": COMP_TOL,
            "fisher": FISHER_TOL, "swdec params": CK_TOL,
            "ckmol params": CKMOL_TOL}
    out_keys = {}
    for label, (kind, on_b, off_b, shape) in builds.items():
        name = label.split()[0]
        y0, p, span, tq = inp[name]
        tol = tols[label]
        ms = wall_ms(lambda: line(name, tol))
        on_ms = launch_ms(kind, on_b, y0, p, span, tol, shape, 0, tq=tq)[0]
        off_ms = launch_ms(kind, off_b, y0, p, span, tol, shape, 0)[0]
        out = runs[label]
        nb, n = y0.shape
        snap_bytes = len(tq) * nb * n * 4
        nfev = int(out[3].sum())
        if kind == "fused_erk":
            by = N_MEMBERS * (2 * 4 * 2 + 4 * 3)
            ops_ = nfev * OPS_PER_EVAL["fused_erk"]
        elif kind == "fused_erk_grid":
            by = FISHER_M * (FISHER_N * 4 * 2 + 4 * 3)
            ops_ = rk_ops(FK._fused_consts(BS5), False, FISHER_N,
                          RHS_OPS["fisher"], nfev, FISHER_M, 5)
        elif kind == "fused_ckdisc":
            by = CK_N * (2 * 4 * 2 + 4 * 4)
            ops_ = ck_ops(2, RHS_OPS["swdec"], nfev, CK_N, 5)
        else:
            by = CKMOL_M * (CKMOL_N * 4 * 2 + 4 * 4)
            ops_ = ck_ops(CKMOL_N, RHS_OPS["ckmol"], nfev, CKMOL_M, 5)
        bound = bound_entry(by + snap_bytes, ops_)
        key = kind if label != "vdp compensated" else kind + "_comp"
        print(f"time [t_eval {label}, {nb} members, {len(tq)} points]: "
              f"{ms:.3f} ms wall through the wrapper; the launch alone "
              f"{on_ms:.4f} ms device with t_eval, {off_ms:.4f} ms without "
              f"(CUDA events, ten launches back to back, the same shape); "
              f"rows {snap_bytes} bytes; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}); plain version {plain_ms[key]:.1f} "
              f"ms wall")
        suffix = "_teval" if label != "vdp compensated" else "_teval_comp"
        entry = out_keys.setdefault(kind, {})
        entry.update({
            "max_abs_err" + suffix: errs[key][0],
            "max_abs_err_y_eval" + suffix: errs[key][1],
            "ms" + suffix: ms, "device_ms" + suffix: on_ms,
            "device_ms_no_teval" + suffix: off_ms,
            "plain_ms" + suffix: plain_ms[key],
            "bound_ms" + suffix: bound["bound_ms"],
            "bound_by" + suffix: bound["bound_by"],
            "library_ms" + suffix: None})
    for kind in out_keys:
        out_keys[kind]["launches_teval"] = launches.get("solve_" + kind, 0)
    print(f"t_eval phase: {time.perf_counter() - start:.1f} s")
    return out_keys


# -- the t_eval snapshots of B5, B6, B2 and B7 --------------------------
# Five lines, each an earlier path's problem at its full size with points in
# its span, none cut: kepler2048-fi5n-teval (B5: config 3's 2,048 Kepler
# orbits, t in [0, 2 pi], plain at rtol 1e-5 and compensated at 1e-7, with
# t_eval = linspace(0, 2 pi, 101)), wave64x256-teval (B6: the wave line's
# 64 members at n = 256, t in [0, 4], plain and compensated, 11 points),
# pend4096-kv3i-teval (B2: the bench's 4,096 pendulum DAE members, t in
# [0, 10], 101 points; its plain version's and f64 driver's runs are
# esdirk_path's), beside it the Kaps DAE behind the hidden M (1,024
# members, TRBDF2, t in [0, 1], 11 points) and rdiff32x128-teval (B7:
# config 4d's 32 members at n = 128, t in [0, 1], plain and compensated,
# 11 points).
TR_KEP_DENSE = 256       # rows a member of B5's dense=R launch beside them
KAPS_N = 1024
KAPS_SPAN = (0.0, 1.0)
KAPS_TOL = dict(rtol=1e-4, atol=1e-6)
# each kernel's snapshot build against its plain version on the card: max
# |dy_eval| over the members whose counts equal the plain version's, and
# over every finished member and every shape (y keeps the gates of the
# line's earlier check).  nvcc's contraction moves h by last bits, and a
# member may take other steps, its rows then from other cubic Hermites.
# Readings on an H100 (NVIDIA H100 80GB HBM3, 700 W; run ED), same counts
# / all: kepler plain 7.392e-4 / 8.268e-4, compensated 3.511e-5 /
# 5.180e-5, wave plain 1.217e-3 / 1.908e-3, compensated 5.925e-5 /
# 8.094e-5 (at two elements a thread), pend 1.833e-3 / 3.101e-3, kaps
# 4.053e-6 / 3.290e-5, rdiff plain - / 8.637e-5 (at 64 threads) and
# compensated - / 7.492e-5 (every rdiff member takes other counts than the
# plain version: 4d's float32 steady-state tail, PERF.md §5, so the first
# gate there is the second).  The gates keep about 3x
TR_YEVAL_GATES = {"kepler plain": (2.2e-3, 2.5e-3),
                  "kepler compensated": (1.1e-4, 1.6e-4),
                  "wave plain": (3.6e-3, 6e-3),
                  "wave compensated": (1.8e-4, 2.5e-4),
                  "pend": (5.5e-3, 1e-2), "kaps hidden M": (1.2e-5, 1e-4),
                  "rdiff plain": (2.6e-4, 2.6e-4),
                  "rdiff compensated": (2.3e-4, 2.3e-4)}
# y itself against the plain version where no earlier check of the line
# has a gate: (max |dy|, relative mean nsteps, max |dnsteps|); rdiff
# compensated read 7.117e-5, 1.36e-2, 27 (ED), held at rd4d's gates
TR_KERNEL_GATES = {"rdiff compensated": MID_KERNEL_GATES["rd4d"]}
# y_eval against the f64 driver's t_eval rows on the same members: B5 plain
# and compensated against solve_ensemble(kepler, ...) at rtol 1e-9
# (readings 7.635e-4 and 5.131e-5, the plain versions' 7.293e-4 and
# 5.060e-5; ED), B2 on the pendulum's differential rows against the bench
# line's f64 run at the same tolerances (7.665e-2, the plain version's
# 7.667e-2: float32 at rtol 1e-4 over 700 steps of a swinging pendulum,
# its velocities' phase); gates about 3x
TR_F64_GATES = {"kepler plain": 2.3e-3, "kepler compensated": 1.5e-4,
                "pend": 0.25}
# sol(t_eval) of B5's dense=R launch against its own y_eval: both the cubic
# Hermite of the step crossing each point, summed in other orders (reading
# 2.086e-6, ED), gate 4x
TR_DENSE_GATE = 8e-6
# the hidden-M rows mapped to the Kaps problem's y against its exact
# solution (y0 = a^2 e^-2t, y1 = a e^-t): reading 2.635e-4 (ED; the
# endpoint's in esdirk_path 2.1e-4), gate 3x
TR_KAPS_EXACT_GATE = 8e-4


def teval_routes_rhs():
    """The phase's functions: the Kepler and wave accelerations, the
    pendulum and the hidden-M Kaps DAE, config 4d's reaction-diffusion."""
    R, E = rkn_grid_rhs(), esdirk_builds()
    return {"kepler": R["kepler"], "wave": R["wave"], "pend": E[2][2],
            "kaps": E[3][2], "rdiff": mid_rhs()["rdiff"]}


def teval_routes_builds(rhs):
    """(kernel, label, rhs, option) of the phase's snapshot builds: B5 (and
    beside the dense record), B6, B2 with the diagonal and with the hidden
    M, and B7."""
    from extensisq_tpu_torch import Fi5N, Kv3I, TRBDF2
    return [("fused_rkn_snap", "kepler t_eval", rhs["kepler"], Fi5N),
            ("fused_rkn_rec_snap", "kepler dense t_eval", rhs["kepler"],
             Fi5N),
            ("fused_rkn_grid_snap", "wave t_eval", rhs["wave"], Fi5N),
            ("fused_esdirk_snap", "pendulum t_eval", rhs["pend"],
             (Kv3I, M_PEND)),
            ("fused_esdirk_snap", "kaps hidden M t_eval", rhs["kaps"],
             (TRBDF2, M_HIDDEN)),
            ("fused_esdirk_grid_snap", "rdiff t_eval", rhs["rdiff"], Kv3I)]


def kaps_y0(n):
    """The hidden-M Kaps members of esdirk_path: z = B y with y0 = (a^2,
    a), a in [0.8, 1.2], and their consistent derivatives."""
    a = np.linspace(0.8, 1.2, n)
    z0 = torch.tensor((HID_B @ np.stack([a * a, a])).T, dtype=torch.float32,
                      device="cuda")
    zp0 = torch.tensor((HID_B @ np.stack([-2 * a * a, -a])).T,
                       dtype=torch.float32, device="cuda")
    return a, z0, zp0


def teval_routes_lines():
    """Each line's (label, kernel, wrapper options, y0, span, t_eval)."""
    from extensisq_tpu_torch import Fi5N, Kv3I, TRBDF2
    f = np.float32
    kep = np.linspace(*KEP_SPAN, TE_N_EVAL).astype(f)
    wav = np.linspace(*WAVE_SPAN, TE_POINTS).astype(f)
    _, kz0, kzp0 = kaps_y0(KAPS_N)
    rd = np.linspace(*RD_SPAN, TE_POINTS).astype(f)
    ky, wy, ry = kepler_y0(KEP_N), wave_y0(WAVE_M, WAVE_N), rdiff_y0(RD_M,
                                                                     RD_N)
    return [
        ("kepler plain", "fused_rkn", dict(KEP_PLAIN_TOL, method=Fi5N), ky,
         KEP_SPAN, kep),
        ("kepler compensated", "fused_rkn", dict(KEP_COMP_TOL, method=Fi5N),
         ky, KEP_SPAN, kep),
        ("wave plain", "fused_rkn_grid", dict(WAVE_TOL, method=Fi5N), wy,
         WAVE_SPAN, wav),
        ("wave compensated", "fused_rkn_grid",
         dict(WAVE_COMP_TOL, method=Fi5N), wy, WAVE_SPAN, wav),
        ("pend", "fused_esdirk",
         dict(PEND_TOL, method=Kv3I, M=M_PEND,
              yp0_batch=PEND_RUNS["yp0"]), PEND_RUNS["y0"], PEND_SPAN,
         PEND_RUNS["tq"]),
        ("kaps hidden M", "fused_esdirk",
         dict(KAPS_TOL, method=TRBDF2, M=M_HIDDEN, yp0_batch=kzp0), kz0,
         KAPS_SPAN, np.linspace(*KAPS_SPAN, TE_POINTS).astype(f)),
        ("rdiff plain", "fused_esdirk_grid", dict(RD_TOL, method=Kv3I), ry,
         RD_SPAN, rd),
        ("rdiff compensated", "fused_esdirk_grid",
         dict(RD_TOL, method=Kv3I, compensated=True), ry, RD_SPAN, rd)]


def teval_routes_shapes(kind, label, y0, shape, kw):
    """The shapes at which the line's snapshot launch is held bit for bit
    to the launch without t_eval: B5 the rule's, 4 lanes and one thread;
    B6 and B7 their blocks and the warp; B2 the rule's G, 32 lanes and one
    thread."""
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    from extensisq_tpu_torch.ops.fused_erk_grid import grid_threads
    n = y0.shape[1]
    if kind == "fused_rkn":
        return list(dict.fromkeys([shape, (4, None), (1, None)]))
    if kind == "fused_esdirk":
        return list(dict.fromkeys([shape, (32, None), (1, None)]))
    if kind == "fused_rkn_grid":
        n = n // 2
        return list(dict.fromkeys([(grid_threads(n), 0),
                                   (grid_threads(-(-n // 2)), 0),
                                   (32, FNG.WARP_MEMBERS)]))
    return list(dict.fromkeys([(grid_threads(n), 0),
                               (grid_threads(-(-n // 2)), 0),
                               (32, FEG.WARP_MEMBERS)]))


def teval_routes_launch(kind, R, label, y0, span, kw, tq, s):
    """The line's kernel at shape ``s`` (a comparison launch, not
    counted), with the points ``tq`` (None: the build without them)."""
    from extensisq_tpu_torch.ops import fused_esdirk as FE
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn as FN
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    fun = R[label.split()[0]]
    kw = dict(kw)
    meth = kw.pop("method")
    comp = kw.pop("compensated", False)
    rtol, atol = kw.pop("rtol"), kw.pop("atol")
    first = kw.pop("first_step", None)
    if kind == "fused_rkn":
        return FN._launch(fun, span, y0, meth, rtol, atol, first, 100_000,
                          comp, None, s[0], s[1], None, None, tq)[0]
    if kind == "fused_esdirk":
        return FE._launch(fun, span, y0, meth, kw["M"], kw["yp0_batch"],
                          rtol, atol, first, 100_000, comp, None, s[0],
                          s[1], None, None, None, tq)[0]
    opts = dict(rtol=rtol, atol=atol, first_step=first, compensated=comp,
                t_eval=tq)
    if kind == "fused_rkn_grid":
        return FNG._launch(FNG._kernel(meth, fun, False, tq is not None),
                           span, y0, y0.shape[1] // 2, shape=s, **opts)[0]
    return FEG._launch(FEG._kernel(meth, fun, None, False, tq is not None),
                       span, y0, method=meth, shape=s, **opts)[0]


def teval_routes_path():
    """The t_eval snapshots of B5, B6, B2 and B7 on the card: the five
    lines through the wrappers, each wrapper's count set to 0 just before
    and read just after (two launches of each kernel); each against its
    plain version (pend4096's from esdirk_path) and, bit for bit, the
    launch without t_eval at every shape its rule takes; B5 and B2 against
    the f64 driver's t_eval rows, a dense=R launch of B5's sol(t_eval)
    against its y_eval, the hidden-M rows in the user's coordinates against
    the Kaps problem's exact solution; each line's launch alone with and
    without t_eval (ten back to back, CUDA events) and its bound.  Returns
    each kernel's ``_teval`` keys by its ``kernels`` name."""
    from extensisq_tpu_torch import Fi5N, ops, solve_ensemble
    from extensisq_tpu_torch.ops import fused_esdirk as FE
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn as FN
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    from extensisq_tpu_torch.ops.fused_esdirk import (_esdirk_consts,
                                                      _mass_setup)
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts
    start = time.perf_counter()
    R = teval_routes_rhs()
    lines = teval_routes_lines()
    wrappers = {k: getattr(ops, "solve_" + k)
                for k in ("fused_rkn", "fused_rkn_grid", "fused_esdirk",
                          "fused_esdirk_grid")}
    every = [getattr(ops, k) for k in dir(ops) if k.startswith("solve_fused_")
             and hasattr(getattr(ops, k), "launches")]

    def line(label, kind, kw, y0, span, tq):
        return wrappers[kind](R[label.split()[0]], span, y0, t_eval=tq, **kw)

    # the main path of the phase: the lines through the wrappers
    for w in every:
        w.launches = 0
    t0 = time.perf_counter()
    runs, shapes = {}, {}
    for spec in lines:
        runs[spec[0]] = line(*spec)
        shapes[spec[0]] = wrappers[spec[1]].last_shape
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = {w.__name__: w.launches for w in every if w.launches}
    expect = {"solve_" + k: 2 for k in wrappers}
    print(f"t_eval routes path: {path_ms:.1f} ms for the lines (first "
          f"calls), launches {launches}")
    check(launches == expect, f"t_eval routes path launched {launches}, "
          f"expected {expect}")
    for label, _, _, y0, _, tq in lines:
        out = runs[label]
        check(len(out) == 5 and bool((out[1] == 1).all()),
              f"{label}: not every member finished")
        check(out[4].shape == (len(tq), *out[0].shape),
              f"{label}: y_eval's shape")
        check(bool(torch.isfinite(out[4]).all()), f"{label}: y_eval finite")

    # each line against its plain version and, bit for bit, the launch
    # without t_eval at each shape its rule takes
    gates = {"kepler plain": RKN_KERNEL_GATES["kepler"],
             "kepler compensated": RKN_KERNEL_GATES["kepler_comp"],
             "wave plain": RKN_KERNEL_GATES["wave"],
             "wave compensated": RKN_KERNEL_GATES["wave_comp"],
             "pend": ESDIRK_GATES["bench"],
             "kaps hidden M": ESDIRK_GATES["kaps_hidden"],
             "rdiff plain": MID_KERNEL_GATES["rd4d"],
             "rdiff compensated": TR_KERNEL_GATES["rdiff compensated"]}
    errs, plain_ms, plains = {}, {}, {}
    for label, kind, kw, y0, span, tq in lines:
        k = runs[label]
        plain = getattr(ops, kind + "_reference")
        if label == "pend":
            r = PEND_RUNS["plain"]
            _, r, dy, _ = hold_against_plain("t_eval", label + " t_eval",
                                             lambda: k, lambda: r,
                                             *gates[label])
            plain_ms[label] = PEND_RUNS["plain_ms"]
        else:
            _, r, dy, r_s = hold_against_plain(
                "t_eval", label + " t_eval", lambda: k,
                lambda: plain(R[label.split()[0]], span, y0, t_eval=tq, **kw),
                *gates[label])
            plain_ms[label] = r_s * 1e3
        plains[label] = r
        dq, dq_same = _eval_err(k, r), _eval_err(k, r, True)
        g_same, g_all = TR_YEVAL_GATES[label]
        print(f"t_eval kernel vs plain [{label}, {y0.shape[0]}, "
              f"{len(tq)} points]: max |dy_eval| over the members with the "
              f"plain version's counts {dq_same:.3e} (gate {g_same:.1e}), "
              f"over all {dq:.3e} (gate {g_all:.1e})")
        check(dq_same <= g_same and dq <= g_all,
              f"{label}: y_eval off the plain version")
        same, worst = {}, dq
        for s in teval_routes_shapes(kind, label, y0, shapes[label], kw):
            on = teval_routes_launch(kind, R, label, y0, span, kw, tq, s)
            off = teval_routes_launch(kind, R, label, y0, span, kw, None, s)
            same[s] = _same(on[:4], off)
            worst = max(worst, _eval_err(on, r))
            check(torch.equal(on[1], r[1]), f"{label} at {s}: status")
        print(f"t_eval [{label}]: the four outputs bit for bit those without "
              f"t_eval at {same}; max |dy_eval| over the shapes {worst:.3e}")
        check(all(same.values()), f"{label}: t_eval changed the outputs")
        check(worst <= g_all, f"{label}: y_eval off at a shape")
        errs[label] = (dy, worst)

    # B5 against the f64 driver's t_eval rows on the same members, and a
    # dense=R launch's sol(t_eval) against its own y_eval
    _, _, _, y0, span, tq = lines[0]
    te = torch.tensor(tq, dtype=torch.float64, device="cuda")
    ref = solve_ensemble(kepler, span, y0.double(), method=Fi5N, t_eval=te,
                         **KEP_F64_TOL)
    check(bool((ref.status == 1).all()), "f64 kepler t_eval: not finished")
    rows64 = ref.y_eval.permute(1, 0, 2)
    for label in ("kepler plain", "kepler compensated"):
        d64 = (runs[label][4].double() - rows64).abs().max().item()
        d_pl = (plains[label][4].double() - rows64).abs().max().item()
        print(f"t_eval {label} vs f64 solve_ensemble(t_eval) at rtol 1e-9: "
              f"max |dy_eval| {d64:.3e} (gate {TR_F64_GATES[label]:.1e}); "
              f"the plain version's {d_pl:.3e}")
        check(d64 <= TR_F64_GATES[label], f"{label}: y_eval off f64")
    dense = ops.solve_fused_rkn(R["kepler"], span, y0, t_eval=tq,
                                dense=TR_KEP_DENSE, method=Fi5N,
                                **KEP_PLAIN_TOL)
    check(_same(dense[:5], runs["kepler plain"]),
          "kepler: the record changed the outputs or y_eval")
    sol = dense[5]
    check(bool(sol.valid.all()), f"kepler dense: {TR_KEP_DENSE} rows too few")
    at = sol(torch.tensor(tq, device="cuda")).permute(2, 0, 1)
    d_sol = (at - dense[4]).abs().max().item()
    print(f"t_eval kepler plain with dense={TR_KEP_DENSE}: outputs and y_eval "
          f"bit for bit the launch without the record; sol(t_eval) vs y_eval "
          f"max |d| {d_sol:.3e} (gate {TR_DENSE_GATE:.1e})")
    check(d_sol <= TR_DENSE_GATE, "kepler: sol(t_eval) off y_eval")

    # B2 against the bench line's f64 rows on the differential rows, and
    # the hidden-M rows in the user's coordinates against the exact Kaps
    # solution
    rows64 = PEND_RUNS["f64"].y_eval.permute(1, 0, 2)[..., :4]
    d64 = (runs["pend"][4][..., :4].double() - rows64).abs().max().item()
    d_pl = (plains["pend"][4][..., :4].double() - rows64).abs().max().item()
    print(f"t_eval pend vs the f64 driver's t_eval rows (rows 0-3): max "
          f"|dy_eval| {d64:.3e} (gate {TR_F64_GATES['pend']:.1e}); the plain "
          f"version's {d_pl:.3e}")
    check(d64 <= TR_F64_GATES["pend"], "pend: y_eval off f64")
    a, _, _ = kaps_y0(KAPS_N)
    tk = lines[5][5].astype(np.float64)
    exact = np.stack([np.exp(-2 * tk)[:, None] * (a * a)[None, :],
                      np.exp(-tk)[:, None] * a[None, :]], -1)
    yk = runs["kaps hidden M"][4].double().cpu().numpy() @ HID_BINV.T
    d_ex = np.abs(yk - exact).max()
    print(f"t_eval kaps hidden M: the rows mapped to y = B^-1 z against the "
          f"exact solution max |d| {d_ex:.3e} (gate {TR_KAPS_EXACT_GATE:.1e})")
    check(d_ex <= TR_KAPS_EXACT_GATE, "kaps: rows off the exact solution")

    # readings: each line's wall through the wrapper, its launch alone with
    # and without t_eval, the rows' bytes, the bound
    fi5n, kv3i = rkn_consts(Fi5N), _esdirk_consts(lines[4][2]["method"])
    out_keys = {}
    for label, kind, kw, y0, span, tq in lines:
        fun = R[label.split()[0]]
        meth = kw["method"]
        if kind == "fused_rkn":
            on_b, off_b = (FN._kernel(meth, fun, False, True),
                           FN._kernel(meth, fun))
        elif kind == "fused_rkn_grid":
            on_b, off_b = (FNG._kernel(meth, fun, False, True),
                           FNG._kernel(meth, fun))
        elif kind == "fused_esdirk":
            n = y0.shape[1]
            setup = _mass_setup(kw["M"], n)
            on_b, off_b = (FE._kernel(meth, fun, kw["M"], *setup, n, n,
                                      False, True),
                           FE._kernel(meth, fun, kw["M"], *setup, n, n))
        else:
            on_b, off_b = (FEG._kernel(meth, fun, None, False, True),
                           FEG._kernel(meth, fun))
        tol = {x: kw[x] for x in ("rtol", "atol", "compensated",
                                  "first_step") if x in kw}
        extra = ({} if kind != "fused_esdirk"
                 else dict(yp0=kw["yp0_batch"], M=kw["M"]))
        ms = wall_ms(lambda: line(label, kind, kw, y0, span, tq))
        on_ms = launch_ms(kind, on_b, y0, None, span, tol, shapes[label], 0,
                          tq=tq, **extra)[0]
        off_ms = launch_ms(kind, off_b, y0, None, span, tol, shapes[label],
                           0, **extra)[0]
        out = runs[label]
        nb, width = y0.shape
        snap_bytes = len(tq) * nb * width * 4
        nfev = int(out[3].sum())
        if kind == "fused_rkn":
            by = KEP_N * (4 * 4 * 2 + 4 * 3)
            ops_ = rk_ops(fi5n, True, 2, RHS_OPS["kepler"], nfev, KEP_N, 5)
        elif kind == "fused_rkn_grid":
            by = WAVE_M * (2 * WAVE_N * 4 * 2 + 4 * 3)
            ops_ = rk_ops(fi5n, True, WAVE_N, RHS_OPS["wave"], nfev, WAVE_M,
                          1)
        elif kind == "fused_esdirk":
            by = nb * width * 4 * 3 + nb * 4 * 3
            ops_ = nfev * OPS_PER_EVAL["fused_esdirk"]
        else:
            by = RD_M * (RD_N * 4 * 2 + 4 * 3)
            ops_ = esdirk_grid_ops(RD_N, kv3i, RHS_OPS["rdiff"], nfev - RD_M,
                                   int(out[2].sum()),
                                   3 * RHS_OPS["rdiff_band"])
        bound = bound_entry(by + snap_bytes, ops_)
        print(f"time [t_eval {label}, {nb} members, {len(tq)} points]: "
              f"{ms:.3f} ms wall through the wrapper; the launch alone "
              f"{on_ms:.4f} ms device with t_eval, {off_ms:.4f} ms without "
              f"(CUDA events, ten launches back to back, the same shape); "
              f"rows {snap_bytes} bytes; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}); plain version {plain_ms[label]:.1f} "
              f"ms wall")
        suffix = {"compensated": "_teval_comp", "M": "_teval_kaps"}.get(
            label.split()[-1], "_teval")
        entry = out_keys.setdefault(kind, {})
        entry.update({
            "max_abs_err" + suffix: errs[label][0],
            "max_abs_err_y_eval" + suffix: errs[label][1],
            "ms" + suffix: ms, "device_ms" + suffix: on_ms,
            "device_ms_no_teval" + suffix: off_ms,
            "plain_ms" + suffix: plain_ms[label],
            "bound_ms" + suffix: bound["bound_ms"],
            "bound_by" + suffix: bound["bound_by"],
            "library_ms" + suffix: None})
    for kind in out_keys:
        out_keys[kind]["launches_teval"] = launches.get("solve_" + kind, 0)
    out_keys["fused_esdirk"]["f64_ms_teval"] = PEND_RUNS["f64_ms"]
    print(f"t_eval routes phase: {time.perf_counter() - start:.1f} s")
    return out_keys


HOST_GATE = 1e-9
HOST_GATES = {"pleiades-cfmr7osc": 1e-6, "kepler-fi5n": 1e-8,
              "swdec-ckdisc": 1e-8}
HOST_COUNTS = ("status", "nfev", "njev", "nlu", "nsteps", "nfailed")


def _ev_cross(t, y):
    return y[0]


def _ev_stop(t, y):
    return t - 8.5


_ev_stop.terminal = True


def host_ivp_cases():
    """(label, fun, span, y0, method, options) of each solve_ivp run: the
    problem library's and this script's right-hand sides, rows-first, so
    each runs with ``vectorized=True``."""
    from extensisq_tpu_torch import (BS5, CFMR7osc, CKdisc, Fi5N, KC4I,
                                     Kv3I, SSV2stab, SWAG, problems)
    pl, pend = problems.pleiades(), problems.pendulum_dae()
    med, bru = problems.medazko(200), problems.brusselator_2d((64, 64))
    v = dict(vectorized=True)
    return [
        ("vdp-bs5", vdp, T_SPAN, np.array([2.0, 0.0]), BS5,
         dict(v, rtol=1e-6, atol=1e-9, t_eval=np.linspace(0.0, 10.0, 101),
              dense_output=True, events=(_ev_cross, _ev_stop))),
        ("swdec-ckdisc", swdec_rows, CK_SPAN, np.array([1.2, 1.4]), CKdisc,
         dict(v, rtol=1e-6, atol=1e-9, first_step=1e-3)),
        ("pleiades-cfmr7osc", pl.rhs, pl.t_span, pl.y0, CFMR7osc,
         dict(v, rtol=1e-9, atol=1e-12)),
        ("kepler-fi5n", kepler, KEP_SPAN,
         np.array([0.5, 0.0, 0.0, np.sqrt(3.0)]), Fi5N,
         dict(v, rtol=1e-9, atol=1e-12)),
        ("pendulum-kv3i", pend.rhs, PEND_SPAN, pend.y0, Kv3I,
         dict(v, M=pend.M, **PEND_TOL)),
        ("medazko200-kc4i-bands", med.rhs, med.t_span, med.y0, KC4I,
         dict(v, jac_sparsity=med.jac_sparsity, bands=True, rtol=1e-3,
              atol=1e-6)),
        ("vdp-swag", vdp, T_SPAN, np.array([2.0, 0.0]), SWAG,
         dict(v, rtol=1e-6, atol=1e-9)),
        ("brus64-ssv2stab", bru.rhs, (0.0, 1.0), bru.y0, SSV2stab,
         dict(v, rho_jac=bru.rho_jac, rtol=1e-4, atol=1e-7))]


def count_syncs(fn):
    """``fn()`` with the card's synchronizing calls counted (CUDA's sync
    debug mode, one warning each); returns (result, count, seconds)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return out, n, sec, [w for w in caught if "synchroniz"
                         not in str(w.message)]


def _driver_warnings(caught):
    """The host driver's own warnings among ``caught``, sorted."""
    own = ("Your problem", "\nInitial conditions", "The following")
    return sorted(str(w.message) for w in caught
                  if str(w.message).startswith(own))


def _host_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def host_ivp_runs():
    """Each solve_ivp case on the card and on the CPU; prints walls, ms per
    step and host syncs per step (after one untimed solve that wakes the
    card's libraries), then fails if any case missed a gate."""
    import warnings
    from extensisq_tpu_torch import BS5, solve_ivp
    solve_ivp(vdp, (0.0, 1.0), np.array([2.0, 0.0]), method=BS5,
              vectorized=True)
    missed = []

    def check(cond, what):
        if not cond:
            print(f"MISSED: {what}")
            missed.append(what)
    for label, fun, span, y0, method, opts in host_ivp_cases():
        card, syncs, card_s, card_w = count_syncs(
            lambda: solve_ivp(fun, span, y0, method=method, **opts))
        with warnings.catch_warnings(record=True) as cpu_w:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            cpu = solve_ivp(fun, span, torch.as_tensor(y0), method=method,
                            **opts)
            cpu_s = time.perf_counter() - t0
        check(card.success and cpu.success, f"solve_ivp {label}: failed")
        for k in HOST_COUNTS:
            check(card[k] == cpu[k], f"solve_ivp {label}: {k} {card[k]} on "
                  f"the card, {cpu[k]} on the CPU")
        check(_driver_warnings(card_w) == _driver_warnings(cpu_w),
              f"solve_ivp {label}: the warnings differ")
        rel = max(_host_rel(card.t, cpu.t), _host_rel(card.y, cpu.y))
        if card.t_events is not None:
            for a, b in zip(card.t_events + card.y_events,
                            cpu.t_events + cpu.y_events):
                rel = max(rel, _host_rel(a, b))
        if card.sol is not None:
            tq = np.linspace(span[0], card.t[-1], 37)
            rel = max(rel, _host_rel(card.sol(tq).cpu(), cpu.sol(tq)))
        check(bool(np.isfinite(card.y).all()), f"solve_ivp {label}: y")
        gate = HOST_GATES.get(label, HOST_GATE)
        steps = card.nsteps
        print(f"solve_ivp {label} (n = {len(y0)}): {steps} steps, nfev "
              f"{card.nfev}, njev {card.njev}, nlu {card.nlu} (CPU "
              f"{cpu.nsteps}, {cpu.nfev}, {cpu.njev}, {cpu.nlu}); card "
              f"{card_s * 1e3:.1f} ms ({card_s * 1e3 / steps:.3f} ms a "
              f"step, {syncs / steps:.2f} host syncs a step), CPU "
              f"{cpu_s * 1e3:.1f} ms ({cpu_s * 1e3 / steps:.3f} ms a step);"
              f" counters equal, max rel |d| {rel:.2e} (gate {gate:.0e})")
        check(rel <= gate, f"solve_ivp {label}: card and CPU disagree")
    globals()["check"](not missed, f"solve_ivp: {len(missed)} gates missed")


def host_stepper_by_hand():
    """BS5's stepwise protocol on the card and on the CPU, step for step."""
    from extensisq_tpu_torch import BS5
    on = {}
    for dev in ("cuda", "cpu"):
        y0 = np.array([2.0, 0.0]) if dev == "cuda" else torch.tensor(
            [2.0, 0.0], dtype=torch.float64)
        s = BS5(vdp, 0.0, y0, 3.0, vectorized=True, rtol=1e-6, atol=1e-9)
        ts, ys = [], []
        while s.status == "running":
            check(s.step() is None, "Stepper: a step failed")
            ts.append(s.t)
            ys.append(s.dense_output()(0.5 * (s.t_old + s.t)))
        on[dev] = (ts, np.array(ys), s.nfev, s.host_syncs)
    (tc, yc, fc, sc), (tp, yp, fp, _) = on["cuda"], on["cpu"]
    rel = max(_host_rel(tc, tp), _host_rel(yc, yp))
    print(f"Stepper by hand (vdp BS5, t in [0, 3]): {len(tc)} steps on the "
          f"card and {len(tp)} on the CPU, nfev {fc} / {fp}, the driver's "
          f"own count {sc / len(tc):.2f} host syncs a step; max rel |d| of "
          f"t and the midpoints {rel:.2e}")
    check(len(tc) == len(tp) and fc == fp and rel <= HOST_GATE,
          "Stepper: card and CPU disagree")


def host_sensitivities():
    """The three sensitivity functions on Robertson at the CVODES gates of
    the JAX tests, and solve_final's Van der Pol gradient against
    sens_forward, all on the card."""
    from extensisq_tpu_torch import (BS5, KC4I, sens_adjoint_end,
                                     sens_adjoint_int, sens_forward,
                                     solve_final)

    def rob(t, y, *p):
        p1, p2, p3 = p
        return torch.stack([-p1 * y[0] + p2 * y[1] * y[2],
                            p1 * y[0] - p2 * y[1] * y[2] - p3 * y[1] ** 2,
                            p3 * y[1] ** 2])
    y0, p = np.array([1.0, 0.0, 0.0]), (0.04, 1e4, 3e7)
    atol, dy0dp = np.array([1e-8, 1e-14, 1e-6]), np.zeros((3, 3))
    yf_ref = [9.8517e-01, 3.3864e-05, 1.4794e-02]
    sens_ref = [[-3.5595e-01, 9.5428e-08, -1.5832e-11],
                [3.9026e-04, -2.1310e-10, -5.2900e-13],
                [3.5556e-01, -9.5215e-08, 1.6361e-11]]
    t0 = time.perf_counter()
    sens, yf, sol = sens_forward(rob, (0.0, 0.4), y0, None, None, dy0dp,
                                 p=p, method=KC4I, rtol=1e-4, atol=atol)
    fwd_s = time.perf_counter() - t0
    check(np.allclose(yf, yf_ref, rtol=1e-3, atol=0)
          and np.allclose(sens, sens_ref, rtol=1e-3, atol=0),
          "sens_forward: off the CVODES values")
    t0 = time.perf_counter()
    sol_y = None
    for i in range(3):
        s_i, g_i, sol_y, _ = sens_adjoint_end(
            rob, (0.0, 0.4), y0, None, None, dy0dp, p,
            lambda t, y, *q, i=i: y[i:i + 1], None, None, method=KC4I,
            atol=atol, rtol=1e-4, atol_adj=1e-6, atol_quad=1e-7,
            sol_y=sol_y)
        check(np.allclose(g_i, yf_ref[i], rtol=1e-3, atol=0)
              and np.allclose(s_i, sens_ref[i], rtol=1e-2, atol=1e-13),
              f"sens_adjoint_end {i}: off the CVODES values")
    end_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_int, G, sol_yi, sol_bw = sens_adjoint_int(
        rob, (0.0, 4e7), y0, None, None, dy0dp, p,
        lambda t, y, *q: (y[0] + q[1] * y[1] * y[2]).reshape(1), None,
        None, method=KC4I, atol=atol, rtol=1e-4, atol_adj=1e-5,
        atol_quad=1e-6)
    int_s = time.perf_counter() - t0
    check(np.allclose(G, 1.8219e4, rtol=5e-3, atol=0)
          and np.allclose(s_int, [-7.8383e5, 3.1991, -5.3301e-4], rtol=1e-2,
                          atol=0)
          and np.allclose(sol_bw.y[:3, -1], [3.4249e4, 3.4206e4, 3.4139e4],
                          rtol=1e-2, atol=0),
          "sens_adjoint_int: off the CVODES values")

    def vdp_p(t, y, mu):
        return torch.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])
    t0 = time.perf_counter()
    mu = torch.tensor(1.5, dtype=torch.float64, device="cuda",
                      requires_grad=True)
    yv = torch.tensor([2.0, 0.0], dtype=torch.float64, device="cuda")
    gmu, = torch.autograd.grad(
        solve_final(vdp_p, (0.0, 5.0), yv, mu, BS5, 1e-9, 1e-12)[0], mu)
    fin_s = time.perf_counter() - t0
    s_v, _, _ = sens_forward(vdp_p, (0.0, 5.0), np.array([2.0, 0.0]),
                             p=(1.5,), rtol=1e-10, atol=1e-13, method=BS5)
    d = abs(float(gmu) - s_v[0, 0]) / abs(s_v[0, 0])
    print(f"sensitivities on the card: sens_forward (Robertson, KC4I, "
          f"{sol.nsteps} steps, njev {sol.njev}, nlu {sol.nlu}) "
          f"{fwd_s * 1e3:.1f} ms, three sens_adjoint_end {end_s * 1e3:.1f}"
          f" ms, sens_adjoint_int ({sol_yi.nsteps} + {sol_bw.nsteps} steps)"
          f" {int_s * 1e3:.1f} ms, all at the CVODES gates; solve_final's "
          f"dy/dmu {float(gmu):.10f} vs sens_forward {s_v[0, 0]:.10f}, rel "
          f"{d:.2e} (gate 1e-6), forward and backward {fin_s * 1e3:.1f} ms")
    check(d <= 1e-6, "solve_final: gradient off sens_forward")


def host_front_door(vdp_rhs):
    """ops.solve_fused, one call per family and layout at the earlier
    phases' problems (few members, short spans), and one more on B11 and
    B12 with params and t_eval (the t_eval phase's) and on B5, B6, B2 and
    B7 with t_eval (the t_eval routes phase's builds), each the route of
    JAX's table, one launch and bit for bit the direct wrapper call.  Every
    wrapper's count is set to 0 just before and read just after; returns
    the launches."""
    from extensisq_tpu_torch import (BS5, CKdisc, Fi5N, Kv3I, SSV2stab,
                                     SWAG, ops)
    R = dict(rkn_grid_rhs(), **{f"ck_{k}": v for k, v in
                                ckdisc_rhs().items()})
    A, M, RK = adams_rhs(), mid_rhs(), rkc_rhs()
    PEND = esdirk_builds()[2][2]
    _, yc, ypc = pend_start(8, "cuda")
    y9 = torch.tensor(brus131k_y0(), dtype=torch.float32, device="cuda")
    y10 = torch.tensor(ens_y0(4, ENS_NY, ENS_NX), device="cuda")
    p10 = torch.tensor(np.linspace(2.8, 3.5, 4), dtype=torch.float32,
                       device="cuda")[:, None]
    vdp0 = vdp_y0(64, torch.float32)
    TE, te = teval_rhs(), teval_inputs()
    TR = teval_routes_rhs()
    f = np.float32
    calls = [
        ("fused_erk", vdp_rhs, T_SPAN, vdp0, BS5, dict(PLAIN_TOL)),
        ("fused_erk_grid", R["fisher"], FISHER_SPAN,
         fisher_y0(8, FISHER_N), BS5, dict(FISHER_TOL)),
        ("fused_rkn", R["kepler"], KEP_SPAN, kepler_y0(64), Fi5N,
         dict(KEP_PLAIN_TOL)),
        ("fused_rkn_grid", R["wave"], WAVE_SPAN, wave_y0(8, WAVE_N), Fi5N,
         dict(WAVE_TOL)),
        ("fused_esdirk", PEND, (0.0, 1.0), yc.float(), Kv3I,
         dict(M=M_PEND, yp0_batch=ypc.float(), **PEND_TOL)),
        ("fused_esdirk_grid", M["rdiff"], RD_STEP_SPAN, rdiff_y0(8, RD_N),
         Kv3I, dict(RD_TOL)),
        ("fused_adams", A["vdp"], (0.0, 2.0), vdp0, SWAG,
         dict(rtol=1e-4, atol=1e-6, k_max=ADAMS_KMAX["vdp"])),
        ("fused_adams_grid", M["heat"], HEAT_SPAN, heat_y0(8, HEAT_N), SWAG,
         dict(HEAT_TOL)),
        ("fused_ckdisc", R["ck_swdec"], CK_SPAN, swdec_y0(torch.float32)[:64],
         CKdisc, dict(CK_TOL)),
        ("fused_ckdisc_grid", R["ck_ckmol"], CKMOL_SPAN,
         fisher_y0(8, CKMOL_N), CKdisc, dict(CKMOL_TOL)),
        ("fused_rkc", RK["b9"], (0.0, 0.2), y9, SSV2stab,
         dict(rho=BRUS_RHO, **RKC_TOL)),
        ("fused_rkc_ensemble", RK["b10"], (0.0, 0.5), y10, SSV2stab,
         dict(rho=ENS_RHO, params=p10, **RKC_TOL)),
        ("fused_ckdisc", TE["swdec"], CK_SPAN, te["swdec"][0][:64], CKdisc,
         dict(CK_TOL, params=te["swdec"][1][:64], t_eval=te["swdec"][3])),
        ("fused_ckdisc_grid", TE["ckmol"], CKMOL_SPAN, te["ckmol"][0][:8],
         CKdisc, dict(CKMOL_TOL, params=te["ckmol"][1][:8],
                      t_eval=te["ckmol"][3])),
        ("fused_rkn", TR["kepler"], KEP_SPAN, kepler_y0(64), Fi5N,
         dict(KEP_PLAIN_TOL, t_eval=np.linspace(*KEP_SPAN, 11).astype(f))),
        ("fused_rkn_grid", TR["wave"], WAVE_SPAN, wave_y0(8, WAVE_N), Fi5N,
         dict(WAVE_TOL, t_eval=np.linspace(*WAVE_SPAN, 11).astype(f))),
        ("fused_esdirk", TR["pend"], (0.0, 1.0), yc.float(), Kv3I,
         dict(M=M_PEND, yp0_batch=ypc.float(),
              t_eval=np.linspace(0.0, 1.0, 11).astype(f), **PEND_TOL)),
        ("fused_esdirk_grid", TR["rdiff"], RD_STEP_SPAN, rdiff_y0(8, RD_N),
         Kv3I, dict(RD_TOL, t_eval=np.linspace(*RD_STEP_SPAN,
                                               11).astype(f)))]
    wrappers = {name: getattr(ops, "solve_" + name) for name, *_ in calls}
    takes_method = ("fused_erk", "fused_erk_grid", "fused_rkn",
                    "fused_rkn_grid", "fused_esdirk", "fused_esdirk_grid")
    outs = []
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for name, rhs, span, y0, method, kw in calls:
        before = {k: f.launches for k, f in wrappers.items()}
        outs.append(ops.solve_fused(rhs, span, y0, method=method, **kw))
        moved = {k: f.launches - before[k] for k, f in wrappers.items()
                 if f.launches != before[k]}
        check(moved == {name: 1}, f"solve_fused routed {method.name} on "
              f"{type(rhs).__name__} {tuple(y0.shape)} to {moved}, not one "
              f"launch of {name}")
    torch.cuda.synchronize()
    door_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in wrappers.items()}
    expect = {k: sum(c[0] == k for c in calls) for k in wrappers}
    check(launches == expect, f"solve_fused launches {launches}")
    for (name, rhs, span, y0, method, kw), out in zip(calls, outs):
        direct = wrappers[name](rhs, span, y0, **(
            dict(kw, method=method) if name in takes_method else kw))
        same = len(out) == len(direct) and all(
            a is b or torch.equal(a, b) for a, b in zip(out, direct))
        check(same, f"solve_fused {name}: not bit for bit the direct call")
        check(bool((out[1] == 1).all()), f"solve_fused {name}: "
              "not every member finished")
    print(f"front door: {len(calls)} solve_fused calls in "
          f"{door_s * 1e3:.1f} ms, each to the kernel of JAX's table (one "
          f"launch each; B11 and B12 also with params and t_eval, B5, B6, B2 "
          f"and B7 with t_eval, y_eval fifth), each bit for bit the direct "
          f"wrapper call")
    return launches


def host_path(smi, vdp_rhs):
    """The host driver, the sensitivities and the front door on the card;
    prints the phase's time and returns the front door's launches."""
    start = time.perf_counter()
    print(f"host driver on {smi.splitlines()[0]}")
    host_ivp_runs()
    host_stepper_by_hand()
    host_sensitivities()
    launches = host_front_door(vdp_rhs)
    print(f"host driver phase: {time.perf_counter() - start:.1f} s")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    script_start = time.perf_counter()
    from extensisq_tpu_torch import BS5, solve_ensemble
    from extensisq_tpu_torch.ops import (FusedRHS, fused_erk_reference,
                                         solve_fused_erk, solve_fused_esdirk)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    VDP = FusedRHS(vdp, VDP_CUDA, 2)
    HO = FusedRHS(oscillator, HO_CUDA, 2)
    CUBIC = FusedRHS(cubic, CUBIC_CUDA, 2)

    # 2. build every kernel variant used below, all nvcc runs at once
    build_all([("fused_erk", "vdp", VDP, None), ("fused_erk", "oscillator",
                                                 HO, None),
               ("fused_erk", "cubic", CUBIC, None)] + esdirk_builds()
              + adams_builds(adams_rhs()) + rkc_builds(rkc_rhs())
              + rkn_grid_builds(rkn_grid_rhs())
              + ckdisc_builds(ckdisc_rhs()) + mid_builds(mid_rhs())
              + sens_builds(sens_rhs()) + sens_grid_builds(sens_grid_rhs())
              + adjoint_builds(adjoint_rhs())
              + adjoint_routes_builds(adjoint_routes_rhs())
              + adams_routes_builds(adams_routes_rhs())
              + teval_builds(teval_rhs())
              + teval_routes_builds(teval_routes_rhs()))

    # 3. the kernel against its plain version, on the card
    def compare(label, rhs, span, y0, y_gate, **kw):
        k, r = hold_against_plain(
            "erk", label,
            lambda: solve_fused_erk(rhs, span, y0, method=BS5, **kw),
            lambda: fused_erk_reference(rhs, span, y0, method=BS5, **kw),
            y_gate, STEP_GATE)[:2]
        hold_small_lanes("fused_erk", label, rhs, span, y0,
                         dict(kw, method=BS5), k, solve_fused_erk.last_shape)
        return k, r

    y1024 = vdp_y0(1024, torch.float32)
    compare("vdp plain", VDP, T_SPAN, y1024, PLAIN_GATE, **PLAIN_TOL)
    compare("vdp compensated", VDP, T_SPAN, y1024, COMP_GATE,
            **COMP_TOL)
    # 50 oscillator periods: the global error is ~2e-5, and kernel and
    # plain version land on different sides of it, so the gate is 1e-4;
    # each must stay within 2x the f64 solver's error (the JAX gate)
    ho_span = (0.0, 50 * 2 * np.pi)
    ho0 = torch.tensor([[1.0, 0.0]], device="cuda").repeat(1024, 1)
    k, r = compare("oscillator compensated, 50 periods", HO, ho_span, ho0,
                   COMP_GATE, **COMP_TOL)
    exact = torch.tensor([1.0, 0.0], device="cuda")
    ho64 = solve_ensemble(oscillator, ho_span, ho0[:4].double(), method=BS5,
                          rtol=1e-6, atol=1e-9)
    err64 = (ho64.y - exact.double()).abs().max().item()
    err_k = (k[0] - exact).abs().max().item()
    err_r = (r[0] - exact).abs().max().item()
    print(f"oscillator error vs exact: kernel {err_k:.3e}, plain version "
          f"{err_r:.3e}, f64 solver {err64:.3e} (gate 2x f64)")
    check(max(err_k, err_r) < 2.0 * err64, "oscillator: compensated error")
    x0 = np.full(1024, 0.1, np.float32)
    x0[7] = 1e18                      # this member overflows in f32
    cub0 = torch.tensor(np.stack([x0, np.zeros_like(x0)], 1),
                        device="cuda")
    k, _ = compare("overflow isolation", CUBIC, (0.0, 1.0), cub0, 1e-6,
                   max_steps=2000, **PLAIN_TOL)
    check(int(k[1][7]) == 3 and int((k[1] == 1).sum()) == 1023,
          "overflow isolation: member 7 must end with status 3 alone")

    # 4. the explicit main path at bench size
    y64 = vdp_y0(N_MEMBERS, torch.float64)
    y32 = y64.float()
    solve_fused_erk.launches = 0
    solve_fused_esdirk.launches = 0
    t0 = time.perf_counter()
    ens = solve_ensemble(vdp, T_SPAN, y64, method=BS5, rtol=1e-6, atol=1e-9)
    plain = solve_fused_erk(VDP, T_SPAN, y32, method=BS5, **PLAIN_TOL)
    plain_shape = solve_fused_erk.last_shape
    comp = solve_fused_erk(VDP, T_SPAN, y32, method=BS5, **COMP_TOL)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = solve_fused_erk.launches
    comp_shape = solve_fused_erk.last_shape
    print(f"main path: {main_s:.3f} s, fused_erk launches {launches}; "
          f"{N_MEMBERS} members at {plain_shape[0]} lanes per member "
          f"(plain), {comp_shape[0]} (compensated), 128 threads a block")
    check(launches == 2, f"fused_erk launched {launches} times, expected 2")
    check(solve_fused_esdirk.launches == 0,
          "the explicit path launched the implicit kernel")

    # (a) the f64 solver: all finished; 64 sampled members rerun on the CPU
    check(bool((ens.status == 1).all()), "f64 solver: not all finished")
    check(ens.y.shape == (N_MEMBERS, 2) and bool(torch.isfinite(ens.y).all()),
          "f64 solver: bad output")
    idx = torch.linspace(0, N_MEMBERS - 1, 64).long()
    cpu = solve_ensemble(vdp, T_SPAN, y64[idx].cpu(), method=BS5,
                         rtol=1e-6, atol=1e-9)
    for f in ("status", "nsteps", "nfev", "nfailed"):
        check(torch.equal(getattr(ens, f)[idx].cpu(), getattr(cpu, f)),
              f"f64 solver: {f} differs between the card and the CPU")
    dcpu = (ens.y[idx].cpu() - cpu.y).abs().max().item()
    print(f"f64 solver: card vs CPU on 64 members: counts equal, "
          f"max |dy| {dcpu:.3e} (gate 1e-12)")
    check(dcpu <= 1e-12, "f64 solver: card and CPU disagree")

    # (b) the kernel lines against the f64 solver, with the gates of the
    # JAX package's fused tests: plain within 5e-2 of the f64 solver at the
    # same tolerances and total steps within 30%; compensated within 1e-3
    # of the f64 line and mean nsteps within 10
    ens4 = solve_ensemble(vdp, T_SPAN, y64, method=BS5, **PLAIN_TOL)
    d_plain = (plain[0].double() - ens4.y).abs().max().item()
    d_comp = (comp[0].double() - ens.y).abs().max().item()
    s64 = ens4.nsteps.sum().item()
    print(f"fused plain vs f64 at rtol 1e-4: max |dy| {d_plain:.3e}, total "
          f"steps {plain[2].sum().item()} vs {s64}")
    print(f"fused compensated vs f64: max |dy| {d_comp:.3e}, mean nsteps "
          f"{comp[2].double().mean():.3f} vs {ens.nsteps.double().mean():.3f}")
    for label, out in (("plain", plain), ("compensated", comp)):
        check(bool((out[1] == 1).all()), f"fused {label}: not all finished")
    check(d_plain < 5e-2, "fused plain: endpoints off")
    check(abs(plain[2].sum().item() - s64) < 0.3 * s64,
          "fused plain: step count off")
    check(d_comp < 1e-3, "fused compensated: endpoints off")
    check(abs(comp[2].double().mean().item()
              - ens.nsteps.double().mean().item()) < 10.0,
          "fused compensated: step count off")

    # the kernel against its plain version at the main path's shapes
    ref_plain = fused_erk_reference(VDP, T_SPAN, y32, method=BS5,
                                    **PLAIN_TOL)
    ref_comp = fused_erk_reference(VDP, T_SPAN, y32, method=BS5, **COMP_TOL)
    err_plain = (plain[0] - ref_plain[0]).abs().max().item()
    err_comp = (comp[0] - ref_comp[0]).abs().max().item()
    print(f"kernel vs plain at {N_MEMBERS}: max |dy| plain {err_plain:.3e}"
          f" (gate {PLAIN_GATE:.0e}), compensated {err_comp:.3e} (gate "
          f"{COMP_GATE:.0e})")
    check(torch.equal(plain[1], ref_plain[1])
          and torch.equal(comp[1], ref_comp[1]), "status differs at 4096")
    check(err_plain <= PLAIN_GATE and err_comp <= COMP_GATE,
          "kernel and plain version disagree at 4096")
    for label, tol, out, shape in (
            ("main path plain", PLAIN_TOL, plain, plain_shape),
            ("main path compensated", COMP_TOL, comp, comp_shape)):
        hold_small_lanes("fused_erk", label, VDP, T_SPAN, y32,
                         dict(tol, method=BS5), out, shape)

    # timing: warm, synchronized, median of REPS
    def run_f64():
        return solve_ensemble(vdp, T_SPAN, y64, method=BS5, rtol=1e-6,
                              atol=1e-9)

    def run_kernel(tol, y=y32):
        return lambda: solve_fused_erk(VDP, T_SPAN, y, method=BS5, **tol)

    def run_ref(tol):
        return lambda: fused_erk_reference(VDP, T_SPAN, y32, method=BS5,
                                           **tol)

    rows = [("f64 solve_ensemble", run_f64, ens),
            ("kernel plain f32", run_kernel(PLAIN_TOL), plain),
            ("kernel compensated", run_kernel(COMP_TOL), comp),
            ("plain version, plain f32", run_ref(PLAIN_TOL), ref_plain),
            ("plain version, compensated", run_ref(COMP_TOL), ref_comp)]
    times = {}
    for label, fn, out in rows:
        ms = wall_ms(fn)
        times[label] = ms
        # a Solution is a NamedTuple too: read its counters by name
        steps = (out.nsteps if hasattr(out, "nsteps") else out[2]).sum()
        fev = (out.nfev if hasattr(out, "nfev") else out[3]).sum()
        print(f"time [{label}] {N_MEMBERS} members: {ms:.3f} ms wall, "
              f"{steps.item() / ms * 1e3:.4g} accepted steps/s, "
              f"{fev.item() / ms * 1e3:.4g} RHS evals/s")
    k_plain_ms = event_ms(run_kernel(PLAIN_TOL))
    k_comp_ms = event_ms(run_kernel(COMP_TOL))
    print(f"kernel device time (CUDA events) {N_MEMBERS} members: plain "
          f"{k_plain_ms:.4f} ms, compensated {k_comp_ms:.4f} ms")

    y_large = vdp_y0(N_LARGE, torch.float32)
    for label, tol in (("plain", PLAIN_TOL), ("compensated", COMP_TOL)):
        out = solve_fused_erk(VDP, T_SPAN, y_large, method=BS5, **tol)
        check(solve_fused_erk.last_shape[0] == 1,
              f"large {label}: the rule took a lane group")
        large = shape_text(solve_fused_erk, N_LARGE)
        ms = event_ms(run_kernel(tol, y_large))
        check(bool((out[1] == 1).all()), f"large {label}: not finished")
        print(f"kernel {label} {N_LARGE} members ({large}): {ms:.3f} ms, "
              f"{out[2].sum().item() / ms * 1e3:.4g} accepted steps/s, "
              f"{out[3].sum().item() / ms * 1e3:.4g} RHS evals/s")

    # 4b. the trajectory options of the f64 driver on the main path's line
    trajectory_path(y64, ens, times["f64 solve_ensemble"])

    # 4c. banded and sparse ESDIRK Jacobians (config 8) and complex states
    banded_complex_path(smi)

    # 5. the implicit path: kernel checks, the bench line, times
    esdirk = esdirk_path()

    # 6. the multistep path: kernel checks, the bench line, times
    adams = adams_path()

    # 7. the stabilized path: kernel checks, config 5's lines, times
    rkc = rkc_path()

    # 8. the second-order and mid-size explicit paths: kernel checks,
    # config 3's and 1b's lines and the wave, times
    rkn = rkn_grid_path()

    # 9. the CKdisc paths: kernel checks, config 1c and the MoL, times
    ck = ckdisc_path()

    # 10. the mid-size SWAG and ESDIRK paths: kernel checks, configs 2d and
    # 4d, times
    mid = mid_path()

    # 11. the fused sensitivities: params on B1 and B2, B2's simultaneous
    # corrector, configs 7a and 7b
    sens_erk, sens_esdirk = sens_path()

    # 11b. the grid layout's sensitivities: params on B4 and B7, B7's
    # simultaneous corrector, the Fisher and reaction-diffusion sweeps
    grid_erk, grid_esdirk = sens_grid_path()

    # 11c. the continuous adjoint: the dense record on B1 and B4, configs
    # 7d and 7b through solve_fused_adjoint
    adj_erk, adj_grid = adjoint_path()

    # 11d. the ESDIRK and RKN routes of the continuous adjoint: the dense
    # record on B2, B7, B5 and B6 and params on B5 and B6
    routes = adjoint_routes_path()

    # 11e. the SWAG routes of the continuous adjoint: params and the dense
    # record on B3 and B8
    swag_routes = adams_routes_path()
    for entry in rkn + mid:
        entry.update({"fused_erk_grid": dict(grid_erk, **adj_grid),
                      "fused_esdirk_grid": grid_esdirk}.get(entry["name"],
                                                            {}))
        entry.update(routes.get(entry["name"], {}))
        entry.update(swag_routes.get(entry["name"], {}))
    esdirk.update(routes["fused_esdirk"])
    adams.update(swag_routes["fused_adams"])

    # 11f. the t_eval snapshots on B1, B4, B11 and B12, with params on B11
    # and B12
    teval = teval_path()
    for entry in rkn + ck:
        entry.update(teval.get(entry["name"], {}))

    # 11g. the t_eval snapshots on B5, B6, B2 and B7
    teval_routes = teval_routes_path()
    for entry in rkn + mid:
        entry.update(teval_routes.get(entry["name"], {}))
    esdirk.update(teval_routes["fused_esdirk"])

    # 12. the host driver (solve_ivp, the Stepper), the sensitivities and
    # the front door ops.solve_fused over every kernel
    door = host_path(smi, VDP)

    print(f"chip_smoke: {time.perf_counter() - script_start:.1f} s from the "
          "first build to the last phase")
    # the card again, so that the end of the output names it beside the
    # kernels' times
    print(smi.splitlines()[0])
    kernels = ([dict({
        "name": "fused_erk",
        "route": "cuda",
        "source": "extensisq_tpu_torch/csrc/fused_erk.cu",
        "replaces": "extensisq_tpu/ops/fused_erk.py:830",
        "launches": launches,
        "max_abs_err": max(err_plain, err_comp),
        "ms": times["kernel plain f32"],
        "plain_ms": times["plain version, plain f32"],
        "ms_compensated": times["kernel compensated"],
        "plain_ms_compensated": times["plain version, compensated"],
        "lanes": plain_shape[0], "block_members": plain_shape[1],
        "lanes_compensated": comp_shape[0],
        "block_members_compensated": comp_shape[1],
    }, **bound_entry(N_MEMBERS * (2 * 4 * 2 + 4 * 3),
                     int(plain[3].sum()) * OPS_PER_EVAL["fused_erk"]),
        **sens_erk, **adj_erk, **teval["fused_erk"]),
        dict(esdirk, **sens_esdirk), adams]
        + rkc + rkn + ck + mid)
    for k in kernels:
        # the launches of the front door phase beside those of the path
        k["launches_solve_fused"] = door[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
