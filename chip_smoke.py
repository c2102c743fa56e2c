"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path once: 4096 Van der Pol members (mu = 3,
t in [0, 10]) integrated with BS5, first through the f64 batched solver
``solve_ensemble`` and then through the fused CUDA kernel
``ops.solve_fused_erk`` in plain float32 (rtol 1e-4) and in compensated
mode (rtol 1e-6 / atol 1e-9).  Before that, it builds the kernel from the
sources in this checkout and holds it against its plain PyTorch version
on the card.  Any mismatch raises; the script exits 0 only if every
phase passed.

    python3 chip_smoke.py

The last line of output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launch count on the main path, its
largest difference from the plain version and both times in ms.
"""
import json
import statistics
import subprocess
import sys
import time

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


def vdp(t, y):
    return torch.stack([y[1], MU * (1 - y[0] ** 2) * y[1] - y[0]])


def oscillator(t, y):
    return torch.stack([y[1], -y[0]])


def cubic(t, y):
    return torch.stack([y[1], y[0] ** 3])


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def vdp_y0(n, dtype):
    return torch.tensor(np.stack([np.linspace(1.5, 2.5, n), np.zeros(n)], 1),
                        dtype=dtype, device="cuda")


def wall_ms(fn):
    """Median synchronized wall time of ``fn()`` over REPS warm runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from extensisq_tpu_torch import BS5, solve_ensemble
    from extensisq_tpu_torch.ops import (FusedRHS, fused_erk_reference,
                                         solve_fused_erk)
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts

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

    # 2. build the kernel for each right-hand side used below
    for label, rhs in (("vdp", VDP), ("oscillator", HO), ("cubic", CUBIC)):
        built = _build.load_fused_erk(_fused_consts(BS5), rhs.n,
                                      rhs.cuda_src)
        regs = [ln.strip() for ln in built.log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build fused_erk[{label}]: {built.seconds:.2f} s; "
              + "; ".join(regs))

    # 3. the kernel against its plain version, on the card
    def compare(label, rhs, span, y0, y_gate, **kw):
        k = solve_fused_erk(rhs, span, y0, method=BS5, **kw)
        r = fused_erk_reference(rhs, span, y0, method=BS5, **kw)
        torch.cuda.synchronize()
        ok = r[1] == 1
        ydiff = (k[0][ok] - r[0][ok]).abs().max().item() if ok.any() \
            else 0.0
        step_rel = abs(k[2].double().mean().item()
                       / r[2].double().mean().item() - 1.0)
        print(f"kernel vs plain [{label}]: status equal "
              f"{torch.equal(k[1], r[1])}, max |dy| {ydiff:.3e} "
              f"(gate {y_gate:.0e}), mean nsteps {k[2].double().mean():.4f}"
              f" vs {r[2].double().mean():.4f} (rel {step_rel:.2e}, gate "
              f"{STEP_GATE:.0e}), max |dnsteps| "
              f"{(k[2] - r[2]).abs().max().item()}")
        check(torch.equal(k[1], r[1]), f"{label}: status differs")
        check(bool(torch.isfinite(k[0][ok]).all()), f"{label}: non-finite")
        check(ydiff <= y_gate, f"{label}: |dy| {ydiff} > {y_gate}")
        check(step_rel <= STEP_GATE,
              f"{label}: mean nsteps differ by {step_rel}")
        return k, r

    y1024 = vdp_y0(1024, torch.float32)
    compare("vdp plain, 1024", VDP, T_SPAN, y1024, PLAIN_GATE, **PLAIN_TOL)
    compare("vdp compensated, 1024", VDP, T_SPAN, y1024, COMP_GATE,
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

    # 4. the main path at bench size
    y64 = vdp_y0(N_MEMBERS, torch.float64)
    y32 = y64.float()
    solve_fused_erk.launches = 0
    t0 = time.perf_counter()
    ens = solve_ensemble(vdp, T_SPAN, y64, method=BS5, rtol=1e-6, atol=1e-9)
    plain = solve_fused_erk(VDP, T_SPAN, y32, method=BS5,
                            block_members=128, **PLAIN_TOL)
    comp = solve_fused_erk(VDP, T_SPAN, y32, method=BS5,
                           block_members=128, **COMP_TOL)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = solve_fused_erk.launches
    print(f"main path: {main_s:.3f} s, fused_erk launches {launches}")
    check(launches == 2, f"fused_erk launched {launches} times, expected 2")

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

    # timing: warm, synchronized, median of REPS
    def run_f64():
        return solve_ensemble(vdp, T_SPAN, y64, method=BS5, rtol=1e-6,
                              atol=1e-9)

    def run_kernel(tol, y=y32):
        return lambda: solve_fused_erk(VDP, T_SPAN, y, method=BS5,
                                       block_members=128, **tol)

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
        out = solve_fused_erk(VDP, T_SPAN, y_large, method=BS5,
                              block_members=128, **tol)
        ms = event_ms(run_kernel(tol, y_large))
        check(bool((out[1] == 1).all()), f"large {label}: not finished")
        print(f"kernel {label} {N_LARGE} members ({N_LARGE // 128} blocks "
              f"of 128): {ms:.3f} ms, "
              f"{out[2].sum().item() / ms * 1e3:.4g} accepted steps/s, "
              f"{out[3].sum().item() / ms * 1e3:.4g} RHS evals/s")

    print(json.dumps({"kernels": [{
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
