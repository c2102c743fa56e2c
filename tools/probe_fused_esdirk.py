"""Member sweep and section breakdown of the fused ESDIRK kernel
(csrc/fused_esdirk.cu, B2) against an earlier build of it, on one card.

The bench line (bench.py:172-221): members of the index-1 pendulum DAE (M
= diag(1, 1, 1, 1, 0), theta0 evenly in [0.2, 1.2], consistent starts
from the f64 stepper's projection) on t in [0, 10] with Kv3I at rtol 1e-4
/ atol 1e-6, at each member count of --sizes.  The kernel of --old-src (a
directory holding an earlier fused_esdirk.cu with the headers it
includes; its launch signature is read from the source: ``..., threads,
stream`` for one thread per member at 128 a block, or ``..., lanes,
block_members, stream``) and the current kernel at each lane count of
--lanes (128 / G members a block, where B G <= --max-threads) are timed in
turns (old, each G, each G in reverse, old) with CUDA events around the
launch alone.  Every G of the current kernel is held bit for bit against
its one-lane body, and the one-lane body against the old kernel.

With --sections, the current source is also built with
FUSED_ESDIRK_SECTIONS, whose SM clock counters (csrc/fused_esdirk.cu:
Clock, clock() read at each section's end) give each member's cycles per
section of its attempts: the
Jacobian, W and its factor, the Newton iterations' RHS, replay and tests,
the stage sums, the error estimate and the controller; printed at each
lane count of --section-lanes for the sizes of --sections, as cycles per
accepted step of the slowest member and as shares over all members.  The
instrumented launch is not timed against the others.  Prints registers
and spills of every build; writes chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_esdirk.py \\
        --old-src <dir>/extensisq_tpu_torch/csrc --sections 4096
"""
import argparse
import ctypes
import re
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from _probe import (build, card, launch_signature, ptxas_lines, sass_ops,
                    turns, write_out)
from extensisq_tpu_torch import Kv3I
from extensisq_tpu_torch.ops import _build
from extensisq_tpu_torch.ops import fused_esdirk as FE
from extensisq_tpu_torch.steppers import build_stepper
from extensisq_tpu_torch.types import IVPParams

SPAN = (0.0, 10.0)
RTOL, ATOL = 1e-4, 1e-6
M_PEND = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
MAX_STEPS = 100_000
SECTIONS = ("jacobian", "factor", "newton_rhs", "newton_solve",
            "newton_test", "stage", "error", "control")
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
OUT = {}


def pendulum(t, s):
    g = 9.81
    x, y, u, v, lam = s
    return torch.stack([u, v, -lam * x, -lam * y - g,
                        u * u + v * v - lam * (x * x + y * y) - g * y])


def pend_start(n):
    """(y0, yp0) float32 on the card: theta0 in [0.2, 1.2], consistent
    from the f64 stepper's DAE projection."""
    th = np.linspace(0.2, 1.2, n)
    y0 = torch.tensor(np.stack([np.sin(th), -np.cos(th), np.zeros(n),
                                np.zeros(n), np.zeros(n)]),
                      dtype=torch.float64, device="cuda")
    st = build_stepper(Kv3I, pendulum, 5, torch.float64,
                       M=np.diag(M_PEND)).init(
        0.0, y0, IVPParams(t_bound=SPAN[1], direction=1.0,
                           max_step=np.inf, rtol=RTOL, atol=ATOL))
    return (st.y.T.float().contiguous(), st.yp.T.float().contiguous())


def lane_convention(src_dir):
    """Whether src_dir/fused_esdirk.cu's launch takes lanes and
    block_members (else threads)."""
    return "int lanes" in launch_signature(src_dir, "fused_esdirk")


def build_esdirk(src_dir, header, tag, flags=()):
    b = build(src_dir, "fused_esdirk", header, f"b2_{tag}", flags)
    lanes = lane_convention(src_dir)
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = b["lib"]
    lib.fused_esdirk_launch.argtypes = (
        [V] * 6 + [I, F, F, F, F, F, I, I, F, I, F, I]
        + ([I, I] if lanes else [I]) + [V])
    lib.fused_esdirk_launch.restype = I
    if flags:
        lib.fused_esdirk_sections.argtypes = [V]
        lib.fused_esdirk_sections.restype = I
    b["lanes"] = lanes
    return b


def launch(b, y0, yp0, lanes=1):
    """One launch of build ``b`` on the members (y0, yp0) at ``lanes``
    lanes per member, 128 / lanes members a block; returns (y, status,
    nsteps, nfev)."""
    B = y0.shape[0]
    y = torch.empty_like(y0)
    ints = [torch.empty(B, dtype=torch.int32, device="cuda")
            for _ in range(3)]
    t0, tf = np.float32(SPAN[0]), np.float32(SPAN[1])
    args = [y0.data_ptr(), yp0.data_ptr(), y.data_ptr(),
            *[x.data_ptr() for x in ints], B, float(t0), float(tf),
            float(np.float32(RTOL)), float(np.float32(ATOL)),
            float(np.float32(0.01) * abs(tf - t0)), 0, 1, np.inf, MAX_STEPS,
            FE._tiny_err(5, RTOL), 0]
    if b["lanes"]:
        args += [lanes, max(1, 128 // lanes)]
    elif lanes != 1:
        raise ValueError("the old kernel runs one thread per member")
    else:
        args.append(128)
    rc = b["lib"].fused_esdirk_launch(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch at {lanes} lanes failed: CUDA error {rc}")
    return (y, *ints)


def sass_mix(so):
    """{kernel instantiation: instruction count and the counts of the
    opcodes of the latency chains (MUFU, FCHK for the IEEE divisions'
    range check, SHFL, CS2R for the section clocks)}, or a note where
    cuobjdump is not found."""
    ops = sass_ops(so)
    if not isinstance(ops, dict):
        return ops
    out = {}
    for fn, c in ops.items():
        m = re.search(r"kernelILi(\d+)ELb(\d)E", fn)
        key = f"G={m.group(1)} comp={m.group(2)}" if m else fn
        mix = {"total": sum(c.values())}
        for op in ("MUFU", "FCHK", "SHFL", "CS2R", "BRA"):
            mix[op] = sum(n for o, n in c.items() if o.split(".")[0] == op)
        out[key] = mix
    return out


def equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def sweep(builds, sizes, lanes, max_threads, n_turns):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for B in sizes:
        y0, yp0 = pend_start(B)
        gs = [g for g in lanes if B * g <= max_threads or g == 1]
        runs = [("old", lambda: launch(builds["old"], y0, yp0))]
        runs += [(f"G={g}", lambda g=g: launch(builds["new"], y0, yp0, g))
                 for g in gs]
        times, outs = turns(runs, n_turns)
        ref = outs["G=1"]
        rule = FE._lanes_per_member(B, sms, 5)
        print(f"b2 B={B}: the wrapper takes G = {rule}; status "
              f"{torch.unique(ref[1]).tolist()}, max nsteps "
              f"{int(ref[2].max())}, mean {ref[2].double().mean():.2f}; "
              f"one lane bit-identical to old {equal(ref, outs['old'])}")
        r = {"rule_G": rule, "max_nsteps": int(ref[2].max()),
             "one_lane_equals_old": equal(ref, outs["old"])}
        for label, _ in runs:
            t = times[label]
            med = statistics.median(t)
            same = equal(outs[label], ref)
            print(f"  b2 B={B} {label}: {' '.join(f'{x:.3f}' for x in t)} ms"
                  f" (median {med:.3f}), {med / int(ref[2].max()) * 1e3:.3f}"
                  f" us per step of the slowest member; bit-identical to one"
                  f" lane {same}")
            r[label] = {"ms": t, "median_ms": med, "bit_identical": same}
        res[str(B)] = r
    return res


def sections(b, sizes, lanes):
    res = {}
    for B in sizes:
        y0, yp0 = pend_start(B)
        buf = torch.zeros(B, len(SECTIONS), dtype=torch.int32, device="cuda")
        rc = b["lib"].fused_esdirk_sections(buf.data_ptr())
        if rc:
            raise RuntimeError(f"sections: CUDA error {rc}")
        for g in lanes:
            buf.zero_()
            out = launch(b, y0, yp0, g)
            torch.cuda.synchronize()
            cyc = buf.to(torch.int64).double() % 2**32
            share = cyc.sum(0) / cyc.sum()
            slow = int(out[2].argmax())
            steps = int(out[2][slow])
            per_step = cyc[slow] / steps
            print(f"b2 sections B={B} G={g}: slowest member {slow} "
                  f"({steps} steps, nfev {int(out[3][slow])}), cycles per "
                  f"step {per_step.sum():.0f}: "
                  + ", ".join(f"{n} {c:.0f}" for n, c in
                              zip(SECTIONS, per_step.tolist())))
            print(f"b2 sections B={B} G={g}: shares over all members "
                  + ", ".join(f"{n} {s:.3f}" for n, s in
                              zip(SECTIONS, share.tolist())))
            res[f"{B}/G={g}"] = {
                "slowest": slow, "steps": steps,
                "nfev": int(out[3][slow]),
                "cycles_per_step": dict(zip(SECTIONS, per_step.tolist())),
                "shares": dict(zip(SECTIONS, share.tolist())),
                "mean_cycles_per_member": cyc.mean(0).tolist()}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_esdirk.cu")
    ap.add_argument("--sizes", default="1024,4096,16384,65536,262144",
                    help="comma-separated member counts")
    ap.add_argument("--lanes", default="1,4,8,16,32",
                    help="lane counts of the current kernel")
    ap.add_argument("--max-threads", type=int, default=1 << 21,
                    help="largest B G timed at G > 1")
    ap.add_argument("--sections", default="",
                    help="member counts of the section breakdown")
    ap.add_argument("--section-lanes", default="1",
                    help="lane counts of the section breakdown")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--tag", default="probe_b2", help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    print("SMs", torch.cuda.get_device_properties(0).multi_processor_count,
          "torch", torch.__version__, torch.version.cuda)
    header = _build.fused_esdirk_header(
        FE._esdirk_consts(Kv3I), *FE._mass_setup(M_PEND, 5), 5, PEND_CUDA)
    jobs = {"old": (args.old_src.resolve(), header, "old"),
            "new": (_build.CSRC, header, "new")}
    if args.sections:
        jobs["sections"] = (_build.CSRC, header, "sections",
                            ("-DFUSED_ESDIRK_SECTIONS",))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build_esdirk, *v) for k, v in jobs.items()}
        builds = {k: f.result() for k, f in futs.items()}
    print(f"builds {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {b['seconds']:.1f} s" for k, b in builds.items()))
    for k, b in builds.items():
        for ln in ptxas_lines(b["log"], entries=True):
            print(f"ptxas[{k}] {ln}")
        sass = sass_mix(b["so"])
        for fn, mix in (sass.items() if isinstance(sass, dict) else ()):
            print(f"sass[{k}] {fn}: {mix}")
        OUT[f"build_{k}"] = {"seconds": b["seconds"], "log": b["log"],
                             "sass": sass}
    lanes = [int(x) for x in args.lanes.split(",")]
    if not builds["new"]["lanes"]:
        lanes = [1]
    if args.sections:
        OUT["sections"] = sections(
            builds["sections"], [int(x) for x in args.sections.split(",")],
            [int(x) for x in args.section_lanes.split(",")])
    OUT["sweep"] = sweep(builds, [int(x) for x in args.sizes.split(",")],
                         lanes, args.max_threads, args.turns)
    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
