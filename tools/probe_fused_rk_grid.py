"""Launch-shape sweep of the mid-size RKN kernel (the RKN family of
csrc/fused_rk_grid.cu, B6) against an earlier build of it, with B4 and B12
(the same source's ERK and CKdisc families) held to the earlier build, on
one card.

B6's lines are chip_smoke.py's wave (tests/test_fused_pallas.py:1367-1414
at config 1b's widths): members of the 256-position periodic wave (c^2 =
400, u0 = amps sin(2 pi x) with amps in [0.5, 1.5], v0 = 0) with Fi5N on t
in [0, 4] from first_step 0.05, plain at rtol 1e-5 / atol 1e-7 and
compensated at 1e-6 / 1e-9, at each member count of --sizes.  The kernel
of --old-src (a directory holding an earlier fused_rk_grid.cu with the
headers it includes; its launch signature is read from the source:
``..., threads, stream`` for one block a member, or ``..., threads,
warp_members, stream``) at each block size of --old-threads and the
current kernel at each shape of --shapes (``b<T>``: one block of T
threads a member; ``w<P>``: one warp a member, P members a block) are
timed in turns (old, each shape, the same in reverse, old) with CUDA
events around the launch alone; each shape's outputs (y, status, nsteps,
nfev) are held bit for bit against the old kernel at the same block size
(a warp against the old block of 32 threads).  B4 (fisher256x64, BS5) and
B12 (ckmol256x64) run at their wrapper's block size, old against new,
timed in turns and held bit for bit.  With --n the wave has n positions
instead of 256, and a warp shape whose members do not fit a block's shared
memory is left out.  Prints the shape the RKN wrapper's rule takes at each
size, registers and spills of every build; writes
chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_rk_grid.py \\
        --old-src <dir>/extensisq_tpu_torch/csrc
"""
import argparse
import ctypes
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as CS
from _probe import build, card, launch_signature, ptxas_lines, turns, write_out
from extensisq_tpu_torch import BS5, Fi5N
from extensisq_tpu_torch.ops import _build
from extensisq_tpu_torch.ops import fused_erk as FK
from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
from extensisq_tpu_torch.ops.fused_ckdisc import ck_consts
from extensisq_tpu_torch.ops.fused_erk_grid import (grid_threads,
                                                    shared_memory)
from extensisq_tpu_torch.ops.fused_rkn import rkn_consts

OUT = {}


def build_rk(src_dir, header, tag):
    b = build(src_dir, "fused_rk_grid", header, f"rk_{tag}")
    b["warp"] = "warp_members" in launch_signature(src_dir, "fused_rk_grid")
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    b["lib"].fused_rk_grid_launch.argtypes = (
        [V] * 5 + [I] + [F] * 6 + [I, F, I, I, I]
        + ([I] if b["warp"] else []) + [V])
    b["lib"].fused_rk_grid_launch.restype = I
    return b


def parse_shape(text):
    """``b<T>`` -> (T, 0), ``w<P>`` -> (32, P)."""
    kind, num = text[0], int(text[1:])
    return (num, 0) if kind == "b" else (32, num)


def launch(b, span, y0, shape, rtol, atol, first_step=None,
           max_steps=100_000, compensated=False):
    """One launch of build ``b`` at ``shape`` (threads, warp members);
    returns (y, status, nsteps, nfev)."""
    threads, warp = shape
    if warp and not b["warp"]:
        raise ValueError("this build has no warp body")
    nb = y0.shape[0]
    y = torch.empty_like(y0)
    ints = [torch.empty(nb, dtype=torch.int32, device="cuda")
            for _ in range(3)]
    t0, tf, rt, at, h0, use_h, mstep, msteps, comp = FK.launch_args(
        span, rtol, atol, first_step, max_steps, compensated, None)
    args = [y0.data_ptr(), y.data_ptr(), *[x.data_ptr() for x in ints], nb,
            t0, tf, float(np.sign(np.float32(tf) - np.float32(t0))), rt, at,
            h0, use_h, mstep, msteps, comp, threads]
    if b["warp"]:
        args.append(warp)
    rc = b["lib"].fused_rk_grid_launch(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch at {shape} failed: CUDA error {rc}")
    return (y, *ints)


def equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def rule_shape(B, n):
    """The RKN wrapper's rule, where the current source has one."""
    rule = getattr(FNG, "_launch_shape", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return rule(B, n, sms) if rule else (grid_threads(n), 0)


def fits(b, shape):
    """Whether ``shape``'s members fit a block's shared memory."""
    need, limit = shared_memory("probe", b["lib"].fused_rk_grid_smem)
    return need * max(1, shape[1]) <= limit


def wave_sweep(builds, sizes, old_threads, shapes, n_turns, n):
    res = {}
    shapes = [s for s in shapes if fits(builds["new wave"], parse_shape(s))]
    for B in sizes:
        y0 = CS.wave_y0(B, n)
        for mode, tol in (("plain", CS.WAVE_TOL),
                          ("compensated", CS.WAVE_COMP_TOL)):
            runs = [(f"old b{t}", lambda t=t, tol=tol: launch(
                builds["old wave"], CS.WAVE_SPAN, y0, (t, 0), **tol))
                for t in old_threads]
            runs += [(f"new {s}", lambda s=s, tol=tol: launch(
                builds["new wave"], CS.WAVE_SPAN, y0, parse_shape(s), **tol))
                for s in shapes]
            times, outs = turns(runs, n_turns)
            ref = outs[runs[0][0]]
            r = {"n": n, "rule": rule_shape(B, n),
                 "max_nsteps": int(ref[2].max()),
                 "mean_nsteps": float(ref[2].double().mean())}
            print(f"b6 wave{n}x{B} {mode}: the wrapper takes "
                  f"{r['rule']}; status {torch.unique(ref[1]).tolist()}, max"
                  f" nsteps {r['max_nsteps']}, mean {r['mean_nsteps']:.2f}")
            for label, _ in runs:
                t = times[label]
                med = statistics.median(t)
                twin = f"old b{parse_shape(label.split()[1])[0]}"
                same = (equal(outs[label], outs[twin]) if twin in outs
                        else None)
                print(f"  b6 wave{n}x{B} {mode} {label}: "
                      f"{' '.join(f'{x:.4f}' for x in t)} ms (median "
                      f"{med:.4f}), {med / r['max_nsteps'] * 1e3:.3f} us per "
                      f"step of the slowest member; bit-identical to {twin} "
                      f"{same}")
                r[label] = {"ms": t, "median_ms": med, "bit_identical": same}
            key = f"{B}/{mode}"
            res[key if n == CS.WAVE_N else f"n{n}/{key}"] = r
    return res


def siblings(builds, n_turns):
    """B4 and B12 at their wrappers' block size, old against new."""
    res = {}
    for kind, span, y0, tol in (
            ("fisher", CS.FISHER_SPAN, CS.fisher_y0(CS.FISHER_M, CS.FISHER_N),
             CS.FISHER_TOL),
            ("ckmol", CS.CKMOL_SPAN, CS.fisher_y0(CS.CKMOL_M, CS.CKMOL_N),
             CS.CKMOL_TOL)):
        shape = (grid_threads(y0.shape[1]), 0)
        runs = [(f"{age}", lambda age=age: launch(
            builds[f"{age} {kind}"], span, y0, shape, **tol))
            for age in ("old", "new")]
        times, outs = turns(runs, n_turns)
        same = equal(outs["old"], outs["new"])
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"{kind}{y0.shape[1]}x{y0.shape[0]} at {shape[0]} threads: "
              f"old {' '.join(f'{x:.4f}' for x in times['old'])} (median "
              f"{med['old']:.4f}), new "
              f"{' '.join(f'{x:.4f}' for x in times['new'])} (median "
              f"{med['new']:.4f}) ms, new/old {med['new'] / med['old']:.4f};"
              f" bit-identical {same}")
        res[kind] = {"old_ms": times["old"], "new_ms": times["new"],
                     "ratio": med["new"] / med["old"], "bit_identical": same}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_rk_grid.cu")
    ap.add_argument("--sizes", default="64,1024",
                    help="comma-separated member counts of the wave")
    ap.add_argument("--old-threads", default="32,64,128,256",
                    help="block sizes of the old kernel")
    ap.add_argument("--shapes", default="",
                    help="shapes of the current kernel (b<T>, w<P>); "
                    "default: the old block sizes")
    ap.add_argument("--n", type=int, default=CS.WAVE_N,
                    help="positions of the wave")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--tag", default="probe_b6", help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    print("SMs", torch.cuda.get_device_properties(0).multi_processor_count,
          "torch", torch.__version__, torch.version.cuda)
    rhs = dict(CS.rkn_grid_rhs(), ckmol=CS.ckdisc_rhs()["ckmol"])
    headers = {
        "wave": _build.fused_rk_grid_header(rkn_consts(Fi5N), True,
                                            (args.n,),
                                            rhs["wave"].cuda_src),
        "fisher": _build.fused_rk_grid_header(
            FK._fused_consts(BS5), False, rhs["fisher"].shape,
            rhs["fisher"].cuda_src),
        "ckmol": _build.fused_rk_grid_header(ck_consts(), False,
                                             rhs["ckmol"].shape,
                                             rhs["ckmol"].cuda_src)}
    old_src = args.old_src.resolve()
    jobs = {f"{age} {k}": (src, h, f"{age}_{k}")
            for k, h in headers.items()
            for age, src in (("old", old_src), ("new", _build.CSRC))}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build_rk, *v) for k, v in jobs.items()}
        builds = {k: f.result() for k, f in futs.items()}
    print(f"builds {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {b['seconds']:.1f} s" for k, b in builds.items()))
    for k, b in builds.items():
        for ln in ptxas_lines(b["log"], entries=True):
            print(f"ptxas[{k}] {ln}")
        OUT[f"build_{k}"] = {"seconds": b["seconds"], "log": b["log"]}
    old_threads = [int(x) for x in args.old_threads.split(",")]
    shapes = ([s for s in args.shapes.split(",") if s] if args.shapes
              else [f"b{t}" for t in old_threads])
    OUT["siblings"] = siblings(builds, args.turns)
    OUT["wave"] = wave_sweep(builds, [int(x) for x in args.sizes.split(",")],
                             old_threads, shapes, args.turns, args.n)
    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
