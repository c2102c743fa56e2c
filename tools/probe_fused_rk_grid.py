"""Launch-shape sweep and section breakdown of the mid-size RK kernels (the
ERK, RKN and CKdisc families of csrc/fused_rk_grid.cu: B4, B6 and B12)
against an earlier build of them, on one card.

Each family has its line (--family, one or several of erk, ck, rkn):
  erk  fisher (config 1b, validation/benchmarks.py:69-103, as chip_smoke.py
       runs it): members of the 256-state periodic fisher MoL, y0 = 0.5 +
       0.4 amps sin(2 pi x) with amps in [0.2, 0.8], BS5 on t in [0, 2],
       plain at rtol 1e-5 / atol 1e-7 and compensated at 1e-6 / 1e-9 (the
       tolerances of chip_smoke.py's fisher_comp check);
  ck   ckmol (tests/test_fused_pallas.py:2010-2024 at config 1b's widths):
       the non-smooth advection-reaction MoL from the same y0, CKdisc on t
       in [0, 1.2] at rtol 1e-4 / atol 1e-6;
  rkn  wave (tests/test_fused_pallas.py:1367-1414 at config 1b's widths):
       the 256-position periodic wave (c^2 = 400, u0 = amps sin(2 pi x)
       with amps in [0.5, 1.5], v0 = 0) with Fi5N on t in [0, 4] from
       first_step 0.05, plain at rtol 1e-5 / atol 1e-7 and compensated at
       1e-6 / 1e-9;
each at every member count of --sizes.  The kernel of --old-src (a
directory holding an earlier fused_rk_grid.cu with the headers it
includes; its launch signature is read from the source: ``..., threads,
stream`` for one block a member, or ``..., threads, warp_members,
stream``, and whether it takes a ``params`` pointer, which the probe's
lines leave null) at each shape of --old-threads (block sizes, or ``w<P>`` where
the old build runs the family's warp) and the current kernel at each shape
of --shapes (``b<T>``: one block of T threads a member; ``w<P>``: one
warp a member, P members a block) are timed in turns (old, each shape, the
same in reverse, old) with CUDA events around the launch alone; each
shape's outputs (y, status, nsteps, nfev) are held bit for bit against
the old kernel at the same shape, else at the same block size (a warp
against the old block of 32 threads).  The families not swept run at
their wrapper's shape for 64 members (one block of grid_threads(n)
threads where that is a warp an earlier build may refuse), old against
new, timed in turns and held bit for bit.  With --n the swept lines have
n states (positions) instead of 256, and a warp shape whose members do
not fit a block's shared memory is left out.

With --sections, the current source is also built with
FUSED_RK_GRID_SECTIONS, whose SM clock counters (csrc/fused_rk_grid.cu:
Clock) give each member's cycles per section of its attempts (stage
arguments, RHS, solution and norms, reduction waits, controller or
cascade, commit), its barrier phases (syncs and group reductions, the
start's included), its attempts and, for CKdisc, the attempts that E1 and
E2 veto: printed at each shape of --section-shapes for the member counts
of --sections, as cycles and phases per attempt of the slowest member and
as shares over all members.  The instrumented launches are not timed
against the others.  Prints the shape each wrapper's rule takes, registers
and spills of every build; writes chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_rk_grid.py --family erk,ck \\
        --old-src <dir>/extensisq_tpu_torch/csrc --sections 64,1024
"""
import argparse
import ctypes
import importlib
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as CS
from _probe import (build, card, launch_signature, ptxas_lines, sass_ops,
                    turns, write_out)
from extensisq_tpu_torch import BS5, Fi5N
from extensisq_tpu_torch.ops import FusedGridRHS, _build
from extensisq_tpu_torch.ops import fused_erk as FK
from extensisq_tpu_torch.ops.fused_ckdisc import ck_consts
from extensisq_tpu_torch.ops.fused_erk_grid import (grid_threads,
                                                    shared_memory)
from extensisq_tpu_torch.ops.fused_rkn import rkn_consts

SECTIONS = ("args", "rhs", "norm", "wait", "control", "commit")
SLOTS = len(SECTIONS) + 4    # the sections, phases, attempts, two vetoes
# family -> (line, wrapper module, [(mode, options)], span)
FAMILIES = {
    "erk": ("fisher", "fused_erk_grid", [
        ("plain", CS.FISHER_TOL),
        ("compensated", dict(rtol=1e-6, atol=1e-9, compensated=True))],
        CS.FISHER_SPAN),
    "ck": ("ckmol", "fused_ckdisc_grid", [("plain", CS.CKMOL_TOL)],
           CS.CKMOL_SPAN),
    "rkn": ("wave", "fused_rkn_grid", [("plain", CS.WAVE_TOL),
                                       ("compensated", CS.WAVE_COMP_TOL)],
            CS.WAVE_SPAN)}
OUT = {}


def header(family, n):
    """The generated header of ``family``'s line at n states."""
    if family == "rkn":
        return _build.fused_rk_grid_header(
            rkn_consts(Fi5N), True, (n,), CS.rkn_grid_rhs()["wave"].cuda_src)
    if family == "erk":
        fun = FusedGridRHS(CS.fisher_mol(n), CS._fisher_cuda(n), (n,))
        return _build.fused_rk_grid_header(FK._fused_consts(BS5), False,
                                           fun.shape, fun.cuda_src)
    fun = FusedGridRHS(CS.ck_mol(n), CS._ck_mol_cuda(n), (n,))
    return _build.fused_rk_grid_header(ck_consts(), False, fun.shape,
                                       fun.cuda_src)


def y0_of(family, members, n):
    return (CS.wave_y0(members, n) if family == "rkn"
            else CS.fisher_y0(members, n))


def build_rk(src_dir, hdr, tag, flags=()):
    b = build(src_dir, "fused_rk_grid", hdr, f"rk_{tag}", flags)
    sig = launch_signature(src_dir, "fused_rk_grid")
    b["warp"] = "warp_members" in sig
    b["params"] = "params" in sig
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = b["lib"]
    lib.fused_rk_grid_launch.argtypes = (
        [V] * (6 if b["params"] else 5) + [I] + [F] * 6 + [I, F, I, I, I]
        + ([I] if b["warp"] else []) + [V])
    lib.fused_rk_grid_launch.restype = I
    if "-DFUSED_RK_GRID_SECTIONS" in flags:
        lib.fused_rk_grid_sections.argtypes = [V]
        lib.fused_rk_grid_sections.restype = I
    return b


def sass_same(old, new):
    """Whether two builds' kernels have the same SASS opcodes, kernel by
    kernel (their mangled names differ where the launch's parameters do),
    and each build's total instruction count."""
    counts = [sass_ops(b["so"]) for b in (old, new)]
    if any(isinstance(c, str) for c in counts):
        return counts[0], None
    keys = [sorted(sorted(c.items()) for c in cs.values()) for cs in counts]
    return keys[0] == keys[1], [sum(sum(c.values()) for c in cs.values())
                                for cs in counts]


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
    args = [y0.data_ptr(), *([None] if b["params"] else []), y.data_ptr(),
            *[x.data_ptr() for x in ints], nb,
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


def rule_shape(family, B, n):
    """The family's wrapper rule, where the current source has one."""
    mod = importlib.import_module(
        f"extensisq_tpu_torch.ops.{FAMILIES[family][1]}")
    rule = getattr(mod, "_launch_shape", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return rule(B, n, sms) if rule else (grid_threads(n), 0)


def fits(b, shape):
    """Whether ``shape``'s members fit a block's shared memory."""
    need, limit = shared_memory("probe", b["lib"].fused_rk_grid_smem)
    return need * max(1, shape[1]) <= limit


def sweep(family, builds, sizes, old_threads, shapes, n_turns, n):
    """Every member count of ``sizes``: the old build at each block size
    against the current build at each shape."""
    line, _, modes, span = FAMILIES[family]
    shapes = [s for s in shapes if fits(builds[f"new {family}"],
                                        parse_shape(s))]
    res = {}
    for B in sizes:
        y0 = y0_of(family, B, n)
        for mode, tol in modes:
            runs = [(f"old {t}", lambda t=t, tol=tol: launch(
                builds[f"old {family}"], span, y0, parse_shape(t), **tol))
                for t in old_threads]
            runs += [(f"new {s}", lambda s=s, tol=tol: launch(
                builds[f"new {family}"], span, y0, parse_shape(s), **tol))
                for s in shapes]
            times, outs = turns(runs, n_turns)
            ref = outs[runs[0][0]]
            r = {"n": n, "rule": rule_shape(family, B, n),
                 "max_nsteps": int(ref[2].max()),
                 "mean_nsteps": float(ref[2].double().mean())}
            tag = f"{line}{n}x{B} {mode}"
            print(f"{tag}: the wrapper takes {r['rule']}; status "
                  f"{torch.unique(ref[1]).tolist()}, max nsteps "
                  f"{r['max_nsteps']}, mean {r['mean_nsteps']:.2f}")
            for label, _ in runs:
                t = times[label]
                med = statistics.median(t)
                shape = label.split()[1]
                twin = (f"old {shape}" if f"old {shape}" in outs
                        else f"old b{parse_shape(shape)[0]}")
                same = (equal(outs[label], outs[twin]) if twin in outs
                        else None)
                print(f"  {tag} {label}: "
                      f"{' '.join(f'{x:.4f}' for x in t)} ms (median "
                      f"{med:.4f}), {med / r['max_nsteps'] * 1e3:.3f} us per "
                      f"step of the slowest member; bit-identical to {twin} "
                      f"{same}")
                r[label] = {"ms": t, "median_ms": med, "bit_identical": same}
            res[f"n{n}/{B}/{mode}"] = r
    return res


def siblings(families, builds, n_turns):
    """The other families for 64 members, old against new, at the shape
    both builds take: the wrapper's where the old build has that shape
    (B6's rule), else one block of ``grid_threads(n)`` threads, the shape
    of the wrappers that had no rule."""
    res = {}
    for family in families:
        line, _, modes, span = FAMILIES[family]
        n = CS.WAVE_N
        y0 = y0_of(family, 64, n)
        shape = rule_shape(family, 64, n)
        if shape[1] and family != "rkn":
            shape = (grid_threads(n), 0)
        for mode, tol in modes:
            runs = [(age, lambda age=age, tol=tol: launch(
                builds[f"{age} {family}"], span, y0, shape, **tol))
                for age in ("old", "new")]
            times, outs = turns(runs, n_turns)
            same = equal(outs["old"], outs["new"])
            med = {k: statistics.median(v) for k, v in times.items()}
            print(f"{line}{n}x64 {mode} at {shape}: old "
                  f"{' '.join(f'{x:.4f}' for x in times['old'])} (median "
                  f"{med['old']:.4f}), new "
                  f"{' '.join(f'{x:.4f}' for x in times['new'])} (median "
                  f"{med['new']:.4f}) ms, new/old "
                  f"{med['new'] / med['old']:.4f}; bit-identical {same}")
            res[f"{line}/{mode}"] = {
                "shape": shape, "old_ms": times["old"],
                "new_ms": times["new"], "ratio": med["new"] / med["old"],
                "bit_identical": same}
    return res


def sections(family, builds, sizes, shapes, n):
    """Section clocks, phases, attempts and vetoes of the instrumented
    build at each member count and shape."""
    line, _, modes, span = FAMILIES[family]
    res = {}
    b = builds[f"sections {family}"]
    for B in sizes:
        y0 = y0_of(family, B, n)
        buf = torch.zeros(B, SLOTS, dtype=torch.int32, device="cuda")
        rc = b["lib"].fused_rk_grid_sections(buf.data_ptr())
        if rc:
            raise RuntimeError(f"sections: CUDA error {rc}")
        for s in shapes:
            if not fits(b, parse_shape(s)):
                continue
            mode, tol = modes[0]
            buf.zero_()
            out = launch(b, span, y0, parse_shape(s), **tol)
            torch.cuda.synchronize()
            row = buf.to(torch.int64).double() % 2**32
            k = len(SECTIONS)
            cyc = row[:, :k]
            phases, att = row[:, k], row[:, k + 1]
            veto = row[:, k + 2:k + 4].sum(0) / att.sum()
            share = cyc.sum(0) / cyc.sum()
            slow = int(cyc.sum(1).argmax())
            a = float(att[slow])
            per = cyc[slow] / a
            tag = f"{line}{n}x{B} {mode} {s}"
            print(f"sections {tag}: slowest member {slow} ({a:.0f} "
                  f"attempts, {int(out[2][slow])} steps, nfev "
                  f"{int(out[3][slow])}), {float(phases[slow]) / a:.2f} "
                  f"barrier phases and {per.sum():.0f} cycles per "
                  "attempt: " + ", ".join(
                      f"{x} {c:.0f}" for x, c in zip(SECTIONS,
                                                     per.tolist())))
            print(f"sections {tag}: shares over all members "
                  + ", ".join(f"{x} {v:.3f}" for x, v in
                              zip(SECTIONS, share.tolist()))
                  + f"; attempts vetoed by E1 {float(veto[0]):.4f}, by"
                  f" E2 {float(veto[1]):.4f}; mean phases per attempt "
                  f"{float((phases / att).mean()):.2f}")
            res[f"{B}/{s}"] = {
                "slowest": slow, "attempts": a,
                "phases_per_attempt": float(phases[slow]) / a,
                "cycles_per_attempt": dict(zip(SECTIONS, per.tolist())),
                "shares": dict(zip(SECTIONS, share.tolist())),
                "veto_e1": float(veto[0]), "veto_e2": float(veto[1]),
                "mean_phases_per_attempt": float((phases / att).mean())}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_rk_grid.cu")
    ap.add_argument("--family", default="rkn",
                    help="comma-separated families to sweep: erk, ck, rkn")
    ap.add_argument("--sizes", default="64,1024",
                    help="comma-separated member counts")
    ap.add_argument("--old-threads", default="32,64,128,256",
                    help="block sizes (or b<T>, w<P> shapes, where the "
                    "old build has them) of the old kernel")
    ap.add_argument("--shapes", default="",
                    help="shapes of the current kernel (b<T>, w<P>); "
                    "default: the old block sizes")
    ap.add_argument("--sections", default="",
                    help="member counts of the section breakdown")
    ap.add_argument("--section-shapes", default="b256",
                    help="shapes of the section breakdown")
    ap.add_argument("--n", type=int, default=CS.WAVE_N,
                    help="states (positions) of the swept lines' members")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--tag", default="probe_rk_grid",
                    help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    print("SMs", torch.cuda.get_device_properties(0).multi_processor_count,
          "torch", torch.__version__, torch.version.cuda)
    swept = [f for f in args.family.split(",") if f]
    others = [f for f in FAMILIES if f not in swept]
    old_src = args.old_src.resolve()
    jobs = {}
    for f in swept + others:
        hdr = header(f, args.n if f in swept else CS.WAVE_N)
        jobs[f"old {f}"] = (old_src, hdr, f"old_{f}")
        jobs[f"new {f}"] = (_build.CSRC, hdr, f"new_{f}")
        if f in swept and args.sections:
            jobs[f"sections {f}"] = (_build.CSRC, hdr, f"sections_{f}",
                                     ("-DFUSED_RK_GRID_SECTIONS",))
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
    for f in swept + others:
        same, sizes = sass_same(builds[f"old {f}"], builds[f"new {f}"])
        print(f"SASS [{f}]: old and new opcodes kernel by kernel identical "
              f"{same}; instructions old / new {sizes}")
        OUT[f"sass_same_{f}"] = same
    old_threads = [x if x[0] in "bw" else f"b{x}"
                   for x in args.old_threads.split(",")]
    shapes = ([s for s in args.shapes.split(",") if s] if args.shapes
              else old_threads)
    OUT["siblings"] = siblings(others, builds, args.turns)
    for f in swept:
        if args.sections:
            OUT[f"sections_{f}"] = sections(
                f, builds, [int(x) for x in args.sections.split(",")],
                args.section_shapes.split(","), args.n)
        OUT[f"sweep_{f}"] = sweep(
            f, builds, [int(x) for x in args.sizes.split(",")],
            old_threads, shapes, args.turns, args.n)
    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
