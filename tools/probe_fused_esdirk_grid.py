"""Launch-shape sweep and section breakdown of the mid-size ESDIRK kernel
(csrc/fused_esdirk_grid.cu, B7) against an earlier build of it, on one
card.

The bench line is config 4d (validation/benchmarks.py:463-502, as
chip_smoke.py runs it): members of the 128-state periodic
reaction-diffusion, y0 = 0.5 + 0.4 amps sin(2 pi x) with amps in [0.3,
0.7], Kv3I on t in [0, 1] at rtol 1e-4 / atol 1e-6, at each member count
of --sizes.  The kernel of --old-src (a directory holding an earlier
fused_esdirk_grid.cu with the headers it includes; its launch signature
is read from the source: ``..., threads, stream`` for one block a member,
or ``..., threads, warp_members, stream``, and whether it takes a
``params`` pointer, which the probe's lines leave null) at each block size
of --old-threads (and its warp at each P of --old-warp, where it has the
warp body) and the current kernel at each shape of --shapes are timed in
turns (old, each shape, the same in reverse, old) with CUDA events around
the launch alone.  A shape is ``b<T>``, one block of T threads a member,
or ``w<P>``, one warp a member and P members a block.  Each shape's
outputs (y, status, nsteps, nfev) are held bit for bit against the old
kernel at the same shape, else at the same block size (a warp against
the old block of 32 threads); so are chip_smoke.py's B7 cases (rd_kv3i,
rd_trbdf2, rd_comp, dae, dirichlet_back, cubic_overflow) at every shape.
Prints the shape the wrapper's rule takes at each size.  With --n the
line's members have n states instead of 128 (the same problem on a finer
grid), and a warp shape whose members do not fit a block's shared memory
is left out.

With --sections, the current source is also built with
FUSED_ESDIRK_GRID_SECTIONS, whose SM clock counters
(csrc/fused_esdirk_grid.cu: Clock) give each member's cycles per section
of its attempts (the dual bands, the factor, the Newton point and RHS,
the replay, the norm and tests, the stage sums, the error and the
controller), its barrier phases (syncs and group reductions) and its
attempts: printed at each shape of --section-shapes for the sizes of
--sections, as cycles and phases per attempt of the slowest member and
as shares over all members.  The instrumented launch is not timed
against the others.  Prints registers and spills of every build and the
barriers in each kernel's SASS; writes chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_esdirk_grid.py \\
        --old-src <dir>/extensisq_tpu_torch/csrc --sections 32,1024
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
from _probe import (build, card, launch_signature, ptxas_lines, sass_ops,
                    turns, write_out)
from extensisq_tpu_torch import Kv3I, TRBDF2
from extensisq_tpu_torch.ops import _build
from extensisq_tpu_torch.ops import fused_esdirk as FE
from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
from extensisq_tpu_torch.ops.fused_erk_grid import shared_memory
from extensisq_tpu_torch.ops.fused_rkc import FusedGridRHS

SECTIONS = ("bands", "factor", "newton_rhs", "replay", "newton_test",
            "stage", "error", "control")
SLOTS = len(SECTIONS) + 2          # the sections, barrier phases, attempts
OUT = {}


def cases():
    """chip_smoke.py's B7 cases: label -> (build label, span, y0, options);
    the build label names (rhs, method)."""
    r8 = CS.rdiff_y0(8, CS.RD_N)
    m_dae = (np.arange(CS.RD_N) % 2 == 0).astype(np.float64)
    d8 = torch.ones(8, CS.RD_N, device="cuda") * torch.linspace(
        0.5, 2.0, 8, device="cuda")[:, None]
    xs = np.linspace(0, 1, 32)
    bump = torch.tensor(np.exp(-40 * (xs - 0.5) ** 2)[None, :]
                        * np.linspace(0.5, 1.0, 8)[:, None],
                        dtype=torch.float32, device="cuda")
    bad = bump.clone()
    bad[3] *= 1e19
    return {
        "rd_kv3i": ("rdiff Kv3I", CS.RD_STEP_SPAN, r8, CS.RD_TOL),
        "rd_trbdf2": ("rdiff TRBDF2", CS.RD_STEP_SPAN, r8, CS.RD_TOL),
        "rd_comp": ("rdiff Kv3I", (0.0, 0.02), r8,
                    dict(rtol=1e-6, atol=1e-9, compensated=True)),
        "dae": ("dae Kv3I", (0.0, 1.0), d8,
                dict(M=m_dae, yp0=-d8, rtol=1e-5, atol=1e-7)),
        "dirichlet_back": ("skew_d32 TRBDF2", (0.2, 0.0), bump,
                           dict(rtol=1e-5, atol=1e-7)),
        "cubic_overflow": ("cubic_d32 Kv3I", (0.0, 0.05), bad,
                           dict(rtol=1e-4, atol=1e-6, first_step=1e-3,
                                max_steps=2000))}


BUILDS = {"rdiff Kv3I": ("rdiff", Kv3I), "rdiff TRBDF2": ("rdiff", TRBDF2),
          "dae Kv3I": ("dae", Kv3I), "skew_d32 TRBDF2": ("skew_d32", TRBDF2),
          "cubic_d32 Kv3I": ("cubic_d32", Kv3I)}


def build_b7(src_dir, header, tag, flags=()):
    b = build(src_dir, "fused_esdirk_grid", header, f"b7_{tag}", flags)
    sig = launch_signature(src_dir, "fused_esdirk_grid")
    b["warp"] = "warp_members" in sig
    b["params"] = "params" in sig
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = b["lib"]
    lib.fused_esdirk_grid_launch.argtypes = (
        [V] * (8 if b["params"] else 7)
        + [I, F, F, F, F, F, I, I, F, I, F, I, I]
        + ([I] if b["warp"] else []) + [V])
    lib.fused_esdirk_grid_launch.restype = I
    if flags:
        lib.fused_esdirk_grid_sections.argtypes = [V]
        lib.fused_esdirk_grid_sections.restype = I
    return b


def parse_shape(text):
    """``b<T>`` -> (T, 0), ``w<P>`` -> (32, P)."""
    kind, num = text[0], int(text[1:])
    return (num, 0) if kind == "b" else (32, num)


def launch(b, span, y0, shape, M=None, yp0=None, rtol=1e-4, atol=1e-6,
           first_step=None, max_steps=100_000, compensated=False):
    """One launch of build ``b`` at ``shape`` (threads, warp members);
    returns (y, status, nsteps, nfev)."""
    threads, warp = shape
    if warp and not b["warp"]:
        raise ValueError("this build has no warp body")
    nb, n = y0.shape
    y = torch.empty_like(y0)
    ints = [torch.empty(nb, dtype=torch.int32, device="cuda")
            for _ in range(3)]
    mass = (None if M is None else
            torch.tensor(FEG._mass_diag(M, n), device="cuda"))
    t0, tf = np.float32(span[0]), np.float32(span[1])
    h0 = (np.float32(first_step) if first_step is not None
          else np.float32(0.01) * abs(tf - t0))
    args = [y0.data_ptr(), None if yp0 is None else yp0.data_ptr(),
            None if mass is None else mass.data_ptr(),
            *([None] if b["params"] else []), y.data_ptr(),
            *[x.data_ptr() for x in ints], nb, float(t0), float(tf),
            float(rtol), float(atol), float(h0),
            int(first_step is None and M is None), int(yp0 is not None),
            np.inf, int(max_steps), FE._tiny_err(n, rtol),
            int(bool(compensated)), threads]
    if b["warp"]:
        args.append(warp)
    rc = b["lib"].fused_esdirk_grid_launch(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch at {shape} failed: CUDA error {rc}")
    return (y, *ints)


def equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def rule_shape(B, n):
    """The wrapper's rule, where the current source has one."""
    rule = getattr(FEG, "_launch_shape", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return rule(B, n, sms) if rule else (FEG.grid_threads(n), 0)


def fits(b, shape):
    """Whether ``shape``'s members fit a block's shared memory."""
    need, limit = shared_memory("probe", b["lib"].fused_esdirk_grid_smem)
    return need * max(1, shape[1]) <= limit


def sweep(builds, sizes, old_threads, shapes, n_turns, n, old_warp=()):
    res = {}
    shapes = [s for s in shapes if fits(builds["new"], parse_shape(s))]
    for B in sizes:
        y0 = CS.rdiff_y0(B, n)
        kw = dict(CS.RD_TOL)
        runs = [(f"old b{t}", lambda t=t: launch(builds["old"], CS.RD_SPAN,
                                                 y0, (t, 0), **kw))
                for t in old_threads]
        runs += [(f"old w{p}", lambda p=p: launch(builds["old"], CS.RD_SPAN,
                                                  y0, (32, p), **kw))
                 for p in old_warp]
        runs += [(f"new {s}", lambda s=s: launch(
            builds["new"], CS.RD_SPAN, y0, parse_shape(s), **kw))
            for s in shapes]
        times, outs = turns(runs, n_turns)
        ref = outs[runs[0][0]]
        r = {"n": n, "rule": rule_shape(B, n),
             "max_nsteps": int(ref[2].max()),
             "mean_nsteps": float(ref[2].double().mean()),
             "mean_nfev": float(ref[3].double().mean())}
        print(f"b7 n={n} B={B}: the wrapper takes {r['rule']}; status "
              f"{torch.unique(ref[1]).tolist()}, max nsteps "
              f"{r['max_nsteps']}, mean nsteps {r['mean_nsteps']:.2f}, mean "
              f"nfev {r['mean_nfev']:.1f}")
        for label, _ in runs:
            t = times[label]
            med = statistics.median(t)
            shape = label.split()[1]
            twin = (f"old {shape}" if f"old {shape}" in outs
                    else f"old b{parse_shape(shape)[0]}")
            same = (equal(outs[label], outs[twin]) if twin in outs
                    else None)
            print(f"  b7 n={n} B={B} {label}: "
                  f"{' '.join(f'{x:.4f}' for x in t)} ms "
                  f"(median {med:.4f}), {med / r['max_nsteps'] * 1e3:.3f} us"
                  f" per step of the slowest member; bit-identical to "
                  f"{twin} {same}")
            r[label] = {"ms": t, "median_ms": med, "bit_identical": same}
        res[str(B) if n == CS.RD_N else f"n{n}/{B}"] = r
    return res


def case_checks(builds, old_threads, shapes):
    """Every B7 case of chip_smoke.py at every shape, against the old
    kernel at the same block size (a warp against the old block of 32)."""
    res = {}
    for label, (blabel, span, y0, kw) in cases().items():
        full = FEG.grid_threads(y0.shape[1])
        old = {t: launch(builds[f"old {blabel}"], span, y0, (t, 0), **kw)
               for t in {32, full} | {t for t in old_threads if t <= full}}
        row = {}
        for s in shapes:
            shape = parse_shape(s)
            if shape[0] not in old:
                continue
            out = launch(builds[f"new {blabel}"], span, y0, shape, **kw)
            row[s] = equal(out, old[shape[0]])
        ref = old[full]
        print(f"b7 case {label}: status {torch.unique(ref[1]).tolist()}, "
              f"mean nsteps {ref[2].double().mean():.2f}; bit-identical to "
              f"the old kernel at the same block size: {row}")
        res[label] = row
    return res


def sections(b, sizes, shapes, n):
    res = {}
    for B in sizes:
        y0 = CS.rdiff_y0(B, n)
        buf = torch.zeros(B, SLOTS, dtype=torch.int32, device="cuda")
        rc = b["lib"].fused_esdirk_grid_sections(buf.data_ptr())
        if rc:
            raise RuntimeError(f"sections: CUDA error {rc}")
        for s in shapes:
            buf.zero_()
            out = launch(b, CS.RD_SPAN, y0, parse_shape(s), **CS.RD_TOL)
            torch.cuda.synchronize()
            row = buf.to(torch.int64).double() % 2**32
            cyc = row[:, :len(SECTIONS)]
            phases, att = row[:, len(SECTIONS)], row[:, len(SECTIONS) + 1]
            share = cyc.sum(0) / cyc.sum()
            slow = int(cyc.sum(1).argmax())
            a = float(att[slow])
            per = cyc[slow] / a
            print(f"b7 sections B={B} {s}: slowest member {slow} ({a:.0f} "
                  f"attempts, {int(out[2][slow])} steps, nfev "
                  f"{int(out[3][slow])}), {float(phases[slow]) / a:.1f} "
                  f"barrier phases and {per.sum():.0f} cycles per attempt: "
                  + ", ".join(f"{k} {c:.0f}" for k, c in
                              zip(SECTIONS, per.tolist())))
            print(f"b7 sections B={B} {s}: shares over all members "
                  + ", ".join(f"{k} {x:.3f}" for k, x in
                              zip(SECTIONS, share.tolist())))
            res[f"{B}/{s}"] = {
                "slowest": slow, "attempts": a,
                "phases_per_attempt": float(phases[slow]) / a,
                "cycles_per_attempt": dict(zip(SECTIONS, per.tolist())),
                "shares": dict(zip(SECTIONS, share.tolist())),
                "mean_phases_per_attempt": float((phases / att).mean())}
    return res


def barriers(so):
    """{kernel function: BAR and SHFL counts and the instruction total of
    its SASS}, or a note where cuobjdump is not found."""
    ops = sass_ops(so)
    if not isinstance(ops, dict):
        return ops
    return {fn: {"total": sum(c.values()),
                 **{op: sum(k for o, k in c.items() if o.split(".")[0] == op)
                    for op in ("BAR", "WARPSYNC", "SHFL", "FCHK")}}
            for fn, c in ops.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_esdirk_grid.cu")
    ap.add_argument("--sizes", default="32,256,1024",
                    help="comma-separated member counts")
    ap.add_argument("--old-threads", default="32,64,128",
                    help="block sizes of the old kernel")
    ap.add_argument("--shapes", default="",
                    help="shapes of the current kernel (b<T>, w<P>); "
                    "default: the old block sizes")
    ap.add_argument("--old-warp", default="",
                    help="members a block of the old kernel's warp shapes "
                    "(where it has the warp body)")
    ap.add_argument("--sections", default="",
                    help="member counts of the section breakdown")
    ap.add_argument("--section-shapes", default="b128",
                    help="shapes of the section breakdown")
    ap.add_argument("--no-cases", action="store_true",
                    help="skip chip_smoke.py's B7 cases")
    ap.add_argument("--n", type=int, default=CS.RD_N,
                    help="states of the line's members")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--tag", default="probe_b7", help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    print("SMs", torch.cuda.get_device_properties(0).multi_processor_count,
          "torch", torch.__version__, torch.version.cuda)
    if args.n != CS.RD_N and not args.no_cases:
        print(f"--n {args.n}: chip_smoke.py's B7 cases are left out (their"
              f" reaction-diffusion has {CS.RD_N} states)")
        args.no_cases = True
    rhs = CS.mid_rhs()
    rhs["rdiff"] = FusedGridRHS(CS.rdiff_mol(args.n), CS._rdiff_cuda(args.n),
                                (args.n,))
    headers = {k: _build.fused_esdirk_grid_header(
        FE._esdirk_consts(m), rhs[r].shape, rhs[r].cuda_src)
        for k, (r, m) in BUILDS.items()}
    old_src = args.old_src.resolve()
    jobs = {"old": (old_src, headers["rdiff Kv3I"], "old"),
            "new": (_build.CSRC, headers["rdiff Kv3I"], "new")}
    if not args.no_cases:
        for k, h in headers.items():
            tag = k.replace(" ", "_")
            jobs[f"old {k}"] = (old_src, h, f"old_{tag}")
            jobs[f"new {k}"] = (_build.CSRC, h, f"new_{tag}")
    if args.sections:
        jobs["sections"] = (_build.CSRC, headers["rdiff Kv3I"], "sections",
                            ("-DFUSED_ESDIRK_GRID_SECTIONS",))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build_b7, *v) for k, v in jobs.items()}
        builds = {k: f.result() for k, f in futs.items()}
    print(f"builds {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {b['seconds']:.1f} s" for k, b in builds.items()))
    for k in ("old", "new", "sections"):
        if k not in builds:
            continue
        for ln in ptxas_lines(builds[k]["log"], entries=True):
            print(f"ptxas[{k}] {ln}")
        sass = barriers(builds[k]["so"])
        for fn, mix in (sass.items() if isinstance(sass, dict) else ()):
            print(f"sass[{k}] {fn}: {mix}")
        OUT[f"build_{k}"] = {"seconds": builds[k]["seconds"],
                             "log": builds[k]["log"], "sass": sass}
    old_threads = [int(x) for x in args.old_threads.split(",")]
    shapes = ([s for s in args.shapes.split(",") if s] if args.shapes
              else [f"b{t}" for t in old_threads])
    if args.sections:
        OUT["sections"] = sections(
            builds["sections"], [int(x) for x in args.sections.split(",")],
            args.section_shapes.split(","), args.n)
    if not args.no_cases:
        OUT["cases"] = case_checks(builds, old_threads, shapes)
    OUT["sweep"] = sweep(builds, [int(x) for x in args.sizes.split(",")],
                         old_threads, shapes, args.turns, args.n,
                         [int(x) for x in args.old_warp.split(",") if x])
    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
