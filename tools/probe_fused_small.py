"""Member and launch-shape sweep and section breakdown of the small
kernels B1 (csrc/fused_erk.cu), B5 (csrc/fused_rkn.cu) and B11
(csrc/fused_ckdisc.cu) against an earlier build of them, on one card.

Each family has its line (--family, one or more of erk, rkn, pleiades, ck),
as chip_smoke.py runs it or builds it:
  erk  vdp (bench.py:18-54, the main path): Van der Pol at mu = 3 from
       y0 = (linspace(1.5, 2.5), 0), BS5 on t in [0, 10], plain at rtol
       1e-4 / atol 1e-6 and compensated at 1e-6 / 1e-9;
  rkn  kepler (config 3c, validation/benchmarks.py:328-341): Kepler orbits
       of eccentricities linspace(0.1, 0.7) from the pericentre, Fi5N over
       one orbit, plain at rtol 1e-5 / atol 1e-7 and compensated at 1e-7 /
       1e-9;
  pleiades  B5 at M = 14 (config 3b's seven bodies, chip_smoke.py's
       acceleration, which it builds for its registers only): the
       Pleiades start plus 1e-3 N(0, 1) (seed 1) on t in [0, 3], Fi5N at
       Kepler's tolerances;
  ck   swdec (config 1c, validation/benchmarks.py:105-142): the
       sign-switching decay from y0 = 1 + 0.5 U(0, 1) (seed 1, the first
       members of chip_smoke.py's 1,024), CKdisc on t in [0, 5] at rtol
       1e-4 / atol 1e-7 (one mode, "plain");
each at every member count of --sizes.  Shapes: ``t<T>``, one thread per
member and T threads a block; ``g<G>``, G lanes of one warp per member
and 128 / G members a block; ``g<G>x<P>``, the same with P members a
block.  The kernel of --old-src (a directory holding earlier sources with
the headers they include; its launch signature is read from the source:
``..., threads, stream``, ``..., stream`` for 128 threads a block, or
``..., lanes, block_members, stream``) at 128 threads a block and the
current kernel at each shape of --shapes it takes are timed in turns (old,
each shape, the same in reverse, old) with CUDA events around --reps
launches back to back (outputs allocated and arguments converted before,
so that the host's enqueue hides behind the card's work), per launch;
every shape's outputs (y, status, nsteps, nfev) are held bit for bit
against the old kernel's.  The fixed cost of a launch is timed the
same way over a span of one step (t in [0, 1e-6]), plain, at --fixed
member counts.  With --wrapper, the event window holds one call, as
chip_smoke.py times its lines: the current wrapper (solve_fused_erk /
solve_fused_rkn at its rule's shape), the parent's wrapper body (four
allocations, the launch scalars and the launch of the old build at 128
threads) and the current build launched alone once at the rule's shape,
in turns at the family's chip_smoke.py member count (vdp 4,096, kepler
2,048, swdec 1,024): the host's share of those lines.

With --sections, the current source is also built with
FUSED_SMALL_SECTIONS, whose SM clock counters (csrc/rk_lanes.cuh: Clock)
give each member's cycles per section of its attempts (stage sums, RHS,
solution and error sums, norm, controller, loop; B11: stage sums, RHS,
assessments, roots, cascade and controller, loop) and its attempts: printed
at each shape of --section-shapes for the member counts of --sections, as
cycles per attempt of the slowest member (the most attempts) and as
shares over all members; B11's build also gives each member the attempts
of the slowest member of its warp and the attempts in which its warp's
members took other cascade paths (a ballot of go2, go4, accept4 and
fb3_ok), printed as the warp's wait and divergence.  The instrumented
launches are not timed against
the others.  Prints whether each family's old and new builds have the
same SASS opcodes, kernel by kernel, the shape each wrapper's rule takes
(where it has
one), registers, spills and the float32 SASS mix of every build; writes
chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_small.py --family erk,rkn \\
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

import chip_smoke as CS
from _probe import (build, card, launch_signature, ptxas_lines, sass_ops,
                    sass_same, turns, write_out)
from extensisq_tpu_torch import BS5, Fi5N
from extensisq_tpu_torch.ops import _build
from extensisq_tpu_torch.ops import fused_ckdisc as FC
from extensisq_tpu_torch.ops import fused_erk as FK
from extensisq_tpu_torch.ops import fused_rkn as FN

SECTIONS = ("stage_sums", "rhs", "solution", "norm", "control", "loop")
# B11's sections (csrc/fused_ckdisc.cu: Section), in the same slots
CK_SECTIONS = ("stage_sums", "rhs", "assess", "roots", "control", "loop")
SLOTS = len(SECTIONS) + 1    # the sections and the attempts
WARP_SLOTS = 2               # B11: the warp's slowest attempts, its splits
FIXED_SPAN = (0.0, 1e-6)
# family -> (kernel, line, state width, span, [(mode, options)], wrapper)
FAMILIES = {
    "erk": ("fused_erk", "vdp", 2, CS.T_SPAN,
            [("plain", CS.PLAIN_TOL), ("comp", CS.COMP_TOL)], FK),
    "rkn": ("fused_rkn", "kepler", 4, CS.KEP_SPAN,
            [("plain", CS.KEP_PLAIN_TOL), ("comp", CS.KEP_COMP_TOL)], FN),
    "pleiades": ("fused_rkn", "pleiades", 28, CS.PL_SPAN,
                 [("plain", CS.KEP_PLAIN_TOL), ("comp", CS.KEP_COMP_TOL)],
                 FN),
    "ck": ("fused_ckdisc", "swdec", 2, CS.CK_SPAN, [("plain", CS.CK_TOL)],
           FC),
}
OUT = {}


def header(family):
    if family == "ck":
        return _build.fused_ckdisc_header(FC.ck_consts(), 2,
                                          CS.ckdisc_rhs()["swdec"].cuda_src)
    if family == "erk":
        return _build.fused_erk_header(FK._fused_consts(BS5), 2, CS.VDP_CUDA)
    if family == "pleiades":
        return _build.fused_rkn_header(FN.rkn_consts(Fi5N), 14,
                                       CS.PLEIADES_ACC_CUDA)
    return _build.fused_rkn_header(FN.rkn_consts(Fi5N), 2, CS.KEPLER_CUDA)


def convention(src_dir, kernel):
    """How src_dir/<kernel>.cu's launch takes its shape: 'lanes' (lanes,
    block_members), 'threads' (threads a block) or 'fixed' (128)."""
    sig = launch_signature(src_dir, kernel)
    if "int lanes" in sig:
        return "lanes"
    return "threads" if "int threads" in sig else "fixed"


def build_small(src_dir, family, tag, flags=()):
    kernel = FAMILIES[family][0]
    b = build(src_dir, kernel, header(family), tag, flags)
    conv = convention(src_dir, kernel)
    # B1 since it takes per-member params: their pointer after y0
    par = "params" in launch_signature(src_dir, kernel)
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(b["lib"], f"{kernel}_launch")
    ck = kernel == "fused_ckdisc"          # no compensated mode
    fn.argtypes = ([V] * (5 + par) + [I, F, F, F, F, F, I, F, I]
                   + ([] if ck else [I])
                   + {"lanes": [I, I], "threads": [I], "fixed": []}[conv]
                   + [V])
    fn.restype = I
    if flags:
        sec = getattr(b["lib"], f"{kernel}_sections")
        sec.argtypes = [V, V] if ck else [V]
        sec.restype = I
    b.update(conv=conv, kernel=kernel, par=par)
    return b


def sass_mix(so):
    """{kernel instantiation: its float32 SASS mix (FFMA, FMUL, FADD, MUFU)
    and instruction count}, or a note where cuobjdump is not found: a
    product nvcc shares between two sums shows as FFMA turned FADD."""
    ops = sass_ops(so)
    if not isinstance(ops, dict):
        return ops
    out = {}
    for fn, c in ops.items():
        m = re.search(r"kernelI(?:Li(\d+)E)?Lb(\d)E", fn)
        key = f"G={m.group(1) or 1} comp={m.group(2)}" if m else fn
        mix = {o: sum(n for op, n in c.items() if op.split(".")[0] == o)
               for o in ("FFMA", "FMUL", "FADD", "MUFU")}
        mix["total"] = sum(c.values())
        out[key] = mix
    return out


def parse_shape(text):
    """(lanes, members a block) of a shape string."""
    m = re.fullmatch(r"t(\d+)", text)
    if m:
        return 1, int(m.group(1))
    m = re.fullmatch(r"g(\d+)(?:x(\d+))?", text)
    if m:
        g = int(m.group(1))
        return g, int(m.group(2)) if m.group(2) else max(1, 128 // g)
    raise ValueError(f"shape {text!r}: t<T>, g<G> or g<G>x<P>")


def takes(b, shape):
    lanes, bm = shape
    if b["conv"] == "lanes":
        return True
    return lanes == 1 and (b["conv"] == "threads" or bm == 128)


def launcher(b, y0, span, tol, shape, reps=1):
    """A function that launches build ``b`` at ``shape`` ``reps`` times
    into outputs allocated here and returns them (y, status, nsteps,
    nfev)."""
    lanes, bm = shape
    B = y0.shape[0]
    y = torch.empty_like(y0)
    ints = [torch.empty(B, dtype=torch.int32, device="cuda")
            for _ in range(3)]
    fn = getattr(b["lib"], f"{b['kernel']}_launch")
    scalars = FK.launch_args(span, tol["rtol"], tol["atol"],
                             tol.get("first_step"), 100_000,
                             tol.get("compensated", False), None)
    if b["kernel"] == "fused_ckdisc":
        scalars = scalars[:-1]             # no compensated mode
    args = [y0.data_ptr(), *([None] if b["par"] else []), y.data_ptr(),
            *[x.data_ptr() for x in ints], B, *scalars]
    args += {"lanes": [lanes, bm], "threads": [bm],
             "fixed": []}[b["conv"]]
    args = [a if not isinstance(a, float) else ctypes.c_float(a)
            for a in args] + [torch.cuda.current_stream().cuda_stream]

    def run():
        for _ in range(reps):
            rc = fn(*args)
            if rc:
                raise RuntimeError(
                    f"launch at {shape} failed: CUDA error {rc}")
        return (y, *ints)
    return run


def parent_wrapper(b, y0, span, tol):
    """The parent wrapper's body around build ``b``: allocate the outputs,
    convert the launch scalars and launch at 128 threads a block."""
    def run():
        return launcher(b, y0, span, tol, (1, 128))()
    return run


def wrapper_sweep(family, builds, n_turns):
    kernel, line, _, span, modes, mod = FAMILIES[family]
    B = {"erk": 4096, "ck": CS.CK_N}.get(family, CS.KEP_N)
    y0 = members(family, B)
    if family == "ck":
        fun, solve, opts = (CS.ckdisc_rhs()["swdec"], mod.solve_fused_ckdisc,
                            {})
    elif family == "erk":
        fun, solve, opts = (FK.FusedRHS(CS.vdp, CS.VDP_CUDA, 2),
                            mod.solve_fused_erk, {"method": BS5})
    else:
        fun, solve, opts = (CS.rkn_grid_rhs()["kepler"], mod.solve_fused_rkn,
                            {"method": Fi5N})
    res = {}
    for mode, tol in modes:
        solve(fun, span, y0, **opts, **tol)
        shape = solve.last_shape
        runs = [("old wrapper", parent_wrapper(builds[f"old {family}"], y0,
                                               span, tol)),
                ("new wrapper", lambda tol=tol: solve(fun, span, y0, **opts,
                                                      **tol)),
                ("new launch", launcher(builds[f"new {family}"], y0, span,
                                        tol, shape))]
        times, outs = turns(runs, n_turns)
        key = f"{line} {mode} B={B}"
        r = {"shape": list(shape)}
        for label, _ in runs:
            med = statistics.median(times[label])
            same = equal(outs[label], outs["old wrapper"])
            print(f"  {kernel} wrapper {key} {label}: "
                  f"{' '.join(f'{x:.4f}' for x in times[label])} ms "
                  f"(median {med:.4f}); bit-identical to old {same}")
            r[label] = {"ms": times[label], "median_ms": med,
                        "bit_identical": same}
        res[key] = r
    return res


def members(family, n):
    if family == "ck":
        y0 = 1.0 + 0.5 * np.random.RandomState(1).rand(n, 2)
        return torch.tensor(y0.astype(np.float32), device="cuda")
    if family == "erk":
        return CS.vdp_y0(n, torch.float32)
    if family == "pleiades":
        start = torch.tensor(np.concatenate([CS.PL_Q0, CS.PL_V0]))
        noise = torch.tensor(np.random.RandomState(1).randn(n, 28))
        return (start[None, :] + 1e-3 * noise).float().cuda().contiguous()
    return CS.kepler_y0(n)


def equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def rule(family, n, sms, tol):
    """The G the family's wrapper takes (None where it has no rule)."""
    fn = getattr(FAMILIES[family][5], "_lanes_per_member", None)
    if fn is None:
        return None
    if family == "erk":
        return fn(n, sms, tol.get("compensated", False))
    if family == "ck":
        return fn(n, sms)
    return fn(n, sms, FAMILIES[family][2] // 2)


def sweep(family, builds, sizes, shapes, n_turns, reps, span=None,
          modes=None):
    kernel, line, _, fspan, fmodes, _ = FAMILIES[family]
    span = span or fspan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    old, new = builds[f"old {family}"], builds[f"new {family}"]
    res = {}
    for mode, tol in fmodes:
        if modes and mode not in modes:
            continue
        for B in sizes:
            y0 = members(family, B)
            ok = [s for s in shapes if takes(new, parse_shape(s))]
            runs = [("old", launcher(old, y0, span, tol, (1, 128), reps))]
            runs += [(s, launcher(new, y0, span, tol, parse_shape(s), reps))
                     for s in ok]
            times, outs = turns(runs, n_turns)
            times = {k: [x / reps for x in v] for k, v in times.items()}
            ref = outs["old"]
            key = f"{line} {mode} B={B}"
            r = {"rule_G": rule(family, B, sms, tol),
                 "max_nsteps": int(ref[2].max()),
                 "mean_nsteps": ref[2].double().mean().item(),
                 "status": torch.unique(ref[1]).tolist()}
            print(f"{kernel} {key}: the wrapper's rule takes G = "
                  f"{r['rule_G']}; status {r['status']}, nsteps max "
                  f"{r['max_nsteps']}, mean {r['mean_nsteps']:.2f}")
            for label, _ in runs:
                t = times[label]
                med = statistics.median(t)
                same = equal(outs[label], ref)
                print(f"  {kernel} {key} {label}: "
                      f"{' '.join(f'{x:.4f}' for x in t)} ms (median "
                      f"{med:.4f}); bit-identical to old {same}")
                r[label] = {"ms": t, "median_ms": med, "bit_identical": same}
            skipped = [s for s in shapes if s not in ok]
            if skipped:
                print(f"  {kernel} {key}: the current build takes no "
                      f"{', '.join(skipped)}")
            res[key] = r
    return res


def warp_readings(warp, att):
    """B11's warp readings over all members: the mean attempts of the
    slowest member of each member's warp against the member's own, the
    share of lane-attempts spent waiting for the warp's slowest member, and
    the share of a member's attempts in which its warp's members took other
    cascade paths."""
    slowest = warp[:, 0].double()
    split = warp[:, 1].double()
    att = att.double()
    return {"mean_attempts": att.mean().item(),
            "mean_warp_slowest": slowest.mean().item(),
            "wait_share": ((slowest - att).sum() / slowest.sum()).item(),
            "split_share": (split.sum() / att.sum()).item(),
            "split_share_of_warp_attempts":
                (split.sum() / slowest.sum()).item()}


def sections(family, b, sizes, shapes):
    kernel, line, _, span, modes, _ = FAMILIES[family]
    ck = family == "ck"
    names = CK_SECTIONS if ck else SECTIONS
    res = {}
    for mode, tol in modes:
        for B in sizes:
            y0 = members(family, B)
            buf = torch.zeros(B, SLOTS, dtype=torch.int32, device="cuda")
            warp = torch.zeros(B, WARP_SLOTS, dtype=torch.int32,
                               device="cuda")
            fn = getattr(b["lib"], f"{kernel}_sections")
            rc = (fn(buf.data_ptr(), warp.data_ptr()) if ck
                  else fn(buf.data_ptr()))
            if rc:
                raise RuntimeError(f"sections: CUDA error {rc}")
            for s in shapes:
                shape = parse_shape(s)
                if not takes(b, shape):
                    continue
                buf.zero_()
                warp.zero_()
                out = launcher(b, y0, span, tol, shape)()
                torch.cuda.synchronize()
                raw = buf.to(torch.int64) % 2**32
                cyc = raw[:, :len(names)].double()
                att = raw[:, len(names)]
                share = cyc.sum(0) / cyc.sum()
                slow = int(att.argmax())
                n_att = int(att[slow])
                per = cyc[slow] / n_att
                key = f"{line} {mode} B={B} {s}"
                print(f"{kernel} sections {key}: slowest member {slow} "
                      f"({n_att} attempts, {int(out[2][slow])} steps), "
                      f"cycles per attempt {per.sum():.0f}: "
                      + ", ".join(f"{n} {c:.0f}" for n, c in
                                  zip(names, per.tolist())))
                print(f"{kernel} sections {key}: shares over all members "
                      + ", ".join(f"{n} {x:.3f}" for n, x in
                                  zip(names, share.tolist()))
                      + f"; attempts mean {att.double().mean():.2f}")
                res[key] = {
                    "slowest": slow, "attempts": n_att,
                    "steps": int(out[2][slow]),
                    "cycles_per_attempt": dict(zip(names, per.tolist())),
                    "shares": dict(zip(names, share.tolist())),
                    "mean_attempts": att.double().mean().item()}
                if ck:
                    w = warp_readings(warp.to(torch.int64), att)
                    print(f"{kernel} warps {key}: attempts mean "
                          f"{w['mean_attempts']:.2f}, of the warp's slowest "
                          f"member {w['mean_warp_slowest']:.2f} (waiting "
                          f"{w['wait_share']:.3f} of the lane-attempts); "
                          f"attempts whose warp split on the cascade "
                          f"{w['split_share']:.3f} of a member's, "
                          f"{w['split_share_of_warp_attempts']:.3f} of the "
                          f"warp's; the slowest member's warp split in "
                          f"{int(warp[slow, 1])} of its {n_att}")
                    res[key]["warp"] = w
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_erk.cu, "
                    "fused_rkn.cu and fused_ckdisc.cu")
    ap.add_argument("--family", default="erk,rkn",
                    help="comma-separated families: erk, rkn, pleiades, ck")
    ap.add_argument("--sizes", default="512,1024,2048,4096,16384,262144",
                    help="comma-separated member counts")
    ap.add_argument("--shapes", default="t32,t64,t128,t256,g2,g4,g8",
                    help="shapes of the current kernel: t<T>, g<G>, "
                    "g<G>x<P>")
    ap.add_argument("--fixed", default="4096,262144",
                    help="member counts of the one-step launches")
    ap.add_argument("--sections", default="",
                    help="member counts of the section breakdown")
    ap.add_argument("--section-shapes", default="t128",
                    help="shapes of the section breakdown")
    ap.add_argument("--wrapper", action="store_true",
                    help="also time one call of each wrapper per window")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10,
                    help="launches back to back in one timing")
    ap.add_argument("--tag", default="probe_small", help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    print("SMs", torch.cuda.get_device_properties(0).multi_processor_count,
          "torch", torch.__version__, torch.version.cuda)
    families = [f for f in args.family.split(",") if f]
    old_src = args.old_src.resolve()
    jobs = {}
    for f in families:
        jobs[f"old {f}"] = (old_src, f, f"small_old_{f}")
        jobs[f"new {f}"] = (_build.CSRC, f, f"small_new_{f}")
        if args.sections:
            jobs[f"sections {f}"] = (_build.CSRC, f, f"small_sections_{f}",
                                     ("-DFUSED_SMALL_SECTIONS",))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build_small, *v) for k, v in jobs.items()}
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
                             "convention": b["conv"], "sass": sass}
    for f in families:
        same, sizes = sass_same(builds[f"old {f}"], builds[f"new {f}"])
        print(f"SASS [{f}]: old and new opcodes kernel by kernel identical "
              f"{same}; instructions old / new {sizes}")
        OUT[f"sass_same_{f}"] = same
    shapes = [s for s in args.shapes.split(",") if s]
    sizes = [int(x) for x in args.sizes.split(",")]
    fixed = [int(x) for x in args.fixed.split(",") if x]
    for f in families:
        if args.sections:
            OUT[f"sections_{f}"] = sections(
                f, builds[f"sections {f}"],
                [int(x) for x in args.sections.split(",")],
                args.section_shapes.split(","))
        OUT[f"sweep_{f}"] = sweep(f, builds, sizes, shapes, args.turns,
                                  args.reps)
        if fixed:
            print(f"{FAMILIES[f][0]}: one-step launches, t in {FIXED_SPAN}")
            OUT[f"fixed_{f}"] = sweep(f, builds, fixed, shapes, args.turns,
                                      args.reps, span=FIXED_SPAN,
                                      modes=("plain",))
        if args.wrapper and f != "pleiades":
            OUT[f"wrapper_{f}"] = wrapper_sweep(f, builds, 5)
    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
