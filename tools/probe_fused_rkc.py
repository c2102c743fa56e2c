"""Old-against-new timing of the fused RKC kernels (csrc/fused_rkc.cu, B9
and B10) on one card.

B10 on config 5d (a rho bound) and 5e (the power iteration)
(validation/benchmarks.py:588-668): M members of the 2x64x128 Brusselator
(u0 = 1 + 0.3 sin(2 pi x), v0 = 3, B = linspace(2.8, 3.5, M)) on t in
[0, 4] at rtol 1e-4 / atol 1e-7, at each M of --sizes (default 8, 64 and
256), and at each grid of --extra (NYxNX:M,M..., 5d only); B9 on config
5c's 2x256x256 grid on t in [0, 1], the current kernel in its global and
(where it fits) its shared placement of the elementwise arrays, with each
build of --b9-src (label=directory, e.g. a copy of the sources with one
header of an earlier commit; in its shared placement where it has one)
beside them; --b9-only skips B10.  The
kernel of --old-src (a directory
holding an earlier fused_rkc.cu with the headers it includes; its launch
signature, with or without the cluster size, is read from the source) and
the current one are built from the same generated header, the current one
also in each variant of --variants (label:NAME=value, a copy of the
current sources with ``constexpr int NAME`` of fused_rkc.cu set to value,
e.g. kClusterThreads=512).  Each launch is timed
alone with CUDA events, in turns (old, each configuration of the current
kernel, the same in reverse, old, twice): B10 at the wrapper's cluster
size C (ops/fused_rkc.py:_cluster_size), at every other C whose chunk fits
in shared memory (C = 1: one block per member, the arrays in global
memory) and each variant at the rule's C (at least 2).
Prints C, the clusters resident at once and the shared memory of a CTA at
each C, registers and spills of every build, the cluster barriers, fences
and L1 invalidations in each kernel's SASS (cuobjdump), whether B9 and
B10 at C = 1 are bit-identical to the old kernel and whether three
launches of B10 at the rule's C and of B9 in each placement repeat bit
for bit, whether B9 with the power iteration is bit-identical to the old
kernel at each placement, whether each old build's SASS opcodes are the
current one's kernel by kernel (cuobjdump; where not, each kernel apart
with its opcode counts less the old build's), and us per RHS
evaluation of the slowest member.  Writes chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_rkc.py \
        --old-src <dir>/extensisq_tpu_torch/csrc
"""
import argparse
import ctypes
import re
import shutil
import statistics
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from _probe import (build, card, launch_signature, ptxas_lines, sass_ops,
                    sass_same,
                    turns, write_out)
from extensisq_tpu_torch import parallel
from extensisq_tpu_torch.ops import _build
from extensisq_tpu_torch.ops import fused_rkc as FR

RTOL, ATOL = 1e-4, 1e-7
ENS_NY, ENS_NX, ENS_TF = 64, 128, 4.0
BRUS_N = 256
BRUS_RHO = 8.0 * 0.02 * BRUS_N**2 + 5.0
MAX_STEPS = 100_000
TURNS = 2
REPEATS = 3
SASS_OPS = ("UCGABAR", "CCTL", "MEMBAR", "FENCE", "BAR", "ERRBAR")
OUT = {}


def ens_y0(members, ny=ENS_NY, nx=ENS_NX):
    x = np.linspace(0, 1, nx, endpoint=False)
    y0 = np.zeros((members, 2, ny, nx), np.float32)
    y0[:, 0] = 1.0 + 0.3 * np.sin(2 * np.pi * x)[None, :]
    y0[:, 1] = 3.0
    return torch.tensor(y0, device="cuda")


def b9_y0():
    n = BRUS_N
    xg, yg = np.meshgrid(np.linspace(0, 1, n, endpoint=False),
                         np.linspace(0, 1, n, endpoint=False))
    return torch.tensor(np.stack([1.0 + 0.5 * np.sin(2 * np.pi * xg)
                                  * np.sin(2 * np.pi * yg),
                                  3.0 + 0.1 * np.cos(2 * np.pi * xg)]),
                        dtype=torch.float32, device="cuda")


def has_cluster(src_dir):
    """Whether src_dir/fused_rkc.cu's launch takes a cluster size."""
    return "int cluster" in launch_signature(src_dir, "fused_rkc")


def build_rkc(src_dir, header, tag):
    """``src_dir``/fused_rkc.cu built with ``header``, its launch and
    capacity queries bound; the dict of ``_probe.build`` with whether the
    launch takes a cluster size."""
    b = build(src_dir, "fused_rkc", header, f"rkc_{tag}")
    lib = b["lib"]
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cl = has_cluster(src_dir)
    lib.fused_rkc_launch.argtypes = (
        [I, I] + [V] * 9 + [I] + [F] * 8 + [I] * (6 if cl else 5) + [V])
    lib.fused_rkc_launch.restype = I
    lib.fused_rkc_grid_capacity.argtypes = [I, I, ctypes.POINTER(I)]
    lib.fused_rkc_grid_capacity.restype = I
    if cl:
        lib.fused_rkc_cluster_capacity.argtypes = (
            [I, I, I] + [ctypes.POINTER(I)] * 2)
        lib.fused_rkc_cluster_capacity.restype = I
    b["cluster"] = cl
    return b


def variant_src(name, const, value):
    """A copy of the current sources under the build directory with
    ``constexpr int <const> = <value>;`` in fused_rkc.cu."""
    d = _build.BUILD_DIR / f"probe_rkc_src_{name}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d)
    f = d / "fused_rkc.cu"
    text, n = re.subn(rf"constexpr int {const} = \d+;",
                      f"constexpr int {const} = {int(value)};",
                      f.read_text())
    if n != 1:
        raise RuntimeError(f"fused_rkc.cu: no constexpr int {const}")
    f.write_text(text)
    return d


def sass_barriers(so):
    """{kernel function: {op: count}} for the ops of SASS_OPS, with the
    function's instruction count as "total", or a note where cuobjdump is
    not found."""
    ops = sass_ops(so)
    if not isinstance(ops, dict):
        return ops
    return {fn: {"total": sum(c.values()),
                 **{op: n for op, n in c.items()
                    if op.split(".")[0].startswith(SASS_OPS)}}
            for fn, c in ops.items()}


class Line:
    """One B10 or B9 problem: inputs, and launches of a build on them."""

    def __init__(self, y0, params, tf, rho, grid):
        self.y0, self.params, self.tf, self.grid = y0, params, tf, grid
        self.mode = FR._rho_mode(rho)
        self.rho_const = float(np.float32(rho)) if self.mode == 0 else 0.0
        self.members = y0.shape[0] if not grid else 1
        self.ntot = int(np.prod(y0.shape[1:] if not grid else y0.shape))
        self.mmax, _ = FR._mmax_for(RTOL, None)

    def launch(self, b, cluster=1, threads=None, blocks=0, placement=1):
        dev = self.y0.device
        M = self.members
        y = torch.empty_like(self.y0)
        ints = [torch.empty(M, dtype=torch.int32, device=dev)
                for _ in range(4)]
        work = torch.empty(M * FR.N_ARRAYS * self.ntot, dtype=torch.float32,
                           device=dev)
        # B9: the blocks' sums and, in a build with a grid barrier of its
        # own, the barrier's counter
        part = torch.empty(2 * max(blocks, 1) + 1, dtype=torch.float32,
                           device=dev)
        if threads is None:
            threads = FR.GRID_THREADS if self.grid else FR.BLOCK_THREADS
        args = [placement if self.grid else 0, self.mode, self.y0.data_ptr(),
                None if self.params is None else self.params.data_ptr(),
                y.data_ptr(), *[x.data_ptr() for x in ints],
                work.data_ptr(), part.data_ptr(), M, 0.0,
                float(np.float32(self.tf)), 1.0, float(np.float32(RTOL)),
                float(np.float32(ATOL)), -1.0, self.rho_const, np.inf,
                self.mmax, MAX_STEPS, 0, threads, blocks]
        if b["cluster"]:
            args.append(cluster)
        elif cluster != 1:
            raise ValueError("the old kernel has no cluster launch")
        rc = b["lib"].fused_rkc_launch(*args,
                                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return (y, *ints)


def equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def capacity(b, mode, threads):
    """{C: (clusters resident at once, dynamic shared memory bytes)}."""
    res = {}
    for c in FR.CLUSTER_SIZES:
        n, nbytes = ctypes.c_int(0), ctypes.c_int(0)
        rc = b["lib"].fused_rkc_cluster_capacity(mode, threads, c,
                                                 ctypes.byref(n),
                                                 ctypes.byref(nbytes))
        if rc:
            raise RuntimeError(f"cluster capacity C = {c}: CUDA error {rc}")
        res[c] = (n.value, nbytes.value)
    return res


def b10_sizes(builds, variants, ny, nx, sizes, modes, old_at_rule=False):
    old, new = builds[f"old_{ny}x{nx}"], builds[f"new_{ny}x{nx}"]
    for label, rho in (("5d", 8.0 * 0.02 * nx**2 + 5.5), ("5e", None)):
        if label not in modes:
            continue
        mode = FR._rho_mode(rho)
        cap = capacity(new, mode, FR.BLOCK_THREADS) if new["cluster"] \
            else {}
        print(f"B10 {label} 2x{ny}x{nx}: clusters resident at once and "
              f"shared memory per CTA, CTAs of {FR.BLOCK_THREADS}: "
              + ", ".join(f"C={c}: {n} ({b} B)" for c, (n, b) in cap.items()))
        OUT[f"b10_{label}_2x{ny}x{nx}_capacity"] = cap
        for M in sizes:
            line = Line(ens_y0(M, ny, nx), torch.tensor(
                np.linspace(2.8, 3.5, M), dtype=torch.float32,
                device="cuda")[:, None], ENS_TF, rho, False)
            held = {c: n for c, (n, _) in cap.items()}
            rule = FR._cluster_size(M, held) if cap else 1
            oc = rule if old_at_rule and old["cluster"] else 1
            runs = [("old", lambda: line.launch(old, oc))]
            cs = [1] + [c for c in (2, 4, 8) if held.get(c, 0) > 0]
            if new["cluster"]:
                runs += [(f"new C={c}", lambda c=c: line.launch(new, c))
                         for c in cs]
                vc = max(rule, 2)
                for name, threads in variants:
                    b = builds[f"{name}_{ny}x{nx}"]
                    if held.get(vc, 0) > 0:
                        runs.append((f"{name} C={vc}",
                                     lambda b=b, t=threads:
                                     line.launch(b, vc, t)))
            else:
                runs.append(("new C=1", lambda: line.launch(new)))
            times, outs = turns(runs, TURNS)
            ref = outs["old"]
            tag = f"b10 {label} 2x{ny}x{nx} M={M}"
            print(f"{tag}: the rule takes C = {rule}; old nsteps "
                  f"{int(ref[2].min())}-{int(ref[2].max())}, max nfev "
                  f"{int(ref[3].max())}, status {torch.unique(ref[1]).tolist()}")
            res = {"rule_C": rule}
            for lab, _ in runs:
                o, t = outs[lab], times[lab]
                med = statistics.median(t)
                # evaluations of the slowest member, the power iteration's
                # included
                ev = int((o[3] + (o[4] if mode == 2 else 0)).max()) - 1
                ok = (o[1] == 1).reshape(-1)
                dy = (o[0] - ref[0]).reshape(M, -1)[ok].abs().max().item() \
                    if bool(ok.any()) else float("nan")
                dn = int((o[2] - ref[2]).abs().max())
                print(f"  {tag} {lab}: {' '.join(f'{x:.3f}' for x in t)} ms "
                      f"(median {med:.3f}), {med / ev * 1e3:.3f} us per "
                      f"evaluation of the slowest member ({ev}); vs old: "
                      f"bit-identical {equal(o, ref)}, max |dy| {dy:.3e}, "
                      f"max |dnsteps| {dn}, status equal "
                      f"{torch.equal(o[1], ref[1])}")
                res[lab] = {"ms": t, "median_ms": med, "evals": ev,
                            "bit_identical": equal(o, ref), "dy": dy,
                            "dnsteps": dn}
            if new["cluster"]:
                first = line.launch(new, rule)
                reps = [line.launch(new, rule) for _ in range(REPEATS - 1)]
                torch.cuda.synchronize()
                same = all(equal(first, r) for r in reps)
                print(f"  {tag}: {REPEATS} launches at C = {rule} repeat "
                      f"bit for bit: {same}")
                res["repeat_bit_identical"] = same
            OUT[tag] = res


def grid_blocks(b, ntot):
    """B9's grid for build ``b``: one block of GRID_THREADS per SM, within
    the resident grid and at most one thread per element."""
    cap = ctypes.c_int(0)
    rc = b["lib"].fused_rkc_grid_capacity(0, FR.GRID_THREADS,
                                          ctypes.byref(cap))
    if rc:
        raise RuntimeError(f"B9 capacity: CUDA error {rc}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return min(cap.value, sms, -(-ntot // FR.GRID_THREADS))


def shared_fits(b, blocks):
    """(bytes, fits) of B9's shared placement in build ``b`` on ``blocks``
    blocks, or None where the build has no shared placement."""
    lib = b["lib"]
    if not hasattr(lib, "fused_rkc_grid_smem"):
        return None
    I = ctypes.c_int
    lib.fused_rkc_grid_smem.argtypes = [I, I, I] + [ctypes.POINTER(I)] * 2
    lib.fused_rkc_grid_smem.restype = I
    nbytes, fits = I(0), I(0)
    rc = lib.fused_rkc_grid_smem(0, FR.GRID_THREADS, blocks,
                                 ctypes.byref(nbytes), ctypes.byref(fits))
    if rc:
        raise RuntimeError(f"B9 shared memory query: CUDA error {rc}")
    return nbytes.value, bool(fits.value)


def b9(builds, labels, n_turns):
    """B9 on 5c's grid: the old build, the current one in its global and
    (where it fits) its shared placement, and each build of ``labels``
    (--b9-src) in its global placement, in turns; bit identity with the
    old build, and three launches of each current placement repeated."""
    line = Line(b9_y0(), None, 1.0, BRUS_RHO, True)
    kinds = ["old", "new"] + list(labels)
    blocks = {k: grid_blocks(builds[f"{k}_b9"], line.ntot) for k in kinds}
    runs = [(k if k != "new" else "new global",
             lambda k=k: line.launch(builds[f"{k}_b9"], blocks=blocks[k]))
            for k in kinds[:2]]
    for k in labels:
        # a build of --b9-src in its shared placement where it has one
        ks = shared_fits(builds[f"{k}_b9"], blocks[k])
        p = 2 if ks is not None and ks[1] else 1
        runs.append((f"{k} {'shared' if p == 2 else 'global'}",
                     lambda k=k, p=p: line.launch(
                         builds[f"{k}_b9"], blocks=blocks[k], placement=p)))
    sh = shared_fits(builds["new_b9"], blocks["new"])
    res = {"blocks": blocks, "shared": sh}
    for label, fn in list(runs[2:]):
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"b9 {label}: {e}; not timed")
            res[label] = str(e)
            runs.remove((label, fn))
    if sh is not None:
        print(f"b9: shared placement {sh[0]} B a block, fits {sh[1]}")
        if sh[1]:
            runs.insert(2, ("new shared", lambda: line.launch(
                builds["new_b9"], blocks=blocks["new"], placement=2)))
    times, outs = turns(runs, n_turns)
    ev = int(outs["new global"][3].max()) - 1
    for label, _ in runs:
        med = statistics.median(times[label])
        same = equal(outs["old"], outs[label])
        print(f"b9 2x{BRUS_N}x{BRUS_N} {label}: "
              f"{' '.join(f'{x:.3f}' for x in times[label])} ms (median "
              f"{med:.3f}), {med / ev * 1e3:.3f} us per evaluation ({ev}); "
              f"bit-identical to old {same}")
        res[label] = {"ms": times[label], "median_ms": med,
                      "bit_identical": same}
    for label, fn in runs[1:3]:
        if label.startswith("new"):
            first = fn()
            again = [fn() for _ in range(REPEATS - 1)]
            torch.cuda.synchronize()
            same = all(equal(first, r) for r in again)
            print(f"b9 {label}: {REPEATS} launches repeat bit for bit {same}")
            res[label]["repeat_bit_identical"] = same
    print(f"b9: status {int(outs['new global'][1][0])}, nsteps "
          f"{int(outs['new global'][2][0])}")
    # the power iteration's kernels, old against new at both placements
    power = Line(b9_y0(), None, 1.0, None, True)
    same = {}
    for placement in (1, 2) if sh is not None and sh[1] else (1,):
        o, n = (power.launch(builds[f"{k}_b9"], blocks=blocks[k],
                             placement=placement) for k in ("old", "new"))
        torch.cuda.synchronize()
        same[placement] = equal(o, n)
    print(f"b9 2x{BRUS_N}x{BRUS_N} power iteration: bit-identical to old at "
          f"placements {same}")
    res["power_bit_identical"] = same
    OUT["b9"] = res


def sass_apart(old, new):
    """The kernels whose SASS opcodes differ between two builds, each with
    new's opcode counts less old's (kernels paired by their order in each
    build's dump, which follows their names once sorted)."""
    a, b = sass_ops(old["so"]), sass_ops(new["so"])
    if not isinstance(a, dict) or not isinstance(b, dict):
        return {}
    out = {}
    for (ka, ca), (kb, cb) in zip(sorted(a.items()), sorted(b.items())):
        if ca != cb:
            d = Counter(cb)
            d.subtract(ca)
            out[kb] = {op: n for op, n in d.items() if n}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_rkc.cu")
    ap.add_argument("--sizes", default="8,64,256",
                    help="comma-separated B10 member counts at 2x64x128")
    ap.add_argument("--extra", default="",
                    help="more B10 grids, 5d only: NYxNX:M,M;NYxNX:M")
    ap.add_argument("--variants",
                    default="t512:kClusterThreads=512",
                    help="label:NAME=value builds of the current kernel")
    ap.add_argument("--old-at-rule", action="store_true",
                    help="launch an old kernel that has cluster launches at "
                         "the rule's C too (else at C = 1)")
    ap.add_argument("--b9-src", action="append", default=[],
                    help="label=directory: another B9 build timed with the "
                         "old and the current one")
    ap.add_argument("--b9-only", action="store_true",
                    help="time B9 alone (no B10 lines)")
    ap.add_argument("--b9-turns", type=int, default=TURNS)
    ap.add_argument("--tag", default="probe_rkc", help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    grids = [] if args.b9_only else [
        (ENS_NY, ENS_NX, [int(x) for x in args.sizes.split(",")],
         ("5d", "5e"))]
    for item in filter(None, [] if args.b9_only else args.extra.split(";")):
        shape, ms = item.split(":")
        ny, nx = (int(x) for x in shape.split("x"))
        grids.append((ny, nx, [int(x) for x in ms.split(",")], ("5d",)))
    variants = []
    for item in filter(None, args.variants.split(",")):
        name, assign = item.split(":")
        const, value = assign.split("=")
        variants.append((name, const, value))
    old_src = args.old_src.resolve()
    jobs = {}
    for ny, nx, _, _ in grids:
        ens = parallel.brusselator_2d_grid((ny, nx), B=None)
        h = _build.fused_rkc_header(ens.shape, 1, ens.cuda_src)
        jobs[f"old_{ny}x{nx}"] = (old_src, h)
        jobs[f"new_{ny}x{nx}"] = (_build.CSRC, h)
        if has_cluster(_build.CSRC):
            for name, const, value in variants:
                jobs[f"{name}_{ny}x{nx}"] = (
                    variant_src(f"{name}_{ny}x{nx}", const, value), h)
    brus = parallel.brusselator_2d_grid((BRUS_N, BRUS_N))
    h_b9 = _build.fused_rkc_header(brus.shape, 0, brus.cuda_src)
    jobs["old_b9"] = (old_src, h_b9)
    jobs["new_b9"] = (_build.CSRC, h_b9)
    extra = dict(item.split("=", 1) for item in args.b9_src)
    for label, d in extra.items():
        jobs[f"{label}_b9"] = (Path(d).resolve(), h_b9)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build_rkc, *v, k) for k, v in jobs.items()}
        builds = {k: f.result() for k, f in futs.items()}
    print(f"builds {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {b['seconds']:.1f} s" for k, b in builds.items()))
    for k, b in builds.items():
        for ln in ptxas_lines(b["log"], entries=True):
            print(f"ptxas[{k}] {ln}")
        sass = sass_barriers(b["so"])
        if isinstance(sass, dict):
            for fn, ops in sass.items():
                print(f"sass[{k}] {fn}: {ops}")
        else:
            print(f"sass[{k}] {sass}")
        OUT[f"build_{k}"] = {"seconds": b["seconds"], "log": b["log"],
                             "sass": sass}
    # each old build against the current one from the same header: their
    # kernels' SASS opcodes, kernel by kernel
    for k in [k for k in builds if k.startswith("old_")]:
        new = "new_" + k[len("old_"):]
        same, totals = sass_same(builds[k], builds[new])
        print(f"SASS [{k[len('old_'):]}]: old and new opcodes kernel by "
              f"kernel {'identical' if same is True else same}; "
              f"instructions {totals}")
        if same is False:
            for fn, d in sass_apart(builds[k], builds[new]).items():
                print(f"  SASS apart [{k[len('old_'):]}] {fn}: {d}")
        OUT[f"sass_same_{k[len('old_'):]}"] = same

    vt = [(name, int(value) if const == "kClusterThreads"
           else FR.BLOCK_THREADS) for name, const, value in variants]
    for ny, nx, sizes, modes in grids:
        b10_sizes(builds, vt if has_cluster(_build.CSRC) else [], ny, nx,
                  sizes, modes, args.old_at_rule)
    b9(builds, list(extra), args.b9_turns)
    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
