"""Member sweep of the fused SWAG kernel (csrc/fused_adams.cu) against an
earlier build of it, on one card.

The SWAG bench line (Van der Pol mu = 1000, t in [0, 20], rtol 1e-6 /
atol 1e-9, compensated), for each configuration n:k_max of --configs (n
even, n / 2 uncoupled Van der Pol pairs per member, k_max 1 to 12), at
each member count of --sizes: the kernel of --old-src against the current
kernel at each lane count it builds (1, 8, 16, 32, where B G <= 131,072),
timed in turns (old, each G, each G in reverse, old) with CUDA events
around the launch alone.  --old-src is a directory holding an earlier
fused_adams.cu with the headers it includes; its launch signature is read
from the source: the thread-per-member kernel (``..., compensated,
threads, stream``, launched at 128 members per block) or a lane-group
kernel (``..., compensated, lanes, block_members, stream``, with or
without the work counters, launched at the wrapper's lane count).  Also
prints registers and spills of every instantiation, the SASS instruction
count of each kernel function where cuobjdump is found, and with
--witness the plain-f32 line at 256 members and a lockstep witness (256
members started from one y0, so that every warp of a thread-per-member
kernel takes one branch).  Writes chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_adams.py \
        --old-src <dir>/extensisq_tpu_torch/csrc --configs 2:12,8:12,2:4
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
                    timed, turns, write_out)
from extensisq_tpu_torch.ops import _build
from extensisq_tpu_torch.ops import fused_adams as FA

MU = 1000.0
SPAN = (0.0, 20.0)
RTOL, ATOL = 1e-6, 1e-9
MAX_STEPS = 400_000
NEW_LANES = (1, 8, 16, 32)
MAX_THREADS = 131_072
OUT = {}


def rhs_src(n):
    """CUDA source of n / 2 uncoupled Van der Pol pairs."""
    mu = f"{float(np.float32(MU))!r}f"
    body = "".join(
        f"  dy[{i}] = y[{i + 1}];\n"
        f"  dy[{i + 1}] = {mu} * (1.0f - y[{i}] * y[{i}]) * y[{i + 1}]"
        f" - y[{i}];\n" for i in range(0, n, 2))
    return ("__device__ void rhs(float t, const float* y, float* dy) {\n"
            + body + "}")


def vdp_rows(t, y):
    out = []
    for i in range(0, y.shape[0], 2):
        out += [y[i + 1], MU * (1 - y[i] ** 2) * y[i + 1] - y[i]]
    return torch.stack(out)


def old_convention(src_dir):
    """(lanes, work) of the launch signature of src_dir/fused_adams.cu."""
    args = launch_signature(src_dir, "fused_adams")
    return "int lanes" in args, "void* work" in args


def build_old(header, old_src, tag):
    """nvcc the earlier kernel of ``old_src`` with ``header``; returns
    (library, .so path, seconds, compiler output)."""
    b = build(old_src, "fused_adams", header, f"b3_old_{tag}")
    lanes, work = old_convention(old_src)
    lib = b["lib"]
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_adams_launch.argtypes = (
        [V] * (9 if work else 8) + [I, F, F, F, F, F, F, I, I]
        + ([I, I] if lanes else [I]) + [V])
    lib.fused_adams_launch.restype = I
    return lib, b["so"], b["seconds"], b["log"]


# SASS opcodes by kind, for the instruction mix of each kernel function
INT_OPS = {"IMAD", "ISETP", "LOP3", "SEL", "IADD3", "VIADD", "VIMNMX",
           "VIADDMNMX", "SHF", "LEA", "PLOP3", "P2R", "R2P", "I2FP", "F2I"}
FLOAT_OPS = {"FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "MUFU",
             "FCHK", "FRND"}


def sass_counts(so):
    """{function: {"total", "shfl", "int", "float", "branch"}} from
    cuobjdump -sass, or a note where cuobjdump is not found."""
    ops = sass_ops(so)
    if not isinstance(ops, dict):
        return ops
    counts = {}
    for name, c in ops.items():
        k = dict.fromkeys(("total", "shfl", "int", "float", "branch"), 0)
        for op, n in c.items():
            op = op.split(".")[0]
            k["total"] += n
            k["shfl"] += n * (op == "SHFL")
            k["int"] += n * (op in INT_OPS)
            k["float"] += n * (op in FLOAT_OPS)
            k["branch"] += n * (op in ("BRA", "BSSY", "BSYNC"))
        counts[name] = k
    return counts


class Probe:
    """The old and the current kernel of one configuration n:k_max."""

    def __init__(self, n, km, old, new, old_conv, sms):
        self.n, self.km, self.sms = n, km, sms
        self.old_lib, self.new = old, new
        self.old_lanes, self.old_work = old_conv
        self.stream = torch.cuda.current_stream().cuda_stream
        self.dev = torch.device("cuda")

    def inputs(self, B, same=False):
        x = np.full(B, 2.0) if same else np.linspace(1.9, 2.1, B)
        cols = []
        for i in range(self.n // 2):
            cols += [x + 0.01 * i, np.zeros(B)]
        y0 = torch.tensor(np.stack(cols, 1), dtype=torch.float32,
                          device=self.dev)
        _, s0, direction = FA._host_init(vdp_rows, SPAN, y0.T, RTOL, ATOL,
                                         None, self.km, None)
        return (y0, s0.yp.T.contiguous(), s0.h.contiguous(),
                s0.nfev.contiguous(), direction)

    def old_cfg(self, B):
        if self.old_lanes:
            g = FA._lanes_per_member(B, self.sms, self.km)
            return ("old", g, max(1, 128 // g))
        return ("old", 1, 128)

    def launch(self, cfg, inp, comp=True, tf=SPAN[1]):
        y0, yp0, h0, nf0, direction = inp
        B = y0.shape[0]
        y = torch.empty_like(y0)
        st = torch.empty(B, dtype=torch.int32, device=self.dev)
        ns, nf = torch.empty_like(st), torch.empty_like(st)
        work = torch.empty(B, FA._WORK, dtype=torch.int32, device=self.dev)
        kind, G, bm = cfg
        outs = [y.data_ptr(), st.data_ptr(), ns.data_ptr(), nf.data_ptr()]
        if kind == "new" or self.old_work:
            outs.append(work.data_ptr())
        args = [y0.data_ptr(), yp0.data_ptr(), h0.data_ptr(),
                nf0.data_ptr(), *outs, B, float(np.float32(SPAN[0])),
                float(np.float32(tf)), direction, float(np.float32(RTOL)),
                float(np.float32(ATOL)), np.inf, MAX_STEPS, int(comp)]
        if kind == "new":
            rc = self.new.lib.fused_adams_launch(*args, G, bm, self.stream)
        elif self.old_lanes:
            rc = self.old_lib.fused_adams_launch(*args, G, bm, self.stream)
        else:
            rc = self.old_lib.fused_adams_launch(*args, bm, self.stream)
        if rc:
            raise RuntimeError(f"{cfg}: launch failed {rc}")
        return y, st, ns, nf

    def timed(self, cfg, inp, comp=True):
        return timed(lambda: self.launch(cfg, inp, comp))

    def warm(self):
        """Every kernel function once on a short span."""
        inp = self.inputs(64)
        for comp in (True, False):
            for G in NEW_LANES:
                self.launch(("new", G, max(1, 128 // G)), inp, comp, tf=1e-3)
            for B in (256, 4096, 32768):
                self.launch(self.old_cfg(B), inp, comp, tf=1e-3)
        torch.cuda.synchronize()

    def sweep(self, sizes):
        tag = f"n{self.n}_km{self.km}"
        results = {}
        for B in sizes:
            inp = self.inputs(B)
            old = self.old_cfg(B)
            cfgs = [("new", G, max(1, 128 // G)) for G in NEW_LANES
                    if B * G <= MAX_THREADS]
            times, outs = turns(
                [(cfg, lambda cfg=cfg: self.launch(cfg, inp))
                 for cfg in [old] + cfgs], 1, warm=False)
            ref = outs[old]
            done = all(bool((o[1] == 1).all()) for o in outs.values())
            rule = FA._lanes_per_member(B, self.sms, self.km)
            print(f"{tag} B={B}: all finished {done}; the wrapper takes G = "
                  f"{rule}; old max nsteps {int(ref[2].max())}")
            for cfg in [old] + cfgs:
                o, t = outs[cfg], times[cfg]
                dy = (o[0] - ref[0]).abs().max().item()
                dn = int((o[2] != ref[2]).sum())
                # attempts: one evaluation each, one more when accepted
                att = int((o[3] - inp[3] - o[2]).max())
                med = statistics.median(t)
                print(f"  {tag} B={B} {cfg[0]} G={cfg[1]} bm={cfg[2]}: "
                      f"{' '.join(f'{x:.3f}' for x in t)} ms (median "
                      f"{med:.3f}); vs old max |dy| {dy:.3e}, members with "
                      f"other nsteps {dn}, ms/attempt of slowest "
                      f"{med / att:.5f}")
                results[f"{B}/{cfg[0]}/{cfg[1]}/{cfg[2]}"] = {
                    "ms": t, "dy_vs_old": dy, "nsteps_differ": dn,
                    "max_nsteps": int(o[2].max()), "max_attempts": att,
                    "finished": bool((o[1] == 1).all())}
        return results

    def witness(self):
        """The plain-f32 line at 256 members and the lockstep witness."""
        res = {}
        inp = self.inputs(256)
        cfgs = [self.old_cfg(256), ("new", 32, 4), ("new", 1, 128)]
        times = {}
        for cfg in cfgs + cfgs[::-1]:
            ms, _ = self.timed(cfg, inp, comp=False)
            times.setdefault(cfg, []).append(ms)
        for cfg in cfgs:
            print(f"plain f32 256 {cfg}: {times[cfg]} ms")
        res["plain256"] = {str(k): v for k, v in times.items()}
        same = self.inputs(256, same=True)
        times = {}
        for cfg in cfgs + cfgs[::-1]:
            ms, out = self.timed(cfg, same)
            times.setdefault(cfg, []).append(ms)
            steps = out[2]
        for cfg in cfgs:
            print(f"lockstep witness (256 identical members) {cfg}: "
                  f"{times[cfg]} ms, nsteps {int(steps.min())}-"
                  f"{int(steps.max())}")
        res["lockstep"] = {str(k): v for k, v in times.items()}
        return res


def print_builds(tag, old_log, new, old_so):
    for kind, log in (("old", old_log), ("new", new.log)):
        for ln in ptxas_lines(log, entries=True):
            print(f"ptxas[{tag} {kind}] {ln}")
    new_so = _build.BUILD_DIR / f"fused_adams_{new.key}" / "lib.so"
    sass = {}
    for kind, so in (("old", old_so), ("new", new_so)):
        c = sass_counts(so)
        sass[kind] = c
        if isinstance(c, dict):
            for k, v in c.items():
                m = re.search(r"kernelI(\w+?)EEv", k)
                print(f"sass[{tag} {kind}] {m.group(1) if m else k}: "
                      + ", ".join(f"{n} {x}" for n, x in v.items()))
        else:
            print(f"sass[{tag} {kind}] {c}")
    return {"ptxas_old": old_log, "ptxas_new": new.log, "sass": sass}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_adams.cu")
    ap.add_argument("--configs", default="2:12",
                    help="comma-separated n:k_max, n even from 2 to 8")
    ap.add_argument("--sizes", default="256,1024,4096,32768",
                    help="comma-separated member counts")
    ap.add_argument("--witness", action="store_true",
                    help="the plain-f32 line and the lockstep witness (at "
                         "the first configuration)")
    ap.add_argument("--tag", default="probe_b3", help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("SMs", sms, "torch", torch.__version__, torch.version.cuda)
    configs = [tuple(int(x) for x in c.split(":"))
               for c in args.configs.split(",")]
    for n, km in configs:
        if n % 2 or not 2 <= n <= 8 or not 1 <= km <= 12:
            raise SystemExit(f"bad configuration {n}:{km}")
    sizes = [int(x) for x in args.sizes.split(",")]
    old_src = args.old_src.resolve()
    conv = old_convention(old_src)
    print(f"old kernel: {'lane groups' if conv[0] else 'thread per member'}"
          f"{', work counters' if conv[1] else ''}")

    t0 = time.perf_counter()
    jobs = {}
    with ThreadPoolExecutor(2 * len(configs)) as pool:
        for n, km in configs:
            consts, src = FA._adams_consts(km, n), rhs_src(n)
            header = _build.fused_adams_header(consts, src)
            jobs[n, km] = (pool.submit(build_old, header, old_src,
                                       f"n{n}_km{km}"),
                           pool.submit(_build.load_fused_adams, consts, src))
        built = {c: (fo.result(), fn.result()) for c, (fo, fn) in
                 jobs.items()}
    print(f"builds {time.perf_counter() - t0:.1f} s")
    for (n, km), ((old_lib, old_so, old_s, old_log), new) in built.items():
        tag = f"n{n}_km{km}"
        print(f"build {tag}: old {old_s:.1f} s, new {new.seconds:.1f} s")
        OUT[tag] = {"build_s": {"old": old_s, "new": new.seconds},
                    **print_builds(tag, old_log, new, old_so)}

    for i, ((n, km), ((old_lib, _, _, _), new)) in enumerate(built.items()):
        tag = f"n{n}_km{km}"
        p = Probe(n, km, old_lib, new, conv, sms)
        p.warm()
        OUT[tag]["sweep"] = p.sweep(sizes)
        if args.witness and i == 0:
            OUT[tag].update(p.witness())

    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
