"""The harness the old-against-new kernel probes (tools/probe_*.py) share.

A probe builds an earlier source of a kernel (a directory unpacked with
``git archive``) and the current one from the same generated header, then
times each launch alone with CUDA events, in turns, so that the card's
clock and power state weigh on both alike.  This module holds the parts
that do not depend on the kernel: the card's name and power limit, the
build, the launch signature of a source, event timing, the turn order, the
compiler's register and spill lines, the SASS opcodes of a build and the
JSON output under chiprun_out/.
"""
import ctypes
import json
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

from extensisq_tpu_torch.ops import _build


def card():
    """The card's name and power limit as nvidia-smi gives them, printed."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return smi


def launch_signature(src_dir, kernel):
    """The parameter list of ``extern "C" int <kernel>_launch(...)`` in
    ``src_dir``/<kernel>.cu, to tell an earlier launch convention."""
    text = (Path(src_dir) / f"{kernel}.cu").read_text()
    sig = re.search(rf'extern "C" int {kernel}_launch\((.*?)\)', text, re.S)
    if sig is None:
        raise RuntimeError(f"{src_dir}: no {kernel}_launch")
    return sig.group(1)


def build(src_dir, kernel, header, tag, flags=()):
    """nvcc ``src_dir``/<kernel>.cu with ``header`` as its generated
    <kernel>_config.cuh and the extra nvcc ``flags`` (e.g. a define of an
    instrumented build), under the build directory's probe_<tag>; returns
    a dict with the loaded library (no argument types set), the .so path,
    the nvcc seconds and the compiler output."""
    d = _build.BUILD_DIR / f"probe_{tag}"
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    (d / f"{kernel}_config.cuh").write_text(header)
    so = d / "lib.so"
    src_dir = Path(src_dir)
    cmd = [str(_build._nvcc()), *_build.NVCC_FLAGS, *flags, "-I", str(d),
           "-I", str(src_dir), "-o", str(so), str(src_dir / f"{kernel}.cu")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{tag}: nvcc failed\n{p.stdout}{p.stderr}")
    return {"lib": ctypes.CDLL(str(so)), "so": so,
            "seconds": time.perf_counter() - t0, "log": p.stdout + p.stderr}


def timed(fn):
    """(device ms between CUDA events around ``fn()``, its result)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def turns(runs, n, warm=True):
    """Time each (label, fn) of ``runs`` in turns: the first, the rest, the
    rest in reverse, the first, ``n`` times (after one warm call of each
    where ``warm``); returns ({label: [ms]}, {label: last outputs})."""
    if warm:
        for _, fn in runs:
            fn()
        torch.cuda.synchronize()
    order = [runs[0]] + runs[1:] + runs[1:][::-1] + [runs[0]]
    times, outs = {}, {}
    for _ in range(n):
        for label, fn in order:
            ms, out = timed(fn)
            times.setdefault(label, []).append(ms)
            outs[label] = out
    return times, outs


def ptxas_lines(log, entries=False):
    """The compiler's register and spill lines (and, with ``entries``, the
    names of the functions they belong to)."""
    keys = ("registers", "spill") + (("entry function",) if entries else ())
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in keys)]


def sass_ops(so):
    """{kernel function: Counter of SASS opcodes with their modifiers}
    from cuobjdump, or a note where cuobjdump is not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "cuobjdump not found"
    p = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                       text=True)
    counts, name = {}, None
    for ln in p.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     ln)
        if name and m:
            counts[name][m.group(1)] += 1
    return counts


def write_out(tag, out):
    """Write ``out`` to chiprun_out/<tag>.json."""
    Path("chiprun_out").mkdir(exist_ok=True)
    Path(f"chiprun_out/{tag}.json").write_text(json.dumps(out, indent=1))
