"""Old-against-new timing of the mid-size SWAG kernel (B8,
csrc/fused_adams_grid.cu) on one card.

Config 2d's line (validation/benchmarks.py:221-259): the 256-state periodic
heat MoL (D = 0.01), y0 = amps sin(2 pi x) + 0.3 cos(4 pi x) with amps =
linspace(0.5, 1.5), SWAG with k_max 6 on t in [0, 0.25] at rtol 1e-4 /
atol 1e-6, at each member count of --sizes (default 32, config 2d, and
1,024, chip_smoke.py's heat1024).  The float32 stepper's init runs once,
before any timing, and its outputs feed both kernels; each launch is timed
alone with CUDA events, in turns (old, new, new, old, three times).  The
kernel of --old-src (a directory holding an earlier fused_adams_grid.cu
with the headers it includes) and the current one are built from the same
generated header.  Prints each time, the outputs' bit identity against the
old kernel, ms per attempt of the slowest member, registers and spills of
both builds, and, for the current kernel, the event window around the
wrapper call (init and launch) that chip_smoke.py timed before.  Writes
chiprun_out/<--tag>.json.

    git archive <commit> extensisq_tpu_torch/csrc | tar -x -C <dir>
    PYTHONPATH=. python tools/probe_fused_adams_grid.py \
        --old-src <dir>/extensisq_tpu_torch/csrc
"""
import argparse
import ctypes
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from _probe import build, card, ptxas_lines, timed, turns, write_out
from extensisq_tpu_torch.ops import FusedGridRHS, _build
from extensisq_tpu_torch.ops import fused_adams as FA
from extensisq_tpu_torch.ops import fused_adams_grid as FAG
from extensisq_tpu_torch.ops.fused_erk_grid import grid_threads

N, DIFF, KM = 256, 0.01, 6
SPAN = (0.0, 0.25)
RTOL, ATOL = 1e-4, 1e-6
MAX_STEPS = 200_000
TURNS = 3
OUT = {}


def heat_mol(n, diff):
    c = diff * n * n

    def fun(t, y):
        return (torch.roll(y, 1, 0) + torch.roll(y, -1, 0) - 2.0 * y) * c
    return fun


def heat_rhs():
    c = float(np.float32(DIFF * N * N))
    src = ("__device__ float rhs(float t, const float* y, int i, "
           "const float* p) {\n  using G = tab::G;\n"
           "  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) - "
           f"2.0f * y[i]) * {c!r}f;\n}}")
    return FusedGridRHS(heat_mol(N, DIFF), src, (N,))


def heat_y0(members):
    x = np.linspace(0, 1, N, endpoint=False)
    amps = np.linspace(0.5, 1.5, members)
    return torch.tensor(amps[:, None] * np.sin(2 * np.pi * x)[None, :]
                        + 0.3 * np.cos(4 * np.pi * x)[None, :],
                        dtype=torch.float32, device="cuda")


def build_b8(src_dir, header, tag):
    """``src_dir``/fused_adams_grid.cu built with ``header``, its launch
    bound."""
    b = build(src_dir, "fused_adams_grid", header, f"b8_{tag}")
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    b["lib"].fused_adams_grid_launch.argtypes = (
        [V] * 8 + [I, F, F, F, F, F, F, I, I, V])
    b["lib"].fused_adams_grid_launch.restype = I
    return b


def start(fun, y0):
    """The float32 stepper's init, outside the kernel as in the wrapper."""
    return (y0, *FAG._start(fun, SPAN, y0, RTOL, ATOL, None, KM, None))


def launch(lib, inp):
    y0, yp0, h0, nfev0, direction = inp
    B = y0.shape[0]
    y = torch.empty_like(y0)
    st = torch.empty(B, dtype=torch.int32, device=y0.device)
    ns, nf = torch.empty_like(st), torch.empty_like(st)
    rc = lib.fused_adams_grid_launch(
        y0.data_ptr(), yp0.data_ptr(), h0.data_ptr(), nfev0.data_ptr(),
        y.data_ptr(), st.data_ptr(), ns.data_ptr(), nf.data_ptr(), B,
        float(np.float32(SPAN[0])), float(np.float32(SPAN[1])), direction,
        float(np.float32(RTOL)), float(np.float32(ATOL)), np.inf, MAX_STEPS,
        grid_threads(N), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return y, st, ns, nf


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True,
                    help="directory of the earlier fused_adams_grid.cu")
    ap.add_argument("--sizes", default="32,1024",
                    help="comma-separated member counts")
    ap.add_argument("--tag", default="probe_b8", help="output file name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    smi = card()
    OUT["card"] = smi
    fun = heat_rhs()
    header = _build.fused_adams_header(FA._adams_consts(KM, N), fun.cuda_src,
                                       fun.shape)
    with ThreadPoolExecutor(2) as pool:
        fo = pool.submit(build_b8, args.old_src.resolve(), header, "old")
        fn = pool.submit(build_b8, _build.CSRC, header, "new")
        builds = {"old": fo.result(), "new": fn.result()}
    print(f"builds: old {builds['old']['seconds']:.1f} s, new "
          f"{builds['new']['seconds']:.1f} s")
    OUT["ptxas"] = {}
    for kind, b in builds.items():
        OUT["ptxas"][kind] = ptxas_lines(b["log"])
        for ln in OUT["ptxas"][kind]:
            print(f"ptxas[{kind}] {ln}")

    libs = {kind: b["lib"] for kind, b in builds.items()}
    for B in (int(x) for x in args.sizes.split(",")):
        inp = start(fun, heat_y0(B))
        times, outs = turns([(kind, lambda kind=kind: launch(libs[kind], inp))
                             for kind in ("old", "new")], TURNS)
        same = all(torch.equal(a, b) for a, b in zip(outs["old"],
                                                       outs["new"]))
        o = outs["new"]
        done = bool((o[1] == 1).all())
        # one evaluation an attempt, one more when it is accepted
        att = int((o[3] - inp[3] - o[2]).max())
        res = {"bit_identical": same, "all_finished": done,
               "max_attempts": att, "max_nsteps": int(o[2].max()),
               "mean_nsteps": float(o[2].double().mean())}
        for kind in ("old", "new"):
            med = statistics.median(times[kind])
            res[kind] = {"ms": times[kind], "median_ms": med,
                         "us_per_attempt": med / att * 1e3}
            print(f"heat{N}x{B} B8 {kind}: "
                  f"{' '.join(f'{t:.4f}' for t in times[kind])} ms "
                  f"(median {med:.4f}), {med / att * 1e3:.3f} us per "
                  f"attempt of the slowest member ({att} attempts)")
        print(f"heat{N}x{B}: new bit-identical to old {same}, all finished "
              f"{done}, mean nsteps {res['mean_nsteps']:.2f}")
        # the wrapper's window: the float32 init and the launch
        y0 = inp[0]
        win = []
        for _ in range(5):
            ms, _ = timed(lambda: FAG.solve_fused_adams_grid(
                fun, SPAN, y0, rtol=RTOL, atol=ATOL, k_max=KM))
            win.append(ms)
        res["wrapper_window_ms"] = win
        print(f"heat{N}x{B} wrapper window (init + new launch): "
              f"{' '.join(f'{t:.4f}' for t in win)} ms")
        OUT[f"heat{N}x{B}"] = res

    write_out(args.tag, OUT)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
