"""The f64 driver's trajectory phase of chip_smoke.py alone, on one card.

Integrates the main path's line (4,096 Van der Pol members at mu = 3,
BS5 on t in [0, 10], rtol 1e-6 / atol 1e-9) through ``solve_ensemble`` for
the final state, times it, then runs ``chip_smoke.trajectory_path``:
201 ``t_eval`` points with ``save_steps``, a zero-crossing and a terminal
event, four ``solve_windowed`` windows, sampled members on the CPU, and
one 64-member ``t_eval`` run of each other family.  Every check of the
phase applies; the phase prints its times.  Run from the repository root:

    PYTHONPATH=. python tools/probe_trajectory.py

``--ab <dir>`` instead times the final-state line alone (warm median of
``chip_smoke.REPS``) for the package under ``<dir>`` (an earlier tree,
e.g. ``git archive <commit> extensisq_tpu_torch | tar -x -C <dir>``)
and for this tree, each in a fresh process, in turns (earlier, this, this,
earlier) ``--rounds`` times.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as C
from extensisq_tpu_torch import BS5, solve_ensemble

_TIME_FINAL = """
import chip_smoke as C, torch, extensisq_tpu_torch as P
from extensisq_tpu_torch import BS5, solve_ensemble
y = C.vdp_y0(C.N_MEMBERS, torch.float64)
print(P.__file__)
print(C.wall_ms(lambda: solve_ensemble(C.vdp, C.T_SPAN, y, method=BS5,
                                       rtol=1e-6, atol=1e-9)))
"""


def ab(parent, rounds):
    """Final-state wall ms of the package under ``parent`` and of this
    tree, in turns, one process each."""
    here = os.getcwd()
    times = {"earlier": [], "this": []}
    for _ in range(rounds):
        for label in ("earlier", "this", "this", "earlier"):
            first = parent if label == "earlier" else here
            out = subprocess.run([sys.executable, "-c", _TIME_FINAL],
                                 cwd=first, capture_output=True, text=True,
                                 env=dict(os.environ, PYTHONPATH=os.pathsep
                                          .join([first, here])), check=True)
            pkg, ms = out.stdout.split()[-2:]
            times[label].append(float(ms))
            print(f"final-state vdp{C.N_MEMBERS} f64 [{label}, {pkg}]: "
                  f"{float(ms):.1f} ms")
    for label, v in times.items():
        print(f"[{label}] median {statistics.median(v):.1f} ms, runs "
              f"{', '.join(f'{x:.1f}' for x in v)}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", help="directory holding an earlier "
                    "extensisq_tpu_torch")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_trajectory: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.ab:
        ab(os.path.abspath(args.ab), args.rounds)
        return 0
    y64 = C.vdp_y0(C.N_MEMBERS, torch.float64)

    def run():
        return solve_ensemble(C.vdp, C.T_SPAN, y64, method=BS5, rtol=1e-6,
                              atol=1e-9)
    ens = run()
    ms = C.wall_ms(run)
    print(f"final-state vdp{C.N_MEMBERS} f64: {ms:.1f} ms wall "
          f"({torch.cuda.get_device_name(0)})")
    t0 = time.perf_counter()
    C.trajectory_path(y64, ens, ms)
    print(f"phase {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
