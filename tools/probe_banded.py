"""The banded ESDIRK linear algebra on one card: block cyclic reduction
against the dense LU, and chip_smoke.py's banded and complex phase.

For each n of ``--sizes`` and member count of ``--members`` it builds
seeded, diagonally dominant banded matrices (``kl = ku = 4``, Medazko's
bands) in float64 and times, with CUDA events (median of 5 warm runs):

* ``core.banded.banded_factor`` and ``banded_solve`` (the port's cyclic
  reduction, plain torch);
* ``torch.linalg.lu_factor_ex`` and ``lu_solve`` on the dense matrices
  (the dense path's LU);

and counts the device kernels one factor and one solve launch
(``torch.profiler``; "not measured" where the profiler sees none).  The
solves are checked against each other.  Then, unless ``--no-phase``, it
runs ``chip_smoke.banded_complex_path`` (config 8, the banded ensemble,
RCM, complex states) with every gate.  Run from the repository root:

    PYTHONPATH=. python tools/probe_banded.py --sizes 512,1024,2048,4096

Results go to ``chiprun_out/probe_banded.json``.
"""
import argparse
import json
import os
import statistics
import subprocess

import numpy as np
import torch

import chip_smoke as C
from extensisq_tpu_torch.core import banded as bd

KL = KU = 4


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels(fn):
    """Device kernels one call of ``fn`` launches, or None."""
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if getattr(e, "device_type", None) is not None
                and "CUDA" in str(e.device_type))
        return n or None
    except Exception:                    # noqa: BLE001 - report, go on
        return None


def system(n, members, seed):
    rng = np.random.default_rng(seed)
    i, j = np.indices((n, n))
    mask = (i - j <= KL) & (j - i <= KU)
    A = rng.standard_normal((members, n, n)) * mask + np.eye(n) * 12.0
    return (torch.tensor(A, device="cuda"),
            torch.tensor(rng.standard_normal((members, n)), device="cuda"))


def compare(sizes, members_list):
    rows = []
    for members in members_list:
        for n in sizes:
            A, b = system(n, members, n + members)
            AB = bd.banded_from_dense(A, KL, KU)
            fact = bd.banded_factor(AB, KL, KU, n)
            LU, piv, _ = torch.linalg.lu_factor_ex(A)
            xb = bd.banded_solve(fact, b, n, KL, KU)
            xd = torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]
            diff = (xb - xd).abs().max().item()
            row = dict(
                n=n, members=members, max_abs_diff=diff,
                bcr_factor_ms=event_ms(
                    lambda: bd.banded_factor(AB, KL, KU, n)),
                bcr_solve_ms=event_ms(
                    lambda: bd.banded_solve(fact, b, n, KL, KU)),
                lu_factor_ms=event_ms(lambda: torch.linalg.lu_factor_ex(A)),
                lu_solve_ms=event_ms(
                    lambda: torch.linalg.lu_solve(LU, piv, b[..., None])),
                bcr_factor_kernels=kernels(
                    lambda: bd.banded_factor(AB, KL, KU, n)),
                bcr_solve_kernels=kernels(
                    lambda: bd.banded_solve(fact, b, n, KL, KU)),
                lu_factor_kernels=kernels(
                    lambda: torch.linalg.lu_factor_ex(A)),
                lu_solve_kernels=kernels(
                    lambda: torch.linalg.lu_solve(LU, piv, b[..., None])))
            print(json.dumps(row))
            C.check(diff < 1e-9, f"BCR and LU solves differ at n={n}")
            rows.append(row)
            del A, AB, fact, LU
            torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048,4096")
    ap.add_argument("--members", default="1,16")
    ap.add_argument("--no-phase", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    rows = compare([int(x) for x in args.sizes.split(",")],
                   [int(x) for x in args.members.split(",")])
    if not args.no_phase:
        C.banded_complex_path(smi)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/probe_banded.json", "w") as f:
        json.dump({"card": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
