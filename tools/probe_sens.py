"""chip_smoke.py's sensitivity phase alone, on one card.

Builds the phase's four kernel variants (B1 with params, B1 on 7b's
variational system, B2 with params and B2's simultaneous corrector on 7a's
variational Robertson system; one nvcc each, all started together, their
registers and spills printed), then runs ``chip_smoke.sens_path``: each
variant against its plain version on the card, config 7a (512 Robertson
members through ``solve_fused_sens``, member 0 at the CVODES gates) and
config 7b (the gradient of a 1,024-member Van der Pol sweep through
``solve_fused_final``, against central differences), with their times.
Run from the repository root:

    PYTHONPATH=. python tools/probe_sens.py
"""
import subprocess
import sys

import torch

import chip_smoke as C


def main():
    if not torch.cuda.is_available():
        print("probe_sens: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    C.build_all(C.sens_builds(C.sens_rhs()))
    erk, esdirk = C.sens_path()
    print(f"fused_erk: {erk}")
    print(f"fused_esdirk: {esdirk}")
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
