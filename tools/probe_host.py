"""chip_smoke.py's host-driver phase alone, on one card.

Builds the twelve kernel variants the front door calls (one nvcc each, all
started together), then runs ``chip_smoke.host_path``: ``solve_ivp`` on
the card against the same call on CPU tensors (VdP/BS5 with ``t_eval``,
dense output and events, CKdisc, Pleiades/CFMR7osc, Kepler/Fi5N, the
pendulum DAE/Kv3I, Medazko N = 200 with ``bands=True``, VdP/SWAG, the 2 x
64 x 64 Brusselator/SSV2stab), the stepwise protocol by hand, the
sensitivity functions on Robertson and ``solve_final``, and
``ops.solve_fused`` over every kernel.  Every check of the phase applies;
it prints its times.  Run from the repository root:

    PYTHONPATH=. python tools/probe_host.py
"""
import subprocess
import sys

import torch

import chip_smoke as C


def main():
    if not torch.cuda.is_available():
        print("probe_host: no CUDA device", file=sys.stderr)
        return 1
    from extensisq_tpu_torch.ops import FusedRHS
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    vdp_rhs = FusedRHS(C.vdp, C.VDP_CUDA, 2)

    def pick(jobs, labels):
        return [j for j in jobs if j[1] in labels]
    C.build_all(
        [("fused_erk", "vdp", vdp_rhs, None)]
        + pick(C.esdirk_builds(), ("pendulum Kv3I diag M",))
        + pick(C.adams_builds(C.adams_rhs()), ("vdp k_max=6",))
        + pick(C.rkc_builds(C.rkc_rhs()),
               ("brusselator 2x256x256",
                "brusselator 2x64x128, B per member"))
        + pick(C.rkn_grid_builds(C.rkn_grid_rhs()),
               ("kepler Fi5N", "fisher BS5", "wave Fi5N"))
        + pick(C.ckdisc_builds(C.ckdisc_rhs()), ("swdec", "ckmol"))
        + pick(C.mid_builds(C.mid_rhs()), ("heat k_max=6", "rdiff Kv3I")))
    launches = C.host_path(smi, vdp_rhs)
    print(f"front door launches: {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
