"""chip_smoke.py's sensitivity phases alone, on one card.

Builds the phases' eight kernel variants (B1 with params, B1 on 7b's
variational system, B2 with params and B2's simultaneous corrector on 7a's
variational Robertson system; B4 with params and on the Fisher MoL's
variational system, B7 with params and its simultaneous corrector on the
reaction-diffusion's; one nvcc each, all started together, their
registers and spills printed), then runs ``chip_smoke.sens_path`` (each
flat variant against its plain version on the card, config 7a through
``solve_fused_sens`` at the CVODES gates and config 7b's gradient through
``solve_fused_final`` against central differences) and
``chip_smoke.sens_grid_path`` (each grid variant against its plain
version, the 64-member Fisher sweep at n = 256 and the 32-member
reaction-diffusion sweep at n = 128 through ``solve_fused_sens(layout=
"grid")``), with their times.  ``--grid`` runs the grid phase only.

``--inline`` then also builds the two variational grid systems with their
augmented ``rhs`` inlined (``__forceinline__`` for the generated
``__noinline__``) and times each sensitivity launch alone with CUDA
events, the shipped out-of-line build against the inlined one in turns
(out, in, in, out, three rounds), at the wrapper's launch shape; prints
the medians, their ratio and how far the inlined outputs lie from the
shipped ones.  Run from the repository root:

    PYTHONPATH=. python tools/probe_sens.py [--grid] [--inline]
"""
import statistics
import subprocess
import sys

import torch

import chip_smoke as C


def inline_ab(R, rounds=3):
    """The two sensitivity launches with the augmented rhs out of line
    (shipped) and inlined, timed in turns; see the module docstring."""
    from extensisq_tpu_torch import BS5, TRBDF2
    from extensisq_tpu_torch import ops
    inl = {name: ops.FusedGridRHS(
        R[name].torch_fn,
        R[name].cuda_src.replace("__noinline__", "__forceinline__"),
        R[name].shape, R[name].k) for name in ("fisher_aug", "rd_aug")}
    C.build_all([("fused_erk_grid", "fisher variational inlined",
                  inl["fisher_aug"], BS5),
                 ("fused_esdirk_grid", "rd variational TRBDF2 block_base "
                  f"{C.SG_RD_N} inlined", inl["rd_aug"],
                  (TRBDF2, C.SG_RD_N))])
    fy0, r, fY, ry0, kd, rY = C.sens_grid_inputs()
    lines = [("Fisher, B4 on 512 rows", ops.solve_fused_erk_grid, "fisher_aug",
              C.SG_FIS_SPAN, fY, dict(method=BS5, params=r, **C.SG_FIS_TOL)),
             ("reaction-diffusion, B7 block_base on 384 rows",
              ops.solve_fused_esdirk_grid, "rd_aug", C.SG_RD_SPAN, rY,
              dict(method=TRBDF2, params=kd, block_base=C.SG_RD_N,
                   **C.SG_RD_TOL))]
    for label, run, name, span, y0, kw in lines:
        funs = {"out of line": R[name], "inlined": inl[name]}
        outs = {v: run(f, span, y0, **kw) for v, f in funs.items()}
        shape = run.last_shape
        times = {v: [] for v in funs}
        for _ in range(rounds):
            for v in ("out of line", "inlined", "inlined", "out of line"):
                times[v].append(C.event_ms(
                    lambda: run(funs[v], span, y0, **kw)))
        med = {v: statistics.median(t) for v, t in times.items()}
        a, b = outs["out of line"], outs["inlined"]
        print(f"inline A/B [{label}] shape {shape}: out of line "
              f"{med['out of line']:.4f} ms, inlined {med['inlined']:.4f} ms "
              f"device (median of {2 * rounds} turns of {C.REPS} launches "
              f"each; all out of line "
              f"{[round(t, 4) for t in times['out of line']]}, inlined "
              f"{[round(t, 4) for t in times['inlined']]}), out of line / "
              f"inlined {med['out of line'] / med['inlined']:.3f}; inlined "
              f"vs shipped: max |dy| {(a[0] - b[0]).abs().max().item():.3e}, "
              f"status equal {torch.equal(a[1], b[1])}, mean nsteps "
              f"{a[2].double().mean():.3f} vs {b[2].double().mean():.3f}, "
              f"mean nfev {a[3].double().mean():.3f} vs "
              f"{b[3].double().mean():.3f}")


def main():
    if not torch.cuda.is_available():
        print("probe_sens: no CUDA device", file=sys.stderr)
        return 1
    grid_only = "--grid" in sys.argv[1:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    C.build_all(([] if grid_only else C.sens_builds(C.sens_rhs()))
                + C.sens_grid_builds(C.sens_grid_rhs()))
    if not grid_only:
        erk, esdirk = C.sens_path()
        print(f"fused_erk: {erk}")
        print(f"fused_esdirk: {esdirk}")
    erk_grid, esdirk_grid = C.sens_grid_path()
    print(f"fused_erk_grid: {erk_grid}")
    print(f"fused_esdirk_grid: {esdirk_grid}")
    if "--inline" in sys.argv[1:]:
        inline_ab(C.sens_grid_rhs())
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
