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
"grid")``), with their times.  ``--grid`` runs the grid phase only;
``--adjoint`` runs ``chip_smoke.adjoint_path`` alone (B1 and B4 with the
dense record against their plain versions, configs 7d and 7b through
``solve_fused_adjoint``; three builds); ``--routes`` runs
``chip_smoke.adjoint_routes_path`` alone (B2, B7, B5 and B6 with the
dense record, B5 and B6 with params, against their plain versions; the
ESDIRK and RKN routes of ``solve_fused_adjoint``, flat and grid; with the
sensitivity builds their references launch, fifteen builds); ``--adams``
runs ``chip_smoke.adams_routes_path`` alone (B3 and B8 with params, with
and without the dense record, against their plain versions; the SWAG
routes of ``solve_fused_adjoint``, flat and grid; four builds);
``--teval`` runs ``chip_smoke.teval_path`` alone (the t_eval snapshots on
B1, B4, B11 and B12, with params on B11 and B12, each against its plain
version and bit for bit the launch without t_eval at every shape; eleven
builds), and then times B1's launch alone on the main path's vdp4096
line with 0 (the build without the snapshots), 11, 101 and 1,001 points
spread over the span, plain at one thread and at 8 lanes a member,
compensated at 4 and 8 lanes, in turns; with ``--snap-src <dir>`` (an
earlier ``extensisq_tpu_torch/csrc``; the option may repeat) it then
builds B1's snapshot kernel from there too and times the two builds in
turns at each of those shapes and point counts, their outputs and rows
compared bit for bit.  ``--teval-routes`` runs ``chip_smoke.esdirk_path``
(whose bench line's plain version and f64 driver take the pend4096 line's
points) and then ``chip_smoke.teval_routes_path`` (the t_eval snapshots on
B5, B6, B2 and B7, each against its plain version and bit for bit the
launch without t_eval at every shape; the implicit builds, the Kepler,
wave and reaction-diffusion builds and the six snapshot builds).

``--inline`` then also builds the two variational grid systems with their
augmented ``rhs`` inlined (``__forceinline__`` for the generated
``__noinline__``) and times each sensitivity launch alone with CUDA
events, the shipped out-of-line build against the inlined one in turns
(out, in, in, out, three rounds), at the wrapper's launch shape; prints
the medians, their ratio and how far the inlined outputs lie from the
shipped ones.  Run from the repository root:

    PYTHONPATH=. python tools/probe_sens.py [--grid | --adjoint | --routes
        | --adams | --teval [--snap-src <dir>] | --teval-routes] [--inline]
"""
import re
import statistics
import subprocess
import sys
from pathlib import Path

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


def teval_sweep(rounds=2):
    """B1's launch alone on vdp4096 by the number of t_eval points; see the
    module docstring."""
    import numpy as np
    from extensisq_tpu_torch import BS5
    from extensisq_tpu_torch.ops import fused_erk as FK
    R = C.teval_rhs()["vdp"]
    y0 = C.vdp_y0(C.N_MEMBERS, torch.float32)
    builds = {False: FK._kernel(BS5, R), True: FK._kernel(BS5, R, False,
                                                          True)}
    counts = (0, 11, 101, 1001)
    for label, tol, shapes in (("plain", C.PLAIN_TOL, [(1, 128), (8, 16)]),
                               ("compensated", C.COMP_TOL,
                                [(4, 32), (8, 16)])):
        for shape in shapes:
            ms = {nq: [] for nq in counts}
            for _ in range(rounds):
                for nq in counts + counts[::-1]:
                    tq = (None if nq == 0 else np.linspace(
                        *C.T_SPAN, nq).astype(np.float32))
                    ms[nq].append(C.launch_ms("fused_erk", builds[nq > 0],
                                              y0, None, C.T_SPAN, tol, shape,
                                              0, tq=tq)[0])
            med = {nq: statistics.median(v) for nq, v in ms.items()}
            print(f"t_eval sweep [vdp4096 {label}, {shape[0]} lanes, "
                  f"{shape[1]} members a block]: launch alone (ms, medians "
                  f"of {2 * rounds} in turns) by points: "
                  + ", ".join(f"{nq}: {v:.4f}" for nq, v in med.items())
                  + f"; per point past 0: "
                  + ", ".join(f"{nq}: {(med[nq] - med[0]) / nq * 1e3:.3f} us"
                              for nq in counts[1:]))


def snap_launch(built, y0, tol, shape, tq):
    """One launch of a B1 snapshot build on the vdp4096 line at ``shape``
    with the points ``tq``: (y, status, nsteps, nfev, y_eval)."""
    from extensisq_tpu_torch.ops.fused_erk import DenseRecord, SnapPoints
    out = (torch.empty_like(y0),
           *[torch.empty(y0.shape[0], dtype=torch.int32, device="cuda")
             for _ in range(3)])
    rec = DenseRecord(y0, 0)
    pts = SnapPoints(tq, C.T_SPAN, y0)
    args = (C._launch_args("fused_erk", y0, out, None, C.T_SPAN, tol, shape,
                           rec) + rec.args() + pts.args())
    rc = built.lib.fused_erk_snap_launch(
        *args, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    torch.cuda.synchronize()
    return out + (pts.y,)


def snap_ab(src, rounds=2):
    """B1's snapshot build from ``src`` against this checkout's on the
    vdp4096 line: bit for bit, and the launch alone in turns."""
    import numpy as np
    from extensisq_tpu_torch import BS5
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops import fused_erk as FK
    R = C.teval_rhs()["vdp"]
    y0 = C.vdp_y0(C.N_MEMBERS, torch.float32)
    new = FK._kernel(BS5, R, False, True)
    here = _build.CSRC
    _build.CSRC = Path(src).resolve()
    try:
        old = _build.load_fused_erk(FK._fused_consts(BS5), R.n, R.cuda_src,
                                    R.k, False, True)
    finally:
        _build.CSRC = here
    regs = {name: sorted({int(r) for r in re.findall(
        r"Used (\d+) registers", b.log)}) for name, b in (("old", old),
                                                         ("new", new))}
    print(f"snap A/B: builds {old.key} (old, {src}) and {new.key} (new)"
          f"; registers by entry {regs}")
    for label, tol, shapes in (("plain", C.PLAIN_TOL, [(1, 128), (8, 16)]),
                               ("compensated", C.COMP_TOL,
                                [(4, 32), (8, 16)])):
        for shape in shapes:
            for nq in (11, 101, 1001):
                tq = np.linspace(*C.T_SPAN, nq).astype(np.float32)
                a = snap_launch(old, y0, tol, shape, tq)
                b = snap_launch(new, y0, tol, shape, tq)
                same = all(torch.equal(u, v) for u, v in zip(a, b))
                ms = {"old": [], "new": []}
                for _ in range(rounds):
                    for tag in ("old", "new", "new", "old"):
                        ms[tag].append(C.launch_ms(
                            "fused_erk", old if tag == "old" else new, y0,
                            None, C.T_SPAN, tol, shape, 0, tq=tq)[0])
                mo, mn = (statistics.median(ms[k]) for k in ("old", "new"))
                print(f"snap A/B [vdp4096 {label}, {shape[0]} lanes, "
                      f"{nq} points]: launch alone old {mo:.4f} ms, new "
                      f"{mn:.4f} ms ({(mn / mo - 1) * 100:+.1f}%), medians "
                      f"of {2 * rounds} in turns; outputs and rows "
                      f"bit-identical {same}")
                if not same:
                    raise SystemExit("snap A/B: the builds differ")


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
    if "--teval-routes" in sys.argv[1:]:
        C.build_all(
            C.esdirk_builds()
            + [b for b in C.rkn_grid_builds(C.rkn_grid_rhs())
               if b[1] in ("kepler Fi5N", "wave Fi5N")]
            + [b for b in C.mid_builds(C.mid_rhs())
               if b[1] == "rdiff Kv3I"]
            + C.teval_routes_builds(C.teval_routes_rhs()))
        C.esdirk_path()
        for name, keys in C.teval_routes_path().items():
            print(f"{name}: {keys}")
        print(smi.splitlines()[0])
        return 0
    if "--teval" in sys.argv[1:]:
        C.build_all(
            C.teval_builds(C.teval_rhs())
            + [("fused_erk", "vdp", C.teval_rhs()["vdp"], None)]
            + [b for b in C.rkn_grid_builds(C.rkn_grid_rhs())
               if b[1] == "fisher BS5"]
            + [b for b in C.ckdisc_builds(C.ckdisc_rhs())
               if b[1] in ("swdec", "ckmol")])
        for name, keys in C.teval_path().items():
            print(f"{name}: {keys}")
        teval_sweep()
        argv = sys.argv[1:]
        for i, arg in enumerate(argv):
            if arg == "--snap-src":
                snap_ab(argv[i + 1])
        print(smi.splitlines()[0])
        return 0
    if "--adams" in sys.argv[1:]:
        C.build_all(C.adams_routes_builds(C.adams_routes_rhs()))
        for name, keys in C.adams_routes_path().items():
            print(f"{name}: {keys}")
        print(smi.splitlines()[0])
        return 0
    if "--routes" in sys.argv[1:]:
        C.build_all(C.sens_builds(C.sens_rhs())
                    + C.sens_grid_builds(C.sens_grid_rhs())
                    + C.adjoint_routes_builds(C.adjoint_routes_rhs()))
        for name, keys in C.adjoint_routes_path().items():
            print(f"{name}: {keys}")
        print(smi.splitlines()[0])
        return 0
    if "--adjoint" in sys.argv[1:]:
        C.build_all(C.sens_builds(C.sens_rhs())[:1]
                    + C.adjoint_builds(C.adjoint_rhs()))
        erk, grid = C.adjoint_path()
        print(f"fused_erk: {erk}")
        print(f"fused_erk_grid: {grid}")
        print(smi.splitlines()[0])
        return 0
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
