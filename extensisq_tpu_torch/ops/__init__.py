"""Fused kernels of the port: whole adaptive integrations in one CUDA
kernel launch, each with its plain PyTorch version beside it.

* :func:`solve_fused_erk` — explicit RK ensembles, plain float32 and the
  compensated mixed-precision mode (``csrc/fused_erk.cu``)
* :func:`solve_fused_esdirk` — implicit ESDIRK ensembles, stiff ODEs and
  index-1 DAEs with a diagonal or dense mass matrix, plain and
  compensated (``csrc/fused_esdirk.cu``)
* :func:`solve_fused_adams` — SWAG (variable-order Adams PECE)
  ensembles, plain and compensated (``csrc/fused_adams.cu``)
* :func:`solve_fused_rkn` — Runge-Kutta-Nystrom ensembles of second-order
  systems, plain and compensated (``csrc/fused_rkn.cu``)
* :func:`solve_fused_erk_grid` and :func:`solve_fused_rkn_grid` — the ERK
  and RKN loops for mid-size systems of any n, one thread block per member
  (``csrc/fused_rk_grid.cu``)
* :func:`solve_fused_ckdisc` and :func:`solve_fused_ckdisc_grid` — the
  CKdisc variable-order cascade for non-smooth ensembles, one thread per
  member (``csrc/fused_ckdisc.cu``) or, for mid-size systems, one thread
  block per member (``csrc/fused_rk_grid.cu``)
* :func:`solve_fused_adams_grid` — SWAG for mid-size systems, one thread
  block per member with its divided differences in shared memory
  (``csrc/fused_adams_grid.cu``)
* :func:`solve_fused_esdirk_grid` — ESDIRK for mid-size stiff systems and
  index-1 DAEs with tridiagonal (optionally periodic) Jacobians: striped
  dual-number bands and cyclic reduction, one thread block per member
  (``csrc/fused_esdirk_grid.cu``)
* :func:`solve_fused_rkc` and :func:`solve_fused_rkc_ensemble` — SSV2stab
  (Runge-Kutta-Chebyshev) on one PDE grid across the whole card, or on an
  ensemble of grids with one thread block per member
  (``csrc/fused_rkc.cu``)
* :func:`solve_fused_sens` and :func:`solve_fused_final` — forward
  sensitivities of a parameter-sweep ensemble in one launch of B1, or of
  B2 with its simultaneous corrector (with ``layout="grid"``, of B4, or
  of B7 with its simultaneous corrector), and ``y(t_f)`` differentiable
  through ``torch.autograd`` by one more such launch
  (``ops/fused_sens.py``)
* :func:`solve_fused` — the front door: routes by method family to the
  flat or the grid kernel, reading the layout from the RHS object
  (``ops/dispatch.py``)
* :class:`FusedRHS` — a right-hand side as a rows-first torch function
  plus the CUDA source the kernel compiles in; :class:`FusedAcc` is the
  RKN kernel's acceleration, :class:`FusedGridRHS`, :class:`FusedGridAcc`
  and :class:`FusedRho` are the grid kernels' counterparts

Every whole-integration kernel of ``extensisq_tpu.ops`` has its
counterpart here; their options not ported yet are queued in ROADMAP.md
(queue B).
"""
from .dispatch import solve_fused
from .fused_adams import fused_adams_reference, solve_fused_adams
from .fused_adams_grid import (fused_adams_grid_reference,
                               solve_fused_adams_grid)
from .fused_ckdisc import fused_ckdisc_reference, solve_fused_ckdisc
from .fused_ckdisc_grid import (fused_ckdisc_grid_reference,
                                solve_fused_ckdisc_grid)
from .fused_erk import FusedRHS, fused_erk_reference, solve_fused_erk
from .fused_erk_grid import fused_erk_grid_reference, solve_fused_erk_grid
from .fused_esdirk import fused_esdirk_reference, solve_fused_esdirk
from .fused_esdirk_grid import (fused_esdirk_grid_reference,
                                solve_fused_esdirk_grid)
from .fused_rkc import (FusedGridRHS, FusedRho, fused_rkc_reference,
                        solve_fused_rkc, solve_fused_rkc_ensemble)
from .fused_rkn import FusedAcc, fused_rkn_reference, solve_fused_rkn
from .fused_rkn_grid import (FusedGridAcc, fused_rkn_grid_reference,
                             solve_fused_rkn_grid)
from .fused_sens import (solve_fused_adjoint, solve_fused_final,
                         solve_fused_sens)

__all__ = ["solve_fused", "FusedRHS", "fused_erk_reference",
           "solve_fused_erk",
           "fused_esdirk_reference", "solve_fused_esdirk",
           "fused_esdirk_grid_reference", "solve_fused_esdirk_grid",
           "fused_adams_reference", "solve_fused_adams",
           "fused_adams_grid_reference", "solve_fused_adams_grid",
           "FusedGridRHS", "FusedRho", "fused_rkc_reference",
           "solve_fused_rkc", "solve_fused_rkc_ensemble",
           "FusedAcc", "fused_rkn_reference", "solve_fused_rkn",
           "fused_erk_grid_reference", "solve_fused_erk_grid",
           "FusedGridAcc", "fused_rkn_grid_reference",
           "solve_fused_rkn_grid", "fused_ckdisc_reference",
           "solve_fused_ckdisc", "fused_ckdisc_grid_reference",
           "solve_fused_ckdisc_grid", "solve_fused_sens",
           "solve_fused_final", "solve_fused_adjoint"]
