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
* :func:`solve_fused_rkc` and :func:`solve_fused_rkc_ensemble` — SSV2stab
  (Runge-Kutta-Chebyshev) on one PDE grid across the whole card, or on an
  ensemble of grids with one thread block per member
  (``csrc/fused_rkc.cu``)
* :class:`FusedRHS` — a right-hand side as a rows-first torch function
  plus the CUDA source the kernel compiles in; :class:`FusedAcc` is the
  RKN kernel's acceleration, :class:`FusedGridRHS`, :class:`FusedGridAcc`
  and :class:`FusedRho` are the grid kernels' counterparts

The other fused families of ``extensisq_tpu.ops`` are queued in
ROADMAP.md (queue B).
"""
from .fused_adams import fused_adams_reference, solve_fused_adams
from .fused_erk import FusedRHS, fused_erk_reference, solve_fused_erk
from .fused_erk_grid import fused_erk_grid_reference, solve_fused_erk_grid
from .fused_esdirk import fused_esdirk_reference, solve_fused_esdirk
from .fused_rkc import (FusedGridRHS, FusedRho, fused_rkc_reference,
                        solve_fused_rkc, solve_fused_rkc_ensemble)
from .fused_rkn import FusedAcc, fused_rkn_reference, solve_fused_rkn
from .fused_rkn_grid import (FusedGridAcc, fused_rkn_grid_reference,
                             solve_fused_rkn_grid)

__all__ = ["FusedRHS", "fused_erk_reference", "solve_fused_erk",
           "fused_esdirk_reference", "solve_fused_esdirk",
           "fused_adams_reference", "solve_fused_adams",
           "FusedGridRHS", "FusedRho", "fused_rkc_reference",
           "solve_fused_rkc", "solve_fused_rkc_ensemble",
           "FusedAcc", "fused_rkn_reference", "solve_fused_rkn",
           "fused_erk_grid_reference", "solve_fused_erk_grid",
           "FusedGridAcc", "fused_rkn_grid_reference",
           "solve_fused_rkn_grid"]
