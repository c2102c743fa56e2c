"""extensisq_tpu_torch: the PyTorch/CUDA port of extensisq_tpu.

The port carries the explicit Runge-Kutta, the Runge-Kutta-Nystrom
(second-order systems), the implicit ESDIRK, the SWAG (variable-order
Adams) ensemble paths and SSV2stab (Runge-Kutta-Chebyshev) for
semi-discretized PDEs:

* :func:`solve` / :func:`solve_ensemble` — the batched on-device solver
  (final state, counters and status per member), in the dtype of ``y0``;
  ESDIRK methods take ``jac=``, a mass matrix ``M=`` (index-1 DAEs) and
  ``jac_each_step=``; SWAG takes ``k_max=``; SSV2stab ``rho_jac=`` and
  ``const_jac=``;
* :func:`ops.solve_fused_erk`, :func:`ops.solve_fused_esdirk` and
  :func:`ops.solve_fused_adams` — the whole adaptive integration in one
  CUDA kernel launch (float32, optionally compensated);
  :func:`ops.solve_fused_rkn` — the same for Nystrom pairs on
  second-order systems (accelerations as :class:`ops.FusedAcc`);
  :func:`ops.solve_fused_erk_grid` and :func:`ops.solve_fused_rkn_grid`
  — mid-size systems of any n, one thread block per member;
  :func:`ops.solve_fused_rkc` and :func:`ops.solve_fused_rkc_ensemble` —
  the same for SSV2stab on PDE grids (right-hand sides as
  :class:`ops.FusedGridRHS`, e.g. from :mod:`parallel`);
* the explicit RK, RKN and ESDIRK methods as tableau data, SWAG, and
  :func:`tableau_from_arrays` for custom explicit tableaux.

Right-hand sides are row-stacked: ``fun(t, y)`` takes ``y`` of shape
``(n, B)`` with members on the last axis and ``t`` of shape ``(B,)``.
Public arrays keep the JAX package's ``(B, n)`` layout.  An entry point
runs on the device of a tensor input (a CPU tensor asks for the CPU) and
on the card for a numpy array or a list.  The package imports torch and
numpy, never jax.
"""
from . import ops, parallel  # noqa: F401
from .methods import (  # noqa: F401
    BS5, Ts5, CK5, CKdisc, Me4, Pr7, Pr8, Pr9, CFMR7osc,
    Fi4N, Fi5N, Mu5Nmb, MR6NN,
    TRBDF2, TRX2, HS2I, HS2Ia, KC3I, KC4I, KC4Ia, Kv3I, SWAG, SSV2stab,
    EXPLICIT_METHODS, RKN_METHODS, ESDIRK_METHODS, METHODS_BY_NAME)
from .ops import (FusedAcc, FusedGridAcc, FusedGridRHS,  # noqa: F401
                  FusedRHS, FusedRho, solve_fused_adams, solve_fused_erk,
                  solve_fused_erk_grid, solve_fused_esdirk, solve_fused_rkc,
                  solve_fused_rkc_ensemble, solve_fused_rkn,
                  solve_fused_rkn_grid)
from .solve import solve, solve_ensemble, Solution  # noqa: F401
from .types import (ERKTableau, ESDIRKTableau, Method,  # noqa: F401
                    RKNTableau, tableau_from_arrays)

__version__ = "0.1.0"

__all__ = [
    "solve", "solve_ensemble", "Solution", "ops", "parallel", "FusedRHS",
    "FusedGridRHS", "FusedRho", "FusedAcc", "FusedGridAcc",
    "solve_fused_erk", "solve_fused_esdirk", "solve_fused_adams",
    "solve_fused_rkc", "solve_fused_rkc_ensemble", "solve_fused_rkn",
    "solve_fused_erk_grid", "solve_fused_rkn_grid",
    "ERKTableau", "ESDIRKTableau", "RKNTableau",
    "Method", "tableau_from_arrays",
    "BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9", "CFMR7osc",
    "Fi4N", "Fi5N", "Mu5Nmb", "MR6NN", "RKN_METHODS",
    "TRBDF2", "TRX2", "HS2I", "HS2Ia", "KC3I", "KC4I", "KC4Ia", "Kv3I",
    "SWAG", "SSV2stab", "EXPLICIT_METHODS", "ESDIRK_METHODS",
    "METHODS_BY_NAME",
]
