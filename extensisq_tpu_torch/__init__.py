"""extensisq_tpu_torch: the PyTorch/CUDA port of extensisq_tpu.

The port carries the explicit Runge-Kutta, the implicit ESDIRK and the
SWAG (variable-order Adams) ensemble paths:

* :func:`solve` / :func:`solve_ensemble` — the batched on-device solver
  (final state, counters and status per member), in the dtype of ``y0``;
  ESDIRK methods take ``jac=``, a mass matrix ``M=`` (index-1 DAEs) and
  ``jac_each_step=``; SWAG takes ``k_max=``;
* :func:`ops.solve_fused_erk`, :func:`ops.solve_fused_esdirk` and
  :func:`ops.solve_fused_adams` — the whole adaptive integration in one
  CUDA kernel launch (float32, optionally compensated);
* the explicit RK and ESDIRK methods as tableau data, SWAG, and
  :func:`tableau_from_arrays` for custom explicit tableaux.

Right-hand sides are row-stacked: ``fun(t, y)`` takes ``y`` of shape
``(n, B)`` with members on the last axis and ``t`` of shape ``(B,)``.
Public arrays keep the JAX package's ``(B, n)`` layout.  The package
imports torch and numpy, never jax.
"""
from . import ops  # noqa: F401
from .methods import (  # noqa: F401
    BS5, Ts5, CK5, CKdisc, Me4, Pr7, Pr8, Pr9, CFMR7osc,
    TRBDF2, TRX2, HS2I, HS2Ia, KC3I, KC4I, KC4Ia, Kv3I, SWAG,
    EXPLICIT_METHODS, ESDIRK_METHODS, METHODS_BY_NAME)
from .ops import (FusedRHS, solve_fused_adams, solve_fused_erk,  # noqa: F401
                  solve_fused_esdirk)
from .solve import solve, solve_ensemble, Solution  # noqa: F401
from .types import (ERKTableau, ESDIRKTableau, Method,  # noqa: F401
                    tableau_from_arrays)

__version__ = "0.1.0"

__all__ = [
    "solve", "solve_ensemble", "Solution", "ops", "FusedRHS",
    "solve_fused_erk", "solve_fused_esdirk", "solve_fused_adams",
    "ERKTableau", "ESDIRKTableau",
    "Method", "tableau_from_arrays",
    "BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9", "CFMR7osc",
    "TRBDF2", "TRX2", "HS2I", "HS2Ia", "KC3I", "KC4I", "KC4Ia", "Kv3I",
    "SWAG", "EXPLICIT_METHODS", "ESDIRK_METHODS", "METHODS_BY_NAME",
]
