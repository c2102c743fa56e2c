"""extensisq_tpu_torch: the PyTorch/CUDA port of extensisq_tpu.

The port carries the explicit Runge-Kutta, the Runge-Kutta-Nystrom
(second-order systems), the CKdisc (variable-order, non-smooth), the
implicit ESDIRK, the SWAG (variable-order Adams) ensemble paths and
SSV2stab (Runge-Kutta-Chebyshev) for semi-discretized PDEs:

* :func:`solve_ivp` — the scipy-semantics host driver (``t_eval``,
  events located by Brent's method on the host, dense output, the host
  stiffness check, an :class:`OdeResult` whose dense output is an
  :class:`OdeSolution`), and the stepwise protocol ``BS5(fun, t0, y0,
  t_bound).step()`` (a :class:`Stepper`); :func:`sens_forward`,
  :func:`sens_adjoint_end` and :func:`sens_adjoint_int` — sensitivities on
  top of it; :func:`solve_final` — ``y(t_f)`` of a device solve under
  ``torch.autograd`` (the continuous adjoint);
* :func:`solve` / :func:`solve_ensemble` — the batched on-device solver
  (final state, counters and status per member, and on request the
  trajectory: ``save_steps``, ``t_eval``, events, the stiffness
  diagnosis), in the dtype of ``y0``; :func:`solve_windowed` — the same
  over warm-started windows, bit for bit;
  ESDIRK methods take ``jac=``, a mass matrix ``M=`` (index-1 DAEs),
  ``jac_each_step=``, ``jac_sparsity=`` and ``bands=`` (banded Newton
  linear algebra by cyclic reduction); SWAG takes ``k_max=``; SSV2stab
  ``rho_jac=`` and ``const_jac=``; ``y0`` may be complex (not for
  SSV2stab);
* :func:`ops.solve_fused` — the fused kernels' front door, by method
  family;
  :func:`ops.solve_fused_erk`, :func:`ops.solve_fused_esdirk` and
  :func:`ops.solve_fused_adams` — the whole adaptive integration in one
  CUDA kernel launch (float32, optionally compensated);
  :func:`ops.solve_fused_rkn` — the same for Nystrom pairs on
  second-order systems (accelerations as :class:`ops.FusedAcc`);
  :func:`ops.solve_fused_ckdisc` — CKdisc's cascade for non-smooth
  problems; :func:`ops.solve_fused_erk_grid`,
  :func:`ops.solve_fused_rkn_grid`, :func:`ops.solve_fused_ckdisc_grid`,
  :func:`ops.solve_fused_adams_grid` and :func:`ops.solve_fused_esdirk_grid`
  — mid-size systems of any n, one thread block per member;
  :func:`ops.solve_fused_rkc` and :func:`ops.solve_fused_rkc_ensemble` —
  the same for SSV2stab on PDE grids (right-hand sides as
  :class:`ops.FusedGridRHS`, e.g. from :mod:`parallel`);
* the explicit RK (CKdisc among them), RKN and ESDIRK methods as tableau
  data, SWAG, and
  :func:`tableau_from_arrays` for custom explicit tableaux;
* :mod:`problems`: the JAX package's problem library with rows-first
  right-hand sides.

Right-hand sides of the device driver and the kernels are row-stacked:
``fun(t, y)`` takes ``y`` of shape ``(n, B)`` with members on the last
axis and ``t`` of shape ``(B,)``; those of the host driver take a 1-D
``y`` ``(n,)`` and a 0-d ``t`` (:mod:`extensisq_tpu_torch.ivp`).
Public arrays keep the JAX package's ``(B, n)`` layout.  An entry point
runs on the device of a tensor input (a CPU tensor asks for the CPU) and
on the card for a numpy array or a list.  The package imports torch and
numpy, never jax.
"""
from . import ops, parallel, problems  # noqa: F401
from .methods import (  # noqa: F401
    BS5, Ts5, CK5, CKdisc, Me4, Pr7, Pr8, Pr9, CFMR7osc,
    Fi4N, Fi5N, Mu5Nmb, MR6NN,
    TRBDF2, TRX2, HS2I, HS2Ia, KC3I, KC4I, KC4Ia, Kv3I, SWAG, SSV2stab,
    EXPLICIT_METHODS, RKN_METHODS, ESDIRK_METHODS, ALL_METHODS,
    METHODS_BY_NAME)
from .ops import (FusedAcc, FusedGridAcc, FusedGridRHS,  # noqa: F401
                  FusedRHS, FusedRho, solve_fused_adams,
                  solve_fused_adams_grid, solve_fused_ckdisc,
                  solve_fused_ckdisc_grid, solve_fused_erk,
                  solve_fused_erk_grid, solve_fused_esdirk,
                  solve_fused_esdirk_grid, solve_fused_rkc,
                  solve_fused_rkc_ensemble, solve_fused_rkn,
                  solve_fused_rkn_grid)
from .ivp import OdeResult, Stepper, solve_ivp  # noqa: F401
from .core.interpolate import OdeSolution  # noqa: F401
from .sensitivity import (sens_adjoint_end,  # noqa: F401
                          sens_adjoint_int, sens_forward, solve_final)
from .solve import (solve, solve_ensemble, solve_windowed,  # noqa: F401
                    Solution)
from .types import (ERKTableau, ESDIRKTableau, Method,  # noqa: F401
                    RKNTableau, tableau_from_arrays)

__version__ = "0.1.0"

__all__ = [
    "solve_ivp", "Stepper", "OdeResult", "OdeSolution", "sens_forward",
    "sens_adjoint_end", "sens_adjoint_int", "solve_final",
    "solve", "solve_ensemble", "solve_windowed", "Solution", "ops",
    "parallel", "problems", "FusedRHS",
    "FusedGridRHS", "FusedRho", "FusedAcc", "FusedGridAcc",
    "solve_fused_erk", "solve_fused_esdirk", "solve_fused_adams",
    "solve_fused_rkc", "solve_fused_rkc_ensemble", "solve_fused_rkn",
    "solve_fused_erk_grid", "solve_fused_rkn_grid", "solve_fused_ckdisc",
    "solve_fused_ckdisc_grid", "solve_fused_adams_grid",
    "solve_fused_esdirk_grid", "ERKTableau", "ESDIRKTableau", "RKNTableau",
    "Method", "tableau_from_arrays",
    "BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9", "CFMR7osc",
    "Fi4N", "Fi5N", "Mu5Nmb", "MR6NN", "RKN_METHODS",
    "TRBDF2", "TRX2", "HS2I", "HS2Ia", "KC3I", "KC4I", "KC4Ia", "Kv3I",
    "SWAG", "SSV2stab", "EXPLICIT_METHODS", "ESDIRK_METHODS", "ALL_METHODS",
    "METHODS_BY_NAME",
]
