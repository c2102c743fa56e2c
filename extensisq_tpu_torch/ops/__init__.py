"""Fused kernels of the port: whole adaptive integrations in one CUDA
kernel launch, each with its plain PyTorch version beside it.

* :func:`solve_fused_erk` — explicit RK ensembles, plain float32 and the
  compensated mixed-precision mode (``csrc/fused_erk.cu``)
* :func:`solve_fused_esdirk` — implicit ESDIRK ensembles, stiff ODEs and
  index-1 DAEs with a diagonal or dense mass matrix, plain and
  compensated (``csrc/fused_esdirk.cu``)
* :func:`solve_fused_adams` — SWAG (variable-order Adams PECE)
  ensembles, plain and compensated (``csrc/fused_adams.cu``)
* :class:`FusedRHS` — a right-hand side as a rows-first torch function
  plus the CUDA source the kernel compiles in

The other fused families of ``extensisq_tpu.ops`` are queued in
ROADMAP.md (queue B).
"""
from .fused_adams import fused_adams_reference, solve_fused_adams
from .fused_erk import FusedRHS, fused_erk_reference, solve_fused_erk
from .fused_esdirk import fused_esdirk_reference, solve_fused_esdirk

__all__ = ["FusedRHS", "fused_erk_reference", "solve_fused_erk",
           "fused_esdirk_reference", "solve_fused_esdirk",
           "fused_adams_reference", "solve_fused_adams"]
