"""PDE right-hand sides for SSV2stab (the JAX package's
``extensisq_tpu.parallel``, without its mesh and sharding helpers, which
come with ROADMAP A18)."""
from .pde import (brusselator_2d_grid, brusselator_2d_rhs,  # noqa: F401
                  brusselator_2d_rhs_interleaved, brusselator_rho_bound,
                  heat_1d_rhs, heat_2d_grid, heat_2d_rhs, heat_3d_rhs)

__all__ = ["heat_1d_rhs", "heat_2d_rhs", "heat_3d_rhs",
           "brusselator_2d_rhs", "brusselator_2d_rhs_interleaved",
           "brusselator_rho_bound", "brusselator_2d_grid", "heat_2d_grid"]
