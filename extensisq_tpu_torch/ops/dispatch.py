"""One front door for the fused kernels: route by METHOD FAMILY, the way
a reference user thinks (``method=BS5``), not by kernel name.

Counterpart of ``extensisq_tpu/ops/dispatch.py``.
``solve_fused(fun, t_span, y0_batch, method=..., **kw)`` picks:

| family  | flat layout (register kernels) | grid layout (block kernels)   |
|---------|--------------------------------|-------------------------------|
| erk     | solve_fused_erk (B1)           | solve_fused_erk_grid (B4)     |
| ckdisc  | solve_fused_ckdisc (B11)       | solve_fused_ckdisc_grid (B12) |
| rkn     | solve_fused_rkn (B5)           | solve_fused_rkn_grid (B6)     |
| esdirk  | solve_fused_esdirk (B2, n<=8)  | solve_fused_esdirk_grid (B7)  |
| adams   | solve_fused_adams (B3, n<=8)   | solve_fused_adams_grid (B8)   |
| rkc     | solve_fused_rkc (B9, one grid) / solve_fused_rkc_ensemble (B10)|

The two layouts take two kinds of right-hand side, so the layout is read
from the RHS object: a :class:`FusedRHS` or :class:`FusedAcc` (one
member's CUDA function) goes to the flat kernels, a :class:`FusedGridRHS`
or :class:`FusedGridAcc` (one element of a member's grid) to the grid
kernels, and a ``layout=`` that contradicts the object raises
``TypeError``.  Only a bare callable, which the wrappers take for CPU
tensors alone (their plain versions), falls back to the JAX package's size
rule: the grid side when the (per-partition) state length is a multiple
of 128, at least 48, or above a flat kernel's cap.  The grid kernels take
any n up to a block's shared memory and raise beyond it; the error
surfaces here.

RKC routes by input shape: a single grid-shaped (>= 2-D) ``y0`` runs
:func:`solve_fused_rkc`, an ``(n_members, *grid_shape)`` stack
:func:`solve_fused_rkc_ensemble` (``ensemble=True`` forces the member
reading of a 3-D input that could be a single 3-D grid).
"""
import numpy as np

from .fused_adams import solve_fused_adams
from .fused_adams_grid import solve_fused_adams_grid
from .fused_ckdisc import solve_fused_ckdisc
from .fused_ckdisc_grid import solve_fused_ckdisc_grid
from .fused_erk import FusedRHS, solve_fused_erk
from .fused_erk_grid import solve_fused_erk_grid
from .fused_esdirk import solve_fused_esdirk
from .fused_esdirk_grid import solve_fused_esdirk_grid
from .fused_rkc import (FusedGridRHS, solve_fused_rkc,
                        solve_fused_rkc_ensemble)
from .fused_rkn import FusedAcc, solve_fused_rkn
from .fused_rkn_grid import FusedGridAcc, solve_fused_rkn_grid

_SMALL_CAP = {"esdirk": 8, "adams": 8}
_GRID_MIN = 48     # smallest state the grid layout takes by the size rule

# family -> (flat wrapper, grid wrapper, whether it takes ``method``)
_ROUTES = {
    "erk": (solve_fused_erk, solve_fused_erk_grid, True),
    "ckdisc": (solve_fused_ckdisc, solve_fused_ckdisc_grid, False),
    "rkn": (solve_fused_rkn, solve_fused_rkn_grid, True),
    "esdirk": (solve_fused_esdirk, solve_fused_esdirk_grid, True),
    "adams": (solve_fused_adams, solve_fused_adams_grid, False),
}


def _layout_of(fun):
    """The layout an RHS object is written for, or None for a callable."""
    if isinstance(fun, (FusedRHS, FusedAcc)):
        return "flat"
    if isinstance(fun, (FusedGridRHS, FusedGridAcc)):
        return "grid"
    return None


def solve_fused(fun, t_span, y0_batch, method=None, layout=None,
                ensemble=None, **kw):
    """Route a fused whole-integration solve to the family's kernel.

    ``method``: a Method handle (BS5, CKdisc, SWAG, SSV2stab, Fi5N, Kv3I,
    ...), whose ``family`` picks the kernel; None = BS5 (erk).
    ``layout``: "flat" or "grid"; it must agree with the RHS object's type
    where ``fun`` is one (else ``TypeError``), and picks the side for a
    bare callable (default: the size rule).  Every other keyword (rtol,
    atol, first_step, max_steps, compensated, k_max, M, rho, ...) passes
    through to the kernel's wrapper unchanged; see each wrapper for its
    RHS convention and options.
    """
    if method is None:
        family = "erk"
    else:
        family = getattr(method, "family", None)
        if family is None:
            raise ValueError(
                f"method {method!r} has no 'family' attribute — "
                "custom methods must declare one (erk/ckdisc/rkn/"
                "esdirk/adams/rkc) to route to a fused kernel; "
                "running an unknown method through the ERK kernel "
                "would silently produce wrong results")

    if family == "rkc":
        is_ens = ensemble if ensemble is not None else \
            np.ndim(y0_batch) >= 4
        if is_ens:
            return solve_fused_rkc_ensemble(fun, t_span, y0_batch, **kw)
        return solve_fused_rkc(fun, t_span, y0_batch, **kw)
    if family not in _ROUTES:
        raise ValueError(f"no fused kernel for method family {family!r}")

    own = _layout_of(fun)
    if own is not None:
        if layout is not None and layout != own:
            raise TypeError(
                f"layout={layout!r} contradicts the right-hand side: a "
                f"{type(fun).__name__} is written for the {own} kernels")
        layout = own
    elif layout is None:
        n = int(np.shape(y0_batch)[-1])
        n_part = n // 2 if family == "rkn" else n
        cap = _SMALL_CAP.get(family)
        wants_grid = (n_part % 128 == 0 and n_part >= 128) \
            or n_part >= _GRID_MIN
        if cap is not None and n_part > cap:
            layout = "grid"
        else:
            layout = "grid" if wants_grid else "flat"
    elif layout not in ("flat", "grid"):
        raise ValueError(f"layout must be 'flat' or 'grid', got {layout!r}")

    flat, grid, takes_method = _ROUTES[family]
    f = grid if layout == "grid" else flat
    if takes_method:
        kw["method"] = method
    return f(fun, t_span, y0_batch, **kw)
