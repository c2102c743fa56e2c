"""Branchless step-size controllers for explicit and implicit methods.

Counterpart of ``extensisq_tpu/core/controller.py``.  Implements the
4-coefficient controller law of extensisq (``bogacki.py``)::

    h_new = h * g**(kb1+kb2) * (err/tol)**-b1 * (err_o/tol_o)**-b2
              * (h/h_old)**-a2

with its named presets, explicit and implicit.  The if/else ladders of
extensisq's ``_step_impl`` and ``_assess_error_and_stepsize`` become
``torch.where`` selection, one value per member.
"""
from typing import NamedTuple

import torch

from .._config import MIN_FACTOR, MAX_FACTOR

_EXPLICIT_PRESETS = {
    "G": (0.7, -0.4, 0.0, 0.9),        # Gustafsson
    "S": (0.6, -0.2, 0.0, 0.9),        # Soderlind
    "standard": (1.0, 0.0, 0.0, 0.9),
}
_IMPLICIT_PRESETS = {
    "G": (2.0, -1.0, -1.0, 0.8),
    "S": (1.1, -0.7, -1.0, 0.8),
    "standard": (1.0, 0.0, 0.0, 0.8),
}


class ControllerCoeffs(NamedTuple):
    """Static controller coefficients, resolved at build time."""
    minbeta1: float
    minbeta2: float
    minalpha: float
    safety: float
    safety_sc: float
    error_exponent: float
    min_factor: float


def resolve_controller(sc_params, default, error_exponent, implicit=False,
                       min_factor=MIN_FACTOR):
    """Controller coefficients from a preset name (explicit or, with
    ``implicit=True``, implicit presets) or a 4-tuple ``(kb1, kb2, a,
    g)``."""
    presets = _IMPLICIT_PRESETS if implicit else _EXPLICIT_PRESETS
    sc = sc_params or default
    if isinstance(sc, str):
        if sc not in presets:
            raise ValueError(
                'sc_params should be a tuple of length 4 or one of the '
                'strings "G", "S" or "standard"')
        kb1, kb2, a, g = presets[sc]
    elif isinstance(sc, tuple) and len(sc) == 4:
        kb1, kb2, a, g = sc
    else:
        raise ValueError(
            'sc_params should be a tuple of length 4 or one of the '
            'strings "G", "S" or "standard"')
    return ControllerCoeffs(
        minbeta1=kb1 * error_exponent,
        minbeta2=kb2 * error_exponent,
        minalpha=-a,
        safety=g,
        safety_sc=g ** (kb1 + kb2),
        error_exponent=error_exponent,
        min_factor=min_factor,
    )


def _second_order_factor(cc, error_norm, error_norm_old, h_ratio):
    err = torch.clamp(error_norm, min=1e-300)
    err_old = torch.clamp(error_norm_old, min=1e-300)
    hr = torch.where(h_ratio == 0.0, 1.0, h_ratio)
    return cc.safety_sc * (err ** cc.minbeta1 * err_old ** cc.minbeta2
                           * hr ** cc.minalpha)


def reject_factor(cc, error_norm):
    """Shrink factor after a rejected step."""
    err = torch.clamp(error_norm, min=1e-300)
    return torch.clamp(cc.safety * err ** cc.error_exponent,
                       min=cc.min_factor)


def erk_accept_update(cc, tiny_err, error_norm, error_norm_old, h_ratio,
                      step_rejected, standard_sc, max_factor):
    """Factor and controller-state update on an accepted explicit step,
    as extensisq ``common.py`` does it.

    All tensor arguments are per member.  Returns (factor,
    standard_sc_new, max_factor_new).
    """
    err = torch.clamp(error_norm, min=1e-300)
    factor_std = cc.safety * err ** cc.error_exponent
    factor_2nd = torch.minimum(
        torch.clamp(_second_order_factor(cc, error_norm, error_norm_old,
                                         h_ratio), min=cc.min_factor),
        max_factor)

    is_tiny = error_norm < tiny_err
    factor = torch.where(is_tiny, max_factor,
                         torch.where(standard_sc, factor_std, factor_2nd))
    # the first-order controller stays on only after a tiny error
    standard_sc_new = is_tiny
    factor = torch.where(step_rejected, torch.clamp(factor, max=1.0),
                         factor)
    # reduce the initial max_factor (10) to 4 once the step is on scale
    max_factor_new = torch.where(factor < MAX_FACTOR,
                                 torch.full_like(max_factor, MAX_FACTOR),
                                 max_factor)
    return factor, standard_sc_new, max_factor_new


def esdirk_accept_update(cc, tiny_err, error_norm, error_norm_old, h_ratio,
                         step_rejected, standard_sc, max_factor):
    """Factor and controller-state update on an accepted implicit step,
    as extensisq ``common.py`` does it for ESDIRK methods.

    Unlike :func:`erk_accept_update`, the standard factor is capped by
    ``max_factor``, ``standard_sc`` clears only once the step is on scale,
    and a step accepted after a rejection goes back to the standard
    controller.  Returns (factor, standard_sc_new, max_factor_new).
    """
    err = torch.clamp(error_norm, min=1e-300)
    factor_std = torch.minimum(cc.safety * err ** cc.error_exponent,
                               max_factor)
    factor_2nd = torch.minimum(
        torch.clamp(_second_order_factor(cc, error_norm, error_norm_old,
                                         h_ratio), min=cc.min_factor),
        max_factor)

    is_tiny = error_norm < tiny_err
    factor = torch.where(is_tiny, max_factor,
                         torch.where(standard_sc, factor_std, factor_2nd))
    on_scale = max_factor == MAX_FACTOR
    standard_sc_new = is_tiny | (standard_sc & ~on_scale)
    factor = torch.where(step_rejected, torch.clamp(factor, max=1.0),
                         factor)
    standard_sc_new = standard_sc_new | step_rejected
    max_factor_new = torch.where(factor < MAX_FACTOR,
                                 torch.full_like(max_factor, MAX_FACTOR),
                                 max_factor)
    return factor, standard_sc_new, max_factor_new
