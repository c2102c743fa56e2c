"""Shared numerics: RMS norm, error scale, tolerance validation.

Counterpart of ``extensisq_tpu/core/numerics.py``.  State is rows-first,
``(n, B)`` with members on the last axis, so the norm is an RMS over the
state axis taken per member.
"""
from math import sqrt

import numpy as np
import torch


def norm(x):
    """RMS norm over the state axis (axis 0), one value per member:
    ``(n, B) -> (B,)`` and ``(n,) -> ()``, as in extensisq ``common.py``.
    Complex-safe: ``sqrt(sum(real(x conj(x))) / n)``."""
    if x.is_complex():
        return torch.sqrt((x * x.conj()).real.sum(0) / x.shape[0])
    return torch.sqrt((x * x).sum(0) / x.shape[0])


def real_dtype(dtype):
    """The real dtype of a state dtype (float64 for complex128): the
    dtype of times, step sizes and norms."""
    return dtype.to_real() if dtype.is_complex else dtype


def over(c, x):
    """``c / x`` for a number ``c``, rounded as one division (PyTorch
    computes ``c / x`` as ``c * (1 / x)``, rounded twice)."""
    return x.new_tensor(c) / x


def calculate_scale(atol, rtol, y, y_new, _mean=False):
    """Error-scale array ``atol + rtol * max(|y|, |y_new|)`` (real, also
    for complex states).

    The ``_mean`` variant (average of magnitudes) is what the Adams
    solver uses.
    """
    if _mean:
        return atol + rtol * 0.5 * (torch.abs(y) + torch.abs(y_new))
    return atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))


def validate_tol(rtol, atol, y):
    """Host-side tolerance validation with RKSuite-style silent clipping:
    ``atol >= sqrt(tiny)`` and ``10*epsneg <= rtol <= 0.1``.

    ``y`` is one member's state (or anything of its dtype and size n).
    Returns numpy values.
    """
    y = np.asarray(y)
    atol = np.asarray(atol, dtype=float)
    if atol.ndim > 0 and atol.shape != (y.size,):
        raise ValueError("`atol` has wrong shape.")
    if np.any(atol < 0):
        raise ValueError("`atol` must be positive.")
    rtol = float(rtol)
    if rtol < 0:
        raise ValueError("`rtol` must be positive.")

    finfo = np.finfo(y.dtype)
    atol = np.maximum(atol, sqrt(finfo.tiny))
    rtol = min(max(rtol, 10.0 * finfo.epsneg), 0.1)
    return rtol, atol


def dtype_constants(dtype):
    """Machine constants used by the steppers, resolved at build time.

    ``dtype`` may be a numpy or a torch dtype.
    """
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    finfo = np.finfo(np.dtype(dtype))
    return {
        "tiny": float(finfo.tiny),
        "epsneg": float(finfo.epsneg),
        "eps": float(finfo.eps),
        "big": sqrt(float(finfo.max)),
        "sqrt_tiny": sqrt(float(finfo.tiny)),
        # smallest u with (1 + u) > 1, as used by SLATEC translations
        "uround": float(np.nextafter(finfo.epsneg, 1.0)),
    }
