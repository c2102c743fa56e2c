"""Scalar root refinement on the host, for the host driver's events.

Counterpart of ``extensisq_tpu/core/rootfind.py``: Brent's method with the
convergence setup scipy's event handling uses (``xtol = rtol = 4 eps``),
over a Python callable of a float.  The host driver evaluates the step's
interpolant in numpy, so the iterates are those of the JAX package.
"""
import numpy as np

_EPS = float(np.finfo(float).eps)


def brentq(f, a, b, xtol=4 * _EPS, rtol=4 * _EPS, maxiter=100):
    """A root of ``f`` in ``[a, b]``, where ``f(a)`` and ``f(b)`` differ in
    sign (or one of them is 0)."""
    fa, fb = f(a), f(b)
    if fa == 0.0:
        return a
    if fb == 0.0:
        return b
    if np.sign(fa) == np.sign(fb):
        raise ValueError("f(a) and f(b) must have different signs")

    c, fc = a, fa
    d = e = b - a
    for _ in range(maxiter):
        if np.sign(fb) == np.sign(fc):
            c, fc = a, fa
            d = e = b - a
        if abs(fc) < abs(fb):
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb
        tol = 2.0 * rtol * abs(b) + 0.5 * xtol
        m = 0.5 * (c - b)
        if abs(m) <= tol or fb == 0.0:
            return b
        if abs(e) < tol or abs(fa) <= abs(fb):
            d = e = m                      # bisection
        else:
            s = fb / fa
            if a == c:                     # secant
                p = 2.0 * m * s
                q = 1.0 - s
            else:                          # inverse quadratic
                q = fa / fc
                r = fb / fc
                p = s * (2.0 * m * q * (q - r) - (b - a) * (r - 1.0))
                q = (q - 1.0) * (r - 1.0) * (s - 1.0)
            if p > 0:
                q = -q
            else:
                p = -p
            if 2.0 * p < min(3.0 * m * q - abs(tol * q), abs(e * q)):
                e = d
                d = p / q
            else:
                d = e = m
        a, fa = b, fb
        b = b + (d if abs(d) > tol else np.copysign(tol, m))
        fb = f(b)
    return b
