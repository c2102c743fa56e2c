"""Dense-output representation and evaluation, batched over members.

Counterpart of ``extensisq_tpu/core/interpolate.py``.  Every interpolant
(the tableau ``P`` polynomials, the cubic and quintic Hermite fallbacks,
the Nystrom split polynomials, SWAG's dintp polynomial, the HS methods'
piecewise cubic) is one segment form::

    y(u) = y_anchor + sum_k Q[:, k] * u**(k+1),   u = (t - t_anchor) / h

Inside the solve loop ``Q`` is rows-first, ``(n, p, B)``, beside the
``(n, B)`` state; the trajectory record stores it members first,
``(B, steps, n, p)``, and :func:`horner` takes the degree axis as an
argument so that one function evaluates both.
"""
from typing import Any, NamedTuple

import numpy as np
import torch


def horner(u, Q, y_anchor, axis=1):
    """``y_anchor + sum_k Q_k u^(k+1)``, with the degree on ``axis`` of
    ``Q``; ``u`` broadcasts against ``y_anchor``."""
    p = Q.shape[axis]
    acc = Q.select(axis, p - 1)
    for k in range(p - 2, -1, -1):
        acc = acc * u + Q.select(axis, k)
    return y_anchor + u * acc


def hermite_cubic_coefficients(h, y_old, y, f_old, f):
    """C1 cubic Hermite as ``(n, 3, B)`` coefficients.

    With m0 = h f_old, m1 = h f:
      y(u) = y_old + m0 u + (3 dy - 2 m0 - m1) u^2 + (m0 + m1 - 2 dy) u^3
    """
    m0 = h * f_old
    m1 = h * f
    dy = y - y_old
    return torch.stack([m0, 3.0 * dy - 2.0 * m0 - m1, m0 + m1 - 2.0 * dy],
                       dim=1)


def linear_coefficients(y_old, y):
    """Linear segment (SWAG's extrapolated final step)."""
    return (y - y_old)[:, None]


# quintic Hermite basis of the position over (x0, v0 h, a0 h^2, x1, v1 h,
# a1 h^2), coefficients of u^0 .. u^5
_QUINTIC = np.array([[1, 0, 0, -10, 15, -6],
                     [0, 1, 0, -6, 8, -3],
                     [0, 0, 1 / 2, -3 / 2, 3 / 2, -1 / 2],
                     [0, 0, 0, 10, -15, 6],
                     [0, 0, 0, -4, 7, -3],
                     [0, 0, 0, 1 / 2, -1, 1 / 2]])


def _combine(basis, P):
    """``sum_b basis[b] P[b, :]`` -> ``(m, p, B)`` for ``basis`` rows of
    ``(m, B)`` and the host matrix ``P`` ``(len(basis), p)``."""
    cols = []
    for j in range(P.shape[1]):
        acc = None
        for b, x in enumerate(basis):
            w = float(P[b, j])
            if w == 0.0:
                continue
            term = w * x
            acc = term if acc is None else acc + term
        cols.append(torch.zeros_like(basis[0]) if acc is None else acc)
    return torch.stack(cols, dim=1)


def quintic_hermite_coefficients(h, y_old, y, f_old, f):
    """C2 quintic Hermite for a second-order state ``[u, v]`` (rows
    ``2m``); ``f_old``/``f`` are the accelerations ``(m, B)``.  Returns
    ``(2m, 5, B)`` in the anchor form."""
    m = y_old.shape[0] // 2
    x0, v0 = y_old[:m], y_old[m:]
    x1, v1 = y[:m], y[m:]
    coef_x = _combine([x0, v0 * h, f_old * h * h, x1, v1 * h, f * h * h],
                      _QUINTIC)
    # velocity = derivative / h
    Pp = _QUINTIC[:, 1:] * np.arange(1, 6)
    coef_v = _combine([x0 / h, v0, f_old * h, x1 / h, v1, f * h], Pp)
    Qx = coef_x[:, 1:]                       # coef_x[:, 0] == x0
    Qv = torch.cat([coef_v[:, 1:], torch.zeros_like(coef_v[:, :1])], dim=1)
    return torch.cat([Qx, Qv], dim=0)


def nystrom_coefficients(h, y_old, Q, Qp):
    """Anchor-form coefficients from the Nystrom interpolation matrices:
    ``Q = K^T P`` ``(m, p, B)``, ``Qp = K^T Pp``.

    u(x) = u0 + x h v0 + x^2 h^2 (Q poly),  v(x) = v0 + x h (Qp poly).
    """
    m = y_old.shape[0] // 2
    v0 = y_old[m:]
    Qx = torch.cat([(h * v0)[:, None], Q * (h * h)], dim=1)
    Qv = Qp * h
    p = max(Qx.shape[1], Qv.shape[1])
    pad = (lambda A: torch.cat([A, A.new_zeros(
        (A.shape[0], p - A.shape[1]) + tuple(A.shape[2:]))], dim=1))
    return torch.cat([pad(Qx), pad(Qv)], dim=0)


def host_matrix(cache, P, like):
    """The host matrix ``P`` (a tableau's array) as a tensor of ``like``'s
    dtype and device, made once and kept in ``cache``, a dict of the
    caller's (a stepper's)."""
    key = (id(P), like.dtype, like.device)
    hit = cache.get(key)
    if hit is None or hit[0] is not P:
        hit = cache[key] = (P, torch.tensor(np.array(P, dtype=float),
                                            dtype=like.dtype,
                                            device=like.device))
    return hit[1]


def stage_coefficients(K, P, h, cache):
    """``(K^T P) h`` for stage rows ``K`` ``(s, n, B)`` and the host matrix
    ``P`` ``(s, p)``: ``(n, p, B)``."""
    return torch.einsum("snb,sp->npb", K, host_matrix(cache, P, K)) * h


class OdeSolution(NamedTuple):
    """Evaluable dense output over one member's trajectory.

    Segment i covers [ts[i], ts[i+1]] (reversed for a backward solve);
    ``Q`` rows are zero-padded to a common degree.  ``sol(t)`` gives
    ``(n,)`` for a scalar ``t`` and ``(n, m)`` for ``m`` times.
    """
    ts: Any          # (N+1,) strictly monotone
    t_anchor: Any    # (N,)
    h: Any           # (N,) signed
    y_anchor: Any    # (N, n)
    Q: Any           # (N, n, p)

    @property
    def t_min(self):
        return torch.minimum(self.ts[0], self.ts[-1])

    @property
    def t_max(self):
        return torch.maximum(self.ts[0], self.ts[-1])

    def __call__(self, t):
        ts = self.ts
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        scalar = t.ndim == 0
        tq = t.reshape(-1)
        sgn = 1.0 if bool(ts[-1] >= ts[0]) else -1.0
        idx = torch.searchsorted((sgn * ts[1:-1]).contiguous(), sgn * tq,
                                 side="left")
        idx = idx.clamp(0, self.h.shape[0] - 1)
        u = ((tq - self.t_anchor[idx]) / self.h[idx])[:, None]
        y = horner(u, self.Q[idx], self.y_anchor[idx], axis=-1)
        return y[0] if scalar else y.T


def stack_segments(segments):
    """An :class:`OdeSolution` from a host-side list of (t_old, t_new,
    t_anchor, h, y_anchor, Q) tuples of one member (``Q`` ``(n, p)``),
    zero-padding ``Q`` to the largest degree."""
    ts = [segments[0][0]] + [s[1] for s in segments]
    p = max(int(s[5].shape[1]) for s in segments)
    Qs = []
    for s in segments:
        Q = np.asarray(s[5])
        if Q.shape[1] < p:
            Q = np.pad(Q, ((0, 0), (0, p - Q.shape[1])))
        Qs.append(Q)

    def t64(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))
    return OdeSolution(
        ts=t64([float(x) for x in ts]),
        t_anchor=t64([float(s[2]) for s in segments]),
        h=t64([float(s[3]) for s in segments]),
        y_anchor=torch.as_tensor(np.stack([np.asarray(s[4])
                                           for s in segments])),
        Q=torch.as_tensor(np.stack(Qs)))
