"""The port's problem library: one definition per benchmark and
conformance problem.

Counterpart of ``extensisq_tpu/problems/__init__.py``.  Each factory
returns an :class:`IVProblem` whose ``rhs`` follows the port's contract,
``rhs(t, y)`` with ``t`` ``(B,)`` and ``y`` ``(n, B)`` returning ``(n,
B)``, on the device and in the dtype of ``y``.  An analytic ``jac``
returns the rows-first ``(n, n, B)`` Jacobian the ESDIRK stepper takes
(``dfdp`` likewise ``(n, p, B)``), ``rho_jac`` the spectral-radius bound
SSV2stab takes.  ``y0``, ``t_span``, ``jac_sparsity``, ``M``,
``params`` and the exact ``solution`` stay numpy, as in the JAX module.
"""
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.numerics import over


class IVProblem(NamedTuple):
    name: str
    rhs: Callable                      # rhs(t, y) -> dy, rows-first
    t_span: Any
    y0: Any
    jac: Optional[Callable] = None     # analytic Jacobian (n, n, B)
    M: Any = None                      # mass matrix (DAE)
    rho_jac: Optional[Callable] = None  # spectral-radius bound (RKC)
    jac_sparsity: Any = None
    solution: Optional[Callable] = None  # exact solution sol(t)
    params: Any = None                 # parameter vector, if parametric
    dfdp: Optional[Callable] = None    # df/dp for sensitivity problems
    extra: Any = None                  # problem-specific bits


def _consts(cache, arrays, like):
    """The host arrays as tensors of ``like``'s dtype and device, made
    once per (dtype, device) and kept in the dict ``cache``."""
    key = (like.dtype, like.device)
    if key not in cache:
        cache[key] = [torch.as_tensor(a, dtype=like.dtype,
                                      device=like.device) for a in arrays]
    return cache[key]


def _matrix(rows):
    """Rows-first ``(n, n, B)`` from nested lists of ``(B,)`` tensors or
    numbers (numbers broadcast over the members)."""
    like = next(x for row in rows for x in row if torch.is_tensor(x))
    return torch.stack([torch.stack([x if torch.is_tensor(x)
                                     else torch.full_like(like, x)
                                     for x in row]) for row in rows])


def rational():
    """scipy's rational conformance problem: exact solution known, used
    forward and backward."""
    def rhs(t, y):
        return torch.stack([y[1] / t,
                            y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])

    def sol(t):
        t = np.asarray(t)
        return np.asarray([t / (t + 10), 10 * t / (t + 10) ** 2])

    return IVProblem("rational", rhs, (5.0, 9.0),
                     np.array([1 / 3, 2 / 9]), solution=sol)


def exponential_decay(rate=0.5):
    """extensisq's README 3-state example."""
    def rhs(t, y):
        return -rate * y

    def sol(t):
        t = np.atleast_1d(np.asarray(t, dtype=float))
        return np.exp(-rate * t)[None, :] * np.array([2, 4, 8])[:, None]

    return IVProblem("exponential_decay", rhs, (0.0, 10.0),
                     np.array([2.0, 4.0, 8.0]), solution=sol)


def robertson(p=(0.04, 1e4, 3e7)):
    """Robertson stiff kinetics, parametric (the CVODES sensitivity
    setup); ``rhs`` closes over p, ``extra["rhs_p"]`` takes it."""
    p1, p2, p3 = p

    def rhs_p(t, y, *pp):
        q1, q2, q3 = pp
        return torch.stack([-q1 * y[0] + q2 * y[1] * y[2],
                            q1 * y[0] - q2 * y[1] * y[2] - q3 * y[1] ** 2,
                            q3 * y[1] ** 2])

    def rhs(t, y):
        return rhs_p(t, y, p1, p2, p3)

    def jac(t, y):
        return _matrix([[-p1, p2 * y[2], p2 * y[1]],
                        [p1, -p2 * y[2] - 2 * p3 * y[1], -p2 * y[1]],
                        [0.0, 2 * p3 * y[1], 0.0]])

    def dfdp(t, y, *pp):
        return _matrix([[-y[0], y[1] * y[2], 0.0],
                        [y[0], -y[1] * y[2], -y[1] ** 2],
                        [0.0, 0.0, y[1] ** 2]])

    return IVProblem("robertson", rhs, (0.0, 1e8),
                     np.array([1.0, 0.0, 0.0]), jac=jac,
                     params=np.asarray(p), dfdp=dfdp,
                     extra={"rhs_p": rhs_p})


def kaps():
    """Kaps problem: mildly stiff 2-state with exact solution
    ``[exp(-2t), exp(-t)]``."""
    def rhs(t, y):
        return torch.stack([-y[0] + y[1] ** 2,
                            y[0] - y[1] - y[1] ** 2])

    def jac(t, y):
        return _matrix([[-1.0, 2 * y[1]], [1.0, -1 - 2 * y[1]]])

    def sol(t):
        t = np.asarray(t)
        return np.stack([np.exp(-t) ** 2, np.exp(-t)])

    return IVProblem("kaps", rhs, (0.0, 1.0), np.array([1.0, 1.0]),
                     jac=jac, solution=sol)


def vdp(mu=1e3):
    """Van der Pol oscillator; the flagship ensemble and benchmark
    problem (stiff for large mu)."""
    def rhs(t, y):
        return torch.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])

    def jac(t, y):
        return _matrix([[0.0, 1.0],
                        [-2 * mu * y[0] * y[1] - 1.0,
                         mu * (1 - y[0] ** 2)]])

    return IVProblem("vdp", rhs, (0.0, 3000.0 if mu >= 100 else 20.0),
                     np.array([2.0, 0.0]), jac=jac, params=mu)


def pendulum_dae(theta0=0.5, g=9.81):
    """Index-1 Cartesian pendulum (twice-differentiated length
    constraint, singular mass matrix).  State ``[x, y, vx, vy, lambda]``;
    lambda(t0) is inconsistent (0) on purpose: the solver's
    consistent-initial-condition projection fixes it."""
    def rhs(t, s):
        x, ya, vx, vy, lam = s
        return torch.stack([
            vx, vy, -lam * x, -lam * ya - g,
            vx ** 2 + vy ** 2 - lam * (x ** 2 + ya ** 2) - g * ya])

    y0 = np.array([np.sin(theta0), -np.cos(theta0), 0.0, 0.0, 0.0])
    M = np.diag([1.0, 1.0, 1.0, 1.0, 0.0])
    return IVProblem("pendulum_dae", rhs, (0.0, 10.0), y0, M=M,
                     extra={"lambda0": g * np.cos(theta0)})


def pleiades():
    """7-body Pleiades (28 states first-order, 14 + 14 second-order);
    the oscillatory RKN benchmark.  ``extra["accel"]`` maps positions
    ``(14, B)`` to accelerations."""
    masses = np.arange(1.0, 8.0)
    eye = np.eye(7)
    cache = {}

    def accel(q):
        m, e = _consts(cache, (masses, eye), q)
        x, ya = q[:7], q[7:]
        dx = x[None, :] - x[:, None]
        dy = ya[None, :] - ya[:, None]
        r2 = dx * dx + dy * dy + e[..., None]
        w = m[None, :, None] * r2 ** -1.5 * (1.0 - e)[..., None]
        return torch.cat([(w * dx).sum(1), (w * dy).sum(1)])

    def rhs(t, y):
        return torch.cat([y[14:], accel(y[:14])])

    q0 = np.array([3, 3, -1, -3, 2, -2, 2,
                   3, -3, 2, 0, 0, -4, 4], dtype=float)
    v0 = np.array([0, 0, 0, 0, 0, 1.75, -1.5,
                   0, 0, 0, -1.25, 1, 0, 0], dtype=float)
    return IVProblem("pleiades", rhs, (0.0, 3.0),
                     np.concatenate([q0, v0]),
                     extra={"accel": accel, "q0": q0, "v0": v0})


def medazko(N=200):
    """Medical Akzo Nobel reaction-transport problem, 2N states; banded
    Jacobian (bandwidths 4, 4), the ``jac_sparsity`` and ``bands``
    showcase."""
    k = 100.0
    c = 4.0
    d = 1.0 / N
    j = np.arange(N) + 1
    alpha = 2 * (j * d - 1) ** 3 / c ** 2
    beta = (j * d - 1) ** 4 / c ** 2
    # yext rows 2j + 2, 2j - 2, 2j and 2j + 1 for j = 1..N, as slices
    j_2_p1 = slice(4, 2 * N + 3, 2)
    j_2_m3 = slice(0, 2 * N - 1, 2)
    j_2_m1 = slice(2, 2 * N + 1, 2)
    j_2 = slice(3, 2 * N + 2, 2)
    cache = {}

    def rhs(t, y):
        a, b = _consts(cache, (alpha[:, None], beta[:, None]), y)
        phi = torch.where(t <= 5.0, 2.0, 0.0).to(y.dtype)
        yext = torch.cat([phi[None], torch.zeros_like(phi)[None], y,
                          y[-2:-1]])
        u = (a * (yext[j_2_p1] - yext[j_2_m3]) / (2 * d)
             + b * (yext[j_2_m3] - 2 * yext[j_2_m1]
                    + yext[j_2_p1]) / d ** 2
             - k * yext[j_2_m1] * yext[j_2])
        v = -k * yext[j_2] * yext[j_2_m1]
        return torch.stack([u, v], dim=1).reshape(2 * N, -1)

    y0 = np.zeros(2 * N)
    y0[1::2] = 1.0
    i = np.arange(2 * N)
    S = (np.abs(i[:, None] - i[None, :]) <= 4).astype(int)
    return IVProblem("medazko", rhs, (0.0, 20.0), y0, jac_sparsity=S)


def brusselator_2d(shape=(64, 64), A=1.0, B=3.0, alpha=0.02):
    """2-D reaction-diffusion Brusselator, flat ``[u.ravel(),
    v.ravel()]`` layout on a periodic grid; the RHS and the rho bound are
    :mod:`~extensisq_tpu_torch.parallel.pde`'s."""
    from ..parallel.pde import brusselator_2d_rhs, brusselator_rho_bound
    ny, nx = shape
    xg, yg = np.meshgrid(np.linspace(0, 1, nx, endpoint=False),
                         np.linspace(0, 1, ny, endpoint=False))
    u0 = 1.0 + 0.5 * np.sin(2 * np.pi * xg) * np.sin(2 * np.pi * yg)
    v0 = 3.0 + 0.1 * np.cos(2 * np.pi * xg)
    y0 = np.concatenate([u0.ravel(), v0.ravel()])
    return IVProblem(
        "brusselator_2d",
        brusselator_2d_rhs(shape, A=A, B=B, alpha=alpha),
        (0.0, 1.0), y0,
        rho_jac=brusselator_rho_bound(shape, A=A, B=B, alpha=alpha),
        extra={"shape": shape})


def combustion_3d(N=40):
    """3-D combustion wave, 2 species, ``2 N^3`` states (the RKC paper's
    Table 3 problem).  Low faces Neumann, high faces Dirichlet (= 1);
    layout ``[c.ravel(), T.ravel()]``."""
    L, alpha_c, delta, R = 0.9, 1.0, 20.0, 5.0
    D = R * np.exp(delta) / (alpha_c * delta)
    h = 1.0 / (N + 0.5)
    m = N ** 3

    def lap(A):
        return (1.0 / h ** 2) * (
            -6 * A[1:-1, 1:-1, 1:-1]
            + A[:-2, 1:-1, 1:-1] + A[2:, 1:-1, 1:-1]
            + A[1:-1, :-2, 1:-1] + A[1:-1, 2:, 1:-1]
            + A[1:-1, 1:-1, :-2] + A[1:-1, 1:-1, 2:])

    def expand(A):
        # each axis: the low face copies the first interior plane, the
        # high face is 1
        for ax in range(3):
            lo = A.narrow(ax, 0, 1)
            A = torch.cat([lo, A, torch.ones_like(lo)], dim=ax)
        return A

    def rhs(t, y):
        c = expand(y[:m].reshape(N, N, N, -1))
        T = expand(y[m:].reshape(N, N, N, -1))
        Ti = T[1:-1, 1:-1, 1:-1]
        Dce = D * c[1:-1, 1:-1, 1:-1] * torch.exp(over(-delta, Ti))
        dc = lap(c) - Dce
        dT = (lap(T) + alpha_c * Dce) / L
        return torch.cat([dc.reshape(m, -1), dT.reshape(m, -1)])

    y0 = np.ones(2 * m)
    return IVProblem("combustion_3d", rhs, (0.0, 0.3), y0,
                     extra={"N": N})


__all__ = ["IVProblem", "rational", "exponential_decay", "robertson",
           "kaps", "vdp", "pendulum_dae", "pleiades", "medazko",
           "brusselator_2d", "combustion_3d"]
