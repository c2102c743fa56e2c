"""Explicit Runge-Kutta-Nystrom stepper for second-order systems, over a
batch of members.

Counterpart of ``extensisq_tpu/steppers/rkn.py``.  The user state is
``y = [u, v]`` (rows-first, ``(2m, B)``) and ``fun(t, y)`` returns
``[v, a]``, as in the reference; only the accelerations are stored as
stage rows.  Displacements update with ``h^2 A`` weights, velocities with
``h Ap``; velocity-independent (strict) methods have no ``Ap``.

The stepper is the ERK stepper with its stage machinery replaced: the
attempt, the controller and the flat step loop are the base class's.  The
base class evaluates ``self.fun`` for stages and for the endpoint of a
non-FSAL pair, so here ``self.fun`` is the acceleration-only RHS and the
first-order ``fun`` is kept for ``init``'s starting step.
"""
import numpy as np
import torch

from .._config import RUNNING
from ..core.hstart import h_start
from ..core.numerics import real_dtype
from ..core.interpolate import (host_matrix, nystrom_coefficients,
                                quintic_hermite_coefficients)
from .erk import ERKStepper, ERKState, weighted_sum

_SECOND_ORDER = ("This method is for second order problems and `fun` should"
                 " have signature: [v, a] = fun(t, [x, v]).")


class RKNStepper(ERKStepper):
    """init/step functions for one (fun, RKN tableau, controller).

    ``scale_embedded`` damps the embedded error estimate by 0.75 (Mu5Nmb's
    default, extensisq ``murua.py``).
    """

    def __init__(self, fun, tableau, n, dtype, sc_params=None,
                 scale_embedded=False, carry_stages=False, interpolant=None,
                 options=None):
        if n % 2:
            raise ValueError(_SECOND_ORDER)
        super().__init__(fun, tableau, n, dtype, sc_params=sc_params,
                         carry_stages=carry_stages, interpolant=interpolant,
                         options=options)
        self.m = n // 2
        self.fun_first_order = fun
        self.fun = self.afun
        self.Ap = (np.zeros_like(tableau.A) if tableau.Ap is None
                   else tableau.Ap)
        self.Bp = tableau.Bp
        E, Ep = tableau.E, tableau.Ep
        if scale_embedded:
            E, Ep = E * 0.75, Ep * 0.75
        self.E_u = E
        self.E_v = Ep

    def afun(self, t, y):
        """The acceleration rows of the first-order RHS."""
        return self.fun_first_order(t, y)[self.m:]

    def validate_problem(self, fun_np, t0, y0, device=None):
        """The host driver's probe of the second-order form: uncounted RHS
        evaluations of ``fun_np`` (numpy in and out, evaluated where the
        driver runs, so ``device`` is not needed) on one member's ``y0``,
        as in the JAX stepper."""
        m = self.m
        y0 = np.asarray(y0)
        f0 = np.asarray(fun_np(t0, y0))
        if not np.all(y0[m:] == f0[:m]):
            raise AssertionError(_SECOND_ORDER)
        if np.all(y0[m:] == y0[:m]):
            y_test = y0.copy()
            y_test[m:] = y_test[m:] * (1 + 1e-8) + 1e-8
            if not np.all(np.asarray(fun_np(t0, y_test))[:m]
                          == y_test[m:]):
                raise AssertionError(_SECOND_ORDER)
        if self.tab.Ap is None:
            y_test = y0.copy()
            y_test[m:] = y_test[m:] * (1 + 1e-8) + 1e-8
            if not np.all(np.asarray(fun_np(t0, y_test))[m:] == f0[m:]):
                raise AssertionError(
                    "This method is for velocity independent ODEs, but "
                    "`fun` seems velocity dependent.")

    # -- dense output (carry_stages) ------------------------------------------

    def error_estimate(self, state):
        """The displacement and velocity error estimates of the last
        accepted step, stacked ``(2m, B)``."""
        h = state.h_previous
        mm = self.s + (1 if self.fsal else 0)
        rows = list(state.K)[:mm]
        eu = weighted_sum(rows, self.E_u[:mm]) * h * h
        ev = weighted_sum(rows, self.E_v[:mm]) * h
        return torch.cat([eu, ev])

    def _nystrom(self, K, P, Pp, h, y_old):
        Q, Qp = (torch.einsum("snb,sp->npb", K,
                              host_matrix(self.matrices, x, K))
                 for x in (P, Pp))
        return nystrom_coefficients(h, y_old, Q, Qp)

    def record_coefficients(self, state):
        """The free interpolant ``(2m, p, B)``: the Nystrom form of ``P``
        and ``Pp``, or the quintic Hermite where the tableau has none."""
        h = state.h_previous
        if self.tab.P is not None and self.tab.Pp is not None:
            return self._nystrom(state.K, self.tab.P, self.tab.Pp, h,
                                 state.y_old)
        return quintic_hermite_coefficients(h, state.y_old, state.y,
                                            state.f_old, state.f)

    def dense_segments(self, state, interpolant=None):
        """As the ERK stepper's; an extra-stage interpolant (Fi5N's,
        Mu5Nmb's) runs its extra stages in the Nystrom form."""
        name = interpolant if interpolant is not None else self.interpolant
        spec = (self.tab.interpolants or {}).get(name)
        if spec is None:
            return [(state.t_old, state.h_previous, state.y_old,
                     self.record_coefficients(state))], 0
        C_extra = np.atleast_1d(np.asarray(spec["C_extra"]))
        A_extra = np.atleast_2d(np.asarray(spec["A_extra"]))
        Ap_extra = np.atleast_2d(np.asarray(spec["Ap_extra"]))
        h = state.h_previous
        t_old, y_old = state.t_old, state.y_old
        v_old = y_old[self.m:]
        rows = list(state.K)
        for j, cx in enumerate(C_extra):
            sx = self.s + 1 + j
            dt = float(cx) * h
            du = weighted_sum(rows[:sx], A_extra[j, :sx]) * (h * h) \
                + dt * v_old
            dv = weighted_sum(rows[:sx], Ap_extra[j, :sx]) * h
            rows.append(self.afun(t_old + dt, y_old + torch.cat([du, dv])))
        Q = self._nystrom(torch.stack(rows), spec["P"], spec["Pp"], h, y_old)
        return [(t_old, h, y_old, Q)], len(C_extra)

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        """Initial state: h_start runs on the first-order form; the carried
        derivative ``f`` is the acceleration ``(m, B)``."""
        B = y0.shape[1]
        t0 = torch.as_tensor(t0, dtype=real_dtype(self.dtype),
                             device=y0.device).expand(B).clone()
        f_full = self.fun_first_order(t0, y0)
        nfev = 1
        if first_step is None:
            b = t0 + params.direction * torch.clamp(
                torch.abs(params.t_bound - t0), max=params.max_step)
            h_abs = torch.abs(h_start(
                self.fun_first_order, t0, b, y0, f_full,
                self.tab.order_secondary, params.rtol, params.atol))
            nfev += 1 + min(self.n + 1, 3)
        else:
            h_abs = torch.full_like(t0, float(first_step))
        i0 = torch.zeros(B, dtype=torch.int32, device=y0.device)
        return ERKState(
            t=t0, y=y0, f=f_full[self.m:], h_abs=h_abs,
            status=i0 + RUNNING,
            standard_sc=torch.ones(B, dtype=torch.bool, device=y0.device),
            error_norm_old=torch.ones_like(t0),
            h_previous=torch.zeros_like(t0),
            max_factor=torch.full_like(t0, 10.0),
            nfev=i0 + nfev, nsteps=i0, nfailed=i0,
            **self._dense_fields(t0, y0, f_full[self.m:], self.m))

    # -- RKN stage machinery -------------------------------------------------

    def _run_stages(self, t, y, h, lo, hi, K_rows):
        v = y[self.m:]
        for i in range(lo, hi):
            dt = float(self.C[i]) * h
            du = weighted_sum(K_rows[:i], self.A[i, :i]) * (h * h) + dt * v
            dv = weighted_sum(K_rows[:i], self.Ap[i, :i]) * h
            K_rows.append(self.afun(t + dt, y + torch.cat([du, dv])))
        return hi - lo

    def _solution_error(self, t, y, h, K_rows):
        v = y[self.m:]
        du = weighted_sum(K_rows[:self.s], self.B) * (h * h) + h * v
        dv = weighted_sum(K_rows[:self.s], self.Bp) * h
        y_new = y + torch.cat([du, dv])
        nfev = 0
        if self.fsal:
            K_rows.append(self.afun(t + h, y_new))
            nfev = 1
        mm = self.s + (1 if self.fsal else 0)
        eu = weighted_sum(K_rows[:mm], self.E_u[:mm]) * (h * h)
        ev = weighted_sum(K_rows[:mm], self.E_v[:mm]) * h
        return y_new, torch.cat([eu, ev]), nfev
