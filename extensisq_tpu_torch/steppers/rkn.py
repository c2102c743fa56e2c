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
from .erk import ERKStepper, ERKState, weighted_sum

_SECOND_ORDER = ("This method is for second order problems and `fun` should"
                 " have signature: [v, a] = fun(t, [x, v]).")


class RKNStepper(ERKStepper):
    """init/step functions for one (fun, RKN tableau, controller).

    ``scale_embedded`` damps the embedded error estimate by 0.75 (Mu5Nmb's
    default, extensisq ``murua.py``).
    """

    def __init__(self, fun, tableau, n, dtype, sc_params=None,
                 scale_embedded=False):
        if n % 2:
            raise ValueError(_SECOND_ORDER)
        super().__init__(fun, tableau, n, dtype, sc_params=sc_params)
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

    def validate_problem(self, fun_np, t0, y0):
        raise NotImplementedError(
            "the host driver's second-order problem check is not ported "
            "yet: ROADMAP A7")

    def record_coefficients(self, state):
        raise NotImplementedError("RKN dense output is not ported yet: "
                                  "ROADMAP A4b")

    def dense_segments(self, state, interpolant=None):
        raise NotImplementedError("RKN dense output is not ported yet: "
                                  "ROADMAP A4b")

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        """Initial state: h_start runs on the first-order form; the carried
        derivative ``f`` is the acceleration ``(m, B)``."""
        B = y0.shape[1]
        t0 = torch.as_tensor(t0, dtype=self.dtype,
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
            nfev=i0 + nfev, nsteps=i0, nfailed=i0)

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
