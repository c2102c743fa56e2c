"""CKdisc: the Cash-Karp variable-order (5/3/2) stepper for non-smooth
problems, over a batch of members.

Counterpart of ``extensisq_tpu/steppers/ckdisc.py``.  The method anticipates
failure: staged error assessments E1 (after stage 2) and E2 (after stage 4)
veto the rest of an attempt, and fallback solutions of order 3 and 2
advance a member to the internal points c = 3/5 and 1/5 of the step with no
further evaluations.  The adaptive ``twiddle`` and ``quit`` factors are
per-member state.

State is rows-first, ``(n, B)`` with members on the last axis.  Where the
JAX stepper skips stages under ``lax.cond``, this one evaluates every
stage for the whole batch and selects with ``torch.where`` (a skipped
member's stage arguments may be inf or NaN, so nothing is multiplied by a
mask); ``nfev`` counts only what each member's own branch evaluated.  The
stage rows are carried from step to step only with ``carry_stages``, for
dense output (``record_coefficients``, ``dense_segments``) and events.
"""
from typing import Any, NamedTuple

import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW
from ..core.hstart import h_start
from ..core.interpolate import (hermite_cubic_coefficients,
                                stage_coefficients)
from ..core.numerics import (calculate_scale, dtype_constants, norm, over,
                             real_dtype)
from .erk import ERKStepper, weighted_sum

SAFETY = 0.9
MAX_FACTOR_CK = 5.0
MIN_FACTOR_CK = 0.2


class CKState(NamedTuple):
    """Per-member solver state; every field has the member axis last."""
    t: Any                   # (B,)
    y: Any                   # (n, B)
    f: Any                   # (n, B) derivative at (t, y)
    h_abs: Any
    status: Any              # int32 status code
    twiddle: Any             # (2, B)
    quit_f: Any              # (2, B)
    order_accepted: Any      # error order of the last accepted step: 4, 2, 1
    h_previous: Any          # signed h of the last accepted (sub-)step
    nfev: Any                # int32 counters
    nsteps: Any
    nfailed: Any
    # carry_stages only (None otherwise): the last accepted step
    t_old: Any = None
    y_old: Any = None
    K: Any = None            # (7, n, B): its stages, the endpoint's last


class CKdiscStepper:
    """init/step functions for one (fun, CKdisc tableau) combination.

    ``data`` holds the cascade's assessment and fallback weights
    (``methods.erk.CKDISC_DATA``).  ``fun(t, y)`` takes ``t`` of shape
    ``(B,)`` and ``y`` of shape ``(n, B)``.
    """
    family = "ckdisc"

    def __init__(self, fun, tableau, n, dtype, data, carry_stages=False):
        self.fun = fun
        self.carry_stages = bool(carry_stages)
        self.matrices = {}           # the interpolant matrix on the device
        self.tab = tableau
        self.n = n
        self.dtype = dtype
        consts = dtype_constants(dtype)
        self.h_min_a = 10.0 * consts["epsneg"] / tableau.c_spacing()
        self.h_min_b = consts["sqrt_tiny"]
        self.A, self.B, self.C, self.E = (tableau.A, tableau.B, tableau.C,
                                          tableau.E)
        self.B_assess = data["B_assess"]
        self.E_assess = data["E_assess"]
        self.C_fallback = data["C_fallback"]
        self.B_fallback = data["B_fallback"]
        self.E_fallback = data["E_fallback"]

    def init(self, t0, y0, params, first_step=None):
        """Initial state for ``y0`` of shape ``(n, B)`` at time ``t0``:
        1 RHS evaluation, plus Watts' start (``1 + min(n + 1, 3)``) unless
        ``first_step`` is given."""
        B = y0.shape[1]
        t0 = torch.as_tensor(t0, dtype=real_dtype(self.dtype),
                             device=y0.device).expand(B).clone()
        f0 = self.fun(t0, y0)
        nfev = 1
        if first_step is None:
            b = t0 + params.direction * torch.clamp(
                torch.abs(params.t_bound - t0), max=params.max_step)
            h_abs = torch.abs(h_start(
                self.fun, t0, b, y0, f0, self.tab.order_secondary,
                params.rtol, params.atol))
            nfev += 1 + min(self.n + 1, 3)
        else:
            h_abs = torch.full_like(t0, float(first_step))
        i0 = torch.zeros(B, dtype=torch.int32, device=y0.device)
        pair = torch.ones(2, B, dtype=t0.dtype, device=y0.device)
        dense = {}
        if self.carry_stages:
            dense = dict(t_old=t0, y_old=y0,
                         K=y0.new_zeros((self.tab.n_stages + 1,)
                                        + tuple(y0.shape)))
        return CKState(
            t=t0, y=y0, f=f0, h_abs=h_abs, status=i0 + RUNNING,
            twiddle=pair * torch.tensor([[1.5], [1.1]], dtype=t0.dtype,
                                        device=y0.device),
            quit_f=pair * 100.0, order_accepted=i0 + 4,
            h_previous=torch.zeros_like(t0), nfev=i0 + nfev, nsteps=i0,
            nfailed=i0, **dense)

    # -- the cascade ---------------------------------------------------------

    def _run_stages(self, t, y, h, lo, hi, rows):
        for i in range(lo, hi):
            dy = h * weighted_sum(rows[:i], self.A[i, :i])
            rows.append(self.fun(t + float(self.C[i]) * h, y + dy))

    def _sol_err_tol(self, params, y, h, rows, B, E, i):
        sol = y + h * weighted_sum(rows[:i], B[:i])
        err = h * weighted_sum(rows[:i], E[:i])
        return sol, err, calculate_scale(params.atol, params.rtol, y, sol)

    def _attempt(self, params, t, y, f, h_abs, tw, qf, rejected):
        """One E1/E2/E4 cascade attempt of every member
        (extensisq ``cash.py``): returns a dict of its outcome."""
        h = h_abs * params.direction
        rows = [f]
        self._run_stages(t, y, h, 1, 2, rows)
        _, err, tol = self._sol_err_tol(params, y, h, rows, self.B_assess[0],
                                        self.E_assess[0], 2)
        E1 = torch.sqrt(norm(err / tol))
        go2 = E1 < tw[0] * qf[0]

        # stages 2-3 and E2 where E1 lets the attempt go on
        self._run_stages(t, y, h, 2, 4, rows)
        rows[2:4] = [torch.where(go2, r, 0.0) for r in rows[2:4]]
        _, err, tol = self._sol_err_tol(params, y, h, rows, self.B_assess[1],
                                        self.E_assess[1], 4)
        E2 = torch.where(go2, torch.pow(norm(err / tol), 1.0 / 3.0), torch.inf)
        go4 = go2 & (E2 < tw[1] * qf[1])

        # stages 4-5 and the 5(4) assessment E4 where E2 lets it go on
        self._run_stages(t, y, h, 4, 6, rows)
        rows[4:6] = [torch.where(go4, r, 0.0) for r in rows[4:6]]
        y5, err, tol = self._sol_err_tol(params, y, h, rows, self.B,
                                         self.E[:6], 6)
        E4 = torch.pow(norm(err / tol), 0.2)
        E4 = torch.where(go4, torch.where(E4 == 0.0, 1e-160, E4), torch.inf)
        accept4 = go4 & (E4 < 1.0)
        # the skipped branch's inf has go4 False, so an overflow is exactly
        # go4 with a non-finite E4
        bad = go4 & ~torch.isfinite(E4)

        # twiddle update when the 5th-order solution was rejected
        EQ = torch.stack([E1 / qf[0], E2 / qf[1]])
        tw_new = torch.where(EQ < tw, torch.clamp(EQ, min=1.1), tw)
        twiddle = torch.where(go4 & ~accept4, tw_new, tw)
        # quit-factor update on acceptance
        q = torch.stack([E1, E2]) / torch.clamp(E4, min=1e-300)
        q_adj = torch.where(q > qf, torch.minimum(q, 10.0 * qf),
                            torch.maximum(q, 2.0 / 3.0 * qf))
        quit_f = torch.where(accept4, torch.clamp(q_adj, 1.0, 10000.0), qf)

        # third-order, then second-order fallback
        y3, err, tol = self._sol_err_tol(params, y, h, rows,
                                         self.B_fallback[1],
                                         self.E_fallback[1], 4)
        fb3_ok = (go4 & ~accept4 & (E2 < 1.0) & ~bad
                  & (norm(err / tol) < 1.0))
        y2, err, tol = self._sol_err_tol(params, y, h, rows,
                                         self.B_fallback[0],
                                         self.E_fallback[0], 2)
        fb2_try = go2 & ~accept4 & ~fb3_ok & (E1 < 1.0) & ~bad
        fb2_ok = fb2_try & (norm(err / tol) < 1.0)
        accepted = accept4 | fb3_ok | fb2_ok

        # the next step size; a fallback shortens this step too: its
        # weights sum to C_fallback, so its solution lives at t + c h
        c3, c2 = float(self.C_fallback[1]), float(self.C_fallback[0])
        esttol = torch.where(go4, E4, torch.where(go2, E2 / qf[1],
                                                  E1 / qf[0]))
        fac4 = torch.clamp(over(SAFETY, torch.clamp(E4, min=1e-300)),
                           max=MAX_FACTOR_CK)
        fac4 = torch.where(rejected, torch.clamp(fac4, max=1.0), fac4)
        fac_rej = torch.clamp(over(SAFETY, torch.clamp(esttol, min=1e-300)),
                              min=MIN_FACTOR_CK)
        h_next = torch.where(
            accept4, h_abs * fac4,
            torch.where(fb3_ok, h_abs * c3,
                        torch.where(fb2_try, h_abs * c2, h_abs * fac_rej)))
        return dict(
            accepted=accepted, bad=bad, twiddle=twiddle, quit_f=quit_f,
            h_abs=h_next,
            h_used=torch.where(accept4, h, torch.where(fb3_ok, h * c3,
                                                       h * c2)),
            y_new=torch.where(accept4, y5, torch.where(fb3_ok, y3, y2)),
            order=torch.where(accept4, 4, torch.where(fb3_ok, 2, 1)),
            nfev=1 + 2 * go2.to(torch.int32) + 2 * go4.to(torch.int32),
            rows=rows)

    def reassess_stepsize(self, params, t, h_abs):
        """Step-size limits + end-of-interval look-ahead split."""
        min_step = torch.clamp(self.h_min_a * (torch.abs(t) + h_abs),
                               min=self.h_min_b)
        h_abs = torch.clamp(torch.maximum(min_step, h_abs),
                            max=params.max_step)
        d = torch.abs(params.t_bound - t)
        split = (d < 2.0 * h_abs) & (d > h_abs)
        h_abs = torch.where(split, torch.maximum(0.5 * d, min_step),
                            torch.where(d <= h_abs, d, h_abs))
        return h_abs, min_step

    # -- flat (attempt-level) stepping for the batched solve loop ------------

    def flat_init_aux(self, state):
        """Auxiliary carry for attempt-level looping: (fresh, min_step,
        rejected_this_step)."""
        ones = torch.ones_like(state.status, dtype=torch.bool)
        return (ones, torch.zeros_like(state.t), ~ones)

    def step_flat(self, params, state, aux):
        """Exactly ONE cascade attempt per member; a member's state advances
        where the attempt is accepted at order 5, 3 or 2.  The step-size
        reassessment runs on fresh steps only, and the twiddle and quit
        factors and reduced h of a rejected attempt persist through the
        state.  Returns (state', aux', accepted)."""
        fresh, min_step_c, rejected = aux
        t, y, f = state.t, state.y, state.f
        h_abs_r, min_step_r = self.reassess_stepsize(params, t, state.h_abs)
        h_abs = torch.where(fresh, h_abs_r, state.h_abs)
        min_step = torch.where(fresh, min_step_r, min_step_c)
        status = torch.where((h_abs < min_step) & (state.status == RUNNING),
                             TOO_SMALL_STEP, state.status)
        # a too-small step or a terminal status evaluates nothing for that
        # member (the JAX lax.cond)
        gate = status == RUNNING
        a = self._attempt(params, t, y, f, h_abs, state.twiddle,
                          state.quit_f, rejected)
        ok = gate & a["accepted"]
        status = torch.where(gate & a["bad"], OVERFLOW, status)

        d = torch.abs(params.t_bound - t)
        is_last = ok & (torch.abs(a["h_used"]) >= d)
        t_new = torch.where(is_last, params.t_bound, t + a["h_used"])
        f_new = torch.where(ok, self.fun(t_new, a["y_new"]), f)
        status = torch.where((status == RUNNING) & is_last, FINISHED,
                             status).to(torch.int32)
        nfev = (state.nfev + torch.where(gate, a["nfev"], 0)
                + ok.to(torch.int32))
        dense = {}
        if self.carry_stages:
            dense = dict(t_old=torch.where(ok, t, state.t_old),
                         y_old=torch.where(ok, y, state.y_old),
                         K=torch.where(ok, torch.stack(a["rows"] + [f_new]),
                                       state.K))
        new_state = CKState(
            t=torch.where(ok, t_new, t),
            y=torch.where(ok, a["y_new"], y),
            f=f_new,
            h_abs=torch.where(gate, a["h_abs"], h_abs),
            status=status,
            twiddle=torch.where(gate, a["twiddle"], state.twiddle),
            quit_f=torch.where(gate, a["quit_f"], state.quit_f),
            order_accepted=torch.where(ok, a["order"],
                                       state.order_accepted).to(torch.int32),
            h_previous=torch.where(ok, a["h_used"], state.h_previous),
            nfev=nfev.to(torch.int32),
            nsteps=state.nsteps + ok.to(torch.int32),
            nfailed=state.nfailed + (gate & ~a["accepted"]).to(torch.int32),
            **dense)
        rejected = rejected | (gate & ~a["accepted"])
        aux_new = (ok | (status != RUNNING), min_step, rejected & ~ok)
        return new_state, aux_new, ok

    # one accepted step per member: step_flat until accepted (the JAX
    # ``step``'s inner loop)
    step = ERKStepper.step

    # -- dense output --------------------------------------------------------

    def record_coefficients(self, state):
        """The order-aware free interpolant ``(n, p, B)`` (extensisq
        ``cash.py``): ``K^T P h`` after a fifth-order step, the cubic
        Hermite (zero-padded) after a fallback, per member."""
        h = state.h_previous
        Qp = stage_coefficients(state.K, self.tab.P, h, self.matrices)
        Qc = hermite_cubic_coefficients(h, state.y_old, state.y,
                                        state.K[0], state.K[-1])
        Qc = torch.cat([Qc, Qc.new_zeros((Qc.shape[0], Qp.shape[1]
                                          - Qc.shape[1], Qc.shape[2]))],
                       dim=1)
        return torch.where(state.order_accepted == 4, Qp, Qc)

    def dense_segments(self, state, interpolant=None):
        return [(state.t_old, state.h_previous, state.y_old,
                 self.record_coefficients(state))], 0
