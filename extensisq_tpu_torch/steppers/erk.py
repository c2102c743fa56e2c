"""Explicit embedded Runge-Kutta stepper over a batch of members.

Counterpart of ``extensisq_tpu/steppers/erk.py``.  The JAX stepper is a
pure per-member function that ``solve_ensemble`` vmaps; here the batch
dimension is written out.  State is rows-first, ``(n, B)`` with members
on the last axis, so every per-member scalar is a ``(B,)`` tensor that
broadcasts against the state.  Where the JAX stepper branches per member
with ``lax.cond``, this one evaluates both sides for the whole batch and
selects with masks; the work counters add only what each member's own
branch evaluated, so ``nfev`` counts exactly what the JAX version counts.

Dense output (``dense_segments``, ``record_coefficients``) and the
stiffness bookkeeping come with ``t_eval``/events (ROADMAP A4).
"""
from typing import Any, NamedTuple

import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW
from ..core.controller import (resolve_controller, erk_accept_update,
                               reject_factor)
from ..core.hstart import h_start
from ..core.numerics import calculate_scale, norm, dtype_constants


class ERKState(NamedTuple):
    """Per-member solver state; every field has the member axis last."""
    t: Any                   # (B,)
    y: Any                   # (n, B)
    f: Any                   # (n, B) derivative at (t, y)
    h_abs: Any
    status: Any              # int32 status code
    standard_sc: Any         # bool: use first-order controller next
    error_norm_old: Any
    h_previous: Any          # signed accepted step
    max_factor: Any
    nfev: Any                # int32 counters
    nsteps: Any
    nfailed: Any


class _Carry(NamedTuple):
    """One step's accept/reject carry."""
    h_abs: Any
    h_used: Any              # signed h of the accepted attempt
    accepted: Any
    rejected: Any            # some rejection happened within this step
    status: Any
    standard_sc: Any
    max_factor: Any
    y_new: Any
    f_new: Any               # FSAL derivative at the accepted endpoint
    error_norm: Any
    nfev: Any
    nfailed: Any


def select(mask, a, b):
    """Field-wise ``torch.where(mask, a, b)`` over two NamedTuples (or
    tuples) of tensors; ``mask`` is per member, ``(B,)``.  Fields have the
    member axis last, except those a NamedTuple type names in its
    ``members_first`` (batched matrices ``(B, n, n)``), where the mask
    goes on the first axis."""
    first = getattr(type(a), "members_first", ())
    names = getattr(a, "_fields", ())
    vals = []
    for i, (x, y) in enumerate(zip(a, b)):
        m = mask
        if names and names[i] in first:
            m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        vals.append(torch.where(m, x, y))
    return type(a)(*vals) if names else tuple(vals)


def weighted_sum(K_rows, weights):
    """sum_j w_j * K_j with zero weights skipped, summed in order."""
    acc = None
    for w, k in zip(weights, K_rows):
        if w == 0.0:
            continue
        term = float(w) * k
        acc = term if acc is None else acc + term
    if acc is None:
        return torch.zeros_like(K_rows[0])
    return acc


class ERKStepper:
    """init/step functions for one (fun, tableau, controller) combination.

    ``fun(t, y)`` takes ``t`` of shape ``(B,)`` and ``y`` of shape
    ``(n, B)`` and returns ``(n, B)``.
    """

    def __init__(self, fun, tableau, n, dtype, sc_params=None):
        self.fun = fun
        self.tab = tableau
        self.n = n
        self.dtype = dtype
        consts = dtype_constants(dtype)
        cdiff = tableau.c_spacing()
        self.h_min_a = 10.0 * consts["epsneg"] / cdiff
        self.h_min_b = consts["sqrt_tiny"]
        self.tiny_err = self.h_min_b
        err_order = min(tableau.order_secondary, tableau.order)
        self.error_exponent = -1.0 / (err_order + 1)
        self.cc = resolve_controller(sc_params, tableau.sc_params,
                                     self.error_exponent)
        self.A = tableau.A
        self.B = tableau.B
        self.C = tableau.C
        self.E = tableau.E
        self.fsal = tableau.fsal
        self.s = tableau.n_stages

    # -- construction ------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        """Initial state for ``y0`` of shape ``(n, B)`` at time ``t0``
        (a float or a ``(B,)`` tensor): 1 RHS eval + h_start unless
        ``first_step`` is given."""
        B = y0.shape[1]
        t0 = torch.as_tensor(t0, dtype=self.dtype,
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
        return ERKState(
            t=t0, y=y0, f=f0, h_abs=h_abs,
            status=i0 + RUNNING,
            standard_sc=torch.ones(B, dtype=torch.bool, device=y0.device),
            error_norm_old=torch.ones_like(t0),
            h_previous=torch.zeros_like(t0),
            max_factor=torch.full_like(t0, 10.0),
            nfev=i0 + nfev, nsteps=i0, nfailed=i0)

    # -- stage machinery -----------------------------------------------------

    def _run_stages(self, t, y, h, lo, hi, K_rows):
        """Evaluate stages lo..hi-1, appending to K_rows."""
        for i in range(lo, hi):
            dy = h * weighted_sum(K_rows[:i], self.A[i, :i])
            K_rows.append(self.fun(t + float(self.C[i]) * h, y + dy))
        return hi - lo

    def _solution_error(self, t, y, h, K_rows):
        """y_new, optional FSAL eval, raw error vector."""
        y_new = y + h * weighted_sum(K_rows[:self.s], self.B)
        nfev = 0
        if self.fsal:
            K_rows.append(self.fun(t + h, y_new))
            nfev = 1
        m = self.s + (1 if self.fsal else 0)
        err = h * weighted_sum(K_rows[:m], self.E[:m])
        return y_new, err, nfev

    def reassess_stepsize(self, params, t, h_abs, standard_sc):
        """Step-size limits + end-of-interval look-ahead split."""
        min_step = torch.clamp(self.h_min_a * (torch.abs(t) + h_abs),
                               min=self.h_min_b)
        out_of_range = (h_abs < min_step) | (h_abs > params.max_step)
        h_abs = torch.clamp(torch.maximum(min_step, h_abs),
                            max=params.max_step)
        standard_sc = standard_sc | out_of_range

        d = torch.abs(params.t_bound - t)
        split = (d < 2.0 * h_abs) & (d > h_abs)
        h_abs = torch.where(split, torch.maximum(0.5 * d, min_step),
                            torch.where(d <= h_abs, d, h_abs))
        standard_sc = standard_sc | split
        return h_abs, min_step, standard_sc

    # -- one attempt ---------------------------------------------------------

    def _attempt(self, params, t, y, f, state, c):
        h = c.h_abs * params.direction
        zero_y = torch.zeros_like(f)
        nfev = c.nfev

        if getattr(self.tab, "E_pre", None) is not None:
            npre = self.tab.n_pre
            K_rows = [f]
            nfev = nfev + self._run_stages(t, y, h, 1, npre, K_rows)
            # pre-error check with the premature solution as scale weight
            # (extensisq bogacki.py / calvo.py)
            y_pre = y + h * weighted_sum(K_rows[:npre], self.tab.B_pre)
            scale_pre = calculate_scale(params.atol, params.rtol, y, y_pre)
            err_pre = h * weighted_sum(K_rows[:npre], self.tab.E_pre)
            pre_norm = norm(err_pre / scale_pre)
            pre_ok = ~(pre_norm > 1.0)

            # the JAX stepper evaluates the remaining stages under
            # lax.cond; here every member runs them and the members whose
            # pre-check failed take the skip branch's values and counts
            ev = self._run_stages(t, y, h, npre, self.s, K_rows)
            y_fin, err, ev2 = self._solution_error(t, y, h, K_rows)
            scale = calculate_scale(params.atol, params.rtol, y, y_fin)
            norm_fin = norm(err / scale)
            y_new = torch.where(pre_ok, y_fin, y)
            f_last = torch.where(pre_ok, K_rows[-1], zero_y) \
                if self.fsal else zero_y
            error_norm = torch.where(pre_ok, norm_fin, torch.inf)
            nfev = nfev + torch.where(pre_ok, ev + ev2, 0).to(torch.int32)
            err_for_reject = torch.where(pre_ok, error_norm, pre_norm)
            accepted = pre_ok & (error_norm < 1.0)
            bad = pre_ok & ~torch.isfinite(error_norm)
        else:
            K_rows = [f]
            nfev = nfev + self._run_stages(t, y, h, 1, self.s, K_rows)
            y_new, err, ev2 = self._solution_error(t, y, h, K_rows)
            nfev = nfev + ev2
            f_last = K_rows[-1] if self.fsal else zero_y
            scale = calculate_scale(params.atol, params.rtol, y, y_new)
            error_norm = norm(err / scale)
            err_for_reject = error_norm
            accepted = error_norm < 1.0
            bad = ~torch.isfinite(error_norm)

        # controller: accepted and rejected branches
        h_ratio = h / torch.where(state.h_previous == 0.0, h,
                                  state.h_previous)
        factor_acc, sc_acc, mf_acc = erk_accept_update(
            self.cc, self.tiny_err, error_norm, state.error_norm_old,
            h_ratio, c.rejected, c.standard_sc, c.max_factor)
        factor_rej = reject_factor(self.cc, err_for_reject)

        h_abs_new = c.h_abs * torch.where(accepted, factor_acc, factor_rej)
        status = torch.where(bad & ~accepted, OVERFLOW, c.status)
        return _Carry(
            h_abs=h_abs_new,
            h_used=torch.where(accepted, h, c.h_used),
            accepted=accepted,
            rejected=c.rejected | ~accepted,
            status=status.to(torch.int32),
            standard_sc=torch.where(accepted, sc_acc, c.standard_sc),
            max_factor=torch.where(accepted, mf_acc, c.max_factor),
            y_new=torch.where(accepted, y_new, c.y_new),
            f_new=torch.where(accepted, f_last, c.f_new),
            error_norm=torch.where(accepted, error_norm, c.error_norm),
            nfev=nfev,
            nfailed=c.nfailed + (~accepted).to(torch.int32),
        )

    # -- flat (attempt-level) stepping for the batched solve loop ------------

    def flat_init_aux(self, state):
        """Auxiliary carry for attempt-level looping: (fresh, min_step,
        rejected_this_step)."""
        ones = torch.ones_like(state.standard_sc)
        return (ones, torch.zeros_like(state.t), ~ones)

    def step_flat(self, params, state, aux):
        """Exactly ONE step attempt per member; a member's state advances
        where its attempt is accepted.  Returns (state', aux', accepted).
        """
        fresh, min_step_c, rejected = aux
        t, y, f = state.t, state.y, state.f

        # per-STEP preparation only on a fresh step
        h_abs_r, min_step_r, sc_r = self.reassess_stepsize(
            params, t, state.h_abs, state.standard_sc)
        h_abs = torch.where(fresh, h_abs_r, state.h_abs)
        min_step = torch.where(fresh, min_step_r, min_step_c)
        standard_sc = torch.where(fresh, sc_r, state.standard_sc)

        too_small = h_abs < min_step
        c = _Carry(
            h_abs=h_abs,
            h_used=torch.zeros_like(state.h_previous),
            accepted=torch.zeros_like(fresh),
            rejected=rejected,
            status=state.status,
            standard_sc=standard_sc,
            max_factor=state.max_factor,
            y_new=y, f_new=torch.zeros_like(f),
            error_norm=state.error_norm_old,
            nfev=state.nfev, nfailed=state.nfailed)
        # a too-small step or an already-terminal status evaluates no RHS
        # for that member (the JAX lax.cond), so nfev/nfailed keep only
        # the attempts that ran
        gate = ~too_small & (state.status == RUNNING)
        c = select(gate, self._attempt(params, t, y, f, state, c), c)
        ok = c.accepted & ~too_small
        status = torch.where(too_small & (state.status == RUNNING),
                             TOO_SMALL_STEP, c.status)

        d = torch.abs(params.t_bound - t)
        is_last = ok & (torch.abs(c.h_used) >= d)
        t_new = torch.where(is_last, params.t_bound, t + c.h_used)

        if self.fsal:
            f_new = c.f_new
            nfev = c.nfev
        else:
            f_new = torch.where(ok, self.fun(t_new, c.y_new), f)
            nfev = c.nfev + ok.to(torch.int32)

        status = torch.where((status == RUNNING) & is_last, FINISHED,
                             status).to(torch.int32)

        new_state = ERKState(
            t=torch.where(ok, t_new, state.t),
            y=torch.where(ok, c.y_new, state.y),
            f=torch.where(ok, f_new, state.f),
            h_abs=c.h_abs,
            status=status,
            standard_sc=torch.where(ok, c.standard_sc, standard_sc),
            error_norm_old=torch.where(ok, c.error_norm,
                                       state.error_norm_old),
            h_previous=torch.where(ok, c.h_used, state.h_previous),
            max_factor=torch.where(ok, c.max_factor, state.max_factor),
            nfev=nfev,
            nsteps=state.nsteps + ok.to(torch.int32),
            nfailed=c.nfailed)
        aux_new = (ok | (status != RUNNING), min_step, c.rejected & ~ok)
        return new_state, aux_new, ok

    # -- one step ------------------------------------------------------------

    def step(self, params, state):
        """Advance every running member by one accepted step, or set its
        terminal failure status: attempts repeat, per member, until that
        member's attempt is accepted (the JAX ``step``'s inner loop)."""
        aux = self.flat_init_aux(state)
        active = state.status == RUNNING
        while bool(active.any()):
            new, aux_new, ok = self.step_flat(params, state, aux)
            state = select(active, new, state)
            aux = select(active, aux_new, aux)
            active = active & ~ok & (state.status == RUNNING)
        return state
