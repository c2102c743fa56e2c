"""ESDIRK implicit stepper with index-1 DAE (mass matrix) support, over a
batch of members.

Counterpart of ``extensisq_tpu/steppers/esdirk.py`` (the dense path).
State is rows-first like the explicit stepper's: ``y`` is ``(n, B)`` with
members last, every per-member scalar is ``(B,)``, and the stage rows
``K`` are ``(s, n, B)``.  The Jacobian, its LU factors and pivots are
batched the way ``torch.linalg`` wants them, ``(B, n, n)`` and
``(B, n)``; their fields are named in ``members_first`` so that
:func:`~extensisq_tpu_torch.steppers.erk.select` puts the member mask on
their first axis.

* Modified-Newton stage solves with extensisq's convergence-rate
  tracking and early divergence exit (``common.py``): the JAX
  ``while_loop`` becomes at most ``NEWTON_MAXITER`` iterations of the
  whole batch, each member stopping on its own.
* The Jacobian/LU reuse strategy (preemptive refresh from predicted
  rates; failure ladder: fresh Jacobian, then a smaller step) is per
  member, as under the JAX vmap.
* The Jacobian defaults to forward-mode autodiff of the RHS: ``n``
  ``torch.func.jvp`` calls, one basis tangent per column for every
  member at once (the counterpart of ``jax.jacfwd`` under vmap).  A
  callable ``jac(t, y)`` returns the rows-first ``(n, n, B)`` matrix; a
  constant ``jac`` array selects the linear fast path (one direct solve
  per stage, a refactor on every change of h).
* The LU is ``torch.linalg.lu_factor_ex``/``lu_solve`` on ``(B, n, n)``.
* A constant mass matrix ``M``: a host SVD splits differential and
  algebraic parts, algebraic rows are rescaled by ``1/(h d)``, and DAE
  initial conditions are made consistent by Newton projection.

Where the JAX stepper branches per member with ``lax.cond`` (refactor,
Jacobian refresh, skipped stages), this one computes for the batch and
selects per member; the counters move only where the JAX branch ran.
Banded linear algebra, ``jac_sparsity`` and complex states are ROADMAP
A8b; dense output and the DAE index check come with A4b/A7.
"""
from typing import Any, NamedTuple

import numpy as np
import torch

from .._config import (RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW,
                       NEWTON_MAXITER, MAX_RATE, MAX_FACTOR_NRF, MIN_FACTOR)
from ..core.controller import (resolve_controller, esdirk_accept_update,
                               reject_factor)
from ..core.hstart import h_start
from ..core.linalg import gauss_solve
from ..core.numerics import calculate_scale, norm, dtype_constants
from .erk import select, weighted_sum


class ESDIRKState(NamedTuple):
    """Per-member solver state; member axis last except ``members_first``."""
    t: Any                  # (B,)
    y: Any                  # (n, B)
    yp: Any                 # (n, B) derivative: first stage of the next step
    h_abs: Any
    status: Any
    standard_sc: Any
    error_norm_old: Any
    h_previous: Any
    max_factor: Any
    J: Any                  # (B, n, n) current Jacobian
    current_J: Any          # J evaluated at the current (t, y)
    LU: Any                 # (B, n, n) packed LU factors
    piv: Any                # (B, n) pivots
    LU_valid: Any
    h_LU: Any               # signed h the LU was built for
    Rate: Any               # max Newton rate of the last attempt
    Niter: Any              # max Newton iterations of the last attempt
    K: Any                  # (s, n, B) stage derivatives
    nfev: Any
    njev: Any
    nlu: Any
    nls: Any                # linear solves
    nfi: Any                # failed Newton iterations
    nsteps: Any
    nfailed: Any

    members_first = ("J", "LU", "piv")


class _ECarry(NamedTuple):
    """Attempt-to-attempt carry of the accept/reject loop."""
    h_abs: Any
    h_used: Any
    accepted: Any
    rejected: Any
    status: Any
    standard_sc: Any
    max_factor: Any
    J: Any
    current_J: Any
    LU: Any
    piv: Any
    LU_valid: Any
    h_LU: Any
    Rate: Any
    Niter: Any
    y_new: Any
    error_norm: Any
    K: Any
    nfev: Any
    njev: Any
    nlu: Any
    nls: Any
    nfi: Any
    nfailed: Any

    members_first = ("J", "LU", "piv")


def jacfwd(fun, n):
    """``jac(t, y)`` -> ``(B, n, n)``: the Jacobian of the rows-first
    ``fun`` for every member, from ``n`` forward-mode JVPs, one basis
    tangent per column broadcast over the members."""
    def jac(t, y):
        cols = []
        for j in range(n):
            v = torch.zeros_like(y)
            v[j] = 1.0
            cols.append(torch.func.jvp(lambda yy: fun(t, yy), (y,), (v,))[1])
        return torch.stack(cols, dim=-1).permute(1, 0, 2)
    return jac


class ESDIRKStepper:
    """init/step functions for one (fun, tableau, controller, options)
    combination.  ``fun(t, y)`` takes ``t`` of shape ``(B,)`` and ``y``
    of shape ``(n, B)`` and returns ``(n, B)``."""

    def __init__(self, fun, tableau, n, dtype, sc_params=None, jac=None,
                 M=None, jac_each_step=False):
        self.fun = fun
        self.tab = tableau
        self.n = n
        self.dtype = dtype
        consts = dtype_constants(dtype)
        self.h_min_a = 10.0 * consts["epsneg"] / tableau.c_spacing()
        self.h_min_b = consts["sqrt_tiny"]
        # looser Newton/controller floor (extensisq common.py)
        self.tiny_err = np.sqrt(n) * consts["eps"] ** 0.8 if n else 1e-12
        self.error_exponent = -1.0 / (min(tableau.order_secondary,
                                          tableau.order) + 1)
        self.cc = resolve_controller(sc_params, tableau.sc_params,
                                     self.error_exponent, implicit=True)
        self.A, self.C, self.E, self.Az = (tableau.A, tableau.C, tableau.E,
                                           tableau.Az)
        self.d = float(tableau.d)
        self.kappa = float(tableau.kappa)
        self.s = tableau.n_stages
        self.filter_error = tableau.filter_error
        self.jac_each_step = bool(jac_each_step)
        self._consts = {}

        # Jacobian setup
        if jac is None:
            self.jac = jacfwd(fun, n)
            self.linear = False
        elif callable(jac):
            def user_jac(t, y):
                Jr = torch.as_tensor(jac(t, y), dtype=y.dtype,
                                     device=y.device)
                return Jr.expand(n, n, y.shape[1]).permute(2, 0, 1)
            self.jac = user_jac
            self.linear = False
        else:
            Jc = np.asarray(jac.toarray() if hasattr(jac, "toarray")
                            else jac, dtype=float)
            if Jc.shape != (n, n):
                raise ValueError(f"`jac` is expected to have shape {(n, n)}"
                                 f", but actually has {Jc.shape}.")
            self.J_const = Jc
            self.jac = None
            self.linear = True

        # mass matrix / DAE setup: the SVD split of extensisq _handle_M
        self.isDAE = False
        self.M = None
        if M is not None:
            M = np.asarray(M.toarray() if hasattr(M, "toarray") else M,
                           dtype=float)
            if M.ndim == 1:
                M = np.diag(M)
            if M.shape != (n, n):
                raise ValueError("M should have shape (n,) or (n, n)")
            self.M = M
            U, sv, Vh = np.linalg.svd(M)
            real = torch.empty((), dtype=dtype).numpy().dtype
            cond_lim = sv[0] * n ** 2 * np.finfo(real).eps
            self.nAE = int(np.sum(sv < cond_lim))
            self.isDAE = self.nAE > 0
            self.U, self.sv, self.Vh = U, sv, Vh

    # -- device constants ---------------------------------------------------

    def _c(self, name, like):
        """Host array ``name`` as a tensor on the device of ``like``."""
        key = (name, like.device)
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(
                getattr(self, name), dtype=self.dtype, device=like.device)
        return self._consts[key]

    def _sc(self, h):
        """(n, B) row factors of Sc = U diag(sc) U^T: 1 on the
        differential rows, 1/(h d) on the algebraic ones."""
        nd = self.n - self.nAE
        alg = (1.0 / (h * self.d)).expand(self.nAE, h.shape[0])
        return torch.cat([torch.ones_like(alg[:1]).expand(nd, -1), alg])

    # -- small helpers ------------------------------------------------------

    def _M_mul(self, z):
        if self.M is None:
            return z
        return self._c("M", z) @ z

    def _Sc_mul(self, h, v):
        """Scale the algebraic rows by 1/(h d) (extensisq common.py)."""
        if not self.isDAE:
            return v
        U = self._c("U", v)
        return U @ (self._sc(h) * (U.T @ v))

    def _factor(self, h, J):
        """LU of Sc (M - h d J), per member."""
        if self.M is None:
            A = torch.eye(self.n, dtype=J.dtype, device=J.device)
        else:
            A = self._c("M", J)
        W = A - (h * self.d)[:, None, None] * J
        if self.isDAE:
            U = self._c("U", J)
            W = U @ (self._sc(h).T[:, :, None] * (U.T @ W))
        LU, piv, _ = torch.linalg.lu_factor_ex(W)
        return LU, piv

    @staticmethod
    def _solve(LU, piv, b):
        return torch.linalg.lu_solve(LU, piv, b.T[:, :, None])[:, :, 0].T

    def _jac_dense(self):
        if self.jac is None:
            return lambda t, y: self._c("J_const", y).expand(
                y.shape[1], self.n, self.n)
        return self.jac

    # -- DAE consistent initial conditions ----------------------------------

    def consistent_ics(self, t0, y0, params):
        """Project ``y0`` onto the constraint manifold and compute a
        consistent derivative (extensisq common.py), by a fixed 10
        Newton iterations per member.  Returns (y, yp, J, h_start
        arguments of the reduced ODE)."""
        U, Vh, sv = (self._c(k, y0) for k in ("U", "Vh", "sv"))
        nd = self.n - self.nAE
        jac = self._jac_dense()

        def rows(A, v):              # per-member (B, p, q) @ (q, B)
            return (A @ v.T[:, :, None])[:, :, 0].T

        z0 = Vh @ y0
        u, v = z0[:nd], z0[nd:]
        for _ in range(10):
            y = Vh.T @ torch.cat([u, v])
            gv = (U.T @ self.fun(t0, y))[nd:]
            Gvv = (U.T @ jac(t0, y) @ Vh.T)[:, nd:, nd:]
            v = v - gauss_solve(Gvv, gv.T).T
        y = Vh.T @ torch.cat([u, v])
        f = self.fun(t0, y)
        J = jac(t0, y)

        # consistent derivative from df/dt and the constraint
        b = t0 + params.direction * torch.clamp(
            torch.abs(params.t_bound - t0), max=params.max_step)
        fdot = h_start(self.fun, t0, b, y, f, None, params.rtol,
                       params.atol, returnT=True)
        gdot = U.T @ fdot
        g = U.T @ f
        Gm = U.T @ J @ Vh.T
        Guu, Guv = Gm[:, :nd, :nd], Gm[:, :nd, nd:]
        Gvu, Gvv = Gm[:, nd:, :nd], Gm[:, nd:, nd:]
        udot = g[:nd] / sv[:nd, None]
        vdot = -gauss_solve(Gvv, (gdot[nd:] + rows(Gvu, udot)).T).T
        ydot = Vh.T @ torch.cat([udot, vdot])
        # reduced ODE data for h_start (extensisq common.py)
        S = Guv @ gauss_solve(Gvv, Gvu)
        Tr = (gdot[:nd] + rows(Guv, vdot)) / sv[:nd, None]
        Jr = (Guu + S) / sv[None, :nd, None]
        return y, ydot, J, {"y": u, "yprime": udot, "J": Jr, "T": Tr}

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        """Initial state for ``y0`` of shape ``(n, B)`` at time ``t0``."""
        nb = y0.shape[1]
        t0 = torch.as_tensor(t0, dtype=self.dtype,
                             device=y0.device).expand(nb).clone()
        njev = 0
        b = t0 + params.direction * torch.clamp(
            torch.abs(params.t_bound - t0), max=params.max_step)
        morder = min(self.tab.order_secondary, self.tab.order)
        if self.isDAE:
            y0, yp0, J, hs_kwargs = self.consistent_ics(t0, y0, params)
            njev += 1
            if first_step is None:
                h_abs = torch.abs(h_start(
                    self.fun, t0, b, morder=morder, rtol=params.rtol,
                    atol=params.atol, **hs_kwargs))
        else:
            f0 = self.fun(t0, y0)
            if self.M is None:
                yp0 = f0
                fun_ext = self.fun
            else:
                Mb = self._c("M", y0).expand(nb, self.n, self.n)
                yp0 = gauss_solve(Mb, f0.T).T
                fun_ext = lambda t, y: gauss_solve(   # noqa: E731
                    Mb, self.fun(t, y).T).T
            if self.linear:
                J = self._jac_dense()(t0, y0)
            else:
                J = self.jac(t0, y0)
                njev += 1
            if first_step is None:
                # the h_start evaluations are not counted (extensisq)
                h_abs = torch.abs(h_start(fun_ext, t0, b, y0, yp0, morder,
                                          params.rtol, params.atol))
        if first_step is not None:
            h_abs = torch.full_like(t0, float(first_step))

        i0 = torch.zeros(nb, dtype=torch.int32, device=y0.device)
        no = torch.zeros(nb, dtype=torch.bool, device=y0.device)
        return ESDIRKState(
            t=t0, y=y0, yp=yp0, h_abs=h_abs, status=i0 + RUNNING,
            standard_sc=~no, error_norm_old=torch.ones_like(t0),
            h_previous=torch.zeros_like(t0),
            max_factor=torch.full_like(t0, 10.0),
            J=J.contiguous(), current_J=~no,
            LU=torch.zeros_like(J), piv=torch.zeros_like(J[:, 0],
                                                       dtype=torch.int32),
            LU_valid=no, h_LU=torch.zeros_like(t0),
            Rate=torch.full_like(t0, -torch.inf), Niter=i0,
            K=torch.zeros((self.s,) + tuple(y0.shape), dtype=self.dtype,
                          device=y0.device),
            nfev=i0 + 1, njev=i0 + njev, nlu=i0, nls=i0, nfi=i0,
            nsteps=i0, nfailed=i0)

    # -- Newton stage solve --------------------------------------------------

    def _stage_newton(self, params, t_stage, z_predict, h, psi, y, LU, piv,
                      run):
        """Modified Newton for one stage on the members in ``run``.
        Returns (converged, z, rate, iterations); nfev and the linear
        solves equal the iterations.  Members outside ``run`` get the
        skipped stage's values (not converged, z = z_predict, rate -inf,
        0 iterations)."""
        i1 = run.to(torch.int32)
        if self.linear:
            # direct solve: one iteration
            f = self.fun(t_stage, psi + self.d * z_predict)
            res = h * f - self._M_mul(z_predict)
            z = z_predict + self._solve(LU, piv, self._Sc_mul(h, res))
            conv = run & torch.isfinite(f).all(0)
            return (conv, torch.where(run, z, z_predict),
                    torch.full_like(h, -torch.inf), i1)

        z = z_predict
        rate = torch.full_like(h, -torch.inf)
        dz_old = torch.zeros_like(h)
        converged = torch.zeros_like(run)
        stop = ~run
        k = torch.zeros_like(i1)
        kappa = self.kappa
        for it in range(NEWTON_MAXITER):
            active = ~stop
            if not bool(active.any()):
                break
            y_predict = psi + self.d * z
            f = self.fun(t_stage, y_predict)
            bad = ~torch.isfinite(f).all(0)
            res = h * f - self._M_mul(z)
            dz = self._solve(LU, piv, self._Sc_mul(h, res))
            scale = calculate_scale(params.atol, params.rtol, y, y_predict)
            dz_norm = norm(dz / scale)

            tiny_ok = dz_norm <= self.tiny_err
            if it == 0:
                rate_new = rate
                diverged = conv_normal = torch.zeros_like(run)
            else:
                ratio = dz_norm / torch.clamp(dz_old, min=1e-300)
                rate_new = torch.where((rate < 0) | (dz_old > kappa),
                                       torch.maximum(rate, ratio), rate)
                diverged = ((rate_new >= 1.0)
                            | (dz_norm * rate_new ** (NEWTON_MAXITER - it)
                               >= kappa * (1.0 - rate_new)))
                conv_normal = dz_norm * rate_new < kappa * (1.0 - rate_new)
            conv_it = (tiny_ok | (conv_normal & ~diverged)) & ~bad
            stop_it = bad | tiny_ok | diverged | conv_normal

            z = torch.where(active & ~bad, z + dz, z)
            rate = torch.where(active, rate_new, rate)
            dz_old = torch.where(active, dz_norm, dz_old)
            converged = torch.where(active, conv_it, converged)
            stop = stop | (active & stop_it)
            k = k + active.to(torch.int32)
        return converged, z, rate, k

    # -- one step ------------------------------------------------------------

    def reassess_stepsize(self, params, t, h_abs, standard_sc):
        """Step-size limits and the landing on t_bound."""
        min_step = torch.clamp(self.h_min_a * (torch.abs(t) + h_abs),
                               min=self.h_min_b)
        out = (h_abs < min_step) | (h_abs > params.max_step)
        h_abs = torch.clamp(torch.maximum(min_step, h_abs),
                            max=params.max_step)
        standard_sc = standard_sc | out
        d = torch.abs(params.t_bound - t)
        h_abs = torch.where((torch.abs(d / h_abs - 1.0) < 1e-2) | (d < h_abs),
                            d, h_abs)
        return h_abs, min_step, standard_sc

    def _refresh_jac(self, want, t, y, J, njev):
        """A fresh Jacobian for the members in ``want``; returns (J,
        njev)."""
        if self.jac is not None and bool(want.any()):
            J = torch.where(want[:, None, None], self.jac(t, y), J)
        return J, njev + want.to(torch.int32)

    def _preamble(self, params, t, y, state, h_abs, gate):
        """Preemptive J/LU refresh, once per step, for the members in
        ``gate`` (extensisq common.py)."""
        LU_valid = state.LU_valid
        if self.jac_each_step and not self.linear:
            want = gate & ~state.current_J
            J, njev = self._refresh_jac(want, t, y, state.J, state.njev)
            return J, state.current_J | want, LU_valid & ~gate, njev
        h = h_abs * params.direction
        h_prev = torch.where(state.h_previous == 0.0, h, state.h_previous)
        h_LU = torch.where(state.h_LU == 0.0, h, state.h_LU)
        rate_predict = state.Rate * (h / h_prev)
        rate_predict_LU = torch.abs(h / h_LU - 1.0)
        has_rate = gate & (state.Rate > 0.0)
        want_jac = (has_rate & (state.Niter > 2)
                    & (rate_predict - rate_predict_LU > MAX_RATE))
        if self.linear:
            want_jac = torch.zeros_like(want_jac)
        J, njev = self._refresh_jac(want_jac, t, y, state.J, state.njev)
        want_lu = has_rate & (want_jac | (rate_predict_LU > MAX_RATE))
        return J, state.current_J | want_jac, LU_valid & ~want_lu, njev

    def _attempt(self, params, t, y, yp, error_norm_old, h_previous, c,
                 gate):
        """One step attempt for the members in ``gate`` (the body of
        extensisq's accept/reject loop)."""
        h = c.h_abs * params.direction

        # (re)factor the LU where needed
        need_lu = ~c.LU_valid | self.jac_each_step
        if self.linear:
            need_lu = need_lu | (h != c.h_LU)
        need_lu = need_lu & gate
        LU, piv, nlu, h_LU = c.LU, c.piv, c.nlu, c.h_LU
        if bool(need_lu.any()):
            LU_f, piv_f = self._factor(h, c.J)
            LU = torch.where(need_lu[:, None, None], LU_f, LU)
            piv = torch.where(need_lu[:, None], piv_f, piv)
            nlu = nlu + need_lu.to(torch.int32)
            h_LU = torch.where(need_lu, h, h_LU)

        # stages; a stage after a failed one is skipped
        ok = gate
        Rate = torch.full_like(h, -torch.inf)
        Niter = torch.zeros_like(c.nfev)
        nfev, nls = c.nfev, c.nls
        psi_last = y
        z_last = torch.zeros_like(y)
        K_rows = [yp]
        K = [yp]
        for s in range(1, self.s):
            t_stage = t + float(self.C[s]) * h
            psi = y + h * weighted_sum(K_rows, self.A[s, :s])
            z_pred = h * weighted_sum(K_rows, self.Az[s, :s])
            conv, z, rate, niter = self._stage_newton(
                params, t_stage, z_pred, h, psi, y, LU, piv, ok)
            nfev = nfev + niter
            nls = nls + niter
            Rate = torch.maximum(Rate, rate)
            Niter = torch.maximum(Niter, niter)
            Kz = z / h
            K.append(torch.where(conv, Kz, c.K[s]))
            K_rows.append(torch.where(conv, Kz, 0.0))
            psi_last = torch.where(ok, psi, psi_last)
            z_last = torch.where(conv, z, z_last)
            ok = conv
        converged = ok
        K = torch.stack(K)

        # Newton failure ladder: a fresh Jacobian first, then a smaller h
        nfi = c.nfi + (gate & ~converged).to(torch.int32)
        retry = gate & ~converged & ~c.current_J
        if self.linear:
            retry = torch.zeros_like(retry)
        J2, njev2 = self._refresh_jac(retry, t, y, c.J, c.njev)
        factor_nrf = torch.clamp(
            torch.where(Rate > 0.0, MAX_RATE / torch.clamp(Rate, min=1e-300),
                        MIN_FACTOR), MIN_FACTOR, MAX_FACTOR_NRF)
        h_abs_fail = torch.where(retry, c.h_abs, c.h_abs * factor_nrf)

        # solution and error estimate
        y_new = psi_last + self.d * z_last
        scale = calculate_scale(params.atol, params.rtol, y, y_new)
        err = h * weighted_sum(list(K), self.E)
        if self.filter_error:
            err = self._M_mul(self._solve(LU, piv, self._Sc_mul(h, err)))
            # extensisq skips the filter solve after a Newton failure
            nls = nls + converged.to(torch.int32)
        error_norm = norm(err / scale)

        h_ratio = h / torch.where(h_previous == 0.0, h, h_previous)
        facc, sc_acc, mf_acc = esdirk_accept_update(
            self.cc, self.tiny_err, error_norm, error_norm_old, h_ratio,
            c.rejected, c.standard_sc, c.max_factor)
        frej = reject_factor(self.cc, error_norm)

        accepted = converged & (error_norm < 1.0)
        err_rejected = converged & ~accepted
        bad = converged & ~torch.isfinite(error_norm)
        # a convergence failure invalidates the LU and resets the
        # controller; an error rejection resets the controller mode; a
        # retry with a fresh Jacobian is not a rejection
        return _ECarry(
            h_abs=torch.where(converged,
                              c.h_abs * torch.where(accepted, facc, frej),
                              h_abs_fail),
            h_used=torch.where(accepted, h, c.h_used),
            accepted=accepted,
            rejected=c.rejected | err_rejected | (~converged & ~retry),
            status=torch.where(bad, OVERFLOW, c.status).to(torch.int32),
            standard_sc=torch.where(
                accepted, sc_acc, torch.where(retry, c.standard_sc, True)),
            max_factor=torch.where(accepted, mf_acc, c.max_factor),
            J=J2, current_J=c.current_J | retry,
            LU=LU, piv=piv,
            LU_valid=converged & (need_lu | c.LU_valid), h_LU=h_LU,
            Rate=Rate, Niter=Niter,
            y_new=torch.where(accepted, y_new, c.y_new),
            error_norm=torch.where(accepted, error_norm, c.error_norm),
            K=torch.where(accepted, K, c.K),
            nfev=nfev, njev=njev2, nlu=nlu, nls=nls, nfi=nfi,
            nfailed=c.nfailed + err_rejected.to(torch.int32))

    # -- flat (attempt-level) stepping for the batched solve loop ------------

    def flat_init_aux(self, state):
        """Auxiliary carry for attempt-level looping: (fresh, min_step,
        rejected_this_step)."""
        ones = torch.ones_like(state.standard_sc)
        return (ones, torch.zeros_like(state.t), ~ones)

    def step_flat(self, params, state, aux):
        """Exactly ONE step attempt per member; a member's state advances
        where its attempt is accepted.  Per-step work (step-size
        reassessment, the preemptive J/LU refresh) runs on fresh steps
        only.  Returns (state', aux', accepted)."""
        fresh, min_step_c, rejected = aux
        t, y, yp = state.t, state.y, state.yp

        h_abs_r, min_step_r, sc_r = self.reassess_stepsize(
            params, t, state.h_abs, state.standard_sc)
        h_abs = torch.where(fresh, h_abs_r, state.h_abs)
        min_step = torch.where(fresh, min_step_r, min_step_c)
        standard_sc = torch.where(fresh, sc_r, state.standard_sc)

        J, current_J, LU_valid, njev = self._preamble(
            params, t, y, state, h_abs, fresh)

        too_small = h_abs < min_step
        status0 = torch.where(too_small & (state.status == RUNNING),
                              TOO_SMALL_STEP, state.status).to(torch.int32)
        c = _ECarry(
            h_abs=h_abs, h_used=torch.zeros_like(state.h_previous),
            accepted=torch.zeros_like(fresh), rejected=rejected,
            status=status0, standard_sc=standard_sc,
            max_factor=state.max_factor,
            J=J, current_J=current_J, LU=state.LU, piv=state.piv,
            LU_valid=LU_valid, h_LU=state.h_LU,
            Rate=state.Rate, Niter=state.Niter,
            y_new=y, error_norm=state.error_norm_old, K=state.K,
            nfev=state.nfev, njev=njev, nlu=state.nlu, nls=state.nls,
            nfi=state.nfi, nfailed=state.nfailed)
        gate = status0 == RUNNING
        c = select(gate, self._attempt(params, t, y, yp,
                                       state.error_norm_old,
                                       state.h_previous, c, gate), c)
        ok = c.accepted

        d = torch.abs(params.t_bound - t)
        is_last = ok & (torch.abs(c.h_used) >= d)
        t_new = torch.where(is_last, params.t_bound, t + c.h_used)
        status = torch.where((c.status == RUNNING) & is_last, FINISHED,
                             c.status).to(torch.int32)

        new_state = ESDIRKState(
            t=torch.where(ok, t_new, state.t),
            y=torch.where(ok, c.y_new, state.y),
            yp=torch.where(ok, c.K[-1], state.yp),
            h_abs=c.h_abs, status=status,
            standard_sc=c.standard_sc,
            error_norm_old=torch.where(ok, c.error_norm,
                                       state.error_norm_old),
            h_previous=torch.where(ok, c.h_used, state.h_previous),
            max_factor=c.max_factor,
            J=c.J,
            # J is stale at the next step unless constant
            current_J=(c.current_J | ok if self.linear
                       else c.current_J & ~ok),
            LU=c.LU, piv=c.piv, LU_valid=c.LU_valid, h_LU=c.h_LU,
            Rate=c.Rate, Niter=c.Niter,
            K=torch.where(ok, c.K, state.K),
            nfev=c.nfev, njev=c.njev, nlu=c.nlu, nls=c.nls, nfi=c.nfi,
            nsteps=state.nsteps + ok.to(torch.int32),
            nfailed=c.nfailed)
        aux_new = (ok | (status != RUNNING), min_step, c.rejected & ~ok)
        return new_state, aux_new, ok

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
