"""SSV2stab: stabilized second-order Runge-Kutta-Chebyshev stepper, batched
over members.

Counterpart of ``extensisq_tpu/steppers/rkc.py`` (the netlib rkc.f
translation).  State is rows-first, members last: per-member scalars are
``(B,)`` and the state ``(n, B)``.  Where the JAX stepper runs a
data-dependent loop per member under ``vmap`` (the Chebyshev stages, m of
them; the nonlinear power iteration for the spectral radius), this one
loops to the largest trip count of the running members and keeps each
member's carry once its own loop has ended, so ``nfev`` and ``nfesig``
count exactly what the JAX stepper counts.  Both dtypes run: float64 for
the driver, float32 for tests of the fused kernels' arithmetic.

Dense output (``record_coefficients``, ``dense_segments``) comes with
ROADMAP A4b, and with it the last accepted step's (t, y, f) that the JAX
state carries for it.
"""
from typing import Any, NamedTuple

import numpy as np
import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW, RHO_FAIL
from ..core.numerics import calculate_scale, norm, dtype_constants
from .erk import select

ITMAX = 50               # power-iteration bound (sommeijer.py:331-398)


class RKCState(NamedTuple):
    t: Any
    y: Any                 # yn
    f: Any                 # fn = fun(t, yn)
    h_abs: Any             # negative sentinel = "not yet initialized"
    status: Any
    sprad: Any
    V: Any                 # eigenvector warm start for the power method
    newspc: Any            # bool: re-estimate spectral radius
    jacatt: Any            # bool: current spectral radius is up to date
    h_previous: Any        # previous signed h (0 = none)
    errold: Any
    nstsig: Any            # steps since last rho refresh (mod 25)
    mlim: Any              # consecutive steps at the m cap
    # counters
    nfev: Any
    nfesig: Any
    nsteps: Any
    nfailed: Any
    maxm: Any
    # derived limits (computed at init from t0/t_bound)
    max_step_eff: Any
    hmin0: Any


def _sumsq(x):
    """Per-member sum of squares over the state rows: ``(n, B) -> (B,)``."""
    return (x * x).sum(0)


class RKCStepper:
    """init/step functions of SSV2stab for one right-hand side.

    ``fun(t, y)`` takes ``t`` of shape ``(B,)`` and ``y`` of shape
    ``(n, B)``.  Options: ``rho_jac(t, y)``, a spectral-radius bound (a
    float or a ``(B,)`` tensor) that replaces the power iteration, and
    ``const_jac``, which keeps the first estimate for the whole run.
    """
    family = "rkc"

    def __init__(self, fun, n, dtype, options=None):
        self.fun = fun
        self.n = n
        if dtype.is_complex:
            raise ValueError("SSV2stab does not support complex problems.")
        self.dtype = dtype
        self.real_dtype = dtype
        consts = dtype_constants(dtype)
        self.uround = consts["uround"]
        self.sqrtu = float(np.sqrt(self.uround))
        self.sqrtmin = consts["sqrt_tiny"]
        self.sqrtmax = consts["big"]
        opts = dict(options or {})
        self.const_jac = bool(opts.pop("const_jac", False))
        self.rho_jac = opts.pop("rho_jac", None)
        self.options = opts

    # -- spectral radius ----------------------------------------------------

    def _rho(self, t, yn, fn, V, max_step_eff, active):
        """Nonlinear power iteration (sommeijer.py:331-398) for the members
        in ``active``; the others run no iteration.

        Returns (sprad, V_new, n_evals, converged); inactive members get
        sprad 0, V, 0 and True.
        """
        small = 1.0 / max_step_eff
        ynrm = torch.sqrt(_sumsq(yn))
        vnrm = torch.sqrt(_sumsq(V))

        both = (ynrm != 0.0) & (vnrm != 0.0)
        only_y = (ynrm != 0.0) & (vnrm == 0.0)
        only_v = (ynrm == 0.0) & (vnrm != 0.0)
        dynrm = torch.where(both | only_y, ynrm * self.sqrtu,
                            torch.full_like(ynrm, self.uround))
        vsafe = torch.where(vnrm == 0, 1.0, vnrm)
        v = torch.where(
            both, yn + V * (dynrm / vsafe),
            torch.where(only_y, V * (1.0 + self.sqrtu),
                        torch.where(only_v, V * (dynrm / vsafe),
                                    dynrm.expand_as(V))))

        sigma = torch.zeros_like(ynrm)
        sprad = torch.zeros_like(ynrm)
        done = ~active
        nev = torch.zeros(ynrm.shape, dtype=torch.int32, device=yn.device)
        for i in range(ITMAX):
            if bool(done.all()):
                break
            live = ~done
            fv = self.fun(t, v)
            nev = nev + live.to(torch.int32)
            df = fv - fn
            dfnrm = torch.sqrt(_sumsq(df))
            sigma_new = dfnrm / dynrm
            conv = (i > 0) & (torch.abs(sigma_new - sigma)
                              <= torch.maximum(sigma_new, small) * 0.01)
            # next iterate: change in f scaled to dynrm, or a sign flip
            # of one component in the degenerate case
            v_deg = v.clone()
            v_deg[i % self.n] = -v_deg[i % self.n]
            v_next = torch.where(
                dfnrm != 0.0,
                yn + df * (dynrm / torch.where(dfnrm == 0.0, 1.0, dfnrm)),
                v_deg)
            v = torch.where(live & ~conv, v_next, v)
            sigma = torch.where(live, sigma_new, sigma)
            sprad = torch.where(live & conv, 1.2 * sigma_new, sprad)
            done = done | (live & conv)
        ok = done | ~active
        V_new = torch.where(active & done, v - yn, V)
        return sprad, V_new, nev, ok

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        """Initial state for ``y0`` of shape ``(n, B)`` at time ``t0`` (a
        float or a ``(B,)`` tensor): one RHS evaluation."""
        B = y0.shape[1]
        dev = y0.device
        t0 = torch.as_tensor(t0, dtype=self.dtype,
                             device=dev).expand(B).clone()
        f0 = self.fun(t0, y0)

        max_step_eff = torch.clamp(torch.clamp(
            torch.abs(params.t_bound - t0), max=params.max_step),
            max=self.sqrtmax)
        hmin = torch.maximum(torch.abs(t0), torch.abs(max_step_eff))
        hmin0 = torch.clamp(10.0 * self.uround * hmin, min=self.sqrtmin)

        h_abs = torch.full_like(t0, -1.0 if first_step is None
                                else float(first_step))
        z = torch.zeros_like(t0)
        i0 = torch.zeros(B, dtype=torch.int32, device=dev)
        b0 = torch.zeros(B, dtype=torch.bool, device=dev)
        return RKCState(
            t=t0, y=y0, f=f0, h_abs=h_abs, status=i0 + RUNNING,
            sprad=z, V=f0 * 1.0, newspc=~b0, jacatt=b0, h_previous=z,
            errold=z + 1.0, nstsig=i0, mlim=i0,
            nfev=i0 + 1, nfesig=i0, nsteps=i0, nfailed=i0, maxm=i0,
            max_step_eff=max_step_eff, hmin0=hmin0)

    # -- stages (sommeijer.py:273-329) ----------------------------------------

    def _stages(self, t, yn, fn, h, m, m_top):
        """The Chebyshev recurrence with each member's own stage count m
        (B,); the loop runs to ``m_top`` and a member keeps its carry past
        its own m.  Returns (y_m, m - 1 evaluations per member)."""
        mf = m.to(self.dtype)
        w0 = 1.0 + 2.0 / (13.0 * mf * mf)
        temp1 = w0 * w0 - 1.0
        temp2 = torch.sqrt(temp1)
        arg = mf * torch.log(w0 + temp2)
        sinh_a, cosh_a = torch.sinh(arg), torch.cosh(arg)
        w1 = sinh_a * temp1 / (cosh_a * mf * temp2 - w0 * sinh_a)
        tw = 2.0 * w0
        bj0 = 1.0 / (tw * tw)

        mus0 = w1 * bj0
        yjm2, yjm1, y = yn, yn + h * mus0 * fn, yn
        thjm2, thjm1 = torch.zeros_like(mus0), mus0
        zjm2, zjm1 = torch.ones_like(w0), w0
        dzjm2, dzjm1 = torch.zeros_like(w0), torch.ones_like(w0)
        d2zjm2, d2zjm1 = torch.zeros_like(w0), torch.zeros_like(w0)
        bjm2, bjm1 = bj0, bj0

        for j in range(2, m_top + 1):
            act = j <= m
            zj = 2.0 * w0 * zjm1 - zjm2
            dzj = 2.0 * w0 * dzjm1 - dzjm2 + 2.0 * zjm1
            d2zj = 2.0 * w0 * d2zjm1 - d2zjm2 + 4.0 * dzjm1
            bj = d2zj / (dzj * dzj)
            ajm1 = 1.0 - zjm1 * bjm1
            mu = 2.0 * w0 * bj / bjm1
            nu = -bj / bjm2
            mus = mu * w1 / w0

            fj = self.fun(t + h * thjm1, yjm1)
            yj = (mu * yjm1 + nu * yjm2
                  + (1.0 - mu - nu) * yn + h * mus * (fj - ajm1 * fn))
            thj = mu * thjm1 + nu * thjm2 + mus * (1.0 - ajm1)

            yjm2, yjm1, y = (torch.where(act, yjm1, yjm2),
                             torch.where(act, yj, yjm1),
                             torch.where(act, yj, y))
            thjm2, thjm1 = (torch.where(act, thjm1, thjm2),
                            torch.where(act, thj, thjm1))
            zjm2, zjm1 = torch.where(act, zjm1, zjm2), torch.where(act, zj,
                                                                   zjm1)
            dzjm2, dzjm1 = (torch.where(act, dzjm1, dzjm2),
                            torch.where(act, dzj, dzjm1))
            d2zjm2, d2zjm1 = (torch.where(act, d2zjm1, d2zjm2),
                              torch.where(act, d2zj, d2zjm1))
            bjm2, bjm1 = torch.where(act, bjm1, bjm2), torch.where(act, bj,
                                                                   bjm1)
        return y, m - 1

    # -- one attempt ---------------------------------------------------------

    def flat_init_aux(self, state):
        return ()

    def step_flat(self, params, state, aux):
        """Exactly ONE step attempt per member (the state advances where it
        is accepted), as the JAX ``step_flat``; members not RUNNING take
        part in no loop.  Returns (state', aux, accepted)."""
        t, yn, fn = state.t, state.y, state.f
        running = state.status == RUNNING

        # spectral-radius refresh (sommeijer.py:174-189)
        if self.rho_jac is not None:
            r = torch.as_tensor(self.rho_jac(t, yn), dtype=self.dtype,
                                device=t.device).expand_as(t)
            sprad = torch.where(state.newspc, r, state.sprad)
            V, nfesig = state.V, state.nfesig
            rho_ok = torch.ones_like(running)
        else:
            active = state.newspc & running
            sp, V, nev, rho_ok = self._rho(t, yn, fn, state.V,
                                           state.max_step_eff, active)
            sprad = torch.where(active, sp, state.sprad)
            nfesig = state.nfesig + nev
        jacatt = state.newspc | state.jacatt
        status = torch.where(rho_ok, state.status, RHO_FAIL)

        # initial step size on the very first attempt
        need = (state.h_abs < 0.0) & running
        absh = state.h_abs
        if bool(need.any()):
            mse = state.max_step_eff
            absh0 = torch.where(sprad * mse > 1.0, 1.0 / sprad, mse)
            absh0 = torch.maximum(absh0, state.hmin0)
            vtemp1 = yn + absh0 * fn
            vtemp2 = self.fun(t + absh0, vtemp1)
            wt = params.atol + params.rtol * torch.abs(yn)
            est = absh0 * norm((vtemp2 - fn) / wt)
            absh1 = torch.where(
                0.1 * absh0 < mse * torch.sqrt(est),
                torch.maximum(0.1 * absh0 / torch.sqrt(est), state.hmin0),
                mse)
            absh = torch.where(need, absh1, absh)
        nfev = state.nfev + need.to(torch.int32)

        # stage count and the m cap (sommeijer.py:190-204)
        d = torch.abs(params.t_bound - t)
        absh = torch.where(1.1 * absh >= d, d, absh)
        m = 1 + torch.sqrt(1.54 * absh * sprad + 1.0).to(torch.int32)
        mmax = int(torch.clamp(torch.round(torch.sqrt(
            torch.tensor(params.rtol, dtype=self.dtype)
            / (10.0 * self.uround))), min=2.0))
        hit_cap = m > mmax
        m = torch.where(hit_cap, mmax, m).to(torch.int32)
        mf = m.to(self.dtype)
        absh = torch.where(hit_cap, (mf * mf - 1.0) / (1.54 * sprad), absh)
        mlim = torch.where(hit_cap, state.mlim + 1, 0).to(torch.int32)

        h = params.direction * absh
        hmin = torch.clamp(
            13.3 * self.uround * (torch.abs(t) + absh) * (mf * mf - 1.0),
            min=self.sqrtmin)

        m_top = int(m[running].max()) if bool(running.any()) else 1
        y, n_st = self._stages(t, yn, fn, h, m, m_top)
        f_new = self.fun(t + h, y)
        nfev = nfev + n_st + 1

        wt = calculate_scale(params.atol, params.rtol, y, yn)
        est = 0.8 * (yn - y) + 0.4 * h * (fn + f_new)
        err = norm(est / wt)

        accepted = err < 1.0
        bad = torch.isnan(err) | torch.isinf(err)
        absh_rej = 0.8 * absh / torch.clamp(err, min=1e-300) ** (1.0 / 3.0)
        too_small = ~accepted & (absh_rej < hmin)
        status = torch.where(
            bad, OVERFLOW,
            torch.where(too_small & (status == RUNNING), TOO_SMALL_STEP,
                        status))
        ok = accepted & ~bad

        is_last = ok & (absh >= d)
        t_new = torch.where(is_last, params.t_bound, t + h)
        status = torch.where((status == RUNNING) & is_last, FINISHED,
                             status).to(torch.int32)

        # post-acceptance bookkeeping (sommeijer.py:238-266)
        nstsig = torch.where(ok, torch.remainder(state.nstsig + 1, 25),
                             state.nstsig).to(torch.int32)
        refresh = (self.rho_jac is not None) | (nstsig == 0)
        newspc = torch.where(ok, refresh & (not self.const_jac), ~jacatt)

        # H220 dead-beat controller for the next step size
        t2_first = torch.clamp(err, min=1e-300) ** (1.0 / 3.0)
        fac_first = torch.where(0.8 < 10.0 * t2_first, 0.8 / t2_first, 10.0)
        temp1 = 0.8 * absh * torch.clamp(state.errold,
                                         min=1e-300) ** (1.0 / 3.0)
        temp2 = torch.abs(state.h_previous) * torch.clamp(
            err, min=1e-300) ** (2.0 / 3.0)
        fac_next = torch.where(temp1 < 10.0 * temp2,
                               temp1 / torch.clamp(temp2, min=1e-300), 10.0)
        fac = torch.where(state.h_previous == 0.0, fac_first, fac_next)
        absh_acc = torch.clamp(fac, min=0.1) * absh
        absh_acc = torch.maximum(hmin, torch.minimum(state.max_step_eff,
                                                     absh_acc))

        new_state = RKCState(
            t=torch.where(ok, t_new, t),
            y=torch.where(ok, y, yn),
            f=torch.where(ok, f_new, fn),
            h_abs=torch.where(ok, absh_acc, absh_rej),
            status=status,
            sprad=sprad, V=V,
            newspc=newspc,
            jacatt=torch.where(ok, self.const_jac, jacatt),
            h_previous=torch.where(ok, h, state.h_previous),
            errold=torch.where(ok, err, state.errold),
            nstsig=nstsig,
            mlim=mlim,
            nfev=nfev.to(torch.int32), nfesig=nfesig.to(torch.int32),
            nsteps=state.nsteps + ok.to(torch.int32),
            nfailed=state.nfailed + (~ok).to(torch.int32),
            # maxm counts rejected attempts too (sommeijer.py:204)
            maxm=torch.maximum(state.maxm, m),
            max_step_eff=state.max_step_eff, hmin0=state.hmin0)
        return new_state, aux, ok

    def step(self, params, state):
        """One accepted step per RUNNING member: its attempts repeat until
        one is accepted or its status changes (the JAX ``step``'s nested
        accept/reject loop, with the same arithmetic as ``step_flat``)."""
        start = state.nsteps
        while True:
            pending = (state.nsteps == start) & (state.status == RUNNING)
            if not bool(pending.any()):
                return state
            new, _, _ = self.step_flat(params, state, ())
            state = select(pending, new, state)

    # -- dense output --------------------------------------------------------

    def record_coefficients(self, state):
        raise NotImplementedError("SSV2stab dense output is not ported yet: "
                                  "ROADMAP A4b")

    def dense_segments(self, state, interpolant=None):
        raise NotImplementedError("SSV2stab dense output is not ported yet: "
                                  "ROADMAP A4b")
