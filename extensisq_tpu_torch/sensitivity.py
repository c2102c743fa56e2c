"""Sensitivity analysis: forward, adjoint at the endpoint, adjoint of an
integral, and a whole solve under ``torch.autograd``.

Counterpart of ``extensisq_tpu/sensitivity.py``.  The user derivatives
``jac``/``dfdp``/``dgdy``/``dgdp`` are optional: without them

* the forward sensitivities' augmented RHS takes ``J s_i + df/dp_i`` from
  one ``torch.func.jvp`` per parameter, with no Jacobian formed;
* the adjoint solves take ``-J^T mu`` and ``(df/dp)^T mu`` from one
  ``torch.func.vjp`` per RHS evaluation.

``sens_forward``, ``sens_adjoint_end`` and ``sens_adjoint_int`` run on the
host driver (:func:`~extensisq_tpu_torch.ivp.solve_ivp`), with its
conventions: ``fun(t, y, *p)`` gets a 0-d tensor ``t``, a 1-D tensor ``y``
on ``y0``'s device and each parameter as a 0-d tensor there; ``g(t, y,
*p)`` likewise.  They run on the card for a numpy or list ``y0`` and on
the CPU for a CPU tensor.  The adjoints' backward RHS evaluates the
forward solution on the device, from the forward solve's
:class:`~extensisq_tpu_torch.core.interpolate.OdeSolution`.

:func:`solve_final` is ``y(t_f)`` of the device driver
(:func:`~extensisq_tpu_torch.solve.solve`) as a ``torch.autograd.Function``
whose backward pass integrates the continuous adjoint against the
recorded steps; with a leading member axis on ``y0`` and ``p`` it is the
same function over a batch (:func:`~extensisq_tpu_torch.solve.
solve_ensemble`).
"""
from collections import namedtuple
import warnings

import numpy as np
import torch

from ._device import as_input
from .core.interpolate import horner

SensitivityOutput = namedtuple("ForwardSensitivityOutput",
                               "sensf yf sol")
AdjointSensitivityOutputEnd = namedtuple("AdjointSensitivityOutput",
                                         "sens gf sol_y sol_bw")
AdjointSensitivityOutputInt = namedtuple("AdjointSensitivityOutput",
                                         "sens G sol_y sol_bw")


def _embed(f, p):
    """close over the parameter vector: f(t, y, *p) -> f(t, y)"""
    if f is None:
        return None
    return lambda t, y: f(t, y, *p)


def _setup(y0, p, dy0dp):
    """``y0`` and ``p`` as float64 tensors on ``y0``'s device (the card for
    numpy and lists), and ``dy0dp`` as numpy."""
    y0 = torch.atleast_1d(as_input(y0).to(torch.float64))
    if not isinstance(p, torch.Tensor):
        p = torch.as_tensor(np.asarray([float(x) for x in np.ravel(
            np.asarray(p, dtype=object))]))
    p = torch.atleast_1d(p.to(dtype=torch.float64, device=y0.device))
    Ny, Np = y0.numel(), p.numel()
    if dy0dp is None:
        dy0dp = np.zeros((Ny, Np))
    return y0, p, np.asarray(dy0dp, dtype=float), Ny, Np


def _method(method):
    if method is None:
        from .methods import BS5 as method
    if isinstance(method, str):
        from .methods import METHODS_BY_NAME
        method = METHODS_BY_NAME[method]
    return method


def _as(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def sens_forward(fun, t_span, y0, jac=None, dfdp=None, dy0dp=None, p=(),
                 atol=1e-6, rtol=1e-3, method=None, dense_output=False,
                 t_eval=None, use_approx_jac=False):
    """Forward (internal-differentiation) sensitivities dy/dp.

    The augmented system of size ny (np + 1) is integrated in one host
    solve; ``jac``/``dfdp`` may be None (one JVP per parameter).  With an
    implicit method the augmented Newton Jacobian is by default the exact
    one, evaluated through its block sparsity (colored forward AD, 2 ny
    tangents whatever np); ``use_approx_jac=True`` supplies the block
    diagonal diag(J, ..., J) of one base Jacobian instead.  Explicit
    methods ignore the flag (warned).
    """
    from .ivp import solve_ivp
    from .types import Method
    method = _method(method)
    y0, p, dy0dp, Ny, Np = _setup(y0, p, dy0dp)
    if dy0dp.shape != (Ny, Np):
        raise ValueError("`dy0dp` should be an array of shape (ny, np)")
    t0, tf = t_span
    if t_eval is not None and t_eval[-1] != tf:
        raise ValueError(
            "if `t_eval` is used, the last point should be t_span[-1]")

    fun_p = lambda t, y, pp: _as(fun(t, y, *pp), y)      # noqa: E731
    jac_e = _embed(jac, tuple(p))
    dfdp_e = _embed(dfdp, tuple(p))

    if jac_e is not None and dfdp_e is not None:
        def sens_rhs(t, y, s):
            # s: (Np, Ny) rows = per-parameter sensitivities
            J = _as(jac_e(t, y), y)
            D = _as(dfdp_e(t, y), y)                     # (Ny, Np)
            return s @ J.T + D.T
    else:
        eye = torch.eye(Np, dtype=p.dtype, device=p.device)

        def sens_rhs(t, y, s):
            return torch.stack([
                torch.func.jvp(lambda yy, pp: fun_p(t, yy, pp), (y, p),
                               (s[i], eye[i]))[1] for i in range(Np)])

    def total_fun(t, z):
        y = z[:Ny]
        s = z[Ny:].reshape(Np, Ny)
        dy = fun_p(t, y, p)
        ds = sens_rhs(t, y, s)
        return torch.cat([dy, ds.reshape(-1)])

    # per-parameter absolute tolerance scaling
    total_atol = np.empty((Np + 1) * Ny)
    total_atol[:Ny] = atol
    p_np = p.cpu().numpy()
    for i in range(Np):
        factor = abs(p_np[i]) or 1.0
        total_atol[(i + 1) * Ny:(i + 2) * Ny] = atol / factor

    # the augmented system's Newton Jacobian for implicit methods
    extra = {}
    if isinstance(method, Method) and method.family == "esdirk":
        m = (Np + 1) * Ny
        if use_approx_jac:
            if jac_e is not None:
                base_jac = jac_e
            else:
                def base_jac(t, y):
                    return torch.func.jacfwd(
                        lambda yy: fun_p(t, yy, p))(y)

            def total_jac(t, z):
                J = _as(base_jac(t, z[:Ny]), z)
                return torch.block_diag(*([J] * (Np + 1)))

            extra["jac"] = total_jac
        else:
            # exact block pattern: every block row depends on y, and
            # sensitivity block i on itself; colored AD needs only
            # 2 ny tangents for it, independent of np
            S = np.zeros((m, m), dtype=int)
            S[:, :Ny] = 1
            for i in range(Np):
                S[(i + 1) * Ny:(i + 2) * Ny,
                  (i + 1) * Ny:(i + 2) * Ny] = 1
            extra["jac_sparsity"] = S
    elif use_approx_jac:
        warnings.warn("use_approx_jac has no effect for explicit "
                      "methods", stacklevel=2)

    z0 = torch.cat([y0, _as(dy0dp.T.reshape(-1), y0)])
    sol = solve_ivp(total_fun, t_span, z0, atol=total_atol, rtol=rtol,
                    method=method, dense_output=dense_output,
                    t_eval=t_eval, **extra)
    if not sol.success:
        raise RuntimeError("IVP solver not converged")
    yf = sol.y[:Ny, -1]
    sensf = sol.y[Ny:, -1].reshape(Np, Ny).T
    return SensitivityOutput(sensf, yf, sol)


def _g_derivatives(g, dgdy, dgdp, p):
    gp = lambda t, y, pp: g(t, y, *pp).reshape(())         # noqa: E731
    if dgdy is None:
        dgdy_e = lambda t, y: torch.func.grad(                # noqa: E731
            gp, argnums=1)(t, y, p)
    else:
        dgdy_e = _embed(dgdy, tuple(p))
    if dgdp is None:
        dgdp_e = lambda t, y: torch.func.grad(                # noqa: E731
            gp, argnums=2)(t, y, p)
    else:
        dgdp_e = _embed(dgdp, tuple(p))
    return gp, dgdy_e, dgdp_e


def _vjp_terms(fun_p, t, y, p, mu):
    """(J^T mu, dfdp^T mu) in one vjp call."""
    _, pullback = torch.func.vjp(lambda yy, pp: fun_p(t, yy, pp), y, p)
    JTmu, DTmu = pullback(mu)
    return JTmu, DTmu


def _evaluator(sol):
    """``y(t)`` ``(n,)`` of an :class:`OdeSolution` at a 0-d tensor ``t``,
    on the solution's device without a host sync (the direction is read
    once, here)."""
    ts = sol.ts
    sgn = 1.0 if float(ts[-1]) >= float(ts[0]) else -1.0
    inner = (sgn * ts[1:-1]).contiguous()
    last = sol.h.shape[0] - 1

    def interp(t):
        tq = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        idx = torch.searchsorted(inner, (sgn * tq).reshape(1),
                                 side="left").clamp(0, last)[0]
        u = (tq - sol.t_anchor[idx]) / sol.h[idx]
        return horner(u, sol.Q[idx], sol.y_anchor[idx])
    return interp


def _forward_y(fun_p, t_span, y0, p, method, atol, rtol, sol_y):
    from .ivp import solve_ivp
    if sol_y is None:
        sol_y = solve_ivp(lambda t, y: fun_p(t, y, p), t_span, y0,
                          method=method, atol=atol, rtol=rtol,
                          dense_output=True)
        if not sol_y.success:
            raise RuntimeError(
                "IVP solver not converged in forward solve of y")
    if sol_y.sol is None:
        raise ValueError("sol_y should have a dense output")
    sol = sol_y.sol
    if sol.ts.device != y0.device:
        sol = type(sol)(*(x.to(y0.device) for x in sol))
    return sol_y, _evaluator(sol)


def sens_adjoint_end(fun, t_span, y0, jac=None, dfdp=None, dy0dp=None,
                     p=(), g=None, dgdp=None, dgdy=None, method=None,
                     rtol=1e-3, atol=1e-6, atol_adj=1e-6, atol_quad=1e-6,
                     sol_y=None):
    """dg/dp of ``g(t_f, y(t_f))`` by the adjoint method: a forward solve
    with dense output (or ``sol_y``), then one backward solve of the
    adjoint and the quadrature."""
    from .ivp import solve_ivp
    method = _method(method)
    y0, p, dy0dp, Ny, Np = _setup(y0, p, dy0dp)
    t0, tf = t_span

    fun_p = lambda t, y, pp: _as(fun(t, y, *pp), y)      # noqa: E731
    gp, dgdy_e, dgdp_e = _g_derivatives(g, dgdy, dgdp, p)
    sol_y, interp = _forward_y(fun_p, t_span, y0, p, method, atol, rtol,
                               sol_y)

    if jac is not None and dfdp is not None:
        jac_e = _embed(jac, tuple(p))
        dfdp_e = _embed(dfdp, tuple(p))

        def fun_bw(t, z):
            mu = z[:Ny]
            y = interp(t)
            dmu = -(_as(jac_e(t, y), y).T @ mu)
            dxi = _as(dfdp_e(t, y), y).T @ mu
            return torch.cat([dmu, dxi])
    else:
        def fun_bw(t, z):
            mu = z[:Ny]
            y = interp(t)
            JTmu, DTmu = _vjp_terms(fun_p, t, y, p, mu)
            return torch.cat([-JTmu, DTmu])

    tf_t = torch.tensor(float(tf), dtype=torch.float64, device=y0.device)
    yf = interp(tf_t)
    zf = torch.cat([_as(dgdy_e(tf_t, yf), yf), yf.new_zeros(Np)])
    atol_bw = np.concatenate([np.full(Ny, atol_adj),
                              np.full(Np, atol_quad)])
    sol_bw = solve_ivp(fun_bw, (tf, t0), zf, method=method, atol=atol_bw,
                       rtol=rtol)
    if not sol_bw.success:
        raise RuntimeError(
            "IVP solver not converged in backward solve of lambda")

    mu0 = sol_bw.y[:Ny, -1]
    integral = -sol_bw.y[Ny:, -1]
    sens = (_as(dgdp_e(tf_t, yf), yf).cpu().numpy() + mu0 @ dy0dp
            + integral)
    gf = float(gp(tf_t, yf, p))
    return AdjointSensitivityOutputEnd(sens, gf, sol_y, sol_bw)


def sens_adjoint_int(fun, t_span, y0, jac=None, dfdp=None, dy0dp=None,
                     p=(), g=None, dgdp=None, dgdy=None, method=None,
                     rtol=1e-3, atol=1e-6, atol_adj=1e-6, atol_quad=1e-6,
                     sol_y=None):
    """dG/dp for G the integral of ``g(t, y)`` over ``t_span``: a forward
    solve with dense output, then one backward solve of the adjoint, the
    quadrature and G itself."""
    from .ivp import solve_ivp
    method = _method(method)
    y0, p, dy0dp, Ny, Np = _setup(y0, p, dy0dp)
    t0, tf = t_span

    fun_p = lambda t, y, pp: _as(fun(t, y, *pp), y)      # noqa: E731
    gp, dgdy_e, dgdp_e = _g_derivatives(g, dgdy, dgdp, p)
    sol_y, interp = _forward_y(fun_p, t_span, y0, p, method, atol, rtol,
                               sol_y)

    def fun_bw(t, z):
        lam = z[:Ny]
        y = interp(t)
        JTlam, DTlam = _vjp_terms(fun_p, t, y, p, lam)
        dlam = -(JTlam + _as(dgdy_e(t, y), y))
        dxi = DTlam + _as(dgdp_e(t, y), y)
        dzeta = gp(t, y, p).reshape(1)
        return torch.cat([dlam, dxi, dzeta])

    zf = y0.new_zeros(Ny + Np + 1)
    atol_bw = np.concatenate([np.full(Ny, atol_adj),
                              np.full(Np, atol_quad),
                              [np.min(atol_quad)]])
    sol_bw = solve_ivp(fun_bw, (tf, t0), zf, method=method, atol=atol_bw,
                       rtol=rtol)
    if not sol_bw.success:
        raise RuntimeError(
            "IVP solver not converged in backward solve of lambda")

    lam0 = sol_bw.y[:Ny, -1]
    integral = -sol_bw.y[Ny:-1, -1]
    G = -float(sol_bw.y[-1, -1])
    sens = lam0 @ dy0dp + integral
    return AdjointSensitivityOutputInt(sens, G, sol_y, sol_bw)


# ---------------------------------------------------------------------------
# a whole device solve under torch.autograd: the continuous adjoint
# ---------------------------------------------------------------------------

def _ravel(leaves, batch):
    """JAX's ``ravel_pytree`` over the parameter leaves: ``(flat,
    unravel)``, where ``flat`` is ``(Np,)``, or ``(B, Np)`` with a member
    axis, and ``unravel`` maps a flat vector back (members last for a
    batch, as ``solve_ensemble`` passes them)."""
    shapes = [tuple(x.shape[1:] if batch else x.shape) for x in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    if batch:
        flat = torch.cat([x.reshape(x.shape[0], -1) for x in leaves], 1)
    else:
        flat = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(v):
        out, i = [], 0
        for s, k in zip(shapes, sizes):
            part = v[i:i + k]
            out.append(part.reshape(s + tuple(v.shape[1:])))
            i += k
        return out
    return flat, unravel


class _SolveFinal(torch.autograd.Function):
    """Forward: ``solve`` (or ``solve_ensemble``) with ``save_steps``;
    backward: the continuous adjoint from ``t_f`` to ``t_0`` against the
    record's segments."""

    @staticmethod
    def forward(ctx, cfg, t0, tf, y0, *leaves):
        from .solve import solve, solve_ensemble
        p = cfg["pack"](leaves)
        span = (float(t0), float(tf))
        kw = dict(method=cfg["method"], rtol=cfg["rtol"], atol=cfg["atol"],
                  max_steps=cfg["max_steps"], save_steps=True)
        fun = cfg["fun"]
        if cfg["batch"]:
            out = solve_ensemble(fun, span, y0, params_batch=p, **kw)
        else:
            out = solve(lambda t, y: fun(t, y, p), span, y0, **kw)
        ctx.cfg, ctx.out = cfg, out
        ctx.save_for_backward(t0, tf, y0, *leaves)
        return out.y

    @staticmethod
    def backward(ctx, ct):
        from .solve import solve, solve_ensemble, _members_last
        cfg, fwd = ctx.cfg, ctx.out
        t0, tf, y0, *leaves = ctx.saved_tensors
        fun, batch = cfg["fun"], cfg["batch"]
        span = (float(t0), float(tf))
        sgn = 1.0 if span[1] >= span[0] else -1.0
        rec, nseg = fwd.record, fwd.nsteps
        n = y0.shape[-1]
        p_flat, unravel = _ravel(leaves, batch)
        pack = cfg["pack"]

        # the record with a member axis (one member for a single solve)
        if not batch:
            rec = {k: v[None] for k, v in rec.items()}
            nseg = nseg.reshape(1)
        rows = torch.arange(rec["t_hi"].shape[0], device=y0.device)
        steps = torch.arange(rec["t_hi"].shape[1], device=y0.device)
        grid = torch.where(steps[None] < nseg[:, None], sgn * rec["t_hi"],
                           torch.inf).contiguous()
        last = torch.clamp(nseg - 1, min=0)

        def interp(t):
            """The forward solution at ``t`` ``(B,)``, rows-first."""
            idx = torch.searchsorted(grid, (sgn * t)[:, None].contiguous(),
                                     side="left")[:, 0]
            idx = torch.minimum(idx, last)
            u = (t - rec["t_lo"][rows, idx]) / rec["h"][rows, idx]
            return horner(u[:, None], rec["Q"][rows, idx],
                          rec["y_anchor"][rows, idx], axis=-1).T

        # the flat parameters as the RHS's rows: (Np, B), or (Np,) alone
        pf_rows = p_flat.T.contiguous() if batch else p_flat
        Npf = p_flat.shape[-1]

        def fun_bw(t, z):
            mu = z[:n]
            y = interp(t)
            _, pullback = torch.func.vjp(
                lambda yy, pf: fun(t, yy, pack(unravel(pf))), y, pf_rows)
            JTmu, DTmu = pullback(mu)
            return torch.cat([-JTmu, DTmu if batch else DTmu[:, None]])

        kw = dict(method=cfg["method"], rtol=cfg["rtol"], atol=cfg["atol"],
                  max_steps=cfg["max_steps"])
        zf = torch.cat([ct, ct.new_zeros(ct.shape[:-1] + (Npf,))], -1)
        if batch:
            bw = solve_ensemble(fun_bw, (span[1], span[0]), zf, **kw)
            mu0, xi = bw.y[:, :n], bw.y[:, n:]
            dp = [d.movedim(-1, 0) for d in unravel(-xi.T)]
            p_rows, y_f, y_0 = _members_last(pack(leaves)), fwd.y.T, y0.T
        else:
            bw = solve(fun_bw, (span[1], span[0]), zf, **kw)
            mu0, xi = bw.y[:n], bw.y[n:]
            dp = unravel(-xi)
            p_rows, y_f, y_0 = pack(leaves), fwd.y[:, None], y0[:, None]
        ones = y0.new_ones(rows.shape[0])
        f_tf = fun(span[1] * ones, y_f, p_rows).T.reshape(ct.shape)
        f_t0 = fun(span[0] * ones, y_0, p_rows).T.reshape(mu0.shape)
        # d y_f / d t_f = f(t_f, y_f); d y_f / d t_0 = -mu_0 . f(t_0, y_0)
        dtf = (ct * f_tf).sum()
        dt0 = -(mu0 * f_t0).sum()
        return (None, dt0.reshape(t0.shape).to(t0.dtype),
                dtf.reshape(tf.shape).to(tf.dtype), mu0, *dp)


def solve_final(fun, t_span, y0, p, method=None, rtol=1e-6, atol=1e-9,
                max_steps=10_000):
    """``y(t_f)`` as a differentiable function of ``(t_span, y0, p)``.

    ``fun(t, y, p)`` is rows-first, as for :func:`~extensisq_tpu_torch.
    solve.solve`; ``p`` is a tensor or a tuple of tensors.  Gradients
    reach the tensors among ``t_span``'s ends, ``y0`` and ``p`` through
    ``torch.autograd`` (``backward``, ``torch.autograd.grad``); the
    backward pass integrates the continuous adjoint against the forward
    solve's recorded steps.  With ``y0`` ``(B, n)`` and a leading member
    axis on every leaf of ``p``, the members are solved at once
    (``solve_ensemble``, ``p`` reaching ``fun`` with the member axis last)
    and ``y(t_f)`` is ``(B, n)``.  Runs on the device of ``y0``.
    """
    method = _method(method)
    y0 = as_input(y0)
    if not y0.is_floating_point():
        y0 = y0.to(torch.float64)
    tuple_p = isinstance(p, (tuple, list))
    leaves = tuple(torch.as_tensor(x, dtype=y0.dtype, device=y0.device)
                   if not isinstance(x, torch.Tensor) else x
                   for x in (p if tuple_p else (p,)))
    cfg = dict(fun=fun, method=method, rtol=rtol, atol=atol,
               max_steps=max_steps, batch=y0.ndim == 2,
               pack=(lambda ls: tuple(ls)) if tuple_p else (
                   lambda ls: ls[0]))
    t0, tf = (x if isinstance(x, torch.Tensor) else
              torch.tensor(float(x), dtype=y0.dtype, device=y0.device)
              for x in t_span)
    return _SolveFinal.apply(cfg, t0, tf, y0, *leaves)
