"""Whole-integration solver over a batch of members: the f64 device path.

Counterpart of ``extensisq_tpu/solve.py`` (final-state path only).  The
JAX ``solve_ensemble`` vmaps ``solve``, whose body is one flat
``lax.while_loop`` over step attempts.  Here the member batch is
explicit: each loop iteration runs one attempt for every member (masked
where a member has stopped), and the loop ends once no member has status
RUNNING.  Everything runs on the device of ``y0``.

``fun(t, y)`` is row-stacked: ``y`` has shape ``(n, B)`` with members on
the last axis and ``t`` shape ``(B,)``, e.g.
``torch.stack([y[1], mu * (1 - y[0]**2) * y[1] - y[0]])``.  The same
code is the RHS of the fused kernel's plain version.  ``solve`` calls it
with ``B = 1``.  ESDIRK methods take the stepper options ``jac``, ``M``
and ``jac_each_step`` as keyword arguments, SWAG takes ``k_max`` (see
``steppers.build_stepper``).
"""
from typing import Any, NamedTuple

import numpy as np
import torch

from ._config import RUNNING, MAX_STEPS_REACHED, TERMINAL_EVENT
from .steppers import build_stepper
from .steppers.erk import select
from .types import IVPParams, Method


class Solution(NamedTuple):
    """Result of a solve: final time, state, status and work counters.

    For ``solve_ensemble`` every field has the member axis first:
    ``y`` is ``(B, n)``, the rest ``(B,)``.
    """
    t: Any                 # final time reached
    y: Any                 # final state
    status: Any            # int32 status code (1 = finished)
    nfev: Any
    nsteps: Any
    nfailed: Any

    @property
    def success(self):
        return (self.status == 1) | (self.status == TERMINAL_EVENT)


def _resolve_method(method):
    if method is None:
        from .methods import BS5 as method
    if isinstance(method, str):
        from .methods import METHODS_BY_NAME
        method = METHODS_BY_NAME[method]
    if not isinstance(method, Method):
        raise ValueError(f"unknown method {method!r}")
    return method


def _integrate(fun, t_span, y, method, rtol, atol, max_step, first_step,
               max_steps, options):
    """Run the attempt loop on the rows-first batch ``y`` (n, B);
    returns the final stepper state."""
    n = y.shape[0]
    t0, tf = float(t_span[0]), float(t_span[1])
    sgn = float(np.sign(tf - t0))
    if np.ndim(atol) > 0:
        atol = torch.as_tensor(np.asarray(atol), dtype=y.dtype,
                               device=y.device).reshape(n, 1)
    else:
        atol = float(atol)
    params = IVPParams(t_bound=tf, direction=1.0 if sgn == 0 else sgn,
                       rtol=float(rtol), atol=atol,
                       max_step=float(max_step))
    stepper = build_stepper(method, fun, n, y.dtype, **options)
    state = stepper.init(t0, y, params, first_step=first_step)
    aux = stepper.flat_init_aux(state)
    while True:
        running = state.status == RUNNING
        if not bool(running.any()):
            return state
        new, aux_new, _ = stepper.step_flat(params, state, aux)
        hit_cap = (new.nsteps >= max_steps) & (new.status == RUNNING)
        new = new._replace(status=torch.where(
            hit_cap, MAX_STEPS_REACHED, new.status).to(torch.int32))
        # a member that has stopped keeps its state, as under vmap
        state = select(running, new, state)
        aux = select(running, aux_new, aux)


def _check_options(t_eval, save_steps, events, pause_at, resume_state,
                   options):
    unported = {"t_eval": t_eval is not None, "save_steps": save_steps,
                "events": events is not None,
                "pause_at": pause_at is not None,
                "resume_state": resume_state is not None,
                "nfev_stiff_detect": bool(options.pop("nfev_stiff_detect",
                                                      0))}
    named = [k for k, v in unported.items() if v]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)}: not ported yet (ROADMAP A4); the port's "
            "solver returns the final state only")


def _as_float_tensor(y0):
    y0 = torch.as_tensor(y0)
    if y0.is_complex():
        raise NotImplementedError("complex states are not ported yet: "
                                  "ROADMAP A3")
    if not y0.is_floating_point():
        y0 = y0.to(torch.float64)
    return y0


def solve(fun, t_span, y0, method=None, rtol=1e-3, atol=1e-6,
          max_step=np.inf, first_step=None, max_steps=10_000,
          t_eval=None, save_steps=False, args=None, events=None,
          pause_at=None, resume_state=None, **options):
    """Integrate one IVP on the device of ``y0`` (shape ``(n,)``).

    ``fun(t, y[, *args])`` is called with ``y`` of shape ``(n, 1)`` and
    ``t`` of shape ``(1,)``.  Returns a :class:`Solution` with ``y`` of
    shape ``(n,)`` and 0-d counters.  ``max_steps`` caps accepted steps
    (status 4).
    """
    _check_options(t_eval, save_steps, events, pause_at, resume_state,
                   options)
    method = _resolve_method(method)
    y0 = _as_float_tensor(y0).reshape(-1)
    if args is not None:
        base = fun
        fun = lambda t, y: base(t, y, *args)                 # noqa: E731
    st = _integrate(fun, t_span, y0[:, None], method, rtol, atol,
                    max_step, first_step, max_steps, options)
    return Solution(t=st.t[0], y=st.y[:, 0], status=st.status[0],
                    nfev=st.nfev[0], nsteps=st.nsteps[0],
                    nfailed=st.nfailed[0])


def _members_last(p):
    """Per-member parameters with the member axis moved last, so that
    ``p[j]`` is a ``(B,)`` row like the rows of ``y``."""
    if isinstance(p, torch.Tensor):
        return p.movedim(0, -1)
    if isinstance(p, dict):
        return {k: _members_last(v) for k, v in p.items()}
    if isinstance(p, (tuple, list)):
        return type(p)(_members_last(v) for v in p)
    raise TypeError(f"params_batch leaves must be tensors, got {type(p)}")


def solve_ensemble(fun, t_span, y0_batch, params_batch=None, method=None,
                   t_eval=None, save_steps=False, args=None, events=None,
                   pause_at=None, resume_state=None, rtol=1e-3, atol=1e-6,
                   max_step=np.inf, first_step=None, max_steps=10_000,
                   **options):
    """Integrate a batch of initial states ``y0_batch`` (B, n) at once.

    ``fun(t, y)``, or ``fun(t, y, p)`` with per-member ``params_batch``
    (a tensor, or a dict/tuple of tensors, each with the member axis
    first).  ``p`` reaches ``fun`` with the member axis last, so a
    ``(B, k)`` tensor arrives as ``(k, B)`` and ``p[0]`` is one
    parameter across members, used like a scalar.  Returns a
    :class:`Solution` with ``y`` (B, n) and per-member ``(B,)`` fields.
    """
    _check_options(t_eval, save_steps, events, pause_at, resume_state,
                   options)
    method = _resolve_method(method)
    y0_batch = _as_float_tensor(y0_batch)
    if y0_batch.ndim != 2:
        raise ValueError("y0_batch must be (B, n)")
    extra = tuple(args or ())
    if params_batch is not None:
        extra = (_members_last(params_batch),) + extra
    if extra:
        base = fun
        fun = lambda t, y: base(t, y, *extra)                 # noqa: E731
    st = _integrate(fun, t_span, y0_batch.T.contiguous(), method, rtol,
                    atol, max_step, first_step, max_steps, options)
    return Solution(t=st.t, y=st.y.T.contiguous(), status=st.status,
                    nfev=st.nfev, nsteps=st.nsteps, nfailed=st.nfailed)
