"""Whole-integration solver over a batch of members: the f64 device path.

Counterpart of ``extensisq_tpu/solve.py``.  The JAX ``solve_ensemble``
vmaps ``solve``, whose body is one flat ``lax.while_loop`` over step
attempts.  Here the member batch is explicit: each loop iteration runs one
attempt for every member (masked where a member has stopped), and the
loop ends once no member has status RUNNING (or, with ``pause_at``, once
every running member has reached the pause).  Everything runs on the
device of ``y0`` when it is a tensor (a CPU tensor asks for the CPU); a
numpy array or a list goes to the card.

``fun(t, y)`` is row-stacked: ``y`` has shape ``(n, B)`` with members on
the last axis and ``t`` shape ``(B,)``, e.g.
``torch.stack([y[1], mu * (1 - y[0]**2) * y[1] - y[0]])``.  The same
code is the RHS of the fused kernel's plain version.  ``solve`` calls it
with ``B = 1``.  An event function ``e(t, y)`` follows the same contract
and returns ``(B,)``; its ``terminal`` and ``direction`` attributes are
read as in scipy.  ESDIRK methods take the stepper options ``jac``, ``M``,
``jac_each_step``, ``jac_sparsity`` and ``bands`` as keyword arguments,
SWAG takes ``k_max``, SSV2stab ``rho_jac`` and ``const_jac`` (see
``steppers.build_stepper``).  ``y0`` may be complex in every family but
SSV2stab (times, steps and counters stay real; the stiffness check is
off), as in the JAX driver.

Trajectory options, as in the JAX driver: ``save_steps`` (every accepted
step's end), ``t_eval`` (the steps' free interpolants at given times),
``events`` (sign changes located by a 60-round bisection on the step's
interpolant; a terminal one truncates the member at its root, status 8),
``pause_at``/``resume_state``/``return_state`` (warm-started windows,
:func:`solve_windowed`) and ``nfev_stiff_detect`` (the on-device
stiffness diagnosis of the ERK and RKN families).  The record is written
in place: each attempt writes one row a member, the accepted members' to
their step's row and the others' to a spare row past the end.
"""
from typing import Any, NamedTuple

import numpy as np
import torch

from ._config import (RUNNING, MAX_STEPS_REACHED, TERMINAL_EVENT, PAUSED)
from ._device import as_input
from .core.interpolate import OdeSolution, horner
from .steppers import build_stepper
from .steppers.erk import select
from .types import IVPParams, Method


class Solution(NamedTuple):
    """Result of a solve.

    For ``solve_ensemble`` every field has the member axis first: ``y`` is
    ``(B, n)``, the counters ``(B,)``; ``ts`` ``(B, max_steps)``, ``ys``
    ``(B, max_steps, n)`` (NaN past each member's steps); ``y_eval`` ``(B,
    len(t_eval), n)``; ``t_events`` ``(B, n_events, max_events)`` (NaN
    padded), ``y_events`` ``(B, n_events, max_events, n)``, ``n_events``
    ``(B, n_events)``; ``record`` a dict of ``(B, max_steps, ...)``
    tensors (``t_lo``, ``t_hi``, ``h``, ``y_anchor``, ``Q``); ``stiffness``
    ``(B,)`` (``core.stiffness.STIFF_*``).  ``solve`` gives one member's
    view.  ``nfesig`` (RHS evaluations of the spectral-radius power
    iteration) and ``maxm`` (the largest stage count of any attempt) are
    SSV2stab's.  ``final_state`` is the stepper state, rows-first with the
    members last, to pass back as ``resume_state``.
    """
    t: Any                 # final time reached
    y: Any                 # final state
    status: Any            # int32 status code (1 = finished)
    nfev: Any
    nsteps: Any
    nfailed: Any
    ts: Any = None
    ys: Any = None
    t_eval: Any = None
    y_eval: Any = None
    record: Any = None
    t_events: Any = None
    y_events: Any = None
    n_events: Any = None
    stiffness: Any = None
    nfesig: Any = None
    maxm: Any = None
    final_state: Any = None

    @property
    def success(self):
        return (self.status == 1) | (self.status == TERMINAL_EVENT)

    def ode_solution(self, member=None):
        """An evaluable :class:`~extensisq_tpu_torch.core.interpolate.
        OdeSolution` from the recorded segments (``save_steps=True`` or
        ``t_eval``); an ensemble's takes the ``member`` index."""
        if self.record is None:
            raise ValueError(
                "no trajectory record: run solve(..., save_steps=True)")
        r, k = self.record, self.nsteps
        if member is not None:
            r = {key: v[member] for key, v in r.items()}
            k = k[member]
        elif k.ndim:
            raise ValueError("an ensemble's record: pass member=")
        k = int(k)
        ts = torch.cat([r["t_lo"][:1], r["t_hi"][:k]])
        return OdeSolution(ts=ts, t_anchor=r["t_lo"][:k], h=r["h"][:k],
                           y_anchor=r["y_anchor"][:k], Q=r["Q"][:k])


def _resolve_method(method):
    if method is None:
        from .methods import BS5 as method
    if isinstance(method, str):
        from .methods import METHODS_BY_NAME
        method = METHODS_BY_NAME[method]
    if not isinstance(method, Method):
        raise ValueError(f"unknown method {method!r}")
    return method


class _Record:
    """The trajectory record: per member one row a step, written in place
    (row ``max_steps`` is the spare row of members that did not accept)."""

    def __init__(self, stepper, state0, t0, max_steps):
        Q0 = stepper.record_coefficients(state0)
        n, p, B = Q0.shape
        M = self.M = max_steps
        like = state0.t
        self.bufs = {
            "t_lo": like.new_full((B, M + 1), t0),
            "t_hi": like.new_full((B, M + 1), t0),
            "h": like.new_ones((B, M + 1)),
            "y_anchor": Q0.new_zeros((B, M + 1, n)),
            "Q": Q0.new_zeros((B, M + 1, n, p)),
        }
        self.b = torch.arange(B, device=like.device)

    def write(self, stepper, new, accepted, prev_nsteps):
        Q = stepper.record_coefficients(new)
        i = torch.where(accepted, torch.clamp(prev_nsteps, max=self.M - 1),
                        self.M).long()
        rows = (self.b, i)
        self.bufs["t_lo"][rows] = new.t_old
        self.bufs["t_hi"][rows] = new.t
        self.bufs["h"][rows] = new.h_previous
        self.bufs["y_anchor"][rows] = new.y_old.T
        self.bufs["Q"][rows] = Q.permute(2, 0, 1)

    def results(self, nseg, direction, save_steps, t_eval):
        """(record, ts, ys, t_eval, y_eval) with the member axis first."""
        M = self.M
        bufs = {k: v[:, :M] for k, v in self.bufs.items()}
        ts = ys = te = y_eval = None
        mask = (torch.arange(M, device=nseg.device)[None]
                < nseg[:, None])
        if save_steps:
            # step-end states: each segment at u = 1
            ys = horner(1.0, bufs["Q"], bufs["y_anchor"], axis=-1)
            ts = torch.where(mask, bufs["t_hi"], torch.nan)
            ys = torch.where(mask[..., None], ys, torch.nan)
        if t_eval is not None:
            t_hi = bufs["t_hi"]
            te = torch.as_tensor(t_eval, dtype=t_hi.dtype,
                                 device=t_hi.device).reshape(-1)
            B, T = t_hi.shape[0], te.shape[0]
            grid = torch.where(mask, direction * t_hi, torch.inf)
            idx = torch.searchsorted(grid.contiguous(),
                                     (direction * te).expand(B, T)
                                     .contiguous(), side="left")
            idx = torch.minimum(idx, torch.clamp(nseg - 1, min=0)
                                .to(idx.dtype)[:, None])
            rows = (self.b[:, None], idx)
            u = (te - bufs["t_lo"][rows]) / bufs["h"][rows]
            y_eval = horner(u[..., None], bufs["Q"][rows],
                            bufs["y_anchor"][rows], axis=-1)
            te = te.expand(B, T)
        return bufs, ts, ys, te, y_eval


class _Events:
    """On-device events: sign-change detection on each accepted step, a
    60-round bisection on the step's free interpolant (run only when some
    member fired), terminal truncation at the earliest terminal root in
    the integration direction, and at most ``max_events`` roots an event
    (the first ones; the count saturates)."""

    def __init__(self, stepper, events, max_events, direction, state0):
        self.stepper = stepper
        self.events = (events,) if callable(events) else tuple(events)
        self.terminal = torch.tensor(
            [bool(getattr(e, "terminal", False)) for e in self.events],
            device=state0.t.device)
        self.dirs = [float(getattr(e, "direction", 0.0))
                     for e in self.events]
        self.max_events = int(max_events)
        self.direction = direction
        n, B = state0.y.shape
        n_ev = len(self.events)
        self.g = self._g(state0.t, state0.y)
        # slot max_events of each event is the spare slot
        self.t_ev = torch.full((B, n_ev, max_events + 1), torch.nan,
                               dtype=state0.t.dtype, device=state0.t.device)
        self.y_ev = state0.y.new_full((B, n_ev, max_events + 1, n),
                                      torch.nan)
        self.count = torch.zeros((n_ev, B), dtype=torch.int32,
                                 device=state0.t.device)
        self.b = torch.arange(B, device=state0.t.device)

    @staticmethod
    def _value(e, t, y):
        v = torch.as_tensor(e(t, y), device=t.device).to(torch.float64)
        return torch.broadcast_to(v, t.shape)

    def _g(self, t, y):
        return torch.stack([self._value(e, t, y) for e in self.events])

    def handle(self, new, accepted):
        g, g_new = self.g, self._g(new.t, new.y)
        up = (g <= 0) & (g_new >= 0)
        down = (g >= 0) & (g_new <= 0)
        fired = torch.stack([up[i] if d > 0 else down[i] if d < 0
                             else up[i] | down[i]
                             for i, d in enumerate(self.dirs)]) & accepted
        self.g = torch.where(accepted, g_new, g)
        if not bool(fired.any()):
            return new
        t_old, t_new, h, ya = new.t_old, new.t, new.h_previous, new.y_old
        Q = self.stepper.record_coefficients(new)

        def interp(tq):
            return horner((tq - t_old) / h, Q, ya)

        roots = []
        for i, e in enumerate(self.events):
            if not bool(fired[i].any()):
                roots.append(t_new)
                continue
            a, b, fa = t_old, t_new, g[i]
            for _ in range(60):
                mid = 0.5 * (a + b)
                fm = self._value(e, mid, interp(mid))
                left = fa * fm <= 0.0
                a, b, fa = (torch.where(left, a, mid),
                            torch.where(left, mid, b),
                            torch.where(left, fa, fm))
            roots.append(0.5 * (a + b))
        roots = torch.stack(roots)

        term_mask = self.terminal[:, None] & fired
        any_term = term_mask.any(0)
        dir_roots = self.direction * roots
        te_dir = torch.where(term_mask, dir_roots, torch.inf).amin(0)
        keep = fired & (~any_term | (dir_roots <= te_dir))
        keep = keep & (self.count < self.max_events)
        slot = torch.where(keep, self.count, self.max_events).long()
        for i in range(len(self.events)):
            if bool(keep[i].any()):
                rows = (self.b, i, slot[i])
                self.t_ev[rows] = roots[i]
                self.y_ev[rows] = interp(roots[i]).T
        self.count = self.count + keep.to(torch.int32)
        if bool(any_term.any()):
            te = self.direction * te_dir
            new = new._replace(
                t=torch.where(any_term, te, new.t),
                y=torch.where(any_term, interp(te), new.y),
                status=torch.where(any_term, TERMINAL_EVENT,
                                   new.status).to(torch.int32))
        return new

    def results(self):
        m = self.max_events
        return (self.t_ev[:, :, :m], self.y_ev[:, :, :m],
                self.count.T.contiguous())


def _stiffness_check(stepper, method, nsd, y):
    """(check, fxy_of) of the on-device diagnosis, or None where the
    method has no stability data (as in the JAX driver)."""
    if nsd <= 0 or method.family not in ("erk", "rkn") or y.is_complex():
        return None
    from .core.stiffness import make_device_diagnosis
    tab = stepper.tab
    if method.family == "erk" and tab.stbrad is not None:
        return (make_device_diagnosis(stepper.fun, stepper.s, nsd,
                                      stbrad=tab.stbrad, tanang=tab.tanang),
                lambda st: st.f)
    if method.family == "rkn" and tab.stbre is not None:
        m = stepper.m
        return (make_device_diagnosis(stepper.fun_first_order, stepper.s,
                                      nsd, stbre=tab.stbre, stbim=tab.stbim,
                                      tanang=tab.tanang),
                lambda st: torch.cat([st.y[m:], st.f]))
    return None


def _integrate(fun, t_span, y, method, rtol, atol, max_step, first_step,
               max_steps, options, t_eval=None, save_steps=False,
               events=None, max_events=8, pause_at=None, resume_state=None,
               return_state=False):
    """Run the attempt loop on the rows-first batch ``y`` (n, B); returns
    the :class:`Solution` with the member axis first."""
    n = y.shape[0]
    t0, tf = float(t_span[0]), float(t_span[1])
    sgn = float(np.sign(tf - t0))
    direction = 1.0 if sgn == 0 else sgn
    if np.ndim(atol) > 0:
        atol = torch.as_tensor(np.asarray(atol), dtype=y.dtype,
                               device=y.device).reshape(n, 1)
    else:
        atol = float(atol)
    params = IVPParams(t_bound=tf, direction=direction, rtol=float(rtol),
                       atol=atol, max_step=float(max_step))
    options = dict(options)
    nsd = int(options.pop("nfev_stiff_detect", 0) or 0)
    record = bool(save_steps) or t_eval is not None
    if record or events is not None or nsd > 0:
        # the last accepted step's start and stages, for the interpolant
        options["carry_stages"] = True
    stepper = build_stepper(method, fun, n, y.dtype, **options)
    if resume_state is not None:
        state = resume_state
    else:
        state = stepper.init(t0, y, params, first_step=first_step)
    aux = stepper.flat_init_aux(state)

    rec = _Record(stepper, state, t0, max_steps) if record else None
    ev = (_Events(stepper, events, max_events, direction, state)
          if events is not None else None)
    stiff = _stiffness_check(stepper, method, nsd, y)
    if stiff is not None:
        stiff_code = torch.zeros_like(state.nsteps)
        stiff_nfev = torch.zeros_like(state.nsteps)
    # max_steps budgets this call: under resume_state the carried counter
    # keeps counting, so the cap is relative to the call's first count
    cap = state.nsteps + max_steps
    watch = rec is not None or ev is not None or stiff is not None
    while True:
        running = state.status == RUNNING
        if pause_at is not None:
            running = running & (direction * (state.t - float(pause_at))
                                 < 0)
        if not bool(running.any()):
            break
        new, aux_new, accepted = stepper.step_flat(params, state, aux)
        if watch:
            accepted = accepted & running
        if rec is not None:
            rec.write(stepper, new, accepted, state.nsteps)
        if ev is not None:
            new = ev.handle(new, accepted)
        if stiff is not None:
            check, fxy_of = stiff
            code, dnfev, jreset = check(new, stepper.error_estimate(new),
                                        fxy_of(new), tf, accepted)
            new = new._replace(jflstp=torch.where(jreset, 0, new.jflstp)
                               .to(torch.int32))
            stiff_code = torch.maximum(stiff_code, code)
            stiff_nfev = stiff_nfev + dnfev
        hit_cap = (new.nsteps >= cap) & (new.status == RUNNING)
        new = new._replace(status=torch.where(
            hit_cap, MAX_STEPS_REACHED, new.status).to(torch.int32))
        # a member that has stopped keeps its state, as under vmap
        state = select(running, new, state)
        aux = select(running, aux_new, aux)

    status = state.status
    if pause_at is not None:
        # the loop leaves a member RUNNING only at the pause
        status = torch.where(status == RUNNING, PAUSED,
                             status).to(torch.int32)
    sol = Solution(t=state.t, y=state.y.T, status=status, nfev=state.nfev,
                   nsteps=state.nsteps, nfailed=state.nfailed,
                   nfesig=getattr(state, "nfesig", None),
                   maxm=getattr(state, "maxm", None))
    if return_state:
        sol = sol._replace(final_state=state)
    if stiff is not None:
        sol = sol._replace(stiffness=stiff_code, nfev=state.nfev + stiff_nfev)
    if ev is not None:
        t_ev, y_ev, count = ev.results()
        sol = sol._replace(t_events=t_ev, y_events=y_ev, n_events=count)
    if rec is not None:
        bufs, ts, ys, te, y_eval = rec.results(state.nsteps, direction,
                                               save_steps, t_eval)
        sol = sol._replace(record=bufs, ts=ts, ys=ys, t_eval=te,
                           y_eval=y_eval)
    return sol


def _as_float_tensor(y0):
    y0 = as_input(y0)
    if not (y0.is_floating_point() or y0.is_complex()):
        y0 = y0.to(torch.float64)
    return y0


def _first_member(sol):
    """One member's view of an ensemble :class:`Solution` (the stepper
    state stays the batch of one that ``resume_state`` takes)."""
    out = {}
    for name, x in sol._asdict().items():
        if x is None or name == "final_state":
            out[name] = x
        elif isinstance(x, dict):
            out[name] = {k: v[0] for k, v in x.items()}
        else:
            out[name] = x[0]
    return Solution(**out)


def solve(fun, t_span, y0, method=None, rtol=1e-3, atol=1e-6,
          max_step=np.inf, first_step=None, max_steps=10_000,
          t_eval=None, save_steps=False, args=None, events=None,
          max_events=8, pause_at=None, resume_state=None,
          return_state=False, **options):
    """Integrate one IVP (``y0`` of shape ``(n,)``) on the device of ``y0``
    when it is a tensor, else on the card.

    ``fun(t, y[, *args])`` and each event function are called with ``y``
    of shape ``(n, 1)`` and ``t`` of shape ``(1,)``.  Returns a
    :class:`Solution` with ``y`` of shape ``(n,)``, 0-d counters and the
    JAX driver's trajectory fields (``ys`` ``(max_steps, n)``, ``y_eval``
    ``(len(t_eval), n)``, ``t_events`` ``(n_events, max_events)``, ...).
    ``max_steps`` caps the accepted steps of this call (status 4);
    ``pause_at`` stops the member once ``t`` reaches it (status 9), and
    ``resume_state`` (a ``final_state`` of ``return_state=True``) continues
    it step for step.
    """
    method = _resolve_method(method)
    y0 = _as_float_tensor(y0).reshape(-1)
    if args is not None:
        base = fun
        fun = lambda t, y: base(t, y, *args)                 # noqa: E731
    sol = _integrate(fun, t_span, y0[:, None], method, rtol, atol, max_step,
                     first_step, max_steps, options, t_eval=t_eval,
                     save_steps=save_steps, events=events,
                     max_events=max_events, pause_at=pause_at,
                     resume_state=resume_state, return_state=return_state)
    return _first_member(sol)


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
                   max_events=8, pause_at=None, resume_state=None,
                   return_state=False, rtol=1e-3, atol=1e-6,
                   max_step=np.inf, first_step=None, max_steps=10_000,
                   **options):
    """Integrate a batch of initial states ``y0_batch`` (B, n) at once, on
    the device of ``y0_batch`` when it is a tensor, else on the card.

    ``fun(t, y)``, or ``fun(t, y, p)`` with per-member ``params_batch``
    (a tensor, or a dict/tuple of tensors, each with the member axis
    first).  ``p`` reaches ``fun`` with the member axis last, so a
    ``(B, k)`` tensor arrives as ``(k, B)`` and ``p[0]`` is one
    parameter across members, used like a scalar.  Event functions take
    ``(t, y)`` alone.  Returns a :class:`Solution` with ``y`` (B, n),
    per-member ``(B,)`` counters and members-first trajectory fields (the
    shapes of the JAX ``vmap`` of ``solve``).
    """
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
    return _integrate(fun, t_span, y0_batch.T.contiguous(), method, rtol,
                      atol, max_step, first_step, max_steps, options,
                      t_eval=t_eval, save_steps=save_steps, events=events,
                      max_events=max_events, pause_at=pause_at,
                      resume_state=resume_state, return_state=return_state)


def solve_windowed(fun, t_span, y0, n_windows, method=None,
                   ensemble=False, params_batch=None, **kwargs):
    """Integrate a long horizon as ``n_windows`` calls, feeding the whole
    stepper state forward between them on the host.

    Each window warm-starts from the previous one's state (step size,
    controller memory, SWAG's phi history, SSV2stab's eigenvector,
    ESDIRK's Jacobian/LU ladder, the counters) and the loop only pauses at
    each boundary (no step is clamped to it), so the windowed solve takes
    exactly the single-shot solve's steps: the final state and every
    counter are bit-identical.  ``ensemble=True`` integrates a batch
    ``y0`` (B, n) with optional ``params_batch``.  Trajectory recording
    and events are per-window and refused here; call :func:`solve` per
    window for them.  A window that ends a member with a failure status
    ends the loop.  Returns the last window's :class:`Solution`.
    """
    if (kwargs.get("save_steps") or kwargs.get("t_eval") is not None
            or kwargs.get("events") is not None):
        raise ValueError(
            "solve_windowed does not support save_steps/t_eval/events; "
            "call solve() per window instead.")
    t0, tf = t_span
    edges = np.linspace(float(t0), float(tf), int(n_windows) + 1)
    if ensemble:
        def run(a, b, st):
            return solve_ensemble(fun, (a, tf), y0, params_batch=params_batch,
                                  method=method, pause_at=b,
                                  resume_state=st, return_state=True,
                                  **kwargs)
    else:
        f = fun if params_batch is None else (
            lambda t, y: fun(t, y, params_batch))

        def run(a, b, st):
            return solve(f, (a, tf), y0, method=method, pause_at=b,
                         resume_state=st, return_state=True, **kwargs)

    out = run(edges[0], edges[1], None)
    for a, b in zip(edges[1:-1], edges[2:]):
        ok = out.status
        if not bool(((ok == 1) | (ok == TERMINAL_EVENT)
                     | (ok == PAUSED)).all()):
            break
        out = run(a, b, out.final_state)
    return out._replace(final_state=None)
