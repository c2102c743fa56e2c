"""Host driver: scipy-semantics ``solve_ivp`` and the stepwise ``Stepper``
on top of the port's steppers.

Counterpart of ``extensisq_tpu/ivp.py``: a Python loop of accepted steps
around a stepper's ``step``, with ``t_eval`` interpolation, event location
by Brent's method on the host, dense output and result assembly, the same
option checks, warnings, status codes and counters.  The steppers are the
batched ones of the ``solve`` driver, run with one member: state is
rows-first ``(n, 1)``.  Public arrays are numpy, as scipy's: ``y`` is
``(n, k)``; ``sol`` is an :class:`~extensisq_tpu_torch.core.interpolate.
OdeSolution` on the device of the solve.

Where it runs: on the card for a numpy or list ``y0``, on the CPU for a CPU
``torch.Tensor`` ``y0`` (how a caller, and the tests, ask for the CPU); with
no card a numpy ``y0`` raises.

The right-hand side ``fun(t, y[, *args])`` gets ``y`` as a 1-D tensor
``(n,)`` on ``y0``'s device and ``t`` as a 0-d tensor on that device (a
Python float would cost one host sync per evaluation on the card), and
returns ``(n,)``.  With ``vectorized=True`` it gets ``y`` as ``(n, k)`` and
``t`` as ``(k,)``, and returns ``(n, k)``: the rows-first contract of
:func:`~extensisq_tpu_torch.solve.solve`, with ``k = 1`` in the driver's
calls, so the right-hand sides of :mod:`extensisq_tpu_torch.problems` run
with ``vectorized=True``.  A callable ``jac(t, y)`` (ESDIRK) and ``rho_jac(t,
y)`` (SSV2stab) take ``t`` and ``y`` as ``fun`` does without
``vectorized``.  Event functions run on the host with a numpy ``y`` and a
float ``t``, as in scipy.

Host syncs: the stepper's attempt loop reads one flag an attempt plus one
to leave; after each accepted step one transfer brings ``t``, ``t_old``,
``h``, the status, the stiffness bookkeeping and ``y`` to the host; dense
output (``t_eval``, events, ``dense_output``) adds one transfer a step
where it is needed.  ``Stepper.host_syncs`` counts them.
"""
from types import SimpleNamespace
from warnings import warn

import numpy as np
import torch

from ._config import RUNNING, FINISHED, TOO_SMALL_STEP, STATUS_MESSAGES
from ._device import as_input
from .core.interpolate import OdeSolution, stack_segments
from .core.numerics import real_dtype, validate_tol
from .core.rootfind import brentq
from .steppers import build_stepper
from .types import IVPParams, Method


class OdeResult(dict):
    """Attribute-accessible result bunch (scipy-compatible surface)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    __setattr__ = dict.__setitem__

    def __repr__(self):
        keys = ", ".join(sorted(self.keys()))
        return f"OdeResult({keys})"


_FAMILY_OPTIONS = {
    "erk": {"first_step", "max_step", "rtol", "atol", "sc_params",
            "nfev_stiff_detect", "interpolant"},
    "ckdisc": {"first_step", "max_step", "rtol", "atol"},
    "rkn": {"first_step", "max_step", "rtol", "atol", "sc_params",
            "nfev_stiff_detect", "interpolant", "scale_embedded"},
    "esdirk": {"first_step", "max_step", "rtol", "atol", "sc_params",
               "jac", "jac_sparsity", "M", "jac_each_step", "interpolant",
               "bands"},
    "adams": {"first_step", "max_step", "rtol", "atol", "k_max"},
    "rkc": {"first_step", "max_step", "rtol", "atol", "const_jac",
            "rho_jac"},
}

# per-step scalars the driver reads on the host, where the state has them
_HOST_SCALARS = ("t", "t_old", "h_previous", "status", "nfailed", "okstp",
                 "jflstp", "stiff_flag", "mlim")
_COUNTERS = ("nfev", "njev", "nlu", "nsteps", "nfailed", "nls", "nfi",
             "nfesig", "maxm")


def _to_host(tensors):
    """The tensors as numpy arrays (real parts kept real), in one
    device-to-host transfer."""
    cplx = any(x.is_complex() for x in tensors)
    common = torch.complex128 if cplx else torch.float64
    flat = torch.cat([x.reshape(-1).to(common) for x in tensors]).cpu()
    out, i = [], 0
    for x in tensors:
        k = x.numel()
        v = flat[i:i + k].numpy().reshape(tuple(x.shape))
        out.append(v if x.is_complex() else v.real)
        i += k
    return out


class StepInterpolant:
    """Dense output of a single accepted step: host-side evaluation of
    one or more polynomial segments in the unified anchor form."""

    def __init__(self, t_old, t, segments):
        self.t_old = float(t_old)
        self.t = float(t)
        self.segments = [(float(ta), float(h), np.asarray(ya),
                          np.asarray(Q)) for ta, h, ya, Q in segments]

    def _eval_one(self, t):
        segs = self.segments
        if len(segs) > 1:
            # pick the sub-segment containing t (piecewise output)
            for ta, h, ya, Q in segs:
                lo, hi = sorted((ta, ta + h))
                if lo <= t <= hi:
                    break
        else:
            ta, h, ya, Q = segs[0]
        u = (t - ta) / h
        p = Q.shape[1]
        acc = Q[:, p - 1]
        for k in range(p - 2, -1, -1):
            acc = acc * u + Q[:, k]
        return ya + u * acc

    def __call__(self, t):
        t = np.asarray(t, dtype=float)
        if t.ndim == 0:
            return self._eval_one(float(t))
        return np.stack([self._eval_one(float(ti)) for ti in t], axis=1)


def _state_tensor(y0):
    """``y0`` as a 1-D tensor on its device (the card for numpy and
    lists): complex dtypes kept, anything else float64."""
    y0 = as_input(y0)
    if not y0.is_complex():
        y0 = y0.to(torch.float64)
    return y0


def _rows_first(fun, vectorized, dtype):
    """The stepper's ``fun(t (1,), y (n, 1)) -> (n, 1)`` from the user's
    ``fun(t, y)`` of a 0-d ``t`` and a 1-D ``y`` (where ``vectorized``, the
    stepper's own ``(1,)`` and ``(n, 1)``)."""
    def as_state(v, like):
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v, device=like.device)
        return v.to(dtype)

    if vectorized:
        return lambda t, y: as_state(fun(t, y), y).reshape(y.shape)
    return lambda t, y: as_state(fun(t[0], y[:, 0]), y)[:, None]


class Stepper:
    """Stepwise solver with the scipy ``OdeSolver`` surface, made by
    ``Method.__call__`` (``BS5(fun, t0, y0, t_bound).step()``).

    ``t``, ``y``, ``status`` and the step data read a host copy made once
    per accepted step; the counters read the device state (one sync
    each).
    """

    TOO_SMALL_STEP = STATUS_MESSAGES[TOO_SMALL_STEP]

    def __init__(self, method, fun, t0, y0, t_bound, rtol=1e-3, atol=1e-6,
                 max_step=np.inf, first_step=None, vectorized=False,
                 args=None, **options):
        if isinstance(method, str):
            from .methods import METHODS_BY_NAME
            method = METHODS_BY_NAME[method]
        y0 = _state_tensor(y0).reshape(-1)
        self._y0 = y0
        self.n = y0.numel()
        dtype = y0.dtype
        self.y0 = y0.cpu().numpy()
        self.t_bound = float(t_bound)
        t0 = float(t0)
        self.direction = float(np.sign(self.t_bound - t0) or 1.0)
        # every transfer to the host waits for the card: counted there
        self._on_card = int(y0.device.type != "cpu")
        self.host_syncs = self._on_card

        # ignore-and-warn options that don't apply to this family,
        # matching scipy's warn_extraneous behaviour; `vectorized` is
        # accepted everywhere
        options.pop("vectorized", None)
        allowed = _FAMILY_OPTIONS[method.family] | {"interpolant"}
        extraneous = {k: v for k, v in options.items() if k not in allowed}
        if extraneous:
            warn("The following arguments have no effect for a chosen "
                 f"solver: {', '.join(f'`{k}`' for k in extraneous)}.")
            for k in extraneous:
                options.pop(k)

        rtol, atol = validate_tol(rtol, atol, self.y0)
        if first_step is not None:
            first_step = float(first_step)
            if first_step <= 0:
                raise ValueError("`first_step` must be positive.")
            if first_step > abs(t_bound - t0):
                raise ValueError(
                    "`first_step` exceeds bounds.")
        if max_step <= 0:
            raise ValueError("`max_step` must be positive.")

        if args is not None:
            _fun = fun
            fun = lambda t, y: _fun(t, y, *args)                  # noqa: E731
        fun_wrapped = _rows_first(fun, vectorized, dtype)
        for key in ("jac", "rho_jac"):
            user = options.get(key)
            if callable(user):
                options[key] = (lambda t, y, user=user:
                                user(t[0], y[:, 0]))

        self._impl = build_stepper(method, fun_wrapped, self.n, dtype,
                                   carry_stages=True, **options)
        self.family = method.family
        if hasattr(self._impl, "validate_problem"):
            # host-side structural probes (uncounted RHS evaluations)
            self._impl.validate_problem(self._host_fun(fun_wrapped), t0,
                                        self.y0, device=y0.device)
        atol_t = (torch.as_tensor(atol, dtype=real_dtype(dtype),
                                  device=y0.device).reshape(-1, 1)
                  if np.ndim(atol) > 0 else float(atol))
        self.params = IVPParams(t_bound=self.t_bound,
                                direction=self.direction, rtol=float(rtol),
                                atol=atol_t, max_step=float(max_step))
        self.state = self._impl.init(t0, y0[:, None], self.params,
                                     first_step=first_step)
        self._snapshot()
        if getattr(self._impl, "isDAE", False):
            y0c = self.y
            if not np.allclose(y0c, self.y0, rtol=rtol, atol=np.max(atol)):
                warn(f"\nInitial conditions are changed to y0 = {y0c} to"
                     "\nmake them consistent with the algebraic "
                     "constraints.")
        self._nfev_extra = 0
        self._status_code = RUNNING
        self._message = None
        self._stiff_warned = False

    def _host_fun(self, fun_rows):
        """A rows-first RHS as a function of a float ``t`` and a numpy
        ``y`` (one transfer each way)."""
        dev, dtype = self._y0.device, self._y0.dtype

        def f(t, y):
            tt = torch.full((1,), float(t), dtype=real_dtype(dtype),
                            device=dev)
            yy = torch.as_tensor(np.asarray(y), device=dev).to(dtype)
            out = fun_rows(tt, yy[:, None])[:, 0]
            self.host_syncs += self._on_card
            return out.detach().cpu().numpy()
        return f

    def _snapshot(self):
        """Bring this step's scalars and ``y`` to the host, at once."""
        st = self.state
        names = [k for k in _HOST_SCALARS
                 if getattr(st, k, None) is not None]
        self.host_syncs += self._on_card
        vals, y = _to_host([self._scalars(names), st.y[:, 0]])
        self._host = dict(zip(names, (float(v) for v in vals)))
        self._y_host = y.astype(self.y0.dtype, copy=False)

    # -- scipy OdeSolver surface ------------------------------------------

    @property
    def t(self):
        return self._host["t"]

    @property
    def t_old(self):
        return self._host["t_old"]

    @property
    def y(self):
        return self._y_host

    @property
    def f(self):
        return self.state.f[:, 0].cpu().numpy()

    def _scalars(self, names):
        """The member's values of the state fields ``names``, float64."""
        return torch.stack([getattr(self.state, k).reshape(-1)[0]
                            .to(torch.float64) for k in names])

    def counters(self, names=_COUNTERS):
        """The work counters ``names`` of the state (0 where the family
        keeps none), with the host check's RHS evaluations in ``nfev``,
        read in one transfer."""
        have = [k for k in names if getattr(self.state, k, None) is not None]
        self.host_syncs += self._on_card
        vals = _to_host([self._scalars(have)])[0]
        out = dict.fromkeys(names, 0)
        out.update({k: int(v) for k, v in zip(have, vals)})
        if "nfev" in out:
            out["nfev"] += self._nfev_extra
        return out

    @property
    def nfev(self):
        return self.counters(("nfev",))["nfev"]

    @property
    def njev(self):
        return self.counters(("njev",))["njev"]

    @property
    def nlu(self):
        return self.counters(("nlu",))["nlu"]

    @property
    def nfailed(self):
        return self.counters(("nfailed",))["nfailed"]

    @property
    def step_size(self):
        h = self._host["h_previous"]
        return abs(h) if h != 0.0 else None

    @property
    def status(self):
        if self._status_code == RUNNING:
            return "running"
        if self._status_code == FINISHED:
            return "finished"
        return "failed"

    def step(self):
        """Advance one accepted step; returns None or failure message."""
        if self._status_code != RUNNING:
            raise RuntimeError(
                "Attempt to step on a failed or finished solver.")
        if self.n == 0 or self.t == self.t_bound:
            # degenerate problems finish immediately (scipy semantics)
            st = self.state
            self.state = st._replace(
                t_old=st.t, y_old=st.y,
                t=torch.full_like(st.t, self.t_bound),
                status=torch.full_like(st.status, FINISHED))
            self._snapshot()
            self._status_code = FINISHED
            return None
        failed = self._host["nfailed"]
        self.state = self._impl.step(self.params, self.state)
        self._snapshot()
        # the attempt loop's flags: one an attempt and one to leave
        self.host_syncs += self._on_card * (
            int(self._host["nfailed"] - failed) + 2)
        code = int(self._host["status"])
        self._status_code = code
        if code in (RUNNING, FINISHED):
            self._maybe_diagnose_stiffness()
            return None
        self._message = STATUS_MESSAGES.get(code, "failed")
        return self._message

    def _maybe_diagnose_stiffness(self):
        """RKSuite's stiffness check between steps (extensisq
        ``common.py``), plus the per-family stiffness hints (SWAG: 50
        consecutive low-order steps; SSV2stab: 15 consecutive steps at the
        stage cap)."""
        impl, host = self._impl, self._host
        if self.family == "adams":
            if host["stiff_flag"] and not self._stiff_warned:
                self._stiff_warned = True
                warn("Your problem appears to be stiff (for this "
                     "tolerance).")
            return
        if self.family == "rkc":
            if host.get("mlim", 0) >= 15 and not self._stiff_warned:
                self._stiff_warned = True
                warn("Your problem is too stiff for this method.")
            return
        if self.family not in ("erk", "rkn"):
            return
        tab = impl.tab
        nsd = impl.options.get("nfev_stiff_detect", 5000)
        if not nsd:
            return
        if self.family == "erk" and tab.stbrad is None:
            return
        if self.family == "rkn" and tab.stbre is None:
            return
        st = self.state
        okstp = int(host["okstp"])
        lotsfl = False
        if okstp % 40 == 39:
            lotsfl = int(host["jflstp"]) >= 10
            self.state = st._replace(jflstp=torch.zeros_like(st.jflstp))
            host["jflstp"] = 0.0
        many = max(nsd // impl.s, 1)
        toomch = okstp % many == many - 1
        if not (lotsfl or toomch):
            return

        from .core.stiffness import diagnose
        st = self.state
        if self.family == "rkn":
            m = impl.m
            fxy = torch.cat([st.y[m:], st.f])
            fun_h = self._host_fun(impl.fun_first_order)
            kwargs = {"stbre": tab.stbre, "stbim": tab.stbim}
        else:
            fxy = st.f
            fun_h = self._host_fun(impl.fun)
            kwargs = {"stbrad": tab.stbrad}
        self.host_syncs += self._on_card
        v0, fxy, y_old, havg = _to_host([impl.error_estimate(st)[:, 0],
                                         fxy[:, 0], st.y_old[:, 0],
                                         st.havg.reshape(-1)[:1]])
        host_state = SimpleNamespace(
            t=self.t, y=self.y, y_old=y_old.astype(self.y0.dtype),
            h_previous=host["h_previous"], havg=float(havg[0]))
        _, nfev = diagnose(
            fun_h, host_state, self.t_bound, nsd, impl.s,
            tanang=tab.tanang, estimate_error=v0, fxy=fxy,
            lotsfl=lotsfl, **kwargs)
        self._nfev_extra += nfev

    def dense_output(self, **opts):
        """Interpolant for the last accepted step."""
        if self._host["h_previous"] == 0.0:
            # no step taken (degenerate interval): constant segment
            seg = [(self.t_old, self.t - self.t_old or 1.0, self.y,
                    np.zeros((self.n, 1)))]
            return StepInterpolant(self.t_old, self.t, seg)
        segments, nfev_extra = self._impl.dense_segments(self.state, **opts)
        self._nfev_extra += int(nfev_extra)
        parts = []
        for ta, h, ya, Q in segments:
            parts += [torch.as_tensor(ta).reshape(-1)[:1],
                      torch.as_tensor(h).reshape(-1)[:1], ya[:, 0],
                      Q[..., 0]]
        self.host_syncs += self._on_card
        host = _to_host(parts)
        segs = [(host[i][0], host[i + 1][0], host[i + 2], host[i + 3])
                for i in range(0, len(host), 4)]
        return StepInterpolant(self.t_old, self.t, segs)


def _prepare_events(events, args):
    if events is None:
        return None, None, None
    if callable(events):
        events = (events,)
    wrapped = []
    is_terminal = []
    direction = []
    for ev in events:
        if args is not None:
            base = ev
            wrapped.append(lambda t, y, base=base: base(t, y, *args))
        else:
            wrapped.append(ev)
        is_terminal.append(bool(getattr(ev, "terminal", False)))
        direction.append(float(getattr(ev, "direction", 0)))
    return wrapped, np.asarray(is_terminal), np.asarray(direction)


def _active_events(g, g_new, direction):
    g = np.asarray(g, dtype=float)
    g_new = np.asarray(g_new, dtype=float)
    up = (g <= 0) & (g_new >= 0)
    down = (g >= 0) & (g_new <= 0)
    either = up | down
    mask = (up & (direction > 0)) | (down & (direction < 0)) \
        | (either & (direction == 0))
    return np.nonzero(mask)[0]


def solve_ivp(fun, t_span, y0, method=None, t_eval=None, dense_output=False,
              events=None, vectorized=False, args=None, **options):
    """Solve an IVP with scipy's semantics on the port's steppers.

    ``fun(t, y[, *args])`` follows the module's convention (a 0-d tensor
    ``t`` and a 1-D tensor ``y`` on ``y0``'s device); ``method`` is a
    Method handle (e.g. ``BS5``) or its name.  Runs on the card for a
    numpy or list ``y0`` and on the CPU for a CPU tensor.  Returns an
    :class:`OdeResult` with numpy ``t``, ``y`` ``(n, k)``, ``t_events``,
    ``y_events``, the counters, ``status``, ``message`` and ``success``,
    and ``sol`` with ``dense_output=True``.
    """
    if method is None:
        from .methods import BS5 as method
    if isinstance(method, str):
        from .methods import METHODS_BY_NAME
        method = METHODS_BY_NAME[method]
    if not isinstance(method, Method):
        raise ValueError(f"unknown method {method!r}")

    t0, tf = map(float, t_span)
    y0 = _state_tensor(y0)
    if y0.ndim != 1:
        raise ValueError("`y0` must be 1-dimensional.")
    if y0.numel() and not bool(torch.isfinite(
            y0 if not y0.is_complex() else y0.abs()).all()):
        raise ValueError(
            "All components of the initial state `y0` must be finite.")
    if args is not None:
        try:
            (lambda *a: None)(*args)
        except TypeError as exc:
            raise TypeError(
                "Supplied 'args' cannot be unpacked. Please supply "
                "`args` as a tuple (e.g. `args=(arg,)`)") from exc

    if t_eval is not None:
        t_eval = np.asarray(t_eval, dtype=float)
        if t_eval.ndim != 1:
            raise ValueError("`t_eval` must be 1-dimensional.")
        if np.any(t_eval < min(t0, tf)) or np.any(t_eval > max(t0, tf)):
            raise ValueError("Values in `t_eval` are not within `t_span`.")
        d = np.diff(t_eval)
        if tf > t0 and np.any(d <= 0) or tf < t0 and np.any(d >= 0):
            raise ValueError("Values in `t_eval` are not properly sorted.")

    solver = Stepper(method, fun, t0, y0, tf, vectorized=vectorized,
                     args=args, **options)
    direction = solver.direction

    events, is_terminal, event_dir = _prepare_events(events, args)
    if events is not None:
        g = [float(np.asarray(ev(t0, solver.y)).item()) for ev in events]
        t_events = [[] for _ in events]
        y_events = [[] for _ in events]
    else:
        t_events = y_events = None

    ts, ys = [t0], [solver.y]
    ts_eval, ys_eval = [], []
    eval_ptr = 0
    all_segments = []
    status = None

    while status is None:
        message = solver.step()
        if solver.status == "finished":
            status = 0
        elif solver.status == "failed":
            status = -1
            break
        t_old, t, y = solver.t_old, solver.t, solver.y
        sol_step = None

        if dense_output:
            sol_step = solver.dense_output()
            segs = sol_step.segments
            if len(segs) == 1:
                a, h, ya, Q = segs[0]
                all_segments.append((t_old, t, a, h, ya, Q))
            else:
                # piecewise step output (HS ESDIRK): each sub-segment
                # covers [anchor, anchor+h]
                for a, h, ya, Q in segs:
                    all_segments.append((a, a + h, a, h, ya, Q))

        if events is not None:
            g_new = [float(np.asarray(ev(t, y)).item()) for ev in events]
            active = _active_events(g, g_new, event_dir)
            if active.size:
                if sol_step is None:
                    sol_step = solver.dense_output()
                roots = []
                for e in active:
                    ev = events[e]
                    root = brentq(
                        lambda x: float(np.asarray(
                            ev(x, sol_step(x))).item()), t_old, t)
                    roots.append(root)
                roots = np.asarray(roots)
                if np.any(is_terminal[active]):
                    term_roots = roots[is_terminal[active]]
                    t_term = (np.min(term_roots) if direction > 0
                              else np.max(term_roots))
                    keep = direction * (roots - t_term) <= 0
                    active, roots = active[keep], roots[keep]
                    terminate = True
                else:
                    t_term = None
                    terminate = False
                order = np.argsort(direction * roots)
                for e, te in zip(active[order], roots[order]):
                    t_events[e].append(te)
                    y_events[e].append(np.asarray(sol_step(te)))
                if terminate:
                    status = 1
                    t = float(t_term)
                    y = np.asarray(sol_step(t))
            g = g_new

        if t_eval is None:
            ts.append(t)
            ys.append(y)
        else:
            new_ptr = eval_ptr
            m = t_eval.shape[0]
            while new_ptr < m and direction * (t_eval[new_ptr] - t) <= 0:
                new_ptr += 1
            if new_ptr > eval_ptr:
                if sol_step is None:
                    sol_step = solver.dense_output()
                for p in t_eval[eval_ptr:new_ptr]:
                    ts_eval.append(float(p))
                    ys_eval.append(np.asarray(sol_step(float(p))))
                eval_ptr = new_ptr

    if t_eval is None:
        t_out = np.asarray(ts)
        y_out = (np.stack(ys, axis=1) if ys
                 else np.empty((solver.n, 0), dtype=solver.y0.dtype))
    else:
        t_out = np.asarray(ts_eval)
        y_out = (np.stack(ys_eval, axis=1) if ys_eval
                 else np.empty((solver.n, 0), dtype=solver.y0.dtype))

    sol = None
    if dense_output and all_segments:
        sol = OdeSolution(*(x.to(y0.device)
                            for x in stack_segments(all_segments)))

    if events is not None:
        t_events = [np.asarray(te) for te in t_events]
        y_events = [(np.stack(ye) if ye else np.empty((0,)))
                    for ye in y_events]

    if status == 0:
        message = STATUS_MESSAGES[FINISHED]
    elif status == 1:
        message = "A termination event occurred."

    counts = solver.counters()
    return OdeResult(
        t=t_out, y=y_out, sol=sol,
        t_events=t_events, y_events=y_events,
        nfev=counts["nfev"], njev=counts["njev"], nlu=counts["nlu"],
        nsteps=counts["nsteps"], nfailed=counts["nfailed"],
        nls=counts["nls"], nfi=counts["nfi"],
        # RKC diagnostics (the reference exposes these as module
        # globals, sommeijer.py)
        nfesig=counts["nfesig"], maxm=counts["maxm"],
        status=status, message=message, success=status >= 0)
