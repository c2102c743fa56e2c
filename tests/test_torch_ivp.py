"""The port's host driver (``solve_ivp`` and the stepwise ``Stepper``)
against the JAX package's, on the CPU.

Each case runs the port on CPU tensors in this process and the JAX
``solve_ivp`` on the same inputs in no-FMA subprocesses
(``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, ``tests/jax_reference.py``), as
the f64 driver tests do.  The work counters (``nfev`` with the host
stiffness check's evaluations, ``njev``, ``nlu``, ``nsteps``, ``nfailed``),
the status and the warnings must be equal; ``t``, ``y``, ``sol`` at
off-grid times, ``t_events`` and ``y_events`` agree within 1e-10 relative
to max(1, |y|) (``GATE``): XLA's f64 ``pow`` in the starting step puts the
step grids up to ~1e-10 apart, as in ``tests/test_torch_dense.py``.  The
cases mirror ``tests/test_ivp_explicit.py``,
``tests/test_stiffness_detection.py:11-66``, the host cases of
``tests/test_misc_options.py`` and ``tests/test_swag.py:11-89``, plus a
CKdisc case, the pendulum DAE, a DAE of index 2, the RKN problem checks
and a rows-first library problem under ``vectorized=True``.
"""
import functools
import textwrap
import warnings

import numpy as np
import pytest
import torch

from jax_reference import run_jax

import extensisq_tpu_torch as P
from extensisq_tpu_torch import problems
from extensisq_tpu_torch.ivp import OdeResult, solve_ivp

GATE = 1e-10
COUNTS = ("nfev", "njev", "nlu", "nsteps", "nfailed", "status")


# -- problems: the same functions on both sides (1-D y, 0-d t) -------------

def rational(t, y):
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def sol_rational(t):
    t = np.asarray(t)
    return np.asarray([t / (t + 10), 10 * t / (t + 10) ** 2])


def stiff500(t, y):
    return torch.stack([-500.0 * (y[0] - torch.sin(t)) + torch.cos(t)])


def stiff2000(t, y):
    return torch.stack([-2000.0 * (y[0] - torch.sin(t)) + torch.cos(t)])


def osc(t, y):
    return torch.stack([y[1], -y[0]])


def spring(t, y):
    return torch.stack([y[1], -2.5e5 * y[0] - 1000.0 * y[1]])


def vdp5(t, y):
    return torch.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def rob(t, y):
    return torch.stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                        0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                        3e7 * y[1] ** 2])


def f_disc(t, y):
    return torch.stack([torch.where(t < 5.0, 1.0, -1.0) * y[0] - y[1],
                        y[0] * 0.1 + torch.where(t < 5.0, 0.5, -2.0)])


def index2(t, y):
    # x' = z, 0 = x - sin(t): the algebraic z is absent from the constraint
    return torch.stack([y[1], y[0] - torch.sin(t)])


def not_second_order(t, y):
    return torch.stack([y[0], -y[1]])


def damped(t, y):
    return torch.stack([y[1], -y[0] - 0.1 * y[1]])


FUNS = {
    "rational": rational, "neg": lambda t, y: -y,
    "half_vec": lambda t, y: -0.5 * y, "zero": lambda t, y: 0 * y,
    "stiff500": stiff500, "stiff2000": stiff2000, "osc": osc,
    "spring": spring, "vdp5": vdp5, "rob": rob, "f_disc": f_disc,
    "index2": index2, "not_second_order": not_second_order,
    "damped": damped, "rot": lambda t, y, w: torch.stack([-w * y[1],
                                                         w * y[0]]),
    "scaled": lambda t, y, a: a * y,
    "pendulum": problems.pendulum_dae().rhs,
    "pleiades": problems.pleiades().rhs,
}

# event functions: host numpy, shared with the JAX script's text
_EVENTS_SRC = textwrap.dedent("""
    def e1(t, y):
        return float(y[0] - y[1] ** 0.7)
    def e2(t, y):
        return float(y[1] ** 0.6 - y[0])
    def e3(t, y):
        return t - 7.4
    def half(t, y):
        return y[0] - 0.5
    def rot_ev(t, y, w):
        return float(y[1] - 0.5)
    EVENTS = {"e1": e1, "e2": e2, "e3": e3, "half": half, "rot_ev": rot_ev}
""")
_ns = {}
exec(_EVENTS_SRC, _ns)
EVENTS = _ns["EVENTS"]

HEUN = dict(A=[[0.0, 0.0], [1.0, 0.0]], B=[0.5, 0.5], C=[0.0, 1.0],
            E=[-0.5, 0.5, 0.0])

Y_RAT = [1 / 3, 2 / 9]
TC_RAT = list(np.linspace(5, 9, 33)[1:-1] + 0.013)
TC_BACK = list(np.linspace(1, 5, 33)[1:-1] + 0.013)
PEND = problems.pendulum_dae()

# name -> spec; "fun", "method", "span", "y0" (list, or [re, im] pairs with
# "complex"), "opts", "events" [(name, direction, terminal)], "t_eval",
# "dense", "tc" (sol evaluation times), "args", "vectorized", "M",
# "raises" (a failing construction: the message must match)
CASES = {}
for _m in ("BS5", "Ts5", "Me4", "Pr7", "Pr9", "CFMR7osc"):
    CASES[f"rational_{_m}"] = dict(fun="rational", method=_m, span=[5, 9],
                                   y0=Y_RAT, dense=True, tc=TC_RAT)
    CASES[f"rational_back_{_m}"] = dict(fun="rational", method=_m,
                                        span=[5, 1], y0=Y_RAT, dense=True,
                                        tc=TC_BACK)
for _m in ("BS5", "CK5", "Pr8"):
    CASES[f"complex_{_m}"] = dict(fun="neg", method=_m, span=[0, 1],
                                  y0=[[0.5, 1.0]], complex=True, dense=True,
                                  tc=[0.1, 0.37, 0.82])
for _m in ("BS5", "Ts5", "Me4"):
    CASES[f"events_{_m}"] = dict(
        fun="rational", method=_m, span=[5, 8], y0=Y_RAT,
        events=[("e1", 0, False), ("e2", 0, False)])
    CASES[f"events_up_{_m}"] = dict(
        fun="rational", method=_m, span=[5, 8], y0=Y_RAT,
        events=[("e1", 1, False), ("e2", 1, False)])
    CASES[f"events_down_{_m}"] = dict(
        fun="rational", method=_m, span=[5, 8], y0=Y_RAT,
        events=[("e1", -1, False), ("e2", -1, False)])
    CASES[f"events_term_{_m}"] = dict(
        fun="rational", method=_m, span=[5, 8], y0=Y_RAT, dense=True,
        tc=[5.2, 6.1, 7.3], events=[("e1", 0, False), ("e2", 0, False),
                                    ("e3", 0, True)])
    CASES[f"events_back_{_m}"] = dict(
        fun="rational", method=_m, span=[8, 5], y0=[4 / 9, 20 / 81],
        dense=True, tc=[7.9, 7.5], events=[("e1", 0, False),
                                           ("e2", 0, False),
                                           ("e3", 0, True)])
for _m in ("BS5", "Pr7"):
    for _s in ([5, 9], [5, 1]):
        _k = f"{_m}_{_s[1]}"
        CASES[f"max_step_{_k}"] = dict(fun="rational", method=_m, span=_s,
                                       y0=Y_RAT, opts=dict(max_step=0.5))
        CASES[f"first_step_{_k}"] = dict(fun="rational", method=_m, span=_s,
                                         y0=Y_RAT, opts=dict(first_step=0.1))
for _s in ([5, 9], [5, 1]):
    CASES[f"t_eval_{_s[1]}"] = dict(fun="rational", method="BS5", span=_s,
                                    y0=Y_RAT,
                                    t_eval=list(np.linspace(*_s, 10)))
CASES["t_eval_subset"] = dict(fun="rational", method="BS5", span=[5, 9],
                              y0=Y_RAT, t_eval=[5.01, 7, 8, 8.01])
CASES["t_eval_subset_back"] = dict(fun="rational", method="BS5",
                                   span=[5, 1], y0=Y_RAT,
                                   t_eval=[4.99, 3, 1.5, 1.1])
CASES["t_eval_dense"] = dict(fun="rational", method="BS5", span=[5, 9],
                             y0=Y_RAT, t_eval=list(np.linspace(5, 9, 10)),
                             dense=True, tc=TC_RAT)
for _m in ("BS5", "CFMR7osc"):
    CASES[f"degenerate_span_{_m}"] = dict(fun="neg", method=_m, span=[0, 0],
                                          y0=[1.0, 2.0])
    CASES[f"degenerate_empty_{_m}"] = dict(fun="neg", method=_m,
                                           span=[0, 10], y0=[])
    CASES[f"degenerate_zero_{_m}"] = dict(fun="zero", method=_m,
                                          span=[0, 10], y0=[1.0])
CASES["args"] = dict(fun="rot", method="BS5", span=[0, 1], y0=[1.0, 0.0],
                     args=[2.0], opts=dict(rtol=1e-9, atol=1e-12),
                     dense=True, tc=[0.3, 0.71])
CASES["args_event"] = dict(fun="rot", method="BS5", span=[0, 1],
                           y0=[1.0, 0.0], args=[2.0],
                           opts=dict(rtol=1e-9, atol=1e-12),
                           events=[("rot_ev", 0, False)])
CASES["extraneous"] = dict(fun="rational", method="BS5", span=[5, 9],
                           y0=Y_RAT, opts=dict(jac_each_step=True))
for _i in ("free", "low", "best"):
    CASES[f"bs5_{_i}"] = dict(fun="rational", method="BS5", span=[5, 9],
                              y0=Y_RAT, opts=dict(rtol=1e-6, atol=1e-9,
                                                  interpolant=_i),
                              dense=True, tc=TC_RAT)
# tests/test_stiffness_detection.py:11-66.  These runs sit at BS5's and
# Fi5N's stability limit, where the controller amplifies XLA's last bits of
# its f64 pow: each gives a first step (h_start's pow apart), and the BS5
# ones keep equal counts and warnings but part on the way by up to ~1e-6,
# so their gate is 1e-5 ("gate").  The spring has a double eigenvalue
# (-500, a discriminant of 0), so the real-or-complex verdict of a
# diagnosis hangs on the last bit of the power iteration: there both
# drivers must warn "diagnosed as stiff" ("warn_any").  The spans are a
# third (BS5) and two fifths (Fi5N) of the JAX tests': each check fires on
# its first trigger, after nfev_stiff_detect / stages steps, well inside.
CASES["stiff_warns"] = dict(fun="stiff500", method="BS5", span=[0, 10],
                            y0=[0.5], opts=dict(rtol=1e-4, atol=1e-7,
                                                first_step=1e-3), gate=1e-5)
CASES["nonstiff_silent"] = dict(fun="osc", method="Me4", span=[0, 10],
                                y0=[0.0, 1.0], opts=dict(rtol=1e-6,
                                                         atol=1e-9))
CASES["detection_disabled"] = dict(fun="stiff500", method="BS5",
                                   span=[0, 5], y0=[0.5],
                                   opts=dict(rtol=1e-4, atol=1e-7,
                                             nfev_stiff_detect=0,
                                             first_step=1e-3), gate=1e-5)
CASES["rkn_stiff"] = dict(fun="spring", method="Fi5N", span=[0, 8],
                          y0=[1.0, 0.0], opts=dict(rtol=1e-3, atol=1e-6,
                                                   first_step=1e-4),
                          warn_any="diagnosed as stiff")
# the host cases of tests/test_misc_options.py
CASES["vectorized"] = dict(fun="half_vec", method="BS5", span=[0, 5],
                           y0=[2.0], vectorized=True,
                           opts=dict(rtol=1e-8, atol=1e-11))
CASES["jac_each_step"] = dict(fun="rob", method="TRBDF2", span=[0, 1e4],
                              y0=[1.0, 0.0, 0.0],
                              opts=dict(rtol=1e-5, atol=1e-8,
                                        jac_each_step=True))
CASES["jac_lazy"] = dict(fun="rob", method="TRBDF2", span=[0, 1e4],
                         y0=[1.0, 0.0, 0.0], opts=dict(rtol=1e-5, atol=1e-8))
CASES["kv3i_rob"] = dict(fun="rob", method="Kv3I", span=[0, 100.0],
                         y0=[1.0, 0.0, 0.0], opts=dict(rtol=1e-6, atol=1e-9))
# a tenth of the JAX test's span: the hint fires after 50 low-order steps
CASES["swag_hint"] = dict(fun="stiff2000", method="SWAG", span=[0, 0.25],
                          y0=[0.5], opts=dict(rtol=1e-5, atol=1e-8))
CASES["rkc_hint"] = dict(fun="stiff_1e9", method="SSV2stab", span=[0, 1.0],
                         y0=[0.0], opts=dict(rtol=1e-8, atol=1e-11))
CASES["args_single"] = dict(fun="scaled", method="BS5", span=[0, 0.1],
                            y0=[1.0], args=[-1.0])
CASES["array_atol"] = dict(fun="neg", method="BS5", span=[0, 5],
                           y0=[1.0, 2.0], opts=dict(atol=[1e-8, 1e-10],
                                                    rtol=1e-6))
CASES["t_eval_early_event"] = dict(fun="neg", method="BS5", span=[0, 10],
                                   y0=[1.0], opts=dict(rtol=1e-9, atol=1e-12),
                                   t_eval=list(np.linspace(0, 10, 21)),
                                   events=[("half", 0, True)])
CASES["heun"] = dict(fun="neg", method="heun", span=[0.0, 4.0], y0=[1.0],
                     opts=dict(rtol=1e-4, atol=1e-7), dense=True,
                     tc=[2.0, 3.3])
CASES["complex_kv3i"] = dict(
    fun="cplx_lin", method="Kv3I", span=[0.0, 2.0], y0=[[1.0, 0.5]],
    complex=True, opts=dict(rtol=1e-5, atol=1e-8))
# tests/test_swag.py:11-89, on 40% (high order) and half (k_max) of its
# spans
for _s in ([5, 9], [5, 1]):
    CASES[f"swag_rational_{_s[1]}"] = dict(
        fun="rational", method="SWAG", span=_s, y0=Y_RAT, dense=True,
        tc=TC_RAT if _s[1] == 9 else TC_BACK)
CASES["swag_complex"] = dict(fun="neg", method="SWAG", span=[0, 1],
                             y0=[[0.5, 1.0]], complex=True)
CASES["swag_high_order"] = dict(fun="osc", method="SWAG", span=[0, 40],
                                y0=[0.0, 1.0], opts=dict(rtol=1e-8,
                                                         atol=1e-11))
# long SWAG and RKN runs: a first step (h_start's pow), then bit for bit
CASES["swag_vdp"] = dict(fun="vdp5", method="SWAG", span=[0, 20],
                         y0=[2.0, 0.0], opts=dict(rtol=1e-6, atol=1e-9,
                                                  first_step=1e-3),
                         dense=True, tc=[3.1, 11.7])
CASES["swag_k_max4"] = dict(fun="osc", method="SWAG", span=[0, 15],
                            y0=[0.0, 1.0], opts=dict(rtol=1e-8, atol=1e-11,
                                                     k_max=4))
CASES["swag_k_max12"] = dict(fun="osc", method="SWAG", span=[0, 15],
                             y0=[0.0, 1.0], opts=dict(rtol=1e-8, atol=1e-11))
# one CKdisc case, the pendulum DAE, refusals, a library problem
CASES["ckdisc"] = dict(fun="f_disc", method="CKdisc", span=[0, 10],
                       y0=[1.0, 0.0], opts=dict(rtol=1e-6, atol=1e-9),
                       dense=True, tc=[2.3, 4.99, 5.01, 8.7],
                       events=[("half", 0, False)])
CASES["pendulum_kv3i"] = dict(fun="pendulum", method="Kv3I", span=[0, 2.0],
                              y0=list(PEND.y0), vectorized=True,
                              M=list(np.diag(PEND.M)),
                              opts=dict(rtol=1e-6, atol=1e-8), dense=True,
                              tc=[0.33, 1.41])
CASES["index2_refused"] = dict(fun="index2", method="Kv3I", span=[0, 1.0],
                               y0=[0.0, 1.0], M=[1.0, 0.0], raises=True)
CASES["rkn_not_second_order"] = dict(fun="not_second_order", method="Fi5N",
                                     span=[0, 1.0], y0=[1.0, 2.0],
                                     raises=True)
CASES["rkn_velocity_dependent"] = dict(fun="damped", method="MR6NN",
                                       span=[0, 1.0], y0=[1.0, 0.0],
                                       raises=True)
CASES["rkn_fi5n"] = dict(fun="damped", method="Fi5N", span=[0, 5.0],
                         y0=[1.0, 0.0], opts=dict(rtol=1e-8, atol=1e-11,
                                                  first_step=1e-2),
                         dense=True, tc=[0.7, 3.9])
STEPWISE = ("BS5", "Ts5")

FUNS["stiff_1e9"] = lambda t, y: torch.stack([-1e9 * (y[0] - 1.0)])
FUNS["cplx_lin"] = lambda t, y: (-0.5 + 3.0j) * y

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu import problems
    from extensisq_tpu.types import ERKTableau, Method
    %s
    def rational(t, y):
        return jnp.stack([y[1] / t,
                          y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])
    FUNS = {
        "rational": rational, "neg": lambda t, y: -y,
        "half_vec": lambda t, y: -0.5 * y, "zero": lambda t, y: 0 * y,
        "stiff500": lambda t, y: jnp.stack(
            [-500.0 * (y[0] - jnp.sin(t)) + jnp.cos(t)]),
        "stiff2000": lambda t, y: jnp.stack(
            [-2000.0 * (y[0] - jnp.sin(t)) + jnp.cos(t)]),
        "osc": lambda t, y: jnp.stack([y[1], -y[0]]),
        "spring": lambda t, y: jnp.stack(
            [y[1], -2.5e5 * y[0] - 1000.0 * y[1]]),
        "vdp5": lambda t, y: jnp.stack(
            [y[1], 5.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
        "rob": lambda t, y: jnp.stack(
            [-0.04 * y[0] + 1e4 * y[1] * y[2],
             0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
             3e7 * y[1] ** 2]),
        "f_disc": lambda t, y: jnp.stack(
            [jnp.where(t < 5.0, 1.0, -1.0) * y[0] - y[1],
             y[0] * 0.1 + jnp.where(t < 5.0, 0.5, -2.0)]),
        "index2": lambda t, y: jnp.stack([y[1], y[0] - jnp.sin(t)]),
        "not_second_order": lambda t, y: jnp.stack([y[0], -y[1]]),
        "damped": lambda t, y: jnp.stack([y[1], -y[0] - 0.1 * y[1]]),
        "rot": lambda t, y, w: jnp.stack([-w * y[1], w * y[0]]),
        "scaled": lambda t, y, a: a * y,
        "pendulum": problems.pendulum_dae().rhs,
        "stiff_1e9": lambda t, y: jnp.stack([-1e9 * (y[0] - 1.0)]),
        "cplx_lin": lambda t, y: (-0.5 + 3.0j) * y,
    }
    HEUN = Method(name="Heun", family="erk", tableau=ERKTableau(
        name="Heun", order=2, order_secondary=1, stbrad=2.0, tanang=2.0,
        **%r))
    COUNTS = %r

    def run(c):
        method = HEUN if c["method"] == "heun" else getattr(X, c["method"])
        y0 = np.asarray(c["y0"], dtype=float)
        if c.get("complex"):
            y0 = y0[:, 0] + 1j * y0[:, 1]
        opts = dict(c.get("opts", {}))
        if "M" in c:
            opts["M"] = np.diag(c["M"])
        evs = None
        if c.get("events"):
            evs = []
            for name, d, term in c["events"]:
                base = EVENTS[name]
                ev = (lambda t, y, *a, base=base: base(t, y, *a))
                ev.direction, ev.terminal = d, term
                evs.append(ev)
        return X.solve_ivp(
            FUNS[c["fun"]], c["span"], y0, method=method,
            t_eval=c.get("t_eval"), dense_output=c.get("dense", False),
            events=evs, vectorized=c.get("vectorized", False),
            args=tuple(c["args"]) if "args" in c else None, **opts)

    out = {}
    for name, c in json.loads(sys.argv[2]).items():
        if c.get("stepwise"):
            m = getattr(X, c["method"])
            s = m(rational, 5.0, [1 / 3, 2 / 9], 9.0)
            ts, nf, mid = [], [], []
            while s.status == "running":
                s.step()
                ts.append(s.t)
                nf.append(s.nfev)
                mid.append(np.asarray(s.dense_output()(
                    0.5 * (s.t_old + s.t))))
            out[name + "/t"] = np.asarray(ts)
            out[name + "/nfev"] = np.asarray(nf)
            out[name + "/mid"] = np.asarray(mid)
            continue
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                r = run(c)
            except Exception as exc:
                out[name + "/err"] = np.asarray(
                    [type(exc).__name__, str(exc)])
                continue
        out[name + "/warn"] = np.asarray(
            sorted({str(w.message) for w in rec
                    if issubclass(w.category, UserWarning)}) or [""])
        out[name + "/t"] = np.asarray(r.t)
        out[name + "/y"] = np.asarray(r.y)
        out[name + "/counts"] = np.asarray([r[k] for k in COUNTS])
        if r.t_events is not None:
            for i, (te, ye) in enumerate(zip(r.t_events, r.y_events)):
                out[name + f"/te{i}"] = np.asarray(te)
                out[name + f"/ye{i}"] = np.asarray(ye)
        if c.get("tc"):
            out[name + "/sol"] = np.asarray(r.sol(np.asarray(c["tc"])))
    np.savez(sys.argv[3], **out)
""") % (_EVENTS_SRC, HEUN, COUNTS)

N_PARTS = 4


def _heun():
    from extensisq_tpu_torch.types import ERKTableau, Method
    return Method(name="Heun", family="erk", tableau=ERKTableau(
        name="Heun", order=2, order_secondary=1, stbrad=2.0, tanang=2.0,
        **HEUN))


def run_port(c):
    """(result or exception, warnings) of the port on CPU tensors."""
    method = _heun() if c["method"] == "heun" else getattr(P, c["method"])
    y0 = np.asarray(c["y0"], dtype=float)
    if c.get("complex"):
        y0 = y0[:, 0] + 1j * y0[:, 1]
    opts = dict(c.get("opts", {}))
    if "M" in c:
        opts["M"] = np.diag(c["M"])
    evs = None
    if c.get("events"):
        evs = []
        for name, d, term in c["events"]:
            base = EVENTS[name]
            ev = (lambda t, y, *a, base=base: base(t, y, *a))
            ev.direction, ev.terminal = d, term
            evs.append(ev)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            r = solve_ivp(FUNS[c["fun"]], c["span"], torch.as_tensor(y0),
                          method=method, t_eval=c.get("t_eval"),
                          dense_output=c.get("dense", False), events=evs,
                          vectorized=c.get("vectorized", False),
                          args=tuple(c["args"]) if "args" in c else None,
                          **opts)
        except Exception as exc:
            r = exc
    msgs = sorted({str(w.message) for w in rec
                   if issubclass(w.category, UserWarning)}) or [""]
    return r, msgs


@functools.lru_cache(maxsize=None)
def _results(tmp):
    """(JAX outputs, port results), the port's computed while the JAX
    subprocesses run."""
    from pathlib import Path
    d = Path(tmp)
    np.savez(d / "in.npz", dummy=np.zeros(1))
    specs = dict(CASES)
    for m in STEPWISE:
        specs[f"stepwise_{m}"] = dict(stepwise=True, method=m)
    names = sorted(specs)
    parts = [{k: specs[k] for k in names[i::N_PARTS]}
             for i in range(N_PARTS)]
    port = {}

    def warm():
        for name in sorted(CASES):
            port[name] = run_port(CASES[name])
    jx = run_jax(_JAX_SCRIPT, d, parts, warm=(warm,))
    return jx, port


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _results(str(tmp_path_factory.mktemp("ivp")))


def close(a, b, gate=GATE):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size:
        scale = np.maximum(1.0, np.abs(b))
        assert np.all(np.abs(a - b) <= gate * scale), np.max(
            np.abs(a - b) / scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_ivp_matches_jax(results, name):
    jx, port = results
    r, msgs = port[name]
    c = CASES[name]
    if name + "/err" in jx:
        kind, text = jx[name + "/err"]
        assert isinstance(r, Exception), r
        assert type(r).__name__ == kind and str(r) == text
        return
    assert c.get("raises") is None, "JAX accepted a case meant to fail"
    if isinstance(r, Exception):
        raise r
    assert isinstance(r, OdeResult)
    if "warn_any" in c:
        for m in (msgs, list(jx[name + "/warn"])):
            assert any(c["warn_any"] in x for x in m), m
    else:
        assert list(jx[name + "/warn"]) == msgs
    assert [r[k] for k in COUNTS] == list(jx[name + "/counts"]), name
    assert r.success == (r.status >= 0)
    gate = c.get("gate", GATE)
    close(r.t, jx[name + "/t"], gate)
    close(r.y, jx[name + "/y"], gate)
    if c.get("events"):
        for i in range(len(c["events"])):
            close(r.t_events[i], jx[name + f"/te{i}"], gate)
            close(r.y_events[i], jx[name + f"/ye{i}"], gate)
    else:
        assert r.t_events is None and r.y_events is None
    if c.get("tc"):
        sol = r.sol(torch.as_tensor(np.asarray(c["tc"])))
        close(sol.numpy(), jx[name + "/sol"], gate)


def test_expected_behaviour(results):
    """The JAX tests' own assertions hold for the port's results."""
    _, port = results
    r = port["stiff_warns"]
    assert any("diagnosed as stiff" in m for m in r[1]) and r[0].success
    assert not any("stiff" in m for m in port["nonstiff_silent"][1])
    assert not any("stiff" in m for m in port["detection_disabled"][1])
    assert any("stiff" in m for m in port["rkn_stiff"][1])
    assert any("appears to be stiff" in m for m in port["swag_hint"][1])
    assert any("no effect" in m for m in port["extraneous"][1])
    assert any("Initial conditions are changed" in m
               for m in port["pendulum_kv3i"][1])
    heun = port["heun"][0]
    assert heun.t.size - 1 == 313 and heun.nfev == 630
    lazy, each = port["jac_lazy"][0], port["jac_each_step"][0]
    assert each.njev > 3 * lazy.njev
    r = port["t_eval_early_event"][0]
    assert r.status == 1 and r.t[-1] <= r.t_events[0][0]
    np.testing.assert_allclose(r.t_events[0][0], np.log(2), rtol=1e-8)
    assert port["degenerate_span_BS5"][0].success
    assert port["degenerate_empty_BS5"][0].y.shape[0] == 0
    r = port["swag_high_order"][0]
    assert r.nfev < 2.2 * r.nsteps + 10
    assert port["swag_k_max4"][0].nsteps > 1.5 * port[
        "swag_k_max12"][0].nsteps
    r = port["complex_BS5"][0]
    assert r.y.dtype == np.complex128 and r.sol(0.5).dtype == torch.complex128
    for m in ("BS5", "Pr7"):
        r = port[f"first_step_{m}_9"][0]
        assert np.isclose(r.t[1] - 5.0, 0.1)
        r = port[f"max_step_{m}_1"][0]
        assert np.all(np.abs(np.diff(r.t)) <= 0.5 + 1e-12)


@pytest.mark.parametrize("method", STEPWISE)
def test_stepwise_protocol(results, method):
    """``Method.__call__`` gives the scipy stepwise surface; each step's
    t, nfev and dense output equal the JAX Stepper's."""
    jx, _ = results
    solver = getattr(P, method)(rational, 5.0,
                                torch.tensor(Y_RAT, dtype=torch.float64),
                                9.0)
    assert solver.n == 2 and solver.status == "running"
    assert solver.t_bound == 9.0
    ts, nf, mid = [], [], []
    while solver.status == "running":
        assert solver.step() is None
        assert solver.step_size is not None
        ts.append(solver.t)
        nf.append(solver.nfev)
        sol = solver.dense_output()
        mid.append(sol(0.5 * (solver.t_old + solver.t)))
        np.testing.assert_allclose(sol(solver.t), solver.y, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(
                                       solver.y).max()))
    assert solver.status == "finished" and solver.t == 9.0
    assert nf == list(jx[f"stepwise_{method}/nfev"])
    close(ts, jx[f"stepwise_{method}/t"])
    close(mid, jx[f"stepwise_{method}/mid"])
    with pytest.raises(RuntimeError):
        solver.step()


def test_option_errors():
    """scipy's argument checks, with the JAX driver's texts."""
    y0 = torch.tensor(Y_RAT, dtype=torch.float64)
    for bad in (dict(first_step=-1), dict(max_step=-1),
                dict(t_eval=[5, 5.01, 4]), dict(t_eval=[4, 6])):
        with pytest.raises(ValueError):
            solve_ivp(rational, [5, 9], y0, method=P.BS5, **bad)
    for fill in (np.nan, np.inf):
        with pytest.raises(ValueError, match="must be finite"):
            solve_ivp(lambda t, y: 0 * y, (0, 10),
                      torch.full((3,), fill, dtype=torch.float64))
    with pytest.raises(TypeError, match="cannot be unpacked"):
        solve_ivp(lambda t, y, a: a * y, (0, 0.1), torch.tensor([1.0]),
                  args=-1)
    with pytest.raises(ValueError):
        solve_ivp(osc, (0, 1), torch.tensor([0.0, 1.0]), method=P.SWAG,
                  k_max=13)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_ivp(rational, [5, 9], Y_RAT)


def test_pleiades_cfmr7osc_library_vectorized():
    """The rows-first library RHS under ``vectorized=True``: Pleiades with
    CFMR7osc takes the JAX test's pinned 384 steps and 4,083 evaluations
    (``tests/test_ivp_explicit.py:316-330``)."""
    pl = problems.pleiades()
    r = solve_ivp(pl.rhs, pl.t_span, torch.as_tensor(pl.y0),
                  method=P.CFMR7osc, rtol=1e-9, atol=1e-12, vectorized=True)
    assert r.success
    assert r.t.size - 1 == 384 and r.nsteps == 384
    assert r.nfev == 4083
