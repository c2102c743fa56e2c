"""The port's on-device events and stiffness diagnosis against the JAX
package.

Events: the cases of the JAX ``tests/test_solve_device.py`` (a
non-terminal and a terminal event together, ``direction``, the vmapped
terminal hit) as ensembles of oscillators whose members fire at different
steps, with ``max_events`` saturation, a terminal event that stops some
members and not others, and a backward span.  The stiffness cases are
those of the JAX ``tests/test_stiffness_detection.py`` (one stiff member,
an ensemble with one stiff member, the Nystrom rectangle).  JAX runs in
two subprocesses with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no FMA).
Status, nsteps, nfev, nfailed, n_events and the stiffness codes must be
identical per member; t, y, the event times and event states agree within
1e-10 relative to max(1, |value|) (the f64 endpoint gate), and the roots
within 1e-8 of the exact ones.
"""
import functools
import textwrap

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import solve, solve_ensemble
from extensisq_tpu_torch.core.stiffness import STIFF_NONE, STIFF_REAL

from jax_reference import run_jax

COUNTERS = ("status", "nsteps", "nfev", "nfailed")
GATE = 1e-10
TOL = dict(rtol=1e-9, atol=1e-12)


def osc_w(t, y, w):
    return torch.stack([y[1], -w[0] * y[0]])


def half(t, y):
    return y[0] - 0.5


def vel(t, y):
    return y[1]


vel.terminal = True


def down(t, y):
    return y[0]


down.direction = -1


def cross(t, y):
    return y[0]


def reach(t, y):
    return y[0] - 0.8


reach.terminal = True
reach.direction = 1


def hit(t, y):
    return y[0]


hit.terminal = True
hit.direction = -1


def back_vel(t, y):
    return y[1] + 0.5


back_vel.terminal = True
back_vel.direction = 1


EVENTS = {"half": half, "vel": vel, "down": down, "cross": cross,
          "reach": reach, "hit": hit, "back_vel": back_vel}
ATTRS = {k: {"terminal": bool(getattr(e, "terminal", False)),
             "direction": float(getattr(e, "direction", 0.0))}
         for k, e in EVENTS.items()}


def _start(amps):
    amps = np.asarray(amps, float)
    return np.stack([0.0 * amps, amps], 1)


# name -> (span, y0, w, events, options)
CASES = {
    "pair": ((0.0, 10.0), _start([1.0] * 6), np.linspace(0.5, 2.0, 6),
             ["half", "vel"], {}),
    "direction": ((0.0, 13.0), _start([1.0] * 6), np.linspace(1.0, 3.0, 6),
                  ["down"], {}),
    "saturate": ((0.0, 20.0), _start([1.0] * 6), np.linspace(2.0, 4.0, 6),
                 ["cross"], {"max_events": 3}),
    "terminal_some": ((0.0, 5.0), _start(np.linspace(0.5, 1.5, 6)),
                      np.ones(6), ["reach", "down"], {}),
    "vmapped": ((0.0, 20.0), _start([1.0] * 8), np.linspace(1.0, 4.0, 8),
                ["hit"], {}),
    "backward": ((10.0, 0.0), _start([1.0] * 6), np.linspace(0.5, 2.0, 6),
                 ["cross", "back_vel"], {}),
}
# the stiffness cases: name -> (problem, method, span, y0, params, options)
# (the JAX tests' problems on shorter spans, with a first step: XLA's f64
# pow in h_start moves the whole trajectory by ~1e-10, which parts an
# accept decision of the stability-limited forced problem and the
# real/complex verdict of the spring's double eigenvalue; with the first
# step given every counter and code is identical)
STIFF = {
    "single": ("forced", "BS5", (0.0, 5.0), np.array([[0.5]]), None,
               dict(rtol=1e-4, atol=1e-7, first_step=1e-3,
                    nfev_stiff_detect=1000)),
    "one_stiff": ("decay", "BS5", (0.0, 3.0), np.ones((4, 1)),
                  np.array([1.0, 2.0, 800.0, 4.0]),
                  dict(rtol=1e-5, atol=1e-8, first_step=1e-3,
                       nfev_stiff_detect=1000)),
    "rkn": ("spring", "Fi5N", (0.0, 4.0), np.array([[1.0, 0.0]]), None,
            dict(rtol=1e-3, atol=1e-6, first_step=1e-3,
                 nfev_stiff_detect=1000)),
}


def forced(t, y):
    return torch.stack([-500.0 * (y[0] - torch.sin(t)) + torch.cos(t)])


def decay(t, y, lam):
    return -lam * y


def spring(t, y):
    return torch.stack([y[1], -2.5e5 * y[0] - 1000.0 * y[1]])


STIFF_FUNS = {"forced": forced, "decay": decay, "spring": spring}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X

    def make(name, attrs):
        f = {"half": lambda t, y: y[0] - 0.5, "vel": lambda t, y: y[1],
             "down": lambda t, y: y[0], "cross": lambda t, y: y[0],
             "reach": lambda t, y: y[0] - 0.8, "hit": lambda t, y: y[0],
             "back_vel": lambda t, y: y[1] + 0.5}[name]
        f.terminal, f.direction = attrs["terminal"], attrs["direction"]
        return f

    stiff_funs = {
        "forced": lambda t, y: jnp.stack(
            [-500.0 * (y[0] - jnp.sin(t)) + jnp.cos(t)]),
        "decay": lambda t, y, lam: -lam * y,
        "spring": lambda t, y: jnp.stack(
            [y[1], -2.5e5 * y[0] - 1000.0 * y[1]]),
    }
    inputs = np.load(sys.argv[1])
    spec = json.loads(sys.argv[2])
    out = {}
    for name, c in spec["events"].items():
        evs = tuple(make(e, spec["attrs"][e]) for e in c["events"])
        run = jax.jit(lambda Y, W: X.solve_ensemble(
            lambda t, y, w: jnp.stack([y[1], -w * y[0]]), tuple(c["span"]),
            Y, params_batch=W, method=X.BS5, events=evs, **c["kw"]))
        res = run(jnp.asarray(inputs[name + "/y0"]),
                  jnp.asarray(inputs[name + "/w"]))
        for f in ("t", "y", "status", "nsteps", "nfev", "nfailed",
                  "t_events", "y_events", "n_events"):
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
    for name, c in spec["stiff"].items():
        fun, m = stiff_funs[c["problem"]], getattr(X, c["method"])
        y0 = jnp.asarray(inputs[name + "/y0"])
        if name + "/p" in inputs:
            res = X.solve_ensemble(fun, tuple(c["span"]), y0,
                                   params_batch=jnp.asarray(
                                       inputs[name + "/p"]),
                                   method=m, **c["kw"])
        else:
            res = jax.jit(jax.vmap(lambda y: X.solve(
                fun, tuple(c["span"]), y, method=m, **c["kw"])))(y0)
        for f in ("y", "status", "nsteps", "nfev", "nfailed", "stiffness"):
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """Every case in JAX, from two subprocesses without FMA (events,
    stiffness; the port's runs meanwhile)."""
    d = tmp_path_factory.mktemp("jax_events")
    arrays = {}
    for k, (span, y0, w, evs, kw) in CASES.items():
        arrays[k + "/y0"], arrays[k + "/w"] = y0, w
    for k, (_, _, _, y0, p, _) in STIFF.items():
        arrays[k + "/y0"] = y0
        if p is not None:
            arrays[k + "/p"] = p
    np.savez(d / "in.npz", **arrays)
    events = {k: dict(span=list(v[0]), events=v[3], kw=dict(TOL, **v[4]))
              for k, v in CASES.items()}
    stiff = {k: dict(problem=v[0], method=v[1], span=list(v[2]), kw=v[5])
             for k, v in STIFF.items()}
    parts = [{"attrs": ATTRS, "events": events, "stiff": {}},
             {"attrs": ATTRS, "events": {}, "stiff": stiff}]
    warm = ([lambda k=k: _port(k) for k in CASES]
            + [lambda k=k: _stiff_port(k) for k in STIFF])
    return run_jax(_JAX_SCRIPT, d, parts, warm)


def _close(a, b, gate=GATE):
    """NaN where ``b`` is, and |a - b| <= gate * max(1, |b|) elsewhere."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    d = np.abs(a[ok] - b[ok]) / np.maximum(1.0, np.abs(b[ok]))
    assert np.max(d, initial=0.0) <= gate


@functools.lru_cache(maxsize=None)
def _port(name):
    span, y0, w, evs, kw = CASES[name]
    return solve_ensemble(osc_w, span, torch.tensor(y0),
                          params_batch=torch.tensor(w)[:, None],
                          method="BS5", events=[EVENTS[e] for e in evs],
                          **TOL, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_events_match_jax(jax_results, name):
    port = _port(name)
    ref = {f: jax_results[f"{name}/{f}"] for f in
           COUNTERS + ("t", "y", "t_events", "y_events", "n_events")}
    for f in COUNTERS + ("n_events",):
        np.testing.assert_array_equal(getattr(port, f).numpy(), ref[f],
                                      err_msg=f)
    for f in ("t", "y", "t_events", "y_events"):
        _close(getattr(port, f), ref[f])
    if name in ("pair", "direction", "terminal_some"):
        # the members fire at different steps (a frequency alone rescales
        # time, which BS5's steps follow)
        assert len(set(port.nsteps.tolist())) > 1


def test_event_roots_are_exact():
    """The JAX tests' analytic roots, y = sin(sqrt(w) t) / sqrt(w), within
    1e-8 (the error of BS5's free interpolant at rtol 1e-9)."""
    sw = np.sqrt(CASES["pair"][2])
    out = _port("pair")
    assert torch.all(out.status == 8) and torch.all(out.n_events == 1)
    np.testing.assert_allclose(out.t.numpy(), np.pi / (2 * sw), rtol=1e-8)
    np.testing.assert_allclose(out.t_events[:, 0, 0].numpy(),
                               np.arcsin(0.5 * sw) / sw, rtol=1e-8)
    np.testing.assert_allclose(out.y_events[:, 1, 0].numpy(),
                               np.stack([1 / sw, 0 * sw], 1), atol=1e-8)
    # downward zeros at (2k + 1) pi / sqrt(w) within t <= 13
    sw = np.sqrt(CASES["direction"][2])
    out = _port("direction")
    for b in range(len(sw)):
        roots = np.pi * np.arange(1, 30, 2) / sw[b]
        roots = roots[roots <= 13.0]
        k = int(out.n_events[b, 0])
        assert k == len(roots)
        np.testing.assert_allclose(out.t_events[b, 0, :k].numpy(), roots,
                                   rtol=1e-8)
    out = _port("vmapped")
    assert torch.all(out.status == 8)
    np.testing.assert_allclose(out.t.numpy(),
                               np.pi / np.sqrt(CASES["vmapped"][2]),
                               rtol=1e-8)


def test_saturation_and_partial_terminal():
    """max_events keeps the first roots and the count stops there (the
    first is the start, where y[0] = 0 and the first step leaves zero); a
    terminal event stops only the members that reach it."""
    out = _port("saturate")
    assert torch.all(out.n_events == 3)
    sw = np.sqrt(CASES["saturate"][2])
    assert torch.all(out.t_events[:, 0, 0].abs() < 1e-12)
    np.testing.assert_allclose(out.t_events[:, 0, 1:].numpy(),
                               np.pi * np.arange(1, 3)[None] / sw[:, None],
                               rtol=1e-8)
    assert torch.all(out.status == 1)
    out = _port("terminal_some")
    amps = CASES["terminal_some"][1][:, 1]
    np.testing.assert_array_equal(out.status.numpy(),
                                  np.where(amps > 0.8, 8, 1))
    stop = amps > 0.8
    np.testing.assert_allclose(out.t[stop].numpy(),
                               np.arcsin(0.8 / amps[stop]), rtol=1e-8)
    assert torch.all(out.t[~stop] == 5.0)


def test_solve_takes_one_member_events():
    """``solve`` calls the event with (1,) and (n, 1), and gives the
    member's view."""
    span, y0, w, evs, kw = CASES["pair"]
    ens = _port("pair")
    one = solve(lambda t, y: osc_w(t, y, torch.tensor([w[2]])), span,
                torch.tensor(y0[2]), method="BS5",
                events=[EVENTS[e] for e in evs], **TOL)
    assert one.t_events.shape == (2, 8) and one.y_events.shape == (2, 8, 2)
    for f in COUNTERS + ("n_events",):
        assert torch.equal(getattr(one, f), getattr(ens, f)[2])
    torch.testing.assert_close(one.t_events, ens.t_events[2], rtol=0.0,
                               atol=0.0, equal_nan=True)


# -- stiffness diagnosis ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stiff_port(name, **extra):
    prob, method, span, y0, p, kw = STIFF[name]
    kw = dict(kw, **extra)
    if p is None:
        return solve_ensemble(STIFF_FUNS[prob], span, torch.tensor(y0),
                              method=method, **kw)
    return solve_ensemble(STIFF_FUNS[prob], span, torch.tensor(y0),
                          params_batch=torch.tensor(p)[:, None],
                          method=method, **kw)


@pytest.mark.parametrize("name", list(STIFF))
def test_stiffness_matches_jax(jax_results, name):
    port = _stiff_port(name)
    for f in COUNTERS + ("stiffness",):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      jax_results[f"{name}/{f}"],
                                      err_msg=f)
    _close(port.y, jax_results[f"{name}/y"])
    assert torch.all(port.status == 1)
    if name == "one_stiff":
        np.testing.assert_array_equal(
            port.stiffness.numpy(),
            [STIFF_NONE, STIFF_NONE, STIFF_REAL, STIFF_NONE])
        # the diagnosis changes no step: the same y as without it
        ref = _stiff_port(name, nfev_stiff_detect=0)
        assert ref.stiffness is None
        assert torch.equal(port.y, ref.y)
        assert torch.all(port.nfev >= ref.nfev)
    elif name == "single":
        assert int(port.stiffness[0]) == STIFF_REAL
    else:
        assert int(port.stiffness[0]) > 0
