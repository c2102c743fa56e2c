"""The port's CKdisc stepper (the f64 driver's variable-order cascade) and
its explicit tableaux against the JAX package.

``solve_ensemble(method=CKdisc)`` integrates the problems of
``tests/test_ckdisc.py`` (the rational problem forward and backward, the
sign-switching decay, the step forcing, the ``f_disc`` system of
``test_flat_path_matches_host_driver``), 16 members of BASELINE config
1c's ``swdec_rows`` (``validation/benchmarks.py:110-128``), and a case with
``max_step`` and one with ``first_step``, in both packages on the CPU.  JAX
runs in one subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no
FMA): on these non-smooth problems the cascade bisects towards each
switch, so a step that lands a few ulps elsewhere gets a fallback solution
whose error is of the tolerance's size.  Without FMA, status, nsteps, nfev
and nfailed are identical per member and the endpoints agree to 1e-10.
Where the members sit is part of the case: about one member in four of
these problems takes a kink step that XLA's compiled f64 arithmetic rounds
otherwise than IEEE operations one by one (JAX's own eager steps and the
port agree bit for bit there), and its endpoint then moves by up to 1e-6
with the same counts; such members are left out.

The tableau checks run ``tests/order_oracle.py``'s rooted-tree conditions
on the port's explicit tableaux, CKdisc's assessment and fallback rows
included.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from order_oracle import augmented_embedded, rk_residuals

import extensisq_tpu_torch as P
from extensisq_tpu_torch import CKdisc, solve, solve_ensemble
from extensisq_tpu_torch.methods.erk import CKDISC_DATA
from extensisq_tpu_torch.steppers import build_stepper
from extensisq_tpu_torch.types import IVPParams

REPO = Path(__file__).resolve().parents[1]
COUNTERS = ("status", "nsteps", "nfev", "nfailed")


def rational(t, y):
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def decay(t, y):
    return torch.stack([-torch.sign(torch.sin(3 * t)) * y[0] - 0.5 * y[0]])


def forcing(t, y):
    return torch.stack([torch.where(t < 1.0, 1.0, -1.0) - 0.1 * y[0]])


def f_disc(t, y):
    return torch.stack([torch.where(t < 5.0, 1.0, -1.0) * y[0] - y[1],
                        y[0] * 0.1 + torch.where(t < 5.0, 0.5, -2.0)])


def swdec_rows(t, y):
    sw = torch.where(torch.sin(3.0 * t) >= 0.0, 1.0, -1.0)
    return torch.stack([(-sw - 0.5) * y[0], (sw - 0.5) * y[1]])


PROBLEMS = {"rational": rational, "decay": decay, "forcing": forcing,
            "f_disc": f_disc, "swdec_rows": swdec_rows}
SCALE = np.array([1.0, 1.01, 1.03])[:, None]
RATIONAL0 = np.array([[1 / 3, 2 / 9]]) * SCALE
SWDEC0 = (1.0 + 0.5 * np.random.RandomState(1).rand(1024, 2))[:16]
SWDEC0 = SWDEC0.astype(np.float32).astype(np.float64)
# name -> (problem, span, y0, options)
CASES = {
    "rational": ("rational", (5.0, 9.0), RATIONAL0,
                 dict(rtol=1e-3, atol=1e-6)),
    "rational_back": ("rational", (5.0, 1.0), RATIONAL0,
                      dict(rtol=1e-3, atol=1e-6)),
    "decay": ("decay", (0.0, 5.0), 2.0 * SCALE, dict(rtol=1e-4, atol=1e-8)),
    "forcing": ("forcing", (0.0, 2.0), np.array([[0.0], [0.02], [0.03]]),
                dict(rtol=1e-6, atol=1e-9)),
    "f_disc": ("f_disc", (0.0, 10.0), np.array([[1.0, 0.0]]) * SCALE,
               dict(rtol=1e-6, atol=1e-9)),
    "swdec16": ("swdec_rows", (0.0, 5.0), SWDEC0, dict(rtol=1e-4, atol=1e-7)),
    "decay_max_step": ("decay", (0.0, 5.0), 2.0 * SCALE,
                       dict(rtol=1e-4, atol=1e-8, max_step=0.1)),
    "f_disc_first_step": ("f_disc", (0.0, 10.0),
                          np.array([[1.0, 0.0]]) * np.array(
                              [[1.0], [1.02], [1.03]]),
                          dict(rtol=1e-6, atol=1e-9, first_step=0.01)),
}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    DENSE_T = np.linspace(0.0, 10.0, 41)

    def sw(t):
        return jnp.where(jnp.sin(3.0 * t) >= 0.0, 1.0, -1.0)

    problems = {
        "rational": lambda t, y: jnp.stack(
            [y[1] / t, y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))]),
        "decay": lambda t, y: jnp.stack(
            [-jnp.sign(jnp.sin(3 * t)) * y[0] - 0.5 * y[0]]),
        "forcing": lambda t, y: jnp.stack(
            [jnp.where(t < 1.0, 1.0, -1.0) - 0.1 * y[0]]),
        "f_disc": lambda t, y: jnp.stack(
            [jnp.where(t < 5.0, 1.0, -1.0) * y[0] - y[1],
             y[0] * 0.1 + jnp.where(t < 5.0, 0.5, -2.0)]),
        "swdec_rows": lambda t, y: jnp.stack(
            [(-sw(t) - 0.5) * y[0], (sw(t) - 0.5) * y[1]]),
    }
    inputs = np.load(sys.argv[1])
    out = {}
    for name, (prob, span, kw) in json.loads(sys.argv[2]).items():
        run = jax.jit(lambda Y: X.solve_ensemble(
            problems[prob], tuple(span), Y, method=X.CKdisc, **kw))
        res = run(jnp.asarray(inputs[name]))
        for f in ("y", "status", "nsteps", "nfev", "nfailed"):
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
    # dense output: the f_disc members' free interpolant at t_eval
    prob, span, kw = json.loads(sys.argv[2])["f_disc"]
    res = jax.jit(lambda Y: X.solve_ensemble(
        problems[prob], tuple(span), Y, method=X.CKdisc,
        t_eval=jnp.asarray(DENSE_T), **kw))(jnp.asarray(inputs["f_disc"]))
    out["dense/y_eval"] = np.asarray(res.y_eval)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """JAX ``solve_ensemble(method=CKdisc)`` on every case, from one
    subprocess without FMA."""
    d = tmp_path_factory.mktemp("jax_ckdisc")
    np.savez(d / "in.npz", **{k: v[2] for k, v in CASES.items()})
    spec = {k: [v[0], v[1], v[3]] for k, v in CASES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=600)
    out = np.load(d / "out.npz")
    res = {k: {f: out[f"{k}/{f}"] for f in ("y",) + COUNTERS}
           for k in CASES}
    res["dense"] = {"y_eval": out["dense/y_eval"]}
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_ensemble_matches_jax(jax_results, name):
    prob, span, y0, kw = CASES[name]
    port = solve_ensemble(PROBLEMS[prob], span, torch.tensor(y0),
                          method="CKdisc", **kw)
    ref = jax_results[name]
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(), ref[f],
                                      err_msg=f)
    assert np.all(ref["status"] == 1)
    assert np.max(np.abs(port.y.numpy() - ref["y"])) <= 1e-10


def _orders(name):
    """The error orders of every accepted step of a case, from the port's
    stepper (4: the 5th-order solution, 2 and 1: the 3rd- and 2nd-order
    fallbacks)."""
    prob, span, y0, kw = CASES[name]
    y = torch.tensor(y0).T.contiguous()
    params = IVPParams(t_bound=span[1], direction=float(np.sign(span[1]
                                                                - span[0])),
                       rtol=kw["rtol"], atol=kw["atol"],
                       max_step=kw.get("max_step", np.inf))
    st = build_stepper(CKdisc, PROBLEMS[prob], y.shape[0], torch.float64)
    state = st.init(span[0], y, params, first_step=kw.get("first_step"))
    aux = st.flat_init_aux(state)
    seen = []
    while bool((state.status == 0).any()):
        state, aux, ok = st.step_flat(params, state, aux)
        seen += state.order_accepted[ok].tolist()
    return seen


@pytest.mark.parametrize("name", ["decay", "f_disc", "swdec16"])
def test_both_fallbacks_accept(name):
    """The cases reach the fallback solutions: some steps are accepted at
    the 3rd-order fallback (error order 2) and some at the 2nd-order one
    (error order 1), besides the 5th-order solution."""
    assert set(_orders(name)) == {1, 2, 4}


def test_solve_and_step_match_the_ensemble():
    """``solve`` on one member takes that member's steps in the ensemble,
    and ``step`` (attempts until one is accepted) walks the same accepted
    steps as the flat attempt loop."""
    prob, span, y0, kw = CASES["f_disc"]
    ens = solve_ensemble(f_disc, span, torch.tensor(y0), method=CKdisc, **kw)
    for i in range(len(y0)):
        one = solve(f_disc, span, torch.tensor(y0[i]), method="CKdisc", **kw)
        for f in COUNTERS:
            assert int(getattr(one, f)) == int(getattr(ens, f)[i])
        assert (one.y - ens.y[i]).abs().max() <= 1e-12
    params = IVPParams(t_bound=span[1], direction=1.0, rtol=kw["rtol"],
                       atol=kw["atol"], max_step=np.inf)
    st = build_stepper(CKdisc, f_disc, 2, torch.float64)
    state = st.init(span[0], torch.tensor(y0).T.contiguous(), params)
    for k in range(1, 11):
        state = st.step(params, state)
        part = solve_ensemble(f_disc, span, torch.tensor(y0), method=CKdisc,
                              max_steps=k, **kw)
        assert torch.all(state.nsteps == k)
        assert torch.equal(state.t, part.t)
        assert torch.equal(state.y.T, part.y)
        assert torch.equal(state.nfev, part.nfev)


def test_stepper_counts_and_state():
    """Watts' start costs 1 + min(n + 1, 3) evaluations on top of f(t0);
    the twiddle and quit factors start at (1.5, 1.1) and (100, 100)."""
    params = IVPParams(t_bound=5.0, direction=1.0, rtol=1e-4, atol=1e-8,
                       max_step=np.inf)
    st = build_stepper(CKdisc, decay, 1, torch.float64)
    s0 = st.init(0.0, torch.ones(1, 3, dtype=torch.float64), params)
    assert torch.all(s0.nfev == 1 + 1 + 2)
    torch.testing.assert_close(s0.twiddle[:, 0],
                               torch.tensor([1.5, 1.1], dtype=torch.float64))
    torch.testing.assert_close(s0.quit_f[:, 0],
                               torch.full((2,), 100.0, dtype=torch.float64))
    s1 = st.init(0.0, torch.ones(1, 3, dtype=torch.float64), params,
                 first_step=0.1)
    assert torch.all(s1.nfev == 1) and torch.all(s1.h_abs == 0.1)


def test_dense_output_names_its_roadmap_item(jax_results):
    """Dense output (ROADMAP A4b, ported): the f_disc members' order-aware
    free interpolant at 41 times across both switches matches JAX's
    within 1e-10, and the stepper's dense segment is its record
    coefficients."""
    prob, span, y0, kw = CASES["f_disc"]
    te = np.linspace(0.0, 10.0, 41)
    out = solve_ensemble(f_disc, span, torch.tensor(y0), method=CKdisc,
                         t_eval=te, return_state=True, **kw)
    assert np.max(np.abs(out.y_eval.numpy()
                         - jax_results["dense"]["y_eval"])) <= 1e-10
    st = build_stepper(CKdisc, f_disc, 2, torch.float64, carry_stages=True)
    (t_a, h, ya, Q), = st.dense_segments(out.final_state)[0]
    assert torch.equal(Q, st.record_coefficients(out.final_state))
    assert torch.equal(t_a + h, out.t) and torch.equal(ya, out.final_state
                                                       .y_old)


# -- the tableaux -------------------------------------------------------------

RK_LIKE = P.EXPLICIT_METHODS + [CKdisc]


@pytest.mark.parametrize("method", RK_LIKE, ids=lambda m: m.name)
def test_order_conditions(method):
    """The port's explicit tableaux satisfy the rooted-tree conditions at
    their stated orders, main and embedded pair (``tests/test_tableaux.py``
    does the same for the JAX arrays).  Tolerance: 1e-13 per stage."""
    tab = method.tableau
    tol = tab.n_stages * 1e-13
    for q in range(1, min(tab.order, 9) + 1):
        assert np.max(np.abs(rk_residuals(q, tab.B, tab.C, tab.A))) < tol, q
    A2, Bh, C2 = augmented_embedded(tab.A, tab.B, tab.C, tab.E)
    for q in range(1, min(tab.order_secondary, 9) + 1):
        assert np.max(np.abs(rk_residuals(q, Bh, C2, A2))) < tol, q


def _fallback_tableau(i):
    """The fallback of index i (0: 2nd order at c = 1/5, 1: 3rd order at
    3/5) as a Runge-Kutta method of its own step c h: its stages
    rescaled by 1/c, and its main and embedded weight rows (B - E)."""
    d = CKDISC_DATA
    c = d["C_fallback"][i]
    m = 2 if i == 0 else 4
    tab = CKdisc.tableau
    b = d["B_fallback"][i][:m] / c
    return b, b - d["E_fallback"][i][:m] / c, tab.C[:m] / c, tab.A[:m, :m] / c


@pytest.mark.parametrize("i,order,embedded", [(0, 2, 1), (1, 3, 2)])
def test_fallback_rows_order_conditions(i, order, embedded):
    """CKdisc's fallback solutions are Runge-Kutta methods of at least
    orders 2 and 3 (the 3rd-order one meets the 4th-order conditions too),
    with embedded orders 1 and 2, over the part of the step they advance."""
    b, bh, c, A = _fallback_tableau(i)
    for q in range(1, order + 1):
        assert np.max(np.abs(rk_residuals(q, b, c, A))) < 1e-13, q
    for q in range(1, embedded + 1):
        assert np.max(np.abs(rk_residuals(q, bh, c, A))) < 1e-13, q
    assert np.max(np.abs(rk_residuals(embedded + 1, bh, c, A))) > 1e-6


@pytest.mark.parametrize("k,stages,order", [(0, 2, 2), (1, 4, 3)])
def test_assessment_rows_order_conditions(k, stages, order):
    """The staged assessments compare solutions of orders 2 and 1 after
    two stages (E1) and 3 and 2 after four (E2)."""
    tab = CKdisc.tableau
    b = CKDISC_DATA["B_assess"][k][:stages]
    lower = b - CKDISC_DATA["E_assess"][k][:stages]
    A, c = tab.A[:stages, :stages], tab.C[:stages]
    for w, p in ((b, order), (lower, order - 1)):
        for q in range(1, p + 1):
            assert np.max(np.abs(rk_residuals(q, w, c, A))) < 1e-13, q
        assert np.max(np.abs(rk_residuals(p + 1, w, c, A))) > 1e-6
