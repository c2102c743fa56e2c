"""Complex states in the port's f64 driver against the JAX package.

``core.numerics.norm`` is complex-safe as JAX's is (and the real norm
keeps its arithmetic, bit for bit); the ESDIRK autodiff Jacobian of a
holomorphic RHS equals JAX's ``jacfwd(holomorphic=True)``.  Seeded
complex128 ensembles run through ``solve_ensemble`` in both packages: BS5
and CKdisc on a nonlinear holomorphic system, Fi5N on a complex
second-order system, TRBDF2 and KC3I with a callable and with a constant
complex Jacobian, SWAG, and BS5 and TRBDF2 again with ``t_eval`` and an
event on the real part of a component.  The JAX side runs in two subprocesses without FMA
(``tests/jax_reference.py``).  Gates: status, nsteps, nfev and nfailed
identical per member; endpoints, ``y_eval`` and event states within
1e-10 relative to max(1, |y|); event times within 1e-10.  SSV2stab
refuses complex states with the JAX stepper's ``ValueError``.
"""
import functools
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extensisq_tpu as X
from extensisq_tpu.core.numerics import norm as jax_norm

import extensisq_tpu_torch as P
from extensisq_tpu_torch.core.numerics import norm
from extensisq_tpu_torch.steppers.esdirk import jacfwd
from jax_reference import run_jax

COUNTERS = ("status", "nsteps", "nfev", "nfailed")
GATE = 1e-10
LAM = -1.0 + 3.0j
A_LIN = np.array([[-1.0 + 2.0j, 0.5], [0.1j, -3.0]])


def _close(a, b):
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))) <= GATE


def test_norm_matches_jax():
    rng = np.random.default_rng(3)
    real = rng.standard_normal((7, 5))
    cplx = real + 1j * rng.standard_normal((7, 5))
    for x in (real, cplx):
        got = norm(torch.tensor(x)).numpy()
        want = np.array([float(jax_norm(jnp.asarray(x[:, b])))
                         for b in range(5)])
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    # the real path keeps its arithmetic
    xr = torch.tensor(real)
    assert torch.equal(norm(xr), torch.sqrt((xr * xr).sum(0) / 7))
    assert norm(torch.tensor(cplx)).dtype == torch.float64


def test_holomorphic_jacobian_matches_jax():
    """The ESDIRK stepper's autodiff Jacobian of a holomorphic RHS (one
    JVP a column, complex seeds) equals JAX's ``jacfwd(holomorphic=True)``
    member by member."""

    def jax_fun(y):
        return jnp.stack([LAM * y[0] + 0.3j * y[1] ** 2,
                          -(1 + 0.5j) * y[1] + jnp.sin(y[0])])

    got = jacfwd(nonlinear, 2)(torch.zeros(6, dtype=torch.float64),
                               torch.tensor(Y0.T)).numpy()
    want = np.stack([np.asarray(jax.jacfwd(jax_fun, holomorphic=True)(
        jnp.asarray(y))) for y in Y0])
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


def nonlinear(t, y):
    return torch.stack([LAM * y[0] + 0.3j * y[1] ** 2,
                        -(1 + 0.5j) * y[1] + torch.sin(y[0])])


def second_order(t, y):
    return torch.stack([y[1], -(1 + 0.2j) * y[0]])


def linear(t, y):
    return torch.as_tensor(A_LIN, device=y.device) @ y


def spiral(t, y):
    return torch.stack([(-0.5 + 2j) * y[0], -y[1] + 0.1 * y[0]])


def real_part(t, y):
    return y[0].real


_RNG = np.random.default_rng(7)
Y0 = (_RNG.standard_normal((6, 2)) + 1j * _RNG.standard_normal((6, 2))) * .5
TE = np.linspace(0.0, 3.0, 7)
TIGHT = dict(rtol=1e-6, atol=1e-9)
# name -> (problem, method, span, options); "jac": "call" or "const"
CASES = {
    "BS5": ("nonlinear", "BS5", (0.0, 2.0), TIGHT),
    "CKdisc": ("nonlinear", "CKdisc", (0.0, 2.0), TIGHT),
    "Fi5N": ("second_order", "Fi5N", (0.0, 3.0), dict(rtol=1e-7,
                                                      atol=1e-9)),
    "SWAG": ("nonlinear", "SWAG", (0.0, 2.0), dict(TIGHT, k_max=6)),
    "TRBDF2-autodiff": ("nonlinear", "TRBDF2", (0.0, 2.0), TIGHT),
    "TRBDF2-call": ("linear", "TRBDF2", (0.0, 2.0), dict(TIGHT, jac="call")),
    "TRBDF2-const": ("linear", "TRBDF2", (0.0, 2.0),
                     dict(TIGHT, jac="const")),
    "KC3I-call": ("linear", "KC3I", (0.0, 2.0), dict(TIGHT, jac="call")),
    "KC3I-const": ("linear", "KC3I", (0.0, 2.0), dict(TIGHT, jac="const")),
    "BS5-traj": ("spiral", "BS5", (0.0, 3.0), dict(TIGHT, traj=True)),
    "TRBDF2-traj": ("spiral", "TRBDF2", (0.0, 3.0), dict(TIGHT, traj=True)),
}
PROBLEMS = {"nonlinear": nonlinear, "second_order": second_order,
            "linear": linear, "spiral": spiral}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X

    inputs = np.load(sys.argv[1])
    A = jnp.asarray(inputs["A"])
    problems = {
        "nonlinear": lambda t, y: jnp.stack(
            [(%r) * y[0] + 0.3j * y[1] ** 2,
             -(1 + 0.5j) * y[1] + jnp.sin(y[0])]),
        "second_order": lambda t, y: jnp.stack([y[1], -(1 + 0.2j) * y[0]]),
        "linear": lambda t, y: A @ y,
        "spiral": lambda t, y: jnp.stack([(-0.5 + 2j) * y[0],
                                          -y[1] + 0.1 * y[0]]),
    }
    out = {}
    for name, c in json.loads(sys.argv[2]).items():
        kw = dict(c["kw"])
        jac = kw.pop("jac", None)
        if jac == "call":
            kw["jac"] = lambda t, y: A
        elif jac == "const":
            kw["jac"] = np.asarray(inputs["A"])
        fields = ["y"]
        if kw.pop("traj", False):
            kw["t_eval"] = jnp.asarray(inputs["te"])
            kw["events"] = lambda t, y: jnp.real(y[0])
            fields += ["y_eval", "t_events", "y_events", "n_events"]
        res = X.solve_ensemble(problems[c["problem"]], tuple(c["span"]),
                               jnp.asarray(inputs["y0"]),
                               method=getattr(X, c["method"]), **kw)
        for f in fields + ["status", "nsteps", "nfev", "nfailed"]:
            out[name + "/" + f] = np.asarray(getattr(res, f))
    np.savez(sys.argv[3], **out)
""" % LAM)


@functools.lru_cache(maxsize=None)
def _run(name):
    prob, method, span, kw = CASES[name]
    kw = dict(kw)
    jac = kw.pop("jac", None)
    if jac == "call":
        kw["jac"] = lambda t, y: torch.as_tensor(A_LIN)
    elif jac == "const":
        kw["jac"] = A_LIN
    if kw.pop("traj", False):
        kw.update(t_eval=TE, events=real_part)
    return P.solve_ensemble(PROBLEMS[prob], span, torch.tensor(Y0),
                            method=method, **kw)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_complex")
    np.savez(d / "in.npz", y0=Y0, A=A_LIN, te=TE)
    spec = {k: dict(problem=v[0], method=v[1], span=list(v[2]), kw=v[3])
            for k, v in CASES.items()}
    names = list(CASES)
    return run_jax(_JAX_SCRIPT, d, [{k: spec[k] for k in names[i::2]}
                                    for i in range(2)],
                   [lambda k=k: _run(k) for k in names])


@pytest.mark.parametrize("name", list(CASES))
def test_complex_solve_matches_jax(jax_results, name):
    res = _run(name)
    assert res.y.dtype == torch.complex128
    assert torch.all(res.status == 1)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      jax_results[f"{name}/{f}"], err_msg=f)
    assert _close(res.y.numpy(), jax_results[name + "/y"])
    if "traj" in CASES[name][3]:
        np.testing.assert_array_equal(res.n_events.numpy(),
                                      jax_results[name + "/n_events"])
        assert res.n_events.sum() > 0
        assert _close(res.y_eval.numpy(), jax_results[name + "/y_eval"])
        te, ye = res.t_events.numpy(), res.y_events.numpy()
        jte, jye = (jax_results[name + "/t_events"],
                    jax_results[name + "/y_events"])
        hit = np.isfinite(jte)
        np.testing.assert_array_equal(np.isfinite(te), hit)
        assert np.max(np.abs(te[hit] - jte[hit])) <= GATE
        assert _close(ye[hit], jye[hit])


def test_complex_windowed_and_record():
    """``solve_windowed`` on a complex ensemble equals the single shot bit
    for bit; a saved trajectory evaluates complex."""
    one = _run("TRBDF2-autodiff")
    win = P.solve_windowed(nonlinear, (0.0, 2.0), torch.tensor(Y0), 3,
                           method="TRBDF2", ensemble=True, **TIGHT)
    for f in ("y",) + COUNTERS:
        assert torch.equal(getattr(win, f), getattr(one, f)), f
    sol = P.solve(nonlinear, (0.0, 2.0), torch.tensor(Y0[0]), method="BS5",
                  save_steps=True, **TIGHT)
    assert sol.ys.dtype == torch.complex128
    dense = sol.ode_solution()(torch.tensor([2.0]))
    assert torch.allclose(dense[:, 0], sol.y, rtol=0, atol=1e-12)


def test_rkc_refuses_complex_as_jax():
    with pytest.raises(ValueError) as port:
        P.solve(lambda t, y: -y, (0.0, 1.0),
                torch.tensor([0.5 + 1j], dtype=torch.complex128),
                method="SSV2stab")
    with pytest.raises(ValueError) as ref:
        X.solve(lambda t, y: -y, (0.0, 1.0), jnp.asarray([0.5 + 1j]),
                method=X.SSV2stab)
    assert str(port.value) == str(ref.value)
