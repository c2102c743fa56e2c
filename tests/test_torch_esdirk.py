"""The port's ESDIRK family (f64 driver) against the JAX package.

Both packages integrate the same seeded members on the CPU: stiff
Robertson kinetics, the rational problem of extensisq's tests (with an
analytic and an autodiff Jacobian, forward and backward), a linear
problem with a constant Jacobian, the index-1 pendulum DAE (diagonal M)
and the Kaps DAE with diagonal, dense and hidden mass matrices.  In
float64 the round-off of the two libraries sits below every decision of
the Newton iteration and the controller, so the work counters are
identical per member and the endpoints agree to 1e-10.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extensisq_tpu as X
from extensisq_tpu import methods as jax_methods
from extensisq_tpu.core import controller as jctl
from extensisq_tpu.core.hstart import h_start as jax_h_start
from extensisq_tpu.core.linalg import gauss_solve as jax_gauss_solve
from extensisq_tpu.steppers import build_stepper as jax_build_stepper
from extensisq_tpu.types import IVPParams as JaxParams

import extensisq_tpu_torch as P
from extensisq_tpu_torch.core import controller as pctl
from extensisq_tpu_torch.core.hstart import h_start as port_h_start
from extensisq_tpu_torch.core.linalg import gauss_solve
from extensisq_tpu_torch.steppers import build_stepper
from extensisq_tpu_torch.types import IVPParams

NAMES = ["TRBDF2", "TRX2", "HS2I", "HS2Ia", "KC3I", "KC4I", "KC4Ia", "Kv3I"]
COUNTERS = ("status", "nsteps", "nfev", "nfailed")
REL = 1e-14
G = 9.81


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


# -- problems, in both packages --------------------------------------------

def rob_jax(t, y):
    return jnp.stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                      0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                      3e7 * y[1] ** 2])


def rob_torch(t, y):
    return torch.stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                        0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                        3e7 * y[1] ** 2])


def rational_jax(t, y):
    return jnp.stack([y[1] / t,
                      y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def rational_torch(t, y):
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def rational_jac_jax(t, y):
    return jnp.array([
        [0.0, 1 / t],
        [-y[1] ** 2 / (t * (y[0] - 1) ** 2),
         (y[0] + 4 * y[1] - 1) / (t * (y[0] - 1))]])


def rational_jac_torch(t, y):
    """The rows-first (n, n, B) Jacobian of ``rational_torch``."""
    zero = torch.zeros_like(t)
    return torch.stack([
        torch.stack([zero, 1 / t]),
        torch.stack([-y[1] ** 2 / (t * (y[0] - 1) ** 2),
                     (y[0] + 4 * y[1] - 1) / (t * (y[0] - 1))])])


def kaps_jax(t, y):
    return jnp.stack([-y[0] + y[1] ** 2, y[0] - y[1] - y[1] ** 2])


def kaps_torch(t, y):
    return torch.stack([-y[0] + y[1] ** 2, y[0] - y[1] - y[1] ** 2])


def kaps_jac_torch(t, y):
    one = torch.ones_like(t)
    return torch.stack([torch.stack([-one, 2 * y[1]]),
                        torch.stack([one, -1 - 2 * y[1]])])


def kaps_jac_jax(t, y):
    return jnp.array([[-1.0, 2 * y[1]], [1.0, -1 - 2 * y[1]]])


def pend_jax(t, s):
    x, ya, vx, vy, lam = s[0], s[1], s[2], s[3], s[4]
    return jnp.stack([vx, vy, -lam * x, -lam * ya - G,
                      vx ** 2 + vy ** 2 - lam * (x ** 2 + ya ** 2) - G * ya])


def pend_torch(t, s):
    x, ya, vx, vy, lam = s[0], s[1], s[2], s[3], s[4]
    return torch.stack([vx, vy, -lam * x, -lam * ya - G,
                        vx ** 2 + vy ** 2 - lam * (x ** 2 + ya ** 2)
                        - G * ya])


_HID = np.random.RandomState(42).rand(2, 2) + np.eye(2)
M_KAPS = np.array([[0.0, 0.0], [0.0, 1.0]])
M_PEND = np.diag([1.0, 1.0, 1.0, 1.0, 0.0])
M_NONSING = np.array([[1e-3, 0.0], [0.5, 1.0]])


def kaps_hidden_jax(t, y):
    return jnp.asarray(_HID) @ kaps_jax(t, y)


def kaps_hidden_torch(t, y):
    return torch.tensor(_HID) @ kaps_torch(t, y)


def _pend_members(b=12):
    th = np.linspace(0.3, 0.7, b)
    return np.stack([np.sin(th), -np.cos(th), np.zeros(b), np.zeros(b),
                     np.zeros(b)], axis=1), th


def _members(case, b=12):
    rng = np.random.default_rng(11)
    if case == "rob":
        return np.stack([rng.uniform(0.9, 1.1, b), np.zeros(b),
                         np.zeros(b)], axis=1)
    if case == "rational":
        return np.array([1 / 3, 2 / 9]) * rng.uniform(0.98, 1.02, (b, 1))
    if case == "linear":
        return rng.uniform(0.5, 1.5, (b, 2))
    if case == "kaps":
        return np.stack([rng.uniform(0.5, 2.0, b), np.ones(b)], axis=1)
    if case == "pend":
        return _pend_members(b)[0]
    raise ValueError(case)


A_LIN = np.array([[-1.0, 3.0], [0.0, -2.0]])

# name -> (jax fun, torch fun, span, members, method, tolerances, jax
# options, port options)
CASES = {
    "rob-Kv3I": (rob_jax, rob_torch, (0.0, 10.0), "rob", "Kv3I",
                 (1e-6, 1e-9), {}, {}),
    "rob-TRBDF2": (rob_jax, rob_torch, (0.0, 10.0), "rob", "TRBDF2",
                   (1e-6, 1e-9), {}, {}),
    "rob-KC4I": (rob_jax, rob_torch, (0.0, 10.0), "rob", "KC4I",
                 (1e-6, 1e-9), {}, {}),
    "rational-fwd-jac": (rational_jax, rational_torch, (5.0, 9.0),
                         "rational", "KC3I", (1e-5, 1e-8),
                         {"jac": rational_jac_jax},
                         {"jac": rational_jac_torch}),
    "rational-bwd-jac": (rational_jax, rational_torch, (5.0, 1.0),
                         "rational", "TRX2", (1e-5, 1e-8),
                         {"jac": rational_jac_jax},
                         {"jac": rational_jac_torch}),
    "rational-fwd-ad": (rational_jax, rational_torch, (5.0, 9.0),
                        "rational", "KC4Ia", (1e-5, 1e-8), {}, {}),
    "rational-bwd-ad": (rational_jax, rational_torch, (5.0, 1.0),
                        "rational", "Kv3I", (1e-5, 1e-8), {}, {}),
    "linear-const-jac": (lambda t, y: jnp.asarray(A_LIN) @ y,
                         lambda t, y: torch.tensor(A_LIN) @ y, (0.0, 2.0),
                         "linear", "TRBDF2", (1e-6, 1e-9), {"jac": A_LIN},
                         {"jac": A_LIN}),
    "pendulum-dae": (pend_jax, pend_torch, (0.0, 1.0), "pend", "Kv3I",
                     (1e-6, 1e-8), {"M": M_PEND}, {"M": M_PEND}),
    "kaps-diag-M-jac": (kaps_jax, kaps_torch, (0.0, 1.0), "kaps", "KC4I",
                        (1e-5, 1e-8), {"M": np.diag(M_KAPS),
                                       "jac": kaps_jac_jax},
                        {"M": np.diag(M_KAPS), "jac": kaps_jac_torch}),
    "kaps-dense-M": (kaps_jax, kaps_torch, (0.0, 1.0), "kaps", "Kv3I",
                     (1e-5, 1e-8), {"M": M_KAPS}, {"M": M_KAPS}),
    "kaps-hidden-M": (kaps_hidden_jax, kaps_hidden_torch, (0.0, 1.0),
                      "kaps", "TRBDF2", (1e-5, 1e-8),
                      {"M": _HID @ M_KAPS}, {"M": _HID @ M_KAPS}),
    "kaps-nonsingular-M": (kaps_jax, kaps_torch, (0.0, 1.0), "kaps", "KC3I",
                           (1e-5, 1e-8), {"M": M_NONSING},
                           {"M": M_NONSING}),
}


def _run_both(name):
    fj, ft, span, members, meth, (rtol, atol), jopt, popt = CASES[name]
    y0 = _members(members)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax.jit(lambda Y: X.solve_ensemble(
            fj, span, Y, method=getattr(X, meth), rtol=rtol, atol=atol,
            **jopt))(jnp.asarray(y0))
    port = P.solve_ensemble(ft, span, torch.tensor(y0), method=meth,
                            rtol=rtol, atol=atol, **popt)
    return port, ref


@pytest.mark.parametrize("name", list(CASES))
def test_ensemble_matches_jax(name):
    port, ref = _run_both(name)
    assert np.all(np.asarray(ref.status) == 1)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert np.max(np.abs(port.y.numpy() - np.asarray(ref.y))) <= 1e-10


# -- data and shared numerics ----------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_tableaux_equal_jax(name):
    pm, jm = P.METHODS_BY_NAME[name], X.METHODS_BY_NAME[name]
    assert (pm.family, pm.name) == (jm.family, jm.name)
    assert pm.options == jm.options
    pt, jt = pm.tableau, jm.tableau
    for f in ("A", "B", "C", "E", "Az", "P"):
        a, b = getattr(pt, f), getattr(jt, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    for f in ("name", "order", "order_secondary", "d", "kappa",
              "filter_error", "piecewise_cubic_dense", "sc_params",
              "n_stages"):
        assert getattr(pt, f) == getattr(jt, f), f
    assert pt.c_spacing() == jt.c_spacing()
    pi, ji = pt.interpolants or {}, jt.interpolants or {}
    assert pi.keys() == ji.keys()
    for k in ji:
        assert np.array_equal(pi[k], ji[k]), k
    assert [m.name for m in P.ESDIRK_METHODS] == \
        [m.name for m in jax_methods.ESDIRK_METHODS]
    assert [m.tableau.n_stages for m in P.ESDIRK_METHODS] == [3, 3, 5, 6,
                                                             7, 4]


@pytest.mark.parametrize("sc", ["G", "S", "standard", (0.5, -0.1, 0.2, 0.8)])
def test_implicit_controller_matches_jax(sc):
    cc_j = jctl.resolve_controller(sc, "G", -1 / 3, implicit=True)
    cc_p = pctl.resolve_controller(sc, "G", -1 / 3, implicit=True)
    assert tuple(cc_p) == tuple(cc_j)
    rng = np.random.default_rng(5)
    b = 256
    err = 10.0 ** rng.uniform(-22, 1, b)
    args = (err, 10.0 ** rng.uniform(-8, 1, b),
            np.where(np.arange(b) % 17 == 0, 0.0, rng.uniform(0.1, 4.0, b)),
            rng.uniform(size=b) < 0.3, rng.uniform(size=b) < 0.5,
            np.where(rng.uniform(size=b) < 0.5, 10.0, 4.0))
    ref = jax.vmap(lambda *a: jctl.esdirk_accept_update(cc_j, 1e-20, *a))(
        *(jnp.asarray(v) for v in args))
    got = pctl.esdirk_accept_update(cc_p, 1e-20,
                                    *(torch.tensor(v) for v in args))
    assert _rel(got[0].numpy(), ref[0]) <= REL
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_h_start_dae_short_cuts_match_jax():
    """``T`` replaces the time probe, ``J`` the Lipschitz probes and
    ``returnT`` returns the df/dt estimate, as in the JAX function."""
    rng = np.random.default_rng(6)
    b, n = 32, 3
    y0 = rng.uniform(-2.0, 2.0, (b, n))
    yp = rng.standard_normal((b, n))
    T = rng.standard_normal((b, n))
    J = rng.standard_normal((b, n, n))
    a = rng.uniform(-1.0, 1.0, b)
    span = rng.uniform(0.5, 5.0, b)
    Mx = rng.standard_normal((n, n))

    def fj(t, y):
        return jnp.sin(t) + jnp.asarray(Mx) @ y

    def fp(t, y):
        return torch.sin(t) + torch.tensor(Mx) @ y

    ta, tb = torch.tensor(a), torch.tensor(a + span)
    yt, ypt = torch.tensor(y0.T).contiguous(), torch.tensor(yp.T).contiguous()
    ref = jax.vmap(lambda y, d, t0, dt, Ti, Ji: jax_h_start(
        fj, t0, t0 + dt, y, d, 2, 1e-5, 1e-8, J=Ji, T=Ti))(
        *(jnp.asarray(v) for v in (y0, yp, a, span, T, J)))
    got = port_h_start(fp, ta, tb, yt, ypt, 2, 1e-5, 1e-8,
                       J=torch.tensor(J), T=torch.tensor(T.T))
    assert _rel(got.numpy(), ref) <= REL
    ref = jax.vmap(lambda y, d, t0, dt: jax_h_start(
        fj, t0, t0 + dt, y, d, None, 1e-5, 1e-8, returnT=True))(
        *(jnp.asarray(v) for v in (y0, yp, a, span)))
    got = port_h_start(fp, ta, tb, yt, ypt, None, 1e-5, 1e-8, returnT=True)
    assert _rel(got.numpy().T, ref) <= REL


def test_gauss_solve_matches_jax():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((16, 4, 4))
    A[3, 0, 0] = 0.0                   # a zero leading pivot
    A[5, 1:, 0] = A[5, 0, 0]           # ties: the first largest wins
    b = rng.standard_normal((16, 4))
    Bm = rng.standard_normal((16, 4, 3))
    ref = jax.vmap(jax_gauss_solve)(jnp.asarray(A), jnp.asarray(b))
    got = gauss_solve(torch.tensor(A), torch.tensor(b))
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-12
    ref = jax.vmap(jax_gauss_solve)(jnp.asarray(A), jnp.asarray(Bm))
    got = gauss_solve(torch.tensor(A), torch.tensor(Bm))
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-12


# -- DAE projection, stepping and counters ---------------------------------

def _params(tf, rtol, atol):
    return (IVPParams(t_bound=tf, direction=1.0, rtol=rtol, atol=atol,
                      max_step=np.inf),
            JaxParams(t_bound=jnp.asarray(tf), direction=jnp.asarray(1.0),
                      rtol=jnp.asarray(rtol), atol=jnp.asarray(atol),
                      max_step=jnp.asarray(np.inf)))


def test_pendulum_projection_matches_jax():
    """The consistent-IC projection gives lambda0 = g cos(theta0) (v = 0
    at t0), and the initial state equals the JAX stepper's."""
    y0, th = _pend_members()
    params, jparams = _params(1.0, 1e-6, 1e-8)
    st = build_stepper(P.Kv3I, pend_torch, 5, torch.float64, M=M_PEND).init(
        0.0, torch.tensor(y0.T).contiguous(), params)
    np.testing.assert_allclose(st.y[4].numpy(), G * np.cos(th), rtol=1e-6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jst = jax_build_stepper(X.Kv3I, pend_jax, 5, np.float64, M=M_PEND)
    js = jax.jit(jax.vmap(lambda y: jst.init(0.0, y, jparams)))(
        jnp.asarray(y0))
    assert np.max(np.abs(st.y.numpy().T - np.asarray(js.y))) <= 1e-12
    assert np.max(np.abs(st.yp.numpy().T - np.asarray(js.yp))) <= 1e-10
    assert _rel(st.h_abs.numpy(), js.h_abs) <= 1e-12
    assert _rel(st.J.numpy(), js.J) <= 1e-12


@pytest.mark.parametrize("name,meth", [("rob", "TRBDF2"), ("pend", "Kv3I"),
                                       ("rob-each", "KC3I")])
def test_step_counters_match_jax(name, meth):
    """``step`` against the JAX stepper's ``step`` (vmapped), member by
    member: the Jacobian evaluations, LU factorizations, linear solves and
    Newton failures agree as well as the counters solve_ensemble reports."""
    members = "pend" if name == "pend" else "rob"
    y0 = _members(members)
    fj, ft = (pend_jax, pend_torch) if name == "pend" else (rob_jax,
                                                            rob_torch)
    opt = {"M": M_PEND} if name == "pend" else {}
    if name == "rob-each":
        opt["jac_each_step"] = True
    n = y0.shape[1]
    params, jparams = _params(10.0, 1e-6, 1e-9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jst = jax_build_stepper(getattr(X, meth), fj, n, np.float64, **opt)
    js = jax.jit(jax.vmap(lambda y: jst.init(0.0, y, jparams)))(
        jnp.asarray(y0))
    jstep = jax.jit(jax.vmap(lambda s: jst.step(jparams, s)))
    stepper = build_stepper(getattr(P, meth), ft, n, torch.float64, **opt)
    st = stepper.init(0.0, torch.tensor(y0.T).contiguous(), params)
    for k in range(1, 13):
        st = stepper.step(params, st)
        js = jstep(js)
        for f in ("status", "nsteps", "nfev", "njev", "nlu", "nls", "nfi",
                  "nfailed", "Niter", "current_J", "LU_valid"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{f} at step {k}")
        assert np.max(np.abs(st.y.numpy().T - np.asarray(js.y))) <= 1e-10
        assert _rel(st.h_abs.numpy(), js.h_abs) <= 1e-8


def test_solve_matches_ensemble_member():
    y0 = torch.tensor(_members("rob"))
    ens = P.solve_ensemble(rob_torch, (0.0, 10.0), y0, method="Kv3I",
                           rtol=1e-6, atol=1e-9)
    for i in (0, 7):
        one = P.solve(rob_torch, (0.0, 10.0), y0[i], method="Kv3I",
                      rtol=1e-6, atol=1e-9)
        for f in COUNTERS:
            assert int(getattr(one, f)) == int(getattr(ens, f)[i])
        assert torch.allclose(one.y, ens.y[i], rtol=0.0, atol=1e-12)


@pytest.mark.parametrize("option", ["bands", "jac_sparsity"])
def test_banded_options_name_roadmap_item(option):
    with pytest.raises(NotImplementedError, match="ROADMAP item A8b"):
        P.solve_ensemble(rob_torch, (0.0, 1.0),
                         torch.tensor(_members("rob")), method="Kv3I",
                         **{option: (1, 1)})


def test_complex_states_raise():
    with pytest.raises(NotImplementedError, match="complex"):
        P.solve(lambda t, y: -y, (0.0, 1.0),
                torch.tensor([0.5 + 1j]), method="TRBDF2")
