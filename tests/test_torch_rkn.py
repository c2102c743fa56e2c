"""The port's Runge-Kutta-Nystrom methods and f64 stepper against the JAX
package.

The four tableaux (Fi4N, Fi5N, Mu5Nmb, MR6NN) are pinned equal to the JAX
arrays, dense-output data included, and checked against the order
conditions of ``tests/order_oracle.py``.  ``solve_ensemble`` integrates the
same Kepler orbits (ecc in [0.1, 0.7], t in [0, 2 pi], rtol 1e-9 / atol
1e-12, as BASELINE config 3) and a discrete wave with per-member speeds in
both packages on the CPU.  In float64 the two libraries' round-off sits
far below every accept/reject decision (XLA's FMA and its compiled pow
included, on these problems), so status, nsteps, nfev and nfailed must be
identical per member and the endpoints agree to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extensisq_tpu as X
from order_oracle import rkn_residuals, srkn_residuals

import extensisq_tpu_torch as P
from extensisq_tpu_torch import solve, solve_ensemble
from extensisq_tpu_torch.steppers import build_stepper

NAMES = ["Fi4N", "Fi5N", "Mu5Nmb", "MR6NN"]
ARRAYS = ("A", "B", "C", "E", "Ap", "Bp", "Ep", "P", "Pp")
SCALARS = ("name", "order", "order_secondary", "stbre", "stbim", "tanang",
           "sc_params", "n_stages", "fsal", "velocity_independent")
COUNTERS = ("status", "nsteps", "nfev", "nfailed")
B = 24
N_WAVE = 16


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", NAMES)
def test_tableaux_equal_jax(name):
    pm, jm = P.METHODS_BY_NAME[name], X.METHODS_BY_NAME[name]
    assert (pm.family, pm.name, pm.options) == (jm.family, jm.name,
                                                jm.options)
    pt, jt = pm.tableau, jm.tableau
    for f in ARRAYS:
        assert _same(getattr(pt, f), getattr(jt, f)), f
    for f in SCALARS:
        assert getattr(pt, f) == getattr(jt, f), f
    assert pt.c_spacing() == jt.c_spacing()
    pi, ji = pt.interpolants or {}, jt.interpolants or {}
    assert pi.keys() == ji.keys()
    for key, spec in ji.items():
        if spec is None:
            assert pi[key] is None
            continue
        assert spec.keys() == pi[key].keys()
        for field, value in spec.items():
            assert _same(pi[key][field], value), (key, field)
    from extensisq_tpu.methods import RKN_METHODS
    assert [m.name for m in P.RKN_METHODS] == [m.name for m in RKN_METHODS]


def _augmented(tab):
    """The (s+1)-stage tableau of the embedded pair: (Bp, B, C, A, Ap)."""
    s = tab.n_stages
    E, Ep = np.asarray(tab.E, float), np.asarray(tab.Ep, float)
    A2 = np.zeros((Ep.size, Ep.size))
    A2[:s, :s] = tab.A
    A2[-1, :-1] = tab.B
    Ap2 = np.zeros_like(A2)
    if tab.Ap is not None:
        Ap2[:s, :s] = tab.Ap
    Ap2[-1, :-1] = tab.Bp
    C2 = np.ones(Ep.size)
    C2[:-1] = tab.C
    Bh = Ep.copy()
    Bh[:-1] += tab.Bp
    betah = E.copy()
    betah[:-1] += tab.B
    return Bh, betah, C2, A2, Ap2


@pytest.mark.parametrize("name", NAMES)
def test_order_conditions(name):
    """The port's tableaux satisfy the Nystrom order conditions at their
    stated orders (velocity order p, position order p - 1 at least), the
    main and the embedded pair; MR6NN (velocity independent) by the strict
    RKN trees.  Tolerance: 1e-13 per stage, the conditions' round-off."""
    tab = P.METHODS_BY_NAME[name].tableau
    tol = tab.n_stages * 1e-13
    Bh, betah, C2, A2, Ap2 = _augmented(tab)
    pairs = [(tab.order, (tab.Bp, tab.B, tab.C, tab.A, tab.Ap)),
             (tab.order_secondary, (Bh, betah, C2, A2, Ap2))]
    for order, (bp, b, c, a, ap) in pairs:
        for q in range(1, min(order, 7) + 1):
            if tab.velocity_independent:
                rv, ru = srkn_residuals(q, bp, b, c, a)
            else:
                rv, ru = rkn_residuals(q, bp, b, c, a, ap)
            assert np.max(np.abs(rv)) < tol, (order, q, "velocity")
            if q < order:
                assert np.max(np.abs(ru)) < tol, (order, q, "position")


def kepler_jax(t, y):
    r2 = y[0] ** 2 + y[1] ** 2
    a = -r2 ** -1.5
    return jnp.stack([y[2], y[3], a * y[0], a * y[1]])


def kepler_torch(t, y):
    r2 = y[0] ** 2 + y[1] ** 2
    a = -r2 ** -1.5
    return torch.stack([y[2], y[3], a * y[0], a * y[1]])


def kepler_y0(b):
    ecc = np.linspace(0.1, 0.7, b)
    return np.stack([1 - ecc, np.zeros(b), np.zeros(b),
                     np.sqrt((1 + ecc) / (1 - ecc))], axis=1)


def _jax_ensemble(fun, span, y0, method, params=None, **kw):
    run = jax.jit(lambda Y, p: X.solve_ensemble(
        fun, span, Y, params_batch=p, method=method, **kw))
    return run(jnp.asarray(y0),
               None if params is None else jnp.asarray(params))


def _assert_same(port, ref, y_tol=1e-10):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert np.all(np.asarray(ref.status) == 1)
    assert np.max(np.abs(port.y.numpy() - np.asarray(ref.y))) <= y_tol


@pytest.mark.parametrize("forward", [True, False],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("name", NAMES)
def test_kepler_ensemble_matches_jax(name, forward):
    """Fi4N and MR6NN are non-FSAL (zero Ep tail: one endpoint evaluation
    per accepted step), Fi5N and Mu5Nmb FSAL; Mu5Nmb damps its embedded
    estimate by 0.75 (its default option)."""
    span = (0.0, 2 * np.pi) if forward else (2 * np.pi, 0.0)
    y0 = kepler_y0(B)
    ref = _jax_ensemble(kepler_jax, span, y0, getattr(X, name), rtol=1e-9,
                        atol=1e-12)
    port = solve_ensemble(kepler_torch, span, torch.tensor(y0), method=name,
                          rtol=1e-9, atol=1e-12)
    _assert_same(port, ref)


def wave_jax(t, y, p):
    u = y[:N_WAVE]
    a = p[0] * (jnp.roll(u, 1) + jnp.roll(u, -1) - 2.0 * u)
    return jnp.concatenate([y[N_WAVE:], a])


def wave_torch(t, y, p):
    u = y[:N_WAVE]
    a = p[0] * (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) - 2.0 * u)
    return torch.cat([y[N_WAVE:], a])


def wave_y0(b):
    x = np.linspace(0, 1, N_WAVE, endpoint=False)
    u0 = np.linspace(0.5, 1.5, b)[:, None] * np.sin(2 * np.pi * x)[None, :]
    return np.concatenate([u0, np.zeros_like(u0)], axis=1)


@pytest.mark.parametrize("name", ["Fi5N", "MR6NN"])
def test_wave_with_params_batch_matches_jax(name):
    """A 16-position periodic wave, u'' = c2 (u[i+1] + u[i-1] - 2 u[i]),
    with its own c2 per member through ``params_batch``."""
    y0 = wave_y0(12)
    c2 = np.linspace(20.0, 60.0, 12)[:, None]
    kw = dict(rtol=1e-6, atol=1e-9)
    ref = _jax_ensemble(wave_jax, (0.0, 1.0), y0, getattr(X, name),
                        params=c2, **kw)
    port = solve_ensemble(wave_torch, (0.0, 1.0), torch.tensor(y0),
                          params_batch=torch.tensor(c2), method=name, **kw)
    _assert_same(port, ref)


def test_solve_matches_ensemble_member():
    """``solve`` on one member takes that member's steps in the ensemble;
    the endpoints agree to 1e-12, not bit for bit, since PyTorch's
    vectorised CPU kernels round by the batch's shape."""
    y0 = torch.tensor(kepler_y0(B))
    ens = solve_ensemble(kepler_torch, (0.0, 2 * np.pi), y0, method="Fi5N",
                         rtol=1e-9, atol=1e-12)
    for i in (0, B - 1):
        one = solve(kepler_torch, (0.0, 2 * np.pi), y0[i], method=P.Fi5N,
                    rtol=1e-9, atol=1e-12)
        for f in COUNTERS:
            assert int(getattr(one, f)) == int(getattr(ens, f)[i])
        assert (one.y - ens.y[i]).abs().max() <= 1e-12


def test_odd_state_raises():
    with pytest.raises(ValueError, match="second order problems"):
        build_stepper(P.Fi5N, kepler_torch, 3, torch.float64)
    with pytest.raises(ValueError, match="second order problems"):
        solve_ensemble(lambda t, y: y, (0.0, 1.0), torch.ones(2, 3),
                       method="Fi4N")


def test_mu5nmb_damping_is_an_option():
    """Mu5Nmb's 0.75 damping of E/Ep comes from its options and can be
    switched off per solve, as in the JAX stepper."""
    on = build_stepper(P.Mu5Nmb, kepler_torch, 4, torch.float64)
    off = build_stepper(P.Mu5Nmb, kepler_torch, 4, torch.float64,
                        scale_embedded=False)
    tab = P.Mu5Nmb.tableau
    np.testing.assert_array_equal(on.E_u, tab.E * 0.75)
    np.testing.assert_array_equal(on.E_v, tab.Ep * 0.75)
    np.testing.assert_array_equal(off.E_u, tab.E)


def test_unported_parts_name_their_roadmap_item():
    """The host driver's problem check (A7) is ported: it takes Kepler's
    [v, a] form and refuses another (tests/test_torch_ivp.py holds its
    refusals against JAX's); dense output and the stiffness check (A4b)
    run: tests/test_torch_dense.py and tests/test_torch_events.py hold
    them against JAX."""
    st = build_stepper(P.Fi5N, kepler_torch, 4, torch.float64)
    y0 = kepler_y0(1)[0]

    def fun_np(t, y):
        return kepler_torch(torch.tensor([t]),
                            torch.as_tensor(y)[:, None])[:, 0].numpy()
    st.validate_problem(fun_np, 0.0, y0)
    with pytest.raises(AssertionError, match="second order"):
        st.validate_problem(lambda t, y: -np.asarray(y), 0.0, y0)
    out = solve_ensemble(kepler_torch, (0.0, 1.0), torch.tensor(kepler_y0(2)),
                         method="Fi5N", nfev_stiff_detect=100, save_steps=True,
                         max_steps=100)
    assert out.stiffness.shape == (2,) and out.ys.shape == (2, 100, 4)
