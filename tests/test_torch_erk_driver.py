"""The port's f64 solver against the JAX package's ``solve_ensemble``.

Both packages integrate the same seeded Van der Pol members (mu = 3,
t in [0, 10], rtol 1e-6 / atol 1e-9) on the CPU.  In float64 the
round-off of the two libraries sits far below every accept/reject
decision, so the work counters must be identical per member and the
endpoints agree to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extensisq_tpu as X
from extensisq_tpu_torch import (BS5, CK5, Ts5, solve, solve_ensemble,
                                 Method)
from extensisq_tpu_torch.steppers import build_stepper

MU = 3.0
B = 48
COUNTERS = ("status", "nsteps", "nfev", "nfailed")


def vdp_jax(t, y):
    return jnp.stack([y[1], MU * (1 - y[0] ** 2) * y[1] - y[0]])


def vdp_torch(t, y):
    return torch.stack([y[1], MU * (1 - y[0] ** 2) * y[1] - y[0]])


def _members(seed, forward):
    rng = np.random.default_rng(seed)
    if forward:
        return np.stack([rng.uniform(1.5, 2.5, B),
                         rng.uniform(-1.0, 1.0, B)], axis=1)
    # backward in time the limit cycle repels: start inside it, where the
    # backward flow spirals into the origin and stays bounded
    return np.stack([rng.uniform(0.5, 1.5, B), rng.uniform(-0.5, 0.5, B)],
                    axis=1)


def _jax_ensemble(fun, span, y0, method, **kw):
    return jax.jit(lambda Y: X.solve_ensemble(fun, span, Y, method=method,
                                              **kw))(jnp.asarray(y0))


def _assert_same(port, ref, y_tol=1e-10):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert np.max(np.abs(port.y.numpy() - np.asarray(ref.y))) <= y_tol


@pytest.mark.parametrize("forward", [True, False],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("name", ["BS5", "CK5", "Ts5"])
def test_ensemble_matches_jax(name, forward):
    """BS5 (FSAL, two-phase error), CK5 (non-FSAL) and Ts5."""
    span = (0.0, 10.0) if forward else (10.0, 0.0)
    y0 = _members(7 if forward else 8, forward)
    ref = _jax_ensemble(vdp_jax, span, y0, getattr(X, name), rtol=1e-6,
                        atol=1e-9)
    port = solve_ensemble(vdp_torch, span, torch.tensor(y0), method=name,
                          rtol=1e-6, atol=1e-9)
    assert np.all(np.asarray(ref.status) == 1)
    _assert_same(port, ref)


def test_solve_matches_ensemble_member():
    y0 = torch.tensor(_members(7, True))
    ens = solve_ensemble(vdp_torch, (0.0, 10.0), y0, method=BS5, rtol=1e-6,
                         atol=1e-9)
    for i in (0, 17, B - 1):
        one = solve(vdp_torch, (0.0, 10.0), y0[i], method=BS5, rtol=1e-6,
                    atol=1e-9)
        for f in COUNTERS:
            assert int(getattr(one, f)) == int(getattr(ens, f)[i])
        assert float(one.t) == 10.0
        assert torch.allclose(one.y, ens.y[i], rtol=0.0, atol=1e-12)


def test_max_steps_cap_gives_status_4():
    y0 = _members(7, True)
    ref = _jax_ensemble(vdp_jax, (0.0, 10.0), y0, X.BS5, rtol=1e-6,
                        atol=1e-9, max_steps=20)
    port = solve_ensemble(vdp_torch, (0.0, 10.0), torch.tensor(y0),
                          method=BS5, rtol=1e-6, atol=1e-9, max_steps=20)
    assert torch.all(port.status == 4)
    assert torch.all(port.nsteps == 20)
    # at the cap some members are inside a relaxation jump, where the flow
    # expands round-off differences ~1e3-fold for a while (by t = 10 they
    # have contracted again to ~1e-13)
    _assert_same(port, ref, y_tol=1e-9)


def test_blowup_gives_status_3_and_is_isolated():
    """One member overflows float64 on its first evaluation; it ends with
    status 3 and every other member finishes as in the JAX package."""
    def cubic_jax(t, y):
        return jnp.stack([y[1], y[0] ** 3])

    def cubic_torch(t, y):
        return torch.stack([y[1], y[0] ** 3])

    y0 = np.stack([np.linspace(0.1, 0.5, 16), np.zeros(16)], axis=1)
    y0[5, 0] = 1e120
    ref = _jax_ensemble(cubic_jax, (0.0, 1.0), y0, X.BS5, rtol=1e-6,
                        atol=1e-9)
    port = solve_ensemble(cubic_torch, (0.0, 1.0), torch.tensor(y0),
                          method=BS5, rtol=1e-6, atol=1e-9)
    assert int(port.status[5]) == 3
    assert int((port.status == 1).sum()) == 15
    ok = port.status == 1
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert np.max(np.abs(port.y[ok].numpy()
                         - np.asarray(ref.y)[ok.numpy()])) <= 1e-10


def test_params_batch_matches_jax():
    """Per-member parameters reach the RHS with the member axis last, so
    ``p`` is used like the JAX package's per-member scalar."""
    mus = np.linspace(1.0, 4.0, B)
    y0 = _members(9, True)

    def vdp_p_jax(t, y, p):
        return jnp.stack([y[1], p * (1 - y[0] ** 2) * y[1] - y[0]])

    def vdp_p_torch(t, y, p):
        return torch.stack([y[1], p * (1 - y[0] ** 2) * y[1] - y[0]])

    ref = jax.jit(lambda Y, P: X.solve_ensemble(
        vdp_p_jax, (0.0, 5.0), Y, params_batch=P, method=X.CK5, rtol=1e-6,
        atol=1e-9))(jnp.asarray(y0), jnp.asarray(mus))
    port = solve_ensemble(vdp_p_torch, (0.0, 5.0), torch.tensor(y0),
                          params_batch=torch.tensor(mus), method=CK5,
                          rtol=1e-6, atol=1e-9)
    _assert_same(port, ref)


def test_step_matches_jax_step():
    """``step`` advances every running member by exactly one accepted
    step, repeating rejected attempts per member, as the JAX stepper's
    ``step`` (vmapped) does."""
    from extensisq_tpu.steppers import build_stepper as jax_build_stepper
    from extensisq_tpu.types import IVPParams as JaxParams
    from extensisq_tpu_torch.types import IVPParams
    y0 = _members(7, True)
    jst = jax_build_stepper(X.BS5, vdp_jax, 2, np.float64)
    jparams = JaxParams(t_bound=jnp.asarray(10.0), direction=jnp.asarray(1.0),
                        rtol=jnp.asarray(1e-6), atol=jnp.asarray(1e-9),
                        max_step=jnp.asarray(np.inf))
    jstate = jax.vmap(lambda y: jst.init(0.0, y, jparams))(jnp.asarray(y0))
    jstep = jax.jit(jax.vmap(lambda s: jst.step(jparams, s)))
    stepper = build_stepper(BS5, vdp_torch, 2, torch.float64)
    params = IVPParams(t_bound=10.0, direction=1.0, rtol=1e-6, atol=1e-9,
                       max_step=np.inf)
    state = stepper.init(0.0, torch.tensor(y0).T.contiguous(), params)
    for k in range(1, 6):
        state = stepper.step(params, state)
        jstate = jstep(jstate)
        assert torch.all(state.nsteps == k)
        for f in ("status", "nsteps", "nfev", "nfailed"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)))
        # XLA's compiled pow/log carry ~1e-10 relative error in h_start's
        # tolerance term (eager JAX agrees with the port to 1e-15), so the
        # first step, and with it t and y, differ at that level
        assert np.max(np.abs(state.t.numpy() - np.asarray(jstate.t))) < 1e-9
        assert np.max(np.abs(state.y.T.numpy()
                             - np.asarray(jstate.y))) < 1e-9


@pytest.mark.parametrize("kw", [{"t_eval": [1.0]}, {"save_steps": True},
                                {"events": lambda t, y: y[0]},
                                {"pause_at": 1.0},
                                {"nfev_stiff_detect": 100}])
def test_unported_solve_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        solve_ensemble(vdp_torch, (0.0, 1.0), torch.tensor(_members(7, True)),
                       **kw)


def test_unported_families_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP item A14"):
        build_stepper(Method(name="x", family="ckdisc"), vdp_torch, 2,
                      torch.float64)
