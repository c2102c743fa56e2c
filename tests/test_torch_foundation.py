"""The port's foundation against the JAX package: tableau data, shared
numerics, the controller and the starting step, on seeded float64 input.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extensisq_tpu as X
from extensisq_tpu.core import controller as jctl
from extensisq_tpu.core import numerics as jnum
from extensisq_tpu.core.hstart import h_start as jax_h_start
from extensisq_tpu.types import ERKTableau as JaxTableau
from extensisq_tpu.types import Method as JaxMethod

import extensisq_tpu_torch as P
from extensisq_tpu_torch import _config as pcfg
from extensisq_tpu_torch.core import controller as pctl
from extensisq_tpu_torch.core import numerics as pnum
from extensisq_tpu_torch.core.hstart import h_start as port_h_start

REPO = Path(__file__).resolve().parents[1]
NAMES = ["BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9",
         "CFMR7osc"]
ARRAYS = ("A", "B", "C", "E", "P", "E_pre", "B_pre")
SCALARS = ("name", "order", "order_secondary", "n_pre", "stbrad", "tanang",
           "sc_params", "n_stages", "fsal")
REL = 1e-14


def _same_array(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _same_tableau(pt, jt):
    for f in ARRAYS:
        assert _same_array(getattr(pt, f), getattr(jt, f)), f
    for f in SCALARS:
        assert getattr(pt, f) == getattr(jt, f), f
    assert pt.c_spacing() == jt.c_spacing()


@pytest.mark.parametrize("name", NAMES)
def test_tableaux_equal_jax(name):
    pm, jm = P.METHODS_BY_NAME[name], X.METHODS_BY_NAME[name]
    assert (pm.family, pm.name) == (jm.family, jm.name)
    _same_tableau(pm.tableau, jm.tableau)
    pi, ji = pm.tableau.interpolants or {}, jm.tableau.interpolants or {}
    assert pi.keys() == ji.keys()
    for key, spec in ji.items():
        if spec is None:
            assert pi[key] is None
            continue
        for part in ("C_extra", "A_extra", "P"):
            assert np.array_equal(pi[key][part], spec[part]), (key, part)
        assert pi[key]["anchor"] == spec["anchor"]
    if name == "CKdisc":
        for k, v in jm.options["ckdisc"].items():
            assert np.array_equal(pm.options["ckdisc"][k], v), k


def test_status_codes_equal_jax():
    from extensisq_tpu import _config as jcfg
    for name in ("RUNNING", "FINISHED", "TOO_SMALL_STEP", "OVERFLOW",
                 "MAX_STEPS_REACHED", "TERMINAL_EVENT", "PAUSED",
                 "MIN_FACTOR", "MAX_FACTOR", "MAX_FACTOR0"):
        assert getattr(pcfg, name) == getattr(jcfg, name), name
    assert pcfg.STATUS_MESSAGES == jcfg.STATUS_MESSAGES


def _bs3_jax():
    """A custom FSAL pair defined for the JAX package only (Bogacki &
    Shampine 3(2))."""
    B = np.array([2 / 9, 1 / 3, 4 / 9])
    E = np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8])
    E[:3] -= B
    tab = JaxTableau(
        name="BS3", order=3, order_secondary=2,
        A=np.array([[0, 0, 0], [1 / 2, 0, 0], [0, 3 / 4, 0]]), B=B,
        C=np.array([0, 1 / 2, 3 / 4]), E=E, sc_params="standard")
    return JaxMethod(name="BS3", family="erk", tableau=tab)


def test_tableau_from_arrays_round_trips():
    for jm in (X.BS5, X.CFMR7osc, _bs3_jax()):
        jt = jm.tableau
        pt = P.tableau_from_arrays(
            jt.A, jt.B, jt.C, jt.E, jt.order, jt.order_secondary,
            name=jt.name, P=jt.P, n_pre=jt.n_pre, E_pre=jt.E_pre,
            B_pre=jt.B_pre, stbrad=jt.stbrad, tanang=jt.tanang,
            sc_params=jt.sc_params)
        _same_tableau(pt, jt)
    with pytest.raises(TypeError, match="unknown"):
        P.tableau_from_arrays(jt.A, jt.B, jt.C, jt.E, 3, 2, colour="red")


def test_custom_jax_method_runs_unchanged():
    """A tableau defined for the JAX package, carried over as arrays,
    takes exactly the JAX package's steps in the port."""
    jm = _bs3_jax()
    jt = jm.tableau
    pm = P.Method(name="BS3", family="erk", tableau=P.tableau_from_arrays(
        jt.A, jt.B, jt.C, jt.E, jt.order, jt.order_secondary, name="BS3",
        sc_params=jt.sc_params))
    y0 = np.stack([np.linspace(1.5, 2.5, 16), np.zeros(16)], axis=1)
    ref = jax.jit(lambda Y: X.solve_ensemble(
        lambda t, y: jnp.stack([y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
        (0.0, 3.0), Y, method=jm, rtol=1e-5, atol=1e-8))(jnp.asarray(y0))
    port = P.solve_ensemble(
        lambda t, y: torch.stack([y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
        (0.0, 3.0), torch.tensor(y0), method=pm, rtol=1e-5, atol=1e-8)
    for f in ("status", "nsteps", "nfev", "nfailed"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert np.max(np.abs(port.y.numpy() - np.asarray(ref.y))) <= 1e-10


def _rng_batch(seed, n=3, b=64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n)), rng


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


def test_norm_and_scale_match_jax():
    x, rng = _rng_batch(1)
    y_new = x + 0.1 * rng.standard_normal(x.shape)
    ref = jax.vmap(jnum.norm)(jnp.asarray(x))
    assert _rel(pnum.norm(torch.tensor(x.T)).numpy(), ref) <= REL
    atol = np.abs(rng.standard_normal(3)) * 1e-6
    for mean in (False, True):
        ref = jnum.calculate_scale(atol, 1e-4, jnp.asarray(x),
                                   jnp.asarray(y_new), _mean=mean)
        got = pnum.calculate_scale(torch.tensor(atol)[:, None], 1e-4,
                                   torch.tensor(x.T), torch.tensor(y_new.T),
                                   _mean=mean)
        assert _rel(got.numpy().T, ref) <= REL


def test_validate_tol_and_constants_match_jax():
    y = np.zeros(3)
    for rtol, atol in ((1e-6, 1e-9), (1.0, 0.0), (1e-20, [1e-3, 0, 1e-200])):
        got = pnum.validate_tol(rtol, atol, y)
        ref = jnum.validate_tol(rtol, atol, y)
        assert got[0] == ref[0]
        assert np.array_equal(got[1], ref[1])
    with pytest.raises(ValueError):
        pnum.validate_tol(1e-3, [1e-6, 1e-6], y)
    for dt in (np.float32, np.float64):
        assert pnum.dtype_constants(dt) == jnum.dtype_constants(dt)
    assert pnum.dtype_constants(torch.float32) == \
        jnum.dtype_constants(np.float32)


@pytest.mark.parametrize("sc", ["G", "S", "standard", (0.5, -0.1, 0.2, 0.8)])
def test_controller_matches_jax(sc):
    cc_j = jctl.resolve_controller(sc, "G", -0.2)
    cc_p = pctl.resolve_controller(sc, "G", -0.2)
    assert tuple(cc_p) == tuple(cc_j)
    rng = np.random.default_rng(2)
    b = 256
    err = 10.0 ** rng.uniform(-22, 1, b)
    err_old = 10.0 ** rng.uniform(-8, 1, b)
    h_ratio = rng.uniform(0.1, 4.0, b)
    h_ratio[::17] = 0.0
    rejected = rng.uniform(size=b) < 0.3
    std = rng.uniform(size=b) < 0.5
    max_factor = np.where(rng.uniform(size=b) < 0.5, 10.0, 4.0)
    tiny = 1e-20
    ref = jax.vmap(lambda *a: jctl.erk_accept_update(cc_j, tiny, *a))(
        *(jnp.asarray(v) for v in (err, err_old, h_ratio, rejected, std,
                                   max_factor)))
    got = pctl.erk_accept_update(
        cc_p, tiny, *(torch.tensor(v) for v in (err, err_old, h_ratio,
                                                rejected, std, max_factor)))
    assert _rel(got[0].numpy(), ref[0]) <= REL
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    ref_r = jax.vmap(lambda e: jctl.reject_factor(cc_j, e))(jnp.asarray(err))
    assert _rel(pctl.reject_factor(cc_p, torch.tensor(err)).numpy(),
                ref_r) <= REL


@pytest.mark.parametrize("n,forward", [(1, True), (2, True), (3, False)])
def test_h_start_matches_jax(n, forward):
    """Watts' start per member against the JAX function, vmapped and run
    op by op (XLA's compiled pow carries ~1e-10 relative error)."""
    rng = np.random.default_rng(3 + n)
    b = 64
    y0 = rng.uniform(-2.0, 2.0, (b, n))
    y0[::9] = 0.0                      # members with y = 0 take other branches
    a = rng.uniform(-1.0, 1.0, b)
    span = rng.uniform(0.5, 5.0, b) * (1.0 if forward else -1.0)
    M = rng.standard_normal((n, n))

    def fj(t, y):
        return jnp.sin(t) + jnp.asarray(M) @ y + 0.1 * y ** 3

    def fp(t, y):
        return torch.sin(t) + torch.tensor(M) @ y + 0.1 * y ** 3

    ref = jax.vmap(lambda y, t0, dt: jax_h_start(
        fj, t0, t0 + dt, y, fj(t0, y), 4, 1e-6, 1e-9))(
        jnp.asarray(y0), jnp.asarray(a), jnp.asarray(span))
    t0 = torch.tensor(a)
    y = torch.tensor(y0.T).contiguous()
    got = port_h_start(fp, t0, t0 + torch.tensor(span), y, fp(t0, y), 4,
                       1e-6, 1e-9)
    assert _rel(got.numpy(), ref) <= REL


def test_package_imports_no_jax():
    code = ("import extensisq_tpu_torch, sys; "
            "assert not any(m.startswith('jax') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
