"""The port's problem library against the JAX package's.

Every factory's ``rhs`` (and analytic ``jac`` and ``dfdp``, and the
spectral-radius bound) is evaluated on the same seeded rows-first ``(n,
B)`` inputs in the port and, member by member, in JAX; the numpy fields
(``t_span``, ``y0``, ``M``, ``jac_sparsity``, ``params``, the exact
solution, the extras) must be equal.  Gate: 1e-14 relative to max(1,
|f|) (Pleiades' and the combustion wave's powers and exponentials round
in the last bit otherwise than XLA's).  The top-level ``ALL_METHODS``
names the JAX package's methods in the JAX order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extensisq_tpu as X
from extensisq_tpu import problems as jax_problems

import extensisq_tpu_torch as P
from extensisq_tpu_torch import problems

FACTORIES = {"rational": (), "exponential_decay": (), "robertson": (),
             "kaps": (), "vdp": (), "pendulum_dae": (), "pleiades": (),
             "medazko": (12,), "brusselator_2d": ((8, 8),),
             "combustion_3d": (4,)}
B = 3
REL = 1e-14


def _rel(a, b):
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", list(FACTORIES))
def test_problem_matches_jax(name):
    args = FACTORIES[name]
    pj, pp = getattr(jax_problems, name)(*args), \
        getattr(problems, name)(*args)
    assert pp.name == pj.name
    for f in ("t_span", "y0", "M", "jac_sparsity", "params"):
        assert _same(getattr(pp, f), getattr(pj, f)), f
    n = pj.y0.size
    rng = np.random.default_rng(n)
    Y = pj.y0[:, None] * (1 + 0.1 * rng.standard_normal((n, B))) \
        + 0.01 * rng.standard_normal((n, B))
    t = pj.t_span[0] + np.array([1e-3, 0.5, 7.0])
    f = pp.rhs(torch.tensor(t), torch.tensor(Y))
    assert f.shape == (n, B) and f.dtype == torch.float64
    want = np.stack([np.asarray(pj.rhs(t[b], jnp.asarray(Y[:, b])))
                     for b in range(B)], 1)
    assert _rel(f.numpy(), want) <= REL
    for field in ("jac", "dfdp"):
        if getattr(pj, field) is None:
            assert getattr(pp, field) is None
            continue
        got = getattr(pp, field)(torch.tensor(t), torch.tensor(Y))
        want = np.stack([np.asarray(getattr(pj, field)(
            t[b], jnp.asarray(Y[:, b]))) for b in range(B)], -1)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= REL, field
    if pj.rho_jac is not None:
        assert float(pp.rho_jac(torch.tensor(t), torch.tensor(Y))) == \
            float(pj.rho_jac(t[0], jnp.asarray(Y[:, 0])))
    if pj.solution is not None:
        ts = np.linspace(*pj.t_span, 5)
        np.testing.assert_array_equal(pp.solution(ts), pj.solution(ts))
    if pj.jac_sparsity is not None:
        # the pattern holds every structural nonzero of the port's rhs
        J = torch.func.jacfwd(lambda y: pp.rhs(torch.tensor(t[:1]), y))(
            torch.tensor(Y[:, :1]))[:, 0, :, 0]
        assert not np.any((J.numpy() != 0) & (pp.jac_sparsity == 0))


def test_robertson_and_pleiades_extras():
    pj, pp = jax_problems.robertson(), problems.robertson()
    rng = np.random.default_rng(1)
    Y = rng.uniform(0.0, 1.0, (3, B))
    got = pp.extra["rhs_p"](None, torch.tensor(Y), 0.05, 2e4, 1e7)
    want = np.stack([np.asarray(pj.extra["rhs_p"](
        0.0, jnp.asarray(Y[:, b]), 0.05, 2e4, 1e7)) for b in range(B)], 1)
    assert _rel(got.numpy(), want) <= REL
    pj, pp = jax_problems.pleiades(), problems.pleiades()
    for k in ("q0", "v0"):
        assert _same(pp.extra[k], pj.extra[k])
    Q = pj.extra["q0"][:, None] + 0.1 * rng.standard_normal((14, B))
    got = pp.extra["accel"](torch.tensor(Q)).numpy()
    want = np.stack([np.asarray(pj.extra["accel"](jnp.asarray(Q[:, b])))
                     for b in range(B)], 1)
    assert _rel(got, want) <= REL
    assert problems.pendulum_dae().extra == jax_problems.pendulum_dae().extra


def test_medazko_drives_the_banded_solver():
    """One factory end to end: Medazko N = 10 with ``bands=True`` and
    its pattern, on the dense path's counters."""
    pp = problems.medazko(10)
    kw = dict(method="KC4I", jac_sparsity=pp.jac_sparsity)
    y0 = torch.tensor(pp.y0)
    banded = P.solve(pp.rhs, (0.0, 6.0), y0, bands=True, **kw)
    dense = P.solve(pp.rhs, (0.0, 6.0), y0, **kw)
    assert int(banded.status) == 1
    for f in ("nsteps", "nfev", "nfailed"):
        assert int(getattr(banded, f)) == int(getattr(dense, f)), f
    assert torch.allclose(banded.y, dense.y, rtol=0, atol=1e-9)


def test_all_methods_match_jax():
    assert [m.name for m in P.ALL_METHODS] == [m.name for m in X.ALL_METHODS]
    assert [m.family for m in P.ALL_METHODS] == \
        [m.family for m in X.ALL_METHODS]
