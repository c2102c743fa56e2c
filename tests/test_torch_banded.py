"""Banded and sparse ESDIRK Jacobians of the port against the JAX package.

The storage helpers, the column grouping, the reverse Cuthill-McKee order
and the block cyclic reduction (factor and solve) of
``extensisq_tpu_torch/core/banded.py`` and ``core/linalg.py`` are held
against the JAX functions on the same seeded arrays (the storage and the
orderings exactly, the solves to 1e-12 relative).  Medazko at N = 20
(n = 40) runs through the port's ``solve`` and the JAX ``solve`` with
``bands=True``, ``bands=(4, 4)``, ``bands="rcm"`` and ``jac_sparsity``
alone, with TRBDF2 and KC4I; so do the FEM-mass and the diagonal-DAE
cases of ``tests/test_banded.py`` and its relabelled diffusion chain
under ``bands="rcm"``.  The JAX side runs in three subprocesses without FMA
(``tests/jax_reference.py``).  Gates: status, nsteps, nfev, njev, nlu and
nfailed identical, endpoints within 1e-10.
"""
import functools
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extensisq_tpu.core import banded as jbd
from extensisq_tpu.core import linalg as jla
from extensisq_tpu.problems import medazko as jax_medazko

import extensisq_tpu_torch as P
from extensisq_tpu_torch.core import banded as bd
from extensisq_tpu_torch.core import linalg as la
from extensisq_tpu_torch.problems import medazko
from jax_reference import run_jax

COUNTERS = ("status", "nsteps", "nfev", "njev", "nlu", "nfailed")
GATE = 1e-10
N_MED = 20


def _banded_system(n, kl, ku, members, seed, complex_=False):
    rng = np.random.default_rng(seed)
    i, j = np.indices((n, n))
    mask = (i - j <= kl) & (j - i <= ku)
    A = rng.standard_normal((members, n, n)) * mask
    x = rng.standard_normal((members, n))
    if complex_:
        A = A + 1j * rng.standard_normal((members, n, n)) * mask
        x = x + 1j * rng.standard_normal((members, n))
    A = A + np.eye(n) * (kl + ku + 2)
    return A, x


# -- storage, orderings and cyclic reduction against the JAX functions -----

@pytest.mark.parametrize("n,kl,ku,cplx", [(7, 1, 1, False),
                                          (13, 2, 3, False),
                                          (64, 4, 4, False),
                                          (17, 2, 1, True)])
def test_bcr_matches_jax(n, kl, ku, cplx):
    """Three members at once: banded storage and back, the banded
    product, and factor + solve, each against the JAX function on every
    member."""
    A, x = _banded_system(n, kl, ku, 3, n + 10 * kl + ku, cplx)
    rhs = np.einsum("kij,kj->ki", A, x)
    AB = bd.banded_from_dense(torch.tensor(A), kl, ku)

    @jax.jit
    @jax.vmap
    def jax_side(a, v, r):
        ab = jbd.banded_from_dense(a, kl, ku)
        return (ab, jbd.banded_matvec(ab, kl, ku, v),
                jbd.banded_solve(jbd.banded_factor(ab, kl, ku, n), r, n, kl,
                                 ku))

    jax_AB, jax_mv, want = (np.asarray(a) for a in jax_side(
        jnp.asarray(A), jnp.asarray(x), jnp.asarray(rhs)))
    np.testing.assert_array_equal(AB.numpy(), jax_AB)
    np.testing.assert_array_equal(
        bd.dense_from_banded(AB, kl, ku, n).numpy(), A)
    mv = bd.banded_matvec(AB, kl, ku, torch.tensor(x)).numpy()
    np.testing.assert_allclose(mv, jax_mv, rtol=1e-14, atol=1e-13)

    fact = bd.banded_factor(AB, kl, ku, n)
    got = bd.banded_solve(fact, torch.tensor(rhs), n, kl, ku).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    np.testing.assert_allclose(got, x, rtol=0, atol=1e-9)
    # the state's placeholder has the factor's structure
    zero = bd.bcr_zero_factor(n, kl, ku, AB.dtype, 3)
    shapes = [t.shape for lv in fact[0] for t in lv] + [fact[1].shape]
    assert shapes == [t.shape for lv in zero[0] for t in lv] + [
        zero[1].shape]
    assert bd.block_shapes(n, kl, ku) == jbd.block_shapes(n, kl, ku)


def _relabelled_chain(n, seed):
    rng = np.random.RandomState(seed)
    sig = np.asarray(rng.permutation(n))
    pos = np.argsort(sig)
    Sc = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 1
    return sig, pos, Sc[np.ix_(pos, pos)].astype(int)


def test_orderings_and_groups_match_jax():
    """``bands_of_sparsity``, ``rcm_order`` and ``group_columns`` give the
    JAX functions' results on Medazko's pattern, a relabelled chain and a
    random pattern."""
    rng = np.random.default_rng(4)
    R = (rng.random((30, 30)) < 0.1) | np.eye(30, dtype=bool)
    patterns = [jax_medazko(N_MED).jac_sparsity,
                _relabelled_chain(50, 11)[2], R.astype(int)]
    for S in patterns:
        assert bd.bands_of_sparsity(S) == jbd.bands_of_sparsity(S)
        np.testing.assert_array_equal(bd.rcm_order(S), jbd.rcm_order(S))
        g, k = la.group_columns(S)
        jg, jk = jla.group_columns(S)
        assert k == jk
        np.testing.assert_array_equal(g, jg)
    p = bd.rcm_order(patterns[1])
    assert sum(bd.bands_of_sparsity(patterns[1][p][:, p])) <= 2


def test_colored_jacobians_match_jax():
    """The colored dense and banded Jacobians of Medazko equal JAX's
    ``jacfwd`` on three members, and take 9 JVPs instead of 40."""
    jp, pp = jax_medazko(N_MED), medazko(N_MED)
    n = pp.y0.size
    rng = np.random.default_rng(2)
    Y = pp.y0[:, None] + 0.1 * rng.standard_normal((n, 3))
    t = np.array([1.3, 4.0, 7.5])
    want = np.stack([np.asarray(jax.jacfwd(jp.rhs, argnums=1)(
        t[b], jnp.asarray(Y[:, b]))) for b in range(3)])
    groups, k = la.group_columns(pp.jac_sparsity)
    assert k == 9
    J = la.colored_jacfwd(pp.rhs, pp.jac_sparsity, n)(torch.tensor(t),
                                                       torch.tensor(Y))
    np.testing.assert_allclose(J.numpy(), want, rtol=1e-14, atol=1e-12)
    AB = bd.banded_colored_jacfwd(pp.rhs, 4, 4, n)(torch.tensor(t),
                                                   torch.tensor(Y))
    np.testing.assert_allclose(bd.dense_from_banded(AB, 4, 4, n).numpy(),
                               want, rtol=1e-14, atol=1e-12)


# -- the ESDIRK banded modes against the JAX driver -------------------------

def _banded_dae(nc):
    """u_t = u_xx - v, 0 = v - u^2, interleaved: (kl, ku) = (2, 2) and
    M = diag(1, 0, 1, 0, ...) (``tests/test_banded.py``)."""
    n = 2 * nc
    h2 = (nc + 1) ** 2

    def rhs(t, y):
        u, v = y[0::2], y[1::2]
        lap = (torch.nn.functional.pad(u[1:], (0, 0, 0, 1)) - 2 * u
               + torch.nn.functional.pad(u[:-1], (0, 0, 1, 0))) * h2
        return torch.stack([lap - v, v - u ** 2], dim=1).reshape(n, -1)

    M = np.zeros(n)
    M[0::2] = 1.0
    x = np.linspace(0, 1, nc + 2)[1:-1]
    u0 = np.sin(np.pi * x)
    return rhs, M, np.stack([u0, u0 ** 2], axis=1).reshape(n)


def _fem(y_len=40):
    M = (np.diag(np.full(y_len, 2.0 / 3.0))
         + np.diag(np.full(y_len - 1, 1.0 / 6.0), 1)
         + np.diag(np.full(y_len - 1, 1.0 / 6.0), -1))

    def rhs(t, y):
        left = torch.cat([y[:1], y[:-1]])
        right = torch.cat([y[1:], y[-1:]])
        return 20.0 * (left - 2.0 * y + right) - y ** 3

    y0 = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(y_len) / y_len)
    return rhs, M, y0


def _chain(n=60):
    sig, pos, S = _relabelled_chain(n, 3)
    lam = 1.0 + np.linspace(0.0, 1.0, n)

    def rhs(t, y):
        w = y[sig]
        left = torch.cat([w[:1], w[:-1]])
        right = torch.cat([w[1:], w[-1:]])
        gw = 30.0 * (left - 2.0 * w + right) - torch.tensor(lam)[:, None] * w
        return gw[pos]

    return rhs, S, 1.0 + 0.1 * np.sin(np.arange(n))


_MED = medazko(N_MED)
_DAE = _banded_dae(24)
_FEM = _fem()
_CHAIN = _chain()
BANDS = {"true": dict(bands=True, jac_sparsity="S"),
         "tuple": dict(bands=(4, 4)),
         "rcm": dict(bands="rcm", jac_sparsity="S"),
         "sparsity": dict(jac_sparsity="S")}
# name -> (problem, method, span, y0, options); "S" stands for the pattern
CASES = {f"medazko-{m}-{k}": ("medazko", m, (0.0, 20.0), _MED.y0, kw)
         for m in ("TRBDF2", "KC4I") for k, kw in BANDS.items()}
CASES["dae-KC4I"] = ("dae", "KC4I", (0.0, 0.2), _DAE[2],
                     dict(M="M", bands=(2, 2)))
CASES["fem"] = ("fem", "TRBDF2", (0.0, 0.5), _FEM[2],
                dict(M="M", bands=(1, 1)))
CASES["chain-rcm"] = ("chain", "TRBDF2", (0.0, 0.5), _CHAIN[2],
                      dict(bands="rcm", jac_sparsity="S"))
EXTRA = {"medazko": dict(S=_MED.jac_sparsity), "dae": dict(M=_DAE[1]),
         "fem": dict(M=_FEM[1]), "chain": dict(S=_CHAIN[1])}
RHS = {"medazko": _MED.rhs, "dae": _DAE[0], "fem": _FEM[0],
       "chain": _CHAIN[0]}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.problems import medazko

    def dae(t, y):
        u, v = y[0::2], y[1::2]
        lap = (jnp.concatenate([u[1:], jnp.zeros(1, y.dtype)]) - 2 * u
               + jnp.concatenate([jnp.zeros(1, y.dtype), u[:-1]])) * 25 ** 2
        return jnp.stack([lap - v, v - u ** 2], axis=1).reshape(-1)

    def fem(t, y):
        left = jnp.concatenate([y[:1], y[:-1]])
        right = jnp.concatenate([y[1:], y[-1:]])
        return 20.0 * (left - 2.0 * y + right) - y ** 3

    inputs = np.load(sys.argv[1])
    sig, pos, lam = (inputs[k] for k in ("sig", "pos", "lam"))

    def chain(t, y):
        w = y[sig]
        left = jnp.concatenate([w[:1], w[:-1]])
        right = jnp.concatenate([w[1:], w[-1:]])
        return (30.0 * (left - 2.0 * w + right) - jnp.asarray(lam) * w)[pos]

    rhs = {"medazko": medazko(%d).rhs, "dae": dae, "fem": fem,
           "chain": chain}
    out = {}
    for name, c in json.loads(sys.argv[2]).items():
        kw = {k: (inputs[c["problem"] + "/" + v] if isinstance(v, str)
                  and v in ("S", "M") else v) for k, v in c["kw"].items()}
        if isinstance(kw.get("bands"), list):
            kw["bands"] = tuple(kw["bands"])
        res = X.solve(rhs[c["problem"]], tuple(c["span"]),
                      jnp.asarray(inputs[name + "/y0"]),
                      method=getattr(X, c["method"]), return_state=True,
                      **kw)
        st = res.final_state
        out[name + "/y"] = np.asarray(res.y)
        for f in ("status", "nsteps", "nfev", "nfailed"):
            out[name + "/" + f] = np.asarray(getattr(res, f))
        for f in ("njev", "nlu"):
            out[name + "/" + f] = np.asarray(getattr(st, f))
    np.savez(sys.argv[3], **out)
""" % N_MED)


def _kwargs(prob, kw):
    return {k: (EXTRA[prob][v] if isinstance(v, str) and v in ("S", "M")
                else v) for k, v in kw.items()}


@functools.lru_cache(maxsize=None)
def _run(name, dense=False):
    prob, method, span, y0, kw = CASES[name]
    kw = _kwargs(prob, kw)
    if dense:
        kw.pop("bands")
    return P.solve(RHS[prob], span, torch.tensor(y0), method=method,
                   return_state=True, **kw)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_banded")
    arrays = {"sig": _relabelled_chain(60, 3)[0],
              "pos": _relabelled_chain(60, 3)[1],
              "lam": 1.0 + np.linspace(0.0, 1.0, 60)}
    for prob, extra in EXTRA.items():
        for k, v in extra.items():
            arrays[f"{prob}/{k}"] = v
    for k, v in CASES.items():
        arrays[k + "/y0"] = v[3]
    np.savez(d / "in.npz", **arrays)
    spec = {k: dict(problem=v[0], method=v[1], span=list(v[2]),
                    kw={a: (list(b) if isinstance(b, tuple) else b)
                        for a, b in v[4].items()})
            for k, v in CASES.items()}
    names = list(CASES)
    warm = [lambda k=k: _run(k) for k in names]
    return run_jax(_JAX_SCRIPT, d, [{k: spec[k] for k in names[i::3]}
                                    for i in range(3)], warm)


def _counters(res):
    st = res.final_state
    return {f: int(getattr(res, f)) if f not in ("njev", "nlu")
            else int(getattr(st, f)[0]) for f in COUNTERS}


@pytest.mark.parametrize("name", list(CASES))
def test_banded_solve_matches_jax(jax_results, name):
    res = _run(name)
    assert int(res.status) == 1
    want = {f: int(jax_results[f"{name}/{f}"]) for f in COUNTERS}
    assert _counters(res) == want
    y_ref = jax_results[name + "/y"]
    assert np.max(np.abs(res.y.numpy() - y_ref)
                  / np.maximum(1.0, np.abs(y_ref))) <= GATE


@pytest.mark.parametrize("name", ["dae-KC4I", "fem", "chain-rcm"])
def test_banded_counts_equal_dense_path(name):
    """Banded mode changes the linear algebra, not the integration: the
    port's dense path takes the same steps (the DAE's constraint holds)."""
    banded, dense = _run(name), _run(name, dense=True)
    assert _counters(banded) == _counters(dense)
    np.testing.assert_allclose(banded.y.numpy(), dense.y.numpy(), rtol=0,
                               atol=1e-9)
    if name.startswith("dae"):
        u, v = banded.y[0::2].numpy(), banded.y[1::2].numpy()
        np.testing.assert_allclose(v, u ** 2, rtol=0, atol=1e-6)


def test_banded_user_and_constant_jacobians():
    """A user ``jac`` returning dense ``(n, n, B)`` or banded
    ``(kl+ku+1, n, B)`` storage, and a constant tridiagonal ``jac`` on the
    linear path: the dense path's counters, and its endpoint within 1e-9
    (cyclic reduction rounds otherwise than the LU); the two user forms
    within 1e-12 of each other."""
    kl = ku = 4
    jac_banded = bd.banded_colored_jacfwd(_MED.rhs, kl, ku, 2 * N_MED)
    kw = dict(method="KC4I", return_state=True)
    span, y0 = (0.0, 8.0), torch.tensor(_MED.y0)
    r_dense = P.solve(_MED.rhs, span, y0,
                      jac=lambda t, y: bd.dense_from_banded(
                          jac_banded(t, y), kl, ku, 2 * N_MED).permute(
                              1, 2, 0), bands=(kl, ku), **kw)
    r_band = P.solve(_MED.rhs, span, y0, bands=(kl, ku),
                     jac=lambda t, y: jac_banded(t, y).permute(1, 2, 0),
                     **kw)
    r_ref = P.solve(_MED.rhs, span, y0, jac_sparsity=_MED.jac_sparsity,
                    **kw)
    assert _counters(r_dense) == _counters(r_band) == _counters(r_ref)
    np.testing.assert_allclose(r_dense.y.numpy(), r_band.y.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r_band.y.numpy(), r_ref.y.numpy(), rtol=0,
                               atol=1e-9)

    n = 64
    J = (np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1)) * n ** 2
    heat0 = torch.tensor(np.sin(np.pi * (np.arange(n) + 1) / (n + 1)))
    Jt = torch.tensor(J)
    runs = [P.solve(lambda t, y: Jt @ y, (0.0, 0.1), heat0, method="Kv3I",
                    jac=J, return_state=True, **b)
            for b in ({}, dict(bands=(1, 1)))]
    assert _counters(runs[0]) == _counters(runs[1])
    np.testing.assert_allclose(runs[1].y.numpy(), runs[0].y.numpy(),
                               rtol=0, atol=1e-10)


def test_banded_ensemble_equals_single_solves():
    """A banded ``solve_ensemble`` (each member's y0 scaled) equals its
    members' single solves, the factor levels selected per member: the
    same counters, and endpoints within 1e-9 (a single member's norms sum
    its column in another order than a batch's, and Medazko at rtol 1e-3
    carries that last bit to ~1e-10)."""
    scales = np.array([0.6, 1.3])
    Y0 = torch.tensor(scales[:, None] * _MED.y0[None])
    kw = dict(method="KC4I", bands=True, jac_sparsity=_MED.jac_sparsity)
    ens = P.solve_ensemble(_MED.rhs, (0.0, 8.0), Y0, **kw)
    for i in range(len(scales)):
        one = P.solve(_MED.rhs, (0.0, 8.0), Y0[i], **kw)
        for f in ("status", "nsteps", "nfev", "nfailed"):
            assert int(getattr(one, f)) == int(getattr(ens, f)[i]), f
        np.testing.assert_allclose(one.y.numpy(), ens.y[i].numpy(), rtol=0,
                                   atol=1e-9)


def _refusal_message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", ["bands-true-needs-sparsity",
                                  "singular-nondiagonal-M"])
def test_refusals_match_jax(case):
    import extensisq_tpu as X
    rhs, M, y0 = _banded_dae(8)
    if case == "bands-true-needs-sparsity":
        kw = dict(bands=True)
    else:
        Mfull = np.diag(M)
        Mfull[0, 2] = 0.5
        kw = dict(M=Mfull, bands=(2, 2))
    port = _refusal_message(lambda: P.solve(
        rhs, (0.0, 0.1), torch.tensor(y0), method="TRBDF2", **kw))
    ref = _refusal_message(lambda: X.solve(
        lambda t, y: -y, (0.0, 0.1), jnp.asarray(y0), method=X.TRBDF2,
        **kw))
    assert port == ref
    assert ("bands=True requires" in port) or ("nonsingular" in port)
