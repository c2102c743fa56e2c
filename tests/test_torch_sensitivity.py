"""The port's sensitivity functions and ``solve_final`` on the CPU.

The seven cases of ``tests/test_sensitivity.py`` at their CVODES values
and gates (the Robertson setup: forward sensitivities with analytic and
autodiff derivatives on KC4I and TRBDF2, the block-diagonal Newton
Jacobian, the augmented sparsity pattern, the adjoint at the endpoint and
of an integral, ``solve_final``'s gradients against ``sens_forward`` and
central differences, and the batched form).  The Robertson runs are also
held against the JAX functions on the same inputs in no-FMA subprocesses
(``tests/jax_reference.py``): equal counters of the forward and backward
solves, values within 1e-9 relative (the host driver's gate over the
stiff sensitivity rows, whose entries span 1e-13 to 1), and 1e-8 for the
adjoint of the integral over (0, 4e7), which with equal counters parts by
2.2e-9 at its end.
"""
import functools
import textwrap

import numpy as np
import pytest
import torch

from jax_reference import run_jax

from extensisq_tpu_torch import BS5, KC4I, TRBDF2
from extensisq_tpu_torch.core.linalg import group_columns
from extensisq_tpu_torch.sensitivity import (sens_adjoint_end,
                                             sens_adjoint_int, sens_forward,
                                             solve_final)

COUNTS = ("nfev", "njev", "nlu", "nsteps", "nfailed")
GATE = 1e-9


def fun(t, y, *p):
    p1, p2, p3 = p
    return torch.stack([-p1 * y[0] + p2 * y[1] * y[2],
                        p1 * y[0] - p2 * y[1] * y[2] - p3 * y[1] ** 2,
                        p3 * y[1] ** 2])


def jac(t, y, *p):
    p1, p2, p3 = p
    z = torch.zeros_like(y[0])
    return torch.stack([
        torch.stack([-p1 + z, p2 * y[2], p2 * y[1]]),
        torch.stack([p1 + z, -p2 * y[2] - 2 * p3 * y[1], -p2 * y[1]]),
        torch.stack([z, 2 * p3 * y[1], z])])


def dfdp(t, y, *p):
    z = torch.zeros_like(y[0])
    return torch.stack([torch.stack([-y[0], y[1] * y[2], z]),
                        torch.stack([y[0], -y[1] * y[2], -y[1] ** 2]),
                        torch.stack([z, z, y[1] ** 2])])


def vdp(t, y, mu):
    return torch.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])


def g_end(i):
    return lambda t, y, *p: y[i:i + 1]


def g_int(t, y, *p):
    return (y[0] + p[1] * y[1] * y[2]).reshape(1)


Y0 = np.array([1.0, 0.0, 0.0])
P = (0.04, 1e4, 3e7)
DY0DP = np.zeros((3, 3))
RTOL = 1e-4
ATOL = np.array([1e-8, 1e-14, 1e-6])

# hard-coded CVODES reference numbers (the reference's test_sens.py)
YF = [9.8517e-01, 3.3864e-05, 1.4794e-02]
SENS = [[-3.5595e-01, 9.5428e-08, -1.5832e-11],
        [3.9026e-04, -2.1310e-10, -5.2900e-13],
        [3.5556e-01, -9.5215e-08, 1.6361e-11]]


def y0_cpu():
    return torch.as_tensor(Y0)


@functools.lru_cache(maxsize=None)
def forward(method, derivs, approx=False):
    J, D = (jac, dfdp) if derivs == "analytic" else (None, None)
    m = {"KC4I": KC4I, "TRBDF2": TRBDF2}[method]
    return sens_forward(fun, (0.0, 0.4), y0_cpu(), J, D, DY0DP, p=P,
                        method=m, rtol=RTOL, atol=ATOL,
                        use_approx_jac=approx)


@functools.lru_cache(maxsize=None)
def adjoint_end():
    sol_y, out = None, []
    for i in range(3):
        r = sens_adjoint_end(fun, (0.0, 0.4), y0_cpu(), None, None, DY0DP,
                             P, g_end(i), None, None, method=KC4I, atol=ATOL,
                             rtol=RTOL, atol_adj=1e-6, atol_quad=1e-7,
                             sol_y=sol_y)
        sol_y = r.sol_y
        out.append(r)
    return out


@functools.lru_cache(maxsize=None)
def adjoint_int():
    return sens_adjoint_int(fun, (0.0, 4e7), y0_cpu(), None, None, DY0DP,
                            P, g_int, None, None, method=KC4I, atol=ATOL,
                            rtol=RTOL, atol_adj=1e-5, atol_quad=1e-6)


@pytest.mark.parametrize("method", ["KC4I", "TRBDF2"])
@pytest.mark.parametrize("derivs", ["analytic", "autodiff"])
def test_sens_forward(method, derivs):
    sens, yf, _ = forward(method, derivs)
    np.testing.assert_allclose(yf, YF, rtol=1e-3)
    np.testing.assert_allclose(sens, SENS, rtol=1e-3)


def test_sens_forward_approx_jac():
    """``use_approx_jac=True`` supplies the block-diagonal Newton Jacobian:
    the same answers; explicit methods warn and ignore the flag."""
    sens, yf, _ = forward("KC4I", "autodiff", approx=True)
    np.testing.assert_allclose(yf, YF, rtol=1e-3)
    np.testing.assert_allclose(sens, SENS, rtol=1e-3)
    with pytest.warns(UserWarning, match="use_approx_jac"):
        sens_forward(fun, (0.0, 1e-3), y0_cpu(), None, None, DY0DP, p=P,
                     method=BS5, rtol=RTOL, atol=ATOL, use_approx_jac=True)


def test_sens_forward_sparsity_pattern_matches_dense_jac():
    """The default implicit path's block pattern covers every structural
    nonzero of the augmented RHS's dense AD Jacobian, in 2 ny groups."""
    Ny, Np = 3, 3
    m = (Np + 1) * Ny
    S = np.zeros((m, m), dtype=int)
    S[:, :Ny] = 1
    for i in range(Np):
        S[(i + 1) * Ny:(i + 2) * Ny, (i + 1) * Ny:(i + 2) * Ny] = 1
    _, ng = group_columns(S)
    assert ng == 2 * Ny

    p = torch.tensor(P, dtype=torch.float64)
    eye = torch.eye(Np, dtype=torch.float64)

    def total_fun(z):
        y, s = z[:Ny], z[Ny:].reshape(Np, Ny)
        ds = torch.stack([torch.func.jvp(
            lambda yy, pp: fun(0.1, yy, *pp), (y, p), (s[i], eye[i]))[1]
            for i in range(Np)])
        return torch.cat([fun(0.1, y, *P), ds.reshape(-1)])

    z = torch.as_tensor(np.concatenate(
        [[1.0, 2e-5, 0.01], np.random.default_rng(1).standard_normal(9)]))
    Jd = torch.func.jacfwd(total_fun)(z).numpy()
    assert not np.any((Jd != 0) & (S == 0)), \
        "pattern misses a structural nonzero"


def test_sens_adjoint_end():
    for i, (sens, gf, _, _) in enumerate(adjoint_end()):
        np.testing.assert_allclose(gf, YF[i], rtol=1e-3)
        np.testing.assert_allclose(sens, SENS[i], rtol=1e-2, atol=1e-13)


def test_sens_adjoint_int():
    sens, G, sol_y, sol_bw = adjoint_int()
    np.testing.assert_allclose(sol_y.y[:, -1],
                               [5.2016e-05, 2.0808e-10, 9.9995e-01],
                               rtol=1e-2)
    np.testing.assert_allclose(G, 1.8219e4, rtol=5e-3)
    np.testing.assert_allclose(sens, [-7.8383e5, 3.1991, -5.3301e-4],
                               rtol=1e-2)
    np.testing.assert_allclose(sol_bw.y[:3, -1],
                               [3.4249e4, 3.4206e4, 3.4139e4], rtol=1e-2)


def test_grad_native_adjoint():
    """``torch.autograd.grad`` through a whole device solve (the
    continuous adjoint) agrees with forward sensitivities and central
    differences."""
    mu = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    y0 = torch.tensor([2.0, 0.0], dtype=torch.float64)
    gmu, = torch.autograd.grad(
        solve_final(vdp, (0.0, 5.0), y0, mu, BS5, 1e-9, 1e-12)[0], mu)
    sens, _, _ = sens_forward(lambda t, y, m: vdp(t, y, m), (0.0, 5.0),
                              y0, p=(1.5,), rtol=1e-10, atol=1e-13,
                              method=BS5)
    np.testing.assert_allclose(float(gmu), sens[0, 0], rtol=1e-6)

    y0g = y0.clone().requires_grad_(True)
    gy0, = torch.autograd.grad(
        solve_final(vdp, (0.0, 5.0), y0g, 1.5, BS5, 1e-9, 1e-12)[0], y0g)

    def yf0(y):
        return float(solve_final(vdp, (0.0, 5.0),
                                 torch.tensor(y, dtype=torch.float64), 1.5,
                                 BS5, 1e-11, 1e-14)[0])

    eps = 1e-6
    fd = [(yf0([2 + eps, 0]) - yf0([2 - eps, 0])) / (2 * eps),
          (yf0([2, eps]) - yf0([2, -eps])) / (2 * eps)]
    np.testing.assert_allclose(gy0.numpy(), fd, rtol=1e-6)


def test_grad_native_batched():
    """The batched form (a leading member axis on ``y0`` and ``p``,
    ``solve_ensemble`` underneath): each member's gradient equals its
    single solve's at the JAX test's rtol 1e-8, and the time gradients sum
    over the members."""
    mus = torch.linspace(0.5, 2.0, 4, dtype=torch.float64)
    mus.requires_grad_(True)
    tf = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    y0 = torch.tensor([2.0, 0.0], dtype=torch.float64).repeat(4, 1)
    yf = solve_final(vdp, (0.0, tf), y0, mus, BS5, 1e-8, 1e-11)
    assert yf.shape == (4, 2)
    grads, gtf = torch.autograd.grad(yf[:, 0].sum(), (mus, tf))
    assert grads.shape == (4,)
    gtf_single = 0.0
    for j in range(4):
        mu = mus[j].detach().clone().requires_grad_(True)
        tj = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
        g1, gt = torch.autograd.grad(solve_final(
            vdp, (0.0, tj), y0[0], mu, BS5, 1e-8, 1e-11)[0], (mu, tj))
        np.testing.assert_allclose(float(grads[j]), float(g1), rtol=1e-8)
        gtf_single += float(gt)
    np.testing.assert_allclose(float(gtf), gtf_single, rtol=1e-8)


def test_solve_final_tuple_params():
    """``p`` as a tuple of tensors: one gradient per leaf, the flat
    order of JAX's ``ravel_pytree``."""
    def f(t, y, p):
        a, b = p
        return torch.stack([y[1], a * (1 - y[0] ** 2) * y[1] - b[0] * y[0]])
    a = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    b = torch.tensor([1.0], dtype=torch.float64, requires_grad=True)
    y0 = torch.tensor([2.0, 0.0], dtype=torch.float64)
    ga, gb = torch.autograd.grad(solve_final(
        f, (0.0, 2.0), y0, (a, b), BS5, 1e-9, 1e-12)[0], (a, b))
    sens, _, _ = sens_forward(lambda t, y, aa, bb: f(t, y, (aa, [bb])),
                              (0.0, 2.0), y0, p=(1.5, 1.0), rtol=1e-10,
                              atol=1e-13, method=BS5)
    np.testing.assert_allclose([float(ga), float(gb[0])], sens[0],
                               rtol=1e-6)


_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from extensisq_tpu import KC4I, TRBDF2
    from extensisq_tpu.sensitivity import (sens_forward, sens_adjoint_end,
                                           sens_adjoint_int)

    def fun(t, y, *p):
        p1, p2, p3 = p
        return jnp.stack([-p1 * y[0] + p2 * y[1] * y[2],
                          p1 * y[0] - p2 * y[1] * y[2] - p3 * y[1] ** 2,
                          p3 * y[1] ** 2])

    def jac(t, y, *p):
        p1, p2, p3 = p
        return jnp.array([[-p1, p2 * y[2], p2 * y[1]],
                          [p1, -p2 * y[2] - 2 * p3 * y[1], -p2 * y[1]],
                          [0.0, 2 * p3 * y[1], 0.0]])

    def dfdp(t, y, *p):
        return jnp.array([[-y[0], y[1] * y[2], 0.0],
                          [y[0], -y[1] * y[2], -y[1] ** 2],
                          [0.0, 0.0, y[1] ** 2]])

    COUNTS = %r
    Y0 = np.array([1.0, 0.0, 0.0]); P = (0.04, 1e4, 3e7)
    DY0DP = np.zeros((3, 3)); RTOL = 1e-4
    ATOL = np.array([1e-8, 1e-14, 1e-6])
    out = {}

    def counts(name, sol):
        out[name] = np.asarray([sol[k] for k in COUNTS])

    for name in json.loads(sys.argv[2]):
        if name.startswith("fwd"):
            _, m, derivs = name.split("_")
            J, D = (jac, dfdp) if derivs == "analytic" else (None, None)
            sens, yf, sol = sens_forward(
                fun, (0.0, 0.4), Y0, J, D, DY0DP, p=P,
                method={"KC4I": KC4I, "TRBDF2": TRBDF2}[m], rtol=RTOL,
                atol=ATOL)
            out[name + "/sens"], out[name + "/yf"] = sens, yf
            counts(name + "/counts", sol)
        elif name == "end":
            sol_y = None
            for i in range(3):
                r = sens_adjoint_end(
                    fun, (0.0, 0.4), Y0, None, None, DY0DP, P,
                    lambda t, y, *p, i=i: jnp.array([y[i]]), None, None,
                    method=KC4I, atol=ATOL, rtol=RTOL, atol_adj=1e-6,
                    atol_quad=1e-7, sol_y=sol_y)
                sol_y = r.sol_y
                out[f"end{i}/sens"] = r.sens
                out[f"end{i}/gf"] = np.asarray(r.gf)
                counts(f"end{i}/bw", r.sol_bw)
            counts("end/fw", sol_y)
        elif name == "int":
            r = sens_adjoint_int(
                fun, (0.0, 4e7), Y0, None, None, DY0DP, P,
                lambda t, y, *p: jnp.array([y[0] + p[1] * y[1] * y[2]]),
                None, None, method=KC4I, atol=ATOL, rtol=RTOL,
                atol_adj=1e-5, atol_quad=1e-6)
            out["int/sens"], out["int/G"] = r.sens, np.asarray(r.G)
            out["int/ybw"] = r.sol_bw.y[:, -1]
            counts("int/fw", r.sol_y)
            counts("int/bw", r.sol_bw)
    np.savez(sys.argv[3], **out)
""") % (COUNTS,)

FWD = [f"fwd_{m}_{d}" for m in ("KC4I", "TRBDF2")
       for d in ("analytic", "autodiff")]


@functools.lru_cache(maxsize=None)
def _jax(tmp):
    from pathlib import Path
    d = Path(tmp)
    np.savez(d / "in.npz", dummy=np.zeros(1))

    def warm():
        for name in FWD:
            forward(*name.split("_")[1:])
        adjoint_end()
        adjoint_int()
    return run_jax(_JAX_SCRIPT, d, [FWD[:2], FWD[2:], ["end"], ["int"]],
                   warm=(warm,))


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return _jax(str(tmp_path_factory.mktemp("sens")))


def close(a, b, gate=GATE):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(b), 1e-300)
    assert np.all(np.abs(a - b) <= gate * scale), np.max(
        np.abs(a - b) / scale)


@pytest.mark.parametrize("name", FWD)
def test_sens_forward_matches_jax(jx, name):
    sens, yf, sol = forward(*name.split("_")[1:])
    assert [sol[k] for k in COUNTS] == list(jx[name + "/counts"])
    close(sens, jx[name + "/sens"])
    close(yf, jx[name + "/yf"])


def test_sens_adjoints_match_jax(jx):
    out = adjoint_end()
    assert [out[0].sol_y[k] for k in COUNTS] == list(jx["end/fw"])
    for i, r in enumerate(out):
        assert [r.sol_bw[k] for k in COUNTS] == list(jx[f"end{i}/bw"])
        close(r.sens, jx[f"end{i}/sens"])
        close(r.gf, jx[f"end{i}/gf"])
    r = adjoint_int()
    assert [r.sol_y[k] for k in COUNTS] == list(jx["int/fw"])
    assert [r.sol_bw[k] for k in COUNTS] == list(jx["int/bw"])
    close(r.sens, jx["int/sens"], 1e-8)
    close(r.G, jx["int/G"], 1e-8)
    close(r.sol_bw.y[:, -1], jx["int/ybw"], 1e-8)
