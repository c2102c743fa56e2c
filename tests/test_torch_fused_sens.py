"""The port's fused sensitivities (``ops/fused_sens.py``) on the CPU.

``solve_fused_sens`` and ``solve_fused_final`` run here through the plain
versions of B1 and B2 (``fused_erk_reference``, ``fused_esdirk_reference``
with ``block_base``), held to what the JAX package's
``tests/test_fused_sens.py`` holds its fused path to: central differences
of the fused primal, the f64 ``sens_forward`` and ``jacrev`` of the f64
``solve_final`` of the JAX package (one no-FMA subprocess, run while the
port's cases run), the CVODES Robertson table and ``expm`` of a linear
system.  The grid layout (``layout="grid"``, B4 and B7's simultaneous
corrector) runs JAX's three grid cases (an analytic decay, a Fisher MoL
and a stiff reaction-diffusion sweep) against the JAX package's fused
outputs and f64 ``sens_forward`` in ``tests/jax_fused_sens_grid.npz``
(``tests/jax_fused_sens_grid.py``), and the Fisher sweep also against
central differences of B4 with params.  The tests marked ``gpu`` run the
kernels on the card against the plain versions; they skip where there is
none.
"""
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg as sl
import torch

from extensisq_tpu_torch import BS5, SSV2stab, TRBDF2
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRHS, solve_fused_erk,
                                     solve_fused_erk_grid, solve_fused_esdirk,
                                     solve_fused_final, solve_fused_sens)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_erk_grid as TG  # noqa: E402
import test_torch_fused_esdirk_grid as TEG  # noqa: E402
from jax_reference import run_jax  # noqa: E402

B = 128
SPAN = (0.0, 3.0)
VDP_P = FusedRHS(
    lambda t, y, p: torch.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]]),
    """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = y[1];
  dy[1] = p[0] * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2, 1)


def _rob(t, y, p):
    r1 = p[0] * y[0]
    r2 = p[1] * y[1] * y[2]
    r3 = p[2] * y[1] * y[1]
    return torch.stack([-r1 + r2, r1 - r2 - r3, r3])


ROB_P = FusedRHS(_rob, """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  const T r1 = p[0] * y[0];
  const T r2 = p[1] * y[1] * y[2];
  const T r3 = p[2] * y[1] * y[1];
  dy[0] = -r1 + r2;
  dy[1] = r1 - r2 - r3;
  dy[2] = r3;
}""", 3, 3)
# a mildly stiff parameterized pair (the JAX test_fused_esdirk_final_grad)
RELAX_P = FusedRHS(
    lambda t, y, p: torch.stack([-p[0] * (y[0] - torch.sin(y[1])),
                                 -y[1] + 0.1 * y[0]]),
    """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = -p[0] * (y[0] - sin(y[1]));
  dy[1] = -y[1] + 0.1f * y[0];
}""", 2, 1)

# CVODES Robertson forward-sensitivity table at t = 0.4
CVODES_YF = np.array([9.8517e-01, 3.3864e-05, 1.4794e-02])
CVODES_SENS = np.array([[-3.5595e-01, 9.5428e-08, -1.5832e-11],
                        [3.9026e-04, -2.1310e-10, -5.2900e-13],
                        [3.5556e-01, -9.5215e-08, 1.6361e-11]])


def _vdp_setup():
    Y0 = np.zeros((B, 2), np.float32)
    Y0[:, 0] = 2.0
    mus = np.linspace(1.0, 2.0, B).astype(np.float32)[:, None]
    return torch.tensor(Y0), torch.tensor(mus)


def _fd(y0, mus, eps, **kw):
    """Central differences of B1 with params (the plain version here)."""
    yp = solve_fused_erk(VDP_P, SPAN, y0, params=mus + eps, **kw)[0]
    ym = solve_fused_erk(VDP_P, SPAN, y0, params=mus - eps, **kw)[0]
    return (yp - ym) / (2 * eps)


_JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from extensisq_tpu import sensitivity

    def vdp(t, y, mu):
        return jnp.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])

    def relax(t, y, k):
        return jnp.stack([-k * (y[0] - jnp.sin(y[1])), -y[1] + 0.1 * y[0]])

    out = sensitivity.sens_forward(vdp, (0.0, 3.0), np.array([2.0, 0.0]),
                                   p=(1.0,), rtol=1e-9, atol=1e-11)
    J = jax.jacrev(lambda y0: sensitivity.solve_final(
        vdp, (0.0, 3.0), y0, 1.0, None, 1e-9, 1e-11, 10_000))(
            jnp.array([2.0, 0.0]))
    Jr = jax.jacrev(lambda y0: sensitivity.solve_final(
        relax, (0.0, 1.0), y0, 50.0, None, 1e-9, 1e-12, 10_000))(
            jnp.array([2.0, 1.0]))
    np.savez(sys.argv[3], yf=np.asarray(out.yf),
             sensf=np.asarray(out.sensf), jac_y0=np.asarray(J),
             jac_relax=np.asarray(Jr))
""")


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    """The JAX package's f64 sens_forward and jacrev(solve_final) values,
    from one subprocess, and meanwhile the port's fused runs of the
    Van der Pol sweep: solve_fused_sens with sens_y0, and the gradient of
    sum(y_f[:, 0]) through solve_fused_final."""
    d = tmp_path_factory.mktemp("jax_fused_sens")
    np.savez(d / "in.npz", none=np.zeros(1))
    port = {}

    def run_port():
        Y0, mus = _vdp_setup()
        port["sens"] = solve_fused_sens(VDP_P, SPAN, Y0, params=mus,
                                        sens_y0=True, rtol=1e-5, atol=1e-7)
        tsp = (torch.tensor(SPAN[0], requires_grad=True),
               torch.tensor(SPAN[1], requires_grad=True))
        Y = Y0.clone().requires_grad_(True)
        P = mus.clone().requires_grad_(True)
        yf = solve_fused_final(VDP_P, tsp, Y, P, BS5, 1e-5, 1e-7)
        port["yf"] = yf.detach()
        port["grads"] = torch.autograd.grad(yf[:, 0].sum(), (*tsp, Y, P))
    out = run_jax(_JAX_SCRIPT, d, [{}], warm=(run_port,))
    return out, port


def test_fused_sens_matches_fd_and_jax(jax_and_port):
    """S_p from the variational solve against central differences of B1
    with params over the whole mu sweep (3e-3), and member 0 against the
    JAX package's f64 sens_forward (y_f 1e-4, S_p 1e-3) and S_y0 against
    jacrev of its f64 solve_final (1e-3): the JAX test's gates."""
    jx, port = jax_and_port
    yf, Sp, Sy0, st, ns, nf = port["sens"]
    assert torch.all(st == 1)
    assert Sp.shape == (B, 2, 1) and Sy0.shape == (B, 2, 2)
    Y0, mus = _vdp_setup()
    fd = _fd(Y0, mus, 1e-3, method=BS5, rtol=1e-7, atol=1e-9,
             compensated=True)
    assert (Sp[:, :, 0] - fd).abs().max().item() < 3e-3
    assert np.max(np.abs(yf[0].numpy() - jx["yf"])) < 1e-4
    assert np.max(np.abs(Sp[0, :, 0].numpy() - jx["sensf"][:, 0])) < 1e-3
    assert np.max(np.abs(Sy0[0].numpy() - jx["jac_y0"])) < 1e-3


def test_fused_final_grad(jax_and_port):
    """Gradients through solve_fused_final: dL/dmu against central
    differences (3e-3), dL/dy0 against jacrev of the JAX package's f64
    solve_final (1e-3), the cotangent contracted with solve_fused_sens's
    S_y0 and S_p bit for bit, and the t_span ends: f(t_f, y_f) summed, and
    dt0 + dtf ~ 0 for an autonomous system."""
    jx, port = jax_and_port
    dt0, dtf, gy0, gp = port["grads"]
    Y0, mus = _vdp_setup()
    fd = _fd(Y0, mus, 1e-3, method=BS5, rtol=1e-7, atol=1e-9,
             compensated=True)
    assert (gp[:, 0] - fd[:, 0]).abs().max().item() < 3e-3
    assert np.max(np.abs(gy0[0].numpy() - jx["jac_y0"][0, :])) < 1e-3
    _, Sp, Sy0, _, _, _ = solve_fused_sens(VDP_P, SPAN, Y0, params=mus,
                                           method=BS5, sens_y0=True,
                                           rtol=1e-5, atol=1e-7)
    assert torch.equal(gy0, Sy0[:, 0, :])
    assert torch.equal(gp, Sp[:, 0, :])
    yf = port["yf"]
    f_tf = VDP_P.torch_fn(torch.full((B,), SPAN[1]), yf.T, (mus[:, 0],))
    assert abs(float(dtf) - float(f_tf[0].sum())) <= 1e-5 * abs(float(dtf))
    assert abs(float(dt0) + float(dtf)) < 0.05 * abs(float(dtf))


def test_fused_esdirk_sens_robertson_cvodes():
    """Stiff forward sensitivities through B2's simultaneous corrector
    (block_base = 3): member 0 at the CVODES table, y_f within 5e-4 and
    each dy/dp_j column scaled by its largest entry within 2e-2, and all
    members (the same params) identical."""
    Bs = 8
    y0b = torch.tensor([[1.0, 0.0, 0.0]]).repeat(Bs, 1)
    pb = torch.tensor([[0.04, 1e4, 3e7]]).repeat(Bs, 1)
    yf, Sp, Sy0, st, ns, nf = solve_fused_sens(
        ROB_P, (0.0, 0.4), y0b, params=pb, method=TRBDF2, rtol=1e-4,
        atol=1e-8)
    assert torch.all(st == 1)
    assert Sp.shape == (Bs, 3, 3) and Sy0 is None
    np.testing.assert_allclose(yf[0].numpy(), CVODES_YF, rtol=5e-4)
    S = Sp[0].numpy()
    for j in range(3):
        scale = np.abs(CVODES_SENS[:, j]).max()
        np.testing.assert_allclose(S[:, j] / scale, CVODES_SENS[:, j] / scale,
                                   atol=2e-2)
    assert (Sp - Sp[0]).abs().max().item() == 0.0


def test_fused_esdirk_final_grad(jax_and_port):
    """solve_fused_final with an ESDIRK method (the backward pass through
    B2's simultaneous corrector): dL/dk against central differences of
    the fused primal (5e-5) and dL/dy0 of member 0 against jacrev of the
    JAX package's f64 solve_final (1e-4), the JAX test's gates."""
    jx, _ = jax_and_port
    Bs = 8
    y0b = torch.tensor([[2.0, 1.0]]).repeat(Bs, 1)
    ks = torch.linspace(50.0, 400.0, Bs)[:, None]
    Y = y0b.clone().requires_grad_(True)
    P = ks.clone().requires_grad_(True)
    yf = solve_fused_final(RELAX_P, (0.0, 1.0), Y, P, TRBDF2, 1e-5, 1e-8)
    gy0, gp = torch.autograd.grad(yf[:, 0].sum(), (Y, P))
    eps = 0.5
    kw = dict(method=TRBDF2, rtol=1e-6, atol=1e-9)
    yp = solve_fused_esdirk(RELAX_P, (0.0, 1.0), y0b, params=ks + eps,
                            **kw)[0]
    ym = solve_fused_esdirk(RELAX_P, (0.0, 1.0), y0b, params=ks - eps,
                            **kw)[0]
    fd = (yp[:, 0] - ym[:, 0]) / (2 * eps)
    assert (gp[:, 0] - fd).abs().max().item() < 5e-5
    assert np.max(np.abs(gy0[0].numpy() - jx["jac_relax"][0, :])) < 1e-4


def test_fused_sens_y0_only():
    """params None with sens_y0=True, and the (t, y) right-hand side: for a
    constant-coefficient system S_y0 = expm(A) and y_f = expm(A) y0
    (1e-5)."""
    def lin(t, y):
        return torch.stack([-0.5 * y[0] + 0.2 * y[1], -0.3 * y[1]])

    Y0 = torch.tensor([[1.0, 2.0]]).repeat(B, 1)
    yf, Sp, Sy0, st, ns, nf = solve_fused_sens(
        lin, (0.0, 1.0), Y0, sens_y0=True, rtol=1e-6, atol=1e-9)
    assert torch.all(st == 1)
    assert Sp.shape == (B, 2, 0)
    E = sl.expm(np.array([[-0.5, 0.2], [0.0, -0.3]]))
    assert np.max(np.abs(Sy0[0].numpy() - E)) < 1e-5
    assert np.max(np.abs(yf[0].numpy() - E @ np.array([1.0, 2.0]))) < 1e-5


def test_fused_sens_rejects_unsupported_family():
    Y0, mus = _vdp_setup()
    with pytest.raises(ValueError, match="family"):
        solve_fused_sens(VDP_P, SPAN, Y0, params=mus, method=SSV2stab)


@pytest.mark.parametrize("kw,error,match", [
    (dict(sens_y0=True), ValueError, "sens_y0 on the grid"),
    (dict(method=SSV2stab), ValueError, "family"),
    (dict(fun=TG.FISHER_P), ValueError, r"shape \(2,\)")])
def test_fused_sens_grid_layout_raises(kw, error, match):
    """layout="grid": JAX's ValueError for sens_y0 before anything else
    (even with the flat layout's FusedRHS), the families other than erk
    and esdirk, and a FusedGridRHS whose shape is not the state's."""
    Y0, mus = _vdp_setup()
    kw = dict(kw)
    with pytest.raises(error, match=match):
        solve_fused_sens(kw.pop("fun", VDP_P), SPAN, Y0, params=mus,
                         layout="grid", **kw)


# -- the grid layout ---------------------------------------------------------
GRID = np.load(Path(__file__).resolve().parent / "jax_fused_sens_grid.npz")
DECAY_G = FusedGridRHS(lambda t, y, p: -p[0] * y, """template <class T, class V>
__device__ T rhs(T t, V y, int i, const T* p) { return -p[0] * y[i]; }""",
                       (32,), 1)


def _grid_case(name, fun, span, **kw):
    """The port's grid-layout sensitivities (plain versions) on case
    ``name`` of the JAX fixture, its inputs checked equal to the tests'
    own, and the fixture's outputs."""
    y0 = GRID[name + "/y0"]
    p = GRID[name + "/params"]
    out = solve_fused_sens(fun, span, torch.tensor(y0),
                           params=torch.tensor(p), layout="grid", **kw)
    yf, Sp, Sy0, st, ns, nf = out
    assert Sy0 is None and Sp.shape == (len(y0), y0.shape[1], p.shape[1])
    jax = [GRID[f"{name}/{i}"] for i in (0, 1, 3, 4, 5)]
    return [x.numpy() for x in (yf, Sp, st, ns, nf)], jax


def test_fused_sens_grid_decay_analytic():
    """JAX's analytic grid case (n = 32, a in [0.5, 1.5]) through B4's
    plain version: y_f and S_a = -t y0 e^{-a t} within JAX's gates (5e-5
    and 5e-4 relative; measured 2.4e-7 on both), the JAX kernel's counts
    identical and its outputs within 4e-7 (measured 1.8e-7 and 2.4e-7)."""
    y0 = np.tile(np.linspace(1.0, 2.0, 32, dtype=np.float32), (8, 1))
    rates = np.linspace(0.5, 1.5, 8).astype(np.float32)[:, None]
    np.testing.assert_array_equal(y0, GRID["sens_decay/y0"])
    np.testing.assert_array_equal(rates, GRID["sens_decay/params"])
    (yf, Sp, st, ns, nf), (jy, jS, jst, jns, jnf) = _grid_case(
        "sens_decay", DECAY_G, (0.0, 1.0), rtol=1e-6, atol=1e-9)
    assert np.all(st == 1)
    ex = y0 * np.exp(-rates)
    np.testing.assert_allclose(yf, ex, rtol=5e-5)
    np.testing.assert_allclose(Sp[:, :, 0], -ex, rtol=5e-4)
    for a, b in ((st, jst), (ns, jns), (nf, jnf)):
        np.testing.assert_array_equal(a, b)
    assert np.max(np.abs(yf - jy)) <= 4e-7
    assert np.max(np.abs(Sp - jS)) <= 4e-7


def test_fused_sens_grid_fisher_matches_jax_and_fd():
    """JAX's Fisher grid case (n = 64, periodic upwind, r in [0.8, 1.2])
    through B4's plain version on the variational system: against the JAX
    kernel, status and nsteps identical, nfev apart on at most 4 members
    by at most 14 (measured 2 members, 7: one rejected attempt), y_f within
    1e-5 and S_p within 2e-6 (measured 5.1e-6 and 1.1e-6); against central
    differences of B4 with params (eps 4e-3, rtol 1e-7 / atol 1e-10),
    within JAX's 6e-3 of the largest |FD|."""
    y0, r = TG.fisher_p_inputs()
    np.testing.assert_array_equal(y0, GRID["sens_fisher/y0"])
    np.testing.assert_array_equal(r, GRID["sens_fisher/params"])
    (yf, Sp, st, ns, nf), (jy, jS, jst, jns, jnf) = _grid_case(
        "sens_fisher", TG.FISHER_P, (0.0, 0.25), rtol=1e-5, atol=1e-8)
    assert np.all(st == 1)
    np.testing.assert_array_equal(st, jst)
    np.testing.assert_array_equal(ns, jns)
    assert np.max(np.abs(nf - jnf)) <= 14 and np.sum(nf != jnf) <= 4
    assert np.max(np.abs(yf - jy)) <= 1e-5
    assert np.max(np.abs(Sp - jS)) <= 2e-6
    eps = np.float32(4e-3)
    kw = dict(rtol=1e-7, atol=1e-10)
    y0t = torch.tensor(y0)
    yp = solve_fused_erk_grid(TG.FISHER_P, (0.0, 0.25), y0t,
                              params=torch.tensor(r + eps), **kw)[0]
    ym = solve_fused_erk_grid(TG.FISHER_P, (0.0, 0.25), y0t,
                              params=torch.tensor(r - eps), **kw)[0]
    fd = ((yp - ym) / (2 * eps)).numpy()
    assert np.max(np.abs(Sp[:, :, 0] - fd)) < 6e-3 * np.abs(fd).max()


def test_fused_sens_grid_esdirk_matches_jax_and_f64():
    """JAX's stiff grid case (the edge-replicated reaction-diffusion, n =
    64, k in [5, 30], D = 200: three blocks) through B7's simultaneous
    corrector (``block_base=n``) with TRBDF2: against the JAX kernel,
    status and counts identical, y_f within 1e-6 and S_p within 1e-8
    (measured 3.6e-7 and 3.7e-9); members 0 and 7 against the JAX
    package's f64 sens_forward within JAX's gates, |dy| 2e-5 and each
    column of S_p within 3e-3 of its largest entry."""
    y0, P = TEG.rd_p_inputs()
    np.testing.assert_array_equal(y0, GRID["sens_rd/y0"])
    np.testing.assert_array_equal(P, GRID["sens_rd/params"])
    (yf, Sp, st, ns, nf), (jy, jS, jst, jns, jnf) = _grid_case(
        "sens_rd", TEG.RD_P, (0.0, 0.04), method=TRBDF2, rtol=1e-5,
        atol=1e-8)
    assert np.all(st == 1)
    for a, b in ((st, jst), (ns, jns), (nf, jnf)):
        np.testing.assert_array_equal(a, b)
    assert np.max(np.abs(yf - jy)) <= 1e-6
    assert np.max(np.abs(Sp - jS)) <= 1e-8
    for b in (0, 7):
        ref_y = GRID[f"sens_rd_f64/{b}/yf"]
        ref_S = GRID[f"sens_rd_f64/{b}/sensf"]
        assert np.max(np.abs(yf[b] - ref_y)) < 2e-5
        for j in range(2):
            sc = max(np.abs(ref_S[:, j]).max(), 1e-12)
            assert np.max(np.abs(Sp[b, :, j] - ref_S[:, j])) < 3e-3 * sc


@pytest.mark.parametrize("kw,match", [
    (dict(), "nothing to differentiate"),
    (dict(params=np.ones((B - 1, 1), np.float32)), r"params must be \(B, k\)"),
    (dict(params=np.ones((B, 2), np.float32)), "k = 1")])
def test_fused_sens_argument_checks(kw, match):
    Y0, _ = _vdp_setup()
    with pytest.raises(ValueError, match=match):
        solve_fused_sens(VDP_P, SPAN, Y0, **kw)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sens_kernels_match_plain_versions_on_card(cuda):
    """solve_fused_sens on CUDA tensors (one launch of B1, or of B2 in
    block_base mode) against the same call on the plain versions on the
    card, at the gates chip_smoke.py measured (its sensitivity phase)."""
    from extensisq_tpu_torch.ops import fused_erk_reference
    from extensisq_tpu_torch.ops import fused_esdirk_reference
    from extensisq_tpu_torch.ops.fused_sens import _aug_rhs
    Y0, mus = (x.to(cuda) for x in _vdp_setup())
    before = solve_fused_erk.launches
    out = solve_fused_sens(VDP_P, SPAN, Y0, params=mus, sens_y0=True,
                           rtol=1e-5, atol=1e-8)
    assert solve_fused_erk.launches == before + 1
    Ya = torch.cat([Y0, torch.zeros_like(Y0),
                    torch.eye(2, device=cuda).reshape(1, 4).repeat(B, 1)], 1)
    r = fused_erk_reference(_aug_rhs(VDP_P, 2, 1, 2), SPAN, Ya, params=mus,
                            rtol=1e-5, atol=1e-8)
    assert torch.equal(out[3], r[1])
    assert (out[1][:, :, 0] - r[0][:, 2:4]).abs().max().item() <= 2e-3
    y0b = torch.tensor([[1.0, 0.0, 0.0]], device=cuda).repeat(64, 1)
    pb = torch.tensor([[0.04, 1e4, 3e7]], device=cuda).repeat(64, 1)
    before = solve_fused_esdirk.launches
    yf, Sp, _, st, _, _ = solve_fused_sens(
        ROB_P, (0.0, 0.4), y0b, params=pb, method=TRBDF2, rtol=1e-4,
        atol=1e-8)
    assert solve_fused_esdirk.launches == before + 1
    Yb = torch.cat([y0b, torch.zeros(64, 9, device=cuda)], 1)
    r = fused_esdirk_reference(_aug_rhs(ROB_P, 3, 3, 0), (0.0, 0.4), Yb,
                               method=TRBDF2, params=pb, block_base=3,
                               rtol=1e-4, atol=1e-8)
    assert torch.equal(st, r[1])
    assert (yf - r[0][:, :3]).abs().max().item() <= 5e-5


@pytest.mark.gpu
def test_sens_grid_kernels_match_plain_versions_on_card(cuda):
    """solve_fused_sens(layout="grid") on CUDA tensors (one launch of B4, or
    of B7 in block_base mode) against the same call on the plain versions
    on the card: status equal, y_f and S_p within the grid kernels' card
    gates (test_torch_fused_erk_grid.py, test_torch_fused_esdirk_grid.py);
    a bare callable raises TypeError, as the grid wrappers do."""
    from extensisq_tpu_torch.ops import (fused_erk_grid_reference,
                                         fused_esdirk_grid_reference,
                                         solve_fused_esdirk_grid)
    from extensisq_tpu_torch.ops.fused_sens import _aug_grid_rhs
    cases = [(TG.FISHER_P, TG.fisher_p_inputs(), (0.0, 0.25), {},
              solve_fused_erk_grid, fused_erk_grid_reference,
              TG.CARD_GATES["fisher_h0"]),
             (TEG.RD_P, TEG.rd_p_inputs(), (0.0, 0.04),
              dict(method=TRBDF2, block_base=TEG.N_P),
              solve_fused_esdirk_grid, fused_esdirk_grid_reference,
              TEG.CARD_GATES["rd_trbdf2"])]
    for fun, (y0, p), span, extra, wrapper, plain, gate in cases:
        y0, p = (torch.tensor(x, device=cuda) for x in (y0, p))
        n, k = y0.shape[1], p.shape[1]
        kw = dict(rtol=1e-5, atol=1e-8)
        before = wrapper.launches
        yf, Sp, Sy0, st, ns, nf = solve_fused_sens(
            fun, span, y0, params=p, layout="grid",
            method=extra.get("method"), **kw)
        assert wrapper.launches == before + 1 and Sy0 is None
        Y0 = torch.cat([y0, torch.zeros(len(y0), n * k, device=cuda)], 1)
        r = plain(_aug_grid_rhs(fun, n, k), span, Y0, params=p, **extra,
                  **kw)
        assert torch.equal(st, r[1]) and bool((st == 1).all())
        ref_S = r[0][:, n:].reshape(-1, k, n).transpose(1, 2)
        assert (yf - r[0][:, :n]).abs().max().item() <= gate
        assert (Sp - ref_S).abs().max().item() <= gate
        with pytest.raises(TypeError, match="FusedGridRHS"):
            solve_fused_sens(fun.torch_fn, span, y0, params=p,
                             layout="grid", method=extra.get("method"), **kw)
