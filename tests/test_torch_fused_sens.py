"""The port's fused sensitivities (``ops/fused_sens.py``) on the CPU.

``solve_fused_sens`` and ``solve_fused_final`` run here through the plain
versions of B1 and B2 (``fused_erk_reference``, ``fused_esdirk_reference``
with ``block_base``), held to what the JAX package's
``tests/test_fused_sens.py`` holds its fused path to: central differences
of the fused primal, the f64 ``sens_forward`` and ``jacrev`` of the f64
``solve_final`` of the JAX package (one no-FMA subprocess, run while the
port's cases run), the CVODES Robertson table and ``expm`` of a linear
system.  The tests marked ``gpu`` run the kernels on the card against the
plain versions; they skip where there is none.
"""
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg as sl
import torch

from extensisq_tpu_torch import BS5, SSV2stab, TRBDF2
from extensisq_tpu_torch.ops import (FusedRHS, solve_fused_adjoint,
                                     solve_fused_erk, solve_fused_esdirk,
                                     solve_fused_final, solve_fused_sens)

sys.path.insert(0, str(Path(__file__).resolve().parent))
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
    (dict(), NotImplementedError, "A16")])
def test_fused_sens_grid_layout_raises(kw, error, match):
    """layout="grid": JAX's ValueError for sens_y0 first, then
    NotImplementedError until params and block_base reach B4 and B7."""
    Y0, mus = _vdp_setup()
    with pytest.raises(error, match=match):
        solve_fused_sens(VDP_P, SPAN, Y0, params=mus, layout="grid", **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(), "nothing to differentiate"),
    (dict(params=np.ones((B - 1, 1), np.float32)), r"params must be \(B, k\)"),
    (dict(params=np.ones((B, 2), np.float32)), "k = 1")])
def test_fused_sens_argument_checks(kw, match):
    Y0, _ = _vdp_setup()
    with pytest.raises(ValueError, match=match):
        solve_fused_sens(VDP_P, SPAN, Y0, **kw)


def test_fused_adjoint_not_ported_yet():
    with pytest.raises(NotImplementedError, match="dense"):
        solve_fused_adjoint(VDP_P, SPAN, *_vdp_setup())


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
