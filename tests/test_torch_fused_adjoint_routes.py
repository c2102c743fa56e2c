"""The ESDIRK and RKN routes of the port's continuous adjoint
(``ops.solve_fused_adjoint`` through B2 and B7, B5 and B6) on the CPU.

The forward pass runs here on the plain versions with ``dense``, the
backward pass on the f64 ``solve_ensemble``.  Held against what the JAX
package's ``tests/test_fused_adjoint.py`` holds its cases to, and against
the JAX package's own gradients on the same inputs, read from
``tests/jax_fused_adjoint_routes.npz`` (``tests/jax_fused_adjoint_routes.py``):

* the stiff relaxation through B2 (TRBDF2, k a member): dL/dk within 5e-5
  of JAX's central differences of B2 with params, member 0's dL/dy0
  within 1e-4 of the f64 ``solve_final`` jacobian row;
* the reaction-diffusion through B7 (n = 64, k a member): dL/dk within
  5e-3 of scale of the central differences of B7 with params;
* the oscillator through B5 (w a member): dL/dw and dL/du0 within 5e-3 of
  their closed forms -tf sin(w tf) and cos(w tf);
* the wave through B6 (n = 32, c2 a member), which the JAX tests lack:
  dL/dc2 within 5e-3 of scale of central differences of B6 with params
  (compensated, rtol 1e-8).

The tests marked ``gpu`` run the four routes on the card, one forward
launch each, against the same calls on the CPU; they skip where there is
none.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import Fi5N, TRBDF2
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRHS,
                                     solve_fused_adjoint, solve_fused_esdirk,
                                     solve_fused_esdirk_grid,
                                     solve_fused_rkn, solve_fused_rkn_grid)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_dense_routes as TDR  # noqa: E402

FIXTURE = TDR.FIXTURE
N_RD = 64


def stiff(t, y, p):
    return torch.stack([-p[0] * (y[0] - torch.sin(y[1])),
                        -y[1] + 0.1 * y[0]])


STIFF = FusedRHS(stiff, """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = -p[0] * (y[0] - sin(y[1]));
  dy[1] = -y[1] + 0.1f * y[0];
}""", 2, 1)


def rd(t, y, p):
    left = torch.cat([y[:1], y[:-1]])
    right = torch.cat([y[1:], y[-1:]])
    return (left - 2.0 * y + right) * 200.0 - p[0] * (y - 1.0)


RD = FusedGridRHS(rd, f"""template <class T, class V>
__device__ T rhs(T t, V y, int i, const T* p) {{
  const T left = y[i > 0 ? i - 1 : 0];
  const T right = y[i < {N_RD - 1} ? i + 1 : {N_RD - 1}];
  return (left - 2.0f * y[i] + right) * 200.0f - p[0] * (y[i] - 1.0f);
}}""", (N_RD,), 1)


def _first(yf):
    return yf[:, 0].sum()


def _mean(yf):
    return yf.mean(1).sum()


# name -> (right-hand side, method, span, dense, layout, loss, rtol, atol)
ROUTES = {
    "adj_esdirk": (STIFF, TRBDF2, (0.0, 1.0), 256, "flat", _first, 1e-5,
                   1e-8),
    "adj_esdirk_grid": (RD, TRBDF2, (0.0, 0.04), 256, "grid", _mean, 1e-5,
                        1e-8),
    "adj_rkn": (TDR.OSC_P, Fi5N, (0.0, 2.0), 512, "flat", _first, 1e-6,
                1e-9),
    "adj_rkn_grid": (TDR.WAVE_P, Fi5N, (0.0, 0.5), 320, "grid", _first, 1e-6,
                     1e-9),
}


def _inputs(name, device="cpu"):
    return (torch.tensor(FIXTURE[f"{name}/in_{k}"], device=device)
            for k in ("y0", "params"))


def grads(name, device="cpu", dense=None):
    """(value, dL/dt0, dL/dtf, dL/dy0, dL/dp) of the route's loss."""
    fun, method, span, rows, layout, loss_of, rtol, atol = ROUTES[name]
    y0, p = _inputs(name, device)
    t0, tf = (torch.tensor(float(x), requires_grad=True, device=device)
              for x in span)
    Y = y0.clone().requires_grad_(True)
    P = p.clone().requires_grad_(True)
    yf = solve_fused_adjoint(fun, (t0, tf), Y, P, method, rtol, atol,
                             100_000, None, rows if dense is None else dense,
                             layout=layout)
    loss = loss_of(yf)
    loss.backward()
    return loss.detach(), t0.grad, tf.grad, Y.grad, P.grad


def _scaled(a, b):
    b = torch.as_tensor(b, dtype=a.dtype)
    return ((a - b).abs().max() / b.abs().max()).item()


_CACHE = {}


def _cached(name):
    if name not in _CACHE:
        _CACHE[name] = grads(name)
    return _CACHE[name]


# the gradients against the JAX package's on the same inputs: dL/dy0 and
# dL/dp over their largest entries, dt0 and dtf relative.  Measured
# (y0, params, t0, tf): adj_esdirk 1.0e-7, 6.3e-6, 4.0e-6, 2.2e-6;
# adj_esdirk_grid 3.6e-8, 1.4e-7, 0, 0; adj_rkn 2.4e-9, 5.2e-7, 0, 4.0e-6;
# adj_rkn_grid 1.8e-7, 1.9e-6, 0, 1.2e-7 (the forward solves part in the
# last bits of h from the second attempt, the backward solves' step
# sequences with them).  Gates about 5x, at least 1e-7
JAX_GATES = {"adj_esdirk": (5e-7, 3.2e-5, 2e-5, 1.1e-5),
             "adj_esdirk_grid": (2e-7, 7e-7, 1e-7, 1e-7),
             "adj_rkn": (1e-7, 2.6e-6, 1e-7, 2e-5),
             "adj_rkn_grid": (9e-7, 1e-5, 1e-7, 6e-7)}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_matches_jax(name):
    """Each route's value, dL/dy0, dL/dp and the t-span gradients against
    the JAX package's adjoint on the same inputs; every gradient finite."""
    val, gt0, gtf, gy0, gp = _cached(name)
    for g in (gt0, gtf, gy0, gp):
        assert bool(torch.isfinite(g).all())
    assert val.item() == pytest.approx(float(FIXTURE[f"{name}/value"]),
                                       rel=1e-6, abs=1e-7)
    gates = JAX_GATES[name]
    for g, key, gate in zip((gy0, gp, gt0, gtf),
                            ("y0", "params", "t0", "tf"), gates):
        assert _scaled(g, FIXTURE[f"{name}/{key}"]) <= gate, key


def test_esdirk_route_matches_fd_and_f64():
    """tests/test_fused_adjoint.py:185-225 through B2: dL/dk within 5e-5 of
    the central differences of B2 with params (eps 0.5, rtol 1e-6 / atol
    1e-9) and member 0's dL/dy0 within 1e-4 of the f64 solve_final
    jacobian row."""
    _, _, _, gy0, gp = _cached("adj_esdirk")
    fd = torch.tensor(FIXTURE["adj_esdirk/fd"])
    assert (gp[:, 0] - fd).abs().max().item() < 5e-5
    gref = torch.tensor(FIXTURE["adj_esdirk/gref0"])
    assert (gy0[0].double() - gref).abs().max().item() < 1e-4


def test_esdirk_grid_route_matches_fd():
    """tests/test_fused_adjoint.py:142-182 through B7: dL/dk within 5e-3
    of scale of the central differences of B7 with params (eps 0.1, rtol
    1e-6 / atol 1e-9); the port's own central differences agree with
    JAX's."""
    _, _, _, _, gp = _cached("adj_esdirk_grid")
    fd = torch.tensor(FIXTURE["adj_esdirk_grid/fd"])
    assert _scaled(gp[:, 0], fd) < 5e-3
    y0, k = _inputs("adj_esdirk_grid")
    kw = dict(method=TRBDF2, rtol=1e-6, atol=1e-9)
    yp, ym = (solve_fused_esdirk_grid(RD, (0.0, 0.04), y0, params=k + s,
                                      **kw)[0] for s in (0.1, -0.1))
    mine = (yp.mean(1) - ym.mean(1)) / 0.2
    assert _scaled(mine, fd) < 5e-3


def test_rkn_route_matches_closed_forms():
    """tests/test_fused_adjoint.py:228-267 through B5: for u'' = -w^2 u,
    u(0) = 1, L = sum u(tf): dL/dw = -tf sin(w tf) and dL/du0 = cos(w tf)
    within 5e-3; dL/dv0 = sin(w tf) / w."""
    _, _, _, gy0, gp = _cached("adj_rkn")
    _, ws = _inputs("adj_rkn")
    w, tf = ws[:, 0].double(), 2.0
    assert (gp[:, 0] + tf * torch.sin(w * tf)).abs().max().item() < 5e-3
    assert (gy0[:, 0] - torch.cos(w * tf)).abs().max().item() < 5e-3
    assert (gy0[:, 1] - torch.sin(w * tf) / w).abs().max().item() < 5e-3


def test_rkn_grid_route_matches_fd():
    """The grid RKN adjoint through B6 (the wave, c2 a member): dL/dc2
    within 5e-3 of scale of central differences of B6 with params (eps
    1e-2, compensated, rtol 1e-8 / atol 1e-11), the JAX package's and the
    port's own."""
    _, _, _, _, gp = _cached("adj_rkn_grid")
    fd = torch.tensor(FIXTURE["adj_rkn_grid/fd"])
    assert _scaled(gp[:, 0], fd) < 5e-3
    y0, c2 = _inputs("adj_rkn_grid")
    kw = dict(rtol=1e-8, atol=1e-11, compensated=True)
    yp, ym = (solve_fused_rkn_grid(TDR.WAVE_P, (0.0, 0.5), y0, params=c2 + s,
                                   **kw)[0] for s in (1e-2, -1e-2))
    mine = (yp[:, 0] - ym[:, 0]) / 2e-2
    assert _scaled(mine, fd) < 5e-3


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_overflow_gives_nan_gradients(name):
    """A record too small for the trajectory gives NaN gradients, not
    wrong ones, on every route."""
    _, _, _, gy0, gp = grads(name, dense=3)
    assert not bool(torch.isfinite(gy0).any())
    assert not bool(torch.isfinite(gp).any())


@pytest.mark.parametrize("name,solver", [
    ("adj_esdirk", solve_fused_esdirk), ("adj_rkn", solve_fused_rkn),
    ("adj_esdirk_grid", solve_fused_esdirk_grid),
    ("adj_rkn_grid", solve_fused_rkn_grid)])
def test_route_value_is_the_forward_without_record(name, solver):
    """Without a gradient the route runs its kernel's wrapper without the
    record; with one its y_f is bit for bit the same."""
    fun, method, span, rows, layout, _, rtol, atol = ROUTES[name]
    y0, p = _inputs(name)
    ref = solver(fun, span, y0, method=method, params=p, rtol=rtol,
                 atol=atol)
    plain = solve_fused_adjoint(fun, span, y0, p, method, rtol, atol,
                                layout=layout)
    assert torch.equal(plain, ref[0])
    Y = y0.clone().requires_grad_(True)
    with_grad = solve_fused_adjoint(fun, span, Y, p, method, rtol, atol,
                                    dense=rows, layout=layout)
    assert torch.equal(with_grad.detach(), ref[0])


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


WRAPPER = {"adj_esdirk": solve_fused_esdirk,
           "adj_esdirk_grid": solve_fused_esdirk_grid,
           "adj_rkn": solve_fused_rkn, "adj_rkn_grid": solve_fused_rkn_grid}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_on_card_matches_cpu(cuda, name):
    """Each route on the card, one forward launch, against the same call on
    the CPU within 5e-3 of scale (the card's powf parts h from the second
    attempt)."""
    wrapper = WRAPPER[name]
    before = wrapper.launches
    card = grads(name, cuda)
    assert wrapper.launches == before + 1
    cpu = _cached(name)
    for a, b in zip(card[3:], cpu[3:]):
        assert _scaled(a.cpu(), b) < 5e-3
