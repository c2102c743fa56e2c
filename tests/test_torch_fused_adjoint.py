"""The port's continuous adjoint through a fused forward solve
(``ops.solve_fused_adjoint``, its ERK routes) on the CPU.

The forward pass runs here on the plain versions of B1 and B4 with
``dense``, the backward pass on the f64 ``solve_ensemble``.  Held against
what the JAX package's ``tests/test_fused_adjoint.py`` holds its two ERK
cases to: the Van der Pol sweep's gradients against ``solve_fused_final``
(forward sensitivities) within 2e-3, with the same primal value; the grid
layout's Fisher sweep (n = 128, ``dense=400``, config 7d's case) against
the f64 ``solve_final`` gradient of member 0 within 2e-3 and central
differences of B4 with params within 5e-3.  Both also against the JAX
package's gradients on the same inputs, read from
``tests/jax_fused_adjoint.npz`` (``tests/jax_fused_adjoint.py``).  The
tests marked ``gpu`` run B1 and B4 with their records and the adjoint on
the card against the plain versions; they skip where there is none.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import BS5, CKdisc, SSV2stab, SWAG, sensitivity
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRHS,
                                     fused_erk_grid_reference,
                                     fused_erk_reference, solve_fused_adjoint,
                                     solve_fused_erk, solve_fused_erk_grid,
                                     solve_fused_final)

FIXTURE = np.load(Path(__file__).resolve().parent / "jax_fused_adjoint.npz")
SPAN = (0.0, 3.0)
VDP_P = FusedRHS(
    lambda t, y, p: torch.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]]),
    """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = y[1];
  dy[1] = p[0] * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2, 1)
N = 128
D = 0.02 * N * N
FIS_SPAN = (0.0, 0.25)


def fisher(t, y, p):
    return ((torch.roll(y, 1, 0) - 2.0 * y + torch.roll(y, -1, 0)) * D
            + p[0] * y * (1.0 - y))


FISHER = FusedGridRHS(fisher, f"""template <class T, class V>
__device__ T rhs(T t, V y, int i, const T* p) {{
  return (tab::G::rolled<0>(y, i, 1) - 2.0f * y[i]
          + tab::G::rolled<0>(y, i, -1)) * {float(np.float32(D))!r}f
         + p[0] * y[i] * (1.0f - y[i]);
}}""", (N,), 1)


def _vdp_inputs(device="cpu"):
    return (torch.tensor(FIXTURE[f"adj_vdp/in_{k}"], device=device)
            for k in ("y0", "params"))


def _grads(solver, fun, span, y0, p, *args, **kw):
    """(value, dL/dt0, dL/dtf, dL/dy0, dL/dp) of sum(y_f[:, 0])."""
    t0, tf = (torch.tensor(float(x), requires_grad=True, device=y0.device)
              for x in span)
    Y = y0.clone().requires_grad_(True)
    P = p.clone().requires_grad_(True)
    loss = solver(fun, (t0, tf), Y, P, *args, **kw)[:, 0].sum()
    loss.backward()
    return loss.detach(), t0.grad, tf.grad, Y.grad, P.grad


def _scaled(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


# the ERK adjoint on the Van der Pol sweep against the JAX package's, on
# the same inputs: dL/dy0 and dL/dmu over their largest entries, dt0 and
# dtf relative.  Measured 2.6e-5, 2.5e-5, 4.7e-6 and 0 (the forward solves
# part in the last bits of h, and the backward solves' step sequences with
# them; each package's adjoint is 1.3e-3 from its forward sensitivities).
# Gates about 5x
VDP_JAX_GATES = {"y0": 1.3e-4, "params": 1.3e-4, "t0": 2.5e-5, "tf": 5e-7}


def test_adjoint_vdp_matches_final_and_jax():
    """dL/dy0 and dL/dmu through the continuous adjoint against
    solve_fused_final's forward sensitivities within JAX's 2e-3 of their
    largest entries, the same primal value, dL/dtf within 2e-3 and dt0 +
    dtf ~ 0 on the autonomous system; and against the JAX package's
    adjoint gradients."""
    y0, mus = _vdp_inputs()
    args = (None, 1e-5, 1e-8, 100_000, None)
    va, at0, atf, ay0, ap = _grads(solve_fused_adjoint, VDP_P, SPAN, y0, mus,
                                   *args, dense=512)
    vf, ft0, ftf, fy0, fp = _grads(solve_fused_final, VDP_P, SPAN, y0, mus,
                                   *args)
    assert va.item() == vf.item()
    assert _scaled(ay0, fy0) < 2e-3 and _scaled(ap, fp) < 2e-3
    assert abs(at0.item() + atf.item()) < 0.05 * abs(atf.item())
    assert abs(atf.item() - ftf.item()) < 2e-3 * abs(ftf.item())
    jax = {k: torch.tensor(FIXTURE[f"adj_vdp/adjoint/{k}"], dtype=ay0.dtype)
           for k in ("y0", "params", "t0", "tf")}
    assert va.item() == pytest.approx(float(FIXTURE["adj_vdp/adjoint/value"]),
                                      rel=1e-6)
    assert _scaled(ay0, jax["y0"]) <= VDP_JAX_GATES["y0"]
    assert _scaled(ap, jax["params"]) <= VDP_JAX_GATES["params"]
    for name, g in (("t0", at0), ("tf", atf)):
        assert _scaled(g, jax[name]) <= VDP_JAX_GATES[name]


def _fisher_inputs(device="cpu"):
    return (torch.tensor(FIXTURE[f"adj_fisher/in_{k}"], device=device)
            for k in ("y0", "params"))


def _fisher_grads(device="cpu", dense=400):
    y0, rates = _fisher_inputs(device)
    Y = y0.clone().requires_grad_(True)
    P = rates.clone().requires_grad_(True)
    yf = solve_fused_adjoint(FISHER, FIS_SPAN, Y, P, None, 1e-5, 1e-8,
                             100_000, 8, dense, layout="grid")
    gy0, gp = torch.autograd.grad(yf.mean(1).sum(), (Y, P))
    return gy0, gp


# the grid adjoint against the JAX package's: dL/dy0 and dL/dr over their
# largest entries, measured 1.2e-4 and 7.0e-8 (member 0's dL/dy0 is
# 1.0e-5 from the f64 reference in both packages, dL/dr 6.4e-4 from the
# port's central differences); gates about 5x
FIS_JAX_GATES = (6e-4, 4e-7)


def test_adjoint_grid_fisher_matches_f64_fd_and_jax():
    """Config 7d's case: the grid layout's adjoint through B4 with params on
    the diffusive Fisher sweep; every gradient finite; member 0's dL/dy0
    within JAX's 2e-3 of the f64 solve_final gradient, dL/dr within 5e-3
    of central differences of B4 with params (eps 2e-3, rtol 1e-7 / atol
    1e-10); and both within the gates of the JAX package's gradients."""
    gy0, gp = _fisher_grads()
    assert bool(torch.isfinite(gy0).all()) and bool(torch.isfinite(gp).all())
    gref = torch.tensor(FIXTURE["adj_fisher/gref0"])
    assert _scaled(gy0[0].double(), gref) < 2e-3
    y0, rates = _fisher_inputs()
    eps = 2e-3
    kw = dict(method=BS5, rtol=1e-7, atol=1e-10)
    yp = fused_erk_grid_reference(FISHER, FIS_SPAN, y0, params=rates + eps,
                                  **kw)[0]
    ym = fused_erk_grid_reference(FISHER, FIS_SPAN, y0, params=rates - eps,
                                  **kw)[0]
    fd = (yp.mean(1) - ym.mean(1)) / (2 * eps)
    assert _scaled(gp[:, 0], fd) < 5e-3
    assert _scaled(gy0, torch.tensor(FIXTURE["adj_fisher/y0"])) \
        <= FIS_JAX_GATES[0]
    assert _scaled(gp, torch.tensor(FIXTURE["adj_fisher/params"])) \
        <= FIS_JAX_GATES[1]


def test_adjoint_f64_reference_in_the_port():
    """The fixture's f64 reference of member 0 against the port's own
    ``sensitivity.solve_final`` gradient on the same member (rtol 1e-6 /
    atol 1e-9 here, for time)."""
    y0, rates = _fisher_inputs()
    v = y0[0].double().requires_grad_(True)
    out = sensitivity.solve_final(
        lambda t, y, p: fisher(t, y, (p,)), FIS_SPAN, v,
        torch.tensor(float(rates[0, 0]), dtype=torch.float64), None, 1e-6,
        1e-9, 100_000)
    g, = torch.autograd.grad(out.mean(), v)
    assert _scaled(g, torch.tensor(FIXTURE["adj_fisher/gref0"])) < 1e-4


@pytest.mark.parametrize("layout", ["flat", "grid"])
def test_adjoint_overflow_gives_nan_gradients(layout):
    """A record too small for the trajectory gives NaN gradients, not
    wrong ones (tests/test_fused_adjoint.py:69-81)."""
    if layout == "flat":
        y0, mus = _vdp_inputs()
        Y = y0.clone().requires_grad_(True)
        yf = solve_fused_adjoint(VDP_P, SPAN, Y, mus, None, 1e-5, 1e-8,
                                 100_000, None, 8)
        g, = torch.autograd.grad(yf[:, 0].sum(), Y)
    else:
        g, _ = _fisher_grads(dense=8)
    assert not bool(torch.isfinite(g).any())


def test_adjoint_without_gradient_records_nothing(monkeypatch):
    """Where no input requires a gradient the forward runs without the
    record and gives solve_fused_erk's y_f."""
    from extensisq_tpu_torch.ops import fused_sens
    seen = []
    real = fused_sens.solve_fused_erk

    def spy(*a, **kw):
        seen.append(kw.get("dense"))
        return real(*a, **kw)

    monkeypatch.setattr(fused_sens, "solve_fused_erk", spy)
    y0, mus = _vdp_inputs()
    yf = solve_fused_adjoint(VDP_P, SPAN, y0, mus, rtol=1e-5, atol=1e-8)
    assert seen == [None]
    ref = solve_fused_erk(VDP_P, SPAN, y0, params=mus, rtol=1e-5, atol=1e-8)
    assert torch.equal(yf, ref[0])


def test_adjoint_backward_span():
    """A span from 1 back to 0 (Van der Pol's cycle repels backward in
    time, so the span is short): the adjoint's gradients against
    solve_fused_final's within 2e-3 (measured 5.4e-4), the same value."""
    y0, mus = _vdp_inputs()
    span = (1.0, 0.0)
    args = (None, 1e-5, 1e-8, 100_000, None)
    va, _, atf, ay0, ap = _grads(solve_fused_adjoint, VDP_P, span, y0, mus,
                                 *args, dense=512)
    vf, _, ftf, fy0, fp = _grads(solve_fused_final, VDP_P, span, y0, mus,
                                 *args)
    assert va.item() == vf.item()
    assert _scaled(ay0, fy0) < 2e-3 and _scaled(ap, fp) < 2e-3
    assert abs(atf.item() - ftf.item()) < 2e-3 * abs(ftf.item())


@pytest.mark.parametrize("method,exc,match", [
    (SWAG, ValueError, "static t_span"),
    (SSV2stab, ValueError, "family"),
    (CKdisc, ValueError, "family")])
def test_adjoint_routes_not_ported_raise(method, exc, match):
    """The SWAG route takes a static t_span, as in JAX: an end that requires
    a gradient raises ValueError; other families raise JAX's ValueError.
    The ESDIRK, RKN and SWAG routes run
    (tests/test_torch_fused_adjoint_routes.py,
    tests/test_torch_fused_adams_routes.py)."""
    y0, mus = _vdp_inputs()
    t0 = torch.tensor(float(SPAN[0]), requires_grad=True)
    with pytest.raises(exc, match=match):
        solve_fused_adjoint(VDP_P, (t0, SPAN[1]), y0, mus, method)


@pytest.mark.parametrize("kw,match", [(dict(layout="rows"), "layout"),
                                      (dict(dense=0), "dense"),
                                      (dict(dense=None), "dense")])
def test_adjoint_argument_checks(kw, match):
    y0, mus = _vdp_inputs()
    with pytest.raises(ValueError, match=match):
        solve_fused_adjoint(VDP_P, SPAN, y0, mus, **kw)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _same_solution(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


@pytest.mark.gpu
def test_dense_kernels_match_plain_versions_on_card(cuda):
    """B1 and B4 with their records on the card: the record leaves y,
    status, nsteps and nfev bit for bit; B1's lane shapes and B4's warp
    give the thread body's and the block of 32's outputs and records bit
    for bit; status, nsteps and valid against the plain versions, the
    dense outputs within chip_smoke.py's gates."""
    from extensisq_tpu_torch.ops import fused_erk as FK
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    y0 = torch.zeros(256, 2, device=cuda)
    y0[:, 0] = 2.0
    mus = torch.linspace(1.0, 2.0, 256, device=cuda)[:, None]
    for tol in (dict(rtol=1e-5, atol=1e-8),
                dict(rtol=1e-6, atol=1e-9, compensated=True)):
        before = solve_fused_erk.launches
        on = solve_fused_erk(VDP_P, SPAN, y0, params=mus, dense=512, **tol)
        assert solve_fused_erk.launches == before + 1
        off = solve_fused_erk(VDP_P, SPAN, y0, params=mus, **tol)
        assert all(torch.equal(a, b) for a, b in zip(on[:4], off))
        for lanes in (1, 4, 8):
            o = FK._launch(VDP_P, SPAN, y0, None, tol["rtol"], tol["atol"],
                           None, 100_000, tol.get("compensated", False),
                           None, lanes, None, mus, 512)[0]
            assert all(torch.equal(a, b) for a, b in zip(on[:4], o[:4]))
            assert _same_solution(on[4], o[4])
        r = fused_erk_reference(VDP_P, SPAN, y0, params=mus, dense=512, **tol)
        assert torch.equal(on[1], r[1])
        assert torch.equal(on[4].valid, r[4].valid)
        tq = torch.linspace(*SPAN, 97, device=cuda)
        assert (on[4](tq) - r[4](tq)).abs().max().item() <= 3e-2
    y0, rates = _fisher_inputs(cuda)
    kw = dict(rtol=1e-5, atol=1e-8, params=rates)
    on = solve_fused_erk_grid(FISHER, FIS_SPAN, y0, dense=400, **kw)
    off = solve_fused_erk_grid(FISHER, FIS_SPAN, y0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(on[:4], off))
    built = FKG._kernel(None, FISHER, True)
    warp, b32 = (FKG._launch(built, FIS_SPAN, y0, N, shape=s, dense=400,
                             **kw)[0] for s in ((32, 4), (32, 0)))
    assert all(torch.equal(a, b) for a, b in zip(warp[:4], b32[:4]))
    assert _same_solution(warp[4], b32[4])
    r = fused_erk_grid_reference(FISHER, FIS_SPAN, y0, dense=400, **kw)
    assert torch.equal(on[1], r[1]) and torch.equal(on[4].valid, r[4].valid)
    tq = torch.linspace(*FIS_SPAN, 97, device=cuda)
    assert (on[4](tq) - r[4](tq)).abs().max().item() <= 2e-3


@pytest.mark.gpu
def test_adjoint_on_card_matches_cpu(cuda):
    """The two ERK adjoints on the card, one launch each, against the same
    calls on the CPU within the gates of the forward's parting (the card's
    powf and the CPU's part h) and of 2e-3 against solve_fused_final."""
    y0, mus = _vdp_inputs(cuda)
    args = (None, 1e-5, 1e-8, 100_000, None)
    before = solve_fused_erk.launches
    va, _, _, ay0, ap = _grads(solve_fused_adjoint, VDP_P, SPAN, y0, mus,
                               *args, dense=512)
    assert solve_fused_erk.launches == before + 1
    vf, _, _, fy0, fp = _grads(solve_fused_final, VDP_P, SPAN, y0, mus,
                               *args)
    assert va.item() == vf.item()
    assert _scaled(ay0, fy0) < 2e-3 and _scaled(ap, fp) < 2e-3
    before = solve_fused_erk_grid.launches
    gy0, gp = _fisher_grads(cuda)
    assert solve_fused_erk_grid.launches == before + 1
    cy0, cp = _fisher_grads()
    assert _scaled(gy0.cpu(), cy0) < 2e-3 and _scaled(gp.cpu(), cp) < 2e-3
