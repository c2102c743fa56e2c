"""Per-member ``params`` and the dense record on the port's SWAG kernels
(B3, ``ops.solve_fused_adams``, and B8, ``ops.solve_fused_adams_grid``),
and the SWAG routes of the continuous adjoint
(``ops.solve_fused_adjoint(..., method=SWAG)``), on the CPU.

The plain versions run here; the JAX package's Pallas kernels in interpret
mode (without FMA) and its adjoint are read from
``tests/jax_fused_adams_routes.npz`` (``tests/jax_fused_adams_routes.py``),
on the same inputs:

* ``params_decay`` and ``params_heat`` (``tests/test_fused_params.py:94``
  and ``:176``): the outputs, the step counts growing with the stiffness;
* ``dense_flat`` and ``dense_grid`` (``tests/test_fused_dense.py:298`` and
  ``:244``, ``dense`` without ``t_eval``): the dense output at six times,
  the last node the final state, bit for bit;
* ``adj_vdp`` (``tests/test_fused_adjoint.py:270``): dL/dmu against JAX's
  gradient and, within JAX's 2e-2 of max |FD|, against central
  differences of the fused primal;
* ``adj_heat``: the grid route on the heat MoL, against JAX's gradient and
  against the semi-discrete closed form.

The tests marked ``gpu`` run the kernels on the card against the plain
versions, and B3's lane bodies bit for bit; they skip where there is none.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import SWAG
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRHS,
                                     fused_adams_grid_reference,
                                     fused_adams_reference,
                                     solve_fused_adams,
                                     solve_fused_adams_grid,
                                     solve_fused_adjoint)

HERE = Path(__file__).resolve().parent
FIXTURE = np.load(HERE / "jax_fused_adams_routes.npz")
N_HEAT = 128
N_ADV = 32


def dec_p(t, y, p):
    return torch.stack([-p[0] * y[0], -2.0 * p[0] * y[1]])


def vdp_p(t, y, p):
    return torch.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]])


def heat_p(n):
    """Periodic heat MoL with the diffusivity a member's parameter."""
    c = float(n * n)

    def fun(t, y, p):
        return p[0] * (torch.roll(y, 1, 0) - 2 * y + torch.roll(y, -1, 0)) \
            * c
    return fun


def heat_p_cuda(n):
    return f"""__device__ float rhs(float t, const float* y, int i,
                    const float* p) {{
  using G = tab::G;
  return p[0] * (G::rolled<0>(y, i, 1) - 2.0f * y[i]
                 + G::rolled<0>(y, i, -1)) * {float(n * n)!r}f;
}}"""


def adv(t, y):
    return -(y - torch.roll(y, 1, 0)) * (0.2 * N_ADV)


DEC_P = FusedRHS(dec_p, """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = -p[0] * y[0];
  dy[1] = -2.0f * p[0] * y[1];
}""", 2, 1)
VDP_P = FusedRHS(vdp_p, """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = y[1];
  dy[1] = p[0] * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2, 1)
OSC = FusedRHS(lambda t, y: torch.stack([y[1], -y[0]]),
               "__device__ void rhs(float t, const float* y, float* dy) {\n"
               "  dy[0] = y[1];\n  dy[1] = -y[0];\n}", 2)
HEAT_P = FusedGridRHS(heat_p(N_HEAT), heat_p_cuda(N_HEAT), (N_HEAT,), 1)
ADV = FusedGridRHS(adv, f"""__device__ float rhs(float t, const float* y,
                    int i, const float* p) {{
  using G = tab::G;
  return -(y[i] - G::rolled<0>(y, i, 1)) * {0.2 * N_ADV!r}f;
}}""", (N_ADV,))

# name -> (wrapper, plain version, right-hand side, span, options)
RUNS = {
    "params_decay": (solve_fused_adams, fused_adams_reference, DEC_P,
                     (0.0, 1.0), dict(rtol=1e-4, atol=1e-7, k_max=6)),
    "params_heat": (solve_fused_adams_grid, fused_adams_grid_reference,
                    HEAT_P, (0.0, 0.3), dict(rtol=1e-4, atol=1e-7, k_max=6)),
    "dense_flat": (solve_fused_adams, fused_adams_reference, OSC, (0.0, 4.0),
                   dict(rtol=1e-5, atol=1e-8, k_max=6, dense=256)),
    "dense_grid": (solve_fused_adams_grid, fused_adams_grid_reference, ADV,
                   (0.0, 1.0), dict(rtol=1e-5, atol=1e-8, dense=256)),
}
QUERIES = {"dense_flat": np.linspace(0.0, 4.0, 6),
           "dense_grid": np.linspace(0.0, 1.0, 6)}


def _inputs(name, device="cpu"):
    y0 = torch.tensor(FIXTURE[name + "/y0"], device=device)
    key = name + "/params"
    p = (torch.tensor(FIXTURE[key], device=device) if key in FIXTURE
         else None)
    return y0, p


_CACHE = {}


def run(name, **over):
    """The plain version on the case (cached without overrides)."""
    if not over and name in _CACHE:
        return _CACHE[name]
    _, plain, fun, span, kw = RUNS[name]
    y0, p = _inputs(name)
    out = plain(fun, span, y0, params=p, **dict(kw, **over))
    if not over:
        _CACHE[name] = out
    return out


# the plain versions against the JAX kernels: (max |dy|, max |dnsteps|,
# members with other counts).  Measured: dense_flat and dense_grid 0, 0, 0
# (bit for bit); params_decay 8.9e-8, 0, 0; params_heat 2.7e-4, 2, 4 (the
# step ratio's pow parts last bits of h from the second attempt, and the
# heat MoL's steps sit at its stability limit).  Gates about 5x on |dy|,
# at least 1e-7, 3x on the counts, at least 1 and 2
JAX_GATES = {"params_decay": (5e-7, 1, 2), "params_heat": (1.4e-3, 6, 12),
             "dense_flat": (1e-7, 1, 2), "dense_grid": (1e-7, 1, 2)}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_plain_versions_match_jax(name):
    """The plain versions with params or the record against the JAX
    kernels on the same inputs: status identical, y and the counts within
    the gates."""
    y, st, ns, nf = (r.numpy() for r in run(name)[:4])
    jy, jst, jns, jnf = (FIXTURE[f"{name}/{i}"] for i in range(4))
    np.testing.assert_array_equal(st, jst)
    assert np.all(st == 1)
    y_gate, dsteps, members = JAX_GATES[name]
    assert np.abs(y - jy).max() <= y_gate
    assert np.abs(ns - jns).max() <= dsteps
    assert np.sum((ns != jns) | (nf != jnf)) <= members


def test_params_decay_stiffer_members_take_more_steps():
    """tests/test_fused_params.py:94-108: y0 within 1e-3 of exp(-l), and
    the starting state goes through the per-member function: the stiffest
    member takes more steps than the mildest."""
    y, st, ns, _ = run("params_decay")[:4]
    _, lam = _inputs("params_decay")
    assert bool((st == 1).all())
    assert (y[:, 0] - torch.exp(-lam[:, 0])).abs().max().item() < 1e-3
    assert int(ns[-1]) > int(ns[0])


def test_params_heat_matches_the_closed_form():
    """tests/test_fused_params.py:176-195: members 0 and 15 within 5e-3 of
    exp(-D lam_1 t) sin(2 pi x)."""
    y = run("params_heat")[0].double()
    _, D = _inputs("params_heat")
    x = np.arange(N_HEAT) / N_HEAT
    lam = (2.0 * N_HEAT * np.sin(np.pi / N_HEAT)) ** 2
    for i in (0, 15):
        exact = np.exp(-float(D[i, 0]) * lam * 0.3) * np.sin(2 * np.pi * x)
        assert np.abs(y[i].numpy() - exact).max() < 5e-3


# the records' nodes and the dense outputs at the six query times against
# JAX's, measured: 0 on both (the same steps, bit for bit); gates 1e-7
SOL_GATES = {"dense_flat": 1e-7, "dense_grid": 1e-7}


@pytest.mark.parametrize("name", ["dense_flat", "dense_grid"])
def test_dense_output_matches_jax(name):
    """The record's nodes (times, states, Hermite coefficients) and its
    dense output at JAX's query times against JAX's, every member valid,
    and at tf the final state within 1e-6 (JAX's gate)."""
    out = run(name)
    sol = out[4]
    assert bool(sol.valid.all())
    for f in ("ts", "y_anchor", "Q"):
        jax_rows = FIXTURE[f"{name}/{f}"]
        mine = getattr(sol, f)[:, :jax_rows.shape[1]].numpy()
        assert np.abs(mine - jax_rows).max() <= SOL_GATES[name], f
    tq = torch.tensor(QUERIES[name], dtype=torch.float32)
    d = np.abs(sol(tq).numpy() - FIXTURE[name + "/sol"]).max()
    assert d <= SOL_GATES[name]
    span = RUNS[name][3]
    assert (sol(span[1]) - out[0]).abs().max().item() < 1e-6


@pytest.mark.parametrize("name", ["dense_flat", "dense_grid"])
def test_last_node_is_the_final_state(name):
    """Each member's node nsteps is its final state at tf, bit for bit: the
    near-end extrapolation or the landing step is the record's last row."""
    out = run(name)
    sol, ns = out[4], out[2].long()
    b = torch.arange(len(ns))
    assert torch.equal(sol.y_anchor[b, ns], out[0])
    tf = float(np.float32(RUNS[name][3][1]))
    assert torch.equal(sol.ts[b, ns], torch.full((len(ns),), tf))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_record_leaves_the_outputs_unchanged(name):
    """dense=None's outputs are the record's, bit for bit, with and
    without params."""
    wrapper, _, fun, span, kw = RUNS[name]
    y0, p = _inputs(name)
    kw = dict(kw, dense=None)
    off = wrapper(fun, span, y0, params=p, **kw)
    on = wrapper(fun, span, y0, params=p, **dict(kw, dense=128))
    assert len(off) == 4 and len(on) == 5
    for a, b in zip(off, on[:4]):
        assert torch.equal(a, b)


def test_overflowing_record_is_not_valid():
    """A record too small for a member's attempts leaves it invalid; its
    recorded prefix still matches the full record's nodes."""
    small = run("dense_flat", dense=5)[4]
    full = run("dense_flat")[4]
    assert not bool(small.valid.any())
    assert torch.equal(small.y_anchor[:, 1:5], full.y_anchor[:, 1:5])


# -- the adjoint routes ------------------------------------------------------

W_HEAT = torch.sin(2 * np.pi * torch.arange(N_HEAT) / N_HEAT)


def _first(yf):
    return yf[:, 0].sum()


def _heat_loss(yf):
    return (yf * W_HEAT.to(yf.device)).sum()


# name -> (right-hand side, span, layout, loss, rtol, atol)
ROUTES = {"adj_vdp": (VDP_P, (0.0, 3.0), "flat", _first, 1e-5, 1e-8),
          "adj_heat": (HEAT_P, (0.0, 0.3), "grid", _heat_loss, 1e-4, 1e-7)}


def grads(name, device="cpu", dense=512):
    """(value, dL/dy0, dL/dp) of the route's loss through
    solve_fused_adjoint with method=SWAG."""
    fun, span, layout, loss_of, rtol, atol = ROUTES[name]
    y0, p = (torch.tensor(FIXTURE[f"{name}/in_{k}"], device=device)
             for k in ("y0", "params"))
    Y = y0.clone().requires_grad_(True)
    P = p.clone().requires_grad_(True)
    yf = solve_fused_adjoint(fun, span, Y, P, SWAG, rtol, atol, 100_000,
                             None, dense, layout=layout, k_max=6)
    loss = loss_of(yf)
    loss.backward()
    return loss.detach(), Y.grad, P.grad


def _cached(name):
    if name not in _CACHE:
        _CACHE[name] = grads(name)
    return _CACHE[name]


def _scaled(a, b):
    b = torch.as_tensor(b, dtype=a.dtype)
    return ((a - b).abs().max() / b.abs().max()).item()


# the gradients against the JAX package's, over their largest entries,
# measured (y0, params): adj_vdp 0, 0 (the forward bit for bit, the
# backward to the last bit); adj_heat 5.7e-4, 6.5e-7 (JAX's backward
# solves each member alone at rtol 1e-4, the port's the ensemble at once:
# its dL/dy0 lies 1.3e-5 from the closed form, JAX's 5.7e-4).  Gates about
# 5x, at least 1e-7
ROUTE_GATES = {"adj_vdp": (1e-7, 1e-7), "adj_heat": (2.8e-3, 3.3e-6)}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_swag_route_matches_jax(name):
    """Each SWAG route's value, dL/dy0 and dL/dp against JAX's adjoint on
    the same inputs; every gradient finite."""
    val, gy0, gp = _cached(name)
    assert bool(torch.isfinite(gy0).all() and torch.isfinite(gp).all())
    assert val.item() == pytest.approx(float(FIXTURE[f"{name}/value"]),
                                       rel=1e-6, abs=1e-7)
    y_gate, p_gate = ROUTE_GATES[name]
    assert _scaled(gy0, FIXTURE[f"{name}/y0"]) <= y_gate
    assert _scaled(gp, FIXTURE[f"{name}/params"]) <= p_gate


def test_flat_route_matches_central_differences():
    """tests/test_fused_adjoint.py:270-301 through B3: dL/dmu within 2e-2 of
    max(max |FD|, 1) of the JAX package's central differences (eps 1e-2)
    and of the port's own, from two solves with every member's mu moved
    (measured 6.8e-4)."""
    _, _, gp = _cached("adj_vdp")
    fd = torch.tensor(FIXTURE["adj_vdp/fd"])
    scale = max(fd.abs().max().item(), 1.0)
    assert (gp[:, 0] - fd).abs().max().item() < 2e-2 * scale
    y0, mus = (torch.tensor(FIXTURE[f"adj_vdp/in_{k}"])
               for k in ("y0", "params"))
    kw = dict(rtol=1e-5, atol=1e-8, k_max=6)
    yp, ym = (solve_fused_adams(VDP_P, (0.0, 3.0), y0, params=mus + s,
                                **kw)[0] for s in (1e-2, -1e-2))
    mine = (yp[:, 0] - ym[:, 0]) / 2e-2
    assert (gp[:, 0] - mine).abs().max().item() < 2e-2 * scale


def test_grid_route_matches_the_closed_form():
    """The heat MoL is linear, so the semi-discrete solution gives the
    gradient: with lam_1 = (2 n sin(pi / n))^2 and y0 = sin(2 pi x),
    dL/dD_b = -lam_1 T (n / 2) exp(-D_b lam_1 T) and dL/dy0[b, i] =
    exp(-D_b lam_1 T) sin(2 pi x_i), each over its largest entry within
    about 5x its reading (measured 7.3e-8 and 1.3e-5)."""
    _, gy0, gp = _cached("adj_heat")
    D = torch.tensor(FIXTURE["adj_heat/in_params"]).double()[:, 0]
    T = 0.3
    lam = (2.0 * N_HEAT * np.sin(np.pi / N_HEAT)) ** 2
    decay = torch.exp(-D * lam * T)
    dD = -lam * T * (N_HEAT / 2) * decay
    dy0 = decay[:, None] * W_HEAT.double()[None, :]
    assert _scaled(gp[:, 0].double(), dD) < 4e-7
    assert _scaled(gy0.double(), dy0) < 7e-5


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_swag_route_overflow_gives_nan_gradients(name):
    """A record too small for the trajectory gives NaN gradients, not
    wrong ones, on both layouts."""
    _, gy0, gp = grads(name, dense=3)
    assert not bool(torch.isfinite(gy0).any())
    assert not bool(torch.isfinite(gp).any())


@pytest.mark.parametrize("name,solver", [("adj_vdp", solve_fused_adams),
                                         ("adj_heat",
                                          solve_fused_adams_grid)])
def test_swag_route_value_is_the_forward_without_record(name, solver):
    """Without a gradient the route runs its kernel's wrapper at k_max
    without the record; with one its y_f is bit for bit the same; the ends
    of a static t_span may be tensors that need no gradient."""
    fun, span, layout, _, rtol, atol = ROUTES[name]
    y0, p = (torch.tensor(FIXTURE[f"{name}/in_{k}"])
             for k in ("y0", "params"))
    ref = solver(fun, span, y0, params=p, rtol=rtol, atol=atol, k_max=6,
                 max_steps=100_000)
    plain = solve_fused_adjoint(fun, span, y0, p, SWAG, rtol, atol,
                                layout=layout, k_max=6)
    assert torch.equal(plain, ref[0])
    Y = y0.clone().requires_grad_(True)
    tens = tuple(torch.tensor(x) for x in span)
    with_grad = solve_fused_adjoint(fun, tens, Y, p, SWAG, rtol, atol,
                                    dense=512, layout=layout, k_max=6)
    assert torch.equal(with_grad.detach(), ref[0])


@pytest.mark.parametrize("layout", ["flat", "grid"])
def test_swag_route_needs_a_static_t_span(layout):
    """As in JAX, the SWAG route refuses a t_span end that requires a
    gradient."""
    fun = VDP_P if layout == "flat" else HEAT_P
    name = "adj_vdp" if layout == "flat" else "adj_heat"
    y0, p = (torch.tensor(FIXTURE[f"{name}/in_{k}"])
             for k in ("y0", "params"))
    tf = torch.tensor(0.3, requires_grad=True)
    with pytest.raises(ValueError, match="static t_span"):
        solve_fused_adjoint(fun, (0.0, tf), y0, p, SWAG, layout=layout)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(RUNS))
def test_kernel_on_card_matches_plain_version(cuda, name):
    """Each kernel with params or the record on the card, one launch,
    against its plain version on the card (the card's powf and FMA part h
    from the second attempt): status equal, y within 1e-4, the record
    valid where the plain version's is, its last node the final state."""
    wrapper, plain, fun, span, kw = RUNS[name]
    y0, p = _inputs(name, cuda)
    before = wrapper.launches
    k = wrapper(fun, span, y0, params=p, **kw)
    assert wrapper.launches == before + 1
    r = plain(fun, span, y0, params=p, **kw)
    assert torch.equal(k[1], r[1])
    assert (k[0] - r[0]).abs().max().item() <= 1e-4
    if "dense" in kw:
        assert torch.equal(k[4].valid, r[4].valid)
        b = torch.arange(len(k[2]), device=cuda)
        assert torch.equal(k[4].y_anchor[b, k[2].long()], k[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["params_decay", "dense_flat"])
def test_lane_bodies_on_card_bit_identical(cuda, name):
    """B3's group bodies at 8, 16 and 32 lanes per member: outputs and
    records bit for bit the same.  The one-lane body is code of its own,
    which nvcc contracts otherwise where the right-hand side's products
    meet the predictor's differences: on the oscillator it gives the same
    bits, on the decay with a parameter it parts from the 13th attempt by
    7.5e-9 (measured on an H100), so it is held to equal status and steps
    and 1e-7 there."""
    from extensisq_tpu_torch.ops import fused_adams as FA
    _, _, fun, span, kw = RUNS[name]
    y0, p = _inputs(name, cuda)
    kw = dict(kw)
    rows = kw.pop("dense", None)
    runs = {lanes: FA._launch(fun, span, y0, kw["rtol"], kw["atol"], None,
                              kw["k_max"], 200_000, False, None, lanes, None,
                              p, rows)[0] for lanes in (1, 8, 16, 32)}
    for lanes in (8, 16):
        for a, b in zip(runs[32][:4], runs[lanes][:4]):
            assert torch.equal(a, b)
        if rows:
            for f in runs[32][4]._fields:
                assert torch.equal(getattr(runs[32][4], f),
                                   getattr(runs[lanes][4], f))
    one, ref = runs[1], runs[32]
    for a, b in zip(one[1:4], ref[1:4]):
        assert torch.equal(a, b)
    gate = 1e-7 if name == "params_decay" else 0.0
    assert (one[0] - ref[0]).abs().max().item() <= gate


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_swag_route_on_card_matches_cpu(cuda, name):
    """Each SWAG route on the card, one forward launch, against the same
    call on the CPU within 5e-3 of scale."""
    wrapper = solve_fused_adams if name == "adj_vdp" else \
        solve_fused_adams_grid
    before = wrapper.launches
    card = grads(name, cuda)
    assert wrapper.launches == before + 1
    cpu = _cached(name)
    for a, b in zip(card[1:], cpu[1:]):
        assert _scaled(a.cpu(), b) < 5e-3
