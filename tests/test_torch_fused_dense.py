"""The port's continuous dense output from the fused kernels
(``ops/fused_dense.py``, ``dense=R`` on B1 and B4) on the CPU.

``build_fused_dense`` and ``FusedDenseSolution`` run against the JAX
package's on the same numpy records (in this process: they are plain
array code).  The plain versions of B1 and B4 with ``dense`` run against
the JAX kernels' records in ``tests/jax_fused_adjoint.npz``
(``tests/jax_fused_adjoint.py``: Van der Pol with a mu a member, plain and
compensated, and the Fisher MoL with a rate a member, ``first_step``
given so that the counts are equal), and the JAX package's
``tests/test_fused_dense.py`` ERK cases run here at their gates against
the port's f64 ``solve_ivp``.  The kernels on the card are held against
these plain versions in ``tests/test_torch_fused_adjoint.py`` and in
``chip_smoke.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import BS5, solve_ivp
from extensisq_tpu_torch.ops import (FusedDenseSolution, build_fused_dense,
                                     fused_erk_grid_reference,
                                     fused_erk_reference, solve_fused_erk)
from extensisq_tpu_torch.ops.fused_dense import evaluate_members

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_erk as TK  # noqa: E402
import test_torch_fused_erk_grid as TG  # noqa: E402

FIXTURE = np.load(Path(__file__).resolve().parent / "jax_fused_adjoint.npz")
FIELDS = ("ts", "t_anchor", "h", "y_anchor", "Q")


def _records(seed, R, B, n, span):
    """Random flagged rows of ``B`` members over ``span``: member 0 accepts
    every row, member 1 none, the rest at random; member 2's nsteps is one
    more than it recorded (an overflow)."""
    rng = np.random.default_rng(seed)
    t0, tf = span
    flag = (rng.uniform(size=(R, B)) < 0.6).astype(np.int32)
    flag[:, 0], flag[:, 1] = 1, 0
    rec_t = np.zeros((R, B), np.float32)
    for b in range(B):
        k = int(flag[:, b].sum())
        nodes = np.sort(rng.uniform(0.05, 1.0, k)) if k else []
        rec_t[flag[:, b] != 0, b] = t0 + (tf - t0) * np.asarray(nodes)
    rec_t[flag == 0] = rng.uniform(-5, 5, int((flag == 0).sum()))
    y0 = rng.normal(size=(B, n)).astype(np.float32)
    f0 = rng.normal(size=(B, n)).astype(np.float32)
    rec_y = rng.normal(size=(R, B, n)).astype(np.float32)
    rec_f = rng.normal(size=(R, B, n)).astype(np.float32)
    nsteps = flag.sum(0).astype(np.int32)
    nsteps[2] += 1
    return t0, tf, y0, f0, rec_t, flag, rec_y, rec_f, nsteps


SPANS = {"forward": (0.0, 2.0), "backward": (3.0, 1.0)}


def _both(span):
    from extensisq_tpu.ops.fused_dense import build_fused_dense as jax_build
    args = _records(7, 12, 5, 3, span)
    return jax_build(*args), build_fused_dense(*(
        torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args))


@pytest.mark.parametrize("span", list(SPANS))
def test_build_fused_dense_matches_jax(span):
    """The compaction (member by member), the inert tail, the Hermite
    coefficients and ``valid`` against JAX's ``build_fused_dense`` on the
    same rows: the nodes bit for bit, Q within float32 rounding (XLA may
    contract its products), an overflowing member not valid."""
    js, ts = _both(SPANS[span])
    for f in ("ts", "t_anchor", "h", "y_anchor", "valid"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_allclose(ts.Q.numpy(), np.asarray(js.Q), rtol=1e-6,
                               atol=1e-6)
    assert ts.valid.tolist() == [True, True, False, True, True]
    # member 1 recorded nothing: its whole record is the inert tail (the
    # first node repeated, Q = 0, h = 1)
    assert bool((ts.ts[1] == ts.ts[1, 0]).all())
    assert bool((ts.Q[1] == 0).all()) and bool((ts.h[1] == 1).all())


@pytest.mark.parametrize("span", list(SPANS))
def test_dense_solution_evaluates_as_jax(span):
    """``sol(t)`` at a scalar and at a vector of times (inside, before t0
    and past tf), ``member(b)`` and the per-member times of the adjoint's
    helper against JAX's ``FusedDenseSolution`` and ``OdeSolution`` on
    the same rows."""
    js, ts = _both(SPANS[span])
    t0, tf = SPANS[span]
    tq = np.float32(np.linspace(t0 - 0.5 * (tf - t0), tf + 0.5 * (tf - t0),
                                17))
    for t in (np.float32(0.5 * (t0 + tf)), tq):
        np.testing.assert_allclose(ts(torch.tensor(t)).numpy(),
                                   np.asarray(js(t)), rtol=1e-5, atol=1e-5)
    assert ts(torch.tensor(tq)).shape == (5, 3, 17)
    for b in range(5):
        np.testing.assert_allclose(ts.member(b)(torch.tensor(tq)).numpy(),
                                   np.asarray(js.member(b)(tq)), rtol=1e-5,
                                   atol=1e-5)
    t_b = tq[3:8]
    mine = evaluate_members(ts, torch.tensor(t_b),
                            1.0 if tf >= t0 else -1.0).numpy()
    for b in range(5):
        np.testing.assert_allclose(mine[b], np.asarray(js.member(b)(t_b[b])),
                                   rtol=1e-5, atol=1e-5)


def test_dense_solution_is_the_jax_named_tuple():
    assert FusedDenseSolution._fields == ("ts", "t_anchor", "h", "y_anchor",
                                          "Q", "valid")


def _port_case(name):
    """The plain version of the fixture's case ``name`` with its dense
    output and without it."""
    y0, p = (torch.tensor(FIXTURE[f"{name}/{k}"]) for k in ("y0", "params"))
    if name == "grid_fisher":
        kw = dict(rtol=1e-5, atol=1e-8, first_step=0.005, params=p)
        run = (lambda **d: fused_erk_grid_reference(
            TG.FISHER_P, (0.0, 0.25), y0, method=BS5, **kw, **d))
        return run(dense=400), run()
    kw = dict(rtol=1e-5, atol=1e-8, first_step=0.01, params=p)
    if name == "erk_comp":
        kw.update(rtol=1e-6, atol=1e-9, compensated=True)
    dense = 10 if name == "erk_overflow" else 512
    run = (lambda **d: fused_erk_reference(
        TK.PROBLEMS["vdp_p"], (0.0, 3.0), y0, method=BS5, **kw, **d))
    return run(dense=dense), run()


# (case, max |dy|, gate on the dense output at 61 common times), against
# the JAX kernels in interpret mode.  With first_step given the counts are
# equal; from the second attempt XLA's and torch's powf part the last bits
# of h, so the nodes part (by 1.2e-3 in t on erk_plain, 1.7e-3 on erk_comp,
# 5.4e-3 on grid_fisher) and the dense outputs differ by their
# interpolation error between them.  Measured: erk_plain 2.7e-6 and
# 2.6e-5; erk_comp 8.3e-7 and 1.7e-5; grid_fisher 2.6e-5 and 2.5e-4.
# Gates about 3x
RECORD_GATES = [("erk_plain", 1e-5, 8e-5), ("erk_comp", 3e-6, 5e-5),
                ("erk_overflow", 1e-5, None), ("grid_fisher", 8e-5, 8e-4)]


@pytest.mark.parametrize("name,y_gate,sol_gate", RECORD_GATES)
def test_plain_records_match_jax(name, y_gate, sol_gate):
    """B1's and B4's plain versions with ``dense`` against the JAX kernels'
    records: status, nsteps, nfev and valid equal, the endpoints and the
    dense outputs (the port's against the JAX record's own segments)
    within the gates."""
    (y, st, ns, nf, sol), _ = _port_case(name)
    np.testing.assert_array_equal(st.numpy(), FIXTURE[f"{name}/1"])
    np.testing.assert_array_equal(ns.numpy(), FIXTURE[f"{name}/2"])
    np.testing.assert_array_equal(nf.numpy(), FIXTURE[f"{name}/3"])
    np.testing.assert_array_equal(sol.valid.numpy(),
                                  FIXTURE[f"{name}/valid"])
    assert np.max(np.abs(y.numpy() - FIXTURE[f"{name}/0"])) <= y_gate
    if sol_gate is None:
        assert not bool(sol.valid.any())
        return
    assert bool(sol.valid.all())
    from extensisq_tpu_torch import OdeSolution
    span = (0.0, 0.25) if name == "grid_fisher" else (0.0, 3.0)
    tq = torch.linspace(*span, 61)
    for b in range(y.shape[0]):
        k = int(ns[b])
        jsol = OdeSolution(*(torch.tensor(FIXTURE[f"{name}/{f}"][b])
                             for f in FIELDS))
        jsol = jsol._replace(ts=jsol.ts[:k + 1], t_anchor=jsol.t_anchor[:k],
                             h=jsol.h[:k], y_anchor=jsol.y_anchor[:k],
                             Q=jsol.Q[:k])
        d = (sol.member(b)(tq) - jsol(tq)).abs().max().item()
        assert d <= sol_gate, (b, d)


@pytest.mark.parametrize("name", ["erk_plain", "erk_comp", "erk_overflow",
                                  "grid_fisher"])
def test_plain_dense_leaves_the_outputs_as_they_are(name):
    """``dense`` leaves y, status, nsteps and nfev of the plain versions bit
    for bit as they are without it."""
    on, off = _port_case(name)
    assert len(off) == 4
    for a, b in zip(on[:4], off):
        assert torch.equal(a, b)


def test_dense_none_and_zero_return_four_outputs():
    y0 = torch.tensor(TK.VDPP0[:4])
    p = torch.tensor(TK.MUS[:4])
    for dense in (None, 0):
        out = solve_fused_erk(TK.PROBLEMS["vdp_p"], (0.0, 1.0), y0,
                              params=p, dense=dense)
        assert len(out) == 4
    with pytest.raises(ValueError, match="dense"):
        solve_fused_erk(TK.PROBLEMS["vdp_p"], (0.0, 1.0), y0, params=p,
                        dense=-1)


# -- the JAX package's tests/test_fused_dense.py ERK cases --------------------

B_DENSE = 128


def _vdp2(t, y):
    return torch.stack([y[1], 2.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def test_fused_erk_dense_vdp():
    """VdP (mu = 2) dense output against a tight f64 solve: node values at
    the solve's accuracy, between the nodes at the cubic Hermite's, the
    endpoint exact and evaluation past tf the final state, member(0) the
    batched evaluation (tests/test_fused_dense.py:35-79)."""
    Y0 = torch.tensor(np.tile([2.0, 0.0], (B_DENSE, 1)).astype(np.float32))
    yf, st, ns, nf, sol = solve_fused_erk(_vdp2, (0.0, 10.0), Y0, rtol=1e-5,
                                          atol=1e-8, dense=256)
    assert bool((st == 1).all()) and bool(sol.valid.all())
    r = solve_ivp(lambda t, y: _vdp2(t, y[:, None])[:, 0], (0.0, 10.0),
                  torch.tensor([2.0, 0.0], dtype=torch.float64), method=BS5,
                  rtol=1e-8, atol=1e-11, dense_output=True)
    k = int(ns[0])
    ts0 = sol.ts[0, :k + 1]
    assert bool((torch.diff(ts0) > 0).all())
    ya0 = sol.y_anchor[0, :k].double()
    node_err = (ya0.T - r.sol(ts0[:-1].double())).abs().max().item()
    assert node_err < 1e-3, node_err
    tq = torch.linspace(0.0, 10.0, 73)
    fv = sol(tq)[0]
    assert (fv.double() - r.sol(tq.double())).abs().max().item() < 3e-2
    assert (sol(torch.tensor(10.0))[0] - yf[0]).abs().max().item() < 1e-6
    assert (sol(torch.tensor(12.0))[0] - yf[0]).abs().max().item() == 0.0
    assert (sol.member(0)(tq) - fv).abs().max().item() == 0.0


def test_fused_erk_dense_smooth_tight():
    """A smooth decay's whole dense trajectory within 2e-4 of the exact
    solution, compensated (tests/test_fused_dense.py:82-104)."""
    rates = torch.tensor([0.5, 1.0, 1.7])

    def rows(t, y):
        return -rates[:, None] * y

    Y0 = torch.tensor(np.tile([1.0, 2.0, 0.7], (B_DENSE, 1))
                      .astype(np.float32))
    yf, st, ns, nf, sol = solve_fused_erk(rows, (0.0, 3.0), Y0, rtol=1e-6,
                                          atol=1e-9, dense=128,
                                          compensated=True)
    assert bool((st == 1).all())
    tq = torch.linspace(0.0, 3.0, 41)
    vals = sol(tq)[0]
    exact = (torch.tensor([1.0, 2.0, 0.7])[:, None]
             * torch.exp(-rates[:, None] * tq[None, :]))
    assert (vals - exact).abs().max().item() < 2e-4


def test_fused_erk_dense_overflow_flag():
    Y0 = torch.tensor(np.tile([2.0, 0.0], (B_DENSE, 1)).astype(np.float32))
    sol = solve_fused_erk(_vdp2, (0.0, 10.0), Y0, rtol=1e-5, atol=1e-8,
                          dense=10)[4]
    assert not bool(sol.valid.any())
