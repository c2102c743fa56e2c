"""In-kernel ``t_eval`` snapshots on the port's explicit fused kernels (B1,
B4, B11, B12) and per-member ``params`` on the CKdisc kernels (B11, B12),
on the CPU.

The plain versions (``fused_erk_reference``, ``fused_erk_grid_reference``,
``fused_ckdisc_reference``, ``fused_ckdisc_grid_reference``) run here; the
JAX package's Pallas kernels in interpret mode (without FMA) are read from
``tests/jax_fused_teval.npz`` (``tests/jax_fused_teval.py``), on the same
inputs: B1 plain and compensated with points unsorted, repeated, before t0
and past tf, over a backward span, with ``params`` and with ``dense``; B4
on the periodic advection-reaction; B11 on the sign-switching decay with
points, with its rate a member's parameter and with both; B12 through
``ops.solve_fused`` with ``params``, without and with points.  Every case
gives ``first_step``.  The invariants of the snapshots run on the plain
versions alone: the four outputs bit for bit those without ``t_eval``,
rows at or before t0 exactly y0, rows a member never reaches exactly its
final y, an overflowing member's rows apart from its neighbours', the
dense output at the points against ``y_eval``, and a parameter run bit
for bit the run with the value as a literal.

The tests marked ``gpu`` hold the kernels against these plain versions on
the card (the snapshot build's four outputs bit for bit the build without
it at every shape the rule can take); they skip where there is none.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import BS5, CKdisc, solve_ensemble
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRHS,
                                     fused_ckdisc_grid_reference,
                                     fused_ckdisc_reference,
                                     fused_erk_grid_reference,
                                     fused_erk_reference, solve_fused,
                                     solve_fused_ckdisc,
                                     solve_fused_ckdisc_grid,
                                     solve_fused_erk, solve_fused_erk_grid)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_erk as TK  # noqa: E402

FIXTURE = np.load(Path(__file__).resolve().parent / "jax_fused_teval.npz")
N_ADV = 128
N_CK = 32
# B12's card-only case: at n = 256 its rule's three block shapes differ
# (256, 128 and 64 threads), at N_CK they are one (32)
N_CK_WIDE = 256
SW_CUDA = "const float sw = sinf({f}f * t) >= 0.0f ? 1.0f : -1.0f;"


def _sw(t, freq):
    return torch.where(torch.sin(freq * t) >= 0.0, 1.0, -1.0)


def vdp5(t, y):
    """The Van der Pol of ``tests/test_fused_pallas.py:259`` (mu = 5)."""
    return torch.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def osc(t, y):
    return torch.stack([y[1], -y[0]])


def adv(t, y):
    """The periodic advection-reaction of ``:536`` at n = 128."""
    return -(y - torch.roll(y, 1, 0)) * float(N_ADV) + y * (1.0 - y)


def decay(t, y):
    """The sign-switching decay of ``:1686``."""
    return torch.stack([(-_sw(t, 3.0) - 0.5) * y[0]])


def decay_p(t, y, p):
    """The decay with its rate 0.5 a member's parameter."""
    return torch.stack([(-_sw(t, 3.0) - p[0]) * y[0]])


def sink_p(t, y, p):
    """The grid CKdisc problem of ``:2097`` with its rate a member's
    parameter (``p`` ``(1, B)``)."""
    return -p[0] * y + 0.3 * _sw(t, 4.0)


def sink(t, y):
    """``sink_p`` with the rate 1.25 as a literal."""
    return -1.25 * y + 0.3 * _sw(t, 4.0)


FLAT = "__device__ void rhs(float t, const float* y, float* dy) {\n"
FLAT_P = ("__device__ void rhs(float t, const float* y, float* dy, "
          "const float* p) {\n")
GRID = ("__device__ float rhs(float t, const float* y, int i, "
        "const float* p) {\n")
RHS = {
    "vdp5": FusedRHS(vdp5, FLAT + "  dy[0] = y[1];\n"
                     "  dy[1] = 5.0f * (1.0f - y[0] * y[0]) * y[1] - y[0];\n}",
                     2),
    "osc": FusedRHS(osc, FLAT + "  dy[0] = y[1];\n  dy[1] = -y[0];\n}", 2),
    "vdp_p": TK.PROBLEMS["vdp_p"],
    "adv": FusedGridRHS(adv, GRID + "  return -(y[i] - tab::G::rolled<0>(y, "
                        f"i, 1)) * {float(N_ADV)!r}f\n"
                        "         + y[i] * (1.0f - y[i]);\n}", (N_ADV,)),
    "decay": FusedRHS(decay, FLAT + "  " + SW_CUDA.format(f=3.0) + "\n"
                      "  dy[0] = (-sw - 0.5f) * y[0];\n}", 1),
    "decay_p": FusedRHS(decay_p, FLAT_P + "  " + SW_CUDA.format(f=3.0) + "\n"
                        "  dy[0] = (-sw - p[0]) * y[0];\n}", 1, 1),
    "sink_p": FusedGridRHS(sink_p, GRID + "  " + SW_CUDA.format(f=4.0) + "\n"
                           "  return -p[0] * y[i] + 0.3f * sw;\n}", (N_CK,),
                           1),
    "sink": FusedGridRHS(sink, GRID + "  " + SW_CUDA.format(f=4.0) + "\n"
                         "  return -1.25f * y[i] + 0.3f * sw;\n}", (N_CK,)),
    "sink_p_wide": FusedGridRHS(sink_p, GRID + "  "
                                + SW_CUDA.format(f=4.0) + "\n"
                                "  return -p[0] * y[i] + 0.3f * sw;\n}",
                                (N_CK_WIDE,), 1),
}

# name -> (kernel, problem, span, options), as tests/jax_fused_teval.py
CASES = {
    "b1_plain": ("erk", "vdp5", (0.0, 2.0),
                 dict(rtol=1e-4, atol=1e-6, first_step=0.01)),
    "b1_comp": ("erk", "vdp5", (0.0, 2.0),
                dict(rtol=1e-6, atol=1e-9, first_step=0.01,
                     compensated=True)),
    "b1_back": ("erk", "osc", (3.0, 0.0),
                dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
    "b1_params": ("erk", "vdp_p", (0.0, 3.0),
                  dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
    "b1_dense": ("erk", "vdp5", (0.0, 2.0),
                 dict(rtol=1e-4, atol=1e-6, first_step=0.01, dense=256)),
    "b4_adv": ("erk_grid", "adv", (0.0, 0.5),
               dict(rtol=1e-5, atol=1e-7, first_step=0.005)),
    "b11_teval": ("ckdisc", "decay", (0.0, 5.0),
                  dict(rtol=1e-4, atol=1e-7, first_step=0.01)),
    "b11_params": ("ckdisc", "decay_p", (0.0, 5.0),
                   dict(rtol=1e-4, atol=1e-7, first_step=0.01)),
    "b11_both": ("ckdisc", "decay_p", (0.0, 5.0),
                 dict(rtol=1e-4, atol=1e-7, first_step=0.01)),
    "b12_params": ("ckdisc_grid", "sink_p", (0.0, 2.0),
                   dict(rtol=1e-4, atol=1e-6, first_step=0.01)),
    "b12_params_teval": ("ckdisc_grid", "sink_p", (0.0, 2.0),
                         dict(rtol=1e-4, atol=1e-6, first_step=0.01)),
    "b12_wide": ("ckdisc_grid", "sink_p_wide", (0.0, 2.0),
                 dict(rtol=1e-4, atol=1e-6, first_step=0.01)),
}
# card-only cases: name -> (the fixture's case whose inputs it takes, its
# y0 tiled that many times along the states)
WIDE = {"b12_wide": ("b12_params_teval", N_CK_WIDE // N_CK)}
# one attempt of a case with points inside its first step, bit for bit the
# JAX kernel's: name -> case (the points are the fixture's)
FIRST = {"b1_first": "b1_plain", "b1_comp_first": "b1_comp",
         "b4_first": "b4_adv", "b11_first": "b11_both",
         "b12_first": "b12_params_teval"}
for _name, _case in FIRST.items():
    CASES[_name] = CASES[_case][:3] + (dict(CASES[_case][3], max_steps=1),)
PLAIN = {"erk": fused_erk_reference, "erk_grid": fused_erk_grid_reference,
         "ckdisc": fused_ckdisc_reference,
         "ckdisc_grid": fused_ckdisc_grid_reference}
WRAPPER = {"erk": solve_fused_erk, "erk_grid": solve_fused_erk_grid,
           "ckdisc": solve_fused_ckdisc,
           "ckdisc_grid": solve_fused_ckdisc_grid}


def _inputs(name, device="cpu"):
    """(y0, options with params and t_eval) of a case, from the fixture."""
    kw = dict(CASES[name][3])
    base, reps = WIDE.get(name, (name, 1))
    for key in ("params", "t_eval"):
        if f"{base}/{key}" in FIXTURE.files:
            kw[key] = torch.tensor(FIXTURE[f"{base}/{key}"], device=device)
    y0 = np.tile(FIXTURE[f"{base}/y0"], (1, reps))
    return torch.tensor(y0, device=device), kw


def _port(name, fn=None, device="cpu", **over):
    """The outputs of a case by its plain version (or by ``fn``, taking the
    plain version's arguments) on ``device``, with the options ``over``
    (``t_eval=None`` drops the points)."""
    kind, prob, span, _ = CASES[name]
    y0, kw = _inputs(name, device)
    kw.update(over)
    if kw.get("t_eval") is None:
        kw.pop("t_eval", None)
    if kind.startswith("erk"):
        kw["method"] = BS5
    return (fn or PLAIN[kind])(RHS[prob], span, y0, **kw)


def _np(out):
    return tuple(r.cpu().numpy() if isinstance(r, torch.Tensor) else r
                 for r in out)


def _jax(name):
    n = 5 if f"{name}/4" in FIXTURE.files else 4
    return tuple(FIXTURE[f"{name}/{i}"] for i in range(n))


# (case, max |dy|, max |dy_eval|, max |dnsteps|, max |dnfev|, members with
# other counts), measured on the CPU against the JAX kernels: b1_plain and
# b1_dense 2.1e-5, 1.3e-4, 0, 7, 1; b1_comp 2.1e-7, 1.7e-5, 2, 14, 6;
# b1_back 6.0e-7, 6.0e-7, 0, 0, 0; b1_params 2.7e-6, 4.3e-6, 0, 0, 0;
# b4_adv 1.3e-4, 1.3e-4, 1, 7, 1; b11_teval 2.6e-4, 7.4e-4, 7, 45, 22 of
# 32; b11_params and b11_both 4.2e-4, 1.1e-3, 5, 50, 22 of 32; b12_params
# and b12_params_teval 5.4e-5, 5.4e-5, 2, 31, 3.  From the second attempt
# XLA's and PyTorch's float32 pow part the last bits of h, and a member
# whose error estimate sits at a decision (an attempt rejected or not, a
# cascade's veto at a switch of the decay) takes other steps from there:
# counts are equal on the oscillator and the mu sweep, and apart by a few
# attempts elsewhere; the rows follow the steps.  The gates add about 2x
# (the members with other counts of the b11 cases 4 more: 2x would pass the
# whole batch).
GATES = [
    ("b1_plain", 5e-5, 3e-4, 1, 14, 4),
    ("b1_comp", 5e-7, 4e-5, 4, 28, 12),
    ("b1_back", 2e-6, 2e-6, 0, 0, 0),
    ("b1_params", 6e-6, 1e-5, 0, 0, 0),
    ("b1_dense", 5e-5, 3e-4, 1, 14, 4),
    ("b4_adv", 3e-4, 3e-4, 2, 14, 2),
    ("b11_teval", 6e-4, 1.5e-3, 14, 90, 26),
    ("b11_params", 1e-3, None, 10, 100, 26),
    ("b11_both", 1e-3, 2.2e-3, 10, 100, 26),
    ("b12_params", 1.2e-4, None, 4, 62, 6),
    ("b12_params_teval", 1.2e-4, 1.2e-4, 4, 62, 6),
]


@pytest.mark.parametrize("name,y_gate,yq_gate,dsteps,dfev,nmembers", GATES)
def test_reference_matches_jax_kernel(name, y_gate, yq_gate, dsteps, dfev,
                                      nmembers):
    """The plain versions against the JAX kernels, the outputs in JAX's
    order (y, status, nsteps, nfev, y_eval[, sol]), y_eval's rows at each
    point's index in t_eval: unsorted, repeated and out-of-span points
    included."""
    out = _np(_port(name))
    jx = _jax(name)
    assert len(out) == len(jx) + (1 if CASES[name][3].get("dense") else 0)
    y, status, nsteps, nfev = out[:4]
    np.testing.assert_array_equal(status, jx[1])
    assert np.all(status == 1)
    assert np.max(np.abs(y - jx[0])) <= y_gate
    assert np.max(np.abs(nsteps - jx[2])) <= dsteps
    assert np.max(np.abs(nfev - jx[3])) <= dfev
    assert np.sum((nsteps != jx[2]) | (nfev != jx[3])) <= nmembers
    if len(jx) > 4:
        assert out[4].shape == jx[4].shape
        assert np.max(np.abs(out[4] - jx[4])) <= yq_gate


@pytest.mark.parametrize("name", list(FIRST))
def test_first_attempt_rows_bit_identical(name):
    """One attempt of every member (its first, the JAX kernel's bit for
    bit): the rows of the points it crosses (the cubic Hermite in
    _hermite_tiles' order), of those at or before t0 (y0) and of those
    past it (the final y) are the JAX kernel's bit for bit."""
    out = _np(_port(name))
    jx = _jax(name)
    assert np.all(out[1] == 3)
    for a, b in zip(out, jx):
        np.testing.assert_array_equal(a, b)


def test_dense_output_after_y_eval():
    """With ``dense`` and ``t_eval`` the dense output comes last, after
    y_eval (JAX's order); it agrees with JAX's at six times and with y_eval
    at the points inside the span (both the step's cubic Hermite, summed in
    other orders).  Measured: 1.3e-4 from JAX's (the steps part as in
    b1_plain), 4.8e-7 from y_eval."""
    out = _port("b1_dense")
    sol = out[5]
    got = sol(torch.tensor(FIXTURE["dense_times"], dtype=torch.float32))
    assert np.max(np.abs(got.numpy() - FIXTURE["b1_dense/dense"])) <= 3e-4
    np.testing.assert_array_equal(sol.valid.numpy(), FIXTURE["b1_dense/valid"])
    tq = FIXTURE["b1_dense/t_eval"]
    inside = (tq >= 0.0) & (tq <= 2.0)
    at = sol(torch.tensor(tq[inside])).permute(2, 0, 1)
    assert float((at - out[4][inside]).abs().max()) <= 1e-6


def test_y_eval_tracks_the_f64_driver():
    """``tests/test_fused_pallas.py:259``'s gates on the plain version: each
    point's rows within 2e-3 of the f64 driver's ``t_eval`` output, the t0
    row exactly y0 and the tf row within 1e-6 of the endpoint."""
    y0, kw = _inputs("b1_plain")
    tq = FIXTURE["b1_plain/t_eval"]
    inside = np.flatnonzero((tq >= 0.0) & (tq <= 2.0))
    out = _port("b1_plain")
    ref = solve_ensemble(vdp5, (0.0, 2.0), y0[:16].double(), method=BS5,
                         rtol=1e-4, atol=1e-6,
                         t_eval=torch.tensor(tq[inside], dtype=torch.float64))
    d = (out[4][inside, :16].double() - ref.y_eval.permute(1, 0, 2)).abs()
    assert float(d.max()) < 2e-3
    assert torch.equal(out[4][int(np.flatnonzero(tq == 0.0)[0])], y0)
    assert float((out[4][int(np.flatnonzero(tq == 2.0)[0])]
                  - out[0]).abs().max()) < 1e-6


# cases of each plain version with points, for the invariants
TEVAL_CASES = ["b1_plain", "b1_comp", "b1_back", "b1_params", "b4_adv",
               "b11_both", "b12_params_teval"]


@pytest.mark.parametrize("name", TEVAL_CASES)
def test_t_eval_leaves_the_outputs_bit_for_bit(name):
    """The four outputs with ``t_eval`` are those without it, bit for bit,
    and so is the dense record beside it."""
    out = _port(name)
    off = _port(name, t_eval=None)
    assert len(out) == len(off) + 1
    for a, b in zip(out[:4], off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", TEVAL_CASES)
def test_rows_before_t0_and_unreached_rows_exact(name):
    """Rows of points at or before t0 are y0 and rows of points a member
    never reaches are its final y, bit for bit: past tf, and where
    ``max_steps`` stops the members early (status 3) every point past their
    last accepted step."""
    span = CASES[name][2]
    y0, kw = _inputs(name)
    tq = kw["t_eval"].numpy()
    d = np.sign(span[1] - span[0])
    for max_steps in (None, 4):
        over = {} if max_steps is None else dict(max_steps=max_steps)
        out = _port(name, **over)
        for q in np.flatnonzero(d * tq <= d * span[0]):
            assert torch.equal(out[4][q], y0)
        if max_steps is None:
            assert torch.all(out[1] == 1)
            for q in np.flatnonzero(d * tq > d * span[1]):
                assert torch.equal(out[4][q], out[0])
        else:
            assert torch.all(out[1] == 3)
            # the members' final t from the rows they keep: a point is
            # unreached where its row is the final y of every member whose
            # last step ends before it; the last point inside the span
            # lies beyond 4 attempts on every case
            far = int(np.argmax(np.where(d * tq < d * span[1], d * tq,
                                         -np.inf)))
            assert torch.equal(out[4][far], out[0])


def _overflow_case(name):
    """A case's members, and the same with member 3's state times 1e20,
    which makes the Van der Pol and the advection-reaction blow up."""
    y0, kw = _inputs(name)
    bad = y0.clone()
    bad[3] = bad[3] * 1e20
    return y0, bad, kw


@pytest.mark.parametrize("name", ["b1_plain", "b4_adv"])
def test_overflowing_member_keeps_to_its_rows(name):
    """A member whose state overflows ends with status 3 and its rows take
    its last finite state, while its neighbours' rows are bit for bit those
    of the run where it is finite."""
    kind, prob, span, _ = CASES[name]
    y0, bad, kw = _overflow_case(name)
    kw["method"] = BS5
    kw["max_steps"] = 2000
    good = PLAIN[kind](RHS[prob], span, y0, **kw)
    out = PLAIN[kind](RHS[prob], span, bad, **kw)
    assert int(out[1][3]) == 3 and int((out[1] == 1).sum()) == len(y0) - 1
    keep = torch.arange(len(y0)) != 3
    assert torch.equal(out[4][:, keep], good[4][:, keep])
    assert bool(torch.isfinite(out[4][:, 3]).all())


def test_params_bit_for_bit_the_literal():
    """A parameter run with every member at the literal's value is bit for
    bit the run with the value as a literal, rows included: B11's decay at
    rate 0.5, B12's sink at rate 1.25; and in B11's sweep the member at 0.5
    is the literal run's member bit for bit (the same batch)."""
    y0, kw = _inputs("b11_both")
    half = torch.full_like(kw["params"], 0.5)
    lit = fused_ckdisc_reference(RHS["decay"], (0.0, 5.0), y0, **dict(
        kw, params=None))
    par = fused_ckdisc_reference(RHS["decay_p"], (0.0, 5.0), y0, **dict(
        kw, params=half))
    for a, b in zip(lit, par):
        assert torch.equal(a, b)
    sweep = fused_ckdisc_reference(RHS["decay_p"], (0.0, 5.0), y0, **kw)
    assert float(kw["params"][5]) == 0.5
    for a, b in zip(lit, sweep):
        assert torch.equal(a[..., 5, :] if a.ndim == 3 else a[5],
                           b[..., 5, :] if b.ndim == 3 else b[5])
    y0, kw = _inputs("b12_params_teval")
    lit = fused_ckdisc_grid_reference(RHS["sink"], (0.0, 2.0), y0, **dict(
        kw, params=None))
    par = fused_ckdisc_grid_reference(RHS["sink_p"], (0.0, 2.0), y0, **dict(
        kw, params=torch.full_like(kw["params"], 1.25)))
    for a, b in zip(lit, par):
        assert torch.equal(a, b)


def test_front_door_and_wrappers_on_cpu():
    """``ops.solve_fused`` routes CKdisc with a FusedRHS or FusedGridRHS of
    k parameters, and the wrappers on CPU tensors run the plain versions
    (no launch), bit for bit; an empty t_eval returns the four outputs."""
    for name, wrapper in (("b11_both", solve_fused_ckdisc),
                          ("b12_params_teval", solve_fused_ckdisc_grid),
                          ("b1_params", solve_fused_erk),
                          ("b4_adv", solve_fused_erk_grid)):
        before = wrapper.launches
        ref = _port(name)
        # CKdisc unless the case passes its method (BS5)
        for fn in (wrapper, lambda *a, **k: solve_fused(
                *a, **dict(dict(method=CKdisc), **k))):
            out = _port(name, fn=fn)
            assert len(out) == len(ref)
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
        assert wrapper.launches == before
        assert len(_port(name, t_eval=[])) == 4


@pytest.mark.parametrize("solve_fn", [solve_fused_erk, solve_fused_erk_grid,
                                      solve_fused_ckdisc,
                                      solve_fused_ckdisc_grid])
def test_events_still_raise(solve_fn):
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        solve_fn(decay, (0.0, 1.0), torch.ones(4, 1), events=lambda t, y: y)


def test_params_are_checked():
    """B11 and B12 check params as B1 does: a (B, k) shape agreeing with the
    function's k."""
    y0, kw = _inputs("b11_params")
    with pytest.raises(ValueError, match="takes 1 parameters"):
        solve_fused_ckdisc(RHS["decay_p"], (0.0, 1.0), y0)
    with pytest.raises(ValueError, match="params must be"):
        solve_fused_ckdisc(RHS["decay_p"], (0.0, 1.0), y0,
                           params=kw["params"][:-1])
    y0, kw = _inputs("b12_params")
    with pytest.raises(ValueError, match="k = 0"):
        solve_fused_ckdisc_grid(RHS["sink"], (0.0, 1.0), y0,
                                params=kw["params"])


def test_generated_headers_carry_the_switches():
    """The generated headers carry tab::SNAP where asked and B11's NPAR."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_ckdisc import ck_consts
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    k = _fused_consts(BS5)
    assert "constexpr bool SNAP = true;" in _build.fused_erk_header(
        k, 2, RHS["vdp5"].cuda_src, snap=True)
    assert "constexpr bool SNAP = false;" in _build.fused_erk_header(
        k, 2, RHS["vdp5"].cuda_src)
    grid = _build.fused_rk_grid_header(ck_consts(), False, (N_CK,),
                                       RHS["sink_p"].cuda_src, 1, False, True)
    assert "constexpr int NPAR = 1;" in grid
    assert "constexpr bool SNAP = true;" in grid
    flat = _build.fused_ckdisc_header(ck_consts(), 1, RHS["decay_p"].cuda_src,
                                      1, True)
    assert "constexpr int NPAR = 1;" in flat
    assert "constexpr bool SNAP = true;" in flat


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# each kernel with snapshots against its plain version on the card: (max
# |dy|, max |dy_eval|) over the finished members.  Measured on an H100
# (nvcc's contraction moves h, so a member may take other steps, and its
# rows then come from other cubic Hermites): b1_plain 5.0e-4, 5.0e-4;
# b1_comp 3.4e-7, 1.6e-5; b1_back 1.3e-6, 4.8e-4; b1_params 1.6e-4,
# 1.6e-3; b4_adv 1.2e-4, 2.7e-4; b11_both and b11_params 2.7e-4, 1.9e-3;
# b12_params_teval and b12_params 9.2e-4, 9.2e-4; b12_wide (at 256, 128
# and 64 threads) 9.2e-4; the same y_eval at every shape.  Gates about 3x
CARD_GATES = {"b1_plain": (1.5e-3, 1.5e-3), "b1_comp": (1e-6, 5e-5),
              "b1_back": (4e-6, 1.5e-3), "b1_params": (5e-4, 5e-3),
              "b4_adv": (4e-4, 8e-4), "b11_both": (1e-3, 6e-3),
              "b12_params_teval": (3e-3, 3e-3), "b11_params": (1e-3, None),
              "b12_params": (3e-3, None), "b12_wide": (3e-3, 3e-3)}
# one attempt (FIRST) on the card against the plain version, y and y_eval:
# only nvcc's contraction parts them
CARD_FIRST_GATE = 1e-6


def _card_shapes(name, y0):
    """Every shape the kind's rule can take: B1's lanes (1, 2, 4, 8), B4's
    blocks and warp, B11's lanes (1 to 32), B12's three blocks."""
    from extensisq_tpu_torch.ops import fused_ckdisc_grid as FCG
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    kind = CASES[name][0]
    n = y0.shape[1]
    t = FKG.grid_threads
    return {"erk": [1, 2, 4, 8], "ckdisc": [1, 2, 4, 8, 16, 32],
            "erk_grid": [(t(n), 0), (t(-(-n // 2)), 0),
                         (32, FKG.WARP_MEMBERS)],
            "ckdisc_grid": [(t(n), 0), (t(-(-n // 2)), 0),
                            (min(FCG.SMALL_THREADS, t(n)), 0)]}[kind]


def _card_launch(name, shape, y0, kw):
    """A case forced to ``shape`` on the card (a comparison launch, not
    counted), with its options ``kw`` (t_eval None: the build without the
    snapshots)."""
    from extensisq_tpu_torch.ops import fused_ckdisc as FC
    from extensisq_tpu_torch.ops import fused_ckdisc_grid as FCG
    from extensisq_tpu_torch.ops import fused_erk as FK
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    kind, prob, span, _ = CASES[name]
    fun = RHS[prob]
    tq = kw.get("t_eval")
    if kind == "erk":
        return FK._launch(fun, span, y0, BS5, kw["rtol"], kw["atol"],
                          kw.get("first_step"), 100_000,
                          kw.get("compensated", False), None, shape, None,
                          kw.get("params"), None, tq)[0]
    if kind == "ckdisc":
        return FC._launch(fun, span, y0, kw["rtol"], kw["atol"],
                          kw.get("first_step"), 100_000, None, shape, None,
                          kw.get("params"), tq)[0]
    opts = {k: v for k, v in kw.items() if k not in ("dense", "method")}
    if kind == "erk_grid":
        built = FKG._kernel(BS5, fun, False, tq is not None)
        return FKG._launch(built, span, y0, y0.shape[1], shape=shape,
                           **opts)[0]
    built = FCG._kernel(fun, tq is not None)
    return FCG._launch(built, span, y0, y0.shape[1], shape=shape, **opts)[0]


def _finished_err(a, b, ok):
    return float((a[..., ok, :] - b[..., ok, :]).abs().max()) if ok.any() \
        else 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["b1_plain", "b1_comp", "b1_back",
                                  "b1_params", "b4_adv", "b11_both",
                                  "b12_params_teval"])
def test_y_eval_matches_plain_version_on_card(cuda, name):
    """Each kernel's snapshot build through its wrapper (one launch) against
    its plain version on the card: status identical, y and y_eval within
    the card gates."""
    kind = CASES[name][0]
    wrapper = WRAPPER[kind]
    before = wrapper.launches
    k = _port(name, fn=wrapper, device=cuda)
    assert wrapper.launches == before + 1
    r = _port(name, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    dy = float((k[0][ok] - r[0][ok]).abs().max())
    dq = _finished_err(k[4], r[4], ok)
    print(f"{name}: max |dy| {dy:.3e}, max |dy_eval| {dq:.3e}")
    assert dy <= CARD_GATES[name][0] and dq <= CARD_GATES[name][1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["b1_plain", "b1_comp", "b1_params",
                                  "b4_adv", "b11_both", "b12_params_teval",
                                  "b12_wide"])
def test_snapshot_build_bit_for_bit_at_every_shape_on_card(cuda, name):
    """At every shape the kind's rule can take, the snapshot build's four
    outputs are the build without it bit for bit, and its y_eval lies
    within the card gate of the plain version's.  Comparison launches are
    not counted."""
    y0, kw = _inputs(name, cuda)
    kw.pop("dense", None)
    r = _port(name, device=cuda)
    ok = r[1] == 1
    wrapper = WRAPPER[CASES[name][0]]
    before = wrapper.launches
    shapes = _card_shapes(name, y0)
    if name == "b12_wide":
        assert len(set(shapes)) == 3, shapes
    for shape in dict.fromkeys(shapes):
        on = _card_launch(name, shape, y0, kw)
        off = _card_launch(name, shape, y0, dict(kw, t_eval=None))
        assert len(on) == 5 and len(off) == 4
        for a, b in zip(on, off):
            assert torch.equal(a, b), shape
        dq = _finished_err(on[4], r[4], ok)
        print(f"{name} at {shape}: max |dy_eval| {dq:.3e}")
        assert dq <= CARD_GATES[name][1]
    assert wrapper.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["b11_params", "b12_params"])
def test_ckdisc_params_match_plain_version_on_card(cuda, name):
    """B11 and B12 with a parameter a member against their plain versions
    on the card (one launch each): status identical, y within the card
    gates."""
    wrapper = WRAPPER[CASES[name][0]]
    before = wrapper.launches
    k = _port(name, fn=wrapper, device=cuda)
    assert wrapper.launches == before + 1
    r = _port(name, device=cuda)
    assert len(k) == 4 and torch.equal(k[1], r[1])
    ok = r[1] == 1
    dy = float((k[0][ok] - r[0][ok]).abs().max())
    print(f"{name}: max |dy| {dy:.3e}")
    assert dy <= CARD_GATES[name][0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FIRST))
def test_first_attempt_rows_on_card(cuda, name):
    """One attempt of every member with points inside its first step, before
    t0 and past it: the kernel's outputs and rows against the plain
    version's, the counts equal, y and y_eval within CARD_FIRST_GATE."""
    k = _port(name, fn=WRAPPER[CASES[name][0]], device=cuda)
    r = _port(name, device=cuda)
    for a, b in zip(k[1:4], r[1:4]):
        assert torch.equal(a, b)
    d = max(float((k[0] - r[0]).abs().max()),
            float((k[4] - r[4]).abs().max()))
    print(f"{name}: max |dy| and |dy_eval| {d:.3e}")
    assert d <= CARD_FIRST_GATE
