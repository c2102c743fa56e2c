"""In-kernel ``t_eval`` snapshots on the port's SWAG and RKC fused kernels
(B3, B8, B9, B10), on the CPU.

The plain versions (``fused_adams_reference``, ``fused_adams_grid_reference``
and ``fused_rkc_reference``, which the RKC wrappers run on CPU tensors) run
here; the JAX package's Pallas kernels in interpret mode (without FMA) are
read from ``tests/jax_fused_teval_adams_rkc.npz``
(``tests/jax_fused_teval_adams_rkc.py``), on the same inputs: B3 on Van der
Pol (mu = 5, the JAX package's ``test_fused_adams_t_eval``), plain and
compensated, with ``params`` (mu a member's parameter) and with ``dense``
on the oscillator (``tests/test_fused_dense.py:298``); B8 on the periodic
heat MoL at n = 32 (``test_fused_adams_grid_t_eval``), with ``params`` (the
diffusivity) and with ``dense`` on the upwind advection
(``tests/test_fused_dense.py:244``); B9 and B10 on the 2x16x16 Brusselator
(``test_fused_rkc_t_eval``, ``test_fused_rkc_ensemble_power_events_teval``)
with a float bound and with the power iteration, and one case each with
points out of order and a NaN point, which shows JAX's pending index.
SWAG's cases keep k_max = 4 (XLA compiles the interpret-mode SWAG body in
time ~k_max^3) and give ``first_step``; one attempt of B3 and B8 with
points inside the first step is held bit for bit.

SWAG's near-end extrapolation writes JAX's straight line y + (tq - t) y' to
the points in (t, tf].  In float32 no point can lie there: the
extrapolation runs where the double-single remainder (tf - t) - t_lo is
within 4 2^-30 |t|, which holds only where t's high word is tf itself (a
high word below tf leaves at least half an ulp of t, ~6e-8 |t|), and then
(t, tf] is empty.  So the branch is held by unit tests of the plain
version's rows against the formula and of the kernel's rows
(``csrc/snapshot.cuh``, compiled for the host) against the plain version's.

The tests marked ``gpu`` hold the kernels against these plain versions on
the card (the snapshot build's outputs bit for bit the build without it at
every shape the rules can take); they skip where there is none.
"""
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import parallel
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRHS,
                                     fused_adams_grid_reference,
                                     fused_adams_reference,
                                     fused_rkc_reference, solve_fused,
                                     solve_fused_adams,
                                     solve_fused_adams_grid, solve_fused_rkc,
                                     solve_fused_rkc_ensemble)
from extensisq_tpu_torch.ops.fused_erk import Snapshots

sys.path.insert(0, str(Path(__file__).resolve().parent))

FIXTURE_PATH = (Path(__file__).resolve().parent
                / "jax_fused_teval_adams_rkc.npz")
B_FLAT = 128        # B3 members (one JAX block)
B_GRID = 8          # B8 members
N_GRID = 32         # B8 states (the JAX kernel pads to 128 lanes)
D_HEAT = 0.05
NY, NX = 16, 16     # the Brusselator grid
ALPHA = 0.02
RHO = 8.0 * ALPHA * NX**2 + 2.0 + 3.0
RHO_ENS = 8.0 * ALPHA * NX**2 + 2.0 + 3.5


def vdp5(t, y):
    return torch.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def vdp_p(t, y, p):
    return torch.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]])


def osc(t, y):
    return torch.stack([y[1], -y[0]])


def heat(t, y):
    """Periodic heat MoL, D = 0.05, dx = 1/n, rows-first (n, B)."""
    return (torch.roll(y, 1, 0) + torch.roll(y, -1, 0) - 2.0 * y) \
        * (D_HEAT * N_GRID * N_GRID)


def heat_p(t, y, p):
    """The heat MoL with the diffusivity a member's parameter."""
    return p[0] * (torch.roll(y, 1, 0) - 2.0 * y + torch.roll(y, -1, 0)) \
        * float(N_GRID * N_GRID)


def adv(t, y):
    """Periodic upwind advection, -(y - roll(y, 1)) 0.2 n."""
    return -(y - torch.roll(y, 1, 0)) * (0.2 * N_GRID)


RHS = {
    "vdp5": FusedRHS(vdp5, """__device__ void rhs(float t, const float* y,
                    float* dy) {
  dy[0] = y[1];
  dy[1] = 5.0f * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2),
    "vdp_p": FusedRHS(vdp_p, """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = y[1];
  dy[1] = p[0] * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2, 1),
    "osc": FusedRHS(osc, """__device__ void rhs(float t, const float* y,
                    float* dy) {
  dy[0] = y[1];
  dy[1] = -y[0];
}""", 2),
    "heat": FusedGridRHS(heat, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  using G = tab::G;
  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) - 2.0f * y[i])
         * {float(np.float32(D_HEAT * N_GRID * N_GRID))!r}f;
}}""", (N_GRID,)),
    "heat_p": FusedGridRHS(heat_p, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  using G = tab::G;
  return p[0] * (G::rolled<0>(y, i, 1) - 2.0f * y[i]
                 + G::rolled<0>(y, i, -1)) * {float(N_GRID * N_GRID)!r}f;
}}""", (N_GRID,), 1),
    "adv": FusedGridRHS(adv, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  using G = tab::G;
  return -(y[i] - G::rolled<0>(y, i, 1)) * {0.2 * N_GRID!r}f;
}}""", (N_GRID,)),
    "brus": parallel.brusselator_2d_grid((NY, NX), alpha=ALPHA),
    "brus_p": parallel.brusselator_2d_grid((NY, NX), B=None, alpha=ALPHA),
}


def _brus0(amp):
    xg = np.linspace(0, 1, NX, endpoint=False)
    y0 = np.zeros((2, NY, NX), np.float32)
    y0[0] = 1.0 + amp * np.sin(2 * np.pi * xg)[None, :]
    y0[1] = 3.0
    return y0


def inputs():
    """name -> array of every case's inputs."""
    x = np.linspace(0, 1, N_GRID, endpoint=False)
    return {
        "vdp": np.stack([np.linspace(1.9, 2.1, B_FLAT), np.zeros(B_FLAT)],
                        1).astype(np.float32),
        "mu": np.linspace(1.0, 2.0, B_FLAT).astype(np.float32)[:, None],
        "osc": np.tile([1.0, 0.5], (B_FLAT, 1)).astype(np.float32),
        "heat": (np.linspace(0.8, 1.2, B_GRID)[:, None]
                 * np.sin(2 * np.pi * x)[None, :]).astype(np.float32),
        "diff": np.linspace(0.03, 0.06, B_GRID).astype(np.float32)[:, None],
        "adv": np.tile((1.0 + 0.3 * np.sin(2 * np.pi * x)),
                       (B_GRID, 1)).astype(np.float32),
        "brus": _brus0(0.3),
        "ens": np.stack([_brus0(a) for a in (0.2, 0.3, 0.4, 0.5)]),
        "bs": np.linspace(2.8, 3.5, 4).astype(np.float32)[:, None],
    }


Y0 = inputs()
RHOS = {"float": RHO, "float_ens": RHO_ENS, "power": None}
TQ_VDP = [1.1, 0.0, 0.5, 2.0, 1.7, 1.7, -0.5, 2.5]
TQ_HEAT = [0.1, 0.0, 0.25, 0.05, 0.05, -0.1, 0.3]
# name -> (kernel, problem, span, y0, options); the options name the
# inputs of params by their keys of Y0 and rho by its key of RHOS
CASES = {
    "b3_vdp": ("adams", "vdp5", (0.0, 2.0), "vdp",
               dict(rtol=1e-4, atol=1e-6, k_max=4, first_step=1e-3,
                    t_eval=TQ_VDP)),
    "b3_vdp_comp": ("adams", "vdp5", (0.0, 2.0), "vdp",
                    dict(rtol=1e-6, atol=1e-9, k_max=4, first_step=1e-4,
                         compensated=True, t_eval=TQ_VDP)),
    "b3_params": ("adams", "vdp_p", (0.0, 3.0), "vdp",
                  dict(rtol=1e-5, atol=1e-8, k_max=4, first_step=1e-3,
                       params="mu",
                       t_eval=[1.5, 0.0, 3.0, 0.7, 2.2, 2.2, -1.0, 4.0])),
    "b3_dense": ("adams", "osc", (0.0, 4.0), "osc",
                 dict(rtol=1e-5, atol=1e-8, k_max=4, first_step=1e-3,
                      dense=256, t_eval=np.linspace(0.0, 4.0, 6))),
    "b3_first": ("adams", "vdp5", (0.0, 2.0), "vdp",
                 dict(rtol=1e-4, atol=1e-6, k_max=4, first_step=1e-4,
                      max_steps=1,
                      t_eval=[5e-5, 0.0, 1e-4, 2.5e-5, 0.5, -0.1, 5e-5])),
    "b8_heat": ("adams_grid", "heat", (0.0, 0.25), "heat",
                dict(rtol=1e-4, atol=1e-6, k_max=4, first_step=1e-3,
                     t_eval=TQ_HEAT)),
    "b8_params": ("adams_grid", "heat_p", (0.0, 0.25), "heat",
                  dict(rtol=1e-4, atol=1e-6, k_max=4, first_step=1e-3,
                       params="diff", t_eval=TQ_HEAT)),
    "b8_dense": ("adams_grid", "adv", (0.0, 1.0), "adv",
                 dict(rtol=1e-5, atol=1e-8, k_max=4, first_step=1e-3,
                      dense=256, t_eval=np.linspace(0.0, 1.0, 6))),
    "b8_first": ("adams_grid", "heat", (0.0, 0.25), "heat",
                 dict(rtol=1e-4, atol=1e-6, k_max=4, first_step=1e-3,
                      max_steps=1,
                      t_eval=[5e-4, 0.0, 1e-3, 2.5e-4, 0.2, -0.1])),
    "b9_float": ("rkc", "brus", (0.0, 1.0), "brus",
                 dict(rho="float", rtol=1e-4, atol=1e-7,
                      t_eval=[0.0, 0.1, 0.25, 0.5, 0.77, 1.0, 1.5])),
    "b9_power": ("rkc", "brus", (0.0, 1.0), "brus",
                 dict(rho="power", rtol=1e-4, atol=1e-7,
                      t_eval=[0.0, 0.1, 0.25, 0.5, 0.77, 1.0, 1.5])),
    "b9_pending": ("rkc", "brus", (0.0, 1.0), "brus",
                   dict(rho="float", rtol=1e-4, atol=1e-7,
                        t_eval=[-0.1, 0.25, 0.75, 0.5, np.nan, 0.9, 0.3])),
    "b10_float": ("rkc_ens", "brus_p", (0.0, 1.0), "ens",
                  dict(rho="float_ens", params="bs", rtol=1e-4, atol=1e-7,
                       t_eval=[0.25, 0.5, 0.75, 1.0, 2.0])),
    "b10_power": ("rkc_ens", "brus_p", (0.0, 1.0), "ens",
                  dict(rho="power", params="bs", rtol=1e-4, atol=1e-7,
                       t_eval=[0.25, 0.5, 0.75, 1.0, 2.0])),
    "b10_pending": ("rkc_ens", "brus_p", (0.0, 1.0), "ens",
                    dict(rho="float_ens", params="bs", rtol=1e-4, atol=1e-7,
                         t_eval=[0.0, 0.25, 0.75, 0.5, np.nan, 0.9])),
}
FIRST = ["b3_first", "b8_first"]
PENDING = ["b9_pending", "b10_pending"]
DENSE = ["b3_dense", "b8_dense"]
WRAPPER = {"adams": solve_fused_adams, "adams_grid": solve_fused_adams_grid,
           "rkc": solve_fused_rkc, "rkc_ens": solve_fused_rkc_ensemble}


def spec(name):
    """(kernel, problem, span, y0 (numpy), options with params filled in as
    a numpy array, rho as its value and t_eval as float32) of a case: what
    the JAX script and the tests run."""
    kind, prob, span, y0, kw = CASES[name]
    kw = dict(kw)
    if "params" in kw:
        kw["params"] = Y0[kw["params"]]
    if "rho" in kw:
        kw["rho"] = RHOS[kw["rho"]]
    kw["t_eval"] = np.asarray(kw["t_eval"], np.float32)
    return kind, prob, span, Y0[y0], kw


def _plain_fn(kind):
    """The plain version of a kernel, with the wrappers' argument order and
    outputs (B9 on one grid)."""
    if kind == "adams":
        return fused_adams_reference
    if kind == "adams_grid":
        return fused_adams_grid_reference

    def rkc(fun, span, y0, **kw):
        rho = kw.pop("rho")
        if kind == "rkc_ens":
            return fused_rkc_reference(fun, span, y0, rho, **kw)
        return tuple(x[0] for x in fused_rkc_reference(fun, span, y0[None],
                                                       rho, **kw))
    return rkc


def _port(name, fn=None, device="cpu", **over):
    """The outputs of a case by its plain version (or by ``fn``, taking the
    wrappers' arguments) on ``device``, with the options ``over``
    (``t_eval=None`` drops the points); the plain version's run of a case
    as it stands on the CPU is made once (``_plain``)."""
    if fn is None and device == "cpu" and not over:
        return _plain(name)
    kind, prob, span, y0, kw = spec(name)
    kw = dict(kw, **over)
    if "params" in kw:
        kw["params"] = torch.tensor(kw["params"], device=device)
    if kw.get("t_eval") is None:
        kw.pop("t_eval", None)
    if fn is not None and kind.startswith("rkc"):
        return fn(RHS[prob], span, torch.tensor(y0, device=device),
                  kw.pop("rho"), **kw)
    return (fn or _plain_fn(kind))(RHS[prob], span,
                                   torch.tensor(y0, device=device), **kw)


@functools.lru_cache(maxsize=None)
def _plain(name):
    """The plain version's outputs of a case on the CPU, made once; the
    tests read them and change nothing in them."""
    return _port(name, t_eval=spec(name)[4]["t_eval"])


def _np(out):
    return tuple(r.cpu().numpy() if isinstance(r, torch.Tensor) else r
                 for r in out)


def _fixture():
    return np.load(FIXTURE_PATH)


def _yq_at(name):
    """The index of y_eval in a case's outputs: after the four (and, for
    the power iteration's RKC cases, after nfesig)."""
    kind, _, _, _, kw = spec(name)
    return 5 if kind.startswith("rkc") and kw["rho"] is None else 4


def _jax(name):
    fx = _fixture()
    return tuple(fx[f"{name}/{i}"] for i in range(_yq_at(name) + 1))


# (case, max |dy|, max |dy_eval|, max |dnsteps|, max |dnfev|, members
# with other counts), measured on the CPU against the JAX kernels: b3_vdp
# 5.8e-7, 5.8e-7; b3_vdp_comp 0, 1.2e-7; b3_params 1.8e-6, 1.8e-6;
# b3_dense, b8_params and b8_dense 0, 0; b8_heat 6e-8, 6e-8; b9_float
# 1.4e-6, 1.4e-6; b9_power 1.4e-6, 1.9e-6; b10_float 2.6e-6, 2.6e-6;
# b10_power 2.3e-6, 2.4e-6; the pending cases 1.4e-6 (b9) and 2.6e-6 (b10)
# on y, and 8.0e-5 and 9.1e-5 on y_eval, the rows of the points out of
# order (the cubic at theta down to ~-3, which amplifies the end pairs'
# differences); every count equal.  What parts the two is XLA's and
# PyTorch's float32 pow in SWAG's step ratio, and RKC's
# sinh/cosh/pow and grid sums (tests/test_torch_fused_rkc.py holds RKC at
# 5e-6 with equal counts).  The gates add about 2x (at least 1e-7, 5e-6 on
# RKC), SWAG's counts a step of margin.
GATES = [
    ("b3_vdp", 1.2e-6, 1.2e-6, 1, 2, 2),
    ("b3_vdp_comp", 1e-7, 2.5e-7, 1, 2, 2),
    ("b3_params", 4e-6, 4e-6, 1, 2, 2),
    ("b3_dense", 1e-7, 1e-7, 1, 2, 2),
    ("b8_heat", 1.2e-7, 1.2e-7, 1, 2, 1),
    ("b8_params", 1e-7, 1e-7, 1, 2, 1),
    ("b8_dense", 1e-7, 1e-7, 1, 2, 1),
    ("b9_float", 5e-6, 5e-6, 0, 0, 0),
    ("b9_power", 5e-6, 5e-6, 0, 0, 0),
    ("b9_pending", 5e-6, 2e-4, 0, 0, 0),
    ("b10_float", 5e-6, 5e-6, 0, 0, 0),
    ("b10_power", 5e-6, 5e-6, 0, 0, 0),
    ("b10_pending", 5e-6, 2e-4, 0, 0, 0),
]


@pytest.mark.parametrize("name,y_gate,yq_gate,dsteps,dfev,nmembers", GATES)
def test_reference_matches_jax_kernel(name, y_gate, yq_gate, dsteps, dfev,
                                      nmembers):
    """The plain versions against the JAX kernels, the outputs in JAX's
    order and shapes: SWAG's ``y_eval`` (nq, B, n) after nfev (and before
    the dense output), B9's (nq, *shape) and B10's (members, nq, *shape)
    after nfesig where the power iteration runs; the rows at each point's
    index in t_eval (unsorted, repeated and out-of-span points included,
    and for RKC's pending cases points out of order and NaN)."""
    out = _np(_port(name))
    jx = _jax(name)
    at = _yq_at(name)
    dense = bool(CASES[name][4].get("dense"))
    assert len(out) == at + 1 + dense
    y, status, nsteps, nfev = (np.asarray(a) for a in out[:4])
    jstatus, jnsteps, jnfev = (np.asarray(a).reshape(status.shape)
                               for a in jx[1:4])
    np.testing.assert_array_equal(status, jstatus)
    assert np.all(status == 1)
    if at == 5:
        np.testing.assert_array_equal(np.asarray(out[4]).reshape(-1),
                                      np.asarray(jx[4]).reshape(-1))
    assert out[at].shape == jx[at].shape
    assert np.max(np.abs(y - jx[0])) <= y_gate
    finite = np.isfinite(jx[at])
    np.testing.assert_array_equal(np.isfinite(out[at]), finite)
    assert np.max(np.abs(out[at] - jx[at])[finite]) <= yq_gate
    assert np.max(np.abs(nsteps - jnsteps)) <= dsteps
    assert np.max(np.abs(nfev - jnfev)) <= dfev
    assert np.sum((nsteps != jnsteps) | (nfev != jnfev)) <= nmembers


@pytest.mark.parametrize("name", FIRST)
def test_first_attempt_rows_match_jax_kernel(name):
    """One attempt of every member from ``first_step`` (its first, the JAX
    kernel's), with points inside the step, before t0 and past it, one
    twice: the counts, the state and the rows are the JAX kernel's bit for
    bit (the Hermite in _hermite_tiles' order)."""
    out = _np(_port(name))
    jx = _jax(name)
    assert np.all(out[1] == 3) and np.all(out[2] == 1)
    for a, b in zip(out[1:4], jx[1:4]):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(a.shape))
    np.testing.assert_array_equal(out[0], jx[0])
    np.testing.assert_array_equal(out[4], jx[4])


# sol(t_eval) against y_eval: JAX's own gates (tests/test_fused_dense.py
# :244, :298), both the cubic Hermite of the accepted steps' end pairs
DENSE_GATE = 5e-5


@pytest.mark.parametrize("name", DENSE)
def test_dense_output_matches_y_eval(name):
    """With ``dense`` and ``t_eval`` the dense output comes last, after
    y_eval (JAX's order); at the points its values are y_eval's within
    JAX's gate, at tf the final state within 1e-6, every member's record
    is complete, and the four outputs and the record are those of the run
    without the points bit for bit."""
    out = _port(name)
    _, _, span, _, kw = spec(name)
    sol = out[5]
    assert bool(sol.valid.all())
    at = sol(torch.tensor(kw["t_eval"])).permute(2, 0, 1)
    assert float((at - out[4]).abs().max()) <= DENSE_GATE
    end = sol(torch.tensor(np.float32(span[1])))
    assert float((end - out[0]).abs().max()) <= 1e-6
    off = _port(name, t_eval=None)
    assert len(off) == 5
    for a, b in zip(out[:4], off[:4]):
        assert torch.equal(a, b)
    assert torch.equal(sol.valid, off[4].valid)
    assert torch.equal(sol(torch.tensor(kw["t_eval"])),
                       off[4](torch.tensor(kw["t_eval"])))


TEVAL_CASES = [n for n in CASES if n not in FIRST]


@pytest.mark.parametrize("name", TEVAL_CASES)
def test_t_eval_leaves_the_outputs_bit_for_bit(name):
    """The other outputs with ``t_eval`` are those without it, bit for bit
    (nfesig too)."""
    out = _port(name)
    off = _port(name, t_eval=None)
    at = _yq_at(name)
    assert len(out) == len(off) + 1
    for a, b in zip(out[:at], off[:at]):
        assert torch.equal(a, b)


SWAG_CASES = [n for n in TEVAL_CASES if n.startswith("b3")
              or n.startswith("b8")]


@pytest.mark.parametrize("name", SWAG_CASES)
def test_swag_rows_before_t0_and_unreached_rows_exact(name):
    """SWAG's rows of points at or before t0 are y0 and rows of points a
    member never reaches are its final state, bit for bit: past tf, and
    where ``max_steps`` stops the members early (status 3) every point past
    their last accepted step."""
    _, _, span, y0, kw = spec(name)
    y0 = torch.tensor(y0)
    tq = kw["t_eval"]
    span = np.float32(span)
    for max_steps in (None, 3):
        over = {} if max_steps is None else dict(max_steps=max_steps)
        out = _port(name, **over)
        for q in np.flatnonzero(tq <= span[0]):
            assert torch.equal(out[4][q], y0)
        if max_steps is None:
            for q in np.flatnonzero(tq > span[1]):
                assert torch.equal(out[4][q], out[0])
        else:
            assert torch.all(out[1] == 3)
            far = int(np.argmax(np.where(tq < span[1], tq, -np.inf)))
            assert torch.equal(out[4][far], out[0])


def _rkc_rows(name):
    """A RKC case's y_eval with the member axis first (B9 as one member)
    and its final y likewise."""
    out = _port(name)
    yq = out[_yq_at(name)]
    if CASES[name][0] == "rkc":
        return yq[None], out[0][None]
    return yq, out[0]


def _hermite_free(theta, h, y, f, y1, f1):
    """JAX's RKC _hermite (fused_rkc.py:98) in float32 numpy: theta not
    clamped, the terms summed in its order."""
    f32 = np.float32
    t2 = theta * theta
    t3 = t2 * theta
    return (((y * ((f32(2) * t3 - f32(3) * t2) + f32(1))
              + (h * ((t3 - f32(2) * t2) + theta)) * f)
             + y1 * (f32(3) * t2 - f32(2) * t3))
            + (h * (t3 - t2)) * f1)


@pytest.mark.parametrize("name", PENDING)
def test_rkc_pending_index(name):
    """JAX's pending index on points out of order and a NaN point: a point
    at or before t0 in first place takes y0 bit for bit; the points in
    order up to the first that lies behind an earlier one are written at
    the steps that reach them, and that one at the step after, within
    JAX's gate (tests/test_fused_pallas.py:291 holds the rows to 1e-4 of
    the f64 driver); the NaN point and every point after it (0.9, inside
    the span, and those behind it) take the final y bit for bit."""
    kind, _, span, y0, kw = spec(name)
    tq = kw["t_eval"]
    rows, yf = _rkc_rows(name)
    y0 = torch.tensor(y0)
    y0 = y0 if kind == "rkc_ens" else y0[None]
    nan_at = int(np.flatnonzero(np.isnan(tq))[0])
    assert tq[0] <= span[0]
    assert torch.equal(rows[:, 0], y0)
    for q in range(nan_at, len(tq)):
        assert torch.equal(rows[:, q], yf)
    # each point before the NaN lies within the span, not at its ends, so
    # its row is none of y0 and the final y
    for q in range(1, nan_at):
        assert not torch.equal(rows[:, q], yf)
        assert not torch.equal(rows[:, q], y0)


def test_rkc_rows_are_the_unclamped_hermite_of_the_step():
    """One accepted RKC step (``max_steps=1`` from ``first_step``) from (t0,
    y0, f0) of size h to (t0 + h, y1, f1): a point inside it, one behind
    t0 out of order (after a point inside) and one past it take, bit for
    bit, JAX's _hermite at theta = (tq - t0) / h unclamped (negative
    behind t0, above 1 past the step); the pending index stops at the
    first point past the step, whose row and those after it are y1."""
    h = np.float32(1e-3)
    tq = np.array([0.0, 5e-4, -1e-3, 2e-3, 2.5e-4], np.float32)
    fun = RHS["brus"]
    y0 = torch.tensor(Y0["brus"])
    out = solve_fused_rkc(fun, (0.0, 1.0), y0, RHO, rtol=1e-4, atol=1e-7,
                          first_step=float(h), max_steps=1, t_eval=tq)
    assert int(out[1]) == 3 and int(out[2]) == 1
    y1 = out[0].numpy()
    f0 = fun.torch_fn(torch.zeros(1), y0[..., None])[..., 0].numpy()
    f1 = fun.torch_fn(torch.full((1,), float(h)),
                      out[0][..., None])[..., 0].numpy()
    yq = out[4].numpy()
    np.testing.assert_array_equal(yq[0], Y0["brus"])
    for q in (1, 2):
        theta = np.float32(tq[q] / h)
        np.testing.assert_array_equal(
            yq[q], _hermite_free(theta, h, Y0["brus"], f0, y1, f1))
    for q in (3, 4):
        np.testing.assert_array_equal(yq[q], y1)


def test_swag_line_rows_are_the_straight_line():
    """The plain SWAG loop's near-end extrapolation rows (``Snapshots.line``,
    which no float32 run reaches; see the module docstring) against JAX's
    formula y + (tq - t) y' in float32: the points in (t, tf] of the
    members that extrapolate take the line, bit for bit; points at or
    before t, past tf, and those of members that do not extrapolate keep
    their rows."""
    rng = np.random.default_rng(7)
    n, nb = 3, 6
    tq = np.array([0.5, 0.999, 1.0, 1.25, 0.9995, 0.25], np.float32)
    t = np.full(nb, 0.999, np.float32)
    t[4] = 0.9999
    tf = torch.ones(nb)
    y = rng.standard_normal((n, nb)).astype(np.float32)
    yp = rng.standard_normal((n, nb)).astype(np.float32)
    snaps = Snapshots(tq, torch.tensor(y), 1.0)
    before = snaps.y.clone()
    upd = torch.tensor([True, True, False, True, True, True])
    snaps.line(upd, torch.tensor(t), tf, torch.tensor(y), torch.tensor(yp))
    for q, p in enumerate(tq):
        for b in range(nb):
            hit = bool(upd[b]) and p > t[b] and p <= 1.0
            want = (y[:, b] + (p - t[b]) * yp[:, b] if hit
                    else before[q, :, b].numpy())
            np.testing.assert_array_equal(snaps.y[q, :, b].numpy(), want)
    assert int((snaps.y != before).any(1).sum()) == 2 * 4 + 1


LINE_HOST = r"""
#include "snapshot.cuh"
extern "C" void line_rows(const float* tq, const int* idx, float* y_eval,
                          int nq, int members, int lanes, const float* t,
                          const float* tf, const float* y, const float* yp,
                          int* cursor) {
  const rk::Snap s{tq, idx, y_eval, nq, members};
  for (int m = 0; m < members; ++m) {
    float ym[3], ypm[3];
    for (int k = 0; k < 3; ++k) {
      ym[k] = y[k * members + m];
      ypm[k] = yp[k * members + m];
    }
    const rk::Cursor c = rk::cursor_at(s, s.past(0, 1.0f, t[m]));
    for (int r = 0; r < lanes; ++r) {
      const rk::Cursor e =
          lanes == 4 ? rk::snap_line<3, 4>(s, c, m, r, 1.0f, t[m], tf[m], ym,
                                           ypm)
                     : rk::snap_line<3, 1>(s, c, m, r, 1.0f, t[m], tf[m], ym,
                                           ypm);
      cursor[m] = e.q;
    }
  }
}
"""


@pytest.mark.parametrize("lanes", [1, 4])
def test_kernel_line_rows_match_plain_version(tmp_path, lanes):
    """The kernels' straight-line rows (``csrc/snapshot.cuh``: snap_line,
    line_row, compiled for the host with each operation rounded on its
    own) are the plain version's bit for bit, on one lane and split over
    four, and the cursor moves past the points up to tf."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA header for the host")
    from test_torch_csrc_host import SHIM
    from extensisq_tpu_torch.ops import _build
    import ctypes
    (tmp_path / "shim.h").write_text(SHIM)
    (tmp_path / "line.cpp").write_text(LINE_HOST)
    so = tmp_path / "line.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-include", str(tmp_path / "shim.h"),
                    "-I", str(_build.CSRC), "-o", str(so),
                    str(tmp_path / "line.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    rng = np.random.default_rng(11)
    nb = 5
    tq = np.array([0.25, 0.5, 0.999, 0.9995, 1.0, 1.0, 1.25], np.float32)
    t = np.array([0.999, 0.9, 0.9999, 0.999, 0.5], np.float32)
    tf = np.ones(nb, np.float32)
    y = rng.standard_normal((3, nb)).astype(np.float32)
    yp = rng.standard_normal((3, nb)).astype(np.float32)
    idx = np.arange(len(tq), dtype=np.int32)
    got = np.full((len(tq), nb, 3), np.nan, np.float32)
    cur = np.zeros(nb, np.int32)
    ptr = ctypes.c_void_p
    lib.line_rows(*(a.ctypes.data_as(ptr) for a in (tq, idx, got)),
                  len(tq), nb, lanes,
                  *(a.ctypes.data_as(ptr) for a in (t, tf, y, yp, cur)))
    snaps = Snapshots(tq, torch.tensor(y), 1.0)
    snaps.y[:] = float("nan")
    snaps.line(torch.ones(nb, dtype=torch.bool), torch.tensor(t),
               torch.tensor(tf), torch.tensor(y), torch.tensor(yp))
    want = snaps.y.permute(0, 2, 1).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    np.testing.assert_array_equal(cur, np.full(nb, 6))


def test_front_door_and_wrappers_on_cpu():
    """``ops.solve_fused`` routes SWAG and SSV2stab with ``t_eval`` to B3,
    B8, B9 and B10, and the wrappers on CPU tensors run the plain versions
    (no launch), bit for bit; an empty t_eval returns SWAG's four outputs
    and, as JAX's RKC kernels do, an empty y_eval."""
    from extensisq_tpu_torch import SSV2stab, SWAG
    for name in ("b3_params", "b8_heat", "b9_power", "b10_float"):
        kind, prob, span, y0, kw = spec(name)
        wrapper = WRAPPER[kind]
        before = wrapper.launches
        ref = _port(name)
        out = _port(name, fn=wrapper)
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        kw = dict(kw)
        if "params" in kw:
            kw["params"] = torch.tensor(kw["params"])
        method = SWAG if kind.startswith("adams") else SSV2stab
        if kind.startswith("rkc"):
            kw["ensemble"] = kind == "rkc_ens"
        front = solve_fused(RHS[prob], span, torch.tensor(y0), method=method,
                            **kw)
        for a, b in zip(front, ref):
            assert torch.equal(a, b)
        assert wrapper.launches == before
        empty = _port(name, fn=wrapper, t_eval=[], max_steps=1)
        if kind.startswith("adams"):
            assert len(empty) == 4
        else:
            at = _yq_at(name)
            assert len(empty) == at + 1
            assert empty[at].shape == ((0,) + tuple(y0.shape)
                                       if kind == "rkc"
                                       else (y0.shape[0], 0)
                                       + tuple(y0.shape[1:]))


@pytest.mark.parametrize("solve_fn", [solve_fused_adams,
                                      solve_fused_adams_grid,
                                      solve_fused_rkc,
                                      solve_fused_rkc_ensemble])
def test_events_still_raise(solve_fn):
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        solve_fn(lambda t, y: -y, (0.0, 1.0), torch.ones(4, 2),
                 events=lambda t, y: y)


def test_generated_headers_carry_the_switch():
    """The generated headers of B3, B8 and of B9/B10 carry tab::SNAP where
    asked."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_adams import _adams_consts
    for snap in (False, True):
        flag = f"constexpr bool SNAP = {'true' if snap else 'false'};"
        assert flag in _build.fused_adams_header(
            _adams_consts(4, 2), RHS["vdp5"].cuda_src, None, 0, False, snap)
        assert flag in _build.fused_adams_header(
            _adams_consts(4, N_GRID), RHS["heat"].cuda_src, (N_GRID,), 0,
            False, snap)
        brus = RHS["brus"]
        assert flag in _build.fused_rkc_header(brus.shape, 0, brus.cuda_src,
                                               None, snap)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# each kernel with snapshots against its plain version on the card: (max
# |dy|, max |dy_eval|) over the finished members.  nvcc's contraction moves
# the last bits of h, so a SWAG member may take other steps and its rows
# then come from other cubic Hermites; the RKC kernels sum their norms in
# the launch's order, and the pending cases' points behind a later one
# carry that amplified (theta ~-3).  Measured on an H100 (NVIDIA H100 80GB
# HBM3, 700 W; the largest over the shapes): b3_vdp 5.2e-5, 5.2e-5;
# b3_vdp_comp 8.6e-7, 8.6e-7; b3_params 6.3e-5, 6.3e-5; b3_dense 1.2e-7,
# 2.4e-7; b8_heat 1.8e-7, 1.8e-7; b8_params 4.2e-7, 7.2e-7; b8_dense
# 1.8e-7, 2.4e-7; b9_float 1.4e-6, 1.7e-6; b9_power 1.9e-6, 1.9e-6;
# b9_pending 1.4e-6, 8.3e-5; b10_float 3.0e-6, 3.3e-6; b10_power 1.0e-5,
# 1.0e-5; b10_pending 3.0e-6, 1.0e-4.  Gates about 3x
CARD_GATES = {"b3_vdp": (1.6e-4, 1.6e-4), "b3_vdp_comp": (2.6e-6, 2.6e-6),
              "b3_params": (2e-4, 2e-4), "b3_dense": (4e-7, 8e-7),
              "b8_heat": (6e-7, 6e-7), "b8_params": (1.3e-6, 2.2e-6),
              "b8_dense": (6e-7, 8e-7), "b9_float": (4.5e-6, 5e-6),
              "b9_power": (6e-6, 6e-6), "b9_pending": (4.5e-6, 2.5e-4),
              "b10_float": (9e-6, 1e-5), "b10_power": (3.1e-5, 3.1e-5),
              "b10_pending": (9e-6, 3e-4)}
# one attempt on the card against the plain version: only nvcc's
# contraction parts them
CARD_FIRST_GATE = 1e-6


def _card_shapes(kind):
    """Every shape the kind's rule can take: B3's lanes (1, 8, 16, 32), B8's
    one block, B9's two placements, B10's block (C = 1) and each cluster
    size the card holds at the grid."""
    from extensisq_tpu_torch.ops import fused_rkc as FR
    if kind == "adams":
        return [1, 8, 16, 32]
    if kind == "adams_grid":
        return [None]
    if kind == "rkc":
        return [FR.SHARED, FR.GLOBAL]
    return [1, *FR.CLUSTER_SIZES]


def _card_launch(name, shape, device, snap=True, **over):
    """A case forced to ``shape`` on the card (a comparison launch, not
    counted), with its points (without ``snap``: the build without the
    snapshots, no points) and the options ``over``; returns the outputs
    (None for a cluster size the card does not hold)."""
    from extensisq_tpu_torch.ops import fused_adams as FA
    from extensisq_tpu_torch.ops import fused_adams_grid as FAG
    from extensisq_tpu_torch.ops import fused_rkc as FR
    kind, prob, span, y0, kw = spec(name)
    fun = RHS[prob]
    y0 = torch.tensor(y0, device=device)
    kw = dict(kw, **over)
    if "params" in kw:
        kw["params"] = torch.tensor(kw["params"], device=device)
    tq = kw.pop("t_eval") if snap else None
    kw.pop("t_eval", None)
    kw.pop("dense", None)
    if kind == "adams":
        return FA._launch(fun, span, y0, kw["rtol"], kw["atol"],
                          kw.get("first_step"), kw["k_max"],
                          kw.get("max_steps", 200_000),
                          kw.get("compensated", False), None, shape, None,
                          kw.get("params"), None, tq)[0]
    if kind == "adams_grid":
        built = FAG._kernel(fun, kw["k_max"], False, tq is not None)
        kw.setdefault("max_steps", 200_000)
        return FAG._launch(built, fun, span, y0, max_step=None, t_eval=tq,
                           **kw)
    rho = kw.pop("rho")
    if kind == "rkc":
        out, _ = FR._launch_grid(fun, span, y0, rho, shape, t_eval=tq, **kw)
        return out
    if shape > 1:
        built = FR._kernel(fun, rho, 1, tq is not None)
        if not FR._max_clusters(built, rho, y0.device).get(shape, 0):
            return None
    params = kw.pop("params")
    out, _ = FR._launch_ensemble(fun, span, y0, rho, params, shape,
                                 t_eval=tq, **kw)
    return out


def _finished_err(a, b, ok, axis):
    """max |a - b| over the finished members (``ok``), their axis of a and
    b at ``axis``."""
    if not bool(ok.any()):
        return 0.0
    idx = ok.nonzero()[:, 0]
    return float((a.index_select(axis, idx)
                  - b.index_select(axis, idx)).abs().max())


def _member_axis(name):
    return 0 if CASES[name][0] == "rkc_ens" else 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_y_eval_matches_plain_version_on_card(cuda, name):
    """Each kernel's snapshot build through its wrapper (one launch)
    against its plain version on the card: status identical, y and y_eval
    within the card gates."""
    kind = CASES[name][0]
    wrapper = WRAPPER[kind]
    before = wrapper.launches
    k = _port(name, fn=wrapper, device=cuda)
    assert wrapper.launches == before + 1
    r = _port(name, device=cuda)
    torch.cuda.synchronize()
    at = _yq_at(name)
    assert len(k) == len(r) and torch.equal(k[1], r[1])
    if kind == "rkc":
        dy = float((k[0] - r[0]).abs().max())
        dq = float((k[at] - r[at]).abs().max())
    else:
        ok = r[1] == 1
        dy = float((k[0][ok] - r[0][ok]).abs().max())
        dq = _finished_err(k[at], r[at], ok, _member_axis(name))
    print(f"{name}: max |dy| {dy:.3e}, max |dy_eval| {dq:.3e}")
    assert dy <= CARD_GATES[name][0] and dq <= CARD_GATES[name][1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_snapshot_build_bit_for_bit_at_every_shape_on_card(cuda, name):
    """At every shape the kind's rule can take, the snapshot build's other
    outputs are the build without it bit for bit, and its y_eval lies
    within the card gate of the plain version's.  Comparison launches are
    not counted, but for B8's, whose launch helper counts each."""
    kind = CASES[name][0]
    r = _port(name, device=cuda)
    at = _yq_at(name)
    wrapper = WRAPPER[kind]
    before = wrapper.launches
    taken = 0
    for shape in _card_shapes(kind):
        on = _card_launch(name, shape, cuda)
        off = _card_launch(name, shape, cuda, snap=False)
        if on is None:
            continue
        taken += 1
        assert len(on) == len(off) + 1
        for a, b in zip(on, off):
            assert torch.equal(a, b), shape
        yq = on[-1]
        if kind == "rkc":
            dq = float((yq - r[at]).abs().max())
        else:
            dq = _finished_err(yq, r[at], r[1] == 1, _member_axis(name))
        print(f"{name} at {shape}: max |dy_eval| {dq:.3e}")
        assert dq <= CARD_GATES[name][1]
    assert taken >= 2 or kind == "adams_grid"
    assert wrapper.launches == before + (2 * taken if kind == "adams_grid"
                                         else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", FIRST)
def test_first_attempt_rows_on_card(cuda, name):
    """One attempt of every member with points inside its first step,
    before t0 and past it: the kernel's outputs and rows against the plain
    version's, the counts equal, y and y_eval within CARD_FIRST_GATE."""
    k = _port(name, fn=WRAPPER[CASES[name][0]], device=cuda)
    r = _port(name, device=cuda)
    for a, b in zip(k[1:4], r[1:4]):
        assert torch.equal(a, b)
    d = max(float((k[0] - r[0]).abs().max()),
            float((k[4] - r[4]).abs().max()))
    print(f"{name}: max |dy| and |dy_eval| {d:.3e}")
    assert d <= CARD_FIRST_GATE
