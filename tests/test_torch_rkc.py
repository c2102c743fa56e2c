"""The port's SSV2stab family (f64 driver) against the JAX package, and the
entry points' device default.

Both packages integrate the same seeded members on the CPU: the Dirichlet
heat problem of ``tests/test_rkc.py`` with the power iteration, with a
``rho_jac`` bound and with ``const_jac``; the pinned case of
``test_maxm_counts_rejected_attempts`` ((nsteps, nfailed, nfev) = (6, 1,
221), maxm 76, nfesig 9); the heat problem run backward (the sign-flipped
right-hand side from t = 0.1 to 0); and a 2x16x16 Brusselator whose
parameter B is per member (``params_batch``).  The JAX side runs in one
subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, so that XLA, like
PyTorch's CPU operations, rounds every product on its own (ROADMAP C).
Status, nsteps, nfev, nfailed, nfesig and maxm are identical per member;
the endpoints agree within 1e-10.

The power-iteration heat members start from ``tests/test_rkc.py``'s
smooth y0 plus a seeded perturbation of 1e-2 in every component.  From
the smooth y0 alone the power iteration never sees the high modes (its
estimate, ~300, is far below the true ~17,000, so m = 2), and the run sits
at the edge of stability, where the controller amplifies the last bit of
every norm, sqrt and pow by ~1e3 per attempt; XLA and PyTorch round those
differently (XLA sums in windows of 32 and computes ``a / sqrt(b)`` as
``a * rsqrt(b)``, and its f64 ``pow`` rounds some inputs otherwise than
PyTorch's), so such runs part after a few attempts.  The perturbation lets
the estimate find the true radius, and the counts then match exactly.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import (SSV2stab, METHODS_BY_NAME, ops, solve,
                                 solve_ensemble)
from extensisq_tpu_torch.steppers import build_stepper
from extensisq_tpu_torch.steppers.rkc import RKCStepper
from extensisq_tpu_torch.types import IVPParams

REPO = Path(__file__).resolve().parents[1]
COUNTERS = ("status", "nsteps", "nfev", "nfailed", "nfesig", "maxm")
N = 64
SHAPE = (16, 16)


def heat(t, y):
    yp = torch.nn.functional.pad(y, (0, 0, 1, 1))
    return (yp[:-2] - 2.0 * y + yp[2:]) * (N + 1) ** 2


def heat_back(t, y):
    return -heat(t, y)


def brus_p(t, y, b):
    ny, nx = SHAPE
    uv = y.reshape(2, ny, nx, -1)
    lap = (torch.roll(uv, 1, 1) + torch.roll(uv, -1, 1)
           + torch.roll(uv, 1, 2) + torch.roll(uv, -1, 2) - 4.0 * uv) * nx**2
    u, v = uv[0], uv[1]
    uv2 = u * u * v
    du = 1.0 + uv2 - (b + 1.0) * u + 0.02 * lap[0]
    dv = b * u - uv2 + 0.02 * lap[1]
    return torch.cat([du.reshape(ny * nx, -1), dv.reshape(ny * nx, -1)])


PROBLEMS = {"heat": heat, "heat_back": heat_back, "brus_p": brus_p}


def _heat0(amp):
    x = np.linspace(1 / (N + 1), N / (N + 1), N)
    return (np.asarray(amp)[:, None] * np.sin(np.pi * x)
            + 0.5 * np.sin(5 * np.pi * x))


def _inputs():
    rng = np.random.default_rng(4)
    x = np.linspace(1 / (N + 1), N / (N + 1), N)
    heat0 = _heat0(HEAT_AMPS)
    ny, nx = SHAPE
    xg, yg = np.meshgrid(np.linspace(0, 1, nx, endpoint=False),
                         np.linspace(0, 1, ny, endpoint=False))
    u0 = 1.0 + 0.5 * np.sin(2 * np.pi * xg) * np.sin(2 * np.pi * yg)
    v0 = 3.0 + 0.1 * np.cos(2 * np.pi * xg)
    base = np.concatenate([u0.ravel(), v0.ravel()])
    brus0 = base * rng.uniform(0.97, 1.03, (3, 1))
    rough = heat0 + 0.01 * rng.uniform(-1.0, 1.0, heat0.shape)
    return x, heat0, brus0, rough


# the heat members: amplitudes of sin(pi x) (1.0 is tests/test_rkc.py's
# y0)
HEAT_AMPS = [0.85, 0.95, 1.0, 1.1, 1.15]
X_GRID, HEAT0, BRUS0, HEAT_ROUGH = _inputs()
RHO_HEAT = 4.0 * (N + 1) ** 2
BS = np.linspace(2.8, 3.4, 3)
# name -> (problem, span, y0, options, params_batch)
CASES = {
    "heat_power": ("heat", (0.0, 0.1), HEAT_ROUGH,
                   dict(rtol=1e-4, atol=1e-7), None),
    "heat_rho_jac": ("heat", (0.0, 0.1), HEAT0,
                     dict(rtol=1e-4, atol=1e-7, rho_jac="heat"), None),
    "heat_const_jac": ("heat", (0.0, 0.1), HEAT_ROUGH,
                       dict(rtol=1e-4, atol=1e-7, const_jac=True), None),
    "pinned": ("heat", (0.0, 0.5), np.sin(np.pi * X_GRID)[None],
               dict(rtol=1e-1, atol=1e-1), None),
    "heat_backward": ("heat_back", (0.1, 0.0), HEAT0,
                      dict(rtol=1e-4, atol=1e-7, rho_jac="heat"), None),
    "heat_power_backward": ("heat_back", (0.1, 0.0), HEAT_ROUGH,
                            dict(rtol=1e-4, atol=1e-7), None),
    "brusselator_params": ("brus_p", (0.0, 1.0), BRUS0,
                           dict(rtol=1e-4, atol=1e-7), BS),
}
RHO = {"heat": lambda t, y: RHO_HEAT}
_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.solve import solve, solve_ensemble

    N = 64
    NY, NX = 16, 16

    def heat(t, y):
        yp = jnp.pad(y, 1)
        return (yp[:-2] - 2.0 * y + yp[2:]) * (N + 1) ** 2

    def heat_back(t, y):
        return -heat(t, y)

    def brus_p(t, y, b):
        uv = y.reshape(2, NY, NX)
        lap = (jnp.roll(uv, 1, 1) + jnp.roll(uv, -1, 1)
               + jnp.roll(uv, 1, 2) + jnp.roll(uv, -1, 2) - 4.0 * uv) \\
            * NX**2
        u, v = uv[0], uv[1]
        uv2 = u * u * v
        du = 1.0 + uv2 - (b + 1.0) * u + 0.02 * lap[0]
        dv = b * u - uv2 + 0.02 * lap[1]
        return jnp.concatenate([du.reshape(-1), dv.reshape(-1)])

    problems = {"heat": heat, "heat_back": heat_back, "brus_p": brus_p}
    rho = {"heat": lambda t, y: 4.0 * (N + 1) ** 2}
    inputs = np.load(sys.argv[1])
    out = {}
    for name, (prob, span, kw, has_p) in json.loads(sys.argv[2]).items():
        if "rho_jac" in kw:
            kw["rho_jac"] = rho[kw["rho_jac"]]
        y0 = jnp.asarray(inputs[name + "/y0"])
        pb = jnp.asarray(inputs[name + "/p"]) if has_p else None
        res = jax.jit(lambda Y, P: solve_ensemble(
            problems[prob], tuple(span), Y, params_batch=P,
            method=X.SSV2stab, **kw))(y0, pb)
        for f in ("status", "nsteps", "nfev", "nfailed", "nfesig", "maxm",
                  "y"):
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
    # the pinned case through the single-system solve as well
    one = solve(heat, (0.0, 0.5), jnp.asarray(inputs["pinned/y0"][0]),
                method=X.SSV2stab, rtol=1e-1, atol=1e-1)
    for f in ("status", "nsteps", "nfev", "nfailed", "nfesig", "maxm"):
        out["one/" + f] = np.asarray(getattr(one, f))
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX package's results for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_rkc")
    arrays, spec = {}, {}
    for name, (prob, span, y0, kw, pb) in CASES.items():
        arrays[name + "/y0"] = y0
        if pb is not None:
            arrays[name + "/p"] = pb
        spec[name] = [prob, span, kw, pb is not None]
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=600)
    return dict(np.load(d / "out.npz"))


def _port(name):
    prob, span, y0, kw, pb = CASES[name]
    kw = dict(kw)
    if "rho_jac" in kw:
        kw["rho_jac"] = RHO[kw["rho_jac"]]
    return solve_ensemble(PROBLEMS[prob], span, torch.tensor(y0),
                          params_batch=None if pb is None
                          else torch.tensor(pb), method=SSV2stab, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_ensemble_matches_jax(jax_results, name):
    """Identical status, nsteps, nfev, nfailed, nfesig and maxm per member;
    endpoints within 1e-10."""
    port = _port(name)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      jax_results[f"{name}/{f}"], err_msg=f)
    assert np.all(port.status.numpy() == 1)
    assert np.max(np.abs(port.y.numpy() - jax_results[f"{name}/y"])) <= 1e-10


def test_pinned_counts(jax_results):
    """tests/test_rkc.py:83-103: the rejected attempt runs m = 76 stages,
    which no accepted step reaches; maxm counts it.  The single-system
    ``solve`` gives the same counts as the JAX ``solve``."""
    y0 = torch.tensor(CASES["pinned"][2][0])
    out = solve(heat, (0.0, 0.5), y0, method=SSV2stab, rtol=1e-1, atol=1e-1)
    assert (int(out.nsteps), int(out.nfailed), int(out.nfev)) == (6, 1, 221)
    assert int(out.maxm) == 76 and int(out.nfesig) == 9
    for f in COUNTERS:
        assert int(getattr(out, f)) == int(jax_results["one/" + f]), f


def test_heat_accuracy():
    """tests/test_rkc.py:36-48 and :64-70: within 1e-4 of the exact
    solution of the discrete system, with the power iteration and with
    const_jac."""
    lam = [-4.0 * (N + 1) ** 2 * np.sin(k * np.pi / (2 * (N + 1))) ** 2
           for k in (1, 5)]
    y0 = np.sin(np.pi * X_GRID) + 0.5 * np.sin(5 * np.pi * X_GRID)
    exact = (np.sin(np.pi * X_GRID) * np.exp(lam[0] * 0.1)
             + 0.5 * np.sin(5 * np.pi * X_GRID) * np.exp(lam[1] * 0.1))
    out = solve(heat, (0.0, 0.1), torch.tensor(y0), method="SSV2stab",
                rtol=1e-4, atol=1e-7)
    assert int(out.status) == 1 and int(out.nsteps) < 80
    assert int(out.nfev) < 500
    assert np.max(np.abs(out.y.numpy() - exact)) < 1e-4
    out = solve(heat, (0.0, 0.1), torch.tensor(y0), method="SSV2stab",
                rtol=1e-4, atol=1e-7, const_jac=True)
    assert int(out.status) == 1
    assert np.max(np.abs(out.y.numpy() - exact)) < 1e-4


def test_step_advances_one_accepted_step():
    """``step`` repeats attempts per member until each is accepted: nsteps
    moves by one per call, and the counts are those of step_flat."""
    stepper = build_stepper(SSV2stab, heat, N, torch.float64)
    params = IVPParams(t_bound=0.5, direction=1.0, rtol=1e-1, atol=1e-1,
                       max_step=np.inf)
    y = torch.tensor(HEAT0).T.contiguous()
    state = stepper.init(0.0, y, params)
    flat = stepper.init(0.0, y, params)
    for k in range(1, 4):
        state = stepper.step(params, state)
        assert torch.all(state.nsteps == k)
    while bool((flat.nsteps < 3).any()):
        new, _, _ = stepper.step_flat(params, flat, ())
        run = flat.nsteps < 3
        flat = type(flat)(*[torch.where(run, a, b) for a, b in
                            zip(new, flat)])
    for f in ("t", "y", "h_abs", "nfev", "nfesig", "nfailed", "maxm"):
        assert torch.equal(getattr(state, f), getattr(flat, f)), f


def test_float32_stepper_runs():
    out = solve(heat, (0.0, 0.1), torch.tensor(HEAT0[0], dtype=torch.float32),
                method=SSV2stab, rtol=1e-3, atol=1e-6)
    assert int(out.status) == 1 and out.y.dtype == torch.float32


def test_registry_and_unported_parts():
    assert METHODS_BY_NAME["SSV2stab"] is SSV2stab
    assert SSV2stab.family == "rkc"
    stepper = RKCStepper(heat, N, torch.float64)
    params = IVPParams(t_bound=1.0, direction=1.0, rtol=1e-4, atol=1e-7,
                       max_step=np.inf)
    state = stepper.init(0.0, torch.tensor(HEAT0[:1]).T.contiguous(), params)
    # dense output is ported (tests/test_torch_dense.py): the cubic
    # Hermite over t - t_old, zero before the first step
    (t_a, h, ya, Q), = stepper.dense_segments(state)[0]
    assert Q.shape == (N, 3, 1) and torch.equal(
        Q, stepper.record_coefficients(state)) and not Q.any()
    with pytest.raises(ValueError, match="complex"):
        solve(lambda t, y: -y, (0.0, 1.0), torch.tensor([1j]),
              method=SSV2stab)


# -- the device default: numpy and lists go to the card ---------------------

def _entry_points():
    rhs = ops.FusedRHS(lambda t, y: -y, "", 1)
    grid = ops.FusedGridRHS(lambda t, y, p=None: -y, "", (2, 4))
    y1 = np.ones((4, 1), np.float32)
    yg = np.ones((2, 4), np.float32)
    return {
        "solve": lambda y: solve(lambda t, z: -z, (0.0, 1.0), y[0]),
        "solve_ensemble": lambda y: solve_ensemble(lambda t, z: -z,
                                                   (0.0, 1.0), y),
        "solve_fused_erk": lambda y: ops.solve_fused_erk(rhs, (0.0, 1.0), y),
        "solve_fused_esdirk": lambda y: ops.solve_fused_esdirk(
            rhs, (0.0, 1.0), y),
        "solve_fused_adams": lambda y: ops.solve_fused_adams(
            rhs, (0.0, 1.0), y),
        "solve_fused_rkc": lambda y: ops.solve_fused_rkc(
            grid, (0.0, 1.0), yg if isinstance(y, np.ndarray)
            else torch.tensor(yg), 10.0),
        "solve_fused_rkc_ensemble": lambda y: ops.solve_fused_rkc_ensemble(
            grid, (0.0, 1.0), yg[None] if isinstance(y, np.ndarray)
            else torch.tensor(yg[None]), 10.0),
    }, y1


@pytest.mark.parametrize("entry", ["solve", "solve_ensemble",
                                   "solve_fused_erk", "solve_fused_esdirk",
                                   "solve_fused_adams", "solve_fused_rkc",
                                   "solve_fused_rkc_ensemble"])
def test_numpy_input_needs_the_card(monkeypatch, entry):
    """A numpy ``y0`` runs on the card; with no card it raises instead of
    running on the CPU.  A CPU tensor still runs on the CPU."""
    calls, y1 = _entry_points()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry](y1)
    out = calls[entry](torch.tensor(y1))
    status = out.status if hasattr(out, "status") else out[1]
    assert torch.all(status == 1) and status.device.type == "cpu"
