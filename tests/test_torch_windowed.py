"""``solve_windowed``: warm-started windows bit for bit the single-shot
solve, in the port, and with the JAX package's windowed counts.

BS5, SWAG, Kv3I and SSV2stab integrate seeded ensembles (Van der Pol
members with per-member mu, a perturbed heat MoL for SSV2stab) forward and
backward, in one call and in windows.  The windowed final state and every
counter must equal the single-shot ones exactly, and so must the stepper
memory carried across the boundaries (SWAG's phi history, SSV2stab's
eigenvector, ESDIRK's Jacobian and LU).  JAX's ``solve_windowed`` runs the
same cases in two subprocesses with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``
(no FMA); its counters must equal the port's and its endpoints agree
within the f64 gate, 1e-10 relative to max(1, |y|).
"""
import functools
import textwrap

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import solve, solve_ensemble, solve_windowed
from extensisq_tpu_torch._config import PAUSED
from jax_reference import run_jax

COUNTERS = ("status", "nsteps", "nfev", "nfailed")
GATE = 1e-10
N_HEAT = 16


def vdp_p(t, y, mu):
    return torch.stack([y[1], mu[0] * (1 - y[0] ** 2) * y[1] - y[0]])


def heat(t, y, s):
    yp = torch.nn.functional.pad(y, (0, 0, 1, 1))
    return s[0] * (yp[:-2] - 2.0 * y + yp[2:]) * (N_HEAT + 1) ** 2


_RNG = np.random.default_rng(9)
VDP_FWD = np.stack([_RNG.uniform(1.5, 2.5, 6), _RNG.uniform(-1, 1, 6)], 1)
# backward in time the limit cycle repels: start inside it
VDP_BWD = np.stack([_RNG.uniform(0.5, 1.5, 6), _RNG.uniform(-.5, .5, 6)], 1)
MUS = np.linspace(1.0, 4.0, 6)
_X = np.linspace(1 / (N_HEAT + 1), N_HEAT / (N_HEAT + 1), N_HEAT)
HEAT0 = (np.stack([np.sin(np.pi * _X) * a for a in (0.9, 1.0, 1.1)])
         + 0.01 * _RNG.uniform(-1.0, 1.0, (3, N_HEAT)))
# the backward heat case runs -heat from t = 0.1 down to 0
SIGN = {True: np.ones(3), False: -np.ones(3)}

# name -> (problem, method, span, y0, params, n_windows, options)
CASES = {}
for fwd in (True, False):
    tag = "forward" if fwd else "backward"
    y0 = VDP_FWD if fwd else VDP_BWD
    for method, T, kw in (("BS5", 8.0, dict(rtol=1e-7, atol=1e-9)),
                          ("SWAG", 8.0, dict(rtol=1e-7, atol=1e-9, k_max=6)),
                          ("Kv3I", 2.0, dict(rtol=1e-5, atol=1e-8))):
        span = (0.0, T) if fwd else (T, 0.0)
        CASES[f"{method}-{tag}"] = ("vdp", method, span, y0, MUS, 4, kw)
    CASES[f"SSV2stab-{tag}"] = (
        "heat", "SSV2stab", (0.0, 0.1) if fwd else (0.1, 0.0), HEAT0,
        SIGN[fwd], 3, dict(rtol=1e-4, atol=1e-7))
PROBLEMS = {"vdp": vdp_p, "heat": heat}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X

    N = %d
    def heat(t, y, s):
        yp = jnp.pad(y, (1, 1))
        return s * (yp[:-2] - 2.0 * y + yp[2:]) * (N + 1) ** 2
    problems = {
        "vdp": lambda t, y, mu: jnp.stack(
            [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]),
        "heat": heat,
    }
    inputs = np.load(sys.argv[1])
    out = {}
    for name, c in json.loads(sys.argv[2]).items():
        # a function object of its own: solve_windowed's runner cache
        # keys on the function, not on t_span's end, which it captures
        f = problems[c["problem"]]
        res = X.solve_windowed(
            lambda t, y, p, f=f: f(t, y, p), tuple(c["span"]),
            jnp.asarray(inputs[name + "/y0"]), c["n_windows"],
            method=getattr(X, c["method"]), ensemble=True,
            params_batch=jnp.asarray(inputs[name + "/p"]), **c["kw"])
        for f in ("t", "y", "status", "nsteps", "nfev", "nfailed"):
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
    np.savez(sys.argv[3], **out)
""" % N_HEAT)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """JAX ``solve_windowed`` on every case, from two subprocesses without
    FMA (the port's runs meanwhile)."""
    d = tmp_path_factory.mktemp("jax_windowed")
    arrays = {}
    for k, v in CASES.items():
        arrays[k + "/y0"], arrays[k + "/p"] = v[3], v[4]
    np.savez(d / "in.npz", **arrays)
    spec = {k: dict(problem=v[0], method=v[1], span=list(v[2]),
                    n_windows=v[5], kw=v[6]) for k, v in CASES.items()}
    names = list(CASES)
    warm = [lambda k=k, w=w: _run(k, w) for k in names for w in (True, False)]
    return run_jax(_JAX_SCRIPT, d, [{k: spec[k] for k in names[i::2]}
                                    for i in range(2)], warm)


@functools.lru_cache(maxsize=None)
def _run(name, windows):
    prob, method, span, y0, p, n_windows, kw = CASES[name]
    args = (PROBLEMS[prob], span, torch.tensor(y0))
    pb = torch.tensor(p)[:, None]
    if windows:
        return solve_windowed(*args, n_windows, method=method, ensemble=True,
                              params_batch=pb, **kw)
    return solve_ensemble(*args, params_batch=pb, method=method, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_windowed_is_single_shot_bit_for_bit(jax_results, name):
    win, one = _run(name, True), _run(name, False)
    assert torch.all(one.status == 1)
    for f in ("t", "y") + COUNTERS:
        assert torch.equal(getattr(win, f), getattr(one, f)), f
    assert win.final_state is None
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(win, f).numpy(),
                                      jax_results[f"{name}/{f}"], err_msg=f)
    y_ref = jax_results[f"{name}/y"]
    assert np.max(np.abs(win.y.numpy() - y_ref)
                  / np.maximum(1.0, np.abs(y_ref))) <= GATE


@pytest.mark.parametrize("name", ["SWAG-forward", "Kv3I-backward",
                                  "SSV2stab-forward"])
def test_carried_stepper_memory_is_single_shot(name):
    """Window by window through pause_at/resume_state: every field of the
    stepper state (phi, the eigenvector V, J and LU) equals the
    single-shot run's at the end, and each window ends PAUSED."""
    prob, method, span, y0, p, n_windows, kw = CASES[name]
    fun, y0 = PROBLEMS[prob], torch.tensor(y0)
    pb = torch.tensor(p)[:, None]
    edges = np.linspace(span[0], span[1], n_windows + 1)
    st = None
    for a, b in zip(edges[:-1], edges[1:]):
        out = solve_ensemble(fun, (a, span[1]), y0, params_batch=pb,
                             method=method, pause_at=b, resume_state=st,
                             return_state=True, **kw)
        st = out.final_state
        if b != span[1]:
            assert torch.all(out.status == PAUSED)
    ref = solve_ensemble(fun, span, y0, params_batch=pb, method=method,
                         return_state=True, **kw).final_state
    assert type(st) is type(ref)
    for f, x, y in zip(ref._fields, st, ref):
        assert torch.equal(x, y), f


def test_windowed_refusals_and_single_member():
    """The JAX refusals; a single member with a per-member parameter; an
    early exit on a failing window; max_steps budgets each window."""
    y0 = torch.tensor(VDP_FWD[0])
    fun = vdp_p
    for kw in ({"save_steps": True}, {"t_eval": [0.5]},
               {"events": lambda t, y: y[0]}):
        with pytest.raises(ValueError, match="solve_windowed"):
            solve_windowed(fun, (0.0, 1.0), y0, 2, method="BS5",
                           params_batch=torch.tensor([2.0]), **kw)
    win = solve_windowed(fun, (0.0, 8.0), y0, 4, method="BS5",
                         params_batch=torch.tensor([2.0]), rtol=1e-7,
                         atol=1e-9)
    one = solve(lambda t, y: fun(t, y, torch.tensor([2.0])), (0.0, 8.0), y0,
                method="BS5", rtol=1e-7, atol=1e-9)
    for f in ("t", "y") + COUNTERS:
        assert torch.equal(getattr(win, f), getattr(one, f)), f
    # a cap that the first window hits: status 4 and no further window
    cap = solve_windowed(fun, (0.0, 8.0), y0, 4, method="BS5",
                         params_batch=torch.tensor([2.0]), max_steps=5)
    assert int(cap.status) == 4 and int(cap.nsteps) == 5
    assert float(cap.t) < 2.0
    # each window gets its own budget of max_steps
    part = solve_windowed(fun, (0.0, 8.0), y0, 4, method="BS5",
                          params_batch=torch.tensor([2.0]),
                          max_steps=int(one.nsteps) // 2, rtol=1e-7,
                          atol=1e-9)
    assert int(part.status) == 1 and torch.equal(part.y, one.y)
