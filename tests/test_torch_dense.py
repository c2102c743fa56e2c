"""The port's dense output and trajectory record against the JAX package.

``core/interpolate.py`` is held function by function against the JAX
module on seeded inputs (round-off gate 1e-13).  Then one method of each
family (BS5, Fi5N, Kv3I, SWAG, SSV2stab, CKdisc, and HS2I for the
piecewise cubic of the HS methods) integrates seeded members with
``t_eval`` and ``save_steps`` in both packages on the CPU; JAX runs in two
subprocesses with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no FMA), as the
SWAG, CKdisc and ESDIRK driver tests do.  The work counters must be
identical per member; ``y``, ``ys``, ``y_eval``, ``ode_solution()`` at
off-grid times and every stepper's ``dense_segments`` of the last step
agree within 1e-10 relative to max(1, |y|), the families' f64 endpoint
gate (XLA's f64 ``pow`` in the starting step puts the two trajectories
~1e-10 apart on the way, on values up to 2).
"""
import functools
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extensisq_tpu.core import interpolate as JI
from jax_reference import run_jax

import extensisq_tpu_torch as P
from extensisq_tpu_torch import solve, solve_ensemble
from extensisq_tpu_torch.core import interpolate as PI
from extensisq_tpu_torch.steppers import build_stepper

COUNTERS = ("status", "nsteps", "nfev", "nfailed")
GATE = 1e-10
ROUND = 1e-13
N_HEAT = 16
MAX_STEPS = 1500


def vdp(t, y):
    return torch.stack([y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def kepler(t, y):
    r2 = y[0] ** 2 + y[1] ** 2
    a = -r2 ** -1.5
    return torch.stack([y[2], y[3], a * y[0], a * y[1]])


def heat(t, y):
    yp = torch.nn.functional.pad(y, (0, 0, 1, 1))
    return (yp[:-2] - 2.0 * y + yp[2:]) * (N_HEAT + 1) ** 2


def f_disc(t, y):
    return torch.stack([torch.where(t < 5.0, 1.0, -1.0) * y[0] - y[1],
                        y[0] * 0.1 + torch.where(t < 5.0, 0.5, -2.0)])


PROBLEMS = {"vdp": vdp, "kepler": kepler, "heat": heat, "f_disc": f_disc}

_RNG = np.random.default_rng(16)
VDP0 = np.stack([_RNG.uniform(1.5, 2.5, 4), _RNG.uniform(-1, 1, 4)], 1)
ECC = np.array([0.1, 0.3, 0.5])
KEPLER0 = np.stack([1 - ECC, 0 * ECC, 0 * ECC, np.sqrt((1 + ECC)
                                                        / (1 - ECC))], 1)
_X = np.linspace(1 / (N_HEAT + 1), N_HEAT / (N_HEAT + 1), N_HEAT)
# perturbed, as in tests/test_torch_rkc.py: from a smooth start the power
# iteration sits at the edge of stability and amplifies XLA's last bits
HEAT0 = np.stack([np.sin(np.pi * _X) + a * np.sin(3 * np.pi * _X)
                  for a in (0.1, 0.3, 0.5)]) + 0.01 * _RNG.uniform(
                      -1.0, 1.0, (3, N_HEAT))
F_DISC0 = np.array([[1.0, 0.0], [1.01, 0.0], [1.03, 0.0]])

# name -> (problem, method, span, y0, options, dense_segments names)
CASES = {
    "BS5": ("vdp", "BS5", (0.0, 5.0), VDP0, dict(rtol=1e-6, atol=1e-9),
            [None, "low", "best"]),
    "BS5_back": ("vdp", "BS5", (3.0, 0.0), 0.5 * VDP0,
                 dict(rtol=1e-6, atol=1e-9), [None]),
    # a first step: XLA's f64 pow in h_start puts the Kepler step grids
    # 2.5e-9 apart (bit for bit with it given)
    "Fi5N": ("kepler", "Fi5N", (0.0, 2 * np.pi), KEPLER0,
             dict(rtol=1e-8, atol=1e-11, first_step=0.01), [None, 1]),
    "Kv3I": ("vdp", "Kv3I", (0.0, 1.5), VDP0, dict(rtol=1e-5, atol=1e-8),
             [None, "C1"]),
    "HS2I": ("vdp", "HS2I", (0.0, 1.0), VDP0[:2], dict(rtol=1e-4, atol=1e-7),
             [None]),
    "SWAG": ("vdp", "SWAG", (0.0, 5.0), VDP0, dict(rtol=1e-6, atol=1e-9,
                                                   k_max=4), [None]),
    "SSV2stab": ("heat", "SSV2stab", (0.0, 0.1), HEAT0,
                 dict(rtol=1e-4, atol=1e-7), [None]),
    "CKdisc": ("f_disc", "CKdisc", (0.0, 10.0), F_DISC0,
               dict(rtol=1e-6, atol=1e-9), [None]),
}
N_EVAL = 17


def t_eval_of(span):
    """Interior points off the step grid, plus both ends."""
    return np.linspace(span[0], span[1], N_EVAL)


def t_off_of(span):
    return span[0] + (span[1] - span[0]) * np.array([0.013, 0.37, 0.61,
                                                     0.9973])


_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.core.interpolate import OdeSolution
    from extensisq_tpu.steppers import build_stepper

    N = %d
    def heat(t, y):
        yp = jnp.pad(y, (1, 1))
        return (yp[:-2] - 2.0 * y + yp[2:]) * (N + 1) ** 2
    def kepler(t, y):
        r2 = y[0] ** 2 + y[1] ** 2
        a = -r2 ** -1.5
        return jnp.stack([y[2], y[3], a * y[0], a * y[1]])
    problems = {
        "vdp": lambda t, y: jnp.stack(
            [y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
        "kepler": kepler, "heat": heat,
        "f_disc": lambda t, y: jnp.stack(
            [jnp.where(t < 5.0, 1.0, -1.0) * y[0] - y[1],
             y[0] * 0.1 + jnp.where(t < 5.0, 0.5, -2.0)]),
    }
    inputs = np.load(sys.argv[1])
    out = {}
    for name, c in json.loads(sys.argv[2]).items():
        fun, m = problems[c["problem"]], getattr(X, c["method"])
        te = jnp.asarray(c["t_eval"])
        res = jax.jit(lambda Y: X.solve_ensemble(
            fun, tuple(c["span"]), Y, method=m, t_eval=te, save_steps=True,
            return_state=True, max_steps=c["max_steps"], **c["kw"]))(
            jnp.asarray(inputs[name]))
        for f in ("y", "status", "nsteps", "nfev", "nfailed", "ts", "ys",
                  "y_eval"):
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
        r, k = res.record, int(res.nsteps[0])
        sol = OdeSolution(
            ts=jnp.concatenate([r["t_lo"][0, :1], r["t_hi"][0, :k]]),
            t_anchor=r["t_lo"][0, :k], h=r["h"][0, :k],
            y_anchor=r["y_anchor"][0, :k], Q=r["Q"][0, :k])
        out[f"{name}/ode"] = np.asarray(sol(jnp.asarray(c["t_off"])))
        opts = {k: v for k, v in c["kw"].items() if k == "k_max"}
        st = build_stepper(m, fun, inputs[name].shape[1], jnp.float64,
                           **opts)
        for j, interp in enumerate(c["dense"]):
            segs = jax.jit(jax.vmap(
                lambda s: st.dense_segments(s, interp)[0]))(res.final_state)
            for q, seg in enumerate(segs):
                for f, v in zip(("t", "h", "ya", "Q"), seg):
                    out[f"{name}/seg{j}/{q}/{f}"] = np.asarray(v)
    np.savez(sys.argv[3], **out)
""" % N_HEAT)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """JAX ``solve_ensemble`` with the record on every case, from two
    subprocesses without FMA (the port's runs meanwhile)."""
    d = tmp_path_factory.mktemp("jax_dense")
    np.savez(d / "in.npz", **{k: v[3] for k, v in CASES.items()})
    spec = {k: dict(problem=v[0], method=v[1], span=list(v[2]),
                    kw=v[4], dense=v[5], t_eval=t_eval_of(v[2]).tolist(),
                    t_off=t_off_of(v[2]).tolist(), max_steps=MAX_STEPS)
            for k, v in CASES.items()}
    names = list(CASES)
    return run_jax(_JAX_SCRIPT, d, [{k: spec[k] for k in names[i::2]}
                                    for i in range(2)],
                   warm=[lambda k=k: _port(k) for k in names])


@functools.lru_cache(maxsize=None)
def _port(name):
    prob, method, span, y0, kw, _ = CASES[name]
    return solve_ensemble(PROBLEMS[prob], span, torch.tensor(y0),
                          method=method, t_eval=t_eval_of(span),
                          save_steps=True, return_state=True,
                          max_steps=MAX_STEPS, **kw)


def _close(a, b, gate=GATE):
    """NaN where ``b`` is, and |a - b| <= gate * max(1, |b|) elsewhere."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    d = np.abs(a[ok] - b[ok]) / np.maximum(1.0, np.abs(b[ok]))
    assert np.max(d, initial=0.0) <= gate


@pytest.mark.parametrize("name", list(CASES))
def test_record_matches_jax(jax_results, name):
    """Counters identical; y, ys, ts, y_eval and the ode_solution of
    member 0 at off-grid times within the f64 gate."""
    port = _port(name)
    ref = {f: jax_results[f"{name}/{f}"] for f in
           COUNTERS + ("y", "ts", "ys", "y_eval", "ode")}
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(), ref[f],
                                      err_msg=f)
    assert np.all(ref["status"] == 1)
    _close(port.y, ref["y"])
    _close(port.ts, ref["ts"])
    _close(port.ys, ref["ys"])
    _close(port.y_eval, ref["y_eval"])
    span = CASES[name][2]
    np.testing.assert_array_equal(port.t_eval[1].numpy(), t_eval_of(span))
    sol = port.ode_solution(member=0)
    _close(sol(torch.tensor(t_off_of(span))), ref["ode"])
    # the last recorded step ends at the final state
    k = port.nsteps.long() - 1
    b = torch.arange(len(k))
    _close(port.ys[b, k], port.y.numpy(), 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_segments_match_jax(jax_results, name):
    """Every stepper's dense_segments of the last accepted step (extra
    stages of BS5's and Fi5N's interpolants, the HS piecewise cubic,
    Kv3I's C1 interpolant) against the JAX stepper's on its state."""
    prob, method, span, y0, kw, names = CASES[name]
    port = _port(name)
    opts = {k: v for k, v in kw.items() if k == "k_max"}
    if P.METHODS_BY_NAME[method].family in ("erk", "rkn", "ckdisc"):
        opts["carry_stages"] = True
    st = build_stepper(P.METHODS_BY_NAME[method], PROBLEMS[prob],
                       y0.shape[1], torch.float64, **opts)
    for j, interp in enumerate(names):
        segs, _ = st.dense_segments(port.final_state, interp)
        for q, (t_a, h, ya, Q) in enumerate(segs):
            key = f"{name}/seg{j}/{q}"
            _close(t_a, jax_results[f"{key}/t"])
            _close(h, jax_results[f"{key}/h"])
            _close(ya.T, jax_results[f"{key}/ya"])
            _close(Q.permute(2, 0, 1), jax_results[f"{key}/Q"])
        assert f"{name}/seg{j}/{len(segs)}/Q" not in jax_results


def test_single_solve_and_ode_solution_between_steps():
    """``solve`` gives member 0's view of the ensemble record, and the
    dense output passes through every recorded step end."""
    prob, method, span, y0, kw, _ = CASES["BS5"]
    ens = _port("BS5")
    one = solve(vdp, span, torch.tensor(y0[0]), method=method,
                t_eval=t_eval_of(span), save_steps=True, max_steps=MAX_STEPS,
                **kw)
    assert one.y_eval.shape == (N_EVAL, 2) and one.ys.shape == (MAX_STEPS, 2)
    for a, b in ((one.y_eval, ens.y_eval[0]), (one.ys, ens.ys[0])):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)
    k = int(one.nsteps)
    sol = one.ode_solution()
    _close(sol(one.ts[:k]), one.ys[:k].T.numpy(), 1e-12)
    assert sol(torch.tensor(span[1])).shape == (2,)
    with pytest.raises(ValueError, match="member"):
        ens.ode_solution()
    with pytest.raises(ValueError, match="save_steps"):
        solve(vdp, span, torch.tensor(y0[0])).ode_solution()


# -- core/interpolate.py, function by function -----------------------------

def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _vmap_jax(fn, *args):
    """The JAX function on member b's slice of every (…, B) argument,
    stacked with the member axis last."""
    outs = [np.asarray(fn(*[jnp.asarray(a[..., b]) for a in args]))
            for b in range(args[0].shape[-1])]
    return np.stack(outs, axis=-1)


def test_horner_matches_jax():
    Q, ya = _rand(3, 5, 4, seed=1), _rand(3, 4, seed=2)
    u = np.array([0.0, 0.3, 1.0, -0.7])
    got = PI.horner(torch.tensor(u), torch.tensor(Q), torch.tensor(ya))
    _close(got, _vmap_jax(JI.horner, u, Q, ya), ROUND)
    # the members-first layout of the record
    got = PI.horner(torch.tensor(u)[:, None], torch.tensor(Q).permute(2, 0, 1),
                    torch.tensor(ya).T, axis=-1)
    _close(got.T, _vmap_jax(JI.horner, u, Q, ya), ROUND)


@pytest.mark.parametrize("fn", ["hermite_cubic_coefficients",
                                "quintic_hermite_coefficients"])
def test_hermite_coefficients_match_jax(fn):
    n = 4
    h = np.array([0.1, -0.25, 1.5])
    y_old, y = _rand(n, 3, seed=3), _rand(n, 3, seed=4)
    m = n // 2 if fn.startswith("quintic") else n
    f_old, f = _rand(m, 3, seed=5), _rand(m, 3, seed=6)
    args = (h, y_old, y, f_old, f)
    got = getattr(PI, fn)(*map(torch.tensor, args))
    _close(got, _vmap_jax(getattr(JI, fn), *args), ROUND)


def test_linear_and_nystrom_coefficients_match_jax():
    y_old, y = _rand(4, 3, seed=7), _rand(4, 3, seed=8)
    got = PI.linear_coefficients(torch.tensor(y_old), torch.tensor(y))
    _close(got, _vmap_jax(JI.linear_coefficients, y_old, y), ROUND)
    h = np.array([0.2, -0.1, 0.7])
    Q, Qp = _rand(2, 4, 3, seed=9), _rand(2, 5, 3, seed=10)
    got = PI.nystrom_coefficients(*map(torch.tensor, (h, y_old, Q, Qp)))
    _close(got, _vmap_jax(JI.nystrom_coefficients, h, y_old, Q, Qp), ROUND)


@pytest.mark.parametrize("backward", [False, True])
def test_stack_segments_and_ode_solution_match_jax(backward):
    """Segments of mixed degree, zero-padded, evaluated forward and
    backward at the steps and between them."""
    ts = np.array([0.0, 0.4, 1.1, 2.0]) * (-1 if backward else 1)
    segs = [(ts[i], ts[i + 1], ts[i], ts[i + 1] - ts[i], _rand(3, seed=i),
             _rand(3, 2 + i, seed=20 + i)) for i in range(3)]
    got = PI.stack_segments(segs)
    ref = JI.stack_segments(segs)
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f), 0.0)
    tq = np.array([0.0, 0.2, 0.4, 1.0, 1.7, 2.0]) * (-1 if backward else 1)
    _close(got(torch.tensor(tq)), ref(jnp.asarray(tq)), ROUND)
    _close(got(torch.tensor(tq[3])), ref(jnp.asarray(tq[3])), ROUND)
    assert float(got.t_min) == float(ref.t_min)
    assert float(got.t_max) == float(ref.t_max)
