"""The port's SWAG family (f64 driver) against the JAX package.

Both packages integrate the same seeded members on the CPU: extensisq's
rational problem forward and backward, the oscillator at rtol 1e-8 with
``k_max`` 4 and 12, Van der Pol with per-member ``mu``, the Brusselator
at rtol 1e-9, whose run takes rejections, a span shorter than the minimum
step (one near-end linear extrapolation) and a tolerance below round-off
(status 7, TOL_TOO_TIGHT).  The JAX side runs in one subprocess with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``: XLA's CPU backend otherwise
contracts ``a*b + c`` into FMA even in float64, and the high rows of
``phi`` (differences at the round-off level that pick the order) then
part in the last bits; at rtol 1e-9 the Brusselator's step sequences part
after 53 attempts (ROADMAP C, comparison hazards).  Without FMA every
rounding is the same, and the work counters are identical per member.
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

from extensisq_tpu.steppers import adams as jax_adams

from extensisq_tpu_torch import SWAG, METHODS_BY_NAME, solve, solve_ensemble
from extensisq_tpu_torch.steppers import adams, build_stepper
from extensisq_tpu_torch.types import IVPParams

REPO = Path(__file__).resolve().parents[1]
COUNTERS = ("status", "nsteps", "nfev", "nfailed")


def rational(t, y):
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def osc(t, y):
    return torch.stack([y[1], -y[0]])


def vdp_p(t, y, mu):
    return torch.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])


def brus(t, y):
    return torch.stack([1.0 + y[0] ** 2 * y[1] - 4.0 * y[0],
                        3.0 * y[0] - y[0] ** 2 * y[1]])


PROBLEMS = {"rational": rational, "osc": osc, "vdp_p": vdp_p, "brus": brus}


def _inputs():
    rng = np.random.default_rng(11)
    rat = np.array([1 / 3, 2 / 9]) * rng.uniform(0.97, 1.03, (4, 1))
    ho = np.stack([rng.uniform(-1.0, 1.0, 6), rng.uniform(0.5, 1.5, 6)], 1)
    vdp = np.tile([2.0, 0.0], (8, 1))
    br = np.stack([rng.uniform(1.4, 1.6, 4), rng.uniform(2.9, 3.1, 4)], 1)
    return rat, ho, vdp, br


RAT0, HO0, VDP0, BR0 = _inputs()
MUS = np.linspace(0.5, 3.0, 8)
# name -> (problem, span, y0, options, params_batch); tests/test_swag.py
CASES = {
    "rational_fwd": ("rational", (5.0, 9.0), RAT0,
                     dict(rtol=1e-3, atol=1e-6), None),
    "rational_bwd": ("rational", (5.0, 1.0), RAT0,
                     dict(rtol=1e-3, atol=1e-6), None),
    "osc_k4": ("osc", (0.0, 30.0), HO0,
               dict(rtol=1e-8, atol=1e-11, k_max=4), None),
    "osc_k12": ("osc", (0.0, 30.0), HO0,
                dict(rtol=1e-8, atol=1e-11, k_max=12), None),
    "vdp_params": ("vdp_p", (0.0, 10.0), VDP0,
                   dict(rtol=1e-6, atol=1e-9), MUS),
    "brusselator": ("brus", (0.0, 30.0), BR0,
                    dict(rtol=1e-9, atol=1e-12), None),
    # a span below the minimum step: one near-end linear extrapolation
    "near_end": ("osc", (1e6, 1e6 + 1e-10), HO0[:2],
                 dict(rtol=1e-6, atol=1e-9), None),
    # rtol below round-off: TOL_TOO_TIGHT (status 7) on the first step
    "tol_too_tight": ("osc", (0.0, 1.0), HO0[:2],
                      dict(rtol=1e-17, atol=1e-20), None),
}
TRACE_CASE = "brusselator"
# the f32 starting state of the fused kernel: (span, y0, rtol, atol)
F32_INIT = ((0.0, 2.0), np.stack([np.linspace(1.9, 2.1, 16),
                                  np.zeros(16)], 1), 1e-4, 1e-6)

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.solve import solve_ensemble
    from extensisq_tpu.steppers import build_stepper
    from extensisq_tpu.types import IVPParams

    def rational(t, y):
        return jnp.stack([y[1] / t,
                          y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])

    def osc(t, y):
        return jnp.stack([y[1], -y[0]])

    def vdp_p(t, y, mu):
        return jnp.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])

    def vdp5(t, y):
        return jnp.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1] - y[0]])

    def brus(t, y):
        return jnp.stack([1.0 + y[0] ** 2 * y[1] - 4.0 * y[0],
                          3.0 * y[0] - y[0] ** 2 * y[1]])

    problems = {"rational": rational, "osc": osc, "vdp_p": vdp_p,
                "brus": brus}
    inputs = np.load(sys.argv[1])
    spec = json.loads(sys.argv[2])
    out = {}
    for name, (prob, span, kw, has_p) in spec["cases"].items():
        y0 = jnp.asarray(inputs[name + "/y0"])
        pb = jnp.asarray(inputs[name + "/p"]) if has_p else None
        res = jax.jit(lambda Y, P: solve_ensemble(
            problems[prob], tuple(span), Y, params_batch=P, method=X.SWAG,
            **kw))(y0, pb)
        for f in ("status", "nsteps", "nfev", "nfailed", "y"):
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))

    # one member, attempt by attempt, through step_flat
    prob, span, kw, _ = spec["cases"][spec["trace"]]
    kw = dict(kw)
    st = build_stepper(X.SWAG, problems[prob], 2, np.float64,
                       k_max=kw.pop("k_max", 12))
    p = IVPParams(t_bound=jnp.asarray(span[1]),
                  direction=jnp.asarray(np.sign(span[1] - span[0])),
                  rtol=jnp.asarray(kw["rtol"]), atol=jnp.asarray(kw["atol"]),
                  max_step=jnp.asarray(np.inf))
    s = jax.vmap(lambda y: st.init(span[0], y, p))(
        jnp.asarray(inputs[spec["trace"] + "/y0"][:1]))
    aux = jax.vmap(st.flat_init_aux)(s)
    step = jax.jit(jax.vmap(lambda s, a: st.step_flat(p, s, a)))
    rows = {f: [] for f in ("k", "ns", "h", "phi", "g", "nfev")}
    while int(s.status[0]) == 0:
        s, aux, _ = step(s, aux)
        for f in rows:
            rows[f].append(np.asarray(getattr(s, f))[0])
    for f, v in rows.items():
        out["trace/" + f] = np.stack(v)

    # the f32 starting state of the fused kernel
    (t0, tf), rtol, atol = spec["f32"]
    with jax.enable_x64(False):
        p32 = IVPParams(t_bound=jnp.asarray(tf, jnp.float32),
                        direction=jnp.asarray(1.0, jnp.float32),
                        rtol=jnp.asarray(rtol, jnp.float32),
                        atol=jnp.asarray(atol, jnp.float32),
                        max_step=jnp.asarray(np.finfo(np.float32).max,
                                             jnp.float32))
        st32 = build_stepper(X.SWAG, vdp5, 2, np.float32, k_max=6)
        s32 = jax.vmap(lambda y: st32.init(t0, y, p32))(
            jnp.asarray(inputs["f32/y0"], jnp.float32))
        for f in ("h", "wt", "yp", "nfev"):
            out["f32/" + f] = np.asarray(getattr(s32, f))
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX package's results for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_swag")
    arrays = {"f32/y0": F32_INIT[1]}
    spec = {"cases": {}, "trace": TRACE_CASE,
            "f32": [F32_INIT[0], F32_INIT[2], F32_INIT[3]]}
    for name, (prob, span, y0, kw, pb) in CASES.items():
        arrays[name + "/y0"] = y0
        if pb is not None:
            arrays[name + "/p"] = pb
        spec["cases"][name] = [prob, span, kw, pb is not None]
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=900)
    return dict(np.load(d / "out.npz"))


def _port(name):
    prob, span, y0, kw, pb = CASES[name]
    return solve_ensemble(PROBLEMS[prob], span, torch.tensor(y0),
                          params_batch=None if pb is None
                          else torch.tensor(pb), method=SWAG, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_ensemble_matches_jax(jax_results, name):
    """Identical status, nsteps, nfev and nfailed per member; endpoints
    within 1e-10 (measured: at most 1.3e-13, on the oscillators)."""
    port = _port(name)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      jax_results[f"{name}/{f}"], err_msg=f)
    want = 7 if name == "tol_too_tight" else 1
    assert np.all(port.status.numpy() == want)
    assert np.max(np.abs(port.y.numpy() - jax_results[f"{name}/y"])) <= 1e-10
    if name == "near_end":
        # the extrapolation counts as a step and evaluates nothing
        assert torch.all(port.nsteps == 1)
        y0 = torch.tensor(CASES[name][2])
        d = CASES[name][1][1] - CASES[name][1][0]
        assert torch.equal(port.y, y0 + d * osc(0.0, y0.T).T)


def test_step_flat_matches_jax_attempt_by_attempt(jax_results):
    """One Brusselator member through step_flat, every attempt of its run
    (rejections included): order and ns identical, h, phi and g equal to
    the last bit (XLA without FMA rounds as PyTorch does)."""
    prob, span, y0, kw, _ = CASES[TRACE_CASE]
    kw = dict(kw)
    stepper = build_stepper(SWAG, PROBLEMS[prob], 2, torch.float64,
                            k_max=kw.pop("k_max", 12))
    params = IVPParams(t_bound=span[1], direction=1.0, max_step=np.inf, **kw)
    state = stepper.init(span[0], torch.tensor(y0[:1]).T.contiguous(),
                         params)
    aux = stepper.flat_init_aux(state)
    ref = {f: jax_results["trace/" + f] for f in ("k", "ns", "h", "phi", "g",
                                                   "nfev")}
    n_att = ref["k"].shape[0]
    rejected = 0
    for a in range(n_att):
        state, aux, accepted = stepper.step_flat(params, state, aux)
        rejected += int(~accepted[0] & (state.status[0] == 0))
        assert int(state.k[0]) == ref["k"][a], a
        assert int(state.ns[0]) == ref["ns"][a], a
        assert int(state.nfev[0]) == ref["nfev"][a], a
        assert float(state.h[0]) == ref["h"][a], a
        np.testing.assert_array_equal(state.phi[..., 0].numpy(),
                                      ref["phi"][a], err_msg=str(a))
        np.testing.assert_array_equal(state.g[:, 0].numpy(), ref["g"][a],
                                      err_msg=str(a))
    assert int(state.status[0]) == 1
    assert rejected > 0


def test_f32_init_matches_jax(jax_results):
    """The fused kernel's starting state, from the float32 ``init``, against
    JAX's float32 ``init`` (x64 off): the starting step's log10/pow round
    differently in the two libraries.  Measured: h bit-identical on 15 of
    16 members and 5.2e-7 relative apart on one, wt bit-identical; the gate
    is 1e-6 relative on at most 2 members."""
    (t0, tf), y0, rtol, atol = F32_INIT
    st = build_stepper(SWAG, lambda t, y: torch.stack(
        [y[1], 5.0 * (1 - y[0] ** 2) * y[1] - y[0]]), 2, torch.float32,
        k_max=6)
    f32 = np.float32
    params = IVPParams(t_bound=float(f32(tf)), direction=1.0,
                       rtol=float(f32(rtol)), atol=float(f32(atol)),
                       max_step=float(np.finfo(f32).max))
    s = st.init(t0, torch.tensor(y0, dtype=torch.float32).T.contiguous(),
                params)
    np.testing.assert_array_equal(s.nfev.numpy(), jax_results["f32/nfev"])
    np.testing.assert_array_equal(s.yp.T.numpy(), jax_results["f32/yp"])
    np.testing.assert_allclose(s.h.numpy(), jax_results["f32/h"],
                               rtol=1e-6, atol=0)
    assert np.sum(s.h.numpy() != jax_results["f32/h"]) <= 2
    np.testing.assert_allclose(s.wt.T.numpy(), jax_results["f32/wt"],
                               rtol=1e-6, atol=0)


def test_step_advances_one_accepted_step():
    """``step`` repeats attempts per member until each is accepted: every
    member's nsteps moves by one per call, and the counts are those of
    step_flat run to the same steps."""
    prob, span, y0, kw, _ = CASES["brusselator"]
    stepper = build_stepper(SWAG, brus, 2, torch.float64)
    params = IVPParams(t_bound=span[1], direction=1.0, max_step=np.inf, **kw)
    y = torch.tensor(y0).T.contiguous()
    state = stepper.init(span[0], y, params)
    flat = stepper.init(span[0], y, params)
    aux = stepper.flat_init_aux(flat)
    for k in range(1, 41):
        state = stepper.step(params, state)
        assert torch.all(state.nsteps == k)
    while bool((flat.nsteps < 40).any()):
        new, aux_new, _ = stepper.step_flat(params, flat, aux)
        run = flat.nsteps < 40
        flat = adams.select(run, new, flat)
        aux = adams.select(run, aux_new, aux)
    for f in ("t", "y", "h", "k", "nfev", "nfailed", "phi"):
        assert torch.equal(getattr(state, f), getattr(flat, f)), f


def test_solve_matches_ensemble_member():
    prob, span, y0, kw, _ = CASES["osc_k12"]
    ens = _port("osc_k12")
    one = solve(osc, span, torch.tensor(y0[2]), method=SWAG, max_steps=5000,
                **kw)
    for f in COUNTERS:
        assert int(getattr(one, f)) == int(getattr(ens, f)[2])
    assert torch.equal(one.y, ens.y[2])


def test_constants_equal_jax():
    assert adams.K_MAX_LIMIT == jax_adams.K_MAX_LIMIT
    assert np.array_equal(adams._GSTR, jax_adams._GSTR)
    assert METHODS_BY_NAME["SWAG"] is SWAG
    assert SWAG.family == "adams" and SWAG.options == {"k_max": 12}


def test_k_max_out_of_range_raises():
    for k_max in (0, 13):
        with pytest.raises(ValueError, match="k_max"):
            solve(osc, (0.0, 1.0), torch.tensor([0.0, 1.0]), method=SWAG,
                  k_max=k_max)


def test_unported_parts_name_their_roadmap_item():
    stepper = build_stepper(SWAG, osc, 2, torch.float64)
    params = IVPParams(t_bound=1.0, direction=1.0, rtol=1e-6, atol=1e-9,
                       max_step=np.inf)
    state = stepper.init(0.0, torch.tensor([[0.0], [1.0]]), params)
    with pytest.raises(NotImplementedError, match="A4b"):
        stepper.dense_segments(state)
    with pytest.raises(NotImplementedError, match="A3"):
        solve(osc, (0.0, 1.0), torch.tensor([0.5 + 1j, 0.0]), method=SWAG)
