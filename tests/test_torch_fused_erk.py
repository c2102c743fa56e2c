"""The port's fused ERK path against the JAX package's Pallas kernel.

``fused_erk_reference`` (the CUDA kernel's plain PyTorch version) runs on
the CPU; the JAX side runs ``solve_fused_erk(..., interpret=True)`` as the
JAX package's own tests run it, on the same seeded inputs.

XLA's CPU backend contracts ``a*b + c`` into one FMA, while PyTorch's CPU
operations round one at a time.  In float32 at small steps the embedded
error estimate is mostly round-off, so the two would take different
steps for that reason alone.  The JAX side therefore runs in a
subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, which has no FMA
instructions: both sides then round alike.  What remains is the
transcendental round-off of the two libraries (``log10``/``pow`` in the
port's starting step against ``log``/``exp`` in the JAX kernel, and
``pow`` in the controller), which the gates below allow for.

The tests marked ``gpu`` hold the CUDA kernel against the plain version
on the card; they skip where there is none.
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

from extensisq_tpu_torch import BS5, CK5
from extensisq_tpu_torch.ops import (FusedRHS, fused_erk_reference,
                                     solve_fused_erk)

REPO = Path(__file__).resolve().parents[1]
B = 128

PROBLEMS = {
    "vdp": FusedRHS(
        lambda t, y: torch.stack([y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
        """__device__ void rhs(float t, const float* y, float* dy) {
  dy[0] = y[1];
  dy[1] = 3.0f * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2),
    "linear": FusedRHS(
        lambda t, y: torch.stack([y[1], -y[0]]),
        """__device__ void rhs(float t, const float* y, float* dy) {
  dy[0] = y[1];
  dy[1] = -y[0];
}""", 2),
    "cubic": FusedRHS(
        lambda t, y: torch.stack([y[1], y[0] ** 3]),
        """__device__ void rhs(float t, const float* y, float* dy) {
  dy[0] = y[1];
  dy[1] = y[0] * y[0] * y[0];
}""", 2),
    # Van der Pol with a per-member mu (one parameter)
    "vdp_p": FusedRHS(
        lambda t, y, p: torch.stack([y[1],
                                     p[0] * (1 - y[0] ** 2) * y[1] - y[0]]),
        """template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = y[1];
  dy[1] = p[0] * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2, 1),
}
METHODS = {"BS5": BS5, "CK5": CK5}


def _inputs():
    rng = np.random.default_rng(20261016)
    vdp = np.stack([rng.uniform(1.5, 2.5, B), rng.uniform(-1.0, 1.0, B)],
                   axis=1).astype(np.float32)
    lin = np.stack([rng.uniform(0.5, 1.5, B), np.ones(B)],
                   axis=1).astype(np.float32)
    x0 = np.full(B, 0.1, np.float32)
    x0[7] = 1e18                      # this member blows up in f32
    cub = np.stack([x0, np.zeros(B, np.float32)], axis=1)
    return vdp, lin, cub


VDP0, LIN0, CUB0 = _inputs()
# the mu sweep of the JAX package's params tests: mu in [1, 2], y0 = (2, 0)
MUS = np.linspace(1.0, 2.0, B).astype(np.float32)[:, None]
VDPP0 = np.stack([np.full(B, 2.0), np.zeros(B)], axis=1).astype(np.float32)
# name -> the members' params, for the cases that take them
PARAMS = {"vdp_params": MUS}
CASES = {
    "vdp_plain": ("vdp", "BS5", (0.0, 2.0), VDP0,
                  dict(rtol=1e-4, atol=1e-6)),
    "vdp_compensated": ("vdp", "BS5", (0.0, 2.0), VDP0,
                        dict(rtol=1e-6, atol=1e-9, compensated=True)),
    "linear_ck5": ("linear", "CK5", (0.0, 3.14159265), LIN0,
                   dict(rtol=1e-5, atol=1e-7)),
    "overflow": ("cubic", "BS5", (0.0, 1.0), CUB0,
                 dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
    "vdp_params": ("vdp_p", "BS5", (0.0, 3.0), VDPP0,
                   dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.ops import solve_fused_erk
    problems = {
        "vdp": lambda t, y: jnp.stack([y[1],
                                       3.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
        "linear": lambda t, y: jnp.stack([y[1], -y[0]]),
        "cubic": lambda t, y: jnp.stack([y[1], y[0] ** 3]),
        "vdp_p": lambda t, y, p: jnp.stack(
            [y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]]),
    }
    inputs = np.load(sys.argv[1])
    out = {}
    for name, (prob, meth, span, kw) in json.loads(sys.argv[2]).items():
        if name + "/params" in inputs.files:
            kw["params"] = inputs[name + "/params"]
        res = solve_fused_erk(problems[prob], tuple(span), inputs[name],
                              method=getattr(X, meth), block_members=128,
                              interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX kernel's outputs for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_fused")
    np.savez(d / "in.npz", **{k: v[3] for k, v in CASES.items()},
             **{k + "/params": v for k, v in PARAMS.items()})
    spec = {k: [v[0], v[1], v[2], v[4]] for k, v in CASES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=600)
    out = np.load(d / "out.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in CASES}


def _port(name):
    prob, meth, span, y0, kw = CASES[name]
    if name in PARAMS:
        kw = dict(kw, params=torch.tensor(PARAMS[name]))
    res = fused_erk_reference(PROBLEMS[prob], span, torch.tensor(y0),
                              method=METHODS[meth], **kw)
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference).  Measured on the CPU: vdp_plain 2.8e-5, one member one
# rejected attempt (7 RHS evals) apart; vdp_compensated 2.4e-6, six
# members at most one step (14 RHS evals) apart; linear_ck5 7.2e-7 with
# identical counts; vdp_params (per-member mu, first_step given) 2.9e-6
# with identical counts.
# Each count difference starts from the last bits of the starting step;
# the gates add a margin of about 2x.
GATES = [
    ("vdp_plain", 1e-4, 1, 14, 4),
    ("vdp_compensated", 1e-5, 2, 28, 12),
    ("linear_ck5", 1e-5, 0, 0, 0),
    ("vdp_params", 6e-6, 0, 0, 0),
]


@pytest.mark.parametrize("name,y_gate,dsteps,dfev,nmembers", GATES)
def test_reference_matches_jax_kernel(jax_results, name, y_gate, dsteps,
                                      dfev, nmembers):
    y, status, nsteps, nfev = _port(name)
    jy, jstatus, jnsteps, jnfev = jax_results[name]
    np.testing.assert_array_equal(status, jstatus)
    assert np.all(status == 1)
    assert np.max(np.abs(y - jy)) <= y_gate
    assert np.max(np.abs(nsteps - jnsteps)) <= dsteps
    assert np.max(np.abs(nfev - jnfev)) <= dfev
    assert np.sum((nsteps != jnsteps) | (nfev != jnfev)) <= nmembers


def test_overflow_member_isolated(jax_results):
    """A diverging member must not poison its neighbours."""
    y, status, nsteps, nfev = _port("overflow")
    assert status[7] != 1                     # the bad member failed...
    assert np.sum(status == 1) == B - 1       # ...every other one finished
    assert np.all(np.isfinite(y[status == 1]))
    jy, jstatus, jnsteps, jnfev = jax_results["overflow"]
    np.testing.assert_array_equal(status, jstatus)
    ok = status == 1
    np.testing.assert_array_equal(nsteps[ok], jnsteps[ok])
    assert np.max(np.abs(y[ok] - jy[ok])) <= 1e-6


def test_nonfsal_method_accuracy():
    """CK5 on the harmonic oscillator rotates (x, v) by pi (the JAX
    package's test_fused_nonfsal_method gate)."""
    y, status, _, _ = _port("linear_ck5")
    assert np.all(status == 1)
    assert np.max(np.abs(y + LIN0)) < 1e-3


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper runs the plain version, with a FusedRHS
    or a bare torch function, and launches no kernel."""
    prob, meth, span, y0, kw = CASES["vdp_plain"]
    before = solve_fused_erk.launches
    ref = fused_erk_reference(PROBLEMS[prob], span, torch.tensor(y0), **kw)
    for fun in (PROBLEMS[prob], PROBLEMS[prob].torch_fn):
        out = solve_fused_erk(fun, span, torch.tensor(y0), method=BS5, **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert solve_fused_erk.launches == before


@pytest.mark.parametrize("option", ["events"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_fused_erk(PROBLEMS["vdp"], (0.0, 1.0), torch.tensor(VDP0),
                        **{option: 1})


@pytest.mark.parametrize("fun,params,match", [
    ("vdp_p", MUS[:-1], "params must be"),
    ("vdp_p", MUS[:, 0], "params must be"),
    ("vdp_p", None, "takes 1 parameters"),
    ("vdp_p", np.repeat(MUS, 2, axis=1), "k = 1"),
    ("vdp", MUS, "k = 0")])
def test_params_checks_raise(fun, params, match):
    """As the JAX kernel checks them: params of another shape than (B, k)
    raise ValueError, and so do params a FusedRHS's k does not take."""
    with pytest.raises(ValueError, match=match):
        solve_fused_erk(PROBLEMS[fun], (0.0, 1.0), torch.tensor(VDPP0),
                        params=params)


def test_params_bit_for_bit_baked():
    """Per-member params give each member the steps of the same RHS with
    its mu baked in, bit for bit (the JAX package's
    test_fused_erk_params_bit_exact_vs_baked).  The baked run repeats the
    member over a batch of the same size, as the JAX test does: PyTorch's
    CPU pow rounds otherwise in its vectorized body than in its scalar
    tail, so a batch of one would part in the last bits."""
    mus = np.linspace(1.0, 4.0, B).astype(np.float32)[:, None]
    kw = dict(method=BS5, rtol=1e-4, atol=1e-6)
    y, st, ns, nf = fused_erk_reference(
        PROBLEMS["vdp_p"], (0.0, 5.0), torch.tensor(VDPP0),
        params=torch.tensor(mus), **kw)
    assert torch.all(st == 1)
    for i in (0, 37, 127):
        mu = float(mus[i, 0])
        baked = fused_erk_reference(
            lambda t, yy, mu=mu: torch.stack(
                [yy[1], mu * (1 - yy[0] ** 2) * yy[1] - yy[0]]),
            (0.0, 5.0), torch.tensor(VDPP0[i:i + 1]).repeat(B, 1), **kw)
        assert torch.equal(baked[0][0], y[i])
        assert int(baked[2][0]) == int(ns[i])
        assert int(baked[3][0]) == int(nf[i])


def test_step_cap_counts_attempts():
    """max_steps caps loop iterations (accepted + rejected) with status 3,
    as the JAX kernel's hit_cap does."""
    prob, meth, span, y0, kw = CASES["vdp_plain"]
    y, status, nsteps, nfev = fused_erk_reference(
        PROBLEMS[prob], (0.0, 10.0), torch.tensor(y0), max_steps=5, **kw)
    assert torch.all(status == 3)
    assert torch.all(nsteps <= 5)
    # 5 start-up evaluations, then 7 per attempt (6 stages + FSAL)
    assert torch.all(nfev == 5 + 5 * 7)


def test_generated_header_holds_float32_tableau():
    """The kernel's tableau header carries every weight rounded to float32
    exactly as the JAX kernel rounds it, zeros included."""
    import re
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    for method in (BS5, CK5):
        k = _fused_consts(method)
        text = _build.fused_erk_header(k, 2, PROBLEMS["vdp"].cuda_src)
        tab = method.tableau
        assert f"constexpr int S = {tab.n_stages};" in text
        assert f"constexpr bool FSAL = {str(tab.fsal).lower()};" in text
        assert PROBLEMS["vdp"].cuda_src in text
        for name, ref in (("B", tab.B), ("C", tab.C), ("E", tab.E)):
            body = re.search(rf"constexpr float {name}\[[^]]*\] = \{{(.*?)\}};",
                             text).group(1)
            vals = [0.0 if v.strip() == "0.0f" else
                    float.fromhex(v.strip()[:-1]) for v in body.split(",")]
            np.testing.assert_array_equal(np.float32(vals),
                                          np.asarray(ref, np.float32))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CPU fallback: where the CUDA toolkit is missing, building the
    kernel raises before anything is written."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_fused_erk(_fused_consts(BS5), 2,
                              PROBLEMS["vdp"].cuda_src)
    assert not (tmp_path / "build").exists()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# kernel against its plain version on the same card: status identical,
# |dy| over finished members within the gates chip_smoke.py measured
CARD_GATES = {"vdp_plain": 3e-2, "vdp_compensated": 1e-4, "overflow": 1e-6}


@pytest.mark.gpu
@pytest.mark.parametrize("name,y_gate", list(CARD_GATES.items()))
def test_kernel_matches_plain_version_on_card(cuda, name, y_gate):
    """The CUDA kernel against its plain version on the same card; f32
    round-off (the kernel contracts to FMA) allows other step sequences,
    hence the measured gates of chip_smoke.py."""
    prob, meth, span, y0, kw = CASES[name]
    y0 = torch.tensor(y0, device=cuda)
    before = solve_fused_erk.launches
    k = solve_fused_erk(PROBLEMS[prob], span, y0, method=METHODS[meth],
                        **kw)
    assert solve_fused_erk.launches == before + 1
    r = fused_erk_reference(PROBLEMS[prob], span, y0, method=METHODS[meth],
                            **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    assert (k[0][ok] - r[0][ok]).abs().max().item() <= y_gate


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_rhs(cuda):
    y0 = torch.tensor(VDP0, device=cuda)
    with pytest.raises(TypeError, match="FusedRHS"):
        solve_fused_erk(PROBLEMS["vdp"].torch_fn, (0.0, 1.0), y0)


@pytest.mark.parametrize("members,compensated,lanes", [
    (512, True, 8), (2112, True, 8), (2113, True, 4), (4096, True, 4),
    (4224, True, 4), (4225, True, 1), (262144, True, 1), (512, False, 1),
    (4096, False, 1)])
def test_lanes_per_member_on_132_sms(members, compensated, lanes):
    """B1's rule on the H100's 132 SMs: compensated, the largest of 8 and
    4 lanes with members x lanes <= 128 x 132, else one thread; plain,
    one thread (the sweep's ties and losses)."""
    from extensisq_tpu_torch.ops.fused_erk import _lanes_per_member
    assert _lanes_per_member(members, 132, compensated) == lanes


def _launch_args(name, cuda):
    prob, meth, span, y0, kw = CASES[name]
    return (PROBLEMS[prob], span, torch.tensor(y0, device=cuda),
            METHODS[meth], kw["rtol"], kw["atol"], kw.get("first_step"),
            kw.get("max_steps", 100_000), kw.get("compensated", False), None)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_lane_bodies_bit_identical_to_one_thread_on_card(cuda, name):
    """B1 forced to 2, 4 and 8 lanes a member (128 / G members a block):
    bit for bit the one-thread body, and against the plain version at the
    card gates.  Comparison launches are not counted."""
    from extensisq_tpu_torch.ops import fused_erk as FK
    args = _launch_args(name, cuda)
    before = solve_fused_erk.launches
    one, shape = FK._launch(*args, 1)
    assert shape == (1, 128)
    fun, span, y0, method = args[:4]
    prob, meth, span, _, kw = CASES[name]
    r = fused_erk_reference(fun, span, y0, method=method, **kw)
    for lanes in (2, 4, 8):
        k, shape = FK._launch(*args, lanes)
        assert shape == (lanes, 128 // lanes)
        for a, b in zip(k, one):
            assert torch.equal(a, b)
        assert torch.equal(k[1], r[1])
        ok = r[1] == 1
        assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]
    assert solve_fused_erk.launches == before


@pytest.mark.gpu
def test_wrapper_takes_the_rules_shape_on_card(cuda):
    """solve_fused_erk launches its rule's shape for the card's SM count
    and mode, and records it in last_shape."""
    from extensisq_tpu_torch.ops import fused_erk as FK
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name in ("vdp_plain", "vdp_compensated"):
        prob, meth, span, y0, kw = CASES[name]
        for y in (y0, np.repeat(y0, 40, axis=0)):
            solve_fused_erk(PROBLEMS[prob], span, torch.tensor(y, device=cuda),
                            method=METHODS[meth], **kw)
            g = FK._lanes_per_member(len(y), sms, kw.get("compensated", False))
            assert solve_fused_erk.last_shape == (g, 128 // g)


@pytest.mark.gpu
def test_block_of_more_than_1024_threads_raises(cuda):
    """An explicit block_members of more than 1024 threads at the lanes
    taken raises before any launch."""
    from extensisq_tpu_torch.ops import fused_erk as FK
    args = _launch_args("vdp_compensated", cuda)
    before = solve_fused_erk.launches
    with pytest.raises(ValueError, match="at most 1024"):
        FK._launch(*args, 8, 256)
    prob, meth, span, y0, kw = CASES["vdp_plain"]
    with pytest.raises(ValueError, match="at most 1024"):
        solve_fused_erk(PROBLEMS[prob], span, torch.tensor(y0, device=cuda),
                        method=METHODS[meth], block_members=2048, **kw)
    assert solve_fused_erk.launches == before
