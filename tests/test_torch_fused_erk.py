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
CASES = {
    "vdp_plain": ("vdp", "BS5", (0.0, 2.0), VDP0,
                  dict(rtol=1e-4, atol=1e-6)),
    "vdp_compensated": ("vdp", "BS5", (0.0, 2.0), VDP0,
                        dict(rtol=1e-6, atol=1e-9, compensated=True)),
    "linear_ck5": ("linear", "CK5", (0.0, 3.14159265), LIN0,
                   dict(rtol=1e-5, atol=1e-7)),
    "overflow": ("cubic", "BS5", (0.0, 1.0), CUB0,
                 dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
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
    }
    inputs = np.load(sys.argv[1])
    out = {}
    for name, (prob, meth, span, kw) in json.loads(sys.argv[2]).items():
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
    np.savez(d / "in.npz", **{k: v[3] for k, v in CASES.items()})
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
    res = fused_erk_reference(PROBLEMS[prob], span, torch.tensor(y0),
                              method=METHODS[meth], **kw)
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference).  Measured on the CPU: vdp_plain 2.8e-5, one member one
# rejected attempt (7 RHS evals) apart; vdp_compensated 2.4e-6, six
# members at most one step (14 RHS evals) apart; linear_ck5 7.2e-7 with
# identical counts.  Each count difference starts from the last bits of
# the starting step; the gates add a margin of about 2x.
GATES = [
    ("vdp_plain", 1e-4, 1, 14, 4),
    ("vdp_compensated", 1e-5, 2, 28, 12),
    ("linear_ck5", 1e-5, 0, 0, 0),
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


@pytest.mark.parametrize("option", ["t_eval", "events", "params", "dense"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_fused_erk(PROBLEMS["vdp"], (0.0, 1.0), torch.tensor(VDP0),
                        **{option: 1})


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


@pytest.mark.gpu
@pytest.mark.parametrize("name,y_gate", [("vdp_plain", 3e-2),
                                         ("vdp_compensated", 1e-4),
                                         ("overflow", 1e-6)])
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
