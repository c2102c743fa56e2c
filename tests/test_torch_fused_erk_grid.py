"""The port's mid-size fused ERK path (B4) against the JAX package's Pallas
kernel.

``fused_erk_grid_reference`` (the CUDA kernel's plain PyTorch version, B1's
loop on the rows-first state) runs on the CPU; the JAX side runs
``solve_fused_erk_grid(..., interpret=True)`` on the same seeded members,
in a subprocess without FMA (``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, see
``test_torch_fused_erk.py``).  The members have n = 100 states, which the
JAX kernel pads to 128 lanes (its masked norms keep the unpadded step
sequence) and the port takes as they are.  As for B5/B6, the first
attempts agree bit for bit and the controller's float32 ``pow`` (and the
starting step's ``log10``/``pow``) part later last bits: with
``first_step`` given, BS5's counts stay identical; CK5, which rejects
attempts close to the threshold, takes one attempt more or less on one
member; elsewhere the gates below are measured with a margin.

The tests marked ``gpu`` hold the CUDA kernel against its plain version on
the card; they skip where there is none.
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
from extensisq_tpu_torch.ops import (FusedGridRHS, fused_erk_grid_reference,
                                     solve_fused_erk_grid)

REPO = Path(__file__).resolve().parents[1]
B = 8
N = 100
METHODS = {"BS5": BS5, "CK5": CK5}


def fisher(t, y):
    """Upwind advection-reaction (BASELINE config 1b's MoL, c = 1)."""
    return -(y - torch.roll(y, 1, 0)) * float(N) + y * (1.0 - y)


def skew(t, y):
    """Central advection: imaginary spectrum, bounded both ways in t."""
    return -(torch.roll(y, -1, 0) - torch.roll(y, 1, 0)) * (0.5 * N)


RHS = {
    "fisher": FusedGridRHS(fisher, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {float(N)!r}f
         + y[i] * (1.0f - y[i]);
}}""", (N,)),
    "skew": FusedGridRHS(skew, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  using G = tab::G;
  return -(G::rolled<0>(y, i, -1) - G::rolled<0>(y, i, 1)) * {0.5 * N!r}f;
}}""", (N,)),
}


def _inputs():
    x = np.linspace(0, 1, N, endpoint=False)
    amps = np.linspace(0.2, 0.8, B)
    fis = (0.5 + 0.4 * amps[:, None] * np.sin(2 * np.pi * x)[None, :])
    fis = fis.astype(np.float32)
    bad = fis.copy()
    bad[3] *= 1e19                    # this member blows up in f32
    return fis, bad


FIS0, BAD0 = _inputs()
# name -> (problem, method, span, y0, options)
CASES = {
    "fisher_plain": ("fisher", "BS5", (0.0, 2.0), FIS0,
                     dict(rtol=1e-5, atol=1e-7)),
    "fisher_comp": ("fisher", "BS5", (0.0, 1.0), FIS0,
                    dict(rtol=1e-6, atol=1e-9, compensated=True)),
    "fisher_h0": ("fisher", "BS5", (0.0, 0.5), FIS0,
                  dict(rtol=1e-5, atol=1e-7, first_step=0.01)),
    "fisher_ck5_h0": ("fisher", "CK5", (0.0, 0.5), FIS0,
                      dict(rtol=1e-5, atol=1e-7, first_step=0.01)),
    "skew_back": ("skew", "BS5", (0.5, 0.0), FIS0,
                  dict(rtol=1e-5, atol=1e-7)),
    "overflow": ("fisher", "BS5", (0.0, 1.0), BAD0,
                 dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
}

_JAX_SCRIPT = textwrap.dedent(f"""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.ops import solve_fused_erk_grid
    problems = {{
        "fisher": lambda t, y: (-(y - jnp.roll(y, 1, -1)) * {float(N)!r}
                                + y * (1.0 - y)),
        "skew": lambda t, y: (-(jnp.roll(y, -1, -1) - jnp.roll(y, 1, -1))
                              * {0.5 * N!r}),
    }}
    inputs = np.load(sys.argv[1])
    out = {{}}
    for name, (prob, meth, span, kw) in json.loads(sys.argv[2]).items():
        res = solve_fused_erk_grid(problems[prob], tuple(span), inputs[name],
                                   method=getattr(X, meth), block_members=8,
                                   interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{{name}}/{{i}}"] = np.asarray(r)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX kernel's outputs for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_fused_erk_grid")
    np.savez(d / "in.npz", **{k: v[3] for k, v in CASES.items()})
    spec = {k: [v[0], v[1], v[2], v[4]] for k, v in CASES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=600)
    out = np.load(d / "out.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in CASES}


def _port(name, **over):
    prob, meth, span, y0, kw = CASES[name]
    res = fused_erk_grid_reference(RHS[prob], span, torch.tensor(y0),
                                   method=METHODS[meth], **dict(kw, **over))
    return tuple(r.numpy() for r in res)



# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference), measured on the CPU: fisher_plain 5.4e-5, 4, 147, 3;
# fisher_comp 9.3e-6, 3, 91, 6; fisher_ck5_h0 2.6e-6, 0, 5, 1 (CK5,
# non-FSAL); skew_back 3.7e-4, 0, 7, 1 (backward).  Gates about 2x.
GATES = [
    ("fisher_plain", 1.2e-4, 8, 300, 6),
    ("fisher_comp", 2e-5, 6, 180, 8),
    ("fisher_ck5_h0", 6e-6, 1, 10, 2),
    ("skew_back", 8e-4, 1, 14, 2),
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


def test_first_step_counts_identical(jax_results):
    """BS5 with ``first_step`` given takes the JAX kernel's steps on every
    member at n = 100 (measured |dy| 7.7e-7, gate 2e-6)."""
    y, status, nsteps, nfev = _port("fisher_h0")
    jy, jstatus, jnsteps, jnfev = jax_results["fisher_h0"]
    assert np.all(status == 1)
    np.testing.assert_array_equal(status, jstatus)
    np.testing.assert_array_equal(nsteps, jnsteps)
    np.testing.assert_array_equal(nfev, jnfev)
    assert np.max(np.abs(y - jy)) <= 2e-6


def test_overflow_member_isolated(jax_results):
    """A diverging member ends with status 3 and does not poison its
    neighbours, whose counts are the JAX kernel's (measured |dy| 3.6e-4 at
    rtol 1e-4 from the starting step's last bits, gate 8e-4)."""
    y, status, nsteps, nfev = _port("overflow")
    jy, jstatus, jnsteps, jnfev = jax_results["overflow"]
    assert status[3] == 3 and np.sum(status == 1) == B - 1
    np.testing.assert_array_equal(status, jstatus)
    ok = status == 1
    np.testing.assert_array_equal(nsteps[ok], jnsteps[ok])
    np.testing.assert_array_equal(nfev[ok], jnfev[ok])
    assert np.all(np.isfinite(y[ok]))
    assert np.max(np.abs(y[ok] - jy[ok])) <= 8e-4


def test_endpoint_tracks_the_f64_driver():
    """BASELINE config 1b's gate (``validation/benchmarks.py:100``) at
    n = 100: the plain version in f32 within 1e-3 of the f64
    ``solve_ensemble`` with BS5 at the same tolerances."""
    from extensisq_tpu_torch import solve_ensemble
    y, status, _, _ = _port("fisher_plain")
    ref = solve_ensemble(fisher, (0.0, 2.0),
                         torch.tensor(FIS0, dtype=torch.float64), method=BS5,
                         rtol=1e-5, atol=1e-7)
    assert np.all(status == 1) and bool((ref.status == 1).all())
    assert np.max(np.abs(y - ref.y.numpy())) < 1e-3


def test_grid_rhs_must_be_one_axis():
    """The mid-size kernel's state is one axis of n; a FusedGridRHS of
    another shape raises before anything runs."""
    two = FusedGridRHS(fisher, RHS["fisher"].cuda_src, (2, N // 2))
    with pytest.raises(ValueError, match="shape"):
        fused_erk_grid_reference(two, (0.0, 0.2), torch.tensor(FIS0))


def test_cpu_wrapper_runs_plain_version():
    prob, meth, span, y0, kw = CASES["fisher_h0"]
    before = solve_fused_erk_grid.launches
    ref = fused_erk_grid_reference(RHS[prob], span, torch.tensor(y0), **kw)
    for fun in (RHS[prob], RHS[prob].torch_fn):
        out = solve_fused_erk_grid(fun, span, torch.tensor(y0), method=BS5,
                                   **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert solve_fused_erk_grid.launches == before


@pytest.mark.parametrize("option", ["t_eval", "events", "params", "dense"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_fused_erk_grid(RHS["fisher"], (0.0, 1.0), torch.tensor(FIS0),
                             **{option: 1})


def test_generated_header_carries_the_grid_and_stub():
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    text = _build.fused_rk_grid_header(_fused_consts(BS5), False, (N,),
                                       RHS["fisher"].cuda_src)
    assert f"using G = grid::Grid<{N}>;" in text
    assert "constexpr bool RKN = false;" in text
    assert RHS["fisher"].cuda_src in text and "float acc(" in text


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# kernel against its plain version on the same card: status identical,
# |dy| over finished members within the gates chip_smoke.py measured
CARD_GATES = {"fisher_plain": 1e-3, "fisher_comp": 1e-4, "fisher_h0": 1e-4,
              "fisher_ck5_h0": 1e-4, "skew_back": 2e-3, "overflow": 2e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_kernel_matches_plain_version_on_card(cuda, name):
    prob, meth, span, y0, kw = CASES[name]
    y0 = torch.tensor(y0, device=cuda)
    before = solve_fused_erk_grid.launches
    k = solve_fused_erk_grid(RHS[prob], span, y0, method=METHODS[meth], **kw)
    assert solve_fused_erk_grid.launches == before + 1
    r = fused_erk_grid_reference(RHS[prob], span, y0, method=METHODS[meth],
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda):
    before = solve_fused_erk_grid.launches
    y, status, nsteps, nfev = solve_fused_erk_grid(
        RHS["fisher"], (0.0, 1.0), torch.zeros((0, N), device=cuda))
    assert y.shape == (0, N) and status.shape == (0,)
    assert solve_fused_erk_grid.launches == before


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_grid_rhs(cuda):
    with pytest.raises(TypeError, match="FusedGridRHS"):
        solve_fused_erk_grid(fisher, (0.0, 1.0),
                             torch.tensor(FIS0, device=cuda))
