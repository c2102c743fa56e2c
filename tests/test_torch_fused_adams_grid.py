"""The port's mid-size fused SWAG path (B8) against the JAX package's Pallas
kernel and the port's f64 driver.

``fused_adams_grid_reference`` (the CUDA kernel's plain PyTorch version,
B3's loop on the rows-first state) runs on the CPU; the JAX side runs
``solve_fused_adams_grid(..., interpret=True)`` on the same seeded members,
in one subprocess without FMA (``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, see
``test_torch_fused_erk.py``).  XLA compiles the interpret-mode SWAG body in
time ~k_max^3, so the JAX cases keep k_max <= 4.  The members have n = 32
states, which the JAX kernel pads to 128 lanes (its masked norms keep the
unpadded step sequence) and the port takes as they are.  The first
attempts agree bit for bit; from there the port's ``pow`` in the step
ratio (the JAX kernel takes ``exp(log x / (k + 1))``, a Mosaic workaround
left out) and the order of the norms' sums part last bits of h, and the
gates below are measured with a margin.  Config 2d's shapes (32 heat
members of n = 256, k_max = 6) are held against the port's f64 SWAG driver
on a cut span.

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

from extensisq_tpu_torch import SWAG, solve_ensemble
from extensisq_tpu_torch.ops import (FusedGridRHS, fused_adams_grid_reference,
                                     solve_fused_adams_grid)

REPO = Path(__file__).resolve().parents[1]
B = 8
N = 32
D_HEAT = 0.05      # the small cases' diffusivity: stiffer than config 2d's
N_2D = 256          # config 2d (validation/benchmarks.py:221-259)
B_2D = 32


def heat(n, diff=D_HEAT):
    """Periodic heat MoL, D = ``diff``, dx = 1/n."""
    c = diff * n * n

    def fun(t, y):
        return (torch.roll(y, 1, 0) + torch.roll(y, -1, 0) - 2.0 * y) * c
    return fun


def heat_cuda(n, diff=D_HEAT):
    return f"""__device__ float rhs(float t, const float* y, int i,
                    const float* p) {{
  using G = tab::G;
  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) - 2.0f * y[i])
         * {float(np.float32(diff * n * n))!r}f;
}}"""


def skew(t, y):
    """Central advection: imaginary spectrum, bounded both ways in t."""
    return -(torch.roll(y, -1, 0) - torch.roll(y, 1, 0)) * (0.5 * N)


def heat_cubic(t, y):
    """The heat MoL plus a cubic term that blows up a large member."""
    return heat(N)(t, y) + y * y * y


RHS = {
    "heat": FusedGridRHS(heat(N), heat_cuda(N), (N,)),
    "skew": FusedGridRHS(skew, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  using G = tab::G;
  return -(G::rolled<0>(y, i, -1) - G::rolled<0>(y, i, 1)) * {0.5 * N!r}f;
}}""", (N,)),
    "heat_cubic": FusedGridRHS(heat_cubic, f"""template <class T>
__device__ T rhs(T t, const T* y, int i, const float* p) {{
  using G = tab::G;
  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) - 2.0f * y[i])
         * {D_HEAT * N * N!r}f + y[i] * y[i] * y[i];
}}""", (N,)),
}


def heat_y0(members, n):
    """Config 2d's members: amps sin(2 pi x) + 0.3 cos(4 pi x)."""
    x = np.linspace(0, 1, n, endpoint=False)
    amps = np.linspace(0.5, 1.5, members)
    return (amps[:, None] * np.sin(2 * np.pi * x)[None, :]
            + 0.3 * np.cos(4 * np.pi * x)[None, :]).astype(np.float32)


def _inputs():
    hy = heat_y0(B, N)
    bad = hy.copy()
    bad[3] *= 1e19                    # this member blows up in f32
    return {"heat": hy, "bad": bad}


Y0 = _inputs()
TOL = dict(rtol=1e-4, atol=1e-6)
# name -> (problem, span, y0, options)
CASES = {
    "heat": ("heat", (0.0, 0.25), "heat", dict(TOL, k_max=4)),
    "skew_back": ("skew", (0.5, 0.0), "heat",
                  dict(rtol=1e-5, atol=1e-7, k_max=3)),
    "heat_max_step": ("heat", (0.0, 0.25), "heat",
                      dict(TOL, k_max=3, first_step=1e-3, max_step=0.005)),
}
# the first attempts of a case, bit for bit: name -> (case, max_steps)
FIRST = {"heat_max_step_3": ("heat_max_step", 3)}

_JAX_SCRIPT = textwrap.dedent(f"""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from extensisq_tpu.ops import solve_fused_adams_grid

    c = {D_HEAT * N * N!r}
    problems = {{
        "heat": lambda t, y: (jnp.roll(y, 1, -1) + jnp.roll(y, -1, -1)
                              - 2.0 * y) * c,
        "skew": lambda t, y: -(jnp.roll(y, -1, -1) - jnp.roll(y, 1, -1))
                              * {0.5 * N!r},
    }}
    inputs = np.load(sys.argv[1])
    out = {{}}
    for name, (prob, span, y0, kw) in json.loads(sys.argv[2]).items():
        res = solve_fused_adams_grid(problems[prob], tuple(span),
                                     inputs[y0], block_members=8,
                                     interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{{name}}/{{i}}"] = np.asarray(r)
    np.savez(sys.argv[3], **out)
""")


def _spec():
    spec = {k: list(v) for k, v in CASES.items()}
    for name, (case, attempts) in FIRST.items():
        prob, span, y0, kw = CASES[case]
        spec[name] = [prob, span, y0, dict(kw, max_steps=attempts)]
    return spec


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX kernel's outputs for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_fused_adams_grid")
    np.savez(d / "in.npz", **Y0)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(_spec()), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=600)
    out = np.load(d / "out.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in _spec()}


def _port(name, **over):
    prob, span, y0, kw = CASES[name]
    res = fused_adams_grid_reference(RHS[prob], span, torch.tensor(Y0[y0]),
                                     **dict(kw, **over))
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with other counts),
# measured on the CPU: heat 2.7e-5, 2, 4, 3 of 8 (31.25 vs 30.625 mean
# steps); skew_back (a backward span) 9.5e-7, 0, 0, 0; heat_max_step
# (first_step and max_step given) 0, 0, 0, 0, every member bit for bit.
# The gates add a margin of about 2x.
GATES = [("heat", 6e-5, 4, 8, 6), ("skew_back", 2e-6, 1, 2, 2),
         ("heat_max_step", 0.0, 0, 0, 0)]


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


@pytest.mark.parametrize("name", list(FIRST))
def test_first_attempts_bit_identical(jax_results, name):
    """With ``first_step`` given, the first attempts (the coefficient
    update, the predictor, the error ladder, the corrector and the order
    selection) repeat the JAX kernel's arithmetic bit for bit."""
    case, attempts = FIRST[name]
    out = _port(case, max_steps=attempts)
    for a, b in zip(out, jax_results[name]):
        np.testing.assert_array_equal(a, b)


def test_max_step_caps_the_steps():
    """``max_step`` bounds every step: over t in [0, 0.25] with a cap of
    0.005 every member takes at least 50 steps."""
    _, status, nsteps, _ = _port("heat_max_step")
    assert np.all(status == 1) and np.all(nsteps >= 50)


def test_overflow_member_isolated():
    """A member whose state overflows ends with status 3 alone; its
    neighbours finish with the counts they take without it."""
    span, kw = (0.0, 0.1), dict(TOL, k_max=4, max_steps=2000)
    y, status, nsteps, nfev = fused_adams_grid_reference(
        RHS["heat_cubic"], span, torch.tensor(Y0["bad"]), **kw)
    ref = fused_adams_grid_reference(
        RHS["heat_cubic"], span, torch.tensor(Y0["heat"]), **kw)
    assert int(status[3]) == 3 and int((status == 1).sum()) == B - 1
    ok = np.arange(B) != 3
    assert torch.equal(nsteps[ok], ref[2][ok])
    assert torch.equal(y[ok], ref[0][ok])


def config_2d(span):
    """Config 2d's members and options on ``span``."""
    return (RHS_2D, span, torch.tensor(heat_y0(B_2D, N_2D)),
            dict(TOL, k_max=6))


RHS_2D = FusedGridRHS(heat(N_2D, 0.01), heat_cuda(N_2D, 0.01), (N_2D,))


def test_config_2d_tracks_the_f64_driver():
    """Config 2d on a cut span, t in [0, 0.05]: every member finishes,
    within 1e-3 of the port's f64 SWAG driver with k_max 6 and with mean
    nsteps within 15% (the JAX gates, tests/test_fused_pallas.py:598-628).
    Measured on the CPU: |dy| 4.59e-4, mean nsteps 76.31 vs 70.13."""
    fun, span, y0, kw = config_2d((0.0, 0.05))
    y, status, nsteps, nfev = fused_adams_grid_reference(fun, span, y0, **kw)
    ref = solve_ensemble(fun.torch_fn, span, y0.double(), method=SWAG,
                         rtol=kw["rtol"], atol=kw["atol"], k_max=6)
    assert bool((status == 1).all()) and bool((ref.status == 1).all())
    assert (y.double() - ref.y).abs().max().item() < 1e-3
    mean, mean64 = nsteps.double().mean(), ref.nsteps.double().mean()
    assert abs(mean - mean64) < 0.15 * mean64
    assert bool((nfev >= 2 * nsteps).all())


def test_grid_rhs_must_be_one_axis():
    two = FusedGridRHS(heat(N), heat_cuda(N), (2, N // 2))
    with pytest.raises(ValueError, match="shape"):
        fused_adams_grid_reference(two, (0.0, 0.1),
                                   torch.tensor(Y0["heat"]))


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper runs the plain version, with a
    FusedGridRHS or a bare torch function, and launches no kernel."""
    prob, span, y0, kw = CASES["heat_max_step"]
    y0 = torch.tensor(Y0[y0])
    before = solve_fused_adams_grid.launches
    ref = fused_adams_grid_reference(RHS[prob], span, y0, **kw)
    for f in (RHS[prob], RHS[prob].torch_fn):
        for a, b in zip(solve_fused_adams_grid(f, span, y0, **kw), ref):
            assert torch.equal(a, b)
    assert solve_fused_adams_grid.launches == before


@pytest.mark.parametrize("option", ["events"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        solve_fused_adams_grid(RHS["heat"], (0.0, 1.0),
                               torch.tensor(Y0["heat"]), **{option: 1})


def test_k_max_out_of_range_raises():
    with pytest.raises(ValueError, match="k_max"):
        solve_fused_adams_grid(RHS["heat"], (0.0, 1.0),
                               torch.tensor(Y0["heat"]), k_max=13)


def test_generated_header_carries_the_grid():
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_adams import _adams_consts
    text = _build.fused_adams_header(_adams_consts(6, N), RHS["heat"].cuda_src,
                                     (N,))
    assert f"using G = grid::Grid<{N}>;" in text
    assert "constexpr int KM = 6;" in text and RHS["heat"].cuda_src in text
    assert [p.name for p in _build.shared_headers("fused_adams_grid")] == [
        "dense_record.cuh", "grid_common.cuh", "adams_common.cuh",
        "rk_common.cuh", "snapshot.cuh", "block_group.cuh", "lane_group.cuh"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# kernel against its plain version on the same card: status identical,
# |dy| over finished members within the gates chip_smoke.py measured
CARD_GATES = {"heat": 1e-4, "skew_back": 1e-4, "heat_max_step": 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_kernel_matches_plain_version_on_card(cuda, name):
    prob, span, y0, kw = CASES[name]
    y0 = torch.tensor(Y0[y0], device=cuda)
    before = solve_fused_adams_grid.launches
    k = solve_fused_adams_grid(RHS[prob], span, y0, **kw)
    assert solve_fused_adams_grid.launches == before + 1
    r = fused_adams_grid_reference(RHS[prob], span, y0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]


@pytest.mark.gpu
def test_overflow_member_isolated_on_card(cuda):
    span, kw = (0.0, 0.1), dict(TOL, k_max=4, max_steps=2000)
    y0 = torch.tensor(Y0["bad"], device=cuda)
    k = solve_fused_adams_grid(RHS["heat_cubic"], span, y0, **kw)
    r = fused_adams_grid_reference(RHS["heat_cubic"], span, y0, **kw)
    assert torch.equal(k[1], r[1]) and int(k[1][3]) == 3
    assert int((k[1] == 1).sum()) == B - 1


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda):
    before = solve_fused_adams_grid.launches
    y, status, nsteps, nfev = solve_fused_adams_grid(
        RHS["heat"], (0.0, 1.0), torch.zeros((0, N), device=cuda))
    assert y.shape == (0, N) and status.shape == (0,)
    assert solve_fused_adams_grid.launches == before


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_grid_rhs(cuda):
    with pytest.raises(TypeError, match="FusedGridRHS"):
        solve_fused_adams_grid(heat(N), (0.0, 1.0),
                               torch.tensor(Y0["heat"], device=cuda))
