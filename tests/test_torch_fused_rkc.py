"""The port's fused RKC path (B9, B10) against the JAX package's Pallas
kernels.

``fused_rkc_reference`` (the CUDA kernels' plain PyTorch version) runs on
the CPU; the JAX side runs ``solve_fused_rkc``/``solve_fused_rkc_ensemble``
with ``interpret=True``, as the JAX package's own tests run them, on the
same 2x16x16 Brusselator grids, in one subprocess with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` so that XLA, like PyTorch's CPU
operations, rounds every product on its own.  What remains between the two
is deliberate (ROADMAP C): ``sinh``/``cosh``/``pow`` where the Pallas
kernel takes ``exp``/``exp(log x / 3)``, selects where it blends, and the
order of the grid sums.  The gates are stated by each test.

The tests marked ``gpu`` hold the CUDA kernels against the plain version on
the card; they skip where there is none.  JAX is imported only by the
subprocess, so that the file also runs where only torch is installed
(``-m gpu --noconftest``).
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

from extensisq_tpu_torch import SSV2stab, parallel, solve, solve_ensemble
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRho,
                                     fused_rkc_reference, solve_fused_rkc,
                                     solve_fused_rkc_ensemble)
from extensisq_tpu_torch.ops import fused_rkc as FR

REPO = Path(__file__).resolve().parents[1]
NY, NX = 16, 16
ALPHA = 0.02
RHO = 8.0 * ALPHA * NX**2 + 2.0 + 3.0
RHO_ENS = 8.0 * ALPHA * NX**2 + 2.0 + 3.5
BRUS = parallel.brusselator_2d_grid((NY, NX), alpha=ALPHA)
BRUS_P = parallel.brusselator_2d_grid((NY, NX), B=None, alpha=ALPHA)
# a spectral-radius callback: the bound, growing with t
RHO_FN = FusedRho(lambda t, y, p=None: RHO * (1.0 + 0.1 * t),
                  f"__device__ float rho(float t, const float* y, "
                  f"const float* p) {{ return {RHO!r}f * "
                  "(1.0f + 0.1f * t); }")


def _grid0(amp=0.3):
    xg = np.linspace(0, 1, NX, endpoint=False)
    y0 = np.zeros((2, NY, NX), np.float32)
    y0[0] = 1.0 + amp * np.sin(2 * np.pi * xg)[None, :]
    y0[1] = 3.0
    return y0


Y0 = _grid0()
ENS0 = np.stack([_grid0(a) for a in (0.2, 0.3, 0.4, 0.5)])
BS = np.linspace(2.8, 3.5, 4).astype(np.float32)[:, None]
TOL = dict(rtol=1e-4, atol=1e-7)
# name -> (rho: "float" | "fn" | None, options); tests/test_fused_pallas.py
# :176-216, :1463-1493, and the stage cap of :218-256 forced by m_max
CASES = {
    "rho_float": ("float", dict(TOL)),
    "rho_callable": ("fn", dict(TOL)),
    "power": (None, dict(TOL)),
    "power_const_jac": (None, dict(TOL, const_jac=True)),
    "m_max": ("float", dict(TOL, m_max=2)),
    "max_step_first_step": ("float", dict(TOL, max_step=0.05,
                                          first_step=1e-3)),
}
ENS_CASES = {"ens_float": "float", "ens_power": None}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from extensisq_tpu.ops.fused_rkc import (roll, solve_fused_rkc,
                                             solve_fused_rkc_ensemble)

    NY, NX, ALPHA = 16, 16, 0.02
    dx = 1.0 / NX
    RHO = 8.0 * ALPHA / dx**2 + 2.0 + 3.0
    RHO_ENS = 8.0 * ALPHA / dx**2 + 2.0 + 3.5

    def fun(t, uv, B=3.0):
        lap = (roll(uv, 1, 1) + roll(uv, -1, 1)
               + roll(uv, 1, 2) + roll(uv, -1, 2) - 4.0 * uv) / dx ** 2
        u, v = uv[0], uv[1]
        uv2 = u * u * v
        return jnp.stack([1.0 + uv2 - (B + 1.0) * u + ALPHA * lap[0],
                          B * u - uv2 + ALPHA * lap[1]])

    def fun_p(t, uv, p):
        return fun(t, uv, p[0])

    rhos = {"float": RHO, "fn": lambda t, y: RHO * (1.0 + 0.1 * t),
            None: None}
    inputs = np.load(sys.argv[1])
    spec = json.loads(sys.argv[2])
    out = {}
    for name, (rho, kw) in spec["single"].items():
        res = solve_fused_rkc(fun, (0.0, 1.0), inputs["y0"], rhos[rho],
                              interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
    for name, rho in spec["ens"].items():
        res = solve_fused_rkc_ensemble(
            fun_p, (0.0, 1.0), inputs["ens0"],
            RHO_ENS if rho == "float" else None, params=inputs["bs"],
            interpret=True, rtol=1e-4, atol=1e-7)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The Pallas kernels' outputs for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_fused_rkc")
    np.savez(d / "in.npz", y0=Y0, ens0=ENS0, bs=BS)
    spec = {"single": {n: list(c) for n, c in CASES.items()},
            "ens": ENS_CASES}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=900)
    out = np.load(d / "out.npz")
    n = {name: 5 if c[0] is None else 4 for name, c in CASES.items()}
    n.update({name: 5 if r is None else 4 for name, r in ENS_CASES.items()})
    return {k: tuple(out[f"{k}/{i}"] for i in range(v)) for k, v in n.items()}


def _rho(kind, bound=RHO):
    return {"float": bound, "fn": RHO_FN, None: None}[kind]


def _single(name, **over):
    rho, kw = CASES[name]
    res = solve_fused_rkc(BRUS, (0.0, 1.0), torch.tensor(Y0), _rho(rho),
                          **dict(kw, **over))
    return tuple(r.numpy() for r in res)


def _ensemble(rho):
    res = solve_fused_rkc_ensemble(
        BRUS_P, (0.0, 1.0), torch.tensor(ENS0), _rho(rho, RHO_ENS),
        params=torch.tensor(BS), **TOL)
    return tuple(r.numpy() for r in res)


# case -> (max |dy|, max |dnsteps|, max |dnfev|, max |dnfesig|).  Measured
# on the CPU: status, nsteps, nfev and nfesig identical in every case and
# member; max |dy| 1.4e-6 (B9, 0 with first_step given: the difference
# starts in the starting step's grid sum), 1.2e-6 (m_max), 2.6e-6 and
# 2.3e-6 (B10).  The gates: identical counts, |dy| <= 5e-6.
GATES = {name: (5e-6, 0, 0, 0) for name in list(CASES) + list(ENS_CASES)}


def _check(port, ref, name):
    y_gate, dsteps, dfev, dsig = GATES[name]
    np.testing.assert_array_equal(port[1], ref[1])
    assert np.all(port[1] == 1)
    assert np.max(np.abs(port[0] - ref[0])) <= y_gate
    assert np.max(np.abs(port[2] - ref[2])) <= dsteps
    assert np.max(np.abs(port[3] - ref[3])) <= dfev
    if len(ref) == 5:
        assert np.max(np.abs(port[4] - ref[4])) <= dsig


@pytest.mark.parametrize("name", list(CASES))
def test_b9_reference_matches_pallas(jax_results, name):
    """B9: status, counts and y of the plain version against the Pallas
    kernel (interpret mode) within the gates of ``GATES``."""
    _check(_single(name), jax_results[name], name)


@pytest.mark.parametrize("name", list(ENS_CASES))
def test_b10_reference_matches_pallas(jax_results, name):
    """B10: four members with their own B (params), each against the
    Pallas ensemble kernel, within the gates of ``GATES``."""
    _check(_ensemble(ENS_CASES[name]), jax_results[name], name)


def test_ensemble_member_is_the_single_grid():
    """Each member of an ensemble takes the steps the single-grid solve
    takes on it alone: the batched plain version is the same arithmetic
    per member, up to the order of the grid sums, which PyTorch picks by
    the batch's shape (measured |dy| 1.3e-6; the gate is 5e-6)."""
    ens = _ensemble(None)
    for i in (0, 3):
        fun = parallel.brusselator_2d_grid((NY, NX), B=float(BS[i, 0]),
                                           alpha=ALPHA)
        one = solve_fused_rkc(fun, (0.0, 1.0), torch.tensor(ENS0[i]), None,
                              **TOL)
        assert np.max(np.abs(one[0].numpy() - ens[0][i])) <= 5e-6
        for k in range(1, 5):
            assert int(one[k]) == int(ens[k][i])


def test_matches_f64_driver():
    """tests/test_fused_pallas.py:176-216 at 16x16: within 1e-3 of the f64
    SSV2stab driver with the same bound, and with the power iteration
    (:1463-1493) within 2 steps of the f64 power-iteration run."""
    flat = parallel.brusselator_2d_rhs((NY, NX), alpha=ALPHA)
    y64 = torch.tensor(Y0.reshape(-1), dtype=torch.float64)
    out = solve(flat, (0.0, 1.0), y64, method=SSV2stab, rtol=1e-4, atol=1e-7,
                rho_jac=lambda t, y: RHO)
    y, st, ns, nf = _single("rho_float")
    assert int(st) == 1 and int(out.status) == 1
    assert np.max(np.abs(y.reshape(-1) - out.y.numpy())) < 1e-3
    y, st, ns, nf, nsig = _single("power")
    out = solve(flat, (0.0, 1.0), y64, method=SSV2stab, rtol=1e-4, atol=1e-7)
    assert abs(int(ns) - int(out.nsteps)) <= 2 and int(nsig) > 0
    assert np.max(np.abs(y.reshape(-1) - out.y.numpy())) < 1e-3


def test_ensemble_tracks_f64_ensemble():
    """tests/test_fused_pallas.py:337-399: the member ensemble's step
    counts within 2 of the f64 ensemble driver's."""
    flat_p = lambda t, y, b: BRUS_P.torch_fn(                # noqa: E731
        t, y.reshape(2, NY, NX, -1), b[None]).reshape(2 * NY * NX, -1)
    f64 = torch.float64
    out = solve_ensemble(flat_p, (0.0, 1.0),
                         torch.tensor(ENS0.reshape(4, -1), dtype=f64),
                         params_batch=torch.tensor(BS[:, 0], dtype=f64),
                         method=SSV2stab, rtol=1e-4, atol=1e-7,
                         rho_jac=lambda t, y: RHO_ENS)
    ens = _ensemble("float")
    assert np.all(ens[1] == 1) and torch.all(out.status == 1)
    assert np.max(np.abs(ens[2] - out.nsteps.numpy())) <= 2


def test_overflow_and_rho_fail_isolation():
    """A member whose state overflows float32 ends with status 3 and
    leaves the others unharmed; with the power iteration such a member
    cannot converge and ends with status 6 (RHO_FAIL)."""
    y0 = ENS0.copy()
    y0[2] *= 1e30
    for rho, bad in ((RHO_ENS, 3), (None, 6)):
        res = solve_fused_rkc_ensemble(BRUS_P, (0.0, 1.0), torch.tensor(y0),
                                       rho, params=torch.tensor(BS), **TOL)
        st = res[1].numpy()
        assert st[2] == bad and np.all(np.delete(st, 2) == 1)
        ok = _ensemble("float" if rho else None)
        np.testing.assert_array_equal(np.delete(res[0].numpy(), 2, 0),
                                      np.delete(ok[0], 2, 0))


def test_step_cap_and_backward_span():
    _, st, ns, _ = _single("rho_float", max_steps=3)
    assert int(st) == 3 and int(ns) <= 3
    heat = parallel.heat_2d_grid((8, 8), kappa=0.1)
    x = np.linspace(0, 1, 8, endpoint=False)
    u0 = np.sin(2 * np.pi * x)[None, :] * np.ones((8, 1), np.float32)
    # backward in time, the anti-diffusion -kappa lap u decays
    anti = FusedGridRHS(lambda t, u, p=None: -heat.torch_fn(t, u), "", (8, 8))
    y, st, ns, nf = solve_fused_rkc(anti, (1.0, 0.0),
                                    torch.tensor(u0, dtype=torch.float32),
                                    8 * 0.1 * 64 + 1.0, **TOL)
    exact = u0 * np.exp(-0.1 * 64 * 4 * np.sin(np.pi / 8) ** 2)
    assert int(st) == 1
    assert np.max(np.abs(y.numpy() - exact)) < 1e-3


def test_cpu_wrappers_run_plain_version():
    """On CPU tensors the wrappers run the plain version and launch no
    kernel; B9 returns 0-d counters."""
    before = (solve_fused_rkc.launches, solve_fused_rkc_ensemble.launches)
    ref = fused_rkc_reference(BRUS, (0.0, 1.0), torch.tensor(Y0[None]), RHO,
                              **TOL)
    out = solve_fused_rkc(BRUS.torch_fn, (0.0, 1.0), torch.tensor(Y0), RHO,
                          **TOL)
    assert out[1].ndim == 0 and len(out) == 4
    for a, b in zip(out, ref):
        assert torch.equal(a, b[0])
    assert (solve_fused_rkc.launches,
            solve_fused_rkc_ensemble.launches) == before


@pytest.mark.parametrize("option", ["t_eval", "events"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="B9"):
        solve_fused_rkc(BRUS, (0.0, 1.0), torch.tensor(Y0), RHO,
                        **{option: 1})
    with pytest.raises(NotImplementedError, match="B10"):
        solve_fused_rkc_ensemble(BRUS, (0.0, 1.0), torch.tensor(ENS0), RHO,
                                 **{option: 1})


def test_mmax_and_stage_table():
    """The stage cap of the JAX kernel (double-single u, hard cap 200), and
    the coefficient table: the stage time fractions rise to ~1 at j = m."""
    assert FR._mmax_for(1e-4, None)[0] == 200
    assert FR._mmax_for(1e-10, None)[0] == 27
    assert FR._mmax_for(1e-4, 7)[0] == 7
    tab = FR._stage_table(20)
    assert tab.shape == (21, 5) and tab.dtype == torch.float32
    th = tab[2:, 4].numpy()
    assert np.all(np.diff(th) > 0) and 0.5 < th[-1] < 1.0


def test_generated_header():
    """The kernel's header carries the grid as a Grid<...> type, the
    element and parameter counts, the float32 constants as the JAX kernel
    rounds them, and the user's sources."""
    from extensisq_tpu_torch.ops import _build
    text = _build.fused_rkc_header((2, 16, 32), 1, BRUS_P.cuda_src,
                                   RHO_FN.cuda_src)
    assert "using G = grid::Grid<2, 16, 32>;" in text
    assert "constexpr int NTOT = 1024;" in text
    assert "constexpr int NPAR = 1;" in text
    assert BRUS_P.cuda_src in text and RHO_FN.cuda_src in text
    k = FR._rkc_consts()
    eps = float(np.finfo(np.float32).eps)
    assert k["hmin_c"] == float(np.float32(13.3 * eps * eps))
    assert k["sqrtu"] == float(np.float32(np.sqrt(eps)))
    stub = _build.fused_rkc_header((4,), 0, "src")
    assert "__device__ float rho(" in stub


def test_build_key_hashes_rkc_headers(monkeypatch, tmp_path):
    """The kernel's build key covers ds.cuh, grid_common.cuh,
    block_group.cuh (B10's thread-block group, shared with the mid-size
    kernels) and rk_common.cuh (whose NaN-keeping minimum block_group.cuh
    takes), which it includes, and no other shared header."""
    import shutil
    from extensisq_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.shared_headers("fused_rkc")] == [
        "ds.cuh", "grid_common.cuh", "block_group.cuh", "rk_common.cuh"]
    before = _build.build_key("fused_rkc", "header")
    for name in ("ds.cuh", "grid_common.cuh", "block_group.cuh",
                 "rk_common.cuh"):
        f = csrc / name
        f.write_text(f.read_text() + "\n// edited\n")
        after = _build.build_key("fused_rkc", "header")
        assert after != before
        before = after
    dual = csrc / "dual.cuh"
    dual.write_text(dual.read_text() + "\n// edited\n")
    assert _build.build_key("fused_rkc", "header") == before


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_b9_kernel_matches_plain_version_on_card(cuda, name):
    """B9 on the card against its plain version: the same status, y within
    1e-4 (float32 round-off, the kernel contracts to FMA and sums the grid
    in another order)."""
    rho, kw = CASES[name]
    y0 = torch.tensor(Y0, device=cuda)
    before = solve_fused_rkc.launches
    k = solve_fused_rkc(BRUS, (0.0, 1.0), y0, _rho(rho), **kw)
    assert solve_fused_rkc.launches == before + 1
    r = fused_rkc_reference(BRUS, (0.0, 1.0), y0[None], _rho(rho), **kw)
    torch.cuda.synchronize()
    assert int(k[1]) == int(r[1][0])
    assert (k[0] - r[0][0]).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ENS_CASES))
def test_b10_kernel_matches_plain_version_on_card(cuda, name):
    rho = _rho(ENS_CASES[name], RHO_ENS)
    y0 = torch.tensor(ENS0, device=cuda)
    p = torch.tensor(BS, device=cuda)
    before = solve_fused_rkc_ensemble.launches
    k = solve_fused_rkc_ensemble(BRUS_P, (0.0, 1.0), y0, rho, params=p, **TOL)
    assert solve_fused_rkc_ensemble.launches == before + 1
    r = fused_rkc_reference(BRUS_P, (0.0, 1.0), y0, rho, params=p, **TOL)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    assert (k[0] - r[0]).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_cuda_tensor_needs_grid_rhs(cuda):
    with pytest.raises(TypeError, match="FusedGridRHS"):
        solve_fused_rkc(BRUS.torch_fn, (0.0, 1.0),
                        torch.tensor(Y0, device=cuda), RHO)
    with pytest.raises(TypeError, match="FusedRho"):
        solve_fused_rkc(BRUS, (0.0, 1.0), torch.tensor(Y0, device=cuda),
                        lambda t, y: RHO)
