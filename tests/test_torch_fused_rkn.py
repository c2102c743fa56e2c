"""The port's fused RKN paths (B5 and B6) against the JAX package's Pallas
kernels.

``fused_rkn_reference`` and ``fused_rkn_grid_reference`` (the CUDA
kernels' plain PyTorch versions) run on the CPU; the JAX side runs
``solve_fused_rkn``/``solve_fused_rkn_grid(..., interpret=True)`` as the
JAX package's own tests run them, on the same seeded inputs, in one
subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no FMA, so both
sides round alike; see ``test_torch_fused_erk.py``).  The first attempt of
each member is then bit for bit the same; from the second on, XLA's and
PyTorch's float32 ``pow`` in the controller (and, without ``first_step``,
``log10``/``pow`` against ``log``/``exp`` in the starting step, and the
Kepler acceleration's ``sqrt`` and division) part the last bits of h.
Where ``first_step`` is given and no accept decision sits that close, the
counts stay identical; elsewhere the gates below, measured with a margin,
allow for the parting.  The grid cases use n = 100 positions, which the
JAX kernel pads to 128 lanes and the port takes as they are.

The tests marked ``gpu`` hold the CUDA kernels against their plain
versions on the card; they skip where there is none.
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

from extensisq_tpu_torch import Fi4N, Fi5N, MR6NN, Mu5Nmb
from extensisq_tpu_torch.ops import (FusedAcc, FusedGridAcc,
                                     fused_rkn_grid_reference,
                                     fused_rkn_reference, solve_fused_rkn,
                                     solve_fused_rkn_grid)

REPO = Path(__file__).resolve().parents[1]
B = 128
B_GRID = 8
N_GRID = 100
METHODS = {"Fi4N": Fi4N, "Fi5N": Fi5N, "Mu5Nmb": Mu5Nmb, "MR6NN": MR6NN}


def kepler(t, u, v):
    r2 = u[0] ** 2 + u[1] ** 2
    a = -1.0 / (r2 * torch.sqrt(r2))
    return torch.stack([a * u[0], a * u[1]])


def duffing(t, u, v):
    return -u - 0.5 * u ** 3 - 0.1 * v


def cubic(t, u, v):
    return u ** 3


def wave(t, u, v):
    return 400.0 * (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) - 2.0 * u)


def wave_cubic(t, u, v):
    return wave(t, u, v) + u ** 3


KEPLER = FusedAcc(kepler, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  const T r2 = u[0] * u[0] + u[1] * u[1];
  const T s = -1.0f / (r2 * sqrtf(r2));
  a[0] = s * u[0];
  a[1] = s * u[1];
}""", 2)
WAVE_CUDA = """__device__ float acc(float t, const float* u, const float* v,
                    int i, const float* p) {
  using G = tab::G;
  return 400.0f * (G::rolled<0>(u, i, 1) + G::rolled<0>(u, i, -1)
                   - 2.0f * u[i]);
}"""
WAVE = FusedGridAcc(wave, WAVE_CUDA, N_GRID)
CARD_PROBLEMS = {
    "kepler": KEPLER, "wave": WAVE,
    "duffing": FusedAcc(duffing, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  for (int k = 0; k < 2; ++k) a[k] = -u[k] - 0.5f * u[k] * u[k] * u[k]
                                     - 0.1f * v[k];
}""", 2),
    "cubic": FusedAcc(cubic, """__device__ void acc(float t, const float* u,
                    const float* v, float* a) {
  a[0] = u[0] * u[0] * u[0];
}""", 1),
    "wave_cubic": FusedGridAcc(wave_cubic, WAVE_CUDA.replace(
        "- 2.0f * u[i]);", "- 2.0f * u[i]) + u[i] * u[i] * u[i];"), N_GRID),
}
PROBLEMS = {"kepler": kepler, "cubic": cubic, "duffing": duffing, "wave": wave,
            "wave_cubic": wave_cubic}


def _inputs():
    ecc = np.linspace(0.1, 0.7, B)
    kep = np.stack([1 - ecc, np.zeros(B), np.zeros(B),
                    np.sqrt((1 + ecc) / (1 - ecc))], axis=1).astype(np.float32)
    u0 = np.full(B, 0.1, np.float32)
    u0[7] = 1e18                      # this member blows up in f32
    cub = np.stack([u0, np.zeros(B, np.float32)], axis=1)
    x = np.linspace(0, 1, N_GRID, endpoint=False)
    amps = np.linspace(0.5, 1.5, B_GRID)
    wu = amps[:, None] * np.sin(2 * np.pi * x)[None, :]
    wav = np.concatenate([wu, np.zeros_like(wu)], axis=1).astype(np.float32)
    wcub = wav.copy()
    wcub[3, :N_GRID] *= 1e13          # this member blows up in f32
    duf = np.stack([np.linspace(0.5, 2.0, B), np.linspace(-1.0, 1.0, B),
                    np.zeros(B), np.linspace(0.5, -0.5, B)],
                   axis=1).astype(np.float32)
    return kep, cub, wav, wcub, duf


KEP0, CUB0, WAVE0, WCUB0, DUF0 = _inputs()
# name -> (kernel, problem, method, span, y0, options)
CASES = {
    "kepler_plain": ("flat", "kepler", "Fi5N", (0.0, 2 * np.pi), KEP0,
                     dict(rtol=1e-5, atol=1e-7)),
    "kepler_comp": ("flat", "kepler", "Fi5N", (0.0, 2 * np.pi), KEP0,
                    dict(rtol=1e-7, atol=1e-9, compensated=True)),
    "kepler_mr6nn_back": ("flat", "kepler", "MR6NN", (2 * np.pi, 0.0), KEP0,
                          dict(rtol=1e-5, atol=1e-7)),
    "duffing_fi4n_h0": ("flat", "duffing", "Fi4N", (0.0, 5.0), DUF0,
                        dict(rtol=1e-5, atol=1e-7, first_step=0.01)),
    "duffing_fi5n_back_h0": ("flat", "duffing", "Fi5N", (5.0, 0.0), DUF0,
                             dict(rtol=1e-5, atol=1e-7, first_step=0.01)),
    "duffing_mu5nmb_comp_h0": ("flat", "duffing", "Mu5Nmb", (0.0, 5.0),
                               DUF0, dict(rtol=1e-6, atol=1e-9,
                                          first_step=0.01, compensated=True)),
    "overflow": ("flat", "cubic", "Fi5N", (0.0, 1.0), CUB0,
                 dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
    "wave_h0": ("grid", "wave", "Fi5N", (0.0, 1.0), WAVE0,
                dict(rtol=1e-5, atol=1e-7, first_step=0.05)),
    "wave_comp": ("grid", "wave", "Fi5N", (0.0, 1.0), WAVE0,
                  dict(rtol=1e-6, atol=1e-9, compensated=True)),
    "wave_mr6nn_back_h0": ("grid", "wave", "MR6NN", (1.0, 0.0), WAVE0,
                           dict(rtol=1e-5, atol=1e-7, first_step=0.05)),
    "wave_overflow": ("grid", "wave_cubic", "Fi5N", (0.0, 0.5), WCUB0,
                      dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
}

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.ops import solve_fused_rkn, solve_fused_rkn_grid

    def kepler(t, u, v):
        r2 = u[0] ** 2 + u[1] ** 2
        a = -1.0 / (r2 * jnp.sqrt(r2))
        return jnp.stack([a * u[0], a * u[1]])

    def wave(t, u, v):
        return 400.0 * (jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1) - 2.0 * u)

    problems = {"kepler": kepler, "cubic": lambda t, u, v: u ** 3,
                "wave": wave,
                "duffing": lambda t, u, v: -u - 0.5 * u ** 3 - 0.1 * v,
                "wave_cubic": lambda t, u, v: wave(t, u, v) + u ** 3}
    inputs = np.load(sys.argv[1])
    out = {}
    for name, (kind, prob, meth, span, kw) in json.loads(
            sys.argv[2]).items():
        if kind == "flat":
            res = solve_fused_rkn(problems[prob], tuple(span), inputs[name],
                                  method=getattr(X, meth), block_members=128,
                                  interpret=True, **kw)
        else:
            res = solve_fused_rkn_grid(problems[prob], tuple(span),
                                       inputs[name], method=getattr(X, meth),
                                       block_members=8, interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX kernels' outputs for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_fused_rkn")
    np.savez(d / "in.npz", **{k: v[4] for k, v in CASES.items()})
    spec = {k: [v[0], v[1], v[2], v[3], v[5]] for k, v in CASES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=600)
    out = np.load(d / "out.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in CASES}


def _port(name, **over):
    kind, prob, meth, span, y0, kw = CASES[name]
    ref = fused_rkn_reference if kind == "flat" else fused_rkn_grid_reference
    res = ref(PROBLEMS[prob], span, torch.tensor(y0), method=METHODS[meth],
              **dict(kw, **over))
    return tuple(r.numpy() for r in res)



def _port(name, **over):
    kind, prob, meth, span, y0, kw = CASES[name]
    ref = fused_rkn_reference if kind == "flat" else fused_rkn_grid_reference
    res = ref(PROBLEMS[prob], span, torch.tensor(y0), method=METHODS[meth],
              **dict(kw, **over))
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference), measured on the CPU: kepler_plain 2.2e-4, 1, 18, 11;
# kepler_comp 3.8e-5, 1, 18, 84; kepler_mr6nn_back 1.6e-4, 1, 16, 26;
# duffing_fi5n_back_h0 5.4e-6, 1, 6, 2; wave_comp 1.7e-5, 1, 6, 4.  The
# gates add a margin of about 2x.
GATES = [
    ("kepler_plain", 5e-4, 2, 36, 24),
    ("kepler_comp", 1e-4, 2, 36, 110),
    ("kepler_mr6nn_back", 4e-4, 2, 32, 52),
    ("duffing_fi5n_back_h0", 1e-5, 2, 12, 4),
    ("wave_comp", 5e-5, 2, 12, 6),
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


# measured |dy|: duffing_fi4n_h0 1.8e-6 (Fi4N, non-FSAL), wave_h0 4.0e-5,
# wave_mr6nn_back_h0 1.3e-5 (MR6NN, non-FSAL, backward); gates about 2.5x
@pytest.mark.parametrize("name,y_gate", [("duffing_fi4n_h0", 5e-6),
                                         ("wave_h0", 1e-4),
                                         ("wave_mr6nn_back_h0", 5e-5)])
def test_first_step_counts_identical(jax_results, name, y_gate):
    """With ``first_step`` given, every member takes the JAX kernel's
    steps: status, nsteps and nfev identical (a non-FSAL pair pays one
    endpoint evaluation per accepted step)."""
    y, status, nsteps, nfev = _port(name)
    jy, jstatus, jnsteps, jnfev = jax_results[name]
    assert np.all(status == 1)
    np.testing.assert_array_equal(status, jstatus)
    np.testing.assert_array_equal(nsteps, jnsteps)
    np.testing.assert_array_equal(nfev, jnfev)
    assert np.max(np.abs(y - jy)) <= y_gate


def test_mu5nmb_fused_is_undamped_like_jax_kernel(jax_results):
    """The fused kernels use Mu5Nmb's E/Ep as the tableau has them, as the
    JAX kernels do (the stepper damps them by 0.75).  Undamped at rtol
    1e-6 the pair rejects often and its members' step sequences part on
    last bits (121 of 128 members take other counts), but not in the mean:
    measured 133.7 against 137.4 mean steps (2.7%, gate 6%) and |dy|
    9.5e-7 (gate 3e-6)."""
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts
    k = rkn_consts(Mu5Nmb)
    np.testing.assert_array_equal(k["E"], np.float32(Mu5Nmb.tableau.E))
    np.testing.assert_array_equal(k["Ep"], np.float32(Mu5Nmb.tableau.Ep))
    y, status, nsteps, nfev = _port("duffing_mu5nmb_comp_h0")
    jy, jstatus, jnsteps, jnfev = jax_results["duffing_mu5nmb_comp_h0"]
    assert np.all(status == 1) and np.all(jstatus == 1)
    assert abs(nsteps.mean() / jnsteps.mean() - 1.0) <= 0.06
    assert np.max(np.abs(y - jy)) <= 3e-6


@pytest.mark.parametrize("name,bad", [("overflow", 7), ("wave_overflow", 3)])
def test_overflow_member_isolated(jax_results, name, bad):
    """A diverging member ends with status 3 and does not poison its
    neighbours; the others take the JAX kernel's steps (measured |dy| 0
    and 1.8e-5 on the wave, gate 5e-5)."""
    y, status, nsteps, nfev = _port(name)
    jy, jstatus, jnsteps, jnfev = jax_results[name]
    assert status[bad] == 3
    assert np.sum(status == 1) == len(status) - 1
    np.testing.assert_array_equal(status, jstatus)
    ok = status == 1
    assert np.all(np.isfinite(y[ok]))
    np.testing.assert_array_equal(nsteps[ok], jnsteps[ok])
    np.testing.assert_array_equal(nfev[ok], jnfev[ok])
    assert np.max(np.abs(y[ok] - jy[ok])) <= 5e-5


def test_nonfsal_nfev_counts_accepted_endpoints():
    """Fi4N (zero Ep tail) pays s - 1 = 4 evaluations per attempt and one
    endpoint evaluation per accepted step; the in-kernel start costs
    2 + min(2m + 1, 3) = 5; max_steps caps attempts with status 3."""
    y0 = torch.tensor(KEP0[:16])
    y, status, nsteps, nfev = fused_rkn_reference(
        KEPLER, (0.0, 2 * np.pi), y0, method=Fi4N, rtol=1e-5, atol=1e-7,
        max_steps=12)
    assert torch.all(status == 3)
    torch.testing.assert_close(nfev, 5 + 4 * 12 + nsteps, rtol=0, atol=0)


def test_wave_endpoint_tracks_the_f64_driver():
    """The JAX test's wave gate at n = 100: the plain grid version in f32
    against the f64 ``solve_ensemble`` on the first-order form, endpoints
    within 5e-3 and mean nsteps within 10% + 2 (first_step pinned on both
    sides, as there)."""
    from extensisq_tpu_torch import solve_ensemble

    def first_order(t, y):
        return torch.cat([y[N_GRID:], wave(t, y[:N_GRID], y[N_GRID:])])

    y, status, nsteps, _ = _port("wave_h0")
    ref = solve_ensemble(first_order, (0.0, 1.0),
                         torch.tensor(WAVE0, dtype=torch.float64),
                         method=Fi5N, rtol=1e-5, atol=1e-7, first_step=0.05)
    assert np.all(status == 1) and bool((ref.status == 1).all())
    assert np.max(np.abs(y - ref.y.numpy())) < 5e-3
    mean64 = ref.nsteps.double().mean().item()
    assert abs(nsteps.mean() - mean64) < 0.1 * mean64 + 2.0


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors the wrappers run the plain versions, with a FusedAcc/
    FusedGridAcc or a bare torch function, and launch no kernel."""
    for solve_fn, ref_fn, fun, name in (
            (solve_fused_rkn, fused_rkn_reference, KEPLER, "kepler_plain"),
            (solve_fused_rkn_grid, fused_rkn_grid_reference, WAVE,
             "wave_h0")):
        _, _, meth, span, y0, kw = CASES[name]
        before = solve_fn.launches
        ref = ref_fn(fun, span, torch.tensor(y0[:8]), **kw)
        for f in (fun, fun.torch_fn):
            out = solve_fn(f, span, torch.tensor(y0[:8]), method=Fi5N, **kw)
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
        assert solve_fn.launches == before


@pytest.mark.parametrize("option", ["t_eval", "events", "params", "dense"])
@pytest.mark.parametrize("solve_fn", [solve_fused_rkn, solve_fused_rkn_grid])
def test_unported_options_raise(solve_fn, option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_fn(kepler, (0.0, 1.0), torch.tensor(KEP0), **{option: 1})


def test_odd_state_and_other_families_raise():
    with pytest.raises(ValueError, match="even length"):
        fused_rkn_reference(kepler, (0.0, 1.0), torch.ones(4, 3))
    from extensisq_tpu_torch import BS5
    with pytest.raises(NotImplementedError, match="Nystrom"):
        fused_rkn_reference(kepler, (0.0, 1.0), torch.tensor(KEP0),
                            method=BS5)


def _floats(text, name):
    """The float32 values of the generated accessor ``name``: its nonzero
    literals and the index tests that select them."""
    import re
    body = re.search(rf"constexpr float {name}\(([^)]*)\) {{\n  return "
                     rf"(.*?);\n}}", text, re.S).group(2)
    return {tuple(int(v) for v in re.findall(r"== (\d+)", cond)):
            float.fromhex(lit[:-1])
            for cond, lit in re.findall(r"\(?([^?]*?)\)? \? (\S+f) :",
                                        body)}


@pytest.mark.parametrize("method", [Fi4N, Fi5N, Mu5Nmb, MR6NN],
                         ids=lambda m: m.name)
def test_generated_headers_hold_float32_tableau(method):
    """The RKN kernels' headers carry every nonzero weight rounded to
    float32 as the JAX kernel rounds it, at its index, and the user's
    source."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts
    k = rkn_consts(method)
    for text in (_build.fused_rkn_header(k, 2, KEPLER.cuda_src),
                 _build.fused_rk_grid_header(k, True, (N_GRID,), WAVE_CUDA)):
        assert f"constexpr int S = {k['s']};" in text
        assert f"constexpr bool FSAL = {str(k['fsal']).lower()};" in text
        for name, key in (("A", "A"), ("AP", "Ap"), ("B", "B"), ("BP", "Bp"),
                          ("C", "C"), ("E", "E"), ("EP", "Ep")):
            ref = np.asarray(k[key], np.float32)
            got = np.zeros_like(ref)
            for idx, v in _floats(text, name).items():
                got[idx] = v
            np.testing.assert_array_equal(got, ref, err_msg=name)
    assert WAVE_CUDA in text and "float rhs(" in text   # the stub


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CPU fallback: where the CUDA toolkit is missing, building either
    kernel raises before anything is written."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_fused_rkn(rkn_consts(Fi5N), 2, KEPLER.cuda_src)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_fused_rk_grid(rkn_consts(Fi5N), True, (N_GRID,),
                                  WAVE_CUDA)
    assert not (tmp_path / "build").exists()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# kernel against its plain version on the same card: status identical,
# |dy| over finished members within the gates chip_smoke.py measured
CARD_GATES = {"kepler_plain": 2e-3, "kepler_comp": 1e-4,
              "kepler_mr6nn_back": 2e-3, "duffing_fi4n_h0": 1e-4,
              "duffing_mu5nmb_comp_h0": 1e-4, "overflow": 1e-6,
              "wave_h0": 1e-3, "wave_comp": 1e-4,
              "wave_mr6nn_back_h0": 1e-3, "wave_overflow": 1e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_kernel_matches_plain_version_on_card(cuda, name):
    kind, prob, meth, span, y0, kw = CASES[name]
    fun = CARD_PROBLEMS[prob]
    y0 = torch.tensor(y0, device=cuda)
    solve_fn = solve_fused_rkn if kind == "flat" else solve_fused_rkn_grid
    ref_fn = (fused_rkn_reference if kind == "flat"
              else fused_rkn_grid_reference)
    before = solve_fn.launches
    k = solve_fn(fun, span, y0, method=METHODS[meth], **kw)
    assert solve_fn.launches == before + 1
    r = ref_fn(fun, span, y0, method=METHODS[meth], **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kepler", "wave"])
def test_empty_batch_launches_nothing(cuda, name):
    fun = CARD_PROBLEMS[name]
    solve_fn = solve_fused_rkn if name == "kepler" else solve_fused_rkn_grid
    width = 2 * (fun.m if name == "kepler" else fun.n)
    before = solve_fn.launches
    y, status, nsteps, nfev = solve_fn(
        fun, (0.0, 1.0), torch.zeros((0, width), device=cuda))
    assert y.shape == (0, width) and status.shape == (0,)
    assert solve_fn.launches == before


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_acc(cuda):
    y0 = torch.tensor(KEP0, device=cuda)
    with pytest.raises(TypeError, match="FusedAcc"):
        solve_fused_rkn(kepler, (0.0, 1.0), y0)
    with pytest.raises(TypeError, match="FusedGridAcc"):
        solve_fused_rkn_grid(wave, (0.0, 1.0), torch.tensor(WAVE0,
                                                             device=cuda))


def test_build_keys_hash_the_included_headers(monkeypatch, tmp_path):
    """Each new kernel's build key covers the shared headers it includes
    (directly or through another), and changes when one of them does."""
    import shutil
    from extensisq_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    expect = {"fused_rkn": ["rk_common.cuh", "hstart.cuh",
                            "rk_control.cuh", "rk_rows.cuh"],
              "fused_rk_grid": ["grid_common.cuh", "rk_common.cuh",
                                "rk_control.cuh", "rk_rows.cuh",
                                "block_group.cuh"]}
    for name, headers in expect.items():
        assert [p.name for p in _build.shared_headers(name)] == headers
        before = _build.build_key(name, "header")
        for h in headers:
            f = csrc / h
            f.write_text(f.read_text() + "\n// edited\n")
            after = _build.build_key(name, "header")
            assert after != before
            before = after
