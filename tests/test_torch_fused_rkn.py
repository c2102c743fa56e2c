"""The port's fused RKN paths (B5 and B6) against the JAX package's Pallas
kernels.

``fused_rkn_reference`` and ``fused_rkn_grid_reference`` (the CUDA
kernels' plain PyTorch versions) run on the CPU; the JAX side runs
``solve_fused_rkn``/``solve_fused_rkn_grid(..., interpret=True)`` as the
JAX package's own tests run them, on the same seeded inputs, with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no FMA, so both sides round
alike; see ``test_torch_fused_erk.py``), its outputs written to
``tests/jax_fused_rkn.npz`` by ``tests/jax_fused_rkn.py``.  The first attempt of
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

@pytest.fixture(scope="module")
def jax_results():
    """The JAX kernels' outputs for every case, from
    ``tests/jax_fused_rkn.npz`` (``tests/jax_fused_rkn.py`` writes it)."""
    out = np.load(REPO / "tests" / "jax_fused_rkn.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in CASES}


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


@pytest.mark.parametrize("option", ["events"])
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


@pytest.mark.parametrize("members,n,shape", [
    (64, 256, (256, 0)), (264, 256, (256, 0)), (265, 256, (128, 0)),
    (512, 256, (128, 0)), (529, 256, (32, 4)), (1024, 256, (32, 4)),
    (8, 100, (128, 0)), (300, 100, (64, 0)), (8, 20, (32, 0)),
    (64, 512, (256, 0)), (1024, 512, (256, 0)), (1024, 1024, (256, 0))])
def test_launch_shape_on_132_sms(members, n, shape):
    """B6's launch shape on the H100's 132 SMs: one block of
    ``grid_threads(n)`` threads per member up to 2 members an SM, of two
    positions a thread up to 4, one warp per member (four a block) beyond
    where n is at most 256, else blocks of two positions a thread."""
    from extensisq_tpu_torch.ops.fused_rkn_grid import _launch_shape
    assert _launch_shape(members, n, 132) == shape


@pytest.mark.parametrize("members,m,lanes", [
    (512, 2, 8), (2048, 2, 8), (2112, 2, 8), (2113, 2, 4), (4096, 2, 4),
    (4224, 2, 4), (4225, 2, 1), (16384, 2, 1), (262144, 2, 1), (512, 1, 8),
    (512, 3, 1), (2048, 14, 1)])
def test_lanes_per_member_on_132_sms(members, m, lanes):
    """B5's rule on the H100's 132 SMs: at m <= 2 positions the largest of
    8 and 4 lanes with members x lanes <= 128 x 132, else one thread per
    member."""
    from extensisq_tpu_torch.ops.fused_rkn import _lanes_per_member
    assert _lanes_per_member(members, 132, m) == lanes


FLAT_CARD_CASES = [k for k in CARD_GATES if CASES[k][0] == "flat"]


def _flat_args(name, cuda):
    kind, prob, meth, span, y0, kw = CASES[name]
    return (CARD_PROBLEMS[prob], span, torch.tensor(y0, device=cuda),
            METHODS[meth], kw["rtol"], kw["atol"], kw.get("first_step"),
            kw.get("max_steps", 100_000), kw.get("compensated", False), None)


@pytest.mark.gpu
@pytest.mark.parametrize("name", FLAT_CARD_CASES)
def test_lane_bodies_bit_identical_to_one_thread_on_card(cuda, name):
    """B5 forced to 2, 4 and 8 lanes a member (128 / G members a block):
    bit for bit the one-thread body, and against the plain version at the
    card gates (the overflowing member ends alone with status 3).
    Comparison launches are not counted."""
    from extensisq_tpu_torch.ops import fused_rkn as FN
    args = _flat_args(name, cuda)
    before = solve_fused_rkn.launches
    one, shape = FN._launch(*args, 1)
    assert shape == (1, 128)
    kind, prob, meth, span, _, kw = CASES[name]
    r = fused_rkn_reference(args[0], span, args[2], method=args[3], **kw)
    for lanes in (2, 4, 8):
        k, shape = FN._launch(*args, lanes)
        assert shape == (lanes, 128 // lanes)
        for a, b in zip(k, one):
            assert torch.equal(a, b)
        assert torch.equal(k[1], r[1])
        ok = r[1] == 1
        assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]
    assert solve_fused_rkn.launches == before


@pytest.mark.gpu
def test_flat_wrapper_takes_the_rules_shape_on_card(cuda):
    """solve_fused_rkn launches its rule's shape for the card's SM count
    and records it in last_shape; an explicit block_members of more than
    1024 threads at the lanes taken raises before any launch."""
    from extensisq_tpu_torch.ops import fused_rkn as FN
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    kind, prob, meth, span, y0, kw = CASES["kepler_plain"]
    for y in (y0, np.repeat(y0, 40, axis=0)):
        solve_fused_rkn(KEPLER, span, torch.tensor(y, device=cuda),
                        method=METHODS[meth], **kw)
        g = FN._lanes_per_member(len(y), sms, KEPLER.m)
        assert solve_fused_rkn.last_shape == (g, 128 // g)
    before = solve_fused_rkn.launches
    with pytest.raises(ValueError, match="at most 1024"):
        FN._launch(*_flat_args("kepler_plain", cuda), 8, 256)
    with pytest.raises(ValueError, match="at most 1024"):
        solve_fused_rkn(KEPLER, span, torch.tensor(y0, device=cuda),
                        method=METHODS[meth], block_members=1025, **kw)
    assert solve_fused_rkn.launches == before


GRID_CARD_CASES = [k for k, v in CASES.items() if v[0] == "grid"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", GRID_CARD_CASES)
def test_rule_shapes_bit_identical_to_block_of_32_on_card(cuda, name):
    """B6 at each shape its rule can take: one warp per member (four
    members a block, also with a ragged last block) bit for bit against
    one block of 32 threads per member; the warp and the blocks of one
    and of two positions a thread against the plain version at the card
    gates.  Comparison launches are not counted."""
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    from extensisq_tpu_torch.ops.fused_erk_grid import grid_threads
    kind, prob, meth, span, y0, kw = CASES[name]
    fun = CARD_PROBLEMS[prob]
    y0 = torch.tensor(y0, device=cuda)
    built = FNG._kernel(METHODS[meth], fun)
    before = solve_fused_rkn_grid.launches
    for ys in (y0, y0[:7]):
        block, _ = FNG._launch(built, span, ys, fun.n, shape=(32, 0), **kw)
        warp, _ = FNG._launch(built, span, ys, fun.n,
                              shape=(32, FNG.WARP_MEMBERS), **kw)
        for a, b in zip(warp, block):
            assert torch.equal(a, b)
    r = fused_rkn_grid_reference(fun, span, y0, method=METHODS[meth], **kw)
    for shape in {(32, FNG.WARP_MEMBERS), (grid_threads(-(-fun.n // 2)), 0),
                  (grid_threads(fun.n), 0)}:
        k, _ = FNG._launch(built, span, y0, fun.n, shape=shape, **kw)
        assert torch.equal(k[1], r[1])
        ok = r[1] == 1
        assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]
    assert solve_fused_rkn_grid.launches == before


@pytest.mark.gpu
def test_wrapper_takes_the_rules_launch_shape_on_card(cuda):
    """solve_fused_rkn_grid launches its rule's shape for the card's SM
    count: a block at 16 members, the warp body past 4 members an SM,
    where its outputs equal one block of 32 threads per member."""
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    x = np.linspace(0, 1, N_GRID, endpoint=False)
    kw = dict(rtol=1e-5, atol=1e-7, first_step=0.05)
    for members in (16, FNG.WARP_FROM * sms + 1):
        u0 = (np.linspace(0.5, 1.5, members)[:, None]
              * np.sin(2 * np.pi * x)[None, :])
        y0 = torch.tensor(np.concatenate([u0, np.zeros_like(u0)], 1),
                          dtype=torch.float32, device=cuda)
        out = solve_fused_rkn_grid(WAVE, (0.0, 0.2), y0, method=Fi5N, **kw)
        shape = FNG._launch_shape(members, N_GRID, sms)
        assert solve_fused_rkn_grid.last_shape == shape
        assert bool((out[1] == 1).all())
        if shape[0] == 32:
            ref, _ = FNG._launch(FNG._kernel(Fi5N, WAVE), (0.0, 0.2), y0,
                                 N_GRID, shape=(32, 0), **kw)
            for a, b in zip(out, ref):
                assert torch.equal(a, b)


def test_build_keys_hash_the_included_headers(monkeypatch, tmp_path):
    """Each new kernel's build key covers the shared headers it includes
    (directly or through another), and changes when one of them does."""
    import shutil
    from extensisq_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    expect = {"fused_rkn": ["dense_record.cuh", "rk_common.cuh",
                            "snapshot.cuh", "hstart.cuh", "rk_control.cuh",
                            "rk_lanes.cuh", "rk_rows.cuh", "lane_group.cuh"],
              "fused_rk_grid": ["grid_common.cuh", "dense_record.cuh",
                                "rk_common.cuh", "rk_control.cuh",
                                "rk_rows.cuh", "block_rows.cuh",
                                "ck_control.cuh", "block_hstart.cuh",
                                "snapshot.cuh", "block_group.cuh"]}
    for name, headers in expect.items():
        assert [p.name for p in _build.shared_headers(name)] == headers
        before = _build.build_key(name, "header")
        for h in headers:
            f = csrc / h
            f.write_text(f.read_text() + "\n// edited\n")
            after = _build.build_key(name, "header")
            assert after != before
            before = after
