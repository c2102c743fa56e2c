"""The port's fused CKdisc paths (B11 and B12) against the JAX package's
Pallas kernels.

``fused_ckdisc_reference`` and ``fused_ckdisc_grid_reference`` (the CUDA
kernels' plain PyTorch versions) run on the CPU; the JAX side,
``solve_fused_ckdisc``/``solve_fused_ckdisc_grid(..., interpret=True)`` as
the JAX package's own tests run them, on the same seeded inputs, with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no FMA, so both sides round alike;
see ``test_torch_fused_erk.py``), is read from
``tests/jax_fused_ckdisc.npz``, which ``tests/jax_fused_ckdisc.py`` writes
from this module's cases.  The first attempt of
each member is then bit for bit the same.  From the second on, the roots of
E2 and E4 part the last bits of h: the port takes ``pow`` where the JAX
kernel takes ``exp(log(x) / 3)`` and ``exp(0.2 log(x))`` (a Mosaic
workaround left out), and PyTorch's and XLA's ``sin`` differ in the last
bit at the switches.  On smooth problems with ``first_step`` given (the
rational problem, a linear decay) no decision sits that close, and the
counts stay identical; on the sign-switching problems the cascade bisects
towards each switch, so a last-bit h takes other steps there, and the
gates below are measured with a margin.  The grid cases take n = 128 (the
JAX test's MoL) and n = 200, which the JAX kernel pads to 256 lanes and the
port takes as it is; on the n = 200 diffusion the JAX kernel's counts equal
the f64 host driver's, and so do the port's.

The tests marked ``gpu`` hold the CUDA kernels against their plain
versions on the card; they skip where there is none.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import CKdisc, solve_ensemble
from extensisq_tpu_torch.ops import (FusedGridRHS, FusedRHS,
                                     fused_ckdisc_grid_reference,
                                     fused_ckdisc_reference,
                                     solve_fused_ckdisc,
                                     solve_fused_ckdisc_grid)

REPO = Path(__file__).resolve().parents[1]
B = 128
B_GRID = 8
N_MOL = 128
N_DIFF = 200


def _sw(t, freq):
    return torch.where(torch.sin(freq * t) >= 0.0, 1.0, -1.0)


def decay(t, y):
    """The sign-switching decay of ``tests/test_fused_pallas.py:1695``."""
    return torch.stack([(-_sw(t, 3.0) - 0.5) * y[0]])


def swdec(t, y):
    """BASELINE config 1c's ``swdec_rows``."""
    sw = _sw(t, 3.0)
    return torch.stack([(-sw - 0.5) * y[0], (sw - 0.5) * y[1]])


def rational(t, y):
    """The smooth problem of ``tests/test_ckdisc.py:10``."""
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def linear(t, y):
    return torch.stack([-y[0], -0.5 * y[1] + y[0]])


def cubic(t, y):
    return torch.stack([y[1], y[0] ** 3])


def mol(t, y):
    """The non-smooth advection-reaction MoL of
    ``tests/test_fused_pallas.py:2010``."""
    return (-(y - torch.roll(y, 1, 0)) * float(N_MOL) + y * (1.0 - y)
            + 0.3 * _sw(t, 4.0))


def diffusion(t, y):
    """The n = 200 diffusion of ``tests/test_lane_pad.py:115``."""
    z = torch.zeros_like(y[:1])
    return (20.0 * (torch.cat([z, y[:-1]]) - 2.0 * y + torch.cat([y[1:], z]))
            + torch.abs(y - 0.4))


SW_CUDA = "const float sw = sinf({f}f * t) >= 0.0f ? 1.0f : -1.0f;"
RHS = {
    "decay": FusedRHS(decay, f"""__device__ void rhs(float t, const float* y,
                                          float* dy) {{
  {SW_CUDA.format(f=3.0)}
  dy[0] = (-sw - 0.5f) * y[0];
}}""", 1),
    "swdec": FusedRHS(swdec, f"""__device__ void rhs(float t, const float* y,
                                          float* dy) {{
  {SW_CUDA.format(f=3.0)}
  dy[0] = (-sw - 0.5f) * y[0];
  dy[1] = (sw - 0.5f) * y[1];
}}""", 2),
    "rational": FusedRHS(rational, """__device__ void rhs(float t,
    const float* y, float* dy) {
  dy[0] = y[1] / t;
  dy[1] = y[1] * (y[0] + 2.0f * y[1] - 1.0f) / (t * (y[0] - 1.0f));
}""", 2),
    "linear": FusedRHS(linear, """__device__ void rhs(float t, const float* y,
                                          float* dy) {
  dy[0] = -y[0];
  dy[1] = -0.5f * y[1] + y[0];
}""", 2),
    "cubic": FusedRHS(cubic, """__device__ void rhs(float t, const float* y,
                                          float* dy) {
  dy[0] = y[1];
  dy[1] = y[0] * y[0] * y[0];
}""", 2),
    "mol": FusedGridRHS(mol, f"""__device__ float rhs(float t, const float* y,
                                   int i, const float* p) {{
  {SW_CUDA.format(f=4.0)}
  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {float(N_MOL)!r}f
         + y[i] * (1.0f - y[i]) + 0.3f * sw;
}}""", (N_MOL,)),
    "diffusion": FusedGridRHS(diffusion, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  const float left = i > 0 ? y[i - 1] : 0.0f;
  const float right = i < {N_DIFF - 1} ? y[i + 1] : 0.0f;
  return 20.0f * (left - 2.0f * y[i] + right) + fabsf(y[i] - 0.4f);
}}""", (N_DIFF,)),
}


def _inputs():
    swd = (1.0 + 0.5 * np.random.RandomState(1).rand(1024, 2))[:B]
    rat = np.array([[1 / 3, 2 / 9]]) * np.linspace(1.0, 1.2, B)[:, None]
    lin = np.stack([np.linspace(0.5, 2.0, B), np.zeros(B)], 1)
    cub = np.stack([np.full(B, 0.1), np.zeros(B)], 1)
    cub[7, 0] = 1e18                   # this member overflows in f32
    x = np.linspace(0, 1, N_MOL, endpoint=False)
    amps = np.linspace(0.2, 0.8, B_GRID)
    mol0 = 0.5 + 0.4 * amps[:, None] * np.sin(2 * np.pi * x)[None, :]
    mol_bad = mol0.copy()
    mol_bad[3] *= 1e20                 # this member overflows in f32
    xd = np.linspace(0, 1, N_DIFF)
    dif = np.tile(np.exp(-30 * (xd - 0.5) ** 2), (B_GRID, 1))
    return {k: np.asarray(v, np.float32) for k, v in dict(
        decay=np.ones((B, 1)), swdec=swd, rational=rat, linear=lin,
        cubic=cub, mol=mol0, mol_bad=mol_bad, diffusion=dif).items()}


Y0 = _inputs()
SWDEC_TOL = dict(rtol=1e-4, atol=1e-7)
# name -> (kernel, problem, span, inputs, options)
CASES = {
    "decay": ("flat", "decay", (0.0, 5.0), "decay", SWDEC_TOL),
    "swdec": ("flat", "swdec", (0.0, 5.0), "swdec", SWDEC_TOL),
    "swdec_h0": ("flat", "swdec", (0.0, 5.0), "swdec",
                 dict(SWDEC_TOL, first_step=0.01)),
    "rational_h0": ("flat", "rational", (5.0, 9.0), "rational",
                    dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
    "rational_back_h0": ("flat", "rational", (5.0, 1.0), "rational",
                         dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
    "linear_h0": ("flat", "linear", (0.0, 5.0), "linear",
                  dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
    "linear_max_step": ("flat", "linear", (0.0, 5.0), "linear",
                        dict(rtol=1e-5, atol=1e-8, first_step=0.01,
                             max_step=0.1)),
    "overflow": ("flat", "cubic", (0.0, 1.0), "cubic",
                 dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
    "overflow_h0": ("flat", "cubic", (0.0, 1.0), "cubic",
                    dict(rtol=1e-4, atol=1e-6, first_step=0.01,
                         max_steps=2000)),
    "mol": ("grid", "mol", (0.0, 1.2), "mol", dict(rtol=1e-4, atol=1e-6)),
    "mol_h0": ("grid", "mol", (0.0, 1.2), "mol",
               dict(rtol=1e-4, atol=1e-6, first_step=0.001)),
    "mol_overflow": ("grid", "mol", (0.0, 0.5), "mol_bad",
                     dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
    "mol_overflow_h0": ("grid", "mol", (0.0, 0.5), "mol_bad",
                        dict(rtol=1e-4, atol=1e-6, first_step=0.001,
                             max_steps=2000)),
    "diffusion": ("grid", "diffusion", (0.0, 0.5), "diffusion",
                  dict(rtol=1e-4, atol=1e-6)),
}
# the first attempts of a case, bit for bit: name -> (case, max_steps)
FIRST = {"swdec_1": ("swdec_h0", 1), "decay_1": ("decay", 1),
         "rational_3": ("rational_h0", 3), "mol_1": ("mol_h0", 1)}


def _spec():
    spec = {k: list(v) for k, v in CASES.items()}
    for name, (case, attempts) in FIRST.items():
        kind, prob, span, y0, kw = CASES[case]
        spec[name] = [kind, prob, span, y0, dict(kw, max_steps=attempts)]
    return spec


@pytest.fixture(scope="module")
def jax_results():
    """The JAX kernels' outputs for every case, from
    ``tests/jax_fused_ckdisc.npz``."""
    out = np.load(REPO / "tests" / "jax_fused_ckdisc.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in _spec()}


def _port(name, **over):
    kind, prob, span, y0, kw = CASES[name]
    ref = (fused_ckdisc_reference if kind == "flat"
           else fused_ckdisc_grid_reference)
    res = ref(RHS[prob], span, torch.tensor(Y0[y0]), **dict(kw, **over))
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference, relative difference of mean nsteps), measured on the CPU:
# decay 5.4e-6, 0, 10, 128 (every member the same one: the cascade's
# decisions at a switch part, not its steps), 0; swdec 2.6e-3, 9, 71, 122,
# 1.8e-3; swdec_h0 2.0e-3, 7, 46, 111, 5.8e-3; mol 3.4e-4, 9, 66, 7,
# 3.8e-2 (8 members); mol_h0 3.9e-4, 7, 50, 7, 5.9e-3.  The gates add a
# margin of about 2x (the 1c gate 5e-3 on swdec's endpoints).
GATES = [
    ("decay", 2e-5, 2, 20, 128, 1e-2),
    ("swdec", 5e-3, 18, 150, 128, 1e-2),
    ("swdec_h0", 5e-3, 14, 100, 128, 2e-2),
    ("mol", 1e-3, 18, 140, 8, 8e-2),
    ("mol_h0", 1e-3, 14, 100, 8, 2e-2),
]


@pytest.mark.parametrize("name,y_gate,dsteps,dfev,nmembers,mean_gate", GATES)
def test_reference_matches_jax_kernel(jax_results, name, y_gate, dsteps,
                                      dfev, nmembers, mean_gate):
    y, status, nsteps, nfev = _port(name)
    jy, jstatus, jnsteps, jnfev = jax_results[name]
    np.testing.assert_array_equal(status, jstatus)
    assert np.all(status == 1)
    assert np.max(np.abs(y - jy)) <= y_gate
    assert np.max(np.abs(nsteps - jnsteps)) <= dsteps
    assert np.max(np.abs(nfev - jnfev)) <= dfev
    assert np.sum((nsteps != jnsteps) | (nfev != jnfev)) <= nmembers
    assert abs(nsteps.mean() / jnsteps.mean() - 1.0) <= mean_gate


# measured |dy|: rational_h0 0, rational_back_h0 1.5e-8, linear_h0
# 1.5e-7, linear_max_step 3.0e-8, diffusion 9.5e-7; gates about 3x
@pytest.mark.parametrize("name,y_gate", [
    ("rational_h0", 1e-7), ("rational_back_h0", 5e-8), ("linear_h0", 5e-7),
    ("linear_max_step", 1e-7), ("diffusion", 3e-6)])
def test_counts_identical(jax_results, name, y_gate):
    """Smooth problems with ``first_step`` given (and the n = 200 diffusion,
    whose counts the JAX test holds equal to the f64 host driver's): every
    member takes the JAX kernel's steps, status, nsteps and nfev
    identical."""
    y, status, nsteps, nfev = _port(name)
    jy, jstatus, jnsteps, jnfev = jax_results[name]
    assert np.all(status == 1)
    np.testing.assert_array_equal(status, jstatus)
    np.testing.assert_array_equal(nsteps, jnsteps)
    np.testing.assert_array_equal(nfev, jnfev)
    assert np.max(np.abs(y - jy)) <= y_gate


@pytest.mark.parametrize("name", list(FIRST))
def test_first_attempts_bit_identical(jax_results, name):
    """The first attempts (stages, the cascade's norms and decisions, the
    fallbacks and the new point) repeat the JAX kernel's arithmetic bit for
    bit: one attempt of the switching problems, three of the rational
    problem."""
    case, attempts = FIRST[name]
    out = _port(case, max_steps=attempts)
    for a, b in zip(out, jax_results[name]):
        np.testing.assert_array_equal(a, b)


def test_diffusion_counts_equal_the_f64_driver():
    """``tests/test_lane_pad.py:115``'s gate at n = 200 without padding: the
    plain grid version takes the f64 driver's nsteps and nfev, and lies
    within 2e-3 of it."""
    y, status, nsteps, nfev = _port("diffusion")
    ref = solve_ensemble(diffusion, (0.0, 0.5),
                         torch.tensor(Y0["diffusion"][:1],
                                      dtype=torch.float64),
                         method=CKdisc, rtol=1e-4, atol=1e-6)
    assert np.all(status == 1) and int(ref.status[0]) == 1
    assert np.all(nsteps == int(ref.nsteps[0]))
    assert np.all(nfev == int(ref.nfev[0]))
    assert np.max(np.abs(y - ref.y.numpy())) < 2e-3


def test_mol_tracks_the_f64_driver():
    """The JAX test's gates on the MoL (``tests/test_fused_pallas.py:
    2034-2042``): endpoints within 2e-3 of the f64 driver and mean nsteps
    within 20%."""
    y, status, nsteps, _ = _port("mol")
    ref = solve_ensemble(mol, (0.0, 1.2),
                         torch.tensor(Y0["mol"], dtype=torch.float64),
                         method=CKdisc, rtol=1e-4, atol=1e-6)
    assert np.all(status == 1) and bool((ref.status == 1).all())
    assert np.max(np.abs(y - ref.y.numpy())) < 2e-3
    mean64 = ref.nsteps.double().mean().item()
    assert abs(nsteps.mean() - mean64) < 0.2 * mean64


@pytest.mark.parametrize("name,bad,code", [("overflow", 7, 3),
                                           ("overflow_h0", 7, 2),
                                           ("mol_overflow", 3, 3),
                                           ("mol_overflow_h0", 3, 2)])
def test_overflow_member_isolated(jax_results, name, bad, code):
    """A diverging member ends alone with a failure status, and its
    neighbours keep the JAX kernel's status; the flat kernel's neighbours
    keep its counts too.  Its norms are not finite, so every attempt
    rejects: from Watts' start, whose estimate is NaN there, the step size
    stays NaN and the member runs to the step cap (status 3); from a given
    first step it shrinks below the least step (status 2)."""
    y, status, nsteps, nfev = _port(name)
    jy, jstatus, jnsteps, jnfev = jax_results[name]
    assert status[bad] == code
    assert np.sum(status == 1) == len(status) - 1
    np.testing.assert_array_equal(status, jstatus)
    ok = status == 1
    assert np.all(np.isfinite(y[ok]))
    if not name.startswith("mol"):
        np.testing.assert_array_equal(nsteps, jnsteps)
        np.testing.assert_array_equal(nfev, jnfev)


def test_nfev_counts_the_cascade():
    """nfev counts the reference method's evaluations: with max_steps = 1,
    the start (2 + min(n + 1, 3)), 1 + 2 go2 + 2 go4 for the attempt and
    one for an accepted endpoint; a member of a flat problem that passes
    both assessments and accepts pays 1 + 2 + 2 + 1."""
    y, status, nsteps, nfev = fused_ckdisc_reference(
        RHS["rational"], (5.0, 9.0), torch.tensor(Y0["rational"][:4]),
        rtol=1e-5, atol=1e-8, max_steps=1)
    assert torch.all(status == 3) and torch.all(nsteps == 1)
    assert torch.all(nfev == 2 + 3 + 6)


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors the wrappers run the plain versions, with a FusedRHS/
    FusedGridRHS or a bare torch function, and launch no kernel."""
    for solve_fn, ref_fn, name in (
            (solve_fused_ckdisc, fused_ckdisc_reference, "rational_h0"),
            (solve_fused_ckdisc_grid, fused_ckdisc_grid_reference, "mol_h0")):
        _, prob, span, y0, kw = CASES[name]
        y0 = torch.tensor(Y0[y0][:8])
        before = solve_fn.launches
        ref = ref_fn(RHS[prob], span, y0, **kw)
        for f in (RHS[prob], RHS[prob].torch_fn):
            for a, b in zip(solve_fn(f, span, y0, **kw), ref):
                assert torch.equal(a, b)
        assert solve_fn.launches == before


@pytest.mark.parametrize("option", ["events"])
@pytest.mark.parametrize("solve_fn", [solve_fused_ckdisc,
                                      solve_fused_ckdisc_grid])
def test_unported_options_raise(solve_fn, option):
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        solve_fn(decay, (0.0, 1.0), torch.tensor(Y0["decay"]),
                 **{option: 1})


def test_grid_rhs_must_be_one_axis():
    two = FusedGridRHS(mol, RHS["mol"].cuda_src, (2, N_MOL // 2))
    with pytest.raises(ValueError, match="shape"):
        fused_ckdisc_grid_reference(two, (0.0, 0.2), torch.tensor(Y0["mol"]))


def test_generated_headers_hold_float32_weights():
    """Both kernels' headers carry the cascade's weights rounded to float32
    at their indices, and the user's source; the other grid families carry
    zero cascade rows."""
    import re
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_ckdisc import ck_consts
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    from extensisq_tpu_torch import BS5
    k = ck_consts()
    flat = _build.fused_ckdisc_header(k, 2, RHS["swdec"].cuda_src)
    grid = _build.fused_rk_grid_header(k, False, (N_MOL,),
                                       RHS["mol"].cuda_src)
    for text in (flat, grid):
        for name, key in (("BAS", "B_as"), ("EAS", "E_as"), ("BFB", "B_fb"),
                          ("EFB", "E_fb"), ("CFB", "C_fb"), ("A", "A"),
                          ("E", "E")):
            body = re.search(rf"constexpr float {name}\(([^)]*)\) {{\n  "
                             rf"return (.*?);\n}}", text, re.S).group(2)
            ref = np.asarray(k[key], np.float32)
            got = np.zeros_like(ref)
            for cond, lit in re.findall(r"\(?([^?]*?)\)? \? (\S+f) :", body):
                got[tuple(int(v) for v in re.findall(r"== (\d+)", cond))] = \
                    float.fromhex(lit[:-1])
            np.testing.assert_array_equal(got, ref, err_msg=name)
    assert "constexpr bool CK = true;" in grid
    assert RHS["swdec"].cuda_src in flat and RHS["mol"].cuda_src in grid
    erk = _build.fused_rk_grid_header(_fused_consts(BS5), False, (N_MOL,),
                                      RHS["mol"].cuda_src)
    assert "constexpr bool CK = false;" in erk
    assert "constexpr float BAS(int i, int j) {\n  return 0.0f;\n}" in erk


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CPU fallback: where the CUDA toolkit is missing, building either
    kernel raises before anything is written."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_ckdisc import ck_consts
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_fused_ckdisc(ck_consts(), 2, RHS["swdec"].cuda_src)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_fused_rk_grid(ck_consts(), False, (N_MOL,),
                                  RHS["mol"].cuda_src)
    assert not (tmp_path / "build").exists()


def test_build_keys_hash_the_included_headers():
    from extensisq_tpu_torch.ops import _build
    assert [p.name for p in _build.shared_headers("fused_ckdisc")] == [
        "hstart.cuh", "rk_common.cuh", "rk_rows.cuh", "ck_control.cuh",
        "rk_lanes.cuh", "member_rhs.cuh", "snapshot.cuh", "lane_group.cuh",
        "rk_control.cuh"]
    assert "ck_control.cuh" in [p.name for p in
                                _build.shared_headers("fused_rk_grid")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# kernel against its plain version on the same card: status identical,
# |dy| over finished members within the gates chip_smoke.py measured
CARD_GATES = {"decay": 5e-3, "swdec": 6e-3, "swdec_h0": 6e-3,
              "rational_h0": 1e-5, "rational_back_h0": 1e-5,
              "linear_h0": 1e-5, "linear_max_step": 1e-5, "overflow": 1e-5,
              "overflow_h0": 1e-5, "mol": 2e-3, "mol_h0": 2e-3,
              "mol_overflow": 2e-3, "mol_overflow_h0": 2e-3,
              "diffusion": 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_kernel_matches_plain_version_on_card(cuda, name):
    kind, prob, span, y0, kw = CASES[name]
    y0 = torch.tensor(Y0[y0], device=cuda)
    solve_fn = (solve_fused_ckdisc if kind == "flat"
                else solve_fused_ckdisc_grid)
    ref_fn = (fused_ckdisc_reference if kind == "flat"
              else fused_ckdisc_grid_reference)
    before = solve_fn.launches
    k = solve_fn(RHS[prob], span, y0, **kw)
    assert solve_fn.launches == before + 1
    r = ref_fn(RHS[prob], span, y0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["swdec", "mol"])
def test_empty_batch_launches_nothing(cuda, name):
    fun = RHS[name]
    solve_fn = (solve_fused_ckdisc if name == "swdec"
                else solve_fused_ckdisc_grid)
    width = fun.n if name == "swdec" else fun.shape[0]
    before = solve_fn.launches
    y, status, nsteps, nfev = solve_fn(
        fun, (0.0, 1.0), torch.zeros((0, width), device=cuda))
    assert y.shape == (0, width) and status.shape == (0,)
    assert solve_fn.launches == before


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_rhs(cuda):
    with pytest.raises(TypeError, match="FusedRHS"):
        solve_fused_ckdisc(swdec, (0.0, 1.0),
                           torch.tensor(Y0["swdec"], device=cuda))
    with pytest.raises(TypeError, match="FusedGridRHS"):
        solve_fused_ckdisc_grid(mol, (0.0, 1.0),
                                torch.tensor(Y0["mol"], device=cuda))


FLAT_CARD_CASES = [k for k in CARD_GATES if CASES[k][0] == "flat"]
# B11's lane counts besides one thread
LANES = (2, 4, 8, 16, 32)


def _flat_launch_args(name, cuda):
    _, prob, span, y0, kw = CASES[name]
    return (RHS[prob], span, torch.tensor(Y0[y0], device=cuda), kw["rtol"],
            kw["atol"], kw.get("first_step"), kw.get("max_steps", 100_000),
            kw.get("max_step"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", FLAT_CARD_CASES)
def test_lane_bodies_bit_identical_to_one_thread_on_card(cuda, name):
    """B11 forced to 2, 4, 8, 16 and 32 lanes a member (128 / G members a
    block): bit for bit the one-thread body, and against the plain version
    at the card gates.  Comparison launches are not counted."""
    from extensisq_tpu_torch.ops import fused_ckdisc as FC
    args = _flat_launch_args(name, cuda)
    before = solve_fused_ckdisc.launches
    one, shape = FC._launch(*args, 1)
    assert shape == (1, 128)
    _, prob, span, _, kw = CASES[name]
    r = fused_ckdisc_reference(RHS[prob], span, args[2], **kw)
    for lanes in LANES:
        k, shape = FC._launch(*args, lanes)
        assert shape == (lanes, max(1, 128 // lanes))
        for a, b in zip(k, one):
            assert torch.equal(a, b)
        assert torch.equal(k[1], r[1])
        ok = r[1] == 1
        assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]
    assert solve_fused_ckdisc.launches == before


@pytest.mark.gpu
def test_wrapper_takes_the_rules_shape_on_card(cuda):
    """solve_fused_ckdisc launches its rule's shape for the card's SM count
    and records it in last_shape."""
    from extensisq_tpu_torch.ops import fused_ckdisc as FC
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, prob, span, y0, kw = CASES["swdec"]
    for y in (Y0[y0], np.repeat(Y0[y0], 8, axis=0),
              np.repeat(Y0[y0], 128, axis=0)):
        solve_fused_ckdisc(RHS[prob], span, torch.tensor(y, device=cuda),
                           **kw)
        g = FC._lanes_per_member(len(y), sms)
        assert solve_fused_ckdisc.last_shape == (g, max(1, 128 // g))


@pytest.mark.gpu
def test_block_of_more_than_1024_threads_raises(cuda):
    """An explicit block_members of more than 1024 threads at the lanes
    taken raises before any launch."""
    from extensisq_tpu_torch.ops import fused_ckdisc as FC
    args = _flat_launch_args("swdec", cuda)
    before = solve_fused_ckdisc.launches
    with pytest.raises(ValueError, match="at most 1024"):
        FC._launch(*args, 8, 256)
    with pytest.raises(ValueError, match="at most 1024"):
        solve_fused_ckdisc(*args[:2], args[2], rtol=1e-4, atol=1e-7,
                           block_members=2048)
    assert solve_fused_ckdisc.launches == before


GRID_CARD_CASES = [k for k in CARD_GATES if CASES[k][0] == "grid"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", GRID_CARD_CASES)
def test_rule_shapes_match_plain_version_on_card(cuda, name):
    """B12 at each shape its rule can take, blocks of one, two and four
    elements a thread (64 threads), against the plain version at the card
    gates; a warp launch is refused; the wrapper records the rule's shape.
    Comparison launches are not counted."""
    from extensisq_tpu_torch.ops import fused_ckdisc_grid as FCG
    from extensisq_tpu_torch.ops.fused_erk_grid import grid_threads
    _, prob, span, y0, kw = CASES[name]
    fun = RHS[prob]
    n = fun.shape[0]
    y0 = torch.tensor(Y0[y0], device=cuda)
    built = FCG._kernel(fun)
    before = solve_fused_ckdisc_grid.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        FCG._launch(built, span, y0, n, shape=(32, 4), **kw)
    r = fused_ckdisc_grid_reference(fun, span, y0, **kw)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rule = FCG._launch_shape(len(y0), n, sms)
    for shape in {rule, (grid_threads(n), 0), (grid_threads(-(-n // 2)), 0),
                  (min(FCG.SMALL_THREADS, grid_threads(n)), 0)}:
        k, _ = FCG._launch(built, span, y0, n, shape=shape, **kw)
        assert torch.equal(k[1], r[1])
        ok = r[1] == 1
        assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]
    assert solve_fused_ckdisc_grid.launches == before
    solve_fused_ckdisc_grid(fun, span, y0, **kw)
    assert solve_fused_ckdisc_grid.last_shape == rule
    assert solve_fused_ckdisc_grid.launches == before + 1


@pytest.mark.parametrize("members,lanes", [
    (256, 32), (1024, 32), (1056, 32), (1057, 16), (2112, 16), (2113, 8),
    (4224, 8), (4225, 1), (16384, 1), (262144, 1)])
def test_lanes_per_member_on_132_sms(members, lanes):
    """B11's rule on the H100's 132 SMs: the largest of 32, 16 and 8 lanes
    with members x lanes <= 256 x 132 (two warps per SM sub-partition),
    else one thread per member (the member sweep's wins and losses)."""
    from extensisq_tpu_torch.ops.fused_ckdisc import _lanes_per_member
    assert _lanes_per_member(members, 132) == lanes


@pytest.mark.parametrize("members,n,shape", [
    (64, 256, (256, 0)), (264, 256, (256, 0)), (265, 256, (128, 0)),
    (528, 256, (128, 0)), (529, 256, (64, 0)), (1024, 256, (64, 0)),
    (8, 100, (128, 0)), (300, 100, (64, 0)), (1024, 512, (64, 0)),
    (8, 20, (32, 0)), (1024, 20, (32, 0))])
def test_launch_shape_on_132_sms(members, n, shape):
    """B12's launch shape on the H100's 132 SMs: one block of
    ``grid_threads(n)`` threads per member up to 2 members an SM, of two
    elements a thread up to 4, beyond one block of 64 threads (never
    more than ``grid_threads(n)``); never the warp."""
    from extensisq_tpu_torch.ops.fused_ckdisc_grid import _launch_shape
    assert _launch_shape(members, n, 132) == shape
