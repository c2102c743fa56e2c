"""The port's fused SWAG path against the JAX package's Pallas kernel.

``fused_adams_reference`` (the CUDA kernel's plain PyTorch version) runs on
the CPU; the JAX side runs ``solve_fused_adams(..., interpret=True)`` as the
JAX package's own tests run it, on the same inputs, with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` so that XLA, like PyTorch's CPU
operations, rounds every product on its own (no FMA), its outputs written
to ``tests/jax_fused_adams.npz`` by ``tests/jax_fused_adams.py``.  What
remains
between the two is the round-off of ``pow`` (``exp(log x / (k + 1))`` in
the JAX kernel) and of the float32 starting step's ``log10``/``pow``; a
case given ``first_step`` skips the latter.

The interpret-mode Pallas body is compiled by XLA in time that grows about
as ``k_max**3`` (measured on the CPU: 18 s at k_max = 4, 62 s at 6, 92 s
at 8 compensated, over 500 s at 12 compensated), so the compensated cases
run here at ``k_max = 4``; ``k_max = 12`` is held against the plain version
by the host-compiled kernel (``test_torch_csrc_host.py``) and on the card.

The block-1 coefficient update is checked on its own against JAX
``make_coefficients``, and the plain version against the JAX tests' own
gates with the port's f64 driver.  The tests marked ``gpu`` hold the CUDA
kernel against the plain version on the card, at member counts that
select each lane count per member the wrapper takes; they skip where
there is none.  JAX is imported only inside the tests that call it, so that the
file also runs where only torch is installed (``-m gpu --noconftest``).
"""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import SWAG, solve_ensemble
from extensisq_tpu_torch.ops import (FusedRHS, fused_adams_reference,
                                     solve_fused_adams)
from extensisq_tpu_torch.ops import fused_adams as FA
from extensisq_tpu_torch.steppers.adams import AdamsStepper

REPO = Path(__file__).resolve().parents[1]
B = 128


def _vdp_src(mu):
    return ("__device__ void rhs(float t, const float* y, float* dy) {\n"
            "  dy[0] = y[1];\n"
            f"  dy[1] = {mu!r}f * (1.0f - y[0] * y[0]) * y[1] - y[0];\n}}")


def _vdp(mu):
    return FusedRHS(lambda t, y: torch.stack(
        [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]), _vdp_src(mu), 2)


PROBLEMS = {
    "vdp5": _vdp(5.0),
    "vdp1e3": _vdp(1000.0),
    "osc": FusedRHS(lambda t, y: torch.stack([y[1], -y[0]]),
                    "__device__ void rhs(float t, const float* y, float* dy)"
                    " {\n  dy[0] = y[1];\n  dy[1] = -y[0];\n}", 2),
    "decay": FusedRHS(lambda t, y: torch.stack([-y[0]]),
                      "template <class T>\n__device__ void rhs(T t, const T* "
                      "y, T* dy) {\n  dy[0] = -y[0];\n}", 1),
    "grow": FusedRHS(lambda t, y: torch.stack([y[0]]),
                     "__device__ void rhs(float t, const float* y, float* dy)"
                     " {\n  dy[0] = y[0];\n}", 1),
}
X0 = np.stack([np.linspace(1.9, 2.1, B), np.zeros(B)], 1).astype(np.float32)
HO0 = np.array([1.0, 0.0], np.float32) \
    * np.linspace(0.9, 1.1, B, dtype=np.float32)[:, None]
DEC0 = np.linspace(0.5, 1.5, B, dtype=np.float32)[:, None]
# name -> (problem, span, y0, options); tests/test_fused_pallas.py:481-503,
# :816-838, :868-905 and bench.py:139-169, shortened
CASES = {
    "vdp": ("vdp5", (0.0, 2.0), X0, dict(rtol=1e-4, atol=1e-6, k_max=6)),
    "osc_comp": ("osc", (0.0, 2.0), HO0,
                 dict(rtol=1e-6, atol=1e-9, k_max=4, compensated=True,
                      first_step=1e-3)),
    "decay_1e6": ("decay", (1e6, 1e6 + 1.0), DEC0,
                  dict(rtol=1e-4, atol=1e-7, k_max=6, max_steps=3000)),
    "bench": ("vdp1e3", (0.0, 0.05), X0,
              dict(rtol=1e-6, atol=1e-9, k_max=4, compensated=True,
                   first_step=1e-5, max_steps=400_000)),
}

@pytest.fixture(scope="module")
def jax_results():
    """The JAX kernel's outputs for every case, from
    ``tests/jax_fused_adams.npz`` (``tests/jax_fused_adams.py`` writes
    it)."""
    out = np.load(REPO / "tests" / "jax_fused_adams.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in CASES}


def _port(name, **over):
    prob, span, y0, kw = CASES[name]
    res = fused_adams_reference(PROBLEMS[prob], span, torch.tensor(y0),
                                **dict(kw, **over))
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference).  Measured on the CPU: vdp 4.4e-6, 1 step, 1 evaluation, 1
# member (the starting step's log10/pow); osc_comp 0, 0, 0, 0 (bit for
# bit); decay_1e6 0, 0, 0, 0; bench 7.6e-10, 0, 3, 1 (pow).  The gates add
# a margin of about 2x, and a floor of 1e-7 on |dy|.
GATES = [
    ("vdp", 1e-5, 2, 2, 3),
    ("osc_comp", 1e-7, 1, 2, 2),
    ("decay_1e6", 1e-7, 1, 2, 2),
    ("bench", 2e-9, 1, 6, 3),
]


@pytest.mark.parametrize("name,y_gate,dsteps,dfev,nmembers", GATES)
def test_reference_matches_jax_kernel(jax_results, name, y_gate, dsteps,
                                      dfev, nmembers):
    y, status, nsteps, nfev = _port(name)
    jy, jstatus, jnsteps, jnfev = jax_results[name]
    jstatus, jnsteps, jnfev = (a.ravel() for a in (jstatus, jnsteps, jnfev))
    np.testing.assert_array_equal(status, jstatus)
    assert np.all(status == 1)
    assert np.max(np.abs(y - jy)) <= y_gate
    assert np.max(np.abs(nsteps - jnsteps)) <= dsteps
    assert np.max(np.abs(nfev - jnfev)) <= dfev
    assert np.sum((nsteps != jnsteps) | (nfev != jnfev)) <= nmembers


def test_coefficients_match_make_coefficients(monkeypatch):
    """The port's block-1 update (the stepper's ``_coefficients`` in
    float32) against JAX ``make_coefficients`` called on ``(B,)`` float32
    arrays outside any pallas_call, on every state of a compensated
    oscillator run at k_max = 8 (orders 1 to 8 mixed across members,
    order drops, ns resets): equal to the last bit."""
    import jax
    import jax.numpy as jnp
    from extensisq_tpu.ops._adams_common import TileOps, make_coefficients
    seen = []
    orig = AdamsStepper._coefficients

    def record(self, c, h, kold):
        out = orig(self, c, h, kold)
        seen.append((types.SimpleNamespace(**vars(c)), h, kold, out))
        return out

    monkeypatch.setattr(AdamsStepper, "_coefficients", record)
    km = 8
    fused_adams_reference(PROBLEMS["osc"], (0.0, 6.0), torch.tensor(HO0),
                          rtol=1e-6, atol=1e-9, k_max=km, compensated=True)
    assert len(seen) > 30
    ks = np.concatenate([s[0].k.numpy() for s in seen])
    nss = np.concatenate([s[0].ns.numpy() for s in seen])
    assert ks.min() == 1 and ks.max() == km and nss.max() > 2
    iqq = FA._adams_consts(km, 2)["iqq"]
    names = ("psi", "alpha", "beta", "sig", "v", "w", "g", "gi", "iv",
             "ivc", "kgi")
    with jax.enable_x64(False):
        O = TileOps(jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.int32))
        coefficients = make_coefficients(km, iqq, km - 2, O)

        def rows(x):
            return [jnp.asarray(r.numpy()) for r in x]

        for c, h, kold, out in seen:
            ref = coefficients(
                jnp.asarray(h.numpy()), jnp.asarray(c.k.numpy()),
                jnp.asarray(c.ns.numpy()), rows(c.psi), rows(c.alpha),
                rows(c.beta), rows(c.sig), rows(c.v), rows(c.w), rows(c.g),
                rows(c.gi), rows(c.iv), jnp.asarray(c.ivc.numpy()),
                jnp.asarray(c.kgi.numpy()), jnp.asarray(c.kprev.numpy()),
                jnp.asarray(kold.numpy()))
            for name, r, p in zip(names, ref, out):
                r = np.stack([np.asarray(x) for x in r]) \
                    if isinstance(r, list) else np.asarray(r)
                np.testing.assert_array_equal(p.numpy(), r, err_msg=name)


# -- the JAX tests' own gates, against the port's f64 driver ---------------

def test_vdp_matches_f64_driver():
    """test_fused_adams_vdp: mean nsteps within 2 of the f64 driver and
    endpoints within 1e-3."""
    y, status, nsteps, _ = _port("vdp")
    assert np.all(status == 1)
    out = solve_ensemble(PROBLEMS["vdp5"].torch_fn, (0.0, 2.0),
                         torch.tensor(X0, dtype=torch.float64), method=SWAG,
                         rtol=1e-4, atol=1e-6, k_max=6)
    assert abs(nsteps.mean() - out.nsteps.double().mean().item()) < 2.0
    assert np.max(np.abs(y - out.y.numpy())) < 1e-3


def test_compensated_matches_f64_driver():
    """test_fused_adams_compensated: rtol 1e-6 / atol 1e-9 on the
    oscillator to t = 6 at k_max = 8, within 5e-6 of the f64 driver."""
    y0 = torch.tensor([[1.0, 0.0]]).repeat(B, 1)
    yf, status, _, _ = fused_adams_reference(
        PROBLEMS["osc"], (0.0, 6.0), y0, rtol=1e-6, atol=1e-9, k_max=8,
        compensated=True)
    assert torch.all(status == 1)
    out = solve_ensemble(PROBLEMS["osc"].torch_fn, (0.0, 6.0),
                         y0[:1].double(), method=SWAG, rtol=1e-6, atol=1e-9,
                         k_max=8)
    assert (yf[0].double() - out.y[0]).abs().max().item() < 5e-6


def test_double_single_time_carry():
    """test_fused_ds_time_carry: a unit span at t0 = 1e6 (h below ulp(t))
    lands on tf through the double-single carry, and a backward span
    works."""
    y0 = torch.ones(B, 1)
    y, status, _, _ = fused_adams_reference(
        PROBLEMS["decay"], (1e6, 1e6 + 1.0), y0, rtol=1e-4, atol=1e-7,
        k_max=6, max_steps=3000)
    assert torch.all(status == 1)
    assert abs(float(y[0, 0]) - np.exp(-1.0)) < 1e-3
    y, status, _, _ = fused_adams_reference(
        PROBLEMS["grow"], (1.0, 0.0), y0, rtol=1e-5, atol=1e-8, k_max=6,
        max_steps=3000)
    assert torch.all(status == 1)
    assert abs(float(y[0, 0]) - np.exp(-1.0)) < 1e-4


def test_bench_line_small():
    """The slice as a whole at a small size: the bench line's problem (Van
    der Pol mu = 1000, compensated, k_max = 12, rtol 1e-6 / atol 1e-9)
    through the wrapper, 16 members on t in [0, 0.05], against the f64
    driver on the same members."""
    y0 = torch.tensor(X0[::8])
    before = solve_fused_adams.launches
    y, status, nsteps, nfev = solve_fused_adams(
        PROBLEMS["vdp1e3"], (0.0, 0.05), y0, rtol=1e-6, atol=1e-9, k_max=12,
        compensated=True)
    assert solve_fused_adams.launches == before
    assert torch.all(status == 1)
    assert y.shape == (16, 2) and bool(torch.isfinite(y).all())
    out = solve_ensemble(PROBLEMS["vdp1e3"].torch_fn, (0.0, 0.05),
                         y0.double(), method=SWAG, rtol=1e-6, atol=1e-9)
    assert torch.all(out.status == 1)
    assert (y.double() - out.y).abs().max().item() < 1e-5
    assert torch.all(nfev > nsteps)


def test_step_cap_and_overflow_isolation():
    """max_steps caps loop iterations with status 3; a member whose
    derivative overflows float32 ends with status 3 alone, before its
    first attempt, and every other one finishes."""
    _, status, nsteps, _ = fused_adams_reference(
        PROBLEMS["vdp5"], (0.0, 2.0), torch.tensor(X0[:8]), k_max=6,
        max_steps=5)
    assert torch.all(status == 3) and torch.all(nsteps <= 5)
    cubic = FusedRHS(lambda t, y: torch.stack([y[1], y[0] ** 3]), "", 2)
    x0 = np.full(B, 0.1, np.float32)
    x0[7] = 1e18
    y0 = torch.tensor(np.stack([x0, np.zeros_like(x0)], 1))
    y, status, nsteps, _ = fused_adams_reference(cubic, (0.0, 1.0), y0,
                                                 k_max=6)
    assert int(status[7]) == 3 and int(nsteps[7]) == 0
    assert int((status == 1).sum()) == B - 1
    assert bool(torch.isfinite(y[status == 1]).all())


# -- the wrapper, the header and the build ---------------------------------

def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper runs the plain version, with a FusedRHS
    or a bare torch function, and launches no kernel."""
    prob, span, y0, kw = CASES["vdp"]
    before = solve_fused_adams.launches
    ref = _port("vdp")
    for fun in (PROBLEMS[prob], PROBLEMS[prob].torch_fn):
        out = solve_fused_adams(fun, span, torch.tensor(y0), **kw)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), b)
    assert solve_fused_adams.launches == before


@pytest.mark.parametrize("option", ["events"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="B3"):
        solve_fused_adams(PROBLEMS["vdp5"], (0.0, 1.0), torch.tensor(X0),
                          **{option: 1})


def test_refuses_large_states_and_orders():
    with pytest.raises(ValueError, match="n <= 8"):
        solve_fused_adams(lambda t, y: -y, (0.0, 1.0), torch.ones(4, 9))
    with pytest.raises(ValueError, match="k_max"):
        solve_fused_adams(PROBLEMS["vdp5"], (0.0, 1.0), torch.tensor(X0),
                          k_max=13)


def test_generated_header_holds_float32_constants():
    """The kernel's header carries KM, N and the Adams constants (gstr,
    iqq, the 2^(q+1) table) rounded to float32 as the JAX kernel rounds
    them, and the user's RHS."""
    import re
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu.steppers.adams import _GSTR

    def accessor(text, name):
        body = re.search(rf"constexpr float {name}\(int i\) {{\n  return "
                         rf"(.*?);\n}}", text, re.S).group(1)
        return {int(i): float.fromhex(v.strip()[:-1])
                for i, v in re.findall(r"i == (\d+) \?([^:]+):", body)}

    for km, n in ((12, 2), (1, 1), (6, 8)):
        src = PROBLEMS["osc"].cuda_src
        text = _build.fused_adams_header(FA._adams_consts(km, n), src)
        assert f"constexpr int KM = {km};" in text
        assert f"constexpr int N = {n};" in text
        assert src in text
        assert accessor(text, "GSTR") == {
            i: float(np.float32(v)) for i, v in enumerate(_GSTR)}
        assert accessor(text, "IQQ") == {
            q - 1: float(np.float32(1.0 / (q * (q + 1.0))))
            for q in range(1, km + 2)}
        assert accessor(text, "TWO") == {q: 2.0 ** (q + 1)
                                         for q in range(km + 2)}
        inv_n = re.search(r"INV_N = (\S+)f;", text).group(1)
        assert float.fromhex(inv_n) == float(np.float32(1.0 / n))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CPU fallback: where the CUDA toolkit is missing, building the
    kernel raises before anything is written."""
    from extensisq_tpu_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_fused_adams(FA._adams_consts(12, 2),
                                PROBLEMS["osc"].cuda_src)
    assert not (tmp_path / "build").exists()


def test_build_key_hashes_adams_headers(monkeypatch, tmp_path):
    """The kernel's build key covers dense_record.cuh, adams_common.cuh,
    member_rhs.cuh, rk_common.cuh, snapshot.cuh and lane_group.cuh, which
    it includes, and no other shared header."""
    import shutil
    from extensisq_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.shared_headers("fused_adams")] == [
        "dense_record.cuh", "adams_common.cuh", "member_rhs.cuh",
        "rk_common.cuh", "snapshot.cuh", "lane_group.cuh"]
    before = _build.build_key("fused_adams", "header")
    common = csrc / "adams_common.cuh"
    common.write_text(common.read_text() + "\n// edited\n")
    after = _build.build_key("fused_adams", "header")
    assert after != before
    dual = csrc / "dual.cuh"
    dual.write_text(dual.read_text() + "\n// edited\n")
    assert _build.build_key("fused_adams", "header") == after


@pytest.mark.parametrize("nb,k_max,lanes", [
    (256, 12, 32), (1024, 12, 32), (4096, 12, 8), (8192, 12, 8),
    (16384, 12, 1), (32768, 12, 1), (8192, 8, 8), (256, 4, 32),
    (4096, 4, 8), (8192, 4, 1)])
def test_lanes_per_member_on_132_sms(nb, k_max, lanes):
    """The lane count the wrapper takes for the member sweeps' sizes on an
    H100's 132 SMs."""
    assert FA._lanes_per_member(nb, 132, k_max) == lanes


def test_lanes_per_member_rule():
    """The largest of 32, 16 and 8 lanes that keeps B G within 256 threads
    per SM, else 8 up to twice that at k_max >= 8, else 1: never 2 or 4,
    and fewer lanes for more members."""
    budget = 256 * 132
    for km in range(1, 13):
        wide = 2 * budget if km >= 8 else budget
        prev = 32
        for nb in range(1, 40_000, 37):
            lanes = FA._lanes_per_member(nb, 132, km)
            assert lanes in (1, 8, 16, 32) and lanes <= prev
            assert lanes not in (16, 32) or nb * lanes <= budget
            assert lanes != 8 or (nb * 16 > budget and nb * 8 <= wide)
            assert lanes != 1 or nb * 8 > wide
            prev = lanes
    assert FA._lanes_per_member(1056, 132, 12) == 32
    assert FA._lanes_per_member(1057, 132, 12) == 16
    assert FA._lanes_per_member(2113, 132, 12) == 8
    assert FA._lanes_per_member(8448, 132, 8) == 8
    assert FA._lanes_per_member(8449, 132, 12) == 1
    assert FA._lanes_per_member(4225, 132, 7) == 1
    assert FA._lanes_per_member(256, 66, 12) == 32
    assert FA._lanes_per_member(4096, 66, 12) == 8
    assert FA._lanes_per_member(4225, 66, 12) == 1


def test_launch_shape_refuses_more_than_1024_threads():
    """block_members keeps its meaning (members per block); a block holds
    block_members x G threads, at most 1024, and None takes 128 / G
    members per block.  The refusal comes before any card is needed."""
    assert FA._launch_shape(256, 32) == (4, 128, 64)
    assert FA._launch_shape(256, 32, 1) == (1, 32, 256)
    assert FA._launch_shape(32768, 1) == (128, 128, 256)
    assert FA._launch_shape(1000, 1, 1024) == (1024, 1024, 1)
    assert FA._launch_shape(4097, 8) == (16, 128, 257)
    for nb, lanes, bm in ((256, 32, 33), (256, 8, 129), (10, 1, 1025)):
        with pytest.raises(ValueError, match="at most 1024"):
            FA._launch_shape(nb, lanes, bm)
    with pytest.raises(ValueError, match="at least 1"):
        FA._launch_shape(256, 8, 0)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [32, 16, 8, 1])
@pytest.mark.parametrize("name,y_gate", [("vdp", 1e-3), ("osc_comp", 1e-5),
                                         ("decay_1e6", 1e-5),
                                         ("bench", 1e-5)])
def test_kernel_matches_plain_version_on_card(cuda, name, y_gate, lanes):
    """The CUDA kernel against its plain version on the same card, at a
    member count (the case's members repeated) that selects each lane
    count the wrapper takes; f32 round-off (the kernel contracts to FMA)
    allows other step sequences, hence gates of the size chip_smoke.py
    measures."""
    prob, span, y0, kw = CASES[name]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nb = FA._THREADS_PER_SM * sms // lanes
    assert FA._lanes_per_member(nb, sms, kw["k_max"]) == lanes
    y0 = torch.tensor(np.resize(y0, (nb, y0.shape[1])), device=cuda)
    before = solve_fused_adams.launches
    k = solve_fused_adams(PROBLEMS[prob], span, y0, **kw)
    assert solve_fused_adams.launches == before + 1
    assert solve_fused_adams.last_shape == (lanes, max(1, 128 // lanes))
    r = fused_adams_reference(PROBLEMS[prob], span, y0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    assert (k[0] - r[0]).abs().max().item() <= y_gate


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_rhs(cuda):
    with pytest.raises(TypeError, match="FusedRHS"):
        solve_fused_adams(PROBLEMS["vdp5"].torch_fn, (0.0, 1.0),
                          torch.tensor(X0, device=cuda))
