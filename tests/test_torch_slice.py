"""The port's slice as a whole, at 256 members: the f64 solver line and
both fused lines of the main path (Van der Pol, mu = 3, BS5), held to the
gates of the JAX package's own fused tests (``tests/test_fused_pallas.py``).

On the CPU the fused lines run the kernel's plain version; the test
marked ``gpu`` runs the same lines through the CUDA kernel.
"""
import numpy as np
import pytest
import torch

from extensisq_tpu_torch import BS5, solve_ensemble
from extensisq_tpu_torch.ops import FusedRHS, solve_fused_erk

B = 256
T_SPAN = (0.0, 10.0)


def vdp(t, y):
    return torch.stack([y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def oscillator(t, y):
    return torch.stack([y[1], -y[0]])


VDP = FusedRHS(vdp, """__device__ void rhs(float t, const float* y,
                                          float* dy) {
  dy[0] = y[1];
  dy[1] = 3.0f * (1.0f - y[0] * y[0]) * y[1] - y[0];
}""", 2)
HO = FusedRHS(oscillator, """__device__ void rhs(float t, const float* y,
                                                float* dy) {
  dy[0] = y[1];
  dy[1] = -y[0];
}""", 2)


def _vdp_members(device="cpu"):
    y0 = np.stack([np.linspace(1.5, 2.5, B), np.zeros(B)], axis=1)
    return torch.tensor(y0, device=device)


def test_fused_plain_matches_f64_solver():
    """test_fused_matches_f64_path: f32 at rtol 1e-4 lands within 5e-2 of
    the f64 solver at the same tolerances, with comparable work."""
    y64 = _vdp_members()
    y, status, nsteps, nfev = solve_fused_erk(
        VDP, T_SPAN, y64.float(), method=BS5, rtol=1e-4, atol=1e-6)
    assert torch.all(status == 1)
    out = solve_ensemble(vdp, T_SPAN, y64, method=BS5, rtol=1e-4,
                         atol=1e-6)
    assert torch.all(out.status == 1)
    assert (y.double() - out.y).abs().max().item() < 5e-2
    total = int(out.nsteps.sum())
    assert abs(int(nsteps.sum()) - total) < 0.3 * total


def test_fused_compensated_tight_tolerances():
    """test_fused_compensated_tight_tolerances: over 50 oscillator
    periods at rtol 1e-6 / atol 1e-9 the compensated f32 line is as
    accurate as the f64 solver (within 2x) and tracks its step count."""
    y0 = torch.tensor([[1.0, 0.0]], dtype=torch.float64).repeat(B, 1)
    span = (0.0, 50 * 2 * np.pi)
    exact = torch.tensor([1.0, 0.0], dtype=torch.float64)
    ref = solve_ensemble(oscillator, span, y0, method=BS5, rtol=1e-6,
                         atol=1e-9)
    err_ref = (ref.y - exact).abs().max().item()
    yf, st, ns, nf = solve_fused_erk(HO, span, y0.float(), method=BS5,
                                     rtol=1e-6, atol=1e-9, compensated=True)
    assert torch.all(st == 1)
    err = (yf.double() - exact).abs().max().item()
    assert err < 2.0 * err_ref
    assert abs(ns.double().mean().item()
               - ref.nsteps.double().mean().item()) < 10.0


def _main_path(device):
    y64 = _vdp_members(device)
    ens = solve_ensemble(vdp, T_SPAN, y64, method=BS5, rtol=1e-6, atol=1e-9)
    plain = solve_fused_erk(VDP, T_SPAN, y64.float(), method=BS5,
                            rtol=1e-4, atol=1e-6, block_members=128)
    comp = solve_fused_erk(VDP, T_SPAN, y64.float(), method=BS5, rtol=1e-6,
                           atol=1e-9, compensated=True, block_members=128)
    return ens, plain, comp


def _check_main_path(ens, plain, comp):
    assert torch.all(ens.status == 1)
    assert ens.y.shape == (B, 2) and bool(torch.isfinite(ens.y).all())
    for out in (plain, comp):
        assert torch.all(out[1] == 1)
        assert out[0].shape == (B, 2) and bool(torch.isfinite(out[0]).all())
    # the compensated line at the f64 tolerances: within 1e-3 of the
    # f64 line (measured 2.9e-5 at 4096 members on an H100) and mean
    # nsteps within 10
    assert (comp[0].double() - ens.y).abs().max().item() < 1e-3
    assert abs(comp[2].double().mean().item()
               - ens.nsteps.double().mean().item()) < 10.0
    # the plain line at rtol 1e-4 stays within the 5e-2 gate of the f64 line
    assert (plain[0].double() - ens.y).abs().max().item() < 5e-2


def test_main_path_lines():
    _check_main_path(*_main_path("cpu"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_main_path_lines_on_card(cuda):
    before = solve_fused_erk.launches
    _check_main_path(*_main_path(cuda))
    assert solve_fused_erk.launches == before + 2
