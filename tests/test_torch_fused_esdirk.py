"""The port's fused ESDIRK path against the JAX package's Pallas kernel.

``fused_esdirk_reference`` (the CUDA kernel's plain PyTorch version) runs
on the CPU; the JAX side is ``solve_fused_esdirk(..., interpret=True)``
as the JAX package's own tests run it, on the same seeded inputs, without
FMA (``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, so that XLA, like PyTorch's
CPU operations, rounds every product on its own), its outputs written to
``tests/jax_fused_esdirk.npz`` by ``tests/jax_fused_esdirk.py``.  What
remains between the two is the round-off of ``pow`` (``exp(e log x)`` in
the JAX kernel), of the starting step's ``log10``/``pow`` and of the two
libraries' forward-mode derivatives, which the gates below allow for.

The port's plain version is also held to the JAX tests' own gates against
the f64 driver, here the port's ``solve_ensemble``.  The tests marked
``gpu`` hold the CUDA kernel against the plain version on the card; they
skip where there is none.
"""
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import Kv3I, TRBDF2, solve, solve_ensemble
from extensisq_tpu_torch.ops import (FusedRHS, fused_esdirk_reference,
                                     solve_fused_esdirk)
from extensisq_tpu_torch.ops import fused_esdirk as FE
from extensisq_tpu_torch.ops.fused_sens import _aug_rhs
from extensisq_tpu_torch.steppers import build_stepper
from extensisq_tpu_torch.types import IVPParams

REPO = Path(__file__).resolve().parents[1]
B = 128
G = 9.81

ROB_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy) {
  const T r1 = -0.04f * y[0] + 1e4f * y[1] * y[2];
  const T r3 = 3e7f * y[1] * y[1];
  dy[0] = r1;
  dy[1] = -r1 - r3;
  dy[2] = r3;
}
"""
PEND_CUDA = """
template <class T>
__device__ void rhs(T t, const T* s, T* ds) {
  ds[0] = s[2];
  ds[1] = s[3];
  ds[2] = -s[4] * s[0];
  ds[3] = -s[4] * s[1] - 9.81f;
  ds[4] = s[2] * s[2] + s[3] * s[3]
          - s[4] * (s[0] * s[0] + s[1] * s[1]) - 9.81f * s[1];
}
"""
_RNG = np.random.RandomState(1)
HID_A = _RNG.rand(2, 2)
HID_B = _RNG.rand(2, 2)
HID_BINV = np.linalg.inv(HID_B)
M_HIDDEN = HID_A @ np.array([[0.0, 0.0], [0.0, 1.0]]) @ HID_BINV


def rob(t, y):
    r1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    r3 = 3e7 * y[1] * y[1]
    return torch.stack([r1, -r1 - r3, r3])


def pend(t, s):
    return torch.stack([s[2], s[3], -s[4] * s[0], -s[4] * s[1] - G,
                        s[2] * s[2] + s[3] * s[3]
                        - s[4] * (s[0] * s[0] + s[1] * s[1]) - G * s[1]])


def kaps_hidden(t, z):
    """The Kaps DAE in hidden variables z = B y, premultiplied by A."""
    a, bi = HID_A.tolist(), HID_BINV.tolist()
    y0 = bi[0][0] * z[0] + bi[0][1] * z[1]
    y1 = bi[1][0] * z[0] + bi[1][1] * z[1]
    f0 = -y0 + y1 * y1
    f1 = y0 - y1 - y1 * y1
    return torch.stack([a[0][0] * f0 + a[0][1] * f1,
                        a[1][0] * f0 + a[1][1] * f1])


def _f(x):
    return f"{float(np.float32(x))!r}f"


KAPS_HIDDEN_CUDA = f"""
template <class T>
__device__ void rhs(T t, const T* z, T* dz) {{
  const T y0 = {_f(HID_BINV[0, 0])} * z[0] + {_f(HID_BINV[0, 1])} * z[1];
  const T y1 = {_f(HID_BINV[1, 0])} * z[0] + {_f(HID_BINV[1, 1])} * z[1];
  const T f0 = -y0 + y1 * y1;
  const T f1 = y0 - y1 - y1 * y1;
  dz[0] = {_f(HID_A[0, 0])} * f0 + {_f(HID_A[0, 1])} * f1;
  dz[1] = {_f(HID_A[1, 0])} * f0 + {_f(HID_A[1, 1])} * f1;
}}
"""
def rob_p(t, y, p):
    """Robertson with the rate constants as per-member parameters."""
    r1 = p[0] * y[0]
    r2 = p[1] * y[1] * y[2]
    r3 = p[2] * y[1] * y[1]
    return torch.stack([-r1 + r2, r1 - r2 - r3, r3])


ROB_P_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  const T r1 = p[0] * y[0];
  const T r2 = p[1] * y[1] * y[2];
  const T r3 = p[2] * y[1] * y[1];
  dy[0] = -r1 + r2;
  dy[1] = r1 - r2 - r3;
  dy[2] = r3;
}
"""
STIFF_P_CUDA = """
template <class T>
__device__ void rhs(T t, const T* y, T* dy, const T* p) {
  dy[0] = -p[0] * (y[0] - cos(t));
}
"""
ROB_P = FusedRHS(rob_p, ROB_P_CUDA, 3, 3)
PROBLEMS = {"rob": FusedRHS(rob, ROB_CUDA, 3),
            "pend": FusedRHS(pend, PEND_CUDA, 5),
            "kaps_hidden": FusedRHS(kaps_hidden, KAPS_HIDDEN_CUDA, 2),
            # the JAX package's test_fused_esdirk_params_stiff
            "stiff_p": FusedRHS(
                lambda t, y, p: torch.stack([-p[0] * (y[0] - torch.cos(t))]),
                STIFF_P_CUDA, 1, 1),
            # Robertson's variational system for its three rate constants,
            # as ops.solve_fused_sens builds it
            "rob_aug": _aug_rhs(ROB_P, 3, 3, 0)}
METHODS = {"Kv3I": Kv3I, "TRBDF2": TRBDF2}
M_PEND = np.array([1.0, 1.0, 1.0, 1.0, 0.0])


def pend_start(b, t_bound, rtol, atol, th=(0.3, 0.7), device="cpu"):
    """Consistent (y0, yp0) of ``b`` pendulum members from the f64
    stepper's DAE projection, as float32 ``(b, 5)`` arrays."""
    ths = np.linspace(th[0], th[1], b)
    y0 = np.stack([np.sin(ths), -np.cos(ths), np.zeros(b), np.zeros(b),
                   np.zeros(b)], axis=1)
    stepper = build_stepper(Kv3I, pend, 5, torch.float64, M=np.diag(M_PEND))
    st = stepper.init(0.0, torch.tensor(y0.T, device=device).contiguous(),
                      IVPParams(t_bound=t_bound, direction=1.0, rtol=rtol,
                                atol=atol, max_step=np.inf))
    return st.y.T.float().contiguous(), st.yp.T.float().contiguous()


def _inputs():
    rob0 = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (B, 1))
    rob0[:, 0] = np.linspace(0.9, 1.1, B)
    pend0, pendp0 = (x.numpy() for x in pend_start(B, 0.3, 1e-4, 1e-6))
    a = np.linspace(0.8, 1.2, B)
    kz0 = np.ascontiguousarray((HID_B @ np.stack([a * a, a])).T, np.float32)
    kzp0 = np.ascontiguousarray((HID_B @ np.stack([-2.0 * a * a, -a])).T,
                                np.float32)
    return rob0, pend0, pendp0, kz0, kzp0


ROB0, PEND0, PENDP0, KZ0, KZP0 = _inputs()
# the params cases: a stiff relaxation towards cos(t) at rates 50-500, and
# 8 Robertson members (k1 in [0.04, 0.05]) through the simultaneous
# corrector on their variational system
PSTIFF = np.linspace(50.0, 500.0, B).astype(np.float32)[:, None]
PROB = np.tile([0.04, 1e4, 3e7], (8, 1)).astype(np.float32)
PROB[:, 0] = np.linspace(0.04, 0.05, 8)
ROBA0 = np.concatenate([np.tile(np.array([1.0, 0.0, 0.0], np.float32),
                                (8, 1)), np.zeros((8, 9), np.float32)], 1)
PARAM_CASES = {
    "stiff_params": ("stiff_p", "Kv3I", (0.0, 1.0),
                     np.zeros((B, 1), np.float32), None, None,
                     dict(rtol=1e-4, atol=1e-6)),
    "rob_block": ("rob_aug", "TRBDF2", (0.0, 0.4), ROBA0, None, None,
                  dict(rtol=1e-4, atol=1e-8, block_base=3)),
}
PARAMS = {"stiff_params": PSTIFF, "rob_block": PROB}
# name -> (problem, method, span, y0, yp0, M, options)
CASES = {
    "rob_kv3i": ("rob", "Kv3I", (0.0, 1.0), ROB0, None, None,
                 dict(rtol=1e-4, atol=1e-8)),
    "rob_kv3i_comp": ("rob", "Kv3I", (0.0, 1.0), ROB0, None, None,
                      dict(rtol=1e-6, atol=1e-9, compensated=True)),
    "rob_trbdf2": ("rob", "TRBDF2", (0.0, 1.0), ROB0, None, None,
                   dict(rtol=1e-4, atol=1e-8)),
    "pend_dae": ("pend", "Kv3I", (0.0, 0.3), PEND0, PENDP0, M_PEND,
                 dict(rtol=1e-4, atol=1e-6)),
    "kaps_hidden": ("kaps_hidden", "TRBDF2", (0.0, 1.0), KZ0, KZP0,
                    M_HIDDEN, dict(rtol=1e-4, atol=1e-6)),
}

@pytest.fixture(scope="module")
def jax_results():
    """The JAX kernel's outputs for every case, from
    ``tests/jax_fused_esdirk.npz``, which ``tests/jax_fused_esdirk.py``
    writes from the JAX package (interpret mode takes ~1.5 min for these
    cases), its inputs held equal to these."""
    rec = np.load(Path(__file__).resolve().parent / "jax_fused_esdirk.npz")
    for name, case in {**CASES, **PARAM_CASES}.items():
        y0, yp0 = case[3], case[4]
        np.testing.assert_array_equal(rec[name + "/y0"], y0)
        if yp0 is not None:
            np.testing.assert_array_equal(rec[name + "/yp0"], yp0)
        if name in PARAMS:
            np.testing.assert_array_equal(rec[name + "/params"], PARAMS[name])
    return {k: tuple(rec[f"{k}/{i}"] for i in range(4))
            for k in list(CASES) + list(PARAM_CASES)}


def _port(name, **over):
    prob, meth, span, y0, yp0, M, kw = {**CASES, **PARAM_CASES}[name]
    kw = dict(kw, **over)
    if name in PARAMS:
        kw["params"] = torch.tensor(PARAMS[name])
    res = fused_esdirk_reference(
        PROBLEMS[prob], span, torch.tensor(y0), method=METHODS[meth], M=M,
        yp0_batch=None if yp0 is None else torch.tensor(yp0), **kw)
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference).  Measured on the CPU: rob_kv3i 4.2e-7, 1 step, 11 evals,
# 23 members; rob_kv3i_comp 1.2e-7, 1, 8, 27; rob_trbdf2 3.6e-7, 0, 1, 1;
# pend_dae 4.8e-6, 1, 3, 53; kaps_hidden 1.5e-6, 0, 1, 14; stiff_params
# 1.8e-7, 0, 1, 1; rob_block 2.4e-7 with identical counts.  The first
# attempt of every member is bit-identical where no starting step is
# estimated (pend_dae, kaps_hidden); the counts part where the last bit of
# a step size (pow, log10) moves a Newton residual across its round-off
# floor.  The gates add a margin of about 2x.
GATES = [
    ("rob_kv3i", 1e-6, 2, 22, 46),
    ("rob_kv3i_comp", 5e-7, 2, 16, 54),
    ("rob_trbdf2", 1e-6, 1, 4, 4),
    ("pend_dae", 1e-5, 2, 6, 100),
    ("kaps_hidden", 3e-6, 1, 4, 28),
    ("stiff_params", 4e-7, 1, 2, 2),
    ("rob_block", 5e-7, 0, 0, 0),
]


def test_block_base_sensitivities_match_jax_kernel(jax_results):
    """The simultaneous corrector's sensitivities (each dy/dp_j column over
    its largest entry, which spans 11 decades across j) against the JAX
    kernel's.  Measured: 1.4e-6; the gate allows 2x."""
    y = _port("rob_block")[0]
    jy = jax_results["rob_block"][0]
    S, JS = y[:, 3:].reshape(-1, 3, 3), jy[:, 3:].reshape(-1, 3, 3)
    scaled = np.abs(S - JS).max((0, 2)) / np.abs(JS).max((0, 2))
    assert np.max(scaled) <= 3e-6


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


# -- the JAX tests' own gates, against the port's f64 driver ---------------

def test_robertson_matches_f64_driver():
    """test_fused_esdirk_robertson: within 1e-3 of the f64 driver, total
    steps within 30%."""
    span, kw = (0.0, 10.0), dict(rtol=1e-4, atol=1e-8)
    y, status, nsteps, _ = fused_esdirk_reference(
        PROBLEMS["rob"], span, torch.tensor(ROB0), method=Kv3I, **kw)
    assert torch.all(status == 1)
    out = solve_ensemble(rob, span, torch.tensor(ROB0, dtype=torch.float64),
                         method=Kv3I, **kw)
    assert (y.double() - out.y).abs().max().item() < 1e-3
    total = int(out.nsteps.sum())
    assert abs(int(nsteps.sum()) - total) < 0.3 * total


def test_pendulum_dae_matches_f64_driver():
    """test_fused_esdirk_pendulum_dae: diagonal-M DAE from the f64
    stepper's consistent start; within 1e-3 of the f64 driver and the
    length constraint held to 1e-3."""
    y, status, _, _ = _port("pend_dae")
    assert np.all(status == 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = solve_ensemble(pend, (0.0, 0.3),
                             torch.tensor(PEND0, dtype=torch.float64),
                             method=Kv3I, M=np.diag(M_PEND), rtol=1e-4,
                             atol=1e-6)
    assert np.max(np.abs(y - out.y.numpy())) < 1e-3
    assert np.max(np.abs(y[:, 0] ** 2 + y[:, 1] ** 2 - 1.0)) < 1e-3


def test_compensated_official_tolerances():
    """test_fused_esdirk_compensated_official_tol: rtol 1e-6 / atol 1e-9
    on Robertson to t = 1e5, within 5e-6 (relative) of the f64 driver and
    steps within 15%."""
    y0 = torch.tensor([[1.0, 0.0, 0.0]]).repeat(4, 1)
    yf, status, nsteps, _ = fused_esdirk_reference(
        PROBLEMS["rob"], (0.0, 1e5), y0, rtol=1e-6, atol=1e-9,
        compensated=True)
    assert torch.all(status == 1)
    out = solve(rob, (0.0, 1e5), y0[0].double(), method=Kv3I, rtol=1e-6,
                atol=1e-9, max_steps=20000)
    yx = out.y.numpy()
    rel = np.abs(yf[0].double().numpy() - yx) / np.maximum(np.abs(yx), 1e-12)
    assert np.max(rel) < 5e-6
    assert abs(int(nsteps[0]) - int(out.nsteps)) < 0.15 * int(out.nsteps)


def test_trbdf2_filter_error_matches_f64_driver():
    """test_fused_esdirk_trbdf2_filter_error: the filtered error estimate
    (err -> M W^-1 Sc err) lands within 1e-3 relative of the f64 driver."""
    span, kw = (0.0, 100.0), dict(rtol=1e-4, atol=1e-8)
    y, status, _, _ = fused_esdirk_reference(
        PROBLEMS["rob"], span, torch.tensor(ROB0), method=TRBDF2, **kw)
    assert torch.all(status == 1)
    out = solve_ensemble(rob, span, torch.tensor(ROB0, dtype=torch.float64),
                         method=TRBDF2, **kw)
    rel = ((y.double() - out.y).abs() / (1e-8 + out.y.abs())).max().item()
    assert rel < 1e-3


def test_hidden_mass_matrix_matches_exact():
    """test_fused_esdirk_hidden_mass_matrix: the Kaps DAE behind a dense,
    rank-deficient M, rotated by its SVD on the host: the endpoint within
    3e-4 of the exact solution, steps in the regime of the f64 driver."""
    z0 = HID_B @ np.array([1.0, 1.0])
    zp0 = HID_B @ np.array([-2.0, -1.0])
    Z0 = torch.tensor(z0, dtype=torch.float32).repeat(4, 1)
    ZP0 = torch.tensor(zp0, dtype=torch.float32).repeat(4, 1)
    zf, status, nsteps, _ = fused_esdirk_reference(
        PROBLEMS["kaps_hidden"], (0.0, 1.0), Z0, method=TRBDF2, M=M_HIDDEN,
        yp0_batch=ZP0, rtol=1e-4, atol=1e-6)
    assert torch.all(status == 1)
    yf = HID_BINV @ zf[0].double().numpy()
    exact = np.array([np.exp(-1.0) ** 2, np.exp(-1.0)])
    assert np.max(np.abs(yf - exact)) < 3e-4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = solve(kaps_hidden, (0.0, 1.0), torch.tensor(z0), method=TRBDF2,
                    M=M_HIDDEN, rtol=1e-4, atol=1e-6, first_step=0.01)
    assert int(out.status) == 1
    n64 = int(out.nsteps)
    assert abs(int(nsteps[0]) - n64) <= max(4, 0.35 * n64)


def test_pendulum_bench_line():
    """The slice as a whole at a small size: the bench line's pendulum
    ensemble (theta0 in [0.2, 1.2], M = diag(1, 1, 1, 1, 0), Kv3I) from the
    f64 stepper's consistent start through the fused path, against the f64
    driver on the same members."""
    kw = dict(rtol=1e-4, atol=1e-6)
    y0, yp0 = pend_start(32, 1.0, th=(0.2, 1.2), **kw)
    y, status, nsteps, nfev = solve_fused_esdirk(
        PROBLEMS["pend"], (0.0, 1.0), y0, method=Kv3I, M=M_PEND,
        yp0_batch=yp0, **kw)
    assert torch.all(status == 1)
    assert y.shape == (32, 5) and bool(torch.isfinite(y).all())
    assert (y[:, 0] ** 2 + y[:, 1] ** 2 - 1.0).abs().max().item() < 1e-3
    out = solve_ensemble(pend, (0.0, 1.0), y0.double(), method=Kv3I,
                         M=np.diag(M_PEND), **kw)
    assert torch.all(out.status == 1)
    assert (y.double() - out.y).abs().max().item() < 1e-2
    assert torch.all(nfev > nsteps)


# -- the wrapper, the header and the build ---------------------------------

def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper runs the plain version, with a FusedRHS
    or a bare torch function, and launches no kernel."""
    prob, meth, span, y0, yp0, M, kw = CASES["pend_dae"]
    before = solve_fused_esdirk.launches
    ref = _port("pend_dae")
    for fun in (PROBLEMS[prob], PROBLEMS[prob].torch_fn):
        out = solve_fused_esdirk(fun, span, torch.tensor(y0), method=Kv3I,
                                 M=M, yp0_batch=torch.tensor(yp0), **kw)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), b)
    assert solve_fused_esdirk.launches == before


@pytest.mark.parametrize("option", ["t_eval", "events", "dense"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_fused_esdirk(PROBLEMS["rob"], (0.0, 1.0), torch.tensor(ROB0),
                           **{option: 1})


@pytest.mark.parametrize("prob,y0,kw,match", [
    ("stiff_p", np.zeros((B, 1), np.float32), dict(params=PSTIFF[:-1]),
     "params must be"),
    ("stiff_p", np.zeros((B, 1), np.float32), dict(), "takes 1 parameters"),
    ("rob_aug", ROBA0, dict(params=PROB, block_base=5), "divide n"),
    ("rob_aug", ROBA0, dict(params=PROB, block_base=12), "block_base <= 8"),
    ("rob", np.zeros((8, 72), np.float32), dict(block_base=8), "n <= 64"),
    ("pend", PEND0, dict(block_base=5, M=M_PEND), "no mass matrix"),
    ("rob_aug", ROBA0, dict(params=PROB), "n <= 8")])
def test_option_checks_raise(prob, y0, kw, match):
    """What the JAX kernel checks raises ValueError: params of another shape
    than (B, k) or that the FusedRHS's k does not take; a block_base that
    does not divide n, above 8, or with n above 64; block_base with a mass
    matrix; n above 8 without block_base."""
    with pytest.raises(ValueError, match=match):
        solve_fused_esdirk(PROBLEMS[prob], (0.0, 1.0), torch.tensor(y0), **kw)


def test_dae_needs_consistent_yp0_and_small_n():
    with pytest.raises(ValueError, match="yp0_batch"):
        solve_fused_esdirk(PROBLEMS["pend"], (0.0, 1.0), torch.tensor(PEND0),
                           M=M_PEND)
    with pytest.raises(ValueError, match="n <= 8"):
        solve_fused_esdirk(lambda t, y: -y, (0.0, 1.0), torch.ones(4, 9))


def test_step_cap_counts_attempts():
    """max_steps caps loop iterations (accepted + rejected) with status 3,
    as the JAX kernel's hit_cap does."""
    y, status, nsteps, nfev = fused_esdirk_reference(
        PROBLEMS["rob"], (0.0, 10.0), torch.tensor(ROB0), max_steps=5)
    assert torch.all(status == 3)
    assert torch.all(nsteps <= 5)
    # Kv3I: 3 implicit stages of 1 to 5 Newton iterations per attempt,
    # plus f(t0, y0)
    assert torch.all((nfev >= 1 + 5 * 3) & (nfev <= 1 + 5 * 15))


def test_overflow_member_isolated():
    """A member whose right-hand side overflows fails alone: its Newton
    iterations stop on the non-finite values, the step shrinks to the
    minimum and the member ends with status 2; every other one finishes."""
    x0 = np.full((B, 1), 0.5, np.float32)
    x0[7] = 1e18
    cubic = FusedRHS(lambda t, y: torch.stack([y[0] ** 3]), "", 1)
    y, status, _, _ = fused_esdirk_reference(cubic, (0.0, 1.0),
                                             torch.tensor(x0), method=Kv3I)
    assert int(status[7]) == 2
    assert int((status == 1).sum()) == B - 1
    ok = status == 1
    assert torch.all(torch.isfinite(y[ok]))
    exact = 0.5 / np.sqrt(1.0 - 2.0 * 0.25)           # y' = y^3, y0 = 1/2
    assert (y[ok] - exact).abs().max().item() < 1e-3


def test_generated_header_holds_float32_constants():
    """The kernel's header carries every tableau weight, the mass-matrix
    setup and the controller constants rounded to float32 exactly as the
    JAX kernel rounds them, zeros dropped, and the user's RHS."""
    import re
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_esdirk import (_esdirk_consts,
                                                      _mass_setup)

    def accessor(text, name):
        body = re.search(rf"constexpr \w+ {name}\([^)]*\) {{\n  return "
                         rf"(.*?);\n}}", text, re.S).group(1)
        return {tuple(int(v) for v in re.findall(r"== (\d+)", cond)):
                float.fromhex(val.strip()[:-1])
                for cond, val in re.findall(r"([^?:]+)\?([^:]+):", body)}

    for method, M in ((Kv3I, None), (TRBDF2, M_PEND), (TRBDF2, M_HIDDEN)):
        k = _esdirk_consts(method)
        m_diag, rot = _mass_setup(M, 5 if M is M_PEND else 2)
        n = 5 if M is M_PEND else 2
        text = _build.fused_esdirk_header(k, m_diag, rot, n, ROB_CUDA)
        tab = method.tableau
        assert f"constexpr int S = {tab.n_stages};" in text
        assert ROB_CUDA in text
        assert f"FILTER_ERROR = {str(tab.filter_error).lower()}" in text
        assert f"ROT = {str(rot is not None).lower()}" in text
        for name, ref in (("A", tab.A), ("AZ", tab.Az), ("C", tab.C),
                          ("E", tab.E)):
            got = accessor(text, name)
            ref = np.asarray(ref, np.float32)
            want = {idx: float(v) for idx, v in np.ndenumerate(ref) if v}
            assert got == want, name
        d = re.search(r"constexpr float D = (\S+)f;", text).group(1)
        assert np.float32(float.fromhex(d)) == np.float32(tab.d)
        if M is M_PEND:
            assert "return (i == 4);" in text          # the algebraic row
        if rot is not None:
            v = accessor(text, "V")
            want = {idx: float(np.float32(x))
                    for idx, x in np.ndenumerate(rot[0].T) if np.float32(x)}
            assert v == want


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CPU fallback: where the CUDA toolkit is missing, building the
    kernel raises before anything is written."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_esdirk import _esdirk_consts
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_fused_esdirk(_esdirk_consts(Kv3I), None, None, 3,
                                 ROB_CUDA)
    assert not (tmp_path / "build").exists()


def test_build_key_hashes_shared_headers(monkeypatch, tmp_path):
    """Each kernel's build key covers the shared csrc/*.cuh it includes,
    so an edited shared header cannot load a stale library."""
    import shutil
    from extensisq_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.shared_headers("fused_esdirk")] == [
        "dual.cuh", "esdirk_control.cuh", "hstart.cuh", "member_rhs.cuh",
        "rk_common.cuh", "lane_group.cuh"]
    assert [p.name for p in _build.shared_headers("fused_erk")] == [
        "dual.cuh", "hstart.cuh", "member_rhs.cuh", "rk_common.cuh",
        "rk_control.cuh", "rk_lanes.cuh", "lane_group.cuh"]
    before = {k: _build.build_key(k, "header") for k in ("fused_erk",
                                                         "fused_esdirk")}
    common = csrc / "rk_common.cuh"
    common.write_text(common.read_text() + "\n// edited\n")
    after = {k: _build.build_key(k, "header") for k in before}
    assert all(before[k] != after[k] for k in before)
    control = csrc / "esdirk_control.cuh"
    control.write_text(control.read_text() + "\n// edited\n")
    assert _build.build_key("fused_esdirk", "header") != after["fused_esdirk"]
    assert _build.build_key("fused_erk", "header") == after["fused_erk"]
    assert _build.build_key("fused_erk", "other") != after["fused_erk"]


@pytest.mark.parametrize("members,lanes", [
    (128, 32), (512, 32),        # 16,384 threads: one warp an SM partition
    (1024, 16), (2048, 8),
    (4096, 4),                   # the bench line
    (4225, 1), (8192, 1),        # past 128 threads an SM: one thread
    (262144, 1),
])
def test_lanes_per_member_on_132_sms(members, lanes):
    """B2's lane count on an H100 (132 SMs): the largest of 32, 16, 8 and
    4 lanes per member that keeps the ensemble within 128 threads an SM,
    else one thread per member (the pendulum sweep of
    tools/probe_fused_esdirk.py, PERF.md)."""
    assert FE._lanes_per_member(members, 132, 5) == lanes


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,y_gate", [("rob_kv3i", 1e-4),
                                         ("rob_kv3i_comp", 1e-5),
                                         ("rob_trbdf2", 1e-4),
                                         ("pend_dae", 1e-4),
                                         ("kaps_hidden", 1e-4)])
def test_kernel_matches_plain_version_on_card(cuda, name, y_gate):
    """The CUDA kernel against its plain version on the same card; f32
    round-off (the kernel contracts to FMA) allows other step sequences,
    hence the measured gates of chip_smoke.py."""
    prob, meth, span, y0, yp0, M, kw = CASES[name]
    y0 = torch.tensor(y0, device=cuda)
    yp0 = None if yp0 is None else torch.tensor(yp0, device=cuda)
    before = solve_fused_esdirk.launches
    k = solve_fused_esdirk(PROBLEMS[prob], span, y0, method=METHODS[meth],
                           M=M, yp0_batch=yp0, **kw)
    assert solve_fused_esdirk.launches == before + 1
    r = fused_esdirk_reference(PROBLEMS[prob], span, y0, method=METHODS[meth],
                               M=M, yp0_batch=yp0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    assert (k[0] - r[0]).abs().max().item() <= y_gate


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_lane_body_bit_identical_to_thread_body_on_card(cuda, name):
    """B2's group body at 4, 8, 16 and 32 lanes per member against its
    one-thread body on the card: y, status, nsteps and nfev bit for bit
    (the lanes split only the Jacobian's columns, seeded through the same
    opaque index, and every per-element operation keeps its order and its
    FMA contraction); comparison launches, so the launch count stays."""
    prob, meth, span, y0, yp0, M, kw = CASES[name]
    y0 = torch.tensor(y0, device=cuda)
    yp0 = None if yp0 is None else torch.tensor(yp0, device=cuda)
    kw = dict(kw)
    args = (PROBLEMS[prob], span, y0, METHODS[meth], M, yp0,
            kw.pop("rtol"), kw.pop("atol"), None, 100_000,
            kw.pop("compensated", False), None)
    assert not kw
    before = solve_fused_esdirk.launches
    one, shape = FE._launch(*args, 1)
    assert shape == (1, 128)
    for lanes in (4, 8, 16, 32):
        out, shape = FE._launch(*args, lanes)
        assert shape == (lanes, 128 // lanes)
        torch.cuda.synchronize()
        for a, b in zip(out, one):
            assert torch.equal(a, b), (lanes, name)
    assert solve_fused_esdirk.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("members", [128, 2048, 8192])
def test_wrapper_takes_the_rules_launch_shape(cuda, members):
    """solve_fused_esdirk launches the rule's lanes per member, 128 / G
    members a block, and its result equals the thread body's bit for
    bit (Robertson on a short span)."""
    y0 = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (members, 1))
    y0[:, 0] = np.linspace(0.9, 1.1, members)
    y0 = torch.tensor(y0, device=cuda)
    kw = dict(rtol=1e-4, atol=1e-8)
    k = solve_fused_esdirk(PROBLEMS["rob"], (0.0, 0.1), y0, method=Kv3I,
                           **kw)
    lanes = FE._lanes_per_member(members, torch.cuda.get_device_properties(
        cuda).multi_processor_count, 3)
    assert solve_fused_esdirk.last_shape == (lanes, max(1, 128 // lanes))
    one, _ = FE._launch(PROBLEMS["rob"], (0.0, 0.1), y0, Kv3I, None, None,
                        kw["rtol"], kw["atol"], None, 100_000, False, None,
                        1)
    torch.cuda.synchronize()
    assert bool((k[1] == 1).all())
    for a, b in zip(k, one):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_rhs(cuda):
    y0 = torch.tensor(ROB0, device=cuda)
    with pytest.raises(TypeError, match="FusedRHS"):
        solve_fused_esdirk(rob, (0.0, 1.0), y0)
