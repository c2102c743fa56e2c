"""In-kernel ``t_eval`` snapshots on the port's second-order and implicit
fused kernels (B5, B6, B2, B7), on the CPU.

The plain versions (``fused_rkn_reference``, ``fused_rkn_grid_reference``,
``fused_esdirk_reference``, ``fused_esdirk_grid_reference``) run here; the
JAX package's Pallas kernels in interpret mode (without FMA) are read from
``tests/jax_fused_teval_routes.npz`` (``tests/jax_fused_teval_routes.py``),
on the same inputs: B5 on the Kepler ensemble of the JAX package's
``test_fused_rkn_t_eval``, plain and compensated, with points unsorted,
repeated, before t0 and past tf, with ``params`` (the oscillator of a
member's frequency) and with ``dense``; B6 on the wave of
``test_fused_rkn_grid_wave`` (n = 128), plain and compensated; B2 on
Robertson (plain and compensated), on the pendulum DAE (a diagonal M with
an algebraic row), on the Kaps DAE behind a hidden M and with ``params``;
B7 on config 4d's reaction-diffusion at n = 128, plain and compensated.
Every case gives ``first_step``, and one attempt of B5, B6, B2 and B7
with points inside the first step is held bit for bit.  The invariants of
the snapshots run on the plain versions alone: the four outputs bit for
bit those without ``t_eval``, rows at or before t0 exactly y0, rows a
member never reaches exactly its final state, an overflowing member's
rows apart from its neighbours', the RKN rows the cubic Hermite of ``[u,
v]`` with derivative ``[v, a]``, and the dense output at the points
against ``y_eval``.

The tests marked ``gpu`` hold the kernels against these plain versions on
the card (the snapshot build's four outputs bit for bit the build without
it at every shape the rule can take; B2's rows under the hidden M in user
coordinates); they skip where there is none.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import Fi5N, Kv3I, TRBDF2
from extensisq_tpu_torch.ops import (FusedAcc, FusedGridAcc,
                                     fused_esdirk_grid_reference,
                                     fused_esdirk_reference,
                                     fused_rkn_grid_reference,
                                     fused_rkn_reference, solve_fused,
                                     solve_fused_esdirk,
                                     solve_fused_esdirk_grid,
                                     solve_fused_rkn, solve_fused_rkn_grid)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_esdirk as T  # noqa: E402
import test_torch_fused_esdirk_grid as TEG  # noqa: E402

FIXTURE_PATH = Path(__file__).resolve().parent / "jax_fused_teval_routes.npz"
N_KEP = 64          # Kepler members (the JAX test's 128, halved)
N_WAVE = 128        # the JAX test's wave
B_WAVE = 8
N_ESDIRK = 32       # members of the B2 cases (the JAX tests' 128, cut)
METHODS = {"Fi5N": Fi5N, "Kv3I": Kv3I, "TRBDF2": TRBDF2}


def kepler(t, u, v):
    r2 = u[0] ** 2 + u[1] ** 2
    a = -1.0 / (r2 * torch.sqrt(r2))
    return torch.stack([a * u[0], a * u[1]])


def duffing(t, u, v):
    return -u - 0.5 * u ** 3 - 0.1 * v


def cubic(t, u, v):
    return u ** 3


def osc_p(t, u, v, p):
    """u'' = -w^2 u with the frequency w a member's parameter."""
    return -(p[0] ** 2) * u


def wave(t, u, v):
    """The JAX test's wave, c2 = 400 on the unit-spaced ring."""
    return 400.0 * (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) - 2.0 * u)


def wave_cubic(t, u, v):
    return wave(t, u, v) + u ** 3


WAVE_CUDA = """__device__ float acc(float t, const float* u, const float* v,
                    int i, const float* p) {
  using G = tab::G;
  return 400.0f * (G::rolled<0>(u, i, 1) + G::rolled<0>(u, i, -1)
                   - 2.0f * u[i]);
}"""
ACC = {
    "kepler": FusedAcc(kepler, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  const T r2 = u[0] * u[0] + u[1] * u[1];
  const T s = -1.0f / (r2 * sqrtf(r2));
  a[0] = s * u[0];
  a[1] = s * u[1];
}""", 2),
    "duffing": FusedAcc(duffing, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  for (int k = 0; k < 2; ++k) a[k] = -u[k] - 0.5f * u[k] * u[k] * u[k]
                                     - 0.1f * v[k];
}""", 2),
    "cubic": FusedAcc(cubic, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  a[0] = u[0] * u[0] * u[0];
}""", 1),
    "osc_p": FusedAcc(osc_p, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a, const T* p) {
  a[0] = -(p[0] * p[0]) * u[0];
}""", 1, 1),
    "wave": FusedGridAcc(wave, WAVE_CUDA, N_WAVE),
    "wave_cubic": FusedGridAcc(wave_cubic, WAVE_CUDA.replace(
        "- 2.0f * u[i]);", "- 2.0f * u[i]) + u[i] * u[i] * u[i];"),
        N_WAVE),
}
RHS = {"rob": T.PROBLEMS["rob"], "pend": T.PROBLEMS["pend"],
       "kaps_hidden": T.PROBLEMS["kaps_hidden"],
       "stiff_p": T.PROBLEMS["stiff_p"], "rdiff": TEG.RHS["rdiff"]}


def inputs():
    """name -> array of every case's seeded inputs."""
    ecc = np.linspace(0.1, 0.5, N_KEP)
    kep = np.stack([1 - ecc, np.zeros(N_KEP), np.zeros(N_KEP),
                    np.sqrt((1 + ecc) / (1 - ecc))], 1).astype(np.float32)
    duf = np.stack([np.linspace(0.5, 2.0, 32), np.linspace(-1.0, 1.0, 32),
                    np.zeros(32), np.linspace(0.5, -0.5, 32)],
                   1).astype(np.float32)
    cub = np.stack([np.full(16, 0.1), np.zeros(16)], 1).astype(np.float32)
    cub[7, 0] = 1e18                  # this member blows up in f32
    osc = np.stack([np.ones(16), np.zeros(16)], 1).astype(np.float32)
    x = np.linspace(0, 1, N_WAVE, endpoint=False)
    wu = (np.linspace(0.5, 1.5, B_WAVE)[:, None]
          * np.sin(2 * np.pi * x)[None, :])
    wav = np.concatenate([wu, np.zeros_like(wu)], 1).astype(np.float32)
    wcub = wav.copy()
    wcub[3, :N_WAVE] *= 1e13          # this member blows up in f32
    n = N_ESDIRK
    return {"kepler": kep, "duffing": duf, "cubic": cub, "osc": osc,
            "osc_w": np.linspace(1.0, 2.0, 16).astype(np.float32)[:, None],
            "wave": wav, "wave_cubic": wcub,
            "rob": T.ROB0[:n], "pend": T.PEND0[:n], "pend_yp": T.PENDP0[:n],
            "kaps": T.KZ0[:n], "kaps_yp": T.KZP0[:n],
            "stiff": np.zeros((n, 1), np.float32),
            "stiff_k": T.PSTIFF[::128 // n].copy(),
            "rdiff": TEG.Y0["rdiff"]}


Y0 = inputs()
TWO_PI = 2 * np.pi
# name -> (kernel, problem, method, span, y0, options); the options name
# the inputs of params, yp0 and M by their keys of Y0 (M by "M_PEND" or
# "M_HIDDEN"); every case gives first_step and points
CASES = {
    "b5_kepler": ("rkn", "kepler", "Fi5N", (0.0, TWO_PI), "kepler",
                  dict(rtol=1e-5, atol=1e-7, first_step=0.01,
                       t_eval=[5.0, 0.0, np.pi, 1.5, 1.5, -0.5, TWO_PI,
                               7.0])),
    "b5_kepler_comp": ("rkn", "kepler", "Fi5N", (0.0, TWO_PI), "kepler",
                       dict(rtol=1e-7, atol=1e-9, first_step=0.01,
                            compensated=True,
                            t_eval=[5.0, 0.0, np.pi, 1.5, 1.5, -0.5,
                                    TWO_PI, 7.0])),
    "b5_params": ("rkn", "osc_p", "Fi5N", (0.0, 2.0), "osc",
                  dict(rtol=1e-6, atol=1e-9, first_step=0.01,
                       params="osc_w",
                       t_eval=[1.0, 0.0, 0.5, 2.0, 3.0, 0.25, 1.0])),
    "b5_dense": ("rkn", "kepler", "Fi5N", (0.0, TWO_PI), "kepler",
                 dict(rtol=1e-5, atol=1e-7, first_step=0.01, dense=128,
                      t_eval=[5.0, 0.0, np.pi, 1.5, 1.5, -0.5, TWO_PI,
                              7.0])),
    "b5_first": ("rkn", "duffing", "Fi5N", (0.0, 5.0), "duffing",
                 dict(rtol=1e-5, atol=1e-7, first_step=0.01, max_steps=1,
                      t_eval=[0.005, 0.0, 0.01, 0.0025, 0.5, -0.1, 0.005])),
    "b6_wave": ("rkn_grid", "wave", "Fi5N", (0.0, 4.0), "wave",
                dict(rtol=1e-5, atol=1e-7, first_step=0.05,
                     t_eval=[2.0, 0.0, 4.0, 1.0, 1.0, -1.0, 5.0, 3.3])),
    "b6_wave_comp": ("rkn_grid", "wave", "Fi5N", (0.0, 0.5), "wave",
                     dict(rtol=1e-6, atol=1e-9, first_step=0.05,
                          compensated=True,
                          t_eval=[2.0, 0.0, 0.5, 0.25, 0.25, -1.0, 0.35])),
    "b6_first": ("rkn_grid", "wave", "Fi5N", (0.0, 4.0), "wave",
                 dict(rtol=1e-5, atol=1e-7, first_step=0.05, max_steps=1,
                      t_eval=[0.025, 0.0, 0.05, 0.01, 1.0, 0.025])),
    "b2_rob": ("esdirk", "rob", "Kv3I", (0.0, 100.0), "rob",
               dict(rtol=1e-4, atol=1e-8, first_step=1e-4,
                    t_eval=[50.0, 0.0, 1.0, 10.0, 10.0, -1.0, 100.0,
                            200.0])),
    "b2_rob_comp": ("esdirk", "rob", "Kv3I", (0.0, 0.1), "rob",
                    dict(rtol=1e-6, atol=1e-9, first_step=1e-4,
                         compensated=True,
                         t_eval=[0.05, 0.0, 0.1, 0.01, 0.01, -1.0, 0.2])),
    "b2_pend": ("esdirk", "pend", "Kv3I", (0.0, 0.3), "pend",
                dict(rtol=1e-4, atol=1e-6, first_step=0.003, M="M_PEND",
                     yp0_batch="pend_yp",
                     t_eval=[0.1, 0.0, 0.3, 0.05, 0.05, -0.1, 0.4])),
    "b2_kaps": ("esdirk", "kaps_hidden", "TRBDF2", (0.0, 1.0), "kaps",
                dict(rtol=1e-4, atol=1e-6, first_step=0.01, M="M_HIDDEN",
                     yp0_batch="kaps_yp",
                     t_eval=[0.5, 0.0, 1.0, 0.25, 0.25, -0.5, 2.0])),
    "b2_params": ("esdirk", "stiff_p", "Kv3I", (0.0, 1.0), "stiff",
                  dict(rtol=1e-4, atol=1e-6, first_step=1e-3,
                       params="stiff_k",
                       t_eval=[0.5, 0.0, 1.0, 0.1, 0.1, 2.0])),
    "b2_first": ("esdirk", "rob", "Kv3I", (0.0, 100.0), "rob",
                 dict(rtol=1e-4, atol=1e-8, first_step=1e-4, max_steps=1,
                      t_eval=[5e-5, 0.0, 1e-4, 2.5e-5, 1.0, -1.0])),
    "b7_rd": ("esdirk_grid", "rdiff", "Kv3I", (0.0, 0.1), "rdiff",
              dict(rtol=1e-4, atol=1e-6, first_step=1e-3,
                   t_eval=[0.03, 0.0, 0.1, 0.05, 0.05, -0.01, 0.2])),
    "b7_rd_comp": ("esdirk_grid", "rdiff", "Kv3I", (0.0, 0.02), "rdiff",
                   dict(rtol=1e-6, atol=1e-9, first_step=1e-4,
                        compensated=True,
                        t_eval=[0.01, 0.0, 0.02, 0.005, 0.005, 0.03])),
    "b7_first": ("esdirk_grid", "rdiff", "Kv3I", (0.0, 0.1), "rdiff",
                 dict(rtol=1e-4, atol=1e-6, first_step=1e-3, max_steps=1,
                      t_eval=[5e-4, 0.0, 1e-3, 2.5e-4, 0.05])),
}
FIRST = ["b5_first", "b6_first", "b2_first", "b7_first"]
MASS = {"M_PEND": T.M_PEND, "M_HIDDEN": T.M_HIDDEN}
PLAIN = {"rkn": fused_rkn_reference, "rkn_grid": fused_rkn_grid_reference,
         "esdirk": fused_esdirk_reference,
         "esdirk_grid": fused_esdirk_grid_reference}
WRAPPER = {"rkn": solve_fused_rkn, "rkn_grid": solve_fused_rkn_grid,
           "esdirk": solve_fused_esdirk,
           "esdirk_grid": solve_fused_esdirk_grid}


def spec(name):
    """(kernel, problem, method, span, y0 (numpy), options with the inputs
    filled in as numpy arrays and t_eval as float32) of a case: what the
    JAX script and the tests run."""
    kind, prob, meth, span, y0, kw = CASES[name]
    kw = dict(kw)
    for key in ("params", "yp0_batch"):
        if key in kw:
            kw[key] = Y0[kw[key]]
    if "M" in kw:
        kw["M"] = MASS[kw["M"]]
    kw["t_eval"] = np.asarray(kw["t_eval"], np.float32)
    return kind, prob, meth, span, Y0[y0], kw


def _fun(kind, prob):
    return ACC[prob] if kind.startswith("rkn") else RHS[prob]


def _port(name, fn=None, device="cpu", **over):
    """The outputs of a case by its plain version (or by ``fn``, taking the
    plain version's arguments) on ``device``, with the options ``over``
    (``t_eval=None`` drops the points); the plain version's run of a case
    as it stands on the CPU is made once (``_plain``)."""
    if fn is None and device == "cpu" and not over:
        return _plain(name)
    kind, prob, meth, span, y0, kw = spec(name)
    kw = {k: (torch.tensor(v, device=device)
              if k in ("params", "yp0_batch") else v)
          for k, v in dict(kw, **over).items()}
    if kw.get("t_eval") is None:
        kw.pop("t_eval", None)
    return (fn or PLAIN[kind])(_fun(kind, prob), span,
                               torch.tensor(y0, device=device),
                               method=METHODS[meth], **kw)


@functools.lru_cache(maxsize=None)
def _plain(name):
    """The plain version's outputs of a case on the CPU, made once; the
    tests read them and change nothing in them."""
    return _port(name, t_eval=spec(name)[5]["t_eval"])


def _np(out):
    return tuple(r.cpu().numpy() if isinstance(r, torch.Tensor) else r
                 for r in out)


def _fixture():
    return np.load(FIXTURE_PATH)


def _jax(name):
    fx = _fixture()
    return tuple(fx[f"{name}/{i}"] for i in range(5))


# (case, max |dy|, max |dy_eval|, max |dnsteps|, max |dnfev|, members
# with other counts), measured on the CPU against the JAX kernels:
# b5_kepler and b5_dense 1.6e-5, 1.2e-4, 1, 12, 3 of 64; b5_kepler_comp
# 1.0e-5, 1.0e-5, 2, 18, 31 of 64; b5_params 6.9e-7, 2.4e-6, 1, 6, 1 of
# 16; b6_wave 1.8e-3, 2.0e-3, 1, 24, 8 of 8; b6_wave_comp 1.1e-5, 1.1e-5,
# 4, 30, 7 of 8; b2_rob 3.6e-7, 5.4e-7, 0, 0, 0 of 32; b2_rob_comp
# 7.0e-10, 1.2e-7, 0, 8, 3; b2_pend 4.8e-6, 4.8e-6, 0, 3, 19; b2_kaps
# 6.7e-7, 7.5e-7, 0, 1, 5; b2_params 2.4e-7, 2.4e-6, 0, 1, 1; b7_rd
# 1.3e-5, 1.3e-5, 2, 12, 2 of 8; b7_rd_comp 2.0e-6, 2.0e-6, 1, 12, 7 of 8.
# From the second attempt XLA's and PyTorch's float32 pow part the last
# bits of h (and the ESDIRK kernels' Newton iterations the nfev), so the
# counts stay within a few attempts and the rows follow the steps; the
# one-attempt cases (FIRST_GATES) hold the first step.  The gates add
# about 2x (the members with other counts at most the batch).
GATES = [
    ("b5_kepler", 4e-5, 3e-4, 2, 24, 6),
    ("b5_kepler_comp", 2.5e-5, 2.5e-5, 4, 36, 40),
    ("b5_params", 1.5e-6, 5e-6, 2, 12, 2),
    ("b5_dense", 4e-5, 3e-4, 2, 24, 6),
    ("b6_wave", 4e-3, 4e-3, 2, 48, 8),
    ("b6_wave_comp", 2.5e-5, 2.5e-5, 8, 60, 8),
    ("b2_rob", 8e-7, 1.2e-6, 1, 2, 2),
    ("b2_rob_comp", 2e-9, 2.5e-7, 1, 16, 6),
    ("b2_pend", 1e-5, 1e-5, 1, 6, 26),
    ("b2_kaps", 1.5e-6, 1.5e-6, 1, 2, 10),
    ("b2_params", 5e-7, 5e-6, 1, 2, 2),
    ("b7_rd", 3e-5, 3e-5, 4, 24, 4),
    ("b7_rd_comp", 5e-6, 5e-6, 2, 24, 8),
]
# one attempt against the JAX kernel, max |dy| and |dy_eval|: B5 (the
# Duffing acceleration, a polynomial), B2 and B7 bit for bit; B6's wave
# parts in the last bit at a few positions (1.5e-8), gate 2x
FIRST_GATES = {"b5_first": 0.0, "b6_first": 3e-8, "b2_first": 0.0,
               "b7_first": 0.0}
# b5_dense's dense output against JAX's at eight times (1.8e-4: the steps
# part as in b5_kepler) and against its own y_eval (2.4e-7); gates about
# 2x and 4x
DENSE_GATES = (4e-4, 1e-6)


@pytest.mark.parametrize("name,y_gate,yq_gate,dsteps,dfev,nmembers", GATES)
def test_reference_matches_jax_kernel(name, y_gate, yq_gate, dsteps, dfev,
                                      nmembers):
    """The plain versions against the JAX kernels, the outputs in JAX's
    order (y, status, nsteps, nfev, y_eval[, sol]), y_eval's rows at each
    point's index in t_eval: unsorted, repeated and out-of-span points
    included; B2's rows behind the hidden M in user coordinates on both
    sides (JAX maps them by V after its kernel)."""
    out = _np(_port(name))
    jx = _jax(name)
    assert len(out) == 5 + (1 if CASES[name][5].get("dense") else 0)
    y, status, nsteps, nfev, y_eval = out[:5]
    np.testing.assert_array_equal(status, jx[1])
    assert np.all(status == 1)
    assert y_eval.shape == jx[4].shape
    assert np.max(np.abs(y - jx[0])) <= y_gate
    assert np.max(np.abs(y_eval - jx[4])) <= yq_gate
    assert np.max(np.abs(nsteps - jx[2])) <= dsteps
    assert np.max(np.abs(nfev - jx[3])) <= dfev
    assert np.sum((nsteps != jx[2]) | (nfev != jx[3])) <= nmembers


@pytest.mark.parametrize("name", FIRST)
def test_first_attempt_rows_match_jax_kernel(name):
    """One attempt of every member from ``first_step`` (its first, the JAX
    kernel's), with points inside the step, before t0 and past it: the
    counts and status are the JAX kernel's and the rows of the points it
    crosses (the cubic Hermite in _hermite_tiles' order), of those at or
    before t0 (y0) and of those past it (the final state) are within the
    gates."""
    out = _np(_port(name))
    jx = _jax(name)
    assert np.all(out[1] == 3)
    for a, b in zip(out[1:4], jx[1:4]):
        np.testing.assert_array_equal(a, b)
    assert np.max(np.abs(out[0] - jx[0])) <= FIRST_GATES[name]
    assert np.max(np.abs(out[4] - jx[4])) <= FIRST_GATES[name]


def test_dense_output_after_y_eval():
    """With ``dense`` and ``t_eval`` the dense output comes last, after
    y_eval (JAX's order); it agrees with JAX's at eight times and with
    y_eval at the points inside the span (both the step's cubic Hermite of
    [u, v] with derivative [v, a], summed in other orders)."""
    out = _port("b5_dense")
    fx = _fixture()
    sol = out[5]
    got = sol(torch.tensor(fx["dense_times"], dtype=torch.float32))
    assert np.max(np.abs(got.numpy() - fx["b5_dense/dense"])) <= DENSE_GATES[0]
    np.testing.assert_array_equal(sol.valid.numpy(), fx["b5_dense/valid"])
    _, _, _, span, _, kw = spec("b5_dense")
    tq = kw["t_eval"]
    inside = (tq >= span[0]) & (tq <= span[1])
    at = sol(torch.tensor(tq[inside])).permute(2, 0, 1)
    assert float((at - out[4][inside]).abs().max()) <= DENSE_GATES[1]
    for a, b in zip(out[:5], _port("b5_kepler")):
        assert torch.equal(a, b)


# the cases of each plain version with points (the one-attempt cases
# aside), and of them one a kernel and mode (B5 also with the record, B2
# also behind the diagonal and the hidden M), for the bit-for-bit check
TEVAL_CASES = [n for n in CASES if n not in FIRST]
BIT_CASES = ["b5_kepler", "b5_kepler_comp", "b5_dense", "b6_wave",
             "b6_wave_comp", "b2_rob_comp", "b2_pend", "b2_kaps", "b7_rd",
             "b7_rd_comp"]


@pytest.mark.parametrize("name", BIT_CASES)
def test_t_eval_leaves_the_outputs_bit_for_bit(name):
    """The four outputs with ``t_eval`` are those without it, bit for bit,
    and so is the dense record beside it."""
    out = _port(name)
    off = _port(name, t_eval=None)
    assert len(out) == len(off) + 1
    for a, b in zip(out[:4], off[:4]):
        assert torch.equal(a, b)
    if len(off) > 4:
        for a, b in zip(out[5], off[4]):
            assert torch.equal(a, b)


def _initial_rows(name, y0):
    """What a row at or before t0 holds: y0, or under a dense or hidden M
    y0 through the kernel's coordinates and back (V V^T y0, as JAX's rows
    start at the rotated y0 and are mapped by V after its kernel)."""
    if CASES[name][5].get("M") != "M_HIDDEN":
        return y0
    from extensisq_tpu_torch.ops.fused_esdirk import _mass_setup, _mat_rows
    vh = _mass_setup(T.M_HIDDEN, 2)[1][0]
    w = torch.stack(_mat_rows(vh, list(y0.T)))
    return torch.stack(_mat_rows(vh.T, list(w))).T


@pytest.mark.parametrize("name", TEVAL_CASES)
def test_rows_before_t0_and_unreached_rows_exact(name):
    """Rows of points at or before t0 are y0 (behind the hidden M, y0
    through the rotation and back, within 1e-7 of y0) and rows of points a
    member never reaches are its final state, bit for bit: past tf, and
    where ``max_steps`` stops the members early (status 3) every point past
    their last accepted step."""
    _, _, _, span, y0, kw = spec(name)
    y0 = torch.tensor(y0)
    tq = kw["t_eval"]
    span = np.float32(span)             # as the loops take it
    d = np.sign(span[1] - span[0])
    start = _initial_rows(name, y0)
    assert float((start - y0).abs().max()) <= 1e-7
    for max_steps in (None, 3):
        over = {} if max_steps is None else dict(max_steps=max_steps)
        out = _port(name, **over)
        for q in np.flatnonzero(d * tq <= d * span[0]):
            assert torch.equal(out[4][q], start)
        if max_steps is None:
            assert torch.all(out[1] == 1)
            for q in np.flatnonzero(d * tq > d * span[1]):
                assert torch.equal(out[4][q], out[0])
        else:
            assert torch.all(out[1] == 3)
            # the last point inside the span lies beyond three attempts
            far = int(np.argmax(np.where(d * tq < d * span[1], d * tq,
                                         -np.inf)))
            assert torch.equal(out[4][far], out[0])


OVERFLOW = {"b5": ("rkn", "cubic", (0.0, 1.0), "cubic", 7),
            "b6": ("rkn_grid", "wave_cubic", (0.0, 0.5), "wave_cubic", 3)}


@pytest.mark.parametrize("kind", list(OVERFLOW))
def test_overflowing_member_keeps_to_its_rows(kind):
    """A member whose state overflows ends with status 3 and its rows keep
    its last finite state, while its neighbours' rows are bit for bit
    those of the run where it is finite."""
    plain, prob, span, y0, bad = OVERFLOW[kind]
    fun = ACC[prob]
    y0 = torch.tensor(Y0[y0])
    good = y0.clone()
    good[bad] = y0[bad - 1]
    kw = dict(method=Fi5N, rtol=1e-4, atol=1e-6, max_steps=2000,
              t_eval=np.linspace(span[0], span[1], 6).astype(np.float32))
    out = PLAIN[plain](fun, span, y0, **kw)
    ref = PLAIN[plain](fun, span, good, **kw)
    assert int(out[1][bad]) == 3 and int((out[1] == 1).sum()) == len(y0) - 1
    keep = torch.arange(len(y0)) != bad
    assert torch.equal(out[4][:, keep], ref[4][:, keep])
    assert bool(torch.isfinite(out[4][:, bad]).all())


def _hermite(theta, h, y, f, y1, f1):
    """The cubic Hermite in float32 numpy, _hermite_tiles' operations in
    its order."""
    f32 = np.float32
    s = np.clip(theta, f32(0), f32(1)).astype(f32)
    s2 = s * s
    s3 = s2 * s
    c00 = (f32(2) * s3 - f32(3) * s2) + f32(1)
    c10 = h * ((s3 - f32(2) * s2) + s)
    c01 = f32(3) * s2 - f32(2) * s3
    c11 = h * (s3 - s2)
    return ((c00 * y + c10 * f) + c01 * y1) + c11 * f1


@pytest.mark.parametrize("name", ["b5_first", "b6_first"])
def test_rkn_rows_are_the_hermite_of_u_v_with_derivative_v_a(name):
    """One accepted step of the RKN loops from (t0, u0, v0) of size h to
    (t0 + h, u1, v1): each crossed point's row is, bit for bit, JAX's
    partitioned cubic Hermite, its u entries from (u0, v0) to (u1, v1) and
    its v entries from (v0, a0) to (v1, a1), with a the acceleration at
    the step's ends: the Hermite of [u, v] with derivative [v, a]."""
    kind, prob, _, span, y0, kw = spec(name)
    out = _np(_port(name))
    fun = ACC[prob].torch_fn
    m = y0.shape[1] // 2
    h = np.float32(kw["first_step"])
    t0 = np.float32(span[0])
    t1 = np.float32(t0 + h)
    y1 = out[0]
    a0 = fun(torch.full((len(y0),), float(t0)), torch.tensor(y0[:, :m].T),
             torch.tensor(y0[:, m:].T)).numpy().T
    a1 = fun(torch.full((len(y0),), float(t1)), torch.tensor(y1[:, :m].T),
             torch.tensor(y1[:, m:].T)).numpy().T
    crossed = 0
    for q, tq in enumerate(kw["t_eval"]):
        if not (tq > t0 and tq <= t1):
            continue
        theta = np.float32((tq - t0) / h)
        u = _hermite(theta, h, y0[:, :m], y0[:, m:], y1[:, :m], y1[:, m:])
        v = _hermite(theta, h, y0[:, m:], a0, y1[:, m:], a1)
        np.testing.assert_array_equal(out[4][q], np.concatenate([u, v], 1))
        crossed += 1
    assert crossed >= 3


def test_front_door_and_wrappers_on_cpu():
    """``ops.solve_fused`` routes Fi5N and Kv3I with a FusedAcc,
    FusedGridAcc, FusedRHS or FusedGridRHS and ``t_eval`` to B5, B6, B2 and
    B7, and the wrappers on CPU tensors run the plain versions (no launch),
    bit for bit; an empty t_eval returns the four outputs."""
    for name in ("b5_params", "b6_wave", "b2_kaps", "b7_rd"):
        kind = CASES[name][0]
        wrapper = WRAPPER[kind]
        before = wrapper.launches
        ref = _port(name)
        for fn in (wrapper, solve_fused):
            out = _port(name, fn=fn)
            assert len(out) == len(ref) == 5
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
        assert wrapper.launches == before
        assert len(_port(name, t_eval=[], max_steps=1)) == 4


@pytest.mark.parametrize("solve_fn", [solve_fused_rkn, solve_fused_rkn_grid,
                                      solve_fused_esdirk,
                                      solve_fused_esdirk_grid])
def test_events_still_raise(solve_fn):
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        solve_fn(lambda t, u, v=None: u, (0.0, 1.0), torch.ones(4, 2),
                 events=lambda t, y: y)


def test_t_eval_still_raises_on_the_other_kernels():
    """B3, B8, B9 and B10 still refuse ``t_eval``, naming ROADMAP queue
    B."""
    from extensisq_tpu_torch.ops import (solve_fused_adams,
                                         solve_fused_adams_grid,
                                         solve_fused_rkc,
                                         solve_fused_rkc_ensemble)
    y = torch.ones(4, 2)
    for fn, y0 in ((solve_fused_adams, y), (solve_fused_adams_grid, y),
                   (solve_fused_rkc, torch.ones(8, 8)),
                   (solve_fused_rkc_ensemble, torch.ones(2, 8, 8))):
        with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
            fn(lambda t, y: -y, (0.0, 1.0), y0, t_eval=[0.5])


def test_generated_headers_carry_the_switch():
    """The generated headers of B5, B6, B2 and B7 carry tab::SNAP where
    asked."""
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_esdirk import (_esdirk_consts,
                                                      _mass_setup)
    from extensisq_tpu_torch.ops.fused_rkn import rkn_consts
    k, ke = rkn_consts(Fi5N), _esdirk_consts(Kv3I)
    for snap in (False, True):
        flag = f"constexpr bool SNAP = {'true' if snap else 'false'};"
        kep, wav, rob, rd = (ACC["kepler"], ACC["wave"], RHS["rob"],
                             RHS["rdiff"])
        assert flag in _build.fused_rkn_header(k, 2, kep.cuda_src, 0, False,
                                               snap)
        assert flag in _build.fused_rk_grid_header(
            k, True, (N_WAVE,), wav.cuda_src, 0, False, snap)
        assert flag in _build.fused_esdirk_header(
            ke, *_mass_setup(T.M_HIDDEN, 2), 2, rob.cuda_src, 0, None,
            False, snap)
        assert flag in _build.fused_esdirk_grid_header(
            ke, rd.shape, rd.cuda_src, 0, None, False, snap)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# each kernel with snapshots against its plain version on the card: (max
# |dy|, max |dy_eval|) over the finished members.  Measured on an H100
# (NVIDIA H100 80GB HBM3, 700 W; nvcc's contraction moves h, so a member
# may take other steps, and its rows then come from other cubic Hermites;
# the largest y_eval over the shapes): b5_kepler 3.9e-5, 2.8e-4;
# b5_kepler_comp 6.0e-6, 6.1e-6; b5_params 9.5e-7, 8.1e-5; b6_wave 1.6e-3,
# 1.6e-3; b6_wave_comp 1.5e-5, 1.5e-5; b2_rob 4.8e-7, 4.8e-7; b2_rob_comp
# 3.7e-9, 1.2e-7; b2_pend 2.9e-6, 4.8e-6; b2_kaps 2.1e-6,
# 1.2e-5; b2_params 3.6e-7, 1.3e-6; b7_rd 1.4e-5, 1.4e-5; b7_rd_comp
# 2.7e-6, 3.0e-6; the same y_eval at every shape of B5 and B2.  Gates
# about 3x
CARD_GATES = {"b5_kepler": (1.2e-4, 9e-4), "b5_kepler_comp": (2e-5, 2e-5),
              "b5_params": (3e-6, 2.5e-4), "b6_wave": (5e-3, 5e-3),
              "b6_wave_comp": (5e-5, 5e-5), "b2_rob": (1.6e-6, 1.6e-6),
              "b2_rob_comp": (2e-8, 4e-7), "b2_pend": (9e-6, 1.5e-5),
              "b2_kaps": (6e-6, 4e-5), "b2_params": (1.1e-6, 4e-6),
              "b7_rd": (4e-5, 4e-5), "b7_rd_comp": (9e-6, 1e-5)}
# one attempt (FIRST) on the card against the plain version, y and y_eval:
# only nvcc's contraction parts them (measured 7.5e-9, 1.1e-8, 6.8e-13 and
# 2.7e-7 on B5, B6, B2 and B7)
CARD_FIRST_GATE = 1e-6


def _card_shapes(kind, y0):
    """Every shape the kind's rule can take: B5's lanes (1, 2, 4, 8), B2's
    (1, 4, 8, 16, 32), B6's and B7's blocks of one and two elements a
    thread and the warp."""
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    from extensisq_tpu_torch.ops.fused_erk_grid import grid_threads as t
    n = y0.shape[1] // (2 if kind == "rkn_grid" else 1)
    return {"rkn": [1, 2, 4, 8], "esdirk": [1, 4, 8, 16, 32],
            "rkn_grid": [(t(n), 0), (t(-(-n // 2)), 0),
                         (32, FNG.WARP_MEMBERS)],
            "esdirk_grid": [(t(n), 0), (t(-(-n // 2)), 0),
                            (32, FEG.WARP_MEMBERS)]}[kind]


def _card_launch(name, shape, device, snap=True, **over):
    """A case forced to ``shape`` on the card (a comparison launch, not
    counted), with its points (without ``snap``: the build without the
    snapshots, no points) and the options ``over``."""
    from extensisq_tpu_torch.ops import fused_esdirk as FE
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn as FN
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    kind, prob, meth, span, y0, kw = spec(name)
    fun, meth = _fun(kind, prob), METHODS[meth]
    y0 = torch.tensor(y0, device=device)
    kw = {k: (torch.tensor(v, device=device)
              if k in ("params", "yp0_batch") else v)
          for k, v in dict(kw, **over).items()}
    tq = kw.pop("t_eval") if snap else None
    kw.pop("t_eval", None)
    kw.pop("dense", None)
    rtol, atol = kw.pop("rtol"), kw.pop("atol")
    first, comp = kw.pop("first_step"), kw.pop("compensated", False)
    steps, params = kw.pop("max_steps", 100_000), kw.pop("params", None)
    if kind == "rkn":
        return FN._launch(fun, span, y0, meth, rtol, atol, first, steps,
                          comp, None, shape, None, params, None, tq)[0]
    if kind == "esdirk":
        return FE._launch(fun, span, y0, meth, kw.get("M"),
                          kw.get("yp0_batch"), rtol, atol, first, steps,
                          comp, None, shape, None, params, None, None,
                          tq)[0]
    opts = dict(rtol=rtol, atol=atol, first_step=first, max_steps=steps,
                compensated=comp, params=params, t_eval=tq)
    if kind == "rkn_grid":
        built = FNG._kernel(meth, fun, False, tq is not None)
        return FNG._launch(built, span, y0, y0.shape[1] // 2, shape=shape,
                           **opts)[0]
    built = FEG._kernel(meth, fun, None, False, tq is not None)
    return FEG._launch(built, span, y0, method=meth, M=kw.get("M"),
                       yp0_batch=kw.get("yp0_batch"), shape=shape, **opts)[0]


def _finished_err(a, b, ok):
    return float((a[..., ok, :] - b[..., ok, :]).abs().max()) if ok.any() \
        else 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_y_eval_matches_plain_version_on_card(cuda, name):
    """Each kernel's snapshot build through its wrapper (one launch)
    against its plain version on the card: status identical, y and y_eval
    within the card gates (B2's rows behind the hidden M in user
    coordinates on both)."""
    wrapper = WRAPPER[CASES[name][0]]
    before = wrapper.launches
    k = _port(name, fn=wrapper, device=cuda)
    assert wrapper.launches == before + 1
    r = _port(name, device=cuda)
    torch.cuda.synchronize()
    assert len(k) == 5 and torch.equal(k[1], r[1])
    ok = r[1] == 1
    dy = float((k[0][ok] - r[0][ok]).abs().max())
    dq = _finished_err(k[4], r[4], ok)
    print(f"{name}: max |dy| {dy:.3e}, max |dy_eval| {dq:.3e}")
    assert dy <= CARD_GATES[name][0] and dq <= CARD_GATES[name][1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_snapshot_build_bit_for_bit_at_every_shape_on_card(cuda, name):
    """At every shape the kind's rule can take (B6's and B7's three shapes
    differ at n = 128: 128 and 64 threads and the warp), the snapshot
    build's four outputs are the build without it bit for bit, and its
    y_eval lies within the card gate of the plain version's.  Comparison
    launches are not counted."""
    kind = CASES[name][0]
    r = _port(name, device=cuda)
    ok = r[1] == 1
    wrapper = WRAPPER[kind]
    before = wrapper.launches
    shapes = _card_shapes(kind, spec(name)[4])
    assert len(set(shapes)) == len(shapes), shapes
    for shape in shapes:
        on = _card_launch(name, shape, cuda)
        off = _card_launch(name, shape, cuda, snap=False)
        assert len(on) == 5 and len(off) == 4
        for a, b in zip(on, off):
            assert torch.equal(a, b), shape
        dq = _finished_err(on[4], r[4], ok)
        print(f"{name} at {shape}: max |dy_eval| {dq:.3e}")
        assert dq <= CARD_GATES[name][1]
    assert wrapper.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["b5_kepler", "b5_kepler_comp", "b2_rob",
                                  "b2_rob_comp", "b2_params", "b7_rd",
                                  "b7_rd_comp"])
def test_snapshot_build_bit_for_bit_from_watts_start_on_card(cuda, name):
    """From Watts' starting step (no ``first_step``; the snapshot builds of
    B5 and B2 run it out of line) the snapshot build's four outputs are
    the build without it bit for bit at every shape."""
    kind = CASES[name][0]
    for shape in _card_shapes(kind, spec(name)[4]):
        on = _card_launch(name, shape, cuda, first_step=None)
        off = _card_launch(name, shape, cuda, snap=False, first_step=None)
        assert bool((off[1] == 1).all())
        for a, b in zip(on, off):
            assert torch.equal(a, b), shape


@pytest.mark.gpu
def test_hidden_m_rows_in_user_coordinates_on_card(cuda):
    """B2's rows behind the hidden M are in the user's coordinates z: the
    kernel's rows mapped to the Kaps problem's y = B^-1 z lie within 3e-4
    of its exact solution (y0 = a^2 e^-2t, y1 = a e^-t; the endpoint's
    gate of chip_smoke.py), as the plain version's do, and rows at or
    before t0 within 1e-6 of z0."""
    k = _port("b2_kaps", fn=solve_fused_esdirk, device=cuda)
    r = _port("b2_kaps", device=cuda)
    _, _, _, span, z0, kw = spec("b2_kaps")
    tq = kw["t_eval"].astype(np.float64)
    inside = (tq >= span[0]) & (tq <= span[1])
    a = np.linspace(0.8, 1.2, 128)[:N_ESDIRK]
    exact = np.stack([np.exp(-2 * tq)[:, None] * (a * a)[None, :],
                      np.exp(-tq)[:, None] * a[None, :]], -1)
    for out in (k, r):
        y = out[4].double().cpu().numpy() @ T.HID_BINV.T
        d = np.abs(y - exact)[inside].max()
        print(f"kaps rows against the exact solution: {d:.3e}")
        assert d < 3e-4
        for q in np.flatnonzero(tq <= span[0]):
            assert float((out[4][q].cpu() - torch.tensor(z0)).abs().max()) \
                <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("name", FIRST)
def test_first_attempt_rows_on_card(cuda, name):
    """One attempt of every member with points inside its first step,
    before t0 and past it: the kernel's outputs and rows against the plain
    version's, the counts equal, y and y_eval within CARD_FIRST_GATE."""
    k = _port(name, fn=WRAPPER[CASES[name][0]], device=cuda)
    r = _port(name, device=cuda)
    for a, b in zip(k[1:4], r[1:4]):
        assert torch.equal(a, b)
    d = max(float((k[0] - r[0]).abs().max()),
            float((k[4] - r[4]).abs().max()))
    print(f"{name}: max |dy| and |dy_eval| {d:.3e}")
    assert d <= CARD_FIRST_GATE
