"""The port's mid-size fused ESDIRK path (B7) against the JAX package's
Pallas kernel and the port's f64 driver.

``fused_esdirk_grid_reference`` (the CUDA kernel's plain PyTorch version:
B2's loop with the striped-JVP bands and cyclic reduction) runs on the CPU;
the JAX side is ``solve_fused_esdirk_grid(..., interpret=True)`` on the
same seeded members without FMA (``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``,
see ``test_torch_fused_erk.py``), its outputs written to
``tests/jax_fused_esdirk_grid.npz`` by ``tests/jax_fused_esdirk_grid.py``.
The periodic cases take n = 128, which the JAX kernel runs unpadded; the
strictly tridiagonal ones take n = 32, which it pads to 128 inert lanes
and the port takes as it is (the reduction's wrapped couplings are zero
there, so both solve the same system).  The first attempts agree bit for
bit; from there the port's ``pow`` in the controller (the JAX kernel takes
``exp(e log x)``, a Mosaic workaround left out) and the order of the
norms' sums part last bits of h, and the gates below are measured with a
margin.  Config 4d's shapes (32 reaction-diffusion members of n = 128 with
Kv3I) are held against the port's f64 driver, with the gates of the JAX
tests (``tests/test_fused_pallas.py:957-1039``).

Per-member ``params`` (JAX's edge-replicated reaction-diffusion with its
rate k and diffusivity D a member, n = 64) are held to the JAX kernel's
outputs in ``tests/jax_fused_sens_grid.npz`` (``tests/jax_fused_sens_grid.py``),
and the simultaneous corrector's parts (``block_base``: the base block's
bands, the block-cyclic reduction, JAX's guard rails) to their
definitions; ``tests/test_torch_fused_sens.py`` holds the whole
``block_base`` solve to the JAX fixture.

The tests marked ``gpu`` hold the CUDA kernel against its plain version on
the card; they skip where there is none.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import Kv3I, TRBDF2, solve_ensemble
from extensisq_tpu_torch.ops import (FusedGridRHS, fused_esdirk_grid_reference,
                                     solve_fused_esdirk_grid)
from extensisq_tpu_torch.ops.fused_esdirk_grid import (jac_bands, pcr_factor,
                                                       pcr_solve)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = np.load(REPO / "tests" / "jax_fused_sens_grid.npz")
B = 8
N = 128             # config 4d's width (validation/benchmarks.py:463-502)
N_SMALL = 32        # strictly tridiagonal cases
B_4D = 32
METHODS = {"Kv3I": Kv3I, "TRBDF2": TRBDF2}


def rdiff(n):
    """Config 4d's periodic reaction-diffusion, D = 1, dx = 1/n."""
    c = float(n * n)

    def fun(t, y):
        return ((torch.roll(y, 1, 0) + torch.roll(y, -1, 0) - 2.0 * y) * c
                + y * y * (1.0 - y))
    return fun


def rdiff_cuda(n):
    return f"""template <class T>
__device__ T rhs(T t, const T* y, int i, const float* p) {{
  using G = tab::G;
  return (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) - 2.0f * y[i])
         * {float(n * n)!r}f + y[i] * y[i] * (1.0f - y[i]);
}}"""


def dae(t, y):
    """Even rows y' = -y, odd rows 0 = y[i-1] - y[i]
    (``tests/test_fused_pallas.py:991-1015``)."""
    even = (torch.arange(y.shape[0], device=y.device)[:, None] % 2
            == 0).to(y.dtype)
    return even * (-y) + (1.0 - even) * (torch.roll(y, 1, 0) - y)


DAE_CUDA = """template <class T>
__device__ T rhs(T t, const T* y, int i, const float* p) {
  return i % 2 == 0 ? -y[i] : tab::G::rolled<0>(y, i, 1) - y[i];
}"""


def skew(t, y):
    """Central advection with zero boundaries: a strictly tridiagonal
    Jacobian with an imaginary spectrum, bounded both ways in t."""
    z = torch.zeros_like(y[:1])
    return -(torch.cat([y[1:], z]) - torch.cat([z, y[:-1]])) * (0.5 * N_SMALL)


SKEW_CUDA = f"""template <class T>
__device__ T rhs(T t, const T* y, int i, const float* p) {{
  const T right = i < {N_SMALL - 1} ? y[i + 1] : T(0.0f);
  const T left = i > 0 ? y[i - 1] : T(0.0f);
  return -(right - left) * {0.5 * N_SMALL!r}f;
}}"""


def stiff_cubic(t, y):
    """Dirichlet diffusion with a cubic source that blows up a large
    member."""
    z = torch.zeros_like(y[:1])
    return ((torch.cat([y[1:], z]) + torch.cat([z, y[:-1]]) - 2.0 * y)
            * float(N_SMALL ** 2) + y * y * y)


CUBIC_CUDA = f"""template <class T>
__device__ T rhs(T t, const T* y, int i, const float* p) {{
  const T right = i < {N_SMALL - 1} ? y[i + 1] : T(0.0f);
  const T left = i > 0 ? y[i - 1] : T(0.0f);
  return (right + left - 2.0f * y[i]) * {float(N_SMALL ** 2)!r}f
         + y[i] * y[i] * y[i];
}}"""

N_P = 64            # the params and sensitivity cases


def rd_p(t, y, p):
    """JAX's edge-replicated reaction-diffusion (``tests/test_fused_sens.py``
    ``rd_g``), rows-first, with k = p[0] and D = p[1] a member."""
    left = torch.cat([y[:1], y[:-1]])
    right = torch.cat([y[1:], y[-1:]])
    return (left - 2.0 * y + right) * p[1] - p[0] * (y - 1.0)


# its CUDA source in the sensitivities' template form (ops/fused_sens.py),
# which B7 with params runs as rhs<float, const float*> and, for the
# bands, rhs<Dual, const Dual*>
RD_P = FusedGridRHS(rd_p, f"""template <class T, class V>
__device__ T rhs(T t, V y, int i, const T* p) {{
  const T left = y[i > 0 ? i - 1 : 0];
  const T right = y[i < {N_P - 1} ? i + 1 : {N_P - 1}];
  return (left - 2.0f * y[i] + right) * p[1] - p[0] * (y[i] - 1.0f);
}}""", (N_P,), 2)


def rd_p_inputs():
    """8 members from y0 = 1 + 0.5 sin(pi x), k in [5, 30], D = 200."""
    x = np.linspace(0, 1, N_P)
    y0 = np.tile((1.0 + 0.5 * np.sin(np.pi * x)).astype(np.float32), (B, 1))
    return y0, np.stack([np.linspace(5.0, 30.0, B).astype(np.float32),
                         np.full(B, 200.0, np.float32)], axis=1)


RHS = {
    "rdiff": FusedGridRHS(rdiff(N), rdiff_cuda(N), (N,)),
    "dae": FusedGridRHS(dae, DAE_CUDA, (N,)),
    "skew": FusedGridRHS(skew, SKEW_CUDA, (N_SMALL,)),
    "cubic": FusedGridRHS(stiff_cubic, CUBIC_CUDA, (N_SMALL,)),
}
M_DAE = (np.arange(N) % 2 == 0).astype(np.float64)


def rdiff_y0(members, n):
    """Config 4d's members: 0.5 + 0.4 amps sin(2 pi x)."""
    x = np.linspace(0, 1, n, endpoint=False)
    amps = np.linspace(0.3, 0.7, members)
    return (0.5 + 0.4 * amps[:, None]
            * np.sin(2 * np.pi * x)[None, :]).astype(np.float32)


def _inputs():
    xs = np.linspace(0, 1, N_SMALL)
    bump = np.exp(-40 * (xs - 0.5) ** 2)[None, :] * np.linspace(0.5, 1.0, B)[
        :, None]
    bad = bump.copy()
    bad[3] *= 1e19                    # this member blows up in f32
    dae0 = np.ones((B, N)) * np.linspace(0.5, 2.0, B)[:, None]
    return {k: np.asarray(v, np.float32) for k, v in dict(
        rdiff=rdiff_y0(B, N), bump=bump, bad=bad, dae=dae0,
        dae_yp=-dae0).items()}


Y0 = _inputs()
TOL = dict(rtol=1e-4, atol=1e-6)
# name -> (problem, method, span, y0, options); a DAE names its mass
# diagonal and consistent yp0 as "M" and "yp0"
CASES = {
    "rd_kv3i": ("rdiff", "Kv3I", (0.0, 0.1), "rdiff", TOL),
    "rd_trbdf2": ("rdiff", "TRBDF2", (0.0, 0.1), "rdiff", TOL),
    "rd_h0": ("rdiff", "Kv3I", (0.0, 0.1), "rdiff",
              dict(TOL, first_step=1e-3, max_step=0.01)),
    "rd_comp": ("rdiff", "Kv3I", (0.0, 0.02), "rdiff",
                dict(rtol=1e-6, atol=1e-9, compensated=True)),
    "dae": ("dae", "Kv3I", (0.0, 1.0), "dae",
            dict(rtol=1e-5, atol=1e-7, M="M", yp0="dae_yp")),
    "skew_back": ("skew", "TRBDF2", (0.2, 0.0), "bump",
                  dict(rtol=1e-5, atol=1e-7)),
}
# the first attempts of a case, bit for bit: name -> (case, max_steps)
FIRST = {"rd_h0_2": ("rd_h0", 2)}

def _spec():
    spec = {k: list(v) for k, v in CASES.items()}
    for name, (case, attempts) in FIRST.items():
        prob, meth, span, y0, kw = CASES[case]
        spec[name] = [prob, meth, span, y0, dict(kw, max_steps=attempts)]
    return spec


@pytest.fixture(scope="module")
def jax_results():
    """The JAX kernel's outputs for every case, from
    ``tests/jax_fused_esdirk_grid.npz``, which
    ``tests/jax_fused_esdirk_grid.py`` writes from the JAX package
    (interpret mode takes ~1.5 min for these cases), its inputs held
    equal to these."""
    rec = np.load(REPO / "tests" / "jax_fused_esdirk_grid.npz")
    for k, v in Y0.items():
        np.testing.assert_array_equal(rec["y0/" + k], v)
    np.testing.assert_array_equal(rec["M_DAE"], M_DAE)
    return {k: tuple(rec[f"{k}/{i}"] for i in range(4)) for k in _spec()}


def _options(kw):
    """A case's options with the DAE's mass diagonal and yp0 filled in."""
    kw = dict(kw)
    if "M" in kw:
        kw["M"] = M_DAE
        kw["yp0_batch"] = torch.tensor(Y0[kw.pop("yp0")])
    return kw


def _port(name, **over):
    prob, meth, span, y0, kw = CASES[name]
    res = fused_esdirk_grid_reference(RHS[prob], span, torch.tensor(Y0[y0]),
                                      method=METHODS[meth],
                                      **dict(_options(kw), **over))
    return tuple(r.numpy() for r in res)


# (case, max |dy|, max |dnsteps|, max |dnfev|, members with other counts),
# measured on the CPU: rd_kv3i 1.2e-5, 1, 3, 3; rd_trbdf2 5.1e-6, 0, 0, 0;
# rd_h0 (first_step and max_step) 1.2e-5, 0, 1, 1; rd_comp 2.4e-6, 1, 19
# (Newton iterations), 7; dae 1.2e-7, 0, 0, 0; skew_back (a backward span,
# n = 32 strictly tridiagonal) 4.8e-7, 0, 0, 0.  Gates about 2x.
GATES = [("rd_kv3i", 3e-5, 2, 6, 6), ("rd_trbdf2", 1e-5, 1, 2, 2),
         ("rd_h0", 3e-5, 1, 2, 2), ("rd_comp", 5e-6, 2, 38, 8),
         ("dae", 3e-7, 1, 2, 2), ("skew_back", 1e-6, 1, 2, 2)]


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
    """With ``first_step`` given, the first attempts (the striped-JVP
    bands, the cyclic reduction, Newton, the error and the controller)
    repeat the JAX kernel's arithmetic bit for bit."""
    case, attempts = FIRST[name]
    out = _port(case, max_steps=attempts)
    for a, b in zip(out, jax_results[name]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,periodic", [(16, True), (128, True), (20, False),
                                        (37, False)])
def test_cyclic_reduction_solves_the_tridiagonal_system(n, periodic):
    """``pcr_factor``/``pcr_solve`` against a dense solve
    (``tests/test_fused_pallas.py``'s ``_pcr_solve`` check): periodic
    corners at powers of two, strictly tridiagonal systems at any n."""
    rng = np.random.RandomState(n)
    lo, up = rng.randn(2, n, 3)
    di = 4.0 + rng.rand(n, 3)
    if not periodic:
        lo[0] = 0.0
        up[-1] = 0.0
    r = rng.randn(n, 3)
    f = [torch.tensor(a, dtype=torch.float32) for a in (lo, di, up, r)]
    x = pcr_solve(pcr_factor(*f[:3]), f[3]).numpy()
    for m in range(3):
        W = np.zeros((n, n))
        for i in range(n):
            W[i, (i - 1) % n] += lo[i, m]
            W[i, i] += di[i, m]
            W[i, (i + 1) % n] += up[i, m]
        xe = np.linalg.solve(W, r[:, m])
        assert np.max(np.abs(x[:, m] - xe)) / max(1.0, np.abs(xe).max()) < 5e-5


def test_bands_are_the_jacobian():
    """The striped JVPs give the three bands of the dense Jacobian of the
    periodic reaction-diffusion, corners included."""
    y = torch.tensor(Y0["rdiff"][:2].T.copy(), dtype=torch.float64)
    t = torch.zeros(2, dtype=torch.float64)
    lo, di, up = jac_bands(rdiff(N), t, y)
    for m in range(2):
        J = torch.autograd.functional.jacobian(
            lambda v: rdiff(N)(t[m], v[:, None])[:, 0], y[:, m])
        idx = torch.arange(N)
        assert torch.allclose(lo[:, m], J[idx, (idx - 1) % N])
        assert torch.allclose(di[:, m], J[idx, idx])
        assert torch.allclose(up[:, m], J[idx, (idx + 1) % N])


def config_4d(span):
    """Config 4d's members and right-hand side on ``span``."""
    return RHS["rdiff"], span, torch.tensor(rdiff_y0(B_4D, N))


@pytest.mark.parametrize("meth", ["Kv3I", "TRBDF2"])
def test_config_4d_tracks_the_f64_driver(meth):
    """Config 4d's members on the JAX test's span, t in [0, 0.1]: every
    member finishes, within 1e-3 of the port's f64 driver with the same
    method and with mean nsteps within 20% + 2
    (``tests/test_fused_pallas.py:957-988``).  On the whole span, t in
    [0, 1], the float32 steps inflate ~3x at the steady-state tail
    (validation/benchmarks.py:463-469), so chip_smoke.py holds the
    endpoint there and the steps here."""
    fun, span, y0 = config_4d((0.0, 0.1))
    y, status, nsteps, _ = fused_esdirk_grid_reference(
        fun, span, y0, method=METHODS[meth], **TOL)
    ref = solve_ensemble(fun.torch_fn, span, y0.double(),
                         method=METHODS[meth], **TOL)
    assert bool((status == 1).all()) and bool((ref.status == 1).all())
    assert (y.double() - ref.y).abs().max().item() < 1e-3
    mean, mean64 = nsteps.double().mean(), ref.nsteps.double().mean()
    assert abs(mean - mean64) < 0.2 * mean64 + 2.0


def test_dae_lanes_match_the_exact_solution():
    """Lane-interleaved algebraic rows (zeros of a diagonal M): every lane
    follows y0 exp(-t) within 1e-4 at t = 1
    (``tests/test_fused_pallas.py:991-1015``)."""
    y, status, _, _ = _port("dae")
    assert np.all(status == 1)
    assert np.max(np.abs(y - Y0["dae"] * np.exp(-1.0))) < 1e-4


def test_compensated_tracks_the_f64_driver():
    """``compensated=True`` at rtol 1e-6 / atol 1e-9 lands within 3e-5 of
    the f64 driver (``tests/test_fused_pallas.py:1018-1039``), here on
    t in [0, 0.02]."""
    y, status, _, _ = _port("rd_comp")
    _, meth, span, y0, kw = CASES["rd_comp"]
    ref = solve_ensemble(RHS["rdiff"].torch_fn, span,
                         torch.tensor(Y0[y0], dtype=torch.float64),
                         method=Kv3I, rtol=1e-6, atol=1e-9)
    assert np.all(status == 1)
    assert np.max(np.abs(y - ref.y.numpy())) < 3e-5


def test_overflow_member_isolated():
    """A member whose state overflows fails alone; its neighbours finish
    with the steps they take without it."""
    span, kw = (0.0, 0.05), dict(TOL, first_step=1e-3, max_steps=2000)
    y, status, nsteps, _ = fused_esdirk_grid_reference(
        RHS["cubic"], span, torch.tensor(Y0["bad"]), **kw)
    ref = fused_esdirk_grid_reference(
        RHS["cubic"], span, torch.tensor(Y0["bump"]), **kw)
    assert int(status[3]) != 1 and int((status == 1).sum()) == B - 1
    ok = np.arange(B) != 3
    assert torch.equal(nsteps[ok], ref[2][ok])
    assert torch.equal(y[ok], ref[0][ok])


def test_nondiagonal_mass_raises():
    M = np.eye(N) + np.eye(N, k=1)
    with pytest.raises(ValueError, match="diagonal"):
        fused_esdirk_grid_reference(RHS["rdiff"], (0.0, 0.1),
                                    torch.tensor(Y0["rdiff"]), M=M)


def test_dae_needs_yp0():
    with pytest.raises(ValueError, match="yp0_batch"):
        fused_esdirk_grid_reference(RHS["dae"], (0.0, 0.1),
                                    torch.tensor(Y0["dae"]), M=M_DAE)


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper runs the plain version, with a
    FusedGridRHS or a bare torch function, and launches no kernel."""
    prob, meth, span, y0, kw = CASES["rd_h0"]
    y0 = torch.tensor(Y0[y0])
    kw = dict(kw, method=METHODS[meth])
    before = solve_fused_esdirk_grid.launches
    ref = fused_esdirk_grid_reference(RHS[prob], span, y0, **kw)
    for f in (RHS[prob], RHS[prob].torch_fn):
        for a, b in zip(solve_fused_esdirk_grid(f, span, y0, **kw), ref):
            assert torch.equal(a, b)
    assert solve_fused_esdirk_grid.launches == before


@pytest.mark.parametrize("option", ["events"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        solve_fused_esdirk_grid(RHS["rdiff"], (0.0, 1.0),
                                torch.tensor(Y0["rdiff"]), **{option: 1})


PARAMS_SPAN = (0.0, 0.04)
PARAMS_KW = dict(method=Kv3I, rtol=1e-5, atol=1e-8)


def test_params_match_jax_kernel():
    """B7's plain version with (k, D) a member against the JAX kernel's
    fixture (n = 64, which the JAX kernel pads to 128 inert lanes): status
    and nsteps identical, nfev apart on at most one member by one Newton
    iteration (measured: 1), max |dy| measured 3.6e-7, gate 1e-6."""
    y0, P = rd_p_inputs()
    np.testing.assert_array_equal(y0, FIXTURE["esdirk_params/y0"])
    np.testing.assert_array_equal(P, FIXTURE["esdirk_params/params"])
    y, st, ns, nf = (x.numpy() for x in fused_esdirk_grid_reference(
        RD_P, PARAMS_SPAN, torch.tensor(y0), params=torch.tensor(P),
        **PARAMS_KW))
    assert np.all(st == 1)
    np.testing.assert_array_equal(st, FIXTURE["esdirk_params/1"])
    np.testing.assert_array_equal(ns, FIXTURE["esdirk_params/2"])
    dfev = np.abs(nf - FIXTURE["esdirk_params/3"])
    assert dfev.max() <= 1 and np.sum(dfev != 0) <= 1
    assert np.max(np.abs(y - FIXTURE["esdirk_params/0"])) <= 1e-6


def test_params_wrapper_on_cpu_and_checks():
    """On CPU tensors the wrapper with ``params`` runs the plain version
    bit for bit and counts no launch; ``params`` must agree with the
    FusedGridRHS's k."""
    y0, P = (torch.tensor(x) for x in rd_p_inputs())
    kw = dict(PARAMS_KW, first_step=1e-3, max_steps=4)
    before = solve_fused_esdirk_grid.launches
    for a, b in zip(solve_fused_esdirk_grid(RD_P, PARAMS_SPAN, y0, params=P,
                                            **kw),
                    fused_esdirk_grid_reference(RD_P, PARAMS_SPAN, y0,
                                                params=P, **kw)):
        assert torch.equal(a, b)
    assert solve_fused_esdirk_grid.launches == before
    with pytest.raises(ValueError, match="k = 2"):
        solve_fused_esdirk_grid(RD_P, PARAMS_SPAN, y0, params=P[:, :1])
    with pytest.raises(ValueError, match=r"pass params of shape \(B, 2\)"):
        solve_fused_esdirk_grid(RD_P, PARAMS_SPAN, y0)


@pytest.mark.parametrize("kw,match", [
    (dict(M=np.ones(64), block_base=32), "M=None"),
    (dict(block_base=48), "divide")])
def test_block_base_guard_rails(kw, match):
    """JAX's guard rails of the simultaneous corrector
    (``tests/test_fused_sens.py``): a mass matrix with ``block_base``, and
    a ``block_base`` that does not divide n, raise ValueError naming them,
    before anything runs."""
    with pytest.raises(ValueError, match=match):
        solve_fused_esdirk_grid(lambda t, y: -y, (0.0, 1.0),
                                np.ones((8, 64), np.float32), **kw)


def test_block_cyclic_reduction_solves_each_block():
    """``pcr_solve`` with a factor of nb rows on kb nb rows solves
    block-diag(W, ..., W), each block bit for bit as the factor's own
    solve, and each within the dense solve's tolerance."""
    rng = np.random.RandomState(3)
    nb, kb = 20, 3
    lo, up = rng.randn(2, nb, 2)
    lo[0] = 0.0
    up[-1] = 0.0
    di = 4.0 + rng.rand(nb, 2)
    fact = pcr_factor(*(torch.tensor(a, dtype=torch.float32)
                        for a in (lo, di, up)))
    d = torch.tensor(rng.randn(kb * nb, 2), dtype=torch.float32)
    x = pcr_solve(fact, d)
    assert x.shape == d.shape
    for b in range(kb):
        rows = slice(b * nb, (b + 1) * nb)
        assert torch.equal(x[rows], pcr_solve(fact, d[rows]))
        W = np.diag(di[:, 0]) + np.diag(lo[1:, 0], -1) + np.diag(up[:-1, 0], 1)
        xe = np.linalg.solve(W, d[rows, 0].numpy())
        assert np.max(np.abs(x[rows, 0].numpy() - xe)) < 5e-5


def test_base_block_bands_are_the_users():
    """With a base block the striped tangents lie on its columns: the bands
    of the variational system's first block equal the bands of the user's
    right-hand side bit for bit, nb rows each."""
    from extensisq_tpu_torch.ops.fused_erk_grid import bind_grid_params
    from extensisq_tpu_torch.ops.fused_sens import _aug_grid_rhs
    y0, P = (torch.tensor(x) for x in rd_p_inputs())
    aug = _aug_grid_rhs(RD_P, N_P, 2)
    Y = torch.cat([y0, torch.randn(B, 2 * N_P)], 1).T.contiguous()
    t = torch.zeros(B)
    got = jac_bands(bind_grid_params(aug, P), t, Y, N_P)
    want = jac_bands(bind_grid_params(RD_P, P), t, Y[:N_P].contiguous())
    for a, b in zip(got, want):
        assert a.shape == (N_P, B) and torch.equal(a, b)


@pytest.mark.parametrize("members,n,shape", [
    (8, N, (128, 0)), (32, N, (128, 0)), (256, N, (128, 0)),
    (528, N, (128, 0)), (529, N, (32, 4)), (1024, N, (32, 4)),
    (8, N_SMALL, (32, 0)), (4096, N_SMALL, (32, 4)), (8, 300, (256, 0)),
    (1024, 256, (128, 0)), (1024, 300, (160, 0)), (1024, 512, (256, 0))])
def test_launch_shape_on_132_sms(members, n, shape):
    """The rule's launch shape on the H100's 132 SMs: one block of
    ``grid_threads(n)`` threads per member up to 4 members an SM, one warp
    per member (four a block) beyond where n is at most 128, else blocks
    of two elements a thread."""
    from extensisq_tpu_torch.ops.fused_esdirk_grid import _launch_shape
    assert _launch_shape(members, n, 132) == shape


def test_generated_header_carries_the_grid_and_rounds():
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_esdirk import _esdirk_consts
    text = _build.fused_esdirk_grid_header(_esdirk_consts(Kv3I), (N,),
                                           RHS["rdiff"].cuda_src)
    assert f"using G = grid::Grid<{N}>;" in text
    assert "constexpr int L = 7;" in text and "constexpr int S = 4;" in text
    assert RHS["rdiff"].cuda_src in text
    assert "constexpr int L = 6;" in _build.fused_esdirk_grid_header(
        _esdirk_consts(Kv3I), (37,), SKEW_CUDA)
    assert "constexpr int NB = 128;" in text
    assert "constexpr int NPAR = 0;" in text
    block = _build.fused_esdirk_grid_header(_esdirk_consts(Kv3I), (192,),
                                            RD_P.cuda_src, 2, 64)
    assert "constexpr int NB = 64;" in block
    assert "constexpr int L = 6;" in block
    assert "constexpr int NPAR = 2;" in block
    assert [p.name for p in _build.shared_headers("fused_esdirk_grid")] == [
        "dense_record.cuh", "dual.cuh", "grid_common.cuh",
        "esdirk_control.cuh", "block_hstart.cuh", "block_rows.cuh",
        "rk_common.cuh", "snapshot.cuh", "block_group.cuh"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# kernel against its plain version on the same card: status identical,
# |dy| over finished members within the gates chip_smoke.py measured
CARD_GATES = {"rd_kv3i": 1e-4, "rd_trbdf2": 1e-4, "rd_h0": 1e-4,
              "rd_comp": 1e-5, "dae": 1e-4, "skew_back": 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_kernel_matches_plain_version_on_card(cuda, name):
    prob, meth, span, y0, kw = CASES[name]
    kw = dict(_options(kw), method=METHODS[meth])
    if "yp0_batch" in kw:
        kw["yp0_batch"] = kw["yp0_batch"].to(cuda)
    y0 = torch.tensor(Y0[y0], device=cuda)
    before = solve_fused_esdirk_grid.launches
    k = solve_fused_esdirk_grid(RHS[prob], span, y0, **kw)
    assert solve_fused_esdirk_grid.launches == before + 1
    r = fused_esdirk_grid_reference(RHS[prob], span, y0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]


@pytest.mark.gpu
def test_overflow_member_isolated_on_card(cuda):
    span, kw = (0.0, 0.05), dict(TOL, first_step=1e-3, max_steps=2000)
    y0 = torch.tensor(Y0["bad"], device=cuda)
    k = solve_fused_esdirk_grid(RHS["cubic"], span, y0, **kw)
    r = fused_esdirk_grid_reference(RHS["cubic"], span, y0, **kw)
    assert torch.equal(k[1], r[1]) and int(k[1][3]) != 1
    assert int((k[1] == 1).sum()) == B - 1


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda):
    before = solve_fused_esdirk_grid.launches
    y, status, nsteps, nfev = solve_fused_esdirk_grid(
        RHS["rdiff"], (0.0, 1.0), torch.zeros((0, N), device=cuda))
    assert y.shape == (0, N) and status.shape == (0,)
    assert solve_fused_esdirk_grid.launches == before


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_grid_rhs(cuda):
    with pytest.raises(TypeError, match="FusedGridRHS"):
        solve_fused_esdirk_grid(rdiff(N), (0.0, 1.0),
                                torch.tensor(Y0["rdiff"], device=cuda))


def _card_case(name, cuda):
    prob, meth, span, y0, kw = CASES[name]
    kw = dict(_options(kw), method=METHODS[meth])
    if "yp0_batch" in kw:
        kw["yp0_batch"] = kw["yp0_batch"].to(cuda)
    return RHS[prob], span, torch.tensor(Y0[y0], device=cuda), kw


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_warp_body_bit_identical_to_block_of_32_on_card(cuda, name):
    """The rule's warp shape, one warp per member and four members a block,
    equals one block of 32 threads per member bit for bit, on all members
    and on the first 7 (a ragged last block, whose absent warp nobody
    waits for), and is held against the plain version at the card gates
    (the block shape the rule takes for these ensembles is held so by
    test_kernel_matches_plain_version_on_card).  Comparison launches are
    not counted."""
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    fun, span, y0, kw = _card_case(name, cuda)
    built = FEG._kernel(kw["method"], fun)
    before = solve_fused_esdirk_grid.launches
    for ys, yp in ((y0, kw.get("yp0_batch")),
                   (y0[:7], None if "yp0_batch" not in kw
                    else kw["yp0_batch"][:7])):
        kk = dict(kw, yp0_batch=yp)
        block, shape_b = FEG._launch(built, span, ys, shape=(32, 0), **kk)
        warp, shape_w = FEG._launch(built, span, ys,
                                    shape=(32, FEG.WARP_MEMBERS), **kk)
        torch.cuda.synchronize()
        assert shape_b == (32, 0) and shape_w == (32, FEG.WARP_MEMBERS)
        for a, b in zip(warp, block):
            assert torch.equal(a, b)
        r = fused_esdirk_grid_reference(fun, span, ys, **kk)
        assert torch.equal(warp[1], r[1])
        ok = r[1] == 1
        assert ((warp[0][ok] - r[0][ok]).abs().max().item()
                <= CARD_GATES[name])
    assert solve_fused_esdirk_grid.launches == before


@pytest.mark.gpu
def test_params_and_block_base_kernels_match_plain_versions_on_card(cuda):
    """B7 with params, and in block_base mode on the reaction-diffusion's
    variational system, against their plain versions on the card (status
    equal, |dy| within the rd gates), each also on the warp body bit for
    bit the block of 32."""
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops.fused_sens import _aug_grid_rhs
    y0, P = (torch.tensor(x, device=cuda) for x in rd_p_inputs())
    aug = _aug_grid_rhs(RD_P, N_P, 2)
    Y = torch.cat([y0, torch.zeros(B, 2 * N_P, device=cuda)], 1)
    for fun, ys, kw in (
            (RD_P, y0, dict(PARAMS_KW, params=P)),
            (aug, Y, dict(PARAMS_KW, method=TRBDF2, params=P,
                          block_base=N_P))):
        before = solve_fused_esdirk_grid.launches
        k = solve_fused_esdirk_grid(fun, PARAMS_SPAN, ys, **kw)
        assert solve_fused_esdirk_grid.launches == before + 1
        r = fused_esdirk_grid_reference(fun, PARAMS_SPAN, ys, **kw)
        assert torch.equal(k[1], r[1]) and bool((r[1] == 1).all())
        assert (k[0] - r[0]).abs().max().item() <= CARD_GATES["rd_trbdf2"]
        nb = kw.pop("block_base", None)
        built = FEG._kernel(kw["method"], fun, nb)
        block, _ = FEG._launch(built, PARAMS_SPAN, ys, shape=(32, 0), **kw)
        warp, _ = FEG._launch(built, PARAMS_SPAN, ys,
                              shape=(32, FEG.WARP_MEMBERS), **kw)
        for a, c in zip(warp, block):
            assert torch.equal(a, c)


@pytest.mark.gpu
def test_wrapper_takes_the_rules_launch_shape_on_card(cuda):
    """The wrapper launches the rule's shape for the card's SM count, a
    block at 8 members and the warp body past 4 members an SM, where its
    outputs equal one block of 32 threads per member bit for bit."""
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for members in (8, FEG.WARP_FROM * sms + 1):
        y0 = torch.tensor(rdiff_y0(members, N), device=cuda)
        span = (0.0, 0.01)
        out = solve_fused_esdirk_grid(RHS["rdiff"], span, y0, **TOL)
        shape = FEG._launch_shape(members, N, sms)
        assert solve_fused_esdirk_grid.last_shape == shape
        assert bool((out[1] == 1).all())
        if shape[0] == 32:
            ref, _ = FEG._launch(FEG._kernel(None, RHS["rdiff"]), span, y0,
                                 shape=(32, 0), **TOL)
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
