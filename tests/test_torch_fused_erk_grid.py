"""The port's mid-size fused ERK path (B4) against the JAX package's Pallas
kernel.

``fused_erk_grid_reference`` (the CUDA kernel's plain PyTorch version, B1's
loop on the rows-first state) runs on the CPU; the JAX side runs
``solve_fused_erk_grid(..., interpret=True)`` on the same seeded members,
in a subprocess without FMA (``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, see
``test_torch_fused_erk.py``).  The members have n = 100 states, which the
JAX kernel pads to 128 lanes (its masked norms keep the unpadded step
sequence) and the port takes as they are.  As for B5/B6, the first
attempts agree bit for bit and the controller's float32 ``pow`` (and the
starting step's ``log10``/``pow``) part later last bits: with
``first_step`` given, BS5's counts stay identical; CK5, which rejects
attempts close to the threshold, takes one attempt more or less on one
member; elsewhere the gates below are measured with a margin.

Per-member ``params`` (a Fisher MoL with its growth rate a member, n =
64) are held to the JAX kernel's outputs in ``tests/jax_fused_sens_grid.npz``
(written by ``tests/jax_fused_sens_grid.py``, interpret mode without FMA),
with ``first_step`` given: identical counts.

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

from extensisq_tpu_torch import BS5, CK5
from extensisq_tpu_torch.ops import (FusedGridRHS, fused_erk_grid_reference,
                                     solve_fused_erk_grid)

REPO = Path(__file__).resolve().parents[1]
B = 8
N = 100
METHODS = {"BS5": BS5, "CK5": CK5}
# the params cases' members (tests/jax_fused_sens_grid.py)
FIXTURE = np.load(REPO / "tests" / "jax_fused_sens_grid.npz")
N_P = 64


def fisher(t, y):
    """Upwind advection-reaction (BASELINE config 1b's MoL, c = 1)."""
    return -(y - torch.roll(y, 1, 0)) * float(N) + y * (1.0 - y)


def skew(t, y):
    """Central advection: imaginary spectrum, bounded both ways in t."""
    return -(torch.roll(y, -1, 0) - torch.roll(y, 1, 0)) * (0.5 * N)


RHS = {
    "fisher": FusedGridRHS(fisher, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {float(N)!r}f
         + y[i] * (1.0f - y[i]);
}}""", (N,)),
    "skew": FusedGridRHS(skew, f"""__device__ float rhs(float t,
    const float* y, int i, const float* p) {{
  using G = tab::G;
  return -(G::rolled<0>(y, i, -1) - G::rolled<0>(y, i, 1)) * {0.5 * N!r}f;
}}""", (N,)),
}


def fisher_p(t, y, p):
    """The periodic upwind Fisher MoL at n = 64 with its growth rate p[0]
    a member (JAX's ``test_fused_sens_grid_layout_fisher_fd``)."""
    return -(y - torch.roll(y, 1, 0)) * float(N_P) + p[0] * y * (1.0 - y)


# its CUDA source in the sensitivities' template form (ops/fused_sens.py),
# which B4 with params runs as rhs<float, const float*>
FISHER_P = FusedGridRHS(fisher_p, f"""template <class T, class V>
__device__ T rhs(T t, V y, int i, const T* p) {{
  return -(y[i] - tab::G::rolled<0>(y, i, 1)) * {float(N_P)!r}f
         + p[0] * y[i] * (1.0f - y[i]);
}}""", (N_P,), 1)


def fisher_p_inputs():
    """8 members from y0 = 0.5 + 0.3 sin(2 pi x), r in [0.8, 1.2]."""
    x = np.linspace(0, 1, N_P, endpoint=False)
    y0 = np.tile((0.5 + 0.3 * np.sin(2 * np.pi * x)).astype(np.float32),
                 (B, 1))
    return y0, np.linspace(0.8, 1.2, B).astype(np.float32)[:, None]


def _inputs():
    x = np.linspace(0, 1, N, endpoint=False)
    amps = np.linspace(0.2, 0.8, B)
    fis = (0.5 + 0.4 * amps[:, None] * np.sin(2 * np.pi * x)[None, :])
    fis = fis.astype(np.float32)
    bad = fis.copy()
    bad[3] *= 1e19                    # this member blows up in f32
    return fis, bad


FIS0, BAD0 = _inputs()
# name -> (problem, method, span, y0, options)
CASES = {
    "fisher_plain": ("fisher", "BS5", (0.0, 2.0), FIS0,
                     dict(rtol=1e-5, atol=1e-7)),
    "fisher_comp": ("fisher", "BS5", (0.0, 1.0), FIS0,
                    dict(rtol=1e-6, atol=1e-9, compensated=True)),
    "fisher_h0": ("fisher", "BS5", (0.0, 0.5), FIS0,
                  dict(rtol=1e-5, atol=1e-7, first_step=0.01)),
    "fisher_ck5_h0": ("fisher", "CK5", (0.0, 0.5), FIS0,
                      dict(rtol=1e-5, atol=1e-7, first_step=0.01)),
    "skew_back": ("skew", "BS5", (0.5, 0.0), FIS0,
                  dict(rtol=1e-5, atol=1e-7)),
    "overflow": ("fisher", "BS5", (0.0, 1.0), BAD0,
                 dict(rtol=1e-4, atol=1e-6, max_steps=2000)),
}

_JAX_SCRIPT = textwrap.dedent(f"""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import extensisq_tpu as X
    from extensisq_tpu.ops import solve_fused_erk_grid
    problems = {{
        "fisher": lambda t, y: (-(y - jnp.roll(y, 1, -1)) * {float(N)!r}
                                + y * (1.0 - y)),
        "skew": lambda t, y: (-(jnp.roll(y, -1, -1) - jnp.roll(y, 1, -1))
                              * {0.5 * N!r}),
    }}
    inputs = np.load(sys.argv[1])
    out = {{}}
    for name, (prob, meth, span, kw) in json.loads(sys.argv[2]).items():
        res = solve_fused_erk_grid(problems[prob], tuple(span), inputs[name],
                                   method=getattr(X, meth), block_members=8,
                                   interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{{name}}/{{i}}"] = np.asarray(r)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX kernel's outputs for every case, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_fused_erk_grid")
    np.savez(d / "in.npz", **{k: v[3] for k, v in CASES.items()})
    spec = {k: [v[0], v[1], v[2], v[4]] for k, v in CASES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps(spec), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=600)
    out = np.load(d / "out.npz")
    return {k: tuple(out[f"{k}/{i}"] for i in range(4)) for k in CASES}


def _port(name, **over):
    prob, meth, span, y0, kw = CASES[name]
    res = fused_erk_grid_reference(RHS[prob], span, torch.tensor(y0),
                                   method=METHODS[meth], **dict(kw, **over))
    return tuple(r.numpy() for r in res)



# (case, max |dy|, max |dnsteps|, max |dnfev|, members with a count
# difference), measured on the CPU: fisher_plain 5.4e-5, 4, 147, 3;
# fisher_comp 9.3e-6, 3, 91, 6; fisher_ck5_h0 2.6e-6, 0, 5, 1 (CK5,
# non-FSAL); skew_back 3.7e-4, 0, 7, 1 (backward).  Gates about 2x.
GATES = [
    ("fisher_plain", 1.2e-4, 8, 300, 6),
    ("fisher_comp", 2e-5, 6, 180, 8),
    ("fisher_ck5_h0", 6e-6, 1, 10, 2),
    ("skew_back", 8e-4, 1, 14, 2),
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


def test_first_step_counts_identical(jax_results):
    """BS5 with ``first_step`` given takes the JAX kernel's steps on every
    member at n = 100 (measured |dy| 7.7e-7, gate 2e-6)."""
    y, status, nsteps, nfev = _port("fisher_h0")
    jy, jstatus, jnsteps, jnfev = jax_results["fisher_h0"]
    assert np.all(status == 1)
    np.testing.assert_array_equal(status, jstatus)
    np.testing.assert_array_equal(nsteps, jnsteps)
    np.testing.assert_array_equal(nfev, jnfev)
    assert np.max(np.abs(y - jy)) <= 2e-6


def test_overflow_member_isolated(jax_results):
    """A diverging member ends with status 3 and does not poison its
    neighbours, whose counts are the JAX kernel's (measured |dy| 3.6e-4 at
    rtol 1e-4 from the starting step's last bits, gate 8e-4)."""
    y, status, nsteps, nfev = _port("overflow")
    jy, jstatus, jnsteps, jnfev = jax_results["overflow"]
    assert status[3] == 3 and np.sum(status == 1) == B - 1
    np.testing.assert_array_equal(status, jstatus)
    ok = status == 1
    np.testing.assert_array_equal(nsteps[ok], jnsteps[ok])
    np.testing.assert_array_equal(nfev[ok], jnfev[ok])
    assert np.all(np.isfinite(y[ok]))
    assert np.max(np.abs(y[ok] - jy[ok])) <= 8e-4


def test_endpoint_tracks_the_f64_driver():
    """BASELINE config 1b's gate (``validation/benchmarks.py:100``) at
    n = 100: the plain version in f32 within 1e-3 of the f64
    ``solve_ensemble`` with BS5 at the same tolerances."""
    from extensisq_tpu_torch import solve_ensemble
    y, status, _, _ = _port("fisher_plain")
    ref = solve_ensemble(fisher, (0.0, 2.0),
                         torch.tensor(FIS0, dtype=torch.float64), method=BS5,
                         rtol=1e-5, atol=1e-7)
    assert np.all(status == 1) and bool((ref.status == 1).all())
    assert np.max(np.abs(y - ref.y.numpy())) < 1e-3


def test_grid_rhs_must_be_one_axis():
    """The mid-size kernel's state is one axis of n; a FusedGridRHS of
    another shape raises before anything runs."""
    two = FusedGridRHS(fisher, RHS["fisher"].cuda_src, (2, N // 2))
    with pytest.raises(ValueError, match="shape"):
        fused_erk_grid_reference(two, (0.0, 0.2), torch.tensor(FIS0))


def test_cpu_wrapper_runs_plain_version():
    prob, meth, span, y0, kw = CASES["fisher_h0"]
    before = solve_fused_erk_grid.launches
    ref = fused_erk_grid_reference(RHS[prob], span, torch.tensor(y0), **kw)
    for fun in (RHS[prob], RHS[prob].torch_fn):
        out = solve_fused_erk_grid(fun, span, torch.tensor(y0), method=BS5,
                                   **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert solve_fused_erk_grid.launches == before


def test_fused_wrappers_take_the_jax_parameters():
    """Every ``solve_fused_*`` of the port has the JAX wrapper's parameter
    names in its order, ``interpret`` (Pallas' interpreter) left out: the
    twelve kernels' wrappers and the three of ``ops/fused_sens.py``."""
    import inspect

    import extensisq_tpu.ops as jops
    import extensisq_tpu_torch.ops as pops
    names = [n for n in dir(pops) if n.startswith("solve_fused_")]
    assert len(names) == 15
    for name in names:
        want = [k for k in inspect.signature(getattr(jops, name)).parameters
                if k != "interpret"]
        assert list(inspect.signature(getattr(pops, name)).parameters) \
            == want, name


def test_grid_wrappers_accept_block_members():
    """B4, B6 and B12 take the JAX keyword ``block_members`` (default 32)
    and ignore it: the same result at 8 as without it."""
    from extensisq_tpu_torch.ops import (FusedGridAcc, solve_fused_ckdisc_grid,
                                         solve_fused_rkn_grid)
    y0 = torch.tensor(FIS0[:2])
    wave = FusedGridAcc(lambda t, u, v: torch.roll(u, 1, 0) - u, "", N)
    calls = [
        lambda **kw: solve_fused_erk_grid(RHS["fisher"], (0.0, 0.2), y0,
                                          first_step=0.01, **kw),
        lambda **kw: solve_fused_rkn_grid(wave, (0.0, 0.2),
                                          torch.cat([y0, y0], 1), **kw),
        lambda **kw: solve_fused_ckdisc_grid(RHS["fisher"], (0.0, 0.2), y0,
                                             **kw),
    ]
    for call in calls:
        for a, b in zip(call(block_members=8), call()):
            assert torch.equal(a, b)


PARAMS_KW = dict(rtol=1e-5, atol=1e-8, first_step=0.005)


def test_params_match_jax_kernel():
    """B4's plain version with a growth rate a member (``params`` (B, 1),
    ``p`` (1, B) in the torch function) against the JAX kernel's fixture
    on the same members: status, nsteps and nfev identical (first_step
    given), max |dy| measured 2.6e-5 (the controller's pow parts last bits
    of h), gate 6e-5."""
    y0, r = fisher_p_inputs()
    np.testing.assert_array_equal(y0, FIXTURE["erk_params/y0"])
    np.testing.assert_array_equal(r, FIXTURE["erk_params/params"])
    y, st, ns, nf = (x.numpy() for x in fused_erk_grid_reference(
        FISHER_P, (0.0, 0.25), torch.tensor(y0), params=torch.tensor(r),
        **PARAMS_KW))
    assert np.all(st == 1)
    np.testing.assert_array_equal(st, FIXTURE["erk_params/1"])
    np.testing.assert_array_equal(ns, FIXTURE["erk_params/2"])
    np.testing.assert_array_equal(nf, FIXTURE["erk_params/3"])
    assert np.max(np.abs(y - FIXTURE["erk_params/0"])) <= 6e-5


def test_params_wrapper_on_cpu_and_a_baked_rate():
    """On CPU tensors the wrapper with ``params`` runs the plain version
    (bit for bit, no launch counted), and a member's rate bound as params
    equals the same rate baked into the function, member by member."""
    y0, r = fisher_p_inputs()
    y0, r = torch.tensor(y0), torch.tensor(r)
    before = solve_fused_erk_grid.launches
    out = solve_fused_erk_grid(FISHER_P, (0.0, 0.25), y0, params=r,
                               **PARAMS_KW)
    ref = fused_erk_grid_reference(FISHER_P, (0.0, 0.25), y0, params=r,
                                   **PARAMS_KW)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert solve_fused_erk_grid.launches == before
    for m in (0, B - 1):
        rate = r[m:m + 1, 0]
        one = fused_erk_grid_reference(
            lambda t, y: fisher_p(t, y, rate[None]), (0.0, 0.25),
            y0[m:m + 1], **PARAMS_KW)
        got = fused_erk_grid_reference(FISHER_P, (0.0, 0.25), y0[m:m + 1],
                                       params=r[m:m + 1], **PARAMS_KW)
        for a, b in zip(got, one):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw,match", [
    (dict(), r"pass params of shape \(B, 1\)"),
    (dict(params=np.ones((B - 1, 1), np.float32)), r"params must be \(B, k\)"),
    (dict(params=np.ones((B, 2), np.float32)), "k = 1")])
def test_params_checked_against_the_rhs(kw, match):
    """``params`` must be (B, k) with the FusedGridRHS's k, as the JAX
    kernel and B1 check it."""
    y0, _ = fisher_p_inputs()
    with pytest.raises(ValueError, match=match):
        solve_fused_erk_grid(FISHER_P, (0.0, 0.25), torch.tensor(y0), **kw)


@pytest.mark.parametrize("fun", ["acc", "class"])
def test_params_k_read_from_the_two_rhs_classes_only(fun):
    """Only a FusedRHS or a FusedGridRHS says how many parameters it takes:
    another of the port's right-hand-side objects, or the FusedGridRHS
    class itself, is not read for k, so that the wrapper's own type check
    (TypeError on the card) speaks, not an AttributeError."""
    from extensisq_tpu_torch.ops.fused_erk import member_params
    from extensisq_tpu_torch.ops.fused_rkn_grid import FusedGridAcc
    obj = (FusedGridAcc(lambda t, u, v: u, "", 4) if fun == "acc"
           else FusedGridRHS)
    p = torch.ones(B, 3)
    assert member_params(p, torch.zeros(B, 4), obj) is p


@pytest.mark.parametrize("option", ["t_eval", "events", "dense"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_fused_erk_grid(RHS["fisher"], (0.0, 1.0), torch.tensor(FIS0),
                             **{option: 1})


def test_generated_header_carries_the_grid_and_stub():
    from extensisq_tpu_torch.ops import _build
    from extensisq_tpu_torch.ops.fused_erk import _fused_consts
    text = _build.fused_rk_grid_header(_fused_consts(BS5), False, (N,),
                                       RHS["fisher"].cuda_src)
    assert f"using G = grid::Grid<{N}>;" in text
    assert "constexpr bool RKN = false;" in text
    assert RHS["fisher"].cuda_src in text and "float acc(" in text
    assert "constexpr int NPAR = 0;" in text
    assert "constexpr int NPAR = 1;" in _build.fused_rk_grid_header(
        _fused_consts(BS5), False, FISHER_P.shape, FISHER_P.cuda_src,
        FISHER_P.k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# kernel against its plain version on the same card: status identical,
# |dy| over finished members within the gates chip_smoke.py measured
CARD_GATES = {"fisher_plain": 1e-3, "fisher_comp": 1e-4, "fisher_h0": 1e-4,
              "fisher_ck5_h0": 1e-4, "skew_back": 2e-3, "overflow": 2e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_kernel_matches_plain_version_on_card(cuda, name):
    prob, meth, span, y0, kw = CASES[name]
    y0 = torch.tensor(y0, device=cuda)
    before = solve_fused_erk_grid.launches
    k = solve_fused_erk_grid(RHS[prob], span, y0, method=METHODS[meth], **kw)
    assert solve_fused_erk_grid.launches == before + 1
    r = fused_erk_grid_reference(RHS[prob], span, y0, method=METHODS[meth],
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[1], r[1])
    ok = r[1] == 1
    assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda):
    before = solve_fused_erk_grid.launches
    y, status, nsteps, nfev = solve_fused_erk_grid(
        RHS["fisher"], (0.0, 1.0), torch.zeros((0, N), device=cuda))
    assert y.shape == (0, N) and status.shape == (0,)
    assert solve_fused_erk_grid.launches == before


@pytest.mark.gpu
def test_cuda_tensor_needs_fused_grid_rhs(cuda):
    with pytest.raises(TypeError, match="FusedGridRHS"):
        solve_fused_erk_grid(fisher, (0.0, 1.0),
                             torch.tensor(FIS0, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_GATES))
def test_rule_shapes_bit_identical_to_block_of_32_on_card(cuda, name):
    """B4 at each shape its rule can take: one warp per member (four
    members a block, also with a ragged last block) bit for bit against
    one block of 32 threads per member; the rule's shape, the warp and the
    blocks of one and of two elements a thread against the plain version
    at the card gates; the wrapper records the rule's shape.  Comparison
    launches are not counted."""
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    prob, meth, span, y0, kw = CASES[name]
    fun, method = RHS[prob], METHODS[meth]
    y0 = torch.tensor(y0, device=cuda)
    built = FKG._kernel(method, fun)
    before = solve_fused_erk_grid.launches
    for ys in (y0, y0[:7]):
        block, _ = FKG._launch(built, span, ys, N, shape=(32, 0), **kw)
        warp, _ = FKG._launch(built, span, ys, N,
                              shape=(32, FKG.WARP_MEMBERS), **kw)
        for a, b in zip(warp, block):
            assert torch.equal(a, b)
    r = fused_erk_grid_reference(fun, span, y0, method=method, **kw)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rule = FKG._launch_shape(len(y0), N, sms)
    for shape in {rule, (32, FKG.WARP_MEMBERS), (FKG.grid_threads(N), 0),
                  (FKG.grid_threads(-(-N // 2)), 0)}:
        k, _ = FKG._launch(built, span, y0, N, shape=shape, **kw)
        assert torch.equal(k[1], r[1])
        ok = r[1] == 1
        assert (k[0][ok] - r[0][ok]).abs().max().item() <= CARD_GATES[name]
    assert solve_fused_erk_grid.launches == before
    solve_fused_erk_grid(fun, span, y0, method=method, **kw)
    assert solve_fused_erk_grid.last_shape == rule
    assert solve_fused_erk_grid.launches == before + 1


@pytest.mark.gpu
def test_params_kernel_matches_plain_version_on_card(cuda):
    """B4 with params on the card against its plain version there: status
    and counts equal where the step sequences allow, |dy| within the
    fisher_h0 gate; the warp body bit for bit the block of 32."""
    from extensisq_tpu_torch.ops import fused_erk_grid as FKG
    y0, r = (torch.tensor(x, device=cuda) for x in fisher_p_inputs())
    before = solve_fused_erk_grid.launches
    k = solve_fused_erk_grid(FISHER_P, (0.0, 0.25), y0, params=r,
                             **PARAMS_KW)
    assert solve_fused_erk_grid.launches == before + 1
    ref = fused_erk_grid_reference(FISHER_P, (0.0, 0.25), y0, params=r,
                                   **PARAMS_KW)
    assert torch.equal(k[1], ref[1])
    assert (k[0] - ref[0]).abs().max().item() <= CARD_GATES["fisher_h0"]
    built = FKG._kernel(None, FISHER_P)
    block, _ = FKG._launch(built, (0.0, 0.25), y0, N_P, shape=(32, 0),
                           params=r, **PARAMS_KW)
    warp, _ = FKG._launch(built, (0.0, 0.25), y0, N_P,
                          shape=(32, FKG.WARP_MEMBERS), params=r,
                          **PARAMS_KW)
    for a, b in zip(warp, block):
        assert torch.equal(a, b)


@pytest.mark.parametrize("members,n,shape", [
    (64, 256, (256, 0)), (1, 20, (32, 0)), (8, 100, (128, 0)),
    (264, 256, (256, 0)), (265, 256, (32, 4)), (1024, 256, (32, 4)),
    (1024, 512, (32, 4)), (1024, 513, (256, 0)), (1024, 1024, (256, 0)),
    (64, 1025, (256, 0)), (1024, 300, (32, 4)), (1024, 600, (256, 0))])
def test_launch_shape_on_132_sms(members, n, shape):
    """B4's launch shape on the H100's 132 SMs: one block of
    ``grid_threads(n)`` threads per member up to 2 members an SM, beyond
    one warp per member (four a block) where n is at most 512, else
    blocks of two elements a thread."""
    from extensisq_tpu_torch.ops.fused_erk_grid import _launch_shape
    assert _launch_shape(members, n, 132) == shape
