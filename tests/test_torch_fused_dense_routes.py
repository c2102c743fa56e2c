"""The dense records of the port's implicit and second-order fused kernels
(``dense=R`` on B2, B7, B5 and B6) and the per-member ``params`` of B5 and
B6, on the CPU.

The plain versions (``fused_esdirk_reference``,
``fused_esdirk_grid_reference``, ``fused_rkn_reference`` and
``fused_rkn_grid_reference``) run against the JAX kernels' records in
``tests/jax_fused_adjoint_routes.npz`` (``tests/jax_fused_adjoint_routes.py``,
interpret mode without FMA): Robertson (TRBDF2), the Kaps DAE behind a
hidden mass matrix and the pendulum DAE on B2, the Neumann heat line on
B7, the oscillator u'' = -4 u on B5, and B5 and B6 with a parameter a
member.  The records part from JAX's where the counts part (from the
second attempt XLA's and torch's ``pow`` part the last bits of h), so the
dense outputs are held at JAX's query points, not node by node.  The
kernels on the card are held against these plain versions by the tests
marked ``gpu`` (they skip where there is none) and by ``chip_smoke.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import Fi5N, Kv3I, TRBDF2
from extensisq_tpu_torch.ops import (FusedAcc, FusedGridAcc, FusedGridRHS,
                                     FusedRHS, fused_esdirk_grid_reference,
                                     fused_esdirk_reference,
                                     fused_rkn_grid_reference,
                                     fused_rkn_reference, solve_fused_esdirk,
                                     solve_fused_esdirk_grid,
                                     solve_fused_rkn, solve_fused_rkn_grid)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_esdirk as T  # noqa: E402

FIXTURE = np.load(Path(__file__).resolve().parent
                  / "jax_fused_adjoint_routes.npz")
N_HEAT = 32
N_WAVE = 32


def rob(t, y):
    r1 = 0.04 * y[0]
    r2 = 1e4 * y[1] * y[2]
    r3 = 3e7 * y[1] * y[1]
    return torch.stack([-r1 + r2, r1 - r2 - r3, r3])


ROB = FusedRHS(rob, """template <class T>
__device__ void rhs(T t, const T* y, T* dy) {
  const T r1 = 0.04f * y[0];
  const T r2 = 1e4f * y[1] * y[2];
  const T r3 = 3e7f * y[1] * y[1];
  dy[0] = -r1 + r2;
  dy[1] = r1 - r2 - r3;
  dy[2] = r3;
}""", 3)


def heat(t, y):
    left = torch.cat([y[:1], y[:-1]])
    right = torch.cat([y[1:], y[-1:]])
    return (left - 2.0 * y + right) * 50.0


HEAT = FusedGridRHS(heat, f"""template <class T>
__device__ T rhs(T t, const T* y, int i, const float* p) {{
  const T left = y[i > 0 ? i - 1 : 0];
  const T right = y[i < {N_HEAT - 1} ? i + 1 : {N_HEAT - 1}];
  return (left - 2.0f * y[i] + right) * 50.0f;
}}""", (N_HEAT,))
OSC = FusedAcc(lambda t, u, v: -4.0 * u, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a) {
  a[0] = -4.0f * u[0];
}""", 1)
# u'' = -w^2 u with w a member: dL/dw and dL/du0 of u(tf) in closed form
OSC_P = FusedAcc(lambda t, u, v, p: -(p[0] ** 2) * u, """template <class T>
__device__ void acc(T t, const T* u, const T* v, T* a, const T* p) {
  a[0] = -(p[0] * p[0]) * u[0];
}""", 1, 1)


def wave_p(t, u, v, p):
    return ((torch.roll(u, 1, 0) - 2.0 * u + torch.roll(u, -1, 0))
            * (p[0] * float(N_WAVE * N_WAVE)))


# the periodic wave with c2 a member
WAVE_P = FusedGridAcc(wave_p, f"""__device__ float acc(float t, const float* u,
                    const float* v, int i, const float* p) {{
  using G = tab::G;
  return (G::rolled<0>(u, i, 1) - 2.0f * u[i] + G::rolled<0>(u, i, -1))
         * (p[0] * {float(N_WAVE * N_WAVE)!r}f);
}}""", N_WAVE, 1)


def _inputs(name):
    """The fixture's inputs of ``name``: (y0, yp0 or None, params or
    None)."""
    return tuple(torch.tensor(FIXTURE[f"{name}/{k}"])
                 if f"{name}/{k}" in FIXTURE else None
                 for k in ("y0", "yp0", "params"))


# name -> (plain version, right-hand side, span, options)
CASES = {
    "rob_dense": (fused_esdirk_reference, ROB, (0.0, 100.0),
                  dict(method=TRBDF2, rtol=1e-4, atol=1e-8, dense=256)),
    "kaps_dense": (fused_esdirk_reference, T.PROBLEMS["kaps_hidden"],
                   (0.0, 1.0), dict(method=TRBDF2, M=T.M_HIDDEN, rtol=1e-4,
                                    atol=1e-6, dense=128)),
    "pend_dense": (fused_esdirk_reference, T.PROBLEMS["pend"], (0.0, 0.3),
                   dict(method=Kv3I, M=T.M_PEND, rtol=1e-4, atol=1e-6,
                        dense=128)),
    "heat_dense": (fused_esdirk_grid_reference, HEAT, (0.0, 0.1),
                   dict(rtol=1e-4, atol=1e-7, dense=128)),
    "osc_dense": (fused_rkn_reference, OSC, (0.0, 3.0),
                  dict(rtol=1e-5, atol=1e-8, dense=128)),
    "osc_params": (fused_rkn_reference, OSC_P, (0.0, 2.0),
                   dict(rtol=1e-6, atol=1e-9, dense=512)),
    "wave_params": (fused_rkn_grid_reference, WAVE_P, (0.0, 0.5),
                    dict(rtol=1e-5, atol=1e-8, dense=256)),
}
# the fixture's query points of each case's sol
QUERIES = {"rob_dense": np.concatenate([[0.0], np.logspace(-3, 2, 31)]),
           "kaps_dense": np.linspace(0.0, 1.0, 11),
           "pend_dense": np.linspace(0.0, 0.3, 7),
           "heat_dense": np.linspace(0.0, 0.1, 5),
           "osc_dense": np.linspace(0.0, 3.0, 6),
           "osc_params": np.linspace(0.0, 2.0, 9),
           "wave_params": np.linspace(0.0, 0.5, 6)}


def port_case(name, record=True, **over):
    """The plain version of the fixture's case ``name``, with its dense
    output (``record``) or without it."""
    plain, fun, span, kw = CASES[name]
    y0, yp0, params = _inputs(name)
    kw = dict(kw, **over)
    if not record:
        kw.pop("dense")
    if yp0 is not None:
        kw["yp0_batch"] = yp0
    if params is not None:
        kw["params"] = params
    return plain(fun, span, y0, **kw)


# (case, max |dy|, max |dnsteps|, gate on sol at JAX's query points against
# JAX's sol; |dy| and sol's difference relative to each component's largest
# value for rob_dense, as the JAX test reads it: y2 lives at ~3e-5, else
# absolute).  Measured: rob_dense 2.2e-7, 0, 3.0e-7 (1.2e-7 of y's
# difference absolute); kaps_dense 5.1e-7, 0, 2.0e-6; pend_dense
# 3.8e-6, 0, 6.7e-6; heat_dense 2.4e-7, 0, 2.4e-7; osc_dense 6.0e-7, 0,
# 6.1e-6; osc_params 6.3e-7, 1, 1.9e-5; wave_params 1.4e-5, 0, 5.8e-4 (the
# nodes part with the last bits of h, and sol between them by the
# interpolation error of ~23 steps of the wave).  Gates about 3x
GATES = [("rob_dense", 8e-7, 0, 1e-6), ("kaps_dense", 1.5e-6, 0, 6e-6),
         ("pend_dense", 1.2e-5, 0, 2e-5), ("heat_dense", 8e-7, 0, 8e-7),
         ("osc_dense", 2e-6, 0, 2e-5), ("osc_params", 2e-6, 2, 6e-5),
         ("wave_params", 4.5e-5, 0, 1.8e-3)]


@pytest.mark.parametrize("name,y_gate,dsteps,sol_gate", GATES)
def test_plain_records_match_jax(name, y_gate, dsteps, sol_gate):
    """The plain versions with ``dense`` (and B5's and B6's with
    ``params``) against the JAX kernels: status and valid equal, the step
    counts and the endpoints within the gates, the last node at tf, sol(tf)
    the final state within JAX's 1e-6, and ``sol`` at JAX's query points
    within the gate of JAX's."""
    y, st, ns, nf, sol = port_case(name)
    np.testing.assert_array_equal(st.numpy(), FIXTURE[f"{name}/1"])
    assert bool((st == 1).all())
    np.testing.assert_array_equal(sol.valid.numpy(),
                                  FIXTURE[f"{name}/valid"])
    assert bool(sol.valid.all())
    assert np.max(np.abs(ns.numpy() - FIXTURE[f"{name}/2"])) <= dsteps
    dy = np.abs(y.numpy() - FIXTURE[f"{name}/0"])
    if name == "rob_dense":
        dy = dy / np.abs(FIXTURE[f"{name}/0"]).max(axis=0)
    assert dy.max() <= y_gate, dy.max()
    b = torch.arange(y.shape[0])
    assert torch.equal(sol.ts[b, ns.long()], torch.full_like(
        sol.ts[:, 0], CASES[name][2][1]))
    assert (sol(torch.tensor(CASES[name][2][1])) - y).abs().max() <= 1e-6
    mine = sol(torch.tensor(QUERIES[name], dtype=torch.float32)).numpy()
    jax = FIXTURE[f"{name}/sol"]
    d = np.abs(mine - jax)
    if name == "rob_dense":
        d = d / np.abs(jax).max(axis=2, keepdims=True)
    assert d.max() <= sol_gate, d.max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_dense_leaves_the_outputs_as_they_are(name):
    """``dense`` leaves y, status, nsteps and nfev of the plain versions bit
    for bit as they are without it."""
    on, off = port_case(name), port_case(name, record=False)
    assert len(on) == 5 and len(off) == 4
    for a, b in zip(on[:4], off):
        assert torch.equal(a, b)


# a record of fewer rows than each case's attempts
OVERFLOW = {"rob_dense": 8, "heat_dense": 4, "osc_dense": 4,
            "wave_params": 4}


@pytest.mark.parametrize("name", sorted(OVERFLOW))
def test_record_overflow_is_not_valid(name):
    """A record of fewer rows than a member's attempts gives ``valid``
    False, as JAX's, and the outputs of the run without it."""
    on = port_case(name, dense=OVERFLOW[name])
    off = port_case(name, record=False)
    assert not bool(on[4].valid.any())
    for a, b in zip(on[:4], off):
        assert torch.equal(a, b)


def test_hidden_mass_rows_are_user_coordinates():
    """The hidden-M DAE's rows hold y = V w, as y_final does: the algebraic
    relation of the Kaps DAE in the user's coordinates (y = B^-1 z with
    y0 = y1^2) holds at every node within the solver's tolerance."""
    y, _, ns, _, sol = port_case("kaps_dense")
    z = sol.y_anchor.double()
    yy = torch.einsum("ij,brj->bri", torch.tensor(T.HID_BINV), z)
    for b in range(y.shape[0]):
        k = int(ns[b])
        r = yy[b, :k, 0] - yy[b, :k, 1] ** 2
        assert r.abs().max().item() <= 1e-4


@pytest.mark.parametrize("wrapper,fun,y0", [
    (solve_fused_esdirk, ROB, torch.tensor(FIXTURE["rob_dense/y0"])),
    (solve_fused_esdirk_grid, HEAT, torch.tensor(FIXTURE["heat_dense/y0"])),
    (solve_fused_rkn, OSC, torch.tensor(FIXTURE["osc_dense/y0"])),
    (solve_fused_rkn_grid, WAVE_P, None)])
def test_dense_none_and_zero_return_four_outputs(wrapper, fun, y0):
    """``dense`` None or 0 gives the four outputs, a negative count raises;
    on CPU tensors the wrappers run the plain versions."""
    kw = {}
    if y0 is None:
        y0, _, params = _inputs("wave_params")
        kw["params"] = params
    for dense in (None, 0):
        assert len(wrapper(fun, (0.0, 0.01), y0, dense=dense, **kw)) == 4
    with pytest.raises(ValueError, match="dense"):
        wrapper(fun, (0.0, 0.01), y0, dense=-1, **kw)


@pytest.mark.parametrize("wrapper,fun,n", [
    (solve_fused_rkn, OSC_P, 2), (solve_fused_rkn_grid, WAVE_P, 2 * N_WAVE)])
def test_member_params_of_the_acceleration_classes(wrapper, fun, n):
    """``member_params`` reads ``k`` from FusedAcc and FusedGridAcc: params
    of another width, of another member count, or none where k > 0 raise
    ``ValueError``; with them the wrapper runs."""
    y0 = torch.zeros(4, n)
    y0[:, 0] = 1.0
    with pytest.raises(ValueError, match="takes 1 parameters"):
        wrapper(fun, (0.0, 0.1), y0)
    with pytest.raises(ValueError, match="k = 1"):
        wrapper(fun, (0.0, 0.1), y0, params=torch.ones(4, 2))
    with pytest.raises(ValueError, match=r"\(B, k\)"):
        wrapper(fun, (0.0, 0.1), y0, params=torch.ones(3, 1))
    out = wrapper(fun, (0.0, 0.1), y0, params=torch.ones(4, 1))
    assert bool((out[1] == 1).all())


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _same_solution(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


# the wrappers of the cases and their dense-output gate on the card against
# the plain version at 97 common times (the card's powf parts h from the
# second attempt, so the nodes part and the dense outputs by their
# interpolation error between them; rob_dense each component over its
# largest value, as above, the others absolute).  Measured on an H100
# (NVIDIA H100 80GB HBM3, 700 W): heat_dense 4.8e-7, kaps_dense 2.4e-5,
# osc_dense 1.0e-4, osc_params 6.6e-5, pend_dense 6.7e-6, rob_dense
# 2.4e-7, wave_params 6.7e-4.  Gates 3-5x
CARD = {"rob_dense": (solve_fused_esdirk, 1e-6), "kaps_dense":
        (solve_fused_esdirk, 1e-4), "pend_dense": (solve_fused_esdirk, 3e-5),
        "heat_dense": (solve_fused_esdirk_grid, 2e-6),
        "osc_dense": (solve_fused_rkn, 4e-4),
        "osc_params": (solve_fused_rkn, 2e-4),
        "wave_params": (solve_fused_rkn_grid, 2e-3)}


def _card_case(name, device, **over):
    plain, fun, span, kw = CASES[name]
    y0, yp0, params = (None if x is None else x.to(device)
                       for x in _inputs(name))
    kw = dict(kw, **over)
    if yp0 is not None:
        kw["yp0_batch"] = yp0
    if params is not None:
        kw["params"] = params
    return CARD[name][0](fun, span, y0, **kw), (plain, fun, span, y0, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD))
def test_record_kernels_match_plain_versions_on_card(cuda, name):
    """B2, B7, B5 and B6 with their records on the card, one launch each:
    the record leaves the four outputs bit for bit; status and valid as
    the plain version's, the dense output within the gate of it."""
    wrapper = CARD[name][0]
    before = wrapper.launches
    on, (plain, fun, span, y0, kw) = _card_case(name, cuda)
    assert wrapper.launches == before + 1
    off, _ = _card_case(name, cuda, dense=None)
    assert all(torch.equal(a, b) for a, b in zip(on[:4], off))
    ref = plain(fun, span, y0, **kw)
    assert torch.equal(on[1], ref[1]) and torch.equal(on[4].valid,
                                                      ref[4].valid)
    d = card_dense_difference(name, on[4], ref[4], span)
    assert d <= CARD[name][1], d


def card_dense_difference(name, sol, ref, span):
    """The largest difference of the dense outputs ``sol`` and ``ref`` at 97
    common times of ``span``: for rob_dense each component's over that
    component's largest |y| in ``ref``'s, else absolute."""
    tq = torch.linspace(*span, 97, device=sol.ts.device)
    ref_q = ref(tq)
    d = (sol(tq) - ref_q).abs()
    if name == "rob_dense":
        d = d / ref_q.abs().amax((0, 2))[:, None]
    return d.max().item()


@pytest.mark.gpu
def test_record_lane_and_warp_bodies_bit_identical_on_card(cuda):
    """B2's and B5's lane groups write the thread body's records and
    outputs bit for bit, and B7's and B6's warps those of their block of
    32."""
    from extensisq_tpu_torch.ops import fused_esdirk as FE
    from extensisq_tpu_torch.ops import fused_esdirk_grid as FEG
    from extensisq_tpu_torch.ops import fused_rkn as FN
    from extensisq_tpu_torch.ops import fused_rkn_grid as FNG
    y0 = torch.tensor(FIXTURE["rob_dense/y0"], device=cuda)
    outs = [FE._launch(ROB, (0.0, 100.0), y0, TRBDF2, None, None, 1e-4, 1e-8,
                       None, 100_000, False, None, lanes, None, None, None,
                       256)[0] for lanes in (1, 4, 8, 16, 32)]
    y0, _, p = _inputs("osc_params")
    y0, p = y0.to(cuda), p.to(cuda)
    outs_n = [FN._launch(OSC_P, (0.0, 2.0), y0, Fi5N, 1e-6, 1e-9, None,
                         100_000, False, None, lanes, None, p, 512)[0]
              for lanes in (1, 2, 4, 8)]
    for group in (outs, outs_n):
        for o in group[1:]:
            assert all(torch.equal(a, b) for a, b in zip(group[0][:4], o[:4]))
            assert _same_solution(group[0][4], o[4])
    y0 = torch.tensor(FIXTURE["heat_dense/y0"], device=cuda)
    built = FEG._kernel(None, HEAT, None, True)
    warp, b32 = (FEG._launch(built, (0.0, 0.1), y0, rtol=1e-4, atol=1e-7,
                             shape=s, dense=128)[0] for s in ((32, 4),
                                                              (32, 0)))
    y0, _, p = _inputs("wave_params")
    y0, p = y0.to(cuda), p.to(cuda)
    built = FNG._kernel(None, WAVE_P, True)
    wwarp, wb32 = (FNG._launch(built, (0.0, 0.5), y0, N_WAVE, shape=s,
                               rtol=1e-5, atol=1e-8, params=p,
                               dense=256)[0] for s in ((32, 4), (32, 0)))
    for a, b in ((warp, b32), (wwarp, wb32)):
        assert all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
        assert _same_solution(a[4], b[4])
