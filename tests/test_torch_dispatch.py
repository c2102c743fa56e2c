"""``ops.solve_fused``, the fused kernels' front door, on the CPU.

Each route is checked by the wrapper it calls, against the kernel the JAX
dispatcher picks for the same family, state size and layout (its
wrappers replaced by recorders, so nothing runs there), and its result
against the direct wrapper call bit for bit (the plain versions, as a CPU
tensor asks).  The cases are ``tests/test_fused_pallas.py:1739``'s routes
(BS5 on 128 Van der Pol members, Kv3I past the flat cap, SSV2stab on one
grid and on a member stack) and one route per family and layout, with the
RHS object's type deciding the layout, the RKN half-width, the flat caps,
a contradicting ``layout=`` (``TypeError``), a method without a family
(``ValueError``), per-member ``params``, passed through to B1, B2, B5 and
B6, and ``dense``, passed through to B5 and B7.
"""
import numpy as np
import pytest
import torch

import extensisq_tpu_torch as P
from extensisq_tpu_torch.ops import (FusedAcc, FusedGridAcc, FusedGridRHS,
                                     FusedRHS, dispatch)
from extensisq_tpu_torch.ops.dispatch import solve_fused

WRAPPERS = ("solve_fused_erk", "solve_fused_erk_grid", "solve_fused_ckdisc",
            "solve_fused_ckdisc_grid", "solve_fused_rkn",
            "solve_fused_rkn_grid", "solve_fused_esdirk",
            "solve_fused_esdirk_grid", "solve_fused_adams",
            "solve_fused_adams_grid", "solve_fused_rkc",
            "solve_fused_rkc_ensemble")


def vdp(t, y):
    return torch.stack([y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def decay(t, y):
    return -y


def vdp_p(t, y, p):
    return torch.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]])


def decay_p(t, y, p):
    return -p[0] * y


def heat(t, y):
    yp = torch.nn.functional.pad(y, (0, 0, 1, 1))
    return (yp[:-2] - 2.0 * y + yp[2:]) * 4.0


def osc_acc(t, u, v):
    return -u


def osc_acc_p(t, u, v, p):
    return -p[0] * u


def bru(t, uv):
    dx = 1.0 / 16
    lap = (torch.roll(uv, 1, 1) + torch.roll(uv, -1, 1)
           + torch.roll(uv, 1, 2) + torch.roll(uv, -1, 2) - 4.0 * uv) / dx ** 2
    u, v = uv[0], uv[1]
    return torch.stack([1.0 + u * u * v - 4.0 * u + 0.02 * lap[0],
                        3.0 * u - u * u * v + 0.02 * lap[1]])


def heat2d(t, u):
    return 0.02 * 16 ** 2 * (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
                             + torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
                             - 4.0 * u)


def members(n, b=4, base=1.0):
    y = np.full((b, n), base, np.float32)
    y[:, 0] += np.linspace(0.0, 0.5, b, dtype=np.float32)
    return torch.as_tensor(y)


VDP0 = torch.zeros((128, 2))
VDP0[:, 0] = 2.0
BRU0 = np.ones((2, 8, 16), np.float32)
BRU0[0] += 0.1 * np.sin(2 * np.pi * np.linspace(0, 1, 16, endpoint=False))
BRU0[1] = 3.0
BRU0 = torch.as_tensor(BRU0)
RHO = 8 * 0.02 * 16 ** 2 + 6.0
# per-member parameters of 4 members
P4 = torch.linspace(1.0, 2.0, 4)[:, None]

# name -> (fun, method name, y0, layout=, ensemble=, kw, wrapper expected)
CASES = {
    # tests/test_fused_pallas.py:1739's routes
    "bs5_vdp128": (vdp, "BS5", VDP0, None, None, {}, "solve_fused_erk"),
    "kv3i_n9_grid": (decay, "Kv3I", torch.ones((4, 9)), None, None, {},
                     "solve_fused_esdirk_grid"),
    "rkc_single": (bru, "SSV2stab", BRU0, None, None, dict(rho=RHO),
                   "solve_fused_rkc"),
    "rkc_stack": (bru, "SSV2stab", BRU0[None], None, None, dict(rho=RHO),
                  "solve_fused_rkc_ensemble"),
    "rkc_forced": (heat2d, "SSV2stab", BRU0[0][None].repeat(3, 1, 1),
                   None, True, dict(rho=RHO), "solve_fused_rkc_ensemble"),
    # the RHS object decides the layout
    "erk_flat_obj": (FusedRHS(vdp, "", 2), "BS5", members(2), None, None,
                     {}, "solve_fused_erk"),
    "erk_grid_obj": (FusedGridRHS(heat, "", (8,)), "BS5", members(8), None,
                     None, {}, "solve_fused_erk_grid"),
    "erk_grid_obj_layout": (FusedGridRHS(heat, "", (8,)), "BS5", members(8),
                            "grid", None, {}, "solve_fused_erk_grid"),
    "ck_flat_obj": (FusedRHS(decay, "", 2), "CKdisc", members(2), None,
                    None, {}, "solve_fused_ckdisc"),
    "ck_grid_obj": (FusedGridRHS(heat, "", (8,)), "CKdisc", members(8),
                    None, None, {}, "solve_fused_ckdisc_grid"),
    "rkn_flat_obj": (FusedAcc(osc_acc, "", 1), "Fi5N", members(2), None,
                     None, {}, "solve_fused_rkn"),
    "rkn_grid_obj": (FusedGridAcc(osc_acc, "", 4), "Fi5N", members(8),
                     None, None, {}, "solve_fused_rkn_grid"),
    "esdirk_flat_obj": (FusedRHS(decay, "", 2), "Kv3I", members(2), None,
                        None, {}, "solve_fused_esdirk"),
    "esdirk_grid_obj": (FusedGridRHS(heat, "", (8,)), "Kv3I", members(8),
                        None, None, dict(M=np.ones(8)),
                        "solve_fused_esdirk_grid"),
    "adams_flat_obj": (FusedRHS(decay, "", 2), "SWAG", members(2), None,
                       None, dict(k_max=4), "solve_fused_adams"),
    "adams_grid_obj": (FusedGridRHS(heat, "", (8,)), "SWAG", members(8),
                       None, None, dict(k_max=4), "solve_fused_adams_grid"),
    # a bare callable: the size rule
    "erk_callable_48": (decay, "BS5", members(48), None, None, {},
                        "solve_fused_erk_grid"),
    "erk_callable_47": (decay, "BS5", members(47), None, None, {},
                        "solve_fused_erk"),
    "rkn_half_96": (osc_acc, "Fi5N", members(96), None, None, {},
                    "solve_fused_rkn_grid"),
    "rkn_half_94": (osc_acc, "Fi5N", members(94), None, None, {},
                    "solve_fused_rkn"),
    "adams_cap_8": (decay, "SWAG", members(8), None, None, dict(k_max=4),
                    "solve_fused_adams"),
    "adams_cap_9": (decay, "SWAG", members(9), None, None, dict(k_max=4),
                    "solve_fused_adams_grid"),
    "esdirk_cap_8": (decay, "Kv3I", members(8), None, None, {},
                     "solve_fused_esdirk"),
    "ck_forced_grid": (decay, "CKdisc", members(4), "grid", None, {},
                       "solve_fused_ckdisc_grid"),
    "default_method": (vdp, None, members(2), None, None, {},
                       "solve_fused_erk"),
    # params pass through to B1 and B2
    "erk_params": (FusedRHS(vdp_p, "", 2, 1), "BS5", members(2), None, None,
                   dict(params=P4), "solve_fused_erk"),
    "esdirk_params": (FusedRHS(decay_p, "", 2, 1), "Kv3I", members(2), None,
                      None, dict(params=P4), "solve_fused_esdirk"),
    # and to B5 and B6, and dense to B5 and B7
    "rkn_params": (FusedAcc(osc_acc_p, "", 1, 1), "Fi5N", members(2), None,
                   None, dict(params=P4), "solve_fused_rkn"),
    "rkn_grid_params": (FusedGridAcc(osc_acc_p, "", 4, 1), "Fi5N",
                        members(8), None, None, dict(params=P4),
                        "solve_fused_rkn_grid"),
    "rkn_dense": (FusedAcc(osc_acc, "", 1), "Fi5N", members(2), None, None,
                  dict(dense=64), "solve_fused_rkn"),
    "esdirk_grid_dense": (FusedGridRHS(heat, "", (8,)), "Kv3I", members(8),
                          None, None, dict(dense=64),
                          "solve_fused_esdirk_grid"),
}
SPAN = (0.0, 0.5)


class _Recorder:
    def __init__(self):
        self.calls = []

    def spy(self, name, fn):
        def wrapped(*a, **k):
            self.calls.append(name)
            return None if fn is None else fn(*a, **k)
        return wrapped


@pytest.fixture
def port_calls(monkeypatch):
    """The port dispatcher with each wrapper wrapped by a recorder."""
    rec = _Recorder()
    routes = {fam: (rec.spy(flat.__name__, flat),
                    rec.spy(grid.__name__, grid), takes)
              for fam, (flat, grid, takes) in dispatch._ROUTES.items()}
    monkeypatch.setattr(dispatch, "_ROUTES", routes)
    for name in ("solve_fused_rkc", "solve_fused_rkc_ensemble"):
        monkeypatch.setattr(dispatch, name,
                            rec.spy(name, getattr(dispatch, name)))
    return rec


def jax_route(method, shape, layout, ensemble):
    """The wrapper the JAX dispatcher calls for this family, state shape
    and layout (its wrappers replaced by recorders that run nothing)."""
    import extensisq_tpu as X
    from extensisq_tpu.ops import dispatch as JD
    rec = _Recorder()
    saved = {n: getattr(JD, n) for n in WRAPPERS}
    try:
        for n in WRAPPERS:
            setattr(JD, n, rec.spy(n, None))
        m = None if method is None else getattr(X, method)
        JD.solve_fused(None, SPAN, np.zeros(shape, np.float32), method=m,
                       layout=layout, ensemble=ensemble)
    finally:
        for n, f in saved.items():
            setattr(JD, n, f)
    return rec.calls


def _direct(name, fun, method, y0, kw):
    f = getattr(P.ops, name)
    if name in ("solve_fused_erk", "solve_fused_erk_grid", "solve_fused_rkn",
                "solve_fused_rkn_grid", "solve_fused_esdirk",
                "solve_fused_esdirk_grid"):
        kw = dict(kw, method=None if method is None else getattr(P, method))
    return f(fun, SPAN, y0, **kw)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_route(port_calls, name):
    fun, method, y0, layout, ensemble, kw, want = CASES[name]
    m = None if method is None else getattr(P, method)
    out = solve_fused(fun, SPAN, y0, method=m, layout=layout,
                      ensemble=ensemble, **kw)
    assert port_calls.calls == [want]
    # the JAX dispatcher picks the same kernel for the same family, size
    # and layout (an RHS object's layout stated)
    own = dispatch._layout_of(fun)
    assert jax_route(method, tuple(y0.shape), layout or own,
                     ensemble) == [want]
    _equal(out, _direct(want, fun, method, y0, kw))


def test_layout_contradicting_the_rhs_raises():
    with pytest.raises(TypeError, match="contradicts"):
        solve_fused(FusedRHS(vdp, "", 2), SPAN, members(2), method=P.BS5,
                    layout="grid")
    with pytest.raises(TypeError, match="contradicts"):
        solve_fused(FusedGridAcc(osc_acc, "", 4), SPAN, members(8),
                    method=P.Fi5N, layout="flat")


def test_method_without_family_raises():
    class Custom:
        name = "custom"
    with pytest.raises(ValueError, match="no 'family' attribute"):
        solve_fused(vdp, SPAN, members(2), method=Custom())


def test_grid_beyond_a_block_surfaces():
    """The grid wrappers' own errors surface through the front door."""
    with pytest.raises(ValueError, match="shape"):
        solve_fused(FusedGridRHS(heat, "", (2, 4)), SPAN, members(8),
                    method=P.BS5)
