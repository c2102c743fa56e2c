"""The JAX package's dense records of its implicit and second-order fused
kernels (B2, B7, B5 and B6), their per-member parameters on B5 and B6, and
its continuous adjoint through them, in interpret mode without FMA,
written to ``tests/jax_fused_adjoint_routes.npz`` with their inputs: the
port's tests (``tests/test_torch_fused_dense.py`` and
``test_torch_fused_adjoint.py``) read them from there, since the
interpret-mode runs take minutes.  The records, each with its four
outputs, the first rows of its dense output and ``sol`` at query points:

* ``rob_dense``: ``solve_fused_esdirk`` TRBDF2 on Robertson, 8 members,
  t in [0, 100] at rtol 1e-4 / atol 1e-8, ``dense=256``
  (``tests/test_fused_dense.py:107-137``), queried at 0 and 31 points
  from 1e-3 to 1e2;
* ``kaps_dense``: the Kaps DAE behind the hidden mass matrix of
  ``tests/test_torch_fused_esdirk.py`` (``M_HIDDEN``), 8 members, TRBDF2
  on t in [0, 1] at rtol 1e-4 / atol 1e-6, ``dense=128``;
* ``pend_dense``: the pendulum DAE (M = diag(1, 1, 1, 1, 0)) from the
  port's consistent starts, 8 members, Kv3I on t in [0, 0.3] at rtol
  1e-4 / atol 1e-6, ``dense=128``;
* ``heat_dense``: ``solve_fused_esdirk_grid`` on the Neumann heat line, n
  = 32, 8 members, t in [0, 0.1] at rtol 1e-4 / atol 1e-7, ``dense=128``
  (``tests/test_fused_dense.py:167-189``);
* ``osc_dense``: ``solve_fused_rkn`` on u'' = -4 u, 16 members, t in [0,
  3] at rtol 1e-5 / atol 1e-8, ``dense=128``
  (``tests/test_fused_dense.py:270-296``, cut from 128 members);
* ``osc_params``: ``solve_fused_rkn`` with ``params`` on u'' = -w^2 u, w
  in [1, 2], 16 members, t in [0, 2] at rtol 1e-6 / atol 1e-9,
  ``dense=512``;
* ``wave_params``: ``solve_fused_rkn_grid`` with ``params`` on the
  periodic wave u'' = c2 n^2 (roll(u, 1) - 2 u + roll(u, -1)), n = 32, c2
  in [0.4, 0.6], 8 members, t in [0, 0.5] at rtol 1e-5 / atol 1e-8,
  ``dense=256``;

and the adjoints, each the value and the gradients (t0, tf, y0, params)
of its loss through ``solve_fused_adjoint``:

* ``adj_esdirk``: ``sum(y_f[:, 0])`` on the stiff relaxation of
  ``tests/test_fused_adjoint.py:185-225`` (TRBDF2, 8 members, k in [50,
  400], ``dense=256``), with the central differences of B2 with params
  (eps 0.5, rtol 1e-6 / atol 1e-9) and the f64 ``solve_final`` jacobian
  row of member 0;
* ``adj_esdirk_grid``: ``sum(mean(y_f))`` on the reaction-diffusion of
  ``:142-182`` (B7, n = 64, 8 members, k in [5, 30], t in [0, 0.04],
  ``dense=256``), with the central differences of B7 with params (eps
  0.1, rtol 1e-6 / atol 1e-9);
* ``adj_rkn``: ``sum(u_f)`` on the oscillator of ``:228-267`` (Fi5N, 8
  members, w in [1, 2], tf = 2, rtol 1e-6 / atol 1e-9, ``dense=512``);
* ``adj_rkn_grid``: ``sum(u_f[:, 0])`` on the wave of ``wave_params``
  with c2 per member, a grid RKN adjoint that the JAX package's tests
  lack (B6, rtol 1e-6 / atol 1e-9, ``dense=320``), with the central
  differences of B6 with params (eps 1e-2, compensated, rtol 1e-8 / atol
  1e-11).

Run from the repository root (about 6 min)::

    PYTHONPATH=. python tests/jax_fused_adjoint_routes.py
"""
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_cpu_max_isa=SSE4_2"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

from extensisq_tpu import sensitivity  # noqa: E402
from extensisq_tpu.methods import Fi5N, Kv3I, TRBDF2  # noqa: E402
from extensisq_tpu.ops import (solve_fused_esdirk,  # noqa: E402
                               solve_fused_esdirk_grid, solve_fused_rkn,
                               solve_fused_rkn_grid)
from extensisq_tpu.ops.fused_sens import solve_fused_adjoint  # noqa: E402

HERE = Path(__file__).resolve().parent
OUT = HERE / "jax_fused_adjoint_routes.npz"
sys.path.insert(0, str(HERE))
import test_torch_fused_esdirk as T  # noqa: E402

B = 8
FIELDS = ("ts", "t_anchor", "h", "y_anchor", "Q", "valid")
N_HEAT = 32
N_WAVE = 32
N_RD = 64


def rob(t, y):
    r1 = 0.04 * y[0]
    r2 = 1e4 * y[1] * y[2]
    r3 = 3e7 * y[1] * y[1]
    return jnp.stack([-r1 + r2, r1 - r2 - r3, r3])


def kaps_hidden(t, z):
    A, Binv = T.HID_A, T.HID_BINV
    y0 = Binv[0, 0] * z[0] + Binv[0, 1] * z[1]
    y1 = Binv[1, 0] * z[0] + Binv[1, 1] * z[1]
    f0 = -y0 + y1 * y1
    f1 = y0 - y1 - y1 * y1
    return jnp.stack([A[0, 0] * f0 + A[0, 1] * f1,
                      A[1, 0] * f0 + A[1, 1] * f1])


def pend(t, s):
    return jnp.stack([s[2], s[3], -s[4] * s[0], -s[4] * s[1] - 9.81,
                      s[2] * s[2] + s[3] * s[3]
                      - s[4] * (s[0] * s[0] + s[1] * s[1]) - 9.81 * s[1]])


def heat(t, y):
    left = jnp.concatenate([y[:, :1], y[:, :-1]], axis=1)
    right = jnp.concatenate([y[:, 1:], y[:, -1:]], axis=1)
    return (left - 2.0 * y + right) * 50.0


def osc(t, u, v):
    return -4.0 * u


def osc_p(t, u, v, p):
    return -(p[0] ** 2) * u


def wave_p(t, u, v, p):
    return ((jnp.roll(u, 1, -1) - 2.0 * u + jnp.roll(u, -1, -1))
            * (p[0] * float(N_WAVE * N_WAVE)))


def stiff_rows(t, y, p):
    return jnp.stack([-p[0] * (y[0] - jnp.sin(y[1])), -y[1] + 0.1 * y[0]])


def rd_g(t, y, p):
    left = jnp.concatenate([y[:, :1], y[:, :-1]], axis=1)
    right = jnp.concatenate([y[:, 1:], y[:, -1:]], axis=1)
    return (left - 2.0 * y + right) * 200.0 - p[0] * (y - 1.0)


def inputs():
    """Each case's (y0, yp0, params), as the port's tests build them."""
    rob0 = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (B, 1))
    a = np.linspace(0.8, 1.2, B)
    kz0 = np.ascontiguousarray((T.HID_B @ np.stack([a * a, a])).T,
                               np.float32)
    kzp0 = np.ascontiguousarray((T.HID_B @ np.stack([-2.0 * a * a, -a])).T,
                                np.float32)
    pend0, pendp0 = (x.numpy() for x in T.pend_start(B, 0.3, 1e-4, 1e-6))
    xh = np.arange(N_HEAT)
    heat0 = np.tile((1.0 + 0.3 * np.sin(2 * np.pi * xh / N_HEAT))
                    .astype(np.float32), (B, 1))
    osc0 = np.tile([1.0, 0.0], (16, 1)).astype(np.float32)
    ws16 = np.linspace(1.0, 2.0, 16).astype(np.float32)[:, None]
    xw = np.arange(N_WAVE) / N_WAVE
    u0 = (np.sin(2 * np.pi * xw) + 0.5 * np.cos(4 * np.pi * xw)
          ).astype(np.float32)
    wave0 = np.tile(np.concatenate([u0, np.zeros_like(u0)]), (B, 1))
    c2 = np.linspace(0.4, 0.6, B).astype(np.float32)[:, None]
    stiff0 = np.tile([2.0, 1.0], (B, 1)).astype(np.float32)
    ks = np.linspace(50.0, 400.0, B).astype(np.float32)[:, None]
    xr = np.linspace(0, 1, N_RD)
    rd0 = np.tile((1.0 + 0.5 * np.sin(np.pi * xr)).astype(np.float32),
                  (B, 1))
    krd = np.linspace(5.0, 30.0, B).astype(np.float32)[:, None]
    ws = np.linspace(1.0, 2.0, B).astype(np.float32)[:, None]
    osc8 = np.zeros((B, 2), np.float32)
    osc8[:, 0] = 1.0
    return {"rob_dense": (rob0, None, None),
            "kaps_dense": (kz0, kzp0, None),
            "pend_dense": (np.ascontiguousarray(pend0),
                           np.ascontiguousarray(pendp0), None),
            "heat_dense": (heat0, None, None),
            "osc_dense": (osc0, None, None),
            "osc_params": (osc0, None, ws16),
            "wave_params": (wave0, None, c2),
            "adj_esdirk": (stiff0, None, ks),
            "adj_esdirk_grid": (rd0, None, krd),
            "adj_rkn": (osc8, None, ws),
            "adj_rkn_grid": (wave0, None, c2)}


# query points of each record's sol
QUERIES = {"rob_dense": np.concatenate([[0.0], np.logspace(-3, 2, 31)]),
           "kaps_dense": np.linspace(0.0, 1.0, 11),
           "pend_dense": np.linspace(0.0, 0.3, 7),
           "heat_dense": np.linspace(0.0, 0.1, 5),
           "osc_dense": np.linspace(0.0, 3.0, 6),
           "osc_params": np.linspace(0.0, 2.0, 9),
           "wave_params": np.linspace(0.0, 0.5, 6)}


def records(out):
    """The dense runs: each case's outputs, its dense output's first rows
    and its values at the case's query points."""
    flat = dict(block_members=128, interpret=True)
    grid = dict(block_members=8, interpret=True)
    runs = {
        "rob_dense": lambda y0, yp0, p: solve_fused_esdirk(
            rob, (0.0, 100.0), y0, method=TRBDF2, rtol=1e-4, atol=1e-8,
            dense=256, **flat),
        "kaps_dense": lambda y0, yp0, p: solve_fused_esdirk(
            kaps_hidden, (0.0, 1.0), y0, method=TRBDF2, M=T.M_HIDDEN,
            yp0_batch=yp0, rtol=1e-4, atol=1e-6, dense=128, **flat),
        "pend_dense": lambda y0, yp0, p: solve_fused_esdirk(
            pend, (0.0, 0.3), y0, method=Kv3I, M=np.diag(T.M_PEND),
            yp0_batch=yp0, rtol=1e-4, atol=1e-6, dense=128, **flat),
        "heat_dense": lambda y0, yp0, p: solve_fused_esdirk_grid(
            heat, (0.0, 0.1), y0, rtol=1e-4, atol=1e-7, dense=128, **grid),
        "osc_dense": lambda y0, yp0, p: solve_fused_rkn(
            osc, (0.0, 3.0), y0, rtol=1e-5, atol=1e-8, dense=128, **flat),
        "osc_params": lambda y0, yp0, p: solve_fused_rkn(
            osc_p, (0.0, 2.0), y0, params=p, rtol=1e-6, atol=1e-9,
            dense=512, **flat),
        "wave_params": lambda y0, yp0, p: solve_fused_rkn_grid(
            wave_p, (0.0, 0.5), y0, params=p, rtol=1e-5, atol=1e-8,
            dense=256, **grid),
    }
    for name, run in runs.items():
        y0, yp0, params = inputs()[name]
        res = run(y0, yp0, params)
        out[name + "/y0"] = y0
        if yp0 is not None:
            out[name + "/yp0"] = yp0
        if params is not None:
            out[name + "/params"] = params
        for i, r in enumerate(res[:4]):
            out[f"{name}/{i}"] = np.asarray(r)
        rows = int(np.asarray(res[2]).max()) + 1
        sol = res[4]
        for f in FIELDS:
            v = np.asarray(getattr(sol, f))
            out[f"{name}/{f}"] = v if f == "valid" else v[:, :rows + 1]
        out[name + "/sol"] = np.asarray(
            sol(jnp.asarray(QUERIES[name], jnp.float32)))
        print(name, "done", flush=True)


def _adjoint(out, name, fun, method, span, dense, bm, layout, loss_of,
             rtol=1e-6, atol=1e-9):
    """The value and gradients (t0, tf, y0, params) of ``loss_of(y_f)``
    through ``solve_fused_adjoint``."""
    y0, _, params = inputs()[name]

    def loss(tsp, Y, P):
        yf = solve_fused_adjoint(fun, tsp, Y, P, method, rtol, atol,
                                 100_000, bm, True, dense, None, None, None,
                                 layout)
        return loss_of(yf)

    val, ((gt0, gtf), gy0, gp) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        span, jnp.asarray(y0), jnp.asarray(params))
    for key, v in (("value", val), ("t0", gt0), ("tf", gtf), ("y0", gy0),
                   ("params", gp)):
        out[f"{name}/{key}"] = np.asarray(v)
    out[name + "/in_y0"] = y0
    out[name + "/in_params"] = params


def _central(solver, fun, span, y0, params, eps, loss_of, **kw):
    """Central differences of ``loss_of`` per member in its parameter."""
    yp = np.asarray(solver(fun, span, y0, params=params + eps, **kw)[0])
    ym = np.asarray(solver(fun, span, y0, params=params - eps, **kw)[0])
    return (loss_of(yp) - loss_of(ym)) / (2 * eps)


def adjoints(out):
    _adjoint(out, "adj_esdirk", stiff_rows, TRBDF2, (0.0, 1.0), 256, 128,
             "flat", lambda yf: jnp.sum(yf[:, 0]), rtol=1e-5, atol=1e-8)
    y0, _, ks = inputs()["adj_esdirk"]
    out["adj_esdirk/fd"] = _central(
        solve_fused_esdirk, stiff_rows, (0.0, 1.0), y0, ks, np.float32(0.5),
        lambda y: y[:, 0], method=TRBDF2, rtol=1e-6, atol=1e-9,
        block_members=128, interpret=True)
    k0 = float(ks[0, 0])
    J = jax.jacrev(lambda v: sensitivity.solve_final(
        lambda t, y, p: jnp.stack([-p * (y[0] - jnp.sin(y[1])),
                                   -y[1] + 0.1 * y[0]]),
        (0.0, 1.0), v, k0, None, 1e-9, 1e-12, 10_000))(
            jnp.array([2.0, 1.0]))
    out["adj_esdirk/gref0"] = np.asarray(J)[0]
    print("adj_esdirk done", flush=True)

    _adjoint(out, "adj_esdirk_grid", rd_g, TRBDF2, (0.0, 0.04), 256, 8,
             "grid", lambda yf: jnp.sum(jnp.mean(yf, axis=1)), rtol=1e-5,
             atol=1e-8)
    y0, _, krd = inputs()["adj_esdirk_grid"]
    out["adj_esdirk_grid/fd"] = _central(
        solve_fused_esdirk_grid, rd_g, (0.0, 0.04), y0, krd,
        np.float32(0.1), lambda y: y.mean(1), method=TRBDF2, rtol=1e-6,
        atol=1e-9, block_members=8, interpret=True)
    print("adj_esdirk_grid done", flush=True)

    _adjoint(out, "adj_rkn", osc_p, Fi5N, (0.0, 2.0), 512, 128, "flat",
             lambda yf: jnp.sum(yf[:, 0]))
    print("adj_rkn done", flush=True)

    _adjoint(out, "adj_rkn_grid", wave_p, Fi5N, (0.0, 0.5), 320, 8, "grid",
             lambda yf: jnp.sum(yf[:, 0]))
    y0, _, c2 = inputs()["adj_rkn_grid"]
    out["adj_rkn_grid/fd"] = _central(
        solve_fused_rkn_grid, wave_p, (0.0, 0.5), y0, c2, np.float32(1e-2),
        lambda y: y[:, 0], rtol=1e-8, atol=1e-11, compensated=True,
        block_members=8, interpret=True)
    print("adj_rkn_grid done", flush=True)


def main():
    out = {}
    records(out)
    adjoints(out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
