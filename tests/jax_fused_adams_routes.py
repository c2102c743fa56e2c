"""The JAX package's SWAG kernels (B3 and B8) with per-member parameters and
their dense records, and its continuous adjoint through them, in
interpret mode without FMA, written to ``tests/jax_fused_adams_routes.npz``
with their inputs: ``tests/test_torch_fused_adams_routes.py`` reads them
from there, since the interpret-mode runs take minutes.  The cases:

* ``params_decay``: ``solve_fused_adams`` with ``params`` on y' = (-l y0,
  -2 l y1), l in [0.5, 2], 16 members from y0 = (1, 1), t in [0, 1] at
  rtol 1e-4 / atol 1e-7, k_max 6 (``tests/test_fused_params.py:94-108``,
  cut from 128 members);
* ``params_heat``: ``solve_fused_adams_grid`` with ``params`` on the
  periodic heat MoL D (roll(y, 1) - 2 y + roll(y, -1)) / dx^2, n = 128, D
  in [0.001, 0.003], 16 members from sin(2 pi x), t in [0, 0.3] at rtol
  1e-4 / atol 1e-7, k_max 6 (``:176-195``);
* ``dense_flat``: ``solve_fused_adams`` with ``dense=256`` on the
  oscillator (y1, -y0) from (1, 0.5), 16 members, t in [0, 4] at rtol
  1e-5 / atol 1e-8, k_max 6 (``tests/test_fused_dense.py:298-323``, cut
  from 128 members, without ``t_eval``), its dense output at six times;
* ``dense_grid``: ``solve_fused_adams_grid`` with ``dense=256`` on the
  periodic upwind advection -(y - roll(y, 1)) 0.2 n, n = 32, 8 members
  from 1 + 0.3 sin(2 pi x), t in [0, 1] at rtol 1e-5 / atol 1e-8, k_max
  12 (``:244-267``, without ``t_eval``), its dense output at six times;

each with its four outputs and the first rows of its dense output (up to
the largest step count plus one), and the adjoints, each the value and
the gradients (y0, params) of its loss through ``solve_fused_adjoint``
with ``method=SWAG``:

* ``adj_vdp``: ``sum(y_f[:, 0])`` on Van der Pol with mu a member, 8
  members, mu in [1, 2], y0 = (2, 0), t in [0, 3] at rtol 1e-5 / atol
  1e-8, k_max 6, ``dense=512`` (``tests/test_fused_adjoint.py:270-301``),
  with the central differences (eps 1e-2) of the fused primal, from two
  launches (every member's mu up, then down);
* ``adj_heat``: ``sum(y_f * sin(2 pi x))`` through the grid route on the
  heat MoL of ``params_heat`` at 8 members, D in [0.001, 0.003],
  ``dense=512``, a grid SWAG adjoint that the JAX package's tests lack.

Run from the repository root (about 6 min)::

    PYTHONPATH=. python tests/jax_fused_adams_routes.py
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

from extensisq_tpu.methods import SWAG  # noqa: E402
from extensisq_tpu.ops import (solve_fused_adams,  # noqa: E402
                               solve_fused_adams_grid)
from extensisq_tpu.ops.fused_sens import solve_fused_adjoint  # noqa: E402

OUT = Path(__file__).resolve().parent / "jax_fused_adams_routes.npz"
FIELDS = ("ts", "t_anchor", "h", "y_anchor", "Q", "valid")
N_HEAT = 128
N_ADV = 32


def dec_p(t, y, p):
    return jnp.stack([-p[0] * y[0], -2.0 * p[0] * y[1]])


def heat_p(t, y, p):
    return p[0] * (jnp.roll(y, 1, -1) - 2 * y + jnp.roll(y, -1, -1)) \
        * float(N_HEAT * N_HEAT)


def osc(t, y):
    return jnp.stack([y[1], -y[0]])


def adv(t, y):
    return -(y - jnp.roll(y, 1, -1)) * (0.2 * N_ADV)


def vdp_p(t, y, p):
    return jnp.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]])


def inputs():
    """Each case's (y0, params), as the port's tests build them."""
    xh = np.arange(N_HEAT) / N_HEAT
    heat16 = np.tile(np.sin(2 * np.pi * xh).astype(np.float32), (16, 1))
    xa = np.arange(N_ADV)
    adv0 = np.tile((1.0 + 0.3 * np.sin(2 * np.pi * xa / N_ADV))
                   .astype(np.float32), (8, 1))
    vdp0 = np.zeros((8, 2), np.float32)
    vdp0[:, 0] = 2.0
    return {
        "params_decay": (np.ones((16, 2), np.float32),
                         np.linspace(0.5, 2.0, 16)
                         .astype(np.float32)[:, None]),
        "params_heat": (heat16, np.linspace(0.001, 0.003, 16)
                        .astype(np.float32)[:, None]),
        "dense_flat": (np.tile([1.0, 0.5], (16, 1)).astype(np.float32), None),
        "dense_grid": (adv0, None),
        "adj_vdp": (vdp0, np.linspace(1.0, 2.0, 8)
                    .astype(np.float32)[:, None]),
        "adj_heat": (heat16[:8], np.linspace(0.001, 0.003, 8)
                     .astype(np.float32)[:, None]),
    }


QUERIES = {"dense_flat": np.linspace(0.0, 4.0, 6),
           "dense_grid": np.linspace(0.0, 1.0, 6)}


def runs(out):
    flat = dict(block_members=128, interpret=True)
    grid = dict(block_members=8, interpret=True)
    calls = {
        "params_decay": lambda y0, p: solve_fused_adams(
            dec_p, (0.0, 1.0), y0, rtol=1e-4, atol=1e-7, k_max=6, params=p,
            **flat),
        "params_heat": lambda y0, p: solve_fused_adams_grid(
            heat_p, (0.0, 0.3), y0, rtol=1e-4, atol=1e-7, k_max=6, params=p,
            **grid),
        "dense_flat": lambda y0, p: solve_fused_adams(
            osc, (0.0, 4.0), y0, rtol=1e-5, atol=1e-8, k_max=6, dense=256,
            **flat),
        "dense_grid": lambda y0, p: solve_fused_adams_grid(
            adv, (0.0, 1.0), y0, rtol=1e-5, atol=1e-8, dense=256, **grid),
    }
    for name, call in calls.items():
        y0, params = inputs()[name]
        res = call(y0, params)
        out[name + "/y0"] = y0
        if params is not None:
            out[name + "/params"] = params
        for i, r in enumerate(res[:4]):
            out[f"{name}/{i}"] = np.asarray(r)
        if len(res) > 4:
            rows = int(np.asarray(res[2]).max()) + 1
            sol = res[4]
            for f in FIELDS:
                v = np.asarray(getattr(sol, f))
                out[f"{name}/{f}"] = v if f == "valid" else v[:, :rows + 1]
            out[name + "/sol"] = np.asarray(
                sol(jnp.asarray(QUERIES[name], jnp.float32)))
        print(name, "done", flush=True)


def _adjoint(out, name, fun, span, layout, loss_of, rtol, atol, bm):
    y0, params = inputs()[name]

    def loss(Y, P):
        yf = solve_fused_adjoint(fun, span, Y, P, SWAG, rtol, atol, 100_000,
                                 bm, True, 512, None, None, None, layout, 6)
        return loss_of(yf)

    val, (gy0, gp) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(y0), jnp.asarray(params))
    for key, v in (("value", val), ("y0", gy0), ("params", gp)):
        out[f"{name}/{key}"] = np.asarray(v)
    out[name + "/in_y0"] = y0
    out[name + "/in_params"] = params


def adjoints(out):
    _adjoint(out, "adj_vdp", vdp_p, (0.0, 3.0), "flat",
             lambda yf: jnp.sum(yf[:, 0]), 1e-5, 1e-8, 128)
    # each member depends on its own mu only: two launches give every
    # member's central difference
    y0, mus = inputs()["adj_vdp"]
    eps = np.float32(1e-2)
    yp, ym = (np.asarray(solve_fused_adams(
        vdp_p, (0.0, 3.0), y0, rtol=1e-5, atol=1e-8, k_max=6, params=p,
        block_members=128, interpret=True)[0]) for p in (mus + eps,
                                                         mus - eps))
    out["adj_vdp/fd"] = (yp[:, 0] - ym[:, 0]) / (2 * eps)
    print("adj_vdp done", flush=True)

    w = np.sin(2 * np.pi * np.arange(N_HEAT) / N_HEAT)
    _adjoint(out, "adj_heat", heat_p, (0.0, 0.3), "grid",
             lambda yf: jnp.sum(yf * w), 1e-4, 1e-7, 8)
    print("adj_heat done", flush=True)


def main():
    out = {}
    runs(out)
    adjoints(out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
