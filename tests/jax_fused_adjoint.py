"""The JAX package's dense records of its explicit fused kernels and its
continuous adjoint through them, in interpret mode without FMA, written to
``tests/jax_fused_adjoint.npz`` with their inputs: the port's tests
(``tests/test_torch_fused_dense.py`` and ``test_torch_fused_adjoint.py``)
read them from there, since the interpret-mode adjoints take minutes.
The cases:

* ``erk_plain``, ``erk_comp``: ``solve_fused_erk`` with ``dense=512`` on
  Van der Pol with a per-member mu (16 members, mu in [1, 2], y0 = (2,
  0)), BS5 on t in [0, 3], ``first_step`` 0.01, plain at rtol 1e-5 / atol
  1e-8 and compensated at 1e-6 / 1e-9; ``erk_overflow``: the plain case
  at ``dense=10``;
* ``grid_fisher``: ``solve_fused_erk_grid`` with ``dense=400`` on the
  periodic upwind Fisher MoL, ``-(y - roll(y, 1)) n + r y (1 - y)``, n =
  64, 8 members, r in [0.8, 1.2], y0 = 0.5 + 0.3 sin(2 pi x), t in [0,
  0.25] at rtol 1e-5 / atol 1e-8, ``first_step`` 0.005;

each with its four outputs and the first rows of its dense output (up to
the largest step count plus one; the rest is the inert tail), and

* ``adj_vdp``: the value and the gradients (t0, tf, y0, mu) of
  ``sum(y_f[:, 0])`` through ``solve_fused_adjoint`` (``dense=512``) and
  through ``solve_fused_final`` on 8 members of the Van der Pol sweep
  (``tests/test_fused_adjoint.py:32-66``);
* ``adj_fisher``: the gradients (y0, r) of ``sum(mean(y_f))`` through
  ``solve_fused_adjoint(layout="grid")`` on the diffusive Fisher MoL,
  ``(roll(y, 1) - 2 y + roll(y, -1)) D + r y (1 - y)``, n = 128, D = 0.02
  n^2, 8 members, r in [0.8, 1.6], t in [0, 0.25] at rtol 1e-5 / atol
  1e-8, ``dense=400``; member 0's dL/dy0 from the f64
  ``sensitivity.solve_final`` at rtol 1e-9 / atol 1e-12; and the central
  differences (eps 2e-3) of ``solve_fused_erk_grid`` with params at rtol
  1e-7 / atol 1e-10 (``tests/test_fused_adjoint.py:84-139``).

Run from the repository root (about 4 min)::

    PYTHONPATH=. python tests/jax_fused_adjoint.py
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
from extensisq_tpu.ops import (solve_fused_erk,  # noqa: E402
                               solve_fused_erk_grid)
from extensisq_tpu.ops.fused_sens import (solve_fused_adjoint,  # noqa: E402
                                          solve_fused_final)

OUT = Path(__file__).resolve().parent / "jax_fused_adjoint.npz"
B_ERK = 16
B = 8
N_FIS = 64
N_ADJ = 128
D_ADJ = 0.02 * N_ADJ * N_ADJ
FIELDS = ("ts", "t_anchor", "h", "y_anchor", "Q", "valid")


def vdp(t, y, p):
    return jnp.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0]])


def fisher(t, y, p):
    return (-(y - jnp.roll(y, 1, -1)) * float(N_FIS)
            + p[0] * y * (1.0 - y))


def fisher_diff(t, y, p):
    return ((jnp.roll(y, 1, -1) - 2.0 * y + jnp.roll(y, -1, -1)) * D_ADJ
            + p[0] * y * (1.0 - y))


def fisher_diff_1(t, y, p):
    """One member of ``fisher_diff`` in f64, for ``solve_final``."""
    return ((jnp.roll(y, 1) - 2.0 * y + jnp.roll(y, -1)) * D_ADJ
            + p * y * (1.0 - y))


def inputs():
    """Each case's (y0, params), as the port's tests build them."""
    vdp0 = np.stack([np.full(B_ERK, 2.0), np.zeros(B_ERK)],
                    axis=1).astype(np.float32)
    mus = np.linspace(1.0, 2.0, B_ERK).astype(np.float32)[:, None]
    x = np.linspace(0, 1, N_FIS, endpoint=False)
    fis0 = np.tile((0.5 + 0.3 * np.sin(2 * np.pi * x)).astype(np.float32),
                   (B, 1))
    r = np.linspace(0.8, 1.2, B).astype(np.float32)[:, None]
    adj0 = np.zeros((B, 2), np.float32)
    adj0[:, 0] = 2.0
    adj_mu = np.linspace(1.0, 2.0, B).astype(np.float32)[:, None]
    xa = np.linspace(0, 1, N_ADJ, endpoint=False)
    fisa0 = np.tile((0.5 + 0.3 * np.sin(2 * np.pi * xa)).astype(np.float32),
                    (B, 1))
    rates = np.linspace(0.8, 1.6, B).astype(np.float32)[:, None]
    return {"erk_plain": (vdp0, mus), "erk_comp": (vdp0, mus),
            "erk_overflow": (vdp0, mus), "grid_fisher": (fis0, r),
            "adj_vdp": (adj0, adj_mu), "adj_fisher": (fisa0, rates)}


def records(out):
    """The dense runs: each case's outputs and its dense output's first
    rows."""
    erk = dict(block_members=128, interpret=True, first_step=0.01)
    runs = {
        "erk_plain": lambda y0, p: solve_fused_erk(
            vdp, (0.0, 3.0), y0, params=p, rtol=1e-5, atol=1e-8, dense=512,
            **erk),
        "erk_comp": lambda y0, p: solve_fused_erk(
            vdp, (0.0, 3.0), y0, params=p, rtol=1e-6, atol=1e-9,
            compensated=True, dense=512, **erk),
        "erk_overflow": lambda y0, p: solve_fused_erk(
            vdp, (0.0, 3.0), y0, params=p, rtol=1e-5, atol=1e-8, dense=10,
            **erk),
        "grid_fisher": lambda y0, p: solve_fused_erk_grid(
            fisher, (0.0, 0.25), y0, params=p, rtol=1e-5, atol=1e-8,
            first_step=0.005, block_members=8, interpret=True, dense=400),
    }
    for name, run in runs.items():
        y0, params = inputs()[name]
        res = run(y0, params)
        out[name + "/y0"] = y0
        out[name + "/params"] = params
        for i, r in enumerate(res[:4]):
            out[f"{name}/{i}"] = np.asarray(r)
        rows = int(np.asarray(res[2]).max()) + 1
        sol = res[4]
        for f in FIELDS:
            v = np.asarray(getattr(sol, f))
            out[f"{name}/{f}"] = v if f == "valid" else v[:, :rows + 1]
        print(name, "done", flush=True)


def adjoint_vdp(out):
    y0, mus = inputs()["adj_vdp"]

    def loss(solver, *extra):
        def f(tsp, Y, P):
            return jnp.sum(solver(vdp, tsp, Y, P, None, 1e-5, 1e-8, 100_000,
                                  128, True, *extra)[:, 0])
        return jax.value_and_grad(f, argnums=(0, 1, 2))(
            (0.0, 3.0), jnp.asarray(y0), jnp.asarray(mus))

    for name, solver, extra in (("adjoint", solve_fused_adjoint, (512,)),
                                ("final", solve_fused_final, (False,))):
        val, ((gt0, gtf), gy0, gp) = loss(solver, *extra)
        out[f"adj_vdp/{name}/value"] = np.asarray(val)
        out[f"adj_vdp/{name}/t0"] = np.asarray(gt0)
        out[f"adj_vdp/{name}/tf"] = np.asarray(gtf)
        out[f"adj_vdp/{name}/y0"] = np.asarray(gy0)
        out[f"adj_vdp/{name}/params"] = np.asarray(gp)
    out["adj_vdp/in_y0"] = y0
    out["adj_vdp/in_params"] = mus
    print("adj_vdp done", flush=True)


def adjoint_fisher(out):
    y0, rates = inputs()["adj_fisher"]

    def loss(Y, P):
        yf = solve_fused_adjoint(fisher_diff, (0.0, 0.25), Y, P, None, 1e-5,
                                 1e-8, 100_000, 8, True, 400, None, None,
                                 None, "grid")
        return jnp.sum(jnp.mean(yf, axis=1))

    gy0, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y0),
                                             jnp.asarray(rates))
    out["adj_fisher/y0"] = np.asarray(gy0)
    out["adj_fisher/params"] = np.asarray(gp)
    r0 = float(rates[0, 0])
    gref = jax.grad(lambda v: jnp.mean(sensitivity.solve_final(
        fisher_diff_1, (0.0, 0.25), v, r0, None, 1e-9, 1e-12, 100_000)))(
            jnp.asarray(y0[0], jnp.float64))
    out["adj_fisher/gref0"] = np.asarray(gref)
    eps = np.float32(2e-3)
    kw = dict(rtol=1e-7, atol=1e-10, block_members=8, interpret=True)
    yp = solve_fused_erk_grid(fisher_diff, (0.0, 0.25), y0,
                              params=rates + eps, **kw)[0]
    ym = solve_fused_erk_grid(fisher_diff, (0.0, 0.25), y0,
                              params=rates - eps, **kw)[0]
    out["adj_fisher/fd"] = ((np.asarray(yp).mean(1) - np.asarray(ym).mean(1))
                            / (2 * eps))
    out["adj_fisher/in_y0"] = y0
    out["adj_fisher/in_params"] = rates
    print("adj_fisher done", flush=True)


def main():
    out = {}
    records(out)
    adjoint_vdp(out)
    adjoint_fisher(out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
