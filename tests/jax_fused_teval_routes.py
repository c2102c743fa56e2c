"""The JAX package's second-order and implicit fused kernels with in-kernel
``t_eval`` snapshots (B5, B6, B2, B7), in interpret mode without FMA,
written to ``tests/jax_fused_teval_routes.npz``:
``tests/test_torch_fused_teval_routes.py`` reads them from there.  The
cases and their seeded inputs are that test module's (``CASES`` and
``spec``), so the script imports it:

* ``b5_kepler`` and ``b5_kepler_comp``: ``solve_fused_rkn`` on the Kepler
  ensemble of ``tests/test_fused_pallas.py:135`` (64 members,
  eccentricities 0.1-0.5, one orbit) at rtol 1e-5 / atol 1e-7 and,
  compensated, 1e-7 / 1e-9, with eight points given unsorted, one twice,
  one before t0 and one past tf;
* ``b5_params``: u'' = -w^2 u with w a member's parameter (16 members, w
  in [1, 2]); ``b5_dense``: ``b5_kepler`` with ``dense=128`` beside
  ``t_eval``, which fixes the order of the outputs (y_eval fifth, the
  dense output sixth, stored evaluated at eight times);
* ``b6_wave`` and ``b6_wave_comp``: ``solve_fused_rkn_grid`` on the wave
  of ``:1368-1410`` (n = 128, 8 members, ``first_step`` 0.05);
* ``b2_rob`` and ``b2_rob_comp``: ``solve_fused_esdirk`` on Robertson
  (``:748``; 32 members), ``b2_pend`` on the pendulum DAE (M = diag(1, 1,
  1, 1, 0)), ``b2_kaps`` on the Kaps DAE behind a hidden M (its rows
  un-rotated by V after the kernel) and ``b2_params`` on y' = -k (y - cos
  t) with k a member's parameter;
* ``b7_rd`` and ``b7_rd_comp``: ``solve_fused_esdirk_grid`` on config
  4d's reaction-diffusion (``:1018``; n = 128, 8 members);
* ``b5_first``, ``b6_first``, ``b2_first`` and ``b7_first``: one attempt
  (``max_steps=1``) with points inside the first step, before t0 and past
  it.

Every case gives ``first_step``.  Run from the repository root (about 3
min)::

    PYTHONPATH=. python tests/jax_fused_teval_routes.py
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

import extensisq_tpu as X  # noqa: E402
from extensisq_tpu.ops import (solve_fused_esdirk,  # noqa: E402
                               solve_fused_esdirk_grid, solve_fused_rkn,
                               solve_fused_rkn_grid)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import test_torch_fused_teval_routes as TR  # noqa: E402

OUT = TR.FIXTURE_PATH
# the times at which b5_dense's dense output is stored
DENSE_TIMES = np.linspace(0.0, 2 * np.pi, 8)


def kepler(t, u, v):
    r2 = u[0] ** 2 + u[1] ** 2
    a = -1.0 / (r2 * jnp.sqrt(r2))
    return jnp.stack([a * u[0], a * u[1]])


def rob(t, y):
    r1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    r3 = 3e7 * y[1] * y[1]
    return jnp.stack([r1, -r1 - r3, r3])


def pend(t, s):
    return jnp.stack([s[2], s[3], -s[4] * s[0], -s[4] * s[1] - 9.81,
                      s[2] * s[2] + s[3] * s[3]
                      - s[4] * (s[0] * s[0] + s[1] * s[1]) - 9.81 * s[1]])


def kaps_hidden(t, z):
    A, Binv = TR.T.HID_A, TR.T.HID_BINV
    y0 = Binv[0, 0] * z[0] + Binv[0, 1] * z[1]
    y1 = Binv[1, 0] * z[0] + Binv[1, 1] * z[1]
    f0 = -y0 + y1 * y1
    f1 = y0 - y1 - y1 * y1
    return jnp.stack([A[0, 0] * f0 + A[0, 1] * f1,
                      A[1, 0] * f0 + A[1, 1] * f1])


N_RD = TR.TEG.N
PROBLEMS = {
    "kepler": kepler,
    "duffing": lambda t, u, v: -u - 0.5 * u ** 3 - 0.1 * v,
    "osc_p": lambda t, u, v, p: -(p[0] ** 2) * u,
    "wave": lambda t, u, v: 400.0 * (jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1)
                                     - 2.0 * u),
    "rob": rob, "pend": pend, "kaps_hidden": kaps_hidden,
    "stiff_p": lambda t, y, p: jnp.stack([-p[0] * (y[0] - jnp.cos(t))]),
    "rdiff": lambda t, y: ((jnp.roll(y, 1, -1) + jnp.roll(y, -1, -1)
                            - 2.0 * y) * float(N_RD * N_RD)
                           + y * y * (1.0 - y)),
}
SOLVERS = {"rkn": (solve_fused_rkn, 128),
           "rkn_grid": (solve_fused_rkn_grid, 8),
           "esdirk": (solve_fused_esdirk, 128),
           "esdirk_grid": (solve_fused_esdirk_grid, 8)}


def run(name):
    kind, prob, meth, span, y0, kw = TR.spec(name)
    solver, bm = SOLVERS[kind]
    if "M" in kw:
        kw["M"] = np.asarray(kw["M"])
    return solver(PROBLEMS[prob], span, y0, method=getattr(X, meth),
                  block_members=bm, interpret=True, **kw)


def main():
    out = {"dense_times": DENSE_TIMES}
    for name in TR.CASES:
        res = run(name)
        if TR.CASES[name][5].get("dense"):
            sol = res[-1]
            res = res[:-1]
            out[f"{name}/dense"] = np.asarray(sol(jnp.asarray(DENSE_TIMES)))
            out[f"{name}/valid"] = np.asarray(sol.valid)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        print(name, [np.asarray(r).shape for r in res], flush=True)
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
