"""The JAX package's SWAG and RKC kernels (B3, B8, B9, B10) with ``t_eval``
in interpret mode without FMA on every case of
``tests/test_torch_fused_teval_adams_rkc.py`` (its ``CASES``, on its
inputs), written to ``tests/jax_fused_teval_adams_rkc.npz``: that test file
reads them from there, since the interpret-mode SWAG runs take minutes.
Each case keeps its outputs in JAX's order up to ``y_eval`` (the dense
output of the ``dense`` cases is left out: the tests hold the port's own
against its rows).

Run from the repository root (about 4 min, most of it XLA compiling the
interpret-mode SWAG bodies at k_max = 4)::

    PYTHONPATH=. python tests/jax_fused_teval_adams_rkc.py
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

from extensisq_tpu.ops import (solve_fused_adams,  # noqa: E402
                               solve_fused_adams_grid)
from extensisq_tpu.ops.fused_rkc import (roll, solve_fused_rkc,  # noqa: E402
                                         solve_fused_rkc_ensemble)

HERE = Path(__file__).resolve().parent
OUT = HERE / "jax_fused_teval_adams_rkc.npz"
sys.path.insert(0, str(HERE))
import test_torch_fused_teval_adams_rkc as TS  # noqa: E402

N, D = TS.N_GRID, TS.D_HEAT
DX = 1.0 / TS.NX


def brus(t, uv, b=3.0):
    lap = (roll(uv, 1, 1) + roll(uv, -1, 1)
           + roll(uv, 1, 2) + roll(uv, -1, 2) - 4.0 * uv) / DX ** 2
    u, v = uv[0], uv[1]
    uv2 = u * u * v
    return jnp.stack([1.0 + uv2 - (b + 1.0) * u + TS.ALPHA * lap[0],
                      b * u - uv2 + TS.ALPHA * lap[1]])


# the JAX kernels' functions: the flat ones on rows (n, bm), the grid ones
# on (bm, n) with a k-tuple of (bm, 1) parameter columns, RKC's on one grid
PROBLEMS = {
    "vdp5": lambda t, y: jnp.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1]
                                    - y[0]]),
    "vdp_p": lambda t, y, p: jnp.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1]
                                        - y[0]]),
    "osc": lambda t, y: jnp.stack([y[1], -y[0]]),
    "heat": lambda t, y: (jnp.roll(y, 1, -1) + jnp.roll(y, -1, -1)
                          - 2.0 * y) * (D * N * N),
    "heat_p": lambda t, y, p: p[0] * (jnp.roll(y, 1, -1) - 2.0 * y
                                      + jnp.roll(y, -1, -1)) * float(N * N),
    "adv": lambda t, y: -(y - jnp.roll(y, 1, -1)) * (0.2 * N),
    "brus": brus,
    "brus_p": lambda t, uv, p: brus(t, uv, p[0]),
}


def main():
    out = {}
    for name in TS.CASES:
        kind, prob, span, y0, kw = TS.spec(name)
        fun = PROBLEMS[prob]
        if kind == "adams":
            res = solve_fused_adams(fun, tuple(span), y0, block_members=128,
                                    interpret=True, **kw)
        elif kind == "adams_grid":
            res = solve_fused_adams_grid(fun, tuple(span), y0,
                                         block_members=8, interpret=True,
                                         **kw)
        elif kind == "rkc":
            rho = kw.pop("rho")
            res = solve_fused_rkc(fun, tuple(span), y0, rho, interpret=True,
                                  **kw)
        else:
            rho = kw.pop("rho")
            res = solve_fused_rkc_ensemble(fun, tuple(span), y0, rho,
                                           interpret=True, **kw)
        for i in range(TS._yq_at(name) + 1):
            out[f"{name}/{i}"] = np.asarray(res[i])
        print(name, flush=True)
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
