"""The JAX package's fused RKN kernels (B5 and B6) in interpret mode
without FMA on every case of ``tests/test_torch_fused_rkn.py`` (its
``CASES``, on its seeded inputs), written to ``tests/jax_fused_rkn.npz``:
that test file reads them from there instead of running the Pallas
kernels in a subprocess on every run.

Run from the repository root (about 1.5 min)::

    PYTHONPATH=. python tests/jax_fused_rkn.py
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
from extensisq_tpu.ops import solve_fused_rkn, solve_fused_rkn_grid  # noqa

HERE = Path(__file__).resolve().parent
OUT = HERE / "jax_fused_rkn.npz"
sys.path.insert(0, str(HERE))
import test_torch_fused_rkn as TN  # noqa: E402


def kepler(t, u, v):
    r2 = u[0] ** 2 + u[1] ** 2
    a = -1.0 / (r2 * jnp.sqrt(r2))
    return jnp.stack([a * u[0], a * u[1]])


def wave(t, u, v):
    return 400.0 * (jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1) - 2.0 * u)


PROBLEMS = {"kepler": kepler, "cubic": lambda t, u, v: u ** 3,
            "wave": wave,
            "duffing": lambda t, u, v: -u - 0.5 * u ** 3 - 0.1 * v,
            "wave_cubic": lambda t, u, v: wave(t, u, v) + u ** 3}


def main():
    out = {}
    for name, (kind, prob, meth, span, y0, kw) in TN.CASES.items():
        if kind == "flat":
            res = solve_fused_rkn(PROBLEMS[prob], tuple(span), y0,
                                  method=getattr(X, meth), block_members=128,
                                  interpret=True, **kw)
        else:
            res = solve_fused_rkn_grid(PROBLEMS[prob], tuple(span), y0,
                                       method=getattr(X, meth),
                                       block_members=8, interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        print(name, flush=True)
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
