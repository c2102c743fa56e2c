"""The JAX package's fused CKdisc kernels (B11 and B12) in interpret mode
without FMA on every case of ``tests/test_torch_fused_ckdisc.py`` (its
``CASES`` and the first attempts of ``FIRST``, on its seeded inputs),
written to ``tests/jax_fused_ckdisc.npz``: that test file reads them from
there instead of running the Pallas kernels in a subprocess on every run.

Run from the repository root (about 1 min)::

    PYTHONPATH=. python tests/jax_fused_ckdisc.py
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

from extensisq_tpu.ops import (solve_fused_ckdisc,  # noqa: E402
                               solve_fused_ckdisc_grid)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_ckdisc as TC  # noqa: E402

OUT = Path(__file__).resolve().parent / "jax_fused_ckdisc.npz"


def sw(t, freq):
    return jnp.where(jnp.sin(freq * t) >= 0.0, 1.0, -1.0)


def diffusion(t, y):
    left = jnp.concatenate([jnp.zeros_like(y[:, :1]), y[:, :-1]], axis=1)
    right = jnp.concatenate([y[:, 1:], jnp.zeros_like(y[:, :1])], axis=1)
    return 20.0 * (left - 2.0 * y + right) + jnp.abs(y - 0.4)


PROBLEMS = {
    "decay": lambda t, y: jnp.stack([(-sw(t, 3.0) - 0.5) * y[0]]),
    "swdec": lambda t, y: jnp.stack([(-sw(t, 3.0) - 0.5) * y[0],
                                     (sw(t, 3.0) - 0.5) * y[1]]),
    "rational": lambda t, y: jnp.stack(
        [y[1] / t, y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))]),
    "linear": lambda t, y: jnp.stack([-y[0], -0.5 * y[1] + y[0]]),
    "cubic": lambda t, y: jnp.stack([y[1], y[0] ** 3]),
    "mol": lambda t, y: (-(y - jnp.roll(y, 1, -1)) * float(TC.N_MOL)
                         + y * (1.0 - y) + 0.3 * sw(t, 4.0)),
    "diffusion": diffusion,
}


def main():
    out = {}
    for name, (kind, prob, span, y0, kw) in TC._spec().items():
        if kind == "flat":
            res = solve_fused_ckdisc(PROBLEMS[prob], tuple(span), TC.Y0[y0],
                                     block_members=128, interpret=True, **kw)
        else:
            res = solve_fused_ckdisc_grid(PROBLEMS[prob], tuple(span),
                                          TC.Y0[y0], block_members=8,
                                          interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        print(name, flush=True)
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
