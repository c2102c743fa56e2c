"""The JAX package's fused SWAG kernel (B3) in interpret mode without FMA
on every case of ``tests/test_torch_fused_adams.py`` (its ``CASES``, on
its inputs), written to ``tests/jax_fused_adams.npz``: that test file
reads them from there instead of running the Pallas kernel in a
subprocess on every run.

Run from the repository root (about 3.5 min, most of it XLA compiling the
interpret-mode SWAG bodies)::

    PYTHONPATH=. python tests/jax_fused_adams.py
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

from extensisq_tpu.ops.fused_adams import solve_fused_adams  # noqa: E402

HERE = Path(__file__).resolve().parent
OUT = HERE / "jax_fused_adams.npz"
sys.path.insert(0, str(HERE))
import test_torch_fused_adams as TA  # noqa: E402

PROBLEMS = {
    "vdp5": lambda t, y: jnp.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1]
                                    - y[0]]),
    "vdp1e3": lambda t, y: jnp.stack([y[1], 1000.0 * (1 - y[0] ** 2) * y[1]
                                      - y[0]]),
    "osc": lambda t, y: jnp.stack([y[1], -y[0]]),
    "decay": lambda t, y: jnp.stack([-y[0]]),
}


def main():
    out = {}
    for name, (prob, span, y0, kw) in TA.CASES.items():
        res = solve_fused_adams(PROBLEMS[prob], tuple(span), y0,
                                block_members=128, interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        print(name, flush=True)
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
