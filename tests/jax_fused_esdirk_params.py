"""The JAX package's fused ESDIRK kernel on the two params cases of
``tests/test_torch_fused_esdirk.py`` (``PARAM_CASES``), in interpret mode
without FMA, written to ``tests/jax_fused_esdirk_params.npz`` with their
inputs: the test reads them from there, since interpret mode compiles the
``block_base`` case (Robertson's variational system, nested JVPs) for
~40 s of the fast tier.  The cases:

* ``stiff_params``: y' = -k (y - cos t), k in [50, 500] for 128 members,
  Kv3I on t in [0, 1] at rtol 1e-4 / atol 1e-6 (the JAX package's
  ``test_fused_esdirk_params_stiff``);
* ``rob_block``: 8 Robertson members (k1 in [0.04, 0.05]) through the
  simultaneous corrector on their variational system for the three rate
  constants (``block_base=3``), TRBDF2 on t in [0, 0.4] at rtol 1e-4 /
  atol 1e-8.

Run from the repository root (about 1 min)::

    PYTHONPATH=. python tests/jax_fused_esdirk_params.py
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
from extensisq_tpu.ops.fused_esdirk import solve_fused_esdirk  # noqa: E402
from extensisq_tpu.ops.fused_sens import _aug_fun  # noqa: E402

OUT = Path(__file__).resolve().parent / "jax_fused_esdirk_params.npz"
B = 128


def rob_p(t, y, p):
    r1 = p[0] * y[0]
    r2 = p[1] * y[1] * y[2]
    r3 = p[2] * y[1] * y[1]
    return jnp.stack([-r1 + r2, r1 - r2 - r3, r3])


def inputs():
    """The cases' (y0, params), as the test builds them."""
    prob = np.tile([0.04, 1e4, 3e7], (8, 1)).astype(np.float32)
    prob[:, 0] = np.linspace(0.04, 0.05, 8)
    roba0 = np.concatenate([np.tile(np.array([1.0, 0.0, 0.0], np.float32),
                                    (8, 1)), np.zeros((8, 9), np.float32)],
                           1)
    return {"stiff_params": (np.zeros((B, 1), np.float32),
                             np.linspace(50.0, 500.0, B).astype(
                                 np.float32)[:, None]),
            "rob_block": (roba0, prob)}


def main():
    runs = {
        "stiff_params": (lambda t, y, p: jnp.stack(
            [-p[0] * (y[0] - jnp.cos(t))]), X.Kv3I, (0.0, 1.0),
            dict(rtol=1e-4, atol=1e-6)),
        "rob_block": (_aug_fun(rob_p, 3, 3, 0, True), X.TRBDF2, (0.0, 0.4),
                      dict(rtol=1e-4, atol=1e-8, block_base=3)),
    }
    out = {}
    for name, (y0, params) in inputs().items():
        fun, method, span, kw = runs[name]
        res = solve_fused_esdirk(fun, span, y0, method=method,
                                 block_members=128, interpret=True,
                                 params=params, **kw)
        out[name + "/y0"] = y0
        out[name + "/params"] = params
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
