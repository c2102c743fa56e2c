"""The JAX package's mid-size fused ESDIRK kernel on every case of
``tests/test_torch_fused_esdirk_grid.py`` (``CASES`` and the first
attempts of ``FIRST``), in interpret mode without FMA, written to
``tests/jax_fused_esdirk_grid.npz`` with their inputs: the test reads them
from there, since interpret mode takes ~1.5 min for them, which the fast
tier does not pay.  The inputs and options are the test module's own, so
the script imports it.  The cases: config 4d's periodic reaction-diffusion
at n = 128 (8 members, t in [0, 0.1]) with Kv3I and TRBDF2 at rtol 1e-4 /
atol 1e-6, from a first step with a step cap, and compensated at rtol
1e-6 / atol 1e-9 on [0, 0.02]; a lane-interleaved DAE (a diagonal M with
zeros on the odd rows) at n = 128 with Kv3I; and a central advection with
zero boundaries at n = 32 backward in time with TRBDF2, which the JAX
kernel pads to 128 inert lanes.

Run from the repository root (about 2 min)::

    PYTHONPATH=. python tests/jax_fused_esdirk_grid.py
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

from extensisq_tpu import Kv3I, TRBDF2  # noqa: E402
from extensisq_tpu.ops import solve_fused_esdirk_grid  # noqa: E402

HERE = Path(__file__).resolve().parent
OUT = HERE / "jax_fused_esdirk_grid.npz"
sys.path.insert(0, str(HERE))
import test_torch_fused_esdirk_grid as T  # noqa: E402


def dae(t, y):
    mask = (jax.lax.broadcasted_iota(jnp.int32, y.shape, 1)
            % 2 == 0).astype(jnp.float32)
    return mask * (-y) + (1.0 - mask) * (jnp.roll(y, 1, -1) - y)


def shift(y, s):
    z = jnp.zeros_like(y[:, :1])
    return (jnp.concatenate([z, y[:, :-1]], axis=1) if s > 0
            else jnp.concatenate([y[:, 1:], z], axis=1))


PROBLEMS = {
    "rdiff": lambda t, y: ((jnp.roll(y, 1, -1) + jnp.roll(y, -1, -1)
                            - 2.0 * y) * float(T.N * T.N)
                           + y * y * (1.0 - y)),
    "dae": dae,
    "skew": lambda t, y: -(shift(y, -1) - shift(y, 1)) * (0.5 * T.N_SMALL),
}
METHODS = {"Kv3I": Kv3I, "TRBDF2": TRBDF2}


def main():
    out = {f"y0/{k}": v for k, v in T.Y0.items()}
    out["M_DAE"] = T.M_DAE
    for name, (prob, meth, span, y0, kw) in T._spec().items():
        kw = dict(kw)
        if "M" in kw:
            kw["M"] = T.M_DAE
            kw["yp0_batch"] = T.Y0[kw.pop("yp0")]
        res = solve_fused_esdirk_grid(PROBLEMS[prob], tuple(span), T.Y0[y0],
                                      method=METHODS[meth], block_members=8,
                                      interpret=True, **kw)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        print(name, "done", flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
