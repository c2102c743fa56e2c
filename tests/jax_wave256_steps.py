"""Mean steps of the JAX package's mid-size RKN kernel on the wave of
``tests/test_fused_pallas.py:test_fused_rkn_grid_wave`` at 256 positions,
against the JAX f64 driver: the reading behind ``chip_smoke.py``'s wave
step gates.  The kernel runs in interpret mode on the CPU.

Run from the repository root (about 15 s)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_wave256_steps.py [members]
"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from extensisq_tpu import Fi5N, solve_ensemble  # noqa: E402
from extensisq_tpu.ops import solve_fused_rkn_grid  # noqa: E402

N, C2, SPAN = 256, 400.0, (0.0, 4.0)


def acc_g(t, u, v):
    return C2 * (jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1) - 2.0 * u)


def f_vec(t, y):
    u = y[:N]
    return jnp.concatenate([y[N:], C2 * (jnp.roll(u, 1) + jnp.roll(u, -1)
                                         - 2.0 * u)])


def main(members=8):
    x = np.linspace(0, 1, N, endpoint=False)
    u0 = np.linspace(0.5, 1.5, members)[:, None] * np.sin(2 * np.pi * x)
    y0 = np.concatenate([u0, np.zeros_like(u0)], 1).astype(np.float32)
    for label, tol in (("plain", dict(rtol=1e-5, atol=1e-7)),
                       ("compensated", dict(rtol=1e-6, atol=1e-9,
                                            compensated=True))):
        y, st, ns, _ = solve_fused_rkn_grid(
            acc_g, SPAN, y0, interpret=True, first_step=0.05,
            block_members=8, **tol)
        tol.pop("compensated", None)
        ref = solve_ensemble(f_vec, SPAN, jnp.asarray(y0, jnp.float64),
                             method=Fi5N, first_step=0.05, **tol)
        print(f"wave{N}x{members} {label}: status "
              f"{sorted(set(np.asarray(st).tolist()))}, mean nsteps "
              f"{np.mean(np.asarray(ns, np.float64)):.4g} against the f64 "
              f"driver's {np.mean(np.asarray(ref.nsteps, np.float64)):.4g}, "
              f"endpoint max |dy| "
              f"{np.max(np.abs(np.asarray(y) - np.asarray(ref.y))):.3e}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
