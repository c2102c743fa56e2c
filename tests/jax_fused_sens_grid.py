"""The JAX package's grid-layout fused sensitivities and its mid-size
kernels with per-member ``params``, in interpret mode without FMA, written
to ``tests/jax_fused_sens_grid.npz`` with their inputs: the port's tests
(``tests/test_torch_fused_sens.py``, ``test_torch_fused_erk_grid.py`` and
``test_torch_fused_esdirk_grid.py``) read them from there, since interpret
mode takes minutes for the ESDIRK sensitivities.  The cases, 8 members
each, on JAX's grid convention (``fun(t, y, p)`` with y ``(bm, n)`` and p a
k-tuple of ``(bm, 1)`` columns):

* ``sens_decay``: ``solve_fused_sens(layout="grid")`` on the elementwise
  decay y' = -a y, n = 32, a in [0.5, 1.5], y0 in [1, 2] along the state,
  BS5 on t in [0, 1] at rtol 1e-6 / atol 1e-9 (the JAX package's
  ``test_fused_sens_grid_layout_analytic``);
* ``sens_fisher``: the same on the periodic upwind Fisher MoL,
  ``-(y - roll(y, 1)) n + r y (1 - y)``, n = 64, r in [0.8, 1.2], y0 =
  0.5 + 0.3 sin(2 pi x), t in [0, 0.25] at rtol 1e-5 / atol 1e-8
  (``test_fused_sens_grid_layout_fisher_fd``);
* ``sens_rd``: the same on the edge-replicated reaction-diffusion
  ``(left - 2 y + right) D - k (y - 1)``, n = 64, k in [5, 30], D = 200
  (two parameters: three blocks), y0 = 1 + 0.5 sin(pi x), TRBDF2 through
  the simultaneous corrector (``block_base=n``) on t in [0, 0.04] at rtol
  1e-5 / atol 1e-8 (``test_fused_sens_grid_esdirk_mol_sweep``);
* ``erk_params``: ``solve_fused_erk_grid`` on the Fisher MoL with r as
  ``params``, first_step 0.005, otherwise as ``sens_fisher``;
* ``esdirk_params``: ``solve_fused_esdirk_grid`` on the reaction-diffusion
  with (k, D) as ``params``, Kv3I, otherwise as ``sens_rd``;

and ``sens_rd_f64``, the f64 ``sensitivity.sens_forward`` (TRBDF2, rtol
1e-9 / atol 1e-12) of members 0 and 7 of ``sens_rd``, the reference the
JAX test holds the fused sensitivities to.

Run from the repository root (about 1 min)::

    PYTHONPATH=. python tests/jax_fused_sens_grid.py
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

import extensisq_tpu as X  # noqa: E402
from extensisq_tpu import sensitivity  # noqa: E402
from extensisq_tpu.ops import (solve_fused_erk_grid,  # noqa: E402
                               solve_fused_esdirk_grid)
from extensisq_tpu.ops.fused_sens import solve_fused_sens  # noqa: E402

OUT = Path(__file__).resolve().parent / "jax_fused_sens_grid.npz"
B = 8
N_DECAY = 32
N = 64


def decay(t, y, p):
    return -p[0] * y


def fisher(t, y, p):
    return -(y - jnp.roll(y, 1, -1)) * float(N) + p[0] * y * (1.0 - y)


def rd(t, y, p):
    left = jnp.concatenate([y[:, :1], y[:, :-1]], axis=1)
    right = jnp.concatenate([y[:, 1:], y[:, -1:]], axis=1)
    return (left - 2.0 * y + right) * p[1] - p[0] * (y - 1.0)


def rd_1(t, y, k, D):
    """One member of ``rd`` in f64, for ``sens_forward``."""
    left = jnp.concatenate([y[:1], y[:-1]])
    right = jnp.concatenate([y[1:], y[-1:]])
    return (left - 2.0 * y + right) * D - k * (y - 1.0)


def inputs():
    """Each case's (y0, params), as the port's tests build them."""
    rates = np.linspace(0.5, 1.5, B).astype(np.float32)[:, None]
    dec0 = np.tile(np.linspace(1.0, 2.0, N_DECAY, dtype=np.float32), (B, 1))
    x = np.linspace(0, 1, N, endpoint=False)
    fis0 = np.tile((0.5 + 0.3 * np.sin(2 * np.pi * x)).astype(np.float32),
                   (B, 1))
    r = np.linspace(0.8, 1.2, B).astype(np.float32)[:, None]
    xr = np.linspace(0, 1, N)
    rd0 = np.tile((1.0 + 0.5 * np.sin(np.pi * xr)).astype(np.float32),
                  (B, 1))
    kd = np.stack([np.linspace(5.0, 30.0, B).astype(np.float32),
                   np.full(B, 200.0, np.float32)], axis=1)
    return {"sens_decay": (dec0, rates), "sens_fisher": (fis0, r),
            "sens_rd": (rd0, kd), "erk_params": (fis0, r),
            "esdirk_params": (rd0, kd)}


def main():
    sens = dict(block_members=8, interpret=True, layout="grid")
    grid = dict(block_members=8, interpret=True)
    runs = {
        "sens_decay": lambda y0, p: solve_fused_sens(
            decay, (0.0, 1.0), y0, params=p, rtol=1e-6, atol=1e-9, **sens),
        "sens_fisher": lambda y0, p: solve_fused_sens(
            fisher, (0.0, 0.25), y0, params=p, rtol=1e-5, atol=1e-8,
            **sens),
        "sens_rd": lambda y0, p: solve_fused_sens(
            rd, (0.0, 0.04), y0, params=p, method=X.TRBDF2, rtol=1e-5,
            atol=1e-8, **sens),
        "erk_params": lambda y0, p: solve_fused_erk_grid(
            fisher, (0.0, 0.25), y0, params=p, rtol=1e-5, atol=1e-8,
            first_step=0.005, **grid),
        "esdirk_params": lambda y0, p: solve_fused_esdirk_grid(
            rd, (0.0, 0.04), y0, params=p, method=X.Kv3I, rtol=1e-5,
            atol=1e-8, **grid),
    }
    out = {}
    y0, params = inputs()["sens_rd"]
    for b in (0, B - 1):
        ref = sensitivity.sens_forward(
            rd_1, (0.0, 0.04), np.asarray(y0[b], np.float64),
            p=(float(params[b, 0]), float(params[b, 1])), rtol=1e-9,
            atol=1e-12, method=X.TRBDF2)
        out[f"sens_rd_f64/{b}/yf"] = np.asarray(ref.yf)
        out[f"sens_rd_f64/{b}/sensf"] = np.asarray(ref.sensf)
    for name, (y0, params) in inputs().items():
        res = runs[name](y0, params)
        out[name + "/y0"] = y0
        out[name + "/params"] = params
        for i, r in enumerate(res):
            if r is not None:
                out[f"{name}/{i}"] = np.asarray(r)
        print(name, "done", flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
