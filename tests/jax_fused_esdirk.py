"""The JAX package's fused ESDIRK kernel on every case of
``tests/test_torch_fused_esdirk.py`` (``CASES`` and ``PARAM_CASES``), in
interpret mode without FMA, written to ``tests/jax_fused_esdirk.npz`` with
their inputs: the test reads them from there, since interpret mode takes
~1.5 min for them (the ``block_base`` case, Robertson's variational system
with nested JVPs, ~40 s of it), which the fast tier does not pay.  The
inputs are the test module's own (the pendulum's consistent start is the
port's f64 projection), so the script imports it.  The cases:

* ``rob_kv3i``, ``rob_kv3i_comp``, ``rob_trbdf2``: 128 Robertson members
  (y0[0] in [0.9, 1.1]) on t in [0, 1], Kv3I at rtol 1e-4 / atol 1e-8
  (and compensated at 1e-6 / 1e-9), TRBDF2 at 1e-4 / 1e-8;
* ``pend_dae``: 128 pendulum DAE members (M = diag(1, 1, 1, 1, 0)) from
  consistent starts, Kv3I on t in [0, 0.3] at rtol 1e-4 / atol 1e-6;
* ``kaps_hidden``: 128 Kaps DAE members behind the hidden mass matrix A
  M B^-1, TRBDF2 on t in [0, 1] at rtol 1e-4 / atol 1e-6;
* ``stiff_params``: y' = -k (y - cos t), k in [50, 500] for 128 members,
  Kv3I on t in [0, 1] at rtol 1e-4 / atol 1e-6 (the JAX package's
  ``test_fused_esdirk_params_stiff``);
* ``rob_block``: 8 Robertson members (k1 in [0.04, 0.05]) through the
  simultaneous corrector on their variational system for the three rate
  constants (``block_base=3``), TRBDF2 on t in [0, 0.4] at rtol 1e-4 /
  atol 1e-8.

Run from the repository root (about 2 min)::

    PYTHONPATH=. python tests/jax_fused_esdirk.py
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

HERE = Path(__file__).resolve().parent
OUT = HERE / "jax_fused_esdirk.npz"
sys.path.insert(0, str(HERE))
import test_torch_fused_esdirk as T  # noqa: E402


def rob(t, y):
    r1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    r3 = 3e7 * y[1] * y[1]
    return jnp.stack([r1, -r1 - r3, r3])


def pend(t, s):
    return jnp.stack([s[2], s[3], -s[4] * s[0], -s[4] * s[1] - 9.81,
                      s[2] * s[2] + s[3] * s[3]
                      - s[4] * (s[0] * s[0] + s[1] * s[1]) - 9.81 * s[1]])


def kaps_hidden(t, z):
    A, Binv = T.HID_A, T.HID_BINV
    y0 = Binv[0, 0] * z[0] + Binv[0, 1] * z[1]
    y1 = Binv[1, 0] * z[0] + Binv[1, 1] * z[1]
    f0 = -y0 + y1 * y1
    f1 = y0 - y1 - y1 * y1
    return jnp.stack([A[0, 0] * f0 + A[0, 1] * f1,
                      A[1, 0] * f0 + A[1, 1] * f1])


def rob_p(t, y, p):
    r1 = p[0] * y[0]
    r2 = p[1] * y[1] * y[2]
    r3 = p[2] * y[1] * y[1]
    return jnp.stack([-r1 + r2, r1 - r2 - r3, r3])


PROBLEMS = {"rob": rob, "pend": pend, "kaps_hidden": kaps_hidden,
            "stiff_p": lambda t, y, p: jnp.stack([-p[0] * (y[0]
                                                           - jnp.cos(t))]),
            "rob_aug": _aug_fun(rob_p, 3, 3, 0, True)}


def main():
    out = {}
    for name, (prob, meth, span, y0, yp0, M, kw) in {
            **T.CASES, **T.PARAM_CASES}.items():
        params = T.PARAMS.get(name)
        res = solve_fused_esdirk(
            PROBLEMS[prob], span, y0, method=getattr(X, meth),
            M=None if M is None else np.asarray(M), yp0_batch=yp0,
            block_members=128, interpret=True, params=params, **kw)
        out[name + "/y0"] = np.asarray(y0)
        if yp0 is not None:
            out[name + "/yp0"] = np.asarray(yp0)
        if params is not None:
            out[name + "/params"] = params
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        print(name, "done", flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
