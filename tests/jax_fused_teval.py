"""The JAX package's explicit fused kernels with in-kernel ``t_eval``
snapshots (B1, B4, B11, B12) and the CKdisc kernels with per-member
``params``, in interpret mode without FMA, written to
``tests/jax_fused_teval.npz`` with their inputs:
``tests/test_torch_fused_teval.py`` reads them from there.  The cases:

* ``b1_plain`` and ``b1_comp``: ``solve_fused_erk`` on the Van der Pol of
  ``tests/test_fused_pallas.py:259`` (mu = 5, 128 members from y0 in
  [1.9, 2.1] x 0, t in [0, 2]) at rtol 1e-4 / atol 1e-6 and, compensated,
  1e-6 / 1e-9, with eight points given unsorted, one twice, one before t0
  and one past tf;
* ``b1_back``: the oscillator (y1, -y0) over the backward span [3, 0];
* ``b1_params``: Van der Pol with mu a member (mu in [1, 2], y0 = (2, 0),
  t in [0, 3], rtol 1e-5 / atol 1e-8) with points;
* ``b1_dense``: ``b1_plain`` with ``dense=256`` beside ``t_eval``, which
  fixes the order of the outputs: y_eval fifth, the dense output sixth
  (stored evaluated at six times);
* ``b4_adv``: ``solve_fused_erk_grid`` on the periodic advection-reaction
  of ``:536`` at n = 128 (the least n the JAX kernel takes without lane
  padding, which would break the ring), 8 members, t in [0, 0.5];
* ``b11_teval``, ``b11_params`` and ``b11_both``: ``solve_fused_ckdisc`` on
  the sign-switching decay of ``:1686`` (32 members, t in [0, 5], rtol
  1e-4 / atol 1e-7) with points, with its rate 0.5 a member's parameter
  (in [0.3, 0.7], member 5 at 0.5), and with both;
* ``b12_params`` and ``b12_params_teval``: ``ops.solve_fused`` routing
  CKdisc to the grid kernel (``layout="grid"``: the size rule takes the
  flat one below n = 48) with params (``:2097``: -p y + 0.3 sw(4 t), p in
  [0.5, 2]) at n = 32, 8 members, t in [0, 2], without and with points.

Every case gives ``first_step``.  The first attempt of each member is
the JAX kernel's bit for bit (from the second, XLA's and PyTorch's float32
``pow`` part the last bits of h), so each kernel also runs one attempt
(``max_steps=1``) with points inside the first step, before t0 and past
it: ``b1_first``, ``b1_comp_first``, ``b4_first``, ``b11_first`` (with
params) and ``b12_first``.  Run from the repository root (about 1
min)::

    PYTHONPATH=. python tests/jax_fused_teval.py
"""
import os
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_cpu_max_isa=SSE4_2"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from extensisq_tpu import CKdisc  # noqa: E402
from extensisq_tpu.ops import (solve_fused, solve_fused_ckdisc,  # noqa: E402
                               solve_fused_erk, solve_fused_erk_grid)

OUT = Path(__file__).resolve().parent / "jax_fused_teval.npz"
N_ADV = 128
N_CK = 32


def sw(t, freq):
    return jnp.where(jnp.sin(freq * t) >= 0.0, 1.0, -1.0)


PROBLEMS = {
    "vdp5": lambda t, y: jnp.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1]
                                    - y[0]]),
    "osc": lambda t, y: jnp.stack([y[1], -y[0]]),
    "vdp_p": lambda t, y, p: jnp.stack([y[1], p[0] * (1 - y[0] ** 2) * y[1]
                                        - y[0]]),
    "adv": lambda t, y: (-(y - jnp.roll(y, 1, -1)) * float(N_ADV)
                         + y * (1.0 - y)),
    "decay": lambda t, y: jnp.stack([(-sw(t, 3.0) - 0.5) * y[0]]),
    "decay_p": lambda t, y, p: jnp.stack([(-sw(t, 3.0) - p[0]) * y[0]]),
    "sink_p": lambda t, y, p: -p[0] * y + 0.3 * sw(t, 4.0),
}


def inputs():
    """name -> (y0, params or None, t_eval) of each case."""
    vdp = np.stack([np.linspace(1.9, 2.1, 128), np.zeros(128)],
                   1).astype(np.float32)
    tq = np.array([1.7, 0.0, 2.5, 0.5, 1.1, -0.3, 1.1, 2.0], np.float32)
    osc = np.stack([np.linspace(0.5, 1.5, 16), np.zeros(16)],
                   1).astype(np.float32)
    mus = np.linspace(1.0, 2.0, 16).astype(np.float32)[:, None]
    vdpp = np.stack([np.full(16, 2.0), np.zeros(16)], 1).astype(np.float32)
    x = np.linspace(0, 1, N_ADV, endpoint=False)
    amps = np.linspace(0.2, 0.8, 8)
    adv = (0.5 + 0.4 * amps[:, None]
           * np.sin(2 * np.pi * x)[None, :]).astype(np.float32)
    dec = np.linspace(0.5, 1.5, 32).astype(np.float32)[:, None]
    rates = np.linspace(0.3, 0.7, 32).astype(np.float32)[:, None]
    rates[5] = 0.5
    ck_tq = np.array([4.0, 0.5, 2.0, 0.5, -1.0, 6.0, 0.0, 3.3], np.float32)
    sink = np.ones((8, N_CK), np.float32)
    sink_p = np.linspace(0.5, 2.0, 8).astype(np.float32)[:, None]
    return {
        "b1_plain": (vdp, None, tq),
        "b1_comp": (vdp, None, tq),
        "b1_back": (osc, None,
                    np.array([2.0, 3.0, 0.25, 4.0, 1.0, 2.0, -0.5],
                             np.float32)),
        "b1_params": (vdpp, mus,
                      np.array([2.5, 0.1, 3.0, 1.0, 1.0], np.float32)),
        "b1_dense": (vdp, None, tq),
        "b4_adv": (adv, None,
                   np.array([0.5, 0.0, 0.2, -0.1, 0.2, 0.7, 0.35],
                            np.float32)),
        "b11_teval": (dec, None, ck_tq),
        "b11_params": (dec, rates, None),
        "b11_both": (dec, rates, ck_tq),
        "b12_params": (sink, sink_p, None),
        "b12_params_teval": (sink, sink_p,
                             np.array([1.5, 0.25, 2.0, 0.25, 3.0, 0.0],
                                      np.float32)),
    }


# name -> (kernel, problem, span, options)
CASES = {
    "b1_plain": ("erk", "vdp5", (0.0, 2.0),
                 dict(rtol=1e-4, atol=1e-6, first_step=0.01)),
    "b1_comp": ("erk", "vdp5", (0.0, 2.0),
                dict(rtol=1e-6, atol=1e-9, first_step=0.01,
                     compensated=True)),
    "b1_back": ("erk", "osc", (3.0, 0.0),
                dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
    "b1_params": ("erk", "vdp_p", (0.0, 3.0),
                  dict(rtol=1e-5, atol=1e-8, first_step=0.01)),
    "b1_dense": ("erk", "vdp5", (0.0, 2.0),
                 dict(rtol=1e-4, atol=1e-6, first_step=0.01, dense=256)),
    "b4_adv": ("erk_grid", "adv", (0.0, 0.5),
               dict(rtol=1e-5, atol=1e-7, first_step=0.005)),
    "b11_teval": ("ckdisc", "decay", (0.0, 5.0),
                  dict(rtol=1e-4, atol=1e-7, first_step=0.01)),
    "b11_params": ("ckdisc", "decay_p", (0.0, 5.0),
                   dict(rtol=1e-4, atol=1e-7, first_step=0.01)),
    "b11_both": ("ckdisc", "decay_p", (0.0, 5.0),
                 dict(rtol=1e-4, atol=1e-7, first_step=0.01)),
    "b12_params": ("front_door", "sink_p", (0.0, 2.0),
                   dict(rtol=1e-4, atol=1e-6, first_step=0.01)),
    "b12_params_teval": ("front_door", "sink_p", (0.0, 2.0),
                         dict(rtol=1e-4, atol=1e-6, first_step=0.01)),
}
# one attempt of a case with points inside its first step: name -> (case,
# t_eval)
FIRST = {
    "b1_first": ("b1_plain", [0.005, 0.0, 0.01, 0.0025, 0.5, -0.1, 0.005]),
    "b1_comp_first": ("b1_comp", [0.005, 0.0, 0.01, 0.0025, 0.5, -0.1]),
    "b4_first": ("b4_adv", [0.003, 0.0, 0.005, 0.001, 0.4, 0.003]),
    "b11_first": ("b11_both", [0.005, 0.0, 0.01, 0.0025, 3.0, 0.005]),
    "b12_first": ("b12_params_teval", [0.005, 0.0, 0.01, 0.0025, 1.0]),
}
for _name, (_case, _tq) in FIRST.items():
    CASES[_name] = CASES[_case][:3] + (dict(CASES[_case][3], max_steps=1),)
# the times at which b1_dense's dense output is stored
DENSE_TIMES = np.linspace(0.0, 2.0, 6)


def case_inputs(name):
    """(y0, params or None, t_eval) of a case."""
    if name in FIRST:
        case, tq = FIRST[name]
        y0, params, _ = inputs()[case]
        return y0, params, np.asarray(tq, np.float32)
    return inputs()[name]


def run(name):
    kind, prob, span, kw = CASES[name]
    y0, params, tq = case_inputs(name)
    kw = dict(kw)
    if params is not None:
        kw["params"] = params
    if tq is not None:
        kw["t_eval"] = tq
    fun = PROBLEMS[prob]
    if kind == "erk":
        return solve_fused_erk(fun, span, y0, block_members=128,
                               interpret=True, **kw)
    if kind == "erk_grid":
        return solve_fused_erk_grid(fun, span, y0, block_members=8,
                                    interpret=True, **kw)
    if kind == "ckdisc":
        return solve_fused_ckdisc(fun, span, y0, block_members=128,
                                  interpret=True, **kw)
    return solve_fused(fun, span, y0, method=CKdisc, layout="grid",
                       block_members=8, interpret=True, **kw)


def main():
    out = {}
    for name in CASES:
        y0, params, tq = case_inputs(name)
        out[f"{name}/y0"] = y0
        if params is not None:
            out[f"{name}/params"] = params
        if tq is not None:
            out[f"{name}/t_eval"] = tq
        res = run(name)
        if CASES[name][3].get("dense"):
            sol = res[-1]
            res = res[:-1]
            out[f"{name}/dense"] = np.asarray(sol(jnp.asarray(DENSE_TIMES)))
            out[f"{name}/valid"] = np.asarray(sol.valid)
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        print(name, [np.asarray(r).shape for r in res], flush=True)
    out["dense_times"] = DENSE_TIMES
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
