"""The port's PDE right-hand sides (``parallel/pde.py``) and double-single
arithmetic (``ops/ds.py``) against the JAX package's.

The JAX side runs in one subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=
SSE4_2`` (no FMA, as PyTorch's CPU operations): the right-hand sides on
seeded float64 states, one member at a time, agree with the port's
rows-first batch to 1e-14; the double-single functions on seeded float32
arrays agree bit for bit.  The grid forms for the fused kernels are held
against the flat functions.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from extensisq_tpu_torch import parallel
from extensisq_tpu_torch.ops import ds as D

REPO = Path(__file__).resolve().parents[1]
B = 3
# name -> (factory, args, kwargs, state size)
PDES = {
    "heat_1d": ("heat_1d_rhs", [], dict(kappa=0.7, n=32), 32),
    "heat_2d": ("heat_2d_rhs", [], dict(kappa=1.3, shape=[8, 16]), 128),
    "brusselator_2d": ("brusselator_2d_rhs", [[8, 16]],
                       dict(A=1.0, B=3.2, alpha=0.02), 256),
    "heat_3d": ("heat_3d_rhs", [[4, 6, 8]], dict(kappa=0.5), 192),
    "brusselator_interleaved": ("brusselator_2d_rhs_interleaved", [[8, 16]],
                                dict(B=2.9, alpha=0.03), 256),
}
DS_UNARY = ["split", "ds_collapse", "ds_neg"]
DS_BINARY = ["two_sum", "two_prod", "ds_add", "ds_add_f", "ds_mul",
             "ds_mul_f", "ds_div"]

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from extensisq_tpu.parallel import pde
    from extensisq_tpu.ops import ds as D

    inputs = np.load(sys.argv[1])
    spec = json.loads(sys.argv[2])
    out = {}
    for name, (factory, args, kw, n) in spec["pdes"].items():
        args = [tuple(a) if isinstance(a, list) else a for a in args]
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in kw.items()}
        fun = getattr(pde, factory)(*args, **kw)
        y = inputs[name]
        out[name] = np.stack([np.asarray(fun(0.0, jnp.asarray(r)))
                              for r in y])
    out["rho"] = np.asarray(pde.brusselator_rho_bound((8, 16), B=3.2)(
        0.0, jnp.zeros(256)))
    a_hi, a_lo, b_hi, b_lo = (jnp.asarray(inputs["ds/" + k], jnp.float32)
                              for k in ("a_hi", "a_lo", "b_hi", "b_lo"))
    A, Bv = (a_hi, a_lo), (b_hi, b_lo)
    res = {
        "split": D.split(a_hi), "ds_collapse": D.ds_collapse(A),
        "ds_neg": D.ds_neg(A), "two_sum": D.two_sum(a_hi, b_hi),
        "two_prod": D.two_prod(a_hi, b_hi), "ds_add": D.ds_add(A, Bv),
        "ds_add_f": D.ds_add_f(A, b_hi), "ds_mul": D.ds_mul(A, Bv),
        "ds_mul_f": D.ds_mul_f(A, b_hi), "ds_div": D.ds_div(A, Bv),
    }
    for k, v in res.items():
        v = v if isinstance(v, tuple) else (v,)
        for i, x in enumerate(v):
            out[f"ds/{k}/{i}"] = np.asarray(x)
    np.savez(sys.argv[3], **out)
""")


def _inputs():
    rng = np.random.default_rng(12)
    states = {name: rng.uniform(0.5, 3.5, (B, n))
              for name, (_, _, _, n) in PDES.items()}
    hi = lambda: rng.standard_normal(64) * np.exp(    # noqa: E731
        rng.uniform(-8, 8, 64))
    a_hi = hi().astype(np.float32)
    b_hi = hi().astype(np.float32)
    # the lo parts below half an ulp of their hi parts
    a_lo = (a_hi * rng.uniform(-2.0 ** -25, 2.0 ** -25, 64)).astype(
        np.float32)
    b_lo = (b_hi * rng.uniform(-2.0 ** -25, 2.0 ** -25, 64)).astype(
        np.float32)
    return states, {"a_hi": a_hi, "a_lo": a_lo, "b_hi": b_hi, "b_lo": b_lo}


STATES, DS_IN = _inputs()


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_pde")
    np.savez(d / "in.npz", **STATES,
             **{"ds/" + k: v for k, v in DS_IN.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                    json.dumps({"pdes": PDES}), str(d / "out.npz")],
                   cwd=REPO, env=env, check=True, timeout=300)
    return dict(np.load(d / "out.npz"))


def _port_fun(name):
    factory, args, kw, _ = PDES[name]
    args = [tuple(a) if isinstance(a, list) else a for a in args]
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    return getattr(parallel, factory)(*args, **kw)


@pytest.mark.parametrize("name", list(PDES))
def test_rhs_matches_jax(jax_results, name):
    """Rows-first on (n, B): every member's column equals the JAX function
    on that member, in float64, within 1e-14 (relative to max(1, |dy|))."""
    y = torch.tensor(STATES[name].T.copy())
    dy = _port_fun(name)(torch.zeros(B, dtype=torch.float64), y).numpy().T
    ref = jax_results[name]
    assert dy.shape == ref.shape
    assert np.max(np.abs(dy - ref) / np.maximum(1.0, np.abs(ref))) <= 1e-14


def test_rho_bound_matches_jax(jax_results):
    rho = parallel.brusselator_rho_bound((8, 16), B=3.2)(None, None)
    assert rho == float(jax_results["rho"])


@pytest.mark.parametrize("name", DS_UNARY + DS_BINARY)
def test_double_single_bit_identical(jax_results, name):
    a_hi, a_lo, b_hi, b_lo = (torch.tensor(DS_IN[k]) for k in
                              ("a_hi", "a_lo", "b_hi", "b_lo"))
    A, Bv = (a_hi, a_lo), (b_hi, b_lo)
    res = {"split": lambda: D.split(a_hi), "ds_collapse": lambda:
           D.ds_collapse(A), "ds_neg": lambda: D.ds_neg(A),
           "two_sum": lambda: D.two_sum(a_hi, b_hi),
           "two_prod": lambda: D.two_prod(a_hi, b_hi),
           "ds_add": lambda: D.ds_add(A, Bv),
           "ds_add_f": lambda: D.ds_add_f(A, b_hi),
           "ds_mul": lambda: D.ds_mul(A, Bv),
           "ds_mul_f": lambda: D.ds_mul_f(A, b_hi),
           "ds_div": lambda: D.ds_div(A, Bv)}[name]()
    res = res if isinstance(res, tuple) else (res,)
    for i, x in enumerate(res):
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(),
                                      jax_results[f"ds/{name}/{i}"])


def test_two_prod_and_two_sum_are_exact():
    """The error-free transformations: s + e and p + e are a + b and a * b
    exactly (checked in float64)."""
    a, b = torch.tensor(DS_IN["a_hi"]), torch.tensor(DS_IN["b_hi"])
    s, e = D.two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    p, e = D.two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())


@pytest.mark.parametrize("grid,flat,shape", [
    ("brusselator_2d_grid", "brusselator_2d_rhs", (8, 16)),
    ("heat_2d_grid", "heat_2d_rhs", (8, 16))])
def test_grid_forms_match_flat_functions(grid, flat, shape):
    """A FusedGridRHS on (*grid, B) against the flat rows-first function on
    the same states, float32, bit for bit; the per-member B of the
    Brusselator's grid form against the fixed-B one."""
    g = getattr(parallel, grid)(shape)
    kw = {"shape": shape} if flat == "heat_2d_rhs" else {}
    f = getattr(parallel, flat)(*(() if kw else (shape,)), **kw)
    n = int(np.prod(g.shape))
    y = torch.tensor(STATES["brusselator_2d"][:, :n].T.copy(),
                     dtype=torch.float32)
    t = torch.zeros(B)
    dg = g.torch_fn(t, y.reshape(*g.shape, B)).reshape(n, B)
    assert torch.equal(dg, f(t, y))
    if grid == "brusselator_2d_grid":
        gp = parallel.brusselator_2d_grid(shape, B=None)
        p = torch.full((1, B), 3.0)
        assert torch.equal(gp.torch_fn(t, y.reshape(*g.shape, B), p)
                           .reshape(n, B), f(t, y))
        assert "p[0]" in gp.cuda_src and "p[0]" not in g.cuda_src
