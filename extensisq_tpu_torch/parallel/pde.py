"""Stencil right-hand sides of semi-discretized PDEs, for SSV2stab.

Counterpart of ``extensisq_tpu/parallel/pde.py``.  The flat functions are
rows-first like every right-hand side of the port: the state is ``(n,
B)`` with members on the last axis, each member's flat layout and the
arithmetic order those of the JAX functions, and the periodic shifts
``torch.roll`` with ``jnp.roll``'s sign.  The grid forms
(:func:`brusselator_2d_grid`, :func:`heat_2d_grid`) are
:class:`~extensisq_tpu_torch.ops.FusedGridRHS` objects for the fused RKC
kernels: a torch function on ``(*shape, B)`` and the same function as
CUDA source for one grid point.

The JAX module's mesh helpers (``make_mesh``, ``shard_state``) belong to
the multi-device work of ROADMAP A18 and are not ported yet.
"""
import numpy as np
import torch

from ..ops.fused_rkc import FusedGridRHS


def _lit(x):
    """A C++ float literal of ``x`` rounded to float32."""
    return f"{float(np.float32(x))!r}f"


def heat_1d_rhs(kappa=1.0, dx=None, n=None):
    """du/dt = kappa u_xx on a periodic 1-D grid; ``u`` is ``(n, B)``."""
    if dx is None:
        dx = 1.0 / n

    def rhs(t, u):
        return kappa * (torch.roll(u, 1, 0) - 2.0 * u
                        + torch.roll(u, -1, 0)) / dx**2

    return rhs


def heat_2d_rhs(kappa=1.0, shape=None, dx=None):
    """du/dt = kappa (u_xx + u_yy) on a periodic 2-D grid, flat state
    ``(ny * nx, B)``."""
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, u_flat):
        u = u_flat.reshape(ny, nx, -1)
        lap = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
               + torch.roll(u, 1, 1) + torch.roll(u, -1, 1) - 4.0 * u) / dx**2
        return (kappa * lap).reshape(ny * nx, -1)

    return rhs


def brusselator_2d_rhs(shape, A=1.0, B=3.0, alpha=0.02, dx=None):
    """2-D reaction-diffusion Brusselator on a periodic grid.

        u_t = A + u^2 v - (B+1) u + alpha lap(u)
        v_t = B u - u^2 v + alpha lap(v)

    Flat state ``[u.ravel(), v.ravel()]`` per member, ``(2 ny nx, B)``
    (BASELINE config 5).
    """
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, y):
        uv = y.reshape(2, ny, nx, -1)
        lap = (torch.roll(uv, 1, 1) + torch.roll(uv, -1, 1)
               + torch.roll(uv, 1, 2) + torch.roll(uv, -1, 2)
               - 4.0 * uv) / dx**2
        u, v = uv[0], uv[1]
        uv2 = u * u * v
        du = A + uv2 - (B + 1.0) * u + alpha * lap[0]
        dv = B * u - uv2 + alpha * lap[1]
        return torch.cat([du.reshape(ny * nx, -1), dv.reshape(ny * nx, -1)])

    return rhs


def heat_3d_rhs(shape, kappa=1.0, dx=None):
    """du/dt = kappa lap(u) on a periodic 3-D grid, flat state
    ``(nz ny nx, B)``."""
    nz, ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, y):
        u = y.reshape(nz, ny, nx, -1)
        lap = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
               + torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
               + torch.roll(u, 1, 2) + torch.roll(u, -1, 2)
               - 6.0 * u) / dx ** 2
        return (kappa * lap).reshape(nz * ny * nx, -1)

    return rhs


def brusselator_2d_rhs_interleaved(shape, A=1.0, B=3.0, alpha=0.02,
                                   dx=None):
    """The 2-D Brusselator with each grid point's (u, v) pair adjacent:
    flat state ``(ny nx 2, B)``."""
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, y):
        w = y.reshape(ny, nx, 2, -1)
        lap = (torch.roll(w, 1, 0) + torch.roll(w, -1, 0)
               + torch.roll(w, 1, 1) + torch.roll(w, -1, 1)
               - 4.0 * w) / dx ** 2
        u, v = w[:, :, 0], w[:, :, 1]
        uv2 = u * u * v
        du = A + uv2 - (B + 1.0) * u + alpha * lap[:, :, 0]
        dv = B * u - uv2 + alpha * lap[:, :, 1]
        return torch.stack([du, dv], 2).reshape(ny * nx * 2, -1)

    return rhs


def brusselator_rho_bound(shape, A=1.0, B=3.0, alpha=0.02, dx=None):
    """Cheap spectral-radius upper bound for ``rho_jac``: diffusion
    (8 alpha / dx^2) plus a reaction-term margin."""
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx
    diff = 8.0 * alpha / dx**2

    def rho(t, y):
        return diff + 2.0 + B

    return rho


# -- grid forms for the fused RKC kernels -------------------------------------

def brusselator_2d_grid(shape, A=1.0, B=3.0, alpha=0.02, dx=None):
    """The 2-D Brusselator as a :class:`FusedGridRHS` on the state grid
    ``(2, ny, nx)`` (u then v).  ``B=None`` makes B a per-member parameter,
    ``p[0]``.  The arithmetic order is that of the JAX benchmark's grid
    right-hand side (``validation/benchmarks.py``, config 5)."""
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx
    per_member = B is None

    def torch_fn(t, uv, p=None):
        b = p[0] if per_member else B
        lap = (torch.roll(uv, 1, 1) + torch.roll(uv, -1, 1)
               + torch.roll(uv, 1, 2) + torch.roll(uv, -1, 2)
               - 4.0 * uv) / dx**2
        u, v = uv[0], uv[1]
        uv2 = u * u * v
        return torch.stack([A + uv2 - (b + 1.0) * u + alpha * lap[0],
                            b * u - uv2 + alpha * lap[1]])

    m = ny * nx
    b_src = "p[0]" if per_member else _lit(B)
    b1_src = "(p[0] + 1.0f)" if per_member else _lit(B + 1.0)
    cuda_src = f"""
__device__ float rhs(float t, const float* y, int i, const float* p) {{
  using G = tab::G;
  const float lap = (G::rolled<1>(y, i, 1) + G::rolled<1>(y, i, -1) +
                     G::rolled<2>(y, i, 1) + G::rolled<2>(y, i, -1) -
                     4.0f * y[i]) / {_lit(dx**2)};
  const int k = i % {m};
  const float u = y[k];
  const float v = y[k + {m}];
  const float uv2 = u * u * v;
  if (i < {m}) return {_lit(A)} + uv2 - {b1_src} * u + {_lit(alpha)} * lap;
  return {b_src} * u - uv2 + {_lit(alpha)} * lap;
}}
"""
    return FusedGridRHS(torch_fn, cuda_src, (2, ny, nx))


def heat_2d_grid(shape, kappa=1.0, dx=None):
    """du/dt = kappa (u_xx + u_yy) on the periodic grid ``(ny, nx)`` as a
    :class:`FusedGridRHS`."""
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def torch_fn(t, u, p=None):
        lap = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
               + torch.roll(u, 1, 1) + torch.roll(u, -1, 1) - 4.0 * u) / dx**2
        return kappa * lap

    cuda_src = f"""
__device__ float rhs(float t, const float* y, int i, const float* p) {{
  using G = tab::G;
  const float lap = (G::rolled<0>(y, i, 1) + G::rolled<0>(y, i, -1) +
                     G::rolled<1>(y, i, 1) + G::rolled<1>(y, i, -1) -
                     4.0f * y[i]) / {_lit(dx**2)};
  return {_lit(kappa)} * lap;
}}
"""
    return FusedGridRHS(torch_fn, cuda_src, (ny, nx))
