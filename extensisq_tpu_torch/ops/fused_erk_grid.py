"""Fused ERK solver for mid-size systems: the whole adaptive integration of
an ensemble in one CUDA kernel launch, one thread block per member.

Counterpart of ``extensisq_tpu/ops/fused_erk_grid.py``.  The JAX kernel
runs B1's loop with the state across the 128 lanes and the members on
sublanes, and zero-pads n to a multiple of 128; on Hopper a member is one
thread block (``csrc/fused_rk_grid.cu``, shared with the RKN kernel of
``ops/fused_rkn_grid.py``), its rows in shared memory, and any n is taken
without padding.  The loop is B1's, so the plain version,
:func:`fused_erk_grid_reference`, runs ``fused_erk_reference``'s loop on the
rows-first ``(n, B)`` state; the wrapper :func:`solve_fused_erk_grid` takes
it only for tensors on the CPU.

Right-hand sides are :class:`~.fused_rkc.FusedGridRHS` with
``shape=(n,)``: ``torch_fn(t, y)`` on ``(n, B)``, shifts as
``torch.roll(y, s, 0)`` with ``jnp.roll``'s sign, and the CUDA ``rhs(t,
y, i, p)`` of one element.
"""
import numpy as np
import torch

from .._device import as_input
from .fused_erk import (_fused_consts, check_options, fused_erk_reference,
                        launch_args)
from .fused_rkc import FusedGridRHS

# the most threads of a block; a member of n states gets ceil(n / 32) warps
# up to this bound, one element per thread where n allows
MAX_THREADS = 256


def grid_threads(n):
    """The block size for stage rows of n elements: a multiple of 32, at
    most :data:`MAX_THREADS`."""
    return min(MAX_THREADS, 32 * -(-int(n) // 32))


def _state_size(fun):
    """n of a :class:`FusedGridRHS` of ``shape=(n,)``."""
    if len(fun.shape) != 1:
        raise ValueError("the mid-size ERK kernel takes a FusedGridRHS of "
                         f"shape (n,), got {tuple(fun.shape)}")
    return int(fun.shape[0])


def fused_erk_grid_reference(fun, t_span, y0_batch, method=None, rtol=1e-4,
                             atol=1e-6, first_step=None, max_steps=100_000,
                             compensated=False, max_step=None):
    """The plain PyTorch version of the mid-size ERK kernel, on the device
    of ``y0_batch`` ``(B, n)``: B1's loop (``fused_erk_reference``).
    ``fun`` is a :class:`FusedGridRHS` or a rows-first torch function.
    Returns ``(y (B, n), status (B,), nsteps (B,), nfev (B,))``."""
    if isinstance(fun, FusedGridRHS):
        _state_size(fun)
        fun = fun.torch_fn
    return fused_erk_reference(fun, t_span, y0_batch, method=method, rtol=rtol,
                               atol=atol, first_step=first_step,
                               max_steps=max_steps, compensated=compensated,
                               max_step=max_step)


def check_grid_input(name, y0, n_state, rhs_type, fun):
    """``y0`` must be a contiguous float32 ``(B, n_state)`` tensor."""
    if not isinstance(fun, rhs_type):
        raise TypeError(f"{name} on a CUDA tensor needs a {rhs_type.__name__}"
                        " (with the CUDA source of the right-hand side); got "
                        f"{type(fun).__name__}")
    if y0.dtype != torch.float32:
        raise TypeError(f"y0_batch must be float32, got {y0.dtype}")
    if y0.ndim != 2 or y0.shape[1] != n_state:
        raise ValueError(f"y0_batch must be (B, {n_state}), got "
                         f"{tuple(y0.shape)}")
    if not y0.is_contiguous():
        raise ValueError("y0_batch must be contiguous")


def launch_grid(wrapper, built, y0, n_row, t_span, rtol, atol, first_step,
                max_steps, compensated, max_step):
    """Launch ``csrc/fused_rk_grid.cu`` (one block per member, stage rows
    of ``n_row``) on the current stream for ``wrapper``, whose launch count
    it raises; raise before launch when a member's rows do not fit in the
    card's shared memory.  Returns ``(y, status, nsteps, nfev)``."""
    import ctypes
    name = wrapper.__name__
    nb = y0.shape[0]
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    with torch.cuda.device(y0.device):
        need, limit = ctypes.c_int(0), ctypes.c_int(0)
        rc = built.lib.fused_rk_grid_smem(ctypes.byref(need),
                                          ctypes.byref(limit))
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        if need.value > limit.value:
            raise ValueError(
                f"{name}: a member needs {need.value} bytes of shared memory "
                f"for its rows, more than the {limit.value} a thread block "
                "may have on this card; take a smaller system or "
                "solve_fused_* of the flat layout")
        if nb == 0:
            return y_out, status, nsteps, nfev
        t0, tf, rt, at, h0, use_h, mstep, msteps, comp = launch_args(
            t_span, rtol, atol, first_step, max_steps, compensated, max_step)
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        rc = built.lib.fused_rk_grid_launch(
            y0.data_ptr(), y_out.data_ptr(), status.data_ptr(),
            nsteps.data_ptr(), nfev.data_ptr(), nb, t0, tf,
            float(np.sign(np.float32(tf) - np.float32(t0))), rt, at, h0,
            use_h, mstep, msteps, comp, grid_threads(n_row), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return y_out, status, nsteps, nfev


def _kernel(method, fun):
    """The kernel built for one ERK method and FusedGridRHS."""
    if method is None:
        from ..methods import BS5 as method
    from . import _build
    return _build.cached("fused_erk_grid", (method, fun),
                         lambda: _build.load_fused_rk_grid(
                             _fused_consts(method), False, fun.shape,
                             fun.cuda_src))


def solve_fused_erk_grid(fun, t_span, y0_batch, method=None, rtol=1e-4,
                         atol=1e-6, first_step=None, max_steps=100_000,
                         compensated=False, t_eval=None, events=None,
                         max_step=None, params=None, dense=None):
    """Integrate an ensemble of mid-size systems with an explicit RK pair
    (BS5 by default) in one kernel launch.

    ``y0_batch``: (B, n) float32, any n.  Returns ``(y_final (B, n), status
    (B,), nsteps (B,), nfev (B,))``, status as :func:`solve_fused_erk`;
    ``compensated=True`` is its mixed-precision mode.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``fun`` must be a :class:`FusedGridRHS`, and the call launches
    ``csrc/fused_rk_grid.cu`` with one block of up to 256 threads per
    member (raising when the member's rows do not fit in shared memory),
    or raises.  On a CPU tensor it runs :func:`fused_erk_grid_reference`.

    ``t_eval``, ``events``, ``params`` and ``dense`` are not ported yet.
    """
    check_options("solve_fused_erk_grid", "B4", t_eval=t_eval,
                  events=events, params=params, dense=dense)
    y0 = as_input(y0_batch, torch.float32)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, compensated=compensated,
              max_step=max_step)
    if y0.device.type != "cuda":
        return fused_erk_grid_reference(fun, t_span, y0, method=method, **kw)
    n = _state_size(fun) if isinstance(fun, FusedGridRHS) else -1
    check_grid_input("solve_fused_erk_grid", y0, n, FusedGridRHS, fun)
    return launch_grid(solve_fused_erk_grid, _kernel(method, fun), y0, n,
                       t_span, **kw)


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_erk_grid.launches = 0
