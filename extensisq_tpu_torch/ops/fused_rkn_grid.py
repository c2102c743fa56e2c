"""Fused RKN solver for mid-size second-order systems: the whole adaptive
integration of an ensemble in one CUDA kernel launch, one thread block per
member.

Counterpart of ``extensisq_tpu/ops/fused_rkn_grid.py``, which runs B5's
loop (``_run_rkn_loop``) with each partition of the state across the 128
lanes.  On Hopper a member is one thread block of ``csrc/fused_rk_grid.cu``
(the body shared with the mid-size ERK kernel), its ``[u | v]`` state and
stage accelerations in shared memory; any n is taken without padding.  The
plain version, :func:`fused_rkn_grid_reference`, runs B5's loop
(``ops.fused_rkn.run_rkn_loop``) on the rows-first ``(2n, B)`` state; the
wrapper :func:`solve_fused_rkn_grid` takes it only for tensors on the CPU.
"""
import dataclasses
from typing import Callable

import torch

from .._device import as_input
from .fused_erk import check_options
from .fused_erk_grid import check_grid_input, launch_grid
from .fused_rkn import _state, rkn_consts, run_rkn_loop


@dataclasses.dataclass(frozen=True)
class FusedGridAcc:
    """A mid-size acceleration the fused grid RKN kernel can compile in.

    ``torch_fn(t, u, v)`` is the rows-first function on ``(n, B)`` tensors
    (``t`` is ``(B,)``), used by the plain version; shifts are
    ``torch.roll(u, s, 0)`` with ``jnp.roll``'s sign.  ``cuda_src`` defines
    the acceleration at position ``i`` of one member::

        __device__ float acc(float t, const float* u, const float* v, int i,
                             const float* p);

    with neighbours from ``tab::G::rolled<0>(u, i, shift)``, the value at
    ``i`` of ``torch.roll(u, shift, 0)`` (``csrc/grid_common.cuh``); ``p`` is
    unused until per-member parameters are ported.  ``n`` is the number of
    positions; the state is ``[u, v]`` of size 2n.
    """
    torch_fn: Callable
    cuda_src: str
    n: int


def fused_rkn_grid_reference(fun, t_span, y0_batch, method=None, rtol=1e-4,
                             atol=1e-6, first_step=None, max_steps=100_000,
                             compensated=False, max_step=None):
    """The plain PyTorch version of the mid-size RKN kernel, on the device
    of ``y0_batch`` ``(B, 2n)``: B5's loop.  ``fun`` is a
    :class:`FusedGridAcc` or a rows-first torch function ``acc(t, u, v)``.
    Returns ``(y (B, 2n), status (B,), nsteps (B,), nfev (B,))``."""
    acc = fun.torch_fn if isinstance(fun, FusedGridAcc) else fun
    return run_rkn_loop(acc, rkn_consts(method), t_span, _state(y0_batch),
                        rtol, atol, first_step, max_steps, compensated,
                        max_step)


def _kernel(method, fun):
    """The kernel built for one RKN method and FusedGridAcc."""
    if method is None:
        from ..methods import Fi5N as method
    from . import _build
    return _build.cached("fused_rkn_grid", (method, fun),
                         lambda: _build.load_fused_rk_grid(
                             rkn_consts(method), True, (fun.n,),
                             fun.cuda_src))


def solve_fused_rkn_grid(acc, t_span, y0_batch, method=None, rtol=1e-4,
                         atol=1e-6, first_step=None, max_steps=100_000,
                         compensated=False, t_eval=None, events=None,
                         max_step=None, params=None, dense=None):
    """Integrate an ensemble of mid-size second-order systems with an RKN
    pair (Fi5N by default) in one kernel launch.

    ``y0_batch``: (B, 2n) float32, ``[u, v]`` per member, any n.  Returns
    ``(y_final (B, 2n), status (B,), nsteps (B,), nfev (B,))``, status as
    :func:`solve_fused_rkn`; ``compensated=True`` is its mixed-precision
    mode.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``acc`` must be a :class:`FusedGridAcc`, and the call launches
    ``csrc/fused_rk_grid.cu`` with one block of up to 256 threads per
    member (raising when the member's rows do not fit in shared memory),
    or raises.  On a CPU tensor it runs :func:`fused_rkn_grid_reference`.

    ``t_eval``, ``events``, ``params`` and ``dense`` are not ported yet.
    """
    check_options("solve_fused_rkn_grid", "B6", t_eval=t_eval,
                  events=events, params=params, dense=dense)
    y0 = as_input(y0_batch, torch.float32)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, compensated=compensated,
              max_step=max_step)
    if y0.device.type != "cuda":
        return fused_rkn_grid_reference(acc, t_span, y0, method=method, **kw)
    n = acc.n if isinstance(acc, FusedGridAcc) else -1
    check_grid_input("solve_fused_rkn_grid", y0, 2 * n, FusedGridAcc, acc)
    return launch_grid(solve_fused_rkn_grid, _kernel(method, acc), y0, n,
                       t_span, **kw)


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_rkn_grid.launches = 0
