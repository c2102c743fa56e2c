"""Fused RKN solver for mid-size second-order systems: the whole adaptive
integration of an ensemble in one CUDA kernel launch, one thread block or
one warp per member (:func:`_launch_shape`).

Counterpart of ``extensisq_tpu/ops/fused_rkn_grid.py``, which runs B5's
loop (``_run_rkn_loop``) with each partition of the state across the 128
lanes.  On Hopper a member is one thread block or one warp of
``csrc/fused_rk_grid.cu`` (the body shared with the mid-size ERK kernel),
its ``[u | v]`` state and stage accelerations in shared memory; any n is
taken without padding.  The
plain version, :func:`fused_rkn_grid_reference`, runs B5's loop
(``ops.fused_rkn.run_rkn_loop``) on the rows-first ``(2n, B)`` state; the
wrapper :func:`solve_fused_rkn_grid` takes it only for tensors on the CPU.
``params`` (B, k) gives every member its own k parameters, which the
kernel loads once into the member's shared memory, and ``dense=R``
records each member's accepted steps ``(t, [u, v], [v, a])`` for a
continuous dense output (``ops/fused_dense.py``), and ``t_eval`` returns
each member's ``[u, v]`` at the given times (``csrc/snapshot.cuh``), as on
B5.
"""
import dataclasses
from typing import Callable

import torch

from .._device import as_input
from .fused_erk import check_options, dense_rows, eval_points, member_params
from .fused_erk_grid import (check_grid_input, grid_launch_shape,
                             launch_by_rule)
from .fused_rkn import _state, bind_acc, rkn_consts, run_rkn_loop


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
    ``i`` of ``torch.roll(u, shift, 0)`` (``csrc/grid_common.cuh``).  ``n``
    is the number of positions; the state is ``[u, v]`` of size 2n.  With
    ``k > 0`` per-member parameters (``params``), ``torch_fn(t, u, v, p)``
    gets ``p`` of shape ``(k, B)`` (``p[j]`` one parameter across the
    members; JAX's grid functions get a k-tuple of ``(bm, 1)`` columns),
    and the CUDA ``p`` points at the member's k floats in its shared
    memory; with k = 0 it is a null pointer.
    """
    torch_fn: Callable
    cuda_src: str
    n: int
    k: int = 0


def fused_rkn_grid_reference(fun, t_span, y0_batch, method=None, rtol=1e-4,
                             atol=1e-6, first_step=None, max_steps=100_000,
                             compensated=False, max_step=None, params=None,
                             dense=None, t_eval=None):
    """The plain PyTorch version of the mid-size RKN kernel, on the device
    of ``y0_batch`` ``(B, 2n)``: B5's loop.  ``fun`` is a
    :class:`FusedGridAcc` or a rows-first torch function ``acc(t, u, v)``,
    called as ``acc(t, u, v, p)`` with ``p`` ``(k, B)`` where ``params``
    (B, k) is given.  Returns ``(y (B, 2n), status (B,), nsteps (B,), nfev
    (B,))``, with ``t_eval`` ``y_eval`` after them and with ``dense=R``
    the dense output last."""
    y = _state(y0_batch)
    params = member_params(params, y.T, fun)
    acc = bind_acc(fun, params, None if params is None else params.T)
    return run_rkn_loop(acc, rkn_consts(method), t_span, y, rtol, atol,
                        first_step, max_steps, compensated, max_step, dense,
                        t_eval)


# the shapes of :func:`_launch_shape` for large ensembles: the members an SM
# above which it leaves one block of one element a thread, and above which
# it takes the warp body (an SM issues from four warp schedulers, so a warp
# per member fills it from four members on), the members a block of the
# warp body, and the largest n the warp is taken at (beyond it the swept
# sizes ran faster on blocks)
HALF_FROM = 2
WARP_FROM = 4
WARP_MEMBERS = 4
WARP_MAX_N = 256


def _launch_shape(B, n, sm_count):
    """The launch shape for ``B`` members of ``n`` positions on a card of
    ``sm_count`` SMs: one block of ``grid_threads(n)`` threads per member,
    ``(threads, 0)``, where the ensemble gives every SM at most
    ``HALF_FROM`` (2) members; one warp per member, ``(32, WARP_MEMBERS)``
    (four members a block), where it gives more than ``WARP_FROM`` (4) and
    n is at most ``WARP_MAX_N``; else one block of two positions a thread,
    ``grid_threads(ceil(n / 2))``.

    A warp runs its member on one of an SM's four schedulers, with no
    barrier; blocks spread a member over them and wait at their barriers,
    which contend once several blocks share an SM.  From the sweeps of the
    wave (Fi5N; ``tools/probe_fused_rk_grid.py``) on an H100 (132 SMs, 700
    W), device ms plain / compensated.  At n = 256, one block of 128 and of
    256 threads per member against one warp per member at 4 members a
    block: 64 members 0.228 / 1.142 and 0.220 / 1.033 against 0.250 /
    1.781; 256 members 0.229 / 1.178 and 0.212 / 1.097 against 0.247 /
    1.931; 512 members 0.246 / 1.459 and 0.280 / 1.679 against 0.255 /
    1.958; 1,024 members 0.369 / 2.441 and 0.480 / 3.017 against 0.276 /
    2.127.  At 1,024 members, blocks of 128 and of 256 threads against the
    warp at 1 / 4 a block: n = 512 1.025 / 12.744 and 0.904 / 11.685
    against 1.112 / 21.053 and 1.052 / 18.047; n = 1024 3.131 / 73.281 and
    2.870 / 66.205 against 4.431 / 274.456 (four do not fit)."""
    return grid_launch_shape(B, n, sm_count, HALF_FROM, WARP_FROM,
                             WARP_MEMBERS, WARP_MAX_N)


def _kernel(method, fun, record=False, snap=False):
    """The kernel built for one RKN method and FusedGridAcc, with the dense
    record where ``record`` and the t_eval snapshots where ``snap`` (each
    switch a build of its own)."""
    if method is None:
        from ..methods import Fi5N as method
    from . import _build
    return _build.cached("fused_rkn_grid", (method, fun),
                         lambda: _build.load_fused_rk_grid(
                             rkn_consts(method), True, (fun.n,),
                             fun.cuda_src, fun.k, record, snap),
                         extra=(bool(record), bool(snap)))


def solve_fused_rkn_grid(acc, t_span, y0_batch, method=None, rtol=1e-4,
                         atol=1e-6, first_step=None, max_steps=100_000,
                         block_members=32, compensated=False, t_eval=None,
                         events=None, max_step=None, params=None,
                         dense=None):
    """Integrate an ensemble of mid-size second-order systems with an RKN
    pair (Fi5N by default) in one kernel launch.

    ``y0_batch``: (B, 2n) float32, ``[u, v]`` per member, any n.  Returns
    ``(y_final (B, 2n), status (B,), nsteps (B,), nfev (B,))``, status as
    :func:`solve_fused_rkn`; ``compensated=True`` is its mixed-precision
    mode.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``acc`` must be a :class:`FusedGridAcc`, and the call launches
    ``csrc/fused_rk_grid.cu`` with one block or one warp per member, as
    :func:`_launch_shape` says from the ensemble size, n and the card's SM
    count (raising when the members' rows do not fit in shared memory), or
    raises; the shape taken is ``solve_fused_rkn_grid.last_shape``.  On a
    CPU tensor it runs :func:`fused_rkn_grid_reference`.
    ``block_members`` is accepted for the JAX signature and has no effect:
    the members a block come from the measured rule
    (:func:`_launch_shape`), not from the caller.

    ``params``: (B, k) float32 per-member parameters; ``acc`` then takes
    them as its last argument (see :class:`FusedGridAcc`, whose ``k`` must
    agree).  ``dense=R`` adds the dense output last and ``t_eval`` the rows
    ``y_eval`` (len(t_eval), B, 2n) after the four, as on
    :func:`~.fused_rkn.solve_fused_rkn` (every thread records and
    snapshots the elements it commits: position i's u and v rows).
    ``events`` is not ported yet.
    """
    check_options("solve_fused_rkn_grid", "B6", events=events)
    y0 = as_input(y0_batch, torch.float32)
    params = member_params(params, y0, acc)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, compensated=compensated,
              max_step=max_step, params=params, dense=dense, t_eval=t_eval)
    if y0.device.type != "cuda":
        return fused_rkn_grid_reference(acc, t_span, y0, method=method, **kw)
    n = acc.n if isinstance(acc, FusedGridAcc) else -1
    check_grid_input("solve_fused_rkn_grid", y0, 2 * n, FusedGridAcc, acc,
                     params)
    out, shape = _launch(_kernel(method, acc, dense_rows(dense) > 0,
                                 eval_points(t_eval) is not None),
                         t_span, y0, n, count=True, **kw)
    solve_fused_rkn_grid.last_shape = shape
    return out


def _launch(built, t_span, y0, n, shape=None, count=False, rtol=1e-4,
            atol=1e-6, first_step=None, max_steps=100_000, compensated=False,
            max_step=None, params=None, dense=None, t_eval=None):
    """Launch B6 for the CUDA tensor ``y0`` (and the members' ``params``,
    as the build takes them, ``dense`` rows of record a member and the
    points of ``t_eval`` on a build with each) at ``shape`` (None:
    :func:`_launch_shape`'s, its P capped by the card's shared memory; a
    given shape is taken as it is, for comparisons), counted where
    ``count``.  Returns the outputs and the shape taken."""
    return launch_by_rule(solve_fused_rkn_grid, _launch_shape, built, y0, n,
                          t_span, shape, count, rtol=rtol, atol=atol,
                          first_step=first_step, max_steps=max_steps,
                          compensated=compensated, max_step=max_step,
                          params=params, dense=dense, t_eval=t_eval)


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count), and the (threads, warp members) of the last
# launch through the wrapper
solve_fused_rkn_grid.launches = 0
solve_fused_rkn_grid.last_shape = None
