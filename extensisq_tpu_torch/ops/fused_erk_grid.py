"""Fused ERK solver for mid-size systems: the whole adaptive integration of
an ensemble in one CUDA kernel launch, one thread block or one warp per
member (:func:`_launch_shape`).

Counterpart of ``extensisq_tpu/ops/fused_erk_grid.py``.  The JAX kernel
runs B1's loop with the state across the 128 lanes and the members on
sublanes, and zero-pads n to a multiple of 128; on Hopper a member is one
thread block or one warp (``csrc/fused_rk_grid.cu``, shared with the RKN
and CKdisc kernels of ``ops/fused_rkn_grid.py`` and
``ops/fused_ckdisc_grid.py``), its rows in shared memory, and any n is
taken without padding.  This module also holds what the three share, the
block size and the launch, and the rule that chooses the shape of B4 and
B6 (:func:`grid_launch_shape`).  The loop is B1's, so the plain version,
:func:`fused_erk_grid_reference`, runs ``fused_erk_reference``'s loop on the
rows-first ``(n, B)`` state; the wrapper :func:`solve_fused_erk_grid` takes
it only for tensors on the CPU.

Right-hand sides are :class:`~.fused_rkc.FusedGridRHS` with
``shape=(n,)``: ``torch_fn(t, y)`` on ``(n, B)``, shifts as
``torch.roll(y, s, 0)`` with ``jnp.roll``'s sign, and the CUDA ``rhs(t,
y, i, p)`` of one element.  With ``params`` (B, k) the FusedGridRHS takes
``k`` parameters: ``torch_fn(t, y, p)`` gets them as ``p`` of shape ``(k,
B)`` (``p[j]`` one parameter across the members; JAX's grid functions get
a k-tuple of ``(bm, 1)`` columns), the CUDA ``rhs`` the member's k floats,
which the kernel loads once into the member's shared memory.  ``dense=R``
records each member's accepted steps for a continuous dense output
(``ops/fused_dense.py``), and ``t_eval`` returns each member's state at
the given times (``csrc/snapshot.cuh``), as on B1.
"""
import numpy as np
import torch

from .._device import as_input
from .fused_erk import (DenseRecord, SnapPoints, _fused_consts,
                        check_options, dense_rows, eval_points,
                        fused_erk_reference, launch_args, member_params,
                        snap_outputs)
from .fused_rkc import FusedGridRHS

# the most threads of a block; a member of n states gets ceil(n / 32) warps
# up to this bound, one element per thread where n allows
MAX_THREADS = 256


def grid_threads(n):
    """The block size for stage rows of n elements: a multiple of 32, at
    most :data:`MAX_THREADS`."""
    return min(MAX_THREADS, 32 * -(-int(n) // 32))


def grid_launch_shape(B, n, sm_count, half_from, warp_from, warp_members,
                      warp_max_n):
    """The launch shape ``(threads, warp members)`` of B4 and B6 for ``B``
    members of stage rows of ``n`` elements on a card of ``sm_count`` SMs,
    by the family's constants: one block of ``grid_threads(n)`` threads
    per member, ``(threads, 0)``, where the ensemble gives every SM at
    most ``half_from`` members; one warp per member, ``(32,
    warp_members)``, where it gives more than ``warp_from`` and n is at
    most ``warp_max_n``; else one block of two elements a thread,
    ``grid_threads(ceil(n / 2))``.  A warp runs its member on one of an
    SM's four schedulers with no block barrier; blocks spread a member
    over them and wait at their barriers, which contend once several
    blocks share an SM, the less so the smaller the blocks.  Each family's
    wrapper holds its constants and the readings they rest on."""
    B, n, sm_count = int(B), int(n), int(sm_count)
    if B <= half_from * sm_count:
        return grid_threads(n), 0
    if n <= warp_max_n and B > warp_from * sm_count:
        return 32, warp_members
    return grid_threads(-(-n // 2)), 0


def _state_size(fun):
    """n of a :class:`FusedGridRHS` of ``shape=(n,)``."""
    if len(fun.shape) != 1:
        raise ValueError("the mid-size kernels take a FusedGridRHS of "
                         f"shape (n,), got {tuple(fun.shape)}")
    return int(fun.shape[0])


def bind_grid_params(fun, params):
    """The rows-first ``fun(t, y)`` of the grid plain versions: ``fun`` (a
    :class:`FusedGridRHS` or a torch function) with every member's
    parameters bound as ``p``, the ``(k, B)`` transpose of ``params``
    (None: no parameters)."""
    if isinstance(fun, FusedGridRHS):
        fun = fun.torch_fn
    if params is None:
        return fun
    p = params.T
    return lambda t, y: fun(t, y, p)


def fused_erk_grid_reference(fun, t_span, y0_batch, method=None, rtol=1e-4,
                             atol=1e-6, first_step=None, max_steps=100_000,
                             compensated=False, max_step=None, params=None,
                             dense=None, t_eval=None):
    """The plain PyTorch version of the mid-size ERK kernel, on the device
    of ``y0_batch`` ``(B, n)``: B1's loop (``fused_erk_reference``).
    ``fun`` is a :class:`FusedGridRHS` or a rows-first torch function,
    called as ``fun(t, y, p)`` with ``p`` ``(k, B)`` where ``params`` (B, k)
    is given.  Returns ``(y (B, n), status (B,), nsteps (B,), nfev
    (B,))``, with ``t_eval`` ``y_eval`` after them and with ``dense=R``
    the dense output last."""
    if isinstance(fun, FusedGridRHS):
        _state_size(fun)
    y0 = torch.as_tensor(y0_batch)
    fun = bind_grid_params(fun, member_params(params, y0, fun))
    return fused_erk_reference(fun, t_span, y0, method=method, rtol=rtol,
                               atol=atol, first_step=first_step,
                               max_steps=max_steps, compensated=compensated,
                               max_step=max_step, dense=dense, t_eval=t_eval)


def check_grid_input(name, y0, n_state, rhs_type, fun, params=None):
    """``y0`` must be a contiguous float32 ``(B, n_state)`` tensor, and
    ``params`` (checked by ``member_params``) contiguous."""
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
    if params is not None and not params.is_contiguous():
        raise ValueError("params must be contiguous")


def shared_memory(name, smem_fn):
    """(bytes of shared memory one member needs, the most a block may have
    on the current card) from the kernel library's query ``smem_fn(need,
    limit)``."""
    import ctypes
    need, limit = ctypes.c_int(0), ctypes.c_int(0)
    rc = smem_fn(ctypes.byref(need), ctypes.byref(limit))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return need.value, limit.value


def check_shared_memory(name, smem_fn, remedy, members=1):
    """Raise unless ``members`` members' rows fit in a block's shared
    memory on the current card: ``smem_fn(need, limit)`` is the kernel
    library's query, ``remedy`` the advice in the message."""
    need, limit = shared_memory(name, smem_fn)
    if need * members > limit:
        raise ValueError(
            f"{name}: {members} member(s) need {need * members} bytes of "
            f"shared memory for their rows, more than the {limit} a thread "
            f"block may have on this card; {remedy}")


def fit_shape(name, smem_fn, shape):
    """A rule's launch ``shape`` (threads, warp members) with its warp
    members cut to what a block's shared memory holds on the current card
    (at least one)."""
    threads, warp = shape
    if warp:
        need, limit = shared_memory(name, smem_fn)
        warp = max(1, min(warp, limit // need))
    return threads, warp


def launch_by_rule(wrapper, rule, built, y0, n_row, t_span, shape, count,
                   **kw):
    """Launch ``csrc/fused_rk_grid.cu`` for ``wrapper`` on the CUDA tensor
    ``y0`` at ``shape`` (None: ``rule(B, n_row, SMs)``'s, its warp members
    capped by the card's shared memory; a given shape is taken as it is,
    for comparisons), counted where ``count``.  ``kw`` are
    :func:`launch_grid`'s options.  Returns the outputs and the shape
    taken."""
    if shape is None:
        with torch.cuda.device(y0.device):
            sms = torch.cuda.get_device_properties(
                y0.device).multi_processor_count
            shape = fit_shape(wrapper.__name__, built.lib.fused_rk_grid_smem,
                              rule(y0.shape[0], n_row, sms))
    return launch_grid(wrapper, built, y0, n_row, t_span, shape, count,
                       **kw), shape


def launch_grid(wrapper, built, y0, n_row, t_span, shape, count, rtol, atol,
                first_step, max_steps, compensated, max_step, params=None,
                dense=None, t_eval=None):
    """Launch ``csrc/fused_rk_grid.cu`` (stage rows of ``n_row``) on the
    current stream for ``wrapper``, whose launch count it raises (where
    ``count``; not for comparison launches), at ``shape``: ``(threads,
    0)`` one block of that many threads per member, ``(32, P)`` one warp
    per member and P members a block; raise before launch when the
    members' rows do not fit in the card's shared memory.  ``params``:
    the members' (B, k) parameters of a build with k of them, or None.
    ``dense``: the dense record's rows a member, for a B4 or B6 build
    with it (None: none).  ``t_eval``: the points of a B4, B6 or B12
    build with snapshots (None: none).  Returns ``(y, status, nsteps,
    nfev)``, with ``t_eval`` ``y_eval`` after them and with ``dense`` the
    :class:`~.fused_dense.FusedDenseSolution` last."""
    name = wrapper.__name__
    threads, warp_members = shape
    nb = y0.shape[0]
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    rec = DenseRecord(y0, dense_rows(dense))
    tq = eval_points(t_eval)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = snap_outputs((y_out, status, nsteps, nfev), snap)
    with torch.cuda.device(y0.device):
        check_shared_memory(name, built.lib.fused_rk_grid_smem,
                            "take a smaller system or solve_fused_* of the "
                            "flat layout", max(1, warp_members))
        if nb == 0:
            return rec.outputs(out, t_span, y0)
        t0, tf, rt, at, h0, use_h, mstep, msteps, comp = launch_args(
            t_span, rtol, atol, first_step, max_steps, compensated, max_step)
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), None if params is None else params.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), nb, t0, tf,
                float(np.sign(np.float32(tf) - np.float32(t0))), rt, at, h0,
                use_h, mstep, msteps, comp, threads, warp_members)
        if snap is not None:
            rc = built.lib.fused_rk_grid_snap_launch(*args, *rec.args(),
                                                     *snap.args(), stream)
        elif rec.rows:
            rc = built.lib.fused_rk_grid_record_launch(*args, *rec.args(),
                                                       stream)
        else:
            rc = built.lib.fused_rk_grid_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    wrapper.launches += int(count)
    return rec.outputs(out, t_span, y0)


# B4's constants of :func:`grid_launch_shape`: one block of
# ``grid_threads(n)`` threads up to HALF_FROM members an SM, beyond one
# warp per member (WARP_MEMBERS a block) where n is at most WARP_MAX_N,
# else blocks of two elements a thread (see :func:`_launch_shape`)
HALF_FROM = 2
WARP_FROM = 2
WARP_MEMBERS = 4
WARP_MAX_N = 512


def _launch_shape(B, n, sm_count):
    """B4's launch shape for ``B`` members of ``n`` states on a card of
    ``sm_count`` SMs: :func:`grid_launch_shape` with :data:`HALF_FROM`,
    :data:`WARP_FROM`, :data:`WARP_MEMBERS` and :data:`WARP_MAX_N`, so one
    block of ``grid_threads(n)`` threads per member up to 2 members an SM,
    beyond one warp per member, four a block, where n <= 512, else one
    block of two elements a thread.

    From the sweeps of config 1b's fisher MoL (BS5, plain at rtol 1e-5,
    compensated at 1e-6; ``tools/probe_fused_rk_grid.py --family erk``)
    on an H100 (132 SMs, 700 W), device ms, launch alone, plain /
    compensated.  At n = 256, the warp (four a block) against blocks of
    256 and 128 threads: 64 members 0.817 / 1.175 against 0.812 / 0.848
    and 0.959 / 1.017; 256 members 0.870 / 1.334 against 0.879 / 0.996
    and 1.045 / 1.131; 512 members 0.874 / 1.328 against 1.340 / 1.531
    and 1.196 / 1.358; 1,024 members 1.052 / 1.536 against 2.373 / 2.796
    and 1.789 / 2.257.  At 64 members the block of 256 wins at larger n:
    n = 512 2.077 / 2.292 against the warp's 2.954 / 4.349; n = 1,024
    6.395 / 6.963 against 11.528 / 40.911.  At 1,024 members the warp
    wins to n = 512 (4.613 / 5.904 at n = 512 against 5.919 / 8.036 at
    128 threads, the faster block) and not beyond (n = 1,024: 23.969 /
    83.565 against 24.760 / 30.819 at 256 threads): its lanes hold 16
    and 32 elements there, and the compensated pair's carries take more
    of them."""
    return grid_launch_shape(B, n, sm_count, HALF_FROM, WARP_FROM,
                             WARP_MEMBERS, WARP_MAX_N)


def _kernel(method, fun, record=False, snap=False):
    """The kernel built for one ERK method and FusedGridRHS, with the dense
    record where ``record`` and the t_eval snapshots where ``snap`` (each
    switch a build of its own)."""
    if method is None:
        from ..methods import BS5 as method
    from . import _build
    return _build.cached("fused_erk_grid", (method, fun),
                         lambda: _build.load_fused_rk_grid(
                             _fused_consts(method), False, fun.shape,
                             fun.cuda_src, fun.k, record, snap),
                         extra=(bool(record), bool(snap)))


def solve_fused_erk_grid(fun, t_span, y0_batch, method=None, rtol=1e-4,
                         atol=1e-6, first_step=None, max_steps=100_000,
                         block_members=32, compensated=False, t_eval=None,
                         events=None, max_step=None, params=None,
                         dense=None):
    """Integrate an ensemble of mid-size systems with an explicit RK pair
    (BS5 by default) in one kernel launch.

    ``y0_batch``: (B, n) float32, any n.  Returns ``(y_final (B, n), status
    (B,), nsteps (B,), nfev (B,))``, status as :func:`solve_fused_erk`;
    ``compensated=True`` is its mixed-precision mode.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``fun`` must be a :class:`FusedGridRHS`, and the call launches
    ``csrc/fused_rk_grid.cu`` with one block or one warp per member, as
    :func:`_launch_shape` says from the ensemble size, n and the card's SM
    count (raising when the members' rows do not fit in shared memory), or
    raises; the shape taken is ``solve_fused_erk_grid.last_shape``.  On a
    CPU tensor it runs :func:`fused_erk_grid_reference`.
    ``block_members`` is accepted for the JAX signature and has no effect:
    the members a block come from the measured rule
    (:func:`grid_launch_shape`), not from the caller.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument (see the module docstring; a
    :class:`FusedGridRHS`'s ``k`` must agree).  ``dense=R`` adds the dense
    output last and ``t_eval`` the rows ``y_eval`` after the four, as on
    :func:`~.fused_erk.solve_fused_erk` (every thread records and
    snapshots the elements it commits).  ``events`` is not ported yet.
    """
    check_options("solve_fused_erk_grid", "B4", events=events)
    y0 = as_input(y0_batch, torch.float32)
    params = member_params(params, y0, fun)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, compensated=compensated,
              max_step=max_step, params=params, dense=dense, t_eval=t_eval)
    if y0.device.type != "cuda":
        return fused_erk_grid_reference(fun, t_span, y0, method=method, **kw)
    n = _state_size(fun) if isinstance(fun, FusedGridRHS) else -1
    check_grid_input("solve_fused_erk_grid", y0, n, FusedGridRHS, fun,
                     params)
    out, shape = _launch(_kernel(method, fun, dense_rows(dense) > 0,
                                 eval_points(t_eval) is not None),
                         t_span, y0, n, count=True, **kw)
    solve_fused_erk_grid.last_shape = shape
    return out


def _launch(built, t_span, y0, n, shape=None, count=False, rtol=1e-4,
            atol=1e-6, first_step=None, max_steps=100_000, compensated=False,
            max_step=None, params=None, dense=None, t_eval=None):
    """Launch B4 for the CUDA tensor ``y0`` (and the members' ``params``,
    as the build takes them, ``dense`` rows of record a member and the
    points of ``t_eval`` on a build with each) at ``shape`` (None:
    :func:`_launch_shape`'s, its P capped by the card's shared memory; a
    given shape is taken as it is, for comparisons), counted where
    ``count``.  Returns the outputs and the shape taken."""
    return launch_by_rule(solve_fused_erk_grid, _launch_shape, built, y0, n,
                          t_span, shape, count, rtol=rtol, atol=atol,
                          first_step=first_step, max_steps=max_steps,
                          compensated=compensated, max_step=max_step,
                          params=params, dense=dense, t_eval=t_eval)


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count), and the (threads, warp members) of the last
# launch through the wrapper
solve_fused_erk_grid.launches = 0
solve_fused_erk_grid.last_shape = None
