"""Fused SWAG solver for mid-size systems: the whole variable-order Adams
PECE integration of an ensemble in one CUDA kernel launch, one thread
block per member.

Counterpart of ``extensisq_tpu/ops/fused_adams_grid.py``.  The JAX kernel
runs B3's SWAG loop with the state across the 128 lanes and the members on
sublanes, and zero-pads n to a multiple of 128; on Hopper a member is one
thread block (``csrc/fused_adams_grid.cu``), its rows and its ``k_max + 2``
rows of divided differences in shared memory, and any n is taken without
padding.  The loop is B3's, so the plain version,
:func:`fused_adams_grid_reference`, runs ``fused_adams_reference``'s loop
(:func:`~.fused_adams.run_adams_loop`) on the rows-first ``(n, B)`` state,
with the norms summed by ``torch.sum`` rather than row after row; the
wrapper :func:`solve_fused_adams_grid` takes it only for tensors on the
CPU.  As in the JAX package, each member's starting state comes from the
float32 stepper's ``init``, run outside the kernel.

Right-hand sides are :class:`~.fused_rkc.FusedGridRHS` with ``shape=(n,)``:
``torch_fn(t, y)`` on ``(n, B)``, shifts as ``torch.roll(y, s, 0)`` with
``jnp.roll``'s sign, and the CUDA ``rhs(t, y, i, p)`` of one element; with
``k`` > 0 per-member parameters ``torch_fn(t, y, p)`` takes ``p`` of shape
``(k, B)`` and the CUDA ``p`` the member's k floats.  ``dense=R`` records
the steps as B3 records them, and ``t_eval`` writes the rows B3 writes
(``ops/fused_adams.py``), every thread of a member's block its own
elements of each row.
"""
import numpy as np
import torch

from .._device import as_input
from .fused_adams import _adams_consts, _f32, _host_init, run_adams_loop
from .fused_erk import (DenseRecord, SnapPoints, check_options, dense_rows,
                        eval_points, member_params, snap_outputs)
from .fused_erk_grid import (_state_size, bind_grid_params, check_grid_input,
                             check_shared_memory, grid_threads)
from .fused_rkc import FusedGridRHS


def _grid_norm(x):
    """RMS over the state rows of ``x`` (n, B), summed by ``torch.sum``."""
    return torch.sqrt((x * x).sum(0) * (1.0 / x.shape[0]))


def fused_adams_grid_reference(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                               first_step=None, k_max=12, max_steps=200_000,
                               max_step=None, params=None, dense=None,
                               t_eval=None):
    """The plain PyTorch version of the mid-size SWAG kernel, on the device
    of ``y0_batch`` ``(B, n)``: B3's loop.  ``fun`` is a
    :class:`FusedGridRHS` or a rows-first torch function, called as
    ``fun(t, y, p)`` with ``p`` ``(k, B)`` where ``params`` (B, k) is given.
    Returns ``(y (B, n), status (B,), nsteps (B,), nfev (B,))``; with
    ``t_eval`` the rows ``y_eval`` (len(t_eval), B, n) after them, and with
    ``dense=R`` the dense output last."""
    if isinstance(fun, FusedGridRHS):
        _state_size(fun)
    y0 = torch.as_tensor(y0_batch)
    fun = bind_grid_params(fun, member_params(params, y0, fun))
    return run_adams_loop(fun, t_span, y0, rtol, atol, first_step,
                          k_max, max_steps, False, max_step, _grid_norm,
                          dense=dense, t_eval=t_eval)


def _kernel(fun, km, record=False, snap=False):
    """The kernel built for one FusedGridRHS and k_max, with the dense
    record where ``record`` and the t_eval snapshots where ``snap`` (each
    switch a build of its own)."""
    from . import _build
    return _build.cached(
        "fused_adams_grid", (fun,),
        lambda: _build.load_fused_adams_grid(
            _adams_consts(km, _state_size(fun)), fun.shape, fun.cuda_src,
            fun.k, record, snap),
        (km, bool(record), bool(snap)))


def solve_fused_adams_grid(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                           first_step=None, k_max=12, max_steps=200_000,
                           block_members=32, t_eval=None, events=None,
                           max_step=None, params=None, dense=None):
    """Integrate an ensemble of mid-size systems with SWAG in one kernel
    launch.

    ``y0_batch``: (B, n) float32, any n that fits a block's shared memory.
    Returns ``(y_final (B, n), status (B,), nsteps (B,), nfev (B,))`` with
    status 1 = finished, 2 = step size underflow, 3 = overflow or step cap
    (``max_steps`` counts loop iterations, accepted plus rejected).
    ``k_max`` (1 to 12) caps the order; ``max_step`` caps |h|.  Backward
    spans work.  ``block_members`` is accepted for the JAX signature and
    has no effect: a member is one thread block.  ``dense=R`` (R >= 1;
    None or 0: off) adds a fifth output, the members' continuous dense
    output (:class:`~.fused_dense.FusedDenseSolution`), recorded as
    ``solve_fused_adams`` records it; the record leaves the other four
    outputs bit for bit as they are without it.  ``t_eval``: times at
    which to return each member's y, ``y_eval`` (len(t_eval), B, n) after
    ``nfev`` (before the dense output), as ``solve_fused_adams`` returns
    them, leaving the four outputs bit for bit as they are without it.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``fun`` must be a :class:`FusedGridRHS`; the members' starting
    state is computed by torch operations on the card, and the call
    launches ``csrc/fused_adams_grid.cu`` (built at first use) with one
    block of up to 256 threads per member (raising when the member's rows
    do not fit in shared memory), or raises.  On a CPU tensor it runs
    :func:`fused_adams_grid_reference`.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument, ``p`` of shape ``(k, B)`` (a
    :class:`FusedGridRHS` whose ``k`` must agree), the members' starting
    state included.  ``events`` is not ported yet.
    """
    check_options("solve_fused_adams_grid", "B8", events=events)
    y0 = as_input(y0_batch, torch.float32)
    km = int(k_max)
    if not 0 < km < 13:
        raise ValueError("`k_max` should be an integer between 1 and 12.")
    params = member_params(params, y0, fun)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step, k_max=km,
              max_steps=max_steps, max_step=max_step, params=params,
              dense=dense, t_eval=t_eval)
    if y0.device.type != "cuda":
        return fused_adams_grid_reference(fun, t_span, y0, **kw)
    n = _state_size(fun) if isinstance(fun, FusedGridRHS) else -1
    check_grid_input("solve_fused_adams_grid", y0, n, FusedGridRHS, fun,
                     params)
    built = _kernel(fun, km, dense_rows(dense) > 0,
                    eval_points(t_eval) is not None)
    return _launch(built, fun, t_span, y0, **kw)


def _start(fun, t_span, y0, rtol, atol, first_step, k_max, max_step,
           params=None):
    """Each member's starting state, outside the kernel as in the JAX
    package: the float32 stepper's init run as torch operations on the
    card, on ``fun`` with the members' ``params`` bound.  Returns (f(t0,
    y0) (B, n), h0 (B,), nfev0 (B,), direction)."""
    _, s0, direction = _host_init(bind_grid_params(fun, params), t_span,
                                  y0.T, rtol, atol, first_step, k_max,
                                  max_step)
    return (s0.yp.T.contiguous(), s0.h.contiguous(), s0.nfev.contiguous(),
            direction)


def _launch(built, fun, t_span, y0, rtol, atol, first_step, k_max,
            max_steps, max_step, start=None, params=None, dense=None,
            t_eval=None):
    """Launch ``csrc/fused_adams_grid.cu`` (``built``, the build with the
    dense record where ``dense`` has rows and with the snapshots where
    ``t_eval`` has points) on the current stream from the members'
    ``start`` (:func:`_start`'s, computed here when None) with their
    ``params``; raise before launch when a member's rows do not fit in the
    card's shared memory.  Returns the outputs, with ``y_eval`` and the
    :class:`~.fused_dense.FusedDenseSolution` after the four where there
    are points and a record."""
    nb, n = y0.shape
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    rows = dense_rows(dense)
    rec = DenseRecord(y0, rows)
    tq = eval_points(t_eval)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = snap_outputs((y_out, status, nsteps, nfev), snap)
    with torch.cuda.device(y0.device):
        check_shared_memory("solve_fused_adams_grid",
                            built.lib.fused_adams_grid_smem,
                            "take a smaller system or a lower k_max")
        if nb == 0:
            return rec.outputs(out, t_span, y0)
        if start is None:
            start = _start(fun, t_span, y0, rtol, atol, first_step, k_max,
                           max_step, params)
        yp0, h0, nfev0, direction = start
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), yp0.data_ptr(), h0.data_ptr(),
                nfev0.data_ptr(),
                None if params is None else params.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), nb, _f32(t_span[0]), _f32(t_span[1]),
                direction, _f32(rtol), _f32(atol),
                np.inf if max_step is None else _f32(max_step),
                int(max_steps), grid_threads(n))
        if snap is not None:
            rc = built.lib.fused_adams_grid_snap_launch(
                *args, *rec.args(), *snap.args(), stream)
        elif rows:
            rc = built.lib.fused_adams_grid_record_launch(*args, *rec.args(),
                                                          stream)
        else:
            rc = built.lib.fused_adams_grid_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_adams_grid kernel launch failed: CUDA error {rc}")
    solve_fused_adams_grid.launches += 1
    return rec.outputs(out, t_span, y0)


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_adams_grid.launches = 0
