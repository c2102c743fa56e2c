"""Fused ensemble solver for Runge-Kutta-Nystrom pairs: the whole adaptive
integration of a second-order ensemble in one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_rkn.py``.  The state of a member
is ``(u, v)`` with ``u' = v``, ``v' = acc(t, u, v)``; stages store
accelerations only, displacements update with ``h^2 A`` and velocities
with ``h Ap``.  The kernel (``csrc/fused_rkn.cu``) runs one thread per
member with u, v and the stage accelerations in registers.  Its plain
PyTorch version, :func:`fused_rkn_reference`, runs the same loop
(:func:`run_rkn_loop`, shared with the mid-size layout of
``ops/fused_rkn_grid.py``) on rows-first ``(m, B)`` float32 tensors; the
wrapper :func:`solve_fused_rkn` takes it only for tensors on the CPU.

``compensated=True`` is the mixed-precision mode of ``ops/fused_erk.py``:
Neumaier-compensated sums and double-single ``(hi, lo)`` carries of u, v
and t.

``params`` (B, k) gives every member its own k parameters, and ``dense=R``
records each member's accepted steps ``(t, [u, v], [v, a])`` for a
continuous dense output (``ops/fused_dense.py``): cubic Hermite on the
full first-order state, as in JAX.  ``t_eval`` returns each member's
``[u, v]`` at the given times, the same cubic Hermite of the accepted step
that crosses each (the u rows with derivative v, the v rows with the
carried acceleration), written inside the kernel (``csrc/snapshot.cuh``).

The error norm is the RMS of ``[err_u, err_v]`` over all 2m states, each
scaled by ``atol + rtol * max(|[u, v]|, |[u_new, v_new]|)``.  The fused
kernels use the tableau's ``E``/``Ep`` as they are: unlike the stepper,
they do not apply Mu5Nmb's ``scale_embedded`` damping (as in the JAX
kernels).
"""
import dataclasses
from typing import Callable

import numpy as np
import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW
from .._device import as_input
from ..core.controller import resolve_controller
from ..core.numerics import norm
from ..steppers.erk import weighted_sum
from . import _hstart_tile
from .fused_erk import (DenseRecord, SnapPoints, Snapshots, _Record,
                        _comp_wsum, _df_add, _launch_shape, _two_sum,
                        check_options, controller, dense_rows,
                        device_sm_count, eval_points, fresh_step,
                        lanes_within_budget, launch_args, member_params,
                        snap_outputs)


@dataclasses.dataclass(frozen=True)
class FusedAcc:
    """An acceleration the fused RKN kernel can compile in.

    ``torch_fn(t, u, v)`` is the rows-first function on ``(m, B)`` tensors
    (``t`` is ``(B,)``), used by the plain version.  ``cuda_src`` is CUDA
    C++ that defines the same function for one member::

        template <class T>
        __device__ void acc(T t, const T* u, const T* v, T* a);

    (a plain ``float`` function of the same name works too).  ``m`` is
    the number of positions; the state is ``[u, v]`` of size 2m.  With
    ``k > 0`` per-member parameters (``params``), ``torch_fn(t, u, v, p)``
    gets ``p``, a k-tuple of ``(B,)`` tensors, and the CUDA function takes
    the member's k parameters last::

        template <class T>
        __device__ void acc(T t, const T* u, const T* v, T* a, const T* p);

    which the kernel loads once into registers.
    """
    torch_fn: Callable
    cuda_src: str
    m: int
    k: int = 0


def rkn_consts(method):
    """Static tableau and controller data of one RKN method, rounded to
    float32 as the JAX kernel rounds it (``E``/``Ep`` undamped)."""
    if method is None:
        from ..methods import Fi5N as method
    if method.family != "rkn":
        raise NotImplementedError(
            f"the fused RKN kernels take Runge-Kutta-Nystrom methods; "
            f"{method.name} is of the {method.family!r} family")
    tab = method.tableau
    f32 = np.float32
    A = np.asarray(tab.A, dtype=f32)
    err_order = min(tab.order_secondary, tab.order)
    return {
        "name": tab.name,
        "A": A,
        "Ap": np.zeros_like(A) if tab.Ap is None else np.asarray(tab.Ap, f32),
        "B": np.asarray(tab.B, dtype=f32),
        "Bp": np.asarray(tab.Bp, dtype=f32),
        "C": np.asarray(tab.C, dtype=f32),
        "E": np.asarray(tab.E, dtype=f32),
        "Ep": np.asarray(tab.Ep, dtype=f32),
        "s": tab.n_stages,
        "fsal": tab.fsal,
        "morder": tab.order_secondary,
        "cc": resolve_controller(None, tab.sc_params,
                                 -1.0 / (err_order + 1)),
        "tiny_err": float(np.sqrt(np.finfo(np.float32).tiny)),
        "h_min_a": 10.0 * float(np.finfo(np.float32).eps) / tab.c_spacing(),
        "hstart": {"big": _hstart_tile.BIG, "small": _hstart_tile.SMALL,
                   "relper": _hstart_tile.RELPER,
                   "t_floor": 100.0 * _hstart_tile.SMALL_T},
    }


def run_rkn_loop(acc, k, t_span, y, rtol, atol, first_step, max_steps,
                 compensated, max_step, dense=None, t_eval=None):
    """The fused RKN loop (the JAX kernels' ``_run_rkn_loop``) on the
    rows-first float32 state ``y`` ``(2m, B)``: each iteration is one
    attempt of every running member, and the loop ends once no member is
    RUNNING.  ``acc(t, u, v)`` works on ``(m, B)`` rows.  Returns ``(y
    (B, 2m), status, nsteps, nfev)``; with ``t_eval`` the rows ``y_eval``
    (len(t_eval), B, 2m) after them, the cubic Hermite of ``[u, v]`` with
    derivative ``[v, a]`` (``fused_erk.Snapshots``: JAX's partitioned
    Hermite, the u rows from ``(u, v)``, the v rows from ``(v, a)``), and
    with ``dense=R`` the dense output of the rows ``(t, [u, v], [v, a])``
    the kernels write last."""
    A, Ap, B_w, Bp, C = k["A"], k["Ap"], k["B"], k["Bp"], k["C"]
    E, Ep, s, fsal = k["E"], k["Ep"], k["s"], k["fsal"]
    f32 = torch.float32
    n2, nb = y.shape
    m = n2 // 2
    u, v = y[:m].contiguous(), y[m:].contiguous()
    dev = y.device

    def full(x):
        return torch.full((nb,), x, dtype=f32, device=dev)

    def dot(rows, w):
        if compensated:
            return _comp_wsum(rows, w)
        return weighted_sum(rows, w), None

    t = full(float(t_span[0]))
    tf = full(float(t_span[1]))
    rtol_r, atol_r = full(rtol), full(atol)
    direction = torch.sign(tf - t)
    f = acc(t, u, v)
    if first_step is None:
        # the in-kernel Watts start on the first-order form [v, acc]
        def df_full(tt, Y):
            return torch.cat([Y[m:], acc(tt, Y[:m], Y[m:])])

        bq = t + direction * torch.clamp(
            torch.abs(tf - t),
            max=np.inf if max_step is None else float(max_step))
        h_abs = torch.abs(_hstart_tile.hstart_tile(
            df_full, t, bq, torch.cat([u, v]), torch.cat([v, f]),
            k["morder"], rtol_r, atol_r))
        nfev0 = 2 + min(n2 + 1, 3)
    else:
        h_abs = full(first_step)
        nfev0 = 1

    i32 = dict(dtype=torch.int32, device=dev)
    rows_r = dense_rows(dense)
    rec = (_Record(torch.cat([u, v]), torch.cat([v, f]), rows_r) if rows_r
           else None)
    tq = eval_points(t_eval)
    snaps = (None if tq is None
             else Snapshots(tq, torch.cat([u, v]), direction))
    t_lo = torch.zeros_like(t)
    u_lo, v_lo = torch.zeros_like(u), torch.zeros_like(v)
    status = torch.full((nb,), RUNNING, **i32)
    std_sc = torch.ones(nb, dtype=torch.bool, device=dev)
    err_old = full(1.0)
    h_prev = torch.zeros_like(t)
    max_fac = full(10.0)
    fresh = torch.ones_like(std_sc)
    rejected = torch.zeros_like(std_sc)
    min_step = torch.zeros_like(t)
    nstep = torch.zeros(nb, **i32)
    nfev = torch.full((nb,), nfev0, **i32)
    it = 0
    while True:
        running = status == RUNNING
        if not bool(running.any()):
            break
        h_abs, min_step, std_b, d = fresh_step(k, max_step, t, tf, h_abs,
                                               fresh, min_step, std_sc)
        too_small = h_abs < min_step
        h = h_abs * direction
        hh = h * h

        # stages: accelerations only
        rows = [f]
        for i in range(1, s):
            ch = float(C[i]) * h
            du = hh * weighted_sum(rows, A[i, :i]) + ch * v
            dv = h * weighted_sum(rows, Ap[i, :i])
            if compensated:
                du = du + u_lo
                dv = dv + v_lo
            rows.append(acc(t + ch, u + du, v + dv))

        bs, bc = dot(rows, B_w)
        ps, pc = dot(rows, Bp)
        if compensated:
            u_hi, u_l1 = _df_add(u, u_lo, h * v)
            u_hi, u_l2 = _two_sum(u_hi, u_l1 + hh * bs)
            u_new, u_lo_new = _two_sum(u_hi, u_l2 + hh * bc)
            v_hi, v_l1 = _df_add(v, v_lo, h * ps)
            v_new, v_lo_new = _two_sum(v_hi, v_l1 + h * pc)
        else:
            u_new = u + h * v + hh * bs
            v_new = v + h * ps
            u_lo_new, v_lo_new = u_lo, v_lo
        if fsal:
            rows.append(acc(t + h, u_new, v_new))
        mm = s + (1 if fsal else 0)
        es, ec = dot(rows[:mm], E[:mm])
        eps_, epc = dot(rows[:mm], Ep[:mm])
        if compensated:
            err = torch.cat([hh * (es + ec), h * (eps_ + epc)])
        else:
            err = torch.cat([hh * es, h * eps_])
        scale = atol_r + rtol_r * torch.maximum(
            torch.abs(torch.cat([u, v])), torch.abs(torch.cat([u_new, v_new])))
        err_norm = norm(err / scale)
        # overflow: a non-finite error norm, u_new, v_new or FSAL
        # acceleration ends the member with status 3
        finite = (torch.isfinite(err_norm) & torch.isfinite(u_new).all(0)
                  & torch.isfinite(v_new).all(0))
        if fsal:
            finite = finite & torch.isfinite(rows[s]).all(0)
        bad = ~finite
        accepted = (err_norm < 1.0) & ~too_small & running & finite

        fac_acc, fac_rej, is_tiny, max_fac_new = controller(
            k, err_norm, err_old, h, h_prev, std_b, rejected, max_fac)
        h_abs_next = h_abs * torch.where(accepted, fac_acc, fac_rej)

        status = torch.where(running & too_small, TOO_SMALL_STEP,
                             torch.where(running & bad, OVERFLOW, status))
        is_last = accepted & (h_abs >= d)
        if compensated:
            t_adv, t_lo_adv = _df_add(t, t_lo, h)
            t_new = torch.where(is_last, tf, t_adv)
            t_lo_new = torch.where(is_last, 0.0, t_lo_adv)
        else:
            t_new = torch.where(is_last, tf, t + h)
            t_lo_new = t_lo
        status = torch.where((status == RUNNING) & is_last, FINISHED,
                             status)

        f_new = rows[s] if fsal else acc(t_new, u_new, v_new)
        upd = accepted
        dfev = torch.where(running, s if fsal else s - 1, 0)
        if not fsal:
            # a non-FSAL pair evaluates the endpoint of accepted steps only
            dfev = dfev + upd.to(torch.int32)
        if rec is not None and it < rec.rows:
            rec.write(upd, nstep, t_new, torch.cat([u_new, v_new]),
                      torch.cat([v_new, f_new]))
        if snaps is not None:
            # the high words of t, u and v in the compensated mode
            snaps.step(upd, t, t_new, h, torch.cat([u, v]),
                       torch.cat([v, f]), torch.cat([u_new, v_new]),
                       torch.cat([v_new, f_new]))
        # step cap: loop iterations, accepted plus rejected
        it += 1
        status = torch.where((status == RUNNING) & (it >= max_steps),
                             OVERFLOW, status).to(torch.int32)

        u = torch.where(upd, u_new, u)
        v = torch.where(upd, v_new, v)
        u_lo = torch.where(upd, u_lo_new, u_lo)
        v_lo = torch.where(upd, v_lo_new, v_lo)
        f = torch.where(upd, f_new, f)
        t = torch.where(upd, t_new, t)
        t_lo = torch.where(upd, t_lo_new, t_lo)
        h_abs = torch.where(running, h_abs_next, h_abs)
        std_sc = torch.where(upd, is_tiny, std_sc)
        err_old = torch.where(upd, err_norm, err_old)
        h_prev = torch.where(upd, h, h_prev)
        max_fac = torch.where(upd, max_fac_new, max_fac)
        fresh = upd | (status != RUNNING)
        rejected = ~upd & (rejected | (running & ~accepted))
        nstep = nstep + upd.to(torch.int32)
        nfev = nfev + dfev.to(torch.int32)

    out = (torch.cat([u, v]).T.contiguous(), status, nstep, nfev)
    if snaps is not None:
        out = out + (snaps.rows(t, torch.cat([u, v])),)
    if rec is None:
        return out
    return out + (rec.solution(t_span, nstep),)


def bind_acc(fun, params, p=None):
    """The rows-first ``acc(t, u, v)`` of the plain versions: ``fun`` (a
    :class:`FusedAcc`, a ``FusedGridAcc`` or a torch function) with every
    member's parameters bound as ``p``, by default the k-tuple of the
    ``(B,)`` columns of ``params`` (None: no parameters)."""
    fn = getattr(fun, "torch_fn", fun)
    if params is None:
        return fn
    if p is None:
        p = tuple(params[:, j] for j in range(params.shape[1]))
    return lambda t, u, v: fn(t, u, v, p)


def _state(y0_batch):
    """The rows-first float32 state ``(2m, B)`` of a ``(B, 2m)`` batch."""
    y = torch.as_tensor(y0_batch).to(torch.float32)
    if y.ndim != 2 or y.shape[1] % 2:
        raise ValueError("state must be [u, v] with even length: y0_batch "
                         f"(B, 2m), got {tuple(y.shape)}")
    return y.T.contiguous()


def fused_rkn_reference(fun, t_span, y0_batch, method=None, rtol=1e-4,
                        atol=1e-6, first_step=None, max_steps=100_000,
                        compensated=False, max_step=None, params=None,
                        dense=None, t_eval=None):
    """The plain PyTorch version of the fused RKN kernel, on the device of
    ``y0_batch`` ``(B, 2m)``.  ``fun`` is a :class:`FusedAcc` or a
    rows-first torch function ``acc(t, u, v)``, called as ``acc(t, u, v,
    p)`` where ``params`` (B, k) is given.  Returns ``(y (B, 2m), status
    (B,), nsteps (B,), nfev (B,))`` like :func:`solve_fused_rkn`; with
    ``t_eval`` the rows ``y_eval`` (len(t_eval), B, 2m) after them, and
    with ``dense=R`` the members' :class:`~.fused_dense.FusedDenseSolution`
    last, from the rows the kernel writes."""
    y = _state(y0_batch)
    params = member_params(params, y.T, fun)
    return run_rkn_loop(bind_acc(fun, params), rkn_consts(method), t_span,
                        y, rtol, atol, first_step, max_steps, compensated,
                        max_step, dense, t_eval)


def _kernel(method, fun, record=False, snap=False):
    """The kernel built for one RKN method and FusedAcc, with the dense
    record where ``record`` and the t_eval snapshots where ``snap`` (each
    switch a build of its own)."""
    if method is None:
        from ..methods import Fi5N as method
    from . import _build
    return _build.cached("fused_rkn", (method, fun),
                         lambda: _build.load_fused_rkn(
                             rkn_consts(method), fun.m, fun.cuda_src, fun.k,
                             record, snap),
                         extra=(bool(record), bool(snap)))


# the lane counts the wrapper takes besides 1, most first
_LANES = (8, 4)
# the most positions per member at which the wrapper takes lanes
_LANES_MAX_M = 2


def _lanes_per_member(B, sm_count, m):
    """Lanes per member of B5 for an ensemble of ``B`` members of ``m``
    positions on a card of ``sm_count`` SMs: where m <= 2, the largest G
    of 8 and 4 with B G <= 128 sm_count, else 1 (one thread per member).

    From the member sweeps (``tools/probe_fused_small.py``, launch alone,
    ten launches back to back) on an H100 (132 SMs, 700 W), us per launch
    of one thread per member (128 a block) against G = 2 / 4 / 8 (128 / G
    members a block).  Kepler (Fi5N, m = 2, one orbit, eccentricities
    0.1-0.7), plain: 512 members 62.6 against 67.7 / 57.0 / 55.2; 2,048:
    64.1 against 69.1 / 58.1 / 56.4; 4,096: 64.2 against 69.3 / 58.2 /
    60.7; 16,384: 64.4 against 74.1 / 81.1 / 129.8.  Compensated: 512
    members 168.7 against 180.3 / 154.0 / 149.8; 2,048: 167.8 against
    179.8 / 153.7 / 149.5; 4,096: 169.2 against 180.6 / 154.0 / 161.4;
    16,384: 169.6 against 194.4 / 228.8 / 376.2.  The lanes split Fi5N's
    three controller powers (each lane's exponent then known only at run
    time, a longer powf: at G = 2, two a lane, they lose) and the norm's
    2m divisions; past one warp per SM sub-partition every G loses.
    Pleiades (m = 14, seven bodies, t in [0, 3]), where the acceleration
    outweighs what the lanes split: plain, 512 members 6,435 against
    6,670 / 6,600 / 6,602; 2,048: 6,455 against 6,723 / 6,638 / 6,609;
    compensated, 512: 17,636 against 18,201 / 17,966 / 17,921; 2,048:
    18,492 against 19,261 / 18,865 / 18,400.  m from 3 to 13 is not
    measured and keeps one thread.  G = 2 is built (a comparison body) but
    never taken."""
    if int(m) > _LANES_MAX_M:
        return 1
    return lanes_within_budget(B, sm_count, _LANES)


def solve_fused_rkn(acc, t_span, y0_batch, method=None, rtol=1e-4,
                    atol=1e-6, first_step=None, max_steps=100_000,
                    block_members=None, compensated=False, t_eval=None,
                    events=None, max_step=None, params=None, dense=None):
    """Integrate an ensemble of small second-order systems in one kernel
    launch.

    ``y0_batch``: (B, 2m) float32, ``[u, v]`` per member (Fi5N by
    default).  Returns ``(y_final (B, 2m), status (B,), nsteps (B,), nfev
    (B,))`` with status 1 = finished, 2 = step size underflow, 3 = overflow
    or step cap (``max_steps`` counts loop iterations, accepted plus
    rejected).  ``dense=R`` (R >= 1; None or 0: off) adds a fifth output,
    the members' continuous dense output
    (:class:`~.fused_dense.FusedDenseSolution`), from the end ``(t, [u,
    v], [v, a])`` of each accepted step that the kernel records while a
    member's attempts are below R (``valid[b]`` False where more were
    needed): cubic Hermite on the full state, as in JAX; the record leaves
    the other four outputs bit for bit as they are without it.

    ``t_eval``: times (taken as float32, in any order, repeats and points
    outside the span allowed) at which to return each member's ``[u, v]``,
    ``y_eval`` (len(t_eval), B, 2m) after ``nfev`` (before the dense
    output): the cubic Hermite of the accepted step that crosses each
    point, the u rows with derivative v and the v rows with the carried
    acceleration (JAX's partitioned form), written inside the kernel (a
    build of its own, ``csrc/snapshot.cuh``); points at or before t0 take
    y0, points a member never reaches its final state (a member that ended
    with status 2 or 3 included).  It leaves the four outputs bit for bit
    as they are without it.  No points: the four outputs alone.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``acc`` must be a :class:`FusedAcc`, and the call launches
    ``csrc/fused_rkn.cu`` (built at first use) or raises: G lanes of one
    warp per member, G from :func:`_lanes_per_member` (the ensemble size,
    the card's SM count and m; every lane runs the member, the lanes split
    the norm's divisions and the controller's powers, with the bits of one
    thread per member), and ``block_members`` members per block (None: 128
    / G), so ``block_members * G`` threads per block, at most 1024; the
    shape taken is left in ``solve_fused_rkn.last_shape``.  On a CPU
    tensor it runs :func:`fused_rkn_reference`.

    ``params``: (B, k) float32 per-member parameters; ``acc`` then takes
    them as its last argument (see :class:`FusedAcc`, whose ``k`` must
    agree).  ``events`` is not ported yet.
    """
    check_options("solve_fused_rkn", "B5", events=events)
    y0 = as_input(y0_batch, torch.float32)
    if y0.device.type != "cuda":
        return fused_rkn_reference(
            acc, t_span, y0, method=method, rtol=rtol, atol=atol,
            first_step=first_step, max_steps=max_steps,
            compensated=compensated, max_step=max_step, params=params,
            dense=dense, t_eval=t_eval)

    out, shape = _launch(acc, t_span, y0, method, rtol, atol, first_step,
                         max_steps, compensated, max_step, None,
                         block_members, params, dense, t_eval)
    solve_fused_rkn.last_shape = shape
    if y0.shape[0]:
        solve_fused_rkn.launches += 1
    return out


def _launch(acc, t_span, y0, method, rtol, atol, first_step, max_steps,
            compensated, max_step, lanes, block_members=None, params=None,
            dense=None, t_eval=None):
    """B5 on the card for the CUDA tensor ``y0`` (and the members'
    ``params``, checked by :func:`member_params`): ``lanes`` lanes per
    member (None: :func:`_lanes_per_member`'s) and ``block_members``
    members per block (None: 128 / lanes), with the dense record of
    ``dense`` rows a member and the rows of ``t_eval`` (each switch the
    build with it) where given.  Returns the outputs (``y_eval`` and the
    :class:`~.fused_dense.FusedDenseSolution` after the four) and the
    ``(lanes, block_members)`` taken; an empty batch launches nothing."""
    if not isinstance(acc, FusedAcc):
        raise TypeError("solve_fused_rkn on a CUDA tensor needs a FusedAcc "
                        "(a CUDA source of the acceleration); got "
                        f"{type(acc).__name__}")
    if y0.dtype != torch.float32:
        raise TypeError(f"y0_batch must be float32, got {y0.dtype}")
    if y0.ndim != 2 or y0.shape[1] != 2 * acc.m:
        raise ValueError(f"y0_batch must be (B, {2 * acc.m}), got "
                         f"{tuple(y0.shape)}")
    if not y0.is_contiguous():
        raise ValueError("y0_batch must be contiguous")
    params = member_params(params, y0, acc)
    if params is not None:
        params = params.contiguous()
    nb = y0.shape[0]
    if lanes is None:
        lanes = _lanes_per_member(nb, device_sm_count(y0.device), acc.m)
    block_members, _, _ = _launch_shape(nb, lanes, block_members)
    rows = dense_rows(dense)
    tq = eval_points(t_eval)

    built = _kernel(method, acc, rows > 0, tq is not None)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    shape = (lanes, block_members)
    rec = DenseRecord(y0, rows)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = snap_outputs((y_out, status, nsteps, nfev), snap)
    if nb == 0:
        return rec.outputs(out, t_span, y0), shape
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), None if params is None else params.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), nb,
                *launch_args(t_span, rtol, atol, first_step, max_steps,
                             compensated, max_step), int(lanes),
                block_members)
        if snap is not None:
            rc = built.lib.fused_rkn_snap_launch(*args, *rec.args(),
                                                 *snap.args(), stream)
        elif rows:
            rc = built.lib.fused_rkn_record_launch(*args, *rec.args(),
                                                   stream)
        else:
            rc = built.lib.fused_rkn_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_rkn kernel launch failed: CUDA error {rc}")
    return rec.outputs(out, t_span, y0), shape


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count) and the (lanes per member, members per block)
# of the last launch
solve_fused_rkn.launches = 0
solve_fused_rkn.last_shape = None
