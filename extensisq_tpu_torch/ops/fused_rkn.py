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
from .fused_erk import (_comp_wsum, _df_add, _two_sum, check_options,
                        controller, fresh_step, launch_args)


@dataclasses.dataclass(frozen=True)
class FusedAcc:
    """An acceleration the fused RKN kernel can compile in.

    ``torch_fn(t, u, v)`` is the rows-first function on ``(m, B)`` tensors
    (``t`` is ``(B,)``), used by the plain version.  ``cuda_src`` is CUDA
    C++ that defines the same function for one member::

        template <class T>
        __device__ void acc(T t, const T* u, const T* v, T* a);

    (a plain ``float`` function of the same name works too).  ``m`` is
    the number of positions; the state is ``[u, v]`` of size 2m.
    """
    torch_fn: Callable
    cuda_src: str
    m: int


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
                 compensated, max_step):
    """The fused RKN loop (the JAX kernels' ``_run_rkn_loop``) on the
    rows-first float32 state ``y`` ``(2m, B)``: each iteration is one
    attempt of every running member, and the loop ends once no member is
    RUNNING.  ``acc(t, u, v)`` works on ``(m, B)`` rows.  Returns ``(y
    (B, 2m), status, nsteps, nfev)``."""
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

    return torch.cat([u, v]).T.contiguous(), status, nstep, nfev


def _state(y0_batch):
    """The rows-first float32 state ``(2m, B)`` of a ``(B, 2m)`` batch."""
    y = torch.as_tensor(y0_batch).to(torch.float32)
    if y.ndim != 2 or y.shape[1] % 2:
        raise ValueError("state must be [u, v] with even length: y0_batch "
                         f"(B, 2m), got {tuple(y.shape)}")
    return y.T.contiguous()


def fused_rkn_reference(fun, t_span, y0_batch, method=None, rtol=1e-4,
                        atol=1e-6, first_step=None, max_steps=100_000,
                        compensated=False, max_step=None):
    """The plain PyTorch version of the fused RKN kernel, on the device of
    ``y0_batch`` ``(B, 2m)``.  ``fun`` is a :class:`FusedAcc` or a
    rows-first torch function ``acc(t, u, v)``.  Returns ``(y (B, 2m),
    status (B,), nsteps (B,), nfev (B,))`` like :func:`solve_fused_rkn`.
    """
    acc = fun.torch_fn if isinstance(fun, FusedAcc) else fun
    return run_rkn_loop(acc, rkn_consts(method), t_span, _state(y0_batch),
                        rtol, atol, first_step, max_steps, compensated,
                        max_step)


def _kernel(method, fun):
    """The kernel built for one RKN method and FusedAcc."""
    if method is None:
        from ..methods import Fi5N as method
    from . import _build
    return _build.cached("fused_rkn", (method, fun),
                         lambda: _build.load_fused_rkn(
                             rkn_consts(method), fun.m, fun.cuda_src))


def solve_fused_rkn(acc, t_span, y0_batch, method=None, rtol=1e-4,
                    atol=1e-6, first_step=None, max_steps=100_000,
                    compensated=False, t_eval=None, events=None,
                    max_step=None, params=None, dense=None):
    """Integrate an ensemble of small second-order systems in one kernel
    launch.

    ``y0_batch``: (B, 2m) float32, ``[u, v]`` per member (Fi5N by
    default).  Returns ``(y_final (B, 2m), status (B,), nsteps (B,), nfev
    (B,))`` with status 1 = finished, 2 = step size underflow, 3 = overflow
    or step cap (``max_steps`` counts loop iterations, accepted plus
    rejected).

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``acc`` must be a :class:`FusedAcc`, and the call launches
    ``csrc/fused_rkn.cu`` (built at first use, one thread per member in
    blocks of 128), or raises.  On a CPU tensor it runs
    :func:`fused_rkn_reference`.

    ``t_eval``, ``events``, ``params`` and ``dense`` are not ported yet.
    """
    check_options("solve_fused_rkn", "B5", t_eval=t_eval, events=events,
                  params=params, dense=dense)
    y0 = as_input(y0_batch, torch.float32)
    if y0.device.type != "cuda":
        return fused_rkn_reference(
            acc, t_span, y0, method=method, rtol=rtol, atol=atol,
            first_step=first_step, max_steps=max_steps,
            compensated=compensated, max_step=max_step)

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

    built = _kernel(method, acc)
    nb = y0.shape[0]
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    if nb == 0:
        return y_out, status, nsteps, nfev
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        rc = built.lib.fused_rkn_launch(
            y0.data_ptr(), y_out.data_ptr(), status.data_ptr(),
            nsteps.data_ptr(), nfev.data_ptr(), nb,
            *launch_args(t_span, rtol, atol, first_step, max_steps,
                         compensated, max_step), stream)
    if rc != 0:
        raise RuntimeError(f"fused_rkn kernel launch failed: CUDA error {rc}")
    solve_fused_rkn.launches += 1
    return y_out, status, nsteps, nfev


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_rkn.launches = 0
