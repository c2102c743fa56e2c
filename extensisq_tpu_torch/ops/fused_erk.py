"""Fused ensemble solver: the whole adaptive explicit RK integration in
one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_erk.py``.  The kernel
(``csrc/fused_erk.cu``) runs one thread per member: stages, error norm,
accept/reject controller and the time loop all stay in registers for the
whole integration.  Its plain PyTorch version, :func:`fused_erk_reference`,
runs the same loop on rows-first ``(n, B)`` float32 tensors; the wrapper
:func:`solve_fused_erk` takes it only for tensors on the CPU.

``compensated=True`` is the mixed-precision mode: Neumaier-compensated
solution and error sums and a double-single ``(hi, lo)`` carry for y and
t, which lets float32 run rtol ~1e-6 / atol ~1e-9.
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


@dataclasses.dataclass(frozen=True)
class FusedRHS:
    """A right-hand side the fused kernel can compile in.

    ``torch_fn(t, y)`` is the rows-first function on ``(n, B)`` tensors
    (``t`` is ``(B,)``), used by the plain version.  ``cuda_src`` is CUDA
    C++ that defines the same function for one member::

        __device__ void rhs(float t, const float* y, float* dy);

    ``n`` is the state size.
    """
    torch_fn: Callable
    cuda_src: str
    n: int


def _fused_consts(method):
    """Static tableau and controller data of one method, rounded to
    float32 as the JAX kernel rounds it."""
    if method is None:
        from ..methods import BS5 as method
    if method.family != "erk":
        raise NotImplementedError(
            f"solve_fused_erk takes explicit RK methods; {method.name} is "
            f"of the {method.family!r} family")
    tab = method.tableau
    err_order = min(tab.order_secondary, tab.order)
    return {
        "name": tab.name,
        "A": np.asarray(tab.A, dtype=np.float32),
        "B": np.asarray(tab.B, dtype=np.float32),
        "C": np.asarray(tab.C, dtype=np.float32),
        "E": np.asarray(tab.E, dtype=np.float32),
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


# -- compensated / double-single arithmetic (mixed-precision mode) ---------
#
# f32 cannot run tight tolerances for two reasons: (1) the embedded error
# weights sum to zero, so the error estimate is a cancellation of O(h|f|)
# terms; (2) the solution accumulates one f32 rounding per step.
# Neumaier-compensated sums fix (1) and a double-single (hi, lo) carry for
# y and t fixes (2).  PyTorch runs each of these operations as its own
# rounded kernel, so nothing is contracted into an FMA here.

def _two_sum(a, b):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _comp_wsum(rows, w):
    """Neumaier-compensated weighted sum: returns (sum, compensation)."""
    acc = None
    comp = None
    for wi, r in zip(w, rows):
        if wi == 0.0:
            continue
        term = float(wi) * r
        if acc is None:
            acc = term
            comp = torch.zeros_like(term)
        else:
            acc, e = _two_sum(acc, term)
            comp = comp + e
    if acc is None:
        z = torch.zeros_like(rows[0])
        return z, z
    return acc, comp


def _df_add(hi, lo, x):
    """(hi, lo) + x for f32 x: double-single accumulate."""
    s, e = _two_sum(hi, x)
    return _two_sum(s, lo + e)


def fresh_step(k, max_step, t, tf, h_abs, fresh, min_step, std_sc):
    """The per-step preparation of the fused loops (step limits and the
    end-of-interval look-ahead split), applied on fresh steps only.
    Returns ``(h_abs, min_step, std_b, d)`` with ``d = |tf - t|``."""
    ms = torch.clamp(k["h_min_a"] * (torch.abs(t) + h_abs),
                     min=k["tiny_err"])
    h_pre = torch.maximum(h_abs, ms)
    if max_step is not None:
        h_pre = torch.clamp(h_pre, max=float(max_step))
    d = torch.abs(tf - t)
    split = (d < 2.0 * h_pre) & (d > h_pre)
    h_f = torch.where(split, torch.maximum(0.5 * d, ms),
                      torch.where(d <= h_pre, d, h_pre))
    return (torch.where(fresh, h_f, h_abs), torch.where(fresh, ms, min_step),
            std_sc | (fresh & split), d)


def controller(k, err_norm, err_old, h, h_prev, std_b, rejected, max_fac):
    """The fused loops' accept/reject controller in float32
    (``core.controller.erk_accept_update``).  Returns ``(factor if
    accepted, factor if rejected, is_tiny, max_factor after an accepted
    step)``."""
    cc = k["cc"]
    err_c = torch.clamp(err_norm, min=1e-30)
    f_std = cc.safety * err_c ** cc.error_exponent
    hr = h / torch.where(h_prev == 0.0, h, h_prev)
    f_2nd = torch.minimum(torch.clamp(
        cc.safety_sc * err_c ** cc.minbeta1
        * torch.clamp(err_old, min=1e-30) ** cc.minbeta2
        * hr ** cc.minalpha, min=cc.min_factor), max_fac)
    is_tiny = err_norm < k["tiny_err"]
    fac_acc = torch.where(is_tiny, max_fac, torch.where(std_b, f_std, f_2nd))
    fac_acc = torch.where(rejected, torch.clamp(fac_acc, max=1.0), fac_acc)
    max_fac_new = torch.where(fac_acc < 4.0, 4.0, max_fac)
    fac_rej = torch.clamp(f_std, min=cc.min_factor)
    return fac_acc, fac_rej, is_tiny, max_fac_new


def fused_erk_reference(fun, t_span, y0_batch, method=None, rtol=1e-4,
                        atol=1e-6, first_step=None, max_steps=100_000,
                        compensated=False, max_step=None):
    """The plain PyTorch version of the fused kernel, on the device of
    ``y0_batch``.

    Runs the kernel's loop for the whole batch at once, in float32: each
    iteration is one attempt of every running member, and the loop ends
    once no member is RUNNING.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function.  Returns ``(y (B, n), status (B,),
    nsteps (B,), nfev (B,))`` like :func:`solve_fused_erk`.
    """
    if isinstance(fun, FusedRHS):
        fun = fun.torch_fn
    k = _fused_consts(method)
    A, B_w, C, E = k["A"], k["B"], k["C"], k["E"]
    s, fsal = k["s"], k["fsal"]

    f32 = torch.float32
    y = torch.as_tensor(y0_batch).to(f32).T.contiguous()
    n, nb = y.shape
    dev = y.device

    def full(v):
        return torch.full((nb,), v, dtype=f32, device=dev)

    t = full(float(t_span[0]))
    tf = full(float(t_span[1]))
    rtol_r, atol_r = full(rtol), full(atol)
    direction = torch.sign(tf - t)
    f = fun(t, y)
    if first_step is None:
        bq = t + direction * torch.clamp(
            torch.abs(tf - t),
            max=np.inf if max_step is None else float(max_step))
        h_abs = torch.abs(_hstart_tile.hstart_tile(
            fun, t, bq, y, f, k["morder"], rtol_r, atol_r))
        nfev0 = 2 + min(n + 1, 3)
    else:
        h_abs = full(first_step)
        nfev0 = 1

    i32 = dict(dtype=torch.int32, device=dev)
    t_lo = torch.zeros_like(t)
    y_lo = torch.zeros_like(y)
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

        # stages, zero weights dropped
        rows = [f]
        if compensated:
            for i in range(1, s):
                dy = h * weighted_sum(rows, A[i, :i])
                rows.append(fun(t + float(C[i]) * h, y + (dy + y_lo)))
            inc_s, inc_c = _comp_wsum(rows, B_w)
            y_hi, y_lo1 = _df_add(y, y_lo, h * inc_s)
            y_new, y_lo_new = _two_sum(y_hi, y_lo1 + h * inc_c)
        else:
            for i in range(1, s):
                dy = h * weighted_sum(rows, A[i, :i])
                rows.append(fun(t + float(C[i]) * h, y + dy))
            y_new = y + h * weighted_sum(rows, B_w)
            y_lo_new = y_lo
        if fsal:
            rows.append(fun(t + h, y_new))
        m = s + (1 if fsal else 0)
        if compensated:
            e_s, e_c = _comp_wsum(rows[:m], E[:m])
            err = h * (e_s + e_c)
        else:
            err = h * weighted_sum(rows[:m], E[:m])
        scale = atol_r + rtol_r * torch.maximum(torch.abs(y),
                                                torch.abs(y_new))
        err_norm = norm(err / scale)
        # overflow: a non-finite error norm, y_new or FSAL f_new ends the
        # member with status 3 (torch.where keeps it out of its neighbours)
        finite = torch.isfinite(err_norm) & torch.isfinite(y_new).all(0)
        if fsal:
            finite = finite & torch.isfinite(rows[s]).all(0)
        bad = ~finite

        accepted = (err_norm < 1.0) & ~too_small & running & finite

        fac_acc, fac_rej, is_tiny, max_fac_new = controller(
            k, err_norm, err_old, h, h_prev, std_b, rejected, max_fac)
        h_abs_next = h_abs * torch.where(accepted, fac_acc, fac_rej)

        status = torch.where(running & too_small, TOO_SMALL_STEP,
                             torch.where(running & bad, OVERFLOW, status))

        # exact landing on tf at the last step
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

        f_new = rows[s] if fsal else fun(t_new, y_new)
        upd = accepted
        dfev = torch.where(running, s if fsal else s - 1, 0)
        if not fsal:
            dfev = dfev + upd.to(torch.int32)
        # step cap: loop iterations, accepted plus rejected
        it += 1
        status = torch.where((status == RUNNING) & (it >= max_steps),
                             OVERFLOW, status).to(torch.int32)

        y = torch.where(upd, y_new, y)
        y_lo = torch.where(upd, y_lo_new, y_lo)
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

    return y.T.contiguous(), status, nstep, nfev


def check_options(name, item, **options):
    """Raise for the options of the JAX fused kernels not ported yet."""
    for opt, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}({opt}=...) is not ported yet: ROADMAP queue B, "
                f"item {item} (remaining options)")


def launch_args(t_span, rtol, atol, first_step, max_steps, compensated,
                max_step):
    """The launch scalars the fused explicit kernels share: t0, tf, rtol,
    atol, h0, use_hstart, max_step, max_steps, compensated."""
    return (float(np.float32(t_span[0])), float(np.float32(t_span[1])),
            float(rtol), float(atol),
            0.0 if first_step is None else float(first_step),
            int(first_step is None),
            np.inf if max_step is None else float(max_step),
            int(max_steps), int(bool(compensated)))


def _kernel(method, fun):
    """The kernel built for one method and FusedRHS."""
    if method is None:
        from ..methods import BS5 as method
    from . import _build
    return _build.cached("fused_erk", (method, fun),
                         lambda: _build.load_fused_erk(
                             _fused_consts(method), fun.n, fun.cuda_src))


def solve_fused_erk(fun, t_span, y0_batch, method=None, rtol=1e-4,
                    atol=1e-6, first_step=None, max_steps=100_000,
                    block_members=128, compensated=False, t_eval=None,
                    events=None, max_step=None, params=None, dense=None):
    """Integrate an ensemble of small ODE systems in one kernel launch.

    ``y0_batch``: (B, n) float32.  Returns ``(y_final (B, n), status (B,),
    nsteps (B,), nfev (B,))`` with status 1 = finished, 2 = step size
    underflow, 3 = overflow or step cap (``max_steps`` counts loop
    iterations, accepted plus rejected).

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.
    On a CUDA tensor ``fun`` must be a :class:`FusedRHS`, and the call
    launches ``csrc/fused_erk.cu`` (built at first use) with
    ``block_members`` threads per block, or raises.  On a CPU tensor it
    runs :func:`fused_erk_reference`, with a :class:`FusedRHS` or a plain
    rows-first torch function.

    ``t_eval``, ``events``, ``params`` and ``dense`` are not ported yet.
    """
    check_options("solve_fused_erk", "B1", t_eval=t_eval, events=events,
                  params=params, dense=dense)
    y0 = as_input(y0_batch, torch.float32)
    if y0.device.type != "cuda":
        return fused_erk_reference(
            fun, t_span, y0, method=method, rtol=rtol, atol=atol,
            first_step=first_step, max_steps=max_steps,
            compensated=compensated, max_step=max_step)

    if not isinstance(fun, FusedRHS):
        raise TypeError("solve_fused_erk on a CUDA tensor needs a FusedRHS "
                        "(a CUDA source of the right-hand side); got "
                        f"{type(fun).__name__}")
    if y0.dtype != torch.float32:
        raise TypeError(f"y0_batch must be float32, got {y0.dtype}")
    if y0.ndim != 2 or y0.shape[1] != fun.n:
        raise ValueError(f"y0_batch must be (B, {fun.n}), got "
                         f"{tuple(y0.shape)}")
    if not y0.is_contiguous():
        raise ValueError("y0_batch must be contiguous")
    if not 1 <= block_members <= 1024:
        raise ValueError("block_members must be in [1, 1024]")

    built = _kernel(method, fun)
    nb = y0.shape[0]
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    if nb == 0:
        return y_out, status, nsteps, nfev
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        rc = built.lib.fused_erk_launch(
            y0.data_ptr(), y_out.data_ptr(), status.data_ptr(),
            nsteps.data_ptr(), nfev.data_ptr(), nb,
            *launch_args(t_span, rtol, atol, first_step, max_steps,
                         compensated, max_step), int(block_members), stream)
    if rc != 0:
        raise RuntimeError(f"fused_erk kernel launch failed: CUDA error {rc}")
    solve_fused_erk.launches += 1
    return y_out, status, nsteps, nfev


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_erk.launches = 0
