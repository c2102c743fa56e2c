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
t, which lets float32 run rtol ~1e-6 / atol ~1e-9.  ``params`` (B, k)
gives every member its own k parameters (a parameter-sweep ensemble).
"""
import dataclasses
import functools
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

    ``n`` is the state size.  With ``k`` > 0 per-member parameters the
    function takes them as a third argument: ``torch_fn(t, y, p)`` with
    ``p`` a k-tuple of ``(B,)`` tensors, and in CUDA the member's k
    floats, ``rhs(float t, const float* y, float* dy, const float* p)``,
    or the template form ``template <class T> __device__ void rhs(T t,
    const T* y, T* dy, const T* p)``, which the implicit kernels and the
    sensitivities (``ops/fused_sens.py``) need.
    """
    torch_fn: Callable
    cuda_src: str
    n: int
    k: int = 0


def member_params(params, y0, fun):
    """``params`` as the ``(B, k)`` float32 tensor the kernels read (None
    stays None; a non-tensor goes to ``y0``'s device as float32), checked
    as the JAX kernels check it: ``(B, k)`` or ``ValueError``; a tensor
    must be float32 on ``y0``'s device (``TypeError``); a
    :class:`FusedRHS` (or a ``FusedGridRHS``) must take the same ``k``
    (``ValueError``)."""
    from .fused_rkc import FusedGridRHS  # fused_rkc imports this module
    k_fun = fun.k if isinstance(fun, (FusedRHS, FusedGridRHS)) else None
    kind = type(fun).__name__
    if params is None:
        if k_fun:
            raise ValueError(f"the {kind} takes {k_fun} parameters a "
                             f"member: pass params of shape (B, {k_fun})")
        return None
    if not isinstance(params, torch.Tensor):
        params = torch.as_tensor(np.asarray(params, np.float32),
                                 device=y0.device)
    if params.ndim != 2 or params.shape[0] != y0.shape[0]:
        raise ValueError("params must be (B, k)")
    if k_fun is not None and params.shape[1] != k_fun:
        raise ValueError(f"params has {params.shape[1]} columns; the "
                         f"{kind} takes k = {k_fun}")
    if params.dtype != torch.float32 or params.device != y0.device:
        raise TypeError(f"params must be float32 on {y0.device}")
    return params


def bind_params(fun, params):
    """The rows-first ``fun(t, y)`` of the plain versions: ``fun`` (a
    :class:`FusedRHS` or a torch function) with every member's parameters
    bound, ``p[j]`` the ``(B,)`` column j of ``params`` (None: no
    parameters)."""
    if isinstance(fun, FusedRHS):
        fun = fun.torch_fn
    if params is None:
        return fun
    p = tuple(params[:, j] for j in range(params.shape[1]))
    return lambda t, y: fun(t, y, p)


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
                        compensated=False, max_step=None, params=None):
    """The plain PyTorch version of the fused kernel, on the device of
    ``y0_batch``.

    Runs the kernel's loop for the whole batch at once, in float32: each
    iteration is one attempt of every running member, and the loop ends
    once no member is RUNNING.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function, called as ``fun(t, y, p)`` where
    ``params`` (B, k) is given.  Returns ``(y (B, n), status (B,),
    nsteps (B,), nfev (B,))`` like :func:`solve_fused_erk`.
    """
    k = _fused_consts(method)
    A, B_w, C, E = k["A"], k["B"], k["C"], k["E"]
    s, fsal = k["s"], k["fsal"]

    f32 = torch.float32
    y = torch.as_tensor(y0_batch).to(f32).T.contiguous()
    n, nb = y.shape
    dev = y.device
    fun = bind_params(fun, member_params(params, y.T, fun))

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


# threads per block when the caller leaves block_members to the wrapper
_BLOCK_THREADS = 128


def _launch_shape(B, lanes, block_members=None):
    """``(block_members, threads per block, blocks)`` of a launch of ``B``
    members at ``lanes`` lanes each.  ``block_members`` None takes
    128 / lanes members per block (at least one); a block of more than
    1024 threads raises."""
    if block_members is None:
        block_members = max(1, _BLOCK_THREADS // lanes)
    block_members = int(block_members)
    if block_members < 1:
        raise ValueError("block_members must be at least 1")
    threads = block_members * lanes
    if threads > 1024:
        raise ValueError(
            f"block_members={block_members} at {lanes} lanes per member is "
            f"{threads} threads per block; at most 1024")
    return block_members, threads, -(-int(B) // block_members)


def _kernel(method, fun):
    """The kernel built for one method and FusedRHS."""
    if method is None:
        from ..methods import BS5 as method
    from . import _build
    return _build.cached("fused_erk", (method, fun),
                         lambda: _build.load_fused_erk(
                             _fused_consts(method), fun.n, fun.cuda_src,
                             fun.k))


# threads per SM up to which the wrappers spread members over lane groups
# (one warp per SM sub-partition)
_THREADS_PER_SM = 128
# the lane counts B1 takes besides 1, most first
_LANES = (8, 4)


@functools.lru_cache(maxsize=None)
def device_sm_count(device):
    """The SM count of the CUDA ``device``, asked of the driver once: B1's
    and B5's launches take tens of microseconds, and the property call
    is a share of their host time."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def lanes_within_budget(B, sm_count, lanes, threads_per_sm=_THREADS_PER_SM):
    """The largest G of ``lanes`` (most first) with B G <= threads_per_sm
    sm_count, else 1: by default one warp per SM sub-partition (B1, B2,
    B5)."""
    budget = int(threads_per_sm) * int(sm_count)
    for g in lanes:
        if int(B) * g <= budget:
            return g
    return 1


def _lanes_per_member(B, sm_count, compensated):
    """Lanes per member of B1 for an ensemble of ``B`` members on a card of
    ``sm_count`` SMs: in the compensated mode the largest G of 8 and 4 with
    B G <= 128 sm_count, else 1 (one thread per member); in the plain
    mode 1.

    From the member sweep of the Van der Pol line (BS5, n = 2, mu = 3, t
    in [0, 10]; ``tools/probe_fused_small.py``, launch alone, ten launches
    back to back) on an H100 (132 SMs, 700 W), us per launch of one
    thread per member (128 a block) against G = 2 / 4 / 8 (128 / G
    members a block).  Compensated: 512 members 78.7 against 78.6 / 73.5
    / 70.9; 2,048: 78.6 against 79.0 / 74.5 / 72.0; 4,096: 78.8 against
    79.1 / 74.2 / 88.5; 16,384: 78.9 against 96.0 / 137.8 / 250.9.
    Plain: 512 members 26.6 against 29.2 / 27.0 / 25.8; 2,048: 26.1
    against 29.4 / 27.0 / 26.0; 4,096: 26.6 against 29.8 / 27.9 / 30.2.
    BS5 leaves the controller one power (the others fold to 1 or repeat
    it), which every lane computes, so the lanes split only the norm's n
    divisions, which one thread already overlaps at n = 2: in the plain
    mode the lanes tie or lose.  Past one warp per SM sub-partition (B G
    > 128 sm_count) every G loses.  G = 2 is built (a comparison body)
    but never taken."""
    return lanes_within_budget(B, sm_count, _LANES) if compensated else 1


def solve_fused_erk(fun, t_span, y0_batch, method=None, rtol=1e-4,
                    atol=1e-6, first_step=None, max_steps=100_000,
                    block_members=None, compensated=False, t_eval=None,
                    events=None, max_step=None, params=None, dense=None):
    """Integrate an ensemble of small ODE systems in one kernel launch.

    ``y0_batch``: (B, n) float32.  Returns ``(y_final (B, n), status (B,),
    nsteps (B,), nfev (B,))`` with status 1 = finished, 2 = step size
    underflow, 3 = overflow or step cap (``max_steps`` counts loop
    iterations, accepted plus rejected).

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.
    On a CUDA tensor ``fun`` must be a :class:`FusedRHS`, and the call
    launches ``csrc/fused_erk.cu`` (built at first use) or raises: G lanes
    of one warp per member, G from :func:`_lanes_per_member` (the ensemble
    size, the card's SM count and the mode; every lane runs the member,
    the lanes split the norm's divisions and the controller's powers, with
    the bits of one thread per member), and ``block_members`` members per
    block (None: 128 / G), so ``block_members * G`` threads per block, at
    most 1024; the shape taken is left in ``solve_fused_erk.last_shape``.
    On a CPU tensor it runs :func:`fused_erk_reference`, with a
    :class:`FusedRHS` or a plain rows-first torch function.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument (see :class:`FusedRHS`, whose ``k`` must
    agree).  ``t_eval``, ``events`` and ``dense`` are not ported yet.
    """
    check_options("solve_fused_erk", "B1", t_eval=t_eval, events=events,
                  dense=dense)
    y0 = as_input(y0_batch, torch.float32)
    params = member_params(params, y0, fun)
    if y0.device.type != "cuda":
        return fused_erk_reference(
            fun, t_span, y0, method=method, rtol=rtol, atol=atol,
            first_step=first_step, max_steps=max_steps,
            compensated=compensated, max_step=max_step, params=params)

    out, shape = _launch(fun, t_span, y0, method, rtol, atol, first_step,
                         max_steps, compensated, max_step, None,
                         block_members, params)
    solve_fused_erk.last_shape = shape
    if y0.shape[0]:
        solve_fused_erk.launches += 1
    return out


def _launch(fun, t_span, y0, method, rtol, atol, first_step, max_steps,
            compensated, max_step, lanes, block_members=None, params=None):
    """B1 on the card for the CUDA tensor ``y0`` (and the members'
    ``params``, checked by :func:`member_params`): ``lanes`` lanes per
    member (None: :func:`_lanes_per_member`'s) and ``block_members``
    members per block (None: 128 / lanes).  Returns the four outputs and
    the ``(lanes, block_members)`` taken; an empty batch launches
    nothing."""
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
    params = member_params(params, y0, fun)
    if params is not None and not params.is_contiguous():
        raise ValueError("params must be contiguous")
    nb = y0.shape[0]
    if lanes is None:
        lanes = _lanes_per_member(nb, device_sm_count(y0.device),
                                  compensated)
    block_members, _, _ = _launch_shape(nb, lanes, block_members)

    built = _kernel(method, fun)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    shape = (lanes, block_members)
    if nb == 0:
        return (y_out, status, nsteps, nfev), shape
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        rc = built.lib.fused_erk_launch(
            y0.data_ptr(), None if params is None else params.data_ptr(),
            y_out.data_ptr(), status.data_ptr(),
            nsteps.data_ptr(), nfev.data_ptr(), nb,
            *launch_args(t_span, rtol, atol, first_step, max_steps,
                         compensated, max_step), int(lanes), block_members,
            stream)
    if rc != 0:
        raise RuntimeError(f"fused_erk kernel launch failed: CUDA error {rc}")
    return (y_out, status, nsteps, nfev), shape


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count) and the (lanes per member, members per block)
# of the last launch
solve_fused_erk.launches = 0
solve_fused_erk.last_shape = None
