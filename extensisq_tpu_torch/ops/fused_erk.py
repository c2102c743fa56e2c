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
``dense=R`` records each member's accepted steps for a continuous dense
output (``ops/fused_dense.py``).  ``t_eval`` returns each member's state at
the given times, the cubic Hermite of the accepted step that crosses each,
written inside the kernel (``csrc/snapshot.cuh``).
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
from .fused_dense import record_solution


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
    :class:`FusedRHS`, ``FusedGridRHS``, ``FusedAcc`` or ``FusedGridAcc``
    must take the same ``k`` (``ValueError``)."""
    # these modules import this one
    from .fused_rkc import FusedGridRHS
    from .fused_rkn import FusedAcc
    from .fused_rkn_grid import FusedGridAcc
    k_fun = (fun.k if isinstance(fun, (FusedRHS, FusedGridRHS, FusedAcc,
                                        FusedGridAcc)) else None)
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
                        compensated=False, max_step=None, params=None,
                        dense=None, t_eval=None):
    """The plain PyTorch version of the fused kernel, on the device of
    ``y0_batch``.

    Runs the kernel's loop for the whole batch at once, in float32: each
    iteration is one attempt of every running member, and the loop ends
    once no member is RUNNING.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function, called as ``fun(t, y, p)`` where
    ``params`` (B, k) is given.  Returns ``(y (B, n), status (B,),
    nsteps (B,), nfev (B,))`` like :func:`solve_fused_erk`; with
    ``t_eval`` the rows ``y_eval`` (len(t_eval), B, n) after them (see
    :class:`Snapshots`), and with ``dense=R`` the members'
    :class:`~.fused_dense.FusedDenseSolution` last, from the rows the
    kernel writes.
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
    rows = dense_rows(dense)
    rec = _Record(y, f, rows) if rows else None
    tq = eval_points(t_eval)
    snaps = None if tq is None else Snapshots(tq, y, direction)
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
        if rec is not None and it < rec.rows:
            rec.write(upd, nstep, t_new, y_new, f_new)
        if snaps is not None:
            snaps.step(upd, t, t_new, h, y, f, y_new, f_new)
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

    out = (y.T.contiguous(), status, nstep, nfev)
    if snaps is not None:
        out = out + (snaps.rows(t, y),)
    if rec is None:
        return out
    return out + (rec.solution(t_span, nstep),)


class _Record:
    """The plain versions' dense record, written as the kernels write it
    (``csrc/dense_record.cuh``): an accepted step's end at the member's row
    ``nstep``, the others to a spare row past the end."""

    def __init__(self, y, f, rows):
        n, nb = y.shape
        self.rows = rows
        self.y0 = y.T.clone()
        self.f0 = f.T.clone()
        self.t = y.new_zeros(nb, rows + 1)
        self.y = y.new_zeros(nb, rows + 1, n)
        self.f = y.new_zeros(nb, rows + 1, n)
        self.n = torch.zeros(nb, dtype=torch.int32, device=y.device)
        self.b = torch.arange(nb, device=y.device)

    def write(self, accepted, nstep, t, y, f):
        i = (self.b, torch.where(accepted, nstep, self.rows).long())
        self.t[i] = t
        self.y[i] = y.T
        self.f[i] = f.T
        self.n = self.n + accepted.to(torch.int32)

    def solution(self, t_span, nsteps):
        R = self.rows
        return record_solution(t_span, self.y0, self.f0, self.t[:, :R],
                               self.y[:, :R], self.f[:, :R], self.n, nsteps)


def eval_points(t_eval):
    """``t_eval`` as a 1-D float32 numpy array, as the JAX kernels round
    its points; None for None or no points (the four outputs alone, as
    JAX's ``nq = 0``)."""
    if t_eval is None:
        return None
    if isinstance(t_eval, torch.Tensor):
        t_eval = t_eval.detach().cpu().numpy()
    tq = np.asarray(t_eval, np.float32).reshape(-1)
    return tq if tq.size else None


class Snapshots:
    """The plain versions' t_eval rows, JAX's rule point by point
    (``_run_erk_loop``, ``_run_ck_loop``): at each accepted step every
    point q with ``dir (tq - t) > 0`` and ``dir tq <= dir t_new`` takes the
    cubic Hermite of the step's end pairs ``(y, f)``, ``(y_new, f_new)``
    at ``theta = (tq - t) / h`` clamped to [0, 1] (``h`` 1 where it is 0),
    its terms summed in ``_hermite_tiles``' order; points at or before t0
    keep y0, and those a member never reaches take its final y.  Every
    point is tested at every step (the kernels keep a cursor into the
    sorted points instead, ``csrc/snapshot.cuh``), over the rows-first
    ``(n, B)`` state of the plain loops, ``torch.where`` over the
    members."""

    def __init__(self, tq, y, direction):
        n, nb = y.shape
        self.tq = torch.as_tensor(tq, device=y.device)[:, None]
        self.direction = direction
        self.y = y.expand(len(tq), n, nb).clone()

    def step(self, upd, t, t_new, h, y, f, y_new, f_new):
        """The accepted step of each member in ``upd`` from ``(t, y, f)``
        to ``(t_new, y_new, f_new)`` of signed size ``h`` (rows-first)."""
        d, tq = self.direction, self.tq
        crossed = upd & (d * (tq - t) > 0.0) & (d * tq <= d * t_new)
        theta = torch.clamp((tq - t) / torch.where(h == 0.0, 1.0, h), 0.0,
                            1.0)
        t2 = theta * theta
        t3 = t2 * theta
        c00 = (2.0 * t3 - 3.0 * t2 + 1.0)[:, None]
        c10 = (h * (t3 - 2.0 * t2 + theta))[:, None]
        c01 = (3.0 * t2 - 2.0 * t3)[:, None]
        c11 = (h * (t3 - t2))[:, None]
        val = c00 * y + c10 * f + c01 * y_new + c11 * f_new
        self.y = torch.where(crossed[:, None], val, self.y)

    def line(self, upd, t, tf, y, yp):
        """The SWAG loops' near-end extrapolation of each member in ``upd``
        from ``(t, y)`` with slope ``yp`` to ``tf`` (rows-first): every point
        with ``dir (tq - t) > 0`` and ``dir tq <= dir tf`` takes JAX's
        straight line ``y + (tq - t) yp`` (``fused_adams.py:655-681``)."""
        d, tq = self.direction, self.tq
        crossed = upd & (d * (tq - t) > 0.0) & (d * tq <= d * tf)
        val = y + (tq - t)[:, None] * yp
        self.y = torch.where(crossed[:, None], val, self.y)

    def rows(self, t, y):
        """``y_eval`` (nq, B, n) at the members' final ``t`` and ``y``."""
        d = self.direction
        unreached = (d * self.tq > d * t)[:, None]
        return torch.where(unreached, y, self.y).permute(0, 2, 1).contiguous()


class SnapPoints:
    """The t_eval arrays of a snapshot launch for the CUDA tensor ``y0``
    ``(B, n)``: the float32 points ``tq`` sorted in the direction of
    ``t_span`` (a stable sort, NaN first), their indices in t_eval and
    ``y_eval`` (nq, B, n), which the kernel fills (``csrc/snapshot.cuh``)."""

    def __init__(self, tq, t_span, y0):
        d = np.sign(np.float32(t_span[1]) - np.float32(t_span[0]))
        with np.errstate(invalid="ignore"):
            key = d * tq
        key[np.isnan(key)] = -np.inf
        order = np.argsort(key, kind="stable")
        self.nq = len(tq)
        self.tq = torch.from_numpy(tq[order]).to(y0.device)
        self.idx = torch.from_numpy(order.astype(np.int32)).to(y0.device)
        self.y = y0.new_empty(self.nq, *y0.shape)

    def args(self):
        """The launch's snapshot arguments."""
        return (self.tq.data_ptr(), self.idx.data_ptr(), self.y.data_ptr(),
                self.nq)


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


def _kernel(method, fun, record=False, snap=False):
    """The kernel built for one method and FusedRHS, with the dense record
    where ``record`` and the t_eval snapshots where ``snap`` (each switch
    a build of its own)."""
    if method is None:
        from ..methods import BS5 as method
    from . import _build
    return _build.cached("fused_erk", (method, fun),
                         lambda: _build.load_fused_erk(
                             _fused_consts(method), fun.n, fun.cuda_src,
                             fun.k, record, snap),
                         extra=(bool(record), bool(snap)))


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
    iterations, accepted plus rejected).  ``dense=R`` (R >= 1; None or 0:
    off) adds a fifth output, the members' continuous dense output
    (:class:`~.fused_dense.FusedDenseSolution`), from the end ``(t, y,
    f)`` of each accepted step that the kernel records while a member's
    attempts are below R (``valid[b]`` False where more were needed); the
    record leaves the other four outputs bit for bit as they are without
    it.

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
    agree).

    ``t_eval``: times (taken as float32, in any order, repeats and points
    outside the span allowed) at which to return each member's state,
    ``y_eval`` (len(t_eval), B, n) after ``nfev`` (before the dense
    output): the cubic Hermite of the accepted step that crosses each
    point, written inside the kernel (a build of its own,
    ``csrc/snapshot.cuh``); points at or before t0 take y0, points a
    member never reaches its final y (a member that ended with status 2 or
    3 included).  It leaves the four outputs bit for bit as they are
    without it.  No points: the four outputs alone.  ``events`` is not
    ported yet.
    """
    check_options("solve_fused_erk", "B1", events=events)
    y0 = as_input(y0_batch, torch.float32)
    params = member_params(params, y0, fun)
    if y0.device.type != "cuda":
        return fused_erk_reference(
            fun, t_span, y0, method=method, rtol=rtol, atol=atol,
            first_step=first_step, max_steps=max_steps,
            compensated=compensated, max_step=max_step, params=params,
            dense=dense, t_eval=t_eval)

    out, shape = _launch(fun, t_span, y0, method, rtol, atol, first_step,
                         max_steps, compensated, max_step, None,
                         block_members, params, dense, t_eval)
    solve_fused_erk.last_shape = shape
    if y0.shape[0]:
        solve_fused_erk.launches += 1
    return out


def _launch(fun, t_span, y0, method, rtol, atol, first_step, max_steps,
            compensated, max_step, lanes, block_members=None, params=None,
            dense=None, t_eval=None):
    """B1 on the card for the CUDA tensor ``y0`` (and the members'
    ``params``, checked by :func:`member_params`): ``lanes`` lanes per
    member (None: :func:`_lanes_per_member`'s) and ``block_members``
    members per block (None: 128 / lanes), with the dense record of
    ``dense`` rows a member and the rows of ``t_eval`` (each switch the
    build with it) where given.  Returns the outputs (``y_eval`` and the
    :class:`~.fused_dense.FusedDenseSolution` after the four) and the
    ``(lanes, block_members)`` taken; an empty batch launches nothing."""
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
    rows = dense_rows(dense)
    tq = eval_points(t_eval)

    built = _kernel(method, fun, rows > 0, tq is not None)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    shape = (lanes, block_members)
    rec = DenseRecord(y0, rows)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = (y_out, status, nsteps, nfev)
    if nb == 0:
        return rec.outputs(snap_outputs(out, snap), t_span, y0), shape
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), None if params is None else params.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), nb,
                *launch_args(t_span, rtol, atol, first_step, max_steps,
                             compensated, max_step), int(lanes),
                block_members)
        if snap is not None:
            rc = built.lib.fused_erk_snap_launch(*args, *rec.args(),
                                                 *snap.args(), stream)
        elif rows:
            rc = built.lib.fused_erk_record_launch(*args, *rec.args(),
                                                   stream)
        else:
            rc = built.lib.fused_erk_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_erk kernel launch failed: CUDA error {rc}")
    return rec.outputs(snap_outputs(out, snap), t_span, y0), shape


def snap_outputs(out, snap):
    """The launch's outputs ``out``, with ``y_eval`` after them where there
    are t_eval points (``snap``, a :class:`SnapPoints`)."""
    return out if snap is None else out + (snap.y,)


def dense_rows(dense):
    """The record's rows a member of ``dense`` (None or 0: none)."""
    rows = 0 if dense is None else int(dense)
    if rows < 0:
        raise ValueError(f"dense must be None or at least 0, got {dense}")
    return rows


class DenseRecord:
    """The arrays a dense-output launch of B1-B8 writes
    (``csrc/dense_record.cuh``) for the CUDA tensor ``y0`` ``(B, n)`` at
    ``rows`` a member (none for 0)."""

    def __init__(self, y0, rows):
        self.rows = rows
        if rows:
            nb, n = y0.shape
            self.t = y0.new_empty(nb, rows)
            self.y = y0.new_empty(nb, rows, n)
            self.f = y0.new_empty(nb, rows, n)
            self.f0 = torch.empty_like(y0)
            self.n = torch.empty(nb, dtype=torch.int32, device=y0.device)

    def args(self):
        """The launch's record arguments (null pointers and 0 rows without
        a record, as a snapshot launch of a build without it takes
        them)."""
        if not self.rows:
            return (None,) * 5 + (0,)
        return (self.t.data_ptr(), self.y.data_ptr(), self.f.data_ptr(),
                self.f0.data_ptr(), self.n.data_ptr(), self.rows)

    def outputs(self, out, t_span, y0):
        """The launch's outputs ``out``, with the dense output after them
        where there is a record."""
        if not self.rows:
            return out
        return out + (record_solution(t_span, y0, self.f0, self.t, self.y,
                                      self.f, self.n, out[2]),)


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count) and the (lanes per member, members per block)
# of the last launch
solve_fused_erk.launches = 0
solve_fused_erk.last_shape = None
