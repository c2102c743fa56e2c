"""Fused RKC solver: a whole stabilized SSV2stab integration of a PDE grid
in one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_rkc.py``.  Two kernels from one
CUDA body (``csrc/fused_rkc.cu``, ``integrate<Group>``):

* :func:`solve_fused_rkc` (B9): one grid, run by the whole card in a
  cooperative launch, with each block's share of the elementwise arrays in
  its shared memory where it fits (:func:`_grid_shape`);
* :func:`solve_fused_rkc_ensemble` (B10): many member grids, each on a
  thread-block cluster of C CTAs with its elementwise arrays in their
  shared memory (C from :func:`_cluster_size`), or on one thread block,
  with per-member parameters.

Both run the JAX kernel's algorithm in float32: the Chebyshev stage
recurrence in deviation form with double-single coefficients (``ops/ds.py``,
``csrc/ds.cuh``), a double-single carry of y and t, the stage cap
``sqrt(rtol / 10 u)`` with u ~ eps32^2 (hard-capped at 200), the H220
controller and the spectral radius from a float bound, a callback, or the
in-kernel nonlinear power iteration with the stepper's 25-step refresh
policy and its ``nfesig`` counter.  Their plain PyTorch version,
:func:`fused_rkc_reference`, runs the same loop on a batch of members; the
wrappers take it only for tensors on the CPU.

``t_eval`` returns each member's grid at the given times as the JAX
kernels do, by a pending index into the points in the order given (not
sorted): the points at or before t0 take y0, an accepted step writes the
pending point while it lies at or before the step's end, the unclamped
cubic Hermite of the step's end pairs ``(y, f)``, ``(y_k, f_new)`` at
``theta = ((tq - t) - t_lo) / h``, and moves on; every point from the
pending one on takes the final y.  A NaN point, or one out of order,
stops the index there.

Right-hand sides for these kernels are :class:`FusedGridRHS` objects; a
spectral-radius callback that must run on the card is a :class:`FusedRho`.
"""
import dataclasses
from typing import Callable

import numpy as np
import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW, RHO_FAIL
from .._device import as_input
from . import ds as D
from .fused_erk import _df_add, check_options, eval_points

_EPS32 = float(np.finfo(np.float32).eps)
ITMAX = 50               # power-iteration bound
N_ARRAYS = 9             # per-member float32 arrays of the kernel's workspace
# Launch shapes.  B9: one block of 512 per SM (within the resident grid);
# on an H100 that ran the 2x256x256 Brusselator faster than the whole
# resident grid of blocks of 256.  B10: blocks (at C = 1) and CTAs (at
# C > 1) of 1024; at C = 1 that beat 256 and 512 on 64 members of 2x64x128,
# at C = 2 CTAs of 512 were no faster (PERF.md, section 6).
GRID_THREADS = 512
BLOCK_THREADS = 1024
# B10's cluster sizes
CLUSTER_SIZES = (8, 4, 2)


@dataclasses.dataclass(frozen=True)
class FusedGridRHS:
    """A grid right-hand side the fused RKC kernels can compile in.

    ``shape`` is one member's state grid, e.g. ``(2, ny, nx)``.

    ``torch_fn(t, y)``, or ``torch_fn(t, y, p)`` with per-member parameters,
    is the function for the plain version: ``y`` has shape ``(*shape, B)``
    with the members last, ``t`` shape ``(B,)`` and ``p`` shape ``(k, B)``,
    so ``p[0]`` is one parameter across members.  Periodic shifts are
    ``torch.roll(y, shift, axis)`` with ``jnp.roll``'s sign.

    ``cuda_src`` defines the same function for one element of one member::

        __device__ float rhs(float t, const float* y, int i, const float* p);

    returning dy at flat (row-major) index ``i`` from the member's grid ``y``
    in global memory and its ``k`` parameters ``p``.  Neighbours come from
    ``tab::G::rolled<AXIS>(y, i, shift)``, the value at ``i`` of
    ``torch.roll(y, shift, AXIS)`` (``csrc/grid_common.cuh``; the extents
    are compile-time constants of the generated header).

    ``k`` is the number of per-member parameters the mid-size kernels B4
    and B7 take with ``params`` (they check it against ``params``; the RKC
    kernels count the columns of their ``params``).  The implicit kernel
    and the sensitivities (``ops/fused_sens.py``) evaluate the source on
    dual numbers and need the template form ``template <class T> __device__
    T rhs(T t, const T* y, int i, const T* p)``; the sensitivities' grid
    layout takes the state as a second template parameter, ``template
    <class T, class V> __device__ T rhs(T t, V y, int i, const T* p)``,
    indexed as ``y[m]`` and through ``tab::G::rolled``.
    """
    torch_fn: Callable
    cuda_src: str
    shape: tuple
    k: int = 0


@dataclasses.dataclass(frozen=True)
class FusedRho:
    """A spectral-radius callback for the fused RKC kernels: ``torch_fn(t,
    y[, p])`` returns one value per member (``(B,)``, or a float) from the
    plain version's ``(*shape, B)`` grid, and ``cuda_src`` defines::

        __device__ float rho(float t, const float* y, const float* p);

    which every thread of a member's group calls with the same arguments
    (so it must not depend on the thread)."""
    torch_fn: Callable
    cuda_src: str


def _f32(x):
    return float(np.float32(x))


def _rkc_consts():
    """The float32 constants of the kernel, as the JAX kernel rounds them."""
    uround = _EPS32 * _EPS32
    sqrtu = float(np.sqrt(_EPS32))
    return {"sqrtmin": _f32(np.sqrt(np.finfo(np.float32).tiny)),
            "sqrtu": _f32(sqrtu), "one_p_sqrtu": _f32(1.0 + sqrtu),
            "rho_uround": _f32(_EPS32), "hmin_c": _f32(13.3 * uround)}


def _mmax_for(rtol, m_max):
    """The stage cap: sqrt(rtol / 10 u) with u ~ eps32^2, since the stage
    recurrence runs in double-single (the f64 stepper's cap), at most 200;
    ``m_max`` overrides it.  Returns (mmax, u)."""
    uround = _EPS32 * _EPS32
    mmax = int(max(np.round(np.sqrt(rtol / (10.0 * uround))), 2.0))
    mmax = min(mmax, 200)
    return (int(m_max) if m_max is not None else mmax), uround


# m -> (m + 1, 5) float32 table: row 0 holds mus0, row j (2 <= j <= m) the
# coefficients of stage j (muc, nuc, ajc, mus, th)
_TABLES = {}


def _stage_table(m):
    """The Chebyshev coefficients of a step of m stages, in float32 with the
    double-single recurrences of the JAX kernel (``fused_rkc.py:280-321``),
    computed once per m on the host.  Every thread of the CUDA kernel runs
    the same arithmetic (``csrc/fused_rkc.cu``, ``Cheb``)."""
    hit = _TABLES.get(m)
    if hit is not None:
        return hit

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    mf = f32(float(m))
    w0 = D.ds_add_f(D.ds_div(D.ds(f32(2.0)), D.ds(13.0 * mf * mf)),
                    f32(1.0))
    two_w0 = D.ds_mul_f(w0, f32(2.0))
    w0c = D.ds_collapse(w0)
    temp1 = w0c * w0c - 1.0
    temp2 = torch.sqrt(temp1)
    arg = mf * torch.log(w0c + temp2)
    sinh_a, cosh_a = torch.sinh(arg), torch.cosh(arg)
    w1 = sinh_a * temp1 / (cosh_a * mf * temp2 - w0c * sinh_a)
    bj0 = D.ds_div(D.ds(f32(1.0)), D.ds_mul(two_w0, two_w0))
    mus0 = w1 * D.ds_collapse(bj0)

    table = torch.zeros(m + 1, 5, dtype=torch.float32)
    table[0, 0] = mus0
    thjm2, thjm1 = f32(0.0), mus0
    zjm2, zjm1 = D.ds(f32(1.0)), w0
    dzjm2, dzjm1 = D.ds(f32(0.0)), D.ds(f32(1.0))
    d2zjm2, d2zjm1 = D.ds(f32(0.0)), D.ds(f32(0.0))
    bjm2, bjm1 = bj0, bj0
    for j in range(2, m + 1):
        zj = D.ds_add(D.ds_mul(two_w0, zjm1), D.ds_neg(zjm2))
        dzj = D.ds_add(D.ds_add(D.ds_mul(two_w0, dzjm1), D.ds_neg(dzjm2)),
                       D.ds_mul_f(zjm1, f32(2.0)))
        d2zj = D.ds_add(D.ds_add(D.ds_mul(two_w0, d2zjm1),
                                 D.ds_neg(d2zjm2)),
                        D.ds_mul_f(dzjm1, f32(4.0)))
        bj = D.ds_div(d2zj, D.ds_mul(dzj, dzj))
        ajm1 = D.ds_add_f(D.ds_neg(D.ds_mul(zjm1, bjm1)), f32(1.0))
        mu = D.ds_div(D.ds_mul(two_w0, bj), bjm1)
        nu = D.ds_neg(D.ds_div(bj, bjm2))
        muc, nuc = D.ds_collapse(mu), D.ds_collapse(nu)
        ajc = D.ds_collapse(ajm1)
        mus = muc * w1 / w0c
        table[j] = torch.stack([muc, nuc, ajc, mus, thjm1])
        thj = muc * thjm1 + nuc * thjm2 + mus * (1.0 - ajc)
        thjm2, thjm1 = thjm1, thj
        zjm2, zjm1 = zjm1, zj
        dzjm2, dzjm1 = dzjm1, dzj
        d2zjm2, d2zjm1 = d2zjm1, d2zj
        bjm2, bjm1 = bjm1, bj
    _TABLES[m] = table
    return table


def _rho_mode(rho):
    """0: a float bound, 1: a callback, 2: the power iteration."""
    if rho is None:
        return 2
    return 1 if (callable(rho) or isinstance(rho, FusedRho)) else 0


def fused_rkc_reference(fun, t_span, y0, rho=None, params=None, rtol=1e-4,
                        atol=1e-6, first_step=None, max_steps=100_000,
                        m_max=None, const_jac=False, max_step=None,
                        t_eval=None):
    """The plain PyTorch version of the fused RKC kernels, on the device of
    ``y0``.

    ``y0`` is ``(B, *shape)``: B members integrated at once, each with its
    own step size, stage count, spectral-radius estimate and status; one
    member is B9's single grid.  Each loop iteration is one attempt of every
    running member, the stage loop runs to the largest m of the running
    members (a member keeps its carry past its own m), and the power
    iteration to the last running member's convergence.  The Chebyshev
    coefficients of each m come from :func:`_stage_table`.  ``fun`` is a
    :class:`FusedGridRHS` or its ``torch_fn``; ``rho`` a float, a callable
    or :class:`FusedRho` (``rho(t, y[, p])``), or None for the power
    iteration; ``params`` ``(B, k)``.

    Returns ``(y (B, *shape), status (B,), nsteps (B,), nfev (B,))``, with
    ``nfesig (B,)`` appended when ``rho is None``, and then, where
    ``t_eval`` is given, ``y_eval`` (B, len(t_eval), *shape) by each
    member's pending index (:class:`_Pending`).
    """
    f = fun.torch_fn if isinstance(fun, FusedGridRHS) else fun
    f32 = torch.float32
    y0 = torch.as_tensor(y0).to(f32)
    nb = y0.shape[0]
    shape = tuple(y0.shape[1:])
    ntot = int(np.prod(shape))
    dev = y0.device
    mode = _rho_mode(rho)
    power = mode == 2
    p = None
    if params is not None:
        p = torch.as_tensor(params, device=dev).to(f32).reshape(nb, -1).T
    rho_fn = rho.torch_fn if isinstance(rho, FusedRho) else rho

    def fn(t, y):
        return f(t, y) if p is None else f(t, y, p)

    def gsum(x):
        return x.reshape(ntot, nb).sum(0)

    def full(v):
        return torch.full((nb,), v, dtype=f32, device=dev)

    k = _rkc_consts()
    sqrtmin, sqrtu = k["sqrtmin"], k["sqrtu"]
    mmax, _ = _mmax_for(rtol, m_max)
    t0s, tfs = full(_f32(t_span[0])), full(_f32(t_span[1]))
    dir_s = torch.sign(tfs - t0s)
    rtol_s, atol_s = _f32(rtol), _f32(atol)
    mse = torch.abs(tfs - t0s)
    if max_step is not None:
        mse = torch.clamp(mse, max=_f32(max_step))
    small = 1.0 / mse

    y = y0.movedim(0, -1).contiguous()          # (*shape, B)
    y_lo = torch.zeros_like(y)
    f0 = fn(t0s, y)
    fv_cur = f0
    V = f0 * 1.0
    t, t_lo = t0s, torch.zeros_like(t0s)
    h_abs = full(-1.0 if first_step is None else _f32(first_step))
    h_prev, err_old, sprad = full(0.0), full(1.0), full(0.0)
    i32 = dict(dtype=torch.int32, device=dev)
    status = torch.full((nb,), RUNNING, **i32)
    nstep = torch.zeros(nb, **i32)
    nfev = torch.ones(nb, **i32)
    nfesig = torch.zeros(nb, **i32)
    newspc = torch.ones(nb, dtype=torch.bool, device=dev)
    jacatt = torch.zeros_like(newspc)
    nstsig = torch.zeros(nb, **i32)
    pend = None if t_eval is None else _Pending(_points(t_eval), y, dir_s,
                                                 t0s)
    it = 0
    while True:
        running = status == RUNNING
        if not bool(running.any()):
            break
        fcur = fv_cur

        # spectral radius
        rho_ok = torch.ones_like(running)
        jacatt_att = jacatt
        if power:
            active = newspc & running
            if bool(active.any()):
                sp, V_new, nev, ok = _rho_power(fn, t, y, fcur, V, active,
                                                small, sqrtu, k, gsum, ntot)
                sprad = torch.where(active, sp, sprad)
                V = V_new
                rho_ok = ok
                nfesig = nfesig + nev
                jacatt_att = jacatt | active
        elif mode == 0:
            sprad = full(_f32(rho))
            rho_ok = sprad == sprad
        else:
            r = rho_fn(t, y) if p is None else rho_fn(t, y, p)
            sprad = torch.as_tensor(r, device=dev).to(f32).expand(nb)
            rho_ok = sprad == sprad

        # the starting step on the first attempt
        need = (h_abs < 0.0) & running
        absh = h_abs
        if bool(need.any()):
            absh0 = torch.where(sprad * mse > 1.0, 1.0 / sprad, mse)
            absh0 = torch.clamp(absh0, min=sqrtmin)
            vtemp2 = fn(t + absh0, y + absh0 * fcur)
            wt = atol_s + rtol_s * torch.abs(y)
            est = absh0 * torch.sqrt(gsum(((vtemp2 - fcur) / wt) ** 2)
                                     / ntot)
            absh1 = torch.where(
                0.1 * absh0 < mse * torch.sqrt(est),
                torch.clamp(0.1 * absh0 / torch.sqrt(est), min=sqrtmin), mse)
            absh = torch.where(need, absh1, absh)
        nfev = nfev + need.to(torch.int32)

        # stage count and the m cap; a non-finite absh is clamped first
        d = torch.abs(tfs - t)
        absh = torch.where(1.1 * absh >= d, d, absh)
        absh = torch.where(torch.isfinite(absh), absh, mse)
        q = torch.sqrt(1.54 * absh * sprad + 1.0)
        hit_cap = q >= mmax
        qi = torch.where(q == q, torch.clamp(q, max=mmax), 0.0)
        m = torch.where(hit_cap, mmax, 1 + qi.to(torch.int32))
        m = torch.clamp(m, 2, mmax).to(torch.int32)
        mf = m.to(f32)
        absh = torch.where(hit_cap, (mf * mf - 1.0) / (1.54 * sprad), absh)
        h = dir_s * absh
        hmin = torch.clamp(k["hmin_c"] * (torch.abs(t) + absh)
                           * (mf * mf - 1.0), min=sqrtmin)

        # the stages in deviation form
        e_m = _stages(fn, t, y, y_lo, fcur, h, m, running)
        yk = y + (y_lo + e_m)
        f_new = fn(t + h, yk)
        nfev = nfev + torch.where(running, m, 0).to(torch.int32)

        wt = atol_s + rtol_s * torch.maximum(torch.abs(y), torch.abs(yk))
        est = -0.8 * e_m + 0.4 * h * (fcur + f_new)
        err = torch.sqrt(gsum((est / wt) ** 2) / ntot)
        bad = ~torch.isfinite(err)
        err = torch.where(bad, 10.0, err)
        accepted = (err < 1.0) & ~bad & running

        cbrt_e = torch.pow(torch.clamp(err, min=1e-30), 1.0 / 3.0)
        absh_rej = 0.8 * absh / cbrt_e
        too_small = ~accepted & (absh_rej < hmin)

        # H220 dead-beat controller (sommeijer.py:253-266)
        fac_first = torch.where(0.8 < 10.0 * cbrt_e, 0.8 / cbrt_e, 10.0)
        temp1 = 0.8 * absh * torch.pow(torch.clamp(err_old, min=1e-30),
                                       1.0 / 3.0)
        temp2 = torch.abs(h_prev) * torch.pow(torch.clamp(err, min=1e-30),
                                              2.0 / 3.0)
        fac_next = torch.where(temp1 < 10.0 * temp2,
                               temp1 / torch.clamp(temp2, min=1e-30), 10.0)
        fac = torch.where(h_prev == 0.0, fac_first, fac_next)
        absh_acc = torch.clamp(fac, min=0.1) * absh
        absh_acc = torch.maximum(hmin, torch.minimum(mse, absh_acc))

        is_last = accepted & (absh >= d)
        t_adv, t_lo_adv = _df_add(t, t_lo, h)
        y_hi_new, y_lo_new = D.ds_add_f((y, y_lo), e_m)
        if pend is not None:
            pend.step(accepted, torch.where(is_last, tfs, t_adv), t, t_lo,
                      h, y, fcur, yk, f_new)

        st = torch.where(bad, OVERFLOW,
                         torch.where(too_small, TOO_SMALL_STEP,
                                     torch.where(is_last, FINISHED, status)))
        st = torch.where(rho_ok, st, RHO_FAIL)
        it += 1
        st = torch.where((st == RUNNING) & (it >= max_steps), OVERFLOW, st)
        status = torch.where(running, st, status).to(torch.int32)

        if power:
            # refresh policy after the attempt (steppers/rkc.py:513-517)
            nstsig = torch.where(accepted, torch.remainder(nstsig + 1, 25),
                                 nstsig).to(torch.int32)
            newspc = torch.where(
                running, torch.where(accepted, (nstsig == 0) & (not const_jac),
                                     ~jacatt_att), newspc)
            jacatt = torch.where(running, torch.where(accepted, const_jac,
                                                      jacatt_att), jacatt)

        t = torch.where(accepted, torch.where(is_last, tfs, t_adv), t)
        t_lo = torch.where(accepted, torch.where(is_last, 0.0, t_lo_adv),
                           t_lo)
        y = torch.where(accepted, y_hi_new, y)
        y_lo = torch.where(accepted, y_lo_new, y_lo)
        fv_cur = torch.where(accepted, f_new, fcur)
        h_abs = torch.where(running, torch.where(accepted, absh_acc,
                                                 absh_rej), h_abs)
        h_prev = torch.where(accepted, h, h_prev)
        err_old = torch.where(accepted, err, err_old)
        nstep = nstep + accepted.to(torch.int32)

    out = (y.movedim(-1, 0).contiguous(), status, nstep, nfev)
    if power:
        out = out + (nfesig,)
    return out if pend is None else out + (pend.rows(y),)


class _Pending:
    """The plain version's t_eval rows by JAX's pending index
    (``fused_rkc.py:_integrate``, :494-513, :570-584, :605-616): each
    member's index ``iq`` into the points in t_eval's order moves past
    every point at or before the time it reached (``dir tq <= dir t``),
    writing its row as it goes: y0 at t0, the unclamped cubic Hermite of an
    accepted step's end pairs (``fused_rkc.py:_hermite``, its terms summed
    in that order) at ``theta = ((tq - t) - t_lo) / h``; every point from
    ``iq`` on takes the final y.  Over the plain loop's ``(*shape, B)``
    grids, the members' rows scattered at their own indices."""

    def __init__(self, tq, y0, direction, t0):
        self.nq = len(tq)
        self.tq = torch.from_numpy(tq).to(y0.device)
        self.d = direction
        nb = y0.shape[-1]
        self.flat = y0.numel() // nb
        self.y = y0.new_zeros(self.nq, self.flat, nb)
        self.iq = torch.zeros(nb, dtype=torch.long, device=y0.device)
        self.step(torch.ones(nb, dtype=torch.bool, device=y0.device), t0,
                  None, None, None, y0, None, None, None)

    def step(self, upd, t_end, t, t_lo, h, y, f, yk, f_new):
        """Move the index of each member in ``upd`` past the points at or
        before ``t_end``, writing each one's row: y where ``h`` is None (the
        start), else the Hermite of the step from ``(t, t_lo)`` of signed
        size ``h`` with end pairs ``(y, f)``, ``(yk, f_new)``."""
        nb = self.iq.shape[0]
        cols = torch.arange(nb, device=self.iq.device)
        while self.nq:
            i = self.iq.clamp(max=self.nq - 1)
            tqi = self.tq[i]
            cross = upd & (self.iq < self.nq) & (self.d * tqi
                                                 <= self.d * t_end)
            if not bool(cross.any()):
                return
            if h is None:
                val = y
            else:
                th = ((tqi - t) - t_lo) / h
                t2 = th * th
                t3 = t2 * th
                val = (y * (2.0 * t3 - 3.0 * t2 + 1.0)
                       + (h * (t3 - 2.0 * t2 + th)) * f
                       + yk * (3.0 * t2 - 2.0 * t3)
                       + (h * (t3 - t2)) * f_new)
            b = cols[cross]
            self.y[self.iq[b], :, b] = val.reshape(self.flat, nb)[:, b].T
            self.iq = self.iq + cross.long()

    def rows(self, y):
        """``y_eval`` (B, nq, *shape): the points from each member's index
        on take its final ``y`` (``(*shape, B)``)."""
        nb = y.shape[-1]
        left = (torch.arange(self.nq, device=y.device)[:, None]
                >= self.iq[None, :])[:, None, :]
        rows = torch.where(left, y.reshape(1, self.flat, nb), self.y)
        return rows.permute(2, 0, 1).reshape(nb, self.nq,
                                             *y.shape[:-1]).contiguous()


def _rho_power(fn, t, yn, fn0, V, active, small, sqrtu, k, gsum, ntot):
    """The nonlinear power iteration (sommeijer.py:331-398, the JAX
    kernel's ``_rho_power``) for the members in ``active``, each with its
    own convergence and its own sign flip of component ``i mod n`` in the
    degenerate case.  Returns (sprad, V_new, n_evals, ok); a member that
    does not converge in 50 iterations has sprad 0 and ok False, and an
    inactive one keeps V and ok True."""
    ynrm = torch.sqrt(gsum(yn * yn))
    vnrm = torch.sqrt(gsum(V * V))
    both = (ynrm != 0.0) & (vnrm != 0.0)
    only_y = (ynrm != 0.0) & (vnrm == 0.0)
    only_v = (ynrm == 0.0) & (vnrm != 0.0)
    dynrm = torch.where(both | only_y, ynrm * sqrtu,
                        torch.full_like(ynrm, k["rho_uround"]))
    vs = dynrm / torch.where(vnrm == 0.0, 1.0, vnrm)
    v = torch.where(both, yn + V * vs,
                    torch.where(only_y, V * k["one_p_sqrtu"],
                                torch.where(only_v, V * vs,
                                            dynrm.expand_as(V))))
    sigma = torch.zeros_like(ynrm)
    sprad = torch.zeros_like(ynrm)
    done = ~active
    nev = torch.zeros(ynrm.shape, dtype=torch.int32, device=yn.device)
    flat_shape = (ntot, ynrm.shape[0])
    for i in range(ITMAX):
        if bool(done.all()):
            break
        live = ~done
        fv = fn(t, v)
        nev = nev + live.to(torch.int32)
        df = fv - fn0
        dfnrm = torch.sqrt(gsum(df * df))
        sigma_new = dfnrm / dynrm
        conv = (i > 0) & (torch.abs(sigma_new - sigma)
                          <= torch.maximum(sigma_new, small) * 0.01)
        v_pow = yn + df * (dynrm / torch.where(dfnrm == 0.0, 1.0, dfnrm))
        v_deg = v.reshape(flat_shape).clone()
        v_deg[i % ntot] = -v_deg[i % ntot]
        v_next = torch.where(dfnrm != 0.0, v_pow, v_deg.reshape(v.shape))
        v = torch.where(live & ~conv, v_next, v)
        sigma = torch.where(live, sigma_new, sigma)
        sprad = torch.where(live & conv, 1.2 * sigma_new, sprad)
        done = done | (live & conv)
    return (sprad, torch.where(active & done, v - yn, V), nev,
            done | ~active)


def _stages(fn, t, y, y_lo, f, h, m, running):
    """The Chebyshev stages in deviation form (the JAX kernel's
    ``stages``, ``fused_rkc.py:257-336``) for every member at its own m;
    returns e_m = y_m - y_n, shape ``(*shape, B)``."""
    nb = m.shape[0]
    ms = m.tolist()
    m_top = max(mi for mi, r in zip(ms, running.tolist()) if r)
    table = torch.zeros(nb, m_top + 1, 5, dtype=torch.float32)
    for b, mi in enumerate(ms):
        rows = _stage_table(mi)[:m_top + 1]
        table[b, :rows.shape[0]] = rows
    table = table.to(f.device)
    ejm2 = torch.zeros_like(f)
    ejm1 = (h * table[:, 0, 0]) * f
    for j in range(2, m_top + 1):
        act = (j <= m) & running
        muc, nuc, ajc, mus, th = table[:, j].unbind(1)
        fj = fn(t + h * th, y + (y_lo + ejm1))
        ej = muc * ejm1 + nuc * ejm2 + (h * mus) * (fj - ajc * f)
        ejm2, ejm1 = torch.where(act, ejm1, ejm2), torch.where(act, ej, ejm1)
    return ejm1


# -- the wrappers and the kernels --------------------------------------------

# (build key, rho mode, device index) -> B9's (blocks, placement, bytes)
_GRIDS = {}
# (build key, rho mode, device index) -> {C: B10's clusters resident at once}
_CLUSTERS = {}


def _cluster_size(members, max_clusters):
    """B10's cluster size for ``members`` grids.  Of the C in 8, 4 and 2 of
    which the card holds clusters at all (``max_clusters[C]``, the card's
    ``cudaOccupancyMaxActiveClusters``, 0 where a CTA's chunk of the six
    elementwise arrays does not fit its shared memory; a cluster may not
    span GPCs), the largest whose ``members`` clusters are all resident at
    once; where there are more members than that, the smallest such C, its
    clusters in waves; where there is none, 1: one block per member with
    the arrays in global memory.

    On an H100 (132 SMs, 700 W; 66, 30 and 15 clusters of 2, 4 and 8
    resident at 2x64x128, 0, 30 and 15 at 2x128x128;
    ``tools/probe_fused_rkc.py``, PERF.md section 6), config 5d's 2x64x128
    members, device ms at C = 8 / 4 / 2 / 1: 8 members 3.43 / 4.48 / 6.57
    / 13.47; 64: 14.43 / 11.15 / 6.49 / 13.50; 256 (C = 2 in four waves):
    50.75 / 34.03 / 23.63 / 48.56.  At 2x128x128: 16 members 7.87 / 6.67 /
    - / 25.39; 128 (C = 4 in five waves): 34.26 / 28.73 / - / 55.51."""
    held = [c for c in CLUSTER_SIZES if int(max_clusters.get(c, 0)) > 0]
    if int(members) < 1 or not held:
        return 1
    for c in held:
        if int(members) <= int(max_clusters[c]):
            return c
    return held[-1]


def _max_clusters(built, rho, device):
    """{C: clusters of B10 resident at once} on ``device`` for each of
    :data:`CLUSTER_SIZES`, from the kernel library (0 where a CTA's chunk
    does not fit the card's shared memory); raises on a CUDA error."""
    import ctypes
    with torch.cuda.device(device):
        dev = torch.cuda.current_device()
        key = (built.key, _rho_mode(rho), dev)
        hit = _CLUSTERS.get(key)
        if hit is None:
            hit = {}
            for c in CLUSTER_SIZES:
                n, nbytes = ctypes.c_int(0), ctypes.c_int(0)
                rc = built.lib.fused_rkc_cluster_capacity(
                    _rho_mode(rho), BLOCK_THREADS, c, ctypes.byref(n),
                    ctypes.byref(nbytes))
                if rc != 0:
                    raise RuntimeError(f"fused_rkc: cluster occupancy query "
                                       f"failed at C = {c}: CUDA error {rc}")
                hit[c] = n.value
            _CLUSTERS[key] = hit
    return hit


def _kernel(fun, rho, n_par, snap=False):
    """The kernel built for one FusedGridRHS, rho callback and parameter
    count, with the t_eval snapshots where ``snap`` (a build of its own).
    A float rho or None is a launch argument, not a build."""
    cb = rho if isinstance(rho, FusedRho) else None
    from . import _build
    return _build.cached(
        "fused_rkc", (fun, cb),
        lambda: _build.load_fused_rkc(fun.shape, n_par, fun.cuda_src,
                                      None if cb is None else cb.cuda_src,
                                      snap),
        (n_par, bool(snap)))


def _points(t_eval):
    """``t_eval`` as ``fused_erk.eval_points`` takes it (float32, in its
    own order, which the JAX kernels keep), but an empty one as no points
    rather than None: JAX's RKC kernels return an empty ``y_eval`` for
    it."""
    if t_eval is None:
        return None
    tq = eval_points(t_eval)
    return np.zeros(0, np.float32) if tq is None else tq


def _outputs(out, rho):
    """The launch's (y, status, nsteps, nfev, nfesig[, y_eval]) in JAX's
    order: ``nfesig`` only for the power iteration (``rho`` None), then
    ``y_eval`` where there are t_eval points."""
    return out[:4] + ((out[4],) if rho is None else ()) + tuple(out[5:])


def _check_card_inputs(name, fun, rho, y0, lead):
    """``y0`` must be float32 of shape ``lead + fun.shape``."""
    if not isinstance(fun, FusedGridRHS):
        raise TypeError(f"{name} on a CUDA tensor needs a FusedGridRHS (a "
                        "CUDA source of the right-hand side); got "
                        f"{type(fun).__name__}")
    if callable(rho) and not isinstance(rho, FusedRho):
        raise TypeError(f"{name} on a CUDA tensor takes a callable rho as a "
                        "FusedRho (with its CUDA source)")
    if y0.dtype != torch.float32:
        raise TypeError(f"y0 must be float32, got {y0.dtype}")
    shape = tuple(lead) + tuple(fun.shape)
    if tuple(y0.shape) != shape:
        raise ValueError(f"y0 must have shape {shape}, got "
                         f"{tuple(y0.shape)}")


def _launch(built, grid, rho, y0, params, n_members, t_span, rtol, atol,
            first_step, max_steps, m_max, const_jac, max_step, threads,
            blocks, cluster=1, tq=None):
    """Allocate the outputs and the workspace and launch B9 (``grid`` 1:
    the elementwise arrays in global memory, 2: in the blocks' shared
    memory) or B10 (``grid`` 0: a cluster of ``cluster`` CTAs per member,
    or one block at 1) on the current stream, with the rows of the t_eval
    points ``tq`` (:func:`_points`; ``built`` the snapshot build where
    there are any); returns (y, status, nsteps, nfev, nfesig), with
    ``y_eval`` (members, nq, *shape) after them where ``tq`` is given, the
    member axis first."""
    dev = y0.device
    ntot = int(np.prod(y0.shape[1:]))
    mode = _rho_mode(rho)
    mmax, _ = _mmax_for(rtol, m_max)
    t0, tf = _f32(t_span[0]), _f32(t_span[1])
    y_out = torch.empty_like(y0)
    ints = [torch.empty(n_members, dtype=torch.int32, device=dev)
            for _ in range(4)]
    work = torch.empty(n_members * N_ARRAYS * ntot, dtype=torch.float32,
                       device=dev)
    # B9: the blocks' sums and the grid barrier's counter
    partials = torch.empty(2 * max(blocks, 1) + 1, dtype=torch.float32,
                           device=dev)
    out = (y_out, *ints)
    nq = 0 if tq is None else len(tq)
    if tq is not None:
        y_eval = y0.new_empty(n_members, nq, *y0.shape[1:])
        out = out + (y_eval,)
    if n_members == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (int(grid), mode, y0.data_ptr(),
                None if params is None else params.data_ptr(),
                y_out.data_ptr(), *[x.data_ptr() for x in ints],
                work.data_ptr(), partials.data_ptr(), n_members, t0, tf,
                float(np.sign(tf - t0)), _f32(rtol), _f32(atol),
                -1.0 if first_step is None else _f32(first_step),
                _f32(rho) if mode == 0 else 0.0,
                np.inf if max_step is None else _f32(max_step), mmax,
                int(max_steps), int(bool(const_jac)), int(threads),
                int(blocks), int(cluster))
        if nq:
            points = torch.from_numpy(tq).to(dev)
            rc = built.lib.fused_rkc_snap_launch(
                *args, points.data_ptr(), y_eval.data_ptr(), nq, stream)
        else:
            rc = built.lib.fused_rkc_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_rkc kernel launch failed: CUDA error {rc}")
    return out


# B9's placements of the six elementwise arrays (the launch's ``grid``)
GLOBAL, SHARED = 1, 2


def _grid_shape(built, fun, rho, device):
    """B9's launch shape for ``fun`` on ``device``: ``(blocks, placement,
    shared memory bytes per block)``.  One block of :data:`GRID_THREADS`
    per SM, at most one thread per grid element and no more blocks than
    are resident at once (the occupancy times the SM count), or the launch
    would be refused; the elementwise arrays in each block's shared memory
    (:data:`SHARED`) where its threads' share fits and the card still
    holds every block, else in global memory (:data:`GLOBAL`, 0 bytes)."""
    import ctypes
    with torch.cuda.device(device):
        dev = torch.cuda.current_device()
        key = (built.key, _rho_mode(rho), dev)
        shape = _GRIDS.get(key)
        if shape is None:
            mode = _rho_mode(rho)
            cap = ctypes.c_int(0)
            rc = built.lib.fused_rkc_grid_capacity(
                mode, GRID_THREADS, ctypes.byref(cap))
            if rc != 0 or cap.value < 1:
                raise RuntimeError(f"fused_rkc: no resident grid of blocks "
                                   f"of {GRID_THREADS} (CUDA error {rc})")
            need = -(-int(np.prod(fun.shape)) // GRID_THREADS)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            blocks = min(cap.value, sms, need)
            nbytes, fits = ctypes.c_int(0), ctypes.c_int(0)
            rc = built.lib.fused_rkc_grid_smem(
                mode, GRID_THREADS, blocks, ctypes.byref(nbytes),
                ctypes.byref(fits))
            if rc != 0:
                raise RuntimeError(f"fused_rkc: shared memory query failed: "
                                   f"CUDA error {rc}")
            shape = _GRIDS[key] = ((blocks, SHARED, nbytes.value)
                                   if fits.value else (blocks, GLOBAL, 0))
    return shape


def _launch_grid(fun, t_span, y0, rho, placement=None, rtol=1e-4,
                 atol=1e-6, first_step=None, max_steps=100_000, m_max=None,
                 const_jac=False, max_step=None, t_eval=None):
    """B9 on the card in ``placement`` (:data:`SHARED` or :data:`GLOBAL`;
    None: :func:`_grid_shape`'s), with the rows of ``t_eval`` (the build
    with the snapshots where it has points).  Returns the five outputs of
    the one member (and ``y_eval`` (nq, *shape) sixth where ``t_eval`` is
    given) and the shape ``(blocks, placement, bytes)`` taken."""
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, m_max=m_max, const_jac=const_jac,
              max_step=max_step)
    tq = _points(t_eval)
    built = _kernel(fun, rho, 0, tq is not None and len(tq) > 0)
    blocks, rule, nbytes = _grid_shape(built, fun, rho, y0.device)
    placement = placement or rule
    if placement == SHARED and rule != SHARED:
        raise ValueError("fused_rkc: a block's share of the arrays does not "
                         "fit its shared memory on this grid")
    out = _launch(built, placement, rho, y0.contiguous()[None], None, 1,
                  t_span, threads=GRID_THREADS, blocks=blocks, tq=tq, **kw)
    return (tuple(x[0] for x in out),
            (blocks, placement, nbytes if placement == SHARED else 0))


def solve_fused_rkc(fun, t_span, y0, rho=None, rtol=1e-4, atol=1e-6,
                    first_step=None, max_steps=100_000, m_max=None,
                    t_eval=None, events=None, const_jac=False, max_step=None):
    """Integrate one stiff semi-discretized system in one kernel launch (B9).

    ``y0``: float32 grid of ``fun.shape`` (e.g. ``(2, ny, nx)``), not
    flattened.  ``rho``: a float bound of the Jacobian's spectral radius, a
    callback (a :class:`FusedRho` on the card), or ``None`` for the
    nonlinear power iteration (re-estimated on the first step, after
    rejections and every 25 accepted steps; ``const_jac=True`` keeps the
    first estimate).  ``m_max`` overrides the stage cap, ``max_step`` caps
    |h|, ``max_steps`` caps attempts (status 3).

    Returns ``(y_final, status, nsteps, nfev)``, with ``nfesig`` (the power
    iteration's RHS evaluations) appended when ``rho is None``; status 1 =
    finished, 2 = step size underflow, 3 = overflow or step cap, 6 = the
    power iteration did not converge.

    ``t_eval``: times (taken as float32, in the order given) at which to
    return the grid, ``y_eval`` (len(t_eval), *shape) last, as JAX's kernel
    writes it (the module docstring): points at or before t0 take y0,
    those the integration reaches the cubic Hermite of the accepted step
    that reaches each, from the first point out of order (or NaN) on the
    final y.  It leaves the other outputs bit for bit as they are without
    it.

    A ``y0`` that is not a tensor goes to the card as float32 (and raises
    where there is none).  On a CUDA tensor ``fun`` must be a
    :class:`FusedGridRHS`, and the call launches ``csrc/fused_rkc.cu``'s
    grid kernel cooperatively (one block of 512 threads per SM, each
    block's share of the elementwise arrays in its shared memory where it
    fits, :func:`_grid_shape`; the ``(blocks, placement, bytes)`` taken is
    left in ``solve_fused_rkc.last_shape``), or raises; a refused
    cooperative launch raises too.  On a CPU tensor it runs
    :func:`fused_rkc_reference`.

    ``events`` is not ported yet.
    """
    check_options("solve_fused_rkc", "B9", events=events)
    y0 = as_input(y0, torch.float32)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, m_max=m_max, const_jac=const_jac,
              max_step=max_step, t_eval=t_eval)
    if y0.device.type != "cuda":
        out = fused_rkc_reference(fun, t_span, y0[None], rho=rho, **kw)
        return tuple(x[0] for x in out)
    _check_card_inputs("solve_fused_rkc", fun, rho, y0, ())
    out, shape = _launch_grid(fun, t_span, y0, rho, **kw)
    solve_fused_rkc.launches += 1
    solve_fused_rkc.last_shape = shape
    return _outputs(out, rho)


def solve_fused_rkc_ensemble(fun, t_span, y0, rho=None, params=None,
                             rtol=1e-4, atol=1e-6, first_step=None,
                             max_steps=100_000, m_max=None, t_eval=None,
                             events=None, const_jac=False, max_step=None):
    """Integrate an ensemble of stiff PDE grids in one kernel launch (B10).

    ``y0``: ``(n_members, *fun.shape)`` float32, each member with its own
    adaptive step-size control, stage counts, spectral-radius estimate and
    status; ``params``: optional ``(n_members, k)`` per-member parameters,
    reaching ``fun`` (and a ``rho`` callback) as ``p``.  ``rho`` as in
    :func:`solve_fused_rkc`, the power iteration per member.  Each member
    takes the steps :func:`solve_fused_rkc` takes on it alone.

    Returns ``(y_final, status, nsteps, nfev[, nfesig])``, per-member
    arrays.  On a CUDA tensor the call launches a thread-block cluster of C
    CTAs of 1024 threads per member, C from :func:`_cluster_size` (all
    members' clusters resident at once, each CTA's chunk of the member's
    elementwise arrays in its shared memory), or one block of 1024 threads
    per member where no C > 1 qualifies; it raises where the launch is
    refused.  The C taken is left in ``solve_fused_rkc_ensemble.cluster``.
    On a CPU tensor it runs :func:`fused_rkc_reference`.

    ``t_eval``: as in :func:`solve_fused_rkc`, each member by its own
    pending index; ``y_eval`` (n_members, len(t_eval), *fun.shape) last,
    the member axis first as in JAX.  ``events`` is not ported yet.
    """
    check_options("solve_fused_rkc_ensemble", "B10", events=events)
    y0 = as_input(y0, torch.float32)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, m_max=m_max, const_jac=const_jac,
              max_step=max_step, t_eval=t_eval)
    if params is not None:
        params = torch.as_tensor(params, device=y0.device).to(torch.float32)
        if params.ndim != 2 or params.shape[0] != y0.shape[0]:
            raise ValueError("params must be (n_members, k)")
    if y0.device.type != "cuda":
        return fused_rkc_reference(fun, t_span, y0, rho=rho, params=params,
                                   **kw)
    _check_card_inputs("solve_fused_rkc_ensemble", fun, rho, y0,
                       y0.shape[:1])
    out, c = _launch_ensemble(fun, t_span, y0, rho, params, None, **kw)
    solve_fused_rkc_ensemble.launches += 1
    solve_fused_rkc_ensemble.cluster = c
    return _outputs(out, rho)


def _launch_ensemble(fun, t_span, y0, rho, params, cluster, rtol=1e-4,
                     atol=1e-6, first_step=None, max_steps=100_000,
                     m_max=None, const_jac=False, max_step=None,
                     t_eval=None):
    """B10 on the card: a cluster of ``cluster`` CTAs per member (None: the
    C of :func:`_cluster_size`; 1: one block per member), with the rows of
    ``t_eval`` (the build with the snapshots where it has points).  Returns
    the five outputs (and ``y_eval`` sixth where ``t_eval`` is given) and
    the C taken."""
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, m_max=m_max, const_jac=const_jac,
              max_step=max_step)
    n_par = 0 if params is None else params.shape[1]
    tq = _points(t_eval)
    built = _kernel(fun, rho, n_par, tq is not None and len(tq) > 0)
    c = cluster or _cluster_size(y0.shape[0],
                                 _max_clusters(built, rho, y0.device))
    out = _launch(built, 0, rho, y0.contiguous(),
                  None if params is None else params.contiguous(),
                  y0.shape[0], t_span, threads=BLOCK_THREADS, blocks=0,
                  cluster=c, tq=tq, **kw)
    return out, c


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_rkc.launches = 0
solve_fused_rkc_ensemble.launches = 0
# B9's (blocks, placement, shared memory bytes per block) at its last launch
solve_fused_rkc.last_shape = None
# B10's cluster size at its last launch
solve_fused_rkc_ensemble.cluster = 0
