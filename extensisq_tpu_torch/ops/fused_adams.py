"""Fused SWAG ensemble solver: the whole variable-order Adams PECE
integration in one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_adams.py``.  The kernel
(``csrc/fused_adams.cu``) runs a group of G = 8, 16 or 32 lanes of one
warp per member, or one thread per member (G from
:func:`_lanes_per_member`), and keeps the member's whole multistep state
in registers: lane r holds the rows r, r + G, ... of the scaled divided
differences ``phi`` and the same elements of the coefficient vectors
psi/alpha/beta/sig/v/w/g; every lane holds the order ``k``, the counters
and the state.  Its plain PyTorch version,
:func:`fused_adams_reference`, runs the same loop on rows-first
``(n, B)`` float32 tensors, with the block-1 coefficient update of the
port's own stepper (:meth:`AdamsStepper._coefficients` in float32); the
wrapper :func:`solve_fused_adams` takes it only for tensors on the CPU.

As in the JAX package, each member's starting state (its starting step,
``f(t0, y0)`` and ``nfev``) comes from the float32 stepper's ``init``
run outside the kernel, here as torch operations on the device of
``y0``; with per-member ``params`` the init runs on the function with
every member's parameters bound, on the whole batch at once.

``dense=R`` records each member's accepted steps for a continuous dense
output (``ops/fused_dense.py``), as JAX's SWAG kernels record them: the
end ``(t, y, f)`` of each accepted step, and the near-end extrapolation as
a node at ``tf`` with the extrapolated ``y`` and the ``f`` of the step
before it; ``f0`` is the starting state's ``f(t0, y0)``; in compensated
mode the rows hold the high word of ``y``.

``t_eval`` returns each member's y at the given times, written inside the
kernel as the member crosses each (``csrc/snapshot.cuh``), as JAX's SWAG
kernels write them: at an accepted step the cubic Hermite of the step's
end pairs ``(y, f)``, and at the near-end extrapolation JAX's straight
line ``y + (tq - t) f`` for the points up to ``tf``; ``t`` and ``y`` the
high words in compensated mode.

What both compute per attempt (the JAX kernel's semantics): the ns reset
on ``h != hold``, the coefficient update, the predictor (with a
Neumaier-compensated ``g . phi`` sum in compensated mode), the error
estimates at orders k-2, k-1, k and the new order, the failure restore
with the ``ifail >= 3 / 4`` rules, the corrector, the phi update, the
order selection and the step ratio.  Time is carried in double-single in
both modes with a ``4 * 2^-30 |t|`` minimum-step floor, and the landing
on ``tf`` tests the double-single remainder.  ``compensated=True`` also
carries ``y`` in double-single, the whole step increment entering the
``(hi, lo)`` pair; the phi tables stay float32.

Non-finite values: a non-finite error estimate rejects the attempt, as in
the JAX kernel.  A member whose starting state or step is not finite, or
whose accepted step gives a non-finite ``y`` or ``f``, ends with status 3
and leaves its neighbours unharmed (the JAX kernel scrubs such values to
1 and runs on).
"""
import types

import numpy as np
import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW
from .._device import as_input
from ..steppers.adams import AdamsStepper, _GSTR, _put, _rows, _take
from ..types import IVPParams
from .fused_erk import (DenseRecord, FusedRHS, SnapPoints, Snapshots,
                        _Record, _df_add, _launch_shape, _two_sum,
                        bind_params, check_options, dense_rows, eval_points,
                        member_params, snap_outputs)

_EPS32 = float(np.finfo(np.float32).eps)
# the double-single t carry resolves ~2^-46, so the minimum step is
# 4 * 2^-30 |t| rather than the bare-float32 floor
FOURU_T = 4.0 * 2.0 ** -30
# landing on tf: the double-single remainder within 8 ulps of h
LAND_TOL = 8.0 * _EPS32
# work counters per member (the kernel's and fused_adams_reference's)
_WORK = 5


def _f32(x):
    return float(np.float32(x))


def _adams_consts(km, n):
    """Static data of the kernel for ``k_max = km`` and state size ``n``,
    as the JAX kernel rounds it to float32 (``fused_adams.py:182-183``,
    ``:608-610``)."""
    return {"km": km, "n": n,
            "gstr": [_f32(v) for v in _GSTR],
            "iqq": [_f32(1.0 / (q * (q + 1.0))) for q in range(1, km + 2)],
            "two": [_f32(2.0 ** (q + 1)) for q in range(km + 2)],
            "inv_n": _f32(1.0 / n), "fouru_t": FOURU_T,
            "land_tol": LAND_TOL}


def _host_init(fun, t_span, y, rtol, atol, first_step, k_max, max_step):
    """Every member's starting state from the float32 stepper's ``init``
    (JAX ``fused_adams.py:203-228``) on the rows-first ``y`` (n, B).
    Returns (stepper, state, direction)."""
    t0, tf = _f32(t_span[0]), _f32(t_span[1])
    direction = float(np.sign(float(t_span[1]) - float(t_span[0])) or 1.0)
    params = IVPParams(
        t_bound=tf, direction=direction, rtol=_f32(rtol), atol=_f32(atol),
        max_step=(float(np.finfo(np.float32).max) if max_step is None
                  else _f32(max_step)))
    stepper = AdamsStepper(fun, y.shape[0], torch.float32,
                           options={"k_max": k_max})
    return stepper, stepper.init(t0, y, params, first_step=first_step), \
        direction


def _finite_rows(x):
    """(B,) mask of members whose rows of ``x`` (rows, ..., B) are all
    finite."""
    return torch.isfinite(x).reshape(-1, x.shape[-1]).all(0)


def _member_norm(x):
    """RMS over the state rows in the kernel's order: the squares summed
    one row after another, times 1/n."""
    acc = torch.zeros_like(x[0])
    for r in x:
        acc = acc + r * r
    return torch.sqrt(acc * (1.0 / x.shape[0]))


def fused_adams_reference(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                          first_step=None, k_max=12, max_steps=200_000,
                          compensated=False, max_step=None, params=None,
                          dense=None, work=None, t_eval=None):
    """The plain PyTorch version of the fused SWAG kernel, on the device of
    ``y0_batch``.

    Runs the kernel's loop for the whole batch at once in float32: each
    iteration is one attempt (or the near-end extrapolation) of every
    running member, and the loop ends once no member is RUNNING or after
    ``max_steps`` iterations.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function, called as ``fun(t, y, p)`` where
    ``params`` (B, k) is given.  Returns ``(y (B, n), status (B,), nsteps
    (B,), nfev (B,))`` like :func:`solve_fused_adams`; with ``t_eval`` the
    rows ``y_eval`` (len(t_eval), B, n) after them, and with ``dense=R``
    the members' :class:`~.fused_dense.FusedDenseSolution` last, from the
    rows the kernel writes.

    ``work``, a (B, 5) integer tensor, receives the kernel's work counters
    of each member: its attempts, and over them the sums of the order k,
    of k where the step was accepted, of the coefficient elements updated
    (k - ns where k >= ns) and of the element steps of the v update and
    the g loop (k - ns + 1 where ns > 1, plus (k - ns) (k - ns + 1) / 2).
    """
    y0 = torch.as_tensor(y0_batch)
    fun = bind_params(fun, member_params(params, y0, fun))
    return run_adams_loop(fun, t_span, y0, rtol, atol, first_step,
                          k_max, max_steps, compensated, max_step,
                          _member_norm, work, dense, t_eval)


def run_adams_loop(fun, t_span, y0_batch, rtol, atol, first_step, k_max,
                   max_steps, compensated, max_step, member_norm, work=None,
                   dense=None, t_eval=None):
    """The fused SWAG loop on the rows-first torch function ``fun`` (the
    members' parameters bound), shared by the plain versions of B3 and B8;
    ``member_norm`` maps ``(n, B)`` to the members' RMS norms in the order
    of the kernel's sums, ``work`` (None or (B, 5)) receives the work
    counters of :func:`fused_adams_reference`, ``t_eval`` adds the rows
    ``y_eval`` (len(t_eval), B, n) after the four outputs (JAX's rule,
    ``fused_erk.Snapshots``: the Hermite at an accepted step, the straight
    line at the near-end extrapolation) and ``dense=R`` the dense output
    of the rows the kernels record last."""
    km = int(k_max)
    y = torch.as_tensor(y0_batch).to(torch.float32).T.contiguous()
    n, nb = y.shape
    dev = y.device
    K = _adams_consts(km, n)
    stepper, s0, dirs = _host_init(fun, t_span, y, rtol, atol, first_step,
                                   km, max_step)
    atol_f, rtol_f = _f32(atol), _f32(rtol)
    h_max = np.inf if max_step is None else _f32(max_step)
    gstr = torch.tensor(K["gstr"], dtype=torch.float32, device=dev)
    two = torch.tensor(K["two"], dtype=torch.float32, device=dev)
    idx_r = torch.arange(km + 2, device=dev)[:, None]
    idx_k = torch.arange(km, device=dev)[:, None]

    def clip(i, hi):
        return torch.clamp(i, 0, hi)

    tf = torch.full((nb,), _f32(t_span[1]), device=dev)
    t, t_lo = s0.t, torch.zeros_like(s0.t)
    h, hold = s0.h, s0.hold
    y_lo = torch.zeros_like(y)
    yp, phi = s0.yp, s0.phi
    psi, alpha, beta, sig = s0.psi, s0.alpha, s0.beta, s0.sig
    v, w, g, gi, iv = s0.v, s0.w, s0.g, s0.gi, s0.iv
    k, kold, kprev, ns = s0.k, s0.kold, s0.kprev, s0.ns
    ivc, kgi, phase1 = s0.ivc, s0.kgi, s0.phase1
    nfev, nsteps = s0.nfev, s0.nsteps
    fresh = torch.ones_like(phase1)
    ifail = torch.zeros_like(k)
    start_ok = _finite_rows(y) & _finite_rows(yp) & torch.isfinite(h)
    status = torch.where(start_ok, RUNNING, OVERFLOW).to(torch.int32)

    def i32(x):
        return x.to(torch.int32)

    if work is not None:
        counts = torch.zeros(_WORK, nb, dtype=torch.int64, device=dev)
    rows = dense_rows(dense)
    rec = _Record(y, yp, rows) if rows else None
    tq = eval_points(t_eval)
    snaps = None if tq is None else Snapshots(tq, y, dirs)
    it = 0
    while it < max_steps:
        running = status == RUNNING
        if not bool(running.any()):
            break
        tc = t + t_lo                    # double-single time carry
        min_step = FOURU_T * torch.abs(tc)
        d = (tf - t) - t_lo              # remaining interval in DS
        near_end = torch.abs(d) <= min_step

        # fresh steps: clamp h toward tf and max_step
        h_cl = torch.where(dirs * (h - d) > 0, d, h)
        h_cl = torch.sign(h_cl) * torch.clamp(torch.abs(h_cl), max=h_max)
        h_in = torch.where(fresh, h_cl, h)
        ifail = torch.where(fresh, 0, ifail)
        kp1, km1, km2 = k + 1, k - 1, k - 2

        ns2 = torch.where(h_in != hold, 0, ns)
        ns2 = i32(torch.where(ns2 <= kold, ns2 + 1, ns2))
        (psi_n, alpha_n, beta_n, sig_n, v_n, w_n, g_n, gi_n, iv_n, ivc_n,
         kgi_n) = stepper._coefficients(types.SimpleNamespace(
             k=k, ns=ns2, kprev=kprev, psi=psi, alpha=alpha, beta=beta,
             sig=sig, v=v, w=w, g=g, gi=gi, iv=iv, ivc=ivc, kgi=kgi),
             h_in, kold)

        # block 2: predict
        beta_ext = torch.cat([beta_n, beta_n[km - 1:], beta_n[km - 1:]])
        g_ext = torch.cat([g_n, g_n[km:]])
        phi_n = torch.where(_rows((idx_r >= ns2) & (idx_r < k), phi),
                            phi * beta_ext[:, None], phi)
        phi_k = _take(phi_n, clip(k, km + 1))
        phi_n = _put(phi_n, clip(kp1, km + 1), phi_k)
        phi_n = _put(phi_n, clip(k, km + 1), torch.zeros_like(phi_k))
        gw = torch.where(idx_r < k, g_ext, 0.0)
        acc = torch.zeros_like(y)
        if compensated:
            comp = torch.zeros_like(y)
            for r in range(km + 1):
                acc, e = _two_sum(acc, gw[r] * phi_n[r])
                comp = comp + e
            pred_s, pred_c = h_in * acc, h_in * comp
            p = y + (pred_s + (pred_c + y_lo))
        else:
            for r in range(km + 1):
                acc = acc + gw[r] * phi_n[r]
            p = h_in * acc + y
        # reverse cumulative sum over rows < k
        acc = torch.zeros_like(y)
        rows = [None] * (km + 2)
        for r in range(km + 1, -1, -1):
            below = r < k
            acc = acc + torch.where(below, phi_n[r], 0.0)
            rows[r] = torch.where(below, acc, phi_n[r])
        phi_n = torch.stack(rows)

        x = tc + h_in
        yp_pred = fun(x, p)
        attempted = running & ~near_end
        nfev2 = nfev + i32(attempted)

        wtn = atol_f + rtol_f * 0.5 * (torch.abs(p) + torch.abs(y))
        inv_wt = 1.0 / wtn
        temp4 = yp_pred - phi_n[0]
        absh = torch.abs(h_in)
        erk = absh * member_norm(temp4 * inv_wt)
        erkm1 = absh * member_norm(
            (_take(phi_n, clip(km1, km + 1)) + temp4) * inv_wt) \
            * _take(sig_n, clip(km1, km)) * gstr[clip(km2, 12).long()]
        erkm2 = absh * member_norm(
            (_take(phi_n, clip(km2, km + 1)) + temp4) * inv_wt) \
            * _take(sig_n, clip(km2, km)) * gstr[clip(km2 - 1, 12).long()]
        err = erk * (_take(g_n, clip(km1, km)) - _take(g_n, clip(k, km)))
        erk = erk * _take(sig_n, clip(k, km)) * gstr[clip(km1, 12).long()]
        bad_e = ~torch.isfinite(err)
        err = torch.where(bad_e, 11.0, err)

        knew = i32(torch.where(
            (k > 2) & (torch.maximum(erkm1, erkm2) < erk), km1,
            torch.where((k == 2) & (erkm1 < 0.5 * erk), km1, k)))
        success = (err <= 1.0) & attempted & ~bad_e

        # block 3: failure restore
        below = _rows(idx_r < k, phi_n)
        phi_up = torch.cat([phi_n[1:], phi_n[km + 1:]])
        val = torch.where(below, phi_n - phi_up, phi_n)
        bsafe = torch.where(beta_ext == 0.0, 1.0, beta_ext)[:, None]
        phi_r = torch.where(below, val / bsafe, val)
        psi_up = torch.cat([psi_n[1:], psi_n[km - 1:]])
        psi_r = torch.where(idx_k < km1, psi_up - h_in, psi_n)

        ifail2 = ifail + 1
        temp2 = torch.where((ifail2 >= 4) & (0.5 < 0.25 * erk),
                            torch.sqrt(0.5 / torch.clamp(erk, min=1e-30)),
                            0.5)
        knew_fail = i32(torch.where(ifail2 >= 3, 1, knew))
        h_fail = h_in * temp2
        failed = attempted & ~success
        status2 = torch.where(failed & (torch.abs(h_fail) < min_step),
                              TOO_SMALL_STEP, status)

        # block 4: correct, evaluate, order and step selection
        g_k = _take(g_n, clip(k, km))
        if compensated:
            # the whole step increment in double-single
            s1, e1 = _two_sum(pred_s, h_in * g_k * temp4)
            lo = e1 + pred_c
            hi, lo1 = _df_add(y, y_lo, s1)
            y_corr, y_corr_lo = _two_sum(hi, lo1 + lo)
        else:
            y_corr = h_in * g_k * temp4 + p
            y_corr_lo = y_lo
        yp_new = fun(x, y_corr)
        nfev2 = nfev2 + i32(success)
        # y and yp stay finite from one step to the next, so the near-end
        # extrapolation cannot overflow; an accepted step can
        bad_y = success & ~(_finite_rows(y_corr) & _finite_rows(yp_new))
        ok = success & ~bad_y

        pkn = yp_new - phi_n[0]
        kp1c = clip(kp1, km + 1)
        col = _put(phi_n, clip(k, km + 1), pkn)
        col = _put(col, kp1c, pkn - _take(col, kp1c))
        phi_f = torch.where(below, col + pkn, col)

        phase1_b = phase1 & ~((knew == km1) | (k == km))
        erkp1 = gstr[clip(k, 12).long()] * absh \
            * member_norm(_take(phi_f, kp1c) / wtn)
        can_est = ~phase1_b & (knew != km1) & (k < ns2)
        raise1 = (k == 1) & (erkp1 < 0.5 * erk) & (k < km)
        lower = (k != 1) & (erkm1 <= torch.minimum(erk, erkp1))
        raise2 = (k != 1) & ~lower & ~((erkp1 > erk) | (k == km))
        k_next = i32(torch.where(
            phase1_b, kp1,
            torch.where(knew == km1, km1,
                        torch.where(can_est & raise1, kp1,
                                    torch.where(can_est & lower, km1,
                                                torch.where(can_est & raise2,
                                                            kp1, k))))))
        erk_next = torch.where(
            phase1_b, erkp1,
            torch.where(knew == km1, erkm1,
                        torch.where(can_est & raise1, erkp1,
                                    torch.where(can_est & lower, erkm1,
                                                torch.where(can_est & raise2,
                                                            erkp1, erk)))))
        two_next = two[clip(k_next, km + 1).long()]
        double = phase1_b | (0.5 >= erk_next * two_next)
        keep_h = 0.5 >= erk_next
        rr = torch.pow(torch.clamp(0.5 / torch.clamp(erk_next, min=1e-30),
                                   min=1e-30),
                       1.0 / (k_next.to(torch.float32) + 1.0))
        h_red = absh * torch.clamp(rr, 0.5, 0.9)
        h_red = torch.sign(h_in) * torch.maximum(h_red, min_step)
        h_next = torch.where(double, h_in + h_in,
                             torch.where(keep_h, h_in, h_red))

        t_adv, t_lo_adv = _df_add(t, t_lo, h_in)
        rem = (tf - t_adv) - t_lo_adv
        is_last = ok & (torch.abs(rem) <= LAND_TOL * torch.abs(h_in))
        t_new = torch.where(is_last, tf, t_adv)
        t_lo_new = torch.where(is_last, 0.0, t_lo_adv)

        # near-end linear extrapolation
        if compensated:
            y_ext, y_ext_lo = _df_add(y, y_lo, d * yp)
        else:
            y_ext, y_ext_lo = y + d * yp, y_lo
        extrap = running & near_end

        ok_any = ok | extrap
        status3 = torch.where((status2 == RUNNING) & (is_last | extrap),
                              FINISHED, status2)
        status3 = torch.where(bad_y, OVERFLOW, status3)
        if rec is not None and it < rec.rows:
            # the step's end, or the extrapolation's node at tf with the
            # f of the step before it
            rec.write(ok_any, nsteps, torch.where(extrap, tf, t_new),
                      torch.where(extrap, y_ext, y_corr),
                      torch.where(ok, yp_new, yp))
        if snaps is not None:
            # the high words of t and y in the compensated mode
            snaps.step(ok, t, t_new, h_in, y, yp, y_corr, yp_new)
            snaps.line(extrap, t, tf, y, yp)
        it += 1
        status3 = i32(torch.where((status3 == RUNNING) & (it >= max_steps),
                                  OVERFLOW, status3))

        if work is not None:
            a = torch.clamp(k - ns2, min=0)
            steps = torch.where(k >= ns2, torch.where(ns2 > 1, a + 1, 0)
                                + a * (a + 1) // 2, 0)
            counts += attempted * torch.stack(
                [torch.ones_like(k), k, torch.where(ok, k, 0), a, steps])

        # writeback: a rejected attempt's restore carries
        y = torch.where(extrap, y_ext, torch.where(ok, y_corr, y))
        y_lo = torch.where(extrap, y_ext_lo, torch.where(ok, y_corr_lo,
                                                          y_lo))
        yp = torch.where(ok, yp_new, yp)
        h_out = torch.where(ok, h_next, torch.where(extrap, h, h_fail))
        h_out = torch.where(attempted | extrap, h_out, h)
        h = torch.where(torch.isfinite(h_out), h_out, 1.0)
        phi = torch.where(attempted, torch.where(ok, phi_f, phi_r), phi)
        psi = torch.where(attempted, torch.where(ok, psi_n, psi_r), psi)

        def upd(new, old):
            return torch.where(attempted, new, old)

        alpha, beta, sig = upd(alpha_n, alpha), upd(beta_n, beta), \
            upd(sig_n, sig)
        v, w, g, gi = upd(v_n, v), upd(w_n, w), upd(g_n, g), upd(gi_n, gi)
        iv, ivc, kgi = upd(iv_n, iv), upd(ivc_n, ivc), upd(kgi_n, kgi)
        kold = i32(torch.where(extrap, 0, torch.where(ok, k, kold)))
        kprev = upd(k, kprev)
        k = upd(torch.where(ok, k_next, knew_fail), k)
        ns = i32(upd(torch.where(ok, ns2, 0), ns))
        phase1 = upd(ok & phase1_b, phase1)
        fresh = ok | (status3 != RUNNING) | extrap
        ifail = torch.where(ok, 0, ifail2)
        t = torch.where(extrap, tf, torch.where(ok, t_new, t))
        t_lo = torch.where(extrap | is_last, 0.0,
                           torch.where(ok, t_lo_new, t_lo))
        hold = torch.where(ok, h_in, hold)
        status = status3
        nfev = nfev2
        nsteps = nsteps + i32(ok_any)

    if work is not None:
        work.copy_(counts.T)

    out = (y.T.contiguous(), status, nsteps, nfev)
    if snaps is not None:
        out = out + (snaps.rows(t, y),)
    if rec is None:
        return out
    return out + (rec.solution(t_span, nsteps),)


# threads per SM at which the member sweep ran fastest at every ensemble
# size (8 warps: two per SM sub-partition)
_THREADS_PER_SM = 256
# the lane counts the wrapper takes besides 1, most first
_LANES = (32, 16, 8)


def _lanes_per_member(B, sm_count, k_max):
    """Lanes per member for an ensemble of ``B`` members on a card of
    ``sm_count`` SMs at order cap ``k_max``: the largest G of 32, 16 and
    8 with B G <= 256 sm_count; else 8 while 8 B <= 512 sm_count and
    k_max >= 8; else 1 (one thread per member).

    From the member sweeps of the SWAG bench line (Van der Pol mu = 1000,
    compensated, n / 2 uncoupled pairs per member;
    ``tools/probe_fused_adams.py``) on an H100 (132 SMs, 700 W), device ms
    of one thread per member against the lane groups.  n = 2, k_max 12:
    256 members 315.7 against 106.6 at G = 32; 1,024: 308.4 against 122.2
    at 32; 4,096: 329.3 against 191.0 at 8 (213.4 at 16); 8,192: 332.1
    against 259.7 at 8; 16,384: 320.8, and 491.3 at 8.  n = 2, k_max 8:
    8,192 members 234.9 against 196.3 at 8.  n = 2, k_max 4: 4,096
    members 125.4 against 111.1 at 8, but 8,192 125.1 against 139.4 at 8.
    n = 8, k_max 12: 256 members 1,053.7 against 239.6 at 32; 4,096: 997.5
    against 482.3 at 8; 8,192: 953.2 against 928.8 at 8.  n = 8, k_max 4:
    8,192 members 247.7 against 379.3 at 8.  The best G put about 32,768
    threads on the card (two warps per SM sub-partition), and up to twice
    that at 8 lanes where the one-thread body's select walks over k_max
    are long.  2 and 4 lanes never beat 1 and 8, so neither is built.
    Where the rule misses the best G: n = 8, k_max 12, 1,024 members take
    32 lanes (334.7 ms) where 16 take 290.2 (one thread: 996.4).
    """
    budget = _THREADS_PER_SM * int(sm_count)
    for lanes in _LANES:
        if int(B) * lanes <= budget:
            return lanes
    return 8 if int(k_max) >= 8 and 8 * int(B) <= 2 * budget else 1


def _kernel(fun, km, record=False, snap=False):
    """The kernel built for one FusedRHS and k_max, with the dense record
    where ``record`` and the t_eval snapshots where ``snap`` (each switch a
    build of its own)."""
    from . import _build
    return _build.cached("fused_adams", (fun,),
                         lambda: _build.load_fused_adams(
                             _adams_consts(km, fun.n), fun.cuda_src, fun.k,
                             record, snap), (km, bool(record), bool(snap)))


def solve_fused_adams(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                      first_step=None, k_max=12, max_steps=200_000,
                      block_members=None, compensated=False, t_eval=None,
                      events=None, max_step=None, params=None, dense=None):
    """Integrate an ensemble of small ODE systems with SWAG in one kernel
    launch.

    ``y0_batch``: (B, n) float32, n <= 8.  Returns ``(y_final (B, n),
    status (B,), nsteps (B,), nfev (B,))`` with status 1 = finished, 2 =
    step size underflow, 3 = overflow or step cap (``max_steps`` counts
    loop iterations, accepted plus rejected).  ``k_max`` (1 to 12) caps
    the order; ``max_step`` caps |h|.  Backward spans work.  ``dense=R``
    (R >= 1; None or 0: off) adds a fifth output, the members' continuous
    dense output (:class:`~.fused_dense.FusedDenseSolution`), from the end
    ``(t, y, f)`` of each accepted step and the near-end extrapolation's
    node that the kernel records while a member's attempts are below R
    (``valid[b]`` False where more were needed; see the module
    docstring); the record leaves the other four outputs bit for bit as
    they are without it.

    ``t_eval``: times (taken as float32, in any order, repeats and points
    outside the span allowed) at which to return each member's y,
    ``y_eval`` (len(t_eval), B, n) after ``nfev`` (before the dense
    output): the cubic Hermite of the accepted step that crosses each
    point, or the straight line of the near-end extrapolation, as in JAX,
    written inside the kernel (a build of its own, ``csrc/snapshot.cuh``);
    points at or before t0 take y0, points a member never reaches its
    final state.  It leaves the four outputs bit for bit as they are
    without it.  No points: the four outputs alone.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.
    On a CUDA tensor ``fun`` must be a :class:`FusedRHS` (its ``cuda_src``
    defines ``rhs(float t, const float* y, float* dy)`` or the template
    ``rhs<T>``); the members' starting state is computed by torch
    operations on the card, and the call launches ``csrc/fused_adams.cu``
    (built at first use) or raises: G lanes per member, G from
    :func:`_lanes_per_member` (the ensemble size, the card's SM count and
    ``k_max``), and ``block_members`` members per block (None: 128 / G), so
    ``block_members * G`` threads per block, at most 1024.  On a CPU
    tensor it runs :func:`fused_adams_reference`, with a
    :class:`FusedRHS` or a plain rows-first torch function.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument (see :class:`FusedRHS`, whose ``k`` must
    agree), the members' starting state included.  ``events`` is not
    ported yet.
    """
    check_options("solve_fused_adams", "B3", events=events)
    y0 = as_input(y0_batch, torch.float32)
    if y0.ndim != 2 or y0.shape[1] > 8:
        raise ValueError("fused SWAG takes y0_batch of shape (B, n) with "
                         "n <= 8; use solve_ensemble for larger states")
    km = int(k_max)
    if not 0 < km < 13:
        raise ValueError("`k_max` should be an integer between 1 and 12.")
    params = member_params(params, y0, fun)
    if y0.device.type != "cuda":
        return fused_adams_reference(
            fun, t_span, y0, rtol=rtol, atol=atol, first_step=first_step,
            k_max=km, max_steps=max_steps, compensated=compensated,
            max_step=max_step, params=params, dense=dense, t_eval=t_eval)

    out, shape, work = _launch(fun, t_span, y0, rtol, atol, first_step, km,
                               max_steps, compensated, max_step, None,
                               block_members, params, dense, t_eval)
    if y0.shape[0]:
        solve_fused_adams.launches += 1
    solve_fused_adams.last_shape = shape
    solve_fused_adams.last_work = work
    return out


def _launch(fun, t_span, y0, rtol, atol, first_step, k_max, max_steps,
            compensated, max_step, lanes, block_members=None, params=None,
            dense=None, t_eval=None):
    """B3 on the card for the CUDA tensor ``y0`` (and the members'
    ``params``, checked by ``member_params``): ``lanes`` lanes per member
    (None: :func:`_lanes_per_member`'s) and ``block_members`` members per
    block (None: 128 / lanes), with the dense record of ``dense`` rows a
    member and the rows of ``t_eval`` (each switch the build with it) where
    given.  Returns the outputs (``y_eval`` and the
    :class:`~.fused_dense.FusedDenseSolution` after the four), the
    ``(lanes, block_members)`` taken and the (B, 5) work counters; an
    empty batch launches nothing."""
    if not isinstance(fun, FusedRHS):
        raise TypeError("solve_fused_adams on a CUDA tensor needs a "
                        "FusedRHS (a CUDA source of the right-hand side); "
                        f"got {type(fun).__name__}")
    nb, n = y0.shape
    if n != fun.n:
        raise ValueError(f"y0_batch must be (B, {fun.n}), got "
                         f"{tuple(y0.shape)}")
    if y0.dtype != torch.float32:
        raise TypeError(f"y0_batch must be float32, got {y0.dtype}")
    params = member_params(params, y0, fun)
    if params is not None and not params.is_contiguous():
        raise ValueError("params must be contiguous")
    if lanes is None:
        lanes = _lanes_per_member(nb, torch.cuda.get_device_properties(
            y0.device).multi_processor_count, k_max)
    block_members, _, _ = _launch_shape(nb, lanes, block_members)
    y0 = y0.contiguous()
    rows = dense_rows(dense)
    tq = eval_points(t_eval)

    built = _kernel(fun, k_max, rows > 0, tq is not None)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    work = torch.empty(nb, _WORK, dtype=torch.int32, device=y0.device)
    shape = (lanes, block_members)
    rec = DenseRecord(y0, rows)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = snap_outputs((y_out, status, nsteps, nfev), snap)
    if nb == 0:
        return rec.outputs(out, t_span, y0), shape, work
    # the starting state, outside the kernel as in the JAX package
    _, s0, direction = _host_init(bind_params(fun, params), t_span, y0.T,
                                  rtol, atol, first_step, k_max, max_step)
    yp0 = s0.yp.T.contiguous()
    h0 = s0.h.contiguous()
    nfev0 = s0.nfev.contiguous()
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), None if params is None else params.data_ptr(),
                yp0.data_ptr(), h0.data_ptr(), nfev0.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), work.data_ptr(), nb, _f32(t_span[0]),
                _f32(t_span[1]), direction, _f32(rtol), _f32(atol),
                np.inf if max_step is None else _f32(max_step),
                int(max_steps), int(bool(compensated)), lanes,
                block_members)
        if snap is not None:
            rc = built.lib.fused_adams_snap_launch(*args, *rec.args(),
                                                   *snap.args(), stream)
        elif rows:
            rc = built.lib.fused_adams_record_launch(*args, *rec.args(),
                                                     stream)
        else:
            rc = built.lib.fused_adams_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_adams kernel launch failed: CUDA error {rc}")
    return rec.outputs(out, t_span, y0), shape, work


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count), the (lanes per member, members per block)
# of the last launch and its (B, 5) work counters (fused_adams_reference's
# ``work``)
solve_fused_adams.launches = 0
solve_fused_adams.last_shape = None
solve_fused_adams.last_work = None
