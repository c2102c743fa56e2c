"""Fused SWAG ensemble solver: the whole variable-order Adams PECE
integration in one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_adams.py``.  The kernel
(``csrc/fused_adams.cu``) runs one thread per member and keeps the
member's whole multistep state in registers: the scaled divided
differences ``phi``, the coefficient vectors psi/alpha/beta/sig/v/w/g,
the order ``k`` and the counters.  Its plain PyTorch version,
:func:`fused_adams_reference`, runs the same loop on rows-first
``(n, B)`` float32 tensors, with the block-1 coefficient update of the
port's own stepper (:meth:`AdamsStepper._coefficients` in float32); the
wrapper :func:`solve_fused_adams` takes it only for tensors on the CPU.

As in the JAX package, each member's starting state (its starting step,
``f(t0, y0)`` and ``nfev``) comes from the float32 stepper's ``init``
run outside the kernel, here as torch operations on the device of
``y0``.

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
from ..steppers.adams import AdamsStepper, _GSTR, _put, _rows, _take
from ..types import IVPParams
from .fused_erk import FusedRHS, _df_add, _two_sum

_EPS32 = float(np.finfo(np.float32).eps)
# the double-single t carry resolves ~2^-46, so the minimum step is
# 4 * 2^-30 |t| rather than the bare-float32 floor
FOURU_T = 4.0 * 2.0 ** -30
# landing on tf: the double-single remainder within 8 ulps of h
LAND_TOL = 8.0 * _EPS32


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
                          compensated=False, max_step=None):
    """The plain PyTorch version of the fused SWAG kernel, on the device of
    ``y0_batch``.

    Runs the kernel's loop for the whole batch at once in float32: each
    iteration is one attempt (or the near-end extrapolation) of every
    running member, and the loop ends once no member is RUNNING or after
    ``max_steps`` iterations.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function.  Returns ``(y (B, n), status (B,), nsteps
    (B,), nfev (B,))`` like :func:`solve_fused_adams`.
    """
    if isinstance(fun, FusedRHS):
        fun = fun.torch_fn
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
        erk = absh * _member_norm(temp4 * inv_wt)
        erkm1 = absh * _member_norm(
            (_take(phi_n, clip(km1, km + 1)) + temp4) * inv_wt) \
            * _take(sig_n, clip(km1, km)) * gstr[clip(km2, 12).long()]
        erkm2 = absh * _member_norm(
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
            * _member_norm(_take(phi_f, kp1c) / wtn)
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
        it += 1
        status3 = i32(torch.where((status3 == RUNNING) & (it >= max_steps),
                                  OVERFLOW, status3))

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

    return y.T.contiguous(), status, nsteps, nfev


# (id(fun), k_max) -> (fun, built kernel); holding fun keeps its id from
# being reused while the entry lives
_KERNELS = {}


def _kernel(fun, km):
    """The kernel built for one FusedRHS and k_max (built at first use,
    then looked up without touching the disk)."""
    key = (id(fun), km)
    hit = _KERNELS.get(key)
    if hit is None:
        from . import _build
        hit = (fun, _build.load_fused_adams(_adams_consts(km, fun.n),
                                            fun.cuda_src))
        _KERNELS[key] = hit
    return hit[1]


def solve_fused_adams(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                      first_step=None, k_max=12, max_steps=200_000,
                      block_members=128, compensated=False, t_eval=None,
                      events=None, max_step=None, params=None, dense=None):
    """Integrate an ensemble of small ODE systems with SWAG in one kernel
    launch.

    ``y0_batch``: (B, n) float32, n <= 8.  Returns ``(y_final (B, n),
    status (B,), nsteps (B,), nfev (B,))`` with status 1 = finished, 2 =
    step size underflow, 3 = overflow or step cap (``max_steps`` counts
    loop iterations, accepted plus rejected).  ``k_max`` (1 to 12) caps
    the order; ``max_step`` caps |h|.  Backward spans work.

    On a CUDA tensor ``fun`` must be a :class:`FusedRHS` (its ``cuda_src``
    defines ``rhs(float t, const float* y, float* dy)`` or the template
    ``rhs<T>``); the members' starting state is computed by torch
    operations on the card, and the call launches ``csrc/fused_adams.cu``
    (built at first use) with ``block_members`` threads per block, or
    raises.  On a CPU tensor it runs :func:`fused_adams_reference`, with a
    :class:`FusedRHS` or a plain rows-first torch function.

    ``t_eval``, ``events``, ``params`` and ``dense`` are not ported yet.
    """
    for name, value in (("t_eval", t_eval), ("events", events),
                        ("params", params), ("dense", dense)):
        if value is not None:
            raise NotImplementedError(
                f"solve_fused_adams({name}=...) is not ported yet: ROADMAP "
                "queue B, item B3 (remaining options)")
    y0 = torch.as_tensor(y0_batch)
    if y0.ndim != 2 or y0.shape[1] > 8:
        raise ValueError("fused SWAG takes y0_batch of shape (B, n) with "
                         "n <= 8; use solve_ensemble for larger states")
    km = int(k_max)
    if not 0 < km < 13:
        raise ValueError("`k_max` should be an integer between 1 and 12.")
    if y0.device.type != "cuda":
        return fused_adams_reference(
            fun, t_span, y0, rtol=rtol, atol=atol, first_step=first_step,
            k_max=km, max_steps=max_steps, compensated=compensated,
            max_step=max_step)

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
    if not 1 <= block_members <= 1024:
        raise ValueError("block_members must be in [1, 1024]")
    y0 = y0.contiguous()

    built = _kernel(fun, km)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    if nb == 0:
        return y_out, status, nsteps, nfev
    # the starting state, outside the kernel as in the JAX package
    _, s0, direction = _host_init(fun.torch_fn, t_span, y0.T, rtol, atol,
                                  first_step, km, max_step)
    yp0 = s0.yp.T.contiguous()
    h0 = s0.h.contiguous()
    nfev0 = s0.nfev.contiguous()
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        rc = built.lib.fused_adams_launch(
            y0.data_ptr(), yp0.data_ptr(), h0.data_ptr(),
            nfev0.data_ptr(), y_out.data_ptr(), status.data_ptr(),
            nsteps.data_ptr(), nfev.data_ptr(), nb, _f32(t_span[0]),
            _f32(t_span[1]), direction, _f32(rtol), _f32(atol),
            np.inf if max_step is None else _f32(max_step), int(max_steps),
            int(bool(compensated)), int(block_members), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_adams kernel launch failed: CUDA error {rc}")
    solve_fused_adams.launches += 1
    return y_out, status, nsteps, nfev


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_adams.launches = 0
