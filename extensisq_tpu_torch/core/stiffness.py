"""Stiffness diagnosis: RKSuite's nonlinear power iteration, on the host
between steps and on the device inside ``solve``.

Counterpart of ``extensisq_tpu/core/stiffness.py``.  The host half
(``stiff_a``/``stiff_b``/``stiff_c``/``stiff_d`` and ``diagnose``) runs in
numpy for the host driver (``ivp.solve_ivp``), reports through warnings and
``logging`` as the JAX functions do, and evaluates the RHS through a
callable of numpy arrays that the driver hands it.  The device half
(``make_device_diagnosis``) is the same iteration for the ``solve``
driver, with every branch a per-member mask: at most ``maxtry`` = 8 tries
of 3 RHS evaluations while some member is still active; the attempts on
which no member triggers it run only the trigger test.
"""
from math import sqrt
from warnings import warn
import logging

import numpy as np
import torch

from .numerics import dtype_constants

STIFF_NONE = 0          # no diagnosis / not stiff
STIFF_REAL = 1          # stiff, dominant real root
STIFF_COMPLEX = 2       # stiff, dominant complex pair
OSCILLATORY = 3         # complex pair near the imaginary axis + many
                        # failed steps

_MAXTRY = 8
_LARGE = 1.0e10
_PENDING, _UNSURE, _NOTSTIFF, _ROOTS = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# host half: the host driver's check between steps
# ---------------------------------------------------------------------------

def _wdot(a, b, wt):
    return float((a / wt) @ (b / wt))


def stiff_d(v, havg, x, y, f, fxy, wt, scale, vdotv):
    """z ~ havg * J @ v by one forward difference."""
    temp1 = scale / sqrt(vdotv)
    z = f(x, y + temp1 * v)
    z = havg / temp1 * (z - fxy)
    return z, _wdot(z, z, wt)


def stiff_b(v1v1, v0v1, v0v0, rold):
    """Detect a strongly dominant real eigenvalue."""
    root1 = [0.0, 0.0]
    root2 = [0.0, 0.0]
    r = v0v1 / v0v0
    rho = abs(r)
    det = v0v0 * v1v1 - v0v1 ** 2
    res = abs(det / v0v0)
    rootre = det == 0.0 or (res <= 1e-6 * v1v1
                            and abs(r - rold) <= 0.001 * rho)
    if rootre:
        root1[0] = r
    return r, rho, root1, root2, rootre


def stiff_c(alpha, beta):
    """Roots of x^2 + alpha x + beta."""
    r1 = [0.0, 0.0]
    r2 = [0.0, 0.0]
    temp = alpha / 2.0
    disc = temp * temp - beta
    if disc == 0.0:
        r1[0] = r2[0] = -temp
        return r1, r2
    sqdisc = sqrt(abs(disc))
    if disc < 0.0:
        r1[0] = r2[0] = -temp
        r1[1] = sqdisc
        r2[1] = -sqdisc
    else:
        r1[0] = -temp - sqdisc if temp > 0.0 else -temp + sqdisc
        r2[0] = beta / r1[0]
    return r1, r2


def stiff_a(fun, x, y, hnow, havg, xend, maxfcn, wt, fxy, v0, cost):
    """Dominant-eigenvalue estimation: ``(stif, rootre, roots, nfev)``.

    ``fun(t, y)`` takes and returns numpy arrays.  Complex problems are
    expanded into real vectors of twice the length.  ``nfev`` counts the
    RHS evaluations made, which the host driver adds to its own.
    """
    y = np.asarray(y)
    epsneg = np.finfo(np.asarray(y).real.dtype).epsneg
    rootre = None
    nfev = [0]

    if np.iscomplexobj(y):
        def expand(v):
            v = np.asarray(v)
            return np.concatenate((v.real, v.imag))

        def contract(v):
            half = v.size // 2
            return v[:half] + 1j * v[half:]

        def f(t, v):
            nfev[0] += 1
            return expand(fun(t, contract(v)))
        y = expand(y)
        fxy = expand(np.asarray(fxy))
        v0 = expand(np.asarray(v0))
        wt = np.concatenate((wt, wt))
    else:
        def f(t, v):
            nfev[0] += 1
            return np.asarray(fun(t, v))
        fxy = np.asarray(fxy)
        v0 = np.asarray(v0, dtype=float).copy()
        wt = np.asarray(wt)

    # large step-size variation => not stability-limited
    if abs(hnow / havg) > 5 or abs(hnow / havg) < 0.2:
        return False, rootre, None, nfev[0]
    # cheap-completion test
    xtrfcn = cost * abs((xend - x) / havg)
    if xtrfcn <= maxfcn:
        return False, rootre, None, nfev[0]

    ynrm = sqrt(_wdot(y, y, wt))
    sqrrmc = sqrt(epsneg)
    scale = ynrm * sqrrmc
    if scale == 0.0:
        ynrm = sqrt(_wdot(v0, v0, wt))
        scale = ynrm * sqrrmc
        if scale == 0.0:
            return None, rootre, None, nfev[0]

    v0v0 = _wdot(v0, v0, wt)
    if v0v0 == 0.0:
        v0 = np.ones_like(y)
        v0v0 = _wdot(v0, v0, wt)
    v0 = v0 / sqrt(v0v0)
    v0v0 = 1.0

    rold = 0.0
    root1 = root2 = None
    rho = 0.0
    for ntry in range(_MAXTRY):
        v1, v1v1 = stiff_d(v0, havg, x, y, f, fxy, wt, scale, v0v0)
        if sqrt(v1v1) > _LARGE * sqrt(v0v0):
            return None, None, None, nfev[0]
        v0v1 = _wdot(v0, v1, wt)
        if ntry == 0:
            rold = v0v1 / v0v0
            if abs(rold) < epsneg ** (1 / 3):
                return False, None, None, nfev[0]
        else:
            rold, rho, root1, root2, rootre = stiff_b(v1v1, v0v1, v0v0,
                                                      rold)
            if rootre:
                break

        v2, v2v2 = stiff_d(v1, havg, x, y, f, fxy, wt, scale, v1v1)
        v0v2 = _wdot(v0, v2, wt)
        v1v2 = _wdot(v1, v2, wt)
        rold, rho, root1, root2, rootre = stiff_b(v2v2, v1v2, v1v1, rold)
        if rootre:
            break

        det1 = v0v0 * v1v1 - v0v1 ** 2
        alpha1 = (-v0v0 * v1v2 + v0v1 * v0v2) / det1
        beta1 = (v0v1 * v1v2 - v1v1 * v0v2) / det1

        v3, v3v3 = stiff_d(v2, havg, x, y, f, fxy, wt, scale, v2v2)
        v1v3 = _wdot(v1, v3, wt)
        v2v3 = _wdot(v2, v3, wt)
        rold, rho, root1, root2, rootre = stiff_b(v3v3, v2v3, v2v2, rold)
        if rootre:
            break
        det2 = v1v1 * v2v2 - v1v2 ** 2
        alpha2 = (-v1v1 * v2v3 + v1v2 * v1v3) / det2
        beta2 = (v1v2 * v2v3 - v2v2 * v1v3) / det2

        res2 = abs(v3v3 + v2v2 * alpha2 ** 2 + v1v1 * beta2 ** 2
                   + 2 * v2v3 * alpha2 + 2 * v1v3 * beta2
                   + 2 * v1v2 * alpha2 * beta2)
        if res2 <= 1e-6 * v3v3:
            r1, r2 = stiff_c(alpha1, beta1)
            root1, root2 = stiff_c(alpha2, beta2)
            rho = sqrt(root1[0] ** 2 + root1[1] ** 2)
            D1 = (root1[0] - r1[0]) ** 2 + (root1[1] - r1[1]) ** 2
            D2 = (root1[0] - r2[0]) ** 2 + (root1[1] - r2[1]) ** 2
            if sqrt(min(D1, D2)) <= 0.001 * rho:
                break

        v0 = v3 / sqrt(v3v3)
        v0v0 = 1.0
    else:
        return None, None, None, nfev[0]

    return None, rootre, (root1, root2, rho), nfev[0]


def diagnose(fun, state, t_bound, nfev_stiff_detect, n_stages,
             stbrad=None, tanang=None, stbre=None, stbim=None,
             estimate_error=None, fxy=None, lotsfl=False):
    """Assess and report stiffness after the power iteration: the arc
    domain (``stbrad``) of explicit RK or the rectangle (``stbre`` x
    ``stbim``) of Nystrom methods.

    ``state`` holds one member's ``t``, ``y``, ``y_old``, ``h_previous``
    and ``havg`` as numpy values; ``estimate_error`` is the perturbation
    vector v0.  Returns ``(message or None, nfev used)``.
    """
    y = np.asarray(state.y)
    y_old = np.asarray(state.y_old)
    tiny = np.finfo(np.asarray(y).real.dtype).tiny
    avgy = 0.5 * (np.abs(y) + np.abs(y_old))
    wt = np.maximum(avgy.real, sqrt(tiny))
    v0 = np.atleast_1d(np.asarray(estimate_error))
    h_prev = float(state.h_previous)
    havg = float(state.havg)

    stif, rootre, root, nfev = stiff_a(
        fun, float(state.t), y, h_prev, havg, t_bound,
        nfev_stiff_detect, wt, fxy, v0, n_stages)

    if root is not None:
        root1, root2, rho = root
        rootre = root1[1] == 0.0
        if root1[0] > 0.0:
            stif = False
        else:
            rho2 = sqrt(root2[0] ** 2 + root2[1] ** 2)
            if rho2 >= 0.9 * rho and root2[0] > 0.0:
                stif = False
            elif abs(root1[1]) > abs(root1[0]) * tanang:
                stif = None
            elif stbrad is not None:
                stif = rho >= 0.9 * stbrad
            else:
                stif = (abs(root1[0]) >= 0.85 * stbre
                        or abs(root1[1]) >= 0.9 * stbim)

    message = None
    if stif is None:
        if rootre is None:
            logging.info("Stiffness detection did not converge")
        elif not rootre:
            if lotsfl:
                message = (
                    "Your problem has a complex pair of dominant roots "
                    "near the imaginary axis.  There are many recently "
                    "failed steps.  You should probably change to a code "
                    "intended for oscillatory problems.")
            else:
                logging.info(
                    "The problem has a complex pair of dominant roots "
                    "near the imaginary axis.  There are not many failed "
                    "steps.")
    elif stif:
        if rootre:
            message = (
                "Your problem has a real dominant root and is diagnosed "
                "as stiff.  You should probably change to a code "
                "intended for stiff problems.")
        else:
            message = (
                "Your problem has a complex pair of dominant roots and "
                "is diagnosed as stiff.  You should probably change to "
                "a code intended for stiff problems.")
    if message is not None:
        warn(message)
    return message, nfev


# ---------------------------------------------------------------------------
# device half: the solve driver's check, batched over members
# ---------------------------------------------------------------------------

def _wdot_dev(a, b, inv_wt):
    return ((a * inv_wt) * (b * inv_wt)).sum(0)


def _stiff_b(v1v1, v0v1, v0v0, rold):
    """stiff_b: (r, rho, root1 (re, im), rootre)."""
    r = v0v1 / v0v0
    rho = torch.abs(r)
    det = v0v0 * v1v1 - v0v1 ** 2
    res = torch.abs(det / v0v0)
    rootre = (det == 0.0) | ((res <= 1e-6 * v1v1)
                             & (torch.abs(r - rold) <= 0.001 * rho))
    return r, rho, (torch.where(rootre, r, 0.0), torch.zeros_like(r)), rootre


def _stiff_c(alpha, beta):
    """stiff_c: the roots of x^2 + alpha x + beta, branch-free, each as
    (re, im)."""
    temp = alpha / 2.0
    disc = temp * temp - beta
    sqdisc = torch.sqrt(torch.abs(disc))
    r1_r0 = torch.where(temp > 0.0, -temp - sqdisc, -temp + sqdisc)
    safe = torch.where(r1_r0 == 0.0, 1.0, r1_r0)
    zero = torch.zeros_like(temp)
    double, cplx = disc == 0.0, disc < 0.0

    def pick(d, c, r):
        return torch.where(double, d, torch.where(cplx, c, r))
    r1 = (pick(-temp, -temp, r1_r0), pick(zero, sqdisc, zero))
    r2 = (pick(-temp, -temp, beta / safe), pick(zero, -sqdisc, zero))
    return r1, r2


def _where2(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]))


def make_device_diagnosis(fun, n_stages, nfev_stiff_detect, stbrad=None,
                          tanang=None, stbre=None, stbim=None):
    """An on-device stiffness check for the ``solve`` driver.

    Returns ``check(state, v0, fxy, t_bound, accepted)`` -> ``(code, nfev,
    jflstp_reset)``, each ``(B,)``: the diagnosis code (``STIFF_*``), the
    RHS evaluations spent, and where the caller must zero
    ``state.jflstp`` (the every-40-steps reset).  ``v0`` is the error
    estimate ``(n, B)``, ``fxy`` the current derivative in the diagnosis
    space, ``accepted`` where the last attempt advanced.
    """

    def check(state, v0, fxy, t_bound, accepted):
        y = state.y
        consts = dtype_constants(y.dtype)
        epsneg = consts["epsneg"]
        x = state.t
        hnow = state.h_previous
        havg = state.havg
        okstp = state.okstp

        ok = accepted & (state.status <= 1)
        lots_window = (okstp % 40 == 39) & ok
        lotsfl = lots_window & (state.jflstp >= 10)
        many = max(nfev_stiff_detect // n_stages, 1)
        toomch = (okstp % many == many - 1) & ok
        trigger = toomch | lotsfl
        zero_i = torch.zeros_like(okstp)
        if not bool(trigger.any()):
            return zero_i, zero_i, lots_window

        avgy = 0.5 * (torch.abs(y) + torch.abs(state.y_old))
        wt = torch.clamp(avgy, min=consts["sqrt_tiny"])
        inv_wt = 1.0 / wt

        # stiff_a's entry gates
        ratio = torch.abs(hnow / havg)
        not_limited = (ratio > 5.0) | (ratio < 0.2)
        xtrfcn = n_stages * torch.abs((t_bound - x) / havg)
        cheap = xtrfcn <= nfev_stiff_detect

        ynrm = torch.sqrt(_wdot_dev(y, y, inv_wt))
        sqrrmc = sqrt(epsneg)
        scale0 = ynrm * sqrrmc
        v0nrm = torch.sqrt(_wdot_dev(v0, v0, inv_wt))
        scale = torch.where(scale0 == 0.0, v0nrm * sqrrmc, scale0)
        no_scale = scale == 0.0

        v0v0_raw = _wdot_dev(v0, v0, inv_wt)
        ones = torch.ones_like(y)
        zero_v = v0v0_raw == 0.0
        v0_eff = torch.where(zero_v, ones, v0)
        v0v0_eff = torch.where(zero_v, _wdot_dev(ones, ones, inv_wt), v0v0_raw)
        v0c = v0_eff / torch.sqrt(v0v0_eff)

        active = trigger & ~not_limited & ~cheap & ~no_scale
        z = torch.zeros_like(x)
        zroot = (z, z)

        def stiff_d(v, vdotv):
            temp1 = scale / torch.sqrt(vdotv)
            zz = fun(x, y + temp1 * v)
            zz = havg / temp1 * (zz - fxy)
            return zz, _wdot_dev(zz, zz, inv_wt)

        v0v0c = torch.ones_like(x)
        rold, root1, root2, rho = z, zroot, zroot, z
        result = zero_i + _PENDING
        nfev = zero_i
        ntry = 0
        one = torch.ones_like(okstp)
        while bool(active.any()):
            v1, v1v1 = stiff_d(v0c, v0v0c)
            nfev = nfev + torch.where(active, one, 0)
            blowup = torch.sqrt(v1v1) > _LARGE * torch.sqrt(v0v0c)
            v0v1 = _wdot_dev(v0c, v1, inv_wt)

            first = ntry == 0
            rold_first = v0v1 / v0v0c
            early_ns = (torch.abs(rold_first) < float(epsneg) ** (1.0 / 3.0)
                        if first else torch.zeros_like(active))
            r_b, rho_b, root_b, re_b = _stiff_b(v1v1, v0v1, v0v0c, rold)
            hit1 = re_b if not first else torch.zeros_like(active)
            rold = rold_first if first else r_b

            v2, v2v2 = stiff_d(v1, v1v1)
            v0v2 = _wdot_dev(v0c, v2, inv_wt)
            v1v2 = _wdot_dev(v1, v2, inv_wt)
            r_b2, rho_b2, root_b2, hit2 = _stiff_b(v2v2, v1v2, v1v1, rold)
            rold = torch.where(hit1, rold, r_b2)
            nfev = nfev + torch.where(active & ~blowup & ~early_ns & ~hit1,
                                      one, 0)

            det1 = v0v0c * v1v1 - v0v1 ** 2
            det1s = torch.where(det1 == 0.0, 1.0, det1)
            alpha1 = (-v0v0c * v1v2 + v0v1 * v0v2) / det1s
            beta1 = (v0v1 * v1v2 - v1v1 * v0v2) / det1s

            v3, v3v3 = stiff_d(v2, v2v2)
            v1v3 = _wdot_dev(v1, v3, inv_wt)
            v2v3 = _wdot_dev(v2, v3, inv_wt)
            r_b3, rho_b3, root_b3, hit3 = _stiff_b(v3v3, v2v3, v2v2, rold)
            rold = torch.where(hit1 | hit2, rold, r_b3)
            nfev = nfev + torch.where(
                active & ~blowup & ~early_ns & ~hit1 & ~hit2, one, 0)

            det2 = v1v1 * v2v2 - v1v2 ** 2
            det2s = torch.where(det2 == 0.0, 1.0, det2)
            alpha2 = (-v1v1 * v2v3 + v1v2 * v1v3) / det2s
            beta2 = (v1v2 * v2v3 - v2v2 * v1v3) / det2s

            res2 = torch.abs(v3v3 + v2v2 * alpha2 ** 2 + v1v1 * beta2 ** 2
                             + 2.0 * v2v3 * alpha2 + 2.0 * v1v3 * beta2
                             + 2.0 * v1v2 * alpha2 * beta2)
            quad_ok = res2 <= 1e-6 * v3v3
            r1q, r2q = _stiff_c(alpha1, beta1)
            root1q, root2q = _stiff_c(alpha2, beta2)
            rhoq = torch.sqrt(root1q[0] ** 2 + root1q[1] ** 2)
            D1 = (root1q[0] - r1q[0]) ** 2 + (root1q[1] - r1q[1]) ** 2
            D2 = (root1q[0] - r2q[0]) ** 2 + (root1q[1] - r2q[1]) ** 2
            hitq = quad_ok & (torch.sqrt(torch.minimum(D1, D2))
                              <= 0.001 * rhoq)

            # this try's outcome, in priority order
            result = torch.where(blowup & active, _UNSURE, result)
            live = active & ~blowup
            result = torch.where(live & early_ns, _NOTSTIFF, result)
            live = live & ~early_ns
            got_b = hit1 | hit2 | hit3
            pick_b = live & got_b
            root1 = _where2(pick_b, _where2(hit1, root_b, _where2(
                hit2, root_b2, root_b3)), root1)
            rho = torch.where(pick_b, torch.where(
                hit1, rho_b, torch.where(hit2, rho_b2, rho_b3)), rho)
            root2 = _where2(pick_b, zroot, root2)
            result = torch.where(pick_b, _ROOTS, result)
            live = live & ~got_b
            pick_q = live & hitq
            root1 = _where2(pick_q, root1q, root1)
            root2 = _where2(pick_q, root2q, root2)
            rho = torch.where(pick_q, rhoq, rho)
            result = torch.where(pick_q, _ROOTS, result)
            live = live & ~hitq

            v0c = torch.where(live, v3 / torch.sqrt(v3v3), v0c)
            v0v0c = torch.where(live, 1.0, v0v0c)
            ntry += 1
            active = live & (ntry < _MAXTRY)
        # an exhausted loop leaves PENDING: unsure

        rootre = root1[1] == 0.0
        rho2 = torch.sqrt(root2[0] ** 2 + root2[1] ** 2)
        if stbrad is not None:
            in_domain = rho >= 0.9 * stbrad
        else:
            in_domain = ((torch.abs(root1[0]) >= 0.85 * stbre)
                         | (torch.abs(root1[1]) >= 0.9 * stbim))
        near_imag = torch.abs(root1[1]) > torch.abs(root1[0]) * tanang
        pos_real = root1[0] > 0.0
        second_pos = (rho2 >= 0.9 * rho) & (root2[0] > 0.0)

        got = result == _ROOTS
        stif_false = got & (pos_real | second_pos)
        stif_unsure = got & ~stif_false & near_imag
        stif_true = got & ~stif_false & ~near_imag & in_domain

        code = torch.where(
            stif_true & rootre, STIFF_REAL,
            torch.where(stif_true & ~rootre, STIFF_COMPLEX,
                        torch.where(stif_unsure & ~rootre & lotsfl,
                                    OSCILLATORY, STIFF_NONE)))
        return code.to(torch.int32), nfev.to(torch.int32), lots_window

    return check
