"""On-device stiffness diagnosis for ``solve(..., nfev_stiff_detect=N)``,
batched over members.

Counterpart of the device half of ``extensisq_tpu/core/stiffness.py``
(``make_device_diagnosis``): RKSuite's power iteration (stiff_a/b/c/d and
the arc or rectangle decision of extensisq ``common.py``), with every
branch a per-member mask.  The iteration runs at most ``maxtry`` = 8 tries
of 3 RHS evaluations while some member is still active; the attempts on
which no member triggers it run only the trigger test.  The host driver's
warnings are not ported yet (ROADMAP A17).
"""
from math import sqrt

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


def _wdot(a, b, inv_wt):
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

        ynrm = torch.sqrt(_wdot(y, y, inv_wt))
        sqrrmc = sqrt(epsneg)
        scale0 = ynrm * sqrrmc
        v0nrm = torch.sqrt(_wdot(v0, v0, inv_wt))
        scale = torch.where(scale0 == 0.0, v0nrm * sqrrmc, scale0)
        no_scale = scale == 0.0

        v0v0_raw = _wdot(v0, v0, inv_wt)
        ones = torch.ones_like(y)
        zero_v = v0v0_raw == 0.0
        v0_eff = torch.where(zero_v, ones, v0)
        v0v0_eff = torch.where(zero_v, _wdot(ones, ones, inv_wt), v0v0_raw)
        v0c = v0_eff / torch.sqrt(v0v0_eff)

        active = trigger & ~not_limited & ~cheap & ~no_scale
        z = torch.zeros_like(x)
        zroot = (z, z)

        def stiff_d(v, vdotv):
            temp1 = scale / torch.sqrt(vdotv)
            zz = fun(x, y + temp1 * v)
            zz = havg / temp1 * (zz - fxy)
            return zz, _wdot(zz, zz, inv_wt)

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
            v0v1 = _wdot(v0c, v1, inv_wt)

            first = ntry == 0
            rold_first = v0v1 / v0v0c
            early_ns = (torch.abs(rold_first) < float(epsneg) ** (1.0 / 3.0)
                        if first else torch.zeros_like(active))
            r_b, rho_b, root_b, re_b = _stiff_b(v1v1, v0v1, v0v0c, rold)
            hit1 = re_b if not first else torch.zeros_like(active)
            rold = rold_first if first else r_b

            v2, v2v2 = stiff_d(v1, v1v1)
            v0v2 = _wdot(v0c, v2, inv_wt)
            v1v2 = _wdot(v1, v2, inv_wt)
            r_b2, rho_b2, root_b2, hit2 = _stiff_b(v2v2, v1v2, v1v1, rold)
            rold = torch.where(hit1, rold, r_b2)
            nfev = nfev + torch.where(active & ~blowup & ~early_ns & ~hit1,
                                      one, 0)

            det1 = v0v0c * v1v1 - v0v1 ** 2
            det1s = torch.where(det1 == 0.0, 1.0, det1)
            alpha1 = (-v0v0c * v1v2 + v0v1 * v0v2) / det1s
            beta1 = (v0v1 * v1v2 - v1v1 * v0v2) / det1s

            v3, v3v3 = stiff_d(v2, v2v2)
            v1v3 = _wdot(v1, v3, inv_wt)
            v2v3 = _wdot(v2, v3, inv_wt)
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
