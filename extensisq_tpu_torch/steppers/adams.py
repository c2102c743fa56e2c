"""SWAG: variable-order Adams-Bashforth-Moulton PECE stepper, batched over
members.

Counterpart of ``extensisq_tpu/steppers/adams.py`` (the DDEABM/dsteps
translation).  State is rows-first, members last: per-member scalars are
``(B,)``, the state ``(n, B)``, the k-indexed coefficient vectors
``(km, B)`` (``km = k_max``) and the scaled divided differences ``phi``
``(km + 2, n, B)``.  The dynamic index ranges of the dsteps recurrences
(which change with each member's order ``k`` and step count ``ns``) are
masks over the static ``km`` bound, as in the JAX stepper; a per-member
index becomes ``torch.gather``/``scatter`` along axis 0.  Products and
sums that the JAX stepper unrolls (``_cumprod``, ``_cumsum_rev``) keep
its sequential order, so float64 runs give the JAX counts.

Dense output (``record_coefficients``, ``dense_segments``) comes with
ROADMAP A4b, complex states with A3.
"""
from typing import Any, NamedTuple

import numpy as np
import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, TOL_TOO_TIGHT
from ..core.hstart import h_start
from ..core.numerics import calculate_scale, norm, dtype_constants
from .erk import select

K_MAX_LIMIT = 12

# Adams error constants (dsteps gstr) and the doubling thresholds
_GSTR = np.array([0.5, 0.0833, 0.0417, 0.0264, 0.0188, 0.0143, 0.0114,
                  0.00936, 0.00789, 0.00679, 0.00592, 0.00524, 0.00468])


def _cumprod(x):
    """Sequential cumulative product along axis 0 (no ``torch.cumprod``,
    whose order of evaluation is its own)."""
    rows = [x[0]]
    for i in range(1, x.shape[0]):
        rows.append(rows[-1] * x[i])
    return torch.stack(rows)


def _cumsum_rev(x):
    """Reverse cumulative sum along axis 0, in sequential order."""
    rows = [None] * x.shape[0]
    acc = x[-1]
    rows[-1] = acc
    for i in range(x.shape[0] - 2, -1, -1):
        acc = acc + x[i]
        rows[i] = acc
    return torch.stack(rows)


def _index(arr, i):
    """A gather/scatter index for ``arr`` (rows, ..., B) from the
    per-member row index ``i`` (B,)."""
    shape = (1,) + (1,) * (arr.ndim - 2) + (arr.shape[-1],)
    return i.long().reshape(shape).expand((1,) + tuple(arr.shape[1:]))


def _take(arr, i):
    """``arr[i]`` per member; ``i`` (B,) must be in range."""
    return torch.gather(arr, 0, _index(arr, i))[0]


def _put(arr, i, val):
    """``arr`` with row ``i`` (B,) of each member set to ``val``."""
    return torch.scatter(arr, 0, _index(arr, i),
                         val.expand(arr.shape[1:]).unsqueeze(0))


def _rows(m, like):
    """A (rows, B) mask broadcast over the state axis of ``like``
    (rows, n, B)."""
    return m.unsqueeze(1).expand(like.shape)


class AdamsState(NamedTuple):
    t: Any
    y: Any
    yp: Any
    h: Any                  # signed current step proposal
    hold: Any
    wt: Any                 # (n, B) error weights, updated each step
    k: Any                  # current order
    kold: Any
    kprev: Any
    ns: Any                 # steps taken at this h
    phase1: Any             # bool: initial order-raising phase
    ivc: Any
    kgi: Any
    iv: Any                 # (k_max-2, B) int32
    gi: Any                 # (k_max-1, B)
    phi: Any                # (k_max+2, n, B) scaled divided differences
    psi: Any                # (k_max, B)
    alpha: Any              # (k_max, B)
    beta: Any               # (k_max, B)
    sig: Any                # (k_max+1, B)
    v: Any                  # (k_max, B)
    w: Any                  # (k_max, B)
    g: Any                  # (k_max+1, B)
    status: Any
    extrapolated: Any       # bool: last step was a linear extrapolation
    kle4: Any               # consecutive low-order steps (stiffness hint)
    stiff_flag: Any         # bool diagnostic
    t_old: Any
    y_old: Any
    yp_old: Any
    h_previous: Any
    nfev: Any
    nsteps: Any
    nfailed: Any


class _Carry(NamedTuple):
    h: Any
    k: Any
    ns: Any
    kprev: Any
    ifail: Any
    phase1: Any
    phi: Any
    psi: Any
    alpha: Any
    beta: Any
    sig: Any
    v: Any
    w: Any
    g: Any
    gi: Any
    iv: Any
    ivc: Any
    kgi: Any
    success: Any
    status: Any
    p: Any                 # predicted solution
    yp_pred: Any
    wt: Any
    erk: Any
    erkm1: Any
    erkm2: Any
    knew: Any
    nfev: Any
    nfailed: Any


def _i32(x):
    return x.to(torch.int32)


class AdamsStepper:
    """init/step functions of SWAG for one right-hand side.

    ``fun(t, y)`` takes ``t`` of shape ``(B,)`` and ``y`` of shape
    ``(n, B)`` and returns ``(n, B)``.  ``dtype`` is float64 for the
    driver and float32 for the fused kernel's starting state.
    """
    family = "adams"

    def __init__(self, fun, n, dtype, options=None):
        self.fun = fun
        self.n = n
        self.dtype = dtype
        self.real_dtype = dtype
        consts = dtype_constants(dtype)
        small = consts["uround"]
        self.twou = 2.0 * small
        self.fouru = 4.0 * small
        opts = dict(options or {})
        k_max = int(opts.pop("k_max", 12))
        if not (0 < k_max < 13):
            raise ValueError(
                "`k_max` should be an integer between 1 and 12.")
        self.k_max = k_max
        self.options = opts
        km = k_max
        self.iq = np.arange(1, km + 2, dtype=float)
        self.iqq = 1.0 / (self.iq * (self.iq + 1.0))
        self.gstr = _GSTR
        self.two = 2.0 ** np.arange(1, km + 3)   # two[k] = 2^(k+1)
        self.eps = 1.0
        self.p5eps = 0.5
        self._dev_consts = {}

    def _consts(self, device):
        """(iq, iqq, gstr, two) as tensors of the stepper's dtype."""
        c = self._dev_consts.get(device)
        if c is None:
            c = tuple(torch.tensor(a, dtype=self.real_dtype, device=device)
                      for a in (self.iq, self.iqq, self.gstr, self.two))
            self._dev_consts[device] = c
        return c

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        """Initial state for ``y0`` of shape ``(n, B)`` at time ``t0``
        (a float or a ``(B,)`` tensor): 1 RHS evaluation + h_start unless
        ``first_step`` is given."""
        if y0.is_complex():
            raise NotImplementedError("complex states are not ported yet: "
                                      "ROADMAP A3")
        B = y0.shape[1]
        dev = y0.device
        rd = self.real_dtype
        t0 = torch.as_tensor(t0, dtype=rd, device=dev).expand(B).clone()
        yp0 = self.fun(t0, y0)
        nfev = 1
        if first_step is None:
            b = t0 + params.direction * torch.clamp(
                torch.abs(params.t_bound - t0), max=params.max_step)
            h = h_start(self.fun, t0, b, y0, yp0, 1, params.rtol,
                        params.atol)
            nfev += 1 + min(self.n + 1, 3)
        else:
            h = torch.full_like(t0, float(first_step)) * params.direction
        km = self.k_max
        wt = calculate_scale(params.atol, params.rtol, y0, y0 - h * yp0)

        phi = torch.zeros((km + 2, self.n, B), dtype=self.dtype, device=dev)
        phi[0] = yp0
        g = torch.zeros((km + 1, B), dtype=rd, device=dev)
        g[0] = 1.0
        g[1] = 0.5
        sig = torch.zeros((km + 1, B), dtype=rd, device=dev)
        sig[0] = 1.0
        z = torch.zeros_like(t0)
        i0 = torch.zeros(B, dtype=torch.int32, device=dev)
        f0 = torch.zeros(B, dtype=torch.bool, device=dev)

        def zk(rows, dtype=rd):
            return torch.zeros((rows, B), dtype=dtype, device=dev)

        return AdamsState(
            t=t0, y=y0, yp=yp0, h=h, hold=z, wt=wt,
            k=i0 + 1, kold=i0, kprev=i0, ns=i0,
            phase1=~f0, ivc=i0, kgi=i0,
            iv=zk(max(km - 2, 1), torch.int32), gi=zk(km - 1), phi=phi,
            psi=zk(km), alpha=zk(km), beta=zk(km), sig=sig, v=zk(km),
            w=zk(km), g=g,
            status=i0 + RUNNING, extrapolated=f0, kle4=i0, stiff_flag=f0,
            t_old=t0, y_old=y0, yp_old=yp0, h_previous=z,
            nfev=i0 + nfev, nsteps=i0, nfailed=i0)

    # -- block 1: coefficient recurrences (shampine.py:246-317) -------------

    def _coefficients(self, c, h, kold):
        """The dsteps block-1 update of ``c``'s coefficient fields (any
        object with ``k, ns, kprev, psi, alpha, beta, sig, v, w, g, gi,
        iv, ivc, kgi``) for the step ``h``.  Returns (psi, alpha, beta,
        sig, v, w, g, gi, iv, ivc, kgi).  The fused kernel's plain version
        runs this same function in float32 (the counterpart of
        ``extensisq_tpu/ops/_adams_common.py:make_coefficients``)."""
        km = self.k_max
        dev = h.device
        rd = self.real_dtype
        iq, iqq_all, _, _ = self._consts(dev)
        idx = torch.arange(km, device=dev)[:, None]
        i_gi = torch.arange(km - 1, device=dev)[:, None]
        k, ns = c.k, c.ns
        kp1, km1 = k + 1, k - 1
        nsm1 = ns - 1
        rng = (idx >= ns) & (idx < k)

        recompute = k >= ns

        psi_old = c.psi
        zrow = torch.zeros_like(psi_old[:1])
        # psi[nsm1] = h*ns ; psi[i] = h + psi_old[i-1] for i in [ns, k)
        psi_shift = torch.cat([zrow, psi_old[:-1]])
        psi = torch.where(idx == nsm1, h * ns,
                          torch.where(rng, h + psi_shift, psi_old))
        psi = torch.where(recompute, psi, psi_old)

        alpha = torch.where(idx == nsm1, 1.0 / ns.to(rd),
                            torch.where(rng, h / torch.where(psi == 0, 1.0,
                                                             psi),
                                        c.alpha))
        alpha = torch.where(recompute, alpha, c.alpha)

        # beta[i] = prod_{j=ns..i} psi[j-1]/psi_old[j-1]
        ratio = torch.where(
            rng, psi_shift * 0.0
            + torch.cat([torch.ones_like(zrow), psi[:-1]])
            / torch.where(psi_shift == 0, 1.0, psi_shift), 1.0)
        beta = torch.where(idx == nsm1, 1.0,
                           torch.where(rng, _cumprod(ratio), c.beta))
        beta = torch.where(recompute, beta, c.beta)

        # sig[j+1] = sig[nsm1-ish base] * prod_{i=nsm1..j} (i+1)*alpha[i]
        factor = torch.where((idx >= nsm1) & (idx < k),
                             iq[:km, None] * alpha, 1.0)
        cp = _cumprod(factor)
        s_base = _take(c.sig, torch.clamp(nsm1, 0, km))
        s_base = torch.where(nsm1 == 0, 1.0, s_base)
        sig_tail = s_base * cp                      # value for index j+1
        midx = torch.arange(km + 1, device=dev)[:, None]
        sig_tail_sh = torch.cat([sig_tail[:1], sig_tail[:km]])
        sig = torch.where((midx >= ns) & (midx <= k) & recompute,
                          sig_tail_sh, c.sig)

        # ---- v, w, g ----
        iqq = iqq_all[:km, None]
        v, w, gi, iv = c.v, c.w, c.gi, c.iv
        ivc, kgi = c.ivc, c.kgi
        g = c.g
        one = min(1, km - 1)       # row 1 (km == 1 has no gi rows)

        first_ns = ns == 1

        # ns == 1 branch (shampine.py:275-280)
        v1 = torch.where(idx < k, iqq, v)
        w1 = v1
        ivc1 = torch.zeros_like(ivc)
        kgi1 = _i32(k != 1)
        gi1 = torch.where((i_gi == 0) & (k != 1), w1[one], gi)

        # ns > 1 branch (shampine.py:282-309)
        raised = k > c.kprev
        use_iv = raised & (ivc != 0)
        ivc2 = torch.where(raised, torch.where(use_iv, ivc - 1, ivc), ivc)
        jv = _i32(torch.where(
            use_iv, kp1 - _take(iv, torch.clamp(ivc - 1, 0,
                                                iv.shape[0] - 1)), 1))
        # fresh diagonal entry when the order was raised without a stored
        # iv pointer
        fresh = raised & (ivc == 0)
        km1c = torch.clamp(km1, 0, km - 1)
        v2 = torch.where(fresh & (idx == km1),
                         iqq_all[:km][km1c.long()], v)
        w2 = torch.where(fresh & (idx == km1), _take(v2, km1c), w)
        kgi2 = _i32(torch.where(fresh & (k == 2), 1, kgi))
        gi2 = torch.where((i_gi == 0) & fresh & (k == 2), w2[one], gi)

        # sequential diagonal update: j = jv .. nsm1-1 (shampine.py:295-299)
        for j in range(km):
            active = raised & (j >= jv) & (j < nsm1)
            i = torch.clamp(km1 - j, 0, km - 1)
            v2_i = _take(v2, i)
            newval = v2_i - alpha[min(j, km - 1)] \
                * _take(v2, torch.clamp(i + 1, 0, km - 1))
            v2 = _put(v2, i, torch.where(active, newval, v2_i))
        w2 = torch.where(raised & (idx >= torch.clamp(km1 - nsm1 + 1, min=0))
                         & (idx <= km1 - jv), v2, w2)
        cond_kgi = raised & (k == ns) & (jv < nsm1)
        kgi2 = _i32(torch.where(cond_kgi, nsm1, kgi2))
        gi2 = torch.where((i_gi == torch.clamp(nsm1 - 1, 0, km - 2))
                          & cond_kgi, v2[one], gi2)

        # main v update and w copy (shampine.py:301-309)
        limit1 = kp1 - ns
        v_shift = torch.cat([v2[1:], torch.zeros_like(v2[:1])])
        v2 = torch.where(idx < limit1,
                         v2 - _take(alpha, torch.clamp(nsm1, 0, km - 1))
                         * v_shift, v2)
        w2 = torch.where(idx < limit1 + 1, v2, w2)
        g2 = _put(g, torch.clamp(ns, 0, km), v2[0])
        kgi2 = _i32(torch.where(limit1 != 1, ns, kgi2))
        gi2 = torch.where((i_gi == torch.clamp(nsm1, 0, km - 2))
                          & (limit1 != 1), v2[one], gi2)
        lower = k < kold
        i_iv = torch.arange(iv.shape[0], device=dev)[:, None]
        iv2 = _i32(torch.where(
            (i_iv == torch.clamp(ivc2, 0, iv.shape[0] - 1)) & lower,
            limit1 + 2, iv))
        ivc3 = _i32(torch.where(lower, ivc2 + 1, ivc2))

        # select ns==1 vs ns>1 results
        v = torch.where(first_ns, v1, v2)
        w = torch.where(first_ns, w1, w2)
        gi = torch.where(first_ns, gi1, gi2)
        iv = torch.where(first_ns, iv, iv2)
        ivc = torch.where(first_ns, ivc1, ivc3)
        kgi = torch.where(first_ns, kgi1, kgi2)
        g = torch.where(first_ns, g, g2)

        # compute the g coefficients in w (shampine.py:311-316)
        for i in range(km):
            active = (i >= ns) & (i < k)
            limit2 = k - i
            w_shift = torch.cat([w[1:], torch.zeros_like(w[:1])])
            w = torch.where((idx < limit2) & active,
                            w - alpha[min(i, km - 1)] * w_shift, w)
            j = min(i + 1, km)
            g = torch.cat([g[:j], torch.where(active, w[0], g[j])[None],
                           g[j + 1:]])

        def keep(x_new, x_old):
            return torch.where(recompute, x_new, x_old)

        return (psi, alpha, beta, sig, keep(v, c.v), keep(w, c.w),
                keep(g, c.g), keep(gi, c.gi), keep(iv, c.iv),
                keep(ivc, c.ivc), keep(kgi, c.kgi))

    # -- one attempt ----------------------------------------------------------

    def _attempt(self, params, state, min_step, c):
        """One predict+error attempt (dsteps blocks 1-3,
        shampine.py:246-398); shared by step and step_flat."""
        km = self.k_max
        dev = state.t.device
        _, _, gstr, _ = self._consts(dev)
        x0, y0 = state.t, state.y
        h, k = c.h, c.k
        kp1, km1, km2 = k + 1, k - 1, k - 2
        # ns counts steps taken at this h (shampine.py:251-256): reset when
        # h differs from the last successful step's h
        ns = torch.where(h != state.hold, 0, c.ns)
        ns = _i32(torch.where(ns <= state.kold, ns + 1, ns))

        cc = c._replace(ns=ns)
        (psi, alpha, beta, sig, v, w, g, gi, iv, ivc, kgi) = \
            self._coefficients(cc, h, state.kold)

        # block 2: predict (shampine.py:320-364)
        idx_r = torch.arange(km + 2, device=dev)[:, None]
        phi = c.phi
        beta_ext = torch.cat([beta, beta[km - 1:km], beta[km - 1:km]])
        g_ext = torch.cat([g, g[km:km + 1]])
        phi = torch.where(_rows((idx_r >= ns) & (idx_r < k), phi),
                          phi * beta_ext[:, None, :], phi)
        phi_k = _take(phi, torch.clamp(k, 0, km + 1))
        phi = _put(phi, torch.clamp(kp1, 0, km + 1), phi_k)
        phi = _put(phi, torch.clamp(k, 0, km + 1), torch.zeros_like(phi_k))
        # sum_s gw[s] phi[s] one row after another: a matrix product would
        # sum in the order of its library, which differs between the CPU
        # and the card
        gw = torch.where(idx_r < k, g_ext, 0.0)
        acc = torch.zeros_like(y0)
        for s in range(km + 2):
            acc = acc + gw[s] * phi[s]
        p = h * acc + y0
        # reverse cumulative sum over rows < k
        below_k = _rows(idx_r < k, phi)
        rev = _cumsum_rev(torch.where(below_k, phi, torch.zeros_like(phi)))
        phi = torch.where(below_k, rev, phi)

        x = x0 + h
        yp_pred = self.fun(x, p)
        nfev = c.nfev + 1

        wt = calculate_scale(params.atol, params.rtol, p, y0, _mean=True)
        inv_wt = 1.0 / wt
        temp4 = yp_pred - phi[0]
        absh = torch.abs(h)

        erk = absh * norm(temp4 * inv_wt)
        erkm1 = absh * norm((_take(phi, torch.clamp(km1, 0, km + 1))
                             + temp4) * inv_wt) \
            * _take(sig, torch.clamp(km1, 0, km)) \
            * gstr[torch.clamp(km2, 0, 12).long()]
        erkm2 = absh * norm((_take(phi, torch.clamp(km2, 0, km + 1))
                             + temp4) * inv_wt) \
            * _take(sig, torch.clamp(km2, 0, km)) \
            * gstr[torch.clamp(km2 - 1, 0, 12).long()]
        err = erk * (_take(g, torch.clamp(km1, 0, km))
                     - _take(g, torch.clamp(k, 0, km)))
        erk = erk * _take(sig, torch.clamp(k, 0, km)) \
            * gstr[torch.clamp(km1, 0, 12).long()]

        knew = _i32(torch.where(
            (k > 2) & (torch.maximum(erkm1, erkm2) < erk), km1,
            torch.where((k == 2) & (erkm1 < 0.5 * erk), km1, k)))

        success = err <= self.eps

        # block 3: failure restore (shampine.py:369-398)
        phi_up = torch.cat([phi[1:], phi[km + 1:km + 2]])
        phi_r = torch.where(below_k, phi - phi_up, phi)
        bx = beta_ext[:, None, :]
        phi_r = torch.where(below_k,
                            phi_r / torch.where(bx == 0, 1.0, bx), phi_r)
        psi_up = torch.cat([psi[1:], psi[km - 1:km]])
        idx_k = torch.arange(km, device=dev)[:, None]
        psi_r = torch.where(idx_k < km1, psi_up - h, psi)

        ifail = c.ifail + 1
        temp2 = torch.where((ifail >= 4) & (self.p5eps < 0.25 * erk),
                            torch.sqrt(self.p5eps / erk), 0.5)
        knew_fail = _i32(torch.where(ifail >= 3, 1, knew))
        h_fail = h * temp2
        status = _i32(torch.where(~success & (torch.abs(h_fail) < min_step),
                                  TOO_SMALL_STEP, c.status))

        return _Carry(
            h=torch.where(success, h, h_fail),
            k=torch.where(success, k, knew_fail),
            # dsteps sets ns=0 on EVERY rejection (shampine.py:394)
            ns=torch.where(success, ns, 0).to(torch.int32),
            kprev=k,
            ifail=torch.where(success, c.ifail, ifail),
            phase1=c.phase1 & success,
            phi=torch.where(success, phi, phi_r),
            psi=torch.where(success, psi, psi_r),
            alpha=alpha, beta=beta, sig=sig, v=v, w=w, g=g,
            gi=gi, iv=iv, ivc=ivc, kgi=kgi,
            success=success,
            status=status,
            p=torch.where(success, p, c.p),
            yp_pred=torch.where(success, yp_pred, c.yp_pred),
            wt=torch.where(success, wt, c.wt),
            erk=erk, erkm1=erkm1, erkm2=erkm2,
            knew=knew,
            nfev=nfev,
            nfailed=c.nfailed + _i32(~success))

    def _prepare(self, params, state):
        """Per-step quantities: (min_step, d, near_end, h clamped toward
        t_bound and max_step, tol_tight, (kle4, stiff_flag))."""
        x0, y0 = state.t, state.y
        min_step = self.fouru * torch.abs(x0)

        # stiffness hint (shampine.py:198-207)
        kle4 = torch.where(state.kold > 4, 0, state.kle4 + 1)
        stiff_flag = state.stiff_flag | ((kle4 > 50) & (self.k_max > 4))
        kle4 = _i32(torch.where(kle4 > 50, 0, kle4))

        d = params.t_bound - x0
        near_end = torch.abs(d) <= min_step

        h_in = state.h
        h_in = torch.where(params.direction * (h_in - d) > 0, d, h_in)
        h_in = torch.sign(h_in) * torch.clamp(torch.abs(h_in),
                                              max=params.max_step)

        round_ = self.twou * norm(y0 / state.wt)
        tol_tight = self.p5eps < round_
        return min_step, d, near_end, h_in, tol_tight, (kle4, stiff_flag)

    def _carry0(self, state, h_in, ifail, status, near_end):
        z = torch.zeros_like(state.t)
        return _Carry(
            h=h_in, k=state.k, ns=state.ns, kprev=state.kprev, ifail=ifail,
            phase1=state.phase1, phi=state.phi, psi=state.psi,
            alpha=state.alpha, beta=state.beta, sig=state.sig, v=state.v,
            w=state.w, g=state.g, gi=state.gi, iv=state.iv, ivc=state.ivc,
            kgi=state.kgi,
            success=near_end,        # extrapolation skips the attempt
            status=status, p=state.y, yp_pred=state.yp, wt=state.wt,
            erk=z, erkm1=z, erkm2=z, knew=state.k, nfev=state.nfev,
            nfailed=state.nfailed)

    def step(self, params, state):
        """Advance every running member by one accepted step (or the
        near-end extrapolation), or set its terminal status: attempts
        repeat, per member, until that member's attempt is accepted (the
        JAX ``step``'s inner loop)."""
        min_step, d, near_end, h_in, tol_tight, hint = self._prepare(
            params, state)
        status = _i32(torch.where(
            tol_tight & ~near_end, TOL_TOO_TIGHT,
            torch.where((torch.abs(h_in) < min_step) & ~near_end,
                        TOO_SMALL_STEP, state.status)))
        c = self._carry0(state, h_in, torch.zeros_like(state.k), status,
                         near_end)
        active = ~c.success & (c.status == RUNNING)
        while bool(active.any()):
            c = select(active, self._attempt(params, state, min_step, c), c)
            active = ~c.success & (c.status == RUNNING)
        return self._finalize(params, state, c, near_end, d, min_step,
                              *hint, flat=False)

    def _finalize(self, params, state, c, near_end, d, min_step,
                  kle4, stiff_flag, flat):
        """Block 4 (correct, evaluate, order selection,
        shampine.py:402-468) plus the state writeback.

        ``flat``: the attempt-to-attempt carry persists through the state
        (step_flat), so rejected-attempt values (phi/psi restore, reduced
        h/k, ns) are written back instead of kept."""
        km = self.k_max
        dev = state.t.device
        _, _, gstr, two = self._consts(dev)
        x0, y0, yp0 = state.t, state.y, state.yp
        ok = c.success & ~near_end
        h, k = c.h, c.k
        kp1, km1 = k + 1, k - 1
        x = x0 + h
        g_k = _take(c.g, torch.clamp(k, 0, km))
        y_corr = h * g_k * (c.yp_pred - c.phi[0]) + c.p
        # the JAX lax.cond, batched: every member evaluates, only the
        # members that take the branch count it
        yp_new = torch.where(ok, self.fun(x, y_corr), yp0)
        nfev = c.nfev + _i32(ok)

        idx_r = torch.arange(km + 2, device=dev)[:, None]
        phi = c.phi
        phi_k_new = yp_new - phi[0]
        phi = _put(phi, torch.clamp(k, 0, km + 1), phi_k_new)
        kp1c = torch.clamp(kp1, 0, km + 1)
        phi = _put(phi, kp1c, phi_k_new - _take(phi, kp1c))
        phi = torch.where(_rows(idx_r < k, phi), phi + phi_k_new[None], phi)

        # order selection for the next step (shampine.py:420-455)
        phase1 = c.phase1 & ~((c.knew == km1) | (k == self.k_max))
        erkp1 = gstr[torch.clamp(k, 0, 12).long()] * torch.abs(h) \
            * norm(_take(phi, kp1c) / c.wt)
        can_est = (~phase1) & (c.knew != km1) & (k < c.ns)

        raise1 = (k == 1) & (erkp1 < 0.5 * c.erk) & (k < self.k_max)
        lower = (k != 1) & (c.erkm1 <= torch.minimum(c.erk, erkp1))
        raise2 = (k != 1) & ~lower & ~((erkp1 > c.erk) | (k == self.k_max))

        k_next = _i32(torch.where(
            phase1, kp1,
            torch.where(c.knew == km1, km1,
                        torch.where(can_est & raise1, kp1,
                                    torch.where(can_est & lower, km1,
                                                torch.where(can_est & raise2,
                                                            kp1, k))))))
        erk_next = torch.where(
            phase1, erkp1,
            torch.where(c.knew == km1, c.erkm1,
                        torch.where(can_est & raise1, erkp1,
                                    torch.where(can_est & lower, c.erkm1,
                                                torch.where(can_est & raise2,
                                                            erkp1, c.erk)))))

        two_next = two[torch.clamp(k_next, 0, two.shape[0] - 1).long()]
        double = phase1 | (self.p5eps >= erk_next * two_next)
        keep_h = self.p5eps >= erk_next
        r = (self.p5eps / torch.clamp(erk_next, min=1e-300)) \
            ** (1.0 / (k_next.to(self.real_dtype) + 1.0))
        h_red = torch.abs(h) * torch.clamp(r, 0.5, 0.9)
        h_red = torch.sign(h) * torch.maximum(h_red, min_step)
        h_next = torch.where(double, h + h, torch.where(keep_h, h, h_red))

        # h was clamped to d upfront; landing detection via remaining gap
        is_last = ok & (torch.abs(params.t_bound - x)
                        <= self.fouru * torch.abs(x))
        t_new = torch.where(is_last, params.t_bound, x)

        # near-end linear extrapolation (shampine.py:209-217)
        y_ext = y0 + d * yp0

        ok_any = ok | near_end
        status = _i32(torch.where(
            (c.status == RUNNING) & (is_last | near_end), FINISHED,
            c.status))

        # in flat mode a rejected attempt's restore (phi/psi back-out,
        # reduced h/k, ns) must persist through the state
        fb = c if flat else state

        return AdamsState(
            t=torch.where(near_end, params.t_bound,
                          torch.where(ok, t_new, state.t)),
            y=torch.where(near_end, y_ext, torch.where(ok, y_corr, state.y)),
            yp=torch.where(ok, yp_new, state.yp),
            h=torch.where(ok, h_next, torch.where(near_end, state.h, c.h)),
            hold=torch.where(ok, h, state.hold),
            wt=torch.where(ok, c.wt, state.wt),
            k=_i32(torch.where(ok, k_next, torch.where(near_end, state.k,
                                                       c.k))),
            kold=_i32(torch.where(near_end, 0,
                                  torch.where(ok, k, state.kold))),
            kprev=_i32(torch.where(ok, c.kprev, fb.kprev)),
            ns=_i32(torch.where(ok, c.ns, fb.ns)),
            phase1=torch.where(ok, phase1, c.phase1),
            ivc=c.ivc, kgi=c.kgi, iv=c.iv, gi=c.gi,
            phi=torch.where(ok, phi, fb.phi),
            psi=torch.where(ok, c.psi, fb.psi),
            alpha=torch.where(ok, c.alpha, fb.alpha),
            beta=torch.where(ok, c.beta, fb.beta),
            sig=torch.where(ok, c.sig, fb.sig),
            v=torch.where(ok, c.v, fb.v),
            w=torch.where(ok, c.w, fb.w),
            g=torch.where(ok, c.g, fb.g),
            status=status,
            extrapolated=near_end,
            kle4=kle4, stiff_flag=stiff_flag,
            t_old=torch.where(ok_any, x0, state.t_old),
            y_old=torch.where(ok_any, y0, state.y_old),
            yp_old=torch.where(ok_any, yp0, state.yp_old),
            h_previous=torch.where(near_end, d,
                                   torch.where(ok, h, state.h_previous)),
            nfev=nfev,
            nsteps=state.nsteps + _i32(ok_any),
            nfailed=c.nfailed)

    # -- flat (attempt-level) stepping for the batched solve loop ------------

    def flat_init_aux(self, state):
        """(fresh_step, failures_this_step)."""
        return (torch.ones_like(state.phase1), torch.zeros_like(state.k))

    def step_flat(self, params, state, aux):
        """Exactly ONE predict+error attempt per member; a member's state
        advances when its attempt is accepted (or the near-end
        extrapolation fires).

        Per-STEP work (stiffness hint, end-of-interval clamp, tolerance
        check) runs only on a fresh step; a rejected attempt's restore
        (phi/psi back-out, reduced h and k, ns) persists through the
        state.  Returns (state', aux', accepted).
        """
        fresh, ifail = aux
        min_step, d, near_end, h_cl, tol_tight, (kle4_f, stiff_f) = \
            self._prepare(params, state)
        kle4 = torch.where(fresh, kle4_f, state.kle4)
        stiff_flag = torch.where(fresh, stiff_f, state.stiff_flag)
        h_in = torch.where(fresh, h_cl, state.h)

        status0 = _i32(torch.where(
            fresh & tol_tight & ~near_end, TOL_TOO_TIGHT,
            torch.where(fresh & (torch.abs(h_in) < min_step) & ~near_end,
                        TOO_SMALL_STEP, state.status)))
        c0 = self._carry0(state, h_in, torch.where(fresh, 0, ifail),
                          status0, near_end)
        # the attempt runs for every member; the members whose attempt
        # would not run under the JAX cond keep c0
        do = (~c0.success) & (c0.status == RUNNING)
        c = select(do, self._attempt(params, state, min_step, c0), c0)

        new_state = self._finalize(params, state, c, near_end, d, min_step,
                                   kle4, stiff_flag, flat=True)
        accepted = c.success
        aux_new = (accepted | (new_state.status != RUNNING), c.ifail)
        return new_state, aux_new, accepted

    # -- dense output ---------------------------------------------------------

    def record_coefficients(self, state):
        raise NotImplementedError(
            "SWAG dense output (adams_dense.dintp_coefficients) is not "
            "ported yet: ROADMAP A4b")

    def dense_segments(self, state, interpolant=None):
        return self.record_coefficients(state)

