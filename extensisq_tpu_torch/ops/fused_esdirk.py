"""Fused implicit ensemble solver: the whole adaptive ESDIRK integration,
stiff ODEs and index-1 DAEs, in one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_esdirk.py``.  The kernel
(``csrc/fused_esdirk.cu``) runs one thread per member: the Jacobian, the
pivoted factor of the Newton matrix, the stages, the modified-Newton
iterations, the error filter, the implicit controller and the time loop
all stay in registers for the whole integration.  Its plain PyTorch
version, :func:`fused_esdirk_reference`, runs the same loop on rows-first
``(n, B)`` float32 tensors; the wrapper :func:`solve_fused_esdirk` takes
it only for tensors on the CPU.

What both compute, per attempt (the JAX kernel's semantics):

* the Jacobian ``J`` at ``(t, y)`` from ``n`` forward-mode JVPs of the
  right-hand side (dual numbers in the kernel, ``torch.func.jvp`` here);
  these evaluations are not counted in ``nfev``;
* ``W = Sc (M - h d J)``, factored once by Gaussian elimination with the
  JAX kernel's bubble partial pivoting (a row swaps in when its entry is
  strictly larger), then reused by every Newton iteration and the error
  filter;
* the stages by modified Newton with extensisq's rate and divergence
  tests, the filtered or plain embedded error, and the implicit
  controller with the rate-based step reduction after a convergence
  failure.

Mass matrices: a diagonal ``M`` marks algebraic rows by zeros; a dense or
hidden ``M`` is rotated on the host by its SVD into a unit-mass diagonal
system in ``w = V^T y``, with every norm taken back in user coordinates.
``compensated=True`` adds the double-single ``(hi, lo)`` carry of ``y``
and Neumaier-compensated stage sums over the increments ``z``.  Time is
carried in double-single in both modes.
"""
import numpy as np
import torch

from .._config import (RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW,
                       NEWTON_MAXITER, MAX_RATE, MAX_FACTOR_NRF, MIN_FACTOR,
                       MAX_FACTOR, MAX_FACTOR0)
from .._device import as_input
from ..core.controller import resolve_controller
from ..core.numerics import norm
from ..steppers.erk import weighted_sum
from ..steppers.esdirk import jacfwd
from . import _hstart_tile
from .fused_erk import FusedRHS, _comp_wsum, _df_add, _two_sum

_EPS32 = float(np.finfo(np.float32).eps)


def _f32(x):
    return float(np.float32(x))


def _esdirk_consts(method):
    """Static tableau and controller data of one method, rounded to
    float32 as the JAX kernel rounds it."""
    if method is None:
        from ..methods import Kv3I as method
    if method.family != "esdirk":
        raise NotImplementedError(
            f"solve_fused_esdirk takes ESDIRK methods; {method.name} is of "
            f"the {method.family!r} family")
    tab = method.tableau
    err_order = min(tab.order_secondary, tab.order)
    return {
        "name": tab.name,
        "A": np.asarray(tab.A, dtype=np.float32),
        "C": np.asarray(tab.C, dtype=np.float32),
        "E": np.asarray(tab.E, dtype=np.float32),
        "Az": np.asarray(tab.Az, dtype=np.float32),
        "d": _f32(tab.d),
        "inv_d": _f32(1.0 / float(tab.d)),
        "kappa": _f32(tab.kappa),
        "s": tab.n_stages,
        "filter_error": bool(tab.filter_error),
        "morder": err_order,
        "cc": resolve_controller(None, tab.sc_params,
                                 -1.0 / (err_order + 1), implicit=True),
        # the double-single t carry resolves ~2^-46, so the min-step
        # floor is 2^-31-based rather than the bare-f32 one
        "h_min_a": 10.0 * 2.0 ** -31 / tab.c_spacing(),
        "h_min_b": float(np.sqrt(np.finfo(np.float32).tiny)),
        # landing on tf: the double-single remainder within 8 ulps of h
        "land_tol": 8.0 * _EPS32,
        "hstart": {"big": _hstart_tile.BIG, "small": _hstart_tile.SMALL,
                   "relper": _hstart_tile.RELPER,
                   "t_floor": 100.0 * _hstart_tile.SMALL_T},
    }


def _mass_setup(M, n):
    """``(m_diag, rot)`` for a mass matrix: ``m_diag`` the float32
    diagonal (zeros on algebraic rows) or None; ``rot`` None, or for a
    dense/hidden M with SVD ``U S V^T`` the float64 ``(Vh, UTs)`` of the
    unit-mass rotation ``w = V^T y``, ``w'_d = (U^T f)_d / s_d``."""
    if M is None:
        return None, None
    M = np.asarray(M, dtype=np.float64)
    rot = None
    if M.ndim == 2 and not np.array_equal(M, np.diag(np.diag(M))):
        U, sv, Vh = np.linalg.svd(M)
        sv = np.where(sv < sv[0] * n ** 2 * _EPS32, 0.0, sv)
        rot = (Vh, U.T / np.where(sv > 0.0, sv, 1.0)[:, None])
        M = (sv > 0.0).astype(np.float64)
    elif M.ndim == 2:
        M = np.diag(M)
    if M.shape != (n,):
        raise ValueError("M must be (n,), a diagonal (n, n), or a general "
                         "(n, n) mass matrix")
    return M.astype(np.float32), rot


def _tiny_err(n, rtol):
    """The Newton round-off floor: updates below a few ulps of y cannot
    improve the f32 iterate, so count them as converged."""
    return _f32(np.sqrt(n) * max(_EPS32 ** 0.8, 4.0 * _EPS32 / rtol))


def _mat_rows(mat, rows):
    """``mat @ rows`` for rows of member tiles, summed in order with zero
    coefficients dropped (the kernel's unrolled sums)."""
    out = []
    for i in range(len(rows)):
        acc = None
        for j, r in enumerate(rows):
            if mat[i, j] != 0.0:
                term = _f32(mat[i, j]) * r
                acc = term if acc is None else acc + term
        out.append(torch.zeros_like(rows[0]) if acc is None else acc)
    return out


def _finite(x):
    """``(x with non-finite entries replaced by 1, non-finite mask)``."""
    bad = ~torch.isfinite(x)
    return torch.where(bad, 1.0, x), bad


def _gauss_factor(W):
    """Factor the ``n x n`` grid of member tiles ``W`` (lists of ``(B,)``
    tensors) by Gaussian elimination with the JAX kernel's bubble partial
    pivoting: for each column k, each lower row i swaps with row k where
    its entry is strictly larger.  Returns ``(LU, swaps)``: the eliminated
    rows with the multipliers below the diagonal, and the swap masks in
    the order they were taken."""
    n = len(W)
    a = [list(row) for row in W]
    swaps = []
    for k in range(n):
        for i in range(k + 1, n):
            sw = torch.abs(a[i][k]) > torch.abs(a[k][k])
            for j in range(k, n):
                a[k][j], a[i][j] = (torch.where(sw, a[i][j], a[k][j]),
                                    torch.where(sw, a[k][j], a[i][j]))
            swaps.append(sw)
        inv = 1.0 / a[k][k]
        for i in range(k + 1, n):
            fkt = a[i][k] * inv
            for j in range(k + 1, n):
                a[i][j] = a[i][j] - fkt * a[k][j]
            a[i][k] = fkt
    return a, swaps


def _gauss_replay(fact, b):
    """Solve with a :func:`_gauss_factor` factor: the swaps and the
    elimination replayed on ``b`` in the factor's order, then back
    substitution; the same arithmetic as eliminating ``[W | b]``."""
    a, swaps = fact
    n = len(a)
    x = list(b)
    q = 0
    for k in range(n):
        for i in range(k + 1, n):
            sw = swaps[q]
            q += 1
            x[k], x[i] = torch.where(sw, x[i], x[k]), torch.where(sw, x[k],
                                                                  x[i])
        for i in range(k + 1, n):
            x[i] = x[i] - a[i][k] * x[k]
    for k in range(n - 1, -1, -1):
        acc = x[k]
        for j in range(k + 1, n):
            acc = acc - a[k][j] * x[j]
        x[k] = acc / a[k][k]
    return x


def fused_esdirk_reference(fun, t_span, y0_batch, method=None, M=None,
                           yp0_batch=None, rtol=1e-4, atol=1e-6,
                           first_step=None, max_steps=100_000,
                           compensated=False, max_step=None):
    """The plain PyTorch version of the fused ESDIRK kernel, on the device
    of ``y0_batch``.

    Runs the kernel's loop for the whole batch at once in float32: each
    iteration is one attempt of every running member, and the loop ends
    once no member is RUNNING.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function.  Returns ``(y (B, n), status (B,), nsteps
    (B,), nfev (B,))`` like :func:`solve_fused_esdirk`.
    """
    if isinstance(fun, FusedRHS):
        fun = fun.torch_fn
    k = _esdirk_consts(method)
    A, C, E, Az = k["A"], k["C"], k["E"], k["Az"]
    s, dd, kappa, cc = k["s"], k["d"], k["kappa"], k["cc"]
    h_min_a, h_min_b = k["h_min_a"], k["h_min_b"]

    f32 = torch.float32
    y = torch.as_tensor(y0_batch).to(f32).T.contiguous()
    n, nb = y.shape
    dev = y.device
    tiny_err = _tiny_err(n, rtol)
    m_diag, rot = _mass_setup(M, n)
    if m_diag is not None and yp0_batch is None and np.any(m_diag == 0.0):
        raise ValueError("DAE: pass consistent yp0_batch (e.g. from the "
                         "f64 stepper's init)")
    is_alg = [m_diag is not None and m_diag[i] == 0.0 for i in range(n)]
    mass = [1.0 if m_diag is None else float(m_diag[i]) for i in range(n)]

    def rows(x):
        return [x[i] for i in range(n)]

    if rot is not None:
        Vh, UTs = rot
        V = Vh.T
        user_fun = fun

        def fun(t, w):                       # noqa: F811
            f = user_fun(t, torch.stack(_mat_rows(V, rows(w))))
            return torch.stack(_mat_rows(UTs, rows(f)))

        def to_user(r):
            return _mat_rows(V, r)
        y = torch.stack(_mat_rows(Vh, rows(y)))
    else:
        def to_user(r):
            return r

    def full(v):
        return torch.full((nb,), v, dtype=f32, device=dev)

    t = full(t_span[0])
    tf = full(t_span[1])
    direction = torch.sign(tf - t)
    rtol_r, atol_r = full(rtol), full(atol)
    if yp0_batch is not None:
        yp = torch.as_tensor(yp0_batch).to(device=dev, dtype=f32).T
        if rot is not None:
            yp = torch.stack(_mat_rows(Vh, rows(yp)))
    else:
        yp = fun(t, y)
        if m_diag is not None and rot is None:
            yp = torch.stack([yp[i] * _f32(1.0 / mass[i]) for i in range(n)])
    if first_step is not None:
        h_abs = full(first_step)
    elif m_diag is None and rot is None:
        # the in-kernel Watts start, plain ODEs only; its evaluations are
        # not counted
        bq = t + direction * torch.clamp(
            torch.abs(tf - t), max=np.inf if max_step is None
            else float(max_step))
        h_abs = torch.abs(_hstart_tile.hstart_tile(
            fun, t, bq, y, yp, k["morder"], rtol_r, atol_r))
    else:
        h_abs = 0.01 * torch.abs(tf - t)

    i32 = dict(dtype=torch.int32, device=dev)
    t_lo = torch.zeros_like(t)
    y_lo = torch.zeros_like(y)
    status = torch.full((nb,), RUNNING, **i32)
    std_sc = torch.ones(nb, dtype=torch.bool, device=dev)
    rejected = torch.zeros_like(std_sc)
    err_old = full(1.0)
    h_prev = torch.zeros_like(t)
    max_fac = full(MAX_FACTOR0)
    nstep = torch.zeros(nb, **i32)
    nfev = torch.full((nb,), 0 if yp0_batch is not None else 1, **i32)

    def newton(t_stage, z, h, psi, y_c, fact):
        """Modified Newton for one stage, each member stopping on its own.
        Returns (converged, z, rate, nfev, bad)."""
        rate = torch.full_like(h, -1.0)          # < 0: not yet measured
        dz_old = torch.zeros_like(h)
        conv = torch.zeros_like(std_sc)
        stop = torch.zeros_like(std_sc)
        bad_any = torch.zeros_like(std_sc)
        nf = torch.zeros(nb, **i32)
        yu_c = to_user(y_c)
        for it in range(NEWTON_MAXITER):
            active = ~stop
            if not bool(active.any()):
                break
            y_pred = [psi[i] + dd * z[i] for i in range(n)]
            fs = fun(t_stage, torch.stack(y_pred))
            nf = nf + active.to(torch.int32)
            bad = torch.zeros_like(std_sc)
            rhs = []
            for i in range(n):
                fi, bi = _finite(fs[i])
                bad = bad | bi
                rhs.append(fi * k["inv_d"] if is_alg[i]
                           else h * fi - mass[i] * z[i])
            dz = []
            for di in _gauss_replay(fact, rhs):
                di, bi = _finite(di)
                bad = bad | bi
                dz.append(di)
            yu_pred, dz_u = to_user(y_pred), to_user(dz)
            scale = [atol_r + rtol_r * torch.maximum(torch.abs(yu_c[i]),
                                                     torch.abs(yu_pred[i]))
                     for i in range(n)]
            dz_norm, bn = _finite(norm(torch.stack(
                [dz_u[i] / scale[i] for i in range(n)])))
            bad = bad | bn

            tiny_ok = dz_norm <= tiny_err
            if it == 0:
                rate_new = rate
                diverged = conv_normal = torch.zeros_like(std_sc)
            else:
                ratio = dz_norm / torch.clamp(dz_old, min=1e-30)
                rate_new = torch.where((rate < 0.0) | (dz_old > kappa),
                                       torch.maximum(rate, ratio), rate)
                rp = torch.ones_like(rate_new)
                for _ in range(NEWTON_MAXITER - it):
                    rp = rp * rate_new
                diverged = ((rate_new >= 1.0)
                            | (dz_norm * rp >= kappa * (1.0 - rate_new)))
                conv_normal = ((dz_norm * rate_new
                                < kappa * (1.0 - rate_new)) & ~diverged)
            stop_new = bad | tiny_ok | diverged | conv_normal

            keep = active & ~bad
            z = [torch.where(keep, z[i] + dz[i], z[i]) for i in range(n)]
            conv = torch.where(active, tiny_ok | conv_normal, conv)
            rate = torch.where(active, rate_new, rate)
            dz_old = torch.where(active, dz_norm, dz_old)
            bad_any = bad_any | (active & bad)
            stop = stop | (active & stop_new)
        return conv, z, torch.clamp(rate, min=0.0), nf, bad_any

    it = 0
    while True:
        running = status == RUNNING
        if not bool(running.any()):
            break

        # step-size limits and the landing on tf, every attempt
        tc = t + t_lo
        min_step = torch.clamp(h_min_a * (torch.abs(tc) + h_abs),
                               min=h_min_b)
        out_rng = h_abs < min_step
        h_a = torch.maximum(min_step, h_abs)
        if max_step is not None:
            out_rng = out_rng | (h_abs > float(max_step))
            h_a = torch.clamp(h_a, max=float(max_step))
        std_b = std_sc | out_rng
        d = torch.abs((tf - t) - t_lo)
        take_d = (torch.abs(d / h_a - 1.0) < 1e-2) | (d < h_a)
        h_a = torch.where(take_d, d, h_a)
        too_small = h_a < min_step
        h = h_a * direction

        # Newton matrix W = Sc (M - h d J), factored once per attempt
        y_c = rows(y)
        J = jacfwd(fun, n)(tc, y)
        hd = h * dd
        W = [[-J[:, i, j] if is_alg[i]
              else (mass[i] if i == j else 0.0) - hd * J[:, i, j]
              for j in range(n)] for i in range(n)]
        fact = _gauss_factor(W)

        # stages (stage 0 explicit: K0 = yp; h * K_j == z_j)
        K = [rows(yp)]
        Z = [[h * K[0][i] for i in range(n)]]
        y_lo_rows = rows(y_lo)
        conv_all = running & ~too_small
        Rate = torch.zeros_like(h)
        nfev_d = torch.zeros(nb, **i32)
        for si in range(1, s):
            if compensated:
                psi = []
                for i in range(n):
                    acc, cmp = _comp_wsum([Z[j][i] for j in range(si)],
                                          A[si, :si])
                    psi.append(y_c[i] + (acc + (cmp + y_lo_rows[i])))
            else:
                psi = [y_c[i] + h * weighted_sum(
                    [K[j][i] for j in range(si)], A[si, :si])
                       for i in range(n)]
            z0 = [h * weighted_sum([K[j][i] for j in range(si)], Az[si, :si])
                  for i in range(n)]
            conv_s, z, rate_s, nfev_s, bad_s = newton(
                tc + float(C[si]) * h, z0, h, psi, y_c, fact)
            conv_all = conv_all & conv_s & ~bad_s
            Rate = torch.maximum(Rate, rate_s)
            nfev_d = nfev_d + nfev_s
            inv_h = 1.0 / h
            K.append([z[i] * inv_h for i in range(n)])
            Z.append(z)

        # solution and error estimate; stiffly accurate methods:
        # y_new = psi + d z of the last stage
        if compensated:
            y_rows, ylo_rows = [], []
            for i in range(n):
                inc_s, inc_c = _comp_wsum([Z[j][i] for j in range(s)],
                                          A[s - 1, :s])
                hi, lo1 = _df_add(y_c[i], y_lo_rows[i], inc_s)
                hi, lo2 = _two_sum(hi, lo1 + inc_c)
                y_rows.append(hi)
                ylo_rows.append(lo2)
            y_new, y_lo_new = torch.stack(y_rows), torch.stack(ylo_rows)
        else:
            y_new = torch.stack([psi[i] + dd * z[i] for i in range(n)])
            y_lo_new = y_lo
        y_new, bad_y = _finite(y_new)
        scale = atol_r + rtol_r * torch.maximum(
            torch.abs(torch.stack(to_user(y_c))),
            torch.abs(torch.stack(to_user(rows(y_new)))))
        if compensated:
            err_rows = []
            for i in range(n):
                acc, cmp = _comp_wsum([Z[j][i] for j in range(s)], E[:s])
                err_rows.append(acc + cmp)
        else:
            err_rows = [h * weighted_sum([K[j][i] for j in range(s)], E[:s])
                        for i in range(n)]
        if k["filter_error"]:
            inv_hd = 1.0 / hd
            solved = _gauss_replay(fact, [err_rows[i] * inv_hd if is_alg[i]
                                        else err_rows[i] for i in range(n)])
            err_rows = [mass[i] * solved[i] for i in range(n)]
        err_norm, bad_e = _finite(norm(torch.stack(to_user(err_rows))
                                       / scale))
        bad_m = bad_y.any(0) | bad_e
        err_norm = torch.where(bad_m, err_norm + 10.0, err_norm)
        accepted = conv_all & (err_norm < 1.0) & ~bad_m

        # implicit controller
        err_c = torch.clamp(err_norm, min=1e-30)
        f_std = torch.minimum(cc.safety * err_c ** cc.error_exponent,
                              max_fac)
        hr = h / torch.where(h_prev == 0.0, h, h_prev)
        f_2nd = torch.minimum(torch.clamp(
            cc.safety_sc * err_c ** cc.minbeta1
            * torch.clamp(err_old, min=1e-30) ** cc.minbeta2
            * torch.clamp(torch.abs(hr), min=1e-30) ** cc.minalpha,
            min=cc.min_factor), max_fac)
        is_tiny = err_norm < tiny_err
        fac_acc = torch.where(is_tiny, max_fac,
                              torch.where(std_b, f_std, f_2nd))
        on_scale = max_fac == MAX_FACTOR
        std_after = is_tiny | torch.where(std_b & on_scale, False, std_sc)
        fac_acc = torch.where(rejected, torch.clamp(fac_acc, max=1.0),
                              fac_acc)
        std_after = std_after | rejected
        max_fac_new = torch.where(fac_acc < MAX_FACTOR, MAX_FACTOR, max_fac)
        f_rej = torch.clamp(cc.safety * err_c ** cc.error_exponent,
                            min=cc.min_factor)
        # convergence failure: the rate-based reduction
        f_nrf = torch.clamp(torch.where(
            Rate > 0.0, MAX_RATE / torch.clamp(Rate, min=1e-30),
            MIN_FACTOR), MIN_FACTOR, MAX_FACTOR_NRF)
        h_abs_next, _ = _finite(h_a * torch.where(
            accepted, fac_acc, torch.where(conv_all, f_rej, f_nrf)))

        # a rejected attempt whose reduced h falls below min_step ends
        # the member (status 2) instead of being clamped back up
        too_small = too_small | (running & ~accepted
                                 & (h_abs_next < min_step))
        status = torch.where(running & too_small, TOO_SMALL_STEP, status)
        # double-single t advance; the landing test uses the remainder
        t_adv, t_lo_adv = _df_add(t, t_lo, h)
        rem = (tf - t_adv) - t_lo_adv
        is_last = accepted & (torch.abs(rem) <= k["land_tol"] * h_a)
        t_new = torch.where(is_last, tf, t_adv)
        t_lo_new = torch.where(is_last, 0.0, t_lo_adv)
        status = torch.where((status == RUNNING) & is_last, FINISHED,
                             status)
        # step cap: loop iterations, accepted plus rejected
        it += 1
        status = torch.where((status == RUNNING) & (it >= max_steps),
                             OVERFLOW, status).to(torch.int32)
        yp_new, _ = _finite(torch.stack(K[s - 1]))

        upd = accepted
        y = torch.where(upd, y_new, y)
        y_lo = torch.where(upd, y_lo_new, y_lo)
        yp = torch.where(upd, yp_new, yp)
        t = torch.where(upd, t_new, t)
        t_lo = torch.where(upd, t_lo_new, t_lo)
        h_abs = torch.where(running, h_abs_next, h_abs)
        std_sc = torch.where(upd, std_after, std_sc | (running & ~accepted))
        err_old = torch.where(upd, err_norm, err_old)
        h_prev = torch.where(upd, h, h_prev)
        max_fac = torch.where(upd, max_fac_new, max_fac)
        rejected = ~upd & (rejected | (running & ~too_small & ~accepted))
        nstep = nstep + upd.to(torch.int32)
        nfev = nfev + torch.where(running, nfev_d, 0).to(torch.int32)

    if rot is not None:
        y = torch.stack(_mat_rows(rot[0].T, rows(y)))
    return y.T.contiguous(), status, nstep, nfev



def _kernel(method, fun, M, m_diag, rot, n):
    """The kernel built for one method, FusedRHS and mass-matrix setup."""
    if method is None:
        from ..methods import Kv3I as method
    from . import _build
    return _build.cached(
        "fused_esdirk", (method, fun),
        lambda: _build.load_fused_esdirk(_esdirk_consts(method), m_diag, rot,
                                         n, fun.cuda_src),
        None if M is None else np.asarray(M, np.float64).tobytes())


def solve_fused_esdirk(fun, t_span, y0_batch, method=None, M=None,
                       yp0_batch=None, rtol=1e-4, atol=1e-6,
                       first_step=None, max_steps=100_000,
                       block_members=128, compensated=False, t_eval=None,
                       events=None, max_step=None, params=None,
                       block_base=None, dense=None):
    """Integrate an ensemble of small stiff systems or index-1 DAEs in one
    kernel launch.

    ``y0_batch``: (B, n) float32, n <= 8.  ``M``: None, a length-n
    diagonal (zeros mark algebraic rows), or a dense/hidden ``(n, n)``
    mass matrix.  ``yp0_batch``: (B, n) consistent initial derivatives,
    required for DAEs (e.g. from the f64 stepper's ``init``); for ODEs it
    defaults to ``M^-1 f(t0, y0)``.  Without ``first_step`` a plain ODE
    starts from the in-kernel Watts estimate and a DAE from 1% of the
    span.  Returns ``(y_final (B, n), status (B,), nsteps (B,), nfev
    (B,))`` with status 1 = finished, 2 = step size underflow, 3 = step
    cap (``max_steps`` counts loop iterations, accepted plus rejected).

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.
    On a CUDA tensor ``fun`` must be a :class:`FusedRHS` whose
    ``cuda_src`` defines the template ``rhs<T>`` (see ``csrc/dual.cuh``),
    and the call launches ``csrc/fused_esdirk.cu`` (built at first use)
    with ``block_members`` threads per block, or raises.  On a CPU tensor
    it runs :func:`fused_esdirk_reference`, with a :class:`FusedRHS` or a
    plain rows-first torch function.

    ``t_eval``, ``events``, ``params``, ``block_base`` and ``dense`` are
    not ported yet.
    """
    for name, value in (("t_eval", t_eval), ("events", events),
                        ("params", params), ("block_base", block_base),
                        ("dense", dense)):
        if value is not None:
            raise NotImplementedError(
                f"solve_fused_esdirk({name}=...) is not ported yet: ROADMAP "
                "queue B, item B2 (remaining options)")
    y0 = as_input(y0_batch, torch.float32)
    if y0.ndim != 2 or y0.shape[1] > 8:
        raise ValueError("fused ESDIRK takes y0_batch of shape (B, n) with "
                         "n <= 8; use solve_ensemble for larger states")
    if y0.device.type != "cuda":
        return fused_esdirk_reference(
            fun, t_span, y0, method=method, M=M, yp0_batch=yp0_batch,
            rtol=rtol, atol=atol, first_step=first_step,
            max_steps=max_steps, compensated=compensated, max_step=max_step)

    if not isinstance(fun, FusedRHS):
        raise TypeError("solve_fused_esdirk on a CUDA tensor needs a "
                        "FusedRHS (a CUDA source of the right-hand side); "
                        f"got {type(fun).__name__}")
    nb, n = y0.shape
    if n != fun.n:
        raise ValueError(f"y0_batch must be (B, {fun.n}), got "
                         f"{tuple(y0.shape)}")
    y0 = y0.contiguous()
    yp0 = None if yp0_batch is None else torch.as_tensor(
        yp0_batch, device=y0.device)
    if yp0 is not None:
        if yp0.shape != y0.shape:
            raise ValueError("yp0_batch must have the shape of y0_batch")
        yp0 = yp0.contiguous()
    for name, x in (("y0_batch", y0), ("yp0_batch", yp0)):
        if x is not None and (x.dtype != torch.float32
                              or x.device != y0.device):
            raise TypeError(f"{name} must be float32 on {y0.device}")
    if not 1 <= block_members <= 1024:
        raise ValueError("block_members must be in [1, 1024]")
    m_diag, rot = _mass_setup(M, n)
    if m_diag is not None and yp0 is None and np.any(m_diag == 0.0):
        raise ValueError("DAE: pass consistent yp0_batch (e.g. from the "
                         "f64 stepper's init)")

    built = _kernel(method, fun, M, m_diag, rot, n)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    if nb == 0:
        return y_out, status, nsteps, nfev
    t0, tf = np.float32(t_span[0]), np.float32(t_span[1])
    use_hstart = first_step is None and M is None
    if first_step is not None:
        h0 = np.float32(first_step)
    else:
        h0 = np.float32(0.01) * abs(tf - t0)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        rc = built.lib.fused_esdirk_launch(
            y0.data_ptr(), None if yp0 is None else yp0.data_ptr(),
            y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
            nfev.data_ptr(), nb, float(t0), float(tf), float(rtol),
            float(atol), float(h0), int(use_hstart), int(yp0 is not None),
            np.inf if max_step is None else float(max_step),
            int(max_steps), _tiny_err(n, rtol), int(bool(compensated)),
            int(block_members), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_esdirk kernel launch failed: CUDA error {rc}")
    solve_fused_esdirk.launches += 1
    return y_out, status, nsteps, nfev


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count)
solve_fused_esdirk.launches = 0
