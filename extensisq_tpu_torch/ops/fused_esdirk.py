"""Fused implicit ensemble solver: the whole adaptive ESDIRK integration,
stiff ODEs and index-1 DAEs, in one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_esdirk.py``.  The kernel
(``csrc/fused_esdirk.cu``) runs each member on a group of G lanes of one
warp or on one thread (G from :func:`_lanes_per_member`): the Jacobian,
the pivoted factor of the Newton matrix, the stages, the modified-Newton
iterations, the error filter, the implicit controller and the time loop
all stay in registers for the whole integration, and a group's lanes
split the Jacobian's dual evaluations.  Its plain PyTorch
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

``params`` (B, k) gives every member its own parameters; the Jacobian is
taken at fixed parameters.  ``block_base`` is the simultaneous corrector
of the variational systems of ``ops/fused_sens.py``: W is built and
factored on the first ``block_base`` rows and columns only and solves
every block of ``block_base`` rows.  ``dense=R`` records each member's
accepted steps ``(t, y, y')``, y' the stiffly accurate last stage, in user
coordinates, for a continuous dense output (``ops/fused_dense.py``), and
``t_eval`` returns each member's state at the given times, the cubic
Hermite of the accepted step that crosses each with the same y', written
inside the kernel (``csrc/snapshot.cuh``), in user coordinates too.
"""
import numpy as np
import torch

from .._config import (RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW,
                       NEWTON_MAXITER, MAX_RATE, MAX_FACTOR_NRF, MIN_FACTOR,
                       MAX_FACTOR, MAX_FACTOR0)
from .._device import as_input
from ..core.controller import resolve_controller
from ..core.linalg import seed_jvps
from ..core.numerics import norm
from ..steppers.erk import weighted_sum
from ..steppers.esdirk import jacfwd
from . import _hstart_tile
from .fused_erk import (DenseRecord, FusedRHS, SnapPoints, Snapshots,
                        _Record, _comp_wsum, _df_add, _launch_shape,
                        _two_sum, bind_params, check_options, dense_rows,
                        eval_points, lanes_within_budget, member_params,
                        snap_outputs)

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


def _block_checks(block_base, M, n):
    """The base block's rows: ``n``, or ``block_base`` where it divides n
    with block_base <= 8 and n <= 64 and no mass matrix is given (else
    ``ValueError``, as in JAX)."""
    if block_base is None:
        if n > 8:
            raise ValueError("fused ESDIRK takes y0_batch of shape (B, n) "
                             "with n <= 8; use solve_ensemble for larger "
                             "states")
        return n
    nbase = int(block_base)
    if M is not None:
        raise ValueError("block_base (simultaneous corrector) supports "
                         "plain ODEs only, no mass matrix")
    if nbase < 1 or n % nbase or nbase > 8 or n > 64:
        raise ValueError("block_base must divide n, with block_base <= 8 "
                         "and n <= 64")
    return nbase


def fused_esdirk_reference(fun, t_span, y0_batch, method=None, M=None,
                           yp0_batch=None, rtol=1e-4, atol=1e-6,
                           first_step=None, max_steps=100_000,
                           compensated=False, max_step=None, params=None,
                           block_base=None, dense=None, t_eval=None):
    """The plain PyTorch version of the fused ESDIRK kernel, on the device
    of ``y0_batch``.

    Runs the kernel's loop for the whole batch at once in float32: each
    iteration is one attempt of every running member, and the loop ends
    once no member is RUNNING.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function, called as ``fun(t, y, p)`` where
    ``params`` (B, k) is given.  With ``block_base`` the Newton matrix is
    the first ``block_base`` rows and columns of the Jacobian and solves
    each block of as many rows.  Returns ``(y (B, n), status (B,), nsteps
    (B,), nfev (B,))`` like :func:`solve_fused_esdirk`; with ``t_eval``
    the rows ``y_eval`` (len(t_eval), B, n) after them (formed in the
    rotated coordinates of a dense or hidden ``M`` and mapped back as y
    is), and with ``dense=R`` the members'
    :class:`~.fused_dense.FusedDenseSolution` last, from the rows the
    kernel writes.
    """
    k = _esdirk_consts(method)
    f32 = torch.float32
    y = torch.as_tensor(y0_batch).to(f32).T.contiguous()
    y_user = y
    n, nb = y.shape
    dev = y.device
    nbase = _block_checks(block_base, M, n)
    fun = bind_params(fun, member_params(params, y.T, fun))
    m_diag, rot = _mass_setup(M, n)
    if m_diag is not None and yp0_batch is None and np.any(m_diag == 0.0):
        raise ValueError("DAE: pass consistent yp0_batch (e.g. from the "
                         "f64 stepper's init)")
    is_alg = [m_diag is not None and m_diag[i] == 0.0 for i in range(n)]
    mass = [1.0 if m_diag is None else float(m_diag[i]) for i in range(n)]

    def mat(c, x):
        return torch.stack(_mat_rows(c, list(x)))

    if rot is not None:
        Vh, UTs = rot
        V = Vh.T
        user_fun = fun

        def fun(t, w):                       # noqa: F811
            return mat(UTs, user_fun(t, mat(V, w)))

        def to_user(x):
            return mat(V, x)
        y = mat(Vh, y)
    else:
        to_user = None

    t0 = torch.full((nb,), _f32(t_span[0]), dtype=f32, device=dev)
    tf = torch.full((nb,), _f32(t_span[1]), dtype=f32, device=dev)
    if yp0_batch is not None:
        yp = torch.as_tensor(yp0_batch).to(device=dev, dtype=f32).T
        if rot is not None:
            yp = mat(Vh, yp)
    else:
        yp = fun(t0, y)
        if m_diag is not None and rot is None:
            yp = torch.stack([yp[i] * _f32(1.0 / mass[i]) for i in range(n)])
    h_abs = _start_step(fun, k, t0, tf, y, yp, rtol, atol, first_step,
                        max_step, m_diag is None and rot is None)

    if nbase == n:
        jac = jacfwd(fun, n)
    else:
        # the base block: the first nbase rows of the JVPs along the first
        # nbase columns, as the JAX kernel's linearization gives it
        seeds = torch.eye(nbase, n, dtype=f32, device=dev)

        def jac(tc, yy):
            return seed_jvps(lambda t_, y_: fun(t_, y_)[:nbase], tc, yy,
                             seeds).permute(2, 1, 0)

    def factor(tc, yy, hd):
        """W = Sc (M - h d J) by the JAX kernel's bubble elimination."""
        J = jac(tc, yy)
        return _gauss_factor([[-J[:, i, j] if is_alg[i]
                               else (mass[i] if i == j else 0.0)
                               - hd * J[:, i, j] for j in range(nbase)]
                              for i in range(nbase)])

    def solve(fact, b):
        b = list(b)
        return torch.stack([x for i in range(0, n, nbase)
                            for x in _gauss_replay(fact, b[i:i + nbase])])

    rows = dense_rows(dense)
    rec = (_Record(y_user, yp if to_user is None else to_user(yp), rows)
           if rows else None)
    tq = eval_points(t_eval)
    snaps = None if tq is None else Snapshots(tq, y, torch.sign(tf - t0))
    y, status, nstep, nfev, *y_eval = run_esdirk_loop(
        fun, k, t0, tf, y, yp, h_abs, 0 if yp0_batch is not None else 1,
        rtol, atol, max_steps, compensated, max_step,
        torch.tensor(mass, dtype=f32, device=dev)[:, None],
        torch.tensor(is_alg, device=dev)[:, None], factor, solve, to_user,
        rec, snaps)
    if rot is not None:
        # back to the user's y = V w, the rows as y
        y = mat(rot[0].T, y)
        y_eval = [torch.stack([mat(rot[0].T, r.T).T for r in y_eval[0]])
                  ] if y_eval else []
    out = (y.T.contiguous(), status, nstep, nfev, *y_eval)
    if rec is None:
        return out
    return out + (rec.solution(t_span, nstep),)


def _start_step(fun, k, t0, tf, y, yp, rtol, atol, first_step, max_step,
                watts):
    """The first |h| of every member: ``first_step``; else Watts' estimate
    where ``watts`` (plain ODEs; its evaluations are not counted), 1% of
    the span otherwise."""
    full = torch.full_like(t0, 1.0)
    if first_step is not None:
        return full * _f32(first_step)
    direction = torch.sign(tf - t0)
    if watts:
        bq = t0 + direction * torch.clamp(
            torch.abs(tf - t0), max=np.inf if max_step is None
            else float(max_step))
        return torch.abs(_hstart_tile.hstart_tile(
            fun, t0, bq, y, yp, k["morder"], full * _f32(rtol),
            full * _f32(atol)))
    return 0.01 * torch.abs(tf - t0)


def run_esdirk_loop(fun, k, t, tf, y, yp, h_abs, nfev0, rtol, atol,
                    max_steps, compensated, max_step, mass, alg, factor,
                    solve, to_user=None, record=None, snaps=None):
    """The fused ESDIRK loop, shared by the plain versions of B2 and B7.

    ``fun`` is the rows-first torch function of the integrated system, ``k``
    the method's constants (:func:`_esdirk_consts`); ``y``, ``yp`` (n, B)
    the members' start and its derivative, ``h_abs`` (B,) the first |h| and
    ``nfev0`` the evaluations counted so far; ``mass`` (n, 1) the mass
    diagonal (ones for ODEs) and ``alg`` (n, 1) its algebraic rows.  The
    linear algebra is a parameter: ``factor(tc, y, hd)`` builds and factors
    the Newton matrix ``W = M - hd J(tc, y)`` (the algebraic rows ``-J``)
    once per attempt, ``solve(fact, b)`` solves ``W x = b`` for (n, B) rows
    ``b``.  ``to_user`` maps rows to the user's coordinates, where every
    norm is taken (identity when None).  ``record``, a
    ``fused_erk._Record`` or None, takes each accepted step's end ``(t,
    y, y')`` in user coordinates while the attempts are below its rows, as
    the kernels write it.  ``snaps``, a ``fused_erk.Snapshots`` or None,
    takes each accepted step's end pairs ``(y, y')`` (the high words of y
    and t in the compensated mode, y' the sanitized last stage and the one
    carried in), as JAX's loop does, in the integrated coordinates.
    Returns ``(y (n, B), status, nsteps, nfev)``, and with ``snaps`` the
    rows ``y_eval`` (nq, B, n) fifth."""
    A, C, E, Az = k["A"], k["C"], k["E"], k["Az"]
    s, dd, kappa, cc = k["s"], k["d"], k["kappa"], k["cc"]
    h_min_a, h_min_b = k["h_min_a"], k["h_min_b"]
    n, nb = y.shape
    dev = y.device
    # rows-first and contiguous, so that every norm sums over the rows in
    # one order
    y, yp = y.contiguous(), yp.contiguous()
    tiny_err = _tiny_err(n, rtol)
    if to_user is None:
        def to_user(x):
            return x
    i32 = dict(dtype=torch.int32, device=dev)
    direction = torch.sign(tf - t)
    rtol_r = torch.full_like(t, _f32(rtol))
    atol_r = torch.full_like(t, _f32(atol))
    t_lo = torch.zeros_like(t)
    y_lo = torch.zeros_like(y)
    status = torch.full((nb,), RUNNING, **i32)
    std_sc = torch.ones(nb, dtype=torch.bool, device=dev)
    rejected = torch.zeros_like(std_sc)
    err_old = torch.ones_like(t)
    h_prev = torch.zeros_like(t)
    max_fac = torch.full_like(t, MAX_FACTOR0)
    nstep = torch.zeros(nb, **i32)
    nfev = torch.full((nb,), nfev0, **i32)

    def newton(t_stage, z, h, psi, yu_c, fact):
        """Modified Newton for one stage, each member stopping on its own.
        Returns (converged, z, rate, nfev, bad)."""
        rate = torch.full_like(h, -1.0)          # < 0: not yet measured
        dz_old = torch.zeros_like(h)
        conv = torch.zeros_like(std_sc)
        stop = torch.zeros_like(std_sc)
        bad_any = torch.zeros_like(std_sc)
        nf = torch.zeros(nb, **i32)
        for it in range(NEWTON_MAXITER):
            active = ~stop
            if not bool(active.any()):
                break
            y_pred = psi + dd * z
            fs, bad = _finite(fun(t_stage, y_pred))
            bad = bad.any(0)
            nf = nf + active.to(torch.int32)
            dz, bd = _finite(solve(fact, torch.where(
                alg, fs * k["inv_d"], h * fs - mass * z)))
            bad = bad | bd.any(0)
            scale = atol_r + rtol_r * torch.maximum(torch.abs(yu_c),
                                                    torch.abs(to_user(y_pred)))
            dz_norm, bn = _finite(norm(to_user(dz) / scale))
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
            z = torch.where(keep, z + dz, z)
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

        # the Newton matrix, factored once per attempt
        hd = h * dd
        fact = factor(tc, y, hd)

        # stages (stage 0 explicit: K0 = yp; h * K_j == z_j)
        K = [yp]
        Z = [h * yp]
        yu_c = to_user(y)
        conv_all = running & ~too_small
        Rate = torch.zeros_like(h)
        nfev_d = torch.zeros(nb, **i32)
        for si in range(1, s):
            if compensated:
                acc, cmp = _comp_wsum(Z[:si], A[si, :si])
                psi = y + (acc + (cmp + y_lo))
            else:
                psi = y + h * weighted_sum(K[:si], A[si, :si])
            z0 = h * weighted_sum(K[:si], Az[si, :si])
            conv_s, z, rate_s, nfev_s, bad_s = newton(
                tc + float(C[si]) * h, z0, h, psi, yu_c, fact)
            conv_all = conv_all & conv_s & ~bad_s
            Rate = torch.maximum(Rate, rate_s)
            nfev_d = nfev_d + nfev_s
            K.append(z * (1.0 / h))
            Z.append(z)

        # solution and error estimate; stiffly accurate methods:
        # y_new = psi + d z of the last stage
        if compensated:
            inc_s, inc_c = _comp_wsum(Z, A[s - 1, :s])
            hi, lo1 = _df_add(y, y_lo, inc_s)
            y_new, y_lo_new = _two_sum(hi, lo1 + inc_c)
        else:
            y_new = psi + dd * z
            y_lo_new = y_lo
        y_new, bad_y = _finite(y_new)
        scale = atol_r + rtol_r * torch.maximum(torch.abs(yu_c),
                                                torch.abs(to_user(y_new)))
        if compensated:
            acc, cmp = _comp_wsum(Z, E[:s])
            err = acc + cmp
        else:
            err = h * weighted_sum(K, E[:s])
        if k["filter_error"]:
            err = mass * solve(fact, torch.where(alg, err * (1.0 / hd), err))
        err_norm, bad_e = _finite(norm(to_user(err) / scale))
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
        rec_row = record is not None and it < record.rows
        # step cap: loop iterations, accepted plus rejected
        it += 1
        status = torch.where((status == RUNNING) & (it >= max_steps),
                             OVERFLOW, status).to(torch.int32)
        yp_new, _ = _finite(K[s - 1])
        if rec_row:
            record.write(accepted, nstep, t_new, to_user(y_new),
                         to_user(yp_new))
        if snaps is not None:
            snaps.step(accepted, t, t_new, h, y, yp, y_new, yp_new)

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
    if snaps is not None:
        return y, status, nstep, nfev, snaps.rows(t, y)
    return y, status, nstep, nfev


# the lane counts the wrapper takes besides 1, most first
_LANES = (32, 16, 8, 4)


def _lanes_per_member(B, sm_count, n):
    """Lanes per member for an ensemble of ``B`` members of ``n`` states on
    a card of ``sm_count`` SMs: the largest G of 32, 16, 8 and 4 with
    B G <= 128 sm_count, else 1 (one thread per member).

    From the member sweep of the pendulum bench line (n = 5, Kv3I, 707
    steps of the slowest member; ``tools/probe_fused_esdirk.py``) on an
    H100 (132 SMs, 700 W), device ms of one thread per member against the
    lane groups G = 4 / 8 / 16 / 32: 512 members 3.750 against 3.417 /
    3.040 / 2.940 / 2.740; 1,024: 3.709, 3.391 / 3.054 / 2.975 / 3.190;
    2,048: 3.768, 3.378 / 3.046 / 3.365 / 4.358; 4,096: 3.734, 3.362 /
    3.418 / 4.523 / 8.046; 8,192: 3.755, 3.800 at G = 4; 16,384: 3.726,
    4.948.  The best G puts about 16,384 threads on the card (one warp
    per SM sub-partition): a member's lanes run one chain of dependent
    operations, the norms' divisions and the controller's powers split
    over them, and a second warp per scheduler already costs issue slots.
    ``n`` (at most 8) is not used yet: the sweep ran at n = 5 only."""
    return lanes_within_budget(B, sm_count, _LANES)


def _kernel(method, fun, M, m_diag, rot, n, nbase, record=False,
            snap=False):
    """The kernel built for one method, FusedRHS, mass-matrix setup and
    base block, with the dense record where ``record`` and the t_eval
    snapshots where ``snap`` (each switch a build of its own)."""
    if method is None:
        from ..methods import Kv3I as method
    from . import _build
    return _build.cached(
        "fused_esdirk", (method, fun),
        lambda: _build.load_fused_esdirk(
            _esdirk_consts(method), m_diag, rot, n, fun.cuda_src, fun.k,
            None if nbase == n else nbase, record, snap),
        (None if M is None else np.asarray(M, np.float64).tobytes(),
         nbase, bool(record), bool(snap)))


def solve_fused_esdirk(fun, t_span, y0_batch, method=None, M=None,
                       yp0_batch=None, rtol=1e-4, atol=1e-6,
                       first_step=None, max_steps=100_000,
                       block_members=None, compensated=False, t_eval=None,
                       events=None, max_step=None, params=None,
                       block_base=None, dense=None):
    """Integrate an ensemble of small stiff systems or index-1 DAEs in one
    kernel launch.

    ``y0_batch``: (B, n) float32, n <= 8 (n <= 64 with ``block_base``).
    ``M``: None, a length-n diagonal (zeros mark algebraic rows), or a
    dense/hidden ``(n, n)`` mass matrix.  ``yp0_batch``: (B, n)
    consistent initial derivatives, required for DAEs (e.g. from the f64
    stepper's ``init``); for ODEs it defaults to ``M^-1 f(t0, y0)``.
    Without ``first_step`` a plain ODE starts from the in-kernel Watts
    estimate and a DAE from 1% of the span.  Returns ``(y_final (B, n),
    status (B,), nsteps (B,), nfev (B,))`` with status 1 = finished, 2 =
    step size underflow, 3 = step cap (``max_steps`` counts loop
    iterations, accepted plus rejected).

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.
    On a CUDA tensor ``fun`` must be a :class:`FusedRHS` whose
    ``cuda_src`` defines the template ``rhs<T>`` (see ``csrc/dual.cuh``),
    and the call launches ``csrc/fused_esdirk.cu`` (built at first use) or
    raises: G lanes per member, G from :func:`_lanes_per_member` (the
    ensemble size, the card's SM count and n), and ``block_members``
    members per block (None: 128 / G), so ``block_members * G`` threads
    per block, at most 1024; the shape taken is left in
    ``solve_fused_esdirk.last_shape``.  On a CPU tensor it runs
    :func:`fused_esdirk_reference`, with a :class:`FusedRHS` or a plain
    rows-first torch function.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument (see :class:`FusedRHS`; the CUDA source in
    the template form ``rhs<T>(t, y, dy, p)``).

    ``block_base``: the simultaneous corrector (CVODES's SIM scheme) for
    the variational systems of ``ops/fused_sens.py``.  The state is
    ``n = block_base x blocks`` rows whose Jacobian is block lower
    triangular with every diagonal block the base block, the first
    ``block_base`` rows and columns; W is built and factored on the base
    block only, and each Newton iteration and the error filter solve every
    block of rows with that one factor.  Error control runs on the whole
    state.  ``block_base`` must divide n, with block_base <= 8 and
    n <= 64, and no ``M`` (``ValueError``).  On the card the source also
    defines ``base_rhs``, the first block's right-hand side in the form of
    ``rhs`` (``ops/fused_sens.py`` generates it), from which the kernel
    takes the base block's Jacobian.

    ``dense=R`` (R >= 1; None or 0: off) adds a fifth output, the members'
    continuous dense output (:class:`~.fused_dense.FusedDenseSolution`),
    from the end ``(t, y, y')`` of each accepted step that the kernel
    records while a member's attempts are below R (``valid[b]`` False
    where more were needed), y' the stiffly accurate last stage; the rows
    are in user coordinates (a dense or hidden ``M`` maps them back as it
    maps ``y_final``), of the whole augmented state with ``block_base``;
    the record leaves the other four outputs bit for bit as they are
    without it.

    ``t_eval``: times (taken as float32, in any order, repeats and points
    outside the span allowed) at which to return each member's state,
    ``y_eval`` (len(t_eval), B, n) after ``nfev`` (before the dense
    output): the cubic Hermite of the accepted step that crosses each
    point, from its end pairs ``(y, y')`` with y' the stiffly accurate
    last stage, written inside the kernel (a build of its own,
    ``csrc/snapshot.cuh``) in user coordinates (a dense or hidden ``M``
    maps each row back as it maps ``y_final``); points at or before t0
    take y0, points a member never reaches its final y (a member that
    ended with status 2 or 3 included).  It leaves the four outputs bit
    for bit as they are without it.  No points: the four outputs alone.
    ``events`` is not ported yet.
    """
    check_options("solve_fused_esdirk", "B2", events=events)
    y0 = as_input(y0_batch, torch.float32)
    if y0.ndim != 2:
        raise ValueError("fused ESDIRK takes y0_batch of shape (B, n)")
    _block_checks(block_base, M, y0.shape[1])
    params = member_params(params, y0, fun)
    if y0.device.type != "cuda":
        return fused_esdirk_reference(
            fun, t_span, y0, method=method, M=M, yp0_batch=yp0_batch,
            rtol=rtol, atol=atol, first_step=first_step,
            max_steps=max_steps, compensated=compensated, max_step=max_step,
            params=params, block_base=block_base, dense=dense,
            t_eval=t_eval)

    out, shape = _launch(fun, t_span, y0, method, M, yp0_batch, rtol, atol,
                         first_step, max_steps, compensated, max_step, None,
                         block_members, params, block_base, dense, t_eval)
    solve_fused_esdirk.launches += 1
    solve_fused_esdirk.last_shape = shape
    return out


def _launch(fun, t_span, y0, method, M, yp0_batch, rtol, atol, first_step,
            max_steps, compensated, max_step, lanes, block_members=None,
            params=None, block_base=None, dense=None, t_eval=None):
    """B2 on the card for the CUDA tensor ``y0`` (with the members'
    ``params`` and the base block ``block_base``, checked as the wrapper
    checks them): ``lanes`` lanes per member (None:
    :func:`_lanes_per_member`'s) and ``block_members`` members per block
    (None: 128 / lanes), with the dense record of ``dense`` rows a member
    and the rows of ``t_eval`` (each switch the build with it) where
    given.  Returns the outputs (``y_eval`` and the
    :class:`~.fused_dense.FusedDenseSolution` after the four) and the
    ``(lanes, block_members)`` taken."""
    if not isinstance(fun, FusedRHS):
        raise TypeError("solve_fused_esdirk on a CUDA tensor needs a "
                        "FusedRHS (a CUDA source of the right-hand side); "
                        f"got {type(fun).__name__}")
    nb, n = y0.shape
    if n != fun.n:
        raise ValueError(f"y0_batch must be (B, {fun.n}), got "
                         f"{tuple(y0.shape)}")
    nbase = _block_checks(block_base, M, n)
    params = member_params(params, y0, fun)
    if params is not None:
        params = params.contiguous()
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
    if lanes is None:
        lanes = _lanes_per_member(nb, torch.cuda.get_device_properties(
            y0.device).multi_processor_count, n)
    block_members, _, _ = _launch_shape(nb, lanes, block_members)
    m_diag, rot = _mass_setup(M, n)
    if m_diag is not None and yp0 is None and np.any(m_diag == 0.0):
        raise ValueError("DAE: pass consistent yp0_batch (e.g. from the "
                         "f64 stepper's init)")

    rows = dense_rows(dense)
    tq = eval_points(t_eval)
    built = _kernel(method, fun, M, m_diag, rot, n, nbase, rows > 0,
                    tq is not None)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    shape = (lanes, block_members)
    rec = DenseRecord(y0, rows)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = snap_outputs((y_out, status, nsteps, nfev), snap)
    if nb == 0:
        return rec.outputs(out, t_span, y0), shape
    t0, tf = np.float32(t_span[0]), np.float32(t_span[1])
    use_hstart = first_step is None and M is None
    if first_step is not None:
        h0 = np.float32(first_step)
    else:
        h0 = np.float32(0.01) * abs(tf - t0)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), None if yp0 is None else yp0.data_ptr(),
                None if params is None else params.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), nb, float(t0), float(tf), float(rtol),
                float(atol), float(h0), int(use_hstart),
                int(yp0 is not None),
                np.inf if max_step is None else float(max_step),
                int(max_steps), _tiny_err(n, rtol), int(bool(compensated)),
                int(lanes), block_members)
        if snap is not None:
            rc = built.lib.fused_esdirk_snap_launch(*args, *rec.args(),
                                                    *snap.args(), stream)
        elif rows:
            rc = built.lib.fused_esdirk_record_launch(*args, *rec.args(),
                                                      stream)
        else:
            rc = built.lib.fused_esdirk_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_esdirk kernel launch failed: CUDA error {rc}")
    return rec.outputs(out, t_span, y0), shape


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count) and the (lanes per member, members per block)
# of the last launch
solve_fused_esdirk.launches = 0
solve_fused_esdirk.last_shape = None
