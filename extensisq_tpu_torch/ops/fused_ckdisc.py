"""Fused CKdisc solver: the variable-order cascade for non-smooth ensembles,
the whole adaptive integration in one CUDA kernel launch.

Counterpart of ``extensisq_tpu/ops/fused_ckdisc.py``.  CKdisc (extensisq
``cash.py``) anticipates failure: staged error assessments E1 and E2 after
stages 2 and 4 veto the remaining stages, and fallback solutions of order 3
and 2 advance a member to c = 3/5 or 1/5 of the step with no further
evaluations; the twiddle and quit factors adapt per member.

The kernel (``csrc/fused_ckdisc.cu``) runs each member on G lanes of one
warp (G from :func:`_lanes_per_member`) or on one thread, with the state
and stage rows in registers: every lane runs the member's stages, so the
group takes the cascade's branches together, and the lanes split each
assessment's divisions and the step control's.  Unlike the TPU kernel,
which computes all six stages for every member and applies the cascade as
masks, a member really skips stages 3-6 when E1 or E2 vetoes, and
evaluates the endpoint only on acceptance; ``nfev`` counts the evaluations
of the reference method (``1 + 2 go2 + 2 go4`` per attempt, plus the
endpoint of an accepted one) on both.  Its plain PyTorch version,
:func:`fused_ckdisc_reference`, runs the same loop, :func:`run_ck_loop`
(shared with the mid-size layout of ``ops/fused_ckdisc_grid.py``), on
rows-first ``(n, B)`` float32 tensors; the wrapper
:func:`solve_fused_ckdisc` takes it only for tensors on the CPU.

Numerics follow the JAX kernel with its Mosaic workarounds left out: the
roots are ``pow`` of the norm floored at 1e-30 (the floor is the method's:
it keeps E4 >= 1e-6, and E4 divides the quit-factor update), a non-finite
norm counts as 1e30 before any comparison or floor, so it rejects, and a
member whose accepted state or endpoint derivative is not finite ends with
status 3 (the JAX kernel scrubs such values to 1.0 and runs on).  float32
only, as the JAX kernels.

``params`` (B, k) gives every member its own k parameters, as on B1
(``FusedRHS(torch_fn, cuda_src, n, k)``); ``t_eval`` returns each member's
state at the given times, the cubic Hermite over the accepted sub-step
``[t, t + h_used]`` that crosses each (``csrc/snapshot.cuh``).
"""
import numpy as np
import torch

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW
from .._device import as_input
from ..core.controller import resolve_controller
from ..core.numerics import norm, over
from ..steppers.erk import weighted_sum
from . import _hstart_tile
from .fused_erk import (FusedRHS, SnapPoints, Snapshots, _launch_shape,
                        bind_params, check_options, device_sm_count,
                        eval_points, fresh_step, lanes_within_budget,
                        launch_args, member_params, snap_outputs)

SAFETY = 0.9
MAX_FACTOR_CK = 5.0
MIN_FACTOR_CK = 0.2
# a non-finite error norm counts as this, so that the attempt rejects
BIG = float(np.float32(1e30))
# the roots' floor
ROOT_FLOOR = 1e-30


def ck_consts():
    """The CKdisc tableau, its cascade weights and the step-size constants
    as float32 values, rounded as the JAX kernel rounds them (the port's
    ``methods/erk.py`` data)."""
    from ..methods.erk import CKdisc, CKDISC_DATA
    tab = CKdisc.tableau
    f32 = np.float32
    err_order = min(tab.order_secondary, tab.order)
    return {
        "name": tab.name,
        "A": np.asarray(tab.A, f32), "B": np.asarray(tab.B, f32),
        "C": np.asarray(tab.C, f32), "E": np.asarray(tab.E, f32),
        "B_as": np.asarray(CKDISC_DATA["B_assess"], f32),
        "E_as": np.asarray(CKDISC_DATA["E_assess"], f32),
        "C_fb": np.asarray(CKDISC_DATA["C_fallback"], f32),
        "B_fb": np.asarray(CKDISC_DATA["B_fallback"], f32),
        "E_fb": np.asarray(CKDISC_DATA["E_fallback"], f32),
        "s": tab.n_stages,
        "fsal": False,
        "morder": tab.order_secondary,
        # the method's controller constants: the shared grid body compiles
        # them in, the cascade reads none of them
        "cc": resolve_controller(None, tab.sc_params, -1.0 / (err_order + 1)),
        "tiny_err": float(np.sqrt(np.finfo(np.float32).tiny)),
        "h_min_a": 10.0 * float(np.finfo(np.float32).eps) / tab.c_spacing(),
        "hstart": {"big": _hstart_tile.BIG, "small": _hstart_tile.SMALL,
                   "relper": _hstart_tile.RELPER,
                   "t_floor": 100.0 * _hstart_tile.SMALL_T},
    }


def _root(x, e):
    """``x ** e`` of a norm, floored at ``ROOT_FLOOR``."""
    return torch.pow(torch.clamp(x, min=ROOT_FLOOR), e)


def run_ck_loop(fun, k, t_span, y, rtol, atol, first_step, max_steps,
                max_step, t_eval=None):
    """The fused CKdisc loop (the JAX kernels' ``_run_ck_loop``) on the
    rows-first float32 state ``y`` ``(n, B)``: each iteration is one
    cascade attempt of every running member, and the loop ends once no
    member is RUNNING.  Returns ``(y (B, n), status, nsteps, nfev)``, and
    with ``t_eval`` ``y_eval`` (len(t_eval), B, n) after them
    (:class:`~.fused_erk.Snapshots` over each accepted sub-step)."""
    A, B_w, C, E = k["A"], k["B"], k["C"], k["E"]
    B_as, E_as, B_fb, E_fb = k["B_as"], k["E_as"], k["B_fb"], k["E_fb"]
    c2, c3 = float(k["C_fb"][0]), float(k["C_fb"][1])
    f32 = torch.float32
    n, nb = y.shape
    dev = y.device

    def full(x):
        return torch.full((nb,), x, dtype=f32, device=dev)

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
    status = torch.full((nb,), RUNNING, **i32)
    tw0, tw1, q0, q1 = full(1.5), full(1.1), full(100.0), full(100.0)
    fresh = torch.ones(nb, dtype=torch.bool, device=dev)
    rejected = torch.zeros_like(fresh)
    min_step = torch.zeros_like(t)
    nstep = torch.zeros(nb, **i32)
    nfev = torch.full((nb,), nfev0, **i32)
    tq = eval_points(t_eval)
    snaps = None if tq is None else Snapshots(tq, y, direction)
    it = 0
    while True:
        running = status == RUNNING
        if not bool(running.any()):
            break
        h_abs, min_step, _, d = fresh_step(k, max_step, t, tf, h_abs, fresh,
                                           min_step, fresh)
        too_small = h_abs < min_step
        h = h_abs * direction

        # every stage for every member; the cascade selects
        rows = [f]
        for i in range(1, k["s"]):
            dy = h * weighted_sum(rows, A[i, :i])
            rows.append(fun(t + float(C[i]) * h, y + dy))

        def assess(Bw, Ew, m):
            """(solution, norm, norm not finite) of the weight rows over the
            first m stages; a non-finite norm counts as BIG."""
            sol = y + h * weighted_sum(rows[:m], Bw[:m])
            err = h * weighted_sum(rows[:m], Ew[:m])
            nm = norm(err / (atol_r + rtol_r * torch.maximum(torch.abs(y),
                                                             torch.abs(sol))))
            bad = ~torch.isfinite(nm)
            return sol, torch.where(bad, BIG, nm), bad

        E1 = torch.sqrt(assess(B_as[0], E_as[0], 2)[1])
        go2 = E1 < tw0 * q0
        E2 = torch.where(go2, _root(assess(B_as[1], E_as[1], 4)[1], 1.0 / 3.0),
                         BIG)
        go4 = go2 & (E2 < tw1 * q1)
        y5, nm4, bad4 = assess(B_w, E[:6], 6)
        E4 = _root(nm4, 0.2)
        E4 = torch.where(go4, torch.where(E4 == 0.0, 1e-38, E4), BIG)
        bad4 = go4 & bad4
        accept4 = go4 & (E4 < 1.0) & ~too_small & running

        # twiddle update on a 5th-order rejection, quit update on acceptance
        EQ1, EQ2 = E1 / q0, E2 / q1
        rej5 = go4 & ~accept4 & running
        tw0n = torch.where(rej5 & (EQ1 < tw0), torch.clamp(EQ1, min=1.1), tw0)
        tw1n = torch.where(rej5 & (EQ2 < tw1), torch.clamp(EQ2, min=1.1), tw1)

        def quit_new(Ei, qf):
            qv = Ei / torch.clamp(E4, min=1e-30)
            q_adj = torch.where(qv > qf, torch.minimum(qv, 10.0 * qf),
                                torch.maximum(qv, (2.0 / 3.0) * qf))
            return torch.where(accept4, torch.clamp(q_adj, 1.0, 10000.0), qf)

        q0n, q1n = quit_new(E1, q0), quit_new(E2, q1)

        # the fallbacks
        y3, e3n, _ = assess(B_fb[1], E_fb[1], 4)
        fb3_ok = (go4 & ~accept4 & ~bad4 & (E2 < 1.0) & ~too_small & running
                  & (e3n < 1.0))
        y2, e2n, _ = assess(B_fb[0], E_fb[0], 2)
        fb2_try = (go2 & ~accept4 & ~bad4 & ~fb3_ok & (E1 < 1.0)
                   & ~too_small & running)
        fb2_ok = fb2_try & (e2n < 1.0)
        accepted = accept4 | fb3_ok | fb2_ok

        # the next step size
        esttol = torch.where(go4, E4, torch.where(go2, E2 / q1, E1 / q0))
        fac4 = torch.clamp(over(SAFETY, torch.clamp(E4, min=1e-30)),
                           max=MAX_FACTOR_CK)
        fac4 = torch.where(rejected, torch.clamp(fac4, max=1.0), fac4)
        fac_rej = torch.clamp(over(SAFETY, torch.clamp(esttol, min=1e-30)),
                              min=MIN_FACTOR_CK)
        h_next = torch.where(
            accept4, h_abs * fac4,
            torch.where(fb3_ok, h_abs * c3,
                        torch.where(fb2_try, h_abs * c2, h_abs * fac_rej)))
        h_next = torch.where(torch.isfinite(h_next), h_next, 1.0)

        # a fallback shortens this step: its weights sum to C_fallback
        h_used = torch.where(accept4, h, torch.where(fb3_ok, h * c3, h * c2))
        y_new = torch.where(accept4, y5, torch.where(fb3_ok, y3, y2))
        is_last = accepted & (torch.abs(h_used) >= d)
        t_new = torch.where(is_last, tf, t + h_used)
        f_new = fun(t_new, y_new)
        # overflow: a non-finite accepted state or endpoint derivative ends
        # the member with status 3 (torch.where keeps it out of the others)
        ovf = accepted & ~(torch.isfinite(y_new).all(0)
                           & torch.isfinite(f_new).all(0))
        upd = accepted & ~ovf
        if snaps is not None:
            snaps.step(upd, t, t_new, h_used, y, f, y_new, f_new)

        status = torch.where(running & too_small, TOO_SMALL_STEP,
                             torch.where(running & bad4, OVERFLOW, status))
        status = torch.where((status == RUNNING) & is_last, FINISHED, status)
        status = torch.where(ovf, OVERFLOW, status)
        # step cap: loop iterations, accepted plus rejected
        it += 1
        status = torch.where((status == RUNNING) & (it >= max_steps),
                             OVERFLOW, status).to(torch.int32)
        # the reference method's evaluations: stage 2 always, stages 3-4
        # where go2, 5-6 where go4, and the endpoint of an accepted attempt
        dfev = torch.where(running, 1 + 2 * go2.to(torch.int32)
                           + 2 * go4.to(torch.int32), 0) + accepted.to(
                               torch.int32)

        y = torch.where(upd, y_new, y)
        f = torch.where(upd, f_new, f)
        t = torch.where(upd, t_new, t)
        h_abs = torch.where(running, h_next, h_abs)
        tw0, tw1, q0, q1 = tw0n, tw1n, q0n, q1n
        fresh = accepted | (status != RUNNING)
        rejected = ~accepted & (rejected | running)
        nstep = nstep + upd.to(torch.int32)
        nfev = nfev + dfev.to(torch.int32)

    out = (y.T.contiguous(), status, nstep, nfev)
    return out if snaps is None else out + (snaps.rows(t, y),)


def fused_ckdisc_reference(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                           first_step=None, max_steps=100_000, max_step=None,
                           params=None, t_eval=None):
    """The plain PyTorch version of the fused CKdisc kernel, on the device
    of ``y0_batch`` ``(B, n)``.  ``fun`` is a :class:`FusedRHS` or a
    rows-first torch function, called as ``fun(t, y, p)`` where ``params``
    (B, k) is given (the float32 start too).  Returns ``(y (B, n), status
    (B,), nsteps (B,), nfev (B,))`` like :func:`solve_fused_ckdisc`, with
    ``t_eval`` ``y_eval`` after them."""
    y0 = torch.as_tensor(y0_batch).to(torch.float32)
    fun = bind_params(fun, member_params(params, y0, fun))
    return run_ck_loop(fun, ck_consts(), t_span, y0.T.contiguous(), rtol,
                       atol, first_step, max_steps, max_step, t_eval)


def _kernel(fun, snap=False):
    """The kernel built for one FusedRHS, with the t_eval snapshots where
    ``snap`` (a build of its own)."""
    from . import _build
    return _build.cached("fused_ckdisc", (fun,),
                         lambda: _build.load_fused_ckdisc(
                             ck_consts(), fun.n, fun.cuda_src, fun.k, snap),
                         extra=bool(snap))


# the lane counts B11 takes besides 1, most first, and the threads per SM
# up to which it takes them (two warps per SM sub-partition)
_LANES = (32, 16, 8)
_THREADS_PER_SM = 256


def _lanes_per_member(B, sm_count):
    """Lanes per member of B11 for an ensemble of ``B`` members on a card of
    ``sm_count`` SMs: the largest G of 32, 16 and 8 with B G <= 256
    sm_count, else 1 (one thread per member).

    From the member sweep of config 1c's line (the sign-switching decay,
    n = 2, rtol 1e-4 / atol 1e-7, t in [0, 5]; ``tools/probe_fused_small.py
    --family ck``, launch alone, ten launches back to back) on an H100 (132
    SMs, 700 W), us per launch of one thread per member (128 a block)
    against G = 2 / 4 / 8 / 16 / 32 (128 / G members a block): 256 members
    142.6 against 158.3 / 143.8 / 130.8 / 121.9 / **103.0**; 1,024: 146.7
    against 162.4 / 148.5 / 135.9 / 126.0 / **113.8**; 4,096: 151.0 against
    167.5 / 154.6 / **146.4** / 172.7 / 249.6; 16,384: 153.1 against 174.8
    / 192.9 / 311.8 / 519.4 / 834.1; 262,144: 662.0 against 1,176 to
    12,447.  Every lane runs the member, so a warp of 32 / G members splits
    on the cascade only between its groups: at one thread a member's warp
    took other cascade paths in 87% of its attempts and 12% of the
    lane-attempts waited for the warp's slowest member, at G = 32 none
    (the slowest member's attempt 3,765 -> 2,942 cycles).  Past two warps
    per SM sub-partition (B G > 256 sm_count) the lanes' issue slots cost
    more than the splits they save; G = 2 and 4 lose or tie everywhere and
    are built for comparisons only."""
    return lanes_within_budget(B, sm_count, _LANES, _THREADS_PER_SM)


def solve_fused_ckdisc(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                       first_step=None, max_steps=100_000, block_members=None,
                       t_eval=None, events=None, max_step=None, params=None):
    """Integrate an ensemble of small non-smooth systems with the CKdisc
    cascade in one kernel launch.

    ``y0_batch``: (B, n) float32.  Returns ``(y_final (B, n), status (B,),
    nsteps (B,), nfev (B,))`` with status 1 = finished, 2 = step size
    underflow, 3 = overflow or step cap (``max_steps`` counts attempts).

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``fun`` must be a :class:`FusedRHS`, and the call launches
    ``csrc/fused_ckdisc.cu`` (built at first use) or raises: G lanes of one
    warp per member, G from :func:`_lanes_per_member` (the ensemble size
    and the card's SM count; every lane runs the member, the lanes split
    the assessments' and the step control's divisions, with the bits of one
    thread per member), and ``block_members`` members per block (None:
    128 / G), so ``block_members * G`` threads per block, at most 1024; the
    shape taken is left in ``solve_fused_ckdisc.last_shape``.  On a CPU
    tensor it runs :func:`fused_ckdisc_reference`.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument (see :class:`~.fused_erk.FusedRHS`, whose
    ``k`` must agree).  ``t_eval``: times at which to return each member's
    state, ``y_eval`` (len(t_eval), B, n) after ``nfev``, as on
    :func:`~.fused_erk.solve_fused_erk`, over each accepted sub-step as a
    fallback shortened it.  ``events`` is not ported yet.
    """
    check_options("solve_fused_ckdisc", "B11", events=events)
    y0 = as_input(y0_batch, torch.float32)
    params = member_params(params, y0, fun)
    if y0.device.type != "cuda":
        return fused_ckdisc_reference(fun, t_span, y0, rtol=rtol, atol=atol,
                                      first_step=first_step,
                                      max_steps=max_steps, max_step=max_step,
                                      params=params, t_eval=t_eval)

    out, shape = _launch(fun, t_span, y0, rtol, atol, first_step, max_steps,
                         max_step, None, block_members, params, t_eval)
    solve_fused_ckdisc.last_shape = shape
    if y0.shape[0]:
        solve_fused_ckdisc.launches += 1
    return out


def _launch(fun, t_span, y0, rtol, atol, first_step, max_steps, max_step,
            lanes, block_members=None, params=None, t_eval=None):
    """B11 on the card for the CUDA tensor ``y0`` (and the members'
    ``params``): ``lanes`` lanes per member (None:
    :func:`_lanes_per_member`'s) and ``block_members`` members per block
    (None: 128 / lanes), with the rows of ``t_eval`` (the build with the
    snapshots) where given.  Returns the outputs (``y_eval`` after the
    four) and the ``(lanes, block_members)`` taken; an empty batch
    launches nothing."""
    if not isinstance(fun, FusedRHS):
        raise TypeError("solve_fused_ckdisc on a CUDA tensor needs a FusedRHS "
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
        lanes = _lanes_per_member(nb, device_sm_count(y0.device))
    block_members, _, _ = _launch_shape(nb, lanes, block_members)
    tq = eval_points(t_eval)

    built = _kernel(fun, tq is not None)
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    shape = (lanes, block_members)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = snap_outputs((y_out, status, nsteps, nfev), snap)
    if nb == 0:
        return out, shape
    t0, tf, rt, at, h0, use_h, mstep, msteps, _ = launch_args(
        t_span, rtol, atol, first_step, max_steps, False, max_step)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), None if params is None else params.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), nb, t0, tf, rt, at, h0, use_h, mstep,
                msteps, int(lanes), block_members)
        if snap is None:
            rc = built.lib.fused_ckdisc_launch(*args, stream)
        else:
            rc = built.lib.fused_ckdisc_snap_launch(*args, *snap.args(),
                                                    stream)
    if rc != 0:
        raise RuntimeError(f"fused_ckdisc kernel launch failed: CUDA error "
                           f"{rc}")
    return out, shape


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count) and the (lanes per member, members per block)
# of the last launch
solve_fused_ckdisc.launches = 0
solve_fused_ckdisc.last_shape = None
