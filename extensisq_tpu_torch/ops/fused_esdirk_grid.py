"""Fused implicit solver for mid-size systems: the whole adaptive ESDIRK
integration of an ensemble of stiff systems or index-1 DAEs with
tridiagonal Jacobians in one CUDA kernel launch, one thread block or one
warp per member (:func:`_launch_shape`).

Counterpart of ``extensisq_tpu/ops/fused_esdirk_grid.py``.  Per attempt,
as in the JAX kernel:

* the three bands of the Jacobian at ``(t, y)`` from four forward-mode
  JVPs with mod-4 striped tangents (element j seeded where ``j % 4 == c``:
  the neighbours i - 1, i, i + 1 of a row fall on distinct stripes), the
  exact JVP of ``jax.linearize`` (dual numbers in the kernel,
  ``torch.func.jvp`` here), not counted in ``nfev``;
* the Newton matrix ``W = M - h d J`` (algebraic rows of a diagonal ``M``
  take ``-J``, the ``1/(h d)`` rescale) as three bands, solved by parallel
  cyclic reduction: ``ceil(log2 n)`` rounds, each coupling equation i to
  i -/+ s and doubling s.  The rounds' multipliers depend on ``W`` alone,
  so both versions compute them once per attempt and replay them on every
  right-hand side (the Pallas body recomputes them in each solve; the
  arithmetic is the same);
* B2's modified Newton, error filter and implicit controller: the loop is
  ``ops/fused_esdirk.py:run_esdirk_loop`` with this linear algebra.

The plain version, :func:`fused_esdirk_grid_reference`, runs that loop on
rows-first ``(n, B)`` float32 tensors; the wrapper
:func:`solve_fused_esdirk_grid` takes it only for tensors on the CPU and
launches ``csrc/fused_esdirk_grid.cu`` on CUDA tensors.

Which Jacobians the reduction solves exactly: a strictly tridiagonal one
at any n (the zero corners keep every wrapped coupling zero), and one with
periodic corners where n is a power of two of at least 4 (the couplings
wrap onto each equation itself after the last round, and the stripes stay
distinct around the ring).  Elsewhere ``W`` is an approximation: the
Newton residuals stay exact, so converged results remain correct, and the
controller pays with smaller steps, as the JAX kernel's contract for wider
stencils says.  The JAX kernel pads other n to a power-of-two multiple of
128 with inert lanes and supports strictly tridiagonal Jacobians there;
the port takes n as it is.

Right-hand sides are :class:`~.fused_rkc.FusedGridRHS` with ``shape=(n,)``:
``torch_fn(t, y)`` on ``(n, B)``, shifts as ``torch.roll(y, s, 0)``, and a
CUDA source that defines the template ``template <class T> __device__ T
rhs(T t, const T* y, int i, const T* p)`` (run as ``rhs<Dual>`` for the
bands; without parameters ``p`` may be ``const float*``, a null pointer),
neighbours through ``tab::G::rolled``.  With ``params`` (B, k) the
FusedGridRHS takes ``k`` parameters, ``torch_fn(t, y, p)`` with ``p`` of
shape ``(k, B)``; the bands are d f / d y at fixed p.

``block_base`` is the simultaneous corrector of the sensitivities
(``ops/fused_sens.py``): the state is ``n / block_base`` blocks ``[y |
s_1 .. s_k]`` of ``block_base`` rows whose Jacobian is block lower
triangular with every diagonal block the base block's; the bands come
from the base block alone (the striped tangents on its columns, its rows
of the JVPs) and one reduction of ``ceil(log2 block_base)`` rounds is
replayed on every block, block-diag(W, ..., W).  The Newton residuals are
the whole system's, so converged results are exact; the neglected coupling
below the diagonal only slows the Newton rate (JAX's contract).

``dense=R`` records each member's accepted steps ``(t, y, y')``, y' the
stiffly accurate last stage, for a continuous dense output
(``ops/fused_dense.py``), and ``t_eval`` returns each member's state at
the given times (``csrc/snapshot.cuh``), as on B2.
"""
import numpy as np
import torch

from .._device import as_input
from .fused_erk import (DenseRecord, SnapPoints, Snapshots, _Record,
                        check_options, dense_rows, eval_points,
                        member_params, snap_outputs)
from .fused_erk_grid import (_state_size, bind_grid_params, check_grid_input,
                             check_shared_memory, fit_shape, grid_threads)
from .fused_esdirk import (_esdirk_consts, _f32, _start_step, _tiny_err,
                           run_esdirk_loop)
from .fused_rkc import FusedGridRHS


def pcr_rounds(n):
    """The rounds of cyclic reduction for n equations: ceil(log2 n)."""
    return (int(n) - 1).bit_length()


def pcr_factor(wl, wd, wu):
    """The cyclic reduction of the tridiagonal ``W`` with bands ``wl[i] =
    W[i, i-1 mod n]``, ``wd[i] = W[i, i]``, ``wu[i] = W[i, i+1 mod n]``
    (each (n, B)): each round's multipliers ``(alpha, gamma, s)`` and the
    final diagonal ``den``, with the JAX ``_pcr_solve``'s guards (a zero
    pivot or denominator reads 1)."""
    a, b, c = wl, wd, wu
    rounds = []
    s = 1
    for _ in range(pcr_rounds(wd.shape[0])):
        b_m = torch.roll(b, s, 0)
        b_p = torch.roll(b, -s, 0)
        b_m = torch.where(b_m == 0.0, 1.0, b_m)
        b_p = torch.where(b_p == 0.0, 1.0, b_p)
        alpha = -a / b_m
        gamma = -c / b_p
        a_new = alpha * torch.roll(a, s, 0)
        c_new = gamma * torch.roll(c, -s, 0)
        b = b + alpha * torch.roll(c, s, 0) + gamma * torch.roll(a, -s, 0)
        a, c = a_new, c_new
        rounds.append((alpha, gamma, s))
        s *= 2
    den = a + b + c
    return rounds, torch.where(den == 0.0, 1.0, den)


def pcr_solve(fact, d):
    """``W x = d`` for (n, B) rows ``d`` with a :func:`pcr_factor` factor
    of nb rows: where nb < n, block-diag(W, ..., W) x = d, each block of nb
    rows of ``d`` reduced on its own ring (the simultaneous corrector)."""
    rounds, den = fact
    n, nb = d.shape[0], den.shape[0]
    d = d.reshape(n // nb, nb, -1) if nb < n else d
    ax = d.dim() - den.dim()
    for alpha, gamma, s in rounds:
        d = d + alpha * torch.roll(d, s, ax) + gamma * torch.roll(d, -s, ax)
    return (d / den).reshape(n, -1)


def jac_bands(fun, t, y, nb=None):
    """(lower, diagonal, upper) bands of the Jacobian of the rows-first
    ``fun`` at ``(t, y)``, each (n, B), from four JVPs with mod-4 striped
    tangents, summed as the JAX ``jac_bands`` sums them.  With a base block
    of ``nb`` < n rows the tangents lie on its columns only and the bands
    are its nb rows."""
    n = y.shape[0]
    nb = n if nb is None else int(nb)
    lane = torch.arange(n, device=y.device)[:, None]

    def stripe(k, c):
        return ((lane + k) % 4 == c).to(y.dtype)

    base = (lane < nb).to(y.dtype) if nb < n else None
    nz = y * 0.0
    jv = [torch.func.jvp(lambda w: fun(t, w), (y,),
                         ((stripe(0, c) if base is None
                           else stripe(0, c) * base) + nz,))[1]
          for c in range(4)]
    return tuple(sum(stripe(k, c) * jv[c] for c in range(4))[:nb]
                 for k in (3, 0, 1))


def _base_block(block_base, M, n):
    """The base block's rows: n, or ``block_base`` (``ValueError`` with a
    mass matrix or where it does not divide n, as in JAX)."""
    if block_base is None:
        return n
    nb = int(block_base)
    if M is not None:
        raise ValueError(
            "block_base (simultaneous corrector) requires M=None: the tiled "
            "base bands assume identity mass on every block")
    if nb < 1 or n % nb:
        raise ValueError(
            f"block_base={nb} must divide the state width {n} into equal "
            "[y | s_j] blocks")
    return nb


def _mass_diag(M, n):
    """The float32 mass diagonal (n,) of ``M`` (None, a length-n vector or a
    diagonal matrix), or None."""
    if M is None:
        return None
    M = np.asarray(M, dtype=np.float64)
    if M.ndim == 2:
        if not np.array_equal(M, np.diag(np.diag(M))):
            raise ValueError("fused grid ESDIRK takes a diagonal mass matrix "
                             "only; a dense or hidden M is the small-system "
                             "kernel's (solve_fused_esdirk)")
        M = np.diag(M)
    if M.shape != (n,):
        raise ValueError("M must be (n,) or a diagonal (n, n)")
    return M.astype(np.float32)


def fused_esdirk_grid_reference(fun, t_span, y0_batch, method=None, M=None,
                                yp0_batch=None, rtol=1e-4, atol=1e-6,
                                first_step=None, max_steps=100_000,
                                compensated=False, max_step=None,
                                params=None, block_base=None, dense=None,
                                t_eval=None):
    """The plain PyTorch version of the mid-size ESDIRK kernel, on the
    device of ``y0_batch`` ``(B, n)``: B2's loop with the tridiagonal
    bands and cyclic reduction.  ``fun`` is a :class:`FusedGridRHS` or a
    rows-first torch function, called as ``fun(t, y, p)`` with ``p`` (k,
    B) where ``params`` (B, k) is given; ``block_base`` the simultaneous
    corrector's base block (see the module docstring).  Returns ``(y (B,
    n), status (B,), nsteps (B,), nfev (B,))``, with ``t_eval`` ``y_eval``
    after them and with ``dense=R`` the dense output last."""
    if isinstance(fun, FusedGridRHS):
        _state_size(fun)
    k = _esdirk_consts(method)
    f32 = torch.float32
    y0 = torch.as_tensor(y0_batch)
    nbase = _base_block(block_base, M, y0.shape[1])
    fun = bind_grid_params(fun, member_params(params, y0, fun))
    y = y0.to(f32).T.contiguous()
    n, nb = y.shape
    dev = y.device
    m_diag = _mass_diag(M, n)
    if m_diag is not None and yp0_batch is None and np.any(m_diag == 0.0):
        raise ValueError("DAE: pass consistent yp0_batch (e.g. from the "
                         "f64 stepper's init)")
    mass = torch.ones((n, 1), dtype=f32, device=dev)
    if m_diag is not None:
        mass = torch.tensor(m_diag, device=dev)[:, None]
    alg = mass == 0.0
    t0 = torch.full((nb,), _f32(t_span[0]), dtype=f32, device=dev)
    tf = torch.full((nb,), _f32(t_span[1]), dtype=f32, device=dev)
    if yp0_batch is not None:
        yp = torch.as_tensor(yp0_batch).to(device=dev, dtype=f32).T
    else:
        yp = fun(t0, y)
        if m_diag is not None:
            yp = yp / mass
    h_abs = _start_step(fun, k, t0, tf, y, yp, rtol, atol, first_step,
                        max_step, m_diag is None)

    def factor(tc, yy, hd):
        jl, jd, ju = jac_bands(fun, tc, yy, nbase)
        a, m = alg[:nbase], mass[:nbase]
        return pcr_factor(torch.where(a, -jl, -hd * jl),
                          torch.where(a, -jd, m - hd * jd),
                          torch.where(a, -ju, -hd * ju))

    rows = dense_rows(dense)
    rec = _Record(y, yp, rows) if rows else None
    tq = eval_points(t_eval)
    snaps = None if tq is None else Snapshots(tq, y, torch.sign(tf - t0))
    y, status, nstep, nfev, *y_eval = run_esdirk_loop(
        fun, k, t0, tf, y, yp, h_abs, 0 if yp0_batch is not None else 1,
        rtol, atol, max_steps, compensated, max_step, mass, alg, factor,
        pcr_solve, record=rec, snaps=snaps)
    out = (y.T.contiguous(), status, nstep, nfev, *y_eval)
    if rec is None:
        return out
    return out + (rec.solution(t_span, nstep),)


# the shapes of :func:`_launch_shape` for large ensembles: the members an SM
# above which it leaves one block of one element a thread (an SM issues
# from four warp schedulers, so a warp per member fills it from four members
# on), the members a block of the warp body, and the largest n the warp is
# taken at (beyond it the swept sizes ran faster on blocks)
WARP_FROM = 4
WARP_MEMBERS = 4
WARP_MAX_N = 128


def _launch_shape(B, n, sm_count):
    """The launch shape for ``B`` members of ``n`` states on a card of
    ``sm_count`` SMs: one block of ``grid_threads(n)`` threads per member,
    ``(threads, 0)``, where the ensemble gives every SM at most
    ``WARP_FROM`` (4) members; beyond, one warp per member, ``(32,
    WARP_MEMBERS)`` (four members a block), where n is at most
    ``WARP_MAX_N``, else one block of two elements a thread,
    ``grid_threads(ceil(n / 2))``.

    A warp runs its member on one of an SM's four schedulers, with no
    barrier; a block spreads it over all four and waits at its barriers,
    which contend once several blocks share an SM.  From the sweeps of
    config 4d's line (Kv3I; ``tools/probe_fused_esdirk_grid.py``) on an
    H100 (132 SMs, 700 W), device ms.  At n = 128, one block of 32 / 64 /
    128 threads per member against one warp per member at 1 / 2 / 4
    members a block: 32 members 2.650 / 1.735 / 1.474 against 1.652 /
    1.652 / 1.684; 256 members 2.899 / 1.985 / 1.505 against 1.852 / 1.832
    / 1.826; 512 members 2.930 / 1.954 / 1.772 against 1.892 / 1.885 /
    1.903; 1,024 members 3.145 / 2.489 / 2.629 against 2.302 / 2.312 /
    2.303.  At 1,024 members, blocks of 128 / 256 threads against the warp
    at 1 / 2 / 4 a block: n = 256 14.209 / 16.037 against 22.367 / 22.634
    / 22.838; n = 512 100.884 / 84.957 against 224.267 / 224.960 (four
    do not fit; the warp spills, 8 and 16 elements a lane)."""
    B, n, sm_count = int(B), int(n), int(sm_count)
    if B <= WARP_FROM * sm_count:
        return grid_threads(n), 0
    if n <= WARP_MAX_N:
        return 32, WARP_MEMBERS
    return grid_threads(-(-n // 2)), 0


def _kernel(method, fun, nb=None, record=False, snap=False):
    """The kernel built for one method, FusedGridRHS (with its parameter
    count) and base block (None: no simultaneous corrector), with the
    dense record where ``record`` and the t_eval snapshots where ``snap``
    (each switch a build of its own)."""
    if method is None:
        from ..methods import Kv3I as method
    from . import _build
    return _build.cached("fused_esdirk_grid", (method, fun),
                         lambda: _build.load_fused_esdirk_grid(
                             _esdirk_consts(method), fun.shape, fun.cuda_src,
                             fun.k, nb, record, snap),
                         extra=(nb, bool(record), bool(snap)))


def solve_fused_esdirk_grid(fun, t_span, y0_batch, method=None, M=None,
                            yp0_batch=None, rtol=1e-4, atol=1e-6,
                            first_step=None, max_steps=100_000,
                            block_members=8, compensated=False, t_eval=None,
                            events=None, max_step=None, params=None,
                            dense=None, block_base=None):
    """Integrate an ensemble of mid-size stiff systems or index-1 DAEs with
    tridiagonal Jacobians (optionally with periodic corners) in one kernel
    launch.

    ``y0_batch``: (B, n) float32, any n that fits a block's shared memory
    (see the module docstring for the Jacobians solved exactly).
    ``method``: an ESDIRK method (Kv3I by default).  ``M``: None, or a
    length-n diagonal (zeros mark algebraic rows; pass consistent
    ``yp0_batch`` for DAEs).  For ODEs ``yp0_batch`` defaults to ``M^-1
    f(t0, y0)``.  Without ``first_step`` a plain ODE starts from Watts'
    estimate and a DAE from 1% of the span.  Returns ``(y_final (B, n),
    status (B,), nsteps (B,), nfev (B,))`` with status 1 = finished, 2 =
    step size underflow, 3 = step cap (``max_steps`` counts loop
    iterations, accepted plus rejected).  ``compensated=True`` adds the
    double-single carry of y and Neumaier stage sums.  ``block_members``
    is accepted for the JAX signature and has no effect: the launch shape
    is :func:`_launch_shape`'s.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``fun`` must be a :class:`FusedGridRHS` whose CUDA source
    defines the template ``rhs<T>``, and the call launches
    ``csrc/fused_esdirk_grid.cu`` (built at first use) with one block or
    one warp per member, as :func:`_launch_shape` says from the ensemble
    size, n and the card's SM count (raising when the members' rows do not
    fit in shared memory), or raises; the shape taken is
    ``solve_fused_esdirk_grid.last_shape``.  On a CPU tensor it runs
    :func:`fused_esdirk_grid_reference`.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument (see the module docstring; a
    :class:`FusedGridRHS`'s ``k`` must agree).  ``block_base``: the
    simultaneous corrector of the sensitivities (module docstring); it
    must divide n and takes no ``M`` (``ValueError``, as in JAX), and its
    FusedGridRHS must also define ``base_rhs``, the base block's template
    (``ops/fused_sens.py`` builds it).  ``dense=R`` adds the dense output
    last and ``t_eval`` the rows ``y_eval`` (len(t_eval), B, n) after the
    four, as on :func:`~.fused_esdirk.solve_fused_esdirk` (every thread
    records and snapshots the elements it commits).  ``events`` is not
    ported yet.
    """
    check_options("solve_fused_esdirk_grid", "B7", events=events)
    nbase = _base_block(block_base, M, np.shape(y0_batch)[1])
    y0 = as_input(y0_batch, torch.float32)
    params = member_params(params, y0, fun)
    kw = dict(method=method, M=M, yp0_batch=yp0_batch, rtol=rtol, atol=atol,
              first_step=first_step, max_steps=max_steps,
              compensated=compensated, max_step=max_step, params=params,
              dense=dense, t_eval=t_eval)
    if y0.device.type != "cuda":
        return fused_esdirk_grid_reference(fun, t_span, y0,
                                           block_base=block_base, **kw)
    n = _state_size(fun) if isinstance(fun, FusedGridRHS) else -1
    check_grid_input("solve_fused_esdirk_grid", y0, n, FusedGridRHS, fun,
                     params)
    nb = None if nbase == n else nbase
    out, shape = _launch(_kernel(method, fun, nb, dense_rows(dense) > 0,
                                 eval_points(t_eval) is not None),
                         t_span, y0, count=True, **kw)
    solve_fused_esdirk_grid.last_shape = shape
    return out


def _launch(built, t_span, y0, method=None, M=None, yp0_batch=None,
            rtol=1e-4, atol=1e-6, first_step=None, max_steps=100_000,
            compensated=False, max_step=None, shape=None, count=False,
            params=None, dense=None, t_eval=None):
    """Launch ``csrc/fused_esdirk_grid.cu`` on the current stream (with the
    members' ``params`` as the build takes them, ``dense`` rows of record
    a member and the points of ``t_eval`` on a build with each) at
    ``shape`` (None:
    :func:`_launch_shape`'s on the whole state, its P capped by the card's
    shared memory; a given shape is taken as it is, for comparisons),
    counted where ``count``; raise before launch when the members' rows do
    not fit in the card's shared memory.  Returns the outputs (``y_eval``
    with ``t_eval`` and the :class:`~.fused_dense.FusedDenseSolution` with
    ``dense`` after the four) and the shape taken."""
    nb, n = y0.shape
    m_diag = _mass_diag(M, n)
    if m_diag is not None and yp0_batch is None and np.any(m_diag == 0.0):
        raise ValueError("DAE: pass consistent yp0_batch (e.g. from the "
                         "f64 stepper's init)")
    yp0 = None
    if yp0_batch is not None:
        yp0 = torch.as_tensor(yp0_batch, device=y0.device)
        if yp0.shape != y0.shape or yp0.dtype != torch.float32:
            raise ValueError("yp0_batch must be float32 of the shape of "
                             "y0_batch")
        yp0 = yp0.contiguous()
    mass = (None if m_diag is None
            else torch.tensor(m_diag, device=y0.device))
    y_out = torch.empty_like(y0)
    status = torch.empty(nb, dtype=torch.int32, device=y0.device)
    nsteps = torch.empty_like(status)
    nfev = torch.empty_like(status)
    rec = DenseRecord(y0, dense_rows(dense))
    tq = eval_points(t_eval)
    snap = None if tq is None else SnapPoints(tq, t_span, y0)
    out = snap_outputs((y_out, status, nsteps, nfev), snap)
    name = "solve_fused_esdirk_grid"
    with torch.cuda.device(y0.device):
        smem = built.lib.fused_esdirk_grid_smem
        if shape is None:
            shape = fit_shape(name, smem, _launch_shape(
                nb, n, torch.cuda.get_device_properties(
                    y0.device).multi_processor_count))
        check_shared_memory(name, smem, "take a smaller system",
                            max(1, shape[1]))
        if nb == 0:
            return rec.outputs(out, t_span, y0), shape
        t0, tf = np.float32(t_span[0]), np.float32(t_span[1])
        h0 = (np.float32(first_step) if first_step is not None
              else np.float32(0.01) * abs(tf - t0))
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        args = (y0.data_ptr(), None if yp0 is None else yp0.data_ptr(),
                None if mass is None else mass.data_ptr(),
                None if params is None else params.data_ptr(),
                y_out.data_ptr(), status.data_ptr(), nsteps.data_ptr(),
                nfev.data_ptr(), nb, float(t0), float(tf), float(rtol),
                float(atol), float(h0),
                int(first_step is None and M is None), int(yp0 is not None),
                np.inf if max_step is None else float(max_step),
                int(max_steps), _tiny_err(n, rtol), int(bool(compensated)),
                shape[0], shape[1])
        if snap is not None:
            rc = built.lib.fused_esdirk_grid_snap_launch(
                *args, *rec.args(), *snap.args(), stream)
        elif rec.rows:
            rc = built.lib.fused_esdirk_grid_record_launch(
                *args, *rec.args(), stream)
        else:
            rc = built.lib.fused_esdirk_grid_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_esdirk_grid kernel launch failed: CUDA error {rc}")
    solve_fused_esdirk_grid.launches += int(count)
    return rec.outputs(out, t_span, y0), shape


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count), and the (threads, warp members) of the last
# launch
solve_fused_esdirk_grid.launches = 0
solve_fused_esdirk_grid.last_shape = None
