"""Fused CKdisc solver for mid-size non-smooth systems: the whole adaptive
integration of an ensemble in one CUDA kernel launch, one thread block per
member of the size :func:`_launch_shape` gives.

Counterpart of ``extensisq_tpu/ops/fused_ckdisc_grid.py``, which runs the
CKdisc loop of ``fused_ckdisc`` with the state across the 128 lanes and
zero-pads n to a multiple of 128.  On Hopper a member is one thread block
of ``csrc/fused_rk_grid.cu``, the body shared with the mid-size ERK and RKN
kernels, its rows in shared memory; any n is taken without padding.  Every
thread holds the same block reductions, so the whole block takes the same
branch of the cascade, and a stage that E1 or E2 vetoes is skipped with its
barrier.  The plain version, :func:`fused_ckdisc_grid_reference`, runs
``ops.fused_ckdisc.run_ck_loop`` on the rows-first ``(n, B)`` state; the
wrapper :func:`solve_fused_ckdisc_grid` takes it only for tensors on the
CPU.

Right-hand sides are :class:`~.fused_rkc.FusedGridRHS` with
``shape=(n,)``: ``torch_fn(t, y)`` on ``(n, B)``, shifts as
``torch.roll(y, s, 0)`` with ``jnp.roll``'s sign, and the CUDA ``rhs(t,
y, i, p)`` of one element.  With ``params`` (B, k) the FusedGridRHS takes
``k`` parameters, as on B4: ``torch_fn(t, y, p)`` gets them as ``p`` of
shape ``(k, B)``, the CUDA ``rhs`` the member's k floats from its shared
memory.  ``t_eval`` returns each member's state at the given times, over
each accepted sub-step as on B11 (``csrc/snapshot.cuh``).
"""
import torch

from .._device import as_input
from .fused_ckdisc import ck_consts, run_ck_loop
from .fused_erk import check_options, eval_points, member_params
from .fused_erk_grid import (_state_size, bind_grid_params, check_grid_input,
                             grid_threads, launch_by_rule)
from .fused_rkc import FusedGridRHS


def fused_ckdisc_grid_reference(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                                first_step=None, max_steps=100_000,
                                max_step=None, params=None, t_eval=None):
    """The plain PyTorch version of the mid-size CKdisc kernel, on the
    device of ``y0_batch`` ``(B, n)``: the loop of ``fused_ckdisc``.
    ``fun`` is a :class:`FusedGridRHS` or a rows-first torch function,
    called as ``fun(t, y, p)`` with ``p`` ``(k, B)`` where ``params`` (B,
    k) is given.  Returns ``(y (B, n), status (B,), nsteps (B,), nfev
    (B,))``, with ``t_eval`` ``y_eval`` after them."""
    if isinstance(fun, FusedGridRHS):
        _state_size(fun)
    y0 = torch.as_tensor(y0_batch).to(torch.float32)
    fun = bind_grid_params(fun, member_params(params, y0, fun))
    return run_ck_loop(fun, ck_consts(), t_span, y0.T.contiguous(), rtol,
                       atol, first_step, max_steps, max_step, t_eval)


# B12's launch shapes (see :func:`_launch_shape`): blocks of
# ``grid_threads(n)`` threads up to HALF_FROM members an SM, of two
# elements a thread up to SMALL_FROM, beyond of SMALL_THREADS
HALF_FROM = 2
SMALL_FROM = 4
SMALL_THREADS = 64


def _launch_shape(B, n, sm_count):
    """B12's launch shape ``(threads, 0)`` for ``B`` members of ``n``
    states on a card of ``sm_count`` SMs: one block of ``grid_threads(n)``
    threads per member up to 2 members an SM, of two elements a thread up
    to 4, beyond one block of 64 threads; never the warp, which a CKdisc
    build does not have.  Blocks that share an SM contend at their
    barriers, the less so the smaller they are.

    From the sweeps of the non-smooth MoL (ckmol, CKdisc at rtol 1e-4;
    ``tools/probe_fused_rk_grid.py --family ck``) on an H100 (132 SMs,
    700 W), device ms, launch alone, blocks of 256 / 128 / 64 threads.  At
    n = 256: 64 members 0.981 / 1.026 / 1.248; 256 members 1.031 / 1.016 /
    1.259; 512 members 1.566 / 1.174 / 1.284; 1,024 members 2.791 / 1.874
    / 1.499.  At n = 512, 1,024 members: 7.099 / 5.276 / 4.734.  A warp
    body, measured while it was built for CKdisc, lost everywhere (at n =
    256, 1,024 members, 2.3-3.8 ms in two builds): an attempt spends most
    of its time in the RHS and the cascade's scalar control, which a warp
    runs on one of an SM's four schedulers."""
    B, n, sm_count = int(B), int(n), int(sm_count)
    if B <= HALF_FROM * sm_count:
        return grid_threads(n), 0
    if B <= SMALL_FROM * sm_count:
        return grid_threads(-(-n // 2)), 0
    return min(SMALL_THREADS, grid_threads(n)), 0


def _kernel(fun, snap=False):
    """The kernel built for one FusedGridRHS, with the t_eval snapshots
    where ``snap`` (a build of its own)."""
    from . import _build
    return _build.cached("fused_ckdisc_grid", (fun,),
                         lambda: _build.load_fused_rk_grid(
                             ck_consts(), False, fun.shape, fun.cuda_src,
                             fun.k, False, snap), extra=bool(snap))


def solve_fused_ckdisc_grid(fun, t_span, y0_batch, rtol=1e-4, atol=1e-6,
                            first_step=None, max_steps=100_000,
                            block_members=32, t_eval=None, events=None,
                            max_step=None, params=None):
    """Integrate an ensemble of mid-size non-smooth systems with the CKdisc
    cascade in one kernel launch.

    ``y0_batch``: (B, n) float32, any n.  Returns ``(y_final (B, n), status
    (B,), nsteps (B,), nfev (B,))``, status as :func:`solve_fused_ckdisc`.

    A ``y0_batch`` that is not a tensor goes to the card as float32 (and
    raises where there is none); a tensor keeps its device.  On a CUDA
    tensor ``fun`` must be a :class:`FusedGridRHS`, and the call launches
    ``csrc/fused_rk_grid.cu`` with one block per member of the size
    :func:`_launch_shape` gives from the ensemble size, n and the card's
    SM count (raising when the member's rows do not fit in shared memory),
    or raises; the shape taken is ``solve_fused_ckdisc_grid.last_shape``.  On
    a CPU tensor it runs :func:`fused_ckdisc_grid_reference`.
    ``block_members`` is accepted for the JAX signature and has no effect:
    a member is one block, its size from :func:`_launch_shape`.

    ``params``: (B, k) float32 per-member parameters; ``fun`` then takes
    them as its third argument (see the module docstring; a
    :class:`FusedGridRHS`'s ``k`` must agree).  ``t_eval``: times at which
    to return each member's state, ``y_eval`` (len(t_eval), B, n) after
    ``nfev``, as on :func:`~.fused_ckdisc.solve_fused_ckdisc` (every
    thread snapshots the elements it commits).  ``events`` is not ported
    yet.
    """
    check_options("solve_fused_ckdisc_grid", "B12", events=events)
    y0 = as_input(y0_batch, torch.float32)
    params = member_params(params, y0, fun)
    kw = dict(rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, max_step=max_step, params=params,
              t_eval=t_eval)
    if y0.device.type != "cuda":
        return fused_ckdisc_grid_reference(fun, t_span, y0, **kw)
    n = _state_size(fun) if isinstance(fun, FusedGridRHS) else -1
    check_grid_input("solve_fused_ckdisc_grid", y0, n, FusedGridRHS, fun,
                     params)
    out, shape = _launch(_kernel(fun, eval_points(t_eval) is not None),
                         t_span, y0, n, count=True, **kw)
    solve_fused_ckdisc_grid.last_shape = shape
    return out


def _launch(built, t_span, y0, n, shape=None, count=False, rtol=1e-4,
            atol=1e-6, first_step=None, max_steps=100_000, max_step=None,
            params=None, t_eval=None):
    """Launch B12 for the CUDA tensor ``y0`` (and the members' ``params``,
    as the build takes them, and the points of ``t_eval`` on a build with
    the snapshots) at ``shape`` (None: :func:`_launch_shape`'s; a given
    shape is taken as it is, for comparisons), counted where ``count``.
    Returns the outputs and the shape taken."""
    return launch_by_rule(solve_fused_ckdisc_grid, _launch_shape, built, y0,
                          n, t_span, shape, count, rtol=rtol, atol=atol,
                          first_step=first_step, max_steps=max_steps,
                          compensated=False, max_step=max_step,
                          params=params, t_eval=t_eval)


# kernel launches since the count was last set to 0 (the plain version on
# CPU tensors does not count), and the (threads, warp members) of the last
# launch through the wrapper
solve_fused_ckdisc_grid.launches = 0
solve_fused_ckdisc_grid.last_shape = None
