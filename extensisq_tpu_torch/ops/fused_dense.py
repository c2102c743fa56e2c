"""Continuous dense output from the fused kernels.

Counterpart of ``extensisq_tpu/ops/fused_dense.py``.  With ``dense=R`` the
fused kernels B1-B8 (``ops/fused_erk.py`` and the other ``ops/fused_*``
wrappers) record the end ``(t, y, f)`` of each accepted step of a member,
and ``f0 = f(t0, y0)`` (``csrc/dense_record.cuh``).  JAX's kernels write
one row per iteration of a tile's lockstep loop, a sentinel time marking
the members that did not accept, and :func:`build_fused_dense` compacts
them member by member.  A member attempts once in every iteration while
it runs, so that iteration is its own attempt count: the port's kernels
and plain versions write an accepted step at the row of the member's
count of accepted steps before it while its attempt count is below R, so
the rows arrive compacted, with the count of rows written
(:func:`record_solution` flags them for :func:`build_fused_dense`).  The
SWAG kernels (B3, B8) also record their near-end extrapolation, as a node
at ``tf`` with the ``f`` of the step before it, and take ``f0`` from the
starting state of the float32 stepper's init, as JAX's do.  A member
whose loop needed more than R attempts for its accepted steps gets
``valid[b] = False``; its recorded prefix is still exact.  Size R at ~1.3x
the expected attempts.

The segments are cubic Hermite in the unified anchor form of
``core.interpolate.OdeSolution``; past the last node the inert tail (the
last node repeated, ``Q = 0``, ``h = 1``) returns the final state.
Everything is tensor code with no host synchronisation, on the device of
the record.
"""
from typing import Any, NamedTuple

import torch

from ..core.interpolate import (OdeSolution, hermite_cubic_coefficients,
                                horner)


class FusedDenseSolution(NamedTuple):
    """Per-member evaluable dense output from a fused solve.

    Fields carry a leading member axis ``B``.  ``member(b)`` returns that
    member's :class:`~extensisq_tpu_torch.core.interpolate.OdeSolution`;
    calling the object evaluates all members at once: ``sol(t)`` ->
    ``(B, n)`` for a scalar ``t``, ``(B, n, m)`` for ``m`` times.
    ``valid[b]`` is False where member b overflowed the recording capacity
    (see the module docstring).
    """
    ts: Any          # (B, R+1)
    t_anchor: Any    # (B, R)
    h: Any           # (B, R) signed; 1.0 on inert tail segments
    y_anchor: Any    # (B, R, n)
    Q: Any           # (B, R, n, 3)
    valid: Any       # (B,) bool

    def member(self, b):
        return OdeSolution(ts=self.ts[b], t_anchor=self.t_anchor[b],
                           h=self.h[b], y_anchor=self.y_anchor[b],
                           Q=self.Q[b])

    def __call__(self, t):
        ts = self.ts
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        tq = t.reshape(1, -1).expand(ts.shape[0], -1)
        # each member's direction from its own nodes, as JAX's OdeSolution
        sgn = torch.where(ts[:, -1] >= ts[:, 0], 1.0, -1.0).to(ts.dtype)
        y = _evaluate(self, tq, sgn[:, None])
        return y[:, 0] if t.ndim == 0 else y.transpose(1, 2)


def _evaluate(sol, tq, sgn):
    """``sol``'s members at their times ``tq`` ``(B, m)``: ``(B, m, n)``.
    ``sgn`` is the direction of the integration (+1 or -1), a number or a
    ``(B, 1)`` tensor.  No host synchronisation."""
    B, R = sol.h.shape
    n = sol.y_anchor.shape[-1]
    p = sol.Q.shape[-1]
    m = tq.shape[1]
    grid = (sgn * sol.ts[:, 1:-1]).contiguous()
    idx = torch.searchsorted(grid, (sgn * tq).contiguous(), side="left")
    idx = idx.clamp(0, R - 1)
    u = (tq - sol.t_anchor.gather(1, idx)) / sol.h.gather(1, idx)
    y_a = sol.y_anchor.gather(1, idx[..., None].expand(B, m, n))
    Q = sol.Q.gather(1, idx[..., None, None].expand(B, m, n, p))
    return horner(u[..., None], Q, y_a, axis=-1)


def evaluate_members(sol, t, direction):
    """Every member of ``sol`` at its own time ``t`` ``(B,)``: ``(B, n)``,
    for the adjoint's right-hand side.  ``direction`` (+1 or -1) is that of
    the forward solve, from its ``t_span`` on the host, so nothing waits
    for the device."""
    tq = t.to(sol.ts.dtype)[:, None]
    return _evaluate(sol, tq, float(direction))[:, 0]


def build_fused_dense(t0, tf, y0_b, f0_b, rec_t, rec_flag, rec_y, rec_f,
                      nsteps):
    """Compact recording rows into a :class:`FusedDenseSolution` (JAX's
    signature and result).

    ``rec_t`` (R, B), ``rec_flag`` (R, B) (nonzero: an accepted step's
    row), ``rec_y`` / ``rec_f`` (R, B, n); ``y0_b`` / ``f0_b`` (B, n);
    ``nsteps`` (B,) the kernel's accepted-step counts.  Each member's
    flagged rows become its nodes 1, 2, ... after ``(t0, y0, f0)``; the
    tail repeats the last node.  ``tf`` is unused, as in JAX.
    """
    rec_t = torch.as_tensor(rec_t)
    dev = rec_t.device
    f32 = torch.float32
    R, B = rec_t.shape

    def arr(x):
        return torch.as_tensor(x, device=dev).to(f32)

    y0_b, f0_b = arr(y0_b), arr(f0_b)
    n = y0_b.shape[1]
    flag = torch.as_tensor(rec_flag, device=dev) != 0
    pos = torch.cumsum(flag.to(torch.int64), 0)          # 1-indexed node
    nacc = pos[-1]
    # each flagged row to its node; the others to a spare slot, dropped
    idx = torch.where(flag, pos, R + 1).T                 # (B, R)
    tN = torch.zeros(B, R + 2, dtype=f32, device=dev)
    tN[:, 0] = float(t0)
    tN = tN.scatter(1, idx, arr(rec_t).T)[:, :R + 1]
    nodes = []
    for first, rows in ((y0_b, rec_y), (f0_b, rec_f)):
        buf = torch.zeros(B, R + 2, n, dtype=f32, device=dev)
        buf[:, 0] = first
        buf = buf.scatter(1, idx[..., None].expand(B, R, n),
                          arr(rows).transpose(0, 1))
        nodes.append(buf[:, :R + 1])
    yN, fN = nodes
    # the inert tail: the last real node repeated, so that evaluation past
    # the trajectory returns the final state
    live = torch.arange(R + 1, device=dev) <= nacc[:, None]
    last = nacc[:, None]
    tN = torch.where(live, tN, tN.gather(1, last))
    yN, fN = (torch.where(live[..., None], x,
                          x.gather(1, last[..., None].expand(B, 1, n)))
              for x in (yN, fN))
    h = tN[:, 1:] - tN[:, :-1]
    h_safe = torch.where(h == 0.0, torch.ones_like(h), h)
    # (B, 3, R, n) from the anchor-form coefficients -> (B, R, n, 3)
    Q = hermite_cubic_coefficients(h_safe[..., None], yN[:, :-1], yN[:, 1:],
                                   fN[:, :-1], fN[:, 1:]).permute(0, 2, 3, 1)
    # zero-length tail segments carry exactly no change
    Q = torch.where((h == 0.0)[..., None, None], torch.zeros_like(Q), Q)
    valid = nacc == torch.as_tensor(nsteps, device=dev).to(nacc.dtype)
    return FusedDenseSolution(ts=tN, t_anchor=tN[:, :-1], h=h_safe,
                              y_anchor=yN[:, :-1], Q=Q, valid=valid)


def record_solution(t_span, y0, f0, rec_t, rec_y, rec_f, nrec, nsteps):
    """The :class:`FusedDenseSolution` of a port kernel's record (or its
    plain version's): ``f0`` (B, n), the compacted rows ``rec_t`` (B, R),
    ``rec_y`` / ``rec_f`` (B, R, n) and the rows written ``nrec`` (B,),
    flagged for :func:`build_fused_dense` (rows past ``nrec`` are never
    read, so they may hold anything)."""
    R = rec_t.shape[1]
    flag = torch.arange(R, device=rec_t.device)[:, None] < nrec[None, :]
    return build_fused_dense(float(t_span[0]), float(t_span[1]), y0, f0,
                             rec_t.T, flag, rec_y.transpose(0, 1),
                             rec_f.transpose(0, 1), nsteps)
