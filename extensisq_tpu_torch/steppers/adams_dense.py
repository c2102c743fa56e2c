"""SWAG dense output: Watts' dintp as polynomial coefficients, batched over
members.

Counterpart of ``extensisq_tpu/steppers/adams_dense.py``.  The reference
evaluates the C1 interpolant of Watts and Shampine point by point through
the g/w recurrences (SLATEC ``dintp``); those recurrences are polynomial
in the normalized time xi, so here they run once per step on coefficient
vectors, giving the segment form ``y(xi) = y_old + sum_k Q[:, k]
xi^(k+1)``.  Polynomials are ``(D, B)`` (degree first, members last), the
k-indexed rows ``(k_max + 1, D, B)``; each member's order ``kold`` masks
the rows it uses, as in the JAX version.  The extrapolated final step
(``kold == 0``) is the linear interpolant.
"""
import torch

from .adams import _take


def _shift_up(c):
    """The polynomial times xi: coefficients move up one degree (axis -2)."""
    return torch.cat([torch.zeros_like(c[..., :1, :]), c[..., :-1, :]],
                     dim=-2)


def _gdi(stepper, state, iqq):
    """The scalar gdi of dintp per member, ``(B,)``."""
    km = stepper.k_max
    kold, ow, alpha = state.kold, state.w, state.alpha
    if state.gi.shape[0]:
        direct = _take(state.gi, torch.clamp(kold - 1, 0,
                                             state.gi.shape[0] - 1))
    else:
        direct = torch.zeros_like(state.h_previous)
    use_iv = state.ivc != 0
    iw = _take(state.iv, torch.clamp(state.ivc - 1, 0,
                                     state.iv.shape[0] - 1))
    gdi = torch.where(use_iv, _take(ow, torch.clamp(iw - 1, 0, km - 1)),
                      iqq[torch.clamp(kold, 0, km).long()])
    m0 = torch.where(use_iv, kold - iw + 2, 1)
    for i in range(km):
        active = (i >= m0) & (i < kold)
        val = -alpha[min(i, km - 1)] * gdi \
            + _take(ow, torch.clamp(kold - i, 0, km - 1))
        gdi = torch.where(active, val, gdi)
    return torch.where(kold <= state.kgi, direct, gdi)


def dintp_coefficients(stepper, state):
    """``Q`` ``(n, k_max + 2, B)`` for the last accepted step of a SWAG
    solve."""
    km = stepper.k_max
    D = km + 3                       # coefficients of xi^0 .. xi^{D-1}
    kold = state.kold
    alpha = state.alpha
    B = kold.shape[0]
    dev = kold.device
    real = state.h_previous.dtype
    _, iqq, _, _ = stepper._consts(dev)

    gdi = _gdi(stepper, state, iqq)

    # gdif = diff(g[:kold+1], prepend=0), masked to rows <= kold
    midx = torch.arange(km + 1, device=dev)[:, None]
    used = midx <= kold
    og_m = torch.where(used, state.g, 0.0)
    gdif = og_m - torch.cat([torch.zeros_like(og_m[:1]), og_m[:-1]])
    gdif = torch.where(used, gdif, 0.0)

    # W[j] = xi^{j+2} iqq[j]; G[0] = xi, G[1] = xi^2 / 2
    W = torch.zeros((km + 1, D, B), dtype=real, device=dev)
    j = torch.arange(km + 1, device=dev)
    W[j, j + 2] = iqq[:km + 1, None].expand(km + 1, B)
    G = torch.zeros((km + 1, D, B), dtype=real, device=dev)
    G[0, 1] = 1.0
    G[1, 2] = 0.5
    zrow = torch.zeros((1, D, B), dtype=real, device=dev)
    for i in range(km):
        active = i < kold - 1
        alp = alpha[min(i + 1, km - 1)]
        lim = kold - i
        # gamma W - alp W_next, gamma = (1 - alp) + alp xi
        W_next = torch.cat([W[1:], zrow])
        W_new = (1.0 - alp) * W + alp * _shift_up(W) - alp * W_next
        W = torch.where((active & (midx < lim))[:, None, :], W_new, W)
        r = min(i + 2, km)
        G[r] = torch.where(active, W[0], G[r])

    # sigma = (W[1] - (xi - 1) W[0]) / gdi
    sigma = (W[1] - _shift_up(W[0]) + W[0]) / gdi

    # delta-g polynomials, masked to rows <= kold
    G_m = torch.where(used[:, None, :], G, 0.0)
    dG = G_m - torch.cat([zrow, G_m[:-1]])
    dG = torch.where(used[:, None, :], dG, 0.0)

    # yout = h phi[:kold+1]^T (dG - gdif sigma) + sigma (y - y_old) + y_old
    phi_m = torch.where(used[:, None, :], state.phi[:km + 1], 0.0)
    terms = dG - gdif[:, None, :] * sigma[None]
    Q_full = state.h_previous * torch.einsum("snb,sdb->ndb", phi_m,
                                             terms.to(phi_m.dtype))
    dy = state.y - state.y_old
    Q_full = Q_full + dy[:, None, :] * sigma[None]
    Q = Q_full[:, 1:]                # the constant term is zero

    Q_lin = torch.zeros_like(Q)
    Q_lin[:, 0] = dy
    return torch.where(state.extrapolated | (kold == 0), Q_lin, Q)
