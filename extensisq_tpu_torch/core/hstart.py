"""Watts' starting-step-size estimator, batched over members.

Counterpart of ``extensisq_tpu/core/hstart.py`` (itself a rewrite of
extensisq's ``h_start``, a translation of SLATEC dstrt.f).  The
data-dependent branches become ``torch.where`` masks, one value per
member; the Lipschitz sampling loop has the static trip count
``min(n + 1, 3)``.  Costs ``1 + min(n + 1, 3)`` RHS evaluations, like
the JAX version.  Real states only.  The DAE short cuts ``J`` (a
Jacobian bound in place of the Lipschitz probes), ``T`` (a df/dt
estimate in place of the time probe) and ``returnT`` (return that
estimate) serve the ESDIRK stepper's consistent initial conditions.
"""
import torch

from .numerics import dtype_constants, norm


def _copysign_like(mag, sign_src):
    return torch.abs(mag) * torch.where(sign_src >= 0, 1.0, -1.0)


def h_start(df, a, b, y, yprime, morder, rtol, atol, J=None, T=None,
            returnT=False):
    """Estimate a starting step size per member (signed, direction of
    ``b - a``).

    ``df(t, y)`` is the rows-first RHS; ``a``, ``b`` are ``(B,)``
    tensors; ``y``, ``yprime`` are ``(n, B)``.  Returns ``(B,)``.
    ``T`` (``(n, B)``) replaces the time probe by ``yprime + da * T``;
    ``J`` (``(B, n, n)``) replaces the Lipschitz probes by its Frobenius
    norm; with ``returnT`` the function returns the df/dt estimate
    ``(n, B)`` instead of a step.
    """
    neq = y.shape[0]
    consts = dtype_constants(y.dtype)
    big = consts["big"]
    small = consts["uround"]
    relper = small ** 0.375

    etol = atol + rtol * torch.abs(y)

    dx = b - a
    absdx = torch.abs(dx)

    # bound on d f / d t
    da = torch.sign(dx) * torch.maximum(
        torch.minimum(relper * torch.abs(a), absdx),
        100.0 * small * torch.abs(a))
    da = torch.where(da == 0.0, relper * dx, da)
    if T is None:
        sf = df(a + da, y)                                   # evaluate
    else:
        sf = yprime + da * T
    yp = sf - yprime
    delf = norm(yp)
    dfdxb = torch.where(delf < big * torch.abs(da), delf / torch.abs(da),
                        big)
    fbnd = norm(sf)
    if returnT:
        return yp / da
    if J is None:
        dfdub, fbnd = _lipschitz(df, a, da, dx, y, yprime, sf, fbnd, big,
                                 relper)
    else:
        dfdub = torch.sqrt((J * J).sum((-2, -1)))

    # second-derivative bound and tolerance midpoint
    ydpb = dfdxb + dfdub * fbnd
    tolexp = torch.log10(etol) * torch.ones_like(y)
    tolsum = tolexp.sum(0)
    tolmin = torch.clamp(tolexp.amin(0), max=big)
    tolp = 10.0 ** (0.5 * (tolsum / neq + tolmin) / (morder + 1))

    h = absdx
    srydpb = torch.sqrt(0.5 * torch.clamp(ydpb, min=0.0))
    h = torch.where(
        (ydpb == 0.0) & (fbnd == 0.0),
        torch.where(tolp < 1.0, absdx * tolp, h),
        torch.where(ydpb == 0.0,
                    torch.where(tolp < fbnd * absdx, tolp / fbnd, h),
                    torch.where(tolp < srydpb * absdx, tolp / srydpb, h)))
    h = torch.where(dfdub != 0.0, torch.minimum(h, 1.0 / dfdub), h)
    h = torch.maximum(h, 100.0 * small * torch.abs(a))
    h = torch.where(h == 0.0, small * torch.abs(b), h)
    return h * torch.sign(dx)


def _lipschitz(df, a, da, dx, y, yprime, sf, fbnd, big, relper):
    """Local Lipschitz bound from ``min(n + 1, 3)`` probes; returns
    (dfdub, fbnd)."""
    neq = y.shape[0]
    dely = relper * norm(y)
    dely = torch.where(dely == 0.0, relper, dely)
    dely = dely * torch.sign(dx)
    delf = norm(yprime)
    fbnd = torch.maximum(fbnd, delf)
    have_slope = delf != 0.0
    spy = torch.where(have_slope, yprime, torch.zeros_like(yprime))
    yp = torch.where(have_slope, yprime, torch.ones_like(yprime))
    delf = torch.where(have_slope, delf, norm(torch.ones_like(yprime)))
    dfdub = torch.zeros_like(delf)
    done = torch.zeros_like(have_slope)
    lk = min(neq + 1, 3)
    for k in range(1, lk + 1):
        pv = y + dely / delf * yp
        if k == 2:
            yp = df(a + da, pv)                              # evaluate
            pv = yp - sf
        else:
            yp = df(a, pv)                                   # evaluate
            pv = yp - yprime
        fbnd = torch.where(done, fbnd, torch.maximum(fbnd, norm(yp)))
        delf = norm(pv)
        overflow = delf >= big * torch.abs(dely)
        dfdub = torch.where(
            done, dfdub,
            torch.where(overflow, big,
                        torch.maximum(dfdub, delf / torch.abs(dely))))
        done = done | overflow
        if k == lk:
            break
        # next perturbation vector, signs matched to local slopes
        delf = torch.where(delf == 0.0, 1.0, delf)
        if k == 2:
            dy = torch.where(y != 0, y, (dely / relper).expand_as(y))
        else:
            dy = torch.where(pv != 0, pv, delf.expand_as(pv))
        spy = torch.where(spy != 0, spy, yp)
        yp = torch.where(spy != 0, _copysign_like(dy, spy), dy)
        delf = norm(yp)
    return dfdub, fbnd
