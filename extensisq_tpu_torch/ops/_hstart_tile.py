"""Watts' starting-step estimator in float32, one value per member: the
plain PyTorch version of the h_start that the fused ERK kernel runs
inside its launch (``csrc/fused_erk.cu``, ``hstart``).

Counterpart of ``extensisq_tpu/ops/_hstart_tile.py``.  Costs
``1 + min(n + 1, 3)`` RHS evaluations, the stepper's own accounting, so
the fused nfev matches the f64 solver's from step zero.
"""
import numpy as np
import torch

from ..core.numerics import norm

_F32 = np.finfo(np.float32)
BIG = float(np.sqrt(_F32.max))
SMALL = float(np.nextafter(_F32.epsneg, 1.0))
RELPER = SMALL ** 0.375
# |a|-proportional floors guard the representability of t; the fused
# kernels carry t in double-single in compensated mode, so the basis is
# 2^-31 rather than the f32 eps
SMALL_T = float(2.0 ** -31)


def hstart_tile(df, a, b, y, f, morder, rtol, atol):
    """Per-member |h_start| (unsigned, ``(B,)``).

    ``df(t, y)`` is the rows-first RHS; ``a, b, rtol, atol`` are ``(B,)``
    float32 tensors; ``y, f`` are ``(n, B)``.
    """
    n = y.shape[0]
    etol = atol + rtol * torch.abs(y)

    dx = b - a
    absdx = torch.abs(dx)
    sdx = torch.where(dx >= 0.0, 1.0, -1.0)

    # bound on d f / d t
    da = sdx * torch.maximum(
        torch.minimum(RELPER * torch.abs(a), absdx),
        100.0 * SMALL_T * torch.abs(a))
    da = torch.where(da == 0.0, RELPER * dx, da)
    sf = df(a + da, y)                                     # evaluate
    yp = sf - f
    delf = norm(yp)
    dfdxb = torch.where(delf < BIG * torch.abs(da), delf / torch.abs(da),
                        BIG)
    fbnd = norm(sf)

    # local Lipschitz constant from min(n + 1, 3) probes
    dely = RELPER * norm(y)
    dely = torch.where(dely == 0.0, RELPER, dely)
    dely = dely * sdx
    delf = norm(f)
    fbnd = torch.maximum(fbnd, delf)

    have_slope = delf != 0.0
    spy = torch.where(have_slope, f, 0.0)
    yp = torch.where(have_slope, f, 1.0)
    delf = torch.where(have_slope, delf, norm(torch.ones_like(f)))

    dfdub = torch.zeros_like(delf)
    done = torch.zeros_like(have_slope)
    lk = min(n + 1, 3)
    for k in range(1, lk + 1):
        # a zero probe direction leaves pv = y (no 0/0)
        pv = y + (dely / torch.where(delf == 0.0, 1.0, delf)) * yp
        if k == 2:
            yp = df(a + da, pv)                            # evaluate
            pv = yp - sf
        else:
            yp = df(a, pv)                                 # evaluate
            pv = yp - f

        fbnd = torch.where(done, fbnd, torch.maximum(fbnd, norm(yp)))
        delf = norm(pv)
        overflow = delf >= BIG * torch.abs(dely)
        dfdub = torch.where(
            done, dfdub,
            torch.where(overflow, BIG,
                        torch.maximum(dfdub, delf / torch.abs(dely))))
        done = done | overflow
        if k == lk:
            break

        # next perturbation vector, signs matched to local slopes
        delf = torch.where(delf == 0.0, 1.0, delf)
        if k == 2:
            dy = torch.where(y != 0.0, y, dely / RELPER)
        else:
            dy = torch.where(pv != 0.0, pv, delf)
        spy = torch.where(spy != 0.0, spy, yp)
        sgn = torch.where(spy >= 0.0, 1.0, -1.0)
        yp = torch.where(spy != 0.0, torch.abs(dy) * sgn, dy)
        delf = norm(yp)

    # second-derivative bound and tolerance midpoint
    ydpb = dfdxb + dfdub * fbnd
    tolexp = torch.log10(etol)
    tolsum = tolexp.sum(0)
    tolmin = torch.clamp(tolexp.amin(0), max=BIG)
    tolp = torch.pow(10.0, 0.5 * (tolsum / n + tolmin) / (morder + 1))

    h = absdx
    srydpb = torch.sqrt(0.5 * torch.clamp(ydpb, min=0.0))
    h = torch.where(
        (ydpb == 0.0) & (fbnd == 0.0),
        torch.where(tolp < 1.0, absdx * tolp, h),
        torch.where(ydpb == 0.0,
                    torch.where(tolp < fbnd * absdx, tolp / fbnd, h),
                    torch.where(tolp < srydpb * absdx, tolp / srydpb, h)))
    h = torch.where(dfdub != 0.0, torch.minimum(h, 1.0 / dfdub), h)
    h = torch.maximum(h, 100.0 * SMALL_T * torch.abs(a))
    h = torch.where(h == 0.0, SMALL * torch.abs(b), h)
    return h
