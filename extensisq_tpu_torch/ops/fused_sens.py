"""Forward sensitivities and gradients through the fused kernels.

Counterpart of ``extensisq_tpu/ops/fused_sens.py``, the flat layout:

* :func:`solve_fused_sens` integrates the variational system ``[y; dy/dp_j
  (; dy/dy0_i)]`` of a whole parameter-sweep ensemble in one launch of B1
  (``csrc/fused_erk.cu``) or, for an ESDIRK method, of B2
  (``csrc/fused_esdirk.cu``) with its simultaneous corrector
  (``block_base=n``: one n x n factor solves every block of the augmented
  Newton system).  The tangent rows are forward-mode derivatives of the
  user's right-hand side, taken inside the kernel on dual numbers
  (``csrc/dual.cuh``) and in the plain versions by ``torch.func.jvp``, so
  the variational matrix is never formed.  Error control runs on the whole
  augmented state (internal differentiation, ``sens_forward``'s scheme).
* :func:`solve_fused_final` is ``y(t_f)`` as a differentiable function of
  ``(t_span, y0_batch, params)``, a ``torch.autograd.Function``: the
  forward pass is one fused solve, the backward pass one fused augmented
  solve contracted with the cotangent, so a gradient of a per-member loss
  over the whole ensemble costs two launches.

The user's right-hand side is a :class:`~extensisq_tpu_torch.ops.FusedRHS`
whose ``torch_fn(t, y, p)`` is rows-first (``p`` a k-tuple of ``(B,)``
tensors; ``torch_fn(t, y)`` without params) and whose ``cuda_src`` is the
template form ``template <class T> __device__ void rhs(T t, const T* y,
T* dy, const T* p)`` (without ``p`` when there are no params), which the
kernels evaluate on duals.  On CPU tensors a bare rows-first torch
function does as well.  The grid layout waits for ``params`` and
``block_base`` on B4 and B7 (ROADMAP A16).
"""
import functools

import numpy as np
import torch

from .._device import as_input
from .fused_erk import FusedRHS, bind_params, member_params, solve_fused_erk
from .fused_esdirk import solve_fused_esdirk


def _family(method):
    if method is None:
        return "erk"
    fam = getattr(method, "family", None)
    if fam not in ("erk", "esdirk"):
        raise ValueError(
            f"fused sensitivities support erk/esdirk methods, not family "
            f"{fam!r}; use sensitivity.sens_forward for the other families")
    return fam


def _aug_fun(fun, n, k, n_v):
    """The rows-first variational right-hand side: input rows ``[y (n);
    s_1..s_k (n each); v_1..v_{n_v} (n each)]``, output ``[f; J s_j +
    f_pj; J v_i]``, each tangent block one ``torch.func.jvp`` of ``fun``
    seeded with ``(s_j, e_j)`` or ``(v_i, 0)``."""
    def aug(t, Y, p=()):
        y = Y[:n]

        def prim(yy, *pp):
            return fun(t, yy, pp) if k else fun(t, yy)

        blocks = [prim(y, *p)]
        zeros = tuple(torch.zeros_like(pj) for pj in p)
        for j in range(k):
            seed = tuple(torch.ones_like(pi) if i == j else zeros[i]
                         for i, pi in enumerate(p))
            blocks.append(torch.func.jvp(
                prim, (y, *p), (Y[n * (1 + j):n * (2 + j)], *seed))[1])
        for i in range(n_v):
            v = Y[n * (1 + k + i):n * (2 + k + i)]
            blocks.append(torch.func.jvp(prim, (y, *p), (v, *zeros))[1])
        return torch.cat(blocks, 0)
    return aug


def aug_cuda_src(src, n, k, n_v):
    """CUDA source of the variational system for the user's template
    ``rhs<T>`` in ``src`` (n states, k parameters, n_v initial-condition
    blocks): the user's source in a namespace of its own, ``base_rhs<T>``
    (the user's rhs, the first block B2's simultaneous corrector
    differentiates) and the augmented ``rhs`` on floats, one dual
    evaluation of the user's rhs per tangent block with ``y`` seeded by
    the block and, for a parameter block j, ``p_j`` seeded by 1."""
    par = ", const T* p" if k else ""
    fpar = ", const float* p" if k else ""
    call_p = ", p" if k else ""
    dual_p = ""
    if k:
        dual_p = (f"    Dual pd[{k}];\n"
                  f"#pragma unroll\n"
                  f"    for (int i = 0; i < {k}; ++i) "
                  f"pd[i] = Dual(p[i], i == j ? 1.0f : 0.0f);\n")
    return f"""namespace user_rhs {{
{src}
}}  // namespace user_rhs

// the first block: the user's right-hand side
template <class T>
__device__ __forceinline__ void base_rhs(T t, const T* y, T* dy{par}) {{
  user_rhs::rhs(t, y, dy{call_p});
}}

// the variational system [f; J s_j + df/dp_j; J v_i] over {n} * {1 + k + n_v}
// rows
__device__ void rhs(float t, const float* Y, float* dY{fpar}) {{
  user_rhs::rhs(t, Y, dY{call_p});
#pragma unroll
  for (int j = 0; j < {k + n_v}; ++j) {{
    Dual yd[{n}], fd[{n}];
#pragma unroll
    for (int i = 0; i < {n}; ++i) yd[i] = Dual(Y[i], Y[{n} * (1 + j) + i]);
{dual_p}    user_rhs::rhs(Dual(t), yd, fd{", pd" if k else ""});
#pragma unroll
    for (int i = 0; i < {n}; ++i) dY[{n} * (1 + j) + i] = fd[i].d;
  }}
}}
"""


@functools.lru_cache(maxsize=None)
def _aug_rhs(fun, n, k, n_v):
    """The variational system of ``fun`` (a FusedRHS of k parameters or a
    torch function) as a FusedRHS (a torch function for a torch
    function), one object per (fun, k, n_v), so that the kernel is built
    once."""
    if not isinstance(fun, FusedRHS):
        return _aug_fun(fun, n, k, n_v)
    return FusedRHS(_aug_fun(fun.torch_fn, n, k, n_v),
                    aug_cuda_src(fun.cuda_src, n, k, n_v), n * (1 + k + n_v),
                    k)


def solve_fused_sens(fun, t_span, y0_batch, params=None, method=None,
                     sens_y0=False, rtol=1e-4, atol=1e-6, first_step=None,
                     max_steps=100_000, block_members=None,
                     compensated=False, max_step=None, layout=None):
    """Fused forward sensitivities of an ensemble of small systems.

    ``fun``: a FusedRHS (see the module docstring) or, on CPU tensors, a
    rows-first torch function ``fun(t, y, p)`` (``fun(t, y)`` when
    ``params`` is None).  ``params``: (B, k) per-member parameters; the
    sensitivities are taken with respect to each of the k.
    ``sens_y0=True`` also carries the n initial-condition blocks.  An
    ``method`` of the "esdirk" family runs B2 with ``block_base=n``, the
    "erk" family (default BS5) B1; others raise ``ValueError``.
    ``block_members`` None takes the wrapper's rule.

    ``layout``: "flat" (the default; rows-first ``fun``) or "grid", which
    raises ``ValueError`` with ``sens_y0`` (as in JAX) and else
    ``NotImplementedError`` (ROADMAP A16: params and block_base on B4 and
    B7 come first).

    Returns ``(y_final (B, n), S_p (B, n, k), S_y0 (B, n, n) | None,
    status (B,), nsteps (B,), nfev (B,))``: ``S_p[b, m, j] = d y_m(t_f) /
    d p_j`` and ``S_y0[b, m, i] = d y_m(t_f) / d y0_i`` of member b; nfev
    counts evaluations of the augmented system.
    """
    y0 = as_input(y0_batch, torch.float32)
    B, n = y0.shape
    if params is None and not sens_y0:
        raise ValueError("nothing to differentiate: give params and/or "
                         "sens_y0=True")
    params = member_params(params, y0, fun)
    k = 0 if params is None else params.shape[1]
    n_v = n if sens_y0 else 0
    fam = _family(method)
    if layout == "grid":
        if sens_y0:
            raise ValueError(
                "sens_y0 on the grid layout would carry n*n "
                "fundamental-solution lanes; use solve_fused_adjoint for "
                "dL/dy0 at mid-size n")
        raise NotImplementedError(
            "solve_fused_sens(layout='grid') is not ported yet: ROADMAP A16 "
            "(params and block_base on B4 and B7)")

    cols = [y0, y0.new_zeros(B, n * k)]
    if sens_y0:
        cols.append(torch.eye(n, dtype=torch.float32, device=y0.device)
                    .reshape(1, n * n).expand(B, n * n))
    Y0 = torch.cat(cols, 1).contiguous()
    aug = _aug_rhs(fun, n, k, n_v)
    kw = dict(method=method, rtol=rtol, atol=atol, first_step=first_step,
              max_steps=max_steps, block_members=block_members,
              compensated=compensated, max_step=max_step, params=params)
    if fam == "esdirk":
        y_aug, status, nsteps, nfev = solve_fused_esdirk(
            aug, t_span, Y0, block_base=n, **kw)
    else:
        y_aug, status, nsteps, nfev = solve_fused_erk(aug, t_span, Y0, **kw)
    y_f = y_aug[:, :n]
    S_p = y_aug[:, n:n * (1 + k)].reshape(B, k, n).transpose(1, 2)
    S_y0 = (y_aug[:, n * (1 + k):].reshape(B, n, n).transpose(1, 2)
            if sens_y0 else None)
    return y_f, S_p, S_y0, status, nsteps, nfev


def _rows_eval(fun, t, Y, params):
    """``fun`` at the scalar ``t`` on ``(B, n)`` states, as ``(B, n)``."""
    tt = torch.full((Y.shape[0],), float(t), dtype=Y.dtype, device=Y.device)
    return bind_params(fun, params)(tt, Y.T).T


class _FusedFinal(torch.autograd.Function):
    """Forward: one fused solve; backward: one fused augmented solve with
    ``sens_y0=True``, contracted with the cotangent."""

    @staticmethod
    def forward(ctx, cfg, t0, tf, y0, params):
        span = (float(t0), float(tf))
        solver = (solve_fused_esdirk if _family(cfg["method"]) == "esdirk"
                  else solve_fused_erk)
        y_f = solver(cfg["fun"], span, y0, method=cfg["method"],
                     params=params, **cfg["kw"])[0]
        ctx.cfg = cfg
        ctx.save_for_backward(t0, tf, y0, params, y_f)
        return y_f

    @staticmethod
    def backward(ctx, ct):
        t0, tf, y0, params, y_f = ctx.saved_tensors
        cfg = ctx.cfg
        fun = cfg["fun"]
        _, S_p, S_y0, _, _, _ = solve_fused_sens(
            fun, (float(t0), float(tf)), y0, params=params,
            method=cfg["method"], sens_y0=True, **cfg["kw"])
        ct = ct.to(torch.float32)
        y0_bar = torch.einsum("bm,bmi->bi", ct, S_y0)
        p_bar = (None if params is None
                 else torch.einsum("bm,bmj->bj", ct, S_p))
        # d y_f / d t_f = f(t_f, y_f); d y_f / d t_0 = -S_y0 f(t_0, y0)
        f_tf = _rows_eval(fun, tf, y_f, params)
        f_t0 = _rows_eval(fun, t0, y0, params)
        dtf = (ct * f_tf).sum()
        dt0 = -(ct * torch.einsum("bmi,bi->bm", S_y0, f_t0)).sum()
        return (None, dt0.reshape(t0.shape).to(t0.dtype),
                dtf.reshape(tf.shape).to(tf.dtype), y0_bar.to(y0.dtype),
                None if p_bar is None else p_bar.to(params.dtype))


def solve_fused_final(fun, t_span, y0_batch, params, method=None,
                      rtol=1e-4, atol=1e-6, max_steps=100_000,
                      block_members=None, compensated=False):
    """``y(t_f)`` of a fused ensemble, ``(B, n)``, differentiable with
    respect to ``t_span``'s tensor ends, ``y0_batch`` and ``params``
    through ``torch.autograd`` (``backward``, ``torch.autograd.grad``).

    The forward pass is one fused solve (B1, or B2 for an ESDIRK
    ``method``) with ``params`` (B, k) or None; the backward pass is one
    :func:`solve_fused_sens` with ``sens_y0=True``, contracted with the
    cotangent: two launches for a gradient of the whole ensemble, accurate
    to the solver's tolerance.  ``fun`` is as for
    :func:`solve_fused_sens`.
    """
    y0 = as_input(y0_batch, torch.float32)
    if params is not None and not isinstance(params, torch.Tensor):
        params = torch.as_tensor(np.asarray(params, np.float32),
                                 device=y0.device)
    t0, tf = (x if isinstance(x, torch.Tensor) else
              torch.tensor(float(x), dtype=torch.float32, device=y0.device)
              for x in t_span)
    cfg = dict(fun=fun, method=method,
               kw=dict(rtol=rtol, atol=atol, max_steps=max_steps,
                       block_members=block_members,
                       compensated=compensated))
    return _FusedFinal.apply(cfg, t0, tf, y0, params)


def solve_fused_adjoint(fun, t_span, y0_batch, params, method=None,
                        rtol=1e-4, atol=1e-6, max_steps=100_000,
                        block_members=None, dense=512, bw_method=None,
                        bw_rtol=None, bw_atol=None, layout="flat", k_max=12):
    """The continuous adjoint through a fused forward solve (JAX's
    signature); not ported yet: its backward pass interpolates the
    forward's recorded steps, which waits for ``dense=R`` on the fused
    kernels (ROADMAP queue B, option 4)."""
    raise NotImplementedError(
        "solve_fused_adjoint is not ported yet: it needs dense=R on the "
        "fused kernels (ROADMAP queue B, remaining option 4, dense)")
