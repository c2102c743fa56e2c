"""Dense linear solves outside the Newton loop, and colored Jacobians,
batched over members.

Counterpart of ``extensisq_tpu/core/linalg.py``.  The ESDIRK stepper uses
``gauss_solve`` for the few solves it needs outside its LU-reuse
machinery (the DAE consistent-initial-condition projection, the initial
derivative under a nonsingular mass matrix) and for the diagonal blocks
of the banded cyclic reduction (``core/banded.py``).  With a
``jac_sparsity`` pattern its Jacobian is ``colored_jacfwd``: one JVP per
group of columns that share no row (Curtis-Powell-Reid), not one per
column.
"""
import numpy as np
import torch


def group_columns(sparsity):
    """Greedy CPR column grouping of a Jacobian sparsity pattern (host
    numpy, the JAX function's groups): columns that share no nonzero row
    land in one group, densest columns first.  Returns ``(groups,
    n_groups)`` with ``groups[j]`` the group of column j."""
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    S = np.asarray(sparsity) != 0
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError(f"sparsity must be square 2-D, got {S.shape}")
    n = S.shape[1]
    groups = np.full(n, -1, dtype=np.int32)
    n_groups = 0
    order = np.argsort(-S.sum(axis=0), kind="stable")
    for j in order:
        if groups[j] >= 0:
            continue
        groups[j] = n_groups
        covered = S[:, j].copy()
        for k in order:
            if groups[k] < 0 and not np.any(covered & S[:, k]):
                groups[k] = n_groups
                covered |= S[:, k]
        n_groups += 1
    return groups, n_groups


def seed_jvps(fun, t, y, seeds):
    """``(c, n, B)``: the JVP of the rows-first ``fun`` at ``(t, y)`` along
    each row of ``seeds`` ``(c, n)``, broadcast over the members (one
    ``torch.func.jvp`` a seed; a complex ``y`` gets complex seeds, the
    holomorphic JVP)."""
    out = []
    for v in seeds.to(y.dtype):
        tangent = v[:, None].expand_as(y).contiguous()
        out.append(torch.func.jvp(lambda yy: fun(t, yy), (y,),
                                  (tangent,))[1])
    return torch.stack(out)


def colored_jacfwd(fun, sparsity, n):
    """``jac(t, y)`` -> ``(B, n, n)``: the sparse Jacobian of the
    rows-first ``fun`` from one JVP per column group, scattered back
    through the pattern (zeros outside it are hard zeros), in the dtype
    of ``y``."""
    groups, n_groups = group_columns(sparsity)
    seeds = np.zeros((n_groups, n))
    seeds[groups, np.arange(n)] = 1.0
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    mask = np.asarray(sparsity) != 0
    cache = {}

    def jac(t, y):
        key = y.device
        if key not in cache:
            cache[key] = (torch.as_tensor(seeds, device=y.device),
                          torch.as_tensor(mask, device=y.device),
                          torch.as_tensor(groups, device=y.device).long())
        sd, mk, gr = cache[key]
        Jg = seed_jvps(fun, t, y, sd)            # (g, n, B): J @ seed_g
        # column j of J lives in Jg[groups[j]]: (n_j, n_i, B) -> (B, i, j)
        J = torch.index_select(Jg, 0, gr).permute(2, 1, 0)
        return torch.where(mk, J, torch.zeros((), dtype=J.dtype,
                                              device=J.device))

    return jac


def gauss_solve(A, b):
    """Solve ``A x = b`` per member by Gaussian elimination with partial
    pivoting (the first largest pivot wins, as in the JAX function).

    ``A`` is ``(B, n, n)``; ``b`` is ``(B, n)`` or ``(B, n, m)``.
    Returns ``x`` of the shape of ``b``.
    """
    vec = b.ndim == 2
    if vec:
        b = b[..., None]
    nb, n, _ = A.shape
    Ab = torch.cat([A, b.to(A.dtype)], dim=2)
    rows = torch.arange(n, device=A.device)
    members = torch.arange(nb, device=A.device)
    for k in range(n):
        col = torch.where(rows < k, -torch.inf, Ab[:, :, k].abs())
        p = torch.argmax(col, dim=1)
        rk = Ab[:, k].clone()
        Ab[:, k] = Ab[members, p]
        Ab[members, p] = rk
        factors = Ab[:, :, k] / Ab[:, k, k:k + 1]
        factors = torch.where(rows > k, factors, 0.0)
        Ab = Ab - factors[:, :, None] * Ab[:, k:k + 1, :]
    X = torch.zeros_like(Ab[:, :, n:])
    for k in range(n - 1, -1, -1):
        dot = (Ab[:, k, k + 1:n, None] * X[:, k + 1:]).sum(1)
        X[:, k] = (Ab[:, k, n:] - dot) / Ab[:, k, k:k + 1]
    return X[..., 0] if vec else X
