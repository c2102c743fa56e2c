"""Dense linear solves outside the Newton loop, batched over members.

Counterpart of ``extensisq_tpu/core/linalg.py`` (``gauss_solve``).  The
ESDIRK stepper uses it for the few solves it needs outside its LU-reuse
machinery: the DAE consistent-initial-condition projection and the
initial derivative under a nonsingular mass matrix.  The colored
Jacobians of the JAX module (``group_columns``, ``colored_jacfwd``) come
with banded ESDIRK (ROADMAP A8b).
"""
import torch


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
