"""Banded linear algebra by block-tridiagonal cyclic reduction, batched
over members.

Counterpart of ``extensisq_tpu/core/banded.py``.  A matrix with
bandwidths ``(kl, ku)`` is block tridiagonal with blocks of size
``b = max(kl, ku)``; block cyclic reduction factors and solves it in
``log2(n / b)`` sequential levels of batched ``b x b`` products, in the
state's dtype (float64 or complex128).  The ESDIRK stepper's banded mode
(``bands=``) factors its Newton matrices this way.

Storage, with the member axis first:

* banded ``AB`` ``(B, kl+ku+1, n)``, LAPACK-style:
  ``AB[:, ku + i - j, j] = A[:, i, j]`` for ``-kl <= i - j <= ku``;
* blocks ``(B, m, b, b)``: ``D`` (diagonal), ``L`` (coupling of block i
  to block i-1), ``U`` (to block i+1), with ``m`` a power of two
  (identity-padded past ``n``).

Pivoting happens within the ``b x b`` diagonal blocks (``gauss_solve``,
whose rule is the JAX function's), none across blocks.  The storage
helpers also take a single matrix without the member axis.
"""
import functools

import numpy as np
import torch

from .linalg import gauss_solve, seed_jvps


def bands_of_sparsity(sparsity):
    """Host-side ``(kl, ku)`` of a 0/1 sparsity pattern."""
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    S = np.asarray(sparsity) != 0
    i, j = np.nonzero(S)
    if i.size == 0:
        return 0, 0
    return int(np.maximum(i - j, 0).max()), int(np.maximum(j - i, 0).max())


def rcm_order(sparsity):
    """Host-side reverse Cuthill-McKee ordering of a 0/1 sparsity pattern
    (symmetrized): ``perm`` with ``y_perm = y[perm]``.  BFS from a
    minimum-degree vertex of each connected component, neighbours in
    increasing degree (ties: index), the order reversed."""
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    S = np.asarray(sparsity) != 0
    n = S.shape[0]
    S = S | S.T
    np.fill_diagonal(S, False)
    adj = [np.nonzero(S[i])[0] for i in range(n)]
    deg = np.array([a.size for a in adj])
    adj = [a[np.lexsort((a, deg[a]))] for a in adj]
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    k = 0
    while k < n:
        rest = np.nonzero(~visited)[0]
        start = rest[np.argmin(deg[rest])]
        visited[start] = True
        order[k] = start
        head = k
        k += 1
        while head < k:
            for v in adj[order[head]]:
                if not visited[v]:
                    visited[v] = True
                    order[k] = v
                    k += 1
            head += 1
    return order[::-1].copy()


def _index(a, like):
    return torch.as_tensor(a, device=like.device)


def take(x, dim, index):
    """``x`` indexed along ``dim`` by an integer array of any shape, by
    ``index_select`` (the host's advanced indexing is ~100x slower)."""
    index = _index(index, x)
    out = torch.index_select(x, dim, index.reshape(-1))
    dim = dim % x.ndim
    return out.reshape(x.shape[:dim] + index.shape + x.shape[dim + 1:])


def _gather2(x, rows, cols, width):
    """``x[..., rows, cols]`` through one flat index; ``width`` is
    ``x.shape[-1]``."""
    return take(x.reshape(x.shape[:-2] + (-1,)), -1, rows * width + cols)


def banded_from_dense(A, kl, ku):
    """Pack dense ``(..., n, n)`` into banded ``(..., kl+ku+1, n)``."""
    n = A.shape[-1]
    d = np.arange(kl + ku + 1)[:, None]          # band row
    j = np.arange(n)[None, :]                    # column
    i = j + d - ku                               # matrix row
    valid = (i >= 0) & (i < n)
    return torch.where(_index(valid, A),
                       _gather2(A, np.clip(i, 0, n - 1), j, n),
                       torch.zeros((), dtype=A.dtype, device=A.device))


def dense_from_banded(AB, kl, ku, n):
    """Unpack banded ``(..., kl+ku+1, n)`` to dense ``(..., n, n)``."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    d = ku + i - j
    valid = (d >= 0) & (d <= kl + ku)
    return torch.where(_index(valid, AB),
                       _gather2(AB, np.clip(d, 0, kl + ku), j, n),
                       torch.zeros((), dtype=AB.dtype, device=AB.device))


def banded_matvec(AB, kl, ku, x):
    """``A @ x`` from banded storage ``(..., kl+ku+1, n)`` and ``x``
    ``(..., n)``: a sum over the diagonals in order, each an elementwise
    product of shifted vectors."""
    n = x.shape[-1]
    pad = torch.nn.functional.pad
    y = torch.zeros_like(x)
    for d in range(kl + ku + 1):
        o = d - ku                               # i = j + o
        diag = AB[..., d, :]
        if o == 0:
            y = y + diag * x
        elif o > 0:                              # row i gets A[i, i-o] x
            y = y + pad(diag[..., :n - o] * x[..., :n - o], (o, 0))
        else:
            y = y + pad(diag[..., -o:] * x[..., -o:], (0, -o))
    return y


def banded_colored_jacfwd(fun, kl, ku, n):
    """``jac(t, y)`` -> ``(B, kl+ku+1, n)``: the banded Jacobian of the
    rows-first ``fun`` from ``kl + ku + 1`` JVPs, in the dtype of ``y``.
    Columns ``j`` and ``j + kl + ku + 1`` share no row, so ``groups[j] =
    j % (kl+ku+1)``, and the compressed columns scatter straight into
    banded storage."""
    C = kl + ku + 1
    groups = np.arange(n) % C
    seeds = np.zeros((C, n))
    seeds[groups, np.arange(n)] = 1.0
    # AB[d, j] = J[j + d - ku, j] = Jg[j % C, j + d - ku]
    d = np.arange(C)[:, None]
    j = np.arange(n)[None, :]
    i = j + d - ku
    valid = (i >= 0) & (i < n)
    flat = groups[None, :] * n + np.clip(i, 0, n - 1)   # into Jg (C n, B)
    cache = {}

    def jac(t, y):
        if y.device not in cache:
            cache[y.device] = tuple(_index(a, y) for a in (seeds, valid,
                                                          flat))
        sd, vd, fl = cache[y.device]
        Jg = seed_jvps(fun, t, y, sd)            # (C, n, B)
        AB = take(Jg.reshape(C * n, -1), 0, fl).permute(2, 0, 1)
        return torch.where(vd, AB, torch.zeros((), dtype=AB.dtype,
                                               device=AB.device))

    return jac                                   # (B, C, n)


def _next_pow2(m):
    p = 1
    while p < m:
        p *= 2
    return p


def block_shapes(n, kl, ku):
    """Static ``(b, m, n_pad)`` of the block-tridiagonal layout."""
    b = max(kl, ku, 1)
    m = _next_pow2(max(-(-n // b), 1))
    return b, m, m * b


@functools.lru_cache(maxsize=None)
def _block_index(n, kl, ku, device):
    """Gather indices of :func:`blocks_from_banded` on ``device``: the
    flat (band row, column) of D's, L's and U's entries, and the padded
    diagonal's mask."""
    C = kl + ku + 1
    b, m, n_pad = block_shapes(n, kl, ku)
    i = np.arange(m)[:, None, None]
    r = np.arange(b)[None, :, None]
    c = np.arange(b)[None, None, :]

    def flat(row_off, col_block):
        """Flat indices into the padded storage ``(C + 1) * n_pad``."""
        d = ku + r - c + row_off                  # band row index
        col = col_block * b + c
        bad = (d < 0) | (d >= C) | (col < 0) | (col >= n_pad)
        d = np.where(bad, C, np.clip(d, 0, C - 1))  # row C is a hard zero
        col = np.clip(col, 0, n_pad - 1)
        return torch.as_tensor(d * n_pad + col, device=device)

    pad_eye = (i * b + r >= n) & (r == c)
    return (flat(0, i), flat(b, i - 1), flat(-b, i + 1),
            torch.as_tensor(pad_eye, device=device))


def blocks_from_banded(AB, kl, ku, n):
    """``(D, L, U)``, each ``(B, m, b, b)``, of banded ``(B, kl+ku+1,
    n)``, identity-padded to a power-of-two number of blocks (pad rows
    decouple: D = I, L = U = 0, the right-hand side pads with zeros)."""
    b, m, n_pad = block_shapes(n, kl, ku)
    ABp = torch.nn.functional.pad(AB, (0, n_pad - n, 0, 1))  # row C = 0
    ABp = ABp.reshape(AB.shape[0], -1)
    iD, iL, iU, pad_eye = _block_index(n, kl, ku, AB.device)
    one = torch.ones((), dtype=AB.dtype, device=AB.device)
    # identity on padded diagonal entries so pad blocks stay inert
    D = torch.where(pad_eye, one, take(ABp, 1, iD))
    L = take(ABp, 1, iL)                         # rows i*b+r, cols -b
    U = take(ABp, 1, iU)
    L[:, 0] = 0.0
    U[:, m - 1] = 0.0
    return D, L, U


def _inv_batched(D):
    """Inverses of ``(B, m, b, b)`` blocks by ``gauss_solve``."""
    nb, m, b, _ = D.shape
    eye = torch.eye(b, dtype=D.dtype, device=D.device).expand(nb * m, b, b)
    return gauss_solve(D.reshape(nb * m, b, b), eye).reshape(nb, m, b, b)


def _shift_down(X):
    """``X'[:, k] = X[:, k-1]``, zeros at k = 0."""
    return torch.cat([torch.zeros_like(X[:, :1]), X[:, :-1]], dim=1)


def _shift_up(X):
    """``X'[:, k] = X[:, k+1]``, zeros at k = m-1."""
    return torch.cat([X[:, 1:], torch.zeros_like(X[:, :1])], dim=1)


def bcr_factor(D, L, U):
    """Factor a block-tridiagonal system by cyclic reduction.  Each level
    eliminates the odd blocks,
    ``x_o = D_o^{-1} (f_o - L_o x_left - U_o x_right)``, leaving the
    half-size system ``D' = D_e - P U_o< - Q L_o``, ``L' = -P L_o<``,
    ``U' = -Q U_o`` with ``P = L_e D_o<^{-1}``, ``Q = U_e D_o^{-1}``
    (``<``: the left odd neighbour).  Returns ``(levels, root_inverse)``,
    each level ``(P, Q, D_o^{-1}, L_o, U_o)``."""
    levels = []
    while D.shape[1] > 1:
        De, Do = D[:, 0::2], D[:, 1::2]
        Le, Lo = L[:, 0::2], L[:, 1::2]
        Ue, Uo = U[:, 0::2], U[:, 1::2]
        Dinv = _inv_batched(Do)
        P = Le @ _shift_down(Dinv)
        Q = Ue @ Dinv
        levels.append((P, Q, Dinv, Lo, Uo))
        D = De - P @ _shift_down(Uo) - Q @ Lo
        L = -(P @ _shift_down(Lo))
        U = -(Q @ Uo)
    return tuple(levels), _inv_batched(D)


def _bmv(M, v):
    return (M @ v[..., None])[..., 0]


def bcr_solve(fact, f):
    """Solve with a :func:`bcr_factor` result; ``f`` is ``(B, m, b)``
    blocked or ``(B, m*b)`` flat.  Returns the same shape."""
    levels, root = fact
    flat = f.ndim == 2
    if flat:
        f = f.reshape(f.shape[0], -1, root.shape[-1])
    fo_stack = []
    for (P, Q, Dinv, Lo, Uo) in levels:
        fe, fo = f[:, 0::2], f[:, 1::2]
        fo_stack.append(fo)
        f = fe - _bmv(P, _shift_down(fo)) - _bmv(Q, fo)
    x = _bmv(root, f)
    for (P, Q, Dinv, Lo, Uo), fo in zip(reversed(levels),
                                        reversed(fo_stack)):
        xo = _bmv(Dinv, fo - _bmv(Lo, x) - _bmv(Uo, _shift_up(x)))
        x = torch.stack([x, xo], dim=2).reshape(x.shape[0], -1, x.shape[-1])
    return x.reshape(x.shape[0], -1) if flat else x


def bcr_zero_factor(n, kl, ku, dtype, members=1, device=None):
    """A zero factor with the structure :func:`bcr_factor` gives for
    this size: the state's placeholder before the first factorization."""
    b, m, _ = block_shapes(n, kl, ku)
    levels = []
    while m > 1:
        m //= 2
        z = torch.zeros((members, m, b, b), dtype=dtype, device=device)
        levels.append((z, z, z, z, z))
    return tuple(levels), torch.zeros((members, 1, b, b), dtype=dtype,
                                      device=device)


def banded_factor(AB, kl, ku, n):
    """Banded storage ``(B, kl+ku+1, n)`` -> BCR factor."""
    return bcr_factor(*blocks_from_banded(AB, kl, ku, n))


def banded_solve(fact, b_vec, n, kl, ku):
    """Solve ``A x = b`` for ``b`` ``(B, n)`` (zero-padded to the block
    layout inside)."""
    bsz, m, n_pad = block_shapes(n, kl, ku)
    f = torch.nn.functional.pad(b_vec, (0, n_pad - n))
    return bcr_solve(fact, f.reshape(-1, m, bsz)).reshape(
        b_vec.shape[0], -1)[:, :n]
