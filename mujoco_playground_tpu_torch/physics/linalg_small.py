"""Small SPD solves (the port of the JAX package's
``physics/linalg_small.py``): the column-by-column Cholesky factorization and
its triangular solves, unrolled over the static n.  The ``_small`` functions
take one matrix (n, n) or leading batch dims (..., n, n), the per-env step's
solves; the ``_bl`` ones batch-last stacks, matrices ``(n, n, B)`` and
vectors ``(n, B)``, the env axis last."""
from __future__ import annotations

import torch


def cholesky_bl(A):
    """Cholesky of an (n, n, B) SPD stack -> lower-triangular (n, n, B)."""
    n = A.shape[0]
    cols = []
    for j in range(n):
        s = A[:, j, :]
        for k in range(j):
            s = s - cols[k] * cols[k][j][None, :]
        diag = torch.sqrt(torch.clamp_min(s[j], 1e-30))
        col = s / diag[None, :]
        below = (torch.arange(n, device=A.device) >= j)[:, None]
        cols.append(torch.where(below, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=1)


def cho_solve_bl(L, b):
    """Solve A x = b for the (n, n, B) factor L of A and an (n, B) rhs."""
    n = L.shape[0]
    y = []
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i, k] * y[k]
        y.append(s / L[i, i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k, i] * x[k]
        x[i] = s / L[i, i]
    return torch.stack(x, dim=0)


def cholesky_small(A):
    """Lower-triangular Cholesky factor of a small SPD matrix (..., n, n)."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        s = A[..., :, j]
        for k in range(j):
            s = s - cols[k] * cols[k][..., j:j + 1]
        diag = torch.sqrt(torch.clamp_min(s[..., j], 1e-30))
        col = s / diag[..., None]
        below = torch.arange(n, device=A.device) >= j
        cols.append(torch.where(below, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=-1)


def cho_solve_small(L, b):
    """Solve A x = b given L = cholesky_small(A); b (..., n)."""
    n = L.shape[-1]
    y = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y.append(s / L[..., i, i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def solve_spd_small(A, b):
    """Solve the small SPD system A x = b (unrolled Cholesky)."""
    return cho_solve_small(cholesky_small(A), b)
