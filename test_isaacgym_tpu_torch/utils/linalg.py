"""Small batched SPD linear algebra.

Port of test_isaacgym_tpu/utils/linalg.py: the same unrolled batched
Cholesky, entry by entry, so the port rounds as the JAX package does. Every
system in the simulator is SPD (mass matrices, world-frame rotational
inertias, operational-space inertias), and the systems are tiny (3x3..9x9)
at a large batch, where one elementwise op per matrix entry beats a batched
library factorisation.
"""
from __future__ import annotations

import torch

from .trace import span

_UNROLL_MAX = 24


def _chol_unrolled(A):
    """Unrolled batched Cholesky. Returns (L, rinv): L[i][j] (i>=j) and
    1/L[j][j], each a (batch,) tensor."""
    n = A.shape[-1]
    a = [[A[..., i, j] for j in range(i + 1)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    rinv = [None] * n
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        r = 1.0 / d
        rinv[j] = r
        for i in range(j + 1, n):
            t = a[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * r
    return L, rinv


def spd_solve(A, B):
    """Solve A X = B for SPD A, batched over arbitrary leading axes.

    A: (..., n, n); B: (..., n) or (..., n, k). Unrolled Cholesky for
    n <= _UNROLL_MAX, else torch.linalg.solve.
    """
    with span("chol"):
        return _spd_solve(A, B)


def _spd_solve(A, B):
    n = A.shape[-1]
    vec = B.dim() == A.dim() - 1
    if n > _UNROLL_MAX:
        if vec:
            return torch.linalg.solve(A, B[..., None])[..., 0]
        return torch.linalg.solve(A, B)
    if vec:
        B = B[..., None]
    L, rinv = _chol_unrolled(A)
    b = [B[..., i, :] for i in range(n)]
    y = [None] * n
    for i in range(n):
        t = b[i]
        for k in range(i):
            t = t - L[i][k][..., None] * y[k]
        y[i] = t * rinv[i][..., None]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i][..., None] * x[k]
        x[i] = t * rinv[i][..., None]
    X = torch.stack(x, dim=-2)
    return X[..., 0] if vec else X


def spd_inv(A):
    """Batched SPD inverse via the unrolled Cholesky solve against identity."""
    with span("chol"):
        n = A.shape[-1]
        eye = torch.zeros_like(A) + torch.eye(n, dtype=A.dtype, device=A.device)
        if n > _UNROLL_MAX:
            return torch.linalg.solve(A, eye)
        return _spd_solve(A, eye)


# Historical name: every inverse in the simulator is of an SPD operator.
binv = spd_inv
