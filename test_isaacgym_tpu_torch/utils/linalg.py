"""Small batched SPD linear algebra.

Port of test_isaacgym_tpu/utils/linalg.py. Every system in the simulator is
SPD (mass matrices, world-frame rotational inertias, operational-space
inertias), and the systems are tiny (1x1..14x14) at a large batch. On the
card a system of n <= _UNROLL_MAX goes to csrc/chol.cu, one launch a call;
on the CPU to `_spd_solve`, its plain version: the JAX package's unrolled
Cholesky, one batched op a matrix entry and a term, in the same order. The
kernel does the same arithmetic in that order (no fused multiply-add), so
either route rounds as the JAX package does. Larger systems go to
torch.linalg.solve.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..ops import _kernels
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

    A: (..., n, n); B: (..., n) or (..., n, k). For n <= _UNROLL_MAX CUDA
    tensors launch csrc/chol.cu and CPU tensors take the plain version; else
    torch.linalg.solve.
    """
    with span("chol"):
        if A.device.type == "cpu" or A.shape[-1] > _UNROLL_MAX:
            return _spd_solve(A, B)
        return _chol_cuda(A, B)


def _spd_solve(A, B):
    """`spd_solve`'s plain version: the unrolled Cholesky solve of batched
    PyTorch ops, or torch.linalg.solve for n > _UNROLL_MAX."""
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
    """Batched SPD inverse: the solve against the identity, which the kernel
    forms itself."""
    with span("chol"):
        n = A.shape[-1]
        if A.device.type != "cpu" and n <= _UNROLL_MAX:
            return _chol_cuda(A, None)
        eye = torch.zeros_like(A) + torch.eye(n, dtype=A.dtype, device=A.device)
        return _spd_solve(A, eye)


# ---------------------------------------------------------------------------
# the hand-written kernel's wrapper (csrc/chol.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_ARGTYPES = (
    [_P, _P, _P]  # A B X
    + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]  # n k batch
    + [_P]  # stream
)


def _chol_cuda(A, B):
    """One launch of csrc/chol.cu on the current stream for float32 CUDA
    tensors, n <= _UNROLL_MAX; raises on anything else. B None gives A^-1.
    Leading axes broadcast as in the plain version and are flattened into
    the kernel's batch."""
    n = A.shape[-1]
    lead, out = A.shape[:-2], (n, n)
    if B is not None:
        out = (n,) if B.dim() == A.dim() - 1 else (n, B.shape[-1])
        if B.shape[:-len(out)] != lead:  # its first call imports sympy: seconds
            lead = torch.broadcast_shapes(lead, B.shape[:-len(out)])
    dev = A.device
    specs = [("A", A.expand(lead + (n, n)), lead + (n, n))]
    if B is not None:
        specs.append(("B", B.expand(lead + out), lead + out))
    a, *b = _kernels.inputs("chol", dev, specs)
    X = torch.empty(lead + out, dtype=torch.float32, device=dev)
    batch, k = math.prod(lead), out[-1] if len(out) == 2 else 1
    if batch == 0 or k == 0:  # nothing to solve: nothing to launch
        return X
    _kernels.launch(
        "chol", _kernels.entry("chol", "chol_forward", _ARGTYPES), dev,
        a.data_ptr(), b[0].data_ptr() if b else None, X.data_ptr(), n, k, batch,
    )
    return X


# Historical name: every inverse in the simulator is of an SPD operator.
binv = spd_inv
