"""Batched dense LDL^T factorisation and solve in plain torch.

Counterpart of :mod:`ipmzoo_tpu.ops.ldlt` (the column algorithm of
``ldlt`` and the forward / diagonal / backward sweeps of ``solve_ldlt``),
written over a leading batch axis, and of the multi-rhs solve and the
fused factor + multi-rhs solve of :mod:`ipmzoo_tpu.ops.pallas_ldlt`
(``solve_ldlt_matrix``, ``ldlt_solve_matrix``).  These are the plain
versions of the CUDA kernels in ``csrc/ldlt.cu`` (K2, K3, K4, K5):
:mod:`.cuda_ldlt` runs them for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels to them.  :func:`ldlt_solve` and
:func:`cholesky_solve` are the reference's one-call solves, on the
kernels for CUDA tensors.

The augmented KKT system of an interior-point iteration is symmetric
quasi-definite, so an unpivoted LDL^T is stable; an exactly-zero pivot is
replaced by ``pivot_floor`` (Vanderbei 1995).
"""

from __future__ import annotations

import torch

PIVOT_FLOOR = 1e-8


def ldlt(A: torch.Tensor, pivot_floor: float = PIVOT_FLOOR):
    """Factor a batch of symmetric matrices A (B, n, n) = L D L^T.

    Returns L (B, n, n) unit-lower-triangular and D (B, n).  Only an
    exactly-zero pivot is replaced by ``pivot_floor``."""
    B, n = A.shape[0], A.shape[-1]
    L = torch.zeros_like(A)
    D = A.new_zeros((B, n))
    for j in range(n):
        lj = L[:, j, :j]                          # L[j, k<j]
        w = lj * D[:, :j]                         # L[j,k] D[k]
        d = A[:, j, j] - (lj * w).sum(-1)
        d = torch.where(d == 0, torch.full_like(d, pivot_floor), d)
        s = torch.matmul(L[:, j + 1:, :j], w.unsqueeze(-1)).squeeze(-1)
        L[:, j + 1:, j] = (A[:, j + 1:, j] - s) / d.unsqueeze(-1)
        L[:, j, j] = 1.0
        D[:, j] = d
    return L, D


def solve_ldlt(L: torch.Tensor, D: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Solve L D L^T x = b per instance: L (B, n, n), D (B, n), b (B, n).

    Forward sweep with the unit-lower L, division by D, backward sweep
    with L^T."""
    n = b.shape[-1]
    x = b.clone()
    for i in range(1, n):
        x[:, i] = x[:, i] - (L[:, i, :i] * x[:, :i]).sum(-1)
    x = x / D
    for i in range(n - 2, -1, -1):
        x[:, i] = x[:, i] - (L[:, i + 1:, i] * x[:, i + 1:]).sum(-1)
    return x


def solve_ldlt_matrix(L: torch.Tensor, D: torch.Tensor,
                      R: torch.Tensor) -> torch.Tensor:
    """Solve L D L^T X = R per instance for k right-hand sides: L (B, n, n),
    D (B, n), R (B, n, k) -> X (B, n, k).

    The sweep order of the reference's multi-rhs Pallas kernel: a
    column-oriented forward sweep, x[j+1:] -= L[j+1:, j] x[j]; division
    by D; a row-sum backward sweep, x[i] -= sum_{k>i} L[k, i] x[k]."""
    n = R.shape[-2]
    x = R.clone()
    for j in range(n - 1):
        x[:, j + 1:, :] = x[:, j + 1:, :] - \
            L[:, j + 1:, j, None] * x[:, j, None, :]
    x = x / D[:, :, None]
    for i in range(n - 2, -1, -1):
        x[:, i, :] = x[:, i, :] - \
            (L[:, i + 1:, i, None] * x[:, i + 1:, :]).sum(-2)
    return x


def ldlt_solve_matrix(A: torch.Tensor, R: torch.Tensor,
                      pivot_floor: float = PIVOT_FLOOR):
    """Factor and solve in one call: A (B, n, n), R (B, n, k) ->
    (L, D, X) with L D L^T X = R per instance.

    The plain version of kernel K5: the column LDL^T of :func:`ldlt`
    followed by the sweeps of :func:`solve_ldlt_matrix`, which is what
    the kernel computes in one launch (elimination of column j applied
    to the trailing matrix and to the rhs columns alike, subtracted in
    increasing j; division by D; backward sweep).  n = 0 gives empty
    factors and R back; k = 0 the factors and R back."""
    B, n = A.shape[0], A.shape[-1]
    if n == 0:
        return torch.zeros_like(A), A.new_zeros((B, 0)), R
    L, D = ldlt(A, pivot_floor)
    if R.shape[-1] == 0:
        return L, D, R
    return L, D, solve_ldlt_matrix(L, D, R)


def _batched(A: torch.Tensor, b: torch.Tensor):
    """(A, b) with a leading batch axis, and whether one was added: A
    (n, n) / b (n,) is one system, A (B, n, n) / b (B, n) a batch."""
    one = A.dim() == 2
    if A.dim() - 1 != b.dim() or A.shape[-1] != A.shape[-2] or \
            A.shape[:-1] != b.shape or A.dim() not in (2, 3):
        raise ValueError(f"expected A (n, n) and b (n,), or a batch of "
                         f"them, got {tuple(A.shape)} and {tuple(b.shape)}")
    return (A[None], b[None], one) if one else (A, b, one)


def ldlt_solve(A: torch.Tensor, b: torch.Tensor,
               pivot_floor: float = PIVOT_FLOOR) -> torch.Tensor:
    """Solve A x = b by LDL^T (the reference's ``ldlt_solve``): A (n, n)
    and b (n,), or a batch (B, n, n) / (B, n).  On CUDA tensors the
    factor and the solve run on the kernels (:func:`.cuda_ldlt.ldlt_auto`,
    :func:`.cuda_ldlt.solve_ldlt_auto`), on CPU tensors their plain
    versions."""
    from .cuda_ldlt import ldlt_auto, solve_ldlt_auto
    A, b, one = _batched(A, b)
    if b.shape[-1] == 0:
        x = b
    else:
        L, D = ldlt_auto(A, pivot_floor)
        x = solve_ldlt_auto(L, D, b)
    return x[0] if one else x


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive definite A by the library's
    Cholesky factor and two triangular solves (the reference's
    ``cholesky_solve``): A (n, n) and b (n,), or a batch.  A matrix that
    is not positive definite gives NaN, as the reference's does."""
    from .banded import _cholesky
    A, b, one = _batched(A, b)
    L = _cholesky(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                      upper=True)[..., 0]
    return x[0] if one else x
