"""Panel-blocked LDL^T on a leading batch axis: library trailing updates
for large systems.

Counterpart of :mod:`ipmzoo_tpu.ops.blocked_ldlt`.  A right-looking
panel factorisation: each (p x p) diagonal panel is factored by the
column LDL^T, the panel's block column is one triangular solve, and the
trailing update

    A22 <- A22 - L21 D1 L21^T

is one batched matrix product.  Sequential work drops from n columns to
n/p panels, and the O(n^3) bulk runs as library products.  In exact
arithmetic this is the column kernel's factor, the zero-pivot floor
decisions included (a column's pivot sees the fully updated leading
entries in both orderings).

The diagonal panels go through :func:`.cuda_ldlt.ldlt_k2`: kernel K2 on
CUDA tensors (its block route: a 128-panel fits a thread block's shared
memory in both types), the plain column LDL^T on CPU tensors.  A failed
launch raises; nothing falls back.  The block columns and the trailing
updates are ``torch.linalg.solve_triangular`` and ``torch.matmul``, as
the reference's were XLA.  The factors come back as plain (B, n, n) /
(B, n) tensors; :func:`solve_ldlt_blocked` and
:func:`solve_ldlt_matrix_blocked` solve against them with two library
triangular solves and a division, as the reference's ``solve_ldlt``.
"""

from __future__ import annotations

import torch

from . import cuda_ldlt
from .ldlt import PIVOT_FLOOR

DEFAULT_PANEL = 128


def ldlt_blocked(A: torch.Tensor, pivot_floor: float = PIVOT_FLOOR,
                 panel: int = DEFAULT_PANEL):
    """Factor a batch of symmetric matrices A (B, n, n) = L D L^T (L
    unit-lower (B, n, n), D (B, n)) panel by panel.  Orders up to
    ``panel`` are one column factorisation, as in the reference."""
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected (B, n, n), got {tuple(A.shape)}")
    B, n = A.shape[0], A.shape[-1]
    if n == 0:
        return torch.zeros_like(A), A.new_zeros((B, 0))
    if n <= panel:
        return cuda_ldlt.ldlt_k2(A, pivot_floor)
    if A.is_cuda:
        cuda_ldlt.route_launches["ldlt blocked"] += 1
    A = A.clone()
    L = torch.zeros_like(A)
    D = A.new_empty((B, n))
    for j in range(0, n, panel):
        p = min(panel, n - j)
        Ljj, Dj = cuda_ldlt.ldlt_k2(A[:, j:j + p, j:j + p].contiguous(),
                                    pivot_floor)
        L[:, j:j + p, j:j + p] = Ljj
        D[:, j:j + p] = Dj
        if j + p < n:
            # A21 = L21 D1 L11^T  =>  L21^T = D1^{-1} L11^{-1} A21^T
            T = torch.linalg.solve_triangular(
                Ljj, A[:, j:j + p, j + p:], upper=False, unitriangular=True)
            L21 = (T / Dj[:, :, None]).transpose(-1, -2)
            L[:, j + p:, j:j + p] = L21
            # trailing update A22 -= L21 D1 L21^T = L21 @ T (T = D1 L21^T)
            A[:, j + p:, j + p:] -= torch.matmul(L21, T)
    return L, D


def solve_ldlt_matrix_blocked(L: torch.Tensor, D: torch.Tensor,
                              R: torch.Tensor) -> torch.Tensor:
    """Solve L D L^T X = R per instance: L (B, n, n), D (B, n),
    R (B, n, k) -> X (B, n, k), by two library triangular solves."""
    if R.shape[-2] == 0 or R.shape[-1] == 0:
        return R
    y = torch.linalg.solve_triangular(L, R, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(L.transpose(-1, -2),
                                         y / D[:, :, None], upper=True,
                                         unitriangular=True)


def solve_ldlt_blocked(L: torch.Tensor, D: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Solve L D L^T x = b per instance: b (B, n) -> x (B, n)."""
    return solve_ldlt_matrix_blocked(L, D, b[:, :, None])[:, :, 0]
