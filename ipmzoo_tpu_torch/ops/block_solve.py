"""Block elimination for 2x2 quasi-definite KKT systems, batched.

Counterpart of :mod:`ipmzoo_tpu.ops.block_solve`.  The augmented system
of most formulations is

    K = [[ H,  B^T],      H (n x n) symmetric positive definite
         [ B,  -C ]]      C (m x m) symmetric positive definite

and for large n it factors as two Cholesky factorisations and products:

    H = Lh Lh^T,   T = H^-1 B^T,   S = C + B T,   S = Ls Ls^T

    solve:  y1 = H^-1 r1,   dy = S^-1 (T^T r1 - r2),   dx = y1 - T dy

Every array carries a leading batch axis; vectors are (batch, n).  The
work is library calls (``torch.linalg.cholesky_ex``,
``solve_triangular``, ``matmul``), as the reference's was XLA.  A
matrix that is not positive definite gives a NaN factor, as
``jnp.linalg.cholesky`` does, so the IPM's rollback sees it; nothing
syncs with the host.  Used by ``CompiledIPM(kernel="block")``.
"""

from __future__ import annotations

import torch

from .banded import _cholesky


def _t(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (..., r, c) x (..., c)."""
    return torch.matmul(A, x[..., None])[..., 0]


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b for b (..., n, k)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(_t(L), y, upper=True)


def _cho_solve_vec(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cho_solve(L, b[..., None])[..., 0]


def block2_factor(H: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """Factor K = [[H, B^T], [B, -C]] for H (b, n, n), B (b, m, n),
    C (b, m, m); returns opaque factors."""
    Lh = _cholesky(H)
    if B.shape[-2]:
        T = _cho_solve(Lh, _t(B))                 # (b, n, m)
        S = C + torch.matmul(B, T)
        Ls = _cholesky(S)
    else:
        T = H.new_zeros(H.shape[:-1] + (0,))
        Ls = H.new_zeros(H.shape[:-2] + (0, 0))
    return (Lh, T, Ls)


def block2_solve(factors, r1: torch.Tensor, r2: torch.Tensor):
    """Solve K [dx; dy] = [r1; r2] (r1 (b, n), r2 (b, m)) with factors
    from :func:`block2_factor`."""
    Lh, T, Ls = factors
    y1 = _cho_solve_vec(Lh, r1)
    if r2.shape[-1]:
        dy = _cho_solve_vec(Ls, _mv(_t(T), r1) - r2)
        dx = y1 - _mv(T, dy)
    else:
        dy = r2
        dx = y1
    return dx, dy


def block2_matvec(H, B, C, x1, x2):
    """K [x1; x2] for the same block structure (iterative refinement)."""
    if B.shape[-2]:
        return _mv(H, x1) + _mv(_t(B), x2), _mv(B, x1) - _mv(C, x2)
    return _mv(H, x1), x2


def block2_factor_inv(H: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """Like :func:`block2_factor` but binds the explicit inverses H^-1
    and S^-1, so that every later direction solve is products only."""
    n = H.shape[-1]
    Lh = _cholesky(H)
    eye_n = torch.eye(n, dtype=H.dtype, device=H.device).expand_as(H)
    Hinv = _cho_solve(Lh, eye_n)
    if B.shape[-2]:
        T = torch.matmul(Hinv, _t(B))             # H^-1 B^T  (b, n, m)
        S = C + torch.matmul(B, T)
        Ls = _cholesky(S)
        eye_m = torch.eye(S.shape[-1], dtype=H.dtype,
                          device=H.device).expand_as(S)
        Sinv = _cho_solve(Ls, eye_m)
    else:
        T = H.new_zeros(H.shape[:-1] + (0,))
        Sinv = H.new_zeros(H.shape[:-2] + (0, 0))
    return (Hinv, T, Sinv)


def block2_solve_inv(factors, r1: torch.Tensor, r2: torch.Tensor):
    """Solve with factors from :func:`block2_factor_inv`: products
    only."""
    Hinv, T, Sinv = factors
    y1 = _mv(Hinv, r1)
    if r2.shape[-1]:
        dy = _mv(Sinv, _mv(_t(T), r1) - r2)
        dx = y1 - _mv(T, dy)
    else:
        dy = r2
        dx = y1
    return dx, dy
