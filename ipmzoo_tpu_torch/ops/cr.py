"""Whole-reduction block cyclic reduction of an SPD block-tridiagonal
matrix: the factor container and the plain torch versions of kernels K6
(factor) and K7 (solve).

Counterpart of :mod:`ipmzoo_tpu.ops.cr_pallas` (``cr_factor_pallas`` /
``cr_solve_pallas``, ``CRPLFactors``).  The CUDA kernels are
``csrc/cr.cu``, launched by :mod:`.cuda_cr`; the functions here repeat
their arithmetic step by step on batched tensors, in the kernels' order
of accumulation, so that in float64 the two differ only by the compiler's
FMA contraction.  The CPU tests run them, ``method="pl"`` on CPU tensors
runs them, and the smoke test holds the kernels against them on the card.

Layout.  Every array carries optional leading batch axes.  The matrix is
D (..., N, b, b) diagonal blocks and E (..., N-1, b, b) sub-diagonal
blocks (block row i+1, column i).  At the level of stride s = 1, 2, 4, ...
< N the blocks at positions p = s, 3s, 5s, ... < N (the "odd" blocks of
the level) are eliminated; every position 1..N-1 is eliminated at exactly
one level and position 0 is the root.  The factors are therefore three
arrays indexed by block position, with no padding to a power of two:

    Pinv[p]  explicit inverse of block p's pivot when it is eliminated
             (Pinv[0] is the root's inverse)
    Eb[p]    coupling of p to its left neighbour p - s at that level
    Ea[p]    coupling of p to its right neighbour p + s (zero when
             p + s >= N)

with Eb[0] = Ea[0] = 0.  The inverse is Cholesky based: L, then L^-1 by
forward substitution on the identity, then L^-T L^-1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CRKernelFactors(NamedTuple):
    """Factors of K6 (or of its plain version), indexed by block
    position; see the module docstring."""
    Pinv: torch.Tensor   # (..., N, b, b)
    Eb: torch.Tensor     # (..., N, b, b)
    Ea: torch.Tensor     # (..., N, b, b)


def levels(N: int) -> list:
    """The strides 1, 2, 4, ... < N of the reduction's levels."""
    out, s = [], 1
    while s < N:
        out.append(s)
        s *= 2
    return out


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, n) @ (..., n, k), accumulated over the shared index in
    increasing order starting from its first product, as the kernels
    do."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for j in range(1, A.shape[-1]):
        acc = acc + A[..., :, j:j + 1] * B[..., j:j + 1, :]
    return acc


def _t(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def chol_inv_plain(P: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batch of SPD blocks (..., b, b) through the
    Cholesky factor.  A block that is not positive definite gives NaN."""
    b = P.shape[-1]
    # L below the diagonal; the diagonal holds 1 / L_jj
    L = torch.zeros_like(P)
    for j in range(b):
        acc = P[..., j, j]
        for k in range(j):
            acc = acc - L[..., j, k] * L[..., j, k]
        idj = 1.0 / torch.sqrt(acc)
        col = P[..., j + 1:, j]
        for k in range(j):
            col = col - L[..., j + 1:, k] * L[..., j:j + 1, k]
        L[..., j + 1:, j] = col * idj[..., None]
        L[..., j, j] = idj
    # X = L^-1 row by row: X_i = (e_i - sum_{k<i} L_ik X_k) / L_ii
    X = torch.zeros_like(P)
    for i in range(b):
        e = torch.zeros(b, dtype=P.dtype, device=P.device)
        e[i] = 1.0
        if i:
            acc = L[..., i, 0:1] * X[..., 0, :]
            for k in range(1, i):
                acc = acc + L[..., i, k:k + 1] * X[..., k, :]
            e = e - acc
        X[..., i, :] = e * L[..., i, i:i + 1]
    return _mm(_t(X), X)


def cr_factor_plain(D: torch.Tensor, E: torch.Tensor) -> CRKernelFactors:
    """Plain version of K6.  D (..., N, b, b) SPD diagonal blocks,
    E (..., N-1, b, b) sub-diagonal blocks."""
    N = D.shape[-3]
    dev = D.device
    Dw = D.clone()
    # Ew[q] couples q and q + s at the current level; zero when absent
    Ew = torch.zeros_like(D)
    Ew[..., :N - 1, :, :] = E
    Pinv = torch.empty_like(D)
    Eb = torch.zeros_like(D)
    Ea = torch.zeros_like(D)
    for s in levels(N):
        odd = torch.arange(s, N, 2 * s, device=dev)
        Pi = chol_inv_plain(Dw[..., odd, :, :])
        eb = Ew[..., odd - s, :, :]
        ea = Ew[..., odd, :, :]
        Pinv[..., odd, :, :] = Pi
        Eb[..., odd, :, :] = eb
        Ea[..., odd, :, :] = ea
        T = _mm(Pi, eb)
        G = _mm(ea, Pi)
        # the even block on the left of p takes Eb^T Pinv Eb, then the
        # even block on its right (if any) takes Ea Pinv Ea^T
        Dw[..., odd - s, :, :] = Dw[..., odd - s, :, :] - _mm(_t(eb), T)
        has_right = odd + s < N
        right = (odd + s)[has_right]
        Dw[..., right, :, :] = Dw[..., right, :, :] - \
            _mm(G, _t(ea))[..., has_right, :, :]
        # new coupling of p - s to p + s; zero when p + s >= N
        Enew = -_mm(ea, T)
        Enew[..., ~has_right, :, :] = 0.0
        Ew[..., odd - s, :, :] = Enew
    Pinv[..., 0, :, :] = chol_inv_plain(Dw[..., 0, :, :])
    return CRKernelFactors(Pinv=Pinv, Eb=Eb, Ea=Ea)


def cr_solve_plain(f: CRKernelFactors, r: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: solve against ``cr_factor_plain``'s (or
    K6's) factors for r (..., N, b, k)."""
    N = r.shape[-3]
    dev = r.device
    Rw = r.clone()
    x = torch.empty_like(r)
    # down-sweep: fold the odd right-hand sides into their even
    # neighbours; the odd entries of Rw stay as they were at their level
    for s in levels(N):
        odd = torch.arange(s, N, 2 * s, device=dev)
        g = _mm(f.Pinv[..., odd, :, :], Rw[..., odd, :, :])
        Rw[..., odd - s, :, :] = Rw[..., odd - s, :, :] - \
            _mm(_t(f.Eb[..., odd, :, :]), g)
        has_right = odd + s < N
        right = (odd + s)[has_right]
        Rw[..., right, :, :] = Rw[..., right, :, :] - \
            _mm(f.Ea[..., odd, :, :], g)[..., has_right, :, :]
    x[..., 0, :, :] = _mm(f.Pinv[..., 0, :, :], Rw[..., 0, :, :])
    # up-sweep: recover the odd unknowns of each level
    for s in reversed(levels(N)):
        odd = torch.arange(s, N, 2 * s, device=dev)
        rhs = Rw[..., odd, :, :] - _mm(f.Eb[..., odd, :, :],
                                       x[..., odd - s, :, :])
        has_right = odd + s < N
        ov = odd[has_right]
        rhs[..., has_right, :, :] = rhs[..., has_right, :, :] - \
            _mm(_t(f.Ea[..., ov, :, :]), x[..., ov + s, :, :])
        x[..., odd, :, :] = _mm(f.Pinv[..., odd, :, :], rhs)
    return x
