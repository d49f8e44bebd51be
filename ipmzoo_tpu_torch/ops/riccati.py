"""Block-tridiagonal KKT factor/solve via Riccati recursion.

Counterpart of :mod:`ipmzoo_tpu.ops.riccati`.  The Newton system of an
optimal-control (MPC) QP is block-tridiagonal: eliminating it stage by
stage from the terminal cost backwards is the discrete-time Riccati
recursion, an O(T (ns+nu)^3) direct factorisation of a system the dense
path would treat as O((T nu)^3).

System solved (Deltas of the IPM Newton step; ``x0`` is fixed so
``dx_0 = 0``):

    minimize  sum_k 1/2 dx_k' Qt_k dx_k + rx_k' dx_k
                  + 1/2 du_k' Rt_k du_k + ru_k' du_k      (k = 0..T-1,
    subject to dx_{k+1} = A_k dx_k + B_k du_k + d_k        x-index 1..T)

with value function V_k(dx) = 1/2 dx' P_k dx + p_k' dx:

    P_T = Qt_T,                 p_T = rx_T
    F_k = Rt_k + B_k' P_{k+1} B_k          (Cholesky; SPD for the
    K_k = -F_k^{-1} B_k' P_{k+1} A_k        quasi-definite IPM systems)
    P_k = Qt_k + A_k' P_{k+1} A_k + A_k' P_{k+1} B_k K_k
    k_k = -F_k^{-1} (ru_k + B_k' (P_{k+1} d_k + p_{k+1}))
    p_k = rx_k + A_k' (P_{k+1} (B_k k_k + d_k) + p_{k+1})

Every tensor may carry leading batch axes (the reference gets them from
``vmap``); the stage axis comes right after them: (..., T, ns, ns) for a
matrix, (..., T, ns) for a vector.  Each ``lax.scan`` of the reference is
a Python loop over the stages, each stage a few batched library calls
(matmul, ``cholesky_ex``, ``cholesky_solve``) on the whole batch.  No
Pallas kernel sits on this path in the reference, and none is written
here.

A factor that is not positive definite gives NaN, as
``jnp.linalg.cholesky`` does, so the IPM's divergence rollback sees it
(``banded._cholesky``: no host sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .banded import _cholesky, _t
from .block_solve import _mv


class RiccatiFactors(NamedTuple):
    """Rhs-independent elimination chain (stage axis after the batch
    axes)."""
    chol_F: torch.Tensor   # (..., T, nu, nu) lower Cholesky of Rt + B'P'B
    K: torch.Tensor        # (..., T, nu, ns) feedback gains
    P_next: torch.Tensor   # (..., T, ns, ns) P_{k+1} used at stage k


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + _t(M))


def riccati_factor(Qt: torch.Tensor, Rt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor) -> RiccatiFactors:
    """Backward elimination of the block-tridiagonal KKT matrix.

    Qt: (..., T, ns, ns) cost Hessians of x_1..x_T (Qt[-1] is terminal).
    Rt: (..., T, nu, nu) cost Hessians of u_0..u_{T-1}.
    A, B: (..., T, ns, ns), (..., T, ns, nu) dynamics of stages 0..T-1.
    """
    T = Rt.shape[-3]
    P_next = _sym(Qt[..., T - 1, :, :])
    Lfs, Ks, Ps = [None] * T, [None] * T, [None] * T
    for k in reversed(range(T)):
        Ak, Bk = A[..., k, :, :], B[..., k, :, :]
        M = P_next @ Bk                                   # (ns, nu)
        F = Rt[..., k, :, :] + _t(Bk) @ M                 # (nu, nu) SPD
        Lf = _cholesky(F)
        K = -torch.cholesky_solve(_t(M) @ Ak, Lf)         # (nu, ns)
        # stage k consumes Qt of x_k: none for k = 0 (x_0 is fixed)
        P = _t(Ak) @ P_next @ Ak
        if k > 0:
            P = Qt[..., k - 1, :, :] + P
        Lfs[k], Ks[k], Ps[k] = Lf, K, P_next
        P_next = _sym(P + (_t(Ak) @ M) @ K)
    return RiccatiFactors(chol_F=torch.stack(Lfs, dim=-3),
                          K=torch.stack(Ks, dim=-3),
                          P_next=torch.stack(Ps, dim=-3))


def riccati_solve(factors: RiccatiFactors, A: torch.Tensor,
                  B: torch.Tensor, rx: torch.Tensor, ru: torch.Tensor,
                  d: torch.Tensor):
    """Solve for one right-hand side using a precomputed factor chain.

    rx: (..., T, ns) linear residuals of x_1..x_T; ru: (..., T, nu) of
    u_0..u_{T-1}; d: (..., T, ns) dynamics-constraint offsets
    (dx_{k+1} = A dx + B du + d).

    Returns (dx, du, dy): dx (..., T, ns) for x_1..x_T, du (..., T, nu),
    dy (..., T, ns) dynamics duals, with dy_k = -(P_{k+1} dx_{k+1} +
    p_{k+1}).
    """
    T = ru.shape[-2]
    Lf, Kg, Pn = factors.chol_F, factors.K, factors.P_next
    # the products that read no carried value, one batched call each
    # over every stage instead of one call a stage
    Pd, PB = _mv(Pn, d), Pn @ B
    p_next = rx[..., T - 1, :]
    kks, p_nexts = [None] * T, [None] * T
    for k in reversed(range(T)):
        w = Pd[..., k, :] + p_next
        rhs = ru[..., k, :] + _mv(_t(B[..., k, :, :]), w)
        kk = -torch.cholesky_solve(rhs.unsqueeze(-1),
                                   Lf[..., k, :, :]).squeeze(-1)
        # P_{k+1} (B_k kk + d_k) + p_{k+1} = P_{k+1} B_k kk + w
        p = _mv(_t(A[..., k, :, :]), _mv(PB[..., k, :, :], kk) + w)
        if k > 0:
            p = rx[..., k - 1, :] + p
        kks[k], p_nexts[k] = kk, p_next
        p_next = p

    dx = torch.zeros_like(rx[..., 0, :])
    dxs, dus = [], []
    for k in range(T):
        du = _mv(Kg[..., k, :, :], dx) + kks[k]
        dx = _mv(A[..., k, :, :], dx) + _mv(B[..., k, :, :], du) + \
            d[..., k, :]
        dxs.append(dx)
        dus.append(du)
    dx = torch.stack(dxs, dim=-2)
    dy = -(_mv(Pn, dx) + torch.stack(p_nexts, dim=-2))
    return dx, torch.stack(dus, dim=-2), dy


def riccati_kkt_dense(Qt: torch.Tensor, Rt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor) -> torch.Tensor:
    """Materialise the block-tridiagonal KKT matrix densely (testing).

    Variable order: (dx_1..dx_T, du_0..du_{T-1}, dy_0..dy_{T-1}); rows are
    (x-stationarity, u-stationarity, dynamics).  Solving the dense system
    with [rx; ru; -d] as the negated rhs must match ``riccati_solve``.
    Leading batch axes give a batch of matrices.
    """
    T, ns, nu = A.shape[-3], A.shape[-2], B.shape[-1]
    nx, nU = T * ns, T * nu
    N = nx + nU + T * ns
    Kmat = Qt.new_zeros(A.shape[:-3] + (N, N))
    eye = torch.eye(ns, dtype=Qt.dtype, device=Qt.device)

    def X(k):   # slice of dx_k, k = 1..T
        return slice((k - 1) * ns, k * ns)

    def U(k):
        return slice(nx + k * nu, nx + (k + 1) * nu)

    def Y(k):
        return slice(nx + nU + k * ns, nx + nU + (k + 1) * ns)

    for k in range(1, T + 1):
        Kmat[..., X(k), X(k)] = Qt[..., k - 1, :, :]
        Kmat[..., X(k), Y(k - 1)] = eye
        if k <= T - 1:
            Kmat[..., X(k), Y(k)] = -_t(A[..., k, :, :])
    for k in range(T):
        Kmat[..., U(k), U(k)] = Rt[..., k, :, :]
        Kmat[..., U(k), Y(k)] = -_t(B[..., k, :, :])
    for k in range(T):
        Kmat[..., Y(k), X(k + 1)] = eye
        if k >= 1:
            Kmat[..., Y(k), X(k)] = -A[..., k, :, :]
        Kmat[..., Y(k), U(k)] = -B[..., k, :, :]
    return Kmat
