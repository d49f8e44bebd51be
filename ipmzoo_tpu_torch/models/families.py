"""Canonical QP model families (counterpart of
:mod:`ipmzoo_tpu.models.families`).

Generators for the QP classes the solvers are designed around, each
returning :class:`QPData` (optionally batched) plus the recommended
formulation ``Settings`` (the port's own class).  The arrays are made
with numpy from ``seed`` by the reference's own sequence of draws, so the
same seed gives the reference's data; ``QPData.make`` then puts them on
``device`` (default: the CUDA device) in ``dtype`` (default float64).

All generators are deterministic given a seed and produce well-posed,
strictly feasible instances.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formulations import (Bounds, EqualityHandling, InequalityHandling,
                            Settings)
from .data import QPData


@dataclasses.dataclass
class Family:
    name: str
    data: QPData
    settings: Settings
    n: int
    m_ineq: int
    m_eq: int


def _rng(seed):
    return np.random.default_rng(seed)


def portfolio(n_assets: int = 32, batch: int = 0, seed: int = 0,
              risk_aversion: float = 1.0, max_weight: float = 0.2,
              dtype: torch.dtype = torch.float64, device=None) -> Family:
    """Markowitz portfolio optimisation.

        minimize    1/2 gamma w^T Sigma w - mu^T w
        subject to  sum(w) = 1,  0 <= w <= max_weight

    Sigma is a factor-model covariance (well conditioned, realistic
    spectrum).  With ``batch > 0`` the leaves carry a leading batch axis
    (independent scenarios).
    """
    rng = _rng(seed)
    shape = (batch, ) if batch else ()

    def gen(b_shape):
        k = max(2, n_assets // 4)
        F = rng.normal(size=b_shape + (n_assets, k)) / np.sqrt(k)
        spec = 0.05 + 0.2 * rng.random(b_shape + (n_assets,))
        Sigma = np.einsum("...ik,...jk->...ij", F, F)
        idx = np.arange(n_assets)
        Sigma[..., idx, idx] += spec
        mu = 0.02 + 0.05 * rng.random(b_shape + (n_assets,))
        return risk_aversion * Sigma, -mu

    Q, c = gen(shape)
    ones_row = np.ones(shape + (1, n_assets))
    b_eq = np.ones(shape + (1,))
    data = QPData.make(
        Q=Q, c=c,
        A_eq=ones_row, b_eq=b_eq,
        l_x=np.zeros(shape + (n_assets,)),
        u_x=np.full(shape + (n_assets,), max_weight),
        dtype=dtype, device=device)
    settings = Settings(
        inequalities=Bounds.NONE, equalities=True,
        equality_handling=EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL,
        inequality_handling=InequalityHandling.SLACKED_SLACKS)
    return Family("portfolio", data, settings, n_assets, 0, 1)


def mpc(horizon: int = 8, n_states: int = 4, n_controls: int = 2,
        batch: int = 0, seed: int = 0,
        dtype: torch.dtype = torch.float64,
        device=None) -> Family:
    """Condensed linear MPC tracking problem.

    States are eliminated, leaving the control trajectory
    u = (u_0..u_{T-1}) with

        minimize    1/2 u^T H u + g^T u
        subject to  -u_max <= u <= u_max,   |du_k| <= du_max (range rows)

    H = B_s^T Qbar B_s + Rbar from random stable (A, B) dynamics.
    """
    rng = _rng(seed)
    T, ns, nu = horizon, n_states, n_controls
    n = T * nu
    shape = (batch,) if batch else ()

    def one():
        A = rng.normal(size=(ns, ns))
        A *= 0.95 / max(1e-6, np.max(np.abs(np.linalg.eigvals(A))))
        B = rng.normal(size=(ns, nu))
        # prediction matrix: x_k = A^k x0 + sum_j A^{k-1-j} B u_j
        S = np.zeros((T * ns, n))
        Apow = [np.eye(ns)]
        for _ in range(T):
            Apow.append(Apow[-1] @ A)
        for k in range(T):
            for j in range(k + 1):
                S[k * ns:(k + 1) * ns, j * nu:(j + 1) * nu] = \
                    Apow[k - j] @ B
        Qbar = np.eye(T * ns)
        Rbar = 0.1 * np.eye(n)
        H = S.T @ Qbar @ S + Rbar
        x0 = rng.normal(size=ns)
        xref = np.zeros(T * ns)
        free = np.concatenate([Apow[k + 1] @ x0 for k in range(T)])
        g = S.T @ Qbar @ (free - xref)
        return H, g

    if batch:
        Hs, gs = zip(*(one() for _ in range(batch)))
        H, g = np.stack(Hs), np.stack(gs)
    else:
        H, g = one()

    # rate rows: du_k = u_k - u_{k-1}
    D = np.zeros(((T - 1) * nu, n))
    for k in range(T - 1):
        D[k * nu:(k + 1) * nu, (k + 1) * nu:(k + 2) * nu] = np.eye(nu)
        D[k * nu:(k + 1) * nu, k * nu:(k + 1) * nu] = -np.eye(nu)
    m = D.shape[0]
    D_b = np.broadcast_to(D, shape + D.shape).copy() if batch else D

    data = QPData.make(
        Q=H, c=g,
        A_ineq=D_b,
        l_A_ineq=np.full(shape + (m,), -0.5),
        u_A_ineq=np.full(shape + (m,), 0.5),
        l_x=np.full(shape + (n,), -1.0),
        u_x=np.full(shape + (n,), 1.0), dtype=dtype, device=device)
    return Family("mpc", data, Settings(), n, m, 0)


def svm_dual(n_samples: int = 64, n_features: int = 8, batch: int = 0,
             seed: int = 0, C: float = 1.0,
             dtype: torch.dtype = torch.float64,
             device=None) -> Family:
    """Soft-margin SVM dual (box-constrained QP).

        minimize    1/2 a^T (Y K Y) a - 1^T a
        subject to  0 <= a <= C        (bias-free kernel machine)
    """
    rng = _rng(seed)
    shape = (batch,) if batch else ()
    X = rng.normal(size=shape + (n_samples, n_features))
    w_true = rng.normal(size=shape + (n_features,))
    y = np.sign(np.einsum("...ij,...j->...i", X, w_true) +
                0.1 * rng.normal(size=shape + (n_samples,)))
    y = np.where(y == 0, 1.0, y)
    K = np.einsum("...ik,...jk->...ij", X, X)
    Q = K * y[..., :, None] * y[..., None, :]
    idx = np.arange(n_samples)
    Q[..., idx, idx] += 1e-6  # strict convexity
    data = QPData.make(
        Q=Q, c=-np.ones(shape + (n_samples,)),
        l_x=np.zeros(shape + (n_samples,)),
        u_x=np.full(shape + (n_samples,), C), dtype=dtype, device=device)
    return Family("svm_dual",
                  data, Settings(inequalities=Bounds.NONE),
                  n_samples, 0, 0)


def projection(n: int = 32, m: int = 12, batch: int = 0, seed: int = 0,
               dtype: torch.dtype = torch.float64, device=None) -> Family:
    """Euclidean projection onto a polyhedron:

        minimize    1/2 ||x - p||^2
        subject to  l_A <= A x <= u_A,  l <= x <= u
    """
    rng = _rng(seed)
    shape = (batch,) if batch else ()
    p = rng.normal(size=shape + (n,)) * 2
    A = rng.normal(size=shape + (m, n)) / np.sqrt(n)
    mid = np.einsum("...ij,...j->...i", A, np.zeros(shape + (n,)))
    data = QPData.make(
        Q=np.broadcast_to(np.eye(n), shape + (n, n)).copy(),
        c=-p,
        A_ineq=A,
        l_A_ineq=mid - 1.0, u_A_ineq=mid + 1.0,
        l_x=np.full(shape + (n,), -3.0),
        u_x=np.full(shape + (n,), 3.0), dtype=dtype, device=device)
    return Family("projection", data, Settings(), n, m, 0)


def elastic_net(n_features: int = 24, n_samples: int = 48,
                lam1: float = 0.1, lam2: float = 0.05, batch: int = 0,
                seed: int = 0,
                dtype: torch.dtype = torch.float64,
                device=None) -> Family:
    """Elastic-net regression as a nonnegative QP via variable splitting.

        minimize_w  1/2 ||A w - y||^2 + lam1 ||w||_1 + lam2/2 ||w||^2

    With w = u - v, u, v >= 0 the l1 term becomes linear and the QP is

        minimize 1/2 [u; v]^T Q [u; v] + c^T [u; v],  0 <= u, v <= R

    where Q = [[G+lam2 I, -G], [-G, G+lam2 I]], G = A^T A (lam2 > 0
    keeps Q positive definite).  Classic ML training workload; large
    batches of independent regularisation paths are the dp axis.
    """
    rng = _rng(seed)
    shape = (batch,) if batch else ()
    n = 2 * n_features
    A = rng.normal(size=shape + (n_samples, n_features))
    w_true = rng.normal(size=shape + (n_features,)) * \
        (rng.uniform(size=shape + (n_features,)) < 0.3)
    y = np.einsum("...ij,...j->...i", A, w_true) + \
        0.01 * rng.normal(size=shape + (n_samples,))
    G = np.einsum("...ji,...jk->...ik", A, A)
    Aty = np.einsum("...ji,...j->...i", A, y)
    eye = np.broadcast_to(np.eye(n_features), G.shape)
    Q = np.concatenate([
        np.concatenate([G + lam2 * eye, -G], axis=-1),
        np.concatenate([-G, G + lam2 * eye], axis=-1)], axis=-2)
    c = np.concatenate([lam1 - Aty, lam1 + Aty], axis=-1)
    R = 10.0 * (1.0 + np.abs(w_true).max())
    data = QPData.make(
        Q=Q, c=c,
        l_x=np.zeros(shape + (n,)), u_x=np.full(shape + (n,), R),
        dtype=dtype, device=device)
    return Family("elastic_net", data,
                  Settings(inequalities=Bounds.NONE), n, 0, 0)


def equality_qp(n: int = 24, m_eq: int = 6, batch: int = 0,
                seed: int = 0,
                dtype: torch.dtype = torch.float64,
                device=None) -> Family:
    """Equality-constrained QP kept EXACT (EqualityHandling.NONE):

        minimize 1/2 x^T Q x + c^T x   subject to   C x = d.

    The augmented system is genuinely indefinite (zero dual diagonal):
    ``CompiledIPM``'s 'auto' solves it through the signed-regularised
    LDL^T refined against the true system (kernel='regldlt'), as the
    reference does; kernel='lu' takes a pivoted LU instead.
    """
    rng = _rng(seed)
    shape = (batch,) if batch else ()
    M = rng.normal(size=shape + (n, n))
    Q = np.einsum("...ij,...kj->...ik", M, M) / n + \
        np.broadcast_to(np.eye(n), shape + (n, n))
    data = QPData.make(
        Q=Q, c=rng.normal(size=shape + (n,)),
        A_eq=rng.normal(size=shape + (m_eq, n)),
        b_eq=rng.normal(size=shape + (m_eq,)), dtype=dtype, device=device)
    settings = Settings(inequalities=Bounds.NONE,
                        variable_bounds=Bounds.NONE, equalities=True,
                        equality_handling=EqualityHandling.NONE)
    return Family("equality_qp", data, settings, n, 0, m_eq)


def arrow_chain(n: int = 96, bandwidth: int = 8, tip: int = 4,
                batch: int = 0, seed: int = 0,
                dtype: torch.dtype = torch.float64,
                device=None) -> Family:
    """Chain of locally coupled variables plus a few global coupling
    variables (banded+arrow Hessian) under box bounds — the workload
    :class:`ipmzoo_tpu_torch.models.arrow.ArrowIPM` factors in
    O(n (b+t)^2) instead of the dense O(n^3).  Returned as dense QPData
    for the generic solver; pair with ``ArrowQPData.from_dense`` (the
    detector recovers the structure exactly) for the structured path.
    """
    rng = _rng(seed)
    shape = (batch,) if batch else ()
    nb = n - tip
    Q = np.zeros(shape + (n, n))
    for i in range(nb):
        lo, hi = max(0, i - bandwidth), min(nb, i + bandwidth + 1)
        Q[..., i, lo:hi] = rng.normal(size=shape + (hi - lo,)) * 0.1
    Q = (Q + np.swapaxes(Q, -1, -2)) / 2
    strip = rng.normal(size=shape + (tip, n)) * 0.1
    Q[..., nb:, :] = strip
    Q[..., :, nb:] = np.swapaxes(strip, -1, -2)
    corner = Q[..., nb:, nb:]
    Q[..., nb:, nb:] = (corner + np.swapaxes(corner, -1, -2)) / 2
    Q += (2 * bandwidth + tip) * np.broadcast_to(np.eye(n), Q.shape)
    data = QPData.make(
        Q=Q, c=rng.normal(size=shape + (n,)) * 3,
        l_x=np.full(shape + (n,), -1.0),
        u_x=np.full(shape + (n,), 1.0), dtype=dtype, device=device)
    return Family("arrow_chain", data,
                  Settings(inequalities=Bounds.NONE,
                           inequality_handling=InequalityHandling.SLACKS),
                  n, 0, 0)


def grid_qp(side: int = 24, batch: int = 0, seed: int = 0,
            dtype: torch.dtype = torch.float64, device=None) -> Family:
    """Box-bounded QP whose Hessian couples variables on a side x side
    grid (5-point stencil — discretised control/estimation fields).
    The KKT sparsity has small separators, the workload
    ``CompiledIPM(kernel="nd")`` factors by nested-dissection block
    elimination (ops/ndiss.py) instead of the dense O(n^3) path.
    The nested-dissection benchmark's workload."""
    rng = _rng(seed)
    n = side * side
    shape = (batch,) if batch else ()
    Q = np.zeros(shape + (n, n))
    for i in range(side):
        for j in range(side):
            v = i * side + j
            for di, dj in ((0, 1), (1, 0)):
                ii, jj = i + di, j + dj
                if ii < side and jj < side:
                    Q[..., v, ii * side + jj] = \
                        0.25 * rng.normal(size=shape)
    Q = Q + np.swapaxes(Q, -1, -2)
    idx = np.arange(n)
    Q[..., idx, idx] = 4.0 + rng.random(shape + (n,))
    data = QPData.make(
        Q=Q, c=rng.normal(size=shape + (n,)),
        l_x=np.full(shape + (n,), -1.0),
        u_x=np.full(shape + (n,), 1.0), dtype=dtype, device=device)
    return Family("grid_qp", data,
                  Settings(inequalities=Bounds.NONE,
                           inequality_handling=InequalityHandling.SLACKS),
                  n, 0, 0)


FAMILIES = {
    "portfolio": portfolio,
    "mpc": mpc,
    "svm_dual": svm_dual,
    "projection": projection,
    "elastic_net": elastic_net,
    "equality_qp": equality_qp,
    "arrow_chain": arrow_chain,
    "grid_qp": grid_qp,
}
