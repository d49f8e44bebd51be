"""Banded + arrow structured KKT factorization on torch tensors.

Counterpart of :mod:`ipmzoo_tpu.ops.banded`.  A KKT matrix that is
*banded with an arrow* has a leading block that is symmetric banded
(half-bandwidth b) plus t dense trailing rows/columns.  A banded matrix
with half-bandwidth b is block-tridiagonal with block size b, so the
representation is

    D: (N, b, b) diagonal blocks      E: (N-1, b, b) sub-diagonal blocks
    U: (t, nb)   arrow strip          C: (t, t)      arrow tip

and the factorisation is a block-tridiagonal factor of the banded part,
one banded multi-rhs solve for the t arrow columns, and a dense (t x t)
Schur-complement Cholesky.  Every array may carry leading batch axes
(the reference gets them from ``vmap``; here they are written out).

:func:`detect_arrow` (host-side numpy, copied from the reference)
recovers (bandwidth, tip, permutation) from a dense symmetric matrix.

The banded part has three engines, chosen by ``method``:

* ``"scan"``: sequential block Cholesky (:func:`bt_factor` /
  :func:`bt_solve`), library calls in a Python loop over the N blocks;
* ``"cr"``: block cyclic reduction as a composition of batched library
  calls per level (:func:`cr_factor` / :func:`cr_solve`);
* ``"pl"``: the whole reduction in one kernel launch, K6/K7 of
  :mod:`.cuda_cr` on CUDA tensors and their plain versions on CPU
  tensors;
* ``"auto"``: on CUDA tensors ``"pl"`` for N >= 8, on CPU tensors
  ``"cr"`` for N >= 8, else ``"scan"``.

``"scan"`` and ``"cr"`` run on CUDA tensors when asked for by name; the
default on a card never reaches them.  The kernels' size limit raises a
``ValueError`` (:mod:`.cuda_cr`); nothing reroutes to ``"cr"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cr import CRKernelFactors
from .cuda_cr import cr_factor_auto, cr_solve_auto


class ArrowStructure(NamedTuple):
    """Host-side structure descriptor from :func:`detect_arrow`."""
    perm: np.ndarray        # permutation: banded columns first, wide last
    bandwidth: int          # half-bandwidth of the permuted leading block
    tip: int                # number of trailing (dense) arrow columns


def _rcm_order(n, ii, jj):
    """Reverse Cuthill-McKee ordering of the graph with edges (ii, jj)
    over nodes 0..n-1 — recovers a low-bandwidth ordering of a banded
    matrix whose rows were arbitrarily permuted."""
    adj = [[] for _ in range(n)]
    for a, b in zip(ii, jj):
        adj[a].append(b)
        adj[b].append(a)
    deg = np.array([len(a) for a in adj])
    visited = np.zeros(n, dtype=bool)
    order = []
    for start in np.argsort(deg, kind="stable"):   # min-degree seeds
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            order.append(u)
            nbrs = [v for v in adj[u] if not visited[v]]
            nbrs.sort(key=lambda v: deg[v])
            for v in nbrs:
                visited[v] = True
            queue.extend(nbrs)
    return np.array(order[::-1], dtype=np.int64)


def detect_arrow(Q, max_tip_frac: float = 0.25,
                 tol: float = 0.0) -> ArrowStructure:
    """Detect banded+arrow structure in a dense symmetric matrix.

    Three stages, all host-side numpy, run once per problem structure:

    1. *hub peel*: columns whose degree dwarfs the median are coupling
       (arrow) columns — move them to the tail;
    2. *RCM*: Reverse Cuthill-McKee reorders the remainder to minimise
       bandwidth, so the detection is permutation-invariant (a shuffled
       banded matrix is recovered);
    3. *greedy refinement*: while the widest remaining off-band pair
       dominates, peel the column incident to the most over-band pairs;
       every configuration is scored with the structured factor cost
       nb*(b + t)^2 + t^3 and the best wins.

    Compressing surviving columns' indices never grows their pairwise
    distances, so the reported bandwidth is valid for the returned
    permutation.
    """
    Q = np.asarray(Q)
    n = Q.shape[0]
    nz = np.abs(Q) > tol
    np.fill_diagonal(nz, False)
    ii0, jj0 = np.nonzero(np.triu(nz, 1))
    if ii0.size == 0:
        return ArrowStructure(np.arange(n), 1, 0)

    # stage 1: hub peel by degree
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, ii0, 1)
    np.add.at(deg, jj0, 1)
    med = np.median(deg[deg > 0])
    hubs = deg > max(8.0, 4.0 * med)
    if hubs.sum() > max_tip_frac * n:      # no separation: keep all
        hubs[:] = False

    # stage 2: RCM on the non-hub subgraph
    keep = ~hubs
    sub_edge = keep[ii0] & keep[jj0]
    old2sub = np.cumsum(keep) - 1
    sub_order = _rcm_order(int(keep.sum()), old2sub[ii0[sub_edge]],
                           old2sub[jj0[sub_edge]])
    sub_cols = np.nonzero(keep)[0]
    perm0 = np.concatenate([sub_cols[sub_order], np.nonzero(hubs)[0]])

    # re-express the pair list in perm0 coordinates for stage 3
    pos = np.empty(n, dtype=np.int64)
    pos[perm0] = np.arange(n)
    ii, jj = pos[ii0], pos[jj0]
    removed = np.zeros(n, dtype=bool)
    removed[int(keep.sum()):] = True       # hubs start in the tip
    # rank of each column among the survivors (compressed index)
    def current_cost():
        rank = np.cumsum(~removed) - 1
        alive = ~(removed[ii] | removed[jj])
        if not alive.any():
            b = 1
        else:
            b = max(1, int(np.max(np.abs(rank[ii[alive]] -
                                         rank[jj[alive]]))))
        t = int(removed.sum())
        return (n - t) * (b + t) ** 2 + t ** 3, b, t

    best_cost, best_b, best_t = current_cost()
    best_removed = removed.copy()
    max_tip = int(max_tip_frac * n)
    stale = 0
    for _ in range(max_tip):
        if stale >= 8:      # bandwidth stopped improving: peeling more
            break           # only grows the tip term of the cost
        rank = np.cumsum(~removed) - 1
        alive = ~(removed[ii] | removed[jj])
        if not alive.any():
            break
        d = np.abs(rank[ii] - rank[jj])
        d = np.where(alive, d, 0)
        b_now = int(d.max())
        # peel the column incident to the most pairs at distance > b/2 —
        # arrow columns touch O(n) such pairs, banded ones O(bandwidth)
        far = d > max(1, b_now // 2)
        score = np.zeros(n, dtype=np.int64)
        np.add.at(score, ii[far], 1)
        np.add.at(score, jj[far], 1)
        removed[int(np.argmax(score))] = True
        cost, b, t = current_cost()
        if cost < best_cost:
            best_cost, best_b, best_t = cost, b, t
            best_removed = removed.copy()
            stale = 0
        else:
            stale += 1

    perm_local = np.concatenate([np.nonzero(~best_removed)[0],
                                 np.nonzero(best_removed)[0]])
    return ArrowStructure(perm0[perm_local], best_b, best_t)


def _cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a matrix that is not positive definite
    gives NaN (as the reference's does) instead of raising, so the
    IPM's NaN rollback sees it.  No host sync."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _t(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


# ----------------------------------------------------------------------
# block-tridiagonal SPD Cholesky (loop over blocks)
# ----------------------------------------------------------------------

class BTFactors(NamedTuple):
    L: torch.Tensor    # (..., N, b, b) lower Cholesky factors of the pivots
    C: torch.Tensor    # (..., N, b, b) C[i] = E[i] L[i]^{-T}; C[N-1] = 0


def bt_factor(D: torch.Tensor, E: torch.Tensor) -> BTFactors:
    """Block-tridiagonal Cholesky: K = Lb Lb^T with block-bidiagonal Lb.

    D: (..., N, b, b) diagonal blocks (SPD after barrier condensation),
    E: (..., N-1, b, b) sub-diagonal blocks (block row i+1, column i).
    """
    N = D.shape[-3]
    S = D[..., 0, :, :]
    Ls, Cs = [], []
    for i in range(N):
        L = _cholesky(S)
        if i < N - 1:
            # C = E L^{-T}  (solve L C^T = E^T)
            C = _t(torch.linalg.solve_triangular(
                L, _t(E[..., i, :, :]), upper=False))
            S = D[..., i + 1, :, :] - C @ _t(C)
        else:
            C = torch.zeros_like(L)
        Ls.append(L)
        Cs.append(C)
    return BTFactors(L=torch.stack(Ls, dim=-3), C=torch.stack(Cs, dim=-3))


def bt_solve(f: BTFactors, r: torch.Tensor) -> torch.Tensor:
    """Solve the block-tridiagonal system for rhs r of shape
    (..., N, b, k) (k right-hand sides, blocked like D)."""
    L, C = f.L, f.C
    N = L.shape[-3]
    ys = []
    y = torch.zeros_like(r[..., 0, :, :])
    for i in range(N):
        rhs = r[..., i, :, :]
        if i:
            rhs = rhs - C[..., i - 1, :, :] @ y
        y = torch.linalg.solve_triangular(L[..., i, :, :], rhs, upper=False)
        ys.append(y)
    zs = [None] * N
    z = torch.zeros_like(y)
    for i in range(N - 1, -1, -1):
        z = torch.linalg.solve_triangular(
            _t(L[..., i, :, :]), ys[i] - _t(C[..., i, :, :]) @ z,
            upper=True)
        zs[i] = z
    return torch.stack(zs, dim=-3)


# ----------------------------------------------------------------------
# block cyclic reduction: batched levels instead of a sequential loop
# ----------------------------------------------------------------------
#
# Cyclic reduction eliminates all ODD blocks of a level at once:
# log2(N) levels of BATCHED (m, b, b) operations, about twice the flops of
# the sequential factor for a much shorter dependency chain.  Eliminating
# the odd blocks of an SPD block-tridiagonal matrix is a symmetrically
# permuted block Cholesky, so SPD is preserved level to level.  Explicit
# pivot inverses are stored so the solves are batched matmuls.


class CRLevel(NamedTuple):
    Pinv: torch.Tensor   # (..., m/2, b, b) inverses of the odd pivots
    Eb: torch.Tensor     # (..., m/2, b, b) left couplings  E[2k]
    Ea: torch.Tensor     # (..., m/2, b, b) right couplings E[2k+1]


class CRFactors(NamedTuple):
    levels: tuple            # CRLevel per reduction level
    root_inv: torch.Tensor   # (..., b, b) inverse of the last pivot
    n_blocks: int            # original (unpadded) block count


def _pow2_at_least(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _spd_inv(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse via Cholesky."""
    L = _cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(
        M.shape)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    return _t(Li) @ Li


def cr_factor(D: torch.Tensor, E: torch.Tensor) -> CRFactors:
    """Cyclic-reduction factorisation of an SPD block-tridiagonal
    matrix.  D: (..., N, b, b), E: (..., N-1, b, b) sub-diagonal
    blocks."""
    lead, N, b = tuple(D.shape[:-3]), D.shape[-3], D.shape[-1]
    m = _pow2_at_least(N)
    if m != N:      # pad with identity blocks, zero couplings
        eye = torch.eye(b, dtype=D.dtype, device=D.device)
        D = torch.cat([D, eye.expand(lead + (m - N, b, b))], dim=-3)
    E = torch.cat([E, D.new_zeros(lead + (m - E.shape[-3], b, b))],
                  dim=-3)                                  # (..., m, b, b)
    levels = []
    while m > 1:
        Po, Eb, Ea = D[..., 1::2, :, :], E[..., 0::2, :, :], \
            E[..., 1::2, :, :]
        Pinv = _spd_inv(Po)
        levels.append(CRLevel(Pinv=Pinv, Eb=Eb, Ea=Ea))
        PiEb = Pinv @ Eb                       # (..., m/2, b, b)
        De = D[..., 0::2, :, :] - _t(Eb) @ PiEb
        left = Ea @ Pinv @ _t(Ea)
        De = torch.cat([De[..., :1, :, :],
                        De[..., 1:, :, :] - left[..., :-1, :, :]], dim=-3)
        D, E, m = De, -(Ea @ PiEb), m // 2     # E'[k], last entry 0
    return CRFactors(levels=tuple(levels),
                     root_inv=_spd_inv(D[..., 0, :, :]), n_blocks=N)


def cr_solve(f: CRFactors, r: torch.Tensor) -> torch.Tensor:
    """Solve with :func:`cr_factor` factors; r: (..., N, b, k)."""
    lead, (N, b, k) = tuple(r.shape[:-3]), r.shape[-3:]
    m = _pow2_at_least(N)
    if m != N:
        r = torch.cat([r, r.new_zeros(lead + (m - N, b, k))], dim=-3)
    # down-sweep: fold odd rhs into even neighbours
    stack = []
    for lev in f.levels:
        ro = r[..., 1::2, :, :]
        g = lev.Pinv @ ro                      # (..., m/2, b, k)
        re = r[..., 0::2, :, :] - _t(lev.Eb) @ g
        fold = (lev.Ea @ g)[..., :-1, :, :]
        re = torch.cat([re[..., :1, :, :], re[..., 1:, :, :] - fold],
                       dim=-3)
        stack.append(ro)
        r = re
    x = (f.root_inv @ r[..., 0, :, :]).unsqueeze(-3)       # (..., 1, b, k)
    # up-sweep: recover odd unknowns
    for lev, ro in zip(reversed(f.levels), reversed(stack)):
        m2 = x.shape[-3]
        xe_next = torch.cat([x[..., 1:, :, :],
                             x.new_zeros(lead + (1, b, k))], dim=-3)
        xo = lev.Pinv @ (ro - lev.Eb @ x - _t(lev.Ea) @ xe_next)
        x = torch.stack([x, xo], dim=-3).reshape(lead + (2 * m2, b, k))
    return x[..., :N, :, :]


# ----------------------------------------------------------------------
# arrow = block-tridiagonal + dense tip, via Schur complement
# ----------------------------------------------------------------------

class ArrowFactors(NamedTuple):
    bt: object                # BTFactors, CRFactors or CRKernelFactors
    W: torch.Tensor           # (..., N, b, t) = B^{-1} U^T, blocked
    tip_chol: torch.Tensor    # (..., t, t) lower Cholesky of the tip Schur


METHODS = ("auto", "scan", "cr", "pl")


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method={method!r}; expected 'scan', "
                         "'cr', 'pl' or 'auto'")


def resolve_method(method: str, D: torch.Tensor) -> str:
    """``"auto"`` as described in the module docstring."""
    check_method(method)
    if method != "auto":
        return method
    if D.shape[-3] < 8:
        return "scan"
    return "pl" if D.device.type == "cuda" else "cr"


def _bfactor(D, E, method: str):
    method = resolve_method(method, D)
    if method == "pl":
        return cr_factor_auto(D, E)
    return cr_factor(D, E) if method == "cr" else bt_factor(D, E)


def _bsolve(fac, r):
    if isinstance(fac, CRKernelFactors):
        return cr_solve_auto(fac, r)
    return cr_solve(fac, r) if isinstance(fac, CRFactors) else \
        bt_solve(fac, r)


def _strip_blocks(U: torch.Tensor, N: int, b: int) -> torch.Tensor:
    """The arrow strip U (..., t, nb) as right-hand sides (..., N, b, t)."""
    t = U.shape[-2]
    return U.reshape(U.shape[:-2] + (t, N, b)).movedim(-3, -1)


def _tip_solve(tip_chol: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = r for r (..., t)."""
    return torch.cholesky_solve(r.unsqueeze(-1), tip_chol,
                                upper=False).squeeze(-1)


def arrow_factor(D, E, U, Ctip, method: str = "auto") -> ArrowFactors:
    """Factor [[B, U^T], [U, Ctip]] with B block-tridiagonal SPD (given
    as D, E) and t = Ctip.shape[-1] dense arrow rows (SPD overall).

    ``method``: see the module docstring."""
    N, b = D.shape[-3], D.shape[-1]
    t = Ctip.shape[-1]
    fac = _bfactor(D, E, method)
    if t == 0:
        return ArrowFactors(bt=fac, W=D.new_zeros(D.shape[:-2] + (b, 0)),
                            tip_chol=Ctip)
    Ub = _strip_blocks(U, N, b)                          # (..., N, b, t)
    W = _bsolve(fac, Ub)                                 # (..., N, b, t)
    S = Ctip - torch.einsum("...nbt,...nbs->...ts", W, Ub)
    return ArrowFactors(bt=fac, W=W, tip_chol=_cholesky(S))


def arrow_factor_solve(D, E, U, Ctip, r_band, r_tip,
                       method: str = "auto"):
    """:func:`arrow_factor` fused with one :func:`arrow_solve`.

    The banded multi-rhs solve for the t arrow columns and the solve for
    ``r_band`` share one banded solve with k = t+1 stacked right-hand
    sides: one launch fewer per IPM iteration than factor-then-solve.
    Returns ``(factors, (x_band, x_tip))`` with r_band (..., nb) and
    r_tip (..., t).
    """
    N, b = D.shape[-3], D.shape[-1]
    t = Ctip.shape[-1]
    fac = _bfactor(D, E, method)
    rb = r_band.reshape(r_band.shape[:-1] + (N, b, 1))
    if t == 0:
        w = _bsolve(fac, rb)
        factors = ArrowFactors(bt=fac,
                               W=D.new_zeros(D.shape[:-2] + (b, 0)),
                               tip_chol=Ctip)
        return factors, (w[..., 0].reshape(r_band.shape), r_tip)
    Ub = _strip_blocks(U, N, b)                          # (..., N, b, t)
    sol = _bsolve(fac, torch.cat([Ub, rb], dim=-1))
    W, w = sol[..., :t], sol[..., t]                     # (N,b,t), (N,b)
    S = Ctip - torch.einsum("...nbt,...nbs->...ts", W, Ub)
    tip_chol = _cholesky(S)
    factors = ArrowFactors(bt=fac, W=W, tip_chol=tip_chol)
    Urw = torch.einsum("...nbt,...nb->...t", W, rb[..., 0])
    x_tip = _tip_solve(tip_chol, r_tip - Urw)
    x_band = (w - torch.einsum("...nbt,...t->...nb", W, x_tip)).reshape(
        r_band.shape)
    return factors, (x_band, x_tip)


def arrow_solve(f: ArrowFactors, r_band: torch.Tensor,
                r_tip: torch.Tensor) -> tuple:
    """Solve for rhs (r_band: (..., nb), r_tip: (..., t)); returns
    (x_band, x_tip)."""
    N, b, t = f.W.shape[-3:]
    rb = r_band.reshape(r_band.shape[:-1] + (N, b, 1))
    w = _bsolve(f.bt, rb)                                # (..., N, b, 1)
    if t == 0:
        return w[..., 0].reshape(r_band.shape), r_tip
    # U B^{-1} r = (B^{-1} U^T)^T r = W^T r  (B symmetric)
    Urw = torch.einsum("...nbt,...nb->...t", f.W, rb[..., 0])
    x_tip = _tip_solve(f.tip_chol, r_tip - Urw)
    # x_band = B^{-1}(r - U^T x_tip) = w - W x_tip
    x_band = (w[..., 0] - torch.einsum("...nbt,...t->...nb", f.W,
                                       x_tip)).reshape(r_band.shape)
    return x_band, x_tip


def band_to_blocks(H: torch.Tensor, b: int, t: int):
    """Split a dense banded+arrow matrix (already permuted) into the
    structured representation (D, E, U, Ctip).  nb = n - t must be a
    multiple of b (pad upstream if needed)."""
    n = H.shape[-1]
    nb = n - t
    if nb % b:
        raise ValueError(f"banded part {nb} not a multiple of block {b}")
    N = nb // b
    Hb = H[:nb, :nb].reshape(N, b, N, b)
    idx = torch.arange(N, device=H.device)
    D = Hb[idx, :, idx, :]
    E = Hb[idx[1:], :, idx[:-1], :] if N > 1 else H.new_zeros((0, b, b))
    return D, E, H[nb:, :nb], H[nb:, nb:]
