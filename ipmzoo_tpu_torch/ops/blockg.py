"""Signed block-Cholesky factorisation over the symbolic group structure,
batched.

Counterpart of :mod:`ipmzoo_tpu.ops.blockg`.  The augmented KKT system
of a quasi-definite formulation is a G x G block matrix whose diagonal
blocks have structurally known signs: + for a primal group (x, slacks,
regularisation p), - for a dual group (lambda).  Such a matrix factors
as

    K = Lt Sigma Lt^T,   Sigma = diag(sigma_i I_{s_i}),  sigma_i = +-1

with block-lower-triangular Lt whose diagonal blocks are ordinary
Cholesky factors (Vanderbei 1995).  Eliminating groups instead of
columns gives G stages of a library Cholesky, triangular solves and one
trailing-update product per remaining pair: sequential depth G (2-6 in
practice).  This generalises :mod:`.block_solve` (its G=2, signs (+, -)
case) to every quasi-definite augmented structure of the lattice.

Every block carries a leading batch axis; right-hand sides are
(batch, sum s_i).  A stage whose block is not definite gives a NaN
factor, as ``jnp.linalg.cholesky`` does; empty groups (s_i = 0) pass
through.
"""

from __future__ import annotations

import torch

from .banded import _cholesky


def _t(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, x[..., None])[..., 0]


def _tri(L: torch.Tensor, b: torch.Tensor, upper: bool) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, b[..., None],
                                         upper=upper)[..., 0]


def blockg_factor(blocks, signs):
    """Factor K = Lt Sigma Lt^T for a G x G block matrix.

    blocks: nested list, blocks[i][j] = (batch, s_i, s_j) cell of K (both
    triangles supplied).  signs: length-G sequence of +-1.0, the
    definiteness sign of each (updated) diagonal block.  Returns opaque
    factors for :func:`blockg_solve`."""
    G = len(signs)
    work = [[blocks[i][j] for j in range(i + 1)] for i in range(G)]
    Ld = [None] * G                      # diagonal Cholesky factors
    Lt = [[None] * G for _ in range(G)]  # strictly-lower blocks

    for i in range(G):
        si = work[i][i].shape[-1]
        Ld[i] = _cholesky(signs[i] * work[i][i]) if si else work[i][i]
        # T_j = Li^{-1} K'[j][i]^T = sigma_i Lt[j][i]^T
        Ts = {}
        for j in range(i + 1, G):
            sj = work[j][i].shape[-2]
            if si == 0 or sj == 0:
                Lt[j][i] = work[j][i].new_zeros(work[j][i].shape[:-2] +
                                                (sj, si))
                Ts[j] = _t(Lt[j][i])
                continue
            T = torch.linalg.solve_triangular(Ld[i], _t(work[j][i]),
                                              upper=False)
            Ts[j] = T
            Lt[j][i] = signs[i] * _t(T)
        # trailing update: K'[j][l] -= sigma_i T_j^T T_l   (j >= l > i)
        for j in range(i + 1, G):
            for l in range(i + 1, j + 1):
                if work[j][l].shape[-2] and work[j][l].shape[-1] and si:
                    work[j][l] = work[j][l] - signs[i] * torch.matmul(
                        _t(Ts[j]), Ts[l])
    sizes = [blocks[i][i].shape[-1] for i in range(G)]
    return (Ld, Lt, tuple(signs), tuple(sizes))


def blockg_solve(factors, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b with factors from :func:`blockg_factor`; b
    (batch, sum s_i) packed in group order."""
    Ld, Lt, signs, sizes = factors
    G = len(signs)
    offs = [sum(sizes[:i]) for i in range(G)]
    parts = [b[:, offs[i]:offs[i] + sizes[i]] for i in range(G)]

    # forward: Lt y = b
    y = [None] * G
    for i in range(G):
        if sizes[i] == 0:
            y[i] = parts[i]
            continue
        rhs = parts[i]
        for k in range(i):
            if sizes[k]:
                rhs = rhs - _mv(Lt[i][k], y[k])
        y[i] = _tri(Ld[i], rhs, upper=False)
    # scale: z = Sigma y
    z = [signs[i] * y[i] for i in range(G)]
    # backward: Lt^T x = z
    x = [None] * G
    for i in reversed(range(G)):
        if sizes[i] == 0:
            x[i] = z[i]
            continue
        rhs = z[i]
        for k in range(i + 1, G):
            if sizes[k]:
                rhs = rhs - _mv(_t(Lt[k][i]), x[k])
        x[i] = _tri(_t(Ld[i]), rhs, upper=True)
    return torch.cat(x, dim=-1) if x else b


def blockg_matvec(blocks, x_parts):
    """K x for the same block structure (iterative refinement)."""
    G = len(blocks)
    out = []
    for i in range(G):
        acc = None
        for j in range(G):
            cell = blocks[i][j] if j <= i else _t(blocks[j][i])
            if cell.shape[-2] == 0 or cell.shape[-1] == 0:
                continue
            t = _mv(cell, x_parts[j])
            acc = t if acc is None else acc + t
        out.append(acc if acc is not None else x_parts[0].new_zeros(
            x_parts[0].shape[:-1] + (blocks[i][i].shape[-1],)))
    return out
