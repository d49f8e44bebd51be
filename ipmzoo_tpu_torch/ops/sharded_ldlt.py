"""Panel-sharded LDL^T of one large KKT system over a mesh axis.

Counterpart of :mod:`ipmzoo_tpu.ops.sharded_ldlt` (the tp axis): a
single quasi-definite KKT matrix is stored row-sharded over the ranks
of one mesh axis, each rank holding a contiguous block of n / ranks
rows, and factored cooperatively.  Per panel stage j (width p):

1. the rank owning rows [j, j+p) broadcasts them (their columns from j
   on) within the axis (:func:`..parallel.mesh.broadcast`), so every
   rank holds the owner's bits;
2. every rank factors the p x p diagonal block with
   :func:`.cuda_ldlt.ldlt_k2` (kernel K2 on CUDA tensors, the plain
   column LDL^T on CPU tensors; a failed launch raises) and forms the
   panel row block T = L_jj^-1 A[j:j+p, j+p:] with one library
   triangular solve;
3. every rank updates only its own rows of the trailing matrix with one
   product, A_loc -= L21_loc T.

The factor L comes back row-sharded like A; D and the per-panel
diagonal factors are replicated.  The solve walks the panels: in the
forward sweep the owner solves its panel rows and broadcasts them, in
the backward sweep a ``psum`` adds every rank's partial products.  Every
function takes leading batch axes, so one collective and one K2 launch
serve a batch of systems at each stage.

The rank's row offset is a Python integer (the process knows its rank);
the reference's ``psum`` of the owner's rows with zeros from the other
ranks gives the same bits as the broadcast, which moves half the bytes.
In exact arithmetic this is :func:`.blocked_ldlt.ldlt_blocked`'s factor
at the same panel: the same elimination order and pivot floor.
"""

from __future__ import annotations

import torch

from ..parallel import mesh as mesh_ops
from . import cuda_ldlt
from .ldlt import PIVOT_FLOOR


def _plan(n: int, mesh, axis: str, panel):
    """(rows per rank, panel); raises as the reference where n does not
    divide over the ranks or the panel not over a rank's rows."""
    ranks = mesh.shape[axis]
    if n % ranks:
        raise ValueError(f"n={n} must divide over {ranks} devices")
    rpd = n // ranks
    if panel is None:
        panel = min(128, rpd)
    if rpd % panel:
        raise ValueError(f"panel={panel} must divide rows/device={rpd}")
    return rpd, panel


def shard_kkt(A: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """This rank's contiguous row block of A (..., n, n), shape (...,
    n / ranks, n), on its device of the mesh (the counterpart of placing
    A row-sharded over the axis)."""
    sl = mesh_ops.shard_slice(A.shape[-2], mesh, axis)
    return A[..., sl, :].to(mesh.device, copy=True)


def sharded_ldlt(A_loc: torch.Tensor, mesh, axis: str = "tp",
                 panel: int | None = None,
                 pivot_floor: float = PIVOT_FLOOR):
    """Factor a row-sharded symmetric quasi-definite A = L D L^T.

    ``A_loc`` is this rank's row block (..., n / ranks, n), as
    :func:`shard_kkt` gives it.  Returns (L_loc, Lds, D): this rank's rows
    of the unit-lower L, the tuple of per-panel diagonal factors (...,
    p, p) and D (..., n), the last two the same on every rank."""
    n, rows = A_loc.shape[-1], A_loc.shape[-2]
    rpd, panel = _plan(n, mesh, axis, panel)
    if rows != rpd:
        raise ValueError(f"a rank's block has {rows} rows, expected "
                         f"{rpd} of n={n}")
    batch = A_loc.shape[:-2]
    off = mesh.axis_index(axis) * rpd
    A = A_loc.reshape(-1, rpd, n).clone()
    B, p = A.shape[0], panel
    L = torch.zeros_like(A)
    Lds, Ds = [], []
    for j in range(0, n, p):
        owner, jr = divmod(j, rpd)
        mine = off == owner * rpd
        rows_j = A[:, jr:jr + p, j:] if mine else \
            A.new_empty((B, p, n - j))
        rows_j = mesh_ops.broadcast(rows_j.contiguous(), mesh, axis, owner)
        Ljj, Dj = cuda_ldlt.ldlt_k2(rows_j[:, :, :p].contiguous(),
                                    pivot_floor)
        Lds.append(Ljj.reshape(batch + (p, p)))
        Ds.append(Dj)
        if mine:
            L[:, jr:jr + p, j:j + p] = Ljj
        lo = max(j + p, off)          # this rank's first row past the panel
        if lo >= off + rpd:
            continue
        # the columns of T for this rank's rows are the transposed rows
        # of L21; A21 = L21 D1 L11^T  =>  L21^T = D1^-1 L11^-1 A21^T
        T = torch.linalg.solve_triangular(Ljj, rows_j[:, :, p:],
                                          upper=False, unitriangular=True)
        L21 = (T[:, :, lo - j - p:off + rpd - j - p] /
               Dj[:, :, None]).transpose(-1, -2)
        L[:, lo - off:, j:j + p] = L21
        A[:, lo - off:, j + p:] -= torch.matmul(L21, T)
    return (L.reshape(A_loc.shape), tuple(Lds),
            torch.cat(Ds, -1).reshape(batch + (n,)))


def sharded_ldlt_solve(factors, b: torch.Tensor, mesh, axis: str = "tp",
                       panel: int | None = None) -> torch.Tensor:
    """Solve K x = b from :func:`sharded_ldlt`'s factors: b (..., n) the
    same on every rank, x (..., n) the same bits on every rank.  The
    panel is the factors' own (``panel`` is checked against the mesh as
    the reference does, then replaced by it)."""
    L_loc, Lds, D = factors
    n = L_loc.shape[-1]
    _plan(n, mesh, axis, panel)
    rpd, panel = _plan(n, mesh, axis, Lds[0].shape[-1])
    batch = b.shape[:-1]
    off = mesh.axis_index(axis) * rpd
    L = L_loc.reshape(-1, rpd, n)
    Ld = [t.reshape(-1, panel, panel) for t in Lds]
    b = b.reshape(-1, n)
    stages = list(range(0, n, panel))
    # forward: L y = b, the owner solves its panel rows and broadcasts
    y = torch.zeros_like(b)
    for i, j in enumerate(stages):
        owner, jr = divmod(j, rpd)
        if off == owner * rpd:
            rhs = b[:, j:j + panel, None] - torch.matmul(
                L[:, jr:jr + panel, :j], y[:, :j, None])
            yj = torch.linalg.solve_triangular(
                Ld[i], rhs, upper=False, unitriangular=True)[..., 0]
        else:
            yj = b.new_empty((b.shape[0], panel))
        y[:, j:j + panel] = mesh_ops.broadcast(yj.contiguous(), mesh, axis,
                                               owner)
    z = y / D.reshape(-1, n)
    # backward: L^T x = z, every rank adds its rows' partial products
    x = torch.zeros_like(b)
    for i, j in reversed(list(enumerate(stages))):
        part = torch.matmul(L[:, :, j:j + panel].transpose(-1, -2),
                            x[:, off:off + rpd, None])
        contrib = mesh_ops.psum(part, mesh, axis)
        x[:, j:j + panel] = torch.linalg.solve_triangular(
            Ld[i].transpose(-1, -2), z[:, j:j + panel, None] - contrib,
            upper=True, unitriangular=True)[..., 0]
    return x.reshape(batch + (n,))
