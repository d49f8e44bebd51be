"""Conversions between the port's containers and numpy arrays, and the
benchmark workload.

The ``*_from_numpy`` functions take any object with the fields of the
corresponding container (the reference's ``QPData``, ``IPMState`` or
``SolveResult`` included) and read each field through ``np.asarray``; the
``*_to_numpy`` functions return plain dicts of numpy arrays.  The fused
engine's results and warm states are dicts already (``x``,
``variables``, ``iterations``, ``residual``, ``gap``, ``mu``,
``converged``) and cross with ``fused_from_numpy`` / ``fused_to_numpy``.
``block_qp_from_numpy`` does the same for the coupled-QP data of
``SchurIPM``.  Tests use them to pass the same data and state between
the reference and the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .data import QPData
from .state import IPMState, SolveResult

_QP_FIELDS = tuple(f.name for f in dataclasses.fields(QPData))


def _t(a, dtype, device) -> torch.Tensor:
    # copy and cast on the host (numpy's rounding), then move
    return torch.tensor(np.asarray(a)).to(dtype).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def qpdata_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                      device="cpu") -> QPData:
    return QPData(**{k: _t(getattr(src, k), dtype, device)
                     for k in _QP_FIELDS})


def qpdata_to_numpy(data: QPData) -> dict:
    return {k: _np(getattr(data, k)) for k in _QP_FIELDS}


def state_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                     device="cpu") -> IPMState:
    return IPMState(
        vars=tuple(_t(v, dtype, device) for v in src.vars),
        mu=_t(src.mu, dtype, device),
        iteration=_t(src.iteration, torch.int32, device),
        residual=_t(src.residual, dtype, device),
        gap=_t(src.gap, dtype, device))


def state_to_numpy(state: IPMState) -> dict:
    return {"vars": tuple(_np(v) for v in state.vars),
            "mu": _np(state.mu), "iteration": _np(state.iteration),
            "residual": _np(state.residual), "gap": _np(state.gap)}


def result_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                      device="cpu") -> SolveResult:
    return SolveResult(
        x=_t(src.x, dtype, device),
        variables={k: _t(v, dtype, device)
                   for k, v in src.variables.items()},
        objective=_t(src.objective, dtype, device),
        iterations=_t(src.iterations, torch.int32, device),
        residual=_t(src.residual, dtype, device),
        gap=_t(src.gap, dtype, device),
        converged=_t(src.converged, torch.bool, device),
        diverged=_t(src.diverged, torch.bool, device))


def result_to_numpy(res: SolveResult) -> dict:
    out = {f.name: getattr(res, f.name)
           for f in dataclasses.fields(SolveResult) if f.name != "variables"}
    out = {k: _np(v) for k, v in out.items()}
    out["variables"] = {k: _np(v) for k, v in res.variables.items()}
    return out


def fused_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                     device="cpu") -> dict:
    """A fused-engine result or warm state (the reference's dict, or any
    subset of its keys) as tensors; ``converged`` stays boolean."""
    return {k: _t(v, torch.bool if k == "converged" else dtype, device)
            for k, v in src.items()}


def fused_to_numpy(out: dict) -> dict:
    return {k: _np(v) for k, v in out.items()}


def block_qp_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                        device="cpu"):
    """The port's ``BlockQPData`` from any object with its fields (the
    reference's ``BlockQPData`` included), with or without the instance
    axis."""
    from ..parallel.schur import BlockQPData
    return BlockQPData(**{f.name: _t(getattr(src, f.name), dtype, device)
                          for f in dataclasses.fields(BlockQPData)})


def make_batch(batch: int, n: int, m: int, dtype: torch.dtype,
               device="cpu", seed: int = 0) -> QPData:
    """The benchmark workload: ``batch`` random strictly convex QPs with
    ``m`` two-sided inequalities and the box -5 <= x <= 5.

    Byte-identical to the reference benchmark's ``make_batch`` for
    ``seed=0`` (same generator, same call order, ``M`` cast to float32
    before the product)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n, dtype=np.float32)
    c = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m, n))
    lA = -np.abs(rng.normal(size=(batch, m))) - 1
    uA = np.abs(rng.normal(size=(batch, m))) + 1
    return QPData(
        Q=_t(Q, dtype, device), c=_t(c, dtype, device),
        A_ineq=_t(A, dtype, device),
        l_A_ineq=_t(lA, dtype, device), u_A_ineq=_t(uA, dtype, device),
        A_eq=torch.zeros((batch, 0, n), dtype=dtype, device=device),
        b_eq=torch.zeros((batch, 0), dtype=dtype, device=device),
        l_x=torch.full((batch, n), -5.0, dtype=dtype, device=device),
        u_x=torch.full((batch, n), 5.0, dtype=dtype, device=device))
