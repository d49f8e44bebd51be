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
``SchurIPM``, ``arrow_qp_from_numpy`` / ``arrow_state_from_numpy`` for the
data and state of ``ArrowIPM``, ``mpc_data_from_numpy`` /
``mpc_data_to_numpy``, ``mpc_state_from_numpy`` and
``mpc_result_to_numpy`` for the data, states and results of
``RiccatiIPM``, ``family_from_reference`` for a whole
``families.Family`` (data and settings).  Tests use them to pass the same data and
state between the reference and the port.  ``device=None`` is the CUDA
device, as for every entry point of the port; the tests pass
``device="cpu"``.

``settings_from_reference`` rebuilds the port's ``Settings`` from the
JAX package's (or any object with the same fields): the two packages'
enums are different classes and never compare equal, so a solver of the
port refuses a foreign ``Settings`` rather than mis-reading it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formulations import (Bounds, EqualityHandling, InequalityHandling,
                            Settings)
from ..utils.device import resolve_device
from .arrow import ArrowQPData, ArrowState
from .data import QPData
from .mpc import MPCData, MPCSolveResult, MPCState
from .state import IPMState, SolveResult

_QP_FIELDS = tuple(f.name for f in dataclasses.fields(QPData))


def _t(a, dtype, device) -> torch.Tensor:
    # copy and cast on the host (numpy's rounding), then move
    return torch.tensor(np.asarray(a)).to(dtype).to(resolve_device(device))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


_SETTINGS_ENUMS = {"inequalities": Bounds, "variable_bounds": Bounds,
                   "equality_handling": EqualityHandling,
                   "inequality_handling": InequalityHandling}


def settings_from_reference(src) -> Settings:
    """The port's :class:`Settings` with the field values of ``src``, an
    object with the same field names whose enum members are matched by
    *name* (duck-typed: the JAX package's ``Settings``, the port's own, or
    a stand-in).  Raises ``AttributeError`` on a missing field and
    ``KeyError`` on an enum member the port does not have."""
    kw = {}
    for f in dataclasses.fields(Settings):
        v = getattr(src, f.name)
        enum_cls = _SETTINGS_ENUMS.get(f.name)
        kw[f.name] = bool(v) if enum_cls is None else enum_cls[v.name]
    return Settings(**kw)


def qpdata_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                      device=None) -> QPData:
    return QPData(**{k: _t(getattr(src, k), dtype, device)
                     for k in _QP_FIELDS})


def qpdata_to_numpy(data: QPData) -> dict:
    return {k: _np(getattr(data, k)) for k in _QP_FIELDS}


def family_from_reference(src, *, dtype: torch.dtype = torch.float64,
                          device=None):
    """The port's ``Family`` from the reference's (or any object with its
    fields): the data through :func:`qpdata_from_numpy`, the settings
    through :func:`settings_from_reference`."""
    from .families import Family
    return Family(src.name, qpdata_from_numpy(src.data, dtype=dtype,
                                              device=device),
                  settings_from_reference(src.settings), src.n, src.m_ineq,
                  src.m_eq)


def state_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                     device=None) -> IPMState:
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
                      device=None) -> SolveResult:
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
                     device=None) -> dict:
    """A fused-engine result or warm state (the reference's dict, or any
    subset of its keys) as tensors; ``converged`` stays boolean."""
    return {k: _t(v, torch.bool if k == "converged" else dtype, device)
            for k, v in src.items()}


def fused_to_numpy(out: dict) -> dict:
    return {k: _np(v) for k, v in out.items()}


def block_qp_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                        device=None):
    """The port's ``BlockQPData`` from any object with its fields (the
    reference's ``BlockQPData`` included), with or without the instance
    axis."""
    from ..parallel.schur import BlockQPData
    return BlockQPData(**{f.name: _t(getattr(src, f.name), dtype, device)
                          for f in dataclasses.fields(BlockQPData)})


def arrow_qp_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                        device=None) -> ArrowQPData:
    """The port's ``ArrowQPData`` from any object with its fields (the
    reference's ``ArrowQPData`` included), with or without the batch
    axis."""
    return ArrowQPData(**{f.name: _t(getattr(src, f.name), dtype, device)
                          for f in dataclasses.fields(ArrowQPData)})


def arrow_state_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                           device=None) -> ArrowState:
    """The port's ``ArrowState`` from the reference's (or any object with
    its fields); ``iteration`` stays int32."""
    return ArrowState(
        vars=tuple(_t(v, dtype, device) for v in src.vars),
        mu=_t(src.mu, dtype, device),
        iteration=_t(src.iteration, torch.int32, device),
        residual=_t(src.residual, dtype, device),
        gap=_t(src.gap, dtype, device),
        rx=_t(src.rx, dtype, device))


def mpc_data_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                        device=None) -> MPCData:
    """The port's ``MPCData`` from any object with its fields (the
    reference's ``MPCData`` included), with or without the batch axis."""
    return MPCData(**{f.name: _t(getattr(src, f.name), dtype, device)
                      for f in dataclasses.fields(MPCData)})


def mpc_data_to_numpy(data: MPCData) -> dict:
    return {f.name: _np(getattr(data, f.name))
            for f in dataclasses.fields(MPCData)}


def mpc_state_from_numpy(src, *, dtype: torch.dtype = torch.float64,
                         device=None) -> MPCState:
    """The port's ``MPCState`` from the reference's (or any object with
    its fields); ``iteration`` stays int32."""
    return MPCState(
        vars=tuple(_t(v, dtype, device) for v in src.vars),
        mu=_t(src.mu, dtype, device),
        iteration=_t(src.iteration, torch.int32, device),
        residual=_t(src.residual, dtype, device),
        gap=_t(src.gap, dtype, device),
        res=tuple(_t(v, dtype, device) for v in src.res))


def mpc_result_to_numpy(res: MPCSolveResult) -> dict:
    out = {f.name: _np(getattr(res, f.name))
           for f in dataclasses.fields(MPCSolveResult)
           if f.name != "variables"}
    out["variables"] = {k: _np(v) for k, v in res.variables.items()}
    return out


def make_batch(batch: int, n: int, m: int, dtype: torch.dtype,
               device=None, seed: int = 0) -> QPData:
    """The benchmark workload: ``batch`` random strictly convex QPs with
    ``m`` two-sided inequalities and the box -5 <= x <= 5.

    Byte-identical to the reference benchmark's ``make_batch`` for
    ``seed=0`` (same generator, same call order, ``M`` cast to float32
    before the product)."""
    device = resolve_device(device)
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
