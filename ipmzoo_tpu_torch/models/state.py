"""State and result containers of the batched solver, plus ``tree_map``
over them (counterpart of :mod:`ipmzoo_tpu.models.state`)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor            # (B, n)
    variables: dict            # name -> (B, size) for every KKT variable
    objective: torch.Tensor    # (B,)
    iterations: torch.Tensor   # (B,) int32
    residual: torch.Tensor     # (B,)
    gap: torch.Tensor          # (B,)
    converged: torch.Tensor    # (B,) bool
    diverged: torch.Tensor     # (B,) bool: NaN/inf detected


@dataclasses.dataclass
class IPMState:
    """Carry of the iteration loop; every field has a leading batch
    axis."""
    vars: tuple                # per-variable (B, size), in system order
    mu: torch.Tensor           # (B,)
    iteration: torch.Tensor    # (B,) int32
    residual: torch.Tensor     # (B,)
    gap: torch.Tensor          # (B,)


def tree_map(fn, x, *rest):
    """Apply ``fn`` leafwise over tensors nested in tuples, dicts and
    dataclasses (``QPData``, ``IPMState``, ``SolveResult``); ``rest``
    must have the same structure as ``x``."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    if isinstance(x, tuple):
        return tuple(tree_map(fn, a, *(r[i] for r in rest))
                     for i, a in enumerate(x))
    if isinstance(x, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return type(x)(**{
            f.name: tree_map(fn, getattr(x, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(x)})
    raise TypeError(f"tree_map: unsupported node {type(x).__name__}")
