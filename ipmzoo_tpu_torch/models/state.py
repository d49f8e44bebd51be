"""State and result containers of the batched solver, plus ``tree_map``
over them (counterpart of :mod:`ipmzoo_tpu.models.state`), and the
per-instance helpers every batched engine shares: the batch axis added
to one instance and stripped again, the select of frozen instances, the
fraction-to-boundary ratio test and the test of a failed iterate."""

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


def with_batch_axis(x, one: bool):
    """``x`` with a leading batch axis of one on every tensor where
    ``one`` (``x`` is one instance), else ``x`` as it is."""
    return tree_map(lambda t: t.unsqueeze(0), x) if one else x


def without_batch_axis(x, one: bool):
    """The inverse of :func:`with_batch_axis`: the leading axis of every
    tensor stripped where ``one``."""
    return tree_map(lambda t: t[0], x) if one else x


def where_instances(mask, old, new):
    """Per-instance select over a state: ``old`` where ``mask`` (B,) else
    ``new``."""
    return tree_map(lambda o, n_: torch.where(
        mask.reshape(mask.shape + (1,) * (n_.dim() - 1)), o, n_), old, new)


def step_ratio(alpha, v, dv):
    """Fraction-to-boundary, per instance: min(alpha, min over the entries
    with dv < 0 of -v / dv); every axis after the first is reduced."""
    neg = dv < 0
    r = torch.where(neg, -v / torch.where(neg, dv, -1.0), float("inf"))
    return torch.minimum(alpha, r.flatten(1).amin(dim=-1))


def bad_iterate(s, *, masked: bool = False) -> torch.Tensor:
    """Per instance, whether the iterate ``s`` (with ``residual`` and
    ``gap``) failed: residual NaN or inf, or gap NaN, as the reference's
    while loops test it (CompiledIPM, ArrowIPM, RiccatiIPM); ``masked``
    also fails an infinite gap, as its masked compact loops do."""
    bad = torch.isnan(s.residual) | torch.isinf(s.residual) | \
        torch.isnan(s.gap)
    return bad | torch.isinf(s.gap) if masked else bad
