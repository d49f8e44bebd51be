"""Batched evaluation of symbolic expressions into torch operations.

Counterpart of :mod:`ipmzoo_tpu.models.codegen`: the same value model and
the same promotion rules, written over an explicit leading batch axis of
size ``B`` instead of under ``vmap``.  The expression DAG is walked once
per evaluation (eagerly), emitting one batched torch operation per node.

Value model (one more axis than the reference's per-instance values):

  ``scalar``  (B,) tensor, or a Python float for a literal number
  ``vector``  (B, k)
  ``diag``    (B, k) representing a batch of diagonal matrices
  ``matrix``  (B, r, c)
  ``rowvec``  (B, k) representing a transposed vector

Literal numbers stay Python floats so that, like the reference's weakly
typed literals, they never promote the working dtype.  Every other value
carries the batch axis; constants are bound as ``expand``-ed views.

Shape conventions: empty ``(B, 0)`` operands broadcast as zeros in
additions, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Union

import torch

from ..symbolic.expr import Expr, Kind

Value = Union[torch.Tensor, float]


@dataclasses.dataclass(frozen=True)
class TV:
    """A tagged batched value."""
    tag: str          # 'scalar' | 'vector' | 'diag' | 'matrix' | 'rowvec'
    val: Value

    @property
    def is_vec_like(self) -> bool:
        return self.tag in ("vector", "diag", "rowvec")


def scalar(x) -> TV:
    return TV("scalar", x)


def vector(x) -> TV:
    return TV("vector", x)


def diag(x) -> TV:
    return TV("diag", x)


def matrix(x) -> TV:
    return TV("matrix", x)


Env = Dict[Expr, TV]


def _lift(s: Value, like: torch.Tensor) -> Value:
    """Reshape a batched scalar ``(B,)`` to broadcast against ``like``
    (``(B, ...)``); literal floats broadcast as they are."""
    if isinstance(s, torch.Tensor):
        return s.reshape(s.shape + (1,) * (like.dim() - s.dim()))
    return s


def _safe_reciprocal(x: Value) -> Value:
    """Elementwise 1/x with 0 mapped to sqrt(dtype max), as the
    reference (a finite stand-in for an eliminated-diagonal inverse)."""
    if not isinstance(x, torch.Tensor):
        return math.sqrt(torch.finfo(torch.float64).max) if x == 0 \
            else 1.0 / x
    big = math.sqrt(torch.finfo(x.dtype).max)
    zero = x == 0
    return torch.where(zero, torch.full_like(x, big),
                       1.0 / torch.where(zero, torch.ones_like(x), x))


def _unary(x: TV, fn: Callable) -> TV:
    return TV(x.tag, fn(x.val))


def negate_tv(x: TV) -> TV:
    return _unary(x, lambda v: -v)


def invert_tv(x: TV) -> TV:
    """Elementwise inverse for scalar/vector/diag values.  Dense-matrix
    inverses are never inverted elementwise (see the reference)."""
    if x.tag == "matrix":
        raise TypeError("dense-matrix inverse must be pre-bound in the "
                        "environment")
    return _unary(x, _safe_reciprocal)


def _log(v: Value) -> Value:
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _broadcast_zeros(a: torch.Tensor, b: torch.Tensor):
    """If one (B, k) operand is empty, treat it as zeros of the other's
    size."""
    if a.dim() == 2 and b.dim() == 2 and a.shape[-1] != b.shape[-1]:
        if a.shape[-1] == 0:
            a = torch.zeros_like(b)
        elif b.shape[-1] == 0:
            b = torch.zeros_like(a)
    return a, b


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def add_tv(x: TV, y: TV) -> TV:
    """Elementwise addition with the reference's type-promotion rules."""
    if x.tag == "scalar" and y.tag == "scalar":
        return scalar(x.val + y.val)
    if x.tag == "diag" and y.tag == "diag":
        a, b = _broadcast_zeros(x.val, y.val)
        return diag(a + b)
    if x.is_vec_like and y.is_vec_like:
        a, b = _broadcast_zeros(x.val, y.val)
        tag = "rowvec" if (x.tag == "rowvec" or y.tag == "rowvec") \
            else "vector"
        return TV(tag, a + b)
    if x.tag == "matrix" and y.tag == "diag":
        return matrix(x.val + torch.diag_embed(y.val))
    if x.tag == "diag" and y.tag == "matrix":
        return matrix(torch.diag_embed(x.val) + y.val)
    if x.tag == "matrix" and y.tag == "matrix":
        return matrix(x.val + y.val)
    # identity convention of the reference: a scalar adds onto the
    # diagonal of a diag/matrix operand
    if x.tag == "scalar" and y.tag == "diag":
        return diag(y.val + _lift(x.val, y.val))
    if x.tag == "diag" and y.tag == "scalar":
        return diag(x.val + _lift(y.val, x.val))
    if x.tag == "scalar" and y.tag == "matrix":
        n = y.val.shape[-1]
        return matrix(y.val + _lift(x.val, y.val) * _eye(n, y.val))
    if x.tag == "matrix" and y.tag == "scalar":
        return add_tv(y, x)
    raise TypeError(f"cannot add {x.tag} and {y.tag}")


def multiply_tv(x: TV, y: TV) -> TV:
    """Product with the reference's shape-dispatch semantics."""
    xt, yt = x.tag, y.tag
    if xt == "scalar":
        return _unary(y, lambda v: _lift(x.val, v) * v
                      if isinstance(v, torch.Tensor) else x.val * v)
    if yt == "scalar":
        return _unary(x, lambda v: v * _lift(y.val, v)
                      if isinstance(v, torch.Tensor) else v * y.val)
    # any product of two (row)vectors is a dot product, as in the
    # reference
    if xt in ("vector", "rowvec") and yt in ("vector", "rowvec"):
        return scalar((x.val * y.val).sum(-1))
    # elementwise when a diagonal is involved; diag*diag stays diag
    if xt in ("vector", "diag", "rowvec") and \
            yt in ("vector", "diag", "rowvec"):
        if xt == "diag" and yt == "diag":
            return diag(x.val * y.val)
        out_tag = yt if xt == "diag" else xt
        return TV(out_tag, x.val * y.val)
    if xt == "matrix" and yt == "vector":
        return vector(torch.matmul(x.val, y.val.unsqueeze(-1)).squeeze(-1))
    if xt in ("rowvec", "vector") and yt == "matrix":
        # v^T M = (M^T v)^T
        return TV("rowvec",
                  torch.matmul(x.val.unsqueeze(-2), y.val).squeeze(-2))
    if xt == "matrix" and yt == "diag":
        return matrix(x.val * y.val.unsqueeze(-2))
    if xt == "diag" and yt == "matrix":
        return matrix(x.val.unsqueeze(-1) * y.val)
    if xt == "matrix" and yt == "matrix":
        return matrix(torch.matmul(x.val, y.val))
    raise TypeError(f"cannot multiply {xt} and {yt}")


def diagonal_tv(x: TV) -> TV:
    """The diagonal of a square cell value as a ``diag`` (a scalar, which
    stands for a multiple of the identity, stays a scalar): the diagonal
    of a sum is the sum of these, entry by entry the same additions."""
    if x.tag == "matrix":
        return diag(x.val.diagonal(dim1=-2, dim2=-1))
    if x.tag in ("diag", "scalar"):
        return x
    raise TypeError(f"{x.tag} has no diagonal")


def transpose_tv(x: TV) -> TV:
    if x.tag == "matrix":
        return matrix(x.val.transpose(-1, -2))
    if x.tag == "vector":
        return TV("rowvec", x.val)
    if x.tag == "rowvec":
        return vector(x.val)
    return x  # scalars and diagonals are symmetric


def evaluate(e: Expr, env: Env, _memo=None) -> TV:
    """Evaluate ``e`` under the bindings in ``env``.

    ``env`` entries short-circuit evaluation (they double as a memo for
    shorthand residual vectors, as in the reference)."""
    if _memo is None:
        _memo = {}
    hit = env.get(e)
    if hit is not None:
        return hit
    hit = _memo.get(e)
    if hit is not None:
        return hit
    res = _evaluate(e, env, _memo)
    _memo[e] = res
    return res


def _evaluate(e: Expr, env: Env, memo) -> TV:
    k = e.kind
    if k == Kind.NUMBER:
        return scalar(float(e.value))
    if k in (Kind.NAMED_SCALAR, Kind.NAMED_VECTOR, Kind.VARIABLE,
             Kind.MATRIX, Kind.SYMMETRIC_MATRIX):
        raise KeyError(f"symbol {e!r} not bound in environment")
    if k == Kind.DIAGONAL_MATRIX:
        v = evaluate(e.child, env, memo)
        if v.tag not in ("vector", "rowvec"):
            raise TypeError(f"diag of non-vector {v.tag} ({e!r})")
        return diag(v.val)
    if k == Kind.TRANSPOSE:
        return transpose_tv(evaluate(e.child, env, memo))
    if k == Kind.INVERT:
        return invert_tv(evaluate(e.child, env, memo))
    if k == Kind.LOG:
        return _unary(evaluate(e.child, env, memo), _log)
    if k == Kind.NEGATE:
        return negate_tv(evaluate(e.child, env, memo))
    if k == Kind.SUM:
        res = evaluate(e.terms[0], env, memo)
        for t in e.terms[1:]:
            res = add_tv(res, evaluate(t, env, memo))
        return res
    if k == Kind.PRODUCT:
        res = evaluate(e.terms[0], env, memo)
        for t in e.terms[1:]:
            res = multiply_tv(res, evaluate(t, env, memo))
        return res
    raise AssertionError(f"unknown kind {k}")


def _batched(v: TV) -> torch.Tensor:
    if not isinstance(v.val, torch.Tensor):
        raise TypeError("a literal number has no batch axis; bind it "
                        "through the environment")
    return v.val


def as_block(v: TV, rows: int, cols: int) -> torch.Tensor:
    """Materialise a cell value as a dense (B, rows, cols) block for KKT
    assembly.  Scalars broadcast onto the diagonal."""
    val = _batched(v)
    if v.tag == "matrix":
        if tuple(val.shape[-2:]) != (rows, cols):
            raise ValueError(f"block {tuple(val.shape)} is not "
                             f"(B, {rows}, {cols})")
        return val
    if v.tag == "diag":
        if rows != cols or val.shape[-1] != rows:
            raise ValueError(f"diag {tuple(val.shape)} as ({rows},{cols})")
        return torch.diag_embed(val)
    if v.tag == "scalar":
        if rows != cols:
            raise ValueError(f"scalar as ({rows},{cols}) block")
        return val[:, None, None] * _eye(rows, val)
    if v.tag in ("vector", "rowvec"):
        # 1-column / 1-row blocks
        if cols == 1:
            return val.reshape(val.shape[0], rows, 1)
        if rows == 1:
            return val.reshape(val.shape[0], 1, cols)
    raise TypeError(f"cannot materialise {v.tag} as ({rows},{cols}) block")


def as_vector(v: TV, size: int) -> torch.Tensor:
    """Materialise a value as a (B, size) batch of vectors."""
    val = _batched(v)
    if v.tag in ("vector", "rowvec", "diag"):
        if val.shape[-1] == 0 and size > 0:
            return val.new_zeros((val.shape[0], size))
        if val.shape[-1] != size:
            raise ValueError(f"vector {tuple(val.shape)} is not "
                             f"(B, {size})")
        return val
    if v.tag == "scalar" and size == 1:
        return val.reshape(-1, 1)
    raise TypeError(f"cannot materialise {v.tag} as vector of {size}")
