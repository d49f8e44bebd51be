"""Structure-of-arrays evaluation of symbolic expressions, with two
emitters.

Counterpart of :mod:`ipmzoo_tpu.models.codegen_soa`, the evaluation
semantics of the reference's fused whole-solve kernel (K1).  One walk
over an expression DAG (:func:`evaluate`, memoised per call site) and one
tag algebra (:func:`add_tv`, :func:`multiply_tv`, ...) drive either of
two emitters:

* :class:`TorchSoA` evaluates on batched tensors with the batch on the
  trailing axis.  It is the plain version of K1's generated part.
* :class:`CppSoA` prints the same operations as straight-line C++ for
  one instance, with every size a compile-time constant.  Vector results
  become named local arrays (the memo makes them common subexpressions);
  a ``matrix`` value stays an element formula over the data in global
  memory, because a matrix is only ever data (``Q``, ``A``, transposes)
  scaled by a scalar or a diagonal and summed with a diagonal: there is
  no matrix-by-matrix product in this algebra.

Value model (torch shapes; C++ handles carry the same sizes):

  ``scalar``  (1, B)      ``vector``  (k, B)      ``diag``  (k, B)
  ``rowvec``  (k, B)      ``matrix``  (k, l, B)

The SoA semantics differ from :mod:`.codegen`'s, and both emitters keep
the differences:

* the safe reciprocal maps 0 to sqrt(float32 max) in every dtype;
* a literal number is rounded to float32 before it meets the working
  dtype (literal-with-literal arithmetic stays in float32);
* any (row)vector-by-(row)vector product is a dot product;
* an empty operand of an addition broadcasts as zeros;
* ``as_vector`` of an empty value yields zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..symbolic.expr import Expr, Kind

#: what the safe reciprocal returns for 0, in every working dtype
BIG = float(np.sqrt(np.finfo(np.float32).max))

_VECLIKE = ("vector", "diag", "rowvec")


@dataclasses.dataclass(frozen=True)
class TV:
    tag: str      # 'scalar' | 'vector' | 'diag' | 'matrix' | 'rowvec'
    val: object   # emitter value: a tensor, or a C++ handle


def scalar(x) -> TV:
    return TV("scalar", x)


def vector(x) -> TV:
    return TV("vector", x)


def diag(x) -> TV:
    return TV("diag", x)


def matrix(x) -> TV:
    return TV("matrix", x)


Env = Dict[Expr, TV]


# ---------------------------------------------------------------------------
# the tag algebra, shared by both emitters
# ---------------------------------------------------------------------------

def negate_tv(ev, x: TV) -> TV:
    return TV(x.tag, ev.neg(x.val))


def invert_tv(ev, x: TV) -> TV:
    if x.tag == "matrix":
        raise TypeError("a dense matrix is never inverted elementwise")
    return TV(x.tag, ev.recip(x.val))


def _bz(ev, a, b):
    """Empty-operand broadcast of two vector-like values."""
    na, nb = ev.size(a), ev.size(b)
    if na != nb:
        if na == 0:
            a = ev.zeros_like(b)
        elif nb == 0:
            b = ev.zeros_like(a)
    return a, b


def add_tv(ev, x: TV, y: TV) -> TV:
    xt, yt = x.tag, y.tag
    if xt == "scalar" and yt == "scalar":
        return scalar(ev.add(x.val, y.val))
    if xt == "diag" and yt == "diag":
        return diag(ev.add(*_bz(ev, x.val, y.val)))
    if xt in _VECLIKE and yt in _VECLIKE:
        tag = "rowvec" if "rowvec" in (xt, yt) else "vector"
        return TV(tag, ev.add(*_bz(ev, x.val, y.val)))
    if xt == "matrix" and yt in ("diag", "scalar"):
        return matrix(ev.mat_add_diag(x.val, y.val))
    if xt in ("diag", "scalar") and yt == "matrix":
        return matrix(ev.mat_add_diag(y.val, x.val))
    if xt == "matrix" and yt == "matrix":
        return matrix(ev.mat_add(x.val, y.val))
    # identity convention: a scalar in an additive diagonal context is
    # scalar * I
    if xt == "scalar" and yt == "diag":
        return diag(ev.add(y.val, x.val))
    if xt == "diag" and yt == "scalar":
        return diag(ev.add(x.val, y.val))
    raise TypeError(f"cannot add {xt} and {yt}")


def multiply_tv(ev, x: TV, y: TV) -> TV:
    xt, yt = x.tag, y.tag
    if xt == "scalar":
        if yt == "matrix":
            return matrix(ev.mat_scale(y.val, x.val))
        return TV(yt, ev.mul(x.val, y.val))
    if yt == "scalar":
        if xt == "matrix":
            return matrix(ev.mat_scale(x.val, y.val))
        return TV(xt, ev.mul(y.val, x.val))
    # any (row)vector pair is a dot product
    if xt in ("vector", "rowvec") and yt in ("vector", "rowvec"):
        return scalar(ev.dot(x.val, y.val))
    if xt in _VECLIKE and yt in _VECLIKE:
        if xt == "diag" and yt == "diag":
            return diag(ev.mul(x.val, y.val))
        return TV(yt if xt == "diag" else xt, ev.mul(x.val, y.val))
    if xt == "matrix" and yt == "vector":
        return vector(ev.matvec(x.val, y.val))
    if xt in ("rowvec", "vector") and yt == "matrix":
        return TV("rowvec", ev.vecmat(x.val, y.val))
    if xt == "matrix" and yt == "diag":
        return matrix(ev.mat_scale_cols(x.val, y.val))
    if xt == "diag" and yt == "matrix":
        return matrix(ev.mat_scale_rows(x.val, y.val))
    raise TypeError(f"cannot multiply {xt} and {yt}")


def transpose_tv(ev, x: TV) -> TV:
    if x.tag == "matrix":
        return matrix(ev.mat_t(x.val))
    if x.tag == "vector":
        return TV("rowvec", x.val)
    if x.tag == "rowvec":
        return vector(x.val)
    return x


def evaluate(ev, e: Expr, env: Env, memo: Optional[dict] = None) -> TV:
    """Evaluate ``e`` with emitter ``ev`` under the bindings of ``env``
    (which short-circuit the walk); ``memo`` holds the values of the
    subexpressions already emitted."""
    if memo is None:
        memo = {}
    hit = env.get(e)
    if hit is not None:
        return hit
    hit = memo.get(e)
    if hit is not None:
        return hit
    res = _evaluate(ev, e, env, memo)
    memo[e] = res
    return res


def _evaluate(ev, e: Expr, env: Env, memo) -> TV:
    k = e.kind
    if k == Kind.NUMBER:
        return scalar(ev.number(e.value))
    if k in (Kind.NAMED_SCALAR, Kind.NAMED_VECTOR, Kind.VARIABLE,
             Kind.MATRIX, Kind.SYMMETRIC_MATRIX):
        raise KeyError(f"symbol {e!r} not bound in environment")
    if k == Kind.DIAGONAL_MATRIX:
        v = evaluate(ev, e.child, env, memo)
        if v.tag not in ("vector", "rowvec"):
            raise TypeError(f"diag of non-vector {v.tag} ({e!r})")
        return diag(v.val)
    if k == Kind.TRANSPOSE:
        return transpose_tv(ev, evaluate(ev, e.child, env, memo))
    if k == Kind.INVERT:
        return invert_tv(ev, evaluate(ev, e.child, env, memo))
    if k == Kind.LOG:
        v = evaluate(ev, e.child, env, memo)
        return TV(v.tag, ev.log(v.val))
    if k == Kind.NEGATE:
        return negate_tv(ev, evaluate(ev, e.child, env, memo))
    if k == Kind.SUM:
        res = evaluate(ev, e.terms[0], env, memo)
        for t in e.terms[1:]:
            res = add_tv(ev, res, evaluate(ev, t, env, memo))
        return res
    if k == Kind.PRODUCT:
        res = evaluate(ev, e.terms[0], env, memo)
        for t in e.terms[1:]:
            res = multiply_tv(ev, res, evaluate(ev, t, env, memo))
        return res
    raise AssertionError(f"unknown kind {k}")


def as_vector(ev, v: TV, size: int):
    """The value as a vector of ``size`` entries: empty values become
    zeros, a scalar becomes a one-entry vector."""
    if v.tag in _VECLIKE:
        if ev.size(v.val) == 0 and size > 0:
            return ev.zeros(size)
        return v.val
    if v.tag == "scalar" and size == 1:
        return ev.scalar_as_vector(v.val)
    raise TypeError(f"cannot view {v.tag} as vector({size})")


# ---------------------------------------------------------------------------
# emitter (a): batched torch tensors, batch on the trailing axis
# ---------------------------------------------------------------------------

class TorchSoA:
    """Evaluates on tensors of shape (k, B) / (k, l, B); scalars are
    (1, B), literals and constants (1, 1) or (k, 1) and broadcast."""

    def __init__(self, dtype: torch.dtype, device, batch: int):
        self.dtype, self.device, self.batch = dtype, device, batch

    def number(self, value: float) -> torch.Tensor:
        return torch.full((1, 1), value, dtype=torch.float32,
                          device=self.device)

    @staticmethod
    def size(a: torch.Tensor) -> int:
        return a.shape[0]

    @staticmethod
    def zeros_like(a: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(a)

    def zeros(self, size: int) -> torch.Tensor:
        return torch.zeros((size, self.batch), dtype=self.dtype,
                           device=self.device)

    def scalar_as_vector(self, s: torch.Tensor) -> torch.Tensor:
        return s.expand(1, self.batch).to(self.dtype)

    @staticmethod
    def neg(a):
        return -a

    @staticmethod
    def recip(x):
        zero = x == 0
        return torch.where(zero, torch.full_like(x, BIG),
                           1.0 / torch.where(zero, torch.ones_like(x), x))

    @staticmethod
    def log(a):
        return torch.log(a)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def dot(a, b):
        return torch.sum(a * b, dim=0, keepdim=True)

    @staticmethod
    def mat_add_diag(m, d):
        eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
        return m + eye[:, :, None] * d[:, None, :]

    @staticmethod
    def mat_add(a, b):
        return a + b

    @staticmethod
    def mat_scale(m, s):
        return s[:, None, :] * m

    @staticmethod
    def mat_scale_cols(m, d):
        return m * d[None, :, :]

    @staticmethod
    def mat_scale_rows(d, m):
        return d[:, None, :] * m

    @staticmethod
    def matvec(m, v):
        return torch.sum(m * v[None, :, :], dim=1)

    @staticmethod
    def vecmat(v, m):
        return torch.sum(m * v[:, None, :], dim=0)

    @staticmethod
    def mat_t(m):
        return m.transpose(0, 1)

    # -- reductions of the metrics and the Gondzio targets ---------------

    def zero_scalar(self) -> torch.Tensor:
        return torch.zeros((1, self.batch), dtype=self.dtype,
                           device=self.device)

    @staticmethod
    def sum_sq(v):
        return torch.sum(v * v, dim=0, keepdim=True)

    @staticmethod
    def sum_abs(v):
        return torch.sum(torch.abs(v), dim=0, keepdim=True)

    @staticmethod
    def sqrt(s):
        return torch.sqrt(s)

    @staticmethod
    def div_const(s, c: int):
        return s / c

    @staticmethod
    def minus_clip(p, mu, beta_min: float, beta_max: float):
        """p - clip(p, beta_min mu, beta_max mu)."""
        return p - torch.clamp(p, beta_min * mu, beta_max * mu)


# ---------------------------------------------------------------------------
# emitter (b): C++ source for one instance
# ---------------------------------------------------------------------------

def cpp_literal(value: float) -> str:
    """A C++ literal of the working type ``T`` holding the finite
    ``value`` (``repr`` round-trips a double exactly)."""
    return f"T({float(value)!r})"


@dataclasses.dataclass(frozen=True)
class CScalar:
    """A per-instance scalar: a C++ expression of type ``T``.  Literal
    numbers keep their float32 value so that literal-with-literal
    arithmetic folds in float32, as the reference computes it."""
    expr: str
    literal: Optional[np.float32] = None


@dataclasses.dataclass(frozen=True)
class CVec:
    """A vector-like value of ``size`` entries; ``at(i)`` is the C++
    expression of entry ``i`` (an index expression)."""
    size: int
    at: Callable[[str], str]


@dataclasses.dataclass(frozen=True)
class CMat:
    """A lazy matrix: ``at(i, j)`` is the C++ expression of its entry,
    read from the data and the vectors it was built from."""
    rows: int
    cols: int
    at: Callable[[str, str], str]


def _lit(value) -> CScalar:
    v = np.float32(value)
    return CScalar(cpp_literal(float(v)), v)


class CppSoA:
    """Emits C++ statements into ``lines``; values are :class:`CScalar`,
    :class:`CVec` and :class:`CMat` handles.  Every vector operation is
    written once into a named local array, so a memoised subexpression
    is computed once."""

    def __init__(self, prefix: str = "t"):
        self.lines: List[str] = []
        self._prefix = prefix
        self._count = 0

    def _name(self) -> str:
        self._count += 1
        return f"{self._prefix}{self._count}"

    # -- materialisation -------------------------------------------------

    def scalar_tmp(self, expr: str) -> CScalar:
        name = self._name()
        self.lines.append(f"const T {name} = {expr};")
        return CScalar(name)

    def vec_tmp(self, size: int, elem: Callable[[str], str]) -> CVec:
        if size == 0:
            return CVec(0, _no_entry)
        name = self._name()
        self.lines.append(f"T {name}[{size}];")
        self.lines.append(f"for (int i = 0; i < {size}; ++i) "
                          f"{name}[i] = {elem('i')};")
        return array_vec(name, size)

    def _reduce(self, n: int, term: Callable[[str], str]) -> str:
        """Declare an accumulator holding sum_{k<n} term(k); returns its
        name."""
        name = self._name()
        self.lines.append(f"T {name} = T(0);")
        if n:
            self.lines.append(f"for (int k = 0; k < {n}; ++k) "
                              f"{name} += {term('k')};")
        return name

    # -- emitter interface ---------------------------------------------

    @staticmethod
    def number(value: float) -> CScalar:
        return _lit(value)

    @staticmethod
    def size(a) -> int:
        return a.size if isinstance(a, CVec) else 1

    def zeros_like(self, a: CVec) -> CVec:
        return zeros_vec(a.size)

    def zeros(self, size: int) -> CVec:
        return zeros_vec(size)

    @staticmethod
    def scalar_as_vector(s: CScalar) -> CVec:
        return CVec(1, lambda i: s.expr)

    def _unary(self, a, fn: Callable[[str], str], fold):
        if isinstance(a, CScalar):
            if a.literal is not None:
                return _lit(fold(a.literal))
            return self.scalar_tmp(fn(a.expr))
        if isinstance(a, CMat):
            return CMat(a.rows, a.cols, lambda i, j: fn(a.at(i, j)))
        return self.vec_tmp(a.size, lambda i: fn(a.at(i)))

    def neg(self, a):
        return self._unary(a, lambda s: f"(-{s})", lambda v: -v)

    def recip(self, a):
        return self._unary(a, lambda s: f"ipm_recip({s})", _recip32)

    def log(self, a):
        return self._unary(a, lambda s: f"ipm_log({s})", np.log)

    def _binary(self, a, b, op: str, fold):
        if isinstance(a, CScalar) and isinstance(b, CScalar):
            if a.literal is not None and b.literal is not None:
                return _lit(fold(a.literal, b.literal))
            return self.scalar_tmp(f"{a.expr} {op} {b.expr}")
        size = _broadcast(self.size(a), self.size(b))
        return self.vec_tmp(size, lambda i: f"{_entry(a, i)} {op} "
                                            f"{_entry(b, i)}")

    def add(self, a, b):
        return self._binary(a, b, "+", lambda x, y: x + y)

    def mul(self, a, b):
        return self._binary(a, b, "*", lambda x, y: x * y)

    def dot(self, a: CVec, b: CVec) -> CScalar:
        n = _broadcast(a.size, b.size)
        return CScalar(self._reduce(
            n, lambda k: f"{_entry(a, k)} * {_entry(b, k)}"))

    @staticmethod
    def mat_add_diag(m: CMat, d) -> CMat:
        def at(i, j):
            mij = m.at(i, j)
            return f"(({i}) == ({j}) ? {mij} + {_entry(d, i)} : {mij})"
        return CMat(m.rows, m.cols, at)

    @staticmethod
    def mat_add(a: CMat, b: CMat) -> CMat:
        return CMat(a.rows, a.cols,
                    lambda i, j: f"({a.at(i, j)} + {b.at(i, j)})")

    @staticmethod
    def mat_scale(m: CMat, s: CScalar) -> CMat:
        return CMat(m.rows, m.cols, lambda i, j: f"({s.expr} * {m.at(i, j)})")

    @staticmethod
    def mat_scale_cols(m: CMat, d: CVec) -> CMat:
        return CMat(m.rows, m.cols,
                    lambda i, j: f"({m.at(i, j)} * {_entry(d, j)})")

    @staticmethod
    def mat_scale_rows(d: CVec, m: CMat) -> CMat:
        return CMat(m.rows, m.cols,
                    lambda i, j: f"({_entry(d, i)} * {m.at(i, j)})")

    def matvec(self, m: CMat, v: CVec) -> CVec:
        if v.size != m.cols:
            raise TypeError(f"matrix ({m.rows}x{m.cols}) times vector "
                            f"({v.size})")
        return self._mat_reduce(m.rows, m.cols,
                                lambda i, k: f"{m.at(i, k)} * {v.at(k)}")

    def vecmat(self, v: CVec, m: CMat) -> CVec:
        if v.size != m.rows:
            raise TypeError(f"vector ({v.size}) times matrix "
                            f"({m.rows}x{m.cols})")
        return self._mat_reduce(m.cols, m.rows,
                                lambda j, k: f"{m.at(k, j)} * {v.at(k)}")

    def _mat_reduce(self, rows: int, depth: int,
                    term: Callable[[str, str], str]) -> CVec:
        if rows == 0:
            return CVec(0, _no_entry)
        name = self._name()
        self.lines.append(f"T {name}[{rows}];")
        self.lines.append(f"for (int i = 0; i < {rows}; ++i) {{")
        self.lines.append("  T acc = T(0);")
        if depth:
            self.lines.append(f"  for (int k = 0; k < {depth}; ++k) "
                              f"acc += {term('i', 'k')};")
        self.lines.append(f"  {name}[i] = acc;")
        self.lines.append("}")
        return array_vec(name, rows)

    @staticmethod
    def mat_t(m: CMat) -> CMat:
        return CMat(m.cols, m.rows, lambda i, j: m.at(j, i))

    # -- reductions of the metrics and the Gondzio targets ---------------

    @staticmethod
    def zero_scalar() -> CScalar:
        return CScalar("T(0)")

    def sum_sq(self, v: CVec) -> CScalar:
        return CScalar(self._reduce(v.size,
                                    lambda k: f"{v.at(k)} * {v.at(k)}"))

    def sum_abs(self, v: CVec) -> CScalar:
        return CScalar(self._reduce(v.size, lambda k: f"ipm_abs({v.at(k)})"))

    def sqrt(self, s: CScalar) -> CScalar:
        return self.scalar_tmp(f"ipm_sqrt({s.expr})")

    def div_const(self, s: CScalar, c: int) -> CScalar:
        return self.scalar_tmp(f"{s.expr} / T({c})")

    def minus_clip(self, p: CVec, mu: CScalar, beta_min: float,
                   beta_max: float) -> CVec:
        lo = self.scalar_tmp(f"{cpp_literal(beta_min)} * {mu.expr}")
        hi = self.scalar_tmp(f"{cpp_literal(beta_max)} * {mu.expr}")
        return self.vec_tmp(p.size, lambda i: (
            f"{p.at(i)} - ipm_min(ipm_max({p.at(i)}, {lo.expr}), "
            f"{hi.expr})"))

    def store(self, dst: str, offset: int, v: CVec) -> None:
        """dst[offset + i] = v[i] for every entry."""
        if v.size:
            self.lines.append(f"for (int i = 0; i < {v.size}; ++i) "
                              f"{dst}[{offset} + i] = {v.at('i')};")


def _recip32(v):
    return np.float32(BIG) if v == 0 else np.float32(1) / v


def _no_entry(i):
    raise TypeError("an empty vector has no entries")


def _broadcast(na: int, nb: int) -> int:
    if na == nb or nb == 1:
        return na
    if na == 1:
        return nb
    raise TypeError(f"cannot broadcast sizes {na} and {nb}")


def _entry(x, i: str) -> str:
    """Entry ``i`` of a scalar or vector handle, broadcasting scalars and
    one-entry vectors."""
    if isinstance(x, CScalar):
        return x.expr
    return x.at("0") if x.size == 1 else x.at(i)


def array_vec(name: str, size: int, offset: int = 0,
              stride: str = "") -> CVec:
    """A vector stored in the C++ array ``name`` from ``offset``, with
    entries ``stride`` apart (``""`` for contiguous)."""
    if size == 0:
        return CVec(0, _no_entry)
    if stride:
        return CVec(size, lambda i: f"{name}[({offset} + ({i})) * {stride}]")
    if offset:
        return CVec(size, lambda i: f"{name}[{offset} + ({i})]")
    return CVec(size, lambda i: f"{name}[{i}]")


def zeros_vec(size: int) -> CVec:
    return CVec(size, lambda i: "T(0)") if size else CVec(0, _no_entry)


def ones_vec(size: int) -> CVec:
    return CVec(size, lambda i: "T(1)") if size else CVec(0, _no_entry)


def data_matrix(name: str, rows: int, cols: int) -> CMat:
    """A (rows, cols) data matrix in global SoA memory (batch fastest)."""
    return CMat(rows, cols,
                lambda i, j: f"dat.{name}[(({i}) * {cols} + ({j})) * dat.S]")
