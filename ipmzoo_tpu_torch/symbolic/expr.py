"""Immutable, hash-consed symbolic expression IR.

This is the trace-time core of the framework: expression DAGs over scalars,
vectors and matrices with vector-calculus differentiation and algebraic
simplification.  It mirrors the capabilities of the reference expression
engine (cf. include/Expr.h, src/Expr.cpp) but is designed as
a Python IR whose only job is to run at *compile* (trace) time — numeric
evaluation is done by :mod:`ipmzoo_tpu_torch.models.codegen` on tensors,
so nothing here ever executes on device.

Key invariants:
  * Structurally equal expressions are pointer-identical (interning), so
    ``a is b`` <=> structural equality.  (Reference: ExprFactory intern
    cache, src/ExprFactory.cpp:14-34.)
  * Expressions order lexicographically by (node-kind index, canonical
    string), giving deterministic canonicalisation.  (Reference:
    src/Expr.cpp:21-31.)
"""

from __future__ import annotations

import enum
from typing import Callable, Iterable, Optional


class Kind(enum.IntEnum):
    """Node kinds; the integer order defines canonical sort order.

    The order matches the reference's variant declaration order
    (include/Expr.h:32-35) so that canonical sorting —
    and therefore rendered output — agrees with the reference.
    """

    NUMBER = 0
    NAMED_SCALAR = 1
    NAMED_VECTOR = 2
    VARIABLE = 3
    MATRIX = 4
    SYMMETRIC_MATRIX = 5
    DIAGONAL_MATRIX = 6
    TRANSPOSE = 7
    INVERT = 8
    LOG = 9
    SUM = 10
    PRODUCT = 11
    NEGATE = 12


_LEAF_KINDS = frozenset({
    Kind.NUMBER, Kind.NAMED_SCALAR, Kind.NAMED_VECTOR, Kind.VARIABLE,
    Kind.MATRIX, Kind.SYMMETRIC_MATRIX,
})
_NAMED_KINDS = frozenset({
    Kind.NAMED_SCALAR, Kind.NAMED_VECTOR, Kind.VARIABLE,
    Kind.MATRIX, Kind.SYMMETRIC_MATRIX,
})
_UNARY_KINDS = frozenset({
    Kind.DIAGONAL_MATRIX, Kind.TRANSPOSE, Kind.INVERT, Kind.LOG, Kind.NEGATE,
})
_NARY_KINDS = frozenset({Kind.SUM, Kind.PRODUCT})

_KEY_NAMES = {
    Kind.NUMBER: "number",
    Kind.NAMED_SCALAR: "named_scalar",
    Kind.NAMED_VECTOR: "named_vector",
    Kind.VARIABLE: "variable",
    Kind.MATRIX: "matrix",
    Kind.SYMMETRIC_MATRIX: "symmetric_matrix",
    Kind.DIAGONAL_MATRIX: "diagonal_matrix",
    Kind.TRANSPOSE: "transpose",
    Kind.INVERT: "invert",
    Kind.LOG: "log",
    Kind.SUM: "sum",
    Kind.PRODUCT: "product",
    Kind.NEGATE: "negate",
}


def format_number(value: float) -> str:
    """Format a float the way C++ ``operator<<`` does by default ("%g")."""
    return f"{value:g}"


class Expr:
    """A single interned expression node.

    Do not construct directly — use the factory functions (``number``,
    ``variable``, ``sum`` …).  Identity equality is structural equality.
    """

    __slots__ = ("kind", "value", "name", "child", "terms", "key", "_hash",
                 "_vars", "_complexity")

    kind: Kind
    value: float            # Kind.NUMBER only
    name: str               # named leaves only
    child: Optional["Expr"]  # unary kinds only
    terms: tuple            # n-ary kinds only
    key: str                # canonical (intern) string

    def __init__(self, kind: Kind, value: float, name: str,
                 child: Optional["Expr"], terms: tuple, key: str):
        object.__setattr__  # silence linters about mutability; slots are set once
        self.kind = kind
        self.value = value
        self.name = name
        self.child = child
        self.terms = terms
        self.key = key
        self._hash = hash((int(kind), key))
        self._vars = None
        self._complexity = None

    # -- identity / ordering ------------------------------------------------

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return self is other

    def __ne__(self, other) -> bool:
        return self is not other

    def sort_key(self):
        return (int(self.kind), self.key)

    def __lt__(self, other: "Expr") -> bool:
        return self.sort_key() < other.sort_key()

    def __le__(self, other: "Expr") -> bool:
        return self.sort_key() <= other.sort_key()

    def __gt__(self, other: "Expr") -> bool:
        return self.sort_key() > other.sort_key()

    def __ge__(self, other: "Expr") -> bool:
        return self.sort_key() >= other.sort_key()

    def __repr__(self) -> str:
        return f"Expr<{self.key}>"

    # -- algebra sugar ------------------------------------------------------

    def __add__(self, other: "Expr") -> "Expr":
        return sum_expr([self, other])

    def __sub__(self, other: "Expr") -> "Expr":
        return sum_expr([self, negate(other)])

    def __mul__(self, other: "Expr") -> "Expr":
        return product([self, other])

    def __neg__(self) -> "Expr":
        return negate(self)

    # -- structural queries -------------------------------------------------

    @property
    def children(self) -> tuple:
        if self.kind in _UNARY_KINDS:
            return (self.child,)
        if self.kind in _NARY_KINDS:
            return self.terms
        return ()

    def contains(self, target: "Expr") -> bool:
        """True if ``target`` occurs as a subexpression of ``self``."""
        if self is target:
            return True
        memo = _contains_memo
        k = (self, target)
        hit = memo.get(k)
        if hit is not None:
            return hit
        res = any(c.contains(target) for c in self.children)
        memo[k] = res
        return res

    def replace(self, target: "Expr", replacement: "Expr") -> "Expr":
        """Replace every occurrence of ``target`` with ``replacement``."""
        if self is target:
            return replacement
        if not self.contains(target):
            return self
        if self.kind in _UNARY_KINDS:
            return _make_unary(self.kind, self.child.replace(target, replacement))
        if self.kind in _NARY_KINDS:
            new_terms = [t.replace(target, replacement) for t in self.terms]
            return _make_nary(self.kind, new_terms)
        return self

    def variables(self) -> frozenset:
        """The set of Variable leaves occurring in this expression."""
        if self._vars is None:
            if self.kind == Kind.VARIABLE:
                self._vars = frozenset((self,))
            elif self.kind in _LEAF_KINDS:
                self._vars = frozenset()
            else:
                acc = frozenset()
                for c in self.children:
                    acc |= c.variables()
                self._vars = acc
        return self._vars

    def complexity(self) -> float:
        """Size heuristic steering factor-out/distribute decisions.

        Number = 0.5, named leaf = 1.0, unary = 0.5 + child, n-ary = sum.
        (Reference: src/Expr.cpp:186-200.)
        """
        if self._complexity is None:
            if self.kind == Kind.NUMBER:
                self._complexity = 0.5
            elif self.kind in _LEAF_KINDS:
                self._complexity = 1.0
            elif self.kind in _UNARY_KINDS:
                self._complexity = 0.5 + self.child.complexity()
            else:
                self._complexity = sum(t.complexity() for t in self.terms)
        return self._complexity

    # -- heavy algorithms (implemented in sibling modules) ------------------

    def differentiate(self, var: "Expr") -> "Expr":
        """Vector-calculus derivative with respect to Variable ``var``."""
        if not self.contains(var):
            return ZERO
        from . import diff
        return diff.differentiate(self, var)

    def simplify(self, distribute: bool = True) -> "Expr":
        """Fixpoint algebraic simplification."""
        memo = _simplify_memo[distribute]
        hit = memo.get(self)
        if hit is not None:
            return hit
        from . import simplify as _s
        expr = self
        while True:
            nxt = _s.simplify_once(expr, distribute)
            if nxt is expr:
                break
            expr = nxt
        memo[self] = expr
        memo[expr] = expr
        return expr

    def simplify_once(self, distribute: bool = True) -> "Expr":
        from . import simplify as _s
        return _s.simplify_once(self, distribute)

    def to_string(self, condensed: bool = False) -> str:
        from . import printing
        return printing.to_string(self, condensed)

    def to_expression_string(self) -> str:
        return self.key

    # -- factoring helpers (used by simplification) -------------------------

    def leading_or_ending_factor(self, leading: bool) -> "Expr":
        """The common leading (or trailing) factor of this expression.

        For a product this is the first (last) factor; for a sum it is the
        shared factor of all terms if one exists, else the sum itself; a
        negation is transparent.  (Reference: src/Expr.cpp:128-149.)
        """
        if self.kind == Kind.NEGATE:
            return self.child.leading_or_ending_factor(leading)
        if self.kind == Kind.SUM:
            first = self.terms[0].leading_or_ending_factor(leading)
            if all(t.leading_or_ending_factor(leading) is first
                   for t in self.terms):
                return first
            return self
        if self.kind == Kind.PRODUCT:
            t = self.terms[0] if leading else self.terms[-1]
            return t.leading_or_ending_factor(leading)
        return self

    def factor_out(self, factor: "Expr", leading: bool) -> "Expr":
        """Divide out ``factor`` (which must be the leading/ending factor)."""
        if factor is self:
            return UNITY
        assert self.leading_or_ending_factor(leading) is factor, (
            f"{factor!r} is not the {'leading' if leading else 'ending'} "
            f"factor of {self!r}")
        if self.kind == Kind.NEGATE:
            return negate(self.child.factor_out(factor, leading))
        if self.kind == Kind.SUM:
            return sum_expr([t.factor_out(factor, leading)
                             for t in self.terms])
        if self.kind == Kind.PRODUCT:
            terms = list(self.terms)
            n = len(terms)
            for i in range(n):
                idx = i if leading else n - 1 - i
                if terms[idx].leading_or_ending_factor(leading) is factor:
                    terms[idx] = terms[idx].factor_out(factor, leading)
                    return product(terms)
        raise AssertionError(f"cannot factor {factor!r} out of {self!r}")


# ---------------------------------------------------------------------------
# Interning factory
# ---------------------------------------------------------------------------

_intern: dict = {}
_simplify_memo = {True: {}, False: {}}
_contains_memo: dict = {}


def intern_cache_size() -> int:
    return len(_intern)


def clear_caches(keep_units: bool = True) -> None:
    """Drop all interned expressions and memo tables (mainly for tests)."""
    _intern.clear()
    _simplify_memo[True].clear()
    _simplify_memo[False].clear()
    _contains_memo.clear()
    from . import diff
    diff.clear_memo()
    global ZERO, UNITY
    ZERO = number(0.0)
    UNITY = number(1.0)


def _get(kind: Kind, key: str, value: float = 0.0, name: str = "",
         child: Optional[Expr] = None, terms: tuple = ()) -> Expr:
    e = _intern.get(key)
    if e is None:
        e = Expr(kind, value, name, child, terms, key)
        _intern[key] = e
    return e


def number(value: float) -> Expr:
    v = float(value)
    return _get(Kind.NUMBER, f"number({format_number(v)})", value=v)


def named_scalar(name: str) -> Expr:
    return _get(Kind.NAMED_SCALAR, f"named_scalar({name})", name=name)


def named_vector(name: str) -> Expr:
    return _get(Kind.NAMED_VECTOR, f"named_vector({name})", name=name)


def variable(name: str) -> Expr:
    return _get(Kind.VARIABLE, f"variable({name})", name=name)


def matrix(name: str) -> Expr:
    return _get(Kind.MATRIX, f"matrix({name})", name=name)


def symmetric_matrix(name: str) -> Expr:
    return _get(Kind.SYMMETRIC_MATRIX, f"symmetric_matrix({name})", name=name)


def _make_unary(kind: Kind, child: Expr) -> Expr:
    return _get(kind, f"{_KEY_NAMES[kind]}({child.key})", child=child)


def diagonal_matrix(child: Expr) -> Expr:
    return _make_unary(Kind.DIAGONAL_MATRIX, child)


def transpose(child: Expr) -> Expr:
    return _make_unary(Kind.TRANSPOSE, child)


def invert(child: Expr) -> Expr:
    return _make_unary(Kind.INVERT, child)


def log(child: Expr) -> Expr:
    return _make_unary(Kind.LOG, child)


def negate(child: Expr) -> Expr:
    return _make_unary(Kind.NEGATE, child)


def _make_nary(kind: Kind, terms: Iterable[Expr]) -> Expr:
    ts = tuple(terms)
    if not ts:
        return ZERO if kind == Kind.SUM else UNITY
    if len(ts) == 1:
        return ts[0]
    key = f"{_KEY_NAMES[kind]}({', '.join(t.key for t in ts)})"
    return _get(kind, key, terms=ts)


def sum_expr(terms: Iterable[Expr]) -> Expr:
    """n-ary sum; sum([]) == 0, sum([x]) == x."""
    return _make_nary(Kind.SUM, terms)


def product(terms: Iterable[Expr]) -> Expr:
    """n-ary product; product([]) == 1, product([x]) == x."""
    return _make_nary(Kind.PRODUCT, terms)


# -- kind predicates --------------------------------------------------------

def is_number(e: Expr) -> bool: return e.kind == Kind.NUMBER
def is_named_scalar(e: Expr) -> bool: return e.kind == Kind.NAMED_SCALAR
def is_named_vector(e: Expr) -> bool: return e.kind == Kind.NAMED_VECTOR
def is_variable(e: Expr) -> bool: return e.kind == Kind.VARIABLE
def is_matrix(e: Expr) -> bool: return e.kind == Kind.MATRIX
def is_symmetric_matrix(e: Expr) -> bool: return e.kind == Kind.SYMMETRIC_MATRIX
def is_diagonal(e: Expr) -> bool: return e.kind == Kind.DIAGONAL_MATRIX
def is_transpose(e: Expr) -> bool: return e.kind == Kind.TRANSPOSE
def is_invert(e: Expr) -> bool: return e.kind == Kind.INVERT
def is_log(e: Expr) -> bool: return e.kind == Kind.LOG
def is_sum(e: Expr) -> bool: return e.kind == Kind.SUM
def is_product(e: Expr) -> bool: return e.kind == Kind.PRODUCT
def is_negate(e: Expr) -> bool: return e.kind == Kind.NEGATE


def is_named_leaf(e: Expr) -> bool:
    return e.kind in _NAMED_KINDS


ZERO: Expr = number(0.0)
UNITY: Expr = number(1.0)
