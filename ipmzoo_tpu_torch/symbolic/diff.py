"""Vector-calculus differentiation of expression DAGs.

Rule set mirrors the reference derivative semantics
(src/Visitors/DifferentiationVisitor.cpp), including the
two product-rule special cases that make complementarity rows come out in
the canonical ``diag(v) lambda - mu e`` form:

  (a) if the differentiated factor of a product is a (sum of) diagonal
      matrix(es) directly multiplying a trailing Variable, that variable is
      wrapped in ``diag()`` — e.g. d/ds (Lambda s) yields ``diag(lambda)``
      structure rather than a dangling vector product;
  (b) ``f(x)^T g(x)`` contributes the extra ``(dg)^T f`` term whenever the
      transposed child is not a plain named matrix.

The ``log`` rule produces barrier gradients ``diag(f)^-1 f'``.
"""

from __future__ import annotations

from .expr import (Expr, Kind, ZERO, UNITY, diagonal_matrix, invert,
                   is_diagonal, is_matrix, is_negate, is_transpose,
                   is_variable, negate, product, sum_expr, transpose,
                   variable)

_memo: dict = {}


def clear_memo() -> None:
    _memo.clear()


def differentiate(e: Expr, var: Expr) -> Expr:
    assert is_variable(var), f"can only differentiate w.r.t. a Variable, got {var!r}"
    if not e.contains(var):
        return ZERO
    key = (e, var)
    hit = _memo.get(key)
    if hit is not None:
        return hit
    res = _diff(e, var)
    _memo[key] = res
    return res


def _diff(e: Expr, var: Expr) -> Expr:
    k = e.kind
    if k == Kind.VARIABLE:
        return UNITY if e is var else ZERO
    if k == Kind.DIAGONAL_MATRIX:
        return diagonal_matrix(e.child.differentiate(var))
    if k == Kind.TRANSPOSE:
        return transpose(e.child.differentiate(var))
    if k == Kind.NEGATE:
        return negate(e.child.differentiate(var))
    if k == Kind.INVERT:
        raise NotImplementedError("derivative of matrix inverse")
    if k == Kind.LOG:
        # d log f = diag(f)^-1 f'
        return product([invert(diagonal_matrix(e.child)),
                        e.child.differentiate(var)])
    if k == Kind.SUM:
        return sum_expr([t.differentiate(var) for t in e.terms])
    if k == Kind.PRODUCT:
        return _diff_product(e, var)
    return ZERO  # other leaves are constants


def _is_diagonal_like(t: Expr) -> bool:
    """diag(..), or a sum whose terms are all (negated) diagonals or zero."""
    if is_diagonal(t):
        return True
    if t.kind == Kind.SUM:
        def inner(yt: Expr) -> bool:
            return is_diagonal(yt) or (is_negate(yt) and is_diagonal(yt.child))
        return (any(inner(yt) for yt in t.terms) and
                all(inner(yt) or yt is ZERO for yt in t.terms))
    return False


def _diff_product(e: Expr, var: Expr) -> Expr:
    terms = e.terms
    n = len(terms)
    out = []
    for i in range(n):
        xi = terms[i]

        # Standard product-rule term with factor i differentiated.
        new_terms = list(terms)
        new_terms[i] = xi.differentiate(var)
        # Special case (a): a diagonal-like derivative directly multiplying
        # a final Variable — wrap the variable so complementarity rows read
        # diag(v) * lambda.
        if (i + 2 == n and _is_diagonal_like(new_terms[i]) and
                is_variable(new_terms[i + 1])):
            new_terms[i + 1] = diagonal_matrix(new_terms[i + 1])
        out.append(product(new_terms))

        # Special case (b): xi = f(x)^T with non-named-matrix child; the
        # inner-product rule needs the extra (d rest)^T f term.
        if (i + 1 < n and is_transpose(xi) and not is_matrix(xi.child)):
            rest = (terms[i + 1] if i + 2 == n
                    else product(list(terms[i + 1:])))
            extra = list(terms[:i])
            extra.append(transpose(rest).differentiate(var))
            extra.append(xi.child)
            out.append(product(extra))
            break

    return sum_expr(out)
