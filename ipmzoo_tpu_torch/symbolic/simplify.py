"""One-pass algebraic rewriting, driven to fixpoint by ``Expr.simplify``.

Semantics follow the reference rewrite system
(src/Visitors/SimplificationVisitor.cpp) so that derived
Newton systems and their reductions are term-for-term identical:

Sum:     flatten, push negation into sums, collect ``k*x`` coefficients,
         drop zeros, cancel ``x + (-x)``, fold numeric constants, canonical
         sort, ``-x - y -> -(x + y)``, and complexity-based common-factor
         extraction (leading and trailing).
Product: flatten, ``x*0 -> 0``, drop ones, hoist Negate, cancel
         ``x * x^-1 -> 1``, move named scalars and numbers to the front,
         fold numbers, and complexity-based distribution
         ``x(y + z) -> xy + xz``.
Unary:   transpose/invert/negate algebra incl. ``(xyz)^T = z^T y^T x^T``
         and ``(xyz)^-1 = z^-1 y^-1 x^-1``.

The strength of this rewrite system is load-bearing for the block
reductions: symbolic Gaussian elimination only terminates cleanly because
products like ``diag(v) diag(v)^-1`` cancel during elimination.
"""

from __future__ import annotations

from .expr import (Expr, Kind, ZERO, UNITY, diagonal_matrix, invert, is_invert,
                   is_named_scalar, is_negate, is_number, is_product, is_sum,
                   is_transpose, log, negate, number, product, sum_expr,
                   transpose)


def simplify_once(e: Expr, distribute: bool = True) -> Expr:
    k = e.kind
    if k == Kind.SUM:
        return _simplify_sum(e, distribute)
    if k == Kind.PRODUCT:
        return _simplify_product(e, distribute)
    if k == Kind.DIAGONAL_MATRIX:
        return _simplify_diagonal(e, distribute)
    if k == Kind.TRANSPOSE:
        return _simplify_transpose(e, distribute)
    if k == Kind.INVERT:
        return _simplify_invert(e, distribute)
    if k == Kind.NEGATE:
        return _simplify_negate(e, distribute)
    if k == Kind.LOG:
        return log(e.child.simplify_once(distribute))
    return e  # leaves simplify to themselves


# ---------------------------------------------------------------------------
# Unary rules
# ---------------------------------------------------------------------------

def _simplify_diagonal(e: Expr, distribute: bool) -> Expr:
    child = e.child.simplify_once(distribute)
    if child is ZERO or child is UNITY:
        return child
    return diagonal_matrix(child)


def _simplify_transpose(e: Expr, distribute: bool) -> Expr:
    child = e.child.simplify_once(distribute)
    if child is ZERO or child is UNITY:
        return child  # 0^T = 0, 1^T = 1
    k = child.kind
    if k == Kind.TRANSPOSE:
        return child.child  # (x^T)^T = x
    if k in (Kind.NUMBER, Kind.NAMED_SCALAR, Kind.SYMMETRIC_MATRIX,
             Kind.DIAGONAL_MATRIX):
        return child  # symmetric under transpose
    if k == Kind.INVERT:
        # In IPM derivations only inverses of diagonal matrices appear
        # transposed; those are symmetric, so the transpose is dropped —
        # as are inverses of scalars and symmetric matrices (a superset
        # of the reference, which asserts the diagonal case).
        if child.child.kind in (Kind.DIAGONAL_MATRIX, Kind.NUMBER,
                                Kind.NAMED_SCALAR, Kind.SYMMETRIC_MATRIX):
            return child
        return transpose(child)
    if k == Kind.NEGATE:
        return negate(transpose(child.child))  # (-x)^T = -x^T
    if k == Kind.SUM:
        return sum_expr([transpose(t) for t in child.terms])
    if k == Kind.PRODUCT:
        return product([transpose(t) for t in reversed(child.terms)])
    return transpose(child)


def _simplify_negate(e: Expr, distribute: bool) -> Expr:
    child = e.child.simplify_once(distribute)
    if child is ZERO:
        return child  # -0 = 0
    k = child.kind
    if k == Kind.NEGATE:
        return child.child  # -(-x) = x
    if k == Kind.PRODUCT:
        # -(a * (-b) * c) = a * b * c
        for i, t in enumerate(child.terms):
            if is_negate(t):
                terms = list(child.terms)
                terms[i] = t.child
                return product(terms)
        return negate(child)
    if k == Kind.SUM:
        # If more than half the terms are themselves negated, push the
        # negation through:  -(x - y - z) = -x + y + z.
        n_neg = sum(1 for t in child.terms if is_negate(t))
        if n_neg > len(child.terms) // 2:
            return sum_expr([t.child if is_negate(t) else negate(t)
                             for t in child.terms])
        return negate(child)
    return negate(child)


_INVERTIBLE_FACTORS = frozenset({
    Kind.NUMBER, Kind.NAMED_SCALAR, Kind.DIAGONAL_MATRIX, Kind.INVERT,
    Kind.SYMMETRIC_MATRIX, Kind.MATRIX, Kind.NEGATE,
})


def _simplify_invert(e: Expr, distribute: bool) -> Expr:
    child = e.child.simplify_once(distribute)
    if child is UNITY:
        return child
    k = child.kind
    if k == Kind.INVERT:
        return child.child  # (x^-1)^-1 = x
    if k == Kind.NEGATE:
        return negate(invert(child.child))  # (-x)^-1 = -(x^-1)
    if k == Kind.PRODUCT:
        # (xyz)^-1 = z^-1 y^-1 x^-1 — sound only when every factor is
        # individually invertible.  Blind distribution (as the reference
        # does) is wrong for products containing vector factors whose
        # inner product forms a scalar: (v^T w)^-1 != w^-1 (v^T)^-1.
        if all(t.kind in _INVERTIBLE_FACTORS for t in child.terms):
            return product([invert(t) for t in reversed(child.terms)])
        return invert(child)
    return invert(child)


# ---------------------------------------------------------------------------
# Sum rules
# ---------------------------------------------------------------------------

def _flatten_sum_terms(terms: list) -> list:
    out = []
    for t in terms:
        if is_sum(t):
            out.extend(t.terms)
        elif is_negate(t) and is_sum(t.child):
            out.extend(negate(ct) for ct in t.child.terms)
        else:
            out.append(t)
    return out


def _cancel_pairs(terms: list, inverse_kind: Kind, replacement: Expr) -> None:
    """Replace each pair {x, op(x)} with ``replacement`` in place.

    ``inverse_kind`` is NEGATE for sums (x + (-x) -> 0) and INVERT for
    products (x * x^-1 -> 1).
    """
    i = 0
    while i < len(terms):
        t1 = terms[i]
        for j in range(i + 1, len(terms)):
            t2 = terms[j]
            if ((t1.kind == inverse_kind and t1.child is t2) or
                    (t2.kind == inverse_kind and t2.child is t1)):
                del terms[j]
                terms[i] = replacement
                break
        i += 1


def _simplify_sum(e: Expr, distribute: bool) -> Expr:
    terms = [t.simplify_once(distribute) for t in e.terms]
    terms = _flatten_sum_terms(terms)

    # Coefficient collection: x + y + 1.3x -> 2.3x + y
    i = 0
    while i < len(terms):
        term = terms[i]
        if term is not ZERO:
            neg_term = negate(term)

            def matches(t):
                if t is term or t is neg_term:
                    return True
                return (is_product(t) and len(t.terms) == 2 and
                        is_number(t.terms[0]) and t.terms[1] is term)

            if sum(1 for t in terms if matches(t)) > 1:
                coeff = 0.0
                for t in terms:
                    if t is term:
                        coeff += 1.0
                    elif t is neg_term:
                        coeff -= 1.0
                    elif matches(t):
                        coeff += t.terms[0].value
                terms = [t for t in terms if not matches(t)]
                terms.append(product([number(coeff), term]))
        i += 1

    # x + 0 = x
    terms = [t for t in terms if t is not ZERO]
    if not terms:
        return ZERO

    # x + (-x) = 0
    _cancel_pairs(terms, Kind.NEGATE, ZERO)

    # 1 + x + 2 = 3 + x
    if sum(1 for t in terms if is_number(t)) > 1:
        value = sum(t.value for t in terms if is_number(t))
        terms = [t for t in terms if not is_number(t)]
        terms.append(number(value))

    # Canonical commutative order
    terms.sort(key=Expr.sort_key)

    # -x - y = -(x + y)
    if all(is_negate(t) for t in terms):
        return negate(sum_expr([t.child for t in terms]))

    if len(terms) == 1:
        return terms[0]

    simplified = sum_expr(terms)

    # Common-factor extraction, accepted only if complexity decreases:
    # xy + xz + xw -> x(y + z + w)
    if distribute:
        for leading in (True, False):
            factor_per_term = [t.leading_or_ending_factor(leading)
                               for t in terms]
            counts: dict = {}
            for f in factor_per_term:
                counts[f] = counts.get(f, 0) + 1
            # Candidates most-frequent first; ties broken by descending
            # canonical expression order (an ascending-count stable sort
            # over expression-ordered entries, consumed from the back).
            items = sorted(counts.items(), key=lambda kv: kv[0].sort_key())
            items.sort(key=lambda kv: kv[1])  # stable
            for factor, cnt in reversed(items):
                if cnt < 2:
                    break
                factored, unfactored = [], []
                for t, f in zip(terms, factor_per_term):
                    if f is factor:
                        factored.append(t.factor_out(factor, leading))
                    else:
                        unfactored.append(t)
                inner = sum_expr(factored)
                prod = (product([factor, inner]) if leading
                        else product([inner, factor]))
                candidate = (prod if not unfactored
                             else sum_expr([sum_expr(unfactored), prod]))
                candidate = candidate.simplify(distribute=False)
                if candidate.complexity() < simplified.complexity():
                    return candidate

    return simplified


# ---------------------------------------------------------------------------
# Product rules
# ---------------------------------------------------------------------------

def _stable_partition(terms: list, pred) -> list:
    return [t for t in terms if pred(t)] + [t for t in terms if not pred(t)]


def _simplify_product(e: Expr, distribute: bool) -> Expr:
    terms = [t.simplify_once(distribute) for t in e.terms]

    # Flatten: x(yz) = xyz
    flat = []
    for t in terms:
        if is_product(t):
            flat.extend(t.terms)
        else:
            flat.append(t)
    terms = flat

    # x * 0 = 0; x * 1 = x
    if any(t is ZERO for t in terms):
        return ZERO
    if all(t is UNITY for t in terms):
        return UNITY
    terms = [t for t in terms if t is not UNITY]

    # Hoist a negation out of the product
    for i, t in enumerate(terms):
        if is_negate(t):
            terms[i] = t.child
            return negate(product(terms))

    # x * x^-1 = 1
    _cancel_pairs(terms, Kind.INVERT, UNITY)

    # Scalars commute: move named scalars, then numbers, to the front
    terms = _stable_partition(terms, is_named_scalar)
    terms = _stable_partition(terms, is_number)

    # 2 * x * 3 = 6x
    if sum(1 for t in terms if is_number(t)) > 1:
        value = 1.0
        for t in terms:
            if is_number(t):
                value *= t.value
        terms = [t for t in terms if not is_number(t)]
        terms.insert(0, number(value))

    if len(terms) == 1:
        return terms[0]

    simplified = product(terms)

    # Distribution, accepted if complexity does not increase:
    # x(y + z) -> xy + xz
    if distribute and len(terms) > 1:
        for i, t in enumerate(terms):
            if is_sum(t):
                init, rest = terms[:i], terms[i + 1:]
                distributed = sum_expr(
                    [product(init + [st] + rest) for st in t.terms]
                ).simplify(distribute=False)
                if distributed.complexity() <= simplified.complexity():
                    return distributed

    return simplified
