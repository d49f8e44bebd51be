"""Human-readable / LaTeX rendering of expressions.

Condensed mode minimises parentheses and uses LaTeX conventions
(``\\log``, ``^T``, ``^{-1}``, ``\\diag``); ``diag`` of a named leaf
renders as the uppercased name (diag(s) -> S), mirroring the reference
renderer (src/Visitors/ToStringVisitor.cpp) so web/CLI
output is directly comparable.
"""

from __future__ import annotations

from .expr import Expr, Kind, format_number, is_invert, is_negate, \
    is_product, is_sum, is_transpose, is_named_leaf


def to_string(e: Expr, condensed: bool = False) -> str:
    k = e.kind
    if k == Kind.NUMBER:
        return format_number(e.value)
    if k in (Kind.NAMED_SCALAR, Kind.NAMED_VECTOR, Kind.VARIABLE,
             Kind.MATRIX, Kind.SYMMETRIC_MATRIX):
        return e.name
    if k == Kind.DIAGONAL_MATRIX:
        c = e.child
        if is_named_leaf(c):
            # diag(s) renders as S: uppercase the first alphabetic char
            name = c.name
            for i, ch in enumerate(name):
                if ch.isalpha():
                    return name[:i] + ch.upper() + name[i + 1:]
            return "\\diag(" + name + ")"
        return "\\diag(" + to_string(c, condensed) + ")"
    if k == Kind.TRANSPOSE:
        c = e.child
        if condensed and (is_sum(c) or is_product(c) or is_invert(c)):
            return "(" + to_string(c, condensed) + ")^T"
        return to_string(c, condensed) + "^T"
    if k == Kind.NEGATE:
        c = e.child
        if condensed and is_sum(c):
            return "-(" + to_string(c, condensed) + ")"
        return "-" + to_string(c, condensed)
    if k == Kind.INVERT:
        c = e.child
        if condensed and (is_sum(c) or is_product(c) or is_transpose(c)):
            return "(" + to_string(c, condensed) + ")^{-1}"
        return to_string(c, condensed) + "^{-1}"
    if k == Kind.LOG:
        return "\\log(" + to_string(e.child, condensed) + ")"
    if k == Kind.SUM:
        parts = [("" if condensed else "("), to_string(e.terms[0], condensed)]
        for t in e.terms[1:]:
            if is_negate(t):
                parts.append(" - " + to_string(t.child, condensed))
            else:
                parts.append(" + " + to_string(t, condensed))
        parts.append("" if condensed else ")")
        return "".join(parts)
    if k == Kind.PRODUCT:
        front = e.terms[0]
        s = "" if condensed else "("
        if condensed and is_sum(front):
            s += "(" + to_string(front, condensed) + ")"
        else:
            s += to_string(front, condensed)
        symbol = " " if condensed else " * "
        for t in e.terms[1:]:
            if is_negate(t) or (condensed and is_sum(t)):
                s += symbol + "(" + to_string(t, condensed) + ")"
            else:
                s += symbol + to_string(t, condensed)
        s += "" if condensed else ")"
        return s
    raise AssertionError(f"unknown kind {k}")
