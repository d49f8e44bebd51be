"""Symbolic problem construction: Settings -> slacked/barrier QP -> Lagrangian.

For a chosen formulation this constructs, symbolically,

    minimize    1/2 x^T Q x + c^T x  (+ penalty / regularization terms)
    subject to  slacked equality constraints, remaining bounds,
                nonnegativity of barrier slacks,

then the Lagrangian and (in :mod:`.newton`) the KKT conditions.  The
construction follows the reference pipeline stage-for-stage
(src/SymbolicOptimization.cpp:50-357) so derivations match
term-for-term; the numerical lowering is entirely different.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..symbolic import expr as E
from ..symbolic.expr import Expr
from .settings import (Bounds, EqualityHandling, InequalityHandling,
                       ProblemStage, Settings, VariableNames)


@dataclasses.dataclass(frozen=True)
class SymbolTable:
    """The canonical symbols of a formulation (interned expressions)."""
    Q: Expr
    c: Expr
    A_ineq: Expr
    A_eq: Expr
    b_eq: Expr
    p_eq: Expr
    delta_eq: Expr
    mu: Expr
    e_var: Expr
    e_ineq: Expr
    e_eq: Expr
    x: Expr
    s_A_ineq: Expr
    s_A_ineq_l: Expr
    s_A_ineq_u: Expr
    s_x_l: Expr
    s_x_u: Expr
    s_A_eq: Expr
    s_A_eq_l: Expr
    s_A_eq_u: Expr
    lambda_A_eq: Expr
    lambda_sAeql: Expr
    lambda_sAequ: Expr
    lambda_A_ineq: Expr
    lambda_sAineql: Expr
    lambda_sAinequ: Expr
    lambda_sxl: Expr
    lambda_sxu: Expr
    l_A_ineq: Expr
    u_A_ineq: Expr
    l_x: Expr
    u_x: Expr


def build_symbols(names: VariableNames = VariableNames()) -> SymbolTable:
    """Create the ~30 canonical symbols of the formulation space.

    Note: ``b_eq`` is a *matrix* symbol for string/parity reasons even
    though it is semantically a vector — the reference does the same
    (src/SymbolicOptimization.cpp:19) and the numeric environment binds a
    vector to it.
    """
    return SymbolTable(
        Q=E.symmetric_matrix(names.Q),
        c=E.named_vector(names.c),
        A_ineq=E.matrix(names.A_ineq),
        A_eq=E.matrix(names.A_eq),
        b_eq=E.matrix(names.b_eq),
        p_eq=E.variable(names.p_eq),
        delta_eq=E.named_scalar(names.delta_eq),
        mu=E.named_scalar("\\mu"),
        e_var=E.named_vector("e_{" + names.x + "}"),
        e_ineq=E.named_vector("e_{" + names.A_ineq + "}"),
        e_eq=E.named_vector("e_{" + names.A_eq + "}"),
        x=E.variable(names.x),
        s_A_ineq=E.variable(names.s_A_ineq),
        s_A_ineq_l=E.variable(names.s_A_ineq_l),
        s_A_ineq_u=E.variable(names.s_A_ineq_u),
        s_x_l=E.variable(names.s_x_l),
        s_x_u=E.variable(names.s_x_u),
        s_A_eq=E.variable(names.s_A_eq),
        s_A_eq_l=E.variable(names.s_A_eq_l),
        s_A_eq_u=E.variable(names.s_A_eq_u),
        lambda_A_eq=E.variable("\\lambda_{" + names.A_eq + "}"),
        lambda_sAeql=E.variable("\\lambda_{" + names.s_A_eq_l + "}"),
        lambda_sAequ=E.variable("\\lambda_{" + names.s_A_eq_u + "}"),
        lambda_A_ineq=E.variable("\\lambda_{" + names.A_ineq + "}"),
        lambda_sAineql=E.variable("\\lambda_{" + names.s_A_ineq_l + "}"),
        lambda_sAinequ=E.variable("\\lambda_{" + names.s_A_ineq_u + "}"),
        lambda_sxl=E.variable("\\lambda_{" + names.s_x_l + "}"),
        lambda_sxu=E.variable("\\lambda_{" + names.s_x_u + "}"),
        l_A_ineq=E.named_vector(names.l_A_ineq),
        u_A_ineq=E.named_vector(names.u_A_ineq),
        l_x=E.named_vector(names.l_x),
        u_x=E.named_vector(names.u_x),
    )


@dataclasses.dataclass
class BoundConstraint:
    """l <= expr <= u with dual variables for the active sides."""
    expr: Expr
    lower: Optional[Expr]
    upper: Optional[Expr]
    lower_dual: Optional[Expr]
    upper_dual: Optional[Expr]


@dataclasses.dataclass
class EqualityConstraint:
    """expr = rhs with dual variable."""
    expr: Expr
    rhs: Expr
    dual: Expr


@dataclasses.dataclass
class Problem:
    """A (possibly slacked / barriered) QP in symbolic form.

    The four variable groups order the KKT block structure:
    ``primal`` (x), ``eq_duals`` (equality multipliers), ``slacks``
    (primal slacks), ``bound_duals`` (bound multipliers), then
    ``nonnegative_slacks``.
    """
    objective: Expr
    inequalities: list
    equalities: list
    variable_bounds: list
    primal: list
    eq_duals: list
    slacks: list
    bound_duals: list
    nonnegative_slacks: list

    def all_variables(self) -> list:
        return (self.primal + self.eq_duals + self.slacks +
                self.bound_duals + self.nonnegative_slacks)


def build_problem(settings: Settings,
                  names: VariableNames = VariableNames(),
                  stage: ProblemStage = ProblemStage.SLACKED) -> Problem:
    o = build_symbols(names)
    half = E.number(0.5)
    xQx = E.product([half, E.transpose(o.x), o.Q, o.x]).simplify()
    cx = E.product([E.transpose(o.c), o.x])

    p = Problem(objective=E.sum_expr([xQx, cx]), inequalities=[],
                equalities=[], variable_bounds=[], primal=[o.x], eq_duals=[],
                slacks=[], bound_duals=[], nonnegative_slacks=[])

    _add_inequalities(p, o, settings, stage)
    _add_equalities(p, o, settings, stage)
    _add_variable_bounds(p, o, settings, stage)
    _add_log_barriers(p, o, settings, stage)
    return p


def _add_inequalities(p: Problem, o: SymbolTable, settings: Settings,
                      stage: ProblemStage) -> None:
    lo, up = settings.inequalities.has_lower, settings.inequalities.has_upper
    if not (lo or up):
        return
    Ax = E.product([o.A_ineq, o.x])
    if stage == ProblemStage.ORIGINAL:
        p.inequalities.append(BoundConstraint(
            Ax, o.l_A_ineq if lo else None, o.u_A_ineq if up else None,
            E.negate(o.lambda_sAineql) if lo else None,
            o.lambda_sAinequ if up else None))
        return
    ih = settings.inequality_handling
    if ih == InequalityHandling.SLACKS:
        p.equalities.append(EqualityConstraint(
            Ax - o.s_A_ineq, E.ZERO, o.lambda_A_ineq))
        p.variable_bounds.append(BoundConstraint(
            o.s_A_ineq, o.l_A_ineq if lo else None, o.u_A_ineq if up else None,
            o.lambda_sAineql if lo else None,
            o.lambda_sAinequ if up else None))
        p.eq_duals.append(o.lambda_A_ineq)
        p.slacks.append(o.s_A_ineq)
    elif ih == InequalityHandling.SLACKED_SLACKS:
        p.equalities.append(EqualityConstraint(
            Ax - o.s_A_ineq, E.ZERO, o.lambda_A_ineq))
        p.eq_duals.append(o.lambda_A_ineq)
        p.slacks.append(o.s_A_ineq)
        if lo:
            p.equalities.append(EqualityConstraint(
                o.s_A_ineq - o.s_A_ineq_l, o.l_A_ineq,
                E.negate(o.lambda_sAineql)))
            p.bound_duals.append(o.lambda_sAineql)
            p.nonnegative_slacks.append(o.s_A_ineq_l)
        if up:
            p.equalities.append(EqualityConstraint(
                o.s_A_ineq + o.s_A_ineq_u, o.u_A_ineq, o.lambda_sAinequ))
            p.bound_duals.append(o.lambda_sAinequ)
            p.nonnegative_slacks.append(o.s_A_ineq_u)
    elif ih == InequalityHandling.NAIVE_SLACKS:
        if lo:
            p.equalities.append(EqualityConstraint(
                Ax - o.s_A_ineq_l, o.l_A_ineq, E.negate(o.lambda_sAineql)))
            p.eq_duals.append(o.lambda_sAineql)
            p.nonnegative_slacks.append(o.s_A_ineq_l)
        if up:
            p.equalities.append(EqualityConstraint(
                Ax + o.s_A_ineq_u, o.u_A_ineq, o.lambda_sAinequ))
            p.eq_duals.append(o.lambda_sAinequ)
            p.nonnegative_slacks.append(o.s_A_ineq_u)
    else:
        raise ValueError(ih)


def _add_equalities(p: Problem, o: SymbolTable, settings: Settings,
                    stage: ProblemStage) -> None:
    if not settings.equalities:
        return
    half = E.number(0.5)
    Cx = E.product([o.A_eq, o.x])
    CxMinusB = Cx - o.b_eq
    eh = settings.equality_handling
    if stage == ProblemStage.ORIGINAL or eh == EqualityHandling.NONE:
        p.equalities.append(EqualityConstraint(Cx, o.b_eq, o.lambda_A_eq))
        p.eq_duals.append(o.lambda_A_eq)
    elif eh == EqualityHandling.SLACKS:
        p.equalities.append(EqualityConstraint(
            Cx - o.s_A_eq, E.ZERO, o.lambda_A_eq))
        p.variable_bounds.append(BoundConstraint(
            o.s_A_eq, o.b_eq, o.b_eq, o.lambda_sAeql, o.lambda_sAequ))
        p.eq_duals.append(o.lambda_A_eq)
        p.slacks.append(o.s_A_eq)
    elif eh == EqualityHandling.SLACKED_SLACKS:
        p.equalities.append(EqualityConstraint(
            Cx - o.s_A_eq, E.ZERO, o.lambda_A_eq))
        p.equalities.append(EqualityConstraint(
            o.s_A_eq - o.s_A_eq_l, o.b_eq, E.negate(o.lambda_sAeql)))
        p.equalities.append(EqualityConstraint(
            o.s_A_eq + o.s_A_eq_u, o.b_eq, o.lambda_sAequ))
        p.eq_duals.append(o.lambda_A_eq)
        p.slacks.append(o.s_A_eq)
        p.bound_duals.append(o.lambda_sAeql)
        p.bound_duals.append(o.lambda_sAequ)
        p.nonnegative_slacks.append(o.s_A_eq_l)
        p.nonnegative_slacks.append(o.s_A_eq_u)
    elif eh == EqualityHandling.NAIVE_SLACKS:
        p.equalities.append(EqualityConstraint(
            Cx - o.s_A_eq_l, o.b_eq, E.negate(o.lambda_sAeql)))
        p.equalities.append(EqualityConstraint(
            Cx + o.s_A_eq_u, o.b_eq, o.lambda_sAequ))
        p.eq_duals.append(o.lambda_sAeql)
        p.eq_duals.append(o.lambda_sAequ)
        p.nonnegative_slacks.append(o.s_A_eq_l)
        p.nonnegative_slacks.append(o.s_A_eq_u)
    elif eh == EqualityHandling.PENALTY_FUNCTION:
        mu_term = E.product([half, E.invert(o.mu)])
        p.objective = p.objective + E.product(
            [mu_term, E.transpose(CxMinusB), CxMinusB])
    elif eh == EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL:
        p.equalities.append(EqualityConstraint(
            CxMinusB - E.product([half, o.mu, o.lambda_A_eq]), E.ZERO,
            o.lambda_A_eq))
        p.eq_duals.append(o.lambda_A_eq)
    elif eh == EqualityHandling.REGULARIZATION:
        p.objective = p.objective + E.product(
            [half, E.transpose(o.p_eq), o.p_eq]).simplify()
        p.equalities.append(EqualityConstraint(
            CxMinusB + E.product([o.delta_eq, o.p_eq]), E.ZERO,
            o.lambda_A_eq))
        p.eq_duals.append(o.lambda_A_eq)
        p.slacks.append(o.p_eq)
    else:
        raise ValueError(eh)


def _add_variable_bounds(p: Problem, o: SymbolTable, settings: Settings,
                         stage: ProblemStage) -> None:
    lo, up = settings.variable_bounds.has_lower, settings.variable_bounds.has_upper
    if not (lo or up):
        return
    if (stage == ProblemStage.ORIGINAL or
            settings.inequality_handling == InequalityHandling.SLACKS):
        p.variable_bounds.append(BoundConstraint(
            o.x, o.l_x if lo else None, o.u_x if up else None,
            o.lambda_sxl if lo else None, o.lambda_sxu if up else None))
        return
    if settings.inequality_handling in (InequalityHandling.SLACKED_SLACKS,
                                        InequalityHandling.NAIVE_SLACKS):
        if lo:
            p.equalities.append(EqualityConstraint(
                o.x - o.s_x_l, o.l_x, E.negate(o.lambda_sxl)))
            p.bound_duals.append(o.lambda_sxl)
            p.nonnegative_slacks.append(o.s_x_l)
        if up:
            p.equalities.append(EqualityConstraint(
                o.x + o.s_x_u, o.u_x, o.lambda_sxu))
            p.bound_duals.append(o.lambda_sxu)
            p.nonnegative_slacks.append(o.s_x_u)
    else:
        raise ValueError(settings.inequality_handling)


def _add_log_barriers(p: Problem, o: SymbolTable, settings: Settings,
                      stage: ProblemStage) -> None:
    """Replace remaining bounds / nonnegative slacks with -mu e^T log terms."""
    with_barriers = stage == ProblemStage.SLACKED_WITH_BARRIERS
    if not (with_barriers or stage == ProblemStage.FOR_OPTIMALITY_CONDITIONS):
        return
    assert not p.inequalities
    ineq_set = {o.s_A_ineq, o.s_A_ineq_l, o.s_A_ineq_u}
    eq_set = {o.s_A_eq, o.s_A_eq_l, o.s_A_eq_u}
    var_set = {o.x, o.s_x_l, o.s_x_u}

    def get_e(expr: Expr) -> Expr:
        if expr in var_set:
            return o.e_var
        if expr in ineq_set:
            return o.e_ineq
        if expr in eq_set:
            return o.e_eq
        raise KeyError(expr)

    def replace_bound(b: BoundConstraint) -> bool:
        # When deriving optimality conditions with Slacks handling, the box
        # bound on the slack stays explicit (its dual rows are added in
        # newton.py) instead of becoming a barrier.
        is_eq = b.expr in eq_set
        return (with_barriers or
                (not is_eq and settings.inequality_handling !=
                 InequalityHandling.SLACKS) or
                (is_eq and settings.equality_handling !=
                 EqualityHandling.SLACKS))

    for b in p.variable_bounds:
        if replace_bound(b):
            eT = E.transpose(get_e(b.expr))
            if b.lower is not None:
                p.objective = p.objective - E.product(
                    [o.mu, eT, E.log(b.expr - b.lower)]).simplify()
            if b.upper is not None:
                p.objective = p.objective - E.product(
                    [o.mu, eT, E.log(b.upper - b.expr)]).simplify()
    for slack in p.nonnegative_slacks:
        eT = E.transpose(get_e(slack))
        p.objective = p.objective - E.product(
            [o.mu, eT, E.log(slack)]).simplify()
    p.variable_bounds = [b for b in p.variable_bounds if not replace_bound(b)]
    if with_barriers:
        p.nonnegative_slacks = []


def lagrangian(p: Problem) -> Expr:
    """Objective plus multiplier terms for all remaining constraints."""
    terms = [p.objective]
    for bounds in (p.inequalities, p.variable_bounds):
        for b in bounds:
            assert b.lower_dual is not None or b.upper_dual is not None
            if b.lower is not None:
                assert b.lower_dual is not None
                terms.append(E.negate(E.product(
                    [E.transpose(b.lower_dual),
                     b.expr - b.lower])).simplify())
            if b.upper is not None:
                assert b.upper_dual is not None
                terms.append(E.negate(E.product(
                    [E.transpose(b.upper_dual),
                     b.upper - b.expr])).simplify())
    for eq in p.equalities:
        terms.append(E.product(
            [E.transpose(eq.dual), eq.expr - eq.rhs]).simplify())
    return E.sum_expr(terms)
