"""LaTeX renderers for problems, Lagrangians, KKT conditions and Newton
systems (the port's own copy of :mod:`ipmzoo_tpu.frontend.latex`, over
the port's :mod:`..formulations` and :mod:`..symbolic`).

These provide the same presentation layer as the C++ original's web
bindings (``src/wasm_bindings.cpp:33-249``): aligned LaTeX with
cosmetic rewrites (1 -> I, mu -> mu I, delta -> delta I,
(delta I)^2 -> delta^2 I in matrix cells) and heuristic line breaking of
long objective rows.
"""

from __future__ import annotations

import dataclasses

from ..formulations import (ProblemStage, Settings, VariableNames,
                            augmented_system, build_problem,
                            first_order_conditions, lagrangian,
                            newton_system, normal_equations, shorthand_rhs)
from ..symbolic import expr as E


@dataclasses.dataclass
class NewtonSystemLatex:
    lhs: str
    rhs: str
    rhs_shorthand: str
    variables: str
    delta_definitions: str


@dataclasses.dataclass
class NewtonSystemsLatex:
    full: NewtonSystemLatex
    augmented: NewtonSystemLatex
    normal: NewtonSystemLatex


def _cosmetic(cell: E.Expr, names: VariableNames) -> E.Expr:
    """Identity-matrix cosmetics for displayed matrix cells."""
    unity = E.number(1)
    I = E.named_vector("I")
    mu = E.named_scalar("\\mu")
    muI = E.product([mu, I])
    delta = E.named_scalar(names.delta_eq)
    delta2 = E.named_scalar(names.delta_eq + "^2")
    deltaI = E.product([delta, I])
    deltaI2 = E.product([deltaI, deltaI]).simplify()
    delta2I = E.product([delta2, I]).simplify()
    cell = cell.replace(unity, I)
    cell = cell.replace(mu, muI)
    cell = cell.replace(delta, deltaI).simplify()
    cell = cell.replace(deltaI2, delta2I)
    return cell


def render_newton_system(ns, names: VariableNames = VariableNames(),
                         cosmetics: bool = True) -> NewtonSystemLatex:
    lhs_rows = []
    for row in ns.lhs:
        cells = [(_cosmetic(c, names) if cosmetics else c).to_string(True)
                 for c in row]
        lhs_rows.append(" & ".join(cells))
    lhs = " \\\\\n ".join(lhs_rows) + (" \\\\\n " if lhs_rows else "")

    rhs = " \\\\\n ".join(r.to_string(True) for r in ns.rhs)
    rhs += " \\\\\n " if ns.rhs else ""

    sh = shorthand_rhs(ns)
    rhs_short = " \\\\\n ".join(r.to_string(True) for r in sh.shorthand_rhs)
    rhs_short += " \\\\\n " if sh.shorthand_rhs else ""

    variables = " \\\\\n ".join("\\Delta " + v.to_string(True)
                                for v in ns.variables)
    variables += "\n" if ns.variables else ""

    defs = []
    for dvar, ddef in reversed(ns.delta_definitions):
        defs.append(f"{dvar.to_string(True)} &= {ddef.to_string(True)}")
    delta_definitions = " \\\\\n ".join(defs)
    delta_definitions += "\n" if defs else ""

    return NewtonSystemLatex(lhs, rhs, rhs_short, variables,
                             delta_definitions)


def render_newton_systems(settings: Settings,
                          names: VariableNames = VariableNames()
                          ) -> NewtonSystemsLatex:
    """Render full/augmented/normal systems the way the reference web
    bindings do (``wasm_bindings.cpp:214-249``): the full
    system's rhs is swapped for its shorthand (-r_{var} symbols) *before*
    the reductions, so the displayed reduced rhs and delta definitions are
    expressed in terms of the r vectors rather than raw residuals."""
    full = newton_system(settings, names)
    full_tex = render_newton_system(full, names)

    sh = shorthand_rhs(full)
    full_short = full.copy()
    full_short.rhs = list(sh.shorthand_rhs)

    aug = augmented_system(full_short)
    aug_tex = render_newton_system(aug, names)
    normal = normal_equations(full_short)
    normal_tex = render_newton_system(normal, names)
    if len(aug.variables) == len(normal.variables):
        # reference quirk (wasm_bindings.cpp:239-241): when no further
        # reduction happened, the web page shows only the normal system.
        aug_tex.variables = ""
    return NewtonSystemsLatex(full=full_tex, augmented=aug_tex,
                              normal=normal_tex)


def _add_newlines(s: str, term: str) -> str:
    """Insert an aligned line break before occurrences 1, 4, 7, ... of term.

    Matches the reference's heuristic exactly (wasm_bindings.cpp:107-118):
    after inserting, its scan re-finds the occurrence it just broke at, so
    the effective cadence is every third occurrence, starting at the first.
    """
    out = []
    pos = 0
    count = 0
    while True:
        i = s.find(term, pos)
        if i < 0:
            out.append(s[pos:])
            break
        count += 1
        if count % 3 == 1 and i > 0:
            out.append(s[pos:i - 1])
            out.append(" \\\\\n & ")
            out.append(s[i - 1:i])
        else:
            out.append(s[pos:i])
        out.append(term)
        pos = i + len(term)
    return "".join(out)


def render_problem(settings: Settings,
                   stage: ProblemStage = ProblemStage.SLACKED,
                   names: VariableNames = VariableNames()) -> str:
    p = build_problem(settings, names, stage)
    s = "\\text{minimize} \\quad & " + p.objective.to_string(True)
    s = _add_newlines(s, "\\lambda")
    s = _add_newlines(s, "- \\mu")
    s += " \\\\\n \\text{subject to} \\quad"

    def bound_lines(bounds):
        lines = []
        for b in bounds:
            if b.lower is not None and b.upper is not None:
                lines.append(f" & {b.lower.to_string(True)} \\leq "
                             f"{b.expr.to_string(True)} \\leq "
                             f"{b.upper.to_string(True)} \\\\\n")
            elif b.lower is not None:
                lines.append(f" & {b.expr.to_string(True)} \\geq "
                             f"{b.lower.to_string(True)} \\\\\n")
            elif b.upper is not None:
                lines.append(f" & {b.expr.to_string(True)} \\leq "
                             f"{b.upper.to_string(True)} \\\\\n")
        return lines

    parts = bound_lines(p.inequalities)
    for eq in p.equalities:
        parts.append(f" & {eq.expr.to_string(True)} = "
                     f"{eq.rhs.to_string(True)} \\\\\n")
    parts.extend(bound_lines(p.variable_bounds))
    if p.nonnegative_slacks:
        slacks = ", ".join(sl.to_string(True)
                           for sl in p.nonnegative_slacks)
        parts.append(f" & {slacks} \\geq 0 \\\\\n")
    return s + "".join(parts)


def render_lagrangian(settings: Settings,
                      names: VariableNames = VariableNames()) -> str:
    p = build_problem(settings, names, ProblemStage.SLACKED_WITH_BARRIERS)
    s = "& " + lagrangian(p).to_string(True)
    s = _add_newlines(s, "\\lambda")
    s = _add_newlines(s, "- \\mu")
    return s


def render_first_order_conditions(settings: Settings,
                                  names: VariableNames = VariableNames()
                                  ) -> str:
    conditions, _ = first_order_conditions(settings, names)
    return "".join(c.to_string(True) + " &= 0 \\\\" for c in conditions)
