"""The IPM formulation lattice and symbolic derivation pipeline."""

from .settings import (Bounds, EqualityHandling, InequalityHandling,
                       ProblemStage, Settings, VariableNames)
from .problem import (BoundConstraint, EqualityConstraint, Problem,
                      SymbolTable, build_problem, build_symbols, lagrangian)
from .newton import (NewtonSystem, ShorthandRhs, augmented_system,
                     delta_definition, delta_variable, first_order_conditions,
                     gaussian_elimination, newton_system, normal_equations,
                     shorthand_rhs)

__all__ = [
    "Bounds", "EqualityHandling", "InequalityHandling", "ProblemStage",
    "Settings", "VariableNames", "BoundConstraint", "EqualityConstraint",
    "Problem", "SymbolTable", "build_problem", "build_symbols", "lagrangian",
    "NewtonSystem", "ShorthandRhs", "augmented_system", "delta_definition",
    "delta_variable", "first_order_conditions", "gaussian_elimination",
    "newton_system", "normal_equations", "shorthand_rhs",
]
