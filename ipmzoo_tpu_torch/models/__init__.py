"""Batched solvers of the port: the symbolic systems evaluated eagerly on
torch tensors."""

from .arrow import ArrowIPM, ArrowQPData, ArrowSolveResult
from .data import QPData, validate
from .fused import FusedBatchedIPM
from .ipm import CompiledIPM, IPMState, SolveResult

__all__ = ["QPData", "validate", "CompiledIPM", "FusedBatchedIPM",
           "IPMState", "SolveResult", "ArrowIPM", "ArrowQPData",
           "ArrowSolveResult"]
