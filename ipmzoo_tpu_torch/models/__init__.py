"""Batched solvers of the port: the symbolic systems evaluated eagerly on
torch tensors."""

from ..utils.precision import apply_default_matmul_precision

apply_default_matmul_precision()
del apply_default_matmul_precision

from .arrow import ArrowIPM, ArrowQPData, ArrowSolveResult
from .data import QPData, validate
from .fused import FusedBatchedIPM
from .ipm import CompiledIPM, IPMState, SolveResult
from .mpc import MPCData, MPCSolveResult, RiccatiIPM

__all__ = ["QPData", "validate", "CompiledIPM", "FusedBatchedIPM",
           "IPMState", "SolveResult", "ArrowIPM", "ArrowQPData",
           "ArrowSolveResult", "RiccatiIPM", "MPCData", "MPCSolveResult"]
