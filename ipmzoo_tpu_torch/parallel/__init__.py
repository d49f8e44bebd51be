"""Structure-parallel solvers (counterpart of :mod:`ipmzoo_tpu.parallel`):
``SchurIPM``, the block-separable coupled-QP engine, on one device."""

from ..utils.precision import apply_default_matmul_precision

apply_default_matmul_precision()
del apply_default_matmul_precision

from .schur import BlockQPData, SchurIPM, SchurResult, SchurState

__all__ = ["BlockQPData", "SchurIPM", "SchurResult", "SchurState"]
