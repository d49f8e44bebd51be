"""Multi-device execution (counterpart of :mod:`ipmzoo_tpu.parallel`):
meshes over ``torch.distributed`` with their collectives and sharded
batches, the multi-process launch, the dp scaling report, and
``SchurIPM``, the block-separable coupled-QP engine, on one device or
with its blocks over a mesh axis."""

from ..utils.precision import apply_default_matmul_precision

apply_default_matmul_precision()
del apply_default_matmul_precision

from .mesh import batch_sharding, make_mesh, replicated
from .schur import BlockQPData, SchurIPM, SchurResult, SchurState

__all__ = ["batch_sharding", "make_mesh", "replicated", "BlockQPData",
           "SchurIPM", "SchurResult", "SchurState"]
