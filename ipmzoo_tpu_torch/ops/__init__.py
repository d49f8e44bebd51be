"""Device kernels of the port: batched LDL^T factor and solve (CUDA
kernels K2/K3 with plain torch versions) and the wrapper of the fused
whole-solve kernel K1 (:mod:`.cuda_fused`; its plain version is
``models/fused.py``)."""

from .cuda_ldlt import (launches, ldlt_auto, reset_launch_counts,
                        solve_ldlt_auto)
from .ldlt import PIVOT_FLOOR, ldlt, solve_ldlt

__all__ = ["PIVOT_FLOOR", "ldlt", "solve_ldlt", "ldlt_auto",
           "solve_ldlt_auto", "launches", "reset_launch_counts"]
