"""Device kernels of the port: batched LDL^T factor and solve (CUDA
kernels K2/K3/K4/K5 with plain torch versions), the panel-blocked LDL^T
over K2 (:mod:`.blocked_ldlt`), the block Cholesky eliminations of the
'block' / 'blockg' modes (:mod:`.block_solve`, :mod:`.blockg`), the
nested-dissection
factorisation over them (:mod:`.ndiss`), the wrapper of the fused
whole-solve kernel K1 (:mod:`.cuda_fused`; its plain version is
``models/fused.py``), and the banded+arrow factorisation (:mod:`.banded`)
over whole-reduction block cyclic reduction (CUDA kernels K6/K7 in
:mod:`.cuda_cr`, plain versions in :mod:`.cr`), and the panel-sharded
LDL^T of one KKT system over a mesh axis (:mod:`.sharded_ldlt`, its
diagonal panels on K2)."""

from ..utils.precision import apply_default_matmul_precision

apply_default_matmul_precision()
del apply_default_matmul_precision

from .banded import (arrow_factor, arrow_solve, bt_factor, bt_solve,
                     cr_factor, cr_solve, detect_arrow)
from .cuda_ldlt import (launches, ldlt_auto, reset_launch_counts,
                        solve_ldlt_auto)
from .ldlt import PIVOT_FLOOR, cholesky_solve, ldlt, ldlt_solve, solve_ldlt
from .sharded_ldlt import shard_kkt, sharded_ldlt, sharded_ldlt_solve

__all__ = ["PIVOT_FLOOR", "ldlt", "solve_ldlt", "ldlt_solve",
           "cholesky_solve", "ldlt_auto", "solve_ldlt_auto", "launches",
           "reset_launch_counts", "arrow_factor", "arrow_solve", "bt_factor",
           "bt_solve", "cr_factor", "cr_solve", "detect_arrow", "shard_kkt",
           "sharded_ldlt", "sharded_ldlt_solve"]
