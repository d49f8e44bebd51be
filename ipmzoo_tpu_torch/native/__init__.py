"""Native host tier (counterpart of :mod:`ipmzoo_tpu.native`): C++ dense
factorisations through ctypes, numpy in and numpy out.

The shared library is compiled with g++ at first use from
``linear_solvers.cpp`` into the port's build directory (see
:mod:`.native`), never into the package.  It provides the host
implementations of the factorisations the card runs as K2/K3 (unpivoted
LDL^T with pivot floor) and of Bunch-Kaufman (symmetric indefinite), a
yardstick for the device kernels independent of their plain torch
versions, and host-side solves.
"""

from .native import (NativeLinearSolvers, available, build_info,
                     bunch_kaufman_factor, bunch_kaufman_solve, ldlt_factor,
                     ldlt_factor_solve_batch, ldlt_solve)

__all__ = ["NativeLinearSolvers", "available", "bunch_kaufman_factor",
           "bunch_kaufman_solve", "ldlt_factor", "ldlt_factor_solve_batch",
           "ldlt_solve", "build_info"]
