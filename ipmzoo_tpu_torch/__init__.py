"""ipmzoo_tpu_torch — the PyTorch/CUDA port of :mod:`ipmzoo_tpu`.

It imports torch, never jax, and nothing of the JAX package: the
device-free layers it needs are its own copies.  Every entry point runs on
the CUDA device unless the caller passes ``device="cpu"``.  Module names
mirror the JAX package's:

* :mod:`ipmzoo_tpu_torch.symbolic`, :mod:`ipmzoo_tpu_torch.formulations`
  — the expression engine and the formulation lattice (Settings -> Newton
  system -> reductions), pure Python.
* :mod:`ipmzoo_tpu_torch.models` — ``CompiledIPM`` (batched Mehrotra
  solver; dense LDL^T, block Cholesky, normal-equations, regularised
  LDL^T and LU modes, and nested dissection for general sparsity,
  ``kernel="nd"``), ``QPData``, the QP ``families``, the compaction
  engine, and
  ``FusedBatchedIPM`` (the fused whole-solve engine, kernel K1 generated
  from the symbolic derivation), ``ArrowIPM`` (banded+arrow box QPs
  over the cyclic-reduction kernels K6/K7), and ``RiccatiIPM`` (MPC
  over a batched Riccati factor/solve, :mod:`.ops.riccati`).
* :mod:`ipmzoo_tpu_torch.parallel` — meshes over ``torch.distributed``
  (one rank a process, gloo or NCCL), the multi-process launch, the dp
  scaling report and the dry run, and ``SchurIPM``, the block-separable
  coupled-QP engine (Schur complements over K2/K3/K4), on one device or
  with its blocks over a mesh axis (``solve_sharded``).
* :mod:`ipmzoo_tpu_torch.ops` — batched LDL^T factor, solve, multi-rhs
  solve and fused factor + multi-rhs solve: CUDA kernels
  (``csrc/ldlt.cu``) with plain torch versions for CPU tensors; the
  panel-blocked LDL^T over K2 (``blocked_ldlt``) and the block Cholesky
  eliminations (``block_solve``, ``blockg``); the
  nested-dissection factorisation over them (``ndiss``); K1's build and
  launch (``cuda_fused``); the
  banded+arrow factorisation (``banded``) with whole-reduction block
  cyclic reduction, factor and solve (``csrc/cr.cu``, ``cuda_cr``, plain
  versions in ``cr``).
* :mod:`ipmzoo_tpu_torch.utils` — the float32 precision policy, the
  default device, timers (``Timer``, ``cuda_time``, ``slope``,
  ``device_trace``), ``solve_summary`` / ``IterationTrace`` and the
  ``.npz`` checkpoints of solver states.
* the measurement kernels: the FMA-chain ceiling and the in-kernel
  factor / solve repetitions (``csrc/roofline.cu``,
  :mod:`ipmzoo_tpu_torch.ops.cuda_roofline`) and the prefixes of one
  fused iteration (``models/fused_phases.py``), driven by
  ``chip_roofline.py``, ``chip_phases.py`` and ``bench_torch.py`` at the
  repository root.
"""

__version__ = "0.1.0"

from .formulations import (Bounds, EqualityHandling,  # noqa: E402
                           InequalityHandling, Settings, VariableNames)


def __getattr__(name):
    # torch-heavy imports stay lazy
    if name in ("CompiledIPM", "FusedBatchedIPM", "QPData", "SolveResult",
                "IPMState", "ArrowIPM", "ArrowQPData", "ArrowSolveResult",
                "RiccatiIPM", "MPCData", "MPCSolveResult"):
        from . import models
        return getattr(models, name)
    if name == "SchurIPM":
        from .parallel import SchurIPM
        return SchurIPM
    raise AttributeError(name)
