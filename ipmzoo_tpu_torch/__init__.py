"""ipmzoo_tpu_torch — the PyTorch/CUDA port of :mod:`ipmzoo_tpu`.

It reuses the device-free layers of the JAX package
(:mod:`ipmzoo_tpu.symbolic`, :mod:`ipmzoo_tpu.formulations`) and never
imports jax.  Module names mirror the JAX package's:

* :mod:`ipmzoo_tpu_torch.models` — ``CompiledIPM`` (batched Mehrotra
  solver, dense LDL^T mode), ``QPData``, the compaction engine, and
  ``FusedBatchedIPM`` (the fused whole-solve engine, kernel K1 generated
  from the symbolic derivation).
* :mod:`ipmzoo_tpu_torch.parallel` — ``SchurIPM``, the block-separable
  coupled-QP engine (Schur complements over K2/K3/K4), on one device.
* :mod:`ipmzoo_tpu_torch.ops` — batched LDL^T factor, solve and
  multi-rhs solve: CUDA kernels (``csrc/ldlt.cu``) with plain torch
  versions for CPU tensors; K1's build and launch (``cuda_fused``).
* :mod:`ipmzoo_tpu_torch.utils` — the float32 precision policy.
"""

__version__ = "0.1.0"

from ipmzoo_tpu.formulations import (Bounds, EqualityHandling,  # noqa: E402
                                     InequalityHandling, Settings,
                                     VariableNames)


def __getattr__(name):
    # torch-heavy imports stay lazy
    if name in ("CompiledIPM", "FusedBatchedIPM", "QPData", "SolveResult",
                "IPMState"):
        from . import models
        return getattr(models, name)
    raise AttributeError(name)
