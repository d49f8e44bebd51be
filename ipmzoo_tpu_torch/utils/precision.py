"""Float32 precision policy of the port.

The rule is the reference's (:mod:`ipmzoo_tpu.utils.precision`): f32
means full f32.  On NVIDIA cards a float32 matmul or convolution may run
in TF32, which keeps about three decimal digits; an interior-point
solver whose convergence tests assert duality gaps of 1e-6 cannot take
that.  :func:`apply_default_matmul_precision` turns TF32 off for cuBLAS
matmuls and cuDNN and pins ``torch.set_float32_matmul_precision`` to
``"highest"``.  ``CompiledIPM`` applies it on construction.
"""

from __future__ import annotations

import torch


def apply_default_matmul_precision() -> None:
    """Full-f32 matmuls and convolutions (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
