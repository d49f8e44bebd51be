"""Float32 precision policy of the port.

The rule is the reference's (:mod:`ipmzoo_tpu.utils.precision`): f32
means full f32.  On NVIDIA cards a float32 matmul or convolution may run
in TF32, which keeps about three decimal digits; an interior-point
solver whose convergence tests assert duality gaps of 1e-6 cannot take
that.  :func:`apply_default_matmul_precision` turns TF32 off for cuBLAS
matmuls and cuDNN and pins ``torch.set_float32_matmul_precision`` to
``"highest"``.  Importing :mod:`ipmzoo_tpu_torch.models`,
:mod:`ipmzoo_tpu_torch.parallel` or :mod:`ipmzoo_tpu_torch.ops` applies
it, once per process.

A caller who wants the throughput-over-accuracy trade back sets the
environment variable ``IPMZOO_MATMUL_PRECISION`` before importing
(``default`` leaves torch as it is; ``high`` / ``medium`` are passed to
``torch.set_float32_matmul_precision``), or changes torch's settings
after the import: the module only sets process-wide defaults, it wraps
no call.  A process that has already moved torch's matmul precision
away from its default before the import is left alone.
"""

from __future__ import annotations

import os
import warnings

import torch

_APPLIED = False


def apply_default_matmul_precision() -> None:
    """Full-f32 matmuls and convolutions (idempotent, env-overridable).

    Runs once per process; respects a choice made through
    ``IPMZOO_MATMUL_PRECISION`` or by having set torch's float32 matmul
    precision already (anything but torch's own default, "highest"
    without TF32, is left alone)."""
    global _APPLIED
    if _APPLIED:
        return
    _APPLIED = True
    want = os.environ.get("IPMZOO_MATMUL_PRECISION", "highest").lower()
    if want in ("", "default", "none"):
        return
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        return  # the process already chose; don't fight it
    if want == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return
    if want not in ("high", "medium"):
        # a typo in the variable must not break the import of the package
        warnings.warn(
            f"IPMZOO_MATMUL_PRECISION={want!r} not accepted (expected "
            "'highest', 'high', 'medium' or 'default'); leaving the matmul "
            "precision at its default", stacklevel=2)
        return
    torch.set_float32_matmul_precision(want)
