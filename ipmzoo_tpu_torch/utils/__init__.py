"""Utilities of the port: the float32 precision policy and the default
device."""

from .device import resolve_device
from .precision import apply_default_matmul_precision

__all__ = ["apply_default_matmul_precision", "resolve_device"]
