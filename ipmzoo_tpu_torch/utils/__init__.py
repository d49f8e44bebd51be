"""Utilities of the port: the float32 precision policy."""

from .precision import apply_default_matmul_precision

__all__ = ["apply_default_matmul_precision"]
