"""Utilities of the port: the float32 precision policy, the default
device, timers, solve logging and checkpoints."""

from .checkpoint import load_metadata, load_state, save_state
from .device import resolve_device
from .logging import IterationRecord, IterationTrace, solve_summary
from .precision import apply_default_matmul_precision
from .timer import (Timer, Timing, cuda_time, device_trace, host_time,
                    slope)

__all__ = ["apply_default_matmul_precision", "resolve_device", "Timer",
           "Timing", "cuda_time", "host_time", "slope", "device_trace",
           "solve_summary", "IterationTrace", "IterationRecord",
           "save_state", "load_state", "load_metadata"]
