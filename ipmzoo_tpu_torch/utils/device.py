"""Default device of the port's entry points.

The port is written for the card: every entry point that takes a
``device`` defaults to ``None``, which means ``torch.device("cuda")``.
Without a CUDA device that raises torch's own error; nothing carries on
on the CPU unless the caller passes ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA
    device, probed with an empty allocation so that a machine without one
    raises here and not at the first tensor."""
    if device is not None:
        return torch.device(device)
    dev = torch.device("cuda")
    torch.empty(0, device=dev)
    return dev


def nvidia_smi(fields: str = "name,power.limit") -> str:
    """What ``nvidia-smi --query-gpu=<fields> --format=csv,noheader``
    reads of the first card: by default its name and power limit, which
    belong beside every time measured on it."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
