"""Kernel K1, the fused whole-solve IPM: the ctypes wrapper.

K1's source is generated per formulation (``models/fused_source.py``
prints it around ``csrc/fused_ipm.cuh``), built with nvcc at first use
and loaded here.  :func:`fused_soa` takes SoA tensors on a CUDA device
(batch on the last axis, as the solver lays them out), allocates the
outputs and launches K1 once on the current stream (:func:`call` packs
the arguments; the tests call it on a host build of the same source).  It never falls back
to the plain version: tensors off the card, a failed build or a failed
launch raise.  The plain version is
``models/fused.py:FusedBatchedIPM._fused_plain``; the solver calls it for
CPU tensors.

Kernel T3 (the prefixes of one fused iteration,
``models/fused_phases.py``) is generated around the same header and is
launched here the same way: :func:`phase_soa`, with :func:`bind_phase` /
:func:`call_phase` for a host build.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build

#: kernel launches since the last :func:`reset_launch_counts`
launches = {"fused": 0, "phase": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def library(source: str, name: str = "fused_ipm") -> ctypes.CDLL:
    """The built and loaded library of the generated ``source`` (built at
    first use): K1 under its default name, a prefix of T3 under
    ``fused_phase``."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = _LIBS[source] = _build.load_generated(name, source)
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dtype} "
                         f"on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bind(lib: ctypes.CDLL, dtype: torch.dtype):
    """K1's entry point in ``lib`` for ``dtype``, with its ctypes
    signature."""
    if dtype not in _SUFFIX:
        raise TypeError(f"K1 takes float32/float64, not {dtype}")
    fn = getattr(lib, f"ipmzoo_fused_{_SUFFIX[dtype]}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr, i32, i32,
                   i32, ptr]
    fn.restype = i32
    return fn


def call(fn, data: Sequence[torch.Tensor],
         warm: Optional[Tuple[torch.Tensor, ...]], n: int, total: int,
         max_iter: int, gondzio: int, params: Sequence[float], stream=None):
    """Check the SoA tensors, allocate the outputs on their device and call
    K1's entry point ``fn`` once; returns the outputs and the entry's
    status (a cudaError for the CUDA build, 0 for a host build).

    ``data``: the nine QPData fields (Q, c, A_ineq, l_A_ineq, u_A_ineq,
    A_eq, b_eq, l_x, u_x) as contiguous (..., B) tensors; ``warm``: None
    or (variables (total, B), mu (1, B), iterations (1, B)); ``params``:
    (tol, mu0, delta0, pivot_floor, mu_floor, fraction_to_boundary).
    Outputs: x (n, B), variables (total, B), and iterations, residual,
    gap, mu (each (1, B))."""
    dtype, device = data[0].dtype, data[0].device
    B = data[0].shape[-1]
    for i, t in enumerate(data):
        _check(f"data[{i}]", t, t.shape[:-1] + (B,), dtype, device)
    outs = tuple([torch.empty((n, B), dtype=dtype, device=device),
                  torch.empty((total, B), dtype=dtype, device=device)] +
                 [torch.empty((1, B), dtype=dtype, device=device)
                  for _ in range(4)])
    if B == 0:
        return outs, 0
    if warm is not None:
        for name, t, shape in zip(("variables", "mu", "iterations"), warm,
                                  ((total, B), (1, B), (1, B))):
            _check(f"warm {name}", t, shape, dtype, device)
        v0, mu0, it0 = (t.data_ptr() for t in warm)
    else:
        v0 = mu0 = it0 = None
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() if t.numel() else None
                                   for t in data))
    out_ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in outs))
    prm = (_CTYPE[dtype] * 6)(*params)
    err = fn(ptrs, v0, mu0, it0, out_ptrs, B, prm, max_iter,
             int(warm is not None), gondzio, stream)
    return outs, err


def fused_soa(source: str, data: Sequence[torch.Tensor],
              warm: Optional[Tuple[torch.Tensor, ...]], n: int, total: int,
              max_iter: int, gondzio: int, params: Sequence[float]):
    """Launch K1, built from ``source``, on SoA tensors of one CUDA device
    (arguments and outputs as :func:`call`) on the current stream."""
    device = data[0].device
    if device.type != "cuda":
        raise ValueError(f"K1 needs CUDA tensors, got {device}")
    fn = bind(library(source), data[0].dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        outs, err = call(fn, data, warm, n, total, max_iter, gondzio, params,
                         stream)
    if err:
        raise RuntimeError(f"K1 (fused IPM) launch failed: cudaError {err}")
    if data[0].shape[-1]:   # an empty batch launches nothing
        launches["fused"] += 1
    return outs


def bind_phase(lib: ctypes.CDLL, dtype: torch.dtype):
    """T3's entry point in ``lib`` for ``dtype``, with its ctypes
    signature."""
    if dtype not in _SUFFIX:
        raise TypeError(f"T3 takes float32/float64, not {dtype}")
    fn = getattr(lib, f"ipmzoo_phase_{_SUFFIX[dtype]}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ptr, i32, i32, ptr]
    fn.restype = i32
    return fn


def call_phase(fn, data: Sequence[torch.Tensor], params: Sequence[float],
               reps: int = 1, perturb: int = 0, stream=None):
    """Check the SoA data (as :func:`call`), allocate (acc, sink), each
    (1, B), on its device and call T3's entry point ``fn`` once; returns
    the outputs and the entry's status."""
    dtype, device = data[0].dtype, data[0].device
    B = data[0].shape[-1]
    for i, t in enumerate(data):
        _check(f"data[{i}]", t, t.shape[:-1] + (B,), dtype, device)
    outs = (torch.zeros((1, B), dtype=dtype, device=device),
            torch.zeros((1, B), dtype=dtype, device=device))
    if B == 0:
        return outs, 0
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() if t.numel() else None
                                   for t in data))
    prm = (_CTYPE[dtype] * 6)(*params)
    err = fn(ptrs, outs[0].data_ptr(), outs[1].data_ptr(), B, prm, reps,
             perturb, stream)
    return outs, err


def phase_soa(source: str, data: Sequence[torch.Tensor],
              params: Sequence[float], reps: int = 1, perturb: int = 0):
    """Launch the prefix of T3 built from ``source`` on SoA tensors of one
    CUDA device on the current stream; (acc, sink), each (1, B)."""
    device = data[0].device
    if device.type != "cuda":
        raise ValueError(f"T3 needs CUDA tensors, got {device}")
    fn = bind_phase(library(source, "fused_phase"), data[0].dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        outs, err = call_phase(fn, data, params, reps, perturb, stream)
    if err:
        raise RuntimeError(f"T3 (fused phases) launch failed: cudaError "
                           f"{err}")
    if data[0].shape[-1]:
        launches["phase"] += 1
    return outs
