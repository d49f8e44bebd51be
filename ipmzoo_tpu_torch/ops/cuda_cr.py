"""Whole-reduction block cyclic reduction, factor (K6) and solve (K7):
CUDA kernels with plain torch versions.

Counterpart of :mod:`ipmzoo_tpu.ops.cr_pallas` (``cr_factor_pallas`` /
``cr_solve_pallas``).  ``cr_factor_kernel`` / ``cr_solve_kernel`` launch
the kernels of ``csrc/cr.cu`` on the current stream, one thread block per
instance of the batch, and allocate their outputs and scratch; they take
CUDA tensors only.  ``cr_factor_auto`` / ``cr_solve_auto`` launch the
kernels for CUDA tensors and run the plain versions of :mod:`.cr` for CPU
tensors.  Any other device raises; a failed build or launch raises too.
The layout of the factors is described in :mod:`.cr`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cr import CRKernelFactors, cr_factor_plain, cr_solve_plain

#: kernel launches since the last :func:`reset_launch_counts`
launches = {"cr_factor": 0, "cr_solve": 0}
#: the float64 instantiations' share of ``launches``
f64_launches = dict(launches)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: the kernels index one instance's arrays with 32-bit offsets
MAX_INSTANCE_ELEMENTS = 2 ** 31 - 1


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
        f64_launches[k] = 0


def _count(name: str, dtype: torch.dtype) -> None:
    launches[name] += 1
    if dtype == torch.float64:
        f64_launches[name] += 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cr")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in _SUFFIX.values():
        f = getattr(lib, f"ipmzoo_cr_factor_{sfx}")
        f.argtypes = [ptr] * 8 + [i32, i32, i64, ptr]
        f.restype = i32
        s = getattr(lib, f"ipmzoo_cr_solve_{sfx}")
        s.argtypes = [ptr] * 7 + [i32, i32, i32, i64, ptr]
        s.restype = i32
    return lib


def _check(dtype, device, **tensors) -> None:
    if dtype not in _SUFFIX:
        raise TypeError(f"cyclic-reduction kernels take float32/float64, "
                        f"not {dtype}")
    if device.type != "cuda":
        raise ValueError(f"K6/K7 need CUDA tensors, got {device}")
    for name, (t, shape) in tensors.items():
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")


def _check_size(N: int, b: int, k: int) -> None:
    if N * b * max(b, k) > MAX_INSTANCE_ELEMENTS:
        raise ValueError(
            f"K6/K7 index one instance with 32-bit offsets: N * b * "
            f"max(b, k) = {N * b * max(b, k)} exceeds "
            f"{MAX_INSTANCE_ELEMENTS}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def cr_factor_kernel(D: torch.Tensor, E: torch.Tensor) -> CRKernelFactors:
    """Launch K6: D (..., N, b, b), E (..., N-1, b, b) on a CUDA device ->
    factors, every level of the reduction in one launch."""
    lead, (N, b) = tuple(D.shape[:-3]), D.shape[-3:-1]
    _check(D.dtype, D.device, D=(D, lead + (N, b, b)),
           E=(E, lead + (max(N - 1, 0), b, b)))
    _check_size(N, b, b)
    B = 1
    for d in lead:
        B *= d
    D, E = D.contiguous(), E.contiguous()
    Pinv, Eb, Ea = (torch.empty_like(D) for _ in range(3))
    if N == 0 or b == 0 or B == 0:
        return CRKernelFactors(Pinv, Eb, Ea)
    # working copies of D and E and the Cholesky workspace, per instance
    Dw, Ew, Xw = (torch.empty_like(D) for _ in range(3))
    with torch.cuda.device(D.device):
        err = getattr(_lib(), f"ipmzoo_cr_factor_{_SUFFIX[D.dtype]}")(
            D.data_ptr(), E.data_ptr(), Pinv.data_ptr(), Eb.data_ptr(),
            Ea.data_ptr(), Dw.data_ptr(), Ew.data_ptr(), Xw.data_ptr(),
            N, b, B, _stream(D.device))
    if err:
        raise RuntimeError(f"cyclic-reduction factor kernel launch failed: "
                           f"cudaError {err}")
    _count("cr_factor", D.dtype)
    return CRKernelFactors(Pinv, Eb, Ea)


def cr_solve_kernel(f: CRKernelFactors, r: torch.Tensor) -> torch.Tensor:
    """Launch K7: solve against K6's factors for r (..., N, b, k) on a
    CUDA device; down-sweep, root and up-sweep in one launch."""
    lead, (N, b, k) = tuple(r.shape[:-3]), r.shape[-3:]
    shape = lead + (N, b, b)
    _check(r.dtype, r.device, Pinv=(f.Pinv, shape), Eb=(f.Eb, shape),
           Ea=(f.Ea, shape))
    _check_size(N, b, k)
    B = 1
    for d in lead:
        B *= d
    r = r.contiguous()
    Pinv, Eb, Ea = (a.contiguous() for a in f)
    x = torch.empty_like(r)
    if N == 0 or b == 0 or k == 0 or B == 0:
        return x
    # working right-hand sides and the per-level products, per instance
    Rw, Gw = torch.empty_like(r), torch.empty_like(r)
    with torch.cuda.device(r.device):
        err = getattr(_lib(), f"ipmzoo_cr_solve_{_SUFFIX[r.dtype]}")(
            Pinv.data_ptr(), Eb.data_ptr(), Ea.data_ptr(), r.data_ptr(),
            x.data_ptr(), Rw.data_ptr(), Gw.data_ptr(), N, b, k, B,
            _stream(r.device))
    if err:
        raise RuntimeError(f"cyclic-reduction solve kernel launch failed: "
                           f"cudaError {err}")
    _count("cr_solve", r.dtype)
    return x


def _dispatch(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no cyclic-reduction implementation for device "
                     f"{t.device}")


def cr_factor_auto(D: torch.Tensor, E: torch.Tensor) -> CRKernelFactors:
    """K6 for CUDA tensors, its plain version for CPU tensors."""
    if D.dim() < 3 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"expected D (..., N, b, b), got {tuple(D.shape)}")
    return cr_factor_kernel(D, E) if _dispatch(D) else cr_factor_plain(D, E)


def cr_solve_auto(f: CRKernelFactors, r: torch.Tensor) -> torch.Tensor:
    """K7 for CUDA tensors, its plain version for CPU tensors."""
    if r.dim() < 3:
        raise ValueError(f"expected r (..., N, b, k), got {tuple(r.shape)}")
    return cr_solve_kernel(f, r) if _dispatch(r) else cr_solve_plain(f, r)
