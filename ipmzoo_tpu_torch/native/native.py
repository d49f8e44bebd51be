"""ctypes bridge to the native linear-solver library (the port's copy of
:mod:`ipmzoo_tpu.native.native`, numpy in and numpy out).

``linear_solvers.cpp`` is compiled with g++ at first use into the build
directory of :mod:`..ops._build` (``build/ipmzoo_tpu_torch/`` beside the
package, or ``IPMZOO_TORCH_BUILD_DIR``), never into the package, under a
name keyed by a hash of the source, the flags and (for ``-march=native``)
the host's CPU: an edited source is rebuilt, an unchanged one reused,
and a build directory shared with another kind of host is never given a
library made for that host's instruction set.  The flags are the JAX package's:
``-O3 -march=native -fopenmp``, and where that build fails, one retry
without ``-fopenmp -march=native``.  That retry is a host build option;
the library computes the same functions either way.  :func:`build_info`
says which flags built the loaded library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..ops._build import resolve_build_dir

_SRC = Path(__file__).resolve().parent / "linear_solvers.cpp"
#: g++ flags, the first choice and the one retry
FLAGS = ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared",
         "-fopenmp")
RETRY_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")
_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None
_info: dict = {}


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (Linux's ``/proc/cpuinfo``,
    else the platform's processor string): what ``-march=native``
    compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [l for l in f if l.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return platform.processor().encode()


def library_path(flags=FLAGS) -> Path:
    """Where the library built with ``flags`` goes: keyed by the source,
    the flags and, where they hold ``-march=native``, the host's CPU, in
    the build directory."""
    text = _SRC.read_bytes() + " ".join(flags).encode()
    if "-march=native" in flags:
        text += _host_cpu()
    key = hashlib.sha256(text).hexdigest()
    return resolve_build_dir() / f"linear_solvers-{key[:16]}.so"


def _compile(flags, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                       + proc.stderr)
    os.replace(tmp, out)


def _build() -> Path:
    """The library's path, built if missing: with FLAGS, or where g++
    refuses them, with RETRY_FLAGS."""
    for flags in (FLAGS, RETRY_FLAGS):
        out = library_path(flags)
        if out.exists():
            _info.update(path=str(out), flags=" ".join(flags), built=False,
                         seconds=0.0)
            return out
    t0 = time.perf_counter()
    try:
        flags = FLAGS
        _compile(flags, library_path(flags))
    except RuntimeError as e:
        _log.warning("native: %s; retrying without -fopenmp -march=native",
                     e)
        flags = RETRY_FLAGS
        _compile(flags, library_path(flags))
    out = library_path(flags)
    _info.update(path=str(out), flags=" ".join(flags), built=True,
                 seconds=time.perf_counter() - t0)
    _log.info("native: built %s with g++ %s in %.2f s", out.name,
              _info["flags"], _info["seconds"])
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.ipm_ldlt_factor.argtypes = [dp, ctypes.c_int64, dp, dp,
                                        ctypes.c_double]
        lib.ipm_ldlt_factor.restype = ctypes.c_int
        lib.ipm_ldlt_solve.argtypes = [dp, dp, dp, ctypes.c_int64]
        lib.ipm_ldlt_solve.restype = ctypes.c_int
        lib.ipm_ldlt_factor_solve_batch.argtypes = [
            dp, dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, dp]
        lib.ipm_ldlt_factor_solve_batch.restype = ctypes.c_int
        lib.ipm_bunch_kaufman_factor.argtypes = [dp, ctypes.c_int64, dp, ip]
        lib.ipm_bunch_kaufman_factor.restype = ctypes.c_int
        lib.ipm_bunch_kaufman_solve.argtypes = [dp, ip, dp, ctypes.c_int64]
        lib.ipm_bunch_kaufman_solve.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def build_info() -> dict:
    """The loaded library: ``path``, the g++ ``flags`` that built it,
    whether this process ``built`` it and in how many ``seconds`` (0 for
    a library found in the build directory)."""
    _load()
    return dict(_info)


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def ldlt_factor(A: np.ndarray, pivot_floor: float = 1e-8):
    """Return (L, D) with A = L D L^T, zero pivots floored."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    n = A.shape[0]
    L = np.zeros((n, n), np.float64)
    D = np.zeros((n,), np.float64)
    lib.ipm_ldlt_factor(_dptr(A), n, _dptr(L), _dptr(D), pivot_floor)
    return L, D


def ldlt_solve(L: np.ndarray, D: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    lib.ipm_ldlt_solve(_dptr(np.ascontiguousarray(L, np.float64)),
                       _dptr(np.ascontiguousarray(D, np.float64)),
                       _dptr(x), L.shape[0])
    return x


def ldlt_factor_solve_batch(A: np.ndarray, b: np.ndarray,
                            pivot_floor: float = 1e-8) -> np.ndarray:
    """Solve a batch: A (nb,n,n), b (nb,n) -> x (nb,n), OpenMP-parallel."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    nb, n = x.shape
    ws = np.empty((nb, n * n + n), np.float64)
    lib.ipm_ldlt_factor_solve_batch(_dptr(A), _dptr(x), nb, n, pivot_floor,
                                    _dptr(ws))
    return x


def bunch_kaufman_factor(A: np.ndarray):
    """Return (F, ipiv, info): Bunch-Kaufman factorisation of symmetric A."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    n = A.shape[0]
    F = np.zeros((n, n), np.float64)
    ipiv = np.zeros((n,), np.int64)
    info = lib.ipm_bunch_kaufman_factor(_dptr(A), n, _dptr(F), _iptr(ipiv))
    return F, ipiv, info


def bunch_kaufman_solve(F: np.ndarray, ipiv: np.ndarray,
                        b: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    lib.ipm_bunch_kaufman_solve(
        _dptr(np.ascontiguousarray(F, np.float64)),
        _iptr(np.ascontiguousarray(ipiv, np.int64)), _dptr(x), F.shape[0])
    return x


class NativeLinearSolvers:
    """Object-style facade (handy for dependency injection in tests)."""

    ldlt_factor = staticmethod(ldlt_factor)
    ldlt_solve = staticmethod(ldlt_solve)
    ldlt_factor_solve_batch = staticmethod(ldlt_factor_solve_batch)
    bunch_kaufman_factor = staticmethod(bunch_kaufman_factor)
    bunch_kaufman_solve = staticmethod(bunch_kaufman_solve)
