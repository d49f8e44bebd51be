"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library at first use and
loaded with ``ctypes``.  Libraries land in ``build/ipmzoo_tpu_torch/``
beside the package (or in the directory that the environment variable
``IPMZOO_TORCH_BUILD_DIR`` names, for an installed package), under a
name keyed by a hash of the source, of every ``csrc/*.cuh`` header it
may include, and of the flags, so an edited source or header is rebuilt
and an unchanged one is reused.
A generated source (kernel K1, printed per formulation by
``models/fused_source.py``) is written into the same directory, keyed by
a hash of its text and the flags, and built the same way.

The flags keep IEEE arithmetic: no ``--use_fast_math``, ``-ftz=true`` or
``-prec-div=false``.  The kernels' exact-zero pivot test and divisions
must agree with their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: names the build directory; unset or empty means ``build/ipmzoo_tpu_torch``
#: beside the package
BUILD_DIR_ENV = "IPMZOO_TORCH_BUILD_DIR"


def resolve_build_dir() -> Path:
    named = os.environ.get(BUILD_DIR_ENV)
    if named:
        return Path(named).expanduser().resolve()
    return Path(__file__).resolve().parents[2] / "build" / "ipmzoo_tpu_torch"


BUILD_DIR = resolve_build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin",
                                                     "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                           "CUDA kernels cannot be built")
    return path


def _keyed_path(name: str, text: bytes) -> Path:
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def _headers(csrc: Path) -> bytes:
    """Every ``*.cuh`` of ``csrc``, name and text, in name order."""
    return b"".join(p.name.encode() + b"\0" + p.read_bytes() + b"\0"
                    for p in sorted(csrc.glob("*.cuh")))


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: keyed by the source, by
    the headers beside it and by the flags."""
    return _keyed_path(name, (csrc / f"{name}.cu").read_bytes()
                       + _headers(csrc))


def generated_library_path(name: str, text: str) -> Path:
    return _keyed_path(name, text.encode())


def _build(src: Path, out: Path, what: str) -> None:
    """nvcc ``src`` into ``out``; nvcc's report (registers, stack frame,
    spills) is kept beside the library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it.
    Raises ``RuntimeError`` carrying nvcc's output when the build
    fails."""
    out = library_path(name)
    if not out.exists():
        _build(CSRC / f"{name}.cu", out, f"csrc/{name}.cu")
    return ctypes.CDLL(str(out))


def load_generated(name: str, text: str) -> ctypes.CDLL:
    """Write the generated source ``text`` beside its library (``.cu``),
    build it if the library is missing, then load it.  Raises
    ``RuntimeError`` carrying nvcc's output when the build fails."""
    out = generated_library_path(name, text)
    if not out.exists():
        src = out.with_suffix(".cu")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        _build(src, out, f"generated {src.name}")
    return ctypes.CDLL(str(out))


def ptxas_report(lib: Path):
    """What ptxas said of each kernel of a built library, from the
    ``.log`` kept beside it: a list of dicts with the (mangled) entry
    ``name``, ``registers``, ``stack`` (bytes of stack frame),
    ``spill_stores`` and ``spill_loads`` (bytes)."""
    out, cur = [], None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1), "registers": None, "stack": 0,
                   "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def ptxas_shared(lib: Path):
    """Bytes of static shared memory ptxas reports for each kernel of a
    built library (its ``.log``), by (mangled) entry name; a kernel whose
    line names none takes 0."""
    out, cur = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
            continue
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur is not None:
            out[cur] = int(m.group(1))
    return out
