"""The roofline measurement kernels T1, T2a and T2b: wrappers, plain
versions and the sweeps that read them.

Counterpart of the kernels of ``tools/roofline.py`` (``_fma_kernel``,
``_factor_bench_kernel``, ``_solve_bench_kernel``) and of its
``vpu_peak``, ``_bench_inkernel``, ``fused_flops`` and ``quasidef_tile``.
The CUDA sources are ``csrc/roofline.cu`` (which includes
``csrc/fused_ipm.cuh`` and ``csrc/fused_team.cuh``: T2 repeats the
very ``ldlt_packed`` and ``ldlt_solve_packed`` of K1's thread route, or
``team_ldlt`` and ``team_ldlt_solve`` of its team route).

* :func:`fma_chains` (T1): ``chains`` independent accumulators per
  element, ``reps`` dependent ``acc = acc * a + x`` rounds each, their
  sum.  :func:`fma_peak` sweeps the launch shape and the chains on the
  card and reports the best multiply-add rate.
* :func:`factor_reps` (T2a) and :func:`solve_reps` (T2b): ``reps``
  factorisations of ``K0 (1 + 1e-6 r)``, or one factorisation and
  ``reps`` solves of ``b0 (1 + 1e-6 r)``, per instance, SoA with the
  batch on the last axis.  Each has two routes, K1's: the thread route
  (one thread an instance, ``ldlt_packed`` / ``ldlt_solve_packed`` on
  the packed factor in local memory) and the team route
  (``route="team"``: a team of 16 lanes an instance, K and D in shared
  memory, ``team_ldlt`` / ``team_ldlt_solve`` of
  ``csrc/fused_team.cuh``; T2b factors once by ``team_ldlt``).  Each
  returns ``(acc, sink)``: the TPU kernel's own sum (of ``D[0]`` or
  ``x[0]``) and a sum that depends on every pivot and the last row of L
  (or on every entry of x), so that no part of the work is dead code.
  :func:`reps_slope` turns two in-kernel repetition counts into
  milliseconds per repetition; :func:`reps_team_shape` says what a team
  route's block is (bytes a team, teams resident per SM).

For CUDA tensors the wrappers launch the kernels on the current stream
and count the launch; for CPU tensors they run the plain versions, which
are torch over ``models/fused.py``'s SoA factor and solve.  Any other
device, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import _build
from .ldlt import PIVOT_FLOOR

#: kernel launches since the last :func:`reset_launch_counts`, per TPU
#: kernel (T2a and T2b on any route); ``route_launches`` counts them per
#: route
launches = {"fma_chains": 0, "factor_reps": 0, "solve_reps": 0}
route_launches = {"factor_reps thread": 0, "factor_reps team": 0,
                  "solve_reps thread": 0, "solve_reps team": 0}
#: T2a's and T2b's routes: entry-point names
_FACTOR_ENTRY = {"thread": "ipmzoo_factor_reps",
                 "team": "ipmzoo_factor_reps_team"}
_SOLVE_ENTRY = {"thread": "ipmzoo_solve_reps",
                "team": "ipmzoo_solve_reps_team"}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
#: accumulator counts and matrix orders instantiated in csrc/roofline.cu
CHAINS = (4, 8, 16)
ORDERS = (8, 24)
#: NVIDIA's data-sheet rates of one H100 SXM outside the tensor cores,
#: FLOP/s; a measured ceiling is reported as a share of these
DATA_SHEET_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}


def reset_launch_counts() -> None:
    for counts in (launches, route_launches):
        for k in counts:
            counts[k] = 0


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of ``csrc/roofline.cu``'s entry points
    on ``lib`` (the nvcc build, or a host build of the same file)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dt, sfx in _SUFFIX.items():
        f = getattr(lib, f"ipmzoo_fma_chains_{sfx}")
        f.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr]
        f.restype = i32
        for entry in _FACTOR_ENTRY.values():
            f = getattr(lib, f"{entry}_{sfx}")
            f.argtypes = [ptr, ptr, ptr, i32, i64, i32, _CTYPE[dt], ptr]
            f.restype = i32
        for entry in _SOLVE_ENTRY.values():
            f = getattr(lib, f"{entry}_{sfx}")
            f.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, _CTYPE[dt],
                          ptr]
            f.restype = i32
        f = getattr(lib, f"ipmzoo_reps_team_shape_{sfx}")
        f.argtypes = [i32, i32, ptr]
        f.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("roofline"))


def _check(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: float32/float64 only, not {t.dtype}")
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{like.dtype} on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor):
    if not t.is_cuda:       # a host build takes no stream
        return None
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# T1: chains of dependent multiply-adds
# ---------------------------------------------------------------------------

def fma_chains_plain(x: torch.Tensor, chains: int, reps: int) -> torch.Tensor:
    """T1's plain version: the reference kernel's body on a whole
    tensor."""
    a = x * 0.999 + 1e-3
    accs = torch.stack([x * (0.1 * (i + 1)) for i in range(chains)])
    for _ in range(reps):
        accs = accs * a + x
    out = accs[0]
    for acc in accs[1:]:
        out = out + acc
    return out


def fma_chains_call(lib: ctypes.CDLL, x: torch.Tensor, chains: int,
                    reps: int, threads: int = 256):
    """Check ``x``, allocate the output and call T1's entry point of
    ``lib`` once; returns (out, status)."""
    _check("x", x, x.shape, x)
    if chains not in CHAINS:
        raise ValueError(f"chains={chains}: built for {CHAINS}")
    if not 1 <= threads <= 1024:
        raise ValueError(f"threads={threads}: a block has 1 to 1024")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out, 0
    fn = getattr(lib, f"ipmzoo_fma_chains_{_SUFFIX[x.dtype]}")
    return out, fn(x.data_ptr(), out.data_ptr(), x.numel(), chains, reps,
                   threads, _stream(x))


def fma_chains(x: torch.Tensor, chains: int = 8, reps: int = 64,
               threads: int = 256) -> torch.Tensor:
    """T1 on ``x`` (any shape): one element per thread, ``threads`` per
    block; the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fma_chains_plain(x, chains, reps)
    if not x.is_cuda:
        raise ValueError(f"T1 needs a CUDA or a CPU tensor, got {x.device}")
    with torch.cuda.device(x.device):
        out, err = fma_chains_call(_lib(), x, chains, reps, threads)
    if err:
        raise RuntimeError(f"T1 (fma_chains) launch failed: cudaError {err}")
    if x.numel():       # an empty tensor launches nothing
        launches["fma_chains"] += 1
    return out


def fma_flops(n: int, chains: int, reps: int) -> float:
    """Operations of one T1 call: one multiply-add is two."""
    return 2.0 * n * chains * reps


def fma_peak(dtype: torch.dtype, device=None, *,
             threads=(128, 256, 512, 1024), blocks_per_sm=(1, 2, 4, 8),
             chains=CHAINS, runs: int = 3, launch_ms: float = 2.0) -> dict:
    """The best multiply-add rate of the card over launch shapes and
    chain counts (T1's sweep; the reference's ``vpu_peak``).

    Every configuration fills the card: ``blocks_per_sm`` blocks of
    ``threads`` for each SM.  ``reps`` is set so that a launch would last
    about ``launch_ms`` at the data-sheet rate; the rate is the
    operations between ``reps`` and ``2 reps`` over the difference of the
    two launches' times, which cancels the launch, the load and the
    store.  Each time is the median of ``runs`` runs of three launches
    behind a leading one that keeps the device busy, so no host latency
    enters it (a host's jitter of 0.1 ms on a 1 ms launch, maximised over
    the sweep, reads as a rate above the card's peak).  Returns the best
    configuration, timed once more with three times the runs (``flops``,
    ``threads``, ``blocks_per_sm``, ``chains``, ``reps``, ``ms``), its
    ``share`` of the data-sheet rate, and every ``rows`` of the sweep."""
    from ..utils.device import resolve_device
    from ..utils.timer import cuda_time
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"fma_peak measures a CUDA device, not {device}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def rate(t, bps, c, runs):
        n = sms * bps * t
        x = torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
        reps = max(1024, int(launch_ms * 1e-3 * DATA_SHEET_FLOPS[dtype]
                             / (2.0 * n * c)) // 8 * 8)
        t1 = cuda_time(lambda: fma_chains(x, c, reps, t), runs, calls=3,
                       lead=1).ms
        t2 = cuda_time(lambda: fma_chains(x, c, 2 * reps, t), runs, calls=3,
                       lead=1).ms
        return {"threads": t, "blocks_per_sm": bps, "chains": c,
                "reps": reps, "ms": t1,
                "flops": fma_flops(n, c, reps) / (max(t2 - t1, 1e-9) * 1e-3)}

    rows = [rate(t, bps, c, runs) for t in threads for bps in blocks_per_sm
            for c in chains]
    # the largest of many noisy readings is biased upward: the winning
    # configuration is timed again, longer, and that reading is reported
    top = max(rows, key=lambda r: r["flops"])
    best = rate(top["threads"], top["blocks_per_sm"], top["chains"],
                3 * runs)
    best["share"] = best["flops"] / DATA_SHEET_FLOPS[dtype]
    best["rows"] = rows
    return best


# ---------------------------------------------------------------------------
# T2: K1's factor and solve, repeated inside the kernel
# ---------------------------------------------------------------------------

def fused_flops(N: int) -> Tuple[int, int]:
    """Operations per instance of one factorisation and of one solve at
    order N, as the reference's tool counts them: per column j of the
    factor j multiplies for w, a 2j dot, a 2j(N-j-1) trailing update and
    N-j-1 divisions; a solve is N^2/2 multiply-adds forward, N divisions
    and N^2/2 multiply-adds backward."""
    fac = 0
    for j in range(N):
        fac += j + 2 * j + 2 * j * max(N - j - 1, 0) + max(N - j - 1, 0)
    sol = 2 * (N * N + N)
    return fac, sol


def quasidef_tile(N: int, bt: int, seed: int = 0) -> np.ndarray:
    """A random diagonally dominant symmetric (N, N, bt) float32 tile
    (numpy; the same array as the reference's tool for the same seed)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N, bt)).astype(np.float32)
    K = A + np.swapaxes(A, 0, 1)
    K[np.arange(N), np.arange(N)] += 4.0 * N
    return K


def factor_reps_plain(K0: torch.Tensor, reps: int,
                      pivot_floor: float = PIVOT_FLOOR):
    """T2a's plain version on K0 (N, N, B): returns (acc, sink), each
    (1, B)."""
    from ..models.fused import _ldlt_soa
    N = K0.shape[0]
    acc = torch.zeros_like(K0[0, 0:1, :])
    sink = torch.zeros_like(acc)
    for r in range(reps):
        L, D = _ldlt_soa(K0 * (1.0 + 1e-6 * r), pivot_floor)
        acc = acc + D[0:1, :]
        sink = sink + D.sum(0, keepdim=True) + \
            L[N - 1, 0:N - 1, :].sum(0, keepdim=True)
    return acc, sink


def solve_reps_plain(K0: torch.Tensor, b0: torch.Tensor, reps: int,
                     pivot_floor: float = PIVOT_FLOOR):
    """T2b's plain version on K0 (N, N, B), b0 (N, B): returns (acc,
    sink), each (1, B)."""
    from ..models.fused import _ldlt_soa, _solve_soa
    L, D = _ldlt_soa(K0, pivot_floor)
    acc = torch.zeros_like(b0[0:1, :])
    sink = torch.zeros_like(acc)
    for r in range(reps):
        x = _solve_soa(L, D, b0 * (1.0 + 1e-6 * r))
        acc = acc + x[0:1, :]
        sink = sink + x.sum(0, keepdim=True)
    return acc, sink


def _reps_shapes(K0: torch.Tensor):
    if K0.dim() != 3 or K0.shape[0] != K0.shape[1]:
        raise ValueError(f"K0 must be (N, N, B), got {tuple(K0.shape)}")
    N, B = K0.shape[0], K0.shape[-1]
    if N not in ORDERS:
        raise ValueError(f"order {N}: T2 is built for {ORDERS}")
    _check("K0", K0, (N, N, B), K0)
    return N, B


def _entry(kernel: str, route: str) -> str:
    """T2a's (``kernel`` "T2a") or T2b's entry-point name on ``route``;
    raises for another route."""
    entries = {"T2a": _FACTOR_ENTRY, "T2b": _SOLVE_ENTRY}.get(kernel, {})
    if route not in entries:
        raise ValueError(f"{kernel} has no route {route!r}: "
                         f"{tuple(entries)}")
    return entries[route]


def factor_reps_call(lib: ctypes.CDLL, K0: torch.Tensor, reps: int,
                     pivot_floor: float = PIVOT_FLOOR,
                     route: str = "thread"):
    """Check K0, allocate the outputs and call T2a's entry point of
    ``lib`` on ``route`` once; returns ((acc, sink), status)."""
    N, B = _reps_shapes(K0)
    entry = _entry("T2a", route)
    acc, sink = K0.new_empty((1, B)), K0.new_empty((1, B))
    if B == 0:
        return (acc, sink), 0
    fn = getattr(lib, f"{entry}_{_SUFFIX[K0.dtype]}")
    return (acc, sink), fn(K0.data_ptr(), acc.data_ptr(), sink.data_ptr(), N,
                           B, reps, pivot_floor, _stream(K0))


def solve_reps_call(lib: ctypes.CDLL, K0: torch.Tensor, b0: torch.Tensor,
                    reps: int, pivot_floor: float = PIVOT_FLOOR,
                    route: str = "thread"):
    """As :func:`factor_reps_call` for T2b, with b0 (N, B)."""
    N, B = _reps_shapes(K0)
    _check("b0", b0, (N, B), K0)
    entry = _entry("T2b", route)
    acc, sink = K0.new_empty((1, B)), K0.new_empty((1, B))
    if B == 0:
        return (acc, sink), 0
    fn = getattr(lib, f"{entry}_{_SUFFIX[K0.dtype]}")
    return (acc, sink), fn(K0.data_ptr(), b0.data_ptr(), acc.data_ptr(),
                           sink.data_ptr(), N, B, reps, pivot_floor,
                           _stream(K0))


def factor_reps(K0: torch.Tensor, reps: int,
                pivot_floor: float = PIVOT_FLOOR, route: str = "thread"):
    """T2a on K0 (N, N, B), one thread an instance (``route="thread"``) or
    a team of 16 lanes an instance with K and D in shared memory
    (``"team"``): (acc, sink), each (1, B); the plain version for CPU
    tensors."""
    _entry("T2a", route)
    if K0.device.type == "cpu":
        return factor_reps_plain(K0, reps, pivot_floor)
    if not K0.is_cuda:
        raise ValueError(f"T2a needs CUDA or CPU tensors, got {K0.device}")
    with torch.cuda.device(K0.device):
        outs, err = factor_reps_call(_lib(), K0, reps, pivot_floor, route)
    if err:
        raise RuntimeError(f"T2a (factor_reps, {route} route) launch "
                           f"failed: cudaError {err}")
    if K0.shape[-1]:    # an empty batch launches nothing
        launches["factor_reps"] += 1
        route_launches[f"factor_reps {route}"] += 1
    return outs


def solve_reps(K0: torch.Tensor, b0: torch.Tensor, reps: int,
               pivot_floor: float = PIVOT_FLOOR, route: str = "thread"):
    """T2b on K0 (N, N, B), b0 (N, B), one thread an instance
    (``route="thread"``) or a team of 16 lanes an instance with K, D and
    b in shared memory (``"team"``): (acc, sink), each (1, B); the plain
    version for CPU tensors."""
    _entry("T2b", route)
    if K0.device.type == "cpu":
        return solve_reps_plain(K0, b0, reps, pivot_floor)
    if not K0.is_cuda:
        raise ValueError(f"T2b needs CUDA or CPU tensors, got {K0.device}")
    with torch.cuda.device(K0.device):
        outs, err = solve_reps_call(_lib(), K0, b0, reps, pivot_floor,
                                    route)
    if err:
        raise RuntimeError(f"T2b (solve_reps, {route} route) launch "
                           f"failed: cudaError {err}")
    if K0.shape[-1]:
        launches["solve_reps"] += 1
        route_launches[f"solve_reps {route}"] += 1
    return outs


def reps_team_shape(dtype: torch.dtype, kernel: str = "T2b",
                    N: int = 24, lib: ctypes.CDLL = None) -> Dict[str, int]:
    """What the team route of ``kernel`` ("T2a" or "T2b") is at order
    ``N`` in ``dtype``: lanes a team, threads a block, bytes of shared
    memory a team and teams resident per SM (0 in a host build), from
    ``lib`` (default the nvcc build, on the current device)."""
    _entry(kernel, "team")
    if N not in ORDERS:
        raise ValueError(f"order {N}: T2 is built for {ORDERS}")
    fn = getattr(lib or _lib(), f"ipmzoo_reps_team_shape_{_SUFFIX[dtype]}")
    out = (ctypes.c_int * 4)()
    err = fn(int(kernel == "T2b"), N, out)
    if err:
        raise RuntimeError(f"{kernel} team route: occupancy query failed: "
                           f"cudaError {err}")
    return dict(zip(("lanes", "threads", "team_bytes", "teams_per_sm"),
                    out))


def reps_slope(run: Callable[[int], object], r1: int = 2, r2: int = 8, *,
               runs: int = 5, min_diff_ms: float = 0.2,
               max_reps: int = 4096) -> Dict[str, float]:
    """Milliseconds per in-kernel repetition of ``run(reps)`` on the
    card: the slope between ``r1`` and ``r2`` repetitions, each timed by
    CUDA events (median of ``runs`` runs of three launches behind a
    leading one, so the device's time alone).  While the two times differ
    by less than ``min_diff_ms`` the larger count is quadrupled, and the
    smaller then follows at a quarter of it, so that the slope stands
    clear of the timer's noise and both launches outlast the host's
    enqueueing of the next.  Returns ``ms_per_rep``, the
    counts used and their times."""
    from ..utils.timer import cuda_time, slope
    times = {}

    def timed(k):
        if k not in times:
            times[k] = cuda_time(lambda: run(k), runs, calls=3, lead=1).ms
        return times[k]

    r_min = r1
    while timed(r2) - timed(r1) < min_diff_ms and 4 * r2 <= max_reps:
        r2 *= 4
        r1 = max(r_min, r2 // 4)
    return {"ms_per_rep": slope(timed, r1, r2), "r1": r1, "r2": r2,
            "ms_r1": times[r1], "ms_r2": times[r2]}
