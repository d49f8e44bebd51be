"""Batched LDL^T factor (K2), solve (K3), multi-rhs solve (K4) and fused
factor + multi-rhs solve (K5): CUDA kernels with plain torch versions.

Counterpart of :mod:`ipmzoo_tpu.ops.pallas_ldlt` (``ldlt_auto`` /
``solve_ldlt_auto``, ``batched_solve_ldlt_matrix_pallas``,
``batched_ldlt_solve_matrix_pallas``).  The public
layout is the reference's: A (B, n, n), D (B, n), b (B, n),
R (B, n, k).  For CUDA tensors the wrappers transpose to the kernels'
structure-of-arrays layout ((n, n, B), batch fastest) and launch the
kernels of ``csrc/ldlt.cu`` on the current stream.  The factors are
returned as (B, n, n) / (B, n) views of their SoA storage, so a solve
against them reads the factors without a second transpose.  K5 takes
the public layout as it is, no transpose.
For CPU tensors the wrappers run the plain versions of :mod:`.ldlt`.
Any other device raises; a failed build or launch raises too.

K2, K3 and K4 have two routes each and K5 three, picked per call by pure
functions of the shape and type (:func:`k2_route`, :func:`k3_route`,
:func:`k4_route`, :func:`k5_route`)
whose thresholds come from the routes timed on an H100 (PERF.md):

- K2 ``"soa"``: one thread per matrix on SoA data (the QP slices' many
  small systems); ``"block"``: one thread block per matrix, the matrix in
  shared memory, read in the public layout and written as SoA (few,
  larger systems: the Schur slice's H blocks).
- K3 ``"thread"``: one thread per matrix on SoA data; ``"warp"``: a
  thread block stages a tile of 8 (float32) or 4 (float64) instances in
  shared memory, coalesced from the same SoA arrays, and one warp, or an
  8- / 16-lane part of one, solves each matrix with x in registers, for
  every order from 2 whose tile fits a block's shared memory (n <= 83).
- K4 ``"thread"``: one thread per (matrix, column) on SoA data;
  ``"warp"``: a thread block stages K3's tile of the SoA factor once for
  all columns, segments of a warp each solve one matrix's group of four
  columns in registers, R and X in the public layout (no transpose),
  wherever the tile fits a block's shared memory (n <= 81).
- K5 ``"block"``: one thread block per matrix, a block barrier a step;
  ``"warp"``: one warp, or an 8- / 16-lane part of one, per matrix of
  order <= 32, no block barrier; ``"split"``: a thread block per matrix
  of order <= 64 staged by asynchronous copies, the factor on one segment of
  lanes with no block barrier, then the right-hand sides split across the
  block's segments in groups of four (the nested-dissection levels);
  ``"k2+k4"``: K2 then K4 where no K5 route's shared memory holds the
  matrix and its right-hand sides.

Above K2_ORDERS, :func:`ldlt_route` sends a factor and its solves to the
panel-blocked path of :mod:`.blocked_ldlt` where it beat K2 with K3 / K4
on an H100: its diagonal panels on K2, the rest library calls, the
factors plain (B, n, n) tensors, which the solves read as they are.

``launches`` counts each TPU kernel's launches whatever the route;
``route_launches`` counts them per route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ldlt import (PIVOT_FLOOR, ldlt, ldlt_solve_matrix, solve_ldlt,
                   solve_ldlt_matrix)

#: kernel launches since the last :func:`reset_launch_counts`
launches = {"ldlt": 0, "solve_ldlt": 0, "solve_ldlt_matrix": 0,
            "ldlt_solve_matrix": 0}
#: the float64 instantiations' share of ``launches``
f64_launches = dict(launches)
#: ``launches`` of K2 ("ldlt"), K3 ("solve_ldlt"), K4
#: ("solve_ldlt_matrix") and K5 ("ldlt_solve_matrix") by route, and the
#: panel-blocked factorisations of :mod:`.blocked_ldlt` ("ldlt blocked",
#: whose K2 panel launches count under K2's route)
route_launches = {"ldlt soa": 0, "ldlt block": 0,
                  "solve_ldlt thread": 0, "solve_ldlt warp": 0,
                  "solve_ldlt_matrix thread": 0, "solve_ldlt_matrix warp": 0,
                  "ldlt_solve_matrix block": 0, "ldlt_solve_matrix warp": 0,
                  "ldlt_solve_matrix split": 0, "ldlt blocked": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
        f64_launches[k] = 0
    for k in route_launches:
        route_launches[k] = 0


def _count(name: str, dtype: torch.dtype, route: str = None) -> None:
    launches[name] += 1
    if dtype == torch.float64:
        f64_launches[name] += 1
    if route is not None:
        route_launches[f"{name} {route}"] += 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ldlt")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dt, sfx in _SUFFIX.items():
        f = getattr(lib, f"ipmzoo_ldlt_factor_{sfx}")
        f.argtypes = [ptr, ptr, ptr, i32, i64, _CTYPE[dt], ptr]
        f.restype = i32
        s = getattr(lib, f"ipmzoo_ldlt_solve_{sfx}")
        s.argtypes = [ptr, ptr, ptr, ptr, i32, i64, ptr]
        s.restype = i32
        sw = getattr(lib, f"ipmzoo_ldlt_solve_warp_{sfx}")
        sw.argtypes = s.argtypes
        sw.restype = i32
        m = getattr(lib, f"ipmzoo_ldlt_solve_matrix_{sfx}")
        m.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64, ptr]
        m.restype = i32
        mw = getattr(lib, f"ipmzoo_ldlt_solve_matrix_warp_{sfx}")
        mw.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, ptr]
        mw.restype = i32
        fs = getattr(lib, f"ipmzoo_ldlt_factor_solve_matrix_{sfx}")
        fs.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i64, _CTYPE[dt],
                       ptr]
        fs.restype = i32
        fw = getattr(lib, f"ipmzoo_ldlt_factor_solve_matrix_warp_{sfx}")
        fw.argtypes = fs.argtypes
        fw.restype = i32
        fp = getattr(lib, f"ipmzoo_ldlt_factor_solve_matrix_split_{sfx}")
        fp.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32,
                       _CTYPE[dt], ptr]
        fp.restype = i32
        fb = getattr(lib, f"ipmzoo_ldlt_factor_block_{sfx}")
        fb.argtypes = f.argtypes
        fb.restype = i32
    return lib


def _check_soa(dtype, device, **tensors) -> None:
    if dtype not in _SUFFIX:
        raise TypeError(f"LDL^T kernels take float32/float64, not {dtype}")
    for name, (t, shape) in tensors.items():
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def factor_soa(A_t: torch.Tensor, pivot_floor: float = PIVOT_FLOOR):
    """Launch K2 on SoA data: A_t (n, n, B) -> L_t (n, n, B), D_t (n, B)."""
    n, B = A_t.shape[0], A_t.shape[-1]
    _check_soa(A_t.dtype, A_t.device, A_t=(A_t, (n, n, B)))
    if not A_t.is_cuda:
        raise ValueError(f"K2 needs a CUDA tensor, got {A_t.device}")
    L_t = torch.empty_like(A_t)
    D_t = A_t.new_empty((n, B))
    if n == 0 or B == 0:
        return L_t, D_t
    with torch.cuda.device(A_t.device):
        err = getattr(_lib(), f"ipmzoo_ldlt_factor_{_SUFFIX[A_t.dtype]}")(
            A_t.data_ptr(), L_t.data_ptr(), D_t.data_ptr(), n, B,
            pivot_floor, _stream(A_t.device))
    if err:
        raise RuntimeError(f"LDL^T factor kernel launch failed: "
                           f"cudaError {err}")
    _count("ldlt", A_t.dtype, "soa")
    return L_t, D_t


def solve_soa(L_t: torch.Tensor, D_t: torch.Tensor,
              b_t: torch.Tensor) -> torch.Tensor:
    """Launch K3 on SoA data: L_t (n, n, B), D_t (n, B), b_t (n, B) ->
    x_t (n, B) with L D L^T x = b per instance."""
    n, B = b_t.shape
    _check_soa(b_t.dtype, b_t.device, L_t=(L_t, (n, n, B)),
               D_t=(D_t, (n, B)), b_t=(b_t, (n, B)))
    if not b_t.is_cuda:
        raise ValueError(f"K3 needs CUDA tensors, got {b_t.device}")
    x_t = torch.empty_like(b_t)
    if n == 0 or B == 0:
        return x_t
    with torch.cuda.device(b_t.device):
        err = getattr(_lib(), f"ipmzoo_ldlt_solve_{_SUFFIX[b_t.dtype]}")(
            L_t.data_ptr(), D_t.data_ptr(), b_t.data_ptr(), x_t.data_ptr(),
            n, B, _stream(b_t.device))
    if err:
        raise RuntimeError(f"LDL^T solve kernel launch failed: "
                           f"cudaError {err}")
    _count("solve_ldlt", b_t.dtype, "thread")
    return x_t


#: the K3 warp route's tile: consecutive instances a thread block, one
#: 32-byte sector of each SoA element
K3_TILE = {torch.float32: 8, torch.float64: 4}
#: the K3 warp route's largest padded order (a warp, three rows a lane)
K3_WARP_MAX_ORDER = 96


def solve_warp_bytes(n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K3 warp-route thread block for order
    n: per instance of the tile, L at row stride n + 1, D and b."""
    return K3_TILE[dtype] * n * (n + 3) * torch.finfo(dtype).bits // 8


def solve_warp_fits(n: int, dtype: torch.dtype) -> bool:
    return n <= K3_WARP_MAX_ORDER and \
        solve_warp_bytes(n, dtype) <= K5_SHARED_MEMORY_CAP


def k3_route(n: int, B: int, dtype: torch.dtype) -> str:
    """K3's route for B systems of order n: ``"warp"`` for 2 <= n while
    the tile fits a block's shared memory (n <= 83 in both types), else
    ``"thread"``.  On an H100 the warp route was the faster at every
    shape the paths give K3 (n=64, B=512 float64: 0.0258 against 0.4322
    ms of device time; n=24, B=10240 float32: 0.0163 against 0.0343),
    and the thread route at n = 1, where both take the launch's 1.4 us
    and the warp route adds its staging (PERF.md §6)."""
    return "warp" if n >= 2 and solve_warp_fits(n, dtype) else "thread"


def solve_soa_warp(L_t: torch.Tensor, D_t: torch.Tensor,
                   b_t: torch.Tensor) -> torch.Tensor:
    """Launch K3's warp route on the SoA data :func:`solve_soa` takes:
    L_t (n, n, B), D_t (n, B), b_t (n, B) -> x_t (n, B)."""
    n, B = b_t.shape
    _check_soa(b_t.dtype, b_t.device, L_t=(L_t, (n, n, B)),
               D_t=(D_t, (n, B)), b_t=(b_t, (n, B)))
    if not solve_warp_fits(n, b_t.dtype):
        raise ValueError(
            f"K3's warp route at n={n} in {b_t.dtype} needs "
            f"{solve_warp_bytes(n, b_t.dtype)} bytes of shared memory, "
            f"above its cap of {K5_SHARED_MEMORY_CAP} (or n > "
            f"{K3_WARP_MAX_ORDER})")
    if not b_t.is_cuda:
        raise ValueError(f"K3 needs CUDA tensors, got {b_t.device}")
    x_t = torch.empty_like(b_t)
    if n == 0 or B == 0:
        return x_t
    with torch.cuda.device(b_t.device):
        err = getattr(_lib(), f"ipmzoo_ldlt_solve_warp_{_SUFFIX[b_t.dtype]}")(
            L_t.data_ptr(), D_t.data_ptr(), b_t.data_ptr(), x_t.data_ptr(),
            n, B, _stream(b_t.device))
    if err:
        raise RuntimeError(f"LDL^T solve (warp route) kernel launch failed: "
                           f"cudaError {err}")
    _count("solve_ldlt", b_t.dtype, "warp")
    return x_t


def solve_matrix_soa(L_t: torch.Tensor, D_t: torch.Tensor,
                     R_t: torch.Tensor) -> torch.Tensor:
    """Launch K4 on SoA data: L_t (n, n, B), D_t (n, B), R_t (n, k, B) ->
    X_t (n, k, B) with L D L^T X = R per instance."""
    n, k, B = R_t.shape
    _check_soa(R_t.dtype, R_t.device, L_t=(L_t, (n, n, B)),
               D_t=(D_t, (n, B)), R_t=(R_t, (n, k, B)))
    if not R_t.is_cuda:
        raise ValueError(f"K4 needs CUDA tensors, got {R_t.device}")
    if k > 65535:
        raise ValueError(f"K4 takes at most 65535 right-hand sides, got {k}")
    X_t = torch.empty_like(R_t)
    if n == 0 or k == 0 or B == 0:
        return X_t
    with torch.cuda.device(R_t.device):
        err = getattr(_lib(),
                      f"ipmzoo_ldlt_solve_matrix_{_SUFFIX[R_t.dtype]}")(
            L_t.data_ptr(), D_t.data_ptr(), R_t.data_ptr(), X_t.data_ptr(),
            n, k, B, _stream(R_t.device))
    if err:
        raise RuntimeError(f"LDL^T multi-rhs solve kernel launch failed: "
                           f"cudaError {err}")
    _count("solve_ldlt_matrix", R_t.dtype, "thread")
    return X_t


#: the K4 warp route's right-hand sides a segment and its most threads a
#: block (kK4Cols, kK4Threads in csrc/ldlt.cu)
K4_WARP_COLS, K4_WARP_THREADS = 4, 512
#: the K4 warp route's tiles, in the order tried: 4 instances a block in
#: both types (on an H100 at the Schur shape a tile of 8 in float32, one
#: 32-byte sector of each SoA element, took 0.0438 ms of device time
#: against 0.0233 for 4: half the column groups in 512 threads), 2 or 1
#: where a smaller tile leaves room for more column groups (n=81, k=16 in
#: float64: 0.0564 against 0.1589 ms; chip_smoke.sweep_k4, PERF.md §6)
K4_TILES = (4, 2, 1)
#: where the warp route beat the thread route on an H100 (device time over
#: n = 1..16, 24, 64, k = 1, 2, 4, 16 and B = 9, 512, 2048, 10240 in both
#: types: chip_smoke.sweep_k4, PERF.md §6): type -> rows (B_max, k_max,
#: n_min), the first row with B <= B_max and k <= k_max (None: any) gives
#: the smallest order the warp route takes.  Below order 6 the thread
#: route's one pass of n^2 loads wins (n = 1: 1.5 against 2.9 us); at
#: 10240 systems its B k threads fill the card and win to larger orders,
#: the more the more columns.
K4_WARP_RULE = {
    torch.float32: ((2048, None, 6), (None, 4, 7), (None, None, 15)),
    torch.float64: ((2048, None, 6), (None, 4, 11), (None, None, 16)),
}


def _segment(n: int) -> int:
    """Lanes a matrix in the K3 and K4 warp routes: 8, 16 or 32."""
    return 8 if n <= 8 else (16 if n <= 16 else 32)


def solve_matrix_warp_bytes(n: int, groups: int, dtype: torch.dtype,
                            tile: int) -> int:
    """Dynamic shared memory of one K4 warp-route thread block: per
    instance of the tile, L at row stride n + 1, D, and a chunk of
    ``groups`` x K4_WARP_COLS right-hand sides at an odd row stride."""
    chunk = groups * K4_WARP_COLS
    return tile * (n * (n + 2) + n * (chunk | 1)) * \
        torch.finfo(dtype).bits // 8


def k4_warp_shape(n: int, k: int, dtype: torch.dtype, tile: int = None):
    """The K4 warp route's launch at order n, k right-hand sides:
    (instances a block, column groups a matrix), as many groups as the
    columns need while the block keeps within K4_WARP_THREADS threads and
    its tile within a block's shared memory; None where one group does
    not fit.  Without a ``tile``, the first of K4_TILES whose shared
    memory does not cut its groups, else the one with the most groups."""
    if tile is None:
        shapes = []
        for t in K4_TILES:
            shape = k4_warp_shape(n, k, dtype, t)
            if shape is not None and shape[1] == _k4_groups(n, k, t):
                return shape
            shapes += [shape] if shape is not None else []
        return max(shapes, key=lambda s: s[1]) if shapes else None
    if not 1 <= n <= K3_WARP_MAX_ORDER or k < 1 or tile < 1:
        return None
    groups = _k4_groups(n, k, tile)
    while groups >= 1 and solve_matrix_warp_bytes(
            n, groups, dtype, tile) > K5_SHARED_MEMORY_CAP:
        groups -= 1
    return (tile, groups) if groups >= 1 else None


def _k4_groups(n: int, k: int, tile: int) -> int:
    """The K4 warp route's column groups a matrix before its shared
    memory is counted: as many as the columns need, within the block's
    threads."""
    return min(-(-k // K4_WARP_COLS),
               K4_WARP_THREADS // (tile * _segment(n)))


def k4_route(n: int, k: int, B: int, dtype: torch.dtype) -> str:
    """K4's route for B systems of order n with k right-hand sides:
    ``"warp"`` from the order K4_WARP_RULE gives wherever
    :func:`k4_warp_shape` fits (n <= 96), else ``"thread"``.  On an H100
    the warp route took the Schur slice's H blocks (n=64, k=16, B=512) in
    0.0295 ms of device time in float64 against 0.2836 (float32: 0.0234
    against 0.2959; PERF.md §6)."""
    if k4_warp_shape(n, k, dtype) is None:
        return "thread"
    for B_max, k_max, n_min in K4_WARP_RULE[dtype]:
        if (B_max is None or B <= B_max) and (k_max is None or k <= k_max):
            return "warp" if n >= n_min else "thread"
    return "thread"


def solve_matrix_warp(L_t: torch.Tensor, D_t: torch.Tensor, R: torch.Tensor,
                      tile: int = None) -> torch.Tensor:
    """Launch K4's warp route: the SoA factors :func:`solve_matrix_soa`
    takes, L_t (n, n, B), D_t (n, B), and R (B, n, k) in the public layout
    -> X (B, n, k) with L D L^T X = R per instance; ``tile`` instances a
    block (default :func:`k4_warp_shape`'s)."""
    B, n, k = R.shape
    _check_soa(R.dtype, R.device, L_t=(L_t, (n, n, B)), D_t=(D_t, (n, B)),
               R=(R, (B, n, k)))
    shape = k4_warp_shape(n, k, R.dtype, tile)
    if shape is None:
        raise ValueError(
            f"K4's warp route does not take n={n}, k={k} in {R.dtype} with "
            f"a tile of {tile}: 1 <= n <= {K3_WARP_MAX_ORDER}, k >= 1 and "
            f"the tile within {K5_SHARED_MEMORY_CAP} bytes of shared memory")
    if not R.is_cuda:
        raise ValueError(f"K4 needs CUDA tensors, got {R.device}")
    X = torch.empty_like(R)
    if B == 0:
        return X
    with torch.cuda.device(R.device):
        err = getattr(_lib(),
                      f"ipmzoo_ldlt_solve_matrix_warp_{_SUFFIX[R.dtype]}")(
            L_t.data_ptr(), D_t.data_ptr(), R.data_ptr(), X.data_ptr(), n, k,
            B, *shape, _stream(R.device))
    if err:
        raise RuntimeError(f"LDL^T multi-rhs solve (warp route) kernel launch "
                           f"failed: cudaError {err}")
    _count("solve_ldlt_matrix", R.dtype, "warp")
    return X


#: K5 keeps one matrix's panel [A | R] (n x (n + k)), D and one column
#: in the shared memory of its thread block: the most dynamic shared
#: memory a block may take on sm_90, in bytes.  Above it the wrapper
#: runs K2 then K4.
K5_SHARED_MEMORY_CAP = 232448


def factor_solve_matrix_bytes(n: int, k: int, dtype: torch.dtype) -> int:
    """Shared memory one K5 thread block needs for order n, k columns."""
    return (n * (n + k) + 2 * n) * torch.finfo(dtype).bits // 8


def factor_solve_matrix_fits(n: int, k: int, dtype: torch.dtype) -> bool:
    return factor_solve_matrix_bytes(n, k, dtype) <= K5_SHARED_MEMORY_CAP


def factor_solve_matrix_launch(A: torch.Tensor, R: torch.Tensor,
                               pivot_floor: float = PIVOT_FLOOR):
    """Launch K5: A (B, n, n), R (B, n, k), both contiguous on the card ->
    L (B, n, n) unit-lower, D (B, n), X (B, n, k) with L D L^T X = R, in
    one launch; the factor stays in shared memory between the two
    halves."""
    B, n, k = R.shape
    _check_soa(R.dtype, R.device, A=(A, (B, n, n)), R=(R, (B, n, k)))
    if not R.is_cuda:
        raise ValueError(f"K5 needs CUDA tensors, got {R.device}")
    if n == 0 or k == 0 or B == 0:
        raise ValueError(f"K5 needs B, n, k > 0, got {(B, n, k)}")
    need = factor_solve_matrix_bytes(n, k, R.dtype)
    if need > K5_SHARED_MEMORY_CAP:
        raise ValueError(
            f"K5 at n={n}, k={k} in {R.dtype} needs {need} bytes of shared "
            f"memory, above its cap of {K5_SHARED_MEMORY_CAP}")
    L = torch.empty_like(A)
    D = A.new_empty((B, n))
    X = torch.empty_like(R)
    with torch.cuda.device(R.device):
        err = getattr(
            _lib(), f"ipmzoo_ldlt_factor_solve_matrix_{_SUFFIX[R.dtype]}")(
            A.data_ptr(), R.data_ptr(), L.data_ptr(), D.data_ptr(),
            X.data_ptr(), n, k, B, pivot_floor, _stream(R.device))
    if err:
        raise RuntimeError(f"LDL^T factor + multi-rhs solve kernel launch "
                           f"failed: cudaError {err}")
    _count("ldlt_solve_matrix", R.dtype, "block")
    return L, D, X


#: the K5 warp route's largest order (its largest padded instantiation)
K5_WARP_MAX_ORDER = 32
#: the K5 warp route's thread blocks: warps each
K5_WARP_WARPS = 4


def _warp_padding(n: int, k: int):
    """The warp route's instantiation for order n, k columns: the padded
    order NP (8, 16 or 32) and the rhs chunk KP (2 for k <= 2, else 8)."""
    return next(p for p in (8, 16, 32) if n <= p), (2 if k <= 2 else 8)


def factor_solve_matrix_warp_bytes(n: int, k: int,
                                   dtype: torch.dtype) -> int:
    """Static shared memory of one K5 warp-route thread block for order
    n <= 32: per matrix the factor at row stride NP + 1 and one rhs chunk
    at row stride KP + 1, 32 / NP matrices a warp, four warps."""
    p, q = _warp_padding(n, k)
    return (K5_WARP_WARPS * (32 // p) * (p * (p + 1) + p * (q + 1))
            * torch.finfo(dtype).bits // 8)


def factor_block_bytes(n: int, dtype: torch.dtype) -> int:
    """Shared memory one K2 block-route thread block needs for order n:
    the matrix, D and one column."""
    return (n * n + 2 * n) * torch.finfo(dtype).bits // 8


def factor_block_fits(n: int, dtype: torch.dtype) -> bool:
    return factor_block_bytes(n, dtype) <= K5_SHARED_MEMORY_CAP


def k2_route(n: int, B: int, dtype: torch.dtype) -> str:
    """K2's route for B matrices of order n: ``"block"`` (a thread block
    per matrix) wherever the matrix fits a block's shared memory, else
    ``"soa"`` (a thread per matrix).  On an H100 the block route was the
    faster at every shape the paths give K2, the SoA route's transpose
    included, from n=24, B=10240 (0.18 against 0.25 ms) to the Schur
    slice's n=64, B=512 (0.10 against 7.4 ms in float64; PERF.md §6),
    so the batch size does not enter the rule today."""
    return "block" if factor_block_fits(n, dtype) else "soa"


#: where the K5 warp route was within 5% of the fastest route on an H100
#: (device time, chip_smoke.sweep_k5 at 16, 105, 840 and 10240 systems;
#: k5_route is within 5% of the fastest at 469 of its 480 points, PERF.md
#: §6): type -> rows (B_max, (k_max at the warp route's padded order 8,
#: 16, 32)), the first row with B <= B_max (None: any) gives the most
#: right-hand sides it takes (None: any).  A warp walks its columns in
#: chunks while the split route spreads them over its block's segments,
#: so the warp route wins at few columns, and at many systems, which fill
#: the card without the split.
K5_WARP_RULE = {
    torch.float32: ((264, (2, 4, 4)), (1024, (8, 8, 48)),
                    (4096, (16, 64, None)), (None, (None, None, None))),
    torch.float64: ((264, (2, 2, 2)), (1024, (4, 8, 16)),
                    (4096, (16, 32, 0)), (None, (None, None, 0))),
}
def _warp_takes(B: int, n: int, k: int, dtype: torch.dtype) -> bool:
    """Whether K5_WARP_RULE gives B systems of order n, k columns to the
    warp route.  It runs its padded order (8, 16, 32) whatever n: from a
    quarter of padding at order 32 (n = 17..24) the split route's n-wide
    loops won, so those orders never take it."""
    if n > K5_WARP_MAX_ORDER:
        return False
    pad = 0 if n <= 8 else (1 if n <= 16 else 2)
    if pad == 2 and n <= 24:
        return False
    for B_max, k_max in K5_WARP_RULE[dtype]:
        if B_max is None or B <= B_max:
            return k_max[pad] is None or k <= k_max[pad]
    return False


def _block_takes(B: int, n: int, k: int, dtype: torch.dtype) -> bool:
    """Where the block route beat the split route on an H100: from 512
    systems, where the split route gives a matrix few column groups and
    its block's threads take all the columns at once.  Orders up to 8
    with k >= 24; in float64, where the split route factors orders over 32
    in shared memory, k >= 32 there, and orders 9-24 with k >= 64."""
    f64 = dtype == torch.float64
    if B < 512:
        return False
    return (n <= 8 and k >= 24) or (f64 and n > 32 and k >= 32) or \
        (f64 and 8 < n <= 24 and k >= 64)


def k5_route(B: int, n: int, k: int, dtype: torch.dtype) -> str:
    """K5's route for B matrices of order n with k right-hand sides:
    ``"warp"`` where K5_WARP_RULE takes the shape, else ``"split"``
    wherever :func:`k5_split_shape` takes it and the block route did not
    win there (:func:`_block_takes`), else
    ``"block"`` while the panel fits a block's shared memory, else
    ``"k2+k4"``.  On an H100 the split route took the nd slice's level
    (105, 64, 40) in 0.0371 ms of device time in float32 against the block
    route's 0.1398, and (28, 16, 48) in 0.0086 against 0.0198; the warp
    route bench_kkt's (10240, 32, 2) in 0.1015 against 0.1362 (PERF.md
    §6)."""
    if _warp_takes(B, n, k, dtype):
        return "warp"
    if k5_split_shape(B, n, k, dtype) is not None and \
            not _block_takes(B, n, k, dtype):
        return "split"
    if factor_solve_matrix_fits(n, k, dtype):
        return "block"
    return "k2+k4"


def factor_solve_matrix_warp(A: torch.Tensor, R: torch.Tensor,
                             pivot_floor: float = PIVOT_FLOOR):
    """Launch K5's warp route: A (B, n, n), R (B, n, k), both contiguous
    on the card, n <= 32 -> L (B, n, n) unit-lower, D (B, n), X (B, n, k)
    with L D L^T X = R."""
    B, n, k = R.shape
    _check_soa(R.dtype, R.device, A=(A, (B, n, n)), R=(R, (B, n, k)))
    if n == 0 or k == 0 or B == 0:
        raise ValueError(f"K5 needs B, n, k > 0, got {(B, n, k)}")
    if n > K5_WARP_MAX_ORDER:
        raise ValueError(f"K5's warp route takes orders up to "
                         f"{K5_WARP_MAX_ORDER}, got {n}")
    if not R.is_cuda:
        raise ValueError(f"K5 needs CUDA tensors, got {R.device}")
    L = torch.empty_like(A)
    D = A.new_empty((B, n))
    X = torch.empty_like(R)
    with torch.cuda.device(R.device):
        err = getattr(
            _lib(),
            f"ipmzoo_ldlt_factor_solve_matrix_warp_{_SUFFIX[R.dtype]}")(
            A.data_ptr(), R.data_ptr(), L.data_ptr(), D.data_ptr(),
            X.data_ptr(), n, k, B, pivot_floor, _stream(R.device))
    if err:
        raise RuntimeError(f"LDL^T factor + multi-rhs solve (warp route) "
                           f"kernel launch failed: cudaError {err}")
    _count("ldlt_solve_matrix", R.dtype, "warp")
    return L, D, X


#: the K5 split route's right-hand sides a segment, its most threads a
#: block and its largest order, a warp with two rows a lane (kK5SplitCols,
#: kK5SplitThreads, kK5SplitMaxOrder in csrc/ldlt.cu).  Three rows a lane
#: (orders 65-96) lost to the block route at most points of
#: chip_smoke.sweep_k5 on an H100 and took 168 registers with a 48-byte
#: stack in float32 and 44 bytes of spills in float64, so the route stops
#: at 64.
K5_SPLIT_COLS, K5_SPLIT_THREADS, K5_SPLIT_MAX_ORDER = 4, 384, 64
#: the SMs of an H100 and the threads an SM the split route's column
#: groups are sized to, up to order 32 and above (where a thread holds 130
#: registers in float32 and 151 in float64).  Past one such wave a matrix
#: gets fewer groups, each walking more of its columns: at (840, 64, 40) in float32 one group a
#: matrix took 0.1203 ms of device time against 0.1508 for two and 0.2426
#: for all ten, while at a level's 105 matrices all ten took 0.0354
#: against one group's 0.1074 (chip_smoke.scan_k5_split, PERF.md §6)
K5_SMS, K5_SPLIT_SM_THREADS = 132, (512, 384)


def _split_segment(n: int) -> int:
    """Lanes a matrix in the K5 split route: 16 up to order 16, else 32."""
    return 16 if n <= 16 else 32


def factor_solve_matrix_split_bytes(n: int, k: int,
                                    dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K5 split-route thread block: the
    matrix's panel at row stride n + 1, D, the unscaled column and the
    right-hand sides at the odd row stride k | 1."""
    return (n * (n + 3) + n * (k | 1)) * torch.finfo(dtype).bits // 8


def k5_split_shape(B: int, n: int, k: int, dtype: torch.dtype,
                   groups: int = None):
    """The K5 split route's column groups a matrix (one matrix a block) for
    B matrices of order n with k right-hand sides, or None where the route
    does not take the shape (n over K5_SPLIT_MAX_ORDER, k < 1, or the
    matrix over a block's shared memory).  By default as many groups of
    K5_SPLIT_COLS columns as the columns need within the block's threads
    and one wave of the card (K5_SMS x K5_SPLIT_SM_THREADS), evened out so
    that every segment walks the same number of groups; ``groups`` given
    (chip_smoke.scan_k5_split) is taken as it is if it fits."""
    if not 1 <= n <= K5_SPLIT_MAX_ORDER or k < 1:
        return None
    seg = _split_segment(n)
    most = K5_SPLIT_THREADS // seg
    if groups is None:
        need = -(-k // K5_SPLIT_COLS)
        wave = K5_SMS * K5_SPLIT_SM_THREADS[n > 32]
        room = max(1, min(need, most, wave // (B * seg)))
        groups = -(-need // -(-need // room))
    if not 1 <= groups <= most or factor_solve_matrix_split_bytes(
            n, k, dtype) > K5_SHARED_MEMORY_CAP:
        return None
    return groups


def factor_solve_matrix_split(A: torch.Tensor, R: torch.Tensor,
                              pivot_floor: float = PIVOT_FLOOR,
                              groups: int = None):
    """Launch K5's split route: A (B, n, n), R (B, n, k), both contiguous
    on the card, n <= K5_SPLIT_MAX_ORDER -> L (B, n, n) unit-lower,
    D (B, n), X (B, n, k) with L D L^T X = R; ``groups`` column groups a
    matrix as :func:`k5_split_shape` gives them."""
    B, n, k = R.shape
    _check_soa(R.dtype, R.device, A=(A, (B, n, n)), R=(R, (B, n, k)))
    if n == 0 or k == 0 or B == 0:
        raise ValueError(f"K5 needs B, n, k > 0, got {(B, n, k)}")
    ng = k5_split_shape(B, n, k, R.dtype, groups)
    if ng is None:
        raise ValueError(
            f"K5's split route does not take n={n}, k={k} in {R.dtype} with "
            f"{groups} column groups: n <= {K5_SPLIT_MAX_ORDER}, at most "
            f"{K5_SPLIT_THREADS} threads and {K5_SHARED_MEMORY_CAP} bytes "
            f"of shared memory a block")
    if not R.is_cuda:
        raise ValueError(f"K5 needs CUDA tensors, got {R.device}")
    L = torch.empty_like(A)
    D = A.new_empty((B, n))
    X = torch.empty_like(R)
    with torch.cuda.device(R.device):
        err = getattr(
            _lib(),
            f"ipmzoo_ldlt_factor_solve_matrix_split_{_SUFFIX[R.dtype]}")(
            A.data_ptr(), R.data_ptr(), L.data_ptr(), D.data_ptr(),
            X.data_ptr(), n, k, B, ng, pivot_floor, _stream(R.device))
    if err:
        raise RuntimeError(f"LDL^T factor + multi-rhs solve (split route) "
                           f"kernel launch failed: cudaError {err}")
    _count("ldlt_solve_matrix", R.dtype, "split")
    return L, D, X


def factor_block(A: torch.Tensor, pivot_floor: float = PIVOT_FLOOR):
    """Launch K2's block route: A (B, n, n) contiguous on the card ->
    L_t (n, n, B), D_t (n, B), the SoA storage :func:`factor_soa`
    returns."""
    B, n = A.shape[0], A.shape[-1]
    _check_soa(A.dtype, A.device, A=(A, (B, n, n)))
    need = factor_block_bytes(n, A.dtype)
    if need > K5_SHARED_MEMORY_CAP:
        raise ValueError(
            f"K2's block route at n={n} in {A.dtype} needs {need} bytes of "
            f"shared memory, above its cap of {K5_SHARED_MEMORY_CAP}")
    if not A.is_cuda:
        raise ValueError(f"K2 needs a CUDA tensor, got {A.device}")
    L_t = A.new_empty((n, n, B))
    D_t = A.new_empty((n, B))
    if n == 0 or B == 0:
        return L_t, D_t
    with torch.cuda.device(A.device):
        err = getattr(_lib(), f"ipmzoo_ldlt_factor_block_{_SUFFIX[A.dtype]}")(
            A.data_ptr(), L_t.data_ptr(), D_t.data_ptr(), n, B, pivot_floor,
            _stream(A.device))
    if err:
        raise RuntimeError(f"LDL^T factor (block route) kernel launch "
                           f"failed: cudaError {err}")
    _count("ldlt", A.dtype, "block")
    return L_t, D_t


def soa_backed(L: torch.Tensor, D: torch.Tensor):
    """(L, D) as (B, n, n) / (B, n) views of structure-of-arrays storage,
    the form :func:`ldlt_auto` returns: :func:`solve_ldlt_auto` and
    :func:`solve_ldlt_matrix_auto` then read them without a transpose."""
    return (L.permute(1, 2, 0).contiguous().permute(2, 0, 1),
            D.t().contiguous().t())


def _dispatch(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no LDL^T implementation for device {t.device}")


#: the orders K2 keeps whatever the batch: one panel of the blocked path,
#: which holds every order the reference runs its Pallas kernels at (its
#: ``_pl_fits``: n <= 112 in float32, 80 in float64)
K2_ORDERS = 128


def ldlt_route(n: int) -> str:
    """The route of :func:`ldlt_auto` and of its solves for systems of
    order n on the card: ``"k2"`` (K2 by :func:`k2_route`, the solves by
    K3 / K4) up to K2_ORDERS, else ``"blocked"``
    (:func:`.blocked_ldlt.ldlt_blocked`, its panels on K2, the solves two
    library triangular solves).  On an H100 the blocked path with one
    solve was within 5% of the fastest route at all 99 points of
    chip_smoke.sweep_ldlt (n = 129-1024, B = 1-512, both types; 40 of
    them timed more than the blocked route, the others having no K2
    route left that fits or is within 10x; 0.9719 against 223.3779 ms
    for K2's SoA route with K3 at (1, 328) float64, and at B = 512 below
    K2's block route's by 1.7-4.9x), so the batch and the type do not
    enter the rule (PERF.md §6)."""
    return "k2" if n <= K2_ORDERS else "blocked"


def ldlt_k2(A: torch.Tensor, pivot_floor: float = PIVOT_FLOOR):
    """K2 on CUDA tensors by the route :func:`k2_route` picks, the plain
    column LDL^T on CPU tensors: A (B, n, n) -> L (B, n, n) unit-lower,
    D (B, n); on the card views of K2's SoA storage."""
    if not _dispatch(A):
        return ldlt(A, pivot_floor)
    if k2_route(A.shape[-1], A.shape[0], A.dtype) == "block":
        L_t, D_t = factor_block(A.contiguous(), pivot_floor)
    else:
        L_t, D_t = factor_soa(A.permute(1, 2, 0).contiguous(), pivot_floor)
    return L_t.permute(2, 0, 1), D_t.t()


def _blocked(t: torch.Tensor, n: int) -> bool:
    """Whether a call on ``t`` at order n takes the blocked route: on the
    card where :func:`ldlt_route` says so; CPU tensors take the plain
    versions."""
    return _dispatch(t) and ldlt_route(n) == "blocked"


def ldlt_auto(A: torch.Tensor, pivot_floor: float = PIVOT_FLOOR):
    """Batched LDL^T: A (B, n, n) -> L (B, n, n) unit-lower, D (B, n), by
    the route :func:`ldlt_route` picks (CUDA) or the plain version
    (CPU)."""
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected (B, n, n), got {tuple(A.shape)}")
    if _blocked(A, A.shape[-1]):
        from .blocked_ldlt import ldlt_blocked
        return ldlt_blocked(A, pivot_floor)
    return ldlt_k2(A, pivot_floor)


def solve_ldlt_auto(L: torch.Tensor, D: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Batched solve against ``ldlt_auto``'s factors: b (B, n) -> x."""
    if not _dispatch(b):
        return solve_ldlt(L, D, b)
    B, n = b.shape
    if _blocked(b, n):
        from .blocked_ldlt import solve_ldlt_blocked
        return solve_ldlt_blocked(L, D, b)
    launch = solve_soa_warp if k3_route(n, B, b.dtype) == "warp" else \
        solve_soa
    x_t = launch(L.permute(1, 2, 0).contiguous(), D.t().contiguous(),
                 b.t().contiguous())
    return x_t.t()


def solve_ldlt_matrix_auto(L: torch.Tensor, D: torch.Tensor,
                           R: torch.Tensor) -> torch.Tensor:
    """Batched multi-rhs solve against ``ldlt_auto``'s factors:
    R (B, n, k) -> X (B, n, k)."""
    if R.dim() != 3:
        raise ValueError(f"expected R (B, n, k), got {tuple(R.shape)}")
    if not _dispatch(R):
        return solve_ldlt_matrix(L, D, R)
    B, n, k = R.shape
    if _blocked(R, n):
        from .blocked_ldlt import solve_ldlt_matrix_blocked
        return solve_ldlt_matrix_blocked(L, D, R)
    L_t, D_t = L.permute(1, 2, 0).contiguous(), D.t().contiguous()
    if k4_route(n, k, B, R.dtype) == "warp":
        return solve_matrix_warp(L_t, D_t, R.contiguous())
    X_t = solve_matrix_soa(L_t, D_t, R.permute(1, 2, 0).contiguous())
    return X_t.permute(2, 0, 1)


def ldlt_solve_matrix_auto(A: torch.Tensor, R: torch.Tensor,
                           pivot_floor: float = PIVOT_FLOOR):
    """Batched fused factor + multi-rhs solve: A (B, n, n), R (B, n, k)
    -> (L, D, X) with L D L^T X = R per instance.

    On CUDA tensors one K5 launch by the route :func:`k5_route` picks;
    where a block's panel exceeds ``K5_SHARED_MEMORY_CAP`` bytes,
    :func:`ldlt_auto` then :func:`solve_ldlt_matrix_auto` (K2 then K4, or
    the blocked route :func:`ldlt_route` picks; counted under their
    names), and the factor alone for k = 0."""
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected A (B, n, n), got {tuple(A.shape)}")
    if R.dim() != 3 or R.shape[:2] != A.shape[:2]:
        raise ValueError(f"expected R (B, n, k) beside A "
                         f"{tuple(A.shape)}, got {tuple(R.shape)}")
    if not _dispatch(A):
        return ldlt_solve_matrix(A, R, pivot_floor)
    B, n, k = R.shape
    if n == 0:
        return torch.zeros_like(A), A.new_zeros((B, 0)), R
    route = k5_route(B, n, k, A.dtype)
    if k == 0 or B == 0 or route == "k2+k4":
        L, D = ldlt_auto(A, pivot_floor)
        return L, D, (solve_ldlt_matrix_auto(L, D, R) if k else R)
    launch = {"warp": factor_solve_matrix_warp,
              "split": factor_solve_matrix_split,
              "block": factor_solve_matrix_launch}[route]
    return launch(A.contiguous(), R.contiguous(), pivot_floor)
