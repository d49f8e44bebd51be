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

K6 has two routes, picked per call by the pure function :func:`k6_route`
from device times measured on an H100 (PERF.md): ``"block"``, one thread
block per instance with its working blocks in global scratch, and
``"cluster"`` (:func:`cr_factor_cluster`), a thread-block cluster of
:func:`k6_cluster` blocks per instance with every position's working
blocks in the shared memory of the rank that owns it
(:func:`cluster_owner`).  Both write the same factors, so K7 reads either.
K7 has two routes too, picked by :func:`k7_route`: ``"block"``, one
thread block per instance with its working right-hand sides in global
scratch, and ``"shared"`` (:func:`cr_solve_shared`), one thread block per
(instance, group of kc columns) with that group's working right-hand
sides in shared memory.  ``launches`` counts K6 and K7 whatever the
route, ``route_launches`` per route.
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
#: ``launches`` of K6 ("cr_factor") and K7 ("cr_solve") by route
route_launches = {"cr_factor block": 0, "cr_factor cluster": 0,
                  "cr_solve block": 0, "cr_solve shared": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: the kernels index one instance's arrays with 32-bit offsets
MAX_INSTANCE_ELEMENTS = 2 ** 31 - 1


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
    lib = _build.load("cr")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in _SUFFIX.values():
        f = getattr(lib, f"ipmzoo_cr_factor_{sfx}")
        f.argtypes = [ptr] * 8 + [i32, i32, i64, ptr]
        f.restype = i32
        s = getattr(lib, f"ipmzoo_cr_solve_{sfx}")
        s.argtypes = [ptr] * 7 + [i32, i32, i32, i64, ptr]
        s.restype = i32
        c = getattr(lib, f"ipmzoo_cr_factor_cluster_{sfx}")
        c.argtypes = [ptr] * 5 + [i32, i32, i64, i32, ptr]
        c.restype = i32
        o = getattr(lib, f"ipmzoo_cr_factor_cluster_occupancy_{sfx}")
        o.argtypes = [i32, i32, i32, ptr]
        o.restype = i32
        h = getattr(lib, f"ipmzoo_cr_solve_shared_{sfx}")
        h.argtypes = [ptr] * 5 + [i32, i32, i32, i32, i64, ptr]
        h.restype = i32
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
    _count("cr_factor", D.dtype, "block")
    return CRKernelFactors(Pinv, Eb, Ea)


# ----------------------------------------------------------------------
# the cluster route
# ----------------------------------------------------------------------

#: the cluster sizes the route launches (8 is portable, 16 needs the
#: non-portable size)
CLUSTER_SIZES = (8, 16)
#: the largest block order the route takes (its segments are 8 or 16
#: lanes, one row a lane)
CLUSTER_MAX_B = 16
#: the most dynamic shared memory a block may take on sm_90, in bytes
SHARED_MEMORY_CAP = 232448


def cr_levels(N: int) -> int:
    """The number of levels, L: strides 1, 2, ..., 2^(L-1) < N."""
    L = 0
    while (1 << L) < N:
        L += 1
    return L


def level_pivots(N: int, l: int) -> int:
    """Pivots eliminated at level l (l = L: the root alone)."""
    if l == cr_levels(N):
        return 1
    s = 1 << l
    return (N + s - 1) // (2 * s)


def _rank_count(N: int, l: int, r: int, C: int) -> int:
    np_ = level_pivots(N, l)
    return (np_ - r - 1) // C + 1 if np_ > r else 0


def slot_base(N: int, r: int, C: int) -> list:
    """slot_base[l] of rank r for l = 0 .. L + 1: its slots before level
    l (``csrc/cr.cu``, cr_factor_kernel_cluster)."""
    out, acc = [], 0
    for l in range(cr_levels(N) + 1):
        out.append(acc)
        acc += _rank_count(N, l, r, C)
    return out + [acc]


def cluster_owner(p: int, N: int, C: int):
    """(rank, slot) of position p on the cluster route: p > 0 is pivot
    m = p >> (l + 1) of level l = ctz(p), owned by rank m % C in slot
    slot_base[l] + m // C; position 0 is the root, level L, rank 0."""
    if p == 0:
        return 0, slot_base(N, 0, C)[cr_levels(N)]
    l = (p & -p).bit_length() - 1
    m = p >> (l + 1)
    return m % C, slot_base(N, m % C, C)[l] + m // C


def cluster_slots(N: int, r: int, C: int) -> list:
    """The positions rank r owns, by slot: level by level, pivots
    m = r, r + C, ... of each level, the root last on rank 0."""
    L = cr_levels(N)
    out = []
    for l in range(L + 1):
        for k in range(_rank_count(N, l, r, C)):
            m = r + C * k
            out.append(0 if l == L else (2 * m + 1) << l)
    return out


def cluster_threads(N: int, b: int, C: int) -> int:
    """Threads of one cluster-route block: a segment of 8 or 16 lanes for
    each of rank 0's pivots at level 0 or its even positions there,
    whichever is more, at most 256 threads."""
    bp = 8 if b <= 8 else 16
    base = slot_base(N, 0, C)
    seg = max(base[1] - base[0], base[-1] - base[1], 1)
    return min(seg, 256 // bp) * bp


def cluster_bytes(N: int, b: int, C: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one cluster-route block: the slot table
    (16 ranks x 34 levels of int32) and rank 0's slot positions, padded
    to 16 bytes, then three b x b working blocks a slot and three scratch
    blocks a segment, at row stride b + 1."""
    slots = slot_base(N, 0, C)[-1]
    segments = cluster_threads(N, b, C) // (8 if b <= 8 else 16)
    head = ((16 * 34 + slots) * 4 + 15) // 16 * 16
    return head + (slots + segments) * 3 * b * (b + 1) * \
        torch.finfo(dtype).bits // 8


def cluster_fits(N: int, b: int, C: int, dtype: torch.dtype) -> bool:
    """Whether the cluster route takes (N, b) at cluster size C: b <= 16
    and the shared memory within a block's cap."""
    return (1 <= b <= CLUSTER_MAX_B and C in CLUSTER_SIZES and N >= 1 and
            cluster_bytes(N, b, C, dtype) <= SHARED_MEMORY_CAP)


def k6_cluster(N: int, b: int, B: int, dtype: torch.dtype):
    """The cluster size of the cluster route at (N, b, B), or None: 16
    for B <= 4 (more SMs for each of a few instances), else the smallest
    size that fits (more clusters resident at once).  On an H100 at
    N=256, b=16, float32: 0.2805 against 0.3115 ms at B=1, 0.3058
    against 0.5526 at B=8 (PERF.md §6)."""
    fits = [C for C in CLUSTER_SIZES if cluster_fits(N, b, C, dtype)]
    if not fits:
        return None
    return max(fits) if B <= 4 else min(fits)


#: where the cluster route beat the block route on an H100 (device time
#: over N = 1..256, b = 4, 8, 16, B = 1..32; PERF.md §6):
#: type -> block order -> rows (N_lo, B_max): for N_lo <= N (up to the
#: next row's N_lo, and at most K6_CLUSTER_MAX_N) the cluster route takes
#: B <= B_max.  It lost at every N for b = 4 and below N_lo for b = 8 and
#: 16: with few blocks per level the cluster's barriers and remote loads
#: outweigh the spread.  Past B_max its clusters run in more waves than
#: the block route's one SM per instance takes.  Orders and chains
#: measured nowhere (b other than 8 and 16, N > 256) keep the block route.
K6_CLUSTER_RULE = {
    torch.float32: {8: ((256, 32),), 16: ((64, 24), (128, 8), (256, 24))},
    torch.float64: {8: ((128, 24),),
                    16: ((37, 24), (64, 8), (128, 24), (256, 16))},
}
K6_CLUSTER_MAX_N = 256


def k6_route(N: int, b: int, B: int, dtype: torch.dtype) -> str:
    """K6's route for B instances of N blocks of order b: ``"cluster"``
    where K6_CLUSTER_RULE says it was the faster and a cluster size fits
    (the working blocks within 227 KB a block), else ``"block"``."""
    rows = K6_CLUSTER_RULE.get(dtype, {}).get(b, ())
    B_max = 0
    for N_lo, cap in rows:
        if N_lo <= N <= K6_CLUSTER_MAX_N:
            B_max = cap
    if B > B_max or k6_cluster(N, b, B, dtype) is None:
        return "block"
    return "cluster"


def cr_factor_cluster(D: torch.Tensor, E: torch.Tensor,
                      cluster: int = None) -> CRKernelFactors:
    """Launch K6's cluster route: D (..., N, b, b), E (..., N-1, b, b) on
    a CUDA device -> the factors :func:`cr_factor_kernel` gives, with
    ``cluster`` blocks an instance (default :func:`k6_cluster`)."""
    if D.dim() < 3:
        raise ValueError(f"expected D (..., N, b, b), got {tuple(D.shape)}")
    lead, (N, b) = tuple(D.shape[:-3]), D.shape[-3:-1]
    _check(D.dtype, D.device, D=(D, lead + (N, b, b)),
           E=(E, lead + (max(N - 1, 0), b, b)))
    _check_size(N, b, b)
    B = 1
    for d in lead:
        B *= d
    C = k6_cluster(N, b, B, D.dtype) if cluster is None else cluster
    if C is None or not cluster_fits(N, b, C, D.dtype):
        raise ValueError(
            f"K6's cluster route does not take N={N}, b={b} in {D.dtype} "
            f"with cluster {C}: b <= {CLUSTER_MAX_B}, a size of "
            f"{CLUSTER_SIZES} and the working blocks within "
            f"{SHARED_MEMORY_CAP} bytes a block")
    if B * C > MAX_INSTANCE_ELEMENTS:
        raise ValueError(f"K6's cluster route launches B * C = {B * C} "
                         f"blocks, above {MAX_INSTANCE_ELEMENTS}")
    D, E = D.contiguous(), E.contiguous()
    Pinv, Eb, Ea = (torch.empty_like(D) for _ in range(3))
    if B == 0:
        return CRKernelFactors(Pinv, Eb, Ea)
    with torch.cuda.device(D.device):
        err = getattr(_lib(),
                      f"ipmzoo_cr_factor_cluster_{_SUFFIX[D.dtype]}")(
            D.data_ptr(), E.data_ptr(), Pinv.data_ptr(), Eb.data_ptr(),
            Ea.data_ptr(), N, b, B, C, _stream(D.device))
    if err:
        raise RuntimeError(f"cyclic-reduction factor (cluster route) kernel "
                           f"launch failed: cudaError {err}")
    _count("cr_factor", D.dtype, "cluster")
    return CRKernelFactors(Pinv, Eb, Ea)


def cluster_occupancy(N: int, b: int, C: int, dtype: torch.dtype,
                      device=None) -> dict:
    """What one cluster-route launch at (N, b, C) takes on the card:
    threads a block, dynamic shared bytes and
    cudaOccupancyMaxActiveClusters."""
    if not cluster_fits(N, b, C, dtype):
        raise ValueError(f"the cluster route does not take N={N}, b={b}, "
                         f"C={C} in {dtype}")
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device or torch.device("cuda")):
        err = getattr(
            _lib(), f"ipmzoo_cr_factor_cluster_occupancy_{_SUFFIX[dtype]}")(
            N, b, C, ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {err}")
    return {"threads": out[0], "shared_bytes": out[1],
            "max_active_clusters": out[2]}


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
    _count("cr_solve", r.dtype, "block")
    return x


# ----------------------------------------------------------------------
# K7's shared route
# ----------------------------------------------------------------------

#: the largest block order the shared route takes (its dot products
#: unroll to 8 or 16 terms)
SHARED_MAX_B = 16
#: the most column groups a launch takes (gridDim.y)
MAX_GROUPS = 65535


def solve_shared_bytes(N: int, b: int, kc: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one shared-route block: the working
    right-hand sides of kc columns (N, b, kc) and the level scratch
    (ceil(N / 2), b, kc)."""
    return (N + (N + 1) // 2) * b * kc * torch.finfo(dtype).bits // 8


def solve_shared_max_kc(N: int, b: int, dtype: torch.dtype) -> int:
    """The most columns a shared-route block holds at (N, b): 0 where not
    one fits, or b is over SHARED_MAX_B."""
    if not 1 <= b <= SHARED_MAX_B or N < 1:
        return 0
    return SHARED_MEMORY_CAP // solve_shared_bytes(N, b, 1, dtype)


def shared_fits(N: int, b: int, k: int, kc: int, dtype: torch.dtype) -> bool:
    """Whether the shared route takes k columns in groups of kc."""
    return (1 <= kc <= min(k, solve_shared_max_kc(N, b, dtype)) and
            -(-k // kc) <= MAX_GROUPS)


#: the SMs of the H100 the shared route's column groups are sized for: a
#: block's time is its SM's load pipe, so two groups on one SM take about
#: twice as long (PERF.md §6)
K7_SMS = 132


def k7_route(N: int, b: int, k: int, B: int, dtype: torch.dtype):
    """K7's route for B instances of N blocks of order b with k columns:
    ``("shared", kc)``, a thread block per (instance, group of kc
    columns), wherever a group fits a block's shared memory, else
    ``("block", None)``.  kc is the fewest columns that keep the B
    instances' groups within one block per SM (K7_SMS), as many as fit
    where B alone fills the card.  On an H100 the shared route won at
    every measured point (chip_smoke.sweep_k7: N = 37..256, b = 3..16,
    B = 1..64, both types), at the arrow slice's N=256, b=16, k=9 in
    float32 0.0530 ms of device time against the block route's 0.2925 at
    B=1 (kc=1) and 0.1232 against 0.3388 at B=32 (kc=3; PERF.md §6)."""
    if min(N, b, k, B) < 1:
        return "block", None
    top = min(k, solve_shared_max_kc(N, b, dtype))
    if top < 1:
        return "block", None
    kc = min(top, -(-k // max(1, K7_SMS // B)))
    if not shared_fits(N, b, k, kc, dtype):
        return "block", None
    return "shared", kc


def cr_solve_shared(f: CRKernelFactors, r: torch.Tensor,
                    kc: int = None) -> torch.Tensor:
    """Launch K7's shared route: solve against K6's factors for
    r (..., N, b, k) on a CUDA device, one thread block per (instance,
    group of ``kc`` columns; default :func:`k7_route`'s)."""
    if r.dim() < 3:
        raise ValueError(f"expected r (..., N, b, k), got {tuple(r.shape)}")
    lead, (N, b, k) = tuple(r.shape[:-3]), r.shape[-3:]
    shape = lead + (N, b, b)
    _check(r.dtype, r.device, Pinv=(f.Pinv, shape), Eb=(f.Eb, shape),
           Ea=(f.Ea, shape))
    _check_size(N, b, k)
    B = 1
    for d in lead:
        B *= d
    if kc is None:
        kc = k7_route(N, b, k, B, r.dtype)[1]
    if kc is None or not shared_fits(N, b, k, kc, r.dtype):
        raise ValueError(
            f"K7's shared route does not take N={N}, b={b}, k={k} in "
            f"{r.dtype} with groups of {kc} columns: 1 <= b <= "
            f"{SHARED_MAX_B}, 1 <= kc <= k and "
            f"{solve_shared_bytes(N, b, kc or 1, r.dtype)} bytes within "
            f"{SHARED_MEMORY_CAP}")
    r = r.contiguous()
    Pinv, Eb, Ea = (a.contiguous() for a in f)
    x = torch.empty_like(r)
    if B == 0:
        return x
    with torch.cuda.device(r.device):
        err = getattr(_lib(), f"ipmzoo_cr_solve_shared_{_SUFFIX[r.dtype]}")(
            Pinv.data_ptr(), Eb.data_ptr(), Ea.data_ptr(), r.data_ptr(),
            x.data_ptr(), N, b, k, kc, B, _stream(r.device))
    if err:
        raise RuntimeError(f"cyclic-reduction solve (shared route) kernel "
                           f"launch failed: cudaError {err}")
    _count("cr_solve", r.dtype, "shared")
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
    """K6 for CUDA tensors, by the route :func:`k6_route` picks; its
    plain version for CPU tensors."""
    if D.dim() < 3 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"expected D (..., N, b, b), got {tuple(D.shape)}")
    if not _dispatch(D):
        return cr_factor_plain(D, E)
    N, b = D.shape[-3:-1]
    B = D.numel() // max(N * b * b, 1)
    if N and b and k6_route(N, b, B, D.dtype) == "cluster":
        return cr_factor_cluster(D, E)
    return cr_factor_kernel(D, E)


def cr_solve_auto(f: CRKernelFactors, r: torch.Tensor) -> torch.Tensor:
    """K7 for CUDA tensors, by the route :func:`k7_route` picks; its plain
    version for CPU tensors."""
    if r.dim() < 3:
        raise ValueError(f"expected r (..., N, b, k), got {tuple(r.shape)}")
    if not _dispatch(r):
        return cr_solve_plain(f, r)
    N, b, k = r.shape[-3:]
    B = r.numel() // max(N * b * k, 1)
    route, kc = k7_route(N, b, k, B, r.dtype)
    if route == "shared":
        return cr_solve_shared(f, r, kc)
    return cr_solve_kernel(f, r)
