"""Kernel K1, the fused whole-solve IPM: the ctypes wrapper.

K1 has four routes, each a source generated per formulation
(``models/fused_source.py``): the thread route, one thread per instance,
printed around ``csrc/fused_ipm.cuh``; the team route, a team of 16 or 32
lanes per instance with its state in shared memory, printed around
``csrc/fused_team.cuh``; the wide route, one warp per instance with its
state in a device-memory workspace that :func:`call` allocates, printed
around the team code and ``csrc/fused_wide.cuh``; and the block route, a
thread block of 2, 4 or 8 warps per instance with its factor and work
vectors in shared memory and its staged data in such a workspace,
printed around the team code and ``csrc/fused_wide_block.cuh``.
:func:`k1_route` picks one per launch.  Each is
built with nvcc at first use and loaded here.  :func:`fused_soa` takes
SoA tensors on a CUDA device (batch on the last axis, as the solver lays
them out), allocates the outputs and launches K1 once on the current
stream (:func:`call` packs the arguments; the tests call it on a host
build of the same source).  It never falls back to the plain version or
to the other route: tensors off the card, a failed build or a failed
launch raise.  The plain version is
``models/fused.py:FusedBatchedIPM._fused_plain``; the solver calls it for
CPU tensors.

Kernel T3 (the prefixes of one fused iteration,
``models/fused_phases.py``) has K1's four routes, generated around the
same headers, and is launched here the same way: :func:`phase_soa`, with
:func:`bind_phase` / :func:`call_phase` for a host build; the block and
wide routes' workspace is allocated here as K1's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build

#: kernel launches since the last :func:`reset_launch_counts`, per TPU
#: kernel: K1 on any route ("fused") and T3 on any route ("phase");
#: ``route_launches`` counts K1's per route, ``phase_route_launches`` T3's
launches = {"fused": 0, "phase": 0}
route_launches = {"fused thread": 0, "fused team": 0, "fused wide": 0,
                  "fused block": 0}
phase_route_launches = {"phase thread": 0, "phase team": 0,
                        "phase block": 0, "phase wide": 0}

#: K1's routes, one thread per instance (``csrc/fused_ipm.cuh``), a team
#: of lanes per instance (``csrc/fused_team.cuh``), a warp per instance
#: with its region in device memory (``csrc/fused_wide.cuh``) or a thread
#: block per instance with its factor in shared memory
#: (``csrc/fused_wide_block.cuh``): entry points and library names
_ENTRY = {"thread": "ipmzoo_fused", "team": "ipmzoo_fused_team",
          "wide": "ipmzoo_fused_wide", "block": "ipmzoo_fused_block"}
_LIB_NAME = {"thread": "fused_ipm", "team": "fused_team",
             "wide": "fused_wide", "block": "fused_wide_block"}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
#: the arguments of K1's and T3's entries before the stream that a route
#: adds: the wide route its workspace, the block route its warps a block
#: and its workspace
_ROUTE_ARGTYPES = {"wide": [ctypes.c_void_p],
                   "block": [ctypes.c_int, ctypes.c_void_p]}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for counts in (launches, route_launches, phase_route_launches):
        for k in counts:
            counts[k] = 0


def library(source: str, name: str = "fused_ipm") -> ctypes.CDLL:
    """The built and loaded library of the generated ``source`` (built at
    first use): K1 under its default name, a prefix of T3 under
    ``PHASE_LIBS``' name of its route."""
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


def bind(lib: ctypes.CDLL, dtype: torch.dtype, route: str = "thread"):
    """K1's entry point in ``lib`` (built from the ``route``'s source) for
    ``dtype``, with its ctypes signature; the routes take the same
    arguments, the wide route its workspace before the stream, the block
    route its warps a block and its workspace."""
    if dtype not in _SUFFIX:
        raise TypeError(f"K1 takes float32/float64, not {dtype}")
    fn = getattr(lib, f"{_ENTRY[route]}_{_SUFFIX[dtype]}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr, i32, i32,
                   i32] + _ROUTE_ARGTYPES.get(route, []) + [ptr]
    fn.restype = i32
    return fn


def _route_args(B: int, region: Optional[int], warps: Optional[int],
                dtype: torch.dtype, device):
    """The route's arguments of an entry (_ROUTE_ARGTYPES): ``warps`` where
    given, and a workspace of B x ``region`` values allocated on
    ``device`` where ``region`` is given; and the workspace tensor, which
    the caller keeps until the launch is enqueued."""
    extra, work = (() if warps is None else (warps,)), None
    if region is not None:
        work = torch.empty(B * region, dtype=dtype, device=device)
        extra += (work.data_ptr(),)
    return extra, work


def call(fn, data: Sequence[torch.Tensor],
         warm: Optional[Tuple[torch.Tensor, ...]], n: int, total: int,
         max_iter: int, gondzio: int, params: Sequence[float], stream=None,
         region: Optional[int] = None, warps: Optional[int] = None):
    """Check the SoA tensors, allocate the outputs on their device and call
    K1's entry point ``fn`` once; returns the outputs and the entry's
    status (a cudaError for the CUDA build, 0 for a host build).
    ``region``: the wide and block routes' values of workspace an
    instance (:func:`wide_shape`, :func:`block_shape`), allocated here on
    the data's device; None for the other routes.  ``warps``: the block
    route's warps a block; None for the other routes.

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
    extra, work = _route_args(B, region, warps, dtype, device)
    err = fn(ptrs, v0, mu0, it0, out_ptrs, B, prm, max_iter,
             int(warm is not None), gondzio, *extra, stream)
    return outs, err


def fused_soa(source: str, data: Sequence[torch.Tensor],
              warm: Optional[Tuple[torch.Tensor, ...]], n: int, total: int,
              max_iter: int, gondzio: int, params: Sequence[float],
              route: str = "thread", warps: Optional[int] = None):
    """Launch K1, built from ``source`` (the text of ``route``), on SoA
    tensors of one CUDA device (arguments and outputs as :func:`call`) on
    the current stream; the block route on ``warps`` warps a block.  A
    failed build or launch raises: there is no other route to fall back
    on."""
    if (route == "block") != (warps is not None):
        raise ValueError(f"K1's {route} route takes warps={warps}: the "
                         f"block route needs its warps, no other takes any")
    device = data[0].device
    if device.type != "cuda":
        raise ValueError(f"K1 needs CUDA tensors, got {device}")
    lib = library(source, _LIB_NAME[route])
    fn = bind(lib, data[0].dtype, route)
    with torch.cuda.device(device):
        region = region_values(lib, data[0].dtype, route, warps)
        stream = torch.cuda.current_stream(device).cuda_stream
        outs, err = call(fn, data, warm, n, total, max_iter, gondzio, params,
                         stream, region, warps)
    if err:
        raise RuntimeError(f"K1 (fused IPM, {route} route) launch failed: "
                           f"cudaError {err}")
    if data[0].shape[-1]:   # an empty batch launches nothing
        launches["fused"] += 1
        route_launches[f"fused {route}"] += 1
    return outs


#: the most dynamic shared memory a block may take on sm_90, in bytes
SHARED_CAP = 232448


def team_values(sizes: Tuple[int, int, int, int, int]) -> int:
    """An upper bound on the values one team keeps in shared memory
    (``csrc/fused_team.cuh``: TeamLayout) for ``sizes`` = (n, m_ineq,
    m_eq, variables, augmented order): the staged data, seven work
    vectors, the packed factor, D, b, and team slots for at most four
    vectors of variables, plus the padding."""
    n, m, e, total, aug = sizes
    ld = n | 1
    data = (n + m + e) * ld + n + 2 * m + e + 2 * n
    return data + 7 * total + aug * (aug + 1) // 2 + 2 * aug + 4 * total + 48


#: the largest augmented order the thread route is built for: its
#: per-thread arrays (the packed factor among them) live in local memory
THREAD_MAX_AUG = 128


def block_values(sizes: Tuple[int, int, int, int, int], slots: int) -> int:
    """The values the block route keeps in one block's shared memory
    (``csrc/fused_wide_block.cuh``: BlockLayout) for ``sizes``: seven
    work vectors, the packed factor, D, b, two buffers of a column's
    products, ``slots`` team slots (the generated code's,
    ``FusedBatchedIPM.k1_slots``) and the flag."""
    n, m, e, total, aug = sizes
    return 7 * total + aug * (aug + 1) // 2 + 4 * aug + slots + 1


#: K1's block route where it was measured faster than the wide route, per
#: type: rows (lowest augmented order, highest, warps a block).  Measured
#: on an H100 80GB HBM3 at 700 W by chip_smoke.py step 45, a cold
#: solve_fused(max_iter=14), ms by CUDA events, wide / block at W = 2, 4,
#: 8 (PERF.md section 6): float32 at aug 129 (portfolio, B=1024) 11.13 /
#: 5.08, 4.74, 5.79; at aug 161 (portfolio, B=512) 14.34 / 6.43, 5.70,
#: 5.37; at aug 192 (the default formulation at n=128, m_ineq=64, B=512)
#: 31.33 / 15.61, 13.82, 17.84; at aug 225 (portfolio, B=256) 26.71 /
#: 11.93, 9.83, 9.16 (chip_profile.py wide); at aug 257 (portfolio,
#: B=256) 39.03 / 14.48, 11.64, 10.83; float64 at aug 129 32.90 / 10.05,
#: 9.08, 9.04, at aug 161 37.96 / 14.48, 12.50, 12.10 and at aug 192
#: 96.05 / 52.54, 46.06, 44.84.  Each order between measured ones takes
#: the W of the nearer: the best W follows the blocks an SM holds (W=8
#: won where it kept W=4's, at aug 161, 225 and 257 f32), which the order
#: alone does not give.  float64 at aug 225 and 257 does not fit a
#: block's shared memory, and nothing above the measured orders is taken.
K1_BLOCK_RULE = {
    torch.float32: ((129, 145, 4), (146, 176, 8), (177, 208, 4),
                    (209, 257, 8)),
    torch.float64: ((129, 192, 8),),
}


def block_warps(sizes: Tuple[int, int, int, int, int], dtype: torch.dtype,
                slots: int) -> Optional[int]:
    """The block route's warps a block for ``sizes`` in ``dtype`` where
    K1_BLOCK_RULE takes it and its block fits the shared memory
    (:func:`block_values` with the generated code's ``slots``), else
    None."""
    aug = sizes[4]
    if block_values(sizes, slots) * (torch.finfo(dtype).bits // 8) > \
            SHARED_CAP:
        return None
    for lo, hi, warps in K1_BLOCK_RULE.get(dtype, ()):
        if lo <= aug <= hi:
            return warps
    return None


def k1_route(B: int, sizes: Tuple[int, int, int, int, int],
             dtype: torch.dtype, slots: Optional[int] = None) -> str:
    """K1's route for a launch of ``B`` instances of ``sizes`` = (n,
    m_ineq, m_eq, variables, augmented order): ``"team"`` wherever a
    block of four teams fits the shared memory, else ``"thread"`` up to
    augmented order THREAD_MAX_AUG, else ``"block"`` where
    :func:`block_warps` takes it (K1_BLOCK_RULE's measured rows, the
    block within the shared memory with the generated code's ``slots``,
    ``FusedBatchedIPM.k1_slots``, which that choice needs: without them
    it raises), else ``"wide"``.  On an H100 the team route was the
    faster at every launch of the fused slice (B=10240 cold and warm,
    1536, the 512 Gondzio tile) and at B=32, in float32 and float64, by
    3.5-8.5x (PERF.md section 6); above order 128 the block route was
    measured against the wide one at the batches K1_BLOCK_RULE names.
    The batch size does not enter the rule.  Pure: the same arguments
    give the same route."""
    itemsize = torch.finfo(dtype).bits // 8
    teams_per_block = 4     # 64 threads of 16 lanes: the largest block
    if teams_per_block * team_values(sizes) * itemsize <= SHARED_CAP:
        return "team"
    if sizes[4] <= THREAD_MAX_AUG:
        return "thread"
    if slots is None:
        raise ValueError(f"K1's route above order {THREAD_MAX_AUG} (here "
                         f"{sizes[4]}) needs the generated code's team "
                         f"slots (FusedBatchedIPM.k1_slots)")
    return "block" if block_warps(sizes, dtype, slots) else "wide"


def team_shape(lib: ctypes.CDLL, dtype: torch.dtype) -> Dict[str, int]:
    """What a team build is for ``dtype``: lanes a team, threads a block,
    bytes of shared memory a team and teams resident per SM (0 in a host
    build)."""
    fn = lib.ipmzoo_fused_team_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(torch.finfo(dtype).bits // 8, out)
    if err:
        raise RuntimeError(f"K1 team route: occupancy query failed: "
                           f"cudaError {err}")
    return dict(zip(("lanes", "threads", "team_bytes", "teams_per_sm"),
                    out))


def wide_shape(lib: ctypes.CDLL, dtype: torch.dtype,
               kernel: str = "fused") -> Dict[str, int]:
    """What a wide build is for ``dtype``: lanes an instance, threads a
    block, values of workspace an instance (its TeamLayout region) and
    blocks resident per SM (0 in a host build); ``kernel`` "fused" asks
    K1's library, "phase" a T3 prefix's."""
    fn = getattr(lib, f"ipmzoo_{kernel}_wide_shape")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(torch.finfo(dtype).bits // 8, out)
    if err:
        raise RuntimeError(f"{kernel} wide route: occupancy query failed: "
                           f"cudaError {err}")
    return dict(zip(("lanes", "threads", "region", "blocks_per_sm"), out))


def block_shape(lib: ctypes.CDLL, dtype: torch.dtype, warps: int,
                kernel: str = "fused") -> Dict[str, int]:
    """What a block build is for ``dtype`` at ``warps`` warps a block:
    lanes of the team, threads a block, values of workspace an instance
    (the staged data), bytes of shared memory a block and blocks resident
    per SM (0 in a host build, and where the block does not fit);
    ``kernel`` "fused" asks K1's library, "phase" a T3 prefix's."""
    fn = getattr(lib, f"ipmzoo_{kernel}_block_shape")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(torch.finfo(dtype).bits // 8, warps, out)
    if err:
        raise RuntimeError(f"{kernel} block route: occupancy query failed: "
                           f"cudaError {err}")
    return dict(zip(("lanes", "threads", "region", "shared_bytes",
                     "blocks_per_sm"), out))


def region_values(lib: ctypes.CDLL, dtype: torch.dtype, route: str,
                  warps: Optional[int] = None,
                  kernel: str = "fused") -> Optional[int]:
    """The workspace values an instance of a launch of ``lib``, built on
    ``route``: the wide route's region (:func:`wide_shape`), the block
    route's staged data at ``warps`` (:func:`block_shape`), None on the
    routes that keep everything in shared memory or registers; ``kernel``
    "fused" for K1's library, "phase" for a T3 prefix's."""
    if route == "wide":
        return wide_shape(lib, dtype, kernel)["region"]
    if route == "block":
        return block_shape(lib, dtype, warps, kernel)["region"]
    return None


#: T3's routes: entry-point prefixes and library names
_PHASE_ENTRY = {"thread": "ipmzoo_phase", "team": "ipmzoo_phase_team",
                "block": "ipmzoo_phase_block", "wide": "ipmzoo_phase_wide"}
PHASE_LIBS = {"thread": "fused_phase", "team": "fused_phase_team",
              "block": "fused_phase_block", "wide": "fused_phase_wide"}


def bind_phase(lib: ctypes.CDLL, dtype: torch.dtype, route: str = "thread"):
    """T3's entry point in ``lib`` (built from the ``route``'s source) for
    ``dtype``, with its ctypes signature; the routes take the same
    arguments, the wide route its workspace before the stream, the block
    route its warps a block and its workspace."""
    if dtype not in _SUFFIX:
        raise TypeError(f"T3 takes float32/float64, not {dtype}")
    fn = getattr(lib, f"{_PHASE_ENTRY[route]}_{_SUFFIX[dtype]}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ptr, i32, i32] + \
        _ROUTE_ARGTYPES.get(route, []) + [ptr]
    fn.restype = i32
    return fn


def call_phase(fn, data: Sequence[torch.Tensor], params: Sequence[float],
               reps: int = 1, perturb: int = 0, stream=None,
               region: Optional[int] = None, warps: Optional[int] = None):
    """Check the SoA data (as :func:`call`), allocate (acc, sink), each
    (1, B), on its device and call T3's entry point ``fn`` once; returns
    the outputs and the entry's status.  ``region`` and ``warps`` as in
    :func:`call`: the wide and block routes' workspace values an instance,
    allocated here on the data's device, and the block route's warps."""
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
    extra, work = _route_args(B, region, warps, dtype, device)
    err = fn(ptrs, outs[0].data_ptr(), outs[1].data_ptr(), B, prm, reps,
             perturb, *extra, stream)
    return outs, err


def phase_soa(source: str, data: Sequence[torch.Tensor],
              params: Sequence[float], reps: int = 1, perturb: int = 0,
              route: str = "thread", warps: Optional[int] = None):
    """Launch the prefix of T3 built from ``source`` (the text of
    ``route``) on SoA tensors of one CUDA device on the current stream,
    the block route on ``warps`` warps a block; (acc, sink), each (1, B).
    A failed build or launch raises: there is no other route to fall back
    on."""
    if route not in _PHASE_ENTRY:
        raise ValueError(f"T3 has no route {route!r}")
    if (route == "block") != (warps is not None):
        raise ValueError(f"T3's {route} route takes warps={warps}: the "
                         f"block route needs its warps, no other takes any")
    device = data[0].device
    if device.type != "cuda":
        raise ValueError(f"T3 needs CUDA tensors, got {device}")
    lib = library(source, PHASE_LIBS[route])
    fn = bind_phase(lib, data[0].dtype, route)
    with torch.cuda.device(device):
        region = region_values(lib, data[0].dtype, route, warps, "phase")
        stream = torch.cuda.current_stream(device).cuda_stream
        outs, err = call_phase(fn, data, params, reps, perturb, stream,
                               region, warps)
    if err:
        raise RuntimeError(f"T3 (fused phases, {route} route) launch failed: "
                           f"cudaError {err}")
    if data[0].shape[-1]:
        launches["phase"] += 1
        phase_route_launches[f"phase {route}"] += 1
    return outs
