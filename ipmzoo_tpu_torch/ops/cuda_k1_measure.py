"""K1's routes measured: on the wide and block routes
(``csrc/k1_wide_measure.cuh``) the factor alone and the share of a launch
in the factor, on the team route (``csrc/k1_team_measure.cuh``) that
share.

:func:`source` prints the block route's text
(``models/fused_source.py:fused_wide_block_source``) followed by
``csrc/k1_clock.cuh``, the measurement header and its entry points;
:func:`team_source` the team route's text
(``models/fused_source.py:fused_team_source``) followed by the same clock
helpers, ``csrc/k1_team_measure.cuh`` and its entry points.  One library
per formulation and sizes, built at first use as K1's are.
``chip_profile.py wide`` and ``fused`` read them; no solver loads them,
and they count no launch of K1.

* :func:`factor_reps`: the LDL^T of the wide route (``team_ldlt`` on one
  warp, the factor in a device-memory workspace) or of the block route
  (``block_ldlt`` on W warps, the factor in shared memory) alone,
  repeated in one launch.
* :func:`clocked`: one launch of the wide or the block route's kernel
  with its factor clocked; per instance the SM cycles its team spent in
  the factor and the cycles its block lived.  :func:`clocked_team` the
  same on the team route, the cycles from the block's start to the
  team's end.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_fused

HEADER = Path(__file__).resolve().parents[1] / "csrc" / \
    "k1_wide_measure.cuh"
TEAM_HEADER = HEADER.with_name("k1_team_measure.cuh")
CLOCK_HEADER = HEADER.with_name("k1_clock.cuh")


def _text(route_text: str, header: Path, entry: str) -> str:
    return "\n".join([route_text, f'#line 1 "{CLOCK_HEADER.name}"',
                      CLOCK_HEADER.read_text(), f'#line 1 "{header.name}"',
                      header.read_text(), f"{entry}(ipmzoo_fused::Form)",
                      ""])


def source(solver) -> str:
    """The wide and block routes' measurement library's text for
    ``solver``'s formulation and sizes."""
    from ..models.fused_source import fused_wide_block_source
    return _text(fused_wide_block_source(solver), HEADER,
                 "IPMZOO_K1_MEASURE_ENTRY_POINTS")


def team_source(solver) -> str:
    """The team route's measurement library's text for ``solver``'s
    formulation and sizes, at the team route's lanes."""
    from ..models.fused_source import fused_team_source
    return _text(fused_team_source(solver), TEAM_HEADER,
                 "IPMZOO_K1_TEAM_MEASURE_ENTRY_POINTS")


def library(solver) -> ctypes.CDLL:
    """The built and loaded measurement library for ``solver``."""
    return cuda_fused.library(source(solver), "k1_wide_measure")


def team_library(solver) -> ctypes.CDLL:
    """The built and loaded team-route measurement library for
    ``solver``."""
    return cuda_fused.library(team_source(solver), "k1_team_measure")


def factor_reps(lib: ctypes.CDLL, K0: torch.Tensor, reps: int, warps: int,
                pivot_floor: float, resident: int = 0, pad: int = 0,
                stream=None) -> Tuple[torch.Tensor, int]:
    """``reps`` LDL^T factorisations of each packed matrix of ``K0`` (B,
    order (order + 1) / 2; the order the library's), each from a fresh
    copy, on ``warps`` warps with the factor in shared memory or, warps =
    0, on one warp with it in a device-memory workspace.  ``resident`` >
    0: a grid of that many blocks an SM, each looping over the
    instances; ``pad`` > 0: bytes of shared memory each block asks for
    all the same.  Returns sink (B,): over the repetitions, the sum of D
    and of the last row of L; and the entry's status."""
    dtype = K0.dtype
    fn = getattr(lib, f"ipmzoo_k1_factor_reps_{cuda_fused._SUFFIX[dtype]}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ctypes.c_longlong, i32, i32, i32, i32,
                   cuda_fused._CTYPE[dtype], ptr, ptr, ptr]
    fn.restype = i32
    cuda_fused._check("K0", K0, K0.shape, dtype, K0.device)
    B, tri = K0.shape
    order = int(((8 * tri + 1) ** 0.5 - 1) / 2)
    work = torch.empty(B * (tri + order), dtype=dtype, device=K0.device)
    sink = torch.empty(B, dtype=dtype, device=K0.device)
    err = fn(K0.data_ptr(), B, reps, warps, resident, pad, pivot_floor,
             work.data_ptr(), sink.data_ptr(), stream)
    return sink, err


def _clocked(raw, extra, data, warm, n, total, max_iter, gondzio, params,
             stream, region=None, warps=None):
    """One call of a clocked entry ``raw`` (K1's arguments, ``extra``
    ctypes before the cycles and the stream) through
    ``cuda_fused.call``; returns K1's six outputs, cycles (2, B) int64
    and the entry's status."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    raw.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr, i32, i32,
                    i32] + extra + [ptr, ptr]
    raw.restype = i32
    B = data[0].shape[-1]
    cycles = torch.zeros((2, B), dtype=torch.int64, device=data[0].device)

    def fn(*args):
        return raw(*args[:-1], cycles.data_ptr(), args[-1])

    outs, err = cuda_fused.call(fn, data, warm, n, total, max_iter, gondzio,
                                params, stream, region, warps)
    return outs, cycles, err


def clocked(lib: ctypes.CDLL, data: Sequence[torch.Tensor],
            warm: Optional[Tuple[torch.Tensor, ...]], n: int, total: int,
            max_iter: int, gondzio: int, params: Sequence[float],
            warps: int, region: int, stream=None):
    """One launch of the wide route's kernel (``warps`` = 0) or the block
    route's on ``warps`` warps, its factor clocked, on SoA tensors
    (arguments as ``cuda_fused.call``; ``region``: the route's values of
    workspace an instance).  Returns K1's six outputs, cycles (2, B)
    int64 (the factor's cycles, then the block's life, per instance; 0 in
    a host build) and the entry's status."""
    sfx = cuda_fused._SUFFIX[data[0].dtype]
    raw = getattr(lib, f"ipmzoo_k1_clocked_{sfx}")
    return _clocked(raw, [ctypes.c_int, ctypes.c_void_p], data, warm, n,
                    total, max_iter, gondzio, params, stream, region, warps)


def clocked_team(lib: ctypes.CDLL, data: Sequence[torch.Tensor],
                 warm: Optional[Tuple[torch.Tensor, ...]], n: int,
                 total: int, max_iter: int, gondzio: int,
                 params: Sequence[float], stream=None):
    """One launch of the team route's kernel with its factor clocked, from
    :func:`team_library`, on SoA tensors (arguments as
    ``cuda_fused.call``).  Returns K1's six outputs, cycles (2, B) int64
    (the factor's cycles, then the cycles from the block's start to the
    team's end, per instance; 0 in a host build) and the entry's
    status."""
    sfx = cuda_fused._SUFFIX[data[0].dtype]
    raw = getattr(lib, f"ipmzoo_k1_clocked_team_{sfx}")
    return _clocked(raw, [], data, warm, n, total, max_iter, gondzio, params,
                    stream)
