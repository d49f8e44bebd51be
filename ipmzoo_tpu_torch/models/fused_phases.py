"""Kernel T3, the prefixes of one fused iteration: the source generators
and the plain version (counterpart of ``tools/fused_phases.py``).

K1 runs a whole interior-point solve per instance.  T3 runs, at the cold
start of that solve, only a prefix of one iteration — the start iterate
| + KKT assembly | + the LDL^T factor | + the predictor and corrector
directions | + three metrics evaluations — through the very functions K1
runs, so that the time and, from ptxas, the registers, stack frame and
spills of each prefix can be read apart.  It has K1's four routes, so
that it runs on the route K1 itself takes at every order and dtype K1
runs:

* the thread route, :func:`phase_source`: ``csrc/fused_ipm.cuh``,
  ``csrc/fused_phases.cuh`` (``phase_kernel<F, T, PHASE>``, one thread an
  instance), the ``struct Form`` of :func:`.fused_source.form_struct` and
  the entry points for that PHASE;
* the team route, :func:`phase_team_source`: the team route's text
  (``csrc/fused_ipm.cuh``, ``csrc/fused_team.cuh``,
  ``csrc/fused_phases_team.cuh``: ``phase_team_kernel<F, T, PHASE>``, a
  team of lanes an instance with its region in shared memory, and the
  ``struct Form`` of :class:`.codegen_team.CppTeam`) with the entry points
  for that PHASE;
* the block route, :func:`phase_block_source`: K1's block route's text
  (the team code at 32 lanes and ``csrc/fused_wide_block.cuh``),
  ``csrc/fused_phases_team.cuh`` and ``csrc/fused_phases_block.cuh``
  (``phase_block_kernel<F, T, PHASE>``: a thread block of W = 2, 4 or 8
  warps an instance, warp 0 running the prefix and all W warps the
  factor, on K1's shared layout and device-memory workspace);
* the wide route, :func:`phase_wide_source`: K1's wide route's text (the
  team code at 32 lanes and ``csrc/fused_wide.cuh``),
  ``csrc/fused_phases_team.cuh`` and ``csrc/fused_phases_wide.cuh``
  (``phase_wide_kernel<F, T, PHASE>``: one warp an instance, its region in
  a device-memory workspace).

Each prefix is a translation unit of its own.  :func:`phase` launches one
through ``ops/cuda_fused.py`` for CUDA tensors, on the route K1 itself
takes at that shape unless one is named, and runs :func:`phase_plain`,
torch over the solver's own SoA pieces, for CPU tensors.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..ops import cuda_fused
from . import codegen_soa as soa
from .fused import DATA_FIELDS, _ldlt_soa
from .fused_source import (BLOCK_CUH, CUH, TEAM_CUH, WIDE_CUH, _team_text,
                           describe, form_struct, team_lanes)

PHASE_CUH = Path(__file__).resolve().parents[1] / "csrc" / "fused_phases.cuh"
PHASE_TEAM_CUH = PHASE_CUH.with_name("fused_phases_team.cuh")
PHASE_BLOCK_CUH = PHASE_CUH.with_name("fused_phases_block.cuh")
PHASE_WIDE_CUH = PHASE_CUH.with_name("fused_phases_wide.cuh")

#: what each prefix adds to the one before
PHASES = ("start iterate only", "+ assemble", "+ factor",
          "+ directions (predictor, corrector)", "+ metrics x3")
#: T3's routes, each K1's of the same name
ROUTES = ("thread", "team", "block", "wide")


def _check_prefix(solver, phase: int) -> None:
    if phase not in range(len(PHASES)):
        raise ValueError(f"phase {phase}: expected 0..{len(PHASES) - 1}")
    if not solver.var_sizes or solver.var_sizes[0] == 0:
        raise NotImplementedError(
            "the first variable of the system is empty: the prefixes' "
            "accumulator reads the first entry of its delta")


def phase_source(solver, phase: int) -> str:
    """T3's thread route for prefix ``phase`` (0-4) of ``solver``'s
    formulation and sizes.  Deterministic, and independent of the dtype
    and the scalar settings, as K1's; refused above order THREAD_MAX_AUG,
    where K1's thread route is not built either."""
    _check_prefix(solver, phase)
    if solver.aug_dim > cuda_fused.THREAD_MAX_AUG:
        raise ValueError(f"T3's thread route, as K1's, is built only up to "
                         f"order {cuda_fused.THREAD_MAX_AUG}, not "
                         f"{solver.aug_dim}")
    body, total = form_struct(solver)
    head = (["// Kernel T3, generated by "
             "ipmzoo_tpu_torch/models/fused_phases.py.",
             f"// prefix {phase}: {PHASES[phase]}"]
            + describe(solver, total) + ['#line 1 "fused_ipm.cuh"'])
    return "\n".join(
        head + [CUH.read_text(), '#line 1 "fused_phases.cuh"',
                PHASE_CUH.read_text(), '#line 1 "generated"',
                "namespace ipmzoo_fused {", ""] + body
        + ["}  // namespace ipmzoo_fused", "",
           f"IPMZOO_PHASE_ENTRY_POINTS(ipmzoo_fused::Form, {phase})", ""])


def phase_team_source(solver, phase: int) -> str:
    """T3's team route for prefix ``phase`` (0-4) of ``solver``'s
    formulation and sizes, at K1's lanes a team
    (:func:`.fused_source.team_lanes`).  Deterministic, keyed by the
    formulation, the sizes and the prefix, independent of the dtype and
    the scalar settings."""
    _check_prefix(solver, phase)
    return _team_text(solver, f"Kernel T3, team route, prefix {phase}: "
                      f"{PHASES[phase]}", team_lanes(solver),
                      (TEAM_CUH, PHASE_TEAM_CUH),
                      "IPMZOO_PHASE_TEAM_ENTRY_POINTS", args=f", {phase}")


def phase_block_source(solver, phase: int) -> str:
    """T3's block route for prefix ``phase`` (0-4) of ``solver``'s
    formulation and sizes: K1's block route's text
    (:func:`.fused_source.fused_wide_block_source`: the team code at 32
    lanes, the same ``struct Form``), the prefix's headers and its entry
    points.  Deterministic, independent of the dtype, the scalar settings
    and the warps a block (a launch argument, as K1's)."""
    _check_prefix(solver, phase)
    return _team_text(solver, f"Kernel T3, block route, prefix {phase}: "
                      f"{PHASES[phase]}", 32,
                      (TEAM_CUH, BLOCK_CUH, PHASE_TEAM_CUH, PHASE_BLOCK_CUH),
                      "IPMZOO_PHASE_BLOCK_ENTRY_POINTS", args=f", {phase}")


def phase_wide_source(solver, phase: int) -> str:
    """T3's wide route for prefix ``phase`` (0-4) of ``solver``'s
    formulation and sizes: K1's wide route's text
    (:func:`.fused_source.fused_wide_source`), the prefix's headers and its
    entry points.  Deterministic, independent of the dtype and the scalar
    settings."""
    _check_prefix(solver, phase)
    return _team_text(solver, f"Kernel T3, wide route, prefix {phase}: "
                      f"{PHASES[phase]}", 32,
                      (TEAM_CUH, WIDE_CUH, PHASE_TEAM_CUH, PHASE_WIDE_CUH),
                      "IPMZOO_PHASE_WIDE_ENTRY_POINTS", args=f", {phase}")


#: each route's source of a prefix
SOURCES = {"thread": phase_source, "team": phase_team_source,
           "block": phase_block_source, "wide": phase_wide_source}


def phase_route(solver, B: int) -> str:
    """The route K1 takes for a launch of ``B`` instances of ``solver``'s
    sizes (:func:`..ops.cuda_fused.k1_route`): T3's default."""
    slots = (solver.k1_slots() if solver.aug_dim > cuda_fused.THREAD_MAX_AUG
             else None)
    return cuda_fused.k1_route(B, solver.k1_sizes(), solver.dtype, slots)


def phase_plain(solver, data_soa, phase: int, reps: int = 1,
                perturb: int = 0):
    """T3's plain version on SoA tensors of any device (data fields
    (..., B) in ``DATA_FIELDS`` order): returns (acc, sink), each (1, B).
    ``acc`` is the reference kernel's value; ``sink`` also sums
    everything a phase produces.  ``reps`` and ``perturb`` as in
    ``csrc/fused_phases.cuh``.  All four routes compute this
    function."""
    o = solver.symbols
    dt = solver.dtype
    B = data_soa[0].shape[-1]
    dev = data_soa[0].device
    ev = soa.TorchSoA(dt, dev, B)
    fields = dict(zip(DATA_FIELDS, data_soa))
    data_tvs = {getattr(o, f): soa.TV("matrix" if a.dim() == 3 else "vector",
                                      a)
                for f, a in fields.items()}

    def make_env(var_vals, mu_val):
        return solver._env_soa(data_tvs, var_vals, mu_val)

    init = {o.x: 0.5 * (fields["l_x"] + fields["u_x"]),
            o.s_A_ineq: 0.5 * (fields["l_A_ineq"] + fields["u_A_ineq"])}
    start = tuple(init.get(v, torch.ones((sz, B), dtype=dt, device=dev))
                  for v, sz in zip(solver.full.variables, solver.var_sizes))
    mu = torch.full((1, B), solver.mu0, dtype=dt, device=dev)
    zero_mu = ev.zero_scalar()
    N = solver.aug_dim
    below = torch.tril(torch.ones((N, N), dtype=dt, device=dev), -1)

    def total(parts):
        return sum(p.sum(0, keepdim=True) for p in parts)

    acc = torch.zeros((1, B), dtype=dt, device=dev)
    sink = torch.zeros((1, B), dtype=dt, device=dev)
    for r in range(reps):
        var_vals = tuple(v * (1.0 + 1e-6 * r) for v in start)
        if phase == 0:
            sink = sink + total(var_vals)
        env = make_env(var_vals, mu)
        if phase >= 1:
            K = solver._assemble_soa(ev, env)
            s = K.sum((0, 1))[None, :]
            acc, sink = acc + s, sink + s
        if phase >= 2:
            L, D = _ldlt_soa(K, solver.pivot_floor)
            acc = acc + D[0:1, :]
            sink = sink + D.sum(0, keepdim=True) + \
                (L * below[:, :, None]).sum((0, 1))[None, :]
        if phase >= 3:
            renv = solver._residual_env_soa(ev, make_env, env, zero_mu)
            d_aff = solver._search_direction_soa(ev, (L, D), renv)
            cenv = solver._residual_env_soa(ev, make_env, env, mu,
                                            var_vals=var_vals,
                                            affine_deltas=d_aff)
            d_cc = solver._search_direction_soa(ev, (L, D), cenv)
            acc = acc + d_cc[0][0:1, :]
            sink = sink + total(d_cc)
        if phase >= 4:
            for k in range(3):
                nudge = 1.0 + 1e-6 * (k * perturb)
                res, gap = solver._metrics_soa(ev, make_env(
                    tuple(v * nudge for v in var_vals), zero_mu))
                acc, sink = acc + res + gap, sink + res + gap
    return acc, sink


def launch_route(solver, B: int, route: str = None):
    """(route, warps) of a launch of ``B`` instances: ``route`` (one of
    ROUTES; None: K1's, :func:`phase_route`) and, on the block route,
    K1's warps a block (:func:`..ops.cuda_fused.block_warps`), else
    None.  Raises on a route T3 does not have and on the block route
    where K1 takes none at these sizes."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"T3 has no route {route!r}: {ROUTES}")
    route = route or phase_route(solver, B)
    if route != "block":
        return route, None
    warps = cuda_fused.block_warps(solver.k1_sizes(), solver.dtype,
                                   solver.k1_slots())
    if warps is None:
        raise ValueError(f"K1 takes no block route at aug_dim "
                         f"{solver.aug_dim} in {solver.dtype}")
    return route, warps


def phase(solver, data_soa, phase: int, reps: int = 1, perturb: int = 0,
          route: str = None):
    """Prefix ``phase`` on SoA tensors: kernel T3 for CUDA tensors (built
    at first use) on ``route`` (one of ROUTES; None: the route K1 takes at
    this shape, at K1's warps a block on the block route:
    :func:`launch_route`), its plain version for CPU tensors; (acc, sink),
    each (1, B)."""
    B = data_soa[0].shape[-1]
    route, warps = launch_route(solver, B, route)
    if data_soa[0].device.type == "cpu":
        return phase_plain(solver, data_soa, phase, reps, perturb)
    # the text is generated once per solver, route and prefix, as K1's is
    sources = solver._phase_sources
    if (route, phase) not in sources:
        sources[(route, phase)] = SOURCES[route](solver, phase)
    return cuda_fused.phase_soa(sources[(route, phase)], data_soa,
                                solver.kernel_params(), reps, perturb, route,
                                warps)
