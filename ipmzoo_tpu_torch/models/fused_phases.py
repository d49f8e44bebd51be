"""Kernel T3, the prefixes of one fused iteration: the source generators
and the plain version (counterpart of ``tools/fused_phases.py``).

K1 runs a whole interior-point solve per instance.  T3 runs, at the cold
start of that solve, only a prefix of one iteration — the start iterate
| + KKT assembly | + the LDL^T factor | + the predictor and corrector
directions | + three metrics evaluations — through the very functions K1
runs, so that the time and, from ptxas, the registers, stack frame and
spills of each prefix can be read apart.  It has K1's two routes below
order 128:

* the thread route, :func:`phase_source`: ``csrc/fused_ipm.cuh``,
  ``csrc/fused_phases.cuh`` (``phase_kernel<F, T, PHASE>``, one thread an
  instance), the ``struct Form`` of :func:`.fused_source.form_struct` and
  the entry points for that PHASE;
* the team route, :func:`phase_team_source`: the team route's text
  (``csrc/fused_ipm.cuh``, ``csrc/fused_team.cuh``,
  ``csrc/fused_phases_team.cuh``: ``phase_team_kernel<F, T, PHASE>``, a
  team of lanes an instance with its region in shared memory, and the
  ``struct Form`` of :class:`.codegen_team.CppTeam`) with the entry points
  for that PHASE.

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
from .fused_source import (CUH, TEAM_CUH, _team_text, describe, form_struct,
                           team_lanes)

PHASE_CUH = Path(__file__).resolve().parents[1] / "csrc" / "fused_phases.cuh"
PHASE_TEAM_CUH = PHASE_CUH.with_name("fused_phases_team.cuh")

#: what each prefix adds to the one before
PHASES = ("start iterate only", "+ assemble", "+ factor",
          "+ directions (predictor, corrector)", "+ metrics x3")
#: T3's routes, each K1's of the same name
ROUTES = ("thread", "team")


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
    and the scalar settings, as K1's."""
    _check_prefix(solver, phase)
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
    ``csrc/fused_phases.cuh``.  Both routes compute this function."""
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


def phase(solver, data_soa, phase: int, reps: int = 1, perturb: int = 0,
          route: str = None):
    """Prefix ``phase`` on SoA tensors: kernel T3 for CUDA tensors (built
    at first use) on ``route`` ("thread" or "team"; None: the route K1
    takes at this shape, :func:`phase_route`, which raises where that is
    neither), its plain version for CPU tensors; (acc, sink), each
    (1, B)."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"T3 has no route {route!r}: {ROUTES}")
    device = data_soa[0].device
    if device.type == "cpu":
        return phase_plain(solver, data_soa, phase, reps, perturb)
    if route is None:
        route = phase_route(solver, data_soa[0].shape[-1])
        if route not in ROUTES:
            raise ValueError(f"K1 takes its {route} route at this shape; "
                             f"T3 has only {ROUTES}")
    # the text is generated once per solver, route and prefix, as K1's is
    sources = solver._phase_sources
    if (route, phase) not in sources:
        make = phase_team_source if route == "team" else phase_source
        sources[(route, phase)] = make(solver, phase)
    return cuda_fused.phase_soa(sources[(route, phase)], data_soa,
                                solver.kernel_params(), reps, perturb, route)
