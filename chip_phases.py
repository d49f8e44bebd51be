#!/usr/bin/env python3
"""Phase breakdown of the fused whole-solve kernel K1 on one NVIDIA GPU
(the port's counterpart of tools/fused_phases.py).

    python3 chip_phases.py       # from the repository root; needs one
                                 # CUDA card and nvcc

Kernel T3 runs, at the cold start of a fused solve, successive prefixes
of one fused iteration through the functions K1 itself runs:

    start iterate | + assemble | + factor | + directions | + metrics x3

It has K1's four routes (ipmzoo_tpu_torch/models/fused_phases.py), and
this script runs it at three points, each on the routes K1 takes there:

* the fused slice (Settings(), n=16, m_ineq=8, augmented order 24, bench
  workload, numpy seed 0) at B=10240 and 512: the thread route (one
  thread an instance, csrc/fused_phases.cuh) and the team route (16 lanes
  an instance, csrc/fused_phases_team.cuh), the route K1 takes there;
* the wide slice (portfolio of 128 assets, seed 0, augmented order 129)
  at B=4096 (its batch) and 512: the block route (a thread block of W
  warps an instance, csrc/fused_phases_block.cuh) at K1_BLOCK_RULE's W,
  4 in float32 and 8 in float64;
* a portfolio of 256 assets (augmented order 257) in float64 at B=256,
  where the block does not fit: the wide route (one warp an instance,
  csrc/fused_phases_wide.cuh).

Each prefix of each route is generated and built as a translation unit of
its own (all nvcc processes, and K1's, started together), so ptxas
reports its registers, stack frame and spills alone.  The script holds
each prefix of each route to its plain version (float64 within 1e-10,
float32 within 1e-4, both outputs, the metrics nudge off and on), then
prints for each route and point: the time of each prefix per in-kernel
repetition (a slope over repetition counts, so without the launch), the
difference to the prefix before (the phase's cost; an estimate, since two
prefixes are two register allocations), one whole launch, the slope's
bound (the prefix's operations, counted from the solver's sizes, over the
card's peak) and ptxas' figures; beside them K1's ``solve_fused(max_iter=
1)`` on the same data on the same route (and at the fused slice one
``CompiledIPM.step``).  At each point's largest batch no slope may lie
below its bound.  The three metrics calls run on iterates nudged by a
run-time factor (see csrc/fused_phases.cuh), so the compiler cannot merge
them.  Exits 2 without a CUDA device.
"""

import functools
import re
import sys

from chip_roofline import (banner, build_all, check, dtype_name, fused_solver,
                           rel_diff)
from ipmzoo_tpu_torch.ops.cuda_fused import PHASE_LIBS

B_SLICE, B_TILE = 10240, 512
#: the points: (batches, dtypes, routes); "slice" is the fused slice,
#: "wide" the wide slice (portfolio of WIDE_ASSETS assets), "wide route"
#: the portfolio of WIDE_ROUTE_ASSETS where K1 takes its wide route
WIDE_ASSETS, WIDE_ROUTE_ASSETS = 128, 256
POINTS = {"slice": ((B_SLICE, B_TILE), ("float32", "float64"),
                    ("thread", "team")),
          "wide": ((4096, 512), ("float32", "float64"), ("block",)),
          "wide route": ((256,), ("float64",), ("wide",))}
#: the fused slice's routes (what chip_smoke.py times at B_SLICE)
ROUTES = POINTS["slice"][2]
#: every (point, route) whose prefixes are built
BUILDS = tuple((p, r) for p, (_, _, routes) in POINTS.items()
               for r in routes)


def _dtype(name):
    import torch
    return getattr(torch, name)


@functools.lru_cache(maxsize=None)
def point_solver(point, dev, dtype):
    """The solver of ``point`` on ``dev`` in ``dtype`` (one a point, so
    its generated sources are made once): the fused slice's, or a
    portfolio's FusedBatchedIPM at tol 1e-6 (the wide slice's settings)."""
    if point == "slice":
        return fused_solver(dev, dtype)
    from ipmzoo_tpu_torch.models.families import portfolio
    from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
    n = WIDE_ASSETS if point == "wide" else WIDE_ROUTE_ASSETS
    fam = portfolio(n_assets=n, seed=0, dtype=dtype, device="cpu")
    return FusedBatchedIPM(fam.settings, fam.n, fam.m_ineq, fam.m_eq,
                           dtype=dtype, tol=1e-6, device=dev)


@functools.lru_cache(maxsize=None)
def _inputs(point, B, dev, dtype):
    if point == "slice":
        from ipmzoo_tpu_torch.models.convert import make_batch
        return make_batch(B, 16, 8, dtype, device=dev)
    from ipmzoo_tpu_torch.models.families import portfolio
    n = WIDE_ASSETS if point == "wide" else WIDE_ROUTE_ASSETS
    return portfolio(n_assets=n, batch=B, seed=0, dtype=dtype,
                     device=dev).data


def point_inputs(point, B, dev, dtype):
    """(solver, QPData, SoA data) of ``point`` at ``B`` instances: the
    fused slice's make_batch QPs, or the portfolios of seed 0."""
    solver = point_solver(point, dev, dtype)
    data = _inputs(point, B, dev, dtype)
    return solver, data, solver.soa_inputs(data)[0]


def matvec_flops(solver):
    """Operations of one set of the matrix-vector products Q x, A x and
    A^T y per instance at the solver's sizes (A both the inequality and
    the equality rows)."""
    n, m, e = solver.n, solver.m_ineq, solver.m_eq
    return 2 * n * n + 4 * (m + e) * n


def phase_flops(phase, solver):
    """Operations per instance of prefix ``phase``, cumulative, at the
    solver's sizes: the factor and each of the two solves at its augmented
    order as ``fused_flops`` counts them for T2 (about N^3/3 and 2 N^2
    operations), and one set of the matrix-vector products for the
    assembly, for each of the two right-hand sides and for each of the
    three metrics."""
    from ipmzoo_tpu_torch.ops.cuda_roofline import fused_flops
    fac, sol = fused_flops(solver.aug_dim)
    mv = matvec_flops(solver)
    per = [0, mv, fac, 2 * sol + 2 * mv, 3 * mv]
    return sum(per[:phase + 1])


def phase_sources(route="thread", point="slice"):
    """The five prefixes' sources of ``route`` at ``point`` (the text
    depends on neither the dtype nor the batch)."""
    import torch
    from ipmzoo_tpu_torch.models import fused_phases as fp
    solver = point_solver(point, "cpu", torch.float32)
    return [fp.SOURCES[route](solver, p) for p in range(len(fp.PHASES))]


def ptxas_rows(route="thread", point="slice"):
    """ptxas' registers, stack frame and spills of each prefix of
    ``route`` at ``point``, per dtype: {(phase, 'float32'|'float64'):
    dict}."""
    from ipmzoo_tpu_torch.ops import _build
    out = {}
    for p, src in enumerate(phase_sources(route, point)):
        lib = _build.generated_library_path(PHASE_LIBS[route], src)
        for k in _build.ptxas_report(lib):
            m = re.search(r"FormE([fd])Li", k["name"])
            if m:
                out[(p, "float32" if m.group(1) == "f" else "float64")] = k
    return out


def k1_sources():
    """K1's sources that the reference points launch, by build name:
    the thread and team routes at the fused slice, the block route at
    the wide slice and the wide route at WIDE_ROUTE_ASSETS."""
    import torch
    out = {}
    for point, route in (("slice", "thread"), ("slice", "team"),
                         ("wide", "block"), ("wide route", "wide")):
        solver = point_solver(point, "cpu", torch.float32)
        out[f"K1 {route} route ({point})"] = (route,
                                              solver.kernel_source(route))
    return out


def build_jobs():
    """Every build of this script, by name: each prefix of each route at
    its point, and K1's sources (k1_sources)."""
    from ipmzoo_tpu_torch.ops import cuda_fused
    jobs = {f"T3 {route} prefix {p} ({point})":
            lambda s=src, r=route: cuda_fused.library(s, PHASE_LIBS[r])
            for point, route in BUILDS
            for p, src in enumerate(phase_sources(route, point))}
    for name, (route, text) in k1_sources().items():
        jobs[name] = lambda t=text, r=route: cuda_fused.library(
            t, cuda_fused._LIB_NAME[r])
    return jobs


def build():
    """Build every prefix and K1's sources at once; print each build's
    time and ptxas' report."""
    for name, t in build_all(build_jobs()).items():
        print(f"build: {name} ready in {t:.2f} s")
    return report_ptxas()


def report_ptxas():
    """Print and return ptxas' figures of every prefix: {(point, route):
    rows}; and what K1's team, block and wide layouts are at the points
    the prefixes launch on them."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused
    out = {}
    for point, route in BUILDS:
        rows = out[(point, route)] = ptxas_rows(route, point)
        for (p, name), k in sorted(rows.items()):
            print(f"build: T3 {route} prefix {p} ({point}) {name}: "
                  f"{k['registers']} registers, {k['stack']} bytes stack "
                  f"frame, spill stores {k['spill_stores']} / loads "
                  f"{k['spill_loads']} bytes")
    # the team prefixes launch as K1's team route, on its layout and launch
    # bounds: K1's shape query holds for each of them
    team = point_solver("slice", "cpu", torch.float32).kernel_source("team")
    lib = cuda_fused.library(team, "fused_team")
    for dtype in (torch.float32, torch.float64):
        sh = cuda_fused.team_shape(lib, dtype)
        print(f"build: T3 team route (K1's team layout) {dtype_name(dtype)}: "
              f"{sh['lanes']} lanes, {sh['threads']} threads a block, "
              f"{sh['team_bytes']} bytes of shared memory a team, "
              f"{sh['teams_per_sm']} teams resident per SM")
    # the block and wide prefixes answer their own shape query
    for point, route in BUILDS:
        if route not in ("block", "wide"):
            continue
        _, dtypes, _ = POINTS[point]
        for p, src in enumerate(phase_sources(route, point)):
            lib = cuda_fused.library(src, PHASE_LIBS[route])
            for name in dtypes:
                solver = point_solver(point, "cpu", _dtype(name))
                if route == "block":
                    warps = cuda_fused.block_warps(
                        solver.k1_sizes(), solver.dtype, solver.k1_slots())
                    sh = cuda_fused.block_shape(lib, solver.dtype, warps,
                                                "phase")
                else:
                    sh = cuda_fused.wide_shape(lib, solver.dtype, "phase")
                print(f"build: T3 {route} route prefix {p} ({point}, "
                      f"aug_dim {solver.aug_dim}) {name}: {sh}")
                check(sh["lanes"] == 32 and sh["blocks_per_sm"] > 0,
                      f"T3's {route} prefix {p} does not fit: {sh}")
    return out


def check_phases(dev, B=B_SLICE, route="thread", point="slice",
                 dtypes=("float64", "float32"), phases=range(5)):
    """Each prefix of ``phases`` on ``route`` (None: the route K1 takes,
    which must be one of the point's) against its plain version on the card
    at ``B`` instances of ``point``: float64 within 1e-10 relative,
    float32 within 1e-4, both outputs, with the metrics nudge off (the
    reference kernel's value) and on.  Returns the largest absolute
    difference of either output of the last prefix at one repetition, by
    dtype name."""
    import torch
    from ipmzoo_tpu_torch.models import fused_phases as fp

    err = {}
    for name in dtypes:
        tol = 1e-10 if name == "float64" else 1e-4
        solver, _, soa = point_inputs(point, B, dev, _dtype(name))
        took = route or fp.phase_route(solver, B)
        check(took in POINTS[point][2], f"K1 takes its {took} route at "
              f"{point} B={B} {name}, not one of {POINTS[point][2]}")
        for p in phases:
            for reps, perturb in ((1, 0), (2, 1)):
                acc, sink = fp.phase(solver, soa, p, reps, perturb, route)
                acc0, sink0 = fp.phase_plain(solver, soa, p, reps, perturb)
                if acc.is_cuda:
                    torch.cuda.synchronize()
                check(bool(acc.isfinite().all()) and
                      bool(sink.isfinite().all()),
                      f"T3 {took} prefix {p}: non-finite output")
                ra = rel_diff(acc, acc0) if p else \
                    (acc - acc0).abs().max().item()
                rs = rel_diff(sink, sink0)
                print(f"T3 {took} prefix {p} vs plain ({point}, aug_dim "
                      f"{solver.aug_dim}) {name} B={B} reps={reps} "
                      f"perturb={perturb}: rel diff acc {ra:.3e} sink "
                      f"{rs:.3e} (limit {tol:g})")
                check(max(ra, rs) <= tol, f"T3 {took} prefix {p} "
                      f"disagrees with its plain version in {name}: "
                      f"{max(ra, rs):.3e} > {tol:g}")
                if reps == 1:
                    err[name] = max((acc - acc0).abs().max().item(),
                                    (sink - sink0).abs().max().item())
    return err


def slope_bound(phase, B, solver):
    """The least ms of one repetition of prefix ``phase`` on B instances
    of ``solver``'s sizes: its operations (phase_flops) over the card's
    peak for the type (the data is read once a launch, outside the
    repetitions)."""
    import torch
    peak = 67e12 if solver.dtype == torch.float32 else 33.5e12
    return phase_flops(phase, solver) * B / peak * 1e3


def time_phases(dev, B, dtype, ptxas=None, route="thread", point="slice"):
    """Milliseconds of each prefix of ``route`` at ``B`` instances of
    ``point``: per in-kernel repetition (the slope between two repetition
    counts, which leaves the launch and the first loads out) with the
    difference to the prefix before, one whole launch beside it, the
    slope's bound (slope_bound) and ptxas' figures.  Returns the list of
    per-repetition times and the list of one-launch times."""
    from ipmzoo_tpu_torch.models import fused_phases as fp
    from ipmzoo_tpu_torch.ops.cuda_roofline import reps_slope
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    name = dtype_name(dtype)
    solver, _, soa = point_inputs(point, B, dev, dtype)
    times, ones, prev = [], [], 0.0
    print(f"fused prefixes, {route} route ({point}, B={B}, n={solver.n}, "
          f"m_ineq={solver.m_ineq}, m_eq={solver.m_eq}, aug_dim="
          f"{solver.aug_dim}, {name}; metrics nudged; ms per in-kernel "
          f"repetition):")
    for p, what in enumerate(fp.PHASES):
        s = reps_slope(lambda r: fp.phase(solver, soa, p, r, 1, route),
                       min_diff_ms=0.1)
        one = cuda_time(lambda: fp.phase(solver, soa, p, 1, 1, route),
                        runs=3, calls=10, lead=1).ms
        k = (ptxas or {}).get((p, name))
        regs = (f"; {k['registers']} registers, {k['stack']} bytes stack, "
                f"spills {k['spill_stores']} / {k['spill_loads']} bytes"
                if k else "")
        t = s["ms_per_rep"]
        print(f"  prefix {p} {what:36s}: {t:8.4f} ms (delta "
              f"{t - prev:8.4f} ms; reps {s['r1']} / {s['r2']}; one launch "
              f"{one:.4f} ms; bound {slope_bound(p, B, solver):.6f} ms)"
              f"{regs}")
        times.append(t)
        ones.append(one)
        prev = t
    return times, ones


def check_slopes(times, B, solver, route):
    """No slope below its bound: a phase the compiler dropped would read
    as free."""
    for p, t in enumerate(times):
        b = slope_bound(p, B, solver)
        check(t >= b, f"T3 {route} prefix {p} {dtype_name(solver.dtype)} "
              f"aug_dim {solver.aug_dim} B={B}: {t:.6f} ms a repetition, "
              f"below its bound {b:.6f}: work was dropped")


def phase_split(times):
    """The phases' costs from the prefixes' slopes: assemble, factor,
    directions, metrics (differences of consecutive prefixes)."""
    names = ("assemble", "factor", "directions", "metrics x3")
    return dict(zip(names, (b - a for a, b in zip(times, times[1:]))))


def time_k1(dev, B, dtype, point, route):
    """K1's ``solve_fused(max_iter=1)`` on ``route`` at ``B`` instances of
    ``point`` (the block route at K1_BLOCK_RULE's W): ms by CUDA events
    behind a leading launch."""
    from ipmzoo_tpu_torch.ops import cuda_fused
    from ipmzoo_tpu_torch.utils.timer import cuda_time
    solver, _, soa = point_inputs(point, B, dev, dtype)
    warps = (cuda_fused.block_warps(solver.k1_sizes(), dtype,
                                    solver.k1_slots())
             if route == "block" else None)
    src = solver.kernel_source(route)
    ms = cuda_time(lambda: cuda_fused.fused_soa(
        src, soa, None, solver.n, sum(solver.var_sizes), 1, 0,
        solver.kernel_params(), route, warps), runs=5, calls=10,
        lead=1).ms
    w = f" W={warps}" if warps else ""
    print(f"  K1 solve_fused(max_iter=1) ({point}, aug_dim {solver.aug_dim})"
          f" B={B} {dtype_name(dtype)}, {route} route{w}: {ms:.4f} ms (one "
          f"iteration with its ratio tests, sigma and the two metrics "
          f"around it)")
    return ms


def time_reference_points(dev, B):
    """Beside the fused slice's prefixes, as the reference tool: one
    ``solve_fused(max_iter=1)`` (K1 on its thread route and on its team
    route) and one ``CompiledIPM.step`` on the same data, float32.
    Returns K1's ms by route and the step's ms."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    k1 = {route: time_k1(dev, B, torch.float32, "slice", route)
          for route in ROUTES}
    _, data, _ = point_inputs("slice", B, dev, torch.float32)
    step = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-5,
                       device=dev)
    checked = step._check_data(data)
    state = step.init_state(checked)
    ts = cuda_time(lambda: step.step(state, checked), runs=5)
    print(f"  CompiledIPM.step, same data (eager, K2 + 2 x K3): "
          f"{ts.ms:.4f} ms per step (spread {ts.spread:.4f})")
    return k1, ts.ms


def run_point(dev, point, ptxas):
    """Check, then time every route of ``point`` at each of its batches
    and types (prefix times non-decreasing within 10%; no slope below its
    bound at the largest batch), with K1's one-iteration launch on the
    same route beside them.  Returns {(B, dtype name, route): times}."""
    batches, dtypes, routes = POINTS[point]
    for route in routes:
        check_phases(dev, batches[0], route, point, dtypes)
    out = {}
    for B in batches:
        for name in dtypes:
            for route in routes:
                times, _ = time_phases(dev, B, _dtype(name),
                                       ptxas[(point, route)], route, point)
                check(all(b >= a * 0.9 for a, b in zip(times, times[1:])),
                      f"{route} prefix times decrease: {times}")
                if B == batches[0]:
                    check_slopes(times, B, point_solver(point, dev,
                                                        _dtype(name)), route)
                print(f"  {route} route phases ({point}, B={B}, {name}; ms "
                      f"a repetition): " + ", ".join(
                          f"{k} {v:.4f}"
                          for k, v in phase_split(times).items()))
                out[(B, name, route)] = times
                if point != "slice":
                    time_k1(dev, B, _dtype(name), point, route)
        if point == "slice":
            time_reference_points(dev, B)
    return out


def main():
    dev = banner("chip_phases", "the prefixes are timed")
    if dev is None:
        return 2
    rows = build()
    for point in POINTS:
        run_point(dev, point, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
