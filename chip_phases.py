#!/usr/bin/env python3
"""Phase breakdown of the fused whole-solve kernel K1 on one NVIDIA GPU
(the port's counterpart of tools/fused_phases.py).

    python3 chip_phases.py       # from the repository root; needs one
                                 # CUDA card and nvcc

Kernel T3 runs, at the cold start of the fused slice (Settings(), n=16,
m_ineq=8, augmented order 24, bench workload, numpy seed 0), successive
prefixes of one fused iteration through the functions K1 itself runs:

    start iterate | + assemble | + factor | + directions | + metrics x3

T3 has K1's two routes at this order: the thread route (one thread an
instance, csrc/fused_phases.cuh) and the team route (16 lanes an
instance, the instance's region in shared memory,
csrc/fused_phases_team.cuh), which is the route K1 takes on the fused
slice.  Each prefix of each route is generated and built as a
translation unit of its own (all ten nvcc processes, and K1's two, started
together), so ptxas reports its registers, stack frame and spills alone.
The script holds each prefix of each route to its plain version (float64
within 1e-10, float32 within 1e-4, both outputs, the metrics nudge off
and on), then prints for each route, at B=10240 and B=512, float32 and
float64: the time of each prefix per in-kernel repetition (a slope over
repetition counts, so without the launch), the difference to the prefix
before (the phase's cost; an estimate, since two prefixes are two
register allocations), one whole launch, the slope's bound, and ptxas'
figures; beside them one ``solve_fused(max_iter=1)`` (K1 on its thread
and its team route) and one ``CompiledIPM.step`` on the same data.  At
B=10240 no slope may lie below its bound.  The three metrics calls run
on iterates nudged by a run-time factor (see csrc/fused_phases.cuh), so
the compiler cannot merge them.  Exits 2 without a CUDA device.
"""

import re
import sys

from chip_roofline import (banner, build_all, check, dtype_name, fused_solver,
                           rel_diff)
from ipmzoo_tpu_torch.models.fused_phases import ROUTES
from ipmzoo_tpu_torch.ops.cuda_fused import PHASE_LIBS

B_SLICE, B_TILE = 10240, 512
#: operations of one set of the matrix-vector products Q x, A x, A^T y
#: per instance at n=16, m=8
MATVEC_FLOPS = 2 * 16 * 16 + 4 * 8 * 16


def phase_flops(phase):
    """Operations per instance of prefix ``phase``, cumulative, at order
    N = 24: the factor and each of the two solves as ``fused_flops``
    counts them for T2 (about N^3/3 and 2 N^2 operations), and one set of
    the matrix-vector products for the assembly, for each of the two
    right-hand sides and for each of the three metrics."""
    from ipmzoo_tpu_torch.ops.cuda_roofline import fused_flops
    fac, sol = fused_flops(24)
    per = [0, MATVEC_FLOPS, fac, 2 * sol + 2 * MATVEC_FLOPS,
           3 * MATVEC_FLOPS]
    return sum(per[:phase + 1])


def phase_sources(route="thread"):
    """The five prefixes' sources of ``route`` for the fused slice (the
    text does not depend on the dtype)."""
    import torch
    from ipmzoo_tpu_torch.models import fused_phases as fp
    solver = fused_solver("cpu", torch.float32)
    make = fp.phase_team_source if route == "team" else fp.phase_source
    return [make(solver, p) for p in range(len(fp.PHASES))]


def ptxas_rows(route="thread"):
    """ptxas' registers, stack frame and spills of each prefix of
    ``route``, per dtype: {(phase, 'float32'|'float64'): dict}."""
    from ipmzoo_tpu_torch.ops import _build
    out = {}
    for p, src in enumerate(phase_sources(route)):
        lib = _build.generated_library_path(PHASE_LIBS[route], src)
        for k in _build.ptxas_report(lib):
            m = re.search(r"FormE([fd])Li", k["name"])
            if m:
                out[(p, "float32" if m.group(1) == "f" else "float64")] = k
    return out


def build():
    """Build the prefixes of both routes and K1's thread and team routes
    at once; print each build's time and ptxas' report."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused

    jobs = {f"T3 {route} prefix {p}":
            lambda s=src, r=route: cuda_fused.library(s, PHASE_LIBS[r])
            for route in ROUTES for p, src in enumerate(phase_sources(route))}
    solver = fused_solver("cpu", torch.float32)
    k1, team = solver.kernel_source(), solver.kernel_source("team")
    jobs["K1 (generated fused_ipm)"] = lambda: cuda_fused.library(k1)
    jobs["K1 team route (generated fused_team)"] = \
        lambda: cuda_fused.library(team, "fused_team")
    for name, t in build_all(jobs).items():
        print(f"build: {name} ready in {t:.2f} s")
    return report_ptxas()


def report_ptxas():
    """Print and return ptxas' figures of every prefix: {route: rows}."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused
    out = {}
    for route in ROUTES:
        rows = out[route] = ptxas_rows(route)
        for (p, name), k in sorted(rows.items()):
            print(f"build: T3 {route} prefix {p} {name}: {k['registers']} "
                  f"registers, {k['stack']} bytes stack frame, spill stores "
                  f"{k['spill_stores']} / loads {k['spill_loads']} bytes")
    # the prefixes launch as K1's team route, on its layout and launch
    # bounds: K1's shape query holds for each of them
    team = fused_solver("cpu", torch.float32).kernel_source("team")
    lib = cuda_fused.library(team, "fused_team")
    for dtype in (torch.float32, torch.float64):
        sh = cuda_fused.team_shape(lib, dtype)
        print(f"build: T3 team route (K1's team layout) {dtype_name(dtype)}: "
              f"{sh['lanes']} lanes, {sh['threads']} threads a block, "
              f"{sh['team_bytes']} bytes of shared memory a team, "
              f"{sh['teams_per_sm']} teams resident per SM")
    return out


def slice_inputs(solver, B, dev):
    from ipmzoo_tpu_torch.models.convert import make_batch
    data = make_batch(B, 16, 8, solver.dtype, device=dev)
    return data, solver.soa_inputs(data)[0]


def check_phases(dev, B=B_SLICE, route="thread"):
    """Each prefix of ``route`` against its plain version on the card at
    ``B`` instances: float64 within 1e-10 relative, float32 within 1e-4,
    both outputs, with the metrics nudge off (the reference kernel's value)
    and on.  Returns the largest absolute difference of the float32
    outputs of the last prefix."""
    import torch
    from ipmzoo_tpu_torch.models import fused_phases as fp

    err = None
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        name = dtype_name(dtype)
        solver = fused_solver(dev, dtype)
        _, soa = slice_inputs(solver, B, dev)
        for p in range(len(fp.PHASES)):
            for reps, perturb in ((1, 0), (2, 1)):
                acc, sink = fp.phase(solver, soa, p, reps, perturb, route)
                acc0, sink0 = fp.phase_plain(solver, soa, p, reps, perturb)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(acc).all()) and
                      bool(torch.isfinite(sink).all()),
                      f"T3 {route} prefix {p}: non-finite output")
                ra = rel_diff(acc, acc0) if p else \
                    (acc - acc0).abs().max().item()
                rs = rel_diff(sink, sink0)
                print(f"T3 {route} prefix {p} vs plain {name} B={B} "
                      f"reps={reps} perturb={perturb}: rel diff acc "
                      f"{ra:.3e} sink {rs:.3e} (limit {tol:g})")
                check(max(ra, rs) <= tol, f"T3 {route} prefix {p} "
                      f"disagrees with its plain version in {name}: "
                      f"{max(ra, rs):.3e} > {tol:g}")
                if dtype == torch.float32 and p == len(fp.PHASES) - 1 \
                        and reps == 1:
                    err = max((acc - acc0).abs().max().item(),
                              (sink - sink0).abs().max().item())
    return err


def slope_bound(phase, B, dtype):
    """The least ms of one repetition of prefix ``phase`` on B instances:
    its operations (phase_flops) over the card's peak for the type (the
    data is read once a launch, outside the repetitions)."""
    import torch
    peak = 67e12 if dtype == torch.float32 else 33.5e12
    return phase_flops(phase) * B / peak * 1e3


def time_phases(dev, B, dtype, ptxas=None, route="thread"):
    """Milliseconds of each prefix of ``route`` at ``B`` instances: per
    in-kernel repetition (the slope between two repetition counts, which
    leaves the launch and the first loads out) with the difference to the
    prefix before, one whole launch beside it, the slope's bound
    (slope_bound) and ptxas' figures.  Returns the list of per-repetition
    times and the list of one-launch times."""
    from ipmzoo_tpu_torch.models import fused_phases as fp
    from ipmzoo_tpu_torch.ops.cuda_roofline import reps_slope
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    name = dtype_name(dtype)
    solver = fused_solver(dev, dtype)
    _, soa = slice_inputs(solver, B, dev)
    times, ones, prev = [], [], 0.0
    print(f"fused prefixes, {route} route (B={B}, n=16, m=8, aug_dim="
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
              f"{one:.4f} ms; bound {slope_bound(p, B, dtype):.6f} ms)"
              f"{regs}")
        times.append(t)
        ones.append(one)
        prev = t
    return times, ones


def check_slopes(times, B, dtype, route):
    """No slope below its bound: a phase the compiler dropped would read
    as free."""
    for p, t in enumerate(times):
        b = slope_bound(p, B, dtype)
        check(t >= b, f"T3 {route} prefix {p} {dtype_name(dtype)} B={B}: "
              f"{t:.6f} ms a repetition, below its bound {b:.6f}: work was "
              f"dropped")


def phase_split(times):
    """The phases' costs from the prefixes' slopes: assemble, factor,
    directions, metrics (differences of consecutive prefixes)."""
    names = ("assemble", "factor", "directions", "metrics x3")
    return dict(zip(names, (b - a for a, b in zip(times, times[1:]))))


def time_reference_points(dev, B):
    """Beside the prefixes, as the reference tool: one
    ``solve_fused(max_iter=1)`` (K1 on its thread route and on its team
    route) and one ``CompiledIPM.step`` on the same data, float32.
    Returns K1's ms by route and the step's ms."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.ops import cuda_fused
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    solver = fused_solver(dev, torch.float32)
    data, soa = slice_inputs(solver, B, dev)
    params = solver.kernel_params()
    total = sum(solver.var_sizes)
    k1 = {}
    for route in ROUTES:
        src = solver.kernel_source(route)
        k1[route] = cuda_time(lambda: cuda_fused.fused_soa(
            src, soa, None, 16, total, 1, 0, params, route), runs=5,
            calls=10, lead=1).ms
        print(f"  K1 solve_fused(max_iter=1) B={B} float32, {route} route: "
              f"{k1[route]:.4f} ms (one iteration with its ratio tests, "
              f"sigma and the two metrics around it)")
    step = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-5,
                       device=dev)
    checked = step._check_data(data)
    state = step.init_state(checked)
    ts = cuda_time(lambda: step.step(state, checked), runs=5)
    print(f"  CompiledIPM.step, same data (eager, K2 + 2 x K3): "
          f"{ts.ms:.4f} ms per step (spread {ts.spread:.4f})")
    return k1, ts.ms


def main():
    import torch
    dev = banner("chip_phases", "the prefixes are timed")
    if dev is None:
        return 2
    rows = build()
    for route in ROUTES:
        check_phases(dev, route=route)
    for B in (B_SLICE, B_TILE):
        for dtype in (torch.float32, torch.float64):
            for route in ROUTES:
                times, _ = time_phases(dev, B, dtype, rows[route], route)
                check(all(b >= a * 0.9 for a, b in zip(times, times[1:])),
                      f"{route} prefix times decrease: {times}")
                if B == B_SLICE:
                    check_slopes(times, B, dtype, route)
                print(f"  {route} route phases (ms a repetition): " +
                      ", ".join(f"{k} {v:.4f}"
                                for k, v in phase_split(times).items()))
        time_reference_points(dev, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
