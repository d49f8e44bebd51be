#!/usr/bin/env python3
"""Phase breakdown of the fused whole-solve kernel K1 on one NVIDIA GPU
(the port's counterpart of tools/fused_phases.py).

    python3 chip_phases.py       # from the repository root; needs one
                                 # CUDA card and nvcc

Kernel T3 runs, at the cold start of the fused slice (Settings(), n=16,
m_ineq=8, augmented order 24, bench workload, numpy seed 0), successive
prefixes of one fused iteration through the functions K1 itself runs:

    start iterate | + assemble | + factor | + directions | + metrics x3

Each prefix is generated and built as a translation unit of its own (all
five nvcc processes, and K1's, started together), so ptxas reports its
registers, stack frame and spills alone.  The script holds each prefix
to its plain version (float64 within 1e-10, float32 within 1e-4, both
outputs), then prints, at B=10240 and B=512, float32 and float64: the
time of each prefix per in-kernel repetition (a slope over repetition
counts, so without the launch), the difference to the prefix before (the
phase's cost; an estimate, since two prefixes are two register
allocations), one whole launch, and ptxas' figures; beside them one ``solve_fused(max_iter=1)`` (K1) and one
``CompiledIPM.step`` on the same data.  The three metrics calls run on
iterates nudged by a run-time factor (see csrc/fused_phases.cuh), so the
compiler cannot merge them; the checks run with the factor off.
Exits 2 without a CUDA device.
"""

import re
import sys

from chip_roofline import (banner, build_all, check, dtype_name, fused_solver,
                           rel_diff)

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


def phase_sources():
    """The five prefixes' sources for the fused slice (the text does not
    depend on the dtype)."""
    import torch
    from ipmzoo_tpu_torch.models.fused_phases import PHASES, phase_source
    solver = fused_solver("cpu", torch.float32)
    return [phase_source(solver, p) for p in range(len(PHASES))]


def ptxas_rows():
    """ptxas' registers, stack frame and spills of each prefix, per
    dtype: {(phase, 'float32'|'float64'): dict}."""
    from ipmzoo_tpu_torch.ops import _build
    out = {}
    for p, src in enumerate(phase_sources()):
        lib = _build.generated_library_path("fused_phase", src)
        for k in _build.ptxas_report(lib):
            m = re.search(r"FormE([fd])Li", k["name"])
            if m:
                out[(p, "float32" if m.group(1) == "f" else "float64")] = k
    return out


def build():
    """Build the five prefixes and K1 at once; print each build's time and
    ptxas' report."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused

    jobs = {f"T3 prefix {p}":
            lambda s=src: cuda_fused.library(s, "fused_phase")
            for p, src in enumerate(phase_sources())}
    k1 = fused_solver("cpu", torch.float32).kernel_source()
    jobs["K1 (generated fused_ipm)"] = lambda: cuda_fused.library(k1)
    for name, t in build_all(jobs).items():
        print(f"build: {name} ready in {t:.2f} s")
    return report_ptxas()


def report_ptxas():
    rows = ptxas_rows()
    for (p, name), k in sorted(rows.items()):
        print(f"build: T3 prefix {p} {name}: {k['registers']} registers, "
              f"{k['stack']} bytes stack frame, spill stores "
              f"{k['spill_stores']} / loads {k['spill_loads']} bytes")
    return rows


def slice_inputs(solver, B, dev):
    from ipmzoo_tpu_torch.models.convert import make_batch
    data = make_batch(B, 16, 8, solver.dtype, device=dev)
    return data, solver.soa_inputs(data)[0]


def check_phases(dev, B=B_SLICE):
    """Each prefix against its plain version on the card at ``B``
    instances: float64 within 1e-10 relative, float32 within 1e-4, both
    outputs, with the metrics nudge off (the reference kernel's value)
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
                acc, sink = fp.phase(solver, soa, p, reps, perturb)
                acc0, sink0 = fp.phase_plain(solver, soa, p, reps, perturb)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(acc).all()) and
                      bool(torch.isfinite(sink).all()),
                      f"T3 prefix {p}: non-finite output")
                ra = rel_diff(acc, acc0) if p else \
                    (acc - acc0).abs().max().item()
                rs = rel_diff(sink, sink0)
                print(f"T3 prefix {p} vs plain {name} B={B} reps={reps} "
                      f"perturb={perturb}: rel diff acc {ra:.3e} sink "
                      f"{rs:.3e} (limit {tol:g})")
                check(max(ra, rs) <= tol, f"T3 prefix {p} disagrees with "
                      f"its plain version in {name}: {max(ra, rs):.3e} > "
                      f"{tol:g}")
                if dtype == torch.float32 and p == len(fp.PHASES) - 1 \
                        and reps == 1:
                    err = max((acc - acc0).abs().max().item(),
                              (sink - sink0).abs().max().item())
    return err


def time_phases(dev, B, dtype, ptxas=None):
    """Milliseconds of each prefix at ``B`` instances: per in-kernel
    repetition (the slope between two repetition counts, which leaves
    the launch and the first loads out) with the difference to the
    prefix before, one whole launch beside it, and ptxas' figures.
    Returns the list of per-repetition times."""
    from ipmzoo_tpu_torch.models import fused_phases as fp
    from ipmzoo_tpu_torch.ops.cuda_roofline import reps_slope
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    name = dtype_name(dtype)
    solver = fused_solver(dev, dtype)
    _, soa = slice_inputs(solver, B, dev)
    times, prev = [], 0.0
    print(f"fused prefixes (B={B}, n=16, m=8, aug_dim={solver.aug_dim}, "
          f"{name}; metrics nudged; ms per in-kernel repetition):")
    for p, what in enumerate(fp.PHASES):
        s = reps_slope(lambda r: fp.phase(solver, soa, p, r, 1),
                       min_diff_ms=0.1)
        one = cuda_time(lambda: fp.phase(solver, soa, p, 1, 1), runs=3,
                        calls=10, lead=1).ms
        k = (ptxas or {}).get((p, name))
        regs = (f"; {k['registers']} registers, {k['stack']} bytes stack, "
                f"spills {k['spill_stores']} / {k['spill_loads']} bytes"
                if k else "")
        t = s["ms_per_rep"]
        print(f"  prefix {p} {what:36s}: {t:8.4f} ms (delta "
              f"{t - prev:8.4f} ms; reps {s['r1']} / {s['r2']}; one launch "
              f"{one:.4f} ms){regs}")
        times.append(t)
        prev = t
    return times


def time_reference_points(dev, B):
    """Beside the prefixes, as the reference tool: one
    ``solve_fused(max_iter=1)`` (K1) and one ``CompiledIPM.step`` on the
    same data, float32."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.ops import cuda_fused
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    solver = fused_solver(dev, torch.float32)
    data, soa = slice_inputs(solver, B, dev)
    src, params = solver.kernel_source(), solver.kernel_params()
    total = sum(solver.var_sizes)
    t = cuda_time(lambda: cuda_fused.fused_soa(src, soa, None, 16, total, 1,
                                               0, params), runs=5, calls=10,
                  lead=1)
    print(f"  K1 solve_fused(max_iter=1) B={B} float32: {t.ms:.4f} ms "
          f"(one iteration with its ratio tests, sigma and the two "
          f"metrics around it)")
    step = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-5,
                       device=dev)
    checked = step._check_data(data)
    state = step.init_state(checked)
    ts = cuda_time(lambda: step.step(state, checked), runs=5)
    print(f"  CompiledIPM.step, same data (eager, K2 + 2 x K3): "
          f"{ts.ms:.4f} ms per step (spread {ts.spread:.4f})")
    return t.ms, ts.ms


def main():
    import torch
    dev = banner("chip_phases", "the prefixes are timed")
    if dev is None:
        return 2
    rows = build()
    check_phases(dev)
    for B in (B_SLICE, B_TILE):
        for dtype in (torch.float32, torch.float64):
            times = time_phases(dev, B, dtype, rows)
            check(all(b >= a * 0.9 for a, b in zip(times, times[1:])),
                  f"prefix times decrease: {times}")
        time_reference_points(dev, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
