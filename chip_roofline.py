#!/usr/bin/env python3
"""Roofline of the fused engine on one NVIDIA GPU (the port's counterpart
of tools/roofline.py).

    python3 chip_roofline.py     # from the repository root; needs one
                                 # CUDA card and nvcc

It measures, on the card it runs on, and prints:

1. the multiply-add ceiling outside the tensor cores, float32 and
   float64: kernel T1 (chains of dependent FMAs in registers, no loads
   in the loop) swept over threads per block, blocks per SM and chains;
   the best rate, its share of the data sheet's 67 / 33.5 TFLOP/s, and
   the SM clock and power draw read beside it;
2. the matrix-product rates of the library (chained ``torch.matmul``,
   1024^2 float32 with TF32 off, 2048^2 bfloat16);
3. kernel T2 at the fused engine's shape (augmented order 24): the time
   of one LDL^T factorisation and of one solve inside K1's own per-thread
   storage, as the slope between two in-kernel repetition counts, at
   B=10240 (the fused slice) and B=512, float32 and float64; the rates by
   ``fused_flops`` against the ceiling of 1; and the share of one fused
   iteration that is linear algebra (one factor and two solves against
   K1's measured time per iteration).  Beside the thread route's, T2a's
   and T2b's team routes (K1's team route's factor and solve: team_ldlt
   and team_ldlt_solve on 16 lanes, K and D in shared memory) at the same
   shapes, each with its bound and the thread/team ratio; no slope of
   them may lie below its bound at B=10240.  Their teams resident per SM
   beside K1 team's, the SASS of T2b team's repetition loop (it must load
   the factor from shared memory: K1 reloads it every solve), and the
   linear-algebra share of both routes, each against K1's iteration on
   that route (the team route's is the fused slice's).

T1 and T2 are first held to their plain versions, and T1 again at what
the sweep launched: every block size at 1024 rounds, and the winning
configurations at their own sizes and round counts.  The kernels are built
at first use (``csrc/roofline.cu`` in a few seconds; K1's thread and
team routes, which step 3 needs for the time of an iteration, in about a
minute, all at once).
Exits 2 without a CUDA device.
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_AUG, B_SLICE, B_TILE = 24, 10240, 512
#: the fused slice's iteration budget of its first stage
K1_ITERS = 14
ROOFLINE_SOURCE = "ipmzoo_tpu_torch/csrc/roofline.cu"


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_diff(a, b):
    """Largest absolute difference over the largest magnitude of b."""
    return ((a - b).abs().max() / b.abs().max()).item()


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def banner(script, what):
    """Print the card's name and power limit (nvidia-smi) and torch's
    versions, and return the first CUDA device as the current one; without
    a CUDA device, say on the standard error that ``what`` needs one and
    return None."""
    import torch
    from ipmzoo_tpu_torch.utils.device import nvidia_smi
    if not torch.cuda.is_available():
        print(f"{script}: no CUDA device is available; {what} only on a GPU",
              file=sys.stderr)
        return None
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(nvidia_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)}")
    return dev


def build_all(jobs):
    """Run every build of ``jobs`` (name -> callable) at once, one thread
    and so one nvcc process each; print and return the seconds each took,
    by name."""
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = {k: pool.submit(timed, fn) for k, fn in jobs.items()}
        seconds = {k: j.result() for k, j in done.items()}
    print(f"build: {len(jobs)} libraries ready in "
          f"{time.perf_counter() - t0:.2f} s, all nvcc processes started "
          f"together")
    return seconds


def card_state():
    """The SM clock, power draw and power limit nvidia-smi reads now."""
    from ipmzoo_tpu_torch.utils.device import nvidia_smi
    return nvidia_smi("clocks.sm,power.draw,power.limit")


def hold_fma(x, chains, reps, threads, tol):
    """One T1 launch against the plain version on the same ``x``: checks
    that the output is finite and within the relative difference ``tol``,
    prints the reading and returns the largest absolute difference."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr
    out = cr.fma_chains(x, chains, reps, threads)
    plain = cr.fma_chains_plain(x, chains, reps)
    torch.cuda.synchronize()
    name, rd = dtype_name(x.dtype), rel_diff(out, plain)
    print(f"T1 vs plain {name} {tuple(x.shape)} chains={chains} "
          f"reps={reps} threads={threads}: rel diff {rd:.3e} (limit "
          f"{tol:g})")
    check(bool(torch.isfinite(out).all()), "T1: non-finite output")
    check(rd <= tol, f"T1 disagrees with its plain version in {name} at "
          f"{tuple(x.shape)}, chains={chains}, reps={reps}, "
          f"threads={threads}: {rd:.3e} > {tol:g}")
    return (out - plain).abs().max().item()


def check_fma(dev, shape=(64, 512)):
    """T1 against its plain version on the card at the reference tool's
    round count, reps 64, chains 4 / 8 / 16, on a buffer of ``shape`` (one
    of the tool's): float32 within a relative difference of 1e-5 (nvcc
    contracts acc * a + x to one FMA, torch rounds twice), float64 within
    1e-12.  Returns the largest absolute difference in float32 by chain
    count."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr

    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        x = torch.linspace(0.0, 1.0, shape[0] * shape[1], dtype=dtype,
                           device=dev).reshape(shape)
        for chains in cr.CHAINS:
            err = hold_fma(x, chains, 64, 256, tol)
            if dtype == torch.float32:
                errs[chains] = err
    return errs


def check_fma_sweep(dev, ceilings):
    """T1 against its plain version at what the sweep launches: the
    run-time round loop at 1024 rounds with every block size of the sweep
    (one block per SM, the chain counts in turn), then each dtype's
    winning configuration at its own size, block size, chain count and
    round count (at most 8192 rounds: a small winner runs a million, which
    the plain version cannot follow).  Over thousands of rounds the one rounding of an FMA
    against torch's two drifts by about rounds x epsilon, while a wrong
    chain, round or element count is off by whole factors: float32 within
    a relative difference of 1e-2, float64 within 1e-10."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype, tol in ((torch.float32, 1e-2), (torch.float64, 1e-10)):
        def buffer(n):
            return torch.linspace(0.0, 1.0, n, dtype=dtype, device=dev)

        for i, threads in enumerate((128, 256, 512, 1024)):
            hold_fma(buffer(sms * threads), cr.CHAINS[i % len(cr.CHAINS)],
                     1024, threads, tol)
        b = ceilings[dtype_name(dtype)]
        hold_fma(buffer(sms * b["blocks_per_sm"] * b["threads"]),
                 b["chains"], min(b["reps"], 8192), b["threads"], tol)


def fma_ceilings(dev):
    """T1's sweep in float32 and float64; prints and returns the best
    configuration of each."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr

    best = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        b = cr.fma_peak(dtype, dev)
        name = dtype_name(dtype)
        peak = cr.DATA_SHEET_FLOPS[dtype]
        print(f"FMA ceiling {name}: {b['flops'] / 1e12:.3f} TFLOP/s = "
              f"{100 * b['share']:.1f}% of the data sheet's "
              f"{peak / 1e12:g} (best of {len(b['rows'])} configurations: "
              f"{b['threads']} threads x {b['blocks_per_sm']} blocks per SM, "
              f"{b['chains']} chains, reps {b['reps']} / {2 * b['reps']}, "
              f"{b['ms']:.3f} ms at the smaller); card now: {card_state()}; "
              f"sweep took {time.perf_counter() - t0:.1f} s")
        low = min(b["rows"], key=lambda r: r["flops"])
        print(f"FMA ceiling {name}: slowest configuration "
              f"{low['flops'] / 1e12:.3f} TFLOP/s ({low['threads']} threads "
              f"x {low['blocks_per_sm']} blocks per SM, {low['chains']} "
              f"chains)")
        check(b["share"] <= 1.0, f"T1 counts {100 * b['share']:.1f}% of "
              f"the data-sheet rate in {name}: a counting fault")
        best[name] = b
    return best


def matmul_peak(dtype, n, dev, chain=20):
    """FLOP/s of the library's matrix product (the reference tool's
    ``mxu_peak``): a chain of ``y = y @ a`` on n x n operands."""
    import torch
    from ipmzoo_tpu_torch.utils.timer import cuda_time
    import numpy as np
    a = torch.tensor(np.random.default_rng(0).standard_normal((n, n)) / n
                     ).to(dtype).to(dev)
    y0 = torch.ones((n, n), dtype=dtype, device=dev)

    def run():
        y = y0
        for _ in range(chain):
            y = torch.matmul(y, a)
        return y

    t = cuda_time(run, runs=5, warmup=2)
    per = t.ms / chain
    return 2.0 * n ** 3 / (per * 1e-3), per


def matmul_peaks(dev):
    """Step 2: the library's matrix-product rates."""
    import torch
    out = {}
    for dtype, n in ((torch.float32, 1024), (torch.bfloat16, 2048)):
        flops, ms = matmul_peak(dtype, n, dev)
        name = dtype_name(dtype)
        out[name] = (flops, ms)
        print(f"library matmul {name} {n}^3 (torch.matmul, TF32 "
              f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}"
              f"): {flops / 1e12:.3f} TFLOP/s ({ms * 1e3:.1f} us per "
              f"product)")
    return out


def reps_inputs(B, dtype, dev):
    """T2's inputs: the tool's quasi-definite tile (numpy seed 0) and
    right-hand sides (numpy seed 1), float32 values cast to ``dtype``."""
    import numpy as np
    import torch
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr
    K0 = torch.tensor(cr.quasidef_tile(N_AUG, B)).to(dtype).to(dev)
    b0 = torch.tensor(np.random.default_rng(1).standard_normal(
        (N_AUG, B)).astype(np.float32)).to(dtype).to(dev)
    return K0, b0


def check_reps(dev, B=B_SLICE):
    """T2a / T2b (both routes each) against their plain versions on the
    card at order 24, ``B`` instances, 3 repetitions, float32 within 1e-5
    and float64 within 1e-12 on both outputs.  Returns the largest
    absolute differences of the float32 sinks, by kernel ("factor_reps
    team", "solve_reps team" the team routes')."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr

    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        name = dtype_name(dtype)
        K0, b0 = reps_inputs(B, dtype, dev)
        factor = cr.factor_reps_plain(K0, 3)
        solve = cr.solve_reps_plain(K0, b0, 3)
        runs = {"factor_reps": (cr.factor_reps(K0, 3), factor),
                "factor_reps team": (cr.factor_reps(K0, 3, route="team"),
                                     factor),
                "solve_reps": (cr.solve_reps(K0, b0, 3), solve),
                "solve_reps team": (cr.solve_reps(K0, b0, 3, route="team"),
                                    solve)}
        torch.cuda.synchronize()
        for what, ((acc, sink), (acc0, sink0)) in runs.items():
            ra, rs = rel_diff(acc, acc0), rel_diff(sink, sink0)
            print(f"T2 {what} vs plain {name} n={N_AUG} B={B} reps=3: rel "
                  f"diff acc {ra:.3e} sink {rs:.3e} (limit {tol:g})")
            check(bool(torch.isfinite(sink).all()), f"{what}: non-finite")
            check(max(ra, rs) <= tol, f"{what} disagrees with its plain "
                  f"version in {name}: {max(ra, rs):.3e} > {tol:g}")
            if dtype == torch.float32:
                errs[what] = (sink - sink0).abs().max().item()
    return errs


def factor_bound(B, dtype):
    """The least ms of one in-kernel factorisation of B instances at
    order 24: ``fused_flops``' operations over the card's peak for the
    type (each repetition reads no new bytes from device memory)."""
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr
    return cr.fused_flops(N_AUG)[0] * B / cr.DATA_SHEET_FLOPS[dtype] * 1e3


def solve_bound(B, dtype):
    """The least ms of one in-kernel solve of B instances at order 24:
    ``fused_flops``' operations over the card's peak for the type."""
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr
    return cr.fused_flops(N_AUG)[1] * B / cr.DATA_SHEET_FLOPS[dtype] * 1e3


def time_reps(dev, ceilings, batches=(B_SLICE, B_TILE)):
    """Step 3: T2's slopes, T2a and T2b on both routes.  Returns {(B,
    dtype name): {factor_ms, factor_team_ms, solve_ms, solve_team_ms,
    factor_flops, solve_flops}} (ms per repetition, FLOP/s)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr

    fac, sol = cr.fused_flops(N_AUG)
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        peak = ceilings[name]["flops"]
        for B in batches:
            K0, b0 = reps_inputs(B, dtype, dev)
            f = cr.reps_slope(lambda r: cr.factor_reps(K0, r))
            ft = cr.reps_slope(lambda r: cr.factor_reps(K0, r,
                                                         route="team"))
            s = cr.reps_slope(lambda r: cr.solve_reps(K0, b0, r))
            st = cr.reps_slope(lambda r: cr.solve_reps(K0, b0, r,
                                                        route="team"))
            row = {"factor_ms": f["ms_per_rep"],
                   "factor_team_ms": ft["ms_per_rep"],
                   "solve_ms": s["ms_per_rep"],
                   "solve_team_ms": st["ms_per_rep"],
                   "factor_flops": fac * B / (f["ms_per_rep"] * 1e-3),
                   "solve_flops": sol * B / (s["ms_per_rep"] * 1e-3)}
            out[(B, name)] = row
            print(f"T2 {name} n={N_AUG} B={B}: factor "
                  f"{row['factor_ms']:.4f} ms per repetition (slope of reps "
                  f"{f['r1']} / {f['r2']}: {f['ms_r1']:.4f} / "
                  f"{f['ms_r2']:.4f} ms), {row['factor_flops'] / 1e12:.3f} "
                  f"TFLOP/s = {100 * row['factor_flops'] / peak:.1f}% of the "
                  f"measured FMA ceiling [{fac} flops per instance]; solve "
                  f"{row['solve_ms']:.4f} ms per repetition (reps {s['r1']} "
                  f"/ {s['r2']}: {s['ms_r1']:.4f} / {s['ms_r2']:.4f} ms), "
                  f"{row['solve_flops'] / 1e12:.3f} TFLOP/s = "
                  f"{100 * row['solve_flops'] / peak:.1f}% [{sol} flops per "
                  f"instance]")
            team_flops = fac * B / (ft["ms_per_rep"] * 1e-3)
            bnd = factor_bound(B, dtype)
            print(f"T2a team route {name} n={N_AUG} B={B}: factor "
                  f"{ft['ms_per_rep']:.4f} ms per repetition (slope of reps "
                  f"{ft['r1']} / {ft['r2']}: {ft['ms_r1']:.4f} / "
                  f"{ft['ms_r2']:.4f} ms), {team_flops / 1e12:.3f} TFLOP/s "
                  f"= {100 * team_flops / peak:.1f}% of the measured FMA "
                  f"ceiling; bound {bnd:.6f} ms; thread route "
                  f"{row['factor_ms']:.4f} ms "
                  f"({row['factor_ms'] / ft['ms_per_rep']:.2f}x the team "
                  f"route's)")
            solve_flops = sol * B / (st["ms_per_rep"] * 1e-3)
            sbnd = solve_bound(B, dtype)
            print(f"T2b team route {name} n={N_AUG} B={B}: solve "
                  f"{st['ms_per_rep']:.6f} ms per repetition (slope of reps "
                  f"{st['r1']} / {st['r2']}: {st['ms_r1']:.4f} / "
                  f"{st['ms_r2']:.4f} ms), {solve_flops / 1e12:.3f} TFLOP/s "
                  f"= {100 * solve_flops / peak:.1f}% of the measured FMA "
                  f"ceiling; bound {sbnd:.6f} ms "
                  f"({st['ms_per_rep'] / sbnd:.1f}x it); thread route "
                  f"{row['solve_ms']:.6f} ms "
                  f"({row['solve_ms'] / st['ms_per_rep']:.2f}x the team "
                  f"route's)")
            if B == B_SLICE:
                check(ft["ms_per_rep"] >= bnd, f"T2a's team route reads "
                      f"{ft['ms_per_rep']:.6f} ms a factorisation at "
                      f"B={B} {name}, below its bound {bnd:.6f}: work was "
                      f"dropped")
                check(st["ms_per_rep"] >= sbnd, f"T2b's team route reads "
                      f"{st['ms_per_rep']:.6f} ms a solve at B={B} {name}, "
                      f"below its bound {sbnd:.6f}: work was dropped")
    return out


def team_shapes(k1_team_lib):
    """T2a's and T2b's team routes at order 24 beside K1's team route
    (``k1_team_lib``, its build for the fused slice): bytes of shared
    memory a team and teams resident per SM, float32 and float64.  A
    standalone kernel's region is smaller than K1's, so more of its teams
    fit an SM and a batch runs in fewer waves than inside K1.  Returns
    {(kernel, dtype name): shape}."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr

    out = {}
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        out[("K1", name)] = cuda_fused.team_shape(k1_team_lib, dtype)
        for kernel in ("T2a", "T2b"):
            out[(kernel, name)] = cr.reps_team_shape(dtype, kernel, N_AUG)
        print(f"team routes {name} n={N_AUG}: " + "; ".join(
            f"{k} {out[(k, name)]['team_bytes']} B a team, "
            f"{out[(k, name)]['teams_per_sm']} teams per SM"
            for k in ("T2a", "T2b", "K1")))
    return out


def sass_functions(text):
    """{mangled name: [(address, instruction)]} of a ``cuobjdump -sass``
    listing; a branch to a label (`` `(.L_x_3) ``) names the address of
    the instruction after the label instead (``0x...``)."""
    import re
    funcs, labels, name = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[name][m.group(1)] = len(funcs[name])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    for name, ins in funcs.items():     # labels may follow their branches
        def to_address(m, ins=ins, labels=labels[name]):
            i = labels.get(m.group(1))
            return m.group(0) if i is None or i >= len(ins) else \
                hex(ins[i][0])
        funcs[name] = [(a, re.sub(r"`\((\.L_x_\d+)\)", to_address, t))
                       for a, t in ins]
    return funcs


def solve_loops(text):
    """The repetition loop of each T2b team instantiation in a SASS
    listing: the backward branch, innermost of those whose body holds the
    solve's shuffles (SHFL.IDX; the factor in front of the loop holds
    none).  Returns {name: (LDS, SHFL.IDX, instructions)} of the loop's
    body, None for a function with no such loop."""
    import re
    out = {}
    for name, ins in sass_functions(text).items():
        if "solve_reps_team_kernel" not in name:
            continue
        addr = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (_, t) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
            j = addr.get(int(m.group(1), 16)) if m else None
            if j is not None and j <= i:
                body = [b for _, b in ins[j:i + 1]]
                if any("SHFL.IDX" in b for b in body):
                    loops.append(body)
        if not loops:
            out[name] = None
            continue
        body = min(loops, key=len)
        lds = sum(bool(re.match(r"(@!?U?P\d\s+)?LDS\b", b)) for b in body)
        out[name] = (lds, sum("SHFL.IDX" in b for b in body), len(body))
    return out


def check_solve_loop_sass(lib_path=None):
    """T2b team's repetition loops (:func:`solve_loops`) in the SASS of
    the roofline build (``cuobjdump -sass``): prints each loop's
    shared-memory loads (LDS), shuffles and instructions, and fails where
    a loop loads fewer values than the order: then the factor would stay
    in registers across repetitions, and the slope would time a cheaper
    solve than K1's, which reloads it every solve."""
    import re
    import shutil
    import subprocess
    from pathlib import Path
    from ipmzoo_tpu_torch.ops import _build
    lib_path = lib_path or _build.library_path("roofline")
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).with_name("cuobjdump"))
    loops = solve_loops(subprocess.run(
        [tool, "-sass", str(lib_path)], check=True, capture_output=True,
        text=True).stdout)
    check(loops, "no solve_reps_team_kernel in the roofline build's SASS")
    for name, loop in loops.items():
        check(loop is not None, f"{name}: no loop around the solve's "
              f"shuffles in the SASS")
        lds, shfl, n = loop
        order = int(re.search(r"Li(\d+)E", name).group(1))
        print(f"SASS {name}: repetition loop of {n} instructions, {lds} "
              f"LDS, {shfl} SHFL.IDX")
        check(lds >= order, f"{name}: the repetition loop loads {lds} "
              f"values from shared memory, fewer than the order {order}: "
              f"the factor is held in registers across repetitions")
    return loops


def fused_solver(dev, dtype):
    """The fused slice's solver: bench_torch.py's fused configuration at
    its defaults (Settings(), n=16, m_ineq=8, tol 1e-6, max_iter=30)."""
    import bench_torch
    return bench_torch.fused_solver(dev, dtype)


def k1_iteration_ms(dev, B=B_SLICE, route="thread"):
    """K1's measured time per iteration on ``route``, float32: one cold
    ``solve_fused(max_iter=14)`` at ``B`` over the largest iteration
    count an instance took."""
    import torch
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.ops import cuda_fused
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    solver = fused_solver(dev, torch.float32)
    src, params = solver.kernel_source(route), solver.kernel_params()
    total = sum(solver.var_sizes)
    soa, _ = solver.soa_inputs(make_batch(B, 16, 8, torch.float32,
                                          device=dev))

    def run():
        return cuda_fused.fused_soa(src, soa, None, 16, total, K1_ITERS, 0,
                                    params, route)

    its = int(run()[2].max())
    t = cuda_time(run, runs=5)
    print(f"K1 {route} route cold solve_fused(max_iter={K1_ITERS}) B={B} "
          f"float32: "
          f"{t.ms:.4f} ms (spread {t.spread:.4f}), {its} iterations at "
          f"most: {t.ms / its:.4f} ms per iteration")
    return t.ms / its


def linear_algebra_share(reps_times, iter_ms, route="thread", B=B_SLICE):
    """One factor and two solves of ``route`` (T2a and T2b on it)
    against ``iter_ms``, K1's time per iteration on the same route."""
    row = reps_times[(B, "float32")]
    key = "_team" if route == "team" else ""
    fac, sol = row[f"factor{key}_ms"], row[f"solve{key}_ms"]
    lin = fac + 2 * sol
    print(f"linear algebra per fused iteration, {route} route (B={B}, "
          f"float32): factor {fac:.4f} + 2 x solve {sol:.6f} = {lin:.4f} ms "
          f"of {iter_ms:.4f} ms measured per iteration "
          f"({100 * lin / iter_ms:.1f}%); the rest is the evaluation of the "
          f"derived expressions (assembly, right-hand sides and "
          f"back-substitution, residuals, corrector, metrics, ratio tests)")
    return lin / iter_ms


def build():
    """Build roofline.cu and (for the time of an iteration) K1's thread
    and team routes, the nvcc processes started together; returns K1 team
    route's library."""
    import torch
    from ipmzoo_tpu_torch.ops import _build, cuda_fused, cuda_roofline

    solver = fused_solver("cpu", torch.float32)
    src, team = solver.kernel_source(), solver.kernel_source("team")
    seconds = build_all({
        ROOFLINE_SOURCE: cuda_roofline._lib,
        "K1 (generated fused_ipm)": lambda: cuda_fused.library(src),
        "K1 team route (generated fused_team)":
            lambda: cuda_fused.library(team, "fused_team")})
    for k, t in seconds.items():
        print(f"build: {k} ready in {t:.2f} s")
    for k in _build.ptxas_report(_build.library_path("roofline")):
        print(f"build: {k['name'][:60]}: {k['registers']} registers, "
              f"{k['stack']} bytes stack, spills {k['spill_stores']} / "
              f"{k['spill_loads']} bytes")
    return cuda_fused.library(team, "fused_team")


def main():
    dev = banner("chip_roofline", "the roofline is measured")
    if dev is None:
        return 2
    k1_team = build()
    check_solve_loop_sass()
    team_shapes(k1_team)
    check_fma(dev)
    ceilings = fma_ceilings(dev)
    check_fma_sweep(dev, ceilings)
    matmul_peaks(dev)
    check_reps(dev)
    reps_times = time_reps(dev, ceilings)
    for route in ("thread", "team"):
        linear_algebra_share(reps_times, k1_iteration_ms(dev, route=route),
                             route)
    return 0


if __name__ == "__main__":
    sys.exit(main())
