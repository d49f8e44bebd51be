#!/usr/bin/env python3
"""Where the time goes on the port's slices, on one NVIDIA GPU.

    python3 chip_profile.py      # from the repository root; needs one
                                 # CUDA card and nvcc
    python3 chip_profile.py arrow schur   # only the named sections
                                 # (arrow, schur, fused, compact, nd,
                                 # dense, mpc, tf, wide)

It builds the kernels as chip_smoke.py does, drives the same slices on
the same data, and prints, after the card's name and power limit:

1. the Schur slice (bench_schur's defaults; tol 1e-8, solved in float64,
   and plain float32 at tol 1e-5): the wall by CUDA events (median of 5
   runs after a warm-up); the kernel launches and device busy time of
   one solve under torch.profiler, as launches per iteration and busy
   share (busy time over the un-profiled median); the largest entries of
   device time; K2, K3 and K4 (by route) device time and share;
   K3's launches by (route, order, systems, type), each shape's device
   ms per launch timed alone and their product; and the host-clock time
   of three single iterations;
2. the fused slice with esc_cap=32 and with esc_cap=0, twice each: the
   wall and the host-clock time of every stage (K1's solve_fused calls,
   the escalation, the safety-net tail; each stage ends in a
   synchronize), beside each K1 launch's route, batch and device time
   (CUDA events around the launch alone) and K1's device time by route,
   converged instances and host syncs; then the profiled launches and
   busy time of one esc_cap=32 solve; then the share of a cold K1 launch
   on the team route (B=10240, max_iter=14, float32 and float64) spent in
   its factor, read inside the launch by clock64 (team_clocked_share),
   beside T3's team route's factor (prefix 2 less prefix 1);
3. the compact slice with esc_cap 'auto', 0, 0, 'auto' in turns: the
   wall by CUDA events (median of 2 runs after the first);
4. the banded+arrow slice (bench_arrow's defaults, float32, tol 1e-5),
   one instance and the batch of 32: the wall by CUDA events (median of
   5 runs after a warm-up); launches per iteration and busy share of one
   solve under torch.profiler; K6's and K7's (by route) share of device
   time; and the host-clock time of three single iterations;
5. the nested-dissection slice (bench_nd's defaults, float32, tol 1e-5),
   one instance and the batch of 8: the wall by CUDA events (median of 5
   runs after a warm-up); launches per iteration and busy share of one
   solve under torch.profiler; K5's and K3's (by route) share of device
   time, K3's launches and device ms by shape as for the Schur slice;
   the host-clock time of three single iterations, of the
   once-per-solve prework, and of one factorisation and one solve of the
   plan;
6. the dense modes (section ``dense``): bench_aug's QPs through 'auto'
   (the dense LDL^T, the blocked route at aug_dim 352) and 'blockg',
   bench_normal's through 'blockg', 'block' and 'normal': the wall by
   CUDA events (median of 3 runs after a warm-up), launches per
   iteration, busy share and K2's (block route: the blocked LDL^T's
   panels) share of one solve under torch.profiler; one dense
   CompiledIPM step ('blockg') on bench_arrow's and bench_nd's QPs; and
   one blockg factor with two solves at bench_kkt's large orders;
7. the MPC slice (section ``mpc``: bench_mpc's 256 instances, T=32,
   ns=8, nu=4, float32, tol 1e-5) through RiccatiIPM.solve_batch: the
   wall by CUDA events (median of 5 runs after a warm-up), launches per
   iteration and busy share of one solve under torch.profiler, the
   launches of one riccati_factor and of one riccati_solve; and the
   host-clock time of three single iterations as they run, then three
   split into the riccati_factor call, the riccati_solve calls (two,
   more with gondzio) and the rest (a synchronize around each call),
   both before the first torch.profiler session;
8. the tf slice (section ``tf``: bench_torch.py's tf mode, the first
   2048 QPs of the compact slice's data, float32, tol 1e-8,
   two_float=True) and the same QPs cast to float64 through a plain
   float64 solver at the same tolerance: the wall of each by CUDA events
   (median of 3 runs after a warm-up), the host-clock time of three
   single batched steps of each at B=2048, and of the two_float solve
   the launches per step, busy share and K2's / K3's share of one solve
   under torch.profiler.

9. the wide slice (section ``wide``: bench_torch.py's wide mode, 4096
   portfolios of 128 assets, aug_dim 129, float32, tol 1e-6) before and
   after the block route in one process: K1 held on the wide route, then
   on k1_route's pick; for each the stages and each K1 launch (as the
   fused slice), the wall by CUDA events (median of 5), launches by
   route, and under torch.profiler the busy time, launches and K1's
   device ms a launch with its share of busy and of the wall; then the
   LDL^T of the wide and block routes alone at chip_smoke's wide_rows()
   (factor_alone), beside the cold launch and the factor's share of it,
   and that share read inside the launch by clock64 (clocked_share).

torch.profiler inflates the wall; only its device times and launch
counts are read.  It checks nothing: chip_smoke.py holds the results.
"""

import functools
import sys
import time

import chip_smoke as cs
from chip_smoke import profiled


#: the device-time attribution of the LDL^T kernels: (label, a substring
#: of the kernel's name, a substring it must not have); each second route
#: is named after its kernel with a suffix
SCHUR_KERNELS = (("K2", "ldlt_factor_kernel", None),
                 ("K2 SoA route", "ldlt_factor_kernel", "_block"),
                 ("K2 block route", "ldlt_factor_kernel_block", None),
                 ("K3", "ldlt_solve_kernel", None),
                 ("K3 thread route", "ldlt_solve_kernel", "_warp"),
                 ("K3 warp route", "ldlt_solve_kernel_warp", None),
                 ("K4", "ldlt_solve_matrix_kernel", None),
                 ("K4 thread route", "ldlt_solve_matrix_kernel", "_warp"),
                 ("K4 warp route", "ldlt_solve_matrix_kernel_warp", None))
ND_KERNELS = (("K5", "ldlt_factor_solve_matrix_kernel", None),
              ("K5 block route", "ldlt_factor_solve_matrix_kernel<", None),
              ("K5 warp route", "ldlt_factor_solve_matrix_kernel_warp<",
               None),
              ("K5 split route", "ldlt_factor_solve_matrix_kernel_split<",
               None),
              ("K3", "ldlt_solve_kernel", None),
              ("K3 thread route", "ldlt_solve_kernel", "_warp"),
              ("K3 warp route", "ldlt_solve_kernel_warp", None))


def k3_split(fn, label):
    """K3's launches in one call of ``fn``, by (route, order, systems,
    type), recorded at its two launchers, each shape's device ms per
    launch (chip_smoke.launch_ms, every shape in one trace) on factors of
    that shape, and their product: where K3's time goes per shape."""
    import collections
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    calls = collections.Counter()
    saved = {r: getattr(cuda_ldlt, f) for r, f in
             (("thread", "solve_soa"), ("warp", "solve_soa_warp"))}

    def recording(route):
        def launch(L_t, D_t, b_t):
            calls[(route,) + tuple(b_t.shape) + (b_t.dtype,)] += 1
            return saved[route](L_t, D_t, b_t)
        return launch
    try:
        for r, f in (("thread", "solve_soa"), ("warp", "solve_soa_warp")):
            setattr(cuda_ldlt, f, recording(r))
        fn()
        torch.cuda.synchronize()
    finally:
        cuda_ldlt.solve_soa = saved["thread"]
        cuda_ldlt.solve_soa_warp = saved["warp"]
    total = 0.0
    shapes = sorted(calls, key=lambda k: -k[1])
    groups = []
    for route, n, B, dtype in shapes:
        soa = cs.k3_inputs(n, B, dtype, torch.device("cuda"), seed=n + B)[3]
        groups.append((lambda route=route, soa=soa: cs.k3_call(route, *soa),
                       {route: cs.K3_KERNELS[route]}))
    for (route, n, B, dtype), t in zip(shapes, cs.launch_ms(groups, 20)):
        count, ms = calls[(route, n, B, dtype)], t[route]
        total += count * ms
        print(f"    {label}: K3 {route} route n={n} B={B} "
              f"{str(dtype).replace('torch.', '')}: {count} launches x "
              f"{ms:.4f} device ms = {count * ms:.3f} ms")
    print(f"    {label}: K3 {sum(calls.values())} launches, "
          f"{total:.3f} device ms by the split")


def shares(events, busy, kernels):
    """Each kernel's device ms and share of ``busy``, by name."""
    out = []
    for label, key, unless in kernels:
        ms = sum(t for name, t in events
                 if key in name and (unless is None or unless not in name))
        out.append(f"{label} {ms:.3f} ms ({ms / busy:.4f} of device time)")
    return ", ".join(out)


def profile_schur(dev):
    import torch
    from ipmzoo_tpu_torch.parallel import SchurIPM
    data = cs.schur_data(dev)
    for tol in (1e-8, 1e-5):
        solver = SchurIPM(cs.SCHUR_N, cs.SCHUR_MC, dtype=torch.float32,
                          tol=tol, refine=2, max_iter=60, device=dev)
        res = solver.solve_batch(data)
        steps = int(res.iterations.max())
        med = cs.time_solves(lambda: solver.solve_batch(data), 5)
        events = []
        busy, launches = profiled(lambda: solver.solve_batch(data),
                                  f"schur tol={tol:g}", events)
        print(f"schur tol={tol:g} (solved in {solver.compute_dtype}): wall "
              f"median {med:.3f} ms; iterations {steps}; launches per "
              f"iteration {launches / steps:.1f}; busy share "
              f"{busy / med:.4f}; " + shares(events, busy, SCHUR_KERNELS))
        k3_split(lambda: solver.solve_batch(data), f"schur tol={tol:g}")
        d = solver._check(data, 1)
        st = solver.init_state(d)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver._step(d, st)
            torch.cuda.synchronize()
            print(f"    one _step {1e3 * (time.perf_counter() - t0):.3f} ms "
                  f"(host clock)")


def profile_arrow():
    import torch
    from ipmzoo_tpu_torch.models.state import tree_map
    data, st, batch = cs.arrow_slice_data()
    solver = cs.arrow_solver(data, st)
    one = tree_map(lambda a: a[None], data)
    for label, d in (("arrow single", one),
                     (f"arrow batch of {cs.ARROW_BATCH}", batch)):
        res = solver.solve_batch(d)
        steps = int(res.iterations.max())
        med = cs.time_solves(lambda: solver.solve_batch(d), 5)
        events = []
        busy, launches = profiled(lambda: solver.solve_batch(d), label,
                                  events)
        k6 = sum(ms for key, ms in events if "cr_factor_kernel" in key)
        k6c = sum(ms for key, ms in events
                  if "cr_factor_kernel_cluster" in key)
        k7 = sum(ms for key, ms in events if "cr_solve_kernel" in key)
        k7s = sum(ms for key, ms in events
                  if "cr_solve_kernel_shared" in key)
        print(f"{label}: wall median {med:.3f} ms; iterations {steps}; "
              f"launches per iteration {launches / steps:.1f}; busy share "
              f"{busy / med:.4f}; K6 {k6:.3f} ms ({k6 / busy:.4f} of device "
              f"time; cluster route {k6c:.3f} ms, block route "
              f"{k6 - k6c:.3f}), K7 {k7:.3f} ms ({k7 / busy:.4f}; shared "
              f"route {k7s:.3f} ms, block route {k7 - k7s:.3f})")
        dd = solver._check_data(d)
        state = solver.init_state(dd)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver._step_impl(state, dd)
            torch.cuda.synchronize()
            print(f"    one _step_impl "
                  f"{1e3 * (time.perf_counter() - t0):.3f} ms (host clock)")


def profile_nd():
    import torch
    from ipmzoo_tpu_torch.models.families import grid_qp
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.ops.ndiss import nd_factor_pre, nd_solve
    solver, data = cs.nd_solver(torch.float32, 1e-5)
    one = tree_map(lambda a: a[None], data)
    batch = grid_qp(side=cs.ND_SIDE, batch=cs.ND_BATCH, seed=0,
                    dtype=torch.float32).data

    def host_ms(what, fn, reps=3):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            print(f"    one {what} {1e3 * (time.perf_counter() - t0):.3f} ms "
                  f"(host clock)")
        return out

    for label, d in (("nd single", one),
                     (f"nd batch of {cs.ND_BATCH}", batch)):
        res = solver.solve_batch(d)
        steps = int(res.iterations.max())
        med = cs.time_solves(lambda: solver.solve_batch(d), 5)
        events = []
        busy, launches = profiled(lambda: solver.solve_batch(d), label,
                                  events)
        print(f"{label}: wall median {med:.3f} ms; iterations {steps}; "
              f"launches per solve {launches}, per iteration "
              f"{launches / steps:.1f} (prework included); busy share "
              f"{busy / med:.4f}; " + shares(events, busy, ND_KERNELS))
        k3_split(lambda: solver.solve_batch(d), label)
        dd = solver._check_data(d)
        state = solver.init_state(dd)
        pre = host_ms("_nd_prework", lambda: solver._nd_prework(dd), 2)
        host_ms("_step_impl", lambda: solver._step_impl(state, dd,
                                                        nd_pre=pre))
        plan = solver._nd_plan
        w = torch.zeros_like(pre[1])
        factors = host_ms("nd_factor_pre", lambda: nd_factor_pre(
            pre[0], plan, diag_delta=w))
        host_ms("nd_solve", lambda: nd_solve(plan, factors, dd.c))
        profiled(lambda: nd_factor_pre(pre[0], plan, diag_delta=w),
                 f"{label}, one nd_factor_pre")
        profiled(lambda: nd_solve(plan, factors, dd.c),
                 f"{label}, one nd_solve")


#: the LDL^T kernel of the dense modes: K2's block route (the blocked
#: LDL^T's diagonal panels and the 'normal' mode's H^-1)
DENSE_KERNELS = (("K2 block route", "ldlt_factor_kernel_block", None),)


def profile_dense(dev):
    import torch
    import bench_torch
    from ipmzoo_tpu_torch import CompiledIPM, QPData
    from ipmzoo_tpu_torch.formulations import (Bounds, InequalityHandling,
                                               Settings)
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.models.state import tree_map
    aug = bench_torch.aug_data(dev)
    n, m, B, _ = bench_torch.normal_sizes()
    normal = make_batch(B, n, m, torch.float32, device=dev)
    cases = [("aug", k, bench_torch.aug_solver(k, dev), aug)
             for k in ("auto", "blockg")] + \
        [("normal", k, bench_torch.normal_solver(k, dev), normal)
         for k in ("blockg", "block", "normal")]
    for what, k, s, d in cases:
        label = f"{what} kernel={k} ({s._mode})"
        res = s.solve_batch(d)
        steps = int(res.iterations.max())
        med = cs.time_solves(lambda: s.solve_batch(d), 3)
        events = []
        busy, launches = profiled(lambda: s.solve_batch(d), label, events)
        print(f"{label}: wall median {med:.3f} ms; iterations {steps}; "
              f"launches per iteration {launches / steps:.1f}; busy share "
              f"{busy / med:.4f}; " + shares(events, busy, DENSE_KERNELS))

    Q, c, lo, hi = bench_torch.arrow_problem()
    arrow = CompiledIPM(Settings(inequalities=Bounds.NONE,
                                 inequality_handling=InequalityHandling.SLACKS),
                        n=Q.shape[0], dtype=torch.float32, tol=1e-5,
                        device=dev)
    a_data = QPData.make(Q=Q, c=c, l_x=lo, u_x=hi, dtype=torch.float32,
                         device=dev)
    nd, n_data = bench_torch.nd_problem(dev)
    n_dense = CompiledIPM(nd.settings, n=nd.n, dtype=torch.float32,
                          tol=1e-5, device=dev)
    for what, s, d in (("arrow dense", arrow, a_data),
                       ("nd dense", n_dense, n_data)):
        one = s._check_data(tree_map(lambda a: a[None], d))
        state = s.init_state(one)
        med = cs.time_solves(lambda: s._step_impl(state, one), 5)
        events = []
        busy, launches = profiled(lambda: s._step_impl(state, one),
                                  f"{what} step ({s._mode})", events)
        print(f"{what} step ({s._mode}): wall median {med:.3f} ms; "
              f"launches {launches}; busy share {busy / med:.4f}")

    for d in bench_torch.kkt_dims():
        blocks, R = bench_torch.kkt_large_systems(dev, d)
        fn = functools.partial(bench_torch.blockg_two_solves, blocks, R)
        med = cs.time_solves(fn, 5)
        busy, launches = profiled(fn, f"kkt large order {d} B={R.shape[0]}")
        print(f"kkt large order {d}: wall median {med:.3f} ms; launches "
              f"{launches}; busy share {busy / med:.4f}")


def k1_stages(solver, runs):
    """Run each (label, fn) of ``runs`` twice, ``fn`` a solve of
    ``solver``: print the wall and the host-clock time of each stage
    (solve_fused, the escalation, the safety-net tail; each ends in a
    synchronize) beside each K1 launch's route, batch and device time
    (CUDA events around the launch alone), K1's device ms by route,
    converged instances, host syncs and escalated instances."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused
    stages = []
    k1 = []   # (route, batch, start event, end event) of each K1 launch
    fused_soa = cuda_fused.fused_soa

    def traced(source, data_soa, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fused_soa(source, data_soa, *args, **kw)
        end.record()
        # (warm, n, total, max_iter, gondzio, params, route)
        route = args[6] if len(args) > 6 else kw.get("route", "thread")
        k1.append((route, data_soa[0].shape[-1], start, end))
        return out

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            first = len(k1)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            stages.append((name, ms, [(r, b, s.elapsed_time(e))
                                      for r, b, s, e in k1[first:]]))
            return out
        return wrapper

    cuda_fused.fused_soa = traced
    for name in ("solve_fused", "_escalate_tail", "_gondzio_tail"):
        setattr(solver, name, timed(name, getattr(solver, name)))
    try:
        for label, fn in runs:
            for rep in range(2):
                stages.clear()
                solver.host_syncs = 0
                escalated = solver.escalated
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                print(f"{label} run {rep}: wall "
                      f"{1e3 * (time.perf_counter() - t0):.3f} ms (host "
                      f"clock), converged {int(out['converged'].sum())}, "
                      f"host syncs {solver.host_syncs}, escalated "
                      f"{int(solver.escalated - escalated)}")
                k1_ms = {}
                for name, ms, launches in stages:
                    dev_ms = "".join(
                        f"; K1 {r} route B={b}: {t:.3f} ms device"
                        for r, b, t in launches)
                    print(f"    {ms:10.3f} ms  {name}{dev_ms}")
                    for r, _, t in launches:
                        k1_ms[r] = k1_ms.get(r, 0.0) + t
                print("    K1 device ms by route (CUDA events around each "
                      "launch): " + ", ".join(f"{r} {t:.3f}"
                                              for r, t in k1_ms.items()))
    finally:
        cuda_fused.fused_soa = fused_soa
        for name in ("solve_fused", "_escalate_tail", "_gondzio_tail"):
            delattr(solver, name)


def profile_fused(dev, data):
    import torch
    solver = cs.fused_solver(dev, torch.float32)
    k1_stages(solver, [(f"fused esc_cap={esc}",
                        lambda esc=esc: solver.solve_fused_compact(
                            data, esc_cap=esc)) for esc in (32, 0)])
    profiled(lambda: solver.solve_fused_compact(data, esc_cap=32),
             "fused esc_cap=32")
    team_clocked_share(dev)


def team_clocked_share(dev):
    """The share of a cold solve_fused(max_iter=14) launch of K1's team
    route at the fused slice's shape that its teams spend in their factor,
    read inside the launch (ops/cuda_k1_measure.clocked_team: the team
    kernel with its factor wrapped in clock64 reads): the factor's cycles
    over the teams' cycles from their block's start, summed over the
    instances.  Turned into ms of one factor of the whole batch (the
    share of the launch's ms over the mean iterations an instance), it
    stands beside T3's team route's factor at the same B (the slope of
    prefix 2 less prefix 1, chip_phases.time_phases), which compares two
    builds; the clocked and the launched kernels' ms (CUDA events, mean
    of 3) and whether they gave the same bits are printed with it."""
    import torch
    import chip_phases as ph
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.ops import cuda_fused, cuda_k1_measure
    B = cs.B_SLICE
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        solver = cs.fused_solver(dev, dtype)
        soa, _ = solver.soa_inputs(make_batch(B, 16, 8, dtype, device=dev))
        args = (soa, None, solver.n, sum(solver.var_sizes), 14, 0,
                solver.kernel_params())
        lib = cuda_k1_measure.team_library(solver)
        src = solver.kernel_source("team")
        stream = torch.cuda.current_stream(dev).cuda_stream

        def clock():
            outs, cycles, err = cuda_k1_measure.clocked_team(lib, *args,
                                                             stream)
            cs.check(err == 0, f"clocked team route: cudaError {err}")
            return outs, cycles

        def launched():
            return cuda_fused.fused_soa(src, *args, "team")

        outs, cycles = clock()
        ref = launched()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(outs, ref))
        share = float(cycles[0].sum()) / float(cycles[1].sum())
        iters = float(outs[2].sum()) / B
        launch_ms = cs.time_cuda(launched, 3)
        clock_ms = cs.time_cuda(lambda: clock()[0], 3)
        times, _ = ph.time_phases(dev, B, dtype, None, "team")
        t3 = ph.phase_split(times)["factor"]
        per_factor = share * launch_ms / iters
        print(f"factor share in the launch, team route B={B} {name} "
              f"(clock64, cold max_iter=14): {share:.4f} of the teams' "
              f"cycles, {float(cycles[0].sum()) / float(outs[2].sum()):.0f} "
              f"cycles a factor, {iters:.3f} iterations an instance; "
              f"launch {launch_ms:.4f} ms (clocked {clock_ms:.4f}, same bits "
              f"{same}): {per_factor:.4f} ms a factor of the batch, against "
              f"T3's team factor {t3:.4f} ms a repetition "
              f"({per_factor / t3:.2f}x)")


#: K1's wide routes and their kernels' names under torch.profiler
K1_WIDE_KERNELS = (("wide", "fused_wide_kernel"),
                   ("block", "fused_wide_block_kernel"))


def profile_wide(dev):
    """Section ``wide``: bench_torch.py's wide mode (the wide slice of
    chip_smoke.py step 46) before and after the block route, in one
    process: its solve with K1 held on the wide route (k1_route
    replaced), then on the route k1_route picks.  For each, the stages
    and K1's launches (k1_stages), the wall by CUDA events (median of 5
    after a warm-up), launches by route, and under torch.profiler the
    busy time, launches and K1's device ms by route, a launch, and its
    share of busy and of the wall; then the factor alone
    (factor_alone) and its share read inside the launch
    (clocked_share)."""
    import torch
    import bench_torch
    from ipmzoo_tpu_torch.ops import cuda_fused
    fam, solver = bench_torch.wide_problem(dev)
    picked = cuda_fused.k1_route
    for label, route in (("wide slice before (K1 on the wide route)",
                          "wide"),
                         ("wide slice after (K1 on k1_route's pick)",
                          None)):
        if route:
            cuda_fused.k1_route = lambda *a, **k: route
        try:
            def run():
                return solver.solve_fused_compact(fam.data)
            k1_stages(solver, [(label, run)])
            wall = cs.time_solves(run, 5)
            cuda_fused.reset_launch_counts()
            run()
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda_fused.route_launches.items()
                        if v}
            events = []
            busy, n_launches = profiled(run, label, events)
            parts = []
            for r, key in K1_WIDE_KERNELS:
                ms = sum(t for k, t in events if key in k)
                count = launches.get(f"fused {r}", 0)
                if count:
                    parts.append(f"K1 {r} route {ms:.3f} device ms "
                                 f"({ms / count:.3f} a launch, {count} "
                                 f"launches), {ms / busy:.4f} of busy, "
                                 f"{ms / wall:.4f} of the wall")
            print(f"{label}: wall median {wall:.3f} ms (CUDA events), busy "
                  f"{busy:.3f} ms ({busy / wall:.4f} of the wall), "
                  f"{n_launches} kernel launches; K1 launches by route "
                  f"{launches}; " + "; ".join(parts))
        finally:
            cuda_fused.k1_route = picked
    factor_alone(dev)
    clocked_share(dev)


def factor_alone(dev, reps=4):
    """The LDL^T of K1's wide and block routes alone at chip_smoke's
    wide_rows(), float32 and float64 (ops/cuda_k1_measure.factor_reps):
    each instance's packed quasi-definite matrix of the shape's order
    (chip_smoke's quasi_definite_on) factored 1 and 1 + ``reps`` times in
    one launch, each from a fresh copy; the slope is the ms of one factor
    of the whole batch.  The wide route's factor (team_ldlt on one warp,
    K and D in device memory) at the wide build's blocks per SM, two
    ways: a grid of that many blocks an SM, the L1 left whole as in the
    route's launch; and a block for each instance with shared memory
    padded to hold an SM to that many, which takes the L1's bytes.  The
    block route's factor (block_ldlt on W warps, K in shared memory) at
    each W of chip_smoke's BLOCK_WARPS at its build's blocks per SM, by
    the grid.  Their sinks must agree bit for bit.  Printed beside the
    bytes team_ldlt reads (B a^3 / 3 values) and the rate that implies,
    and the cold max_iter=14 launch of each route with the factor's
    share of it (instance-iterations / B factors an instance)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused, cuda_k1_measure
    from ipmzoo_tpu_torch.utils.timer import cuda_time
    for n, m, e, B, tol32 in cs.wide_rows():
        for dtype, tol in ((torch.float32, tol32), (torch.float64, 1e-6)):
            solver, data = cs.wide_case(n, m, e, B, dtype, dev, tol)
            a = solver.aug_dim
            name = (f"n={n} m_ineq={m} m_eq={e} aug {a} B={B} "
                    f"{str(dtype).replace('torch.', '')}")
            if not cs.block_fits(solver, dtype):
                print(f"factor alone {name}: the block does not fit")
                continue
            lib = cuda_k1_measure.library(solver)
            blib = cuda_fused.library(solver.kernel_source("block"),
                                      "fused_wide_block")
            wlib = cuda_fused.library(solver.kernel_source("wide"),
                                      "fused_wide")
            K, _ = cs.quasi_definite_on(B, a, dtype, dev, seed=a + B)
            rows, cols = torch.tril_indices(a, a, device=dev)
            K0 = K[:, rows, cols].contiguous()
            del K
            pf = solver.pivot_floor
            stream = torch.cuda.current_stream(dev).cuda_stream
            wide_sm = cuda_fused.wide_shape(wlib, dtype)["blocks_per_sm"]
            # an SM's 228 KB of shared memory, less the 1 KB the runtime
            # keeps a block, shared among wide_sm blocks
            pad = 233472 // wide_sm - 1024
            cases = [("wide", 0, wide_sm, 0),
                     ("wide, shared-padded", 0, 0, pad)]
            cases += [(f"block W={w}", w, cuda_fused.block_shape(
                blib, dtype, w)["blocks_per_sm"], 0) for w in cs.BLOCK_WARPS]
            sinks, ms = {}, {}
            for label, w, resident, pad_bytes in cases:
                def launch(r, w=w, resident=resident, pad_bytes=pad_bytes):
                    sink, err = cuda_k1_measure.factor_reps(
                        lib, K0, r, w, pf, resident, pad_bytes, stream)
                    cs.check(err == 0, f"factor alone {label}: cudaError "
                             f"{err}")
                    return sink
                sinks[label] = launch(1 + reps)
                t1 = cuda_time(lambda: launch(1), runs=3).ms
                t2 = cuda_time(lambda: launch(1 + reps), runs=3).ms
                ms[label] = (t2 - t1) / reps
            torch.cuda.synchronize()
            same = all(torch.equal(v, sinks["wide"]) for v in sinks.values())
            cs.check(same and bool(torch.isfinite(sinks["wide"]).all()),
                     f"factor alone {name}: the sinks differ or are not "
                     f"finite")
            call = (data, None, 14, 0)
            wide = cs.k1_launcher(solver, call, "wide")
            outs = wide()
            per = float(outs[2][0].sum()) / B
            launch_ms = {"wide": cs.time_cuda(wide, 3)}
            launch_ms["wide, shared-padded"] = launch_ms["wide"]
            for w in cs.BLOCK_WARPS:
                launch_ms[f"block W={w}"] = cs.time_cuda(
                    cs.block_launcher(solver, call, w), 3)
            gb = B * a ** 3 / 3 * dtype.itemsize / 1e9
            print(f"factor alone {name} (ms a factor of the batch, slope of "
                  f"1 and {1 + reps} in one launch, CUDA events): " +
                  ", ".join(f"{c[0]} {ms[c[0]]:.4f} (blocks per SM "
                            f"{c[2] or wide_sm}"
                            + (f", {c[3]} B of shared memory a block"
                               if c[3] else ", by the grid") + ")"
                            for c in cases) +
                  f"; team_ldlt reads {gb:.3f} GB a factor: "
                  f"{gb / ms['wide']:.2f} TB/s on the wide route, "
                  f"{gb / ms['wide, shared-padded']:.2f} shared-padded; "
                  f"sinks bit-equal")
            print(f"factor share {name}: {per:.2f} factors an instance in "
                  f"the cold max_iter=14 launch; " + ", ".join(
                      f"{k}: launch {launch_ms[k]:.4f} ms, factor "
                      f"{per * ms[k]:.4f} ms = "
                      f"{per * ms[k] / launch_ms[k]:.4f} of it"
                      for k in ms))


def clocked_share(dev):
    """The share of a cold max_iter=14 launch that K1's wide and block
    routes spend in their factor, read inside the launch (ops/
    cuda_k1_measure.clocked: each route's kernel with its factor wrapped
    in clock64 reads) at chip_smoke's wide_rows() in both types, the
    block route at K1_BLOCK_RULE's W (4 where the rule keeps the wide
    route) where it fits: the factor's cycles over the blocks' lives,
    summed over the instances.  Printed beside the clocked and the
    launched kernels' ms (CUDA events, mean of 3) and whether the
    clocked launch gave the launched one's bits."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused, cuda_k1_measure
    for n, m, e, B, tol32 in cs.wide_rows():
        for dtype, tol in ((torch.float32, tol32), (torch.float64, 1e-6)):
            solver, data = cs.wide_case(n, m, e, B, dtype, dev, tol)
            name = (f"n={n} m_ineq={m} m_eq={e} aug {solver.aug_dim} "
                    f"B={B} {str(dtype).replace('torch.', '')}")
            lib = cuda_k1_measure.library(solver)
            call = (data, None, 14, 0)
            soa, _ = solver.soa_inputs(data)
            args = (soa, None, solver.n, sum(solver.var_sizes), 14, 0,
                    solver.kernel_params())
            runs = [("wide", 0, cuda_fused.wide_shape(cuda_fused.library(
                solver.kernel_source("wide"), "fused_wide"), dtype)["region"],
                cs.k1_launcher(solver, call, "wide"))]
            if cs.block_fits(solver, dtype):
                w = cuda_fused.block_warps(solver.k1_sizes(), dtype,
                                           solver.k1_slots()) or 4
                blib = cuda_fused.library(solver.kernel_source("block"),
                                          "fused_wide_block")
                runs.append((f"block W={w}", w, cuda_fused.block_shape(
                    blib, dtype, w)["region"],
                    cs.block_launcher(solver, call, w)))
            parts = []
            for label, w, region, launched in runs:
                stream = torch.cuda.current_stream(dev).cuda_stream

                def clock(w=w, region=region, stream=stream):
                    outs, cycles, err = cuda_k1_measure.clocked(
                        lib, *args, w, region, stream)
                    cs.check(err == 0, f"clocked {label}: cudaError {err}")
                    return outs, cycles
                outs, cycles = clock()
                ref = launched()
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(outs, ref))
                share = float(cycles[0].sum()) / float(cycles[1].sum())
                parts.append(
                    f"{label}: factor {share:.4f} of the blocks' cycles, "
                    f"{float(cycles[0].sum()) / float(outs[2].sum()):.0f} "
                    f"cycles a factor; clocked launch "
                    f"{cs.time_cuda(lambda: clock()[0], 3):.4f} ms, "
                    f"launched {cs.time_cuda(launched, 3):.4f} ms, same "
                    f"bits {same}")
            print(f"factor share in the launch {name} (clock64, cold "
                  f"max_iter=14): " + "; ".join(parts))


def profile_compact(dev, data):
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    solver = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-6,
                         device=dev)
    solver.solve_batch_compact(data)
    for esc in ("auto", 0, 0, "auto"):
        res = solver.solve_batch_compact(data, esc_cap=esc)
        med = cs.time_solves(
            lambda: solver.solve_batch_compact(data, esc_cap=esc), 2)
        print(f"compact esc_cap={esc!r}: converged "
              f"{int(res.converged.sum())}, iterations "
              f"{int(res.iterations.sum())}, wall median {med:.3f} ms")


def profile_mpc(dev):
    import torch
    import bench_torch
    from ipmzoo_tpu_torch.models import mpc
    data, solver = bench_torch.mpc_problem(dev)
    res = solver.solve_batch(data)
    steps = int(res.iterations.max())
    med = cs.time_solves(lambda: solver.solve_batch(data), 5)
    dd = solver._check_data(data)
    state = solver.init_state(dd)

    def step_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver._step_impl(state, dd)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    # the host-clock split first: a torch.profiler session may leave
    # the launches of this process slower
    print("    one _step_impl " + ", ".join(
        f"{step_ms():.3f}" for _ in range(3)) + " ms (host clock, no "
        "synchronize inside)")
    spent = {"riccati_factor": 0.0, "riccati_solve": 0.0}
    saved = {name: getattr(mpc, name) for name in spent}

    def timing(name):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*a)
            torch.cuda.synchronize()
            spent[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return call
    try:
        for name in spent:
            setattr(mpc, name, timing(name))
        for _ in range(3):
            for name in spent:
                spent[name] = 0.0
            total = step_ms()
            rest = total - sum(spent.values())
            print(f"    one _step_impl {total:.3f} ms (host clock, a "
                  f"synchronize around each call): riccati_factor "
                  f"{spent['riccati_factor']:.3f}, riccati_solve "
                  f"{spent['riccati_solve']:.3f}, the rest {rest:.3f}")
    finally:
        for name, fn in saved.items():
            setattr(mpc, name, fn)
    busy, launches = profiled(lambda: solver.solve_batch(data), "mpc")
    print(f"mpc: wall median {med:.3f} ms; iterations {steps} (summed "
          f"{int(res.iterations.sum())}); launches per iteration "
          f"{launches / steps:.1f}; busy share {busy / med:.4f}")
    g, h, _, _ = solver._slacks(dd, state.vars[0], state.vars[1])
    Rt = mpc._add_diag(dd.R, state.vars[3] / g + state.vars[4] / h)
    factors = mpc.riccati_factor(dd.Q, Rt, dd.A, dd.B)
    ru, rx, rd = state.res
    profiled(lambda: mpc.riccati_factor(dd.Q, Rt, dd.A, dd.B),
             "mpc, one riccati_factor")
    profiled(lambda: mpc.riccati_solve(factors, dd.A, dd.B, rx, ru, -rd),
             "mpc, one riccati_solve")


def profile_tf(dev, data):
    import torch
    import bench_torch
    from ipmzoo_tpu_torch.models.state import tree_map
    sub = tree_map(lambda a: a[:bench_torch.TF_B], data)
    tf = bench_torch.tf_solver(dev)
    f64 = bench_torch.compact_solver(dev, torch.float64,
                                     tol=bench_torch.TF_TOL, max_iter=30)
    sub64 = sub.to(dtype=torch.float64)
    steps = sum(k for k, _ in tf.default_schedule(bench_torch.TF_B))
    walls = {}
    for label, solver, d in (("tf two_float", tf, sub),
                             ("tf plain float64", f64, sub64)):
        res = solver.solve_batch_compact(d)
        med = walls[label] = cs.time_solves(
            lambda: solver.solve_batch_compact(d), 3)
        dd = solver._check_data(d)
        state = solver.init_state(dd)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver._step_impl(state, dd)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        print(f"{label}: converged {int(res.converged.sum())}, iterations "
              f"{int(res.iterations.sum())}, wall median {med:.3f} ms "
              f"({steps} batched steps); one _step_impl at B="
              f"{bench_torch.TF_B} " + ", ".join(f"{t:.3f}" for t in ms) +
              " ms (host clock)")
    events = []
    busy, launches = profiled(lambda: tf.solve_batch_compact(sub),
                              "tf two_float", events)
    print(f"tf two_float: launches per batched step {launches / steps:.1f}; "
          f"busy share {busy / walls['tf two_float']:.4f}; " +
          shares(events, busy, SCHUR_KERNELS[:6]))


def main():
    import torch
    from chip_roofline import banner
    dev = banner("chip_profile", "the profiles are taken")
    if dev is None:
        return 2
    from ipmzoo_tpu_torch.models.convert import make_batch
    known = ["schur", "fused", "compact", "arrow", "nd", "dense", "mpc",
             "tf", "wide"]
    sections = sys.argv[1:] or known
    unknown = set(sections) - set(known)
    if unknown:
        print(f"chip_profile: unknown sections {sorted(unknown)}",
              file=sys.stderr)
        return 2
    if set(sections) - {"nd", "schur", "dense", "mpc", "tf", "wide"}:
        from ipmzoo_tpu_torch.ops import cuda_k1_measure
        extra = {}
        if "fused" in sections:
            solver = cs.fused_solver("cpu", torch.float32)
            extra["k1 team measure"] = functools.partial(
                cuda_k1_measure.team_library, solver)
        cs.build_kernels(extra)
    elif "wide" in sections:
        from chip_roofline import build_all
        from ipmzoo_tpu_torch.ops import cuda_ldlt
        from ipmzoo_tpu_torch.ops import cuda_k1_measure
        jobs = {k: job[2] for k, job in cs.wide_jobs().items()
                if " apart" not in k}
        for shape in cs.wide_rows():
            solver = cs.wide_case(*shape[:3], 1, torch.float32, "cpu")[0]
            jobs[f"measure{shape[:3]}"] = functools.partial(
                cuda_k1_measure.library, solver)
        jobs["ldlt"] = cuda_ldlt._lib
        build_all(jobs)
    if "schur" in sections:
        profile_schur(dev)
    if {"fused", "compact", "tf"} & set(sections):
        data = make_batch(cs.B_SLICE, 16, 8, torch.float32, device=dev)
    if "fused" in sections:
        profile_fused(dev, data)
    if "compact" in sections:
        profile_compact(dev, data)
    if "arrow" in sections:
        profile_arrow()
    if "nd" in sections:
        profile_nd()
    if "dense" in sections:
        profile_dense(dev)
    if "mpc" in sections:
        profile_mpc(dev)
    if "tf" in sections:
        profile_tf(dev, data)
    if "wide" in sections:
        profile_wide(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
