#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ipmzoo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one
                                 # CUDA card and nvcc

Steps, each reported on its own line:

1. refuse to run without a CUDA device (there is no CPU fallback);
2. print the card's name and power limit (nvidia-smi);
3. build the CUDA kernels from ipmzoo_tpu_torch/csrc/ and report the time,
   with ptxas' registers, stack frame, spills and static shared memory of
   each instantiation of K3's and K4's warp routes, K6's cluster route and
   K7's shared route, and for
   the cluster route at the arrow shape (N=256, b=16) each cluster size's
   threads a block, dynamic shared memory and
   cudaOccupancyMaxActiveClusters (which must be > 0);
4. hold kernels K2 (LDL^T factor) and K3 (LDL^T solve) against their
   plain torch versions on the card at n=24, B=10240: float32 within a
   relative difference of 1e-5, float64 within 1e-12 (largest absolute
   difference over the largest magnitude of the plain result), and an
   exactly-zero pivot replaced by the floor exactly in both; then K4
   (multi-rhs LDL^T solve) against its plain version at the Schur
   slice's n=64, k=16, B=512, at n=24, k=2, B=10240 and at n=13, k=5,
   B=1000, in the same measure and limits, through solve_ldlt_matrix_auto
   and each route alone (the thread route, a thread per (matrix, column),
   and the warp route, a staged tile of the factor and segments of a warp
   across the right-hand sides) there and at K4_EDGES in both types (n=1,
   the smallest orders, odd n, a batch that fills no tile, k=1, k over a
   segment's 4 columns and over a block's chunk, the route's cap 96 and
   97), with the largest difference between the two routes' X and the
   wrapper taking the route k4_route picks; then each route of K2 alone
   (the SoA route, a thread per matrix, and the block route, a thread
   block per matrix) at every (order, matrices) of K2_SHAPES: the
   compact slice's batches and its float64 escalation, the Schur slice's
   H and S blocks, the equality_qp slice's KKT (30, 64), the normal
   slice's order-128 panels (128, 16), the condensed MPC QP of step 43
   (96, 8), odd orders, n=1, batches that fill no whole block, the tf
   slice's batches (24, 2048) and (24, 512) (step 47);
   the SoA route also at (328, 1), over the block route's shared memory;
   and both on an exactly-zero pivot; then each route of K3 alone (the
   thread route, a thread per matrix, and the warp route, a tile of
   instances staged in shared memory and a warp or a segment of one per
   matrix) at every (order, systems) of K3_SHAPES (the compact slice's
   batches, its float64 escalation, the Schur slice's H and S blocks, the
   nd slice's levels, the equality_qp slice's KKT (30, 64, float64),
   the condensed MPC QP of step 43 (96, 8, float64), the nd slice's
   generic top, both over the warp route's cap, the levels of step
   44's side-96 plan and the tf slice's float64 batches (24, 2048) and
   (24, 512)) and
   of K3_EDGES in both types (n=1, odd orders, a batch that fills no
   tile, the cap 83 and 84), float32 within 1e-5 and float64 within
   1e-12, the largest difference between the two routes' x, and
   solve_ldlt_auto taking the route k3_route picks (at order 328 the
   blocked route's library solve that ldlt_route picks);
5. solve the README's demo QP on the card (float64, tol 1e-8);
6. run the slice: CompiledIPM(Settings(), n=16, m_ineq=8, float32,
   tol=1e-6).solve_batch_compact on 10240 QPs of the benchmark workload
   with the reference's default esc_cap='auto' (32 here: the float64
   escalation stage), with >= 99% converged and both kernels launched by
   that run; report the share converged, the instances escalated, the
   float64 K2/K3 launches and the host syncs; time it with CUDA events
   (median of 3 runs after the first) and report useful IPM
   iterations/s (per-instance iterations summed over the batch);
7. check the slice's objectives against the port on the CPU in float64
   on the first 256 instances: |f_gpu - f_cpu| <= 1e-4 (1 + |f_cpu|);
8. time K2 and K3 against their plain versions at the slice's batch
   sizes (10240, 2560, 320) with CUDA events, and both K2 routes there
   (each with its caller's layout work), at the float64 escalation's
   B=32, at step 43's condensed MPC QP (96, 8) float64, at the tf
   slice's float64 batches (24, 2048) and (24, 512) (with K3's warp
   route, its plain version and torch.linalg.ldl_solve at (24, 2048)) and
   at (328, 1), by CUDA events (torch.linalg.ldl_solve at the slice's
   (24, 10240) float32, seconds a call, once: the checked call itself) and by their kernels' device
   time under torch.profiler; fail where k2_route picks a route whose
   device time is more than 5% (timing noise) above the other's; the same
   for both K3 routes at every shape of step 4's K3 check, all in one
   torch.profiler trace (k3_route; two launches within 0.2 us tie, as at
   n=1 where both take the launch's 1.3-1.7 us), with CUDA events behind
   a leading launch printed beside; and both K4 routes at every shape of
   step 4's K4 check, in one trace: fail where k4_route picks a route
   more than 5% slower at K4_SHAPES (the Schur slice's H blocks among
   them);
9. build kernel K1 (the fused whole-solve IPM), generated for the fused
   slice's formulation (Settings(), n=16, m_ineq=8), on both routes: the
   thread route (one thread per instance) and the team route (a team of
   lanes per instance, state in shared memory) at 16 and at 32 lanes;
   report each build's time and ptxas' registers, stack frame and
   spills, and for the team route its threads a block, bytes of shared
   memory a team and teams resident per SM, float32 and float64; and
   K1's wide route (one warp an instance, csrc/fused_wide.cuh) for each
   formulation and sizes of step 45, with its threads a block, workspace
   values an instance and blocks resident per SM, and K1's block route
   (one thread block an instance, csrc/fused_wide_block.cuh) at the same
   sizes, with its threads a block, workspace values an instance, shared
   bytes a block and blocks resident per SM at each W of BLOCK_WARPS,
   and both routes' check builds (the generated functions compiled
   apart) at the same sizes (the builds run beside step 3's, all nvcc
   processes started together);
10. hold K1's thread route against its plain version on the card at
    B=10240: a cold solve_fused(max_iter=14), a warm resume of its
    output and a cold solve with gondzio=2; float64 iterations equal on
    every instance and x within 1e-10 relative; float32 at tol 1e-6 x
    within 1e-4 relative on the instances converged in both, and at tol
    1e-5 iterations equal on >= 99% (see check_fused for why not at
    1e-6); step 34 holds the team route the same way;
11. run the fused slice: FusedBatchedIPM(Settings(), n=16, m_ineq=8,
    float32, tol=1e-6, max_iter=30).solve_fused_compact(esc_cap=32), the
    reference's default, on the 10240 QPs, with >= 99.9% converged,
    finite x and K1 launched by that run on the routes k1_route picks,
    the team route at least once; report the share converged, the
    instances escalated, launches (K1 by route, float64 K2/K3 apart),
    the host syncs of the escalation stage and of the safety-net tail,
    the wall by CUDA events (median of 7 runs after the first) and
    useful iterations/s; then, on a line of its own, the same solve with
    esc_cap=0 (median of 3 runs);
12. check the fused slice's objectives against the fused port on the
    CPU in float64 on the first 256 instances: |f_gpu - f_cpu| <=
    1e-4 (1 + |f_cpu|);
13. time K1's routes alone: the thread route, the team route and the
    plain version at one cold solve_fused(max_iter=14), float32, at
    B=10240, 1536 and 512 (CUDA events); then the thread route and the
    team route at 16 and 32 lanes at the fused slice's four launches
    and at a cold B=32, float32 and float64, by device time (CUDA events
    behind a leading launch); fail where
    k1_route picks a route whose device time is more than 5% above the
    other's;
14. run the Schur slice, bench.py's bench_schur at its defaults: 8
    coupled QPs of 64 blocks, n=64, m_c=16, built as bench.py builds
    them (numpy seeds 0-7, float32), through SchurIPM(64, 16, float32,
    tol=1e-8, refine=2, max_iter=60).solve_batch, which solves in
    float64 (two_float='auto'); >= 99% converged and K2, K3 and K4
    launched by that run, K2's launches by route; time it with CUDA
    events (median of 5 runs after a warm-up) and report ms per solve,
    ms per iteration and useful iterations/s as bench.py counts them;
15. the same slice in plain float32 at tol 1e-5 (two_float off, so the
    float32 kernels), >= 99% converged;
16. check step 14's objectives against the port on the CPU in float64:
    |f_gpu - f_cpu| <= 1e-6 (1 + |f_cpu|) per instance;
17. hold K2, K3 and K4 against their plain versions at the shapes the
    Schur slice gives them, on its own matrices at the initial iterate,
    float32 within 1e-5 and float64 within 1e-12 as in step 4: the H
    blocks (n=64, B=512; K4 with k=16) and the coupling systems S (n=16,
    B=8); then time the route ldlt_auto takes for the H blocks, both K2
    routes on H and on S (with the check of step 8), K3, both K4 routes
    (each alone held to plain there too) and the plain versions, and
    torch.linalg.cholesky_ex on H (the nearest library call, not the same
    function: LL^T, SPD only); K3's warp route and torch.linalg.ldl_solve
    (K3's and K4's function) on H in float64;
18. hold K6 (whole-reduction cyclic-reduction factor) and K7 (its
    multi-rhs solve) against their plain versions on the card, float32
    and float64, on random SPD block-tridiagonal systems at (N, b, k) =
    (256, 16, 9), (256, 16, 1), (37, 8, 3) and a batch of 32 at (256, 16,
    9), and at CR_EDGES (N = 1, 2, 37; b = 8 and 3; k = 1 and k over one
    group's columns): float64 within a relative difference of 1e-10 on
    the factors and on the solution (each K7 route alone on the plain
    factors, and each K6 route + each K7 route chained), float32 within
    5e-4 absolute on the solution; the K6 routes are the block route and
    the cluster route at each cluster size that fits, the K7 routes the
    block route and the shared route (a block per instance and group of
    columns, the group's right-hand sides in shared memory) at the
    columns k7_route picks and at one group; cr_factor_auto and
    cr_solve_auto taking the routes k6_route and k7_route pick; at (37,
    8, 3) also against torch.linalg.solve of the assembled dense system;
    then every K6 route's device time at each (B, N, b) of
    K6_ROUTE_SHAPES (those systems, small chains and the edges of
    k6_route's rows), float32 and float64, in one torch.profiler trace a
    type: fail where k6_route picks a route more than 5% slower than the
    fastest; then both K7 routes (the shared route at each group width)
    at the arrow slice's N=256, b=16, k = 9 and 1, B = 1 and 32, float32
    and float64, in one trace: fail where k7_route picks a route more
    than 5% slower than the other;
19. run the banded+arrow slice, bench.py's bench_arrow at its defaults:
    n=4096, bandwidth 16, tip 8 (numpy seed 0), float32, tol 1e-5,
    through ArrowQPData.from_dense (block 16, N=256, t=8) and
    ArrowIPM.for_data(...).solve on the card, which must converge with
    one K6 (on the route k6_route picks, the cluster route) and two K7
    launches per iteration (on the route k7_route picks, the shared
    route); time it with CUDA events
    (median of 5 runs after a warm-up) and report ms per solve and per
    iteration, launches and host syncs; the objective against the port
    on the CPU in float64 with method='cr': |f_gpu - f_cpu| <= 1e-4
    (1 + |f_cpu|);
20. the same structure as a batch: solve_batch on 32 instances (the same
    Q, c drawn from numpy seeds 1..32), all 32 converged, timed and held
    to the CPU float64 port in the same way;
21. time K6 and K7 (k=9 and k=1; K7's block and shared routes) against
    their plain versions and
    against the per-level library composition (method='cr') on the
    slice's own condensed matrices at the initial iterate, one instance
    and the batch of 32, float32 and float64, and hold them to the plain
    versions there too; each K6 route by CUDA events behind a leading
    launch; fail where k6_route picks a route more than 5% slower than
    the best;
22. hold K5 (fused LDL^T factor + multi-rhs solve, one launch) against
    its plain version on the card, float32 within 1e-5 and float64
    within 1e-12 on L, D and X as in step 4, at (matrices, order,
    right-hand sides) = (105, 64, 40), (28, 16, 48), (16, 16, 64) (the
    three levels of the nd slice's plan), (10240, 32, 2) (bench.py's
    bench_kkt point), (3, 37, 5), with an exactly-zero pivot, and at
    (1, 328, 1), over K5's shared-memory cap, where the wrapper must run
    ldlt_auto then solve_ldlt_matrix_auto by the route ldlt_route picks
    (the blocked LDL^T, its three panels on K2), all through the
    wrapper, which must take the route k5_route picks; the plain X also against torch.linalg.solve(A, R)
    (float32 1e-3, float64 1e-9); then each route of K5 alone (the block
    route, a thread block per matrix; the warp route, a warp per matrix
    of order <= 32; the split route, a block per matrix of order <= 64,
    the factor on one segment of lanes and the right-hand sides split
    across the block's segments) at those shapes, at the batch of 8's
    levels (840, 64, 40), (224, 16, 48), (128, 16, 64), at the levels of
    step 44's side-96 plan (K5_SWEEP_LEVELS: (180, 64, 40), (64, 16, 56),
    (28, 24, 72), (16, 24, 96), (6, 40, 96)) and at K5_EDGES
    (n=1, odd orders, batches that fill no whole block, n = 17, 33, 63,
    64, k = 1 and k not a multiple of the split route's 4 columns a
    group), L exactly unit-lower; and every route on an exactly-zero
    pivot at (28, 16, 48), (10240, 32, 2) and (3, 37, 5);
23. build the nd slice's dissection plan (host) and hold
    nd_solve(nd_factor(K)) on the slice's own KKT matrix at the initial
    iterate, float64 on the card, against torch.linalg.solve within
    1e-9, with the signed merged top and with the generic top (order
    328: the blocked LDL^T that ldlt_route picks, its panels on K2);
24. run the nested-dissection slice, bench.py's bench_nd at its
    defaults: grid_qp(side=64) (n=4096, 5-point-stencil Hessian, bounds
    +-1, numpy seed 0), float32, tol 1e-5, through
    CompiledIPM(kernel="nd", nd_leaf=64, nd_fallback=False).solve on the
    default device, which must converge with three K5 and six K3
    launches per iteration and no K2 / K4; a second solve must give
    bit-identical x; time it with CUDA events (median of 5 runs after
    that warm-up) and report ms per solve and per iteration, launches,
    K5's launches by route (which must add up to its launches; the split
    route must have run), and host syncs;
25. the same structure as a batch: solve_batch on
    grid_qp(side=64, batch=8) (K5 at 840 blocks per launch), all
    converged, bit-identical twice, timed, useful iterations/s;
26. the objectives of step 24 and of step 25's first two instances
    against the port on the CPU in float64 (the library composition
    there): |f_gpu - f_cpu| <= 1e-4 (1 + |f_cpu|);
27. time each K5 route at every shape of step 22's paths (the three nd
    levels, one instance and the batch of 8, step 44's side-96
    levels, (10240, 32, 2) and
    (3, 37, 5) in float32; (105, 64, 40) and (10240, 32, 2) also in
    float64) against its plain version, against K2 followed by K4 (the
    wrappers, their layout transposes included) and against
    torch.linalg.solve (the one PyTorch call that gives the same X; it
    returns no factors), by CUDA events and by device time (the routes of
    a shape in one trace; torch.linalg.solve's at the nd levels too);
    fail where k5_route picks a route whose device time is more than 5%
    above the fastest;
28. build the measurement kernels: csrc/roofline.cu (T1 FMA chains, T2a /
    T2b in-kernel factor / solve repetitions, each on both routes) and the
    five generated prefixes of one fused iteration (T3) on each of its
    four routes, each prefix a source of its own: thread and team at the
    fused slice, block at the wide slice (portfolio aug 129), wide at
    portfolio aug 257 (chip_phases.POINTS); all nvcc processes run beside
    those of steps 3 and 9, and each build's time and ptxas' registers,
    stack frame and spills are reported, with the team prefixes' shared
    bytes a team and teams per SM and the block and wide prefixes' own
    shape queries (threads, workspace, shared bytes, blocks per SM);
29. hold T1 against its plain version at (64, 512) and at (256, 512),
    the shape of its kernels-line entry, reps 64, chains 4 / 8 / 16
    (float32 within 1e-5: nvcc contracts acc * a + x to one FMA; float64
    within 1e-12), then sweep it over threads per block, blocks per SM
    and chains: the card's measured multiply-add ceilings, float32 and
    float64, which must not exceed the data sheet's 67 / 33.5 TFLOP/s,
    with the SM clock and power draw beside them; then hold it again at
    what the sweep launched: every block size at 1024 rounds and each
    winning configuration at its own size, block size, chains and rounds
    (float32 within 1e-2, float64 within 1e-10: thousands of contracted
    rounds drift, a miscounted chain or round is off by factors);
30. hold T2a and T2b, each on the thread and the team route, against
    their plain versions at order 24, B=10240, float32 (1e-5) and float64
    (1e-12), on both outputs (the reference kernel's sum and the sink
    that keeps the whole factorisation or solve alive), then the time of
    one factorisation and of one solve inside K1's per-thread storage and
    on the team route (team_ldlt and team_ldlt_solve, K and D in shared
    memory), as the slope between two in-kernel repetition counts, at
    B=10240 and B=512; their rates against step 29's ceiling; the team
    routes' bytes a team and teams per SM beside K1 team's; the SASS of
    T2b team's repetition loop, which must load the factor from shared
    memory; one factor + two solves against K1's measured time per
    iteration on each route (the team route's share must not pass 100%);
    T2a's thread-route time per factorisation at B=10240 must lie within
    3x of K2's at the same shape (step 8): the work was not optimised
    away; the team routes' slopes at B=10240 must not lie below their
    bounds, and T2a team's is printed beside K2's block route at (24,
    10240); torch.linalg.ldl_solve (trivial pivots) on T2b's factor and
    right-hand sides, the library call for its solves;
31. hold each T3 prefix of both routes against its plain version at
    B=10240 and B=512 (float64 within 1e-10, float32 within 1e-4, both
    outputs, metrics nudge off and on), then for each route the time of
    each prefix per in-kernel repetition, the differences (the phases'
    costs), one whole launch, the slope's bound, and ptxas' figures per
    prefix, at B=10240 and B=512, float32 and float64; the float32 prefix
    times at B=10240 must not decrease, and no slope at B=10240 may lie
    below its bound; beside them one solve_fused(max_iter=1) of K1 on its
    thread and its team route and one CompiledIPM.step; then T3 on K1's
    block route (phase() with no route: the route K1 takes) at the wide
    slice's point, portfolio aug 129, B=4096 and B=512, float32 (W=4) and
    float64 (W=8), every prefix against its plain version in the same
    limits, and on K1's wide route at portfolio aug 257 float64, B=256,
    prefixes 2 and 4; launches by route counted over those runs (only the
    block and the wide route may launch) and one launch of prefix 4 on
    each timed against its plain version;
32. the library's matrix-product rates (torch.matmul, 1024^2 float32
    with TF32 off, 2048^2 bfloat16), a yardstick;
33. bench_torch.py's modes `steps` (10 batched steps after the
    convergence gate) and `kkt` (K5 at (10240, 32, 2), graded by the
    dense-LDL^T flop model) through its own functions, launches counted
    by route (the kkt mode is the K5 warp route's path); its other modes
    are steps 11, 6, 14, 19, 24 and 37-40, which build their solvers and
    data through bench_torch.py too.
34. hold K1's team route (16 and 32 lanes) against its plain version at
    the fused slice's four launches, recorded from its
    solve_fused_compact(esc_cap=32): B=10240 cold max_iter=14 (8 at tol
    1e-5), 1536 warm, the 10240 warm mop-up and the 512 tile cold with
    gondzio=2 and max_iter=30, by step 10's limits (float64 at tol 1e-6,
    float32 at 1e-6 and at 1e-5); it runs after step 10.
35. hold the panel-blocked LDL^T (ops/blocked_ldlt.py: its diagonal
    panels on K2's block route, block columns and trailing updates by the
    library) and its solve against the plain column LDL^T and the plain
    sweeps on the card at (B, n) = (3, 352) in both types, (64, 352)
    float32, (1, 328) float64 and (2, 200) with panels of 64 (an uneven
    last panel) in both types: L, D and x within 1e-10 in float64 and
    1e-4 in float32 (step 4's measure), one K2 block-route launch a
    panel, and an exactly-zero pivot in the second panel put on the
    floor in both;
36. time every LDL^T route (K2's SoA route, up to order 352, and its
    block route where it fits, each with K3; the blocked path with its
    library solve), a factor and one solve by CUDA events, at bench_aug's
    (64, 352) float32, the nd generic top (1, 328) float64 and
    bench_normal's H (16, 1024) float32, beside torch.linalg.cholesky_ex
    on SPD matrices of the same shape (the nearest library call): fail
    where ldlt_route picks a route more than 5% slower than the fastest;
    then K2's block route at the aug slice's panel (64, 128) float32
    against its plain version (1e-5), timed for the kernels line;
37. bench_torch.py's aug mode (64 QPs, n=256, m_ineq=64, m_eq=32,
    aug_dim 352, float32, tol 1e-5 scaled, refine=2, gondzio=2): 'blockg'
    and 'auto' (the dense LDL^T, the blocked route at this order), each
    >= 99% converged, the objectives of the first 8 instances against the
    CPU float64 port within 1e-4 (1 + |f|), its JSON line; then one 'auto'
    solve with the launch counts set to 0 just before and read just after
    (K2's panel launches on the block route);
38. bench_torch.py's normal mode (16 QPs, n=1024, m=128, float32):
    'blockg', 'block' and 'normal', each >= 99% converged, the objectives
    of the first 4 against the CPU float64 port, K2 launched (the
    'normal' mode's H^-1), its JSON line;
39. equality_qp(batch=64) (an indefinite augmented system), float64,
    through 'auto' (= 'regldlt', K2 and K3 launched) and 'lu', all
    converged, x within 1e-6 of each other;
40. bench_torch.py's arrow --dense and nd --dense (the structured step
    against the dense CompiledIPM step, 'blockg' at n=4096, ms per step
    by the slope of two step counts) and kkt --large (the signed block
    Cholesky with two solves at orders 1024 and 4096), their JSON lines.
41. bench_torch.py's mpc mode, bench.py's bench_mpc at its defaults: 256
    random stable tracking MPC instances (random_mpc seed 0, horizon
    T=32, ns=8 states, nu=4 controls, float32) through RiccatiIPM(tol=1e-5,
    max_iter=40).solve_batch on the card, >= 95% converged (the share
    printed); each instance's objective against the port on the CPU in
    float64 at tol 1e-8 within 1e-4 (1 + |f_cpu|), and u and x (unique:
    each instance is strictly convex) within 1e-3 (1 + |v_cpu|) on the
    instances both converge; the wall by CUDA
    events (median and spread of 5 warm calls), the summed iterations,
    the host syncs of one solve, launches per iteration and the busy
    share (device busy time over the median wall) under torch.profiler,
    and its JSON line.  No kernel of the kernels line runs here: the
    Riccati recursion is batched library calls, as it was XLA code in
    the reference;
42. RiccatiIPM in float64 at tol 1e-8 on the card against the port on
    the CPU: one solve of random_mpc() (T=16, ns=4, nu=2, seed 0), then
    solve_batch of random_mpc(batch=8, state_bounds=True) with gondzio=2:
    converged and diverged equal on every instance, and on every
    instance the CPU brings to convergence iterations equal and u, x, y
    within 1e-8 (1 + |v_cpu|); the iterations of the instances that
    diverge (infeasible state bounds) are printed, not held: the
    iteration at which a divergent iterate overflows follows rounding;
43. the condensed QP through the dense engine: condense() of that batch
    of 8 (state bounds as general inequality rows) through
    CompiledIPM(Settings(), n=T*nu=32, m_ineq=T*ns=64) in float64 on the
    card, aug_dim 96, where 'auto' takes 'ldlt' (K2 on the route k2_route
    picks, K3 on the route k3_route picks, both counted by route from
    zero just before the solve and printed); the same instances converge
    as in RiccatiIPM's solve, and on those u within 1e-6 of RiccatiIPM's
    and the objectives equal within 1e-6 (1 + |f|) up to the eliminated
    states' constant (the check of tests/test_mpc.py).
44. the nd auto-fallback's cost model on the card:
    chip_nd_crossover.py's measurement at grid sides 32, 64 and 96 and at
    the one-level plans of a dense pattern of order 196, 400 and 1024 (nd
    against the dense 'auto' path, ms per step by the slope of two step
    counts, median of three interleaved rounds) with the decisions of the
    port's default constants (ops/ndiss.py: the card's fit, CARD_FIT) and
    of the JAX package's; at grid sides 32 and 64 and the one-level 400
    and 1024, whose readings lie well outside the timing noise, it fails
    where the default keeps nd at a measured speedup below 0.87 or drops
    it above 1.2; grid side 96 and the one-level 196 lie inside or near
    that band: their ratios are printed, and side 96's plan's levels must
    be the shapes K5 and K3 are held at in steps 4, 8, 22 and 27; then
    bench_nd's QP (side 64) through CompiledIPM(kernel="nd") with its
    default fallback, launch counts set to 0 just before and read just
    after: it must fall back to 'blockg' (no K5 launch), converge, and
    give the objective within 1e-4 (1 + |f|) of step 24's nd solve.

45. hold K1's wide route (csrc/fused_wide.cuh: one warp an instance, its
    TeamLayout region in a device-memory workspace) against its plain
    version at WIDE_SHAPES: portfolio(n_assets=128) (aug 129) at B=1024,
    the default formulation at n=128, m_ineq=64 (aug 192) at B=512 and
    portfolio(n_assets=256) (aug 257) at B=256, each a cold
    solve_fused(max_iter=14), a warm resume and a cold gondzio=2 solve:
    float64 at tol 1e-6 iterations equal and x within 1e-10; float32 at
    the shape's first decade above its float32 floor (1e-5 on the
    portfolios, 1e-4 at aug 192) iterations equal on >= 99% and x within
    1e-4 on instances converged in both at equal iterations; float32 at
    tol 1e-6, at or below those floors, printed only (the summation order
    decides there on which iteration some instances cross:
    wide_contraction_spread); two launches of the cold solve
    bit-identical; then K1's block route (csrc/fused_wide_block.cuh: a
    thread block of W warps an instance, its factor and work vectors in
    shared memory) wherever its block fits (not float64 at aug 225 and
    257), at
    the W that K1_BLOCK_RULE gives (4 where it keeps the wide route),
    under the same gates, two cold launches bit-identical, the cold
    solve bit-equal at every W of BLOCK_WARPS; as launched, against the
    wide route as launched at the gated tolerances: iterations equal on
    every instance and x within WIDE_ROUTES_X (1e-13 in float64, 1e-5 in
    float32); the design's gate: the two routes' check builds (each
    generated function compiled apart, APART) bit-equal (x, variables,
    iterations, residual, gap, mu) at every launch and, on the cold
    solve, at every W; k1_route must pick the
    team route at the fused slice's launches and the block route only
    where it fits; at RULE_SHAPES (aug 161 and 225) the block route held
    to the wide route as launched only; the cold launch timed in both
    types on the wide route and on the block route at each W against the
    plain version (WIDE_SHAPES) and its bound, and k1_route's pick within
    5% of the fastest;
46. the wide slice: FusedBatchedIPM(portfolio settings, n=128, m_eq=1,
    float32, tol=1e-6).solve_fused_compact() (the default schedule and
    esc_cap=32) on portfolio(n_assets=128, batch=4096, seed=0), launch
    counts set to 0 just before and read just after: >= 99.9% converged,
    finite x, K1 launched on the route k1_route picks and on no other,
    objectives within 1e-4 (1 + |f|) of the port's CPU float64 solve on
    the first 64 instances, the wall by CUDA events (median of 5 after the
    counted run) beside the wide route's (WIDE_ROUTE_SLICE_MS), launches
    by route and host syncs; then the same solve with
    every instance a straggler after three fused iterations, whose
    float64 escalation and Gondzio tail must factor by the panel-blocked
    LDL^T on K2;
47. the tf slice: bench_torch.py's tf mode, the first 2048 QPs of step
    6's data (float32) through CompiledIPM(tol=1e-8, two_float=True,
    max_iter=30).solve_batch_compact, whose iteration runs in float64,
    launch counts set to 0 just before and read just after: >= 99%
    converged, finite float32 x, K2 and K3 launched in float64 only (K2
    on its block route, K3 on its warp route; no float32 launch, no
    other kernel); the same QPs in plain float32 at tol 1e-8 (no
    escalation) converge on fewer than half; the first 256 against the
    port on the CPU in float64 at tol 1e-8: converged equal, the float64
    iteration's x within 1e-8 and objectives within 1e-8 (1 + |f|), the
    float32 result within 1e-8 beyond its rounding; then bench_tf's wall
    (median of 3 after a warm-up, spread), useful iterations/s, host
    syncs, launches by route and type, and its JSON line;
48. the other precision options on the floor table's class (48 QPs of
    tests/test_precision_floor.py, n=16, m=8, seed 0, float32 data):
    refine=2 with hybrid_refine at tol 1e-6 converges all, df_residuals
    at 1e-6 at least the 47 the reference converges (both stall on
    instance 21), none diverged; two_float on instances 0-2 by
    init_state and step: residual and gap below 1e-8 and x within 1e-9
    of the float64 solve on the card;
49. the sp path at one rank: bench_schur's coupled QP of seed 0 (64
    blocks of n=64, 16 coupling rows, float32 data) through
    SchurIPM(mesh=make_mesh(), tol=1e-8, refine=2).solve_sharded
    (two_float: the iteration in float64), launch counts set to 0 just
    before and read just after: converged, x within 1e-8 and the
    objective within 1e-10 relative of SchurIPM.solve on the card; K2 on
    its block route, K3 on its warp route and K4 on its warp route, all
    in float64, each launched, launches by shape; its wall (CUDA events,
    median of 5); then K2, K3 and K4 at its shapes timed against their
    plain versions and library calls;
50. the same solve at two ranks: two processes spawned and joined in one
    gloo group, both on cuda:0, each factoring 32 blocks: every rank
    returns the same x, rank 0's x and objective within step 49's limits
    of SchurIPM.solve; each rank's launches by shape (K2 (64, 32) and
    (16, 1), K4 (64, 16, 32), K3 (64, 32) and (16, 1), all float64),
    host syncs (the loop's and the collectives staged through the host)
    and wall; a rank that fails fails the step;
51. bench_torch.py --mode sharded at one rank (in this process, launch
    counts set to 0 just before and read just after: K2 and K3 launched)
    and at two (two processes started with WORLD_SIZE=2, RANK,
    MASTER_ADDR, MASTER_PORT, both on cuda:0, gloo): each report's
    summary and JSON line, both ranks printing the same value;
52. dryrun_multichip(2): the dp step, the sharded Schur solve and its
    two_float variant at two ranks on cuda:0, each within 1e-5 of its
    local run (run after step 55, with step 56's checks);
53. the tp factor at one rank on the card: tests/test_sharded_ldlt.py's
    slow test's system kkt(3584, 512, seed=3, scale=2.0) of order 4096
    row-sharded over a one-rank ("tp",) mesh, sharded_ldlt at the default
    panel (128) and one sharded_ldlt_solve, launch counts set to 0 just
    before and read just after: 32 K2 launches (block route, one a
    diagonal panel) and no other kernel of the port; float64 max |L D L^T
    - K| and max |K x - b| below 1e-9 (the slow test's bar), float32
    held to the backward error bound n u (u = 2^-24): max |L D L^T -
    K| / (|L| |D| |L^T|) elementwise and the solve's max |K x - b| /
    max(|K| |x| + |b|) (both printed in float64 too); L and D
    against ldlt_blocked on the card (float64 1e-11, float32 1e-4); the
    wall of one factor, one solve and ldlt_blocked (CUDA events, median
    of 3), K2's device ms a factor from a torch.profiler trace and its
    share of the wall and of the busy time; then K2's block route at the
    tp panel (the first diagonal block, n=128, B=1, float64) against its
    plain version (1e-12), its device ms, events ms, plain ms, bound and
    torch.linalg.cholesky_ex's ms;
54. the same float64 factor and solve at two ranks: two processes
    spawned and joined in one gloo group, both on cuda:0 (the same
    processes then run step 55's two-rank solve), each factoring
    2048 rows: each rank's rows of L within 1e-10 of ldlt_blocked's (which
    step 53 holds the one-rank factor to), D and x within 1e-10 of step
    53's and equal on both ranks, 32 K2 launches a rank, 96 collectives
    staged through the host (a broadcast a panel in the factor, a
    broadcast and a psum a panel in the solve); each rank's wall (CUDA
    events, median of 3), the bytes staged and the host clock of one
    staged panel broadcast (1, 128, 4096) float64;
55. tests/test_sharded_ipm.py's slow test's QP (box QP of n = 4096,
    float32, tol 1e-4, panel 128, max_iter 40, scale_tol) through
    CompiledIPM(kernel='sharded').solve at one rank and at two (step
    54's spawned ranks, gloo, cuda:0), against kernel='jnp' on the card,
    launch counts set
    to 0 just before and read just after each solve: converged,
    iterations equal to 'jnp''s, x within 5e-3, 32 K2 launches an
    iteration and, at one rank, no other kernel of the port; x the same
    bits on both ranks; the one-rank wall (median of 3), ms and launches
    an iteration and busy share (torch.profiler); each rank's wall,
    collectives and bytes staged an iteration;
56. the dry run's tp checks in step 52's run: tp-ldlt (order 16, panel 4,
    against ldlt_solve) and tp-ipm (the box QP of n=8, panel 2, against
    the default kernel), each within 1e-5.
57. the CLI (ipmzoo_tpu_torch.frontend.cli) in this process: main(["-e",
    "-n"]) on the default device (the card), launch counts set to 0 just
    before and read just after, against main(["-e", "-n", "--device",
    "cpu"]): the -e output equal, each handling converged in the CPU's
    iterations (7 / 12 / 12), x within 1e-8, residual and gap below 1e-8,
    K2 and K3 launched; launches by route and the wall printed;
58. the native host tier (ipmzoo_tpu_torch.native: g++ at first use into
    the build directory, its time and flags printed) beside K2/K3 on the
    card in float64: ldlt_factor / ldlt_solve against ldlt_auto /
    solve_ldlt_auto at tests/test_native.py's quasidefinite shapes 4+2,
    16+9 and 40+23 within 1e-9, the pivot floor on a zero 3x3 (D = 1e-8
    from both), the regularised LDL^T recipe (three refinement sweeps)
    on K2/K3 against bunch_kaufman_solve at (6, 2), (20, 8), (48, 17) and
    a batch of 8 x (12, 5) within 1e-9; then printed, no gate:
    ldlt_factor_solve_batch at (10240, 24) float64 on the host against
    K2 + K3 at (24, 10240) float64 by CUDA events (median of 5 each);
59. the four example twins (examples/torch_*.py) in this process at
    their defaults on the default device, launch counts set to 0 just
    before and read just after each: their printed dicts, walls and
    launches by route; portfolio (1024 x 32, float64, tol 1e-8) 100%
    converged, budget residual <= 1e-8, K2 and K3 launched; grid (side
    24, leaf 32, float64) both solves converged, the path taken printed,
    max |x_nd - x_dense| <= 1e-6 (at its defaults the card's cost model
    and the dense auto rule both take 'blockg', library Cholesky, so
    the grid twin runs again with nd_fallback=False, which must launch
    a hand-written kernel: K5 and K3); arrow (n=512, bandwidth 8, tip 4,
    float32, tol 1e-5) both converged, max |x_s - x_d| <= 1e-3, K6 and
    K7 launched; Schur (64 blocks x 16, m_c = 4, float32 data, tol 1e-8:
    two_float; world 1) converged, coupling feasibility <= 1e-6, K2, K3
    and K4 launched.

Steps 29-31 are the measurement path: every launch count of T1-T3 in the
kernels line comes from their timed sweeps, counted apart from the
launches that compare a kernel with its plain version.

Every kernel's entry in the kernels line carries its bound: the larger
of the bytes it must move (inputs read once, outputs written once) over
3.35 TB/s and its operations over the card's peak for the type (67
TFLOP/s float32, half that in float64), at the timed shape.

Any failed check raises, so the exit code is nonzero.  The line before
the last is a JSON object describing the kernels; the last line is the
JSON object {"ok": true, "device": {...}}.
"""

import json
import sys
import time

N_AUG, B_SLICE = 24, 10240
SCHEDULE_BATCHES = (10240, 2560, 320)
SOURCE = "ipmzoo_tpu_torch/csrc/ldlt.cu"
#: bench_schur's defaults: instances, blocks, block size, coupling rows
SCHUR_I, SCHUR_BLOCKS, SCHUR_N, SCHUR_MC = 8, 64, 64, 16
#: steps 49-50: bench_schur's coupled QP of seed 0 with its blocks over
#: one rank and over SP_WORLD ranks sharing the card; the sp solve's
#: refinement sweeps
SP_WORLD, SP_REFINE = 2, 2
#: K4's shapes: the Schur slice's H blocks, the sp solve's at one and two
#: ranks, the kkt point and an odd shape
K4_SHAPES = ((SCHUR_N, SCHUR_MC, SCHUR_I * SCHUR_BLOCKS),
             (SCHUR_N, SCHUR_MC, SCHUR_BLOCKS),
             (SCHUR_N, SCHUR_MC, SCHUR_BLOCKS // SP_WORLD), (24, 2, 10240),
             (13, 5, 1000))
#: more (order, right-hand sides, systems) at which both K4 routes are held
#: to plain (step 4) and timed (step 8), in both types: n = 1 and the
#: orders around the warp route's smallest (6), odd orders, batches that
#: fill no tile, k = 1, k over a segment's 4 columns and over a block's
#: chunk of 16, the warp route's cap (96) and one past it
K4_EDGES = ((1, 1, 5), (5, 2, 9), (6, 2, 9), (13, 5, 7), (37, 9, 77),
            (64, 40, 105), (96, 5, 3), (97, 3, 2))
K1_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
             "ipmzoo_tpu_torch/models/codegen_soa.py + "
             "ipmzoo_tpu_torch/models/fused_source.py")
REPLACES = {"ldlt": "ipmzoo_tpu/ops/pallas_ldlt.py:79",
            "solve_ldlt": "ipmzoo_tpu/ops/pallas_ldlt.py:130",
            "solve_ldlt_matrix": "ipmzoo_tpu/ops/pallas_ldlt.py:185",
            "fused": "ipmzoo_tpu/models/fused.py:432",
            "fused team": "ipmzoo_tpu/models/fused.py:432",
            "fused wide": "ipmzoo_tpu/models/fused.py:432",
            "fused block": "ipmzoo_tpu/models/fused.py:432",
            "solve_ldlt_matrix warp": "ipmzoo_tpu/ops/pallas_ldlt.py:185",
            "ldlt_solve_matrix": "ipmzoo_tpu/ops/pallas_ldlt.py:226",
            "ldlt_solve_matrix split": "ipmzoo_tpu/ops/pallas_ldlt.py:226",
            "cr_factor": "ipmzoo_tpu/ops/cr_pallas.py:182",
            "cr_factor cluster": "ipmzoo_tpu/ops/cr_pallas.py:182",
            "cr_solve": "ipmzoo_tpu/ops/cr_pallas.py:281",
            "cr_solve shared": "ipmzoo_tpu/ops/cr_pallas.py:281",
            "fma_chains": "tools/roofline.py:41",
            "factor_reps": "tools/roofline.py:111",
            "factor_reps team": "tools/roofline.py:111",
            "solve_reps": "tools/roofline.py:124",
            "solve_reps team": "tools/roofline.py:124",
            "phase": "tools/fused_phases.py:44",
            "phase team": "tools/fused_phases.py:44",
            "phase block": "tools/fused_phases.py:44",
            "phase wide": "tools/fused_phases.py:44"}
#: T1's shape in the kernels line: the reference sweep's largest buffer
T1_SHAPE, T1_CHAINS, T1_REPS = (256, 512), 16, 64
#: T2's repetitions in the kernels line: the slope's upper count
T2_REPS = 8
T3_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
             "ipmzoo_tpu_torch/csrc/fused_phases.cuh + "
             "ipmzoo_tpu_torch/models/codegen_soa.py + "
             "ipmzoo_tpu_torch/models/fused_source.py + "
             "ipmzoo_tpu_torch/models/fused_phases.py")
T3_TEAM_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_team.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_phases_team.cuh + "
                  "ipmzoo_tpu_torch/models/codegen_team.py + "
                  "ipmzoo_tpu_torch/models/fused_source.py + "
                  "ipmzoo_tpu_torch/models/fused_phases.py")
T3_BLOCK_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
                   "ipmzoo_tpu_torch/csrc/fused_team.cuh + "
                   "ipmzoo_tpu_torch/csrc/fused_wide_block.cuh + "
                   "ipmzoo_tpu_torch/csrc/fused_phases_team.cuh + "
                   "ipmzoo_tpu_torch/csrc/fused_phases_block.cuh + "
                   "ipmzoo_tpu_torch/models/codegen_team.py + "
                   "ipmzoo_tpu_torch/models/fused_source.py + "
                   "ipmzoo_tpu_torch/models/fused_phases.py")
T3_WIDE_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_team.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_wide.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_phases_team.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_phases_wide.cuh + "
                  "ipmzoo_tpu_torch/models/codegen_team.py + "
                  "ipmzoo_tpu_torch/models/fused_source.py + "
                  "ipmzoo_tpu_torch/models/fused_phases.py")
#: the fused slice's K1 batches: the cold full batch and its warm mop-up,
#: the 1/8 stage (round_up(10240 // 8, 512)) and the Gondzio tile
K1_BATCHES = (10240, 1536, 512)
K1_TEAM_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_team.cuh + "
                  "ipmzoo_tpu_torch/models/codegen_soa.py + "
                  "ipmzoo_tpu_torch/models/codegen_team.py + "
                  "ipmzoo_tpu_torch/models/fused_source.py")
#: the team sizes timed against each other (step 13)
K1_LANES = (16, 32)
K1_WIDE_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_team.cuh + "
                  "ipmzoo_tpu_torch/csrc/fused_wide.cuh + "
                  "ipmzoo_tpu_torch/models/codegen_team.py + "
                  "ipmzoo_tpu_torch/models/fused_source.py")
K1_BLOCK_SOURCE = ("ipmzoo_tpu_torch/csrc/fused_ipm.cuh + "
                   "ipmzoo_tpu_torch/csrc/fused_team.cuh + "
                   "ipmzoo_tpu_torch/csrc/fused_wide_block.cuh + "
                   "ipmzoo_tpu_torch/models/codegen_team.py + "
                   "ipmzoo_tpu_torch/models/fused_source.py")
#: the block route's warps a block, each held and timed at step 45
BLOCK_WARPS = (2, 4, 8)
#: step 45's shapes of K1's wide route, (n, m_ineq, m_eq, batch, float32
#: tolerance): m_eq = 1 is portfolio(n_assets=n) (aug n + 1), m_eq = 0 the
#: default formulation on make_batch's QPs (aug n + m_ineq).  The float32
#: tolerance is the shape's first decade above its float32 floor, where
#: step 10's float32 limits hold: at or below it the residual stalls near
#: the tolerance (~1e-6 on the portfolios, ~1.2e-5 at aug 192) and the
#: summation order decides on which iteration an instance crosses, the
#: plain version's on the card against its own on the CPU too
#: (wide_contraction_spread)
WIDE_SHAPES = ((128, 0, 1, 1024, 1e-5), (128, 64, 0, 512, 1e-4),
               (256, 0, 1, 256, 1e-5))
#: step 45's rows that time K1_BLOCK_RULE between WIDE_SHAPES' orders, as
#: WIDE_SHAPES' rows: portfolio(n_assets=160) (aug 161) and (224) (aug
#: 225).  Their block route is held to the wide route as launched
#: (WIDE_ROUTES_X), not to the plain version: at aug 161, B=512, float32
#: tol 1e-5, gondzio=2 the plain version parts from the wide route by
#: 2.6e-4 of the largest |x| at equal iterations, over step 45's 1e-4,
#: and on the CPU the plain version in float32 parts there from float64
#: by 1.2e-3 on one instance solved in a batch of 512 and by 4e-7 when
#: it is solved in a batch of 8 (plain_batch_spread; PERF.md section 6)
RULE_SHAPES = ((160, 0, 1, 512, 1e-5), (224, 0, 1, 256, 1e-5))


def wide_rows():
    """WIDE_SHAPES and RULE_SHAPES by augmented order."""
    return sorted(WIDE_SHAPES + RULE_SHAPES, key=lambda s: s[0] + s[1] + s[2])
#: step 45's gate on the block route as launched against the wide route
#: as launched, by type: iterations equal on every instance and the
#: largest |x - x_wide| within this.  The two builds part only where nvcc
#: contracts a multiply-add in one and not in the other (APART); on an
#: H100 that moved x by at most 2.1e-15 in float64 and 4.1e-6 in float32
#: at the gated tolerances of WIDE_SHAPES and aug 161 (PERF.md section 6)
WIDE_ROUTES_X = {"float64": 1e-13, "float32": 1e-5}
#: what a check build of the wide and block routes prints before the
#: generated ``struct Form``: each of its functions compiled apart.  nvcc
#: contracts a * b + c into an FMA wherever it sees both, across the
#: generated code's temporaries too, and what it sees depends on what was
#: inlined into what and on where the arrays live: the two routes as
#: launched (everything inlined) part in the last bits by how the compiler
#: contracted, not by what they compute.  Compiled apart, each generated
#: function is the same machine code in both kernels, so their check
#: builds, which differ in the factor (team_ldlt, block_ldlt: the same
#: arithmetic) and in where the work arrays live, must give the same bits
#: (step 45).  The calls cost both routes much of their speed on the card
#: (PERF.md section 6), so the routes launch inlined.
APART = ["// check build: each generated function compiled apart",
         "#ifdef __CUDACC__", "#undef IPM_FN",
         "#define IPM_FN __host__ __device__ __noinline__", "#endif"]


def apart(text):
    """The check build of a wide or block route's ``text``: APART's lines
    before its generated part."""
    gen = '#line 1 "generated"'
    return text.replace(gen, "\n".join(APART + [gen]), 1)
#: step 46's batch of portfolio(n_assets=128, seed=0)
WIDE_SLICE_B = 4096
CR_SOURCE = "ipmzoo_tpu_torch/csrc/cr.cu"
ROOFLINE_SOURCE = "ipmzoo_tpu_torch/csrc/roofline.cu"
#: bench_arrow's defaults: variables, half-bandwidth, arrow tip; and the
#: batch line's instances
ARROW_N, ARROW_BW, ARROW_TIP, ARROW_BATCH = 4096, 16, 8, 32
#: (batch, blocks, block size, right-hand sides) of step 18
CR_SHAPES = ((1, 256, 16, 9), (1, 256, 16, 1), (1, 37, 8, 3),
             (ARROW_BATCH, 256, 16, 9))
#: more (batch, blocks, block size, right-hand sides) of step 18: N = 1,
#: 2 and 37, b = 8 and 3, k = 1 and k over one group's columns (40
#: instances: groups of 3)
CR_EDGES = ((1, 1, 16, 1), (1, 2, 8, 3), (2, 37, 3, 5), (1, 37, 8, 1),
            (40, 37, 8, 9))
#: (batch, right-hand sides) of step 18's K7 route timing, at the arrow
#: slice's N and b: its two solves, one instance and the batch
K7_ROUTE_SHAPES = ((1, ARROW_TIP + 1), (1, 1), (ARROW_BATCH, ARROW_TIP + 1),
                   (ARROW_BATCH, 1))
#: (B, N, b) of step 18's K6 route timing: CR_SHAPES' systems and
#: small N, where a level holds few pivots for the cluster's blocks
K6_ROUTE_SHAPES = ((1, 256, 16), (1, 37, 8), (ARROW_BATCH, 256, 16),
                   (1, 1, 16), (1, 2, 8), (1, 4, 16), (4, 8, 8),
                   (16, 64, 16), (24, 256, 16), (1, 128, 8))
#: bench_nd's defaults: grid side (n = side^2), dissection leaf; and the
#: batch line's instances
ND_SIDE, ND_LEAF, ND_BATCH = 64, 64, 8
#: (matrices, order, right-hand sides) of step 22: the three levels of the
#: nd slice's plan, bench_kkt's fused factor + 2-rhs point, an odd shape
K5_LEVEL, K5_KKT = (105, 64, 40), (10240, 32, 2)
#: the nd levels of the batch of 8 (step 25)
K5_BATCH_LEVELS = ((840, 64, 40), (224, 16, 48), (128, 16, 64))
#: step 44's sweep: (side, one level) of its rows, a grid's plan or the
#: one-level plan of a dense pattern of the same order; those whose
#: decision it gates (the readings of grid side 96 spread across the band,
#: 0.833-1.466, and those of the one-level n = 196 reach 0.940); the side
#: of its levels below, and the levels of that side's plan under K5 (the
#: signed top, the last level, takes two Cholesky stages)
ND_SWEEP = ((32, False), (64, False), (96, False), (14, True), (20, True),
            (32, True))
ND_GATED = ((32, False), (64, False), (20, True), (32, True))
ND_SWEEP_SIDE = 96
K5_SWEEP_LEVELS = ((180, 64, 40), (64, 16, 56), (28, 24, 72), (16, 24, 96),
                   (6, 40, 96))
K5_SHAPES = (K5_LEVEL, (28, 16, 48), (16, 16, 64), K5_KKT, (3, 37, 5)) + \
    K5_BATCH_LEVELS + K5_SWEEP_LEVELS
#: the nd levels: one instance, the batch of 8 and step 44's side 96
K5_ND_LEVELS = K5_SHAPES[:3] + K5_BATCH_LEVELS + K5_SWEEP_LEVELS
#: a shape over K5's shared-memory cap: the wrapper runs K2 then K4
K5_OVER_CAP = (1, 328, 1)
#: more shapes at which each K5 route is held to plain (step 22): n = 1,
#: odd orders, batches that fill no whole block of the block or warp
#: route; for the split route n = 17, 33 and 63 (one past a segment's
#: rows, one short of two rows a lane) and 64 (its largest), k = 1 and
#: k = 2, 5, 9 and 41 (not a multiple of its 4 columns a group)
K5_EDGES = ((1, 1, 1), (5, 13, 3), (7, 8, 2), (33, 20, 9), (1, 37, 2),
            (3, 17, 9), (2, 33, 41), (5, 63, 1), (4, 63, 2), (9, 64, 5))
#: bench_mpc's defaults: horizon, states, controls, instances
MPC_T, MPC_NS, MPC_NU, MPC_BATCH = 32, 8, 4, 256
#: the float64 MPC checks (steps 42-43): random_mpc's default sizes and
#: the state-bounded batch
MPC_SMALL, MPC_SMALL_BATCH = (16, 4, 2), 8
#: step 43's condensed MPC QP: order of its augmented system (n = T nu,
#: m_ineq = T ns, no equalities)
MPC_AUG = MPC_SMALL[0] * (MPC_SMALL[1] + MPC_SMALL[2])
#: bench_torch.py's tf mode (step 47): the first TF_B QPs of the slice at
#: tol 1e-8 under two_float, whose float64 iteration factors at order 24
#: at its schedule's batches ([(16, 1), (14, 4)] at max_iter=30)
TF_B = 2048
TF_BATCHES = (TF_B, TF_B // 4)
#: (order, matrices) at which both K2 routes are held to plain (step 4)
#: and timed (steps 8, 17): the compact slice's batches and its float64
#: escalation of at most 32 stragglers, the Schur slice's H and S blocks,
#: the equality_qp slice's KKT (order 30, 64 systems: 'regldlt'), the
#: normal slice's order-128 normal equations and H's panels (16
#: matrices), the condensed MPC QP of step 43 (order 96, 8 systems), odd
#: orders, n = 1, batches that fill no whole block, the tf slice's
#: batches (step 47), the sp solve's H blocks and S at one and two ranks
#: (steps 49-50) and the dp slice's half batch at two ranks (step 51);
#: and one order over the block route's shared memory (the nd slice's
#: generic top)
K2_SHAPES = ((N_AUG, 10240), (N_AUG, 2560), (N_AUG, 320), (N_AUG, 32),
             (SCHUR_N, SCHUR_I * SCHUR_BLOCKS), (SCHUR_MC, SCHUR_I),
             (30, 64), (128, 16), (MPC_AUG, MPC_SMALL_BATCH), (13, 1000),
             (37, 77), (1, 5)) + tuple((N_AUG, B) for B in TF_BATCHES) + \
    ((SCHUR_N, SCHUR_BLOCKS), (SCHUR_N, SCHUR_BLOCKS // SP_WORLD),
     (SCHUR_MC, 1), (N_AUG, B_SLICE // SP_WORLD))
K2_OVER_CAP = (328, 1)
#: (order, systems, type) at which both K3 routes are held to plain
#: (step 4) and timed (step 8): the compact slice's batches and its
#: float64 escalation, the Schur slice's H and S blocks, the nd slice's
#: three levels, the equality_qp slice's KKT ('regldlt', float64), the
#: condensed MPC QP of step 43 (order 96, float64, over the warp route's
#: cap), the nd slice's generic top (order 328, over the warp route's
#: shared memory), the levels of step 44's side-96 plan, the tf
#: slice's float64 batches (step 47), the sp solve's H blocks and S at
#: one and two ranks (steps 49-50) and the dp slice's half batch at two
#: ranks (step 51)
K3_SHAPES = ((N_AUG, 10240, "float32"), (N_AUG, 2560, "float32"),
             (N_AUG, 320, "float32"), (N_AUG, 32, "float64"),
             (SCHUR_N, SCHUR_I * SCHUR_BLOCKS, "float64"),
             (SCHUR_MC, SCHUR_I, "float64"), (64, 105, "float32"),
             (16, 28, "float32"), (16, 16, "float32"), (30, 64, "float64"),
             (MPC_AUG, MPC_SMALL_BATCH, "float64"), (328, 1, "float32")) + \
    tuple((n, B, "float32") for B, n, _ in K5_SWEEP_LEVELS) + \
    tuple((N_AUG, B, "float64") for B in TF_BATCHES) + \
    ((SCHUR_N, SCHUR_BLOCKS, "float64"),
     (SCHUR_N, SCHUR_BLOCKS // SP_WORLD, "float64"),
     (SCHUR_MC, 1, "float64"), (N_AUG, B_SLICE // SP_WORLD, "float32"))
#: more (order, systems), in both types: n = 1, odd orders, batches that
#: fill no tile, the warp route's cap (83) and one past it
K3_EDGES = ((1, 5), (13, 7), (37, 77), (24, 3), (83, 9), (84, 9))
#: steps 53-56: the tp path at the reference's full width, the bar of the
#: slow tests of tests/test_sharded_ldlt.py (the system kkt(3584, 512,
#: seed=3, scale=2.0) of order TP_DIM at the default panel) and
#: tests/test_sharded_ipm.py (the box QP of n = TP_QP_N, float32, tol
#: 1e-4, panel TP_PANEL, max_iter 40, scale_tol), at one rank and at
#: TP_WORLD ranks sharing the card
TP_KKT, TP_DIM, TP_PANEL, TP_WORLD = (3584, 512, 3, 2.0), 4096, 128, 2
TP_QP_N, TP_QP_TOL, TP_QP_ITER = 4096, 1e-4, 40
#: published peaks of one H100 SXM: HBM bytes/s, and FLOP/s outside the
#: tensor cores (float64 runs at half the float32 rate there)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_diff(a, b):
    """Largest absolute difference over the largest magnitude of b."""
    return ((a - b).abs().max() / b.abs().max()).item()


def bound(elements, flops, dtype):
    """The least time the card could take, in ms, and what binds it:
    ``elements`` values of ``dtype`` moved once over the HBM rate against
    ``flops`` operations over the peak rate of the type."""
    name = str(dtype).replace("torch.", "")
    t_bytes = elements * ITEMSIZE[name] / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def ldlt_bounds(B, n, k, dtype):
    """Bounds of K2 (factor), K3 (solve) and K4 (k-column solve) on B
    systems of order n.  K2 reads K and writes L and D, n^3/3
    multiply-adds.  K3 reads the strict lower triangle of L (the unit
    diagonal and the upper triangle are never read), D and b and writes
    x: n(n-1) multiply-adds over the two sweeps and n divisions; K4 the
    same for k columns."""
    tri = n * (n - 1) // 2
    return {"K2": bound(B * (2 * n * n + n), B * 2 * n ** 3 / 3, dtype),
            "K3": bound(B * (tri + 3 * n), B * (4 * tri + n), dtype),
            "K4": bound(B * (tri + n + 2 * n * k),
                        B * k * (4 * tri + n), dtype)}


def k5_bound(B, n, k, dtype):
    """Bound of K5 on B systems of order n with k right-hand sides: it
    reads A and R and writes L, D and X; n^3/3 multiply-adds for the
    factor and n^2 for each column's two sweeps (n^2/2 each), two
    operations a multiply-add."""
    return bound(B * (2 * n * n + n + 2 * n * k),
                 2 * B * (n ** 3 / 3 + k * n * n), dtype)


def cr_bounds(B, N, b, k, dtype):
    """Bounds of K6 and K7 on B systems of N blocks of order b, k
    right-hand sides.  K6 reads D and E and writes three (N, b, b)
    factor arrays; per eliminated block an explicit inverse through the
    Cholesky factor (about b^3 operations: b^3/3 each for L, L^-1 and the
    symmetric product) and five b x b products (10 b^3).  K7 reads the
    factors and r and writes x; per block six products of a b x b matrix
    with k columns (12 b^2 k)."""
    return {"K6": bound(B * (5 * N - 1) * b * b, B * N * 11 * b ** 3,
                        dtype),
            "K7": bound(B * (3 * N * b * b + 2 * N * b * k),
                        B * N * 12 * b * b * k, dtype)}


def time_library(what, fn, want, tol, reps):
    """Milliseconds of one PyTorch call that computes the same function
    (a yardstick the port never calls), or None when the call is refused
    here or computes something else; says which.  ``reps`` 0 times the
    checked call itself by CUDA events (a call of seconds)."""
    import torch
    try:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
    except Exception as exc:                       # noqa: BLE001
        print(f"library call {what}: refused ({type(exc).__name__}: "
              f"{str(exc).splitlines()[0][:120]}); library_ms null")
        return None
    diff = rel_diff(got, want)
    if not diff <= tol:
        print(f"library call {what}: rel diff {diff:.3e} > {tol:g}, not "
              f"the same function here; library_ms null")
        return None
    ms = time_cuda(fn, reps) if reps else start.elapsed_time(end)
    print(f"library call {what}: {ms:.4f} ms per call, rel diff to the "
          f"plain version {diff:.3e}")
    return ms


def ldl_solve_call(L, D, b):
    """torch.linalg.ldl_solve on the compact form of (L, D) with trivial
    pivots: the same function as K3 (b a vector) and K4 (b a matrix)."""
    import torch
    n = L.shape[-1]
    LD = torch.tril(L, -1) + torch.diag_embed(D)
    piv = torch.arange(1, n + 1, dtype=torch.int32,
                       device=L.device).expand(L.shape[0], n).contiguous()
    rhs = b if b.dim() == 3 else b.unsqueeze(-1)

    def call():
        x = torch.linalg.ldl_solve(LD, piv, rhs)
        return x if b.dim() == 3 else x.squeeze(-1)
    return call


def quasi_definite(B, n, dtype, device, seed):
    """Well-conditioned symmetric quasi-definite [[H, A^T], [A, -C]]
    with H, C positive definite (the shape of the IPM's systems)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n1 = (2 * n) // 3
    n2 = n - n1
    M = rng.normal(size=(B, n1, n1))
    K = np.zeros((B, n, n))
    K[:, :n1, :n1] = np.einsum("bij,bkj->bik", M, M) / n1 + np.eye(n1)
    A = rng.normal(size=(B, n2, n1))
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = np.swapaxes(A, 1, 2)
    K[:, n1:, n1:] = -np.einsum("bi,ij->bij",
                                np.abs(rng.normal(size=(B, n2))) + 0.5,
                                np.eye(n2))
    b = rng.normal(size=(B, n))
    return (torch.tensor(K).to(dtype).to(device),
            torch.tensor(b).to(dtype).to(device))


def time_cuda(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    from ipmzoo_tpu_torch.utils.timer import cuda_time
    return cuda_time(fn, runs=1, warmup=1, calls=reps).ms


def device_ms(fn, reps):
    """Device milliseconds per call of ``fn``: the time of the CUDA
    kernels it launches, from one trace of ``reps`` calls (the port's
    ``utils/timer.device_calls``: a whole one if one of five takes is,
    else the last, divided by the calls it holds, said).  Unlike
    time_cuda it leaves out the host's time between launches, which at a
    few tens of microseconds a call hides the difference between two
    short kernels."""
    from ipmzoo_tpu_torch.utils.timer import device_calls
    return device_calls(fn, reps).ms


#: the device's idle time between two groups of launch_ms, and the
#: shortest gap in a trace that separates them (a group's own launches
#: follow each other within the host's launch time, tens of us)
GROUP_GAP_S, GROUP_SPLIT_US = 0.02, 1e4


def launch_ms(groups, reps):
    """Device milliseconds per launch of each kernel of each group, all
    in one trace (the port's ``utils/timer.trace_kernels``, the first
    group's call its lead), so a whole sweep opens one profiler
    session.  ``groups`` is a list of (fn, kernels): ``reps`` calls of
    ``fn``, and ``kernels`` a name -> (substring of the kernel's name, a
    substring it must not have) map.  The groups run one after another
    with the device idle GROUP_GAP_S before each, and the trace is split
    at those gaps.  Each kernel's time is its traced time over its
    traced launches, so a launch the trace lost changes no reading; a
    trace that lost a group or every launch of a kernel of one is taken
    again.  Returns one name -> ms map per group."""
    import time
    import torch
    from ipmzoo_tpu_torch.utils import timer
    for fn, _ in groups:
        fn()
    torch.cuda.synchronize()

    def run():
        for fn, _ in groups:
            torch.cuda.synchronize()
            time.sleep(GROUP_GAP_S)
            for _ in range(reps):
                fn()

    def split(events):
        parts, end = [], None
        for ev in events:
            if end is None or ev[1] - end > GROUP_SPLIT_US:
                parts.append([])
            parts[-1].append(ev)
            end = max(end or 0.0, ev[1] + ev[2])
        return parts

    def times(events):
        parts = split(events)
        if len(parts) != len(groups):
            return None
        out = []
        for part, (_, kernels) in zip(parts, groups):
            ms = {}
            for name, (key, unless) in kernels.items():
                hits = [us for k, _, us in part if key in k and
                        (unless is None or unless not in k)]
                if not hits:
                    return None
                ms[name] = sum(hits) / 1e3 / len(hits)
            out.append(ms)
        return out

    return times(timer.trace_kernels(run, lambda ev: times(ev) is not None,
                                     groups[0][0]))


def check_kernels(dev):
    """Step 4: K2/K3 against their plain versions on the card."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR, ldlt, solve_ldlt

    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        K, b = quasi_definite(B_SLICE, N_AUG, dtype, dev, seed=1)
        L, D = cuda_ldlt.ldlt_auto(K)
        L0, D0 = ldlt(K)
        x0 = solve_ldlt(L0, D0, b)
        x = cuda_ldlt.solve_ldlt_auto(L0, D0, b)
        torch.cuda.synchronize()
        rl, rd, rx = rel_diff(L, L0), rel_diff(D, D0), rel_diff(x, x0)
        name = str(dtype).replace("torch.", "")
        print(f"kernels {name} n={N_AUG} B={B_SLICE}: K2 rel diff "
              f"L {rl:.3e} D {rd:.3e}, K3 rel diff x {rx:.3e} "
              f"(limit {tol:g})")
        check(max(rl, rd) <= tol, f"K2 disagrees with its plain version "
              f"in {name}: {max(rl, rd):.3e} > {tol:g}")
        check(rx <= tol, f"K3 disagrees with its plain version in {name}: "
              f"{rx:.3e} > {tol:g}")
        if dtype == torch.float32:
            errs["ldlt"] = max((L - L0).abs().max().item(),
                               (D - D0).abs().max().item())
            errs["solve_ldlt"] = (x - x0).abs().max().item()

    # exact-zero pivot: rows 0-1 form [[1, 1], [1, 1]], decoupled from
    # the rest, so the second pivot is 1 - 1*1*1 == 0 exactly
    K, _ = quasi_definite(B_SLICE, N_AUG, torch.float32, dev, seed=2)
    K[:, :2, :] = 0.0
    K[:, :, :2] = 0.0
    K[:, :2, :2] = 1.0
    L, D = cuda_ldlt.ldlt_auto(K)
    L0, D0 = ldlt(K)
    floor = torch.tensor(PIVOT_FLOOR, dtype=torch.float32)
    check(bool((D[:, 1].cpu() == floor).all()),
          "K2 did not put the pivot floor on an exactly-zero pivot")
    check(bool((D0[:, 1].cpu() == floor).all()),
          "plain LDL^T did not put the pivot floor on a zero pivot")
    rz = max(rel_diff(L, L0), rel_diff(D, D0))
    check(rz <= 1e-5, f"K2 disagrees on the zero-pivot case: {rz:.3e}")
    print(f"kernels zero pivot: D[:,1] == {PIVOT_FLOOR:g} exactly in both "
          f"for all {B_SLICE} instances; rel diff {rz:.3e}")
    return errs


#: K4's kernels by route, as launch_ms matches them
K4_KERNELS = {"thread": ("ldlt_solve_matrix_kernel<", None),
              "warp": ("ldlt_solve_matrix_kernel_warp<", None)}


def k4_call(route, L_t, D_t, R):
    """One launch of K4's ``route`` on the SoA factors and R (B, n, k),
    with the layout work its caller does (the thread route's transposes
    of R and X); returns X (B, n, k)."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    if route == "warp":
        return cuda_ldlt.solve_matrix_warp(L_t, D_t, R)
    return cuda_ldlt.solve_matrix_soa(
        L_t, D_t, R.permute(1, 2, 0).contiguous()).permute(2, 0, 1)


def k4_routes(n, k, dtype):
    """The K4 routes that can run order n with k columns in ``dtype``."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    return ("thread", "warp") if cuda_ldlt.k4_warp_shape(n, k, dtype) \
        else ("thread",)


def k4_inputs(n, k, B, dtype, dev):
    """Plain factors of B quasi-definite systems of order n, k random
    right-hand sides, and the SoA factors K4 reads."""
    import torch
    from ipmzoo_tpu_torch.ops.ldlt import ldlt
    K, _ = quasi_definite(B, n, dtype, dev, seed=n + k)
    R = torch.randn((B, n, k), dtype=dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(k))
    L, D = ldlt(K)
    return L, D, R, (L.permute(1, 2, 0).contiguous(), D.t().contiguous())


def k4_cases():
    """(n, k, B, dtype) of K4_SHAPES and K4_EDGES, in both types."""
    import torch
    return [(n, k, B, dt) for dt in (torch.float32, torch.float64)
            for n, k, B in K4_SHAPES + K4_EDGES]


def check_k4(dev):
    """Step 4, K4: the multi-rhs solve through solve_ldlt_matrix_auto and
    each route alone against the plain version on the card, on the
    factors of quasi-definite systems, at every shape of k4_cases; the
    two routes' X against each other, and the wrapper taking the route
    k4_route picks, one launch.  Returns the largest absolute differences
    by (route, n, k, B, type)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import solve_ldlt_matrix

    errs, between = {}, 0.0
    for n, k, B, dtype in k4_cases():
        name = str(dtype).replace("torch.", "")
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        L, D, R, soa = k4_inputs(n, k, B, dtype, dev)
        X0 = solve_ldlt_matrix(L, D, R)
        xs = {}
        for route in k4_routes(n, k, dtype):
            X = k4_call(route, *soa, R)
            torch.cuda.synchronize()
            rx = rel_diff(X, X0)
            print(f"kernels {name} n={n} k={k} B={B}: K4 {route} route rel "
                  f"diff X {rx:.3e} (limit {tol:g})")
            check(rx <= tol, f"K4's {route} route disagrees with its plain "
                  f"version in {name} at n={n} k={k} B={B}: {rx:.3e} > "
                  f"{tol:g}")
            xs[route] = X
            errs[(route, n, k, B, name)] = (X - X0).abs().max().item()
        if len(xs) == 2:
            d = (xs["warp"] - xs["thread"]).abs().max().item()
            between = max(between, d / max(X0.abs().max().item(), 1e-300))
        pick = cuda_ldlt.k4_route(n, k, B, dtype)
        before = dict(cuda_ldlt.route_launches)
        X = cuda_ldlt.solve_ldlt_matrix_auto(L, D, R)
        torch.cuda.synchronize()
        made = {a: v - before[a] for a, v in cuda_ldlt.route_launches.items()
                if v != before[a]}
        check(made == {f"solve_ldlt_matrix {pick}": 1},
              f"solve_ldlt_matrix_auto at n={n} k={k} B={B} {name}: "
              f"launches {made}, k4_route picks {pick}")
        check(torch.equal(X, xs[pick]), f"solve_ldlt_matrix_auto at n={n} "
              f"k={k} B={B} {name} differs from its route launched alone")
    print(f"kernels K4: largest difference between the two routes' X, over "
          f"the largest |X|: {between:.3e}")
    return errs


def k4_device_ms(dev, cases, reps):
    """Device ms of each K4 route that can run each (n, k, B, dtype) of
    ``cases`` (k4_routes; the thread route with its caller's transposes),
    on the inputs of k4_inputs, all in one trace (launch_ms); a list of
    route -> ms maps."""
    groups = []
    for n, k, B, dtype in cases:
        _, _, R, soa = k4_inputs(n, k, B, dtype, dev)
        routes = k4_routes(n, k, dtype)
        groups.append((lambda routes=routes, soa=soa, R=R:
                       [k4_call(r, *soa, R) for r in routes],
                       {r: K4_KERNELS[r] for r in routes}))
    return launch_ms(groups, reps)


def time_k4_routes(dev):
    """Step 8, K4's routes: device time of each route at every shape of
    k4_cases, all in one trace (k4_device_ms); fails where k4_route picks
    a route more than 5% slower than the other at K4_SHAPES.  Returns the
    times by (n, k, B, type)."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    cases = k4_cases()
    out = {}
    for (n, k, B, dtype), dev_t in zip(cases, k4_device_ms(dev, cases, 20)):
        name = str(dtype).replace("torch.", "")
        routes = list(dev_t)
        pick = cuda_ldlt.k4_route(n, k, B, dtype)
        best = min(routes, key=lambda r: dev_t[r])
        bnd = ldlt_bounds(B, n, k, dtype)["K4"]
        out[(n, k, B, name)] = dev_t
        print(f"timing K4 routes n={n} k={k} B={B} {name} (device ms per "
              f"call): " + ", ".join(f"{r} {dev_t[r]:.5f}" for r in routes) +
              f"; bound {bnd[0]:.6f} ms by {bnd[1]}; k4_route picks {pick}, "
              f"the faster is {best}")
        if (n, k, B) in K4_SHAPES:
            check(dev_t[pick] <= 1.05 * dev_t[best],
                  f"k4_route picks the {pick} route at n={n} k={k} B={B} "
                  f"{name}: {dev_t[pick]:.5f} ms of device time against "
                  f"{best}'s {dev_t[best]:.5f}")
    return out


def k2_call(route, A):
    """One launch of K2's ``route`` on A (B, n, n), with the layout work
    its caller does (the SoA route's transpose); returns the SoA storage
    L_t (n, n, B), D_t (n, B)."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    if route == "block":
        return cuda_ldlt.factor_block(A.contiguous())
    return cuda_ldlt.factor_soa(A.permute(1, 2, 0).contiguous())


def k2_routes(n, dtype):
    """The K2 routes that can run order n in ``dtype``."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    return ("soa", "block") if cuda_ldlt.factor_block_fits(n, dtype) \
        else ("soa",)


def hold_k2(what, A, route, tol):
    """K2's ``route`` against the plain version on A: L and D within
    ``tol`` (step 4's measure); returns (plain L, plain D, the route's D,
    largest absolute difference)."""
    import torch
    from ipmzoo_tpu_torch.ops.ldlt import ldlt
    L0, D0 = ldlt(A)
    L_t, D_t = k2_call(route, A)
    torch.cuda.synchronize()
    L, D = L_t.permute(2, 0, 1), D_t.t()
    rl, rd = rel_diff(L, L0), rel_diff(D, D0)
    print(f"kernels {what}: K2 {route} route rel diff L {rl:.3e} D "
          f"{rd:.3e} (limit {tol:g})")
    check(max(rl, rd) <= tol, f"K2's {route} route disagrees with its plain "
          f"version ({what}): {max(rl, rd):.3e} > {tol:g}")
    return L0, D0, D, max((L - L0).abs().max().item(),
                          (D - D0).abs().max().item())


def check_k2_routes(dev):
    """Step 4, K2's routes: each held to the plain version at every shape
    of K2_SHAPES (and the SoA route over the block route's cap), float32
    within 1e-5 and float64 within 1e-12, and on an exactly-zero pivot;
    returns the largest absolute differences by (route, n, B, type)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR

    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        name = str(dtype).replace("torch.", "")
        for n, B in K2_SHAPES + (K2_OVER_CAP,):
            A, _ = quasi_definite(B, n, dtype, dev, seed=n + B)
            for route in k2_routes(n, dtype):
                errs[(route, n, B, name)] = hold_k2(
                    f"{name} n={n} B={B}", A, route, tol)[-1]
            print(f"kernels {name} n={n} B={B}: k2_route picks "
                  f"{cuda_ldlt.k2_route(n, B, dtype)}")
        check(K2_OVER_CAP[0] > 0 and k2_routes(K2_OVER_CAP[0], dtype) ==
              ("soa",), f"order {K2_OVER_CAP[0]} fits the block route")
        # an exactly-zero second pivot, as in step 4
        for n, B in ((N_AUG, B_SLICE), (SCHUR_N, SCHUR_I * SCHUR_BLOCKS)):
            A, _ = quasi_definite(B, n, dtype, dev, seed=2)
            A[:, :2, :] = 0.0
            A[:, :, :2] = 0.0
            A[:, :2, :2] = 1.0
            floor = torch.tensor(PIVOT_FLOOR, dtype=dtype)
            for route in k2_routes(n, dtype):
                _, D0, D, _ = hold_k2(f"{name} zero pivot n={n} B={B}", A,
                                      route, tol)
                check(bool((D[:, 1].cpu() == floor).all()) and
                      bool((D0[:, 1].cpu() == floor).all()),
                      f"K2's {route} route or its plain version did not put "
                      f"the pivot floor on an exactly-zero pivot")
    return errs


def time_k2_routes(dev, n, B, dtype, A=None, reps=20):
    """Both K2 routes (each with its caller's layout work), the plain
    version and the bound at (n, B), on A or on quasi-definite matrices;
    prints which the rule picks and that it is no slower."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import ldlt
    if A is None:
        A, _ = quasi_definite(B, n, dtype, dev, seed=n + B)
    name = str(dtype).replace("torch.", "")
    routes = k2_routes(n, dtype)
    t = {f"K2_{r}": time_cuda(lambda r=r: k2_call(r, A), reps)
         for r in routes}
    dev_t = {r: device_ms(lambda r=r: k2_call(r, A), reps) for r in routes} \
        if len(routes) > 1 else {routes[0]: t[f"K2_{routes[0]}"]}
    t.update({f"K2_{r}_device": v for r, v in dev_t.items()})
    t["K2_plain"] = time_cuda(lambda: ldlt(A), 3)
    t["bound"] = ldlt_bounds(B, n, 1, dtype)["K2"]
    pick = cuda_ldlt.k2_route(n, B, dtype)
    best = min(routes, key=lambda r: dev_t[r])
    print(f"timing K2 routes n={n} B={B} {name} (ms per call, CUDA events; "
          f"_device: kernel time under torch.profiler; layout work "
          f"included): " + ", ".join(
              f"{k} {v:.4f}" for k, v in t.items() if k != "bound") +
          f"; bound {t['bound'][0]:.6f} ms by {t['bound'][1]}; k2_route "
          f"picks {pick}, the faster on the device is {best}")
    check(dev_t[pick] <= 1.05 * dev_t[best],
          f"k2_route picks the {pick} route at n={n} B={B} {name}: "
          f"{dev_t[pick]:.4f} ms of device time against {best}'s "
          f"{dev_t[best]:.4f}")
    return t


#: K3's kernels by route, as launch_ms matches them
K3_KERNELS = {"thread": ("ldlt_solve_kernel<", None),
              "warp": ("ldlt_solve_kernel_warp<", None)}


def k3_call(route, L_t, D_t, b_t):
    """One launch of K3's ``route`` on SoA factors and right-hand side."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    launch = cuda_ldlt.solve_soa_warp if route == "warp" else \
        cuda_ldlt.solve_soa
    return launch(L_t, D_t, b_t)


def k3_routes(n, dtype):
    """The K3 routes that can run order n in ``dtype``."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    return ("thread", "warp") if cuda_ldlt.solve_warp_fits(n, dtype) \
        else ("thread",)


def k3_inputs(n, B, dtype, dev, seed):
    """Plain factors of B quasi-definite systems of order n, a right-hand
    side, and the SoA storage K3 reads."""
    from ipmzoo_tpu_torch.ops.ldlt import ldlt
    K, b = quasi_definite(B, n, dtype, dev, seed)
    L, D = ldlt(K)
    soa = (L.permute(1, 2, 0).contiguous(), D.t().contiguous(),
           b.t().contiguous())
    return L, D, b, soa


def k3_cases():
    """(n, B, dtype) of K3_SHAPES, then K3_EDGES in both types."""
    import torch
    dt = {"float32": torch.float32, "float64": torch.float64}
    return [(n, B, dt[t]) for n, B, t in K3_SHAPES] + \
        [(n, B, d) for d in dt.values() for n, B in K3_EDGES]


def check_k3_routes(dev):
    """Step 4, K3's routes: each route alone against the plain solve at
    every shape of k3_cases (float32 within 1e-5, float64 within 1e-12,
    step 4's measure), the two routes' x against each other, and the
    wrapper solve_ldlt_auto taking the route k3_route picks, one launch
    (above K2_ORDERS, where ldlt_route picks the blocked route, its
    library solve instead, within the same limit);
    returns the largest absolute differences by (route, n, B, type)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import solve_ldlt

    errs, between = {}, 0.0
    for n, B, dtype in k3_cases():
        name = str(dtype).replace("torch.", "")
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        L, D, b, soa = k3_inputs(n, B, dtype, dev, seed=n + B)
        x0 = solve_ldlt(L, D, b)
        xs = {}
        for route in k3_routes(n, dtype):
            x = k3_call(route, *soa).t()
            torch.cuda.synchronize()
            r = rel_diff(x, x0)
            print(f"kernels {name} n={n} B={B}: K3 {route} route rel diff x "
                  f"{r:.3e} (limit {tol:g})")
            check(r <= tol, f"K3's {route} route disagrees with the plain "
                  f"solve ({name} n={n} B={B}): {r:.3e} > {tol:g}")
            xs[route] = x
            errs[(route, n, B, name)] = (x - x0).abs().max().item()
        if len(xs) == 2:
            d = (xs["warp"] - xs["thread"]).abs().max().item()
            between = max(between, d / max(x0.abs().max().item(), 1e-300))
        blocked = cuda_ldlt.ldlt_route(n) == "blocked"
        pick = "blocked" if blocked else cuda_ldlt.k3_route(n, B, dtype)
        before = dict(cuda_ldlt.route_launches)
        x = cuda_ldlt.solve_ldlt_auto(L, D, b)
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in cuda_ldlt.route_launches.items()
                if v != before[k]}
        # above K2_ORDERS the blocked route's library solve, no K3
        check(made == ({} if blocked else {f"solve_ldlt {pick}": 1}),
              f"solve_ldlt_auto at n={n} B={B} {name}: launches {made}, "
              f"the route picked is {pick}")
        check(rel_diff(x, x0) <= tol if blocked else
              torch.equal(x, xs[pick]), f"solve_ldlt_auto at n={n} B={B} "
              f"{name} differs from its route ({pick}) alone")
    print(f"kernels K3: largest difference between the two routes' x, over "
          f"the largest |x|: {between:.3e}")
    return errs


#: device time below which two K3 launches tie: at n = 1 both routes take
#: the launch's 1.3-1.7 us, and which is faster flipped between runs
K3_TIE_MS = 2e-4


def time_k3_routes(dev):
    """Step 8, K3's routes: device time of each route at every shape of
    k3_cases, all in one trace (launch_ms: at a few microseconds a call
    CUDA events time the Python wrapper), with CUDA events behind a
    leading launch beside it; fails where k3_route picks a route whose
    device time is more than 5% and K3_TIE_MS above the other's.
    Returns the times by (n, B, type)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.utils.timer import cuda_time
    cases = [(n, B, dtype, k3_routes(n, dtype),
              k3_inputs(n, B, dtype, dev, seed=n + B)[3])
             for n, B, dtype in k3_cases()]
    dev_ts = launch_ms([(lambda routes=routes, soa=soa:
                         [k3_call(r, *soa) for r in routes],
                         {r: K3_KERNELS[r] for r in routes})
                        for _, _, _, routes, soa in cases], 20)
    out = {}
    for (n, B, dtype, routes, soa), dev_t in zip(cases, dev_ts):
        name = str(dtype).replace("torch.", "")
        ev_t = {r: cuda_time(lambda r=r: k3_call(r, *soa), runs=5, calls=3,
                             lead=1).ms for r in routes}
        pick = cuda_ldlt.k3_route(n, B, dtype)
        best = min(routes, key=lambda r: dev_t[r])
        bnd = ldlt_bounds(B, n, 1, dtype)["K3"]
        out[(n, B, name)] = {"device": dev_t, "events": ev_t, "bound": bnd}
        print(f"timing K3 routes n={n} B={B} {name} (ms per call; device: "
              f"kernel time under torch.profiler; events: CUDA events "
              f"behind a leading launch): " + ", ".join(
                  f"{r} device {dev_t[r]:.5f} events {ev_t[r]:.4f}"
                  for r in routes) + f"; bound {bnd[0]:.6f} ms by {bnd[1]};"
              f" k3_route picks {pick}, the faster on the device is {best}")
        check(dev_t[pick] <= max(1.05 * dev_t[best],
                                 dev_t[best] + K3_TIE_MS),
              f"k3_route picks the {pick} route at n={n} B={B} {name}: "
              f"{dev_t[pick]:.4f} ms of device time against {best}'s "
              f"{dev_t[best]:.4f}")
    return out


def solve_demo(dev):
    """Step 5: the README's demo QP on the card."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, QPData, Settings
    data = QPData.make(Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
                       A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0], u_A_ineq=[1.2],
                       l_x=[0.0, 0.0], u_x=[10.0, 10.0],
                       dtype=torch.float64, device=dev)
    res = CompiledIPM(Settings(), 2, 1, tol=1e-8, device=dev).solve(data)
    x = res.x.cpu().tolist()
    f = res.objective.item()
    print(f"demo QP on {dev}: converged={bool(res.converged)} "
          f"iterations={int(res.iterations)} x={x} f={f!r}")
    check(bool(res.converged), "demo QP did not converge")
    check(abs(x[0] - 1.2) <= 1e-8 and abs(x[1]) <= 1e-8,
          f"demo QP x={x}, expected (1.2, 0)")
    check(abs(f + 11.28) <= 1e-9 * 11.28, f"demo QP f={f}, expected -11.28")


def run_slice(dev):
    """Step 6: the 10240-QP slice on the card."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    data = make_batch(B_SLICE, 16, 8, torch.float32, device=dev)
    solver = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-6,
                         device=dev)
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    res = solver.solve_batch_compact(data)
    torch.cuda.synchronize()
    launches = dict(cuda_ldlt.launches)
    f64 = dict(cuda_ldlt.f64_launches)
    routes = dict(cuda_ldlt.route_launches)
    syncs = solver.host_syncs
    twin_syncs = solver._esc_twin.host_syncs
    escalated = int(solver.escalated)

    check(tuple(res.x.shape) == (B_SLICE, 16), f"x shape {res.x.shape}")
    check(bool(torch.isfinite(res.x).all()), "non-finite x")
    check(bool(torch.isfinite(res.objective).all()), "non-finite objective")
    conv = res.converged.float().mean().item()
    iters = int(res.iterations.sum().item())
    print(f"slice: {B_SLICE} QPs n=16 m=8 float32 tol=1e-6 schedule "
          f"{solver.default_schedule(B_SLICE)} esc_cap='auto' (32): "
          f"converged {conv:.6f} ({int(res.converged.sum())}/{B_SLICE}), "
          f"diverged {int(res.diverged.sum())}, iterations {iters}")
    print(f"slice: launches K2 {launches['ldlt']} K3 "
          f"{launches['solve_ldlt']} (float64: K2 {f64['ldlt']} K3 "
          f"{f64['solve_ldlt']}); escalated instances {escalated}; host "
          f"syncs {syncs} ({twin_syncs} in the escalation stage, "
          f"{syncs - twin_syncs} in the mop-up)")
    print(f"slice: K2 routes: SoA {routes['ldlt soa']}, block "
          f"{routes['ldlt block']}; K3 routes: thread "
          f"{routes['solve_ldlt thread']}, warp {routes['solve_ldlt warp']}")
    check(routes["solve_ldlt thread"] + routes["solve_ldlt warp"] ==
          launches["solve_ldlt"], "slice: K3's route counts do not add up")
    check(conv >= 0.99, f"slice convergence {conv} < 0.99")
    for k in ("ldlt", "solve_ldlt"):
        check(launches[k] > 0, f"the slice never launched kernel {k}")

    med = time_solves(lambda: solver.solve_batch_compact(data), 3)
    print(f"slice: wall ms per solve (CUDA events, 3 runs) median "
          f"{med:.3f}; useful iterations/s {iters / (med / 1e3):.1f}")
    return data, res, {**launches, **routes}


def compare_cpu(data, res):
    """Step 7: the slice's objectives against the port on the CPU, f64."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.state import tree_map

    k = 256
    sub = tree_map(lambda a: a[:k].to(device="cpu", dtype=torch.float64),
                   data)
    cres = CompiledIPM(Settings(), 16, 8, dtype=torch.float64, tol=1e-8,
                       device="cpu").solve_batch_compact(sub)
    f_cpu = cres.objective
    f_gpu = res.objective[:k].cpu().double()
    both = cres.converged & res.converged[:k].cpu()
    diff = (f_gpu - f_cpu).abs()
    bound = 1e-4 * (1.0 + f_cpu.abs())
    worst = (diff / (1.0 + f_cpu.abs()))[both].max().item()
    print(f"cpu f64 check: {int(both.sum())}/{k} instances converged in "
          f"both; largest |f_gpu - f_cpu| / (1 + |f_cpu|) = {worst:.3e} "
          f"(limit 1e-4)")
    check(bool(cres.converged.all()), "CPU f64 reference did not converge")
    check(int(both.sum()) >= 0.99 * k, "too few instances to compare")
    check(bool((diff <= bound)[both].all()),
          "slice objectives disagree with the CPU f64 port")


def time_kernels(dev):
    """Step 8: kernel vs plain times at the slice's shapes (float32), on
    the augmented KKT matrices of the slice's first iteration."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import ldlt, solve_ldlt

    solver = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-6,
                         device=dev)
    out = {}
    for B in SCHEDULE_BATCHES:
        data = make_batch(B, 16, 8, torch.float32, device=dev)
        st = solver.init_state(data)
        K = solver._assemble_kkt(solver._env(data, st.vars, st.mu), B)
        b = torch.randn((B, N_AUG), dtype=torch.float32, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        K_t = K.permute(1, 2, 0).contiguous()
        L_t, D_t = cuda_ldlt.factor_soa(K_t)
        b_t = b.t().contiguous()
        L0, D0 = ldlt(K)
        t = {
            "K2": time_cuda(lambda: cuda_ldlt.factor_soa(K_t), 50),
            "K2_plain": time_cuda(lambda: ldlt(K), 5),
            "K3": time_cuda(lambda: cuda_ldlt.solve_soa(L_t, D_t, b_t), 50),
            "K3_plain": time_cuda(lambda: solve_ldlt(L0, D0, b), 5),
            "A_to_soa": time_cuda(
                lambda: K.permute(1, 2, 0).contiguous(), 50),
            "b_to_soa": time_cuda(lambda: b.t().contiguous(), 50),
            "K2_wrapper": time_cuda(lambda: cuda_ldlt.ldlt_auto(K), 50),
        }
        t.update(time_k2_routes(dev, N_AUG, B, torch.float32, A=K))
        if B == B_SLICE:
            t["K3_library"] = time_library(
                f"torch.linalg.ldl_solve (K3's function) n={N_AUG} B={B} "
                f"float32", ldl_solve_call(L0, D0, b),
                solve_ldlt(L0, D0, b), 1e-4, 0)
        out[B] = t
        print(f"timing B={B} n={N_AUG} float32 (ms per call, CUDA events): "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()
                          if isinstance(v, float)))
    # the float64 escalation of at most 32 stragglers, step 43's condensed
    # MPC QP and the nd slice's generic top (over the block route's shared
    # memory)
    time_k2_routes(dev, N_AUG, 32, torch.float64)
    time_k2_routes(dev, MPC_AUG, MPC_SMALL_BATCH, torch.float64)
    # the tf slice's float64 batches (step 47), and its K3 solve at the
    # full batch by the warp route, the plain version and the library
    for B in TF_BATCHES:
        out[(N_AUG, B, "float64")] = time_k2_routes(dev, N_AUG, B,
                                                    torch.float64)
    L0, D0, b, soa = k3_inputs(N_AUG, TF_B, torch.float64, dev,
                               seed=N_AUG + TF_B)
    tf = out[(N_AUG, TF_B, "float64")]
    tf["K3_warp"] = time_cuda(lambda: k3_call("warp", *soa), 50)
    tf["K3_plain"] = time_cuda(lambda: solve_ldlt(L0, D0, b), 5)
    tf["K3_library"] = time_library(
        f"torch.linalg.ldl_solve (K3's function) n={N_AUG} B={TF_B} "
        f"float64", ldl_solve_call(L0, D0, b), solve_ldlt(L0, D0, b), 1e-10,
        2)
    out[K2_OVER_CAP] = time_k2_routes(dev, *K2_OVER_CAP, torch.float64,
                                      reps=2)
    # the sp solve's H blocks and S at one and two ranks (steps 49-50)
    # and the dp slice's half batch at two ranks (step 51)
    for n, B, dtype in ((SCHUR_N, SCHUR_BLOCKS, torch.float64),
                        (SCHUR_N, SCHUR_BLOCKS // SP_WORLD, torch.float64),
                        (SCHUR_MC, 1, torch.float64),
                        (N_AUG, B_SLICE // SP_WORLD, torch.float32)):
        out[(n, B, str(dtype).replace("torch.", ""))] = time_k2_routes(
            dev, n, B, dtype)
    return out


def fused_solver(dev, dtype, tol=1e-6):
    """The fused slice's solver: bench_torch.py's fused configuration."""
    import bench_torch
    return bench_torch.fused_solver(dev, dtype, tol)


def print_build(what, lib, cached, seconds):
    print(f"build: {what} ready in {seconds:.2f} s "
          f"({'reused' if cached else 'compiled'} {lib.name})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if any(k in line for k in ("registers", "spill", "stack frame")):
            print(f"build: {line.strip()}")


def build_kernels(extra=None):
    """Steps 3, 9 and 28: build ldlt.cu, cr.cu, roofline.cu, K1 and the
    five T3 prefixes of each route (and the builds of ``extra``, name ->
    callable), one nvcc process each, all started together; report each
    build's time and ptxas' report."""
    import torch
    import chip_phases
    from chip_roofline import build_all
    from ipmzoo_tpu_torch.ops import (_build, cuda_cr, cuda_fused, cuda_ldlt,
                                      cuda_roofline)
    cpu_solver = fused_solver("cpu", torch.float32)
    src = cpu_solver.kernel_source()
    team_srcs = team_sources(cpu_solver)
    wide = wide_jobs()
    phase_srcs = {key: chip_phases.phase_sources(key[1], key[0])
                  for key in chip_phases.BUILDS}
    libs = {"ldlt": _build.library_path("ldlt"),
            "cr": _build.library_path("cr"),
            "roofline": _build.library_path("roofline"),
            "fused": _build.generated_library_path("fused_ipm", src)}
    for lanes, text in team_srcs.items():
        libs[f"team{lanes}"] = _build.generated_library_path("fused_team",
                                                             text)
    for (point, route), texts in phase_srcs.items():
        for p, text in enumerate(texts):
            libs[f"phase {route} {p} ({point})"] = \
                _build.generated_library_path(cuda_fused.PHASE_LIBS[route],
                                              text)
    for k, (path, _, _) in wide.items():
        libs[k] = path
    cached = {k: p.exists() for k, p in libs.items()}
    jobs = {"ldlt": cuda_ldlt._lib, "cr": cuda_cr._lib,
            "roofline": cuda_roofline._lib,
            "fused": lambda: cuda_fused.library(src)}
    for lanes, text in team_srcs.items():
        jobs[f"team{lanes}"] = lambda t=text: cuda_fused.library(
            t, "fused_team")
    for (point, route), texts in phase_srcs.items():
        for p, text in enumerate(texts):
            jobs[f"phase {route} {p} ({point})"] = \
                lambda t=text, r=route: cuda_fused.library(
                    t, cuda_fused.PHASE_LIBS[r])
    for k, (_, _, build) in wide.items():
        jobs[k] = build
    jobs.update(extra or {})
    seconds = build_all(jobs)
    print_build(SOURCE, libs["ldlt"], cached["ldlt"], seconds["ldlt"])
    print_build(CR_SOURCE, libs["cr"], cached["cr"], seconds["cr"])
    print(f"build: K1 source generated for Settings(), n=16, m_ineq=8: "
          f"{len(src.splitlines())} lines")
    print_build("K1 (generated fused_ipm)", libs["fused"], cached["fused"],
                seconds["fused"])
    for lanes, text in team_srcs.items():
        k = f"team{lanes}"
        print_build(f"K1 team route, {lanes} lanes (generated fused_team, "
                    f"{len(text.splitlines())} lines)", libs[k], cached[k],
                    seconds[k])
        lib = cuda_fused.library(text, "fused_team")
        for dtype in (torch.float32, torch.float64):
            sh = cuda_fused.team_shape(lib, dtype)
            print(f"build: K1 team route, {lanes} lanes, "
                  f"{str(dtype).replace('torch.', '')}: {sh['threads']} "
                  f"threads a block, {sh['team_bytes']} bytes of shared "
                  f"memory a team, {sh['teams_per_sm']} teams resident per "
                  f"SM")
    report_wide_builds(wide_sources(), libs, cached, seconds)
    report_block_builds(wide_sources("block"), libs, cached, seconds)
    print_build(ROOFLINE_SOURCE, libs["roofline"], cached["roofline"],
                seconds["roofline"])
    for (point, route), texts in phase_srcs.items():
        for p in range(len(texts)):
            k = f"phase {route} {p} ({point})"
            how = "reused" if cached[k] else "compiled"
            print(f"build: T3 {route} route prefix {p} ({point}) ready in "
                  f"{seconds[k]:.2f} s ({how} {libs[k].name})")
    return chip_phases.report_ptxas()


def report_route_builds():
    """Step 3, the second routes of K3, K4, K6 and K7 and K5's split
    route: ptxas' registers,
    stack frame, spills and static shared memory per instantiation, and for
    K6's cluster route at the arrow slice's shape (N=256, b=16) the
    threads a block, dynamic shared memory and
    cudaOccupancyMaxActiveClusters per cluster size and type."""
    import torch
    from ipmzoo_tpu_torch.ops import _build, cuda_cr
    for name, key in (("ldlt", "ldlt_solve_kernel_warp"),
                      ("ldlt", "ldlt_solve_matrix_kernel_warp"),
                      ("ldlt", "ldlt_factor_solve_matrix_kernel_split"),
                      ("cr", "cr_factor_kernel_cluster"),
                      ("cr", "cr_solve_kernel_shared")):
        lib = _build.library_path(name)
        smem = _build.ptxas_shared(lib)
        for k in _build.ptxas_report(lib):
            if key in k["name"]:
                inst = k["name"][k["name"].index(key) + len(key):]
                print(f"build: {key}{inst[:24]}: {k['registers']} registers, "
                      f"{k['stack']} B stack frame, {k['spill_stores']} / "
                      f"{k['spill_loads']} B spill stores / loads, "
                      f"{smem.get(k['name'], 0)} B static shared memory")
    N, b = ARROW_N // 16, 16
    for dtype in (torch.float32, torch.float64):
        for C in cuda_cr.CLUSTER_SIZES:
            if not cuda_cr.cluster_fits(N, b, C, dtype):
                continue
            occ = cuda_cr.cluster_occupancy(N, b, C, dtype)
            print(f"build: K6 cluster route N={N} b={b} "
                  f"{str(dtype).replace('torch.', '')}: cluster of {C} "
                  f"blocks, {occ['threads']} threads a block, "
                  f"{occ['shared_bytes']} B of dynamic shared memory a "
                  f"block, cudaOccupancyMaxActiveClusters "
                  f"{occ['max_active_clusters']}")
            check(occ["max_active_clusters"] > 0, f"no cluster of {C} fits "
                  f"the card at N={N} b={b} {dtype}")


def check_fused(dev):
    """Step 10: K1's thread route against its plain version on the card,
    B=10240.

    float64: iterations equal on every instance, x within 1e-10 of the
    largest |x|.  float32 at the slice's tol 1e-6: x within 1e-4 on the
    instances converged in both.  The float32 iterates part at rounding
    level from the first iteration (summation order, FMA), and tol 1e-6
    is the float32 floor, where that noise decides on which iteration
    about half of the instances cross the tolerance; so the iteration
    counts are held equal (>= 99% of instances) at tol 1e-5, above the
    floor, and only reported at 1e-6."""
    import torch
    from ipmzoo_tpu_torch.models.convert import make_batch

    err32 = None
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-6),
                       (torch.float32, 1e-5)):
        name = f"{str(dtype).replace('torch.', '')} tol={tol:g}"
        solver = fused_solver(dev, dtype, tol)
        data = make_batch(B_SLICE, 16, 8, dtype, device=dev)
        cold_call = (data, None, 14, 0)
        cold = solver.soa_result(k1_launcher(solver, cold_call, "thread")())
        state = {k: cold[k] for k in ("variables", "mu", "iterations")}
        for what, call in (("cold max_iter=14", cold_call),
                           ("warm resume max_iter=16", (data, state, 16, 0)),
                           ("cold gondzio=2", (data, None, 14, 2))):
            k = solver.soa_result(k1_launcher(solver, call, "thread")())
            p = solver.soa_result(solver._fused_plain(
                *solver.soa_inputs(*call[:2]), *call[2:]))
            torch.cuda.synchronize()
            err = hold_k1(f"K1 vs plain {name} B={B_SLICE} {what}", k, p,
                          dtype, tol)
            if what == "cold max_iter=14" and dtype == torch.float32 and \
                    tol == 1e-6:
                err32 = err
    return err32


def team_sources(solver):
    """The team route's sources for ``solver`` at each size of
    K1_LANES."""
    from ipmzoo_tpu_torch.models.fused_source import fused_team_source
    return {lanes: fused_team_source(solver, lanes) for lanes in K1_LANES}


def wide_case(n, m, e, B, dtype, device, tol=1e-6):
    """(solver, data) of a WIDE_SHAPES row at batch ``B``: e = 1 is
    portfolio(n_assets=n, batch=B, seed=0), e = 0 make_batch(B, n, m)
    under Settings(); FusedBatchedIPM at ``tol``, its other settings the
    defaults."""
    from ipmzoo_tpu_torch import Settings
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.models.families import portfolio
    from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
    if e:
        fam = portfolio(n_assets=n, batch=B, seed=0, dtype=dtype,
                        device=device)
        settings, data = fam.settings, fam.data
    else:
        settings, data = Settings(), make_batch(B, n, m, dtype,
                                                device=device)
    return FusedBatchedIPM(settings, n, m, e, dtype=dtype, tol=tol,
                           device=device), data


def wide_sources(route="wide", check_build=False):
    """The wide (or block) route's sources at WIDE_SHAPES and RULE_SHAPES,
    by (n, m_ineq, m_eq) (the text depends on neither the batch nor the
    type); ``check_build``: the check builds (apart) at WIDE_SHAPES."""
    import torch
    from ipmzoo_tpu_torch.models import fused_source
    make = {"wide": fused_source.fused_wide_source,
            "block": fused_source.fused_wide_block_source}[route]
    if check_build:
        return {shape[:3]: apart(make(wide_case(*shape[:3], 1,
                                                torch.float32, "cpu")[0]))
                for shape in WIDE_SHAPES}
    return {shape[:3]: make(wide_case(*shape[:3], 1, torch.float32,
                                      "cpu")[0])
            for shape in WIDE_SHAPES + RULE_SHAPES}


def wide_jobs():
    """The wide and block routes' builds, as launched at WIDE_SHAPES and
    RULE_SHAPES and their check builds at WIDE_SHAPES, by build name
    ("wide<shape>", "block<shape>", "wide apart<shape>", "block
    apart<shape>"): (library path, source, build callable)."""
    from ipmzoo_tpu_torch.ops import _build, cuda_fused
    jobs = {}
    for route in ("wide", "block"):
        name = cuda_fused._LIB_NAME[route]
        for check_build in (False, True):
            for key, text in wide_sources(route, check_build).items():
                jobs[f"{route}{' apart' if check_build else ''}{key}"] = (
                    _build.generated_library_path(name, text), text,
                    lambda t=text, nm=name: cuda_fused.library(t, nm))
    return jobs


def report_block_builds(srcs, libs, cached, seconds):
    """Step 9, the block route: each build's time, ptxas' report, and at
    each W of BLOCK_WARPS in both types the threads a block, workspace
    values an instance, shared bytes a block and blocks resident per SM
    (0 where the block does not fit), and the kernel's registers, stack
    and spills a type; the check builds' times."""
    import torch
    from ipmzoo_tpu_torch.ops import _build, cuda_fused
    for k in sorted(k for k in libs if " apart" in k):
        print(f"build: K1 {k.split()[0]} route, check build (generated "
              f"functions apart) {k[k.index('('):]} ready in "
              f"{seconds[k]:.2f} s ({'reused' if cached[k] else 'compiled'} "
              f"{libs[k].name})")
    for key, text in srcs.items():
        k = f"block{key}"
        print_build(f"K1 block route n={key[0]} m_ineq={key[1]} "
                    f"m_eq={key[2]} (generated fused_wide_block, "
                    f"{len(text.splitlines())} lines)", libs[k], cached[k],
                    seconds[k])
        lib = cuda_fused.library(text, "fused_wide_block")
        for k in _build.ptxas_report(libs[f"block{key}"]):
            if "fused_wide_block_kernel" in k["name"]:
                t = "float64" if "FormEdE" in k["name"] else "float32"
                print(f"build: K1 block route n={key[0]} m_ineq={key[1]} "
                      f"m_eq={key[2]} {t} kernel: {k['registers']} "
                      f"registers, {k['stack']} B stack frame, "
                      f"{k['spill_stores']} / {k['spill_loads']} B spill "
                      f"stores / loads")
        for dtype in (torch.float32, torch.float64):
            for w in BLOCK_WARPS:
                sh = cuda_fused.block_shape(lib, dtype, w)
                print(f"build: K1 block route n={key[0]} m_ineq={key[1]} "
                      f"m_eq={key[2]} {str(dtype).replace('torch.', '')} "
                      f"W={w}: {sh['threads']} threads a block, "
                      f"{sh['region']} values of workspace an instance, "
                      f"{sh['shared_bytes']} bytes of shared memory a "
                      f"block, {sh['blocks_per_sm']} blocks resident per "
                      f"SM")
                fits = sh["shared_bytes"] <= cuda_fused.SHARED_CAP
                check(sh["lanes"] == 32 and (sh["blocks_per_sm"] > 0) == fits,
                      f"the block route's build is {sh}")


def report_wide_builds(srcs, libs, cached, seconds):
    """Step 9, the wide route: each build's time, ptxas' report and what
    the build is (threads a block, workspace values an instance, blocks
    resident per SM) in both types."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused
    for key, text in srcs.items():
        k = f"wide{key}"
        print_build(f"K1 wide route n={key[0]} m_ineq={key[1]} m_eq={key[2]}"
                    f" (generated fused_wide, {len(text.splitlines())} "
                    f"lines)", libs[k], cached[k], seconds[k])
        lib = cuda_fused.library(text, "fused_wide")
        for dtype in (torch.float32, torch.float64):
            sh = cuda_fused.wide_shape(lib, dtype)
            print(f"build: K1 wide route n={key[0]} m_ineq={key[1]} "
                  f"m_eq={key[2]} {str(dtype).replace('torch.', '')}: "
                  f"{sh['threads']} threads a block, {sh['region']} values "
                  f"of workspace an instance, {sh['blocks_per_sm']} blocks "
                  f"resident per SM")
            check(sh["lanes"] == 32 and sh["blocks_per_sm"] > 0,
                  f"the wide route's build is {sh}")


def record_k1_calls(solver, data):
    """The fused slice's K1 launches: (data, state, max_iter, gondzio) of
    each solve_fused call that solve_fused_compact(esc_cap=32) makes on
    ``data``, in order (its escalation stage and safety-net tail launch
    no K1)."""
    calls = []
    run = solver.solve_fused

    def record(d, state=None, max_iter=None, gondzio=0):
        calls.append((d, None if state is None else
                      {k: v.clone() for k, v in state.items()},
                      solver.max_iter if max_iter is None else max_iter,
                      gondzio))
        return run(d, state, max_iter, gondzio)

    solver.solve_fused = record
    try:
        solver.solve_fused_compact(data, esc_cap=32)
    finally:
        del solver.solve_fused
    return calls


def k1_call_name(call):
    d, state, max_iter, gondzio = call
    return (f"B={d.Q.shape[0]} {'warm' if state else 'cold'} "
            f"max_iter={max_iter}" + (f" gondzio={gondzio}" if gondzio
                                      else ""))


def k1_launcher(solver, call, route, source=None):
    """One K1 launch of ``call`` on ``route`` (built from ``source``,
    default the solver's), through the wrapper: a function of no
    arguments returning the outputs."""
    from ipmzoo_tpu_torch.ops import cuda_fused
    d, state, max_iter, gondzio = call
    soa, warm = solver.soa_inputs(d, state)
    src = source or solver.kernel_source(route)
    total = sum(solver.var_sizes)
    return lambda: cuda_fused.fused_soa(src, soa, warm, solver.n, total,
                                        max_iter, gondzio,
                                        solver.kernel_params(), route)


def hold_k1(label, k, p, dtype, tol, f32_checks=None):
    """Hold one K1 result dict to the plain version's by step 10's
    limits; prints the reading and returns the largest absolute x
    difference on the instances converged in both.  ``f32_checks``: which
    of "iterations" (equal on >= 99% of instances), "x" (within 1e-4 of
    the largest |x| on the instances converged in both) and "x at equal
    iterations" (the same on those of them that took as many iterations
    in both) a float32 result must pass; by default step 10's,
    "iterations" at tol 1e-5 and "x" at other tolerances."""
    import torch
    B = k["x"].shape[0]
    same = (k["iterations"] == p["iterations"]).cpu()
    n_same = int(same.sum())
    conv = (k["converged"] & p["converged"]).cpu()
    dx = (k["x"] - p["x"]).abs().cpu()
    scale = p["x"].abs().max().item()

    def rel(mask):
        return (dx[mask].max().item() / scale) if mask.any() else 0.0
    rel_all, rel_conv, rel_eq = dx.max().item() / scale, rel(conv), \
        rel(conv & same)
    print(f"{label}: iterations equal on {n_same}/{B}, converged in both "
          f"{int(conv.sum())}, rel diff x all {rel_all:.3e}, on converged "
          f"{rel_conv:.3e}, on converged at equal iterations {rel_eq:.3e}")
    check(bool(torch.isfinite(k["x"]).all()), f"{label}: non-finite x")
    if dtype == torch.float64:
        check(n_same == B, f"{label}: iterations differ from the plain "
              f"version")
        check(rel_all <= 1e-10, f"{label}: x differs from the plain version "
              f"by {rel_all:.3e}")
    else:
        if f32_checks is None:
            f32_checks = ("iterations",) if tol == 1e-5 else ("x",)
        if "iterations" in f32_checks:
            check(n_same >= 0.99 * B, f"{label}: iterations equal on only "
                  f"{n_same} instances")
        if "x" in f32_checks:
            check(rel_conv <= 1e-4, f"{label}: x differs by {rel_conv:.3e} "
                  f"on converged instances")
        if "x at equal iterations" in f32_checks:
            check(rel_eq <= 1e-4, f"{label}: x differs by {rel_eq:.3e} on "
                  f"instances converged at equal iterations")
    return dx[conv].max().item() if conv.any() else 0.0


def check_fused_team(dev):
    """Step 34: K1's team route against its plain version on the card at
    the fused slice's four launches (B=10240 cold max_iter=14, 1536 warm,
    the 10240 warm mop-up and the 512 tile with gondzio=2, recorded from
    solve_fused_compact(esc_cap=32) on the slice's QPs), at each size of
    K1_LANES, by step 10's limits.  Returns the largest float32 x
    difference of the cold B=10240 launch at the default lanes."""
    import torch
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.models.fused_source import team_lanes

    err32 = None
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-6),
                       (torch.float32, 1e-5)):
        name = f"{str(dtype).replace('torch.', '')} tol={tol:g}"
        solver = fused_solver(dev, dtype, tol)
        calls = record_k1_calls(solver, make_batch(B_SLICE, 16, 8, dtype,
                                                   device=dev))
        check([c[0].Q.shape[0] for c in calls] == [B_SLICE, K1_BATCHES[1],
                                                   B_SLICE, K1_BATCHES[2]],
              f"the fused slice's K1 launches changed: "
              f"{[k1_call_name(c) for c in calls]}")
        srcs = team_sources(solver)
        for i, call in enumerate(calls):
            d, state, max_iter, gondzio = call
            p = solver.soa_result(solver._fused_plain(
                *solver.soa_inputs(d, state), max_iter, gondzio))
            for lanes, src in srcs.items():
                k = solver.soa_result(k1_launcher(solver, call, "team",
                                                  src)())
                torch.cuda.synchronize()
                err = hold_k1(f"K1 team route ({lanes} lanes) vs plain "
                              f"{name} {k1_call_name(call)}", k, p, dtype,
                              tol)
                if (i == 0 and dtype == torch.float32 and tol == 1e-6
                        and lanes == team_lanes(solver)):
                    err32 = err
    return err32


def run_fused_slice(dev, data):
    """Step 11: the fused slice on the 10240 QPs."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused, cuda_ldlt

    solver = fused_solver(dev, torch.float32)
    solver.kernel_source()
    cuda_fused.reset_launch_counts()
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    out = solver.solve_fused_compact(data, esc_cap=32)
    torch.cuda.synchronize()
    launches = {**cuda_fused.launches, **cuda_fused.route_launches,
                **cuda_ldlt.launches}
    f64 = dict(cuda_ldlt.f64_launches)
    syncs = solver.host_syncs
    twin_syncs = solver._esc_twin.host_syncs
    escalated = int(solver.escalated)

    x = out["x"]
    check(tuple(x.shape) == (B_SLICE, 16), f"fused x shape {x.shape}")
    check(bool(torch.isfinite(x).all()), "fused slice: non-finite x")
    conv = out["converged"].float().mean().item()
    iters = int(out["iterations"].sum().item())
    print(f"fused slice: {B_SLICE} QPs n=16 m=8 float32 tol=1e-6 "
          f"max_iter=30 schedule {solver.default_fused_schedule(B_SLICE)} "
          f"esc_cap=32: converged {conv:.6f} "
          f"({int(out['converged'].sum())}/{B_SLICE}), iterations {iters}")
    print(f"fused slice: launches K1 {launches['fused']} (team route "
          f"{launches['fused team']}, thread route "
          f"{launches['fused thread']}, as k1_route picks) K2 "
          f"{launches['ldlt']} K3 {launches['solve_ldlt']} (float64: K2 "
          f"{f64['ldlt']} K3 {f64['solve_ldlt']}); escalated instances "
          f"{escalated}; host syncs {syncs} ({twin_syncs} in the "
          f"escalation stage, {syncs - twin_syncs} in the safety-net "
          f"tail)")
    check(conv >= 0.999, f"fused slice convergence {conv} < 0.999")
    check(launches["fused"] > 0, "the fused slice never launched K1")
    check(launches["fused team"] > 0, "the fused slice never launched K1's "
          "team route")

    med = time_solves(lambda: solver.solve_fused_compact(data, esc_cap=32),
                      7)
    print(f"fused slice: wall ms per solve (CUDA events, 7 runs) "
          f"median {med:.3f}; useful iterations/s {iters / (med / 1e3):.1f}")
    before = solver.solve_fused_compact(data, esc_cap=0)
    b_conv = before["converged"].float().mean().item()
    b_iters = int(before["iterations"].sum().item())
    b_med = time_solves(lambda: solver.solve_fused_compact(data, esc_cap=0),
                        3)
    print(f"fused slice esc_cap=0: converged {b_conv:.6f}; wall ms per "
          f"solve (CUDA events, 3 runs) median {b_med:.3f}; useful "
          f"iterations/s {b_iters / (b_med / 1e3):.1f}")
    return out, launches


def time_solves(fn, runs):
    """Median milliseconds of ``runs`` calls of ``fn`` by CUDA events, each
    timed alone; the times are printed."""
    from ipmzoo_tpu_torch.utils.timer import cuda_time
    t = cuda_time(fn, runs=runs, warmup=0)
    print(f"timing: {runs} runs, ms {[round(x, 3) for x in t.times]}")
    return t.ms


def objective(data, x):
    """1/2 x^T Q x + c^T x per instance, in float64 on the CPU."""
    import torch
    Q = data.Q.cpu().double()
    c = data.c.cpu().double()
    x = x.cpu().double()
    return 0.5 * torch.einsum("bi,bij,bj->b", x, Q, x) + (c * x).sum(-1)


def compare_cpu_fused(data, out):
    """Step 12: the fused slice's objectives against the fused port on the
    CPU in float64 (first 256 instances)."""
    import torch
    from ipmzoo_tpu_torch import Settings
    from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
    from ipmzoo_tpu_torch.models.state import tree_map

    k = 256
    sub = tree_map(lambda a: a[:k].to(device="cpu", dtype=torch.float64),
                   data)
    cpu = FusedBatchedIPM(Settings(), 16, 8, dtype=torch.float64, tol=1e-8,
                          max_iter=30, device="cpu").solve_fused_compact(sub)
    f_cpu = objective(sub, cpu["x"])
    f_gpu = objective(sub, out["x"][:k])
    both = cpu["converged"] & out["converged"][:k].cpu()
    rel = (f_gpu - f_cpu).abs() / (1.0 + f_cpu.abs())
    worst = rel[both].max().item()
    print(f"fused cpu f64 check: {int(both.sum())}/{k} instances converged "
          f"in both; largest |f_gpu - f_cpu| / (1 + |f_cpu|) = {worst:.3e} "
          f"(limit 1e-4)")
    check(bool(cpu["converged"].all()), "CPU f64 fused port did not converge")
    check(int(both.sum()) >= 0.99 * k, "too few instances to compare")
    check(worst <= 1e-4, "fused slice objectives disagree with the CPU f64 "
          "port")


def k1_bound(solver, soa, outs):
    """K1's bound for a launch on the SoA inputs ``soa`` that gave
    ``outs``: its inputs and outputs moved once, and for each iteration
    its instances took the LDL^T factor of the augmented system (N^3/3
    multiply-adds, N the augmented order), two solves (N^2 each) and four
    evaluations of Q x, A x and A^T y."""
    n, a = solver.n, solver.aug_dim
    rows = solver.m_ineq + solver.m_eq
    per_it = 2 * a ** 3 / 3 + 4 * a ** 2 + 4 * (2 * n * n + 4 * rows * n)
    return bound(sum(t.numel() for t in soa) + sum(t.numel() for t in outs),
                 float(outs[2][0].sum()) * per_it, soa[0].dtype)


def time_fused(dev):
    """Step 13: K1's routes alone.

    (a) The thread route, the team route (at its default lanes) and the
    plain version at one cold solve_fused(max_iter=14), float32, at each
    batch of K1_BATCHES, by CUDA events, on SoA inputs made once, with
    K1's bound (k1_bound).

    (b) The thread route and the team route at each size of K1_LANES at
    the fused slice's four launches (recorded as in step 34) and at a
    cold B=32, float32 and float64, by device time: CUDA events around
    three calls behind a leading one, so the host's launch latency hides
    behind the device's work (every launch takes more than 0.1 ms);
    fails where k1_route picks a route whose device time is more than 5%
    (timing noise) above the other's."""
    import torch
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.models.fused_source import team_lanes
    from ipmzoo_tpu_torch.ops import cuda_fused
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    solver = fused_solver(dev, torch.float32)
    out = {}
    for B in K1_BATCHES:
        call = (make_batch(B, 16, 8, torch.float32, device=dev), None, 14, 0)
        soa, _ = solver.soa_inputs(call[0])
        thread = k1_launcher(solver, call, "thread")
        t = {"K1": time_cuda(thread, 10),
             "K1_team": time_cuda(k1_launcher(solver, call, "team"), 10),
             "K1_plain": time_cuda(lambda: solver._fused_plain(
                 soa, None, 14, 0), 2)}
        outs = thread()
        t["bound"] = k1_bound(solver, soa, outs)
        print(f"K1 bound B={B}: {int(outs[2][0].sum())} "
              f"instance-iterations, {t['bound'][0]:.6f} ms by "
              f"{t['bound'][1]}")
        out[B] = t
        print(f"timing K1 cold solve_fused(max_iter=14) B={B} float32 "
              f"(ms per call, CUDA events): thread route {t['K1']:.4f}, "
              f"team route {t['K1_team']:.4f}, plain {t['K1_plain']:.4f}")

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        solver = fused_solver(dev, dtype)
        calls = record_k1_calls(solver, make_batch(B_SLICE, 16, 8, dtype,
                                                   device=dev))
        calls.append((make_batch(32, 16, 8, dtype, device=dev), None, 14, 0))
        srcs = {"thread": solver.kernel_source("thread")}
        srcs.update({f"team{lanes}": src
                     for lanes, src in team_sources(solver).items()})
        default = f"team{team_lanes(solver)}"
        for call in calls:
            t = {k: cuda_time(k1_launcher(
                     solver, call, "thread" if k == "thread" else "team",
                     src), runs=5, calls=3, lead=1).ms
                 for k, src in srcs.items()}
            B = call[0].Q.shape[0]
            route = cuda_fused.k1_route(B, solver.k1_sizes(), dtype)
            print(f"timing K1 routes {name} {k1_call_name(call)} (device ms"
                  f", CUDA events behind a leading launch, median of 5): "
                  + ", ".join(
                      f"{k} {v:.4f}" for k, v in t.items())
                  + f"; k1_route picks {route}")
            picked, other = ((t[default], t["thread"]) if route == "team"
                             else (t["thread"], t[default]))
            check(picked <= 1.05 * other, f"k1_route picks the {route} route "
                  f"at {name} {k1_call_name(call)}, {picked:.4f} ms against "
                  f"{other:.4f}")
            out[(name, k1_call_name(call))] = t
    return out


def block_launcher(solver, call, warps, source=None):
    """One K1 launch of ``call`` on the block route at ``warps`` warps a
    block, built from ``source`` (default the solver's), through the
    wrapper (as k1_launcher)."""
    from ipmzoo_tpu_torch.ops import cuda_fused
    d, state, max_iter, gondzio = call
    soa, warm = solver.soa_inputs(d, state)
    src = source or solver.kernel_source("block")
    total = sum(solver.var_sizes)
    return lambda: cuda_fused.fused_soa(src, soa, warm, solver.n, total,
                                        max_iter, gondzio,
                                        solver.kernel_params(), "block",
                                        warps)


def block_fits(solver, dtype):
    """Whether the block route's block fits the shared memory at
    ``solver``'s sizes in ``dtype`` (the generated code's exact slots)."""
    from ipmzoo_tpu_torch.ops import cuda_fused
    return cuda_fused.block_values(solver.k1_sizes(), solver.k1_slots()) * \
        dtype.itemsize <= cuda_fused.SHARED_CAP


def check_fused_wide(dev):
    """Step 45: K1's wide and block routes against the plain version on
    the card at WIDE_SHAPES (portfolio aug 129, B=1024; the default
    formulation at n=128, m_ineq=64, aug 192, B=512; portfolio aug 257,
    B=256), each a cold solve_fused(max_iter=14), a warm resume
    (max_iter=16) and a cold gondzio=2 solve.  float64 at tol 1e-6:
    iterations equal on every instance and x within 1e-10 (step 10's
    limits).  float32 at the shape's tolerance above its floor
    (WIDE_SHAPES): iterations equal on >= 99% and x within 1e-4 on the
    instances converged in both at equal iterations.  float32 at the
    fused slice's tol 1e-6, at or below these shapes' floor, is printed
    only: there the summation order decides on which iteration some
    instances cross, and one more iteration moves x by up to 1e-2 of its
    largest entry (wide_contraction_spread).  Two launches of the cold
    solve must be bit-identical.

    The block route, wherever its block fits the shared memory (not
    float64 at aug 225 and 257), at the warps K1_BLOCK_RULE gives the shape (4
    where the rule keeps the wide route): held to the plain version the
    same way, two cold launches bit-identical, the cold solve bit-equal
    at every W of BLOCK_WARPS (the row split changes no bit), and, as
    launched, against the wide route as launched: at the gated
    tolerances iterations equal on every instance and x within
    WIDE_ROUTES_X (printed only at float32 tol 1e-6).  The design's gate:
    the two routes' check builds (the generated functions compiled apart,
    APART) give the same bits (all six outputs) at every
    launch, and on the cold solve at every W.  k1_route must pick the
    team route at the fused slice's launches, and above order 128 the
    block route only where it fits.

    At RULE_SHAPES (aug 161 and 225, float64 and float32 at tol 1e-5) the
    block route only against the wide route as launched (W-invariance,
    WIDE_ROUTES_X) and timed.

    Then, at the gated tolerances, each shape's cold max_iter=14 launch
    timed by CUDA events (mean of 3 behind a warm-up) on the wide route
    and on the block route at each W, the plain version in float32 (one
    call; WIDE_SHAPES only) and the bound (k1_bound); k1_route's pick must
    be within 5% of the fastest of them (timing noise).  Returns the timings by shape
    and type, and the largest float32 x difference of each route's gated
    cold launch by (route, shape)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_fused

    for dtype in (torch.float32, torch.float64):
        sizes = fused_solver("cpu", dtype).k1_sizes()
        for B in K1_BATCHES + (32,):
            route = cuda_fused.k1_route(B, sizes, dtype)
            check(route == "team", f"k1_route takes the {route} route at "
                  f"the fused slice's B={B} {dtype}")
    times, errs = {}, {}
    fields = ("x", "variables", "iterations")
    for shape in WIDE_SHAPES + RULE_SHAPES:
        n, m, e, B, tol32 = shape
        held = shape in WIDE_SHAPES
        for dtype, tol, gate in ((torch.float64, 1e-6, None),
                                 (torch.float32, tol32,
                                  ("iterations", "x at equal iterations")),
                                 (torch.float32, 1e-6, ())):
            if gate == () and not held:
                continue
            solver, data = wide_case(n, m, e, B, dtype, dev, tol)
            sizes, slots = solver.k1_sizes(), solver.k1_slots()
            route = cuda_fused.k1_route(B, sizes, dtype, slots)
            fits = block_fits(solver, dtype)
            warps = cuda_fused.block_warps(sizes, dtype, slots) or 4
            name = (f"n={n} m_ineq={m} m_eq={e} aug {solver.aug_dim} B={B} "
                    f"{str(dtype).replace('torch.', '')} tol={tol:g}")
            check(route in ("wide", "block") and (fits or route == "wide"),
                  f"k1_route takes the {route} route at {name}")
            cold_call = (data, None, 14, 0)
            cold = solver.soa_result(k1_launcher(solver, cold_call,
                                                 "wide")())
            state = {k: cold[k] for k in ("variables", "mu", "iterations")}
            calls = (("cold max_iter=14", cold_call),
                     ("warm resume max_iter=16", (data, state, 16, 0)),
                     ("cold gondzio=2", (data, None, 14, 2)))
            routes = [("wide", lambda c: k1_launcher(solver, c, "wide"))]
            if fits:
                routes.append((f"block W={warps}",
                               lambda c: block_launcher(solver, c, warps)))
                ks = [solver.soa_result(block_launcher(solver, cold_call,
                                                       w)())
                      for w in BLOCK_WARPS]
                check(all(torch.equal(k[f], ks[0][f]) for k in ks
                          for f in fields), f"{name}: the block route's "
                      f"cold solve differs between W={BLOCK_WARPS}")
                dx = (ks[0]["x"] - cold["x"]).abs().max().item()
                same = int((ks[0]["iterations"] == cold["iterations"]).sum())
                limit = WIDE_ROUTES_X[str(dtype).replace("torch.", "")]
                print(f"K1 block route {name}: cold max_iter=14 bit-equal "
                      f"at W={BLOCK_WARPS}; against the wide route as "
                      f"launched: iterations equal on {same}/{B}, largest "
                      f"|x - x_wide| {dx:.3e}"
                      + ("" if gate == () else f" (limit {limit:g})")
                      + ", bit-equal "
                      f"{all(torch.equal(ks[0][f], cold[f]) for f in fields)}")
                check(gate == () or (same == B and dx <= limit),
                      f"{name}: the block route as launched parts from the "
                      f"wide route as launched: iterations equal on "
                      f"{same}/{B}, largest |x - x_wide| {dx:.3e} against "
                      f"{limit:g}")
                if held:
                    check_apart(solver, calls, name)
            for what, call in calls if held else ():
                p = solver.soa_result(solver._fused_plain(
                    *solver.soa_inputs(*call[:2]), *call[2:]))
                for label, launch in routes:
                    k = solver.soa_result(launch(call)())
                    if call is cold_call:
                        k2 = solver.soa_result(launch(call)())
                        check(all(torch.equal(k[f], k2[f]) for f in fields),
                              f"{name}: two launches of the cold solve on "
                              f"the {label} route differ")
                    torch.cuda.synchronize()
                    err = hold_k1(f"K1 {label} route vs plain {name} {what}"
                                  + (" (not gated)" if gate == () else ""),
                                  k, p, dtype, tol, gate)
                    if what.startswith("cold max") and gate:
                        errs[(label.split()[0], n, m, e, B)] = err
            if gate == ():
                continue
            soa, _ = solver.soa_inputs(data)
            wide = k1_launcher(solver, cold_call, "wide")
            t = {"K1_wide": time_cuda(wide, 3),
                 "bound": k1_bound(solver, soa, wide())}
            if fits:
                for w in BLOCK_WARPS:
                    t[f"K1_block{w}"] = time_cuda(
                        block_launcher(solver, cold_call, w), 3)
                t["K1_block"] = t[f"K1_block{warps}"]
            if dtype == torch.float32 and held:
                t["K1_plain"] = time_cuda(lambda: solver._fused_plain(
                    soa, None, 14, 0), 1)
            routes_ms = {k[3:]: v for k, v in t.items()
                         if k.startswith("K1_") and k != "K1_plain"
                         and k != "K1_block"}
            picked = t["K1_block"] if route == "block" else t["K1_wide"]
            print(f"timing K1 wide routes cold solve_fused(max_iter=14) "
                  f"{name} (ms per call, CUDA events): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in routes_ms.items()) +
                  (f", plain {t['K1_plain']:.4f}" if "K1_plain" in t
                   else "") +
                  f"; bound {t['bound'][0]:.6f} ms by {t['bound'][1]}; "
                  f"k1_route picks {route}"
                  + (f" at W={warps}" if route == "block" else ""))
            check(picked <= 1.05 * min(routes_ms.values()),
                  f"k1_route picks the {route} route at {name}: "
                  f"{picked:.4f} ms against {routes_ms}")
            times[(n, m, e, B, str(dtype).replace("torch.", ""))] = t
    return times, errs


def check_apart(solver, calls, name):
    """Step 45's gate on the design: the block route's check build gives
    the wide route's check build's bits (x, variables, iterations,
    residual, gap, mu) at each of ``calls``, and on the first (cold) at
    every W of BLOCK_WARPS.  Check builds compile each generated function
    apart, so both kernels run the same machine code for everything but
    the factor and where the work arrays live."""
    import torch
    wide_src = apart(solver.kernel_source("wide"))
    block_src = apart(solver.kernel_source("block"))
    for i, (what, call) in enumerate(calls):
        w = k1_launcher(solver, call, "wide", wide_src)()
        for warps in (BLOCK_WARPS if i == 0 else (4,)):
            b = block_launcher(solver, call, warps, block_src)()
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(b, w)),
                  f"{name} {what}: the block route's check build at "
                  f"W={warps} differs from the wide route's")
    print(f"K1 check builds (generated functions apart) {name}: the block "
          f"route gives the wide route's bits at {len(calls)} launches "
          f"(the cold one at W={BLOCK_WARPS})")


def wide_contraction_spread(dev=None):
    """What step 45's float32 spread comes from (run alone, not by
    main()): at each WIDE_SHAPES row and float32 tol 1e-6, 1e-5 and 1e-4,
    a cold solve_fused(max_iter=14) by K1's wide route as step 9 builds it
    and as built without FMA contraction (nvcc --fmad=false), each held
    to the plain version on the card, and the plain version on the card
    held to the plain version on the CPU (the first 128 instances), all
    printed by hold_k1 with no gate."""
    import torch
    from chip_roofline import banner, build_all
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.ops import _build, cuda_fused
    dev = dev or banner("chip_smoke", "the spread is measured")
    every = wide_sources()
    srcs = {shape[:3]: every[shape[:3]] for shape in WIDE_SHAPES}
    # the text names the flag, so the library cache keys the build apart
    plain_flags = _build.NVCC_FLAGS
    _build.NVCC_FLAGS = plain_flags + ("--fmad=false",)
    try:
        nofma = {k: t + "\n// built with --fmad=false\n"
                 for k, t in srcs.items()}
        build_all({f"nofma{k}": lambda t=t: cuda_fused.library(
            t, "fused_wide") for k, t in nofma.items()})
    finally:
        _build.NVCC_FLAGS = plain_flags
    build_all({f"wide{k}": lambda t=t: cuda_fused.library(t, "fused_wide")
               for k, t in srcs.items()})
    for n, m, e, B, _ in WIDE_SHAPES:
        for tol in (1e-6, 1e-5, 1e-4):
            solver, data = wide_case(n, m, e, B, torch.float32, dev, tol)
            name = (f"n={n} m_ineq={m} m_eq={e} aug {solver.aug_dim} B={B} "
                    f"float32 tol={tol:g} cold max_iter=14")
            call = (data, None, 14, 0)
            p = solver.soa_result(solver._fused_plain(
                *solver.soa_inputs(data), 14, 0))
            for what, src in (("FMA", srcs[(n, m, e)]),
                              ("no FMA", nofma[(n, m, e)])):
                k = solver.soa_result(k1_launcher(solver, call, "wide",
                                                  src)())
                torch.cuda.synchronize()
                hold_k1(f"spread: K1 wide route ({what}) vs plain {name}", k,
                        p, torch.float32, tol, ())
            sub = tree_map(lambda a: a[:128].cpu(), data)
            cpu = wide_case(n, m, e, 128, torch.float32, "cpu", tol)[0]
            c = cpu.soa_result(cpu._fused_plain(*cpu.soa_inputs(sub), 14, 0))
            hold_k1(f"spread: plain on the card vs on the CPU {name}, first "
                    f"128", {f: v[:128].cpu() for f, v in p.items()}, c,
                    torch.float32, tol, ())


def plain_batch_spread(n=160, B=64, device="cpu"):
    """Why aug 161 is a RULE_SHAPES row (run alone, not by main(); the
    CPU by default): portfolio(n_assets=n, batch=B, seed=0), a cold
    solve_fused(max_iter=14, gondzio=2) at tol 1e-5 by the plain version
    in float32, held to the plain version in float64, over the whole
    batch (padded to the solver's tile, bt=512) and again in batches of 8
    (bt=8); prints the largest difference in x (of the largest |x|) of
    each run and its instance."""
    import torch
    from ipmzoo_tpu_torch.models.state import tree_map
    s64, d64 = wide_case(n, 0, 1, B, torch.float64, device, 1e-5)
    s32, d32 = wide_case(n, 0, 1, B, torch.float32, device, 1e-5)
    ref = s64.solve_fused(d64, max_iter=14, gondzio=2)["x"]
    scale = ref.abs().max().item()
    x = s32.solve_fused(d32, max_iter=14, gondzio=2)["x"].double()
    eight = wide_case(n, 0, 1, 8, torch.float32, device, 1e-5)[0]
    eight.bt = 8
    parts = [eight.solve_fused(tree_map(lambda a, i=i: a[i:i + 8], d32),
                               max_iter=14, gondzio=2)["x"].double()
             for i in range(0, B, 8)]
    worst = None
    for what, got in ((f"the batch of {B} padded to {s32.bt}", x),
                      ("batches of 8", torch.cat(parts))):
        d = (got - ref).abs().max(dim=1).values / scale
        worst = int(d.argmax()) if worst is None else worst
        print(f"plain float32 vs float64, aug {n + 1} portfolio seed 0 "
              f"tol 1e-5 gondzio=2, {what}: largest x difference "
              f"{d.max().item():.3e} at instance {int(d.argmax())}, "
              f"{d[worst].item():.3e} at instance {worst}")


#: the wide slice's wall with K1 on the wide route, before the block
#: route (H100 80GB HBM3 at 700 W, PERF.md section 6): ms per solve, low
#: and high
WIDE_ROUTE_SLICE_MS = (62.383, 63.158)


def run_wide_slice(dev):
    """Step 46: the wide slice, FusedBatchedIPM(portfolio settings,
    n=128, m_eq=1, float32, tol=1e-6).solve_fused_compact() (the default
    schedule, esc_cap=32) on portfolio(n_assets=128, batch=WIDE_SLICE_B,
    seed=0), launch counts set to 0 just before and read just after: >=
    99.9% converged, finite x, K1 launched on the route k1_route picks
    (the block route at aug 129 in float32 where K1_BLOCK_RULE takes it)
    and on no other; objectives within 1e-4 (1 + |f|) of the port's CPU
    float64 solve on the first 64 instances; the wall by CUDA events
    (median of 5 after the counted run) beside WIDE_ROUTE_SLICE_MS,
    launches by route and host syncs.  Then the
    same solve with every instance left a straggler after three fused
    iterations (schedule [(3, 1)], no fused tail): the float64 escalation
    and the Gondzio tail factor by the panel-blocked LDL^T (its panels on
    K2); printed, and it must launch that path.  Returns the counted
    run's launches by route and its wall."""
    import torch
    from ipmzoo_tpu_torch.models.families import portfolio
    from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.ops import cuda_fused, cuda_ldlt

    n, B = 128, WIDE_SLICE_B
    fam = portfolio(n_assets=n, batch=B, seed=0, dtype=torch.float32,
                    device=dev)
    solver = FusedBatchedIPM(fam.settings, n, 0, 1, dtype=torch.float32,
                             tol=1e-6, device=dev)
    route = cuda_fused.k1_route(B, solver.k1_sizes(), torch.float32,
                                solver.k1_slots())
    solver.kernel_source(route)
    cuda_fused.reset_launch_counts()
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    out = solver.solve_fused_compact(fam.data)
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**cuda_fused.route_launches,
                                  **cuda_ldlt.route_launches}.items() if v}
    syncs = solver.host_syncs
    x = out["x"]
    conv = out["converged"].float().mean().item()
    print(f"wide slice: portfolio n_assets={n} aug {solver.aug_dim} B={B} "
          f"float32 tol=1e-6 max_iter={solver.max_iter} schedule "
          f"{solver.default_fused_schedule(B)} esc_cap=32: converged "
          f"{conv:.6f} ({int(out['converged'].sum())}/{B}), iterations "
          f"{int(out['iterations'].sum().item())}; launches by route "
          f"{launches}; escalated instances {int(solver.escalated)}; host "
          f"syncs {syncs}")
    check(tuple(x.shape) == (B, n), f"wide slice x shape {tuple(x.shape)}")
    check(bool(torch.isfinite(x).all()), "wide slice: non-finite x")
    check(conv >= 0.999, f"wide slice convergence {conv} < 0.999")
    check(launches.get(f"fused {route}", 0) > 0, f"the wide slice never "
          f"launched K1's {route} route")
    check(all(not v for k, v in launches.items() if k.startswith("fused ")
              and k != f"fused {route}"), f"the wide slice launched K1 off "
          f"the {route} route: {launches}")
    med = time_solves(lambda: solver.solve_fused_compact(fam.data), 5)
    print(f"wide slice: wall ms per solve (CUDA events, 5 runs after the "
          f"counted one) median {med:.3f} on the {route} route (on the "
          f"wide route: {WIDE_ROUTE_SLICE_MS[0]}-{WIDE_ROUTE_SLICE_MS[1]})")

    k = 64
    sub = tree_map(lambda a: a[:k].to(device="cpu", dtype=torch.float64),
                   fam.data)
    cpu = FusedBatchedIPM(fam.settings, n, 0, 1, dtype=torch.float64,
                          tol=1e-8, bt=k, device="cpu").solve_fused_compact(sub)
    f_cpu = objective(sub, cpu["x"])
    f_gpu = objective(sub, x[:k])
    both = cpu["converged"] & out["converged"][:k].cpu()
    worst = ((f_gpu - f_cpu).abs() / (1.0 + f_cpu.abs()))[both].max().item()
    print(f"wide slice cpu f64 check: {int(both.sum())}/{k} instances "
          f"converged in both; largest |f_gpu - f_cpu| / (1 + |f_cpu|) = "
          f"{worst:.3e} (limit 1e-4)")
    check(bool(cpu["converged"].all()), "CPU f64 wide port did not converge")
    check(int(both.sum()) >= 0.99 * k, "too few instances to compare")
    check(worst <= 1e-4, "wide slice objectives disagree with the CPU f64 "
          "port")

    cuda_fused.reset_launch_counts()
    cuda_ldlt.reset_launch_counts()
    tail = solver.solve_fused_compact(fam.data, schedule=[(3, 1)],
                                      fused_tail=False)
    torch.cuda.synchronize()
    t_launches = {k: v for k, v in {**cuda_fused.route_launches,
                                    **cuda_ldlt.route_launches}.items()
                  if v}
    print(f"wide slice, stragglers forced (schedule [(3, 1)], no fused "
          f"tail): converged {int(tail['converged'].sum())}/{B} (the "
          f"escalation takes 32, the Gondzio tail 128); launches by route "
          f"{t_launches}")
    check(t_launches.get("ldlt blocked", 0) > 0 and
          t_launches.get("ldlt block", 0) > 0, "the escalation and the tail "
          "did not factor by the panel-blocked LDL^T on K2")
    check(bool(torch.isfinite(tail["x"]).all()), "forced stragglers: "
          "non-finite x")
    return launches, med


def schur_data(dev):
    """bench_torch.py's Schur instances (bench.py's bench_schur): numpy
    seeds 0..SCHUR_I-1, each SCHUR_BLOCKS blocks of n=SCHUR_N with SCHUR_MC
    coupling rows, cast to float32, stacked on a leading instance axis."""
    import bench_torch
    return bench_torch.schur_data(dev, SCHUR_I, SCHUR_BLOCKS, SCHUR_N,
                                  SCHUR_MC)


def run_schur(dev, data, tol, runs):
    """Steps 14 and 15: the Schur slice through SchurIPM.solve_batch."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.parallel import SchurIPM

    solver = SchurIPM(SCHUR_N, SCHUR_MC, dtype=torch.float32, tol=tol,
                      refine=2, max_iter=60, device=dev)
    work = str(solver.compute_dtype).replace("torch.", "")
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    res = solver.solve_batch(data)
    torch.cuda.synchronize()
    launches = dict(cuda_ldlt.launches)
    f64 = dict(cuda_ldlt.f64_launches)
    routes = dict(cuda_ldlt.route_launches)
    syncs = solver.host_syncs

    shape = (SCHUR_I, SCHUR_BLOCKS, SCHUR_N)
    check(tuple(res.x.shape) == shape, f"schur x shape {res.x.shape}")
    check(bool(torch.isfinite(res.x).all()), "schur: non-finite x")
    check(bool(torch.isfinite(res.objective).all()),
          "schur: non-finite objective")
    conv = res.converged.float().mean().item()
    iters = int(res.iterations.sum().item())
    steps = int(res.iterations.max().item())
    print(f"schur slice: {SCHUR_I} instances x {SCHUR_BLOCKS} blocks x "
          f"n={SCHUR_N}, m_c={SCHUR_MC}, float32 tol={tol:g} "
          f"two_float={solver.two_float} (solved in {work}), block kernel "
          f"{solver.block_kernel}: converged {conv:.6f}, iterations "
          f"{res.iterations.tolist()}")
    print(f"schur slice: launches K2 {launches['ldlt']} K3 "
          f"{launches['solve_ldlt']} K4 {launches['solve_ldlt_matrix']} "
          f"(float64: {f64['ldlt']} / {f64['solve_ldlt']} / "
          f"{f64['solve_ldlt_matrix']}); host syncs {syncs}")
    work_t = solver.compute_dtype
    print(f"schur slice: K2 routes: SoA {routes['ldlt soa']}, block "
          f"{routes['ldlt block']} (k2_route at the H blocks: "
          f"{cuda_ldlt.k2_route(SCHUR_N, SCHUR_I * SCHUR_BLOCKS, work_t)}, "
          f"at S: {cuda_ldlt.k2_route(SCHUR_MC, SCHUR_I, work_t)})")
    print(f"schur slice: K3 routes: thread {routes['solve_ldlt thread']}, "
          f"warp {routes['solve_ldlt warp']} (k3_route at the H blocks: "
          f"{cuda_ldlt.k3_route(SCHUR_N, SCHUR_I * SCHUR_BLOCKS, work_t)}, "
          f"at S: {cuda_ldlt.k3_route(SCHUR_MC, SCHUR_I, work_t)})")
    check(routes["ldlt soa"] + routes["ldlt block"] == launches["ldlt"],
          "schur slice: K2's route counts do not add up")
    check(routes["solve_ldlt thread"] + routes["solve_ldlt warp"] ==
          launches["solve_ldlt"], "schur slice: K3's route counts do not "
          "add up")
    check(routes["solve_ldlt warp"] > 0, "schur slice: K3's warp route "
          "never launched")
    k4_pick = cuda_ldlt.k4_route(SCHUR_N, SCHUR_MC, SCHUR_I * SCHUR_BLOCKS,
                                 work_t)
    print(f"schur slice: K4 routes: thread "
          f"{routes['solve_ldlt_matrix thread']}, warp "
          f"{routes['solve_ldlt_matrix warp']} (k4_route at the H blocks: "
          f"{k4_pick})")
    check(routes[f"solve_ldlt_matrix {k4_pick}"] ==
          launches["solve_ldlt_matrix"], "schur slice: K4's launches are "
          f"not all on the route k4_route picks ({k4_pick})")
    check(conv >= 0.99, f"schur convergence {conv} < 0.99")
    for k in ("ldlt", "solve_ldlt", "solve_ldlt_matrix"):
        check(launches[k] > 0, f"the schur slice never launched {k}")
        wanted = launches[k] if solver.two_float else 0
        check(f64[k] == wanted, f"schur slice: {f64[k]} float64 launches "
              f"of {k}, expected {wanted}")

    solver.solve_batch(data)
    med = time_solves(lambda: solver.solve_batch(data), runs)
    print(f"schur slice tol={tol:g}: wall ms per solve (CUDA events, "
          f"{runs} runs) median {med:.3f}; ms per iteration "
          f"{med / steps:.3f}; useful iterations/s {iters / (med / 1e3):.1f}")
    return res, {**launches, **routes}


def compare_cpu_schur(data, res):
    """Step 16: the Schur slice's objectives against the port on the CPU
    in float64."""
    import torch
    from ipmzoo_tpu_torch.parallel import SchurIPM

    cpu = SchurIPM(SCHUR_N, SCHUR_MC, dtype=torch.float64, tol=1e-8,
                   refine=2, max_iter=60, device="cpu").solve_batch(
                       data.to(device="cpu", dtype=torch.float64))
    f_cpu = cpu.objective
    f_gpu = res.objective.cpu().double()
    rel = (f_gpu - f_cpu).abs() / (1.0 + f_cpu.abs())
    print(f"schur cpu f64 check: converged {int(cpu.converged.sum())}/"
          f"{SCHUR_I} on the CPU; largest |f_gpu - f_cpu| / (1 + |f_cpu|)"
          f" = {rel.max().item():.3e} (limit 1e-6); f_cpu "
          f"{[round(f, 6) for f in f_cpu.tolist()]}")
    check(bool(cpu.converged.all()), "CPU f64 Schur port did not converge")
    check(bool((rel <= 1e-6).all()), "schur objectives disagree with the "
          "CPU f64 port")


def check_schur_kernels(dev, data):
    """Step 17: K2, K3 and K4 against their plain versions at the shapes
    the Schur slice gives them, float32 and float64, and their times.

    The matrices are the slice's own at its initial iterate: the H blocks
    Q + 2/3 I (n=64, B=512; K4 on the panel's k=16 columns of F^T) and
    the coupling systems S = F H^-1 F^T + delta I built from them (n=16,
    B=8).  K3 and K4 solve against the plain factors, so each kernel is
    held alone; limits and measure as step 4."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import ldlt, solve_ldlt, solve_ldlt_matrix

    B, n, k = SCHUR_I * SCHUR_BLOCKS, SCHUR_N, SCHUR_MC
    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        name = str(dtype).replace("torch.", "")
        H = (data.Q.reshape(B, n, n) + (2.0 / 3.0) * torch.eye(
            n, device=data.Q.device)).to(dtype)
        R = data.F.reshape(B, k, n).transpose(1, 2).to(dtype)
        r = R[:, :, 0].contiguous()
        L0, D0 = ldlt(H)
        X0 = solve_ldlt_matrix(L0, D0, R)
        S = torch.einsum("abij,abjk->aik", data.F.to(dtype),
                         X0.reshape(SCHUR_I, SCHUR_BLOCKS, n, k)) + \
            1e-8 * torch.eye(k, dtype=dtype, device=dev)
        LS0, DS0 = ldlt(S)
        g = data.g.to(dtype)
        L, D = cuda_ldlt.ldlt_auto(H)
        LS, DS = cuda_ldlt.ldlt_auto(S)
        diffs = {
            f"K2 n={n} B={B} L": rel_diff(L, L0),
            f"K2 n={n} B={B} D": rel_diff(D, D0),
            f"K3 n={n} B={B} x": rel_diff(
                cuda_ldlt.solve_ldlt_auto(L0, D0, r), solve_ldlt(L0, D0, r)),
            f"K4 n={n} k={k} B={B} X": rel_diff(
                cuda_ldlt.solve_ldlt_matrix_auto(L0, D0, R), X0),
            **{f"K4 {route} route n={n} k={k} B={B} X": rel_diff(
                k4_call(route, L0.permute(1, 2, 0).contiguous(),
                        D0.t().contiguous(), R.contiguous()), X0)
               for route in k4_routes(n, k, dtype)},
            f"K2 S n={k} B={SCHUR_I} L": rel_diff(LS, LS0),
            f"K2 S n={k} B={SCHUR_I} D": rel_diff(DS, DS0),
            f"K3 S n={k} B={SCHUR_I} x": rel_diff(
                cuda_ldlt.solve_ldlt_auto(LS0, DS0, g),
                solve_ldlt(LS0, DS0, g)),
        }
        print(f"kernels schur {name}: rel diff " + ", ".join(
            f"{a} {v:.3e}" for a, v in diffs.items()) + f" (limit {tol:g})")
        for what, v in diffs.items():
            check(v <= tol, f"{what.split()[0]} disagrees with its plain "
                  f"version at the Schur shape in {name} ({what}): "
                  f"{v:.3e} > {tol:g}")

        # K2 by the route ldlt_auto takes, and both routes alone
        L, D = cuda_ldlt.ldlt_auto(H)
        L_t, D_t = L.permute(1, 2, 0), D.t()
        check(L_t.is_contiguous() and D_t.is_contiguous(),
              "ldlt_auto's factors are not views of SoA storage")
        R_t, r_t = R.permute(1, 2, 0).contiguous(), r.t().contiguous()
        R_c = R.contiguous()
        t = time_k2_routes(dev, n, B, dtype, A=H)
        t["route"] = cuda_ldlt.k2_route(n, B, dtype)
        t["K2"] = time_cuda(lambda: cuda_ldlt.ldlt_auto(H), 20)
        t["S"] = time_k2_routes(dev, k, SCHUR_I, dtype, A=S)
        chol = torch.linalg.cholesky_ex(H)
        check(int(chol.info.abs().max()) == 0, "the H blocks are not SPD")
        t["K2_library"] = time_cuda(lambda: torch.linalg.cholesky_ex(H), 20)
        print(f"library call torch.linalg.cholesky_ex n={n} B={B} {name}: "
              f"{t['K2_library']:.4f} ms per call (nearest library call, not "
              f"the same function: LL^T, SPD only)")
        t.update({
            "K3": time_cuda(lambda: cuda_ldlt.solve_soa(L_t, D_t, r_t), 20),
            "K3_warp": time_cuda(
                lambda: cuda_ldlt.solve_soa_warp(L_t, D_t, r_t), 20),
            "K3_plain": time_cuda(lambda: solve_ldlt(L0, D0, r), 3),
            "K4": time_cuda(lambda: cuda_ldlt.solve_matrix_soa(L_t, D_t,
                                                               R_t), 20),
            "K4_warp": time_cuda(
                lambda: cuda_ldlt.solve_matrix_warp(L_t, D_t, R_c), 20),
            "K4_plain": time_cuda(lambda: solve_ldlt_matrix(L0, D0, R), 3),
        })
        if dtype == torch.float64:
            t["K3_library"] = time_library(
                f"torch.linalg.ldl_solve (K3's function) n={n} B={B} {name}",
                ldl_solve_call(L0, D0, r), solve_ldlt(L0, D0, r), 1e-10, 2)
            t["K4_library"] = time_library(
                f"torch.linalg.ldl_solve (K4's function) n={n} k={k} B={B} "
                f"{name}", ldl_solve_call(L0, D0, R), X0, 1e-10, 2)
        out[name] = t
        print(f"timing schur shape n={n} k={k} B={B} {name} (ms per call, "
              f"CUDA events; K2 by ldlt_auto's {t['route']} route): " +
              ", ".join(f"{a} {v:.4f}" for a, v in t.items()
                        if isinstance(v, float)))
    return out


def spd_block_tridiag(B, N, b, dtype, device, seed):
    """B well-conditioned SPD block-tridiagonal systems: diagonal blocks
    M M^T / b + 4 I, sub-diagonal blocks of norm about 0.6."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, N, b, b))
    D = np.einsum("anij,ankj->anik", M, M) / b + 4.0 * np.eye(b)
    E = rng.normal(size=(B, N - 1, b, b)) * (0.3 / np.sqrt(b))
    return (torch.tensor(D).to(dtype).to(device),
            torch.tensor(E).to(dtype).to(device))


def block_tridiag_dense(D, E):
    """The dense matrix of one block-tridiagonal system."""
    import torch
    N, b = D.shape[0], D.shape[-1]
    K = torch.zeros((N * b, N * b), dtype=D.dtype, device=D.device)
    for i in range(N):
        K[i * b:(i + 1) * b, i * b:(i + 1) * b] = D[i]
    for i in range(N - 1):
        K[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = E[i]
        K[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = E[i].T
    return K


def k6_calls(N, b, dtype):
    """K6's routes that can run N blocks of order b in ``dtype``, by
    name: "block", and "cluster8" / "cluster16" for each cluster size
    that fits."""
    from ipmzoo_tpu_torch.ops import cuda_cr
    calls = {"block": cuda_cr.cr_factor_kernel}
    for C in cuda_cr.CLUSTER_SIZES:
        if cuda_cr.cluster_fits(N, b, C, dtype):
            calls[f"cluster{C}"] = (lambda D, E, C=C:
                                    cuda_cr.cr_factor_cluster(D, E, C))
    return calls


def k6_pick(N, b, B, dtype):
    """The K6 route, by k6_calls' names, that k6_route and k6_cluster
    pick."""
    from ipmzoo_tpu_torch.ops import cuda_cr
    if cuda_cr.k6_route(N, b, B, dtype) == "block":
        return "block"
    return f"cluster{cuda_cr.k6_cluster(N, b, B, dtype)}"


def k7_calls(N, b, k, B, dtype):
    """K7's routes that can run (N, b, k) in ``dtype``, by name: "block",
    and "shared" at the columns k7_route picks and "shared kc" at one
    group of every column that fits (where that differs)."""
    from ipmzoo_tpu_torch.ops import cuda_cr
    calls = {"block": cuda_cr.cr_solve_kernel}
    route, kc = cuda_cr.k7_route(N, b, k, B, dtype)
    if route == "shared":
        calls["shared"] = lambda f, r, kc=kc: cuda_cr.cr_solve_shared(f, r,
                                                                      kc)
        top = min(k, cuda_cr.solve_shared_max_kc(N, b, dtype))
        if top != kc:
            calls[f"shared kc={top}"] = (
                lambda f, r, kc=top: cuda_cr.cr_solve_shared(f, r, kc))
    return calls


def hold_cr(what, D, E, r, errs=None):
    """K6 (each route) and K7 (each route) against their plain versions
    on (D, E, r): the factors, each K7 route alone on the plain factors,
    and each K6 route + each K7 route chained.  float64 within a relative
    difference of 1e-10 everywhere; float32 within 5e-4 absolute on the
    solutions and 1e-4 relative on the factors.  Returns (plain factors,
    plain solution)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_cr
    from ipmzoo_tpu_torch.ops.cr import cr_factor_plain, cr_solve_plain

    name = str(D.dtype).replace("torch.", "")
    N, b, k = r.shape[-3:]
    B = D.numel() // (N * b * b)
    f0 = cr_factor_plain(D, E)
    x0 = cr_solve_plain(f0, r)
    check(bool(torch.isfinite(x0).all()), f"{what}: plain solution not "
          f"finite")

    def held(label, x, rf=0.0):
        rx = rel_diff(x, x0)
        ax = (x - x0).abs().max().item()
        if D.dtype == torch.float64:
            check(max(rf, rx) <= 1e-10, f"K6/K7 ({label}) disagree with "
                  f"their plain versions in float64 ({what}): "
                  f"{max(rf, rx):.3e} > 1e-10")
        else:
            check(ax <= 5e-4, f"K6/K7 ({label}) disagree with their plain "
                  f"versions in float32 ({what}): {ax:.3e} > 5e-4")
        return rx, ax

    solves = k7_calls(N, b, k, B, D.dtype)
    alone = {}
    for r7, solve in solves.items():
        x = solve(f0, r)
        torch.cuda.synchronize()
        alone[r7] = held(f"K7 {r7} alone", x)
        print(f"kernels {what} {name}: K7 {r7} route on plain factors rel "
              f"diff x {alone[r7][0]:.3e} (abs {alone[r7][1]:.3e})")
    pick6 = k6_pick(N, b, B, D.dtype)
    xs = {}
    for r6, call in k6_calls(N, b, D.dtype).items():
        f = call(D, E)
        torch.cuda.synchronize()
        rf = max(rel_diff(a, a0) for a, a0 in zip(f, f0))
        af = max((a - a0).abs().max().item() for a, a0 in zip(f, f0))
        if D.dtype == torch.float32:
            check(rf <= 1e-4, f"K6's {r6} float32 factors differ from the "
                  f"plain version's by {rf:.3e} ({what})")
        chained = []
        for r7, solve in solves.items():
            xs[(r6, r7)] = solve(f, r)
            torch.cuda.synchronize()
            rc, ac = held(f"{r6} + K7 {r7}", xs[(r6, r7)], rf)
            chained.append(f"+ K7 {r7} rel diff x {rc:.3e} (abs {ac:.3e})")
        print(f"kernels {what} {name}: K6 {r6} route factors rel diff "
              f"{rf:.3e} (abs {af:.3e}); " + ", ".join(chained))
        if errs is not None:
            key = "cr_factor" if r6 == "block" else \
                ("cr_factor cluster" if r6 == pick6 else None)
            if key:
                errs[key] = af
    if errs is not None:
        errs["cr_solve"] = alone["block"][1]
        if "shared" in alone:
            errs["cr_solve shared"] = alone["shared"][1]
    # through the wrappers: the routes k6_route and k7_route pick, one
    # launch each
    before = dict(cuda_cr.route_launches)
    f = cuda_cr.cr_factor_auto(D, E)
    x = cuda_cr.cr_solve_auto(f, r)
    torch.cuda.synchronize()
    made = {a: v - before[a] for a, v in cuda_cr.route_launches.items()
            if v != before[a]}
    want6 = "cluster" if pick6 != "block" else "block"
    pick7 = cuda_cr.k7_route(N, b, k, B, D.dtype)[0]
    check(made == {f"cr_factor {want6}": 1, f"cr_solve {pick7}": 1},
          f"{what}: cr_factor_auto / cr_solve_auto launched {made}, "
          f"k6_route picks {pick6} and k7_route {pick7}")
    check(torch.equal(x, xs[(pick6, pick7)]), f"{what}: the wrappers differ "
          f"from their routes {pick6} and {pick7} launched alone")
    return f0, x0


def check_cr(dev):
    """Step 18: K6/K7 against their plain versions on the card."""
    import torch

    for dtype in (torch.float32, torch.float64):
        for B, N, b, k in CR_SHAPES + CR_EDGES:
            D, E = spd_block_tridiag(B, N, b, dtype, dev, seed=N + b + k)
            r = torch.randn((B, N, b, k), dtype=dtype, device=dev,
                            generator=torch.Generator(dev).manual_seed(k))
            if B == 1:      # without the batch axis too
                D, E, r = D[0], E[0], r[0]
            _, x0 = hold_cr(f"B={B} N={N} b={b} k={k}", D, E, r)
            if B == 1 and N * b <= 512:
                from ipmzoo_tpu_torch.ops import cuda_cr
                xd = torch.linalg.solve(block_tridiag_dense(D, E),
                                        r.reshape(N * b, k))
                x = cuda_cr.cr_solve_auto(cuda_cr.cr_factor_auto(D, E), r)
                rd = rel_diff(x.reshape(N * b, k), xd)
                tol = 1e-10 if dtype == torch.float64 else 1e-4
                print(f"kernels N={N} b={b} k={k} "
                      f"{str(dtype).replace('torch.', '')}: K6+K7 against "
                      f"torch.linalg.solve of the dense system, rel diff "
                      f"{rd:.3e} (limit {tol:g})")
                check(rd <= tol, f"K6+K7 disagree with the dense solve: "
                      f"{rd:.3e} > {tol:g}")


def arrow_problem():
    """bench_torch.py's arrow QP (bench.py's bench_arrow at its defaults,
    numpy seed 0): n=4096, half-bandwidth 16, tip 8, float32, bounds
    +-1."""
    import bench_torch
    return bench_torch.arrow_problem(ARROW_N, ARROW_BW, ARROW_TIP)


def run_arrow(what, solve, solver, cpu_solve, n_inst):
    """Steps 19 and 20: one line of the banded+arrow slice.  ``solve``
    runs it on the card, ``cpu_solve`` the port on the CPU in float64."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_cr

    cuda_cr.reset_launch_counts()
    solver.host_syncs = 0
    res = solve()
    torch.cuda.synchronize()
    launches = dict(cuda_cr.launches)
    f64 = dict(cuda_cr.f64_launches)
    syncs = solver.host_syncs

    x = res.x.reshape(n_inst, -1)
    check(tuple(x.shape) == (n_inst, ARROW_N), f"{what}: x shape "
          f"{tuple(res.x.shape)}")
    check(bool(torch.isfinite(x).all()), f"{what}: non-finite x")
    check(bool(((x >= -1.0) & (x <= 1.0)).all()), f"{what}: x leaves its "
          f"bounds")
    its = res.iterations.reshape(n_inst)
    conv = res.converged.reshape(n_inst)
    steps = int(its.max())
    print(f"{what}: n={ARROW_N} bandwidth={ARROW_BW} tip={ARROW_TIP} "
          f"float32 tol=1e-5, N={solver.N} blocks of {solver.b}, "
          f"t={solver.t}, method {solver.method}: converged "
          f"{int(conv.sum())}/{n_inst}, diverged "
          f"{int(res.diverged.sum())}, iterations {its.tolist()}")
    routes = dict(cuda_cr.route_launches)
    print(f"{what}: launches K6 {launches['cr_factor']} K7 "
          f"{launches['cr_solve']} (float64: {f64['cr_factor']} / "
          f"{f64['cr_solve']}); host syncs {syncs}; K6 routes: block "
          f"{routes['cr_factor block']}, cluster "
          f"{routes['cr_factor cluster']} (k6_route picks "
          f"{k6_pick(solver.N, solver.b, n_inst, torch.float32)})")
    check(routes["cr_factor block"] + routes["cr_factor cluster"] ==
          launches["cr_factor"], f"{what}: K6's route counts do not add up")
    picks7 = {k: cuda_cr.k7_route(solver.N, solver.b, k, n_inst,
                                  torch.float32)[0]
              for k in (solver.t + 1, 1)}
    print(f"{what}: K7 routes: block {routes['cr_solve block']}, shared "
          f"{routes['cr_solve shared']} (k7_route picks "
          f"{picks7[solver.t + 1]} at k={solver.t + 1}, {picks7[1]} at k=1)")
    for route in ("block", "shared"):
        want = steps * sum(p == route for p in picks7.values())
        check(routes[f"cr_solve {route}"] == want, f"{what}: "
              f"{routes[f'cr_solve {route}']} K7 launches on the {route} "
              f"route, k7_route's picks give {want}")
    check(bool(conv.all()), f"{what}: {int(conv.sum())}/{n_inst} converged")
    check(launches["cr_factor"] == steps and
          launches["cr_solve"] == 2 * steps,
          f"{what}: expected one K6 and two K7 launches for each of the "
          f"{steps} iterations, got {launches}")
    check(f64["cr_factor"] == 0 and f64["cr_solve"] == 0,
          f"{what}: float64 launches in a float32 solve")
    launches.update(routes)

    solve()
    med = time_solves(solve, 5)
    print(f"{what}: wall ms per solve (CUDA events, 5 runs) median "
          f"{med:.3f}; ms per iteration {med / steps:.3f}; useful "
          f"iterations/s {int(its.sum()) / (med / 1e3):.1f}")

    cres = cpu_solve()
    f_cpu = cres.objective.reshape(n_inst)
    f_gpu = res.objective.reshape(n_inst).cpu().double()
    rel = (f_gpu - f_cpu).abs() / (1.0 + f_cpu.abs())
    print(f"{what} cpu f64 check (method='cr'): converged "
          f"{int(cres.converged.sum())}/{n_inst} on the CPU in "
          f"{cres.iterations.reshape(n_inst).tolist()} iterations; largest "
          f"|f_gpu - f_cpu| / (1 + |f_cpu|) = {rel.max().item():.3e} "
          f"(limit 1e-4)")
    check(bool(cres.converged.all()), f"{what}: the CPU f64 port did not "
          f"converge")
    check(bool((rel <= 1e-4).all()), f"{what}: objectives disagree with "
          f"the CPU f64 port")
    return launches


def arrow_slice_data():
    """The slice's data on the port's default device, the card: one
    instance (bench_arrow's QP), its structure, and the batch of
    ARROW_BATCH instances of that structure (the same Q, c drawn from
    numpy seeds 1..ARROW_BATCH)."""
    import numpy as np
    import torch
    from ipmzoo_tpu_torch import ArrowQPData

    Q, c, l, u = arrow_problem()
    t0 = time.perf_counter()
    data, st, blk = ArrowQPData.from_dense(Q, c, l, u, dtype=torch.float32)
    print(f"arrow slice: detected bandwidth {st.bandwidth}, tip {st.tip}, "
          f"block {blk}, N={data.D.shape[0]} on {data.D.device} in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    check((st.bandwidth, st.tip, blk) == (ARROW_BW, ARROW_TIP, 16),
          f"detector found {st.bandwidth}, {st.tip}")
    check(data.D.device.type == "cuda", "the default device is not the card")
    datas = []
    for seed in range(1, ARROW_BATCH + 1):
        ci = np.random.default_rng(seed).normal(size=ARROW_N).astype(
            np.float32)
        datas.append(ArrowQPData.from_dense(
            Q, ci, l, u, structure=st, dtype=torch.float32)[0])
    return data, st, ArrowQPData.stack(datas)


def arrow_solver(data, st):
    """bench_arrow's solver, on the data's device with the default
    method."""
    import torch
    from ipmzoo_tpu_torch import ArrowIPM
    solver = ArrowIPM.for_data(data, structure=st, dtype=torch.float32,
                               tol=1e-5)
    check(solver.device.type == "cuda" and solver.method == "auto",
          "ArrowIPM did not take the card and the default method")
    return solver


def run_arrow_slice():
    """Steps 19 and 20."""
    import torch
    from ipmzoo_tpu_torch import ArrowIPM

    data, st, batch = arrow_slice_data()
    solver = arrow_solver(data, st)

    def cpu_twin(d):
        d64 = d.to(device="cpu", dtype=torch.float64)
        return ArrowIPM.for_data(d64, structure=st, tol=1e-8, method="cr"), \
            d64

    cpu1, d1 = cpu_twin(data)
    single = run_arrow("arrow single", lambda: solver.solve(data), solver,
                       lambda: cpu1.solve(d1), 1)
    cpu32, d32 = cpu_twin(batch)
    batched = run_arrow(f"arrow batch of {ARROW_BATCH}",
                        lambda: solver.solve_batch(batch), solver,
                        lambda: cpu32.solve_batch(d32), ARROW_BATCH)
    return solver, data, batch, single, batched


def time_cr(solver, data, batch):
    """Step 21: K6 and K7 (K7s: its shared route, at the columns k7_route
    picks) against their plain versions and against the per-level library
    composition, on the slice's condensed matrices at the initial
    iterate."""
    import torch
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.ops import banded, cuda_cr
    from ipmzoo_tpu_torch.ops.cr import cr_factor_plain, cr_solve_plain
    from ipmzoo_tpu_torch.utils.timer import cuda_time

    out, errs = {}, {}
    one = tree_map(lambda a: a[None], data)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for d in (one, batch):
            B = d.c.shape[0]
            d = d.to(dtype=dtype)
            solver_t = type(solver).for_data(d, dtype=dtype)
            st = solver_t.init_state(d)
            D, _ = solver_t._condensed(d, st.vars)
            E = d.E
            rhs = -st.rx[:, :solver.N * solver.b].reshape(
                B, solver.N, solver.b, 1)
            r9 = torch.cat([banded._strip_blocks(d.U, solver.N, solver.b),
                            rhs], dim=-1).contiguous()
            r1 = rhs.contiguous()
            keep = errs if (dtype == torch.float32 and B == 1) else None
            f0, _ = hold_cr(f"arrow slice B={B} N={solver.N} b={solver.b} "
                            f"k={r9.shape[-1]}", D, E, r9, keep)
            hold_cr(f"arrow slice B={B} N={solver.N} b={solver.b} k=1",
                    D, E, r1)
            f = cuda_cr.cr_factor_kernel(D, E)
            fl = banded.cr_factor(D, E)
            t = {
                "K6": time_cuda(lambda: cuda_cr.cr_factor_kernel(D, E), 20),
                "K6_plain": time_cuda(lambda: cr_factor_plain(D, E), 2),
                "K6_cr": time_cuda(lambda: banded.cr_factor(D, E), 5),
                "K7_k9": time_cuda(lambda: cuda_cr.cr_solve_kernel(f, r9),
                                   20),
                "K7_k9_plain": time_cuda(lambda: cr_solve_plain(f0, r9), 2),
                "K7_k9_cr": time_cuda(lambda: banded.cr_solve(fl, r9), 5),
                "K7_k1": time_cuda(lambda: cuda_cr.cr_solve_kernel(f, r1),
                                   20),
                "K7_k1_plain": time_cuda(lambda: cr_solve_plain(f0, r1), 2),
                "K7_k1_cr": time_cuda(lambda: banded.cr_solve(fl, r1), 5),
                "K7s_k9": time_cuda(lambda: cuda_cr.cr_solve_shared(f, r9),
                                    20),
                "K7s_k1": time_cuda(lambda: cuda_cr.cr_solve_shared(f, r1),
                                    20),
            }
            # K6's routes by CUDA events behind a leading launch (0.28
            # ms and more a call, so the host's launch time hides)
            calls = k6_calls(solver.N, solver.b, dtype)
            ev_t = {r: cuda_time(lambda c=c: c(D, E), runs=5, calls=3,
                                 lead=1).ms for r, c in calls.items()}
            for r in calls:
                t[f"K6_{r}_events"] = ev_t[r]
            pick = k6_pick(solver.N, solver.b, B, dtype)
            best = min(ev_t, key=ev_t.get)
            t["K6_cluster"] = t[f"K6_{pick}_events"] if pick != "block" \
                else None
            out[(name, B)] = t
            print(f"timing arrow shape N={solver.N} b={solver.b} B={B} "
                  f"{name} (ms per call, CUDA events; _cr is the per-level "
                  f"library composition; _events: CUDA events behind a "
                  f"leading launch): " + ", ".join(f"{a} {v:.4f}" for a, v in
                                            t.items() if v is not None) +
                  f"; k6_route picks {pick}, the faster by CUDA events is "
                  f"{best}")
            check(ev_t[pick] <= 1.05 * ev_t[best],
                  f"k6_route picks {pick} at B={B} {name}: {ev_t[pick]:.4f} "
                  f"ms by CUDA events against {best}'s {ev_t[best]:.4f}")
    return out, errs


def k5_inputs(B, n, k, dtype, dev, seed):
    import torch
    A, _ = quasi_definite(B, n, dtype, dev, seed)
    R = torch.randn((B, n, k), dtype=dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(seed))
    return A, R


def hold_k5(what, A, R, tol, route):
    """K5 through the wrapper (``route``: what k5_route picks, "warp",
    "block" or, over the block's cap, "k2+k4": K2 then K4, or above
    K2_ORDERS the blocked route if ldlt_route picks it, its panels on K2)
    against the plain version
    on the card: the launches of that route only, and L, D and X within
    ``tol`` (largest absolute difference over the largest magnitude of the
    plain result); returns the plain result and the largest absolute
    difference of X."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import ldlt_solve_matrix

    L0, D0, X0 = ldlt_solve_matrix(A, R)
    before = dict(cuda_ldlt.launches)
    by_route = dict(cuda_ldlt.route_launches)
    L, D, X = cuda_ldlt.ldlt_solve_matrix_auto(A, R)
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in cuda_ldlt.launches.items() if
            v != before[k]}
    n = A.shape[1]
    blocked = cuda_ldlt.ldlt_route(n) == "blocked"
    want = {"ldlt_solve_matrix": 1} if route != "k2+k4" else \
        {"ldlt": -(-n // 128)} if blocked else \
        {"ldlt": 1, "solve_ldlt_matrix": 1}
    check(made == want, f"{what}: launches {made}, expected {want}")
    if route == "k2+k4" and blocked:
        check(cuda_ldlt.route_launches["ldlt blocked"] ==
              by_route["ldlt blocked"] + 1, f"{what}: ldlt_route picks the "
              f"blocked route, which the wrapper did not take")
    if route != "k2+k4":
        key = f"ldlt_solve_matrix {route}"
        check(cuda_ldlt.route_launches[key] == by_route[key] + 1,
              f"{what}: the wrapper did not take K5's {route} route")
    check(bool(torch.isfinite(X0).all()), f"{what}: plain X not finite")
    rl, rd, rx = rel_diff(L, L0), rel_diff(D, D0), rel_diff(X, X0)
    over = "blocked LDL^T (K2 panels)" if blocked else "K2 + K4"
    print(f"kernels {what}: {over if route == 'k2+k4' else 'K5 ' + route}"
          f" rel diff L {rl:.3e} D {rd:.3e} X {rx:.3e} (limit {tol:g})")
    check(max(rl, rd, rx) <= tol, f"{what}: disagrees with the plain "
          f"version: {max(rl, rd, rx):.3e} > {tol:g}")
    return (L0, D0, X0), (X - X0).abs().max().item()


def k5_call(route, A, R, **kw):
    """One launch of K5's ``route`` on contiguous A, R (``kw``: the split
    route's groups)."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    return {"warp": cuda_ldlt.factor_solve_matrix_warp,
            "split": cuda_ldlt.factor_solve_matrix_split,
            "block": cuda_ldlt.factor_solve_matrix_launch}[route](A, R, **kw)


def k5_routes(B, n, k, dtype):
    """The K5 routes that can run B matrices of order n with k columns in
    ``dtype``."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    routes = ("block",) if cuda_ldlt.factor_solve_matrix_fits(n, k, dtype) \
        else ()
    routes += ("warp",) if n <= cuda_ldlt.K5_WARP_MAX_ORDER else ()
    return routes + (("split",) if cuda_ldlt.k5_split_shape(
        B, n, k, dtype) is not None else ())


def hold_k5_route(what, A, R, route, tol, **kw):
    """K5's ``route`` launched alone against the plain version: L, D and
    X within ``tol``, L exactly unit-lower; returns (plain D, the route's
    D, largest absolute difference of X)."""
    import torch
    from ipmzoo_tpu_torch.ops.ldlt import ldlt_solve_matrix
    L0, D0, X0 = ldlt_solve_matrix(A, R)
    L, D, X = k5_call(route, A, R, **kw)
    torch.cuda.synchronize()
    rl, rd, rx = rel_diff(L, L0), rel_diff(D, D0), rel_diff(X, X0)
    print(f"kernels {what}: K5 {route} route{' ' + str(kw) if kw else ''} "
          f"rel diff L {rl:.3e} D {rd:.3e} X {rx:.3e} (limit {tol:g})")
    check(torch.equal(torch.triu(L, 1), torch.zeros_like(L)) and
          bool((torch.diagonal(L, dim1=1, dim2=2) == 1).all()),
          f"K5's {route} route: L is not exactly unit-lower ({what})")
    check(max(rl, rd, rx) <= tol, f"K5's {route} route disagrees with the "
          f"plain version ({what}): {max(rl, rd, rx):.3e} > {tol:g}")
    return D0, D, (X - X0).abs().max().item()


def check_k5(dev):
    """Step 22: K5 against its plain version on the card: through the
    wrapper (the route k5_route picks) at the path shapes, then each
    route alone at the path shapes and at K5_EDGES, and every route on an
    exactly-zero pivot; returns the wrapper's largest absolute difference
    at K5_LEVEL in float32 and the routes' by (route, B, n, k, type)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR

    err, route_errs = None, {}
    for dtype, tol, tol_lib in ((torch.float32, 1e-5, 1e-3),
                                (torch.float64, 1e-12, 1e-9)):
        name = str(dtype).replace("torch.", "")
        for B, n, k in K5_SHAPES:
            A, R = k5_inputs(B, n, k, dtype, dev, seed=n + k)
            what = f"{name} B={B} n={n} k={k}"
            route = cuda_ldlt.k5_route(B, n, k, dtype)
            check(route != "k2+k4", f"{what} does not fit K5")
            (_, _, X0), ax = hold_k5(what, A, R, tol, route)
            rs = rel_diff(X0, torch.linalg.solve(A, R))
            print(f"kernels {what}: plain X against torch.linalg.solve, "
                  f"rel diff {rs:.3e} (limit {tol_lib:g})")
            check(rs <= tol_lib, f"{what}: X is not the solution")
            if dtype == torch.float32 and (B, n, k) == K5_LEVEL:
                err = ax
        for B, n, k in K5_SHAPES + K5_EDGES:
            A, R = k5_inputs(B, n, k, dtype, dev, seed=n + k + 1)
            for route in k5_routes(B, n, k, dtype):
                route_errs[(route, B, n, k, name)] = hold_k5_route(
                    f"{name} B={B} n={n} k={k}", A, R, route, tol)[-1]
        # an exactly-zero second pivot, as in step 4, through every route
        floor = torch.tensor(PIVOT_FLOOR, dtype=dtype)
        for B, n, k in (K5_SHAPES[1], K5_KKT, (3, 37, 5)):
            A, R = k5_inputs(B, n, k, dtype, dev, seed=7)
            A[:, :2, :] = 0.0
            A[:, :, :2] = 0.0
            A[:, :2, :2] = 1.0
            what = f"{name} zero pivot B={B} n={n} k={k}"
            (_, D0, _), _ = hold_k5(what, A, R, tol,
                                    cuda_ldlt.k5_route(B, n, k, dtype))
            Ds = [hold_k5_route(what, A, R, route, tol)[1]
                  for route in k5_routes(B, n, k, dtype)]
            check(all(bool((D[:, 1].cpu() == floor).all())
                      for D in Ds + [D0]),
                  "K5 or its plain version did not put the pivot floor on "
                  "an exactly-zero pivot")
        B, n, k = K5_OVER_CAP
        check(cuda_ldlt.k5_route(B, n, k, dtype) == "k2+k4",
              f"{K5_OVER_CAP} fits K5 in {name}")
        A, R = k5_inputs(B, n, k, dtype, dev, seed=11)
        hold_k5(f"{name} over the cap B={B} n={n} k={k}", A, R, tol,
                "k2+k4")
    print(f"kernels K5: shared-memory cap "
          f"{cuda_ldlt.K5_SHARED_MEMORY_CAP} bytes; largest level shape "
          f"needs {cuda_ldlt.factor_solve_matrix_bytes(16, 64, torch.float64)}"
          f" / {cuda_ldlt.factor_solve_matrix_bytes(64, 40, torch.float64)} "
          f"bytes in float64")
    return err, route_errs


def nd_solver(dtype, tol, device=None):
    """bench_torch.py's nd solver and QP (bench.py's bench_nd:
    grid_qp(side=64), numpy seed 0) on ``device`` (default: the card)."""
    import bench_torch
    return bench_torch.nd_problem(device, dtype, tol)


def check_nd_kkt():
    """Step 23: nd_solve(nd_factor(K)) on the nd slice's own KKT at the
    initial iterate, float64 on the card, against torch.linalg.solve;
    with the signed merged top (two Cholesky stages) and without signs
    (the top block of order 328 goes through the route ldlt_route picks:
    the panel-blocked LDL^T, its panels on K2's block route, or K2 by its
    SoA route, over the block route's shared memory, + K4).  Returns the
    generic top's launches by route."""
    import torch
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ndiss import nd_factor, nd_plan, nd_solve

    solver, data = nd_solver(torch.float64, 1e-8)
    one = solver._check_data(tree_map(lambda a: a[None], data))
    t0 = time.perf_counter()
    solver._ensure_nd_plan(one)
    plan = solver._nd_plan
    print(f"nd plan: n={plan.n}, {len(plan.levels)} levels, "
          f"{plan.num_nodes} supernodes, (B, k, m, C) per level "
          f"{[(l.idx.shape[0], l.idx.shape[1], l.bnd.shape[1], l.child_ids.shape[1]) for l in plan.levels]}, "
          f"m_max {plan.m_max}, top_neg {plan.top_neg}, flops nd "
          f"{plan.flops_nd:.3e} dense {plan.flops_dense:.3e}, diagonal "
          f"split {solver._nd_diag_split}; built in "
          f"{time.perf_counter() - t0:.2f} s (host), {solver.host_syncs} "
          f"matrices brought to the host")
    check([(l.idx.shape[0],) + l.idx.shape[1:] + (l.bnd.shape[1],)
           for l in plan.levels[:3]] == [K5_SHAPES[0], K5_SHAPES[1],
                                         K5_SHAPES[2]],
          "the plan's levels are not the shapes K5 is held at")
    st = solver.init_state(one)
    K = solver._assemble_kkt(solver._env(one, st.vars, st.mu), 1)[0]
    b = torch.randn(plan.n, dtype=K.dtype, device=K.device,
                    generator=torch.Generator(K.device).manual_seed(3))
    xs = torch.linalg.solve(K, b)
    unsigned = nd_plan((K != 0).cpu().numpy(), leaf=ND_LEAF)
    check(plan.top_neg >= 0 and unsigned.top_neg < 0, "top_neg")
    blocked = cuda_ldlt.ldlt_route(K2_OVER_CAP[0]) == "blocked"
    for what, p in (("signed top", plan), ("generic top", unsigned)):
        cuda_ldlt.reset_launch_counts()
        x = nd_solve(p, nd_factor(K, p), b)
        torch.cuda.synchronize()
        made = dict(cuda_ldlt.launches)
        routes = dict(cuda_ldlt.route_launches)
        rd = rel_diff(x, xs)
        print(f"nd factor + solve float64 n={p.n} ({what}): rel diff to "
              f"torch.linalg.solve {rd:.3e} (limit 1e-9); launches {made}, "
              f"by route {routes}")
        check(rd <= 1e-9, f"nd_solve disagrees with the dense solve "
              f"({what}): {rd:.3e}")
        top = 0 if p is plan else 1
        if blocked:
            # the top takes the panel-blocked LDL^T, its panels on K2
            check(made == {"ldlt": -(-K2_OVER_CAP[0] // 128) * top,
                           "solve_ldlt": 3, "solve_ldlt_matrix": 0,
                           "ldlt_solve_matrix": 3},
                  f"nd ({what}): launches {made}")
            check(routes["ldlt blocked"] == top and routes["ldlt soa"] == 0,
                  f"nd ({what}): the top of order {K2_OVER_CAP[0]} did not "
                  f"take the blocked route ldlt_route picks")
            check(routes["solve_ldlt warp"] == 3 and
                  routes["solve_ldlt thread"] == 0, f"nd ({what}): K3 "
                  f"routes {routes}, expected the three levels on the warp "
                  f"route")
            continue
        check(made == {"ldlt": top, "solve_ldlt": 3 + top,
                       "solve_ldlt_matrix": top, "ldlt_solve_matrix": 3},
              f"nd ({what}): launches {made}")
        check(routes["ldlt soa"] == top, f"nd ({what}): the top of order "
              f"{K2_OVER_CAP[0]} did not take K2's SoA route")
        check(routes["solve_ldlt warp"] == 3 and
              routes["solve_ldlt thread"] == top, f"nd ({what}): K3 routes "
              f"{routes}, expected the three levels on the warp route and "
              f"the top of order {K2_OVER_CAP[0]} on the thread route")
    return routes


def run_nd(what, solve, solver, n_inst):
    """One line of the nd slice: solve on the card, launches, bit-equal
    repeat, wall."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    res = solve()
    torch.cuda.synchronize()
    launches = dict(cuda_ldlt.launches)
    f64 = dict(cuda_ldlt.f64_launches)
    routes = dict(cuda_ldlt.route_launches)
    syncs = solver.host_syncs

    n = ND_SIDE * ND_SIDE
    x = res.x.reshape(n_inst, -1)
    check(tuple(x.shape) == (n_inst, n), f"{what}: x shape "
          f"{tuple(res.x.shape)}")
    check(x.device.type == "cuda", f"{what}: x is on {x.device}")
    check(bool(torch.isfinite(x).all()), f"{what}: non-finite x")
    check(bool(((x >= -1.0) & (x <= 1.0)).all()), f"{what}: x leaves its "
          f"bounds")
    its = res.iterations.reshape(n_inst)
    conv = res.converged.reshape(n_inst)
    steps = int(its.max())
    print(f"{what}: grid_qp side={ND_SIDE} n={n} float32 tol=1e-5 "
          f"kernel='nd' leaf={ND_LEAF}: converged {int(conv.sum())}/"
          f"{n_inst}, diverged {int(res.diverged.sum())}, iterations "
          f"{its.tolist()}")
    print(f"{what}: launches K5 {launches['ldlt_solve_matrix']} K3 "
          f"{launches['solve_ldlt']} K2 {launches['ldlt']} K4 "
          f"{launches['solve_ldlt_matrix']} (float64: "
          f"{sum(f64.values())}); host syncs {syncs}")
    print(f"{what}: K5 routes: block {routes['ldlt_solve_matrix block']}, "
          f"warp {routes['ldlt_solve_matrix warp']}, split "
          f"{routes['ldlt_solve_matrix split']}; K3 routes: thread "
          f"{routes['solve_ldlt thread']}, warp {routes['solve_ldlt warp']}")
    check(routes["solve_ldlt thread"] + routes["solve_ldlt warp"] ==
          launches["solve_ldlt"], f"{what}: K3's route counts do not add up")
    check(routes["ldlt_solve_matrix block"] +
          routes["ldlt_solve_matrix warp"] +
          routes["ldlt_solve_matrix split"] == launches["ldlt_solve_matrix"],
          f"{what}: K5's route counts do not add up")
    check(bool(conv.all()), f"{what}: {int(conv.sum())}/{n_inst} converged")
    check(launches == {"ldlt_solve_matrix": 3 * steps,
                       "solve_ldlt": 6 * steps, "ldlt": 0,
                       "solve_ldlt_matrix": 0},
          f"{what}: expected three K5 and six K3 launches for each of the "
          f"{steps} iterations and no K2 / K4, got {launches}")
    check(sum(f64.values()) == 0, f"{what}: float64 launches in a float32 "
          f"solve")

    again = solve()
    torch.cuda.synchronize()
    check(torch.equal(again.x, res.x) and
          torch.equal(again.iterations, res.iterations),
          f"{what}: two solves of the same data differ in x")
    print(f"{what}: a second solve gives bit-identical x")
    med = time_solves(solve, 5)
    print(f"{what}: wall ms per solve (CUDA events, 5 runs) median "
          f"{med:.3f}; ms per iteration {med / steps:.3f}; useful "
          f"iterations/s {int(its.sum()) / (med / 1e3):.1f}")
    return res, {**launches, **routes}


def run_nd_slice():
    """Steps 24-26: bench_nd's QP through CompiledIPM(kernel='nd') on the
    default device, one instance and a batch of ND_BATCH, and the
    objectives against the port on the CPU in float64.  Returns the
    launches of the single solve and its objective."""
    import torch
    from ipmzoo_tpu_torch.models.families import grid_qp
    from ipmzoo_tpu_torch.models.state import tree_map

    solver, data = nd_solver(torch.float32, 1e-5)
    check(solver.device.type == "cuda" and data.Q.device.type == "cuda",
          "the default device is not the card")
    res, launches = run_nd("nd single", lambda: solver.solve(data), solver,
                           1)
    check(solver._mode == "nd" and not solver.nd_fell_back,
          "the nd solver fell back")
    batch = grid_qp(side=ND_SIDE, batch=ND_BATCH, seed=0,
                    dtype=torch.float32).data
    resb, _ = run_nd(f"nd batch of {ND_BATCH}",
                     lambda: solver.solve_batch(batch), solver, ND_BATCH)

    cpu, _ = nd_solver(torch.float64, 1e-8, device="cpu")
    to64 = lambda d: tree_map(                                # noqa: E731
        lambda a: a.to(device="cpu", dtype=torch.float64), d)
    c1 = cpu.solve(to64(data))
    c2 = cpu.solve_batch(to64(tree_map(lambda a: a[:2], batch)))
    f_cpu = torch.cat([c1.objective[None], c2.objective])
    f_gpu = torch.cat([res.objective[None], resb.objective[:2]]).cpu() \
        .double()
    rel = (f_gpu - f_cpu).abs() / (1.0 + f_cpu.abs())
    print(f"nd cpu f64 check (method 'jnp' there): converged "
          f"{int(c1.converged) + int(c2.converged.sum())}/3 on the CPU in "
          f"{[int(c1.iterations)] + c2.iterations.tolist()} iterations; "
          f"f_cpu {[round(f, 6) for f in f_cpu.tolist()]}; largest "
          f"|f_gpu - f_cpu| / (1 + |f_cpu|) = {rel.max().item():.3e} "
          f"(limit 1e-4)")
    check(bool(c1.converged) and bool(c2.converged.all()),
          "nd: the CPU f64 port did not converge")
    check(bool((rel <= 1e-4).all()), "nd: objectives disagree with the CPU "
          "f64 port")
    return launches, float(res.objective)


def run_nd_crossover(dev, nd_objective):
    """Step 44: the fallback's cost model on the card.  The crossover
    tool's measurement at the rows of ND_SWEEP (the levels of grid side
    ND_SWEEP_SIDE's plan must be K5_SWEEP_LEVELS and the top); fails
    where, at a row of ND_GATED, the default constants (ops/ndiss.py, the
    card's fit chip_nd_crossover.CARD_FIT) keep nd at a measured speedup
    below chip_nd_crossover.BAND or drop it above.  Then bench_nd's QP
    (grid side 64, gated: the default falls back there) through
    CompiledIPM(kernel='nd') with its default fallback, the launch counts
    set to 0 just before the solve and read just after: the path it took
    (the fallback, to 'blockg'), converged, and its objective within 1e-4
    (1 + |f|) of step 24's nd solve (``nd_objective``)."""
    import torch
    import chip_nd_crossover as tool
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.models.families import grid_qp
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ndiss import cost_model_times

    t0 = time.perf_counter()
    lo, hi = tool.BAND
    for g, one_level in ND_SWEEP:
        r = tool.measure_side(g, dev, one_level)
        t_nd, t_dense = cost_model_times(r["n"], r["levels"], r["flops_nd"])
        predicted = t_dense / t_nd
        keeps = predicted >= tool.KEEP
        gated = (g, one_level) in ND_GATED
        print("nd crossover " + tool.row_line(r) +
              f"; the default {'keeps nd' if keeps else 'falls back'}"
              f" ({predicted:.3f}x), the JAX package's constants "
              f"{'keep nd' if r['predicted_reference'] >= tool.KEEP else 'fall back'}"
              + ("" if gated else " (not gated)") +
              (f" (inside the band {lo}-{hi}: either path)"
               if lo <= r["measured"] <= hi else ""))
        if g == ND_SWEEP_SIDE and not one_level:
            check([tuple(x) for x in r["shapes"][:-1]] ==
                  list(K5_SWEEP_LEVELS) and r["shapes"][-1][0] == 1,
                  f"the levels of side {g} are {r['shapes']}, not the "
                  f"shapes K5 and K3 are held at")
        if gated:
            check(not tool.decides_wrong(r["measured"], predicted),
                  f"{tool.label(r)}: the default "
                  f"{'keeps' if keeps else 'drops'} nd at a measured "
                  f"{r['measured']:.3f}x")

    fam = grid_qp(side=ND_SIDE, seed=0, dtype=torch.float32)
    solver = CompiledIPM(fam.settings, n=ND_SIDE * ND_SIDE,
                         dtype=torch.float32, tol=1e-5, kernel="nd",
                         nd_leaf=ND_LEAF)
    cuda_ldlt.reset_launch_counts()
    res = solver.solve(fam.data)
    torch.cuda.synchronize()
    launches = dict(cuda_ldlt.launches)
    routes = {k: v for k, v in cuda_ldlt.route_launches.items() if v}
    f = float(res.objective)
    rel = abs(f - nd_objective) / (1.0 + abs(nd_objective))
    print(f"nd with the default fallback g={ND_SIDE} n={solver.n}: "
          f"nd_fell_back {solver.nd_fell_back}, mode '{solver._mode}', "
          f"converged {bool(res.converged)} in {int(res.iterations)} "
          f"iterations; launches {launches}, by route {routes}; objective "
          f"{f:.6f} against step 24's {nd_objective:.6f}: "
          f"|diff| / (1 + |f|) = {rel:.3e} (limit 1e-4)")
    check(bool(res.converged), "nd with the default fallback did not "
          "converge")
    check(rel <= 1e-4, "nd with the default fallback: the objective "
          "disagrees with step 24's")
    check(solver.nd_fell_back and solver._mode == "blockg",
          f"g={ND_SIDE}: the default kept nd or took "
          f"'{solver._mode}', not the fallback to 'blockg'")
    check(launches["ldlt_solve_matrix"] == 0, f"the fallback still "
          f"launched K5 ({launches})")
    print(f"step 44: {time.perf_counter() - t0:.1f} s")


#: K5's kernels by route, as launch_ms matches them
K5_KERNELS = {"block": ("ldlt_factor_solve_matrix_kernel<", None),
              "warp": ("ldlt_factor_solve_matrix_kernel_warp<", None),
              "split": ("ldlt_factor_solve_matrix_kernel_split<", None)}


def k5_device_ms(cases, reps):
    """Device ms per launch of each K5 route of each (A, R, routes) of
    ``cases``, all in one trace (launch_ms)."""
    groups = [(lambda r=r, A=A, R=R: k5_call(r, A, R), {r: K5_KERNELS[r]})
              for A, R, routes in cases for r in routes]
    ms = iter(launch_ms(groups, reps))
    return [{r: next(ms)[r] for r in routes} for _, _, routes in cases]


def time_k5(dev):
    """Step 27: each K5 route alone at every shape the paths give K5
    (K5_SHAPES in float32, K5_LEVEL and K5_KKT also in float64), against
    the plain version, against K2 followed by K4 (the wrappers, layout
    transposes included) and against torch.linalg.solve, which gives the
    same X and no factors (at the nd levels also its device time); the
    routes' device time in one trace a shape; prints which route k5_route
    picks and which is faster, and fails where the rule picks a route
    more than 5% slower on the device."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import ldlt_solve_matrix

    def k2_k4(A, R):
        L, D = cuda_ldlt.ldlt_auto(A)
        return cuda_ldlt.solve_ldlt_matrix_auto(L, D, R)

    out = {}
    cases = [(s, torch.float32) for s in K5_SHAPES] + \
        [(K5_LEVEL, torch.float64), (K5_KKT, torch.float64)]
    for (B, n, k), dtype in cases:
        name = str(dtype).replace("torch.", "")
        A, R = k5_inputs(B, n, k, dtype, dev, seed=n + k)
        X0 = ldlt_solve_matrix(A, R)[2]
        routes = k5_routes(B, n, k, dtype)
        t = {f"K5_{r}": time_cuda(lambda r=r: k5_call(r, A, R), 50)
             for r in routes}
        dev_t = k5_device_ms([(A, R, routes)], 50)[0]
        t.update({f"K5_{r}_device": v for r, v in dev_t.items()})
        t["K5_plain"] = time_cuda(lambda: ldlt_solve_matrix(A, R), 3)
        t["K2_then_K4"] = time_cuda(lambda: k2_k4(A, R), 10)
        t["library"] = time_library(
            f"torch.linalg.solve (K5's X, no factors) B={B} n={n} k={k} "
            f"{name}", lambda: torch.linalg.solve(A, R), X0,
            1e-3 if dtype == torch.float32 else 1e-9, 10)
        if (B, n, k) in K5_ND_LEVELS and t["library"] is not None:
            t["library_device"] = device_ms(
                lambda: torch.linalg.solve(A, R), 10)
        t["bound"] = k5_bound(B, n, k, dtype)
        pick = cuda_ldlt.k5_route(B, n, k, dtype)
        best = min(routes, key=lambda r: dev_t[r])
        out[(B, n, k, name)] = t
        print(f"timing K5 B={B} n={n} k={k} {name} (ms per call, CUDA "
              f"events; _device: kernel time under torch.profiler): " +
              ", ".join(f"{a} {v:.4f}" for a, v in t.items()
                        if a.startswith(("K", "library_")) and
                        v is not None) +
              f"; bound {t['bound'][0]:.6f} ms by {t['bound'][1]}; k5_route "
              f"picks {pick}, the faster on the device is {best}")
        check(dev_t[pick] <= 1.05 * dev_t[best],
              f"k5_route picks the {pick} route at B={B} n={n} k={k} {name}: "
              f"{dev_t[pick]:.4f} ms of device time against {best}'s "
              f"{dev_t[best]:.4f}")
    return out


#: (B, n, k) of scan_k5_split: the nd slice's levels, one instance and
#: the batch of 8
K5_SCAN_SHAPES = ((105, 64, 40), (28, 16, 48), (16, 16, 64), (840, 64, 40),
                  (224, 16, 48), (128, 16, 64))


def scan_k5_split(dev=None):
    """The split route's device time at K5_SCAN_SHAPES in both types for
    every number of column groups a block holds, beside the other routes,
    one trace a shape (launch_ms): the measurement behind k5_split_shape.
    Where the blocks fit one wave (B up to 132), one group against all
    groups splits the time into the staging with the factor (F) and one
    group's sweeps (S): one group walks all g of them, F + g S, all groups
    take F + S.  Not part of main(); run it alone (a minute with the
    ldlt.cu build)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    dev = dev or torch.device("cuda")
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        for B, n, k in K5_SCAN_SHAPES:
            A, R = k5_inputs(B, n, k, dt, dev, seed=n + k)
            groups, labels = [], []
            for r in k5_routes(B, n, k, dt):
                if r != "split":
                    groups.append((lambda r=r: k5_call(r, A, R),
                                   {r: K5_KERNELS[r]}))
                    labels.append(r)
            need = -(-k // cuda_ldlt.K5_SPLIT_COLS)
            for g in range(1, need + 1):
                if cuda_ldlt.k5_split_shape(B, n, k, dt, g):
                    groups.append((lambda g=g: k5_call(
                        "split", A, R, groups=g),
                        {"split": K5_KERNELS["split"]}))
                    labels.append(f"split groups={g}")
            ms = {lab: next(iter(t.values())) for lab, t in
                  zip(labels, launch_ms(groups, 20))}
            pick = cuda_ldlt.k5_split_shape(B, n, k, dt)
            print(f"scan {name} B={B} n={n} k={k}: device ms " +
                  ", ".join(f"{lab} {v:.4f}" for lab, v in ms.items()) +
                  f"; k5_split_shape gives {pick} groups", flush=True)
            one, full = (ms.get(f"split groups={g}") for g in (1, need))
            if B <= 132 and need > 1 and one is not None and \
                    full is not None:
                S = (one - full) / (need - 1)
                print(f"scan {name} B={B} n={n} k={k}: staging + factor "
                      f"{full - S:.4f} ms, one group's sweeps {S:.4f} ms "
                      f"({need} groups)", flush=True)


#: sweep_k5's orders, right-hand sides and batches
K5_SWEEP_N = (8, 16, 24, 32, 48, 64)
K5_SWEEP_K = (1, 2, 4, 8, 16, 24, 32, 40, 48, 64)
K5_SWEEP_B = (16, 105, 840, 10240)


def sweep_k5(dev=None):
    """Every K5 route's device time over K5_SWEEP_N x K5_SWEEP_K x
    K5_SWEEP_B, float32 and float64, one trace an order and type
    (launch_ms): the measurement behind k5_route.  Prints each point, the
    points where k5_route's pick is more than 5% slower than the fastest
    route, and their count.  Not part of main(); run it alone (a few
    minutes with the ldlt.cu build)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    dev = dev or torch.device("cuda")
    points, misses = 0, []
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        for n in K5_SWEEP_N:
            shapes = [(B, k) for B in K5_SWEEP_B for k in K5_SWEEP_K]
            cases = []
            for B in K5_SWEEP_B:
                A = k5_inputs(B, n, 1, dt, dev, seed=n)[0]
                for k in K5_SWEEP_K:
                    R = torch.randn((B, n, k), dtype=dt, device=dev,
                                    generator=torch.Generator(
                                        dev).manual_seed(k))
                    cases.append((A, R, k5_routes(B, n, k, dt)))
            for (B, k), d in zip(shapes, k5_device_ms(cases, 20)):
                pick = cuda_ldlt.k5_route(B, n, k, dt)
                best = min(d, key=d.get)
                points += 1
                miss = d[pick] > 1.05 * d[best]
                if miss:
                    misses.append((name, B, n, k, pick, d[pick], best,
                                   d[best]))
                print(f"sweep {name} B={B} n={n} k={k}: device ms " +
                      " ".join(f"{r} {v:.4f}" for r, v in d.items()) +
                      f"; k5_route picks {pick}, fastest {best}"
                      f"{' MISS' if miss else ''}", flush=True)
            del cases
    print(f"sweep_k5: k5_route within 5% of the fastest route at "
          f"{points - len(misses)} of {points} points; misses: {misses}")
    return misses


#: K6's kernels by route, as launch_ms matches them
K6_KERNELS = {"block": ("cr_factor_kernel<", None),
              "cluster": ("cr_factor_kernel_cluster<", None)}
#: (N, b) and batches of sweep_k6
K6_SWEEP_NB = tuple((N, b) for b in (4, 8, 16)
                    for N in (1, 2, 3, 4, 8, 16, 37, 64, 128, 256))
K6_SWEEP_B = (1, 4, 8, 16, 24, 32)


def k6_device_ms(dev, shapes, dtype, reps):
    """Device ms of every K6 route of k6_calls at each (B, N, b) of
    ``shapes``, in one trace (launch_ms), on random SPD block-tridiagonal
    systems; a list of route -> ms maps."""
    groups, names = [], []
    for B, N, b in shapes:
        D, E = spd_block_tridiag(B, N, b, dtype, dev, seed=N + b + B)
        calls = k6_calls(N, b, dtype)
        names.append(list(calls))
        for r, c in calls.items():
            groups.append((lambda c=c, D=D, E=E: c(D, E),
                           {r: K6_KERNELS[r.rstrip("0123456789")]}))
    got = iter(launch_ms(groups, reps))
    return [{r: next(got)[r] for r in routes} for routes in names]


def time_k6_routes(dev):
    """Step 18, K6's route rule: device time of each K6 route at every
    (B, N, b) of K6_ROUTE_SHAPES in both types, in one trace; fails where
    k6_route (and k6_cluster) pick a route more than 5% slower than the
    fastest."""
    import torch
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for (B, N, b), t in zip(K6_ROUTE_SHAPES,
                                k6_device_ms(dev, K6_ROUTE_SHAPES, dtype,
                                             10)):
            pick = k6_pick(N, b, B, dtype)
            best = min(t, key=t.get)
            print(f"timing K6 routes B={B} N={N} b={b} {name} (device ms "
                  f"per call): " + ", ".join(f"{r} {v:.4f}"
                                             for r, v in t.items()) +
                  f"; k6_route picks {pick}, the faster is {best}")
            check(t[pick] <= 1.05 * t[best], f"k6_route picks {pick} at "
                  f"B={B} N={N} b={b} {name}: {t[pick]:.4f} ms of device "
                  f"time against {best}'s {t[best]:.4f}")


#: K7's kernels by route, as launch_ms matches them
K7_KERNELS = {"block": ("cr_solve_kernel<", None),
              "shared": ("cr_solve_kernel_shared<", None)}


def k7_device_ms(dev, cases, widths):
    """Device ms of K7's block route and of its shared route at each group
    width of ``widths(N, b, k, dtype)``, at each (B, N, b, k, dtype) of
    ``cases``, on K6's factors of random SPD systems, all in one trace
    (launch_ms); a list of name -> ms maps ("block", "shared kc=w")."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_cr
    groups, names = [], []
    for B, N, b, k, dtype in cases:
        D, E = spd_block_tridiag(B, N, b, dtype, dev, seed=N + b + k)
        r = torch.randn((B, N, b, k), dtype=dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(k))
        f = cuda_cr.cr_factor_kernel(D, E)
        calls = {"block": (lambda f=f, r=r: cuda_cr.cr_solve_kernel(f, r),
                           K7_KERNELS["block"])}
        for w in widths(N, b, k, dtype):
            calls[f"shared kc={w}"] = (
                lambda f=f, r=r, w=w: cuda_cr.cr_solve_shared(f, r, w),
                K7_KERNELS["shared"])
        names.append(list(calls))
        groups += [(fn, {name: key}) for name, (fn, key) in calls.items()]
    got = iter(launch_ms(groups, 10))
    return [{name: next(got)[name] for name in ns} for ns in names]


def k7_widths(N, b, k, dtype):
    """The shared route's group widths that fit, up to k."""
    from ipmzoo_tpu_torch.ops import cuda_cr
    return range(1, min(k, cuda_cr.solve_shared_max_kc(N, b, dtype)) + 1)


def time_k7_routes(dev):
    """Step 18, K7's route rule: device time of the block route and of the
    shared route at every group width that fits (k7_device_ms) at the
    arrow slice's N and b and each (B, k) of K7_ROUTE_SHAPES, float32 and
    float64, all in one trace; fails where k7_route picks a route more
    than 5% slower than the other (the shared route at the columns it
    picks against the block route).  Returns the times by (B, k, type)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_cr
    N, b = ARROW_N // 16, 16
    cases = [(B, N, b, k, dtype) for dtype in (torch.float32, torch.float64)
             for B, k in K7_ROUTE_SHAPES]
    out = {}
    for (B, _, _, k, dtype), t in zip(cases,
                                      k7_device_ms(dev, cases, k7_widths)):
        name = str(dtype).replace("torch.", "")
        route, kc = cuda_cr.k7_route(N, b, k, B, dtype)
        pick = "block" if route == "block" else f"shared kc={kc}"
        other = f"shared kc={kc}" if route == "block" else "block"
        best = min(t, key=t.get)
        bnd = cr_bounds(B, N, b, k, dtype)["K7"]
        out[(B, k, name)] = t
        print(f"timing K7 routes B={B} N={N} b={b} k={k} {name} (device ms "
              f"per call): " + ", ".join(f"{a} {v:.5f}" for a, v in
                                         t.items()) +
              f"; bound {bnd[0]:.6f} ms by {bnd[1]}; k7_route picks {pick}, "
              f"the fastest is {best}")
        if other in t:
            check(t[pick] <= 1.05 * t[other], f"k7_route picks {pick} at "
                  f"B={B} k={k} {name}: {t[pick]:.5f} ms of device time "
                  f"against {other}'s {t[other]:.5f}")
    return out


def sweep_k6(dev=None):
    """Both K6 routes' device time over K6_SWEEP_NB x K6_SWEEP_B in
    float32 and float64, one trace a type: the measurement behind
    k6_route.  Not part of main(); run it alone (about a minute with the
    cr.cu build)."""
    import torch
    dev = dev or torch.device("cuda")
    shapes = [(B, N, b) for N, b in K6_SWEEP_NB for B in K6_SWEEP_B]
    for dt in (torch.float32, torch.float64):
        for (B, N, b), t in zip(shapes, k6_device_ms(dev, shapes, dt, 10)):
            print(f"sweep K6 {str(dt)[6:]} B={B} N={N} b={b}: device ms " +
                  ", ".join(f"{r} {v:.4f}" for r, v in t.items()) +
                  f"; k6_route picks {k6_pick(N, b, B, dt)}", flush=True)


def sweep_k4(dev=None):
    """Both K4 routes' device time over orders 1..16, 24 and 64 with k =
    1, 2, 4, 16 right-hand sides at 9, 512, 2048 and 10240 systems (order
    64 up to 2048), float32 and float64, one trace a type: the
    measurement behind k4_route's smallest orders.  Not part of main();
    run it alone (about a minute with the ldlt.cu build)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    dev = dev or torch.device("cuda")
    cases = [(n, k, B) for n in list(range(1, 17)) + [24, 64]
             for k in (1, 2, 4, 16) for B in (9, 512, 2048, 10240)
             if n <= 24 or B < 10240]
    for dt in (torch.float32, torch.float64):
        times = k4_device_ms(dev, [c + (dt,) for c in cases], 10)
        for (n, k, B), t in zip(cases, times):
            print(f"sweep K4 {str(dt)[6:]} n={n} k={k} B={B}: device ms "
                  f"thread {t['thread']:.5f} warp {t['warp']:.5f}; k4_route "
                  f"picks {cuda_ldlt.k4_route(n, k, B, dt)}", flush=True)
        # the warp route's tile: each of 8, 4, 2 and 1 instances a block
        # where it fits, at the Schur shape and where shared memory cuts
        # a tile of 4 to fewer column groups
        for n, k, B in ((64, 16, 512), (81, 16, 9), (24, 2, 10240)):
            _, _, R, soa = k4_inputs(n, k, B, dt, dev)
            tiles = [g for g in (8, 4, 2, 1)
                     if cuda_ldlt.k4_warp_shape(n, k, dt, g) is not None]
            times = launch_ms([(lambda g=g: cuda_ldlt.solve_matrix_warp(
                *soa, R, g), {"warp": K4_KERNELS["warp"]}) for g in tiles],
                10)
            print(f"sweep K4 tiles {str(dt)[6:]} n={n} k={k} B={B}: device "
                  f"ms " + ", ".join(
                      f"tile {g} {cuda_ldlt.k4_warp_shape(n, k, dt, g)} "
                      f"{t['warp']:.5f}" for g, t in zip(tiles, times)) +
                  f"; k4_warp_shape picks {cuda_ldlt.k4_warp_shape(n, k, dt)}",
                  flush=True)


def sweep_k7(dev=None):
    """Both K7 routes' device time (the shared route at every group width
    from 1 to what fits) at the arrow slice's N=256, b=16 with k = 9 and
    1 over batches 1..64, and at N = 37, 64, 128, 256 with b = 3, 4, 8, 16
    for one instance, float32 and float64, one trace a type: the
    measurement behind k7_route.  Not part of main(); run it alone
    (about a minute with the cr.cu build)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_cr
    dev = dev or torch.device("cuda")
    cases = [(B, 256, 16, k) for k in (9, 1)
             for B in (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)] + \
        [(1, N, b, 9) for N in (37, 64, 128, 256) for b in (3, 4, 8, 16)]
    for dt in (torch.float32, torch.float64):
        times = k7_device_ms(dev, [c + (dt,) for c in cases], k7_widths)
        for (B, N, b, k), t in zip(cases, times):
            print(f"sweep K7 {str(dt)[6:]} B={B} N={N} b={b} k={k}: device "
                  f"ms " + ", ".join(f"{a} {v:.5f}" for a, v in t.items()) +
                  f"; k7_route picks {cuda_cr.k7_route(N, b, k, B, dt)}",
                  flush=True)


def measure_roofline(dev, k2_ms, k2_block, k1_ms, k1_team_ms):
    """Steps 29, 30 and 32: T1, T2a and T2b (both routes each) held to
    their plain versions, then the measurement itself (the FMA ceilings,
    the in-kernel repetition slopes), whose launches are counted, T2a's
    and T2b's by route; ``k2_ms`` is K2's time at n=24, B=10240 (step 8),
    ``k2_block`` its block route's there (CUDA events, device time),
    ``k1_ms`` / ``k1_team_ms`` K1's cold solve_fused(max_iter=14) there
    on its thread / team route (step 13).  Returns the largest absolute
    differences, the launch counts of the measurement (the team routes
    under "factor_reps team" and "solve_reps team"), and the kernels-line
    times."""
    import torch
    import chip_roofline as rl
    from ipmzoo_tpu_torch.models.fused import _ldlt_soa, _solve_soa
    from ipmzoo_tpu_torch.ops import cuda_fused
    from ipmzoo_tpu_torch.ops import cuda_roofline as cr
    from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR

    rl.check_fma(dev)
    errs = {"fma_chains": rl.check_fma(dev, T1_SHAPE)[T1_CHAINS]}
    errs.update(rl.check_reps(dev, B_SLICE))
    rl.check_solve_loop_sass()
    rl.team_shapes(cuda_fused.library(
        fused_solver("cpu", torch.float32).kernel_source("team"),
        "fused_team"))

    cr.reset_launch_counts()
    ceilings = rl.fma_ceilings(dev)
    reps_times = rl.time_reps(dev, ceilings)
    launches = dict(cr.launches)
    for k in ("factor_reps team", "solve_reps team"):
        launches[k] = cr.route_launches[k]
    print(f"roofline: launches of the measurement T1 "
          f"{launches['fma_chains']} T2a {launches['factor_reps']} T2b "
          f"{launches['solve_reps']} (by route {cr.route_launches})")
    for k, v in launches.items():
        check(v > 0, f"the roofline measurement never launched {k}")
    rl.check_fma_sweep(dev, ceilings)
    rl.linear_algebra_share(reps_times, k1_ms / rl.K1_ITERS, "thread")
    share = rl.linear_algebra_share(reps_times, k1_team_ms / rl.K1_ITERS,
                                    "team")
    check(share <= 1.0, f"the team route's factor and two solves take "
          f"{100 * share:.1f}% of K1 team's iteration: more than all of it")
    t2a = reps_times[(B_SLICE, "float32")]["factor_ms"]
    print(f"roofline: T2a {t2a:.4f} ms per factorisation at n={N_AUG} "
          f"B={B_SLICE} float32 against K2's {k2_ms:.4f} ms")
    check(k2_ms / 3 <= t2a <= 3 * k2_ms, f"T2a's {t2a:.4f} ms per "
          f"factorisation is not within 3x of K2's {k2_ms:.4f} ms: the "
          f"repeated work is not what was asked for")
    for (B, name), row in sorted(reps_times.items()):
        print(f"roofline: T2a ms per factorisation at n={N_AUG} B={B} "
              f"{name}: team route {row['factor_team_ms']:.4f}, thread route "
              f"{row['factor_ms']:.4f}; bound "
              f"{rl.factor_bound(B, getattr(torch, name)):.6f}")
    team = reps_times[(B_SLICE, "float32")]["factor_team_ms"]
    print(f"roofline: T2a team route {team:.4f} ms per factorisation at "
          f"n={N_AUG} B={B_SLICE} float32 against one launch of K2's block "
          f"route there: {k2_block[0]:.4f} ms by CUDA events, its layout "
          f"work included, {k2_block[1]:.4f} ms device")
    rl.matmul_peaks(dev)

    # the kernels line: one launch each at a stated shape
    fac, sol = cr.fused_flops(N_AUG)
    S, L = T1_SHAPE
    x = torch.linspace(0.0, 1.0, S * L, dtype=torch.float32,
                       device=dev).reshape(S, L)
    K0, b0 = rl.reps_inputs(B_SLICE, torch.float32, dev)
    f32 = torch.float32
    # both routes read only K0's packed lower triangle (load_packed,
    # stage_packed): those are the bytes the function must move
    packed = N_AUG * (N_AUG + 1) // 2 * B_SLICE
    t = {
        "fma_chains": (
            time_cuda(lambda: cr.fma_chains(x, T1_CHAINS, T1_REPS), 50),
            time_cuda(lambda: cr.fma_chains_plain(x, T1_CHAINS, T1_REPS), 3),
            bound(2 * S * L, cr.fma_flops(S * L, T1_CHAINS, T1_REPS), f32)),
        "factor_reps": (
            time_cuda(lambda: cr.factor_reps(K0, T2_REPS), 20),
            time_cuda(lambda: cr.factor_reps_plain(K0, T2_REPS), 2),
            bound(packed + 2 * B_SLICE, T2_REPS * fac * B_SLICE, f32)),
        "factor_reps team": (
            time_cuda(lambda: cr.factor_reps(K0, T2_REPS, route="team"), 20),
            time_cuda(lambda: cr.factor_reps_plain(K0, T2_REPS), 2),
            bound(packed + 2 * B_SLICE, T2_REPS * fac * B_SLICE, f32)),
        "solve_reps": (
            time_cuda(lambda: cr.solve_reps(K0, b0, T2_REPS), 20),
            time_cuda(lambda: cr.solve_reps_plain(K0, b0, T2_REPS), 2),
            bound(packed + b0.numel() + 2 * B_SLICE,
                  (fac + T2_REPS * sol) * B_SLICE, f32)),
    }
    # the same plain version and bound as the thread route's
    t["solve_reps team"] = (
        time_cuda(lambda: cr.solve_reps(K0, b0, T2_REPS, route="team"), 20),
        *t["solve_reps"][1:])
    for k, (ms, plain_ms, bnd) in t.items():
        print(f"timing {k} float32 (ms per launch, CUDA events): kernel "
              f"{ms:.4f}, plain {plain_ms:.4f}; bound {bnd[0]:.6f} ms by "
              f"{bnd[1]}")
    # the library's solves of a launch: torch.linalg.ldl_solve on T2b's
    # factor, its T2_REPS right-hand sides as the columns of one call (no
    # library call factors without pivoting: the factor is not in it)
    L, D = _ldlt_soa(K0, PIVOT_FLOOR)
    rhs = torch.stack([b0 * (1.0 + 1e-6 * r) for r in range(T2_REPS)], -1)
    X = torch.stack([_solve_soa(L, D, rhs[..., r]) for r in range(T2_REPS)],
                    -1)
    t["library"] = time_library(
        f"torch.linalg.ldl_solve (T2b's {T2_REPS} solves) n={N_AUG} "
        f"B={B_SLICE} float32", ldl_solve_call(
            L.permute(2, 0, 1), D.t(), rhs.permute(1, 0, 2)),
        X.permute(1, 0, 2), 1e-4, 0)
    return errs, launches, t


def measure_phases(dev, ptxas):
    """Step 31: each T3 prefix of the thread and team routes held to its
    plain version at the fused slice's B=10240 and B=512, then the timed
    prefixes, whose launches are counted by route; then the block and
    wide routes (measure_wide_phases).  Returns the largest absolute
    difference (last prefix, float32, at B=10240; the wide route's in
    float64), the launch count by route ("phase" the thread route's,
    "phase team", "phase block", "phase wide" the others') and the
    kernels-line times of the last prefix by route."""
    import torch
    import chip_phases as ph
    from ipmzoo_tpu_torch.models import fused_phases as fp
    from ipmzoo_tpu_torch.ops import cuda_fused

    errs = {}
    for route in ph.ROUTES:
        key = "phase" if route == "thread" else f"phase {route}"
        errs[key] = ph.check_phases(dev, B_SLICE, route)["float32"]
        ph.check_phases(dev, ph.B_TILE, route)
    cuda_fused.reset_launch_counts()
    for B in (B_SLICE, ph.B_TILE):
        for dtype in (torch.float32, torch.float64):
            for route in ph.ROUTES:
                times, _ = ph.time_phases(dev, B, dtype,
                                          ptxas[("slice", route)], route)
                if B == B_SLICE:
                    ph.check_slopes(times, B,
                                    ph.point_solver("slice", dev, dtype),
                                    route)
                    if dtype == torch.float32:
                        check(all(b >= 0.97 * a
                                  for a, b in zip(times, times[1:])),
                              f"T3's {route} prefix times decrease: {times}")
                print(f"phases: {route} route B={B} "
                      f"{str(dtype).replace('torch.', '')}, ms a repetition:"
                      + "".join(f" {k} {v:.4f}," for k, v in
                                ph.phase_split(times).items()))
        ph.time_reference_points(dev, B)
    launches = {"phase": cuda_fused.phase_route_launches["phase thread"],
                "phase team": cuda_fused.phase_route_launches["phase team"]}
    print(f"phases: launches of the measurement T3 by route {launches}")
    for k, v in launches.items():
        check(v > 0, f"the phase measurement never launched T3's {k}")

    last = len(fp.PHASES) - 1
    solver, _, soa = ph.point_inputs("slice", B_SLICE, dev, torch.float32)
    plain_ms = time_cuda(lambda: fp.phase_plain(solver, soa, last, 1, 1), 2)
    bnd = bound(sum(a.numel() for a in soa) + 2 * B_SLICE,
                ph.phase_flops(last, solver) * B_SLICE, torch.float32)
    times = {}
    for route in ph.ROUTES:
        ms = time_cuda(lambda: fp.phase(solver, soa, last, 1, 1, route), 20)
        key = "phase" if route == "thread" else f"phase {route}"
        times[key] = (ms, plain_ms, bnd)
        print(f"timing T3 prefix {last} {route} route B={B_SLICE} float32 "
              f"(ms per launch, CUDA events): kernel {ms:.4f}, plain "
              f"{plain_ms:.4f}; bound {bnd[0]:.6f} ms by {bnd[1]}")
    w_errs, w_launches, w_times = measure_wide_phases(dev)
    errs.update(w_errs)
    launches.update(w_launches)
    times.update(w_times)
    return errs, launches, times


#: the block and wide routes' kernels-line points: (chip_phases point,
#: batch, type)
T3_WIDE_ROWS = {"phase block": ("wide", WIDE_SLICE_B, "float32"),
                "phase wide": ("wide route", 256, "float64")}


def measure_wide_phases(dev):
    """Step 31, T3's block and wide routes: with the launch counts set to 0
    just before, phase() with no route (the route K1 takes) holds every
    prefix at the wide slice's point (portfolio aug 129) at B=4096 and
    B=512, float32 and float64, and prefixes 2 and 4 at portfolio aug 257
    float64, B=256, to the plain version; the counts by route are read
    just after, and only the block and the wide route may have launched.
    Then one launch of prefix 4 on each route against the plain version
    and the bound (T3_WIDE_ROWS).  Returns errs, launches and times as
    measure_phases, keyed "phase block" / "phase wide"."""
    import torch
    import chip_phases as ph
    from ipmzoo_tpu_torch.models import fused_phases as fp
    from ipmzoo_tpu_torch.ops import cuda_fused

    t0 = time.perf_counter()
    cuda_fused.reset_launch_counts()
    batches, _, _ = ph.POINTS["wide"]
    errs = {"phase block": ph.check_phases(dev, batches[0], None,
                                           "wide")["float32"]}
    for B in batches[1:]:
        ph.check_phases(dev, B, None, "wide")
    errs["phase wide"] = ph.check_phases(
        dev, T3_WIDE_ROWS["phase wide"][1], None, "wide route",
        ("float64",), (2, 4))["float64"]
    counts = dict(cuda_fused.phase_route_launches)
    print(f"phases: launches of T3 at portfolio aug 129 and 257 by route "
          f"{counts}")
    check(counts["phase thread"] == counts["phase team"] == 0,
          f"another route stood in for T3's block or wide route: {counts}")
    launches = {k: counts[k] for k in T3_WIDE_ROWS}
    for k, v in launches.items():
        check(v > 0, f"T3 at the wide points never launched its {k} route")
    times = {}
    last = len(fp.PHASES) - 1
    for key, (point, B, name) in T3_WIDE_ROWS.items():
        dtype = getattr(torch, name)
        solver, _, soa = ph.point_inputs(point, B, dev, dtype)
        plain_ms = time_cuda(lambda: fp.phase_plain(solver, soa, last, 1, 1),
                             2)
        ms = time_cuda(lambda: fp.phase(solver, soa, last, 1, 1), 20)
        bnd = bound(sum(a.numel() for a in soa) + 2 * B,
                    ph.phase_flops(last, solver) * B, dtype)
        times[key] = (ms, plain_ms, bnd)
        print(f"timing T3 prefix {last} {key.split()[1]} route ({point}, "
              f"aug_dim {solver.aug_dim}) B={B} {name} (ms per launch, CUDA "
              f"events): kernel {ms:.4f}, plain {plain_ms:.4f}; bound "
              f"{bnd[0]:.6f} ms by {bnd[1]}")
    print(f"step 31, block and wide routes: {time.perf_counter() - t0:.1f} s")
    return errs, launches, times


#: (B, n, type, panel) at which step 35 holds the panel-blocked LDL^T to
#: the plain column LDL^T: bench_aug's KKT order 352 (three systems in
#: both types, its batch of 64 in float32), step 22's over-cap order 328,
#: and an uneven last panel (200 = 3 x 64 + 8)
BLOCKED_SHAPES = ((3, 352, "float64", 128), (3, 352, "float32", 128),
                  (64, 352, "float32", 128), (1, 328, "float64", 128),
                  (2, 200, "float64", 64), (2, 200, "float32", 64))
#: (B, n, type) at which step 36 times every LDL^T route and holds
#: ldlt_route to the fastest: bench_aug's KKT, the nd slice's generic top
#: and bench_normal's H (whose H^-1 the 'normal' mode binds)
LDLT_ROUTE_SHAPES = ((64, 352, "float32"), (1, 328, "float64"),
                     (16, 1024, "float32"))
#: the largest order at which step 36 times K2's SoA route (a thread per
#: matrix): at (16, 1024) float32 one call took 25.4 s on an H100, and
#: sweep_ldlt finds it 16-90x slower than the fastest route from n = 129
LDLT_SOA_TIMED = 352
#: K2's panel launch on the aug slice (B, panel order, type)
K2_PANEL = (64, 128, "float32")
#: sweep_ldlt's orders and batches, both types, and the most bytes one
#: batch of matrices may take
LDLT_SWEEP_N = (129, 160, 169, 192, 240, 256, 328, 352, 512, 1024)
LDLT_SWEEP_B = (1, 3, 16, 64, 512)
LDLT_SWEEP_BYTES = 2 ** 31


def card():
    """The card's name and power limit, for the lines that carry times."""
    from ipmzoo_tpu_torch.utils.device import nvidia_smi
    return nvidia_smi()


def quasi_definite_on(B, n, dtype, device, seed):
    """quasi_definite's matrices drawn on ``device`` by torch (the host's
    product takes minutes at sweep_ldlt's largest shapes): [[H, A^T],
    [A, -C]], H = M M^T / n1 + I, C diagonal in [0.5, ...), and b."""
    import torch
    g = torch.Generator(device).manual_seed(seed)
    n1 = (2 * n) // 3
    n2 = n - n1

    def randn(*shape):
        return torch.randn(shape, dtype=dtype, device=device, generator=g)
    M = randn(B, n1, n1)
    K = torch.zeros((B, n, n), dtype=dtype, device=device)
    K[:, :n1, :n1] = torch.matmul(M, M.transpose(1, 2)) / n1 + \
        torch.eye(n1, dtype=dtype, device=device)
    del M
    A = randn(B, n2, n1)
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = A.transpose(1, 2)
    K[:, n1:, n1:] = -torch.diag_embed(randn(B, n2).abs() + 0.5)
    return K, randn(B, n)


def check_blocked(dev):
    """Step 35: the panel-blocked LDL^T (ldlt_blocked, its panels on K2)
    and its solve against the plain column LDL^T and the plain sweeps on
    the card at BLOCKED_SHAPES: L, D and x within 1e-10 in float64, 1e-4
    in float32; one K2 launch a panel, on the block route; and an
    exactly-zero pivot at the second column of the second panel put on
    the floor in both.  Returns the largest absolute difference of x by
    shape."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.blocked_ldlt import (ldlt_blocked,
                                                   solve_ldlt_blocked)
    from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR, ldlt, solve_ldlt

    print(f"step 35 on {card()}")
    errs = {}
    for B, n, name, panel in BLOCKED_SHAPES:
        dtype = getattr(torch, name)
        tol = 1e-10 if dtype == torch.float64 else 1e-4
        panels = -(-n // panel)
        for zero in (False, True):
            K, b = quasi_definite(B, n, dtype, dev, seed=n + B)
            what = f"{name} B={B} n={n} panel={panel}"
            if zero:
                # rows and columns panel, panel + 1 hold only a block of
                # ones: the second pivot is exactly zero after the first
                # panel's trailing update, in both orderings
                K[:, panel:panel + 2, :] = 0.0
                K[:, :, panel:panel + 2] = 0.0
                K[:, panel:panel + 2, panel:panel + 2] = 1.0
                what += " zero pivot"
            cuda_ldlt.reset_launch_counts()
            L, D = ldlt_blocked(K, panel=panel)
            x = solve_ldlt_blocked(L, D, b)
            torch.cuda.synchronize()
            made = dict(cuda_ldlt.launches)
            routes = dict(cuda_ldlt.route_launches)
            check(made == {"ldlt": panels, "solve_ldlt": 0,
                           "solve_ldlt_matrix": 0, "ldlt_solve_matrix": 0}
                  and routes["ldlt block"] == panels and
                  routes["ldlt blocked"] == 1,
                  f"blocked LDL^T {what}: launches {made}, by route "
                  f"{routes}, expected {panels} K2 block-route panels")
            L0, D0 = ldlt(K)
            x0 = solve_ldlt(L0, D0, b)
            rl, rd, rx = rel_diff(L, L0), rel_diff(D, D0), rel_diff(x, x0)
            print(f"kernels blocked LDL^T {what}: {panels} K2 panel "
                  f"launches; rel diff L {rl:.3e} D {rd:.3e} x {rx:.3e} "
                  f"(limit {tol:g})")
            check(max(rl, rd, rx) <= tol, f"the blocked LDL^T disagrees "
                  f"with the plain version ({what}): {max(rl, rd, rx):.3e}")
            if zero:
                floor = torch.tensor(PIVOT_FLOOR, dtype=dtype)
                check(bool((D[:, panel + 1].cpu() == floor).all()) and
                      bool((D0[:, panel + 1].cpu() == floor).all()),
                      f"{what}: the floor is not on the zero pivot")
            else:
                errs[(B, n, name, panel)] = (x - x0).abs().max().item()
    return errs


def ldlt_route_call(route, A, b):
    """A factor and one solve by an LDL^T route: "soa" / "block" (K2 by
    that route with its caller's layout work, the solve by K3 on the
    route k3_route picks) or "blocked" (ldlt_blocked and its library
    solve)."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.blocked_ldlt import (ldlt_blocked,
                                                   solve_ldlt_blocked)
    if route == "blocked":
        L, D = ldlt_blocked(A)
        return solve_ldlt_blocked(L, D, b)
    L_t, D_t = k2_call(route, A)
    B, n = b.shape
    return k3_call(cuda_ldlt.k3_route(n, B, b.dtype), L_t, D_t,
                   b.t().contiguous()).t()


def ldlt_pick(n, B, dtype):
    """The route ldlt_auto takes: "blocked", or K2's "soa" / "block"."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    if cuda_ldlt.ldlt_route(n) == "blocked":
        return "blocked"
    return cuda_ldlt.k2_route(n, B, dtype)


def route_ms(fn, budget_ms=150.0, most=20):
    """Milliseconds per call of ``fn`` by CUDA events, back to back (the
    host's launch work counts where it is longer than the device's): one
    call after a warm-up, then as many as fit ``budget_ms`` (at most
    ``most``)."""
    one = time_cuda(fn, 1)
    reps = max(1, min(most, int(budget_ms / max(one, 1e-3))))
    return time_cuda(fn, reps) if reps > 1 else one


def ldlt_route_times(n, B, dtype, dev, skip=()):
    """Each LDL^T route's factor + one solve at (B, n) on quasi-definite
    matrices, ms per call (route_ms); the routes of ``skip`` are left
    out."""
    A, b = quasi_definite_on(B, n, dtype, dev, seed=n + B)
    routes = ("blocked",) + tuple(r for r in k2_routes(n, dtype)
                                  if r not in skip)
    return {r: route_ms(lambda r=r: ldlt_route_call(r, A, b))
            for r in routes}


def check_ldlt_routes(dev):
    """Step 36: every LDL^T route's factor + one solve at
    LDLT_ROUTE_SHAPES (CUDA events; K2's SoA route up to order
    LDLT_SOA_TIMED), beside torch.linalg.cholesky_ex on
    SPD matrices of the same shape (the nearest library call, not the
    same function); fail where ldlt_route's pick is more than 5% above
    the fastest route; then K2's block route at the aug slice's panel
    K2_PANEL against its plain version (1e-5), timed for the kernels
    line.  Returns that panel's times."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import ldlt

    print(f"step 36 on {card()}")
    for B, n, name in LDLT_ROUTE_SHAPES:
        dtype = getattr(torch, name)
        t = ldlt_route_times(n, B, dtype, dev, skip=(
            ("soa",) if n > LDLT_SOA_TIMED else ()))
        M = torch.randn((B, n, n), dtype=dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(n))
        H = torch.matmul(M, M.transpose(1, 2)) / n + \
            torch.eye(n, dtype=dtype, device=dev)
        del M
        check(int(torch.linalg.cholesky_ex(H).info.abs().max()) == 0,
              "not SPD")
        lib = route_ms(lambda: torch.linalg.cholesky_ex(H))
        del H
        pick = ldlt_pick(n, B, dtype)
        best = min(t, key=t.get)
        print(f"timing LDL^T routes B={B} n={n} {name} (factor + one "
              f"solve, ms per call, CUDA events): " +
              ", ".join(f"{r} {v:.4f}" for r, v in t.items()) +
              f"; torch.linalg.cholesky_ex on SPD matrices of the shape "
              f"{lib:.4f}; ldlt_route picks {pick}, the fastest is {best}")
        check(t[pick] <= 1.05 * t[best],
              f"ldlt_route picks {pick} at B={B} n={n} {name}: "
              f"{t[pick]:.4f} ms against {best}'s {t[best]:.4f}")

    B, n, name = K2_PANEL
    dtype = getattr(torch, name)
    A, _ = quasi_definite(B, n, dtype, dev, seed=5)
    L_t, D_t = cuda_ldlt.factor_block(A)
    L0, D0 = ldlt(A)
    err = max(rel_diff(L_t.permute(2, 0, 1), L0), rel_diff(D_t.t(), D0))
    print(f"kernels K2 block route at the aug slice's panel B={B} n={n} "
          f"{name}: rel diff {err:.3e} (limit 1e-5)")
    check(err <= 1e-5, f"K2 disagrees with its plain version at the panel "
          f"shape: {err:.3e}")
    M = torch.randn((B, n, n), dtype=dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    H = torch.matmul(M, M.transpose(1, 2)) / n + \
        torch.eye(n, dtype=dtype, device=dev)
    out = {"K2": time_cuda(lambda: cuda_ldlt.factor_block(A), 50),
           "K2_device": device_ms(lambda: cuda_ldlt.factor_block(A), 50),
           "K2_plain": time_cuda(lambda: ldlt(A), 3),
           "K2_library": time_cuda(lambda: torch.linalg.cholesky_ex(H), 50),
           "bound": ldlt_bounds(B, n, 1, dtype)["K2"],
           "err": (D_t.t() - D0).abs().max().item()}
    print(f"timing K2 block route at the panel B={B} n={n} {name} (ms per "
          f"call, CUDA events; _device: under torch.profiler): K2 "
          f"{out['K2']:.4f}, K2_device {out['K2_device']:.4f}, plain "
          f"{out['K2_plain']:.4f}, torch.linalg.cholesky_ex (SPD, nearest "
          f"library call) {out['K2_library']:.4f}; bound "
          f"{out['bound'][0]:.6f} ms by {out['bound'][1]}")
    return out


def sweep_ldlt(dev=None):
    """Every LDL^T route's factor + one solve (ldlt_route_times) over
    LDLT_SWEEP_N x LDLT_SWEEP_B, float32 and float64, shapes whose
    matrices take more than LDLT_SWEEP_BYTES left out: the measurement
    behind ldlt_route.  K2's SoA route (a thread per matrix, its time
    growing as n^3) is timed at a batch until it is 10x slower than the
    fastest route, and left out at larger orders there.  Prints each
    point, the points where ldlt_route's pick is more than 5% slower than
    the fastest (or was left out), and their count.  Not part of main();
    run it alone (about ten seconds after the ldlt.cu build; its output
    is long: send it to a file)."""
    import torch
    dev = dev or torch.device("cuda")
    print(f"sweep_ldlt on {card()}")
    points, misses = 0, []
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        lost = set()
        for n in LDLT_SWEEP_N:
            for B in LDLT_SWEEP_B:
                if B * n * n * ITEMSIZE[name] > LDLT_SWEEP_BYTES:
                    print(f"sweep {name} B={B} n={n}: left out (over "
                          f"{LDLT_SWEEP_BYTES} bytes)")
                    continue
                t = ldlt_route_times(n, B, dt, dev,
                                     skip=("soa",) if B in lost else ())
                best = min(t, key=t.get)
                if t.get("soa", 0.0) > 10 * t[best]:
                    lost.add(B)
                pick = ldlt_pick(n, B, dt)
                points += 1
                miss = pick not in t or t[pick] > 1.05 * t[best]
                if miss:
                    misses.append((name, B, n, pick, t.get(pick), best,
                                   t[best]))
                print(f"sweep {name} B={B} n={n}: ms " +
                      " ".join(f"{r} {v:.4f}" for r, v in t.items()) +
                      f"; ldlt_route picks {pick}, fastest {best}"
                      f"{' MISS' if miss else ''}", flush=True)
                torch.cuda.empty_cache()
    print(f"sweep_ldlt: ldlt_route within 5% of the fastest route at "
          f"{points - len(misses)} of {points} points; misses: {misses}")
    return misses


def cpu_reference(what, cpu_solver, data, n_inst):
    """``cpu_solver`` (float64 on the CPU) on the first ``n_inst``
    instances of ``data``, all converged."""
    import torch
    from ipmzoo_tpu_torch.models.state import tree_map
    sub = tree_map(lambda a: a[:n_inst].to("cpu", torch.float64), data)
    ref = cpu_solver.solve_batch(sub)
    check(bool(ref.converged.all()), f"{what}: the CPU float64 port did "
          f"not converge")
    return ref


def objectives_vs_cpu(what, res, ref, tol):
    """The objectives of ``res``'s first instances against ``ref`` (the
    CPU float64 port on the same data): |f_gpu - f_cpu| <= tol
    (1 + |f_cpu|)."""
    n_inst = ref.objective.shape[0]
    f_gpu = res.objective[:n_inst].double().cpu()
    diff = ((f_gpu - ref.objective).abs() /
            (1 + ref.objective.abs())).max().item()
    print(f"{what}: objectives of {n_inst} instances against the CPU "
          f"float64 port, largest |f_gpu - f_cpu| / (1 + |f_cpu|) "
          f"{diff:.3e} (limit {tol:g})")
    check(diff <= tol, f"{what}: objectives disagree with the CPU port")


def print_bench(mode, label, value, unit):
    print(f"bench_torch --mode {mode}: " + json.dumps(
        {"metric": label, "value": round(value, 1), "unit": unit,
         "vs_baseline": None}))


def run_aug_slice(dev):
    """Step 37: bench_torch.py's aug mode (64 QPs, n=256, m_ineq=64,
    m_eq=32, aug_dim 352, float32, refine=2, gondzio=2): 'blockg' and
    'auto' (the dense LDL^T on the route ldlt_route picks), each >= 99%
    converged; the objectives of the first 8 instances of each against
    the CPU float64 port ('blockg'); then one 'auto' solve with the
    launch counts set to 0 just before and read just after (K2's panel
    launches).  Returns those launches by route and the iterations."""
    import torch
    import bench_torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    print(f"step 37 on {card()}")
    label, value, unit, counts = bench_torch.bench_aug(dev)
    data = bench_torch.aug_data(dev)
    ref = cpu_reference("aug", bench_torch.aug_solver(
        "blockg", "cpu", torch.float64), data, 8)
    for k in ("blockg", "auto"):
        check(counts[k]["converged"] >= 0.99, f"aug kernel={k}: "
              f"{counts[k]['converged']} converged")
        objectives_vs_cpu(f"aug kernel={k}", counts[k]["result"], ref, 1e-4)
    print_bench("aug", label, value, unit)
    solver = bench_torch.aug_solver("auto", dev)
    check(solver._mode == "ldlt", f"aug 'auto' picks {solver._mode}")
    cuda_ldlt.reset_launch_counts()
    res = solver.solve_batch(data)
    torch.cuda.synchronize()
    routes = dict(cuda_ldlt.route_launches)
    iters = int(res.iterations.max().item())
    print(f"aug kernel=auto: one solve, {iters} iterations, ldlt_route "
          f"picks {cuda_ldlt.ldlt_route(solver.aug_dim)}"
          f"; launches {dict(cuda_ldlt.launches)}, by route {routes}")
    check(routes["ldlt block"] > 0, "the aug slice never launched K2")
    return routes, iters


def run_normal_slice(dev):
    """Step 38: bench_torch.py's normal mode (16 QPs, n=1024, m=128,
    float32, gondzio=2): 'blockg', 'block' and 'normal', each >= 99%
    converged, the objectives of the first 4 instances of each against
    the CPU float64 port ('block'); the 'normal' mode binds H^-1 through
    the blocked LDL^T, its panels on K2."""
    import torch
    import bench_torch
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    print(f"step 38 on {card()}")
    cuda_ldlt.reset_launch_counts()
    label, value, unit, counts = bench_torch.bench_normal(dev)
    print(f"normal: launches of the race {dict(cuda_ldlt.launches)}, by "
          f"route {dict(cuda_ldlt.route_launches)}")
    check(cuda_ldlt.route_launches["ldlt block"] > 0, "the normal mode "
          "never launched K2")
    n, m, B, _ = bench_torch.normal_sizes()
    data = make_batch(B, n, m, torch.float32, device=dev)
    ref = cpu_reference("normal", bench_torch.normal_solver(
        "block", "cpu", torch.float64), data, 4)
    for k in ("blockg", "block", "normal"):
        check(counts[k]["converged"] >= 0.99, f"normal kernel={k}: "
              f"{counts[k]['converged']} converged")
        objectives_vs_cpu(f"normal kernel={k}", counts[k]["result"], ref,
                          1e-4)
    print_bench("normal", label, value, unit)


def run_equality(dev):
    """Step 39: equality_qp(batch=64) (EqualityHandling.NONE, an
    indefinite augmented system) in float64 through 'auto' (= 'regldlt':
    K2 / K3 launched) and 'lu', all converged, x within 1e-6."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.models.families import equality_qp
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    print(f"step 39 on {card()}")
    fam = equality_qp(batch=64, device=dev)
    out = {}
    for kernel in ("auto", "lu"):
        s = CompiledIPM(fam.settings, n=fam.n, m_eq=fam.m_eq, kernel=kernel,
                        device=dev)
        cuda_ldlt.reset_launch_counts()
        t0 = time.perf_counter()
        res = s.solve_batch(fam.data)
        torch.cuda.synchronize()
        made = dict(cuda_ldlt.launches)
        print(f"equality_qp kernel={kernel} ({s._mode}): "
              f"{int(res.converged.sum())} of 64 converged, iterations "
              f"{int(res.iterations.max())}, {time.perf_counter() - t0:.3f} "
              f"s (host clock, first call); launches {made}")
        check(bool(res.converged.all()), f"equality_qp {kernel}")
        want = "regldlt" if kernel == "auto" else "lu"
        launched = made["ldlt"] > 0 and made["solve_ldlt"] > 0
        check(s._mode == want and launched == (kernel == "auto"),
              f"equality_qp kernel={kernel}: mode {s._mode}, launches "
              f"{made}; expected {want}, K2 and K3 launched by 'regldlt' "
              f"alone")
        out[kernel] = res.x
    d = (out["auto"] - out["lu"]).abs().max().item()
    print(f"equality_qp: regldlt against lu, largest |x| difference {d:.3e} "
          f"(limit 1e-6)")
    check(d <= 1e-6, f"regldlt and lu disagree: {d:.3e}")


def run_dense_modes(dev):
    """Step 40: bench_torch.py's arrow --dense, nd --dense and kkt --large
    through run_mode, each JSON line printed."""
    import bench_torch
    print(f"step 40 on {card()}")
    for mode, kw in (("arrow", dict(dense=True)), ("nd", dict(dense=True)),
                     ("kkt", dict(large=True))):
        t0 = time.perf_counter()
        label, value, unit, _ = bench_torch.run_mode(mode, dev, **kw)
        check(value > 0 and value == value, f"bench_torch {mode} {kw}: "
              f"value {value}")
        print(f"bench_torch --mode {mode} {kw}: "
              f"{time.perf_counter() - t0:.1f} s")
        print_bench(mode, label, value, unit)


def run_bench_modes(dev, data):
    """Step 33: bench_torch.py's `steps` and `kkt` modes through its own
    functions, on the slice's data."""
    import bench_torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    routes = {}
    for mode, run in (("steps", lambda: bench_torch.bench_steps(data, dev)),
                      ("kkt", lambda: bench_torch.bench_kkt(dev))):
        cuda_ldlt.reset_launch_counts()
        label, value, unit, counts = run()
        routes[mode] = dict(cuda_ldlt.route_launches)
        print(f"bench_torch --mode {mode}: launches by route {routes[mode]}")
        check(value > 0 and value == value, f"bench_torch {mode}: value "
              f"{value}")
        print(f"bench_torch --mode {mode}: " + json.dumps(
            {"metric": label, "value": round(value, 1), "unit": unit,
             "vs_baseline": None}))
    return routes


def profiled(fn, label, per_kernel=None):
    """Device busy ms and kernel launches of one call of ``fn`` (after
    one untraced call) under torch.profiler; prints the largest entries
    and appends every (kernel name, ms) to ``per_kernel`` if given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    if per_kernel is not None:
        per_kernel += [(e.key, e.self_device_time_total / 1e3)
                       for e in events]
    print(f"{label}: profiled device busy {busy:.3f} ms, kernel launches "
          f"{launches}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  "
              f"x{e.count:6d}  {e.key[:90]}")
    return busy, launches


def run_mpc_slice(dev):
    """Step 41: bench_torch.py's mpc mode at bench_mpc's defaults, >= 95%
    converged, objectives, u and x against the CPU float64 port at tol
    1e-8; wall, iterations, host syncs, launches per iteration and busy
    share."""
    import torch
    import bench_torch
    from ipmzoo_tpu_torch.models.mpc import RiccatiIPM

    print(f"step 41 on {card()}")
    check(bench_torch.mpc_sizes() == (MPC_T, MPC_NS, MPC_NU, MPC_BATCH),
          "the BENCH_MPC_* environment resizes bench_torch.py's mpc "
          "workload; the smoke test runs it at its defaults")
    label, value, unit, counts = bench_torch.bench_mpc(dev)
    res = counts["result"]
    conv = counts["converged"]
    print(f"mpc: {conv * 100:.2f}% of {MPC_BATCH} converged (gate 95%), "
          f"{int(counts['iterations'])} iterations summed, "
          f"{int(res.iterations.max())} the most, "
          f"{int(res.diverged.sum())} diverged")
    check(conv >= 0.95, f"mpc: {conv} converged")
    check(bool(torch.isfinite(res.u).all() & torch.isfinite(res.x).all()),
          "mpc: u or x not finite")
    data, solver = bench_torch.mpc_problem(dev)
    cpu = RiccatiIPM(MPC_T, MPC_NS, MPC_NU, tol=1e-8, device="cpu")
    ref = cpu.solve_batch(data.to("cpu", torch.float64))
    check(bool(ref.converged.all()), "mpc: the CPU float64 port did not "
          "converge")
    objectives_vs_cpu("mpc", res, ref, 1e-4)
    both = res.converged.cpu() & ref.converged
    worst = {k: (((getattr(res, k).cpu().double() - getattr(ref, k)).abs()
                  / (1 + getattr(ref, k).abs()))[both].max().item())
             for k in ("u", "x")}
    print(f"mpc: on the {int(both.sum())} instances both converge, largest "
          f"|v_gpu - v_cpu| / (1 + |v_cpu|): u {worst['u']:.3e}, x "
          f"{worst['x']:.3e} (limit 1e-3)")
    check(max(worst.values()) <= 1e-3, "mpc: u or x disagrees with the CPU "
          "float64 port")
    solver.solve_batch(data)
    solver.host_syncs = 0
    solver.solve_batch(data)
    syncs = solver.host_syncs
    steps = int(res.iterations.max())
    busy, launches = profiled(lambda: solver.solve_batch(data), "mpc")
    wall = counts["wall_ms"]
    print(f"mpc: wall median {wall:.3f} ms (CUDA events), {steps} "
          f"iterations, {wall / steps:.3f} ms per iteration, host syncs "
          f"{syncs} a solve, launches per iteration "
          f"{launches / steps:.1f}, busy {busy:.3f} ms = share "
          f"{busy / wall:.4f}")
    print_bench("mpc", label, value, unit)


def mpc_pair(solver_kw, data_kw, dev):
    """The same RiccatiIPM (float64, tol 1e-8) on the card and on the CPU,
    on random_mpc(**data_kw): (card result, CPU result)."""
    import torch
    from ipmzoo_tpu_torch.models.mpc import RiccatiIPM, random_mpc
    T, ns, nu = MPC_SMALL
    data = random_mpc(T, ns, nu, device=dev, **data_kw)
    out = []
    for d in (dev, torch.device("cpu")):
        s = RiccatiIPM(T, ns, nu, device=d, **solver_kw)
        one = s.solve_batch if data.batch_shape else s.solve
        out.append(one(data.to(d)))
    return data, out[0], out[1]


def check_mpc_f64(dev):
    """Step 42: float64 RiccatiIPM on the card against the CPU port:
    iterations equal, u, x, y within 1e-8 (1 + |v|) on every instance the
    CPU converges; converged / diverged equal everywhere."""
    import torch
    print(f"step 42 on {card()}")
    for what, skw, dkw in (
            ("random_mpc() solve", {}, {}),
            (f"random_mpc(batch={MPC_SMALL_BATCH}, state_bounds=True) "
             f"solve_batch, gondzio=2", dict(state_bounds=True, gondzio=2),
             dict(batch=MPC_SMALL_BATCH, state_bounds=True))):
        _, gpu, cpu = mpc_pair(skw, dkw, dev)
        its_g = gpu.iterations.reshape(-1).cpu()
        its_c = cpu.iterations.reshape(-1)
        conv_c = cpu.converged.reshape(-1)
        print(f"mpc f64 {what}: iterations card {its_g.tolist()}, CPU "
              f"{its_c.tolist()}; converged {conv_c.tolist()}, diverged "
              f"{cpu.diverged.reshape(-1).tolist()}")
        check(torch.equal(gpu.converged.reshape(-1).cpu(), conv_c) and
              torch.equal(gpu.diverged.reshape(-1).cpu(),
                          cpu.diverged.reshape(-1)),
              f"mpc f64 {what}: converged / diverged differ")
        check(bool(conv_c.any()), f"mpc f64 {what}: nothing converged")
        check(torch.equal(its_g[conv_c], its_c[conv_c]),
              f"mpc f64 {what}: iterations differ")
        worst = 0.0
        for k in ("u", "x", "y"):
            a = gpu.variables[k].cpu().reshape(len(conv_c), -1)[conv_c]
            b = cpu.variables[k].reshape(len(conv_c), -1)[conv_c]
            worst = max(worst, ((a - b).abs() / (1 + b.abs())).max().item())
        print(f"mpc f64 {what}: largest |v_gpu - v_cpu| / (1 + |v_cpu|) "
              f"over u, x, y of the converged instances {worst:.3e} (limit "
              f"1e-8)")
        check(worst <= 1e-8, f"mpc f64 {what}: u, x, y disagree")


def run_mpc_condensed(dev):
    """Step 43: condense() of the state-bounded batch through the dense
    CompiledIPM ('auto' = 'ldlt' at aug_dim 96) on the card, against
    RiccatiIPM's u and objectives; K2 / K3 launches by route."""
    import numpy as np
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.mpc import RiccatiIPM, condense, random_mpc
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    print(f"step 43 on {card()}")
    T, ns, nu = MPC_SMALL
    B, f64 = MPC_SMALL_BATCH, torch.float64
    data = random_mpc(T, ns, nu, batch=B, state_bounds=True, device=dev)
    mres = RiccatiIPM(T, ns, nu, state_bounds=True,
                      device=dev).solve_batch(data)
    qp, S, free = condense(data, device=dev)
    dense = CompiledIPM(Settings(), n=T * nu, m_ineq=T * ns, device=dev)
    n = dense.aug_dim
    check(n == MPC_AUG, f"condensed MPC: aug_dim {n}, steps 4 and 8 hold "
          f"K2 and K3 at {MPC_AUG}")
    check(dense._mode == "ldlt", f"condensed MPC: 'auto' picks "
          f"{dense._mode}, not 'ldlt'")
    cuda_ldlt.reset_launch_counts()
    dres = dense.solve_batch(qp)
    torch.cuda.synchronize()
    routes = {k: v for k, v in cuda_ldlt.route_launches.items() if v}
    print(f"condensed MPC (n={T * nu}, m_ineq={T * ns}, aug_dim {n}, "
          f"kernel '{dense._mode}'): iterations {dres.iterations.tolist()}; "
          f"K2 / K3 launches by route {routes} (k2_route "
          f"{cuda_ldlt.k2_route(n, B, f64)}, k3_route "
          f"{cuda_ldlt.k3_route(n, B, f64)})")
    check(cuda_ldlt.launches["ldlt"] > 0 and
          cuda_ldlt.launches["solve_ldlt"] > 0,
          "the condensed MPC solve launched no K2 / K3")
    conv = mres.converged.cpu()
    check(torch.equal(dres.converged.cpu(), conv) and bool(conv.any()),
          f"condensed MPC: converged {dres.converged.tolist()} against "
          f"RiccatiIPM's {conv.tolist()}")
    du = (mres.u.reshape(B, -1) - dres.x).abs().cpu()
    du = du[conv].max().item()
    Q, q = data.Q.cpu().numpy(), data.q.cpu().numpy()
    worst = 0.0
    for i in np.nonzero(conv.numpy())[0]:
        Qbar = np.zeros((T * ns, T * ns))
        for k in range(T):
            Qbar[k * ns:(k + 1) * ns, k * ns:(k + 1) * ns] = Q[i, k]
        const = 0.5 * free[i] @ Qbar @ free[i] + q[i].ravel() @ free[i]
        f = mres.objective[i].item()
        worst = max(worst, abs(f - dres.objective[i].item() - const) /
                    (1 + abs(f)))
    print(f"condensed MPC: {int(conv.sum())} of {B} "
          f"converged in both; largest |u - x_dense| {du:.3e} (limit "
          f"1e-6), objectives {worst:.3e} (limit 1e-6)")
    check(du <= 1e-6 and worst <= 1e-6, "condensed MPC disagrees with "
          "RiccatiIPM")


def run_tf_slice(dev, data):
    """Step 47: bench_torch.py's tf mode on the card: the first TF_B QPs of
    the slice's data (float32) through CompiledIPM(tol=1e-8,
    two_float=True, max_iter=30).solve_batch_compact, launch counts set to
    0 just before and read just after: >= 99% converged, finite float32
    x, K2 and K3 launched in float64 only (block and warp routes, no
    float32 launch, no other kernel); the same QPs in plain float32 at
    tol 1e-8 (no float64 escalation) converge on fewer than half; the
    first 256 against the port on the CPU in float64 at tol 1e-8:
    converged equal, the float64 iteration's x within 1e-8 and objectives
    within 1e-8 (1 + |f|), the float32 result within that plus its
    rounding; then bench_torch.bench_tf's wall (median of 3 after a
    warm-up, CUDA events) and JSON line.  Returns the counted run's
    launches by route."""
    import torch
    import bench_torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    t0 = time.perf_counter()
    print(f"step 47 on {card()}")
    sub = tree_map(lambda a: a[:TF_B], data)
    solver = bench_torch.tf_solver(dev)
    schedule = solver.default_schedule(TF_B)
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    res = solver.solve_batch_compact(sub)
    torch.cuda.synchronize()
    launches, f64 = dict(cuda_ldlt.launches), dict(cuda_ldlt.f64_launches)
    routes = dict(cuda_ldlt.route_launches)
    syncs = solver.host_syncs
    check(tuple(res.x.shape) == (TF_B, 16) and res.x.dtype == torch.float32,
          f"tf slice: x {tuple(res.x.shape)} {res.x.dtype}")
    check(bool(torch.isfinite(res.x).all()) and
          bool(torch.isfinite(res.objective).all()),
          "tf slice: non-finite x or objective")
    conv = res.converged.float().mean().item()
    iters = int(res.iterations.sum())
    print(f"tf slice: {TF_B} QPs n=16 m=8 float32 data, tol=1e-8, "
          f"two_float (float64 iteration), schedule {schedule}: converged "
          f"{conv:.6f} ({int(res.converged.sum())}/{TF_B}), diverged "
          f"{int(res.diverged.sum())}, iterations {iters} (largest "
          f"{int(res.iterations.max())}), host syncs {syncs}")
    f32 = {k: launches[k] - f64[k] for k in launches}
    made = {k: v for k, v in routes.items() if v}
    print(f"tf slice: launches K2 {launches['ldlt']} K3 "
          f"{launches['solve_ldlt']}: float64 K2 {f64['ldlt']} K3 "
          f"{f64['solve_ldlt']}, float32 K2 {f32['ldlt']} K3 "
          f"{f32['solve_ldlt']}; by route {made}")
    check(conv >= 0.99, f"tf slice convergence {conv} < 0.99")
    check(not any(f32.values()), f"the tf slice launched float32 kernels: "
          f"{f32}")
    check(f64["ldlt"] > 0 and f64["solve_ldlt"] > 0,
          "the tf slice never launched K2 or K3")
    check(made == {"ldlt block": launches["ldlt"],
                   "solve_ldlt warp": launches["solve_ldlt"]},
          f"the tf slice launched other routes or kernels: {made}")

    plain = bench_torch.compact_solver(dev, tol=bench_torch.TF_TOL,
                                       max_iter=30)
    pres = plain.solve_batch_compact(sub, esc_cap=0)
    pconv = pres.converged.float().mean().item()
    print(f"tf slice: plain float32 at tol 1e-8 (no escalation): converged "
          f"{pconv:.6f} ({int(pres.converged.sum())}/{TF_B})")
    check(pconv < 0.5, f"plain float32 reached 1e-8 on {pconv}: the slice "
          f"does not need two_float")

    k = 256
    cpu = tree_map(lambda a: a[:k].to("cpu", torch.float64), sub)
    ref = CompiledIPM(Settings(), 16, 8, dtype=torch.float64, tol=1e-8,
                      max_iter=30, device="cpu").solve_batch_compact(cpu)
    own = solver._tf.solve_batch_compact(
        tree_map(lambda a: a[:k].to(torch.float64), sub), esc_cap=0)
    check(bool(ref.converged.all()), "the CPU float64 port did not converge")
    check(torch.equal(res.converged[:k].cpu(), ref.converged),
          "tf slice: converged differs from the CPU float64 port")
    x_ref, f_ref = ref.x, ref.objective
    dx = (own.x.cpu() - x_ref).abs().max().item()
    df = ((own.objective.cpu() - f_ref).abs() / (1 + f_ref.abs())).max()
    over = ((res.x[:k].cpu().double() - x_ref).abs() -
            x_ref.abs() * 2.0 ** -24).max().item()
    print(f"tf slice: first {k} against the CPU float64 port: the float64 "
          f"iteration's x within {dx:.3e} (limit 1e-8), objectives "
          f"{df.item():.3e} (limit 1e-8 (1 + |f|)); the float32 result "
          f"beyond its rounding {over:.3e} (limit 1e-8)")
    check(dx <= 1e-8 and df.item() <= 1e-8 and over <= 1e-8,
          "tf slice disagrees with the CPU float64 port")

    label, value, unit, counts = bench_torch.bench_tf(data, dev)
    print(f"tf slice: wall {counts['wall_ms']:.3f} ms a batch solve, useful "
          f"iterations/s {value:.1f}, host syncs {counts['host_syncs']}")
    print_bench("tf", label, value, unit)
    print(f"step 47: {time.perf_counter() - t0:.1f} s")
    return routes


def floor_class(dev, dtype):
    """The 48 QPs of tests/test_precision_floor.py (n=16, m=8, numpy seed
    0), float32 data."""
    import numpy as np
    from ipmzoo_tpu_torch import QPData
    B, n, m = 48, 16, 8
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, n, n)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / n + np.eye(n, dtype=np.float32)
    raw = dict(Q=Q, c=rng.normal(size=(B, n)),
               A_ineq=rng.normal(size=(B, m, n)),
               l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
               u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
               l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0))
    return QPData.make(**{k: v.astype(np.float32) for k, v in raw.items()},
                       dtype=dtype, device=dev)


def run_precision_options(dev):
    """Step 48: the other precision options on the card, on the floor
    table's class: float32 with refine=2, hybrid_refine at 1e-6 (all
    converge), float32 with df_residuals at 1e-6 (at least the 47 of 48
    the reference and the CPU port converge: both stall on instance 21),
    none diverged; two_float on instances 0-2 by init_state and step to
    1e-8: residual and gap below 1e-8, x within 1e-9 of the float64 solve
    on the card."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.state import tree_map

    t0 = time.perf_counter()
    print(f"step 48 on {card()}")
    data = floor_class(dev, torch.float32)
    for opts, least in ((dict(refine=2, hybrid_refine=True), 48),
                        (dict(df_residuals=True), 47)):
        res = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-6,
                          device=dev, **opts).solve_batch(data)
        missed = torch.nonzero(~res.converged).flatten().tolist()
        print(f"precision float32 {opts} tol 1e-6: converged "
              f"{int(res.converged.sum())}/48 (not: {missed}), diverged "
              f"{int(res.diverged.sum())}, iterations "
              f"{int(res.iterations.sum())}")
        check(int(res.converged.sum()) >= least and
              not bool(res.diverged.any()),
              f"precision {opts}: fewer than {least} of 48 converged")
    rows = tree_map(lambda a: a[:3], data)
    x64 = CompiledIPM(Settings(), 16, 8, dtype=torch.float64, tol=1e-8,
                      device=dev).solve_batch(rows.to(dtype=torch.float64))
    check(bool(x64.converged.all()), "the float64 solve of rows 0-2")
    s = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-8,
                    two_float=True, device=dev)
    xi = s.var_index[s.symbols.x]
    for i in range(3):
        one = tree_map(lambda a: a[i], rows)
        st = s.init_state(one)
        for _ in range(30):
            if float(st.residual) < 1e-8 and float(st.gap) < 1e-8:
                break
            st = s.step(st, one)
        dx = (st.vars[xi] - x64.x[i]).abs().max().item()
        print(f"precision two_float row {i}: {int(st.iteration)} steps, "
              f"residual {float(st.residual):.3e} gap {float(st.gap):.3e}, "
              f"x within {dx:.3e} of the float64 solve (limit 1e-9)")
        check(float(st.residual) < 1e-8 and float(st.gap) < 1e-8 and
              dx < 1e-9, f"two_float row {i} misses 1e-8 or the f64 x")
    print(f"step 48: {time.perf_counter() - t0:.1f} s")


# -- the multi-device paths (steps 49-52) ------------------------------------

def sp_data(dev):
    """bench_schur's coupled QP of seed 0: SCHUR_BLOCKS blocks of order
    SCHUR_N with SCHUR_MC coupling rows, float32."""
    import bench_torch
    from ipmzoo_tpu_torch.models.state import tree_map
    return tree_map(lambda a: a[0], bench_torch.schur_data(
        dev, 1, SCHUR_BLOCKS, SCHUR_N, SCHUR_MC))


def sp_solver(mesh=None, dev=None):
    """bench_schur's solver: float32 data at tol 1e-8 (two_float: the
    iteration in float64), refine=2."""
    import torch
    from ipmzoo_tpu_torch.parallel import SchurIPM
    return SchurIPM(SCHUR_N, SCHUR_MC, mesh=mesh, device=dev,
                    dtype=torch.float32, tol=1e-8, refine=SP_REFINE,
                    max_iter=60)


def sp_counted(solver, data):
    """solve_sharded with the launch counts set to 0 just before and read
    just after, and the solver's factor / solve calls recorded by kernel
    and (order, [columns,] systems): (result, launches, float64
    launches, launches by route, calls by shape, host syncs)."""
    import collections
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    shapes = collections.Counter()
    for name, key in (
            ("_factor", lambda A: f"K2 ({A.shape[-1]}, {A.shape[0]})"),
            ("_solve", lambda f, r: f"K3 ({r.shape[-1]}, {r.shape[0]})"),
            ("_solve_mat", lambda f, R:
             f"K4 ({R.shape[1]}, {R.shape[2]}, {R.shape[0]})")):
        def recorded(*a, _call=getattr(solver, name), _key=key):
            shapes[_key(*a)] += 1
            return _call(*a)
        setattr(solver, name, recorded)
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    res = solver.solve_sharded(data)
    torch.cuda.synchronize()
    for name in ("_factor", "_solve", "_solve_mat"):
        delattr(solver, name)
    return (res, dict(cuda_ldlt.launches), dict(cuda_ldlt.f64_launches),
            {k: v for k, v in cuda_ldlt.route_launches.items() if v},
            dict(shapes), solver.host_syncs)


def check_sp_launches(what, iterations, world, launches, f64, routes,
                      shapes):
    """The counted launches and calls by shape against one rank's share
    of ``iterations`` iterations over ``world`` ranks: each factors the H
    blocks and S once, solves the H^-1 F^T panel once, H twice and S
    2 (1 + refine) times, every call one float64 launch."""
    b, it = SCHUR_BLOCKS // world, iterations
    want = {f"K2 ({SCHUR_N}, {b})": it, f"K2 ({SCHUR_MC}, 1)": it,
            f"K4 ({SCHUR_N}, {SCHUR_MC}, {b})": it,
            f"K3 ({SCHUR_N}, {b})": 2 * it,
            f"K3 ({SCHUR_MC}, 1)": 2 * (1 + SP_REFINE) * it}
    print(f"{what}: launches by shape (float64) {shapes}; by route "
          f"{routes}")
    check(shapes == want, f"{what}: calls by shape {shapes}, expected "
          f"{want}")
    by_kernel = {"ldlt": 2 * it, "solve_ldlt_matrix": it,
                 "solve_ldlt": (2 + 2 * (1 + SP_REFINE)) * it,
                 "ldlt_solve_matrix": 0}
    check(launches == by_kernel, f"{what}: launches {launches}, expected "
          f"{by_kernel}")
    check(f64 == launches, f"{what}: float32 launches {f64} of {launches}")


def run_sp_one_rank(dev):
    """Step 49: solve_sharded at one rank against solve on the card;
    returns (the local result, launches by route)."""
    import torch
    from ipmzoo_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    print(f"step 49 on {card()}")
    data = sp_data(dev)
    mesh = make_mesh()
    check(mesh.shape == {"dp": 1} and mesh.device == dev,
          f"one-rank mesh {mesh.shape} on {mesh.device}")
    solver = sp_solver(mesh)
    res, launches, f64, routes, shapes, syncs = sp_counted(solver, data)
    local = sp_solver(dev=dev).solve(data)
    it = int(res.iterations)
    check(solver.two_float and bool(res.converged) and
          tuple(res.x.shape) == (SCHUR_BLOCKS, SCHUR_N) and
          bool(torch.isfinite(res.x).all()),
          f"sp one rank: converged {bool(res.converged)}, x "
          f"{tuple(res.x.shape)}")
    dx = (res.x.double() - local.x.double()).abs().max().item()
    df = abs(float(res.objective) - float(local.objective)) / \
        abs(float(local.objective))
    print(f"sp one rank: {SCHUR_BLOCKS} blocks x n={SCHUR_N}, m_c="
          f"{SCHUR_MC}, float32 data, tol 1e-8 (float64 iteration): "
          f"{it} iterations, residual {float(res.residual):.3e}, gap "
          f"{float(res.gap):.3e}, host syncs {syncs}; against solve: x "
          f"{dx:.3e} (limit 1e-8), objective {df:.3e} relative (limit "
          f"1e-10)")
    check(dx <= 1e-8 and df <= 1e-10, "sp one rank disagrees with solve")
    check_sp_launches("sp one rank", it, 1, launches, f64, routes, shapes)
    for r in ("ldlt block", "solve_ldlt warp", "solve_ldlt_matrix warp"):
        check(routes.get(r, 0) > 0, f"sp one rank: {r} never launched")
    ms = time_solves(lambda: solver.solve_sharded(data), 5)
    print(f"sp one rank: wall {ms:.3f} ms a solve (CUDA events, median of "
          f"5), {ms / it:.3f} ms an iteration")
    print(f"step 49: {time.perf_counter() - t0:.1f} s")
    return local, routes


def sp_rank():
    """One rank of step 50 (run in a spawned process): the counted
    solve_sharded, then its wall and the host clock of one collective
    (a psum of S's size, staged through the host); plain values for the
    parent."""
    import torch
    import torch.distributed as dist
    from ipmzoo_tpu_torch.parallel import make_mesh
    from ipmzoo_tpu_torch.parallel.mesh import psum
    mesh = make_mesh()
    data = sp_data(mesh.device)
    solver = sp_solver(mesh)
    res, launches, f64, routes, shapes, syncs = sp_counted(solver, data)
    staged = mesh.host_syncs
    ms = time_solves(lambda: solver.solve_sharded(data), 5)
    S = torch.ones((1, SCHUR_MC, SCHUR_MC), dtype=torch.float64,
                   device=mesh.device)
    psum(S, mesh)
    t0 = time.perf_counter()
    for _ in range(20):
        psum(S, mesh)
    psum_ms = (time.perf_counter() - t0) / 20 * 1e3
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": dist.get_backend(), "x": res.x.double().cpu().numpy(),
            "objective": float(res.objective),
            "iterations": int(res.iterations),
            "converged": bool(res.converged), "launches": launches,
            "f64": f64, "routes": routes, "shapes": shapes,
            "host_syncs": syncs, "staged": staged, "ms": ms,
            "psum_ms": psum_ms}


def run_sp_two_ranks(local):
    """Step 50: solve_sharded at SP_WORLD ranks sharing the card, against
    step 49's solve."""
    import numpy as np
    from ipmzoo_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    print(f"step 50 on {card()}")
    outs = spawn(sp_rank, SP_WORLD, timeout=600)
    x0 = local.x.double().cpu().numpy()
    f0 = float(local.objective)
    for out in outs:
        check(out["converged"] and np.array_equal(out["x"], outs[0]["x"]),
              f"sp rank {out['rank']}: converged {out['converged']}, x "
              f"differs from rank 0's")
        print(f"sp rank {out['rank']} of {SP_WORLD} on {out['device']} "
              f"({out['backend']}): {out['iterations']} iterations, host "
              f"syncs {out['host_syncs']} ({out['staged']} collectives "
              f"staged through the host), wall {out['ms']:.3f} ms a solve "
              f"(CUDA events, median of 5); one staged psum of S "
              f"{out['psum_ms']:.4f} ms (host clock, mean of 20)")
        check_sp_launches(f"sp rank {out['rank']}", out["iterations"],
                          SP_WORLD, out["launches"], out["f64"],
                          out["routes"], out["shapes"])
    dx = float(np.abs(outs[0]["x"] - x0).max())
    df = abs(outs[0]["objective"] - f0) / abs(f0)
    print(f"sp {SP_WORLD} ranks against solve: x {dx:.3e} (limit 1e-8), "
          f"objective {df:.3e} relative (limit 1e-10)")
    check(dx <= 1e-8 and df <= 1e-10, "sp at two ranks disagrees with "
          "solve")
    print(f"step 50: {time.perf_counter() - t0:.1f} s")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_dp_sharded(dev):
    """Step 51: bench_torch.py --mode sharded at one rank in this process
    (launch counts set to 0 just before, read just after) and at
    SP_WORLD ranks, one process each started by the launch variables;
    returns the one-rank run's launches by route."""
    import os
    import subprocess
    import torch
    import bench_torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    t0 = time.perf_counter()
    print(f"step 51 on {card()}")
    cuda_ldlt.reset_launch_counts()
    label, value, unit, _ = bench_torch.run_mode("sharded", dev)
    torch.cuda.synchronize()
    routes = {k: v for k, v in cuda_ldlt.route_launches.items() if v}
    print(f"dp one rank: launches by route {routes}")
    check(cuda_ldlt.launches["ldlt"] > 0 and
          cuda_ldlt.launches["solve_ldlt"] > 0,
          "the dp slice never launched K2 or K3")
    print_bench("sharded", label, value, unit)

    env = dict(os.environ, WORLD_SIZE=str(SP_WORLD), MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "bench_torch.py"), "--mode",
         "sharded"], cwd=root,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(SP_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    values = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"bench_torch.py --mode sharded rank {r} "
              f"exited {p.returncode}:\n{out[-3000:]}")
        lines = out.strip().splitlines()
        rec = json.loads(lines[-1])
        summary = [ln for ln in lines if ln.startswith("dp scaling:")]
        print(f"dp rank {r} of {SP_WORLD}: {summary[-1]}")
        print(f"bench_torch --mode sharded rank {r}: {lines[-1]}")
        values.append(rec["value"])
    check(len(set(values)) == 1, f"the ranks report different values "
          f"{values}")
    print(f"step 51: {time.perf_counter() - t0:.1f} s")
    return routes


def run_dryrun(dev):
    """Steps 52 and 56: dryrun_multichip at SP_WORLD ranks on the card, its
    dp and sp checks (step 52) and its tp checks (step 56) in one run."""
    from ipmzoo_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    print(f"steps 52 and 56 on {card()}")
    diffs = dryrun_multichip(SP_WORLD)
    check(set(diffs) == {"dp-step", "schur", "schur-tf", "tp-ldlt",
                         "tp-ipm"}, f"dryrun checks {sorted(diffs)}")
    print(f"steps 52 and 56: {time.perf_counter() - t0:.1f} s")


def time_sp_kernels(dev, times):
    """K3's and K4's warp routes at the sp solve's one-rank shapes (float64,
    H blocks n=64, B=64; K4 with the panel's 16 columns) against their
    plain versions and torch.linalg.ldl_solve, by CUDA events; K2's from
    step 8 (``times``)."""
    import torch
    from ipmzoo_tpu_torch.ops.ldlt import solve_ldlt, solve_ldlt_matrix
    n, k, B, dt = SCHUR_N, SCHUR_MC, SCHUR_BLOCKS, torch.float64
    t = {"K2": times[(n, B, "float64")]}
    L, D, b, soa = k3_inputs(n, B, dt, dev, seed=n + B)
    x0 = solve_ldlt(L, D, b)
    t["K3_warp"] = time_cuda(lambda: k3_call("warp", *soa), 50)
    t["K3_plain"] = time_cuda(lambda: solve_ldlt(L, D, b), 5)
    t["K3_library"] = time_library(
        f"torch.linalg.ldl_solve (K3's function) n={n} B={B} float64",
        ldl_solve_call(L, D, b), x0, 1e-10, 2)
    L, D, R, soa = k4_inputs(n, k, B, dt, dev)
    X0 = solve_ldlt_matrix(L, D, R)
    t["K4_warp"] = time_cuda(lambda: k4_call("warp", *soa, R), 50)
    t["K4_plain"] = time_cuda(lambda: solve_ldlt_matrix(L, D, R), 5)
    t["K4_library"] = time_library(
        f"torch.linalg.ldl_solve (K4's function) n={n} k={k} B={B} "
        f"float64", ldl_solve_call(L, D, R), X0, 1e-10, 2)
    print(f"timing sp shapes n={n} k={k} B={B} float64 (ms per call, CUDA "
          f"events): " + ", ".join(f"{a} {v:.4f}" for a, v in t.items()
                                   if isinstance(v, float)))
    return t


# -- the tp path (steps 53-56) -----------------------------------------------

def tp_kkt(dtype, dev):
    """tests/test_sharded_ldlt.py's slow test's system on ``dev``: K =
    kkt(3584, 512, seed=3, scale=2.0) of order TP_DIM and b of seed 4."""
    import numpy as np
    import torch
    n, m, seed, scale = TP_KKT
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n, n))
    H = H @ H.T / n + scale * np.eye(n)
    S = rng.normal(size=(m, m))
    S = S @ S.T / m + np.eye(m)
    B = rng.normal(size=(m, n))
    K = np.block([[H, B.T], [B, -S]])
    b = np.random.default_rng(4).normal(size=n + m)
    return (torch.tensor(K, dtype=dtype, device=dev),
            torch.tensor(b, dtype=dtype, device=dev))


def tp_errors(K, L, D, x, b):
    """In float64: max |L D L^T - K|, max |K x - b|, the factor's
    elementwise backward error max |L D L^T - K| / (|L| |D| |L^T|) and the
    solve's normwise one max |K x - b| / max(|K| |x| + |b|)."""
    import torch
    K, L, D, x, b = (t.double() for t in (K, L, D, x, b))
    dK = ((L * D) @ L.T - K).abs()
    scale = (L.abs() * D.abs()) @ L.abs().T
    r = (K @ x - b).abs()
    return (dK.max().item(), r.max().item(),
            (dK / scale.clamp(min=torch.finfo(scale.dtype).tiny)).max()
            .item(), (r.max() / (K.abs() @ x.abs() + b.abs()).max()).item())


def tp_counted(mesh, A_loc, b):
    """The sharded factor and one solve with the launch counts and the
    mesh's staged collectives set to 0 just before and read just after:
    (factors, x, K2 launches, all launches, collectives staged, bytes
    staged)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt, sharded_ldlt, \
        sharded_ldlt_solve
    cuda_ldlt.reset_launch_counts()
    mesh.host_syncs = mesh.host_bytes = 0
    factors = sharded_ldlt(A_loc, mesh)
    x = sharded_ldlt_solve(factors, b, mesh)
    torch.cuda.synchronize()
    return (factors, x, cuda_ldlt.route_launches["ldlt block"],
            sum(cuda_ldlt.launches.values()), mesh.host_syncs,
            mesh.host_bytes)


def run_tp_factor(dev):
    """Step 53: the tp factor and solve at one rank on the card, float64
    and float32; returns step 54's float64 reference (D, x) and the K2
    row's numbers at the tp panel."""
    import torch
    from ipmzoo_tpu_torch.ops import shard_kkt, sharded_ldlt, \
        sharded_ldlt_solve
    from ipmzoo_tpu_torch.ops.blocked_ldlt import ldlt_blocked
    from ipmzoo_tpu_torch.ops.ldlt import ldlt
    from ipmzoo_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    print(f"step 53 on {card()}")
    mesh = make_mesh((1,), ("tp",))
    check(mesh.shape == {"tp": 1} and mesh.device == dev,
          f"one-rank mesh {mesh.shape} on {mesh.device}")
    stages = TP_DIM // TP_PANEL
    ref = {}
    for dtype, limit, same in ((torch.float64, 1e-9, 1e-11),
                               (torch.float32, None, 1e-4)):
        name = str(dtype).replace("torch.", "")
        K, b = tp_kkt(dtype, dev)
        A_loc = shard_kkt(K, mesh)
        factors, x, k2, total, _, _ = tp_counted(mesh, A_loc, b)
        L, _, D = factors
        check(k2 == stages and total == stages,
              f"tp factor {name}: {k2} K2 block launches of {total}, "
              f"expected {stages} (one a panel)")
        rec, res, ratio, eta = tp_errors(K, L, D, x, b)
        L0, D0 = ldlt_blocked(K[None])
        dL = (L - L0[0]).abs().max().item()
        dD = (D - D0[0]).abs().max().item()
        gamma = TP_DIM * torch.finfo(dtype).eps / 2
        print(f"tp factor {name}, n={TP_DIM}, panel {TP_PANEL}, one rank: "
              f"max|L D L^T - K| {rec:.3e}, max|K x - b| {res:.3e}; "
              f"against the backward error bound n u = {gamma:.3e}: "
              f"max |L D L^T - K| / (|L||D||L^T|) {ratio:.3e}, the solve's "
              f"{eta:.3e}; against ldlt_blocked on the card: L {dL:.3e}, "
              f"D {dD:.3e} (limit {same:g}); K2 launches {k2} (block "
              f"route), all launches {total}")
        if limit is None:
            check(ratio <= gamma and eta <= gamma, f"tp factor {name}: "
                  f"backward errors {ratio:.3e}, {eta:.3e} over n u = "
                  f"{gamma:.3e}")
        else:
            check(rec < limit and res < limit, f"tp factor {name}: "
                  f"reconstruction {rec:.3e} or residual {res:.3e} over "
                  f"{limit:g}")
        check(dL <= same and dD <= same, f"tp factor {name} differs from "
              f"ldlt_blocked: L {dL:.3e}, D {dD:.3e}")
        f_ms = time_solves(lambda: sharded_ldlt(A_loc, mesh), 3)
        s_ms = time_solves(lambda: sharded_ldlt_solve(factors, b, mesh), 3)
        blocked_ms = time_solves(lambda: ldlt_blocked(K[None]), 3)
        per_kernel = []
        busy, launches = profiled(lambda: sharded_ldlt(A_loc, mesh),
                                  f"tp factor {name}", per_kernel)
        k2_ms = sum(ms for k, ms in per_kernel
                    if "ldlt_factor_kernel_block" in k)
        print(f"tp factor {name}: wall {f_ms:.3f} ms a factor (ldlt_blocked "
              f"{blocked_ms:.3f}), {s_ms:.3f} ms a solve (CUDA events, "
              f"median of 3); K2 {k2_ms:.3f} ms of device time a factor, "
              f"{k2_ms / stages:.4f} a launch: {100 * k2_ms / f_ms:.1f}% "
              f"of the wall, {100 * k2_ms / busy:.1f}% of {busy:.3f} ms "
              f"busy, {launches} launches")
        if dtype == torch.float64:
            ref = {"D": D.cpu().numpy(), "x": x.cpu().numpy(), "A": K,
                   "launches": k2}
    # K2 at the tp panel: the system's first diagonal block, (1, 128) f64
    A = ref.pop("A")[None, :TP_PANEL, :TP_PANEL].contiguous()
    t = {"err": hold_k2(f"float64 n={TP_PANEL} B=1 (the tp panel)", A,
                        "block", 1e-12)[-1],
         "ms": device_ms(lambda: k2_call("block", A), 20),
         "events": time_cuda(lambda: k2_call("block", A), 20),
         "plain": time_cuda(lambda: ldlt(A), 3),
         "bound": ldlt_bounds(1, TP_PANEL, 1, torch.float64)["K2"]}
    check(int(torch.linalg.cholesky_ex(A).info.abs().max()) == 0,
          "the tp panel is not SPD")
    t["library"] = time_cuda(lambda: torch.linalg.cholesky_ex(A), 20)
    print(f"timing K2 block route at the tp panel n={TP_PANEL} B=1 float64 "
          f"(ms): device {t['ms']:.4f}, events {t['events']:.4f}, plain "
          f"{t['plain']:.4f}, bound {t['bound'][0]:.6f} by "
          f"{t['bound'][1]}; torch.linalg.cholesky_ex {t['library']:.4f} "
          f"(nearest library call, not the same function)")
    print(f"step 53: {time.perf_counter() - t0:.1f} s")
    return ref, t


def tp_rank(D1, x1):
    """One rank of step 54 (run in a spawned process): the counted
    float64 factor and solve, held to step 53's one-rank D and x and to
    ldlt_blocked's rows (which step 53 holds the one-rank factor to);
    its wall and the host clock of one staged panel broadcast."""
    import torch
    import torch.distributed as dist
    from ipmzoo_tpu_torch.ops import shard_kkt, sharded_ldlt, \
        sharded_ldlt_solve
    from ipmzoo_tpu_torch.ops.blocked_ldlt import ldlt_blocked
    from ipmzoo_tpu_torch.parallel import make_mesh
    from ipmzoo_tpu_torch.parallel.mesh import broadcast, shard_slice
    mesh = make_mesh((TP_WORLD,), ("tp",))
    K, b = tp_kkt(torch.float64, mesh.device)
    A_loc = shard_kkt(K, mesh)
    factors, x, k2, total, syncs, nbytes = tp_counted(mesh, A_loc, b)
    L, _, D = factors
    rows = ldlt_blocked(K[None])[0][0][shard_slice(TP_DIM, mesh, "tp")]
    ms = time_solves(lambda: sharded_ldlt_solve(
        sharded_ldlt(A_loc, mesh), b, mesh), 3)
    panel = A_loc[None, :TP_PANEL, :].contiguous()
    broadcast(panel, mesh, "tp", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        broadcast(panel, mesh, "tp", 0)
    bcast_ms = (time.perf_counter() - t0) / 20 * 1e3
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": dist.get_backend(), "rows": tuple(L.shape),
            "dL": (L - rows).abs().max().item(),
            "dD": float(abs(D.cpu().numpy() - D1).max()),
            "dx": float(abs(x.cpu().numpy() - x1).max()),
            "D": D.cpu().numpy(), "x": x.cpu().numpy(),
            "res": (K @ x - b).abs().max().item(), "k2": k2,
            "launches": total, "staged": syncs, "bytes": nbytes, "ms": ms,
            "bcast_ms": bcast_ms}


def tp_ranks(D1, x1):
    """One rank of steps 54 and 55 (a spawned process): step 54's factor
    and solve, then step 55's two-rank solve, in one process, so that the
    ranks start once."""
    return tp_rank(D1, x1), tp_ipm_rank()


def run_tp_two_ranks(ref):
    """Step 54: the tp factor and solve at TP_WORLD ranks sharing the card
    (gloo), against step 53's.  The same spawned ranks then run step 55's
    two-rank solve: returns their results, which run_tp_ipm checks."""
    import numpy as np
    from ipmzoo_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    print(f"step 54 on {card()}")
    both = spawn(tp_ranks, TP_WORLD, ref["D"], ref["x"], timeout=1500)
    outs = [b[0] for b in both]
    stages = TP_DIM // TP_PANEL
    for out in outs:
        print(f"tp rank {out['rank']} of {TP_WORLD} on {out['device']} "
              f"({out['backend']}): rows {out['rows']}; against step 53 L "
              f"{out['dL']:.3e}, D {out['dD']:.3e}, x {out['dx']:.3e} "
              f"(limit 1e-10); max|K x - b| {out['res']:.3e}; K2 launches "
              f"{out['k2']} of {out['launches']}; {out['staged']} "
              f"collectives staged through the host, {out['bytes']} bytes; "
              f"wall {out['ms']:.3f} ms a factor + solve (CUDA events, "
              f"median of 3); one staged panel broadcast (1, {TP_PANEL}, "
              f"{TP_DIM}) float64 {out['bcast_ms']:.4f} ms (host clock, "
              f"mean of 20)")
        check(max(out["dL"], out["dD"], out["dx"]) <= 1e-10,
              f"tp rank {out['rank']} differs from the one-rank factor")
        check(out["k2"] == stages and out["launches"] == stages,
              f"tp rank {out['rank']}: {out['k2']} K2 launches of "
              f"{out['launches']}, expected {stages}")
        check(out["staged"] == 3 * stages,
              f"tp rank {out['rank']}: {out['staged']} collectives staged, "
              f"expected {3 * stages} (a broadcast a panel, two a panel "
              f"in the solve)")
        check(np.array_equal(out["D"], outs[0]["D"]) and
              np.array_equal(out["x"], outs[0]["x"]),
              f"tp rank {out['rank']}: D or x differs from rank 0's")
    print(f"step 54 (with step 55's two-rank solve): "
          f"{time.perf_counter() - t0:.1f} s")
    return [b[1] for b in both]


def tp_qp(dev):
    """tests/test_sharded_ipm.py's slow test's box QP, n = TP_QP_N,
    float32, on ``dev``."""
    import numpy as np
    import torch
    from ipmzoo_tpu_torch.models.data import QPData
    n = TP_QP_N
    rng = np.random.default_rng(0)
    M = rng.normal(size=(n, n))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return QPData(Q=t(M @ M.T / n + np.eye(n)), c=t(rng.normal(size=n)),
                  A_ineq=t(np.zeros((0, n))), l_A_ineq=t(np.zeros(0)),
                  u_A_ineq=t(np.zeros(0)), A_eq=t(np.zeros((0, n))),
                  b_eq=t(np.zeros(0)), l_x=t(np.full(n, -2.0)),
                  u_x=t(np.full(n, 2.0)))


def tp_solver(kernel, mesh=None, dev=None):
    """The slow test's solver: BOX, float32, tol 1e-4, max_iter 40,
    scale_tol; kernel='sharded' at panel TP_PANEL."""
    import torch
    from ipmzoo_tpu_torch import Bounds, CompiledIPM, InequalityHandling, \
        Settings
    box = Settings(inequalities=Bounds.NONE,
                   inequality_handling=InequalityHandling.SLACKS)
    kw = dict(mesh=mesh, panel=TP_PANEL) if kernel == "sharded" else \
        dict(device=dev)
    return CompiledIPM(box, n=TP_QP_N, dtype=torch.float32, tol=TP_QP_TOL,
                       max_iter=TP_QP_ITER, scale_tol=True, kernel=kernel,
                       **kw)


def tp_solve_counted(solver, data, mesh=None):
    """solve with the launch counts (and the mesh's staged collectives)
    set to 0 just before and read just after: (result, K2 launches, all
    launches of the port's kernels, loop syncs, staged collectives,
    staged bytes)."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    if mesh is not None:
        mesh.host_syncs = mesh.host_bytes = 0
    res = solver.solve(data)
    torch.cuda.synchronize()
    return (res, cuda_ldlt.route_launches["ldlt block"],
            sum(cuda_ldlt.launches.values()), solver.host_syncs,
            0 if mesh is None else mesh.host_syncs,
            0 if mesh is None else mesh.host_bytes)


def tp_ipm_rank():
    """One rank of step 55's two-rank solve (in step 54's spawned
    processes, tp_ranks)."""
    from ipmzoo_tpu_torch.parallel import make_mesh
    mesh = make_mesh((TP_WORLD,), ("tp",))
    data = tp_qp(mesh.device)
    solver = tp_solver("sharded", mesh)
    res, k2, total, syncs, staged, nbytes = tp_solve_counted(solver, data,
                                                             mesh)
    ms = time_solves(lambda: solver.solve(data), 1)
    return {"rank": mesh.rank, "x": res.x.cpu().numpy(),
            "iterations": int(res.iterations),
            "converged": bool(res.converged), "k2": k2, "launches": total,
            "syncs": syncs, "staged": staged, "bytes": nbytes, "ms": ms,
            "device": str(mesh.device)}


def run_tp_ipm(dev, outs):
    """Step 55: kernel='sharded' on the slow test's QP at one rank and at
    TP_WORLD (``outs``: the ranks' results of tp_ipm_rank, which step 54's
    spawned processes ran), against kernel='jnp' on the card."""
    import numpy as np
    from ipmzoo_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    print(f"step 55 on {card()}")
    data = tp_qp(dev)
    jnp_res, jnp_k2, _, _, _, _ = tp_solve_counted(
        tp_solver("jnp", dev=dev), data)
    it = int(jnp_res.iterations)
    x0 = jnp_res.x.cpu().numpy()
    print(f"tp QP n={TP_QP_N} float32 tol {TP_QP_TOL:g} kernel='jnp': "
          f"converged {bool(jnp_res.converged)}, {it} iterations, K2 "
          f"{jnp_k2} ({jnp_k2 / max(it, 1):.1f} an iteration)")
    check(bool(jnp_res.converged), "the tp QP does not converge on 'jnp'")
    stages = TP_QP_N // TP_PANEL

    def hold(what, x, iters, converged, k2):
        dx = float(np.abs(x - x0).max())
        print(f"{what}: converged {converged}, {iters} iterations ('jnp' "
              f"{it}), x against 'jnp' {dx:.3e} (limit 5e-3), K2 {k2} "
              f"({k2 / max(iters, 1):.1f} an iteration)")
        check(converged and iters == it and dx <= 5e-3,
              f"{what}: converged {converged}, iterations {iters} against "
              f"{it}, x {dx:.3e}")
        check(k2 == stages * iters, f"{what}: {k2} K2 launches, expected "
              f"{stages} an iteration")

    mesh = make_mesh((1,), ("tp",))
    solver = tp_solver("sharded", mesh)
    res, k2, total, syncs, _, _ = tp_solve_counted(solver, data, mesh)
    iters = int(res.iterations)
    hold("tp QP kernel='sharded' one rank", res.x.cpu().numpy(), iters,
         bool(res.converged), k2)
    check(total == k2, f"tp one rank: port launches {total}, K2 {k2}")
    ms = time_solves(lambda: solver.solve(data), 3)
    busy, launches = profiled(lambda: solver.solve(data),
                              "tp QP kernel='sharded' one rank")
    print(f"tp QP one rank: wall {ms:.3f} ms a solve (CUDA events, median "
          f"of 3), {ms / iters:.3f} ms an iteration, {launches / iters:.1f} "
          f"launches an iteration, {100 * busy / ms:.1f}% busy, {syncs} "
          f"loop syncs")
    for out in outs:
        hold(f"tp QP kernel='sharded' rank {out['rank']} of {TP_WORLD}",
             out["x"], out["iterations"], out["converged"], out["k2"])
        print(f"tp QP rank {out['rank']} on {out['device']}: wall "
              f"{out['ms']:.3f} ms a solve (CUDA events, one run after "
              f"the counted one), {out['staged'] / out['iterations']:.1f} "
              f"collectives staged an iteration "
              f"({out['bytes'] / out['iterations'] / 1e6:.3f} MB), "
              f"{out['syncs']} loop syncs; x against one rank "
              f"{float(np.abs(out['x'] - res.x.cpu().numpy()).max()):.3e}")
        check(np.array_equal(out["x"], outs[0]["x"]),
              f"tp QP rank {out['rank']}: x differs from rank 0's")
    print(f"step 55: {time.perf_counter() - t0:.1f} s")
    return k2 // max(iters, 1)


#: step 57: the CLI demo's iterations on the port's CPU float64 run, one a
#: handling (slacks, slacked_slacks, naive_slacks)
CLI_ITERATIONS = (7, 12, 12)
#: step 58: tests/test_native.py's quasidefinite shapes (n1 + n2), the
#: regularised-LDL^T KKT shapes (n, m) and the batch (count, n, m), and
#: the compact slice's shape for the host-against-card line
NATIVE_QD = ((4, 2), (16, 9), (40, 23))
NATIVE_KKT = ((6, 2), (20, 8), (48, 17))
NATIVE_KKT_BATCH = (8, 12, 5)
#: step 59: the example twins (examples/torch_<name>.py)
EXAMPLES = ("batch_portfolio", "grid_qp", "arrow_chain", "distributed_schur")


def _captured(fn, *args, **kw):
    """``fn(*args, **kw)``'s result and what it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _cli_rows(text):
    """The numerical demo's rows: handling -> (x, f, iterations, residual,
    gap, converged), parsed from the CLI's output."""
    import re
    rows = {}
    for m in re.finditer(r"^  (\w+)\s+x = \(([^)]*)\), f = (\S+), iters = "
                         r"(\d+), residual = (\S+), gap = (\S+), converged "
                         r"= (\w+)$", text, re.M):
        rows[m.group(1)] = ([float(v) for v in m.group(2).split(",")],
                            float(m.group(3).rstrip(",")), int(m.group(4)),
                            float(m.group(5).rstrip(",")),
                            float(m.group(6).rstrip(",")),
                            m.group(7) == "True")
    return rows


def run_cli(dev):
    """Step 57: the CLI's -e and -n demos on the default device (the card),
    launch counts set to 0 just before and read just after, against the
    same demos with --device cpu."""
    from ipmzoo_tpu_torch.formulations import InequalityHandling
    from ipmzoo_tpu_torch.frontend import cli
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    t0 = time.perf_counter()
    print(f"step 57 on {card()}")
    cuda_ldlt.reset_launch_counts()
    rc, text = _captured(cli.main, ["-e", "-n"])
    routes = {k: v for k, v in cuda_ldlt.route_launches.items() if v}
    wall = time.perf_counter() - t0
    rc_cpu, text_cpu = _captured(cli.main, ["-e", "-n", "--device", "cpu"])
    print(text, end="")
    print(f"cli -e -n on the card: {wall:.2f} s, launches by route {routes}")
    check(rc == 0 and rc_cpu == 0, f"the CLI exited {rc} / {rc_cpu}")
    head = "Numerical optimization"
    check(text.split(head)[0] == text_cpu.split(head)[0],
          "the -e demo on the card differs from the CPU's")
    rows, rows_cpu = _cli_rows(text), _cli_rows(text_cpu)
    names = [h.value for h in InequalityHandling]
    check(list(rows) == names and list(rows_cpu) == names,
          f"the -n demo's rows {list(rows)} / {list(rows_cpu)}")
    for name, it_cpu in zip(names, CLI_ITERATIONS):
        x, f, it, res, gap, conv = rows[name]
        x0, f0, it0, _, _, _ = rows_cpu[name]
        dx = max(abs(a - b) for a, b in zip(x, x0))
        print(f"cli {name}: iterations {it} (CPU {it0}), x against the "
              f"CPU {dx:.1e}, residual {res:.2e}, gap {gap:.2e}")
        check(conv and it == it0 == it_cpu and dx <= 1e-8 and res < 1e-8
              and gap < 1e-8, f"the CLI's {name} solve on the card: "
              f"converged {conv}, iterations {it} against {it0} "
              f"({it_cpu} expected), x {dx:.1e}, residual {res:.2e}, gap "
              f"{gap:.2e}")
    check(cuda_ldlt.launches["ldlt"] > 0 and
          cuda_ldlt.launches["solve_ldlt"] > 0,
          "the CLI's demo never launched K2 or K3")
    print(f"step 57: {time.perf_counter() - t0:.1f} s")
    return routes


def native_qd(n1, n2, seed):
    """tests/test_native.py's quasidefinite matrix (numpy, float64)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n1, n1))
    H = H @ H.T + n1 * np.eye(n1)
    S = rng.normal(size=(n2, n2))
    S = S @ S.T + n2 * np.eye(n2)
    A = rng.normal(size=(n2, n1))
    return np.block([[H, A.T], [A, -S]])


def native_kkt(n, m, seed):
    """tests/test_native.py's indefinite KKT matrix with a zero dual
    block (numpy, float64)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    Q = Q @ Q.T / n + np.eye(n)
    A = rng.normal(size=(m, n))
    return np.block([[Q, A.T], [A, np.zeros((m, m))]])


def regldlt_on(K, b, signs, scale):
    """TestRegLDLTAgainstBK's recipe on ldlt_auto / solve_ldlt_auto: K
    (B, n, n) regularised by signs eps^(2/3) scale, factored once, solved
    with three refinement sweeps against K."""
    import torch
    from ipmzoo_tpu_torch.ops.cuda_ldlt import ldlt_auto, solve_ldlt_auto
    eps = torch.finfo(torch.float64).eps
    reg = torch.diag(torch.as_tensor(signs * eps ** (2 / 3) * scale,
                                     device=K.device))
    L, D = ldlt_auto(K + reg)
    x = solve_ldlt_auto(L, D, b)
    for _ in range(3):
        x = x + solve_ldlt_auto(L, D, b - torch.einsum("bij,bj->bi", K, x))
    return x


def run_native(dev):
    """Step 58: the native host tier (g++, ctypes) beside K2/K3 on the
    card in float64: the factors and solves of tests/test_native.py's
    shapes, the pivot floor, the regularised LDL^T against Bunch-Kaufman,
    and (printed, no gate) the host's batched factor + solve at the
    compact slice's shape against K2 + K3 there."""
    import os
    import numpy as np
    import torch
    from ipmzoo_tpu_torch import native
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.utils.timer import cuda_time, host_time

    t0 = time.perf_counter()
    print(f"step 58 on {card()}")
    info = native.build_info()
    print(f"native: {os.path.basename(info['path'])} by g++ {info['flags']}"
          f"{', built in %.2f s' % info['seconds'] if info['built'] else ''}")
    cuda_ldlt.reset_launch_counts()

    def on(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    for n1, n2 in NATIVE_QD:
        A = native_qd(n1, n2, seed=n1 + n2)
        b = np.random.default_rng(0).normal(size=n1 + n2)
        Ln, Dn = native.ldlt_factor(A)
        xn = native.ldlt_solve(Ln, Dn, b)
        L, D = cuda_ldlt.ldlt_auto(on(A)[None])
        x = cuda_ldlt.solve_ldlt_auto(L, D, on(b)[None])
        err = max(float(np.abs(L[0].cpu().numpy() - Ln).max()),
                  float(np.abs(D[0].cpu().numpy() - Dn).max()),
                  float(np.abs(x[0].cpu().numpy() - xn).max()))
        print(f"native against K2/K3 at {n1}+{n2}: {err:.2e} (limit 1e-9)")
        check(err <= 1e-9, f"native against K2/K3 at {n1}+{n2}: {err:.2e}")
    _, Dn = native.ldlt_factor(np.zeros((3, 3)))
    _, D = cuda_ldlt.ldlt_auto(torch.zeros(1, 3, 3, dtype=torch.float64,
                                           device=dev))
    print(f"pivot floor on a zero 3x3: native {Dn.tolist()}, K2 "
          f"{D[0].tolist()}")
    check(np.all(Dn == 1e-8) and bool((D == 1e-8).all()),
          "the pivot floor is not 1e-8 on both")

    for n, m in NATIVE_KKT:
        K = native_kkt(n, m, seed=n)
        b = np.random.default_rng(n + 1).normal(size=n + m)
        F, ipiv, infos = native.bunch_kaufman_factor(K)
        x_bk = native.bunch_kaufman_solve(F, ipiv, b)
        signs = np.concatenate([np.ones(n), -np.ones(m)])
        scale = max(1.0, float(np.max(np.abs(np.diag(K)))))
        x = regldlt_on(on(K)[None], on(b)[None], signs, scale)[0]
        err = float(np.abs(x.cpu().numpy() - x_bk).max())
        print(f"regularised LDL^T on K2/K3 against Bunch-Kaufman at ({n}, "
              f"{m}): {err:.2e} (limit 1e-9)")
        check(infos == 0 and err <= 1e-9,
              f"regldlt against Bunch-Kaufman at ({n}, {m}): {err:.2e}")
    count, n, m = NATIVE_KKT_BATCH
    Ks = np.stack([native_kkt(n, m, seed=100 + i) for i in range(count)])
    bs = np.random.default_rng(0).normal(size=(count, n + m))
    signs = np.concatenate([np.ones(n), -np.ones(m)])
    xs = regldlt_on(on(Ks), on(bs), signs, 1.0).cpu().numpy()
    err = 0.0
    for i in range(count):
        F, ipiv, _ = native.bunch_kaufman_factor(Ks[i])
        err = max(err, float(np.abs(
            xs[i] - native.bunch_kaufman_solve(F, ipiv, bs[i])).max()))
    print(f"regularised LDL^T on K2/K3 against Bunch-Kaufman, batch of "
          f"{count} x ({n}, {m}): {err:.2e} (limit 1e-9)")
    check(err <= 1e-9, f"the batched regldlt against Bunch-Kaufman: "
          f"{err:.2e}")
    routes = {k: v for k, v in cuda_ldlt.route_launches.items() if v}
    print(f"step 58 launches by route: {routes}")
    check(cuda_ldlt.launches["ldlt"] > 0 and
          cuda_ldlt.launches["solve_ldlt"] > 0,
          "step 58 never launched K2 or K3")

    K, b = quasi_definite(B_SLICE, N_AUG, torch.float64, dev, seed=58)
    Kh, bh = K.cpu().numpy(), b.cpu().numpy()
    xh = native.ldlt_factor_solve_batch(Kh, bh)
    xd = cuda_ldlt.solve_ldlt_auto(*cuda_ldlt.ldlt_auto(K), b)
    host = host_time(lambda: native.ldlt_factor_solve_batch(Kh, bh), runs=5)
    card_ms = cuda_time(lambda: cuda_ldlt.solve_ldlt_auto(
        *cuda_ldlt.ldlt_auto(K), b), runs=5)
    print(f"native ldlt_factor_solve_batch at ({B_SLICE}, {N_AUG}) float64 "
          f"on the host ({os.cpu_count()} cores): {host.ms:.4f} ms (median "
          f"of 5, spread {host.spread:.4f}); K2 + K3 at ({N_AUG}, {B_SLICE}) "
          f"float64 on the card: {card_ms.ms:.4f} ms (CUDA events, median "
          f"of 5, spread {card_ms.spread:.4f}); host / card "
          f"{host.ms / card_ms.ms:.2f}x; largest difference of x "
          f"{float(np.abs(xd.cpu().numpy() - xh).max()):.2e}")
    print(f"step 58: {time.perf_counter() - t0:.1f} s")
    return {"host_ms": host.ms, "card_ms": card_ms.ms}


def load_example(name):
    """examples/torch_<name>.py as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_run(name, **kw):
    """One run of the twin ``name``'s main (defaults but ``kw``) with every
    launch count set to 0 just before and read just after: its dict, its
    wall and the port's launches by route."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_cr, cuda_ldlt
    main = load_example(name).main
    cuda_ldlt.reset_launch_counts()
    cuda_cr.reset_launch_counts()
    t0 = time.perf_counter()
    out, text = _captured(main, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = {k: v for d in (cuda_ldlt.route_launches, cuda_cr.route_launches)
              for k, v in d.items() if v}
    print(text, end="")
    print(f"example torch_{name}{kw or ''}: wall {wall:.2f} s on the card, "
          f"launches by route {routes}; {json.dumps(out)}")
    return out, wall, routes


def run_examples(dev):
    """Step 59: the four example twins on the default device (the card) at
    their defaults, in this process: each one's printed quantities, wall
    and launches by route, gated; the grid twin once more with the nd path
    itself (nd_fallback=False), since at its default side the card's cost
    model takes 'blockg', whose factors are the library's Cholesky."""
    import torch

    t0 = time.perf_counter()
    print(f"step 59 on {card()}")
    check(not torch.distributed.is_initialized(),
          "a process group is joined before the examples run")
    walls = {}

    def launched(routes, *prefixes):
        return all(any(v for k, v in routes.items() if k.startswith(p + " "))
                   for p in prefixes)

    out, walls["portfolio"], r = example_run("batch_portfolio")
    check(out["converged"] == 1.0 and out["budget_residual"] <= 1e-8,
          f"portfolio: converged {out['converged']}, budget residual "
          f"{out['budget_residual']:.2e}")
    check(launched(r, "ldlt", "solve_ldlt"), f"portfolio: K2 / K3 not "
          f"launched ({r})")

    out, walls["grid"], r = example_run("grid_qp")
    check(out["nd_converged"] and out["dense_converged"] and
          out["max_dx"] <= 1e-6, f"grid: converged {out['nd_converged']} / "
          f"{out['dense_converged']}, max dx {out['max_dx']:.2e}")
    print(f"grid at its defaults: path taken '{out['mode']}', dense mode "
          f"'{out['dense_mode']}'; hand-written launches {sum(r.values())}")
    out, walls["grid nd"], r = example_run("grid_qp", nd_fallback=False)
    check(out["mode"] == "nd" and out["nd_converged"] and
          out["dense_converged"] and out["max_dx"] <= 1e-6,
          f"grid, nd path: mode {out['mode']}, converged "
          f"{out['nd_converged']} / {out['dense_converged']}, max dx "
          f"{out['max_dx']:.2e}")
    check(sum(r.values()) > 0, "grid, nd path: no hand-written kernel "
          "launched")

    out, walls["arrow"], r = example_run("arrow_chain")
    check(out["converged"] and out["dense_converged"] and
          out["max_dx"] <= 1e-3, f"arrow: converged {out['converged']} / "
          f"{out['dense_converged']}, max dx {out['max_dx']:.2e}")
    check(launched(r, "cr_factor", "cr_solve"), f"arrow: K6 / K7 not "
          f"launched ({r})")

    out, walls["schur"], r = example_run("distributed_schur")
    check(out["converged"] and out["coupling"] <= 1e-6 and
          out["devices"] == 1, f"schur: converged {out['converged']}, "
          f"coupling {out['coupling']:.2e}, devices {out['devices']}")
    check(launched(r, "ldlt", "solve_ldlt", "solve_ldlt_matrix"),
          f"schur: K2 / K3 / K4 not launched ({r})")
    print(f"step 59 walls (s): {json.dumps(walls)}")
    print(f"step 59: {time.perf_counter() - t0:.1f} s")
    return walls


#: step 60: repetitions of the three probes (their defaults: 5 runs)
PROBE_RUNS = 2
#: step 60's process is stopped after this many seconds
PROBE_DEADLINE_S = 600
#: step 60: the arrow phases on the card (float32) against the port's CPU
#: float64 run of the same phases, relative to the larger of 1 and the
#: output's largest magnitude
PROBE_ARROW_REL = 1e-4
#: step 60: the normal probe's float32 pieces (L L^T against H, H^-1 H
#: against I) and its step rows' x against each other, relative
PROBE_NORMAL_REL = 1e-4


def measured(rows, tool):
    """Step 60: every row of ``tool`` read its device time and launches
    from a whole trace (``utils/timer.device_calls``: none divided by a
    count of calls read off a lossy trace), both finite and above 0, and
    its host syncs (where it counts them) finite."""
    import math
    for r in rows:
        got = [r["device_ms"], r["launches"]] + ([r["syncs"]] if "syncs" in r
                                                  else [])
        check(r["whole"] and all(math.isfinite(v) for v in got) and
              r["device_ms"] > 0 and r["launches"] > 0,
              f"{tool} row {r.get('batch', '')} "
              f"{r['row'] if 'row' in r else r['key']}: whole trace "
              f"{r['whole']}, device ms {r['device_ms']}, launches "
              f"{r['launches']}, syncs {r.get('syncs')}")


def run_probes(dev):
    """Step 60: the port's counterparts of the reference's last three
    probes on the card at their defaults, each row printed with the card's
    name and power limit: chip_arrow_phases.py (n=4096, bandwidth 16, tip
    8, float32, the single instance and the batch of 32), whose phases at
    B=1 are held to the port's CPU float64 run of the same phases;
    chip_normal_probe.py (n=1024, m=128, B=8), whose pieces are checked
    and whose step rows must agree within each gondzio; and
    chip_compact_sched.py (the compact workload under the four schedules),
    each schedule >= 99% converged."""
    import torch
    import chip_arrow_phases as ap
    import chip_compact_sched as sched
    import chip_normal_probe as npb
    from ipmzoo_tpu_torch.utils.timer import host_syncs

    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    print(f"step 60 on {card()}")
    one = torch.ones(1, device=dev)
    check(host_syncs(lambda: one.sum().item(), 2) == 1,
          "torch's sync debug mode did not count one .item() a call: the "
          "probes' host syncs would read 0")
    measured(ap.run(device=dev, dtype=torch.float32, runs=PROBE_RUNS),
             "arrow phases")
    got = ap.results(dtype=torch.float32, device=dev)
    want = ap.results(dtype=torch.float64, device="cpu")
    # relative to the larger of 1 and the output's largest magnitude: qx
    # at the initial x (the bounds' midpoint, 0) is 0
    worst = {k: max(((a - b).abs().max() / b.abs().max().clamp(min=1.0))
                    .item() for a, b in zip(got[k], want[k]))
             for k in want}
    print(f"step 60 arrow phases, card float32 against CPU float64: "
          f"{json.dumps(worst)}")
    check(all(v <= PROBE_ARROW_REL for v in worst.values()),
          f"arrow phases off the CPU float64 run: {worst}")

    rows = npb.run(device=dev, dtype=torch.float32, runs=PROBE_RUNS)
    measured(rows, "normal probe")
    check(all(r["ms"] > 0 for r in rows), "a normal-probe row took no time")
    H, A, b1, Bm = (torch.tensor(a).to(dev) for a in
                    npb.problem(npb.N, npb.M, npb.B))
    outs = [fn() for _, fn in npb.pieces(H, A, b1, Bm)]
    L, hinv = torch.linalg.cholesky(H), outs[3]
    eye = torch.eye(npb.N, device=dev)
    errs = {"L L^T": rel_diff(L @ L.mT, H),
            "1 rhs": rel_diff(L @ outs[1], b1[..., None]),
            f"{npb.M} rhs": rel_diff(L @ outs[2], Bm),
            "H^-1 H": rel_diff(hinv @ H, eye.expand_as(H))}
    xs = {}
    for r in rows:
        if "x" in r:
            check(bool(torch.isfinite(r["x"]).all()), f"normal probe step "
                  f"{r['row']} gondzio={r['gondzio']}: x not finite")
            xs.setdefault(r["gondzio"], []).append((r["row"], r["x"]))
    for gz, group in xs.items():
        for label, x in group[1:]:
            errs[f"{label} gondzio={gz}"] = rel_diff(x, group[0][1])
    print(f"step 60 normal probe checks (relative): {json.dumps(errs)}")
    check(all(v <= PROBE_NORMAL_REL for v in errs.values()),
          f"normal probe pieces or step rows off: {errs}")

    for r in sched.run(device=dev, dtype=torch.float32, runs=PROBE_RUNS - 1):
        check(r["converged"] >= 0.99 and r["iterations"] > 0 and
              len(r["actives"]) == len(r["schedule"]),
              f"compact schedule {r['row']}: converged {r['converged']}")
    print(f"step 60: {time.perf_counter() - t0:.1f} s", flush=True)


def run_probes_apart():
    """Step 60 (run_probes) in a process of its own on the first card:
    torch.profiler in a process that has opened a few hundred sessions
    (this script's steps 8-31) returns empty traces, and the probes read
    launches and device time from it.  The kernels' libraries are built
    already, keyed by their text, so the process only loads them."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    sys.stdout.flush()
    proc = subprocess.Popen(
        [sys.executable, "-c", "import torch, chip_smoke; "
         "chip_smoke.run_probes(torch.device('cuda', 0))"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    try:
        proc.wait(timeout=PROBE_DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"step 60 exited {proc.returncode}")


def main():
    t_start = time.perf_counter()
    import torch
    from chip_roofline import banner
    from ipmzoo_tpu_torch.models.fused_source import team_lanes
    from ipmzoo_tpu_torch.ops import cuda_fused
    dev = banner("chip_smoke", "this smoke test runs")
    if dev is None:
        return 2

    import bench_torch
    check((bench_torch.BATCH, bench_torch.N, bench_torch.M_INEQ,
           bench_torch.TOL, bench_torch.TF_B, bench_torch.TF_TOL) ==
          (B_SLICE, 16, 8, 1e-6, TF_B, 1e-8),
          "the BENCH_* environment resizes bench_torch.py's workload; the "
          "smoke test runs it at its defaults")
    ptxas = build_kernels()
    report_route_builds()
    errs = check_kernels(dev)
    k2_errs = check_k2_routes(dev)
    k3_errs = check_k3_routes(dev)
    k4_errs = check_k4(dev)
    h64 = (SCHUR_N, SCHUR_MC, SCHUR_I * SCHUR_BLOCKS, "float64")
    errs["solve_ldlt_matrix"] = k4_errs[("thread",) + h64]
    errs["solve_ldlt_matrix warp"] = k4_errs[("warp",) + h64]
    solve_demo(dev)
    data, res, launches = run_slice(dev)
    compare_cpu(data, res)
    times = time_kernels(dev)
    k3_times = time_k3_routes(dev)
    time_k4_routes(dev)
    errs["fused"] = check_fused(dev)
    errs["fused team"] = check_fused_team(dev)
    f_out, f_launches = run_fused_slice(dev, data)
    compare_cpu_fused(data, f_out)
    k1_times = time_fused(dev)
    s_data = schur_data(dev)
    s_res, s_launches = run_schur(dev, s_data, 1e-8, 5)
    run_schur(dev, s_data, 1e-5, 3)
    compare_cpu_schur(s_data, s_res)
    s_times = check_schur_kernels(dev, s_data)["float64"]
    check(s_launches["solve_ldlt_matrix warp"] > 0, "the Schur slice never "
          "launched K4's warp route")
    check_cr(dev)
    time_k6_routes(dev)
    time_k7_routes(dev)
    a_solver, a_data, a_batch, a_launches, ab_launches = run_arrow_slice()
    check(a_launches["cr_factor cluster"] > 0, "the arrow slice never "
          "launched K6's cluster route")
    check(a_launches["cr_solve shared"] > 0, "the arrow slice never "
          "launched K7's shared route")
    cr_times, cr_errs = time_cr(a_solver, a_data, a_batch)
    errs.update(cr_errs)
    errs["ldlt_solve_matrix"], k5_errs = check_k5(dev)
    top_routes = check_nd_kkt()
    nd_launches, nd_objective = run_nd_slice()
    check(nd_launches["ldlt_solve_matrix split"] > 0, "the nd slice never "
          "launched K5's split route")
    k5_times = time_k5(dev)
    k5 = k5_times[K5_LEVEL + ("float32",)]
    r_errs, r_launches, r_times = measure_roofline(
        dev, times[B_SLICE]["K2"],
        (times[B_SLICE]["K2_block"], times[B_SLICE]["K2_block_device"]),
        k1_times[B_SLICE]["K1"], k1_times[B_SLICE]["K1_team"])
    errs.update(r_errs)
    p_errs, p_launches, p_times = measure_phases(dev, ptxas)
    errs.update(p_errs)
    bench_routes = run_bench_modes(dev, data)
    blocked_errs = check_blocked(dev)
    panel = check_ldlt_routes(dev)
    aug_routes, aug_iters = run_aug_slice(dev)
    run_normal_slice(dev)
    run_equality(dev)
    run_dense_modes(dev)
    run_mpc_slice(dev)
    check_mpc_f64(dev)
    run_mpc_condensed(dev)
    run_nd_crossover(dev, nd_objective)
    t_wide = time.perf_counter()
    w_times, w_errs = check_fused_wide(dev)
    w_launches, _ = run_wide_slice(dev)
    print(f"steps 45-46: {time.perf_counter() - t_wide:.1f} s")
    tf_launches = run_tf_slice(dev, data)
    run_precision_options(dev)
    sp_local, sp_routes = run_sp_one_rank(dev)
    sp_times = time_sp_kernels(dev, times)
    run_sp_two_ranks(sp_local)
    dp_routes = run_dp_sharded(dev)
    tp_ref, tp_k2 = run_tp_factor(dev)
    run_tp_ipm(dev, run_tp_two_ranks(tp_ref))
    run_dryrun(dev)
    t_new = time.perf_counter()
    run_cli(dev)
    run_native(dev)
    run_examples(dev)
    print(f"steps 57-59: {time.perf_counter() - t_new:.1f} s")
    run_probes_apart()

    loaded = [m for m in sys.modules
              if m in ("jax", "jaxlib", "ipmzoo_tpu", "bench", "tools")
              or m.startswith(("jax.", "jaxlib.", "ipmzoo_tpu.", "tools."))]
    check(not loaded, f"the port loaded JAX code or the reference's "
          f"scripts: {loaded}")

    def entry(name, source, key, n_launches, ms, plain_ms, bnd, library_ms,
              err=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": REPLACES[key], "launches": n_launches,
                "max_abs_err": errs[key] if err is None else err, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    t = times[B_SLICE]
    tf = times[(N_AUG, TF_B, "float64")]
    top = times[K2_OVER_CAP]
    b24 = ldlt_bounds(B_SLICE, N_AUG, 1, torch.float32)
    b64 = ldlt_bounds(SCHUR_I * SCHUR_BLOCKS, SCHUR_N, SCHUR_MC,
                      torch.float64)
    k1 = k1_times[B_SLICE]
    w_shape = WIDE_SHAPES[0][:4]
    w1 = w_times[w_shape + ("float32",)]
    w_solver = wide_case(*w_shape[:3], 1, torch.float32, "cpu")[0]
    w_warps = cuda_fused.block_warps(w_solver.k1_sizes(), torch.float32,
                                     w_solver.k1_slots()) or 4
    k1_lanes = team_lanes(fused_solver("cpu", torch.float32))
    kw = k5_times[K5_KKT + ("float32",)]
    ct, ct32 = cr_times[("float32", 1)], cr_times[("float32", ARROW_BATCH)]
    cb = cr_bounds(1, a_solver.N, a_solver.b, a_solver.t + 1, torch.float32)
    cb32 = cr_bounds(ARROW_BATCH, a_solver.N, a_solver.b, a_solver.t + 1,
                     torch.float32)
    shape = f"float32, N={a_solver.N}, b={a_solver.b}"
    k6_name = k6_pick(a_solver.N, a_solver.b, 1, torch.float32)
    kernels = [
        entry("K2 batched LDL^T factor, SoA route (float64, n=%d, B=%d: "
              "the nd generic top, over the block route's shared memory)"
              % K2_OVER_CAP, SOURCE, "ldlt", top_routes["ldlt soa"],
              top["K2_soa"], top["K2_plain"], top["bound"], None,
              k2_errs[("soa",) + K2_OVER_CAP + ("float64",)]),
        # the aug slice's K2 launches: the diagonal panels of the blocked
        # LDL^T that ldlt_route picks at its order 352
        entry("K2 block route, the panels of the blocked LDL^T (float32, "
              "n=%d, B=%d: the aug slice, %d iterations)"
              % (K2_PANEL[1], K2_PANEL[0], aug_iters), SOURCE, "ldlt",
              aug_routes["ldlt block"], panel["K2"], panel["K2_plain"],
              panel["bound"], panel["K2_library"], panel["err"]),
        # the tf slice's float64 factorisations and solves (step 47)
        entry(f"K2 block route (float64, n={N_AUG}, B={TF_B}: the tf "
              f"slice)", SOURCE, "ldlt", tf_launches["ldlt block"],
              tf["K2_block"], tf["K2_plain"], tf["bound"], None,
              k2_errs[("block", N_AUG, TF_B, "float64")]),
        entry(f"K3 warp route (float64, n={N_AUG}, B={TF_B}: the tf slice)",
              SOURCE, "solve_ldlt", tf_launches["solve_ldlt warp"],
              tf["K3_warp"], tf["K3_plain"],
              ldlt_bounds(TF_B, N_AUG, 1, torch.float64)["K3"],
              tf["K3_library"], k3_errs[("warp", N_AUG, TF_B, "float64")]),
        # the sp solve at one rank (step 49): its H blocks
        entry(f"K2 block route (float64, n={SCHUR_N}, B={SCHUR_BLOCKS}: the "
              f"sp solve, one rank)", SOURCE, "ldlt",
              sp_routes["ldlt block"], sp_times["K2"]["K2_block"],
              sp_times["K2"]["K2_plain"], sp_times["K2"]["bound"], None,
              k2_errs[("block", SCHUR_N, SCHUR_BLOCKS, "float64")]),
        entry(f"K3 warp route (float64, n={SCHUR_N}, B={SCHUR_BLOCKS}: the "
              f"sp solve, one rank)", SOURCE, "solve_ldlt",
              sp_routes["solve_ldlt warp"], sp_times["K3_warp"],
              sp_times["K3_plain"],
              ldlt_bounds(SCHUR_BLOCKS, SCHUR_N, 1, torch.float64)["K3"],
              sp_times["K3_library"],
              k3_errs[("warp", SCHUR_N, SCHUR_BLOCKS, "float64")]),
        entry(f"K4 warp route (float64, n={SCHUR_N}, k={SCHUR_MC}, "
              f"B={SCHUR_BLOCKS}: the sp solve, one rank)", SOURCE,
              "solve_ldlt_matrix warp", sp_routes["solve_ldlt_matrix warp"],
              sp_times["K4_warp"], sp_times["K4_plain"],
              ldlt_bounds(SCHUR_BLOCKS, SCHUR_N, SCHUR_MC,
                          torch.float64)["K4"], sp_times["K4_library"],
              k4_errs[("warp", SCHUR_N, SCHUR_MC, SCHUR_BLOCKS,
                       "float64")]),
        # the dp slice at one rank (step 51): K2 at the whole batch
        entry(f"K2 block route (float32, n={N_AUG}, B={B_SLICE}: the dp "
              f"slice, one rank)", SOURCE, "ldlt", dp_routes["ldlt block"],
              t["K2_block"], t["K2_plain"], t["bound"], None,
              k2_errs[("block", N_AUG, B_SLICE, "float32")]),
        entry(f"K3 warp route (float32, n={N_AUG}, B={B_SLICE}: the dp "
              f"slice, one rank)", SOURCE, "solve_ldlt",
              dp_routes["solve_ldlt warp"],
              k3_times[(N_AUG, B_SLICE, "float32")]["events"]["warp"],
              t["K3_plain"], b24["K3"], t["K3_library"],
              k3_errs[("warp", N_AUG, B_SLICE, "float32")]),
        # the tp factor at one rank (step 53): a launch a diagonal panel
        entry(f"K2 block route (float64, n={TP_PANEL}, B=1: the diagonal "
              f"panels of the tp factor, n={TP_DIM}, one rank; launches a "
              f"factor)", SOURCE, "ldlt", tp_ref["launches"], tp_k2["ms"],
              tp_k2["plain"], tp_k2["bound"], tp_k2["library"],
              tp_k2["err"]),
        entry(f"K2 block route (float64, n={SCHUR_N}, B="
              f"{SCHUR_I * SCHUR_BLOCKS})", SOURCE, "ldlt",
              s_launches["ldlt block"], s_times["K2_block"],
              s_times["K2_plain"], s_times["bound"], s_times["K2_library"],
              k2_errs[("block", SCHUR_N, SCHUR_I * SCHUR_BLOCKS,
                       "float64")]),
        # the thread route's launches on the slices' paths: k3_route
        # takes it only over the warp route's shared memory (n > 83) and
        # at n = 1, which no slice gives K3
        entry(f"K3 batched LDL^T solve, thread route (float32, n={N_AUG}, "
              f"B={B_SLICE})", SOURCE, "solve_ldlt",
              launches["solve_ldlt thread"] +
              s_launches["solve_ldlt thread"] +
              nd_launches["solve_ldlt thread"], t["K3"], t["K3_plain"],
              b24["K3"], t["K3_library"],
              k3_errs[("thread", N_AUG, B_SLICE, "float32")]),
        entry(f"K3 warp route (float64, n={SCHUR_N}, "
              f"B={SCHUR_I * SCHUR_BLOCKS})", SOURCE, "solve_ldlt",
              s_launches["solve_ldlt warp"], s_times["K3_warp"],
              s_times["K3_plain"], b64["K3"], s_times["K3_library"],
              k3_errs[("warp", SCHUR_N, SCHUR_I * SCHUR_BLOCKS,
                       "float64")]),
        # the thread route's launches on the slice's path: k1_route takes
        # it only where a block of teams overflows the shared memory
        entry(f"K1 fused whole-solve IPM, thread route (generated; "
              f"float32, cold max_iter=14, B={B_SLICE})", K1_SOURCE, "fused",
              f_launches["fused thread"], k1["K1"], k1["K1_plain"],
              k1["bound"], None),
        entry(f"K1 team route ({k1_lanes} lanes; generated; "
              f"float32, cold max_iter=14, B={B_SLICE})", K1_TEAM_SOURCE,
              "fused team", f_launches["fused team"], k1["K1_team"],
              k1["K1_plain"], k1["bound"], None),
        # launches: the wide slice's (step 46), at portfolio aug 129; the
        # wide route's are 0 where k1_route takes the block route there
        entry("K1 wide route (one warp an instance; generated; float32, "
              "tol %g, cold max_iter=14, portfolio n=%d aug %d, B=%d)"
              % (WIDE_SHAPES[0][4], w_shape[0], w_shape[0] + 1, w_shape[3]),
              K1_WIDE_SOURCE,
              "fused wide", w_launches.get("fused wide", 0), w1["K1_wide"],
              w1["K1_plain"], w1["bound"], None, w_errs[("wide",) + w_shape]),
        entry("K1 block route (one thread block an instance, W=%d; "
              "generated; float32, tol %g, cold max_iter=14, portfolio n=%d "
              "aug %d, B=%d)" % ((w_warps, WIDE_SHAPES[0][4], w_shape[0],
                                  w_shape[0] + 1, w_shape[3])),
              K1_BLOCK_SOURCE, "fused block",
              w_launches.get("fused block", 0), w1["K1_block"],
              w1["K1_plain"], w1["bound"], None,
              w_errs[("block",) + w_shape]),
        # the thread route's launches on the slice's path: k4_route takes
        # it only at small orders (below 6, more at large batches) and
        # over the warp route's 96 rows
        entry("K4 batched multi-rhs LDL^T solve, thread route (float64, "
              "n=64, k=16, B=512)", SOURCE, "solve_ldlt_matrix",
              s_launches["solve_ldlt_matrix thread"], s_times["K4"],
              s_times["K4_plain"], b64["K4"], s_times["K4_library"]),
        entry("K4 warp route (float64, n=64, k=16, B=512)", SOURCE,
              "solve_ldlt_matrix warp", s_launches["solve_ldlt_matrix warp"],
              s_times["K4_warp"], s_times["K4_plain"], b64["K4"],
              s_times["K4_library"]),
        # the block route's launches on the slice's path: k5_route takes
        # it only where the split route's shared memory does not hold a
        # matrix with its right-hand sides
        entry("K5 fused LDL^T factor + multi-rhs solve, block route "
              "(float32, B=%d, n=%d, k=%d)" % K5_LEVEL, SOURCE,
              "ldlt_solve_matrix", nd_launches["ldlt_solve_matrix block"],
              k5["K5_block"], k5["K5_plain"], k5["bound"], k5["library"],
              k5_errs[("block",) + K5_LEVEL + ("float32",)]),
        entry("K5 split route (float32, B=%d, n=%d, k=%d)" % K5_LEVEL,
              SOURCE, "ldlt_solve_matrix split",
              nd_launches["ldlt_solve_matrix split"], k5["K5_split"],
              k5["K5_plain"], k5["bound"], k5["library"],
              k5_errs[("split",) + K5_LEVEL + ("float32",)]),
        entry("K5 small-order route (float32, %d, %d, %d)" % K5_KKT, SOURCE,
              "ldlt_solve_matrix",
              bench_routes["kkt"]["ldlt_solve_matrix warp"], kw["K5_warp"],
              kw["K5_plain"], kw["bound"], kw["library"],
              k5_errs[("warp",) + K5_KKT + ("float32",)]),
        # the block route's launches on the slice: the batch of
        # ARROW_BATCH, past the cluster route's largest batch
        entry(f"K6 whole-reduction cyclic-reduction factor, block route "
              f"({shape}, B={ARROW_BATCH})", CR_SOURCE, "cr_factor",
              ab_launches["cr_factor block"], ct32["K6"], ct32["K6_plain"],
              cb32["K6"], None),
        entry(f"K6 cluster route ({k6_name}; {shape}, B=1)", CR_SOURCE,
              "cr_factor cluster", a_launches["cr_factor cluster"],
              ct["K6_cluster"], ct["K6_plain"], cb["K6"], None),
        # the block route's launches on the slice: k7_route takes it only
        # where no group of columns fits a block's shared memory
        entry(f"K7 cyclic-reduction multi-rhs solve, block route ({shape}, "
              f"k={a_solver.t + 1}, B=1)", CR_SOURCE, "cr_solve",
              a_launches["cr_solve block"], ct["K7_k9"], ct["K7_k9_plain"],
              cb["K7"], None),
        entry(f"K7 shared route ({shape}, k={a_solver.t + 1}, B=1)",
              CR_SOURCE, "cr_solve shared", a_launches["cr_solve shared"],
              ct["K7s_k9"], ct["K7_k9_plain"], cb["K7"], None),
        entry("T1 FMA chains (float32, %s, chains=%d, reps=%d)"
              % (T1_SHAPE, T1_CHAINS, T1_REPS), ROOFLINE_SOURCE,
              "fma_chains", r_launches["fma_chains"],
              *r_times["fma_chains"], None),
        entry(f"T2a in-kernel LDL^T factor repetitions (float32, n={N_AUG}, "
              f"B={B_SLICE}, reps={T2_REPS})",
              ROOFLINE_SOURCE, "factor_reps",
              r_launches["factor_reps"] - r_launches["factor_reps team"],
              *r_times["factor_reps"], None),
        entry(f"T2a team route (team_ldlt, 16 lanes an instance, K and D "
              f"in shared memory; float32, n={N_AUG}, B={B_SLICE}, "
              f"reps={T2_REPS})", ROOFLINE_SOURCE + " + "
              "ipmzoo_tpu_torch/csrc/fused_team.cuh", "factor_reps team",
              r_launches["factor_reps team"], *r_times["factor_reps team"],
              None),
        entry(f"T2b in-kernel LDL^T solve repetitions (float32, n={N_AUG}, "
              f"B={B_SLICE}, one factor + reps={T2_REPS})", ROOFLINE_SOURCE,
              "solve_reps",
              r_launches["solve_reps"] - r_launches["solve_reps team"],
              *r_times["solve_reps"], r_times["library"]),
        entry(f"T2b team route (team_ldlt once, then team_ldlt_solve a "
              f"repetition, 16 lanes an instance, K, D and b in shared "
              f"memory; float32, n={N_AUG}, B={B_SLICE}, one factor + "
              f"reps={T2_REPS})", ROOFLINE_SOURCE + " + "
              "ipmzoo_tpu_torch/csrc/fused_team.cuh", "solve_reps team",
              r_launches["solve_reps team"], *r_times["solve_reps team"],
              r_times["library"]),
        entry(f"T3 fused iteration prefix 4 (generated; float32, "
              f"B={B_SLICE}, one repetition)", T3_SOURCE, "phase",
              p_launches["phase"], *p_times["phase"], None),
        entry(f"T3 team route prefix 4 ({k1_lanes} lanes an instance; "
              f"generated; float32, B={B_SLICE}, one repetition)",
              T3_TEAM_SOURCE, "phase team", p_launches["phase team"],
              *p_times["phase team"], None),
        entry("T3 block route prefix 4 (one thread block of W=%d warps an "
              "instance; generated; float32, portfolio n=%d aug %d, B=%d, "
              "one repetition)" % (w_warps, w_shape[0], w_shape[0] + 1,
                                   WIDE_SLICE_B), T3_BLOCK_SOURCE,
              "phase block", p_launches["phase block"],
              *p_times["phase block"], None),
        entry("T3 wide route prefix 4 (one warp an instance; generated; "
              "float64, portfolio n=256 aug 257, B=%d, one repetition)"
              % T3_WIDE_ROWS["phase wide"][1], T3_WIDE_SOURCE, "phase wide",
              p_launches["phase wide"], *p_times["phase wide"], None),
    ]
    for k in kernels:
        print(f"bound: {k['name']}: {k['bound_ms']:.6f} ms by "
              f"{k['bound_by']}; kernel {k['ms']:.4f} ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"builds included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
