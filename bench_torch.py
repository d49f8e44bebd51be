#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: the counterpart of bench.py.

    python3 bench_torch.py --mode fused|solve|steps|kkt|schur|arrow|nd|
                                  normal|aug|mpc|tf|sharded|wide
                           [--device cpu] [--batch B] [--dense] [--large]

runs ONE convergence-gated engine of ``ipmzoo_tpu_torch`` on the CUDA
card (``--device cpu`` asks for the CPU; there is no fallback) and prints
one JSON line last:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": null}

The workloads, gates and counts are bench.py's:

* ``fused`` (default) — the 10240 QPs of ``make_batch`` (seed 0, n=16,
  m_ineq=8, float32, tol 1e-6) through
  ``FusedBatchedIPM(max_iter=30).solve_fused_compact``; >= 99.9% must
  converge; useful iterations/s = per-instance iterations summed over
  the batch, over the wall of one whole-batch solve.
* ``solve`` — the same QPs through ``CompiledIPM.solve_batch_compact``;
  >= 99%.
* ``steps`` — after the same gate, 10 batched ``step``s from the initial
  state: batch x 10 over their wall.
* ``kkt`` — the fused LDL^T factor + 2-column solve (kernel K5) on
  BATCH systems of order N + 2 M, graded by the dense-LDL^T flop model;
  with ``--large`` also the signed block Cholesky (``ops/blockg.py``)
  with two solves on quasi-definite systems of order 1024 and 4096
  (BENCH_KKT_DIMS), the best of which is the value.
* ``schur`` — 8 block-separable coupled QPs (64 blocks, n=64, 16
  coupling rows) through ``SchurIPM`` at tol 1e-8; >= 99%.
* ``arrow`` — the n=4096 banded+arrow box QP (bandwidth 16, tip 8)
  through ``ArrowIPM.solve``; must converge; useful iterations/s and ms
  per iteration of the structured solve; with ``--dense`` the value is
  the structured step's speed-up over the dense ``CompiledIPM`` step
  (``'auto'``, here ``'blockg'``) on the same QP, ms per step of each by
  the slope between two step counts.
* ``nd`` — ``grid_qp(side=64)`` (n=4096) through
  ``CompiledIPM(kernel="nd")``; must converge; ``--dense`` as for arrow.
* ``normal`` — 16 QPs of ``make_batch`` at n=1024, m=128 (float32, tol
  1e-5 scaled, gondzio=2) through the normal-equations stagings
  ``'blockg'``, ``'block'`` and ``'normal'``: the fastest of those with
  >= 99% converged is the value, with bench.py's flop model.
* ``aug`` — 64 equality + inequality QPs (n=256, m_ineq=64, m_eq=32,
  REGULARIZATION, aug_dim 352; float32, tol 1e-5 scaled, refine=2,
  gondzio=2) through ``'blockg'`` and ``'auto'`` (dense LDL^T, the
  panel-blocked path at this order); the faster with >= 99% converged.
* ``mpc`` — 256 random stable tracking MPC instances (``random_mpc``,
  seed 0, horizon T=32, ns=8 states, nu=4 controls, float32) through
  ``RiccatiIPM(tol=1e-5, max_iter=40).solve_batch``; >= 95% must
  converge; useful iterations/s.
* ``tf`` — the first 2048 QPs of the ``solve`` batch (float32 data)
  through ``CompiledIPM(tol=1e-8, two_float=True, max_iter=30)
  .solve_batch_compact``: the reference-parity tolerance, which float32
  cannot reach; ``two_float`` runs the iteration in float64 (K2/K3's
  float64 instantiations on the card) and returns float32; >= 99% must
  converge; useful iterations/s.
* ``wide`` — the fused engine above augmented order 128, where K1 runs
  its wide routes: ``portfolio(n_assets=128, batch=4096, seed=0)``
  (aug_dim 129, float32, tol 1e-6) through
  ``FusedBatchedIPM.solve_fused_compact()`` (its default schedule and
  escalation); >= 99.9% must converge; useful iterations/s as the fused
  mode.  bench.py has no such mode: its sizes are BENCH_WIDE_B and
  BENCH_WIDE_ASSETS.
* ``sharded`` — bench.py's bench_sharded: ``dp_scaling_report`` of the
  ``solve`` solver on the same 10240 QPs, 10 steps, over the ranks of
  the process group: rank 0 steps the whole batch alone, then every rank
  its slice at once; the value is the sharded useful iterations/s, the
  report's summary stands on an earlier line.  It joins the process
  group when ``WORLD_SIZE`` > 1 is set (``RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT`` beside it, one process per rank; every rank prints the
  same report), else runs one rank.  Ranks on one card time-slice it.

The BENCH_* environment variables of bench.py size the workloads
(BENCH_BATCH, BENCH_N, BENCH_M, BENCH_STEPS, BENCH_TOL, BENCH_SCHUR_*,
BENCH_ARROW_*, BENCH_ND_*, BENCH_NORMAL_*, BENCH_AUG_*, BENCH_KKT_*,
BENCH_MPC_*, BENCH_TF_B, BENCH_TF_TOL; BENCH_WIDE_* are the port's
own).
Walls are CUDA-event times (``utils/timer.cuda_time``; the host clock
with ``--device cpu``): the median over the runs, with the spread and
every run printed on an earlier line.

``vs_baseline`` is null: bench.py's baselines are rates of another
program measured on another machine's host, and no number of this card.

Every mode of bench.py is ported; ``REFUSED`` names none.
"""

import argparse
import json
import os
import sys
import types

import numpy as np

BATCH = int(os.environ.get("BENCH_BATCH", 10240))
N = int(os.environ.get("BENCH_N", 16))
M_INEQ = int(os.environ.get("BENCH_M", 8))
STEPS = int(os.environ.get("BENCH_STEPS", 10))
# the float32 convergence floor: a full solve at the tightest tolerance
# the working precision supports
TOL = float(os.environ.get("BENCH_TOL", 1e-6))

#: bench.py's tf mode: the first BENCH_TF_B QPs of the batch, solved to
#: the reference-parity tolerance
TF_B = int(os.environ.get("BENCH_TF_B", 2048))
TF_TOL = float(os.environ.get("BENCH_TF_TOL", 1e-8))

#: the wide mode: portfolios of WIDE_ASSETS assets (aug_dim WIDE_ASSETS +
#: 1), WIDE_B of them, float32 at the float32 floor
WIDE_B = int(os.environ.get("BENCH_WIDE_B", 4096))
WIDE_ASSETS = int(os.environ.get("BENCH_WIDE_ASSETS", 128))
WIDE_TOL = 1e-6

MODES = ("fused", "solve", "steps", "kkt", "schur", "arrow", "nd", "normal",
         "aug", "mpc", "tf", "sharded", "wide")
#: modes of bench.py the port does not have yet, with their ROADMAP item
REFUSED = {}


def refuse(mode: str):
    """Raise for a mode of bench.py that the port does not have."""
    raise NotImplementedError(
        f"bench mode {mode!r} is not ported: see {REFUSED[mode]}")


def timed(fn, device, runs, what):
    """Wall of ``fn`` in seconds: median of ``runs`` runs after a
    warm-up, by CUDA events on the card and by the host clock on the
    CPU; prints the median, the spread and every run."""
    from ipmzoo_tpu_torch.utils.timer import cuda_time, host_time
    t = (cuda_time if device.type == "cuda" else host_time)(fn, runs)
    print(f"{what}: wall ms per call ({device.type}, {runs} runs) median "
          f"{t.ms:.3f}, spread {t.spread:.3f}, runs "
          f"{[round(x, 3) for x in t.times]}")
    return t.ms * 1e-3


def backend(device):
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


# -- the dense-QP engines ---------------------------------------------------

def compact_solver(device, dtype=None, **kw):
    """bench.py's ``_solver``: CompiledIPM(Settings(), N, M_INEQ)."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    kw.setdefault("tol", TOL)
    return CompiledIPM(Settings(), n=N, m_ineq=M_INEQ,
                       dtype=dtype or torch.float32, device=device, **kw)


def fused_solver(device, dtype=None, tol=None):
    """bench.py's fused configuration."""
    import torch
    from ipmzoo_tpu_torch import Settings
    from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
    return FusedBatchedIPM(Settings(), n=N, m_ineq=M_INEQ,
                           dtype=dtype or torch.float32,
                           tol=TOL if tol is None else tol, max_iter=30,
                           device=device)


def _gate(share, floor, what):
    if share < floor:
        raise RuntimeError(f"{what} convergence too low: {share}")


def bench_solve(data, device, dtype=None, runs=3):
    """FULL batched solves (compaction-scheduled), convergence-checked:
    useful iterations/s."""
    solver = compact_solver(device, dtype)
    res = solver.solve_batch_compact(data)
    conv = res.converged.float().mean().item()
    _gate(conv, 0.99, "solve")
    iters = float(res.iterations.sum().item())
    t = timed(lambda: solver.solve_batch_compact(data), device, runs, "solve")
    batch = data.Q.shape[0]
    label = (f"IPM iterations/s, {batch} batched QPs FULLY SOLVED to "
             f"tol={TOL:g} ({conv * 100:.2f}% converged, compacted batch, "
             f"n={N}, m={M_INEQ}, {backend(device)})")
    return label, iters / t, "iterations/s", {"converged": conv,
                                              "iterations": iters}


def bench_steps(data, device, dtype=None, runs=3):
    """Raw batched-step throughput, convergence-gated: the same solver
    must first fully solve the batch (>= 99%)."""
    solver = compact_solver(device, dtype)
    res = solver.solve_batch_compact(data)
    conv = res.converged.float().mean().item()
    _gate(conv, 0.99, "step-path")
    checked = solver._check_data(data)
    state = solver.init_state(checked)

    def k_steps():
        s = state
        for _ in range(STEPS):
            s = solver._step_impl(s, checked)
        return s

    t = timed(k_steps, device, runs, f"{STEPS} steps")
    batch = data.Q.shape[0]
    label = (f"IPM iterations/s, {batch} batched QPs, batched step "
             f"(convergence-gated at {conv * 100:.2f}%, n={N}, m={M_INEQ}, "
             f"{backend(device)})")
    return label, batch * STEPS / t, "iterations/s", {
        "converged": conv, "iterations": float(batch * STEPS)}


def tf_solver(device, **kw):
    """bench.py's tf solver: ``_solver(tol=1e-8, two_float=True,
    max_iter=30)``, float32."""
    return compact_solver(device, tol=TF_TOL, two_float=True, max_iter=30,
                          **kw)


def bench_tf(data, device, runs=3):
    """Full batched solves of the first TF_B instances of ``data`` at the
    reference-parity tolerance under two_float (the iteration in
    float64, the data and the result float32), convergence-gated at 99%:
    useful iterations/s."""
    from ipmzoo_tpu_torch.models.state import tree_map
    sub = tree_map(lambda a: a[:TF_B], data)
    solver = tf_solver(device)
    syncs = solver.host_syncs
    res = solver.solve_batch_compact(sub)
    syncs = solver.host_syncs - syncs
    conv = res.converged.float().mean().item()
    _gate(conv, 0.99, "two-float")
    iters = float(res.iterations.sum().item())
    t = timed(lambda: solver.solve_batch_compact(sub), device, runs, "tf")
    batch = sub.Q.shape[0]
    label = (f"IPM iterations/s, {batch} batched QPs FULLY SOLVED to the "
             f"reference-parity tol={TF_TOL:g} from float32 data, two_float "
             f"(float64 iteration; {conv * 100:.2f}% converged, n={N}, "
             f"m={M_INEQ}, {backend(device)})")
    return label, iters / t, "iterations/s", {
        "converged": conv, "iterations": iters, "wall_ms": t * 1e3,
        "host_syncs": syncs, "result": res}


def bench_fused(data, device, dtype=None, runs=7):
    """Full solves: the fused whole-solve kernel K1 under the compaction
    schedule, the float64 escalation and the anti-cycling tail."""
    fused = fused_solver(device, dtype)
    out = fused.solve_fused_compact(data)
    conv = out["converged"].float().mean().item()
    _gate(conv, 0.999, "fused solver")
    iters = float(out["iterations"].sum().item())
    t = timed(lambda: fused.solve_fused_compact(data), device, runs, "fused")
    batch = data.Q.shape[0]
    label = (f"IPM iterations/s, {batch} batched QPs FULLY SOLVED to "
             f"tol={TOL:g} in the compaction-scheduled fused engine + "
             f"anti-cycling tail ({conv * 100:.2f}% converged, n={N}, "
             f"m={M_INEQ}, {backend(device)})")
    return label, iters / t, "iterations/s", {"converged": conv,
                                              "iterations": iters}


def wide_problem(device, batch=None):
    """The wide mode's family and solver: portfolio(n_assets=WIDE_ASSETS,
    batch, seed=0) in float32 and FusedBatchedIPM at tol WIDE_TOL with its
    other settings the defaults."""
    import torch
    from ipmzoo_tpu_torch.models.families import portfolio
    from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
    fam = portfolio(n_assets=WIDE_ASSETS, batch=WIDE_B if batch is None
                    else batch, seed=0, dtype=torch.float32, device=device)
    return fam, FusedBatchedIPM(fam.settings, fam.n, fam.m_ineq, fam.m_eq,
                                dtype=torch.float32, tol=WIDE_TOL,
                                device=device)


def bench_wide(device, batch=None, runs=7):
    """Full solves above augmented order 128: the wide mode's
    portfolios through solve_fused_compact, gated at 99.9%."""
    fam, solver = wide_problem(device, batch)
    out = solver.solve_fused_compact(fam.data)
    conv = out["converged"].float().mean().item()
    _gate(conv, 0.999, "wide fused solver")
    iters = float(out["iterations"].sum().item())
    t = timed(lambda: solver.solve_fused_compact(fam.data), device, runs,
              "wide")
    label = (f"IPM iterations/s, {fam.data.Q.shape[0]} batched portfolio "
             f"QPs FULLY SOLVED to tol={WIDE_TOL:g} in the "
             f"compaction-scheduled fused engine + anti-cycling tail "
             f"({conv * 100:.2f}% converged, n={fam.n}, m_eq={fam.m_eq}, "
             f"aug_dim {solver.aug_dim}, {backend(device)})")
    return label, iters / t, "iterations/s", {"converged": conv,
                                              "iterations": iters,
                                              "result": out}


def flops_model(B, d, k):
    """Dense-LDL^T-equivalent operations of B factorisations of order d
    with k right-hand sides (bench.py's)."""
    return B * 2.0 * (d ** 3 / 3 + 2 * k * d * d)


def kkt_systems(device, dtype=None, batch=None):
    """bench.py's kkt point: BATCH SPD systems of order N + 2 M_INEQ
    with 2 right-hand sides (numpy seed 0)."""
    import torch
    rng = np.random.default_rng(0)
    B, n = BATCH if batch is None else batch, N + 2 * M_INEQ
    M = rng.normal(size=(B, n, n)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n, dtype=np.float32)
    R = rng.normal(size=(B, n, 2)).astype(np.float32)
    dtype = dtype or torch.float32
    return (torch.tensor(A).to(dtype).to(device),
            torch.tensor(R).to(dtype).to(device))


def bench_kkt(device, dtype=None, batch=None, runs=5, calls=20):
    """Batched KKT factor + solve throughput: the fused factor + 2-column
    solve (kernel K5; its plain version on the CPU), flop-graded."""
    import torch
    from ipmzoo_tpu_torch.ops.cuda_ldlt import ldlt_solve_matrix_auto
    from ipmzoo_tpu_torch.utils.timer import cuda_time, host_time

    A, R = kkt_systems(device, dtype, batch)
    B, n = A.shape[0], A.shape[-1]
    _, _, X = ldlt_solve_matrix_auto(A, R)
    resid = ((A @ X - R).abs().max() / R.abs().max()).item()
    if not resid <= 1e-3:
        raise RuntimeError(f"kkt factor+solve residual too large: {resid}")
    timer = cuda_time if device.type == "cuda" else host_time
    t = timer(lambda: ldlt_solve_matrix_auto(A, R), runs, calls=calls)
    print(f"kkt: {B} x dim {n}, fused factor + 2-rhs solve: ms per call "
          f"({device.type}, {runs} runs of {calls}) median {t.ms:.4f}, "
          f"spread {t.spread:.4f}; residual {resid:.3e}")
    gflops = flops_model(B, n, 2) / (t.ms * 1e-3) / 1e9
    label = (f"batched KKT factor+solve, {B} systems of dim {n} through the "
             f"fused factor + 2-rhs solve kernel ({t.ms:.4f} ms per batch, "
             f"{backend(device)})")
    return label, gflops, "GFLOP/s", {"residual": resid,
                                      "flops": flops_model(B, n, 2)}


def kkt_large_systems(device, d, dtype=None):
    """bench.py's large kkt point at order d: max(2, 16384 // d) (or
    BENCH_KKT_B) quasi-definite systems [[H, A^T], [A, -I]], H of order
    d - d // 8 positive definite, A (d // 8, d - d // 8), with two
    right-hand sides; drawn from numpy seed 0 after the small point's
    draws, one order after another as bench.py draws them (BENCH_KKT_DIMS);
    H's product is taken on ``device`` (float32 with TF32 off: 184 GFLOP
    at order 4096, minutes for the host).  Returns the lower blocks
    [[H], [A, -I]] and R (B, d, 2)."""
    import torch
    rng = np.random.default_rng(0)
    n = N + 2 * M_INEQ
    rng.normal(size=(BATCH, n, n))
    rng.normal(size=(BATCH, n, 2))
    dtype = dtype or torch.float32
    for dim in kkt_dims():
        Bm = int(os.environ.get("BENCH_KKT_B", 0)) or max(2, 16384 // dim)
        m = dim // 8
        nq = dim - m
        Mq = rng.normal(size=(Bm, nq, nq)).astype(np.float32)
        A = rng.normal(size=(Bm, m, nq)).astype(np.float32)
        R = rng.normal(size=(Bm, dim, 2)).astype(np.float32)
        if dim == d:
            def t(a):
                return torch.tensor(a).to(device)
            Mt = t(Mq)
            H = torch.matmul(Mt, Mt.transpose(-1, -2)) / nq + \
                torch.eye(nq, device=device)
            S = -torch.eye(m, dtype=dtype, device=device).expand(Bm, m, m)
            return [[H.to(dtype)], [t(A).to(dtype), S]], t(R).to(dtype)
    raise ValueError(f"order {d} is not among BENCH_KKT_DIMS {kkt_dims()}")


def kkt_dims():
    return [int(x) for x in
            os.environ.get("BENCH_KKT_DIMS", "1024,4096").split(",")]


def blockg_two_solves(blocks, R):
    """bench.py's large-point work: the signed block Cholesky of K and
    one solve for each of the two columns of R."""
    import torch
    from ipmzoo_tpu_torch.ops.blockg import blockg_factor, blockg_solve
    fact = blockg_factor(blocks, (1.0, -1.0))
    return torch.stack([blockg_solve(fact, R[:, :, 0]),
                        blockg_solve(fact, R[:, :, 1])], dim=-1)


def bench_kkt_large(device, dtype=None, runs=5, calls=5):
    """The large kkt point: at each order of BENCH_KKT_DIMS, the signed
    block Cholesky factor and two solves, residual-checked and graded by
    the dense-LDL^T flop model; returns {order: (B, GFLOP/s, ms)}."""
    import torch
    from ipmzoo_tpu_torch.utils.timer import cuda_time, host_time
    timer = cuda_time if device.type == "cuda" else host_time
    out = {}
    for d in kkt_dims():
        blocks, R = kkt_large_systems(device, d, dtype)
        B = R.shape[0]
        X = blockg_two_solves(blocks, R)
        H, A = blocks[0][0], blocks[1][0]
        m = A.shape[-2]
        top = torch.matmul(H, X[:, :-m]) + torch.matmul(A.transpose(-1, -2),
                                                        X[:, -m:])
        bot = torch.matmul(A, X[:, :-m]) - X[:, -m:]
        resid = ((torch.cat([top, bot], dim=1) - R).abs().max() /
                 R.abs().max()).item()
        if not resid <= 1e-3:
            raise RuntimeError(f"kkt order {d}: blockg residual {resid}")
        t = timer(lambda: blockg_two_solves(blocks, R), runs, calls=calls)
        gflops = flops_model(B, d, 2) / (t.ms * 1e-3) / 1e9
        print(f"kkt large point: {B} x dim {d} (blockg, n={d - m}+m={m}): "
              f"{gflops:.1f} GFLOP/s ({t.ms:.3f} ms per batch, "
              f"{device.type}, {runs} runs of {calls}, spread "
              f"{t.spread:.3f}); residual {resid:.3e}")
        out[d] = (B, gflops, t.ms)
    return out


# -- the structured engines -------------------------------------------------

def schur_sizes():
    """(instances, blocks, block size, coupling rows, tol) of the Schur
    mode, from the BENCH_SCHUR_* variables."""
    return (int(os.environ.get("BENCH_SCHUR_I", 8)),
            int(os.environ.get("BENCH_SCHUR_BLOCKS", 64)),
            int(os.environ.get("BENCH_SCHUR_N", 64)),
            int(os.environ.get("BENCH_SCHUR_MC", 16)),
            float(os.environ.get("BENCH_SCHUR_TOL", 1e-8)))


def schur_data(device, inst=None, blocks=None, n=None, m_c=None):
    """bench.py's bench_schur instances: numpy seeds 0..inst-1, each
    ``blocks`` blocks of order ``n`` with ``m_c`` coupling rows, cast to
    float32, stacked on a leading instance axis."""
    import torch
    from ipmzoo_tpu_torch.models.convert import block_qp_from_numpy
    d_inst, d_blocks, d_n, d_mc, _ = schur_sizes()
    inst = d_inst if inst is None else inst
    blocks = d_blocks if blocks is None else blocks
    n = d_n if n is None else n
    m_c = d_mc if m_c is None else m_c

    def make(seed):
        r = np.random.default_rng(seed)
        M = r.normal(size=(blocks, n, n))
        return dict(Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
                    c=r.normal(size=(blocks, n)),
                    F=r.normal(size=(blocks, m_c, n)) / blocks,
                    l_x=np.full((blocks, n), -3.0),
                    u_x=np.full((blocks, n), 3.0),
                    g=r.normal(size=(m_c,)) * 0.1)

    insts = [make(s) for s in range(inst)]
    raw = types.SimpleNamespace(**{
        k: np.stack([d[k] for d in insts]).astype(np.float32)
        for k in insts[0]})
    return block_qp_from_numpy(raw, dtype=torch.float32, device=device)


def bench_schur(device, runs=5):
    """Block-separable coupled QPs through the Schur-complement IPM at
    tol 1e-8 (the float32 data solved in float64)."""
    import torch
    from ipmzoo_tpu_torch.parallel import SchurIPM

    inst, blocks, n, m_c, tol = schur_sizes()
    datas = schur_data(device)
    s = SchurIPM(n=n, m_c=m_c, dtype=torch.float32, tol=tol,
                 two_float=(tol < 1e-6), refine=2, max_iter=60,
                 device=device)
    res = s.solve_batch(datas)
    conv = res.converged.float().mean().item()
    _gate(conv, 0.99, "schur")
    iters = float(res.iterations.sum().item())
    steps = float(res.iterations.max().item())
    t = timed(lambda: s.solve_batch(datas), device, runs, "schur")
    print(f"schur: {inst} instances x {blocks} blocks x n={n}, m_c={m_c}, "
          f"tol={tol:g}: {t * 1e3:.2f} ms/solve-batch, "
          f"{t / steps * 1e3:.3f} ms/iteration, {iters / t:.0f} useful it/s, "
          f"{conv * 100:.0f}% converged")
    label = (f"IPM iterations/s, {inst} block-separable coupled QPs "
             f"({blocks} blocks x n={n}, m_c={m_c}) FULLY SOLVED to "
             f"tol={tol:g} (float32 data, solved in "
             f"{str(s.compute_dtype).replace('torch.', '')}) via the "
             f"Schur-complement IPM ({conv * 100:.0f}% converged, "
             f"{t / steps * 1e3:.2f} ms/iteration, {backend(device)})")
    return label, iters / t, "iterations/s", {
        "converged": conv, "iterations": iters,
        "per_instance": res.iterations.tolist()}


def arrow_sizes():
    """(variables, half-bandwidth, tip) of the arrow mode."""
    return (int(os.environ.get("BENCH_ARROW_N", 4096)),
            int(os.environ.get("BENCH_ARROW_B", 16)),
            int(os.environ.get("BENCH_ARROW_T", 8)))


def arrow_problem(n=None, b=None, t=None):
    """bench.py's bench_arrow QP (numpy seed 0): banded Hessian of
    half-bandwidth b with a dense tip of t coupling variables, float32,
    bounds +-1.  Returns dense (Q, c, l, u)."""
    d_n, d_b, d_t = arrow_sizes()
    n = d_n if n is None else n
    b = d_b if b is None else b
    t = d_t if t is None else t
    rng = np.random.default_rng(0)
    nb = n - t
    Q = np.zeros((n, n), np.float32)
    for i in range(nb):
        lo, hi = max(0, i - b), min(nb, i + b + 1)
        Q[i, lo:hi] = rng.normal(size=hi - lo) * 0.1
    Q = (Q + Q.T) / 2
    strip = rng.normal(size=(t, n)).astype(np.float32) * 0.1
    Q[nb:, :] = strip
    Q[:, nb:] = strip.T
    Q[nb:, nb:] = (strip[:, nb:] + strip[:, nb:].T) / 2
    Q += np.eye(n, dtype=np.float32) * (2 * b + t)
    c = rng.normal(size=n).astype(np.float32)
    l = np.full(n, -1.0, np.float32)
    u = np.full(n, 1.0, np.float32)
    return Q, c, l, u


def step_walls(solver, data, device):
    """k -> the wall in ms of k IPM steps of ``solver`` from its initial
    state on one instance ``data`` (fields without a batch axis); the nd
    path's loop-invariant prework runs inside, as in bench.py's loop."""
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.utils.timer import cuda_time, host_time
    one = solver._check_data(tree_map(lambda a: a.unsqueeze(0), data))
    state = solver.init_state(one)
    nd = getattr(solver, "_mode", None) == "nd"
    timer = cuda_time if device.type == "cuda" else host_time

    def run(k):
        def steps():
            kw = dict(nd_pre=solver._nd_prework(one)) if nd else {}
            s = state
            for _ in range(k):
                s = solver._step_impl(s, one, **kw)
            return s
        return timer(steps, runs=1, warmup=0).ms
    return run


def dense_speedup(what, solver, data, dense, ddata, device, ks, dks):
    """bench.py's dense half: ms per step of the structured ``solver``
    and of the ``dense`` CompiledIPM on the same QP, each the slope of the
    walls of two step counts (``ks``, ``dks``) after a warm-up of both,
    in three interleaved rounds; the dense solver must converge.
    Returns (structured ms, dense ms)."""
    res = dense.solve(ddata)
    if not bool(res.converged):
        raise RuntimeError(f"{what}: the dense path did not converge")
    runs = [(step_walls(solver, data, device), ks),
            (step_walls(dense, ddata, device), dks)]
    for run, (k1, k2) in runs:
        run(k1)
        run(k2)
    rounds = [[(run(k2) - run(k1)) / (k2 - k1) for run, (k1, k2) in runs]
              for _ in range(3)]
    t_s, t_d = (float(np.median([r[i] for r in rounds])) for i in (0, 1))
    print(f"{what} rounds (ms/step): structured "
          f"{[round(r[0], 4) for r in rounds]}, dense "
          f"{[round(r[1], 4) for r in rounds]} (kernel "
          f"{dense._mode!r}, {res.iterations.item()} iterations)")
    print(f"{what}: {t_s:.3f} ms/step structured vs {t_d:.3f} ms/step "
          f"dense = {t_d / t_s:.1f}x")
    return t_s, t_d


def bench_arrow(device, dtype=None, runs=5, dense=False):
    """The structured banded+arrow IPM on bench.py's QP: full solves,
    convergence-gated; with ``dense`` the step's speed-up over the dense
    CompiledIPM step on the same QP, as bench.py reports it."""
    import torch
    from ipmzoo_tpu_torch import (ArrowIPM, ArrowQPData, CompiledIPM,
                                  QPData)
    from ipmzoo_tpu_torch.formulations import (Bounds, InequalityHandling,
                                               Settings)

    n, b, t = arrow_sizes()
    dtype = dtype or torch.float32
    Q, c, l, u = arrow_problem()
    blk_env = int(os.environ.get("BENCH_ARROW_BLOCK", 0))
    data, st, blk = ArrowQPData.from_dense(Q, c, l, u, dtype=dtype,
                                           block=blk_env or None,
                                           device=device)
    method = os.environ.get("BENCH_ARROW_METHOD", "auto")
    solver = ArrowIPM.for_data(data, structure=st, dtype=dtype, tol=1e-5,
                               method=method)
    print(f"arrow: block={blk}, N={data.D.shape[0]}, method={method}")
    res = solver.solve(data)
    if not bool(res.converged):
        raise RuntimeError("arrow solver did not converge")
    iters = float(res.iterations)
    if dense:
        dsolver = CompiledIPM(
            Settings(inequalities=Bounds.NONE,
                     inequality_handling=InequalityHandling.SLACKS),
            n=n, dtype=dtype, tol=1e-5, device=device)
        ddata = QPData.make(Q=Q, c=c, l_x=l, u_x=u, dtype=dtype,
                            device=device)
        t_s, t_d = dense_speedup("arrow", solver, data, dsolver, ddata,
                                 device, (4, 16), (2, 6))
        label = (f"structured banded+arrow IPM step speedup vs dense path "
                 f"(n={n}, bandwidth={b}, tip={t}, {backend(device)}; "
                 f"{t_s:.3f} ms vs {t_d:.3f} ms per iteration, dense "
                 f"kernel '{dsolver._mode}')")
        return label, t_d / t_s, "x speedup", {
            "converged": 1.0, "iterations": iters, "ms_structured": t_s,
            "ms_dense": t_d}
    wall = timed(lambda: solver.solve(data), device, runs, "arrow")
    label = (f"IPM iterations/s, structured banded+arrow IPM FULLY SOLVED "
             f"(n={n}, bandwidth={b}, tip={t}, {int(iters)} iterations, "
             f"{wall / iters * 1e3:.3f} ms per iteration, "
             f"{backend(device)})")
    return label, iters / wall, "iterations/s", {
        "converged": 1.0, "iterations": iters}


def nd_problem(device, dtype=None, tol=1e-5):
    """bench.py's bench_nd solver and QP: ``grid_qp`` of side BENCH_ND_G
    (numpy seed 0) under ``CompiledIPM(kernel="nd")`` with the
    auto-fallback off, so the nd path itself is measured."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.models.families import grid_qp
    g = int(os.environ.get("BENCH_ND_G", 64))
    leaf = int(os.environ.get("BENCH_ND_LEAF", 64))
    dtype = dtype or torch.float32
    fam = grid_qp(side=g, seed=0, dtype=dtype, device=device)
    solver = CompiledIPM(fam.settings, n=g * g, dtype=dtype, tol=tol,
                         kernel="nd", nd_leaf=leaf, nd_fallback=False,
                         device=device)
    return solver, fam.data


def bench_nd(device, dtype=None, runs=5, dense=False):
    """The nested-dissection IPM on a 2D-grid QP: full solves,
    convergence-gated; with ``dense`` the step's speed-up over the dense
    CompiledIPM ('auto') step on the same QP, as bench.py reports it."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM
    solver, data = nd_problem(device, dtype)
    res = solver.solve(data)
    if not bool(res.converged):
        raise RuntimeError("nd solver did not converge")
    plan = solver._nd_plan
    print(f"nd: {len(plan.levels)} levels, flop ratio dense/nd = "
          f"{plan.flops_dense / max(plan.flops_nd, 1):.1f}x")
    iters = float(res.iterations)
    if dense:
        dsolver = CompiledIPM(solver.settings, n=solver.n,
                              dtype=dtype or torch.float32, tol=1e-5,
                              device=device)
        t_s, t_d = dense_speedup("nd", solver, data, dsolver, data, device,
                                 (2, 8), (2, 8))
        label = (f"nested-dissection IPM step speedup vs dense path "
                 f"(2D-grid QP, n={solver.n}, leaf={solver._nd_leaf}, "
                 f"{backend(device)}; {t_s:.3f} ms vs {t_d:.3f} ms per "
                 f"iteration, dense kernel '{dsolver._mode}')")
        return label, t_d / t_s, "x speedup", {
            "converged": 1.0, "iterations": iters, "ms_structured": t_s,
            "ms_dense": t_d}
    wall = timed(lambda: solver.solve(data), device, runs, "nd")
    label = (f"IPM iterations/s, nested-dissection IPM FULLY SOLVED "
             f"(2D-grid QP, n={solver.n}, leaf={solver._nd_leaf}, "
             f"{int(iters)} iterations, {wall / iters * 1e3:.3f} ms per "
             f"iteration, {backend(device)})")
    return label, iters / wall, "iterations/s", {
        "converged": 1.0, "iterations": iters}


# -- the dense reductions ---------------------------------------------------

def race(what, kernels, make, data, device, runs):
    """Solve ``data`` with each kernel mode's solver (``make(kernel)``),
    gate at >= 99% converged, and time each that passes; returns
    {kernel: (share converged, iterations summed, wall s, result)} and
    the winner (most useful iterations/s).  A mode that raises fails the
    run."""
    results = {}
    for kernel in kernels:
        s = make(kernel)
        res = s.solve_batch(data)
        conv = res.converged.float().mean().item()
        iters = float(res.iterations.sum().item())
        t = timed(lambda: s.solve_batch(data), device, runs,
                  f"{what} kernel={kernel}") if conv >= 0.99 else None
        results[kernel] = (conv, iters, t, res)
    ok = {k: v for k, v in results.items() if v[2] is not None}
    print(f"{what} stagings: " + ", ".join(
        f"{k}: {i / t:.1f} it/s ({c * 100:.1f}% conv)" if t else
        f"{k}: {c * 100:.1f}% conv" for k, (c, i, t, _) in results.items()))
    if not ok:
        raise RuntimeError(f"{what}: convergence too low: "
                           f"{ {k: v[0] for k, v in results.items()} }")
    return results, max(ok, key=lambda k: ok[k][1] / ok[k][2])


def normal_sizes():
    """(n, m, batch, tol) of the normal mode."""
    return (int(os.environ.get("BENCH_NORMAL_N", 1024)),
            int(os.environ.get("BENCH_NORMAL_M", 128)),
            int(os.environ.get("BENCH_NORMAL_B", 16)),
            float(os.environ.get("BENCH_NORMAL_TOL", 1e-5)))


def normal_solver(kernel, device, dtype=None):
    """bench.py's bench_normal solver: Settings(), scale_tol, gondzio=2."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    n, m, _, tol = normal_sizes()
    return CompiledIPM(Settings(), n=n, m_ineq=m,
                       dtype=dtype or torch.float32, tol=tol, kernel=kernel,
                       scale_tol=True, gondzio=2, device=device)


def bench_normal(device, dtype=None, runs=3):
    """Dense QPs through the normal-equations reduction: the stagings
    'blockg', 'block' and 'normal' race on the same batch and the winner
    is the value, with bench.py's flop model for its GFLOP/s."""
    import torch
    from ipmzoo_tpu_torch.models.convert import make_batch
    n, m, B, tol = normal_sizes()
    data = make_batch(B, n, m, dtype or torch.float32, device=device)
    it_flops = {
        "normal": 2 * (n ** 3 / 3 + n ** 3 + n * n * m + m * m * n
                       + m ** 3 / 3),
        "block": 2 * (n ** 3 / 3 + n * n * m + m * m * n + m ** 3 / 3
                      + 2 * (n * n + n * m + m * m)),
    }
    it_flops["blockg"] = it_flops["block"]
    results, kernel = race("normal", ("blockg", "block", "normal"),
                           lambda k: normal_solver(k, device, dtype), data,
                           device, runs)
    conv, iters, t, _ = results[kernel]
    gflops = iters * it_flops[kernel] / t / 1e9
    label = (f"IPM iterations/s, {B} dense QPs (n={n}, m={m}) FULLY "
             f"SOLVED to rel tol={tol:g} via the normal-equations "
             f"reduction, kernel='{kernel}' ({conv * 100:.1f}% "
             f"converged, ~{gflops:.0f} GFLOP/s, {backend(device)})")
    return label, iters / t, "iterations/s", {
        k: {"converged": c, "iterations": i,
            "its_per_s": (i / w if w else None), "result": r}
        for k, (c, i, w, r) in results.items()}


def aug_sizes():
    """(n, m_ineq, m_eq, batch, tol) of the aug mode."""
    return (int(os.environ.get("BENCH_AUG_N", 256)),
            int(os.environ.get("BENCH_AUG_M", 64)),
            int(os.environ.get("BENCH_AUG_ME", 32)),
            int(os.environ.get("BENCH_AUG_B", 64)),
            float(os.environ.get("BENCH_AUG_TOL", 1e-5)))


def aug_data(device, dtype=None):
    """bench.py's bench_aug QPs (numpy seed 0, float32 values):
    consistent equalities b = A_eq x0, two-sided inequalities, box +-5."""
    import torch
    from ipmzoo_tpu_torch import QPData
    n, m, me, B, _ = aug_sizes()
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, n, n)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / n + np.eye(n, dtype=np.float32)
    x0 = rng.normal(size=(B, n)).astype(np.float32)
    A_eq = rng.normal(size=(B, me, n)).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    data = QPData.make(
        Q=Q, c=rng.normal(size=(B, n)),
        A_ineq=rng.normal(size=(B, m, n)),
        l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
        A_eq=A_eq, b_eq=np.einsum("bmn,bn->bm", A_eq, x0),
        l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0), **f32)
    return data.to(dtype=dtype or torch.float32)


def aug_solver(kernel, device, dtype=None):
    """bench.py's bench_aug solver: REGULARIZATION equality handling,
    scale_tol, refine=2, gondzio=2."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.formulations import EqualityHandling, Settings
    n, m, me, _, tol = aug_sizes()
    return CompiledIPM(
        Settings(equalities=True,
                 equality_handling=EqualityHandling.REGULARIZATION),
        n=n, m_ineq=m, m_eq=me, dtype=dtype or torch.float32, tol=tol,
        scale_tol=True, refine=2, gondzio=2, kernel=kernel, device=device)


def bench_aug(device, dtype=None, runs=3):
    """Equality + inequality QPs through the augmented system with
    iterative refinement: 'blockg' races 'auto' (the dense LDL^T) on the
    same batch, and the winner is the value."""
    n, m, me, B, tol = aug_sizes()
    data = aug_data(device, dtype)
    results, kernel = race("aug", ("blockg", "auto"),
                           lambda k: aug_solver(k, device, dtype), data,
                           device, runs)
    conv, iters, t, _ = results[kernel]
    label = (f"IPM iterations/s, {B} equality+inequality QPs (n={n}, "
             f"m_ineq={m}, m_eq={me}, aug_dim={n + m + me}) FULLY SOLVED to "
             f"rel tol={tol:g} via the augmented system + iterative "
             f"refinement (refine=2, kernel='{kernel}', {conv * 100:.1f}% "
             f"converged, {backend(device)})")
    return label, iters / t, "iterations/s", {
        k: {"converged": c, "iterations": i,
            "its_per_s": (i / w if w else None), "result": r}
        for k, (c, i, w, r) in results.items()}


def mpc_sizes():
    """(horizon, states, controls, instances) of the mpc mode, from the
    BENCH_MPC_* variables."""
    return (int(os.environ.get("BENCH_MPC_T", 32)),
            int(os.environ.get("BENCH_MPC_NS", 8)),
            int(os.environ.get("BENCH_MPC_NU", 4)),
            int(os.environ.get("BENCH_MPC_BATCH", 256)))


def mpc_problem(device, dtype=None):
    """bench.py's bench_mpc batch and solver: ``random_mpc`` seed 0 and
    ``RiccatiIPM(tol=1e-5, max_iter=40)``, float32 unless ``dtype``."""
    import torch
    from ipmzoo_tpu_torch.models.mpc import RiccatiIPM, random_mpc
    T, ns, nu, batch = mpc_sizes()
    dtype = dtype or torch.float32
    data = random_mpc(horizon=T, n_states=ns, n_controls=nu, batch=batch,
                      seed=0, dtype=dtype, device=device)
    solver = RiccatiIPM(T, ns, nu, dtype=dtype, tol=1e-5, max_iter=40,
                        device=device)
    return data, solver


def bench_mpc(device, dtype=None, runs=5):
    """Structured MPC: batched Riccati IPM solves (block-tridiagonal KKT,
    O(T) per iteration), convergence-gated at 95%."""
    T, ns, nu, batch = mpc_sizes()
    data, solver = mpc_problem(device, dtype)
    res = solver.solve_batch(data)
    conv = res.converged.float().mean().item()
    _gate(conv, 0.95, "mpc")
    iters = float(res.iterations.sum().item())
    t = timed(lambda: solver.solve_batch(data), device, runs, "mpc")
    steps = int(res.iterations.max().item())
    label = (f"IPM iterations/s, {batch} structured MPC QPs fully solved "
             f"(Riccati, T={T}, ns={ns}, nu={nu}, "
             f"{str(solver.dtype).replace('torch.', '')}, tol=1e-05, "
             f"{conv * 100:.1f}% converged, {t / steps * 1e3:.3f} "
             f"ms/iteration, {backend(device)})")
    return label, iters / t, "iterations/s", {
        "converged": conv, "iterations": iters, "wall_ms": t * 1e3,
        "result": res}


def bench_sharded(device, batch=None):
    """dp-sharded batched stepping over the ranks of the process group,
    with its strong-scaling efficiency against rank 0 alone (bench.py's
    bench_sharded); joins the group first where ``WORLD_SIZE`` > 1."""
    import torch
    import torch.distributed as dist
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.parallel.distributed import initialize
    from ipmzoo_tpu_torch.parallel.mesh import make_mesh
    from ipmzoo_tpu_torch.parallel.scaling import dp_scaling_report
    if not dist.is_initialized():
        initialize()
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = None if device.type == "cuda" else [device] * world
    dev = make_mesh(devices=devices).device
    data = make_batch(BATCH if batch is None else batch, N, M_INEQ,
                      torch.float32, device=dev)
    report = dp_scaling_report(compact_solver(dev), data, steps=10,
                               devices=devices)
    print(report.summary())
    label = (f"IPM iterations/s, {report.batch} batched QPs, dp-sharded over "
             f"{report.n_devices} device(s), strong-scaling efficiency "
             f"{100 * report.efficiency:.1f}% vs 1 device "
             f"(n={N}, m={M_INEQ}, {backend(dev)})")
    return label, report.iters_per_s_ndev, "iterations/s", {
        "report": report}


def run_mode(mode, device, batch=None, dense=False, large=False):
    """Run one mode; returns (label, value, unit, counts)."""
    import torch
    from ipmzoo_tpu_torch.models.convert import make_batch
    if mode in REFUSED:
        refuse(mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{MODES + tuple(REFUSED)}")
    if dense and mode not in ("arrow", "nd"):
        raise ValueError("--dense belongs to the modes arrow and nd")
    if large and mode != "kkt":
        raise ValueError("--large belongs to the mode kkt")
    if mode == "wide":
        return bench_wide(device, batch)
    batch = BATCH if batch is None else batch
    if mode in ("fused", "solve", "steps", "tf"):
        data = make_batch(batch, N, M_INEQ, torch.float32, device=device)
        fn = {"fused": bench_fused, "solve": bench_solve,
              "steps": bench_steps, "tf": bench_tf}[mode]
        return fn(data, device)
    if mode == "kkt":
        label, value, unit, counts = bench_kkt(device, batch=batch)
        if not large:
            return label, value, unit, counts
        pts = bench_kkt_large(device)
        d = max(pts, key=lambda k: pts[k][1])
        others = "; ".join(f"dim {k} x{b}: {g:.0f} GFLOP/s"
                           for k, (b, g, _) in sorted(pts.items()) if k != d)
        label = (f"batched KKT factor+solve, {pts[d][0]} quasi-definite "
                 f"systems of dim {d} via signed block-Cholesky "
                 f"({backend(device)}; {others}; small point: {batch} x dim "
                 f"{N + 2 * M_INEQ} fused factor + 2-rhs solve at "
                 f"{value:.0f} GFLOP/s)")
        return label, pts[d][1], "GFLOP/s", {"points": pts, **counts}
    if mode in ("arrow", "nd"):
        return {"arrow": bench_arrow, "nd": bench_nd}[mode](device,
                                                            dense=dense)
    if mode == "sharded":
        return bench_sharded(device, batch)
    return {"schur": bench_schur, "normal": bench_normal,
            "aug": bench_aug, "mpc": bench_mpc}[mode](device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default=os.environ.get("BENCH_MODE", "fused"),
                    choices=MODES + tuple(REFUSED))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default: the CUDA card")
    ap.add_argument("--batch", type=int, default=None,
                    help="instances of the dense-QP modes (BENCH_BATCH) "
                    "and of the wide mode (BENCH_WIDE_B)")
    ap.add_argument("--dense", action="store_true",
                    help="arrow / nd: the step's speed-up over the dense "
                    "path")
    ap.add_argument("--large", action="store_true",
                    help="kkt: also the large-matrix point")
    args = ap.parse_args(argv)

    import torch
    from ipmzoo_tpu_torch.parallel.distributed import shutdown
    from ipmzoo_tpu_torch.utils.device import nvidia_smi, resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(nvidia_smi())
    print(f"torch {torch.__version__}; device {backend(device)}")
    try:
        label, value, unit, _ = run_mode(args.mode, device, args.batch,
                                         args.dense, args.large)
    finally:
        shutdown()
    print(json.dumps({"metric": label, "value": round(value, 1),
                      "unit": unit, "vs_baseline": None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
