"""bench_torch.py, the port's benchmark program, against bench.py's
function of the same mode, both on the CPU at a small size.

Both programs are sized by the same module constants and BENCH_*
variables and both timers are replaced by a constant second, so a
mode's ``value`` is the count it divides by the wall: the same converged
share and the same counts must come out.  float32 iteration totals may
part by rounding (2%); in float64 the port's function is held to the
reference's solver iteration for iteration.  The sharded mode runs at
one rank in this process and at two in gloo processes.
"""

import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

import bench
import bench_torch
import ipmzoo_tpu.utils.timing as ref_timing
from ipmzoo_tpu.formulations import Settings
from ipmzoo_tpu.models import ArrowIPM as RefArrowIPM
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.models import families as ref_families
from ipmzoo_tpu.models.fused import FusedBatchedIPM as RefFused
from ipmzoo_tpu.models.mpc import RiccatiIPM as RefRiccatiIPM
from ipmzoo_tpu.models.mpc import random_mpc as ref_random_mpc
from ipmzoo_tpu.parallel.schur import SchurIPM as RefSchurIPM
from ipmzoo_tpu_torch.models.convert import make_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BATCH, N, M, TOL = 48, 8, 4, 1e-5


@pytest.fixture
def small(monkeypatch):
    """The same small workload on both sides and both timers at one
    second, so that a value is the count it is computed from."""
    for mod in (bench, bench_torch):
        monkeypatch.setattr(mod, "BATCH", BATCH)
        monkeypatch.setattr(mod, "N", N)
        monkeypatch.setattr(mod, "M_INEQ", M)
        monkeypatch.setattr(mod, "TOL", TOL)
    ticks = itertools.count(1)
    # bench.py divides two differences of times in its arrow and nd modes:
    # distinct values keep those finite
    monkeypatch.setattr(ref_timing, "measure_call",
                        lambda fn, *a, **k: 1.0)
    monkeypatch.setattr(ref_timing, "measure_chain",
                        lambda fn, init, **k: 1.0)
    monkeypatch.setattr(bench_torch, "timed",
                        lambda fn, device, runs, what: 1.0)
    return ticks


@pytest.fixture
def spy(monkeypatch):
    """Record what a reference solver's method returns inside bench.py."""
    def install(cls, method):
        seen = []
        orig = getattr(cls, method)

        @functools.wraps(orig)
        def wrapped(self, *a, **k):
            out = orig(self, *a, **k)
            seen.append(out)
            return out
        monkeypatch.setattr(cls, method, wrapped)
        return seen
    return install


def test_solve_mode(small, spy):
    seen = spy(RefIPM, "solve_batch_compact")
    ref_label, ref_value, ref_unit, _ = bench.bench_solve(
        bench.make_batch(BATCH, N, M, jnp.float32), "cpu")
    label, value, unit, counts = bench_torch.bench_solve(
        make_batch(BATCH, N, M, torch.float32, device="cpu"), CPU)
    assert unit == ref_unit == "iterations/s"
    assert counts["converged"] == 1.0 and "100.00% converged" in ref_label
    assert "100.00% converged" in label and f"{BATCH} batched QPs" in label
    assert value == counts["iterations"]
    assert abs(value - ref_value) <= 0.02 * ref_value
    assert float(np.asarray(seen[0].iterations).sum()) == ref_value


def test_solve_mode_float64_iterations_equal(small):
    ref = RefIPM(Settings(), n=N, m_ineq=M, dtype=jnp.float64, tol=TOL)
    want = ref.solve_batch_compact(bench.make_batch(BATCH, N, M,
                                                    jnp.float64))
    _, value, _, counts = bench_torch.bench_solve(
        make_batch(BATCH, N, M, torch.float64, device="cpu"), CPU,
        dtype=torch.float64)
    assert counts["converged"] == float(np.asarray(want.converged).mean())
    assert value == float(np.asarray(want.iterations).sum())


def test_steps_mode(small, monkeypatch):
    monkeypatch.setattr(bench_torch, "STEPS", 10)
    ref_label, ref_value, ref_unit, _ = bench.bench_steps(
        bench.make_batch(BATCH, N, M, jnp.float32), "cpu")
    label, value, unit, counts = bench_torch.bench_steps(
        make_batch(BATCH, N, M, torch.float32, device="cpu"), CPU)
    # bench.py counts BATCH * 10 steps over their wall
    assert value == ref_value == BATCH * 10
    assert unit == ref_unit
    assert "convergence-gated at 100.00%" in label
    assert "convergence-gated at 100.00%" in ref_label


def test_steps_mode_steps_from_the_initial_state(monkeypatch, small):
    """What is timed is STEPS batched steps from the initial state."""
    taken = []
    monkeypatch.setattr(bench_torch, "STEPS", 3)
    monkeypatch.setattr(bench_torch, "timed",
                        lambda fn, device, runs, what: taken.append(fn())
                        or 1.0)
    data = make_batch(8, N, M, torch.float64, device="cpu")
    _, value, _, _ = bench_torch.bench_steps(data, CPU, dtype=torch.float64)
    assert value == 8 * 3
    assert taken[0].iteration.tolist() == [3] * 8
    ref = RefIPM(Settings(), n=N, m_ineq=M, dtype=jnp.float64, tol=TOL)
    rdata = bench.make_batch(8, N, M, jnp.float64)
    state = jax.vmap(ref.init_state)(rdata)
    for _ in range(3):
        state = jax.vmap(ref._step_impl)(state, rdata)
    for a, b in zip(taken[0].vars, state.vars):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)


def test_fused_mode(small, monkeypatch, spy):
    # the reference's tile is cut to the batch, and its escalation stage
    # is left out: traced into the program it compiles its double-single
    # pipeline for minutes on the CPU, and with every instance converged
    # before it (asserted below) it changes nothing
    init, solve = RefFused.__init__, RefFused.solve_fused_compact
    monkeypatch.setattr(
        RefFused, "__init__",
        lambda self, *a, **k: init(self, *a, **{**k, "bt": BATCH}))
    monkeypatch.setattr(
        RefFused, "solve_fused_compact",
        lambda self, data, **k: solve(self, data, **{**k, "esc_cap": 0}))
    seen = spy(RefFused, "solve_fused_compact")
    ref_label, ref_value, ref_unit, _ = bench.bench_fused(
        bench.make_batch(BATCH, N, M, jnp.float32), "cpu")
    label, value, unit, counts = bench_torch.bench_fused(
        make_batch(BATCH, N, M, torch.float32, device="cpu"), CPU)
    assert unit == ref_unit == "iterations/s"
    assert counts["converged"] == 1.0 and "100.00% converged" in ref_label
    assert value == counts["iterations"]
    assert abs(value - ref_value) <= 0.02 * ref_value
    assert float(np.asarray(seen[0]["iterations"]).sum()) == ref_value


def test_fused_gate_refuses_a_batch_that_does_not_converge(small,
                                                           monkeypatch):
    monkeypatch.setattr(bench_torch, "TOL", 1e-30)
    with pytest.raises(RuntimeError, match="convergence too low"):
        bench_torch.bench_fused(
            make_batch(8, N, M, torch.float32, device="cpu"), CPU)


def test_kkt_mode(small, monkeypatch):
    monkeypatch.setenv("BENCH_KKT_DIMS", "32")
    monkeypatch.setenv("BENCH_KKT_B", "2")
    _, ref_value, ref_unit, _ = bench.bench_kkt(
        bench.make_batch(BATCH, N, M, jnp.float32), "cpu")
    label, value, unit, counts = bench_torch.bench_kkt(CPU, runs=1, calls=1)
    d = N + 2 * M
    assert unit == ref_unit == "GFLOP/s" and value > 0
    assert counts["flops"] == BATCH * 2.0 * (d ** 3 / 3 + 2 * 2 * d * d)
    assert bench_torch.flops_model(3, 5, 2) == 3 * 2.0 * (125 / 3 + 100)
    assert f"{BATCH} systems of dim {d}" in label
    # the systems are bench.py's: same generator, same call order
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(BATCH, d, d)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", Mx, Mx) / d + np.eye(d, dtype=np.float32)
    R = rng.normal(size=(BATCH, d, 2)).astype(np.float32)
    ours_A, ours_R = bench_torch.kkt_systems(CPU)
    assert ours_A.numpy().tobytes() == A.tobytes()
    assert ours_R.numpy().tobytes() == R.tobytes()
    # and what is timed solves them
    from ipmzoo_tpu_torch.ops.cuda_ldlt import ldlt_solve_matrix_auto
    X = ldlt_solve_matrix_auto(ours_A, ours_R)[2].numpy()
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", A, X), R,
                               atol=1e-4)
    assert counts["residual"] <= 1e-5


def test_schur_mode(small, monkeypatch, spy):
    for k, v in (("I", 2), ("BLOCKS", 4), ("N", 8), ("MC", 2)):
        monkeypatch.setenv(f"BENCH_SCHUR_{k}", str(v))
    seen = spy(RefSchurIPM, "solve_batch")
    ref_label, ref_value, ref_unit, _ = bench.bench_schur("cpu")
    label, value, unit, counts = bench_torch.bench_schur(CPU)
    assert unit == ref_unit == "iterations/s"
    assert counts["converged"] == 1.0 and "100% converged" in ref_label
    assert "2 block-separable coupled QPs (4 blocks x n=8, m_c=2)" in label
    assert value == counts["iterations"] == sum(counts["per_instance"])
    # the reference iterates in double-single pairs, the port in float64
    ref_its = np.asarray(seen[0].iterations)
    assert float(ref_its.sum()) == ref_value
    assert np.abs(np.asarray(counts["per_instance"]) - ref_its).max() <= 2


def test_arrow_mode(small, monkeypatch, spy):
    for k, v in (("N", 136), ("B", 4), ("T", 8)):
        monkeypatch.setenv(f"BENCH_ARROW_{k}", str(v))
    monkeypatch.setattr(ref_timing, "measure_call",
                        lambda fn, *a, **k: float(next(small)))
    seen = spy(RefArrowIPM, "solve")
    _, _, ref_unit, _ = bench.bench_arrow("cpu")
    label, value, unit, counts = bench_torch.bench_arrow(CPU)
    assert ref_unit == "x speedup" and unit == "iterations/s"
    assert bool(seen[0].converged) and counts["converged"] == 1.0
    assert abs(value - int(seen[0].iterations)) <= 1
    assert "n=136, bandwidth=4, tip=8" in label
    assert "speedup" not in label and counts["iterations"] == value
    # the QP is bench.py's
    Q, c, l, u = bench_torch.arrow_problem()
    assert Q.shape == (136, 136) and Q.dtype == np.float32
    np.testing.assert_array_equal(Q, Q.T)
    assert (l == -1).all() and (u == 1).all() and c.shape == (136,)


def test_arrow_mode_float64_iterations_equal(small, monkeypatch):
    from ipmzoo_tpu.models import ArrowQPData as RefArrowQPData
    for k, v in (("N", 136), ("B", 4), ("T", 8)):
        monkeypatch.setenv(f"BENCH_ARROW_{k}", str(v))
    Q, c, l, u = bench_torch.arrow_problem()
    data, st, _ = RefArrowQPData.from_dense(Q, c, l, u, dtype=jnp.float64)
    want = RefArrowIPM.for_data(data, structure=st, dtype=jnp.float64,
                                tol=1e-5).solve(data)
    _, value, _, _ = bench_torch.bench_arrow(CPU, dtype=torch.float64)
    assert bool(want.converged) and value == int(want.iterations)


def test_nd_mode(small, monkeypatch, spy):
    monkeypatch.setenv("BENCH_ND_G", "12")
    monkeypatch.setenv("BENCH_ND_LEAF", "16")
    monkeypatch.setattr(ref_timing, "measure_call",
                        lambda fn, *a, **k: float(next(small)))
    seen = spy(RefIPM, "solve")
    _, _, ref_unit, _ = bench.bench_nd("cpu")
    label, value, unit, counts = bench_torch.bench_nd(CPU)
    assert ref_unit == "x speedup" and unit == "iterations/s"
    assert bool(seen[0].converged) and counts["converged"] == 1.0
    assert abs(value - int(seen[0].iterations)) <= 1
    assert "n=144, leaf=16" in label
    # float64: iteration for iteration
    from ipmzoo_tpu.models.families import grid_qp
    fam = grid_qp(side=12, seed=0, dtype=jnp.float64)
    want = RefIPM(fam.settings, n=144, dtype=jnp.float64, tol=1e-5,
                  kernel="nd", nd_leaf=16, nd_fallback=False).solve(fam.data)
    _, value64, _, _ = bench_torch.bench_nd(CPU, dtype=torch.float64)
    assert value64 == int(want.iterations)


def mpc_env(monkeypatch):
    for k, v in (("T", 6), ("NS", 3), ("NU", 2), ("BATCH", 16)):
        monkeypatch.setenv(f"BENCH_MPC_{k}", str(v))


def test_mpc_mode(small, monkeypatch, spy):
    mpc_env(monkeypatch)
    seen = spy(RefRiccatiIPM, "solve_batch")
    ref_label, ref_value, ref_unit, _ = bench.bench_mpc("cpu")
    label, value, unit, counts = bench_torch.run_mode("mpc", CPU)
    assert unit == ref_unit == "iterations/s"
    assert "16 structured MPC QPs fully solved" in label
    assert "T=6, ns=3, nu=2, float32" in label
    assert "100.0% converged" in ref_label and "100.0% converged" in label
    assert counts["converged"] == 1.0 and value == counts["iterations"]
    assert float(np.asarray(seen[0].iterations).sum()) == ref_value
    assert abs(value - ref_value) <= 0.02 * ref_value
    # the instances are bench.py's
    ref = ref_random_mpc(horizon=6, n_states=3, n_controls=2, batch=16,
                         seed=0, dtype=jnp.float32)
    data, _ = bench_torch.mpc_problem(CPU)
    np.testing.assert_array_equal(data.A.numpy(), np.asarray(ref.A))
    np.testing.assert_array_equal(data.x0.numpy(), np.asarray(ref.x0))


def test_mpc_mode_float64_iterations_equal(small, monkeypatch):
    mpc_env(monkeypatch)
    ref = RefRiccatiIPM(6, 3, 2, dtype=jnp.float64, tol=1e-5, max_iter=40)
    want = ref.solve_batch(ref_random_mpc(horizon=6, n_states=3,
                                          n_controls=2, batch=16, seed=0,
                                          dtype=jnp.float64))
    _, value, _, counts = bench_torch.bench_mpc(CPU, dtype=torch.float64)
    np.testing.assert_array_equal(counts["result"].iterations.numpy(),
                                  np.asarray(want.iterations))
    assert value == float(np.asarray(want.iterations).sum())


def test_tf_mode(small, monkeypatch):
    """bench_tf at a small batch (16 of the 48 QPs, n=8, m=4): its
    float32 x is the float32 rounding of a point within 1e-9 of the
    port's float64 solve_batch of the same float32 data, ``converged``
    equal; the value is the useful iterations over the (one-second)
    wall.  bench.py's tf mode is not run: XLA's CPU compile of its pair
    pipeline takes minutes."""
    monkeypatch.setattr(bench_torch, "TF_B", 16)
    label, value, unit, counts = bench_torch.run_mode("tf", CPU)
    res = counts["result"]
    assert unit == "iterations/s" and "tol=1e-08" in label
    assert res.x.dtype == torch.float32 and tuple(res.x.shape) == (16, N)
    assert value == counts["iterations"] == float(res.iterations.sum())
    assert counts["converged"] == 1.0
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.formulations import Settings as PortSettings
    from ipmzoo_tpu_torch.models.state import tree_map
    sub = tree_map(lambda a: a[:16].double(),
                   make_batch(BATCH, N, M, torch.float32, device=CPU))
    want = CompiledIPM(PortSettings(), n=N, m_ineq=M, tol=1e-8,
                       device=CPU).solve_batch(sub)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  want.converged.numpy())
    x64 = want.x.numpy()
    assert (np.abs(res.x.double().numpy() - x64) <=
            1e-9 + np.abs(x64) * 2.0 ** -24).all()


def test_wide_mode(small):
    """bench_wide at a small batch: 4 portfolios of 128 assets (aug_dim
    129, float32, tol 1e-6) through solve_fused_compact on the CPU (K1's
    plain version); all converge, the value is the useful iterations over
    the (one-second) wall, and each objective is within 1e-5 (1 + |f|) of
    the JAX package's jnp solver in float64 at tol 1e-8 on the same
    portfolios (float32 at its floor: the gap 1e-6 bounds the objective's
    error; seen 1.8e-6).  bench.py has no such mode."""
    label, value, unit, counts = bench_torch.run_mode("wide", CPU, 4)
    out = counts["result"]
    assert unit == "iterations/s" and "aug_dim 129" in label
    assert "4 batched portfolio QPs" in label and "tol=1e-06" in label
    assert counts["converged"] == 1.0
    assert value == counts["iterations"] == float(out["iterations"].sum())
    ref = ref_families.portfolio(n_assets=128, batch=4, seed=0,
                                 dtype=jnp.float64)
    want = RefIPM(ref.settings, n=ref.n, m_ineq=ref.m_ineq, m_eq=ref.m_eq,
                  dtype=jnp.float64, kernel="jnp", tol=1e-8).solve_batch(
                      ref.data)
    assert bool(np.all(want.converged))
    Q, c = np.asarray(ref.data.Q), np.asarray(ref.data.c)

    def objective(x):
        return (0.5 * np.einsum("bi,bij,bj->b", x, Q, x)
                + np.einsum("bi,bi->b", c, x))
    f_ref = objective(np.asarray(want.x))
    f = objective(out["x"].double().numpy())
    assert (np.abs(f - f_ref) <= 1e-5 * (1 + np.abs(f_ref))).all()


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_mode(small, monkeypatch, world):
    """bench_sharded at the small size, both stepping timers at one
    second: the value is batch x 10 steps, as bench.py's; the report's
    efficiency is 1 / world.  World 2 runs in two gloo processes."""
    import ipmzoo_tpu.parallel.scaling as ref_scaling
    import torch_spawn_jobs as jobs
    from ipmzoo_tpu_torch.parallel import scaling
    # the reference's scaling module holds its own name of the timer
    monkeypatch.setattr(ref_scaling, "measure_chain",
                        lambda fn, init, **k: 1.0)
    ref_label, ref_value, ref_unit, _ = bench.bench_sharded(
        bench.make_batch(BATCH, N, M, jnp.float32), "cpu")
    if world == 1:
        monkeypatch.setattr(scaling, "time_steps", lambda *a, **k: 1.0)
        label, value, unit, counts = bench_torch.run_mode("sharded", CPU)
        outs = [(label, value, unit, counts["report"])]
    else:
        outs = jobs.run(jobs.bench_sharded, world, BATCH, N, M)
    for label, value, unit, report in outs:
        assert unit == ref_unit == "iterations/s"
        assert value == ref_value == BATCH * 10
        assert f"{BATCH} batched QPs, dp-sharded over {world} device(s)" \
            in label and ref_label.startswith(label.split(", dp-")[0])
        assert f"efficiency {100 / world:.1f}% vs 1 device" in label
        assert report.n_devices == world and report.steps == 10
        assert report.t_1dev == report.t_ndev == 1.0


def aug_env(monkeypatch):
    # aug_dim 6 + 4 + 2 = 12: no interpret-mode compile above n = 13 on
    # the reference's 'auto' side
    for k, v in (("N", 6), ("M", 4), ("ME", 2), ("B", 8)):
        monkeypatch.setenv(f"BENCH_AUG_{k}", str(v))


def test_aug_mode(small, monkeypatch, spy):
    aug_env(monkeypatch)
    seen = spy(RefIPM, "solve_batch")
    ref_label, ref_value, ref_unit, _ = bench.bench_aug("cpu")
    label, value, unit, counts = bench_torch.bench_aug(CPU)
    assert unit == ref_unit == "iterations/s"
    assert "8 equality+inequality QPs (n=6, m_ineq=4, m_eq=2" in label
    assert "aug_dim=12" in label and "refine=2" in label
    # the races in bench.py's order, blockg then auto: the same counts
    for k, ref in zip(("blockg", "auto"), seen):
        assert counts[k]["converged"] == 1.0
        ref_its = float(np.asarray(ref.iterations).sum())
        assert abs(counts[k]["iterations"] - ref_its) <= 0.02 * ref_its
    assert value == max(c["iterations"] for c in counts.values())
    # the QPs are bench.py's
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(8, 6, 6)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / 6 + np.eye(6, dtype=np.float32)
    x0 = rng.normal(size=(8, 6)).astype(np.float32)
    A_eq = rng.normal(size=(8, 2, 6)).astype(np.float32)
    data = bench_torch.aug_data(CPU)
    assert data.Q.numpy().tobytes() == Q.tobytes()
    np.testing.assert_array_equal(
        data.b_eq.numpy(), np.einsum("bmn,bn->bm", A_eq, x0))


def test_aug_mode_float64_iterations_equal(small, monkeypatch):
    from ipmzoo_tpu.formulations import EqualityHandling
    aug_env(monkeypatch)
    data = bench_torch.aug_data(CPU, torch.float64)
    ref_data = RefQPData(**{f.name: jnp.asarray(getattr(data, f.name)
                                                .numpy())
                            for f in dataclasses.fields(RefQPData)})
    for kernel in ("blockg", "auto"):
        ref = RefIPM(Settings(equalities=True,
                              equality_handling=EqualityHandling
                              .REGULARIZATION), n=6, m_ineq=4, m_eq=2,
                     dtype=jnp.float64, tol=1e-5, scale_tol=True, refine=2,
                     gondzio=2, kernel=kernel).solve_batch(ref_data)
        res = bench_torch.aug_solver(kernel, CPU,
                                     torch.float64).solve_batch(data)
        assert res.iterations.tolist() == np.asarray(
            ref.iterations).tolist()
        np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x),
                                   atol=1e-8)


def test_normal_mode(small, monkeypatch, spy):
    for k, v in (("N", 12), ("M", 4), ("B", 4)):
        monkeypatch.setenv(f"BENCH_NORMAL_{k}", str(v))
    seen = spy(RefIPM, "solve_batch")
    _, _, ref_unit, _ = bench.bench_normal("cpu")
    label, value, unit, counts = bench_torch.bench_normal(CPU)
    assert unit == ref_unit == "iterations/s"
    assert "4 dense QPs (n=12, m=4)" in label
    # 'blockg' and 'block' iterate as the reference's; the reference's
    # 'normal' binds an inexact H^-1 (tests/test_torch_block_modes.py),
    # the port's takes the augmented path's iterations
    for k, ref in zip(("blockg", "block"), seen):
        ref_its = float(np.asarray(ref.iterations).sum())
        assert counts[k]["converged"] == 1.0
        assert abs(counts[k]["iterations"] - ref_its) <= 0.02 * ref_its
    assert counts["normal"]["converged"] == 1.0
    assert abs(counts["normal"]["iterations"] - counts["block"][
        "iterations"]) <= 0.05 * counts["block"]["iterations"]
    assert value == max(c["iterations"] for c in counts.values())


@pytest.mark.parametrize("mode,flags", [
    ("arrow", dict(dense=True)), ("nd", dict(dense=True)),
    ("kkt", dict(large=True))])
def test_dense_halves_and_large_point(mode, flags, small, monkeypatch):
    """--dense and --large on a small size: the unit bench.py reports,
    the dense solver's mode the reference's, and the dense solve held to
    the reference's in float64 (kkt: the systems and the solve)."""
    from ipmzoo_tpu_torch import CompiledIPM, QPData
    env = {"arrow": (("BENCH_ARROW_N", 60), ("BENCH_ARROW_B", 4),
                     ("BENCH_ARROW_T", 4)),
           "nd": (("BENCH_ND_G", 8), ("BENCH_ND_LEAF", 8)),
           "kkt": (("BENCH_KKT_DIMS", "64,128"), ("BENCH_KKT_B", 3))}[mode]
    for k, v in env:
        monkeypatch.setenv(k, str(v))
    monkeypatch.setattr(ref_timing, "measure_call",
                        lambda fn, *a, **k: float(next(small)))
    ref_fn = {"arrow": lambda: bench.bench_arrow("cpu"),
              "nd": lambda: bench.bench_nd("cpu"),
              "kkt": lambda: bench.bench_kkt(
                  bench.make_batch(BATCH, N, M, jnp.float32), "cpu")}[mode]
    _, _, ref_unit, _ = ref_fn()
    label, value, unit, counts = bench_torch.run_mode(mode, CPU, **flags)
    assert unit == ref_unit and value > 0
    with pytest.raises(ValueError, match="belongs to"):
        bench_torch.run_mode("solve", CPU, **flags)
    if mode == "kkt":
        assert "via signed block-Cholesky" in label
        assert sorted(counts["points"]) == [64, 128]
        blocks, R = bench_torch.kkt_large_systems(CPU, 64, torch.float64)
        X = bench_torch.blockg_two_solves(blocks, R)
        from ipmzoo_tpu.ops.blockg import blockg_factor, blockg_solve
        H, A, S = (np.asarray(b) for b in (blocks[0][0][0], blocks[1][0][0],
                                           blocks[1][1][0]))
        fact = blockg_factor([[jnp.asarray(H)], [jnp.asarray(A),
                                                 jnp.asarray(S)]],
                             (1.0, -1.0))
        for j in range(2):
            np.testing.assert_allclose(
                X[0, :, j].numpy(),
                np.asarray(blockg_solve(fact, jnp.asarray(R[0, :, j]))),
                atol=1e-10)
        return
    assert "dense kernel 'ldlt'" in label and "speedup" in label
    assert counts["ms_dense"] > 0 and counts["ms_structured"] > 0
    if mode == "arrow":
        from ipmzoo_tpu.formulations import Bounds, InequalityHandling
        Q, c, lo, hi = bench_torch.arrow_problem()
        settings = Settings(inequalities=Bounds.NONE,
                            inequality_handling=InequalityHandling.SLACKS)
        ref = RefIPM(settings, n=60, dtype=jnp.float64, tol=1e-5).solve(
            RefQPData.make(Q=Q, c=c, l_x=lo, u_x=hi, dtype=jnp.float64))
        from ipmzoo_tpu_torch.models.convert import settings_from_reference
        port = CompiledIPM(settings_from_reference(settings), n=60,
                           tol=1e-5, device="cpu").solve(QPData.make(
                               Q=Q, c=c, l_x=lo, u_x=hi, device="cpu"))
    else:
        from ipmzoo_tpu.models.families import grid_qp as ref_grid_qp
        from ipmzoo_tpu_torch.models.families import grid_qp
        rfam = ref_grid_qp(side=8, seed=0, dtype=jnp.float64)
        ref = RefIPM(rfam.settings, n=64, dtype=jnp.float64,
                     tol=1e-5).solve(rfam.data)
        fam = grid_qp(side=8, seed=0, device="cpu")
        port = CompiledIPM(fam.settings, n=64, tol=1e-5,
                           device="cpu").solve(fam.data)
    assert int(port.iterations) == int(ref.iterations)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-8)


def test_unknown_mode_and_the_lists_of_modes():
    with pytest.raises(ValueError, match="unknown mode"):
        bench_torch.run_mode("nope", CPU)
    assert bench_torch.MODES == ("fused", "solve", "steps", "kkt", "schur",
                                 "arrow", "nd", "normal", "aug", "mpc", "tf",
                                 "sharded", "wide")
    assert bench_torch.REFUSED == {}
    assert not set(bench_torch.MODES) & set(bench_torch.REFUSED)


def test_main_prints_one_json_line_last(capsys):
    assert bench_torch.main(["--mode", "kkt", "--device", "cpu", "--batch",
                             "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["unit"] == "GFLOP/s" and rec["vs_baseline"] is None
    assert "8 systems of dim" in rec["metric"]
    # the wall's median and spread stand on an earlier line
    assert any("median" in ln and "spread" in ln for ln in lines[:-1])


def test_environment_sizes_the_workload_and_the_default_device_is_the_card():
    env = dict(os.environ, BENCH_BATCH="8", BENCH_N="4", BENCH_M="2",
               BENCH_STEPS="2", BENCH_TOL="1e-5", BENCH_MODE="steps",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "bench_torch.py", "--device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert "8 batched QPs, batched step" in rec["metric"]
    assert "n=4, m=2" in rec["metric"] and rec["vs_baseline"] is None
    # no --device: the card, and without one it fails rather than fall
    # back to the CPU
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0 and "metric" not in out.stdout
