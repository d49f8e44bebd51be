"""The port's fused engine (ipmzoo_tpu_torch/models/fused.py and
fused_compact.py) on the CPU, where it runs kernel K1's plain version,
against the reference's FusedBatchedIPM in Pallas interpret mode, float64,
bt=8 (as tests/test_fused.py runs it), on the same numpy inputs.

Parity: per-instance iterations equal, ``converged`` equal, x within
rtol 1e-10 / atol 1e-10.  The ten tests of tests/test_fused.py are
mirrored.  The escalation stage runs a float64 twin where the reference
runs double-single (here double-double) pairs; where it does work the
two agree in ``converged``, x within 1e-6 and iterations within 2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import Bounds, Settings
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.models.fused import FusedBatchedIPM as RefFused
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.convert import qpdata_from_numpy
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.ops import cuda_fused


def numpy_batch(B, n, m, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    return RefQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(B, n)),
        A_ineq=rng.normal(size=(B, m, n)),
        l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
        A_eq=np.zeros((B, 0, n)), b_eq=np.zeros((B, 0)),
        l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0))


@functools.lru_cache(maxsize=None)
def solvers(n, m, max_iter=100, inequalities=Bounds.BOTH):
    """(reference, port) fused solvers, built once per configuration."""
    settings = Settings(inequalities=inequalities)
    ref = RefFused(settings, n=n, m_ineq=m, bt=8, dtype=jnp.float64,
                   max_iter=max_iter)
    port = FusedBatchedIPM(port_settings(settings), n=n, m_ineq=m, bt=8,
                           dtype=torch.float64, max_iter=max_iter,
                           device="cpu")
    return ref, port


def both(entry, n, m, data, max_iter=100, inequalities=Bounds.BOTH,
         **kw):
    """Run the same entry of both solvers on the same numpy data; returns
    (reference, port) results as numpy dicts."""
    ref, port = solvers(n, m, max_iter, inequalities)
    r = getattr(ref, entry)(jax.tree_util.tree_map(jnp.asarray, data), **kw)
    p = getattr(port, entry)(qpdata_from_numpy(data, device="cpu"), **kw)
    return ({k: np.asarray(v) for k, v in r.items()},
            {k: v.numpy() for k, v in p.items()})


def assert_parity(r, p):
    np.testing.assert_array_equal(p["converged"], r["converged"])
    np.testing.assert_array_equal(p["iterations"], r["iterations"])
    np.testing.assert_allclose(p["x"], r["x"], rtol=1e-10, atol=1e-10)
    assert p["x"].shape == r["x"].shape


def test_fused_matches_reference():
    r, p = both("solve_fused", 6, 3, numpy_batch(8, 6, 3))
    assert p["converged"].all()
    assert_parity(r, p)
    np.testing.assert_allclose(p["gap"], r["gap"], rtol=1e-6, atol=1e-14)


def test_fused_gondzio_matches_reference():
    r, p = both("solve_fused", 6, 3, numpy_batch(8, 6, 3, seed=11),
                gondzio=2)
    assert p["converged"].all()
    assert_parity(r, p)


def test_fused_batch_padding():
    # 5 instances, tile 8: the replicas must not leak into the result
    r, p = both("solve_fused", 4, 2, numpy_batch(5, 4, 2, seed=3))
    assert p["x"].shape == (5, 4) and p["converged"].all()
    assert_parity(r, p)


def test_fused_box_only():
    r, p = both("solve_fused", 5, 0, numpy_batch(6, 5, 0, seed=4),
                inequalities=Bounds.NONE)
    assert p["converged"].all()
    assert_parity(r, p)


def test_fused_refined_converges_full_batch():
    r, p = both("solve_fused_refined", 6, 3, numpy_batch(16, 6, 3, seed=3),
                max_iter=40, tail_cap=4, tail_iters=30)
    assert p["converged"].all()
    assert_parity(r, p)


def test_fused_refined_tail_rescues_straggler():
    data = numpy_batch(8, 6, 3, seed=5)
    _, port = solvers(6, 3, 4)
    core = port.solve_fused(qpdata_from_numpy(data, device="cpu"))
    assert not bool(core["converged"].all())
    r, p = both("solve_fused_refined", 6, 3, data, max_iter=4, tail_cap=8,
                tail_iters=40)
    assert p["converged"].all()
    assert_parity(r, p)
    # tail instances accumulate iterations on top of the fused budget
    rescued = ~core["converged"].numpy()
    assert (p["iterations"][rescued] > 4).all()


def test_fused_compact_matches_refined():
    data = numpy_batch(24, 6, 3, seed=7)
    # the default esc_cap=32 on both sides: nothing is left to escalate
    r, p = both("solve_fused_compact", 6, 3, data, max_iter=40,
                schedule=[(7, 1), (33, 3)], tail_cap=8)
    assert p["converged"].all()
    assert_parity(r, p)
    # iteration accounting is cumulative across the resume stages
    _, port = solvers(6, 3, 40)
    ref = port.solve_fused_refined(qpdata_from_numpy(data, device="cpu"),
                                   tail_cap=8)
    np.testing.assert_allclose(p["x"], ref["x"].numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_array_equal(p["iterations"], ref["iterations"].numpy())


def test_fused_compact_capacity_overflow_mopped_up():
    # cap 8 of ~24 actives: the full-batch mop-up finishes the overflow
    r, p = both("solve_fused_compact", 6, 3, numpy_batch(24, 6, 3, seed=21),
                max_iter=40, schedule=[(1, 1), (3, 3)], tail_cap=8,
                esc_cap=0)
    assert p["converged"].all()
    assert_parity(r, p)


@pytest.mark.parametrize("entry,kw", [
    ("solve_fused", {}),
    ("solve_fused_refined", {"tail_cap": 8}),
    ("solve_fused_compact", {"schedule": [(6, 1), (34, 2)], "tail_cap": 8,
                             "esc_cap": 0}),
])
def test_fused_padded_public_entries(entry, kw):
    # 11 instances, tile 8: every public entry pads before solving and
    # slices the result back
    r, p = both(entry, 4, 2, numpy_batch(11, 4, 2, seed=9), max_iter=40,
                **kw)
    assert p["x"].shape == (11, 4) and p["converged"].all()
    assert_parity(r, p)


def test_escalation_stage_runs_at_every_cap():
    # the default esc_cap=32, a smaller cap, esc_cap=0 and a cold restart
    # all solve, and an f64 solver escalates with itself
    _, port = solvers(4, 2)
    data = qpdata_from_numpy(numpy_batch(8, 4, 2, seed=6), device="cpu")
    for kw in ({}, {"esc_cap": 8}, {"esc_cap": 0}, {"esc_warm": False}):
        assert bool(port.solve_fused_compact(data, **kw)["converged"].all())
    assert port._escalation_twin() is port


def test_fused_compact_escalation_rescues_residual_stuck():
    # every earlier stage is starved (core budget 4, tails 1 iteration),
    # so only the escalation stage can converge the batch
    data = numpy_batch(8, 6, 3, seed=5)
    _, port = solvers(6, 3, 4)
    kw = dict(schedule=[(4, 1)], tail_iters=1)
    starved = port.solve_fused_compact(qpdata_from_numpy(data, device="cpu"),
                                       esc_cap=0, **kw)
    assert not bool(starved["converged"].all())
    r, p = both("solve_fused_compact", 6, 3, data, max_iter=4,
                esc_iters=60, **kw)
    assert p["converged"].all()
    np.testing.assert_array_equal(p["converged"], r["converged"])
    np.testing.assert_allclose(p["x"], r["x"], rtol=1e-6, atol=1e-6)
    assert np.abs(p["iterations"] - r["iterations"]).max() <= 2
    # escalated instances accumulate iterations on top of earlier stages
    rescued = ~starved["converged"].numpy()
    assert (p["iterations"][rescued] > 4).all()


def test_float32_escalation_twin_is_float64():
    fused = FusedBatchedIPM(port_settings(Settings()), n=4, m_ineq=2, bt=8,
                            dtype=torch.float32, tol=1e-6, max_iter=4,
                            device="cpu")
    data = qpdata_from_numpy(numpy_batch(8, 4, 2, seed=6),
                             dtype=torch.float32, device="cpu")
    fused.host_syncs = 0
    out = fused.solve_fused_compact(data, tail_iters=1, esc_iters=60)
    twin = fused._escalation_twin()
    assert twin.dtype == torch.float64 and twin.mu_floor == fused.mu_floor
    assert out["x"].dtype == torch.float32 and out["converged"].all()
    # the twin's loop checks are counted on the solver that ran it
    assert fused.host_syncs >= twin.host_syncs > 0


def test_cpu_solves_run_the_plain_version():
    cuda_fused.reset_launch_counts()
    _, port = solvers(4, 2)
    out = port.solve_fused(qpdata_from_numpy(numpy_batch(8, 4, 2, seed=1),
                                             device="cpu"))
    assert bool(out["converged"].all())
    assert cuda_fused.launches == {"fused": 0, "phase": 0}
    assert out["iterations"].dtype == torch.float64


def test_fused_f32_reaches_1e6_no_rollbacks():
    """Counterpart of tests/test_precision_floor.py's fused test on the
    port: float32 converges the whole batch at tol 1e-6 with the
    dtype-tied mu floor active."""
    B, n, m = 48, 16, 8
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, n, n)).astype(np.float32)
    data = RefQPData(
        Q=np.einsum("bij,bkj->bik", Mx, Mx) / n + np.eye(n, dtype=np.float32),
        c=rng.normal(size=(B, n)), A_ineq=rng.normal(size=(B, m, n)),
        l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
        A_eq=np.zeros((B, 0, n)), b_eq=np.zeros((B, 0)),
        l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0))
    fused = FusedBatchedIPM(port_settings(Settings()), n=n, m_ineq=m,
                            dtype=torch.float32, tol=1e-6, bt=16, max_iter=40,
                            device="cpu")
    assert fused.mu_floor == float(np.finfo(np.float32).eps) ** 2
    out = fused.solve_fused_refined(qpdata_from_numpy(data,
                                                      dtype=torch.float32,
                                                      device="cpu"),
                                    tail_cap=16)
    assert out["x"].dtype == torch.float32
    assert float(out["converged"].double().mean()) == 1.0
