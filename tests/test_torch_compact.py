"""solve_batch_compact of the port (ipmzoo_tpu_torch/models/compact.py)
on the CPU in float64, against the reference's compact engine (kernel
'auto': the Pallas LDL^T kernels in interpret mode) on the same numpy
inputs, and the anti-cycling facts tests/test_compact.py pins.

Parity: per-instance iteration counts and ``converged`` equal, x within
1e-8.  The schedule gathers instances by a stable sort of their
priority, as the reference's, so the same instances land in each
capacity-limited stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.formulations import Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu_torch.models import CompiledIPM, QPData
from ipmzoo_tpu_torch.models.convert import (make_batch, qpdata_from_numpy,
                                             result_to_numpy)


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


def test_matches_reference_compact_engine():
    data = numpy_batch(128, 8, 4)
    ref = RefIPM(Settings(), n=8, m_ineq=4, dtype=jnp.float64, tol=1e-8)
    r = ref.solve_batch_compact(jax.tree_util.tree_map(jnp.asarray, data),
                                esc_cap=0)
    port = CompiledIPM(Settings(), n=8, m_ineq=4, tol=1e-8)
    assert port.default_schedule(128) == [(16, 1), (16, 4), (68, 32)]
    out = result_to_numpy(port.solve_batch_compact(qpdata_from_numpy(data),
                                                   esc_cap=0))
    np.testing.assert_array_equal(out["converged"], np.asarray(r.converged))
    np.testing.assert_array_equal(out["diverged"], np.asarray(r.diverged))
    np.testing.assert_array_equal(out["iterations"],
                                  np.asarray(r.iterations))
    np.testing.assert_allclose(out["x"], np.asarray(r.x), rtol=0, atol=1e-8)
    assert out["converged"].all()


def test_pure_compaction_reproduces_solve_batch():
    # no tail Gondzio, no restart: compaction changes who keeps
    # stepping, never the steps themselves
    data = qpdata_from_numpy(numpy_batch(96, 6, 3, seed=2))
    s = CompiledIPM(Settings(), n=6, m_ineq=3, tol=1e-8)
    full = s.solve_batch(data)
    comp = s.solve_batch_compact(data, schedule=[(4, 1), (40, 2)],
                                 tail_gondzio=0, tail_restart=False)
    assert bool(full.converged.all()) and bool(comp.converged.all())
    assert torch.equal(full.iterations, comp.iterations)
    np.testing.assert_allclose(comp.x.numpy(), full.x.numpy(), rtol=0,
                               atol=1e-12)


def test_capacity_overflow_is_mopped_up():
    # a tail capacity of 1 cannot hold the active set; the full-batch
    # mop-up finishes the overflow
    data = qpdata_from_numpy(numpy_batch(64, 6, 3, seed=4))
    s = CompiledIPM(Settings(), n=6, m_ineq=3, tol=1e-8)
    r = s.solve_batch_compact(data, schedule=[(1, 1), (30, 64)])
    assert bool(r.converged.all())
    # the mop-up asked the device once per step it ran, plus once to stop
    assert s.host_syncs >= 2


class TestMehrotraCycling:
    """Plain Mehrotra cycles on instance 2487 of the benchmark workload
    (seed 0, B=10240); Gondzio rounds break the cycle
    (tests/test_compact.py pins the same facts on the reference)."""

    @staticmethod
    def cycler():
        full = make_batch(10240, 16, 8, torch.float64)
        return QPData(**{k: getattr(full, k)[2487:2488].clone()
                         for k in ("Q", "c", "A_ineq", "l_A_ineq",
                                   "u_A_ineq", "A_eq", "b_eq", "l_x",
                                   "u_x")})

    def test_gondzio_breaks_cycle(self):
        data = self.cycler()
        plain = CompiledIPM(Settings(), n=16, m_ineq=8, tol=1e-8,
                            max_iter=60)
        assert not bool(plain.solve_batch(data).converged[0])
        gz = CompiledIPM(Settings(), n=16, m_ineq=8, tol=1e-8, max_iter=60,
                         gondzio=2)
        rg = gz.solve_batch(data)
        assert bool(rg.converged[0])
        assert int(rg.iterations[0]) < 20

    def test_compact_tail_rescues_cycler(self):
        easy = qpdata_from_numpy(numpy_batch(63, 16, 8, seed=1))
        cyc = self.cycler()
        batch = QPData(**{k: torch.cat([getattr(easy, k), getattr(cyc, k)])
                          for k in ("Q", "c", "A_ineq", "l_A_ineq",
                                    "u_A_ineq", "A_eq", "b_eq", "l_x",
                                    "u_x")})
        s = CompiledIPM(Settings(), n=16, m_ineq=8, tol=1e-8)
        r = s.solve_batch_compact(batch, schedule=[(12, 1), (12, 8),
                                                   (40, 16)])
        assert bool(r.converged.all())


class TestEscalationCap:
    def test_auto_cap_at_f32_tight_tol_raises(self):
        s = CompiledIPM(Settings(), n=4, m_ineq=2, dtype=torch.float32,
                        tol=1e-6)
        data = qpdata_from_numpy(numpy_batch(4, 4, 2, seed=6),
                                 dtype=torch.float32)
        with pytest.raises(NotImplementedError, match="item 7"):
            s.solve_batch_compact(data)
        with pytest.raises(NotImplementedError, match="esc_cap=8"):
            s.solve_batch_compact(data, esc_cap=8)
        r = s.solve_batch_compact(data, esc_cap=0)
        assert r.x.dtype == torch.float32

    def test_auto_cap_is_zero_where_the_reference_needs_no_stage(self):
        data = qpdata_from_numpy(numpy_batch(4, 4, 2, seed=6))
        r = CompiledIPM(Settings(), n=4, m_ineq=2,
                        tol=1e-6).solve_batch_compact(data)
        assert bool(r.converged.all())
        d32 = qpdata_from_numpy(numpy_batch(4, 4, 2, seed=6),
                                dtype=torch.float32)
        r32 = CompiledIPM(Settings(), n=4, m_ineq=2, dtype=torch.float32,
                          tol=1e-5).solve_batch_compact(d32)
        assert bool(r32.converged.all())


def test_does_not_write_into_the_callers_data():
    data = qpdata_from_numpy(numpy_batch(70, 4, 2, seed=9))
    before = {k: getattr(data, k).clone() for k in ("Q", "c", "l_x")}
    CompiledIPM(Settings(), n=4, m_ineq=2).solve_batch_compact(data)
    for k, v in before.items():
        assert torch.equal(getattr(data, k), v)
