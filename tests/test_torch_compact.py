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
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
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
    port = CompiledIPM(port_settings(Settings()), n=8, m_ineq=4, tol=1e-8,
                       device="cpu")
    assert port.default_schedule(128) == [(16, 1), (16, 4), (68, 32)]
    out = result_to_numpy(port.solve_batch_compact(
        qpdata_from_numpy(data, device="cpu"), esc_cap=0))
    np.testing.assert_array_equal(out["converged"], np.asarray(r.converged))
    np.testing.assert_array_equal(out["diverged"], np.asarray(r.diverged))
    np.testing.assert_array_equal(out["iterations"],
                                  np.asarray(r.iterations))
    np.testing.assert_allclose(out["x"], np.asarray(r.x), rtol=0, atol=1e-8)
    assert out["converged"].all()


def test_pure_compaction_reproduces_solve_batch():
    # no tail Gondzio, no restart: compaction changes who keeps
    # stepping, never the steps themselves
    data = qpdata_from_numpy(numpy_batch(96, 6, 3, seed=2), device="cpu")
    s = CompiledIPM(port_settings(Settings()), n=6, m_ineq=3, tol=1e-8,
                    device="cpu")
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
    data = qpdata_from_numpy(numpy_batch(64, 6, 3, seed=4), device="cpu")
    s = CompiledIPM(port_settings(Settings()), n=6, m_ineq=3, tol=1e-8,
                    device="cpu")
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
        full = make_batch(10240, 16, 8, torch.float64, device="cpu")
        return QPData(**{k: getattr(full, k)[2487:2488].clone()
                         for k in ("Q", "c", "A_ineq", "l_A_ineq",
                                   "u_A_ineq", "A_eq", "b_eq", "l_x",
                                   "u_x")})

    def test_gondzio_breaks_cycle(self):
        data = self.cycler()
        plain = CompiledIPM(port_settings(Settings()), n=16, m_ineq=8,
                            tol=1e-8, max_iter=60, device="cpu")
        assert not bool(plain.solve_batch(data).converged[0])
        gz = CompiledIPM(port_settings(Settings()), n=16, m_ineq=8, tol=1e-8,
                         max_iter=60, gondzio=2, device="cpu")
        rg = gz.solve_batch(data)
        assert bool(rg.converged[0])
        assert int(rg.iterations[0]) < 20

    def test_compact_tail_rescues_cycler(self):
        easy = qpdata_from_numpy(numpy_batch(63, 16, 8, seed=1), device="cpu")
        cyc = self.cycler()
        batch = QPData(**{k: torch.cat([getattr(easy, k), getattr(cyc, k)])
                          for k in ("Q", "c", "A_ineq", "l_A_ineq",
                                    "u_A_ineq", "A_eq", "b_eq", "l_x",
                                    "u_x")})
        s = CompiledIPM(port_settings(Settings()), n=16, m_ineq=8, tol=1e-8,
                        device="cpu")
        r = s.solve_batch_compact(batch, schedule=[(12, 1), (12, 8),
                                                   (40, 16)])
        assert bool(r.converged.all())


class TestEscalationCap:
    def test_auto_cap_at_f32_tight_tol_escalates_in_f64(self):
        # esc_cap='auto' at float32 and tol 1e-6 resolves to 32 and runs
        # the float64 escalation stage
        s = CompiledIPM(port_settings(Settings()), n=4, m_ineq=2,
                        dtype=torch.float32, tol=1e-6, device="cpu")
        data = qpdata_from_numpy(numpy_batch(4, 4, 2, seed=6),
                                 dtype=torch.float32, device="cpu")
        r = s.solve_batch_compact(data)
        assert r.x.dtype == torch.float32 and bool(r.converged.all())
        twin = s._esc_twin
        assert twin.dtype == torch.float64 and twin.mu_floor == s.mu_floor
        for cap in (8, 0):
            r = s.solve_batch_compact(data, esc_cap=cap)
            assert r.x.dtype == torch.float32 and bool(r.converged.all())

    def test_auto_cap_is_zero_where_the_reference_needs_no_stage(self):
        data = qpdata_from_numpy(numpy_batch(4, 4, 2, seed=6), device="cpu")
        s64 = CompiledIPM(port_settings(Settings()), n=4, m_ineq=2, tol=1e-6,
                          device="cpu")
        assert bool(s64.solve_batch_compact(data).converged.all())
        d32 = qpdata_from_numpy(numpy_batch(4, 4, 2, seed=6),
                                dtype=torch.float32, device="cpu")
        s32 = CompiledIPM(port_settings(Settings()), n=4, m_ineq=2,
                          dtype=torch.float32, tol=1e-5, device="cpu")
        assert bool(s32.solve_batch_compact(d32).converged.all())
        assert not hasattr(s64, "_esc_twin")
        assert not hasattr(s32, "_esc_twin")


class TestEscalation:
    """The escalation stage against the reference's (tests/test_compact.py
    TestEscalation).  The reference's twin carries double-single pairs
    (double-double in float64), the port's computes in float64, so the
    two are not bit-identical: ``converged`` equal, x within 1e-6, and
    per-instance iteration counts within 2."""

    @staticmethod
    def starved(dtype_np, dtype_t):
        B, n, m = 8, 6, 3
        raw = numpy_batch(B, n, m, seed=5)
        ref = RefIPM(Settings(), n=n, m_ineq=m, dtype=dtype_np, tol=1e-8,
                     max_iter=3)
        port = CompiledIPM(port_settings(Settings()), n=n, m_ineq=m,
                           dtype=dtype_t, tol=1e-8, max_iter=3, device="cpu")
        jd = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype_np), raw)
        return ref, port, jd, qpdata_from_numpy(raw, dtype=dtype_t,
                                                device="cpu")

    def test_escalation_rescues_starved_batch(self):
        # every earlier stage is starved (budget 3, no mop-up headroom),
        # so only the escalation stage can converge the batch
        ref, port, jd, data = self.starved(jnp.float64, torch.float64)
        starved = port.solve_batch_compact(data, schedule=[(3, 1)],
                                           esc_cap=0)
        assert not bool(starved.converged.all())
        out = result_to_numpy(port.solve_batch_compact(
            data, schedule=[(3, 1)], esc_cap=8, esc_iters=60))
        r = ref.solve_batch_compact(jd, schedule=[(3, 1)], esc_cap=8,
                                    esc_iters=60)
        assert out["converged"].all()
        np.testing.assert_array_equal(out["converged"],
                                      np.asarray(r.converged))
        np.testing.assert_allclose(out["x"], np.asarray(r.x), rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(out["iterations"] -
                      np.asarray(r.iterations)).max() <= 2
        # and the answer is the straight solve's
        full = CompiledIPM(port_settings(Settings()), n=6, m_ineq=3,
                           max_iter=60, device="cpu").solve_batch(data)
        np.testing.assert_allclose(out["x"], full.x.numpy(), rtol=1e-6,
                                   atol=1e-6)
        # an f64 solver is its own twin
        assert not hasattr(port, "_esc_twin")

    def test_float32_starved_batch_matches_two_float_reference(self):
        # float32: the reference escalates in double-single pairs, the
        # port in float64; the merged x is rounded to float32 on both
        # sides, so it agrees to float32 rounding of the optimum
        ref, port, jd, data = self.starved(jnp.float32, torch.float32)
        kw = dict(schedule=[(3, 1)], esc_cap=8, esc_iters=60)
        out = result_to_numpy(port.solve_batch_compact(data, **kw))
        r = ref.solve_batch_compact(jd, **kw)
        assert out["x"].dtype == np.float32
        assert out["converged"].all()
        np.testing.assert_array_equal(out["converged"],
                                      np.asarray(r.converged))
        np.testing.assert_allclose(out["x"], np.asarray(r.x), rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(out["iterations"] -
                      np.asarray(r.iterations)).max() <= 2
        assert port._esc_twin.mu_floor == port.mu_floor == ref.mu_floor

    def test_auto_cap_tied_to_dtype_and_tol(self):
        s32 = CompiledIPM(port_settings(Settings()), n=4, m_ineq=2,
                          dtype=torch.float32, tol=1e-6, device="cpu")
        s64 = CompiledIPM(port_settings(Settings()), n=4, m_ineq=2, tol=1e-6,
                          device="cpu")
        data = numpy_batch(4, 4, 2, seed=6)
        s32.solve_batch_compact(qpdata_from_numpy(data, dtype=torch.float32,
                                                  device="cpu"))
        s64.solve_batch_compact(qpdata_from_numpy(data, device="cpu"))
        # f32 at tol 1e-6 builds the float64 twin; f64 never needs it
        assert hasattr(s32, "_esc_twin")
        assert not hasattr(s64, "_esc_twin")

    def test_escalated_diverged_instance_reported_both_ways(self):
        """The reference's stage gathers diverged instances with the
        active ones and returns ``diverged`` unchanged, so a diverged
        instance it converges ends both converged and diverged
        (ipmzoo_tpu/models/compact.py:127).  The port matches that."""
        ref, port, jd, data = self.starved(jnp.float64, torch.float64)
        r_state = jax.vmap(ref.init_state)(jd)
        p_state = port.init_state(data)
        res_tol = torch.full((8,), 1e-8, dtype=torch.float64)
        div = torch.zeros(8, dtype=torch.bool)
        div[2] = True
        p_state, p_div = port._escalate_batch(data, p_state, res_tol, div,
                                              8, 60, 2)
        r_state, r_div = ref._escalate_batch(
            jd, r_state, jnp.asarray(res_tol.numpy()),
            jnp.asarray(div.numpy()), 8, 60, 2)
        p_conv = port._done(p_state, res_tol).numpy()
        r_conv = np.asarray((r_state.residual < 1e-8) & (r_state.gap < 1e-8))
        assert p_conv[2] and p_div[2].item()
        np.testing.assert_array_equal(p_div.numpy(), np.asarray(r_div))
        np.testing.assert_array_equal(p_conv, r_conv)
        np.testing.assert_allclose(p_state.vars[0].numpy(),
                                   np.asarray(r_state.vars[0]), rtol=1e-6,
                                   atol=1e-6)


def test_does_not_write_into_the_callers_data():
    data = qpdata_from_numpy(numpy_batch(70, 4, 2, seed=9), device="cpu")
    before = {k: getattr(data, k).clone() for k in ("Q", "c", "l_x")}
    CompiledIPM(port_settings(Settings()), n=4, m_ineq=2,
                device="cpu").solve_batch_compact(data)
    for k, v in before.items():
        assert torch.equal(getattr(data, k), v)
