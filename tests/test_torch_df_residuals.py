"""``df_residuals`` and ``hybrid_refine`` of the port, backed by float64,
against the JAX package's two-float pipelines on the CPU.

The four cases of tests/test_df_residuals.py on the port's internals
(the metrics at a float32-rounded optimum track the float64 truth where
plain float32 evaluation floats above it; the gap agrees with the plain
one away from the optimum; the eager iteration converges; early steps
match the plain iteration), then the port's float32 iteration against
the reference's over three steps (rtol 2e-4, atol 2e-5, the reference's
own measure), and ``hybrid_refine`` with ``refine=2`` per kernel mode
against the reference's compensated refinement: ``converged`` equal, x
within 1e-5, iterations within 2 (the instances 'regldlt' leaves
unconverged in float32 included: the two sides stall alike).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import InequalityHandling, Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu_torch import CompiledIPM, QPData
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.state import with_batch_axis


def problem(n=16, mi=6, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    Q = M @ M.T / n + np.eye(n)
    xf = rng.uniform(-0.5, 0.5, size=n)
    A = rng.normal(size=(mi, n))
    return dict(Q=Q, c=rng.normal(size=n), A_ineq=A, l_A_ineq=A @ xf - 1,
                u_A_ineq=A @ xf + 1, l_x=np.full(n, -2.0),
                u_x=np.full(n, 2.0))


def data_of(raw, dtype):
    return QPData.make(**raw, dtype=dtype, device="cpu")


def solver(n, mi, dtype=torch.float32, settings=Settings(), **kw):
    return CompiledIPM(port_settings(settings), n=n, m_ineq=mi, dtype=dtype,
                       device="cpu", **kw)


def batched(x):
    return with_batch_axis(x, True)


class TestDFMetrics:
    def test_df_metrics_track_f64_at_optimum(self):
        """The KKT residual at the float32 rounding of a float64 optimum:
        the truth is the float64 value at the same point."""
        n, mi = 16, 6
        raw = problem(n, mi)
        s64 = solver(n, mi, torch.float64, tol=1e-11, max_iter=60)
        r64 = s64.solve(data_of(raw, torch.float64))
        assert bool(r64.converged)
        vars32 = tuple(batched(r64.variables[v.name].float())
                       for v in s64.full.variables)
        data32 = batched(data_of(raw, torch.float32))

        env64 = s64._env(data32.to(dtype=torch.float64),
                         tuple(v.double() for v in vars32), 0.0)
        res_true = float(s64._metrics(env64, 1)[0])
        s32p = solver(n, mi)
        env32 = s32p._env(data32, vars32, 0.0)
        res_plain = float(s32p._metrics(env32, 1)[0])
        s32d = solver(n, mi, df_residuals=True)
        res_df = float(s32d._metrics(s32d._lift(env32), 1)[0])

        assert abs(res_df - res_true) <= 2e-2 * res_true + 1e-9
        assert abs(res_plain - res_true) > 5 * abs(res_df - res_true)

    def test_df_gap_matches(self):
        n, mi = 12, 4
        data = batched(data_of(problem(n, mi, seed=3), torch.float32))
        s = solver(n, mi)
        sd = solver(n, mi, df_residuals=True)
        st = s._init_batch(data)
        env = s._env(data, st.vars, 0.0)
        g_plain = float(s._metrics(env, 1)[1])
        g_df = float(sd._metrics(sd._lift(env), 1)[1])
        assert abs(g_plain - g_df) <= 1e-5 * max(abs(g_plain), 1.0)


class TestDFSolver:
    def test_eager_steps_converge(self):
        n, mi = 8, 3
        data = data_of(problem(n, mi, seed=5), torch.float32)
        s = solver(n, mi, tol=1e-6, df_residuals=True)
        st = s.init_state(data)
        for _ in range(25):
            if float(st.residual) < 1e-6 and float(st.gap) < 1e-6:
                break
            st = s.step(st, data)
        assert float(st.residual) < 1e-6 and float(st.gap) < 1e-6
        assert st.residual.dtype == torch.float32

    def test_eager_steps_match_plain_early(self):
        n, mi = 8, 3
        data = data_of(problem(n, mi, seed=6), torch.float32)
        s, sd = solver(n, mi), solver(n, mi, df_residuals=True)
        st, std = s.init_state(data), sd.init_state(data)
        for _ in range(3):
            st, std = s.step(st, data), sd.step(std, data)
        for a, b in zip(st.vars, std.vars):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-5)

    @pytest.mark.parametrize("settings,gondzio,taylor", [
        (Settings(), 0, "staged"),
        (Settings(inequality_handling=InequalityHandling.SLACKS), 1,
         "symbolic")])
    def test_steps_match_reference(self, settings, gondzio, taylor):
        """Three float32 steps of the port's df_residuals against the
        reference's pair residuals (its Gondzio trials and its symbolic
        corrector in the second case)."""
        n, mi = 8, 3
        raw = problem(n, mi, seed=6)
        kw = dict(df_residuals=True, gondzio=gondzio, taylor=taylor)
        ref = RefIPM(settings, n=n, m_ineq=mi, dtype=jnp.float32, **kw)
        port = solver(n, mi, settings=settings, **kw)
        rdata = RefQPData.make(**raw, dtype=jnp.float32)
        data = data_of(raw, torch.float32)
        r, p = ref.init_state(rdata), port.init_state(data)
        for _ in range(3):
            r, p = ref._step_impl(r, rdata), port.step(p, data)
        for a, b in zip(r.vars, p.vars):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-4,
                                       atol=2e-5)


@pytest.mark.parametrize("kernel", ["ldlt", "block", "blockg", "regldlt"])
def test_hybrid_refine_matches_reference(kernel):
    """float32, refine=2, hybrid_refine: the port's float64 residual
    against the reference's compensated one, per kernel mode."""
    B, n, mi = 8, 8, 4
    rng = np.random.default_rng(7)
    Mx = rng.normal(size=(B, n, n))
    raw = dict(Q=np.einsum("bij,bkj->bik", Mx, Mx) / n + np.eye(n),
               c=rng.normal(size=(B, n)), A_ineq=rng.normal(size=(B, mi, n)),
               l_A_ineq=-np.abs(rng.normal(size=(B, mi))) - 1,
               u_A_ineq=np.abs(rng.normal(size=(B, mi))) + 1,
               l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0))
    kw = dict(tol=1e-5, refine=2, hybrid_refine=True, kernel=kernel)
    ref = RefIPM(Settings(), n=n, m_ineq=mi, dtype=jnp.float32,
                 **kw).solve_batch(RefQPData.make(**raw, dtype=jnp.float32))
    port = solver(n, mi, **kw).solve_batch(data_of(raw, torch.float32))
    np.testing.assert_array_equal(port.converged.numpy(),
                                  np.asarray(ref.converged))
    # 'regldlt' on this quasi-definite class converges 2 of 8 in float32
    # on both sides (its eps^(2/3) shift stalls the rest near 1e-5)
    assert int(port.converged.sum()) >= (2 if kernel == "regldlt" else B)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-5)
    assert np.abs(port.iterations.numpy() -
                  np.asarray(ref.iterations)).max() <= 2
