"""The port's precision options, backed by float64 where the reference
computes in double-single (hi, lo) pairs, against the JAX package on the
CPU.

The floor table of tests/test_precision_floor.py, on the same QP class
(48 random SPD box QPs with two-sided inequalities, n=16, m=8, numpy seed
0); tests/test_torch_precision_floor.py holds the plain rows (float64 at
1e-8, float32 at 1e-6 with and without gondzio=2, float32's floor at
3e-7), this file the option rows:

| dtype | options                  | achievable tol | not achievable |
|-------|--------------------------|----------------|----------------|
| f32   | hybrid_refine, refine=2  | 1e-6           | 3e-7           |
| f32   | df_residuals             | 1e-6 on 47/48  |                |
| f32   | two_float                | 1e-8 (parity)  | (1e-10 on row 0)|

No row diverges.  The df_residuals row is the reference's own: its
eager iteration stalls on instance 21 at residual 1.024e-6 as the port's
does.

``two_float`` runs the iteration on a float64 solver with the scalars
(mu, the step lengths, residual, gap) in float32 as the reference keeps
them beside its pairs, so one instance's ``init_state`` and three steps
agree with the reference's eager ``_step_impl`` to 1e-9 relative, mu
too (the reference's pair pipeline is run eagerly: XLA's CPU compile of
it is pathologically slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.formulations import InequalityHandling, Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu_torch import CompiledIPM, QPData
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings

B, N, M = 48, 16, 8


@pytest.fixture(scope="module")
def qp_batch():
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, N, N)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / N + \
        np.eye(N, dtype=np.float32)
    return dict(
        Q=Q, c=rng.normal(size=(B, N)),
        A_ineq=rng.normal(size=(B, M, N)),
        l_A_ineq=-np.abs(rng.normal(size=(B, M))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, M))) + 1,
        l_x=np.full((B, N), -5.0), u_x=np.full((B, N), 5.0))


def row(qp, i, dtype=torch.float32):
    return QPData.make(**{k: v[i] for k, v in qp.items()}, dtype=dtype,
                       device="cpu")


def ref_row(qp, i, dtype=jnp.float32):
    return RefQPData.make(**{k: v[i] for k, v in qp.items()}, dtype=dtype)


def solver(tol, settings=Settings(), **opts):
    return CompiledIPM(port_settings(settings), n=N, m_ineq=M,
                       dtype=torch.float32, tol=tol, device="cpu", **opts)


def conv(qp, tol, **opts):
    res = solver(tol, **opts).solve_batch(
        QPData.make(**qp, dtype=torch.float32, device="cpu"))
    assert not bool(res.diverged.any()), "divergence rollback tripped"
    return res.converged


@pytest.mark.parametrize("tol,share", [(1e-6, 1.0), (3e-7, 0.0)])
def test_hybrid_refine_rows(qp_batch, tol, share):
    """f32 with refine=2, hybrid_refine: 1e-6 reached, 3e-7 below the
    float32 factorisation floor (the reference pins < 0.5)."""
    got = conv(qp_batch, tol, refine=2, hybrid_refine=True)
    assert got.double().mean().item() == share


def test_df_residuals_row(qp_batch):
    got = conv(qp_batch, 1e-6, df_residuals=True)
    assert torch.nonzero(~got).flatten().tolist() == [21]


def eager(data, tol, max_iter=30, **opts):
    """``init_state`` and ``step`` of one instance until it converges."""
    s = solver(tol, two_float=True, **opts)
    st = s.init_state(data)
    for _ in range(max_iter):
        if float(st.residual) < tol and float(st.gap) < tol:
            break
        st = s.step(st, data)
    return st, s


@pytest.fixture(scope="module")
def f64_rows(qp_batch):
    """x of rows 0-2 by the port's and the reference's float64 solves of
    the float32 data."""
    sub = {k: v[:3].astype(np.float32) for k, v in qp_batch.items()}
    port = CompiledIPM(port_settings(Settings()), n=N, m_ineq=M, tol=1e-8,
                       device="cpu").solve_batch(
        QPData.make(**sub, device="cpu"))
    ref = RefIPM(Settings(), n=N, m_ineq=M, dtype=jnp.float64,
                 tol=1e-8).solve_batch(RefQPData.make(**sub))
    assert bool(port.converged.all()) and bool(np.all(ref.converged))
    return port.x.numpy(), np.asarray(ref.x)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_two_float_reaches_parity(qp_batch, f64_rows, i):
    """Rows 0-2 at 1e-8 from float32 data, x within 1e-9 of the port's
    and the reference's float64 solves."""
    st, s = eager(row(qp_batch, i), 1e-8)
    assert float(st.residual) < 1e-8 and float(st.gap) < 1e-8
    x = st.vars[s.var_index[s.symbols.x]].numpy()
    assert np.abs(x - f64_rows[0][i]).max() < 1e-9
    assert np.abs(x - f64_rows[1][i]).max() < 1e-9


def test_two_float_beyond_parity(qp_batch):
    st, _ = eager(row(qp_batch, 0), 1e-10, max_iter=35)
    assert float(st.residual) < 1e-10 and float(st.gap) < 1e-10


def test_two_float_batch_reaches_parity(qp_batch):
    assert conv(qp_batch, 1e-8, two_float=True).all()


@pytest.mark.parametrize("settings,gondzio", [
    (Settings(), 0),
    (Settings(inequality_handling=InequalityHandling.SLACKS), 1)])
def test_two_float_steps_match_reference_pairs(qp_batch, settings, gondzio):
    """init_state and three steps of instance 0 against the reference's
    eager pair iteration: the port's float64 fields against hi + lo, mu,
    residual and gap within 1e-9 relative (the box ratio test of Slacks
    handling and a Gondzio round included in the second case)."""
    ref = RefIPM(settings, n=N, m_ineq=M, dtype=jnp.float32, tol=1e-8,
                 two_float=True, gondzio=gondzio)
    port = solver(1e-8, settings, two_float=True, gondzio=gondzio)
    rdata, data = ref_row(qp_batch, 0), row(qp_batch, 0)
    r, p = ref.init_state(rdata), port.init_state(data)
    for k in range(4):
        for a, b in zip(r.vars, p.vars):
            assert b.dtype == torch.float64
            want = np.asarray(a[0], np.float64) + np.asarray(a[1], np.float64)
            np.testing.assert_allclose(b.numpy(), want, rtol=1e-9,
                                       atol=1e-9 * np.abs(want).max())
        for f in ("mu", "residual", "gap"):
            np.testing.assert_allclose(float(getattr(p, f)),
                                       float(getattr(r, f)), rtol=1e-9)
        if k < 3:
            r, p = ref._step_impl(r, rdata), port.step(p, data)


def test_two_float_dtypes(qp_batch):
    """SolveResult in the working dtype from every entry point, the
    states float64; a warm start from a result takes fewer iterations."""
    s = solver(1e-8, two_float=True)
    batch = QPData.make(**{k: v[:4] for k, v in qp_batch.items()},
                        dtype=torch.float32, device="cpu")
    one = row(qp_batch, 0)
    results = [s.solve(one), s.solve_batch(batch),
               s.solve_batch_compact(batch)]
    for res in results:
        for f in ("x", "objective", "residual", "gap"):
            assert getattr(res, f).dtype == torch.float32, f
        assert all(v.dtype == torch.float32
                   for v in res.variables.values())
        assert res.iterations.dtype == torch.int32
        assert res.converged.dtype == res.diverged.dtype == torch.bool
        assert bool(res.converged.all())
    for st in (s.init_state(one), s.step(s.init_state(batch), batch)):
        assert all(v.dtype == torch.float64 for v in st.vars)
        assert st.mu.dtype == st.residual.dtype == torch.float64
    warm = s.solve(one, warm_start=results[0].variables)
    assert bool(warm.converged)
    assert int(warm.iterations) < int(results[0].iterations)
    assert s.host_syncs > 0 and s._tf.host_syncs == s.host_syncs


@pytest.mark.parametrize("kernel", ["jnp", "block", "blockg", "lu",
                                    "regldlt", "normal", "sharded", "nd"])
def test_two_float_refuses_kernel(kernel):
    """Each kernel the reference refuses under two_float."""
    with pytest.raises(ValueError, match="two_float"):
        RefIPM(Settings(), n=4, m_ineq=2, two_float=True, kernel=kernel)
    with pytest.raises(ValueError, match="two_float"):
        CompiledIPM(port_settings(Settings()), 4, 2, two_float=True,
                    kernel=kernel, device="cpu")


def test_normal_refuses_df_residuals():
    with pytest.raises(NotImplementedError, match="kernel='normal'"):
        RefIPM(Settings(), n=4, m_ineq=2, df_residuals=True,
               kernel="normal")
    with pytest.raises(NotImplementedError, match="kernel='normal'"):
        CompiledIPM(port_settings(Settings()), 4, 2, df_residuals=True,
                    kernel="normal", device="cpu")


def test_two_float_implies_df_residuals():
    s = solver(1e-8, two_float=True)
    assert s.df_residuals and s._mode == "tf"
    assert s._tf.dtype == torch.float64 and s._tf._mode == "ldlt"
    assert s.mu_floor == s._tf.mu_floor == np.finfo(np.float32).eps ** 2


def test_two_float_no_escalation(qp_batch):
    """esc_cap='auto' is 0 under two_float (32 for plain float32 at the
    same tolerance) and no escalation twin is built."""
    s = solver(1e-8, two_float=True)
    assert s._auto_esc_cap() == 0 and solver(1e-8)._auto_esc_cap() == 32
    res = s.solve_batch_compact(
        QPData.make(**qp_batch, dtype=torch.float32, device="cpu"))
    assert bool(res.converged.all())
    assert not hasattr(s, "_esc_twin") and not hasattr(s._tf, "_esc_twin")
    assert int(s.escalated) == 0
    assert s._escalation_twin() is s._tf
