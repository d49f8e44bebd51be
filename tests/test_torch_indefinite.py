"""Genuinely indefinite augmented systems in the port's CompiledIPM
(EqualityHandling.NONE keeps a zero dual diagonal block): the signed
regularised LDL^T ('regldlt', what 'auto' picks) and the pivoted LU
('lu'), on the CPU in float64, against the JAX package's same modes on
the same numpy inputs (tests/test_ipm.py::TestIndefiniteSystems,
tests/test_families.py's equality_qp).

Tolerances: iterations equal and x within 1e-8 of the reference's same
mode; the reference test's own limits for the KKT residuals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import Bounds, EqualityHandling, Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu_torch.models import CompiledIPM, QPData
from ipmzoo_tpu_torch.models.convert import qpdata_from_numpy
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings

SETTINGS = Settings(inequalities=Bounds.NONE, variable_bounds=Bounds.NONE,
                    equalities=True, equality_handling=EqualityHandling.NONE)


def port(n, m_eq, **kw):
    return CompiledIPM(port_settings(SETTINGS), n, 0, m_eq, device="cpu",
                       **kw)


def eq_qp(n):
    """min 1/2 ||x||^2 - x1  s.t.  sum(x) = 1  ->  x = (1, 0, ..., 0)."""
    return QPData.make(Q=np.eye(n), c=[-1.0] + [0.0] * (n - 1),
                       A_eq=np.ones((1, n)), b_eq=[1.0], device="cpu")


def random_eq(B, n, m, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    return RefQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(B, n)), A_ineq=np.zeros((B, 0, n)),
        l_A_ineq=np.zeros((B, 0)), u_A_ineq=np.zeros((B, 0)),
        A_eq=rng.normal(size=(B, m, n)), b_eq=rng.normal(size=(B, m)),
        l_x=np.zeros((B, n)), u_x=np.zeros((B, n)))


@pytest.mark.parametrize("kernel", ["ldlt", "jnp", "block", "blockg",
                                    "normal", "nd"])
def test_zero_diagonal_refused_by_the_quasi_definite_modes(kernel):
    with pytest.raises(NotImplementedError, match="indefinite"):
        port(3, 1, kernel=kernel)


def test_auto_selects_regldlt():
    s = port(3, 1)
    assert s._mode == "regldlt"
    res = s.solve(eq_qp(3))
    assert bool(res.converged) and not bool(res.diverged)
    np.testing.assert_allclose(res.x.numpy(), [1.0, 0.0, 0.0], atol=1e-9)


def test_lu_solves_equality_qp():
    s = port(3, 1, kernel="lu")
    assert s._mode == "lu"
    res = s.solve(eq_qp(3))
    assert bool(res.converged) and not bool(res.diverged)
    np.testing.assert_allclose(res.x.numpy(), [1.0, 0.0, 0.0], atol=1e-9)


@pytest.mark.parametrize("kernel", ["auto", "regldlt", "lu"])
def test_modes_match_reference(kernel):
    nb = random_eq(4, 6, 2, seed=3)
    ref = RefIPM(SETTINGS, n=6, m_eq=2, kernel=kernel).solve_batch(
        jax.tree_util.tree_map(jnp.asarray, nb))
    res = port(6, 2, kernel=kernel).solve_batch(
        qpdata_from_numpy(nb, device="cpu"))
    assert bool(res.converged.all())
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-8)


def test_regldlt_matches_lu():
    data = qpdata_from_numpy(random_eq(1, 6, 2, seed=3), device="cpu")
    r_reg = port(6, 2).solve_batch(data)
    r_lu = port(6, 2, kernel="lu").solve_batch(data)
    assert bool(r_reg.converged.all()) and bool(r_lu.converged.all())
    np.testing.assert_allclose(r_reg.x.numpy(), r_lu.x.numpy(), rtol=1e-8,
                               atol=1e-8)


def test_regularisation_is_per_instance():
    """delta = eps^(2/3) max(1, max |diag K|) of each instance: scaling one
    instance's data leaves the others' solutions bit for bit."""
    nb = random_eq(3, 5, 2, seed=4)
    data = qpdata_from_numpy(nb, device="cpu")
    r0 = port(5, 2).solve_batch(data)
    data.Q[2] *= 1e4
    r1 = port(5, 2).solve_batch(data)
    assert torch.equal(r0.x[:2], r1.x[:2])
    assert torch.equal(r0.iterations[:2], r1.iterations[:2])


def test_batched_indefinite_solves():
    n, m, batch = 8, 3, 16
    nb = random_eq(batch, n, m, seed=11)
    s = port(n, m)
    assert s._mode == "regldlt"
    res = s.solve_batch(qpdata_from_numpy(nb, device="cpu"))
    assert bool(res.converged.all())
    # KKT check: Q x + c + A^T lam = 0, A x = b
    x = res.x.numpy()
    lam = res.variables["\\lambda_{C}"].numpy()
    r_stat = np.einsum("bij,bj->bi", nb.Q, x) + nb.c + \
        np.einsum("bji,bj->bi", nb.A_eq, lam)
    r_eq = np.einsum("bij,bj->bi", nb.A_eq, x) - nb.b_eq
    assert np.max(np.abs(r_stat)) < 1e-7
    assert np.max(np.abs(r_eq)) < 1e-7


def test_equality_qp_uses_regldlt_and_matches_reference():
    from ipmzoo_tpu.models.families import equality_qp as ref_equality_qp
    from ipmzoo_tpu_torch.models.families import equality_qp
    fam = equality_qp(n=12, m_eq=3, seed=7, device="cpu")
    solver = CompiledIPM(fam.settings, n=fam.n, m_eq=fam.m_eq, device="cpu")
    assert solver._mode == "regldlt"
    res = solver.solve(fam.data)
    assert bool(res.converged)
    viol = fam.data.A_eq.numpy() @ res.x.numpy() - fam.data.b_eq.numpy()
    assert np.max(np.abs(viol)) < 1e-8
    rfam = ref_equality_qp(n=12, m_eq=3, seed=7, dtype=jnp.float64)
    ref = RefIPM(rfam.settings, n=12, m_eq=3).solve(rfam.data)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-8)


def test_escalation_twin_of_an_indefinite_system():
    """The compact engine's float64 twin factors an indefinite system as
    the reference's pair twin does (signed-regularised LDL^T), and
    finishes a float32 batch to the float64 solution."""
    nb = random_eq(4, 6, 2, seed=8)
    s = port(6, 2, dtype=torch.float32, tol=1e-6)
    assert s._escalation_twin()._mode == "regldlt"
    res = s.solve_batch_compact(qpdata_from_numpy(nb, dtype=torch.float32,
                                                  device="cpu"),
                                esc_cap=4)
    want = port(6, 2).solve_batch(qpdata_from_numpy(nb, device="cpu"))
    assert bool(res.converged.all())
    np.testing.assert_allclose(res.x.double().numpy(), want.x.numpy(),
                               atol=1e-4)
