"""QP model families of the port (ipmzoo_tpu_torch/models/families.py):
every generator gives the reference's arrays for the same seed, and the
reference's own family tests (tests/test_families.py) hold on the port,
on the CPU in float64.

The generators draw with numpy in the reference's order, so the data is
compared exactly; solutions are compared with the JAX solver at 1e-8 (the
two run the same iteration on the same data; only summation order
differs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import families as ref_families
from ipmzoo_tpu_torch import CompiledIPM, QPData
from ipmzoo_tpu_torch.models import families
from ipmzoo_tpu_torch.models.convert import (family_from_reference,
                                             qpdata_to_numpy)
from ipmzoo_tpu_torch.models.families import (FAMILIES, arrow_chain,
                                              elastic_net, equality_qp, mpc,
                                              portfolio, projection,
                                              svm_dual)

CPU = dict(dtype=torch.float64, device="cpu")


def _solver(fam, **kw):
    return CompiledIPM(fam.settings, n=fam.n, m_ineq=fam.m_ineq,
                       m_eq=fam.m_eq, dtype=torch.float64, device="cpu",
                       **kw)


def test_family_names_match_reference():
    assert list(FAMILIES) == list(ref_families.FAMILIES)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_generators_give_the_reference_arrays(name, batch):
    ref = ref_families.FAMILIES[name](seed=5, batch=batch,
                                      dtype=jnp.float64)
    fam = FAMILIES[name](seed=5, batch=batch, **CPU)
    assert (fam.name, fam.n, fam.m_ineq, fam.m_eq) == \
        (ref.name, ref.n, ref.m_ineq, ref.m_eq)
    got = qpdata_to_numpy(fam.data)
    for f in dataclasses.fields(QPData):
        want = np.asarray(getattr(ref.data, f.name))
        assert got[f.name].shape == want.shape, f.name
        assert np.array_equal(got[f.name], want), f.name
    # the settings are the port's own class with the reference's values,
    # and the reference's family converts to the same thing
    conv = family_from_reference(ref, **CPU)
    assert conv.settings == fam.settings
    assert type(fam.settings).__module__.startswith("ipmzoo_tpu_torch")
    assert all(torch.equal(getattr(conv.data, f.name),
                           getattr(fam.data, f.name))
               for f in dataclasses.fields(QPData))


def test_float32_data_rounds_as_the_reference():
    ref = ref_families.grid_qp(side=5, seed=2, dtype=jnp.float32)
    fam = families.grid_qp(side=5, seed=2, dtype=torch.float32,
                           device="cpu")
    assert fam.data.Q.dtype == torch.float32
    assert np.array_equal(fam.data.Q.numpy(), np.asarray(ref.data.Q))
    assert np.array_equal(fam.data.c.numpy(), np.asarray(ref.data.c))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_single_instance_solves(name):
    fam = FAMILIES[name](seed=1, **CPU)
    # 'auto' as the reference picks it: 'regldlt' for equality_qp's
    # indefinite system, 'blockg' for grid_qp's aug_dim 576
    solver = _solver(fam, tol=1e-8)
    res = solver.solve(fam.data)
    assert bool(res.converged), name
    assert not bool(res.diverged)
    ref = ref_families.FAMILIES[name](seed=1, dtype=jnp.float64)
    rs = RefIPM(ref.settings, n=ref.n, m_ineq=ref.m_ineq, m_eq=ref.m_eq,
                dtype=jnp.float64, tol=1e-8)
    assert solver._mode == rs._mode
    r = rs.solve(ref.data)
    assert int(res.iterations) == int(r.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(r.x), atol=1e-8)


def test_portfolio_constraints_hold():
    fam = portfolio(n_assets=16, seed=2, **CPU)
    res = _solver(fam).solve(fam.data)
    w = res.x.numpy()
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-6)
    assert (w >= -1e-8).all() and (w <= 0.2 + 1e-7).all()


def test_mpc_rate_limits_hold():
    fam = mpc(horizon=5, seed=3, **CPU)
    res = _solver(fam).solve(fam.data)
    u = res.x.numpy()
    du = fam.data.A_ineq.numpy() @ u
    assert (np.abs(u) <= 1.0 + 1e-7).all()
    assert (du <= 0.5 + 1e-7).all() and (du >= -0.5 - 1e-7).all()


def test_svm_dual_box():
    fam = svm_dual(n_samples=24, seed=4, **CPU)
    res = _solver(fam).solve(fam.data)
    a = res.x.numpy()
    assert (a >= -1e-8).all() and (a <= 1.0 + 1e-7).all()


def test_projection_matches_scipy():
    from scipy import optimize
    fam = projection(n=10, m=4, seed=5, **CPU)
    res = _solver(fam).solve(fam.data)
    d = qpdata_to_numpy(fam.data)
    cons = optimize.LinearConstraint(d["A_ineq"], d["l_A_ineq"],
                                     d["u_A_ineq"])
    p = -d["c"]
    out = optimize.minimize(
        lambda x: 0.5 * x @ x - p @ x, np.zeros(fam.n),
        jac=lambda x: x - p,
        bounds=optimize.Bounds(d["l_x"], d["u_x"]),
        constraints=[cons], method="SLSQP",
        options={"ftol": 1e-14, "maxiter": 500})
    assert out.success
    np.testing.assert_allclose(res.x.numpy(), out.x, atol=1e-6)


def test_batched_family_solve():
    fam = svm_dual(n_samples=12, batch=6, seed=6, **CPU)
    res = _solver(fam).solve_batch(fam.data)
    assert bool(res.converged.all())
    assert tuple(res.x.shape) == (6, 12)


def test_elastic_net_matches_sklearn_like_oracle():
    """The split-QP solution reconstructs the elastic-net coefficients:
    verify the KKT subgradient conditions of the original problem."""
    fam = elastic_net(n_features=8, n_samples=32, lam1=0.2, lam2=0.1,
                      seed=6, **CPU)
    res = _solver(fam).solve(fam.data)
    assert bool(res.converged)
    uv = res.x.numpy()
    nf = fam.n // 2
    w = uv[:nf] - uv[nf:]
    # rebuild A, y from the generator for the subgradient check
    rng = np.random.default_rng(6)
    A = rng.normal(size=(32, 8))
    w_true = rng.normal(size=8) * (rng.uniform(size=8) < 0.3)
    y = A @ w_true + 0.01 * rng.normal(size=32)
    g = A.T @ (A @ w - y) + 0.1 * w      # smooth part gradient
    # subgradient optimality: |g| <= lam1, equality where w != 0
    assert (np.abs(g) <= 0.2 + 1e-6).all()
    active = np.abs(w) > 1e-4
    np.testing.assert_allclose(g[active], -0.2 * np.sign(w[active]),
                               atol=1e-6)


def test_equality_qp_solves_through_regldlt():
    # the reference solves this family with kernel='regldlt'; so does the
    # port's 'auto', and 'lu' gives the same x
    fam = equality_qp(n=12, m_eq=3, seed=7, **CPU)
    assert (fam.m_eq, tuple(fam.data.A_eq.shape)) == (3, (3, 12))
    s = _solver(fam)
    assert s._mode == "regldlt"
    res = s.solve(fam.data)
    lu = _solver(fam, kernel="lu").solve(fam.data)
    assert bool(res.converged) and bool(lu.converged)
    np.testing.assert_allclose(res.x.numpy(), lu.x.numpy(), atol=1e-8)


def test_arrow_chain_detector_and_structured_solver():
    from ipmzoo_tpu_torch import ArrowIPM, ArrowQPData
    fam = arrow_chain(n=60, bandwidth=4, tip=4, seed=8, **CPU)
    d = qpdata_to_numpy(fam.data)
    sdata, st, blk = ArrowQPData.from_dense(d["Q"], d["c"], d["l_x"],
                                            d["u_x"], device="cpu")
    assert st.bandwidth == 4 and st.tip == 4
    ares = ArrowIPM.for_data(sdata, structure=st).solve(sdata)
    dres = _solver(fam).solve(fam.data)
    assert bool(ares.converged) and bool(dres.converged)
    np.testing.assert_allclose(ares.x.numpy(), dres.x.numpy(), atol=1e-7)
