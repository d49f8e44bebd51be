"""The port's one-call solves ``ops.ldlt_solve`` / ``ops.cholesky_solve``
and the names ``ipmzoo_tpu_torch.ops`` exports, mirroring the cases of
tests/test_ldlt.py for the two solves (float64, against the JAX
package's functions on the same inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

import ipmzoo_tpu.ops as ref_ops
import ipmzoo_tpu_torch.ops as ops
from ipmzoo_tpu.ops import cholesky_solve as ref_cholesky_solve
from ipmzoo_tpu.ops import ldlt_solve as ref_ldlt_solve
from ipmzoo_tpu_torch.ops import cholesky_solve, ldlt_solve


def quasidefinite(n1, n2, seed):
    """tests/test_ldlt.py's symmetric quasi-definite [[H, A^T], [A, -S]]."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n1, n1))
    H = H @ H.T + n1 * np.eye(n1)
    S = rng.normal(size=(n2, n2))
    S = S @ S.T + n2 * np.eye(n2)
    A = rng.normal(size=(n2, n1))
    return np.block([[H, A.T], [A, -S]])


@pytest.mark.parametrize("n1,n2", [(5, 3), (20, 11)])
def test_solve(n1, n2):
    n = n1 + n2
    A = quasidefinite(n1, n2, seed=7 * n)
    b = np.random.default_rng(1).normal(size=n)
    x = ldlt_solve(torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_allclose(A @ x, b, rtol=1e-8, atol=1e-8)
    xr = np.asarray(ref_ldlt_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, xr, rtol=1e-12, atol=1e-12)


def test_solve_batch():
    A = np.stack([quasidefinite(6, 3, seed=s) for s in range(4)])
    b = np.random.default_rng(0).normal(size=(4, 9))
    x = ldlt_solve(torch.tensor(A), torch.tensor(b)).numpy()
    for s in range(4):
        xr = np.asarray(ref_ldlt_solve(jnp.asarray(A[s]), jnp.asarray(b[s])))
        np.testing.assert_allclose(x[s], xr, rtol=1e-12, atol=1e-12)


def test_zero_pivot_floor():
    # a singular matrix: the zero pivot is floored, not NaN
    A = np.zeros((3, 3))
    b = np.ones(3)
    x = ldlt_solve(torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_array_equal(x, np.full(3, 1e8))
    xr = np.asarray(ref_ldlt_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_array_equal(x, xr)
    # another floor
    x = ldlt_solve(torch.tensor(A), torch.tensor(b), pivot_floor=0.5)
    np.testing.assert_array_equal(x.numpy(), np.full(3, 2.0))


def test_empty():
    A, b = torch.zeros((0, 0), dtype=torch.float64), torch.zeros(0)
    assert ldlt_solve(A, b).shape == (0,)
    assert cholesky_solve(A, b.double()).shape == (0,)
    assert np.asarray(ref_ldlt_solve(jnp.zeros((0, 0)),
                                     jnp.zeros((0,)))).shape == (0,)


def test_cholesky_solve_spd():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(12, 12))
    A = M @ M.T + 12 * np.eye(12)
    b = rng.normal(size=12)
    x = cholesky_solve(torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_allclose(A @ x, b, rtol=1e-8, atol=1e-8)
    xr = np.asarray(ref_cholesky_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, xr, rtol=1e-12, atol=1e-12)


def test_cholesky_solve_not_positive_definite_is_nan():
    A = -np.eye(3)
    b = np.ones(3)
    x = cholesky_solve(torch.tensor(A), torch.tensor(b)).numpy()
    xr = np.asarray(ref_cholesky_solve(jnp.asarray(A), jnp.asarray(b)))
    assert np.isnan(x).all() and np.isnan(xr).all()


@pytest.mark.parametrize("fn", [ldlt_solve, cholesky_solve])
def test_shapes_that_do_not_pair_raise(fn):
    with pytest.raises(ValueError, match="expected A"):
        fn(torch.eye(3, dtype=torch.float64), torch.ones(4,
                                                          dtype=torch.float64))


def test_exports_follow_the_reference():
    # the reference's names, less its Pallas entry points (the port's
    # kernels sit behind the *_auto functions) and the double-single
    # functions (backed by float64 in the port), plus the port's own
    mine = set(ops.__all__)
    ref = set(ref_ops.__all__)
    left_out = {n for n in ref if n.endswith(("_df", "_pallas"))} | \
        {"batched_ldlt", "batched_solve_ldlt"}
    assert ref - left_out <= mine
    assert mine - ref == {"ldlt_auto", "solve_ldlt_auto", "launches",
                          "reset_launch_counts"}
    for name in mine:
        assert callable(getattr(ops, name)) or name in ("PIVOT_FLOOR",
                                                        "launches")
