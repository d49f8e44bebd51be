"""Plain batched LDL^T of the port (ipmzoo_tpu_torch/ops/ldlt.py, the CPU
twins of CUDA kernels K2/K3/K4/K5) against the reference's Pallas kernels
(run in interpret mode on the CPU) and its jnp column kernel, in float64.

Tolerance: rtol 1e-12 (with atol 1e-12 for the exact zeros above the
diagonal); the algorithms are the same, only summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.ops.ldlt import batched_ldlt
from ipmzoo_tpu.ops.pallas_ldlt import (batched_ldlt_pallas,
                                        batched_ldlt_solve_matrix_pallas,
                                        batched_solve_ldlt_matrix_pallas,
                                        batched_solve_ldlt_pallas)
from ipmzoo_tpu.parallel.schur import _ldlt_solve_batched_mat
from ipmzoo_tpu_torch.ops import cuda_ldlt
from ipmzoo_tpu_torch.ops.ldlt import (PIVOT_FLOOR, ldlt,
                                       ldlt_solve_matrix, solve_ldlt,
                                       solve_ldlt_matrix)


def quasi_definite(B, n, seed):
    """Well-conditioned symmetric quasi-definite matrices
    [[H, A^T], [A, -C]] with H, C positive definite, as the IPM's
    augmented systems; ``n`` rows in all."""
    rng = np.random.default_rng(seed)
    n1 = (n + 1) // 2
    n2 = n - n1
    M = rng.normal(size=(B, n1, n1))
    H = np.einsum("bij,bkj->bik", M, M) / n1 + np.eye(n1)
    A = rng.normal(size=(B, n2, n1))
    C = np.abs(rng.normal(size=(B, n2))) + 0.5
    K = np.zeros((B, n, n))
    K[:, :n1, :n1] = H
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = np.swapaxes(A, 1, 2)
    K[:, n1:, n1:] = -np.einsum("bi,ij->bij", C, np.eye(n2))
    return K, rng.normal(size=(B, n))


@pytest.mark.parametrize("B", [1, 7, 130])
@pytest.mark.parametrize("n", [1, 5, 24])
def test_factor_and_solve_match_reference(B, n):
    K, b = quasi_definite(B, n, seed=B * 100 + n)
    L_pl, D_pl = batched_ldlt_pallas(jnp.asarray(K), PIVOT_FLOOR)
    L_jnp, D_jnp = batched_ldlt(jnp.asarray(K), PIVOT_FLOOR)
    x_pl = batched_solve_ldlt_pallas(L_pl, D_pl, jnp.asarray(b))

    L, D = ldlt(torch.from_numpy(K), PIVOT_FLOOR)
    x = solve_ldlt(L, D, torch.from_numpy(b))
    for ref in (L_pl, L_jnp):
        np.testing.assert_allclose(L.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    for ref in (D_pl, D_jnp):
        np.testing.assert_allclose(D.numpy(), np.asarray(ref), rtol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_pl), rtol=1e-12,
                               atol=1e-12)
    # and the factors really solve the system
    np.testing.assert_allclose(np.einsum("bij,bj->bi", K, x.numpy()), b,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("n", [1, 13, 64])
def test_multi_rhs_solve_matches_reference(n, k):
    B = 6
    K, _ = quasi_definite(B, n, seed=n * 100 + k)
    R = np.random.default_rng(k).normal(size=(B, n, k))
    L, D = ldlt(torch.from_numpy(K), PIVOT_FLOOR)
    X = solve_ldlt_matrix(L, D, torch.from_numpy(R)).numpy()
    Lj, Dj = jnp.asarray(L.numpy()), jnp.asarray(D.numpy())
    for ref in (batched_solve_ldlt_matrix_pallas(Lj, Dj, jnp.asarray(R)),
                _ldlt_solve_batched_mat(Lj, Dj, jnp.asarray(R))):
        np.testing.assert_allclose(X, np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    # each column is the single-rhs solve of that column
    for c in range(k):
        np.testing.assert_allclose(
            X[:, :, c], solve_ldlt(L, D, torch.from_numpy(R[:, :, c])),
            rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", K, X), R,
                               rtol=1e-9, atol=1e-9)


def test_exact_zero_pivot_takes_the_floor():
    # second pivot: 1 - 1*1*1 == 0 exactly
    K = np.array([[[1.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 2.0]]])
    L_pl, D_pl = batched_ldlt_pallas(jnp.asarray(K), PIVOT_FLOOR)
    L, D = ldlt(torch.from_numpy(K), PIVOT_FLOOR)
    assert D[0, 1].item() == PIVOT_FLOOR == float(D_pl[0, 1])
    np.testing.assert_allclose(L.numpy(), np.asarray(L_pl), rtol=1e-12)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_pl), rtol=1e-12)


def test_only_exact_zero_is_floored():
    # a pivot far below the floor, but not zero, is kept as it is
    K = np.array([[[1e-12, 0.0], [0.0, 1.0]]])
    _, D = ldlt(torch.from_numpy(K), PIVOT_FLOOR)
    assert D[0, 0].item() == 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_take_plain_version_on_cpu(dtype):
    K, b = quasi_definite(9, 6, seed=3)
    K_t, b_t = torch.from_numpy(K).to(dtype), torch.from_numpy(b).to(dtype)
    cuda_ldlt.reset_launch_counts()
    L, D = cuda_ldlt.ldlt_auto(K_t)
    x = cuda_ldlt.solve_ldlt_auto(L, D, b_t)
    L0, D0 = ldlt(K_t)
    assert torch.equal(L, L0) and torch.equal(D, D0)
    assert torch.equal(x, solve_ldlt(L0, D0, b_t))
    assert x.dtype == dtype
    assert cuda_ldlt.launches == {"ldlt": 0, "solve_ldlt": 0,
                                 "solve_ldlt_matrix": 0,
                                 "ldlt_solve_matrix": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_multi_rhs_wrapper_takes_plain_version_on_cpu(dtype):
    K, _ = quasi_definite(9, 6, seed=5)
    R = torch.from_numpy(np.random.default_rng(5).normal(size=(9, 6, 4)))
    L, D = ldlt(torch.from_numpy(K).to(dtype))
    cuda_ldlt.reset_launch_counts()
    X = cuda_ldlt.solve_ldlt_matrix_auto(L, D, R.to(dtype))
    assert torch.equal(X, solve_ldlt_matrix(L, D, R.to(dtype)))
    assert X.dtype == dtype and tuple(X.shape) == (9, 6, 4)
    assert cuda_ldlt.launches["solve_ldlt_matrix"] == 0


def test_solve_does_not_write_into_its_inputs():
    K, b = quasi_definite(4, 5, seed=4)
    L, D = ldlt(torch.from_numpy(K))
    b_t = torch.from_numpy(b)
    before = b_t.clone()
    solve_ldlt(L, D, b_t)
    assert torch.equal(b_t, before)
    R = b_t[:, :, None].repeat(1, 1, 3)
    before = R.clone()
    solve_ldlt_matrix(L, D, R)
    assert torch.equal(R, before)


def test_wrappers_reject_other_devices():
    A = torch.zeros((2, 3, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_ldlt.ldlt_auto(A)
    with pytest.raises(ValueError, match="B, n, n"):
        cuda_ldlt.ldlt_auto(torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="device"):
        cuda_ldlt.solve_ldlt_matrix_auto(A, A[:, :, 0],
                                         torch.zeros((2, 3, 2),
                                                     device="meta"))
    with pytest.raises(ValueError, match="B, n, k"):
        cuda_ldlt.solve_ldlt_matrix_auto(A, A[:, :, 0], A[0])


def test_soa_launchers_check_their_inputs_before_launching():
    # the launch wrappers refuse CPU tensors and bad shapes without ever
    # loading the CUDA library
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.factor_soa(torch.zeros((3, 3, 4)))
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_ldlt.factor_soa(torch.zeros((3, 3, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.solve_soa(torch.zeros((3, 3, 4)), torch.zeros((3, 5)),
                            torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ldlt.factor_soa(torch.zeros((4, 3, 3)).permute(1, 2, 0))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.solve_matrix_soa(torch.zeros((3, 3, 4)),
                                   torch.zeros((3, 4)),
                                   torch.zeros((3, 2, 4)))
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.solve_matrix_soa(torch.zeros((3, 3, 4)),
                                   torch.zeros((3, 4)),
                                   torch.zeros((3, 2, 5)))


# ----------------------------------------------------------------------
# K5: fused factor + multi-rhs solve
# ----------------------------------------------------------------------

def _assert_k5_matches(K, R, x_tol=1e-12):
    """The plain K5 against the reference's fused Pallas kernel in
    interpret mode: L, D and X within 1e-12."""
    L_ref, D_ref, X_ref = batched_ldlt_solve_matrix_pallas(
        jnp.asarray(K), jnp.asarray(R), PIVOT_FLOOR)
    L, D, X = ldlt_solve_matrix(torch.from_numpy(K), torch.from_numpy(R))
    assert L.shape == L_ref.shape and D.shape == D_ref.shape
    assert X.shape == X_ref.shape
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_ref), rtol=1e-12)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_ref), rtol=x_tol,
                               atol=x_tol)
    return L, D, X


@pytest.mark.parametrize("B,n,k", [(5, 16, 24), (3, 37, 5), (130, 8, 2)])
def test_fused_factor_solve_matches_reference(B, n, k):
    K, _ = quasi_definite(B, n, seed=B + n + k)
    R = np.random.default_rng(n).normal(size=(B, n, k))
    L, D, X = _assert_k5_matches(K, R)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", K, X.numpy()), R,
                               rtol=1e-9, atol=1e-9)
    # exactly the plain K2 followed by the plain K4
    L2, D2 = ldlt(torch.from_numpy(K), PIVOT_FLOOR)
    assert torch.equal(L, L2) and torch.equal(D, D2)
    assert torch.equal(X, solve_ldlt_matrix(L2, D2, torch.from_numpy(R)))


def test_fused_factor_solve_zero_pivot():
    K = np.array([[[1.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 2.0]]])
    R = np.array([[[1.0, 2.0], [0.5, -1.0], [3.0, 0.25]]])
    # the floored pivot of 1e-8 divides the rhs: X is of order 1e8 and
    # carries the sweeps' rounding differences 1e8-fold, so X is held to
    # 1e-6; L and D stay at 1e-12
    _, D, _ = _assert_k5_matches(K, R, x_tol=1e-6)
    assert D[0, 1].item() == PIVOT_FLOOR


@pytest.mark.parametrize("n,k", [(0, 3), (4, 0), (0, 0)])
def test_fused_factor_solve_empty_edges(n, k):
    B = 3
    K, _ = quasi_definite(B, n, seed=1) if n else (np.zeros((B, 0, 0)), 0)
    R = np.random.default_rng(2).normal(size=(B, n, k))
    L_ref, D_ref, X_ref = batched_ldlt_solve_matrix_pallas(
        jnp.asarray(K), jnp.asarray(R), PIVOT_FLOOR)
    for fn in (ldlt_solve_matrix, cuda_ldlt.ldlt_solve_matrix_auto):
        L, D, X = fn(torch.from_numpy(K), torch.from_numpy(R))
        assert tuple(L.shape) == L_ref.shape == (B, n, n)
        assert tuple(D.shape) == D_ref.shape == (B, n)
        assert tuple(X.shape) == X_ref.shape == (B, n, k)
        np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(D.numpy(), np.asarray(D_ref), rtol=1e-12)
        assert X is not None and np.array_equal(X.numpy(), R)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_wrapper_takes_plain_version_on_cpu(dtype):
    K, _ = quasi_definite(9, 6, seed=5)
    R = torch.from_numpy(np.random.default_rng(5).normal(size=(9, 6, 4)))
    A = torch.from_numpy(K).to(dtype)
    cuda_ldlt.reset_launch_counts()
    L, D, X = cuda_ldlt.ldlt_solve_matrix_auto(A, R.to(dtype))
    L0, D0, X0 = ldlt_solve_matrix(A, R.to(dtype))
    assert torch.equal(L, L0) and torch.equal(D, D0) and torch.equal(X, X0)
    assert X.dtype == dtype
    assert not any(cuda_ldlt.launches.values())


def test_fused_launcher_checks_before_launching():
    # refuses CPU tensors, bad shapes and sizes over its shared-memory cap
    # without ever loading the CUDA library
    A, R = torch.zeros((2, 3, 3)), torch.zeros((2, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.factor_solve_matrix_launch(A, R)
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.factor_solve_matrix_launch(torch.zeros((2, 4, 4)), R)
    with pytest.raises(ValueError, match="device"):
        cuda_ldlt.ldlt_solve_matrix_auto(A.to("meta"), R.to("meta"))
    with pytest.raises(ValueError, match="B, n, k"):
        cuda_ldlt.ldlt_solve_matrix_auto(A, R[0])
    # the cap, in bytes: the panel [A | R], D and one column
    f32, f64 = torch.float32, torch.float64
    assert cuda_ldlt.factor_solve_matrix_bytes(64, 64, f64) == 66560
    assert cuda_ldlt.factor_solve_matrix_fits(64, 64, f64)
    assert cuda_ldlt.factor_solve_matrix_fits(32, 2, f32)
    assert not cuda_ldlt.factor_solve_matrix_fits(328, 1, f32)
    assert cuda_ldlt.K5_SHARED_MEMORY_CAP == 227 * 1024


def test_soa_backed_views_keep_values_and_skip_the_transpose():
    K, _ = quasi_definite(4, 5, seed=8)
    L, D = ldlt(torch.from_numpy(K))
    Ls, Ds = cuda_ldlt.soa_backed(L, D)
    assert torch.equal(Ls, L) and torch.equal(Ds, D)
    assert Ls.permute(1, 2, 0).is_contiguous() and Ds.t().is_contiguous()
