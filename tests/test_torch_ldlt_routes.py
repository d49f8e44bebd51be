"""The second routes of K2 (block per matrix) and K5 (warp per matrix; the
third, the split route, in test_torch_k5_split_route.py) in
ipmzoo_tpu_torch/ops/cuda_ldlt.py, on the CPU: the route rules as pure
functions pinned at the shapes the port's paths give the kernels, the
shared-memory byte counts, the launchers' refusals before the CUDA
library is loaded, the wrappers' plain versions on CPU tensors, and the
plain versions against the reference's Pallas kernels (interpret mode)
at the new routes' shapes in float64.

Tolerance: rtol 1e-12 (atol 1e-12 for the exact zeros above the
diagonal), as in test_torch_ldlt.py: the algorithms are the same, only
summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.ops.pallas_ldlt import (batched_ldlt_pallas,
                                        batched_ldlt_solve_matrix_pallas)
from ipmzoo_tpu_torch.ops import cuda_ldlt
from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR, ldlt, ldlt_solve_matrix

f32, f64 = torch.float32, torch.float64


def quasi_definite(B, n, seed):
    """Symmetric quasi-definite [[H, A^T], [A, -C]], H and C positive
    definite, as the IPM's augmented systems."""
    rng = np.random.default_rng(seed)
    n1 = (n + 1) // 2
    n2 = n - n1
    M = rng.normal(size=(B, n1, n1))
    K = np.zeros((B, n, n))
    K[:, :n1, :n1] = np.einsum("bij,bkj->bik", M, M) / n1 + np.eye(n1)
    A = rng.normal(size=(B, n2, n1))
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = np.swapaxes(A, 1, 2)
    K[:, n1:, n1:] = -np.einsum("bi,ij->bij",
                                np.abs(rng.normal(size=(B, n2))) + 0.5,
                                np.eye(n2))
    return K


# ----------------------------------------------------------------------
# the route rules
# ----------------------------------------------------------------------

#: (B, n, k, dtype) -> K5 route at every shape the paths give K5: the nd
#: slice's three levels (one instance and the batch of 8), bench_kkt's
#: point, the odd shape of chip_smoke, and the nd generic top over the cap
K5_PATH_ROUTES = [
    ((105, 64, 40, f32), "split"), ((105, 64, 40, f64), "split"),
    ((28, 16, 48, f32), "split"), ((16, 16, 64, f32), "split"),
    ((840, 64, 40, f32), "split"), ((224, 16, 48, f32), "split"),
    ((128, 16, 64, f32), "split"),
    ((10240, 32, 2, f32), "warp"), ((10240, 32, 2, f64), "split"),
    ((3, 37, 5, f32), "split"),
    ((1, 328, 1, f32), "k2+k4"), ((1, 328, 1, f64), "k2+k4"),
]

#: (n, B, dtype) -> K2 route at every shape the paths give K2: the
#: compact slice's batches and its float64 escalation of <= 32
#: stragglers, the Schur slice's H blocks (f64 and plain f32) and S, and
#: the nd generic top (over the block route's shared memory)
K2_PATH_ROUTES = [
    ((24, 10240, f32), "block"), ((24, 2560, f32), "block"),
    ((24, 320, f32), "block"), ((24, 32, f64), "block"),
    ((24, 1, f64), "block"),
    ((64, 512, f64), "block"), ((64, 512, f32), "block"),
    ((16, 8, f64), "block"), ((16, 8, f32), "block"),
    ((328, 1, f64), "soa"), ((328, 1, f32), "soa"),
]


@pytest.mark.parametrize("shape,route", K5_PATH_ROUTES,
                         ids=[str(s) for s, _ in K5_PATH_ROUTES])
def test_k5_route_at_path_shapes(shape, route):
    assert cuda_ldlt.k5_route(*shape) == route


@pytest.mark.parametrize("shape,route", K2_PATH_ROUTES,
                         ids=[str(s) for s, _ in K2_PATH_ROUTES])
def test_k2_route_at_path_shapes(shape, route):
    assert cuda_ldlt.k2_route(*shape) == route


@pytest.mark.parametrize("dtype", [f32, f64])
def test_routes_never_exceed_what_a_route_holds(dtype):
    # never an order above the warp route's largest instantiation to it,
    # never a size over the shared-memory cap to a block route
    for n in list(range(1, 70)) + [100, 168, 169, 170, 240, 241, 328, 500]:
        for k in (1, 2, 3, 8, 9, 40, 64, 200):
            for B in (1, 8, 512, 10240):
                r = cuda_ldlt.k5_route(B, n, k, dtype)
                assert r in ("warp", "split", "block", "k2+k4")
                if r == "warp":
                    # a warp walks its columns in chunks: at batches of
                    # up to a level's few hundred systems it takes at most
                    # 4 right-hand sides (the split route spreads more)
                    assert n <= cuda_ldlt.K5_WARP_MAX_ORDER == 32
                    assert B > 264 or k <= 4
                if r == "split":
                    assert cuda_ldlt.k5_split_shape(B, n, k, dtype) \
                        is not None
                if r == "block":
                    assert cuda_ldlt.factor_solve_matrix_fits(n, k, dtype)
                if r == "k2+k4":
                    assert not cuda_ldlt.factor_solve_matrix_fits(n, k,
                                                                  dtype)
                    assert cuda_ldlt.k5_split_shape(B, n, k, dtype) is None
        for B in (1, 8, 32, 320, 512, 2560, 10240):
            r = cuda_ldlt.k2_route(n, B, dtype)
            assert r in ("soa", "block")
            if r == "block":
                assert cuda_ldlt.factor_block_fits(n, dtype)


# ----------------------------------------------------------------------
# shared memory
# ----------------------------------------------------------------------

def test_block_route_bytes_and_cap():
    assert cuda_ldlt.factor_block_bytes(64, f64) == (64 * 64 + 128) * 8
    assert cuda_ldlt.factor_block_bytes(64, f32) == (64 * 64 + 128) * 4
    # the largest orders one block holds: 169 in float64, 240 in float32
    assert cuda_ldlt.factor_block_fits(169, f64)
    assert not cuda_ldlt.factor_block_fits(170, f64)
    assert cuda_ldlt.factor_block_fits(240, f32)
    assert not cuda_ldlt.factor_block_fits(241, f32)
    # the block route needs less than K5's panel with its k columns
    for n in (16, 64, 100):
        assert cuda_ldlt.factor_block_bytes(n, f64) < \
            cuda_ldlt.factor_solve_matrix_bytes(n, 1, f64)


def test_warp_route_bytes_stay_under_static_shared_memory():
    # four warps a block; per matrix the factor at row stride NP + 1 and a
    # chunk of KP = 2 or 8 columns at stride KP + 1; 32 / NP matrices a warp
    assert cuda_ldlt.factor_solve_matrix_warp_bytes(32, 2, f32) == \
        4 * (32 * 33 + 32 * 3) * 4
    assert cuda_ldlt.factor_solve_matrix_warp_bytes(32, 8, f64) == \
        4 * (32 * 33 + 32 * 9) * 8
    assert cuda_ldlt.factor_solve_matrix_warp_bytes(5, 1, f32) == \
        4 * 4 * (8 * 9 + 8 * 3) * 4
    assert cuda_ldlt.factor_solve_matrix_warp_bytes(13, 40, f64) == \
        4 * 2 * (16 * 17 + 16 * 9) * 8
    for dtype in (f32, f64):
        for n in range(1, 33):
            for k in (1, 2, 3, 8, 64, 1000):
                assert cuda_ldlt.factor_solve_matrix_warp_bytes(
                    n, k, dtype) <= 48 * 1024


# ----------------------------------------------------------------------
# the launchers refuse before the CUDA library is loaded
# ----------------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    def boom():
        raise AssertionError("the CUDA library was loaded")
    monkeypatch.setattr(cuda_ldlt, "_lib", boom)


def test_warp_launcher_checks_before_launching(no_library):
    A, R = torch.zeros((2, 3, 3)), torch.zeros((2, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.factor_solve_matrix_warp(A, R)
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_ldlt.factor_solve_matrix_warp(A.half(), R.half())
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.factor_solve_matrix_warp(torch.zeros((2, 4, 4)), R)
    with pytest.raises(ValueError, match="float64"):
        cuda_ldlt.factor_solve_matrix_warp(A, R.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ldlt.factor_solve_matrix_warp(
            torch.zeros((2, 3, 3)).transpose(1, 2), R)
    with pytest.raises(ValueError, match="orders up to 32"):
        cuda_ldlt.factor_solve_matrix_warp(torch.zeros((2, 33, 33)),
                                           torch.zeros((2, 33, 1)))
    with pytest.raises(ValueError, match="B, n, k > 0"):
        cuda_ldlt.factor_solve_matrix_warp(A, torch.zeros((2, 3, 0)))


def test_block_launcher_checks_before_launching(no_library):
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.factor_block(torch.zeros((4, 3, 3)))
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_ldlt.factor_block(torch.zeros((4, 3, 3), dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ldlt.factor_block(torch.zeros((4, 3, 3)).transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.factor_block(torch.zeros((4, 3, 5)))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ldlt.factor_block(torch.zeros((1, 170, 170), dtype=f64))


# ----------------------------------------------------------------------
# CPU tensors take the plain versions, with no launch counted
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [f32, f64])
@pytest.mark.parametrize("B,n", [(512, 64), (8, 16), (20, 24)])
def test_ldlt_auto_takes_plain_version_on_cpu(B, n, dtype, no_library):
    A = torch.from_numpy(quasi_definite(B, n, seed=n)).to(dtype)
    cuda_ldlt.reset_launch_counts()
    L, D = cuda_ldlt.ldlt_auto(A)
    L0, D0 = ldlt(A)
    assert torch.equal(L, L0) and torch.equal(D, D0)
    assert not any(cuda_ldlt.launches.values())
    assert not any(cuda_ldlt.route_launches.values())


@pytest.mark.parametrize("dtype", [f32, f64])
@pytest.mark.parametrize("B,n,k", [(64, 32, 2), (5, 16, 48), (3, 37, 5)])
def test_ldlt_solve_matrix_auto_takes_plain_version_on_cpu(B, n, k, dtype,
                                                          no_library):
    A = torch.from_numpy(quasi_definite(B, n, seed=k)).to(dtype)
    R = torch.from_numpy(
        np.random.default_rng(k).normal(size=(B, n, k))).to(dtype)
    cuda_ldlt.reset_launch_counts()
    L, D, X = cuda_ldlt.ldlt_solve_matrix_auto(A, R)
    L0, D0, X0 = ldlt_solve_matrix(A, R)
    assert torch.equal(L, L0) and torch.equal(D, D0) and torch.equal(X, X0)
    assert not any(cuda_ldlt.launches.values())
    assert not any(cuda_ldlt.route_launches.values())


def test_reset_clears_the_route_counts():
    for key in cuda_ldlt.route_launches:
        cuda_ldlt.route_launches[key] = 3
    cuda_ldlt.reset_launch_counts()
    assert set(cuda_ldlt.route_launches) == {
        "ldlt soa", "ldlt block", "solve_ldlt thread", "solve_ldlt warp",
        "solve_ldlt_matrix thread", "solve_ldlt_matrix warp",
        "ldlt_solve_matrix block", "ldlt_solve_matrix warp",
        "ldlt_solve_matrix split", "ldlt blocked"}
    assert not any(cuda_ldlt.route_launches.values())


# ----------------------------------------------------------------------
# the plain versions against the reference at the new routes' shapes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,n,k", [(4, 32, 2), (2, 16, 48)])
def test_plain_k5_matches_reference_at_route_shapes(B, n, k):
    K = quasi_definite(B, n, seed=B * n + k)
    R = np.random.default_rng(n + k).normal(size=(B, n, k))
    L_ref, D_ref, X_ref = batched_ldlt_solve_matrix_pallas(
        jnp.asarray(K), jnp.asarray(R), PIVOT_FLOOR)
    L, D, X = ldlt_solve_matrix(torch.from_numpy(K), torch.from_numpy(R))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_ref), rtol=1e-12)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", K, X.numpy()), R,
                               rtol=1e-9, atol=1e-9)


def test_plain_k2_matches_reference_at_the_block_route_shape():
    K = quasi_definite(3, 64, seed=64)
    L_ref, D_ref = batched_ldlt_pallas(jnp.asarray(K), PIVOT_FLOOR)
    L, D = ldlt(torch.from_numpy(K), PIVOT_FLOOR)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_ref), rtol=1e-12)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.diagonal(L, dim1=1, dim2=2),
                       torch.ones((3, 64), dtype=L.dtype))
