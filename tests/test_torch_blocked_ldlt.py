"""The panel-blocked LDL^T of the port (ipmzoo_tpu_torch/ops/blocked_ldlt.py)
and the route rule that sends ldlt_auto's large orders to it
(ops/cuda_ldlt.py::ldlt_route), on the CPU in float64, against the JAX
package's ``ldlt_blocked`` on the same numpy inputs.

On CPU tensors the diagonal panels take K2's plain version (the column
LDL^T), and nothing counts as a launch.  Tolerances: L and D within 1e-10
of the reference (the same algorithm; only the summation order of the
library products differs), solutions within 1e-10, residuals 1e-7 as the
reference's large-order test pins them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.ops.blocked_ldlt import ldlt_blocked as ref_ldlt_blocked
from ipmzoo_tpu.ops.ldlt import ldlt as ref_ldlt
from ipmzoo_tpu.ops.ldlt import solve_ldlt as ref_solve_ldlt
from ipmzoo_tpu_torch.ops import cuda_ldlt
from ipmzoo_tpu_torch.ops.blocked_ldlt import (DEFAULT_PANEL, ldlt_blocked,
                                               solve_ldlt_blocked,
                                               solve_ldlt_matrix_blocked)
from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR, ldlt

f32, f64 = torch.float32, torch.float64


def quasi_definite(n, m, seed=0):
    """[[H, B^T], [B, -C]] with H, C SPD (tests/test_blocked_ldlt.py's
    generator)."""
    rng = np.random.default_rng(seed)
    Mh = rng.normal(size=(n, n))
    H = Mh @ Mh.T / n + np.eye(n)
    Mc = rng.normal(size=(m, m))
    C = Mc @ Mc.T / m + np.eye(m)
    B = rng.normal(size=(m, n))
    return np.block([[H, B.T], [B, -C]])


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.fixture
def no_library(monkeypatch):
    def boom():
        raise AssertionError("the CUDA library was loaded")
    monkeypatch.setattr(cuda_ldlt, "_lib", boom)


@pytest.mark.parametrize("n,m,panel", [(180, 120, 128), (130, 70, 64),
                                       (50, 23, 32), (40, 30, 128)])
def test_matches_reference(n, m, panel, no_library):
    # 300 over two panels of 128 and a tail of 44; 200 = 3 x 64 + 8 (an
    # uneven tail); 73 = 2 x 32 + 9; 70 <= 128: the column kernel alone
    K = quasi_definite(n, m, seed=n)
    L0, D0 = ref_ldlt_blocked(jnp.asarray(K), panel=panel)
    cuda_ldlt.reset_launch_counts()
    L, D = ldlt_blocked(torch.from_numpy(K)[None], panel=panel)
    close(L[0], L0)
    close(D[0], D0)
    assert not any(cuda_ldlt.launches.values())
    assert not any(cuda_ldlt.route_launches.values())


def test_small_order_is_the_column_kernel(no_library):
    K = torch.from_numpy(quasi_definite(10, 5, seed=5))[None]
    L0, D0 = ldlt(K)
    L1, D1 = ldlt_blocked(K)
    assert torch.equal(L1, L0) and torch.equal(D1, D0)
    L2, D2 = ref_ldlt(jnp.asarray(K[0].numpy()))
    close(L1[0], L2, 1e-12)


def test_batched_matches_reference_per_instance():
    Ks = np.stack([quasi_definite(40, 30, seed=s) for s in range(3)])
    Lb, Db = ldlt_blocked(torch.from_numpy(Ks), panel=16)
    Lr, Dr = jax.vmap(lambda A: ref_ldlt_blocked(A, panel=16))(
        jnp.asarray(Ks))
    close(Lb, Lr)
    close(Db, Dr)
    for i in range(3):
        Li, Di = ldlt_blocked(torch.from_numpy(Ks[i])[None], panel=16)
        assert torch.equal(Li[0], Lb[i]) and torch.equal(Di[0], Db[i])


def test_reconstructs_and_matches_the_column_kernel():
    K = torch.from_numpy(quasi_definite(90, 47, seed=1))[None]
    L, D = ldlt_blocked(K, panel=32)
    rec = L @ torch.diag_embed(D) @ L.transpose(-1, -2)
    close(rec, K, 1e-9)
    L0, D0 = ldlt(K)
    close(L, L0, 1e-9)
    close(D, D0, 1e-9)


def test_pivot_floor_in_a_later_panel():
    # rows / columns 32 and 33 hold only a block of ones: after the first
    # panel's trailing update the pivot of column 33 is exactly zero
    K = quasi_definite(60, 20, seed=3)
    K[32:34, :] = 0.0
    K[:, 32:34] = 0.0
    K[32:34, 32:34] = 1.0
    L, D = ldlt_blocked(torch.from_numpy(K)[None], panel=32)
    L0, D0 = ref_ldlt_blocked(jnp.asarray(K), panel=32)
    assert float(D[0, 33]) == PIVOT_FLOOR == float(D0[33])
    close(L[0], L0)
    close(D[0], D0)


def test_empty_and_degenerate_shapes():
    L, D = ldlt_blocked(torch.zeros((2, 0, 0), dtype=f64))
    assert L.shape == (2, 0, 0) and D.shape == (2, 0)
    with pytest.raises(ValueError, match="expected"):
        ldlt_blocked(torch.zeros((4, 3), dtype=f64))
    x = solve_ldlt_matrix_blocked(L, D, torch.zeros((2, 0, 3), dtype=f64))
    assert x.shape == (2, 0, 3)


def test_solves_match_reference():
    K = quasi_definite(100, 60, seed=2)
    rng = np.random.default_rng(3)
    b = rng.normal(size=(2, 160))
    R = rng.normal(size=(160, 3))
    Kt = torch.from_numpy(np.stack([K, K]))
    L, D = ldlt_blocked(Kt, panel=48)
    x = solve_ldlt_blocked(L, D, torch.from_numpy(b))
    L0, D0 = ref_ldlt_blocked(jnp.asarray(K), panel=48)
    for i in range(2):
        close(x[i], ref_solve_ldlt(L0, D0, jnp.asarray(b[i])))
        np.testing.assert_allclose(K @ x[i].numpy(), b[i], rtol=1e-8,
                                   atol=1e-8)
    # the multi-rhs twin, column by column against the reference's
    # one-column solve
    X = solve_ldlt_matrix_blocked(L[:1], D[:1], torch.from_numpy(R)[None])
    for j in range(3):
        close(X[0, :, j], ref_solve_ldlt(L0, D0, jnp.asarray(R[:, j])))


def test_large_dim_mirror_of_the_reference_route_test():
    """tests/test_pallas_kernels.py's aug_dim 352 batch of three, factored
    and solved by the blocked path: the route ldlt_auto takes on the card
    at this order (the plain version takes it on the CPU)."""
    rng = np.random.default_rng(5)
    n, B = 352, 3
    M = rng.normal(size=(B, n, n))
    A = torch.from_numpy(M @ np.swapaxes(M, 1, 2) + n * np.eye(n))
    b = torch.from_numpy(rng.normal(size=(B, n)))
    L, D = ldlt_blocked(A)
    x = solve_ldlt_blocked(L, D, b)
    r = torch.einsum("bij,bj->bi", A, x) - b
    assert float(r.abs().max()) < 1e-7
    assert cuda_ldlt.ldlt_route(n) == "blocked"


@pytest.mark.parametrize("dtype", [f32, f64])
def test_route_never_blocked_up_to_one_panel(dtype):
    # K2 keeps every order up to one panel, and its block route holds a
    # whole panel in either type
    assert cuda_ldlt.K2_ORDERS == DEFAULT_PANEL == 128
    for n in range(1, cuda_ldlt.K2_ORDERS + 1):
        assert cuda_ldlt.ldlt_route(n) == "k2"
        assert cuda_ldlt.factor_block_fits(n, dtype)


@pytest.mark.parametrize("n", [129, 328, 352, 1024])
def test_route_sends_the_path_orders_to_the_blocked_path(n):
    # one past a panel, the nd generic top (328), bench_aug's KKT (352),
    # the normal mode's H (1024): the rule's measured picks
    assert cuda_ldlt.ldlt_route(n) == "blocked"


def test_cpu_wrappers_keep_the_plain_versions_above_one_panel(no_library):
    """ldlt_route decides for CUDA tensors only: on the CPU the wrappers
    run K2/K3/K4's plain versions at every order."""
    from ipmzoo_tpu_torch.ops.ldlt import solve_ldlt, solve_ldlt_matrix
    K = torch.from_numpy(quasi_definite(100, 60, seed=4))[None]
    b = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 160)))
    L, D = cuda_ldlt.ldlt_auto(K)
    L0, D0 = ldlt(K)
    assert torch.equal(L, L0) and torch.equal(D, D0)
    assert torch.equal(cuda_ldlt.solve_ldlt_auto(L, D, b),
                       solve_ldlt(L0, D0, b))
    R = b[:, :, None]
    assert torch.equal(cuda_ldlt.solve_ldlt_matrix_auto(L, D, R),
                       solve_ldlt_matrix(L0, D0, R))


def test_blocked_factors_solve_in_either_layout():
    """The blocked route returns plain (B, n, n) factors and K2 views of
    its SoA storage: both solve paths read either."""
    K = torch.from_numpy(np.stack([quasi_definite(30, 20, seed=s)
                                   for s in range(2)]))
    b = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 50)))
    L, D = ldlt_blocked(K, panel=16)
    soa_L, soa_D = cuda_ldlt.soa_backed(L, D)
    x = solve_ldlt_blocked(L, D, b)
    close(solve_ldlt_blocked(soa_L, soa_D, b), x, 1e-12)
    from ipmzoo_tpu_torch.ops.ldlt import solve_ldlt
    close(solve_ldlt(L, D, b), x, 1e-10)
