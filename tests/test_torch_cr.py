"""Plain versions of the cyclic-reduction kernels K6/K7
(ipmzoo_tpu_torch.ops.cr) against the JAX package's Pallas kernels in
interpret mode, its level-by-level composition and a dense solve.

float64 on the CPU unless a case says float32; the inputs are made with
numpy from a seed and fed to both sides.  Tolerances: 1e-9 absolute in
float64 (the reference's own test of its kernels), 5e-4 in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.ops.banded import bt_factor, bt_solve, cr_factor, cr_solve
from ipmzoo_tpu.ops.cr_pallas import cr_factor_pallas, cr_solve_pallas
from ipmzoo_tpu_torch.ops import banded, cuda_cr
from ipmzoo_tpu_torch.ops.cr import (CRKernelFactors, chol_inv_plain,
                                     cr_factor_plain, cr_solve_plain, levels)


def _spd_block_tridiag(N, b, seed=0, dtype=np.float64, coupling=0.3):
    rng = np.random.default_rng(seed)
    D = np.zeros((N, b, b), dtype)
    for i in range(N):
        M = rng.normal(size=(b, b))
        D[i] = M @ M.T / b + (2.0 + 0.5 * i % 3) * np.eye(b)
    E = rng.normal(size=(max(N - 1, 0), b, b)).astype(dtype) * coupling
    return D, E


def _dense(D, E):
    N, b = D.shape[0], D.shape[-1]
    K = np.zeros((N * b, N * b))
    for i in range(N):
        K[i * b:(i + 1) * b, i * b:(i + 1) * b] = D[i]
    for i in range(N - 1):
        K[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = E[i]
        K[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = E[i].T
    return K


def _port(D, E, r):
    f = cr_factor_plain(torch.tensor(D), torch.tensor(E))
    return f, cr_solve_plain(f, torch.tensor(r)).numpy()


def _assert_factors_match(f: CRKernelFactors, ref, N, atol):
    """The port's position-indexed factors against the reference's
    per-level slabs (block p of level s sits at lane p - s there)."""
    np.testing.assert_allclose(f.Pinv[0].numpy(),
                               np.asarray(ref.root)[:, :, 0], atol=atol)
    assert not f.Eb[0].any() and not f.Ea[0].any()
    seen = [0]
    for lev, s in enumerate(levels(N)):
        for p in range(s, N, 2 * s):
            seen.append(p)
            for name in ("Pinv", "Eb", "Ea"):
                np.testing.assert_allclose(
                    getattr(f, name)[p].numpy(),
                    np.asarray(getattr(ref, name))[lev, :, :, p - s],
                    atol=atol, err_msg=f"{name}[{p}] level {lev}")
    assert sorted(seen) == list(range(N))


@pytest.mark.parametrize("N,b", [(8, 4), (16, 4), (5, 4), (4, 8)])
def test_matches_reference_kernels_cr_and_dense(N, b):
    D, E = _spd_block_tridiag(N, b)
    r = np.random.default_rng(1).normal(size=(N, b, 1))

    f, x = _port(D, E, r)
    f_pl = cr_factor_pallas(jnp.asarray(D), jnp.asarray(E))
    x_pl = cr_solve_pallas(f_pl, jnp.asarray(r))
    np.testing.assert_allclose(x, np.asarray(x_pl), rtol=0, atol=1e-9)
    _assert_factors_match(f, f_pl, N, 1e-9)

    x_x = cr_solve(cr_factor(jnp.asarray(D), jnp.asarray(E)), jnp.asarray(r))
    np.testing.assert_allclose(x, np.asarray(x_x), rtol=0, atol=1e-9)

    x_d = np.linalg.solve(_dense(D, E), r.reshape(-1))
    np.testing.assert_allclose(x.reshape(-1), x_d, rtol=0, atol=1e-9)


def test_multi_rhs_matches_scan():
    """k=8 right-hand sides (the arrow strip width)."""
    N, b, k = 8, 4, 8
    D, E = _spd_block_tridiag(N, b, seed=2)
    r = np.random.default_rng(3).normal(size=(N, b, k))
    _, x = _port(D, E, r)
    x_pl = cr_solve_pallas(cr_factor_pallas(jnp.asarray(D), jnp.asarray(E)),
                           jnp.asarray(r))
    x_bt = bt_solve(bt_factor(jnp.asarray(D), jnp.asarray(E)),
                    jnp.asarray(r))
    np.testing.assert_allclose(x, np.asarray(x_pl), rtol=0, atol=1e-9)
    np.testing.assert_allclose(x, np.asarray(x_bt), rtol=0, atol=1e-9)


def test_single_block():
    D, E = _spd_block_tridiag(1, 4, seed=4)
    r = np.random.default_rng(5).normal(size=(1, 4, 1))
    f, x = _port(D, E, r)
    x_pl = cr_solve_pallas(cr_factor_pallas(jnp.asarray(D), jnp.asarray(E)),
                           jnp.asarray(r))
    np.testing.assert_allclose(x, np.asarray(x_pl), atol=1e-10)
    np.testing.assert_allclose(x[0, :, 0],
                               np.linalg.solve(D[0], r[0, :, 0]), atol=1e-10)
    assert levels(1) == []


def test_f32_shapes():
    """float32, bench-like blocking (small N to keep the test fast)."""
    N, b = 16, 8
    D, E = _spd_block_tridiag(N, b, seed=6, dtype=np.float32)
    r = np.random.default_rng(7).normal(size=(N, b, 1)).astype(np.float32)
    f, x = _port(D, E, r)
    assert x.dtype == np.float32 and f.Pinv.dtype == torch.float32
    x_pl = cr_solve_pallas(cr_factor_pallas(jnp.asarray(D), jnp.asarray(E)),
                           jnp.asarray(r))
    x_x = cr_solve(cr_factor(jnp.asarray(D), jnp.asarray(E)), jnp.asarray(r))
    np.testing.assert_allclose(x, np.asarray(x_pl), rtol=0, atol=5e-4)
    np.testing.assert_allclose(x, np.asarray(x_x), rtol=0, atol=5e-4)


@pytest.mark.parametrize("N,b,k", [(11, 4, 3), (32, 16, 9)])
def test_batched_equals_per_instance(N, b, k):
    """A leading batch axis computes each instance as alone, bit for bit,
    and agrees with the reference's kernels."""
    B = 3
    # weaker couplings keep the wide blocks positive definite
    Ds, Es = zip(*(_spd_block_tridiag(N, b, seed=10 + i,
                                      coupling=0.3 if b < 16 else 0.1)
                   for i in range(B)))
    D, E = np.stack(Ds), np.stack(Es)
    r = np.random.default_rng(8).normal(size=(B, N, b, k))
    f = cr_factor_plain(torch.tensor(D), torch.tensor(E))
    x = cr_solve_plain(f, torch.tensor(r))
    assert tuple(f.Pinv.shape) == (B, N, b, b) and x.shape == r.shape
    for i in range(B):
        fi, xi = _port(D[i], E[i], r[i])
        for a, c in zip(f, fi):
            assert torch.equal(a[i], c)
        np.testing.assert_array_equal(x[i].numpy(), xi)
    assert bool(torch.isfinite(x).all())
    x_pl = cr_solve_pallas(cr_factor_pallas(jnp.asarray(D[0]),
                                            jnp.asarray(E[0])),
                           jnp.asarray(r[0]))
    np.testing.assert_allclose(x[0].numpy(), np.asarray(x_pl), rtol=0,
                               atol=1e-9)


def test_chol_inv_plain_is_the_inverse_and_nan_when_not_spd():
    rng = np.random.default_rng(9)
    M = rng.normal(size=(5, 6, 6))
    P = M @ M.transpose(0, 2, 1) + 6 * np.eye(6)
    Pi = chol_inv_plain(torch.tensor(P)).numpy()
    np.testing.assert_allclose(Pi, np.linalg.inv(P), atol=1e-12)
    bad = chol_inv_plain(torch.tensor(-np.eye(3)))
    assert bool(torch.isnan(bad).any())


def test_library_composition_matches_reference():
    """The port's 'cr' and 'scan' engines (library calls per level / per
    block) against the reference's."""
    N, b, k = 13, 4, 2
    D, E = _spd_block_tridiag(N, b, seed=12)
    r = np.random.default_rng(13).normal(size=(N, b, k))
    tD, tE, tr = torch.tensor(D), torch.tensor(E), torch.tensor(r)
    x_ref = np.asarray(cr_solve(cr_factor(jnp.asarray(D), jnp.asarray(E)),
                                jnp.asarray(r)))
    x_cr = banded.cr_solve(banded.cr_factor(tD, tE), tr).numpy()
    x_bt = banded.bt_solve(banded.bt_factor(tD, tE), tr).numpy()
    np.testing.assert_allclose(x_cr, x_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(x_bt, x_ref, rtol=0, atol=1e-12)
    # and with a leading batch axis
    xb = banded.cr_solve(banded.cr_factor(tD[None], tE[None]), tr[None])
    np.testing.assert_allclose(xb[0].numpy(), x_cr, rtol=0, atol=1e-14)
    xb = banded.bt_solve(banded.bt_factor(tD[None], tE[None]), tr[None])
    np.testing.assert_allclose(xb[0].numpy(), x_bt, rtol=0, atol=1e-14)


class TestWrapper:
    """ops/cuda_cr.py on a machine without a card: CPU tensors take the
    plain versions, the kernels' entry points refuse them."""

    def setup_method(self):
        D, E = _spd_block_tridiag(6, 4, seed=14)
        self.D, self.E = torch.tensor(D), torch.tensor(E)
        self.r = torch.tensor(np.random.default_rng(15).normal(
            size=(6, 4, 2)))

    def test_auto_on_cpu_is_the_plain_version_and_counts_nothing(self):
        cuda_cr.reset_launch_counts()
        f = cuda_cr.cr_factor_auto(self.D, self.E)
        x = cuda_cr.cr_solve_auto(f, self.r)
        g = cr_factor_plain(self.D, self.E)
        assert all(torch.equal(a, c) for a, c in zip(f, g))
        assert torch.equal(x, cr_solve_plain(g, self.r))
        assert cuda_cr.launches == {"cr_factor": 0, "cr_solve": 0}
        assert cuda_cr.f64_launches == {"cr_factor": 0, "cr_solve": 0}

    def test_kernels_refuse_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_cr.cr_factor_kernel(self.D, self.E)
        f = cr_factor_plain(self.D, self.E)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_cr.cr_solve_kernel(f, self.r)

    def test_other_devices_and_shapes_raise(self):
        with pytest.raises(ValueError, match="meta"):
            cuda_cr.cr_factor_auto(self.D.to("meta"), self.E.to("meta"))
        with pytest.raises(ValueError, match="expected D"):
            cuda_cr.cr_factor_auto(self.D[0], self.E[0])
        with pytest.raises(ValueError, match="expected r"):
            cuda_cr.cr_solve_auto(cr_factor_plain(self.D, self.E),
                                  self.r[0])

    def test_size_limit_is_named(self):
        with pytest.raises(ValueError, match="32-bit offsets"):
            cuda_cr._check_size(2 ** 20, 64, 64)
        cuda_cr._check_size(256, 16, 16)
