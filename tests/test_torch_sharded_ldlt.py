"""The port's panel-sharded LDL^T (ipmzoo_tpu_torch/ops/sharded_ldlt.py)
on the CPU, mirroring tests/test_sharded_ldlt.py, and the collectives
over one axis of a two-axis mesh (parallel/mesh.py).

One job (``torch_spawn_jobs.sharded_ldlt_world4``) runs every case in 4
gloo ranks.  The port's factor is held to the JAX package's
``ldlt_blocked`` at the reference's bars (L 1e-11, D 1e-10) and to its
``sharded_ldlt`` / ``sharded_ldlt_solve`` on conftest's virtual CPU
devices; the solve to K x = b within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spawn_jobs as jobs
from ipmzoo_tpu.ops.blocked_ldlt import ldlt_blocked as ref_ldlt_blocked
from ipmzoo_tpu.ops.sharded_ldlt import shard_kkt as ref_shard_kkt
from ipmzoo_tpu.ops.sharded_ldlt import sharded_ldlt as ref_sharded_ldlt
from ipmzoo_tpu.ops.sharded_ldlt import \
    sharded_ldlt_solve as ref_sharded_ldlt_solve
from ipmzoo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ipmzoo_tpu_torch.ops import (shard_kkt, sharded_ldlt,
                                  sharded_ldlt_solve)
from ipmzoo_tpu_torch.ops.blocked_ldlt import ldlt_blocked
from ipmzoo_tpu_torch.parallel import make_mesh

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return jobs.run(jobs.sharded_ldlt_world4, WORLD)


def ref_mesh():
    return ref_make_mesh(axis_names=("tp",))


@pytest.mark.parametrize("panel", jobs.TP_PANELS)
def test_sharded_factor_matches_unsharded(ranks, panel):
    K = jobs.kkt(384, 128, seed=0)           # dim 512 over 4 ranks
    L, D, _ = ranks[0]["factor"][panel]
    L0, D0 = ref_ldlt_blocked(jnp.asarray(K))
    np.testing.assert_allclose(L, np.asarray(L0), rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(D, np.asarray(D0), rtol=1e-10, atol=1e-10)
    # and the JAX package's own sharded factor on its 8-device mesh
    mesh = ref_mesh()
    Lr, Ldr, Dr = ref_sharded_ldlt(ref_shard_kkt(jnp.asarray(K), mesh),
                                   mesh, panel=panel)
    np.testing.assert_allclose(L, np.asarray(jax.device_get(Lr)),
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(D, np.asarray(Dr), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("panel", jobs.TP_PANELS)
def test_every_rank_holds_the_same_D_and_panels(ranks, panel):
    L, D, Lds = ranks[0]["factor"][panel]
    assert len(Lds) == 512 // panel and Lds[0].shape == (panel, panel)
    for out in ranks[1:]:
        Lr, Dr, Ldr = out["factor"][panel]
        np.testing.assert_array_equal(Dr, D)
        np.testing.assert_array_equal(Lr, L)
        for a, b in zip(Ldr, Lds):
            np.testing.assert_array_equal(a, b)


def test_factor_comes_back_row_sharded(ranks):
    # each rank keeps its 128 rows of L, as the reference's P(axis, None)
    assert all(out["rows"] == (512 // WORLD, 512) for out in ranks)


def test_sharded_solve(ranks):
    K = jobs.kkt(384, 128, seed=1)
    b = np.random.default_rng(2).normal(size=512)
    x = ranks[0]["x"]
    np.testing.assert_allclose(K @ x, b, rtol=1e-10, atol=1e-10)
    # the same bits on every rank
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["x"], x)
    mesh = ref_mesh()
    factors = ref_sharded_ldlt(ref_shard_kkt(jnp.asarray(K), mesh), mesh,
                               panel=64)
    xr = ref_sharded_ldlt_solve(factors, jnp.asarray(b), mesh, panel=64)
    np.testing.assert_allclose(x, np.asarray(xr), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("case,match", [
    ("bad_n", "n=102 must divide over 4 devices"),
    ("bad_n_shard", "does not split over 4 ranks"),
    ("bad_panel", "panel=48 must divide rows/device=128"),
])
def test_bad_shapes_rejected(ranks, case, match):
    kind, msg = ranks[0][case]
    assert kind == "ValueError" and match in msg
    # the reference raises on the same shapes
    mesh = ref_mesh()
    with pytest.raises(ValueError):
        ref_sharded_ldlt(jnp.eye(100), mesh)            # 100 % 8 != 0
    with pytest.raises(ValueError):
        ref_sharded_ldlt(jnp.eye(512), mesh, panel=48)  # 48 does not divide 64


def test_batch_axis_equals_single_factors(ranks):
    (L, D, x), singles = ranks[0]["batch"]
    assert L.shape == (jobs.TP_BATCH, 128 // WORLD, 128)
    for s, (Ls, Ds, xs) in enumerate(singles):
        np.testing.assert_allclose(L[s], Ls, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(D[s], Ds, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(x[s], xs, rtol=1e-12, atol=1e-12)
    Ks = np.stack([jobs.kkt(96, 32, seed=10 + s)
                   for s in range(jobs.TP_BATCH)])
    bs = np.random.default_rng(11).normal(size=(jobs.TP_BATCH, 128))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", Ks, x), bs,
                               rtol=1e-10, atol=1e-10)


def test_no_collective_staged_on_the_cpu(ranks):
    assert all(out["staged"] == 0 for out in ranks)


# -- one axis of a (2, 2) ("dp", "tp") mesh -----------------------------------

def _expected(op, values, ranks_of_slice):
    vals = np.array([values[r] for r in ranks_of_slice])
    return {"psum": vals.sum(0), "pmin": vals.min(0),
            "pmax": vals.max(0), "gather": vals,
            "gather_tiled": vals.reshape(-1),
            "broadcast": vals[1]}[op]


@pytest.mark.parametrize("op", ["psum", "pmin", "pmax", "gather",
                                "gather_tiled", "broadcast"])
@pytest.mark.parametrize("axis", ["dp", "tp"])
def test_two_axis_collectives(ranks, axis, op):
    values = [np.array([float(r), 10.0 * r + 1.0]) for r in range(WORLD)]
    grid = np.arange(WORLD).reshape(2, 2)
    for r, out in enumerate(ranks):
        two = out["two_axes"]
        assert two["coords"] == (r // 2, r % 2)
        assert two["groups"] == ["dp", "tp"]
        # the ranks that share every other coordinate with rank r
        dp, tp = two["coords"]
        members = grid[:, tp] if axis == "dp" else grid[dp, :]
        np.testing.assert_array_equal(two["collectives"][axis][op],
                                      _expected(op, values, members))


def test_two_axis_shard_slice(ranks):
    for r, out in enumerate(ranks):
        assert out["two_axes"]["shard"] == slice(4 * (r % 2),
                                                 4 * (r % 2) + 4)


def test_two_axis_tp_factor_equals_the_one_axis_factor(ranks):
    L1, D1, _ = ranks[0]["factor"][64]
    for out in ranks:
        two = out["two_axes"]
        np.testing.assert_allclose(two["L"], L1, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(two["D"], D1, rtol=1e-12, atol=1e-12)
        # D and x the same bits on every rank
        np.testing.assert_array_equal(two["D"], ranks[0]["two_axes"]["D"])
        np.testing.assert_array_equal(two["x"], ranks[0]["two_axes"]["x"])
    np.testing.assert_allclose(ranks[0]["two_axes"]["x"], ranks[0]["x"],
                               rtol=1e-12, atol=1e-12)


# -- one rank, no process group ----------------------------------------------

@pytest.mark.parametrize("panel", [16, 32])
def test_one_rank_mesh_is_the_blocked_factor(panel):
    K = torch.tensor(jobs.kkt(96, 32, seed=5))
    mesh = make_mesh((1,), ("tp",), ["cpu"])
    assert mesh.group is None
    L, Lds, D = sharded_ldlt(shard_kkt(K, mesh), mesh, panel=panel)
    L0, D0 = ldlt_blocked(K[None], panel=panel)
    # the same arithmetic in the same order: the same bits
    assert torch.equal(L, L0[0]) and torch.equal(D, D0[0])
    b = torch.tensor(np.random.default_rng(6).normal(size=128))
    x = sharded_ldlt_solve((L, Lds, D), b, mesh)
    np.testing.assert_allclose((K @ x).numpy(), b.numpy(), rtol=1e-10,
                               atol=1e-10)
    assert mesh.host_syncs == 0


def test_solve_takes_the_factors_panel():
    # the reference replaces a panel that differs from the factors' own
    K = torch.tensor(jobs.kkt(48, 16, seed=7))
    mesh = make_mesh((1,), ("tp",), ["cpu"])
    factors = sharded_ldlt(shard_kkt(K, mesh), mesh, panel=16)
    b = torch.ones(64, dtype=torch.float64)
    x = sharded_ldlt_solve(factors, b, mesh, panel=32)
    assert torch.equal(x, sharded_ldlt_solve(factors, b, mesh))
    with pytest.raises(ValueError, match="panel=48"):
        sharded_ldlt_solve(factors, b, mesh, panel=48)
