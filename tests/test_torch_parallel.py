"""The port's multi-device layer (ipmzoo_tpu_torch/parallel/: mesh.py,
distributed.py, scaling.py, dryrun.py) on the CPU, mirroring
tests/test_parallel.py and tests/test_distributed.py.

The port's ranks are processes joined in one gloo group
(``distributed.spawn``): each world is started once per module, and one
job computes every case (``torch_spawn_jobs.py``).  The reference runs
in this process on conftest's virtual CPU devices, on a mesh of as many
devices as the port has ranks.  A hung rank fails its test after
``torch_spawn_jobs.DEADLINE`` seconds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

import torch_spawn_jobs as jobs
from ipmzoo_tpu.formulations import Bounds, Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.parallel.mesh import batch_sharding as ref_batch_sharding
from ipmzoo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ipmzoo_tpu.parallel.scaling import ScalingReport as RefScalingReport
from ipmzoo_tpu_torch.parallel import (batch_sharding, make_mesh,
                                       replicated)
from ipmzoo_tpu_torch.parallel import distributed, mesh as port_mesh
from ipmzoo_tpu_torch.parallel.dryrun import dryrun_multichip
from ipmzoo_tpu_torch.parallel.scaling import ScalingReport

WORLD = 4


@pytest.fixture(scope="module")
def world4():
    return jobs.run(jobs.parallel_world4, WORLD)


@pytest.fixture(scope="module")
def world2():
    return jobs.run(jobs.two_process_psum, 2)


# -- the mesh ----------------------------------------------------------------

def test_mesh_helpers(world4):
    ref = ref_make_mesh((WORLD,), ("dp",), jax.devices()[:WORLD])
    for r, out in enumerate(world4):
        assert out["rank"] == r and out["group"]
        assert out["shape"] == {"dp": WORLD} == dict(ref.shape)
        assert out["size"] == WORLD == ref.devices.size
        assert out["devices"] == ["cpu"] * WORLD and out["device"] == "cpu"
        dp, rep = out["specs"]
        assert dp == RefP("dp") and rep == RefP()
        assert tuple(dp) == tuple(ref_batch_sharding(ref).spec)


def test_one_rank_mesh_without_a_process_group():
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == {"dp": 1} and mesh.size == 1
    assert mesh.rank == 0 and mesh.group is None
    assert batch_sharding(mesh).spec == RefP("dp") == port_mesh.P("dp")
    assert replicated(mesh).spec == RefP() == port_mesh.P()
    x = torch.arange(3.0)
    # collectives are the identity, nothing staged
    assert port_mesh.psum(x, mesh) is x and port_mesh.pmin(x, mesh) is x
    assert torch.equal(port_mesh.all_gather(x, mesh), x[None])
    assert port_mesh.shard_batch({"a": x}, mesh)["a"].tolist() == [0, 1, 2]
    assert port_mesh.gather_batch(x, mesh) is x
    assert mesh.host_syncs == 0
    assert distributed.is_primary()
    assert distributed.local_batch_slice(8) == slice(0, 8)


def test_mesh_raises_as_the_reference():
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 1"):
        make_mesh((8,), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"mesh needs 8 devices, have 4"):
        ref_make_mesh((8,), ("dp",), jax.devices()[:4])
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((1,), ("dp", "tp"), devices=["cpu"])


def test_default_devices_are_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        make_mesh()


def test_mesh_refusals_at_four_ranks(world4):
    out = world4[0]
    assert out["too_many"] == ("ValueError",
                               "mesh needs 8 devices, have 4")
    assert out["too_few"][0] == "ValueError" and "spans every rank" in \
        out["too_few"][1]
    assert out["uneven"][0] == "ValueError" and "does not split" in \
        out["uneven"][1]
    # a collective over one axis of a two-axis mesh sums the ranks that
    # share the other coordinate: (rank 0 + 1) + (rank 2 + 1) over dp
    assert [o["two_axes"] for o in world4] == [[4.0], [6.0], [4.0], [6.0]]


def test_collectives(world4):
    for r, out in enumerate(world4):
        assert out["psum"] == [0.0 + 1 + 2 + 3, 4.0]
        assert out["pmin"] == 7.0 and out["pmax"] == 10.0
        assert out["gather"] == [[k, 2 * k] for k in range(WORLD)]
        assert out["gather_tiled"] == [v for k in range(WORLD)
                                       for v in (k, 2 * k)]
        assert out["gather_bool"] == [True, False, True, False]
        assert out["slice"] == slice(4 * r, 4 * r + 4)
        # CPU tensors on gloo go through no staging
        assert out["staged"] == 0


def test_two_process_psum(world2):
    for r, out in enumerate(world2):
        assert out["backend"] == "gloo"
        assert out["slice"] == (4 * r, 4 * r + 4)
        assert out["total"] == 28.0
        assert out["primary"] == (r == 0)


def test_backend_rule_takes_gloo_without_a_card_each():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert distributed.backend(1) == distributed.backend(2) == "gloo"


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()
    distributed.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()


# -- dp: a batch of independent QPs over the ranks ----------------------------

def ref_batch(raw):
    return RefQPData(**{k: jnp.asarray(v) for k, v in raw.items()})


def test_sharded_batch_solve_matches_unsharded(world4):
    dp = world4[0]["dp"]
    for out in world4[1:]:
        for k, (a, b) in out["dp"].items():
            np.testing.assert_array_equal(a, dp[k][0])
    x_sh, x_plain = dp["x"]
    assert dp["converged"][0].all() and dp["converged"][1].all()
    np.testing.assert_array_equal(dp["iterations"][0], dp["iterations"][1])
    np.testing.assert_allclose(x_sh, x_plain, rtol=1e-10, atol=1e-10)
    # the reference's dp-sharded solve on a mesh of as many devices
    solver = RefIPM(Settings(inequalities=Bounds.NONE), n=6)
    mesh = ref_make_mesh((WORLD,), ("dp",), jax.devices()[:WORLD])
    data = jax.device_put(ref_batch(jobs.random_batch(16, 6, seed=1)),
                          ref_batch_sharding(mesh))
    ref = jax.jit(jax.vmap(solver._solve_impl))(data)
    assert bool(jnp.all(ref.converged))
    np.testing.assert_array_equal(dp["iterations"][0],
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(x_sh, np.asarray(ref.x), rtol=1e-10,
                               atol=1e-10)


def test_dp_scaling_report_mechanics(world4):
    """The report's mechanics at 4 ranks on one CPU (the value of the
    efficiency means nothing there: the ranks share the cores)."""
    reports = [out["report"] for out in world4]
    rep = reports[0]
    # the slowest rank's times: every rank returns the same report
    assert all(r == rep for r in reports)
    assert rep.n_devices == WORLD and rep.batch == 16 and rep.steps == 5
    assert rep.t_1dev > 0 and rep.t_ndev > 0
    assert rep.speedup == pytest.approx(rep.t_1dev / rep.t_ndev)
    assert rep.efficiency == pytest.approx(rep.speedup / WORLD)
    assert rep.iters_per_s_ndev == pytest.approx(16 * 5 / rep.t_ndev)
    summary = rep.summary()
    assert "efficiency" in summary and f"{WORLD} dev" in summary
    # the same fields and the same text as the reference's report
    assert [f.name for f in dataclasses.fields(ScalingReport)] == \
        [f.name for f in dataclasses.fields(RefScalingReport)]
    assert RefScalingReport(**dataclasses.asdict(rep)).summary() == summary


def test_sharded_steps_equal_single_rank_steps(world4):
    for a, b in world4[0]["steps"]:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


# -- the dry run -------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_graft_dryrun_multichip(world, capsys):
    diffs = dryrun_multichip(world, device="cpu")
    assert set(diffs) == {"dp-step", "schur", "schur-tf", "tp-ldlt",
                          "tp-ipm"}
    assert all(d <= 1e-5 for d in diffs.values())
    out = capsys.readouterr().out
    for name in diffs:
        assert f"dryrun[{name}]: sharded vs local max|diff|" in out


def test_spawn_fails_with_the_rank_that_failed():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        jobs.run(jobs.failing_rank, 2)
