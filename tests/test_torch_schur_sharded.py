"""``SchurIPM.solve_sharded`` of the port on the CPU: the blocks of one
coupled QP over 4 gloo ranks, mirroring the sharded cases of
tests/test_schur.py.

One job (``torch_spawn_jobs.schur_world4``) solves every case sharded
and locally on each rank.  The sharded solve is held to the port's own
local ``solve`` at the reference's bars (x 1e-8, objective 1e-10
relative; two_float x 1e-6), and, in float64, to the JAX package's
``solve_sharded`` on a mesh of 4 virtual CPU devices (iterations equal,
x 1e-8).  The port's ``two_float`` solves in float64 where the reference
carries pairs, so that case is held to the local solve only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spawn_jobs as jobs
from ipmzoo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ipmzoo_tpu.parallel.schur import BlockQPData as RefBlockQPData
from ipmzoo_tpu.parallel.schur import SchurIPM as RefSchurIPM
from ipmzoo_tpu_torch.parallel import BlockQPData, SchurIPM

WORLD = 4
CASES = jobs.SCHUR_CASES
FLOAT64 = [k for k, (_, _, dt) in CASES.items() if dt == "float64"]


@pytest.fixture(scope="module")
def ranks():
    return jobs.run(jobs.schur_world4, WORLD)


def ref_sharded(name):
    raw, kw, _ = CASES[name]
    mesh = ref_make_mesh((WORLD,), ("dp",), jax.devices()[:WORLD])
    n, m_c = raw["Q"].shape[-1], raw["g"].shape[-1]
    data = RefBlockQPData(**{k: jnp.asarray(v) for k, v in raw.items()})
    res = RefSchurIPM(n, m_c, mesh=mesh, axis="dp", **kw).solve_sharded(data)
    return np.asarray(res.x), int(res.iterations), bool(res.converged)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_whole_result(ranks, name):
    raw = CASES[name][0]
    first = ranks[0][name]
    for out in ranks[1:]:
        for f in ("x", "nu", "objective", "iterations", "residual", "gap",
                  "converged"):
            np.testing.assert_array_equal(out[name][f][0], first[f][0])
    assert first["x"][0].shape == raw["c"].shape
    assert first["nu"][0].shape == raw["g"].shape


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_local(ranks, name):
    out = ranks[0][name]
    xs, xl = out["x"]
    assert out["converged"][0] and out["converged"][1]
    assert out["iterations"][0] == out["iterations"][1]
    atol = 1e-6 if name == "two_float" else 1e-8
    np.testing.assert_allclose(xs, xl, rtol=atol, atol=atol)
    np.testing.assert_allclose(out["objective"][0], out["objective"][1],
                               rtol=1e-10)


@pytest.mark.parametrize("name", FLOAT64)
def test_sharded_equals_the_reference_sharded(ranks, name):
    x, iterations, converged = ref_sharded(name)
    out = ranks[0][name]
    assert converged and out["converged"][0]
    assert int(out["iterations"][0]) == iterations
    np.testing.assert_allclose(out["x"][0], x, rtol=1e-8, atol=1e-8)


def test_sharded_matches_scipy(ranks):
    x_ref, f_ref = jobs.dense_reference(CASES["scipy"][0])
    out = ranks[0]["scipy"]
    np.testing.assert_allclose(out["x"][0], x_ref, atol=1e-5)
    assert abs(float(out["objective"][0]) - f_ref) <= 1e-6 * (1 + abs(f_ref))


def test_cond_1e8_sharded_stays_in_the_box(ranks):
    x = ranks[0]["cond_1e8"]["x"][0]
    assert np.all(x <= 3.0 + 1e-9) and np.all(x >= -3.0 - 1e-9)


def test_two_float_solves_in_float64_and_returns_float32(ranks):
    out = ranks[0]["two_float"]
    assert out["two_float"]
    assert out["x"][0].dtype == np.float32
    assert float(out["residual"][0]) < 1e-8 and float(out["gap"][0]) < 1e-8


def test_plain_versions_on_cpu_tensors(ranks):
    # 'pallas' runs K2/K3/K4's plain versions on CPU tensors: no launch
    assert ranks[0]["launches"] == {"ldlt": 0, "solve_ldlt": 0,
                                    "solve_ldlt_matrix": 0,
                                    "ldlt_solve_matrix": 0}


def test_refusals_at_four_ranks(ranks):
    kind, msg = ranks[0]["uneven"]
    assert kind == "ValueError" and "6 does not split over 4" in msg
    kind, msg = ranks[0]["other_device"]
    assert kind == "ValueError" and "this rank's device" in msg


def test_one_rank_mesh_equals_solve():
    """At one rank the collectives are the identity: solve_sharded is
    solve, bit for bit."""
    from ipmzoo_tpu_torch.parallel import make_mesh
    raw = jobs.make_coupled(4, 3, 2, seed=2)
    data = BlockQPData(**{k: torch.tensor(v) for k, v in raw.items()})
    mesh = make_mesh(devices=["cpu"])
    rs = SchurIPM(3, 2, mesh=mesh).solve_sharded(data)
    rl = SchurIPM(3, 2, device="cpu").solve(data)
    assert torch.equal(rs.x, rl.x) and torch.equal(rs.objective,
                                                   rl.objective)
    assert int(rs.iterations) == int(rl.iterations)
