"""``CompiledIPM(kernel='sharded')`` of the port on the CPU: one KKT
system row-sharded over 4 gloo ranks and factored by the panel-sharded
LDL^T in every Mehrotra iteration, mirroring tests/test_sharded_ipm.py.

One job (``torch_spawn_jobs.sharded_ipm_world4``) solves every case
sharded and with the port's local 'jnp' kernel on each rank.  The
sharded solve is held to the JAX package's ``kernel='jnp'`` solve at the
reference's bars (iterations equal, x 1e-9; 1e-8 for the ``Settings()``
case) and, on that case, to its ``kernel='sharded'`` solve on a mesh of
4 virtual CPU devices.  Every rank must return the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

import torch_spawn_jobs as jobs
from ipmzoo_tpu.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ipmzoo_tpu_torch import CompiledIPM
from ipmzoo_tpu_torch.models.convert import settings_from_reference
from ipmzoo_tpu_torch.parallel import make_mesh

WORLD = 4
CASES = jobs.TP_IPM_CASES
#: x against the reference's 'jnp' solve, as tests/test_sharded_ipm.py
X_TOL = {"matches_unsharded": 1e-9, "padding": 1e-9, "ineq": 1e-8}
BOX = Settings(inequalities=Bounds.NONE,
               inequality_handling=InequalityHandling.SLACKS)


@pytest.fixture(scope="module")
def ranks():
    return jobs.run(jobs.sharded_ipm_world4, WORLD)


def ref_settings(kw):
    return BOX if kw is None else Settings(**kw)


def ref_data(raw):
    return RefQPData(**{k: jnp.asarray(v) for k, v in raw.items()})


def ref_solve(name, **kw):
    raw, skw, n, m_ineq, _ = CASES[name]
    res = RefIPM(ref_settings(skw), n=n, m_ineq=m_ineq, dtype=jnp.float64,
                 tol=1e-8, **kw).solve(ref_data(raw))
    return np.asarray(res.x), int(res.iterations), bool(res.converged)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_the_reference_jnp_solve(ranks, name):
    out = ranks[0][name]["sharded"]
    x, iterations, converged = ref_solve(name, kernel="jnp")
    assert converged and bool(out["converged"])
    assert int(out["iterations"]) == iterations
    np.testing.assert_allclose(out["x"], x, rtol=0, atol=X_TOL[name])


@pytest.mark.parametrize("name", list(CASES))
def test_matches_the_local_jnp_solve(ranks, name):
    out = ranks[0][name]
    assert int(out["sharded"]["iterations"]) == \
        int(out["plain"]["iterations"])
    for k in ("x", "objective", "residual", "gap"):
        np.testing.assert_allclose(out["sharded"][k], out["plain"][k],
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_same_bits(ranks, name):
    first = ranks[0][name]["sharded"]
    for out in ranks[1:]:
        for k, v in out[name]["sharded"].items():
            np.testing.assert_array_equal(v, first[k])
    assert all(out[name]["device"] == "cpu" for out in ranks)


def test_identity_padding_any_dim(ranks):
    # n = 50 pads to 64 with panel 8 over 4 ranks (the reference pads to
    # 64 over its 8 devices too)
    out = ranks[0]["padding"]
    assert out["dim"] == 64 and out["panel"] == 8
    assert ranks[0]["matches_unsharded"]["dim"] == 64
    assert ranks[0]["ineq"]["dim"] == 32


def test_ineq_case_matches_the_reference_sharded_solve(ranks):
    raw, skw, n, m_ineq, panel = CASES["ineq"]
    mesh = ref_make_mesh((WORLD,), ("tp",), jax.devices()[:WORLD])
    x, iterations, converged = ref_solve("ineq", kernel="sharded",
                                         mesh=mesh, panel=panel)
    out = ranks[0]["ineq"]["sharded"]
    assert converged and int(out["iterations"]) == iterations
    np.testing.assert_allclose(out["x"], x, rtol=0, atol=1e-8)


@pytest.mark.parametrize("entry", ["batch", "compact"])
def test_solve_batch(ranks, entry):
    out = ranks[0][entry]
    for k in ("iterations", "converged"):
        np.testing.assert_array_equal(out["sharded"][k], out["plain"][k])
    assert out["sharded"]["converged"].all()
    np.testing.assert_allclose(out["sharded"]["x"], out["plain"]["x"],
                               rtol=1e-9, atol=1e-9)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[entry]["sharded"]["x"],
                                      out["sharded"]["x"])


@pytest.mark.parametrize("what", ["one", "batch"])
def test_init_state_and_steps(ranks, what):
    sharded, plain = ranks[0]["steps"][what]
    for a, b in zip(sharded, plain):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    for r in ranks[1:]:
        for a, b in zip(r["steps"][what][0], sharded):
            np.testing.assert_array_equal(a, b)


def test_constructor_refusals_at_four_ranks(ranks):
    out = ranks[0]
    assert out["other_device"][0] == "ValueError" and \
        "not this rank's device" in out["other_device"][1]
    assert out["no_axis"][0] == "ValueError" and "'dp'" in out["no_axis"][1]
    assert out["staged"] == 0


def test_default_panel_is_the_reference_rule(ranks):
    # min(128, aug_dim // ranks): 64 // 4
    mesh = ref_make_mesh((WORLD,), ("tp",), jax.devices()[:WORLD])
    ref = RefIPM(BOX, n=64, kernel="sharded", mesh=mesh)
    assert ranks[0]["default_panel"] == ref._sharded_panel == 16


# -- in this process: the constructor, and one rank without a group ----------

def test_requires_mesh():
    with pytest.raises(ValueError, match="mesh"):
        CompiledIPM(settings_from_reference(BOX), n=8, kernel="sharded",
                    device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        RefIPM(BOX, n=8, kernel="sharded")


@pytest.mark.parametrize("n,m_ineq,panel,world", [
    (64, 0, 8, 4), (50, 0, 8, 4), (50, 0, None, 4), (24, 8, 4, 4),
    (24, 8, None, 8), (7, 0, None, 8), (300, 0, None, 2)])
def test_sharded_dims_equal_the_reference(n, m_ineq, panel, world):
    settings = BOX if m_ineq == 0 else Settings()
    ref = RefIPM(settings, n=n, m_ineq=m_ineq, kernel="sharded",
                 mesh=ref_make_mesh((world,), ("tp",),
                                    jax.devices()[:world]), panel=panel)

    class Shape:
        # the constructor reads only the axis sizes of the mesh
        shape = {"tp": world}
        axis_names = ("tp",)
        device = torch.device("cpu")

    port = CompiledIPM(settings_from_reference(settings), n=n,
                       m_ineq=m_ineq, kernel="sharded", mesh=Shape(),
                       panel=panel)
    assert (port._sharded_dim, port._sharded_panel) == \
        (ref._sharded_dim, ref._sharded_panel)
    assert port.device == torch.device("cpu")


def test_refusals_follow_the_reference():
    mesh = make_mesh((1,), ("tp",), ["cpu"])
    with pytest.raises(ValueError, match="kernel='auto'/'ldlt' only"):
        CompiledIPM(settings_from_reference(BOX), n=4, kernel="sharded",
                    mesh=mesh, two_float=True)
    with pytest.raises(ValueError, match="kernel='auto'/'ldlt' only"):
        RefIPM(BOX, n=4, kernel="sharded", two_float=True,
               mesh=ref_make_mesh((1,), ("tp",), jax.devices()[:1]))
    indefinite = Settings(inequalities=Bounds.NONE,
                          variable_bounds=Bounds.NONE, equalities=True,
                          equality_handling=EqualityHandling.NONE)
    with pytest.raises(NotImplementedError, match="indefinite"):
        CompiledIPM(settings_from_reference(indefinite), n=3, m_eq=1,
                    kernel="sharded", mesh=mesh)
    with pytest.raises(NotImplementedError, match="indefinite"):
        RefIPM(indefinite, n=3, m_eq=1, kernel="sharded",
               mesh=ref_make_mesh((1,), ("tp",), jax.devices()[:1]))


@pytest.mark.parametrize("name", list(CASES))
def test_one_rank_mesh_equals_jnp(name):
    raw, skw, n, m_ineq, panel = CASES[name]
    mesh = make_mesh((1,), ("tp",), ["cpu"])
    assert mesh.group is None
    data = jobs._qp(raw)
    kw = dict(n=n, m_ineq=m_ineq, dtype=torch.float64, tol=1e-8)
    settings = jobs._tp_settings(skw)
    rs = CompiledIPM(settings, kernel="sharded", mesh=mesh, panel=panel,
                     **kw).solve(data)
    rp = CompiledIPM(settings, kernel="jnp", device="cpu", **kw).solve(data)
    assert bool(rs.converged) and int(rs.iterations) == int(rp.iterations)
    np.testing.assert_allclose(rs.x.numpy(), rp.x.numpy(), rtol=0,
                               atol=1e-12)
    assert mesh.host_syncs == 0
