"""SchurIPM of the port (ipmzoo_tpu_torch/parallel/schur.py) on the CPU
against the reference's SchurIPM on the same numpy data, mirroring the
non-sharded cases of tests/test_schur.py.

Parity in float64: iterations equal and x within 1e-10 (the two differ
only in summation order).  The reference runs its block kernels as its
own tests run them: 'jnp', and 'pallas' in interpret mode.  The port's
``two_float`` solves in float64 where the reference carries double-single
pairs; those cases are held to the reference's own bars for that mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.parallel.schur import BlockQPData as RefBlockQPData
from ipmzoo_tpu.parallel.schur import SchurIPM as RefSchurIPM
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.convert import block_qp_from_numpy
from ipmzoo_tpu_torch.ops import cuda_ldlt
from ipmzoo_tpu_torch.parallel import BlockQPData, SchurIPM

TORCH = {"float64": torch.float64, "float32": torch.float32}


def make_coupled(blocks, n, m_c, seed=0):
    """tests/test_schur.py's coupled QP, as numpy leaves."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(blocks, n, n))
    return RefBlockQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(blocks, n)),
        F=rng.normal(size=(blocks, m_c, n)) / blocks,
        l_x=np.full((blocks, n), -3.0), u_x=np.full((blocks, n), 3.0),
        g=rng.normal(size=(m_c,)) * 0.1)


def make_illconditioned(blocks, n, m_c, seed=0, cond=1e8, push=0.0):
    """tests/test_schur.py's blocks of condition number ``cond``."""
    rng = np.random.default_rng(seed)
    Qs = np.empty((blocks, n, n))
    for b in range(blocks):
        V, _ = np.linalg.qr(rng.normal(size=(n, n)))
        Qs[b] = (V * np.logspace(0.0, -np.log10(cond), n)) @ V.T
    return RefBlockQPData(
        Q=Qs, c=rng.normal(size=(blocks, n)) - push,
        F=rng.normal(size=(blocks, m_c, n)) / blocks,
        l_x=np.full((blocks, n), -3.0), u_x=np.full((blocks, n), 3.0),
        g=rng.normal(size=(m_c,)) * 0.1)


def stack(raws):
    return RefBlockQPData(*[np.stack(leaves)
                            for leaves in zip(*[(r.Q, r.c, r.F, r.l_x,
                                                 r.u_x, r.g) for r in raws])])


def both(raw, n, m_c, entry="solve", dtype="float64", **kw):
    """The same entry of the reference and the port on the same numpy
    data; returns (reference, port) results as numpy dicts."""
    ref = RefSchurIPM(n, m_c, dtype=getattr(jnp, dtype), **kw)
    r = getattr(ref, entry)(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, getattr(jnp, dtype)), raw))
    port = SchurIPM(n, m_c, dtype=TORCH[dtype], device="cpu", **kw)
    p = getattr(port, entry)(block_qp_from_numpy(raw, dtype=TORCH[dtype],
                                                 device="cpu"))
    fields = ("x", "nu", "objective", "iterations", "residual", "gap",
              "converged")
    return ({f: np.asarray(getattr(r, f)) for f in fields},
            {f: getattr(p, f).numpy() for f in fields})


def assert_parity(r, p):
    """Iterations and converged equal; x and nu within 1e-10."""
    np.testing.assert_array_equal(p["converged"], r["converged"])
    np.testing.assert_array_equal(p["iterations"], r["iterations"])
    np.testing.assert_allclose(p["x"], r["x"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(p["nu"], r["nu"], rtol=1e-10, atol=1e-10)
    assert p["x"].shape == r["x"].shape


def dense_reference(raw):
    """The coupled QP as one dense QP, solved by scipy."""
    from scipy import optimize
    B, n = raw.c.shape
    F = np.concatenate(list(raw.F), axis=1)

    def fun(x):
        xb = x.reshape(B, n)
        return float(0.5 * np.einsum("bi,bij,bj->", xb, raw.Q, xb) +
                     raw.c.ravel() @ x)

    def jac(x):
        return np.einsum("bij,bj->bi", raw.Q, x.reshape(B, n)).ravel() + \
            raw.c.ravel()

    res = optimize.minimize(
        fun, np.zeros(B * n), jac=jac, method="SLSQP",
        constraints=[optimize.LinearConstraint(F, raw.g, raw.g)],
        bounds=optimize.Bounds(raw.l_x.ravel(), raw.u_x.ravel()),
        options={"maxiter": 500, "ftol": 1e-12})
    assert res.success, res.message
    return res.x.reshape(B, n), res.fun


BLOCK_KERNELS = pytest.mark.parametrize("block_kernel", ["jnp", "pallas"])


class TestLocal:
    @BLOCK_KERNELS
    def test_converges_and_matches_scipy(self, block_kernel):
        raw = make_coupled(blocks=4, n=5, m_c=2, seed=1)
        r, p = both(raw, 5, 2, block_kernel=block_kernel)
        assert p["converged"]
        assert_parity(r, p)
        x_ref, f_ref = dense_reference(raw)
        np.testing.assert_allclose(p["x"], x_ref, atol=1e-5)
        np.testing.assert_allclose(p["objective"], f_ref, rtol=1e-6)

    @BLOCK_KERNELS
    def test_coupling_feasibility(self, block_kernel):
        raw = make_coupled(blocks=6, n=4, m_c=3, seed=2)
        r, p = both(raw, 4, 3, block_kernel=block_kernel)
        assert p["converged"]
        assert_parity(r, p)
        coupling = np.einsum("bij,bj->i", raw.F, p["x"]) - raw.g
        np.testing.assert_allclose(coupling, 0.0, atol=1e-7)

    @BLOCK_KERNELS
    def test_active_bounds(self, block_kernel):
        # a strong linear term pushes x to the box bound
        raw = make_coupled(blocks=2, n=3, m_c=1, seed=3)
        raw = RefBlockQPData(Q=raw.Q, c=raw.c - 50.0, F=raw.F * 0.0,
                             l_x=raw.l_x, u_x=raw.u_x, g=raw.g * 0.0)
        r, p = both(raw, 3, 1, block_kernel=block_kernel)
        assert p["converged"]
        assert_parity(r, p)
        np.testing.assert_allclose(p["x"], 3.0, atol=1e-6)


class TestSymbolicCrossCheck:
    def test_matches_compiled_ipm_on_monolithic_form(self):
        """The coupled QP posed as one equality-constrained QP through the
        port's CompiledIPM reaches the same optimum."""
        from ipmzoo_tpu.formulations import EqualityHandling, Settings
        from ipmzoo_tpu_torch.models import CompiledIPM, QPData

        B, n, m_c = 4, 6, 3
        raw = make_coupled(B, n, m_c, seed=5)
        r = SchurIPM(n, m_c, tol=1e-9,
                     device="cpu").solve(block_qp_from_numpy(raw,
                                                             device="cpu"))
        assert bool(r.converged)
        N = B * n
        Qm = np.zeros((N, N))
        for b in range(B):
            Qm[b * n:(b + 1) * n, b * n:(b + 1) * n] = raw.Q[b]
        mono = QPData.make(Q=Qm, c=raw.c.ravel(),
                           A_eq=np.concatenate(list(raw.F), axis=1),
                           b_eq=raw.g, l_x=raw.l_x.ravel(),
                           u_x=raw.u_x.ravel(), device="cpu")
        settings = Settings(equalities=True,
                            equality_handling=EqualityHandling.REGULARIZATION)
        rm = CompiledIPM(port_settings(settings), n=N, m_eq=m_c, tol=1e-9,
                         device="cpu").solve(mono)
        assert bool(rm.converged)
        np.testing.assert_allclose(r.x.numpy().ravel(), rm.x.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(float(r.objective), float(rm.objective),
                                   rtol=1e-8)


class TestIllConditioned:
    def test_cond_1e8_converges(self):
        raw = make_illconditioned(blocks=4, n=6, m_c=2, seed=7)
        r, p = both(raw, 6, 2, tol=1e-7)
        assert p["converged"], (p["residual"], p["gap"])
        assert_parity(r, p)
        assert np.all(np.isfinite(p["x"]))
        coupling = np.einsum("bij,bj->i", raw.F, p["x"]) - raw.g
        np.testing.assert_allclose(coupling, 0.0, atol=1e-7)

    def test_cond_1e8_active_bounds(self):
        # bad spectrum and active box bounds: barrier diagonals ~1/s stack
        # on the 1e8 condition number at the end of the solve
        raw = make_illconditioned(blocks=3, n=5, m_c=1, seed=8, push=20.0)
        r, p = both(raw, 5, 1, tol=1e-7)
        assert p["converged"], (p["residual"], p["gap"])
        assert_parity(r, p)
        assert np.all(p["x"] <= 3.0 + 1e-9) and np.all(p["x"] >= -3.0 - 1e-9)


class TestPallasBlockKernel:
    def test_pallas_equals_jnp(self):
        # float32 at tol 1e-4, as tests/test_schur.py: port 'pallas'
        # (K2/K3/K4's plain versions here) against port 'jnp' and against
        # the reference's Pallas kernels in interpret mode
        raw = make_coupled(blocks=3, n=4, m_c=2, seed=11)
        kw = dict(dtype="float32", tol=1e-4)
        r_p, p_p = both(raw, 4, 2, block_kernel="pallas", **kw)
        _, p_j = both(raw, 4, 2, block_kernel="jnp", **kw)
        assert p_p["converged"] and p_j["converged"] and r_p["converged"]
        np.testing.assert_allclose(p_p["x"], p_j["x"], atol=1e-4)
        np.testing.assert_allclose(p_p["x"], r_p["x"], atol=1e-4)
        assert p_p["x"].dtype == np.float32

    def test_cache_invalidation_on_mutation(self):
        # the port keeps no compiled program: a mutated tol takes effect
        data = block_qp_from_numpy(make_coupled(blocks=2, n=3, m_c=1,
                                                seed=12), device="cpu")
        ipm = SchurIPM(3, 1, tol=1e-2, max_iter=100, device="cpu")
        r1 = ipm.solve(data)
        ipm.tol = 1e-9
        r2 = ipm.solve(data)
        assert float(r2.residual) < 1e-9
        assert int(r2.iterations) > int(r1.iterations)

    def test_cpu_runs_leave_kernel_counts_at_zero(self):
        cuda_ldlt.reset_launch_counts()
        ipm = SchurIPM(4, 2, block_kernel="pallas", device="cpu")
        assert ipm.block_kernel == "pallas"
        assert SchurIPM(4, 2, device="cpu").block_kernel == "jnp"
        assert bool(ipm.solve(block_qp_from_numpy(make_coupled(blocks=3, n=4,
                                                               m_c=2, seed=1),
                                                  device="cpu")).converged)
        assert cuda_ldlt.launches == {"ldlt": 0, "solve_ldlt": 0,
                                      "solve_ldlt_matrix": 0,
                                      "ldlt_solve_matrix": 0}


class TestTwoFloat:
    """``two_float`` solves in float64.  The reference's pin that plain
    float32 floors above 1e-8 still holds for the port's plain float32."""

    def test_f32_plain_floors_above_1e8(self):
        data = block_qp_from_numpy(make_coupled(blocks=8, n=16, m_c=4, seed=3),
                                   dtype=torch.float32, device="cpu")
        ipm = SchurIPM(16, 4, dtype=torch.float32, tol=1e-8, max_iter=40,
                       two_float=False, device="cpu")
        assert ipm.compute_dtype == torch.float32
        assert not bool(ipm.solve(data).converged), \
            "plain f32 reached 1e-8: the two_float mode is redundant"

    def test_auto_enables_two_float_on_f32_tight_tol(self):
        data = block_qp_from_numpy(make_coupled(blocks=8, n=16, m_c=4, seed=3),
                                   dtype=torch.float32, device="cpu")
        ipm = SchurIPM(16, 4, dtype=torch.float32, tol=1e-8, max_iter=40,
                       device="cpu")
        assert ipm.two_float and ipm.compute_dtype == torch.float64
        res = ipm.solve(data)
        assert bool(res.converged)
        assert res.x.dtype == res.objective.dtype == torch.float32
        assert res.residual.dtype == torch.float32
        # the mu floor stays the working dtype's, as the reference's
        assert ipm.mu_floor == float(np.finfo(np.float32).eps) ** 2
        assert not SchurIPM(16, 4, dtype=torch.float32, tol=1e-5,
                            device="cpu").two_float
        assert not SchurIPM(16, 4, dtype=torch.float32, tol=1e-6,
                            device="cpu").two_float
        assert not SchurIPM(16, 4, dtype=torch.float64, device="cpu").two_float

    def test_f32_two_float_reaches_1e8_and_matches_f64(self):
        raw = make_coupled(blocks=8, n=16, m_c=4, seed=3)
        r64 = RefSchurIPM(16, 4, dtype=jnp.float64, tol=1e-8).solve(
            jax.tree_util.tree_map(jnp.asarray, raw))
        r_tf, p_tf = both(raw, 16, 4, dtype="float32", tol=1e-8,
                          max_iter=40, two_float=True, refine=2)
        assert bool(r64.converged) and p_tf["converged"] and r_tf["converged"]
        # the reference's bars for its pairs: iterations within 1 of f64,
        # x to float32 rounding
        assert abs(int(p_tf["iterations"]) - int(r64.iterations)) <= 1
        assert abs(int(p_tf["iterations"]) - int(r_tf["iterations"])) <= 1
        np.testing.assert_allclose(p_tf["x"],
                                   np.asarray(r64.x).astype(np.float32),
                                   atol=5e-6)
        np.testing.assert_allclose(p_tf["x"], r_tf["x"], atol=5e-6)

    def test_two_float_pallas_kernel(self):
        data = block_qp_from_numpy(make_coupled(blocks=8, n=16, m_c=4, seed=7),
                                   dtype=torch.float32, device="cpu")
        kw = dict(dtype=torch.float32, tol=1e-8, max_iter=40,
                  two_float=True, refine=2)
        res = SchurIPM(16, 4, block_kernel="pallas", device="cpu",
                       **kw).solve(data)
        assert bool(res.converged)
        res_j = SchurIPM(16, 4, block_kernel="jnp", device="cpu",
                         **kw).solve(data)
        assert int(res.iterations) == int(res_j.iterations)
        np.testing.assert_allclose(res.x.numpy(), res_j.x.numpy(),
                                   atol=1e-6)


class TestSolveBatch:
    @BLOCK_KERNELS
    def test_batch_matches_lone_solves(self, block_kernel):
        raws = [make_coupled(blocks=4, n=6, m_c=2, seed=s) for s in range(3)]
        r, p = both(stack(raws), 6, 2, entry="solve_batch", tol=1e-8,
                    block_kernel=block_kernel)
        assert p["converged"].all()
        assert_parity(r, p)
        ipm = SchurIPM(6, 2, tol=1e-8, block_kernel=block_kernel, device="cpu")
        ipm.host_syncs = 0
        rb = ipm.solve_batch(block_qp_from_numpy(stack(raws), device="cpu"))
        # one round trip per iteration of the slowest instance, plus the
        # check that finds nothing active
        assert ipm.host_syncs == int(rb.iterations.max()) + 1
        for i, raw in enumerate(raws):
            ri = ipm.solve(block_qp_from_numpy(raw, device="cpu"))
            # a finished instance is frozen, so its lone solve is the same
            assert int(rb.iterations[i]) == int(ri.iterations)
            np.testing.assert_allclose(rb.x[i].numpy(), ri.x.numpy(),
                                       rtol=1e-12, atol=1e-12)

    def test_batch_two_float(self):
        raws = [make_coupled(blocks=4, n=6, m_c=2, seed=s) for s in range(3)]
        kw = dict(tol=1e-8, max_iter=40, two_float=True, refine=2)
        r, p = both(stack(raws), 6, 2, entry="solve_batch", dtype="float32",
                    **kw)
        assert p["converged"].all() and r["converged"].all()
        np.testing.assert_allclose(p["x"], r["x"], atol=1e-5)
        ipm = SchurIPM(6, 2, dtype=torch.float32, device="cpu", **kw)
        r0 = ipm.solve(block_qp_from_numpy(raws[0], dtype=torch.float32,
                                           device="cpu"))
        np.testing.assert_allclose(p["x"][0], r0.x.numpy(), atol=1e-5)


class TestRejects:
    def test_solve_sharded_is_not_ported(self):
        """Without a mesh, solve_sharded raises as the reference's does
        (its sharded cases: tests/test_torch_schur_sharded.py)."""
        data = block_qp_from_numpy(make_coupled(blocks=2, n=3, m_c=1),
                                   device="cpu")
        with pytest.raises(ValueError, match="solve_sharded needs a mesh"):
            SchurIPM(3, 1, device="cpu").solve_sharded(data)

    def test_data_of_other_sizes_or_devices(self):
        data = block_qp_from_numpy(make_coupled(blocks=2, n=3, m_c=1),
                                   device="cpu")
        with pytest.raises(ValueError, match="sizes"):
            SchurIPM(4, 1, device="cpu").solve(data)
        with pytest.raises(ValueError, match="axes"):
            SchurIPM(3, 1, device="cpu").solve_batch(data)
        with pytest.raises(ValueError, match="meta"):
            SchurIPM(3, 1, device="cpu").solve(data.to(device="meta"))
        with pytest.raises(ValueError, match="block_kernel"):
            SchurIPM(3, 1, block_kernel="triton", device="cpu")

    def test_cuda_solver_takes_only_the_kernels(self):
        # the plain 'jnp' path is for CPU tensors; a CUDA solver (built
        # without touching a card) resolves 'auto' to the kernels
        with pytest.raises(ValueError, match="CPU tensors"):
            SchurIPM(3, 1, device="cuda", block_kernel="jnp")
        assert SchurIPM(3, 1, device="cuda").block_kernel == "pallas"
        assert SchurIPM(3, 1, device="cuda",
                        block_kernel="pallas").block_kernel == "pallas"

    def test_float32_data_is_cast_to_the_working_dtype(self):
        data = block_qp_from_numpy(make_coupled(blocks=2, n=3, m_c=1),
                                   dtype=torch.float32, device="cpu")
        res = SchurIPM(3, 1, device="cpu").solve(data)
        assert res.x.dtype == torch.float64 and bool(res.converged)
        assert isinstance(data, BlockQPData)
