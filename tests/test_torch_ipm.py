"""CompiledIPM of the port (ipmzoo_tpu_torch/models/ipm.py) on the CPU in
float64, against the reference's oracle trace and against the reference
solver itself (kernel 'auto', i.e. the Pallas LDL^T kernels in interpret
mode under vmap) on the same numpy inputs.

Tolerances: the demo-QP trace as tests/test_ipm.py pins it; 5-step
state parity at rtol 1e-10, with an absolute floor of 1e-12 for entries
near zero (residual norms after a few steps are cancellations of O(1)
terms); batched solves x within 1e-9 and equal per-instance iteration
counts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models import CompiledIPM, QPData
from ipmzoo_tpu_torch.models.convert import (qpdata_from_numpy,
                                             result_to_numpy,
                                             state_from_numpy,
                                             state_to_numpy)
from ipmzoo_tpu_torch.ops import cuda_ldlt


def demo_qp():
    return QPData.make(
        Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
        A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0], u_A_ineq=[1.2],
        l_x=[0.0, 0.0], u_x=[10.0, 10.0], dtype=torch.float64, device="cpu")


def numpy_batch(B, n, m, m_eq=0, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    return RefQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(B, n)),
        A_ineq=rng.normal(size=(B, m, n)),
        l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
        A_eq=rng.normal(size=(B, m_eq, n)),
        b_eq=rng.normal(size=(B, m_eq)),
        l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0))


def as_jax(data):
    return jax.tree_util.tree_map(jnp.asarray, data)


class TestDemoQP:
    def test_slacked_slacks_reference_trace(self):
        """The reference oracle's trace (tests/test_ipm.py)."""
        s = CompiledIPM(port_settings(Settings(
            inequality_handling=InequalityHandling.SLACKED_SLACKS)), 2, 1,
            device="cpu")
        res = s.solve(demo_qp())
        assert bool(res.converged) and not bool(res.diverged)
        assert int(res.iterations) == 12
        np.testing.assert_allclose(float(res.residual), 1.932123e-10,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(res.gap), 4.940198e-11, rtol=1e-4)
        np.testing.assert_allclose(res.x.numpy(), [1.2, 0.0], atol=1e-10)
        np.testing.assert_allclose(float(res.objective), -11.28, rtol=1e-9)

    def test_slacks_converges_where_reference_stalls(self):
        s = CompiledIPM(port_settings(Settings(
            inequality_handling=InequalityHandling.SLACKS)), 2, 1,
            device="cpu")
        res = s.solve(demo_qp())
        assert bool(res.converged)
        assert int(res.iterations) <= 10
        np.testing.assert_allclose(res.x.numpy(), [1.2, 0.0], atol=1e-8)
        np.testing.assert_allclose(float(res.objective), -11.28, rtol=1e-8)

    def test_warm_start_from_solution(self):
        s = CompiledIPM(port_settings(Settings()), 2, 1, device="cpu")
        cold = s.solve(demo_qp())
        warm = s.solve(demo_qp(), warm_start=cold.variables)
        assert bool(warm.converged)
        assert int(warm.iterations) < int(cold.iterations)
        np.testing.assert_allclose(warm.x.numpy(), [1.2, 0.0], atol=1e-8)


# formulation lattice points that the reference factors in its 'ldlt'
# mode (quasi-definite augmented systems), with their m_eq
LATTICE = [
    (Settings(), 0),
    (Settings(inequality_handling=InequalityHandling.SLACKS), 0),
    (Settings(inequalities=Bounds.LOWER, variable_bounds=Bounds.UPPER), 0),
    (Settings(equalities=True,
              equality_handling=EqualityHandling
              .PENALTY_FUNCTION_WITH_EXTRA_DUAL), 2),
    (Settings(equalities=True,
              equality_handling=EqualityHandling.SLACKED_SLACKS,
              inequality_handling=InequalityHandling.NAIVE_SLACKS), 2),
    (Settings(equalities=True,
              equality_handling=EqualityHandling.REGULARIZATION,
              inequality_handling=InequalityHandling.SLACKS,
              variable_bounds=Bounds.LOWER), 2),
]


def assert_state_close(port, ref):
    a, b = state_to_numpy(port), ref
    pairs = list(zip(a["vars"], [np.asarray(v) for v in b.vars]))
    pairs += [(a[k], np.asarray(getattr(b, k)))
              for k in ("mu", "residual", "gap")]
    for p, r in pairs:
        np.testing.assert_allclose(p, r, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(a["iteration"], np.asarray(b.iteration))


@pytest.mark.parametrize("gondzio", [0, 2])
@pytest.mark.parametrize("idx", range(len(LATTICE)))
def test_five_steps_match_reference(idx, gondzio):
    settings, m_eq = LATTICE[idx]
    n, m = 5, 3
    data = numpy_batch(6, n, m, m_eq, seed=idx)
    ref = RefIPM(settings, n, m, m_eq)
    assert ref._mode == "ldlt"
    step = jax.jit(jax.vmap(functools.partial(ref._step_impl,
                                              gondzio=gondzio)))
    jd = as_jax(data)
    r_state = jax.jit(jax.vmap(ref.init_state))(jd)

    port = CompiledIPM(port_settings(settings), n, m, m_eq, device="cpu")
    td = qpdata_from_numpy(data, device="cpu")
    p_state = port.init_state(td)
    assert_state_close(p_state, r_state)
    for _ in range(5):
        r_state = step(r_state, jd)
        p_state = port.step(p_state, td) if gondzio == 0 else \
            port._step_impl(p_state, td, gondzio=gondzio)
    assert_state_close(p_state, r_state)


def test_symbolic_taylor_corrector_matches_reference():
    n, m = 5, 3
    data = numpy_batch(6, n, m, seed=7)
    ref = RefIPM(Settings(), n, m, taylor="symbolic")
    step = jax.jit(jax.vmap(ref._step_impl))
    jd = as_jax(data)
    r_state = jax.jit(jax.vmap(ref.init_state))(jd)
    port = CompiledIPM(port_settings(Settings()), n, m, taylor="symbolic",
                       device="cpu")
    td = qpdata_from_numpy(data, device="cpu")
    p_state = port.init_state(td)
    for _ in range(5):
        r_state, p_state = step(r_state, jd), port.step(p_state, td)
    assert_state_close(p_state, r_state)


def test_step_continues_from_a_reference_state():
    # a reference state carried into the port steps on as the
    # reference's own would
    n, m = 5, 3
    data = numpy_batch(4, n, m, seed=8)
    ref = RefIPM(Settings(), n, m)
    jd = as_jax(data)
    r_state = jax.jit(jax.vmap(ref.init_state))(jd)
    r_state = jax.jit(jax.vmap(ref._step_impl))(r_state, jd)
    port = CompiledIPM(port_settings(Settings()), n, m, device="cpu")
    p_state = port.step(state_from_numpy(r_state, device="cpu"),
                        qpdata_from_numpy(data, device="cpu"))
    assert_state_close(p_state,
                       jax.jit(jax.vmap(ref._step_impl))(r_state, jd))


@pytest.mark.parametrize("options", [{}, {"scale_tol": True, "refine": 1}],
                         ids=["default", "scale_tol_refine"])
def test_solve_batch_matches_reference(options):
    n, m, B = 6, 3, 16
    data = numpy_batch(B, n, m, seed=11)
    ref = RefIPM(Settings(), n, m, **options).solve_batch(as_jax(data))
    port = CompiledIPM(port_settings(Settings()), n, m, device="cpu",
                       **options)
    cuda_ldlt.reset_launch_counts()
    res = port.solve_batch(qpdata_from_numpy(data, device="cpu"))
    assert cuda_ldlt.launches == {"ldlt": 0, "solve_ldlt": 0,
                                  "solve_ldlt_matrix": 0,
                                  "ldlt_solve_matrix": 0}
    out = result_to_numpy(res)
    assert out["converged"].all() and np.asarray(ref.converged).all()
    np.testing.assert_array_equal(out["iterations"],
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(out["x"], np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(out["objective"], np.asarray(ref.objective),
                               rtol=1e-9)
    # one device round trip per iteration of the masked loop, plus the
    # final test that finds nothing active
    assert port.host_syncs == int(out["iterations"].max()) + 1


def test_mu_floor_tied_to_dtype():
    s32 = CompiledIPM(port_settings(Settings()), 4, 2, dtype=torch.float32,
                      device="cpu")
    s64 = CompiledIPM(port_settings(Settings()), 4, 2, device="cpu")
    assert s32.mu_floor == RefIPM(Settings(), 4, 2,
                                  dtype=jnp.float32).mu_floor
    assert s64.mu_floor == pytest.approx(np.finfo(np.float64).eps ** 2)
    assert CompiledIPM(port_settings(Settings()), 4, 2, mu_floor=1e-20,
                       device="cpu").mu_floor == 1e-20


def test_nan_data_flags_diverged():
    data = QPData.make(
        Q=[[np.nan, 0.0], [0.0, 1.0]], c=[0.0, 0.0],
        l_x=[-1.0, -1.0], u_x=[1.0, 1.0], device="cpu")
    s = CompiledIPM(port_settings(Settings(inequalities=Bounds.NONE)), n=2,
                    device="cpu")
    res = s.solve(data)
    assert bool(res.diverged)
    assert not bool(res.converged)
    assert int(res.iterations) < 5


def test_gondzio_rounds_keep_the_solution():
    n, m = 12, 5
    data = qpdata_from_numpy(numpy_batch(4, n, m, seed=3), device="cpu")
    r0 = CompiledIPM(port_settings(Settings()), n, m,
                     device="cpu").solve_batch(data)
    r2 = CompiledIPM(port_settings(Settings()), n, m, gondzio=2,
                     device="cpu").solve_batch(data)
    assert bool(r0.converged.all()) and bool(r2.converged.all())
    assert bool((r2.iterations <= r0.iterations).all())
    np.testing.assert_allclose(r2.x.numpy(), r0.x.numpy(), atol=1e-7)


class TestRejects:
    """What the port refuses, it refuses as the reference; the kernel
    modes solve."""

    @pytest.mark.parametrize("kernel", ["sharded"])
    def test_unported_kernel_modes(self, kernel):
        # every kernel mode of the reference is ported; 'sharded' without
        # a mesh raises as the reference's does
        with pytest.raises(ValueError, match="requires mesh="):
            CompiledIPM(port_settings(Settings()), kernel=kernel,
                        device="cpu", n=4, m_ineq=2)
        with pytest.raises(ValueError, match="requires mesh="):
            RefIPM(Settings(), kernel=kernel, n=4, m_ineq=2)

    @pytest.mark.parametrize("kernel", ["jnp", "block", "blockg", "lu",
                                        "regldlt", "normal", "nd"])
    def test_kernel_modes_solve(self, kernel):
        # every mode the reference has besides 'sharded' solves the
        # batch as the dense LDL^T mode does ('nd' on a dense pattern of
        # order 400 falls back to the block mode the auto rule picks)
        kw = dict(n=6, m_ineq=2)
        if kernel == "nd":
            kw = dict(n=398, m_ineq=2,
                      nd_pattern=np.ones((400, 400), bool))
        s = CompiledIPM(port_settings(Settings()), kernel=kernel,
                        device="cpu", **kw)
        if kernel == "nd":
            assert s.nd_fell_back and s._mode == "block"
            return
        data = qpdata_from_numpy(numpy_batch(3, 6, 2, seed=4), device="cpu")
        res = s.solve_batch(data)
        want = CompiledIPM(port_settings(Settings()), 6, 2,
                           device="cpu").solve_batch(data)
        assert bool(res.converged.all())
        np.testing.assert_allclose(res.x.numpy(), want.x.numpy(),
                                   atol=1e-7)

    def test_mesh(self):
        # kernel='sharded' on a one-rank mesh solves the batch as the
        # dense LDL^T mode does; another mode reads no mesh, as the
        # reference's
        from ipmzoo_tpu_torch.parallel import make_mesh
        mesh = make_mesh((1,), ("tp",), ["cpu"])
        data = qpdata_from_numpy(numpy_batch(3, 6, 2, seed=4), device="cpu")
        s = CompiledIPM(port_settings(Settings()), 6, 2, kernel="sharded",
                        mesh=mesh, panel=4)
        assert s._mode == "sharded" and s.device == torch.device("cpu")
        assert (s._sharded_dim, s._sharded_panel) == (8, 4)
        res = s.solve_batch(data)
        want = CompiledIPM(port_settings(Settings()), 6, 2,
                           device="cpu").solve_batch(data)
        assert bool(res.converged.all())
        np.testing.assert_array_equal(res.iterations.numpy(),
                                      want.iterations.numpy())
        np.testing.assert_allclose(res.x.numpy(), want.x.numpy(),
                                   atol=1e-10)
        other = CompiledIPM(port_settings(Settings()), 4, 2, mesh=object(),
                            device="cpu")
        assert other._mode == RefIPM(Settings(), 4, 2,
                                     mesh=object())._mode == "ldlt"

    def test_indefinite_formulation(self):
        # 'auto' takes the signed-regularised LDL^T, as the reference
        settings = Settings(inequalities=Bounds.NONE,
                            variable_bounds=Bounds.NONE, equalities=True,
                            equality_handling=EqualityHandling.NONE)
        s = CompiledIPM(port_settings(settings), n=3, m_eq=1, device="cpu")
        assert s._mode == RefIPM(settings, n=3, m_eq=1)._mode == "regldlt"
        res = s.solve(QPData.make(Q=np.eye(3), c=[-1.0, 0.0, 0.0],
                                  A_eq=np.ones((1, 3)), b_eq=[1.0],
                                  device="cpu"))
        assert bool(res.converged)
        np.testing.assert_allclose(res.x.numpy(), [1.0, 0.0, 0.0],
                                   atol=1e-9)

    def test_large_auto_system(self):
        # the reference's 'auto' hands a 2x2 system from n = 384 to 'block'
        s = CompiledIPM(port_settings(Settings()), 400, 8, device="cpu")
        assert s._mode == RefIPM(Settings(), 400, 8)._mode == "block"

    def test_data_on_another_device(self):
        s = CompiledIPM(port_settings(Settings()), 2, 1, device="cpu")
        with pytest.raises(ValueError, match="meta"):
            s.solve_batch(tree_to_meta(demo_qp()))

    def test_data_of_other_sizes(self):
        s = CompiledIPM(port_settings(Settings()), 3, 1, device="cpu")
        with pytest.raises(ValueError, match="sizes"):
            s.solve(demo_qp())

    def test_float32_data_is_cast_to_the_working_dtype(self):
        s = CompiledIPM(port_settings(Settings()), 2, 1, device="cpu")
        res = s.solve(demo_qp().to(dtype=torch.float32))
        assert res.x.dtype == torch.float64 and bool(res.converged)


def tree_to_meta(data):
    one = data.to(device="meta")
    return QPData(**{k: getattr(one, k).unsqueeze(0)
                     for k in ("Q", "c", "A_ineq", "l_A_ineq", "u_A_ineq",
                               "A_eq", "b_eq", "l_x", "u_x")})
