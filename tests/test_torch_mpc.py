"""The port's structured MPC engine (ops/riccati.py, models/mpc.py)
against the JAX package's, on the CPU in float64.

The inputs are made with numpy from a seed (``random_mpc`` draws the
reference's arrays bit for bit) and fed to both sides through
``models/convert.py``.  Neither side reaches a Pallas kernel: the
reference's Riccati recursion is XLA code, the port's batched library
calls.  Tolerances: the two sides differ only in the order of sums
inside library calls, so the factors and one Newton solve agree to rtol
1e-10, one IPM step to rtol 1e-9, and whole solves take the same
iterations with u, x and y within 1e-8.  The tests of
``tests/test_mpc.py`` are mirrored on the port (class ``TestMirror``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.models import mpc as ref_mpc
from ipmzoo_tpu.ops import riccati as ref_riccati
from ipmzoo_tpu_torch.formulations import Settings
from ipmzoo_tpu_torch.models import CompiledIPM, MPCData, RiccatiIPM
from ipmzoo_tpu_torch.models import convert
from ipmzoo_tpu_torch.models.mpc import MPCState, condense, random_mpc
from ipmzoo_tpu_torch.models.state import tree_map
from ipmzoo_tpu_torch.ops.riccati import (RiccatiFactors, riccati_factor,
                                          riccati_kkt_dense, riccati_solve)

CPU = "cpu"


def port_data(ref_data):
    return convert.mpc_data_from_numpy(ref_data, device=CPU)


def _rand_lqr(T, ns, nu, seed=0, batch=None):
    """A random block-tridiagonal KKT system as numpy arrays (Qt, Rt, A,
    B, rx, ru, d); ``batch`` stacks that many of them, drawn from seeds
    seed, seed + 1, ..."""
    if batch is not None:
        parts = [_rand_lqr(T, ns, nu, seed + i) for i in range(batch)]
        return tuple(np.stack(p) for p in zip(*parts))
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(T, ns, ns))
    Qt = np.einsum("kij,klj->kil", M, M) / ns + np.eye(ns)
    Mr = rng.normal(size=(T, nu, nu))
    Rt = np.einsum("kij,klj->kil", Mr, Mr) / nu + np.eye(nu)
    A = 0.5 * rng.normal(size=(T, ns, ns))
    B = rng.normal(size=(T, ns, nu))
    rx = rng.normal(size=(T, ns))
    ru = rng.normal(size=(T, nu))
    d = rng.normal(size=(T, ns))
    return Qt, Rt, A, B, rx, ru, d


def _torch(arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _close(port, ref, rtol, atol=1e-12, what=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


# -- the generator -----------------------------------------------------------

@pytest.mark.parametrize("batch,state_bounds,dtype", [
    (0, False, None), (3, False, None), (0, True, None), (3, True, None),
    (2, True, "float32")])
def test_random_mpc_is_the_reference_bit_for_bit(batch, state_bounds,
                                                 dtype):
    kw = dict(horizon=6, n_states=3, n_controls=2, batch=batch, seed=4,
              state_bounds=state_bounds)
    ref = ref_mpc.random_mpc(**kw, dtype=dtype and getattr(jnp, dtype))
    ours = random_mpc(**kw, dtype=dtype and getattr(torch, dtype),
                      device=CPU)
    assert ours.horizon == 6
    assert ours.batch_shape == ((batch,) if batch else ())
    for f in dataclasses.fields(MPCData):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(ours, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name


# -- the Riccati factor / solve ----------------------------------------------

RICCATI_SHAPES = [(7, 3, 2, None), (1, 2, 1, None), (4, 2, 2, 3),
                  (5, 4, 2, 2)]


def _ref_factor_solve(Qt, Rt, A, B, rx, ru, d):
    f = ref_riccati.riccati_factor(Qt, Rt, A, B)
    return f, ref_riccati.riccati_solve(f, A, B, rx, ru, d)


_ref_factor_solve_jit = jax.jit(_ref_factor_solve)
_ref_factor_solve_vmap = jax.jit(jax.vmap(_ref_factor_solve))


@pytest.mark.parametrize("T,ns,nu,batch", RICCATI_SHAPES)
def test_riccati_factor_and_solve_match_the_reference(T, ns, nu, batch):
    arrays = _rand_lqr(T, ns, nu, seed=T + ns, batch=batch)
    run = _ref_factor_solve_jit if batch is None else _ref_factor_solve_vmap
    r_f, r_sol = run(*(jnp.asarray(a) for a in arrays))
    Qt, Rt, A, B, rx, ru, d = _torch(arrays)
    f = riccati_factor(Qt, Rt, A, B)
    assert isinstance(f, RiccatiFactors)
    lead = () if batch is None else (batch,)
    assert f.chol_F.shape == lead + (T, nu, nu)
    assert f.K.shape == lead + (T, nu, ns)
    assert f.P_next.shape == lead + (T, ns, ns)
    for name in RiccatiFactors._fields:
        _close(getattr(f, name), getattr(r_f, name), 1e-10, what=name)
    for got, want, name in zip(riccati_solve(f, A, B, rx, ru, d), r_sol,
                               ("dx", "du", "dy")):
        _close(got, want, 1e-10, what=name)


@pytest.mark.parametrize("T,ns,nu,batch", RICCATI_SHAPES)
def test_riccati_kkt_dense_matches_the_reference(T, ns, nu, batch):
    Qt, Rt, A, B = _rand_lqr(T, ns, nu, seed=1, batch=batch)[:4]
    dense = ref_riccati.riccati_kkt_dense
    if batch is not None:
        dense = jax.vmap(dense)
    want = np.asarray(dense(*(jnp.asarray(a) for a in (Qt, Rt, A, B))))
    got = riccati_kkt_dense(*_torch((Qt, Rt, A, B))).numpy()
    np.testing.assert_array_equal(got, want)


def test_a_factor_that_is_not_positive_definite_gives_nan():
    """jnp.linalg.cholesky returns NaN where torch's raises: the port's
    factor carries NaN (no exception, no host sync), and so does the
    solve, so that the IPM's rollback sees it."""
    Qt, Rt, A, B, rx, ru, d = _torch(_rand_lqr(4, 2, 2, seed=2, batch=2))
    Rt[1, 2] = -10.0 * torch.eye(2, dtype=Rt.dtype)
    f = riccati_factor(Qt, Rt, A, B)
    sol = riccati_solve(f, A, B, rx, ru, d)
    assert torch.isnan(f.chol_F[1, 2]).all()
    assert all(torch.isnan(s[1]).any() for s in sol)
    # the other instance of the batch is untouched
    one = riccati_factor(Qt[:1], Rt[:1], A[:1], B[:1])
    assert torch.equal(f.chol_F[0], one.chol_F[0])


# -- the IPM ------------------------------------------------------------------

#: (T, ns, nu, seed, solver options) of the parity cases
CASES = {
    "control_bounds": (10, 4, 2, 2, {}),
    "state_bounds": (8, 3, 2, 2, dict(state_bounds=True)),
    "gondzio": (10, 3, 2, 9, dict(gondzio=2)),
    "state_bounds_gondzio": (8, 3, 2, 2, dict(state_bounds=True,
                                               gondzio=2)),
}


@functools.lru_cache(maxsize=None)
def ref_solver(T, ns, nu, **kw):
    return ref_mpc.RiccatiIPM(T, ns, nu, **kw)


def case(name):
    T, ns, nu, seed, kw = CASES[name]
    data = ref_mpc.random_mpc(T, ns, nu, seed=seed,
                              state_bounds=kw.get("state_bounds", False))
    return (ref_solver(T, ns, nu, **kw), data,
            RiccatiIPM(T, ns, nu, device=CPU, **kw))


def assert_state_close(p: MPCState, r, rtol=1e-9):
    for i, (a, c) in enumerate(zip(p.vars, r.vars)):
        _close(a[0], c, rtol, what=f"vars[{i}]")
    for name in ("mu", "residual", "gap"):
        _close(getattr(p, name)[0], getattr(r, name), rtol, what=name)
    for i, (a, c) in enumerate(zip(p.res, r.res)):
        _close(a[0], c, rtol, atol=1e-11, what=f"res[{i}]")
    assert int(p.iteration[0]) == int(r.iteration)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_the_reference(name):
    """init_state equal; each port step from the reference's state lands
    on the reference's next state in every variable (rtol 1e-9)."""
    ref, rdata, port = case(name)
    data = tree_map(lambda a: a[None], port_data(rdata))
    r_state = jax.jit(ref.init_state)(rdata)
    assert_state_close(port.init_state(data), r_state)
    for _ in range(3):
        p_from_ref = tree_map(lambda a: a[None], convert.mpc_state_from_numpy(
            r_state, device=CPU))
        r_state = ref.step(r_state, rdata)
        assert_state_close(port.step(p_from_ref, data), r_state)


def assert_same_solution(res, rres, atol=1e-8):
    assert int(res.iterations) == int(rres.iterations)
    assert bool(res.converged) == bool(rres.converged)
    assert bool(res.diverged) == bool(rres.diverged)
    for k in ("u", "x", "y"):
        got = res.u if k == "u" else res.x if k == "x" else res.variables["y"]
        np.testing.assert_allclose(got.numpy(), np.asarray(rres.variables[k]),
                                   atol=atol, err_msg=k)
    _close(res.objective, rres.objective, 1e-10)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_the_reference(name):
    ref, rdata, port = case(name)
    rres = ref.solve(rdata)
    res = port.solve(port_data(rdata))
    assert bool(res.converged)
    assert res.variables.keys() == rres.variables.keys()
    assert_same_solution(res, rres)


def test_warm_start_matches_the_reference():
    """A perturbed instance warm-started from the port's own solution:
    the same iterations and solution as the reference's warm start from
    that solution."""
    ref, rdata, port = case("control_bounds")
    cold = port.solve(port_data(rdata))
    rdata2 = dataclasses.replace(rdata, x0=rdata.x0 + 0.01)
    warm = port.solve(port_data(rdata2), warm_start=cold.variables)
    rwarm = ref.solve(rdata2, warm_start={
        k: jnp.asarray(v.numpy()) for k, v in cold.variables.items()})
    assert bool(warm.converged)
    assert_same_solution(warm, rwarm)


def test_solve_batch_per_lane_iterations():
    """Lanes that stop at different iterations: each is frozen where the
    reference's vmapped while_loop freezes it."""
    T, ns, nu = 6, 3, 2
    rdata = ref_mpc.random_mpc(T, ns, nu, batch=6, seed=5)
    rres = ref_solver(T, ns, nu).solve_batch(rdata)
    port = RiccatiIPM(T, ns, nu, device=CPU)
    res = port.solve_batch(port_data(rdata))
    its = res.iterations.numpy()
    assert len(set(its.tolist())) > 1
    np.testing.assert_array_equal(its, np.asarray(rres.iterations))
    # one host sync per iteration of the slowest lane, plus the last
    assert port.host_syncs == its.max() + 1
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(rres.converged))
    for k in ("u", "x", "y"):
        np.testing.assert_allclose(res.variables[k].numpy(),
                                   np.asarray(rres.variables[k]), atol=1e-8)


def test_a_nan_lane_is_reported_diverged_as_the_reference_reports_it():
    T, ns, nu = 6, 3, 2
    rdata = ref_mpc.random_mpc(T, ns, nu, batch=6, seed=5)
    rdata = dataclasses.replace(rdata, A=rdata.A.at[1, 2, 0, 0].set(jnp.nan))
    rres = ref_solver(T, ns, nu).solve_batch(rdata)
    res = RiccatiIPM(T, ns, nu, device=CPU).solve_batch(port_data(rdata))
    for k in ("iterations", "converged", "diverged"):
        np.testing.assert_array_equal(getattr(res, k).numpy(),
                                      np.asarray(getattr(rres, k)), k)
    assert bool(res.diverged[1]) and not bool(res.diverged[0])
    keep = np.arange(6) != 1
    np.testing.assert_allclose(res.u.numpy()[keep],
                               np.asarray(rres.u)[keep], atol=1e-8)


@pytest.mark.parametrize("batch", [0, 3])
def test_condense_matches_the_reference(batch):
    rdata = ref_mpc.random_mpc(5, 3, 2, batch=batch, seed=4,
                               state_bounds=True)
    qp, S, free = condense(port_data(rdata), device=CPU)
    for i in range(batch or 1):
        one = jax.tree_util.tree_map(lambda a: a[i], rdata) if batch \
            else rdata
        rqp, rS, rfree = ref_mpc.condense(one)
        pick = (lambda a: a[i]) if batch else (lambda a: a)
        np.testing.assert_allclose(pick(S), rS, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(pick(free), rfree, rtol=1e-12,
                                   atol=1e-12)
        for f in dataclasses.fields(qp):
            np.testing.assert_allclose(
                pick(getattr(qp, f.name)).numpy(),
                np.asarray(getattr(rqp, f.name)), rtol=1e-12, atol=1e-12,
                err_msg=f.name)


# -- tests/test_mpc.py on the port --------------------------------------------

class TestMirror:
    """Every test of ``tests/test_mpc.py``, on the port alone."""

    def test_matches_dense_kkt_solve(self):
        T, ns, nu = 7, 3, 2
        Qt, Rt, A, B, rx, ru, d = _torch(_rand_lqr(T, ns, nu))
        dx, du, dy = riccati_solve(riccati_factor(Qt, Rt, A, B), A, B, rx,
                                   ru, d)
        K = riccati_kkt_dense(Qt, Rt, A, B).numpy()
        rhs = np.concatenate([-rx.numpy().ravel(), -ru.numpy().ravel(),
                              d.numpy().ravel()])
        sol = np.linalg.solve(K, rhs)
        nx = T * ns
        np.testing.assert_allclose(dx.numpy().ravel(), sol[:nx], rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(du.numpy().ravel(), sol[nx:nx + T * nu],
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(dy.numpy().ravel(), sol[nx + T * nu:],
                                   rtol=1e-9, atol=1e-9)

    def test_horizon_one(self):
        Qt, Rt, A, B, rx, ru, d = _torch(_rand_lqr(1, 2, 1, seed=3))
        sol = riccati_solve(riccati_factor(Qt, Rt, A, B), A, B, rx, ru, d)
        K = riccati_kkt_dense(Qt, Rt, A, B).numpy()
        rhs = np.concatenate([-rx.numpy().ravel(), -ru.numpy().ravel(),
                              d.numpy().ravel()])
        got = np.concatenate([s.numpy().ravel() for s in sol])
        np.testing.assert_allclose(got, np.linalg.solve(K, rhs), rtol=1e-9,
                                   atol=1e-9)

    def test_vmappable(self):
        """The batch axis is the reference's vmap: a batched factor/solve
        equals the loop over its instances."""
        T, ns, nu = 4, 2, 2
        batches = [_torch(_rand_lqr(T, ns, nu, seed=s)) for s in range(3)]
        stacked = tuple(torch.stack([b[i] for b in batches])
                        for i in range(7))

        def solve_one(Qt, Rt, A, B, rx, ru, d):
            return riccati_solve(riccati_factor(Qt, Rt, A, B), A, B, rx, ru,
                                 d)

        bdx, bdu, bdy = solve_one(*stacked)
        for i, b in enumerate(batches):
            dx, du, dy = solve_one(*b)
            np.testing.assert_allclose(bdx[i].numpy(), dx.numpy(),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(bdu[i].numpy(), du.numpy(),
                                       rtol=1e-12, atol=1e-12)

    def test_converges_control_bounds(self):
        data = random_mpc(horizon=12, n_states=4, n_controls=2, seed=1,
                          device=CPU)
        res = RiccatiIPM(12, 4, 2, device=CPU).solve(data)
        assert bool(res.converged)
        assert float(res.gap) < 1e-8
        assert float(res.residual) < 1e-8
        u = res.u.numpy()
        assert (u >= data.l_u.numpy() - 1e-9).all()
        assert (u <= data.u_u.numpy() + 1e-9).all()
        x = res.x.numpy()
        A, B, c = (a.numpy() for a in (data.A, data.B, data.c))
        xprev = np.concatenate([data.x0.numpy()[None], x[:-1]])
        dyn = x - np.einsum("kij,kj->ki", A, xprev) - \
            np.einsum("kiu,ku->ki", B, u) - c
        assert np.abs(dyn).max() < 1e-8

    def test_converges_state_bounds(self):
        data = random_mpc(horizon=8, n_states=3, n_controls=2, seed=2,
                          state_bounds=True, device=CPU)
        res = RiccatiIPM(8, 3, 2, state_bounds=True, device=CPU).solve(data)
        assert bool(res.converged)
        x = res.x.numpy()
        assert (x >= data.l_x.numpy() - 1e-8).all()
        assert (x <= data.u_x.numpy() + 1e-8).all()

    def test_matches_condensed_dense_solver(self):
        """The same QP through the structured path and through state
        elimination + the port's dense CompiledIPM must agree."""
        T, ns, nu = 5, 3, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=4,
                          state_bounds=True, device=CPU)
        res = RiccatiIPM(T, ns, nu, state_bounds=True, device=CPU).solve(data)
        assert bool(res.converged)
        qp, S, free = condense(data, device=CPU)
        dense = CompiledIPM(Settings(), n=T * nu, m_ineq=T * ns, device=CPU)
        dres = dense.solve(qp)
        assert bool(dres.converged)
        np.testing.assert_allclose(res.u.numpy().ravel(), dres.x.numpy(),
                                   rtol=1e-6, atol=1e-6)
        # objectives differ by the constant from the eliminated states
        Qbar = np.zeros((T * ns, T * ns))
        Q = data.Q.numpy()
        for k in range(T):
            Qbar[k * ns:(k + 1) * ns, k * ns:(k + 1) * ns] = Q[k]
        const = 0.5 * free @ Qbar @ free + data.q.numpy().ravel() @ free
        np.testing.assert_allclose(float(res.objective),
                                   float(dres.objective) + const,
                                   rtol=1e-6, atol=1e-6)

    def test_batch_vmap_matches_loop(self):
        T, ns, nu = 6, 3, 2
        bdata = random_mpc(horizon=T, n_states=ns, n_controls=nu, batch=4,
                           seed=5, device=CPU)
        solver = RiccatiIPM(T, ns, nu, device=CPU)
        bres = solver.solve_batch(bdata)
        assert bool(bres.converged.all())
        for i in range(4):
            res = solver.solve(tree_map(lambda a: a[i], bdata))
            np.testing.assert_allclose(bres.u[i].numpy(), res.u.numpy(),
                                       rtol=1e-7, atol=1e-9)

    def test_warm_start_reduces_iterations(self):
        T, ns, nu = 10, 4, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=6,
                          device=CPU)
        solver = RiccatiIPM(T, ns, nu, device=CPU)
        res = solver.solve(data)
        assert bool(res.converged)
        data2 = dataclasses.replace(data, x0=data.x0 + 0.01)
        cold = solver.solve(data2)
        warm = solver.solve(data2, warm_start=res.variables)
        assert bool(warm.converged)
        assert int(warm.iterations) <= int(cold.iterations)

    def test_gondzio_converges_and_matches(self):
        T, ns, nu = 10, 3, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=9,
                          device=CPU)
        plain = RiccatiIPM(T, ns, nu, device=CPU).solve(data)
        gz = RiccatiIPM(T, ns, nu, gondzio=2, device=CPU).solve(data)
        assert bool(plain.converged) and bool(gz.converged)
        assert int(gz.iterations) <= int(plain.iterations)
        np.testing.assert_allclose(gz.u.numpy(), plain.u.numpy(), rtol=1e-6,
                                   atol=1e-7)

    def test_result_is_optimal_vs_perturbations(self):
        """Objective at the solution beats feasible perturbed controls."""
        T, ns, nu = 6, 2, 2
        data = random_mpc(horizon=T, n_states=ns, n_controls=nu, seed=7,
                          device=CPU)
        res = RiccatiIPM(T, ns, nu, device=CPU).solve(data)
        assert bool(res.converged)
        A, B, c, Q, q, R, r = (getattr(data, k).numpy()
                               for k in ("A", "B", "c", "Q", "q", "R", "r"))

        def obj(u):
            x, xs = data.x0.numpy(), []
            for k in range(T):
                x = A[k] @ x + B[k] @ u[k] + c[k]
                xs.append(x)
            xs = np.stack(xs)
            return (0.5 * np.einsum("ki,kij,kj->", xs, Q, xs)
                    + np.einsum("ki,ki->", q, xs)
                    + 0.5 * np.einsum("ki,kij,kj->", u, R, u)
                    + np.einsum("ki,ki->", r, u))

        u_star = res.u.numpy()
        f_star = obj(u_star)
        np.testing.assert_allclose(f_star, float(res.objective), rtol=1e-9)
        rng = np.random.default_rng(0)
        for _ in range(5):
            pert = 1e-3 * rng.normal(size=u_star.shape)
            u_p = np.clip(u_star + pert, data.l_u.numpy(), data.u_u.numpy())
            assert obj(u_p) >= f_star - 1e-9


# -- device, sizes, types, conversions -------------------------------------

class TestDevice:
    def test_default_device_is_the_card(self):
        """Without a CUDA device the entry points raise; device='cpu'
        runs."""
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a CUDA device")
        rdata = ref_mpc.random_mpc(4, 2, 1, seed=0)
        with pytest.raises((RuntimeError, AssertionError)):
            RiccatiIPM(4, 2, 1)
        with pytest.raises((RuntimeError, AssertionError)):
            random_mpc(4, 2, 1)
        with pytest.raises((RuntimeError, AssertionError)):
            convert.mpc_data_from_numpy(rdata)
        with pytest.raises((RuntimeError, AssertionError)):
            convert.mpc_state_from_numpy(ref_solver(4, 2, 1).init_state(
                rdata))
        with pytest.raises((RuntimeError, AssertionError)):
            condense(port_data(rdata))
        assert bool(RiccatiIPM(4, 2, 1, device=CPU).solve(
            port_data(rdata)).converged)

    def test_data_on_another_device_or_of_other_sizes(self):
        data = random_mpc(4, 2, 1, device=CPU)
        solver = RiccatiIPM(4, 2, 1, device=CPU)
        with pytest.raises(ValueError, match="meta"):
            solver.solve(data.to(device="meta"))
        with pytest.raises(ValueError, match="solver built for"):
            RiccatiIPM(5, 2, 1, device=CPU).solve(data)
        with pytest.raises(ValueError, match="batch"):
            solver.solve_batch(data)
        with pytest.raises(TypeError, match="float32 or float64"):
            RiccatiIPM(4, 2, 1, dtype=torch.float16, device=CPU)

    def test_float32_solver_meets_the_float32_floor(self):
        """bench_mpc's configuration at a small size: float32 data and
        solver at tol 1e-5, against the float64 solve of the same data."""
        data = random_mpc(8, 4, 2, batch=16, seed=0, dtype=torch.float32,
                          device=CPU)
        res = RiccatiIPM(8, 4, 2, dtype=torch.float32, tol=1e-5,
                         max_iter=40, device=CPU).solve_batch(data)
        assert bool(res.converged.all()) and res.u.dtype == torch.float32
        ref = RiccatiIPM(8, 4, 2, device=CPU).solve_batch(
            data.to(dtype=torch.float64))
        f, g = res.objective.double(), ref.objective
        assert ((f - g).abs() / (1 + g.abs())).max().item() < 1e-4

    def test_conversions_round_trip(self):
        rdata = ref_mpc.random_mpc(4, 2, 1, batch=2, seed=3,
                                   state_bounds=True)
        back = convert.mpc_data_to_numpy(port_data(rdata))
        for f in dataclasses.fields(MPCData):
            np.testing.assert_array_equal(back[f.name],
                                          np.asarray(getattr(rdata, f.name)))
        ref = ref_solver(4, 2, 1, state_bounds=True)
        one = jax.tree_util.tree_map(lambda a: a[0], rdata)
        state = convert.mpc_state_from_numpy(ref.init_state(one), device=CPU)
        assert state.iteration.dtype == torch.int32 and len(state.vars) == 7
        assert len(state.res) == 3
        res = RiccatiIPM(4, 2, 1, state_bounds=True,
                         device=CPU).solve_batch(port_data(rdata))
        out = convert.mpc_result_to_numpy(res)
        assert set(out) == {f.name for f in dataclasses.fields(res)}
        assert out["variables"].keys() == res.variables.keys()
        np.testing.assert_array_equal(out["u"], res.u.numpy())
