"""Banded+arrow structured path of the port (ops/banded.py,
models/arrow.py) against the JAX package's, on the CPU in float64.

The inputs are made with numpy from a seed and fed to both sides.  The
port's ``method="pl"`` runs the plain versions of kernels K6/K7 on CPU
tensors; the reference's runs its Pallas kernels in interpret mode.
Tolerances: the two sides differ only in the order of sums inside library
calls, so iterates agree to rtol 1e-9 per step and solutions to 1e-8."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.models import ArrowIPM as RefArrowIPM
from ipmzoo_tpu.models import ArrowQPData as RefArrowQPData
from ipmzoo_tpu.ops import banded as ref_banded
from ipmzoo_tpu_torch.formulations import (Bounds, InequalityHandling,
                                           Settings)
from ipmzoo_tpu_torch.models import (ArrowIPM, ArrowQPData, CompiledIPM,
                                     QPData)
from ipmzoo_tpu_torch.models.arrow import ArrowState
from ipmzoo_tpu_torch.models.convert import (arrow_qp_from_numpy,
                                             arrow_state_from_numpy)
from ipmzoo_tpu_torch.models.state import tree_map
from ipmzoo_tpu_torch.ops import banded, cuda_cr
from ipmzoo_tpu_torch.ops.cr import CRKernelFactors

METHODS = ("scan", "cr", "pl")


def make_arrow_spd(n, b, t, seed, shuffle=False):
    """SPD banded+arrow matrix; optionally under a random symmetric
    permutation (to exercise the detector's RCM stage)."""
    rng = np.random.default_rng(seed)
    nb = n - t
    Q = np.zeros((n, n))
    for i in range(nb):
        lo, hi = max(0, i - b), min(nb, i + b + 1)
        Q[i, lo:hi] = rng.normal(size=hi - lo) * 0.1
    Q = (Q + Q.T) / 2
    strip = rng.normal(size=(t, n)) * 0.1
    Q[nb:, :] = strip
    Q[:, nb:] = strip.T
    Q[nb:, nb:] = (strip[:, nb:] + strip[:, nb:].T) / 2
    Q += np.eye(n) * (2 * b + t)
    if shuffle:
        p = rng.permutation(n)
        Q = Q[np.ix_(p, p)]
    return Q


def random_arrow_qp(n, b, t, seed, shuffle=True):
    rng = np.random.default_rng(seed)
    Q = make_arrow_spd(n, b, t, seed, shuffle=shuffle)
    c = rng.normal(size=n) * 3
    l = -np.abs(rng.normal(size=n)) - 0.1
    u = np.abs(rng.normal(size=n)) + 0.1
    return Q, c, l, u


def from_dense(*a, **kw):
    return ArrowQPData.from_dense(*a, device="cpu", **kw)


def port_solver(data, st, **kw):
    return ArrowIPM.for_data(data, structure=st, device="cpu", **kw)


def dense_solve(Q, c, l, u):
    n = Q.shape[0]
    dense = CompiledIPM(
        Settings(inequalities=Bounds.NONE,
                 inequality_handling=InequalityHandling.SLACKS),
        n=n, dtype=torch.float64, device="cpu")
    res = dense.solve(QPData.make(Q=Q, c=c, l_x=l, u_x=u, device="cpu"))
    assert bool(res.converged)
    return res


@functools.lru_cache(maxsize=None)
def ref_solver(N, b, t, method):
    """One reference solver (and its compiled programs) per shape and
    method for the whole module."""
    return RefArrowIPM(N, b, t, method=method)


class TestDetector:
    @pytest.mark.parametrize("n,b,t,shuffle", [
        (93, 8, 5, False), (128, 4, 3, False),
        (256, 16, 8, True), (200, 8, 0, True)])
    def test_exact_recovery(self, n, b, t, shuffle):
        Q = make_arrow_spd(n, b, t, seed=n + t, shuffle=shuffle)
        st = banded.detect_arrow(Q)
        assert st.bandwidth == b and st.tip == t
        Qp = Q[np.ix_(st.perm, st.perm)]
        nb = n - st.tip
        ii, jj = np.nonzero(np.abs(np.triu(Qp[:nb, :nb], 1)) > 0)
        assert (np.abs(ii - jj) <= st.bandwidth).all()
        ref = ref_banded.detect_arrow(Q)
        np.testing.assert_array_equal(st.perm, ref.perm)
        assert (st.bandwidth, st.tip) == (ref.bandwidth, ref.tip)

    def test_dense_matrix_gets_no_structure(self):
        rng = np.random.default_rng(0)
        M = rng.normal(size=(40, 40))
        Q = M @ M.T + np.eye(40)
        st = banded.detect_arrow(Q)
        assert st.tip <= 10            # nothing useful to peel
        assert st.bandwidth >= 20      # genuinely dense
        ref = ref_banded.detect_arrow(Q)
        np.testing.assert_array_equal(st.perm, ref.perm)
        assert (st.bandwidth, st.tip) == (ref.bandwidth, ref.tip)

    def test_diagonal(self):
        st = banded.detect_arrow(np.eye(16))
        assert st.bandwidth == 1 and st.tip == 0
        np.testing.assert_array_equal(st.perm, np.arange(16))


class TestOps:
    def test_bt_factor_solve(self):
        Q = make_arrow_spd(64, 8, 0, seed=1)
        D, E, U, C = banded.band_to_blocks(torch.tensor(Q), 8, 0)
        rD, rE, _, _ = ref_banded.band_to_blocks(jnp.asarray(Q), 8, 0)
        np.testing.assert_array_equal(D.numpy(), np.asarray(rD))
        np.testing.assert_array_equal(E.numpy(), np.asarray(rE))
        f = banded.bt_factor(D, E)
        r = np.random.default_rng(2).normal(size=(64, 3))
        z = banded.bt_solve(f, torch.tensor(r.reshape(8, 8, 3)))
        np.testing.assert_allclose(Q @ z.numpy().reshape(64, 3), r,
                                   atol=1e-11)
        rz = ref_banded.bt_solve(ref_banded.bt_factor(rD, rE),
                                 jnp.asarray(r.reshape(8, 8, 3)))
        np.testing.assert_allclose(z.numpy(), np.asarray(rz), atol=1e-13)

    @pytest.mark.parametrize("method", ("auto",) + METHODS)
    def test_arrow_factor_solve(self, method):
        n, b, t = 93, 8, 5
        Q = make_arrow_spd(n, b, t, seed=3)
        D, E, U, C = banded.band_to_blocks(torch.tensor(Q), b, t)
        f = banded.arrow_factor(D, E, U, C, method=method)
        r = np.random.default_rng(4).normal(size=n)
        xb, xt = banded.arrow_solve(f, torch.tensor(r[:n - t]),
                                    torch.tensor(r[n - t:]))
        x = np.concatenate([xb.numpy(), xt.numpy()])
        np.testing.assert_allclose(Q @ x, r, atol=1e-11)
        # fused factor + solve: the same factors and solution
        f2, (xb2, xt2) = banded.arrow_factor_solve(
            D, E, U, C, torch.tensor(r[:n - t]), torch.tensor(r[n - t:]),
            method=method)
        np.testing.assert_allclose(xb2.numpy(), xb.numpy(), atol=1e-13)
        np.testing.assert_allclose(xt2.numpy(), xt.numpy(), atol=1e-13)
        np.testing.assert_allclose(f2.W.numpy(), f.W.numpy(), atol=1e-14)
        # on CPU tensors 'auto' is the library composition per level
        kind = {"auto": banded.CRFactors, "cr": banded.CRFactors,
                "scan": banded.BTFactors, "pl": CRKernelFactors}[method]
        assert isinstance(f.bt, kind) and isinstance(f2.bt, kind)

    def test_batched_arrow_factor_solve(self):
        """A leading batch axis gives each instance's own answer."""
        n, b, t = 45, 8, 5
        Qs = [make_arrow_spd(n, b, t, seed=s) for s in (5, 6)]
        parts = [banded.band_to_blocks(torch.tensor(Q), b, t) for Q in Qs]
        D, E, U, C = (torch.stack(p) for p in zip(*parts))
        r = torch.tensor(np.random.default_rng(7).normal(size=(2, n)))
        for method in METHODS:
            _, (xb, xt) = banded.arrow_factor_solve(
                D, E, U, C, r[:, :n - t], r[:, n - t:], method=method)
            x = torch.cat([xb, xt], dim=-1).numpy()
            for i, Q in enumerate(Qs):
                np.testing.assert_allclose(Q @ x[i], r[i].numpy(),
                                           atol=1e-11)

    def test_band_to_blocks_rejects_ragged(self):
        with pytest.raises(ValueError):
            banded.band_to_blocks(torch.eye(11), 4, 2)   # 9 % 4 != 0

    def test_unknown_method(self):
        D = torch.eye(4).expand(3, 4, 4)
        with pytest.raises(ValueError, match="unknown method"):
            banded.resolve_method("pallas", D)
        assert banded.resolve_method("auto", D) == "scan"
        assert banded.resolve_method("auto", torch.eye(4).expand(
            8, 4, 4)) == "cr"
        assert banded.resolve_method("auto", torch.eye(4, device="meta")
                                     .expand(8, 4, 4)) == "cr"
        with pytest.raises(ValueError, match="unknown method"):
            ArrowIPM(3, 4, 1, method="pallas", device="cpu")


def assert_same_solution(res, ref, atol=1e-8):
    assert bool(res.converged) and not bool(res.diverged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=atol)
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-9)


class TestArrowIPM:
    def test_solves_vs_dense_path(self):
        n, b, t = 93, 8, 5
        Q, c, l, u = random_arrow_qp(n, b, t, seed=7)
        data, st, blk = from_dense(Q, c, l, u)
        assert (st.bandwidth, st.tip) == (b, t)
        solver = port_solver(data, st)
        res = solver.solve(data)
        assert bool(res.converged) and not bool(res.diverged)
        assert float(res.residual) < 1e-8 and float(res.gap) < 1e-8

        dres = dense_solve(Q, c, l, u)
        np.testing.assert_allclose(res.x.numpy(), dres.x.numpy(), atol=1e-7)
        np.testing.assert_allclose(float(res.objective),
                                   float(dres.objective), rtol=1e-9)

        rdata, rst, _ = RefArrowQPData.from_dense(Q, c, l, u)
        np.testing.assert_array_equal(rst.perm, st.perm)
        for f in ("D", "E", "U", "Ct", "c", "l_x", "u_x"):
            np.testing.assert_array_equal(getattr(data, f).numpy(),
                                          np.asarray(getattr(rdata, f)))
        ref = RefArrowIPM.for_data(rdata, structure=rst).solve(rdata)
        assert_same_solution(res, ref)

    def test_pure_banded_no_tip(self):
        n, b = 64, 4
        Q, c, l, u = random_arrow_qp(n, b, 0, seed=9, shuffle=False)
        data, st, blk = from_dense(Q, c, l, u)
        assert st.tip == 0
        res = port_solver(data, st).solve(data)
        assert bool(res.converged)
        dres = dense_solve(Q, c, l, u)
        np.testing.assert_allclose(res.x.numpy(), dres.x.numpy(), atol=1e-7)
        for method in METHODS:
            r2 = port_solver(data, st, method=method).solve(data)
            assert int(r2.iterations) == int(res.iterations)
            np.testing.assert_allclose(r2.x.numpy(), res.x.numpy(),
                                       atol=1e-9)

    def test_padding_path(self):
        # n - t not a multiple of the block: from_dense pads with benign
        # interior variables; solution in original order is unaffected
        n, b, t = 90, 8, 5   # nb = 85, pads to 88
        Q, c, l, u = random_arrow_qp(n, b, t, seed=11, shuffle=False)
        data, st, blk = from_dense(Q, c, l, u)
        assert data.c.shape[0] > n
        res = port_solver(data, st).solve(data)
        assert bool(res.converged)
        assert tuple(res.x.shape) == (n,)
        dres = dense_solve(Q, c, l, u)
        np.testing.assert_allclose(res.x.numpy(), dres.x.numpy(), atol=1e-7)
        rdata, rst, _ = RefArrowQPData.from_dense(Q, c, l, u)
        for f in ("D", "E", "U", "Ct", "c", "l_x", "u_x"):
            np.testing.assert_array_equal(getattr(data, f).numpy(),
                                          np.asarray(getattr(rdata, f)))

    def test_batched(self):
        n, b, t = 61, 4, 3
        datas = []
        st0 = None
        for seed in range(4):
            Q, c, l, u = random_arrow_qp(n, b, t, seed=20, shuffle=False)
            rng = np.random.default_rng(100 + seed)
            c = rng.normal(size=n)
            data, st, blk = from_dense(Q, c, l, u, structure=st0)
            st0 = st
            datas.append(data)
        batch = ArrowQPData.stack(datas)
        for method in ("auto", "pl"):
            solver = port_solver(datas[0], st0, method=method)
            res = solver.solve_batch(batch)
            assert bool(res.converged.all())
            # one question to the device per iteration, and a last one
            assert solver.host_syncs == int(res.iterations.max()) + 1
            for i in range(4):
                single = solver.solve(datas[i])
                assert int(res.iterations[i]) == int(single.iterations)
                np.testing.assert_allclose(res.x[i].numpy(),
                                           single.x.numpy(), atol=1e-9)
                np.testing.assert_allclose(float(res.objective[i]),
                                           float(single.objective),
                                           rtol=1e-12)

    def test_nan_instance_is_rolled_back_alone(self):
        """A step that goes NaN keeps the instance's last good iterate
        and flags it; the rest of the batch solves as alone."""
        n, b, t = 33, 4, 1
        Q, c, l, u = random_arrow_qp(n, b, t, seed=21, shuffle=False)
        good, st, _ = from_dense(Q, c, l, u)
        Qbad = Q.copy()
        Qbad[:n - t, :n - t] -= 3 * (2 * b + t) * np.eye(n - t)  # indefinite
        bad, _, _ = from_dense(Qbad, c, l, u, structure=st)
        solver = port_solver(good, st, method="pl")
        res = solver.solve_batch(ArrowQPData.stack([good, bad, good]))
        assert res.converged.tolist() == [True, False, True]
        assert res.diverged.tolist() == [False, True, False]
        assert bool(torch.isfinite(res.x).all())
        assert int(res.iterations[1]) == 0
        single = solver.solve(good)
        np.testing.assert_allclose(res.x[0].numpy(), single.x.numpy(),
                                   atol=1e-12)


class TestCyclicReduction:
    @pytest.mark.parametrize("N,b", [(4, 8), (5, 8), (32, 16), (1, 8)])
    def test_cr_matches_dense(self, N, b):
        n = N * b
        Q = make_arrow_spd(n, b, 0, seed=N * 10 + b)
        D, E, U, C = banded.band_to_blocks(torch.tensor(Q), b, 0)
        r = np.random.default_rng(1).normal(size=(n, 3))
        rt = torch.tensor(r.reshape(N, b, 3))
        x = banded.cr_solve(banded.cr_factor(D, E), rt)
        np.testing.assert_allclose(Q @ x.numpy().reshape(n, 3), r,
                                   atol=1e-11)
        # the plain versions of K6/K7 on the same system
        xk = cuda_cr.cr_solve_auto(cuda_cr.cr_factor_auto(D, E), rt)
        np.testing.assert_allclose(Q @ xk.numpy().reshape(n, 3), r,
                                   atol=1e-11)

    def test_arrow_cr_matches_scan(self):
        n, b, t = 93, 8, 5
        Q = make_arrow_spd(n, b, t, seed=42)
        D, E, U, C = banded.band_to_blocks(torch.tensor(Q), b, t)
        r = np.random.default_rng(2).normal(size=n)
        outs = []
        for method in ("scan", "cr"):
            f = banded.arrow_factor(D, E, U, C, method=method)
            xb, xt = banded.arrow_solve(f, torch.tensor(r[:n - t]),
                                        torch.tensor(r[n - t:]))
            outs.append(np.concatenate([xb.numpy(), xt.numpy()]))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-11,
                                   atol=1e-11)

    def test_arrow_pl_matches_cr(self):
        """method='pl' (the plain versions of K6/K7 on CPU tensors) is a
        drop-in for 'cr' in the full arrow factor+solve, and agrees with
        the reference's 'pl' (its kernels in interpret mode)."""
        n, b, t = 93, 8, 5
        Q = make_arrow_spd(n, b, t, seed=43)
        D, E, U, C = banded.band_to_blocks(torch.tensor(Q), b, t)
        r = np.random.default_rng(3).normal(size=n)
        outs = []
        for method in ("cr", "pl"):
            f = banded.arrow_factor(D, E, U, C, method=method)
            xb, xt = banded.arrow_solve(f, torch.tensor(r[:n - t]),
                                        torch.tensor(r[n - t:]))
            outs.append(np.concatenate([xb.numpy(), xt.numpy()]))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-10,
                                   atol=1e-10)
        rD, rE, rU, rC = ref_banded.band_to_blocks(jnp.asarray(Q), b, t)
        rf = ref_banded.arrow_factor(rD, rE, rU, rC, method="pl")
        rxb, rxt = ref_banded.arrow_solve(rf, jnp.asarray(r[:n - t]),
                                          jnp.asarray(r[n - t:]))
        np.testing.assert_allclose(
            outs[1], np.concatenate([np.asarray(rxb), np.asarray(rxt)]),
            rtol=1e-10, atol=1e-10)


def _chain_qp():
    n, b, t = 64, 4, 2
    Q = make_arrow_spd(n, b, t, seed=9)
    c = np.random.default_rng(10).normal(size=n)
    return Q, c, np.full(n, -1.0), np.full(n, 1.0), b


def test_arrow_ipm_pl_end_to_end():
    """ArrowIPM over the plain K6/K7 solves a small chain QP to the same
    answer as the per-level 'cr' path."""
    Q, c, l, u, b = _chain_qp()
    res = []
    for method in ("cr", "pl"):
        data, st, blk = from_dense(Q, c, l, u, block=b)
        r = port_solver(data, st, tol=1e-8, method=method).solve(data)
        assert bool(r.converged), method
        res.append(r.x.numpy())
    np.testing.assert_allclose(res[0], res[1], atol=1e-7)


@pytest.mark.parametrize("method", METHODS)
def test_solve_matches_reference(method):
    """Same iteration count and solution as the JAX ArrowIPM with the
    same banded engine."""
    Q, c, l, u, b = _chain_qp()
    data, st, _ = from_dense(Q, c, l, u, block=b)
    rdata, rst, _ = RefArrowQPData.from_dense(Q, c, l, u, block=b)
    ref = ref_solver(data.D.shape[0], b, st.tip, method)
    ref.structure = rst
    rres = ref.solve(rdata)
    assert bool(rres.converged)
    cuda_cr.reset_launch_counts()
    res = port_solver(data, st, method=method).solve(data)
    assert cuda_cr.launches == {"cr_factor": 0, "cr_solve": 0}
    assert_same_solution(res, rres)
    np.testing.assert_allclose(float(res.residual), float(rres.residual),
                               atol=1e-12)
    for k, v in res.variables.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(rres.variables[k]),
                                   atol=1e-8)


def assert_state_close(p: ArrowState, r, rtol=1e-9):
    for a, c in zip(p.vars, r.vars):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(c), rtol=rtol,
                                   atol=1e-12)
    for name in ("mu", "residual", "gap", "rx"):
        np.testing.assert_allclose(getattr(p, name)[0].numpy(),
                                   np.asarray(getattr(r, name)), rtol=rtol,
                                   atol=1e-12)
    assert int(p.iteration[0]) == int(r.iteration)


@pytest.mark.parametrize("method", METHODS)
def test_steps_match_reference(method):
    """Step-by-step trace: each port step from the reference's state
    lands on the reference's next state."""
    Q, c, l, u, b = _chain_qp()
    rdata, rst, _ = RefArrowQPData.from_dense(Q, c, l, u, block=b)
    ref = ref_solver(rdata.D.shape[0], b, rst.tip, method)
    data = tree_map(lambda a: a[None],
                    arrow_qp_from_numpy(rdata, device="cpu"))
    port = ArrowIPM.for_data(data, structure=rst, method=method)
    assert port.device.type == "cpu"
    r_state = ref.init_state(rdata)
    p_state = port.init_state(data)
    assert_state_close(p_state, r_state)
    for _ in range(4):
        p_from_ref = tree_map(lambda a: a[None], arrow_state_from_numpy(
            r_state, device="cpu"))
        r_state = ref._step_jit(r_state, rdata)
        assert_state_close(port.step(p_from_ref, data), r_state)
        p_state = port.step(p_state, data)
        assert_state_close(p_state, r_state, rtol=1e-8)


def test_arrow_warm_start_reduces_iterations():
    n, b, t = 61, 4, 3
    Q, c, l, u = random_arrow_qp(n, b, t, seed=30, shuffle=False)
    data, st, blk = from_dense(Q, c, l, u)
    solver = port_solver(data, st)
    cold = solver.solve(data)
    assert bool(cold.converged)
    # perturb the linear term slightly and re-solve warm
    data2, _, _ = from_dense(Q, c * 1.01, l, u, structure=st)
    warm = solver.solve(data2, warm_start=cold.variables)
    cold2 = solver.solve(data2)
    assert bool(warm.converged) and bool(cold2.converged)
    assert int(warm.iterations) <= int(cold2.iterations)
    np.testing.assert_allclose(warm.x.numpy(), cold2.x.numpy(), atol=1e-7)
    # the reference's warm start takes the same number of iterations
    rdata2, rst, _ = RefArrowQPData.from_dense(Q, c * 1.01, l, u)
    ref = RefArrowIPM.for_data(rdata2, structure=rst)
    rwarm = ref.solve(rdata2, warm_start={
        k: jnp.asarray(v.numpy()) for k, v in cold.variables.items()})
    assert_same_solution(warm, rwarm)


class TestDevice:
    def test_default_device_is_the_card(self):
        """Without a CUDA device the entry points raise; device='cpu'
        runs."""
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a CUDA device")
        Q, c, l, u, b = _chain_qp()
        with pytest.raises((RuntimeError, AssertionError)):
            ArrowQPData.from_dense(Q, c, l, u)
        with pytest.raises((RuntimeError, AssertionError)):
            ArrowIPM(16, 4, 2)
        with pytest.raises((RuntimeError, AssertionError)):
            CompiledIPM(Settings(), 2, 1)
        with pytest.raises((RuntimeError, AssertionError)):
            arrow_qp_from_numpy(from_dense(Q, c, l, u)[0])
        data, st, _ = from_dense(Q, c, l, u, block=b)
        assert bool(ArrowIPM(16, 4, 2, structure=st, device="cpu")
                    .solve(data).converged)
        assert bool(CompiledIPM(Settings(), 2, 0, device="cpu").solve(
            QPData.make(Q=np.eye(2), c=np.ones(2), l_x=-np.ones(2),
                        u_x=np.ones(2), device="cpu")).converged)

    def test_data_on_another_device_or_of_other_sizes(self):
        Q, c, l, u, b = _chain_qp()
        data, st, _ = from_dense(Q, c, l, u, block=b)
        solver = port_solver(data, st)
        with pytest.raises(ValueError, match="meta"):
            solver.solve(data.to(device="meta"))
        with pytest.raises(ValueError, match="solver built for"):
            ArrowIPM(8, 4, 2, device="cpu").solve(data)
        with pytest.raises(ValueError, match="batch"):
            solver.solve_batch(data)
        with pytest.raises(TypeError, match="float32 or float64"):
            port_solver(data, st, dtype=torch.float16)

    def test_float32_data_and_solver(self):
        Q, c, l, u, b = _chain_qp()
        data, st, _ = from_dense(Q, c, l, u, block=b, dtype=torch.float32)
        assert data.D.dtype == torch.float32
        res = port_solver(data, st, dtype=torch.float32, tol=1e-5,
                          method="pl").solve(data)
        assert bool(res.converged) and res.x.dtype == torch.float32
        ref64 = port_solver(data, st, method="cr").solve(data)
        assert abs(float(res.objective) - float(ref64.objective)) <= \
            1e-4 * (1 + abs(float(ref64.objective)))
