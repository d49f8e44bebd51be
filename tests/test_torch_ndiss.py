"""Nested dissection of the port (ipmzoo_tpu_torch/ops/ndiss.py,
models/ndplan.py, CompiledIPM(kernel="nd")) on the CPU in float64: the
reference's own tests (tests/test_ndiss.py) mirrored on the port, and the
port held to the JAX package on the same numpy-seeded inputs.

Tolerances: plans are compared array for array (the host half is the same
numpy code); factors and solutions within 1e-10 (same algorithm, other
summation order; 'pl' on the reference side runs its Pallas kernels in
interpret mode); CompiledIPM iterations equal and x within 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import Settings as RefSettings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.models.families import grid_qp as ref_grid_qp
from ipmzoo_tpu.ops import ndiss as ref_nd
from ipmzoo_tpu_torch import CompiledIPM, Settings
from ipmzoo_tpu_torch.models.convert import (qpdata_from_numpy,
                                             settings_from_reference)
from ipmzoo_tpu_torch.models.families import grid_qp
from ipmzoo_tpu_torch.ops import cuda_ldlt
from ipmzoo_tpu_torch.ops.ldlt import ldlt, solve_ldlt
from ipmzoo_tpu_torch.ops.ndiss import (REFERENCE_CONSTANTS, NDPlan,
                                        _uses_kernels, nd_factor,
                                        nd_factor_pre, nd_plan,
                                        nd_predicted_speedup, nd_prework,
                                        nd_solve, nd_solve_matrix)

LEVEL_FIELDS = ("idx", "valid", "bnd", "bvalid", "off", "child_ids",
                "child_map")


def banded_qd(n, bw, seed=0):
    """Banded symmetric quasi-definite matrix (positive diag on the first
    half, negative on the second)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(1, bw + 1):
        v = rng.normal(size=n - d) * 0.3
        A += np.diag(v, d) + np.diag(v, -d)
    s = np.where(np.arange(n) < n // 2, 1.0, -1.0)
    A += np.diag(s * (bw + 1.0))
    return A


def grid_spd(side, seed=0):
    """2D grid Laplacian + jitter: the classic nested-dissection case."""
    n = side * side
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for i in range(side):
        for j in range(side):
            a = i * side + j
            for di, dj in ((0, 1), (1, 0)):
                ii, jj = i + di, j + dj
                if ii < side and jj < side:
                    b = ii * side + jj
                    w = -1.0 - 0.1 * rng.random()
                    A[a, b] = A[b, a] = w
    np.fill_diagonal(A, 5.0 + rng.random(n))
    return A


def random_sparse(n=150, seed=3):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for _ in range(2 * n):
        i, j = rng.integers(0, n, 2)
        if i != j:
            A[i, j] = A[j, i] = rng.normal() * 0.1
    np.fill_diagonal(A, 4.0)
    return A


def kkt_qd(seed_q, seed_a, n=120, m=30):
    """[[Q, A^T], [A, -delta I]] with banded Q and local constraints —
    the shape of an augmented IPM system; and its structural signs."""
    rng = np.random.default_rng(seed_a)
    Q = banded_qd(n, 2, seed=seed_q)
    Q = Q @ Q.T / 10 + np.eye(n)   # SPD, still banded (wider)
    Q[np.abs(Q) < 1e-12] = 0.0
    A = np.zeros((m, n))
    for i in range(m):
        j = (i * n) // m
        A[i, j:j + 3] = rng.normal(size=min(3, n - j))
    K = np.block([[Q, A.T], [A, -1e-4 * np.eye(m)]])
    return K, np.concatenate([np.ones(n), -np.ones(m)])


def tree_matrix(n=127):
    A = np.zeros((n, n))
    for i in range(1, n):
        p = (i - 1) // 2
        A[i, p] = A[p, i] = 0.5
    np.fill_diagonal(A, 3.0)
    return A


def disconnected():
    A1 = grid_spd(6, seed=11)
    A2 = banded_qd(40, 2, seed=12)
    n1, n2 = A1.shape[0], A2.shape[0]
    A = np.zeros((n1 + n2, n1 + n2))
    A[:n1, :n1] = A1
    A[n1:, n1:] = A2
    return A


def dense_solve(A, b):
    """The port's dense LDL^T solve, the yardstick of the round trips."""
    L, D = ldlt(torch.from_numpy(A)[None])
    return solve_ldlt(L, D, torch.from_numpy(b)[None])[0].numpy()


def check_roundtrip(A, atol=1e-9, leaf=16):
    n = A.shape[0]
    plan = nd_plan(A != 0, leaf=leaf)
    b = np.random.default_rng(42).normal(size=n)
    K = torch.from_numpy(A)
    x = nd_solve(plan, nd_factor(K, plan), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), dense_solve(A, b), atol=atol,
                               rtol=1e-7)
    return plan


def assert_plans_equal(p: NDPlan, r):
    assert (p.n, p.flops_nd, p.flops_dense, p.m_max, p.num_nodes,
            p.level_id0, p.top_neg) == \
        (r.n, r.flops_nd, r.flops_dense, r.m_max, r.num_nodes,
         r.level_id0, r.top_neg)
    assert np.array_equal(p.perm, r.perm)
    assert len(p.levels) == len(r.levels)
    for a, b in zip(p.levels, r.levels):
        for f in LEVEL_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


class TestParity:
    def test_banded(self):
        plan = check_roundtrip(banded_qd(200, 3, seed=1))
        assert plan.flops_nd < plan.flops_dense / 20

    def test_grid(self):
        plan = check_roundtrip(grid_spd(16, seed=2))
        assert plan.flops_nd < plan.flops_dense / 5

    def test_random_sparse(self):
        check_roundtrip(random_sparse())

    def test_kkt_quasidefinite(self):
        K, _ = kkt_qd(5, 4)
        check_roundtrip(K, atol=1e-7)

    def test_signed_amalgamated_top(self):
        # structural signs route the merged top block through the
        # two-stage Cholesky (_signed_top_factor); parity against the
        # dense LDL^T on a mixed quasi-definite KKT
        K, signs = kkt_qd(12, 11)
        plan = nd_plan(K != 0, leaf=16, root_merge=64, signs=signs)
        assert plan.top_neg >= 0, "amalgamated signed top expected"
        b = np.random.default_rng(11).normal(size=K.shape[0])
        Kt = torch.from_numpy(K)
        x = nd_solve(plan, nd_factor(Kt, plan), torch.from_numpy(b))
        np.testing.assert_allclose(x.numpy(), dense_solve(K, b), atol=1e-7,
                                   rtol=1e-7)
        # mixed split: some negatives actually reached the top block
        assert 0 < plan.top_neg < plan.levels[-1].idx.shape[1]

    def test_tree_structured(self):
        # binary-tree coupling: separators are single vertices
        plan = check_roundtrip(tree_matrix(), leaf=8)
        assert plan.flops_nd < plan.flops_dense / 50

    def test_multi_rhs(self):
        A = grid_spd(10, seed=6)
        plan = nd_plan(A != 0, leaf=12)
        factors = nd_factor(torch.from_numpy(A), plan)
        B = np.random.default_rng(7).normal(size=(100, 4))
        X = nd_solve_matrix(plan, factors, torch.from_numpy(B))
        np.testing.assert_allclose(A @ X.numpy(), B, atol=1e-9)
        assert nd_solve_matrix(plan, factors,
                               torch.zeros((100, 0))).shape == (100, 0)

    def test_dense_fallback(self):
        # a clique cannot be dissected; the plan degrades to one block
        # and still solves correctly
        M = np.random.default_rng(8).normal(size=(20, 20))
        check_roundtrip(M @ M.T + np.eye(20), leaf=4)


def sparse_qp(n=96, m=12, seed=13):
    """The reference test's sparse QP as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    Q = banded_qd(n, 2, seed=seed)
    Q = Q @ Q.T / 8 + np.eye(n)       # SPD, banded (wider)
    Q[np.abs(Q) < 1e-12] = 0.0
    A = np.zeros((m, n))
    for i in range(m):
        j = (i * n) // m
        A[i, j:j + 4] = rng.normal(size=min(4, n - j))
    return dict(
        Q=Q, c=rng.normal(size=n), A_ineq=A,
        l_A_ineq=-np.abs(rng.normal(size=m)) - 1,
        u_A_ineq=np.abs(rng.normal(size=m)) + 1,
        A_eq=np.zeros((0, n)), b_eq=np.zeros((0,)),
        l_x=np.full((n,), -2.0), u_x=np.full((n,), 2.0))


def both(arrays):
    """The same data for the reference and for the port (CPU)."""
    ref = RefQPData(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return ref, qpdata_from_numpy(ref, device="cpu")


def batch_qp(n=64, m=8, B=3):
    """Batched QPs of one structure: instance 0's Q/A, other vectors."""
    insts = [sparse_qp(n, m, seed=20 + i) for i in range(B)]
    shared = ("Q", "A_ineq", "A_eq", "b_eq", "l_x", "u_x")
    return {k: np.stack([insts[0][k] if k in shared else d[k]
                         for d in insts]) for k in insts[0]}


def port_solver(n, m, **kw):
    return CompiledIPM(Settings(), n=n, m_ineq=m, device="cpu", **kw)


class TestIPMConsumer:
    """kernel='nd' end-to-end: the full Mehrotra loop factoring the
    augmented KKT through the dissection plan each iteration, with the
    plan derived lazily from the data's sparsity on the first solve."""

    def test_nd_matches_dense_kernel(self):
        n, m = 96, 12
        _, data = both(sparse_qp(n, m))
        nd = port_solver(n, m, kernel="nd", nd_leaf=16)
        dense = port_solver(n, m, kernel="ldlt")
        r_nd, r_ref = nd.solve(data), dense.solve(data)
        assert bool(r_nd.converged) and bool(r_ref.converged)
        np.testing.assert_allclose(r_nd.x.numpy(), r_ref.x.numpy(),
                                   atol=1e-7)
        # the lazily derived plan must actually exploit the sparsity
        plan = nd._nd_plan
        assert plan is not None and plan.flops_nd < plan.flops_dense / 3
        # at this size the auto-fallback takes the dense kernel, as the
        # reference's does; with it off the plan really factors the KKT
        assert nd.nd_fell_back and nd._mode == "ldlt"
        kept = port_solver(n, m, kernel="nd", nd_leaf=16,
                           nd_fallback=False)
        r_kept = kept.solve(data)
        assert kept._mode == "nd" and kept._nd_diag_split
        assert int(r_kept.iterations) == int(r_ref.iterations)
        np.testing.assert_allclose(r_kept.x.numpy(), r_ref.x.numpy(),
                                   atol=1e-7)

    def test_nd_solve_batch(self):
        # batched QPs share the structure (plan derived from instance 0)
        n, m = 64, 8
        _, data = both(batch_qp(n, m))
        r_nd = port_solver(n, m, kernel="nd", nd_leaf=16,
                           nd_fallback=False).solve_batch(data)
        r_ref = port_solver(n, m, kernel="ldlt").solve_batch(data)
        assert bool(r_nd.converged.all())
        np.testing.assert_allclose(r_nd.x.numpy(), r_ref.x.numpy(),
                                   atol=1e-7)

    def test_explicit_pattern(self):
        n, m = 64, 8
        _, data = both(sparse_qp(n, m, seed=14))
        probe = port_solver(n, m, kernel="nd")
        one = probe._check_data(type(data)(**{
            f.name: getattr(data, f.name)[None]
            for f in dataclasses.fields(data)}))
        st = probe.init_state(one)
        env = probe._env(one, st.vars, 1.0)
        pattern = probe._assemble_kkt(env, 1)[0].numpy() != 0
        nd = port_solver(n, m, kernel="nd", nd_pattern=pattern, nd_leaf=16,
                         nd_fallback=False)
        assert nd._nd_plan is not None and nd._mode == "nd"
        res = nd.solve(data)
        assert bool(res.converged)

    def test_step_without_a_plan_raises(self):
        n, m = 64, 8
        _, data = both(batch_qp(n, m))
        nd = port_solver(n, m, kernel="nd", nd_leaf=16, nd_fallback=False)
        with pytest.raises(RuntimeError, match="dissection plan"):
            nd.step(nd.init_state(data), data)


class TestBatchAxes:
    """Leading batch axes (the reference vmaps; the port writes them
    out): a level's blocks of all instances go to the kernels as one
    batch."""

    def test_factor_solve_with_leading_axes(self):
        A = grid_spd(12, seed=9)
        n = A.shape[0]
        plan = nd_plan(A != 0, leaf=16)
        rng = np.random.default_rng(10)
        scale = 1.0 + rng.random((2, 3, 1, 1))
        K = torch.from_numpy(A * scale)          # (2, 3, n, n)
        b = torch.from_numpy(rng.normal(size=(2, 3, n)))
        for method in ("jnp", "pl"):
            x = nd_solve(plan, nd_factor(K, plan, method=method), b,
                         method=method)
            np.testing.assert_allclose(
                torch.einsum("...ij,...j->...i", K, x).numpy(), b.numpy(),
                atol=1e-9)
            one = nd_solve(plan, nd_factor(K[1, 2], plan, method=method),
                           b[1, 2], method=method)
            assert torch.equal(one, x[1, 2])

    def test_prework_and_diag_delta(self):
        # nd_factor_pre(prework(K), diag_delta=w) factors K + diag(w)
        K, signs = kkt_qd(5, 4)
        n = K.shape[0]
        plan = nd_plan(K != 0, leaf=16, root_merge=64, signs=signs)
        w = np.random.default_rng(1).random(n) * signs
        b = np.random.default_rng(2).normal(size=n)
        pre = nd_prework(torch.from_numpy(K), plan)
        x = nd_solve(plan, nd_factor_pre(pre, plan,
                                         diag_delta=torch.from_numpy(w)),
                     torch.from_numpy(b))
        np.testing.assert_allclose(x.numpy(), dense_solve(K + np.diag(w), b),
                                   atol=1e-8, rtol=1e-7)
        rf = ref_nd.nd_factor_pre(
            ref_nd.nd_prework(jnp.asarray(K), plan), plan,
            diag_delta=jnp.asarray(w))
        rx = ref_nd.nd_solve(plan, rf, jnp.asarray(b))
        np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-10,
                                   rtol=1e-10)

    def test_two_solves_are_bit_identical(self):
        A = grid_spd(10, seed=4)
        plan = nd_plan(A != 0, leaf=8)
        K = torch.from_numpy(A)
        b = torch.from_numpy(np.random.default_rng(5).normal(size=100))
        x1 = nd_solve(plan, nd_factor(K, plan), b)
        x2 = nd_solve(plan, nd_factor(K, plan), b)
        assert torch.equal(x1, x2)

    def test_plan_tensors_are_cached_per_device_and_dtype(self):
        A = grid_spd(6, seed=1)
        plan = nd_plan(A != 0, leaf=8)
        nd_factor(torch.from_numpy(A), plan)
        nd_factor(torch.from_numpy(A), plan)
        assert list(plan._cache) == [("cpu", torch.float64)]
        nd_factor(torch.from_numpy(A).float(), plan)
        assert len(plan._cache) == 2

    def test_methods_and_devices(self):
        A = grid_spd(6, seed=1)
        plan = nd_plan(A != 0, leaf=8)
        with pytest.raises(ValueError, match="method"):
            nd_factor(torch.from_numpy(A), plan, method="xla")
        # a CUDA tensor refuses the library composition
        with pytest.raises(ValueError, match="CPU tensors"):
            _uses_kernels("jnp", torch.device("cuda"))
        assert _uses_kernels("auto", torch.device("cuda"))
        assert not _uses_kernels("auto", torch.device("cpu"))
        cuda_ldlt.reset_launch_counts()
        nd_factor(torch.from_numpy(A), plan, method="pl")
        assert not any(cuda_ldlt.launches.values())


class TestJit:
    def test_factor_solve_eagerly(self):
        # the reference jits this; the port runs it eagerly
        A = grid_spd(12, seed=9)
        plan = nd_plan(A != 0, leaf=16)
        b = np.random.default_rng(10).normal(size=A.shape[0])
        x = nd_solve(plan, nd_factor(torch.from_numpy(A), plan),
                     torch.from_numpy(b))
        np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-9)

    def test_disconnected(self):
        # two independent components solve as a forest
        check_roundtrip(disconnected(), leaf=8)


class TestPallasMethod:
    """method='pl' runs each level through K5/K2/K3/K4 (their plain
    versions on the CPU).  Pin parity with the library composition on a
    grid KKT."""

    def test_pl_equals_jnp(self):
        A = grid_spd(8, seed=13)
        n = A.shape[0]
        plan = nd_plan(A != 0, leaf=16)
        K = torch.from_numpy(A)
        bn = np.random.default_rng(3).normal(size=n)
        b = torch.from_numpy(bn)
        x_j = nd_solve(plan, nd_factor(K, plan, method="jnp"), b,
                       method="jnp")
        x_p = nd_solve(plan, nd_factor(K, plan, method="pl"), b,
                       method="pl")
        np.testing.assert_allclose(x_p.numpy(), x_j.numpy(), atol=1e-10,
                                   rtol=1e-10)
        np.testing.assert_allclose(x_p.numpy(), dense_solve(A, bn),
                                   atol=1e-8, rtol=1e-7)


class TestAutoFallback:
    """kernel='nd' must never silently run a plan predicted to lose to
    the dense path."""

    def test_small_grid_falls_back_to_dense(self):
        fam = grid_qp(side=6, seed=0, device="cpu")
        s = CompiledIPM(fam.settings, n=36, tol=1e-7, kernel="nd",
                        nd_leaf=8, device="cpu")
        r = s.solve(fam.data)
        assert s.nd_fell_back and s._mode == "ldlt"
        assert bool(r.converged)
        ref = ref_grid_qp(side=6, seed=0, dtype=jnp.float64)
        rs = RefIPM(ref.settings, n=36, dtype=jnp.float64, tol=1e-7,
                    kernel="nd", nd_leaf=8)
        rr = rs.solve(ref.data)
        assert rs.nd_fell_back and rs._mode == "ldlt"
        assert int(r.iterations) == int(rr.iterations)
        np.testing.assert_allclose(r.x.numpy(), np.asarray(rr.x), atol=1e-8)

    def test_fallback_disabled_keeps_nd(self):
        fam = grid_qp(side=6, seed=0, device="cpu")
        s = CompiledIPM(fam.settings, n=36, tol=1e-7, kernel="nd",
                        nd_leaf=8, nd_fallback=False, device="cpu")
        r = s.solve(fam.data)
        assert not s.nd_fell_back and s._mode == "nd"
        assert bool(r.converged)

    def test_fallback_matches_nd_solution(self):
        fam = grid_qp(side=5, seed=1, device="cpu")
        kw = dict(n=25, tol=1e-8, kernel="nd", device="cpu")
        r_fb = CompiledIPM(fam.settings, **kw).solve(fam.data)
        r_nd = CompiledIPM(fam.settings, nd_fallback=False,
                           **kw).solve(fam.data)
        np.testing.assert_allclose(r_fb.x.numpy(), r_nd.x.numpy(),
                                   atol=1e-6)

    def test_fallback_to_a_block_mode(self):
        # a dense pattern of order 400: the plan cannot win, and the
        # dense auto rule picks 'blockg' from aug_dim 384 on (x alone: no
        # 2x2 structure), as the reference's does
        fb = CompiledIPM(grid_qp(side=2, device="cpu").settings, n=400,
                         kernel="nd", nd_pattern=np.ones((400, 400), bool),
                         device="cpu")
        ref = RefIPM(ref_grid_qp(side=2).settings, n=400, kernel="nd",
                     nd_pattern=np.ones((400, 400), bool))
        assert fb.nd_fell_back and ref.nd_fell_back
        assert fb._mode == ref._mode == "blockg"
        s = CompiledIPM(grid_qp(side=2, device="cpu").settings, n=400,
                        kernel="nd", nd_pattern=np.ones((400, 400), bool),
                        nd_fallback=False, device="cpu")
        assert s._mode == "nd" and not s.nd_fell_back

    def test_predicted_speedup_equals_reference(self):
        # under the JAX package's constants (the port's default is the
        # card's fit: tests/test_torch_nd_crossover.py)
        for A in (grid_spd(16, seed=2), banded_qd(200, 3, seed=1)):
            assert nd_predicted_speedup(nd_plan(A != 0, leaf=16),
                                        REFERENCE_CONSTANTS) == \
                ref_nd.nd_predicted_speedup(ref_nd.nd_plan(A != 0, leaf=16))


# ----------------------------------------------------------------------
# the port against the JAX package
# ----------------------------------------------------------------------

PATTERNS = {
    "banded": lambda: (banded_qd(200, 3, seed=1), dict(leaf=16)),
    "grid": lambda: (grid_spd(16, seed=2), dict(leaf=16)),
    "random_sparse": lambda: (random_sparse(), dict(leaf=16)),
    "kkt_signed": lambda: (kkt_qd(12, 11)[0], dict(
        leaf=16, root_merge=64, signs=kkt_qd(12, 11)[1])),
    "kkt_unsigned": lambda: (kkt_qd(5, 4)[0], dict(leaf=16)),
    "tree": lambda: (tree_matrix(), dict(leaf=8)),
    "disconnected": lambda: (disconnected(), dict(leaf=8)),
    "clique": lambda: (np.ones((20, 20)), dict(leaf=4)),
    "no_merge": lambda: (grid_spd(10, seed=6), dict(leaf=12,
                                                    root_merge=0)),
}


@pytest.mark.parametrize("name", list(PATTERNS))
def test_plan_equals_reference(name):
    A, kw = PATTERNS[name]()
    assert_plans_equal(nd_plan(A != 0, **kw), ref_nd.nd_plan(A != 0, **kw))


@pytest.mark.parametrize("method", ["jnp", "pl"])
@pytest.mark.parametrize("name", ["grid", "kkt_signed", "kkt_unsigned",
                                  "disconnected"])
def test_factor_and_solve_match_reference(name, method):
    A, kw = PATTERNS[name]()
    if name == "grid":
        A = grid_spd(9, seed=2)        # the interpret-mode 'pl' is slow
    n = A.shape[0]
    plan = nd_plan(A != 0, **kw)
    rng = np.random.default_rng(17)
    b, Bm = rng.normal(size=n), rng.normal(size=(n, 3))
    rf = ref_nd.nd_factor(jnp.asarray(A), plan, method=method)
    pf = nd_factor(torch.from_numpy(A), plan, method=method)
    assert len(rf) == len(pf) == len(plan.levels)
    for (rl, rd, rw), (pl_, pd, pw) in zip(rf, pf):
        for r, p in ((rl, pl_), (rd, pd), (rw, pw)):
            assert tuple(p.shape) == r.shape
            np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                       atol=1e-10, rtol=1e-10)
    rx = ref_nd.nd_solve(plan, rf, jnp.asarray(b), method=method)
    px = nd_solve(plan, pf, torch.from_numpy(b), method=method)
    np.testing.assert_allclose(px.numpy(), np.asarray(rx), atol=1e-10,
                               rtol=1e-10)
    rX = ref_nd.nd_solve_matrix(plan, rf, jnp.asarray(Bm))
    pX = nd_solve_matrix(plan, pf, torch.from_numpy(Bm), method=method)
    np.testing.assert_allclose(pX.numpy(), np.asarray(rX), atol=1e-10,
                               rtol=1e-10)


def _assert_same_solve(res, ref):
    assert np.array_equal(res.iterations.numpy(),
                          np.asarray(ref.iterations))
    assert bool(res.converged.all()) and bool(jnp.all(ref.converged))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-8)
    np.testing.assert_allclose(res.objective.numpy(),
                               np.asarray(ref.objective), rtol=1e-9)


@pytest.mark.parametrize("fallback", [False, True])
def test_nd_solve_matches_reference_solver(fallback):
    n, m = 96, 12
    ref_data, data = both(sparse_qp(n, m))
    kw = dict(kernel="nd", nd_leaf=16, nd_fallback=fallback)
    ref = RefIPM(RefSettings(), n=n, m_ineq=m, **kw)
    port = port_solver(n, m, **kw)
    _assert_same_solve(port.solve(data), ref.solve(ref_data))
    assert port._mode == ref._mode == ("ldlt" if fallback else "nd")
    assert port.nd_fell_back == ref.nd_fell_back == fallback
    if fallback:
        return
    assert_plans_equal(port._nd_plan, ref._nd_plan)
    assert port._nd_diag_split == ref._nd_diag_split
    assert port.group_signs == ref.group_signs
    assert np.array_equal(port._sign_vec, ref._sign_vec)
    # three matrices go to the host once, then one question per iteration
    port.host_syncs = 0
    res = port.solve(data)
    assert port.host_syncs == int(res.iterations) + 1


def test_nd_solve_batch_matches_reference_solver():
    n, m = 64, 8
    ref_data, data = both(batch_qp(n, m))
    kw = dict(kernel="nd", nd_leaf=16, nd_fallback=False)
    ref = RefIPM(RefSettings(), n=n, m_ineq=m, **kw)
    port = CompiledIPM(settings_from_reference(RefSettings()), n=n,
                       m_ineq=m, device="cpu", **kw)
    _assert_same_solve(port.solve_batch(data), ref.solve_batch(ref_data))


def test_nd_grid_family_matches_reference_solver():
    # bench_nd's workload at a small side, fallback off as the benchmark
    ref_fam = ref_grid_qp(side=10, seed=0, dtype=jnp.float64)
    fam = grid_qp(side=10, seed=0, device="cpu")
    kw = dict(n=100, tol=1e-8, kernel="nd", nd_leaf=12, nd_fallback=False)
    ref = RefIPM(ref_fam.settings, dtype=jnp.float64, **kw)
    port = CompiledIPM(fam.settings, device="cpu", **kw)
    _assert_same_solve(port.solve(fam.data), ref.solve(ref_fam.data))
    assert port._nd_plan.top_neg == ref._nd_plan.top_neg


def test_nd_compact_and_step_paths():
    # solve_batch_compact derives the plan too and factors the full KKT
    # each iteration (no prework), as the reference's compact engine
    n, m = 64, 8
    _, data = both(batch_qp(n, m))
    nd = port_solver(n, m, kernel="nd", nd_leaf=16, tol=1e-8,
                     nd_fallback=False)
    dense = port_solver(n, m, kernel="ldlt", tol=1e-8)
    r_nd = nd.solve_batch_compact(data)
    r_d = dense.solve_batch_compact(data)
    assert nd._nd_plan is not None and bool(r_nd.converged.all())
    assert torch.equal(r_nd.iterations, r_d.iterations)
    np.testing.assert_allclose(r_nd.x.numpy(), r_d.x.numpy(), atol=1e-7)
    # refine sweeps against the assembled KKT
    rf = port_solver(n, m, kernel="nd", nd_leaf=16, tol=1e-8, refine=1,
                     nd_fallback=False)
    np.testing.assert_allclose(rf.solve_batch(data).x.numpy(),
                               r_d.x.numpy(), atol=1e-7)


def test_other_kernel_modes_solve_as_nd():
    # the block mode gives the nd path's solution on the same batch
    n, m = 8, 2
    _, data = both(batch_qp(n, m))
    r_g = port_solver(n, m, kernel="blockg", tol=1e-8).solve_batch(data)
    r_nd = port_solver(n, m, kernel="nd", nd_leaf=4, tol=1e-8,
                       nd_fallback=False).solve_batch(data)
    assert bool(r_g.converged.all()) and bool(r_nd.converged.all())
    assert torch.equal(r_g.iterations, r_nd.iterations)
    np.testing.assert_allclose(r_g.x.numpy(), r_nd.x.numpy(), atol=1e-8)


@pytest.mark.parametrize("family", ["mpc", "portfolio", "svm_dual",
                                    "projection", "grid_qp"])
def test_assemble_diag_is_the_dense_assembly_diagonal(family):
    # the diagonal taken term by term equals the assembled KKT's, bit for
    # bit, at the initial iterate and at a shifted one
    from ipmzoo_tpu_torch.models.families import FAMILIES
    kw = dict(side=5) if family == "grid_qp" else {}
    fam = FAMILIES[family](seed=3, batch=2, device="cpu", **kw)
    s = CompiledIPM(fam.settings, n=fam.n, m_ineq=fam.m_ineq, m_eq=fam.m_eq,
                    kernel="nd", nd_fallback=False, device="cpu")
    st = s.init_state(fam.data)
    for vals, mu in ((st.vars, 1.0),
                     (tuple(v.abs() + 0.5 for v in st.vars), 0.31)):
        env = s._env(fam.data, vals, mu)
        want = s._assemble_kkt(env, 2).diagonal(dim1=-2, dim2=-1)
        got = s._assemble_diag(env, 2)
        assert got.shape == want.shape and torch.equal(got, want)
