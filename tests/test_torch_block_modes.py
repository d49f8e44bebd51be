"""The block kernel modes of the port's CompiledIPM on the CPU in float64:
``ops/block_solve.py`` ('block'), ``ops/blockg.py`` ('blockg'), the
panel-blocked LDL^T mode ('jnp') and the normal-equations reduction
('normal'), each against the JAX package's on the same numpy inputs, and
the reference's auto rule for large systems.

Tolerances: factor/solve results within 1e-10 of the reference (the same
library algorithms), solver x within 1e-8 with equal iteration counts.

'normal' is held to the reference's augmented path iteration for
iteration, and to the reference's 'normal' only at its converged x: the
reference binds H^-1 through ``solve_ldlt(L, D, I)``, whose ``y / D``
divides the COLUMNS of L^-1 by D (an identity right-hand side has as
many columns as rows, so the shapes broadcast), which gives
L^-T L^-1 D^-1 instead of L^-T D^-1 L^-1.  Its directions are inexact,
and it takes more iterations to the same optimum.  The port binds the
true inverse (test_bound_inverse_is_the_inverse pins both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.ops import block_solve as ref_bs
from ipmzoo_tpu.ops import blockg as ref_bg
from ipmzoo_tpu_torch.models import CompiledIPM
from ipmzoo_tpu_torch.models.convert import qpdata_from_numpy
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.ops import block_solve as bs
from ipmzoo_tpu_torch.ops import blockg as bg

TOL = 1e-10


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def make_blocks(n, m, seed, B=2):
    """B instances of (H, B, C) as tests/test_block_solve.py draws one."""
    out = []
    for i in range(B):
        rng = np.random.default_rng(seed + i)
        M = rng.normal(size=(n, n))
        H = M @ M.T / n + np.eye(n)
        Bm = rng.normal(size=(m, n))
        Nn = rng.normal(size=(m, m))
        C = Nn @ Nn.T / max(m, 1) + np.eye(m)
        out.append((H, Bm, C))
    return [np.stack(x) for x in zip(*out)]


def t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------------------
# ops/block_solve.py
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(8, 3), (40, 17), (100, 30)])
def test_block2_matches_reference(n, m):
    H, Bm, C = make_blocks(n, m, seed=n)
    rng = np.random.default_rng(1)
    b = rng.normal(size=(2, n + m))
    f = bs.block2_factor(t(H), t(Bm), t(C))
    dx, dy = bs.block2_solve(f, t(b[:, :n]), t(b[:, n:]))
    for i in range(2):
        rf = ref_bs.block2_factor(jnp.asarray(H[i]), jnp.asarray(Bm[i]),
                                  jnp.asarray(C[i]))
        rdx, rdy = ref_bs.block2_solve(rf, jnp.asarray(b[i, :n]),
                                       jnp.asarray(b[i, n:]))
        close(dx[i], rdx)
        close(dy[i], rdy)
        K = np.block([[H[i], Bm[i].T], [Bm[i], -C[i]]])
        np.testing.assert_allclose(
            K @ np.concatenate([dx[i].numpy(), dy[i].numpy()]), b[i],
            rtol=1e-8, atol=1e-8)


def test_block2_matvec():
    H, Bm, C = make_blocks(6, 2, seed=0)
    x = np.random.default_rng(2).normal(size=(2, 8))
    y1, y2 = bs.block2_matvec(t(H), t(Bm), t(C), t(x[:, :6]), t(x[:, 6:]))
    for i in range(2):
        K = np.block([[H[i], Bm[i].T], [Bm[i], -C[i]]])
        close(np.concatenate([y1[i].numpy(), y2[i].numpy()]), K @ x[i],
              1e-12)


@pytest.mark.parametrize("inverse", [False, True])
def test_block2_no_constraints(inverse):
    H = make_blocks(5, 1, seed=3)[0]
    Bm, C = torch.zeros((2, 0, 5), dtype=torch.float64), \
        torch.zeros((2, 0, 0), dtype=torch.float64)
    b = np.random.default_rng(0).normal(size=(2, 5))
    factor, solve = ((bs.block2_factor_inv, bs.block2_solve_inv) if inverse
                     else (bs.block2_factor, bs.block2_solve))
    dx, dy = solve(factor(t(H), Bm, C), t(b),
                   torch.zeros((2, 0), dtype=torch.float64))
    assert dy.shape == (2, 0)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", H, dx.numpy()), b,
                               atol=1e-9)


def test_explicit_inverse_matches_triangular_and_reference():
    H, Bm, C = make_blocks(20, 6, seed=0)
    rng = np.random.default_rng(0)
    r1, r2 = rng.normal(size=(2, 20)), rng.normal(size=(2, 6))
    dx0, dy0 = bs.block2_solve(bs.block2_factor(t(H), t(Bm), t(C)), t(r1),
                               t(r2))
    dx1, dy1 = bs.block2_solve_inv(bs.block2_factor_inv(t(H), t(Bm), t(C)),
                                   t(r1), t(r2))
    close(dx1, dx0)
    close(dy1, dy0)
    rf = ref_bs.block2_factor_inv(jnp.asarray(H[0]), jnp.asarray(Bm[0]),
                                  jnp.asarray(C[0]))
    rdx, rdy = ref_bs.block2_solve_inv(rf, jnp.asarray(r1[0]),
                                       jnp.asarray(r2[0]))
    close(dx1[0], rdx)
    close(dy1[0], rdy)


def test_not_definite_gives_nan_not_an_error():
    # jnp.linalg.cholesky's semantics: NaN, which the IPM's rollback sees
    H, Bm, C = make_blocks(6, 2, seed=4)
    H[1] = -H[1]
    f = bs.block2_factor(t(H), t(Bm), t(C))
    low = np.tril_indices(6)
    assert bool(torch.isnan(f[0][1][low]).all()) and \
        bool(torch.isfinite(f[0][0]).all())
    rf = ref_bs.block2_factor(jnp.asarray(H[1]), jnp.asarray(Bm[1]),
                              jnp.asarray(C[1]))
    assert bool(jnp.isnan(rf[0][low]).all())
    dx, _ = bs.block2_solve(f, t(H[:, 0]), t(C[:, 0]))
    assert bool(torch.isnan(dx[1]).all()) and bool(torch.isfinite(dx[0]).all())


# ----------------------------------------------------------------------
# ops/blockg.py
# ----------------------------------------------------------------------

def _qd_dense(sizes, signs, seed=0):
    """tests/test_blockg.py's quasi-definite block matrix (the joint
    primal block SPD, the joint dual block SND), as numpy, with each
    group's slice."""
    rng = np.random.default_rng(seed)

    def spd(n):
        M = rng.normal(size=(n, n))
        return M @ M.T / max(n, 1) + np.eye(n)
    G = len(sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    pos = [i for i in range(G) if signs[i] > 0]
    neg = [i for i in range(G) if signs[i] < 0]
    P = spd(sum(sizes[i] for i in pos))
    N = spd(sum(sizes[i] for i in neg))
    Cc = rng.normal(size=(P.shape[0], N.shape[0]))
    p_off, n_off, o, q = {}, {}, 0, 0
    for i in pos:
        p_off[i], o = o, o + sizes[i]
    for i in neg:
        n_off[i], q = q, q + sizes[i]
    dense = np.zeros((offs[-1], offs[-1]))

    def sl(i):
        return slice(offs[i], offs[i] + sizes[i])
    for i in range(G):
        for j in range(G):
            si, sj = sizes[i], sizes[j]
            if signs[i] > 0 and signs[j] > 0:
                cell = P[p_off[i]:p_off[i] + si, p_off[j]:p_off[j] + sj]
            elif signs[i] < 0 and signs[j] < 0:
                cell = -N[n_off[i]:n_off[i] + si, n_off[j]:n_off[j] + sj]
            elif signs[i] > 0:
                cell = Cc[p_off[i]:p_off[i] + si, n_off[j]:n_off[j] + sj]
            else:
                cell = Cc[p_off[j]:p_off[j] + sj, n_off[i]:n_off[i] + si].T
            dense[sl(i), sl(j)] = cell
    return dense, [sl(i) for i in range(G)]


def _blocks(dense, slices, B=1):
    return [[t(np.broadcast_to(dense[a, b], (B,) + dense[a, b].shape)
               .copy()) for b in slices] for a in slices]


@pytest.mark.parametrize("sizes,signs", [
    ((8, 5), (1.0, -1.0)),
    ((10, 6, 4), (1.0, 1.0, -1.0)),
    ((7, 5, 6, 3), (1.0, -1.0, 1.0, -1.0)),
    ((9, 0, 4), (1.0, 1.0, -1.0)),      # empty middle group
])
def test_blockg_matches_reference(sizes, signs):
    dense, slices = _qd_dense(sizes, signs)
    b = np.random.default_rng(1).normal(size=dense.shape[0])
    x = bg.blockg_solve(bg.blockg_factor(_blocks(dense, slices), signs),
                        t(b)[None])
    ref_blocks = [[jnp.asarray(dense[a, c]) for c in slices] for a in slices]
    x0 = ref_bg.blockg_solve(ref_bg.blockg_factor(ref_blocks, signs),
                             jnp.asarray(b))
    close(x[0], x0)
    np.testing.assert_allclose(dense @ x[0].numpy(), b, rtol=1e-9,
                               atol=1e-9)


def test_blockg_matvec():
    sizes, signs = (6, 4, 5), (1.0, -1.0, -1.0)
    dense, slices = _qd_dense(sizes, signs, seed=2)
    x = np.random.default_rng(3).normal(size=dense.shape[0])
    parts = [t(x[s])[None] for s in slices]
    out = torch.cat(bg.blockg_matvec(_blocks(dense, slices), parts), -1)
    close(out[0], dense @ x, 1e-12)


def test_blockg_matches_block2_and_batches():
    dense, slices = _qd_dense((12, 7), (1.0, -1.0), seed=4)
    b = np.random.default_rng(5).normal(size=(3, 19))
    blocks = _blocks(dense, slices, B=3)
    xg = bg.blockg_solve(bg.blockg_factor(blocks, (1.0, -1.0)), t(b))
    H, Bm, negC = blocks[0][0], blocks[1][0], blocks[1][1]
    dx, dy = bs.block2_solve(bs.block2_factor(H, Bm, -negC), t(b[:, :12]),
                             t(b[:, 12:]))
    close(xg, torch.cat([dx, dy], -1), 1e-9)
    for i in range(3):
        one = bg.blockg_solve(bg.blockg_factor(
            _blocks(dense, slices), (1.0, -1.0)), t(b[i])[None])
        close(one[0], xg[i], 1e-12)


# ----------------------------------------------------------------------
# CompiledIPM's modes against the reference's
# ----------------------------------------------------------------------

def numpy_batch(B, n, m, m_eq=0, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    x_feas = rng.uniform(-0.5, 0.5, size=(B, n))
    A = rng.normal(size=(B, m, n))
    C = rng.normal(size=(B, m_eq, n))
    mid = np.einsum("bij,bj->bi", A, x_feas)
    return RefQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(B, n)), A_ineq=A,
        l_A_ineq=mid - 1, u_A_ineq=mid + 1,
        A_eq=C, b_eq=np.einsum("bij,bj->bi", C, x_feas),
        l_x=np.full((B, n), -2.0), u_x=np.full((B, n), 2.0))


def solve_both(settings, n, m, m_eq=0, B=3, seed=11, ref_kernel=None, **kw):
    nb = numpy_batch(B, n, m, m_eq, seed=seed)
    ref_kw = dict(kw, kernel=ref_kernel or kw.get("kernel", "auto"))
    ref = RefIPM(settings, n=n, m_ineq=m, m_eq=m_eq, **ref_kw).solve_batch(
        jax.tree_util.tree_map(jnp.asarray, nb))
    port = CompiledIPM(port_settings(settings), n, m, m_eq, device="cpu",
                       **kw)
    res = port.solve_batch(qpdata_from_numpy(nb, device="cpu"))
    return port, ref, res


SETTINGS = {
    "default": (Settings(), 3, 0),
    "slacked_eq": (Settings(
        equalities=True,
        equality_handling=EqualityHandling.SLACKED_SLACKS), 3, 2),
    "reg_naive": (Settings(
        equalities=True,
        equality_handling=EqualityHandling.REGULARIZATION,
        inequality_handling=InequalityHandling.NAIVE_SLACKS), 3, 2),
}


@pytest.mark.parametrize("kernel,point", [
    ("jnp", "default"), ("jnp", "slacked_eq"),
    ("block", "default"),
    ("blockg", "default"), ("blockg", "slacked_eq"), ("blockg", "reg_naive"),
])
def test_mode_matches_reference(kernel, point):
    settings, m, me = SETTINGS[point]
    port, ref, res = solve_both(settings, 8, m, me, kernel=kernel)
    assert port._mode == ("ldlt" if kernel == "jnp" else kernel)
    assert bool(np.all(np.asarray(ref.converged)))
    assert bool(res.converged.all())
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    close(res.x, ref.x, 1e-8)


@pytest.mark.parametrize("kernel", ["block", "blockg"])
def test_refinement_matches_reference(kernel):
    port, ref, res = solve_both(Settings(), 8, 3, kernel=kernel, refine=1,
                                seed=13)
    assert bool(res.converged.all())
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    close(res.x, ref.x, 1e-8)


def test_block_inv_matches_reference():
    port, ref, res = solve_both(Settings(), 8, 3, kernel="block",
                                block_inv=True, seed=5)
    assert port._block_inv and bool(res.converged.all())
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    close(res.x, ref.x, 1e-8)


def test_block_mode_needs_two_groups_with_x_first():
    with pytest.raises(ValueError, match="2x2"):
        CompiledIPM(port_settings(Settings(inequalities=Bounds.NONE,
                                           variable_bounds=Bounds.NONE)),
                    n=4, kernel="block", device="cpu")


@pytest.mark.parametrize("kernel,kw,blocked", [
    ("ldlt", {}, False), ("ldlt", dict(pivot_floor=1e-6), False),
    ("regldlt", dict(pivot_floor=1e-6), False), ("nd", {}, False),
    ("jnp", {}, True), ("normal", {}, True),
])
def test_dense_factor_follows_the_mode(kernel, kw, blocked):
    # ldlt_auto (K2 with K3 on the card) takes 'ldlt' and 'regldlt' at
    # any pivot floor, and a later nd fallback; 'jnp' and 'normal' the
    # panel-blocked LDL^T with library solves
    from ipmzoo_tpu_torch.ops import blocked_ldlt, cuda_ldlt
    s = CompiledIPM(port_settings(Settings()), n=8, m_ineq=3,
                    kernel=kernel, device="cpu", **kw)
    want = blocked_ldlt.solve_ldlt_blocked if blocked else \
        cuda_ldlt.solve_ldlt_auto
    assert s._solve_kernel is want


def test_non_default_pivot_floor_matches_reference():
    port, ref, res = solve_both(Settings(), 8, 3, kernel="ldlt",
                                pivot_floor=1e-6, seed=7)
    assert port._mode == "ldlt" and bool(res.converged.all())
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    close(res.x, ref.x, 1e-8)


def test_normal_matches_the_reference_augmented_path():
    # the port's normal equations give the augmented path's directions
    # to rounding: the reference's 'ldlt' iteration for iteration
    port, ref, res = solve_both(Settings(), 10, 4, kernel="normal",
                                ref_kernel="ldlt", seed=1)
    assert port.red_dim == 4 < port.aug_dim
    assert bool(res.converged.all())
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    close(res.x, ref.x, 1e-8)


def test_normal_reaches_the_reference_normal_solution():
    # the reference's own 'normal' converges to the same optimum on its
    # inexact directions (more iterations): x as tests/test_normal_eq.py
    # holds it to the augmented path
    port, ref, res = solve_both(Settings(), 10, 4, kernel="normal", seed=1)
    assert bool(np.all(np.asarray(ref.converged)))
    assert bool(res.converged.all())
    close(res.x, ref.x, 1e-6)


def test_bound_inverse_is_the_inverse():
    nb = numpy_batch(1, 6, 2, seed=2)
    port = CompiledIPM(port_settings(Settings()), 6, 2, kernel="normal",
                       device="cpu")
    data = qpdata_from_numpy(nb, device="cpu")
    st = port.init_state(data)
    env = port._env(data, st.vars, st.mu)
    port._bind_matrix_inverts(env)
    (ie,) = port._matrix_inverts
    from ipmzoo_tpu_torch.models import codegen as cg
    H = cg.evaluate(ie.child, env, {}).val
    close(env[ie].val, torch.linalg.inv(H), 1e-10)
    # the reference's binding: L^-T L^-1 D^-1 (see the module docstring)
    ref = RefIPM(Settings(), n=6, m_ineq=2, kernel="normal")
    d1 = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), nb)
    rst = ref.init_state(d1)
    renv = ref._env(d1, rst.vars, rst.mu)
    ref._bind_matrix_inverts(renv)
    from ipmzoo_tpu.ops.blocked_ldlt import ldlt_blocked
    L, D = ldlt_blocked(jnp.asarray(H[0].numpy()))
    Linv = np.linalg.inv(np.asarray(L))
    close(renv[ref._matrix_inverts[0]].val, Linv.T @ Linv /
          np.asarray(D)[None, :], 1e-10)


@pytest.mark.parametrize("ih", [InequalityHandling.SLACKS,
                                InequalityHandling.SLACKED_SLACKS,
                                InequalityHandling.NAIVE_SLACKS])
def test_normal_matches_augmented_across_handlings(ih):
    # port against port (tests/test_normal_eq.py's lattice rows)
    settings = port_settings(Settings(inequality_handling=ih))
    nb = numpy_batch(3, 6, 2, seed=9)
    data = qpdata_from_numpy(nb, device="cpu")
    ne = CompiledIPM(settings, 6, 2, kernel="normal", device="cpu")
    aug = CompiledIPM(settings, 6, 2, device="cpu")
    r_ne, r_aug = ne.solve_batch(data), aug.solve_batch(data)
    assert bool(r_ne.converged.all()) and ne.red_dim < ne.aug_dim
    assert torch.equal(r_ne.iterations, r_aug.iterations)
    close(r_ne.x, r_aug.x, 1e-8)


# ----------------------------------------------------------------------
# the structural sign rule and the auto rules
# ----------------------------------------------------------------------

def _sample_settings():
    """tests/test_blockg.py's six quasi-definite lattice points."""
    return [
        Settings(),
        Settings(inequalities=Bounds.LOWER,
                 inequality_handling=InequalityHandling.NAIVE_SLACKS),
        Settings(equalities=True,
                 equality_handling=EqualityHandling.REGULARIZATION),
        Settings(equalities=True,
                 equality_handling=EqualityHandling.SLACKED_SLACKS),
        Settings(equalities=True,
                 equality_handling=EqualityHandling
                 .PENALTY_FUNCTION_WITH_EXTRA_DUAL,
                 inequality_handling=InequalityHandling.SLACKS),
        Settings(inequalities=Bounds.NONE, variable_bounds=Bounds.BOTH),
    ]


@pytest.mark.parametrize("idx", range(6))
def test_diagonal_signs_structural(idx):
    """The assembled diagonal blocks at the initial iterate have the
    definiteness the primal/dual rule claims, and the signs are the
    reference's."""
    settings = _sample_settings()[idx]
    n, mi, me = 6, 3, 2
    mi = mi if settings.inequalities != Bounds.NONE else 0
    me = me if settings.equalities else 0
    solver = CompiledIPM(port_settings(settings), n, mi, me, device="cpu")
    assert solver.group_signs == RefIPM(settings, n=n, m_ineq=mi,
                                        m_eq=me).group_signs
    nb = numpy_batch(1, n, mi, me)
    data = qpdata_from_numpy(nb, device="cpu")
    state = solver.init_state(data)
    env = solver._env(data, state.vars, state.mu)
    blocks = solver._assemble_blocks(env, 1)
    for i, sign in enumerate(solver.group_signs):
        cell = blocks[i][i][0].numpy()
        if cell.shape[0] == 0:
            continue
        ev = np.linalg.eigvalsh(0.5 * (cell + cell.T))
        assert (sign * ev > 0).all(), (i, sign, ev)


@pytest.mark.parametrize("settings,kw", [
    (Settings(), dict(n=400, m_ineq=8)),
    (Settings(equalities=True,
              equality_handling=EqualityHandling.SLACKED_SLACKS),
     dict(n=400, m_ineq=10, m_eq=10)),
    (Settings(inequalities=Bounds.NONE,
              inequality_handling=InequalityHandling.SLACKS),
     dict(n=400)),
    (Settings(), dict(n=300, m_ineq=90)),
    (Settings(), dict(n=300, m_ineq=8)),
])
def test_auto_rule_equals_reference(settings, kw):
    port = CompiledIPM(port_settings(settings), device="cpu", **kw)
    assert port._mode == RefIPM(settings, **kw)._mode


def test_nd_fallback_takes_the_block_mode():
    # a dense pattern of order 400: the plan cannot win, and the dense
    # auto rule picks 'block' from n = 384 on, as the reference's
    from ipmzoo_tpu.models.families import grid_qp as ref_grid_qp
    from ipmzoo_tpu_torch.models.families import grid_qp
    settings = grid_qp(side=2, device="cpu").settings
    s = CompiledIPM(settings, n=400, kernel="nd",
                    nd_pattern=np.ones((400, 400), bool), device="cpu")
    ref = RefIPM(ref_grid_qp(side=2).settings, n=400, kernel="nd",
                 nd_pattern=np.ones((400, 400), bool))
    assert s.nd_fell_back and ref.nd_fell_back
    assert s._mode == ref._mode == "blockg"
