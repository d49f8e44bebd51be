"""Batched evaluator of the port (ipmzoo_tpu_torch/models/codegen.py)
against ``jax.vmap`` of the reference's (ipmzoo_tpu/models/codegen.py).

Each side derives its systems with its own symbolic package (the
reference's ``Settings`` reach the port through
``settings_from_reference``).  Every augmented-system cell and right-hand
side of two formulations is evaluated on the same random batch, float64,
atol 1e-13: ``Settings()``
and ``Settings()`` with ``m_ineq=0``, whose inequality groups are empty
(B, 0) operands that broadcast as zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

import ipmzoo_tpu.symbolic as ref_sym
import ipmzoo_tpu_torch.symbolic as port_sym
from ipmzoo_tpu.formulations import Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import codegen as jcg
from ipmzoo_tpu_torch.models import CompiledIPM, QPData
from ipmzoo_tpu_torch.models import codegen as cg
from ipmzoo_tpu_torch.models.convert import settings_from_reference
from ipmzoo_tpu_torch.symbolic import number, product, sum_expr, variable

B = 5


def random_inputs(solver, seed):
    """Problem data, a strictly interior iterate and mu, as numpy."""
    rng = np.random.default_rng(seed)
    n, m, me = solver.n, solver.m_ineq, solver.m_eq
    M = rng.normal(size=(B, n, n))
    data = {
        "Q": np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        "c": rng.normal(size=(B, n)),
        "A_ineq": rng.normal(size=(B, m, n)),
        "l_A_ineq": -np.abs(rng.normal(size=(B, m))) - 1,
        "u_A_ineq": np.abs(rng.normal(size=(B, m))) + 1,
        "A_eq": rng.normal(size=(B, me, n)),
        "b_eq": rng.normal(size=(B, me)),
        "l_x": -np.abs(rng.normal(size=(B, n))) - 1,
        "u_x": np.abs(rng.normal(size=(B, n))) + 1,
    }
    var_vals = [rng.uniform(0.5, 2.0, size=(B, sz))
                for sz in solver.var_sizes]
    mu = rng.uniform(0.1, 1.0, size=(B,))
    return data, var_vals, mu


def jax_env(solver, data, var_vals, mu):
    """The reference's per-instance environment (to be vmapped)."""
    o = solver.symbols
    env = {getattr(o, k): (jcg.matrix(v) if v.ndim == 2 else jcg.vector(v))
           for k, v in data.items()}
    env[o.delta_eq] = jcg.scalar(jnp.asarray(solver.delta0))
    env[o.mu] = jcg.scalar(mu)
    env[o.e_var] = jcg.vector(jnp.ones(solver.n))
    env[o.e_ineq] = jcg.vector(jnp.ones(solver.m_ineq))
    env[o.e_eq] = jcg.vector(jnp.ones(solver.m_eq))
    for var, val in zip(solver.full.variables, var_vals):
        env[var] = jcg.vector(val)
    return env


def jax_outputs(solver, data, var_vals, mu):
    def one(data, var_vals, mu):
        env = jax_env(solver, data, var_vals, mu)
        memo = {}
        cells = [jcg.as_block(jcg.evaluate(c, env, memo), si, sj)
                 for row, si in zip(solver.aug.lhs, solver.aug_sizes)
                 for c, sj in zip(row, solver.aug_sizes)
                 if c is not ref_sym.ZERO]
        for vec, definition, _ in solver.corrector:
            env[vec] = jcg.evaluate(definition, env, {})
        rhs = [jcg.as_vector(jcg.evaluate(r, env, {}), sz)
               for r, sz in zip(solver.aug.rhs, solver.aug_sizes)]
        return cells, rhs

    jd = {k: jnp.asarray(v) for k, v in data.items()}
    return jax.vmap(one)(jd, [jnp.asarray(v) for v in var_vals],
                         jnp.asarray(mu))


def torch_outputs(solver, data, var_vals, mu):
    td = QPData(**{k: torch.from_numpy(v) for k, v in data.items()})
    env = solver._env(td, [torch.from_numpy(v) for v in var_vals],
                      torch.from_numpy(mu))
    memo = {}
    cells = [cg.as_block(cg.evaluate(c, env, memo), si, sj)
             for row, si in zip(solver.aug.lhs, solver.aug_sizes)
             for c, sj in zip(row, solver.aug_sizes)
             if c is not port_sym.ZERO]
    for vec, definition, _ in solver.corrector:
        env[vec] = cg.evaluate(definition, env, {})
    rhs = [cg.as_vector(cg.evaluate(r, env, {}), sz)
           for r, sz in zip(solver.aug.rhs, solver.aug_sizes)]
    return cells, rhs


@pytest.mark.parametrize("m_ineq", [3, 0])
def test_augmented_cells_and_rhs_match_reference(m_ineq):
    solver = CompiledIPM(settings_from_reference(Settings()), n=4,
                         m_ineq=m_ineq, device="cpu")
    ref = RefIPM(Settings(), n=4, m_ineq=m_ineq)
    assert [str(v) for v in ref.full.variables] == \
        [str(v) for v in solver.full.variables]
    inputs = random_inputs(solver, seed=m_ineq)
    j_cells, j_rhs = jax_outputs(ref, *inputs)
    t_cells, t_rhs = torch_outputs(solver, *inputs)
    assert len(t_cells) == len(j_cells) > 0
    assert len(t_rhs) == len(j_rhs) > 0
    for t, j in zip(t_cells + t_rhs, list(j_cells) + list(j_rhs)):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_safe_reciprocal_matches_reference(dtype):
    x = np.array([2.0, 0.0, -4.0, 0.5])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = np.asarray(jcg._safe_reciprocal(jnp.asarray(x, jdt)))
    out = cg._safe_reciprocal(torch.tensor(x, dtype=dtype))
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.numpy(), ref)
    # zero maps to sqrt(dtype max), finite
    assert out[1].item() == float(np.sqrt(np.finfo(ref.dtype).max))


def expressions(sym):
    """The leaves x, y, Q, A and the test expressions over them, built
    with the symbolic package ``sym`` (each evaluator takes its own
    package's expressions)."""
    x, y = sym.variable("x"), sym.variable("y")
    Q, A = sym.symmetric_matrix("Q"), sym.matrix("A")
    product, sum_expr, diag = sym.product, sym.sum_expr, sym.diagonal_matrix
    return (x, y, Q, A), {
        "matvec": product([A, x]),
        "quadratic_form": product([sym.transpose(x), Q, x]),
        "dot": product([sym.transpose(x), y]),
        "rowvec_times_matrix": product([sym.transpose(x), Q]),
        "diag_times_vector": product([diag(x), y]),
        "diag_times_diag": product([diag(x), diag(y)]),
        "diag_plus_matrix": sum_expr([Q, diag(y)]),
        "inverse_diag": sym.invert(diag(x)),
        "sum_with_negate": sum_expr([x, sym.negate(y)]),
        "matrix_product": product([sym.transpose(A), A]),
    }


(x, y, Q, A), EXPRESSIONS = expressions(port_sym)
REF_LEAVES, REF_EXPRESSIONS = expressions(ref_sym)


def small_env(lib, wrap, leaves=(x, y, Q, A)):
    """One batch of two instances bound for the expressions above."""
    x, y, Q, A = leaves
    xs = np.array([[1.0, 2.0, 3.0], [0.5, -1.0, 2.0]])
    ys = np.array([[4.0, 5.0, 6.0], [1.0, 1.0, -2.0]])
    Qs = np.array([[[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 4.0]]] * 2)
    As = np.array([[[1.0, 0.0, 2.0], [0.0, 1.0, 0.0]]] * 2)
    return {x: lib.vector(wrap(xs)), y: lib.vector(wrap(ys)),
            Q: lib.matrix(wrap(Qs)), A: lib.matrix(wrap(As))}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_expression_semantics_match_reference(name):
    e = EXPRESSIONS[name]
    t = cg.evaluate(e, small_env(cg, torch.from_numpy))
    jenv = small_env(jcg, jnp.asarray, REF_LEAVES)
    ref_e = REF_EXPRESSIONS[name]
    assert str(ref_e) == str(e)

    def one(vals):
        env = {k: jcg.TV(tv.tag, v) for (k, tv), v in
               zip(jenv.items(), vals)}
        res = jcg.evaluate(ref_e, env)
        return res.val, res.tag

    ref_val = jax.vmap(lambda vals: one(vals)[0])(
        [tv.val for tv in jenv.values()])
    assert t.tag == one([tv.val[0] for tv in jenv.values()])[1]
    np.testing.assert_allclose(t.val.numpy(), np.asarray(ref_val),
                               rtol=1e-15)


def test_empty_operand_broadcasts_as_zero():
    w = variable("w")
    env = small_env(cg, torch.from_numpy)
    env[w] = cg.vector(torch.zeros((2, 0), dtype=torch.float64))
    v = cg.evaluate(sum_expr([x, w]), env)
    assert torch.equal(v.val, env[x].val)
    assert torch.equal(cg.as_vector(env[w], 3),
                       torch.zeros((2, 3), dtype=torch.float64))


def test_scalars_broadcast_per_instance():
    mu = variable("mu_s")
    env = small_env(cg, torch.from_numpy)
    env[mu] = cg.scalar(torch.tensor([2.0, -1.0], dtype=torch.float64))
    v = cg.evaluate(product([mu, Q]), env)
    np.testing.assert_allclose(v.val[1].numpy(), -env[Q].val[1].numpy())
    blk = cg.as_block(env[mu], 3, 3)
    assert torch.equal(blk[0], 2.0 * torch.eye(3, dtype=torch.float64))


def test_literal_numbers_do_not_promote():
    env = {x: cg.vector(torch.ones((2, 3), dtype=torch.float32))}
    v = cg.evaluate(product([number(0.5), x]), env)
    assert v.val.dtype == torch.float32
    with pytest.raises(TypeError, match="batch axis"):
        cg.as_vector(cg.evaluate(number(1.0), {}), 1)


def test_unbound_symbol_raises_and_env_short_circuits():
    with pytest.raises(KeyError):
        cg.evaluate(variable("unbound"), {})
    e = product([A, x])
    env = small_env(cg, torch.from_numpy)
    pinned = cg.vector(torch.full((2, 2), 9.0, dtype=torch.float64))
    assert cg.evaluate(e, {**env, e: pinned}) is pinned
