"""The port's SoA evaluator (ipmzoo_tpu_torch/models/codegen_soa.py, torch
emitter) against the reference's ipmzoo_tpu/models/codegen_soa.py on the
same numpy values: every derived expression of the fused engine, the
pieces built on them, and the SoA quirks one by one.  Each side derives
its expressions with its own symbolic package; the lists are built in the
same order and their printed forms are held equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.formulations import Bounds, EqualityHandling, Settings
from ipmzoo_tpu.models import codegen_soa as ref_soa
from ipmzoo_tpu.models.fused import FusedBatchedIPM as RefFused
from ipmzoo_tpu.symbolic import expr as RE
from ipmzoo_tpu_torch.models import codegen_soa as soa
from ipmzoo_tpu_torch.models.convert import settings_from_reference
from ipmzoo_tpu_torch.models.fused import DATA_FIELDS, FusedBatchedIPM
from ipmzoo_tpu_torch.symbolic import expr as E

BT = 5
FORMULATIONS = [
    (Settings(), 4, 3, 0),
    (Settings(inequalities=Bounds.NONE), 4, 0, 0),
    (Settings(variable_bounds=Bounds.LOWER, equalities=True,
              equality_handling=EqualityHandling.PENALTY_FUNCTION), 4, 2, 2),
]


def close(port_tv, ref_tv):
    assert port_tv.tag == ref_tv.tag
    r = np.asarray(ref_tv.val)
    p = port_tv.val.numpy()
    shape = np.broadcast_shapes(r.shape, p.shape)
    np.testing.assert_allclose(np.broadcast_to(p, shape),
                               np.broadcast_to(r, shape), rtol=1e-13,
                               atol=1e-13)


class Pair:
    """The reference and the port fused solvers with one SoA environment
    of random values on each side."""

    def __init__(self, settings, n, m, e, seed=0):
        self.ref = RefFused(settings, n, m, e, bt=BT, dtype=jnp.float64)
        self.port = FusedBatchedIPM(settings_from_reference(settings), n, m,
                                    e, bt=BT, dtype=torch.float64,
                                    device="cpu")
        self.ev = soa.TorchSoA(torch.float64, "cpu", BT)
        rng = np.random.default_rng(seed)
        shapes = {"Q": (n, n), "c": (n,), "A_ineq": (m, n),
                  "l_A_ineq": (m,), "u_A_ineq": (m,), "A_eq": (e, n),
                  "b_eq": (e,), "l_x": (n,), "u_x": (n,)}
        self.data = {f: rng.normal(size=shapes[f] + (BT,))
                     for f in DATA_FIELDS}
        self.vars = [rng.uniform(0.5, 2.0, size=(sz, BT))
                     for sz in self.port.var_sizes]
        self.deltas = [rng.normal(size=(sz, BT))
                       for sz in self.port.var_sizes]
        self.mu = rng.uniform(0.1, 1.0, size=(1, BT))

    def ref_env(self, vals=None, mu=None):
        o = self.ref.symbols
        tvs = {getattr(o, f): ref_soa.TV("matrix" if a.ndim == 3
                                         else "vector", jnp.asarray(a))
               for f, a in self.data.items()}
        vals = self.vars if vals is None else vals
        return self.ref._env_soa(tvs, tuple(jnp.asarray(v) for v in vals),
                                 jnp.asarray(self.mu if mu is None else mu))

    def port_env(self, vals=None, mu=None):
        o = self.port.symbols
        tvs = {getattr(o, f): soa.TV("matrix" if a.ndim == 3 else "vector",
                                     torch.tensor(a))
               for f, a in self.data.items()}
        vals = self.vars if vals is None else vals
        return self.port._env_soa(tvs, tuple(torch.tensor(v) for v in vals),
                                  torch.tensor(self.mu if mu is None else mu))

    def port_make_env(self, vals, mu):
        return self.port._env_soa(
            {k: v for k, v in self.port_env().items()
             if k not in self.port.full.variables}, vals, mu)


@pytest.fixture(scope="module", params=range(len(FORMULATIONS)))
def pair(request):
    return Pair(*FORMULATIONS[request.param])


def test_every_derived_expression(pair):
    def derived(s, zero):
        exprs = list(s.full.rhs)
        exprs += [c for row in s.aug.lhs for c in row if c is not zero]
        return exprs + [d for _, d, _ in s.corrector]

    port_exprs = derived(pair.port, E.ZERO)
    ref_exprs = derived(pair.ref, RE.ZERO)
    assert [str(e) for e in port_exprs] == [str(e) for e in ref_exprs]
    renv_ref, renv_port = pair.ref_env(), pair.port_env()
    rm, pm = {}, {}
    for e, ref_e in zip(port_exprs, ref_exprs):
        close(soa.evaluate(pair.ev, e, renv_port, pm),
              ref_soa.evaluate(ref_e, renv_ref, rm))


@pytest.mark.parametrize("corrector", [False, True])
def test_residual_env_and_augmented_rhs(pair, corrector):
    mu_r = np.full((1, BT), 0.3)
    kw_ref, kw_port = {}, {}
    if corrector:
        kw_ref = dict(data_tvs={k: v for k, v in pair.ref_env().items()
                                if k not in pair.ref.full.variables},
                      var_vals=tuple(jnp.asarray(v) for v in pair.vars),
                      affine_deltas=tuple(jnp.asarray(d)
                                          for d in pair.deltas))
        kw_port = dict(var_vals=tuple(torch.tensor(v) for v in pair.vars),
                       affine_deltas=tuple(torch.tensor(d)
                                           for d in pair.deltas))
    r = pair.ref._residual_env_soa(pair.ref_env(), jnp.asarray(mu_r),
                                   **kw_ref)
    p = pair.port._residual_env_soa(pair.ev, pair.port_make_env,
                                    pair.port_env(), torch.tensor(mu_r),
                                    **kw_port)
    for (vec, _, _), (ref_vec, _, _) in zip(pair.port.corrector,
                                            pair.ref.corrector):
        close(p[vec], r[ref_vec])
    rm = {}
    for part, (expr, sz) in zip(pair.port._aug_rhs_soa(pair.ev, p),
                                zip(pair.ref.aug.rhs, pair.ref.aug_sizes)):
        ref_part = ref_soa.as_vector(ref_soa.evaluate(expr, r, rm), sz, BT,
                                     jnp.float64)
        close(soa.vector(part), ref_soa.vector(ref_part))


def test_metrics(pair):
    zero = np.zeros((1, BT))
    res_r, gap_r = pair.ref._metrics_soa(pair.ref_env(mu=zero), BT)
    res_p, gap_p = pair.port._metrics_soa(pair.ev, pair.port_env(mu=zero))
    np.testing.assert_allclose(res_p.numpy(), np.asarray(res_r), rtol=1e-13)
    np.testing.assert_allclose(gap_p.numpy(), np.asarray(gap_r), rtol=1e-13)


def test_assembled_kkt(pair):
    K_r = pair.ref._assemble_soa(pair.ref_env(), BT)
    K_p = pair.port._assemble_soa(pair.ev, pair.port_env())
    np.testing.assert_allclose(K_p.numpy(), np.asarray(K_r), rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_safe_reciprocal_maps_zero_to_float32_sqrt_max(dtype):
    ev = soa.TorchSoA(dtype, "cpu", 3)
    x = torch.tensor([[0.0, 2.0, -4.0]], dtype=dtype)
    out = ev.recip(x)
    ref = ref_soa._safe_reciprocal(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 0].item() == float(np.sqrt(np.finfo(np.float32).max))


def test_literals_are_float32():
    ev = soa.TorchSoA(torch.float64, "cpu", 2)
    v = soa.evaluate(ev, E.number(0.1), {})
    r = ref_soa.evaluate(RE.number(0.1), {})
    assert v.val.dtype == torch.float32
    assert v.val.item() == float(np.asarray(r.val).item()) == \
        float(np.float32(0.1))
    # a float32 literal meets a float64 vector as its float32 value
    e = E.named_vector("w")
    w = torch.ones((3, 2), dtype=torch.float64)
    prod = soa.evaluate(ev, E.product([E.number(0.1), e]),
                        {e: soa.vector(w)})
    assert prod.val.dtype == torch.float64
    assert prod.val[0, 0].item() == float(np.float32(0.1))


def test_vector_products_and_empty_operands():
    ev = soa.TorchSoA(torch.float64, "cpu", 2)
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.float64)
    dot = soa.multiply_tv(ev, soa.vector(a), soa.TV("rowvec", a))
    assert dot.tag == "scalar"
    np.testing.assert_array_equal(dot.val.numpy(), [[10.0, 20.0]])
    empty = torch.zeros((0, 2), dtype=torch.float64)
    s = soa.add_tv(ev, soa.vector(empty), soa.vector(a))
    assert s.tag == "vector" and torch.equal(s.val, a)
    z = soa.as_vector(ev, soa.vector(empty), 3)
    assert tuple(z.shape) == (3, 2) and not z.any()
