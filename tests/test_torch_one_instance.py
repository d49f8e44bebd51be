"""One instance through ``init_state`` and ``step`` of the port's engines
(CompiledIPM, RiccatiIPM, ArrowIPM, SchurIPM) against the JAX package's,
whose methods take one instance, on the CPU in float64.

The inputs are made with numpy from a seed and fed to both sides.  Each
engine tells one instance from a batch by the number of axes of one field
of the data (a batch of one stays a batch), and ``init_state`` checks and
casts the data as ``solve`` does.  Tolerances: the initial iterates agree
to rtol 1e-12 (the same arithmetic, sums in another order); one IPM step
from the reference's state, and the port's own chain of three, to rtol
1e-9, as ``tests/test_torch_mpc.py`` holds its steps.  The reference's
CompiledIPM runs its LDL^T kernels in interpret mode at an augmented
order of 8.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import Settings
from ipmzoo_tpu.models import ArrowIPM as RefArrowIPM
from ipmzoo_tpu.models import ArrowQPData as RefArrowQPData
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.models import mpc as ref_mpc
from ipmzoo_tpu.parallel.schur import BlockQPData as RefBlockQPData
from ipmzoo_tpu.parallel.schur import SchurIPM as RefSchurIPM
from ipmzoo_tpu_torch.models import ArrowIPM, CompiledIPM, RiccatiIPM
from ipmzoo_tpu_torch.models import convert
from ipmzoo_tpu_torch.models.state import tree_map, with_batch_axis
from ipmzoo_tpu_torch.parallel import SchurIPM

CPU = "cpu"


@dataclasses.dataclass
class Case:
    ref: object             # the reference's solver
    rdata: object           # one instance, as the reference takes it
    port: object            # the port's solver, float64 on the CPU
    data: object            # the same instance, without a batch axis
    wrong: object           # a port solver built for other sizes
    state_from_ref: object  # the reference's state as the port's


def _compiled():
    n, m = 5, 3
    rng = np.random.default_rng(11)
    M = rng.normal(size=(n, n))
    raw = RefQPData(
        Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
        A_ineq=rng.normal(size=(m, n)),
        l_A_ineq=-np.abs(rng.normal(size=m)) - 1,
        u_A_ineq=np.abs(rng.normal(size=m)) + 1,
        A_eq=np.zeros((0, n)), b_eq=np.zeros(0),
        l_x=np.full(n, -5.0), u_x=np.full(n, 5.0))
    settings = convert.settings_from_reference(Settings())
    return Case(
        ref=RefIPM(Settings(), n, m),
        rdata=jax.tree_util.tree_map(jnp.asarray, raw),
        port=CompiledIPM(settings, n, m, device=CPU),
        data=convert.qpdata_from_numpy(raw, device=CPU),
        wrong=CompiledIPM(settings, n + 1, m, device=CPU),
        state_from_ref=functools.partial(convert.state_from_numpy,
                                         device=CPU))


def _riccati():
    T, ns, nu = 8, 3, 2
    raw = ref_mpc.random_mpc(T, ns, nu, seed=2, state_bounds=True)
    return Case(
        ref=ref_mpc.RiccatiIPM(T, ns, nu, state_bounds=True),
        rdata=raw,
        port=RiccatiIPM(T, ns, nu, state_bounds=True, device=CPU),
        data=convert.mpc_data_from_numpy(raw, device=CPU),
        wrong=RiccatiIPM(T + 1, ns, nu, state_bounds=True, device=CPU),
        state_from_ref=functools.partial(convert.mpc_state_from_numpy,
                                         device=CPU))


def _arrow():
    n, b, t = 64, 4, 2
    rng = np.random.default_rng(9)
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
    c = np.random.default_rng(10).normal(size=n)
    raw, st, blk = RefArrowQPData.from_dense(Q, c, np.full(n, -1.0),
                                             np.full(n, 1.0), block=b)
    data = convert.arrow_qp_from_numpy(raw, device=CPU)
    N = raw.D.shape[0]
    return Case(
        ref=RefArrowIPM(N, blk, st.tip),
        rdata=raw,
        port=ArrowIPM.for_data(data, structure=st),
        data=data,
        wrong=ArrowIPM(N + 1, blk, st.tip, device=CPU),
        state_from_ref=functools.partial(convert.arrow_state_from_numpy,
                                         device=CPU))


def _schur():
    blocks, n, m_c = 3, 4, 2
    rng = np.random.default_rng(7)
    M = rng.normal(size=(blocks, n, n))
    raw = RefBlockQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(blocks, n)),
        F=rng.normal(size=(blocks, m_c, n)) / blocks,
        l_x=np.full((blocks, n), -3.0), u_x=np.full((blocks, n), 3.0),
        g=rng.normal(size=(m_c,)) * 0.1)
    return Case(
        ref=RefSchurIPM(n, m_c),
        rdata=jax.tree_util.tree_map(jnp.asarray, raw),
        port=SchurIPM(n, m_c, device=CPU),
        data=convert.block_qp_from_numpy(raw, device=CPU),
        wrong=SchurIPM(n + 1, m_c, device=CPU),
        state_from_ref=None)


BUILDERS = {"compiled": _compiled, "riccati": _riccati, "arrow": _arrow,
            "schur": _schur}
ENGINES = list(BUILDERS)
#: the engines whose reference takes one instance in ``step`` too
STEPPERS = ["compiled", "riccati"]


@functools.lru_cache(maxsize=None)
def case(name) -> Case:
    return BUILDERS[name]()


def leaves(state):
    """(name, tensor) of every tensor of a port state, in field order."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, tuple):
            out += [(f"{f.name}[{i}]", a) for i, a in enumerate(v)]
        elif v is not None:
            out.append((f.name, v))
    return out


def assert_close_to_reference(p, r, rtol, atol):
    """Every field of the port's one-instance state ``p`` against the
    reference's ``r``: same shape, within rtol / atol."""
    for f in dataclasses.fields(p):
        got, want = getattr(p, f.name), getattr(r, f.name)
        if got is None:
            continue
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for a, b in pairs:
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape, f.name
            np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol,
                                       err_msg=f.name)


@pytest.mark.parametrize("engine", ENGINES)
def test_init_state_of_one_instance_equals_reference(engine):
    c = case(engine)
    assert_close_to_reference(c.port.init_state(c.data),
                              c.ref.init_state(c.rdata), 1e-12, 1e-14)


@pytest.mark.parametrize("engine", STEPPERS)
def test_steps_of_one_instance_equal_reference(engine):
    """Three chained steps: each port step from the reference's state
    lands on the reference's next state, and so does the port's own
    chain from its own ``init_state``."""
    c = case(engine)
    r_state = c.ref.init_state(c.rdata)
    p_state = c.port.init_state(c.data)
    for _ in range(3):
        p_from_ref = c.port.step(c.state_from_ref(r_state), c.data)
        r_state = c.ref.step(r_state, c.rdata)
        p_state = c.port.step(p_state, c.data)
        assert_close_to_reference(p_from_ref, r_state, 1e-9, 1e-11)
        assert_close_to_reference(p_state, r_state, 1e-9, 1e-11)


@pytest.mark.parametrize("engine", ENGINES)
def test_float32_data_is_cast_to_the_solver_dtype(engine):
    c = case(engine)
    d32 = c.data.to(dtype=torch.float32)
    got = c.port.init_state(d32)
    want = c.port.init_state(d32.to(dtype=torch.float64))
    for (name, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert got.residual.dtype == torch.float64


@pytest.mark.parametrize("engine", ENGINES)
def test_a_batch_of_one_stays_a_batch(engine):
    c = case(engine)
    one = c.port.init_state(c.data)
    batch = c.port.init_state(with_batch_axis(c.data, True))
    for (name, a), (_, b) in zip(leaves(one), leaves(batch)):
        assert tuple(b.shape) == (1,) + tuple(a.shape), name
        assert torch.equal(b[0], a), name
    if engine in STEPPERS:
        stepped = c.port.step(batch, with_batch_axis(c.data, True))
        for (name, a), (_, b) in zip(leaves(c.port.step(one, c.data)),
                                     leaves(stepped)):
            assert tuple(b.shape) == (1,) + tuple(a.shape), name
            assert torch.equal(b[0], a), name


@pytest.mark.parametrize("engine", ENGINES)
def test_wrong_sizes_raise(engine):
    c = case(engine)
    with pytest.raises(ValueError):
        c.wrong.init_state(c.data)
    with pytest.raises(ValueError):
        c.wrong.init_state(with_batch_axis(c.data, True))


@pytest.mark.parametrize("engine", ENGINES)
def test_data_on_another_device_raises(engine):
    c = case(engine)
    with pytest.raises(ValueError, match="meta"):
        c.port.init_state(tree_map(lambda a: a.to(device="meta"), c.data))
