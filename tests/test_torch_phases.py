"""Kernel T3, the prefixes of one fused iteration, against the reference
tool's Pallas kernel.

For each of the five prefixes the same numpy data goes through

(a) ``tools/fused_phases.py:phase_kernel`` around the reference's
    ``FusedBatchedIPM``, run in interpret mode by a ``pl.pallas_call``
    built here (bt=128),
(b) the port's plain prefix (``models/fused_phases.py:phase_plain``) on
    the CPU, and
(c) a g++ host build of the generated phase source
    (``models/fused_phases.py:phase_source``), whose entry points loop
    on the host when ``__CUDACC__`` is unset.

float64 agrees to 1e-10 relative (the sum over K is taken in another
order), float32 to 1e-4.  Besides ``Settings()`` at the fused slice's
sizes (n=16, m=8) and at narrow ones (6, 3), three more points of the
formulation lattice are held the same way (in
``test_torch_phases_lattice.py``, a file of its own so that neither runs
long).  The reference kernel writes
one value per instance (``acc``); the port's second output, ``sink``,
which keeps every phase's work alive, is held between (b) and (c).
"""

import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ipmzoo_tpu.formulations import Bounds, EqualityHandling, Settings
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.models.fused import FusedBatchedIPM as RefFused
from ipmzoo_tpu_torch.models import fused_phases as fp
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.convert import qpdata_from_numpy
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.ops import cuda_fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BT = 128
TOL = {"float32": 1e-4, "float64": 1e-10}
PHASES = range(len(fp.PHASES))

POINTS = {
    # (settings, n, m_ineq, m_eq)
    "slice": (Settings(), 16, 8, 0),
    "narrow": (Settings(), 6, 3, 0),
    "box_only": (Settings(inequalities=Bounds.NONE), 5, 0, 0),
    "equalities_slacked": (Settings(
        equalities=True,
        equality_handling=EqualityHandling.SLACKED_SLACKS), 5, 3, 2),
    "equalities_penalty": (Settings(
        equalities=True,
        equality_handling=EqualityHandling.PENALTY_FUNCTION), 5, 3, 2),
}


@pytest.fixture(scope="module")
def tool():
    """tools/fused_phases.py, loaded as a module (it is a script)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_fused_phases",
        os.path.join(ROOT, "tools", "fused_phases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile a generated phase source for the host; cached by text."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) found to build the "
                    "generated phase sources")
    root = tmp_path_factory.mktemp("t3")

    @functools.lru_cache(maxsize=None)
    def build(source: str) -> ctypes.CDLL:
        key = hashlib.sha256(source.encode()).hexdigest()[:16]
        src, lib = root / f"t3-{key}.cc", root / f"t3-{key}.so"
        src.write_text(source)
        proc = subprocess.run(
            [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-x", "c++", str(src), "-o", str(lib)],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return ctypes.CDLL(str(lib))

    return build


def numpy_data(n, m, e, B=BT, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    A_eq = rng.normal(size=(B, e, n))
    x0 = rng.uniform(-0.5, 0.5, size=(B, n))
    return RefQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(B, n)), A_ineq=rng.normal(size=(B, m, n)),
        l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
        A_eq=A_eq, b_eq=np.einsum("bij,bj->bi", A_eq, x0),
        l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0))


def reference_prefix(tool, fused, data, phase):
    """The reference kernel's (1, bt) output for one prefix."""
    dt = fused.dtype
    o = fused.symbols
    field_of = {o.Q: data.Q, o.c: data.c, o.A_ineq: data.A_ineq,
                o.l_A_ineq: data.l_A_ineq, o.u_A_ineq: data.u_A_ineq,
                o.A_eq: data.A_eq, o.b_eq: data.b_eq, o.l_x: data.l_x,
                o.u_x: data.u_x}
    arrays = [jnp.moveaxis(jnp.asarray(field_of[sym], dt), 0, -1)
              for sym, _ in fused._data_syms]
    bt, N = fused.bt, fused.aug_dim
    whole = [pl.BlockSpec(a.shape, (lambda *_, _nd=a.ndim: (0,) * _nd),
                          memory_space=pltpu.VMEM) for a in arrays]
    call = pl.pallas_call(
        functools.partial(tool.phase_kernel, fused, phase),
        grid=(1,), in_specs=whole,
        out_specs=pl.BlockSpec((1, bt), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, bt), dt),
        scratch_shapes=[pltpu.VMEM((N, N, bt), dt), pltpu.VMEM((N, bt), dt),
                        pltpu.VMEM((N, bt), dt)],
        interpret=True)
    return np.asarray(call(*arrays))


@functools.lru_cache(maxsize=None)
def solvers(point, dtype):
    settings, n, m, e = POINTS[point]
    ref = RefFused(settings, n=n, m_ineq=m, m_eq=e, bt=BT,
                   dtype=jnp.dtype(dtype), tol=1e-5, max_iter=1)
    port = FusedBatchedIPM(port_settings(settings), n=n, m_ineq=m, m_eq=e,
                           bt=BT, dtype=getattr(torch, dtype), tol=1e-5,
                           max_iter=1, device="cpu")
    return ref, port


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale > 0 else 1.0)


def hold_three_ways(tool, host_build, point, dtype, phase):
    ref, port = solvers(point, dtype)
    _, n, m, e = POINTS[point]
    data = numpy_data(n, m, e)
    want = reference_prefix(tool, ref, data, phase)
    soa, _ = port.soa_inputs(qpdata_from_numpy(
        data, dtype=getattr(torch, dtype), device="cpu"))
    acc, sink = fp.phase(port, soa, phase)
    fn = cuda_fused.bind_phase(host_build(fp.phase_source(port, phase)),
                               port.dtype)
    (hacc, hsink), err = cuda_fused.call_phase(fn, soa,
                                               port.kernel_params())
    assert err == 0
    assert np.isfinite(want).all() and bool(torch.isfinite(sink).all())
    tol = TOL[dtype]
    assert rel(acc.numpy(), want) <= tol, (point, dtype, phase)
    assert rel(hacc.numpy(), want) <= tol, (point, dtype, phase)
    assert rel(hsink.numpy(), sink.numpy()) <= tol, (point, dtype, phase)
    if phase == 0:
        assert not want.any() and not acc.any() and not hacc.any()
    else:
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("point", ["slice", "narrow"])
def test_prefix_three_ways(tool, host_build, point, dtype, phase):
    hold_three_ways(tool, host_build, point, dtype, phase)


@pytest.mark.parametrize("phase", PHASES)
def test_repetitions_and_metrics_nudge(host_build, phase):
    """``reps`` repeats the prefix on the iterate scaled by 1 + 1e-6 r;
    ``perturb`` nudges the three metrics calls apart.  Host build against
    the plain version, and the sizes of the effects."""
    _, port = solvers("narrow", "float64")
    _, n, m, e = POINTS["narrow"]
    soa, _ = port.soa_inputs(qpdata_from_numpy(numpy_data(n, m, e, B=16),
                                               device="cpu"))
    fn = cuda_fused.bind_phase(host_build(fp.phase_source(port, phase)),
                               port.dtype)
    one = fp.phase(port, soa, phase)
    for reps, perturb in ((3, 0), (2, 1)):
        acc, sink = fp.phase(port, soa, phase, reps, perturb)
        (hacc, hsink), err = cuda_fused.call_phase(
            fn, soa, port.kernel_params(), reps, perturb)
        assert err == 0
        assert rel(hacc.numpy(), acc.numpy()) <= 1e-10
        assert rel(hsink.numpy(), sink.numpy()) <= 1e-10
        # r repetitions sum r nearly equal values
        assert rel(sink.numpy(), reps * one[1].numpy()) <= 1e-3
    # zero repetitions: nothing runs
    (zacc, zsink), _ = cuda_fused.call_phase(fn, soa, port.kernel_params(),
                                             0, 0)
    assert not zacc.any() and not zsink.any()


def test_phase_source_is_k1s_form_with_one_prefix():
    _, port = solvers("slice", "float32")
    k1 = port.kernel_source()
    form = k1[k1.index("struct Form {"):k1.index("IPMZOO_FUSED_ENTRY_POINTS("
                                                 "ipmzoo_fused::Form)")]
    texts = [fp.phase_source(port, p) for p in PHASES]
    for p, text in enumerate(texts):
        assert form in text
        assert f"IPMZOO_PHASE_ENTRY_POINTS(ipmzoo_fused::Form, {p})" in text
        assert fp.PHASE_CUH.read_text() in text
        assert text == fp.phase_source(port, p)
    assert len(set(texts)) == len(texts)
    # independent of the dtype and the scalar settings, as K1's text
    _, port64 = solvers("slice", "float64")
    assert fp.phase_source(port64, 3) == texts[3]
    with pytest.raises(ValueError, match="phase 5"):
        fp.phase_source(port, 5)


def test_phase_on_the_cpu_counts_no_launch_and_cuda_only_entry_raises():
    cuda_fused.reset_launch_counts()
    _, port = solvers("narrow", "float64")
    soa, _ = port.soa_inputs(qpdata_from_numpy(numpy_data(6, 3, 0, B=4),
                                               device="cpu"))
    fp.phase(port, soa, 4)
    assert cuda_fused.launches == {"fused": 0, "phase": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fused.phase_soa(fp.phase_source(port, 0), soa,
                             port.kernel_params())
