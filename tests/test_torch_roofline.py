"""The roofline measurement kernels T1, T2a, T2b of the port against the
reference tool's Pallas kernels.

The same inputs, made from numpy seeds, go through

(a) the kernels of ``tools/roofline.py`` (``_fma_kernel``,
    ``_factor_bench_kernel``, ``_solve_bench_kernel``), run in interpret
    mode by a ``pl.pallas_call`` built here around them,
(b) the port's plain versions (``ops/cuda_roofline.py``) on the CPU, and
(c) a g++ host build of ``csrc/roofline.cu``: its per-element bodies are
    ``__host__ __device__`` and its entry points loop on the host when
    ``__CUDACC__`` is unset.

float64 agrees to 1e-12 relative, float32 to 1e-5 (sums are taken in
another order and, on the reference's side, in fused multiply-adds or
not as XLA decides).  The tool's ``fused_flops`` and ``quasidef_tile``
have their own copies in the port, equal array for array.
"""

import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ipmzoo_tpu_torch.ops import _build, cuda_roofline as cr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "float64": 1e-12}
PIVOT_FLOOR = 1e-8


@pytest.fixture(scope="module")
def tool():
    """tools/roofline.py, loaded as a module (it is a script)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_roofline", os.path.join(ROOT, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/roofline.cu compiled for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) found to build roofline.cu")
    lib = tmp_path_factory.mktemp("roofline") / "roofline_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", str(_build.CSRC / "roofline.cu"), "-o", str(lib)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return cr.bind(ctypes.CDLL(str(lib)))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def reps_inputs(N, bt, dtype):
    K0 = cr.quasidef_tile(N, bt).astype(dtype)
    b0 = np.random.default_rng(1).standard_normal((N, bt)).astype(
        np.float32).astype(dtype)
    return K0, b0


def whole(a):
    """A BlockSpec taking the whole array into the kernel."""
    return pl.BlockSpec(a.shape, (lambda *_, _nd=a.ndim: (0,) * _nd),
                        memory_space=pltpu.VMEM)


def run_reference(kernel, inputs, out_shape, scratch=()):
    call = pl.pallas_call(
        kernel, in_specs=[whole(a) for a in inputs],
        out_specs=pl.BlockSpec(out_shape, lambda: (0,) * len(out_shape),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, inputs[0].dtype),
        scratch_shapes=list(scratch), grid=(), interpret=True)
    return np.asarray(call(*inputs))


@pytest.mark.parametrize("chains", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fma_chains_three_ways(tool, host_lib, dtype, chains):
    S, L, reps = 8, 128, 64
    x = np.linspace(0.0, 1.0, S * L).astype(dtype).reshape(S, L)
    ref = run_reference(
        functools.partial(tool._fma_kernel, S, L, chains, reps),
        [jnp.asarray(x)], (S, L))
    xt = torch.tensor(x)
    plain = cr.fma_chains(xt, chains, reps)
    host, err = cr.fma_chains_call(host_lib, xt, chains, reps)
    assert err == 0 and plain.dtype == xt.dtype
    assert np.isfinite(ref).all()
    assert rel(plain.numpy(), ref) <= TOL[dtype]
    assert rel(host.numpy(), ref) <= TOL[dtype]
    assert rel(host.numpy(), plain.numpy()) <= TOL[dtype]


def test_fma_chains_sixteen_chains_and_run_time_reps(host_lib):
    x = torch.linspace(0.0, 1.0, 300, dtype=torch.float64)
    for reps in (0, 1, 7, 64, 1001):
        host, err = cr.fma_chains_call(host_lib, x, 16, reps)
        assert err == 0
        assert rel(host.numpy(), cr.fma_chains_plain(x, 16, reps).numpy()) \
            <= 1e-12
    # x in [0, 1] keeps a <= 1: the accumulators grow at most linearly
    big, _ = cr.fma_chains_call(host_lib, x.float(), 4, 100000)
    assert bool(torch.isfinite(big).all())


def test_fma_chains_rejects_what_the_kernel_does_not_take(host_lib):
    x = torch.zeros(8, dtype=torch.float32)
    with pytest.raises(ValueError, match="chains"):
        cr.fma_chains_call(host_lib, x, 5, 4)
    with pytest.raises(ValueError, match="threads"):
        cr.fma_chains_call(host_lib, x, 4, 4, threads=2048)
    with pytest.raises(TypeError, match="float32/float64"):
        cr.fma_chains_call(host_lib, x.half(), 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cr.fma_chains_call(host_lib, torch.zeros(4, 4).t(), 4, 4)
    with pytest.raises(ValueError, match="CUDA or a CPU"):
        cr.fma_chains(torch.zeros(4, device="meta"), 4, 4)
    assert cr.fma_flops(10, 4, 8) == 640.0


@pytest.mark.parametrize("N", [24, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_factor_reps_three_ways(tool, host_lib, dtype, N):
    bt, reps = 128, 2
    K0, _ = reps_inputs(N, bt, dtype)
    jdt = jnp.dtype(dtype)
    ref = run_reference(
        functools.partial(tool._factor_bench_kernel, N, reps, PIVOT_FLOOR,
                          bt), [jnp.asarray(K0)], (1, bt),
        [pltpu.VMEM((N, N, bt), jdt), pltpu.VMEM((N, bt), jdt)])
    Kt = torch.tensor(K0)
    acc, sink = cr.factor_reps(Kt, reps, PIVOT_FLOOR)
    (hacc, hsink), err = cr.factor_reps_call(host_lib, Kt, reps, PIVOT_FLOOR)
    assert err == 0
    assert rel(acc.numpy(), ref) <= TOL[dtype]
    assert rel(hacc.numpy(), ref) <= TOL[dtype]
    # the sink covers every pivot and the last row of L: held to plain
    assert rel(hsink.numpy(), sink.numpy()) <= TOL[dtype]
    assert not np.allclose(sink.numpy(), acc.numpy())


@pytest.mark.parametrize("N", [24, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_reps_three_ways(tool, host_lib, dtype, N):
    bt, reps = 128, 2
    K0, b0 = reps_inputs(N, bt, dtype)
    jdt = jnp.dtype(dtype)
    ref = run_reference(
        functools.partial(tool._solve_bench_kernel, N, reps, PIVOT_FLOOR,
                          bt), [jnp.asarray(K0), jnp.asarray(b0)], (1, bt),
        [pltpu.VMEM((N, N, bt), jdt), pltpu.VMEM((N, bt), jdt),
         pltpu.VMEM((N, bt), jdt)])
    Kt, bt_ = torch.tensor(K0), torch.tensor(b0)
    acc, sink = cr.solve_reps(Kt, bt_, reps, PIVOT_FLOOR)
    (hacc, hsink), err = cr.solve_reps_call(host_lib, Kt, bt_, reps,
                                            PIVOT_FLOOR)
    assert err == 0
    assert rel(acc.numpy(), ref) <= TOL[dtype]
    assert rel(hacc.numpy(), ref) <= TOL[dtype]
    assert rel(hsink.numpy(), sink.numpy()) <= TOL[dtype]


def test_solve_reps_solves_the_system():
    """One repetition's x is the solution of K0 x = b0: the sink is the
    sum of its entries."""
    K0, b0 = reps_inputs(24, 16, "float64")
    _, sink = cr.solve_reps(torch.tensor(K0), torch.tensor(b0), 1)
    x = np.linalg.solve(np.moveaxis(K0, -1, 0), np.moveaxis(b0, -1, 0)[
        ..., None])[..., 0]
    np.testing.assert_allclose(sink.numpy()[0], x.sum(-1), rtol=1e-10)


def test_reps_reject_other_orders_and_shapes(host_lib):
    with pytest.raises(ValueError, match="order 5"):
        cr.factor_reps_call(host_lib, torch.zeros(5, 5, 4), 2)
    with pytest.raises(ValueError, match=r"\(N, N, B\)"):
        cr.factor_reps_call(host_lib, torch.zeros(8, 4), 2)
    with pytest.raises(ValueError, match="b0"):
        cr.solve_reps_call(host_lib, torch.zeros(8, 8, 4),
                           torch.zeros(7, 4), 2)
    (acc, sink), err = cr.factor_reps_call(host_lib, torch.zeros(8, 8, 0), 2)
    assert err == 0 and acc.shape == (1, 0)


@pytest.mark.parametrize("N", [1, 8, 24, 32, 64])
def test_fused_flops_is_the_tools(tool, N):
    assert cr.fused_flops(N) == tool.fused_flops(N)


@pytest.mark.parametrize("N,bt,seed", [(24, 512, 0), (8, 128, 3)])
def test_quasidef_tile_is_the_tools_array(tool, N, bt, seed):
    ours = cr.quasidef_tile(N, bt, seed)
    theirs = np.asarray(tool.quasidef_tile(N, bt, seed))
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.tobytes() == theirs.tobytes()


def test_cpu_runs_count_no_launch():
    cr.reset_launch_counts()
    K0, b0 = reps_inputs(8, 4, "float32")
    cr.fma_chains(torch.zeros(4), 4, 2)
    cr.factor_reps(torch.tensor(K0), 1)
    cr.solve_reps(torch.tensor(K0), torch.tensor(b0), 1)
    assert cr.launches == {"fma_chains": 0, "factor_reps": 0,
                           "solve_reps": 0}


def test_measuring_needs_the_card():
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        cr.fma_peak(torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        cr.fma_peak(torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cr.reps_slope(lambda r: None)
