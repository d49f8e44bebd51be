"""Kernel T2a on K1's team route against the reference tool's Pallas
kernel and the plain version.

T2a's team route (``csrc/roofline.cu``: ``factor_reps_team_kernel``,
``team_ldlt`` of ``csrc/fused_team.cuh`` on 16 lanes with K and D in the
team's shared memory) compiles for the host two ways, as K1's team route
does in ``test_torch_fused_team.py``: plain g++ (one lane a team), and
with IPMZOO_TEAM_EMULATE (C++20, threads) at 16 lanes, each team 16 host
threads with a barrier for each team barrier, which runs the lane-spread
factor itself (on the first four instances: a host barrier is slow).
On the same seeded numpy inputs both builds are held to
the plain version (``ops/cuda_roofline.py:factor_reps_plain``), and that
to ``tools/roofline.py:_factor_bench_kernel`` in interpret mode at the
fused slice's order 24: float32 within 1e-5, float64 within 1e-12 (each
lane sums its own pivots and entries of L's last row, then the team
adds the lanes: another order than the plain version's).  Order 8 is
held to the plain version.  T3's team route has the same tests in
``test_torch_phases_team.py``.
"""

import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ipmzoo_tpu_torch.ops import _build
from ipmzoo_tpu_torch.ops import cuda_roofline as cr

from test_torch_roofline import reps_inputs, rel, run_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "float64": 1e-12}
PIVOT_FLOOR = 1e-8
EMULATE = ("-std=c++20", "-DIPMZOO_TEAM_EMULATE", "-pthread")
#: instances each build runs
BATCH = {"one": 128, "emulated": 4}


@pytest.fixture(scope="module")
def tool():
    """tools/roofline.py, loaded as a module (it is a script)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_roofline_team", os.path.join(ROOT, "tools",
                                                 "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """csrc/roofline.cu compiled for the host with g++, one lane a team
    ("one") and 16 emulated lanes ("emulated"), both at once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) found to build roofline.cu")
    root = tmp_path_factory.mktemp("roofline_team")
    flags = {"one": ("-std=c++17",), "emulated": EMULATE}

    def build(kind):
        lib = root / f"roofline_{kind}.so"
        proc = subprocess.run(
            [gxx, *flags[kind], "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-x", "c++", str(_build.CSRC / "roofline.cu"), "-o",
             str(lib)], capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return cr.bind(ctypes.CDLL(str(lib)))

    with ThreadPoolExecutor(2) as pool:
        return dict(zip(flags, pool.map(build, flags)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_team_factor_reps_three_ways(tool, host_libs, dtype):
    bt, reps = 128, 2
    tol = TOL[dtype]
    jdt = jnp.dtype(dtype)
    for N in cr.ORDERS:
        K0, _ = reps_inputs(N, bt, dtype)
        Kt = torch.tensor(K0)
        acc, sink = cr.factor_reps(Kt, reps, PIVOT_FLOOR, route="team")
        if N == 24:
            want = run_reference(
                functools.partial(tool._factor_bench_kernel, N, reps,
                                  PIVOT_FLOOR, bt), [jnp.asarray(K0)],
                (1, bt), [pltpu.VMEM((N, N, bt), jdt),
                          pltpu.VMEM((N, bt), jdt)])
            assert rel(acc.numpy(), want) <= tol
        for kind, lib in host_libs.items():
            b = BATCH[kind]
            (hacc, hsink), err = cr.factor_reps_call(
                lib, Kt[..., :b].contiguous(), reps, PIVOT_FLOOR, "team")
            assert err == 0
            if N == 24:
                assert rel(hacc.numpy(), want[:, :b]) <= tol, kind
            assert rel(hacc.numpy(), acc[:, :b].numpy()) <= tol, (kind, N)
            # the sink covers every pivot and the last row of L
            assert rel(hsink.numpy(), sink[:, :b].numpy()) <= tol, (kind, N)
        assert not np.allclose(sink.numpy(), acc.numpy())
    (zacc, zsink), _ = cr.factor_reps_call(host_libs["one"], Kt, 0,
                                           PIVOT_FLOOR, "team")
    assert not zacc.any() and not zsink.any()


def test_team_route_on_the_cpu_counts_no_launch_and_refuses_others():
    K0, _ = reps_inputs(8, 4, "float64")
    Kt = torch.tensor(K0)
    cr.reset_launch_counts()
    for route in ("thread", "team"):
        out = cr.factor_reps(Kt, 2, route=route)
        assert all(torch.equal(x, y) for x, y in
                   zip(out, cr.factor_reps_plain(Kt, 2)))
    assert cr.launches == {"fma_chains": 0, "factor_reps": 0,
                           "solve_reps": 0}
    assert cr.route_launches == {"factor_reps thread": 0,
                                 "factor_reps team": 0}
    with pytest.raises(ValueError, match="no route 'block'"):
        cr.factor_reps(Kt, 1, route="block")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cr.factor_reps(torch.zeros((8, 8, 2), device="meta"), 1,
                       route="team")
    with pytest.raises(ValueError, match="order 5"):
        cr.factor_reps_call(None, torch.zeros((5, 5, 2)), 1, route="team")
