"""Kernels T2a and T2b on K1's team route against the reference tool's
Pallas kernels and the plain versions.

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
held to the plain version.  T2b's team route (``solve_reps_team_kernel``:
``team_ldlt`` once, then ``team_ldlt_solve`` a repetition, K, D and b in
shared memory) is held the same way to ``solve_reps_plain`` and to
``tools/roofline.py:_solve_bench_kernel``: each lane sums its own entries
of x, then the team adds the lanes.  T3's team route has the same tests
in ``test_torch_phases_team.py``.
"""

import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host
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
    ("one") and 16 emulated lanes ("emulated"), ``torch_host.BUILD_JOBS``
    at a time."""
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

    return torch_host.build_all(build, flags)


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
                                 "factor_reps team": 0,
                                 "solve_reps thread": 0,
                                 "solve_reps team": 0}
    with pytest.raises(ValueError, match="no route 'block'"):
        cr.factor_reps(Kt, 1, route="block")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cr.factor_reps(torch.zeros((8, 8, 2), device="meta"), 1,
                       route="team")
    with pytest.raises(ValueError, match="order 5"):
        cr.factor_reps_call(None, torch.zeros((5, 5, 2)), 1, route="team")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_team_solve_reps_three_ways(tool, host_libs, dtype):
    bt, reps = 128, 2
    tol = TOL[dtype]
    jdt = jnp.dtype(dtype)
    for N in cr.ORDERS:
        K0, b0 = reps_inputs(N, bt, dtype)
        Kt, bt_ = torch.tensor(K0), torch.tensor(b0)
        acc, sink = cr.solve_reps(Kt, bt_, reps, PIVOT_FLOOR, route="team")
        if N == 24:
            want = run_reference(
                functools.partial(tool._solve_bench_kernel, N, reps,
                                  PIVOT_FLOOR, bt),
                [jnp.asarray(K0), jnp.asarray(b0)], (1, bt),
                [pltpu.VMEM((N, N, bt), jdt), pltpu.VMEM((N, bt), jdt),
                 pltpu.VMEM((N, bt), jdt)])
            assert rel(acc.numpy(), want) <= tol
        for kind, lib in host_libs.items():
            b = BATCH[kind]
            (hacc, hsink), err = cr.solve_reps_call(
                lib, Kt[..., :b].contiguous(), bt_[:, :b].contiguous(),
                reps, PIVOT_FLOOR, "team")
            assert err == 0
            if N == 24:
                assert rel(hacc.numpy(), want[:, :b]) <= tol, kind
            assert rel(hacc.numpy(), acc[:, :b].numpy()) <= tol, (kind, N)
            # the sink covers every entry of x
            assert rel(hsink.numpy(), sink[:, :b].numpy()) <= tol, (kind, N)
        assert not np.allclose(sink.numpy(), acc.numpy())
    (zacc, zsink), _ = cr.solve_reps_call(host_libs["one"], Kt, bt_, 0,
                                          PIVOT_FLOOR, "team")
    assert not zacc.any() and not zsink.any()


def test_team_solve_route_on_the_cpu_counts_no_launch_and_refuses_others():
    K0, b0 = reps_inputs(8, 4, "float64")
    Kt, bt_ = torch.tensor(K0), torch.tensor(b0)
    cr.reset_launch_counts()
    for route in ("thread", "team"):
        out = cr.solve_reps(Kt, bt_, 2, route=route)
        assert all(torch.equal(x, y) for x, y in
                   zip(out, cr.solve_reps_plain(Kt, bt_, 2)))
    assert not any(cr.launches.values())
    assert not any(cr.route_launches.values())
    with pytest.raises(ValueError, match="T2b has no route 'wide'"):
        cr.solve_reps(Kt, bt_, 1, route="wide")
    with pytest.raises(ValueError, match="T2b has no route 'block'"):
        cr.solve_reps_call(None, Kt, bt_, 1, route="block")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cr.solve_reps(torch.zeros((8, 8, 2), device="meta"),
                      torch.zeros((8, 2), device="meta"), 1, route="team")
    with pytest.raises(ValueError, match="b0"):
        cr.solve_reps_call(None, Kt, bt_[:7].contiguous(), 1, route="team")


#: one team's region in values at orders 8 and 24 (roofline.cu:
#: FactorTeamLayout, SolveTeamLayout): rounded up to 32 values, plus 16
STRIDES = {("T2a", 8): 112, ("T2a", 24): 656,
           ("T2b", 8): 80, ("T2b", 24): 400}


@pytest.mark.parametrize("kernel", ["T2a", "T2b"])
def test_team_shape_of_the_host_builds(host_libs, kernel):
    for kind, lanes in (("one", 1), ("emulated", 16)):
        for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
            for N in cr.ORDERS:
                sh = cr.reps_team_shape(dtype, kernel, N, host_libs[kind])
                assert sh == {"lanes": lanes, "threads": 64,
                              "team_bytes": size * STRIDES[kernel, N],
                              "teams_per_sm": 0}, (kind, dtype, N)
    with pytest.raises(ValueError, match="order 5"):
        cr.reps_team_shape(torch.float32, kernel, 5, host_libs["one"])
    with pytest.raises(ValueError, match="T1 has no route"):
        cr.reps_team_shape(torch.float32, "T1", 24, host_libs["one"])


#: a cuobjdump -sass listing in both branch forms: to an address (order
#: 8: a loop whose body reloads the factor) and to a label (order 24: a
#: loop that loads nothing), beside the thread route's kernel
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN15ipmzoo_roofline22solve_reps_team_kernelIfLi8EEEvPKT_S3_liS1_PS1_S4_
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   LDS.64 R4, [R3+0x8] ;
        /*0030*/              @!P0 LDS R5, [R3+0x10] ;
        /*0040*/                   SHFL.IDX PT, R6, R2, RZ, 0xf1f ;
        /*0050*/               @P1 BRA 0x10 ;
        /*0060*/                   SHFL.BFLY PT, R6, R2, 0x1, 0x1f ;
        /*0070*/                   EXIT ;
\t\tFunction : _ZN15ipmzoo_roofline22solve_reps_team_kernelIdLi24EEEvPKT_S3_liS1_PS1_S4_
        /*0000*/                   LDS R2, [R3] ;
.L_x_1:
        /*0010*/                   DFMA R2, R2, R2, R2 ;
        /*0020*/                   SHFL.IDX PT, R6, R2, RZ, 0xf1f ;
        /*0030*/               @P1 BRA `(.L_x_1) ;
        /*0040*/               @P2 BRA `(.L_x_2) ;
.L_x_2:
        /*0050*/                   EXIT ;
\t\tFunction : _ZN15ipmzoo_roofline17solve_reps_kernelIfLi8EEEvPKT_S3_liS1_PS1_S4_
        /*0000*/                   EXIT ;
"""


def test_solve_loop_reader_of_sass():
    """chip_roofline's reader of T2b team's repetition loop, which the
    card's run holds to load the factor from shared memory."""
    import chip_roofline as rl
    funcs = rl.sass_functions(SASS)
    assert len(funcs) == 3
    f64 = funcs["_ZN15ipmzoo_roofline22solve_reps_team_kernelIdLi24EEEvPKT_"
                "S3_liS1_PS1_S4_"]
    assert f64[3] == (0x30, "@P1 BRA 0x10")
    assert f64[4] == (0x40, "@P2 BRA 0x50")
    loops = rl.solve_loops(SASS)
    assert sorted(loops.values()) == [(0, 1, 3), (3, 1, 5)]
    no_loop = rl.solve_loops(SASS.replace("SHFL.IDX", "SHFL.UP"))
    assert no_loop == dict.fromkeys(loops)
