"""Package-level properties of the port (ipmzoo_tpu_torch): it runs
without jax, CPU runs never touch the CUDA kernels, its benchmark
workload is the reference benchmark's bit for bit, and its numpy
conversions round-trip the reference's containers."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ipmzoo_tpu.formulations import Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models import CompiledIPM, QPData, validate
from ipmzoo_tpu_torch.models import convert
from ipmzoo_tpu_torch.models.state import tree_map
from ipmzoo_tpu_torch.ops import _build, cuda_ldlt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_and_solves_without_jax():
    code = textwrap.dedent("""
        import sys
        import ipmzoo_tpu_torch as p
        d = p.QPData.make(Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
                          A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0],
                          u_A_ineq=[1.2], l_x=[0, 0], u_x=[10, 10],
                          device="cpu")
        r = p.CompiledIPM(p.Settings(), n=2, m_ineq=1,
                          device="cpu").solve(d)
        assert bool(r.converged), r
        import torch
        from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
        f = FusedBatchedIPM(p.Settings(), n=2, m_ineq=1, bt=1,
                            dtype=torch.float64, device="cpu")
        one = p.QPData(**{k: getattr(d, k)[None]
                          for k in d.__dataclass_fields__})
        assert bool(f.solve_fused_compact(one)["converged"][0])
        assert "struct Form" in f.kernel_source()
        from ipmzoo_tpu_torch.parallel import BlockQPData, SchurIPM
        blk = BlockQPData(Q=torch.eye(2)[None].repeat(3, 1, 1),
                          c=torch.ones(3, 2), F=torch.ones(3, 1, 2),
                          l_x=-torch.ones(3, 2), u_x=torch.ones(3, 2),
                          g=torch.zeros(1))
        assert bool(SchurIPM(2, 1, dtype=torch.float32, device="cpu").solve(
            blk.to(dtype=torch.float32)).converged)
        from ipmzoo_tpu_torch.models.families import grid_qp
        fam = grid_qp(side=4, device="cpu")
        nd = p.CompiledIPM(fam.settings, n=fam.n, kernel="nd", nd_leaf=4,
                           nd_fallback=False, device="cpu")
        assert bool(nd.solve(fam.data).converged) and nd._mode == "nd"
        jaxy = [m for m in sys.modules
                if m in ("jax", "jaxlib", "ipmzoo_tpu")
                or m.startswith(("jax.", "jaxlib.", "ipmzoo_tpu."))]
        print("LOADED", jaxy)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cpu_runs_leave_launch_counters_at_zero():
    cuda_ldlt.reset_launch_counts()
    data = convert.make_batch(70, 4, 2, torch.float64, seed=3, device="cpu")
    s = CompiledIPM(port_settings(Settings()), n=4, m_ineq=2, device="cpu")
    s.solve_batch_compact(data)
    s.solve_batch(data)
    assert cuda_ldlt.launches == {"ldlt": 0, "solve_ldlt": 0,
                                 "solve_ldlt_matrix": 0,
                                 "ldlt_solve_matrix": 0}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_batch_is_the_benchmark_workload_bit_for_bit(dtype):
    ref = bench.make_batch(8, 16, 8, getattr(jnp, dtype))
    ours = convert.make_batch(8, 16, 8, getattr(torch, dtype), device="cpu")
    for f in dataclasses.fields(QPData):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(ours, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name


def test_qpdata_round_trip():
    ref = bench.make_batch(3, 4, 2, jnp.float64)
    ours = convert.qpdata_from_numpy(ref, device="cpu")
    back = convert.qpdata_to_numpy(ours)
    for f in dataclasses.fields(QPData):
        np.testing.assert_array_equal(back[f.name],
                                      np.asarray(getattr(ref, f.name)))


def test_state_and_result_round_trip():
    ref = RefIPM(Settings(), 4, 2)
    data = bench.make_batch(3, 4, 2, jnp.float64)
    state = jax.vmap(ref.init_state)(data)
    back = convert.state_to_numpy(convert.state_from_numpy(state,
                                                           device="cpu"))
    for a, b in zip(back["vars"], state.vars):
        np.testing.assert_array_equal(a, np.asarray(b))
    for k in ("mu", "iteration", "residual", "gap"):
        np.testing.assert_array_equal(back[k],
                                      np.asarray(getattr(state, k)))
    res = ref.solve_batch(data)
    rback = convert.result_to_numpy(convert.result_from_numpy(res,
                                                              device="cpu"))
    for k in ("x", "objective", "iterations", "residual", "gap",
              "converged", "diverged"):
        np.testing.assert_array_equal(rback[k], np.asarray(getattr(res, k)))
    assert rback["variables"].keys() == res.variables.keys()
    for k, v in res.variables.items():
        np.testing.assert_array_equal(rback["variables"][k], np.asarray(v))


def test_fused_dicts_round_trip():
    rng = np.random.default_rng(0)
    ref = {"x": rng.normal(size=(3, 4)), "variables": rng.normal(size=(3, 9)),
           "iterations": np.array([7.0, 8.0, 30.0]),
           "residual": rng.random(3), "gap": rng.random(3),
           "mu": rng.random(3), "converged": np.array([True, True, False])}
    ours = convert.fused_from_numpy(ref, dtype=torch.float32, device="cpu")
    assert ours["converged"].dtype == torch.bool
    assert ours["x"].dtype == torch.float32
    back = convert.fused_to_numpy(convert.fused_from_numpy(ref, device="cpu"))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v)
    # a warm state is a subset of the result's keys
    warm = {k: ref[k] for k in ("variables", "mu", "iterations")}
    assert convert.fused_from_numpy(warm, device="cpu").keys() == warm.keys()


def test_qpdata_make_fills_absent_groups():
    d = QPData.make(Q=np.eye(3), c=np.zeros(3), device="cpu")
    assert d.Q.dtype == torch.float64
    assert (d.n, d.m_ineq, d.m_eq) == (3, 0, 0)
    assert tuple(d.A_ineq.shape) == (0, 3) and tuple(d.l_x.shape) == (3,)
    b = QPData.make(Q=np.stack([np.eye(3)] * 5), c=np.zeros((5, 3)),
                    dtype=torch.float32, device="cpu")
    assert b.batch_shape == (5,) and tuple(b.A_eq.shape) == (5, 0, 3)
    assert b.to(dtype=torch.float64).c.dtype == torch.float64


def test_validate_rejects_crossed_bounds():
    validate(QPData.make(Q=np.eye(2), c=np.zeros(2), l_x=[0, 0],
                         u_x=[1, 1], device="cpu"))
    with pytest.raises(ValueError, match="l_x < u_x"):
        validate(QPData.make(Q=np.eye(2), c=np.zeros(2), l_x=[0, 2],
                             u_x=[1, 1], device="cpu"))
    with pytest.raises(ValueError, match="l_A_ineq"):
        validate(QPData.make(Q=np.eye(2), c=np.zeros(2), A_ineq=[[1.0, 1.0]],
                             l_A_ineq=[2.0], u_A_ineq=[1.0], l_x=[0, 0],
                             u_x=[1, 1], device="cpu"))


def test_tree_map_over_nested_containers():
    d = convert.make_batch(4, 3, 2, torch.float64, device="cpu")
    halves = tree_map(lambda a: a[:2], d)
    assert isinstance(halves, QPData) and halves.batch_shape == (2,)
    summed = tree_map(lambda a, b: a + b, {"t": (d.c,)}, {"t": (d.c,)})
    assert torch.equal(summed["t"][0], 2 * d.c)


def test_kernel_build_is_keyed_by_source_and_flags():
    path = _build.library_path("ldlt")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("ldlt-") and path.suffix == ".so"
    assert path == _build.library_path("ldlt")
    # the IEEE-preserving build: Hopper target, no fast-math flags
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for bad in ("--use_fast_math", "-ftz=true", "-prec-div=false"):
        assert bad not in flags
