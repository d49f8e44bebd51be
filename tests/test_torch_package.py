"""Package-level properties of the port (ipmzoo_tpu_torch): it runs
without jax, CPU runs never touch the CUDA kernels, its benchmark
workload is the reference benchmark's bit for bit, and its numpy
conversions round-trip the reference's containers."""

import dataclasses
import os
import re
import subprocess
import sys
import textwrap
import tomllib
from pathlib import Path

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
from ipmzoo_tpu_torch.utils import precision

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
        from ipmzoo_tpu_torch.parallel import (batch_sharding, make_mesh,
                                               replicated)
        from ipmzoo_tpu_torch.parallel import distributed, dryrun, scaling
        mesh = make_mesh(devices=["cpu"])
        assert mesh.shape == {"dp": 1} and mesh.group is None
        assert tuple(batch_sharding(mesh).spec) == ("dp",)
        assert tuple(replicated(mesh).spec) == ()
        assert bool(SchurIPM(2, 1, mesh=mesh).solve_sharded(blk).converged)
        distributed.initialize()
        assert distributed.is_primary()
        assert callable(dryrun.dryrun_multichip)
        assert callable(scaling.dp_scaling_report)
        from ipmzoo_tpu_torch.models.families import grid_qp
        fam = grid_qp(side=4, device="cpu")
        nd = p.CompiledIPM(fam.settings, n=fam.n, kernel="nd", nd_leaf=4,
                           nd_fallback=False, device="cpu")
        assert bool(nd.solve(fam.data).converged) and nd._mode == "nd"
        from ipmzoo_tpu_torch.models.mpc import condense, random_mpc
        mpc = p.RiccatiIPM(4, 2, 1, state_bounds=True, gondzio=1,
                           device="cpu")
        md = random_mpc(4, 2, 1, batch=2, state_bounds=True, device="cpu")
        assert bool(mpc.solve_batch(md).converged.all())
        assert condense(md, device="cpu")[0].batch_shape == (2,)
        from ipmzoo_tpu_torch.ops import (ldlt_solve, shard_kkt,
                                          sharded_ldlt, sharded_ldlt_solve)
        tp = make_mesh((1,), ("tp",), ["cpu"])
        K = torch.eye(4, dtype=torch.float64) * 2
        b = torch.ones(4, dtype=torch.float64)
        x = sharded_ldlt_solve(sharded_ldlt(shard_kkt(K, tp), tp), b, tp)
        assert torch.equal(x, ldlt_solve(K, b))
        sh = p.CompiledIPM(p.Settings(), n=2, m_ineq=1, kernel="sharded",
                           mesh=tp)
        assert bool(sh.solve(d).converged)
        import contextlib, io
        import numpy as np
        from ipmzoo_tpu_torch.frontend import cli, render_problem
        from ipmzoo_tpu_torch.frontend.web import build_derivations
        assert "{minimize}" in render_problem(p.Settings())
        assert len(build_derivations()) == 336
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["-b", "-e", "-n", "--device", "cpu"]) == 0
        assert "naive_slacks" in buf.getvalue()
        from ipmzoo_tpu_torch import native
        assert native.available()
        L, D = native.ldlt_factor(np.array([[4.0, 2.0], [2.0, 3.0]]))
        assert D.tolist() == [4.0, 2.0] and L[1, 0] == 0.5
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


def test_schur_ipm_resolves_at_the_top_level():
    import ipmzoo_tpu_torch as port
    from ipmzoo_tpu_torch.models import mpc
    from ipmzoo_tpu_torch.parallel.schur import SchurIPM
    assert port.SchurIPM is SchurIPM
    # the MPC engine's names, as the reference exports them
    for name in ("RiccatiIPM", "MPCData", "MPCSolveResult"):
        assert getattr(port, name) is getattr(mpc, name)
    # the reference exports no BlockQPData at the top level either
    import ipmzoo_tpu as ref
    for name in ("BlockQPData", "NoSuchSolver"):
        assert not hasattr(port, name) and not hasattr(ref, name)


# -- the float32 precision policy (mirrors tests/test_precision_policy.py) --

def test_import_pins_full_float32_precision():
    # importing models / parallel / ops (above) applied the policy
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    for sub in ("models", "parallel", "ops"):
        text = (Path(ROOT) / "ipmzoo_tpu_torch" / sub /
                "__init__.py").read_text()
        assert "apply_default_matmul_precision()" in text, sub


def test_apply_is_idempotent_and_respects_user_choice(monkeypatch):
    # once applied, a second call is a no-op even if the user has since
    # chosen something else
    torch.set_float32_matmul_precision("high")
    try:
        precision.apply_default_matmul_precision()
        assert torch.get_float32_matmul_precision() == "high"
        # and a fresh (unapplied) module run also defers to a choice the
        # process has already made
        monkeypatch.setattr(precision, "_APPLIED", False)
        precision.apply_default_matmul_precision()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False


def test_env_opt_out(monkeypatch):
    monkeypatch.setenv("IPMZOO_MATMUL_PRECISION", "default")
    monkeypatch.setattr(precision, "_APPLIED", False)
    torch.backends.cudnn.allow_tf32 = True
    try:
        precision.apply_default_matmul_precision()
        assert torch.backends.cudnn.allow_tf32 is True
        # without the variable the same fresh run turns TF32 off
        monkeypatch.delenv("IPMZOO_MATMUL_PRECISION")
        monkeypatch.setattr(precision, "_APPLIED", False)
        precision.apply_default_matmul_precision()
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32 = False


def test_env_typo_warns_and_leaves_the_default(monkeypatch):
    monkeypatch.setenv("IPMZOO_MATMUL_PRECISION", "hihgest")
    monkeypatch.setattr(precision, "_APPLIED", False)
    with pytest.warns(UserWarning, match="not accepted"):
        precision.apply_default_matmul_precision()
    assert torch.get_float32_matmul_precision() == "highest"


# -- the constructor options of item 16 (multi-device), ported -------------

@pytest.mark.parametrize("kw,item", [
    (dict(mesh_axis="tp"), "item 16"),
    # panel= sets kernel='sharded''s panel in the reference
    (dict(panel=64), "item 16"),
    (dict(kernel="sharded"), "item 16"),
])
def test_unported_constructor_options_name_their_item(kw, item):
    # every option of ``item`` is taken as the reference takes it:
    # mesh_axis= and panel= are read by kernel='sharded' only (mesh_axis
    # defaults to "tp"), and kernel='sharded' asks for a mesh
    if kw.get("kernel") == "sharded":
        with pytest.raises(ValueError, match="requires mesh="):
            CompiledIPM(port_settings(Settings()), 4, 2, device="cpu", **kw)
        with pytest.raises(ValueError, match="requires mesh="):
            RefIPM(Settings(), 4, 2, **kw)
        return
    s = CompiledIPM(port_settings(Settings()), 4, 2, device="cpu", **kw)
    assert s._mode == RefIPM(Settings(), 4, 2, **kw)._mode == "ldlt"
    assert not any(hasattr(s, a) for a in ("_mesh", "_sharded_panel"))


def test_block_inv_option():
    # 'auto' = off, as the reference; True binds H^-1 / S^-1 in 'block'
    assert not CompiledIPM(port_settings(Settings()), 4, 2, kernel="block",
                           device="cpu")._block_inv
    s = CompiledIPM(port_settings(Settings()), 4, 2, kernel="block",
                    block_inv=True, device="cpu")
    assert s._block_inv and s._mode == "block"


# -- the build ---------------------------------------------------------------

def test_build_key_covers_the_headers_a_source_may_include(tmp_path):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return H; }')
    (tmp_path / "h.cuh").write_text("#define H 1\n")
    first = _build.library_path("k", csrc=tmp_path)
    assert first == _build.library_path("k", csrc=tmp_path)
    (tmp_path / "h.cuh").write_text("#define H 2\n")
    second = _build.library_path("k", csrc=tmp_path)
    assert second != first
    # a header of another name counts too; a file that is no header not
    (tmp_path / "other.cuh").write_text("")
    third = _build.library_path("k", csrc=tmp_path)
    assert third != second
    (tmp_path / "notes.txt").write_text("x")
    assert _build.library_path("k", csrc=tmp_path) == third
    # the shipped measurement kernels include K1's header
    assert '#include "fused_ipm.cuh"' in (_build.CSRC /
                                          "roofline.cu").read_text()


def test_build_directory_can_be_named_by_the_environment(monkeypatch,
                                                         tmp_path):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert _build.resolve_build_dir() == Path(ROOT) / "build" / \
        "ipmzoo_tpu_torch"
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert _build.resolve_build_dir() == tmp_path / "kernels"


def test_ptxas_report_reads_the_build_log(tmp_path):
    lib = tmp_path / "k-0.so"
    lib.with_suffix(".log").write_text(textwrap.dedent("""\
        ptxas info    : 0 bytes gmem
        ptxas info    : Compiling entry function '_Z1kIfLi2EEvv' for 'sm_90a'
        ptxas info    : Function properties for _Z1kIfLi2EEvv
            1392 bytes stack frame, 56 bytes spill stores, 60 bytes spill loads
        ptxas info    : Used 255 registers, used 0 barriers, 1392 bytes cumulative stack size
        ptxas info    : Compiling entry function '_Z1kIdLi2EEvv' for 'sm_90a'
        ptxas info    : Function properties for _Z1kIdLi2EEvv
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 40 registers, used 0 barriers
        """))
    assert _build.ptxas_report(lib) == [
        {"name": "_Z1kIfLi2EEvv", "registers": 255, "stack": 1392,
         "spill_stores": 56, "spill_loads": 60},
        {"name": "_Z1kIdLi2EEvv", "registers": 40, "stack": 0,
         "spill_stores": 0, "spill_loads": 0}]


def test_packaging_ships_the_headers_and_names_torch():
    meta = tomllib.loads((Path(ROOT) / "pyproject.toml").read_text())
    shipped = meta["tool"]["setuptools"]["package-data"]["ipmzoo_tpu_torch"]
    assert "csrc/*.cu" in shipped and "csrc/*.cuh" in shipped
    assert "native/*.cpp" in shipped
    assert meta["project"]["optional-dependencies"]["torch"] == ["torch"]
    for f in _build.CSRC.iterdir():
        assert f.suffix in (".cu", ".cuh"), f.name


# -- the import guard over the whole port -----------------------------------

PORT_SCRIPTS = ("bench_torch.py", "chip_smoke.py", "chip_profile.py",
                "chip_roofline.py", "chip_phases.py", "chip_nd_crossover.py")


def test_no_port_file_imports_the_jax_side():
    files = [Path(ROOT) / f for f in PORT_SCRIPTS] + sorted(
        (Path(ROOT) / "ipmzoo_tpu_torch").rglob("*.py")) + sorted(
        (Path(ROOT) / "examples").glob("torch_*.py"))
    assert len([f for f in files if f.parent.name == "examples"]) == 4
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ipmzoo_tpu|bench|"
                     r"tools)(\.|\s|$)", re.M)
    for f in files:
        found = bad.findall(f.read_text())
        assert not found, (f.name, found)


def test_measurement_modules_import_and_run_without_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        import bench_torch, chip_phases, chip_profile, chip_roofline
        import chip_nd_crossover, chip_smoke
        import ipmzoo_tpu_torch.utils as u
        from ipmzoo_tpu_torch.models import fused_phases as fp
        from ipmzoo_tpu_torch.ops import cuda_roofline as cr
        dev = torch.device("cpu")
        bench_torch.BATCH = 16
        label, value, unit, counts = bench_torch.run_mode("steps", dev,
                                                          batch=16)
        assert unit == "iterations/s" and counts["converged"] >= 0.99
        assert bench_torch.run_mode("kkt", dev, batch=8)[2] == "GFLOP/s"
        K0 = torch.tensor(cr.quasidef_tile(8, 4))
        assert cr.factor_reps(K0, 2)[1].shape == (1, 4)
        s = chip_phases.fused_solver("cpu", torch.float64)
        assert "IPMZOO_PHASE_ENTRY_POINTS" in fp.phase_source(s, 2)
        assert u.slope(lambda k: float(k), 1, 3) == 1.0
        assert chip_roofline.main() == 2 and chip_phases.main() == 2
        assert chip_nd_crossover.main(["16"]) == 2
        chip_nd_crossover.fit([dict(n=256, levels=2, flops_nd=5e5,
                                    nd_ms=1.0, dense_ms=1.0)])
        loaded = [m for m in sys.modules
                  if m in ("jax", "jaxlib", "ipmzoo_tpu", "bench", "tools")
                  or m.startswith(("jax.", "jaxlib.", "ipmzoo_tpu.",
                                   "tools."))]
        print("LOADED", loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_phase_operations_count_the_factor_and_solves_as_fused_flops():
    """T3's operation count takes its factor and its solves from the
    count T2 is graded by, so the two kernels' bounds agree."""
    sys.path.insert(0, ROOT)
    try:
        import chip_phases
    finally:
        sys.path.remove(ROOT)
    import torch
    from ipmzoo_tpu_torch.ops.cuda_roofline import fused_flops
    # the fused slice (n=16, m_ineq=8, aug 24) and the portfolios of the
    # block and wide routes (aug 129 and 257, one equality row)
    for point, aug, mv in (("slice", 24, 2 * 16 * 16 + 4 * 8 * 16),
                           ("wide", 129, 2 * 128 * 128 + 4 * 128),
                           ("wide route", 257, 2 * 256 * 256 + 4 * 256)):
        solver = chip_phases.point_solver(point, "cpu", torch.float32)
        assert solver.aug_dim == aug
        assert chip_phases.matvec_flops(solver) == mv
        fac, sol = fused_flops(aug)
        flops = [chip_phases.phase_flops(p, solver) for p in range(5)]
        assert flops[0] == 0 and flops[1] == mv
        assert flops[2] - flops[1] == fac
        assert flops[3] - flops[2] == 2 * sol + 2 * mv
        assert flops[4] - flops[3] == 3 * mv
        assert flops == sorted(flops)


def test_all_four_scripts_refuse_a_machine_without_a_card(capsys):
    """One banner serves every chip script: without a CUDA device each
    says so on the standard error and returns 2."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sys.path.insert(0, ROOT)
    try:
        import chip_phases
        import chip_profile
        import chip_roofline
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for mod in (chip_smoke, chip_roofline, chip_phases, chip_profile):
        assert mod.main() == 2
        captured = capsys.readouterr()
        assert captured.out == ""
        assert f"{mod.__name__}: no CUDA device" in captured.err
