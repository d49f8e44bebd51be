"""K1's team route on the CPU: its generated text, host builds of it and
its route function.

The team route's source (``models/fused_source.py:fused_team_source``:
``csrc/fused_ipm.cuh`` + ``csrc/fused_team.cuh`` + the ``struct Form``
printed by ``models/codegen_team.py:CppTeam``) compiles for the host in
two ways:

* plain g++ (-O1 -ffp-contract=off): one lane a team, barriers no-ops,
  reductions identities.  In float64 it must give K1's plain version's
  iteration counts exactly and its x within 1e-10, on the five
  formulations of ``test_torch_fused_emit.py``, cold, warm and with
  Gondzio rounds, and the JAX fused engine's (interpret mode) at the
  fused slice's formulation;
* with IPMZOO_TEAM_EMULATE (C++20, threads): each team is 16 or 32 host
  threads, a barrier for each team barrier, a scratch line for each
  shuffle.  That runs the lane-spread code itself (entry i in lane
  i % kLanes, the column-spread factor, the shuffled solves, the
  butterfly reductions), and under ThreadSanitizer shows that no lane
  reads shared memory another lane writes without a barrier between.
"""

import ctypes
import functools
import hashlib
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.formulations import Settings as RefSettings
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.models.fused import FusedBatchedIPM as RefFused
from ipmzoo_tpu_torch.models import codegen_soa as soa
from ipmzoo_tpu_torch.models.codegen_team import CppTeam, CrossLaneRead, \
    lane_vec
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.convert import qpdata_from_numpy
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.models.fused_source import fused_team_source, \
    team_lanes
from ipmzoo_tpu_torch.ops import cuda_fused

from test_torch_fused_emit import FORMULATIONS, assert_same, make_data

F64 = torch.float64


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("no host C++ compiler (g++) found to build K1's team "
                    "route")
    return path


@pytest.fixture(scope="module")
def host_build(gxx, tmp_path_factory):
    """Compile a team source for the host (``flags`` added); libraries
    are cached by text and flags."""
    root = tmp_path_factory.mktemp("k1team")

    @functools.lru_cache(maxsize=None)
    def build(source: str, flags=()) -> ctypes.CDLL:
        key = hashlib.sha256((source + repr(flags)).encode()).hexdigest()
        src, lib = root / f"t-{key[:16]}.cc", root / f"t-{key[:16]}.so"
        src.write_text(source)
        std = "-std=c++20" if flags else "-std=c++17"
        proc = subprocess.run(
            [gxx, std, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
             *flags, "-x", "c++", str(src), "-o", str(lib)],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return ctypes.CDLL(str(lib))

    return build


EMULATE = ("-DIPMZOO_TEAM_EMULATE", "-pthread")


@functools.lru_cache(maxsize=None)
def solver_of(name, dtype=F64):
    settings, n, m, e, kw = FORMULATIONS[name]
    return FusedBatchedIPM(port_settings(settings), n=n, m_ineq=m, m_eq=e,
                           dtype=dtype, max_iter=40, device="cpu", **kw)


def run_team(solver, lib, soa_data, warm=None, max_iter=30, gondzio=0):
    fn = cuda_fused.bind(lib, solver.dtype, "team")
    out, err = cuda_fused.call(fn, soa_data, warm, solver.n,
                               sum(solver.var_sizes), max_iter, gondzio,
                               solver.kernel_params())
    assert err == 0
    return out


def both(solver, lib, data, warm=None, max_iter=30, gondzio=0):
    """(team host build, plain version) outputs on the same SoA inputs."""
    soa_data, _ = solver.soa_inputs(data)
    return (run_team(solver, lib, soa_data, warm, max_iter, gondzio),
            solver._fused_plain(soa_data, warm, max_iter, gondzio))


# ---------------------------------------------------------------------------
# host builds against the plain version and the JAX fused engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FORMULATIONS))
def test_team_host_build_matches_plain_version(name, host_build):
    solver = solver_of(name)
    lib = host_build(fused_team_source(solver))
    data = make_data(solver.n, solver.m_ineq, solver.m_eq)
    for gondzio in (0, 2):
        host, plain = both(solver, lib, data, gondzio=gondzio)
        assert bool(((plain[3] < solver.tol) & (plain[4] < solver.tol))
                    .all()), (name, gondzio)
        assert_same(host, plain)


@pytest.mark.parametrize("name", list(FORMULATIONS))
def test_team_host_build_warm_resume(name, host_build):
    solver = solver_of(name)
    lib = host_build(fused_team_source(solver))
    data = make_data(solver.n, solver.m_ineq, solver.m_eq, B=6, seed=3)
    cold, cold_plain = both(solver, lib, data, max_iter=3)
    assert_same(cold, cold_plain)
    warm = (cold[1], cold[5], cold[2])
    host, plain = both(solver, lib, data, warm=warm, gondzio=1)
    assert_same(host, plain)
    assert bool((plain[2] > 3).all())


@pytest.mark.parametrize("lanes", [16, 32])
@pytest.mark.parametrize("name", ["slice", "equalities_slacked",
                                  "symbolic_taylor"])
def test_emulated_team_lanes_match_plain_version(name, lanes, host_build):
    """The lane-spread code itself, each team as ``lanes`` threads."""
    solver = solver_of(name)
    lib = host_build(fused_team_source(solver, lanes), EMULATE)
    data = make_data(solver.n, solver.m_ineq, solver.m_eq, B=3, seed=1)
    for gondzio in (0, 2):
        host, plain = both(solver, lib, data, gondzio=gondzio)
        assert_same(host, plain)
    warm = (host[1], host[5], host[2] - 2)
    host, plain = both(solver, lib, data, warm=warm, max_iter=3)
    assert_same(host, plain)


_TSAN_MAIN = r"""
#include <cstdio>
#include <random>
int main() {
  const int n = 16, m = 8, B = 2;
  std::mt19937 gen(7);
  std::uniform_real_distribution<double> u(-0.5, 0.5);
  std::vector<double> Q(n * n * B), c(n * B), A(m * n * B), lA(m * B),
      uA(m * B), lx(n * B), ux(n * B);
  for (int b = 0; b < B; ++b) {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j <= i; ++j)
        Q[(i * n + j) * B + b] = Q[(j * n + i) * B + b] =
            (i == j ? 2.0 : 0.02 * u(gen));
    for (int i = 0; i < n; ++i) {
      c[i * B + b] = u(gen);
      lx[i * B + b] = -5;
      ux[i * B + b] = 5;
    }
    for (int i = 0; i < m * n; ++i) A[i * B + b] = u(gen);
    for (int i = 0; i < m; ++i) {
      lA[i * B + b] = -1;
      uA[i * B + b] = 1;
    }
  }
  const double* data9[9] = {Q.data(), c.data(), A.data(), lA.data(),
                            uA.data(), nullptr, nullptr, lx.data(),
                            ux.data()};
  std::vector<double> x(n * B), vars(128 * B), it(B), res(B), gap(B),
      mu(B);
  double* out6[6] = {x.data(), vars.data(), it.data(), res.data(),
                     gap.data(), mu.data()};
  const double prm[6] = {1e-8, 1.0, 1e-8, 1e-30, 1e-30, 0.99};
  const int err = ipmzoo_fused_team_f64(data9, nullptr, nullptr, nullptr,
                                        out6, B, prm, 20, 0, 2, nullptr);
  std::printf("err %d iterations %g %g residual %g %g\n", err, it[0], it[1],
              res[0], res[1]);
  return err;
}
"""


def test_team_barriers_leave_no_data_race(gxx, tmp_path):
    """ThreadSanitizer over the emulated 16-lane team on the slice's
    formulation, with Gondzio rounds: every cross-lane read of shared
    memory is ordered after its write by a team barrier."""
    solver = solver_of("slice")
    assert solver.var_sizes and sum(solver.var_sizes) == 128
    src = tmp_path / "tsan.cc"
    src.write_text(fused_team_source(solver, 16) + _TSAN_MAIN)
    exe = tmp_path / "tsan"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-g", "-ffp-contract=off", *EMULATE,
         "-fsanitize=thread", str(src), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300)
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stdout + run.stderr[-2000:]
    its = [float(v) for v in run.stdout.split()[3:5]]
    res = [float(v) for v in run.stdout.split()[6:8]]
    assert all(1 <= k < 20 for k in its) and max(res) < 1e-8, run.stdout


def _numpy_slice_batch(B, seed=0):
    rng = np.random.default_rng(seed)
    n, m = 16, 8
    M = rng.normal(size=(B, n, n))
    return RefQPData(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(B, n)), A_ineq=rng.normal(size=(B, m, n)),
        l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
        A_eq=np.zeros((B, 0, n)), b_eq=np.zeros((B, 0)),
        l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0))


def test_team_host_build_matches_jax_fused_engine(host_build):
    """The fused slice's formulation (Settings(), n=16, m_ineq=8) at B=8:
    the team text against the reference's FusedBatchedIPM.solve_fused in
    Pallas interpret mode, float64."""
    data = _numpy_slice_batch(8, seed=2)
    ref = RefFused(RefSettings(), n=16, m_ineq=8, bt=8, dtype=jnp.float64,
                   max_iter=30)
    r = ref.solve_fused(jax.tree_util.tree_map(jnp.asarray, data))
    port = FusedBatchedIPM(port_settings(RefSettings()), n=16, m_ineq=8,
                           bt=8, dtype=F64, max_iter=30, device="cpu")
    lib = host_build(fused_team_source(port))
    soa_data, _ = port.soa_inputs(qpdata_from_numpy(data, device="cpu"))
    p = port.soa_result(run_team(port, lib, soa_data))
    assert bool(p["converged"].all())
    np.testing.assert_array_equal(p["converged"].numpy(),
                                  np.asarray(r["converged"]))
    np.testing.assert_array_equal(p["iterations"].numpy(),
                                  np.asarray(r["iterations"]))
    np.testing.assert_allclose(p["x"].numpy(), np.asarray(r["x"]),
                               rtol=1e-10, atol=1e-10)


def test_team_host_build_float32_converges(host_build):
    solver = FusedBatchedIPM(port_settings(RefSettings()), n=16, m_ineq=8,
                             tol=1e-5, device="cpu")
    lib = host_build(fused_team_source(solver))
    data = make_data(16, 8, 0, B=16, seed=5).to(dtype=torch.float32)
    host, plain = both(solver, lib, data)
    assert host[0].dtype == torch.float32
    for out in (host, plain):
        assert bool(((out[3] < 1e-5) & (out[4] < 1e-5)).all())
    np.testing.assert_allclose(host[0].numpy(), plain[0].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_team_shape_of_host_build(host_build):
    lib = host_build(fused_team_source(solver_of("slice")))
    for dtype, item in ((torch.float32, 4), (F64, 8)):
        sh = cuda_fused.team_shape(lib, dtype)
        assert sh["lanes"] == 1 and sh["threads"] == 64
        assert sh["teams_per_sm"] == 0
        # data 472 + 7 x 128 + 300 + 2 x 24 + slots, padded
        assert sh["team_bytes"] % (32 * item) == 16 * item
        assert 1716 * item < sh["team_bytes"] <= cuda_fused.team_values(
            solver_of("slice").k1_sizes()) * item + 48 * item


# ---------------------------------------------------------------------------
# the generated text
# ---------------------------------------------------------------------------

def _functions(text):
    """The generated functions of a team source: name -> body lines."""
    body = text[text.index('#line 1 "generated"'):]
    out, name = {}, None
    for line in body.splitlines():
        m = re.match(r"  IPM_FN static void (\w+)\(", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif line == "  }":
            name = None
        elif name is not None:
            out[name].append(line.strip())
    return out


@pytest.mark.parametrize("lanes", [16, 32])
@pytest.mark.parametrize("name", ["box_only", "equalities_slacked"])
def test_team_text_lane_arrays_hold_ceil_size_over_lanes(name, lanes):
    """Every vector temporary is a per-lane array of IPM_LANES(size) =
    ceil(size / kLanes) entries, written only by a loop over the lane's
    own entries of a vector of that size; no other array is declared."""
    text = fused_team_source(solver_of(name), lanes)
    assert f"#define IPMZOO_TEAM_LANES {lanes}" in text
    funcs = _functions(text)
    assert set(funcs) == {"init", "metrics", "assemble", "residuals",
                          "corrector", "aug_rhs", "back_substitute",
                          "gondzio_targets"}
    n_arrays = 0
    for fname, lines in funcs.items():
        sizes = {}
        for line in lines:
            decl = re.match(r"T (\w+)\[(.*)\];$", line)
            if decl:
                m = re.fullmatch(r"IPM_LANES\((\d+)\)", decl.group(2))
                assert m, (fname, line)
                sizes[decl.group(1)] = int(m.group(1))
        n_arrays += len(sizes)
        loop = None
        for line in lines:
            m = re.match(r"IPM_FOR\((\d+)\)", line)
            if m:
                loop = int(m.group(1))
            for var in re.findall(r"(\w+)\[p\] =", line):
                assert sizes.get(var) == loop, (fname, line)
    assert n_arrays > 20
    # ... and IPM_LANES(size) is ceil(size / kLanes)
    assert "#define IPM_LANES(size) (((size) + kLanes - 1) / kLanes)" in text


@pytest.mark.parametrize("name", list(FORMULATIONS))
def test_team_text_cross_lane_reads_follow_a_barrier(name):
    """A team slot is read only after a team barrier that follows its
    write; every function starts and ends with a team barrier (its
    inputs were written by other lanes, its outputs are read by them);
    a lane-local array is read only at the lane's own entries (``[p]``)."""
    funcs = _functions(fused_team_source(solver_of(name)))
    for fname, lines in funcs.items():
        assert lines[0] == "team_sync(tm);", fname
        assert lines[-1] == "team_sync(tm);", fname
        pending = set()    # slot ranges written since the last barrier
        written = set()
        for line in lines:
            if line == "team_sync(tm);":
                pending.clear()
                continue
            w = re.match(r"IPM_FOR\((\d+)\) tm\.slot\[(\d+) \+ i\] = ", line)
            reads = {int(o) for o in re.findall(
                r"tm\.slot\[(\d+) \+ \(", line)}
            reads |= {0 for _ in re.findall(r"tm\.slot\[(?!\d+ \+)", line)}
            for off in reads:
                assert off in written and off not in pending, (fname, line)
            if w:
                pending.add(int(w.group(2)))
                written.add(int(w.group(2)))
            # lane-local arrays: read and written at [p] only
            if not line.startswith("T "):
                for _, idx in re.findall(r"\b(t\d+)\[([^\]]+)\]", line):
                    assert idx == "p", (fname, line)


def test_cpp_team_spreads_values_and_refuses_cross_lane_reads():
    ev = CppTeam()
    v = soa.array_vec("v", 4)
    neg = ev.neg(v)
    assert neg.at("i") == f"{neg.name}[p]"
    with pytest.raises(CrossLaneRead):
        neg.at("k")
    with pytest.raises(CrossLaneRead):
        lane_vec("t9", 3).at("0")
    # a matrix product reads its vector at every index: stored to team
    # slots first, once, and a barrier follows
    M = soa.data_matrix("Q", 4, 4)
    ev.matvec(M, neg)
    ev.matvec(M, neg)
    text = "\n".join(ev.lines)
    assert text.count(f"tm.slot[0 + i] = {neg.name}[p];") == 1
    assert text.index("team_sync(tm);") > text.index("tm.slot[0 + i]")
    assert ev.slots == 4
    # a reduction sums the lane's partials, then across the team
    s = ev.sum_sq(neg)
    assert ev.lines[-1] == f"{s.expr} = team_sum(tm, {s.expr});"
    # a one-entry lane-local vector broadcast over four entries is shared
    one = ev.neg(soa.array_vec("w", 1))
    ev.add(one, neg)
    assert f"tm.slot[4 + i] = {one.name}[p];" in "\n".join(ev.lines)


def test_team_source_is_deterministic_and_keyed_by_lanes():
    s = solver_of("slice")
    a, b = fused_team_source(s), fused_team_source(solver_of("slice"))
    assert a == b == fused_team_source(s, 16)
    assert fused_team_source(s, 32) != a
    assert s.kernel_source("team") == a
    assert s.kernel_source("thread") == s.kernel_source()
    assert "ipmzoo_fused_team_f32" not in s.kernel_source()
    # independent of the dtype and scalar settings (run-time arguments)
    c = FusedBatchedIPM(port_settings(RefSettings()), n=16, m_ineq=8,
                        tol=1e-9, mu0=2.0, device="cpu")
    assert c.kernel_source("team") == a
    with pytest.raises(ValueError):
        fused_team_source(s, 8)
    with pytest.raises(ValueError):
        s.kernel_source("warp")


@pytest.mark.parametrize("n, m, lanes", [(16, 8, 16), (6, 3, 16),
                                         (20, 4, 32), (12, 24, 32)])
def test_team_lanes_hold_the_largest_block(n, m, lanes):
    solver = FusedBatchedIPM(port_settings(RefSettings()), n=n, m_ineq=m,
                             device="cpu")
    assert team_lanes(solver) == lanes


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

#: the fused slice's K1 launches (solve_fused_compact(esc_cap=32) at 10240
#: QPs): cold 10240, the 1/8 stage 1536, the 10240 mop-up, the 512 tile;
#: and the f64 escalation's scale, B=32
SLICE_SIZES = (16, 8, 0, 128, 24)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [10240, 1536, 512, 32])
def test_k1_route_at_the_slice_launches(B, dtype):
    """The team route was the faster at each of these launches, f32 and
    f64, on an H100 (PERF.md section 6)."""
    assert solver_of("slice").k1_sizes() == SLICE_SIZES
    assert cuda_fused.k1_route(B, SLICE_SIZES, dtype) == "team"
    # pure: the same arguments give the same route
    assert cuda_fused.k1_route(B, SLICE_SIZES, dtype) == \
        cuda_fused.k1_route(B, SLICE_SIZES, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_route_keeps_the_thread_route_over_the_shared_memory(dtype):
    # up to augmented order 128 (above it the wide route takes over:
    # tests/test_torch_fused_wide.py)
    big = (100, 20, 0, 5 * 100 + 6 * 20, 120)
    assert cuda_fused.k1_route(10240, big, dtype) == "thread"
    item = 4 if dtype == torch.float32 else 8
    assert 4 * cuda_fused.team_values(big) * item > cuda_fused.SHARED_CAP
    assert 4 * cuda_fused.team_values(SLICE_SIZES) * item < \
        cuda_fused.SHARED_CAP


def test_cpu_solve_runs_the_plain_version_on_no_route():
    solver = solver_of("slice")
    data = make_data(16, 8, 0, B=4)
    cuda_fused.reset_launch_counts()
    out = solver.solve_fused(data)
    assert bool(out["converged"].all())
    assert cuda_fused.launches == {"fused": 0, "phase": 0}
    assert cuda_fused.route_launches == {"fused thread": 0, "fused team": 0,
                                         "fused wide": 0, "fused block": 0}


def test_team_wrapper_refuses_cpu_tensors():
    solver = solver_of("slice")
    soa_data, _ = solver.soa_inputs(make_data(16, 8, 0, B=2))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fused.fused_soa(solver.kernel_source("team"), soa_data, None,
                             16, 128, 5, 0, solver.kernel_params(), "team")
    assert set(cuda_fused.route_launches) == {"fused thread", "fused team",
                                              "fused wide", "fused block"}
