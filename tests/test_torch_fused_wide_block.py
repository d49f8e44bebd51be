"""K1's block route (``csrc/fused_wide_block.cuh``: one thread block an
instance, the packed factor and the work vectors in shared memory) in
host builds, against K1's wide route and its plain version.

* The block route's source builds with g++ and, at one lane (the block
  is one host thread), gives the wide route's one-lane host build bit for
  bit at aug_dim 129 and 257 in float64, cold, with Gondzio rounds and
  warm, and the plain version's iterations and x within 1e-10;
* each instance as W x 32 host threads (IPMZOO_TEAM_EMULATE: the first
  32 the team, all W x 32 in the factor's row split and block barriers)
  it gives the emulated wide route bit for bit at W = 2 and 4, aug 129,
  and W = 2 at aug 257 (more rows than threads);
* under ThreadSanitizer no thread reads the shared region or the
  workspace where another writes without a barrier between;
* the measurement library (``ops/cuda_k1_measure.py``): the factor
  alone, whose block factor's sums equal the wide route's team_ldlt's
  bit for bit, and the clocked kernels' entry, which gives each route's
  bits;
* ``k1_route`` takes the block route exactly where K1_BLOCK_RULE's rows
  and the shared memory say, and the wide route in float64 at aug 257.
"""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu_torch.models.families import portfolio
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.models.fused_source import (fused_wide_block_source,
                                                  fused_wide_source)
from ipmzoo_tpu_torch.ops import cuda_fused, cuda_k1_measure

from test_torch_fused_emit import assert_same
from test_torch_fused_team import EMULATE, gxx, host_build  # noqa: F401

F64 = torch.float64


@functools.lru_cache(maxsize=None)
def case(n_assets, batch=2):
    """portfolio(n_assets) (aug_dim n_assets + 1), seed 3, and its float64
    FusedBatchedIPM on the CPU; the SoA data."""
    fam = portfolio(n_assets=n_assets, batch=batch, seed=3, device="cpu")
    solver = FusedBatchedIPM(fam.settings, fam.n, fam.m_ineq, fam.m_eq,
                             bt=batch, dtype=F64, max_iter=40, device="cpu")
    return solver, solver.soa_inputs(fam.data)[0]


def run(solver, lib, soa, route, warm=None, max_iter=30, gondzio=0,
        warps=None):
    fn = cuda_fused.bind(lib, F64, route)
    region = (cuda_fused.wide_shape(lib, F64) if route == "wide" else
              cuda_fused.block_shape(lib, F64, warps))["region"]
    out, err = cuda_fused.call(fn, soa, warm, solver.n,
                               sum(solver.var_sizes), max_iter, gondzio,
                               solver.kernel_params(), region=region,
                               warps=warps)
    assert err == 0
    return out


def assert_bits(a, b):
    for name, x, y in zip(("x", "variables", "iterations", "residual",
                           "gap", "mu"), a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("n_assets", [128, 256])
def test_one_lane_block_route_is_the_wide_route(n_assets, host_build):
    """aug_dim 129 and 257, float64, one host thread a block: cold, two
    Gondzio rounds and a warm resume, bit for bit; the cold solve also
    against the plain version."""
    solver, soa = case(n_assets)
    assert solver.aug_dim == n_assets + 1
    wide = host_build(fused_wide_source(solver))
    block = host_build(fused_wide_block_source(solver))
    for gondzio in (0, 2):
        w = run(solver, wide, soa, "wide", gondzio=gondzio)
        assert_bits(run(solver, block, soa, "block", gondzio=gondzio,
                        warps=4), w)
    cold = run(solver, block, soa, "block", warps=2)
    assert_same(cold, solver._fused_plain(soa, None, 30, 0))
    warm = (cold[1], cold[5], cold[2] - 3)
    assert_bits(run(solver, block, soa, "block", warm, max_iter=4, warps=8),
                run(solver, wide, soa, "wide", warm, max_iter=4))


@pytest.mark.parametrize("n_assets, warps, cold_iter", [
    (128, 2, 2),      # more threads than rows below column 65
    (128, 4, 1),      # as many threads as rows or more at every column
    (256, 2, 1),      # more rows than threads at the first 192 columns
])
def test_emulated_block_route_is_the_wide_route(n_assets, warps, cold_iter,
                                                host_build):
    """One instance as W x 32 host threads against the wide route as 32:
    the first iterations of a cold solve, of a Gondzio solve and of a warm
    resume from there, bit for bit (the host's threads are slow at the
    barriers: the one-lane build above runs the whole solves)."""
    solver, soa = case(n_assets, 1)
    wide = host_build(fused_wide_source(solver), EMULATE)
    block = host_build(fused_wide_block_source(solver), EMULATE)
    cold = run(solver, block, soa, "block", max_iter=cold_iter, warps=warps)
    assert_bits(cold, run(solver, wide, soa, "wide", max_iter=cold_iter))
    assert_bits(run(solver, block, soa, "block", max_iter=1, gondzio=2,
                    warps=warps),
                run(solver, wide, soa, "wide", max_iter=1, gondzio=2))
    warm = (cold[1], cold[5], cold[2])
    assert_bits(run(solver, block, soa, "block", warm, max_iter=1,
                    warps=warps),
                run(solver, wide, soa, "wide", warm, max_iter=1))


_TSAN_MAIN = r"""
#include <cstdio>
#include <random>
int main() {
  const int n = 128;
  std::mt19937 gen(7);
  std::uniform_real_distribution<double> u(0.0, 1.0);
  std::vector<double> Q(n * n), c(n), Aeq(n, 1.0), beq(1, 1.0), lx(n, 0.0),
      ux(n, 0.2);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j)
      Q[i * n + j] = Q[j * n + i] = i == j ? 0.2 + 0.1 * u(gen)
                                           : 0.001 * u(gen);
    c[i] = -0.02 - 0.05 * u(gen);
  }
  const double* data9[9] = {Q.data(), c.data(), nullptr, nullptr, nullptr,
                            Aeq.data(), beq.data(), lx.data(), ux.data()};
  int shape[5];
  ipmzoo_fused_block_shape(8, 2, shape);
  std::vector<double> work(shape[2]), x(n), vars(1024), it(1), res(1),
      gap(1), mu(1);
  double* out6[6] = {x.data(), vars.data(), it.data(), res.data(),
                     gap.data(), mu.data()};
  const double prm[6] = {1e-8, 1.0, 1e-8, 1e-30, 1e-30, 0.99};
  const int err = ipmzoo_fused_block_f64(data9, nullptr, nullptr, nullptr,
                                         out6, 1, prm, 2, 0, 1, 2,
                                         work.data(), nullptr);
  std::printf("err %d iterations %g residual %g\n", err, it[0], res[0]);
  return err;
}
"""


def test_block_route_leaves_no_data_race(gxx, tmp_path):
    """ThreadSanitizer over one portfolio instance (aug 129) as a block
    of 64 host threads, two iterations with a Gondzio round each: every
    read of the shared region and the workspace by another thread than
    the writer is ordered after the write by a team or block barrier, as
    on the card by __syncwarp and __syncthreads."""
    solver, _ = case(128)
    src = tmp_path / "tsan.cc"
    src.write_text(fused_wide_block_source(solver) + _TSAN_MAIN)
    exe = tmp_path / "tsan"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-g", "-ffp-contract=off", *EMULATE,
         "-fsanitize=thread", str(src), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300)
    assert "ThreadSanitizer" not in out.stderr, out.stderr[-6000:]
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
    assert out.stdout.split()[:4] == ["err", "0", "iterations", "2"], \
        out.stdout


def packed_quasi_definite(B, a, seed):
    """B packed lower triangles (row-major, tri(i, j) = i (i + 1) / 2 + j)
    of [[H, A^T], [A, -C]], H = M M^T / n1 + I, C diagonal >= 0.5."""
    rng = np.random.default_rng(seed)
    n1 = 2 * a // 3
    K = np.zeros((B, a, a))
    M = rng.normal(size=(B, n1, n1))
    K[:, :n1, :n1] = M @ np.swapaxes(M, 1, 2) / n1 + np.eye(n1)
    A = rng.normal(size=(B, a - n1, n1))
    K[:, n1:, :n1] = A
    K[:, n1:, n1:] = -np.einsum("bi,ij->bij",
                                np.abs(rng.normal(size=(B, a - n1))) + 0.5,
                                np.eye(a - n1))
    rows, cols = np.tril_indices(a)
    return torch.from_numpy(np.ascontiguousarray(K[:, rows, cols]))


def test_factor_alone_block_is_team_ldlt(host_build):
    """The measurement library's factor alone at aug 129: block_ldlt's
    sums equal the wide route's team_ldlt's bit for bit over two
    repetitions, and match an LDL^T in numpy; the emulated build
    refuses."""
    solver, _ = case(128)
    a = solver.aug_dim
    lib = host_build(cuda_k1_measure.source(solver))
    K0 = packed_quasi_definite(2, a, seed=5)
    sinks = {}
    for warps in (0, 4):
        sinks[warps], err = cuda_k1_measure.factor_reps(lib, K0, 2, warps,
                                                        solver.pivot_floor)
        assert err == 0
    assert torch.equal(sinks[0], sinks[4])
    want = []
    for k in K0.numpy():
        L, D = np.zeros((a, a)), np.zeros(a)
        rows, cols = np.tril_indices(a)
        L[rows, cols] = k
        for j in range(a):
            D[j] = L[j, j] - (L[j, :j] ** 2 * D[:j]).sum()
            L[j + 1:, j] = (L[j + 1:, j] - L[j + 1:, :j] @ (L[j, :j] *
                                                            D[:j])) / D[j]
        want.append(2 * (D.sum() + L[-1, :-1].sum()))
    np.testing.assert_allclose(sinks[0].numpy(), want, rtol=1e-12)
    emulated = host_build(cuda_k1_measure.source(solver), EMULATE)
    assert cuda_k1_measure.factor_reps(emulated, K0, 1, 4,
                                       solver.pivot_floor)[1] != 0
    assert cuda_k1_measure.factor_reps(lib, K0, 1, 3,
                                       solver.pivot_floor)[1] != 0


def test_clocked_entry_gives_each_routes_bits(host_build):
    """The measurement library's clocked entry at aug 129, one host
    thread an instance: on the wide route (warps = 0) and the block route
    it gives the route's own host build bit for bit, cold and with
    Gondzio rounds, and counts no cycles off the card; the library holds
    the block route's entry points, but the block route's own library
    holds no measurement entry."""
    solver, soa = case(128)
    text = cuda_k1_measure.source(solver)
    assert text.startswith(fused_wide_block_source(solver))
    assert "ipmzoo_k1" not in fused_wide_block_source(solver)
    lib = host_build(text)
    libs = {"wide": host_build(fused_wide_source(solver)),
            "block": host_build(fused_wide_block_source(solver))}
    for gondzio in (0, 2):
        for route, warps in (("wide", 0), ("block", 4)):
            region = (cuda_fused.wide_shape(libs["wide"], F64) if warps == 0
                      else cuda_fused.block_shape(lib, F64, warps))["region"]
            outs, cycles, err = cuda_k1_measure.clocked(
                lib, soa, None, solver.n, sum(solver.var_sizes), 30,
                gondzio, solver.kernel_params(), warps, region)
            assert err == 0
            assert_bits(outs, run(solver, libs[route], soa, route,
                                  gondzio=gondzio, warps=warps or None))
            assert cycles.shape == (2, 2) and not cycles.any()


def test_block_shape_and_shared_bytes(host_build):
    """The shared bytes a block are BlockLayout's values, which
    block_values gives exactly with the generated slots; the workspace is
    the staged data alone; the threads are W warps; W other than 2, 4, 8
    is refused."""
    solver, soa = case(128)
    lib = host_build(fused_wide_block_source(solver))
    sizes, slots = solver.k1_sizes(), solver.k1_slots()
    wide = cuda_fused.wide_shape(host_build(fused_wide_source(solver)), F64)
    for dtype in (torch.float32, F64):
        for warps in (2, 4, 8):
            sh = cuda_fused.block_shape(lib, dtype, warps)
            assert (sh["lanes"], sh["threads"], sh["blocks_per_sm"]) == \
                (1, 32 * warps, 0)
            assert sh["shared_bytes"] == dtype.itemsize * \
                cuda_fused.block_values(sizes, slots)
            assert 0 < sh["region"] < wide["region"]
    fn = cuda_fused.bind(lib, F64, "block")
    _, err = cuda_fused.call(fn, soa, None, solver.n, sum(solver.var_sizes),
                             5, 0, solver.kernel_params(), region=1,
                             warps=3)
    assert err != 0


def test_block_source_text():
    solver, _ = case(128)
    text = fused_wide_block_source(solver)
    assert "#define IPMZOO_TEAM_LANES 32" in text
    assert '#line 1 "fused_wide_block.cuh"' in text
    assert '#line 1 "fused_wide.cuh"' not in text
    assert "IPMZOO_FUSED_BLOCK_ENTRY_POINTS(ipmzoo_fused::Form)" in text
    assert solver.kernel_source("block") == text
    # the same generated struct Form as the wide route's
    wide = fused_wide_source(solver)
    gen = text.index('#line 1 "generated"')
    assert text[gen:].split("IPMZOO_FUSED")[0] == \
        wide[wide.index('#line 1 "generated"'):].split("IPMZOO_FUSED")[0]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("n, m, e, want32, want64", [
    (128, 0, 1, ("block", 4), ("block", 8)),    # portfolio, aug 129
    (100, 40, 0, ("block", 4), ("block", 8)),   # aug 140
    (144, 0, 1, ("block", 4), ("block", 8)),    # aug 145
    (145, 0, 1, ("block", 8), ("block", 8)),    # aug 146
    (160, 0, 1, ("block", 8), ("block", 8)),    # aug 161
    (128, 64, 0, ("block", 4), ("block", 8)),   # aug 192
    (100, 76, 0, ("block", 8), ("block", 8)),   # aug 176
    (200, 0, 1, ("block", 4), ("wide", None)),  # aug 201: f64 fits, not
                                                # measured above 192
    (210, 0, 1, ("block", 8), ("wide", None)),  # aug 211
    (224, 0, 1, ("block", 8), ("wide", None)),  # aug 225: f64 overflows
    (230, 0, 1, ("block", 8), ("wide", None)),  # aug 231
    (256, 0, 1, ("block", 8), ("wide", None)),  # aug 257
    (300, 0, 1, ("wide", None), ("wide", None)),  # aug 301: not measured
])
def test_k1_route_takes_the_block_route_where_the_rule_says(
        n, m, e, want32, want64, dtype):
    """With the generated code's slots (as solve_fused passes them)
    k1_route takes the block route at K1_BLOCK_RULE's warps wherever its
    rows hold the order and the block fits 227 KB, at any batch, and the
    wide route elsewhere above order 128; without the slots it refuses to
    choose there."""
    from ipmzoo_tpu_torch.models.convert import settings_from_reference
    from ipmzoo_tpu.formulations import Settings as RefSettings
    settings = portfolio(n_assets=4, device="cpu").settings if e else \
        settings_from_reference(RefSettings())
    solver = FusedBatchedIPM(settings, n, m, e, dtype=dtype, device="cpu")
    sizes, slots = solver.k1_sizes(), solver.k1_slots()
    route, warps = want64 if dtype == F64 else want32
    for B in (1, 32, 4096):
        assert cuda_fused.k1_route(B, sizes, dtype, slots) == route
    assert cuda_fused.block_warps(sizes, dtype, slots) == warps
    fits = cuda_fused.block_values(sizes, slots) * dtype.itemsize <= \
        cuda_fused.SHARED_CAP
    assert route == "wide" or fits
    with pytest.raises(ValueError, match="slots"):
        cuda_fused.k1_route(32, sizes, dtype)


def test_check_builds_differ_only_by_the_apart_lines(host_build):
    """The check builds (each generated function compiled apart on the
    card: chip_smoke.py's apart) are the launched text with APART's lines
    before the generated part; on the host those lines change nothing:
    bit for bit."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    solver, soa = case(128)
    lines = "\n".join(chip_smoke.APART) + "\n"
    gen = '#line 1 "generated"'
    for make in (fused_wide_source, fused_wide_block_source):
        text = make(solver)
        assert lines not in text
        assert chip_smoke.apart(text) == text.replace(gen, lines + gen, 1)
    block = host_build(fused_wide_block_source(solver))
    apart = host_build(chip_smoke.apart(fused_wide_block_source(solver)))
    assert_bits(run(solver, apart, soa, "block", max_iter=3, warps=4),
                run(solver, block, soa, "block", max_iter=3, warps=4))


def test_fused_soa_refuses_the_cpu_and_warps_off_the_block_route():
    solver, soa = case(128)
    args = (soa, None, solver.n, sum(solver.var_sizes), 5, 0,
            solver.kernel_params())
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fused.fused_soa(solver.kernel_source("block"), *args, "block",
                             4)
    with pytest.raises(ValueError, match="needs its warps"):
        cuda_fused.fused_soa(solver.kernel_source("block"), *args, "block")
    with pytest.raises(ValueError, match="needs its warps"):
        cuda_fused.fused_soa(solver.kernel_source("wide"), *args, "wide", 4)
