"""Kernel T3 on K1's block and wide routes, against the plain version.

Above augmented order 128 K1 runs its block route (a thread block of W
warps an instance, ``csrc/fused_wide_block.cuh``) or its wide route (one
warp an instance, ``csrc/fused_wide.cuh``), and T3 runs there too:
``models/fused_phases.py:phase_block_source`` and ``phase_wide_source``
(``csrc/fused_phases_block.cuh``, ``csrc/fused_phases_wide.cuh`` around
K1's texts and ``csrc/fused_phases_team.cuh``).  Their sources compile for
the host, as K1's in ``test_torch_fused_wide_block.py``:

* at one lane (the block is one host thread; the wide route one lane);
* emulated (IPMZOO_TEAM_EMULATE): the block as W x 32 host threads at
  W = 4 and 8, the first 32 the team, all of them in the factor's row
  split and block barriers; the wide route as 32 host threads.

At portfolio(128) (aug 129, K1's wide slice) every prefix of each build
is held to the plain version (``phase_plain``) on the same seeded data:
float64 within 1e-10 and float32 within 1e-4, both outputs, the metrics
nudge off and on; the emulated builds run one instance (a block barrier
of 256 host threads is slow).  ThreadSanitizer runs the emulated block
prefix 4; the prefixes answer K1's shape queries with K1's layout; the
route T3 takes is K1's at every order.  ``test_torch_phases_block_ref.py``
holds the plain version to the reference tool's kernel at aug 129.
"""

import ctypes
import functools
import hashlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ipmzoo_tpu_torch import Settings
from ipmzoo_tpu_torch.models import fused_phases as fp
from ipmzoo_tpu_torch.models.families import portfolio
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.models.fused_source import (fused_wide_block_source,
                                                  fused_wide_source)
from ipmzoo_tpu_torch.ops import cuda_fused

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
PHASES = range(len(fp.PHASES))
EMULATE = ("-DIPMZOO_TEAM_EMULATE", "-pthread")
#: (route, build, warps, instances): the builds and launches held
RUNS = (("block", "one", 4, 2), ("block", "emulated", 4, 1),
        ("block", "emulated", 8, 1), ("wide", "one", None, 2),
        ("wide", "emulated", None, 1))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale > 0 else 1.0)


@functools.lru_cache(maxsize=None)
def case(dtype, n_assets=128, batch=2):
    """portfolio(n_assets) (aug n_assets + 1), seed 3: the solver on the
    CPU and its SoA data."""
    fam = portfolio(n_assets=n_assets, batch=batch, seed=3, dtype=dtype,
                    device="cpu")
    solver = FusedBatchedIPM(fam.settings, fam.n, fam.m_ineq, fam.m_eq,
                             bt=batch, dtype=dtype, device="cpu")
    return solver, solver.soa_inputs(fam.data)[0]


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("no host C++ compiler (g++) found to build the block "
                    "and wide routes' sources")
    return path


@pytest.fixture(scope="module")
def libs(gxx, tmp_path_factory):
    """Every host library this file loads, compiled at once: the five
    prefixes of each route at aug 129, one lane ("one") and emulated
    ("emulated"), and K1's block and wide routes at one lane ("K1")."""
    root = tmp_path_factory.mktemp("t3block")
    solver, _ = case(torch.float64)
    sources = {(route, p, build): fp.SOURCES[route](solver, p)
               for route in ("block", "wide") for p in PHASES
               for build in ("one", "emulated")}
    sources[("block", "K1", "one")] = fused_wide_block_source(solver)
    sources[("wide", "K1", "one")] = fused_wide_source(solver)

    def build(key):
        text, emulated = sources[key], key[2] == "emulated"
        name = hashlib.sha256((text + key[2]).encode()).hexdigest()[:16]
        src, lib = root / f"t-{name}.cc", root / f"t-{name}.so"
        src.write_text(text)
        proc = subprocess.run(
            [gxx, "-std=c++20" if emulated else "-std=c++17", "-O1",
             "-ffp-contract=off", "-shared", "-fPIC",
             *(EMULATE if emulated else ()), "-x", "c++", str(src), "-o",
             str(lib)], capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(6) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def run_prefix(lib, solver, soa, route, warps, reps=1, perturb=0):
    fn = cuda_fused.bind_phase(lib, solver.dtype, route)
    region = cuda_fused.region_values(lib, solver.dtype, route, warps,
                                       "phase")
    outs, err = cuda_fused.call_phase(fn, soa, solver.kernel_params(), reps,
                                      perturb, None, region, warps)
    assert err == 0
    return outs


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_and_wide_prefixes_against_plain(libs, dtype, phase):
    """Every build and launch of RUNS against the plain version on the
    same instances, the metrics nudge off (one repetition) and on (two)."""
    solver, soa = case(dtype)
    assert solver.aug_dim == 129
    tol = TOL[dtype]
    for route, build, warps, b in RUNS:
        part = [t[..., :b].contiguous() for t in soa]
        lib = libs[(route, phase, build)]
        for reps, perturb in ((1, 0), (2, 1)):
            acc, sink = run_prefix(lib, solver, part, route, warps, reps,
                                   perturb)
            pacc, psink = fp.phase_plain(solver, part, phase, reps, perturb)
            where = (route, build, warps, reps, perturb)
            assert bool(torch.isfinite(sink).all()), where
            assert rel(acc.numpy(), pacc.numpy()) <= tol, where
            assert rel(sink.numpy(), psink.numpy()) <= tol, where
            if phase == 0:
                assert not acc.any(), where
            else:
                assert acc.abs().min() > 0, where


def test_one_lane_block_and_wide_prefixes_agree_bit_for_bit(libs):
    """At one lane the block route's factor (block_ldlt on one thread) is
    team_ldlt's arithmetic element for element and the rest is the same
    team code: the two routes' prefixes give the same bits, and a W other
    than 2, 4 or 8 is refused."""
    solver, soa = case(torch.float64)
    for p in PHASES:
        block = run_prefix(libs[("block", p, "one")], solver, soa, "block",
                           2, 2, 1)
        wide = run_prefix(libs[("wide", p, "one")], solver, soa, "wide",
                          None, 2, 1)
        assert all(torch.equal(x, y) for x, y in zip(block, wide)), p
    lib = libs[("block", 4, "one")]
    fn = cuda_fused.bind_phase(lib, solver.dtype, "block")
    region = cuda_fused.region_values(lib, solver.dtype, "block", 4, "phase")
    assert cuda_fused.call_phase(fn, soa, solver.kernel_params(), 1, 0, None,
                                 region, 3)[1] != 0


def test_prefixes_run_on_k1s_layout(libs):
    """Each prefix's shape query gives K1's: on the block route the
    workspace values an instance and the shared bytes a block
    (block_values with the generated slots) at every W, on the wide route
    the TeamLayout region."""
    solver, _ = case(torch.float64)
    sizes, slots = solver.k1_sizes(), solver.k1_slots()
    k1_block, k1_wide = libs[("block", "K1", "one")], \
        libs[("wide", "K1", "one")]
    for dtype in (torch.float32, torch.float64):
        wide = cuda_fused.wide_shape(k1_wide, dtype)
        for p in PHASES:
            for w in (2, 4, 8):
                sh = cuda_fused.block_shape(libs[("block", p, "one")], dtype,
                                            w, "phase")
                assert sh == cuda_fused.block_shape(k1_block, dtype, w)
                assert sh["shared_bytes"] == dtype.itemsize * \
                    cuda_fused.block_values(sizes, slots)
                assert sh["threads"] == 32 * w
            assert cuda_fused.wide_shape(libs[("wide", p, "one")], dtype,
                                         "phase") == wide


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
  ipmzoo_phase_block_shape(8, 2, shape);
  std::vector<double> work(shape[2]);
  double acc = 0, sink = 0;
  const double prm[6] = {1e-8, 1.0, 1e-8, 1e-30, 1e-30, 0.99};
  const int err = ipmzoo_phase_block_f64(data9, &acc, &sink, 1, prm, 2, 1,
                                         2, work.data(), nullptr);
  std::printf("err %d acc %g sink %g\n", err, acc, sink);
  return err;
}
"""


def test_block_prefix_leaves_no_data_race(gxx, tmp_path):
    """ThreadSanitizer over prefix 4 (every phase: the factor on the whole
    block, the directions, the metrics) of one portfolio instance (aug
    129) as a block of 64 host threads, two repetitions with the nudge:
    every read of the shared region and the workspace by another thread
    than the writer is ordered after the write by a team or block barrier,
    as on the card by __syncwarp and __syncthreads."""
    solver, _ = case(torch.float64)
    src = tmp_path / "tsan.cc"
    src.write_text(fp.phase_block_source(solver, 4) + _TSAN_MAIN)
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
    words = out.stdout.split()
    assert words[:2] == ["err", "0"] and np.isfinite(float(words[5])), \
        out.stdout


@functools.lru_cache(maxsize=None)
def point(aug, dtype):
    """A solver of augmented order ``aug`` on the CPU: the fused slice
    (Settings(), n=16, m_ineq=8: 24), the default formulation at n=128,
    m_ineq=64 (192), and portfolios of 128 and 256 assets (129, 257)."""
    if aug in (24, 192):
        n, m = (16, 8) if aug == 24 else (128, 64)
        return FusedBatchedIPM(Settings(), n, m, 0, dtype=dtype,
                               device="cpu")
    return case(dtype, aug - 1, 1)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("aug", [24, 129, 192, 257])
def test_t3_takes_k1s_route_at_every_order(aug, dtype):
    """phase_route is k1_route (with the generated slots above 128) at any
    batch, launch_route adds K1's warps on the block route and raises at
    none of K1's routes, and the route's source generates: T3 runs wherever
    K1 runs."""
    solver = point(aug, dtype)
    assert solver.aug_dim == aug
    sizes = solver.k1_sizes()
    slots = solver.k1_slots() if aug > cuda_fused.THREAD_MAX_AUG else None
    want = {24: "team", 129: "block", 192: "block",
            257: "block" if dtype == torch.float32 else "wide"}[aug]
    for B in (1, 512, 4096):
        route = fp.phase_route(solver, B)
        assert route == cuda_fused.k1_route(B, sizes, dtype, slots) == want
        warps = (cuda_fused.block_warps(sizes, dtype, slots)
                 if route == "block" else None)
        assert fp.launch_route(solver, B) == (route, warps)
    assert "IPMZOO_PHASE" in fp.SOURCES[want](solver, 2)
    if aug > cuda_fused.THREAD_MAX_AUG:
        with pytest.raises(ValueError, match="built only up to order 128"):
            fp.phase_source(solver, 0)


def test_sources_are_deterministic_per_route_prefix_and_warps():
    """The block and wide prefixes' texts: K1's text of the route with
    the same struct Form, the prefix's headers and entry points, one text
    a prefix, the same for both dtypes, and one build for every W (the
    warps are a launch argument)."""
    s32, _ = case(torch.float32)
    s64, _ = case(torch.float64)
    for route, k1, headers, entry in (
            ("block", fused_wide_block_source,
             (fp.PHASE_TEAM_CUH, fp.PHASE_BLOCK_CUH),
             "IPMZOO_PHASE_BLOCK_ENTRY_POINTS"),
            ("wide", fused_wide_source, (fp.PHASE_TEAM_CUH, fp.PHASE_WIDE_CUH),
             "IPMZOO_PHASE_WIDE_ENTRY_POINTS")):
        text = k1(s32)
        gen = text.index('#line 1 "generated"')
        head = text[text.index("#define IPMZOO_TEAM_LANES 32"):gen]
        form = text[gen:text.index("IPMZOO_FUSED", gen)]
        texts = [fp.SOURCES[route](s32, p) for p in PHASES]
        for p, src in enumerate(texts):
            assert src == fp.SOURCES[route](s32, p) == \
                fp.SOURCES[route](s64, p)
            # K1's headers, then the prefix's, then K1's generated part
            assert src.index(head) < src.index(headers[0].read_text())
            assert form in src
            assert all(h.read_text() in src for h in headers)
            assert src.rstrip().endswith(f"{entry}(ipmzoo_fused::Form, {p})")
            assert "IPMZOO_FUSED_" not in src.split(
                '#line 1 "generated"')[1]
        assert len(set(texts)) == len(texts)
    with pytest.raises(ValueError, match="phase 5"):
        fp.phase_block_source(s32, 5)


def test_launches_refuse_the_cpu_and_count_per_route():
    """The block and wide routes' launches take CUDA tensors only, the
    block route its warps and no other route any; phase() on CPU tensors
    runs the plain version and launches nothing; the counts have a key a
    route."""
    solver, soa = case(torch.float64)
    cuda_fused.reset_launch_counts()
    plain = fp.phase_plain(solver, soa, 2)
    for route in (None, "block", "wide"):
        out = fp.phase(solver, soa, 2, route=route)
        assert all(torch.equal(x, y) for x, y in zip(out, plain))
    assert cuda_fused.launches == {"fused": 0, "phase": 0}
    assert set(cuda_fused.phase_route_launches) == {
        f"phase {r}" for r in fp.ROUTES}
    assert not any(cuda_fused.phase_route_launches.values())
    args = (soa, solver.kernel_params(), 1, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fused.phase_soa(fp.phase_block_source(solver, 0), *args,
                             "block", 4)
    with pytest.raises(ValueError, match="needs its warps"):
        cuda_fused.phase_soa(fp.phase_block_source(solver, 0), *args,
                             "block")
    with pytest.raises(ValueError, match="needs its warps"):
        cuda_fused.phase_soa(fp.phase_wide_source(solver, 0), *args, "wide",
                             4)
    with pytest.raises(ValueError, match="no block route"):
        fp.launch_route(point(24, torch.float64), 32, "block")
