"""The fused engine above augmented order 128 on the CPU: K1's plain
version and K1's wide route (``csrc/fused_wide.cuh``, one warp an
instance, its region in a device-memory workspace) in host builds.

* ``FusedBatchedIPM`` builds and solves at aug_dim 129 (``portfolio``,
  128 assets) and 160 (``svm_dual``, 160 samples): the plain version in
  float64 against the JAX package's ``CompiledIPM(kernel="jnp")``
  (iterations equal, x within 1e-8), and ``solve_fused_compact`` with
  every instance left a straggler by a three-iteration schedule, so that
  the Gondzio tail solves them, against the JAX package's
  ``CompiledIPM(kernel="jnp", gondzio=2)``;
* the wide route's source builds with g++ and, each instance as 32 host
  threads (IPMZOO_TEAM_EMULATE) with its region in a host workspace,
  gives the plain version's iterations and x within 1e-10 in float64
  (cold, Gondzio rounds, warm), as ``tests/test_torch_fused_team.py``
  holds the team route, and under ThreadSanitizer no lane reads the
  region where another writes without a team barrier between;
* ``k1_route`` takes a wide route (the wide or the block route) exactly
  where four teams overflow a block's shared memory above order 128, and
  the thread route is not built above 128.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import Settings as RefSettings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import families as ref_families
from ipmzoo_tpu_torch.models.convert import (family_from_reference,
                                             settings_from_reference)
from ipmzoo_tpu_torch.models.families import portfolio
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.models.fused_source import (fused_team_source,
                                                  fused_wide_source)
from ipmzoo_tpu_torch.ops import cuda_fused, cuda_ldlt

from test_torch_fused_emit import assert_same
from test_torch_fused_team import EMULATE, gxx, host_build  # noqa: F401

F64 = torch.float64

#: the reference's families at aug_dim 129 and 160, two instances each
CASES = {
    "portfolio128": lambda: ref_families.portfolio(
        n_assets=128, batch=2, seed=0, dtype=jnp.float64),
    "svm160": lambda: ref_families.svm_dual(
        n_samples=160, batch=2, seed=0, dtype=jnp.float64),
}


def port_of(ref, **kw):
    """The port's family and its FusedBatchedIPM (float64, on the CPU,
    tile 2) for the reference's family ``ref``."""
    fam = family_from_reference(ref, dtype=F64, device="cpu")
    kw = dict(dict(bt=2, dtype=F64, device="cpu"), **kw)
    return fam, FusedBatchedIPM(fam.settings, fam.n, fam.m_ineq, fam.m_eq,
                                **kw)


def ref_solve(ref, **kw):
    return RefIPM(ref.settings, n=ref.n, m_ineq=ref.m_ineq, m_eq=ref.m_eq,
                  dtype=jnp.float64, kernel="jnp", **kw).solve_batch(
                      ref.data)


@pytest.mark.parametrize("name, aug", [("portfolio128", 129),
                                       ("svm160", 160)])
def test_plain_version_matches_jax_jnp_solver(name, aug):
    ref = CASES[name]()
    fam, solver = port_of(ref)
    assert solver.aug_dim == aug
    r = ref_solve(ref)
    out = solver.solve_fused(fam.data)
    assert bool(out["converged"].all()) and bool(np.all(r.converged))
    np.testing.assert_array_equal(out["iterations"].numpy(),
                                  np.asarray(r.iterations))
    dx = np.abs(out["x"].numpy() - np.asarray(r.x)).max()
    print(f"{name} aug {aug}: largest |x - x_ref| {dx:.3e}")
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(r.x),
                               rtol=1e-8, atol=1e-8)


def test_compact_tail_solves_the_stragglers_as_jax_jnp():
    """Three fused iterations leave both instances unconverged; with no
    fused tail and no escalation the Gondzio tail cold-restarts them (the
    base class's masked loop over ``ldlt_auto``: on the card the
    panel-blocked LDL^T at this order, here its plain version), which is
    the reference's jnp solver with two Gondzio rounds, three iterations
    later."""
    ref = CASES["portfolio128"]()
    fam, solver = port_of(ref)
    assert cuda_ldlt.ldlt_route(solver.aug_dim) == "blocked"
    first = solver.solve_fused(fam.data, max_iter=3)
    assert not bool(first["converged"].any())
    solver.host_syncs = 0
    out = solver.solve_fused_compact(fam.data, schedule=[(3, 1)],
                                     fused_tail=False, esc_cap=0)
    r = ref_solve(ref, gondzio=2)
    assert bool(out["converged"].all()) and bool(np.all(r.converged))
    np.testing.assert_array_equal(out["iterations"].numpy(),
                                  np.asarray(r.iterations) + 3)
    assert solver.host_syncs > int(np.max(r.iterations))
    dx = np.abs(out["x"].numpy() - np.asarray(r.x)).max()
    print(f"portfolio128 tail: largest |x - x_ref| {dx:.3e}")
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(r.x),
                               rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# the wide route's source, built for the host
# ---------------------------------------------------------------------------

def wide_solver(n_assets=128, **kw):
    fam = portfolio(n_assets=n_assets, batch=2, seed=3, device="cpu")
    kw = dict(dict(bt=2, dtype=F64, max_iter=40, device="cpu"), **kw)
    return fam, FusedBatchedIPM(fam.settings, fam.n, fam.m_ineq, fam.m_eq,
                                **kw)


def run_wide(solver, lib, soa_data, warm=None, max_iter=30, gondzio=0):
    fn = cuda_fused.bind(lib, solver.dtype, "wide")
    region = cuda_fused.wide_shape(lib, solver.dtype)["region"]
    out, err = cuda_fused.call(fn, soa_data, warm, solver.n,
                               sum(solver.var_sizes), max_iter, gondzio,
                               solver.kernel_params(), region=region)
    assert err == 0
    return out


def test_emulated_wide_route_matches_plain_version(host_build):
    """Each instance as one warp of 32 host threads, its region in a host
    workspace, at aug_dim 129: cold, with two Gondzio rounds, and a warm
    resume, float64."""
    fam, solver = wide_solver()
    assert solver.aug_dim == 129
    lib = host_build(fused_wide_source(solver), EMULATE)
    assert cuda_fused.wide_shape(lib, F64)["lanes"] == 32
    soa_data, _ = solver.soa_inputs(fam.data)
    for gondzio in (0, 2):
        host = run_wide(solver, lib, soa_data, gondzio=gondzio)
        plain = solver._fused_plain(soa_data, None, 30, gondzio)
        assert bool(((plain[3] < solver.tol) & (plain[4] < solver.tol))
                    .all()), gondzio
        assert_same(host, plain)
    warm = (host[1], host[5], host[2] - 3)
    host = run_wide(solver, lib, soa_data, warm, max_iter=4)
    assert_same(host, solver._fused_plain(soa_data, warm, 4, 0))


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
  int shape[4];
  ipmzoo_fused_wide_shape(8, shape);
  std::vector<double> work(shape[2]), x(n), vars(1024), it(1), res(1),
      gap(1), mu(1);
  double* out6[6] = {x.data(), vars.data(), it.data(), res.data(),
                     gap.data(), mu.data()};
  const double prm[6] = {1e-8, 1.0, 1e-8, 1e-30, 1e-30, 0.99};
  const int err = ipmzoo_fused_wide_f64(data9, nullptr, nullptr, nullptr,
                                        out6, 1, prm, 4, 0, 1, work.data(),
                                        nullptr);
  std::printf("err %d iterations %g residual %g\n", err, it[0], res[0]);
  return err;
}
"""


def test_wide_route_leaves_no_data_race(gxx, tmp_path):
    """ThreadSanitizer over one portfolio instance (aug 129) as 32 host
    threads, its region in a heap workspace, four iterations with a
    Gondzio round each: every cross-lane read of the region is ordered
    after its write by a team barrier, as on the card by __syncwarp."""
    _, solver = wide_solver()
    src = tmp_path / "tsan.cc"
    src.write_text(fused_wide_source(solver) + _TSAN_MAIN)
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
    assert run.stdout.split()[:4] == ["err", "0", "iterations", "4"], \
        run.stdout


def test_wide_route_one_lane_at_order_257(host_build):
    """The one-lane host build at aug_dim 257 (the solve's column loops
    above order 128), cold, float64."""
    fam, solver = wide_solver(256)
    assert solver.aug_dim == 257
    lib = host_build(fused_wide_source(solver))
    soa_data, _ = solver.soa_inputs(fam.data)
    assert_same(run_wide(solver, lib, soa_data),
                solver._fused_plain(soa_data, None, 30, 0))


def test_wide_shape_and_workspace(host_build):
    """The workspace is TeamLayout's region an instance (within the team
    route's sizing rule) on the data's device; one warp a block."""
    fam, solver = wide_solver()
    lib = host_build(fused_wide_source(solver))
    for dtype in (torch.float32, F64):
        sh = cuda_fused.wide_shape(lib, dtype)
        assert (sh["lanes"], sh["threads"], sh["blocks_per_sm"]) == (1, 32, 0)
        assert 0 < sh["region"] <= cuda_fused.team_values(
            solver.k1_sizes()) + 48
    fn = cuda_fused.bind(lib, F64, "wide")
    soa_data, _ = solver.soa_inputs(fam.data)
    empty = [t[..., :0].contiguous() for t in soa_data]
    outs, err = cuda_fused.call(fn, empty, None, solver.n,
                                sum(solver.var_sizes), 5, 0,
                                solver.kernel_params(), region=1)
    assert err == 0 and outs[0].shape == (solver.n, 0)


def test_wide_source_text():
    _, solver = wide_solver()
    text = fused_wide_source(solver)
    assert "#define IPMZOO_TEAM_LANES 32" in text
    assert '#line 1 "fused_wide.cuh"' in text
    assert "IPMZOO_FUSED_WIDE_ENTRY_POINTS(ipmzoo_fused::Form)" in text
    assert "IPMZOO_FUSED_TEAM_ENTRY_POINTS(ipmzoo_fused::Form)" not in text
    assert solver.kernel_source("wide") == text == fused_wide_source(
        wide_solver()[1])
    # the same generated functions as the team route at 32 lanes
    team = fused_team_source(solver, 32)
    gen = text.index('#line 1 "generated"')
    assert text[gen:].split("IPMZOO_FUSED")[0] == \
        team[team.index('#line 1 "generated"'):].split("IPMZOO_FUSED")[0]


def test_thread_route_is_not_built_above_order_128():
    _, solver = wide_solver()
    with pytest.raises(ValueError, match="thread route"):
        solver.kernel_source("thread")
    _, small = wide_solver(127)
    assert small.aug_dim == 128
    assert "ipmzoo_fused_f32" in small.kernel_source("thread")


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("n, m, e, route, route64", [
    (16, 8, 0, "team", "team"),         # the fused slice
    (100, 20, 0, "thread", "thread"),   # aug 120: four teams overflow
    (127, 0, 1, "thread", "thread"),    # portfolio, aug 128
    (128, 0, 1, "block", "block"),      # portfolio, aug 129
    (100, 40, 0, "block", "block"),     # aug 140
    (128, 64, 0, "block", "block"),     # aug 192
    (256, 0, 1, "block", "wide"),       # aug 257
])
def test_k1_route_takes_the_wide_route_above_128(n, m, e, route, route64,
                                                 dtype):
    """Above order 128, where four teams overflow the shared memory,
    k1_route, given the generated code's slots as solve_fused gives them,
    takes the block route (csrc/fused_wide_block.cuh) where
    K1_BLOCK_RULE's rows take the order and the block fits, else the
    wide route (float64 at aug 257); without the slots it refuses to
    choose there.  test_torch_fused_wide_block.py holds the rule
    itself."""
    route = route64 if dtype == F64 else route
    settings = portfolio(n_assets=4, device="cpu").settings if e else \
        settings_from_reference(RefSettings())
    solver = FusedBatchedIPM(settings, n, m, e, dtype=dtype, device="cpu")
    sizes = solver.k1_sizes()
    wide = solver.aug_dim > cuda_fused.THREAD_MAX_AUG
    slots = solver.k1_slots() if wide else None
    for B in (32, 512, 4096):
        assert cuda_fused.k1_route(B, sizes, dtype, slots) == route
    if wide:
        with pytest.raises(ValueError, match="slots"):
            cuda_fused.k1_route(32, sizes, dtype)
    fits = 4 * cuda_fused.team_values(sizes) * dtype.itemsize <= \
        cuda_fused.SHARED_CAP
    assert (route == "team") == fits
    assert (route in ("wide", "block")) == (not fits and wide)


def test_team_route_prints_a_one_equality_formulation(host_build):
    """A one-entry lane-local vector in a one-entry loop (portfolio's
    single budget row) is read at the lane's own slot: the team route's
    text prints and its host build gives the plain version's solve."""
    fam = portfolio(n_assets=12, batch=3, seed=1, device="cpu")
    solver = FusedBatchedIPM(fam.settings, fam.n, fam.m_ineq, fam.m_eq,
                             bt=3, dtype=F64, max_iter=40, device="cpu")
    assert cuda_fused.k1_route(3, solver.k1_sizes(), F64) == "team"
    lib = host_build(fused_team_source(solver), EMULATE)
    soa_data, _ = solver.soa_inputs(fam.data)
    fn = cuda_fused.bind(lib, F64, "team")
    host, err = cuda_fused.call(fn, soa_data, None, solver.n,
                                sum(solver.var_sizes), 30, 0,
                                solver.kernel_params())
    assert err == 0
    assert_same(host, solver._fused_plain(soa_data, None, 30, 0))
