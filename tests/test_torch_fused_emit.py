"""Kernel K1's generated source, compiled for the host and held against
K1's plain version on the CPU.

The C++ that ``models/fused_source.py`` prints (the hand-written
``csrc/fused_ipm.cuh`` plus the generated ``struct Form``) compiles as
plain C++ when ``__CUDACC__`` is unset: ``__host__``/``__device__`` are
empty and the entry points loop over the instances on the host.  Built
with g++ (-O1 -ffp-contract=off, no fast-math), the same per-instance
code runs here and must give, in float64, the plain version's iteration
counts exactly and its x within 1e-10.
"""

import ctypes
import functools
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import Bounds, EqualityHandling, Settings
from ipmzoo_tpu_torch.models import codegen_soa as soa
from ipmzoo_tpu_torch.models.codegen_soa import CppSoA
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.data import QPData
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.models.fused_source import CUH
from ipmzoo_tpu_torch.ops import _build, cuda_fused
from ipmzoo_tpu_torch.symbolic import expr as E

FORMULATIONS = {
    # the fused slice's formulation at its sizes
    "slice": (Settings(), 16, 8, 0, {}),
    "box_only": (Settings(inequalities=Bounds.NONE), 5, 0, 0, {}),
    "equalities_slacked": (Settings(
        equalities=True,
        equality_handling=EqualityHandling.SLACKED_SLACKS), 5, 3, 2, {}),
    "equalities_penalty": (Settings(
        equalities=True,
        equality_handling=EqualityHandling.PENALTY_FUNCTION), 5, 3, 2, {}),
    "symbolic_taylor": (Settings(), 6, 3, 0, {"taylor": "symbolic"}),
}


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile a K1 source for the host; libraries are cached by text."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) found to build K1's "
                    "generated source")
    root = tmp_path_factory.mktemp("k1")

    @functools.lru_cache(maxsize=None)
    def build(source: str) -> ctypes.CDLL:
        key = hashlib.sha256(source.encode()).hexdigest()[:16]
        src, lib = root / f"k1-{key}.cc", root / f"k1-{key}.so"
        src.write_text(source)
        proc = subprocess.run(
            [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-x", "c++", str(src), "-o", str(lib)],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return ctypes.CDLL(str(lib))

    return build


def make_data(n, m, e, B=8, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    A_eq = rng.normal(size=(B, e, n))
    x0 = rng.uniform(-0.5, 0.5, size=(B, n))
    return QPData.make(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(B, n)), A_ineq=rng.normal(size=(B, m, n)),
        l_A_ineq=-np.abs(rng.normal(size=(B, m))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, m))) + 1,
        A_eq=A_eq, b_eq=np.einsum("bij,bj->bi", A_eq, x0),
        l_x=np.full((B, n), -5.0), u_x=np.full((B, n), 5.0), device="cpu")


def run_both(solver, lib, data, warm=None, max_iter=30, gondzio=0):
    """(host-built K1, plain version) outputs on the same SoA inputs."""
    soa, _ = solver.soa_inputs(data)
    fn = cuda_fused.bind(lib, solver.dtype)
    host, err = cuda_fused.call(fn, soa, warm, solver.n,
                                sum(solver.var_sizes), max_iter, gondzio,
                                solver.kernel_params())
    assert err == 0
    return host, solver._fused_plain(soa, warm, max_iter, gondzio)


def assert_same(host, plain):
    # x, not every variable: with equality slacks some duals are not
    # unique at the optimum and drift at rounding level
    x, _, its, res, gap, _ = host
    np.testing.assert_array_equal(its.numpy(), plain[2].numpy())
    np.testing.assert_allclose(x.numpy(), plain[0].numpy(), rtol=1e-10,
                               atol=1e-10)
    for a, b in ((res, plain[3]), (gap, plain[4])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("name", list(FORMULATIONS))
def test_host_build_matches_plain_version(name, host_build):
    settings, n, m, e, kw = FORMULATIONS[name]
    solver = FusedBatchedIPM(port_settings(settings), n=n, m_ineq=m, m_eq=e,
                             dtype=torch.float64, max_iter=40, device="cpu",
                             **kw)
    lib = host_build(solver.kernel_source())
    data = make_data(n, m, e)
    for gondzio in (0, 2):
        host, plain = run_both(solver, lib, data, gondzio=gondzio)
        assert bool(((plain[3] < solver.tol) & (plain[4] < solver.tol))
                    .all()), (name, gondzio)
        assert_same(host, plain)


def test_host_build_warm_resume(host_build):
    settings, n, m, e, _ = FORMULATIONS["slice"]
    solver = FusedBatchedIPM(port_settings(settings), n=n, m_ineq=m,
                             dtype=torch.float64, device="cpu")
    lib = host_build(solver.kernel_source())
    data = make_data(n, m, e, B=16, seed=3)
    cold, cold_plain = run_both(solver, lib, data, max_iter=4)
    assert_same(cold, cold_plain)
    warm = (cold[1], cold[5], cold[2])
    host, plain = run_both(solver, lib, data, warm=warm, max_iter=30,
                           gondzio=1)
    assert_same(host, plain)
    # iterations continue from the warm state's count
    assert bool((plain[2] > 4).all())


def test_safe_reciprocal_maps_zero_to_float32_sqrt_max(host_build):
    lib = host_build(CUH.read_text() + """
extern "C" double recip_f64(double x) { return ipmzoo_fused::ipm_recip(x); }
extern "C" float recip_f32(float x) { return ipmzoo_fused::ipm_recip(x); }
""")
    for name, ct in (("recip_f64", ctypes.c_double),
                     ("recip_f32", ctypes.c_float)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ct], ct
        assert fn(0.0) == float(np.sqrt(np.finfo(np.float32).max))
        assert fn(4.0) == 0.25
    # the emitter spells every inverse with that helper
    ev = CppSoA()
    inv = soa.invert_tv(ev, soa.vector(soa.array_vec("v", 3)))
    assert "ipm_recip(v[i])" in "\n".join(ev.lines)
    assert inv.val.size == 3


def test_emitter_rounds_literals_to_float32():
    ev = CppSoA()
    lit = soa.evaluate(ev, E.number(0.1), {})
    assert lit.val.expr == f"T({float(np.float32(0.1))!r})"
    # literal-with-literal arithmetic folds in float32, emitting nothing
    prod = soa.multiply_tv(ev, lit, soa.evaluate(ev, E.number(3.0), {}))
    assert prod.val.literal == np.float32(0.1) * np.float32(3.0)
    assert ev.lines == []


def test_host_build_float32_converges(host_build):
    settings, n, m, e, _ = FORMULATIONS["slice"]
    solver = FusedBatchedIPM(port_settings(settings), n=n, m_ineq=m, tol=1e-5,
                             device="cpu")
    lib = host_build(solver.kernel_source())
    data = make_data(n, m, e, B=16, seed=5).to(dtype=torch.float32)
    host, plain = run_both(solver, lib, data)
    assert host[0].dtype == torch.float32
    for out in (host, plain):
        assert bool(((out[3] < 1e-5) & (out[4] < 1e-5)).all())
    np.testing.assert_allclose(host[0].numpy(), plain[0].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_emitted_text_is_deterministic():
    def make(n, m):
        return FusedBatchedIPM(port_settings(Settings()), n=n, m_ineq=m,
                               device="cpu")

    a, b = make(16, 8).kernel_source(), make(16, 8).kernel_source()
    assert a == b
    assert (_build.generated_library_path("fused_ipm", a) ==
            _build.generated_library_path("fused_ipm", b))
    # the text is independent of the dtype and the scalar settings, which
    # are run-time arguments, and changes with the sizes
    c = FusedBatchedIPM(port_settings(Settings()), n=16, m_ineq=8,
                        dtype=torch.float64, tol=1e-9, mu0=2.0,
                        device="cpu").kernel_source()
    assert c == a
    assert make(16, 7).kernel_source() != a


def test_generated_build_is_keyed_by_text_and_flags(tmp_path):
    src = FusedBatchedIPM(port_settings(Settings()), n=4, m_ineq=2,
                          device="cpu").kernel_source()
    path = _build.generated_library_path("fused_ipm", src)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("fused_ipm-") and path.suffix == ".so"
    assert path != _build.generated_library_path("fused_ipm", src + " ")
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for bad in ("--use_fast_math", "-ftz=true", "-prec-div=false"):
        assert bad not in flags
