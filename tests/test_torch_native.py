"""The port's native host tier (ipmzoo_tpu_torch.native): the JAX
package's tests/test_native.py on the port, its comparisons with the
device kernels run against the port's ldlt_auto / solve_ldlt_auto on CPU
tensors (the plain K2/K3), every function's output bit for bit against
the JAX package's native tier on the same input (the same code built
with the same compiler and flags), and where the library is built."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu import native as ref_native
from ipmzoo_tpu_torch import native
from ipmzoo_tpu_torch.ops import _build
from ipmzoo_tpu_torch.ops.cuda_ldlt import ldlt_auto, solve_ldlt_auto

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_DIR = ROOT / "ipmzoo_tpu_torch" / "native"


@pytest.fixture(autouse=True, scope="module")
def _toolchain():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def quasidefinite(n1, n2, seed):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n1, n1))
    H = H @ H.T + n1 * np.eye(n1)
    S = rng.normal(size=(n2, n2))
    S = S @ S.T + n2 * np.eye(n2)
    A = rng.normal(size=(n2, n1))
    return np.block([[H, A.T], [A, -S]])


def indefinite(n, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return (M + M.T) / 2


def kkt(n, m, seed):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    Q = Q @ Q.T / n + np.eye(n)
    A = rng.normal(size=(m, n))
    return np.block([[Q, A.T], [A, np.zeros((m, m))]])


def plain_ldlt(A):
    """The port's ldlt_auto on a CPU tensor (K2's plain version) of one
    matrix, as numpy."""
    L, D = ldlt_auto(torch.as_tensor(A)[None])
    return L[0].numpy(), D[0].numpy()


class TestLDLT:
    @pytest.mark.parametrize("n1,n2", [(4, 2), (16, 9), (40, 23)])
    def test_factor_and_solve(self, n1, n2):
        A = quasidefinite(n1, n2, seed=n1 + n2)
        L, D = native.ldlt_factor(A)
        np.testing.assert_allclose(L @ np.diag(D) @ L.T, A,
                                   rtol=1e-9, atol=1e-9)
        b = np.random.default_rng(0).normal(size=n1 + n2)
        x = native.ldlt_solve(L, D, b)
        np.testing.assert_allclose(A @ x, b, rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("n1,n2", [(4, 2), (16, 9), (40, 23)])
    def test_matches_plain_k2_k3(self, n1, n2):
        A = quasidefinite(n1, n2, seed=n1 + n2)
        b = np.random.default_rng(0).normal(size=n1 + n2)
        Ln, Dn = native.ldlt_factor(A)
        L, D = ldlt_auto(torch.as_tensor(A)[None])
        np.testing.assert_allclose(Ln, L[0].numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(Dn, D[0].numpy(), rtol=1e-9, atol=1e-9)
        x = solve_ldlt_auto(L, D, torch.as_tensor(b)[None])[0].numpy()
        np.testing.assert_allclose(native.ldlt_solve(Ln, Dn, b), x,
                                   rtol=1e-9, atol=1e-9)

    def test_pivot_floor(self):
        L, D = native.ldlt_factor(np.zeros((3, 3)))
        assert np.all(D == 1e-8)
        _, Dp = plain_ldlt(np.zeros((3, 3)))
        assert np.all(Dp == 1e-8)

    def test_batch(self):
        nb, n1, n2 = 16, 6, 3
        A = np.stack([quasidefinite(n1, n2, seed=s) for s in range(nb)])
        b = np.random.default_rng(1).normal(size=(nb, n1 + n2))
        x = native.ldlt_factor_solve_batch(A, b)
        np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x), b,
                                   rtol=1e-8, atol=1e-8)

    def test_matches_device_kernel(self):
        """The native tier and the plain K2 agree (up to floating-point
        summation order)."""
        A = quasidefinite(8, 5, seed=42)
        Ln, Dn = native.ldlt_factor(A)
        Lp, Dp = plain_ldlt(A)
        np.testing.assert_allclose(Ln, Lp, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(Dn, Dp, rtol=1e-9, atol=1e-9)


class TestBunchKaufman:
    @pytest.mark.parametrize("n", [1, 2, 3, 8, 25, 60])
    def test_solve_indefinite(self, n):
        A = indefinite(n, seed=n)
        F, ipiv, info = native.bunch_kaufman_factor(A)
        assert info == 0
        rng = np.random.default_rng(2)
        for _ in range(3):
            b = rng.normal(size=n)
            x = native.bunch_kaufman_solve(F, ipiv, b)
            np.testing.assert_allclose(A @ x, b, rtol=1e-7, atol=1e-7)

    def test_needs_2x2_pivots(self):
        A = np.array([[0.0, 1.0], [1.0, 0.0]])
        F, ipiv, info = native.bunch_kaufman_factor(A)
        assert info == 0
        b = np.array([1.0, 2.0])
        x = native.bunch_kaufman_solve(F, ipiv, b)
        np.testing.assert_allclose(A @ x, b, atol=1e-12)
        assert ipiv[0] < 0  # a 2x2 block was used

    def test_saddle_point_matrix(self):
        rng = np.random.default_rng(3)
        n, m = 6, 3
        Q = rng.normal(size=(n, n))
        Q = Q @ Q.T + np.eye(n)
        A = rng.normal(size=(m, n))
        K = np.block([[Q, A.T], [A, np.zeros((m, m))]])
        F, ipiv, info = native.bunch_kaufman_factor(K)
        assert info == 0
        b = rng.normal(size=n + m)
        x = native.bunch_kaufman_solve(F, ipiv, b)
        np.testing.assert_allclose(K @ x, b, rtol=1e-8, atol=1e-8)

    def test_vs_numpy(self):
        A = indefinite(12, seed=7)
        b = np.random.default_rng(4).normal(size=12)
        F, ipiv, _ = native.bunch_kaufman_factor(A)
        x = native.bunch_kaufman_solve(F, ipiv, b)
        np.testing.assert_allclose(x, np.linalg.solve(A, b),
                                   rtol=1e-8, atol=1e-8)


class TestRegLDLTAgainstBK:
    """The IPM's 'regldlt' recipe (signed regularisation, unpivoted
    LDL^T, three refinement sweeps) on the port's ldlt_auto /
    solve_ldlt_auto reproduces the native Bunch-Kaufman solution on
    indefinite KKT systems with a zero dual block."""

    @staticmethod
    def _regldlt_solve(K, b, signs, sweeps=3):
        Kt = torch.as_tensor(K)[None]
        bt = torch.as_tensor(b)[None]
        eps = float(np.finfo(K.dtype).eps)
        scale = max(1.0, float(np.max(np.abs(np.diag(K)))))
        Kr = Kt + torch.diag(torch.as_tensor(signs * eps ** (2 / 3) * scale))
        L, D = ldlt_auto(Kr)
        x = solve_ldlt_auto(L, D, bt)
        for _ in range(sweeps):
            x = x + solve_ldlt_auto(L, D,
                                    bt - torch.einsum("bij,bj->bi", Kt, x))
        return x[0].numpy()

    @pytest.mark.parametrize("n,m", [(6, 2), (20, 8), (48, 17)])
    def test_matches_bunch_kaufman(self, n, m):
        K = kkt(n, m, seed=n)
        b = np.random.default_rng(n + 1).normal(size=n + m)
        F, ipiv, info = native.bunch_kaufman_factor(K)
        assert info == 0
        x_bk = native.bunch_kaufman_solve(F, ipiv, b)
        signs = np.concatenate([np.ones(n), -np.ones(m)])
        x_reg = self._regldlt_solve(K, b, signs)
        np.testing.assert_allclose(x_reg, x_bk, rtol=1e-9, atol=1e-9)

    def test_batched_matches_bunch_kaufman(self):
        n, m, batch = 12, 5, 8
        Ks = np.stack([kkt(n, m, seed=100 + i) for i in range(batch)])
        bs = np.random.default_rng(0).normal(size=(batch, n + m))
        signs = np.concatenate([np.ones(n), -np.ones(m)])
        # the reference's batched recipe regularises at eps^(2/3), unscaled
        Kt, bt = torch.as_tensor(Ks), torch.as_tensor(bs)
        eps = float(np.finfo(np.float64).eps)
        Kr = Kt + torch.diag_embed(torch.as_tensor(signs * eps ** (2 / 3)))
        L, D = ldlt_auto(Kr)
        x = solve_ldlt_auto(L, D, bt)
        for _ in range(3):
            x = x + solve_ldlt_auto(L, D,
                                    bt - torch.einsum("bij,bj->bi", Kt, x))
        for i in range(batch):
            F, ipiv, info = native.bunch_kaufman_factor(Ks[i])
            assert info == 0
            x_bk = native.bunch_kaufman_solve(F, ipiv, bs[i])
            np.testing.assert_allclose(x[i].numpy(), x_bk, rtol=1e-9,
                                       atol=1e-9)


@pytest.fixture(scope="class")
def ref_built_here(tmp_path_factory):
    """The JAX package's native tier on a library that its own ``_build``
    compiles here from its source, into a temporary directory.  The
    library committed beside that source was built on another host with
    ``-march=native``, whose instruction choices (fused multiply-adds)
    round differently in the last bit; built by this host's g++ with the
    same flags, the two sources (which differ only in a comment) give the
    same bits."""
    mod = ref_native.native
    saved = mod._LIB, mod._lib
    mod._LIB = str(tmp_path_factory.mktemp("ref_native") /
                   "_linear_solvers.so")
    mod._lib = None
    try:
        if not mod.available():
            pytest.skip("the JAX package's native tier does not build here")
        yield ref_native
    finally:
        mod._LIB, mod._lib = saved


class TestAgainstReferenceNative:
    """Same source, same g++, same flags: the same bits."""

    @pytest.fixture(autouse=True)
    def _ref(self, ref_built_here):
        self.ref = ref_built_here

    @pytest.mark.parametrize("n1,n2", [(4, 2), (16, 9), (40, 23)])
    def test_ldlt_factor_and_solve(self, n1, n2):
        A = quasidefinite(n1, n2, seed=n1 + n2)
        b = np.random.default_rng(0).normal(size=n1 + n2)
        L, D = native.ldlt_factor(A)
        Lr, Dr = self.ref.ldlt_factor(A)
        np.testing.assert_array_equal(L, Lr)
        np.testing.assert_array_equal(D, Dr)
        np.testing.assert_array_equal(native.ldlt_solve(L, D, b),
                                      self.ref.ldlt_solve(Lr, Dr, b))

    def test_ldlt_pivot_floor(self):
        for floor in (1e-8, 1e-4):
            Z = np.zeros((3, 3))
            np.testing.assert_array_equal(
                native.ldlt_factor(Z, floor)[1],
                self.ref.ldlt_factor(Z, floor)[1])

    def test_ldlt_factor_solve_batch(self):
        A = np.stack([quasidefinite(6, 3, seed=s) for s in range(16)])
        b = np.random.default_rng(1).normal(size=(16, 9))
        np.testing.assert_array_equal(
            native.ldlt_factor_solve_batch(A, b),
            self.ref.ldlt_factor_solve_batch(A, b))

    @pytest.mark.parametrize("n", [1, 2, 8, 25, 60])
    def test_bunch_kaufman(self, n):
        A = indefinite(n, seed=n)
        b = np.random.default_rng(2).normal(size=n)
        F, ipiv, info = native.bunch_kaufman_factor(A)
        Fr, ipivr, infor = self.ref.bunch_kaufman_factor(A)
        np.testing.assert_array_equal(F, Fr)
        np.testing.assert_array_equal(ipiv, ipivr)
        assert info == infor
        np.testing.assert_array_equal(
            native.bunch_kaufman_solve(F, ipiv, b),
            self.ref.bunch_kaufman_solve(Fr, ipivr, b))

    def test_facade(self):
        assert native.NativeLinearSolvers.ldlt_factor is native.ldlt_factor
        A = kkt(6, 2, seed=3)
        F, ipiv, _ = native.NativeLinearSolvers.bunch_kaufman_factor(A)
        Fr, _, _ = self.ref.NativeLinearSolvers.bunch_kaufman_factor(A)
        np.testing.assert_array_equal(F, Fr)


@pytest.mark.parametrize("n1,n2", [(4, 2), (16, 9), (40, 23)])
def test_matches_committed_reference_library(n1, n2):
    """Against the library committed beside the JAX package's source
    (built on another host, see ``ref_built_here``): the last bit may
    differ, so within 1e-13 relative."""
    if not ref_native.available():
        pytest.skip("the JAX package's native tier does not load")
    A = quasidefinite(n1, n2, seed=n1 + n2)
    b = np.random.default_rng(0).normal(size=n1 + n2)
    L, D = native.ldlt_factor(A)
    Lr, Dr = ref_native.ldlt_factor(A)
    np.testing.assert_allclose(L, Lr, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(D, Dr, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(native.ldlt_solve(L, D, b),
                               ref_native.ldlt_solve(Lr, Dr, b),
                               rtol=1e-13, atol=1e-15)


def test_library_lands_in_the_build_directory():
    info = native.build_info()
    path = Path(info["path"])
    assert path.parent == _build.resolve_build_dir()
    assert path.exists() and path.with_suffix(".log").exists()
    assert info["flags"] in (" ".join(native.native.FLAGS),
                             " ".join(native.native.RETRY_FLAGS))
    assert path == native.native.library_path(info["flags"].split())
    # nothing but the sources (and Python's bytecode cache) in the package
    assert sorted(p.name for p in PACKAGE_DIR.iterdir()
                  if p.name != "__pycache__") == \
        ["__init__.py", "linear_solvers.cpp", "native.py"]


def test_build_directory_is_named_by_the_environment(tmp_path):
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from ipmzoo_tpu_torch import native
        info = native.build_info()
        assert native.ldlt_factor(np.eye(2))[1].tolist() == [1.0, 1.0]
        loaded = [m for m in sys.modules
                  if m in ("jax", "jaxlib", "ipmzoo_tpu")
                  or m.startswith(("jax.", "jaxlib.", "ipmzoo_tpu."))]
        print("INFO", info["path"], info["built"], "LOADED", loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), IPMZOO_TORCH_BUILD_DIR=str(tmp_path))
    before = sorted(p.name for p in PACKAGE_DIR.iterdir())
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    words = out.stdout.split()
    assert Path(words[1]).parent == tmp_path and words[2] == "True"
    assert "LOADED []" in out.stdout
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and names[0].endswith(".log") and \
        names[1].endswith(".so")
    assert sorted(p.name for p in PACKAGE_DIR.iterdir()) == before
