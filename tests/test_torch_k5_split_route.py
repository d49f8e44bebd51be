"""K5's split route (a matrix a block staged by asynchronous copies, the
factor on one segment of lanes, the right-hand sides split across the
block's segments) in ipmzoo_tpu_torch/ops/cuda_ldlt.py, on the CPU: the
route rule as a pure function pinned at the shapes the port's paths give
K5, the route's shared-memory bytes and cap, the launcher's refusals
before the CUDA library is loaded, and the route's data flow replayed on
the plain arithmetic (and, at one small shape, against the reference's
Pallas kernel in interpret mode).

Tolerances: the replay runs the plain version's operations in the route's
order and grouping, so it agrees with the plain version to rtol 1e-12 in
float64 (the factor subtracts in the plain version's order of j, the
backward sweep goes column by column where the plain version sums rows);
against the reference, 1e-10 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.ops.pallas_ldlt import batched_ldlt_solve_matrix_pallas
from ipmzoo_tpu_torch.ops import cuda_ldlt
from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR, ldlt_solve_matrix

f32, f64 = torch.float32, torch.float64
CAP = 232448


def quasi_definite(B, n, seed):
    """Symmetric quasi-definite [[H, A^T], [A, -C]], H and C positive
    definite, as the IPM's augmented systems."""
    rng = np.random.default_rng(seed)
    n1 = (n + 1) // 2
    n2 = n - n1
    M = rng.normal(size=(B, n1, n1))
    K = np.zeros((B, n, n))
    K[:, :n1, :n1] = np.einsum("bij,bkj->bik", M, M) / n1 + np.eye(n1)
    A = rng.normal(size=(B, n2, n1))
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = np.swapaxes(A, 1, 2)
    K[:, n1:, n1:] = -np.einsum("bi,ij->bij",
                                np.abs(rng.normal(size=(B, n2))) + 0.5,
                                np.eye(n2))
    return K


def inputs(B, n, k, seed):
    A = torch.from_numpy(quasi_definite(B, n, seed))
    R = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(B, n, k)))
    return A, R


# ----------------------------------------------------------------------
# the route rule
# ----------------------------------------------------------------------

#: (B, n, k, dtype) -> K5 route at every shape the paths give K5: the nd
#: slice's three levels, one instance and the batch of 8, and bench_kkt's
#: point, in both types
K5_PATH_ROUTES = [
    ((105, 64, 40, f32), "split"), ((105, 64, 40, f64), "split"),
    ((28, 16, 48, f32), "split"), ((28, 16, 48, f64), "split"),
    ((16, 16, 64, f32), "split"), ((16, 16, 64, f64), "split"),
    ((840, 64, 40, f32), "split"), ((840, 64, 40, f64), "block"),
    ((224, 16, 48, f32), "split"), ((224, 16, 48, f64), "split"),
    ((128, 16, 64, f32), "split"), ((128, 16, 64, f64), "split"),
    ((10240, 32, 2, f32), "warp"), ((10240, 32, 2, f64), "split"),
]

#: (B, n, k, dtype) -> K5 route at the edges of the measured rule: the
#: warp route's column limits by batch, its padding at order 24, the
#: block route's rows, and orders over the split route's 64 (its largest)
K5_RULE_EDGES = [
    ((105, 16, 4, f32), "warp"), ((105, 16, 5, f32), "split"),
    ((105, 16, 2, f64), "warp"), ((105, 16, 3, f64), "split"),
    ((840, 32, 48, f32), "warp"), ((840, 32, 49, f32), "split"),
    ((16, 24, 1, f32), "split"), ((10240, 24, 1, f32), "split"),
    ((10240, 25, 64, f32), "warp"), ((10240, 16, 64, f64), "warp"),
    ((4096, 32, 1, f64), "split"), ((16, 48, 4, f64), "split"),
    ((16, 48, 5, f64), "split"), ((16, 48, 4, f32), "split"),
    ((840, 8, 24, f32), "block"), ((840, 8, 23, f32), "split"),
    ((840, 16, 64, f32), "split"), ((840, 16, 64, f64), "block"),
    ((840, 48, 32, f64), "block"), ((840, 48, 31, f64), "split"),
    ((511, 48, 32, f64), "split"), ((840, 32, 64, f64), "split"),
    ((105, 65, 40, f32), "block"), ((105, 96, 40, f64), "block"),
    ((1, 64, 387, f64), "split"), ((1, 64, 388, f64), "block"),
]


@pytest.mark.parametrize("shape,route", K5_PATH_ROUTES + K5_RULE_EDGES,
                         ids=[str(s) for s, _ in
                              K5_PATH_ROUTES + K5_RULE_EDGES])
def test_k5_route_at_path_shapes_and_rule_edges(shape, route):
    assert cuda_ldlt.k5_route(*shape) == route


@pytest.mark.parametrize("dtype", [f32, f64])
def test_split_route_only_where_it_fits(dtype):
    for n in (1, 2, 15, 16, 17, 32, 33, 63, 64, 65, 96, 97, 168):
        for k in (1, 2, 3, 9, 40, 64, 203, 204, 500):
            for B in (1, 105, 10240):
                r = cuda_ldlt.k5_route(B, n, k, dtype)
                if r == "split":
                    assert n <= cuda_ldlt.K5_SPLIT_MAX_ORDER == 64
                    assert cuda_ldlt.factor_solve_matrix_split_bytes(
                        n, k, dtype) <= CAP
                    assert cuda_ldlt.k5_split_shape(B, n, k, dtype) \
                        is not None
                if n > 64:
                    assert r != "split"
                    assert cuda_ldlt.k5_split_shape(B, n, k, dtype) is None


# ----------------------------------------------------------------------
# shared memory, threads and the cap
# ----------------------------------------------------------------------

def test_split_bytes_shape_and_cap():
    # the panel at row stride n + 1, D, the unscaled column, and R at the
    # odd row stride k | 1
    assert cuda_ldlt.factor_solve_matrix_split_bytes(64, 40, f32) == \
        (64 * 67 + 64 * 41) * 4 == 27648
    assert cuda_ldlt.factor_solve_matrix_split_bytes(64, 40, f64) == 55296
    assert cuda_ldlt.factor_solve_matrix_split_bytes(16, 48, f32) == \
        (16 * 19 + 16 * 49) * 4
    assert cuda_ldlt.factor_solve_matrix_split_bytes(16, 64, f64) == \
        (16 * 19 + 16 * 65) * 8
    # one matrix a block, a group of 4 columns a segment: 10 warps at the
    # order-64 level, 12 and 16 sixteen-lane segments at the order-16 ones
    assert cuda_ldlt.k5_split_shape(105, 64, 40, f32) == 10
    assert cuda_ldlt.k5_split_shape(28, 16, 48, f32) == 12
    assert cuda_ldlt.k5_split_shape(16, 16, 64, f64) == 16
    # the batch of 8: one wave of 132 SMs x 384 threads holds 840 blocks of
    # one warp at order 64, 1.2k of 12 sixteen-lane segments at order 16
    assert cuda_ldlt.k5_split_shape(840, 64, 40, f32) == 1
    assert cuda_ldlt.k5_split_shape(224, 16, 48, f32) == 12
    assert cuda_ldlt.k5_split_shape(128, 16, 64, f32) == 16
    # the groups are evened out over the rounds a segment walks
    assert cuda_ldlt.k5_split_shape(840, 24, 40, f32) == 2
    assert cuda_ldlt.k5_split_shape(352, 24, 40, f32) == 5
    assert cuda_ldlt.k5_split_shape(2048, 16, 64, f32) == 2
    # more groups than 384 threads hold are walked in turn, evened out
    assert cuda_ldlt.k5_split_shape(1, 64, 100, f32) == 9
    assert cuda_ldlt.k5_split_shape(1, 16, 100, f32) == 13
    # groups given are taken where the block's threads hold them
    assert cuda_ldlt.k5_split_shape(9, 8, 5, f32, groups=24) == 24
    assert cuda_ldlt.k5_split_shape(9, 8, 5, f32, groups=25) is None
    assert cuda_ldlt.k5_split_shape(9, 33, 5, f32, groups=13) is None
    assert cuda_ldlt.k5_split_shape(9, 33, 5, f32, groups=0) is None
    # orders up to 64 (a warp, two rows a lane), k within the cap
    for dtype in (f32, f64):
        assert cuda_ldlt.k5_split_shape(1, 64, 1, dtype) is not None
        assert cuda_ldlt.k5_split_shape(1, 65, 1, dtype) is None
        assert cuda_ldlt.k5_split_shape(1, 5, 0, dtype) is None
    # order 64: (64 * 67 + 64 * (k | 1)) sizeof(T) <= CAP up to k = 387 in
    # float64 and k = 841 in float32
    for dtype, kmax in ((f64, 387), (f32, 841)):
        assert cuda_ldlt.factor_solve_matrix_split_bytes(64, kmax, dtype) \
            <= CAP < cuda_ldlt.factor_solve_matrix_split_bytes(
                64, kmax + 1, dtype)
        assert cuda_ldlt.k5_split_shape(1, 64, kmax, dtype) is not None
        assert cuda_ldlt.k5_split_shape(1, 64, kmax + 1, dtype) is None
    assert cuda_ldlt.k5_route(1, 64, 388, f64) == "block"


# ----------------------------------------------------------------------
# the launcher refuses before the CUDA library is loaded
# ----------------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    def boom():
        raise AssertionError("the CUDA library was loaded")
    monkeypatch.setattr(cuda_ldlt, "_lib", boom)


def test_split_launcher_checks_before_launching(no_library):
    A, R = torch.zeros((2, 3, 3)), torch.zeros((2, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.factor_solve_matrix_split(A, R)
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_ldlt.factor_solve_matrix_split(A.half(), R.half())
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.factor_solve_matrix_split(torch.zeros((2, 4, 4)), R)
    with pytest.raises(ValueError, match="float64"):
        cuda_ldlt.factor_solve_matrix_split(A, R.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ldlt.factor_solve_matrix_split(
            torch.zeros((2, 3, 3)).transpose(1, 2), R)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ldlt.factor_solve_matrix_split(
            A, torch.zeros((2, 2, 3)).transpose(1, 2))
    with pytest.raises(ValueError, match="split route does not take"):
        cuda_ldlt.factor_solve_matrix_split(torch.zeros((1, 65, 65)),
                                            torch.zeros((1, 65, 1)))
    with pytest.raises(ValueError, match="split route does not take"):
        cuda_ldlt.factor_solve_matrix_split(
            torch.zeros((1, 64, 64), dtype=f64),
            torch.zeros((1, 64, 388), dtype=f64))
    with pytest.raises(ValueError, match="split route does not take"):
        cuda_ldlt.factor_solve_matrix_split(A, R, groups=25)
    for shape in ((2, 3, 0), (0, 3, 2)):
        with pytest.raises(ValueError, match="B, n, k > 0"):
            cuda_ldlt.factor_solve_matrix_split(
                torch.zeros(shape[:2] + (shape[1],)), torch.zeros(shape))
    with pytest.raises(ValueError, match="B, n, k > 0"):
        cuda_ldlt.factor_solve_matrix_split(torch.zeros((2, 0, 0)),
                                            torch.zeros((2, 0, 2)))


def test_split_route_counted_apart():
    assert "ldlt_solve_matrix split" in cuda_ldlt.route_launches
    cuda_ldlt.route_launches["ldlt_solve_matrix split"] = 3
    cuda_ldlt.reset_launch_counts()
    assert cuda_ldlt.route_launches["ldlt_solve_matrix split"] == 0


# ----------------------------------------------------------------------
# the split route's data flow, replayed on the plain arithmetic
# ----------------------------------------------------------------------

def factor_registers(P, ucol, n, S, seg, rows, pivot_floor):
    """The factor with a lane's rows in registers: slot r of lane l is row
    r seg + l and holds (r + 1) seg registers, register c the row's column
    j + c at column j (zeros past n).  Column block jb runs columns
    jb seg .. (jb + 1) seg - 1 on slots r >= jb: each row at or below j
    sets its register 0 aside in ucol, the pivot is ucol[j], each row below
    j scales register 0 into L (written to the panel at once), and every
    register c >= 1 moves to c - 1, less l_ij times ucol[j + c].  Returns
    D."""
    row = torch.arange(rows)[:, None] * seg + torch.arange(seg)
    zero = torch.zeros((), dtype=P.dtype)
    a = []
    for r in range(rows):
        c = torch.arange((r + 1) * seg)
        held = (row[r][:, None] < n) & (c < n)
        a.append(torch.where(held, P[(row[r][:, None] * S + c).clamp(
            max=P.numel() - 1)], zero))
    D = torch.empty(n, dtype=P.dtype)
    for jb in range(rows):
        for j in range(jb * seg, min(n, (jb + 1) * seg)):
            for r in range(jb, rows):
                keep = (row[r] >= j) & (row[r] < n)
                ucol[row[r][keep]] = a[r][keep, 0]
            d = ucol[j]
            d = torch.where(d == 0, torch.full_like(d, pivot_floor), d)
            D[j] = d
            lij = []
            for r in range(rows):
                below = (row[r] > j) & (row[r] < n)
                lr = torch.where(below, a[r][:, 0] / d, zero) if r >= jb \
                    else None
                if r >= jb:
                    P[row[r][below] * S + j] = lr[below]
                lij.append(lr)
            for c in range(1, (rows - jb) * seg):
                uc = ucol[j + c] if j + c < n else zero
                for r in range(jb, rows):
                    if c < (r + 1 - jb) * seg:
                        a[r][:, c - 1] = a[r][:, c] - lij[r] * uc
    return D


def factor_panel(P, ucol, n, S, seg, rows, pivot_floor):
    """The factor in the staged panel: the same steps, the unscaled
    column set aside, each row updated in place on j < c <= i."""
    D = torch.empty(n, dtype=P.dtype)
    for j in range(n):
        d = P[j * S + j]
        d = torch.where(d == 0, torch.full_like(d, pivot_floor), d)
        D[j] = d
        i = torch.arange(j + 1, n)
        ucol[i] = P[i * S + j]
        P[i * S + j] = ucol[i] / d
        for c in range(j + 1, n):
            i = torch.arange(c, n)
            P[i * S + c] = P[i * S + c] - P[i * S + j] * ucol[c]
    return D


def sweep_group(P, D, Xt, n, k, S, SR, seg, rows, c0, KC):
    """One segment's group of KC columns: the forward sweep by row in
    increasing j with row j taken from its owner lane, the division by D,
    the backward sweep column by column from the last; X in place."""
    row = torch.arange(rows)[:, None] * seg + torch.arange(seg)
    cols = c0 + torch.arange(KC)
    live = (row < n)[..., None] & (cols < k)
    idx = (row[..., None] * SR + cols).clamp(max=Xt.numel() - 1)
    zero = torch.zeros((), dtype=Xt.dtype)
    v = torch.where(live, Xt[idx], zero)
    for j in range(n):
        y = v[j // seg, j % seg].clone()
        below = (row > j) & (row < n)
        lij = P[(row * S + j).clamp(max=P.numel() - 1)]
        v = torch.where(below[..., None], v - lij[..., None] * y, v)
    v = torch.where((row < n)[..., None],
                    v / D[row.clamp(max=n - 1)][..., None], v)
    for j in range(n - 1, 0, -1):
        y = v[j // seg, j % seg].clone()
        above = row < j
        lji = P[(j * S + row).clamp(max=P.numel() - 1)]
        v = torch.where(above[..., None], v - lji[..., None] * y, v)
    Xt[idx[live]] = v[live]


def split_replay(A, R, groups, registers, pivot_floor=PIVOT_FLOOR):
    """K5's split route replayed block by block (a matrix each) on a flat
    tile poisoned with NaN: A and R staged as contiguous runs (A at row
    stride n + 1, R at k | 1), segment 0 factors the matrix, segment q
    solves column groups q, q + groups, ... of 4 columns, X overwriting R
    in the tile; L, D and X read back from the tile."""
    B, n, k = R.shape
    seg, KC = cuda_ldlt._split_segment(n), cuda_ldlt.K5_SPLIT_COLS
    rows = -(-n // seg)
    S, SR = n + 1, k | 1
    per = n * S + 2 * n + n * SR
    L, D, X = (torch.full(s, float("nan"), dtype=R.dtype)
               for s in (A.shape, (B, n), R.shape))
    Af, Rf = A.reshape(-1), R.reshape(-1)
    factor = factor_registers if registers else factor_panel
    for b in range(B):
        tile = torch.full((per,), float("nan"), dtype=R.dtype)
        e = torch.arange(n * n)
        tile[(e // n) * S + e % n] = Af[b * n * n + e]
        e = torch.arange(n * k)
        tile[n * S + 2 * n + (e // k) * SR + e % k] = Rf[b * n * k + e]
        P = tile[:n * S]
        tile[n * S:n * S + n] = factor(P, tile[n * S + n:n * S + 2 * n], n,
                                       S, seg, rows, pivot_floor)
        Xt = tile[n * S + 2 * n:]
        for q in range(groups):
            for c0 in range(q * KC, k, groups * KC):
                sweep_group(P, tile[n * S:n * S + n], Xt, n, k, S, SR, seg,
                            rows, c0, KC)
        L[b] = torch.where(torch.ones(n, n, dtype=torch.bool).tril(-1),
                           P.reshape(n, S)[:, :n],
                           torch.eye(n, dtype=R.dtype))
        D[b] = tile[n * S:n * S + n]
        X[b] = Xt.reshape(n, SR)[:, :k]
    return L, D, X


@pytest.mark.parametrize("registers", [True, False],
                         ids=["rows in registers", "rows in the panel"])
@pytest.mark.parametrize("B,n,k,groups", [
    (2, 1, 1, 1), (3, 5, 4, 1), (2, 16, 9, 3), (3, 17, 11, 2),
    (1, 33, 20, 5), (1, 64, 40, 4)])
def test_split_replay_matches_plain(B, n, k, groups, registers):
    A, R = inputs(B, n, k, seed=n + k)
    L0, D0, X0 = ldlt_solve_matrix(A, R)
    L, D, X = split_replay(A, R, groups, registers)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.diagonal(L, dim1=1, dim2=2),
                       torch.ones((B, n), dtype=L.dtype))
    np.testing.assert_allclose(L.numpy(), L0.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(D.numpy(), D0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(X.numpy(), X0.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_split_replay_puts_the_pivot_floor_on_an_exact_zero():
    A, R = inputs(2, 16, 9, seed=3)
    A[:, :2, :] = 0.0
    A[:, :, :2] = 0.0
    A[:, :2, :2] = 1.0
    for registers in (True, False):
        _, D, X = split_replay(A, R, 3, registers)
        assert bool((D[:, 1] == PIVOT_FLOOR).all())
        np.testing.assert_allclose(X.numpy(),
                                   ldlt_solve_matrix(A, R)[2].numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_split_replay_matches_the_reference_kernel():
    A, R = inputs(2, 12, 9, seed=12)
    L_ref, D_ref, X_ref = batched_ldlt_solve_matrix_pallas(
        jnp.asarray(A.numpy()), jnp.asarray(R.numpy()), PIVOT_FLOOR)
    L, D, X = split_replay(A, R, 3, True)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_ref), rtol=1e-10)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_ref), rtol=1e-10,
                               atol=1e-10)
