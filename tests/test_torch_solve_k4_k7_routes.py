"""The second routes of K4 (a staged tile of the factor, warps across the
right-hand sides) in ipmzoo_tpu_torch/ops/cuda_ldlt.py and of K7 (the
working right-hand sides in shared memory, split by column groups) in
ipmzoo_tpu_torch/ops/cuda_cr.py, on the CPU: the route rules as pure
functions pinned at the shapes the port's paths give the kernels, the
shared-memory byte counts and caps, the launchers' refusals before the
CUDA library is loaded, the wrappers' plain versions on CPU tensors, and
each new route's data flow replayed on the plain arithmetic (and, at one
small shape each, against the reference's Pallas kernel in interpret
mode).

Tolerances: the replays run the plain versions' operations in the
routes' order and grouping, so they agree with the plain versions to
rtol 1e-12 in float64 (K4's backward sweep goes column by column where
the plain version sums rows); against the reference, 1e-10 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.ops.cr_pallas import cr_factor_pallas, cr_solve_pallas
from ipmzoo_tpu.ops.pallas_ldlt import batched_solve_ldlt_matrix_pallas
from ipmzoo_tpu_torch.ops import cuda_cr, cuda_ldlt
from ipmzoo_tpu_torch.ops.cr import (CRKernelFactors, _mm, _t,
                                     cr_factor_plain, cr_solve_plain, levels)
from ipmzoo_tpu_torch.ops.ldlt import ldlt, solve_ldlt_matrix

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


def spd_block_tridiag(B, N, b, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, N, b, b))
    D = np.einsum("anij,ankj->anik", M, M) / b + 4.0 * np.eye(b)
    E = rng.normal(size=(B, N - 1, b, b)) * (0.3 / np.sqrt(b))
    return torch.from_numpy(D), torch.from_numpy(E)


# ----------------------------------------------------------------------
# the route rules
# ----------------------------------------------------------------------

#: (n, k, B, dtype) -> K4 route: the Schur slice's H blocks (its float64
#: solve and plain float32), chip_smoke's other K4 shapes, the nd slice's
#: generic top (order 328, K2 + K4), the edges of each row of the measured
#: rule (the thread route below order 6 up to 2048 systems, past them
#: below 7 / 11 with k <= 4 and 15 / 16 with more columns), the route's
#: cap of 96 rows a warp, and k = 0
K4_PATH_ROUTES = [
    ((64, 16, 512, f64), "warp"), ((64, 16, 512, f32), "warp"),
    ((24, 2, 10240, f32), "warp"), ((24, 2, 10240, f64), "warp"),
    ((13, 5, 1000, f64), "warp"), ((328, 1, 1, f32), "thread"),
    ((328, 1, 1, f64), "thread"), ((1, 1, 5, f32), "thread"),
    ((5, 2, 9, f64), "thread"), ((6, 2, 9, f64), "warp"),
    ((6, 16, 2048, f32), "warp"), ((6, 4, 2049, f32), "thread"),
    ((7, 4, 10240, f32), "warp"), ((14, 16, 10240, f32), "thread"),
    ((15, 16, 10240, f32), "warp"), ((10, 4, 10240, f64), "thread"),
    ((11, 4, 10240, f64), "warp"), ((15, 16, 10240, f64), "thread"),
    ((16, 16, 10240, f64), "warp"),
    ((81, 16, 9, f64), "warp"), ((96, 16, 9, f64), "warp"),
    ((97, 1, 9, f64), "thread"), ((96, 3, 9, f32), "warp"),
    ((97, 3, 9, f32), "thread"), ((64, 40, 105, f32), "warp"),
    ((5, 0, 3, f64), "thread"),
]

#: (N, b, k, B, dtype) -> K7 route and columns a group: the arrow slice's
#: two solves per iteration (k = 9 and k = 1), one instance and the batch
#: of 32, in both types (the fewest columns that keep every group on an
#: SM of its own: 1 at one instance, 3 at 32, 2 at 16); batches where one
#: group an instance fills the card, up to the float64 shared memory's 4
#: columns; chip_smoke's odd shape; N = 1; an order over the route's
#: unrolling and a chain over its shared memory; k = 0
K7_PATH_ROUTES = [
    ((256, 16, 9, 1, f32), ("shared", 1)),
    ((256, 16, 1, 1, f32), ("shared", 1)),
    ((256, 16, 9, 32, f32), ("shared", 3)),
    ((256, 16, 1, 32, f32), ("shared", 1)),
    ((256, 16, 9, 1, f64), ("shared", 1)),
    ((256, 16, 1, 1, f64), ("shared", 1)),
    ((256, 16, 9, 32, f64), ("shared", 3)),
    ((256, 16, 1, 32, f64), ("shared", 1)),
    ((256, 16, 9, 16, f32), ("shared", 2)),
    ((256, 16, 9, 64, f32), ("shared", 5)),
    ((256, 16, 9, 64, f64), ("shared", 4)),
    ((256, 16, 9, 200, f32), ("shared", 9)),
    ((256, 16, 9, 200, f64), ("shared", 4)),
    ((37, 8, 3, 1, f32), ("shared", 1)),
    ((256, 3, 9, 1, f64), ("shared", 1)),
    ((1, 16, 1, 1, f64), ("shared", 1)),
    ((256, 17, 9, 1, f32), ("block", None)),
    ((4096, 16, 1, 1, f32), ("block", None)),
    ((256, 16, 0, 1, f32), ("block", None)),
]


@pytest.mark.parametrize("shape,route", K4_PATH_ROUTES,
                         ids=[str(s) for s, _ in K4_PATH_ROUTES])
def test_k4_route_at_path_shapes(shape, route):
    assert cuda_ldlt.k4_route(*shape) == route


@pytest.mark.parametrize("shape,route", K7_PATH_ROUTES,
                         ids=[str(s) for s, _ in K7_PATH_ROUTES])
def test_k7_route_at_path_shapes(shape, route):
    assert cuda_cr.k7_route(*shape) == route


@pytest.mark.parametrize("dtype", [f32, f64])
def test_routes_never_exceed_what_a_route_holds(dtype):
    for n in list(range(1, 100)) + [168, 328]:
        for k in (1, 2, 4, 5, 16, 40, 64, 300):
            r = cuda_ldlt.k4_route(n, k, 512, dtype)
            assert r in ("warp", "thread")
            shape = cuda_ldlt.k4_warp_shape(n, k, dtype)
            assert (r == "warp") == (shape is not None and n >= 6)
            if shape is not None:
                tile, groups = shape
                assert tile in cuda_ldlt.K4_TILES
                assert tile * groups * cuda_ldlt._segment(n) <= 512
                assert cuda_ldlt.solve_matrix_warp_bytes(
                    n, groups, dtype, tile) <= CAP
                assert groups * cuda_ldlt.K4_WARP_COLS < k + \
                    cuda_ldlt.K4_WARP_COLS
    for N in (1, 2, 3, 37, 256, 1000, 4096):
        for b in (1, 3, 8, 9, 16, 17, 32):
            for k in (1, 3, 9, 100):
                for B in (1, 32):
                    route, kc = cuda_cr.k7_route(N, b, k, B, dtype)
                    assert route in ("shared", "block")
                    if route == "shared":
                        assert 1 <= kc <= k and b <= cuda_cr.SHARED_MAX_B
                        assert cuda_cr.solve_shared_bytes(N, b, kc,
                                                          dtype) <= CAP
                    else:
                        assert kc is None


# ----------------------------------------------------------------------
# shared memory and caps
# ----------------------------------------------------------------------

def test_k4_warp_bytes_shape_and_cap():
    # per instance of the tile: L at row stride n + 1, D, and a chunk of
    # groups x 4 columns at an odd row stride
    assert cuda_ldlt.solve_matrix_warp_bytes(64, 4, f64, 4) == \
        4 * (64 * 66 + 64 * 17) * 8
    assert cuda_ldlt.solve_matrix_warp_bytes(64, 4, f32, 8) == \
        8 * (64 * 66 + 64 * 17) * 4
    assert cuda_ldlt.solve_matrix_warp_bytes(24, 1, f32, 8) == \
        8 * (24 * 26 + 24 * 5) * 4
    # the Schur shape: a tile of 4 instances and four groups of 4 columns
    # a matrix, 512 threads, 168 KB in float64
    assert cuda_ldlt.k4_warp_shape(64, 16, f64) == (4, 4)
    assert cuda_ldlt.k4_warp_shape(64, 16, f32) == (4, 4)
    assert cuda_ldlt.k4_warp_shape(64, 16, f32, 8) == (8, 2)
    assert cuda_ldlt.solve_matrix_warp_bytes(64, 4, f64, 4) == 169984
    # k > 16: the columns come in chunks of the threads' cap
    assert cuda_ldlt.k4_warp_shape(64, 40, f64) == (4, 4)
    assert cuda_ldlt.k4_warp_shape(8, 40, f32) == (4, 10)
    assert cuda_ldlt.k4_warp_shape(1, 1, f32) == (4, 1)
    # where a tile of 4 leaves room for fewer groups, a tile of 2
    assert cuda_ldlt.k4_warp_shape(81, 16, f64, 4) == (4, 1)
    assert cuda_ldlt.k4_warp_shape(81, 16, f64) == (2, 4)
    assert cuda_ldlt.k4_warp_shape(81, 16, f32) == (4, 4)
    # one group of 4 columns beside the factor: a tile of 4 holds orders
    # up to 81 in float64, the segments' 96 rows cap both types
    assert cuda_ldlt.k4_warp_shape(81, 1, f64, 4) == (4, 1)
    assert cuda_ldlt.k4_warp_shape(82, 1, f64, 4) is None
    assert cuda_ldlt.solve_matrix_warp_bytes(81, 1, f64, 4) <= CAP < \
        cuda_ldlt.solve_matrix_warp_bytes(82, 1, f64, 4)
    for dtype in (f32, f64):
        assert cuda_ldlt.k4_warp_shape(96, 4, dtype) is not None
        assert cuda_ldlt.k4_warp_shape(97, 4, dtype) is None
    assert cuda_ldlt.k4_warp_shape(5, 0, f64) is None


def test_k7_shared_bytes_and_cap():
    # (N + ceil(N / 2)) b values a column: 24 KB in float32 and 48 KB in
    # float64 at the arrow slice's N = 256, b = 16
    assert cuda_cr.solve_shared_bytes(256, 16, 1, f32) == 384 * 16 * 4
    assert cuda_cr.solve_shared_bytes(256, 16, 9, f64) == 384 * 16 * 9 * 8
    assert cuda_cr.solve_shared_bytes(37, 3, 2, f64) == (37 + 19) * 3 * 2 * 8
    assert cuda_cr.solve_shared_max_kc(256, 16, f32) == 9
    assert cuda_cr.solve_shared_max_kc(256, 16, f64) == 4
    assert cuda_cr.solve_shared_max_kc(4096, 16, f32) == 0
    assert cuda_cr.solve_shared_max_kc(256, 17, f32) == 0
    assert cuda_cr.shared_fits(256, 16, 9, 9, f32)
    assert not cuda_cr.shared_fits(256, 16, 9, 5, f64)
    assert not cuda_cr.shared_fits(256, 16, 9, 10, f32)
    assert not cuda_cr.shared_fits(256, 16, 9, 0, f32)
    assert not cuda_cr.shared_fits(1, 1, 70000, 1, f32)


# ----------------------------------------------------------------------
# the launchers refuse before the CUDA library is loaded
# ----------------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    def boom():
        raise AssertionError("the CUDA library was loaded")
    monkeypatch.setattr(cuda_ldlt, "_lib", boom)
    monkeypatch.setattr(cuda_cr, "_lib", boom)


def test_k4_warp_launcher_checks_before_launching(no_library):
    n, k, B = 5, 3, 7
    L, D = torch.zeros((n, n, B)), torch.ones((n, B))
    R = torch.zeros((B, n, k))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.solve_matrix_warp(L, D, R)
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_ldlt.solve_matrix_warp(L.half(), D.half(), R.half())
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.solve_matrix_warp(L, D, torch.zeros((B, n + 1, k)))
    with pytest.raises(ValueError, match="float64"):
        cuda_ldlt.solve_matrix_warp(L, D.double(), R)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ldlt.solve_matrix_warp(L, D,
                                    torch.zeros((B, k, n)).transpose(1, 2))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ldlt.solve_matrix_warp(torch.zeros((97, 97, 2)),
                                    torch.ones((97, 2)),
                                    torch.zeros((2, 97, 1)))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ldlt.solve_matrix_warp(torch.zeros((82, 82, 2)).double(),
                                    torch.ones((82, 2)).double(),
                                    torch.zeros((2, 82, 1)).double(),
                                    tile=4)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ldlt.solve_matrix_warp(L, D, torch.zeros((B, n, 0)))


def test_k7_shared_launcher_checks_before_launching(no_library):
    D, E = spd_block_tridiag(1, 8, 4, seed=0)
    f = cr_factor_plain(D, E)
    r = torch.zeros((1, 8, 4, 3), dtype=f64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cr.cr_solve_shared(f, r)
    with pytest.raises(ValueError, match="expected r"):
        cuda_cr.cr_solve_shared(f, r[0, 0])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cr.cr_solve_shared(f, r, kc=2)
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_cr.cr_solve_shared(CRKernelFactors(*(a.half() for a in f)),
                                r.half())
    D17, E17 = spd_block_tridiag(1, 8, 17, seed=0)
    f17 = CRKernelFactors(*(a.to("meta") for a in cr_factor_plain(D17,
                                                                 E17)))
    r17 = torch.zeros((1, 8, 17, 3), dtype=f64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cr.cr_solve_shared(f17, r17)
    # the route's own limits, checked where the tensors pass _check
    monkey = pytest.MonkeyPatch()
    try:
        monkey.setattr(cuda_cr, "_check", lambda *a, **k: None)
        with pytest.raises(ValueError, match="shared route"):
            cuda_cr.cr_solve_shared(f17, r17)
        with pytest.raises(ValueError, match="shared route"):
            cuda_cr.cr_solve_shared(f, r, kc=4)
        with pytest.raises(ValueError, match="shared route"):
            cuda_cr.cr_solve_shared(f, r, kc=0)
    finally:
        monkey.undo()


# ----------------------------------------------------------------------
# CPU tensors take the plain versions, with no launch counted
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [f32, f64])
@pytest.mark.parametrize("B,n,k", [(512, 64, 16), (8, 16, 16), (3, 1, 1),
                                   (2, 328, 1)])
def test_solve_ldlt_matrix_auto_takes_plain_version_on_cpu(B, n, k, dtype,
                                                          no_library):
    A = torch.from_numpy(quasi_definite(B, n, seed=n)).to(dtype)
    R = torch.from_numpy(
        np.random.default_rng(k).normal(size=(B, n, k))).to(dtype)
    L, D = ldlt(A)
    cuda_ldlt.reset_launch_counts()
    X = cuda_ldlt.solve_ldlt_matrix_auto(L, D, R)
    assert torch.equal(X, solve_ldlt_matrix(L, D, R))
    assert not any(cuda_ldlt.launches.values())
    assert not any(cuda_ldlt.route_launches.values())


@pytest.mark.parametrize("dtype", [f32, f64])
@pytest.mark.parametrize("B,N,b,k", [(1, 37, 8, 9), (3, 16, 4, 1),
                                     (1, 1, 2, 2)])
def test_cr_solve_auto_takes_plain_version_on_cpu(B, N, b, k, dtype,
                                                  no_library):
    D, E = spd_block_tridiag(B, N, b, seed=N)
    f = cr_factor_plain(D.to(dtype), E.to(dtype))
    r = torch.from_numpy(
        np.random.default_rng(k).normal(size=(B, N, b, k))).to(dtype)
    cuda_cr.reset_launch_counts()
    assert torch.equal(cuda_cr.cr_solve_auto(f, r), cr_solve_plain(f, r))
    assert not any(cuda_cr.launches.values())
    assert not any(cuda_cr.route_launches.values())


def test_reset_clears_the_k4_and_k7_route_counts():
    for counts in (cuda_ldlt.route_launches, cuda_cr.route_launches):
        for key in counts:
            counts[key] = 3
    cuda_ldlt.reset_launch_counts()
    cuda_cr.reset_launch_counts()
    assert {"solve_ldlt_matrix thread", "solve_ldlt_matrix warp"} <= \
        set(cuda_ldlt.route_launches)
    assert {"cr_solve block", "cr_solve shared"} <= \
        set(cuda_cr.route_launches)
    assert not any(cuda_ldlt.route_launches.values())
    assert not any(cuda_cr.route_launches.values())


# ----------------------------------------------------------------------
# K4's warp route, its data flow replayed on the plain arithmetic
# ----------------------------------------------------------------------

def tri_row(s):
    """Row of entry s of a strict lower triangle stored row by row
    (``csrc/ldlt.cu``, tri_row)."""
    i = int((1.0 + np.sqrt(np.float32(8.0 * s + 1.0))) * 0.5)
    while i * (i - 1) // 2 > s:
        i -= 1
    while i * (i + 1) // 2 <= s:
        i += 1
    return i


def k4_warp_replay(L, D, R, tile, groups):
    """K4's warp route replayed: per block a flat tile of shared memory
    (NaN where nothing was staged), the factor staged once by stage_factor's
    slot map, then the right-hand sides chunk by chunk at the odd row
    stride; segment (m, q) holds matrix m's columns q KC .. q KC + KC - 1,
    lane l rows l, l + SEG, ...: the forward sweep by row in increasing j
    with x_j taken from its owner lane, the division by D, the backward
    sweep column by column from the last; X back through the tile."""
    B, n, k = R.shape
    seg, KC = cuda_ldlt._segment(n), cuda_ldlt.K4_WARP_COLS
    rows = -(-n // seg)
    CH = groups * KC
    S, SR = n + 1, CH | 1
    per = n * S + n + n * SR
    L_t = L.permute(1, 2, 0).reshape(-1)
    D_t = D.t().reshape(-1)
    Rf, X = R.reshape(-1), torch.full((B * n * k,), float("nan"),
                                      dtype=R.dtype)
    tri = [(tri_row(s), s - tri_row(s) * (tri_row(s) - 1) // 2)
           for s in range(n * (n - 1) // 2)]
    lane_row = torch.arange(rows)[:, None] * seg + torch.arange(seg)
    for b0 in range(0, B, tile):
        nb = min(tile, B - b0)
        buf = torch.full((tile * per,), float("nan"), dtype=R.dtype)
        for g in range(nb):
            for i, j in tri:
                buf[g * per + i * S + j] = L_t[(i * n + j) * B + b0 + g]
            for i in range(n):
                buf[g * per + n * S + i] = D_t[i * B + b0 + g]
        for c0 in range(0, k, CH):
            kc = min(CH, k - c0)
            for e in range(nb * n * kc):
                mm, rem = divmod(e, n * kc)
                row, c = divmod(rem, kc)
                buf[mm * per + n * S + n + row * SR + c] = \
                    Rf[(b0 + mm) * n * k + row * k + c0 + c]
            for m in range(nb):
                P = buf[m * per:(m + 1) * per]
                for q in range(groups):
                    cols = q * KC + torch.arange(KC)
                    live = (lane_row < n)[..., None] & (cols < kc)
                    idx = n * S + n + lane_row[..., None] * SR + cols
                    v = torch.where(live, P[idx.clamp(max=per - 1)],
                                    torch.zeros((), dtype=R.dtype))
                    for j in range(n):
                        y = v[j // seg, j % seg]       # the owner's x_j
                        below = (lane_row > j) & (lane_row < n)
                        lij = P[(lane_row * S + j).clamp(max=per - 1)]
                        v = torch.where(below[..., None],
                                        v - lij[..., None] * y, v)
                    dv = P[(n * S + lane_row).clamp(max=per - 1)]
                    v = torch.where((lane_row < n)[..., None],
                                    v / dv[..., None], v)
                    for j in range(n - 1, 0, -1):
                        y = v[j // seg, j % seg]
                        above = lane_row < j
                        lji = P[(j * S + lane_row).clamp(max=per - 1)]
                        v = torch.where(above[..., None],
                                        v - lji[..., None] * y, v)
                    P[idx[live]] = v[live]
            for e in range(nb * n * kc):
                mm, rem = divmod(e, n * kc)
                row, c = divmod(rem, kc)
                X[(b0 + mm) * n * k + row * k + c0 + c] = \
                    buf[mm * per + n * S + n + row * SR + c]
    return X.reshape(B, n, k)


@pytest.mark.parametrize("B,n,k,tile,groups", [
    (3, 13, 5, 4, 2),     # one chunk, the second group half full
    (5, 13, 5, 4, 1),     # two chunks against one staged factor
    (2, 37, 9, 4, 2),     # a warp, two rows a lane; k > one chunk
    (9, 8, 3, 8, 1),      # a batch that fills no tile
    (2, 1, 1, 4, 1),      # n = 1
    (1, 33, 4, 2, 1),     # past one warp's rows by one
])
def test_k4_warp_data_flow_gives_the_plain_solve(B, n, k, tile, groups):
    K = torch.from_numpy(quasi_definite(B, n, seed=n + k))
    R = torch.from_numpy(np.random.default_rng(k).normal(size=(B, n, k)))
    L, D = ldlt(K)
    X = k4_warp_replay(L, D, R, tile, groups)
    X0 = solve_ldlt_matrix(L, D, R)
    np.testing.assert_allclose(X.numpy(), X0.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_k4_warp_replay_matches_reference_kernel():
    # n = 13, k = 5, B = 3: the reference's multi-rhs Pallas kernel in
    # interpret mode, on the same factors
    B, n, k = 3, 13, 5
    K = quasi_definite(B, n, seed=21)
    R = np.random.default_rng(22).normal(size=(B, n, k))
    L, D = ldlt(torch.from_numpy(K))
    shape = cuda_ldlt.k4_warp_shape(n, k, f64)
    X = k4_warp_replay(L, D, torch.from_numpy(R), *shape)
    ref = batched_solve_ldlt_matrix_pallas(jnp.asarray(L.numpy()),
                                           jnp.asarray(D.numpy()),
                                           jnp.asarray(R))
    np.testing.assert_allclose(X.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", K, X.numpy()), R,
                               rtol=1e-9, atol=1e-9)


# ----------------------------------------------------------------------
# K7's shared route, its data flow replayed on the plain arithmetic
# ----------------------------------------------------------------------

def k7_shared_replay(f, r, kc):
    """K7's shared route replayed: column group by column group (one
    thread block each), the group's working right-hand sides W overwritten
    by x in place, the scratch G indexed by pivot rank within the level
    and poisoned (NaN) before each level's first phase, the root through
    G; each product in cr_solve_kernel's order (ops/cr.py:_mm)."""
    N, b, k = r.shape[-3:]
    nan = float("nan")
    x = torch.full_like(r, nan)
    for c0 in range(0, k, kc):
        w = min(kc, k - c0)
        W = r[..., c0:c0 + w].clone()
        G = torch.full(r.shape[:-3] + ((N + 1) // 2, b, w), nan,
                       dtype=r.dtype)
        for s in levels(N):
            odd = torch.arange(s, N, 2 * s)
            rank = torch.arange(len(odd))
            G.fill_(nan)
            G[..., rank, :, :] = _mm(f.Pinv[..., odd, :, :],
                                     W[..., odd, :, :])
            even = torch.arange(0, N, 2 * s)
            m = torch.arange(len(even))
            v = W[..., even, :, :].clone()
            hr, hl = even + s < N, even > 0
            v[..., hr, :, :] = v[..., hr, :, :] - _mm(
                _t(f.Eb[..., even[hr] + s, :, :]), G[..., m[hr], :, :])
            v[..., hl, :, :] = v[..., hl, :, :] - _mm(
                f.Ea[..., even[hl] - s, :, :], G[..., m[hl] - 1, :, :])
            W[..., even, :, :] = v
        G.fill_(nan)
        G[..., 0, :, :] = _mm(f.Pinv[..., 0, :, :], W[..., 0, :, :])
        W[..., 0, :, :] = G[..., 0, :, :]
        for s in reversed(levels(N)):
            odd = torch.arange(s, N, 2 * s)
            rank = torch.arange(len(odd))
            G.fill_(nan)
            v = W[..., odd, :, :] - _mm(f.Eb[..., odd, :, :],
                                        W[..., odd - s, :, :])
            hr = odd + s < N
            v[..., hr, :, :] = v[..., hr, :, :] - _mm(
                _t(f.Ea[..., odd[hr], :, :]), W[..., odd[hr] + s, :, :])
            G[..., rank, :, :] = v
            W[..., odd, :, :] = _mm(f.Pinv[..., odd, :, :],
                                    G[..., rank, :, :])
        x[..., c0:c0 + w] = W
    return x


@pytest.mark.parametrize("N", [1, 2, 37, 64])
@pytest.mark.parametrize("b", [3, 8])
@pytest.mark.parametrize("k,kc", [(1, 1), (5, 2), (5, 5)])
def test_k7_shared_data_flow_gives_the_plain_solve(N, b, k, kc):
    D, E = spd_block_tridiag(2, N, b, seed=N + b + k)
    f = cr_factor_plain(D, E)
    r = torch.from_numpy(
        np.random.default_rng(N * k).normal(size=(2, N, b, k)))
    x = k7_shared_replay(f, r, kc)
    np.testing.assert_allclose(x.numpy(), cr_solve_plain(f, r).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_k7_shared_replay_matches_reference_kernel():
    # N = 37, b = 3: the reference's solve kernel in interpret mode on its
    # own factors of the same system
    N, b, k = 37, 3, 4
    rng = np.random.default_rng(37)
    M = rng.normal(size=(N, b, b))
    D = np.einsum("nij,nkj->nik", M, M) / b + 3.0 * np.eye(b)
    E = rng.normal(size=(N - 1, b, b)) * 0.3
    r = rng.normal(size=(N, b, k))
    f = cr_factor_plain(torch.from_numpy(D), torch.from_numpy(E))
    x = k7_shared_replay(f, torch.from_numpy(r), 3)
    ref = cr_solve_pallas(cr_factor_pallas(jnp.asarray(D), jnp.asarray(E)),
                          jnp.asarray(r))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
