"""The second routes of K3 (a warp per matrix over a staged tile) in
ipmzoo_tpu_torch/ops/cuda_ldlt.py and of K6 (a thread-block cluster per
instance) in ipmzoo_tpu_torch/ops/cuda_cr.py, on the CPU: the route rules
as pure functions pinned at the shapes the port's paths give the kernels,
the shared-memory byte counts and caps, the launchers' refusals before
the CUDA library is loaded, the wrappers' plain versions on CPU tensors,
the cluster route's ownership map (and its data flow replayed on the
plain arithmetic), and the plain solve against the reference's Pallas
kernel (interpret mode) at the Schur and nd shapes in float64.

Tolerances: rtol 1e-12 for the plain solve against the reference (the
same sweeps, summation order aside, as in test_torch_ldlt.py); the
replayed cluster data flow runs the plain version's own operations in
another grouping, so it must agree to rtol 1e-12 as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipmzoo_tpu.ops.pallas_ldlt import LANE, _batched_solve_t
from ipmzoo_tpu_torch.ops import cuda_cr, cuda_ldlt
from ipmzoo_tpu_torch.ops.cr import (_mm, _t, chol_inv_plain,
                                     cr_factor_plain)
from ipmzoo_tpu_torch.ops.ldlt import ldlt, solve_ldlt

f32, f64 = torch.float32, torch.float64


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

#: (n, B, dtype) -> K3 route at every shape the paths give K3: the
#: compact slice's batches and its float64 escalation, the Schur slice's
#: H and S blocks (f64 and plain f32), the nd slice's levels (one
#: instance and the batch of 8) and its generic top (order 328), and the
#: route's cap
K3_PATH_ROUTES = [
    ((24, 10240, f32), "warp"), ((24, 2560, f32), "warp"),
    ((24, 320, f32), "warp"), ((24, 32, f64), "warp"),
    ((64, 512, f64), "warp"), ((64, 512, f32), "warp"),
    ((16, 8, f64), "warp"), ((16, 8, f32), "warp"),
    ((64, 105, f32), "warp"), ((16, 28, f32), "warp"),
    ((16, 16, f32), "warp"), ((64, 840, f32), "warp"),
    ((16, 224, f32), "warp"), ((16, 128, f32), "warp"),
    ((328, 1, f32), "thread"), ((328, 1, f64), "thread"),
    ((1, 5, f32), "thread"), ((1, 5, f64), "thread"), ((2, 5, f32), "warp"),
    ((83, 9, f64), "warp"), ((84, 9, f64), "thread"),
    ((83, 9, f32), "warp"), ((84, 9, f32), "thread"),
]

#: (N, b, B, dtype) -> K6 route: the arrow slice's one instance and batch
#: of 32 in both types (a cluster per instance for a few instances, the
#: block route for many), chip_smoke's odd shape and its small chains
#: (the block route: few blocks a level), each row of the measured rule
#: at its edges, and what was measured nowhere (an order over the
#: segments or between the measured ones, a longer chain)
K6_PATH_ROUTES = [
    ((256, 16, 1, f32), "cluster"), ((256, 16, 32, f32), "block"),
    ((256, 16, 1, f64), "cluster"), ((256, 16, 32, f64), "block"),
    ((256, 16, 24, f32), "cluster"), ((256, 16, 25, f32), "block"),
    ((256, 16, 16, f64), "cluster"), ((256, 16, 17, f64), "block"),
    ((37, 8, 1, f32), "block"), ((37, 8, 1, f64), "block"),
    ((1, 16, 1, f32), "block"), ((2, 8, 1, f64), "block"),
    ((4, 16, 1, f32), "block"), ((8, 8, 4, f64), "block"),
    ((256, 8, 32, f32), "cluster"), ((256, 8, 33, f32), "block"),
    ((128, 8, 1, f32), "block"), ((128, 8, 24, f64), "cluster"),
    ((128, 8, 25, f64), "block"), ((127, 8, 1, f64), "block"),
    ((63, 16, 1, f32), "block"), ((64, 16, 24, f32), "cluster"),
    ((128, 16, 8, f32), "cluster"), ((128, 16, 9, f32), "block"),
    ((36, 16, 1, f64), "block"), ((37, 16, 24, f64), "cluster"),
    ((64, 16, 8, f64), "cluster"), ((64, 16, 9, f64), "block"),
    ((128, 16, 24, f64), "cluster"), ((256, 4, 1, f32), "block"),
    ((256, 12, 1, f32), "block"), ((512, 16, 1, f32), "block"),
    ((256, 17, 1, f32), "block"), ((4096, 16, 1, f64), "block"),
]


@pytest.mark.parametrize("shape,route", K3_PATH_ROUTES,
                         ids=[str(s) for s, _ in K3_PATH_ROUTES])
def test_k3_route_at_path_shapes(shape, route):
    assert cuda_ldlt.k3_route(*shape) == route


@pytest.mark.parametrize("shape,route", K6_PATH_ROUTES,
                         ids=[str(s) for s, _ in K6_PATH_ROUTES])
def test_k6_route_at_path_shapes(shape, route):
    assert cuda_cr.k6_route(*shape) == route


#: (N, b, B, dtype) -> the cluster route's cluster size: 16 for a few
#: instances, else the smallest that fits (float64 at N=256: 16 alone)
K6_CLUSTER_SIZES = [
    ((256, 16, 1, f32), 16), ((256, 16, 4, f32), 16), ((256, 16, 5, f32), 8),
    ((256, 16, 24, f32), 8), ((256, 16, 1, f64), 16), ((256, 16, 16, f64), 16),
    ((37, 8, 8, f64), 8), ((4096, 16, 1, f64), None),
]


@pytest.mark.parametrize("shape,C", K6_CLUSTER_SIZES,
                         ids=[str(s) for s, _ in K6_CLUSTER_SIZES])
def test_k6_cluster_size_at_path_shapes(shape, C):
    assert cuda_cr.k6_cluster(*shape) == C


@pytest.mark.parametrize("dtype", [f32, f64])
def test_routes_never_exceed_what_a_route_holds(dtype):
    for n in list(range(1, 100)) + [168, 328]:
        for B in (1, 8, 512, 10240):
            r = cuda_ldlt.k3_route(n, B, dtype)
            assert r in ("warp", "thread")
            assert (r == "warp") == (n >= 2 and
                                     cuda_ldlt.solve_warp_fits(n, dtype))
    for N in (1, 2, 3, 37, 256, 1000, 4096):
        for b in (1, 5, 8, 9, 16, 17, 32):
            for B in (1, 32):
                r = cuda_cr.k6_route(N, b, B, dtype)
                assert r in ("cluster", "block")
                if r == "cluster":
                    C = cuda_cr.k6_cluster(N, b, B, dtype)
                    assert C in cuda_cr.CLUSTER_SIZES
                    assert cuda_cr.cluster_fits(N, b, C, dtype)
                    assert b <= cuda_cr.CLUSTER_MAX_B


# ----------------------------------------------------------------------
# shared memory and threads
# ----------------------------------------------------------------------

def test_k3_warp_bytes_and_cap():
    # a tile of 8 (f32) or 4 (f64) instances of n (n + 3) values
    assert cuda_ldlt.solve_warp_bytes(64, f64) == 4 * 64 * 67 * 8
    assert cuda_ldlt.solve_warp_bytes(24, f32) == 8 * 24 * 27 * 4
    assert cuda_ldlt.solve_warp_bytes(1, f32) == 8 * 1 * 4 * 4
    for dtype in (f32, f64):
        assert cuda_ldlt.solve_warp_fits(83, dtype)
        assert not cuda_ldlt.solve_warp_fits(84, dtype)
        assert cuda_ldlt.solve_warp_bytes(83, dtype) <= 232448 < \
            cuda_ldlt.solve_warp_bytes(84, dtype)
    assert cuda_ldlt.K3_WARP_MAX_ORDER >= 83


def test_k6_cluster_bytes_threads_and_cap():
    # rank 0 of 8 holds 35 slots at N=256: 16 + 8 + 4 + 2 + 1 + 1 + 1 + 1
    # pivots and the root; three 16 x 17 working blocks a slot and three
    # scratch blocks a segment, after the slot table (16 x 34 int32) and
    # the slots' positions
    assert cuda_cr.slot_base(256, 0, 8) == [0, 16, 24, 28, 30, 31, 32, 33,
                                            34, 35]
    assert cuda_cr.cluster_bytes(256, 16, 8, f32) == \
        2320 + (35 + 16) * 3 * 272 * 4
    assert cuda_cr.cluster_bytes(256, 16, 8, f64) == \
        2320 + (35 + 16) * 3 * 272 * 8
    assert cuda_cr.cluster_bytes(256, 16, 16, f64) == \
        2256 + (20 + 12) * 3 * 272 * 8
    assert cuda_cr.cluster_fits(256, 16, 8, f32)
    assert not cuda_cr.cluster_fits(256, 16, 8, f64)
    assert cuda_cr.cluster_fits(256, 16, 16, f64)
    # N=512 in float64 holds 36 slots and 16 segments a rank even at 16
    # ranks: too many
    assert cuda_cr.cluster_bytes(512, 16, 16, f64) == \
        2320 + (36 + 16) * 3 * 272 * 8
    assert not cuda_cr.cluster_fits(512, 16, 16, f64)
    assert cuda_cr.cluster_fits(512, 16, 16, f32)
    assert not cuda_cr.cluster_fits(256, 17, 16, f32)
    assert not cuda_cr.cluster_fits(256, 16, 4, f32)
    # a segment of 16 lanes for each of rank 0's level-0 pivots or evens,
    # at most 256 threads
    assert cuda_cr.cluster_threads(256, 16, 8) == 256
    assert cuda_cr.cluster_threads(256, 16, 16) == 192
    assert cuda_cr.cluster_threads(37, 8, 16) == 6 * 8
    assert cuda_cr.cluster_threads(1, 16, 8) == 16


# ----------------------------------------------------------------------
# the cluster route's ownership map
# ----------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 2, 3, 5, 8, 37, 100, 255, 256, 257])
@pytest.mark.parametrize("C", [8, 16])
def test_every_position_has_one_owner_and_slot(N, C):
    seen = {}
    for r in range(C):
        slots = cuda_cr.cluster_slots(N, r, C)
        assert len(slots) == cuda_cr.slot_base(N, r, C)[-1]
        assert len(slots) <= cuda_cr.slot_base(N, 0, C)[-1]
        for k, p in enumerate(slots):
            assert p not in seen
            seen[p] = (r, k)
            assert cuda_cr.cluster_owner(p, N, C) == (r, k)
    assert sorted(seen) == list(range(N))


@pytest.mark.parametrize("N", [2, 3, 37, 256, 257])
@pytest.mark.parametrize("C", [8, 16])
def test_each_level_eliminates_each_live_pivot_once(N, C):
    L = cuda_cr.cr_levels(N)
    done = set()
    for l in range(L):
        s = 1 << l
        live = set(range(0, N, s))
        pivots = set(range(s, N, 2 * s))
        evens = live - pivots
        got, upd = [], []
        for r in range(C):
            base = cuda_cr.slot_base(N, r, C)
            slots = cuda_cr.cluster_slots(N, r, C)
            got += slots[base[l]:base[l + 1]]
            upd += slots[base[l + 1]:]
        # the pivots of the level, each on exactly one rank, and every
        # other live position updated by exactly one rank
        assert sorted(got) == sorted(pivots) and len(got) == len(pivots)
        assert sorted(upd) == sorted(evens) and len(upd) == len(evens)
        assert not pivots & done
        done |= pivots
        # what a pivot reads (p - s) and an even position reads (q + s,
        # q - s) is live at this level
        for p in pivots:
            assert p - s in live
        for q in evens:
            for nb in (q - s, q + s):
                if 0 <= nb < N:
                    assert nb in pivots
    assert done == set(range(1, N))


def cluster_replay(D, E, C):
    """K6's cluster route replayed on the plain arithmetic: per rank a
    dict of working blocks by slot, filled and read only through
    ``cluster_owner``, phases in the kernel's order; returns the
    factors."""
    N, b = D.shape[-3], D.shape[-1]
    store = [dict() for _ in range(C)]

    def blk(p, which):
        r, k = cuda_cr.cluster_owner(p, N, C)
        return store[r].setdefault((k, which), None)

    def put(p, which, v):
        r, k = cuda_cr.cluster_owner(p, N, C)
        store[r][(k, which)] = v

    Pinv, Eb, Ea = (torch.zeros_like(D) for _ in range(3))
    for p in range(N):
        put(p, "D", D[..., p, :, :].clone())
        put(p, "E", E[..., p, :, :].clone() if p < N - 1
            else torch.zeros_like(D[..., 0, :, :]))
    for l in range(cuda_cr.cr_levels(N)):
        s = 1 << l
        for r in range(C):
            base = cuda_cr.slot_base(N, r, C)
            for p in cuda_cr.cluster_slots(N, r, C)[base[l]:base[l + 1]]:
                Pi = chol_inv_plain(blk(p, "D"))
                eb, ea = blk(p - s, "E"), blk(p, "E")
                Pinv[..., p, :, :], Eb[..., p, :, :] = Pi, eb
                Ea[..., p, :, :] = ea
                put(p, "X", _mm(Pi, eb))
                put(p, "D", _mm(ea, Pi))
        new = {}
        for r in range(C):
            base = cuda_cr.slot_base(N, r, C)
            for q in cuda_cr.cluster_slots(N, r, C)[base[l + 1]:]:
                de, en = blk(q, "D"), torch.zeros_like(blk(q, "D"))
                if q + s < N:
                    t = blk(q + s, "X")
                    de = de - _mm(_t(blk(q, "E")), t)
                    if q + 2 * s < N:
                        en = -_mm(blk(q + s, "E"), t)
                if q > 0:
                    de = de - _mm(blk(q - s, "D"), _t(blk(q - s, "E")))
                new[q] = (de, en)
        for q, (de, en) in new.items():
            put(q, "D", de)
            put(q, "E", en)
    Pinv[..., 0, :, :] = chol_inv_plain(blk(0, "D"))
    return Pinv, Eb, Ea


@pytest.mark.parametrize("N,b,C", [(37, 8, 8), (37, 8, 16), (64, 4, 8),
                                   (1, 3, 8), (2, 3, 16)])
def test_cluster_data_flow_gives_the_plain_factors(N, b, C):
    D, E = spd_block_tridiag(2, N, b, seed=N + b + C)
    f0 = cr_factor_plain(D, E)
    for got, want in zip(cluster_replay(D, E, C), f0):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-14)


# ----------------------------------------------------------------------
# the launchers refuse before the CUDA library is loaded
# ----------------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    def boom():
        raise AssertionError("the CUDA library was loaded")
    monkeypatch.setattr(cuda_ldlt, "_lib", boom)
    monkeypatch.setattr(cuda_cr, "_lib", boom)


def test_k3_warp_launcher_checks_before_launching(no_library):
    n, B = 5, 7
    L, D, b = torch.zeros((n, n, B)), torch.ones((n, B)), torch.zeros((n, B))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ldlt.solve_soa_warp(L, D, b)
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_ldlt.solve_soa_warp(L.half(), D.half(), b.half())
    with pytest.raises(ValueError, match="shape"):
        cuda_ldlt.solve_soa_warp(torch.zeros((n, n, B + 1)), D, b)
    with pytest.raises(ValueError, match="float64"):
        cuda_ldlt.solve_soa_warp(L, D.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ldlt.solve_soa_warp(L, D, torch.zeros((B, n)).t())
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ldlt.solve_soa_warp(torch.zeros((84, 84, 2)),
                                 torch.ones((84, 2)), torch.zeros((84, 2)))


def test_k6_cluster_launcher_checks_before_launching(no_library):
    D, E = spd_block_tridiag(1, 8, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cr.cr_factor_cluster(D, E)
    with pytest.raises(ValueError, match="expected D"):
        cuda_cr.cr_factor_cluster(D[0, 0, 0], E)
    D17, E17 = spd_block_tridiag(1, 8, 17, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cr.cr_factor_cluster(D17, E17)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cr.cr_factor_cluster(D, E, cluster=4)
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_cr.cr_factor_cluster(D.half(), E.half())
    with pytest.raises(ValueError, match="cluster route"):
        cuda_cr.cluster_occupancy(256, 17, 8, f32)
    with pytest.raises(ValueError, match="cluster route"):
        cuda_cr.cluster_occupancy(4096, 16, 16, f64)


# ----------------------------------------------------------------------
# CPU tensors take the plain versions, with no launch counted
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [f32, f64])
@pytest.mark.parametrize("B,n", [(512, 64), (8, 16), (20, 24), (3, 1)])
def test_solve_ldlt_auto_takes_plain_version_on_cpu(B, n, dtype,
                                                    no_library):
    A = torch.from_numpy(quasi_definite(B, n, seed=n)).to(dtype)
    b = torch.from_numpy(np.random.default_rng(n).normal(size=(B, n))) \
        .to(dtype)
    L, D = ldlt(A)
    cuda_ldlt.reset_launch_counts()
    x = cuda_ldlt.solve_ldlt_auto(L, D, b)
    assert torch.equal(x, solve_ldlt(L, D, b))
    assert not any(cuda_ldlt.launches.values())
    assert not any(cuda_ldlt.route_launches.values())


@pytest.mark.parametrize("dtype", [f32, f64])
@pytest.mark.parametrize("B,N,b", [(1, 37, 8), (3, 16, 4), (1, 1, 2)])
def test_cr_factor_auto_takes_plain_version_on_cpu(B, N, b, dtype,
                                                   no_library):
    D, E = spd_block_tridiag(B, N, b, seed=N)
    D, E = D.to(dtype), E.to(dtype)
    cuda_cr.reset_launch_counts()
    f = cuda_cr.cr_factor_auto(D, E)
    for got, want in zip(f, cr_factor_plain(D, E)):
        assert torch.equal(got, want)
    assert not any(cuda_cr.launches.values())
    assert not any(cuda_cr.route_launches.values())


def test_reset_clears_the_k6_route_counts():
    for key in cuda_cr.route_launches:
        cuda_cr.route_launches[key] = 3
    cuda_cr.reset_launch_counts()
    assert set(cuda_cr.route_launches) == {"cr_factor block",
                                           "cr_factor cluster",
                                           "cr_solve block",
                                           "cr_solve shared"}
    assert not any(cuda_cr.route_launches.values())


# ----------------------------------------------------------------------
# the plain solve against the reference at the Schur and nd shapes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,B", [(64, 512), (16, 8), (64, 105), (16, 28),
                                 (16, 16)])
def test_plain_k3_matches_reference_solve_kernel(n, B):
    K = quasi_definite(B, n, seed=n + B)
    b = np.random.default_rng(B).normal(size=(B, n))
    L, D = ldlt(torch.from_numpy(K))
    x = solve_ldlt(L, D, torch.from_numpy(b))
    # the reference kernel on the same SoA layout, padded as its wrapper
    # pads: order to a multiple of 8, batch to lanes, D with ones
    npad, Bpad = -(-n // 8) * 8, -(-B // LANE) * LANE
    L_t = np.zeros((npad, npad, Bpad))
    L_t[:n, :n, :B] = L.permute(1, 2, 0).numpy()
    D_t = np.ones((npad, Bpad))
    D_t[:n, :B] = D.t().numpy()
    b_t = np.zeros((npad, Bpad))
    b_t[:n, :B] = b.T
    x_ref = np.asarray(_batched_solve_t(jnp.asarray(L_t), jnp.asarray(D_t),
                                        jnp.asarray(b_t), n))[:n, :B].T
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", K, x.numpy()), b,
                               rtol=1e-9, atol=1e-9)


def test_ptxas_shared_reads_the_build_log(tmp_path):
    from ipmzoo_tpu_torch.ops import _build
    lib = tmp_path / "k-0.so"
    lib.with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_Z1kIfLi2EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 2176 bytes "
        "smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1kIdLi2EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Used 64 registers, used 0 barriers\n")
    assert _build.ptxas_shared(lib) == {"_Z1kIfLi2EEvv": 2176,
                                        "_Z1kIdLi2EEvv": 0}


# ----------------------------------------------------------------------
# chip_smoke.py's K3 bounds and its one-trace device timing, on the CPU
# ----------------------------------------------------------------------

def _chip_smoke():
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("n,B,k,dtype", [(64, 512, 16, f64),
                                         (24, 10240, 1, f32),
                                         (16, 8, 16, f64), (1, 5, 1, f32)])
def test_solve_bounds_count_the_strict_lower_triangle(n, B, k, dtype):
    # K3 reads L's strict lower triangle, D and b and writes x; K4 the
    # same with k columns: the unit diagonal and the upper zeros are
    # never read, so they are not in the bytes the solve must move
    cs = _chip_smoke()
    size = torch.finfo(dtype).bits // 8
    tri = n * (n - 1) // 2
    bounds = cs.ldlt_bounds(B, n, k, dtype)
    for key, values in (("K3", tri + 3 * n), ("K4", tri + n + 2 * n * k)):
        ms, by = bounds[key]
        assert by == "bytes"
        assert ms == pytest.approx(
            1e3 * B * values * size / cs.HBM_BYTES_PER_S, rel=1e-12)
    # the Schur slice's H blocks: about 0.0027 ms
    if (n, B) == (64, 512):
        assert bounds["K3"][0] == pytest.approx(0.0027, abs=5e-5)


def _fake_trace(monkeypatch, cs, traces):
    """Replace the profiler: each call of trace_kernels runs the body
    and offers the traces in turn until one is kept."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "GROUP_GAP_S", 0.0)
    offered = []

    def trace_kernels(run, kept):
        run()
        for t in traces:
            offered.append(t)
            if kept(t):
                return t
        raise AssertionError("no trace kept")
    monkeypatch.setattr(cs, "trace_kernels", trace_kernels)
    return offered


def test_launch_ms_splits_one_trace_at_the_idle_gaps(monkeypatch):
    cs = _chip_smoke()
    th, wp = "ldlt_solve_kernel<float>", "ldlt_solve_kernel_warp<float, 8, 1>"
    gap = cs.GROUP_SPLIT_US + 1.0
    whole = [(th, 0.0, 1.0), (wp, 20.0, 2.0), (th, 40.0, 1.2),
             (wp, 60.0, 2.4), (th, 62.4 + gap, 3.0), (wp, 80.0 + gap, 4.0)]
    lost_group = whole[:4]
    lost_kernel = whole[:4] + [whole[4]]
    offered = _fake_trace(monkeypatch, cs, [lost_group, lost_kernel, whole])
    calls = []
    k = {r: cs.K3_KERNELS[r] for r in ("thread", "warp")}
    got = cs.launch_ms([(lambda: calls.append(0), k),
                        (lambda: calls.append(1), k)], 2)
    # a warm-up call of each group, then the groups' calls in turn
    assert calls == [0, 1, 0, 0, 1, 1]
    # a trace that lost a group or every launch of a kernel is retaken
    assert offered == [lost_group, lost_kernel, whole]
    assert got[0] == pytest.approx({"thread": 0.0011, "warp": 0.0022})
    assert got[1] == pytest.approx({"thread": 0.003, "warp": 0.004})


def test_device_ms_divides_by_the_calls_the_trace_holds(monkeypatch):
    cs = _chip_smoke()
    # 19 of 20 launches of the main kernel kept, and a memset beside them
    trace = [("k<float>", 10.0 * i, 2.0) for i in range(19)] + \
        [("Memset (Device)", 500.0, 0.5)]
    _fake_trace(monkeypatch, cs, [[], trace])
    assert cs.device_ms(lambda: None, 20) == pytest.approx(38.5 / 19 / 1e3)
