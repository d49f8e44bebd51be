"""What the multi-process tests of the port run in each rank, and the
numpy data both sides share.

The functions here run in processes that ``ipmzoo_tpu_torch.parallel.
distributed.spawn`` starts and joins in one gloo group on the CPU; they
import nothing of JAX, so a rank starts in the time torch takes to
import.  Each returns plain Python and numpy values, which the tests
hold against the JAX package in the pytest process.
"""

import numpy as np
import torch

#: a hung rank fails its test after this many seconds
DEADLINE = 240.0


def run(fn, world, *args):
    """``fn(*args)`` in ``world`` gloo processes on the CPU; each rank's
    result in rank order."""
    from ipmzoo_tpu_torch.parallel.distributed import spawn
    return spawn(fn, world, *args, cpu=True, timeout=DEADLINE)


def cpus(world):
    return [torch.device("cpu")] * world


# -- data -------------------------------------------------------------------

def random_batch(batch, n, seed=0):
    """tests/test_parallel.py's box-constrained batch, as numpy leaves of
    a QPData."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n))
    return dict(
        Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
        c=rng.normal(size=(batch, n)),
        A_ineq=np.zeros((batch, 0, n)), l_A_ineq=np.zeros((batch, 0)),
        u_A_ineq=np.zeros((batch, 0)), A_eq=np.zeros((batch, 0, n)),
        b_eq=np.zeros((batch, 0)),
        l_x=-np.abs(rng.normal(size=(batch, n))) - 1,
        u_x=np.abs(rng.normal(size=(batch, n))) + 1)


def make_coupled(blocks, n, m_c, seed=0):
    """tests/test_schur.py's coupled QP, as numpy leaves of a
    BlockQPData."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(blocks, n, n))
    return dict(Q=np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
                c=rng.normal(size=(blocks, n)),
                F=rng.normal(size=(blocks, m_c, n)) / blocks,
                l_x=np.full((blocks, n), -3.0), u_x=np.full((blocks, n), 3.0),
                g=rng.normal(size=(m_c,)) * 0.1)


def make_illconditioned(blocks, n, m_c, seed=0, cond=1e8):
    """tests/test_schur.py's blocks of condition number ``cond``."""
    rng = np.random.default_rng(seed)
    Qs = np.empty((blocks, n, n))
    for b in range(blocks):
        V, _ = np.linalg.qr(rng.normal(size=(n, n)))
        Qs[b] = (V * np.logspace(0.0, -np.log10(cond), n)) @ V.T
    return dict(Q=Qs, c=rng.normal(size=(blocks, n)),
                F=rng.normal(size=(blocks, m_c, n)) / blocks,
                l_x=np.full((blocks, n), -3.0), u_x=np.full((blocks, n), 3.0),
                g=rng.normal(size=(m_c,)) * 0.1)


#: the sharded Schur cases of tests/test_schur.py at 4 ranks: name ->
#: (data, solver options, dtype)
SCHUR_CASES = {
    "equals_local": (make_coupled(8, 4, 2, seed=4), {}, "float64"),
    "scipy": (make_coupled(8, 3, 2, seed=5), {}, "float64"),
    "cond_1e8": (make_illconditioned(8, 4, 2, seed=9), {"tol": 1e-7},
                 "float64"),
    "two_float": (make_coupled(8, 4, 2, seed=6),
                  {"tol": 1e-8, "max_iter": 40, "two_float": True,
                   "refine": 2}, "float32"),
    "pallas": (make_coupled(8, 4, 2, seed=4), {"block_kernel": "pallas"},
               "float64"),
}


def dense_reference(raw):
    """The coupled QP as one dense QP, solved by scipy."""
    from scipy import optimize
    B, n = raw["c"].shape
    F = np.concatenate(list(raw["F"]), axis=1)

    def fun(x):
        xb = x.reshape(B, n)
        return float(0.5 * np.einsum("bi,bij,bj->", xb, raw["Q"], xb) +
                     raw["c"].ravel() @ x)

    def jac(x):
        return np.einsum("bij,bj->bi", raw["Q"],
                         x.reshape(B, n)).ravel() + raw["c"].ravel()

    res = optimize.minimize(
        fun, np.zeros(B * n), jac=jac, method="SLSQP",
        constraints=[optimize.LinearConstraint(F, raw["g"], raw["g"])],
        bounds=optimize.Bounds(raw["l_x"].ravel(), raw["u_x"].ravel()),
        options={"maxiter": 500, "ftol": 1e-12})
    assert res.success, res.message
    return res.x.reshape(B, n), res.fun


def _qp(raw, dtype=torch.float64):
    from ipmzoo_tpu_torch.models.data import QPData
    return QPData(**{k: torch.tensor(v, dtype=dtype) for k, v in raw.items()})


def _block_qp(raw, dtype):
    from ipmzoo_tpu_torch.parallel import BlockQPData
    return BlockQPData(**{k: torch.tensor(v, dtype=getattr(torch, dtype))
                          for k, v in raw.items()})


def _error(fn):
    """The type and message of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


# -- jobs -------------------------------------------------------------------

def two_process_psum():
    """tests/test_distributed.py's worker: this rank's slice of
    arange(8), summed over the group."""
    import torch.distributed as dist
    from ipmzoo_tpu_torch.parallel.distributed import (is_primary,
                                                       local_batch_slice)
    from ipmzoo_tpu_torch.parallel.mesh import make_mesh, psum
    mesh = make_mesh(devices=cpus(2))
    sl = local_batch_slice(8)
    local = torch.arange(8, dtype=torch.float32)[sl]
    return {"slice": (sl.start, sl.stop), "backend": dist.get_backend(),
            "total": float(psum(local.sum(), mesh)),
            "primary": is_primary()}


def parallel_world4():
    """Every case of tests/test_torch_parallel.py at 4 ranks."""
    from ipmzoo_tpu_torch import CompiledIPM, Settings, Bounds
    from ipmzoo_tpu_torch.parallel import (batch_sharding, make_mesh,
                                           replicated)
    from ipmzoo_tpu_torch.parallel import mesh as m
    from ipmzoo_tpu_torch.parallel.scaling import dp_scaling_report

    mesh = make_mesh(devices=cpus(4))
    r = mesh.rank
    out = {
        "rank": r, "shape": mesh.shape, "size": int(mesh.devices.size),
        "devices": [str(d) for d in mesh.devices.flat],
        "device": str(mesh.device), "group": mesh.group is not None,
        "specs": (batch_sharding(mesh).spec, replicated(mesh).spec),
        "psum": m.psum(torch.tensor([float(r), 1.0]), mesh).tolist(),
        "pmin": float(m.pmin(torch.tensor(10.0 - r), mesh)),
        "pmax": float(m.pmax(torch.tensor(10.0 - r), mesh)),
        "gather": m.all_gather(torch.tensor([r, 2 * r]), mesh).tolist(),
        "gather_tiled": m.all_gather(torch.tensor([r, 2 * r]), mesh,
                                     tiled=True).tolist(),
        "gather_bool": m.gather_batch(torch.tensor([r % 2 == 0]),
                                      mesh).tolist(),
        "slice": m.shard_slice(16, mesh),
        "staged": mesh.host_syncs,
        "too_many": _error(lambda: make_mesh((8,), devices=cpus(8))),
        "too_few": _error(lambda: make_mesh((2,), devices=cpus(4))),
        "uneven": _error(lambda: m.shard_batch(torch.zeros(6), mesh)),
        "two_axes": m.psum(torch.ones(1) + r, make_mesh(
            (2, 2), ("dp", "tp"), cpus(4)), "dp").tolist(),
    }

    # dp: solve_batch over the shards, gathered
    data = _qp(random_batch(16, 6, seed=1))
    solver = CompiledIPM(Settings(inequalities=Bounds.NONE), n=6,
                         device="cpu")
    sharded = m.gather_batch(solver.solve_batch(m.shard_batch(data, mesh)),
                             mesh)
    plain = solver.solve_batch(data)
    out["dp"] = {k: (getattr(sharded, k).numpy(), getattr(plain, k).numpy())
                 for k in ("x", "converged", "iterations", "objective")}

    # the scaling report's mechanics, and three sharded steps against
    # three steps of the whole batch
    data = _qp(random_batch(16, 6, seed=2))
    out["report"] = dp_scaling_report(solver, data, steps=5,
                                      devices=cpus(4))
    state = solver.init_state(data)
    s_plain, s_shard = state, m.shard_batch(state, mesh)
    local = m.shard_batch(data, mesh)
    for _ in range(3):
        s_plain = solver.step(s_plain, data)
        s_shard = solver.step(s_shard, local)
    s_shard = m.gather_batch(s_shard, mesh)
    out["steps"] = [(a.numpy(), b.numpy())
                    for a, b in zip(s_shard.vars, s_plain.vars)]
    return out


def schur_world4():
    """Every sharded Schur case at 4 ranks: the sharded result and the
    local ``solve`` of the same data, as numpy, with the launch counts
    and the refusals."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.parallel import SchurIPM, make_mesh

    mesh = make_mesh(devices=cpus(4))
    fields = ("x", "nu", "objective", "iterations", "residual", "gap",
              "converged")
    cuda_ldlt.reset_launch_counts()
    out = {}
    for name, (raw, kw, dtype) in SCHUR_CASES.items():
        n, m_c = raw["Q"].shape[-1], raw["g"].shape[-1]
        data = _block_qp(raw, dtype)
        kw = dict(kw, dtype=getattr(torch, dtype))
        sharded = SchurIPM(n, m_c, mesh=mesh, **kw)
        rs = sharded.solve_sharded(data)
        rl = SchurIPM(n, m_c, device="cpu", **kw).solve(data)
        out[name] = {f: (getattr(rs, f).numpy(), getattr(rl, f).numpy())
                     for f in fields}
        out[name]["two_float"] = sharded.two_float
    out["launches"] = dict(cuda_ldlt.launches)
    data = _block_qp(make_coupled(6, 3, 1), "float64")
    out["uneven"] = _error(lambda: SchurIPM(3, 1, mesh=mesh).solve_sharded(
        data))
    out["other_device"] = _error(lambda: SchurIPM(3, 1, mesh=mesh,
                                                  device="meta"))
    return out


def bench_sharded(batch, n, m):
    """bench_torch.py's sharded mode at a small size, its stepping timer
    at one second."""
    import bench_torch
    from ipmzoo_tpu_torch.parallel import scaling
    bench_torch.BATCH, bench_torch.N, bench_torch.M_INEQ = batch, n, m
    scaling.time_steps = lambda *a, **k: 1.0
    label, value, unit, counts = bench_torch.run_mode(
        "sharded", torch.device("cpu"))
    return label, value, unit, counts["report"]


def failing_rank():
    """Rank 1 raises; rank 0 returns."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return "ok"


# -- the tp axis --------------------------------------------------------------

def kkt(n, m, seed, scale=1.0):
    """tests/test_sharded_ldlt.py's quasi-definite KKT matrix of order
    n + m."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n, n))
    H = H @ H.T / n + scale * np.eye(n)
    S = rng.normal(size=(m, m))
    S = S @ S.T / m + np.eye(m)
    B = rng.normal(size=(m, n))
    return np.block([[H, B.T], [B, -S]])


def box_qp(n, seed=0, scale=1.0):
    """tests/test_sharded_ipm.py's box QP, as numpy leaves of one
    QPData."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return dict(Q=(M @ M.T / n + np.eye(n)) * scale, c=rng.normal(size=n),
                A_ineq=np.zeros((0, n)), l_A_ineq=np.zeros(0),
                u_A_ineq=np.zeros(0), A_eq=np.zeros((0, n)),
                b_eq=np.zeros(0), l_x=np.full(n, -2.0), u_x=np.full(n, 2.0))


def ineq_qp(n=24, m=8, seed=1):
    """tests/test_sharded_ipm.py's QP with two-sided inequalities, as
    numpy leaves of one QPData."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return dict(Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
                A_ineq=rng.normal(size=(m, n)),
                l_A_ineq=-np.abs(rng.normal(size=m)) - 1,
                u_A_ineq=np.abs(rng.normal(size=m)) + 1,
                A_eq=np.zeros((0, n)), b_eq=np.zeros(0),
                l_x=np.full(n, -5.0), u_x=np.full(n, 5.0))


#: tests/test_sharded_ldlt.py's panels of the dim-512 factor
TP_PANELS = (32, 64)
#: the batched factor's three systems (dim 128) and panel
TP_BATCH, TP_BATCH_PANEL = 3, 16


def _tp_factor(K, mesh, axis, panel):
    """The sharded factor of K (numpy) over ``axis``: the whole L
    gathered in row order, D and the panels' diagonal factors."""
    from ipmzoo_tpu_torch.ops import shard_kkt, sharded_ldlt
    from ipmzoo_tpu_torch.parallel import mesh as m
    L, Lds, D = sharded_ldlt(shard_kkt(torch.tensor(K), mesh, axis), mesh,
                             axis, panel=panel)
    L_all = m.all_gather(L, mesh, axis, tiled=L.dim() == 2)
    if L.dim() == 3:
        # (ranks, B, rows, n) -> (B, n, n)
        L_all = L_all.permute(1, 0, 2, 3).reshape(L.shape[0], -1,
                                                  L.shape[-1])
    return L_all.numpy(), D.numpy(), [t.numpy() for t in Lds]


def sharded_ldlt_world4():
    """Every case of tests/test_torch_sharded_ldlt.py at 4 ranks."""
    from ipmzoo_tpu_torch.ops import (shard_kkt, sharded_ldlt,
                                      sharded_ldlt_solve)
    from ipmzoo_tpu_torch.parallel import make_mesh
    from ipmzoo_tpu_torch.parallel import mesh as m

    mesh = make_mesh((4,), ("tp",), cpus(4))
    K0 = kkt(384, 128, seed=0)
    out = {"rank": mesh.rank,
           "factor": {p: _tp_factor(K0, mesh, "tp", p) for p in TP_PANELS}}
    K1 = kkt(384, 128, seed=1)
    b = np.random.default_rng(2).normal(size=512)
    factors = sharded_ldlt(shard_kkt(torch.tensor(K1), mesh), mesh,
                           panel=64)
    out["x"] = sharded_ldlt_solve(factors, torch.tensor(b), mesh,
                                  panel=64).numpy()
    out["rows"] = tuple(factors[0].shape)
    out["bad_n"] = _error(lambda: sharded_ldlt(torch.eye(102)[:26], mesh))
    out["bad_n_shard"] = _error(lambda: shard_kkt(torch.eye(102), mesh))
    out["bad_panel"] = _error(lambda: sharded_ldlt(
        shard_kkt(torch.eye(512), mesh), mesh, panel=48))

    # a leading batch axis of three systems against each alone
    Ks = np.stack([kkt(96, 32, seed=10 + s) for s in range(TP_BATCH)])
    bs = np.random.default_rng(11).normal(size=(TP_BATCH, 128))
    fb = sharded_ldlt(shard_kkt(torch.tensor(Ks), mesh), mesh,
                      panel=TP_BATCH_PANEL)
    xb = sharded_ldlt_solve(fb, torch.tensor(bs), mesh)
    singles = []
    for s in range(TP_BATCH):
        f1 = sharded_ldlt(shard_kkt(torch.tensor(Ks[s]), mesh), mesh,
                          panel=TP_BATCH_PANEL)
        x1 = sharded_ldlt_solve(f1, torch.tensor(bs[s]), mesh)
        singles.append((f1[0].numpy(), f1[2].numpy(), x1.numpy()))
    out["batch"] = ((fb[0].numpy(), fb[2].numpy(), xb.numpy()), singles)

    # a (2, 2) ("dp", "tp") mesh: collectives over each axis, and the tp
    # factor on each dp slice against the 1-D mesh's
    mesh2 = make_mesh((2, 2), ("dp", "tp"), cpus(4))
    r = mesh2.rank
    v = torch.tensor([float(r), 10.0 * r + 1.0])
    out["two_axes"] = {
        "coords": (mesh2.axis_index("dp"), mesh2.axis_index("tp")),
        "groups": sorted(mesh2.axis_groups),
        "collectives": {
            a: {"psum": m.psum(v, mesh2, a).tolist(),
                "pmin": m.pmin(v, mesh2, a).tolist(),
                "pmax": m.pmax(v, mesh2, a).tolist(),
                "gather": m.all_gather(v, mesh2, a).tolist(),
                "gather_tiled": m.all_gather(v, mesh2, a,
                                             tiled=True).tolist(),
                "broadcast": m.broadcast(v.clone(), mesh2, a, 1).tolist()}
            for a in ("dp", "tp")},
        "shard": m.shard_slice(8, mesh2, "tp"),
    }
    m.barrier(mesh2, "dp")
    m.barrier(mesh2, "tp")
    L2, D2, _ = _tp_factor(K0, mesh2, "tp", 64)
    fac2 = sharded_ldlt(shard_kkt(torch.tensor(K1), mesh2), mesh2,
                        panel=64)
    x2 = sharded_ldlt_solve(fac2, torch.tensor(b), mesh2)
    out["two_axes"].update(L=L2, D=D2, x=x2.numpy())
    out["staged"] = mesh.host_syncs + mesh2.host_syncs
    return out


#: tests/test_sharded_ipm.py's cases at 4 ranks, float64: name ->
#: (QP, Settings keywords (None: BOX), n, m_ineq, panel)
TP_IPM_CASES = {
    "matches_unsharded": (box_qp(64), None, 64, 0, 8),
    "padding": (box_qp(50, seed=3), None, 50, 0, 8),
    "ineq": (ineq_qp(), {}, 24, 8, 4),
}


def _tp_settings(kw):
    from ipmzoo_tpu_torch import Bounds, InequalityHandling, Settings
    if kw is None:
        return Settings(inequalities=Bounds.NONE,
                        inequality_handling=InequalityHandling.SLACKS)
    return Settings(**kw)


def _result(res):
    return {k: getattr(res, k).numpy()
            for k in ("x", "iterations", "converged", "objective",
                      "residual", "gap")}


def sharded_ipm_world4():
    """Every case of tests/test_torch_sharded_ipm.py at 4 ranks: the
    sharded solve and the port's local 'jnp' solve of the same data."""
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.models.state import tree_map
    from ipmzoo_tpu_torch.parallel import make_mesh

    mesh = make_mesh((4,), ("tp",), cpus(4))
    out = {"rank": mesh.rank}
    for name, (raw, skw, n, m_ineq, panel) in TP_IPM_CASES.items():
        data = _qp(raw)
        kw = dict(n=n, m_ineq=m_ineq, dtype=torch.float64, tol=1e-8)
        sharded = CompiledIPM(_tp_settings(skw), kernel="sharded",
                              mesh=mesh, panel=panel, **kw)
        plain = CompiledIPM(_tp_settings(skw), kernel="jnp", device="cpu",
                            **kw)
        out[name] = {"sharded": _result(sharded.solve(data)),
                     "plain": _result(plain.solve(data)),
                     "dim": sharded._sharded_dim,
                     "panel": sharded._sharded_panel,
                     "device": str(sharded.device)}

    # the batch entry points: two instances through solve_batch and
    # solve_batch_compact, and init_state / step of one instance and of
    # the batch
    raw, skw, n, m_ineq, panel = TP_IPM_CASES["ineq"]
    kw = dict(n=n, m_ineq=m_ineq, dtype=torch.float64, tol=1e-8)
    sharded = CompiledIPM(_tp_settings(skw), kernel="sharded", mesh=mesh,
                          panel=panel, **kw)
    plain = CompiledIPM(_tp_settings(skw), kernel="jnp", device="cpu", **kw)
    one = _qp(raw)
    batch = tree_map(lambda a: torch.stack([a, 1.5 * a]), one)
    out["batch"] = {"sharded": _result(sharded.solve_batch(batch)),
                    "plain": _result(plain.solve_batch(batch))}
    out["compact"] = {"sharded": _result(sharded.solve_batch_compact(batch)),
                      "plain": _result(plain.solve_batch_compact(batch))}
    steps = {}
    for what, data in (("one", one), ("batch", batch)):
        pair = []
        for s in (sharded, plain):
            st = s.init_state(data)
            for _ in range(3):
                st = s.step(st, data)
            pair.append([v.numpy() for v in st.vars] +
                        [st.mu.numpy(), st.iteration.numpy()])
        steps[what] = pair
    out["steps"] = steps
    out["default_panel"] = CompiledIPM(
        _tp_settings(None), n=64, kernel="sharded", mesh=mesh)._sharded_panel
    out["other_device"] = _error(lambda: CompiledIPM(
        _tp_settings(None), n=8, kernel="sharded", mesh=mesh,
        device="meta"))
    out["no_axis"] = _error(lambda: CompiledIPM(
        _tp_settings(None), n=8, kernel="sharded", mesh=mesh,
        mesh_axis="dp"))
    out["staged"] = mesh.host_syncs
    return out
