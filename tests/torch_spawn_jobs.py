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
        "two_axes": _error(lambda: m.psum(
            torch.ones(1), make_mesh((2, 2), ("dp", "tp"), cpus(4)), "dp")),
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
