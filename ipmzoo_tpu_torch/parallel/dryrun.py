"""Multi-process dry run of the sharded paths (the counterpart of the
reference's ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(world)`` starts ``world`` processes joined in one
group (:func:`.distributed.spawn`), builds a mesh over them, and runs
five checks at the reference's sizes, each sharded against the same
path run locally on every rank:

* ``dp-step``: one batched IPM step of 2 x world QPs (n=4, m_ineq=2,
  float32) on each rank's slice of the batch, gathered, against the step
  of the whole batch;
* ``schur``: ``SchurIPM.solve_sharded`` of a coupled QP of 2 x world
  blocks (n=4, m_c=2, float32, tol 1e-4, three iterations) against
  ``SchurIPM.solve``;
* ``schur-tf``: the same at tol 1e-8, where ``two_float`` engages
  (float64 iteration), 20 iterations, refine=2;
* ``tp-ldlt``: one SPD system of order 8 x world row-sharded over a
  ``("tp",)`` mesh, the panel-sharded LDL^T (panel 4) and its solve
  against :func:`..ops.ldlt.ldlt_solve`;
* ``tp-ipm``: the box QP of n = 4 x world through ``CompiledIPM(kernel=
  'sharded', panel=2)`` (tol 1e-4, three iterations) against the same
  solve with the default kernel.

The tp checks draw their data from the reference's generator, after the
coupled QP's draws, so both dry runs solve the same numbers.

A check fails on wrong numbers, not only on a crash: sharded and local x
must agree within 1e-5.  The ranks run on their cards (``cuda:{rank %
device_count}``) unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

#: sharded-against-local limit of every check
TOL_EQ = 1e-5


def _demo_batch(batch, n, m_ineq, dtype, device):
    """The reference's demo batch (numpy seed 0): SPD Q, two-sided
    inequalities and bounds +-5."""
    from ..models.data import QPData
    rng = np.random.default_rng(0)
    M = rng.normal(size=(batch, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)
    c = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m_ineq, n))
    l_A = -np.abs(rng.normal(size=(batch, m_ineq))) - 1
    u_A = np.abs(rng.normal(size=(batch, m_ineq))) + 1

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return QPData(Q=t(Q), c=t(c), A_ineq=t(A), l_A_ineq=t(l_A),
                  u_A_ineq=t(u_A), A_eq=t(np.zeros((batch, 0, n))),
                  b_eq=t(np.zeros((batch, 0))),
                  l_x=t(-5 * np.ones((batch, n))),
                  u_x=t(5 * np.ones((batch, n))))


def _coupled(world, dtype, device):
    """The reference's coupled QP (numpy seed 1): 2 x world blocks of
    n=4 with 2 coupling rows."""
    from .schur import BlockQPData
    blocks, nb, mc = 2 * world, 4, 2
    rng = np.random.default_rng(1)
    M = rng.normal(size=(blocks, nb, nb))
    Q = np.einsum("bij,bkj->bik", M, M) / nb + np.eye(nb)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BlockQPData(Q=t(Q), c=t(rng.normal(size=(blocks, nb))),
                       F=t(rng.normal(size=(blocks, mc, nb)) / blocks),
                       l_x=t(np.full((blocks, nb), -3.0)),
                       u_x=t(np.full((blocks, nb), 3.0)),
                       g=t(np.zeros(mc)))


def _tp_data(world, dtype, device):
    """The reference's tp data: its seed-1 generator continued past the
    coupled QP's draws; (K, rhs) of order 8 x world and the box QP of
    n = 4 x world."""
    from ..models.data import QPData
    blocks, nb, mc = 2 * world, 4, 2
    rng = np.random.default_rng(1)
    for size in ((blocks, nb, nb), (blocks, nb), (blocks, mc, nb)):
        rng.normal(size=size)
    dim = 8 * world
    Mk = rng.normal(size=(dim, dim))
    K = Mk @ Mk.T / dim + 2.0 * np.eye(dim)
    rhs = rng.normal(size=dim)
    n = 4 * world
    Mq = rng.normal(size=(n, n))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    qp = QPData(Q=t(Mq @ Mq.T / n + np.eye(n)), c=t(rng.normal(size=n)),
                A_ineq=t(np.zeros((0, n))), l_A_ineq=t(np.zeros(0)),
                u_A_ineq=t(np.zeros(0)), A_eq=t(np.zeros((0, n))),
                b_eq=t(np.zeros(0)), l_x=t(np.full(n, -3.0)),
                u_x=t(np.full(n, 3.0)))
    return t(K), t(rhs), qp


def _check(name, a, b) -> float:
    diff = float((a - b).abs().max()) if a.numel() else 0.0
    if not diff <= TOL_EQ:
        raise AssertionError(f"{name}: sharded != local ({diff:.3e})")
    return diff


def _rank(world, device):
    """One rank's five checks; returns name -> sharded-vs-local max
    |diff|."""
    from ..formulations import Bounds, InequalityHandling, Settings
    from ..models.ipm import CompiledIPM
    from ..ops.ldlt import ldlt_solve
    from ..ops.sharded_ldlt import (shard_kkt, sharded_ldlt,
                                    sharded_ldlt_solve)
    from .mesh import gather_batch, make_mesh, shard_batch
    from .schur import SchurIPM

    mesh = make_mesh((world,), ("dp",),
                     None if device is None else [device] * world)
    dev = mesh.device
    dtype = torch.float32
    diffs = {}

    # dp: a batch of independent QPs over the ranks
    batch, n, m_ineq = 2 * world, 4, 2
    solver = CompiledIPM(Settings(), n=n, m_ineq=m_ineq, dtype=dtype,
                         tol=1e-4, max_iter=3, device=dev)
    data = _demo_batch(batch, n, m_ineq, dtype, dev)
    local = shard_batch(data, mesh)
    out = gather_batch(solver.step(solver.init_state(local), local), mesh)
    if tuple(out.iteration.shape) != (batch,):
        raise AssertionError(f"dp-step: iteration of shape "
                             f"{tuple(out.iteration.shape)}")
    out_l = solver.step(solver.init_state(data), data)
    diffs["dp-step"] = _check("dp-step", out.vars[0], out_l.vars[0])

    # sp: one coupled QP, its blocks over the ranks
    bdata = _coupled(world, dtype, dev)
    schur = SchurIPM(4, 2, mesh=mesh, axis="dp", dtype=dtype, tol=1e-4,
                     max_iter=3)
    res = schur.solve_sharded(bdata)
    if tuple(res.x.shape) != tuple(bdata.c.shape):
        raise AssertionError(f"schur: x of shape {tuple(res.x.shape)}")
    res_l = SchurIPM(4, 2, dtype=dtype, tol=1e-4, max_iter=3,
                     block_kernel=schur.block_kernel, device=dev).solve(bdata)
    diffs["schur"] = _check("schur", res.x, res_l.x)

    # sp at the reference-parity tolerance: two_float engages
    schur_tf = SchurIPM(4, 2, mesh=mesh, axis="dp", dtype=dtype, tol=1e-8,
                        max_iter=20, refine=2)
    if not schur_tf.two_float:
        raise AssertionError("two_float='auto' should engage at float32 and "
                             "tol 1e-8")
    res_tf = schur_tf.solve_sharded(bdata)
    res_tf_l = SchurIPM(4, 2, dtype=dtype, tol=1e-8, max_iter=20, refine=2,
                        block_kernel=schur_tf.block_kernel,
                        device=dev).solve(bdata)
    diffs["schur-tf"] = _check("schur-tf", res_tf.x, res_tf_l.x)

    # tp: one system row-sharded over the ranks, factored and solved
    mesh_tp = make_mesh((world,), ("tp",), list(mesh.devices.flat))
    K, rhs, qp = _tp_data(world, dtype, dev)
    factors = sharded_ldlt(shard_kkt(K, mesh_tp), mesh_tp, panel=4)
    xs = sharded_ldlt_solve(factors, rhs, mesh_tp, panel=4)
    if tuple(xs.shape) != tuple(rhs.shape):
        raise AssertionError(f"tp-ldlt: x of shape {tuple(xs.shape)}")
    diffs["tp-ldlt"] = _check("tp-ldlt", xs, ldlt_solve(K, rhs))

    # tp end to end: the Mehrotra loop with the sharded factor inside
    box = Settings(inequalities=Bounds.NONE,
                   inequality_handling=InequalityHandling.SLACKS)
    kw = dict(n=qp.n, dtype=dtype, tol=1e-4, max_iter=3)
    tr = CompiledIPM(box, kernel="sharded", mesh=mesh_tp, panel=2,
                     **kw).solve(qp)
    if tuple(tr.x.shape) != (qp.n,):
        raise AssertionError(f"tp-ipm: x of shape {tuple(tr.x.shape)}")
    tr_l = CompiledIPM(box, device=dev, **kw).solve(qp)
    diffs["tp-ipm"] = _check("tp-ipm", tr.x, tr_l.x)
    return diffs


def dryrun_multichip(world: int, device=None) -> dict:
    """Run the five sharded-against-local checks in ``world`` processes
    (on their cards, or on the CPU with ``device="cpu"``); prints each
    check's largest difference over the ranks and returns them by name.
    Raises where a rank's check fails or a rank fails."""
    from .distributed import spawn
    cpu = device is not None and torch.device(device).type == "cpu"
    per_rank = spawn(_rank, world, world, device, cpu=cpu)
    diffs = {k: max(d[k] for d in per_rank) for k in per_rank[0]}
    for name, diff in diffs.items():
        print(f"dryrun[{name}]: sharded vs local max|diff| = {diff:.3e} "
              f"({world} ranks)")
    return diffs
