"""Strong-scaling efficiency of the dp (batched-QP) axis (counterpart of
:mod:`ipmzoo_tpu.parallel.scaling`).

The same whole-batch stepping workload is timed (a) by rank 0 alone on
its device, the other ranks waiting, and (b) with every rank stepping
its slice of the batch at once, and reported as

    efficiency = t_1dev / (n_devices * t_ndev)

(strong scaling: fixed total batch).  Times come from
:mod:`ipmzoo_tpu_torch.utils.timer`: CUDA events on a card, the host
clock on the CPU; (b) takes the slowest rank, so every rank returns the
same report.  The reference's slope timing is a workaround for its
backend's asynchronous dispatch and has no counterpart here.

Ranks that share one card (or one CPU) time-slice it: their efficiency
measures the mechanics, not hardware scaling.
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import barrier, make_mesh, pmax, shard_batch


@dataclasses.dataclass
class ScalingReport:
    n_devices: int
    steps: int
    batch: int
    t_1dev: float           # seconds per `steps` whole-batch steps, 1 device
    t_ndev: float           # same workload dp-sharded over all devices
    iters_per_s_1dev: float
    iters_per_s_ndev: float
    speedup: float          # t_1dev / t_ndev
    efficiency: float       # speedup / n_devices  (1.0 = perfect)

    def summary(self) -> str:
        return (f"dp scaling: {self.batch} QPs x {self.steps} steps, "
                f"{self.n_devices} device(s): "
                f"{self.iters_per_s_1dev:.3g} it/s (1 dev) -> "
                f"{self.iters_per_s_ndev:.3g} it/s ({self.n_devices} dev), "
                f"speedup {self.speedup:.2f}x, "
                f"efficiency {100 * self.efficiency:.1f}%")


def time_steps(solver, data, steps: int) -> float:
    """Seconds for ``steps`` batched steps of ``data`` from its initial
    state: the median of 3 runs after a warm-up, by CUDA events on a card
    and by the host clock on the CPU."""
    from ..utils.timer import cuda_time, host_time
    checked = solver._check_data(data)
    state = solver._init_batch(checked)

    def k_steps():
        s = state
        for _ in range(steps):
            s = solver._step_impl(s, checked)
        return s

    timer = cuda_time if solver.device.type == "cuda" else host_time
    return timer(k_steps, 3).ms * 1e-3


def _slowest(t: float, mesh) -> float:
    return float(pmax(torch.tensor(t, dtype=torch.float64,
                                   device=mesh.device), mesh))


def dp_scaling_report(solver, data, steps: int = 10,
                      devices=None) -> ScalingReport:
    """Strong-scaling efficiency of dp-sharded batched stepping over the
    ranks of the process group.

    Every rank passes the same ``solver`` (a
    :class:`~ipmzoo_tpu_torch.models.ipm.CompiledIPM` on its device) and
    the whole batched ``data``.  ``devices``: one per rank, as for
    :func:`.mesh.make_mesh` (None: each rank's card)."""
    mesh = make_mesh(devices=devices)
    n_dev = mesh.size
    batch = int(data.Q.shape[0])

    # (a) rank 0 steps the whole batch alone; the others wait
    barrier(mesh)
    t1 = time_steps(solver, data, steps) if mesh.rank == 0 else 0.0
    barrier(mesh)
    t1 = _slowest(t1, mesh)

    # (b) every rank steps its slice at once
    if n_dev > 1:
        shard = shard_batch(data, mesh)
        barrier(mesh)
        tn = _slowest(time_steps(solver, shard, steps), mesh)
    else:
        tn = t1

    speedup = t1 / tn
    return ScalingReport(
        n_devices=n_dev, steps=steps, batch=batch, t_1dev=t1, t_ndev=tn,
        iters_per_s_1dev=batch * steps / t1,
        iters_per_s_ndev=batch * steps / tn,
        speedup=speedup, efficiency=speedup / n_dev)
