#!/usr/bin/env python3
"""Schedules of ``solve_batch_compact`` on one NVIDIA GPU (the port's
counterpart of tools/compact_sched_probe.py).

    python3 chip_compact_sched.py

bench's compact workload (``models/convert.py::make_batch`` seed 0: 10240
QPs, n=16, m_ineq=8, float32, tol 1e-6) through
``CompiledIPM.solve_batch_compact`` under each of the reference probe's
four schedules of ``(steps, batch divisor)`` stages.  The first is the
port's default, ``default_schedule(B)``, printed as the solver makes it
(at tol 1e-6 and max_iter 100: (16,1)(16,4)(68,32), the reference's
choice from that probe; the reference probe's own label of its first row
names an older schedule).  Per schedule, from one counted solve: the
share converged, the total iterations, its host syncs (torch's sync
debug mode), K2's and K3's launches by route, and the count of instances
still active (neither converged nor diverged) after each stage; then the wall median and spread
by CUDA events over solves of their own (each run from an idle device,
the four schedules in turns, so a drift of the host falls on all alike)
and useful iterations a second (total iterations over the median wall).
Every line carries the card's name and power limit.  Exits 2 without a
CUDA device.
"""

import sys

B, N, M_INEQ, TOL = 10240, 16, 8, 1e-6
RUNS = 5
#: the reference probe's schedules after its first (None: the default)
SCHEDULES = (("default", None),
             ("deep", [(16, 1), (12, 4), (12, 16), (60, 64)]),
             ("wide", [(16, 1), (16, 4), (68, 32)]),
             ("k0_18", [(18, 1), (12, 8), (70, 64)]))


def setup(batch=B, n=N, m=M_INEQ, dtype=None, device=None):
    """bench's compact workload and its solver."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.convert import make_batch
    dtype = torch.float32 if dtype is None else dtype
    data = make_batch(batch, n, m, dtype, device=device)
    return CompiledIPM(Settings(), n, m, dtype=dtype, tol=TOL,
                       device=device), data


def schedules(solver, batch):
    """(name, schedule) of every row, the default written out."""
    return [(name, solver.default_schedule(batch) if s is None else s)
            for name, s in SCHEDULES]


def counted_solve(solver, data, schedule):
    """One solve, counted: its result, its host syncs (torch's sync debug
    mode, ``utils/timer.host_syncs``, as the other two probes count
    them), K2's and K3's launches by route, and the instances still
    active (neither converged nor diverged) after each stage, read by
    wrapping the solver's ``_masked_steps`` (one call a stage; the counts
    stay on the device until the solve is done, so they add no sync)."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.utils import timer
    actives, out = [], []
    inner = solver._masked_steps

    def counted(state, d, diverged, res_tol, k, gondzio=None):
        state, diverged = inner(state, d, diverged, res_tol, k,
                                gondzio=gondzio)
        actives.append((~solver._done(state, res_tol) & ~diverged).sum())
        return state, diverged

    before = dict(cuda_ldlt.route_launches)
    solver._masked_steps = counted
    try:
        syncs = timer.host_syncs(lambda: out.append(
            solver.solve_batch_compact(data, schedule=schedule)))
    finally:
        del solver._masked_steps
    launches = {k: v - before[k] for k, v in cuda_ldlt.route_launches.items()
                if v - before[k]}
    return out[0], syncs, launches, [int(a) for a in actives]


def wall(fns, runs=RUNS):
    """Wall ms of each solve by CUDA events, each run from an idle
    device, the schedules in turns (``runs`` rounds; the counted solves
    before them are the warm-up)."""
    from ipmzoo_tpu_torch.utils.timer import cuda_time_rounds
    return cuda_time_rounds(fns, runs, warmup=False)


def run(batch=B, n=N, m=M_INEQ, dtype=None, device=None, runs=RUNS):
    """Every schedule's row, printed; returns the rows as dicts."""
    from ipmzoo_tpu_torch.utils import device as card
    solver, data = setup(batch, n, m, dtype, device)
    name, rows = card.nvidia_smi(), []
    print(f"compact schedules: {batch} QPs, n={n}, m_ineq={m}, "
          f"{str(solver.dtype).replace('torch.', '')}, tol {TOL:g}, "
          f"max_iter {solver.max_iter}, on {data.Q.device}; wall by CUDA "
          f"events over {runs} runs")
    rows_of = schedules(solver, batch)
    counted = [counted_solve(solver, data, s) for _, s in rows_of]
    walls = wall([lambda s=s: solver.solve_batch_compact(data, schedule=s)
                  for _, s in rows_of], runs)
    for (label, schedule), (res, syncs, launches, actives), t in zip(
            rows_of, counted, walls):
        conv = float(res.converged.float().mean())
        iters = float(res.iterations.sum())
        left = int((~res.converged).sum())
        rows.append({"row": label, "schedule": schedule, "converged": conv,
                     "iterations": iters, "ms": t.ms, "spread": t.spread,
                     "it_s": iters / t.ms * 1e3, "syncs": syncs,
                     "launches": launches, "actives": actives,
                     "unconverged": left, "card": name})
        print(f"  {label} {schedule}: converged {conv * 100:.2f}%, "
              f"iterations {iters:.0f}, wall {t.ms:.3f} ms (spread "
              f"{t.spread:.3f}) => {iters / t.ms * 1e3 / 1e6:.4f}M useful "
              f"it/s; host syncs {syncs:g}; launches by route {launches}; "
              f"active after each stage {actives}, unconverged at the end "
              f"{left}  [{name}]")
    return rows


def main(argv=None):
    import torch
    from chip_roofline import banner
    dev = banner("chip_compact_sched", "the schedules are timed")
    if dev is None:
        return 2
    run(dtype=torch.float32, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
