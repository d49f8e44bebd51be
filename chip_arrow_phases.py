#!/usr/bin/env python3
"""Phase split of the banded+arrow IPM step on one NVIDIA GPU (the port's
counterpart of tools/arrow_phases.py).

    python3 chip_arrow_phases.py [n] [bandwidth] [tip]

The problem is the reference tool's (``make_problem``: numpy seed 0,
n=4096, half-bandwidth 16, tip 8, float32), solved by the port's
``ArrowIPM`` with ``method="auto"`` and tol 1e-5, which on the card runs
the cyclic reduction as K6 (factor) and K7 (solve).  At the initial
iterate, the reference tool's rows each time one piece of
``ArrowIPM._step_impl`` on the same inputs:

* the bare banded factor (K6, named by the route ``cuda_cr.k6_route``
  takes) and the full arrow factor (``ops/banded.py::arrow_factor``: K6,
  the K7 solve of the arrow strip, the tip's Schur complement);
* the banded solve at k=1 and k=tip right-hand sides (K7, by
  ``cuda_cr.k7_route``);
* ``_direction``, ``_max_step`` (the eight ratio reductions),
  ``_gap_at``, ``_qx``, ``_metrics`` and the whole ``_step_impl``;

and the sum 1F + 2D + 2M + G + Me against the step, as the reference
prints it.  The port's ``_step_impl`` factors and solves in one
``arrow_factor_solve`` (models/arrow.py), where the factor row factors
alone: the sum counts a factor and two directions, the step runs one
fused factor-solve and one direction.

The port's methods take a leading batch axis: each row runs on the single
instance as a batch of 1 and on bench_arrow's batch of 32 (the same Q, c
from numpy seeds 1..32, as chip_smoke.py's arrow slice).  Each row gives,
per execution: the wall by CUDA events as the slope of K=4 and K=16
back-to-back calls (the reference's K-slope; on the card the launches it
cancels nowhere are real cost, so the slope keeps them), the device ms
and the launches under torch.profiler, and the host syncs (torch's sync
debug mode); beside them the card's name and power limit.  Exits 2
without a CUDA device.
"""

import sys

import numpy as np

N, BAND, TIP, TOL = 4096, 16, 8, 1e-5
#: bench_arrow's batch (chip_smoke.ARROW_BATCH) beside the single instance
BATCHES = (1, 32)
#: back-to-back calls of the slope
K = (4, 16)
RUNS = 5
#: the rows the reference sums: (key, weight)
SUM = (("arrow factor", 1), ("direction", 2), ("max_step", 2),
       ("gap_at", 1), ("metrics", 1))


def make_problem(n, b, t):
    """tools/arrow_phases.py's problem (numpy seed 0): a banded Hessian of
    half-bandwidth b with a dense tip of t coupling variables, float32,
    bounds +-1.  Returns dense (Q, c, l, u)."""
    rng = np.random.default_rng(0)
    nb = n - t
    Q = np.zeros((n, n), np.float32)
    for i in range(nb):
        lo, hi = max(0, i - b), min(nb, i + b + 1)
        Q[i, lo:hi] = rng.normal(size=hi - lo) * 0.1
    Q = (Q + Q.T) / 2
    strip = rng.normal(size=(t, n)).astype(np.float32) * 0.1
    Q[nb:, :] = strip
    Q[:, nb:] = strip.T
    Q[nb:, nb:] = (strip[:, nb:] + strip[:, nb:].T) / 2
    Q += np.eye(n, dtype=np.float32) * (2 * b + t)
    c = rng.normal(size=n).astype(np.float32)
    l = np.full(n, -1.0, np.float32)
    u = np.full(n, 1.0, np.float32)
    return Q, c, l, u


def batch_data(problem, batch, dtype, device):
    """The batch of ``batch`` instances: the problem itself for one, else
    its Q with c drawn from numpy seeds 1..batch.  Returns (data,
    structure)."""
    import torch
    from ipmzoo_tpu_torch import ArrowQPData
    from ipmzoo_tpu_torch.models.state import tree_map
    Q, c, l, u = problem
    one, st, _ = ArrowQPData.from_dense(Q, c, l, u, dtype=dtype,
                                        device=device)
    if batch == 1:
        return tree_map(lambda a: a[None], one), st
    n = Q.shape[0]
    return ArrowQPData.stack([ArrowQPData.from_dense(
        Q, np.random.default_rng(s).normal(size=n).astype(np.float32), l, u,
        structure=st, dtype=dtype, device=device)[0]
        for s in range(1, batch + 1)]), st


def routes(solver, data):
    """The names of the bare factor's and the two solves' routes: K6's and
    K7's on CUDA tensors under 'pl', else the method's own name."""
    from ipmzoo_tpu_torch.ops import cuda_cr
    from ipmzoo_tpu_torch.ops.banded import resolve_method
    method = resolve_method(solver.method, data.D)
    if method != "pl" or data.D.device.type != "cuda":
        return method, method, method
    B, dt = data.D.shape[0], data.D.dtype
    N, b, t = solver.N, solver.b, solver.t
    return (f"K6 {cuda_cr.k6_route(N, b, B, dt)}",
            f"K7 {cuda_cr.k7_route(N, b, 1, B, dt)[0]}",
            f"K7 {cuda_cr.k7_route(N, b, t, B, dt)[0]}")


def phases(solver, data):
    """(key, label, fn) of every row at the initial iterate of ``data``
    (checked, batched); ``fn()`` runs the phase once and returns what it
    computes.  The inputs are the reference tool's."""
    import torch
    from ipmzoo_tpu_torch.ops.banded import _bfactor, _bsolve, arrow_factor
    state = solver._init_batch(data)
    vars = state.vars
    x, lg, lh = vars
    g, h = solver._slacks(data, x)
    Dc, Ctc = solver._condensed(data, vars)
    method = solver.method
    fac0 = _bfactor(Dc, data.E, method)
    factors = arrow_factor(Dc, data.E, data.U, Ctc, method=method)
    B, N, b, t = x.shape[0], solver.N, solver.b, solver.t
    r1 = torch.ones((B, N, b, 1), dtype=x.dtype, device=x.device)
    rt = torch.ones((B, N, b, t), dtype=x.dtype, device=x.device)
    cg, ch = g * lg, h * lh
    trial = tuple(v * (1 - 1e-3) for v in vars)
    d0 = solver._direction(data, vars, factors, state.rx, cg, ch)
    f_route, s1_route, st_route = routes(solver, data)
    return [
        ("factor", f"cr factor kernel ({f_route})",
         lambda: _bfactor(Dc, data.E, method)),
        ("arrow factor", "full arrow factor (+W,+tip)",
         lambda: arrow_factor(Dc, data.E, data.U, Ctc, method=method)),
        ("solve k=1", f"cr solve k=1 ({s1_route})",
         lambda: _bsolve(fac0, r1)),
        ("solve k=t", f"cr solve k={t} ({st_route})",
         lambda: _bsolve(fac0, rt)),
        ("direction", "full direction (arrow_solve+duals)",
         lambda: solver._direction(data, vars, factors, state.rx, cg, ch)),
        ("max_step", "max_step (8 ratio reductions)",
         lambda: solver._max_step(data, vars, d0)),
        ("gap_at", "gap_at", lambda: solver._gap_at(data, trial)),
        ("qx", "qx structured matvec", lambda: solver._qx(data, x)),
        ("metrics", "metrics (qx + residual norms)",
         lambda: solver._metrics(data, trial)),
        ("step", "FULL STEP (_step_impl)",
         lambda: solver._step_impl(state, data)),
    ]


def setup(n=N, b=BAND, t=TIP, batch=1, dtype=None, device=None):
    """The solver and checked data of the tool's problem at one batch."""
    import torch
    from ipmzoo_tpu_torch import ArrowIPM
    dtype = torch.float32 if dtype is None else dtype
    data, st = batch_data(make_problem(n, b, t), batch, dtype, device)
    solver = ArrowIPM.for_data(data, structure=st, dtype=dtype, tol=TOL)
    return solver, solver._check_data(data)


def tensors(out):
    """The tensors of a phase's output that two runs can compare: a
    factor's W and tip Cholesky, a state's fields; None for the bare
    banded factor, whose layout is the route's own."""
    import torch
    from ipmzoo_tpu_torch.models.arrow import ArrowState
    from ipmzoo_tpu_torch.ops.banded import ArrowFactors
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, ArrowFactors):
        return [out.W, out.tip_chol]
    if isinstance(out, ArrowState):
        return [*out.vars, out.mu, out.residual, out.gap, out.rx]
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return [a for o in out for a in tensors(o)]
    return None


def results(n=N, b=BAND, t=TIP, batch=1, dtype=None, device=None):
    """key -> the phase's comparable output tensors (float64, on the CPU)
    for every row but the bare factor."""
    solver, data = setup(n, b, t, batch, dtype, device)
    out = {}
    for key, _, fn in phases(solver, data):
        ts = tensors(fn())
        if ts is not None:
            out[key] = [a.detach().double().cpu() for a in ts]
    return out


def measure(fn, k=K, runs=RUNS):
    """Per execution of ``fn`` on the card: the wall (slope of k[0] and
    k[1] back-to-back calls by CUDA events), the device ms and launches
    (torch.profiler) and the host syncs."""
    from ipmzoo_tpu_torch.utils.timer import (cuda_time, device_calls,
                                              host_syncs)
    k1, k2 = k
    t1 = cuda_time(fn, runs=runs, calls=k1)
    t2 = cuda_time(fn, runs=runs, calls=k2)
    dev = device_calls(fn, k1)
    return {"wall_ms": (k2 * t2.ms - k1 * t1.ms) / (k2 - k1),
            "device_ms": dev.ms, "launches": dev.launches,
            "whole": dev.whole, "syncs": host_syncs(fn, k1)}


def run(n=N, b=BAND, t=TIP, batches=BATCHES, dtype=None, device=None,
        k=K, runs=RUNS):
    """Every row at every batch, printed; returns the rows as dicts."""
    import torch
    from ipmzoo_tpu_torch.utils import device as card
    dtype = torch.float32 if dtype is None else dtype
    name, rows = card.nvidia_smi(), []
    for batch in batches:
        solver, data = setup(n, b, t, batch, dtype, device)
        print(f"arrow phases: n={n}, bandwidth={b}, tip={t}, block "
              f"{solver.b}, N={solver.N}, batch {batch}, "
              f"{str(dtype).replace('torch.', '')}, method={solver.method}, "
              f"{data.D.device}; per execution: wall (slope of {k[0]} and "
              f"{k[1]} calls by CUDA events), device ms and launches "
              f"(torch.profiler), host syncs")
        got = {}
        for key, label, fn in phases(solver, data):
            m = measure(fn, k, runs)
            got[key] = m
            rows.append({"batch": batch, "key": key, "row": label, **m,
                         "card": name})
            print(f"  B={batch:<3d} {label:40s}: wall {m['wall_ms']:9.4f} ms"
                  f", device {m['device_ms']:9.4f} ms, launches "
                  f"{m['launches']:6.2f}, syncs {m['syncs']:5.2f}  [{name}]")
        acct = {f: sum(w * got[key][f] for key, w in SUM)
                for f in ("wall_ms", "device_ms", "launches")}
        step = got["step"]
        rows.append({"batch": batch, "key": "sum", **acct,
                     "whole": all(got[key]["whole"] for key, _ in SUM),
                     "step_wall_ms": step["wall_ms"], "card": name})
        print(f"  B={batch:<3d} {'sum of phases (1F+2D+2M+G+Me)':40s}: wall "
              f"{acct['wall_ms']:9.4f} ms (step {step['wall_ms']:.4f}), "
              f"device {acct['device_ms']:9.4f} ms (step "
              f"{step['device_ms']:.4f}), launches {acct['launches']:6.2f} "
              f"(step {step['launches']:.2f})  [{name}]; the step fuses "
              f"its factor with the predictor's solve (arrow_factor_solve: "
              f"one banded factor, two banded solves), the sum counts a "
              f"factor and two directions")
    return rows


def main(argv=None):
    import torch
    from chip_roofline import banner
    argv = sys.argv[1:] if argv is None else argv
    n, b, t = (int(a) for a in (argv + [N, BAND, TIP][len(argv):])[:3])
    dev = banner("chip_arrow_phases", "the phases are timed")
    if dev is None:
        return 2
    run(n, b, t, device=dev, dtype=torch.float32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
