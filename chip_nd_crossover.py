#!/usr/bin/env python3
"""The nested-dissection path against the dense path on 2D-grid QPs, on
one NVIDIA GPU (the port's counterpart of tools/nd_crossover.py), and the
fit of the auto-fallback's cost model (ops/ndiss.py) to what it measured.

    python3 chip_nd_crossover.py [--out ROWS.json] [g1 g2 ...]
    python3 chip_nd_crossover.py --one-level [--out ROWS.json] [g1 ...]
    python3 chip_nd_crossover.py --fit ROWS.json [ROWS.json ...]

For each grid side g (default 16 24 32 48 64 80 96 112 128): the port's
``grid_qp(side=g, seed=0)`` in float32 under
``CompiledIPM(kernel="nd", nd_leaf=64, nd_fallback=False, tol=1e-5)``
and under the dense ``CompiledIPM(tol=1e-5)`` (kernel 'auto'); one IPM
step of each is timed as the slope of the walls of two step counts, nd
and dense rounds interleaved, the median of three rounds
(``bench_torch.dense_speedup``; the dense path must converge first).  One
line a side: n, the plan's levels and ``flops_nd``, nd ms, dense ms and
the dense mode, the measured speedup (dense / nd) and the cost model's
predicted speedup under the JAX package's constants
(``ops/ndiss.py:REFERENCE_CONSTANTS``) and under the card's fit,
``CARD_FIT`` (the port's default).  ``--one-level`` measures, at
each side's n, the plan of a dense pattern (``nd_pattern`` all true: one
level, the whole matrix one leaf) instead of the grid's (default sides
14 20 32, n = 196, 400, 1024).  Once a side has taken more than 60 s, the
larger sides are reported and skipped; a side
whose dense step does not fit the card's memory is reported and skipped.
``--out`` writes the rows, with the card's name and power limit, as JSON.

``--fit`` reads the rows of one or more such files (no card needed) and
prints the six constants fitted to them: the dense rows by non-negative
least squares on the relative error against (1, n^2, n^3), the nd rows
likewise against (1, levels, 2 flops_nd); a term the fit sets to zero
stays zero in the model's form (ND_FLOP_RATE = inf).  Beside them, each row's
relative error, the worst per dense mode and for nd, and the speedups the
fitted model predicts.

``--device cpu`` runs the measurement on the CPU (the plain versions of
the kernels); without it the tool needs a CUDA device and exits 2
without one.
"""

import argparse
import itertools
import json
import sys
import time

import numpy as np

DEFAULT_SIDES = (16, 24, 32, 48, 64, 80, 96, 112, 128)
#: seconds a side may take before the larger sides are skipped
SIDE_BUDGET_S = 60.0
ND_LEAF, TOL = 64, 1e-5
#: step counts of the slope, for nd and for dense: twelve steps apart
#: (bench_torch's nd mode takes six), as the host-bound nd step's rounds
#: spread by 20-30% at six
STEPS = (2, 14)
#: --one-level's sides: n = 196 (the fallback's range starts at 192),
#: 400 and 1024
ONE_LEVEL_SIDES = (14, 20, 32)
#: the cost model's six constants fitted on an NVIDIA H100 80GB HBM3 at a
#: 700.00 W power limit: ``--fit`` on two runs of the grid sweep (sides
#: 16-128, twelve steps a slope) and two ``--one-level`` runs, pooled.
#: ops/ndiss.py's module constants are these (the port's default).
CARD_FIT = {"ND_T_STEP": 6.104551e-3, "ND_T_LEVEL": 1.283299e-3,
            "ND_FLOP_RATE": 3.214237e11, "DENSE_T_FLOOR": 5.561362e-3,
            "DENSE_A": 2.008866e-11, "DENSE_B": 1.079313e-14}


#: measured speedups (dense / nd ms a step) inside which either path is
#: right: the timing noise of the host-bound nd step (side 96's readings
#: spread over 0.833-1.466 on the card)
BAND = (0.87, 1.2)
#: the predicted speedup from which CompiledIPM's auto-fallback keeps nd
KEEP = 1.05


def decides_wrong(measured, predicted):
    """Whether the fallback's decision at a ``predicted`` speedup takes the
    slower path at a row ``measured`` outside BAND."""
    keeps = predicted >= KEEP
    return (keeps and measured < BAND[0]) or (not keeps and
                                              measured > BAND[1])


def measure_side(g, device, one_level=False):
    """One row of the sweep at grid side ``g`` on ``device`` (with
    ``one_level``, the plan of a dense pattern of the same order): the
    plan's statistics (its levels' (matrices, order, boundary) among
    them), ms per step of nd and of dense, the dense mode, the measured
    speedup and the predicted ones."""
    import torch
    import bench_torch
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.models.families import grid_qp
    from ipmzoo_tpu_torch.models.state import with_batch_axis
    from ipmzoo_tpu_torch.ops.ndiss import (REFERENCE_CONSTANTS,
                                            nd_predicted_speedup)

    n = g * g
    fam = grid_qp(side=g, seed=0, dtype=torch.float32, device=device)
    nd = CompiledIPM(fam.settings, n=n, dtype=torch.float32, tol=TOL,
                     kernel="nd", nd_leaf=ND_LEAF, nd_fallback=False,
                     nd_pattern=np.ones((n, n), bool) if one_level
                     else None, device=device)
    t0 = time.perf_counter()
    nd._ensure_nd_plan(nd._check_data(with_batch_axis(fam.data, True)))
    plan_s = time.perf_counter() - t0
    plan = nd._nd_plan
    dense = CompiledIPM(fam.settings, n=n, dtype=torch.float32, tol=TOL,
                        device=device)
    t_nd, t_dense = bench_torch.dense_speedup(
        f"g={g}", nd, fam.data, dense, fam.data, device, STEPS, STEPS)
    return {"side": g, "n": n, "pattern": "dense" if one_level else "grid",
            "levels": len(plan.levels),
            "flops_nd": int(plan.flops_nd),
            "shapes": [[lev.idx.shape[0], lev.idx.shape[1],
                        lev.bnd.shape[1]] for lev in plan.levels],
            "nd_ms": t_nd, "dense_ms": t_dense, "dense_mode": dense._mode,
            "measured": t_dense / t_nd,
            "predicted_reference": nd_predicted_speedup(
                plan, REFERENCE_CONSTANTS),
            "predicted_card": nd_predicted_speedup(plan, CARD_FIT),
            "plan_s": plan_s}


def label(r):
    """A row's side and order, and its pattern where it is dense."""
    return f"g={r['side']:3d} n={r['n']:5d}" + (
        " dense pattern" if r.get("pattern") == "dense" else "")


def row_line(r):
    return (f"{label(r)}: {r['levels']} levels, "
            f"flops_nd={r['flops_nd']:.3e}; nd {r['nd_ms']:.4f} ms vs dense "
            f"{r['dense_ms']:.4f} ms ('{r['dense_mode']}') = "
            f"{r['measured']:.3f}x measured; predicted "
            f"{r['predicted_reference']:.3f}x (the JAX package's constants), "
            f"{r['predicted_card']:.3f}x (CARD_FIT, the port's default)")


def sweep(sides, device, one_level=False):
    """Measure every side in order, up to the first that takes more than
    SIDE_BUDGET_S; returns the rows."""
    import torch
    rows = []
    for i, g in enumerate(sides):
        t0 = time.perf_counter()
        try:
            r = measure_side(g, device, one_level)
        except torch.cuda.OutOfMemoryError as e:
            print(f"g={g}: skipped, out of the card's memory ({e})",
                  flush=True)
            torch.cuda.empty_cache()
            continue
        r["seconds"] = time.perf_counter() - t0
        rows.append(r)
        print(row_line(r) + f" [{r['seconds']:.1f} s, plan "
              f"{r['plan_s']:.1f} s]", flush=True)
        if r["seconds"] > SIDE_BUDGET_S and sides[i + 1:]:
            print(f"g={g} took {r['seconds']:.1f} s, over the budget of "
                  f"{SIDE_BUDGET_S:g} s: skipped {list(sides[i + 1:])}",
                  flush=True)
            break
    return rows


def nnls_relative(X, t):
    """argmin over theta >= 0 of sum_i ((X_i theta - t_i) / t_i)^2, exact:
    the least-squares solution on every support of the columns, the best
    one whose coefficients are all nonnegative."""
    A = np.asarray(X, float) / np.asarray(t, float)[:, None]
    b = np.ones(A.shape[0])
    scale = np.linalg.norm(A, axis=0)
    scale[scale == 0] = 1.0
    best, best_res = np.zeros(A.shape[1]), float(b @ b)
    for k in range(1, A.shape[1] + 1):
        for cols in itertools.combinations(range(A.shape[1]), k):
            As = A[:, cols] / scale[list(cols)]
            coef = np.linalg.lstsq(As, b, rcond=None)[0] / scale[list(cols)]
            if (coef < 0).any():
                continue
            theta = np.zeros(A.shape[1])
            theta[list(cols)] = coef
            res = float(np.sum((A @ theta - b) ** 2))
            if res < best_res:
                best, best_res = theta, res
    return best


def fit(rows):
    """The six constants of the cost model fitted to ``rows`` (times in
    ms, as measure_side gives them)."""
    n = np.array([r["n"] for r in rows], float)
    t_dense = np.array([r["dense_ms"] for r in rows]) * 1e-3
    t_nd = np.array([r["nd_ms"] for r in rows]) * 1e-3
    floor, a, b = nnls_relative(np.stack([np.ones_like(n), n ** 2, n ** 3],
                                         axis=1), t_dense)
    t_step, t_level, inv_rate = nnls_relative(np.stack(
        [np.ones_like(n), [float(r["levels"]) for r in rows],
         [2.0 * r["flops_nd"] for r in rows]], axis=1), t_nd)
    return {"ND_T_STEP": float(t_step), "ND_T_LEVEL": float(t_level),
            "ND_FLOP_RATE": float(1.0 / inv_rate) if inv_rate > 0
            else float("inf"),
            "DENSE_T_FLOOR": float(floor), "DENSE_A": float(a),
            "DENSE_B": float(b)}


def report_fit(rows, c):
    """Print the fitted constants, each row's relative errors, its
    decision and whether that takes the slower path outside BAND, the
    worst error per regime and the count of such rows; returns the worst
    by regime."""
    from ipmzoo_tpu_torch.ops.ndiss import cost_model_times
    for k, v in c.items():
        print(f"{k} = {v!r}" if np.isfinite(v) else f'{k} = float("inf")')
    worst, wrong = {}, 0
    for r in sorted(rows, key=lambda r: r["n"]):
        m_nd, m_dense = cost_model_times(r["n"], r["levels"],
                                         r["flops_nd"], c)
        e_nd = m_nd / (r["nd_ms"] * 1e-3) - 1.0
        e_dense = m_dense / (r["dense_ms"] * 1e-3) - 1.0
        for key, e in (("nd", e_nd), (f"dense '{r['dense_mode']}'",
                                      e_dense)):
            worst[key] = max(worst.get(key, 0.0), abs(e))
        fitted = m_dense / m_nd
        wrong += decides_wrong(r["measured"], fitted)
        print(f"{label(r)}: nd {r['nd_ms']:.4f} ms, "
              f"model {m_nd * 1e3:.4f} ({e_nd:+.3f}); dense "
              f"{r['dense_ms']:.4f} ms ('{r['dense_mode']}'), model "
              f"{m_dense * 1e3:.4f} ({e_dense:+.3f}); measured "
              f"{r['measured']:.3f}x, fitted model {fitted:.3f}x, "
              f"{'keeps nd' if fitted >= KEEP else 'falls back'}"
              + (" WRONG" if decides_wrong(r["measured"], fitted) else ""))
    for key, e in worst.items():
        print(f"worst relative error, {key}: {e:.3f}")
    print(f"rows outside {BAND[0]}-{BAND[1]} decided for the slower path: "
          f"{wrong} of {len(rows)}")
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sides", nargs="*", type=int)
    ap.add_argument("--one-level", action="store_true",
                    help="the plan of a dense pattern at each side's n")
    ap.add_argument("--out", help="write the rows to this JSON file")
    ap.add_argument("--fit", nargs="+", metavar="ROWS",
                    help="fit the cost model to the rows of these files")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fit:
        runs = [json.load(open(p)) for p in args.fit]
        for p, run in zip(args.fit, runs):
            print(f"{p}: {run['card']}, {len(run['rows'])} rows")
        rows = [r for run in runs for r in run["rows"]]
        report_fit(rows, fit(rows))
        return 0

    import torch
    if args.device == "cpu":
        dev, card = torch.device("cpu"), "cpu"
    else:
        from chip_roofline import banner
        from ipmzoo_tpu_torch.ops import cuda_ldlt
        from ipmzoo_tpu_torch.utils.device import nvidia_smi
        dev = banner("chip_nd_crossover", "the crossover is measured")
        if dev is None:
            return 2
        card = nvidia_smi()
        # build K2-K5 (csrc/ldlt.cu) before the first side's budget starts
        t0 = time.perf_counter()
        cuda_ldlt._lib()
        print(f"ldlt.cu ready in {time.perf_counter() - t0:.1f} s",
              flush=True)
    rows = sweep(tuple(args.sides) or (
        ONE_LEVEL_SIDES if args.one_level else DEFAULT_SIDES), dev,
        args.one_level)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
