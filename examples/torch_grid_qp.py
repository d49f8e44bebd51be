#!/usr/bin/env python
"""General-sparsity IPM via nested dissection on a 2D-grid QP (the
PyTorch/CUDA port's twin of ``examples/grid_qp.py``).

A box-constrained QP whose Hessian couples variables on a g x g grid
(5-point stencil — think discretised control/estimation fields).  The
KKT sparsity has small separators, so ``CompiledIPM(kernel="nd")`` plans
a nested-dissection block elimination (ops/ndiss.py): the separator tree
and symbolic fill are computed on the host once.  Its cost model then
decides, by the card's fitted constants, whether the plan beats the dense
auto rule; where it does not, the solver falls back to that rule's mode
(at the default side 24, n = 576, the card's fit picks 'blockg', where
the JAX package's constants keep nd).  The example prints the plan and
the path the solve took (``_mode``); ``--no-nd-fallback`` runs the nd
path itself.  Float64 at tol 1e-8.

    python examples/torch_grid_qp.py [grid_side] [leaf] [--no-nd-fallback]
        [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch

from ipmzoo_tpu_torch.models import CompiledIPM
from ipmzoo_tpu_torch.models.families import grid_qp
from ipmzoo_tpu_torch.utils import resolve_device


def _wall(dev, fn):
    t0 = time.time()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.time() - t0


def main(g=24, leaf=32, device=None, nd_fallback=True):
    """Solve with kernel="nd" and with the dense path, print as the
    reference does plus the path taken, and return the printed quantities
    as a dict."""
    dev = resolve_device(device)
    n = g * g
    dtype, tol = torch.float64, 1e-8
    fam = grid_qp(side=g, seed=0, dtype=dtype, device=dev)
    data = fam.data

    nd = CompiledIPM(fam.settings, n=n, dtype=dtype, tol=tol, kernel="nd",
                     nd_leaf=leaf, nd_fallback=nd_fallback, device=dev)
    res, t_nd = _wall(dev, lambda: nd.solve(data))   # derives the plan
    plan = nd._nd_plan
    ratio = plan.flops_dense / max(plan.flops_nd, 1)
    print(f"grid {g}x{g} (n={n}, {str(dtype).split('.')[-1]}, tol={tol:g}): "
          f"nested dissection, {len(plan.levels)} levels, "
          f"flop ratio dense/nd = {ratio:.1f}x")
    how = ("the nd plan" if nd._mode == "nd" else
           "the nd auto-fallback to the dense auto rule's mode")
    print(f"  path taken: '{nd._mode}' ({how})")
    print(f"  nd:    converged={bool(res.converged)} "
          f"iters={int(res.iterations)} gap={float(res.gap):.2e} "
          f"({t_nd:.1f}s incl. compile)")

    dense = CompiledIPM(fam.settings, n=n, dtype=dtype, tol=tol, device=dev)
    res_d, t_d = _wall(dev, lambda: dense.solve(data))
    dx = float((res.x - res_d.x).abs().max())
    print(f"  dense: converged={bool(res_d.converged)} "
          f"iters={int(res_d.iterations)} ({t_d:.1f}s incl. compile)")
    print(f"  max|x_nd - x_dense| = {dx:.2e}")
    return {"n": n, "levels": len(plan.levels), "flop_ratio": ratio,
            "mode": nd._mode, "dense_mode": dense._mode,
            "nd_converged": bool(res.converged),
            "nd_iterations": int(res.iterations), "nd_gap": float(res.gap),
            "dense_converged": bool(res_d.converged),
            "dense_iterations": int(res_d.iterations), "max_dx": dx,
            "nd_seconds": t_nd, "dense_seconds": t_d}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("grid_side", nargs="?", type=int, default=24)
    p.add_argument("leaf", nargs="?", type=int, default=32)
    p.add_argument("--no-nd-fallback", action="store_true",
                   help="run the nd plan whatever the cost model says")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' without one")
    a = p.parse_args()
    main(a.grid_side, a.leaf, a.device, not a.no_nd_fallback)
