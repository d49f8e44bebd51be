"""Batched Markowitz portfolio optimisation on the card (the PyTorch/CUDA
port's twin of ``examples/batch_portfolio.py``).

Solves a batch of independent portfolio QPs (different return/covariance
scenarios) with one batched solver, then prints summary statistics.  It
runs in float64 at tol 1e-8, the reference's choice on every backend but
a TPU; on the card the factorisations are kernels K2/K3.

    python examples/torch_batch_portfolio.py [batch] [n_assets] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ipmzoo_tpu_torch.models import CompiledIPM
from ipmzoo_tpu_torch.models.families import portfolio
from ipmzoo_tpu_torch.utils import Timer, resolve_device


def main(batch=1024, n_assets=32, device=None):
    """Solve, print as the reference does, and return the printed
    quantities and the sections' seconds as a dict."""
    dev = resolve_device(device)
    dtype, tol = torch.float64, 1e-8

    def block_until_ready():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t = Timer()
    with t.section("generate"):
        fam = portfolio(n_assets=n_assets, batch=batch, seed=0, dtype=dtype,
                        device=dev)
    with t.section("compile+first solve"):
        solver = CompiledIPM(fam.settings, n=fam.n, m_eq=fam.m_eq,
                             dtype=dtype, tol=tol, device=dev)
        res = solver.solve_batch(fam.data)
        block_until_ready()
    with t.section("steady-state solve"):
        res = solver.solve_batch(fam.data)
        block_until_ready()

    conv = float(res.converged.double().mean())
    iters = float(res.iterations.double().mean())
    gap = float(np.median(res.gap.cpu().numpy()))
    w = res.x
    w_min, w_max = float(w.min()), float(w.max())
    budget = float((w.sum(dim=-1) - 1).abs().max())
    print(f"backend: {dev.type}, batch={batch}, n_assets={n_assets}")
    print(f"converged: {conv * 100:.1f}%  "
          f"mean iterations: {iters:.1f}  "
          f"median gap: {gap:.2e}")
    print(f"weights: min {w_min:.4f}, max {w_max:.4f}, "
          f"budget residual {budget:.2e}")
    t.report()
    return {"backend": dev.type, "batch": batch, "n_assets": n_assets,
            "converged": conv, "mean_iterations": iters, "median_gap": gap,
            "w_min": w_min, "w_max": w_max, "budget_residual": budget,
            "seconds": {k: t.elapsed(k) for k in
                        ("generate", "compile+first solve",
                         "steady-state solve")}}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", type=int, default=1024)
    p.add_argument("n_assets", nargs="?", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' without one")
    a = p.parse_args()
    main(a.batch, a.n_assets, a.device)
