#!/usr/bin/env python
"""Structured banded+arrow IPM vs the dense path on a chain QP (the
PyTorch/CUDA port's twin of ``examples/arrow_chain.py``).

A chain of locally coupled decision variables plus a few global coupling
variables (banded+arrow Hessian) under box bounds: the structure
detector recovers (bandwidth, tip, permutation) from the dense matrix,
and ArrowIPM factors the condensed KKT in O(n (b+t)^2) per iteration —
block-tridiagonal cyclic reduction (kernels K6/K7 on the card) + a dense
tip Schur complement — instead of the dense path's O(n^3).  Float32 at
tol 1e-5.

    python examples/torch_arrow_chain.py [n] [bandwidth] [tip] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch

from ipmzoo_tpu_torch.models import ArrowIPM, ArrowQPData, CompiledIPM
from ipmzoo_tpu_torch.models.families import arrow_chain
from ipmzoo_tpu_torch.utils import resolve_device


def main(n=512, bandwidth=8, tip=4, device=None):
    """Solve with ArrowIPM and with the dense CompiledIPM, print as the
    reference does, and return the printed quantities as a dict."""
    dev = resolve_device(device)
    dtype = torch.float32

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fam = arrow_chain(n=n, bandwidth=bandwidth, tip=tip, seed=0,
                      dtype=dtype, device=dev)

    data, st, block = ArrowQPData.from_dense(
        fam.data.Q.cpu().numpy(), fam.data.c.cpu().numpy(),
        fam.data.l_x.cpu().numpy(), fam.data.u_x.cpu().numpy(),
        dtype=dtype, device=dev)
    print(f"detected structure: bandwidth={st.bandwidth} tip={st.tip} "
          f"(block size {block})")

    solver = ArrowIPM.for_data(data, structure=st, dtype=dtype, tol=1e-5)
    t0 = time.time()
    res = solver.solve(data)
    sync()
    t_s = time.time() - t0
    print(f"structured: converged={bool(res.converged)} in "
          f"{int(res.iterations)} iterations, "
          f"objective {float(res.objective):.6f} "
          f"({t_s:.2f}s incl. compile)")

    dense = CompiledIPM(fam.settings, n=fam.n, dtype=dtype, tol=1e-5,
                        device=dev)
    t0 = time.time()
    dres = dense.solve(fam.data)
    sync()
    t_d = time.time() - t0
    print(f"dense:      converged={bool(dres.converged)} in "
          f"{int(dres.iterations)} iterations, "
          f"objective {float(dres.objective):.6f} "
          f"({t_d:.2f}s incl. compile)")
    err = float((res.x - dres.x).abs().max())
    print(f"max |x_structured - x_dense| = {err:.2e}")
    return {"bandwidth": st.bandwidth, "tip": st.tip, "block": block,
            "converged": bool(res.converged),
            "iterations": int(res.iterations),
            "objective": float(res.objective),
            "dense_converged": bool(dres.converged),
            "dense_iterations": int(dres.iterations),
            "dense_objective": float(dres.objective),
            "dense_mode": dense._mode, "max_dx": err,
            "structured_seconds": t_s, "dense_seconds": t_d}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=512)
    p.add_argument("bandwidth", nargs="?", type=int, default=8)
    p.add_argument("tip", nargs="?", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' without one")
    a = p.parse_args()
    main(a.n, a.bandwidth, a.tip, a.device)
