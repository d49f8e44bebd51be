"""Distributed block-separable QP via Schur complements over a mesh (the
PyTorch/CUDA port's twin of ``examples/distributed_schur.py``).

Runs the structure-parallel IPM: blocks shard across the ranks of the
process group, the coupling system is psum-assembled per iteration.  One
process is a one-rank mesh on the card; started as several ranks
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in each
process's environment) it spans them all, each rank on
``cuda:{rank % cards}`` (gloo where ranks share a card, NCCL where each
has its own).  The block count must divide the world.

    python examples/torch_distributed_schur.py [blocks] [block_size]
        [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ipmzoo_tpu_torch.parallel import distributed
from ipmzoo_tpu_torch.parallel.mesh import make_mesh
from ipmzoo_tpu_torch.parallel.schur import BlockQPData, SchurIPM


def main(blocks=64, n=16, device=None):
    """Join the process group (a no-op at one process), solve over a mesh
    of every rank, print as the reference does on the primary rank, and
    return the printed quantities as a dict."""
    m_c = 4
    # f32 data: at tol 1e-8 SchurIPM's two_float='auto' engages, as in the
    # reference (the port's two_float computes in float64)
    dtype = torch.float32
    tol = 1e-8

    distributed.initialize()
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    mesh = make_mesh(devices=None if device is None else [device] * world)
    dev = mesh.device

    rng = np.random.default_rng(0)
    M = rng.normal(size=(blocks, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)

    def arr(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    data = BlockQPData(
        Q=arr(Q),
        c=arr(rng.normal(size=(blocks, n))),
        F=arr(rng.normal(size=(blocks, m_c, n)) / blocks),
        l_x=torch.full((blocks, n), -3.0, dtype=dtype, device=dev),
        u_x=torch.full((blocks, n), 3.0, dtype=dtype, device=dev),
        g=arr(rng.normal(size=(m_c,)) * 0.1))

    ipm = SchurIPM(n, m_c, mesh=mesh, axis="dp", dtype=dtype, tol=tol)
    res = ipm.solve_sharded(data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    coupling = torch.einsum("bij,bj->i", data.F, res.x) - data.g
    out = {"backend": dev.type, "devices": world, "blocks": blocks, "n": n,
           "m_c": m_c, "converged": bool(res.converged),
           "iterations": int(res.iterations),
           "residual": float(res.residual), "gap": float(res.gap),
           "coupling": float(coupling.abs().max()),
           "two_float": ipm.two_float}
    if distributed.is_primary():
        print(f"backend: {out['backend']}, devices: {world}, "
              f"blocks: {blocks} x {n} vars, coupling rows: {m_c}")
        print(f"converged: {out['converged']} in {out['iterations']} "
              f"iterations; residual {out['residual']:.2e}, "
              f"gap {out['gap']:.2e}")
        print(f"coupling feasibility: {out['coupling']:.2e}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("blocks", nargs="?", type=int, default=64)
    p.add_argument("block_size", nargs="?", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="every rank's device (default: the rank's CUDA "
                        "card; 'cpu' without one)")
    a = p.parse_args()
    main(a.blocks, a.block_size, a.device)
    distributed.shutdown()
