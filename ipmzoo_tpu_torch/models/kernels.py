"""Linear-solver staging for :class:`CompiledIPM`: KKT assembly and the
dense LDL^T factor-and-solve (counterpart of
:mod:`ipmzoo_tpu.models.kernels`, ``'ldlt'`` mode only).

The factorisation and the solves go through :mod:`..ops.cuda_ldlt`: the
CUDA kernels K2/K3 for CUDA tensors, their plain versions for CPU
tensors.  The reference's other kernel modes are not ported yet; the
constructor of :class:`CompiledIPM` rejects them.
"""

from __future__ import annotations

import torch

from ..symbolic import expr as E

from ..ops.cuda_ldlt import ldlt_auto, solve_ldlt_auto
from . import codegen as cg


class KernelDispatchMixin:
    """Factor/solve staging of the ``'ldlt'`` kernel mode."""

    def _assemble_blocks(self, env, B: int):
        """Each cell of the augmented system as a dense (B, si, sj)
        block."""
        memo = {}
        blocks = []
        for i in range(len(self.aug.variables)):
            si = self.aug_sizes[i]
            row_blocks = []
            for j in range(len(self.aug.variables)):
                sj = self.aug_sizes[j]
                cell = self.aug.lhs[i][j]
                if cell is E.ZERO:
                    row_blocks.append(torch.zeros(
                        (1, si, sj), dtype=self.dtype,
                        device=self.device).expand(B, si, sj))
                else:
                    row_blocks.append(
                        cg.as_block(cg.evaluate(cell, env, memo), si, sj))
            blocks.append(row_blocks)
        return blocks

    def _assemble_kkt(self, env, B: int) -> torch.Tensor:
        """The augmented KKT matrices, (B, aug_dim, aug_dim)."""
        rows = [torch.cat(rb, dim=-1) for rb in self._assemble_blocks(env, B)]
        return torch.cat(rows, dim=-2)

    def _make_solve_dense(self, env, B: int):
        """Factor the augmented KKT once; return solve(b) -> sol for
        b (B, aug_dim), with ``refine`` iterative-refinement sweeps."""
        K = self._assemble_kkt(env, B)
        L, D = ldlt_auto(K, self.pivot_floor)

        def solve(b):
            if b.shape[-1] == 0:
                return b
            sol = solve_ldlt_auto(L, D, b)
            for _ in range(self.refine):
                r = b - torch.matmul(K, sol.unsqueeze(-1)).squeeze(-1)
                sol = sol + solve_ldlt_auto(L, D, r)
            return sol

        return solve
