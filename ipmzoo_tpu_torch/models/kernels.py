"""Linear-solver staging for :class:`CompiledIPM`: KKT assembly, the
dense LDL^T factor-and-solve and the nested-dissection factor-and-solve
(counterpart of :mod:`ipmzoo_tpu.models.kernels`, modes ``'ldlt'`` and
``'nd'``).

The dense factorisation and solves go through :mod:`..ops.cuda_ldlt`:
the CUDA kernels K2/K3 for CUDA tensors, their plain versions for CPU
tensors.  The ``'nd'`` mode factors along a dissection plan
(:mod:`..ops.ndiss`: K5 per level, K3 in the solves).  The reference's
other kernel modes are not ported yet; the constructor of
:class:`CompiledIPM` rejects them.
"""

from __future__ import annotations

import torch

from ..symbolic import expr as E

from ..ops.cuda_ldlt import ldlt_auto, solve_ldlt_auto
from . import codegen as cg


class KernelDispatchMixin:
    """Factor/solve staging of the ``'ldlt'`` and ``'nd'`` kernel modes."""

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

    def _refined(self, solve_once, K):
        """``solve_once`` followed by ``refine`` iterative-refinement
        sweeps against K (assembled by ``K()`` only if any are asked
        for)."""
        Kmat = K() if self.refine else None

        def solve(b):
            if b.shape[-1] == 0:
                return b
            sol = solve_once(b)
            for _ in range(self.refine):
                r = b - torch.matmul(Kmat, sol.unsqueeze(-1)).squeeze(-1)
                sol = sol + solve_once(r)
            return sol

        return solve

    def _make_solve(self, env, B: int, nd_pre=None):
        """Factor the augmented KKT once by the solver's kernel mode;
        return solve(b) -> sol for b (B, aug_dim)."""
        if self._mode != "nd":
            return self._make_solve_dense(env, B)
        from ..ops.ndiss import nd_factor, nd_factor_pre, nd_solve
        if self._nd_plan is None:
            raise RuntimeError(
                "kernel='nd' has no dissection plan; pass nd_pattern= "
                "to the constructor or call solve()/solve_batch() "
                "(which derive it from the data) before step()")
        plan = self._nd_plan
        if nd_pre is not None:
            # IPM iterations only change the KKT's DIAGONAL (barrier
            # terms; validated numerically at plan time,
            # _check_nd_diag_split).  The loop-invariant slabs were
            # extracted OUTSIDE the solver loop (_nd_prework); the
            # in-loop factorisation consumes them plus the
            # per-iteration barrier diagonal only.
            pre, diag_ref = nd_pre
            w = self._assemble_diag(env, B) - diag_ref
            factors = nd_factor_pre(pre, plan, diag_delta=w,
                                    pivot_floor=self.pivot_floor)

            def K():
                return self._assemble_kkt(env, B)
        else:
            Kmat = self._assemble_kkt(env, B)
            factors = nd_factor(Kmat, plan, self.pivot_floor)

            def K():
                return Kmat
        return self._refined(lambda b: nd_solve(plan, factors, b), K)

    def _nd_ref_env(self, env):
        """Reference environment for the nd diagonal split: variables
        bound to the same data-derived strictly-interior point
        init_state uses (bound midpoints for x/s — ones would sit ON a
        bound whenever a bound equals 1, blowing the barrier inverses),
        mu to a constant.  Everything depends only on the data, so the
        KKT assembled against it is loop-invariant."""
        o = self.symbols
        B = env[o.Q].val.shape[0]
        renv = dict(env)
        mids = {}
        if o.x in self.var_index:
            mids[o.x] = 0.5 * (env[o.l_x].val + env[o.u_x].val)
        if o.s_A_ineq in self.var_index:
            mids[o.s_A_ineq] = 0.5 * (env[o.l_A_ineq].val +
                                      env[o.u_A_ineq].val)
        for var, sz in zip(self.full.variables, self.var_sizes):
            renv[var] = cg.vector(mids.get(var, self._ones(B, sz)))
        renv[o.mu] = cg.scalar(self._bscalar(1.0, B))
        return renv

    def _assemble_diag(self, env, B: int) -> torch.Tensor:
        """Concatenated diagonal (B, aug_dim) of the augmented system's
        diagonal cells (the only cells an IPM iteration changes when the
        nd diagonal split is valid).  The diagonal of a sum is taken
        term by term, in the order the dense assembly adds them, so no
        cell is materialised and the values are the dense assembly's."""
        memo = {}
        parts = []
        for i, si in enumerate(self.aug_sizes):
            cell = self.aug.lhs[i][i]
            if cell is E.ZERO:
                parts.append(torch.zeros((B, si), dtype=self.dtype,
                                         device=self.device))
                continue
            terms = cell.terms if cell.kind == E.Kind.SUM else (cell,)
            acc = cg.evaluate(terms[0], env, memo)
            for t in terms[1:]:
                acc = cg.add_tv(cg.diagonal_tv(acc),
                                cg.diagonal_tv(cg.evaluate(t, env, memo)))
            acc = cg.diagonal_tv(acc)
            if acc.tag == "scalar":
                parts.append(self._bscalar(acc.val, B)[:, None]
                             .expand(B, si))
            else:
                parts.append(cg.as_vector(acc, si))
        return torch.cat(parts, dim=-1)

    def _make_solve_dense(self, env, B: int):
        """Factor the augmented KKT once; return solve(b) -> sol for
        b (B, aug_dim), with ``refine`` iterative-refinement sweeps."""
        K = self._assemble_kkt(env, B)
        L, D = ldlt_auto(K, self.pivot_floor)
        return self._refined(lambda b: solve_ldlt_auto(L, D, b), lambda: K)
