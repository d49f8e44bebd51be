"""Linear-solver staging for :class:`CompiledIPM`: KKT assembly from the
consumed reduction, the kernel-mode dispatch (``_make_solve``) and the
dense-matrix-inverse binding the normal-equations reduction needs
(counterpart of :mod:`ipmzoo_tpu.models.kernels`; its two-float mode
``'tf'`` is a float64 solver of these modes here, ``CompiledIPM._tf``).

The modes:

- ``'ldlt'``: dense LDL^T of the assembled reduction by
  :mod:`..ops.cuda_ldlt` (K2/K3 on the card, the panel-blocked path of
  :mod:`..ops.blocked_ldlt` above the orders :func:`ldlt_route` gives
  it; the plain versions on CPU tensors) at any pivot floor, or by
  ``ldlt_blocked`` with library triangular solves for ``kernel='jnp'``;
- ``'regldlt'``: that factor of K + delta diag(signs), refined against K;
- ``'lu'``: batched partial-pivoting LU (library);
- ``'block'`` / ``'blockg'``: block Cholesky elimination of the 2x2 /
  G x G augmented system (:mod:`..ops.block_solve`, :mod:`..ops.blockg`);
- ``'normal'``: the panel-blocked LDL^T of the normal equations (K2 on
  its panels), with each dense H^-1 bound once per iteration;
- ``'nd'``: nested dissection along a plan (:mod:`..ops.ndiss`: K5 per
  level, K3 in the solves);
- ``'sharded'``: the panel-sharded LDL^T of the identity-padded system
  over a mesh axis (:mod:`..ops.sharded_ldlt`: K2 on the diagonal
  panels), each rank factoring its rows of the whole K it assembles.

With ``hybrid_refine`` every refinement sweep computes b - K x in
float64 against the assembled K (the reference's compensated two-float
residual), rounded to the working dtype.
"""

from __future__ import annotations

import torch

from ..symbolic import expr as E

from . import codegen as cg


class KernelDispatchMixin:
    """Factor/solve staging shared by every CompiledIPM kernel mode."""

    def _collect_matrix_inverts(self):
        """All distinct Invert subexpressions over dense-matrix operands
        in the condensed system (lhs cells, rhs, delta definitions).

        Eliminating the leading Q/x block introduces H^-1 with
        H = aug.lhs[0][0] (a Sum containing the symmetric matrix Q);
        elementwise inversion is unsound for those, so the solver binds a
        factored inverse per iteration instead."""
        K = E.Kind
        seen, out = set(), []
        hm_memo = {}

        def has_matrix(e):
            # memoised: the expression DAG is hash-consed with heavy
            # sharing, so unmemoised recursion is exponential
            hit = hm_memo.get(e)
            if hit is not None:
                return hit
            r = (e.kind in (K.MATRIX, K.SYMMETRIC_MATRIX) or
                 any(has_matrix(c) for c in e.children))
            hm_memo[e] = r
            return r

        def walk(e):
            if e in seen:
                return
            seen.add(e)
            if E.is_invert(e) and has_matrix(e.child):
                out.append(e)
            for c in e.children:
                walk(c)

        for row in self.red.lhs:
            for cell in row:
                walk(cell)
        for r in self.red.rhs:
            walk(r)
        for _, d in self.red.delta_definitions:
            walk(d)
        return out

    def _bind_matrix_inverts(self, env) -> None:
        """Evaluate each dense-matrix inverse once (panel-blocked LDL^T
        with the pivot floor, solved against I) and bind it into ``env``
        IN PLACE, so every later evaluation of the condensed system this
        iteration short-circuits on the env hit."""
        from ..ops.blocked_ldlt import ldlt_blocked, solve_ldlt_matrix_blocked
        for ie in self._matrix_inverts:
            if ie in env:
                continue
            child = cg.evaluate(ie.child, env, {})
            if child.tag != "matrix":
                env[ie] = cg.invert_tv(child)
                continue
            H = child.val
            L, D = ldlt_blocked(H, self.pivot_floor)
            eye = torch.eye(H.shape[-1], dtype=H.dtype,
                            device=H.device).expand_as(H)
            env[ie] = cg.matrix(solve_ldlt_matrix_blocked(L, D, eye))

    def _assemble_blocks(self, env, B: int):
        """Each cell of the consumed reduction (the augmented system, or
        the condensed normal equations for kernel='normal') as a dense
        (B, si, sj) block."""
        memo = {}
        blocks = []
        for i in range(len(self.red.variables)):
            si = self.red_sizes[i]
            row_blocks = []
            for j in range(len(self.red.variables)):
                sj = self.red_sizes[j]
                cell = self.red.lhs[i][j]
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
        """The consumed reduction's matrices, (B, red_dim, red_dim)."""
        rows = [torch.cat(rb, dim=-1) for rb in self._assemble_blocks(env, B)]
        return torch.cat(rows, dim=-2)

    def _refined(self, solve_once, K, sweeps=None, matvec=None):
        """``solve_once`` followed by ``sweeps`` (default ``refine``)
        iterative-refinement sweeps against K (assembled by ``K()`` only
        if any are asked for), or against ``matvec`` where given and
        ``hybrid_refine`` is off."""
        sweeps = self.refine if sweeps is None else sweeps
        if sweeps and self.hybrid_refine:
            K64 = K().to(torch.float64)

            def resid(b, x):
                r = b.to(torch.float64) - torch.matmul(
                    K64, x.to(torch.float64).unsqueeze(-1)).squeeze(-1)
                return r.to(b.dtype)
        elif sweeps:
            if matvec is None:
                Kmat = K()

                def matvec(x):
                    return torch.matmul(Kmat, x.unsqueeze(-1)).squeeze(-1)

            def resid(b, x):
                return b - matvec(x)

        def solve(b):
            if b.shape[-1] == 0:
                return b
            sol = solve_once(b)
            for _ in range(sweeps):
                sol = sol + solve_once(resid(b, sol))
            return sol

        return solve

    def _make_solve(self, env, B: int, nd_pre=None):
        """Factor the consumed reduction once by the solver's kernel
        mode; return solve(b) -> sol for b (B, red_dim)."""
        mode = self._mode
        if mode == "nd":
            return self._make_solve_nd(env, B, nd_pre)
        if mode == "sharded":
            return self._make_solve_sharded(env, B)
        if mode == "lu":
            K = self._assemble_kkt(env, B)
            LU, piv, _ = torch.linalg.lu_factor_ex(K)
            return self._refined(
                lambda b: torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0],
                lambda: K)
        if mode == "regldlt":
            # signed proximal regularisation K + delta diag(signs): the
            # perturbed system is quasi-definite (Vanderbei 1995), so the
            # unpivoted LDL^T is sound; refinement against the TRUE K
            # removes the O(delta) perturbation.  delta per instance, as
            # the reference computes it under vmap.
            K = self._assemble_kkt(env, B)
            eps = torch.finfo(self.dtype).eps
            scale = K.diagonal(dim1=-2, dim2=-1).abs().amax(-1).clamp(min=1.0)
            delta = eps ** (2.0 / 3.0) * scale
            signs = torch.as_tensor(self._sign_vec, dtype=self.dtype,
                                    device=self.device)
            L, D = self._factor(K + torch.diag_embed(delta[:, None] * signs))
            return self._refined(lambda b: self._solve_kernel(L, D, b),
                                 lambda: K, sweeps=max(self.refine, 3))
        if mode == "blockg":
            from ..ops.blockg import blockg_factor, blockg_matvec, blockg_solve
            blocks = self._assemble_blocks(env, B)
            factors = blockg_factor(blocks, self.group_signs)
            sizes = self.red_sizes

            def matvec(x):
                parts = torch.split(x, sizes, dim=-1)
                return torch.cat(blockg_matvec(blocks, parts), dim=-1)

            return self._refined(lambda b: blockg_solve(factors, b),
                                 lambda: self._assemble_kkt(env, B),
                                 matvec=matvec)
        if mode == "block":
            from ..ops.block_solve import (block2_factor, block2_factor_inv,
                                           block2_matvec, block2_solve,
                                           block2_solve_inv)
            blocks = self._assemble_blocks(env, B)
            H, Bm, C = blocks[0][0], blocks[1][0], -blocks[1][1]
            if self._block_inv:
                # explicit H^-1 / S^-1: one n-rhs solve pair up front, so
                # the direction solves of the iteration are products
                factors = block2_factor_inv(H, Bm, C)
                solve2 = block2_solve_inv
            else:
                factors = block2_factor(H, Bm, C)
                solve2 = block2_solve
            n1 = self.red_sizes[0]

            def once(b):
                return torch.cat(solve2(factors, b[:, :n1], b[:, n1:]),
                                 dim=-1)

            def matvec(x):
                return torch.cat(block2_matvec(H, Bm, C, x[:, :n1],
                                               x[:, n1:]), dim=-1)

            return self._refined(once, lambda: self._assemble_kkt(env, B),
                                 matvec=matvec)
        if mode == "normal":
            # bind H^-1 first (mutates env: the residual / corrector envs
            # derive from this env by dict copy, so the binding reaches
            # every rhs and back-substitution of this iteration)
            self._bind_matrix_inverts(env)
        return self._make_solve_dense(env, B)

    def _make_solve_sharded(self, env, B: int):
        """Every rank assembles the whole K (the reference's replicated
        input), factors its rows of blockdiag(K, I) over the mesh axis and
        solves with the refinement sweeps against the unpadded K.  Every
        rank returns the same bits: the stop test reads only them."""
        from ..ops.sharded_ldlt import sharded_ldlt, sharded_ldlt_solve
        from ..parallel.mesh import shard_slice
        mesh, axis, panel = self._mesh, self._mesh_axis, self._sharded_panel
        K = self._assemble_kkt(env, B)
        dim, pdim = self.red_dim, self._sharded_dim
        sl = shard_slice(pdim, mesh, axis)
        K_loc = K.new_zeros((B, sl.stop - sl.start, pdim))
        top = min(max(dim, sl.start), sl.stop)   # the rank's last row of K
        K_loc[:, :top - sl.start, :dim] = K[:, sl.start:top]
        pad = torch.arange(top, sl.stop, device=K.device)
        K_loc[:, pad - sl.start, pad] = 1.0
        factors = sharded_ldlt(K_loc, mesh, axis, panel, self.pivot_floor)

        def once(b):
            bp = torch.nn.functional.pad(b, (0, pdim - dim))
            return sharded_ldlt_solve(factors, bp, mesh, axis,
                                      panel)[:, :dim]

        return self._refined(once, lambda: K)

    def _make_solve_nd(self, env, B: int, nd_pre):
        """The nested-dissection factor and solve along the plan."""
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
        """Concatenated diagonal (B, red_dim) of the consumed reduction's
        diagonal cells (the only cells an IPM iteration changes when the
        nd diagonal split is valid).  The diagonal of a sum is taken
        term by term, in the order the dense assembly adds them, so no
        cell is materialised and the values are the dense assembly's."""
        memo = {}
        parts = []
        for i, si in enumerate(self.red_sizes):
            cell = self.red.lhs[i][i]
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
        """Factor the assembled reduction once (the default path; also
        consumes the bound H^-1 of mode 'normal'); return solve(b) -> sol
        for b (B, red_dim), with ``refine`` iterative-refinement
        sweeps."""
        K = self._assemble_kkt(env, B)
        L, D = self._factor(K)
        return self._refined(lambda b: self._solve_kernel(L, D, b),
                             lambda: K)
