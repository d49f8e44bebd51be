"""Search-direction staging for :class:`CompiledIPM` (counterpart of
:mod:`ipmzoo_tpu.models.directions`): residual environments (predictor,
corrector with the exact quadratic Taylor remainder, Gondzio
centrality-corrector rounds), the packed solve with symbolic
back-substitution, and the fraction-to-boundary ratio tests, all on a
leading batch axis.  Per-instance step lengths are (B,) tensors.
"""

from __future__ import annotations

import torch

from ..formulations import delta_variable
from ..symbolic import expr as E

from . import codegen as cg


class DirectionsMixin:
    """Residual/corrector environments, solves, and line search."""

    def _build_symbolic_corrector(self):
        """Exact quadratic Taylor remainder of each complementarity row
        as a simplified expression in the affine-delta symbols:

            rem_i = simplify(def_i(v + Delta) - def_i(v)
                             - sum_j lhs[i][j] Delta_j)
        """
        rems = {}
        for i, (vec, definition, comp) in enumerate(self.corrector):
            if not comp:
                continue
            shifted = definition
            for v in self.full.variables:
                shifted = shifted.replace(
                    v, E.sum_expr([v, delta_variable(v)]))
            terms = [shifted, E.negate(definition)]
            for j, vj in enumerate(self.full.variables):
                cell = self.full.lhs[i][j]
                if cell is E.ZERO:
                    continue
                terms.append(E.negate(E.product([cell,
                                                 delta_variable(vj)])))
            rems[vec] = E.sum_expr(terms).simplify()
        return rems

    def _residual_env(self, env, mu_val, data=None, var_vals=None,
                      affine_deltas=None):
        """Bind the shorthand residual vectors r_{v} into a new env.

        With ``affine_deltas`` given, complementarity residuals get the
        exact second-order Mehrotra correction
        ``c_i(v + d_aff) - c_i(v) - J_i d_aff`` added (corrector phase).

        ``env`` must be of the residual pipeline's dtype: lifted
        (``_lift``) under df_residuals."""
        B = env[self.symbols.Q].val.shape[0]
        rdt = self._rdt
        renv = dict(env)
        renv[self.symbols.mu] = cg.scalar(self._bscalar(mu_val, B, rdt))
        memo = {}

        corr_vals = None
        if affine_deltas is not None and self.corrector_rem is not None:
            # taylor="symbolic": one evaluation of the staged remainder
            corr_vals = {}
            cenv = dict(env)
            cenv[self.symbols.mu] = cg.scalar(self._bscalar(0.0, B, rdt))
            for var, dj in zip(self.full.variables, affine_deltas):
                cenv[delta_variable(var)] = cg.vector(dj.to(rdt))
            cmemo = {}
            for vec, rem in self.corrector_rem.items():
                corr_vals[vec] = cg.evaluate(rem, cenv, cmemo)
        elif affine_deltas is not None:
            corr_vals = {}
            aff_point = tuple(v + d for v, d in
                              zip(var_vals, affine_deltas))
            aenv = self._envm(data, aff_point, 0.0)
            benv = self._envm(data, var_vals, 0.0)
            amemo, bmemo, jmemo = {}, {}, {}
            for i, (vec, definition, comp) in enumerate(self.corrector):
                if not comp:
                    continue
                c_shift = cg.evaluate(definition, aenv, amemo)
                c_base = cg.evaluate(definition, benv, bmemo)
                lin = None
                for j, dj in enumerate(affine_deltas):
                    cell = self.full.lhs[i][j]
                    if cell is E.ZERO or dj.shape[-1] == 0:
                        continue
                    term = cg.multiply_tv(cg.evaluate(cell, env, jmemo),
                                          cg.vector(dj.to(rdt)))
                    lin = term if lin is None else cg.add_tv(lin, term)
                corr = cg.add_tv(c_shift, cg.negate_tv(c_base))
                if lin is not None:
                    corr = cg.add_tv(corr, cg.negate_tv(lin))
                corr_vals[vec] = corr

        for (vec, definition, comp) in self.corrector:
            val = cg.evaluate(definition, renv, memo)
            if corr_vals is not None and vec in corr_vals:
                val = cg.add_tv(val, corr_vals[vec])
            renv[vec] = val
        return renv

    def _search_direction(self, solve_fn, renv):
        """Solve the consumed reduction (the augmented system, or the
        normal equations) and back-substitute eliminated variables via
        the symbolic delta definitions.  The right-hand side and the
        back-substitutions are evaluated in the residual pipeline's dtype
        and rounded to the working dtype (the reference's
        ``as_vector_arr``), the solve runs in the working dtype."""
        dt, rdt = self.dtype, self._rdt
        memo = {}
        parts = [cg.as_vector(cg.evaluate(r, renv, memo), sz)
                 for r, sz in zip(self.red.rhs, self.red_sizes)]
        sol = solve_fn(torch.cat(parts, dim=-1).to(dt))

        deltas = [None] * len(self.full.variables)
        denv = dict(renv)
        offset = 0
        for var, sz in zip(self.red.variables, self.red_sizes):
            val = sol[:, offset:offset + sz]
            offset += sz
            deltas[self.var_index[var]] = val
            denv[delta_variable(var)] = cg.vector(val.to(rdt))
        memo2 = {}
        for dvar, ddef in reversed(self.red.delta_definitions):
            var = self.delta_to_var[dvar]
            val = cg.as_vector(cg.evaluate(ddef, denv, memo2),
                               self.size_of[var]).to(dt)
            denv[dvar] = cg.vector(val.to(rdt))
            deltas[self.var_index[var]] = val
        return deltas

    def _max_step(self, env, var_vals, deltas):
        """Per-instance fraction-to-boundary step (B,): the largest
        alpha <= 1 keeping nonnegative variables (and, for Slacks
        handling, the explicit boxes) feasible.  The test runs on the
        values rounded to the scalar dtype, and alpha is of that dtype
        (the reference's ``_var_val`` under two_float)."""
        sd = self._sdt
        alpha = torch.ones(var_vals[0].shape[0], dtype=sd,
                           device=self.device)

        def clip(alpha, num, d, neg: bool):
            # min over the group of num / d where d points at the
            # boundary; an empty group leaves alpha unchanged (the
            # reference's min(..., initial=inf))
            if d.shape[-1] == 0:
                return alpha
            moving = d < 0 if neg else d > 0
            safe = torch.where(moving, d, torch.full_like(
                d, -1.0 if neg else 1.0))
            ratio = torch.where(moving, num / safe,
                                torch.full_like(d, float("inf")))
            return torch.minimum(alpha, ratio.amin(dim=-1))

        for i in self.nonneg_idx:
            alpha = clip(alpha, -var_vals[i].to(sd), deltas[i].to(sd),
                         neg=True)
        if self.box_test:
            o = self.symbols
            checks = []
            if o.x in self.var_index:
                checks.append((o.x, o.l_x if self.x_has_lb else None,
                               o.u_x if self.x_has_ub else None))
            if o.s_A_ineq in self.var_index:
                checks.append((o.s_A_ineq,
                               o.l_A_ineq if self.s_has_lb else None,
                               o.u_A_ineq if self.s_has_ub else None))
            for var, lb_sym, ub_sym in checks:
                i = self.var_index[var]
                v, d = var_vals[i].to(sd), deltas[i].to(sd)
                if lb_sym is not None:
                    alpha = clip(alpha, env[lb_sym].val.to(sd) - v, d,
                                 neg=True)
                if ub_sym is not None:
                    alpha = clip(alpha, env[ub_sym].val.to(sd) - v, d,
                                 neg=False)
        return alpha

    def _gondzio_round(self, env, data, var_vals, solve_fn, d, alpha,
                       mu_target, beta_min=0.1, beta_max=10.0,
                       delta_alpha=0.1, gamma=0.1):
        """One Gondzio centrality-corrector round (Gondzio 1996).

        At the enlarged trial step, complementarity products outside
        [beta_min, beta_max] * mu are pulled back to the nearest bound by
        an extra solve with the existing factors.  The corrected
        direction is kept, per instance, only if it lengthens the
        step.  ``env`` is of the residual pipeline's dtype; the products
        and their targets are rounded to the scalar dtype (the
        reference's ``as_vector_arr``)."""
        sd, rdt = self._sdt, self._rdt
        alpha_t = torch.clamp(alpha + delta_alpha, max=1.0)
        tenv = self._envm(data, self._axpy(var_vals, alpha_t, d), 0.0)

        # residual-vector bindings: comp rows get (p - clip(p)), others 0
        genv = dict(env)
        memo = {}
        mu_t = mu_target.to(sd)
        lo = (beta_min * mu_t)[:, None]
        hi = (beta_max * mu_t)[:, None]
        B = alpha.shape[0]
        for i, (vec, definition, comp) in enumerate(self.corrector):
            sz = self.var_sizes[i]
            if comp and sz:
                p = cg.as_vector(cg.evaluate(definition, tenv, memo),
                                 sz).to(sd)
                genv[vec] = cg.vector(
                    (p - torch.clamp(p, min=lo, max=hi)).to(rdt))
            else:
                genv[vec] = cg.vector(torch.zeros(
                    (B, sz), dtype=rdt, device=self.device))
        dm = self._search_direction(solve_fn, genv)

        d_new = tuple(dv + dmv for dv, dmv in zip(d, dm))
        alpha_new = self._max_step(env, var_vals, d_new)
        accept = alpha_new >= torch.clamp(alpha + gamma * delta_alpha,
                                          max=1.0)
        d_out = tuple(torch.where(accept[:, None], dn, dv)
                      for dn, dv in zip(d_new, d))
        return d_out, torch.where(accept, alpha_new, alpha)
