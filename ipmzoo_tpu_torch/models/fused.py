"""The fused whole-solve engine: the entire Mehrotra IPM of each instance
in one kernel launch (counterpart of :mod:`ipmzoo_tpu.models.fused`).

``FusedBatchedIPM.solve_fused`` runs kernel K1 for CUDA tensors: each QP
instance reads its data once and runs every iteration (KKT assembly,
in-place LDL^T, predictor, ratio tests, centering, corrector, Gondzio
rounds, update, convergence test) without returning to the host, on one
of four routes that ``ops/cuda_fused.k1_route`` picks per launch: a
thread per instance (``csrc/fused_ipm.cuh``), a team of 16 or 32 lanes
per instance with its state in shared memory (``csrc/fused_team.cuh``),
or, above augmented order 128 where four teams do not fit a block, a warp
per instance with its state in device memory (``csrc/fused_wide.cuh``)
or a thread block per instance with its factor and work vectors in shared
memory (``csrc/fused_wide_block.cuh``).
For CPU tensors it runs K1's plain version, :meth:`_fused_plain`, which
evaluates the same steps on the whole batch with the batch on the
trailing axis (SoA), as the reference's kernel body does for a tile.

Both are generated from the symbolic derivation that ``CompiledIPM``
uses.  The pieces below that evaluate the derived expressions (metrics,
residual environments with the Taylor corrector, the augmented
right-hand side, back-substitution, Gondzio targets) take an emitter:
:class:`.codegen_soa.TorchSoA` runs them on tensors, and
:mod:`.fused_source` passes :class:`.codegen_soa.CppSoA` to print them as
K1's generated C++ (:class:`.codegen_team.CppTeam` for the team, wide
and block routes).
The hand-written parts (the LDL^T, the ratio tests, the step and the
loop) are written here in torch and for each route in its header.

Converged instances are frozen: their state re-enters unchanged, so a
lane's result does not depend on the other lanes of its batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..formulations import Settings, delta_variable
from ..symbolic import expr as E

from ..ops import cuda_fused
from . import codegen_soa as soa
from .data import QPData
from .fused_compact import FusedCompactMixin
from .fused_source import fused_source, fused_team_source, \
    fused_wide_block_source, fused_wide_source, team_slots
from .ipm import CompiledIPM
from .state import tree_map

#: the QPData fields, in the order of the kernel's data arguments
DATA_FIELDS = ("Q", "c", "A_ineq", "l_A_ineq", "u_A_ineq", "A_eq", "b_eq",
               "l_x", "u_x")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# SoA dense LDL^T, plain version of the kernel's in-place factor and solve
# ---------------------------------------------------------------------------

def _ldlt_soa(K: torch.Tensor, pivot_floor: float):
    """Factor K (N, N, B): L strictly below the diagonal of a copy of K,
    D (N, B).  The column algorithm of the reference's
    ``_ldlt_into_refs``; only an exactly-zero pivot is floored."""
    n = K.shape[0]
    L = K.clone()
    D = torch.ones_like(K[:, 0, :])
    floor = torch.tensor(pivot_floor, dtype=K.dtype, device=K.device)
    for j in range(n):
        if j == 0:
            d = L[0, 0, :]
        else:
            lj = L[j, 0:j, :]
            w = lj * D[0:j, :]
            d = L[j, j, :] - torch.sum(lj * w, dim=0)
        d = torch.where(d == 0, floor, d)
        D[j, :] = d
        if j + 1 < n:
            if j == 0:
                L[1:n, 0, :] = L[1:n, 0, :] / d[None, :]
            else:
                s = torch.sum(L[j + 1:n, 0:j, :] * w[None, :, :], dim=1)
                L[j + 1:n, j, :] = (L[j + 1:n, j, :] - s) / d[None, :]
    return L, D


def _solve_soa(L: torch.Tensor, D: torch.Tensor, b: torch.Tensor):
    """Solve L D L^T x = b for b (N, B) against :func:`_ldlt_soa`'s
    factors (the reference's ``_solve_from_refs``)."""
    n = b.shape[0]
    x = b.clone()
    for j in range(n - 1):
        x[j + 1:n, :] = x[j + 1:n, :] - L[j + 1:n, j, :] * x[j, :][None, :]
    x = x / D
    for i in range(n - 2, -1, -1):
        s = torch.sum(L[i + 1:n, i, :] * x[i + 1:n, :], dim=0)
        x[i, :] = x[i, :] - s
    return x


# ---------------------------------------------------------------------------
# Fused solver
# ---------------------------------------------------------------------------

class FusedBatchedIPM(FusedCompactMixin, CompiledIPM):
    """Whole-solve variant of :class:`CompiledIPM` for batched small QPs.
    ``solve_fused(batched QPData)`` returns the reference's dict of
    tensors.

    ``dtype`` defaults to float32.  ``bt`` is the reference's tile size;
    here it sets only the replicate-padding granularity of the public
    entries and the capacities of the compaction stages, so that every
    stage gathers the same instances as the reference.  It is not a CUDA
    block size.  The Gondzio safety-net tail and the float64 escalation
    run the base class's dense LDL^T, ``ldlt_auto``: the column LDL^T
    (kernels K2/K3 on the card) up to order 128 and above it the
    panel-blocked LDL^T (its diagonal panels on K2), which is what the
    reference's ``kernel="jnp"`` tail computes at every order."""

    def __init__(self, settings: Settings, n: int, m_ineq: int = 0,
                 m_eq: int = 0, *, bt: int = 512, **kw):
        kw.setdefault("dtype", torch.float32)
        kw.setdefault("kernel", "ldlt")
        super().__init__(settings, n, m_ineq, m_eq, **kw)
        self.bt = bt
        #: K1's generated sources, by route, and its team code's slots
        self._kernel_sources: dict = {}
        self._k1_slots: Optional[int] = None
        #: generated sources of the fused-iteration prefixes (kernel T3,
        #: ``models/fused_phases.py``), by prefix
        self._phase_sources: dict = {}

    # -- pieces generated from the derivation (shared by both emitters) --

    def _metrics_soa(self, ev, env0):
        """(residual norm, duality measure) of the full system."""
        memo = {}
        vals = [soa.as_vector(ev, soa.evaluate(ev, r, env0, memo), sz)
                for r, sz in zip(self.full.rhs, self.var_sizes)]
        sq = ev.zero_scalar()
        for v in vals:
            if ev.size(v):
                sq = ev.add(sq, ev.sum_sq(v))
        residual = ev.sqrt(sq)
        if self.comp_size == 0:
            return residual, ev.zero_scalar()
        acc = ev.zero_scalar()
        for i in self.comp_rows:
            if ev.size(vals[i]):
                acc = ev.add(acc, ev.sum_abs(vals[i]))
        return residual, ev.div_const(acc, self.comp_size)

    def _residual_env_soa(self, ev, make_env, env, mu_val, var_vals=None,
                          affine_deltas=None):
        """Bind the shorthand residual vectors; with ``affine_deltas`` the
        complementarity rows get the Taylor remainder
        c(v + d_aff) - c(v) - J d_aff (corrector)."""
        o = self.symbols
        renv = dict(env)
        renv[o.mu] = soa.scalar(mu_val)
        memo = {}
        corr_vals = None
        if affine_deltas is not None and self.corrector_rem is not None:
            # taylor="symbolic": one evaluation of the staged remainder
            corr_vals = {}
            cenv = dict(env)
            cenv[o.mu] = soa.scalar(ev.zero_scalar())
            for var, dj in zip(self.full.variables, affine_deltas):
                cenv[delta_variable(var)] = soa.vector(dj)
            cmemo = {}
            for vec, rem in self.corrector_rem.items():
                corr_vals[vec] = soa.evaluate(ev, rem, cenv, cmemo)
        elif affine_deltas is not None:
            corr_vals = {}
            zero_mu = ev.zero_scalar()
            aff_point = tuple(ev.add(v, d) for v, d in zip(var_vals,
                                                           affine_deltas))
            aenv = make_env(aff_point, zero_mu)
            benv = make_env(var_vals, zero_mu)
            amemo, bmemo, jmemo = {}, {}, {}
            for i, (vec, definition, comp) in enumerate(self.corrector):
                if not comp:
                    continue
                c_shift = soa.evaluate(ev, definition, aenv, amemo)
                c_base = soa.evaluate(ev, definition, benv, bmemo)
                lin = None
                for j, dj in enumerate(affine_deltas):
                    cell = self.full.lhs[i][j]
                    if cell is E.ZERO or ev.size(dj) == 0:
                        continue
                    term = soa.multiply_tv(
                        ev, soa.evaluate(ev, cell, env, jmemo),
                        soa.vector(dj))
                    lin = term if lin is None else soa.add_tv(ev, lin, term)
                corr = soa.add_tv(ev, c_shift, soa.negate_tv(ev, c_base))
                if lin is not None:
                    corr = soa.add_tv(ev, corr, soa.negate_tv(ev, lin))
                corr_vals[vec] = corr
        for (vec, definition, comp) in self.corrector:
            val = soa.evaluate(ev, definition, renv, memo)
            if corr_vals is not None and vec in corr_vals:
                val = soa.add_tv(ev, val, corr_vals[vec])
            renv[vec] = val
        return renv

    def _aug_rhs_soa(self, ev, renv):
        """The augmented right-hand side, one vector per block."""
        memo = {}
        return [soa.as_vector(ev, soa.evaluate(ev, r, renv, memo), sz)
                for r, sz in zip(self.aug.rhs, self.aug_sizes)]

    def _back_substitute_soa(self, ev, renv, sol_parts):
        """Every variable's delta from the solved blocks, through the
        symbolic delta definitions."""
        deltas = [None] * len(self.full.variables)
        denv = dict(renv)
        for var, val in zip(self.aug.variables, sol_parts):
            deltas[self.var_index[var]] = val
            denv[delta_variable(var)] = soa.vector(val)
        memo = {}
        for dvar, ddef in reversed(self.aug.delta_definitions):
            var = self.delta_to_var[dvar]
            val = soa.as_vector(ev, soa.evaluate(ev, ddef, denv, memo),
                                self.size_of[var])
            denv[dvar] = soa.vector(val)
            deltas[self.var_index[var]] = val
        return deltas

    def _gondzio_targets_soa(self, ev, tenv, mu_target, beta_min=0.1,
                             beta_max=10.0):
        """Residual vectors of a Gondzio round: for complementarity rows
        p - clip(p, beta_min mu, beta_max mu) at the trial point, zeros
        elsewhere."""
        memo = {}
        out = []
        for i, (vec, definition, comp) in enumerate(self.corrector):
            sz = self.var_sizes[i]
            if comp and sz:
                p = soa.as_vector(ev, soa.evaluate(ev, definition, tenv,
                                                   memo), sz)
                out.append(ev.minus_clip(p, mu_target, beta_min, beta_max))
            else:
                out.append(ev.zeros(sz))
        return out

    # -- plain version of K1 (torch, SoA) --------------------------------

    def _env_soa(self, data_tvs, var_vals, mu_val):
        o = self.symbols
        dt = self.dtype
        dev = mu_val.device
        env = dict(data_tvs)
        env[o.delta_eq] = soa.scalar(torch.full((1, 1), self.delta0,
                                                dtype=dt, device=dev))
        env[o.mu] = soa.scalar(mu_val)
        env[o.e_var] = soa.vector(torch.ones((self.n, 1), dtype=dt,
                                             device=dev))
        env[o.e_ineq] = soa.vector(torch.ones((self.m_ineq, 1), dtype=dt,
                                              device=dev))
        env[o.e_eq] = soa.vector(torch.ones((self.m_eq, 1), dtype=dt,
                                            device=dev))
        for var, val in zip(self.full.variables, var_vals):
            env[var] = soa.vector(val)
        return env

    def _assemble_soa(self, ev, env):
        """The augmented KKT matrices, (aug_dim, aug_dim, B)."""
        B = ev.batch
        dt = self.dtype
        memo = {}
        rows = []
        for i in range(len(self.aug.variables)):
            si = self.aug_sizes[i]
            row = []
            for j in range(len(self.aug.variables)):
                sj = self.aug_sizes[j]
                cell = self.aug.lhs[i][j]
                if cell is E.ZERO:
                    row.append(torch.zeros((si, sj, B), dtype=dt,
                                           device=ev.device))
                    continue
                v = soa.evaluate(ev, cell, env, memo)
                if v.tag == "matrix":
                    blk = v.val.expand(si, sj, B)
                elif v.tag in ("diag", "scalar"):
                    eye = torch.eye(si, dtype=dt, device=ev.device)
                    blk = eye[:, :, None] * v.val[:, None, :].expand(
                        v.val.shape[0], 1, B)
                else:
                    raise TypeError(f"cell {cell!r} -> {v.tag}")
                row.append(blk)
            rows.append(torch.cat(row, dim=1))
        return torch.cat(rows, dim=0)

    def _search_direction_soa(self, ev, factors, renv):
        L, D = factors
        b = torch.cat(self._aug_rhs_soa(ev, renv), dim=0)
        sol = _solve_soa(L, D, b)
        parts, off = [], 0
        for sz in self.aug_sizes:
            parts.append(sol[off:off + sz])
            off += sz
        return self._back_substitute_soa(ev, renv, parts)

    def _max_step_soa(self, env, var_vals, deltas):
        alpha = torch.ones_like(env[self.symbols.mu].val)
        inf = torch.tensor(float("inf"), dtype=self.dtype,
                           device=alpha.device)

        def clip(alpha, num, d, neg: bool):
            if d.shape[0] == 0:
                return alpha
            moving = d < 0 if neg else d > 0
            ratio = torch.where(moving, num / torch.where(
                moving, d, torch.full_like(d, -1.0 if neg else 1.0)), inf)
            return torch.minimum(alpha, torch.amin(ratio, dim=0,
                                                   keepdim=True))

        for i in self.nonneg_idx:
            alpha = clip(alpha, -var_vals[i], deltas[i], neg=True)
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
                v, d = var_vals[i], deltas[i]
                if lb_sym is not None:
                    alpha = clip(alpha, env[lb_sym].val - v, d, neg=True)
                if ub_sym is not None:
                    alpha = clip(alpha, env[ub_sym].val - v, d, neg=False)
        return alpha

    def _gondzio_round_soa(self, ev, env, make_env, var_vals, factors, d,
                           alpha, mu_target, delta_alpha=0.1, gamma=0.1):
        """One in-kernel Gondzio round: same constants and per-lane
        accept rule as :meth:`CompiledIPM._gondzio_round`."""
        alpha_t = torch.clamp(alpha + delta_alpha, max=1.0)
        trial = tuple(v + alpha_t * dv for v, dv in zip(var_vals, d))
        tenv = make_env(trial, ev.zero_scalar())
        genv = dict(env)
        for (vec, _, _), r in zip(self.corrector,
                                  self._gondzio_targets_soa(ev, tenv,
                                                            mu_target)):
            genv[vec] = soa.vector(r)
        dm = self._search_direction_soa(ev, factors, genv)
        d_new = tuple(dv + dmv for dv, dmv in zip(d, dm))
        alpha_new = self._max_step_soa(env, var_vals, d_new)
        accept = alpha_new >= torch.clamp(alpha + gamma * delta_alpha,
                                          max=1.0)
        d_out = tuple(torch.where(accept, dn, dv)
                      for dn, dv in zip(d_new, d))
        return d_out, torch.where(accept, alpha_new, alpha)

    def _fused_step(self, ev, make_env, var_vals, mu, gap, gondzio: int):
        env = make_env(var_vals, mu)
        factors = _ldlt_soa(self._assemble_soa(ev, env), self.pivot_floor)

        zero_mu = ev.zero_scalar()
        renv = self._residual_env_soa(ev, make_env, env, zero_mu)
        d_aff = self._search_direction_soa(ev, factors, renv)
        alpha_aff = self._max_step_soa(env, var_vals, d_aff)

        trial = tuple(v + alpha_aff * d for v, d in zip(var_vals, d_aff))
        _, gap_aff = self._metrics_soa(ev, make_env(trial, zero_mu))
        pos = gap > 0
        g = gap_aff / torch.where(pos, gap, torch.ones_like(gap))
        sigma = torch.where(pos, g * g * g, torch.zeros_like(gap))
        mu_new = torch.maximum(gap * sigma, torch.full_like(
            gap, self.mu_floor))

        cenv = self._residual_env_soa(ev, make_env, env, mu_new,
                                      var_vals=var_vals,
                                      affine_deltas=d_aff)
        d_cc = self._search_direction_soa(ev, factors, cenv)
        alpha = self._max_step_soa(env, var_vals, d_cc)
        for _ in range(gondzio):
            d_cc, alpha = self._gondzio_round_soa(ev, env, make_env,
                                                  var_vals, factors, d_cc,
                                                  alpha, mu_new)
        step = self.fraction_to_boundary * alpha
        return tuple(v + step * d for v, d in zip(var_vals, d_cc)), mu_new

    def _fused_plain(self, data_soa, warm, max_iter: int, gondzio: int):
        """Plain version of K1 on SoA tensors of any device: data fields
        (..., B) in :data:`DATA_FIELDS` order, ``warm`` None or
        (variables (total, B), mu (1, B), iterations (1, B)).  Returns
        (x (n, B), variables (total, B), iterations, residual, gap, mu,
        each (1, B)).  The loop asks the device once per iteration
        whether a lane is still active (``host_syncs``)."""
        o = self.symbols
        dt = self.dtype
        B = data_soa[0].shape[-1]
        dev = data_soa[0].device
        ev = soa.TorchSoA(dt, dev, B)
        fields = dict(zip(DATA_FIELDS, data_soa))
        data_tvs = {getattr(o, f): soa.TV("matrix" if a.dim() == 3
                                          else "vector", a)
                    for f, a in fields.items()}

        def make_env(var_vals, mu_val):
            return self._env_soa(data_tvs, var_vals, mu_val)

        if warm is not None:
            v0, mu, iters = warm
            var_vals, off = [], 0
            for sz in self.var_sizes:
                var_vals.append(v0[off:off + sz])
                off += sz
            var_vals = tuple(var_vals)
        else:
            init = {o.x: 0.5 * (fields["l_x"] + fields["u_x"]),
                    o.s_A_ineq: 0.5 * (fields["l_A_ineq"] +
                                       fields["u_A_ineq"])}
            var_vals = tuple(init.get(v, torch.ones((sz, B), dtype=dt,
                                                    device=dev))
                             for v, sz in zip(self.full.variables,
                                              self.var_sizes))
            mu = torch.full((1, B), self.mu0, dtype=dt, device=dev)
            iters = torch.zeros((1, B), dtype=dt, device=dev)

        residual, gap = self._metrics_soa(ev, make_env(var_vals,
                                                       ev.zero_scalar()))
        done = (residual < self.tol) & (gap < self.tol)
        for _ in range(max_iter):
            self.host_syncs += 1
            if bool(done.all()):
                break
            new_vars, mu_new = self._fused_step(ev, make_env, var_vals, mu,
                                                gap, gondzio)
            var_vals = tuple(torch.where(done, v, nv)
                             for v, nv in zip(var_vals, new_vars))
            mu = torch.where(done, mu, mu_new)
            n_res, n_gap = self._metrics_soa(ev, make_env(
                var_vals, ev.zero_scalar()))
            residual = torch.where(done, residual, n_res)
            gap = torch.where(done, gap, n_gap)
            iters = torch.where(done, iters, iters + 1.0)
            done = done | ((residual < self.tol) & (gap < self.tol))
        x = var_vals[self.var_index[o.x]]
        return (x, torch.cat(var_vals, dim=0), iters, residual, gap, mu)

    # -- K1 ---------------------------------------------------------------

    def kernel_source(self, route: str = "thread") -> str:
        """K1's C++ source of ``route`` ("thread", "team", "wide" or
        "block") for this formulation and these sizes (generated once per
        solver)."""
        src = self._kernel_sources.get(route)
        if src is None:
            make = {"thread": fused_source, "team": fused_team_source,
                    "wide": fused_wide_source,
                    "block": fused_wide_block_source}
            if route not in make:
                raise ValueError(f"K1 has no route {route!r}")
            if route == "thread" and self.aug_dim > cuda_fused.THREAD_MAX_AUG:
                raise ValueError(
                    f"K1's thread route keeps the packed factor of order "
                    f"{self.aug_dim} in each thread's local memory: it is "
                    f"built only up to order {cuda_fused.THREAD_MAX_AUG}")
            src = self._kernel_sources[route] = make[route](self)
        return src

    def k1_sizes(self):
        """What :func:`..ops.cuda_fused.k1_route` reads of the sizes: (n,
        m_ineq, m_eq, variables, augmented order)."""
        return (self.n, self.m_ineq, self.m_eq, sum(self.var_sizes),
                self.aug_dim)

    def k1_slots(self) -> int:
        """The team slots of K1's generated team code (the team, wide and
        block routes' ``kSlots``) at these sizes: what
        :func:`..ops.cuda_fused.k1_route` reads to fit the block route's
        shared memory exactly (generated once per solver)."""
        if self._k1_slots is None:
            self._k1_slots = team_slots(self)
        return self._k1_slots

    def kernel_params(self):
        """K1's scalar settings, in the order of ``Params`` in
        ``csrc/fused_ipm.cuh``."""
        return (self.tol, self.mu0, self.delta0, self.pivot_floor,
                self.mu_floor, self.fraction_to_boundary)

    # -- public wrapper ---------------------------------------------------

    def _pad_batch(self, B: int, tree):
        """Replicate-pad every leaf's batch axis to a multiple of ``bt``
        (replicas converge like the instance they copy; zero instances
        would not)."""
        Bpad = _round_up(B, self.bt)

        def pad(a):
            return torch.cat([a, a[-1:].expand((Bpad - B,) + a.shape[1:])])

        return tree_map(pad, tree)

    def solve_fused(self, data: QPData, state: Optional[dict] = None,
                    max_iter: Optional[int] = None, gondzio: int = 0):
        """Solve a batch of QPs with kernel K1 (CUDA tensors) or its plain
        version (CPU tensors).

        ``state``: optional warm start, a dict with ``variables``
        (B, total), ``mu`` (B,) and ``iterations`` (B,) from a previous
        result; the solve resumes from it.  ``max_iter``: this call's
        iteration budget.  ``gondzio``: centrality-corrector rounds per
        iteration.  Returns a dict of ``x``, ``variables``,
        ``iterations`` (working dtype, cumulative over warm resumes),
        ``residual``, ``gap``, ``mu`` and ``converged``."""
        data = self._check_data(data)
        B = data.Q.shape[0]
        max_iter = self.max_iter if max_iter is None else max_iter
        if B % self.bt:
            padded = self._pad_batch(B, (data,) if state is None
                                     else (data, state))
            out = self.solve_fused(padded[0], None if state is None
                                   else padded[1], max_iter, gondzio)
            return {k: v[:B] for k, v in out.items()}

        data_soa, warm = self.soa_inputs(data, state)
        if self.device.type == "cuda":
            sizes = self.k1_sizes()
            slots = (self.k1_slots() if self.aug_dim >
                     cuda_fused.THREAD_MAX_AUG else None)
            route = cuda_fused.k1_route(B, sizes, self.dtype, slots)
            warps = (cuda_fused.block_warps(sizes, self.dtype, slots)
                     if route == "block" else None)
            outs = cuda_fused.fused_soa(self.kernel_source(route), data_soa,
                                        warm, self.n, sum(self.var_sizes),
                                        max_iter, gondzio,
                                        self.kernel_params(), route, warps)
        elif self.device.type == "cpu":
            outs = self._fused_plain(data_soa, warm, max_iter, gondzio)
        else:
            raise ValueError(f"no fused solver for device {self.device}")
        return self.soa_result(outs)

    def soa_inputs(self, data: QPData, state: Optional[dict] = None):
        """K1's inputs: the data fields in :data:`DATA_FIELDS` order and
        the warm state (or None), as contiguous SoA copies (batch last)
        in the working dtype."""
        dt = self.dtype
        data_soa = [getattr(data, f).to(dt).movedim(0, -1).contiguous()
                    for f in DATA_FIELDS]
        if state is None:
            return data_soa, None
        B = data.Q.shape[0]
        return data_soa, (state["variables"].to(dt).t().contiguous(),
                          state["mu"].to(dt).reshape(1, B).contiguous(),
                          state["iterations"].to(dt).reshape(1, B)
                          .contiguous())

    def soa_result(self, outs):
        """The result dict of K1's (or the plain version's) outputs."""
        x, allvars, iters, residual, gap, mu = outs
        res_b, gap_b = residual[0], gap[0]
        return {
            "x": x.t(),
            "variables": allvars.t(),
            "iterations": iters[0],
            "residual": res_b,
            "gap": gap_b,
            "mu": mu[0],
            "converged": (res_b < self.tol) & (gap_b < self.tol),
        }
