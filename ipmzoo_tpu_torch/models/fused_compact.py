"""Tail and compaction engines of :class:`.fused.FusedBatchedIPM`
(counterpart of :mod:`ipmzoo_tpu.models.fused_compact`).

``FusedCompactMixin`` holds the hybrid entries built on the fused solve:
the cold-restarted Gondzio anti-cycling tail (``_gondzio_tail``, on the
base class's masked while loop), the escalation stage (``_escalate_tail``),
``solve_fused_refined``, and the compaction schedule of
``solve_fused_compact``.  The escalation stage finishes the instances at
the float32 representation floor with a float64 ``CompiledIPM`` twin on
the same device (K2/K3 in f64 on a card), where the reference carries
them in double-single pairs.

Gathers use a stable sort of the converged mask, as the reference's
``jnp.argsort``, so every capacity-limited stage takes the same
instances.
"""

from __future__ import annotations

import torch

from .compact import _put, _stragglers_first
from .data import QPData
from .state import IPMState, tree_map

_FIELDS = ("x", "variables", "iterations", "residual", "gap", "mu",
           "converged")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class FusedCompactMixin:
    """Gondzio tail + compaction over the fused solve."""

    def _gondzio_tail(self, data: QPData, out, tail_cap: int,
                      tail_iters: int, tail_gondzio: int):
        """Cold-restart the unconverged instances (up to ``tail_cap``) under
        Gondzio correctors in one masked batched solve.  Instances that
        had converged are gathered only as padding and stay frozen; when
        there is no straggler the loop ends at its first check."""
        B = data.Q.shape[0]
        cap = min(tail_cap, B)
        dt = self.dtype
        take = _stragglers_first(out["converged"], cap)
        s_data = tree_map(lambda a: a[take], data)
        s_was_conv = out["converged"][take]

        # restart from the initial iterate: plain Mehrotra cycles on a
        # few instances, and Gondzio from a cold start breaks the cycle
        fresh = self.init_state(s_data)
        s_state = IPMState(vars=fresh.vars, mu=fresh.mu,
                           iteration=out["iterations"][take].to(torch.int32),
                           residual=fresh.residual, gap=fresh.gap)
        s_tol = torch.full((cap,), self.tol, dtype=dt, device=self.device)
        s_state, s_div = self._masked_while(s_state, s_data, s_was_conv,
                                            s_tol, tail_iters,
                                            gondzio=tail_gondzio)
        s_conv = ((s_state.residual < s_tol) & (s_state.gap < self.tol)
                  & ~s_div)
        s_vars = torch.cat(s_state.vars, dim=-1)
        # keep the tail's result only where the fused solve had failed and
        # the tail converged
        use = ~s_was_conv & s_conv
        x_i = self.var_index[self.symbols.x]
        off = sum(self.var_sizes[:x_i])
        out = dict(out)
        out["x"] = _put(out["x"], take, use, s_vars[:, off:off + self.n])
        out["variables"] = _put(out["variables"], take, use, s_vars)
        out["residual"] = _put(out["residual"], take, use, s_state.residual)
        out["gap"] = _put(out["gap"], take, use, s_state.gap)
        out["iterations"] = _put(out["iterations"], take, use,
                                 s_state.iteration.to(dt))
        out["converged"] = _put(out["converged"], take, use, s_conv)
        return out

    def _escalate_tail(self, data: QPData, out, esc_cap: int,
                       esc_iters: int, esc_gondzio: int,
                       esc_warm: bool = True):
        """Re-solve up to ``esc_cap`` unconverged instances in float64 with
        the twin of :meth:`_escalation_twin`; when every instance has
        converged its masked loop ends at the first check.

        ``esc_warm`` starts from the fused iterate promoted to float64 and
        ``max(mu, mu_floor)``: these instances are already essentially
        optimal, only unable to express a smaller residual in float32.
        Otherwise they restart from the twin's initial iterate."""
        f64 = torch.float64
        cap = min(esc_cap, data.Q.shape[0])
        esc = self._escalation_twin()
        take = _stragglers_first(out["converged"], cap)
        e_data = tree_map(lambda a: a[take].to(f64), data)
        e_was = out["converged"][take]
        if esc_warm:
            e_state = self._twin_warm_state(
                esc, e_data, tuple(torch.split(out["variables"][take].to(
                    f64), self.var_sizes, dim=-1)), out["mu"][take])
        else:
            e_state = esc.init_state(e_data)
        # the working dtype's tolerance, as the reference compares
        e_tol = torch.full((cap,), self.tol, dtype=self.dtype,
                           device=self.device).to(f64)
        self.escalated = self.escalated + (~e_was).sum()
        e_state, e_div = self._run_twin(esc, e_state, e_data, e_was, e_tol,
                                        esc_iters, esc_gondzio)
        e_conv = esc._done(e_state, e_tol) & ~e_div
        # merged back rounded to the working dtype
        dt = self.dtype
        e_vars = torch.cat(e_state.vars, dim=-1).to(dt)
        use = ~e_was & e_conv
        x_i = self.var_index[self.symbols.x]
        off = sum(self.var_sizes[:x_i])
        out = dict(out)
        out["x"] = _put(out["x"], take, use, e_vars[:, off:off + self.n])
        out["variables"] = _put(out["variables"], take, use, e_vars)
        out["residual"] = _put(out["residual"], take, use, e_state.residual)
        out["gap"] = _put(out["gap"], take, use, e_state.gap)
        out["iterations"] = _put(
            out["iterations"], take, use,
            out["iterations"][take] + e_state.iteration.to(dt))
        out["converged"] = _put(out["converged"], take, use, e_conv)
        return out

    def solve_fused_refined(self, data: QPData, tail_cap: int = 128,
                            tail_iters: int = 30, tail_gondzio: int = 2):
        """Fused solve plus the restarted Gondzio tail: the instances
        plain Mehrotra cycles on are solved again from a cold start in one
        small batched solve."""
        data = self._check_data(data)
        B = data.Q.shape[0]
        if B % self.bt:
            out = self.solve_fused_refined(self._pad_batch(B, data),
                                           tail_cap, tail_iters,
                                           tail_gondzio)
            return {k: v[:B] for k, v in out.items()}
        out = self.solve_fused(data)
        return self._gondzio_tail(data, out, tail_cap, tail_iters,
                                  tail_gondzio)

    # -- compaction schedule over fused stages ---------------------------

    def _compact_fused_impl(self, data: QPData, schedule, tail_cap: int,
                            tail_iters: int, tail_gondzio: int,
                            fused_tail: bool, esc_cap: int = 0,
                            esc_iters: int = 40, esc_warm: bool = True):
        """Staged fused solve: the full batch for ``k0`` iterations, then
        the unconverged instances gathered into smaller batches and
        resumed warm; a full-batch resume mops up what overflowed a
        stage's capacity.  With ``fused_tail`` the stragglers are then
        cold-restarted in one ``bt``-sized fused solve with in-kernel
        Gondzio rounds.  With ``esc_cap`` the float64 escalation stage
        follows; the masked-while Gondzio tail runs last as the safety
        net."""
        B = data.Q.shape[0]
        (k0, div0), *rest = schedule
        if div0 != 1:
            raise ValueError("first stage must cover the full batch")
        out = self.solve_fused(data, max_iter=k0)
        for (k, divisor) in rest:
            cap = _round_up(max(B // divisor, 1), min(self.bt, B))
            take = _stragglers_first(out["converged"], cap)
            s_out = self.solve_fused(
                tree_map(lambda a: a[take], data),
                state={f: out[f][take]
                       for f in ("variables", "mu", "iterations")},
                max_iter=k)
            for f in _FIELDS:
                out[f] = out[f].clone()
                out[f][take] = s_out[f]
        # an instance dropped by a full stage is still owed
        # max_iter - k0 iterations; a batch whose instances are all
        # converged ends at the kernel's first check
        if rest and self.max_iter > k0:
            out = self.solve_fused(
                data, state={f: out[f]
                             for f in ("variables", "mu", "iterations")},
                max_iter=self.max_iter - k0)
        if fused_tail:
            cap = min(self.bt, B)
            take = _stragglers_first(out["converged"], cap)
            s_was = out["converged"][take]
            s_out = self.solve_fused(tree_map(lambda a: a[take], data),
                                     max_iter=tail_iters,
                                     gondzio=tail_gondzio)
            s_out["iterations"] = s_out["iterations"] + \
                out["iterations"][take]
            use = ~s_was & s_out["converged"]
            for f in _FIELDS:
                out[f] = _put(out[f], take, use, s_out[f])
        # escalation before the safety net, as the reference: a
        # float32-floor instance would churn through every tail step
        if esc_cap:
            out = self._escalate_tail(data, out, esc_cap, esc_iters,
                                      tail_gondzio, esc_warm)
        return self._gondzio_tail(data, out, tail_cap, tail_iters,
                                  tail_gondzio)

    def solve_fused_compact(self, data: QPData, schedule=None,
                            tail_cap: int = 128, tail_iters: int = 30,
                            tail_gondzio: int = 2, fused_tail: bool = True,
                            esc_cap: int = 32, esc_iters: int = 40,
                            esc_warm: bool = True):
        """Compaction-scheduled fused solve (see
        :meth:`_compact_fused_impl`).  Default schedule: the full batch
        for 8 iterations (14 below tol 1e-5), then the stragglers resumed
        in a 1/8-size batch for the rest of ``max_iter``.

        ``esc_cap``, ``esc_iters``, ``esc_warm`` configure the float64
        escalation stage (:meth:`_escalate_tail`); ``esc_cap=0`` skips
        it."""
        data = self._check_data(data)
        B = data.Q.shape[0]
        if B % self.bt:
            out = self.solve_fused_compact(
                self._pad_batch(B, data), schedule, tail_cap, tail_iters,
                tail_gondzio, fused_tail, esc_cap, esc_iters, esc_warm)
            return {k: v[:B] for k, v in out.items()}
        if schedule is None:
            schedule = self.default_fused_schedule(B)
        return self._compact_fused_impl(data, schedule, tail_cap,
                                        tail_iters, tail_gondzio,
                                        fused_tail, esc_cap, esc_iters,
                                        esc_warm)

    def default_fused_schedule(self, B: int):
        """The reference's default ``(max_iter, batch_divisor)`` stages of
        :meth:`solve_fused_compact` for an aligned batch of ``B``."""
        if B <= 2 * self.bt:
            return [(self.max_iter, 1)]
        # stage 1 must converge > 87.5% of the batch for the 1/8 stage to
        # hold it: 8 iterations at tol >= 1e-5, 14 below (the reference's
        # measured iteration quantiles on the benchmark workload)
        k0 = min(self.max_iter, 8 if self.tol >= 1e-5 else 14)
        return [(k0, 1), (max(self.max_iter - k0, 1), 8)]
