"""Compaction-scheduled batched solving for :class:`CompiledIPM`
(counterpart of :mod:`ipmzoo_tpu.models.compact`).

A masked batched loop makes every instance pay for the slowest one.
``solve_batch_compact`` instead runs a fixed number of masked steps on
the full batch, then sorts the done-mask (actives first), gathers the
leading ``B // divisor`` instances and continues on that sub-batch only,
scattering results back; a full-batch early-exit loop mops up whatever
overflowed a stage's capacity.

Host syncs: ``_masked_steps`` runs a fixed count and never asks the
device anything; ``_masked_while`` asks once per iteration whether any
instance is still active (counted in ``host_syncs``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .data import QPData
from .state import IPMState, SolveResult, tree_map

_ROADMAP_ESCALATION = ("ROADMAP.md Queue 1 item 7 (escalation precision: "
                       "the two-float escalation stage)")


def _where(mask, old, new):
    """Per-instance select: ``old`` where ``mask`` else ``new``."""
    return tree_map(lambda o, n_: torch.where(
        mask.reshape(mask.shape + (1,) * (n_.dim() - 1)), o, n_), old, new)


def _bad(s: IPMState) -> torch.Tensor:
    return (torch.isnan(s.residual) | torch.isinf(s.residual) |
            torch.isnan(s.gap) | torch.isinf(s.gap))


class CompactScheduleMixin:
    """Masked iteration loops + the gather/compact/resume schedule."""

    def _masked_step(self, st, data, frozen, div, gondzio):
        """One batched iteration; frozen instances re-enter unchanged and
        a step that goes NaN/inf rolls back to the last good iterate."""
        new = self._step_impl(st, data, gondzio=gondzio)
        bad = _bad(new)
        return _where(frozen | bad, st, new), div | (bad & ~frozen)

    def _masked_steps(self, state, data, diverged, res_tol, k: int,
                      gondzio: Optional[int] = None):
        """Run ``k`` batched iterations with freeze-on-done."""
        for _ in range(k):
            frozen = self._done(state, res_tol) | diverged
            state, diverged = self._masked_step(state, data, frozen,
                                                diverged, gondzio)
        return state, diverged

    def _masked_while(self, state, data, frozen0, res_tol, max_steps: int,
                      gondzio: Optional[int] = None):
        """Early-exit variant of :meth:`_masked_steps`: iterates until
        every instance is frozen (converged, diverged, or frozen via
        ``frozen0``) or ``max_steps`` is reached."""
        diverged = torch.zeros_like(frozen0)
        for _ in range(max_steps):
            frozen = frozen0 | self._done(state, res_tol) | diverged
            self.host_syncs += 1
            if bool(frozen.all()):
                break
            state, diverged = self._masked_step(state, data, frozen,
                                                diverged, gondzio)
        return state, diverged

    def _compact_impl(self, data: QPData, schedule, tail_gondzio,
                      tail_restart) -> SolveResult:
        """Whole-batch solve with compaction between stages.

        Tail stages restart still-active instances from the initial
        iterate and run with ``tail_gondzio`` Gondzio rounds (plain
        Mehrotra cycles on a small fraction of instances; Gondzio from a
        cold start breaks the cycle), keeping cumulative iteration
        counts."""
        B = data.Q.shape[0]
        state = self.init_state(data)
        res_tol = self._res_tol(state)
        diverged = torch.zeros(B, dtype=torch.bool, device=self.device)

        (k0, div0), *rest = schedule
        if div0 != 1:
            raise ValueError("first stage must cover the full batch")
        state, diverged = self._masked_steps(state, data, diverged,
                                             res_tol, k0)

        for (k, divisor) in rest:
            cap = max(B // divisor, 1)
            done = self._done(state, res_tol)
            # gather priority: actives first, then diverged (which get
            # their Gondzio second chance), converged last as padding.
            # A stable sort, as the reference's, decides which instances
            # fit a capacity-limited stage.
            priority = 2 * done.to(torch.int32) + \
                (diverged & ~done).to(torch.int32)
            take = torch.argsort(priority, stable=True)[:cap]
            s_state, s_data, s_div, s_tol = tree_map(
                lambda a: a[take], (state, data, diverged, res_tol))
            if tail_restart:
                s_done = self._done(s_state, s_tol)
                fresh = self.init_state(s_data)
                fresh = IPMState(vars=fresh.vars, mu=fresh.mu,
                                 iteration=s_state.iteration,
                                 residual=fresh.residual, gap=fresh.gap)
                s_state = _where(s_done, s_state, fresh)
                s_div = s_div & s_done
            s_state, s_div = self._masked_steps(s_state, s_data, s_div,
                                                s_tol, k,
                                                gondzio=tail_gondzio)

            def put(full, sub):
                out = full.clone()
                out[take] = sub
                return out

            state = tree_map(put, state, s_state)
            diverged = put(diverged, s_div)

        # full-batch mop-up of whatever overflowed a stage's capacity
        done = self._done(state, res_tol)
        state, mop_div = self._masked_while(
            state, data, done | diverged, res_tol,
            max(self.max_iter - schedule[0][0], 0), gondzio=tail_gondzio)
        return self._result(state, data, res_tol, diverged | mop_div)

    def default_schedule(self, B: int):
        """The reference's default ``(steps, batch_divisor)`` stages."""
        if B < 64:
            return [(self.max_iter, 1)]
        # tighter tolerances converge later and wider: longer stages and
        # wider tails (the reference's measured choice)
        (s0, s1), (d1, d2) = (((12, 12), (8, 64)) if self.tol >= 1e-5
                              else ((16, 16), (4, 32)))
        k0 = min(self.max_iter, s0)
        k1 = min(max(self.max_iter - k0, 0), s1)
        k2 = max(self.max_iter - k0 - k1, 0)
        schedule = [(k0, 1)]
        if k1:
            schedule.append((k1, d1))
        if k2:
            schedule.append((k2, d2))
        return schedule

    def solve_batch_compact(self, data: QPData, schedule=None,
                            tail_gondzio: int = 2,
                            tail_restart: bool = True,
                            esc_cap="auto") -> SolveResult:
        """Straggler-free batched solve (see :meth:`_compact_impl`).

        ``schedule``: list of ``(steps, batch_divisor)`` stages; the
        first divisor must be 1 (default: :meth:`default_schedule`).
        ``esc_cap``: capacity of the reference's two-float escalation
        stage ('auto' = 32 for f32 at tolerances near its floor, else
        0).  The stage is not ported, so a nonzero cap raises."""
        if esc_cap == "auto":
            eps = torch.finfo(self.dtype).eps
            esc_cap = 32 if self.tol <= eps * 20 else 0
        if esc_cap:
            raise NotImplementedError(
                f"esc_cap={esc_cap}: the escalation stage is not ported "
                f"({_ROADMAP_ESCALATION}); pass esc_cap=0 to solve "
                "without it")
        data = self._check_data(data)
        if schedule is None:
            schedule = self.default_schedule(data.Q.shape[0])
        return self._compact_impl(data, schedule, tail_gondzio,
                                  tail_restart)
