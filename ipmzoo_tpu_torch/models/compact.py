"""Compaction-scheduled batched solving for :class:`CompiledIPM`
(counterpart of :mod:`ipmzoo_tpu.models.compact`).

A masked batched loop makes every instance pay for the slowest one.
``solve_batch_compact`` instead runs a fixed number of masked steps on
the full batch, then sorts the done-mask (actives first), gathers the
leading ``B // divisor`` instances and continues on that sub-batch only,
scattering results back; a full-batch early-exit loop mops up whatever
overflowed a stage's capacity.

The escalation stage finishes the instances left at the float32
representation floor in float64: where the reference carries them in
double-single pairs (its ``two_float`` twin, for a TPU without f64), the
port's twin is the same solver in ``torch.float64`` on the same device,
which on a card runs the f64 instantiations of K2/K3.  A ``two_float``
solver iterates in float64 from the start (``CompiledIPM._tf``): its
'auto' capacity is 0, and its twin is that float64 iteration.

Host syncs: ``_masked_steps`` runs a fixed count and never asks the
device anything; ``_masked_while`` asks once per iteration whether any
instance is still active (counted in ``host_syncs``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .data import QPData
from .state import (IPMState, SolveResult, bad_iterate, tree_map,
                    where_instances)


def _stragglers_first(converged: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first ``cap`` instances, unconverged ones first, in
    batch order within each group."""
    return torch.argsort(converged.to(torch.int8), stable=True)[:cap]


def _put(dst: torch.Tensor, take: torch.Tensor, use: torch.Tensor,
         src: torch.Tensor) -> torch.Tensor:
    """dst with dst[take] replaced by src (cast to dst's dtype) where
    ``use``."""
    out = dst.clone()
    mask = use.reshape((-1,) + (1,) * (src.dim() - 1))
    out[take] = torch.where(mask, src.to(dst.dtype), dst[take])
    return out


class CompactScheduleMixin:
    """Masked iteration loops + the gather/compact/resume schedule."""

    def _masked_step(self, st, data, frozen, div, gondzio):
        """One batched iteration; frozen instances re-enter unchanged and
        a step that goes NaN/inf rolls back to the last good iterate."""
        new = self._step_impl(st, data, gondzio=gondzio)
        bad = bad_iterate(new, masked=True)
        return where_instances(frozen | bad, st, new), div | (bad & ~frozen)

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

    def _escalation_twin(self):
        """The float64 twin of this solver for the escalation stage: the
        solver itself when it works in float64, and under two_float its
        own float64 iteration (``_tf``: the reference's pair solver is
        its own twin).  Otherwise it keeps this solver's
        settings, ``mu_floor`` included, as the reference's pair twin
        does, and factors the dense augmented system as the reference's
        pair twin does: by LDL^T, signed-regularised where the system is
        indefinite."""
        if self.two_float:
            return self._tf
        if self.dtype == torch.float64:
            return self
        esc = getattr(self, "_esc_twin", None)
        if esc is None:
            from .ipm import CompiledIPM
            esc = CompiledIPM(
                self.settings, self.n, self.m_ineq, self.m_eq,
                names=self.names, dtype=torch.float64, device=self.device,
                tol=self.tol, max_iter=self.max_iter, mu0=self.mu0,
                delta0=self.delta0, pivot_floor=self.pivot_floor,
                fraction_to_boundary=self.fraction_to_boundary,
                mu_floor=self.mu_floor, scale_tol=self.scale_tol,
                gondzio=self.gondzio,
                kernel="regldlt" if self._indefinite else "ldlt")
            self._esc_twin = esc
        return esc

    def _run_twin(self, esc, state, data, frozen0, res_tol, esc_iters,
                  gondzio):
        """``esc._masked_while`` with its host syncs counted here too."""
        before = esc.host_syncs
        out = esc._masked_while(state, data, frozen0, res_tol, esc_iters,
                                gondzio=gondzio)
        if esc is not self:
            self.host_syncs += esc.host_syncs - before
        return out

    def _twin_warm_state(self, esc, e_data: QPData, vals, mu) -> IPMState:
        """The twin's state at the float64 iterates ``vals``: metrics
        recomputed, ``max(mu, mu_floor)``, iteration count 0."""
        cap = mu.shape[0]
        residual, gap = esc._metrics(esc._env(e_data, vals, 0.0), cap)
        return IPMState(
            vars=vals, mu=torch.clamp(mu.to(torch.float64),
                                      min=esc.mu_floor),
            iteration=torch.zeros(cap, dtype=torch.int32,
                                  device=self.device),
            residual=residual, gap=gap)

    def _escalate_batch(self, data: QPData, state, res_tol, diverged,
                        esc_cap: int, esc_iters: int, gondzio: int):
        """Warm float64 refinement of the residual-floor stragglers.

        Gathers up to ``esc_cap`` unconverged instances (diverged ones
        included, as the reference), promotes their iterates to float64
        (the reference's (hi, lo=0) pairs, here exact), recomputes their
        metrics and runs the twin's masked loop.  Results are merged back
        rounded to the working dtype only where an instance was not
        converged before and converged now; ``diverged`` is returned as it
        came, so a diverged instance that the stage converges is reported
        both converged and diverged, as by the reference."""
        f64 = torch.float64
        cap = min(esc_cap, data.Q.shape[0])
        esc = self._escalation_twin()
        done = self._done(state, res_tol)
        take = _stragglers_first(done, cap)
        e_data = tree_map(lambda a: a[take].to(f64), data)
        e_was = done[take]
        e_state = self._twin_warm_state(
            esc, e_data, tuple(v[take].to(f64) for v in state.vars),
            state.mu[take])
        e_tol = res_tol[take].to(f64)
        self.escalated = self.escalated + (~e_was).sum()
        e_state, e_div = self._run_twin(esc, e_state, e_data, e_was, e_tol,
                                        esc_iters, gondzio)
        use = ~e_was & esc._done(e_state, e_tol) & ~e_div
        state = IPMState(
            vars=tuple(_put(v, take, use, ev)
                       for v, ev in zip(state.vars, e_state.vars)),
            mu=_put(state.mu, take, use, e_state.mu),
            iteration=_put(state.iteration, take, use,
                           state.iteration[take] + e_state.iteration),
            residual=_put(state.residual, take, use, e_state.residual),
            gap=_put(state.gap, take, use, e_state.gap))
        return state, diverged

    def _compact_impl(self, data: QPData, schedule, tail_gondzio,
                      tail_restart, esc_cap: int = 0,
                      esc_iters: int = 40) -> SolveResult:
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
                s_state = where_instances(s_done, s_state, fresh)
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

        # escalation before the mop-up, as the reference: an instance at
        # the float32 floor can never pass the mop-up's test in float32
        # and would keep the whole batch stepping for its budget
        if esc_cap:
            state, diverged = self._escalate_batch(
                data, state, res_tol, diverged, esc_cap, esc_iters,
                tail_gondzio)

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

    def _auto_esc_cap(self) -> int:
        """``esc_cap='auto'``: 32 where the working dtype's floor can sit
        above the tolerance (float32 at tight tolerances), 0 otherwise
        and under two_float, whose iteration runs in float64 already."""
        eps = torch.finfo(self.dtype).eps
        return 32 if not self.two_float and self.tol <= eps * 20 else 0

    def solve_batch_compact(self, data: QPData, schedule=None,
                            tail_gondzio: int = 2,
                            tail_restart: bool = True,
                            esc_cap="auto",
                            esc_iters: int = 40) -> SolveResult:
        """Straggler-free batched solve (see :meth:`_compact_impl`).

        ``schedule``: list of ``(steps, batch_divisor)`` stages; the
        first divisor must be 1 (default: :meth:`default_schedule`).
        ``esc_cap``: capacity of the float64 escalation stage for
        float32-floor stragglers ('auto': :meth:`_auto_esc_cap`);
        ``esc_iters``: its iteration budget.  Under two_float the solve
        runs on the float64 iteration and comes back rounded to the
        working dtype."""
        if esc_cap == "auto":
            esc_cap = self._auto_esc_cap()
        data = self._check_data(data)
        if schedule is None:
            schedule = self.default_schedule(data.Q.shape[0])
        if self._tf is not None:
            return self._on_tf(lambda tf: self._rounded(
                tf.solve_batch_compact(data.to(dtype=torch.float64), schedule,
                                       tail_gondzio, tail_restart, esc_cap,
                                       esc_iters)))
        self._ensure_nd_plan(data)
        return self._compact_impl(data, schedule, tail_gondzio,
                                  tail_restart, esc_cap, esc_iters)
