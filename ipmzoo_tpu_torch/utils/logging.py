"""Structured solve logging and iteration tracing (counterpart of
:mod:`ipmzoo_tpu.utils.logging`).

* :func:`solve_summary` — one structured record per solve (iterations,
  residual, gap, objective, convergence) from a one-instance result.
* :class:`IterationTrace` — an opt-in traced solve that calls
  ``CompiledIPM.step`` iteration by iteration from the host and records
  the per-iteration metrics of one instance (objective, residual, gap,
  mu), one device-to-host read per metric and iteration.  For debugging,
  not for throughput.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import List, Optional

logger = logging.getLogger("ipmzoo_tpu_torch")


def solve_summary(result, log=True) -> dict:
    rec = {
        "iterations": int(result.iterations),
        "residual": float(result.residual),
        "gap": float(result.gap),
        "objective": float(result.objective),
        "converged": bool(result.converged),
    }
    if log:
        logger.info("solve: %s", json.dumps(rec))
    return rec


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    objective: float
    residual: float
    gap: float
    mu: float


class IterationTrace:
    """Run a CompiledIPM solve of one instance step by step, recording
    metrics.

    >>> trace = IterationTrace(solver)
    >>> records = trace.run(data)
    """

    def __init__(self, solver, max_iter: Optional[int] = None):
        self.solver = solver
        self.max_iter = max_iter or solver.max_iter

    def run(self, data) -> List[IterationRecord]:
        """``data``: one QP instance, with or without a leading batch
        axis of length one."""
        from ..models import codegen as cg
        from ..models.state import tree_map
        solver = self.solver
        if len(data.batch_shape) == 0:
            data = tree_map(lambda t: t.unsqueeze(0), data)
        data = solver._check_data(data)
        if data.Q.shape[0] != 1:
            raise ValueError(f"IterationTrace follows one instance, got a "
                             f"batch of {data.Q.shape[0]}")
        state = solver.init_state(data)
        records: List[IterationRecord] = []

        def record(state):
            env = solver._env(data, state.vars, state.mu)
            f = float(cg.evaluate(solver.objective_expr, env).val[0])
            rec = IterationRecord(
                iteration=int(state.iteration[0]), objective=f,
                residual=float(state.residual[0]), gap=float(state.gap[0]),
                mu=float(state.mu[0]))
            records.append(rec)
            logger.info("iter: %d, f: %e, res: %e, gap: %e", rec.iteration,
                        rec.objective, rec.residual, rec.gap)
            return rec

        rec = record(state)
        while (rec.iteration < self.max_iter and
               not (rec.residual < solver.tol and rec.gap < solver.tol)):
            state = solver.step(state, data)
            rec = record(state)
        return records
