"""Nested-dissection plan management for :class:`CompiledIPM`
(counterpart of :mod:`ipmzoo_tpu.models.ndplan`).

``NdPlanMixin`` holds the kernel='nd' plan lifecycle: deriving the
separator-tree plan from the data's sparsity at first contact, the
cost-model auto-fallback that refuses plans predicted to lose to the
dense kernels, and the one-time diagonal-split validation.  Each brings
one assembled KKT matrix of the first instance to the host, once per
solver and never per solve; ``host_syncs`` counts them.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import QPData
from .state import tree_map

class NdPlanMixin:
    """Plan derivation + auto-fallback for the nested-dissection kernel."""

    def _maybe_nd_fallback(self) -> None:
        """Refuse a nested-dissection plan predicted to lose to dense.

        When the time model (``ops/ndiss.py::nd_predicted_speedup``)
        predicts < 1.05x over the dense factorisation, or the plan is
        below the model's range (n < 192), switch to the mode the dense
        auto rule picks ('block', 'blockg' or 'ldlt') and record
        ``nd_fell_back``."""
        from ..ops.ndiss import nd_predicted_speedup
        if not self._nd_fallback or self._nd_plan is None:
            return
        if self._nd_plan.n >= 192 and \
                nd_predicted_speedup(self._nd_plan) >= 1.05:
            return
        self.nd_fell_back = True
        self._mode = self._dense_auto_mode()

    def _kkt_to_host(self, data: QPData, var_vals, mu_val) -> np.ndarray:
        """The first instance's assembled KKT matrix as a numpy array."""
        K = self._assemble_kkt(self._env(data, var_vals, mu_val), 1)[0]
        self.host_syncs += 1
        return K.cpu().numpy()

    def _ensure_nd_plan(self, data: QPData) -> None:
        """Derive the nested-dissection plan from the data's sparsity
        (kernel='nd' with no explicit nd_pattern): assemble ONE KKT
        matrix at the initial iterate and dissect its nonzero pattern on
        the host.  Barrier terms only touch diagonal blocks, so the
        pattern is iteration-invariant; the plan is cached.  ``data`` is
        batched; the structure comes from instance 0."""
        if self._mode != "nd":
            return
        data = tree_map(lambda a: a[:1], data)
        if self._nd_plan is None:
            from ..ops.ndiss import nd_plan
            state = self.init_state(data)
            K = self._kkt_to_host(data, state.vars, self.mu0)
            # structural signs let the amalgamated top factor as two
            # dense Cholesky stages (ops/ndiss.py::_signed_top_factor)
            self._nd_plan = nd_plan(K != 0, leaf=self._nd_leaf,
                                    signs=self._sign_vec)
            self._maybe_nd_fallback()
        if self._mode == "nd" and not hasattr(self, "_nd_diag_split"):
            self._check_nd_diag_split(data)

    def _check_nd_diag_split(self, data: QPData) -> None:
        """Validate (numerically, once, on the host) that IPM iterations
        only change the KKT's DIAGONAL for this formulation: assemble
        the reduction at two different variable/mu assignments and
        compare off-diagonals.  True across the standard lattice
        (barrier terms are diagonal); false e.g. for penalty handlings
        whose mu^-1 C^T C block is off-diagonal — those keep the full
        per-iteration permute path."""
        state = self.init_state(data)
        vars2 = tuple(torch.abs(v) + 0.5 for v in state.vars)
        K1 = self._kkt_to_host(data, state.vars, 0.7)
        K2 = self._kkt_to_host(data, vars2, 0.31)
        off = ~np.eye(K1.shape[0], dtype=bool)
        self._nd_diag_split = bool(np.array_equal(K1[off], K2[off]))
