"""The Mehrotra predictor-corrector IPM on batched torch tensors.

Counterpart of :class:`ipmzoo_tpu.models.ipm.CompiledIPM`.  The
constructor binds a symbolic formulation (Settings -> Newton system ->
augmented reduction, from :mod:`ipmzoo_tpu_torch.formulations`) to concrete
sizes; each iteration then evaluates the derived system eagerly on a
batch of QP instances:

  1. residual norm and duality measure of the full KKT residual at mu=0
  2. assemble the consumed reduction (the augmented KKT system, or the
     normal equations); factor once by the kernel mode (dense LDL^T on
     kernel K2, the panel-blocked LDL^T, block Cholesky, regularised
     LDL^T or LU; or, with kernel="nd", along a nested-dissection plan
     of the KKT sparsity, kernel K5 per level)
  3. affine predictor: residual vectors at mu=0, solve (K3 or library),
     back-substitute eliminated variables via the symbolic delta
     definitions
  4. ratio test, trial step, mu_aff, sigma = (mu_aff/mu)^3
  5. corrector with the exact quadratic Taylor remainder, solved with
     the SAME factorisation
  6. optional Gondzio rounds; step all variables by 0.995 * alpha

Where the reference runs one instance under ``vmap`` and a
``lax.while_loop``, this runs the whole batch in a masked loop: an
instance that converged or diverged is frozen (its state re-enters
unchanged), and a step that goes NaN/inf rolls back to the last good
iterate.  The loop asks the device once per iteration whether any
instance is still active; ``host_syncs`` counts those round trips.
``init_state`` and ``step`` take one instance, as the reference's do, or
a batch (:meth:`CompiledIPM._is_instance` tells them apart).

The reference's double-single precision options are backed by float64
(see :class:`CompiledIPM`): ``two_float`` runs every entry point on a
float64 solver built once, ``df_residuals`` lifts the residual pipeline
to float64 and ``hybrid_refine`` the refinement residuals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..formulations import (Settings, VariableNames, augmented_system,
                            build_symbols, delta_variable, newton_system,
                            normal_equations, shorthand_rhs)
from ..ops.blocked_ldlt import ldlt_blocked, solve_ldlt_blocked
from ..ops.cuda_ldlt import ldlt_auto, solve_ldlt_auto
from ..symbolic import expr as E
from ..utils.device import resolve_device
from ..utils.precision import apply_default_matmul_precision
from . import codegen as cg
from .compact import CompactScheduleMixin
from .data import QPData
from .directions import DirectionsMixin
from .kernels import KernelDispatchMixin
from .ndplan import NdPlanMixin
from .state import (IPMState, SolveResult, bad_iterate, tree_map,
                    where_instances, with_batch_axis, without_batch_axis)

__all__ = ["CompiledIPM", "IPMState", "SolveResult"]

_KERNELS = ("auto", "ldlt", "jnp", "block", "blockg", "lu", "regldlt",
            "normal", "sharded", "nd")


class CompiledIPM(KernelDispatchMixin, DirectionsMixin,
                  CompactScheduleMixin, NdPlanMixin):
    """A formulation + problem-size specialised batched IPM solver.

    ``device`` is where the solver's tensors live (default: the CUDA
    device; without one that raises, pass ``device="cpu"`` for the CPU);
    data on any other device is rejected.  ``settings`` must be the
    port's own :class:`Settings` (``convert.settings_from_reference``
    rebuilds one from the JAX package's).  ``dtype`` is the working
    precision (default float64, as the reference).

    ``kernel``: 'auto' / 'ldlt' factor the dense augmented system (K2,
    K3; the panel-blocked LDL^T above the orders
    ``ops/cuda_ldlt.ldlt_route`` gives K2); 'jnp' the same with the
    panel-blocked LDL^T and library triangular solves at every order;
    'block' / 'blockg' by block Cholesky elimination of the 2x2 / G x G
    augmented system (``ops/block_solve.py``, ``ops/blockg.py``);
    'normal' factors the normal equations, binding each dense H^-1 once
    per iteration; 'regldlt' the signed-regularised LDL^T refined
    against the true system and 'lu' a pivoted LU, for genuinely
    indefinite systems; 'nd' by nested-dissection block elimination for
    general sparsity (``ops/ndiss.py``: K5 per tree level, K3 in the
    solves); 'sharded' by the panel-sharded LDL^T over the ``mesh_axis``
    axis of ``mesh`` (``ops/sharded_ldlt.py``: K2 on every diagonal
    panel, library products and triangular solves), the one system
    identity-padded to a multiple of ranks x ``panel`` (default
    min(128, aug_dim / ranks)); every rank passes the whole QP, runs the
    same iteration and returns the same bits, and the solver runs on
    this rank's device of the mesh.  'auto' picks 'regldlt' for an
    indefinite system, 'block' for a 2x2 system from n = 384, 'blockg'
    from aug_dim = 384, else 'ldlt', as the reference.  ``block_inv``: the 'block' mode binds
    explicit H^-1 / S^-1 ('auto' = off).  The dissection plan is built
    on the host from the KKT sparsity pattern: pass it as
    ``nd_pattern``, or leave None and the first solve derives it from
    the data.  ``nd_leaf``: stop dissecting below this many variables.
    ``nd_fallback``: refuse a plan predicted to lose to the dense path
    and solve with the mode the dense auto rule picks instead (recorded
    in ``nd_fell_back``); False keeps the plan.

    The precision options, where the reference computes in double-single
    (hi, lo) pairs, are backed by float64 here:

    - ``hybrid_refine``: each refinement sweep's residual b - K x is
      computed in float64 against the assembled K and rounded to the
      working dtype (no effect without a sweep: ``refine=0`` leaves only
      the three sweeps of 'regldlt');
    - ``df_residuals``: residuals, metrics, right-hand sides, Gondzio
      trials and back-substitutions are evaluated in float64 and rounded
      to the working dtype; iterates and factor stay in it ('normal'
      raises, as the reference);
    - ``two_float`` (implies ``df_residuals``; 'auto' / 'ldlt' only):
      the whole iteration runs in float64 on a float64 solver (``_tf``,
      dense LDL^T, K2/K3 in float64 on the card), the scalars (mu, step
      lengths, residual, gap, tolerance) held in the working dtype as
      the reference holds them.  ``SolveResult`` comes back in the
      working dtype (x, variables, objective, residual, gap); the
      ``IPMState`` of ``init_state`` / ``step`` is float64, the
      counterpart of the reference's (2, n) pairs."""

    def __init__(self, settings: Settings, n: int, m_ineq: int = 0,
                 m_eq: int = 0, *, names: VariableNames = VariableNames(),
                 dtype: torch.dtype = torch.float64, device=None,
                 tol: float = 1e-8, max_iter: int = 100,
                 fraction_to_boundary: float = 0.995, mu0: float = 1.0,
                 delta0: float = 1e-4, pivot_floor: float = 1e-8,
                 refine: int = 0, kernel: str = "auto",
                 scale_tol: bool = False, gondzio: int = 0,
                 mu_floor: float | str = "auto",
                 hybrid_refine: bool = False, df_residuals: bool = False,
                 two_float: bool = False, mesh=None,
                 mesh_axis: str = "tp",
                 panel: Optional[int] = None, block_inv="auto",
                 taylor: str = "staged", nd_pattern=None,
                 nd_leaf: int = 32, nd_fallback: bool = True):
        apply_default_matmul_precision()
        if not isinstance(settings, Settings):
            raise TypeError(
                f"settings must be ipmzoo_tpu_torch.formulations.Settings, "
                f"not {type(settings).__module__}."
                f"{type(settings).__qualname__}; convert another package's "
                f"with models.convert.settings_from_reference")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, not {dtype}")
        if two_float:
            if kernel not in ("auto", "ldlt"):
                raise ValueError(
                    "two_float=True factors the dense augmented system in "
                    "float64 and supports kernel='auto'/'ldlt' only")
            df_residuals = True
        if kernel == "normal" and df_residuals:
            raise NotImplementedError(
                "kernel='normal' pre-binds dense-matrix inverses in working "
                "precision; the float64 residual pipeline does not consume "
                "them: use the augmented-system kernels with df_residuals")
        if kernel not in _KERNELS:
            raise ValueError(f"unknown kernel={kernel!r}; expected one of "
                             f"{_KERNELS}")
        if taylor not in ("staged", "symbolic"):
            raise ValueError(f"unknown taylor={taylor!r}; expected "
                             "'staged' or 'symbolic'")
        self.settings = settings
        self.n, self.m_ineq, self.m_eq = n, m_ineq, m_eq
        self.dtype = dtype
        if kernel == "sharded" and mesh is not None:
            # the solver's tensors live on this rank's device of the mesh
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not this rank's "
                                 f"device of the mesh, {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.tol = tol
        self.max_iter = max_iter
        self.fraction_to_boundary = fraction_to_boundary
        self.mu0 = mu0
        self.delta0 = delta0
        self.pivot_floor = pivot_floor
        #: extra iterative-refinement sweeps per linear solve
        self.refine = refine
        #: Gondzio multiple-centrality-corrector rounds per iteration
        self.gondzio = gondzio
        #: lower bound on mu tied to the working dtype ("auto" =
        #: eps(dtype)^2 * mu0), as in the reference
        if mu_floor == "auto":
            mu_floor = torch.finfo(dtype).eps ** 2 * mu0
        self.mu_floor = float(mu_floor)
        #: scale the residual test by (1 + initial residual norm)
        self.scale_tol = scale_tol
        #: refinement residuals b - K x in float64 against the assembled
        #: K, rounded to the working dtype (the reference's compensated
        #: two-float residual); no effect without a refinement sweep
        self.hybrid_refine = hybrid_refine
        #: residuals, metrics, right-hand sides and back-substitutions in
        #: float64 (the reference's two-float pairs), rounded to the
        #: working dtype before the solve and the step; iterates and
        #: factor stay in the working dtype
        self.df_residuals = df_residuals
        #: the whole iteration in float64 (the reference's double-single
        #: pairs): every entry point runs on the float64 solver ``_tf``
        self.two_float = two_float
        #: the dtype the residual pipeline evaluates in
        self._rdt = torch.float64 if df_residuals else dtype
        #: the dtype of the iteration's scalars (mu, the step lengths,
        #: residual, gap, the tolerance): the working dtype, which the
        #: float64 solver of a two_float solver keeps from its owner, as
        #: the reference keeps them beside its pair iterates
        self._sdt = dtype
        #: device-to-host round trips made by the iteration loops
        self.host_syncs = 0
        #: instances the escalation stage took in unconverged, summed over
        #: solves (a device tensor once a stage has run)
        self.escalated = 0

        o = build_symbols(names)
        self.symbols = o
        self.names = names

        # --- symbolic derivation ------------------------------------------
        full = newton_system(settings, names)
        sh = shorthand_rhs(full)
        reduced = full.copy()
        reduced.rhs = list(sh.shorthand_rhs)
        aug = augmented_system(reduced)
        self.full, self.sh, self.aug = full, sh, aug
        # the normal-equations reduction (one more elimination: the
        # leading Q/x block), which kernel='normal' factors
        self.norm = normal_equations(reduced) if kernel == "normal" else None
        # a symbolically zero diagonal block: the augmented system is
        # genuinely indefinite, and only 'regldlt' / 'lu' factor it
        self._indefinite = any(aug.lhs[i][i] is E.ZERO
                               for i in range(len(aug.lhs)))
        if self._indefinite and kernel not in ("auto", "lu", "regldlt"):
            raise NotImplementedError(
                "augmented system has a symbolically zero diagonal block "
                "(indefinite); use kernel='regldlt' / 'lu' (or 'auto'), or "
                "a formulation with a quasi-definite augmented system")

        size_of = {
            o.x: n, o.s_x_l: n, o.s_x_u: n, o.lambda_sxl: n, o.lambda_sxu: n,
            o.s_A_ineq: m_ineq, o.s_A_ineq_l: m_ineq, o.s_A_ineq_u: m_ineq,
            o.lambda_A_ineq: m_ineq, o.lambda_sAineql: m_ineq,
            o.lambda_sAinequ: m_ineq,
            o.s_A_eq: m_eq, o.s_A_eq_l: m_eq, o.s_A_eq_u: m_eq, o.p_eq: m_eq,
            o.lambda_A_eq: m_eq, o.lambda_sAeql: m_eq, o.lambda_sAequ: m_eq,
        }
        self.size_of = size_of
        self.var_sizes = [size_of[v] for v in full.variables]
        self.aug_sizes = [size_of[v] for v in aug.variables]
        self.aug_dim = sum(self.aug_sizes)
        self.var_index = {v: i for i, v in enumerate(full.variables)}
        # the reduction the linear solver consumes: the normal equations
        # for kernel='normal', else the augmented system
        self.red = self.norm if self.norm is not None else aug
        self.red_sizes = [size_of[v] for v in self.red.variables]
        self.red_dim = sum(self.red_sizes)
        # the dense-matrix inverses the normal equations hold (H^-1, H =
        # aug.lhs[0][0]), bound once per iteration
        self._matrix_inverts = tuple(
            self._collect_matrix_inverts()) if self.norm is not None else ()
        self.delta_to_var = {delta_variable(v): v for v in full.variables}

        # structural signs of the augmented system's diagonal: +1 on
        # primal groups, -1 on dual groups (the 'regldlt' row
        # regularisation, the 'blockg' stage signs and the nd
        # amalgamated-top split)
        can_block = self._can_block = (len(aug.variables) == 2 and
                                       aug.variables[0] is o.x)
        dual_groups = {o.lambda_A_ineq, o.lambda_sAineql, o.lambda_sAinequ,
                       o.lambda_A_eq, o.lambda_sAeql, o.lambda_sAequ,
                       o.lambda_sxl, o.lambda_sxu}
        self.group_signs = tuple(
            -1.0 if v in dual_groups else 1.0 for v in aug.variables)
        self._sign_vec = np.concatenate(
            [np.full(s, sign, dtype=np.float64)
             for s, sign in zip(self.aug_sizes, self.group_signs)]
        ) if self.aug_sizes else np.zeros((0,))

        # --- linear-solver mode --------------------------------------------
        #: the kernel mode in use (the reference's selection; 'tf' runs on
        #: ``_tf``)
        if two_float:
            self._mode = "tf"
        elif self._indefinite:
            self._mode = "lu" if kernel == "lu" else "regldlt"
        elif kernel in ("lu", "regldlt", "blockg", "normal"):
            self._mode = kernel
        elif kernel == "nd":
            self._mode = "nd"
            self._nd_leaf = nd_leaf
            self._nd_fallback = nd_fallback
            #: whether the auto-fallback replaced the nd plan by the mode
            #: the dense auto rule picks
            self.nd_fell_back = False
            self._nd_plan = None
            if nd_pattern is not None:
                from ..ops.ndiss import nd_plan
                self._nd_plan = nd_plan(np.asarray(nd_pattern),
                                        leaf=nd_leaf, signs=self._sign_vec)
                self._maybe_nd_fallback()
        elif kernel == "sharded":
            self._sharded_setup(mesh, mesh_axis, panel)
        elif kernel == "block":
            if not can_block:
                raise ValueError("kernel='block' needs a 2x2 augmented "
                                 "system with x in the leading block")
            self._mode = "block"
        elif kernel == "auto":
            self._mode = self._dense_auto_mode()
        else:
            self._mode = "ldlt"
        # the dense factor of 'ldlt' / 'regldlt' (also after an nd
        # fallback): the cut-over of ldlt_auto, K2 with K3 up to
        # K2_ORDERS, at any pivot floor; 'jnp' and the reduced system of
        # 'normal' take the panel-blocked LDL^T with library solves
        if kernel == "jnp" or self._mode == "normal":
            self._factor = lambda K: ldlt_blocked(K, self.pivot_floor)
            self._solve_kernel = solve_ldlt_blocked
        else:
            self._factor = lambda K: ldlt_auto(K, self.pivot_floor)
            self._solve_kernel = solve_ldlt_auto
        #: 'block' mode: bind explicit H^-1 / S^-1 each iteration ('auto'
        #: = off, as the reference)
        self._block_inv = bool(block_inv) if block_inv != "auto" else False

        # complementarity rows: contain an e-vector and mu
        e_vecs = (o.e_var, o.e_ineq, o.e_eq)

        def is_comp(expr):
            return (any(expr.contains(ev) for ev in e_vecs) and
                    expr.contains(o.mu))
        self.comp_rows = [i for i, r in enumerate(full.rhs) if is_comp(r)]
        self.comp_size = sum(self.var_sizes[i] for i in self.comp_rows)

        # corrector: the exact quadratic Taylor remainder
        # c_i(v + d_aff) - c_i(v) - J_i d_aff of each complementarity row
        self.corrector = [(vec, definition, is_comp(definition))
                          for vec, definition in sh.vector_definitions]
        self.taylor = taylor
        self.corrector_rem = (self._build_symbolic_corrector()
                              if taylor == "symbolic" else None)

        nonneg = {o.s_A_ineq_l, o.s_A_ineq_u, o.s_x_l, o.s_x_u, o.s_A_eq_l,
                  o.s_A_eq_u, o.lambda_sAeql, o.lambda_sAequ,
                  o.lambda_sAineql, o.lambda_sAinequ, o.lambda_sxl,
                  o.lambda_sxu}
        self.nonneg_idx = [i for i, v in enumerate(full.variables)
                           if v in nonneg]

        # explicit box ratio tests when the bound slacks are not variables
        var_set = set(full.variables)
        self.box_test = (o.s_A_ineq_l not in var_set and
                         o.s_A_ineq_u not in var_set)
        self.x_has_lb = settings.variable_bounds.has_lower
        self.x_has_ub = settings.variable_bounds.has_upper
        self.s_has_lb = settings.inequalities.has_lower
        self.s_has_ub = settings.inequalities.has_upper

        self.objective_expr = E.sum_expr([
            E.product([E.number(0.5), E.transpose(o.x), o.Q, o.x]),
            E.product([E.transpose(o.c), o.x])])
        #: under two_float, the float64 solver every entry point runs on
        self._tf = self._two_float_solver() if two_float else None

    # ------------------------------------------------------------------
    # environment plumbing
    # ------------------------------------------------------------------

    def _sharded_setup(self, mesh, mesh_axis: str, panel) -> None:
        """kernel='sharded': the one augmented system is identity-padded
        to ``_sharded_dim``, a multiple of ranks x ``_sharded_panel``, so
        any aug_dim shards (the unpivoted LDL^T of blockdiag(K, I)
        factors the padding trivially and leaves the solution as it
        is)."""
        if mesh is None:
            raise ValueError("kernel='sharded' requires mesh=")
        if mesh_axis not in mesh.axis_names:
            raise ValueError(f"no axis {mesh_axis!r} in mesh axes "
                             f"{mesh.axis_names}")
        ranks = mesh.shape[mesh_axis]
        p = panel if panel is not None else \
            min(128, max(self.aug_dim // ranks, 1))
        chunk = ranks * p
        self._mesh, self._mesh_axis = mesh, mesh_axis
        self._sharded_panel = p
        self._sharded_dim = -(-self.aug_dim // chunk) * chunk
        self._mode = "sharded"

    def _dense_auto_mode(self) -> str:
        """The reference's dense auto rule: 'block' for a 2x2 augmented
        system from n = 384, 'blockg' from aug_dim = 384, else 'ldlt'."""
        if self._can_block and self.n >= 384:
            return "block"
        if self.aug_dim >= 384:
            return "blockg"
        return "ldlt"

    def _bscalar(self, v, B: int, dtype=None) -> torch.Tensor:
        """A per-instance scalar as a (B,) tensor of ``dtype`` (default
        the working dtype); a constant becomes an expanded view."""
        dtype = dtype or self.dtype
        if isinstance(v, torch.Tensor) and v.dim() == 1:
            return v.to(dtype)
        return torch.full((1,), v, dtype=dtype,
                          device=self.device).expand(B)

    def _ones(self, B: int, size: int) -> torch.Tensor:
        return torch.ones((1, size), dtype=self.dtype,
                          device=self.device).expand(B, size)

    def _base_env(self, data: QPData, mu_val) -> cg.Env:
        o = self.symbols
        B = data.Q.shape[0]
        return {
            o.Q: cg.matrix(data.Q),
            o.c: cg.vector(data.c),
            o.A_ineq: cg.matrix(data.A_ineq),
            o.l_A_ineq: cg.vector(data.l_A_ineq),
            o.u_A_ineq: cg.vector(data.u_A_ineq),
            o.A_eq: cg.matrix(data.A_eq),
            o.b_eq: cg.vector(data.b_eq),
            o.l_x: cg.vector(data.l_x),
            o.u_x: cg.vector(data.u_x),
            o.delta_eq: cg.scalar(self._bscalar(self.delta0, B)),
            o.mu: cg.scalar(self._bscalar(mu_val, B)),
            o.e_var: cg.vector(self._ones(B, self.n)),
            o.e_ineq: cg.vector(self._ones(B, self.m_ineq)),
            o.e_eq: cg.vector(self._ones(B, self.m_eq)),
        }

    def _env(self, data: QPData, var_vals, mu_val) -> cg.Env:
        env = self._base_env(data, mu_val)
        for var, val in zip(self.full.variables, var_vals):
            env[var] = cg.vector(val)
        return env

    def _lift(self, env: cg.Env) -> cg.Env:
        """``env`` for the residual pipeline: its values cast to float64
        under df_residuals (the reference's ``cgdf.lift_env``: exact, as
        its pairs' zero low words), else ``env`` itself."""
        if self._rdt == self.dtype:
            return env
        return {k: cg.TV(v.tag, v.val.to(self._rdt)
                         if isinstance(v.val, torch.Tensor) else v.val)
                for k, v in env.items()}

    def _envm(self, data: QPData, var_vals, mu_val) -> cg.Env:
        return self._lift(self._env(data, var_vals, mu_val))

    def _scalar(self, fn, acc: torch.Tensor) -> torch.Tensor:
        """``fn`` of a sum ``acc`` of the residual pipeline, taken in the
        scalar dtype and held in the working dtype (the reference rounds
        its pair sums so; a no-op on the plain pipeline)."""
        return fn(acc.to(self._sdt)).to(self.dtype)

    def _check_data(self, data: QPData) -> QPData:
        """Reject data on another device or of the wrong sizes; cast it
        to the working dtype.  Returns batched data."""
        for name in ("Q", "c", "A_ineq", "l_A_ineq", "u_A_ineq", "A_eq",
                     "b_eq", "l_x", "u_x"):
            t = getattr(data, name)
            if t.device.type != self.device.type or (
                    self.device.index is not None and
                    t.device.index != self.device.index):
                raise ValueError(f"QPData.{name} is on {t.device}, the "
                                 f"solver on {self.device}")
        if (data.n, data.m_ineq, data.m_eq) != (self.n, self.m_ineq,
                                                self.m_eq):
            raise ValueError(
                f"data sizes (n, m_ineq, m_eq) = "
                f"{(data.n, data.m_ineq, data.m_eq)}, solver built for "
                f"{(self.n, self.m_ineq, self.m_eq)}")
        if len(data.batch_shape) != 1:
            raise ValueError(f"expected one leading batch axis, got "
                             f"batch shape {data.batch_shape}")
        return data.to(dtype=self.dtype)

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def _metrics(self, env0, B: int):
        """(residual norm, duality gap) of the full system at mu=0, each
        (B,).  ``env0`` is a working env, or a lifted one (``_envm``)
        under df_residuals; the metrics come back in the working dtype."""
        zero = torch.zeros(B, dtype=self.dtype, device=self.device)
        if sum(self.var_sizes) == 0:
            return zero, zero
        memo = {}
        vals = [cg.as_vector(cg.evaluate(r, env0, memo), sz)
                for r, sz in zip(self.full.rhs, self.var_sizes)]
        r = torch.cat(vals, dim=-1)
        residual = self._scalar(torch.sqrt, (r * r).sum(-1))
        if self.comp_size == 0:
            return residual, zero
        comp = torch.cat([vals[i] for i in self.comp_rows], dim=-1)
        return residual, self._scalar(lambda t: t / self.comp_size,
                                      comp.abs().sum(-1))

    def _gap_only(self, env0, B: int):
        """Duality measure alone (only the complementarity rows), (B,)."""
        acc = torch.zeros(B, dtype=self._rdt, device=self.device)
        if self.comp_size == 0:
            return acc.to(self.dtype)
        memo = {}
        for i in self.comp_rows:
            v = cg.as_vector(cg.evaluate(self.full.rhs[i], env0, memo),
                             self.var_sizes[i])
            if v.shape[-1]:
                acc = acc + v.abs().sum(-1)
        return self._scalar(lambda t: t / self.comp_size, acc)

    def _done(self, state: IPMState, res_tol) -> torch.Tensor:
        return (state.residual < res_tol) & (state.gap < self.tol)

    # ------------------------------------------------------------------
    # iteration / loop
    # ------------------------------------------------------------------

    def _is_instance(self, data: QPData) -> bool:
        """Whether ``data`` is one instance: Q is (n, n) there and
        (B, n, n) in a batch, so a batch of one stays a batch."""
        return data.Q.dim() == 2

    def init_state(self, data: QPData,
                   warm_start: Optional[dict] = None) -> IPMState:
        """The initial iterate of one instance or of a batch: bound
        midpoints for x and s, ones elsewhere.  The data is checked and
        cast to the solver's dtype as ``solve`` checks it.
        ``warm_start`` maps variable names to starting values
        broadcastable to (B, size); nonnegative variables are kept at
        least 1e-2 from their bound."""
        one = self._is_instance(data)
        data = self._check_data(with_batch_axis(data, one))
        return without_batch_axis(self._init_batch(data, warm_start), one)

    def _init_batch(self, data: QPData,
                    warm_start: Optional[dict] = None) -> IPMState:
        """``init_state`` on checked, batched data."""
        if self._tf is not None:
            return self._tf._init_batch(data.to(dtype=torch.float64),
                                        self._tf_warm(warm_start))
        o = self.symbols
        B = data.Q.shape[0]
        init = {
            o.x: 0.5 * (data.l_x + data.u_x),
            o.s_A_ineq: 0.5 * (data.l_A_ineq + data.u_A_ineq),
        }
        nonneg = {self.full.variables[i] for i in self.nonneg_idx}
        vals = []
        for v, sz in zip(self.full.variables, self.var_sizes):
            if warm_start is not None and v.name in warm_start:
                w = torch.as_tensor(warm_start[v.name], dtype=self.dtype,
                                    device=self.device).expand(B, sz)
                if v in nonneg:
                    w = torch.clamp(w, min=1e-2)
                vals.append(w)
            elif v in init:
                vals.append(init[v])
            else:
                vals.append(torch.ones((B, sz), dtype=self.dtype,
                                       device=self.device))
        residual, gap = self._metrics(self._envm(data, vals, 0.0), B)
        return IPMState(
            vars=tuple(vals),
            mu=torch.full((B,), self.mu0, dtype=self.dtype,
                          device=self.device),
            iteration=torch.zeros(B, dtype=torch.int32, device=self.device),
            residual=residual, gap=gap)

    def _step_impl(self, state: IPMState, data: QPData,
                   gondzio: Optional[int] = None, nd_pre=None) -> IPMState:
        """One Mehrotra iteration of every instance of the batch."""
        if self._tf is not None:
            return self._tf._step_impl(
                tree_map(lambda t: t.to(torch.float64)
                         if t.is_floating_point() else t, state),
                data.to(dtype=torch.float64), gondzio=gondzio, nd_pre=nd_pre)
        B = data.Q.shape[0]
        env = self._env(data, state.vars, state.mu)
        envm = self._lift(env)

        # factor the augmented KKT once (always in the working dtype)
        solve_fn = self._make_solve(env, B, nd_pre=nd_pre)

        # affine predictor (mu = 0)
        renv = self._residual_env(envm, 0.0)
        d_aff = self._search_direction(solve_fn, renv)
        alpha_aff = self._max_step(env, state.vars, d_aff)

        # trial step -> mu_aff -> sigma
        trial = self._axpy(state.vars, alpha_aff, d_aff)
        gap_aff = self._gap_only(self._envm(data, trial, 0.0), B)
        mu_new = self._centring(state.gap, gap_aff)

        # corrector with recentred complementarity + affine correction
        cenv = self._residual_env(envm, mu_new, data=data,
                                  var_vals=state.vars, affine_deltas=d_aff)
        d_cc = self._search_direction(solve_fn, cenv)
        alpha = self._max_step(env, state.vars, d_cc)

        n_gondzio = self.gondzio if gondzio is None else gondzio
        for _ in range(n_gondzio):
            d_cc, alpha = self._gondzio_round(envm, data, state.vars,
                                              solve_fn, d_cc, alpha, mu_new)

        new_vars = self._axpy(state.vars, self.fraction_to_boundary * alpha,
                              d_cc)
        residual, new_gap = self._metrics(self._envm(data, new_vars, 0.0), B)
        return IPMState(vars=new_vars, mu=mu_new,
                        iteration=state.iteration + 1,
                        residual=residual, gap=new_gap)

    def _axpy(self, var_vals, alpha, deltas) -> tuple:
        """Every variable stepped by ``alpha`` (B,) of the scalar dtype
        along its delta."""
        a = alpha.to(self.dtype)[:, None]
        return tuple(v + a * d for v, d in zip(var_vals, deltas))

    def _centring(self, gap, gap_aff) -> torch.Tensor:
        """mu = gap sigma with sigma = (mu_aff / mu)^3, at least
        ``mu_floor``, computed in the scalar dtype."""
        g, ga = gap.to(self._sdt), gap_aff.to(self._sdt)
        pos = g > 0
        sigma = torch.where(pos, (ga / torch.where(
            pos, g, torch.ones_like(g))) ** 3, torch.zeros_like(g))
        return torch.clamp(g * sigma, min=self.mu_floor).to(self.dtype)

    def _result(self, state: IPMState, data: QPData, res_tol,
                diverged) -> SolveResult:
        env = self._env(data, state.vars, state.mu)
        return SolveResult(
            x=state.vars[self.var_index[self.symbols.x]],
            variables={v.name: val for v, val in
                       zip(self.full.variables, state.vars)},
            objective=cg.evaluate(self.objective_expr, env).val,
            iterations=state.iteration,
            residual=state.residual,
            gap=state.gap,
            converged=self._done(state, res_tol),
            diverged=diverged)

    def _res_tol(self, state: IPMState) -> torch.Tensor:
        if self.scale_tol:
            return (self.tol * (1.0 + state.residual.to(self._sdt))).to(
                self.dtype)
        return torch.full_like(state.residual, self.tol)

    def _nd_prework(self, data: QPData):
        """Loop-invariant prework of the nd diagonal-split path: the
        reference KKT (at a data-derived strictly interior point) cut
        into the plan's static slabs, plus its diagonal.  Computed once
        OUTSIDE the solver loop."""
        if self._mode != "nd" or not getattr(self, "_nd_diag_split",
                                             False):
            return None
        from ..ops.ndiss import nd_prework
        B = data.Q.shape[0]
        env_ref = self._nd_ref_env(self._base_env(data, 1.0))
        K_ref = self._assemble_kkt(env_ref, B)
        return (nd_prework(K_ref, self._nd_plan),
                self._assemble_diag(env_ref, B))

    def _solve_impl(self, data: QPData,
                    warm_start: Optional[dict] = None) -> SolveResult:
        """Solve every instance of a batch: the batched form of the
        reference's per-instance ``while_loop``."""
        if self._tf is not None:
            return self._on_tf(lambda tf: self._rounded(tf._solve_impl(
                data.to(dtype=torch.float64), self._tf_warm(warm_start))))
        self._ensure_nd_plan(data)
        state = self._init_batch(data, warm_start)
        res_tol = self._res_tol(state)
        nd_pre = self._nd_prework(data)

        diverged = torch.zeros_like(res_tol, dtype=torch.bool)
        while True:
            active = ~self._done(state, res_tol) & ~diverged & \
                (state.iteration < self.max_iter)
            self.host_syncs += 1
            if not bool(active.any()):
                break
            new = self._step_impl(state, data, nd_pre=nd_pre)
            # divergence rollback: a failed step keeps the last good
            # iterate and flags the instance
            failed = bad_iterate(new)
            state = where_instances(~active | failed, state, new)
            diverged = diverged | (active & failed)
        return self._result(state, data, res_tol,
                            diverged | bad_iterate(state))

    # ------------------------------------------------------------------
    # two_float: the iteration in float64
    # ------------------------------------------------------------------

    def _two_float_solver(self) -> "CompiledIPM":
        """The float64 solver a two_float solver runs on.  It keeps this
        solver's settings; the constants the reference holds in the
        working dtype (tol, mu0, delta0) are rounded to it, and its
        scalars stay in it (``_sdt``).  It factors by the dense LDL^T, as
        the reference's pair mode does, signed-regularised where the
        augmented system is indefinite (at float64's eps^(2/3) where the
        reference's pairs take 2^-48's)."""
        def w(v):
            return torch.tensor(v, dtype=self.dtype).item()
        tf = CompiledIPM(
            self.settings, self.n, self.m_ineq, self.m_eq, names=self.names,
            dtype=torch.float64, device=self.device, tol=w(self.tol),
            max_iter=self.max_iter,
            fraction_to_boundary=self.fraction_to_boundary, mu0=w(self.mu0),
            delta0=w(self.delta0), pivot_floor=self.pivot_floor,
            refine=self.refine, scale_tol=self.scale_tol,
            gondzio=self.gondzio, mu_floor=self.mu_floor, taylor=self.taylor,
            kernel="regldlt" if self._indefinite else "ldlt")
        tf._sdt = self.dtype
        return tf

    def _tf_warm(self, warm_start: Optional[dict]) -> Optional[dict]:
        """A warm start rounded to the working dtype, as the reference
        reads it."""
        if warm_start is None:
            return None
        return {k: torch.as_tensor(v, device=self.device).to(self.dtype)
                for k, v in warm_start.items()}

    def _on_tf(self, fn):
        """``fn(self._tf)``, with the float64 solver's host syncs and
        escalated instances counted here too."""
        tf = self._tf
        syncs, escalated = tf.host_syncs, tf.escalated
        out = fn(tf)
        self.host_syncs += tf.host_syncs - syncs
        self.escalated = self.escalated + (tf.escalated - escalated)
        return out

    def _rounded(self, res: SolveResult) -> SolveResult:
        """A result of the float64 iteration with its values rounded to
        the working dtype (the reference's hi + lo); iterations and flags
        as they are."""
        dt = self.dtype
        return dataclasses.replace(
            res, x=res.x.to(dt),
            variables={k: v.to(dt) for k, v in res.variables.items()},
            objective=res.objective.to(dt), residual=res.residual.to(dt),
            gap=res.gap.to(dt))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def solve(self, data: QPData,
              warm_start: Optional[dict] = None) -> SolveResult:
        """Solve one QP instance (fields without a batch axis).

        ``warm_start``: optional dict of variable name -> initial value
        (e.g. a previous ``SolveResult.variables``)."""
        one = self._check_data(with_batch_axis(data, True))
        return without_batch_axis(self._solve_impl(one, warm_start), True)

    def step(self, state: IPMState, data: QPData) -> IPMState:
        """One IPM iteration of one instance, or of a batch (then a
        leading batch axis on ``data`` and on every field of
        ``state``)."""
        one = self._is_instance(data)
        data = self._check_data(with_batch_axis(data, one))
        new = self._step_impl(with_batch_axis(state, one), data)
        return without_batch_axis(new, one)

    def solve_batch(self, data: QPData) -> SolveResult:
        """Solve a batch of QPs (leading batch axis on every field)."""
        return self._solve_impl(self._check_data(data))
