"""Banded+arrow structured IPM for box-constrained QPs.

Counterpart of :mod:`ipmzoo_tpu.models.arrow`.  The structured twin of
:class:`CompiledIPM` for QPs whose Hessian is banded with a small dense
arrow (coupling variables): chains of locally coupled decision variables
with a few global resources.  The dense path factors the condensed system
in O(n^3) per iteration; here it is O(n (b + t)^2) through
:mod:`ipmzoo_tpu_torch.ops.banded`, with the same Mehrotra
predictor-corrector loop and constants as the dense solver (tol 1e-8, 100
iterations, fraction-to-boundary 0.995, sigma = (mu_aff / mu)^3) and the
exact-Taylor corrector (bilinear complementarity rows -> dx * dlambda).

Formulation: Slacks handling of two-sided variable bounds,

    minimize 1/2 x^T Q x + c^T x   s.t.   l <= x <= u

with implicit slacks g = x - l, h = u - x and bound duals lambda_g,
lambda_h >= 0.  The barrier-condensed Newton system is H dx = -r with
H = Q + diag(lambda_g / g + lambda_h / h): a diagonal modification, so H
keeps Q's banded+arrow sparsity exactly.

Every iteration factors the banded part once and solves against it twice:
the t arrow columns and the predictor in one solve with k = t + 1
right-hand sides, the corrector with k = 1.  On CUDA tensors with the
default ``method`` that is one launch of kernel K6 and two of K7 per
iteration for the whole batch (:mod:`ipmzoo_tpu_torch.ops.cuda_cr`).

Where the reference is a pure function of one instance batched by
``vmap``, the methods here take a leading batch axis on every leaf;
:meth:`ArrowIPM.solve` and ``init_state`` add and remove it for one
instance.  The loop asks the device once per iteration whether an
instance is still active (``host_syncs``); finished and diverged
instances are frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.banded import (ArrowStructure, arrow_factor_solve, arrow_solve,
                          band_to_blocks, check_method, detect_arrow)
from ..utils.device import resolve_device
from ..utils.precision import apply_default_matmul_precision
from .state import (bad_iterate, step_ratio, tree_map, where_instances,
                    with_batch_axis, without_batch_axis)


@dataclasses.dataclass
class ArrowQPData:
    """Box QP with banded+arrow Hessian, stored structurally (already in
    detector order; a batch axis may precede every leaf)."""
    D: torch.Tensor      # ([B,] N, b, b) diagonal blocks of the banded part
    E: torch.Tensor      # ([B,] N-1, b, b) sub-diagonal blocks
    U: torch.Tensor      # ([B,] t, nb) arrow strip
    Ct: torch.Tensor     # ([B,] t, t) arrow tip
    c: torch.Tensor      # ([B,] n) linear term (n = nb + t)
    l_x: torch.Tensor    # ([B,] n)
    u_x: torch.Tensor    # ([B,] n)

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.c.shape[:-1])

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "ArrowQPData":
        """Every field moved to ``device`` and cast to ``dtype``."""
        return tree_map(lambda a: a.to(device=device, dtype=dtype), self)

    @staticmethod
    def stack(datas) -> "ArrowQPData":
        """A batch from instances of one structure."""
        return tree_map(lambda *xs: torch.stack(xs), *datas)

    @staticmethod
    def from_dense(Q, c, l_x, u_x,
                   structure: Optional[ArrowStructure] = None,
                   block: Optional[int] = None,
                   dtype: torch.dtype = torch.float64, device=None):
        """Detect (or take) the arrow structure, permute, pad the banded
        part to a block multiple, and extract the structured blocks on
        ``device`` (default: the CUDA device).

        Returns (data, structure, block): keep ``structure`` to un-permute
        solutions and to build more instances with the same sparsity."""
        device = resolve_device(device)
        Q = np.asarray(Q)
        n = Q.shape[0]
        if structure is None:
            structure = detect_arrow(Q)
        p, b_detected, t = structure.perm, structure.bandwidth, \
            structure.tip
        block = block or max(8, b_detected)
        if block < b_detected:
            raise ValueError(f"block {block} < bandwidth {b_detected}")
        Qp = Q[np.ix_(p, p)]
        cp = np.asarray(c)[p]
        lp = np.asarray(l_x)[p]
        up = np.asarray(u_x)[p]
        nb = n - t
        pad = (-nb) % block
        if pad:
            # benign interior variables: identity Hessian, bounds +-1
            Qpad = np.zeros((n + pad, n + pad))
            Qpad[:nb, :nb] = Qp[:nb, :nb]
            Qpad[nb:nb + pad, nb:nb + pad] = np.eye(pad)
            Qpad[nb + pad:, :nb] = Qp[nb:, :nb]
            Qpad[:nb, nb + pad:] = Qp[:nb, nb:]
            Qpad[nb + pad:, nb + pad:] = Qp[nb:, nb:]
            Qp = Qpad
            cp = np.concatenate([cp[:nb], np.zeros(pad), cp[nb:]])
            lp = np.concatenate([lp[:nb], -np.ones(pad), lp[nb:]])
            up = np.concatenate([up[:nb], np.ones(pad), up[nb:]])

        def arr(v):
            # cast on the host (numpy's rounding), then move
            return torch.tensor(np.asarray(v)).to(dtype).to(device)

        D, E, U, Ct = band_to_blocks(arr(Qp), block, t)
        data = ArrowQPData(D=D, E=E, U=U.contiguous(), Ct=Ct.contiguous(),
                           c=arr(cp), l_x=arr(lp), u_x=arr(up))
        return data, structure, block


@dataclasses.dataclass
class ArrowState:
    vars: tuple                 # (x, lambda_g, lambda_h), each (B, n)
    mu: torch.Tensor            # (B,)
    iteration: torch.Tensor     # (B,) int32
    residual: torch.Tensor      # (B,)
    gap: torch.Tensor           # (B,)
    #: dual residual Qx + c - lambda_g + lambda_h at ``vars``, carried
    #: through the loop: the metrics evaluation at the end of a step
    #: computes it, so the next step's direction phase reuses it instead
    #: of running the structured matvec again.
    rx: torch.Tensor            # (B, n)


@dataclasses.dataclass
class ArrowSolveResult:
    x: torch.Tensor             # solution in the ORIGINAL variable order
    variables: dict             # solver order (permuted, padded)
    objective: torch.Tensor
    iterations: torch.Tensor
    residual: torch.Tensor
    gap: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor


class ArrowIPM:
    """Mehrotra predictor-corrector IPM with an O(n (b+t)^2) per-iteration
    banded+arrow factorisation.

    ``device`` is where the solver's tensors live (default: the CUDA
    device; without one that raises, pass ``device="cpu"`` for the CPU);
    data on any other device is rejected."""

    def __init__(self, n_banded_blocks: int, block: int, tip: int, *,
                 structure: Optional[ArrowStructure] = None,
                 dtype: torch.dtype = torch.float64, device=None,
                 tol: float = 1e-8, max_iter: int = 100,
                 fraction_to_boundary: float = 0.995, mu0: float = 1.0,
                 method: str = "auto"):
        apply_default_matmul_precision()
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, not {dtype}")
        check_method(method)
        #: banded factor engine: "scan" | "cr" | "pl" | "auto"
        #: (see ops/banded.py)
        self.method = method
        self.N, self.b, self.t = n_banded_blocks, block, tip
        self.n = n_banded_blocks * block + tip
        self.structure = structure
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tol = tol
        self.max_iter = max_iter
        self.fraction_to_boundary = fraction_to_boundary
        self.mu0 = mu0
        self.comp_count = 2 * self.n
        #: times a loop asked the device whether any instance is active
        self.host_syncs = 0

    @staticmethod
    def for_data(data: ArrowQPData, structure=None, **kw) -> "ArrowIPM":
        """A solver of the data's sizes, on the data's device unless
        ``device`` is given."""
        N, b = data.D.shape[-3], data.D.shape[-1]
        t = data.Ct.shape[-1]
        kw.setdefault("device", data.D.device)
        return ArrowIPM(N, b, t, structure=structure, **kw)

    # -- structured matvec ------------------------------------------------

    def _qx(self, data: ArrowQPData, x):
        B = x.shape[0]
        nb = self.N * self.b
        xb = x[:, :nb].reshape(B, self.N, self.b)
        xt = x[:, nb:]
        yb = torch.einsum("anij,anj->ani", data.D, xb)
        if self.N > 1:
            lower = torch.einsum("anij,anj->ani", data.E, xb[:, :-1])
            upper = torch.einsum("anji,anj->ani", data.E, xb[:, 1:])
            zero = torch.zeros_like(yb[:, :1])
            yb = yb + torch.cat([zero, lower], dim=1)
            yb = yb + torch.cat([upper, zero], dim=1)
        if self.t:
            yb = yb + torch.einsum("atk,at->ak", data.U, xt).reshape(
                B, self.N, self.b)
            yt = torch.einsum("atk,ak->at", data.U, x[:, :nb]) + \
                torch.einsum("ats,as->at", data.Ct, xt)
        else:
            yt = xt
        return torch.cat([yb.reshape(B, nb), yt], dim=-1)

    # -- residuals / metrics ----------------------------------------------

    def _slacks(self, data, x):
        return x - data.l_x, data.u_x - x

    def _metrics(self, data, vars):
        """(residual, gap, rx): rx returned so callers can carry it."""
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        rx = self._qx(data, x) + data.c - lg + lh
        comps = torch.cat([g * lg, h * lh], dim=-1)
        r = torch.cat([rx, comps], dim=-1)
        return torch.sqrt((r * r).sum(-1)), \
            comps.abs().sum(-1) / self.comp_count, rx

    # -- direction ---------------------------------------------------------

    def _condensed(self, data, vars):
        """Barrier-condensed diagonal blocks (D + diag(w), Ct + diag(w))."""
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        w = lg / g + lh / h
        nb = self.N * self.b
        D = data.D + torch.diag_embed(
            w[:, :nb].reshape(-1, self.N, self.b))
        Ct = data.Ct + torch.diag_embed(w[:, nb:]) if self.t else data.Ct
        return D, Ct

    def _direction(self, data, vars, factors, rx, cg, ch):
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        rhs = -(rx + cg / g - ch / h)
        nb = self.N * self.b
        dxb, dxt = arrow_solve(factors, rhs[:, :nb], rhs[:, nb:])
        dx = torch.cat([dxb, dxt], dim=-1)
        dlg = (-cg - lg * dx) / g
        dlh = (-ch + lh * dx) / h
        return dx, dlg, dlh

    def _max_step(self, data, vars, d):
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        dx, dlg, dlh = d
        alpha = torch.ones(x.shape[0], dtype=self.dtype, device=x.device)
        alpha = step_ratio(alpha, g, dx)
        alpha = step_ratio(alpha, h, -dx)
        alpha = step_ratio(alpha, lg, dlg)
        alpha = step_ratio(alpha, lh, dlh)
        return alpha

    def _gap_at(self, data, vars):
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        return ((g * lg).abs().sum(-1) + (h * lh).abs().sum(-1)) / \
            self.comp_count

    # -- loop ----------------------------------------------------------------

    def _check_data(self, data: ArrowQPData) -> ArrowQPData:
        """Reject data on another device or of the wrong sizes; cast it
        to the working dtype.  Takes and returns batched data."""
        for f in dataclasses.fields(data):
            a = getattr(data, f.name)
            if a.device.type != self.device.type or (
                    self.device.index is not None and
                    a.device.index != self.device.index):
                raise ValueError(f"ArrowQPData.{f.name} is on {a.device}, "
                                 f"the solver on {self.device}")
        if len(data.batch_shape) != 1:
            raise ValueError(f"expected one leading batch axis, got batch "
                             f"shape {data.batch_shape}")
        B = data.batch_shape[0]
        N, b, t, n = self.N, self.b, self.t, self.n
        want = {"D": (B, N, b, b), "E": (B, max(N - 1, 0), b, b),
                "U": (B, t, N * b), "Ct": (B, t, t), "c": (B, n),
                "l_x": (B, n), "u_x": (B, n)}
        for name, shape in want.items():
            if tuple(getattr(data, name).shape) != shape:
                raise ValueError(
                    f"ArrowQPData.{name} has shape "
                    f"{tuple(getattr(data, name).shape)}, solver built for "
                    f"{shape} (N, b, t) = {(N, b, t)}")
        return data.to(dtype=self.dtype)

    def _is_instance(self, data: ArrowQPData) -> bool:
        """Whether ``data`` is one instance: c is (n,) there and (B, n) in
        a batch, so a batch of one stays a batch."""
        return data.c.dim() == 1

    def init_state(self, data: ArrowQPData,
                   warm_start: Optional[dict] = None) -> ArrowState:
        """Bound midpoints / ones for one instance or a batch, or a warm
        start (a previous ``ArrowSolveResult.variables``, in solver
        order): x is clipped strictly inside the bounds, duals floored
        away from zero, the same safeguards as :class:`CompiledIPM`.  The
        data is checked and cast to the solver's dtype as ``solve``
        checks it."""
        one = self._is_instance(data)
        data = self._check_data(with_batch_axis(data, one))
        return without_batch_axis(self._init_batch(data, warm_start), one)

    def _init_batch(self, data: ArrowQPData,
                    warm_start: Optional[dict] = None) -> ArrowState:
        """``init_state`` on checked, batched data."""
        dt, dev = self.dtype, data.c.device
        B = data.c.shape[0]
        x = 0.5 * (data.l_x + data.u_x)
        ones = torch.ones((B, self.n), dtype=dt, device=dev)
        vals = [x, ones, ones]
        if warm_start is not None:
            eps = 1e-2
            for i, name in enumerate(("x", "lambda_g", "lambda_h")):
                if name not in warm_start:
                    continue
                w = torch.as_tensor(warm_start[name], dtype=dt,
                                    device=dev).expand(B, self.n)
                if name == "x":
                    span = data.u_x - data.l_x
                    w = torch.minimum(torch.maximum(
                        w, data.l_x + eps * span), data.u_x - eps * span)
                else:
                    w = torch.clamp(w, min=eps)
                vals[i] = w
        vars = tuple(vals)
        residual, gap, rx = self._metrics(data, vars)
        return ArrowState(
            vars=vars, mu=torch.full((B,), self.mu0, dtype=dt, device=dev),
            iteration=torch.zeros(B, dtype=torch.int32, device=dev),
            residual=residual, gap=gap, rx=rx)

    def _step_impl(self, state: ArrowState,
                   data: ArrowQPData) -> ArrowState:
        """One Mehrotra iteration of every instance of the batch."""
        vars = state.vars
        x, lg, lh = vars
        g, h = self._slacks(data, x)
        gap = state.gap
        rx = state.rx          # carried from the previous metrics pass

        # affine predictor (mu = 0), its banded solve stacked onto the
        # factor's arrow-strip multi-rhs solve (one k = t+1 solve instead
        # of a k = t solve and a separate k = 1 predictor solve)
        cg_a, ch_a = g * lg, h * lh
        rhs = -(rx + cg_a / g - ch_a / h)
        nb = self.N * self.b
        Dc, Ctc = self._condensed(data, vars)
        factors, (dxb_a, dxt_a) = arrow_factor_solve(
            Dc, data.E, data.U, Ctc, rhs[:, :nb], rhs[:, nb:],
            method=self.method)
        dx_a = torch.cat([dxb_a, dxt_a], dim=-1)
        d_aff = (dx_a, (-cg_a - lg * dx_a) / g, (-ch_a + lh * dx_a) / h)
        alpha_aff = self._max_step(data, vars, d_aff)
        trial = tuple(v + alpha_aff[:, None] * dv
                      for v, dv in zip(vars, d_aff))
        gap_aff = self._gap_at(data, trial)
        pos = gap > 0
        sigma = torch.where(pos, (gap_aff / torch.where(
            pos, gap, torch.ones_like(gap))) ** 3, torch.zeros_like(gap))
        mu_new = gap * sigma

        # corrector: recentred + exact second-order (bilinear rows)
        dx_a, dlg_a, dlh_a = d_aff
        m = mu_new[:, None]
        cg = g * lg - m + dx_a * dlg_a
        ch = h * lh - m + (-dx_a) * dlh_a
        d_cc = self._direction(data, vars, factors, rx, cg, ch)
        alpha = self._max_step(data, vars, d_cc)

        step = (self.fraction_to_boundary * alpha)[:, None]
        new_vars = tuple(v + step * dv for v, dv in zip(vars, d_cc))
        residual, new_gap, new_rx = self._metrics(data, new_vars)
        return ArrowState(vars=new_vars, mu=mu_new,
                          iteration=state.iteration + 1,
                          residual=residual, gap=new_gap, rx=new_rx)

    def _objective(self, data, x):
        return 0.5 * (x * self._qx(data, x)).sum(-1) + (data.c * x).sum(-1)

    def _unpermute(self, x):
        """Map the (padded, permuted) solution back to original order."""
        if self.structure is None:
            return x
        p = np.asarray(self.structure.perm)
        n_orig = p.size
        nb_orig = n_orig - self.structure.tip
        nb = self.N * self.b
        keep = torch.cat([x[..., :nb_orig], x[..., nb:]], dim=-1)
        inv = np.empty(n_orig, dtype=np.int64)
        inv[p] = np.arange(n_orig)
        return keep[..., torch.as_tensor(inv, device=x.device)]

    def _done(self, state: ArrowState) -> torch.Tensor:
        return (state.residual < self.tol) & (state.gap < self.tol)

    def _solve_impl(self, data: ArrowQPData,
                    warm_start: Optional[dict] = None) -> ArrowSolveResult:
        """Solve every instance of a batch: the batched form of the
        reference's per-instance ``while_loop``."""
        state = self._init_batch(data, warm_start)
        diverged = torch.zeros_like(state.residual, dtype=torch.bool)
        while True:
            active = ~self._done(state) & ~diverged & \
                (state.iteration < self.max_iter)
            self.host_syncs += 1
            if not bool(active.any()):
                break
            new = self._step_impl(state, data)
            # divergence rollback: a failed step keeps the last good
            # iterate and flags the instance
            failed = bad_iterate(new)
            state = where_instances(~active | failed, state, new)
            diverged = diverged | (active & failed)
        x, lg, lh = state.vars
        return ArrowSolveResult(
            x=self._unpermute(x),
            variables={"x": x, "lambda_g": lg, "lambda_h": lh},
            objective=self._objective(data, x),
            iterations=state.iteration,
            residual=state.residual,
            gap=state.gap,
            converged=self._done(state),
            diverged=diverged | bad_iterate(state))

    # -- public ----------------------------------------------------------

    def solve(self, data: ArrowQPData,
              warm_start: Optional[dict] = None) -> ArrowSolveResult:
        """Solve one instance (fields without a batch axis);
        ``warm_start`` takes a previous result's ``variables`` dict
        (receding-horizon / homotopy pattern)."""
        one = self._check_data(with_batch_axis(data, True))
        return without_batch_axis(self._solve_impl(one, warm_start), True)

    def step(self, state: ArrowState, data: ArrowQPData) -> ArrowState:
        """One IPM iteration of a batch (leading batch axis on ``data``
        and on every field of ``state``)."""
        return self._step_impl(state, self._check_data(data))

    def solve_batch(self, data: ArrowQPData) -> ArrowSolveResult:
        """Solve a batch of instances of one structure (leading batch
        axis on every field)."""
        return self._solve_impl(self._check_data(data))
