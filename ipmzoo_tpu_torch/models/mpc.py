"""Structured MPC: block-tridiagonal IPM with a Riccati inner solver.

Counterpart of :mod:`ipmzoo_tpu.models.mpc`.  The condensed MPC family
eliminates states and hands a dense (T*nu)-dimensional box QP to the
generic solver, O((T nu)^3) per IPM iteration.  This module keeps the
optimal-control structure: states stay variables, the Newton system is
block-tridiagonal, and each iteration is an O(T (ns+nu)^3) Riccati
factor/solve pair (:mod:`ipmzoo_tpu_torch.ops.riccati`) inside the same
Mehrotra predictor-corrector loop as :class:`CompiledIPM`, with the same
constants (tol 1e-8, 100 iterations, fraction-to-boundary 0.995,
sigma = (mu_aff/mu)^3) and the exact-Taylor-remainder corrector
(complementarity rows here are bilinear, so the remainder
du_aff * dlambda_aff is exact).

Problem (x_0 fixed; x-index below runs 1..T):

    minimize    sum_{k=1}^{T} 1/2 x_k' Q_k x_k + q_k' x_k
              + sum_{k=0}^{T-1} 1/2 u_k' R_k u_k + r_k' u_k
    subject to  x_{k+1} = A_k x_k + B_k u_k + c_k
                l_u <= u_k <= u_u            (always)
                l_x <= x_k <= u_x, k>=1      (``state_bounds=True``)

Bounds are handled primal-dual with implicit slacks g = v - l,
h = u - v and complementarity G lambda_g = mu e, H lambda_h = mu e; the
barrier contributions condense into diagonal modifications of R_k / Q_k,
exactly the structure the Riccati recursion consumes.

Where the reference is a pure function of one instance batched by
``vmap``, the methods here take a leading batch axis on every leaf
(batch first, then the stage axis); :meth:`RiccatiIPM.solve`,
``init_state`` and ``step`` add and remove it for one instance.  The
loop asks the device once per iteration whether an instance is still
active (``host_syncs``); converged, diverged and exhausted instances are
frozen, as the reference's ``vmap(while_loop)`` freezes them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.riccati import riccati_factor, riccati_solve
from ..utils.device import resolve_device
from ..utils.precision import apply_default_matmul_precision
from .state import (bad_iterate, step_ratio, tree_map, where_instances,
                    with_batch_axis, without_batch_axis)


@dataclasses.dataclass
class MPCData:
    """Stagewise MPC problem data (stage axis after the batch axes, on
    every leaf)."""
    A: torch.Tensor     # ([B,] T, ns, ns) dynamics
    B: torch.Tensor     # ([B,] T, ns, nu)
    c: torch.Tensor     # ([B,] T, ns) affine dynamics offsets
    x0: torch.Tensor    # ([B,] ns) fixed initial state
    Q: torch.Tensor     # ([B,] T, ns, ns) cost Hessian of x_1..x_T
    q: torch.Tensor     # ([B,] T, ns)
    R: torch.Tensor     # ([B,] T, nu, nu)
    r: torch.Tensor     # ([B,] T, nu)
    l_u: torch.Tensor   # ([B,] T, nu)
    u_u: torch.Tensor   # ([B,] T, nu)
    l_x: torch.Tensor   # ([B,] T, ns) bounds on x_1..x_T
    u_x: torch.Tensor   # ([B,] T, ns)

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.A.shape[:-3])

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "MPCData":
        """Every field moved to ``device`` and cast to ``dtype``."""
        return tree_map(lambda a: a.to(device=device, dtype=dtype), self)


@dataclasses.dataclass
class MPCState:
    """Carry of the iteration loop; every field has a leading batch
    axis."""
    vars: tuple                 # per-variable (B, T, size), in _var_names
    mu: torch.Tensor            # (B,)
    iteration: torch.Tensor     # (B,) int32
    residual: torch.Tensor      # (B,)
    gap: torch.Tensor           # (B,)
    #: (ru, rx, rd) residual triple at ``vars``, carried through the
    #: loop: the end-of-step metrics evaluation already computes it, so
    #: the next step's direction phase reuses it
    res: tuple = None


@dataclasses.dataclass
class MPCSolveResult:
    x: torch.Tensor             # ([B,] T, ns) state trajectory x_1..x_T
    u: torch.Tensor             # ([B,] T, nu) control trajectory
    variables: dict             # every KKT variable by name
    objective: torch.Tensor
    iterations: torch.Tensor
    residual: torch.Tensor
    gap: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor


def _add_diag(M, dvec):
    """M_k + diag(dvec_k) over the stage axis."""
    return M + torch.diag_embed(dvec)


def _lane(s):
    """A per-instance scalar (B,) broadcast over (B, T, size)."""
    return s[:, None, None]


class RiccatiIPM:
    """Mehrotra predictor-corrector IPM over the MPC structure.

    Variables (in ``MPCState.vars`` order): u (T,nu), x (T,ns) for
    x_1..x_T, y (T,ns) dynamics duals, lambda_g/lambda_h (T,nu) bound
    duals of u; with ``state_bounds=True`` additionally
    lambda_gx/lambda_hx (T,ns).

    ``device`` is where the solver's tensors live (default: the CUDA
    device; without one that raises, pass ``device="cpu"`` for the CPU);
    data on any other device is rejected."""

    def __init__(self, horizon: int, n_states: int, n_controls: int, *,
                 state_bounds: bool = False,
                 dtype: torch.dtype = torch.float64, device=None,
                 tol: float = 1e-8, max_iter: int = 100,
                 fraction_to_boundary: float = 0.995, mu0: float = 1.0,
                 gondzio: int = 0):
        apply_default_matmul_precision()
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, not {dtype}")
        self.T, self.ns, self.nu = horizon, n_states, n_controls
        self.state_bounds = state_bounds
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tol = tol
        self.max_iter = max_iter
        self.fraction_to_boundary = fraction_to_boundary
        self.mu0 = mu0
        #: Gondzio multiple-centrality-corrector rounds per iteration
        #: (extra solves against the existing Riccati factor chain,
        #: accepted per instance only if its step lengthens)
        self.gondzio = gondzio
        #: complementarity pairs counted in the duality measure
        self.comp_count = 2 * horizon * n_controls + (
            2 * horizon * n_states if state_bounds else 0)
        #: times a loop asked the device whether any instance is active
        self.host_syncs = 0

    # -- residuals ---------------------------------------------------------

    def _slacks(self, data: MPCData, u, x):
        g = u - data.l_u
        h = data.u_u - u
        if self.state_bounds:
            return g, h, x - data.l_x, data.u_x - x
        return g, h, None, None

    def _residuals(self, data: MPCData, vars):
        """Stationarity and dynamics residuals (mu-independent parts)."""
        u, x, y = vars[0], vars[1], vars[2]
        lg, lh = vars[3], vars[4]
        ru = (torch.einsum("bkij,bkj->bki", data.R, u) + data.r
              - torch.einsum("bkiu,bki->bku", data.B, y) - lg + lh)
        Aty = torch.einsum("bkij,bki->bkj", data.A, y)      # A_k^T y_k
        Aty_next = torch.cat([Aty[:, 1:], torch.zeros_like(Aty[:, :1])],
                             dim=1)
        rx = (torch.einsum("bkij,bkj->bki", data.Q, x) + data.q + y
              - Aty_next)
        if self.state_bounds:
            rx = rx - vars[5] + vars[6]
        xprev = torch.cat([data.x0[:, None], x[:, :-1]], dim=1)
        rd = (x - torch.einsum("bkij,bkj->bki", data.A, xprev)
              - torch.einsum("bkiu,bku->bki", data.B, u) - data.c)
        return ru, rx, rd

    def _metrics(self, data: MPCData, vars):
        """(residual norm, duality measure, (ru, rx, rd)) at mu = 0."""
        u, x = vars[0], vars[1]
        g, h, gx, hx = self._slacks(data, u, x)
        ru, rx, rd = self._residuals(data, vars)
        comps = [g * vars[3], h * vars[4]]
        if self.state_bounds:
            comps += [gx * vars[5], hx * vars[6]]
        r = torch.cat([p.flatten(1) for p in [ru, rx, rd] + comps], dim=1)
        residual = torch.sqrt((r * r).sum(-1))
        gap = sum(c.abs().flatten(1).sum(-1) for c in comps) / \
            self.comp_count
        return residual, gap, (ru, rx, rd)

    # -- directions --------------------------------------------------------

    def _direction(self, data, vars, factors, ru, rx, rd, comp):
        """Newton direction for given complementarity residual vectors
        ``comp = (cg, ch[, cgx, chx])``, reusing the factor chain."""
        u, x = vars[0], vars[1]
        lg, lh = vars[3], vars[4]
        g, h, gx, hx = self._slacks(data, u, x)
        cg, ch = comp[0], comp[1]
        ru_t = ru + cg / g - ch / h
        rx_t = rx
        if self.state_bounds:
            cgx, chx = comp[2], comp[3]
            rx_t = rx + cgx / gx - chx / hx
        dx, du, dy = riccati_solve(factors, data.A, data.B, rx_t, ru_t, -rd)
        ds = [du, dx, dy, (-cg - lg * du) / g, (-ch + lh * du) / h]
        if self.state_bounds:
            ds += [(-cgx - vars[5] * dx) / gx, (-chx + vars[6] * dx) / hx]
        return tuple(ds)

    def _max_step(self, data, vars, d):
        u, x = vars[0], vars[1]
        g, h, gx, hx = self._slacks(data, u, x)
        du, dx = d[0], d[1]
        alpha = torch.ones(u.shape[0], dtype=self.dtype, device=u.device)
        alpha = step_ratio(alpha, g, du)
        alpha = step_ratio(alpha, h, -du)
        alpha = step_ratio(alpha, vars[3], d[3])
        alpha = step_ratio(alpha, vars[4], d[4])
        if self.state_bounds:
            alpha = step_ratio(alpha, gx, dx)
            alpha = step_ratio(alpha, hx, -dx)
            alpha = step_ratio(alpha, vars[5], d[5])
            alpha = step_ratio(alpha, vars[6], d[6])
        return alpha

    def _gap_at(self, data, vars):
        u, x = vars[0], vars[1]
        g, h, gx, hx = self._slacks(data, u, x)
        acc = (g * vars[3]).abs().flatten(1).sum(-1) + \
            (h * vars[4]).abs().flatten(1).sum(-1)
        if self.state_bounds:
            acc = acc + (gx * vars[5]).abs().flatten(1).sum(-1)
            acc = acc + (hx * vars[6]).abs().flatten(1).sum(-1)
        return acc / self.comp_count

    # -- iteration / loop --------------------------------------------------

    def _check_data(self, data: MPCData) -> MPCData:
        """Reject data on another device or of the wrong sizes; cast it
        to the working dtype.  Takes and returns batched data."""
        for f in dataclasses.fields(data):
            a = getattr(data, f.name)
            if a.device.type != self.device.type or (
                    self.device.index is not None and
                    a.device.index != self.device.index):
                raise ValueError(f"MPCData.{f.name} is on {a.device}, the "
                                 f"solver on {self.device}")
        if len(data.batch_shape) != 1:
            raise ValueError(f"expected one leading batch axis, got batch "
                             f"shape {data.batch_shape}")
        Bn, T, ns, nu = data.batch_shape[0], self.T, self.ns, self.nu
        want = {"A": (T, ns, ns), "B": (T, ns, nu), "c": (T, ns),
                "x0": (ns,), "Q": (T, ns, ns), "q": (T, ns),
                "R": (T, nu, nu), "r": (T, nu), "l_u": (T, nu),
                "u_u": (T, nu), "l_x": (T, ns), "u_x": (T, ns)}
        for name, shape in want.items():
            got = tuple(getattr(data, name).shape)
            if got != (Bn,) + shape:
                raise ValueError(
                    f"MPCData.{name} has shape {got}, solver built for "
                    f"{(Bn,) + shape} (T, ns, nu) = {(T, ns, nu)}")
        return data.to(dtype=self.dtype)

    def _var_names(self):
        names = ["u", "x", "y", "lambda_g", "lambda_h"]
        if self.state_bounds:
            names += ["lambda_gx", "lambda_hx"]
        return names

    def _is_instance(self, data: MPCData) -> bool:
        """Whether ``data`` is one instance: A is (T, ns, ns) there and
        (B, T, ns, ns) in a batch, so a batch of one stays a batch."""
        return data.A.dim() == 3

    def init_state(self, data: MPCData,
                   warm_start: Optional[dict] = None) -> MPCState:
        """Bound midpoints for u (and x under state bounds; otherwise the
        dynamics rollout, which zeroes the dynamics residual), ones for
        duals; or a warm start (a previous ``MPCSolveResult.variables``):
        u (and x under state bounds) clipped strictly inside the bounds,
        duals floored away from zero.  Takes one instance or a batch,
        checked and cast to the solver's dtype as ``solve`` checks it."""
        one = self._is_instance(data)
        data = self._check_data(with_batch_axis(data, one))
        return without_batch_axis(self._init_batch(data, warm_start), one)

    def _init_batch(self, data: MPCData,
                    warm_start: Optional[dict] = None) -> MPCState:
        """``init_state`` on checked, batched data."""
        dt, dev = self.dtype, data.A.device
        Bn, T, ns, nu = data.A.shape[0], self.T, self.ns, self.nu
        u = 0.5 * (data.l_u + data.u_u)
        if self.state_bounds:
            x = 0.5 * (data.l_x + data.u_x)
        else:
            xk, xs = data.x0, []
            for k in range(T):
                xk = (data.A[:, k] @ xk[..., None])[..., 0] + \
                    (data.B[:, k] @ u[:, k, :, None])[..., 0] + data.c[:, k]
                xs.append(xk)
            x = torch.stack(xs, dim=1)

        def ones(n):
            return torch.ones((Bn, T, n), dtype=dt, device=dev)

        vals = [u, x, ones(ns), ones(nu), ones(nu)]
        if self.state_bounds:
            vals += [ones(ns), ones(ns)]
        if warm_start is not None:
            eps = 1e-2
            for i, name in enumerate(self._var_names()):
                if name not in warm_start:
                    continue
                w = torch.as_tensor(warm_start[name], dtype=dt, device=dev)
                w = torch.broadcast_to(w, vals[i].shape)
                if name == "u":
                    span = data.u_u - data.l_u
                    w = torch.minimum(torch.maximum(
                        w, data.l_u + eps * span), data.u_u - eps * span)
                elif name == "x" and self.state_bounds:
                    span = data.u_x - data.l_x
                    w = torch.minimum(torch.maximum(
                        w, data.l_x + eps * span), data.u_x - eps * span)
                elif name.startswith("lambda_"):
                    w = torch.clamp(w, min=eps)
                vals[i] = w
        vars = tuple(vals)
        residual, gap, res = self._metrics(data, vars)
        return MPCState(
            vars=vars, mu=torch.full((Bn,), self.mu0, dtype=dt, device=dev),
            iteration=torch.zeros(Bn, dtype=torch.int32, device=dev),
            residual=residual, gap=gap, res=res)

    def _gondzio_round(self, data, vars, factors, d, alpha, mu_target,
                       beta_min=0.1, beta_max=10.0, delta_alpha=0.1,
                       gamma=0.1):
        """One Gondzio centrality-corrector round (Gondzio 1996): at the
        enlarged trial step, complementarity products outside
        [beta_min, beta_max]*mu are pulled to the nearest bound with an
        extra solve against the SAME factor chain; each instance keeps it
        only if its own step lengthens."""
        alpha_t = torch.clamp(alpha + delta_alpha, max=1.0)
        trial = tuple(v + _lane(alpha_t) * dv for v, dv in zip(vars, d))
        g_t, h_t, gx_t, hx_t = self._slacks(data, trial[0], trial[1])
        lo, hi = _lane(beta_min * mu_target), _lane(beta_max * mu_target)

        def pulled(p):
            return p - torch.minimum(torch.maximum(p, lo), hi)

        comp = [pulled(g_t * trial[3]), pulled(h_t * trial[4])]
        if self.state_bounds:
            comp += [pulled(gx_t * trial[5]), pulled(hx_t * trial[6])]
        zeros_u = torch.zeros_like(vars[0])
        zeros_x = torch.zeros_like(vars[1])
        dm = self._direction(data, vars, factors, zeros_u, zeros_x,
                             zeros_x, tuple(comp))
        d_new = tuple(dv + dmv for dv, dmv in zip(d, dm))
        alpha_new = self._max_step(data, vars, d_new)
        accept = alpha_new >= torch.clamp(alpha + gamma * delta_alpha,
                                          max=1.0)
        d_out = tuple(torch.where(_lane(accept), dn, dv)
                      for dn, dv in zip(d_new, d))
        return d_out, torch.where(accept, alpha_new, alpha)

    def _step_impl(self, state: MPCState, data: MPCData) -> MPCState:
        """One Mehrotra iteration of every instance of the batch."""
        vars = state.vars
        u, x = vars[0], vars[1]
        lg, lh = vars[3], vars[4]
        g, h, gx, hx = self._slacks(data, u, x)
        gap = state.gap

        # barrier-condensed Hessians -> factor once per iteration
        Rt = _add_diag(data.R, lg / g + lh / h)
        if self.state_bounds:
            Qt = _add_diag(data.Q, vars[5] / gx + vars[6] / hx)
        else:
            Qt = data.Q
        factors = riccati_factor(Qt, Rt, data.A, data.B)

        ru, rx, rd = state.res    # carried from the previous metrics pass

        # affine predictor (mu = 0)
        comp0 = [g * lg, h * lh]
        if self.state_bounds:
            comp0 += [gx * vars[5], hx * vars[6]]
        d_aff = self._direction(data, vars, factors, ru, rx, rd,
                                tuple(comp0))
        alpha_aff = self._max_step(data, vars, d_aff)

        trial = tuple(v + _lane(alpha_aff) * dv
                      for v, dv in zip(vars, d_aff))
        gap_aff = self._gap_at(data, trial)
        pos = gap > 0
        sigma = torch.where(pos, (gap_aff / torch.where(
            pos, gap, torch.ones_like(gap))) ** 3, torch.zeros_like(gap))
        mu_new = gap * sigma

        # corrector: recentred + exact second-order term (bilinear rows)
        m = _lane(mu_new)
        du_a = d_aff[0]
        comp = [g * lg - m + du_a * d_aff[3],
                h * lh - m + (-du_a) * d_aff[4]]
        if self.state_bounds:
            dx_a = d_aff[1]
            comp += [gx * vars[5] - m + dx_a * d_aff[5],
                     hx * vars[6] - m + (-dx_a) * d_aff[6]]
        d_cc = self._direction(data, vars, factors, ru, rx, rd, tuple(comp))
        alpha = self._max_step(data, vars, d_cc)

        for _ in range(self.gondzio):
            d_cc, alpha = self._gondzio_round(data, vars, factors, d_cc,
                                              alpha, mu_new)

        step = _lane(self.fraction_to_boundary * alpha)
        new_vars = tuple(v + step * dv for v, dv in zip(vars, d_cc))
        residual, new_gap, new_res = self._metrics(data, new_vars)
        return MPCState(vars=new_vars, mu=mu_new,
                        iteration=state.iteration + 1,
                        residual=residual, gap=new_gap, res=new_res)

    def _objective(self, data: MPCData, u, x):
        fx = 0.5 * torch.einsum("bki,bkij,bkj->b", x, data.Q, x) + \
            torch.einsum("bki,bki->b", data.q, x)
        fu = 0.5 * torch.einsum("bki,bkij,bkj->b", u, data.R, u) + \
            torch.einsum("bki,bki->b", data.r, u)
        return fx + fu

    def _done(self, state: MPCState) -> torch.Tensor:
        return (state.residual < self.tol) & (state.gap < self.tol)

    def _solve_impl(self, data: MPCData,
                    warm_start: Optional[dict] = None) -> MPCSolveResult:
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
        u, x = state.vars[0], state.vars[1]
        return MPCSolveResult(
            x=x, u=u,
            variables=dict(zip(self._var_names(), state.vars)),
            objective=self._objective(data, u, x),
            iterations=state.iteration,
            residual=state.residual,
            gap=state.gap,
            converged=self._done(state),
            diverged=diverged | bad_iterate(state))

    # -- public ------------------------------------------------------------

    def solve(self, data: MPCData,
              warm_start: Optional[dict] = None) -> MPCSolveResult:
        """Solve one MPC instance (fields without a batch axis).

        ``warm_start``: a previous ``MPCSolveResult.variables``, the
        receding-horizon pattern (shift externally if desired)."""
        one = self._check_data(with_batch_axis(data, True))
        return without_batch_axis(self._solve_impl(one, warm_start), True)

    def step(self, state: MPCState, data: MPCData) -> MPCState:
        """One IPM iteration of one instance, or of a batch (then a
        leading batch axis on ``data`` and on every field of
        ``state``)."""
        one = self._is_instance(data)
        data = self._check_data(with_batch_axis(data, one))
        new = self._step_impl(with_batch_axis(state, one), data)
        return without_batch_axis(new, one)

    def solve_batch(self, data: MPCData) -> MPCSolveResult:
        """Batch of instances: every MPCData leaf carries a leading
        batch axis."""
        return self._solve_impl(self._check_data(data))


# ----------------------------------------------------------------------
# generators / converters
# ----------------------------------------------------------------------

def random_mpc(horizon: int = 16, n_states: int = 4, n_controls: int = 2,
               batch: int = 0, seed: int = 0, state_bounds: bool = False,
               dtype: Optional[torch.dtype] = None,
               device=None) -> MPCData:
    """Random stable tracking MPC instance(s) (deterministic per seed):
    the reference's arrays bit for bit (same generator, same draws, cast
    on the host), on ``device`` (default: the CUDA device).  ``dtype``
    None is float64."""
    device = resolve_device(device)
    dtype = dtype or torch.float64
    rng = np.random.default_rng(seed)
    T, ns, nu = horizon, n_states, n_controls
    shape = (batch,) if batch else ()

    A = rng.normal(size=shape + (T, ns, ns))
    norm = np.max(np.abs(np.linalg.eigvals(A)), axis=-1)
    A = A * (0.95 / np.maximum(norm, 1e-6))[..., None, None]
    B = rng.normal(size=shape + (T, ns, nu))
    c = 0.1 * rng.normal(size=shape + (T, ns))
    x0 = rng.normal(size=shape + (ns,))

    M = rng.normal(size=shape + (T, ns, ns)) / np.sqrt(ns)
    Q = np.einsum("...ij,...kj->...ik", M, M)
    idx = np.arange(ns)
    Q[..., idx, idx] += 1.0
    q = 0.1 * rng.normal(size=shape + (T, ns))
    Mr = rng.normal(size=shape + (T, nu, nu)) / np.sqrt(nu)
    R = np.einsum("...ij,...kj->...ik", Mr, Mr)
    jdx = np.arange(nu)
    R[..., jdx, jdx] += 0.5
    r = 0.1 * rng.normal(size=shape + (T, nu))

    def arr(v):
        # cast on the host (numpy's rounding), then move
        return torch.tensor(v).to(dtype).to(device)

    def full(tail, v):
        return torch.full(shape + tail, v, dtype=dtype, device=device)

    lim = 1.0 if state_bounds else 1e3
    return MPCData(A=arr(A), B=arr(B), c=arr(c), x0=arr(x0), Q=arr(Q),
                   q=arr(q), R=arr(R), r=arr(r),
                   l_u=full((T, nu), -1.0), u_u=full((T, nu), 1.0),
                   l_x=full((T, ns), -lim), u_x=full((T, ns), lim))


def _condense_one(A, B, c, x0, Q, q, R, r, l_u, u_u, l_x, u_x):
    """The reference's ``condense`` of one instance, in numpy float64:
    (H, g, S, l_A, u_A, l, u, free)."""
    T, ns, nu = A.shape[0], A.shape[1], B.shape[2]
    n = T * nu
    # x_k = free response + sum_j S[k,j] u_j
    S = np.zeros((T * ns, n))
    free = np.zeros(T * ns)
    xf = x0.copy()
    for k in range(T):
        if k == 0:
            S[:ns, :nu] = B[0]
        else:
            S[k * ns:(k + 1) * ns] = A[k] @ S[(k - 1) * ns:k * ns]
            S[k * ns:(k + 1) * ns, k * nu:(k + 1) * nu] += B[k]
        xf = A[k] @ xf + c[k]
        free[k * ns:(k + 1) * ns] = xf

    Qbar = np.zeros((T * ns, T * ns))
    for k in range(T):
        Qbar[k * ns:(k + 1) * ns, k * ns:(k + 1) * ns] = Q[k]
    Rbar = np.zeros((n, n))
    for k in range(T):
        Rbar[k * nu:(k + 1) * nu, k * nu:(k + 1) * nu] = R[k]
    H = S.T @ Qbar @ S + Rbar
    H = 0.5 * (H + H.T)
    g = S.T @ (Qbar @ free + q.ravel()) + r.ravel()
    return (H, g, S, l_x.ravel() - free, u_x.ravel() - free, l_u.ravel(),
            u_u.ravel(), free)


def condense(data: MPCData, *, dtype: torch.dtype = torch.float64,
             device=None):
    """Eliminate states -> the equivalent dense box QP on u (numpy
    float64 on the host, for parity tests and the dense-path cross-check).

    Returns (QPData, S, free) with the QPData on ``device`` (default: the
    CUDA device) in ``dtype``, S and free as numpy arrays:
    z = vec(u_0..u_{T-1}), vec(x_1..x_T) = S z + free, objective
    1/2 z'Hz + g'z (+ const); state bounds become general inequality rows
    l_x - free <= S z <= u_x - free.  A leading batch axis on ``data``
    gives a batch of QPs (each instance condensed alone)."""
    from .data import QPData

    fields = [np.asarray(getattr(data, f.name).detach().cpu(), np.float64)
              for f in dataclasses.fields(MPCData)]
    if data.batch_shape:
        parts = [_condense_one(*(a[i] for a in fields))
                 for i in range(data.batch_shape[0])]
        H, g, S, lA, uA, l, u, free = (np.stack(p) for p in zip(*parts))
    else:
        H, g, S, lA, uA, l, u, free = _condense_one(*fields)
    qp = QPData.make(Q=H, c=g, A_ineq=S, l_A_ineq=lA, u_A_ineq=uA, l_x=l,
                     u_x=u, dtype=dtype, device=device)
    return qp, S, free
