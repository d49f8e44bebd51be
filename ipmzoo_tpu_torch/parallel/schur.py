"""Interior-point method for block-separable coupled QPs through Schur
complements (counterpart of :mod:`ipmzoo_tpu.parallel.schur`).

Problem family:

    minimize    sum_b  1/2 x_b^T Q_b x_b + c_b^T x_b
    subject to  l_x <= x_b <= u_x          (per-block box bounds)
                sum_b F_b x_b = g          (m_c coupling equalities)

Each Mehrotra iteration solves the arrow-structured condensed KKT system
by block elimination: the blocks H_b = Q_b + diag(z_l/s_l + z_u/s_u) are
factored once (LDL^T, kernel K2), the panel H_b^{-1} F_b^T is solved for
all m_c columns at once (kernel K4), and the (m_c x m_c) coupling system

    (dI + sum_b F_b H_b^{-1} F_b^T) dnu = sum_b F_b H_b^{-1} r_b - r_c

is factored once and reused by predictor and corrector, with iterative
refinement; every H^{-1} r_b is one single-rhs solve (kernel K3).  The
iteration is the reference's formula for formula: long-step barrier on
the box (s_l = x - l, s_u = u - x with duals z_l, z_u), sigma =
(mu_aff/mu)^3, fraction-to-boundary 0.995, mu floored at eps(dtype)^2.

``solve_batch`` runs independent coupled QPs together: the I instances'
blocks form one kernel batch of I*B, and a finished instance is frozen
(its state re-enters unchanged) while the others iterate, as under the
reference's ``vmap`` of its ``while_loop``.  The loop asks the device
once per iteration whether an instance is still active (``host_syncs``).

``two_float``: the reference carries float32 iterates as double-single
pairs (for a TPU without f64) when float32 must reach a tolerance below
its floor.  Here the same switch solves in float64 (data and state
promoted, the f64 kernels on a card) and returns x, nu, the objective
and the metrics in the working dtype.

``solve_sharded`` spreads the blocks of one coupled QP over the ranks of
a mesh axis (:mod:`.mesh`): each rank factors its contiguous slice of
blocks, and every reduction over the blocks (S, the coupling residual,
the two right-hand sides of S, the step lengths, mu_aff, the metrics and
the objective) is a collective over the axis, so every rank holds the
same coupling system, step lengths and stop test.  Under ``two_float``
the collectives run in float64, where the reference folds its pairs
exactly with an ``all_gather``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.state import tree_map, with_batch_axis, without_batch_axis
from ..utils.device import resolve_device
from ..ops.cuda_ldlt import ldlt_auto, solve_ldlt_auto, solve_ldlt_matrix_auto
from ..ops.ldlt import PIVOT_FLOOR, ldlt, solve_ldlt
from . import mesh as mesh_ops


@dataclasses.dataclass
class BlockQPData:
    """Per-block data; leaves have a leading block axis B (and an instance
    axis I before it for ``solve_batch``)."""
    Q: torch.Tensor      # ([I,] B, n, n)
    c: torch.Tensor      # ([I,] B, n)
    F: torch.Tensor      # ([I,] B, m_c, n) coupling rows
    l_x: torch.Tensor    # ([I,] B, n)
    u_x: torch.Tensor    # ([I,] B, n)
    g: torch.Tensor      # ([I,] m_c) coupling right-hand side

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "BlockQPData":
        """Every field moved to ``device`` and cast to ``dtype``."""
        return tree_map(lambda a: a.to(device=device, dtype=dtype), self)


@dataclasses.dataclass
class SchurState:
    """Carry of the iteration loop, with a leading instance axis I."""
    x: torch.Tensor          # (I, B, n)
    s_l: torch.Tensor        # (I, B, n)
    s_u: torch.Tensor        # (I, B, n)
    z_l: torch.Tensor        # (I, B, n)
    z_u: torch.Tensor        # (I, B, n)
    nu: torch.Tensor         # (I, m_c) coupling duals
    iteration: torch.Tensor  # (I,) int32
    residual: torch.Tensor   # (I,)
    gap: torch.Tensor        # (I,)


@dataclasses.dataclass
class SchurResult:
    x: torch.Tensor
    nu: torch.Tensor
    objective: torch.Tensor
    iterations: torch.Tensor
    residual: torch.Tensor
    gap: torch.Tensor
    converged: torch.Tensor


class SchurIPM:
    """Mehrotra IPM over the blocks of coupled QPs, on one device, or
    with its blocks over the ``axis`` of ``mesh`` (``solve_sharded``;
    the solver then runs on this rank's device of the mesh).

    ``block_kernel``: 'pallas' factors and solves the H_b blocks and the
    coupling system with kernels K2/K3/K4 through the ``*_auto``
    dispatchers (their plain versions for CPU tensors); 'jnp' takes the
    plain path (plain LDL^T, plain vector solve, and a triangular-solve
    pair for the panel, the reference's XLA path), on the CPU only: a
    CUDA solver refuses it; 'auto' is 'pallas' on a CUDA device and
    'jnp' elsewhere.  ``two_float``: 'auto' switches it
    on for float32 with tol < 1e-6, as the reference; it solves in
    float64 (see the module docstring)."""

    def __init__(self, n: int, m_c: int, *, mesh=None, axis: str = "dp",
                 device=None,
                 dtype: torch.dtype = torch.float64, tol: float = 1e-8,
                 max_iter: int = 100, fraction_to_boundary: float = 0.995,
                 delta: float = 1e-8, pivot_floor: float = PIVOT_FLOOR,
                 refine: int = 1, block_kernel: str = "auto",
                 two_float="auto"):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, not {dtype}")
        if block_kernel not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown block_kernel={block_kernel!r}")
        self.n, self.m_c = n, m_c
        self.mesh, self.axis = mesh, axis
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not this rank's "
                                 f"device of the mesh, {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.dtype = dtype
        self.tol = tol
        if two_float == "auto":
            # float32 iterates floor at ~8e-7 on the reference's test class
            two_float = dtype == torch.float32 and tol < 1e-6
        self.two_float = bool(two_float)
        self.max_iter = max_iter
        self.ftb = fraction_to_boundary
        #: regularisation of the coupling system S
        self.delta = delta
        if block_kernel == "auto":
            block_kernel = "pallas" if self.device.type == "cuda" else "jnp"
        if block_kernel == "jnp" and self.device.type == "cuda":
            raise ValueError("block_kernel='jnp' is the plain path for CPU "
                             "tensors; on a CUDA device the blocks go "
                             "through kernels K2/K3/K4 ('pallas' or "
                             "'auto')")
        self.block_kernel = block_kernel
        #: zero-pivot floor of both factorisations (H_b and S)
        self.pivot_floor = pivot_floor
        #: iterative-refinement sweeps on the coupling solve
        self.refine = refine
        #: mu floor tied to the working dtype, as the reference
        self.mu_floor = torch.finfo(dtype).eps ** 2
        #: device-to-host round trips made by the iteration loop
        self.host_syncs = 0

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the iteration runs in: float64 under ``two_float``."""
        return torch.float64 if self.two_float else self.dtype

    # -- factor / solve kernels ------------------------------------------

    def _factor(self, A):
        if self.block_kernel == "pallas":
            return ldlt_auto(A, self.pivot_floor)
        return ldlt(A, self.pivot_floor)

    def _solve(self, fact, r):
        """(N, n) right-hand sides against (N, n, n) factors."""
        L, D = fact
        if self.block_kernel == "pallas":
            return solve_ldlt_auto(L, D, r)
        return solve_ldlt(L, D, r)

    def _solve_mat(self, fact, R):
        """(N, n, k) right-hand sides against (N, n, n) factors."""
        L, D = fact
        if self.block_kernel == "pallas":
            return solve_ldlt_matrix_auto(L, D, R)
        y = torch.linalg.solve_triangular(L, R, upper=False,
                                          unitriangular=True)
        z = y / D[:, :, None]
        return torch.linalg.solve_triangular(L.transpose(-1, -2), z,
                                             upper=True, unitriangular=True)

    # -- the iteration ------------------------------------------------------

    def _grad(self, data: BlockQPData, st: SchurState):
        """Stationarity residual Q x + c + F^T nu - z_l + z_u."""
        return (torch.einsum("abij,abj->abi", data.Q, st.x) + data.c +
                torch.einsum("abij,ai->abj", data.F, st.nu) - st.z_l +
                st.z_u)

    # -- reductions over the mesh axis (the identity without a mesh) -----

    def _psum(self, x, mesh):
        return x if mesh is None else mesh_ops.psum(x, mesh, self.axis)

    def _pmin(self, x, mesh):
        return x if mesh is None else mesh_ops.pmin(x, mesh, self.axis)

    def _ranks(self, mesh) -> int:
        return 1 if mesh is None else mesh.shape[self.axis]

    def _coupling(self, data: BlockQPData, x, mesh=None):
        """sum_b F_b x_b - g, summed over every rank's blocks."""
        return self._psum(torch.einsum("abij,abj->ai", data.F, x),
                          mesh) - data.g

    def _metrics(self, data: BlockQPData, st: SchurState, mesh=None):
        grad = self._grad(data, st)
        coupling = self._coupling(data, st.x, mesh)
        I = grad.shape[0]
        comp = torch.cat([(st.s_l * st.z_l).reshape(I, -1),
                          (st.s_u * st.z_u).reshape(I, -1)], dim=1)
        # the squares and the gap's sum over every rank's blocks, in one
        # collective
        sq, gap_sum = self._psum(torch.stack([
            (grad ** 2).sum(dim=(1, 2)) + (comp ** 2).sum(-1),
            comp.abs().sum(-1)]), mesh)
        sq = sq + (coupling ** 2).sum(-1)
        return torch.sqrt(sq), gap_sum / (comp.shape[1] * self._ranks(mesh))

    def _local_rhs(self, data, st, grad, fact, mu, corr=None, mesh=None):
        """Complementarity residuals (with the Mehrotra correction when
        ``corr`` = (dx_aff, dz_l_aff, dz_u_aff)), H^{-1} r_x, and the
        right-hand side sum_b F_b H_b^{-1} r_b of S over every rank."""
        m = mu[:, None, None]
        r_l = st.s_l * st.z_l - m
        r_u = st.s_u * st.z_u - m
        if corr is not None:
            dx_aff, dzl_aff, dzu_aff = corr
            r_l = r_l + dx_aff * dzl_aff          # ds_l = dx
            r_u = r_u + (-dx_aff) * dzu_aff       # ds_u = -dx
        r_x = -grad - r_l / st.s_l + r_u / st.s_u
        I, B, n = r_x.shape
        Hinv_rx = self._solve(fact, r_x.reshape(I * B, n)).reshape(I, B, n)
        rS = self._psum(torch.einsum("abij,abj->ai", data.F, Hinv_rx), mesh)
        return rS, (Hinv_rx, r_l, r_u)

    def _direction(self, st, Hinv_FT, pieces, dnu):
        """Back-substitute the block directions given the coupling one."""
        Hinv_rx, r_l, r_u = pieces
        dx = Hinv_rx - torch.einsum("abij,aj->abi", Hinv_FT, dnu)
        ds_l = dx
        ds_u = -dx
        dz_l = -(r_l + st.z_l * ds_l) / st.s_l
        dz_u = -(r_u + st.z_u * ds_u) / st.s_u
        return dx, ds_l, ds_u, dz_l, dz_u

    def _max_step(self, st, d):
        """Per-instance ratio test over all of its blocks, at most 1."""
        _, ds_l, ds_u, dz_l, dz_u = d
        inf = torch.tensor(float("inf"), dtype=st.x.dtype,
                           device=st.x.device)

        def ratio(v, dv):
            neg = dv < 0
            r = torch.where(neg, -v / torch.where(neg, dv, -1.0), inf)
            return r.amin(dim=(1, 2))

        one = torch.ones_like(st.gap)
        return torch.minimum(one, torch.minimum(
            torch.minimum(ratio(st.s_l, ds_l), ratio(st.s_u, ds_u)),
            torch.minimum(ratio(st.z_l, dz_l), ratio(st.z_u, dz_u))))

    def _step(self, data: BlockQPData, st: SchurState,
              mesh=None) -> SchurState:
        """One Mehrotra iteration of every instance: one factorisation of
        the H_b blocks and one of S, shared by predictor and corrector.
        With a mesh, ``data`` and ``st`` hold this rank's blocks."""
        dt = st.x.dtype
        I, B, n = st.x.shape
        m_c = self.m_c
        # st.gap is the current iterate's duality measure
        mu = st.gap

        grad = self._grad(data, st)
        H = data.Q + torch.diag_embed(st.z_l / st.s_l + st.z_u / st.s_u)
        fact = self._factor(H.reshape(I * B, n, n))
        Hinv_FT = self._solve_mat(
            fact, data.F.transpose(-1, -2).reshape(I * B, n, m_c)
        ).reshape(I, B, n, m_c)
        S = self._psum(torch.einsum("abij,abjk->aik", data.F, Hinv_FT),
                       mesh) + \
            self.delta * torch.eye(m_c, dtype=dt, device=st.x.device)
        r_c = self._coupling(data, st.x, mesh)
        fact_S = self._factor(S)

        def solve_S(rhs):
            x = self._solve(fact_S, rhs)
            for _ in range(self.refine):
                r = rhs - torch.einsum("aij,aj->ai", S, x)
                x = x + self._solve(fact_S, r)
            return x

        # affine predictor
        rS, pieces = self._local_rhs(data, st, grad, fact,
                                     torch.zeros_like(mu), mesh=mesh)
        dnu = solve_S(rS + r_c)
        d_aff = self._direction(st, Hinv_FT, pieces, dnu)
        alpha_aff = self._pmin(self._max_step(st, d_aff), mesh)

        # centering
        dx, dsl, dsu, dzl, dzu = d_aff
        a = alpha_aff[:, None, None]
        mu_aff_sum = self._psum(
            ((st.s_l + a * dsl) * (st.z_l + a * dzl)).sum((1, 2)) +
            ((st.s_u + a * dsu) * (st.z_u + a * dzu)).sum((1, 2)), mesh)
        mu_aff = mu_aff_sum / (2 * B * n * self._ranks(mesh))
        pos = mu > 0
        sigma = torch.where(pos, (mu_aff / torch.where(pos, mu, 1.0)) ** 3,
                            0.0)
        mu_new = torch.clamp(sigma * mu, min=self.mu_floor)

        # corrector: same factorisations, Mehrotra correction terms
        rS2, pieces2 = self._local_rhs(data, st, grad, fact, mu_new,
                                       corr=(dx, dzl, dzu), mesh=mesh)
        dnu2 = solve_S(rS2 + r_c)
        d = self._direction(st, Hinv_FT, pieces2, dnu2)
        step = self.ftb * self._pmin(self._max_step(st, d), mesh)
        a = step[:, None, None]

        dx, dsl, dsu, dzl, dzu = d
        new = SchurState(
            x=st.x + a * dx, s_l=st.s_l + a * dsl, s_u=st.s_u + a * dsu,
            z_l=st.z_l + a * dzl, z_u=st.z_u + a * dzu,
            nu=st.nu + step[:, None] * dnu2, iteration=st.iteration + 1,
            residual=st.residual, gap=st.gap)
        new.residual, new.gap = self._metrics(data, new, mesh)
        return new

    def _is_instance(self, data: BlockQPData) -> bool:
        """Whether ``data`` is one coupled QP: g is (m_c,) there and
        (I, m_c) in a batch, so a batch of one stays a batch."""
        return data.g.dim() == 1

    def init_state(self, data: BlockQPData) -> SchurState:
        """Box midpoints for x, unit duals, zero coupling duals, of one
        coupled QP (leaves with a leading block axis) or of a batch (an
        instance axis before it); the data is checked and cast to the
        compute dtype as ``solve`` checks it."""
        one = self._is_instance(data)
        data = with_batch_axis(self._check(data, 0 if one else 1), one)
        return without_batch_axis(self._init_batch(data), one)

    def _init_batch(self, data: BlockQPData, mesh=None) -> SchurState:
        """``init_state`` on checked data with the instance axis (this
        rank's blocks with a mesh)."""
        x = 0.5 * (data.l_x + data.u_x)
        ones = torch.ones_like(x)
        I = x.shape[0]
        st = SchurState(
            x=x, s_l=x - data.l_x, s_u=data.u_x - x, z_l=ones,
            z_u=ones.clone(),
            nu=torch.zeros((I, self.m_c), dtype=x.dtype, device=x.device),
            iteration=torch.zeros(I, dtype=torch.int32, device=x.device),
            residual=torch.full((I,), float("inf"), dtype=x.dtype,
                                device=x.device),
            gap=torch.full((I,), float("inf"), dtype=x.dtype,
                           device=x.device))
        st.residual, st.gap = self._metrics(data, st, mesh)
        return st

    def _done(self, st: SchurState) -> torch.Tensor:
        return (st.residual < self.tol) & (st.gap < self.tol)

    def _solve_loop(self, data: BlockQPData, mesh=None) -> SchurState:
        """Iterate every instance until it converges or reaches
        ``max_iter``; finished instances are frozen.  With a mesh the
        stop test reads only reduced values, the same bits on every rank,
        so the ranks leave the loop together."""
        st = self._init_batch(data, mesh)
        while True:
            active = ~self._done(st) & (st.iteration < self.max_iter)
            self.host_syncs += 1
            if not bool(active.any()):
                return st
            new = self._step(data, st, mesh)
            st = tree_map(lambda o, nw: torch.where(
                active.reshape((-1,) + (1,) * (nw.dim() - 1)), nw, o),
                st, new)

    def _check(self, data: BlockQPData, lead: int) -> BlockQPData:
        """Reject data on another device or of the wrong sizes; cast it to
        the compute dtype."""
        for f in dataclasses.fields(data):
            t = getattr(data, f.name)
            if t.device.type != self.device.type or (
                    self.device.index is not None and
                    t.device.index != self.device.index):
                raise ValueError(f"BlockQPData.{f.name} is on {t.device}, "
                                 f"the solver on {self.device}")
        n, m_c = data.Q.shape[-1], data.g.shape[-1]
        if (n, m_c) != (self.n, self.m_c) or data.F.shape[-2:] != (m_c, n):
            raise ValueError(f"data sizes (n, m_c) = {(n, m_c)}, F "
                             f"{tuple(data.F.shape)}; solver built for "
                             f"{(self.n, self.m_c)}")
        if data.Q.dim() != lead + 3 or data.g.dim() != lead + 1:
            raise ValueError(f"expected Q with {lead + 3} axes and g with "
                             f"{lead + 1}, got {tuple(data.Q.shape)} and "
                             f"{tuple(data.g.shape)}")
        return data.to(dtype=self.compute_dtype)

    def _result(self, data: BlockQPData, st: SchurState,
                mesh=None) -> SchurResult:
        """The result; with a mesh the objective is summed over the ranks
        and x gathered from every rank's blocks, on every rank."""
        x = st.x
        obj = self._psum(0.5 * torch.einsum("abi,abij,abj->a", x, data.Q, x) +
                         torch.einsum("abi,abi->a", data.c, x), mesh)
        if mesh is not None:
            x = mesh_ops.all_gather(x.transpose(0, 1), mesh, self.axis,
                                    tiled=True).transpose(0, 1)
        dt = self.dtype
        return SchurResult(
            x=x.to(dt), nu=st.nu.to(dt), objective=obj.to(dt),
            iterations=st.iteration, residual=st.residual.to(dt),
            gap=st.gap.to(dt), converged=self._done(st))

    def solve(self, data: BlockQPData) -> SchurResult:
        """Solve one coupled QP (leaves with a leading block axis)."""
        data = with_batch_axis(self._check(data, 0), True)
        return without_batch_axis(
            self._result(data, self._solve_loop(data)), True)

    def solve_batch(self, datas: BlockQPData) -> SchurResult:
        """Solve a batch of independent coupled QPs: every leaf carries a
        leading instance axis (Q is (I, B, n, n), g is (I, m_c)).  The
        I*B blocks form one kernel batch per call."""
        datas = self._check(datas, 1)
        return self._result(datas, self._solve_loop(datas))

    def solve_sharded(self, data: BlockQPData) -> SchurResult:
        """Solve one coupled QP with its blocks over the mesh axis: every
        rank passes the whole QP, factors its contiguous slice of blocks
        and returns the whole result (x gathered on every rank).  The
        block count must divide over the axis.  Collectives staged
        through the host count in ``host_syncs``."""
        if self.mesh is None:
            raise ValueError("solve_sharded needs a mesh")
        mesh = self.mesh
        data = with_batch_axis(self._check(data, 0), True)
        sl = mesh_ops.shard_slice(data.Q.shape[1], mesh, self.axis)
        local = BlockQPData(Q=data.Q[:, sl], c=data.c[:, sl],
                            F=data.F[:, sl], l_x=data.l_x[:, sl],
                            u_x=data.u_x[:, sl], g=data.g)
        staged = mesh.host_syncs
        res = self._result(local, self._solve_loop(local, mesh), mesh)
        self.host_syncs += mesh.host_syncs - staged
        return without_batch_axis(res, True)
