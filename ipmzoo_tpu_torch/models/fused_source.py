"""The C++ source of kernel K1 for one formulation and one set of sizes.

:func:`fused_source` walks the same symbolic derivation as the plain
version, through the same pieces of :class:`.fused.FusedBatchedIPM`
(metrics, residual environments, augmented right-hand side,
back-substitution, Gondzio targets), with the C++ emitter
:class:`.codegen_soa.CppSoA`.  The result is a ``struct Form`` of
``__host__ __device__`` functions for one instance, appended to the
hand-written ``csrc/fused_ipm.cuh`` together with the entry points: the
thread route.  :func:`fused_team_source` makes the same walk with
:class:`.codegen_team.CppTeam` (the same functions for a team of lanes,
the data staged in shared memory) around ``csrc/fused_team.cuh``: the
team route.  :func:`fused_wide_source` prints the team route's text at
32 lanes followed by ``csrc/fused_wide.cuh``: the wide route, one warp an
instance with its region in device memory; :func:`fused_wide_block_source`
the same text followed by ``csrc/fused_wide_block.cuh``: the block route,
one thread block an instance with its factor and work vectors in shared
memory.
The text depends only on the formulation and the sizes (and
``taylor``), never on the dtype or the solver's scalar settings, which
are run-time arguments: one build serves both float32 and float64.

Generated functions (``T`` is the working type; ``v``, ``r``, ``delta``
and the like are per-instance arrays laid out like the variables):

  init(dat, v)                                  cold-start iterate
  metrics(dat, prm, v, residual, gap)           residual norm, gap at mu=0
  assemble(dat, prm, v, mu, K)                  packed lower KKT triangle
  residuals(dat, prm, v, mu_r, r)               predictor right-hand sides
  corrector(dat, prm, v, mu, mu_r, d_aff, r)    ... plus Taylor remainder
  aug_rhs(dat, prm, v, mu_r, r, b)              augmented right-hand side
  back_substitute(dat, prm, v, mu_r, r, sol, delta)
  gondzio_targets(dat, prm, trial, mu_t, r)
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from ..symbolic import expr as E

from . import codegen_soa as soa
from .codegen_soa import CppSoA, CScalar
from .codegen_team import CppTeam, staged_matrix, staged_stride

CUH = Path(__file__).resolve().parents[1] / "csrc" / "fused_ipm.cuh"
TEAM_CUH = CUH.with_name("fused_team.cuh")
WIDE_CUH = CUH.with_name("fused_wide.cuh")
BLOCK_CUH = CUH.with_name("fused_wide_block.cuh")

_PARAMS = "const Data<T>& dat, const Params<T>& prm"
_TEAM_PARAMS = ("const Team<T>& tm, const Staged<T>& dat, "
                "const Params<T>& prm")


def _function(name: str, args: str, ev: CppSoA) -> List[str]:
    return (["  template <typename T>",
             f"  IPM_FN static void {name}({args}) {{"]
            + ["    " + line for line in ev.lines] + ["  }", ""])


class _Generator:
    def __init__(self, solver):
        self.s = solver
        self.offsets = []
        off = 0
        for sz in solver.var_sizes:
            self.offsets.append(off)
            off += sz
        self.total = off
        self.aug_offsets = []
        off = 0
        for sz in solver.aug_sizes:
            self.aug_offsets.append(off)
            off += sz

    # -- the dialect: one thread per instance, data in global SoA memory --

    #: the arguments every generated function takes first, and those of
    #: init
    params = _PARAMS
    init_params = "const Data<T>& dat"

    @staticmethod
    def emitter():
        return CppSoA()

    @staticmethod
    def data_vec(name: str, size: int):
        return soa.vector(soa.array_vec(f"dat.{name}", size,
                                        stride="dat.S"))

    @staticmethod
    def data_matrix(name: str, rows: int, cols: int):
        return soa.data_matrix(name, rows, cols)

    @staticmethod
    def data_entry(name: str) -> str:
        """Entry ``i`` of a data vector, in a loop over ``i``."""
        return f"dat.{name}[i * dat.S]"

    @staticmethod
    def row_loop(size: int) -> str:
        """The head of a loop over the rows ``i`` < ``size``."""
        return f"for (int i = 0; i < {size}; ++i)"

    def function(self, name: str, args: str, ev) -> List[str]:
        return _function(name, args, ev)

    # -- environments ------------------------------------------------------

    def split(self, array: str):
        """Per-variable handles into a per-instance array laid out like the
        variables."""
        return tuple(soa.array_vec(array, sz, off)
                     for sz, off in zip(self.s.var_sizes, self.offsets))

    def env(self, var_vals, mu: CScalar):
        s = self.s
        o = s.symbols
        n, m, e = s.n, s.m_ineq, s.m_eq

        data_vec = self.data_vec
        env = {
            o.Q: soa.matrix(self.data_matrix("Q", n, n)),
            o.c: data_vec("c", n),
            o.A_ineq: soa.matrix(self.data_matrix("A_ineq", m, n)),
            o.l_A_ineq: data_vec("l_A_ineq", m),
            o.u_A_ineq: data_vec("u_A_ineq", m),
            o.A_eq: soa.matrix(self.data_matrix("A_eq", e, n)),
            o.b_eq: data_vec("b_eq", e),
            o.l_x: data_vec("l_x", n),
            o.u_x: data_vec("u_x", n),
            o.delta_eq: soa.scalar(CScalar("prm.delta0")),
            o.mu: soa.scalar(mu),
            o.e_var: soa.vector(soa.ones_vec(n)),
            o.e_ineq: soa.vector(soa.ones_vec(m)),
            o.e_eq: soa.vector(soa.ones_vec(e)),
        }
        for var, val in zip(s.full.variables, var_vals):
            env[var] = soa.vector(val)
        return env

    def bind_residuals(self, env, r: str):
        renv = dict(env)
        for (vec, _, _), val in zip(self.s.corrector, self.split(r)):
            renv[vec] = soa.vector(val)
        return renv

    def store_residuals(self, ev: CppSoA, renv, r: str):
        """Write the residual vectors bound in ``renv`` into array ``r``.
        Across generated functions they travel as plain vectors, so each
        must be one (or empty: zeros)."""
        for i, (vec, _, _) in enumerate(self.s.corrector):
            val = renv[vec]
            size = self.s.var_sizes[i]
            if val.tag != "vector":
                raise NotImplementedError(
                    f"residual {vec!r} evaluates to a {val.tag}, which K1's "
                    "generated functions do not pass between them")
            ev.store(r, self.offsets[i], soa.as_vector(ev, val, size))

    # -- functions -----------------------------------------------------------

    def init(self) -> List[str]:
        o = self.s.symbols
        ev = self.emitter()
        mids = {o.x: ("l_x", "u_x"), o.s_A_ineq: ("l_A_ineq", "u_A_ineq")}
        for var, size, off in zip(self.s.full.variables, self.s.var_sizes,
                                  self.offsets):
            if not size:
                continue
            if var in mids:
                lo, hi = mids[var]
                elem = (f"T(0.5) * ({self.data_entry(lo)} + "
                        f"{self.data_entry(hi)})")
            else:
                elem = "T(1)"
            ev.lines.append(f"{self.row_loop(size)} v[{off} + i] = {elem};")
        return self.function("init", f"{self.init_params}, T* v", ev)

    def metrics(self) -> List[str]:
        ev = self.emitter()
        env0 = self.env(self.split("v"), CScalar("T(0)"))
        residual, gap = self.s._metrics_soa(ev, env0)
        ev.lines.append(f"residual = {residual.expr};")
        ev.lines.append(f"gap = {gap.expr};")
        return self.function("metrics", f"{self.params}, const T* v, "
                             "T& residual, T& gap", ev)

    def assemble(self) -> List[str]:
        s = self.s
        ev = self.emitter()
        env = self.env(self.split("v"), CScalar("mu"))
        memo = {}
        nblk = len(s.aug.variables)
        for bi in range(nblk):
            for bj in range(bi + 1):
                self._write_block(ev, env, memo, bi, bj)
        return self.function("assemble", f"{self.params}, const T* v, T mu, "
                             "T* K", ev)

    def _write_block(self, ev, env, memo, bi: int, bj: int) -> None:
        """Write block (bi, bj), bj <= bi, of the augmented matrix into the
        packed lower triangle K (its upper half when bi == bj is never
        read)."""
        s = self.s
        si, sj = s.aug_sizes[bi], s.aug_sizes[bj]
        if not si or not sj:
            return
        r0, c0 = self.aug_offsets[bi], self.aug_offsets[bj]
        cols = "i + 1" if bi == bj else str(sj)
        cell = s.aug.lhs[bi][bj]
        if cell is E.ZERO:
            elem = "T(0)"
        else:
            v = soa.evaluate(ev, cell, env, memo)
            if v.tag == "matrix":
                elem = v.val.at("i", "j")
            elif v.tag in ("diag", "scalar"):
                d = v.val.expr if v.tag == "scalar" else v.val.at("i")
                elem = f"(i == j ? {d} : T(0))"
            else:
                raise TypeError(f"cell {cell!r} -> {v.tag}")
        ev.lines.append(self.row_loop(si))
        ev.lines.append(f"  for (int j = 0; j < {cols}; ++j)")
        ev.lines.append(f"    K[tri({r0} + i, {c0} + j)] = {elem};")

    def residuals(self) -> List[str]:
        ev = self.emitter()
        env = self.env(self.split("v"), CScalar("mu_r"))
        renv = self.s._residual_env_soa(ev, self.env, env,
                                        CScalar("mu_r"))
        self.store_residuals(ev, renv, "r")
        return self.function("residuals", f"{self.params}, const T* v, "
                             "T mu_r, T* r", ev)

    def corrector(self) -> List[str]:
        ev = self.emitter()
        var_vals = self.split("v")
        env = self.env(var_vals, CScalar("mu"))
        renv = self.s._residual_env_soa(ev, self.env, env,
                                        CScalar("mu_r"), var_vals=var_vals,
                                        affine_deltas=self.split("d_aff"))
        self.store_residuals(ev, renv, "r")
        return self.function("corrector", f"{self.params}, const T* v, "
                             "T mu, T mu_r, const T* d_aff, T* r", ev)

    def aug_rhs(self) -> List[str]:
        ev = self.emitter()
        renv = self.bind_residuals(self.env(self.split("v"),
                                            CScalar("mu_r")), "r")
        for part, off in zip(self.s._aug_rhs_soa(ev, renv),
                             self.aug_offsets):
            ev.store("b", off, part)
        return self.function("aug_rhs", f"{self.params}, const T* v, "
                             "T mu_r, const T* r, T* b", ev)

    def back_substitute(self) -> List[str]:
        s = self.s
        ev = self.emitter()
        renv = self.bind_residuals(self.env(self.split("v"),
                                            CScalar("mu_r")), "r")
        sol = [soa.array_vec("sol", sz, off)
               for sz, off in zip(s.aug_sizes, self.aug_offsets)]
        deltas = s._back_substitute_soa(ev, renv, sol)
        for i, val in enumerate(deltas):
            if val is None:
                raise NotImplementedError(
                    f"no delta for variable {s.full.variables[i]!r}")
            ev.store("delta", self.offsets[i], val)
        return self.function("back_substitute", f"{self.params}, "
                             "const T* v, T mu_r, const T* r, const T* sol, "
                             "T* delta", ev)

    def gondzio_targets(self) -> List[str]:
        ev = self.emitter()
        tenv = self.env(self.split("trial"), CScalar("T(0)"))
        for val, off in zip(self.s._gondzio_targets_soa(
                ev, tenv, CScalar("mu_t")), self.offsets):
            ev.store("r", off, val)
        return self.function("gondzio_targets", f"{self.params}, "
                             "const T* trial, T mu_t, T* r", ev)

    # -- the struct ------------------------------------------------------

    def constants(self) -> List[str]:
        s = self.s
        o = s.symbols
        groups = [(self.offsets[i], s.var_sizes[i]) for i in s.nonneg_idx
                  if s.var_sizes[i]]
        s_index = s.var_index.get(o.s_A_ineq)
        k_s = self.offsets[s_index] if (
            s_index is not None and s.var_sizes[s_index]) else -1
        offs = ", ".join(str(g[0]) for g in groups) or "0"
        sizes = ", ".join(str(g[1]) for g in groups) or "0"
        flag = lambda b: "true" if b else "false"  # noqa: E731
        return [
            f"  static constexpr int kN = {s.n};",
            f"  static constexpr int kM = {s.m_ineq};",
            f"  static constexpr int kTotal = {self.total};",
            f"  static constexpr int kAug = {s.aug_dim};",
            f"  static constexpr int kTri = {s.aug_dim * (s.aug_dim + 1) // 2};",
            f"  static constexpr int kX = "
            f"{self.offsets[s.var_index[o.x]]};",
            f"  static constexpr int kS = {k_s};",
            f"  static constexpr int kNonnegGroups = {len(groups)};",
            f"  static constexpr bool kBoxTest = {flag(s.box_test)};",
            f"  static constexpr bool kXLower = {flag(s.x_has_lb)};",
            f"  static constexpr bool kXUpper = {flag(s.x_has_ub)};",
            f"  static constexpr bool kSLower = {flag(s.s_has_lb)};",
            f"  static constexpr bool kSUpper = {flag(s.s_has_ub)};",
            "  IPM_FN static int nonneg_offset(int g) {",
            f"    const int t[] = {{{offs}}};",
            "    return t[g];",
            "  }",
            "  IPM_FN static int nonneg_size(int g) {",
            f"    const int t[] = {{{sizes}}};",
            "    return t[g];",
            "  }",
            "",
        ]


class _TeamGenerator(_Generator):
    """The same walk for the team route: :class:`.codegen_team.CppTeam`,
    the data staged row-major in the team's shared memory, every
    function between two team barriers (its inputs were written by other
    lanes; its outputs are read by them)."""

    params = _TEAM_PARAMS
    init_params = "const Team<T>& tm, const Staged<T>& dat"

    def __init__(self, solver):
        super().__init__(solver)
        self.ld = staged_stride(solver.n)
        self.slots = 0

    @staticmethod
    def emitter():
        return CppTeam()

    @staticmethod
    def data_vec(name: str, size: int):
        return soa.vector(soa.array_vec(f"dat.{name}", size))

    def data_matrix(self, name: str, rows: int, cols: int):
        return staged_matrix(name, rows, cols, self.ld)

    @staticmethod
    def data_entry(name: str) -> str:
        return f"dat.{name}[i]"

    @staticmethod
    def row_loop(size: int) -> str:
        return f"IPM_FOR({size})"

    def function(self, name: str, args: str, ev) -> List[str]:
        self.slots = max(self.slots, ev.slots)
        ev.lines[:0] = ["team_sync(tm);"]
        ev.lines.append("team_sync(tm);")
        return _function(name, args, ev)

    def constants(self) -> List[str]:
        return super().constants()[:-1] + [
            f"  static constexpr int kE = {self.s.m_eq};",
            f"  static constexpr int kLd = {self.ld};",
            f"  static constexpr int kSlots = {self.slots};",
            ""]


def _struct(g: _Generator) -> List[str]:
    # the functions first: the team's constants count their slots
    funcs = (g.init() + g.metrics() + g.assemble() + g.residuals()
             + g.corrector() + g.aug_rhs() + g.back_substitute()
             + g.gondzio_targets())
    return ["struct Form {"] + g.constants() + funcs + ["};", ""]


def form_struct(solver):
    """The generated ``struct Form`` of ``solver``'s formulation and
    sizes, as lines, and the total number of variables."""
    g = _Generator(solver)
    return _struct(g), g.total


def team_slots(solver) -> int:
    """The team slots (``kSlots``) of the ``struct Form`` that
    :class:`.codegen_team.CppTeam` prints for ``solver``: the most
    entries of lane-local vectors a generated function stores for reads
    across lanes."""
    g = _TeamGenerator(solver)
    _struct(g)
    return g.slots


def team_lanes(solver) -> int:
    """The team route's lanes for ``solver``'s sizes: the smallest of 16
    and 32 that holds the largest variable block."""
    return 16 if max(solver.var_sizes) <= 16 else 32


def describe(solver, total: int):
    """The comment lines that name what a generated source was printed
    for."""
    s = solver
    return [f"// formulation: {s.settings!r}",
            f"// names: {s.names!r}",
            f"// n={s.n} m_ineq={s.m_ineq} m_eq={s.m_eq} "
            f"aug_dim={s.aug_dim} variables={total} taylor={s.taylor}"]


def fused_source(solver) -> str:
    """K1's complete C++ source for ``solver``'s formulation and sizes:
    the hand-written ``csrc/fused_ipm.cuh`` followed by the generated
    ``struct Form`` and the entry points.  Deterministic: the same
    formulation and sizes give the same text."""
    body, total = form_struct(solver)
    head = (["// Kernel K1, generated by "
             "ipmzoo_tpu_torch/models/fused_source.py."]
            + describe(solver, total) + ['#line 1 "fused_ipm.cuh"'])
    return "\n".join(
        head + [CUH.read_text(), '#line 1 "generated"',
                "namespace ipmzoo_fused {", ""] + body
        + ["}  // namespace ipmzoo_fused", "",
           "IPMZOO_FUSED_ENTRY_POINTS(ipmzoo_fused::Form)", ""])


def _team_text(solver, what: str, lanes: int, headers, entry: str,
               args: str = "") -> str:
    """A source of the team walk: the head naming ``what``, ``lanes`` a
    team, ``csrc/fused_ipm.cuh`` and the hand-written ``headers``, the
    ``struct Form`` printed by :class:`.codegen_team.CppTeam` and the
    entry-point macro ``entry`` (the Form, then ``args``)."""
    g = _TeamGenerator(solver)
    body = _struct(g)
    head = ([f"// {what}, generated by "
             "ipmzoo_tpu_torch/models/fused_source.py."]
            + describe(solver, g.total)
            + [f"#define IPMZOO_TEAM_LANES {lanes}",
               '#line 1 "fused_ipm.cuh"', CUH.read_text()])
    for h in headers:
        head += [f'#line 1 "{h.name}"', h.read_text()]
    return "\n".join(
        head + ['#line 1 "generated"', "namespace ipmzoo_fused {", ""]
        + body + ["}  // namespace ipmzoo_fused", "",
                  f"{entry}(ipmzoo_fused::Form{args})", ""])


def fused_team_source(solver, lanes: int = None) -> str:
    """K1's team route for ``solver``'s formulation and sizes:
    ``csrc/fused_ipm.cuh`` (types and scalar helpers),
    ``csrc/fused_team.cuh``, the ``struct Form`` of the same walk printed
    by :class:`.codegen_team.CppTeam`, and the entry points
    ``ipmzoo_fused_team_*``.  ``lanes`` (16 or 32; default
    :func:`team_lanes`) is a constant of the text; the host build takes
    one lane whatever it says."""
    lanes = team_lanes(solver) if lanes is None else lanes
    if lanes not in (16, 32):
        raise ValueError(f"a team is 16 or 32 lanes, not {lanes}")
    return _team_text(solver, "Kernel K1, team route", lanes, (TEAM_CUH,),
                      "IPMZOO_FUSED_TEAM_ENTRY_POINTS")


def fused_wide_source(solver) -> str:
    """K1's wide route for ``solver``'s formulation and sizes: the team
    route's text at 32 lanes (``csrc/fused_ipm.cuh``,
    ``csrc/fused_team.cuh``, the same ``struct Form``), then
    ``csrc/fused_wide.cuh`` and the entry points ``ipmzoo_fused_wide_*``
    (one warp an instance, the region in a device-memory workspace)."""
    return _team_text(solver, "Kernel K1, wide route", 32,
                      (TEAM_CUH, WIDE_CUH),
                      "IPMZOO_FUSED_WIDE_ENTRY_POINTS")


def fused_wide_block_source(solver) -> str:
    """K1's block route for ``solver``'s formulation and sizes: the team
    route's text at 32 lanes (``csrc/fused_ipm.cuh``,
    ``csrc/fused_team.cuh``, the same ``struct Form``), then
    ``csrc/fused_wide_block.cuh`` and the entry points
    ``ipmzoo_fused_block_*`` (one thread block an instance, the factor and
    the work vectors in shared memory, the staged data in a device-memory
    workspace)."""
    return _team_text(solver, "Kernel K1, block route", 32,
                      (TEAM_CUH, BLOCK_CUH),
                      "IPMZOO_FUSED_BLOCK_ENTRY_POINTS")
