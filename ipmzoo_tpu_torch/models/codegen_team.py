"""The team emitter: the SoA evaluation of :mod:`.codegen_soa` printed as
C++ for a team of lanes that share one QP instance.

:class:`CppTeam` takes the place of :class:`.codegen_soa.CppSoA` in the
same walk (:func:`.codegen_soa.evaluate` and the tag algebra) and keeps
its value model and semantics; only where an entry lives changes:

* a vector result is a *lane-local* array: entry ``i`` of a vector of
  ``size`` entries lives in lane ``i % kLanes`` at slot ``i / kLanes``,
  so each lane declares ``IPM_LANES(size)`` = ceil(size / kLanes) values
  (one register when ``size <= kLanes``).  Every elementwise operation
  is one ``IPM_FOR(size)`` loop over the lane's own entries;
* a lane-local value may be read only at the index that wrote it.  Where
  the walk reads it elsewhere (the vector of a matrix product, a
  diagonal inside a matrix, a one-entry vector broadcast), it is first
  stored to a team slot in shared memory and a team barrier follows
  (:meth:`CppTeam.shared`); a read of a lane-local value at another
  index raises :class:`CrossLaneRead` while the text is printed;
* the variables, right-hand sides and data live in shared memory and
  are readable at any index;
* a scalar reduction sums the lane's partials and then across the team
  (``team_sum``), so the result lands in every lane; scalars are
  computed alike in every lane;
* a matrix product gives lane ``i`` row ``i``.

``IPM_LANES``, ``IPM_FOR``, ``team_sync`` and ``team_sum`` are defined in
``csrc/fused_team.cuh``; ``tm`` is the team (lane, mask, slots).  With
``kLanes = 1`` (the host build) the text is the per-instance program of
:class:`.codegen_soa.CppSoA` with the same order of operations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .codegen_soa import CMat, CppSoA, CScalar, CVec, _broadcast, _entry, \
    _no_entry, array_vec

#: the index and slot variables of ``IPM_FOR``
INDEX, SLOT = "i", "p"


class CrossLaneRead(TypeError):
    """A lane-local value was read at an index its lane does not own."""


@dataclasses.dataclass(frozen=True)
class LaneVec(CVec):
    """A vector spread over the team's lanes, in the per-lane array
    ``name`` of ``IPM_LANES(size)`` entries."""
    name: str


def lane_vec(name: str, size: int) -> LaneVec:
    def at(i: str) -> str:
        if i != INDEX:
            raise CrossLaneRead(
                f"lane-local {name} read at index {i!r}: store it to a team "
                "slot first")
        return f"{name}[{SLOT}]"
    return LaneVec(size, at, name)


def _lane_entry(x, i: str) -> str:
    """Entry ``i`` of an operand in a loop over the result's entries.  A
    lane-local operand has the loop's size (:meth:`CppTeam._broadcastable`
    shares a broadcast one first), so it is read at the loop's own entry,
    also where both are one entry long."""
    return x.at(i) if isinstance(x, LaneVec) else _entry(x, i)


def team_loop(size: int, body: str) -> str:
    """One statement over the lane's own entries of a ``size``-entry
    vector: ``i`` is the entry, ``p`` its slot in the lane's arrays."""
    return f"IPM_FOR({size}) {body}"


class CppTeam(CppSoA):
    """Emits the C++ statements of one generated function for a team;
    values are :class:`CScalar`, :class:`CVec` (readable at any index:
    shared memory and constants), :class:`LaneVec` and :class:`CMat`
    handles.  ``slots`` counts the team-slot entries the function
    uses."""

    def __init__(self, prefix: str = "t"):
        super().__init__(prefix)
        self.slots = 0
        self._shared: Dict[str, CVec] = {}

    # -- where entries live ---------------------------------------------

    def shared(self, v):
        """``v`` readable at any index: a lane-local vector is stored to
        team slots (once per value) and a team barrier follows."""
        if not isinstance(v, LaneVec):
            return v
        hit = self._shared.get(v.name)
        if hit is None:
            off = self.slots
            self.slots += v.size
            self.lines.append(team_loop(
                v.size, f"tm.slot[{off} + {INDEX}] = {v.at(INDEX)};"))
            self.lines.append("team_sync(tm);")
            hit = self._shared[v.name] = array_vec("tm.slot", v.size, off)
        return hit

    def _broadcastable(self, x, size: int):
        """A one-entry vector broadcast over ``size`` entries is read at
        entry 0 by every lane."""
        if isinstance(x, LaneVec) and x.size == 1 and size > 1:
            return self.shared(x)
        return x

    # -- materialisation -------------------------------------------------

    def vec_tmp(self, size: int, elem: Callable[[str], str]) -> CVec:
        if size == 0:
            return super().vec_tmp(0, elem)
        name = self._name()
        self.lines.append(f"T {name}[IPM_LANES({size})];")
        self.lines.append(team_loop(size, f"{name}[{SLOT}] = "
                                          f"{elem(INDEX)};"))
        return lane_vec(name, size)

    def _reduce(self, n: int, term: Callable[[str], str]) -> str:
        name = self._name()
        self.lines.append(f"T {name} = T(0);")
        if n:
            self.lines.append(team_loop(n, f"{name} += {term(INDEX)};"))
            self.lines.append(f"{name} = team_sum(tm, {name});")
        return name

    def _binary(self, a, b, op: str, fold):
        if isinstance(a, CScalar) and isinstance(b, CScalar):
            return super()._binary(a, b, op, fold)
        size = _broadcast(self.size(a), self.size(b))
        a = self._broadcastable(a, size)
        b = self._broadcastable(b, size)
        return self.vec_tmp(size, lambda i: f"{_lane_entry(a, i)} {op} "
                                            f"{_lane_entry(b, i)}")

    def dot(self, a: CVec, b: CVec) -> CScalar:
        n = _broadcast(a.size, b.size)
        a = self._broadcastable(a, n)
        b = self._broadcastable(b, n)
        return CScalar(self._reduce(
            n, lambda k: f"{_lane_entry(a, k)} * {_lane_entry(b, k)}"))

    # -- matrices: every vector inside is read at any index ----------------

    def mat_add_diag(self, m: CMat, d) -> CMat:
        return super().mat_add_diag(m, self.shared(d))

    def mat_scale_cols(self, m: CMat, d: CVec) -> CMat:
        return super().mat_scale_cols(m, self.shared(d))

    def mat_scale_rows(self, d: CVec, m: CMat) -> CMat:
        return super().mat_scale_rows(self.shared(d), m)

    def matvec(self, m: CMat, v: CVec) -> CVec:
        return super().matvec(m, self.shared(v))

    def vecmat(self, v: CVec, m: CMat) -> CVec:
        return super().vecmat(self.shared(v), m)

    def _mat_reduce(self, rows: int, depth: int,
                    term: Callable[[str, str], str]) -> CVec:
        """Lane ``i`` owns row ``i``: acc = sum_k term(i, k)."""
        if rows == 0:
            return CVec(0, _no_entry)
        name = self._name()
        self.lines.append(f"T {name}[IPM_LANES({rows})];")
        self.lines.append(team_loop(rows, "{"))
        self.lines.append("  T acc = T(0);")
        if depth:
            self.lines.append(f"  for (int k = 0; k < {depth}; ++k) "
                              f"acc += {term(INDEX, 'k')};")
        self.lines.append(f"  {name}[{SLOT}] = acc;")
        self.lines.append("}")
        return lane_vec(name, rows)

    # -- outputs -------------------------------------------------------------

    def store(self, dst: str, offset: int, v: CVec) -> None:
        """dst[offset + i] = v[i], each lane its own entries."""
        if v.size:
            self.lines.append(team_loop(
                v.size, f"{dst}[{offset} + {INDEX}] = {v.at(INDEX)};"))


def staged_matrix(name: str, rows: int, cols: int, ld: int) -> CMat:
    """A (rows, cols) data matrix staged row-major in the team's shared
    memory, rows ``ld`` apart."""
    return CMat(rows, cols, lambda i, j: f"dat.{name}[({i}) * {ld} + ({j})]")


def staged_stride(cols: int) -> int:
    """The row stride of a staged matrix of ``cols`` columns: odd, so
    that lanes reading a column of it (one row each) hit distinct
    banks."""
    return cols | 1
