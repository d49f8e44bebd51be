"""Nested-dissection factorisation for general sparse KKT systems
(counterpart of :mod:`ipmzoo_tpu.ops.ndiss`).

Any symmetric quasi-definite KKT matrix whose graph has small separators
(grids, meshes, chains, trees, circuit-like couplings) factors in far
fewer flops than the dense O(n^3) LDL^T:

* The sparsity STRUCTURE is static (it comes from the problem's Q/A
  patterns), so all graph work — separator tree, elimination order,
  fill-in (symbolic factorisation), per-level padding — happens on the
  HOST at plan-build time (numpy).  The host half below is the port's own
  copy of the reference's, so a pattern gives the same plan array for
  array.  The device program sees only static shapes and constant index
  tensors, moved to the device once per (plan, device, dtype).
* Supernodes at the same elimination-tree height are independent, so
  each tree level runs as ONE batch of equal-padded dense blocks: a fused
  pivot-floored LDL^T factor + multi-rhs solve of the (B, k, k) diagonal
  blocks against their (B, k, m) boundary coupling (kernel K5,
  :func:`..cuda_ldlt.ldlt_solve_matrix_auto`), one matmul for the
  (B, m, m) Schur updates, and one extend-add into the parents' frontal
  matrices.  Sequential depth is O(log n) levels.
* Quasi-definite safety: the unpivoted LDL^T with a zero-pivot floor is
  stable for symmetric quasi-definite matrices under ANY symmetric
  permutation (Vanderbei 1995), so the dissection ordering needs no
  numerical pivoting.

Every device function takes LEADING BATCH AXES: ``K`` is (..., n, n),
``b`` is (..., n), and a level's blocks of all instances go to the
kernels as one batch of I * B.

Padding convention: supernodes within a level are padded to the level's
max block/boundary size with a DUMMY variable index n (one extra
row/col).  Gathered blocks are masked back to identity on dummy slots,
and every scattered update is masked to zero there, so the dummy
row/col never contaminates live data.

``method``: ``'pl'`` runs the hand-written kernels (K5, K2, K3, K4; their
plain versions for CPU tensors), ``'jnp'`` the library composition
(the plain column LDL^T and ``torch.linalg.solve_triangular``; CPU
tensors only), ``'auto'`` is ``'pl'`` on a CUDA tensor and ``'jnp'`` on a
CPU tensor.

Everything is deterministic: updates that several supernodes send to one
boundary variable are summed through a fixed gather table, never through
atomics, so two solves of the same data give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from .banded import _cholesky
from .cuda_ldlt import (ldlt_auto, ldlt_solve_matrix_auto, soa_backed,
                        solve_ldlt_auto, solve_ldlt_matrix_auto)
from .ldlt import PIVOT_FLOOR, ldlt

# ---------------------------------------------------------------------------
# host-side plan construction (numpy only — runs once per pattern)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NDLevel:
    """One elimination-tree level: B supernodes padded to (k, m).

    All indices are in the PLAN'S PERMUTED coordinate system (variables
    laid out node-run by node-run in elimination order): diagonal blocks
    are contiguous (k, k) slabs, boundary blocks a row-gather plus one
    contiguous column slab, and Schur updates flow parent-ward through
    per-node update matrices (multifrontal) instead of scatter-adds
    into a global work matrix."""
    idx: np.ndarray      # (B, k) int32 permuted var indices, dummy = n
    valid: np.ndarray    # (B, k) float mask, 1 on live slots
    bnd: np.ndarray      # (B, m) int32 permuted boundary idx, dummy = n
    bvalid: np.ndarray   # (B, m) float mask
    off: np.ndarray      # (B,) int32 var-run start (permuted order)
    child_ids: np.ndarray   # (B, C) int32 node ids, pad = num_nodes
    child_map: np.ndarray   # (B, C, m_max) int32 frontal position of the
    #                         child's t-th boundary column, pad = k + m


@dataclasses.dataclass(frozen=True)
class NDPlan:
    n: int
    levels: Tuple[NDLevel, ...]
    flops_nd: int        # sum over supernodes of k^3/3 + k^2 m + k m^2
    flops_dense: int     # n^3 / 3
    perm: np.ndarray = None       # (n,) permuted position -> original var
    m_max: int = 0                # max padded boundary width over levels
    num_nodes: int = 0
    level_id0: Tuple[int, ...] = ()   # first node id of each level
    #: amalgamated-top signed-Cholesky split: the last level is a single
    #: merged supernode whose first ``top_neg`` variables carry negative
    #: structural sign (dual rows) and the rest positive — factored by
    #: two dense Cholesky stages instead of the sequential-column LDL^T.
    #: -1 = no signed top (generic per-level kernels everywhere).
    top_neg: int = -1
    #: the plan's index arrays as tensors, per (device, dtype); filled by
    #: the device half at first use
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)


#: Time-based cost model of the auto-fallback:
#:
#:   t_nd    = ND_T_STEP + ND_T_LEVEL * levels + 2 * flops_nd / ND_FLOP_RATE
#:   t_dense = DENSE_T_FLOOR + DENSE_A * n^2 + DENSE_B * n^3
#:
#: in seconds per IPM step.  ND_T_STEP is the nd step's own floor (its
#: evaluation, ratio tests and host work, whatever the plan's depth).  The
#: six values below are fitted on an NVIDIA H100 80GB HBM3 at a 700.00 W
#: power limit: ``python3 chip_nd_crossover.py --fit`` on two grid sweeps
#: (grid_qp sides 16-128, float32, tol 1e-5, nd_leaf 64, twelve steps a
#: slope, against the dense 'auto' mode) and two ``--one-level`` runs (the
#: plan of a dense pattern at n = 196, 400, 1024), the rows pooled: nd
#: rows by non-negative least squares on the relative error against
#: (1, levels, 2 flops_nd), dense rows against (1, n^2, n^3); worst
#: relative error 0.31 (nd), 0.25 (dense).  Measured there, nd loses to
#: the dense path up to grid side 80 (n = 6400; 0.44-0.88x) and on every
#: one-level plan (0.62-0.94x), and wins from side 112 (n = 12544;
#: 1.54-3.67x).  Side 96 (n = 9216) spreads over 0.833-1.466x from call to
#: call, the timing noise of the host-bound nd step, so either decision
#: there is right; these values keep nd (1.115x).  Every reading outside
#: 0.87-1.2 but that side's two lowest is decided as measured.  Without
#: ND_T_STEP a one-level plan looks cheap, and only a large ND_T_LEVEL
#: could make it dear, which then loses side 112.
#:
#: REFERENCE_CONSTANTS are the JAX package's decision constants (its form
#: has no ND_T_STEP: 0 here), so that ``nd_predicted_speedup(plan,
#: REFERENCE_CONSTANTS)`` reproduces the reference's prediction exactly;
#: they are not times or rates of a CUDA card.
ND_T_STEP = 6.104551e-3
ND_T_LEVEL = 1.283299e-3
ND_FLOP_RATE = 3.214237e11
DENSE_T_FLOOR = 5.561362e-3
DENSE_A = 2.008866e-11
DENSE_B = 1.079313e-14

#: the six names of :func:`cost_model_constants`
COST_MODEL_NAMES = ("ND_T_STEP", "ND_T_LEVEL", "ND_FLOP_RATE",
                    "DENSE_T_FLOOR", "DENSE_A", "DENSE_B")
REFERENCE_CONSTANTS = {"ND_T_STEP": 0.0, "ND_T_LEVEL": 3.2e-5,
                       "ND_FLOP_RATE": 3.1e10, "DENSE_T_FLOOR": 2.3e-4,
                       "DENSE_A": 1.34e-10, "DENSE_B": 1.29e-14}


def cost_model_constants() -> dict:
    """The six constants above by name, as ``constants=`` takes them."""
    return {k: globals()[k] for k in COST_MODEL_NAMES}


def cost_model_times(n: int, levels: int, flops_nd: float,
                     constants: Optional[Mapping[str, float]] = None):
    """(t_nd, t_dense) in seconds of the time model above for a plan of
    order ``n`` with ``levels`` levels and ``flops_nd`` flops, under
    ``constants`` (a mapping of the six names of
    :func:`cost_model_constants`; None: this module's)."""
    c = cost_model_constants() if constants is None else constants
    t_nd = c["ND_T_STEP"] + c["ND_T_LEVEL"] * levels + \
        2.0 * flops_nd / c["ND_FLOP_RATE"]
    n = float(n)
    return t_nd, c["DENSE_T_FLOOR"] + c["DENSE_A"] * n * n + \
        c["DENSE_B"] * n ** 3


def nd_predicted_speedup(plan: NDPlan,
                         constants: Optional[Mapping[str, float]] = None
                         ) -> float:
    """Predicted step speedup of the plan vs the dense factorisation
    from the time model above (``constants``: see
    :func:`cost_model_times`).  > 1 means the plan is predicted to win;
    CompiledIPM's auto-fallback refuses plans below its threshold so a
    losing nd plan is never silently selected."""
    t_nd, t_dense = cost_model_times(plan.n, len(plan.levels),
                                     plan.flops_nd, constants)
    return t_dense / max(t_nd, 1e-12)


def _bfs_levels(adj: List[np.ndarray], start: int,
                members: np.ndarray) -> List[np.ndarray]:
    """BFS level sets of the subgraph induced by ``members`` (bool mask)."""
    seen = np.zeros(len(adj), bool)
    seen[~members] = True
    seen[start] = True
    frontier = [start]
    out = []
    while frontier:
        out.append(np.asarray(frontier, np.int64))
        nxt = []
        for v in frontier:
            for w in adj[v]:
                if not seen[w]:
                    seen[w] = True
                    nxt.append(w)
        frontier = nxt
    return out


def _components(adj: List[np.ndarray], verts: np.ndarray) -> List[np.ndarray]:
    members = np.zeros(len(adj), bool)
    members[verts] = True
    comps = []
    for v in verts:
        if members[v]:
            levels = _bfs_levels(adj, int(v), members)
            comp = np.concatenate(levels)
            members[comp] = False
            comps.append(np.sort(comp))
    return comps


def _separate(adj: List[np.ndarray], verts: np.ndarray):
    """Split connected ``verts`` into (A, B, sep) by a BFS level-set cut
    from a pseudo-peripheral vertex.  Returns None if no useful cut
    exists (near-clique)."""
    members = np.zeros(len(adj), bool)
    members[verts] = True
    # pseudo-peripheral start: farthest vertex from an arbitrary one
    levels = _bfs_levels(adj, int(verts[0]), members)
    levels = _bfs_levels(adj, int(levels[-1][0]), members)
    if len(levels) < 3:
        return None
    sizes = np.array([len(l) for l in levels])
    total = sizes.sum()
    below = np.cumsum(sizes) - sizes  # vars strictly before level i
    # pick the separator level minimising the larger side
    worst = np.maximum(below, total - below - sizes)
    cand = np.arange(1, len(levels) - 1)
    ell = int(cand[np.argmin(worst[cand])])
    A = np.concatenate(levels[:ell])
    B = np.concatenate(levels[ell + 1:])
    sep = levels[ell]
    if len(A) == 0 or len(B) == 0 or len(sep) >= 0.5 * total:
        return None
    return np.sort(A), np.sort(B), np.sort(sep)


@dataclasses.dataclass
class _Node:
    vars: np.ndarray                 # this supernode's variables
    children: list                   # child _Nodes
    boundary: np.ndarray = None      # filled by _symbolic_factor
    height: int = 0


def _dissect(adj, verts: np.ndarray, leaf: int) -> List[_Node]:
    """Dissect ``verts`` into a forest of supernode trees (a forest when
    the induced subgraph is disconnected)."""
    comps = _components(adj, verts)
    nodes = []
    for comp in comps:
        if len(comp) <= leaf:
            nodes.append(_Node(vars=comp, children=[]))
            continue
        cut = _separate(adj, comp)
        if cut is None:
            nodes.append(_Node(vars=comp, children=[]))
            continue
        A, B, sep = cut
        children = _dissect(adj, A, leaf) + _dissect(adj, B, leaf)
        nodes.append(_Node(vars=sep, children=children))
    return nodes


def _symbolic_factor(adj, roots: List[_Node]) -> List[_Node]:
    """Compute each supernode's boundary (its row structure in the block
    factor, fill included) and height; return all supernodes."""
    out = []

    def visit(node, ancestors: np.ndarray):
        anc = np.zeros(len(adj), bool)
        anc[ancestors] = True
        own = np.zeros(len(adj), bool)
        own[node.vars] = True
        bset = np.zeros(len(adj), bool)
        h = 0
        child_anc = np.concatenate([ancestors, node.vars])
        for c in node.children:
            visit(c, child_anc)
            bset[c.boundary] = True
            h = max(h, c.height + 1)
        for v in node.vars:
            bset[adj[v]] = True
        # boundary = (direct neighbours ∪ child boundaries) that are
        # ancestors — everything else is inside the subtree (eliminated)
        node.boundary = np.flatnonzero(bset & anc)
        node.height = h
        out.append(node)

    for r in roots:
        visit(r, np.zeros((0,), np.int64))
    return out


def _amalgamate_top(nodes_all: list, root_merge: int,
                    signs: np.ndarray = None):
    """Merge the TOP of the separator tree into one dense supernode.

    Every device level costs a fixed number of launches regardless of
    its flop count, and the upper separator levels hold only a few tiny
    nodes (at a 64 x 64 grid with leaf 64: levels 3-6 carry 13 nodes /
    ~336 variables in all).  Amalgamating all nodes of height >= H (an
    upper-closed set: height strictly increases toward the root, so
    their united boundary is internal) into ONE supernode factors those
    variables as a single dense block — a classical supernode
    amalgamation, applied at the tree top where the latency/flop trade
    is most lopsided.  ``root_merge`` caps the
    merged variable count; H is the smallest height whose upper set
    fits, with H >= 1 so leaves never merge.

    ``signs``: optional (n,) +-1 structural signs (positive primal /
    negative dual groups, the same signs ops/blockg.py uses).  When
    given, the merged block's variables are ordered negatives-first so
    the device factorisation can run as TWO dense Cholesky stages
    (chol(-N), then chol of the positive Schur complement — Vanderbei's
    quasi-definite factorizability) instead of a k-step sequential
    LDL^T; identity-padded dummy slots land in the trailing positive
    block.  Returns (nodes, top_neg) with top_neg = -1 when no signed
    top exists."""
    if root_merge <= 0:
        return nodes_all, -1
    maxh = max((nd.height for nd in nodes_all), default=0)
    best_h = None
    for H in range(1, maxh + 1):
        size = sum(len(nd.vars) for nd in nodes_all if nd.height >= H)
        if size and size <= root_merge:
            best_h = H
            break
    if best_h is None:
        return nodes_all, -1
    merged = [nd for nd in nodes_all if nd.height >= best_h]
    if len(merged) <= 1:
        return nodes_all, -1
    keep = [nd for nd in nodes_all if nd.height < best_h]
    merged_ids = {id(nd) for nd in merged}
    # level-by-level order inside the dense block (any symmetric order
    # is factorizable for quasi-definite K)
    tvars = np.concatenate(
        [nd.vars for h in range(best_h, maxh + 1)
         for nd in nodes_all if nd.height == h])
    top_neg = -1
    if signs is not None:
        sv = np.asarray(signs)[tvars]
        tvars = np.concatenate([tvars[sv < 0], tvars[sv >= 0]])
        top_neg = int((sv < 0).sum())
    top = _Node(
        vars=tvars,
        children=[c for nd in merged for c in nd.children
                  if id(c) not in merged_ids],
        height=best_h)
    own = set(top.vars.tolist())
    bset = sorted({int(v) for nd in merged for v in nd.boundary} - own)
    top.boundary = np.asarray(bset, np.int64)
    return keep + [top], top_neg


def nd_plan(pattern: np.ndarray, leaf: int = 32, pad_to: int = 8,
            root_merge: int = None, signs: np.ndarray = None) -> NDPlan:
    """Build the dissection plan for a symmetric sparsity ``pattern``
    ((n, n) bool; the diagonal is implicitly nonzero).

    ``leaf``: stop dissecting below this many variables.  ``pad_to``:
    round padded block sizes up to this multiple (kept at the
    reference's 8 so that the plans are equal).
    ``root_merge``: amalgamate the top of the separator tree into one
    dense supernode of at most this many variables (0 disables;
    default min(512, n // 8) — the trade only pays while the merged
    block stays a small fraction of the problem) — see
    :func:`_amalgamate_top`.  ``signs``: optional (n,) +-1 structural
    signs enabling the merged top's two-stage Cholesky factorisation.
    """
    pattern = np.asarray(pattern)
    n = pattern.shape[0]
    if root_merge is None:
        root_merge = min(512, n // 8)
    if signs is not None and len(np.asarray(signs)) != n:
        signs = None
    sym = pattern | pattern.T
    np.fill_diagonal(sym, False)
    adj = [np.flatnonzero(sym[i]) for i in range(n)]

    roots = _dissect(adj, np.arange(n), leaf)
    nodes_all = _symbolic_factor(adj, roots)   # postorder
    nodes_all, top_neg = _amalgamate_top(nodes_all, root_merge, signs)

    # splice empty supernodes out of every children list so update
    # matrices always flow through a parent that exists (postorder:
    # an empty child's own list is already spliced when read here)
    for nd in nodes_all:
        nd.children = \
            [c for c in nd.children if len(c.vars)] + \
            [g for c in nd.children if not len(c.vars)
             for g in c.children]
    nodes = [nd for nd in nodes_all if len(nd.vars)]

    # group by height; pad each level to its max (k, m)
    def rup(x, m):
        return max(-(-x // m) * m, m) if x else 0

    maxh = max((nd.height for nd in nodes), default=0)
    groups = [g for g in ([nd for nd in nodes if nd.height == h]
                          for h in range(maxh + 1)) if g]

    # elimination-order permutation: node var-runs laid out level by
    # level; ids assigned in the same order (children always have
    # smaller ids than their parents)
    perm = np.concatenate([nd.vars for g in groups for nd in g]) \
        if nodes else np.zeros((0,), np.int64)
    pos = np.empty(n, np.int64)
    pos[perm] = np.arange(len(perm))
    nid = {}
    off_of = {}
    p = 0
    i = 0
    for g in groups:
        for nd in g:
            nid[id(nd)] = i
            off_of[id(nd)] = p
            i += 1
            p += len(nd.vars)
    num_nodes = i
    # per-node boundary in permuted coordinates, sorted — this order
    # defines the child's U column order AND the parent map below
    bnd_of = {id(nd): np.sort(pos[nd.boundary]) for g in groups
              for nd in g}

    level_m = [rup(max(len(nd.boundary) for nd in g), pad_to)
               for g in groups]
    m_max = max([max(m, 1) for m in level_m], default=1)

    levels = []
    level_id0 = []
    flops = 0
    for g, m in zip(groups, level_m):
        k = rup(max(len(nd.vars) for nd in g), pad_to)
        m = max(m, 1)
        B = len(g)
        C = max((len(nd.children) for nd in g), default=0)
        f = k + m
        idx = np.full((B, k), n, np.int32)
        val = np.zeros((B, k), np.float64)
        bnd = np.full((B, m), n, np.int32)
        bval = np.zeros((B, m), np.float64)
        off = np.zeros((B,), np.int32)
        cids = np.full((B, max(C, 1)), num_nodes, np.int32)
        cmap = np.full((B, max(C, 1), m_max), f, np.int32)
        for bi, nd in enumerate(g):
            kv, mv = len(nd.vars), len(nd.boundary)
            o = off_of[id(nd)]
            off[bi] = o
            idx[bi, :kv] = o + np.arange(kv)
            val[bi, :kv] = 1.0
            bp = bnd_of[id(nd)]
            bnd[bi, :mv] = bp
            bval[bi, :mv] = 1.0
            flops += kv ** 3 // 3 + kv * kv * mv + kv * mv * mv
            # frontal position of each global (permuted) index: S run
            # first (position - off), then the padded boundary slots
            fp = {int(q): k + j for j, q in enumerate(bp)}
            for ci, c in enumerate(nd.children):
                cids[bi, ci] = nid[id(c)]
                cb = bnd_of[id(c)]
                for t, q in enumerate(cb):
                    q = int(q)
                    if o <= q < o + kv:
                        cmap[bi, ci, t] = q - o
                    else:
                        cmap[bi, ci, t] = fp[q]
        levels.append(NDLevel(idx=idx, valid=val, bnd=bnd, bvalid=bval,
                              off=off, child_ids=cids, child_map=cmap))
        level_id0.append(nid[id(g[0])])
    if top_neg >= 0 and not (levels and levels[-1].idx.shape[0] == 1):
        top_neg = -1       # merged top vanished in the splice; be safe
    return NDPlan(n=n, levels=tuple(levels), flops_nd=flops,
                  flops_dense=n ** 3 // 3, perm=perm, m_max=m_max,
                  num_nodes=num_nodes, level_id0=tuple(level_id0),
                  top_neg=top_neg)

# ---------------------------------------------------------------------------
# device-side factor / solve (plan arrays are constant index tensors)
# ---------------------------------------------------------------------------


def _uses_kernels(method: str, device: torch.device) -> bool:
    """Whether the level factor/solves run the hand-written kernels
    (their plain versions on the CPU) or the library composition."""
    if method == "pl":
        return True
    if method == "jnp":
        if device.type == "cuda":
            raise ValueError("method='jnp' is the library composition for "
                             "CPU tensors; on a CUDA tensor use 'auto' or "
                             "'pl' (the CUDA kernels)")
        return False
    if method == "auto":
        return device.type == "cuda"
    raise ValueError(f"unknown method={method!r}; expected 'auto', 'pl' "
                     f"or 'jnp'")


@dataclasses.dataclass
class _LevelTensors:
    """One level's index arrays and masks on a device."""
    idx: torch.Tensor       # (B, k) int64, dummy = n
    v: torch.Tensor         # (B, k) mask of live slots
    bnd: torch.Tensor       # (B, m) int64, dummy = n
    rows: torch.Tensor      # (B, k) int64 slab rows off + 0..k-1
    ss_mask: torch.Tensor   # (B, k, k) v v^T
    eye_pad: torch.Tensor   # (B, k, k) identity on dummy slots
    sb_mask: torch.Tensor   # (B, m, k) bv v^T
    bb_mask: torch.Tensor   # (B, m, m) bv bv^T
    bv: torch.Tensor        # (B, m) mask of live boundary slots
    cids: torch.Tensor      # (B * C,) int64 child node ids, or None
    E: torch.Tensor         # (B, C, m_max, f) one-hot extend-add maps
    tq: torch.Tensor        # (Q,) int64 distinct live boundary variables
    contrib: torch.Tensor   # (Q, R) int64 slots of bnd that hit tq, pad B*m


@dataclasses.dataclass
class _PlanTensors:
    perm: torch.Tensor      # (n,) int64
    levels: Tuple[_LevelTensors, ...]


def _gather_table(bnd: np.ndarray, n: int):
    """For the scatter ``bp[bnd] += upd`` with repeated indices: the
    distinct live targets and, per target, the flat slots of ``bnd``
    that hit it (padded with ``bnd.size``, the slot of an appended
    zero).  Summing a gather through this table is the same update in a
    fixed order."""
    flat = bnd.reshape(-1).astype(np.int64)
    live = np.flatnonzero(flat < n)
    order = live[np.argsort(flat[live], kind="stable")]
    tq, start, count = np.unique(flat[order], return_index=True,
                                 return_counts=True)
    width = int(count.max()) if len(count) else 1
    contrib = np.full((len(tq), width), flat.size, np.int64)
    for j in range(width):
        has = count > j
        contrib[has, j] = order[start[has] + j]
    return tq, contrib


def _plan_tensors(plan: NDPlan, device: torch.device,
                  dtype: torch.dtype) -> _PlanTensors:
    """The plan's index arrays on ``device`` (masks in ``dtype``), built
    once per (plan, device, dtype)."""
    key = (str(device), dtype)
    hit = plan._cache.get(key)
    if hit is not None:
        return hit

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def mask(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).to(
            device)

    levels = []
    for lev in plan.levels:
        B, k = lev.idx.shape
        m = lev.bnd.shape[1]
        v, bv = lev.valid, lev.bvalid
        rows = lev.off[:, None].astype(np.int64) + np.arange(k)
        eye_pad = np.eye(k)[None] * (1.0 - v)[:, :, None]
        if bool((lev.child_ids < plan.num_nodes).any()):
            cids = ints(lev.child_ids.reshape(-1))
            E = mask(lev.child_map[..., None] == np.arange(k + m))
        else:
            cids = E = None
        tq, contrib = _gather_table(lev.bnd, plan.n)
        levels.append(_LevelTensors(
            idx=ints(lev.idx), v=mask(v), bnd=ints(lev.bnd),
            rows=ints(rows),
            ss_mask=mask(v[:, :, None] * v[:, None, :]),
            eye_pad=mask(eye_pad),
            sb_mask=mask(bv[:, :, None] * v[:, None, :]),
            bb_mask=mask(bv[:, :, None] * bv[:, None, :]), bv=mask(bv),
            cids=cids, E=E, tq=ints(tq), contrib=ints(contrib)))
    out = _PlanTensors(perm=ints(plan.perm), levels=tuple(levels))
    plan._cache[key] = out
    return out


def _t(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _kmax(plan: NDPlan) -> int:
    return max((lev.idx.shape[1] for lev in plan.levels), default=1)


def _factor_blocks(Kss, pivot_floor, kern: bool):
    """Batched LDL^T of (..., B, k, k) blocks: K2, or the plain column
    loop."""
    k = Kss.shape[-1]
    flat = Kss.reshape(-1, k, k)
    L, D = ldlt_auto(flat, pivot_floor) if kern else ldlt(flat, pivot_floor)
    return L.reshape(Kss.shape), D.reshape(Kss.shape[:-1])


def _solve_blocks(L, D, R, kern: bool):
    """Batched multi-rhs LDL^T solve: (..., B, k, k) factors x
    (..., B, k, m): K4, or two triangular solves."""
    k, m = R.shape[-2:]
    if m and kern:
        return solve_ldlt_matrix_auto(
            L.reshape(-1, k, k), D.reshape(-1, k),
            R.reshape(-1, k, m)).reshape(R.shape)
    y = torch.linalg.solve_triangular(L, R, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(_t(L), y / D[..., None],
                                         upper=True, unitriangular=True)


def _solve_vec_blocks(L, D, z, kern: bool):
    """Batched single-rhs LDL^T solve: (..., B, k, k) factors x
    (..., B, k): K3, or two triangular solves."""
    k = z.shape[-1]
    if kern:
        return solve_ldlt_auto(L.reshape(-1, k, k), D.reshape(-1, k),
                               z.reshape(-1, k)).reshape(z.shape)
    return _solve_blocks(L, D, z[..., None], False)[..., 0]


def nd_prework(K: torch.Tensor, plan: NDPlan):
    """Extract the per-level static slabs of ``K`` (..., n, n) along the
    plan.

    Permutes K into elimination order and cuts, per level, the
    contiguous diagonal slabs Kss (..., B, k, k) and boundary blocks
    Ksb^T (..., B, m, k), masked/identity-padded.  An IPM iteration only
    changes the KKT's DIAGONAL, so callers inside a solver loop compute
    this ONCE outside the loop and pass it to :func:`nd_factor_pre` with
    just the per-iteration diagonal.

    The permuted matrix is padded to n + kmax + 1 rows and columns, so
    that the (off, k) slabs of short supernodes and the dummy boundary
    row n index real (zero) storage: an index never leaves the array."""
    n = plan.n
    pt = _plan_tensors(plan, K.device, K.dtype)
    npad = n + _kmax(plan) + 1
    Kpad = K.new_zeros(K.shape[:-2] + (npad, npad))
    Kpad[..., :n, :n] = K.index_select(-2, pt.perm).index_select(-1,
                                                                 pt.perm)
    pre = []
    for lt in pt.levels:
        cols = lt.rows[:, None, :]
        Kss = Kpad[..., lt.rows[:, :, None], cols] * lt.ss_mask + lt.eye_pad
        KsbT = Kpad[..., lt.bnd[:, :, None], cols] * lt.sb_mask
        pre.append((Kss, KsbT))
    return pre


def _factor_level(Kss, Ksb, pivot_floor, kern: bool):
    """(L, D, W = Kss^-1 Ksb) of one level's blocks.  With the kernels:
    one fused K5 launch for all instances' blocks (K2 then K4 above K5's
    shared-memory cap); the factors come back over structure-of-arrays
    storage, so the K3 solves of :func:`nd_solve` read them without a
    transpose."""
    k, m = Ksb.shape[-2:]
    if m and kern:
        L, D, W = ldlt_solve_matrix_auto(Kss.reshape(-1, k, k),
                                         Ksb.reshape(-1, k, m), pivot_floor)
        if L.is_cuda:
            L, D = soa_backed(L, D)
        return (L.reshape(Kss.shape), D.reshape(Kss.shape[:-1]),
                W.reshape(Ksb.shape))
    L, D = _factor_blocks(Kss, pivot_floor, kern)
    return L, D, _solve_blocks(L, D, Ksb, kern)


def nd_factor_pre(pre, plan: NDPlan, diag_delta: torch.Tensor = None,
                  pivot_floor: float = PIVOT_FLOOR, method: str = "auto"):
    """Multifrontal factorisation from :func:`nd_prework` slabs.

    ``diag_delta``: optional (..., n) vector (ORIGINAL coordinates) added
    to the diagonal — the per-iteration barrier terms.  Returns
    per-level factors [(L, D, W)] (unit-lower/diagonal LDL^T of each
    eliminated block, W = Kss^{-1} Ksb) — identical to the classical
    right-looking result.  Schur updates flow parent-ward as per-node
    update matrices embedded with one-hot matmuls (extend-add): children
    of one parent map to the same frontal positions, and a matmul sums
    them in a fixed order.  ``method``: see the module docstring."""
    if not pre:
        return []
    Kss0 = pre[0][0]
    dt, dev, batch = Kss0.dtype, Kss0.device, tuple(Kss0.shape[:-3])
    kern = _uses_kernels(method, dev)
    pt = _plan_tensors(plan, dev, dt)
    n, mm = plan.n, plan.m_max
    if diag_delta is not None:
        wpad = Kss0.new_zeros(batch + (n + _kmax(plan) + 1,))
        wpad[..., :n] = diag_delta.index_select(-1, pt.perm)
    U_all = Kss0.new_zeros(batch + (plan.num_nodes + 1, mm, mm))
    out = []
    for lev, lt, id0, (Kss, KsbT) in zip(plan.levels, pt.levels,
                                         plan.level_id0, pre):
        B, k = lev.idx.shape
        m = lev.bnd.shape[1]
        if diag_delta is not None:
            # the only non-invariant input of the whole factorisation
            Kss = Kss + torch.diag_embed(wpad[..., lt.rows] * lt.v)
        # frontal matrix [[K_SS, K_SB], [K_BS, 0]] + child updates, kept
        # as its three blocks
        Ksb = _t(KsbT)
        Fbb = None
        if lt.cids is not None:
            C = lev.child_ids.shape[1]
            cu = U_all[..., lt.cids, :, :].reshape(
                batch + (B, C, mm, mm))
            T = torch.matmul(cu, lt.E)                # (..., B, C, mm, f)
            G = torch.matmul(
                _t(lt.E.reshape(B, C * mm, k + m)),
                T.reshape(batch + (B, C * mm, k + m)))    # (..., B, f, f)
            Kss = Kss + G[..., :k, :k]
            Ksb = Ksb + G[..., :k, k:]
            Fbb = G[..., k:, k:]
        if lev is plan.levels[-1] and plan.top_neg >= 0 and B == 1:
            # amalgamated top: two dense Cholesky stages (negatives
            # first, then the SPD Schur of the positive block —
            # Vanderbei quasi-definite factorizability), re-expressed as
            # unit-L/D so nd_solve is oblivious.  The factor slot
            # carries Linv (NOT L): the per-rhs top solves in nd_solve
            # become two matvecs instead of two triangular solves (the
            # plan's top_neg >= 0 marks the convention).
            L, D = _signed_top_factor(Kss[..., 0, :, :], plan.top_neg)
            eye = torch.eye(k, dtype=dt, device=dev).expand(L.shape)
            Linv = torch.linalg.solve_triangular(L, eye, upper=False,
                                                 unitriangular=True)
            W = torch.matmul(_t(Linv), torch.matmul(
                Linv, Ksb[..., 0, :, :]) / D[..., None])
            L, D, W = (Linv.unsqueeze(-3), D.unsqueeze(-2),
                       W.unsqueeze(-3))
        else:
            L, D, W = _factor_level(Kss, Ksb, pivot_floor, kern)
        U = -torch.matmul(KsbT if Fbb is None else _t(Ksb), W)
        if Fbb is not None:
            U = Fbb + U
        out.append((L, D, W))
        U_all[..., id0:id0 + B, :m, :m] = U * lt.bb_mask
    return out


def _signed_top_factor(Kf: torch.Tensor, nneg: int):
    """Unit-L/D LDL^T of quasi-definite blocks (..., k, k) ordered
    negatives-first via two dense Cholesky stages:

        K = [[N, B^T], [B, P]],  N neg.def., P pos.def. (after any
        leading eliminations — quasi-definiteness is closed under
        Schur complements)

        Ln = chol(-N);  T = Ln^{-1} B^T;  Lp = chol(P + T^T T)
        K  = Lf Sigma Lf^T,  Lf = [[Ln, 0], [-T^T, Lp]],
        Sigma = diag(-I, +I)

    Returned as (L, D) with L unit-lower and D carrying the signs:
    L = Lf diag(1/diag(Lf)), D = sigma * diag(Lf)^2 — the exact format
    every other level produces, so the solve sweeps are unchanged.  A
    block that is not definite gives NaN, as the reference's Cholesky,
    for the IPM's rollback to see."""
    k = Kf.shape[-1]
    ones = Kf.new_ones((k,))
    if nneg == 0:
        Lf, sigma = _cholesky(Kf), ones
    elif nneg == k:
        Lf, sigma = _cholesky(-Kf), -ones
    else:
        N = Kf[..., :nneg, :nneg]
        Bt = Kf[..., :nneg, nneg:]
        P = Kf[..., nneg:, nneg:]
        Ln = _cholesky(-N)
        T = torch.linalg.solve_triangular(Ln, Bt, upper=False)
        Lp = _cholesky(P + torch.matmul(_t(T), T))
        Lf = torch.cat([torch.cat([Ln, torch.zeros_like(Bt)], dim=-1),
                        torch.cat([-_t(T), Lp], dim=-1)], dim=-2)
        sigma = torch.cat([-ones[:nneg], ones[nneg:]])
    d = Lf.diagonal(dim1=-2, dim2=-1)
    return Lf / d[..., None, :], sigma * d * d


def nd_factor(K: torch.Tensor, plan: NDPlan,
              pivot_floor: float = PIVOT_FLOOR, method: str = "auto",
              diag_delta: torch.Tensor = None):
    """Multifrontal block factorisation of K (..., n, n) along the
    dissection plan (= :func:`nd_prework` + :func:`nd_factor_pre`;
    solver loops call the two pieces separately so the prework stays out
    of the loop)."""
    return nd_factor_pre(nd_prework(K, plan), plan,
                         diag_delta=diag_delta,
                         pivot_floor=pivot_floor, method=method)


def nd_solve(plan: NDPlan, factors, b: torch.Tensor,
             method: str = "auto") -> torch.Tensor:
    """Solve K x = b, b (..., n), with :func:`nd_factor` factors.

    The factors (and the plan's index arrays) live in the plan's
    permuted coordinate system; the rhs is permuted on entry and the
    solution un-permuted on exit."""
    dt, dev, batch = b.dtype, b.device, tuple(b.shape[:-1])
    n = plan.n
    kern = _uses_kernels(method, dev)
    pt = _plan_tensors(plan, dev, dt)
    bp = b.new_zeros(batch + (n + 1,))
    bp[..., :n] = b.index_select(-1, pt.perm)
    zero = b.new_zeros(batch + (1,))

    zs = []
    for lt, (L, D, W) in zip(pt.levels, factors):
        z = bp[..., lt.idx] * lt.v
        zs.append(z)
        upd = torch.matmul(z.unsqueeze(-2), W).squeeze(-2) * lt.bv
        # bp[bnd] -= upd: supernodes of a level share boundary variables,
        # so each target sums its contributions through the gather table
        flat = torch.cat([upd.reshape(batch + (-1,)), zero], dim=-1)
        bp[..., lt.tq] -= flat[..., lt.contrib].sum(-1)

    x = b.new_zeros(batch + (n + 1,))
    top = plan.levels[-1] if plan.levels else None
    for lev, lt, (L, D, W), z in zip(reversed(plan.levels),
                                     reversed(pt.levels),
                                     reversed(factors), reversed(zs)):
        if lev is top and plan.top_neg >= 0:
            # amalgamated top stores Linv: solve = two matvecs
            Li = L[..., 0, :, :]
            y = torch.matmul(Li, z[..., 0, :, None]) / D[..., 0, :, None]
            y = _t(torch.matmul(_t(Li), y))
        else:
            y = _solve_vec_blocks(L, D, z, kern)
        y = y - torch.matmul(W, x[..., lt.bnd].unsqueeze(-1)).squeeze(-1)
        # live slots are distinct; every dummy slot writes 0 to x[n]
        x[..., lt.idx] = y * lt.v
    # un-permute: x_orig[perm[p]] = x_perm[p]
    out = torch.empty_like(b)
    out[..., pt.perm] = x[..., :n]
    return out


def nd_solve_matrix(plan: NDPlan, factors, B: torch.Tensor,
                    method: str = "auto") -> torch.Tensor:
    """Multi-rhs variant: B is (..., n, r), solved column by column."""
    if B.shape[-1] == 0:
        return B
    return torch.stack([nd_solve(plan, factors, B[..., c], method)
                        for c in range(B.shape[-1])], dim=-1)
