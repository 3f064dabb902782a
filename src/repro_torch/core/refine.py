"""Post-bisection repair + boundary refinement (the parRSB quality stage).

parRSB never ships raw bisection labels: after the spectral tree bottoms
out, a post-processing pass (paper §6; Sphynx makes the same point for GPU
spectral partitioners) repairs disconnected parts and smooths part
boundaries, recovering the cut/connectivity quality the bisection labels
leave on the table.  This module implements both passes on the assembled
dual graph, host-side NumPy, as pipeline `post` stages:

* **Connected-component repair** (:func:`repair_components`) — label the
  components of every part's induced subgraph (one vectorized
  `connected_labels` sweep over the intra-part edges), keep each part's
  heaviest component, and reassign every other fragment to the neighboring
  part with the maximum shared edge weight (ties toward the lighter part).
  A fragment has *zero* edges to the rest of its own part, so each move
  strictly decreases the cut by the shared weight — repair can only
  improve the cut, and it terminates (the cut is bounded below).  Moves
  prefer destinations that stay under the balance cap; when no sharing
  part fits, connectivity wins and the move is recorded as *forced*.

* **Greedy weighted boundary refinement** (:func:`refine_boundary`) —
  Fiduccia–Mattheyses-style single-node moves over the boundary frontier.
  Each sweep computes, fully vectorized, every boundary node's edge-weight
  connection to each part; the gain of moving node i to part q is
  ``conn[i, q] − conn[i, part[i]]``.  Positive-gain candidates are applied
  in descending gain order under two guards: (a) a node is skipped if any
  neighbor already moved this sweep (its precomputed gain would be stale),
  and (b) the move must keep both endpoint parts inside the weight-balance
  corridor ``[floor, cap]`` — when the best-connected target part would
  overflow the cap, the move falls back to the best *feasible*
  positive-gain target instead of skipping the node.  Applied gains are
  exact, so the cut is strictly non-increasing across sweeps.

The balance corridor is computed ONCE per post chain — from the part
weights the chain starts with — and threaded through every stage via the
``corridor=`` keyword (the pipeline does this; so do :func:`refine_stage`
and :func:`repair_refine` for their internal sub-passes).  Recomputing it
per stage would let a cap-exceeding forced repair move permanently widen
the cap for every later stage.  Each stage records the corridor it used in
``PostStats.corridor``.

Single-node moves can disconnect a part (moving an articulation node), so
:func:`refine_stage` — the "refine" stage the pipeline registers — closes
its FM sweeps with a repair pass: the invariant handed downstream is
**zero disconnected parts** (on a globally connected graph) at a cut no
worse than the bisection's.  :func:`repair_refine` composes the default
post pair (repair, then refine_stage) as one call for direct library use.

Host NumPy, bit-identical to `repro.core.refine` on the same labels.  The
k-way refiner is `repro_torch.core.kway`, the sharded one
`repro_torch.dist.refine_sharded`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.mesh.graphs import Graph, connected_labels


@dataclasses.dataclass
class SweepRecord:
    """One FM sweep: moves applied and the cut on either side."""

    sweep: int
    moves: int
    cut_before: float
    cut_after: float


@dataclasses.dataclass
class PostStats:
    """The `post` section of an :class:`~repro.core.rsb.RSBReport`."""

    stages: list = dataclasses.field(default_factory=list)  # stage names run
    fragments_repaired: int = 0
    forced_moves: int = 0        # fragment moves that had to exceed the cap
    unrepaired_fragments: int = 0  # left behind when repair's round cap hit
    moves_applied: int = 0       # FM single-node moves (kway: kept moves)
    sweeps: list = dataclasses.field(default_factory=list)  # [SweepRecord]
    corridor: tuple | None = None  # (floor, cap) the stage enforced
    kway: object | None = None   # kway.KwayStats when a "kway" stage ran
    cut_before: float = 0.0
    cut_after: float = 0.0
    seconds: float = 0.0
    # The port's own record of a sharded stage (not in ``row()``, which
    # stays `repro`'s): the sweep loop's ``info`` — moves, gathers, cut,
    # sweep and admission seconds — plus plan seconds, halo, w and m.
    sharded: dict | None = None

    def row(self) -> dict:
        """JSON-able summary (benchmark rows, smoke gate)."""
        return {
            "stages": list(self.stages),
            "fragments_repaired": self.fragments_repaired,
            "forced_moves": self.forced_moves,
            "unrepaired_fragments": self.unrepaired_fragments,
            "moves_applied": self.moves_applied,
            "sweeps": [dataclasses.asdict(s) for s in self.sweeps],
            "corridor": list(self.corridor) if self.corridor else None,
            "kway": self.kway.row() if self.kway is not None else None,
            "cut_before": self.cut_before,
            "cut_after": self.cut_after,
            "seconds": self.seconds,
        }

    def to_dict(self) -> dict:
        return self.row()

    @classmethod
    def from_dict(cls, d: dict) -> "PostStats":
        """Rebuild from :meth:`to_dict` output (``kway`` comes back as its
        raw row dict — consumers read it like ``KwayStats.row()``)."""
        s = cls(stages=list(d.get("stages", [])),
                fragments_repaired=d.get("fragments_repaired", 0),
                forced_moves=d.get("forced_moves", 0),
                unrepaired_fragments=d.get("unrepaired_fragments", 0),
                moves_applied=d.get("moves_applied", 0),
                corridor=tuple(d["corridor"]) if d.get("corridor") else None,
                kway=d.get("kway"),
                cut_before=d.get("cut_before", 0.0),
                cut_after=d.get("cut_after", 0.0),
                seconds=d.get("seconds", 0.0))
        s.sweeps = [SweepRecord(**r) for r in d.get("sweeps", [])]
        return s


def edge_cut(graph: Graph, parts: np.ndarray) -> float:
    """Σ ω over cut edges, each undirected edge counted once."""
    cut = parts[graph.rows] != parts[graph.indices]
    return float(graph.weights[cut].sum() / 2.0)


def _part_weights(parts, w, nparts):
    return np.bincount(parts, weights=w, minlength=nparts)


def _balance_corridor(part_w: np.ndarray, balance_tol: float):
    """[floor, cap] weight corridor.  Widened to include the initial state,
    so a partition that already violates the tolerance is never made worse
    but is not required to be fixed here (that is the bisector's job)."""
    mean = part_w.mean()
    cap = max((1.0 + balance_tol) * mean, float(part_w.max()))
    floor = min((1.0 - balance_tol) * mean, float(part_w.min()))
    return floor, cap


def balance_corridor(
    parts: np.ndarray,
    nparts: int,
    weights: np.ndarray | None,
    balance_tol: float,
) -> tuple:
    """The (floor, cap) corridor the post chain starting at ``parts``
    enforces.  Computed once per chain and threaded through every stage via
    ``corridor=`` — see the module docstring for why it must not be
    recomputed mid-chain."""
    parts = np.asarray(parts, dtype=np.int64)
    w = np.ones(parts.size) if weights is None else np.asarray(weights,
                                                               np.float64)
    return _balance_corridor(_part_weights(parts, w, nparts), balance_tol)


def repair_components(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
    max_rounds: int = 8,
) -> tuple[np.ndarray, PostStats]:
    """Reassign every disconnected fragment to its best-connected neighbor
    part.  Strictly cut-decreasing; see the module docstring for the move
    rule.  Rounds iterate because a receiving part may itself have lost its
    anchoring fragment in the same round; convergence is typically 1–2
    rounds (each round strictly decreases the cut).

    ``corridor`` is the post chain's fixed (floor, cap); when None (direct
    library call outside a chain) it is computed from the incoming labels.
    Fragments with no cut edges at all (islands of a globally disconnected
    graph) are left in place — no reassignment can connect them.
    """
    parts = np.asarray(parts, dtype=np.int64).copy()
    n = graph.n
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    rows, cols, ew = graph.rows, graph.indices, graph.weights
    part_w = _part_weights(parts, w, nparts)
    if corridor is None:
        corridor = _balance_corridor(part_w, balance_tol)
    _, cap = corridor
    stats = PostStats(stages=["repair"], corridor=tuple(corridor),
                      cut_before=edge_cut(graph, parts))
    with obs.timed("repair") as t:
        deferred = 0
        for round_no in range(max_rounds):
            deferred = 0
            intra = parts[rows] == parts[cols]
            comp = connected_labels(n, rows[intra], cols[intra])
            n_comp = int(comp.max()) + 1 if n else 0
            comp_w = np.bincount(comp, weights=w, minlength=n_comp)
            # Representative node per component → its (uniform) part.
            _, reps = np.unique(comp, return_index=True)
            part_of_comp = parts[reps]
            # Keep each part's heaviest component (ties: lowest label).
            keep = np.zeros(n_comp, dtype=bool)
            order = np.lexsort((np.arange(n_comp), -comp_w, part_of_comp))
            first = np.r_[True, part_of_comp[order][1:] != part_of_comp[order][:-1]]
            keep[order[first]] = True
            frag_ids = np.flatnonzero(~keep)
            if frag_ids.size == 0:
                break
            # Shared edge weight fragment → foreign part, over cut edges whose
            # source lies in a fragment (compact fragment indexing keeps the
            # bincount at F·nparts, not n·nparts).
            fidx = -np.ones(n_comp, dtype=np.int64)
            fidx[frag_ids] = np.arange(frag_ids.size)
            cut_e = np.flatnonzero(~intra)
            fsrc = fidx[comp[rows[cut_e]]]
            sel = fsrc >= 0
            shared = np.bincount(
                fsrc[sel] * np.int64(nparts) + parts[cols[cut_e[sel]]],
                weights=ew[cut_e[sel]], minlength=frag_ids.size * nparts,
            ).reshape(frag_ids.size, nparts)

            moved_any = False
            received = np.zeros(nparts, dtype=bool)
            for k, f in enumerate(frag_ids):
                src = int(part_of_comp[f])
                if received[src]:
                    # The part just gained members; this fragment may now be
                    # connected to them, so its zero-internal-edge premise (the
                    # strict-cut-decrease argument) no longer holds.  Defer to
                    # the next round, which recomputes components.
                    deferred += 1
                    continue
                cand = np.flatnonzero(shared[k] > 0)
                if cand.size == 0:
                    continue  # island: no foreign edges to follow
                fw = comp_w[f]
                fits = cand[part_w[cand] + fw <= cap]
                pool = fits if fits.size else cand
                best_shared = shared[k, pool].max()
                ties = pool[shared[k, pool] == best_shared]
                tgt = int(ties[np.argmin(part_w[ties])])  # ties → lighter part
                if not fits.size:
                    stats.forced_moves += 1
                parts[comp == f] = tgt
                part_w[tgt] += fw
                part_w[src] -= fw
                received[tgt] = True
                stats.fragments_repaired += 1
                moved_any = True
            if not moved_any:
                break
        else:
            # Round cap hit with fragments still deferred: the contract
            # (zero disconnected parts) is broken — make it diagnosable.
            stats.unrepaired_fragments = deferred

        stats.cut_after = edge_cut(graph, parts)
    stats.seconds = t.seconds
    obs.counter_add("fragments_repaired", stats.fragments_repaired)
    obs.counter_add("forced_moves", stats.forced_moves)
    return parts, stats


def refine_boundary(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    sweeps: int = 4,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
) -> tuple[np.ndarray, PostStats]:
    """Greedy weighted FM-style boundary refinement (module docstring).

    The cut never increases: only strictly-positive-gain moves are applied,
    each under a stale-gain guard (skip if a neighbor already moved this
    sweep) and the weight-balance corridor.  A candidate whose
    best-connected target would overflow the cap falls back to the best
    *feasible* positive-gain target.
    """
    parts = np.asarray(parts, dtype=np.int64).copy()
    n = graph.n
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    rows, cols, ew = graph.rows, graph.indices, graph.weights
    indptr, nbrs = graph.indptr, graph.indices
    part_w = _part_weights(parts, w, nparts)
    part_n = np.bincount(parts, minlength=nparts)
    if corridor is None:
        corridor = _balance_corridor(part_w, balance_tol)
    floor, cap = corridor
    stats = PostStats(stages=["refine"], corridor=tuple(corridor),
                      cut_before=edge_cut(graph, parts))
    with obs.timed("refine_sweeps") as t:
        for s in range(sweeps):
            pr, pc = parts[rows], parts[cols]
            cut_mask = pr != pc
            cut0 = float(ew[cut_mask].sum() / 2.0)
            bmask = np.zeros(n, dtype=bool)
            bmask[rows[cut_mask]] = True
            bnodes = np.flatnonzero(bmask)
            if bnodes.size == 0:
                break
            bidx = -np.ones(n, dtype=np.int64)
            bidx[bnodes] = np.arange(bnodes.size)
            e_sel = bidx[rows] >= 0
            conn = np.bincount(
                bidx[rows[e_sel]] * np.int64(nparts) + pc[e_sel],
                weights=ew[e_sel], minlength=bnodes.size * nparts,
            ).reshape(bnodes.size, nparts)
            own = parts[bnodes]
            ar = np.arange(bnodes.size)
            internal = conn[ar, own].copy()
            conn[ar, own] = -np.inf
            best = conn.argmax(1)
            gain = conn[ar, best] - internal
            cand = np.flatnonzero(gain > 1e-12)
            order = cand[np.argsort(-gain[cand], kind="stable")]

            moved = np.zeros(n, dtype=bool)
            applied = 0
            for k in order:
                node = int(bnodes[k])
                nb = nbrs[indptr[node]:indptr[node + 1]]
                if moved[nb].any():
                    continue  # stale gain: a neighbor changed sides this sweep
                src, wn = int(parts[node]), w[node]
                if part_w[src] - wn < floor or part_n[src] <= 1:
                    continue  # never empty or under-floor the source part
                # Best *feasible* positive-gain target: when the argmax part
                # would overflow the cap, fall back to the next-best part that
                # both improves the cut and fits the corridor.
                row = conn[k]
                pos = np.flatnonzero(row - internal[k] > 1e-12)
                fits = pos[part_w[pos] + wn <= cap]
                if fits.size == 0:
                    continue
                tgt = int(fits[np.argmax(row[fits])])
                parts[node] = tgt
                part_w[tgt] += wn
                part_w[src] -= wn
                part_n[tgt] += 1
                part_n[src] -= 1
                moved[node] = True
                applied += 1
            cut1 = edge_cut(graph, parts)
            stats.sweeps.append(SweepRecord(sweep=s, moves=applied,
                                            cut_before=cut0, cut_after=cut1))
            stats.moves_applied += applied
            if applied == 0:
                break

        stats.cut_after = edge_cut(graph, parts)
    stats.seconds = t.seconds
    obs.counter_add("refine_moves", stats.moves_applied)
    obs.counter_add("refine_sweeps", len(stats.sweeps))
    return parts, stats


def close_with_repair(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    stats: PostStats,
    *,
    weights: np.ndarray | None = None,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
) -> tuple[np.ndarray, PostStats]:
    """Close an FM stage with a repair pass and merge its accounting into
    ``stats`` — the shared tail of the "refine" and "kway" stages, so the
    two report repair activity identically."""
    parts, r = repair_components(graph, parts, nparts, weights=weights,
                                 balance_tol=balance_tol, corridor=corridor)
    stats.fragments_repaired += r.fragments_repaired
    stats.forced_moves += r.forced_moves
    stats.unrepaired_fragments = r.unrepaired_fragments
    stats.cut_after = r.cut_after
    stats.seconds += r.seconds
    return parts, stats


def refine_stage(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    sweeps: int = 4,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
) -> tuple[np.ndarray, PostStats]:
    """The pipeline's "refine" stage: FM boundary sweeps + a closing repair
    pass, so articulation moves cannot leave a disconnected part.  Both
    passes are cut-non-increasing, so the stage is too.  One corridor
    (computed here from the incoming labels unless the chain supplies it)
    governs both passes."""
    if corridor is None:
        corridor = balance_corridor(parts, nparts, weights, balance_tol)
    parts, stats = refine_boundary(graph, parts, nparts, weights=weights,
                                   sweeps=sweeps, balance_tol=balance_tol,
                                   corridor=corridor)
    return close_with_repair(graph, parts, nparts, stats, weights=weights,
                             balance_tol=balance_tol, corridor=corridor)


def repair_refine(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    sweeps: int = 4,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
    repair: bool = True,
    refine: bool = True,
) -> tuple[np.ndarray, PostStats]:
    """The default post pair — :func:`repair_components` then
    :func:`refine_stage` — composed as one call (exactly what the pipeline
    runs for ``post=("repair", "refine")``).  One corridor, computed from
    the incoming labels, governs the whole chain."""
    with obs.timed("repair_refine") as t_chain:
        if corridor is None:
            corridor = balance_corridor(parts, nparts, weights, balance_tol)
        stats = PostStats(corridor=tuple(corridor),
                          cut_before=edge_cut(graph, parts))
        kw = dict(weights=weights, balance_tol=balance_tol, corridor=corridor)
        if repair:
            parts, r = repair_components(graph, parts, nparts, **kw)
            stats.stages.append("repair")
            stats.fragments_repaired += r.fragments_repaired
            stats.forced_moves += r.forced_moves
            stats.unrepaired_fragments = r.unrepaired_fragments
        if refine:
            parts, f = refine_stage(graph, parts, nparts, sweeps=sweeps, **kw)
            stats.stages.append("refine")
            stats.fragments_repaired += f.fragments_repaired
            stats.forced_moves += f.forced_moves
            stats.unrepaired_fragments = f.unrepaired_fragments
            stats.moves_applied += f.moves_applied
            stats.sweeps.extend(f.sweeps)
        stats.cut_after = edge_cut(graph, parts)
    stats.seconds = t_chain.seconds
    return parts, stats
