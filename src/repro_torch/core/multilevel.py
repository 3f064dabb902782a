"""METIS-style multilevel k-way V-cycle — the ``bisect="multilevel"`` stage.

The port of `repro.core.multilevel`: all host NumPy, bit-identical to
`repro`'s on the same inputs, and it runs no kernel.  Instead of Fiedler
solves on the fine graph:

1. **Coarsen** — a ladder of heavy-edge-matching aggregations
   (:func:`repro_torch.core.amg.heavy_edge_matching`) Galerkin-coarsens the
   graph down to ~``coarse_factor * nparts`` nodes.  Edge AND node weights
   flow through :func:`~repro_torch.core.amg.coarsen_graph` — node-weight
   totals are conserved exactly, so one corridor (computed from the fine
   totals) is valid at every level.
2. **Partition the coarsest graph directly** — dense-``eigh`` recursive
   spectral bisection (the coarsest graph is tiny) or seeded BFS k-way
   growth, polished by full :func:`~repro_torch.core.kway.kway_fm` passes.
3. **Prolong + refine** — labels transfer by aggregate copy
   (``parts_fine = parts_coarse[agg]``), and each level runs an explicit
   balance-restoration pass (:func:`_rebalance`) followed by a bounded
   boundary-restricted FM sweep, so per-level refinement is O(boundary).

Balance is enforced twice over: matching is weight-capped (no aggregate
may outweigh ``total/(coarse_factor·nparts)``), and any residual
violation is repaired during uncoarsening by :func:`_rebalance` rather
than grandfathered in through corridor widening.

Observability, as in `repro`: one ``mlevel:N`` span per ladder level on
the way down (matching + coarsening) and again on the way up (prolong +
refine), a ``coarsen`` span over the whole ladder, a ``coarsest`` span
around the direct solve, ``finalize`` around the closing repair and
rebalance, and the ``ml_levels`` / ``ml_coarsen_ratio`` / ``ml_fm_moves``
/ ``edge_cut`` metrics.  ``mlevel:0`` is emitted even when the input is
already coarse enough to skip the ladder.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.amg import coarsen_graph, heavy_edge_matching
from repro_torch.core.kway import kway_fm, kway_fm_boundary
from repro_torch.core.laplacian import dense_laplacian_np
from repro_torch.core.refine import (
    _part_weights,
    edge_cut,
    refine_boundary,
    repair_components,
)
from repro_torch.core.rsb import BisectionRecord, LevelRecord, RSBReport, _proportional_split
from repro_torch.mesh.graphs import Graph

# Above this size the dense-eigh coarsest solve (O(n³)) costs more than it
# buys over seeded growth + FM polish; "spectral" falls back to "greedy".
_DENSE_SPECTRAL_MAX = 1024

_EPS = 1e-9


@dataclasses.dataclass
class MLLevel:
    """One ladder level: the coarsening step taken from it on the way down
    and the refinement sweep run on it on the way up."""

    level: int
    n: int                       # fine-side node count at this level
    n_coarse: int                # nodes after this level's aggregation
    ratio: float                 # n_coarse / n
    coarsen_seconds: float = 0.0
    refine_seconds: float = 0.0
    fm_moves: int = 0            # boundary-FM moves kept at this level
    balance_moves: int = 0       # forced rebalance moves at this level
    cut: float = 0.0             # cut after this level's refinement

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class MultilevelStats:
    """The ``ml`` section of an :class:`~repro_torch.core.rsb.RSBReport`."""

    levels: int = 0              # coarsening-ladder depth
    n_fine: int = 0
    n_coarsest: int = 0
    coarsen_ratio: float = 1.0   # n_coarsest / n_fine
    coarse_solver: str = "spectral"   # solver actually used
    coarsen_seconds: float = 0.0
    coarsest_seconds: float = 0.0
    refine_seconds: float = 0.0
    coarse_cut: float = 0.0      # cut on the coarsest graph after FM polish
    fm_moves: int = 0            # kept moves, coarsest polish + all levels
    balance_moves: int = 0       # forced rebalance moves, all levels
    records: list = dataclasses.field(default_factory=list)  # [MLLevel]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["records"] = [r.to_dict() for r in self.records]
        return d


def _fiedler_dense(g: Graph) -> np.ndarray:
    if g.n <= 1:
        return np.zeros(g.n)
    _, vecs = np.linalg.eigh(dense_laplacian_np(g))
    return vecs[:, 1]


def _dense_spectral_parts(graph: Graph, node_w: np.ndarray,
                          nparts: int) -> np.ndarray:
    """Recursive spectral bisection with dense ``eigh`` — exact Fiedler
    vectors, affordable because the coarsest graph is ~coarse_factor·nparts
    nodes.  Splits are weight-proportional so part counts line up with the
    k-way target before the FM polish."""
    parts = np.zeros(graph.n, dtype=np.int64)

    def rec(g, w, idx, p_lo, k):
        if k <= 1 or idx.size <= 1:
            parts[idx] = p_lo
            return
        n_left = k // 2
        lo, hi = _proportional_split(_fiedler_dense(g), w, n_left, k)
        rec(g.sub(lo), w[lo], idx[lo], p_lo, n_left)
        rec(g.sub(hi), w[hi], idx[hi], p_lo + n_left, k - n_left)

    rec(graph, node_w, np.arange(graph.n, dtype=np.int64), 0, nparts)
    return parts


def _rebalance(graph: Graph, parts: np.ndarray, nparts: int,
               node_w: np.ndarray, corridor: tuple,
               max_rounds: int = 8) -> int:
    """Forced balance restoration toward ``corridor`` — the IDEAL corridor,
    not a widened one.  Per round, ONE vectorized gain table covers every
    movable boundary node (nodes of over-cap parts, plus nodes a
    under-floor part could pull in), then moves apply greedily in
    least-cut-damage order under live part weights: out of over-cap parts
    into any adjacent part with room, and into under-floor parts from any
    donor that stays above the floor.  No move creates a new violation, so
    total violation is non-increasing and the loop terminates.

    The V-cycle runs this at every uncoarsening level: violations a coarse
    level cannot fix (its nodes are too heavy) shrink a level finer where
    the same weight is spread over lighter movable nodes, instead of being
    grandfathered in by the corridor-widening convention the FM stages
    use.  Batched rounds (vs one scan per move) matter at the finest
    level, where a closing repair may strand hundreds of nodes' worth of
    excess in one part.  Mutates ``parts`` in place; returns the move
    count."""
    floor, cap = corridor
    rows, cols, ew = graph.rows, graph.indices, graph.weights
    pw = np.bincount(parts, weights=node_w, minlength=nparts)
    pn = np.bincount(parts, minlength=nparts)
    moves = 0
    for _ in range(max_rounds):
        over = pw > cap + _EPS
        under = pw < floor - _EPS
        if not over.any() and not under.any():
            break
        pr, pc = parts[rows], parts[cols]
        push_m = over[pr] & (pc != pr)
        pull_m = under[pc] & ~under[pr] & (pc != pr)
        cand = np.unique(rows[push_m | pull_m])
        if cand.size == 0:
            break
        cidx = np.full(graph.n, -1, dtype=np.int64)
        cidx[cand] = np.arange(cand.size)
        e_sel = cidx[rows] >= 0
        conn = np.bincount(
            cidx[rows[e_sel]] * np.int64(nparts) + pc[e_sel],
            weights=ew[e_sel], minlength=cand.size * nparts,
        ).reshape(cand.size, nparts)
        ar = np.arange(cand.size)
        own_part = parts[cand]
        internal = conn[ar, own_part]
        ext = conn.copy()
        ext[ar, own_part] = -np.inf
        # order ALL candidates by the damage of their best external move;
        # rebalance is forced, so negative gains are admitted — the order
        # just spends the cheapest moves first
        order = np.argsort(-(ext[ar, ext.argmax(1)] - internal),
                           kind="stable")
        did = 0
        for k in order.tolist():
            i = int(cand[k])
            s = int(parts[i])
            wi = float(node_w[i])
            if pn[s] <= 1:
                continue
            row = conn[k]
            t = -1
            if pw[s] > cap + _EPS:
                # push: strongest-connected adjacent part with room
                for q in np.argsort(-row).tolist():
                    if q == s:
                        continue
                    if row[q] <= 0.0:
                        break
                    if pw[q] + wi <= cap + _EPS:
                        t = q
                        break
            elif pw[s] - wi >= floor - _EPS:
                # pull: an adjacent under-floor part, donor stays legal
                uq = np.flatnonzero((row > 0.0) & (pw < floor - _EPS))
                if uq.size:
                    q = int(uq[np.argmax(row[uq])])
                    if pw[q] + wi <= cap + _EPS:
                        t = q
            if t < 0:
                continue
            parts[i] = t
            pw[s] -= wi
            pw[t] += wi
            pn[s] -= 1
            pn[t] += 1
            did += 1
            if not (pw > cap + _EPS).any() and \
                    not (pw < floor - _EPS).any():
                break
        moves += did
        if did == 0:
            break
    return moves


def _bfs_order(graph: Graph) -> np.ndarray:
    """Breadth-first node order, component by component (host loop — only
    ever run on the coarsest graph)."""
    indptr, nbrs = graph.indptr, graph.indices
    seen = np.zeros(graph.n, dtype=bool)
    out: list = []
    for s in range(graph.n):
        if seen[s]:
            continue
        seen[s] = True
        frontier = [s]
        while frontier:
            out.extend(frontier)
            nxt = np.unique(np.concatenate(
                [nbrs[indptr[i]:indptr[i + 1]] for i in frontier]))
            nxt = nxt[~seen[nxt]]
            seen[nxt] = True
            frontier = nxt.tolist()
    return np.asarray(out, dtype=np.int64)


def _greedy_grow_parts(graph: Graph, node_w: np.ndarray,
                       nparts: int) -> np.ndarray:
    """Seeded k-way growth: BFS order, then contiguous cumulative-weight
    chunks of ~total/nparts each.  Crude on purpose — the coarse FM passes
    and the V-cycle refinement do the optimization; this only provides k
    connected-ish, weight-proportional seeds.  Every part gets ≥1 node."""
    order = _bfs_order(graph)
    cw = np.cumsum(node_w[order])
    targets = cw[-1] * (np.arange(1, nparts) / nparts)
    cuts = np.searchsorted(cw, targets, side="left") + 1
    parts = np.empty(graph.n, dtype=np.int64)
    prev = 0
    for p in range(nparts - 1):
        c = max(int(cuts[p]), prev + 1)
        c = min(c, graph.n - (nparts - 1 - p))
        parts[order[prev:c]] = p
        prev = c
    parts[order[prev:]] = nparts - 1
    return parts


def multilevel_partition(
    graph: Graph,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    coarse_factor: int = 8,
    coarse_solver: str = "spectral",
    refine_passes: int = 2,
    stall: int = 32,
    coarse_passes: int = 8,
    fm_below: int = 4096,
    balance_tol: float = 0.05,
    seed: int = 0,
    max_levels: int = 32,
    min_coarsen_ratio: float = 0.95,
) -> tuple[np.ndarray, RSBReport]:
    """The full V-cycle (module docstring): coarsen to
    ~``coarse_factor * nparts`` nodes, partition the coarsest graph
    directly, prolong + boundary-refine level by level.

    ``coarse_solver`` ∈ {"spectral", "greedy"}: dense-eigh recursive
    bisection (falls back to greedy above ``_DENSE_SPECTRAL_MAX`` nodes)
    or seeded BFS growth.  ``min_coarsen_ratio`` stops the ladder when
    matching stalls (a round that shrinks the graph by <5% is not worth a
    level).

    Per-level refinement is hybrid: levels with ≤ ``fm_below`` nodes run
    the hill-climbing boundary FM (``stall``/``refine_passes`` bound it;
    ``coarse_passes`` the full polish at the coarsest level) — coarse
    moves are cheap and their decisions propagate through every finer
    level — while larger levels run the *vectorized* greedy boundary
    sweeps (:func:`~repro_torch.core.refine.refine_boundary`), which smooth the
    prolonged boundaries at a per-sweep cost of one edge scan.  That split
    is what keeps the V-cycle wall sublinear in the FM work: the Python
    heap climb never touches a fine level.

    Returns ``(parts, report)`` with ``report.engine == "multilevel"``,
    per-level :class:`BisectionRecord`/:class:`LevelRecord` rows (so
    benchmark columns work unchanged: ``iterations`` = kept FM moves,
    ``levels`` = ladder depth) and the full :class:`MultilevelStats` on
    ``report.ml``.
    """
    n = graph.n
    if nparts <= 0:
        raise ValueError(f"nparts must be positive, got {nparts}")
    if nparts > n:
        raise ValueError(f"nparts={nparts} exceeds graph size {n}")
    if coarse_solver not in ("spectral", "greedy"):
        raise ValueError(f"unknown coarse_solver: {coarse_solver!r} "
                         "(have 'spectral', 'greedy')")
    node_w = (np.ones(n) if weights is None
              else np.asarray(weights, np.float64))
    stats = MultilevelStats(n_fine=n)
    target = max(int(coarse_factor) * nparts, nparts)
    # Aggregate-weight cap: no coarse node may outweigh 1/coarse_factor of
    # a part.  Self-consistent with the node-count target (total/target is
    # exactly the mean node weight AT the target) and the balance
    # guarantee: coarsest granularity stays ~1/coarse_factor of a part, so
    # a near-ideal split exists at every level of the ladder.
    max_agg_w = node_w.sum() / target

    with obs.timed("engine", engine="multilevel") as t_all:
        # --- down: heavy-edge-matching coarsening ladder
        ladder: list = []   # (fine_graph, fine_node_w, agg) per level
        g, w = graph, node_w
        with obs.timed("coarsen") as t_down:
            lvl = 0
            while g.n > target and lvl < max_levels:
                with obs.timed(f"mlevel:{lvl}", n=int(g.n)) as t_l:
                    agg, n_c = heavy_edge_matching(
                        g, node_weights=w, max_weight=max_agg_w,
                        seed=seed + lvl, rounds=8)
                    if n_c >= min_coarsen_ratio * g.n:
                        break   # matching stalled; a level would buy nothing
                    g_c, w_c = coarsen_graph(g, agg, n_c, node_weights=w)
                ladder.append((g, w, agg))
                stats.records.append(MLLevel(
                    level=lvl, n=g.n, n_coarse=n_c, ratio=n_c / g.n,
                    coarsen_seconds=t_l.seconds))
                g, w = g_c, w_c
                lvl += 1
        stats.levels = len(ladder)
        stats.n_coarsest = g.n
        stats.coarsen_ratio = g.n / max(n, 1)
        stats.coarsen_seconds = t_down.seconds

        # One corridor anchored on the FINE totals — valid at every level
        # because coarsen_graph conserves the node-weight sum exactly.
        mean = node_w.sum() / nparts
        ideal = ((1.0 - balance_tol) * mean, (1.0 + balance_tol) * mean)

        def widened(parts_lvl, w_lvl):
            """The ideal corridor, widened (refine.py convention) to admit
            the state this level starts from — never to demand worse."""
            pw = _part_weights(parts_lvl, w_lvl, nparts)
            return (min(ideal[0], float(pw.min())),
                    max(ideal[1], float(pw.max())))

        # --- coarsest: direct partition + full k-way FM polish
        solver = coarse_solver
        if solver == "spectral" and g.n > _DENSE_SPECTRAL_MAX:
            solver = "greedy"
        stats.coarse_solver = solver
        with obs.timed("coarsest", n=int(g.n), solver=solver) as t_c:
            if solver == "spectral":
                parts = _dense_spectral_parts(g, w, nparts)
            else:
                parts = _greedy_grow_parts(g, w, nparts)
            bal = _rebalance(g, parts, nparts, w, ideal)
            parts, st_c = kway_fm(g, parts, nparts, weights=w,
                                  passes=coarse_passes,
                                  corridor=widened(parts, w))
        stats.coarsest_seconds = t_c.seconds
        stats.coarse_cut = st_c.cut_after
        stats.fm_moves += st_c.moves_applied
        stats.balance_moves += bal

        # --- up: prolong by aggregate copy, restore balance toward the
        # ideal corridor (finer granularity makes it reachable), then run
        # the bounded boundary refinement.
        if ladder:
            for lvl in range(len(ladder) - 1, -1, -1):
                g_f, w_f, agg = ladder[lvl]
                with obs.timed(f"mlevel:{lvl}", n=int(g_f.n)) as t_r:
                    parts = parts[agg]
                    bal = _rebalance(g_f, parts, nparts, w_f, ideal)
                    if g_f.n <= fm_below:
                        parts, st = kway_fm_boundary(
                            g_f, parts, nparts, weights=w_f,
                            passes=refine_passes,
                            stall=max(stall, g_f.n // 16),
                            corridor=widened(parts, w_f))
                    else:
                        parts, st = refine_boundary(
                            g_f, parts, nparts, weights=w_f,
                            sweeps=2 * refine_passes,
                            corridor=widened(parts, w_f))
                rec = stats.records[lvl]
                rec.refine_seconds = t_r.seconds
                rec.fm_moves = st.moves_applied
                rec.balance_moves = bal
                rec.cut = st.cut_after
                stats.fm_moves += st.moves_applied
                stats.balance_moves += bal
        else:
            # Degenerate ladder (input already coarse): still run one
            # bounded boundary sweep under the mlevel:0 span, keeping both
            # the refinement contract and the drift guard's span set.
            with obs.timed("mlevel:0", n=int(n)) as t_r:
                bal = _rebalance(graph, parts, nparts, node_w, ideal)
                parts, st = kway_fm_boundary(
                    graph, parts, nparts, weights=node_w,
                    passes=refine_passes, stall=stall,
                    corridor=widened(parts, node_w))
            stats.records.append(MLLevel(
                level=0, n=n, n_coarse=n, ratio=1.0,
                refine_seconds=t_r.seconds, fm_moves=st.moves_applied,
                balance_moves=bal, cut=st.cut_after))
            stats.fm_moves += st.moves_applied
            stats.balance_moves += bal
        # --- finalize: the V-cycle's own closing repair.  Per-level FM can
        # strand fragments (a part split in two by a move sequence), and a
        # downstream repair stage would heal them by moving whole fragments
        # — wrecking balance at exactly the granularity where the corridor
        # was finally reachable.  Repairing INSIDE the stage (against the
        # ideal corridor) followed by one more rebalance keeps the stage's
        # contract: connected, corridor-balanced raw labels.
        with obs.timed("finalize") as t_fin:
            parts, _rep = repair_components(graph, parts, nparts,
                                            weights=node_w, corridor=ideal)
            stats.balance_moves += _rebalance(graph, parts, nparts, node_w,
                                              ideal)
            # polish the cut damage the forced moves left behind (cheap:
            # two vectorized sweeps)
            parts, _pol = refine_boundary(graph, parts, nparts,
                                          weights=node_w, sweeps=2,
                                          corridor=widened(parts, node_w))
        stats.refine_seconds = (
            sum(r.refine_seconds for r in stats.records) + t_fin.seconds)

    obs.gauge_set("ml_levels", stats.levels)
    obs.gauge_set("ml_coarsen_ratio", stats.coarsen_ratio)
    obs.counter_add("ml_fm_moves", stats.fm_moves)
    obs.gauge_set("edge_cut", edge_cut(graph, parts))

    records = [BisectionRecord(
        level=r.level, size=r.n, nparts=nparts, method="hem+kway",
        iterations=r.fm_moves, eigenvalue=0.0, residual=0.0,
        seconds=r.refine_seconds, levels=stats.levels,
        split_seconds=r.coarsen_seconds) for r in stats.records]
    levels = [LevelRecord(
        level=r.level, n_nodes=1, total_size=r.n, buckets=[],
        iterations=r.fm_moves, solve_seconds=r.refine_seconds,
        split_seconds=r.coarsen_seconds) for r in stats.records]
    report = RSBReport(records=records, seconds=t_all.seconds,
                       levels=levels, engine="multilevel",
                       multilevel=True, ml=stats)
    return parts, report
