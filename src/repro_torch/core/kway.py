"""Hill-climbing k-way Fiduccia–Mattheyses refinement (the "kway" stage).

The greedy boundary refiner (:func:`repro.core.refine.refine_boundary`)
applies strictly-positive-gain moves under a stale-gain guard, which makes
every sweep a full vectorized recompute and leaves it stuck in any local
minimum where every single move is neutral or negative.  This module is
the classic FM escape, generalized to k parts (Karypis & Kumar's k-way
refinement; Sphynx makes the same argument for GPU spectral partitioners):

* **Per-(node, part) gain structure with sorted-heap updates.**  One dense
  ``conn[node, part]`` edge-weight table is built vectorized per pass;
  after that a move updates only the mover's neighbors — O(degree)
  conn-row touches plus an O(nparts) best-target rescan per touched
  neighbor — instead of recomputing the table.  The inner structures are
  plain Python lists: at mesh-partitioning degrees (~6) and part counts
  (≤64), numpy's per-call dispatch on degree-sized arrays costs an order
  of magnitude more than the scalar arithmetic it would vectorize.  The
  heap is a lazy max-heap over (gain, version, node, target) entries:
  every conn-row change bumps the node's version stamp and pushes a fresh
  exact entry, so stale entries (older stamp, or node already locked) are
  simply discarded at pop time — the standard lazy-invalidation
  alternative to bucket deletion that also handles non-integer edge
  weights.  Part-weight drift cannot stale a gain (gains depend only on
  conn rows); it can only change *feasibility*, which is re-checked at
  pop.

* **Hill climbing with rollback to the best prefix.**  Moves are applied
  *tentatively* in best-gain-first order even when the best gain is
  negative, the running cut is tracked exactly (applied gains are exact —
  recomputed from the live ``conn`` at pop time), and at pass end every
  move after the best-prefix cut minimum is undone.  A pass therefore
  never ends worse than it started, but it can walk *through* a
  cut-increasing ridge that the greedy refiner cannot cross.

* **One corridor, one lock.**  Per-move incremental balance accounting
  runs against a ``[floor, cap]`` corridor fixed once per post chain
  (``corridor=``; never recomputed mid-chain — see
  :mod:`repro.core.refine`), and a lock array lets each node move at most
  once per pass, so passes terminate and oscillation is impossible.

Moves are restricted to *adjacent* parts (``conn[node, q] > 0``): a move
to a non-adjacent part can only increase the cut and is never the FM
escape route.  Target ties break toward the lighter part.

:func:`kway_stage` — what the pipeline registers as ``"kway"`` — closes
the FM passes with a connected-component repair pass, so the
zero-disconnected-parts invariant survives articulation moves, exactly
like the greedy ``"refine"`` stage.  :class:`KwayStats` (passes, rollback
depth, best-prefix index, per-pass cut trajectory) rides through
``PostStats.kway`` into ``RSBReport.post``.

Host Python/NumPy copied from `repro.core.kway`, bit-identical on given
labels; its inner loop is scalar by design and stays on the host.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch import obs
from repro_torch.core.refine import (
    PostStats,
    _balance_corridor,
    _part_weights,
    balance_corridor,
    close_with_repair,
    edge_cut,
)
from repro_torch.mesh.graphs import Graph

_EPS = 1e-12


@dataclasses.dataclass
class KwayPassRecord:
    """One hill-climbing pass: how far it walked and what it kept."""

    pass_no: int
    attempted: int      # moves tentatively applied
    best_prefix: int    # kept prefix length (index of the cut minimum)
    rolled_back: int    # attempted − best_prefix
    cut_before: float
    cut_after: float    # cut at the best prefix (== cut_before if none)


@dataclasses.dataclass
class KwayStats:
    """The `kway` section of :class:`~repro.core.refine.PostStats`."""

    passes: int = 0
    moves_attempted: int = 0
    moves_kept: int = 0
    rolled_back: int = 0
    records: list = dataclasses.field(default_factory=list)  # [KwayPassRecord]

    def row(self) -> dict:
        return {
            "passes": self.passes,
            "moves_attempted": self.moves_attempted,
            "moves_kept": self.moves_kept,
            "rolled_back": self.rolled_back,
            "records": [dataclasses.asdict(r) for r in self.records],
        }

    def to_dict(self) -> dict:
        return self.row()

    @classmethod
    def from_dict(cls, d: dict) -> "KwayStats":
        s = cls(passes=d.get("passes", 0),
                moves_attempted=d.get("moves_attempted", 0),
                moves_kept=d.get("moves_kept", 0),
                rolled_back=d.get("rolled_back", 0))
        s.records = [KwayPassRecord(**r) for r in d.get("records", [])]
        return s


def kway_fm(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    passes: int = 8,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
    stall: int | None = None,
    nodes: np.ndarray | None = None,
) -> tuple[np.ndarray, PostStats]:
    """Hill-climbing k-way FM (module docstring).  Cut-non-increasing: a
    pass is rolled back to its best prefix, so the returned cut is the
    minimum the climb visited.

    ``stall`` caps the number of consecutive non-improving tentative moves
    before a pass gives up its climb (None = exhaust the boundary: every
    unlocked feasible node moves once).  The default bounds the climb so
    the stage stays a small fraction of the solve wall; deep ridges past
    the stall horizon are reachable by raising it.  Passes end early when
    a full pass keeps no move.

    ``nodes`` restricts the movable set: only the listed nodes get conn
    rows, heap entries, or moves — everything else is frozen scenery whose
    edges still contribute to gains.  The mutable mirrors (conn table,
    adjacency, locks) are sized to the candidate set, so the per-pass cost
    is O(candidates · (degree + nparts)) plus one vectorized edge sweep —
    what makes boundary-restricted refinement O(boundary), not O(n).  With
    ``nodes=None`` the compact indexing is the identity and behavior is
    exactly the unrestricted stage.
    """
    parts_np = np.asarray(parts, dtype=np.int64).copy()
    n = graph.n
    w_np = (np.ones(n) if weights is None
            else np.asarray(weights, np.float64))
    rows, ew = graph.rows, graph.weights
    indptr, nbrs = graph.indptr, graph.indices
    if nodes is None:
        cand, pos = np.arange(n, dtype=np.int64), None
    else:
        cand = np.unique(np.asarray(nodes, dtype=np.int64))
        pos = np.full(n, -1, dtype=np.int64)
        pos[cand] = np.arange(cand.size, dtype=np.int64)
    m = cand.size
    part_w_np = _part_weights(parts_np, w_np, nparts)
    if corridor is None:
        corridor = _balance_corridor(part_w_np, balance_tol)
    floor, cap = (float(corridor[0]), float(corridor[1]))
    cap_slack, floor_slack = cap + 1e-9, floor - 1e-9
    kstats = KwayStats()
    stats = PostStats(stages=["kway"], corridor=(floor, cap), kway=kstats,
                      cut_before=edge_cut(graph, parts_np))
    with obs.timed("kway_fm") as t:
        cut = stats.cut_before
        if stall is None:
            stall = max(64, m // 8)

        # Plain-Python mirrors of the mutable state (module docstring: scalar
        # updates beat numpy dispatch at degree-sized granularity).  All of
        # them are indexed by candidate position; part weights/counts stay
        # global (frozen nodes still occupy their parts).
        if pos is None:
            parts_l = parts_np.tolist()
            w_l = w_np.tolist()
        else:
            parts_l = parts_np[cand].tolist()
            w_l = w_np[cand].tolist()
        part_w = part_w_np.tolist()
        part_n = np.bincount(parts_np, minlength=nparts).tolist()
        if pos is None:
            nbrs_l, ew_l, off = nbrs.tolist(), ew.tolist(), indptr.tolist()
            adj = [list(zip(nbrs_l[off[i]:off[i + 1]],
                            ew_l[off[i]:off[i + 1]]))
                   for i in range(n)]
        else:
            # Neighbor ids remapped to candidate positions (-1 = frozen):
            # per-candidate-row slices, so building this is O(Σ deg(cand)).
            adj = [list(zip(pos[nbrs[indptr[i]:indptr[i + 1]]].tolist(),
                            ew[indptr[i]:indptr[i + 1]].tolist()))
                   for i in cand.tolist()]
        prange = range(nparts)

        for pass_no in range(passes):
            # Dense per-(node, part) connection table, one vectorized build,
            # then scalar increments only.
            conn_np = np.zeros((m, nparts))
            if pos is None:
                np.add.at(conn_np, (rows, parts_np[nbrs]), ew)
            else:
                sel = pos[rows] >= 0
                np.add.at(conn_np, (pos[rows[sel]], parts_np[nbrs[sel]]),
                          ew[sel])
            conn = conn_np.tolist()
            locked = [False] * m
            ver = [0] * m   # conn-row version stamps
            heap: list = []
            seq = 0  # FIFO tiebreak keeps equal-gain pops deterministic

            def push(i: int):
                """Push node i's best feasible adjacent target (exact gain
                from the live conn row; ties → lighter part), stamped with the
                row's current version."""
                nonlocal seq
                row = conn[i]
                src = parts_l[i]
                wi = w_l[i]
                own = row[src]
                best_g = None
                best_t = -1
                best_w = 0.0
                for q in prange:
                    c = row[q]
                    if c <= _EPS or q == src or part_w[q] + wi > cap_slack:
                        continue
                    g = c - own
                    if (best_g is None or g > best_g + _EPS
                            or (g > best_g - _EPS and part_w[q] < best_w)):
                        best_g, best_t, best_w = g, q, part_w[q]
                if best_g is not None:
                    heapq.heappush(heap, (-best_g, seq, i, best_t, ver[i]))
                    seq += 1

            total = np.bincount(rows, weights=ew, minlength=n)
            if pos is None:
                own_all = conn_np[np.arange(n), parts_np]
                frontier = np.flatnonzero(total - own_all > _EPS)
            else:
                own_all = conn_np[np.arange(m), parts_np[cand]]
                frontier = np.flatnonzero(total[cand] - own_all > _EPS)
            for i in frontier.tolist():
                push(i)  # boundary frontier

            move_log: list = []   # (node, src, tgt, gain)
            run_cut = best_cut = cut
            best_idx = 0
            pops, max_pops = 0, 50 * m + 1000  # lazy-heap runaway backstop
            while heap and pops < max_pops:
                pops += 1
                neg_gain, _, i, tgt, entry_ver = heapq.heappop(heap)
                if locked[i] or entry_ver != ver[i]:
                    continue  # stale: a fresher exact entry was pushed
                src = parts_l[i]
                wi = w_l[i]
                if part_w[tgt] + wi > cap_slack:
                    # Target filled up since the push (part weights drift
                    # without touching conn rows).  Re-evaluate this node once
                    # against the current weights.
                    ver[i] += 1
                    push(i)
                    continue
                if part_w[src] - wi < floor_slack or part_n[src] <= 1:
                    # Source constraint: never under-floor or empty a part.
                    # No re-push (unlike the cap branch): the node's conn row
                    # is unchanged, so push() would recreate this same entry
                    # and loop.  The node returns next pass if still boundary.
                    continue
                gain = -neg_gain  # exact: conn[i] unchanged since the push
                # Tentative apply — hill climbing admits negative gains.
                parts_l[i] = tgt
                part_w[src] -= wi
                part_w[tgt] += wi
                part_n[src] -= 1
                part_n[tgt] += 1
                locked[i] = True
                run_cut -= gain
                move_log.append((i, src, tgt, gain))
                if run_cut < best_cut - _EPS:
                    best_cut, best_idx = run_cut, len(move_log)
                # O(degree) incremental gain update: only the mover's
                # neighbors' connections to (src, tgt) changed.  j < 0 is
                # a frozen neighbor (nodes= restriction): no conn row.
                for j, wij in adj[i]:
                    if j < 0:
                        continue
                    row = conn[j]
                    row[src] -= wij
                    row[tgt] += wij
                    if not locked[j]:
                        ver[j] += 1
                        push(j)
                if len(move_log) - best_idx > stall:
                    break

            # Roll back to the best prefix (the FM contract: a pass never ends
            # worse than it started; best_idx == 0 undoes the whole climb).
            attempted = len(move_log)
            for i, src, tgt, _g in reversed(move_log[best_idx:]):
                parts_l[i] = src
                part_w[src] += w_l[i]
                part_w[tgt] -= w_l[i]
                part_n[src] += 1
                part_n[tgt] -= 1
            if pos is None:
                parts_np = np.asarray(parts_l, dtype=np.int64)
            else:
                parts_np[cand] = parts_l
            kstats.passes += 1
            kstats.moves_attempted += attempted
            kstats.moves_kept += best_idx
            kstats.rolled_back += attempted - best_idx
            kstats.records.append(KwayPassRecord(
                pass_no=pass_no, attempted=attempted, best_prefix=best_idx,
                rolled_back=attempted - best_idx,
                cut_before=cut, cut_after=best_cut))
            stats.moves_applied += best_idx
            improved = cut - best_cut
            cut = best_cut
            if best_idx == 0 or improved <= _EPS:
                break

        stats.cut_after = edge_cut(graph, parts_np)
    stats.seconds = t.seconds
    obs.counter_add("fm_passes", kstats.passes)
    obs.counter_add("fm_moves_attempted", kstats.moves_attempted)
    obs.counter_add("fm_moves", kstats.moves_kept)
    obs.counter_add("fm_rollbacks", kstats.rolled_back)
    return parts_np, stats


def kway_fm_boundary(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    passes: int = 2,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
    stall: int = 32,
) -> tuple[np.ndarray, PostStats]:
    """Boundary-restricted hill-climbing FM — the multilevel V-cycle's
    per-level refinement.  Each pass recomputes the boundary frontier
    (nodes with at least one cut edge) and runs ONE :func:`kway_fm` pass
    restricted to it (``nodes=``), so per-pass cost is
    O(boundary · (degree + nparts)) instead of O(n · nparts): on a freshly
    prolonged partition the boundary is a thin shell of the graph.  The
    ``stall`` default is deliberately tight (32, vs ``kway_fm``'s n//8):
    this sweep runs at EVERY ladder level, so each one must stay cheap —
    deep climbs belong to the final post chain, not the ladder."""
    parts = np.asarray(parts, dtype=np.int64).copy()
    if corridor is None:
        corridor = balance_corridor(parts, nparts, weights, balance_tol)
    agg = PostStats(stages=["kway"], corridor=tuple(corridor),
                    kway=KwayStats(), cut_before=edge_cut(graph, parts))
    rows, cols = graph.rows, graph.indices
    for _ in range(passes):
        boundary = rows[parts[rows] != parts[cols]]
        if boundary.size == 0:
            break
        parts, st = kway_fm(graph, parts, nparts, weights=weights,
                            passes=1, corridor=corridor, stall=stall,
                            nodes=boundary)
        k = st.kway
        for rec in k.records:
            rec.pass_no = len(agg.kway.records)
            agg.kway.records.append(rec)
        agg.kway.passes += k.passes
        agg.kway.moves_attempted += k.moves_attempted
        agg.kway.moves_kept += k.moves_kept
        agg.kway.rolled_back += k.rolled_back
        agg.moves_applied += st.moves_applied
        agg.seconds += st.seconds
        if st.moves_applied == 0:
            break
    agg.cut_after = edge_cut(graph, parts)
    return parts, agg


def kway_stage(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    passes: int = 8,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
    stall: int | None = None,
) -> tuple[np.ndarray, PostStats]:
    """The pipeline's "kway" stage: hill-climbing FM passes + a closing
    repair pass (articulation moves cannot leave a disconnected part).
    Both are cut-non-increasing under ONE corridor, so the stage is too."""
    if corridor is None:
        corridor = balance_corridor(parts, nparts, weights, balance_tol)
    parts, stats = kway_fm(graph, parts, nparts, weights=weights,
                           passes=passes, balance_tol=balance_tol,
                           corridor=corridor, stall=stall)
    return close_with_repair(graph, parts, nparts, stats, weights=weights,
                             balance_tol=balance_tol, corridor=corridor)
