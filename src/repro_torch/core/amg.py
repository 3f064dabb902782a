"""Aggregation-based AMG preconditioner (paper §7, Algorithm 3), in PyTorch.

The port of `repro.core.amg`: a V-cycle over Galerkin coarse operators
``L_{l+1} = J_l^{l+1} L_l J_{l+1}^l`` with piecewise-constant prolongation
over pairs of consecutive nodes (``i → i // 2``; callers feed RCB-ordered
graphs), damped-Jacobi smoothing (σ D⁻¹) and a dense pseudo-inverse at the
coarsest level (≤ ``coarse_size`` rows).  Every coarse operator is again a
graph Laplacian, stored as the port's `EllLaplacian`.

The hierarchy is built on the host in NumPy, bit-identical to `repro`'s
(:func:`coarsen_graph` is also the cascadic warm start's coarsening); each
level operator and each coarsest pinv is copied to the device once.  Two
forms share the math:

* `AMG` (`amg_setup`) — one graph, ragged per-level sizes; 2-D level
  operators (K1 on the card); restriction is an `index_add_` over the
  aggregation map (`jax.ops.segment_sum` in `repro`), prolongation an
  `index_select`.
* `BatchedAMG` (`amg_setup_batched`) — B graphs padded to a shared
  power-of-two ladder (n_pad, n_pad/2, …); each level one batched
  operator (K2 on the card).  The pairwise map is the same for every
  problem and level, so restriction is a reshape-sum and prolongation a
  ``repeat_interleave(2, -1)``.  Padding rows carry zero operator rows;
  batch-padding problems are all-zero operators with a zero pinv.

`heavy_edge_matching` is the multilevel V-cycle's coarsening
(`core/multilevel.py`), host NumPy and bit-identical to `repro`'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.laplacian import (
    EllLaplacian,
    dense_laplacian_np,
    ell_laplacian,
    ell_laplacian_batched,
)
from repro_torch.device import resolve_device
from repro_torch.mesh.graphs import Graph, build_csr


def coarsen_graph(graph: Graph, agg: np.ndarray, n_coarse: int,
                  *, node_weights: np.ndarray | None = None):
    """Galerkin coarse graph: weights between aggregates are summed.

    Edges whose endpoints land in ONE aggregate become self-loops and are
    dropped (``build_csr`` filters ``src == dst``), so the coarse total
    edge weight is the fine total minus the absorbed intra-aggregate
    weight — never more.  When ``node_weights`` is given, aggregate node
    weights are accumulated and ``(coarse_graph, coarse_weights)`` is
    returned; the node-weight sum is conserved exactly level to level.
    """
    rows = graph.rows
    coarse = build_csr(
        agg[rows], agg[graph.indices], n_coarse,
        weights=graph.weights, symmetrize=False,
    )
    if node_weights is None:
        return coarse
    w_c = np.bincount(agg, weights=np.asarray(node_weights, np.float64),
                      minlength=n_coarse)
    return coarse, w_c


def heavy_edge_matching(graph: Graph, *, node_weights: np.ndarray | None = None,
                        max_weight: float | None = None, seed: int = 0,
                        rounds: int = 4) -> tuple[np.ndarray, int]:
    """Vectorized heavy-edge matching: a fine→coarse aggregation map.

    Generalizes ``amg_setup``'s order-dependent pairwise map (``i → i//2``
    in RCB order) into a weight-aware matching with no ordering
    prerequisite: each round, every unmatched node proposes to its
    heaviest unmatched neighbor, and mutual proposals ``i ↔ j`` become a
    two-node aggregate.  Ties break by a per-round random priority
    (deterministic in ``seed``) — with deterministic tie-breaks a
    uniform-weight mesh degenerates to O(1) matched pairs per round,
    because every proposal chain points the same way and almost none are
    mutual.  A few rounds leave only nodes with no unmatched neighbor;
    those stay singletons.

    ``max_weight`` (with ``node_weights``) caps the combined weight of a
    matched pair — the balance guard: without it, deep ladders grow coarse
    nodes as heavy as an entire part, and no downstream refinement can fix
    a partition whose granularity is one-node-per-part.  Pairs that would
    exceed the cap simply stay unmatched and coarsen no further (the
    ladder's ``min_coarsen_ratio`` stop condition fires once most nodes
    sit at the cap).

    Returns ``(agg, n_coarse)`` with aggregate sizes ≤ 2 — each coarsening
    step roughly halves the graph, the standard multilevel ladder step
    (Karypis & Kumar's HEM).  Coarse ids are assigned in fine-node order
    of each aggregate's smallest member, keeping the map deterministic.
    """
    n = graph.n
    rows, cols, w = graph.rows, graph.indices, graph.weights
    rng = np.random.default_rng(seed)
    mate = np.full(n, -1, dtype=np.int64)
    node_ids = np.arange(n, dtype=np.int64)
    fits = None
    if max_weight is not None and node_weights is not None:
        nw = np.asarray(node_weights, np.float64)
        fits = nw[rows] + nw[cols] <= max_weight

    # Per-row argmax via a segmented maximum (np.maximum.at), not a sort:
    # O(E) per round instead of the O(E log E) lexsort that dominated HEM
    # wall time on fine levels.  The random per-node priority folds into a
    # multiplicative jitter on the edge weight — it breaks exact-weight
    # ties (the degenerate uniform-mesh case) while perturbing genuinely
    # distinct weights by ≤1e-9 relative, far below anything that matters
    # to matching quality.  The jitter is fixed across rounds, which can
    # (rarely) leave a round with live edges but zero mutual proposals —
    # cyclic preferences — so a matchless round re-rolls the priorities.
    def roll_key():
        pri = rng.random(n)
        return w * (1.0 + 1e-9 * pri[cols])

    key = roll_key()
    for _ in range(rounds):
        free = mate < 0
        live = free[rows] & free[cols]
        if fits is not None:
            live &= fits
        if not live.any():
            break
        er, ec, ek = rows[live], cols[live], key[live]
        best = np.full(n, -np.inf)
        np.maximum.at(best, er, ek)
        win = ek == best[er]
        head = np.full(n, -1, dtype=np.int64)
        head[er[win]] = ec[win]
        # Mutual-proposal handshake: i matches j iff head[i]=j, head[j]=i.
        prop = np.flatnonzero(head >= 0)
        mutual = prop[head[head[prop]] == prop]
        lo = mutual[mutual < head[mutual]]
        if lo.size == 0:
            key = roll_key()
            continue
        mate[lo] = head[lo]
        mate[head[lo]] = lo
    owner = np.minimum(node_ids, np.where(mate >= 0, mate, node_ids))
    reps = np.flatnonzero(owner == node_ids)
    coarse_id = np.full(n, -1, dtype=np.int64)
    coarse_id[reps] = np.arange(reps.size, dtype=np.int64)
    return coarse_id[owner], int(reps.size)


def _inv_diag(L: EllLaplacian) -> torch.Tensor:
    return torch.where(L.diag > 0, 1.0 / torch.clamp(L.diag, min=1e-30), 0.0)


def _pinv_np(graph: Graph, nc: int) -> np.ndarray:
    """Dense pseudo-inverse of the coarsest Laplacian, zero-padded to nc
    rows (singular on the constants, hence pinv)."""
    Lc = np.zeros((nc, nc), dtype=np.float64)
    Lc[: graph.n, : graph.n] = dense_laplacian_np(graph)
    return np.linalg.pinv(Lc, rcond=1e-10).astype(np.float32)


@dataclasses.dataclass(frozen=True, eq=False)
class _VCycle:
    """Algorithm 3's V-cycle; call as ``pre(r) -> u ≈ L⁻¹ r``.  Subclasses
    say how a residual moves between levels and how the coarsest level is
    solved."""

    ops: tuple              # per-level EllLaplacian (level 0 = finest)
    inv_diags: tuple        # per-level D⁻¹ (0 on empty rows), set up once
    sizes: tuple            # per-level row counts
    coarse_pinv: torch.Tensor
    sigma: float
    n_smooth: int

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r)

    def _cycle(self, lvl: int, r: torch.Tensor) -> torch.Tensor:
        if lvl == len(self.ops):
            return self._coarse_solve(r)
        L, inv_d = self.ops[lvl], self.inv_diags[lvl]
        # Alg. 3 lines 1–7: u = σDr; r = r − Lu; n_smooth more sweeps.
        u = self.sigma * r * inv_d
        rr = r - L.apply(u)
        for _ in range(self.n_smooth):
            du = self.sigma * rr * inv_d
            u = u + du
            rr = rr - L.apply(du)
        # Restrict (Jᵀ), recurse, prolong (J).
        u = u + self._prolong(lvl, self._cycle(lvl + 1, self._restrict(lvl, rr)))
        # Alg. 3 lines 12–15: post-smooth against the true residual (the
        # residual after the last sweep is never read, so it is not formed).
        for _ in range(self.n_smooth):
            u = u + self.sigma * (r - L.apply(u)) * inv_d
        return u


@dataclasses.dataclass(frozen=True, eq=False)
class AMG(_VCycle):
    """V-cycle preconditioner for one graph, r of shape (n,)."""

    aggs: tuple             # per-level (n_l,) int64 fine→coarse maps

    def _coarse_solve(self, r):
        return self.coarse_pinv @ r

    def _restrict(self, lvl, rr):    # sum over aggregates
        rc = torch.zeros(self.sizes[lvl + 1], dtype=rr.dtype, device=rr.device)
        return rc.index_add_(0, self.aggs[lvl], rr)

    def _prolong(self, lvl, ec):     # copy to the members
        return torch.index_select(ec, 0, self.aggs[lvl])


@dataclasses.dataclass(frozen=True, eq=False)
class BatchedAMG(_VCycle):
    """Leading-batch-dim V-cycle for r of shape (B, n_pad): B independent
    problems in one pass per level; ``ops`` are batched (B, w_l, n_l)
    operators over padded sizes n_pad >> l, ``coarse_pinv`` is (B, nc, nc).
    The pairwise aggregation i → i//2 is shared by every problem and level,
    so restriction is a reshape-sum and prolongation a repeat."""

    def _coarse_solve(self, r):
        return torch.bmm(self.coarse_pinv, r[..., None])[..., 0]

    def _restrict(self, lvl, rr):
        return rr.reshape(rr.shape[0], self.sizes[lvl + 1], 2).sum(-1)

    def _prolong(self, lvl, ec):
        return ec.repeat_interleave(2, dim=-1)


def amg_setup(
    graph: Graph,
    *,
    order: np.ndarray | None = None,
    coarse_size: int = 16,
    sigma: float = 2.0 / 3.0,
    n_smooth: int = 1,
    max_levels: int = 64,
    device=None,
    use_kernel: bool = True,
) -> AMG:
    """Build the level hierarchy on the host and copy it to ``device``.

    order: RCB ordering of the fine nodes (paper's bootstrap).  Identity if
    omitted (degrades quality, still converges).
    """
    dev = resolve_device(device)
    n = graph.n
    perm = np.arange(n, dtype=np.int64) if order is None else np.asarray(order)
    rank = np.empty(n, dtype=np.int64)
    rank[perm] = np.arange(n)

    ops: list[EllLaplacian] = []
    aggs: list[np.ndarray] = []
    sizes: list[int] = [n]
    g = graph
    # Level-0 aggregation pairs RCB-consecutive nodes; coarser levels are
    # already RCB-ordered by construction (J = I₂ ⊗ J_prev).
    agg_of_fine = rank // 2
    lvl = 0
    while g.n > coarse_size and lvl < max_levels:
        n_c = (g.n + 1) // 2
        agg = agg_of_fine if lvl == 0 else np.arange(g.n, dtype=np.int64) // 2
        ops.append(ell_laplacian(g, device=dev, use_kernel=use_kernel))
        aggs.append(agg)
        g = coarsen_graph(g, agg, n_c)
        sizes.append(n_c)
        lvl += 1

    pinv = np.linalg.pinv(dense_laplacian_np(g), rcond=1e-10)
    return AMG(
        ops=tuple(ops),
        inv_diags=tuple(_inv_diag(L) for L in ops),
        aggs=tuple(torch.from_numpy(a.astype(np.int64)).to(dev) for a in aggs),
        sizes=tuple(sizes),
        coarse_pinv=torch.from_numpy(pinv.astype(np.float32)).to(dev),
        sigma=sigma,
        n_smooth=n_smooth,
    )


def amg_setup_batched(
    graphs: list,
    n_pad: int,
    b_pad: int,
    *,
    coarse_size: int = 16,
    sigma: float = 2.0 / 3.0,
    n_smooth: int = 1,
    device=None,
    use_kernel: bool = True,
) -> BatchedAMG:
    """Build one packed V-cycle hierarchy for B graphs (host NumPy) and copy
    it to ``device``.

    `n_pad` (a power of two ≥ every graph's n) fixes the shared level
    ladder n_pad, n_pad/2, … down to `coarse_size`; each graph is
    Galerkin-coarsened along it with the pairwise aggregation `amg_setup`
    uses (feed RCB-ordered graphs, as the engine does).
    """
    if n_pad & (n_pad - 1):
        raise ValueError(f"n_pad must be a power of two, got {n_pad}")
    if any(g.n > n_pad for g in graphs):
        raise ValueError("n_pad below a graph size")
    dev = resolve_device(device)
    level_graphs: list[list[Graph]] = [list(graphs)]
    sizes = [n_pad]
    while sizes[-1] > coarse_size:
        nxt = [
            coarsen_graph(g, np.arange(g.n, dtype=np.int64) // 2, (g.n + 1) // 2)
            for g in level_graphs[-1]
        ]
        level_graphs.append(nxt)
        sizes.append(sizes[-1] // 2)

    ops = []
    for lvl in range(len(sizes) - 1):
        gs = level_graphs[lvl]
        width = max([int(g.degrees.max()) if g.nnz else 1 for g in gs] + [1])
        width_pad = 1 << max(0, (max(width, 2) - 1)).bit_length()
        ops.append(ell_laplacian_batched(gs, sizes[lvl], width_pad, b_pad,
                                         device=dev, use_kernel=use_kernel))

    nc = sizes[-1]
    pinv = np.zeros((b_pad, nc, nc), dtype=np.float32)
    for b, g in enumerate(level_graphs[-1]):
        pinv[b] = _pinv_np(g, nc)
    return BatchedAMG(
        ops=tuple(ops),
        inv_diags=tuple(_inv_diag(L) for L in ops),
        sizes=tuple(sizes),
        coarse_pinv=torch.from_numpy(pinv).to(dev),
        sigma=sigma,
        n_smooth=n_smooth,
    )
