"""Recursive Spectral Bisection driver (paper Algorithm 1), batched engine.

The level-synchronous engine of `repro.core.rsb`: all 2^L subdomains at
level L of the bisection tree are independent, so each level

  1. reorders every active node's elements by RCB/RIB (paper §8, host
     NumPy),
  2. solves every active subproblem's Fiedler vector on the device
     (`fiedler_from_graph_batched`), seeded by the cascadic coarse-to-fine
     warm start (host NumPy): ``method="lanczos"`` in ONE packed Lanczos
     solve capped at ``fine_restarts`` refinement restarts over a 20-step
     window (`_resolve_solver_opts`), ``method="inverse"`` by inverse
     iteration over shape buckets with the ``precond`` ("jacobi" or
     "amg") inner preconditioner,
  3. splits each node by weight (`_proportional_split`: sort by Fiedler
     component, cut at ⌊P/2⌋ / ⌈P/2⌉ of the weight) and extracts the
     children's subgraphs in one vectorized pass.

Per-node start vectors are seeded from (seed, level, p_lo) as in `repro`.
``use_kernel`` defaults to **True** (the JAX engine leaves its Pallas
kernels off): on the card every matvec runs a CUDA ELL SpMV (K1 packed,
K2 batched).  The recursive engine and the guard hooks are not yet
ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.fiedler import (
    _DENSE_CUTOFF,
    check_fiedler_method,
    fiedler_from_graph_batched,
    next_pow2,
)
from repro_torch.core.rcb import rcb_order, rib_order
from repro_torch.device import resolve_device
from repro_torch.mesh.graphs import Graph, dual_graph_from_incidence, extract_subgraphs

_ENGINES = ("batched", "recursive")


@dataclasses.dataclass
class BisectionRecord:
    level: int
    size: int
    nparts: int
    method: str
    iterations: int
    eigenvalue: float
    residual: float
    seconds: float
    levels: int = 0    # multilevel warm-start hierarchy depth; 0 = none
    split_seconds: float = 0.0   # this node's sort/split + child extraction
    breakdown: bool = False      # solver breakdown here


@dataclasses.dataclass
class LevelRecord:
    """One tree level of the engine: how many nodes were solved together,
    in which shape buckets, and where the time went."""

    level: int
    n_nodes: int             # nodes solved at this level
    total_size: int          # Σ elements over those nodes
    buckets: list            # [(count, n_pad)] — n_pad 0 = dense tail
    iterations: int          # Σ per-node restarts / outer iterations
    solve_seconds: float     # warm starts + packing + the device solve
    split_seconds: float     # sort/split + child extraction
    device_seconds: float = 0.0  # the device solve alone (incl. its copies)
    order_seconds: float = 0.0   # RCB/RIB reorder of the level's nodes
    inner_iterations: int = 0    # Σ per-node flexcg iterations (inverse)


@dataclasses.dataclass
class RSBReport:
    records: list
    seconds: float
    levels: list = dataclasses.field(default_factory=list)
    engine: str = "batched"
    pre: str = "none"          # geometric pre-partitioning used ("rcb"/"rib")
    precond: str = "none"      # inverse-iteration preconditioner ("jacobi"/"amg")
    multilevel: bool = False   # coarse-to-fine warm starts active
    post: object = None        # refine.PostStats once pipeline post stages ran

    @property
    def total_iterations(self) -> int:
        return sum(r.iterations for r in self.records)

    @property
    def device_seconds(self) -> float:
        return sum(lv.device_seconds for lv in self.levels)

    @property
    def precond_levels(self) -> int:
        """Deepest Galerkin ladder (warm start or AMG) used by any solve."""
        return max((r.levels for r in self.records), default=0)


def _node_seed(seed: int, level: int, p_lo: int, attempt: int = 0) -> int:
    """Deterministic per-node seed from (seed, level, p_lo): siblings never
    share a start vector.  The same hash as `repro.core.rsb._node_seed`."""
    h = (seed * 0x9E3779B1 + level * 0x85EBCA77 + p_lo * 0xC2B2AE3D
         + attempt * 0x27D4EB2F) & 0x7FFFFFFF
    return int(h)


def _warm_vector(c: np.ndarray) -> np.ndarray:
    """Geometric warm start: centroid coordinate along the longest axis."""
    ax = int(np.argmax(c.max(0) - c.min(0)))
    return (c[:, ax] - c[:, ax].mean()).astype(np.float32)


def _proportional_split(keys: np.ndarray, weights: np.ndarray, n_left: int,
                        n_total: int) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(keys, kind="stable")
    cw = np.cumsum(weights[order])
    target = cw[-1] * (n_left / n_total)
    k = int(np.searchsorted(cw, target, side="left")) + 1
    k = min(max(k, 1), keys.size - 1)
    return order[:k], order[k:]


def _size_buckets(sizes: list) -> list:
    """Group node sizes into the (count, n_pad) shape buckets they solve in."""
    counts: dict = {}
    for s in sizes:
        key = 0 if s <= _DENSE_CUTOFF else next_pow2(s)
        counts[key] = counts.get(key, 0) + 1
    return sorted((c, k) for k, c in counts.items())


def _resolve_solver_opts(window, max_restarts, multilevel, fine_restarts,
                         ordered):
    """Multilevel solves are *refinements* of the prolonged coarse Fiedler
    vector: a shallower Lanczos window capped at a few restarts replaces
    the deep cold-start windows, but only when the cascadic warm start is
    in play AND the geometric pre-ordering applied (``ordered``) — the
    pairwise hierarchy follows the node order.  An explicit ``window``
    always wins.  (`repro.core.rsb._resolve_solver_opts`.)"""
    if window is None:
        window = 20 if multilevel else 30
    if multilevel and ordered and fine_restarts is not None:
        max_restarts = min(max_restarts, fine_restarts)
    return window, max_restarts


def _check_method(method: str, engine: str) -> None:
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine: {engine}")
    if engine == "recursive":
        raise NotImplementedError("engine='recursive' is not yet ported")
    check_fiedler_method(method)


def rsb_partition_mesh(
    mesh,
    nparts: int,
    *,
    method: str = "lanczos",
    laplacian: str = "weighted",
    pre: str | None = "rcb",
    tol: float = 1e-3,
    window: int | None = None,
    max_restarts: int = 50,
    seed: int = 0,
    warm_start: bool = False,
    engine: str = "batched",
    multilevel: bool = True,
    fine_restarts: int | None = 3,
    precond: str = "jacobi",
    use_kernel: bool = True,
    device=None,
) -> tuple[np.ndarray, RSBReport]:
    """Partition a HexMesh into ``nparts`` via RSB on its dual graph.

    The batched engine assembles the weighted dual graph and runs the
    graph engine on it (``laplacian`` is validated only, as in `repro`)."""
    if laplacian not in ("weighted", "unweighted"):
        raise ValueError(laplacian)
    _check_method(method, engine)
    graph = dual_graph_from_incidence(mesh.vert_gid, mesh.n_vert, mesh.nelems)
    return rsb_partition_graph(
        graph, nparts, coords=mesh.coords, weights=mesh.weights,
        method=method, pre=pre, tol=tol, window=window,
        max_restarts=max_restarts, seed=seed, warm_start=warm_start,
        use_kernel=use_kernel, engine=engine, multilevel=multilevel,
        fine_restarts=fine_restarts, precond=precond, device=device,
    )


def rsb_partition_graph(
    graph: Graph,
    nparts: int,
    *,
    coords: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    method: str = "lanczos",
    pre: str | None = "rcb",
    tol: float = 1e-3,
    window: int | None = None,
    max_restarts: int = 50,
    seed: int = 0,
    warm_start: bool = False,
    use_kernel: bool = True,
    engine: str = "batched",
    multilevel: bool = True,
    fine_restarts: int | None = 3,
    precond: str = "jacobi",
    device=None,
) -> tuple[np.ndarray, RSBReport]:
    """Partition a generic graph (assembled ELL Laplacian) via RSB.

    ``pre`` selects the geometric pre-ordering ("rcb"/"rib"/None — a no-op
    without ``coords``); ``multilevel``/``fine_restarts``/``window`` set the
    coarse-to-fine solver schedule; ``warm_start=True`` seeds each node
    from its coordinates instead.  ``device`` (default: the card) is where
    the packed solves run.
    """
    _check_method(method, engine)
    dev = resolve_device(device)
    window, max_restarts = _resolve_solver_opts(
        window, max_restarts, multilevel, fine_restarts,
        ordered=(pre in ("rcb", "rib") and coords is not None
                 and not warm_start),
    )
    return _rsb_graph_batched(
        graph, nparts, coords=coords, weights=weights, method=method,
        pre=pre, tol=tol, window=window, max_restarts=max_restarts,
        seed=seed, warm_start=warm_start, use_kernel=use_kernel,
        multilevel=multilevel, precond=precond, device=dev)


def _rsb_graph_batched(
    graph, nparts, *, coords, weights, method, pre, tol, window, max_restarts,
    seed, warm_start, use_kernel, multilevel, precond, device,
) -> tuple[np.ndarray, RSBReport]:
    n = graph.n
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    records: list[BisectionRecord] = []
    levels: list[LevelRecord] = []
    parts = np.zeros(n, dtype=np.int64)
    with obs.timed("engine", engine="batched") as t_total:
        # Run-wide packing pins: subgraph degrees never exceed the root's,
        # so the root ELL width bounds every level, and a level's padded
        # blocks always fit the root's padded size.
        pack_slots = next_pow2(max(n, 2))
        pack_segs = next_pow2(max(nparts, 1))
        root_width = int(graph.degrees.max()) if graph.nnz else 1
        width_pad = next_pow2(max(root_width, 2))

        active = [(graph, np.arange(n, dtype=np.int64), 0, nparts)]
        level = 0
        while active:
            solve_nodes = []
            with obs.timed("order", level=level) as t_order:
                for g, idx, p_lo, p_hi in active:
                    if p_hi - p_lo <= 1 or idx.size <= 1:
                        parts[idx] = p_lo
                        continue
                    if pre in ("rcb", "rib") and coords is not None:
                        fn = rcb_order if pre == "rcb" else rib_order
                        perm = fn(coords[idx], w[idx])
                        idx = idx[perm]
                        g = g.sub(perm)
                    solve_nodes.append((g, idx, p_lo, p_hi))
            if not solve_nodes:
                break

            with obs.timed("solve", level=level) as t_solve:
                results = fiedler_from_graph_batched(
                    [g for g, _, _, _ in solve_nodes],
                    method=method,
                    seeds=[_node_seed(seed, level, p_lo)
                           for _, _, p_lo, _ in solve_nodes],
                    warms=[
                        _warm_vector(coords[idx])
                        if warm_start and coords is not None else None
                        for _, idx, _, _ in solve_nodes
                    ],
                    tol=tol, window=window, max_restarts=max_restarts,
                    pack_slots=pack_slots, pack_segs=pack_segs,
                    width_pad=width_pad, use_kernel=use_kernel,
                    multilevel=multilevel, precond=precond, device=device,
                )
            with obs.timed("split", level=level) as t_split:
                next_active = []
                for (g, idx, p_lo, p_hi), res in zip(solve_nodes, results):
                    np_here = p_hi - p_lo
                    records.append(BisectionRecord(
                        level=level, size=int(idx.size), nparts=np_here,
                        method=res.method, iterations=res.iterations,
                        eigenvalue=res.eigenvalue, residual=res.residual,
                        seconds=t_solve.seconds / len(solve_nodes),
                        levels=res.levels, breakdown=res.breakdown,
                    ))
                    n_left = np_here // 2
                    lo, hi = _proportional_split(
                        res.vector, w[idx], n_left, np_here)
                    g_lo, g_hi = extract_subgraphs(g, [lo, hi])
                    next_active.append((g_lo, idx[lo], p_lo, p_lo + n_left))
                    next_active.append((g_hi, idx[hi], p_lo + n_left, p_hi))
            levels.append(LevelRecord(
                level=level,
                n_nodes=len(solve_nodes),
                total_size=sum(int(idx.size) for _, idx, _, _ in solve_nodes),
                buckets=_size_buckets(
                    [int(idx.size) for _, idx, _, _ in solve_nodes]
                ),
                iterations=sum(r.iterations for r in results),
                solve_seconds=t_solve.seconds,
                split_seconds=t_split.seconds,
                device_seconds=max(r.device_seconds for r in results),
                order_seconds=t_order.seconds,
                inner_iterations=sum(r.inner_iterations for r in results),
            ))
            # Per-node split cost isn't separable in the level-synchronous
            # engine; attribute the level's split evenly.
            for r in records[-len(solve_nodes):]:
                r.split_seconds = t_split.seconds / len(solve_nodes)
            active = next_active
            level += 1

    return parts, RSBReport(
        records=records, seconds=t_total.seconds,
        levels=levels, engine="batched", pre=pre or "none",
        precond=precond if method == "inverse" else "none",
        multilevel=multilevel,
    )
