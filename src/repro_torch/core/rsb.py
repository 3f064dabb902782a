"""Recursive Spectral Bisection driver (paper Algorithm 1).

Two engines, as in `repro.core.rsb`, sharing the same math.

**engine="batched"** (default) — the level-synchronous engine: all 2^L
subdomains at level L of the bisection tree are independent, so each level

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

**engine="recursive"** — the host-side depth-first recursion, one solve
per tree node: the reference engine.  On a mesh (`_rsb_mesh_recursive`)
each node solves on the matrix-free gather-scatter Laplacian of its
sub-mesh (`fiedler_from_mesh`, paper §5): Lanczos with no kernel, inverse
iteration with the per-graph `AMG` of the node's assembled dual graph,
whose levels run K1.  On a graph (`_rsb_graph_recursive`) each node
solves through `fiedler_from_graph`, K1 on every matvec.

Per-node start vectors are seeded from (seed, level, p_lo) as in `repro`.
``use_kernel`` defaults to **True** (the JAX engine leaves its Pallas
kernels off): on the card every assembled matvec runs a CUDA ELL SpMV (K1
flat, K2 batched).  Spans as in `repro`: ``engine``, ``solve`` and
``split`` in both engines, the batched engine's ``solve`` and ``split``
under one ``level:<N>`` span per tree level.

``guard`` (a :class:`~repro_torch.guard.policy.GuardPolicy`, passed by a
guarded pipeline) re-admits every node's result through a
:class:`~repro_torch.guard.policy.SolverGuard`, as `repro` does: a failed
solve re-solves alone through `fiedler_from_graph` on the same device
(retry, then the other method), and falls back to a geometric or index
vector last; past the guard's deadline a node skips its solve and takes
the fallback.  The recursive engines also catch their primary solve's
error, as `repro`'s do, under the same rule: an exception raised on the
card raises out of the engine (`~repro_torch.guard.policy.absorbable`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.fiedler import (
    _DENSE_CUTOFF,
    _graph_from_vert_gid,
    check_fiedler_method,
    fiedler_from_graph,
    fiedler_from_graph_batched,
    fiedler_from_mesh,
    next_pow2,
)
from repro_torch.core.rcb import rcb_order, rib_order
from repro_torch.device import resolve_device
from repro_torch.guard.policy import SolverGuard, absorbable
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
    breakdown: bool = False      # solver breakdown (or guard fallback) here
    # The recursive engines' own solve: its device part and its flexcg
    # iterations (0 in the batched engine, whose LevelRecord has them).
    device_seconds: float = 0.0
    inner_iterations: int = 0

    def to_dict(self) -> dict:
        """`repro`'s fields (the port's own timings are left out)."""
        return _repro_fields(self, _PORT_RECORD_FIELDS)


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

    def to_dict(self) -> dict:
        """`repro`'s fields (the port's own timings are left out)."""
        return _repro_fields(self, _PORT_LEVEL_FIELDS)


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
    ml: object = None          # multilevel.MultilevelStats (V-cycle bisect)
    guard: object = None       # guard.GuardReport: what degraded and why

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

    def to_dict(self) -> dict:
        """JSON-able form, with `repro`'s keys — the one the benchmark rows
        and run manifests serialize instead of re-extracting fields."""
        return {
            "engine": self.engine,
            "pre": self.pre,
            "precond": self.precond,
            "multilevel": self.multilevel,
            "seconds": self.seconds,
            "total_iterations": self.total_iterations,
            "precond_levels": self.precond_levels,
            "records": [r.to_dict() for r in self.records],
            "levels": [lv.to_dict() for lv in self.levels],
            "post": self.post.to_dict() if self.post is not None else None,
            "ml": self.ml.to_dict() if self.ml is not None else None,
            "guard": self.guard.to_dict() if self.guard is not None else None,
        }


# The fields the port's records add to `repro`'s; `to_dict` leaves them
# out, so a serialized report has `repro`'s keys.
_PORT_RECORD_FIELDS = ("device_seconds", "inner_iterations")
_PORT_LEVEL_FIELDS = ("device_seconds", "order_seconds", "inner_iterations")


def _repro_fields(record, port_fields) -> dict:
    return {k: v for k, v in dataclasses.asdict(record).items()
            if k not in port_fields}


def _node_seed(seed: int, level: int, p_lo: int, attempt: int = 0) -> int:
    """Deterministic per-node seed from (seed, level, p_lo): siblings never
    share a start vector; ``attempt`` decorrelates guard retries (0 leaves
    the node's seed as it is).  The same hash as
    `repro.core.rsb._node_seed`."""
    h = (seed * 0x9E3779B1 + level * 0x85EBCA77 + p_lo * 0xC2B2AE3D
         + attempt * 0x27D4EB2F) & 0x7FFFFFFF
    return int(h)


def _guarded(sg: SolverGuard | None, res, solve_fn, *, level: int,
             p_lo: int, size: int, coords_sub=None):
    """Admit one solve through the guard (no-op when unguarded).
    ``res`` may be None when the primary solve was skipped."""
    if sg is None:
        return res
    res2, why = sg.admit(res, level=level, p_lo=p_lo, size=size)
    if why is None:
        return res2
    return sg.rescue(solve_fn, why, level=level, p_lo=p_lo, size=size,
                     coords=coords_sub)


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


def _levels_from_records(records: list) -> list:
    """Aggregate per-node records into per-level records (recursive
    engines)."""
    by_level: dict = {}
    for r in records:
        by_level.setdefault(r.level, []).append(r)
    out = []
    for level in sorted(by_level):
        rs = by_level[level]
        out.append(LevelRecord(
            level=level,
            n_nodes=len(rs),
            total_size=sum(r.size for r in rs),
            buckets=_size_buckets([r.size for r in rs]),
            iterations=sum(r.iterations for r in rs),
            solve_seconds=sum(r.seconds for r in rs),
            split_seconds=sum(r.split_seconds for r in rs),
            device_seconds=sum(r.device_seconds for r in rs),
            inner_iterations=sum(r.inner_iterations for r in rs),
        ))
    return out


def _check_method(method: str, engine: str) -> None:
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine: {engine}")
    check_fiedler_method(method)


def _primary_solve(sg: SolverGuard | None, solve_fn, method: str, seed: int,
                   device):
    """A recursive node's first solve: unguarded it runs (and raises) as
    is; guarded it is skipped past the deadline (the rescue takes the
    fallback rung), and an error it raises becomes a failed solve where
    :func:`~repro_torch.guard.policy.absorbable`."""
    if sg is None:
        return solve_fn(method, seed)
    if sg.expired():
        return None
    try:
        return solve_fn(method, seed)
    except Exception as exc:
        if not absorbable(exc, device):
            raise
        return None


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
    guard=None,
) -> tuple[np.ndarray, RSBReport]:
    """Partition a HexMesh into ``nparts`` via RSB on its dual graph.

    ``engine="batched"`` assembles the weighted dual graph and runs the
    batched graph engine on it; ``engine="recursive"`` solves every node
    on the matrix-free gather-scatter Laplacian of its sub-mesh (inverse
    iteration: always with the node's own `AMG`, whatever ``precond``).
    ``laplacian`` is validated only, as in `repro`: both settings
    partition the shared-vertex-weighted dual graph."""
    if laplacian not in ("weighted", "unweighted"):
        raise ValueError(laplacian)
    _check_method(method, engine)
    if engine == "batched":
        graph = dual_graph_from_incidence(mesh.vert_gid, mesh.n_vert,
                                          mesh.nelems)
        return rsb_partition_graph(
            graph, nparts, coords=mesh.coords, weights=mesh.weights,
            method=method, pre=pre, tol=tol, window=window,
            max_restarts=max_restarts, seed=seed, warm_start=warm_start,
            use_kernel=use_kernel, engine=engine, multilevel=multilevel,
            fine_restarts=fine_restarts, precond=precond, device=device,
            guard=guard,
        )
    window, max_restarts = _resolve_solver_opts(
        window, max_restarts, multilevel, fine_restarts,
        ordered=pre in ("rcb", "rib") and not warm_start,
    )
    return _rsb_mesh_recursive(
        mesh, nparts, method=method, pre=pre, tol=tol, window=window,
        max_restarts=max_restarts, seed=seed, warm_start=warm_start,
        multilevel=multilevel, use_kernel=use_kernel,
        device=resolve_device(device), guard=guard)


def _rsb_mesh_recursive(
    mesh, nparts, *, method, pre, tol, window, max_restarts, seed, warm_start,
    multilevel, use_kernel, device, guard=None,
) -> tuple[np.ndarray, RSBReport]:
    records: list[BisectionRecord] = []
    parts = np.zeros(mesh.nelems, dtype=np.int64)
    sg = (SolverGuard(guard, seed=seed, method=method, device=device)
          if guard is not None and guard.enabled else None)

    def rec(idx: np.ndarray, p_lo: int, p_hi: int, level: int) -> None:
        np_here = p_hi - p_lo
        if np_here <= 1 or idx.size <= 1:
            parts[idx] = p_lo
            return
        # Geometric pre-partitioning: make active data locally contiguous.
        if pre in ("rcb", "rib"):
            fn = rcb_order if pre == "rcb" else rib_order
            idx = idx[fn(mesh.coords[idx], mesh.weights[idx])]

        sub_vg = mesh.vert_gid[idx]
        warm = _warm_vector(mesh.coords[idx]) if warm_start else None
        amg_cache: dict = {}

        def solve_fn(m, s, _sub_vg=sub_vg, _size=int(idx.size)):
            graph_amg = order_amg = None
            if m == "inverse":
                if "g" not in amg_cache:
                    amg_cache["g"] = _graph_from_vert_gid(_sub_vg)
                graph_amg = amg_cache["g"]
                order_amg = np.arange(_size)  # already RCB-ordered above
            return fiedler_from_mesh(
                _sub_vg, method=m, graph_for_amg=graph_amg, order=order_amg,
                seed=s, tol=tol, window=window, max_restarts=max_restarts,
                warm=warm, multilevel=multilevel, use_kernel=use_kernel,
                device=device,
            )

        with obs.timed("solve", level=level, n=int(idx.size)) as t_solve:
            res = _primary_solve(sg, solve_fn, method,
                                 _node_seed(seed, level, p_lo), device)
            res = _guarded(sg, res, solve_fn, level=level, p_lo=p_lo,
                           size=int(idx.size), coords_sub=mesh.coords[idx])
        n_left = np_here // 2
        with obs.timed("split", level=level) as t_split:
            lo, hi = _proportional_split(
                res.vector, mesh.weights[idx], n_left, np_here)
            idx_lo, idx_hi = idx[lo], idx[hi]
        records.append(_node_record(res, level, int(idx.size), np_here,
                                    t_solve.seconds, t_split.seconds))
        rec(idx_lo, p_lo, p_lo + n_left, level + 1)
        rec(idx_hi, p_lo + n_left, p_hi, level + 1)

    with obs.timed("engine", engine="recursive") as t_total:
        rec(np.arange(mesh.nelems, dtype=np.int64), 0, nparts, 0)
    return parts, RSBReport(
        records=records, seconds=t_total.seconds,
        levels=_levels_from_records(records), engine="recursive",
        pre=pre or "none", precond="amg" if method == "inverse" else "none",
        multilevel=multilevel, guard=sg.report if sg is not None else None,
    )


def _node_record(res, level: int, size: int, nparts: int, seconds: float,
                 split_seconds: float) -> BisectionRecord:
    """One recursive-engine node's record."""
    return BisectionRecord(
        level=level, size=size, nparts=nparts, method=res.method,
        iterations=res.iterations, eigenvalue=res.eigenvalue,
        residual=res.residual, seconds=seconds, levels=res.levels,
        split_seconds=split_seconds, breakdown=res.breakdown,
        device_seconds=res.device_seconds,
        inner_iterations=res.inner_iterations,
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
    guard=None,
) -> tuple[np.ndarray, RSBReport]:
    """Partition a generic graph (assembled ELL Laplacian) via RSB.

    ``pre`` selects the geometric pre-ordering ("rcb"/"rib"/None — a no-op
    without ``coords``); ``multilevel``/``fine_restarts``/``window`` set the
    coarse-to-fine solver schedule; ``warm_start=True`` seeds each node
    from its coordinates instead.  ``device`` (default: the card) is where
    the packed solves run.  ``guard``: a ``GuardPolicy`` (module docstring)
    or None.
    """
    _check_method(method, engine)
    dev = resolve_device(device)
    window, max_restarts = _resolve_solver_opts(
        window, max_restarts, multilevel, fine_restarts,
        ordered=(pre in ("rcb", "rib") and coords is not None
                 and not warm_start),
    )
    kw = dict(coords=coords, weights=weights, method=method, pre=pre,
              tol=tol, window=window, max_restarts=max_restarts, seed=seed,
              warm_start=warm_start, use_kernel=use_kernel,
              multilevel=multilevel, device=dev, guard=guard)
    if engine == "batched":
        return _rsb_graph_batched(graph, nparts, precond=precond, **kw)
    return _rsb_graph_recursive(graph, nparts, **kw)


def _rsb_graph_recursive(
    graph, nparts, *, coords, weights, method, pre, tol, window, max_restarts,
    seed, warm_start, use_kernel, multilevel, device, guard=None,
) -> tuple[np.ndarray, RSBReport]:
    n = graph.n
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    records: list[BisectionRecord] = []
    parts = np.zeros(n, dtype=np.int64)
    sg = (SolverGuard(guard, seed=seed, method=method, device=device)
          if guard is not None and guard.enabled else None)

    def rec(g: Graph, idx: np.ndarray, p_lo: int, p_hi: int,
            level: int) -> None:
        np_here = p_hi - p_lo
        if np_here <= 1 or idx.size <= 1:
            parts[idx] = p_lo
            return
        if pre in ("rcb", "rib") and coords is not None:
            fn = rcb_order if pre == "rcb" else rib_order
            perm = fn(coords[idx], w[idx])
            idx = idx[perm]
            g = g.sub(perm)
        warm = None
        if warm_start and coords is not None:
            warm = _warm_vector(coords[idx])

        def solve_fn(m, s, _g=g):
            return fiedler_from_graph(
                _g, method=m, order=None, seed=s, warm=warm, tol=tol,
                window=window, max_restarts=max_restarts,
                use_kernel=use_kernel, multilevel=multilevel, device=device,
            )

        with obs.timed("solve", level=level, n=int(idx.size)) as t_solve:
            res = _primary_solve(sg, solve_fn, method,
                                 _node_seed(seed, level, p_lo), device)
            res = _guarded(
                sg, res, solve_fn, level=level, p_lo=p_lo,
                size=int(idx.size),
                coords_sub=coords[idx] if coords is not None else None)
        n_left = np_here // 2
        with obs.timed("split", level=level) as t_split:
            lo, hi = _proportional_split(res.vector, w[idx], n_left, np_here)
            g_lo, g_hi = g.sub(lo), g.sub(hi)
            idx_lo, idx_hi = idx[lo], idx[hi]
        records.append(_node_record(res, level, int(idx.size), np_here,
                                    t_solve.seconds, t_split.seconds))
        rec(g_lo, idx_lo, p_lo, p_lo + n_left, level + 1)
        rec(g_hi, idx_hi, p_lo + n_left, p_hi, level + 1)

    with obs.timed("engine", engine="recursive") as t_total:
        rec(graph, np.arange(n, dtype=np.int64), 0, nparts, 0)
    return parts, RSBReport(
        records=records, seconds=t_total.seconds,
        levels=_levels_from_records(records), engine="recursive",
        pre=pre or "none", precond="amg" if method == "inverse" else "none",
        multilevel=multilevel, guard=sg.report if sg is not None else None,
    )


def _rsb_graph_batched(
    graph, nparts, *, coords, weights, method, pre, tol, window, max_restarts,
    seed, warm_start, use_kernel, multilevel, precond, device, guard=None,
) -> tuple[np.ndarray, RSBReport]:
    n = graph.n
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    records: list[BisectionRecord] = []
    levels: list[LevelRecord] = []
    parts = np.zeros(n, dtype=np.int64)
    sg = (SolverGuard(guard, seed=seed, method=method, device=device)
          if guard is not None and guard.enabled else None)
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
            with obs.stopwatch() as t_order:
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

            with obs.span(f"level:{level}", nodes=len(solve_nodes)):
                with obs.timed("solve", level=level) as t_solve:
                    if sg is not None and sg.expired():
                        # Past the stage deadline: skip the level solve and
                        # let every node take the fallback rung below.
                        results = [None] * len(solve_nodes)
                    else:
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
                            multilevel=multilevel, precond=precond,
                            device=device,
                        )
                if sg is not None:
                    # Re-admit every node's result; failed ones re-solve
                    # individually through the escalation ladder.
                    rescued = []
                    for (g, idx, p_lo, p_hi), res in zip(solve_nodes, results):
                        def solve_fn(m, s, _g=g):
                            return fiedler_from_graph(
                                _g, method=m, order=None, seed=s, tol=tol,
                                window=window, max_restarts=max_restarts,
                                use_kernel=use_kernel, multilevel=multilevel,
                                device=device,
                            )
                        rescued.append(_guarded(
                            sg, res, solve_fn, level=level, p_lo=p_lo,
                            size=int(idx.size),
                            coords_sub=coords[idx] if coords is not None
                            else None))
                    results = rescued
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
        multilevel=multilevel, guard=sg.report if sg is not None else None,
    )


def partition(obj, nparts: int, **kw) -> np.ndarray:
    """Uniform front door: partitioner ∈ {rsb, rsb_inverse, multilevel,
    rcb, rib, sfc, random}; `repro`'s compatibility wrapper over the stage
    pipeline — see :func:`repro_torch.core.pipeline.partition` for the
    whole surface (``refine=`` post stages, per-stage keyword routing,
    ``device=``: the card unless the CPU is asked for) and
    :class:`repro_torch.core.pipeline.PartitionPipeline` for the report
    and timings."""
    from repro_torch.core.pipeline import partition as _pipeline_partition

    return _pipeline_partition(obj, nparts, **kw)
