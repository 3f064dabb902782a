"""Composable partition pipeline: pre → bisect → post (unguarded).

The port of `repro.core.pipeline` without the guard envelope:

* :class:`PartitionPipeline` — three stage slots.  ``pre`` ∈ {"rcb",
  "rib", "sfc", "none"}: "rcb"/"rib" select the per-level reorder the RSB
  engine applies at every tree node, "sfc" one global space-filling-curve
  permutation up front.  ``bisect`` ∈ {"rsb-batched", "rcb", "rib", "sfc",
  "random"}.  ``post`` — an ordered tuple of {"repair", "refine", "kway",
  "refine-sharded", "kway-sharded"}, by default ("repair", "refine"), run
  under ONE balance corridor (:func:`run_post_stages`).
* :class:`PartitionContext` — what flows through the stages, with one
  :class:`StageRecord` per stage (wall seconds, and for the spectral
  bisect stage the part of them spent in device solves).
* :func:`partition` — the keyword front door, returning labels only.

``device`` (default ``None``, meaning the card) is resolved when a run
starts: without a card a run raises unless the caller asked for the CPU.
The spectral bisect stage and the sharded post stages ("refine-sharded",
"kway-sharded", whose sweeps run there) use it; the other stages are host
NumPy, bit-identical to `repro` on the same inputs.

Stage names `repro` knows but the port does not have yet (the recursive
engine, multilevel) raise NotImplementedError;
unknown names raise ValueError, as in `repro`.  ``guard=True`` raises: the
guard stages are not ported, and an unguarded run is what a healthy
guarded `repro` run returns bit for bit.
"""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np

from repro_torch import obs
from repro_torch.core.kway import kway_stage
from repro_torch.core.refine import (
    PostStats,
    balance_corridor,
    refine_stage,
    repair_components,
)
from repro_torch.core.rsb import RSBReport, rsb_partition_graph
from repro_torch.device import resolve_device
from repro_torch.mesh.graphs import Graph, dual_graph_from_incidence


@dataclasses.dataclass
class StageRecord:
    """One executed stage: where the wall-clock went and what it did."""

    kind: str          # "pre" | "bisect" | "post"
    name: str
    seconds: float
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PartitionContext:
    """State threaded through the pipeline stages."""

    nparts: int
    mesh: object | None = None          # HexMesh input (None for graphs)
    graph: Graph | None = None          # dual graph (built lazily for meshes)
    coords: np.ndarray | None = None
    weights: np.ndarray | None = None
    parts: np.ndarray | None = None     # current labels (post stages mutate)
    parts_raw: np.ndarray | None = None  # bisect output, before any post stage
    report: RSBReport | None = None
    stages: list = dataclasses.field(default_factory=list)  # [StageRecord]
    config: dict = dataclasses.field(default_factory=dict)  # pipeline shape

    @property
    def n(self) -> int:
        return self.mesh.nelems if self.mesh is not None else self.graph.n

    def require_graph(self) -> Graph:
        """The dual graph — assembled on first use for mesh inputs."""
        if self.graph is None:
            m = self.mesh
            with obs.timed("dual_graph") as t:
                self.graph = dual_graph_from_incidence(m.vert_gid, m.n_vert,
                                                       m.nelems)
            self.stages.append(StageRecord(kind="setup", name="dual_graph",
                                           seconds=t.seconds))
        return self.graph


# ---------------------------------------------------------------------------
# Stage registries
# ---------------------------------------------------------------------------

PRE_STAGES = ("rcb", "rib", "sfc", "none")

# Stages `repro` registers that the port does not have yet.
_UNPORTED_BISECT = ("rsb-recursive", "multilevel")

_BISECT_STAGES: dict = {}
_POST_STAGES: dict = {}


def register_bisect_stage(name: str, fn) -> None:
    """Register ``fn(ctx, pre, **kw) -> (parts, RSBReport | None)``."""
    _BISECT_STAGES[name] = fn


def register_post_stage(name: str, fn) -> None:
    """Register ``fn(graph, parts, nparts, *, weights=None, ...) ->
    (parts, PostStats)``; cut-non-increasing, labels stay in 0..nparts-1.
    The pipeline's ``post_kw`` is filtered against the signature."""
    _POST_STAGES[name] = fn


def bisect_stage_names() -> tuple:
    return tuple(sorted(_BISECT_STAGES))


def post_stage_names() -> tuple:
    return tuple(sorted(_POST_STAGES))


def _rsb_stage(ctx: PartitionContext, pre, *, device=None, **kw):
    # A mesh input runs the graph engine on its dual graph, assembled
    # through the context ONCE per run — the post stages reuse it.
    laplacian = kw.pop("laplacian", "weighted")
    if laplacian not in ("weighted", "unweighted"):
        raise ValueError(laplacian)
    return rsb_partition_graph(ctx.require_graph(), ctx.nparts,
                               coords=ctx.coords, weights=ctx.weights,
                               pre=pre, device=device, **kw)


def _geometric_stage(fn):
    def stage(ctx: PartitionContext, pre, **kw):
        if ctx.coords is None:
            raise ValueError("geometric bisect stages need coords")
        return fn(ctx.coords, ctx.nparts, ctx.weights, **kw), None
    return stage


def _random_stage(ctx: PartitionContext, pre, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(ctx.n) % ctx.nparts), None


def _stage_kw(fn, post_kw: dict) -> dict:
    """Filter ``post_kw`` to the keywords ``fn``'s signature accepts."""
    params = inspect.signature(fn).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(post_kw)
    return {k: v for k, v in post_kw.items() if k in params}


def _refine_sharded_stage(graph, parts, nparts, *, weights=None, sweeps=4,
                          balance_tol=0.05, corridor=None, backend="auto",
                          guard=None, device=None):
    """Device-resident sharded boundary refinement (repro_torch.dist).  The
    signature mirrors dist.refine_sharded.refine_sharded_stage so
    ``_stage_kw`` filters correctly; the import is lazy because the dist
    layer imports the core package."""
    from repro_torch.dist.refine_sharded import refine_sharded_stage
    return refine_sharded_stage(graph, parts, nparts, weights=weights,
                                sweeps=sweeps, balance_tol=balance_tol,
                                corridor=corridor, backend=backend,
                                guard=guard, device=device)


def _kway_sharded_stage(graph, parts, nparts, *, weights=None, sweeps=4,
                        passes=2, balance_tol=0.05, corridor=None,
                        backend="auto", guard=None, device=None):
    """Sharded sweeps + host boundary k-way polish (repro_torch.dist)."""
    from repro_torch.dist.refine_sharded import kway_sharded_stage
    return kway_sharded_stage(graph, parts, nparts, weights=weights,
                              sweeps=sweeps, passes=passes,
                              balance_tol=balance_tol, corridor=corridor,
                              backend=backend, guard=guard, device=device)


def _register_builtin_stages() -> None:
    from repro_torch.core.rcb import rcb_parts, rib_parts
    from repro_torch.core.sfc import sfc_parts

    register_bisect_stage("rsb-batched", _rsb_stage)
    register_bisect_stage("rcb", _geometric_stage(
        lambda c, p, w, **kw: rcb_parts(c, p, w, **kw)))
    register_bisect_stage("rib", _geometric_stage(
        lambda c, p, w, **kw: rib_parts(c, p, w, **kw)))
    register_bisect_stage("sfc", _geometric_stage(
        lambda c, p, w, **kw: sfc_parts(c, p, w, **kw)))
    register_bisect_stage("random", _random_stage)
    register_post_stage("repair", repair_components)
    register_post_stage("refine", refine_stage)
    register_post_stage("kway", kway_stage)
    register_post_stage("refine-sharded", _refine_sharded_stage)
    register_post_stage("kway-sharded", _kway_sharded_stage)


_register_builtin_stages()


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def _make_context(obj, nparts, coords, weights) -> PartitionContext:
    if hasattr(obj, "vert_gid"):
        c = obj.coords if coords is None else coords
        w = obj.weights if weights is None else weights
        return PartitionContext(nparts=nparts, mesh=obj, coords=c, weights=w)
    return PartitionContext(nparts=nparts, graph=obj, coords=coords,
                            weights=weights)


def _permuted_input(ctx: PartitionContext, order: np.ndarray):
    """A new context whose input is reordered by ``order`` (pre="sfc"),
    carrying any caller coords/weights overrides along."""
    if ctx.mesh is not None:
        mesh = ctx.mesh.take(order)
        if (ctx.coords is not ctx.mesh.coords
                or ctx.weights is not ctx.mesh.weights):
            mesh = dataclasses.replace(
                mesh, coords=np.asarray(ctx.coords, np.float64)[order],
                weights=np.asarray(ctx.weights, np.float64)[order])
        return PartitionContext(nparts=ctx.nparts, mesh=mesh,
                                coords=mesh.coords, weights=mesh.weights)
    return PartitionContext(
        nparts=ctx.nparts, graph=ctx.graph.sub(order),
        coords=None if ctx.coords is None else ctx.coords[order],
        weights=None if ctx.weights is None else ctx.weights[order],
    )


def _check_guard(guard) -> None:
    if guard:
        raise NotImplementedError(
            "guard stages (repro.guard) are not yet ported; pass guard=False")


def run_post_stages(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    post: tuple,
    *,
    weights: np.ndarray | None = None,
    post_kw: dict | None = None,
    device=None,
) -> tuple[np.ndarray, PostStats, list]:
    """Run an ordered chain of registered post stages over ``parts``.

    The balance corridor is computed ONCE here — from the part weights the
    chain starts with — and threaded through every stage, so a
    cap-exceeding forced move in one stage cannot widen the corridor for
    the stages after it.  ``device`` (None: the card) goes to the stages
    that declare a ``device`` keyword (the sharded ones) and is resolved
    only when the chain has one.  Returns the refined labels, the
    aggregated :class:`PostStats`, and one :class:`StageRecord` per stage.
    """
    post_kw = dict(post_kw or {})
    if any("device" in inspect.signature(_POST_STAGES[name]).parameters
           for name in post):
        post_kw["device"] = resolve_device(device)
    parts = np.asarray(parts, dtype=np.int64)
    if post_kw.get("corridor") is None:
        post_kw["corridor"] = balance_corridor(
            parts, nparts, weights, post_kw.get("balance_tol", 0.05))
    corridor = post_kw["corridor"]
    agg = PostStats(corridor=tuple(corridor))
    records = []
    for i, name in enumerate(post):
        fn = _POST_STAGES[name]
        with obs.timed(f"post:{name}") as t:
            parts, stats = fn(graph, parts, nparts, weights=weights,
                              **_stage_kw(fn, post_kw))
        dt = t.seconds
        parts = np.asarray(parts, dtype=np.int64)
        agg.stages.append(name)
        agg.fragments_repaired += stats.fragments_repaired
        agg.forced_moves += stats.forced_moves
        # final state, not a sum: a later repair can clear earlier
        # stages' leftovers
        agg.unrepaired_fragments = stats.unrepaired_fragments
        agg.moves_applied += stats.moves_applied
        agg.sweeps.extend(stats.sweeps)
        if stats.kway is not None:
            agg.kway = stats.kway
        agg.seconds += dt
        info = {"cut_before": stats.cut_before,
                "cut_after": stats.cut_after,
                "fragments": stats.fragments_repaired,
                "moves": stats.moves_applied,
                "corridor": tuple(stats.corridor)
                if stats.corridor else None}
        if stats.sharded is not None:
            info["sharded"] = stats.sharded
        records.append(StageRecord(kind="post", name=name, seconds=dt,
                                   info=info))
        if i == 0:
            agg.cut_before = stats.cut_before
        agg.cut_after = stats.cut_after
    return parts, agg, records


@dataclasses.dataclass
class PartitionPipeline:
    """pre → bisect → post, each slot a registered stage (module docstring).

    ``bisect_kw`` goes to the bisect stage verbatim; ``post_kw`` to every
    post stage, filtered against each stage's signature.  ``device`` is
    where the spectral bisect stage solves and the sharded post stages
    sweep (``None``: the card).
    """

    pre: str = "rcb"
    bisect: str = "rsb-batched"
    post: tuple = ("repair", "refine")
    bisect_kw: dict = dataclasses.field(default_factory=dict)
    post_kw: dict = dataclasses.field(default_factory=dict)
    guard: bool | None = None
    device: object = None

    def __post_init__(self):
        _check_guard(self.guard)
        if self.pre not in PRE_STAGES:
            raise ValueError(
                f"unknown pre stage: {self.pre!r} (have {PRE_STAGES})")
        if self.bisect in _UNPORTED_BISECT:
            raise NotImplementedError(
                f"bisect stage {self.bisect!r} is not yet ported")
        if self.bisect not in _BISECT_STAGES:
            raise ValueError(
                f"unknown bisect stage: {self.bisect!r} "
                f"(have {bisect_stage_names()})")
        self.post = tuple(self.post)
        for name in self.post:
            if name not in _POST_STAGES:
                raise ValueError(
                    f"unknown post stage: {name!r} "
                    f"(have {post_stage_names()})")

    def run(self, obj, nparts: int, *, coords: np.ndarray | None = None,
            weights: np.ndarray | None = None) -> PartitionContext:
        """Partition a HexMesh or Graph; returns the full context."""
        device = resolve_device(self.device)
        ctx = _make_context(obj, nparts, coords, weights)
        spectral = self.bisect.startswith("rsb")
        ctx.config = {"pre": self.pre, "bisect": self.bisect,
                      "post": list(self.post), "nparts": nparts, "n": ctx.n,
                      "guard": False, "device": str(device)}
        self._run_stages(ctx, nparts, spectral, device)
        return ctx

    def _run_stages(self, ctx: PartitionContext, nparts: int,
                    spectral: bool, device) -> None:
        # --- pre: reorder hint (rcb/rib) or one-shot permutation (sfc)
        with obs.timed(f"pre:{self.pre}") as t_pre:
            hint, order = None, None
            run_ctx = ctx
            if spectral and self.pre in ("rcb", "rib"):
                hint = self.pre  # per-level reorder, applied inside driver
            elif spectral and self.pre == "sfc":
                if ctx.coords is not None:
                    from repro_torch.core.sfc import sfc_order

                    order = sfc_order(ctx.coords)
                    run_ctx = _permuted_input(ctx, order)
        ctx.stages.append(StageRecord(
            kind="pre", name=self.pre, seconds=t_pre.seconds,
            info={"mode": ("per-level" if hint else
                           "permute" if order is not None else "noop")},
        ))

        # --- bisect
        bkw = dict(self.bisect_kw)
        if spectral:
            bkw["device"] = device
        with obs.timed(f"bisect:{self.bisect}") as t_bisect:
            parts, report = _BISECT_STAGES[self.bisect](run_ctx, hint, **bkw)
        dt = t_bisect.seconds
        if run_ctx is not ctx:
            ctx.stages.extend(run_ctx.stages)   # the permuted input's setup
        if order is not None:   # map labels back to the caller's order
            unperm = np.empty_like(parts)
            unperm[order] = parts
            parts = unperm
            if ctx.graph is None and run_ctx.graph is not None:
                # One cheap CSR relabel recovers the caller-order graph, so
                # the post stages don't pay a second assembly.
                ctx.graph = run_ctx.graph.sub(np.argsort(order))
        if report is None:
            report = RSBReport(records=[], seconds=dt, engine="-",
                               pre=self.pre)
        ctx.parts = np.asarray(parts, dtype=np.int64)
        ctx.parts_raw = ctx.parts.copy()
        ctx.report = report
        setup = sum(s.seconds for s in ctx.stages if s.kind == "setup")
        ctx.stages.append(StageRecord(
            kind="bisect", name=self.bisect, seconds=dt - setup,
            info={"iterations": report.total_iterations,
                  "device_seconds": report.device_seconds},
        ))

        # --- post (one corridor per chain, fixed from the bisection's
        # part weights — see run_post_stages)
        if self.post:
            parts, agg, records = run_post_stages(
                ctx.require_graph(), ctx.parts, nparts, self.post,
                weights=ctx.weights, post_kw=self.post_kw, device=device)
            ctx.parts = parts
            ctx.stages.extend(records)
            report.post = agg


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

_ENGINE_TO_BISECT = {"batched": "rsb-batched", "recursive": "rsb-recursive"}

# Explicit per-stage keyword routing; unknown keys raise.
_RSB_KW = {"method", "pre", "tol", "window", "max_restarts", "seed",
           "warm_start", "multilevel", "fine_restarts", "precond"}
_RSB_MESH_KW = _RSB_KW | {"laplacian", "use_kernel"}
_RSB_GRAPH_KW = _RSB_KW | {"use_kernel"}
_GEOM_KW = {"rcb": set(), "rib": set(), "sfc": {"curve", "bits"},
            "random": {"seed"}}

_REFINE_SPECS = {
    "none": (), "repair": ("repair",), "refine": ("refine",),
    "repair+refine": ("repair", "refine"),
    # Hill-climbing k-way FM (core/kway.py): negative-gain prefixes with
    # rollback to the best prefix.
    "kway": ("kway",), "repair+kway": ("repair", "kway"),
    # Device-resident sharded refinement (dist/refine_sharded.py): one
    # boundary-label gather and one K4 connection table per sweep.
    "refine-sharded": ("refine-sharded",),
    "repair+refine-sharded": ("repair", "refine-sharded"),
    "kway-sharded": ("kway-sharded",),
    "repair+kway-sharded": ("repair", "kway-sharded"),
}


def parse_refine(refine) -> tuple:
    """``refine=`` spec → post-stage tuple ("none" is the escape hatch)."""
    if refine is None:
        return _REFINE_SPECS["repair+refine"]
    if isinstance(refine, str):
        try:
            return _REFINE_SPECS[refine]
        except KeyError:
            raise ValueError(
                f"unknown refine spec: {refine!r} "
                f"(have {tuple(_REFINE_SPECS)} or a stage tuple)") from None
    return tuple(refine)


def _check_kw(kw: dict, allowed: set, who: str) -> None:
    unknown = set(kw) - allowed
    if unknown:
        raise TypeError(
            f"unknown keyword(s) for partitioner {who!r}: "
            f"{sorted(unknown)} (allowed: {sorted(allowed)})")


def partition(
    obj,
    nparts: int,
    *,
    partitioner: str = "rsb",
    coords: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    engine: str = "batched",
    refine: str | tuple | None = None,
    refine_sweeps: int = 4,
    balance_tol: float = 0.05,
    guard: bool | None = None,
    device=None,
    **kw,
) -> np.ndarray:
    """Uniform front door: partitioner ∈ {rsb, rsb_inverse, rcb, rib, sfc,
    random}, built as a :class:`PartitionPipeline` run; returns the labels.

    ``refine`` selects the post stages ("repair+refine" by default for RSB,
    "none" for the geometric/random baselines; "repair+kway" the k-way FM,
    "repair+refine-sharded" / "kway-sharded" the sharded sweeps).
    ``device`` (default: the card) is where the spectral solves and the
    sharded sweeps run.  Remaining keywords are routed
    to the selected stage and unknown keys raise.  ``partitioner=
    "rsb_inverse"`` is RSB with ``method="inverse"`` (``precond=`` "jacobi",
    the default, or "amg").  ``partitioner="multilevel"``,
    ``engine="recursive"`` and ``guard=True`` are not yet ported and raise.
    """
    _check_guard(guard)
    is_mesh = hasattr(obj, "vert_gid")
    post_kw = dict(sweeps=refine_sweeps, balance_tol=balance_tol)

    if partitioner == "multilevel":
        raise NotImplementedError(
            f"partitioner {partitioner!r} is not yet ported")
    if partitioner in ("rsb", "rsb_lanczos", "rsb_inverse"):
        if engine not in _ENGINE_TO_BISECT:
            raise ValueError(f"unknown engine: {engine}")
        if partitioner == "rsb_inverse":
            kw["method"] = "inverse"
        _check_kw(kw, _RSB_MESH_KW if is_mesh else _RSB_GRAPH_KW, partitioner)
        pre = kw.pop("pre", "rcb")
        pipe = PartitionPipeline(
            pre=pre or "none", bisect=_ENGINE_TO_BISECT[engine],
            post=parse_refine(refine), bisect_kw=kw, post_kw=post_kw,
            device=device,
        )
    elif partitioner in _GEOM_KW:
        _check_kw(kw, _GEOM_KW[partitioner], partitioner)
        pipe = PartitionPipeline(
            pre="none", bisect=partitioner,
            post=parse_refine("none" if refine is None else refine),
            bisect_kw=kw, post_kw=post_kw, device=device,
        )
    else:
        raise ValueError(f"unknown partitioner: {partitioner}")

    return pipe.run(obj, nparts, coords=coords, weights=weights).parts
