"""Composable partition pipeline: pre → bisect → post, inside the guard.

The port of `repro.core.pipeline`:

* :class:`PartitionPipeline` — three stage slots.  ``pre`` ∈ {"rcb",
  "rib", "sfc", "none"}: "rcb"/"rib" select the per-level reorder the RSB
  engine applies at every tree node, "sfc" one global space-filling-curve
  permutation up front.  ``bisect`` ∈ {"rsb-batched", "rsb-recursive",
  "multilevel", "rcb", "rib", "sfc", "random"} ("rsb-recursive" is the
  depth-first reference engine, matrix-free gather-scatter solves on a
  mesh; "multilevel" the host V-cycle of `core/multilevel.py`).
  ``post`` — an ordered tuple of {"repair", "refine", "kway",
  "refine-sharded", "kway-sharded"}, by default ("repair", "refine"),
  run under ONE balance corridor
  (:func:`run_post_stages`).
* The guard (`repro_torch.guard`), on by default as in `repro`
  (``guard=None`` defers to ``REPRO_GUARD``, default on): the
  ``guard:validate`` front door, per-component dispatch of a disconnected
  input, a ``SolverGuard`` around every spectral solve and the sharded
  post stages, and the ``guard:finalize`` output invariant.  A healthy
  guarded run returns the labels of ``guard=False`` bit for bit.
* :class:`PartitionContext` — what flows through the stages, with one
  :class:`StageRecord` per stage (wall seconds, and for the spectral
  bisect stage the part of them spent in device solves).
* Tracing (`repro_torch.obs`), as in `repro`: with ``REPRO_OBS`` on (the
  default) every run happens inside one ``partition`` root span —
  ``ctx.trace`` — with one child span per stage; ``ctx.export_manifest()``
  writes it as a JSONL manifest, ``ctx.export_trace_events()`` as a
  Chrome trace, and ``REPRO_OBS_DIR`` writes a manifest there on every
  run.
* :func:`partition` — the keyword front door, returning labels only.

``device`` (default ``None``, meaning the card) is resolved when a run
starts: without a card a run raises unless the caller asked for the CPU.
The spectral bisect stage and the sharded post stages ("refine-sharded",
"kway-sharded", whose sweeps run there) use it; the other stages are host
NumPy, bit-identical to `repro` on the same inputs.

Unknown stage names raise ValueError, as in `repro`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os

import numpy as np

from repro_torch import obs
from repro_torch.core.kway import kway_stage
from repro_torch.core.refine import (
    PostStats,
    balance_corridor,
    refine_stage,
    repair_components,
)
from repro_torch.core.rsb import (
    RSBReport,
    rsb_partition_graph,
    rsb_partition_mesh,
)
from repro_torch.device import resolve_device
from repro_torch.guard import chaos
from repro_torch.guard.errors import GuardReport
from repro_torch.guard.policy import (
    GuardPolicy,
    SolverGuard,
    check_output,
    enforce_output,
)
from repro_torch.guard.validate import (
    component_labels,
    pack_components,
    proportional_budgets,
    validate_graph,
    validate_mesh,
    validate_nparts,
)
from repro_torch.mesh.graphs import Graph, dual_graph_from_incidence


@dataclasses.dataclass
class StageRecord:
    """One executed stage: where the wall-clock went and what it did."""

    kind: str          # "setup" | "guard" | "pre" | "bisect" | "post"
    name: str
    seconds: float
    info: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        """`repro`'s row: kind, name, seconds and the stage's info, less
        the keys only the port records (:data:`_PORT_INFO`)."""
        return {"kind": self.kind, "name": self.name,
                "seconds": self.seconds,
                **{k: v for k, v in self.info.items() if k not in _PORT_INFO}}


# Stage info the port records beyond `repro`'s: a bisect stage's device
# seconds, a post stage's own steps and its sharded sweeps' figures.
_PORT_INFO = ("device_seconds", "stages", "sharded")


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
    trace: object | None = None          # obs.Span root (None: REPRO_OBS=off)
    config: dict = dataclasses.field(default_factory=dict)  # pipeline shape

    @property
    def n(self) -> int:
        return self.mesh.nelems if self.mesh is not None else self.graph.n

    def require_graph(self) -> Graph:
        """The dual graph — assembled on first use for mesh inputs."""
        if self.graph is None:
            m = self.mesh
            with obs.stopwatch() as t:
                self.graph = dual_graph_from_incidence(m.vert_gid, m.n_vert,
                                                       m.nelems)
            self.stages.append(StageRecord(kind="setup", name="dual_graph",
                                           seconds=t.seconds))
        return self.graph

    def stage_seconds(self, kind: str | None = None) -> float:
        return sum(s.seconds for s in self.stages
                   if kind is None or s.kind == kind)

    @property
    def seconds(self) -> float:
        return self.stage_seconds()

    def stats(self) -> dict:
        """JSON-able run summary (benchmark rows, experiment records) with
        `repro`'s keys: the port's own ``setup`` records (the dual graph's
        assembly, inside ``guard:validate`` in `repro`) are left out of
        ``stages`` and counted in ``seconds``."""
        out = {
            "nparts": self.nparts,
            "n": self.n,
            "seconds": self.seconds,
            "stages": [s.to_dict() for s in self.stages
                       if s.kind != "setup"],
        }
        if self.report is not None and self.report.post is not None:
            out["post"] = self.report.post.row()
        return out

    def export_manifest(self, path: str | None = None, *,
                        name: str = "partition",
                        runs_dir: str = "runs") -> str | None:
        """Write this run's JSONL manifest (span tree + counters + config
        + git SHA).  Returns the path, or None when no trace was recorded
        (``REPRO_OBS=off``)."""
        if self.trace is None:
            return None
        if path is None:
            path = obs.run_path(runs_dir, name)
        return obs.write_manifest(self.trace, path, name=name,
                                  config=self.config)

    def export_trace_events(self, path: str) -> str | None:
        """Write the Chrome/Perfetto ``trace_event`` JSON for this run;
        None when no trace was recorded."""
        if self.trace is None:
            return None
        return obs.write_trace_events(self.trace, path)


# ---------------------------------------------------------------------------
# Stage registries
# ---------------------------------------------------------------------------

PRE_STAGES = ("rcb", "rib", "sfc", "none")

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


def _rsb_stage(engine):
    def stage(ctx: PartitionContext, pre, *, device=None, **kw):
        if ctx.mesh is not None and engine == "recursive":
            # The recursive mesh engine solves on the mesh's gather-scatter
            # operator and reads coords/weights off the mesh: hand it an
            # overridden copy so both engines balance the same weights.
            mesh = ctx.mesh
            if ctx.coords is not mesh.coords or ctx.weights is not mesh.weights:
                mesh = dataclasses.replace(
                    mesh, coords=np.asarray(ctx.coords, np.float64),
                    weights=np.asarray(ctx.weights, np.float64))
            return rsb_partition_mesh(mesh, ctx.nparts, pre=pre,
                                      engine=engine, device=device, **kw)
        # A mesh input runs the batched graph engine on its dual graph,
        # assembled through the context ONCE per run — the post stages
        # reuse it.
        laplacian = kw.pop("laplacian", "weighted")
        if laplacian not in ("weighted", "unweighted"):
            raise ValueError(laplacian)
        return rsb_partition_graph(ctx.require_graph(), ctx.nparts,
                                   coords=ctx.coords, weights=ctx.weights,
                                   pre=pre, engine=engine, device=device,
                                   **kw)
    return stage


def _geometric_stage(fn):
    def stage(ctx: PartitionContext, pre, **kw):
        if ctx.coords is None:
            raise ValueError("geometric bisect stages need coords")
        return fn(ctx.coords, ctx.nparts, ctx.weights, **kw), None
    return stage


def _random_stage(ctx: PartitionContext, pre, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(ctx.n) % ctx.nparts), None


def _multilevel_stage(ctx: PartitionContext, pre, **kw):
    """METIS-style multilevel k-way V-cycle (core/multilevel.py): coarsen →
    partition-coarsest → prolong+refine, on the host.  The ``pre`` reorder
    hint is irrelevant (matching is order-free)."""
    from repro_torch.core.multilevel import multilevel_partition

    return multilevel_partition(ctx.require_graph(), ctx.nparts,
                                weights=ctx.weights, **kw)


def _stage_kw(fn, post_kw: dict) -> dict:
    """Filter ``post_kw`` to the keywords ``fn``'s signature accepts."""
    params = inspect.signature(fn).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(post_kw)
    return {k: v for k, v in post_kw.items() if k in params}


def _refine_sharded_stage(graph, parts, nparts, *, weights=None, sweeps=4,
                          balance_tol=0.05, corridor=None, backend="auto",
                          guard=None, device=None, group=None):
    """Device-resident sharded boundary refinement (repro_torch.dist).  The
    signature mirrors dist.refine_sharded.refine_sharded_stage so
    ``_stage_kw`` filters correctly; the import is lazy because the dist
    layer imports the core package."""
    from repro_torch.dist.refine_sharded import refine_sharded_stage
    return refine_sharded_stage(graph, parts, nparts, weights=weights,
                                sweeps=sweeps, balance_tol=balance_tol,
                                corridor=corridor, backend=backend,
                                guard=guard, device=device, group=group)


def _kway_sharded_stage(graph, parts, nparts, *, weights=None, sweeps=4,
                        passes=2, balance_tol=0.05, corridor=None,
                        backend="auto", guard=None, device=None, group=None):
    """Sharded sweeps + host boundary k-way polish (repro_torch.dist)."""
    from repro_torch.dist.refine_sharded import kway_sharded_stage
    return kway_sharded_stage(graph, parts, nparts, weights=weights,
                              sweeps=sweeps, passes=passes,
                              balance_tol=balance_tol, corridor=corridor,
                              backend=backend, guard=guard, device=device,
                              group=group)


def _register_builtin_stages() -> None:
    from repro_torch.core.rcb import rcb_parts, rib_parts
    from repro_torch.core.sfc import sfc_parts

    register_bisect_stage("rsb-batched", _rsb_stage("batched"))
    register_bisect_stage("rsb-recursive", _rsb_stage("recursive"))
    register_bisect_stage("rcb", _geometric_stage(
        lambda c, p, w, **kw: rcb_parts(c, p, w, **kw)))
    register_bisect_stage("rib", _geometric_stage(
        lambda c, p, w, **kw: rib_parts(c, p, w, **kw)))
    register_bisect_stage("sfc", _geometric_stage(
        lambda c, p, w, **kw: sfc_parts(c, p, w, **kw)))
    register_bisect_stage("random", _random_stage)
    register_bisect_stage("multilevel", _multilevel_stage)
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


def _subset_context(ctx: PartitionContext, idx: np.ndarray,
                    nparts: int) -> PartitionContext:
    """A sub-context over the nodes in ``idx`` (one connected component),
    renumbered contiguously — what the per-component bisect runs on."""
    if ctx.mesh is not None:
        mesh = ctx.mesh.take(idx)
        return PartitionContext(nparts=nparts, mesh=mesh,
                                coords=mesh.coords, weights=mesh.weights)
    return PartitionContext(
        nparts=nparts, graph=ctx.require_graph().sub(idx),
        coords=None if ctx.coords is None else ctx.coords[idx],
        weights=None if ctx.weights is None else ctx.weights[idx],
    )


def _guard_enabled(flag: bool | None) -> bool:
    """Resolve the pipeline guard switch: an explicit ``guard=`` wins;
    otherwise ``REPRO_GUARD`` (default on; off/0/false/no disable)."""
    if flag is not None:
        return bool(flag)
    env = os.environ.get("REPRO_GUARD", "on").strip().lower()
    return env not in ("off", "0", "false", "no")


def _merge_guard(dst: GuardReport, src) -> None:
    """Fold one bisect stage's GuardReport into the pipeline-wide one
    (the RSB engine creates its own per-stage report)."""
    if src is None or src is dst:
        return
    dst.validated |= src.validated
    dst.sanitized |= src.sanitized
    dst.issues.extend(src.issues)
    dst.components = max(dst.components, src.components)
    dst.retries += src.retries
    dst.fallbacks += src.fallbacks
    dst.sanitize_fixes += src.sanitize_fixes
    dst.deadline_expired |= src.deadline_expired
    dst.degraded.extend(src.degraded)


def run_post_stages(
    graph: Graph,
    parts: np.ndarray,
    nparts: int,
    post: tuple,
    *,
    weights: np.ndarray | None = None,
    post_kw: dict | None = None,
    device=None,
    group=None,
) -> tuple[np.ndarray, PostStats, list]:
    """Run an ordered chain of registered post stages over ``parts``.

    The balance corridor is computed ONCE here — from the part weights the
    chain starts with — and threaded through every stage, so a
    cap-exceeding forced move in one stage cannot widen the corridor for
    the stages after it.  ``device`` (None: the card) goes to the stages
    that declare a ``device`` keyword (the sharded ones) and is resolved
    only when the chain has one; ``group`` (None: the default group when
    `torch.distributed` is initialized) to the stages that declare a
    ``group`` keyword: the sharded sweeps run across its ranks, the host
    stages run on every rank alike.  Returns the refined labels, the
    aggregated :class:`PostStats`, and one :class:`StageRecord` per stage.
    """
    post_kw = dict(post_kw or {})
    if any("device" in inspect.signature(_POST_STAGES[name]).parameters
           for name in post):
        post_kw["device"] = resolve_device(device)
    if group is not None:
        post_kw["group"] = group
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
                if stats.corridor else None,
                # the stage's own steps ("host-fallback" where the sharded
                # sweeps degraded to the host refiner)
                "stages": list(stats.stages)}
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
    sweep (``None``: the card); ``group`` the process group the sharded
    post stages sweep across (`run_post_stages`; ``None``: the default
    group when `torch.distributed` is initialized).

    ``guard`` switches the fault-tolerance envelope (module docstring;
    ``None`` defers to ``REPRO_GUARD``, default on).  ``guard_kw``
    parameterizes the :class:`~repro_torch.guard.policy.GuardPolicy`
    (``sanitize``, ``max_retries``, ``switch_method``, ``deadline``,
    ``balance_tol``) plus the chaos overlay (``chaos`` — a tuple of fault
    sites — ``chaos_seed``, ``chaos_rate``), as in `repro`.
    """

    pre: str = "rcb"
    bisect: str = "rsb-batched"
    post: tuple = ("repair", "refine")
    bisect_kw: dict = dataclasses.field(default_factory=dict)
    post_kw: dict = dataclasses.field(default_factory=dict)
    guard: bool | None = None
    guard_kw: dict = dataclasses.field(default_factory=dict)
    device: object = None
    group: object = None

    def __post_init__(self):
        if self.pre not in PRE_STAGES:
            raise ValueError(
                f"unknown pre stage: {self.pre!r} (have {PRE_STAGES})")
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
        """Partition a HexMesh or Graph; returns the full context.

        When tracing is on (``REPRO_OBS`` unset/on) the whole run happens
        inside one ``partition`` root span — ``ctx.trace`` — with one
        child span per stage; ``ctx.export_manifest()`` serializes it, and
        setting ``REPRO_OBS_DIR`` writes a manifest there automatically.
        """
        device = resolve_device(self.device)
        ctx = _make_context(obj, nparts, coords, weights)
        spectral = self.bisect.startswith("rsb")
        guard_on = _guard_enabled(self.guard)
        ctx.config = {"pre": self.pre, "bisect": self.bisect,
                      "post": list(self.post), "nparts": nparts, "n": ctx.n,
                      "guard": guard_on, "device": str(device)}

        root = obs.trace("partition", nparts=nparts, n=ctx.n,
                         pre=self.pre, bisect=self.bisect,
                         post=",".join(self.post), guard=guard_on)
        with root:
            if guard_on:
                self._run_guarded(ctx, nparts, spectral, device)
            else:
                self._run_stages(ctx, nparts, spectral, device)
        if isinstance(root, obs.Span):
            ctx.trace = root
            out_dir = os.environ.get("REPRO_OBS_DIR")
            if out_dir:
                ctx.export_manifest(runs_dir=out_dir)
        return ctx

    # -- the guarded path: validate → (components?) → stages → finalize --

    def _run_guarded(self, ctx: PartitionContext, nparts: int,
                     spectral: bool, device) -> None:
        policy = GuardPolicy.from_kw(self.guard_kw)
        greport = GuardReport()
        sites = tuple(self.guard_kw.get("chaos") or ())
        overlay = (chaos.overlay(
            sites, seed=int(self.guard_kw.get("chaos_seed", 0)),
            rate=float(self.guard_kw.get("chaos_rate", 1.0)))
            if sites else contextlib.nullcontext())
        with overlay:
            ncomp, comp = self._validate_input(ctx, nparts, policy, greport)
            if ncomp > 1:
                self._run_components(ctx, nparts, spectral, device, policy,
                                     greport, comp, ncomp)
            else:
                self._run_stages(ctx, nparts, spectral, device,
                                 policy=policy, greport=greport)
            self._finalize(ctx, nparts, policy, greport, ncomp)

    def _validate_input(self, ctx: PartitionContext, nparts: int,
                        policy: GuardPolicy, greport: GuardReport):
        """``guard:validate`` — the implicit first stage: typed
        :class:`GuardError` in strict mode, recorded repairs in sanitize
        mode, plus component detection (disconnected inputs are handled
        downstream, never rejected here).  A mesh's dual graph is
        assembled here, once per run (its own ``setup`` record)."""
        with obs.timed("guard:validate") as t:
            validate_nparts(nparts, ctx.n)
            if ctx.mesh is not None:
                mesh = ctx.mesh
                if (ctx.coords is not mesh.coords
                        or ctx.weights is not mesh.weights):
                    mesh = dataclasses.replace(
                        mesh, coords=np.asarray(ctx.coords, np.float64),
                        weights=np.asarray(ctx.weights, np.float64))
                mesh = validate_mesh(mesh, nparts=nparts,
                                     sanitize=policy.sanitize,
                                     report=greport)
                ctx.mesh = mesh
                ctx.coords, ctx.weights = mesh.coords, mesh.weights
            else:
                g, c, w = validate_graph(
                    ctx.graph, coords=ctx.coords, weights=ctx.weights,
                    nparts=nparts, sanitize=policy.sanitize, report=greport)
                ctx.graph, ctx.coords, ctx.weights = g, c, w
            n_before = len(ctx.stages)
            comp, ncomp = component_labels(ctx.require_graph())
            greport.components = max(greport.components, ncomp)
            if greport.sanitize_fixes:
                obs.counter_add("guard_sanitize_fixes",
                                greport.sanitize_fixes)
        setup = sum(s.seconds for s in ctx.stages[n_before:])
        ctx.config["components"] = ncomp
        ctx.stages.append(StageRecord(
            kind="guard", name="validate", seconds=t.seconds - setup,
            info={"issues": len(greport.issues),
                  "fixes": greport.sanitize_fixes,
                  "components": ncomp},
        ))
        return ncomp, comp

    def _run_components(self, ctx: PartitionContext, nparts: int,
                        spectral: bool, device, policy: GuardPolicy,
                        greport: GuardReport, comp: np.ndarray,
                        ncomp: int) -> None:
        """Partition a disconnected input component by component.

        ``ncomp <= nparts``: largest-remainder part budgets per component,
        each component run through pre+bisect with its own budget; the
        post chain then runs ONCE over the full graph (no edge crosses
        components, so refinement can never merge them back).
        ``ncomp > nparts``: whole components are packed onto parts
        (greedy heaviest-first).
        """
        w = np.ones(ctx.n) if ctx.weights is None else \
            np.asarray(ctx.weights, np.float64)
        comp_w = np.bincount(comp, weights=w, minlength=ncomp)
        with obs.timed(f"pre:{self.pre}") as t_pre:
            pass        # pre runs inside each component's sub-pipeline
        ctx.stages.append(StageRecord(
            kind="pre", name=self.pre, seconds=t_pre.seconds,
            info={"mode": "per-component", "components": ncomp}))

        parts = np.zeros(ctx.n, dtype=np.int64)
        merged = RSBReport(records=[], seconds=0.0, engine="-", pre=self.pre)
        with obs.timed(f"bisect:{self.bisect}") as t_bisect:
            if ncomp > nparts:
                parts = pack_components(comp_w, nparts)[comp]
                merged.engine = "pack-components"
                greport.degrade(f"input:packed-{ncomp}-components")
            else:
                budgets = proportional_budgets(comp_w, nparts)
                offset = 0
                for c in range(ncomp):
                    idx = np.flatnonzero(comp == c)
                    k = int(budgets[c])
                    if k <= 1 or idx.size <= 1:
                        parts[idx] = offset
                    else:
                        sub = _subset_context(ctx, idx, k)
                        self._run_stages(sub, k, spectral, device,
                                         policy=policy, greport=greport,
                                         with_post=False)
                        parts[idx] = offset + np.asarray(sub.parts,
                                                         np.int64)
                        for s in sub.stages:
                            s.info["component"] = c
                        ctx.stages.extend(sub.stages)
                        merged.records.extend(sub.report.records)
                        merged.engine = sub.report.engine
                    offset += k
        merged.seconds = t_bisect.seconds
        ctx.parts = parts
        ctx.parts_raw = parts.copy()
        ctx.report = merged
        ctx.stages.append(StageRecord(
            kind="bisect", name=self.bisect, seconds=t_bisect.seconds,
            info={"mode": ("pack" if ncomp > nparts else "per-component"),
                  "components": ncomp,
                  "iterations": merged.total_iterations}))

        if self.post:
            parts, agg, records = run_post_stages(
                ctx.require_graph(), ctx.parts, nparts, self.post,
                weights=ctx.weights, post_kw=self.post_kw, device=device,
                group=self.group)
            ctx.parts = parts
            ctx.stages.extend(records)
            merged.post = agg

    def _finalize(self, ctx: PartitionContext, nparts: int,
                  policy: GuardPolicy, greport: GuardReport,
                  ncomp: int) -> None:
        """``guard:finalize`` — the output-invariant closer.  Checks every
        run; *mutates* only when labels are structurally invalid or a
        degraded solve path left problems behind, so a healthy guarded run
        returns bit-identical labels to ``guard=False``."""
        with obs.timed("guard:finalize") as t:
            graph = ctx.require_graph()
            expected = max(0, ncomp - nparts)
            problems = check_output(
                graph, ctx.parts, nparts, weights=ctx.weights,
                balance_tol=policy.balance_tol,
                expected_disconnected=expected)
            structural = any(p.startswith("labels") for p in problems)
            degraded = bool(greport.fallbacks or greport.deadline_expired)
            enforced = False
            if structural or (problems and degraded):
                ctx.parts = enforce_output(
                    graph, ctx.parts, nparts, weights=ctx.weights,
                    balance_tol=policy.balance_tol, report=greport)
                enforced = True
                problems = check_output(
                    graph, ctx.parts, nparts, weights=ctx.weights,
                    balance_tol=policy.balance_tol,
                    expected_disconnected=expected)
        ctx.stages.append(StageRecord(
            kind="guard", name="finalize", seconds=t.seconds,
            info={"problems": list(problems), "enforced": enforced,
                  "retries": greport.retries,
                  "fallbacks": greport.fallbacks},
        ))
        if ctx.report is not None:
            ctx.report.guard = greport

    def _run_stages(self, ctx: PartitionContext, nparts: int,
                    spectral: bool, device, *,
                    policy: GuardPolicy | None = None,
                    greport: GuardReport | None = None,
                    with_post: bool = True) -> None:
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
            if policy is not None:
                bkw.setdefault("guard", policy)
        n_before = len(ctx.stages)
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
        if greport is not None:
            _merge_guard(greport, report.guard)
        ctx.parts = np.asarray(parts, dtype=np.int64)
        ctx.parts_raw = ctx.parts.copy()
        ctx.report = report
        # the dual graph, where the bisect stage assembled it
        setup = sum(s.seconds for s in ctx.stages[n_before:]
                    if s.kind == "setup")
        ctx.stages.append(StageRecord(
            kind="bisect", name=self.bisect, seconds=dt - setup,
            info={"iterations": report.total_iterations,
                  "device_seconds": report.device_seconds},
        ))

        # --- post (one corridor per chain, fixed from the bisection's
        # part weights — see run_post_stages)
        if self.post and with_post:
            post_kw = dict(self.post_kw)
            if policy is not None and "guard" not in post_kw:
                # Stages that declare a ``guard`` keyword (the sharded
                # refinement pair) get the stage-deadline envelope; the
                # host stages never see it (_stage_kw filters).
                post_kw["guard"] = SolverGuard(
                    policy, seed=0, method="post", report=greport)
            parts, agg, records = run_post_stages(
                ctx.require_graph(), ctx.parts, nparts, self.post,
                weights=ctx.weights, post_kw=post_kw, device=device,
                group=self.group)
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
_ML_KW = {"coarse_factor", "coarse_solver", "refine_passes", "stall",
          "coarse_passes", "seed", "max_levels", "min_coarsen_ratio"}

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
    guard_kw: dict | None = None,
    device=None,
    group=None,
    **kw,
) -> np.ndarray:
    """Uniform front door: partitioner ∈ {rsb, rsb_inverse, multilevel,
    rcb, rib, sfc, random}, built as a :class:`PartitionPipeline` run;
    returns the labels.

    ``refine`` selects the post stages ("repair+refine" by default for RSB,
    "repair+kway" for multilevel, "none" for the geometric/random
    baselines; "repair+kway" the k-way FM, "repair+refine-sharded" /
    "kway-sharded" the sharded sweeps).  ``device`` (default: the card) is
    where the spectral solves and the sharded sweeps run; ``group`` the
    process group the sharded sweeps run across (every rank runs the rest
    alike; :class:`PartitionPipeline`).  Remaining
    keywords are routed to the selected stage and unknown keys raise.
    ``partitioner="rsb_inverse"`` is RSB with ``method="inverse"``
    (``precond=`` "jacobi", the default, or "amg").  ``guard``/``guard_kw``
    switch and parameterize the guard (:class:`PartitionPipeline`; the
    default defers to ``REPRO_GUARD``, on unless set off).
    ``engine`` selects the RSB driver ("batched", or "recursive": the
    depth-first reference engine, gather-scatter solves on a mesh).
    """
    is_mesh = hasattr(obj, "vert_gid")
    post_kw = dict(sweeps=refine_sweeps, balance_tol=balance_tol)
    gkw = dict(guard=guard, guard_kw=dict(guard_kw or {}), device=device,
               group=group)

    if partitioner in ("rsb", "rsb_lanczos", "rsb_inverse"):
        if engine not in _ENGINE_TO_BISECT:
            raise ValueError(f"unknown engine: {engine}")
        if partitioner == "rsb_inverse":
            kw["method"] = "inverse"
        _check_kw(kw, _RSB_MESH_KW if is_mesh else _RSB_GRAPH_KW, partitioner)
        pre = kw.pop("pre", "rcb")
        pipe = PartitionPipeline(
            pre=pre or "none", bisect=_ENGINE_TO_BISECT[engine],
            post=parse_refine(refine), bisect_kw=kw, post_kw=post_kw, **gkw,
        )
    elif partitioner == "multilevel":
        # The V-cycle's default post chain is repair+kway, as in `repro`.
        _check_kw(kw, _ML_KW, partitioner)
        pipe = PartitionPipeline(
            pre="none", bisect="multilevel",
            post=parse_refine("repair+kway" if refine is None else refine),
            bisect_kw=dict(balance_tol=balance_tol, **kw), post_kw=post_kw,
            **gkw,
        )
    elif partitioner in _GEOM_KW:
        _check_kw(kw, _GEOM_KW[partitioner], partitioner)
        pipe = PartitionPipeline(
            pre="none", bisect=partitioner,
            post=parse_refine("none" if refine is None else refine),
            bisect_kw=kw, post_kw=post_kw, **gkw,
        )
    else:
        raise ValueError(f"unknown partitioner: {partitioner}")

    return pipe.run(obj, nparts, coords=coords, weights=weights).parts
