"""Typed metric registry: the names solver internals emit into spans.

The port of `repro.obs.registry`: the same metric definitions (names,
kinds, units, aggregations) and the same span vocabulary, so a port
trace and a `repro` trace of the same run carry the same keys.

Stages call ``counter_add``/``gauge_set`` with free-form names, but the
*known* metrics — the ones exporters label, benchmarks tabulate, and the
drift guard checks — are declared here with a kind, unit, and merge
semantics.  Registration is open (``register`` at import time for new
subsystems); emitting an unregistered name is allowed and merges with
counter semantics, it just carries no unit/description.

Merge semantics when aggregating over a span subtree:

* ``counter`` — sums (CG iterations across levels add up).
* ``gauge``   — by aggregation: ``max`` (default; e.g. ``amg_levels``
  reports the deepest hierarchy seen), ``min``, or ``last``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MetricDef:
    name: str
    kind: str                    # "counter" | "gauge"
    unit: str = ""
    description: str = ""
    agg: str = "sum"             # counters: sum; gauges: max|min|last


_REGISTRY: dict = {}


def register(name: str, kind: str, *, unit: str = "", description: str = "",
             agg: str | None = None) -> MetricDef:
    if kind not in ("counter", "gauge"):
        raise ValueError(f"metric kind must be counter|gauge, got {kind!r}")
    if agg is None:
        agg = "sum" if kind == "counter" else "max"
    if kind == "counter" and agg != "sum":
        raise ValueError("counters always aggregate by sum")
    if kind == "gauge" and agg not in ("max", "min", "last"):
        raise ValueError(f"gauge agg must be max|min|last, got {agg!r}")
    d = MetricDef(name=name, kind=kind, unit=unit,
                  description=description, agg=agg)
    _REGISTRY[name] = d
    return d


def lookup(name: str):
    """The MetricDef for ``name``, or None if unregistered."""
    return _REGISTRY.get(name)


def registered() -> dict:
    """Snapshot of the registry (name -> MetricDef)."""
    return dict(_REGISTRY)


def merge_metrics(dst: dict, src: dict, *, kind: str = "counter") -> dict:
    """Merge ``src`` into ``dst`` in place using each metric's declared
    semantics; ``kind`` is the fallback for unregistered names."""
    for name, value in src.items():
        d = _REGISTRY.get(name)
        k = d.kind if d is not None else kind
        if name not in dst:
            dst[name] = value
        elif k == "counter":
            dst[name] = dst[name] + value
        else:
            agg = d.agg if d is not None else "max"
            if agg == "max":
                dst[name] = max(dst[name], value)
            elif agg == "min":
                dst[name] = min(dst[name], value)
            else:                 # last write wins
                dst[name] = value
    return dst


# ---------------------------------------------------------------------------
# Core metric set — solver internals the paper's phase breakdowns track.
# ---------------------------------------------------------------------------

# Fiedler / eigensolvers
register("lanczos_restarts", "counter",
         description="Restarted-Lanczos restart count across solves")
register("lanczos_iters", "counter",
         description="Total Lanczos iterations (all restarts)")
register("inverse_outer_iters", "counter",
         description="Inverse-iteration outer iterations")
register("cg_inner_iters", "counter",
         description="Flex-CG inner iterations inside inverse iteration")
register("fiedler_solves", "counter",
         description="Number of Fiedler vector solves")
register("residual_max", "gauge", agg="max",
         description="Worst eigenpair residual seen in the subtree")
register("amg_levels", "gauge", agg="max",
         description="Deepest AMG/multilevel hierarchy used")
register("multilevel_levels", "gauge", agg="max",
         description="Coarse-to-fine warm-start hierarchy depth")

# Refinement / k-way FM
register("fm_moves", "counter",
         description="k-way FM moves kept after rollback")
register("fm_moves_attempted", "counter",
         description="k-way FM moves attempted")
register("fm_rollbacks", "counter",
         description="k-way FM moves rolled back past the best prefix")
register("fm_passes", "counter",
         description="k-way FM hill-climbing passes executed")
register("refine_moves", "counter",
         description="Boundary-refinement moves applied")
register("refine_sweeps", "counter",
         description="Boundary-refinement sweeps executed")
register("fragments_repaired", "counter",
         description="Disconnected fragments reassigned by repair")
register("forced_moves", "counter",
         description="Repair moves that were balance-forced")

# Multilevel k-way V-cycle (bisect="multilevel")
register("ml_levels", "gauge", agg="max",
         description="Coarsening-ladder depth of the multilevel V-cycle")
register("ml_coarsen_ratio", "gauge", agg="min",
         description="n_coarsest / n_fine of the V-cycle ladder")
register("ml_fm_moves", "counter",
         description="FM moves kept across coarsest polish + all V-cycle "
                     "refinement levels")

# Partition structure / distribution layer
register("edge_cut", "gauge", agg="last",
         description="Edge cut of the partition at this point")
register("halo_words", "counter", unit="words",
         description="Halo exchange words per feature (all shards)")
register("halo_bytes", "counter", unit="bytes",
         description="Halo exchange bytes per feature at f32")
register("halo_max_degree", "gauge", agg="max",
         description="Max neighbor count over shards in the halo plan")
register("sharded_sweeps", "counter",
         description="Device-resident sharded refinement sweeps executed")
register("sharded_gathers", "counter",
         description="Boundary-label all_gather collectives issued by the "
                     "sharded refinement loop (contract: == sharded_sweeps)")
register("sharded_moves", "counter",
         description="Moves applied by sharded refinement sweeps")

# Fault-tolerance guard (repro_torch.guard)
register("guard_retries", "counter",
         description="Seed-perturbed Fiedler re-solves after a failed "
                     "health check")
register("guard_fallbacks", "counter",
         description="Guard escalations past retry: method switches, "
                     "geometric/index fallback vectors, finalize repairs, "
                     "halo plan rebuilds")
register("guard_sanitize_fixes", "counter",
         description="Input defects repaired by sanitize-mode validation")
register("guard_deadline_expired", "counter",
         description="Bisect stages whose guard deadline expired "
                     "(remaining solves go straight to fallback)")


# ---------------------------------------------------------------------------
# Span vocabulary — every span()/timed()/trace() name used in the port
# must be declared here (exact name, or under one of the dynamic
# prefixes); tests/test_torch_obs.py scans the sources for it.
# `expected_span_names` in repro_torch.obs.export derives the per-config
# REQUIRED subset for the manifest check from the same vocabulary.
# ---------------------------------------------------------------------------

SPAN_NAMES = (
    # pipeline skeleton
    "partition", "guard:validate", "guard:finalize",
    # solver engines
    "engine", "solve", "split",
    # multilevel V-cycle
    "coarsen", "coarsest", "finalize",
    # host post chain
    "repair", "refine_sweeps", "repair_refine", "kway_fm",
    # sharded refinement
    "sharded_sweeps_total",
    # serving path
    "serve", "prefill", "decode_step",
)

SPAN_PREFIXES = (
    "pre:",        # pre:<stage>   — pipeline pre stage
    "bisect:",     # bisect:<stage>
    "post:",       # post:<stage>
    "level:",      # level:<N>     — batched-engine tree level
    "mlevel:",     # mlevel:<N>    — multilevel V-cycle ladder level
    "sweep:",      # sweep:<N>     — sharded refinement sweep
)


def span_declared(name: str) -> bool:
    """Is ``name`` part of the declared span vocabulary?"""
    return name in SPAN_NAMES or any(
        name.startswith(p) for p in SPAN_PREFIXES)


def declared_spans() -> tuple:
    """Snapshot of (names, prefixes) — what the drift guard and the
    static analyzer share."""
    return SPAN_NAMES, SPAN_PREFIXES
