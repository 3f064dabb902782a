"""repro_torch.obs — hierarchical tracing, solver metrics, and profiler
ranges: the port of `repro.obs` (``profiler`` takes the place of
``jaxprof``).

Span trees and counters (:mod:`~repro_torch.obs.trace`), the metric
registry and span vocabulary (:mod:`~repro_torch.obs.registry`), JSONL
manifests and Chrome traces (:mod:`~repro_torch.obs.export`), and
``torch.profiler`` / NVTX ranges (:mod:`~repro_torch.obs.profiler`).
"""

from repro_torch.obs.export import (
    SCHEMA,
    expected_span_names,
    git_sha,
    load_manifest,
    manifest_lines,
    run_path,
    to_trace_events,
    validate_manifest,
    write_manifest,
    write_trace_events,
)
from repro_torch.obs.profiler import annotate, maybe_start_trace, maybe_stop_trace
from repro_torch.obs.registry import (
    SPAN_NAMES,
    SPAN_PREFIXES,
    MetricDef,
    lookup,
    merge_metrics,
    register,
    registered,
    span_declared,
)
from repro_torch.obs.trace import (
    NOOP_SPAN,
    Span,
    counter_add,
    current_span,
    disabled,
    gauge_max,
    gauge_set,
    obs_enabled,
    percentiles,
    render,
    set_enabled,
    span,
    stopwatch,
    timed,
    trace,
)

__all__ = [
    "NOOP_SPAN", "Span", "counter_add", "current_span", "disabled",
    "gauge_max", "gauge_set", "obs_enabled", "percentiles", "render",
    "set_enabled", "span", "stopwatch", "timed", "trace",
    "MetricDef", "SPAN_NAMES", "SPAN_PREFIXES", "lookup", "merge_metrics",
    "register", "registered", "span_declared",
    "SCHEMA", "expected_span_names", "git_sha", "load_manifest",
    "manifest_lines", "run_path", "to_trace_events", "validate_manifest",
    "write_manifest", "write_trace_events",
    "annotate", "maybe_start_trace", "maybe_stop_trace",
]
