"""Exporters: JSONL run manifests and Chrome/Perfetto trace JSON.

The port of `repro.obs.export`, under the same ``SCHEMA``: a manifest
the port writes loads into `repro`'s loader and the other way round.

Manifest format (``repro.obs/v1``) — one JSONL file per traced run:

* line 1: ``{"type": "manifest", "schema": "repro.obs/v1", "name": ...,
  "created": ..., "git_sha": ..., "config": {...}, "totals": {...}}``
* one line per span, flattened pre-order:
  ``{"type": "span", "id": N, "parent": M|null, "name": ..., "t0": ...,
  "seconds": ..., "tags": {...}, "counters": {...}, "gauges": {...}}``

``load_manifest`` reverses this exactly (header dict + rebuilt
:class:`~repro_torch.obs.trace.Span` tree), so manifests are both the archival
record under ``runs/`` and the interchange format the benchmark tables
read.  ``to_trace_events`` converts a span tree to the Chrome
``trace_event`` format — open the file at https://ui.perfetto.dev or
``chrome://tracing`` to get the flamegraph.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

from repro_torch.obs.trace import Span

SCHEMA = "repro.obs/v1"

_GIT_SHA: str | None = None


def git_sha(repo_dir: str | None = None) -> str:
    """Current git SHA, cached after first lookup; "unknown" on failure."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            _GIT_SHA = subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=repo_dir or os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=5,
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA = "unknown"
    return _GIT_SHA


def _flatten(root: Span) -> list:
    """Pre-order (span, parent_id) rows with stable integer ids."""
    rows: list = []

    def rec(s: Span, parent) -> None:
        sid = len(rows)
        rows.append((sid, parent, s))
        for c in s.children:
            rec(c, sid)

    rec(root, None)
    return rows


def manifest_lines(root: Span, *, name: str = "run",
                   config: dict | None = None) -> list:
    """The manifest as a list of JSON-able dicts (header first)."""
    header = {
        "type": "manifest",
        "schema": SCHEMA,
        "name": name,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git_sha": git_sha(),
        "config": dict(config or {}),
        "totals": {"seconds": root.seconds,
                   "metrics": root.total_counters()},
    }
    lines = [header]
    for sid, parent, s in _flatten(root):
        lines.append({
            "type": "span", "id": sid, "parent": parent,
            "name": s.name, "t0": s.t0, "seconds": s.seconds,
            "tags": dict(s.tags), "counters": dict(s.counters),
            "gauges": dict(s.gauges),
        })
    return lines


def write_manifest(root: Span, path: str, *, name: str = "run",
                   config: dict | None = None) -> str:
    """Write the JSONL manifest for ``root`` to ``path``; returns path."""
    lines = manifest_lines(root, name=name, config=config)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line, sort_keys=True) + "\n")
    return path


def load_manifest(path: str):
    """Read a JSONL manifest: returns ``(header, root_span)``."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if not rows or rows[0].get("type") != "manifest":
        raise ValueError(f"{path}: not a repro.obs manifest")
    header = rows[0]
    if header.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {header.get('schema')!r} != {SCHEMA!r}")
    spans: dict = {}
    root = None
    for r in rows[1:]:
        if r.get("type") != "span":
            continue
        s = Span(name=r["name"], tags=dict(r.get("tags", {})),
                 t0=r.get("t0", 0.0),
                 counters=dict(r.get("counters", {})),
                 gauges=dict(r.get("gauges", {})))
        s.t1 = s.t0 + r.get("seconds", 0.0)
        spans[r["id"]] = s
        parent = r.get("parent")
        if parent is None:
            root = s
        else:
            spans[parent].children.append(s)
    if root is None:
        raise ValueError(f"{path}: manifest has no root span")
    return header, root


def run_path(runs_dir: str, name: str) -> str:
    """A collision-free manifest path under ``runs_dir``."""
    os.makedirs(runs_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    base = f"{name}-{stamp}"
    path = os.path.join(runs_dir, base + ".jsonl")
    i = 1
    while os.path.exists(path):
        path = os.path.join(runs_dir, f"{base}-{i}.jsonl")
        i += 1
    return path


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace_event export
# ---------------------------------------------------------------------------

def to_trace_events(root: Span, *, pid: int = 1, tid: int = 1) -> dict:
    """Span tree -> Chrome ``trace_event`` JSON (complete "X" events,
    microsecond timestamps relative to the root's t0)."""
    events = []
    base = root.t0
    for _sid, _parent, s in _flatten(root):
        args = {}
        if s.tags:
            args.update({str(k): v for k, v in s.tags.items()})
        if s.counters:
            args.update({str(k): v for k, v in s.counters.items()})
        if s.gauges:
            args.update({str(k): v for k, v in s.gauges.items()})
        events.append({
            "name": s.name, "ph": "X", "cat": "repro",
            "ts": (s.t0 - base) * 1e6, "dur": s.seconds * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace_events(root: Span, path: str, **kw) -> str:
    """Write the Perfetto-loadable trace JSON; returns ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_trace_events(root, **kw), f)
    return path


# ---------------------------------------------------------------------------
# Instrumentation-drift guard
# ---------------------------------------------------------------------------

def expected_span_names(config: dict) -> set:
    """Span names a partition trace MUST contain given its recorded
    pipeline config — the CI drift guard's contract.  Derived from the
    same fields ``PartitionPipeline.run`` stamps into the manifest."""
    names = {"partition"}
    if config.get("guard"):
        names.add("guard:validate")
        names.add("guard:finalize")
    pre = config.get("pre")
    if pre and pre != "none":
        names.add(f"pre:{pre}")
    bisect = config.get("bisect")
    # Per-component dispatch (disconnected input, components != 1) may hand
    # every component a budget of one part — then no spectral solve runs,
    # so only single-component runs guarantee the inner solver spans.
    single_comp = config.get("components", 1) == 1
    if bisect:
        names.add(f"bisect:{bisect}")
        if bisect in ("rsb-batched", "rsb-recursive") and single_comp:
            names.add("solve")
            names.add("split")
        elif bisect == "multilevel" and single_comp:
            # The V-cycle emits mlevel:N per ladder level, but only
            # mlevel:0 is guaranteed by construction (the stage runs the
            # level-0 boundary sweep even when the input needs no ladder).
            # "finalize" wraps the stage's closing repair + rebalance.
            names.update({"coarsen", "coarsest", "mlevel:0", "finalize"})
    for stage in config.get("post", ()) or ():
        names.add(f"post:{stage}")
    return names


def validate_manifest(path: str) -> list:
    """Check a partition manifest for missing instrumentation: every
    stage named in the recorded config must have at least one span.
    Returns the list of problems (empty == valid)."""
    problems: list = []
    try:
        header, root = load_manifest(path)
    except (OSError, ValueError, KeyError) as e:
        return [f"unreadable manifest: {e}"]
    have = {s.name for s in root.walk()}
    for want in sorted(expected_span_names(header.get("config", {}))):
        if want not in have:
            problems.append(f"missing span {want!r} "
                            f"(config={header.get('config')})")
    if root.seconds <= 0:
        problems.append("root span has non-positive duration")
    for s in root.walk():
        if s.t1 < s.t0:
            problems.append(f"span {s.name!r} ends before it starts")
    return problems
