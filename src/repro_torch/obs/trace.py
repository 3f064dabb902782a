"""Hierarchical tracing: the span tree every pipeline stage writes into.

The port of `repro.obs.trace`, with the same names, semantics and
``REPRO_OBS`` switch (``off``, ``0``, ``false``, ``no`` disable; anything
else enables — the default), so one environment sets both packages alike.

* :func:`trace` — opens a **root** span.  ``PartitionPipeline.run`` wraps
  each partition call in one (``partition``) and the serve loop its run
  (``serve``); the completed tree lands on ``PartitionContext.trace`` and
  is what the exporters (:mod:`repro_torch.obs.export`) serialize.  Inside
  an active trace it nests as an ordinary child span.
* :func:`timed` — a span whose ``.seconds`` the caller consumes (stage,
  level and solve records).  It ALWAYS measures wall time: disabled or
  outside a trace it is a two-``perf_counter`` :class:`_Timer`, so every
  report field is populated whether tracing is on or off.
* :func:`span` — pure structural annotation; nothing reads its time.
  Disabled (or outside any trace) it returns the shared :data:`NOOP_SPAN`:
  the fast path allocates nothing and tests one module-level bool.
* :func:`stopwatch` — a wall timer that never records a span, for the
  port's own report fields (device seconds, reorder and dual-graph
  seconds) that have no span in `repro`'s vocabulary, so the span tree
  stays `repro`'s.

Counters and gauges (:func:`counter_add`, :func:`gauge_set`,
:func:`gauge_max`) write into the *innermost active span* and merge over
subtrees with the registry's semantics (:mod:`repro_torch.obs.registry`).
Every value they take is a host number the caller already has: no obs
call reads a device tensor, so tracing adds no device-to-host copy and no
synchronisation to the device loops.

Device work is asynchronous, so a span around device code measures wall
time only where that code ends in a host sync (the Lanczos solve does: it
reads θ and the residuals back once per restart).  The device-side view
of the same names comes from :mod:`repro_torch.obs.profiler`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "on").strip().lower() not in (
        "off", "0", "false", "no")


class _State:
    __slots__ = ("enabled", "stack")

    def __init__(self):
        self.enabled = _env_enabled()
        self.stack: list = []     # innermost active span is stack[-1]


_STATE = _State()


def obs_enabled() -> bool:
    """Is the tracing layer on (``REPRO_OBS`` / :func:`set_enabled`)?"""
    return _STATE.enabled


def set_enabled(flag: bool) -> bool:
    """Flip tracing at runtime; returns the previous setting."""
    prev = _STATE.enabled
    _STATE.enabled = bool(flag)
    return prev


@contextlib.contextmanager
def disabled():
    """Run a block with tracing off (the ``REPRO_OBS=off`` escape hatch,
    scoped): spans become no-ops/timers, nothing is recorded."""
    prev = set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


def current_span():
    """The innermost active span, or None (no trace open / disabled)."""
    return _STATE.stack[-1] if _STATE.stack else None


# ---------------------------------------------------------------------------
# Span tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Span:
    """One timed node of the trace tree.

    Use as a context manager: ``__enter__`` stamps ``t0`` and links the
    span under the innermost active span (if any); ``__exit__`` stamps
    ``t1``.  ``counters`` accumulate sums, ``gauges`` record last-written
    values; both are merged over subtrees with the registry's semantics.
    """

    name: str
    tags: dict = dataclasses.field(default_factory=dict)
    t0: float = 0.0
    t1: float = 0.0
    children: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    gauges: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def __enter__(self) -> "Span":
        stack = _STATE.stack
        if stack:
            stack[-1].children.append(self)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        stack = _STATE.stack
        if stack and stack[-1] is self:
            stack.pop()
        else:                      # mispaired exit: drop self wherever it is
            try:
                stack.remove(self)
            except ValueError:
                pass
        return False

    # -- tree traversal -----------------------------------------------------

    def walk(self):
        """Depth-first pre-order iteration over the subtree."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str):
        """First span named ``name`` in the subtree (pre-order), or None."""
        for s in self.walk():
            if s.name == name:
                return s
        return None

    def find_all(self, name: str) -> list:
        return [s for s in self.walk() if s.name == name]

    def total_counters(self) -> dict:
        """Counters + gauges merged over the whole subtree (registry
        semantics: counters sum, gauges max/last/min)."""
        from repro_torch.obs.registry import merge_metrics

        out: dict = {}
        for s in self.walk():
            merge_metrics(out, s.counters, kind="counter")
            merge_metrics(out, s.gauges, kind="gauge")
        return out

    # -- (de)serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        """Nested JSON-able form (inverse: :meth:`from_dict`)."""
        d = {"name": self.name, "t0": self.t0, "seconds": self.seconds}
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.counters:
            d["counters"] = dict(self.counters)
        if self.gauges:
            d["gauges"] = dict(self.gauges)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        s = cls(name=d["name"], tags=dict(d.get("tags", {})),
                t0=d.get("t0", 0.0),
                counters=dict(d.get("counters", {})),
                gauges=dict(d.get("gauges", {})))
        s.t1 = s.t0 + d.get("seconds", 0.0)
        s.children = [cls.from_dict(c) for c in d.get("children", [])]
        return s


class _Timer:
    """Disabled-mode stand-in for :func:`timed`: measures wall time,
    records nothing.  Keeps every pre-obs report field populated when
    ``REPRO_OBS=off``."""

    __slots__ = ("t0", "t1")

    def __enter__(self) -> "_Timer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        return False

    @property
    def seconds(self) -> float:
        return max(self.t1 - self.t0, 0.0)


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path of :func:`span`.
    One module-level instance; entering/exiting allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @property
    def seconds(self) -> float:
        return 0.0


NOOP_SPAN = _NoopSpan()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def trace(name: str, **tags):
    """Open a span that may ROOT a new trace (use for whole-operation
    scopes: one ``partition()`` call, one serve run).  Returns the
    :class:`Span` — keep it; the completed tree is what the exporters
    consume.  Disabled: a :class:`_Timer` (callers may still read
    ``.seconds``; ``PartitionContext.trace`` stays None-equivalent)."""
    if _STATE.enabled:
        return Span(name=name, tags=tags)
    return _Timer()


def stopwatch() -> _Timer:
    """A wall timer that records nothing, traced or not: for report
    fields whose span `repro` does not have."""
    return _Timer()


def timed(name: str, **tags):
    """A span whose ``.seconds`` the caller reads (report timings).
    Records into the active trace when one is open; otherwise — or with
    observability disabled — it is a plain two-perf_counter timer, so the
    measurement survives ``REPRO_OBS=off`` bit-for-bit."""
    if _STATE.enabled and _STATE.stack:
        return Span(name=name, tags=tags)
    return _Timer()


def span(name: str, **tags):
    """Pure structural annotation (nothing reads its time).  Disabled or
    outside any trace this is the zero-allocation fast path: the shared
    :data:`NOOP_SPAN` singleton."""
    if _STATE.enabled and _STATE.stack:
        return Span(name=name, tags=tags)
    return NOOP_SPAN


def counter_add(name: str, value: float = 1.0) -> None:
    """Accumulate ``value`` into the innermost active span's counter
    ``name``.  No-op (one bool test) when disabled or outside a trace."""
    stack = _STATE.stack
    if not stack:
        return
    c = stack[-1].counters
    c[name] = c.get(name, 0.0) + value


def gauge_set(name: str, value) -> None:
    """Set gauge ``name`` on the innermost active span (last write wins
    within a span; subtree merges follow the registry's gauge agg)."""
    stack = _STATE.stack
    if not stack:
        return
    stack[-1].gauges[name] = value


def gauge_max(name: str, value) -> None:
    """Raise gauge ``name`` on the innermost active span to at least
    ``value`` (running max within the span — e.g. worst residual)."""
    stack = _STATE.stack
    if not stack:
        return
    g = stack[-1].gauges
    g[name] = value if name not in g else max(g[name], value)


# ---------------------------------------------------------------------------
# Rendering (the examples' indented stage/level breakdown)
# ---------------------------------------------------------------------------

def render(root, *, max_depth: int = 4, min_share: float = 0.005) -> str:
    """Indented span-tree summary: name, wall seconds, % of the root's
    wall, and any counters — the human-readable flamegraph.  Subtrees
    below ``min_share`` of the root wall or deeper than ``max_depth``
    are elided (noted as ``…``)."""
    if root is None or not isinstance(root, Span):
        return "(no trace recorded — REPRO_OBS=off?)"
    total = max(root.seconds, 1e-12)
    lines: list = []

    def fmt_extras(s: Span) -> str:
        bits = []
        for k, v in list(s.tags.items())[:4]:
            bits.append(f"{k}={v}")
        for k, v in list(s.counters.items())[:4]:
            vv = int(v) if float(v).is_integer() else round(float(v), 3)
            bits.append(f"{k}={vv}")
        return ("  [" + " ".join(bits) + "]") if bits else ""

    def rec(s: Span, depth: int) -> None:
        share = s.seconds / total
        lines.append(f"{'  ' * depth}{s.name:<24s}"
                     f"{s.seconds * 1e3:9.1f} ms  {share:6.1%}"
                     f"{fmt_extras(s)}")
        if depth + 1 > max_depth:
            if s.children:
                lines.append(f"{'  ' * (depth + 1)}…")
            return
        elided = 0
        for c in s.children:
            if c.seconds / total >= min_share:
                rec(c, depth + 1)
            else:
                elided += 1
        if elided:
            lines.append(f"{'  ' * (depth + 1)}… ({elided} spans "
                         f"< {min_share:.1%} of wall)")

    rec(root, 0)
    return "\n".join(lines)


def percentiles(seconds: list, qs=(0.5, 0.99)) -> dict:
    """p50/p99-style summary of a list of durations (serve-path span
    histograms).  Nearest-rank; empty input → zeros."""
    if not seconds:
        return {f"p{int(q * 100)}": 0.0 for q in qs}
    xs = sorted(seconds)
    out = {}
    for q in qs:
        k = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        out[f"p{int(q * 100)}"] = xs[k]
    return out
