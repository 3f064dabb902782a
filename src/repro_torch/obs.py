"""Wall-clock timing for the port's stage and level records.

The port carries only the timing contract of `repro.obs` that the stages
and the serve loop read: :func:`timed` is a context manager whose
``.seconds`` is the wall time between enter and exit, and
:func:`percentiles` summarises a list of durations (the decode steps'
p50/p99).  Structural spans, span trees,
counters, run manifests and the Perfetto export are not ported yet.
Device work is asynchronous, so a span around device code measures
wall time only where that code ends in a host sync (the Lanczos solve
does: it reads θ and the residuals back once per restart).
"""

from __future__ import annotations

import time


class _Timer:
    __slots__ = ("name", "tags", "t0", "t1")

    def __init__(self, name: str, tags: dict):
        self.name = name
        self.tags = tags

    def __enter__(self) -> "_Timer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        return False

    @property
    def seconds(self) -> float:
        return max(self.t1 - self.t0, 0.0)


def timed(name: str, **tags) -> _Timer:
    """A named wall-clock timer whose ``.seconds`` the caller reads."""
    return _Timer(name, tags)


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
