"""Solver health policy, escalation ladder, and the output invariant.

The port of `repro.guard.policy`: the same ladder, seeds and repairs, so
a guarded run of the port takes the decisions `repro`'s takes.  One policy
object (:class:`GuardPolicy`) admits every Fiedler solve of the RSB engine
through a :class:`SolverGuard`, which detects breakdown (non-finite
λ/residual, a solver-reported breakdown flag, a degenerate vector whose
sign split would empty one side, a hopelessly stalled residual) and
escalates deterministically:

1. retry with a seed-derived perturbation — the retry seed is a function
   of ``(seed, level, p_lo, attempt)``, so a retry never replays the
   identical failing solve (counted in ``GuardReport.retries``);
2. switch method (lanczos <-> inverse) — counted in ``fallbacks``;
3. drop to the geometric/index fallback vector — always succeeds, counted
   in ``fallbacks`` and tagged in ``GuardReport.degraded``.

The guard carries a per-stage attempt budget and an optional wall-clock
deadline; once the deadline expires every remaining solve goes straight
to the fallback rung.  :func:`enforce_output` is the pipeline's graceful
degradation closer: it guarantees valid labels, connected parts, and the
weight corridor even when every spectral attempt failed.

Where the port does less than `repro`: a re-solve that raises on the
card is not a failed attempt — it raises, whatever the error, and so does
a :func:`device_fault` anywhere (a
`~repro_torch.kernels._build.KernelError`, a CUDA out-of-memory or
accelerator error).  On the card the ladder absorbs what `repro`'s
absorbs apart from exceptions: results that :meth:`SolverGuard.admit`
rejects (chaos faults included) and the deadline.  On the CPU it also
absorbs the solvers' own errors, as `repro` does.  The guard's counts go
to the :class:`GuardReport` and, as `repro`'s, to the active trace
(``guard_retries``, ``guard_fallbacks``, ``guard_deadline_expired``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.guard import chaos
from repro_torch.guard.errors import GuardReport
from repro_torch.kernels._build import KernelError
from repro_torch.mesh.graphs import connected_labels

#: A residual this many times |λ| is garbage, not "slow convergence".
_RESIDUAL_LIMIT = 1e4


def device_fault(exc: BaseException) -> bool:
    """True when ``exc`` is, by its type, a failure of the card or of a
    kernel — the errors no guard catch absorbs: a kernel's build, load or
    launch (:class:`KernelError`), a CUDA out-of-memory and an accelerator
    error."""
    accel = getattr(torch, "AcceleratorError", None)
    types = (KernelError, torch.OutOfMemoryError) + (
        (accel,) if accel is not None else ())
    return isinstance(exc, types)


def absorbable(exc: BaseException, device) -> bool:
    """Whether a guard catch may absorb ``exc`` raised by work on
    ``device``: never a :func:`device_fault`, and nothing raised on the
    card, where an exception is a fault of the port."""
    on_card = device is not None and torch.device(device).type == "cuda"
    return not (on_card or device_fault(exc))


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Attempt budgets and repair switches for one pipeline run."""

    enabled: bool = True
    sanitize: bool = False        # validation repairs instead of raising
    max_retries: int = 1          # seed-perturbed retries per solve
    switch_method: bool = True    # lanczos <-> inverse rung
    deadline: float | None = None  # seconds per bisect stage
    balance_tol: float = 0.05     # corridor used by enforce_output

    @classmethod
    def from_kw(cls, kw: dict | None) -> "GuardPolicy":
        kw = dict(kw or {})
        kw.pop("chaos", None)
        kw.pop("chaos_seed", None)
        kw.pop("chaos_rate", None)
        return cls(**kw)


def corrupt_result(res, *, level: int, p_lo: int, attempt: int = 0):
    """Apply the solver-facing chaos sites to a Fiedler result."""
    if res is None:
        return None
    if chaos.should_fire("solver_nan", level, p_lo, attempt):
        v = np.asarray(res.vector, np.float64).copy()
        v[:: max(1, v.size // 4)] = np.nan
        res = dataclasses.replace(res, vector=v, eigenvalue=float("nan"))
    if chaos.should_fire("empty_split", level, p_lo, attempt):
        v = np.zeros(np.asarray(res.vector).shape, np.float64)
        res = dataclasses.replace(res, vector=v)
    return res


def failure_reason(res, size: int) -> str | None:
    """Why a Fiedler result is unusable, or ``None`` when healthy."""
    if res is None:
        return "exception"
    if getattr(res, "breakdown", False):
        return "breakdown"
    v = np.asarray(res.vector)
    if not np.all(np.isfinite(v)):
        return "nonfinite-vector"
    lam, residual = float(res.eigenvalue), float(res.residual)
    if not (np.isfinite(lam) and np.isfinite(residual)):
        return "nonfinite-eigenpair"
    if size > 1 and float(np.ptp(v)) <= 1e-12 * max(
            1.0, float(np.max(np.abs(v)))):
        return "degenerate-vector"      # sign split would empty one side
    if residual > _RESIDUAL_LIMIT * max(abs(lam), 1e-12):
        return "stalled-residual"
    return None


def fallback_vector(size: int, coords=None) -> np.ndarray:
    """Deterministic last-rung Fiedler surrogate: the longest coordinate
    axis (an RCB-style geometric ordering) or the index ramp."""
    if coords is not None:
        c = np.asarray(coords, np.float64).reshape(size, -1)
        spans = np.ptp(c, axis=0)
        axis = int(np.argmax(spans))
        if float(spans[axis]) > 0:
            return c[:, axis].copy()
    return np.arange(size, dtype=np.float64)


class SolverGuard:
    """Admits every Fiedler solve of one bisect stage through the
    escalation ladder.  Create one per stage run; it carries the stage
    deadline and streams events into the shared :class:`GuardReport`."""

    def __init__(self, policy: GuardPolicy, *, seed: int, method: str,
                 report: GuardReport | None = None, device=None):
        self.policy = policy
        self.device = device      # where the re-solves run (None: host)
        self.seed = int(seed)
        self.method = method
        self.report = report if report is not None else GuardReport()
        self._t0 = time.monotonic()
        self._deadline = (None if policy.deadline is None
                          else self._t0 + float(policy.deadline))
        self._chaos_deadline = chaos.enabled("deadline")

    def expired(self) -> bool:
        if self._chaos_deadline:
            return True
        return (self._deadline is not None
                and time.monotonic() > self._deadline)

    def admit(self, res, *, level: int, p_lo: int, size: int,
              attempt: int = 0):
        """Chaos-corrupt (when enabled) then health-check one result.
        Returns ``(res, why)`` with ``why is None`` for a healthy solve."""
        res = corrupt_result(res, level=level, p_lo=p_lo, attempt=attempt)
        return res, failure_reason(res, size)

    def _mark_deadline(self) -> None:
        if not self.report.deadline_expired:
            self.report.deadline_expired = True
            self.report.degrade("deadline-expired")
            obs.counter_add("guard_deadline_expired", 1)

    def rescue(self, solve_fn, first_why: str, *, level: int, p_lo: int,
               size: int, coords=None):
        """Run the ladder for one failed solve.  ``solve_fn(method, seed)``
        re-solves the node's problem; an exception counts as a failure
        where :func:`absorbable`, and raises otherwise.  Always returns a
        usable FiedlerResult."""
        from repro_torch.core.fiedler import FiedlerResult

        why = first_why
        if not self.expired():
            # Rung 1: seed-perturbed retries with the primary method.
            for attempt in range(1, self.policy.max_retries + 1):
                res = self._attempt(solve_fn, self.method,
                                    level, p_lo, attempt)
                res, why = self.admit(res, level=level, p_lo=p_lo,
                                      size=size, attempt=attempt)
                self.report.retries += 1
                obs.counter_add("guard_retries", 1)
                if why is None:
                    return res
                if self.expired():
                    break
            # Rung 2: switch solver family.
            if self.policy.switch_method and not self.expired():
                alt = "inverse" if self.method == "lanczos" else "lanczos"
                attempt = self.policy.max_retries + 1
                res = self._attempt(solve_fn, alt, level, p_lo, attempt)
                res, why = self.admit(res, level=level, p_lo=p_lo,
                                      size=size, attempt=attempt)
                self.report.fallbacks += 1
                obs.counter_add("guard_fallbacks", 1)
                if why is None:
                    self.report.degrade(
                        f"solver:switched-to-{alt}@L{level}:{p_lo}")
                    return res
        else:
            self._mark_deadline()
        if self.expired():
            self._mark_deadline()
        # Rung 3: deterministic geometric/index fallback — cannot fail.
        vec = fallback_vector(size, coords)
        self.report.fallbacks += 1
        obs.counter_add("guard_fallbacks", 1)
        kind = "geom" if coords is not None else "index"
        self.report.degrade(f"solver:fallback-{kind}@L{level}:{p_lo}"
                            f" ({why})")
        return FiedlerResult(vector=vec, eigenvalue=0.0, residual=0.0,
                             iterations=0, method=f"fallback-{kind}",
                             breakdown=True)

    def _attempt(self, solve_fn, method: str, level: int, p_lo: int,
                 attempt: int):
        from repro_torch.core.rsb import _node_seed
        try:
            return solve_fn(method,
                            _node_seed(self.seed, level, p_lo, attempt))
        except Exception as exc:
            if not absorbable(exc, self.device):
                raise
            return None


# ---------------------------------------------------------------------------
# Output invariant: check + graceful-degradation closer
# ---------------------------------------------------------------------------

def count_disconnected(graph, parts: np.ndarray, nparts: int) -> int:
    """Number of extra fragments beyond one component per non-empty part."""
    rows, cols = graph.rows, graph.indices
    same = parts[rows] == parts[cols]
    # Every component of the same-part-filtered graph lies inside exactly
    # one part, so: fragments = components - non-empty parts.
    labels = connected_labels(graph.n, rows[same], cols[same])
    return int(np.unique(labels).size - np.unique(parts).size)


def check_output(graph, parts, nparts: int, *, weights=None,
                 balance_tol: float = 0.05,
                 expected_disconnected: int = 0) -> list:
    """Problems with a finished labeling (empty list == invariant holds)."""
    n = int(graph.n)
    problems: list = []
    if parts is None or np.asarray(parts).shape != (n,):
        return ["labels-missing"]
    p = np.asarray(parts)
    if not np.issubdtype(p.dtype, np.integer):
        return ["labels-not-integer"]
    if p.size and (p.min() < 0 or p.max() >= nparts):
        return [f"labels-out-of-range [{p.min()}, {p.max()}] "
                f"vs nparts={nparts}"]
    extra = count_disconnected(graph, p, nparts)
    if extra > expected_disconnected:
        problems.append(f"disconnected-parts: {extra} fragments")
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    pw = np.bincount(p, weights=w, minlength=nparts)
    mean = float(w.sum()) / nparts
    cap = (1.0 + balance_tol) * mean
    if float(pw.max(initial=0.0)) > cap * (1.0 + 1e-9):
        problems.append(f"corridor: max part weight {pw.max():.4g} "
                        f"> cap {cap:.4g}")
    return problems


def _balanced_reassign(n: int, nparts: int, weights) -> np.ndarray:
    """Deterministic zero-assumption labeling: contiguous index blocks
    with (approximately) equal weight — the ultimate fallback."""
    w = np.ones(n) if weights is None else \
        np.maximum(np.asarray(weights, np.float64), 0.0)
    cum = np.cumsum(w)
    total = float(cum[-1]) if n else 0.0
    if total <= 0:
        return (np.arange(n, dtype=np.int64) * nparts) // max(n, 1)
    parts = np.minimum((cum - 0.5 * w) * nparts // total,
                       nparts - 1).astype(np.int64)
    return np.maximum(parts, 0)


def enforce_output(graph, parts, nparts: int, *, weights=None,
                   balance_tol: float = 0.05,
                   report: GuardReport | None = None) -> np.ndarray:
    """Force the output invariant: valid labels, connected parts, weight
    corridor.  Mutating repairs are recorded in ``report.degraded`` and
    ``guard_fallbacks``; a no-op when the labeling is already valid."""
    from repro_torch.core.refine import repair_components
    from repro_torch.core.multilevel import _rebalance

    n = int(graph.n)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    p = None if parts is None else np.asarray(parts)
    if p is None or p.shape != (n,) or \
            not np.issubdtype(p.dtype, np.integer) or \
            (p.size and (p.min() < 0 or p.max() >= nparts)):
        p = _balanced_reassign(n, nparts, w)
        if report is not None:
            report.degrade("finalize:reassigned-labels")
            report.fallbacks += 1
        obs.counter_add("guard_fallbacks", 1)
    p = p.astype(np.int64, copy=True)

    mean = float(w.sum()) / nparts
    corridor = ((1.0 - balance_tol) * mean, (1.0 + balance_tol) * mean)

    moved = False
    if count_disconnected(graph, p, nparts) > 0:
        p, _stats = repair_components(graph, p, nparts, weights=weights,
                                      balance_tol=balance_tol)
        moved = True
    pw = np.bincount(p, weights=w, minlength=nparts)
    if float(pw.max(initial=0.0)) > corridor[1] * (1.0 + 1e-9) or \
            float(pw.min(initial=0.0)) < corridor[0] * (1.0 - 1e-9):
        _rebalance(graph, p, nparts, w, corridor)
        p, _stats = repair_components(graph, p, nparts, weights=weights,
                                      balance_tol=balance_tol)
        moved = True
    if moved and report is not None:
        report.degrade("finalize:repaired")
    return p
