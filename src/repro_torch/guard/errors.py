"""Typed guard diagnostics.

One exception class, many machine-readable codes.  ``GuardError`` is what
the validation front door raises in strict mode and what the CLI entry
points catch and pretty-print — ``code`` is a stable kebab-case slug a
caller can branch on, ``details`` carries the numbers (offending counts,
indices, value ranges) so the message never has to be parsed.
"""

from __future__ import annotations

import dataclasses

# The catalog of stable diagnostic codes.  Every literal code passed to
# GuardError/GuardIssue anywhere in src/ must come from this tuple (the
# static analyzer, rule GRD002, enforces it), and the tuple must be
# duplicate-free — callers branch on these strings, so a code's meaning
# must be unique repo-wide.
KNOWN_CODES = (
    # argument validation
    "bad-argument", "bad-nparts",
    # graph structure
    "malformed-csr", "self-loop", "duplicate-edge", "zero-degree-node",
    # values
    "nonfinite-coords", "nonfinite-edge-weight", "nonpositive-edge-weight",
    "bad-node-weight",
    # mesh
    "empty-mesh",
)


class GuardError(ValueError):
    """A precise, actionable input/solver diagnostic.

    Subclasses ``ValueError`` so legacy ``except ValueError`` call sites
    keep working, but carries a stable ``code`` and a ``details`` dict.
    """

    def __init__(self, code: str, message: str, *,
                 details: dict | None = None):
        self.code = str(code)
        self.details = dict(details or {})
        super().__init__(f"[{self.code}] {message}")

    @property
    def message(self) -> str:
        return str(self.args[0]) if self.args else ""

    def diagnostic(self) -> str:
        """Multi-line human rendering for CLI front doors."""
        lines = [f"guard: {self.message}"]
        for k in sorted(self.details):
            lines.append(f"  {k} = {self.details[k]!r}")
        lines.append("  (fix the input, or pass sanitize=True to let the "
                     "guard repair what is repairable)")
        return "\n".join(lines)


@dataclasses.dataclass
class GuardIssue:
    """One defect found by validation (and possibly repaired)."""

    code: str
    message: str
    count: int = 1
    fixed: bool = False

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message,
                "count": int(self.count), "fixed": bool(self.fixed)}


@dataclasses.dataclass
class GuardReport:
    """What the guard saw and did during one pipeline run.

    Attached to ``RSBReport.guard`` and serialized into the run manifest
    config — degradation is observable, never silent.
    """

    validated: bool = False
    sanitized: bool = False
    issues: list = dataclasses.field(default_factory=list)   # [GuardIssue]
    components: int = 1
    retries: int = 0
    fallbacks: int = 0
    sanitize_fixes: int = 0
    deadline_expired: bool = False
    degraded: list = dataclasses.field(default_factory=list)  # [str]

    def record(self, issue: GuardIssue) -> None:
        self.issues.append(issue)
        if issue.fixed:
            self.sanitize_fixes += int(issue.count)

    def degrade(self, what: str) -> None:
        self.degraded.append(str(what))

    @property
    def clean(self) -> bool:
        return (not self.issues and not self.degraded
                and self.retries == 0 and self.fallbacks == 0
                and not self.deadline_expired)

    def to_dict(self) -> dict:
        return {
            "validated": self.validated,
            "sanitized": self.sanitized,
            "issues": [i.to_dict() for i in self.issues],
            "components": int(self.components),
            "retries": int(self.retries),
            "fallbacks": int(self.fallbacks),
            "sanitize_fixes": int(self.sanitize_fixes),
            "deadline_expired": self.deadline_expired,
            "degraded": list(self.degraded),
        }
