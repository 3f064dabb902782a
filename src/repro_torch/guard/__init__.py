"""repro_torch.guard: typed diagnostics and the CLI front-door checks.

Ported so far: all of `repro.guard.errors` (`GuardError`, `GuardIssue`,
`GuardReport`, `KNOWN_CODES`) and `check_positive_int` from
`repro.guard.validate`.  Graph and mesh validation, the solver escalation
policy and the fault-injection harness wait for ROADMAP B5.
"""

from repro_torch.guard.errors import (
    KNOWN_CODES,
    GuardError,
    GuardIssue,
    GuardReport,
)
from repro_torch.guard.validate import check_positive_int

__all__ = ["KNOWN_CODES", "GuardError", "GuardIssue", "GuardReport",
           "check_positive_int"]
