"""repro_torch.guard: fault-tolerant partitioning, the port of `repro.guard`.

Validation front door (:mod:`repro_torch.guard.validate`), solver
escalation policy (:mod:`repro_torch.guard.policy`), typed diagnostics
(:mod:`repro_torch.guard.errors`) and the deterministic fault-injection
harness (:mod:`repro_torch.guard.chaos`).  All host NumPy, bit-identical
to `repro`'s; a guarded pipeline run takes the same decisions as
`repro`'s on the same inputs.
"""

from repro_torch.guard import chaos
from repro_torch.guard.errors import (
    KNOWN_CODES,
    GuardError,
    GuardIssue,
    GuardReport,
)
from repro_torch.guard.policy import (
    GuardPolicy,
    SolverGuard,
    absorbable,
    check_output,
    count_disconnected,
    device_fault,
    enforce_output,
    failure_reason,
    fallback_vector,
)
from repro_torch.guard.validate import (
    check_positive_int,
    component_labels,
    pack_components,
    proportional_budgets,
    validate_graph,
    validate_mesh,
    validate_nparts,
)

__all__ = [
    "KNOWN_CODES", "GuardError", "GuardIssue", "GuardReport", "chaos",
    "check_positive_int", "component_labels", "pack_components",
    "proportional_budgets", "validate_graph", "validate_mesh",
    "validate_nparts", "GuardPolicy", "SolverGuard", "absorbable",
    "check_output",
    "count_disconnected", "device_fault", "enforce_output",
    "failure_reason", "fallback_vector",
]
