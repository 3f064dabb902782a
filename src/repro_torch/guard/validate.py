"""Validation front door: scalar / CLI checks.

Only `check_positive_int` (`repro.guard.validate:31`) is ported; graph and
mesh validation with sanitizing repair wait for ROADMAP B5.
"""

from __future__ import annotations

from repro_torch.guard.errors import GuardError


def check_positive_int(name: str, value, *, minimum: int = 1,
                       maximum: int | None = None) -> int:
    """CLI front-door check: ``value`` must be an int >= ``minimum``."""
    try:
        v = int(value)
    except (TypeError, ValueError):
        raise GuardError("bad-argument",
                         f"{name} must be an integer, got {value!r}",
                         details={"name": name, "value": value}) from None
    if v != float(value) or v < minimum or (maximum is not None
                                            and v > maximum):
        lo_hi = f">= {minimum}" if maximum is None else \
            f"in [{minimum}, {maximum}]"
        raise GuardError("bad-argument",
                         f"{name} must be {lo_hi}, got {value!r}",
                         details={"name": name, "value": value,
                                  "minimum": minimum, "maximum": maximum})
    return v
