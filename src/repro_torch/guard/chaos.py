"""Deterministic fault injection (``guard.chaos``), copied from
`repro.guard.chaos`: the same sites, environment variables and firing
hash, so one ``(seed, site, key)`` fires in both packages alike.

Fault *sites* are named hooks in the production code paths:

==================  ========================================================
``solver_nan``      corrupt a Fiedler result with NaNs (any method)
``empty_split``     replace a Fiedler vector with a constant vector, so the
                    sign split would put every node on one side
``cg_divergence``   force the inverse-iteration outer loop to a non-finite
                    Rayleigh quotient (exercises the breakdown path)
``deadline``        make every ``SolverGuard`` deadline appear expired
``halo_truncate``   drop export rows from a freshly built ``HaloPlan``
==================  ========================================================

A site only does anything when *enabled* (via :func:`configure`, the
:func:`overlay` context manager, or the ``REPRO_CHAOS`` env var — a
comma-separated site list, with ``REPRO_CHAOS_SEED`` / ``REPRO_CHAOS_RATE``
alongside).  Firing is a pure function of ``(seed, site, *key)`` — the same
run replays the same faults.  ``rate >= 1`` means an enabled site *always*
fires, so escalation ladders provably exhaust.
"""

from __future__ import annotations

import contextlib
import os

FAULT_SITES = ("solver_nan", "empty_split", "cg_divergence",
               "deadline", "halo_truncate")

_state = {"sites": frozenset(), "seed": 0, "rate": 1.0, "suppress": 0}


def _load_env() -> None:
    raw = os.environ.get("REPRO_CHAOS", "")
    sites = frozenset(s.strip() for s in raw.split(",") if s.strip())
    bad = sites - set(FAULT_SITES)
    if bad:
        raise ValueError(f"REPRO_CHAOS: unknown fault sites {sorted(bad)} "
                         f"(have {FAULT_SITES})")
    _state["sites"] = sites
    _state["seed"] = int(os.environ.get("REPRO_CHAOS_SEED", "0"))
    _state["rate"] = float(os.environ.get("REPRO_CHAOS_RATE", "1.0"))


_load_env()


def configure(sites=(), *, seed: int = 0, rate: float = 1.0) -> None:
    """Enable exactly ``sites`` (an iterable of names; empty disables)."""
    sites = frozenset(sites)
    bad = sites - set(FAULT_SITES)
    if bad:
        raise ValueError(f"unknown fault sites {sorted(bad)} "
                         f"(have {FAULT_SITES})")
    _state["sites"] = sites
    _state["seed"] = int(seed)
    _state["rate"] = float(rate)


def clear() -> None:
    """Disable every fault site."""
    _state["sites"] = frozenset()


def active() -> bool:
    return bool(_state["sites"]) and not _state["suppress"]


def enabled(site: str) -> bool:
    return site in _state["sites"] and not _state["suppress"]


def _mix(*vals) -> int:
    """FNV-1a over the repr of the key tuple — stable across processes."""
    h = 0x811C9DC5
    for v in vals:
        for b in repr(v).encode():
            h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def should_fire(site: str, *key) -> bool:
    """True iff ``site`` is enabled and its seed-keyed draw fires."""
    if not enabled(site):
        return False
    rate = _state["rate"]
    if rate >= 1.0:
        return True
    return (_mix(_state["seed"], site, *key) % 10_000) < rate * 10_000


@contextlib.contextmanager
def suppressed():
    """Temporarily mute every site (used by repair paths rebuilding a
    corrupted artifact — the rebuild must not be re-corrupted)."""
    _state["suppress"] += 1
    try:
        yield
    finally:
        _state["suppress"] -= 1


@contextlib.contextmanager
def overlay(sites, *, seed: int = 0, rate: float = 1.0):
    """Enable ``sites`` for the duration of the block, then restore."""
    saved = dict(_state)
    configure(sites, seed=seed, rate=rate)
    try:
        yield
    finally:
        _state.update({k: saved[k] for k in ("sites", "seed", "rate")})
