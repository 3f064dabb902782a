"""The paper's own workload: parRSB partitioning configurations.

`ParRSBConfig` is `repro.configs.parrsb`'s, field for field, plus the
named partition-pipeline presets (pre → bisect → post; see
``repro_torch.core.pipeline``): every preset of `repro`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParRSBConfig:
    name: str = "parrsb"
    # Table 1–2 analogue: pebble-bed-like mesh, Lanczos vs inverse iteration
    pebble_dims: tuple = (24, 24, 24)
    pebble_pebbles: int = 10
    quality_parts: tuple = (8, 16, 32, 64)
    # Table 4 analogue: weak scaling on cube meshes, E/P held constant
    weak_e_per_p: int = 1000
    weak_parts: tuple = (8, 16, 32, 64, 128)
    lanczos_window: int = 30
    max_restarts: int = 50
    tol: float = 1e-3
    # Post-bisection quality stage (repair + FM boundary refinement)
    refine_sweeps: int = 4
    kway_passes: int = 8
    balance_tol: float = 0.05
    pipeline: str = "default"
    # Multilevel V-cycle knobs (bisect="multilevel"): coarsen to
    # ~coarse_factor*nparts nodes; per-level boundary FM is capped at
    # ml_refine_passes sweeps with a tight stall so refinement stays
    # O(boundary) at every level.
    coarse_factor: int = 8
    ml_refine_passes: int = 2
    ml_stall: int = 32
    # Fault-tolerance guard (repro_torch.guard): None defers to
    # REPRO_GUARD (default on), as in repro.
    guard: bool | None = None


def make_config() -> ParRSBConfig:
    return ParRSBConfig()


def make_smoke_config() -> ParRSBConfig:
    return ParRSBConfig(name="parrsb-smoke", pebble_dims=(8, 8, 8),
                        pebble_pebbles=3, quality_parts=(4,),
                        weak_e_per_p=64, weak_parts=(4, 8))


# ---------------------------------------------------------------------------
# Pipeline presets: named (pre, bisect, post) compositions
# ---------------------------------------------------------------------------

PIPELINE_PRESETS: dict = {
    # The parRSB shape: per-level RCB reorder, batched spectral bisection,
    # repair + FM smoothing.  What `partition()` runs by default.
    "default": dict(pre="rcb", bisect="rsb-batched",
                    post=("repair", "refine")),
    # Raw bisection labels — parity baselines, debugging.
    "raw": dict(pre="rcb", bisect="rsb-batched", post=()),
    # Quality-first: inertial per-level reorder, hill-climbing k-way FM
    # post chain with a deeper climb and tighter corridor.
    "quality": dict(pre="rib", bisect="rsb-batched",
                    post=("repair", "kway"),
                    post_kw=dict(passes=12, balance_tol=0.03)),
    # Geometry-only fast path: RCB labels healed by the post stage — no
    # eigensolves at all.
    "geometric": dict(pre="none", bisect="rcb", post=("repair", "refine")),
    # Recursive reference engine (matrix-free gather-scatter solves),
    # refined — parity testing at full quality.
    "reference": dict(pre="rcb", bisect="rsb-recursive",
                      post=("repair", "refine")),
    # Hill-climbing k-way FM post stage (core/kway.py): negative-gain
    # prefixes + rollback recover cut the greedy sweeps cannot.
    "kway": dict(pre="rcb", bisect="rsb-batched", post=("repair", "kway")),
    # Quality-first k-way: inertial reorder, deeper climb, tighter corridor.
    "quality-kway": dict(pre="rib", bisect="rsb-batched",
                         post=("repair", "kway"),
                         post_kw=dict(passes=12, balance_tol=0.03)),
    # Multilevel k-way V-cycle (core/multilevel.py): coarsen →
    # partition-coarsest → prolong+refine, no eigensolves on the fine
    # graph.  Knobs come from the config (coarse_factor/ml_stall/
    # ml_refine_passes) via make_pipeline.
    "multilevel": dict(pre="none", bisect="multilevel",
                       post=("repair", "kway")),
    # Quality-leaning V-cycle: coarser target (shallower ladder), more
    # refinement per level, deeper final climb.
    "multilevel-quality": dict(pre="none", bisect="multilevel",
                               post=("repair", "kway"),
                               bisect_kw=dict(coarse_factor=16,
                                              refine_passes=4, stall=128),
                               post_kw=dict(passes=12, balance_tol=0.03)),
}


def make_pipeline(preset: str | None = None, *,
                  config: ParRSBConfig | None = None, **overrides):
    """Build a :class:`~repro_torch.core.pipeline.PartitionPipeline` from a
    named preset.  The config supplies the base post-stage knobs
    (``refine_sweeps``/``balance_tol``) and the default preset name
    (``pipeline``); preset-specific ``post_kw`` overrides them and keyword
    overrides win over both (`post_kw`/`bisect_kw` merge, other fields —
    e.g. ``device`` — replace).  The multilevel presets seed ``bisect_kw``
    from the config's V-cycle knobs the same way."""
    from repro_torch.core.pipeline import PartitionPipeline

    cfg = make_config() if config is None else config
    preset = cfg.pipeline if preset is None else preset
    if preset not in PIPELINE_PRESETS:
        raise ValueError(
            f"unknown pipeline preset: {preset!r} "
            f"(have {tuple(PIPELINE_PRESETS)})")
    spec = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in PIPELINE_PRESETS[preset].items()}
    post_kw = dict(sweeps=cfg.refine_sweeps, passes=cfg.kway_passes,
                   balance_tol=cfg.balance_tol)
    post_kw.update(spec.pop("post_kw", {}))
    post_kw.update(overrides.pop("post_kw", {}))
    bisect_kw = {}
    if spec.get("bisect") == "multilevel":
        # V-cycle presets get their base knobs from the config, same
        # layering as post_kw: preset bisect_kw overrides, caller wins.
        bisect_kw = dict(coarse_factor=cfg.coarse_factor,
                         refine_passes=cfg.ml_refine_passes,
                         stall=cfg.ml_stall, balance_tol=cfg.balance_tol)
    bisect_kw.update(spec.pop("bisect_kw", {}))
    bisect_kw.update(overrides.pop("bisect_kw", {}))
    spec.setdefault("guard", cfg.guard)
    spec.update(overrides)
    return PartitionPipeline(post_kw=post_kw, bisect_kw=bisect_kw, **spec)
