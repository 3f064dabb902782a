"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LM_SHAPES, LM_SKIPS
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, d_head=64, d_ff=5632, vocab=32000, rope_theta=1e4,
    )


def make_sliding_window_config(window: int = 4096) -> LMConfig:
    """Beyond-table variant; the port does not run it yet (K6 has no
    window), so building a model from it raises."""
    return dataclasses.replace(make_config(), attn="sliding_window", window=window)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="tinyllama-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512, dtype=torch.float32,
    )


ARCH = ArchDef(
    arch_id="tinyllama-1.1b", family="lm", source="arXiv:2401.02385; hf",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES, skips=dict(LM_SKIPS),
)
