"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400, MoE 64e top-6.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LM_SHAPES, LM_SKIPS
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=1408, vocab=102400, rope_theta=1e4,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                      capacity_factor=1.25),
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=64, vocab=512, dtype=torch.float32,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                      capacity_factor=2.0),
    )


ARCH = ArchDef(
    arch_id="deepseek-moe-16b", family="lm", source="arXiv:2401.06066; hf",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES, skips=dict(LM_SKIPS),
)
