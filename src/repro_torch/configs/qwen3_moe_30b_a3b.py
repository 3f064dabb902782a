"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LM_SHAPES, LM_SKIPS
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=768, vocab=151936, rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, n_shared=0, d_ff_expert=768,
                      capacity_factor=1.25),
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=64, vocab=512, dtype=torch.float32,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff_expert=32,
                      capacity_factor=2.0),
    )


ARCH = ArchDef(
    arch_id="qwen3-moe-30b-a3b", family="lm", source="hf:Qwen/Qwen3-30B-A3B; hf",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES, skips=dict(LM_SKIPS),
)
