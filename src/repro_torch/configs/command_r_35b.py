"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LM_SHAPES, LM_SKIPS
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="command-r-35b", n_layers=40, d_model=8192, n_heads=64,
        n_kv_heads=8, d_head=128, d_ff=22528, vocab=256000, rope_theta=8e6,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="command-r-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=176, vocab=1024, dtype=torch.float32,
    )


ARCH = ArchDef(
    arch_id="command-r-35b", family="lm",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES, skips=dict(LM_SKIPS),
)
