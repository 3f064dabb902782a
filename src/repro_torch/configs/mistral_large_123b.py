"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.  Its 123B
parameters are 245 GB in bf16: more than one card holds, so the model is
built only under sharding rules (`models.transformer.build_model`'s
``rules``), each rank holding its slices.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LM_SHAPES, LM_SKIPS
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
        n_kv_heads=8, d_head=128, d_ff=28672, vocab=32768, rope_theta=1e6,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="mistral-large-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_head=16, d_ff=224, vocab=512, dtype=torch.float32,
    )


ARCH = ArchDef(
    arch_id="mistral-large-123b", family="lm",
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES, skips=dict(LM_SKIPS),
)
