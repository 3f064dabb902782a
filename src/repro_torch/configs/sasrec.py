"""sasrec [recsys] — self-attentive sequential recommendation
[arXiv:1808.09781; paper].

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50; 10⁶-item table.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys.sasrec import SASRecConfig


def make_config() -> SASRecConfig:
    return SASRecConfig(name="sasrec", n_items=1_000_000, embed_dim=50,
                        n_blocks=2, n_heads=1, seq_len=50, d_ff=50)


def make_smoke_config() -> SASRecConfig:
    return SASRecConfig(name="sasrec-smoke", n_items=1000, embed_dim=16,
                        n_blocks=2, n_heads=1, seq_len=10, d_ff=16)


ARCH = ArchDef(
    arch_id="sasrec", family="recsys", source="arXiv:1808.09781; paper",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=RECSYS_SHAPES,
)
