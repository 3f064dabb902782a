"""meshgraphnet [gnn] [arXiv:2010.03409; unverified].

n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.meshgraphnet import MGNConfig


def make_config(d_in: int = 3, d_out: int = 3) -> MGNConfig:
    return MGNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                     mlp_layers=2, d_in=d_in, d_out=d_out)


def make_smoke_config() -> MGNConfig:
    return MGNConfig(name="meshgraphnet-smoke", n_layers=2, d_hidden=16,
                     mlp_layers=2, d_in=3, d_out=3)


ARCH = ArchDef(
    arch_id="meshgraphnet", family="gnn", source="arXiv:2010.03409; unverified",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES,
)
