"""mace [gnn] — higher-order equivariant message passing (E(3)-ACE)
[arXiv:2206.07697; paper].

n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.mace import MACEConfig


def make_config(d_feat_in: int = 0) -> MACEConfig:
    return MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                      correlation=3, n_rbf=8, cutoff=5.0, d_feat_in=d_feat_in)


def make_smoke_config() -> MACEConfig:
    return MACEConfig(name="mace-smoke", n_layers=2, d_hidden=8, l_max=2,
                      correlation=3, n_rbf=4, cutoff=5.0)


ARCH = ArchDef(
    arch_id="mace", family="gnn", source="arXiv:2206.07697; paper",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES,
)
