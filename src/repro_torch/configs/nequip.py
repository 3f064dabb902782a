"""nequip [gnn] — O(3)-equivariant interatomic potentials
[arXiv:2101.03164; paper].

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.nequip import NequIPConfig


def make_config(d_feat_in: int = 0) -> NequIPConfig:
    return NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                        n_rbf=8, cutoff=5.0, d_feat_in=d_feat_in)


def make_smoke_config() -> NequIPConfig:
    return NequIPConfig(name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2,
                        n_rbf=4, cutoff=5.0)


ARCH = ArchDef(
    arch_id="nequip", family="gnn", source="arXiv:2101.03164; paper",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES,
)
