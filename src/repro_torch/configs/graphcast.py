"""graphcast [gnn] — encoder-processor-decoder mesh GNN
[arXiv:2212.12794; unverified].

n_layers=16 d_hidden=512 mesh_refinement=6 aggregator=sum n_vars=227.
Adaptation: processor runs on the assigned generic graph (DESIGN.md §6).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.graphcast import GraphCastConfig


def make_config(d_in: int = 227) -> GraphCastConfig:
    return GraphCastConfig(name="graphcast", n_layers=16, d_hidden=512,
                           mesh_refinement=6, n_vars=227, d_in=d_in)


def make_smoke_config() -> GraphCastConfig:
    return GraphCastConfig(name="graphcast-smoke", n_layers=2, d_hidden=32,
                           n_vars=8, d_in=8)


ARCH = ArchDef(
    arch_id="graphcast", family="gnn", source="arXiv:2212.12794; unverified",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES,
)
