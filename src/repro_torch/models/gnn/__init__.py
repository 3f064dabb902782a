"""GNN architectures: MeshGraphNet, GraphCast, NequIP, MACE.

Port of `repro.models.gnn`.  Message passing is built on an ordered
gather/scatter pair over edge-index arrays (`common`: the same bits on
every call and on the CPU and the card, where ``index_add_`` adds with
atomics); `halo` runs GraphCast across the ranks of a process group on
the partitioner's halo plan.
"""

from repro_torch.models.gnn.common import GraphBatch, segment_softmax
from repro_torch.models.gnn.equivariant import enumerate_paths, gaunt_tensor, sh_l2
from repro_torch.models.gnn.graphcast import (
    GraphCastConfig,
    graphcast_forward,
    graphcast_loss,
    init_graphcast,
)
from repro_torch.models.gnn.mace import MACEConfig, init_mace, mace_energy, mace_loss
from repro_torch.models.gnn.meshgraphnet import (
    MGNConfig,
    init_mgn,
    mgn_forward,
    mgn_loss,
)
from repro_torch.models.gnn.nequip import (
    NequIPConfig,
    init_nequip,
    nequip_energy,
    nequip_loss,
)
from repro_torch.models.gnn.sampler import sample_neighbors
