"""repro_torch.dist: the distribution layer (`repro.dist` across processes).

* :mod:`repro_torch.dist.group` — the port's stand-in for a JAX mesh
  axis: a `torch.distributed` process group, its ranks, a rank's device,
  the subgroup of the first d ranks, and the collectives the layer calls,
  chosen by the backend's name (gloo on the CPU, and gloo or NCCL on the
  card; gloo moves a card's tensor through the host), also under autograd.
* :mod:`repro_torch.dist.sharding` — the logical-axis rules on a
  `DeviceMesh` (or an abstract `MeshShape`): specs, placements, each
  rank's slice, the LM, GNN and recsys rule tables, and the sharded
  gradients' reduction and norm.
* :mod:`repro_torch.dist.partition_aware` — halo sharding plans; a
  partition's edge cut becomes the gather volume of each sweep; the halo
  exchange and the distributed adjacency matvec (one export gather).
* :mod:`repro_torch.dist.collectives` — the distributed gather-scatter
  Laplacian (paper §5, one all-reduce) and a hand-rolled ring all-reduce.
* :mod:`repro_torch.dist.refine_sharded` — device-resident sharded
  boundary refinement over the halo plan: one boundary-label gather and
  one connection-table launch (K4) per sweep, the shards spread over the
  ranks of a group (one process: all of them on its card).

Deviations from `repro`: across ranks a sweep also gathers its per-shard
scalars and a run gathers its label blocks once
(`refine_sharded`'s docstring), and the matvec gathers its result blocks
so that every rank returns the whole ``y``.
"""

from repro_torch.dist.collectives import dist_lap_apply_allreduce, ring_allreduce
from repro_torch.dist.partition_aware import (
    HaloPlan,
    adjacency_matvec_distributed,
    gather_features,
    halo_exchange,
    plan_halo_sharding,
    scatter_features,
    verify_halo_plan,
)
from repro_torch.dist.refine_sharded import (
    FrontierPlan,
    build_frontier_plan,
    kway_sharded_stage,
    refine_sharded_host,
    refine_sharded_stage,
    run_sharded_sweeps,
)

__all__ = [
    "FrontierPlan",
    "HaloPlan",
    "adjacency_matvec_distributed",
    "build_frontier_plan",
    "dist_lap_apply_allreduce",
    "gather_features",
    "halo_exchange",
    "kway_sharded_stage",
    "plan_halo_sharding",
    "refine_sharded_host",
    "refine_sharded_stage",
    "ring_allreduce",
    "run_sharded_sweeps",
    "scatter_features",
    "verify_halo_plan",
]
