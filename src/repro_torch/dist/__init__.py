"""repro_torch.dist: the distribution layer (the ported part of `repro.dist`).

* :mod:`repro_torch.dist.partition_aware` — halo sharding plans; a
  partition's edge cut becomes the gather volume of each sweep.
* :mod:`repro_torch.dist.refine_sharded` — device-resident sharded
  boundary refinement over the halo plan: one boundary-label gather and
  one connection-table launch (K4) per sweep, all shards on one card.

Not ported yet: the halo exchange and distributed adjacency matvec, the
collectives, the sharding rules, and a gather across processes.
"""

from repro_torch.dist.partition_aware import (
    HaloPlan,
    gather_features,
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
    "build_frontier_plan",
    "gather_features",
    "kway_sharded_stage",
    "plan_halo_sharding",
    "refine_sharded_host",
    "refine_sharded_stage",
    "run_sharded_sweeps",
    "scatter_features",
    "verify_halo_plan",
]
