"""parRSB core in PyTorch: the port of `repro.core` (both RSB engines,
the gather-scatter operator, inverse iteration, k-way FM, the V-cycle)."""

from repro_torch.core.amg import (
    AMG,
    BatchedAMG,
    amg_setup,
    amg_setup_batched,
    coarsen_graph,
)
from repro_torch.core.fiedler import (
    FiedlerResult,
    fiedler_from_graph,
    fiedler_from_graph_batched,
    fiedler_from_mesh,
    fiedler_from_mesh_batched,
    multilevel_warm_start,
)
from repro_torch.core.flexcg import CGResult, flexcg
from repro_torch.core.gather_scatter import (
    GSHandle,
    GSLaplacian,
    aw_apply,
    gs_apply,
    gs_setup,
    unweighted_laplacian,
    weighted_laplacian,
)
from repro_torch.core.inverse_iteration import (
    BatchedInverseIterInfo,
    InverseIterInfo,
    inverse_iteration,
    inverse_iteration_batched,
)
from repro_torch.core.kway import (
    KwayPassRecord,
    KwayStats,
    kway_fm,
    kway_fm_boundary,
    kway_stage,
)
from repro_torch.core.lanczos import (
    BatchedLanczosInfo,
    LanczosInfo,
    lanczos_fiedler,
    lanczos_fiedler_batched,
)
from repro_torch.core.laplacian import (
    EllLaplacian,
    dense_laplacian_np,
    ell_laplacian,
    ell_laplacian_batched,
    fiedler_oracle_np,
)
from repro_torch.core.metrics import (
    PartitionMetrics,
    comm_time_model,
    m2_words,
    partition_metrics,
)
from repro_torch.core.pipeline import (
    PartitionContext,
    PartitionPipeline,
    StageRecord,
    parse_refine,
    partition,
    register_bisect_stage,
    register_post_stage,
    run_post_stages,
)
from repro_torch.core.rcb import rcb_order, rcb_parts, rib_order, rib_parts
from repro_torch.core.refine import (
    PostStats,
    SweepRecord,
    balance_corridor,
    close_with_repair,
    edge_cut,
    refine_boundary,
    refine_stage,
    repair_components,
    repair_refine,
)
from repro_torch.core.rsb import (
    BisectionRecord,
    LevelRecord,
    RSBReport,
    rsb_partition_graph,
    rsb_partition_mesh,
)
from repro_torch.core.sfc import hilbert_index, morton_index, sfc_order, sfc_parts
