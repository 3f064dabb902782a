"""Partition-aware (halo) GraphCast message passing across the ranks of a
process group — the port of `repro.models.gnn.halo`, where `repro` runs
it under ``shard_map``.

Layout (from `repro_torch.dist.partition_aware.HaloPlan`): every shard owns
a contiguous node block (``n_local``) and the incoming edges of those
nodes; remote sources resolve into an all-gathered ``(P·halo, d)`` export
buffer.  One collective per layer (`halo_exchange`: the export gather)
replaces a full-activation all-reduce — volume drops from O(N·d) to
O(P·halo·d), i.e. proportional to the partition's edge cut: the
partitioner's min-cut objective is the layer's communication volume.

Rank r of the group runs shard r (``HaloBatch.shard(r)``).  The loss is
differentiable across the ranks: the exchange's backward all-reduces the
gradient of the gathered buffer and keeps this rank's rows, and the
loss's ``psum`` passes its gradient through unchanged, so each rank's
parameter gradient is its part and `all_reduce_sum` of them is the
gradient of the full-graph loss.  Not ported: ``make_halo_batch_abstract``
(the dry-run's shapes; the port has no dry run).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist import group as dist_group
from repro_torch.dist.partition_aware import HaloPlan, halo_exchange, scatter_features
from repro_torch.models.common import mlp_apply, tree_slice
from repro_torch.models.gnn.common import SegmentPlan, gather, scatter_sum, segment_plan
from repro_torch.models.gnn.graphcast import GraphCastConfig
from repro_torch.models.gnn.meshgraphnet import _mlp_ln

_FIELDS = ("node_feat", "node_mask", "targets", "export_idx", "export_mask",
           "edge_src", "edge_dst", "edge_mask")


@dataclasses.dataclass
class HaloBatch:
    """Per-shard arrays (leading dim = n_shards; `shard` strips it)."""

    node_feat: torch.Tensor     # (P, n_local, F)
    node_mask: torch.Tensor     # (P, n_local)
    targets: torch.Tensor       # (P, n_local, d_out)
    export_idx: torch.Tensor    # (P, halo)
    export_mask: torch.Tensor   # (P, halo)
    edge_src: torch.Tensor      # (P, max_edges) combined index
    edge_dst: torch.Tensor      # (P, max_edges)
    edge_mask: torch.Tensor     # (P, max_edges)
    plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def shard(self, r: int) -> "HaloBatch":
        """Shard ``r``'s arrays, its leading dim stripped."""
        return HaloBatch(**{f: getattr(self, f)[r] for f in _FIELDS})

    def plan(self, field: str, n: int) -> SegmentPlan:
        """The fixed-order plan of one shard's index ``field`` over ``n``
        rows, built at first use."""
        key = (field, n)
        if key not in self.plans:
            self.plans[key] = segment_plan(getattr(self, field), n)
        return self.plans[key]


def halo_batch_from_plan(plan: HaloPlan, node_feat, targets,
                         device=None) -> HaloBatch:
    """Concrete HaloBatch on ``device`` (None: the card) from global
    ``(n, F)`` features and ``(n, d_out)`` targets."""
    dev = resolve_device(device)
    nf = scatter_features(plan, np.asarray(node_feat))
    tg = scatter_features(plan, np.asarray(targets))
    mask = np.zeros((plan.n_shards, plan.n_local), np.float32)
    for s in range(plan.n_shards):
        mask[s, : int(plan.block_sizes[s])] = 1.0

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dev, dtype) if dtype is not None else t.to(dev)

    return HaloBatch(
        node_feat=put(nf), node_mask=put(mask), targets=put(tg),
        export_idx=put(plan.export_idx, torch.int32),
        export_mask=put(plan.export_mask),
        edge_src=put(plan.edge_src, torch.int32),
        edge_dst=put(plan.edge_dst, torch.int32),
        edge_mask=put(plan.edge_mask),
    )


class _PSum(torch.autograd.Function):
    """``psum`` whose backward passes the gradient through: every rank
    differentiates the same summed loss from its own part."""

    @staticmethod
    def forward(ctx, x, group):
        return dist_group.all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _group(group):
    grp = dist_group.active(group)
    if grp is None:
        raise ValueError("the halo GraphCast needs a process group: "
                         "torch.distributed is not initialized")
    return grp


def _halo_layer(layer_p: dict, h: torch.Tensor, combined: torch.Tensor,
                e: torch.Tensor, b: HaloBatch, src: SegmentPlan,
                dst: SegmentPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """One processor layer on a shard, after its exchange: local work
    only."""
    hs = gather(combined, src)
    hd = gather(h, dst)
    e = e + _mlp_ln(layer_p["edge"], torch.cat([e, hs, hd], -1))
    e = e * b.edge_mask[:, None]
    agg = scatter_sum(e, dst, h.shape[0])
    h = h + _mlp_ln(layer_p["node"], torch.cat([h, agg], -1))
    return h * b.node_mask[:, None], e


def graphcast_halo_local(cfg: GraphCastConfig, params: dict, b: HaloBatch,
                         group=None, *, remat: bool = False) -> torch.Tensor:
    """Forward on ONE shard's block ``b`` (`HaloBatch.shard` of this rank)
    across ``group`` (None: the default group): (n_local, n_vars).
    ``remat`` (default off, `repro`'s program) recomputes each layer's
    local work in the backward, as `graphcast_forward`'s; the exchange
    stays outside the recomputed part, so the backward runs no collective
    twice.  The same bits either way."""
    grp = _group(group)
    n_local = b.node_feat.shape[0]
    n_combined = n_local + dist_group.size(grp) * b.export_idx.shape[0]
    src = b.plan("edge_src", n_combined)
    dst = b.plan("edge_dst", n_local)
    export_idx = b.export_idx.long()
    h = _mlp_ln(params["enc"], b.node_feat.to(cfg.dtype))
    h = h * b.node_mask[:, None]
    e = _mlp_ln(params["enc_edge"], b.edge_mask[:, None].to(cfg.dtype))
    for i in range(cfg.n_layers):
        layer_p = tree_slice(params["layers"], i)
        combined = halo_exchange(h, export_idx, b.export_mask, grp)
        if remat:
            h, e = checkpoint(_halo_layer, layer_p, h, combined, e, b, src,
                              dst, use_reentrant=False)
        else:
            h, e = _halo_layer(layer_p, h, combined, e, b, src, dst)
    return mlp_apply(params["dec"], h)


def graphcast_halo_loss(cfg: GraphCastConfig, params: dict, b: HaloBatch,
                        group=None, *, remat: bool = False) -> torch.Tensor:
    """`repro`'s halo loss: the masked mean squared error over every
    rank's nodes (the same value on every rank)."""
    grp = _group(group)
    pred = graphcast_halo_local(cfg, params, b, grp, remat=remat)
    err = ((pred - b.targets) ** 2).mean(-1) * b.node_mask
    num = _PSum.apply(err.sum().reshape(1), grp)
    den = dist_group.all_reduce_sum(b.node_mask.sum().reshape(1), grp)
    return (num / torch.clamp(den, min=1.0))[0]
