"""GraphCast processor (Lam et al., arXiv:2212.12794) — adapted.

Port of `repro.models.gnn.graphcast`.  The original runs encoder
(grid→mesh), a 16-layer message-passing processor on a refinement-6
icosahedral mesh (d_hidden 512), and a decoder (mesh→grid), predicting
227 surface/atmospheric variables.

Adaptation (as `repro`'s): the assigned shape suite supplies generic
graphs (n_nodes, n_edges), so the encoder/decoder become per-node MLPs
(d_feat → 512 → n_vars) and the processor — the dominant compute — runs
on the supplied graph.  Edge MLPs + node MLPs with residuals, exactly the
GraphCast interaction-network block (MeshGraphNet's `interaction_layer`).

``remat`` (default off, `repro`'s program) recomputes each processor
layer in the backward (``torch.utils.checkpoint``, non-reentrant): at
``minibatch_lg``'s 168,960 edges and 169,984 nodes a layer saves several
GB of activations, and 16 of them do not fit one 80 GB card.  The loss
and gradients are bit-identical either way.  Under ``rules`` the
recomputed layer gathers its node table again in the backward (the
table is not saved: it is (N, 512) a layer), which gives the same bits.

``rules``: as MeshGraphNet's (`repro`'s ``gnn_rules``; the layer is its
`interaction_layer`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (
    NO_SHARD,
    ShardRules,
    mlp_apply,
    mlp_init,
    stack_trees,
    tree_slice,
)
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.gnn.meshgraphnet import (
    _mlp_ln,
    _mlp_ln_init,
    interaction_layer,
    masked_mean,
)


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    mesh_refinement: int = 6
    aggregator: str = "sum"
    n_vars: int = 227
    d_in: int = 227
    dtype: Any = torch.float32


def init_graphcast(cfg: GraphCastConfig, generator: torch.Generator) -> dict:
    """`repro`'s ``init_graphcast`` tree, drawn from ``generator``."""
    d = cfg.d_hidden
    enc = _mlp_ln_init(generator, [cfg.d_in, d, d], cfg.dtype)
    enc_edge = _mlp_ln_init(generator, [1, d, d], cfg.dtype)
    layers = stack_trees([{
        "edge": _mlp_ln_init(generator, [3 * d, d, d], cfg.dtype),
        "node": _mlp_ln_init(generator, [2 * d, d, d], cfg.dtype),
    } for _ in range(cfg.n_layers)])
    return {
        "enc": enc,
        "enc_edge": enc_edge,
        "layers": layers,
        "dec": mlp_init(generator, [d, d, cfg.n_vars], cfg.dtype),
    }


def graphcast_forward(cfg: GraphCastConfig, params: dict, batch: GraphBatch,
                      rules: ShardRules = NO_SHARD, *,
                      remat: bool = False) -> torch.Tensor:
    h = _mlp_ln(params["enc"], batch.node_feat.to(cfg.dtype))
    e = _mlp_ln(params["enc_edge"], batch.edge_mask[:, None].to(cfg.dtype))
    for i in range(cfg.n_layers):
        layer_p = tree_slice(params["layers"], i)
        if remat:
            h, e = checkpoint(interaction_layer, layer_p, h, e, batch, rules,
                              use_reentrant=False)
        else:
            h, e = interaction_layer(layer_p, h, e, batch, rules)
    return mlp_apply(params["dec"], h)


def graphcast_loss(cfg: GraphCastConfig, params: dict, batch: GraphBatch,
                   rules: ShardRules = NO_SHARD, *,
                   remat: bool = False) -> torch.Tensor:
    pred = graphcast_forward(cfg, params, batch, rules, remat=remat)
    tgt = batch.targets if batch.targets is not None else torch.zeros_like(pred)
    err = ((pred - tgt) ** 2).mean(-1) * batch.node_mask
    return masked_mean(err, batch.node_mask, rules)
