"""MeshGraphNet (Pfaff et al., arXiv:2010.03409).

Port of `repro.models.gnn.meshgraphnet`.  Encode-process-decode with
residual edge+node MLP blocks:
    e' = e + MLP_e([e, h_src, h_dst])
    h' = h + MLP_v([h, Σ_{incoming} e'])
Assigned config: 15 layers, d_hidden 128, 2-layer MLPs (+LayerNorm).

The parameter tree is `repro`'s: the per-layer blocks stacked along a
leading ``n_layers`` dim (`repro` inits them under ``jax.vmap`` and runs
them under ``jax.lax.scan``; here a loop takes layer i's slice).  The
gathers and the sum over incoming edges are the fixed-order pair of
`repro_torch.models.gnn.common`, planned once per batch.

``rules`` (`repro`'s ``gnn_rules``; default `NO_SHARD`, the one process):
``batch`` is this rank's stripe of the nodes and edges.  Where `repro`
constrains ``h`` to ``("nodes", None)`` and ``e`` to ``("edges", None)``
the port holds its stripes: a layer all-gathers ``h`` once
(`common.node_table`), both takes read that table, and the sum over
incoming edges reduce-scatters to the rank's nodes; positions are
gathered like features.  The masked mean sums its numerator and
denominator over the node stripes, so every rank returns the global
loss (its gradient the rank's share).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import (
    NO_SHARD,
    ShardRules,
    layer_norm,
    mlp_apply,
    mlp_init,
    stack_trees,
    tree_slice,
)
from repro_torch.models.gnn.common import (
    GraphBatch,
    gather,
    global_rows,
    loss_share,
    node_sum,
    node_table,
    scatter_sum,
)


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_in: int = 3
    d_edge_in: int = 4      # relative displacement + norm (synthesized if absent)
    d_out: int = 3
    dtype: Any = torch.float32

    def mlp_sizes(self, d_in):
        return [d_in] + [self.d_hidden] * self.mlp_layers


def _mlp_ln_init(generator, sizes, dtype):
    return {
        "mlp": mlp_init(generator, sizes, dtype),
        "ln_g": torch.ones((sizes[-1],), dtype=dtype, device=generator.device),
        "ln_b": torch.zeros((sizes[-1],), dtype=dtype,
                            device=generator.device),
    }


def _mlp_ln(p, x):
    y = mlp_apply(p["mlp"], x)
    return layer_norm(y, p["ln_g"], p["ln_b"])


def init_mgn(cfg: MGNConfig, generator: torch.Generator) -> dict:
    """`repro`'s ``init_mgn`` tree, drawn from ``generator`` (on its
    device)."""
    d = cfg.d_hidden
    enc_node = _mlp_ln_init(generator, cfg.mlp_sizes(cfg.d_in), cfg.dtype)
    enc_edge = _mlp_ln_init(generator, cfg.mlp_sizes(cfg.d_edge_in), cfg.dtype)
    layers = stack_trees([{
        "edge": _mlp_ln_init(generator, cfg.mlp_sizes(3 * d), cfg.dtype),
        "node": _mlp_ln_init(generator, cfg.mlp_sizes(2 * d), cfg.dtype),
    } for _ in range(cfg.n_layers)])
    return {
        "enc_node": enc_node,
        "enc_edge": enc_edge,
        "layers": layers,
        "dec": mlp_init(generator, [d, d, cfg.d_out], cfg.dtype),
    }


def interaction_layer(layer_p: dict, h: torch.Tensor, e: torch.Tensor,
                      batch: GraphBatch, rules: ShardRules = NO_SHARD
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One residual edge+node block (MeshGraphNet's and GraphCast's)."""
    n = global_rows(h.shape[0], rules)
    src, dst = batch.plan("edge_src", n, rules), batch.plan("edge_dst", n,
                                                            rules)
    table = node_table(h, rules)
    hs, hd = gather(table, src), gather(table, dst)
    del table             # the backward reads the edges' inputs, not h's
    e = e + _mlp_ln(layer_p["edge"], torch.cat([e, hs, hd], -1))
    e = e * batch.edge_mask[:, None]
    agg = scatter_sum(e, dst, n, rules)
    h = h + _mlp_ln(layer_p["node"], torch.cat([h, agg], -1))
    return h, e


def edge_displacements(batch: GraphBatch,
                       rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """pos[src] − pos[dst] of the batch's (the rank's) edges, the
    positions gathered over the node stripes."""
    pos = node_table(batch.positions, rules)
    n = pos.shape[0]
    return gather(pos, batch.plan("edge_src", n, rules)) - gather(
        pos, batch.plan("edge_dst", n, rules))


def mgn_forward(cfg: MGNConfig, params: dict, batch: GraphBatch,
                rules: ShardRules = NO_SHARD) -> torch.Tensor:
    h = _mlp_ln(params["enc_node"], batch.node_feat.to(cfg.dtype))
    if batch.positions is not None:
        rel = edge_displacements(batch, rules)
        e_in = torch.cat(
            [rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1
        ).to(cfg.dtype)
    else:
        e_in = torch.zeros((batch.edge_src.shape[0], cfg.d_edge_in),
                           dtype=cfg.dtype, device=h.device)
    e = _mlp_ln(params["enc_edge"], e_in)
    for i in range(cfg.n_layers):
        h, e = interaction_layer(tree_slice(params["layers"], i), h, e, batch,
                                 rules)
    return mlp_apply(params["dec"], h)


def masked_mean(err: torch.Tensor, mask: torch.Tensor,
                rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """Σ err / max(Σ mask, 1) over every rank's nodes: the global loss on
    each rank, as its share of the gradient (`common.loss_share`)."""
    num, den = node_sum(err.sum(), rules), node_sum(mask.sum(), rules)
    return loss_share(num / torch.clamp(den, min=1.0), rules)


def mgn_loss(cfg: MGNConfig, params: dict, batch: GraphBatch,
             rules: ShardRules = NO_SHARD) -> torch.Tensor:
    pred = mgn_forward(cfg, params, batch, rules)
    tgt = batch.targets if batch.targets is not None else torch.zeros_like(pred)
    err = ((pred - tgt) ** 2).sum(-1) * batch.node_mask
    return masked_mean(err, batch.node_mask, rules)
