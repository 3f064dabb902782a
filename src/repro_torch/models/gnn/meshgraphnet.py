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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import (
    layer_norm,
    mlp_apply,
    mlp_init,
    stack_trees,
    tree_slice,
)
from repro_torch.models.gnn.common import GraphBatch, gather, scatter_sum


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
                      batch: GraphBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """One residual edge+node block (MeshGraphNet's and GraphCast's)."""
    src, dst = batch.plan("edge_src"), batch.plan("edge_dst")
    hs, hd = gather(h, src), gather(h, dst)
    e = e + _mlp_ln(layer_p["edge"], torch.cat([e, hs, hd], -1))
    e = e * batch.edge_mask[:, None]
    agg = scatter_sum(e, dst, h.shape[0])
    h = h + _mlp_ln(layer_p["node"], torch.cat([h, agg], -1))
    return h, e


def mgn_forward(cfg: MGNConfig, params: dict,
                batch: GraphBatch) -> torch.Tensor:
    h = _mlp_ln(params["enc_node"], batch.node_feat.to(cfg.dtype))
    if batch.positions is not None:
        rel = gather(batch.positions, batch.plan("edge_src")) - gather(
            batch.positions, batch.plan("edge_dst"))
        e_in = torch.cat(
            [rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1
        ).to(cfg.dtype)
    else:
        e_in = torch.zeros((batch.edge_src.shape[0], cfg.d_edge_in),
                           dtype=cfg.dtype, device=h.device)
    e = _mlp_ln(params["enc_edge"], e_in)
    for i in range(cfg.n_layers):
        h, e = interaction_layer(tree_slice(params["layers"], i), h, e, batch)
    return mlp_apply(params["dec"], h)


def mgn_loss(cfg: MGNConfig, params: dict, batch: GraphBatch) -> torch.Tensor:
    pred = mgn_forward(cfg, params, batch)
    tgt = batch.targets if batch.targets is not None else torch.zeros_like(pred)
    err = ((pred - tgt) ** 2).sum(-1) * batch.node_mask
    return err.sum() / torch.clamp(batch.node_mask.sum(), min=1.0)
