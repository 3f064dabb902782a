"""NequIP (Batzner et al., arXiv:2101.03164): E(3)-equivariant interatomic
potential.  Assigned config: 5 layers, 32 channels, l_max 2, 8 Bessel RBFs,
cutoff 5 Å.

Port of `repro.models.gnn.nequip`.  Per layer:
  * edge harmonics Y(r̂) and radial MLP R(r) → per-path tensor-product
    weights,
  * message m_ij = (h_j ⊗_G Y(r̂_ij)) weighted by R(r_ij)  (channelwise TP),
  * aggregation (Σ_j, normalized by avg. neighbor count),
  * per-l channelwise self-interaction (linear) + residual,
  * gate nonlinearity: SiLU on scalars, sigmoid-gated l>0 irreps.

Readout: per-atom MLP on final scalars → Σ over atoms (per graph).  Every
sum over edges, atoms and species is the fixed-order sum of
`repro_torch.models.gnn.common`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import (
    dense_init,
    mlp_apply,
    mlp_init,
    stack_trees,
    tree_slice,
)
from repro_torch.models.gnn.common import GraphBatch, gather, scatter_sum
from repro_torch.models.gnn.equivariant import (
    L_MAX,
    L_SLICES,
    N_IRREPS,
    bessel_rbf,
    n_paths,
    sh_l2,
    tensor_product,
)


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    avg_neighbors: float = 16.0
    d_feat_in: int = 0          # optional extra scalar features (graph cells)
    dtype: Any = torch.float32


def _per_l_linear_init(generator, c_in, c_out, dtype):
    return {f"l{l}": dense_init(generator, (c_in, c_out), dtype=dtype)
            for l in range(L_MAX + 1)}


def _per_l_linear(p, x):
    """x: (N, C, 9) → per-l channel mixing."""
    outs = []
    for l in range(L_MAX + 1):
        sl = L_SLICES[l]
        outs.append(torch.einsum("nci,cd->ndi", x[:, :, sl], p[f"l{l}"]))
    return torch.cat(outs, dim=-1)


def init_nequip(cfg: NequIPConfig, generator: torch.Generator) -> dict:
    """`repro`'s ``init_nequip`` tree, drawn from ``generator``."""
    C, P = cfg.d_hidden, n_paths()
    layers = stack_trees([{
        "radial": mlp_init(generator, [cfg.n_rbf, 64, C * P], cfg.dtype),
        "self": _per_l_linear_init(generator, C, C, cfg.dtype),
        "skip": _per_l_linear_init(generator, C, C, cfg.dtype),
        "gate": dense_init(generator, (C, 2 * C), dtype=cfg.dtype),
    } for _ in range(cfg.n_layers)])
    p = {
        "species_embed": dense_init(generator, (cfg.n_species, C),
                                    dtype=cfg.dtype),
        "layers": layers,
        "readout": mlp_init(generator, [C, 2 * C, 1], cfg.dtype),
    }
    if cfg.d_feat_in:
        p["feat_proj"] = dense_init(generator, (cfg.d_feat_in, C),
                                    dtype=cfg.dtype)
    return p


def _initial_features(cfg, params, batch: GraphBatch) -> torch.Tensor:
    N = batch.n_nodes
    C = cfg.d_hidden
    scalars = gather(params["species_embed"],
                     batch.plan("species", params["species_embed"].shape[0]))
    if cfg.d_feat_in and batch.node_feat is not None \
            and batch.node_feat.dim() == 2:
        scalars = scalars + batch.node_feat.to(cfg.dtype) @ params["feat_proj"]
    rest = scalars.new_zeros((N, C, N_IRREPS - 1))
    return torch.cat([scalars[:, :, None], rest], dim=-1)


def _edge_geometry(cfg, batch: GraphBatch):
    rel = gather(batch.positions, batch.plan("edge_src")) - gather(
        batch.positions, batch.plan("edge_dst"))
    r = torch.linalg.vector_norm(rel, dim=-1)
    rhat = rel / torch.clamp(r, min=1e-6)[:, None]
    sh = sh_l2(rhat).to(cfg.dtype)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    return sh, rbf


def nequip_layer(cfg: NequIPConfig, layer_p: dict, h: torch.Tensor,
                 batch: GraphBatch, sh: torch.Tensor,
                 rbf: torch.Tensor) -> torch.Tensor:
    N, C = h.shape[0], cfg.d_hidden
    P = n_paths()
    radial = mlp_apply(layer_p["radial"], rbf).reshape(-1, C, P)
    msg = tensor_product(gather(h, batch.plan("edge_src")), sh, radial)
    msg = msg * batch.edge_mask[:, None, None]
    agg = scatter_sum(msg, batch.plan("edge_dst"), N) / cfg.avg_neighbors
    z = _per_l_linear(layer_p["self"], agg) + _per_l_linear(layer_p["skip"], h)
    # gate nonlinearity: SiLU scalars, sigmoid-gated higher irreps
    s = z[:, :, 0]
    gates = s @ layer_p["gate"]
    s_act = torch.nn.functional.silu(s + gates[:, :C])
    vec_gate = torch.sigmoid(gates[:, C:])[:, :, None]
    return torch.cat([s_act[:, :, None], z[:, :, 1:] * vec_gate], dim=-1)


def graph_sum(atom_e: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Per-atom values summed per graph (n_graphs,), in the fixed order."""
    return scatter_sum(atom_e, batch.plan("graph_ids", batch.n_graphs),
                       batch.n_graphs)


def nequip_energy(cfg: NequIPConfig, params: dict,
                  batch: GraphBatch) -> torch.Tensor:
    """Per-graph potential energies (n_graphs,)."""
    h = _initial_features(cfg, params, batch)
    sh, rbf = _edge_geometry(cfg, batch)
    for i in range(cfg.n_layers):
        h = nequip_layer(cfg, tree_slice(params["layers"], i), h, batch, sh,
                         rbf)
    atom_e = mlp_apply(params["readout"], h[:, :, 0])[:, 0] * batch.node_mask
    return graph_sum(atom_e, batch)


def nequip_loss(cfg: NequIPConfig, params: dict,
                batch: GraphBatch) -> torch.Tensor:
    e = nequip_energy(cfg, params, batch)
    tgt = batch.targets if batch.targets is not None else torch.zeros_like(e)
    return torch.mean((e - tgt) ** 2)
