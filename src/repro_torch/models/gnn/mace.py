"""MACE (Batatia et al., arXiv:2206.07697): higher-order equivariant
message passing.  Assigned config: 2 layers, 128 channels, l_max 2,
correlation order 3, 8 RBFs, E(3)-ACE basis.

Port of `repro.models.gnn.mace`.  Per layer:
  * one-particle basis A_i = Σ_j R(r_ij) · (h_j ⊗_G Y(r̂_ij))   (as NequIP),
  * higher-order products B^(ν): B¹ = A, B^(ν) = B^(ν−1) ⊗_G A with learned
    per-path channel weights, up to ν = correlation (3),
  * message m_i = Σ_ν Lin_ν(B^(ν)); update h ← Lin(m) + Lin_skip(h),
  * per-layer scalar readout; total energy = Σ over layers and atoms.

`tensor_product_pair` contracts `repro`'s four-operand einsum in a fixed
pairing: the per-path weights into the Gaunt blocks (C, 9, 9, 9), then
the first feature (N, C, 9, 9: 159 MB at the ``molecule`` cell's 3,840
atoms and C = 128), then the second.
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
from repro_torch.models.gnn.equivariant import n_paths, path_tensors_on, tensor_product
from repro_torch.models.gnn.nequip import (
    _edge_geometry,
    _initial_features,
    _per_l_linear,
    _per_l_linear_init,
    graph_sum,
)


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    avg_neighbors: float = 16.0
    d_feat_in: int = 0
    dtype: Any = torch.float32


def tensor_product_pair(f1: torch.Tensor, f2: torch.Tensor,
                        path_w: torch.Tensor) -> torch.Tensor:
    """Node-local TP of two irrep features: (N,C,9)⊗(N,C,9) → (N,C,9).

    path_w: (C, P) learned per-channel, per-path weights.
    """
    GP = path_tensors_on(f1.device, f1.dtype)           # (P, 9, 9, 9)
    Wc = torch.einsum("cp,pijk->cijk", path_w, GP)
    t = torch.einsum("cijk,nci->ncjk", Wc, f1)
    return torch.einsum("ncjk,ncj->nck", t, f2)


def init_mace(cfg: MACEConfig, generator: torch.Generator) -> dict:
    """`repro`'s ``init_mace`` tree, drawn from ``generator``."""
    C, P = cfg.d_hidden, n_paths()

    def one_layer():
        p = {
            "radial": mlp_init(generator, [cfg.n_rbf, 64, C * P], cfg.dtype),
            "mix_A": _per_l_linear_init(generator, C, C, cfg.dtype),
            "skip": _per_l_linear_init(generator, C, C, cfg.dtype),
            "readout": mlp_init(generator, [C, C, 1], cfg.dtype),
        }
        for nu in range(2, cfg.correlation + 1):
            p[f"prod_w{nu}"] = 0.1 * dense_init(generator, (C, P),
                                                dtype=cfg.dtype)
        for nu in range(1, cfg.correlation + 1):
            p[f"mix_B{nu}"] = _per_l_linear_init(generator, C, C, cfg.dtype)
        return p

    p = {
        "species_embed": dense_init(generator, (cfg.n_species, C),
                                    dtype=cfg.dtype),
        "layers": stack_trees([one_layer() for _ in range(cfg.n_layers)]),
    }
    if cfg.d_feat_in:
        p["feat_proj"] = dense_init(generator, (cfg.d_feat_in, C),
                                    dtype=cfg.dtype)
    return p


def mace_layer(cfg: MACEConfig, layer_p: dict, h: torch.Tensor,
               batch: GraphBatch, sh: torch.Tensor, rbf: torch.Tensor):
    N, C, P = h.shape[0], cfg.d_hidden, n_paths()
    radial = mlp_apply(layer_p["radial"], rbf).reshape(-1, C, P)
    msg = tensor_product(gather(h, batch.plan("edge_src")), sh, radial)
    msg = msg * batch.edge_mask[:, None, None]
    A = scatter_sum(msg, batch.plan("edge_dst"), N) / cfg.avg_neighbors
    A = _per_l_linear(layer_p["mix_A"], A)

    # higher-order ACE products: B¹=A, B^ν = B^{ν−1} ⊗_G A
    m = _per_l_linear(layer_p["mix_B1"], A)
    B = A
    for nu in range(2, cfg.correlation + 1):
        B = tensor_product_pair(B, A, layer_p[f"prod_w{nu}"])
        m = m + _per_l_linear(layer_p[f"mix_B{nu}"], B)

    h_new = m + _per_l_linear(layer_p["skip"], h)
    atom_e = mlp_apply(layer_p["readout"], h_new[:, :, 0])[:, 0]
    return h_new, atom_e


def mace_energy(cfg: MACEConfig, params: dict,
                batch: GraphBatch) -> torch.Tensor:
    h = _initial_features(cfg, params, batch)
    sh, rbf = _edge_geometry(cfg, batch)
    atom_es = []
    for i in range(cfg.n_layers):
        h, atom_e = mace_layer(cfg, tree_slice(params["layers"], i), h, batch,
                               sh, rbf)
        atom_es.append(atom_e)
    atom_e = torch.stack(atom_es).sum(0) * batch.node_mask
    return graph_sum(atom_e, batch)


def mace_loss(cfg: MACEConfig, params: dict,
              batch: GraphBatch) -> torch.Tensor:
    e = mace_energy(cfg, params, batch)
    tgt = batch.targets if batch.targets is not None else torch.zeros_like(e)
    return torch.mean((e - tgt) ** 2)
