"""`repro` objects, handed over as NumPy arrays, rebuilt as the port's.

For the partitioner what carries across is the input and its assembled
operators — the mesh, its dual graph, the ELL Laplacian and the halo
sharding plan; for the LM and SASRec it is the weights
(`lm_params_from_numpy`, `sasrec_params_from_numpy`, and back from the
port's modules: `lm_params_to_numpy`, `sasrec_params_to_numpy`), and for
training the master tree and the AdamW state, both ways
(`tree_from_numpy`, `tree_to_numpy`): the port's trees have `repro`'s
keys and shapes, so a `repro` state resumes in the port and the
reverse.
These builders take exactly the arrays a `repro` object holds
(``graph.indptr``, ``op.cols``, ``plan.export_idx``, ``params["layers"]
["wq"]`` …, as NumPy), so a test can hand both packages the identical
input.  Nothing here imports `repro`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.laplacian import EllLaplacian, ell_operator
from repro_torch.device import resolve_device
from repro_torch.dist.partition_aware import HaloPlan
from repro_torch.mesh.box import HexMesh, derive_edge_face_gids
from repro_torch.mesh.graphs import Graph
from repro_torch.models.recsys.sasrec import SASRec, SASRecConfig
from repro_torch.models.transformer import LMConfig, Transformer


def graph_from_arrays(indptr, indices, weights, n) -> Graph:
    """A `Graph` from CSR arrays (`repro.mesh.graphs.Graph`'s fields)."""
    return Graph(n=int(n),
                 indptr=np.array(indptr, dtype=np.int64),
                 indices=np.array(indices, dtype=np.int64),
                 weights=np.array(weights, dtype=np.float64))


def ell_from_arrays(cols, vals, diag, n, device=None, *,
                    use_kernel: bool = True) -> EllLaplacian:
    """An `EllLaplacian` on ``device`` (default: the card) from the
    row-major (n, width) arrays a `repro.core.laplacian.EllLaplacian`
    holds; the port stores them transposed."""
    return ell_operator(np.asarray(cols), np.asarray(vals), np.asarray(diag),
                        int(n), device=device, use_kernel=use_kernel)


def mesh_from_arrays(vert_gid, coords, weights, n_vert) -> HexMesh:
    """A `HexMesh` from its vertex-id table, centroids and element weights;
    edge and face ids are derived from the vertex ids, as `box_mesh`
    derives them."""
    vert_gid = np.array(vert_gid, dtype=np.int64)
    edge_gid, n_edge, face_gid, n_face = derive_edge_face_gids(vert_gid)
    return HexMesh(vert_gid=vert_gid, edge_gid=edge_gid, face_gid=face_gid,
                   coords=np.array(coords, dtype=np.float64),
                   weights=np.array(weights, dtype=np.float64),
                   n_vert=int(n_vert), n_edge=n_edge, n_face=n_face)


def halo_plan_from_arrays(n, n_shards, n_local, halo, max_edges, block_sizes,
                          shard_of, slot_of, export_idx, export_mask,
                          edge_src, edge_dst, edge_weight,
                          edge_mask) -> HaloPlan:
    """A `HaloPlan` from the fields of `repro.dist.partition_aware.HaloPlan`
    (the same names, in its field order), in the dtypes `_assemble_plan`
    gives them."""
    return HaloPlan(
        n=int(n), n_shards=int(n_shards), n_local=int(n_local),
        halo=int(halo), max_edges=int(max_edges),
        block_sizes=np.array(block_sizes, dtype=np.int64),
        shard_of=np.array(shard_of, dtype=np.int64),
        slot_of=np.array(slot_of, dtype=np.int64),
        export_idx=np.array(export_idx, dtype=np.int64),
        export_mask=np.array(export_mask, dtype=np.float32),
        edge_src=np.array(edge_src, dtype=np.int64),
        edge_dst=np.array(edge_dst, dtype=np.int64),
        edge_weight=np.array(edge_weight, dtype=np.float32),
        edge_mask=np.array(edge_mask, dtype=np.float32))


def _tensors(tree, dev):
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)


def lm_params_from_numpy(cfg: LMConfig, params: dict,
                         device=None) -> Transformer:
    """The port's LM (on ``device``, default the card) with the values of
    `repro`'s parameter tree ``params`` — ``embed``, ``head``,
    ``final_norm`` and the stacked ``layers``, whose FFN is ``ffn`` {wi, wg,
    wo} or, for an MoE config, ``moe`` {router, wi, wg, wo, shared_wi,
    shared_wg, shared_wo} — given with NumPy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``)."""
    return Transformer(cfg, _tensors(params, resolve_device(device)))


def sasrec_params_from_numpy(cfg: SASRecConfig, params: dict,
                             device=None) -> SASRec:
    """The port's `SASRec` (on ``device``, default the card) with the values
    of `repro`'s parameter tree ``params`` — ``item_embed``, ``pos_embed``,
    ``blocks`` (stacked by ``vmap``: leading axis n_blocks), ``final_ln_g``
    and ``final_ln_b`` — given with NumPy leaves."""
    return SASRec(cfg, _tensors(params, resolve_device(device)))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def tree_from_numpy(tree: dict, device=None) -> dict:
    """A tree of `repro`'s with NumPy leaves — a parameter tree (LM:
    `init_params`; SASRec: `init_sasrec`) or an AdamW state {m, v, count}
    — as the port's tree of tensors on ``device`` (default the card),
    keys, shapes and dtypes kept: the fp32 master tree that `loss_fn`,
    `sasrec_train_loss` and `train.fit` take, or the state `adamw_update`
    takes."""
    return _tensors(tree, resolve_device(device))


def tree_to_numpy(tree: dict) -> dict:
    """The port's parameter tree or AdamW state as NumPy arrays in
    `repro`'s layout (the same keys and shapes)."""
    return _numpy(tree)


def lm_params_to_numpy(model: Transformer) -> dict:
    """The reverse of `lm_params_from_numpy`: a `Transformer`'s weights (in
    its compute type) as `repro`'s tree — ``embed``, ``head``,
    ``final_norm`` and ``layers`` stacked over a leading (n_layers,) dim,
    the FFN under ``ffn`` {wi, wg, wo} or ``moe``."""
    trees = []
    for layer in model.layers:
        t = layer.tree()
        if "moe" in t:
            t["moe"] = t["moe"].tree()
        trees.append(_numpy(t))
    return {"embed": _numpy(model.embed), "head": _numpy(model.head),
            "final_norm": _numpy(model.final_norm),
            "layers": _stack_numpy(trees)}


def _stack_numpy(trees: list) -> dict:
    return {k: _stack_numpy([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def sasrec_params_to_numpy(model: SASRec) -> dict:
    """The reverse of `sasrec_params_from_numpy`: a `SASRec`'s weights as
    `repro`'s tree (``blocks`` stacked over n_blocks)."""
    return _numpy(model.tree())
