"""Synthetic traffic for every model family: `repro.data.synthetic`'s
`lm_batch`, `token_batches`, `gnn_full_batch`, `molecule_batches` and
`recsys_batches`.

The same NumPy draws from the same seed, so the port and `repro` see the
same tokens, graphs, molecules and item sequences; the batches are torch
tensors on the host (GNN batches: `GraphBatch`, moved with ``.to``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.mesh.graphs import Graph, radius_molecule_batch
from repro_torch.models.gnn.common import GraphBatch


def lm_batch(rng: np.random.Generator, batch: int, seq: int,
             vocab: int) -> dict:
    """Zipf(1.3) tokens with a deterministic bigram drift (a learnable
    signal): ``{"tokens", "labels"}``, each (batch, seq) int32, labels the
    tokens shifted by one."""
    z = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
    drift = (np.cumsum(z, axis=1) * 7) % vocab
    toks = ((z + drift) // 2 % vocab).astype(np.int32)
    return {
        "tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
        "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
    }


def token_batches(batch: int, seq: int, vocab: int, *, seed: int = 0):
    """Endless `lm_batch` draws from one seeded generator."""
    rng = np.random.default_rng(seed)
    while True:
        yield lm_batch(rng, batch, seq, vocab)


def gnn_full_batch(graph: Graph, d_feat: int, d_out: int, *, seed: int = 0,
                   dtype=np.float32) -> GraphBatch:
    """Features = random projection of degree/neighborhood stats; targets =
    1-hop smoothed features (a learnable structural signal)."""
    rng = np.random.default_rng(seed)
    n = graph.n
    feat = rng.normal(size=(n, d_feat)).astype(dtype)
    deg = graph.degrees.astype(dtype)
    feat[:, 0] = (deg - deg.mean()) / max(deg.std(), 1.0)
    tgt = rng.normal(size=(n, d_out)).astype(dtype) * 0.1
    return GraphBatch(
        node_feat=torch.from_numpy(feat),
        edge_src=torch.from_numpy(graph.indices.astype(np.int32)),
        edge_dst=torch.from_numpy(graph.rows.astype(np.int32)),
        node_mask=torch.ones((n,), dtype=torch.float32),
        edge_mask=torch.ones((graph.nnz,), dtype=torch.float32),
        targets=torch.from_numpy(tgt),
    )


def molecule_batches(n_graphs: int, n_nodes: int, n_edges: int, *,
                     seed: int = 0):
    """Batched molecules with synthetic pairwise-potential energies."""
    s = seed
    while True:
        pos, spec, esrc, edst = radius_molecule_batch(
            n_graphs, n_nodes, n_edges, seed=s
        )
        s += 1
        # toy LJ-like target energy per graph
        d = np.linalg.norm(pos[esrc] - pos[edst], axis=1)
        e_edge = 4.0 * ((0.8 / d) ** 12 - (0.8 / d) ** 6)
        gids = np.repeat(np.arange(n_graphs), n_nodes).astype(np.int32)
        e_graph = np.zeros(n_graphs)
        np.add.at(e_graph, gids[esrc], 0.5 * np.clip(e_edge, -5, 5))
        yield GraphBatch(
            node_feat=torch.zeros((pos.shape[0], 0), dtype=torch.float32),
            edge_src=torch.from_numpy(esrc.astype(np.int32)),
            edge_dst=torch.from_numpy(edst.astype(np.int32)),
            node_mask=torch.ones((pos.shape[0],), dtype=torch.float32),
            edge_mask=torch.ones((len(esrc),), dtype=torch.float32),
            positions=torch.from_numpy(pos.astype(np.float32)),
            species=torch.from_numpy(spec.astype(np.int32)),
            graph_ids=torch.from_numpy(gids),
            targets=torch.from_numpy(e_graph.astype(np.float32)),
            n_graphs=n_graphs,
        )


def recsys_batches(batch: int, seq: int, n_items: int, *, seed: int = 0):
    """Endless batches ``{"item_seq", "pos_items", "neg_items"}``, each
    (batch, seq) int32: Zipf(1.2) item popularity, shifted into [1,
    n_items − 1] (0 is the padding item); negatives uniform."""
    rng = np.random.default_rng(seed)
    while True:
        seqs = (rng.zipf(1.2, size=(batch, seq + 1)) % (n_items - 1) + 1).astype(
            np.int32
        )
        neg = (rng.integers(1, n_items, size=(batch, seq))).astype(np.int32)
        yield {
            "item_seq": torch.from_numpy(np.ascontiguousarray(seqs[:, :-1])),
            "pos_items": torch.from_numpy(np.ascontiguousarray(seqs[:, 1:])),
            "neg_items": torch.from_numpy(neg),
        }
