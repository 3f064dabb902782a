"""Neighbor sampler for sampled-training GNN cells (GraphSAGE-style fanout).

A copy of `repro.models.gnn.sampler`, bit-identical to it: the same
subgraph from the same graph, seeds and generator.

`minibatch_lg` samples 2-hop neighborhoods (fanout 15-10) of 1024 seed
nodes from a 233k-node graph — a *real* sampler, host-side NumPy (the data
pipeline runs on host), emitting static-shape padded subgraphs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.mesh.graphs import Graph


@dataclasses.dataclass
class SampledSubgraph:
    """Static-shape padded subgraph in *local* node numbering.

    node_ids : (max_nodes,) original node ids (pad: 0)
    node_mask: (max_nodes,) 1.0 for real nodes
    edge_src/edge_dst : (max_edges,) local indices (pad: 0)
    edge_mask: (max_edges,)
    seed_mask: (max_nodes,) 1.0 for the seed (loss) nodes
    """

    node_ids: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    seed_mask: np.ndarray


def subgraph_capacity(batch_nodes: int, fanout: tuple) -> tuple[int, int]:
    """Static (max_nodes, max_edges) for a fanout tree (dense worst case)."""
    nodes, frontier, edges = batch_nodes, batch_nodes, 0
    for f in fanout:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return nodes, edges


def sample_neighbors(
    graph: Graph,
    seeds: np.ndarray,
    fanout: tuple = (15, 10),
    *,
    rng: np.random.Generator | None = None,
) -> SampledSubgraph:
    rng = np.random.default_rng(0) if rng is None else rng
    max_nodes, max_edges = subgraph_capacity(len(seeds), fanout)

    local = {int(s): i for i, s in enumerate(seeds)}
    node_ids = list(int(s) for s in seeds)
    srcs, dsts = [], []
    frontier = np.asarray(seeds, dtype=np.int64)
    for f in fanout:
        next_frontier = []
        for u in frontier:
            nbrs = graph.indices[graph.indptr[u] : graph.indptr[u + 1]]
            if nbrs.size == 0:
                continue
            take = nbrs if nbrs.size <= f else rng.choice(nbrs, size=f, replace=False)
            for v in take:
                v = int(v)
                if v not in local:
                    local[v] = len(node_ids)
                    node_ids.append(v)
                    next_frontier.append(v)
                # message flows sampled-neighbor → center
                srcs.append(local[v])
                dsts.append(local[int(u)])
        frontier = np.asarray(next_frontier, dtype=np.int64)

    n, m = len(node_ids), len(srcs)
    out = SampledSubgraph(
        node_ids=np.zeros(max_nodes, np.int64),
        node_mask=np.zeros(max_nodes, np.float32),
        edge_src=np.zeros(max_edges, np.int32),
        edge_dst=np.zeros(max_edges, np.int32),
        edge_mask=np.zeros(max_edges, np.float32),
        seed_mask=np.zeros(max_nodes, np.float32),
    )
    out.node_ids[:n] = node_ids
    out.node_mask[:n] = 1.0
    out.edge_src[:m] = srcs
    out.edge_dst[:m] = dsts
    out.edge_mask[:m] = 1.0
    out.seed_mask[: len(seeds)] = 1.0
    return out
