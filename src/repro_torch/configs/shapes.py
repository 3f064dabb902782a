"""The input-shape suites (`repro.configs.shapes`): ``LM_SHAPES``,
``GNN_SHAPES`` and ``RECSYS_SHAPES``."""

from __future__ import annotations

from repro_torch.configs.base import ShapeCell
from repro_torch.models.gnn.sampler import subgraph_capacity

LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train",
                          {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeCell("prefill_32k", "prefill",
                             {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeCell("decode_32k", "decode",
                            {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeCell("long_500k", "decode",
                           {"seq_len": 524288, "global_batch": 1}),
}

# long_500k needs sub-quadratic attention; the LM archs are pure
# full-attention (GQA), so the cell is skipped.
LM_SKIPS = {
    "long_500k": "pure full-attention arch (assignment rule: skip; "
                 "see DESIGN.md §6)",
}

_MB_NODES, _MB_EDGES = subgraph_capacity(1024, (15, 10))

GNN_SHAPES = {
    "full_graph_sm": ShapeCell("full_graph_sm", "train",
                               {"n_nodes": 2708, "n_edges": 10556,
                                "d_feat": 1433}),
    "minibatch_lg": ShapeCell("minibatch_lg", "train",
                              {"n_nodes": 232965, "n_edges": 114615892,
                               "batch_nodes": 1024, "fanout": (15, 10),
                               "sub_nodes": _MB_NODES, "sub_edges": _MB_EDGES,
                               "d_feat": 602}),
    "ogb_products": ShapeCell("ogb_products", "train",
                              {"n_nodes": 2449029, "n_edges": 61859140,
                               "d_feat": 100}),
    "molecule": ShapeCell("molecule", "train",
                          {"n_nodes": 30, "n_edges": 64, "batch": 128}),
}

RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeCell("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1_000_000}),
}
