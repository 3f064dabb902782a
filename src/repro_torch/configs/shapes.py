"""The LM and recsys input-shape suites (`repro.configs.shapes.LM_SHAPES`
and ``RECSYS_SHAPES``); the GNN suite comes with its models (ROADMAP D3)."""

from __future__ import annotations

from repro_torch.configs.base import ShapeCell

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

RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeCell("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1_000_000}),
}
