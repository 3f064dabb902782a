"""The LM input-shape suite (`repro.configs.shapes.LM_SHAPES`); the GNN and
recsys suites come with their models (ROADMAP D2, D3)."""

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
