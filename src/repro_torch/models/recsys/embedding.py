"""EmbeddingBag: ragged multi-hot lookup + reduce per bag.

Port of `repro.models.recsys.embedding`.  ``"sum"`` and ``"mean"`` run on
K5 (`kernels/embedding_bag`): the CUDA kernel on the card, its plain
version on the CPU; ``"max"`` is plain PyTorch, as `repro`'s is jnp.
Correctness does not depend on the segments being sorted: they are sorted
(stably, so each bag keeps its entries' order) before K5, which needs them
sorted.  The result has the table's type (K5's contract; `repro` promotes
with the weights' type).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets_or_segments: torch.Tensor, n_bags: int, *,
                  mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (vocab, dim); indices (nnz,) int; offsets_or_segments (nnz,)
    bag id per index, in [0, n_bags) → (n_bags, dim).  An empty bag is
    zeros in ``"sum"`` and ``"mean"`` and -inf in ``"max"``
    (``segment_max``'s identity)."""
    if mode in ("sum", "mean"):
        s = ops.embedding_bag(table, indices, offsets_or_segments, n_bags,
                              weights=weights, assume_sorted=False)
        if mode == "sum":
            return s
        c = torch.bincount(offsets_or_segments.long(), minlength=n_bags)
        return s / c.clamp(min=1).to(s.dtype)[:, None]
    if mode == "max":
        rows = table.index_select(0, indices.long())
        if weights is not None:
            rows = rows * weights[:, None]
        seg = offsets_or_segments.long()[:, None].expand_as(rows)
        init = torch.full((n_bags, rows.shape[1]), float("-inf"),
                          dtype=rows.dtype, device=rows.device)
        return init.scatter_reduce(0, seg, rows, "amax", include_self=True)
    raise ValueError(mode)
