"""Plain PyTorch version of the embedding bag (K5).

    out[b] = Σ_{i: segments[i] = b} weights[i] · table[indices[i]]

The rows are gathered, multiplied by their weights in fp32 and summed into
a zero ``(n_bags, d)`` fp32 buffer by ``index_add_``, then cast to the
table's type: `repro`'s ``embedding_bag_ref`` (``jnp.take`` +
``segment_sum``), with the sum in fp32 as the CUDA kernel takes it.  An
empty bag is a zero row (the segment sum's identity).  On the CPU
``index_add_`` adds in nnz order, the kernel's order; on the card it adds
with atomics, so there only bags of one are bit-equal to the kernel.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      segments: torch.Tensor, n_bags: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, d); indices, segments (nnz,) int with segments in [0,
    n_bags) (sorted or not); weights (nnz,) or None (ones) → (n_bags, d)
    of the table's type."""
    rows = table.index_select(0, indices.long()).float()
    if weights is not None:
        rows = rows * weights.float()[:, None]
    out = torch.zeros((n_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    out.index_add_(0, segments.long(), rows)
    return out.to(table.dtype)
