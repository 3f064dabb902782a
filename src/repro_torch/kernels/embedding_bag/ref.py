"""Plain PyTorch versions of the embedding bag (K5).

    out[b] = Σ_{i: segments[i] = b} weights[i] · table[indices[i]]

:func:`embedding_bag_ref`: the rows are gathered, multiplied by their
weights in fp32 and summed into a zero ``(n_bags, d)`` fp32 buffer by
``index_add_``, then cast to the table's type: `repro`'s
``embedding_bag_ref`` (``jnp.take`` + ``segment_sum``), with the sum in fp32
as the CUDA kernel takes it.  An empty bag is a zero row (the segment sum's
identity).  On the CPU ``index_add_`` adds in nnz order, the kernel's order
for a bag of at most R entries; on the card it adds with atomics, so there
only bags of one are bit-equal to the kernel.

:func:`embedding_bag_runs_ref`: the same function in the kernel's order
for every bag, on any device: a bag of more than ``run`` entries is cut
into runs of ``run`` entries from its first, each run added in nnz order,
each group of ``group`` runs in run order, the groups in order, every sum
from 0 in fp32 and rounded once (a bag of at most ``run`` entries is one run
of one group: nnz order).  Each step is an elementwise add over all the
runs (groups, bags) at once, so no atomic picks the order: the kernel's
bits on the card and on the CPU alike.
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


def _ordered_sums(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x (n, d) fp32 laid out piece by piece, ``lengths`` (m,) the pieces'
    sizes (sum n) → (m, d): each piece's rows added left to right from 0,
    one elementwise add a position over the pieces that reach it."""
    m = lengths.numel()
    acc = torch.zeros((m, x.shape[1]), dtype=torch.float32, device=x.device)
    if m == 0:
        return acc
    starts = torch.cumsum(lengths, 0) - lengths
    order = torch.argsort(lengths, descending=True, stable=True)
    size, first = lengths[order], starts[order]
    # reach[t]: the pieces (a prefix of ``order``) longer than t
    reach = torch.searchsorted(-size, -torch.arange(
        int(size[0]), device=x.device), right=False).tolist()
    for t, k in enumerate(reach):
        acc[:k] += x[first[:k] + t]
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def embedding_bag_runs_ref(table: torch.Tensor, indices: torch.Tensor,
                           segments: torch.Tensor, n_bags: int,
                           weights: torch.Tensor | None = None, *,
                           run: int, group: int) -> torch.Tensor:
    """The kernel's order (module docstring): table (V, d); indices,
    segments (nnz,) int with segments sorted, in [0, n_bags); weights
    (nnz,) or None (ones); ``run``, ``group`` the kernel's R and G
    (`cuda.run_shape`) → (n_bags, d) of the table's type."""
    d, dev = table.shape[1], table.device
    rows = table.index_select(0, indices.long()).float()
    if weights is not None:
        rows = rows * weights.float()[:, None]
    out = torch.zeros((n_bags, d), dtype=torch.float32, device=dev)
    if indices.numel() == 0:
        return out.to(table.dtype)
    bags, count = torch.unique_consecutive(segments.long(),
                                           return_counts=True)

    def pieces(total, size):
        """Cut each of ``total`` into pieces of ``size`` (the last the
        rest): every piece's length, and the pieces each makes."""
        many = (total + size - 1) // size
        length = torch.full((int(many.sum()),), size, dtype=torch.long,
                            device=dev)
        length[torch.cumsum(many, 0) - 1] = total - (many - 1) * size
        return length, many

    run_len, runs = pieces(count, run)
    group_len, groups = pieces(runs, group)
    part = _ordered_sums(rows, run_len)
    sums = _ordered_sums(_ordered_sums(part, group_len), groups)
    out[bags] = sums
    return out.to(table.dtype)
