"""Public dispatch for K5, the embedding bag.

``prefer``:

* ``"auto"`` (default) — the CUDA kernel for CUDA tensors, the plain
  PyTorch version (`ref.embedding_bag_ref`) for CPU tensors;
* ``"cuda"`` — the CUDA kernel; raises for a CPU tensor;
* ``"ref"`` — the plain version on any device.

There is no fallback: on a CUDA tensor a build or launch failure raises.
`repro` pads the row width to 128 lanes for the Pallas kernel; nothing
binds the port to that, so nothing is padded here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_PREFER = ("auto", "cuda", "ref")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segments: torch.Tensor, n_bags: int, *,
                  weights: torch.Tensor | None = None,
                  assume_sorted: bool = True,
                  prefer: str = "auto") -> torch.Tensor:
    """``out[b] = Σ_{segments[i] = b} weights[i] · table[indices[i]]``:
    table (V, d) → (n_bags, d) of its type; an empty bag is a zero row.

    ``weights=None`` means ones; given, they are cast to the table's type
    (the kernel's contract).  The kernel needs ``segments`` sorted: with
    ``assume_sorted=False`` they are sorted here by a stable argsort and
    the indices and weights reordered with them, as `repro`'s ``ops`` does.
    Indices must lie in [0, V) and segments in [0, n_bags)."""
    if prefer not in _PREFER:
        raise ValueError(f"unknown prefer: {prefer!r} (have {_PREFER})")
    nnz = indices.shape[0]
    if weights is None:
        weights = torch.ones((nnz,), dtype=table.dtype, device=table.device)
    weights = weights.to(table.dtype)
    if not assume_sorted:
        order = torch.argsort(segments, stable=True)
        indices, segments, weights = indices[order], segments[order], \
            weights[order]
    if prefer == "ref" or (prefer == "auto" and not table.is_cuda):
        return embedding_bag_ref(table, indices, segments, n_bags,
                                 weights=weights)
    if not table.is_cuda:
        raise ValueError("prefer='cuda' needs CUDA tensors: the CUDA "
                         "embedding bag has no CPU mode")
    return cuda.embedding_bag_cuda(
        table, indices.to(torch.int32).contiguous(),
        segments.to(torch.int32).contiguous(), weights.contiguous(), n_bags)
