"""Public dispatch for the connection-table kernels (K3 flat, K4 batched).

``prefer``:

* ``"auto"`` (default) — the CUDA kernel for CUDA tensors, the plain
  PyTorch slot loop for CPU tensors;
* ``"kernel"`` — the CUDA kernel; raises for a CPU tensor;
* ``"ref"`` — the plain PyTorch slot loop on any device.

There is no fallback: on a CUDA tensor a build or launch failure raises.
An empty boundary (B = 0) or empty rows (w = 0) give a zero table, as in
`repro`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum import cuda
from repro_torch.kernels.segment_sum.ref import (
    connection_table_batched_ref,
    connection_table_ref,
)

_PREFER = ("auto", "kernel", "ref")


def _use_kernel(t: torch.Tensor, prefer: str) -> bool:
    if prefer not in _PREFER:
        raise ValueError(f"unknown prefer: {prefer!r} (have {_PREFER})")
    if prefer == "ref" or (prefer == "auto" and not t.is_cuda):
        return False
    if not t.is_cuda:
        raise ValueError("prefer='kernel' needs CUDA tensors: the CUDA "
                         "connection table has no CPU mode")
    return True


def connection_table(labels: torch.Tensor, cols: torch.Tensor,
                     wts: torch.Tensor, nparts: int, *,
                     prefer: str = "auto") -> torch.Tensor:
    """``(B, nparts)`` table ``conn[i, q] = Σ_k wts[i,k]·[labels[cols[i,k]]
    == q]`` from row-major ELL ``cols``/``wts`` (B, w); pad slots point at
    any valid label with weight 0."""
    B, w = cols.shape
    kernel = _use_kernel(cols, prefer)
    if B == 0 or w == 0:
        return torch.zeros((B, nparts), dtype=torch.float32, device=cols.device)
    if kernel:
        return cuda.connection_table_cuda(labels, cols, wts, nparts)
    return connection_table_ref(labels, cols, wts, nparts)


def connection_table_batched(labels: torch.Tensor, cols: torch.Tensor,
                             wts: torch.Tensor, nparts: int, *,
                             prefer: str = "auto") -> torch.Tensor:
    """The table per problem: ``labels`` (G, m), ``cols``/``wts`` (G, B, w)
    → (G, B, nparts), every problem in one launch on the card."""
    G, B, w = cols.shape
    kernel = _use_kernel(cols, prefer)
    if B == 0 or w == 0:
        return torch.zeros((G, B, nparts), dtype=torch.float32,
                           device=cols.device)
    if kernel:
        return cuda.connection_table_batched_cuda(labels, cols, wts, nparts)
    return connection_table_batched_ref(labels, cols, wts, nparts)
