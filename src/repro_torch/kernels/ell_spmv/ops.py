"""Public dispatch for the ELL SpMV kernels (K1 flat, K2 batched).

Inputs are in transposed ELL, ``cols_t``/``vals_t`` of shape (w, n) for K1
and (B, w, n) for K2: the layouts the port's `EllLaplacian` keeps on the
device.  ``prefer``:

* ``"auto"`` (default) — the CUDA kernel for a CUDA ``x``, the plain
  PyTorch version for a CPU ``x``;
* ``"kernel"`` — the CUDA kernel; raises for a CPU tensor;
* ``"ref"`` — the plain PyTorch version on any device.

There is no fallback: on a CUDA tensor a build or launch failure raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ell_spmv import cuda
from repro_torch.kernels.ell_spmv.ref import ell_spmv_batched_ref, ell_spmv_ref

_PREFER = ("auto", "kernel", "ref")


def _use_kernel(x: torch.Tensor, prefer: str) -> bool:
    if prefer not in _PREFER:
        raise ValueError(f"unknown prefer: {prefer!r} (have {_PREFER})")
    if prefer == "ref" or (prefer == "auto" and not x.is_cuda):
        return False
    if not x.is_cuda:
        raise ValueError("prefer='kernel' needs CUDA tensors: the CUDA ELL "
                         "SpMV has no CPU mode")
    return True


def ell_spmv(cols_t: torch.Tensor, vals_t: torch.Tensor, x: torch.Tensor, *,
             prefer: str = "auto") -> torch.Tensor:
    """A·x with A in transposed ELL (w, n), dispatched per ``prefer``."""
    if _use_kernel(x, prefer):
        return cuda.ell_spmv_cuda(cols_t, vals_t, x)
    return ell_spmv_ref(cols_t, vals_t, x)


def ell_spmv_batched(cols_t: torch.Tensor, vals_t: torch.Tensor,
                     x: torch.Tensor, *, prefer: str = "auto") -> torch.Tensor:
    """B independent products A_b·x_b, A in transposed ELL (B, w, n) and x
    (B, n), dispatched per ``prefer``."""
    if _use_kernel(x, prefer):
        return cuda.ell_spmv_batched_cuda(cols_t, vals_t, x)
    return ell_spmv_batched_ref(cols_t, vals_t, x)


def lap_apply(cols_t: torch.Tensor, vals_t: torch.Tensor, diag: torch.Tensor,
              x: torch.Tensor, *, prefer: str = "auto") -> torch.Tensor:
    """L·x = diag ⊙ x − A·x with the adjacency product from :func:`ell_spmv`."""
    return diag * x - ell_spmv(cols_t, vals_t, x, prefer=prefer)
