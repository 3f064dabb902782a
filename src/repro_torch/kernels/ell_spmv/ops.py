"""Public dispatch for the ELL SpMV kernel (K1).

Inputs are in transposed ELL, ``cols_t``/``vals_t`` of shape (w, n): the
layout the port's `EllLaplacian` keeps on the device.  ``prefer``:

* ``"auto"`` (default) — the CUDA kernel for a CUDA ``x``, the plain
  PyTorch version for a CPU ``x``;
* ``"kernel"`` — the CUDA kernel; raises for a CPU tensor;
* ``"ref"`` — the plain PyTorch version on any device.

There is no fallback: on a CUDA tensor a build or launch failure raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ell_spmv import cuda
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref

_PREFER = ("auto", "kernel", "ref")


def ell_spmv(cols_t: torch.Tensor, vals_t: torch.Tensor, x: torch.Tensor, *,
             prefer: str = "auto") -> torch.Tensor:
    """A·x with A in transposed ELL (w, n), dispatched per ``prefer``."""
    if prefer not in _PREFER:
        raise ValueError(f"unknown prefer: {prefer!r} (have {_PREFER})")
    if prefer == "ref" or (prefer == "auto" and not x.is_cuda):
        return ell_spmv_ref(cols_t, vals_t, x)
    if not x.is_cuda:
        raise ValueError("prefer='kernel' needs CUDA tensors: the CUDA ELL "
                         "SpMV has no CPU mode")
    return cuda.ell_spmv_cuda(cols_t, vals_t, x)


def lap_apply(cols_t: torch.Tensor, vals_t: torch.Tensor, diag: torch.Tensor,
              x: torch.Tensor, *, prefer: str = "auto") -> torch.Tensor:
    """L·x = diag ⊙ x − A·x with the adjacency product from :func:`ell_spmv`."""
    return diag * x - ell_spmv(cols_t, vals_t, x, prefer=prefer)
