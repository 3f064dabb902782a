"""Plain PyTorch versions of the transposed-ELL matvecs (K1 and K2).

They compute what the kernels compute — fp32 accumulation, output in
``x``'s type — on any device.  The CPU path and the tests run them; on the
card they are the yardstick the CUDA kernels are held against.
"""

from __future__ import annotations

import torch


def ell_spmv_ref(cols_t: torch.Tensor, vals_t: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """A·x with A in transposed ELL: cols_t/vals_t (w, n); pad val = 0.

    out[i] = Σ_k vals_t[k, i] · x[cols_t[k, i]]
    """
    taken = torch.index_select(x, 0, cols_t.reshape(-1)).reshape(cols_t.shape)
    return (vals_t.float() * taken.float()).sum(0).to(x.dtype)


def ell_spmv_batched_ref(cols_t: torch.Tensor, vals_t: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Batched form: cols_t/vals_t (B, w, n); x (B, n).

    out[b, i] = Σ_k vals_t[b, k, i] · x[b, cols_t[b, k, i]]
    """
    B = cols_t.shape[0]
    taken = torch.gather(x, 1, cols_t.reshape(B, -1).long()).reshape(cols_t.shape)
    return (vals_t.float() * taken.float()).sum(1).to(x.dtype)


def lap_apply_ref(cols_t, vals_t, diag, x):
    """L·x = diag ⊙ x − A·x."""
    return diag * x - ell_spmv_ref(cols_t, vals_t, x)
