"""Assembled Laplacian operators (ELL) + dense oracle.

`EllLaplacian` is ``L x = deg ⊙ x − A x`` with A in padded ELL form.  On
the device it keeps its ELL arrays **transposed once, at construction**, as
contiguous (width, n) tensors: the layout the CUDA SpMVs (K1, K2) stream,
with neighbouring rows at neighbouring addresses.  (JAX gets this transpose for
free inside `jit`; in eager PyTorch a per-matvec ``.T.contiguous()`` would
copy the whole operator once per Lanczos step.)

A **batched** operator holds B independent Laplacians: (B, width, n)
slabs and a (B, n) diagonal, applied to (B, n) vectors — `repro`'s 3-D
(B, n, width) operator of the inverse-iteration buckets and the
`BatchedAMG` levels, stored transposed the same way
(`ell_laplacian_batched` builds it straight in that layout on the host).

``use_kernel=True`` (the port's default, unlike `repro`, whose engine
leaves the Pallas kernels off) sends the adjacency product through
`kernels/ell_spmv/ops.py`: K1 (flat) or K2 (batched) for CUDA tensors, the
plain PyTorch versions for CPU tensors.  ``use_kernel=False`` runs the
plain versions everywhere.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ell_spmv import ops as ell_ops
from repro_torch.kernels.ell_spmv.ref import ell_spmv_batched_ref, ell_spmv_ref
from repro_torch.mesh.graphs import Graph, csr_to_ell


@dataclasses.dataclass(frozen=True, eq=False)
class EllLaplacian:
    """L x = deg ⊙ x − A x with A in transposed padded ELL form.

    cols_t/vals_t: (width, n) — or (B, width, n) for a batched operator
    applying B independent Laplacians to (B, n) vectors — contiguous.
    Padding entries have val 0 and point at their own row.
    """

    cols_t: torch.Tensor   # (..., width, n) int32
    vals_t: torch.Tensor   # (..., width, n) float32 — adjacency weights
    diag: torch.Tensor     # (..., n) float32 — Σ_j ω_ij (true Laplacian diagonal)
    n: int
    use_kernel: bool = True

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def adj_apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.cols_t.ndim == 3:
            if self.use_kernel:
                return ell_ops.ell_spmv_batched(self.cols_t, self.vals_t, x)
            return ell_spmv_batched_ref(self.cols_t, self.vals_t, x)
        if self.use_kernel:
            return ell_ops.ell_spmv(self.cols_t, self.vals_t, x)
        return ell_spmv_ref(self.cols_t, self.vals_t, x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.diag * x - self.adj_apply(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


def ell_operator(cols: np.ndarray, vals: np.ndarray, diag: np.ndarray,
                 n: int, *, device=None, use_kernel: bool = True) -> EllLaplacian:
    """Device operator from host ELL arrays indexed (n, width): transposed
    on the host (free when they are views of (width, n) arrays, as the
    packed builder makes them), then copied to ``device`` once."""
    dev = resolve_device(device)
    return EllLaplacian(
        cols_t=torch.from_numpy(np.ascontiguousarray(cols.T, dtype=np.int32)).to(dev),
        vals_t=torch.from_numpy(np.ascontiguousarray(vals.T, dtype=np.float32)).to(dev),
        diag=torch.from_numpy(np.array(diag, dtype=np.float32)).to(dev),
        n=int(n),
        use_kernel=use_kernel,
    )


def fill_ell_block(graph: Graph, C: np.ndarray, V: np.ndarray, D: np.ndarray,
                   col_offset: int = 0) -> None:
    """Fill one graph's rows of a padded row-major ELL block (C/V/D are
    views of the target rows; rows past graph.n keep self-columns and zero
    vals/diag, so L acts as 0 on them).  The single home of the padding
    invariants — the padded and packed builders delegate here."""
    cols, vals = csr_to_ell(graph, max_row=None)
    nb, wb = cols.shape
    if wb > C.shape[1]:
        raise ValueError("width_pad below max degree")
    C[:nb, :wb] = cols + col_offset
    V[:nb, :wb] = vals
    np.add.at(D[:nb], graph.rows, graph.weights)


def batched_ell_arrays(graphs: list, n_pad: int, width_pad: int,
                       b_pad: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host arrays (Ct, Vt, D) of B stacked Laplacians, built straight in
    the device layout: Ct (b_pad, width_pad, n_pad) int32 and Vt float32,
    C-contiguous, with no host transpose and no int64 tile.  Rows past
    each graph's n, and whole batch-padding problems, keep self-columns and
    zero vals/diag.  The values equal `repro`'s `ell_laplacian_batched`
    after its transpose (float64 vals round to float32 on assignment
    instead of afterwards; D accumulates in float64 as there)."""
    Ct = np.empty((b_pad, width_pad, n_pad), dtype=np.int32)
    Ct[:] = np.arange(n_pad, dtype=np.int32)
    Vt = np.zeros((b_pad, width_pad, n_pad), dtype=np.float32)
    D = np.zeros((b_pad, n_pad), dtype=np.float64)
    for b, g in enumerate(graphs):
        fill_ell_block(g, Ct[b].T, Vt[b].T, D[b])
    return Ct, Vt, D


def batched_ell_operator(Ct: np.ndarray, Vt: np.ndarray, D: np.ndarray, *,
                         device=None, use_kernel: bool = True) -> EllLaplacian:
    """Device operator from the host arrays of `batched_ell_arrays`: one
    host-to-device copy each, no transpose."""
    dev = resolve_device(device)
    return EllLaplacian(
        cols_t=torch.from_numpy(Ct).to(dev),
        vals_t=torch.from_numpy(Vt).to(dev),
        diag=torch.from_numpy(D.astype(np.float32)).to(dev),
        n=int(Ct.shape[-1]),
        use_kernel=use_kernel,
    )


def ell_laplacian_batched(graphs: list, n_pad: int, width_pad: int, b_pad: int,
                          *, device=None, use_kernel: bool = True) -> EllLaplacian:
    """Stack B assembled Laplacians into one batched (b_pad, width_pad,
    n_pad) operator on ``device``.  L acts as 0 on padding rows and on
    batch-padding problems."""
    return batched_ell_operator(
        *batched_ell_arrays(graphs, n_pad, width_pad, b_pad),
        device=device, use_kernel=use_kernel)


def ell_laplacian(graph: Graph, *, device=None,
                  use_kernel: bool = True) -> EllLaplacian:
    cols, vals = csr_to_ell(graph)
    deg = np.zeros(graph.n, dtype=np.float64)
    np.add.at(deg, graph.rows, graph.weights)
    return ell_operator(cols, vals, deg, graph.n, device=device,
                        use_kernel=use_kernel)


def dense_laplacian_np(graph: Graph) -> np.ndarray:
    """Dense float64 Laplacian — the test oracle."""
    A = np.zeros((graph.n, graph.n), dtype=np.float64)
    A[graph.rows, graph.indices] = graph.weights
    return np.diag(A.sum(1)) - A


def fiedler_oracle_np(graph: Graph) -> tuple[float, np.ndarray]:
    """(λ₂, y₂) by dense eigendecomposition — ground truth for small graphs."""
    L = dense_laplacian_np(graph)
    w, v = np.linalg.eigh(L)
    return float(w[1]), v[:, 1]
