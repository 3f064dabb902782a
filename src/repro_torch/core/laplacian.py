"""Assembled Laplacian operators (ELL) + dense oracle.

`EllLaplacian` is ``L x = deg ⊙ x − A x`` with A in padded ELL form.  On
the device it keeps its ELL arrays **transposed once, at construction**, as
contiguous (width, n) tensors: the layout the CUDA SpMV (K1) streams, with
neighbouring rows at neighbouring addresses.  (JAX gets this transpose for
free inside `jit`; in eager PyTorch a per-matvec ``.T.contiguous()`` would
copy the whole operator once per Lanczos step.)

``use_kernel=True`` (the port's default, unlike `repro`, whose engine
leaves the Pallas kernel off) sends the adjacency product through
`kernels/ell_spmv/ops.py`: K1 for CUDA tensors, the plain PyTorch version
for CPU tensors.  ``use_kernel=False`` runs the plain version everywhere.
The 3-D (B, n, w) operators of the inverse-iteration and AMG paths belong
to K2 and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ell_spmv import ops as ell_ops
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref
from repro_torch.mesh.graphs import Graph, csr_to_ell


@dataclasses.dataclass(frozen=True, eq=False)
class EllLaplacian:
    """L x = deg ⊙ x − A x with A in transposed padded ELL form.

    cols_t/vals_t: (width, n), contiguous.  Padding entries have val 0 and
    point at their own row.
    """

    cols_t: torch.Tensor   # (width, n) int32
    vals_t: torch.Tensor   # (width, n) float32 — adjacency weights
    diag: torch.Tensor     # (n,) float32 — Σ_j ω_ij (true Laplacian diagonal)
    n: int
    use_kernel: bool = True

    def __post_init__(self):
        if self.cols_t.ndim != 2:
            raise NotImplementedError(
                "batched (B, n, w) EllLaplacian operators (kernel K2) are "
                "not yet ported")

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def adj_apply(self, x: torch.Tensor) -> torch.Tensor:
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
