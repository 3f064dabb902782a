"""E(3)-equivariant substrate: real spherical harmonics (l ≤ 2), Gaunt
tensor-product coefficients, radial bases, and the channelwise tensor
product used by NequIP and MACE.

Port of `repro.models.gnn.equivariant`.  The host tables (`sh_l2_np`,
`gaunt_tensor`, `enumerate_paths`, `path_tensors`) are NumPy copies of
`repro`'s; `sh_l2`, `tensor_product` and `bessel_rbf` are torch.

Irrep layout: features are (..., C, 9) with the 9 components ordered
[l=0 (1), l=1 (3: m=−1,0,1 ≙ y,z,x), l=2 (5)] — orthonormal real SH.

Coupling coefficients: the real-SH Gaunt tensor
    G[i, j, k] = ∫_{S²} Y_i Y_j Y_k dΩ
computed once by Gauss-Legendre (cosθ) × trapezoid (φ) quadrature, which
is exact for the degree-6 integrands arising at l_max = 2.

`tensor_product` keeps `repro`'s contraction order: the edge harmonics
go into the Gaunt blocks first, ``W = einsum("pijk,ej->epik")``, then
the per-path weights, ``einsum("ecp,epik->ecik")``, then the features,
``einsum("ecik,eci->eck")`` (`repro` writes the last two as one
three-operand einsum and leaves their pairing to XLA; here the pairing
is fixed, so the card and the CPU contract alike).  Its largest
intermediate is the (E, C, 9, 9) product: at the ``molecule`` cell
(8,192 edges) 340 MB for MACE (C = 128) and 85 MB for NequIP (C = 32).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

L_MAX = 2
N_IRREPS = (L_MAX + 1) ** 2  # 9
L_SLICES = {0: slice(0, 1), 1: slice(1, 4), 2: slice(4, 9)}
L_OF_INDEX = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])


def sh_l2_np(r: np.ndarray) -> np.ndarray:
    """Orthonormal real spherical harmonics of unit vectors r (..., 3)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    c0 = 0.5 / np.sqrt(np.pi)
    c1 = np.sqrt(3.0 / (4.0 * np.pi))
    c2a = 0.5 * np.sqrt(15.0 / np.pi)
    c2b = 0.25 * np.sqrt(5.0 / np.pi)
    c2c = 0.25 * np.sqrt(15.0 / np.pi)
    return np.stack(
        [
            np.full_like(x, c0),
            c1 * y, c1 * z, c1 * x,
            c2a * x * y, c2a * y * z,
            c2b * (3 * z * z - 1.0),
            c2a * x * z, c2c * (x * x - y * y),
        ],
        axis=-1,
    )


def sh_l2(r: torch.Tensor) -> torch.Tensor:
    """Torch version of sh_l2_np (same formulas)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    c0 = 0.5 / math.sqrt(math.pi)
    c1 = math.sqrt(3.0 / (4.0 * math.pi))
    c2a = 0.5 * math.sqrt(15.0 / math.pi)
    c2b = 0.25 * math.sqrt(5.0 / math.pi)
    c2c = 0.25 * math.sqrt(15.0 / math.pi)
    return torch.stack(
        [
            torch.full_like(x, c0),
            c1 * y, c1 * z, c1 * x,
            c2a * x * y, c2a * y * z,
            c2b * (3 * z * z - 1.0),
            c2a * x * z, c2c * (x * x - y * y),
        ],
        dim=-1,
    )


@lru_cache(maxsize=1)
def gaunt_tensor() -> np.ndarray:
    """G[i,j,k] = ∫ Y_i Y_j Y_k dΩ over the unit sphere (9,9,9)."""
    n_t, n_p = 24, 48
    ct, wt = np.polynomial.legendre.leggauss(n_t)       # cosθ nodes/weights
    phi = (np.arange(n_p) + 0.5) * (2 * np.pi / n_p)
    wp = 2 * np.pi / n_p
    st = np.sqrt(1.0 - ct**2)
    # grid of unit vectors
    x = st[:, None] * np.cos(phi)[None, :]
    y = st[:, None] * np.sin(phi)[None, :]
    z = np.broadcast_to(ct[:, None], x.shape)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    w = (wt[:, None] * wp * np.ones(n_p)[None, :]).reshape(-1)
    Y = sh_l2_np(pts)                                    # (M, 9)
    G = np.einsum("m,mi,mj,mk->ijk", w, Y, Y, Y)
    G[np.abs(G) < 1e-12] = 0.0
    return G


@lru_cache(maxsize=1)
def enumerate_paths() -> list:
    """Nonzero coupling paths (l1, l2, l3) under the Gaunt tensor."""
    G = gaunt_tensor()
    paths = []
    for l1 in range(L_MAX + 1):
        for l2 in range(L_MAX + 1):
            for l3 in range(L_MAX + 1):
                blk = G[L_SLICES[l1], L_SLICES[l2], L_SLICES[l3]]
                if np.abs(blk).max() > 1e-10:
                    paths.append((l1, l2, l3))
    return paths


@lru_cache(maxsize=1)
def path_tensors() -> np.ndarray:
    """(P, 9, 9, 9) per-path masked Gaunt blocks (zero outside the path)."""
    G = gaunt_tensor()
    out = []
    for l1, l2, l3 in enumerate_paths():
        M = np.zeros_like(G)
        M[L_SLICES[l1], L_SLICES[l2], L_SLICES[l3]] = G[
            L_SLICES[l1], L_SLICES[l2], L_SLICES[l3]
        ]
        out.append(M)
    return np.stack(out)


def n_paths() -> int:
    return len(enumerate_paths())


@lru_cache(maxsize=16)
def path_tensors_on(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`path_tensors` as a (P, 9, 9, 9) tensor, copied once per device and
    type."""
    return torch.from_numpy(path_tensors()).to(device, dtype)


def tensor_product(feat: torch.Tensor, sh: torch.Tensor,
                   path_w: torch.Tensor) -> torch.Tensor:
    """Channelwise equivariant TP:  out[e,c,k] = Σ_p w[e,c,p]·(f ⊗_G sh)_p.

    feat   : (E, C, 9) — per-edge source-node features
    sh     : (E, 9)    — per-edge spherical harmonics
    path_w : (E, C, P) — per-path weights (radial MLP output or constants)
    """
    GP = path_tensors_on(feat.device, feat.dtype)        # (P, 9, 9, 9)
    # contract sh into the Gaunt blocks first: (E, P, 9_in, 9_out)
    W = torch.einsum("pijk,ej->epik", GP, sh)
    Wc = torch.einsum("ecp,epik->ecik", path_w, W)
    return torch.einsum("ecik,eci->eck", Wc, feat)


# ---------------------------------------------------------------------------
# Radial basis
# ---------------------------------------------------------------------------

def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with smooth cosine cutoff (NequIP §methods)."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * r[..., None] / cutoff) / r[..., None]
    fc = 0.5 * (torch.cos(math.pi * torch.clamp(r / cutoff, 0, 1)) + 1.0)
    return basis * fc[..., None]
