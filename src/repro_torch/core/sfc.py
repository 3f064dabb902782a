"""Space-filling-curve partitioner (paper §3 related work, baseline).

Hilbert ordering via the Skilling transpose algorithm (bit-interleaved,
Gray-code corrected) plus a plain Morton (Z-order) variant.  Partition =
sort centroids by curve index, split into weight-balanced contiguous chunks.

Host NumPy, bit-identical to the `repro.core` module of the same name.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.rcb import _parts_from_order


def _quantize(coords: np.ndarray, bits: int) -> np.ndarray:
    c = np.asarray(coords, dtype=np.float64)
    lo, hi = c.min(0), c.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = ((c - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    return q


def morton_index(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    q = _quantize(coords, bits)
    out = np.zeros(q.shape[0], dtype=np.uint64)
    for b in range(bits):
        for d in range(q.shape[1]):
            out |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * q.shape[1] + d
            )
    return out


def hilbert_index(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Skilling's transpose-form Hilbert index (vectorized over points)."""
    X = _quantize(coords, bits).astype(np.uint64).copy()  # (n, d)
    n, d = X.shape
    M = np.uint64(1) << np.uint64(bits - 1)

    # Inverse undo excess work (Skilling 2004, vectorized).
    Q = M
    while Q > np.uint64(1):
        P = Q - np.uint64(1)
        for i in range(d):
            mask = (X[:, i] & Q) != 0
            # invert low bits of X[0]
            X[mask, 0] ^= P
            t = (X[:, 0] ^ X[:, i]) & P
            t = np.where(mask, np.uint64(0), t)
            X[:, 0] ^= t
            X[:, i] ^= t
        Q >>= np.uint64(1)

    # Gray decode
    for i in range(1, d):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(n, dtype=np.uint64)
    Q = M
    while Q > np.uint64(1):
        mask = (X[:, d - 1] & Q) != 0
        t ^= np.where(mask, Q - np.uint64(1), np.uint64(0))
        Q >>= np.uint64(1)
    for i in range(d):
        X[:, i] ^= t

    # Interleave transpose-form bits into a single index (MSB first).
    out = np.zeros(n, dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(d):
            out = (out << np.uint64(1)) | ((X[:, i] >> np.uint64(b)) & np.uint64(1))
    return out


def sfc_order(coords: np.ndarray, *, curve: str = "hilbert", bits: int = 16) -> np.ndarray:
    idx = hilbert_index(coords, bits) if curve == "hilbert" else morton_index(coords, bits)
    return np.argsort(idx, kind="stable")


def sfc_parts(
    coords: np.ndarray,
    nparts: int,
    weights: np.ndarray | None = None,
    *,
    curve: str = "hilbert",
    bits: int = 16,
) -> np.ndarray:
    if curve not in ("hilbert", "morton"):
        raise ValueError(f"unknown curve: {curve!r}")
    order = sfc_order(coords, curve=curve, bits=bits)
    w = np.ones(coords.shape[0]) if weights is None else np.asarray(weights, np.float64)
    return _parts_from_order(order, w, nparts)
