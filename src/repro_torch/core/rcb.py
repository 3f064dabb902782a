"""Recursive Coordinate / Inertial Bisection (paper §3 + pre-partitioner §8).

RCB: find the longest coordinate axis, sort by that coordinate, split at the
weighted median, recurse.  RIB: same, but along the principal inertial axis
(covariance eigenvector), so cuts need not be axis-aligned.

Two uses in parRSB:
  * stand-alone geometric partitioners (quality baselines, Tables 1–4), and
  * the *pre-partitioner / ordering bootstrap*: `rcb_order` produces a full
    recursive ordering (down to singletons) that (a) makes element data
    locally contiguous before Lanczos/inverse iteration (paper: ≈2× speedup)
    and (b) seeds the AMG pairwise aggregation (paper §7: "We bootstrap the
    prolongation operator from an RCB ordering of the mesh elements").

Host-side NumPy: sorting-based, O(n log² n), exactly like the production
code's parallel sort usage.

Host NumPy, bit-identical to the `repro.core` module of the same name.
"""

from __future__ import annotations

import numpy as np


def _principal_axis(coords: np.ndarray, weights: np.ndarray) -> np.ndarray:
    w = weights / weights.sum()
    mean = (coords * w[:, None]).sum(0)
    centered = coords - mean
    cov = (centered * w[:, None]).T @ centered
    eigval, eigvec = np.linalg.eigh(cov)
    return eigvec[:, -1]


def _axis_key(coords: np.ndarray, weights: np.ndarray, *, inertial: bool) -> np.ndarray:
    if inertial:
        return coords @ _principal_axis(coords, weights)
    extent = coords.max(0) - coords.min(0)
    return coords[:, int(np.argmax(extent))]


def _global_rescale(coords: np.ndarray) -> np.ndarray:
    """Paper §3: rescale ONCE so the global bounding box is isotropic
    (average element diameters match per axis).  Rescaling per-subset would
    equalize every subset's extents and degenerate RCB into slab cuts."""
    span = coords.max(0) - coords.min(0)
    span = np.where(span > 0, span, 1.0)
    return coords / span


def _weighted_split(keys: np.ndarray, weights: np.ndarray,
                    frac: float) -> tuple[np.ndarray, np.ndarray]:
    """Sort by key; split at the weighted `frac` quantile (indices)."""
    order = np.argsort(keys, kind="stable")
    cw = np.cumsum(weights[order])
    total = cw[-1]
    # smallest prefix with ≥ frac of the weight; ties keep element counts
    # within 1 for unit weights (paper Eq. 2.6)
    k = int(np.searchsorted(cw, frac * total, side="left")) + 1
    k = min(max(k, 1), keys.size - 1) if keys.size > 1 else 0
    return order[:k], order[k:]


def _bisect_order(coords, weights, idx, *, inertial):
    """Iterative recursive-bisection ordering (DFS, left-half first)."""
    stack = [idx]
    ordered = []
    while stack:
        cur = stack.pop()
        if cur.size <= 1:
            ordered.append(cur)
            continue
        keys = _axis_key(coords[cur], weights[cur], inertial=inertial)
        lo, hi = _weighted_split(keys, weights[cur], 0.5)
        # push right first so left pops first (DFS left-to-right)
        stack.append(cur[hi])
        stack.append(cur[lo])
    return np.concatenate(ordered) if ordered else idx


def rcb_order(coords: np.ndarray, weights: np.ndarray | None = None, *,
              inertial: bool = False, rescale: bool = True) -> np.ndarray:
    """Full recursive bisection ordering (permutation of 0..n-1).

    Contiguous chunks of the result are spatially compact at every dyadic
    scale — the property both the pre-partitioner and the AMG aggregation
    bootstrap rely on.
    """
    coords = np.asarray(coords, dtype=np.float64)
    if rescale:
        coords = _global_rescale(coords)
    n = coords.shape[0]
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    return _bisect_order(coords, w, np.arange(n, dtype=np.int64),
                         inertial=inertial)


def rib_order(coords: np.ndarray, weights: np.ndarray | None = None,
              *, rescale: bool = True) -> np.ndarray:
    return rcb_order(coords, weights, inertial=True, rescale=rescale)


def _parts_from_order(order: np.ndarray, weights: np.ndarray,
                      nparts: int) -> np.ndarray:
    """Split an ordering into `nparts` contiguous, weight-balanced chunks.

    Midpoint rule (cw − w/2) keeps unit-weight splits exact (≤1 element
    imbalance) instead of drifting on cumulative-sum ties."""
    w_sorted = weights[order]
    cw = np.cumsum(w_sorted)
    total = cw[-1]
    bounds = np.searchsorted(cw - w_sorted / 2,
                             total * np.arange(1, nparts) / nparts, side="left")
    parts = np.empty(order.size, dtype=np.int64)
    prev = 0
    for p, b in enumerate(np.r_[bounds, order.size]):
        parts[order[prev : b if p < nparts - 1 else order.size]] = p
        prev = b
    return parts


def rcb_parts(coords: np.ndarray, nparts: int,
              weights: np.ndarray | None = None, *, inertial: bool = False) -> np.ndarray:
    """RCB/RIB k-way partition via recursive proportional splits."""
    coords = _global_rescale(np.asarray(coords, dtype=np.float64))
    n = coords.shape[0]
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    parts = np.zeros(n, dtype=np.int64)

    def rec(idx: np.ndarray, p_lo: int, p_hi: int) -> None:
        np_parts = p_hi - p_lo
        if np_parts <= 1 or idx.size == 0:
            parts[idx] = p_lo
            return
        p_left = np_parts // 2
        keys = _axis_key(coords[idx], w[idx], inertial=inertial)
        lo, hi = _weighted_split(keys, w[idx], p_left / np_parts)
        rec(idx[lo], p_lo, p_lo + p_left)
        rec(idx[hi], p_lo + p_left, p_hi)

    rec(np.arange(n, dtype=np.int64), 0, nparts)
    return parts


def rib_parts(coords: np.ndarray, nparts: int,
              weights: np.ndarray | None = None) -> np.ndarray:
    return rcb_parts(coords, nparts, weights, inertial=True)
