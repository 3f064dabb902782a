"""Pebble-bed-like synthetic meshes.

The paper's quality studies (Tables 1-3) use pebble-bed reactor meshes:
hex meshes around dense sphere packings — geometrically irregular, with
voids, and element sizes varying near the pebble surfaces.  We synthesize a
topologically comparable mesh by (a) starting from a structured box,
(b) carving out randomly packed spheres (removing interior elements — the
pebbles themselves are solid), and (c) smoothly warping coordinates so the
geometry is not axis-aligned (defeats RCB's axis alignment, which is exactly
the regime where spectral partitioning shines — paper §3).

Host NumPy, bit-identical to `repro.mesh.pebble` (same generator, seed and
arithmetic), so both packages partition the identical mesh.
"""

from __future__ import annotations

import numpy as np

from repro_torch.mesh.box import HexMesh, box_mesh


def pebble_mesh(
    nx: int,
    ny: int,
    nz: int,
    *,
    n_pebbles: int = 8,
    pebble_radius: float = 0.12,
    warp: float = 0.1,
    seed: int = 0,
) -> HexMesh:
    """Carved + warped box mesh emulating a pebble-bed exterior mesh."""
    rng = np.random.default_rng(seed)
    mesh = box_mesh(nx, ny, nz)
    centers = rng.uniform(pebble_radius, 1.0 - pebble_radius, size=(n_pebbles, 3))

    # Remove elements whose centroid lies inside any pebble.
    d2 = ((mesh.coords[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    keep = ~(d2 < pebble_radius**2).any(axis=1)
    if not keep.any():
        raise ValueError("pebble carving removed every element; reduce radius")
    sub = mesh.take(np.flatnonzero(keep))

    # Smooth non-axis-aligned warp of centroids (partitioning uses centroids
    # only, so warping coords is sufficient to exercise RIB vs RCB).
    x, y, z = sub.coords.T
    cx = x + warp * np.sin(2 * np.pi * y) * np.cos(np.pi * z)
    cy = y + warp * np.sin(2 * np.pi * z) * np.cos(np.pi * x)
    cz = z + warp * np.sin(2 * np.pi * x) * np.cos(np.pi * y)
    sub.coords = np.stack([cx, cy, cz], axis=1)

    # Multi-material weighting (paper §3: conjugate heat transfer): elements
    # near pebble surfaces are "flow" (expensive), others "solid" (cheap).
    near = (d2[keep] < (1.8 * pebble_radius) ** 2).any(axis=1)
    sub.weights = np.where(near, 2.0, 1.0)
    return sub
