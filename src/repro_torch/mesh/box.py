"""Structured hexahedral box meshes with global vertex/edge/face numbering.

This is the SEM mesh substrate of the paper: a mesh is a set of hex elements,
each carrying the *global ids* of its 8 vertices.  parRSB's gather-scatter
Laplacian (paper §5) needs exactly this `(E, 8)` global-id table — plus, for
the *unweighted* Laplacian, analogous `(E, 12)` edge-id and `(E, 6)` face-id
tables (paper §5, inclusion-exclusion numbering: "It turns out that it is
very easy and fast to do this numbering as we have a global numbering for
vertices already available").

Everything here is host-side NumPy, a copy of `repro.mesh.box` kept
bit-identical to it (the port imports nothing of `repro`); it plays the
role of mesh I/O + `gs_setup`'s id discovery.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Local corner order: corner c = (dx, dy, dz) bits, x fastest.
_CORNERS = np.array(
    [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
    dtype=np.int64,
)  # (8, 3)

# The 12 edges of a hex as pairs of local corner indices (corner order above).
_HEX_EDGES = np.array(
    [
        (0, 1), (2, 3), (4, 5), (6, 7),  # x-aligned
        (0, 2), (1, 3), (4, 6), (5, 7),  # y-aligned
        (0, 4), (1, 5), (2, 6), (3, 7),  # z-aligned
    ],
    dtype=np.int64,
)

# The 6 faces of a hex as 4-tuples of local corner indices.
_HEX_FACES = np.array(
    [
        (0, 2, 4, 6), (1, 3, 5, 7),  # x = 0, 1
        (0, 1, 4, 5), (2, 3, 6, 7),  # y = 0, 1
        (0, 1, 2, 3), (4, 5, 6, 7),  # z = 0, 1
    ],
    dtype=np.int64,
)


@dataclasses.dataclass
class HexMesh:
    """A hex mesh in parRSB's input form: per-element global-id tables.

    Attributes
    ----------
    vert_gid : (E, 8) int64 — global vertex id of each element corner.
    edge_gid : (E, 12) int64 — global edge id of each element edge.
    face_gid : (E, 6) int64 — global face id of each element face.
    coords   : (E, 3) float64 — element centroids (for RCB/RIB/SFC).
    weights  : (E,) float64 — per-element work weight (multi-material support;
               1.0 for single-material meshes).
    """

    vert_gid: np.ndarray
    edge_gid: np.ndarray
    face_gid: np.ndarray
    coords: np.ndarray
    weights: np.ndarray
    n_vert: int
    n_edge: int
    n_face: int

    @property
    def nelems(self) -> int:
        return self.vert_gid.shape[0]

    def take(self, idx: np.ndarray) -> "HexMesh":
        """Sub-mesh of the elements in `idx` (gids renumbered contiguously)."""
        vg, nv = _renumber(self.vert_gid[idx])
        eg, ne = _renumber(self.edge_gid[idx])
        fg, nf = _renumber(self.face_gid[idx])
        return HexMesh(
            vert_gid=vg,
            edge_gid=eg,
            face_gid=fg,
            coords=self.coords[idx],
            weights=self.weights[idx],
            n_vert=nv,
            n_edge=ne,
            n_face=nf,
        )


def _renumber(gid: np.ndarray) -> tuple[np.ndarray, int]:
    uniq, inv = np.unique(gid, return_inverse=True)
    return inv.reshape(gid.shape).astype(np.int64), int(uniq.size)


def _number_tuples(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """Contiguously number rows of `keys` (N, k); equal rows share an id."""
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    return inv.astype(np.int64), uniq.shape[0]


def derive_edge_face_gids(vert_gid: np.ndarray) -> tuple[np.ndarray, int, np.ndarray, int]:
    """Derive global edge/face numbering from the vertex numbering.

    This is the paper's observation: with global vertex ids in hand, an edge
    is keyed by its sorted vertex-id pair and a face by its sorted 4-tuple;
    `np.unique` over keys is the parallel numbering (host-side setup).
    """
    E = vert_gid.shape[0]
    edge_pairs = vert_gid[:, _HEX_EDGES]          # (E, 12, 2)
    edge_keys = np.sort(edge_pairs, axis=-1).reshape(E * 12, 2)
    edge_gid, n_edge = _number_tuples(edge_keys)
    face_quads = vert_gid[:, _HEX_FACES]          # (E, 6, 4)
    face_keys = np.sort(face_quads, axis=-1).reshape(E * 6, 4)
    face_gid, n_face = _number_tuples(face_keys)
    return edge_gid.reshape(E, 12), n_edge, face_gid.reshape(E, 6), n_face


def box_mesh(nx: int, ny: int, nz: int, *, lengths=(1.0, 1.0, 1.0)) -> HexMesh:
    """Structured nx × ny × nz hex box mesh (the paper's weak-scaling cube)."""
    E = nx * ny * nz
    ii, jj, kk = np.meshgrid(
        np.arange(nx, dtype=np.int64),
        np.arange(ny, dtype=np.int64),
        np.arange(nz, dtype=np.int64),
        indexing="ij",
    )
    elem_ijk = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)  # (E, 3)

    # Global vertex ids on the (nx+1)(ny+1)(nz+1) lattice.
    corner = elem_ijk[:, None, :] + _CORNERS[None, :, :]  # (E, 8, 3)
    vert_gid = (
        corner[..., 0] * ((ny + 1) * (nz + 1))
        + corner[..., 1] * (nz + 1)
        + corner[..., 2]
    )
    n_vert = (nx + 1) * (ny + 1) * (nz + 1)

    edge_gid, n_edge, face_gid, n_face = derive_edge_face_gids(vert_gid)

    h = np.array(lengths, dtype=np.float64) / np.array([nx, ny, nz], dtype=np.float64)
    coords = (elem_ijk.astype(np.float64) + 0.5) * h[None, :]

    return HexMesh(
        vert_gid=vert_gid,
        edge_gid=edge_gid,
        face_gid=face_gid,
        coords=coords,
        weights=np.ones(E, dtype=np.float64),
        n_vert=n_vert,
        n_edge=n_edge,
        n_face=n_face,
    )
