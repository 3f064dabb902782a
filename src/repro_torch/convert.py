"""`repro` objects, handed over as NumPy arrays, rebuilt as the port's.

The partitioner has no weights; what carries across between the two
packages is the input and its assembled operators — the mesh, its dual
graph and the ELL Laplacian.  These builders take exactly the arrays a
`repro` object holds (``graph.indptr``, ``op.cols`` …, as NumPy), so a
test can hand both packages the identical input.  Nothing here imports
`repro`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.laplacian import EllLaplacian, ell_operator
from repro_torch.mesh.box import HexMesh, derive_edge_face_gids
from repro_torch.mesh.graphs import Graph


def graph_from_arrays(indptr, indices, weights, n) -> Graph:
    """A `Graph` from CSR arrays (`repro.mesh.graphs.Graph`'s fields)."""
    return Graph(n=int(n),
                 indptr=np.array(indptr, dtype=np.int64),
                 indices=np.array(indices, dtype=np.int64),
                 weights=np.array(weights, dtype=np.float64))


def ell_from_arrays(cols, vals, diag, n, device=None, *,
                    use_kernel: bool = True) -> EllLaplacian:
    """An `EllLaplacian` on ``device`` (default: the card) from the
    row-major (n, width) arrays a `repro.core.laplacian.EllLaplacian`
    holds; the port stores them transposed."""
    return ell_operator(np.asarray(cols), np.asarray(vals), np.asarray(diag),
                        int(n), device=device, use_kernel=use_kernel)


def mesh_from_arrays(vert_gid, coords, weights, n_vert) -> HexMesh:
    """A `HexMesh` from its vertex-id table, centroids and element weights;
    edge and face ids are derived from the vertex ids, as `box_mesh`
    derives them."""
    vert_gid = np.array(vert_gid, dtype=np.int64)
    edge_gid, n_edge, face_gid, n_face = derive_edge_face_gids(vert_gid)
    return HexMesh(vert_gid=vert_gid, edge_gid=edge_gid, face_gid=face_gid,
                   coords=np.array(coords, dtype=np.float64),
                   weights=np.array(weights, dtype=np.float64),
                   n_vert=int(n_vert), n_edge=n_edge, n_face=n_face)
