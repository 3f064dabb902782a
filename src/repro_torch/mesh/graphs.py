"""Generic graph substrate: dual graphs, CSR/ELL utilities, generators.

All construction is host-side NumPy (the `gs_setup` analogue), a copy of
`repro.mesh.graphs` kept bit-identical to it; the arrays it produces are
copied to the device once per operator by `repro_torch.core`.  The
generators the main path does not need (R-MAT, molecule batches, 3-D
stencils) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected weighted graph in CSR form (+ COO view).

    `indptr[i]:indptr[i+1]` slices `indices`/`weights` for row i.
    The graph is stored symmetrically: (i, j) and (j, i) both present.
    """

    n: int
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (nnz,) int64 — column (neighbor) ids
    weights: np.ndarray  # (nnz,) float64 — edge weights

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def rows(self) -> np.ndarray:
        """COO row ids aligned with `indices` — computed once, then cached
        on the instance (not a dataclass field, so eq/asdict are
        unaffected).  Hot consumers (edge_cut, FM connection tables, the
        multilevel matching pass) call this repeatedly; the CSR arrays are
        never mutated in place, so the cache cannot go stale."""
        r = self.__dict__.get("_rows")
        if r is None:
            r = np.repeat(np.arange(self.n, dtype=np.int64),
                          np.diff(self.indptr))
            self.__dict__["_rows"] = r
        return r

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def sub(self, idx: np.ndarray) -> "Graph":
        """Node-induced subgraph, nodes renumbered to 0..len(idx)-1."""
        idx = np.asarray(idx, dtype=np.int64)
        remap = -np.ones(self.n, dtype=np.int64)
        remap[idx] = np.arange(idx.size, dtype=np.int64)
        rows = self.rows
        keep = (remap[rows] >= 0) & (remap[self.indices] >= 0)
        return build_csr(
            remap[rows[keep]], remap[self.indices[keep]], idx.size,
            weights=self.weights[keep], symmetrize=False,
        )


def extract_subgraphs(graph: Graph, groups: list) -> list:
    """Node-induced subgraphs for several **disjoint** node groups in one
    pass over the parent edge list.

    The vectorized analogue of calling `graph.sub(idx)` per group: instead
    of one O(n + nnz) remap per child, all children of an RSB tree level
    are extracted with a single label/filter/lexsort sweep.  Nodes of group
    k are renumbered 0..len(groups[k])-1 in the order given (so a
    permutation of all nodes reproduces `graph.sub(perm)`).
    """
    label = np.full(graph.n, -1, dtype=np.int64)
    loc = np.zeros(graph.n, dtype=np.int64)
    sizes = []
    for k, idx in enumerate(groups):
        idx = np.asarray(idx, dtype=np.int64)
        label[idx] = k
        loc[idx] = np.arange(idx.size, dtype=np.int64)
        sizes.append(int(idx.size))
    rows = graph.rows
    keep = (label[rows] >= 0) & (label[rows] == label[graph.indices])
    grp = label[rows[keep]]
    src = loc[rows[keep]]
    dst = loc[graph.indices[keep]]
    w = graph.weights[keep]
    order = np.lexsort((dst, src, grp))
    grp, src, dst, w = grp[order], src[order], dst[order], w[order]
    cuts = np.searchsorted(grp, np.arange(len(groups) + 1))
    out = []
    for k, nk in enumerate(sizes):
        a, b = int(cuts[k]), int(cuts[k + 1])
        indptr = np.zeros(nk + 1, dtype=np.int64)
        np.add.at(indptr, src[a:b] + 1, 1)
        out.append(
            Graph(n=nk, indptr=np.cumsum(indptr), indices=dst[a:b],
                  weights=w[a:b])
        )
    return out


def build_csr(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    *,
    weights: np.ndarray | None = None,
    symmetrize: bool = True,
    sum_duplicates: bool = True,
) -> Graph:
    """Build CSR from COO edge lists; optionally symmetrize + coalesce."""
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    w = (
        np.ones(src.size, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64).ravel()
    )
    mask = src != dst  # drop self-loops (the dual graph has none)
    src, dst, w = src[mask], dst[mask], w[mask]
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    if sum_duplicates and src.size:
        key = src * np.int64(n) + dst
        order = np.argsort(key, kind="stable")
        key, src, dst, w = key[order], src[order], dst[order], w[order]
        first = np.r_[True, key[1:] != key[:-1]]
        seg = np.cumsum(first) - 1
        w = np.bincount(seg, weights=w, minlength=int(first.sum()))
        src, dst = src[first], dst[first]
    else:
        order = np.lexsort((dst, src))
        src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(n=n, indptr=indptr, indices=dst, weights=w)


def dual_graph_from_incidence(item_gid: np.ndarray, n_items: int, nelems: int) -> Graph:
    """Weighted dual graph from an (E, K) item-incidence table.

    Two elements are adjacent iff they share an item (vertex); the edge
    weight is the number of shared items — exactly the paper's ω (1 per
    shared vertex, so 2 for an edge, 4 for a face in a hex mesh).

    This is the *assembled* (CSR) reference; the matrix-free gather-scatter
    path never materializes it.
    """
    E, K = item_gid.shape
    elems = np.repeat(np.arange(E, dtype=np.int64), K)
    gids = item_gid.ravel()
    order = np.argsort(gids, kind="stable")
    gids_s, elems_s = gids[order], elems[order]
    starts = np.flatnonzero(np.r_[True, gids_s[1:] != gids_s[:-1]])
    counts = np.diff(np.r_[starts, gids_s.size])

    # All ordered pairs within each group (group size ≤ elements sharing a
    # vertex — bounded by mesh valence, e.g. 8 for interior box vertices).
    c2 = counts * counts
    total = int(c2.sum())
    rep_c = np.repeat(counts, c2)
    rep_s = np.repeat(starts, c2)
    off = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(c2) - c2, c2)
    src = elems_s[rep_s + off // rep_c]
    dst = elems_s[rep_s + off % rep_c]
    return build_csr(src, dst, nelems, symmetrize=False)


def dual_graph(mesh) -> Graph:
    """Weighted dual graph of a HexMesh (vertex-sharing adjacency)."""
    return dual_graph_from_incidence(mesh.vert_gid, mesh.n_vert, mesh.nelems)


def csr_to_ell(graph: Graph, *, max_row: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """CSR → padded ELL: (n, max_row) column ids + weights.

    Padding entries point at row i itself with weight 0 (harmless for the
    Laplacian matvec `d ⊙ x − A x`).  The device operator stores the
    transpose, (max_row, n), so the CUDA SpMV's neighbouring threads read
    neighbouring addresses.
    """
    deg = graph.degrees
    width = int(deg.max()) if max_row is None else int(max_row)
    if (deg > width).any():
        raise ValueError(f"row degree {int(deg.max())} exceeds ELL width {width}")
    cols = np.tile(np.arange(graph.n, dtype=np.int64)[:, None], (1, width))
    vals = np.zeros((graph.n, width), dtype=np.float64)
    rows = graph.rows
    pos = np.arange(graph.nnz, dtype=np.int64) - graph.indptr[rows]
    cols[rows, pos] = graph.indices
    vals[rows, pos] = graph.weights
    return cols, vals


def connected_labels(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Connected-component labels 0..k-1 from a COO edge list (vectorized).

    Shiloach–Vishkin-style min-label propagation: every node adopts the
    minimum label across its edges, then labels are collapsed by pointer
    doubling; O(nnz) work per round, O(log n) rounds.  Isolated nodes get
    their own label.  This is the production path (`connected_components`
    is the per-node BFS test oracle): the repair stage and the partition
    metrics run it once per call on million-edge graphs.
    """
    label = np.arange(n, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    while src.size:
        m = np.minimum(label[src], label[dst])
        np.minimum.at(label, src, m)
        np.minimum.at(label, dst, m)
        while True:
            nxt = label[label]
            if np.array_equal(nxt, label):
                break
            label = nxt
        if (label[src] == label[dst]).all():
            break
    _, out = np.unique(label, return_inverse=True)
    return out


def connected_components(graph: Graph) -> np.ndarray:
    """Label connected components (frontier BFS, NumPy).  Test utility."""
    label = -np.ones(graph.n, dtype=np.int64)
    comp = 0
    for seed in range(graph.n):
        if label[seed] >= 0:
            continue
        frontier = np.array([seed], dtype=np.int64)
        label[seed] = comp
        while frontier.size:
            # all neighbors of the frontier
            parts = [
                graph.indices[graph.indptr[u] : graph.indptr[u + 1]] for u in frontier
            ]
            nbrs = np.unique(np.concatenate(parts)) if parts else np.array([], np.int64)
            new = nbrs[label[nbrs] < 0]
            label[new] = comp
            frontier = new
        comp += 1
    return label


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def grid_graph_2d(nx: int, ny: int) -> Graph:
    """4-neighbor 2D lattice (checkerboard degeneracy testbed, paper §9)."""
    idx = np.arange(nx * ny, dtype=np.int64).reshape(nx, ny)
    src = np.concatenate([idx[:-1, :].ravel(), idx[:, :-1].ravel()])
    dst = np.concatenate([idx[1:, :].ravel(), idx[:, 1:].ravel()])
    return build_csr(src, dst, nx * ny)


def grid_graph_3d(nx: int, ny: int, nz: int) -> Graph:
    idx = np.arange(nx * ny * nz, dtype=np.int64).reshape(nx, ny, nz)
    src = np.concatenate([idx[:-1].ravel(), idx[:, :-1].ravel(), idx[:, :, :-1].ravel()])
    dst = np.concatenate([idx[1:].ravel(), idx[:, 1:].ravel(), idx[:, :, 1:].ravel()])
    return build_csr(src, dst, nx * ny * nz)
