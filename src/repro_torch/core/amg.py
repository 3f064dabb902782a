"""Galerkin graph coarsening (the host half of `repro.core.amg`).

Only :func:`coarsen_graph` is ported: the cascadic Fiedler warm start
(`core/fiedler.py::multilevel_warm_start`) needs it.  The AMG V-cycles,
heavy-edge matching and the batched hierarchy wait for the inverse-iteration
slice.  Host NumPy, bit-identical to `repro.core.amg.coarsen_graph`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.mesh.graphs import Graph, build_csr


def coarsen_graph(graph: Graph, agg: np.ndarray, n_coarse: int,
                  *, node_weights: np.ndarray | None = None):
    """Galerkin coarse graph: weights between aggregates are summed.

    Edges whose endpoints land in ONE aggregate become self-loops and are
    dropped (``build_csr`` filters ``src == dst``), so the coarse total
    edge weight is the fine total minus the absorbed intra-aggregate
    weight — never more.  When ``node_weights`` is given, aggregate node
    weights are accumulated and ``(coarse_graph, coarse_weights)`` is
    returned; the node-weight sum is conserved exactly level to level.
    """
    rows = graph.rows
    coarse = build_csr(
        agg[rows], agg[graph.indices], n_coarse,
        weights=graph.weights, symmetrize=False,
    )
    if node_weights is None:
        return coarse
    w_c = np.bincount(agg, weights=np.asarray(node_weights, np.float64),
                      minlength=n_coarse)
    return coarse, w_c
