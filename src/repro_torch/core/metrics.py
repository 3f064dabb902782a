"""Partition-quality metrics (paper §8 evaluation methodology).

The paper evaluates partitions by (a) load imbalance — at most one element
for unit weights (Eq. 2.6), (b) the number of neighbor partitions (message
count ∝ latency term α·M), and (c) the average communication volume per
neighbor (∝ bandwidth term β·W).  The `m₂ = α/β` crossover decides which
term dominates; for GPU/TPU-dense machines the volume dominates, which is
why RSB's min-cut objective is the right one.

Host NumPy, bit-identical to `repro.core.metrics` on the same labels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.mesh.graphs import Graph, connected_labels


@dataclasses.dataclass
class PartitionMetrics:
    nparts: int
    imbalance: int              # max|V_i| − min|V_i| (elements)
    weighted_imbalance: float   # max weight / mean weight
    edge_cut: float             # Σ ω over cut edges (each edge once)
    max_neighbors: int
    avg_neighbors: float
    total_volume: float         # Σ_p outgoing volume (ω words)
    avg_message_size: float     # mean over parts of volume_p / neighbors_p
    max_message_size: float
    max_part_volume_words: float = 0.0  # max over parts of volume_p in words
    disconnected_parts: int = 0  # parts whose induced subgraph is not connected
    component_count: int = 0     # Σ_p components of part p's induced subgraph

    def row(self) -> dict:
        return dataclasses.asdict(self)


def partition_metrics(
    graph: Graph,
    parts: np.ndarray,
    nparts: int | None = None,
    *,
    weights: np.ndarray | None = None,
    dofs_per_face: int = 64,
) -> PartitionMetrics:
    """Quality metrics of `parts` over the dual graph.

    `dofs_per_face`: message words per unit shared-face; the paper's SEM
    runs exchange (N+1)² values per shared face with N=7 → 64 words.  Edge
    weight ω counts shared mesh vertices (4 per face), so message words are
    `ω / 4 · dofs_per_face`.
    """
    parts = np.asarray(parts, dtype=np.int64)
    nparts = int(parts.max()) + 1 if nparts is None else int(nparts)
    counts = np.bincount(parts, minlength=nparts)
    w = np.ones(graph.n) if weights is None else np.asarray(weights, np.float64)
    wsum = np.bincount(parts, weights=w, minlength=nparts)

    rows = graph.rows
    cols = graph.indices
    pr, pc = parts[rows], parts[cols]
    cut_mask = pr != pc
    # each undirected edge appears twice in the symmetric CSR
    edge_cut = float(graph.weights[cut_mask].sum() / 2.0)

    # per-(part, neighbor-part) volumes
    key = pr[cut_mask] * np.int64(nparts) + pc[cut_mask]
    vol = graph.weights[cut_mask]
    uniq, inv_key = np.unique(key, return_inverse=True)
    pair_vol = np.bincount(inv_key, weights=vol)
    src_part = (uniq // nparts).astype(np.int64)

    neighbors = np.bincount(src_part, minlength=nparts)
    volume = np.bincount(src_part, weights=pair_vol, minlength=nparts)
    words = volume / 4.0 * dofs_per_face
    msg = np.where(neighbors > 0, words / np.maximum(neighbors, 1), 0.0)

    # Connectivity census: components of each part's induced subgraph.
    # Intra-part edges only, so no component spans parts and the per-part
    # component counts sum to the number of distinct global labels.
    intra = ~cut_mask
    comp = connected_labels(graph.n, rows[intra], cols[intra])
    comps_per_part = np.zeros(nparts, dtype=np.int64)
    if graph.n:
        pair = np.unique(parts * np.int64(comp.max() + 1) + comp)
        np.add.at(comps_per_part, (pair // np.int64(comp.max() + 1)), 1)

    return PartitionMetrics(
        nparts=nparts,
        imbalance=int(counts.max() - counts.min()),
        weighted_imbalance=float(wsum.max() / max(wsum.mean(), 1e-30)),
        edge_cut=edge_cut,
        max_neighbors=int(neighbors.max()) if nparts > 1 else 0,
        avg_neighbors=float(neighbors.mean()) if nparts > 1 else 0.0,
        total_volume=float(volume.sum()),
        avg_message_size=float(msg[neighbors > 0].mean()) if cut_mask.any() else 0.0,
        max_message_size=float(msg.max()) if cut_mask.any() else 0.0,
        max_part_volume_words=float(words.max()) if cut_mask.any() else 0.0,
        disconnected_parts=int((comps_per_part > 1).sum()),
        component_count=int(comps_per_part.sum()),
    )


# Postal-model constants, the same values as `repro.core.metrics` (an
# assumed ~1 µs start-up; a 50 GB/s link, on the H100 cluster a card's
# InfiniBand NDR port, `launch.mesh.IB_BW`): model inputs, not a
# measurement of any machine the port runs on.  The m₂ crossover is where
# the α (latency) and β (volume) terms are equal — messages larger than m₂
# are volume-dominated, the paper's exascale regime.
ALPHA_S = 1e-6          # ~1 µs collective start-up per hop
BETA_S_PER_WORD = 8.0 / 50e9   # 64-bit words over a card's 50 GB/s IB link


def m2_words(alpha: float = ALPHA_S, beta: float = BETA_S_PER_WORD) -> float:
    return alpha / beta


def comm_time_model(metrics: PartitionMetrics, *, alpha: float = ALPHA_S,
                    beta: float = BETA_S_PER_WORD) -> dict:
    """Postal-model estimate (Eq. 1.2): T_c = α·M + β·W per part.

    W is the true per-part maximum outgoing volume in words (max over
    parts of ``volume_p / 4 · dofs_per_face``).  The earlier
    ``max_message_size × max_neighbors`` estimate mixed maxima attained by
    *different* parts, overstating the bandwidth term whenever the
    largest-average-message part is not the most-connected one."""
    M = metrics.max_neighbors
    W = metrics.max_part_volume_words
    return {
        "latency_s": alpha * M,
        "volume_s": beta * W,
        "dominated_by": "volume" if beta * W > alpha * M else "latency",
        "m2_words": m2_words(alpha, beta),
        "avg_message_words": metrics.avg_message_size,
    }
