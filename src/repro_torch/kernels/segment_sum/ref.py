"""Plain PyTorch versions of the connection table (K3 and K4).

For every row ``i`` the edge weights of its ELL slots are summed into
``nparts`` segments keyed by the part label of each neighbour,

    conn[i, q] = Σ_k wts[i, k] · [labels[cols[i, k]] == q]

:func:`connection_table_ref` and :func:`connection_table_batched_ref` run
the slot loop of `repro.kernels.segment_sum.ops._xla_loop`: w fp32
accumulations into a (B, nparts) table, slot k = 0..w-1 in order — the
order the CUDA kernels add in, so on the card the two agree bit for bit.
On a CPU tensor the sharded refinement sweep runs them.
:func:`connection_table_onehot` is `repro`'s one-hot oracle (``ref.py``),
which materialises the (B, w, nparts) one-hot; the tests hold both to it.
"""

from __future__ import annotations

import torch


def connection_table_batched_ref(labels: torch.Tensor, cols: torch.Tensor,
                                 wts: torch.Tensor,
                                 nparts: int) -> torch.Tensor:
    """labels (G, m) int; cols/wts (G, B, w) → (G, B, nparts) float32.
    Problem ``g`` reads only its own label row."""
    G, B, w = cols.shape
    lab = torch.gather(labels.long(), 1, cols.reshape(G, -1).long())
    lab = lab.reshape(G, B, w)
    iota = torch.arange(nparts, device=cols.device)
    acc = torch.zeros((G, B, nparts), dtype=torch.float32, device=cols.device)
    for k in range(w):
        onehot = (lab[:, :, k, None] == iota).to(torch.float32)
        acc = acc + wts[:, :, k, None].to(torch.float32) * onehot
    return acc


def connection_table_ref(labels: torch.Tensor, cols: torch.Tensor,
                         wts: torch.Tensor, nparts: int) -> torch.Tensor:
    """labels (m,) int; cols/wts (B, w) → (B, nparts) float32."""
    return connection_table_batched_ref(labels[None], cols[None], wts[None],
                                        nparts)[0]


def connection_table_onehot(labels: torch.Tensor, cols: torch.Tensor,
                            wts: torch.Tensor, nparts: int) -> torch.Tensor:
    """The one-hot oracle: labels (m,); cols/wts (B, w) → (B, nparts)."""
    lab = labels.long()[cols.long()]                             # (B, w)
    onehot = lab[..., None] == torch.arange(nparts, device=cols.device)
    zero = torch.zeros((), dtype=torch.float32, device=cols.device)
    return torch.where(onehot, wts[..., None].to(torch.float32), zero).sum(1)
