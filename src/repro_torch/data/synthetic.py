"""Synthetic recsys traffic: `repro.data.synthetic.recsys_batches`.

The same NumPy draws from the same seed, so the port and `repro` see the
same item sequences; the batches are int32 torch tensors on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def recsys_batches(batch: int, seq: int, n_items: int, *, seed: int = 0):
    """Endless batches ``{"item_seq", "pos_items", "neg_items"}``, each
    (batch, seq) int32: Zipf(1.2) item popularity, shifted into [1,
    n_items − 1] (0 is the padding item); negatives uniform."""
    rng = np.random.default_rng(seed)
    while True:
        seqs = (rng.zipf(1.2, size=(batch, seq + 1)) % (n_items - 1) + 1).astype(
            np.int32
        )
        neg = (rng.integers(1, n_items, size=(batch, seq))).astype(np.int32)
        yield {
            "item_seq": torch.from_numpy(np.ascontiguousarray(seqs[:, :-1])),
            "pos_items": torch.from_numpy(np.ascontiguousarray(seqs[:, 1:])),
            "neg_items": torch.from_numpy(neg),
        }
