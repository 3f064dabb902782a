"""Synthetic LM and recsys traffic: `repro.data.synthetic`'s `lm_batch`,
`token_batches` and `recsys_batches`.

The same NumPy draws from the same seed, so the port and `repro` see the
same tokens and item sequences; the batches are int32 torch tensors on the
host.  The GNN generators wait for the GNN slice (D3).
"""

from __future__ import annotations

import numpy as np
import torch


def lm_batch(rng: np.random.Generator, batch: int, seq: int,
             vocab: int) -> dict:
    """Zipf(1.3) tokens with a deterministic bigram drift (a learnable
    signal): ``{"tokens", "labels"}``, each (batch, seq) int32, labels the
    tokens shifted by one."""
    z = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
    drift = (np.cumsum(z, axis=1) * 7) % vocab
    toks = ((z + drift) // 2 % vocab).astype(np.int32)
    return {
        "tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
        "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
    }


def token_batches(batch: int, seq: int, vocab: int, *, seed: int = 0):
    """Endless `lm_batch` draws from one seeded generator."""
    rng = np.random.default_rng(seed)
    while True:
        yield lm_batch(rng, batch, seq, vocab)


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
