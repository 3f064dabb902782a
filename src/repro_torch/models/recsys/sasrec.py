"""SASRec (Kang & McAuley, arXiv:1808.09781): self-attentive sequential
recommendation.  Port of `repro.models.recsys.sasrec`.

The final hidden state is the user representation; candidates are scored
by dot product against the item embeddings.  Both table lookups go through
K5 (`kernels/embedding_bag`) as bags of one row each — the item sequence
with ``segments = arange(B·S)`` and weight √d, the candidates with weight
1 — the same products `repro`'s ``jnp.take(...) * √d`` and ``jnp.take``
give, bit for bit in fp32.  The attention stays plain PyTorch, as
`repro`'s is plain einsum: its key-padding mask is SASRec's own, and masked
scores are -1e30 (not -inf), so a left-padded query whose keys are all
masked gets a uniform softmax and is then zeroed by the mask, as in
`repro`.

Training: `sasrec_train_loss` (next-item prediction, one sampled
negative per positive, `repro`'s objective) over `init_sasrec`'s parameter
tree, whose leaves may require gradients.  Its three lookups (the item
sequence, the positives, the negatives) run on K5's autograd function,
whose backward is K5 on the transposed problem: a dense table gradient
summed in a fixed order.  The serving `SASRec` module and the tree share
one copy of the math (`user_state`).

Sharding.  `lookup`, `user_state`, `sasrec_train_loss` and the module's
`SASRec.user_state` / `SASRec.score_candidates` take ``rules`` (`repro`'s
`ShardRules` hook; default `NO_SHARD`, the one-process run).  Under
`repro_torch.dist.sharding.recsys_rules` on a `DeviceMesh` each rank holds
its rows of ``item_embed`` (``Spec("model", None)``: the vocab split over
``model``) and its users (the batch split over the data axes); every
other weight is whole on every rank.  The three lookups (the sequence at
√d, the positives, the negatives) are `vocab_parallel_lookup`s: K5 over
the rank's rows, foreign ids at weight 0, summed over ``model``.  The loss
is `repro`'s mean over the global batch: its numerator and its count are
each summed over the data axes before the divide, and its gradient on a
rank is the rank's share (1 / ranks of the sum of the ranks' losses), as
the LM's is (`repro_torch.dist.sharding.reduce_grads` sums the shares).
Candidate scores are summed over ``model`` as scores, not as rows: each
rank scores its partial rows (the foreign ones zero), so B·N_c numbers
cross the wire, not N_c·d.  A single rank of the vocab (``model`` of size
1, or `NO_SHARD`) runs the one-process lookups, bit for bit.

Differences from `repro` by design: for serving the parameters live in a
`SASRec` module (the stacked block tensors as `repro` stacks them), and
`sasrec_user_state` / `sasrec_score_candidates` take it in place of the
parameter tree (`user_state` takes the tree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models.common import (NO_SHARD, ShardRules, dense_init,
                                       embed_init, grad_scale, layer_norm,
                                       vocab_parallel_lookup)

_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "ln1_g", "ln1_b", "ln2_g",
               "ln2_b")


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    d_ff: int = 50
    pad_rows: int = 512     # table rows padded for clean row-sharding
    dtype: Any = torch.float32

    @property
    def table_rows(self) -> int:
        """Row 0 is the padding item; rows padded to a `pad_rows` multiple
        (`repro` shards the table evenly over any mesh axis ≤ pad_rows)."""
        return -(-(self.n_items + 1) // self.pad_rows) * self.pad_rows

    def n_params(self) -> int:
        d = self.embed_dim
        blk = 4 * d * d + 2 * d * self.d_ff + 4 * d
        return (self.table_rows + self.seq_len) * d + self.n_blocks * blk


def init_sasrec(cfg: SASRecConfig, generator: torch.Generator) -> dict:
    """`repro`'s parameter tree — ``item_embed`` (row 0 the padding item),
    ``pos_embed``, ``blocks`` (each leaf stacked over a leading
    (n_blocks,) dim), ``final_ln_g``, ``final_ln_b`` — in ``cfg.dtype``,
    on the generator's device."""
    d, L = cfg.embed_dim, cfg.n_blocks

    def dense(shape):
        return dense_init(generator, (L, *shape), in_axis=1, dtype=cfg.dtype)

    def const(value, shape):
        return torch.full(shape, value, dtype=cfg.dtype,
                          device=generator.device)

    return {
        "item_embed": embed_init(generator, (cfg.table_rows, d), cfg.dtype),
        "pos_embed": embed_init(generator, (cfg.seq_len, d), cfg.dtype),
        "blocks": {"wq": dense((d, d)), "wk": dense((d, d)),
                   "wv": dense((d, d)), "wo": dense((d, d)),
                   "w1": dense((d, cfg.d_ff)), "w2": dense((cfg.d_ff, d)),
                   "ln1_g": const(1.0, (L, d)), "ln1_b": const(0.0, (L, d)),
                   "ln2_g": const(1.0, (L, d)), "ln2_b": const(0.0, (L, d))},
        "final_ln_g": const(1.0, (d,)),
        "final_ln_b": const(0.0, (d,)),
    }


class SASRec(nn.Module):
    """SASRec's weights in ``cfg.dtype``: ``item_embed``, ``pos_embed``, the
    block tensors stacked over (n_blocks,) as `repro` stacks them, and the
    final LayerNorm.

    ``bag_prefer`` is K5's dispatch for both table lookups (`ops`
    ``prefer``): ``"auto"`` runs the kernel on the card and the plain
    version on the CPU.  Set to ``"ref"``, it forces the plain version on
    the card, to hold the kernel's model against the plain one."""

    def __init__(self, cfg: SASRecConfig, params: dict):
        super().__init__()
        if cfg.embed_dim % cfg.n_heads:
            raise ValueError(f"{cfg.name}: embed_dim={cfg.embed_dim} is not a "
                             f"multiple of n_heads={cfg.n_heads}")
        self.cfg = cfg
        self.bag_prefer = "auto"

        def param(t):
            return nn.Parameter(t.to(cfg.dtype), requires_grad=False)

        self.item_embed = param(params["item_embed"])
        self.pos_embed = param(params["pos_embed"])
        self.blocks = nn.ParameterDict({k: param(params["blocks"][k])
                                        for k in _BLOCK_KEYS})
        self.final_ln_g = param(params["final_ln_g"])
        self.final_ln_b = param(params["final_ln_b"])

    def tree(self) -> dict:
        """The weights as `init_sasrec`'s tree (the module's tensors)."""
        return {"item_embed": self.item_embed, "pos_embed": self.pos_embed,
                "blocks": dict(self.blocks), "final_ln_g": self.final_ln_g,
                "final_ln_b": self.final_ln_b}

    def lookup(self, ids: torch.Tensor, weight: float,
               rules: ShardRules = NO_SHARD) -> torch.Tensor:
        """``weight · item_embed[ids]`` for ids (N,) → (N, d): N bags of one
        row each on K5 (under ``rules``, over the rank's rows)."""
        return lookup(self.item_embed, ids, weight, prefer=self.bag_prefer,
                      rules=rules, vocab=vocab_entry(self.cfg, rules))

    def user_state(self, item_seq: torch.Tensor,
                   rules: ShardRules = NO_SHARD) -> torch.Tensor:
        """item_seq (B, S) int (0 = pad) → per-position user states (B, S,
        d); under ``rules``, this rank's users."""
        return user_state(self.cfg, self.tree(), item_seq,
                          bag_prefer=self.bag_prefer, rules=rules)

    def score_candidates(self, item_seq: torch.Tensor,
                         candidates: torch.Tensor,
                         rules: ShardRules = NO_SHARD) -> torch.Tensor:
        """Score candidates (N_c,) for each user → (B, N_c) logits; under
        ``rules``, this rank's users against every candidate."""
        h = self.user_state(item_seq, rules)[:, -1]        # (B, d)
        return candidate_scores(self.cfg, self.item_embed, h, candidates,
                                rules, prefer=self.bag_prefer)


def vocab_entry(cfg: SASRecConfig, rules: ShardRules):
    """The spec entry ``item_embed``'s rows are split over (None: whole,
    or `NO_SHARD`)."""
    spec = rules.spec(("vocab", None), (cfg.table_rows, cfg.embed_dim))
    return None if spec is None else spec[0]


def vocab_split(rules: ShardRules, entry) -> bool:
    """Whether the rows are split over more than one rank (``entry`` from
    `vocab_entry`)."""
    return entry is not None and rules.count(entry) > 1


def lookup(table: torch.Tensor, ids: torch.Tensor, weight: float, *,
           prefer: str = "auto", rules: ShardRules = NO_SHARD,
           vocab=None) -> torch.Tensor:
    """``weight · table[ids]`` for ids (N,) → (N, d): N bags of one row each
    on K5 (differentiable in the table).  With the rows split over the
    spec entry ``vocab`` (`vocab_entry`), ``table`` is the rank's rows and
    the lookup is `vocab_parallel_lookup`."""
    if vocab_split(rules, vocab):
        return vocab_parallel_lookup(table, ids, weight, rules, vocab,
                                     prefer=prefer)
    n = ids.shape[0]
    dev = table.device
    segments = torch.arange(n, dtype=torch.int32, device=dev)
    weights = torch.full((n,), weight, dtype=torch.float32, device=dev)
    return embedding_bag(table, ids.to(torch.int32), segments, n,
                         weights=weights, bags_of_one=True, prefer=prefer)


def candidate_scores(cfg: SASRecConfig, table: torch.Tensor, h: torch.Tensor,
                     candidates: torch.Tensor, rules: ShardRules = NO_SHARD,
                     *, prefer: str = "auto",
                     scatter: bool = False) -> torch.Tensor:
    """``h @ table[candidates].T``: h (B, d), candidates (N_c,) → (B, N_c).
    With the rows split, each rank scores its partial rows and the scores
    are summed over the vocab's axes; with ``scatter`` the sum is a
    reduce-scatter along the candidates, and the rank gets its block of
    columns (B, N_c / ranks)."""
    vocab = vocab_entry(cfg, rules)
    if not vocab_split(rules, vocab):
        return h @ lookup(table, candidates, 1.0, prefer=prefer).T
    ce = vocab_parallel_lookup(table, candidates, 1.0, rules, vocab,
                               prefer=prefer, reduce=False)
    scores = h @ ce.T
    if scatter:
        return rules.scatter(scores, vocab, 1)
    return rules.psum(scores, vocab)


def user_state(cfg: SASRecConfig, params: dict, item_seq: torch.Tensor, *,
               bag_prefer: str = "auto",
               rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """`repro`'s ``sasrec_user_state`` over a parameter tree: item_seq (B,
    S) int (0 = pad) → per-position user states (B, S, d)."""
    B, S = item_seq.shape
    d = cfg.embed_dim
    mask = (item_seq > 0).to(cfg.dtype)
    x = lookup(params["item_embed"], item_seq.reshape(-1), math.sqrt(d),
               prefer=bag_prefer, rules=rules,
               vocab=vocab_entry(cfg, rules)).reshape(B, S, d)
    x = x + params["pos_embed"][None, :S]
    x = x * mask[:, :, None]
    for i in range(cfg.n_blocks):
        x = _block(cfg, {k: v[i] for k, v in params["blocks"].items()}, x,
                   mask)
    return layer_norm(x, params["final_ln_g"], params["final_ln_b"])


def sasrec_train_loss(cfg: SASRecConfig, params: dict, batch: dict, *,
                      bag_prefer: str = "auto",
                      rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """`repro`'s ``sasrec_train_loss``: batch ``item_seq``, ``pos_items``,
    ``neg_items`` (B, S) int; −(log σ(h·e⁺) + log σ(−h·e⁻)) over the
    positions whose positive is not padding, mean over max(count, 1).
    Under ``rules``: ``params`` and ``batch`` are this rank's, and every
    rank returns the global loss (see the module docstring)."""
    h = user_state(cfg, params, batch["item_seq"], bag_prefer=bag_prefer,
                   rules=rules)
    B, S, d = h.shape
    table = params["item_embed"]
    vocab = vocab_entry(cfg, rules)
    pe = lookup(table, batch["pos_items"].reshape(-1), 1.0,
                prefer=bag_prefer, rules=rules, vocab=vocab).reshape(B, S, d)
    ne = lookup(table, batch["neg_items"].reshape(-1), 1.0,
                prefer=bag_prefer, rules=rules, vocab=vocab).reshape(B, S, d)
    pos_logit = (h * pe).sum(-1)
    neg_logit = (h * ne).sum(-1)
    mask = (batch["pos_items"] > 0).to(cfg.dtype)
    loss = -(F.logsigmoid(pos_logit) + F.logsigmoid(-neg_logit)) * mask
    num, den = loss.sum(), mask.sum()
    if getattr(rules, "mesh", None) is None:
        return num / den.clamp_min(1.0)
    data = rules.spec(("batch",))[0]
    if data is not None:
        num, den = rules.psum(num, data), rules.psum(den, data)
    loss = num / den.clamp_min(1.0)
    return grad_scale(loss, 1.0 / rules.n_ranks) if rules.n_ranks > 1 \
        else loss


def _block(cfg: SASRecConfig, p: dict, x: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    h = layer_norm(x, p["ln1_g"], p["ln1_b"])
    H = cfg.n_heads
    dh = d // H
    q = (h @ p["wq"]).reshape(B, S, H, dh)
    k = (h @ p["wk"]).reshape(B, S, H, dh)
    v = (h @ p["wv"]).reshape(B, S, H, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    valid = causal[None, None] & (mask[:, None, None, :] > 0)
    s = torch.where(valid, s, torch.full((), -1e30, dtype=s.dtype,
                                         device=s.device))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, d)
    x = x + o @ p["wo"]
    h = layer_norm(x, p["ln2_g"], p["ln2_b"])
    x = x + torch.relu(h @ p["w1"]) @ p["w2"]
    return x * mask[:, :, None]


def sasrec_user_state(cfg: SASRecConfig, model: SASRec,
                      item_seq: torch.Tensor,
                      rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """`repro`'s ``sasrec_user_state``: item_seq (B, S) → (B, S, d)."""
    return model.user_state(item_seq, rules)


def sasrec_score_candidates(cfg: SASRecConfig, model: SASRec,
                            item_seq: torch.Tensor,
                            candidates: torch.Tensor,
                            rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """`repro`'s ``sasrec_score_candidates``: (B, N_c) logits."""
    return model.score_candidates(item_seq, candidates, rules)
