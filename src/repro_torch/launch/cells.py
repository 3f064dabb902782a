"""The steps of `repro.launch.cells`, as plain functions on one device.

* :func:`lm_train_step` — ``_lm_train_cell``'s step: gradient accumulation
  over microbatches, then AdamW with ``OPT_CFG``;
* :func:`recsys_train_step` — ``_recsys_cell``'s ``train`` step;
* :func:`gnn_train_step` — ``_gnn_cell``'s step: the arch's loss, its
  gradient, then AdamW with ``OPT_CFG``; :func:`gnn_model_flops` —
  ``_gnn_cell``'s count of a step's useful FLOPs;
* :func:`recsys_serve_topk` — the ``serve`` cells (``serve_p99``,
  ``serve_bulk``): each user's top-k items over the whole catalog, the
  users in chunks of at most ``user_chunk`` and the table streamed in
  ``n_cat_chunks`` contiguous slices, so no (users × catalog) score matrix
  is ever held;
* :func:`recsys_retrieval` — the ``retrieval`` cell (``retrieval_cand``):
  one batched score of every candidate, `sasrec_score_candidates`.

`repro`'s semantics are kept, oddities included: every row of each slice
is scored, the padding row 0 and the rows past ``n_items`` among them, and
the rows past ``n_cat_chunks · (table_rows // n_cat_chunks)`` are not;
the running best comes first in each concatenation, and values come out
sorted in descending order.  `repro` reshapes the users into equal chunks
(its batch must be a multiple of ``user_chunk``); here the last chunk may
be shorter.  Ties: ``jax.lax.top_k`` keeps the lower position of equal
scores, ``torch.topk`` promises no order among them, so ids may differ
where two scores are equal.

`lm_train_step` takes ``rules``: on a `MeshRules` over a `DeviceMesh`
each rank steps its slices of the parameters and moments (placed by
`train.checkpoint.reshard` with `param_specs_lm`) on its rows of the
batch.  The cells as records (`Cell`, abstract arguments, the
production mesh and its topology) are the launch slice's (ROADMAP D5).
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import NO_SHARD, ShardRules, tree_map
from repro_torch.models.gnn import equivariant
from repro_torch.models.gnn.graphcast import graphcast_loss
from repro_torch.models.gnn.mace import mace_loss
from repro_torch.models.gnn.meshgraphnet import mgn_loss
from repro_torch.models.gnn.nequip import nequip_loss
from repro_torch.models.recsys.sasrec import (
    SASRec,
    SASRecConfig,
    sasrec_train_loss,
)
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.train_loop import value_and_grad

OPT_CFG = AdamWConfig(lr=1e-4)


def _rows(rules, batch: dict) -> dict:
    """This rank's rows of a global batch (`batch_specs_lm`: the batch dim
    over the data axes)."""
    from repro_torch.dist.sharding import batch_specs_lm

    specs = batch_specs_lm(rules.mesh)
    return {k: rules.local(v, specs.get(k, specs["tokens"]))
            for k, v in batch.items()}


def lm_train_step(cfg: T.LMConfig, params: dict, opt_state: dict,
                  batch: dict, *, microbatch: int = 1,
                  rules: ShardRules = NO_SHARD):
    """`repro`'s ``_lm_train_cell`` step body: batch ``tokens``/``labels``
    (B, S) split into ``microbatch`` microbatches of B / microbatch rows
    (activations live for one microbatch), the losses and fp32 gradients
    summed in microbatch order and divided by the count, then
    `adamw_update` with ``OPT_CFG``.  Returns (params, opt_state, loss).

    Under ``rules`` (a `MeshRules` on a `DeviceMesh`) ``batch`` is the
    global batch, the same on every rank, and ``params``/``opt_state``
    this rank's slices: each microbatch (global rows, as `repro` cuts
    them) is split over the data axes, `loss_fn` returns its global loss,
    each leaf's gradient shares are summed over the ranks that hold the
    same slice (`reduce_grads`: the data-parallel all-reduce for leaves
    replicated over ``data``; the FSDP expert weights got theirs from the
    gather's reduce-scatter), and the clipping norm is the whole tree's
    (`global_norm`), so every rank clips alike."""
    sharded = getattr(rules, "mesh", None) is not None
    vg = value_and_grad(lambda p, b: T.loss_fn(cfg, p, b, rules=rules))
    B = batch["tokens"].shape[0]
    if B % microbatch:
        raise ValueError(f"batch {B} is not a multiple of microbatch "
                         f"{microbatch}")
    mb = B // microbatch

    def rows(i):
        b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        return _rows(rules, b) if sharded else b

    if microbatch > 1:
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(microbatch):
            l, g = vg(params, rows(i))
            loss = loss + l
            tree_map(lambda s, x: s.add_(x), grads, g)   # gsum + g, in place
            del g
        loss = loss / microbatch
        grads = tree_map(lambda g: g / microbatch, grads)
    else:
        loss, grads = vg(params, rows(0))
    gnorm = None
    if sharded:
        from repro_torch.dist.sharding import (global_norm, reduce_grads,
                                               tree_specs)

        specs = tree_specs(rules, T.abstract_params(cfg))
        grads = reduce_grads(grads, specs, rules)
        gnorm = global_norm(grads, specs, rules)
    params, opt_state, _ = adamw_update(OPT_CFG, grads, opt_state, params,
                                        gnorm=gnorm)
    return params, opt_state, loss


def recsys_train_step(cfg: SASRecConfig, params: dict, opt_state: dict,
                      batch: dict):
    """`repro`'s ``_recsys_cell`` ``train`` step: `sasrec_train_loss`'s
    value and gradient, then `adamw_update` with ``OPT_CFG``.  Returns
    (params, opt_state, loss)."""
    loss, grads = value_and_grad(
        lambda p, b: sasrec_train_loss(cfg, p, b))(params, batch)
    params, opt_state, _ = adamw_update(OPT_CFG, grads, opt_state, params)
    return params, opt_state, loss


GNN_LOSSES = {"meshgraphnet": mgn_loss, "graphcast": graphcast_loss,
              "nequip": nequip_loss, "mace": mace_loss}


def gnn_train_step(arch_id: str, cfg, params: dict, opt_state: dict, batch,
                   *, remat: bool = False):
    """`repro`'s ``_gnn_cell`` step body: the value and gradient of
    ``arch_id``'s loss on the `GraphBatch` ``batch``, then `adamw_update`
    with ``OPT_CFG``.  ``remat`` (GraphCast only): recompute each processor
    layer in the backward, the same bits.  Returns (params, opt_state,
    loss)."""
    if remat and arch_id != "graphcast":
        raise ValueError(f"{arch_id}: remat is GraphCast's option")
    loss = GNN_LOSSES[arch_id]
    kw = {"remat": True} if remat else {}
    l, grads = value_and_grad(lambda p, b: loss(cfg, p, b, **kw))(params,
                                                                  batch)
    params, opt_state, _ = adamw_update(OPT_CFG, grads, opt_state, params)
    return params, opt_state, l


def gnn_model_flops(arch_id: str, cfg, n_nodes: int, n_edges: int) -> float:
    """``_gnn_cell``'s useful FLOPs of one train step (forward and
    backward): ``3 · n_layers · (per_edge · E + per_node · N)``."""
    if arch_id in ("meshgraphnet", "graphcast"):
        d = cfg.d_hidden
        per_edge = 2 * (3 * d * d + d * d)
        per_node = 2 * (2 * d * d + d * d)
    else:
        C, Pn = cfg.d_hidden, equivariant.n_paths()
        per_edge = 2 * (cfg.n_rbf * 64 + 64 * C * Pn) + 2 * Pn * 81 * C
        if arch_id == "nequip":
            per_node = 6 * C * C * 9
        else:
            per_node = (cfg.correlation - 1) * 2 * Pn * 729 * C \
                + 10 * C * C * 9
    return 3.0 * cfg.n_layers * (per_edge * n_edges + per_node * n_nodes)


def recsys_serve_topk(cfg: SASRecConfig, model: SASRec,
                      item_seq: torch.Tensor, k: int = 100,
                      n_cat_chunks: int = 64,
                      user_chunk: int = 8192) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """item_seq (B, S) → (values, ids), each (B, k): the k best items per
    user by ``h @ item_embed.T``, h the last position's user state.  One
    K5 launch (the sequence lookup) per user chunk."""
    table = model.item_embed
    chunk = table.shape[0] // n_cat_chunks
    offsets = torch.arange(chunk, device=table.device)
    vals, ids = [], []
    for seqs in torch.split(item_seq, user_chunk):
        h = model.user_state(seqs)[:, -1]                 # (uc, d)
        n = h.shape[0]
        best_v = torch.full((n, k), float("-inf"), dtype=h.dtype,
                            device=h.device)
        best_i = torch.zeros((n, k), dtype=torch.int64, device=h.device)
        for i in range(n_cat_chunks):
            rows = table[i * chunk:(i + 1) * chunk]
            scores = h @ rows.T                           # (uc, chunk)
            allv = torch.cat([best_v, scores], dim=1)
            alli = torch.cat([best_i, (i * chunk + offsets).expand(n, chunk)],
                             dim=1)
            best_v, pos = torch.topk(allv, k, dim=1)
            best_i = torch.gather(alli, 1, pos)
        vals.append(best_v)
        ids.append(best_i)
    return torch.cat(vals), torch.cat(ids)


def recsys_retrieval(cfg: SASRecConfig, model: SASRec,
                     item_seq: torch.Tensor,
                     candidates: torch.Tensor) -> torch.Tensor:
    """item_seq (B, S), candidates (N_c,) → (B, N_c) scores: two K5
    launches (the sequence and the candidates)."""
    return model.score_candidates(item_seq, candidates)
