"""The steps of `repro.launch.cells`, as plain functions (one process, or
one rank of a mesh).

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

`lm_train_step`, `recsys_train_step`, `recsys_serve_topk` and
`recsys_retrieval` take ``rules``: on a `MeshRules` over a `DeviceMesh`
each rank steps its slices of the parameters and moments (placed by
`train.checkpoint.reshard` with `param_specs_lm` / `param_specs_recsys`)
on its rows of the batch.

The cells as records (`repro`'s ``launch/cells.py``): :func:`build_cell`
turns one (arch × shape × mesh) into a :class:`Cell` — the step, its
arguments as ``meta`` tensors of one rank's local shapes under the
port's `MeshRules` (no memory), their specs, the donated arguments and
`repro`'s count of the step's useful FLOPs (``model_flops``, its formulas
exactly).  ``fn`` runs the port's own step on those arguments as rank 0
of the mesh (`launch.mesh.RankView`: `AbstractGroup` collectives), which
is what the dry run (`launch.dryrun`) measures:

* LM ``train``: `lm_train_step` (the global batch rebuilt from the local
  one as ``meta``, since every rank takes the global batch and slices its
  rows); ``prefill`` / ``decode``: a `Transformer` built from the fp32
  masters (`repro`'s arguments), then `prefill` / `decode_step` at the
  cache's last position (``pos`` is a 0-d argument, as `repro`'s, but the
  port's step takes a Python int).  The MoE runs as its config says:
  ``"pjit"`` (the published default, GSPMD's sorted dispatch with the
  global capacity) or, with ``moe_impl="shardmap"``, expert parallelism.
* recsys: the sharded `recsys_train_step` (the global batch rebuilt from
  the local one, as the LM's), `recsys_serve_topk` (each rank's share of
  `repro`'s ``user_chunk`` users at a time) and `recsys_retrieval`, under
  `recsys_rules`.
* GNN: `gnn_train_step` under `gnn_rules`, on this rank's stripe of the
  padded batch (`repro`'s arguments and specs: nodes and edges striped
  over every mesh axis, the parameters replicated).  The segment plans of
  ``meta`` indices are upper bounds (`models.gnn.common.segment_plan`),
  which the cell's ``notes`` say.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.configs import get_arch
from repro_torch.dist.sharding import (Spec, batch_specs_lm, cache_specs_lm,
                                       entry_axes, global_norm, gnn_rules,
                                       lm_rules, local_slice, param_specs_lm,
                                       param_specs_recsys, recsys_rules,
                                       reduce_grads, spec_map)
from repro_torch.launch.mesh import RankView, axis_names, axis_sizes
from repro_torch.models import transformer as T
from repro_torch.models.common import (NO_SHARD, ShardRules, tree_leaves,
                                      tree_map, tree_unflatten)
from repro_torch.models.gnn import equivariant
from repro_torch.models.gnn.common import _TENSOR_FIELDS, GraphBatch
from repro_torch.models.gnn.graphcast import graphcast_loss, init_graphcast
from repro_torch.models.gnn.mace import init_mace, mace_loss
from repro_torch.models.gnn.meshgraphnet import init_mgn, mgn_loss
from repro_torch.models.gnn.nequip import init_nequip, nequip_loss
from repro_torch.models.recsys.sasrec import (
    SASRec,
    SASRecConfig,
    candidate_scores,
    init_sasrec,
    sasrec_train_loss,
    vocab_entry,
    vocab_split,
)
from repro_torch.train.optimizer import (AdamWConfig, abstract_opt_state,
                                         adamw_update)
from repro_torch.train.train_loop import value_and_grad

OPT_CFG = AdamWConfig(lr=1e-4)


def _rows(rules, batch: dict) -> dict:
    """This rank's rows of a global batch (`batch_specs_lm`: the batch dim
    over the data axes)."""
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
        from repro_torch.dist.sharding import tree_specs

        specs = tree_specs(rules, T.abstract_params(cfg))
        grads = reduce_grads(grads, specs, rules)
        gnorm = global_norm(grads, specs, rules)
    params, opt_state, _ = adamw_update(OPT_CFG, grads, opt_state, params,
                                        gnorm=gnorm)
    return params, opt_state, loss


def recsys_train_step(cfg: SASRecConfig, params: dict, opt_state: dict,
                      batch: dict, *, rules: ShardRules = NO_SHARD):
    """`repro`'s ``_recsys_cell`` ``train`` step: `sasrec_train_loss`'s
    value and gradient, then `adamw_update` with ``OPT_CFG``.  Returns
    (params, opt_state, loss).

    Under ``rules`` (`recsys_rules` on a `DeviceMesh`) ``batch`` is the
    global batch, the same on every rank, and ``params``/``opt_state``
    this rank's slices (`param_specs_recsys`: the rank's rows of
    ``item_embed``, every other leaf whole): the rank takes its users (the
    batch over the data axes), `sasrec_train_loss` returns the global
    loss, `reduce_grads` sums each leaf's shares over the ranks that hold
    the same slice and the clipping norm is the whole tree's
    (`global_norm`)."""
    sharded = getattr(rules, "mesh", None) is not None
    if sharded:
        spec = Spec(_data_axes(rules.mesh), None)
        batch = {k: rules.local(v, spec) for k, v in batch.items()}
    loss, grads = value_and_grad(
        lambda p, b: sasrec_train_loss(cfg, p, b, rules=rules))(params, batch)
    gnorm = None
    if sharded:
        specs = param_specs_recsys(cfg, params, rules.mesh)
        grads = reduce_grads(grads, specs, rules)
        gnorm = global_norm(grads, specs, rules)
    params, opt_state, _ = adamw_update(OPT_CFG, grads, opt_state, params,
                                        gnorm=gnorm)
    return params, opt_state, loss


GNN_LOSSES = {"meshgraphnet": mgn_loss, "graphcast": graphcast_loss,
              "nequip": nequip_loss, "mace": mace_loss}


def gnn_train_step(arch_id: str, cfg, params: dict, opt_state: dict, batch,
                   *, remat: bool = False, rules: ShardRules = NO_SHARD):
    """`repro`'s ``_gnn_cell`` step body: the value and gradient of
    ``arch_id``'s loss on the `GraphBatch` ``batch``, then `adamw_update`
    with ``OPT_CFG``.  ``remat`` (GraphCast only): recompute each processor
    layer in the backward, the same bits.  Returns (params, opt_state,
    loss).

    Under ``rules`` (`gnn_rules` on a `DeviceMesh`) ``batch`` is this
    rank's stripe of the nodes and edges (`data.synthetic.pad_graph_batch`
    pads a host batch to a multiple of the ranks; `stripe` cuts a rank's),
    and ``params``/``opt_state`` are whole on every rank, as `repro`'s
    ``P()``: the loss is the global loss, `reduce_grads` sums the shares
    over every rank, and AdamW's clipping norm is then the whole tree's on
    every rank.  Every leaf is replicated, so the shares travel as one
    buffer (one all-reduce a mesh axis, as XLA's all-reduce combiner
    merges GSPMD's), not one a leaf."""
    if remat and arch_id != "graphcast":
        raise ValueError(f"{arch_id}: remat is GraphCast's option")
    loss = GNN_LOSSES[arch_id]
    kw = {"remat": True} if remat else {}
    l, grads = value_and_grad(lambda p, b: loss(cfg, p, b, rules, **kw))(
        params, batch)
    if getattr(rules, "mesh", None) is not None:
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in leaves])
        flat = reduce_grads({"g": flat}, {"g": Spec()}, rules)["g"]
        grads = tree_unflatten(grads, [
            x.view_as(g) for x, g in zip(
                torch.split(flat, [g.numel() for g in leaves]), leaves)])
    params, opt_state, _ = adamw_update(OPT_CFG, grads, opt_state, params)
    return params, opt_state, l


def stripe(batch: GraphBatch, rules: ShardRules,
           rank: int | None = None) -> GraphBatch:
    """This rank's block (or, with ``rank``, that rank's: row-major on the
    rules' mesh) of a whole (padded) `GraphBatch` under `repro`'s batch
    specs (`_gnn_batch_spec`): node and edge arrays over every mesh axis,
    per-graph targets whole; no plans."""
    spec = _gnn_batch_spec(rules.mesh, energy_targets=batch.targets is not None
                           and batch.targets.dim() == 1,
                           geometry=batch.positions is not None,
                           n_graphs=batch.n_graphs)
    coords = rules.coords if rank is None else dict(zip(
        rules.mesh_axis_names, RankView(rules.mesh, rank).coord))
    out = {f: None if getattr(batch, f) is None
           else local_slice(getattr(batch, f), getattr(spec, f), coords,
                            rules.mesh)
           for f in _TENSOR_FIELDS}
    return GraphBatch(**out, n_graphs=batch.n_graphs)


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
                      n_cat_chunks: int = 64, user_chunk: int = 8192, *,
                      rules: ShardRules = NO_SHARD
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """item_seq (B, S) → (values, ids), each (B, k): the k best items per
    user by ``h @ item_embed.T``, h the last position's user state.  One
    K5 launch (the sequence lookup) per user chunk.

    Under ``rules`` (`recsys_rules`) ``item_seq`` is this rank's users and
    ``model`` holds the rank's rows of the table: the rank streams its own
    rows in ``n_cat_chunks`` slices (ids offset by its first row) into a
    (chunk, k) best of its own, then each user chunk makes one gather of
    the ranks' winners over the vocab's axes (values and ids in one int32
    tensor) and one merge to the global top-k: no collective per catalog
    slice."""
    table = model.item_embed
    vocab = vocab_entry(cfg, rules)
    split = vocab_split(rules, vocab)
    first = rules.index(vocab) * table.shape[0] if split else 0
    chunk = table.shape[0] // n_cat_chunks
    offsets = torch.arange(chunk, device=table.device)
    vals, ids = [], []
    for seqs in torch.split(item_seq, user_chunk):
        h = model.user_state(seqs, rules)[:, -1]          # (uc, d)
        n = h.shape[0]
        best_v = torch.full((n, k), float("-inf"), dtype=h.dtype,
                            device=h.device)
        best_i = torch.zeros((n, k), dtype=torch.int64, device=h.device)
        for i in range(n_cat_chunks):
            rows = table[i * chunk:(i + 1) * chunk]
            scores = h @ rows.T                           # (uc, chunk)
            allv = torch.cat([best_v, scores], dim=1)
            alli = torch.cat([best_i, (first + i * chunk + offsets)
                              .expand(n, chunk)], dim=1)
            best_v, pos = torch.topk(allv, k, dim=1)
            best_i = torch.gather(alli, 1, pos)
        if split:
            best_v, best_i = _merge_topk(best_v, best_i, rules, vocab)
        vals.append(best_v)
        ids.append(best_i)
    return torch.cat(vals), torch.cat(ids)


def _merge_topk(best_v: torch.Tensor, best_i: torch.Tensor, rules, vocab):
    """The global top-k of every rank's (n, k) best along ``vocab``: one
    all-gather of values (their fp32 bits) and ids as int32, one top-k."""
    n, k = best_v.shape
    packed = torch.cat([best_v.float().view(torch.int32),
                        best_i.to(torch.int32)], dim=1)        # (n, 2k)
    every = rules.gather(packed, vocab, 1).view(n, -1, 2, k)
    allv = every[:, :, 0].reshape(n, -1).view(torch.float32)
    alli = every[:, :, 1].reshape(n, -1).long()
    v, pos = torch.topk(allv, k, dim=1)
    return v.to(best_v.dtype), torch.gather(alli, 1, pos)


def recsys_retrieval(cfg: SASRecConfig, model: SASRec,
                     item_seq: torch.Tensor, candidates: torch.Tensor, *,
                     rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """item_seq (B, S), candidates (N_c,) → (B, N_c) scores: two K5
    launches (the sequence and the candidates).

    Under ``rules`` with the table's rows split (`repro`'s specs:
    ``item_seq`` whole, ``candidates`` this rank's block over ``model``,
    the scores ``Spec(None, "model")``): the candidates' ids gathered over
    the vocab's axes, their rows looked up vocab-parallel, and the rank's
    partial scores reduce-scattered to its block of columns (B, N_c /
    ranks)."""
    vocab = vocab_entry(cfg, rules)
    if not vocab_split(rules, vocab):
        return model.score_candidates(item_seq, candidates, rules)
    every = rules.gather(candidates, vocab, 0)
    h = model.user_state(item_seq, rules)[:, -1]
    return candidate_scores(cfg, model.item_embed, h, every, rules,
                            prefer=model.bag_prefer, scatter=True)


# ---------------------------------------------------------------------------
# Cells: one (arch × shape × mesh) as a record, for the dry run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable                 # the port's step on abstract_args
    abstract_args: tuple         # meta tensors, one rank's local shapes
    in_specs: tuple              # the arguments' specs (`Spec` trees)
    out_specs: Any
    model_flops: float           # useful-math FLOPs per step (6ND etc.)
    notes: str = ""

    def donate(self):
        """Donated arg indices (params/opt/cache buffers), `repro`'s."""
        if self.kind == "train":
            return (0, 1)
        if self.kind == "decode":
            return (1,)
        return ()


def _pad_to(x: int, m: int) -> int:
    return int(-(-x // m) * m)


def _n_devices(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _local_shape(shape, spec, mesh) -> tuple:
    """One device's block of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {entry} ({n} shards)")
        out[dim] //= n
    return tuple(out)


def global_shape(local, spec, mesh) -> tuple:
    """The full shape whose block under ``spec`` is ``local`` (a spec
    shorter than the shape leaves the rest whole)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(local) - len(spec))
    return tuple(d * math.prod(sizes[a] for a in entry_axes(e))
                 for d, e in zip(tuple(local), spec))


def _localize(tree, spec_tree, mesh):
    """``meta`` leaves of the local shapes of a tree under its specs."""
    return spec_map(lambda t, s: _meta(_local_shape(t.shape, s, mesh), t.dtype),
                    tree, spec_tree)


def _globalize(tree, spec_tree, mesh, *, hidden: bool = False):
    """``meta`` leaves of the full shapes of a tree of local blocks: what
    an entry point that slices full tensors itself takes.  ``hidden``
    makes them out of sight of any dispatch mode (the dry run's meter):
    stand-ins for weights the port builds from its shards, which no
    device holds whole."""
    def full():
        return spec_map(lambda t, s: _meta(global_shape(t.shape, s, mesh),
                                           t.dtype), tree, spec_tree)

    if not hidden:
        return full()
    with _disable_current_modes():
        return full()


def _replicated(tree):
    return tree_map(lambda _: Spec(), tree)


class _ShapesOnly(TorchDispatchMode):
    """Every op of the body on ``meta``: factories and random draws made
    there, a scalar read answered 0 (an init's rejection loop ends at
    once).  Shapes and types only (`jax.eval_shape`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.ops.aten._local_scalar_dense.default:
            return False if args[0].dtype == torch.bool else 0
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if "generator" in kwargs:
            kwargs["generator"] = None
        return func(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def _abstract_init(init, cfg):
    """``init(cfg, generator)``'s tree as ``meta`` tensors, no memory."""
    with _ShapesOnly():
        return init(cfg, torch.Generator())


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _view(mesh):
    """Rank 0 of ``mesh`` (a `RankView` is kept as it is)."""
    return mesh if isinstance(mesh, RankView) else RankView(mesh, 0)


# -- LM cells ----------------------------------------------------------------

def _arch_config(arch, moe_impl):
    cfg = arch.make_config()
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=moe_impl))
    return cfg


def _lm_setup(cfg, mesh, seq_shard=True):
    # one device: the one-process step (`NO_SHARD`), as a card runs it
    one = _n_devices(mesh) == 1
    rules = NO_SHARD if one else lm_rules(_view(mesh), seq_shard=seq_shard)
    params_g = T.abstract_params(cfg)
    pspec = param_specs_lm(cfg, params_g, mesh)
    return rules, params_g, pspec


def _lm_train_cell(arch, cell, mesh, seq_shard=True, moe_impl=None,
                   microbatch=1) -> Cell:
    cfg = _arch_config(arch, moe_impl)
    return lm_train_cell(cfg, cell["global_batch"], cell["seq_len"], mesh,
                         seq_shard=seq_shard, microbatch=microbatch,
                         arch_id=arch.arch_id, shape_name=cell.name)


def lm_train_cell(cfg, batch: int, seq_len: int, mesh, *,
                  seq_shard: bool = True, microbatch: int = 1,
                  arch_id: str = "", shape_name: str = "train") -> Cell:
    """The LM ``train`` cell of any config: `lm_train_step` on a (batch,
    seq_len) global batch, as rank 0 of ``mesh`` (or the rank a
    `RankView` names); on a one-device mesh, the one-process step."""
    rules, params_g, pspec = _lm_setup(cfg, mesh, seq_shard)
    B, S = batch, seq_len
    params = _localize(params_g, pspec, mesh)
    opt = abstract_opt_state(params)
    bspec = batch_specs_lm(mesh)
    batch = _localize({"tokens": _meta((B, S), torch.int32),
                       "labels": _meta((B, S), torch.int32)}, bspec, mesh)

    def step(params, opt_state, batch):
        if rules is not NO_SHARD:       # every rank takes the global batch
            batch = _globalize(batch, bspec, mesh)
        return lm_train_step(cfg, params, opt_state, batch,
                             microbatch=microbatch, rules=rules)

    ospec = {"m": pspec, "v": pspec, "count": Spec()}
    n_active = cfg.n_active_params()
    return Cell(
        arch_id=arch_id, shape_name=shape_name, kind="train",
        fn=step, abstract_args=(params, opt, batch),
        in_specs=(pspec, ospec, bspec), out_specs=(pspec, ospec, Spec()),
        model_flops=6.0 * n_active * B * S,
        notes=f"N_active={n_active:.3e}")


def _lm_serve_cell(arch, cell, mesh, moe_impl=None) -> Cell:
    cfg = _arch_config(arch, moe_impl)
    rules, params_g, pspec = _lm_setup(cfg, mesh)
    B, S = cell["global_batch"], cell["seq_len"]
    params = _localize(params_g, pspec, mesh)
    cspec = cache_specs_lm(cfg, mesh)
    data = _data_axes(mesh)
    tspec = Spec(data, None)
    out_specs = (Spec(data, None, "model"), cspec)
    n_active = cfg.n_active_params()

    def model(params):
        return T.Transformer(cfg, _globalize(params, pspec, mesh,
                                             hidden=True), rules)

    if cell.kind == "prefill":
        tokens = _meta(_local_shape((B, S), tspec, mesh), torch.int32)

        def step(params, tokens):
            return T.prefill(model(params), tokens)

        attn = 4.0 * B * S * S * cfg.n_heads * cfg.d_head / 2  # causal half
        return Cell(
            arch_id=arch.arch_id, shape_name=cell.name, kind="prefill",
            fn=step, abstract_args=(params, tokens),
            in_specs=(pspec, tspec), out_specs=out_specs,
            model_flops=2.0 * n_active * B * S + attn,
            notes=f"N_active={n_active:.3e}")

    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    cache = {k: _meta(_local_shape(shape, cspec[k], mesh), cfg.dtype)
             for k in ("k", "v")}
    tokens = _meta(_local_shape((B, 1), tspec, mesh), torch.int32)
    pos = _meta((), torch.int32)

    def step(params, cache, tokens, pos):
        return T.decode_step(model(params), cache, tokens, S - 1)

    attn = 4.0 * B * S * cfg.n_heads * cfg.d_head
    return Cell(
        arch_id=arch.arch_id, shape_name=cell.name, kind="decode",
        fn=step, abstract_args=(params, cache, tokens, pos),
        in_specs=(pspec, cspec, tspec, Spec()), out_specs=out_specs,
        model_flops=2.0 * n_active * B + attn,
        notes=f"N_active={n_active:.3e} kv_cache_tokens={S} (decode at "
              f"position {S - 1})")


# -- GNN cells ---------------------------------------------------------------

def _gnn_batch_spec(mesh, *, energy_targets: bool, geometry: bool,
                    n_graphs: int) -> GraphBatch:
    """`repro`'s GNN batch specs: node and edge arrays striped over every
    mesh axis, per-graph targets replicated."""
    every = tuple(a for a in ("pod", "data", "model") if a in axis_names(mesh))
    return GraphBatch(
        node_feat=Spec(every, None), edge_src=Spec(every),
        edge_dst=Spec(every), node_mask=Spec(every), edge_mask=Spec(every),
        positions=Spec(every, None) if geometry else None,
        species=Spec(every) if geometry else None,
        graph_ids=Spec(every) if geometry else None,
        targets=Spec() if energy_targets else Spec(every, None),
        n_graphs=n_graphs)


def _gnn_batch_abstract(cell, mesh, *, d_feat: int, needs_geometry: bool,
                        d_out: int, energy_targets: bool | None = None):
    """`repro`'s ``_gnn_batch_abstract``: the padded `GraphBatch` of a GNN
    cell (nodes and edges padded to a multiple of the device count,
    striped over every mesh axis) as this rank's ``meta`` blocks, its
    spec, the padded counts and a note."""
    if energy_targets is None:
        energy_targets = needs_geometry
    if cell.name == "molecule":
        needs_geometry = True         # molecules always carry positions
        d_feat = max(d_feat, 4)       # synthesized node features if absent
    D = _n_devices(mesh)
    if cell.name == "molecule":
        n_nodes = cell["n_nodes"] * cell["batch"]
        n_edges = cell["n_edges"] * cell["batch"]
        n_graphs = cell["batch"]
    elif cell.name == "minibatch_lg":
        n_nodes, n_edges, n_graphs = cell["sub_nodes"], cell["sub_edges"], 1
    else:
        n_nodes, n_edges, n_graphs = cell["n_nodes"], cell["n_edges"], 1
    n_pad = _pad_to(n_nodes, D)
    e_pad = _pad_to(n_edges, D)
    f32, i32 = torch.float32, torch.int32
    geo = needs_geometry
    spec = _gnn_batch_spec(mesh, energy_targets=energy_targets, geometry=geo,
                           n_graphs=n_graphs)
    full = dict(node_feat=((n_pad, d_feat), f32), edge_src=((e_pad,), i32),
                edge_dst=((e_pad,), i32), node_mask=((n_pad,), f32),
                edge_mask=((e_pad,), f32),
                positions=((n_pad, 3), f32) if geo else None,
                species=((n_pad,), i32) if geo else None,
                graph_ids=((n_pad,), i32) if geo else None,
                targets=((n_graphs,) if energy_targets else (n_pad, d_out),
                         f32))
    batch = GraphBatch(**{
        f: None if v is None
        else _meta(_local_shape(v[0], getattr(spec, f), mesh), v[1])
        for f, v in full.items()}, n_graphs=n_graphs)
    note = f"padded nodes {n_nodes}->{n_pad}, edges {n_edges}->{e_pad}"
    return batch, spec, n_pad, e_pad, note


def _gnn_cell(arch, cell, mesh) -> Cell:
    aid = arch.arch_id
    d_feat = cell.meta.get("d_feat", 0)
    if cell.name == "molecule":
        d_feat = max(d_feat, 4)
    needs_geometry = aid in ("mace", "nequip")
    if aid == "meshgraphnet":
        cfg, init, d_out = arch.make_config(d_in=max(d_feat, 3), d_out=3), \
            init_mgn, 3
    elif aid == "graphcast":
        cfg, init = arch.make_config(d_in=max(d_feat, 1)), init_graphcast
        d_out = cfg.n_vars
    else:
        cfg = arch.make_config(d_feat_in=d_feat)
        init, d_out = (init_nequip if aid == "nequip" else init_mace), 1
    batch, bspec, n_pad, e_pad, note = _gnn_batch_abstract(
        cell, mesh, d_feat=d_feat, needs_geometry=needs_geometry,
        d_out=d_out, energy_targets=needs_geometry)
    params = _abstract_init(init, cfg)
    pspec = _replicated(params)
    ospec = {"m": pspec, "v": pspec, "count": Spec()}
    # one device: the one-process step (`NO_SHARD`), as a card runs it
    rules = NO_SHARD if _n_devices(mesh) == 1 else gnn_rules(_view(mesh))

    def step(params, opt_state, batch):
        return gnn_train_step(aid, cfg, params, opt_state, batch, rules=rules)

    return Cell(
        arch_id=aid, shape_name=cell.name, kind="train", fn=step,
        abstract_args=(params, abstract_opt_state(params), batch),
        in_specs=(pspec, ospec, bspec), out_specs=(pspec, ospec, Spec()),
        model_flops=gnn_model_flops(aid, cfg, n_pad, e_pad),
        notes=note + "; segment plans: upper bounds (meta indices)")


# -- RecSys cells ------------------------------------------------------------

def _recsys_cell(arch, cell, mesh) -> Cell:
    return recsys_cell(arch.make_config(), cell.kind, cell["batch"], mesh,
                       n_candidates=cell.meta.get("n_candidates"),
                       arch_id=arch.arch_id, shape_name=cell.name)


def recsys_cell(cfg: SASRecConfig, kind: str, batch: int, mesh, *,
                n_candidates: int | None = None, arch_id: str = "sasrec",
                shape_name: str = "") -> Cell:
    """A SASRec cell of any config: ``kind`` ``"train"``, ``"serve"``
    (top-100) or ``"retrieval"`` (``n_candidates`` scores) on ``batch``
    global users, as rank 0 of ``mesh`` (or the rank a `RankView` names);
    on a one-device mesh, the one-process step."""
    rules = NO_SHARD if _n_devices(mesh) == 1 else recsys_rules(_view(mesh))
    params_g = _abstract_init(init_sasrec, cfg)
    data = _data_axes(mesh)
    pspec = param_specs_recsys(cfg, params_g, mesh)
    params = _localize(params_g, pspec, mesh)
    d, S = cfg.embed_dim, cfg.seq_len
    blk_flops = 2 * (4 * d * d + 2 * d * cfg.d_ff) + 4 * S * d  # per token
    B = batch

    def args(shapes, specs):
        return _localize({k: _meta(v, torch.int32) for k, v in shapes.items()},
                         specs, mesh)

    if kind == "train":
        bspec = {k: Spec(data, None)
                 for k in ("item_seq", "pos_items", "neg_items")}
        batch = args({k: (B, S) for k in bspec}, bspec)

        def step(params, opt_state, batch):
            if rules is not NO_SHARD:   # every rank takes the global batch
                batch = _globalize(batch, bspec, mesh)
            return recsys_train_step(cfg, params, opt_state, batch,
                                     rules=rules)

        ospec = {"m": pspec, "v": pspec, "count": Spec()}
        return Cell(
            arch_id=arch_id, shape_name=shape_name, kind="train", fn=step,
            abstract_args=(params, abstract_opt_state(params), batch),
            in_specs=(pspec, ospec, bspec), out_specs=(pspec, ospec, Spec()),
            model_flops=3.0 * B * S * cfg.n_blocks * blk_flops)
    if kind == "serve":
        k, V = 100, cfg.table_rows
        # repro chunks the global batch (user_chunk users, split over the
        # data axes): a rank scores its share of each chunk at a time
        user_chunk = min(B, 8192)
        local_chunk = max(1, user_chunk // math.prod(
            axis_sizes(mesh)[a] for a in data))
        seq = args({"s": (B, S)}, {"s": Spec(data, None)})["s"]

        def step(params, item_seq):
            return recsys_serve_topk(cfg, SASRec(cfg, params), item_seq, k=k,
                                     user_chunk=local_chunk, rules=rules)

        return Cell(
            arch_id=arch_id, shape_name=shape_name, kind="serve", fn=step,
            abstract_args=(params, seq), in_specs=(pspec, Spec(data, None)),
            out_specs=(Spec(data, None), Spec(data, None)),
            model_flops=B * S * cfg.n_blocks * blk_flops + 2.0 * B * V * d,
            notes=f"top-{k} over {V}-row catalog; user_chunk={user_chunk}")
    NC = n_candidates
    a = args({"s": (B, S), "c": (NC,)}, {"s": Spec(None, None),
                                          "c": Spec("model")})

    def step(params, item_seq, candidates):
        return recsys_retrieval(cfg, SASRec(cfg, params), item_seq,
                                candidates, rules=rules)

    return Cell(
        arch_id=arch_id, shape_name=shape_name, kind="retrieval", fn=step,
        abstract_args=(params, a["s"], a["c"]),
        in_specs=(pspec, Spec(None, None), Spec("model")),
        out_specs=Spec(None, "model"),
        model_flops=B * S * cfg.n_blocks * blk_flops + 2.0 * B * NC * d)


def build_cell(arch_id: str, shape_name: str, mesh, *, unroll: bool = False,
               n_layers: int | None = None, seq_shard: bool = True,
               moe_impl: str | None = None, microbatch: int = 1) -> Cell:
    """`repro`'s ``build_cell`` on a `MeshShape` (or one rank of it, a
    `RankView`).  ``n_layers`` overrides the config depth (layer
    differencing); ``unroll`` is accepted for `repro`'s signature: the
    port's layers are a Python loop, always unrolled."""
    arch = get_arch(arch_id)
    if n_layers is not None:
        base = arch.make_config

        def _shallow(*a, **kw):
            return dataclasses.replace(base(*a, **kw), n_layers=n_layers)

        arch = dataclasses.replace(arch, make_config=_shallow)
    if shape_name not in arch.shapes:
        raise KeyError(f"{arch_id} has no shape {shape_name}")
    if shape_name in arch.skips:
        raise ValueError(
            f"cell ({arch_id} × {shape_name}) is skipped: "
            f"{arch.skips[shape_name]}")
    cell = arch.shapes[shape_name]
    if arch.family == "lm":
        if cell.kind == "train":
            return _lm_train_cell(arch, cell, mesh, seq_shard=seq_shard,
                                  moe_impl=moe_impl, microbatch=microbatch)
        return _lm_serve_cell(arch, cell, mesh, moe_impl=moe_impl)
    if arch.family == "gnn":
        return _gnn_cell(arch, cell, mesh)
    return _recsys_cell(arch, cell, mesh)
